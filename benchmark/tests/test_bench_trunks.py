"""The reference finds each trunk family by the builder's name, in a file
of its own, and builds what the port builds: the same state-dict names,
order and shapes for the cells' trunks, and for DenseNet-121-FPN (the
published `cubercnn_densenet_FPN.yaml`, which differs from the ResNet-34
one only in MODEL.BACKBONE.NAME) the same inference outputs, losses and
gradients as the port on the CPU at a tiny width, in float32 from the
benchmark's weights."""
from __future__ import annotations

import pytest
import torch

from benchmark.reference import model as ref
from benchmark.tests import tiny
from benchmark.tests.test_bench_reference import assert_inference_matches, assert_training_matches
from benchmark.weights import shapes_of

SEED = 2 ** 31 + 5


def _densenet(cell: str) -> tuple:
    """The tiny cell's spec, and the tiny ResNet-34 configuration on DenseNet-121."""
    _, spec, _ = tiny.cell(cell)
    _, _, config = tiny.cell("resnet34.live_b1")
    config["cfg"]["MODEL"]["BACKBONE"]["NAME"] = "build_densenet_fpn_backbone"
    return spec, config


CONFIGS = {"dla34_fpn": lambda: tiny.cell("dla34.train_b32")[2],
           "resnet34_fpn": lambda: tiny.cell("resnet34.live_b1")[2],
           "densenet121_fpn": lambda: _densenet("resnet34.live_b1")[1]}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_state_is_the_ports(name):
    from omni3d_tpu_torch.config import CfgNode, get_default_cfg
    from omni3d_tpu_torch.models import rcnn3d
    config = CONFIGS[name]()
    cfg = get_default_cfg()
    cfg.merge_from_other(CfgNode(config["cfg"]))
    port = rcnn3d.build_model(cfg, device="cpu", dtype=torch.float32, train=True)
    model = ref.build(config["cfg"], "cpu", train=True)
    assert list(model.state_dict()) == list(port.state_dict())
    assert list(shapes_of(model).items()) == list(shapes_of(port).items())
    assert model.backbone.bottom_up.out_channels == port.backbone.bottom_up.out_channels


def test_an_unknown_builder_names_the_missing_file():
    _, _, config = tiny.cell("dla34.offline_b8")
    config["cfg"]["MODEL"]["BACKBONE"]["NAME"] = "build_no_such_backbone"
    with pytest.raises(ValueError, match=r"trunks/build_no_such_backbone\.py"):
        ref.build(config["cfg"], "cpu")


def test_densenet_inference_matches_the_port():
    assert_inference_matches(*_densenet("resnet34.live_b1"), seed=SEED)


def test_densenet_training_matches_the_port():
    assert_training_matches(*_densenet("dla34.train_b32"), seed=SEED)
