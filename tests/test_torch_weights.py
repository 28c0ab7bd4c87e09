"""Reference and ImageNet weights: a detectron2-named reference state dict
and an ImageNet DLA-34 state dict, written with torch.save, load into the
port exactly as the JAX package's `convert_reference_checkpoint` /
`convert_imagenet_backbone` followed by `state_dict_from_flax` load them
(every tensor equal, the same loaded count and unused keys); the model-zoo
helpers and train_net's weight precedence."""
import os

import numpy as np
import pytest
import torch

from omni3d_tpu.utils import checkpoint as jckpt
from omni3d_tpu.utils import model_zoo as jzoo
from omni3d_tpu_torch.tools import train_net
from omni3d_tpu_torch.utils import checkpoint as tckpt
from omni3d_tpu_torch.utils import model_zoo as tzoo
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax
from torch_port_helpers import (jax_model, pooled_shape, port_model, random_variables,
                                small_cfgs)

DLA = "build_dla_from_vision_fpn_backbone"


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = small_cfgs()
    jm = jax_model(jcfg)
    variables = random_variables(jm, seed=0)
    other = random_variables(jm, seed=1)
    return jcfg, tcfg, variables, other


def _expected(tcfg, params, stats):
    return state_dict_from_flax(params, stats, pooled_shape(tcfg))


def test_reference_checkpoint_loads_as_jax_converts_it(setup, tmp_path):
    jcfg, tcfg, variables, other = setup
    ref = state_dict_from_flax(other["params"], other["batch_stats"], pooled_shape(tcfg))
    dropped = "roi_heads.box_predictor.bbox_pred.bias"
    ref.pop(dropped)                                          # missing from the file
    ref["roi_heads.priors_dims_per_cat"] = ref["roi_heads.priors_dims_per_cat"][None]
    ref["backbone.bottom_up.base_layer.1.num_batches_tracked"] = torch.tensor(7)
    ref["pixel_mean"] = torch.zeros(3, 1, 1)
    ref["roi_heads.unknown.weight"] = torch.ones(2)           # unused
    path = str(tmp_path / "ref.pth")
    torch.save({"model": ref, "iteration": 10}, path)

    params, stats, jrep = jckpt.convert_reference_checkpoint(
        jzoo.load_reference_weights(path), variables["params"], variables["batch_stats"],
        pooled_shape=pooled_shape(tcfg), strict=False)
    want = _expected(tcfg, params, stats)
    model = port_model(tcfg, variables)
    trep = tckpt.convert_reference_checkpoint(tzoo.load_reference_weights(path), model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].float(), v), k
    assert trep["loaded"] == jrep["loaded"] == len(want) - 1
    assert sorted(trep["unused"]) == sorted(jrep["unused"]) == ["roi_heads.unknown.weight"]
    assert trep["missing"] == [dropped]
    with pytest.raises(KeyError, match="missing"):
        tckpt.convert_reference_checkpoint({"model": ref}, model, strict=True)


def test_imagenet_dla34_loads_as_jax_converts_it(setup, tmp_path):
    jcfg, tcfg, variables, other = setup
    full = state_dict_from_flax(other["params"], other["batch_stats"], pooled_shape(tcfg))
    prefix = "backbone.bottom_up."
    imagenet = {k[len(prefix):]: v for k, v in full.items() if k.startswith(prefix)}
    imagenet["fc.weight"] = torch.ones(1000, 512, 1, 1)
    imagenet["fc.bias"] = torch.ones(1000)
    path = str(tmp_path / "dla34-ba72cf86.pth")
    torch.save(imagenet, path)

    params, stats, jrep = jckpt.convert_imagenet_backbone(
        jzoo.load_reference_weights(path), variables["params"], variables["batch_stats"], DLA)
    want = _expected(tcfg, params, stats)
    model = port_model(tcfg, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trep = tckpt.convert_imagenet_backbone(tzoo.load_reference_weights(path), model, DLA)
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k].float(), v), k
        assert torch.equal(got[k], before[k]) != k.startswith(prefix), k   # only the trunk moved
    assert trep["loaded"] == jrep["loaded"] and not trep["missing"] and not trep["unused"]
    for convert, weights in ((tckpt.convert_imagenet_backbone, (model,)),
                             (jckpt.convert_imagenet_backbone, (variables["params"],
                                                                variables["batch_stats"]))):
        with pytest.raises(KeyError, match="build_vgg_fpn_backbone"):   # an unknown builder
            convert(imagenet, *weights, "build_vgg_fpn_backbone")

    # the model zoo finds it as the JAX package does
    jcfg.TPU.IMAGENET_WEIGHTS_DIR = tcfg.TPU.IMAGENET_WEIGHTS_DIR = str(tmp_path)
    assert tzoo.find_imagenet_weights(tcfg) == jzoo.find_imagenet_weights(jcfg) == path


# file names of the published ImageNet weights, one per family
IMAGENET_FILES = {
    ("build_dla_from_vision_fpn_backbone", "dla60x"): "dla60x-d15cacda.pth",
    ("build_resnet_from_vision_fpn_backbone", 34): "resnet34-b627a593.pth",
    ("build_resnet_from_vision_fpn_backbone", 101): "resnet101-63fe2227.pth",
    ("build_densenet_fpn_backbone", None): "densenet121-a639ec97.pth",
    ("build_mnasnet_fpn_backbone", None): "mnasnet1.0_top1_73.512-f206786ef8.pth",
    ("build_shufflenet_fpn_backbone", None): "shufflenetv2_x1-5666bf0f80.pth",
}


@pytest.mark.parametrize("family", list(IMAGENET_FILES), ids=lambda f: IMAGENET_FILES[f][:8])
def test_find_imagenet_weights_finds_each_familys_file_as_jax_does(family, tmp_path):
    """With every family's file in TPU.IMAGENET_WEIGHTS_DIR, the port and
    the JAX package pick the same file for the config's backbone: its own."""
    for name in IMAGENET_FILES.values():
        (tmp_path / name).write_bytes(b"")
    builder, variant = family
    jcfg, tcfg = small_cfgs(**{"MODEL.BACKBONE.NAME": builder})
    for cfg in (jcfg, tcfg):
        cfg.TPU.IMAGENET_WEIGHTS_DIR = str(tmp_path)
        if isinstance(variant, str):
            cfg.MODEL.DLA.TYPE = variant
        elif variant:
            cfg.MODEL.RESNETS.DEPTH = variant
    got = tzoo.find_imagenet_weights(tcfg)
    assert got == jzoo.find_imagenet_weights(jcfg) == str(tmp_path / IMAGENET_FILES[family])


def test_model_zoo_resolves_without_downloading(tmp_path, monkeypatch):
    assert tzoo.resolve(str(tmp_path / "x.pth")) == str(tmp_path / "x.pth")
    monkeypatch.setattr(tzoo, "CACHE_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="fbaipublicfiles"):
        tzoo.resolve("cubercnn://omni3d/cubercnn_DLA34_FPN.pth")
    os.makedirs(tmp_path / "omni3d")
    (tmp_path / "omni3d" / "cubercnn_DLA34_FPN.pth").write_bytes(b"")
    assert tzoo.resolve("cubercnn://omni3d/cubercnn_DLA34_FPN.pth") == str(
        tmp_path / "omni3d" / "cubercnn_DLA34_FPN.pth")


def test_train_init_precedence(setup, tmp_path):
    """WEIGHTS_PRETRAIN, then --weights (it wins where both load), else
    ImageNet with the pose bias at the identity; a checkpoint of the port
    loads by its model state."""
    jcfg, tcfg, variables, other = setup
    ref_a = state_dict_from_flax(other["params"], other["batch_stats"], pooled_shape(tcfg))
    ref_b = {k: v + 1.0 for k, v in ref_a.items()}
    pa, pb = str(tmp_path / "a.pth"), str(tmp_path / "b.pth")
    torch.save(ref_a, pa)
    torch.save(ref_b, pb)
    key = "roi_heads.box_head.fc1.weight"

    def run(weights, pretrain, imagenet_dir=""):
        cfg = tcfg.clone()
        cfg.MODEL.WEIGHTS_PRETRAIN = pretrain
        cfg.TPU.IMAGENET_WEIGHTS_DIR = imagenet_dir
        model = port_model(tcfg, variables)
        args = train_net.parse_args(["--config-file", "x"] + (["--weights", weights] if weights
                                                                else []))
        train_net.make_train_init_fn(args, cfg)(model)
        return model.state_dict()

    assert torch.equal(run(pb, pa)[key], ref_b[key])
    assert torch.equal(run("", pa)[key], ref_a[key])
    torch.save({k[len("backbone.bottom_up."):]: v for k, v in ref_a.items()
                if k.startswith("backbone.bottom_up.")}, str(tmp_path / "dla34-x.pth"))
    sd = run("", "", str(tmp_path))
    trunk = "backbone.bottom_up.base_layer.0.weight"
    assert torch.equal(sd[trunk], ref_a[trunk]) and not torch.equal(sd[key], ref_a[key])
    pose = sd["roi_heads.cube_head.bbox_3D_pose.bias"].reshape(-1, 6)
    assert torch.equal(pose, torch.tensor([[1.0, 0, 0, 0, 1, 0]]).expand_as(pose))
    ckpt_path = str(tmp_path / "model_final.ckpt")
    tckpt.save_checkpoint(ckpt_path, {"model": ref_b}, {"iteration": 3})
    assert torch.equal(run(ckpt_path, "")[key], ref_b[key])
    np.testing.assert_array_equal(run("", "")[key].numpy(),
                                  port_model(tcfg, variables).state_dict()[key].numpy())
