"""The plain reference against the port on the CPU at a tiny width, both in
float32 from the benchmark's weights: the same inference outputs and the
same training losses and gradients."""
from __future__ import annotations

import pytest
import torch

from benchmark.reference import model as ref
from benchmark.tests import tiny
from benchmark.traffic import frames, train
from benchmark.weights import init_state, shapes_of

SEED = 2 ** 31 + 3


def _port(config, train_mode, seed):
    from omni3d_tpu_torch.config import CfgNode, get_default_cfg
    from omni3d_tpu_torch.models import rcnn3d
    cfg = get_default_cfg()
    cfg.merge_from_other(CfgNode(config["cfg"]))
    model = rcnn3d.build_model(cfg, device="cpu", dtype=torch.float32, train=train_mode)
    model.load_state_dict(init_state(shapes_of(model), seed, "cpu"))
    return cfg, model


def _reference(config, train_mode, seed):
    model = ref.build(config["cfg"], "cpu", train=train_mode)
    model.load_state_dict(init_state(shapes_of(model), seed, "cpu"))
    return model


def assert_inference_matches(spec, config, seed=SEED):
    """The port's `inference` and the reference's on one batch of the
    cell's frames, within 1e-4."""
    from omni3d_tpu_torch.models import rcnn3d
    cfg, port = _port(config, False, seed)
    model = _reference(config, False, seed)
    batch = frames.batches(frames.frame_pool(spec, config["cfg"], seed, "cpu"), spec["batch"])[0]
    images, Ks, ratios, hw = frames.normalized(batch, config["cfg"], "cpu")
    got = rcnn3d.inference(port, images, Ks, ratios, hw=hw, **rcnn3d.inference_kwargs(cfg))
    want = frames.reference_outputs(model, images, Ks, ratios, hw)
    for k in want:
        torch.testing.assert_close(got[k].float(), want[k].float(), rtol=1e-4, atol=1e-4,
                                   msg=k)


def assert_training_matches(spec, config, seed=SEED):
    """The losses of one batch and every parameter's gradient, the port's
    against the reference's."""
    from omni3d_tpu_torch.engine.train import compute_losses
    _, port = _port(config, True, seed)
    model = _reference(config, True, seed)
    batch = train.batch_pool(spec, config["cfg"], seed, "cpu")[0]
    got, _, _ = compute_losses(port, batch, train.step_generator(seed, 0))
    want, _ = ref.compute_losses(model, batch, train.step_generator(seed, 0))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    got.backward()
    want.backward()
    refs = dict(model.named_parameters())
    for n, p in port.named_parameters():
        g, r = p.grad, refs[n].grad
        if g is None or r is None:
            assert (g is None or not g.any()) and (r is None or not r.any()), n
            continue
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3 * float(r.abs().max()) + 1e-8,
                                   msg=n)


@pytest.mark.parametrize("name", ["dla34.offline_b8", "resnet34.live_b1"])
def test_inference_matches_the_port(name):
    _, spec, config = tiny.cell(name)
    assert_inference_matches(spec, config)


def test_training_matches_the_port():
    _, spec, config = tiny.cell("dla34.train_b32")
    assert_training_matches(spec, config)
