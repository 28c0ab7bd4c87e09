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


def _port(config, train_mode):
    from omni3d_tpu_torch.config import CfgNode, get_default_cfg
    from omni3d_tpu_torch.models import rcnn3d
    cfg = get_default_cfg()
    cfg.merge_from_other(CfgNode(config["cfg"]))
    model = rcnn3d.build_model(cfg, device="cpu", dtype=torch.float32, train=train_mode)
    model.load_state_dict(init_state(shapes_of(model), SEED, "cpu"))
    return cfg, model


@pytest.mark.parametrize("name", ["dla34.offline_b8", "resnet34.live_b1"])
def test_inference_matches_the_port(name):
    from omni3d_tpu_torch.models import rcnn3d
    _, spec, config = tiny.cell(name)
    cfg, port = _port(config, False)
    model = ref.build(config["cfg"], "cpu")
    model.load_state_dict(init_state(shapes_of(model), SEED, "cpu"))
    batch = frames.batches(frames.frame_pool(spec, config["cfg"], SEED, "cpu"), spec["batch"])[0]
    images, Ks, ratios, hw = frames.normalized(batch, config["cfg"], "cpu")
    got = rcnn3d.inference(port, images, Ks, ratios, hw=hw, **rcnn3d.inference_kwargs(cfg))
    want = frames.reference_outputs(model, images, Ks, ratios, hw)
    for k in want:
        torch.testing.assert_close(got[k].float(), want[k].float(), rtol=1e-4, atol=1e-4,
                                   msg=k)


def test_training_matches_the_port():
    from omni3d_tpu_torch.engine.train import compute_losses
    _, spec, config = tiny.cell("dla34.train_b32")
    _, port = _port(config, True)
    model = ref.build(config["cfg"], "cpu", train=True)
    model.load_state_dict(init_state(shapes_of(model), SEED, "cpu"))
    batch = train.batch_pool(spec, config["cfg"], SEED, "cpu")[0]
    got, _, _ = compute_losses(port, batch, train.step_generator(SEED, 0))
    want, _ = ref.compute_losses(model, batch, train.step_generator(SEED, 0))
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
