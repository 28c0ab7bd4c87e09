"""The port's measurement tools on the CPU at small widths: `tools.bench`
(inference img/s), `tools.bench_train` (the training step),
`tools.profile_stages` (inference stage by stage), `tools.profile_backbone`
(the trunk block by block) and `utils.benchtime` (FLOPs, peaks), held
against the JAX package's bench inputs and `inference_impl`; and the three
small functions ported beside them (`ops.nms.batched_nms_mask`,
`EventStorage.put_scalars`, `vis.logperf.print_ap_dataset_histogram`).

Tolerances: the bench's outputs against the JAX `inference_impl` use
tests/test_torch_inference.py's; everything the port computes twice (the
stage chain, the trunk blocks, the FLOP count) must be equal exactly."""
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.models.rcnn3d import inference_impl
from omni3d_tpu.models.rcnn3d import inference_kwargs as jax_inference_kwargs
from omni3d_tpu.models.rcnn3d import preprocess as jax_preprocess
from omni3d_tpu.ops.nms import batched_nms_mask as jax_batched_nms_mask
from omni3d_tpu.utils.events import EventStorage as JaxEventStorage
from omni3d_tpu.vis import logperf as jax_logperf
from omni3d_tpu_torch.models import rcnn3d
from omni3d_tpu_torch.models.layers import Conv2d, Linear
from omni3d_tpu_torch.ops.nms import batched_nms_mask
from omni3d_tpu_torch.tools import bench, bench_train, profile_backbone, profile_stages
from omni3d_tpu_torch.utils import benchtime as bt
from omni3d_tpu_torch.utils.events import EventStorage
from omni3d_tpu_torch.vis import logperf
from test_torch_inference import TOL, _compare
from torch_port_helpers import jax_model, port_model, random_variables, small_cfgs, to_jnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMG = 64
# the test-time proposal and detection counts cut to the 64 px images
SMALL_TEST = {"MODEL.RPN.PRE_NMS_TOPK_TEST": 64, "MODEL.RPN.POST_NMS_TOPK_TEST": 64,
              "TPU.NMS_CANDIDATES": 128, "TEST.DETECTIONS_PER_IMAGE": 10}
# the training step's sampling cut to a 160 px batch of one image
SMALL_TRAIN = {"MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32, "MODEL.RPN.BATCH_SIZE_PER_IMAGE": 32,
               "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 64, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 32}


def test_bench_inputs_are_bench_py_draws():
    """(a) One default_rng(0) draw per batch size in order, as bench.py:65-70;
    the bs 1 images preprocessed exactly as the JAX package's preprocess."""
    _, cfg = small_cfgs()
    data = bench.inputs(cfg, (1, 8), 512, "cpu")
    rng = np.random.default_rng(0)
    for bs in (1, 8):
        want = rng.integers(0, 255, (bs, 512, 512, 3), dtype=np.int32)
        np.testing.assert_array_equal(data[bs][0], want)
    raw, images, Ks, ratios = data[1]
    jimg = jax_preprocess(jnp.asarray(raw), cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(Ks[0].numpy(), [[500, 0, 256], [0, 500, 256], [0, 0, 1]])
    assert ratios.tolist() == [1.0]


def test_bench_run_matches_inference_and_jax(capsys):
    """(b) One round of one call at bs 1 and 2: every record key (the
    graphed and the eager call's; on the CPU `inference_step` is `inference`
    and nothing is captured), the last printed line bench.py's keys, the
    outputs equal to `inference` with
    `inference_kwargs`, and with weights carried from the JAX model, within
    test_torch_inference's tolerances of the JAX `inference_impl`."""
    jcfg, tcfg = small_cfgs(**SMALL_TEST)
    jm = jax_model(jcfg)
    variables = random_variables(jm, (IMG, IMG), seed=4)
    model = port_model(tcfg, variables)
    record, last = bench.run(tcfg, (1, 2), IMG, rounds=1, iters=1, device="cpu", model=model)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"metric", "value", "unit", "card", "power_limit"}
    assert summary["unit"] == "images/sec/chip" and summary["value"] > 0
    assert summary == record["summary"]
    for row in record["batch_sizes"]:
        assert {"bs", "first_call_ms", "peak_mem_gib", "ms_per_batch", "img_per_s", "profile",
                "model_gflop_per_image", "mfu", "proposals_per_image", "detections_per_image",
                "eager_ms_per_batch", "eager_img_per_s", "eager_profile", "eager_mfu",
                "wrapper_launches_per_call", "eager_wrapper_launches_per_call"} <= set(row)
        assert row["model_gflop_per_image"] > 0 and row["mfu"] is None   # no card: not measured
        assert row["graph"] is None and row["eager_mfu"] is None   # nothing captured on the CPU
        assert row["profile"]["hand_kernel_launches_per_call"] is None
    assert record["graphs"] is None
    kw = rcnn3d.inference_kwargs(tcfg)
    assert kw == jax_inference_kwargs(jcfg) and record["inference_kwargs"] == kw
    for bs, ((_, images, Ks, ratios), got) in last.items():
        want = rcnn3d.inference(model, images, Ks, ratios, **kw)
        for k, v in want.items():
            assert torch.equal(got[k], v), (bs, k)
    (raw, _, Ks, ratios), got = last[2]
    jimg = jax_preprocess(jnp.asarray(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    want = jax.jit(lambda v, im: inference_impl(v, jm, im, jnp.asarray(Ks.numpy()),
                                                jnp.asarray(ratios.numpy()), **kw))(
        to_jnp(variables), jimg)
    _compare(got, want)
    assert set(TOL) <= set(got)


def test_profile_stages_chain_is_inference():
    """(c) The stage chain's outputs are `inference`'s bit for bit; the stage
    names cover the JAX tool's but its TPU-only "pyramid staging"."""
    _, cfg = small_cfgs(**SMALL_TEST)
    model = bench.random_model(cfg, "cpu")
    record, out, (images, Ks, ratios) = profile_stages.run(cfg, 2, IMG, rounds=1, iters=1,
                                                           device="cpu", model=model)
    want = rcnn3d.inference(model, images, Ks, ratios, **rcnn3d.inference_kwargs(cfg))
    assert set(out) == set(want)
    for k, v in want.items():
        assert torch.equal(out[k], v), k
    jax_names = set(re.findall(r'rec\("([^"]+)"', (ROOT / "tools" / "profile_stages.py")
                               .read_text()))
    assert "per-class NMS" in jax_names and "  rpn: level top_k" in jax_names
    assert jax_names - {"pyramid staging"} <= set(record["stage_ms"])
    assert {"batch", "image_hw", "stage_ms", "full_step_ms", "img_per_s", "flops_per_step",
            "tflops_per_s", "mfu", "peak_tflops_assumed", "stage_device_ms", "stage_kernels",
            "device_busy_share", "card", "power_limit"} <= set(record)
    assert record["flops_per_step"] > record["stage_gflop"]["backbone+FPN"] * 1e9 > 0


@pytest.mark.parametrize("trunk", [
    {"MODEL.BACKBONE.NAME": "build_dla_from_vision_fpn_backbone"},
    {"MODEL.BACKBONE.NAME": "build_resnet_from_vision_fpn_backbone", "MODEL.RESNETS.DEPTH": 18},
], ids=["dla34", "resnet18"])
def test_profile_backbone_blocks_compose_to_features(trunk):
    """(d) The trunk's blocks, the FPN's and the copies, run in order, give
    `model.features`' outputs bit for bit; one row per block."""
    _, cfg = small_cfgs(**trunk)
    record, env, (feats, flist) = profile_backbone.run(cfg, 2, IMG, rounds=1, iters=1,
                                                       device="cpu")
    for k, v in feats.items():
        assert torch.equal(env["feats"][k], v), k
    assert all(torch.equal(a, b) for a, b in zip(env["flist"], flist))
    names = [r["block"] for r in record["blocks"]]
    first = "base_layer" if "dla" in trunk["MODEL.BACKBONE.NAME"] else "stem"
    assert names[0] == "backbone+FPN" and first in names and "p6 maxpool" in names
    assert sum(r["gflop"] for r in record["blocks"][1:]) == pytest.approx(
        record["blocks"][0]["gflop"], rel=1e-12)


@pytest.mark.parametrize("name", ["build_densenet_fpn_backbone", "build_mnasnet_fpn_backbone",
                                  "build_shufflenet_fpn_backbone"])
def test_other_trunks_blocks_compose_to_features(name):
    _, cfg = small_cfgs(**{"MODEL.BACKBONE.NAME": name})
    model = rcnn3d.build_model(cfg, device="cpu", seed=0)
    images = torch.randn(1, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        env = profile_backbone.run_blocks(model, images)
        feats, flist = model.features(images)
    for k, v in feats.items():
        assert torch.equal(env["feats"][k], v), k
    assert all(torch.equal(a, b) for a, b in zip(env["flist"], flist))


def test_model_flops_is_the_layers_hand_count():
    """(e) Forward FLOPs of every convolution (2 Cin/groups k^2 Cout Hout Wout
    per image) and linear layer (2 in out rows) that inference runs; the
    NMS fixpoint's products are counted only in `all`."""
    _, cfg = small_cfgs(**SMALL_TEST)
    model = rcnn3d.build_model(cfg, device="cpu", seed=0)
    hand = [0]

    def count(m, inputs, out):
        if isinstance(m, Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1]
            hand[0] += 2 * m.in_channels // m.groups * k * out.numel()
        else:
            hand[0] += 2 * m.in_features * out.numel()
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv2d, Linear))]
    _, images, Ks, ratios = bench.inputs(cfg, (2,), IMG, "cpu")[2]
    counts, out = bt.model_flops(model, lambda: rcnn3d.inference(
        model, images, Ks, ratios, **rcnn3d.inference_kwargs(cfg)))
    for h in hooks:
        h.remove()
    assert counts.forward == hand[0] > 0 and counts.backward == 0
    assert counts.all > counts.model   # the NMS products
    assert out["valid"].shape == (2, cfg.TEST.DETECTIONS_PER_IMAGE)


def test_bench_train_step_is_synthetic_trainers():
    """(f) The tool's first step gives the losses of a direct step of
    `synthetic_trainer` with the same seeds; its FLOPs hold forward and
    backward."""
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer
    _, cfg = small_cfgs(**SMALL_TRAIN)
    record = bench_train.run(cfg, 1, torch.float32, rounds=1, iters=1, device="cpu", image=160)
    _, _, step, batch = synthetic_trainer(cfg, torch.float32, 1, "cpu", img=160)
    logs = step(batch, torch.Generator().manual_seed(0))
    want = {k: float(v.detach() if torch.is_tensor(v) else v) for k, v in logs.items()}
    assert record["first_step_losses"] == want
    assert len(record["total_loss"]) == 4 and record["mfu"] is None
    fwd, bwd = record["model_gflop_forward"], record["model_gflop_backward"]
    assert 1.0 < bwd / fwd < 2.0   # no input gradient of the first conv, no-grad projections


def test_peaks_raise_and_tools_need_the_card(monkeypatch):
    """(g) No peak rate is guessed for an unknown card, and every tool asked
    for the card raises where there is none."""
    with pytest.raises(ValueError):
        bt.peaks("NVIDIA A100-SXM4-80GB")
    assert bt.peaks("NVIDIA H100 80GB HBM3")["bfloat16"] == 989.4e12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = small_cfgs()
    for run in (lambda: bench.run(cfg, (1,), IMG, 1, 1, "cuda"),
                lambda: bench_train.run(cfg, 1, device="cuda"),
                lambda: profile_stages.run(cfg, 1, IMG, device="cuda"),
                lambda: profile_backbone.run(cfg, 1, IMG, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


@pytest.mark.parametrize("n", [200, 600])
def test_batched_nms_mask_matches_jax(n):
    """(h) Class-aware NMS keep masks equal the JAX package's, per row of a
    batch of two; n = 600 runs the JAX blocked path (BLOCK = 256)."""
    rng = np.random.default_rng(n)
    xy = rng.uniform(0, 200, (2, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (2, n, 2)).astype(np.float32)], -1)
    scores = rng.random((2, n)).astype(np.float32)
    idxs = rng.integers(0, 4, (2, n)).astype(np.int32)
    valid = rng.random((2, n)) < 0.9
    got = batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(idxs), 0.5, torch.from_numpy(valid))
    fn = jax.jit(jax_batched_nms_mask, static_argnums=3)
    for i in range(2):
        want = fn(boxes[i], scores[i], idxs[i], 0.5, valid[i])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(valid.sum())


def test_put_scalars_and_dataset_histogram_match_jax(capsys):
    """(i) `put_scalars` leaves the JAX storage's history and latest values;
    the dataset histogram prints the JAX table's text."""
    storages = (EventStorage(None), JaxEventStorage(None))
    for s in storages:
        s.put_scalars(a=1.5, b=2)
        s.put_scalars(a=3.0)
    port, ref = storages
    assert {k: list(v) for k, v in port._history.items()} == \
        {k: list(v) for k, v in ref._history.items()}
    assert port._latest == ref._latest
    results = {"SUNRGBD_test": {"iters": 10, "AP2D": 12.5, "AP3D": 3.25},
               "KITTI_test": {"AP2D": float("nan"), "AP3D": 40.0}, "note": "x"}
    logperf.print_ap_dataset_histogram(results)
    got = capsys.readouterr().out
    jax_logperf.print_ap_dataset_histogram(results)
    assert got == capsys.readouterr().out
    assert "SUNRGBD_test" in got and "Per-dataset performance" in got
