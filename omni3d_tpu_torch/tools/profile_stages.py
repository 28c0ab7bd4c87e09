"""Where the time of an inference call goes, stage by stage, on a CUDA card
(the port's counterpart of the JAX package's tools/profile_stages.py).

    python -m omni3d_tpu_torch.tools.profile_stages [--bs 32] [--rounds 3]
        [--iters 10] [--out FILE] [--device cpu]

The model and inputs of `tools.bench` (DLA34-FPN at full width, bf16, 512
px, `bench.py`'s draw for the batch size). `stage_chain` runs
`rcnn3d.inference` stage by stage, calling the same public functions in the
same order, and keeps every stage's inputs; its outputs equal
`inference`'s bit for bit (a test holds them). Each stage is then timed
alone on its captured inputs: --rounds rounds of --iters back-to-back calls,
the stages, the full call and the full call as a CUDA graph
(`rcnn3d.inference_step`, "full call, graphed") in turns
(`utils.benchtime.in_turns`), with one profiled round each (device ms,
kernels) and its model FLOPs. The stages and
their names are the JAX tool's, in `inference`'s order; "anchors" is the
port's own (the JAX tool folds them into its graph) and the JAX tool's
"pyramid staging" (the TPU kernel's transposed pyramid) has no counterpart.
Sub-rows split the two NMS-bearing stages; they time the functions those
stages call, on the inputs recorded during the chain's run.

The record has the JAX tool's keys (`batch`, `image_hw`, `stage_ms`,
`full_step_ms`, `img_per_s`, `flops_per_step`, `tflops_per_s`, `mfu`,
`peak_tflops_assumed`) plus `stage_device_ms`, `stage_kernels`,
`stage_gflop`, `device_busy_share` (the full call's device busy ms over its
median ms), `kernels_per_call`,
`sum_of_stages_ms`, `graphed_full_call_ms`, `graphed_device_busy_share`,
`card` and `power_limit`. It prints one JSON object as
its last line and writes it to --out. On the CPU the device fields are null.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch

from ..models import heads, rcnn3d, rpn
from ..ops import nms as nms_ops
from ..utils import benchtime as bt
from ..utils import boxes as box_ops
from . import bench


# ---- the stages, in `rcnn3d.inference`'s order; each reads and writes `s`

def _features(m, s):
    s["feats"], s["flist"] = m.features(s["images"])


def _rpn_head(m, s):
    s["logits"], s["deltas"] = m.proposal_generator["rpn_head"](
        [s["feats"][f] for f in rcnn3d.FEATURE_NAMES])


def _anchors(m, s):
    s["anchors"] = m.anchors([(f.shape[1], f.shape[2]) for f in s["flist"]],
                             s["images"].device)


def _proposals(m, s):
    kw = s["kw"]
    s["prop_boxes"], _, s["prop_valid"] = rpn.select_proposals(
        s["anchors"], [lg.float() for lg in s["logits"]], [d.float() for d in s["deltas"]],
        s["image_hw"], kw["pre_nms_topk"], kw["post_nms_topk"], kw["rpn_nms_thresh"])


def _box_pooler(m, s):
    P = m.cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    s["pooled"] = rcnn3d.multilevel_roi_align(s["flist"], s["prop_boxes"],
                                              rcnn3d.FEATURE_STRIDES, P, s["kw"]["sampling_ratio"])


def _box_head(m, s):
    pooled = s["pooled"]
    h = m.roi_heads
    s["scores2d"], s["deltas2d"] = h.box_predictor(h.box_head(
        pooled.reshape(pooled.shape[0] * pooled.shape[1], *pooled.shape[2:])))


def _class_nms(m, s):
    kw, cfg = s["kw"], m.cfg
    B, C = s["images"].shape[0], cfg.MODEL.ROI_HEADS.NUM_CLASSES
    P = kw["post_nms_topk"]
    s["dets"] = heads.fast_rcnn_inference(
        s["scores2d"].reshape(B, P, C + 1).float(), s["deltas2d"].reshape(B, P, C * 4).float(),
        s["prop_boxes"], s["prop_valid"], s["image_hw"], C, kw["score_thresh"],
        kw["nms_thresh"], kw["topk"], kw["nms_candidates"],
        tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS))


def _cube_pooler(m, s):
    ch = m.cfg.MODEL.ROI_CUBE_HEAD
    boxes = heads.scale_proposals(s["dets"]["boxes"], ch.SCALE_ROI_BOXES)
    s["pooled_cube"] = rcnn3d.multilevel_roi_align(
        s["flist"], boxes, rcnn3d.FEATURE_STRIDES, ch.POOLER_RESOLUTION,
        s["kw"]["sampling_ratio"])


def _cube_head(m, s):
    pooled = s["pooled_cube"]
    s["cube_out"] = m.roi_heads.cube_head(
        pooled.reshape(pooled.shape[0] * pooled.shape[1], *pooled.shape[2:]))


def _decode(m, s):
    s["out"] = rcnn3d.decode_outputs(m, s["dets"], s["cube_out"], s["Ks"], s["ratios"],
                                     s["prop_boxes"], s["prop_valid"])


GRAPHED = "full call, graphed"   # `inference_step`, one CUDA graph replayed
STAGES = (("backbone+FPN", _features), ("RPN head convs", _rpn_head), ("anchors", _anchors),
          ("proposal select/NMS", _proposals), ("box pooler (1000)", _box_pooler),
          ("box head FCs", _box_head), ("per-class NMS", _class_nms),
          ("cube pooler (100)", _cube_pooler), ("cube head", _cube_head),
          ("decode_cube + packing", _decode))


@contextlib.contextmanager
def recorded(module, name):
    """Record every call of `module.name` (args, kwargs, result) while the
    block runs; calls made inside `module` itself are recorded too."""
    fn = getattr(module, name)
    calls = []

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@torch.no_grad()
def stage_chain(model, images, Ks, ratios, **kw):
    """`rcnn3d.inference(model, images, Ks, ratios, **kw)` run stage by stage
    (no `hw`, no oracle). Returns (outputs, s, sub-rows): `s` holds every
    stage's inputs and outputs, and each sub-row is (name, fn) timing a
    function that the NMS-bearing stages call, on the inputs it got."""
    B, H, W, _ = images.shape
    s = {"images": images, "Ks": Ks, "ratios": ratios, "kw": kw,
         "image_hw": rcnn3d.padded_hw(B, H, W, images.device)}
    for name, stage in STAGES:
        if name == "proposal select/NMS":
            with recorded(nms_ops, "sort_desc") as sorts, recorded(nms_ops, "nms_mask") as nmss:
                stage(model, s)
            levels = sorts[:len(s["anchors"])]
            rpn_nms = nmss[0]
        elif name == "per-class NMS":
            with recorded(nms_ops, "sort_desc") as sorts, \
                    recorded(nms_ops, "batched_nms_indices") as bnms, \
                    recorded(box_ops, "decode_deltas") as dec, \
                    recorded(box_ops, "clip_boxes") as clip:
                stage(model, s)
            flat, cls_nms, dec, clip = sorts[0], bnms[0], dec[0], clip[0]
        else:
            stage(model, s)

    def rerun(call, fn):
        args, kwargs, _ = call
        return lambda: fn(*args, **kwargs)

    def decode_gather():
        boxes = box_ops.clip_boxes(box_ops.decode_deltas(*dec[0], **dec[1]), *clip[0][1:],
                                   **clip[1])
        top_idx = flat[2][1]
        return torch.gather(boxes.reshape(B, -1, 4), 1, top_idx[..., None].expand(-1, -1, 4))

    subs = [("  rpn: level top_k",
             lambda: [nms_ops.sort_desc(*a, **k) for a, k, _ in levels]),
            ("  rpn: NMS", rerun(rpn_nms, nms_ops.nms_mask)),
            ("  nms: flat top_k", rerun(flat, nms_ops.sort_desc)),
            ("  nms: decode+gather", decode_gather),
            ("  nms: batched NMS", rerun(cls_nms, nms_ops.batched_nms_indices))]
    return s["out"], s, subs


@torch.no_grad()
def run(cfg, bs: int = 32, image: int = bench.IMG, rounds: int = 3, iters: int = 10,
        device="cuda", model=None):
    """Profile inference's stages (module docstring); prints one line per
    stage. Returns (record, outputs of the stage chain, the inputs)."""
    device = bt.cuda_device(device)
    model = bench.random_model(cfg, device) if model is None else model
    kw = rcnn3d.inference_kwargs(cfg)
    _, images, Ks, ratios = bench.inputs(cfg, (bs,), image, device)[bs]
    full = lambda: rcnn3d.inference(model, images, Ks, ratios, **kw)  # noqa: E731
    graphed = lambda: rcnn3d.inference_step(model, images, Ks, ratios, **kw)  # noqa: E731
    for _ in range(2):
        full()
        graphed()
    out, s, subs = stage_chain(model, images, Ks, ratios, **kw)
    calls = {"full step": full, GRAPHED: graphed}
    for name, stage in STAGES:
        calls[name] = lambda stage=stage: stage(model, s)
    calls.update(subs)
    for f in calls.values():   # every stage once before the timed rounds
        f()
    times = bt.in_turns({n: (lambda f=f: bt.timed_calls(f, iters)) for n, f in calls.items()},
                        rounds)
    profiles = {n: bt.device_profile(f, iters, device) for n, f in calls.items()}
    flops = {n: bt.model_flops(model, f)[0].model for n, f in calls.items() if n != GRAPHED}
    flops[GRAPHED] = flops["full step"]   # a replay runs no Python for the counter to see
    full_ms = times["full step"]["median_ms"]
    stage_names = [n for n, _ in STAGES]
    dtype = model.dtype
    peak = bt.peaks()["bfloat16" if dtype == torch.bfloat16 else "float32"] \
        if device.type == "cuda" else None
    record = {
        "batch": bs, "image_hw": [image, image], "dtype": str(dtype).replace("torch.", ""),
        "device": str(device), **bt.card_fields(device), "rounds": rounds, "iters": iters,
        "stage_ms": {n: t["median_ms"] for n, t in times.items()},
        "stage_ms_range": {n: [t["min_ms"], t["max_ms"]] for n, t in times.items()},
        "stage_device_ms": {n: p["device_busy_ms_per_call"] for n, p in profiles.items()},
        "stage_kernels": {n: p["kernels_per_call"] for n, p in profiles.items()},
        "stage_gflop": {n: f / 1e9 for n, f in flops.items()},
        "full_step_ms": full_ms, "img_per_s": bs * 1e3 / full_ms,
        "sum_of_stages_ms": sum(times[n]["median_ms"] for n in stage_names),
        "flops_per_step": flops["full step"],
        "tflops_per_s": flops["full step"] / full_ms / 1e9,
        "mfu": bt.mfu(flops["full step"], full_ms, dtype, device),
        "peak_tflops_assumed": None if peak is None else peak / 1e12,
        "device_busy_share": bt.busy_share(profiles["full step"], full_ms),
        "kernels_per_call": profiles["full step"]["kernels_per_call"],
        "roi_align_launches_per_call": profiles["full step"]["roi_align_launches_per_call"],
        "top_kernels_ms_per_call": profiles["full step"]["top_kernels_ms_per_call"],
        "graphed_full_call_ms": times[GRAPHED]["median_ms"],
        "graphed_hand_kernel_launches_per_call":
            profiles[GRAPHED]["hand_kernel_launches_per_call"],
        "graphed_device_busy_share": bt.busy_share(profiles[GRAPHED],
                                                   times[GRAPHED]["median_ms"]),
    }
    for n in calls:
        print(f"{n:<24}: {record['stage_ms'][n]:8.2f} ms  device "
              f"{bt.fmt(record['stage_device_ms'][n], '.2f')} ms  kernels "
              f"{bt.fmt(record['stage_kernels'][n], '.0f')}  "
              f"{record['stage_gflop'][n]:8.1f} GFLOP", flush=True)
    print(f"sum of stages {record['sum_of_stages_ms']:.2f} ms, full call {full_ms:.2f} ms "
          f"({record['img_per_s']:.1f} img/s), busy {bt.fmt(record['device_busy_share'])}, "
          f"mfu {bt.fmt(record['mfu'])}; graphed {record['graphed_full_call_ms']:.2f} ms, busy "
          f"{bt.fmt(record['graphed_device_busy_share'])}", flush=True)
    return record, out, (images, Ks, ratios)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record, _, _ = run(bench.config(), args.bs, rounds=args.rounds, iters=args.iters,
                       device=args.device)
    if args.out:
        bench.write_record(args.out, record)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
