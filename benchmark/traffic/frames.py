"""The inference generator: frames from a seeded pool through the program's
evaluation path, one closed-loop client.

Each call takes the next `batch` frames of the pool and drives them as
`engine.loop.run_inference_dataset` drives a test batch:
`data.mapper.batch_to_device` (uint8 from pinned host memory, normalised
on the card) -> `models.rcnn3d.inference_step` (one CUDA graph per padded
shape) -> `engine.loop._to_host` (one synchronising copy). The next call
starts when the last returns. Parameters come from the cell's workload
file: the source frame size, the batch, the pool size, the camera
intrinsics at source resolution, how many calls the correctness check
samples, the traced calls, and the limits of the compared numbers. The
network size and the padding are the program's test loader's:
`mapper.resize_shortest_edge` to the config's INPUT.MIN_SIZE_TEST and
MAX_SIZE_TEST, padded by `mapper.pad_to_bucket`; the batch is written into
the program's TPU.EVAL_BATCH_SIZE.

End-to-end: `offline_img_per_s` (images of all calls in the window over
the window's time, to the end of its last call), `live_p95_ms` (95th
percentile of every call's latency on the host clock, from the uint8
frames in host memory to the detections in host memory), `peak_mem_gib`.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import checks, trace
from ..reference import model as ref
from ..weights import calibrated_state
from ..yardstick.flops import model_flops
from ..yardstick.peaks import peaks
from ..yardstick.work import bound_ms, pool_work


def frame_shape(spec: dict, cfg: dict, train: bool = False) -> tuple:
    """((h, w), (Hp, Wp)) of the cell's frames as the program's loader
    makes them: resized by the config's test (or single training) short
    side and long-side cap, padded to the loader's bucket."""
    from omni3d_tpu_torch.data.mapper import pad_to_bucket, resize_shortest_edge
    inp = cfg["INPUT"]
    if train:
        if len(inp["MIN_SIZE_TRAIN"]) != 1:
            raise ValueError("a training cell runs one short side: INPUT.MIN_SIZE_TRAIN")
        short, cap = inp["MIN_SIZE_TRAIN"][0], inp["MAX_SIZE_TRAIN"]
    else:
        short, cap = inp["MIN_SIZE_TEST"], inp["MAX_SIZE_TEST"]
    h, w = resize_shortest_edge(*spec["source_hw"], short, cap)
    return (h, w), pad_to_bucket(h, w)


def frame_pool(spec: dict, cfg: dict, seed: int, device) -> dict:
    """The seeded pool: uint8 BGR frames (N, Hp, Wp, 3) at network size,
    zero in the padding, in pinned host memory (numpy views), with hw, Ks
    and ratios per frame."""
    h0 = spec["source_hw"][0]
    (h, w), (hp, wp) = frame_shape(spec, cfg)
    n = spec["pool_frames"]
    gen = torch.Generator(device=device).manual_seed((seed * 2 + 1) % (1 << 63))
    frames = torch.zeros((n, hp, wp, 3), dtype=torch.uint8, device=device)
    frames[:, :h, :w] = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device,
                                      dtype=torch.uint8)
    host = torch.empty(frames.shape, dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")
    host.copy_(frames)
    return {"images": host.numpy(), "hw": np.tile(np.float32([h, w]), (n, 1)),
            "Ks": np.tile(np.float32(spec["K"]), (n, 1, 1)),
            "ratios": np.full(n, h0 / h, np.float32)}


def batches(pool: dict, bs: int) -> list:
    """The pool cut into collated batches (numpy views of the pinned pool)."""
    n = pool["images"].shape[0] // bs
    return [{k: v[i * bs:(i + 1) * bs] for k, v in pool.items()} for i in range(n)]


def normalized(batch: dict, cfg: dict, device) -> tuple:
    """The reference's own inputs of a collated batch: (images normalized
    with zero outside hw, Ks, ratios, hw) on `device`."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    images = ref.preprocess(t["images"], cfg["MODEL"]["PIXEL_MEAN"], cfg["MODEL"]["PIXEL_STD"])
    H, W = images.shape[1:3]
    rows = torch.arange(H, device=device)[None, :, None] < t["hw"][:, 0, None, None]
    cols = torch.arange(W, device=device)[None, None, :] < t["hw"][:, 1, None, None]
    images = torch.where((rows & cols)[..., None], images, torch.zeros((), device=device))
    return images, t["Ks"], t["ratios"], t["hw"]


def reference_outputs(model, images, Ks, ratios, hw) -> dict:
    """The reference computing what `inference_step` returns (the keys the
    checks read), used in the program's place by the control."""
    flist, boxes, valid = ref.proposal_stage(model, images, hw)
    dets = ref.detect(model, flist, boxes, valid, hw)
    cube = ref.cube_stage(model, flist, dets["boxes"], dets["classes"], Ks, ratios)
    fused = torch.sqrt((dets["scores"] * cube["conf"]).clamp(min=0.0))
    return {"proposal_boxes": boxes, "proposal_valid": valid, "valid": dets["valid"],
            "classes": dets["classes"], "boxes": dets["boxes"],
            "boxes_orig": dets["boxes"] * ratios[:, None, None],
            "scores_2d": dets["scores"],
            "scores_full": dets["scores_full"],
            "scores": torch.where(dets["valid"], fused, torch.zeros_like(fused)),
            "center_cam": cube["center_cam"], "dims": cube["dims"], "pose": cube["pose"]}


class Program:
    """The system under test: the port's model with the benchmark's weights
    and the three calls of the timed path."""

    def __init__(self, ctx, state: dict):
        from omni3d_tpu_torch.data.mapper import batch_to_device
        from omni3d_tpu_torch.engine import loop
        from omni3d_tpu_torch.models import rcnn3d
        self.rcnn3d, self.to_device, self.to_host = rcnn3d, batch_to_device, loop._to_host
        self.cfg = ctx.port_cfg()
        self.cfg.TPU.EVAL_BATCH_SIZE = ctx.spec["batch"]
        self.device = ctx.device
        self.model = rcnn3d.build_model(self.cfg, device=ctx.device)
        self.model.load_state_dict(state)
        self.kw = rcnn3d.inference_kwargs(self.cfg)
        if ctx.substitute == "no_det_nms":   # a planted fault: NMS that suppresses nothing
            self.kw["nms_thresh"] = 1.0
        self.host_s = []   # host seconds inside inference_step, per call

    def feed(self, batch):
        return self.to_device(batch, self.device, self.cfg.MODEL.PIXEL_MEAN,
                              self.cfg.MODEL.PIXEL_STD)

    def __call__(self, batch):
        with trace.span("feed"):
            d = self.feed(batch)
        with trace.span("inference_step"):
            t0 = time.perf_counter()
            out = self.rcnn3d.inference_step(self.model, d["images"], d["Ks"], d["ratios"],
                                             hw=d["hw"], **self.kw)
            self.host_s.append(time.perf_counter() - t0)
        with trace.span("to_host"):
            host = self.to_host(out)
        return out, host

    def features_ms(self, batch, calls: int) -> float:
        """Device busy ms per call of `CubeRCNN.features` alone on a batch."""
        images = self.feed(batch)["images"]
        with torch.no_grad():
            self.model.features(images)
            t = trace.profile(lambda i: self.model.features(images), calls)
        return t.busy_us / 1e3 / calls

    def forward_flops(self, batch) -> int:
        d = self.feed(batch)
        count, _ = model_flops(self.model, lambda: self.rcnn3d.inference(
            self.model, d["images"], d["Ks"], d["ratios"], hw=d["hw"], **self.kw))
        return count.forward

    def free(self):
        self.model.inference_graphs = None
        del self.model


FAULTS = ("moved_boxes", "dropped_dets", "no_det_nms")


class Substitute:
    """The plain reference in the program's place (`control`: float32
    with fp8-rounded products, the precision below the configuration's
    bf16), or the program with a planted fault: `moved_boxes`, the first
    image's boxes moved 8 pixels where they are returned; `dropped_dets`,
    every other detection of the first image dropped there; `no_det_nms`,
    the per-class NMS run at IoU threshold 1, so it suppresses nothing
    (set in `Program`)."""

    def __init__(self, ctx, program: Program, state: dict):
        self.kind, self.program, self.ctx = ctx.substitute, program, ctx
        if self.kind == "control":
            self.model = ref.set_fp8(ref.build(ctx.config["cfg"], ctx.device))
            self.model.load_state_dict(state)
        elif self.kind not in FAULTS:
            raise ValueError(f"unknown substitute {self.kind!r}")

    def __call__(self, batch):
        if self.kind in FAULTS:
            out, host = self.program(batch)
            if self.kind == "no_det_nms":
                return out, host
            if self.kind == "moved_boxes":
                out["boxes_orig"][0] += 8.0
            else:
                out["valid"][0, ::2] = False
            return out, self.program.to_host(out)
        images, Ks, ratios, hw = normalized(batch, self.ctx.config["cfg"], self.ctx.device)
        out = reference_outputs(self.model, images, Ks, ratios, hw)
        return out, {k: v.cpu() for k, v in out.items()}


def run(ctx) -> dict:
    spec = ctx.spec
    bs = spec["batch"]
    pool = frame_pool(spec, ctx.config["cfg"], ctx.seed, ctx.device)
    feed = batches(pool, bs)
    n = spec["calibration_frames"]
    calib = normalized({k: v[:n] for k, v in pool.items()}, ctx.config["cfg"],
                       ctx.device)[0] if n else None
    state = calibrated_state(ctx.config, ctx.seed, calib, spec.get("calibration_rms"), ctx.device)
    ctx.free_memory()
    ctx.reset_peak()          # the peak is the program's, from here
    program = Program(ctx, state)
    call = program if ctx.substitute is None else Substitute(ctx, program, state)
    for i in range(spec["warmup_calls"]):          # the first captures the graph
        call(feed[i % len(feed)])
    ctx.sync()
    setup_s = ctx.elapsed()

    rng = random.Random(ctx.seed)
    keep, latencies = [], []                        # keep: a reservoir of sampled calls
    captures0 = program.rcnn3d.inference_step.captures
    program.host_s.clear()
    i = 0
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        out, _ = call(feed[i % len(feed)])
        e = time.perf_counter()
        latencies.append(e - s)
        if len(keep) < spec["check_calls"]:
            keep.append((i % len(feed), out))
        else:
            j = rng.randrange(i + 1)
            if j < spec["check_calls"]:
                keep[j] = (i % len(feed), out)
        i += 1
        if e - t0 >= ctx.seconds:
            break
    window_s = e - t0
    lat = np.asarray(latencies) * 1e3
    ctx.note(f"window {window_s:.3f} s, {i} calls, latency ms p50 {np.percentile(lat, 50):.4f} "
             f"p95 {np.percentile(lat, 95):.4f} p99 {np.percentile(lat, 99):.4f} "
             f"max {lat.max():.4f}")
    captures = program.rcnn3d.inference_step.captures - captures0
    host_ms = 1e3 * sum(program.host_s) / len(program.host_s) if program.host_s else None
    peak_bytes = ctx.memory_peak()
    res = {
        "attempted": i * bs, "failed": 0, "memory_peak_bytes": peak_bytes,
        "e2e": {"offline_img_per_s": i * bs / window_s,
                "live_p95_ms": float(np.percentile(lat, 95)),
                "peak_mem_gib": peak_bytes / 2 ** 30, "setup_s": setup_s},
    }
    facts = {}
    if ctx.trace:
        tr = trace.profile(lambda k: call(feed[k % len(feed)]), spec["trace_calls"])
        peak = peaks(ctx.card_name()) if ctx.on_card() else None
        facts = {"trace": tr, "rate_img_per_s": i * bs / window_s, "peak": peak, "host_ms_per_call": host_ms, "captures_in_window": captures,
                 "trunk_device_ms": program.features_ms(feed[0], spec["trace_calls"]),
                 "flops_per_image": program.forward_flops(feed[0]) / bs}
        res["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        res["busy_s"], res["window_s"] = tr.busy_us / 1e6, tr.window_us / 1e6

    # the check, once the program's state is freed
    program.free()
    del call
    ctx.free_memory()
    ctx.reference_precision()
    model = ref.build(ctx.config["cfg"], ctx.device)
    model.load_state_dict(state)
    rows, work = [], []
    t_check = time.perf_counter()
    for idx, out in keep:
        inputs = normalized(feed[idx], ctx.config["cfg"], ctx.device)
        rows.append(checks.inference_numbers(model, *inputs, out))
        if ctx.trace:
            work.append(_pool_bound(model, *inputs, facts["peak"]))
    res["numbers"] = checks.worst(rows)
    ctx.note(f"reference check {time.perf_counter() - t_check:.3f} s over {len(keep)} calls")
    if ctx.trace and facts["peak"] is not None:
        kernel_ms, _ = facts["trace"].kernel_ms_per_call("roi_align_fwd")
        facts["roi_align_fwd"] = {"bound_ms": sum(work) / len(work), "kernel_ms": kernel_ms}
    res["facts"] = facts
    return res


def _pool_bound(model, images, Ks, ratios, hw, peak) -> float | None:
    """The forward pooler's bound ms for one call on these inputs: both
    poolings (the box pooler on the reference's proposals, the cube pooler
    on its scaled detections), bf16 features, each touched cell read once
    and each pooled value written once, float32 operations."""
    if peak is None:
        return None
    cfg = model.cfg
    flist, boxes, valid = ref.proposal_stage(model, images, hw)
    dets = ref.detect(model, flist, boxes, valid, hw)
    cube_boxes = ref.scale_proposals(dets["boxes"], cfg.MODEL.ROI_CUBE_HEAD.SCALE_ROI_BOXES)
    shapes = [tuple(f.shape[1:3]) for f in flist]
    C = flist[0].shape[-1]
    total = 0.0
    for b, P in ((boxes, cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION),
                 (cube_boxes, cfg.MODEL.ROI_CUBE_HEAD.POOLER_RESOLUTION)):
        touched, ops, _ = pool_work(b, shapes, ref.FEATURE_STRIDES, cfg.TPU.ROI_SAMPLING_RATIO,
                                    C, P)
        out_bytes = b.shape[0] * b.shape[1] * P * P * C * 2
        total += bound_ms(touched * C * 2 + out_bytes, ops, peak)
    return total
