"""Per-block profile of the trunk and the FPN on a CUDA card (the port's
counterpart of the JAX package's tools/profile_backbone.py).

    python -m omni3d_tpu_torch.tools.profile_backbone [--bs 32] [--rounds 3]
        [--iters 10] [--config-file configs/cubercnn_ResNet34_FPN.yaml]
        [--out FILE] [--device cpu]

`model.features` (the trunk of --config-file, DLA-34 by default, and the
FPN) at full width, 512 px, the config's compute dtype (bf16), eval mode,
channels-last as the model runs, seeded random weights, on `tools.bench`'s
draw for the batch size. `blocks` splits it into the trunk's top-level
blocks (DLA: base_layer, level0 ... level5; ResNet: stem, res2 ... res5;
DenseNet, MNASNet, ShuffleNet: their stem and stages), the p6 pool, each FPN
lateral, top-down sum and output convolution, and the NHWC views that
`features` returns beside the maps (no copy: the maps are channels-last); run in order, the blocks give
`model.features`' outputs exactly (a test holds them). The port's DLA stem
is the plain base_layer + level0 + level1; the JAX tool's "stem (s2d
chain)" is the TPU's packed stem.

Each block is timed alone on its captured inputs (--rounds rounds of
--iters calls, the blocks and the whole `features` in turns). Per block:
ms, model FLOPs (`utils.benchtime.model_flops`), bytes (inputs and outputs
once, nothing for an output that is a view of an input; the parameters and
buffers of the modules it calls once), the
roofline bound from `utils.benchtime.PEAKS` (FLOPs over the dtype's dense
rate, bytes over the memory rate; the larger decides the verdict, compute
or memory) and the share of the bound reached. Also the sum of the blocks
against the whole. Prints one JSON object as its last line and writes it to
--out. On the CPU the device fields (bound, share) are null.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.nn.functional as F

from ..models import rcnn3d
from ..models.dla import DLA
from ..models.extra_backbones import DenseNet121, MNASNet10, ShuffleNetV2
from ..models.layers import max_pool, upsample_nearest_2x
from ..models.resnet import ResNet
from ..utils import benchtime as bt
from . import bench


def _trunk_blocks(bu):
    """(name, fn(env) -> value, output key) of the bottom-up trunk `bu`, in
    its forward's order, from env["x"] (NCHW images in the compute dtype)
    to env["p2"] ... env["p6"]."""
    def mod(m, src):
        return lambda e: m(e[src])

    p6 = ("p6 maxpool", lambda e: max_pool(e["p5"], 1, 2), "p6")
    if isinstance(bu, DLA):
        seq = [("base_layer", "x", "b"), ("level0", "b", "l0"), ("level1", "l0", "l1"),
               ("level2", "l1", "p2"), ("level3", "p2", "p3"), ("level4", "p3", "p4"),
               ("level5", "p4", "p5")]
        return [(n, mod(getattr(bu, n), src), dst) for n, src, dst in seq] + [p6]
    if isinstance(bu, ResNet):
        stem = ("stem", lambda e: max_pool(F.relu(bu.bn1(bu.conv1(e["x"]))), 3, 2, padding=1),
                "s")
        return [stem] + [(f"res{i + 2}", mod(getattr(bu, f"layer{i + 1}"), src), f"p{i + 2}")
                         for i, src in enumerate(("s", "p2", "p3", "p4"))] + [p6]
    if isinstance(bu, DenseNet121):
        b = bu.base
        stem = ("stem", lambda e: max_pool(F.relu(b.norm0(b.conv0(e["x"]))), 3, 2, padding=1),
                "s")
        seq = [("denseblock1", "s", "p2"), ("transition1", "p2", "t1"),
               ("denseblock2", "t1", "p3"), ("transition2", "p3", "t2"),
               ("denseblock3", "t2", "p4"), ("transition3", "p4", "t3"),
               ("denseblock4", "t3", "d4"), ("norm5", "d4", "p5")]
        return [stem] + [(n, mod(getattr(b, n), src), dst) for n, src, dst in seq] + [p6]
    if isinstance(bu, MNASNet10):
        b = bu.base
        seq = [("stem", b[0:8], "x", "s"), ("stack1", b[8], "s", "p2"),
               ("stack2", b[9], "p2", "p3"), ("stack3", b[10], "p3", "k3"),
               ("stack4", b[11], "k3", "p4"), ("stack5", b[12], "p4", "k5"),
               ("stack6", b[13], "k5", "p5")]
        return [(n, mod(m, src), dst) for n, m, src, dst in seq] + [p6]
    if isinstance(bu, ShuffleNetV2):
        return ([("conv1", mod(bu.conv1, "x"), "c1"),
                 ("maxpool", lambda e: max_pool(e["c1"], 3, 2, padding=1), "p2")]
                + [(f"stage{i}", mod(getattr(bu, f"stage{i}"), f"p{i}"), f"p{i + 1}")
                   for i in (2, 3, 4)] + [p6])
    raise ValueError(f"no block table for {type(bu).__name__}")


def blocks(model):
    """(name, fn(env) -> value, output key) of `model.features`, in order:
    the input to NCHW in the compute dtype, the trunk's blocks, the FPN's
    laterals, top-down sums and outputs (FPN.forward's order of operations),
    and the NHWC views. Run in order over env = {"images": ...}, they leave
    `features`' two outputs in env["feats"] and env["flist"]."""
    fpn = model.backbone
    out = [("to NCHW", lambda e: e["images"].permute(0, 3, 1, 2).to(model.dtype), "x")]
    out += _trunk_blocks(fpn.bottom_up)
    feats = list(fpn.in_features)
    for s, f in zip(fpn.stages, feats):
        out.append((f"fpn_lateral{s}", lambda e, m=getattr(fpn, f"fpn_lateral{s}"), f=f:
                    m(e[f]), f"lat{s}"))
    last = len(feats) - 1
    prev = None   # env key of the top-down path's running sum
    for i in range(last, -1, -1):
        s = fpn.stages[i]
        if i == last:
            prev = f"lat{s}"
        else:
            def topdown(e, s=s, above=prev):
                lat = e[f"lat{s}"]
                td = upsample_nearest_2x(e[above])[:, :, : lat.shape[2], : lat.shape[3]]
                return (lat + td) * 0.5 if fpn.fuse_type == "avg" else lat + td
            out.append((f"fpn top-down {s}", topdown, f"sum{s}"))
            prev = f"sum{s}"
        out.append((f"fpn_output{s}", lambda e, m=getattr(fpn, f"fpn_output{s}"), src=prev:
                    m(e[src]), f"out_{feats[i]}"))
    out.append(("feats", lambda e: {f: e[f"out_{f}"] for f in feats}, "feats"))
    out.append(("NHWC views", lambda e: [e["feats"][f].permute(0, 2, 3, 1).contiguous()
                                         for f in rcnn3d.FEATURE_NAMES], "flist"))
    return out


def run_blocks(model, images):
    """The blocks run in order; returns the env (every block's output)."""
    env = {"images": images}
    for _, fn, key in blocks(model):
        env[key] = fn(env)
    return env


def _tensors(v):
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, dict):
        v = list(v.values())
    return [t for x in v for t in _tensors(x)] if isinstance(v, (list, tuple)) else []


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _moved_bytes(ins, out):
    """Bytes a block must move: its outputs written once and its inputs read
    once, except an output that is a view of an input (no data moves)."""
    def unique(ts):   # one tensor per storage: views of one buffer move it once
        return list({t.untyped_storage().data_ptr(): t for t in ts}.values())
    ins, outs = unique(_tensors(ins)), unique(_tensors(out))
    in_ptrs = {t.untyped_storage().data_ptr() for t in ins}
    out_ptrs = {t.untyped_storage().data_ptr() for t in outs}
    return (_nbytes([t for t in ins if t.untyped_storage().data_ptr() not in out_ptrs])
            + _nbytes([t for t in outs if t.untyped_storage().data_ptr() not in in_ptrs]))


def _weight_bytes(model, fn):
    """Bytes of the parameters and buffers of the modules `fn()` calls."""
    seen = set()
    hooks = [m.register_forward_pre_hook(lambda m, _: seen.add(m)) for m in model.modules()]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return sum(_nbytes(list(m.parameters(recurse=False)) + list(m.buffers(recurse=False)))
               for m in seen)


def _inputs_of(fn, env):
    """The env entries a block reads (found by running it on a recording dict)."""
    class Reads(dict):
        def __getitem__(self, k):
            used.add(k)
            return super().__getitem__(k)
    used = set()
    fn(Reads(env))
    return [env[k] for k in used]


@torch.no_grad()
def run(cfg, bs: int = 32, image: int = bench.IMG, rounds: int = 3, iters: int = 10,
        device="cuda", model=None):
    """Profile `model.features` block by block (module docstring). Returns
    (record, env of the blocks run in order, `model.features`' outputs)."""
    device = bt.cuda_device(device)
    model = bench.random_model(cfg, device) if model is None else model
    _, images, _, _ = bench.inputs(cfg, (bs,), image, device)[bs]
    whole = lambda: model.features(images)  # noqa: E731
    want = whole()
    env = run_blocks(model, images)
    table = [(n, fn, key) for n, fn, key in blocks(model) if n != "feats"]
    calls = {"backbone+FPN": whole}
    calls.update({n: (lambda fn=fn: fn(env)) for n, fn, _ in table})
    for f in calls.values():
        f()
    times = bt.in_turns({n: (lambda f=f: bt.timed_calls(f, iters)) for n, f in calls.items()},
                        rounds)
    p = bt.peaks() if device.type == "cuda" else None
    rate = None if p is None else p["bfloat16" if model.dtype == torch.bfloat16 else "float32"]
    ins = {n: _inputs_of(fn, env) for n, fn, _ in table}
    ins["backbone+FPN"] = [images]
    outs = {n: env[key] for n, _, key in table}
    outs["backbone+FPN"] = want
    rows = []
    for n, f in calls.items():
        fl = bt.model_flops(model, f)[0].model
        moved = _moved_bytes(ins[n], outs[n]) + _weight_bytes(model, f)
        ms = times[n]["median_ms"]
        row = {"block": n, "ms": ms, "ms_range": [times[n]["min_ms"], times[n]["max_ms"]],
               "gflop": fl / 1e9, "bytes": moved, "bound_ms": None, "bound_by": None,
               "share_of_bound": None}
        if p is not None:
            t_ops, t_bytes = fl / rate * 1e3, moved / p["hbm_bytes_per_s"] * 1e3
            row.update(bound_ms=max(t_ops, t_bytes),
                       bound_by="compute" if t_ops >= t_bytes else "memory",
                       share_of_bound=max(t_ops, t_bytes) / ms)
        rows.append(row)
        print(f"{n:<18}: {ms:8.3f} ms  {fl / 1e9:8.1f} GFLOP  {moved / 1e6:8.1f} MB  bound "
              f"{bt.fmt(row['bound_ms'], '.3f')} ms ({row['bound_by']}), share "
              f"{bt.fmt(row['share_of_bound'], '.2f')}", flush=True)
    block_sum = sum(r["ms"] for r in rows[1:])
    print(f"sum of blocks {block_sum:.2f} ms, whole features {rows[0]['ms']:.2f} ms", flush=True)
    record = {"batch": bs, "image_hw": [image, image], "trunk": type(model.backbone.bottom_up)
              .__name__, "dtype": str(model.dtype).replace("torch.", ""), "device": str(device),
              **bt.card_fields(device), "rounds": rounds, "iters": iters, "blocks": rows,
              "sum_of_blocks_ms": block_sum, "whole_ms": rows[0]["ms"],
              "peak_tflops_assumed": None if rate is None else rate / 1e12,
              "hbm_bytes_per_s_assumed": None if p is None else p["hbm_bytes_per_s"]}
    return record, env, want


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--config-file", default=bench.CONFIG)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record, _, _ = run(bench.config(args.config_file), args.bs, rounds=args.rounds,
                       iters=args.iters, device=args.device)
    record["config"] = os.path.relpath(os.path.abspath(args.config_file), bench.ROOT)
    if args.out:
        bench.write_record(args.out, record)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
