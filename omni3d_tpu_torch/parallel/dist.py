"""Multi-process helpers (port of `omni3d_tpu.parallel.dist`): joining the
process group, the world-size check, mean all-reduces and the host-side
object gather.

The JAX package runs one process per host and shards its step over a 1-D
device mesh (`make_mesh`), assembling the global batch from each process's
loader slice (`globalize_batch`). The port follows the reference's DDP
contract instead (reference tools/train_net.py:451-454): one process per
GPU, each feeding its own rank-local batch to `DistributedDataParallel`. So
`globalize_batch` has no counterpart here, and the JAX step's image offset
`lax.axis_index("data") * b` becomes rank x local batch
(`engine.train.make_train_step`).

Without a process group every helper answers for one process and touches
no collective.
"""
from __future__ import annotations

import multiprocessing
import socket
import time

import torch
import torch.distributed as dist


def process_group_active() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def init_distributed(dist_init: str, num_processes: int, process_id: int, device,
                     backend: str | None = None) -> torch.device:
    """Join the process group as rank `process_id` of `num_processes` (the
    stand-in for the JAX CLI's `jax.distributed.initialize`).

    dist_init: rank 0's address as `host:port` (the JAX CLI's form; a TCP
      store), or a full init URL such as `file:///path/to/store`.
    device: this rank's device; a CUDA device becomes the current one.
    backend: NCCL for a CUDA device and gloo for the CPU unless given. Pass
      "gloo" to put several ranks on one card, which NCCL refuses.
    Returns the rank's device.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=dist_init if "://" in dist_init
                            else "tcp://" + dist_init,
                            world_size=num_processes, rank=process_id, **kw)
    return device


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if process_group_active() else 0


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if process_group_active() else 1


def check_world(cfg) -> int:
    """The data-parallel width (the counterpart of `make_mesh`):
    TPU.MESH_DATA <= 0 means every process; a positive value must equal
    the number of processes. Returns that number."""
    world, want = process_count(), cfg.TPU.MESH_DATA
    if want > 0 and want != world:
        raise ValueError(f"TPU.MESH_DATA={want} asks for {want} data-parallel processes, "
                         f"but the process group has {world}")
    return world


def barrier() -> None:
    if process_group_active():
        dist.barrier()


def mean_across_ranks(tensors: list) -> list:
    """The mean over the ranks of each float32 tensor, through ONE
    all-reduce of their concatenation (the JAX step's fused `pmean`).
    Without a process group: the tensors themselves."""
    if not process_group_active():
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def gather_objects(objs: list) -> list:
    """All-gather a Python list across the processes: every rank gets the
    concatenation in rank order. With one process: `list(objs)`, and no
    collective."""
    if process_count() == 1:
        return list(objs)
    parts = [None] * process_count()
    dist.all_gather_object(parts, list(objs))
    return [o for part in parts for o in part]


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now: the store address of a
    process group on one machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_spawned(target, argsets: list, timeout: float) -> None:
    """Run target(*args) for each args in `argsets`, each in its own process
    started with the spawn method, all at once (the ranks of one process
    group, say); raise unless every one exits with 0 within `timeout`
    seconds. A process still running then is killed."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=tuple(args)) for args in argsets]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    stuck = [p for p in procs if p.is_alive()]
    for p in stuck:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if stuck or any(codes):
        raise RuntimeError(f"{getattr(target, '__name__', target)}: exit codes {codes}; "
                           f"{len(stuck)} killed after {timeout} s")
