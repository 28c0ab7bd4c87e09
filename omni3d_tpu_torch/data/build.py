"""Samplers and batch loaders (host side, numpy).

Port of `omni3d_tpu.data.build` (the reference loader construction,
cubercnn/data/build.py:47-230) with the four sampling modes:
  * TrainingSampler (infinite shuffled stream),
  * RepeatFactorTrainingSampler with LVIS-style per-category repeat factors
    (build.py:129-174),
  * dataset-balancing weights (build.py:68-91),
  * both combined (build.py:109-115).

Loaders yield padded static-shape batches with uint8 images
(`mapper.collate_batch(normalize=False)`; `mapper.batch_to_device`
normalises them on the device) and are sharded per process: each process
feeds its local slice of the global batch.

A seed gives the JAX package's batches: every numpy Generator is consumed
in its order (the shape cell from the shared stream, the group's sampler,
the per-image short sides, the flips). The flips are drawn here, in image
order, before the images are mapped, so the batches do not depend on
DATALOADER.NUM_WORKERS (the JAX package draws them inside its worker
threads, in thread order; it equals this loader at 0 or 1 workers).

The images of a batch are mapped in worker processes, not threads (the
JAX package uses threads): PNG's Average and Paeth rows decode in Python
and hold the GIL, and in threads that starved the thread that launches
the training step's kernels (PERF.md, Findings).
"""
from __future__ import annotations

import itertools
import math
import multiprocessing
import queue
import threading
from collections import defaultdict

import numpy as np

from .datasets import get_dataset
from .mapper import (DatasetMapper3D, collate_batch, pad_to_bucket,
                     resize_shortest_edge)


def get_detection_dataset_dicts(names, filter_empty: bool = True):
    """reference build.py:26-44."""
    if isinstance(names, str):
        names = [names]
    dicts = [get_dataset(n) for n in names]
    for n, d in zip(names, dicts):
        assert len(d), f"Dataset '{n}' is empty!"
    records = list(itertools.chain.from_iterable(dicts))
    if filter_empty and "annotations" in records[0]:
        records = [
            r for r in records
            if any(a.get("category_id", -1) >= 0 for a in r["annotations"])
        ]
    assert records, f"No valid data found in {names}"
    return records


def repeat_factors_from_category_frequency(records, repeat_thresh: float) -> np.ndarray:
    """LVIS repeat factors r(I) = max_c sqrt(t / f(c)) (build.py:129-174)."""
    freq = defaultdict(int)
    for r in records:
        for cat in {a["category_id"] for a in r["annotations"]}:
            if cat >= 0:
                freq[cat] += 1
    n = len(records)
    rep = {c: max(1.0, math.sqrt(repeat_thresh / (v / n))) for c, v in freq.items()}
    out = []
    for r in records:
        cats = {a["category_id"] for a in r["annotations"] if a["category_id"] >= 0}
        out.append(max((rep[c] for c in cats), default=1.0))
    return np.asarray(out, np.float64)


def dataset_balance_weights(records, dataset_id_to_src: dict) -> np.ndarray:
    """Per-image weights equalizing dataset sources (build.py:68-91)."""
    src_to_int = {v: i for i, v in enumerate(sorted(set(dataset_id_to_src.values())))}
    ids = np.asarray([src_to_int[dataset_id_to_src[r["dataset_id"]]] for r in records])
    uniq = np.unique(ids)
    if len(uniq) == 1:
        return np.ones(len(records))
    counts = np.bincount(ids)
    weights = np.array([1 - counts[i] / counts.sum() for i in uniq], np.float64)
    weights = weights / weights.min()
    out = np.zeros(len(records))
    for i, w in zip(uniq, weights):
        out[ids == i] = w
    return out


def _map_one(mapper, record, short, flip):
    """One image of a batch, in a worker process (module level: picklable)."""
    return mapper(record, short=int(short), flip=flip)


class TrainingSampler:
    """Infinite shuffled index stream (detectron2 TrainingSampler)."""

    def __init__(self, size: int, seed: int = 0, shuffle: bool = True):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle

    def __iter__(self):
        while True:
            idx = np.arange(self.size)
            if self.shuffle:
                self.rng.shuffle(idx)
            yield from idx


class RepeatFactorTrainingSampler:
    """Infinite stream with per-image fractional repeat factors (stochastic
    rounding per epoch, detectron2 semantics)."""

    def __init__(self, repeat_factors: np.ndarray, seed: int = 0):
        self.factors = np.asarray(repeat_factors, np.float64)
        self.int_part = np.floor(self.factors).astype(np.int64)
        self.frac_part = self.factors - self.int_part
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            rands = self.rng.random(len(self.factors))
            reps = self.int_part + (rands < self.frac_part)
            idx = np.repeat(np.arange(len(self.factors)), reps)
            self.rng.shuffle(idx)
            yield from idx


class ShapeBuckets:
    """Static train-shape schedule: ≤ TPU.TRAIN_SIZE_BUCKETS padded (H, W)
    shapes covering the full multi-scale augmentation range.

    Replaces detectron2's aspect-ratio grouping (reference build.py:185-191)
    and bounds the distinct batch shapes (and so the allocator's and cuDNN's
    per-shape work): records are grouped by aspect class, each group gets a
    budget of canonical short sides carved from INPUT.MIN_SIZE_TRAIN, and
    every (group, canonical-short) cell owns one padded shape (multiples of
    128) large enough for every member image at that scale. A batch samples
    one cell (shared RNG -> identical shape on every process) and resizes
    with any of the scales that snap up to the cell's canonical short, so
    augmentation diversity is preserved.
    """

    def __init__(self, records, scales, max_size: int, n_buckets: int,
                 grouping: bool = True, pad_multiple: int = 128):
        self.scales = sorted(scales)
        self.max_size = max_size
        top = self.scales[-1]

        hw = np.asarray([(r["height"], r["width"]) for r in records], np.float64)
        if grouping:
            keys = [pad_to_bucket(*resize_shortest_edge(h, w, top, max_size),
                                  pad_multiple) for h, w in hw]
        else:
            keys = [(0, 0)] * len(records)
        uniq = sorted(set(keys))
        groups = {k: np.nonzero([key == k for key in keys])[0] for k in uniq}

        # merge smallest groups into the nearest aspect until the shape budget
        # admits at least one canonical short per group
        def aspect(k):
            idx = groups[k]
            return float(np.mean(hw[idx, 1] / hw[idx, 0]))

        while len(groups) > max(1, n_buckets):
            k_small = min(groups, key=lambda k: len(groups[k]))
            others = [k for k in groups if k != k_small]
            k_near = min(others, key=lambda k: abs(np.log(aspect(k) /
                                                          aspect(k_small))))
            groups[k_near] = np.concatenate([groups[k_near], groups[k_small]])
            del groups[k_small]

        # split the remaining budget over groups, proportional to size
        sizes = {k: len(v) for k, v in groups.items()}
        budget = {k: 1 for k in groups}
        for _ in range(max(1, n_buckets) - len(groups)):
            # give the next slot to the group with the largest size/slots ratio
            k = max(groups, key=lambda k: sizes[k] / budget[k])
            budget[k] += 1

        self.groups = []
        for k, idx in groups.items():
            # chunk DEDUPED scales so no two chunks share a last element
            # (duplicate MIN_SIZE_TRAIN entries would otherwise collide on
            # the cell key and silently drop scales from the sampling pool);
            # cell membership below re-expands duplicates so a duplicated
            # scale keeps its doubled weight in the per-image draw
            uniq = sorted(set(self.scales))
            b = min(budget[k], len(uniq))
            chunks = [c for c in np.array_split(np.asarray(uniq), b)
                      if len(c)]
            shorts = [int(c[-1]) for c in chunks]
            # every cell (canonical short) carries its member scales so the
            # loader can draw a short side PER IMAGE within the cell
            # (reference ResizeShortestEdge samples per image,
            # dataset_mapper.py:26-28; the cell's canonical short upper-bounds
            # members so the padded shape stays fixed)
            cells = {}
            lo = -1
            for c in chunks:
                canon = int(c[-1])
                cells[canon] = [int(s) for s in self.scales if lo < s <= canon]
                lo = canon
            shapes = {}
            for s in shorts:
                sub = hw[idx]
                rs = np.asarray([resize_shortest_edge(h, w, s, max_size)
                                 for h, w in sub])
                shapes[s] = pad_to_bucket(int(rs[:, 0].max()),
                                          int(rs[:, 1].max()), pad_multiple)
            self.groups.append({
                "indices": idx, "shorts": shorts, "shapes": shapes,
                "cells": cells,
            })

        self.weights = np.asarray([len(g["indices"]) for g in self.groups],
                                  np.float64)
        self.weights /= self.weights.sum()

    @property
    def all_shapes(self):
        return sorted({s for g in self.groups for s in g["shapes"].values()})

    def sample_cell(self, rng) -> tuple[int, list, tuple[int, int]]:
        """(group index, cell scale list, padded shape) for one batch.

        The cell (canonical short) is drawn with probability proportional to
        its member-scale count, so a per-image uniform draw from the returned
        scale list keeps the per-image short-side marginal exactly uniform
        over INPUT.MIN_SIZE_TRAIN (the reference's ResizeShortestEdge choice
        distribution) while the padded shape stays fixed for the batch."""
        gi = int(rng.choice(len(self.groups), p=self.weights))
        g = self.groups[gi]
        s = int(self.scales[rng.integers(len(self.scales))])
        canon = next(c for c in g["shorts"] if c >= s)
        return gi, g["cells"][canon], g["shapes"][canon]


def group_mass_weights(buckets: "ShapeBuckets", factors: np.ndarray) -> np.ndarray:
    """Group-choice probabilities under per-group repeat-factor sampling.

    The group choice must be weighted by each group's repeat-factor MASS, not
    its record count: P(image i) = P(group) * f_i / sum_group f equals the
    reference's global f_i / sum_all f (build.py:129-174) exactly when
    P(group) = sum_group f / sum_all f.
    """
    mass = np.asarray([factors[g["indices"]].sum() for g in buckets.groups])
    return mass / mass.sum()


def build_detection_train_loader(cfg, records=None, dataset_id_to_src=None,
                                 process_index: int = 0, process_count: int = 1,
                                 seed: int = 0, skip_batches: int = 0):
    """Iterator of padded uint8 train batches (the local slice of the global
    batch); `close()` stops its threads.

    Shape bucketing (ShapeBuckets) bounds distinct batch shapes to
    TPU.TRAIN_SIZE_BUCKETS; the bucket choice per step comes from a shared
    RNG so every process emits the same global shape.
    DATALOADER.NUM_WORKERS > 1 maps the images of a batch in that many
    worker processes (spawned: the parent may hold CUDA and threads); > 0
    prepares two batches ahead in a background thread.

    skip_batches: draws (but does not read or map) that many batches first,
    so a run resumed at iteration k sees the batches an unbroken run sees
    from k on.
    """
    if records is None:
        records = get_detection_dataset_dicts(
            cfg.DATASETS.TRAIN, cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
        )
    buckets = ShapeBuckets(
        records, cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN,
        cfg.TPU.TRAIN_SIZE_BUCKETS, grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING,
    )
    if process_index == 0:
        for gi, g in enumerate(buckets.groups):
            print(f"[data] shape bucket group {gi}: {len(g['indices'])} imgs, "
                  f"shorts {g['shorts']} -> shapes {sorted(set(g['shapes'].values()))}")
            if len(g["shorts"]) == 1 and len(cfg.INPUT.MIN_SIZE_TRAIN) > 1:
                print(f"[data] WARNING: group {gi} has ONE canonical short — "
                      f"every batch pads to its max scale; raise "
                      f"TPU.TRAIN_SIZE_BUCKETS (now {cfg.TPU.TRAIN_SIZE_BUCKETS})")
    mapper = DatasetMapper3D(cfg, is_train=True,
                             rng=np.random.default_rng(seed + 1 + process_index))
    local_bs = cfg.SOLVER.IMS_PER_BATCH // process_count
    max_gt = cfg.TPU.MAX_GT_BOXES
    shared_rng = np.random.default_rng(seed)  # identical on every process

    # one sampler per aspect group; repeat/balance factors are computed on the
    # FULL record set (global category frequencies, reference build.py:129-174)
    # and then restricted to each group's members
    name = cfg.DATALOADER.SAMPLER_TRAIN
    balance = cfg.DATALOADER.BALANCE_DATASETS
    factors = np.ones(len(records), np.float64)
    weighted = False
    if name == "RepeatFactorTrainingSampler":
        factors *= repeat_factors_from_category_frequency(
            records, cfg.DATALOADER.REPEAT_THRESHOLD)
        weighted = True
    elif name != "TrainingSampler":
        raise ValueError(f"Unknown training sampler: {name}")
    if balance:
        assert dataset_id_to_src is not None, "Need dataset sources."
        factors *= dataset_balance_weights(records, dataset_id_to_src)
        weighted = True

    def group_sampler(g):
        if weighted:
            f = factors[g["indices"]]
            return iter(RepeatFactorTrainingSampler(f / f.min(), seed))
        return iter(TrainingSampler(len(g["indices"]), seed))

    samplers = [group_sampler(g) for g in buckets.groups]
    if weighted:
        buckets.weights = group_mass_weights(buckets, factors)

    n_workers = max(int(cfg.DATALOADER.NUM_WORKERS), 0)

    def local_indices(it):
        # round-robin shard: this process takes every process_count-th
        out = []
        for _ in range(local_bs):
            for _ in range(process_index):
                next(it)
            out.append(next(it))
            for _ in range(process_count - process_index - 1):
                next(it)
        return out

    # per-image short-side draws are an augmentation, not a shape decision,
    # so they use a process-local stream (shapes stay synced across
    # processes via shared_rng; reference ResizeShortestEdge samples per image)
    scale_rng = np.random.default_rng(seed + 7919 * (process_index + 1))

    def draw():
        gi, cell_scales, shape = buckets.sample_cell(shared_rng)
        g = buckets.groups[gi]
        idx = [g["indices"][i] for i in local_indices(samplers[gi])]
        shorts = scale_rng.choice(cell_scales, size=len(idx))
        flips = [mapper.draw_flip() for _ in idx]       # here, in image order
        return idx, shorts, flips, shape

    def gen():
        pool = None
        if n_workers > 1:
            from concurrent.futures import ProcessPoolExecutor
            pool = ProcessPoolExecutor(n_workers,
                                       mp_context=multiprocessing.get_context("spawn"))
        try:
            for _ in range(skip_batches):
                draw()
            while True:
                idx, shorts, flips, shape = draw()
                args = ([mapper] * len(idx), [records[i] for i in idx], shorts, flips)
                samples = list(pool.map(_map_one, *args) if pool else map(_map_one, *args))
                yield collate_batch(samples, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                    max_gt, pad_shape=shape, normalize=False)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)

    return _Prefetch(gen(), depth=2) if n_workers > 0 else gen()


class _Prefetch:
    """Runs a generator in a daemon thread, keeping `depth` items ready —
    overlaps host-side decode/augment with device compute. An exception in
    the generator is raised to the consumer; `close()` stops the thread and
    closes the generator."""

    _END = object()

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, args=(it,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _work(self, it):
        try:
            for item in it:
                if not self._put(item):
                    return
            self._put(self._END)
        except Exception as e:  # handed to the consumer, which raises it
            self._put(e)
        finally:
            it.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self, timeout: float = 30.0):
        self._stop.set()
        while True:                      # unblock a pending put
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)


def build_detection_test_loader(cfg, dataset_name, records=None, batch_size: int = 1,
                                process_index: int = 0, process_count: int = 1):
    """Finite generator of (batch, records) for evaluation, rank-sharded like
    detectron2 InferenceSampler (reference build.py:211-230; batch=1 default).

    With batch_size > 1 (TPU.EVAL_BATCH_SIZE) records are grouped by their
    padded network shape before batching, so every batch has one of a few
    shapes and images pad only to their own group's extent. Batches carry
    uint8 images, as the train loader's do.
    """
    if records is None:
        records = get_detection_dataset_dicts([dataset_name], filter_empty=False)
    mapper = DatasetMapper3D(cfg, is_train=False)
    shard = records[process_index::process_count]

    if batch_size > 1:
        groups = defaultdict(list)
        for r in shard:
            net_h, net_w = resize_shortest_edge(
                r["height"], r["width"], cfg.INPUT.MIN_SIZE_TEST,
                cfg.INPUT.MAX_SIZE_TEST)
            groups[pad_to_bucket(net_h, net_w)].append(r)
        chunks = [g[i:i + batch_size]
                  for g in groups.values()
                  for i in range(0, len(g), batch_size)]
    else:
        chunks = [shard[i:i + 1] for i in range(len(shard))]

    def gen():
        for chunk in chunks:
            samples = [mapper(r) for r in chunk]
            if batch_size > 1 and len(samples) < batch_size:
                # pad tail groups to the full batch shape; the duplicate rows
                # are never read back — the consumer iterates over the real
                # `chunk` records only
                samples += [samples[-1]] * (batch_size - len(samples))
            yield collate_batch(samples, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                normalize=False), chunk

    return gen(), len(shard)
