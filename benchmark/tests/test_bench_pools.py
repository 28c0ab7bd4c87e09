"""The seeded inputs and weights: the same seed gives the same frames,
batches and weights; another seed gives others."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.tests import tiny
from benchmark.traffic import frames, train
from benchmark.weights import init_state

BIG = 2 ** 31 + 11   # seeds run past 32 signed bits


def test_frame_pool_is_seeded():
    _, spec, config = tiny.cell("dla34.offline_b8")
    cfg = config["cfg"]
    a, b = frames.frame_pool(spec, cfg, BIG, "cpu"), frames.frame_pool(spec, cfg, BIG, "cpu")
    c = frames.frame_pool(spec, cfg, BIG + 1, "cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["images"], c["images"])
    (h, w), _ = frames.frame_shape(spec, cfg)
    assert a["images"][:, h:].sum() == 0 and a["images"][:, :, w:].sum() == 0
    assert len({a["images"][i].tobytes() for i in range(len(a["images"]))}) == len(a["images"])


def test_train_pool_is_seeded():
    _, spec, config = tiny.cell("dla34.train_b32")
    a = train.batch_pool(spec, config["cfg"], BIG, "cpu")
    b = train.batch_pool(spec, config["cfg"], BIG, "cpu")
    c = train.batch_pool(spec, config["cfg"], 5, "cpu")
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert not torch.equal(a[0]["images"], c[0]["images"])
    assert not torch.equal(a[0]["images"], a[1]["images"])   # the rows all differ
    assert bool(a[0]["gt_valid"].any())


@pytest.mark.parametrize("name,train_cell,want", [
    ("dla34.offline_b8", False, ((512, 705), (512, 768))),
    ("resnet34.live_b1", False, ((512, 683), (512, 768))),
    ("dla34.train_b32", True, ((512, 705), (512, 768)))])
def test_sizes_of_the_cells(name, train_cell, want):
    bench = tiny.load("BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    spec = tiny.load(f"benchmark/workloads/{name}.json")
    assert frames.frame_shape(spec, tiny.load(conf["file"])["cfg"], train=train_cell) == want


def test_weights_are_seeded_and_order_free():
    shapes = {"b.weight": (4, 3, 3, 3), "a.weight": (8, 4), "a.bias": (8,),
              "bn.running_var": (4,), "roi_heads.cube_head.bbox_3D_pose.bias": (12,)}
    s1, s2 = init_state(shapes, BIG, "cpu"), init_state(dict(reversed(shapes.items())), BIG, "cpu")
    for k in shapes:
        assert torch.equal(s1[k], s2[k])
    assert not torch.equal(s1["a.weight"], init_state(shapes, 3, "cpu")["a.weight"])
    assert torch.equal(s1["roi_heads.cube_head.bbox_3D_pose.bias"],
                       torch.tensor([1.0, 0, 0, 0, 1, 0] * 2))
    assert torch.equal(s1["bn.running_var"], torch.ones(4))
