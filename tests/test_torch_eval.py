"""The port's AP evaluation (`omni3d_tpu_torch.evaluation`) against the JAX
package's on the CPU: `Omni3DEval` 2D and 3D with proximity evaluation on
and off, the cross-dataset `summarize_all`, the native matcher, the error
statistics and `instances_to_predictions`; and the GT echo (predictions =
the GTs) at AP 100 with the helper's files.

Data: the evaluation bench's synthetic dataset (`tools.bench_eval.synth`,
the JAX bench's draw for draw) at 30 images: 360 GTs, 1050 detections over
20 categories, depths 2-45 m. AP values agree within 1e-6. They can only
differ where an IoU sits on a threshold and rounds across it in one
package: the test asserts that every JAX IoU3D is at least MARGIN from
every AP3D threshold and that the port's IoU3Ds are within MARGIN of
them (the port mirrors XLA's arithmetic, so they are equal here)."""
import json
import types

import numpy as np
import pytest
import torch

from omni3d_tpu.evaluation import error_stats as jerr
from omni3d_tpu.evaluation import native as jnative
from omni3d_tpu.evaluation import omni3d_eval as jeval
from omni3d_tpu_torch.data.builtin import get_omni3d_categories
from omni3d_tpu_torch.evaluation import error_stats as terr
from omni3d_tpu_torch.evaluation import native as tnative
from omni3d_tpu_torch.evaluation import omni3d_eval as teval
from omni3d_tpu_torch.tools.bench_eval import synth

N_IMAGES = 30
AP_TOL = 1e-6
MARGIN = 1e-5


@pytest.fixture(scope="module")
def data():
    return synth(N_IMAGES)


def _run(mod, gts, dts, mode, prox, **kw):
    ev = mod.Omni3DEval([dict(g) for g in gts], [dict(d) for d in dts], mode=mode,
                        eval_prox=prox, **kw)
    ev.evaluate()
    ev.accumulate()
    return ev, ev.summarize()


def _assert_close(got: dict, want: dict, tol=AP_TOL):
    assert set(got) == set(want)
    for k, w in want.items():
        if np.isnan(w):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - w) <= tol, (k, got[k], w)


@pytest.mark.parametrize("mode", ["2D", "3D"])
@pytest.mark.parametrize("prox", [False, True])
def test_omni3d_eval_matches_jax(data, mode, prox):
    gts, dts = data
    ev, stats = _run(teval, gts, dts, mode, prox, device="cpu")
    jev, jstats = _run(jeval, gts, dts, mode, prox)
    _assert_close(stats, jstats)
    _assert_close(ev.per_category_ap(), jev.per_category_ap())
    assert 0 < stats[f"AP{mode}"] < 100
    if mode == "3D":
        thrs = ev.params.iouThrs
        for key, (want, _) in jev.ious.items():
            if np.size(want):
                want = np.asarray(want)
                assert np.abs(want[..., None] - thrs).min() >= MARGIN, key
                np.testing.assert_allclose(ev.ious[key][0], want, rtol=0, atol=MARGIN)


def test_native_matcher_matches_plain_and_jax():
    rng = np.random.default_rng(0)
    thrs = np.linspace(0.05, 0.5, 10)
    for D, G in ((1, 1), (7, 5), (35, 12), (3, 0), (0, 4)):
        ious = rng.uniform(0, 0.8, (D, G)).astype(np.float32)
        ious[rng.random((D, G)) < 0.3] = 0
        gt_ignore = np.sort(rng.random(G) < 0.25).astype(np.uint8)     # ignore-last
        dt_ids = np.arange(1, D + 1, dtype=np.int64)
        gt_ids = np.arange(101, 101 + G, dtype=np.int64)
        for prox in (None, rng.random((D, G)) < 0.7):
            args = (ious, thrs, gt_ignore, prox, dt_ids, gt_ids)
            got = tnative.greedy_match(*args)
            for want in (tnative.greedy_match_plain(*args), jnative.greedy_match(*args)):
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
    assert tnative.build().parent.name == "_build"


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "matcher.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build()
    assert not list((tmp_path / "build").glob("*.so*"))


def _fake_api(gts, categories):
    """An Omni3D index stand-in: the annotations and categories
    `Omni3DEvaluationHelper` reads."""
    anns = [{"id": g["id"], "image_id": g["image_id"], "category_id": g["category_id"],
             "bbox": g["bbox"], "area": g["area"], "center_cam": [0.0, 0.0, g["depth"]],
             "ignore": bool(g["ignore2D"]), "bbox3D_cam": g["bbox3D"]} for g in gts]
    cats = [{"id": i, "name": n} for i, n in enumerate(categories)]
    return types.SimpleNamespace(dataset={"annotations": anns, "categories": cats})


def _two_splits(data):
    """A SUN RGB-D-named split (proximity evaluation on) and a KITTI-named
    one from the synth's first and last 15 images; the 20 category names
    cover Omni3D_Out's 11."""
    gts, dts = data
    names = sorted(get_omni3d_categories("omni3d_out")) + sorted(
        get_omni3d_categories("omni3d_in") - get_omni3d_categories("omni3d_out"))[:9]
    half = N_IMAGES // 2
    return names, {
        "SUNRGBD_test": ([g for g in gts if g["image_id"] < half],
                         [d for d in dts if d["image_id"] < half]),
        "KITTI_test": ([g for g in gts if g["image_id"] >= half],
                       [d for d in dts if d["image_id"] >= half]),
    }


def test_summarize_all_matches_jax(data):
    names, splits = _two_splits(data)
    out = {}
    for label, mod, kw in (("port", teval, {"device": "cpu"}), ("jax", jeval, {})):
        helper = mod.Omni3DEvaluationHelper(list(splits), {}, None, **kw)
        for name, (gts, dts) in splits.items():
            helper.add_predictions(name, [dict(d) for d in dts], _fake_api(gts, names))
            helper.evaluate(name)
        out[label] = helper.summarize_all(), helper.results
    (summary, results), (jsummary, jresults) = out["port"], out["jax"]
    _assert_close(summary, jsummary)
    for name in splits:
        _assert_close(results[name], jresults[name])
    assert np.isfinite(summary["Omni3D_Out/AP3D"]) and np.isnan(summary["Omni3D/AP3D"])


def test_gt_echo_gives_ap_100_and_writes_its_files(data, tmp_path):
    names, splits = _two_splits(data)
    helper = teval.Omni3DEvaluationHelper(list(splits), {}, str(tmp_path), device="cpu")
    for name, (gts, _) in splits.items():
        echo = [dict(g, score=1.0) for g in gts]
        helper.add_predictions(name, echo, _fake_api(gts, names))
        path = helper.save_predictions(name)
        assert helper.load_predictions(path) == echo
        res = helper.evaluate(name)
        assert res["AP2D"] == res["AP3D"] == 100.0, res
    summary = helper.summarize_all()
    assert summary["Concat/AP2D"] == summary["Concat/AP3D"] == 100.0
    with open(helper.save_results()) as f:
        assert json.load(f)["KITTI_test"]["AP3D"] == 100.0


def test_iou3d_guards_match_jax():
    """A degenerate (flat, or non-planar) detection gets IoU 0 in both."""
    rng = np.random.default_rng(3)
    gts, _ = synth(2)
    g = np.asarray([x["bbox3D"] for x in gts], np.float32)
    d = g[:6] + rng.normal(0, 0.1, (6, 1, 3)).astype(np.float32)
    d[0] = g[0]                              # identity
    d[1, :, 1] = d[1, 0, 1]                  # zero height
    d[2, 0] += 0.3                           # a bent face
    # the 3D evaluation's route: every (detection, GT) pair, then the guards
    pairs = teval.paired_iou3d(np.repeat(d, len(g), 0), np.tile(g, (len(d), 1, 1)), "cpu")
    got = teval._guard(pairs.reshape(len(d), len(g)), d)
    np.testing.assert_allclose(got, jeval.box3d_overlap(d, g), rtol=0, atol=MARGIN)
    assert (got[1] == 0).all() and (got[2] == 0).all() and got[0, 0] > 0.999
    assert teval.paired_iou3d(d[:0], g[:0], "cpu").shape == (0,)


def test_compute_error_stats_matches_jax(data):
    """Rotations 0.2-2 rad apart (arccos is well conditioned there): the
    statistics agree within 1e-5 relative (float32 rotation angles)."""
    gts, dts = data
    rng = np.random.default_rng(4)

    def rot(n):
        axis = rng.standard_normal((n, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        ang = rng.uniform(0.2, 2.0, (n, 1))
        K = np.zeros((n, 3, 3))
        K[:, [2, 0, 1], [1, 2, 0]] = axis
        K[:, [1, 2, 0], [2, 0, 1]] = -axis
        return (np.eye(3) + np.sin(ang)[..., None] * K
                + (1 - np.cos(ang))[..., None] * K @ K)

    gts = [dict(g, center_cam=[0.1, -0.2, g["depth"]], dimensions=[1.0, 1.5, 2.0],
                pose=R.tolist(), ignore=bool(g["ignore2D"]))
           for g, R in zip(gts, rot(len(gts)))]
    preds = [dict(d, center_cam=[0.0, 0.1, d["depth"] + 0.3], dimensions=[1.2, 1.4, 2.5],
                  pose=R.tolist(), center_2D=[d["bbox"][0] + 5, d["bbox"][1] + 7])
             for d, R in zip(dts, rot(len(dts)))]
    Ks = {i: [[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]] for i in range(N_IMAGES)}
    for kw in ({"Ks": Ks}, {}):
        got = terr.compute_error_stats(preds, gts, score_thresh=0.3, **kw)
        want = jerr.compute_error_stats(preds, gts, score_thresh=0.3, **kw)
        assert got["n_matched"] == want["n_matched"] > 20
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=k)
        assert terr.error_log_string("KITTI_test", got, 7) == jerr.error_log_string(
            "KITTI_test", want, 7)


def test_instances_to_predictions_matches_jax():
    rng = np.random.default_rng(5)
    K = 6
    det = {"boxes_orig": rng.uniform(0, 300, (K, 4)).astype(np.float32),
           "classes": rng.integers(0, 3, K).astype(np.float32),
           "scores": rng.random(K).astype(np.float32),
           "valid": (rng.random(K) < 0.6).astype(np.float32),
           "center_cam": rng.normal(size=(K, 3)).astype(np.float32),
           "dims": rng.random((K, 3)).astype(np.float32),
           "pose": rng.normal(size=(K, 3, 3)).astype(np.float32),
           "corners": rng.normal(size=(K, 8, 3)).astype(np.float32),
           "center_2D": rng.normal(size=(K, 2)).astype(np.float32)}
    contig = {0: 11, 1: 12, 2: 17}
    got = teval.instances_to_predictions(det, 4, contig, start_id=9)
    assert got == jeval.instances_to_predictions(det, 4, contig, start_id=9)
    assert [p["id"] for p in got] == list(range(9, 9 + int(det["valid"].sum())))


def test_cuda_device_required_by_default(data):
    """IoU3D targets the card unless the caller asks for the CPU; without
    one it raises rather than moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    gts, dts = data
    ev = teval.Omni3DEval([dict(g) for g in gts], [dict(d) for d in dts], mode="3D")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ev.evaluate()
