"""The port's data pipeline vs the JAX package on the CPU: the Omni3D index,
records, metadata and `is_ignore`; the image readers against cv2 and the
resize against PIL (bit-equal); the mapper, collate, shape buckets,
samplers, repeat and balance weights; the train loader's first batches
(bit-equal, also sharded over two processes, and with worker processes) and
the test loader. Datasets: tests/fixtures.make_synthetic_omni3d (JPEG) and
the port's writer (PPM and PNG), each read by both packages. Everything
compared here is exactly equal."""
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import make_synthetic_omni3d
from omni3d_tpu.config.defaults import get_default_cfg as jax_default_cfg
from omni3d_tpu.data import build as jbuild
from omni3d_tpu.data import datasets as jds
from omni3d_tpu.data import mapper as jmapper
from omni3d_tpu_torch.config.defaults import get_default_cfg as torch_default_cfg
from omni3d_tpu_torch.data import build as tbuild
from omni3d_tpu_torch.data import datasets as tds
from omni3d_tpu_torch.data import image as timage
from omni3d_tpu_torch.data import mapper as tmapper
from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset, write_omni3d_stats

PORT_CATS = ("car", "chair", "lamp", "sofa", "table", "toilet")
MEAN, STD = [103.530, 116.280, 123.675], [57.375, 57.120, 58.395]


def _cfgs(**over):
    """(JAX cfg, port cfg) reading the port-written dataset at small scales."""
    out = []
    for make in (jax_default_cfg, torch_default_cfg):
        cfg = make()
        cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs",
                                         "cubercnn_DLA34_FPN.yaml"))
        cfg.DATASETS.TRAIN = ("SUNRGBD_train", "KITTI_train")
        cfg.DATASETS.CATEGORY_NAMES = list(PORT_CATS)
        cfg.SOLVER.IMS_PER_BATCH = 4
        cfg.INPUT.MIN_SIZE_TRAIN = (32, 40, 48, 56, 64, 72, 80)
        cfg.INPUT.MAX_SIZE_TRAIN = 400
        cfg.INPUT.MIN_SIZE_TEST = 64
        cfg.DATALOADER.NUM_WORKERS = 0
        cfg.TPU.TRAIN_SIZE_BUCKETS = 5
        for k, v in over.items():
            node = cfg
            *path, leaf = k.split(".")
            for p in path:
                node = node[p]
            node[leaf] = v
        out.append(cfg)
    return out


def _register(lib, cfg, root, out_dir):
    fs = lib.get_filter_settings_from_cfg(cfg)
    for name in cfg.DATASETS.TRAIN:
        lib.simple_register(name, fs, datasets_root_path=os.path.join(root, "Omni3D"))
    lib.register_and_store_model_metadata(out_dir, fs, os.path.join(root, "Omni3D", "stats.json"))
    return fs


@pytest.fixture(scope="module")
def port_ds(tmp_path_factory):
    """A SUN RGB-D-like split (PPM) and a KITTI-like split (PNG, every row
    filter), registered in both packages."""
    root = str(tmp_path_factory.mktemp("port_omni3d"))
    write_omni3d_dataset(root, "SUNRGBD_train", 7, 53, 73, "ppm", seed=1, dataset_id=1,
                         objects=(1, 6), categories=PORT_CATS)
    write_omni3d_dataset(root, "KITTI_train", 5, 37, 124, "png", seed=2, dataset_id=2,
                         objects=(1, 6), categories=PORT_CATS)
    write_omni3d_stats(root)
    jcfg, tcfg = _cfgs()
    _register(jds, jcfg, root, os.path.join(root, "out_jax"))
    _register(tds, tcfg, root, os.path.join(root, "out_port"))
    return root


@pytest.fixture(scope="module")
def fixture_ds(tmp_path_factory):
    """tests/fixtures.make_synthetic_omni3d (JPEG images)."""
    root = str(tmp_path_factory.mktemp("fixture_omni3d"))
    json_path, _ = make_synthetic_omni3d(root, name="Fixture_train", n_images=5, seed=3)
    return root, json_path


def _records(lib, root):
    """The port dataset's train records, after (re)setting the model's
    category map (an earlier test may have set another)."""
    cfg = _cfgs()[lib is tds]
    _register(lib, cfg, root, os.path.join(root, "out_jax" if lib is jds else "out_port"))
    build = jbuild if lib is jds else tbuild
    return build.get_detection_dataset_dicts(list(cfg.DATASETS.TRAIN))


# ------------------------------ datasets ------------------------------

@pytest.mark.parametrize("which", ["port", "fixture"])
def test_index_records_and_metadata_match_jax(which, port_ds, fixture_ds):
    if which == "port":
        root = port_ds
        jsons = [os.path.join(root, "Omni3D", n + ".json") for n in ("SUNRGBD_train", "KITTI_train")]
        names = PORT_CATS
    else:
        root, json_path = fixture_ds
        jsons, names = [json_path], ("chair", "table", "car")
    jcfg, tcfg = _cfgs(**{"DATASETS.CATEGORY_NAMES": list(names)})
    results = []
    for lib, cfg in ((jds, jcfg), (tds, tcfg)):
        fs = lib.get_filter_settings_from_cfg(cfg)
        api = lib.Omni3D(jsons, dict(fs))
        unfiltered = lib.Omni3D(jsons)
        meta = lib.register_and_store_model_metadata(
            os.path.join(root, f"meta_{which}_{lib.__name__}"), fs,
            os.path.join(root, "Omni3D", "stats.json"))
        records = [lib.load_omni3d_json(j, root, f"{which}_split", fs) for j in jsons]
        results.append((api, unfiltered, meta, records, dict(lib.metadata(f"{which}_split"))))
    (ja, ju, jm, jr, jmeta), (ta, tu, tm, tr, tmeta) = results
    for a, b in ((ja, ta), (ju, tu)):
        assert a.dataset == b.dataset
        assert (a.anns, a.imgs, a.cats) == (b.anns, b.imgs, b.cats)
        assert dict(a.imgToAnns) == dict(b.imgToAnns) and dict(a.catToImgs) == dict(b.catToImgs)
        assert a.getImgIds(catIds=a.getCatIds()[:1]) == b.getImgIds(catIds=b.getCatIds()[:1])
    assert len(ta.anns) > 5
    assert jm == tm and jr == tr and jmeta == tmeta
    assert sum(len(r["annotations"]) for rs in tr for r in rs) > 5


IGNORE_CASES = {
    "kept": {},
    "behind_camera": {"behind_camera": True},
    "invalid3D": {"valid3D": False},
    "zero_dim": {"dimensions": [1, 0, 1]},
    "too_deep": {"center_cam": [0, 0, 2e8]},
    "no_lidar": {"lidar_pts": 0},
    "no_seg": {"segmentation_pts": 0},
    "depth_error": {"depth_error": 0.9},
    "short_box": {"bbox2D_trunc": [0, 0, 50, 3]},
    "tall_box": {"bbox2D_trunc": [0, 0, 50, 190]},
    "truncated": {"truncation": 0.8},
    "invisible": {"visibility": 0.1},
    "ignore_name": {"category_name": "dontcare"},
    "no_trunc_box": {"bbox2D_trunc": [-1, -1, -1, -1], "bbox2D_proj": [0, 0, 50, 2]},
    "modal": {"bbox2D_tight": [0, 0, 50, 1]},
}


@pytest.mark.parametrize("case", sorted(IGNORE_CASES))
@pytest.mark.parametrize("modal", [False, True])
def test_is_ignore_matches_jax(case, modal):
    base = {"behind_camera": False, "valid3D": True, "dimensions": [1, 1, 1],
            "center_cam": [0, 0, 5], "lidar_pts": 10, "segmentation_pts": 10,
            "depth_error": 0.1, "truncation": 0.0, "visibility": 1.0,
            "category_name": "car", "bbox2D_proj": [0, 0, 50, 50],
            "bbox2D_trunc": [0, 0, 50, 40], "bbox2D_tight": [-1, -1, -1, -1]}
    jcfg, tcfg = _cfgs(**{"DATASETS.MODAL_2D_BOXES": modal})
    anno = {**base, **IGNORE_CASES[case]}
    want = jds.is_ignore(dict(anno), jds.get_filter_settings_from_cfg(jcfg), 120)
    got = tds.is_ignore(dict(anno), tds.get_filter_settings_from_cfg(tcfg), 120)
    assert got == want
    assert want == (case != "kept" and not (case == "modal" and not modal))


# ------------------------------ images ------------------------------

RESIZES = [(37, 124, 64, 214), (375, 124, 123, 41), (53, 73, 80, 110), (60, 60, 17, 17),
           (200, 31, 77, 12), (31, 200, 12, 77), (41, 67, 41, 130), (64, 48, 96, 48)]


@pytest.mark.parametrize("h,w,oh,ow", RESIZES)
def test_resize_is_pil_bilinear_bit_for_bit(h, w, oh, ow):
    """Down- and up-scales, odd sizes, one axis at a time, against PIL."""
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), np.uint8)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    got = timage.resize_bilinear_uint8(img, ow, oh)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jmapper.resize_image_bilinear(img, ow, oh), got)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
def test_png_rows_of_every_filter_read_as_cv2(tmp_path, filters):
    img = np.random.default_rng(len(filters)).integers(0, 256, (23, 41, 3), np.uint8)
    img[5:12] = img[5:12] // 32 * 32      # runs, so predictions hit every branch
    path = str(tmp_path / "x.png")
    timage.write_png(path, img, filters=filters)
    got = timage.read_image_bgr(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "P", "RGB"])
def test_png_colour_types_read_as_cv2(tmp_path, mode):
    """Grey, grey+alpha, RGBA, palette and RGB PNGs written by PIL (its
    adaptive filters), against cv2.imread(IMREAD_COLOR)."""
    rgb = np.random.default_rng(5).integers(0, 256, (19, 33, 3), np.uint8)
    im = Image.fromarray(rgb)
    im = im.quantize(64) if mode == "P" else im.convert(mode)
    path = str(tmp_path / f"{mode}.png")
    im.save(path)
    np.testing.assert_array_equal(timage.read_image_bgr(path), cv2.imread(path, cv2.IMREAD_COLOR))


def test_ppm_and_jpeg_read_as_cv2(tmp_path, fixture_ds, monkeypatch):
    img = np.random.default_rng(6).integers(0, 256, (21, 34, 3), np.uint8)
    path = str(tmp_path / "x.ppm")
    timage.write_ppm(path, img)
    np.testing.assert_array_equal(timage.read_image_bgr(path), cv2.imread(path))
    np.testing.assert_array_equal(timage.read_image_bgr(path), img)
    with open(path, "wb") as f:                       # a header comment
        f.write(b"P6\n# c\n34 21\n255\n" + np.ascontiguousarray(img[..., ::-1]).tobytes())
    np.testing.assert_array_equal(timage.read_image_bgr(path), img)
    root, _ = fixture_ds
    jpg = os.path.join(root, "images", "Fixture_train", "0000.jpg")
    np.testing.assert_array_equal(timage.read_image_bgr(jpg), cv2.imread(jpg))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)   # the port's own decoder
    np.testing.assert_array_equal(timage.read_image_bgr(jpg), cv2.imread(jpg))


# ------------------------------ mapper, collate ------------------------------

@pytest.mark.parametrize("is_train,flip", [(True, False), (True, True), (False, False)])
def test_mapper_matches_jax(port_ds, is_train, flip):
    """Per sample on the same decoded image; the JAX mapper's flip draw is
    forced by a generator whose first uniform is on the wanted side."""
    jcfg, tcfg = _cfgs()
    records = _records(tds, port_ds)
    seed = next(s for s in range(100)
                if (np.random.default_rng(s).random() < 0.5) == flip)
    for rec in records:
        img = timage.read_image_bgr(rec["file_name"])
        np.testing.assert_array_equal(img, cv2.imread(rec["file_name"]))
        jm = jmapper.DatasetMapper3D(jcfg, is_train, np.random.default_rng(seed))
        tm = tmapper.DatasetMapper3D(tcfg, is_train, np.random.default_rng(seed))
        want = jm(rec, image=img, short=56)
        got = tm(rec, image=img, short=56, flip=flip if is_train else None)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_collate_and_device_normalisation_match_jax(port_ds):
    jcfg, tcfg = _cfgs()
    records = _records(tds, port_ds)[:4]
    samples = [tmapper.DatasetMapper3D(tcfg, True, np.random.default_rng(i))(r, short=48)
               for i, r in enumerate(records)]
    want = jmapper.collate_batch(samples, MEAN, STD, max_gt=8)
    got = tmapper.collate_batch(samples, MEAN, STD, max_gt=8)
    u8 = tmapper.collate_batch(samples, MEAN, STD, max_gt=8, normalize=False)
    dev = tmapper.batch_to_device(u8, "cpu", MEAN, STD)
    assert u8["images"].dtype == np.uint8
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert torch.equal(dev[k], torch.from_numpy(want[k])), k


# ------------------------------ buckets, samplers, weights ------------------------------

def test_buckets_samplers_and_weights_match_jax(port_ds):
    records = _records(tds, port_ds)
    assert records == _records(jds, port_ds)
    for n in (1, 3, 5, 8):
        jb = jbuild.ShapeBuckets(records, (32, 48, 48, 64, 80), 400, n)
        tb = tbuild.ShapeBuckets(records, (32, 48, 48, 64, 80), 400, n)
        assert str(jb.groups) == str(tb.groups) and jb.all_shapes == tb.all_shapes
        np.testing.assert_array_equal(jb.weights, tb.weights)
        jr, tr = np.random.default_rng(n), np.random.default_rng(n)
        assert [jb.sample_cell(jr) for _ in range(20)] == [tb.sample_cell(tr) for _ in range(20)]
        assert all(s[0] % 128 == 0 and s[1] % 128 == 0 for s in tb.all_shapes)
        assert len(tb.all_shapes) <= n
        f = np.linspace(1, 3, len(records))
        np.testing.assert_array_equal(jbuild.group_mass_weights(jb, f),
                                      tbuild.group_mass_weights(tb, f))
    for t in (0.1, 0.5):
        np.testing.assert_array_equal(
            jbuild.repeat_factors_from_category_frequency(records, t),
            tbuild.repeat_factors_from_category_frequency(records, t))
    src = {1: "SUNRGBD", 2: "KITTI"}
    w = tbuild.dataset_balance_weights(records, src)
    np.testing.assert_array_equal(jbuild.dataset_balance_weights(records, src), w)
    assert len(set(w.tolist())) == 2
    f = tbuild.repeat_factors_from_category_frequency(records, 0.5)
    for a, b in ((jbuild.TrainingSampler(9, 4), tbuild.TrainingSampler(9, 4)),
                 (jbuild.RepeatFactorTrainingSampler(f, 4),
                  tbuild.RepeatFactorTrainingSampler(f, 4))):
        ia, ib = iter(a), iter(b)
        assert [next(ia) for _ in range(40)] == [next(ib) for _ in range(40)]


# ------------------------------ loaders ------------------------------

def _first_batches(lib, cfg, records, n=4, **kw):
    loader = lib.build_detection_train_loader(cfg, records=records, **kw)
    out = [next(loader) for _ in range(n)]
    if hasattr(loader, "close"):
        loader.close()
    return out


@pytest.mark.parametrize("process_count", [1, 2])
@pytest.mark.parametrize("sampler", ["TrainingSampler", "RepeatFactorTrainingSampler"])
def test_train_loader_batches_bit_equal_to_jax(port_ds, process_count, sampler):
    """The first 4 batches at NUM_WORKERS 0: bit-equal after the port's
    uint8 batch is normalised (on the CPU device), on each of two processes."""
    jcfg, tcfg = _cfgs(**{"DATALOADER.SAMPLER_TRAIN": sampler})
    records = _records(tds, port_ds)
    shapes = set()
    for rank in range(process_count):
        kw = dict(seed=5, process_index=rank, process_count=process_count)
        want = _first_batches(jbuild, jcfg, records, **kw)
        got = _first_batches(tbuild, tcfg, records, **kw)
        for w, g in zip(want, got):
            assert g["images"].dtype == np.uint8
            dev = tmapper.batch_to_device(g, "cpu", MEAN, STD)
            assert set(dev) == set(w)
            for k in w:
                assert torch.equal(dev[k], torch.from_numpy(w[k])), k
            shapes.add(g["images"].shape)
    assert len(shapes) > 1


def test_train_loader_independent_of_workers_and_resumable(port_ds):
    """4 worker processes equal 0 workers (the flips are drawn before the
    pool maps); skip_batches=2 continues where an unbroken loader's batch 2
    starts."""
    _, tcfg = _cfgs()
    _, tcfg4 = _cfgs(**{"DATALOADER.NUM_WORKERS": 4})
    records = _records(tds, port_ds)
    ref = _first_batches(tbuild, tcfg, records, n=6, seed=9)
    for other in (_first_batches(tbuild, tcfg4, records, n=6, seed=9),
                  ref[:2] + _first_batches(tbuild, tcfg, records, n=4, seed=9, skip_batches=2)):
        for a, b in zip(ref, other):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prefetch_close_stops_thread_and_raises_errors():
    p = tbuild._Prefetch((i for i in range(100)), depth=2)
    assert next(p) == 0
    p.close(timeout=10)
    assert not p._thread.is_alive()

    def bad():
        yield 1
        raise ValueError("boom")
    p = tbuild._Prefetch(bad(), depth=2)
    assert next(p) == 1
    with pytest.raises(ValueError, match="boom"):
        next(p)
    p.close(timeout=10)
    assert not p._thread.is_alive()


@pytest.mark.parametrize("batch_size, process_index, process_count", [
    pytest.param(1, 0, 1, id="1"), pytest.param(3, 0, 1, id="3"),
    pytest.param(1, 1, 2, id="1-rank1of2"), pytest.param(3, 0, 2, id="3-rank0of2"),
    pytest.param(1, 1, 3, id="1-rank1of3"), pytest.param(3, 2, 3, id="3-rank2of3")])
def test_test_loader_matches_jax(port_ds, batch_size, process_index, process_count):
    """Each rank's shard (every process_count-th record) equals the JAX
    loader's for the same rank."""
    jcfg, tcfg = _cfgs()
    records = _records(tds, port_ds)
    shard = dict(process_index=process_index, process_count=process_count)
    jl, jn = jbuild.build_detection_test_loader(jcfg, "x", records=records,
                                                batch_size=batch_size, **shard)
    tl, tn = tbuild.build_detection_test_loader(tcfg, "x", records=records,
                                                batch_size=batch_size, **shard)
    assert jn == tn == len(records[process_index::process_count]) > 0
    n = 0
    for (wb, wr), (gb, gr) in zip(jl, tl):
        assert wr == gr
        dev = tmapper.batch_to_device(gb, "cpu", MEAN, STD)
        for k in wb:
            assert torch.equal(dev[k], torch.from_numpy(wb[k])), k
        n += 1
    assert n == len(list(jbuild.build_detection_test_loader(
        jcfg, "x", records=records, batch_size=batch_size, **shard)[0]))
