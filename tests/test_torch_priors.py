"""The port's per-category priors vs the JAX package on the CPU:
`compute_priors` (exactly equal: the same float64 arithmetic) at
CLUSTER_BINS 1 and > 1, with a rare category (fewer points than the k-means
needs) and an empty one, on the port-written and the tests/fixtures
datasets; `priors_to_params`; `load_priors_` into the model's buffers; the
host geometry helpers."""
import os

import numpy as np
import pytest
import torch

from fixtures import make_synthetic_omni3d
from omni3d_tpu.config.defaults import get_default_cfg as jax_default_cfg
from omni3d_tpu.data import datasets as jds
from omni3d_tpu.utils import geometry as jgeom
from omni3d_tpu.utils import priors as jpriors
from omni3d_tpu_torch.config.defaults import get_default_cfg as torch_default_cfg
from omni3d_tpu_torch.data import datasets as tds
from omni3d_tpu_torch.models.rcnn3d import build_model
from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset
from omni3d_tpu_torch.utils import geometry as tgeom
from omni3d_tpu_torch.utils import priors as tpriors

CATS = ("car", "chair", "lamp", "sofa", "table")


@pytest.fixture(scope="module")
def jsons(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("priors"))
    many = write_omni3d_dataset(root, "SUNRGBD_train", 12, 60, 80, "ppm", seed=4,
                                dataset_id=1, objects=(8, 20), categories=CATS)
    rare = write_omni3d_dataset(root, "KITTI_train", 1, 37, 124, "ppm", seed=5,
                                dataset_id=2, objects=(2, 2), categories=("bed",))
    fixture, _ = make_synthetic_omni3d(root, name="Fixture_train", n_images=6, seed=1)
    return {"port": [many, rare], "fixture": [fixture]}


def _cfg(make, bins, virtual_depth=True):
    cfg = make()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "cubercnn_DLA34_FPN.yaml"))
    cfg.MODEL.ROI_CUBE_HEAD.CLUSTER_BINS = bins
    cfg.MODEL.ROI_CUBE_HEAD.VIRTUAL_DEPTH = virtual_depth
    cfg.DATASETS.CATEGORY_NAMES = []
    return cfg


@pytest.mark.parametrize("which", ["port", "fixture"])
@pytest.mark.parametrize("bins,virtual_depth", [(1, True), (3, True), (2, False)])
def test_compute_priors_matches_jax(jsons, which, bins, virtual_depth):
    names = (list(CATS) + ["bed", "bin"] if which == "port"
             else ["chair", "table", "car", "bin"])        # "bin": no annotation
    out = []
    for make, lib, pr in ((jax_default_cfg, jds, jpriors), (torch_default_cfg, tds, tpriors)):
        cfg = _cfg(make, bins, virtual_depth)
        api = lib.Omni3D(jsons[which], lib.get_filter_settings_from_cfg(cfg))
        priors = pr.compute_priors(cfg, api, names)
        out.append((priors, pr.priors_to_params(priors, len(names), bins)))
    (want, want_p), (got, got_p) = out
    assert got == want
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_array_equal(got_p[k], want_p[k], err_msg=k)
    assert got["priors_dims_per_cat"][-1] == [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]]
    if bins > 1:
        assert got_p["priors_z_scales"].shape == (len(names), bins)
        assert got_p["priors_z_stats"].shape == (len(names), bins, 2)


def test_load_priors_writes_the_buffers(jsons):
    cfg = _cfg(torch_default_cfg, 3)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = len(CATS)
    cfg.MODEL.FPN.OUT_CHANNELS = 16
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = cfg.MODEL.ROI_CUBE_HEAD.FC_DIM = 16
    api = tds.Omni3D(jsons["port"], tds.get_filter_settings_from_cfg(cfg))
    params = tpriors.priors_to_params(tpriors.compute_priors(cfg, api, list(CATS)),
                                      len(CATS), 3)
    model = build_model(cfg, device="cpu", train=True)
    tpriors.load_priors_(model, params)
    for k, v in params.items():
        assert torch.equal(getattr(model.roi_heads, k), torch.from_numpy(v)), k
        assert torch.equal(model.state_dict()[f"roi_heads.{k}"], torch.from_numpy(v)), k
    with pytest.raises(ValueError, match="priors_dims_per_cat"):
        tpriors.load_priors_(model, {"priors_dims_per_cat": np.ones((2, 2, 3), np.float32)})


@pytest.mark.parametrize("h,w,lo,hi", [(530, 730, 512, 4096), (375, 1242, 512, 4096),
                                       (120, 160, 128, 200), (1000, 3000, 800, 1333)])
def test_host_geometry_matches_jax(h, w, lo, hi):
    assert tgeom.approx_eval_resolution(h, w, lo, hi) == jgeom.approx_eval_resolution(h, w, lo, hi)
    test_h = tgeom.approx_eval_resolution(h, w, lo, hi)[0]
    assert tgeom.virtual_scale(721.5, h, 512.0, test_h) == jgeom.virtual_scale(721.5, h, 512.0,
                                                                                test_h)
