"""The demo entry point and the training / evaluation visualisation of the
port on the CPU, at the narrow test widths (tests/torch_port_helpers.py):

  * `tools.demo.run_image`: its detections equal `inference` called
    directly on the same preprocessed input (bit for bit), and the JAX
    package's `draw_2d_box` / `render_scene_view` / `draw_bev` on those
    detections give the port's images to the vis tolerance (labels off:
    >= 98% of pixels equal);
  * `tools.demo` in a subprocess on two JPEG fixtures: the three PNGs per
    image exist and read back at their sizes;
  * `EventStorage.put_image`, and two `do_train` iterations with
    VIS_PERIOD 1 writing the GT-vs-prediction panels;
  * `do_test`'s sample dumps: as many as the JAX `do_test` writes on the
    same split with images on disk, under the same stems (both with the
    dump's stride and score threshold lowered alike so a seeded
    random-weight model draws), the images to the vis tolerance."""
import os
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from omni3d_tpu.config.cfg import StaticCfg
from omni3d_tpu.data import datasets as jds
from omni3d_tpu.engine import loop as jloop
from omni3d_tpu.evaluation import error_stats as jerr
from omni3d_tpu.vis import vis as JV
from omni3d_tpu_torch.data import datasets as tds
from omni3d_tpu_torch.data.image import read_image_bgr
from omni3d_tpu_torch.engine import loop as tloop
from omni3d_tpu_torch.evaluation import error_stats as terr
from omni3d_tpu_torch.models.rcnn3d import build_model, inference, inference_kwargs, preprocess
from omni3d_tpu_torch.tools import demo, train_net
from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset, write_omni3d_stats
from omni3d_tpu_torch.utils import events as tevents
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax
from omni3d_tpu_torch.vis import vis as TV
from test_torch_eval_loop import EVAL
from test_torch_loop import CATS, _argv, write_loop_dataset
from test_torch_train import TINY
from torch_port_helpers import pooled_shape, random_variables, small_cfgs

ROOT = pathlib.Path(__file__).resolve().parents[1]
JPEG = ROOT / "tests" / "data" / "jpeg"


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard_two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tevents, "_make_tb_writer", lambda output_dir: None)
        yield
    torch.set_num_threads(threads)


def _labels_off(monkeypatch):
    monkeypatch.setattr(JV.cv2, "putText", lambda *a, **k: None)
    monkeypatch.setattr(TV.draw, "put_text", lambda *a, **k: None)


def _frac_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    return (a == b).all(-1).mean()


def test_run_image_matches_inference_and_jax_drawing(monkeypatch):
    _labels_off(monkeypatch)
    _, cfg = small_cfgs(**TINY, **EVAL)
    model = build_model(cfg, device="cpu", seed=4)
    img = read_image_bgr(str(JPEG / "q95_420_640x480.jpg"))
    K = demo.intrinsics(*img.shape[:2])
    assert K[0, 0] == 960 and (K[0, 2], K[1, 2]) == (320, 240)
    det, views = demo.run_image(model, cfg, img, K, threshold=0.0)

    canvas, net_h, net_w = demo.network_input(cfg, img)
    assert (net_h, net_w) == (64, 85) and canvas.shape == (128, 128, 3)
    want = inference(model, preprocess(torch.from_numpy(canvas[None]), cfg.MODEL.PIXEL_MEAN,
                                       cfg.MODEL.PIXEL_STD),
                     torch.from_numpy(K[None]), torch.tensor([480 / 64]),
                     hw=torch.tensor([[64.0, 85.0]]), **inference_kwargs(cfg))
    for k, v in want.items():
        np.testing.assert_array_equal(det[k], v[0].float().numpy(), err_msg=k)
    keep = np.where((det["valid"] > 0) & (det["scores"] >= 0.0))[0]
    assert len(keep) > 0

    vis_img = img.copy()
    colors = [JV.get_color(r) for r in range(len(keep))]
    for c, i in zip(colors, keep):
        JV.draw_2d_box(vis_img, det["boxes_orig"][i], c, 2)
    sel = [det[k][keep] for k in ("center_cam", "dims", "pose")]
    jviews = JV.render_scene_view(vis_img, K, *sel, colors=colors)
    assert views["boxes"].shape == img.shape and views["novel"].shape == (512, 512, 3)
    assert _frac_equal(views["boxes"], jviews["front"]) >= 0.98
    assert _frac_equal(views["novel"], jviews["novel"]) >= 0.98
    assert _frac_equal(views["bev"], JV.draw_bev(*sel, colors=colors)) >= 0.98


def test_demo_cli_writes_pngs(tmp_path):
    folder = tmp_path / "imgs"
    folder.mkdir()
    for name in ("q75_420_37x53", "q75_420_1242x375"):
        (folder / f"{name}.jpg").write_bytes((JPEG / f"{name}.jpg").read_bytes())
    opts = {"MODEL.ROI_HEADS.NUM_CLASSES": 5, "MODEL.FPN.OUT_CHANNELS": 32,
            "MODEL.ROI_BOX_HEAD.FC_DIM": 64, "MODEL.ROI_CUBE_HEAD.FC_DIM": 64,
            "TPU.COMPUTE_DTYPE": "float32", "SEED": 2, "OUTPUT_DIR": str(tmp_path / "o"),
            **EVAL}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    out = tmp_path / "demo"
    run = subprocess.run(
        [sys.executable, "-m", "omni3d_tpu_torch.tools.demo", "--config-file",
         str(ROOT / "configs" / "cubercnn_DLA34_FPN.yaml"), "--input-folder", str(folder),
         "--threshold", "0.0", "--device", "cpu", "--display", "--output-dir", str(out)]
        + [str(x) for k, v in opts.items() for x in (k, v)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "no window is available" in run.stdout
    for name, hw in (("q75_420_37x53", (37, 53)), ("q75_420_1242x375", (375, 1242))):
        assert read_image_bgr(str(out / f"{name}_boxes.png")).shape == hw + (3,)
        assert read_image_bgr(str(out / f"{name}_novel.png")).shape == (512, 512, 3)
        assert read_image_bgr(str(out / f"{name}_bev.png")).shape == (400, 400, 3)


def test_demo_refuses_to_leave_the_card_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        demo.main(["--config-file", str(ROOT / "configs" / "cubercnn_DLA34_FPN.yaml"),
                   "--input-folder", str(JPEG)])


def test_put_image_and_training_visualisation(tmp_path):
    storage = tevents.EventStorage(str(tmp_path / "s"), start_iter=7)
    rgb = np.random.default_rng(0).integers(0, 256, (20, 30, 3), np.uint8)
    path = storage.put_image("panel", rgb)
    storage.close()
    assert path.endswith(os.path.join("vis", "iter_0000007_panel.png"))
    np.testing.assert_array_equal(read_image_bgr(path)[..., ::-1], rgb)
    assert tevents.EventStorage(None).put_image("x", rgb) is None

    root = str(tmp_path / "data")
    write_loop_dataset(root)
    out = tmp_path / "run"
    train_net.main(_argv(root, out, 2, VIS_PERIOD="1"))
    # storage.step() runs before the panels: iteration 1 writes iter_0000002
    assert sorted(os.listdir(out / "vis")) == ["iter_0000002_gt_vs_pred_2d.png",
                                               "iter_0000002_gt_vs_pred_3d.png"]
    two_d = read_image_bgr(str(out / "vis" / "iter_0000002_gt_vs_pred_2d.png"))
    three_d = read_image_bgr(str(out / "vis" / "iter_0000002_gt_vs_pred_3d.png"))
    assert two_d.shape == three_d.shape and two_d.shape[1] % 2 == 0   # GT | prediction


def test_do_test_sample_dumps_match_jax(tmp_path, monkeypatch):
    _labels_off(monkeypatch)
    data_root = str(tmp_path / "data")
    write_omni3d_stats(data_root)
    write_omni3d_dataset(data_root, "SUNRGBD_test", 4, 64, 96, "ppm", seed=8, dataset_id=1,
                         objects=(2, 5), categories=CATS)
    over = {**TINY, **EVAL, "DATASETS.TEST": ("SUNRGBD_test",),
            "DATASETS.CATEGORY_NAMES": list(CATS), "MODEL.ROI_HEADS.SCORE_THRESH_TEST": 0.05}
    jcfg, tcfg = small_cfgs(**over)
    root = os.path.join(data_root, "Omni3D")
    for lib, cfg in ((jds, jcfg), (tds, tcfg)):
        fs = lib.get_filter_settings_from_cfg(cfg)
        lib.simple_register("SUNRGBD_test", fs, datasets_root_path=root)
        lib.register_and_store_model_metadata(str(tmp_path / lib.__name__), fs,
                                              os.path.join(root, "stats.json"))
    jm = jloop.build_eval_model(StaticCfg(jcfg))
    variables = random_variables(jm, (64, 96), seed=6)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"],
                                               pooled_shape(tcfg)), strict=True)

    def lowered(real):
        def vis(*args, **kwargs):
            return real(*args, **dict(kwargs, every=2, score_thresh=0.0))
        return vis
    monkeypatch.setattr(jerr, "visualize_from_predictions",
                        lowered(jerr.visualize_from_predictions))
    monkeypatch.setattr(tloop, "visualize_from_predictions",
                        lowered(terr.visualize_from_predictions))
    # the JAX dumps are JPEG through cv2.imwrite: written losslessly here so
    # the pixels compare
    real_imwrite = cv2.imwrite
    monkeypatch.setattr(cv2, "imwrite", lambda path, img, *a: real_imwrite(
        os.path.splitext(path)[0] + ".png", img))
    image_root = tds.metadata("SUNRGBD_test")["image_root"]
    jloop.do_test(jcfg, jm, variables, output_dir=str(tmp_path / "j"), datasets_root=image_root)
    tloop.do_test(tcfg, model, output_dir=str(tmp_path / "t"))
    sub = os.path.join("inference", "iter_final", "SUNRGBD_test", "vis")
    jfiles = sorted(os.listdir(tmp_path / "j" / sub))
    assert jfiles == ["000000.png", "000002.png"]
    assert sorted(os.listdir(tmp_path / "t" / sub)) == jfiles
    for f in jfiles:
        want = cv2.imread(str(tmp_path / "j" / sub / f))
        assert _frac_equal(read_image_bgr(str(tmp_path / "t" / sub / f)), want) >= 0.98, f
