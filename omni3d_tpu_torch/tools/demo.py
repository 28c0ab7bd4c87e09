"""Folder-of-images Cube R-CNN demo with the PyTorch port (the JAX package's
demo/demo.py, same flags).

    python -m omni3d_tpu_torch.tools.demo --config-file configs/cubercnn_DLA34_FPN.yaml \
        --input-folder imgs/ [--focal-length f] [--principal-point px py] \
        [--threshold t] [--display] [--weights ckpt] [--output-dir dir] \
        [--device cuda|cpu] [KEY VALUE ...]

Every .jpg / .jpeg / .png in the folder is read with the port's own
decoders (`data.image.read_image_bgr`: JPEG bit-equal to cv2.imread),
resized to the test scale (`resize_bilinear_uint8`), padded to the shape
bucket and run through `models.rcnn3d.inference_step` (one CUDA graph per
padded shape on the card) with the config's settings, in its
TPU.COMPUTE_DTYPE. Without --focal-length the focal length is 2 x the
image height and the principal point the image centre
(reference demo.py:54-79). Detections scoring at least --threshold are drawn
as the JAX demo draws them: labelled 2D boxes, shaded cuboids and wireframes
over the image (`<name>_boxes.png`), the shaded top-down novel view
(`<name>_novel.png`, 512 x 512) and the bird's-eye view (`<name>_bev.png`,
400 x 400), under --output-dir (default OUTPUT_DIR/demo). The files are PNG
where the JAX demo writes JPEG (the port has no JPEG encoder; PNG is
lossless), the novel and BEV views are written also when nothing is
detected (blank), and labels are drawn in the port's own font.

Weights: --weights or MODEL.WEIGHTS (a checkpoint of the port, a reference
.pth/.pkl or a `cubercnn://` path, as `tools.train_net` loads them);
without either, seeded random weights (SEED). Category names come from
OUTPUT_DIR/category_meta.json where it exists. It runs on the CUDA card
unless `--device cpu` is given, and raises without a card. `--display`
opens no window (the port has no GUI toolkit) and says so.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from ..config import get_default_cfg, validate_cfg
from ..data.image import read_image_bgr, resize_bilinear_uint8, write_png
from ..data.mapper import pad_to_bucket, resize_shortest_edge
from ..engine.loop import build_eval_model
from ..models.rcnn3d import inference_kwargs, inference_step, preprocess
from ..vis.vis import draw_2d_box, draw_bev, get_color, render_scene_view
from .train_net import load_weights

EXTENSIONS = (".jpg", ".jpeg", ".png")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="omni3d_tpu_torch demo")
    p.add_argument("--config-file", required=True)
    p.add_argument("--input-folder", required=True)
    p.add_argument("--focal-length", type=float, default=0)
    p.add_argument("--principal-point", type=float, nargs=2, default=None)
    p.add_argument("--threshold", type=float, default=0.25)
    p.add_argument("--display", action="store_true",
                   help="show each result in a window (the port opens none: says so)")
    p.add_argument("--weights", default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def intrinsics(h: int, w: int, focal_length: float = 0, principal_point=None) -> np.ndarray:
    """(3, 3) float32 K of an h x w image: f = 2h unless given, principal
    point at the centre unless given (reference demo.py:54-79)."""
    f = focal_length or 4 * h / 2
    px, py = principal_point or (w / 2, h / 2)
    return np.array([[f, 0, px], [0, f, py], [0, 0, 1]], np.float32)


def network_input(cfg, image_bgr: np.ndarray):
    """The padded uint8 network canvas of an image and its (net_h, net_w)."""
    h, w = image_bgr.shape[:2]
    net_h, net_w = resize_shortest_edge(h, w, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    Hp, Wp = pad_to_bucket(net_h, net_w)
    canvas = np.zeros((Hp, Wp, 3), np.uint8)
    canvas[:net_h, :net_w] = resize_bilinear_uint8(image_bgr, net_w, net_h)
    return canvas, net_h, net_w


def infer(model, cfg, image_bgr: np.ndarray, K: np.ndarray) -> dict:
    """`inference_step` on one image (on the model's device: one CUDA graph
    per padded shape on the card) -> its padded detections as float32 numpy
    arrays."""
    device = next(model.parameters()).device
    canvas, net_h, net_w = network_input(cfg, image_bgr)
    images = preprocess(torch.from_numpy(canvas[None]).to(device), cfg.MODEL.PIXEL_MEAN,
                        cfg.MODEL.PIXEL_STD)
    ratio = image_bgr.shape[0] / net_h
    out = inference_step(model, images, torch.from_numpy(K[None]).to(device),
                         torch.tensor([ratio], dtype=torch.float32, device=device),
                         hw=torch.tensor([[net_h, net_w]], dtype=torch.float32, device=device),
                         **inference_kwargs(cfg))
    return {k: v[0].float().cpu().numpy() for k, v in out.items()}


def draw(image_bgr: np.ndarray, det: dict, K: np.ndarray, threshold: float, cats=None):
    """The demo's three images of one image's detections scoring at least
    `threshold` (reference demo.py:119-139): ({"boxes", "novel", "bev"},
    BGR uint8; the number of detections drawn)."""
    keep = np.where((det["valid"] > 0) & (det["scores"] >= threshold))[0]
    vis_img = image_bgr.copy()
    centers, dims, poses, colors = [], [], [], []
    for rank, i in enumerate(keep):
        color = get_color(rank)
        cls = int(det["classes"][i])
        label = f"{cats[cls] if cats else str(cls)} {det['scores'][i]:.2f}"
        draw_2d_box(vis_img, det["boxes_orig"][i], color, 2, label)
        centers.append(det["center_cam"][i])
        dims.append(det["dims"][i])
        poses.append(det["pose"][i])
        colors.append(color)
    views = render_scene_view(vis_img, K, centers, dims, poses, colors=colors,
                              mode="front_and_novel")
    return {"boxes": views["front"], "novel": views["novel"],
            "bev": draw_bev(centers, dims, poses, colors=colors)}, len(keep)


def run_image(model, cfg, image_bgr: np.ndarray, K: np.ndarray, threshold: float, cats=None):
    """One image through the demo: (detections, {"boxes", "novel", "bev"})
    with the detections as `infer` returns them."""
    det = infer(model, cfg, image_bgr, K)
    return det, draw(image_bgr, det, K, threshold, cats)[0]


def setup(args):
    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    validate_cfg(cfg)
    cfg.freeze()
    return cfg


def main(argv=None) -> list:
    """Run the demo; returns one record per image: name, detections drawn,
    the output paths and ms by stage (decode, inference, drawing, write)."""
    args = parse_args(argv)
    cfg = setup(args)
    path = args.weights or cfg.MODEL.WEIGHTS
    model = build_eval_model(cfg, device=args.device, seed=None if path else max(cfg.SEED, 0))
    if path:
        load_weights(model, path)
    else:
        print("[demo] no --weights or MODEL.WEIGHTS: seeded random weights")
    out_dir = args.output_dir or os.path.join(cfg.OUTPUT_DIR, "demo")
    os.makedirs(out_dir, exist_ok=True)
    paths = sorted(p for p in glob.glob(os.path.join(args.input_folder, "*"))
                   if p.lower().endswith(EXTENSIONS))
    if not paths:
        raise FileNotFoundError(f"no .jpg / .jpeg / .png images in {args.input_folder}")
    meta_path = os.path.join(cfg.OUTPUT_DIR, "category_meta.json")
    cats = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            cats = json.load(f)["thing_classes"]
    sync = torch.cuda.synchronize if next(model.parameters()).is_cuda else (lambda: None)

    records = []
    for path in paths:
        t0 = time.perf_counter()
        img = read_image_bgr(path)
        t1 = time.perf_counter()
        h, w = img.shape[:2]
        K = intrinsics(h, w, args.focal_length, args.principal_point)
        det = infer(model, cfg, img, K)
        sync()
        t2 = time.perf_counter()
        views, n = draw(img, det, K, args.threshold, cats)
        t3 = time.perf_counter()
        name = os.path.splitext(os.path.basename(path))[0]
        files = {}
        for kind in ("boxes", "novel", "bev"):
            files[kind] = os.path.join(out_dir, f"{name}_{kind}.png")
            write_png(files[kind], views[kind])
        t4 = time.perf_counter()
        if args.display:
            print("[demo] --display: no window is available (the port has no GUI toolkit); "
                  f"the images are in {out_dir}")
        ms = dict(decode=(t1 - t0) * 1e3, inference=(t2 - t1) * 1e3, drawing=(t3 - t2) * 1e3,
                  write=(t4 - t3) * 1e3)
        records.append(dict(name=name, detections=n, files=files, ms=ms, height=h, width=w))
        print(f"[demo] {name}: {n} detections -> {out_dir}  ("
              + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items()) + ")")
    return records


if __name__ == "__main__":
    main()
