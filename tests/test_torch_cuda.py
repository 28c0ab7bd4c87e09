"""The CUDA ROIAlign kernels (forward and backward) vs their plain PyTorch
versions, the training entry point, a one-rank NCCL step, the
evaluation's IoU3D, the demo, the cuboid rasterizer, the inference bench,
the stage chain, the NMS kernels, `inference_step`'s CUDA graphs and the
stages that `utils.trace` times inside them and inside the training step,
and the train-mode BatchNorm kernels, on the card.

These tests need a CUDA device and skip without one. They import no JAX, so
they run on a machine without it; there, skip tests/conftest.py (it imports
JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from omni3d_tpu_torch.ops.roi_align import (multilevel_roi_align_plain,
                                             multilevel_roi_align_plain_bwd, route_levels)
from omni3d_tpu_torch.ops import roi_align_cuda as rac
from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align

STRIDES = (4, 8, 16, 32, 64)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(device, dtype, n=300, img=512, C=256):
    gen = torch.Generator().manual_seed(0)
    feats = [torch.randn(2, img // s, img // s, C, generator=gen).to(device, dtype)
             for s in STRIDES]
    size = torch.exp(torch.empty(2, n, 2).uniform_(1.0, 6.5, generator=gen))
    xy = torch.rand(2, n, 2, generator=gen) * (img - size) - 4.0
    edge = torch.tensor([[0, 200, img, 208], [-500, -400, 900, 1000], [30, 30, 30, 50]],
                        dtype=torch.float32).expand(2, -1, -1)
    boxes = torch.cat([edge, torch.cat([xy, xy + size], -1)], 1).to(device)
    return feats, boxes


@pytest.mark.cuda
@pytest.mark.parametrize("routing", ["canonical", "fit"])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain(device, dtype, sampling_ratio, routing):
    """f32 atol 1e-5 (same terms summed in another order); bf16 within one
    output ULP, compared in f32 after each side's single rounding."""
    feats, boxes = _case(device, dtype)
    before = multilevel_roi_align.launches
    got = multilevel_roi_align(feats, boxes, STRIDES, 7, sampling_ratio, routing=routing)
    torch.cuda.synchronize()
    assert multilevel_roi_align.launches == before + 1
    levels = route_levels(boxes, STRIDES, 2, routing)
    want = multilevel_roi_align_plain(feats, boxes, levels, STRIDES, 7, sampling_ratio)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_fwd_close(got, want)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    feats, boxes = _case(device, torch.float32, n=4)
    with pytest.raises(ValueError):   # channels-first layout: not contiguous NHWC
        multilevel_roi_align([f.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                              for f in feats], boxes, STRIDES)
    with pytest.raises(ValueError):
        multilevel_roi_align([f.half() for f in feats], boxes, STRIDES)
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, boxes.double(), STRIDES)
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, boxes.cpu(), STRIDES)
    with pytest.raises(ValueError):   # more bins, or samples per bin, than the kernels hold
        multilevel_roi_align(feats, boxes, STRIDES, out_size=9)
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, boxes, STRIDES, sampling_ratio=10)


def bf16_ulp(x):
    """One bfloat16 ULP at the magnitude of each element of x (float32)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("routing", ["canonical", "fit"])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_kernel_matches_plain(device, dtype, sampling_ratio, routing):
    """Through loss.backward(): one backward launch; f32 within
    1e-5 * max|plain| + 1e-6 (the kernel adds each box's banded product
    Ay^T G Ax, the plain version each tap: the same terms in another order);
    bf16 within one output ULP of the plain result after the same single
    cast, plus that f32 slack."""
    feats, boxes = _case(device, dtype)
    feats = [f.requires_grad_(True) for f in feats]
    g = torch.randn((2, boxes.shape[1], 7, 7, feats[0].shape[-1]),
                    generator=torch.Generator().manual_seed(1)).to(device, dtype)
    before = multilevel_roi_align.bwd_launches
    out = multilevel_roi_align(feats, boxes, STRIDES, 7, sampling_ratio, routing=routing)
    out.backward(g)
    torch.cuda.synchronize()
    assert multilevel_roi_align.bwd_launches == before + 1
    levels = route_levels(boxes, STRIDES, 2, routing)
    want = multilevel_roi_align_plain_bwd(g, boxes, levels, [f.shape[1:3] for f in feats],
                                          STRIDES, 7, sampling_ratio, dtype)
    _assert_bwd_close([f.grad for f in feats], want, feats)


def _assert_bwd_close(got, want, feats):
    scale = max(float(w.float().abs().max()) for w in want)
    for k, w, f in zip(got, want, feats):
        assert k.dtype == f.dtype and k.shape == f.shape
        err = (k.float() - w.float()).abs()
        tol = 1e-5 * scale + 1e-6
        if w.dtype == torch.bfloat16:
            tol = tol + bf16_ulp(w.float())
        assert bool((err <= tol).all()), float(err.max())


def _assert_fwd_close(got, want):
    if want.dtype == torch.float32:
        atol = 1e-5
    else:
        atol = 2.0 ** (float(torch.log2(want.float().abs().max()).floor()) - 7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def _edge_case(device, dtype, C=256, img=512):
    """chip_smoke.make_boxes' edge cases (outside the image, zero width and
    height, touching the border, 512 x 8 px = 128 cells wide at p2, 6 x 512
    px, the whole image at p5/p6), a box of negative width and a NaN box."""
    gen = torch.Generator().manual_seed(3)
    feats = [torch.randn(2, img // s, img // s, C, generator=gen).to(device, dtype)
             for s in STRIDES]
    nan = float("nan")
    edge = torch.tensor([
        [-40, -30, -4, -6], [100, 100, 100, 140], [200, 220, 230, 220],
        [img - 9, img - 7, img, img], [0, 0, img, img], [0, 200, img, 208],
        [300, 0, 306, img], [10, 10, 60, 60], [10, 10, 120, 120], [10, 10, 250, 250],
        [-100, -100, 500, 500], [-500, -400, 900, 1000], [90, 40, 30, 100],
        [nan, nan, nan, nan]], dtype=torch.float32)
    return feats, edge.expand(2, -1, -1).contiguous().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("routing", ["canonical", "fit"])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("dtype,C", [(torch.float32, 256), (torch.bfloat16, 256),
                                     (torch.bfloat16, 72), (torch.float32, 36)],
                         ids=["f32", "bf16", "bf16-C72", "f32-C36"])
def test_kernels_on_edge_boxes_and_ragged_channels(device, dtype, C, sampling_ratio, routing):
    """Both kernels against their plain versions on the edge-case boxes
    (bands wider than a window, reversed and clamped axes, an empty band)
    and at channel counts that are not a multiple of the kernels' channel
    tiles (32 forward, 64 backward); the NaN box pools to zeros."""
    feats, boxes = _edge_case(device, dtype, C)
    levels = route_levels(boxes, STRIDES, 2, routing)
    shapes = [f.shape[1:3] for f in feats]
    got = multilevel_roi_align(feats, boxes, STRIDES, 7, sampling_ratio, routing=routing)
    want = multilevel_roi_align_plain(feats, boxes, levels, STRIDES, 7, sampling_ratio)
    torch.cuda.synchronize()
    _assert_fwd_close(got, want)
    assert bool((got[:, -1] == 0).all())
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(4)).to(device, dtype)
    kern = rac._backward_kernel(g, boxes, levels, shapes, STRIDES, 7, sampling_ratio, dtype)
    plain = multilevel_roi_align_plain_bwd(g, boxes, levels, shapes, STRIDES, 7,
                                           sampling_ratio, dtype)
    torch.cuda.synchronize()
    _assert_bwd_close(kern, plain, feats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_kernel_is_bit_reproducible(device, dtype):
    """The backward kernel writes each gradient cell once, adding its boxes in
    index order: two calls on the same inputs give bit-equal gradients."""
    feats, boxes = _case(device, dtype)
    levels = route_levels(boxes, STRIDES, 2, "canonical")
    shapes = [f.shape[1:3] for f in feats]
    g = torch.randn((2, boxes.shape[1], 7, 7, feats[0].shape[-1]),
                    generator=torch.Generator().manual_seed(5)).to(device, dtype)
    first = rac._backward_kernel(g, boxes, levels, shapes, STRIDES, 7, 0, dtype)
    second = rac._backward_kernel(g, boxes, levels, shapes, STRIDES, 7, 0, dtype)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_bwd_kernel_is_the_transpose_of_the_fwd_kernel(device):
    """<g, fwd(f)> = <bwd(g), f> in float32 at rtol 1e-5, both kernels."""
    feats, boxes = _case(device, torch.float32)
    feats = [f.requires_grad_(True) for f in feats]
    g = torch.randn((2, boxes.shape[1], 7, 7, feats[0].shape[-1]),
                    generator=torch.Generator().manual_seed(2)).to(device)
    out = multilevel_roi_align(feats, boxes, STRIDES, 7, 0)
    out.backward(g)
    lhs = float((g.double() * out.detach().double()).sum())
    rhs = float(sum((f.grad.double() * f.detach().double()).sum() for f in feats))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.cuda
def test_training_entry_point_steps_on_the_card(device, tmp_path):
    """Two iterations of tools.train_net on the card from a synthetic
    Omni3D-format dataset (narrow widths): one forward and one backward
    kernel launch per step, finite losses, a checkpoint; the batch
    normalised on the card is bit-equal to the numpy collate's."""
    import json
    import os

    import numpy as np

    from omni3d_tpu_torch.data.build import get_detection_dataset_dicts
    from omni3d_tpu_torch.data.mapper import DatasetMapper3D, batch_to_device, collate_batch
    from omni3d_tpu_torch.tools import train_net
    from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset, write_omni3d_stats

    cats = ("car", "chair", "lamp", "sofa", "table")
    root = str(tmp_path)
    write_omni3d_dataset(root, "SUNRGBD_train", 4, 53, 73, "ppm", seed=1, dataset_id=1,
                         objects=(1, 5), categories=cats)
    write_omni3d_dataset(root, "KITTI_train", 4, 37, 124, "png", seed=2, dataset_id=2,
                         objects=(1, 5), categories=cats)
    write_omni3d_stats(root)
    opts = {"OUTPUT_DIR": os.path.join(root, "out"), "DATASETS.TRAIN": "('SUNRGBD_train', 'KITTI_train')",
            "DATASETS.TEST": "()", "DATASETS.CATEGORY_NAMES": str(list(cats)),
            "MODEL.ROI_HEADS.NUM_CLASSES": "5", "MODEL.FPN.OUT_CHANNELS": "64",
            "MODEL.ROI_BOX_HEAD.FC_DIM": "128", "MODEL.ROI_CUBE_HEAD.FC_DIM": "128",
            "INPUT.MIN_SIZE_TRAIN": "(64, 96, 128)", "INPUT.MAX_SIZE_TRAIN": "600",
            "SOLVER.IMS_PER_BATCH": "4", "SOLVER.CHECKPOINT_PERIOD": "2",
            "TPU.COMPUTE_DTYPE": "bfloat16", "DATALOADER.NUM_WORKERS": "2", "SEED": "0"}
    before = (multilevel_roi_align.launches, multilevel_roi_align.bwd_launches)
    run = train_net.main(["--config-file", os.path.join(os.path.dirname(__file__), "..", "configs",
                                                        "cubercnn_DLA34_FPN.yaml"),
                          "--datasets-root", os.path.join(root, "Omni3D"), "--max-steps", "2",
                          "--device", "cuda"] + [x for kv in opts.items() for x in kv])
    torch.cuda.synchronize()
    assert (multilevel_roi_align.launches - before[0],
            multilevel_roi_align.bwd_launches - before[1]) == (2, 2)
    assert next(run.model.parameters()).is_cuda and run.iterations == [0, 1]
    with open(os.path.join(root, "out", "metrics.json")) as f:
        for line in f:
            assert all(np.isfinite(v) for v in json.loads(line).values())
    assert os.path.exists(os.path.join(root, "out", "model_final.ckpt"))

    cfg = run.model.cfg
    records = get_detection_dataset_dicts(["SUNRGBD_train", "KITTI_train"])
    mapper = DatasetMapper3D(cfg, is_train=True)
    samples = [mapper(r, short=96, flip=bool(i % 2)) for i, r in enumerate(records[2:6])]
    want = collate_batch(samples, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    got = batch_to_device(collate_batch(samples, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                        normalize=False), device,
                          cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    assert got["images"].is_cuda
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), torch.from_numpy(v)), k


@pytest.mark.cuda
def test_iou3d_on_the_card_equals_the_cpu(device):
    """IoU3D is a sequence of single float32 operations, explicit left-to-right
    sums and tensor-by-tensor divisions: the card gives the CPU's values
    (asserted within 1e-5, the chip_smoke tolerance) on the evaluation
    bench's (detection, GT) pairs and on rotated 50 m boxes."""
    import numpy as np

    from omni3d_tpu_torch.evaluation.omni3d_eval import paired_iou3d
    from omni3d_tpu_torch.ops import iou3d
    from omni3d_tpu_torch.tools.bench_eval import group_pairs, synth
    from omni3d_tpu_torch.utils.geometry import axis_angle_to_matrix, cuboid_verts

    dv, gv = group_pairs(*synth(20))
    np.testing.assert_allclose(paired_iou3d(dv, gv, device), paired_iou3d(dv, gv, "cpu"),
                               rtol=0, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    boxes = torch.cat([torch.rand(32, 2, generator=gen) * 4,
                       49 + torch.rand(32, 1, generator=gen) * 2,
                       0.3 + torch.rand(32, 3, generator=gen) * 3], 1)
    v = cuboid_verts(boxes, axis_angle_to_matrix(torch.randn(32, 3, generator=gen)))
    w = v + 0.2 * torch.randn(32, 1, 3, generator=gen)
    for a, b in zip(iou3d.box3d_overlap(v.to(device), w.to(device)), iou3d.box3d_overlap(v, w)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_gt_echo_evaluation_on_the_card(device):
    """Predictions equal to the GTs give AP2D = AP3D = 100 with IoU3D on the
    card, with and without proximity evaluation."""
    from omni3d_tpu_torch.evaluation.omni3d_eval import Omni3DEval
    from omni3d_tpu_torch.tools.bench_eval import synth

    gts, _ = synth(10)
    for mode in ("2D", "3D"):
        for prox in (False, True):
            ev = Omni3DEval([dict(g) for g in gts], [dict(g, score=1.0) for g in gts],
                            mode=mode, eval_prox=prox, device=device)
            ev.evaluate()
            ev.accumulate()
            assert ev.summarize()[f"AP{mode}"] == 100.0, (mode, prox)


@pytest.mark.cuda
def test_one_rank_over_nccl_steps_as_without_a_process_group(device):
    """A process group of one over NCCL (`parallel.init_distributed` with a
    HOST:PORT address): `make_train_step` runs the losses under DDP. One f32
    step from the same seeded weights, batch and noise gives the losses (rel
    1e-4) and the gradients (1e-3 of each tensor's largest) of the step
    without a process group, with one forward and one backward kernel
    launch."""
    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.parallel import dist as dist_lib
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer

    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.ROI_HEADS.NUM_CLASSES", "5", "MODEL.FPN.OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.FC_DIM", "128", "MODEL.ROI_CUBE_HEAD.FC_DIM", "128",
                         "TPU.COMPUTE_DTYPE", "float32"])

    def one_step():
        model, _, step, batch = synthetic_trainer(cfg, torch.float32, 2, device, img=256)
        before = (multilevel_roi_align.launches, multilevel_roi_align.bwd_launches)
        logs = step(batch, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        assert (multilevel_roi_align.launches - before[0],
                multilevel_roi_align.bwd_launches - before[1]) == (1, 1)
        return ({k: float(v) for k, v in logs.items()},
                {n: p.grad.clone() for n, p in model.named_parameters()})

    plain = one_step()
    dist_lib.init_distributed(f"127.0.0.1:{dist_lib.free_port()}", 1, 0, device)
    try:
        assert dist_lib.process_group_active() and dist_lib.process_count() == 1
        ddp = one_step()
    finally:
        torch.distributed.destroy_process_group()
    assert ddp[0]["finite"] == plain[0]["finite"] == 1.0
    for k, v in plain[0].items():
        assert abs(ddp[0][k] - v) <= 1e-4 * abs(v) + 1e-7, k
    for n, g in plain[1].items():
        assert float((ddp[1][n] - g).abs().max()) <= 1e-3 * float(g.abs().max()) + 1e-6, n


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [
    ("MODEL.BACKBONE.NAME", "build_resnet_from_vision_fpn_backbone", "MODEL.RESNETS.DEPTH", "34"),
    ("MODEL.BACKBONE.NAME", "build_densenet_fpn_backbone"),
    ("MODEL.BACKBONE.NAME", "build_mnasnet_fpn_backbone"),
    ("MODEL.BACKBONE.NAME", "build_shufflenet_fpn_backbone"),
    ("MODEL.DLA.TYPE", "dla102x")], ids=["resnet34", "densenet", "mnasnet", "shufflenet",
                                         "dla102x"])
def test_backbone_family_runs_on_the_card(device, opts):
    """Each backbone family (narrow heads, 256 px, seeded weights): the f32
    features on the card (TF32 off) within 1e-4 of the CPU's largest value
    per map; bf16 inference with two forward launches and finite outputs;
    one bf16 training step with one forward and one backward launch and a
    finite loss, each of its train-mode BN calls through the kernels and
    none through the plain formula."""
    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.models import layers as tl
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.ops import batch_norm_cuda as bnc
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer, train_batch

    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.ROI_HEADS.NUM_CLASSES", "5", "MODEL.FPN.OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.FC_DIM", "128", "MODEL.ROI_CUBE_HEAD.FC_DIM", "128",
                         "TPU.COMPUTE_DTYPE", "float32", *opts])
    images = train_batch(cfg, 2, "cpu", img=256)["images"]
    feats = {}
    for dev in ("cpu", device):
        model = rcnn3d.build_model(cfg, device=dev, seed=0)
        with torch.no_grad():
            feats[str(dev)] = {k: v.float().cpu() for k, v in model.features(images.to(dev))[0]
                               .items()}
    for k, want in feats["cpu"].items():
        err = float((feats[str(device)][k] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (k, err)

    model = rcnn3d.build_model(cfg, device=device, dtype=torch.bfloat16, seed=0)
    K = torch.tensor([[256.0, 0, 128], [0, 256.0, 128], [0, 0, 1]], device=device).expand(2, 3, 3)
    before = multilevel_roi_align.launches
    out = rcnn3d.inference(model, images.to(device), K.contiguous(), torch.ones(2, device=device),
                           **rcnn3d.inference_kwargs(cfg))
    torch.cuda.synchronize()
    assert multilevel_roi_align.launches - before == 2
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values()
               if v.is_floating_point())

    model, _, step, batch = synthetic_trainer(cfg, torch.bfloat16, 2, device, img=256)
    before = (multilevel_roi_align.launches, multilevel_roi_align.bwd_launches)
    calls, bn_launches = dict(tl.bn_calls), bnc.forward.launches
    logs = step(batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert (multilevel_roi_align.launches - before[0],
            multilevel_roi_align.bwd_launches - before[1]) == (1, 1)
    assert logs["finite"] == 1.0 and bool(torch.isfinite(torch.as_tensor(logs["total_loss"])))
    fused = tl.bn_calls["fused"] - calls["fused"]
    assert fused > 0 and fused == bnc.forward.launches - bn_launches
    assert tl.bn_calls["plain"] == calls["plain"]


@pytest.mark.cuda
def test_demo_on_the_card(device, tmp_path):
    """`tools.demo` on the card (narrow heads, seeded weights, two JPEG
    fixtures, threshold 0): four forward launches through the wrapper per
    graph captured (one per padded shape) and none per replay, the three PNGs
    at their sizes, and each image's detections equal to a direct
    `inference` call on the same input (scores 1e-4, boxes 1e-2 px)."""
    import os
    import pathlib
    import shutil

    import numpy as np
    from omni3d_tpu_torch.data.image import read_image_bgr
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.tools import demo

    root = pathlib.Path(__file__).resolve().parents[1]
    folder = tmp_path / "imgs"
    folder.mkdir()
    names = ("q75_420_37x53", "q95_420_640x480")
    for name in names:
        shutil.copy(root / "tests" / "data" / "jpeg" / f"{name}.jpg", folder)
    calls, real = [], demo.infer

    def infer(model, cfg, image_bgr, K):
        det = real(model, cfg, image_bgr, K)
        calls.append((model, cfg, image_bgr, K, det))
        return det
    demo.infer = infer
    before = multilevel_roi_align.launches
    graphs_before = rcnn3d.inference_step.captures, rcnn3d.inference_step.replays
    try:
        records = demo.main(["--config-file", str(root / "configs" / "cubercnn_DLA34_FPN.yaml"),
                             "--input-folder", str(folder), "--threshold", "0.0",
                             "--output-dir", str(tmp_path / "out"),
                             "MODEL.ROI_HEADS.NUM_CLASSES", "5", "MODEL.FPN.OUT_CHANNELS", "64",
                             "MODEL.ROI_BOX_HEAD.FC_DIM", "128", "MODEL.ROI_CUBE_HEAD.FC_DIM",
                             "128", "SEED", "0", "OUTPUT_DIR", str(tmp_path / "o")])
    finally:
        demo.infer = real
    torch.cuda.synchronize()
    # one graph per padded shape: a capture runs the wrappers twice (its
    # eager warm-up and the capture), a replay not at all
    captures = rcnn3d.inference_step.captures - graphs_before[0]
    replays = rcnn3d.inference_step.replays - graphs_before[1]
    assert captures + replays == len(names) and captures >= 1
    assert multilevel_roi_align.launches - before == 4 * captures
    for (model, cfg, img, K, det), rec in zip(calls, records):
        for kind, shape in (("boxes", img.shape), ("novel", (512, 512, 3)), ("bev", (400, 400, 3))):
            assert read_image_bgr(rec["files"][kind]).shape == shape
        canvas, net_h, net_w = demo.network_input(cfg, img)
        want = rcnn3d.inference(
            model, rcnn3d.preprocess(torch.from_numpy(canvas[None]).to(device),
                                     cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD),
            torch.from_numpy(K[None]).to(device),
            torch.tensor([img.shape[0] / net_h], device=device),
            hw=torch.tensor([[net_h, net_w]], dtype=torch.float32, device=device),
            **rcnn3d.inference_kwargs(cfg))
        want = {k: v[0].float().cpu().numpy() for k, v in want.items()}
        assert np.array_equal(det["valid"], want["valid"])
        assert np.abs(det["scores"] - want["scores"]).max() <= 1e-4
        assert np.abs(det["boxes"] - want["boxes"]).max() <= 1e-2
        assert os.path.getsize(rec["files"]["boxes"]) > 0


@pytest.mark.cuda
def test_render_depth_map_card_equals_cpu(device):
    """20 boxes at 640 x 480: silhouettes and nearest-instance indices
    equal on the card and the CPU, depth within 1e-5 relative."""
    import numpy as np
    from omni3d_tpu_torch.utils.geometry import euler_angles_to_matrix
    from omni3d_tpu_torch.utils.render import render_depth_map

    rng = np.random.default_rng(1)
    boxes = np.concatenate([np.stack([rng.uniform(-4, 4, 20), rng.uniform(-1, 1.5, 20),
                                      rng.uniform(0.5, 25, 20)], 1),
                            rng.uniform(0.5, 3.0, (20, 3))], 1).astype(np.float32)
    R = euler_angles_to_matrix(torch.tensor(rng.uniform(-np.pi, np.pi, (20, 3)),
                                            dtype=torch.float32)).numpy()
    K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    cs, cd, ci = (t.cpu() for t in render_depth_map(K, boxes, R, 640, 480, device=device))
    ps, pd, pi = render_depth_map(K, boxes, R, 640, 480, device="cpu")
    assert torch.equal(cs, ps) and torch.equal(ci, pi)
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(cd), fin) and fin.any()
    assert float(((cd[fin] - pd[fin]).abs() / pd[fin]).max()) <= 1e-5


@pytest.mark.cuda
def test_bench_at_bs1_on_the_card(device):
    """`tools.bench` at bs 1 (full width, bf16): per eager call two forward
    launches and 2 + 2 NMS launches through the wrappers, per graphed call
    none through them and the same in the profiler's kernel records, the
    graphed outputs equal to a direct `inference` call, device profiles and
    0 < mfu <= 1."""
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.tools import bench

    cfg = bench.config()
    record, last = bench.run(cfg, (1,), rounds=1, iters=2, device=device)
    row = record["batch_sizes"][0]
    per_call = {"roi_align_fwd": 2.0, "roi_align_bwd": 0.0, "suppression_words": 2.0,
                "greedy_keep": 2.0}
    assert row["eager_wrapper_launches_per_call"] == per_call
    assert row["wrapper_launches_per_call"] == dict.fromkeys(per_call, 0.0)
    assert row["profile"]["hand_kernel_launches_per_call"] == per_call
    assert row["eager_profile"]["hand_kernel_launches_per_call"] == per_call
    assert record["graphs"]["captures"] == 1 and record["graphs"]["pool_bytes"] > 0
    for prefix in ("", "eager_"):
        assert 0 < row[prefix + "mfu"] <= 1 and 0 < row[prefix + "device_busy_share"] <= 1
    (_, images, Ks, ratios), got = last[1]
    model = bench.random_model(cfg, device)
    want = rcnn3d.inference(model, images, Ks, ratios, **rcnn3d.inference_kwargs(cfg))
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
def test_stage_chain_is_inference_on_the_card(device):
    """`tools.profile_stages.stage_chain` at full width, bf16, bs 2: its
    outputs equal `inference`'s exactly."""
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.tools import bench, profile_stages

    cfg = bench.config()
    model = bench.random_model(cfg, device)
    kw = rcnn3d.inference_kwargs(cfg)
    _, images, Ks, ratios = bench.inputs(cfg, (2,), bench.IMG, device)[2]
    out, _, _ = profile_stages.stage_chain(model, images, Ks, ratios, **kw)
    want = rcnn3d.inference(model, images, Ks, ratios, **kw)
    for k, v in want.items():
        assert torch.equal(out[k], v), k


def _nms_rows(shape, seed=0, spread=400.0):
    """Seeded score-clustered rows (..., N): boxes in clusters, ~10% exact
    duplicates, zero-width boxes, scores on 17 levels (exact ties), ~10%
    invalid rows and a NaN box per row."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = shape[-1]
    centers = rng.uniform(20, spread, shape[:-1] + (max(1, n // 8), 2))
    pick = rng.integers(0, centers.shape[-2], shape)
    c = np.take_along_axis(centers, pick[..., None], -2) + rng.normal(0, 6, shape + (2,))
    wh = rng.uniform(8, 80, shape + (2,))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    dup = rng.uniform(size=shape) < 0.1
    boxes[dup] = boxes[..., :1, :].repeat(n, -2)[dup]
    zero = rng.uniform(size=shape) < 0.05
    boxes[..., 2][zero] = boxes[..., 0][zero]
    boxes[..., n // 2, 1] = np.nan
    scores = (np.round(rng.uniform(0, 1, shape) * 16) / 16).astype(np.float32)
    valid = rng.uniform(size=shape) > 0.1
    return torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,thresh,kind", [((2, 5, 1000), 0.7, "clusters"),
                                               ((1, 5, 2000), 0.7, "clusters"),
                                               ((3, 1024), 0.5, "classes"),
                                               ((4, 65), 0.5, "clusters"),
                                               ((2, 5000), 0.7, "clusters"),
                                               ((1, 16384), 0.7, "clusters"),
                                               ((4, 1000), 0.5, "near"),
                                               ((4, 1000), 0.7, "near")],
                         ids=["rpn-test", "rpn-train", "per-class", "65", "5000", "16384",
                              "near-0.5", "near-0.7"])
def test_nms_kernels_match_plain(device, shape, thresh, kind):
    """The keep mask of `nms_mask` on the card (the two kernels) equals
    `nms_mask_plain` on the card bit for bit; the words equal the mirror
    where the kernel writes them; the greedy kernel on the mirror's words
    gives the mirror's walk; one launch of each kernel per call. N = 2000,
    5000 and 16384 take the greedy kernel's ring of staged tiles past its
    end (N > 4096: folds from device memory); the near-threshold pairs'
    IoU lies within 4 ULP of t, so the fast IoU test leaves some to the
    division."""
    from omni3d_tpu_torch.ops import nms as tnms
    from omni3d_tpu_torch.ops import nms_cuda
    from omni3d_tpu_torch.tools import profile_nms

    if kind == "near":
        boxes, scores, valid, _ = profile_nms.near_threshold(shape, thresh, 1)
    else:
        boxes, scores, valid = _nms_rows(shape)
    if kind == "classes":
        idx = torch.randint(0, 50, shape, generator=torch.Generator().manual_seed(1))
        boxes = tnms._offset_by_class(boxes, idx)
    b, s, v = boxes.to(device), scores.to(device), valid.to(device)
    before = (nms_cuda.suppression_words.launches, nms_cuda.greedy_keep.launches)
    got = tnms.nms_mask(b, s, thresh, v)
    torch.cuda.synchronize()
    assert (nms_cuda.suppression_words.launches - before[0],
            nms_cuda.greedy_keep.launches - before[1]) == (1, 1)
    want = tnms.nms_mask_plain(b, s, thresh, v)
    assert got.dtype == torch.bool and torch.equal(got, want)
    if shape[-1] <= 2000:
        assert torch.equal(got.cpu(), tnms.nms_mask_plain(boxes, scores, thresh, valid))
    assert 0 < int(got.sum()) < int(valid.sum())

    n = shape[-1]
    boxes_s, valid_s, _ = tnms._sorted(b, s, v)
    rows = (-1, n)
    boxes_s, valid_s = boxes_s.reshape(*rows, 4), valid_s.reshape(rows)
    slow = torch.zeros(1, dtype=torch.int64, device=device)
    words = nms_cuda.suppression_words(boxes_s, valid_s, thresh, slow_pairs=slow)
    mirror = tnms.suppression_words(boxes_s, valid_s, thresh)
    W = words.shape[1]
    defined = torch.arange(W, device=device)[:, None] >= torch.arange(64 * W, device=device) // 64
    assert torch.equal(words[:, defined], mirror[:, defined])
    if kind == "near":
        assert int(slow.item()) > 0
    keep_s = nms_cuda.greedy_keep(mirror, valid_s)
    if n <= 2000:
        assert torch.equal(keep_s.cpu(), tnms.greedy_keep_from_words(mirror.cpu(), valid_s.cpu()))
    else:
        assert torch.equal(keep_s, nms_cuda.greedy_keep(words, valid_s))


@pytest.mark.cuda
@pytest.mark.parametrize("thresh", [-0.1, 0.0, 1e-12, 1.0, 2.0 ** 31, float("nan")])
def test_nms_kernels_thresholds_outside_the_band(device, thresh):
    """Thresholds where the words kernel's fast IoU test steps aside: t < 0
    and NaN divide every pair (the other instance of the kernel), t = 0 and
    t outside `nms_cuda.FAST_RANGE` divide every overlapping pair; the
    words equal the mirror and the keep mask the plain one."""
    from omni3d_tpu_torch.ops import nms as tnms
    from omni3d_tpu_torch.ops import nms_cuda

    boxes, scores, valid = _nms_rows((3, 200), seed=7)
    b, s, v = boxes.to(device), scores.to(device), valid.to(device)
    assert torch.equal(tnms.nms_mask(b, s, thresh, v), tnms.nms_mask_plain(b, s, thresh, v))
    boxes_s, valid_s, _ = tnms._sorted(b, s, v)
    slow = torch.zeros(1, dtype=torch.int64, device=device)
    words = nms_cuda.suppression_words(boxes_s, valid_s, thresh, slow_pairs=slow)
    mirror = tnms.suppression_words(boxes_s, valid_s, thresh)
    defined = torch.arange(4, device=device)[:, None] >= torch.arange(256, device=device) // 64
    assert torch.equal(words[:, defined], mirror[:, defined])
    fast, _, _ = nms_cuda.iou_band(thresh)
    assert fast == (thresh >= 0) and int(slow.item()) > 0


@pytest.mark.cuda
def test_nms_kernels_valid_boxes_need_not_be_a_prefix(device):
    """Sorted rows whose first box and second 64-box tile are invalid (a +NaN
    score sorts first): the words kernel writes zero words for the invalid
    boxes, and the kernels' mask equals the mirror's and the plain one."""
    from omni3d_tpu_torch.ops import nms as tnms
    from omni3d_tpu_torch.ops import nms_cuda

    boxes, _, valid = _nms_rows((3, 300), seed=4)
    valid[:, 0] = False
    valid[:, 64:128] = False
    desc = torch.linspace(1, 0.5, 300).expand(3, 300).contiguous()
    b, v = boxes.to(device), valid.to(device)
    words = nms_cuda.suppression_words(b, v, 0.7)
    keep = nms_cuda.greedy_keep(words, v).cpu()
    mirror = tnms.suppression_words(boxes, valid, 0.7)
    assert not words[:, 1:, 64:128].any() and not words[:, :, 0].any()   # written blocks
    defined = torch.arange(5)[:, None] >= torch.arange(320) // 64
    assert torch.equal(words.cpu()[:, defined], mirror[:, defined])
    assert torch.equal(keep, tnms.greedy_keep_from_words(mirror, valid))
    assert torch.equal(keep, tnms.nms_mask_plain(boxes, desc, 0.7, valid))
    assert keep[:, 128:].any() and not keep[:, 64:128].any()


@pytest.mark.cuda
def test_nms_wrappers_refuse_what_the_kernels_do_not_take(device):
    from omni3d_tpu_torch.ops import nms as tnms
    from omni3d_tpu_torch.ops import nms_cuda

    boxes, scores, valid = (x.to(device) for x in _nms_rows((2, 100)))
    with pytest.raises(ValueError):
        tnms.nms_mask(boxes.double(), scores, 0.7, valid)
    with pytest.raises(ValueError):
        nms_cuda.suppression_words(boxes.double(), valid, 0.7)
    with pytest.raises(ValueError):   # not contiguous
        nms_cuda.suppression_words(boxes.transpose(0, 1).contiguous().transpose(0, 1),
                                   valid, 0.7)
    with pytest.raises(ValueError):   # validity on the CPU, boxes on the card
        nms_cuda.suppression_words(boxes, valid.cpu(), 0.7)
    with pytest.raises(ValueError):
        nms_cuda.suppression_words(boxes.cpu(), valid.cpu(), 0.7)
    words = nms_cuda.suppression_words(boxes, valid, 0.7)
    with pytest.raises(ValueError):
        nms_cuda.greedy_keep(words.float(), valid)
    with pytest.raises(ValueError):
        nms_cuda.greedy_keep(words, valid, torch.zeros(2, 100, dtype=torch.int32, device=device))
    with pytest.raises(ValueError):
        nms_cuda.greedy_keep(words[:, :1], valid)   # (R, W, 64 W) is (2, 2, 128) here


@pytest.mark.cuda
def test_nms_makes_no_host_sync(device):
    """`nms_mask` and `batched_nms_indices` on the card issue no
    synchronising CUDA call (`torch.cuda.set_sync_debug_mode("error")`
    raises on one); the plain fixpoint does, once per iteration."""
    from omni3d_tpu_torch.ops import nms as tnms

    boxes, scores, valid = (x.to(device) for x in _nms_rows((2, 5, 1000)))
    classes = torch.arange(1000, device=device).remainder(7).expand(2, 5, 1000)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tnms.nms_mask(boxes, scores, 0.7, valid)
        tnms.batched_nms_indices(boxes, scores, classes, 0.5, 100, valid)
        with pytest.raises(RuntimeError):
            tnms.nms_mask_plain(boxes, scores, 0.7, valid)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# inference_step: CUDA graphs of `inference` at a narrow width
NARROW = ("MODEL.ROI_HEADS.NUM_CLASSES", "5", "MODEL.FPN.OUT_CHANNELS", "64",
          "MODEL.ROI_BOX_HEAD.FC_DIM", "128", "MODEL.ROI_CUBE_HEAD.FC_DIM", "128",
          "MODEL.RPN.POST_NMS_TOPK_TEST", "200", "TEST.DETECTIONS_PER_IMAGE", "20")


def _narrow_model(device, train=False, seed=0, dtype=torch.float32):
    import pathlib

    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.tools.synthetic import condition_pose_bias_

    cfg = get_default_cfg()
    cfg.merge_from_file(str(pathlib.Path(__file__).resolve().parents[1] / "configs"
                            / "cubercnn_DLA34_FPN.yaml"))
    cfg.merge_from_list(list(NARROW))
    model = rcnn3d.build_model(cfg, device=device, dtype=dtype, seed=seed, train=train)
    condition_pose_bias_(model)
    return model, rcnn3d.inference_kwargs(cfg)


def _batch(device, bs, h, w, seed=0):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(bs, h, w, 3, generator=gen).to(device)
    K = torch.tensor([[200.0, 0, w / 2], [0, 200.0, h / 2], [0, 0, 1]], device=device)
    hw = torch.tensor([[h, w]] * bs, dtype=torch.float32, device=device)
    return images, K.expand(bs, 3, 3).contiguous(), torch.ones(bs, device=device), hw


def _assert_equal(got, want, what=""):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), (what, k)


@pytest.mark.cuda
def test_inference_step_replays_equal_eager(device):
    """Three keys (bs 2 at 96 x 128 with hw, bs 1 at 128 x 128, the oracle
    branch): the first call (the eager warm-up) and replays in the order A,
    B, A, C, B are bit-equal to `inference`; each first call (the warm-up
    and the capture) launched 4 forward, 0 backward and 4 + 4 NMS kernels
    through their wrappers (the oracle's 2 forward), a replay none."""
    from omni3d_tpu_torch.models import rcnn3d

    model, kw = _narrow_model(device)
    a_img, a_K, a_r, a_hw = _batch(device, 2, 96, 128)
    b_img, b_K, b_r, _ = _batch(device, 1, 128, 128, seed=1)
    oracle = (torch.tensor([[[10.0, 10.0, 60.0, 60.0], [20.0, 5.0, 90.0, 80.0]]] * 2,
                           device=device),
              torch.tensor([[1, 3]] * 2, dtype=torch.int32, device=device),
              torch.tensor([[True, False]] * 2, device=device))
    calls = {"A": lambda f: f(model, a_img, a_K, a_r, hw=a_hw, **kw),
             "B": lambda f: f(model, b_img, b_K, b_r, **kw),
             "C": lambda f: f(model, a_img, a_K, a_r, oracle=oracle, sampling_ratio=0)}
    want = {n: c(rcnn3d.inference) for n, c in calls.items()}
    counts = lambda: tuple(rcnn3d.kernel_launch_counts().values())  # noqa: E731
    graph_counts = lambda: (rcnn3d.inference_step.captures,  # noqa: E731
                            rcnn3d.inference_step.replays)
    start = graph_counts()
    for name in ("A", "B", "C"):
        before = counts()
        _assert_equal(calls[name](rcnn3d.inference_step), want[name], name)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(counts(), before))
        assert launched == ((4, 0, 4, 4) if name != "C" else (2, 0, 0, 0)), (name, launched)
    assert len(model.inference_graphs.graphs) == 3
    assert tuple(b - a for a, b in zip(start, graph_counts())) == (3, 0)
    before = counts()
    for name in ("A", "B", "A", "C", "B"):
        _assert_equal(calls[name](rcnn3d.inference_step), want[name], name)
    torch.cuda.synchronize()
    assert counts() == before
    assert tuple(b - a for a, b in zip(start, graph_counts())) == (3, 5)


@pytest.mark.cuda
def test_inference_step_returns_fresh_outputs(device):
    """Two replays at one shape on other images: the first call's outputs
    are unchanged by the second, and each equals eager on its images."""
    from omni3d_tpu_torch.models import rcnn3d

    model, kw = _narrow_model(device)
    one, two = _batch(device, 2, 96, 128), _batch(device, 2, 96, 128, seed=3)
    want1 = rcnn3d.inference(model, *one[:3], **kw)
    want2 = rcnn3d.inference(model, *two[:3], **kw)
    assert any(not torch.equal(want1[k], want2[k]) for k in want1)
    rcnn3d.inference_step(model, *one[:3], **kw)            # capture
    got1 = rcnn3d.inference_step(model, *one[:3], **kw)
    got2 = rcnn3d.inference_step(model, *two[:3], **kw)
    _assert_equal(got1, want1, "first")
    _assert_equal(got2, want2, "second")


@pytest.mark.cuda
def test_inference_step_sees_new_weights_and_recaptures_on_rebinding(device):
    """`load_state_dict` after the capture: the replay (no new capture)
    equals eager with the new weights. A parameter rebound to new storage:
    the graphs are dropped, `recaptures` counts it, and the new graph equals
    eager."""
    from omni3d_tpu_torch.models import rcnn3d

    model, kw = _narrow_model(device)
    other, _ = _narrow_model(device, seed=1)
    images, Ks, ratios, _ = _batch(device, 2, 96, 128)
    step = lambda: rcnn3d.inference_step(model, images, Ks, ratios, **kw)  # noqa: E731
    eager = lambda: rcnn3d.inference(model, images, Ks, ratios, **kw)  # noqa: E731
    before = eager()
    captures = rcnn3d.inference_step.captures
    step()
    graphs = model.inference_graphs
    model.load_state_dict(other.state_dict())
    got, want = step(), eager()
    _assert_equal(got, want, "load_state_dict")
    assert any(not torch.equal(want[k], before[k]) for k in want)
    assert (rcnn3d.inference_step.captures - captures, graphs.recaptures) == (1, 0)
    w = model.roi_heads.box_predictor.cls_score.weight
    w.data = w.data * 0.5
    got, want = step(), eager()
    _assert_equal(got, want, "rebound")
    assert (rcnn3d.inference_step.captures - captures, graphs.recaptures) == (2, 1)
    _assert_equal(step(), want, "replay after rebinding")


@pytest.mark.cuda
def test_inference_step_of_a_training_model_sees_optimizer_steps(device):
    """A `train=True` bf16 model (float32 master weights, cast per call
    inside the graph) under `engine.loop.eval_mode`, as `visualize_training`
    and `do_test` call it: after an optimizer step the replay equals eager
    with the stepped weights, and the model's training flags come back."""
    from omni3d_tpu_torch.engine.loop import eval_mode
    from omni3d_tpu_torch.models import rcnn3d

    model, kw = _narrow_model(device, train=True, dtype=torch.bfloat16)
    images, Ks, ratios, hw = _batch(device, 1, 96, 128)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    flags = [m.training for m in model.modules()]
    counts = (rcnn3d.inference_step.captures, rcnn3d.inference_step.replays)
    with eval_mode(model):
        before = rcnn3d.inference_step(model, images, Ks, ratios, hw=hw, **kw)
    gen = torch.Generator().manual_seed(2)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen).to(device)
    opt.step()
    with eval_mode(model):
        got = rcnn3d.inference_step(model, images, Ks, ratios, hw=hw, **kw)
        want = rcnn3d.inference(model, images, Ks, ratios, hw=hw, **kw)
    assert [m.training for m in model.modules()] == flags and model.training
    _assert_equal(got, want, "after the step")
    assert any(not torch.equal(want[k], before[k]) for k in want)
    assert (rcnn3d.inference_step.captures - counts[0],
            rcnn3d.inference_step.replays - counts[1]) == (1, 1)
    assert model.inference_graphs.recaptures == 0


# utils.trace on the card: the stages' marker kernels inside the replayed
# graphs and the training step, read from the profiler's kernel records with
# no synchronise of their own

def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def _stage_ms(prof) -> dict:
    from omni3d_tpu_torch.utils import benchtime, trace
    return trace.stage_device_ms((e.name, e.time_range.start, e.time_range.end)
                                 for e in benchtime.kernel_events(prof.events(), markers=True))


@pytest.mark.cuda
def test_inference_step_times_its_stages_only_while_profiled(device, monkeypatch):
    """A capture launches the four stages' markers into the graph and an
    unprofiled eager call none; three profiled replays, each followed by
    the caller's synchronise, hold each stage's markers three times in
    their kernel records, each stage busy > 0 and the four within the
    replays' busy time, and the host spans of each call; the replays still
    equal eager."""
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.utils import benchtime, trace

    model, kw = _narrow_model(device)
    images, Ks, ratios, hw = _batch(device, 2, 96, 128)
    launched = []
    real_mark = trace._mark
    monkeypatch.setattr(trace, "_mark", lambda i, d: launched.append(i) or real_mark(i, d))
    want = rcnn3d.inference(model, images, Ks, ratios, hw=hw, **kw)
    assert launched == []
    step = lambda: rcnn3d.inference_step(model, images, Ks, ratios, hw=hw, **kw)  # noqa: E731
    step()                                     # warm-up and capture
    names = ["inference.trunk", "inference.proposals", "inference.box", "inference.cube"]
    assert launched == [2 * trace.STAGES.index(n) + k for n in names for k in (0, 1)]
    _assert_equal(step(), want, "unprofiled replay")
    with _profiled() as prof:
        for _ in range(3):
            _assert_equal(step(), want, "profiled replay")
            torch.cuda.synchronize()
    stages = _stage_ms(prof)
    assert sorted(stages) == sorted(names)
    for n in names:
        assert len(stages[n]) == 3 and min(stages[n]) > 0, (n, stages[n])
    busy = benchtime.device_busy_ms(benchtime.kernel_events(prof.events()))
    assert sum(sum(v) for v in stages.values()) <= busy
    host = [e.name for e in prof.events() if e.name.startswith(trace.PREFIX)
            and e.device_type == torch.autograd.DeviceType.CPU]
    for n in ("prepare", "replay", "clone_out"):
        assert host.count(f"{trace.PREFIX}inference_step.{n}") == 3, n


@pytest.mark.cuda
def test_training_step_stage_readings_need_no_synchronise(device, monkeypatch):
    """Three profiled training steps call no `torch.cuda.synchronize`, and
    their kernel records give each step's stages (the optimizer's for each
    accepted step), each busy > 0, the forward's within the step's; an
    unprofiled step launches no marker."""
    import pathlib

    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer
    from omni3d_tpu_torch.utils import trace

    cfg = get_default_cfg()
    cfg.merge_from_file(str(pathlib.Path(__file__).resolve().parents[1] / "configs"
                            / "cubercnn_DLA34_FPN.yaml"))
    cfg.merge_from_list(list(NARROW))
    _, _, step, batch = synthetic_trainer(cfg, torch.bfloat16, 2, device, img=256)
    step(batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    launched = []
    real_mark = trace._mark
    monkeypatch.setattr(trace, "_mark", lambda i, d: launched.append(i) or real_mark(i, d))
    step(batch, torch.Generator().manual_seed(1))
    assert launched == []
    syncs = []
    real_sync = torch.cuda.synchronize
    with _profiled() as prof:
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
        accepted = [step(batch, torch.Generator().manual_seed(2 + i))["finite"] == 1.0
                    for i in range(3)]
        monkeypatch.setattr(torch.cuda, "synchronize", real_sync)
        real_sync()
    assert syncs == [] and launched
    stages = _stage_ms(prof)
    for n in ("step.forward", "step.backward", "step.trunk", "step.anchor_labelling",
              "step.roi_sampling", "step.cube", "step.optimizer"):
        want = sum(accepted) if n == "step.optimizer" else 3
        assert len(stages.get(n, [])) == want and min(stages[n]) > 0, (n, stages.get(n))
    # the stages inside the forward (step.rank_means follows it, under a process group only)
    inner = [n for n in trace.STAGES if n.startswith("step.") and n not in
             ("step.forward", "step.backward", "step.optimizer", "step.rank_means")]
    for k in range(3):
        assert sum(stages[n][k] for n in inner) <= stages["step.forward"][k] * (1 + 1e-6)


# ------------------------------------------- the train-mode BatchNorm kernels

BN_SHAPES = [(32, 16, 512, 768), (32, 32, 256, 384), (32, 64, 128, 192), (32, 128, 64, 96),
             (32, 256, 32, 48), (32, 512, 16, 24),        # DLA-34's trunk at 512 x 768, bs 32
             (4, 3, 37, 53), (4, 20, 33, 17), (2, 48, 19, 23), (3, 7, 11, 13)]   # ragged C


def _bn_case(device, shape, dtype, seed=0):
    """A channels-last input off zero, affine parameters, running
    statistics and an output gradient, drawn on the card."""
    n, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(n, h, w, c, generator=g, device=device) * 0.5 + 3).to(dtype)
    params = {"weight": torch.rand(c, generator=g, device=device) + 0.5,
              "bias": torch.randn(c, generator=g, device=device),
              "running_mean": torch.randn(c, generator=g, device=device),
              "running_var": torch.rand(c, generator=g, device=device) + 0.5}
    dy = torch.randn(n, h, w, c, generator=g, device=device).to(dtype)
    return x.permute(0, 3, 1, 2), params, dy.permute(0, 3, 1, 2)


def _bn_plain(x, params, dy, dtype, update=True):
    """`BatchNorm2d`'s train-mode formula in `dtype` through autograd (the
    batch statistics one pass, as the module's plain path takes them): y,
    dx, grad_weight, grad_bias and the running statistics."""
    xr = x.to(dtype).requires_grad_()
    weight = params["weight"].to(dtype).requires_grad_()
    bias = params["bias"].to(dtype).requires_grad_()
    mean = xr.mean(dim=(0, 2, 3))
    var = ((xr * xr).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
    a = weight * torch.rsqrt(var + 1e-5)
    y = xr * a[:, None, None] + (bias - mean * a)[:, None, None]
    y.backward(dy.to(dtype))
    running = [params[k].to(dtype) for k in ("running_mean", "running_var")]
    if update:
        running = [0.9 * v + 0.1 * stat.detach() for v, stat in zip(running, (mean, var))]
    return y.detach(), xr.grad, weight.grad, bias.grad, running


def _bn_close(got, want, rel, bf16):
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    tol = rel * scale + (2.0 ** -8 * want.abs() if bf16 else 0.0)
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", BN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_batch_norm_kernels_match_mirror_and_plain(device, shape, dtype):
    """Forward (y, stats, the running update) and backward (dx, the
    parameters' gradients) equal the plain-PyTorch mirror of their
    arithmetic bit for bit, and the plain formula: within a few float32
    roundings of it in float64, and within the float32 formula's own
    one-pass variance error (2e-4 of the largest) of it in float32; bf16
    within half a bf16 ULP more, the one rounding of y and dx."""
    from omni3d_tpu_torch.ops import batch_norm_cuda as bnc
    x, params, dy = _bn_case(device, shape, dtype)
    w, b = params["weight"], params["bias"]
    rk = [params[k].clone() for k in ("running_mean", "running_var")]
    rm = [params[k].clone() for k in ("running_mean", "running_var")]
    y, stats = bnc.forward(x, w, b, *rk, True)
    dx, gw, gb = bnc.backward(x, dy, stats)
    y_m, stats_m = bnc.forward_mirror(x, w, b, *rm, True)
    dx_m, gw_m, gb_m = bnc.backward_mirror(x, dy, stats_m)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    for got, want in zip((y, stats, *rk, dx, gw, gb), (y_m, stats_m, *rm, dx_m, gw_m, gb_m)):
        assert torch.equal(got, want)
    bf16 = dtype == torch.bfloat16
    eps = 2.0 ** -23
    for ref_dtype, rel in ((torch.float64, 32 * eps), (torch.float32, 2e-4)):
        want_y, want_dx, want_gw, want_gb, want_running = _bn_plain(x, params, dy, ref_dtype)
        _bn_close(y, want_y, rel, bf16)
        _bn_close(dx, want_dx, 2 * rel, bf16)
        _bn_close(gw, want_gw, rel, False)
        _bn_close(gb, want_gb, rel, False)
        _bn_close(rk[0], want_running[0], rel, False)
        _bn_close(rk[1], want_running[1], rel, False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 16, 512, 768), (32, 512, 16, 24), (4, 20, 33, 17)],
                         ids=lambda s: "x".join(map(str, s)))
def test_batch_norm_kernels_are_bit_reproducible(device, shape):
    """Two calls give the same bits: no float atomics, a fixed order."""
    from omni3d_tpu_torch.ops import batch_norm_cuda as bnc
    x, params, dy = _bn_case(device, shape, torch.bfloat16, seed=1)
    runs = []
    for _ in range(2):
        y, stats = bnc.forward(x, *params.values(), False)
        runs.append((y, stats, *bnc.backward(x, dy, stats)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_batch_norm_module_updates_running_stats_in_place(device):
    """Through `BatchNorm2d`: the running statistics are updated in the
    module's own tensors (the stabilizer's clones and the training
    snapshot hold them), as the mirror updates them; under
    `running_stats_frozen` they stay; each call counts `fused`; the
    gradients reach the parameters."""
    from omni3d_tpu_torch.models import layers as tl
    from omni3d_tpu_torch.ops import batch_norm_cuda as bnc
    x, params, dy = _bn_case(device, (8, 64, 40, 56), torch.bfloat16, seed=2)
    bn = tl.BatchNorm2d(64).to(device).train()
    bn.load_state_dict(params)
    held = (bn.running_mean, bn.running_var)
    ptrs = [t.data_ptr() for t in held]
    want = [params[k].clone() for k in ("running_mean", "running_var")]
    _, stats = bnc.forward_mirror(x, params["weight"], params["bias"], *want, True)
    _, gw, gb = bnc.backward_mirror(x, dy, stats)
    calls, launches = dict(tl.bn_calls), (bnc.forward.launches, bnc.backward.launches)
    bn(x.requires_grad_()).backward(dy)
    torch.cuda.synchronize()
    assert (bn.running_mean, bn.running_var) == held and [t.data_ptr() for t in held] == ptrs
    assert torch.equal(bn.running_mean, want[0]) and torch.equal(bn.running_var, want[1])
    assert torch.equal(bn.weight.grad, gw) and torch.equal(bn.bias.grad, gb)
    with tl.running_stats_frozen(bn):
        bn(x)
    torch.cuda.synchronize()
    assert torch.equal(bn.running_mean, want[0]) and torch.equal(bn.running_var, want[1])
    assert tl.bn_calls == {"fused": calls["fused"] + 2, "plain": calls["plain"]}
    assert (bnc.forward.launches, bnc.backward.launches) == (launches[0] + 2, launches[1] + 1)


@pytest.mark.cuda
def test_batch_norm_cuda_inputs_of_any_layout_take_the_kernels(device):
    """On the card every train-mode input goes through the kernels: one
    that is not channels-last is made so first (the same y, gradients and
    running statistics as its channels-last twin) and counts `fused`; a
    float16 input raises; a CPU input takes the plain formula and counts
    `plain`; the wrappers refuse all three; a gradient that is not
    channels-last is made so."""
    from omni3d_tpu_torch.models import layers as tl
    from omni3d_tpu_torch.ops import batch_norm_cuda as bnc
    x, params, dy = _bn_case(device, (2, 16, 9, 13), torch.float32, seed=3)
    outs = []
    calls = dict(tl.bn_calls)
    for xi in (x, x.contiguous()):
        bn = tl.BatchNorm2d(16).to(device).train()
        bn.load_state_dict(params)
        xi = xi.detach().requires_grad_()
        y = bn(xi)
        y.backward(dy)
        outs.append((y, xi.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
                     bn.running_var))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert tl.bn_calls == {"fused": calls["fused"] + 2, "plain": calls["plain"]}
    with pytest.raises(ValueError):
        bn(x.half())
    bn.cpu()(x.cpu())
    assert tl.bn_calls == {"fused": calls["fused"] + 2, "plain": calls["plain"] + 1}
    for xo in (x.contiguous(), x.half(), x.cpu()):
        with pytest.raises(ValueError):
            bnc.forward(xo, *(v.to(xo.device) for v in params.values()), False)
    _, stats = bnc.forward(x, *params.values(), False)
    got = bnc.backward(x, dy.contiguous(), stats)
    want = bnc.backward(x, dy, stats)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_dla34_training_step_runs_39_fused_batch_norms(device):
    """One bf16 DLA-34 training step: each of the trunk's 39 train-mode BN
    layers goes through the kernels forward, none through the plain
    formula; 37 backward (the two trees' unused projections run under
    no_grad, so that only their running statistics move)."""
    import pathlib

    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.models import layers as tl
    from omni3d_tpu_torch.ops import batch_norm_cuda as bnc
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer

    cfg = get_default_cfg()
    cfg.merge_from_file(str(pathlib.Path(__file__).resolve().parents[1] / "configs"
                            / "cubercnn_DLA34_FPN.yaml"))
    cfg.merge_from_list(list(NARROW))
    _, _, step, batch = synthetic_trainer(cfg, torch.bfloat16, 2, device, img=256)
    calls, launches = dict(tl.bn_calls), (bnc.forward.launches, bnc.backward.launches)
    logs = step(batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert logs["finite"] == 1.0
    assert tl.bn_calls == {"fused": calls["fused"] + 39, "plain": calls["plain"]}
    assert (bnc.forward.launches, bnc.backward.launches) == (launches[0] + 39, launches[1] + 37)
