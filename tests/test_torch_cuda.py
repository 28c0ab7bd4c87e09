"""The CUDA ROIAlign kernels (forward and backward) vs their plain PyTorch
versions, the training entry point, a one-rank NCCL step and the
evaluation's IoU3D, on the card.

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
    finite loss."""
    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.models import rcnn3d
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
    logs = step(batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert (multilevel_roi_align.launches - before[0],
            multilevel_roi_align.bwd_launches - before[1]) == (1, 1)
    assert logs["finite"] == 1.0 and bool(torch.isfinite(torch.as_tensor(logs["total_loss"])))
