"""The CUDA ROIAlign kernel vs its plain PyTorch version, on the card.

These tests need a CUDA device and skip without one. They import no JAX, so
they run on a machine without it; there, skip tests/conftest.py (it imports
JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from omni3d_tpu_torch.ops.roi_align import multilevel_roi_align_plain, route_levels
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
    if dtype == torch.float32:
        atol = 1e-5
    else:
        atol = 2.0 ** (float(torch.log2(want.float().abs().max()).floor()) - 7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


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
