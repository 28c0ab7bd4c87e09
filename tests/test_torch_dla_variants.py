"""The nine DLA variants beside DLA-34 (`DLA_SPECS`) of the port vs
`omni3d_tpu.models.dla`, on the CPU in f32.

The same numpy-seeded weights through `state_dict_from_flax` (a strict
load: every tensor of the JAX trunk has its key and shape, which holds the
trees' root widths, dla169's two-level level2 among them), two random
128 px images; eval-mode p2..p6 within 1e-5 of each map's largest
magnitude, train-mode p2..p6 and BN running statistics within 5e-3 of each
tensor's largest (see test_torch_resnet for why train mode is looser).
The JAX package runs these variants with plain convolutions too (its
space-to-depth stem is DLA-34-only), here op by op, not compiled."""
import pytest

from omni3d_tpu.models.dla import DLA as JaxDLA
from omni3d_tpu.models.dla import DLA_SPECS as JAX_SPECS
from omni3d_tpu.models.dla import dla_out_channels as jax_out_channels
from omni3d_tpu_torch.config import get_default_cfg
from omni3d_tpu_torch.models import rcnn3d
from omni3d_tpu_torch.models.dla import DLA, DLA_SPECS, RESIDUAL_ROOT, Bottleneck
from torch_port_helpers import trunk_parity

VARIANTS = [v for v in DLA_SPECS if v != "dla34"]


def test_specs_are_the_jax_packages():
    assert DLA_SPECS == JAX_SPECS


@pytest.mark.parametrize("variant", VARIANTS)
def test_trunk_matches_jax(variant):
    port = DLA(variant)
    assert port.out_channels == jax_out_channels(variant)
    assert port.level5.root.residual == (variant in RESIDUAL_ROOT)
    block = DLA_SPECS[variant][2]
    leaf = port.level3.tree1
    while not isinstance(leaf.tree1, Bottleneck):
        leaf = leaf.tree1
    groups = {"bottleneck": 1, "bottleneck_r": 1, "bottleneckx": 32, "bottleneckx_r": 32,
              "bottleneckx2_r": 64}[block]
    assert leaf.tree1.conv2.groups == groups
    trunk_parity(JaxDLA(variant=variant), JaxDLA(variant=variant, train=True), port, (128, 128),
                 jit=False)


@pytest.mark.parametrize("variant", list(DLA_SPECS))
def test_every_variant_builds_from_the_config(variant):
    cfg = get_default_cfg()
    cfg.MODEL.DLA.TYPE = variant
    cfg.MODEL.FPN.OUT_CHANNELS = 16
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = cfg.MODEL.ROI_CUBE_HEAD.FC_DIM = 16
    model = rcnn3d.build_model(cfg, device="cpu", seed=0)
    assert not model.training
    ch = jax_out_channels(variant)
    assert [model.backbone.fpn_lateral2.in_channels, model.backbone.fpn_lateral5.in_channels] \
        == [ch["p2"], ch["p5"]]
