"""DenseNet-121, MNASNet-1.0 and ShuffleNetV2-x1.0 of the port vs
`omni3d_tpu.models.extra_backbones`, and the torchvision namespaces, on
the CPU in f32.

Trunks: the same numpy-seeded weights through `state_dict_from_flax`, two
random 128 px images; eval-mode p2..p6 within 1e-5 of each map's largest
magnitude, train-mode p2..p6 and BN running statistics within 5e-3 of each
tensor's largest (see test_torch_resnet for why train mode is looser).
The torchvision fixtures (tests/torch_extra_backbones.py, transcribed from
the published layouts) load through `convert_imagenet_backbone` with no
key missing or unused beyond the dropped heads, give the same features,
and convert as the JAX package's `convert_imagenet_backbone` does. One
step at world size 1 (gloo, spawned) runs under DDP's static graph for a
family with no unused parameter and equals the step without a group."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.models import extra_backbones as jeb
from omni3d_tpu.utils import checkpoint as jckpt
from omni3d_tpu_torch.engine import train as ttrain
from omni3d_tpu_torch.models import extra_backbones as teb
from omni3d_tpu_torch.models import rcnn3d
from omni3d_tpu_torch.utils import checkpoint as tckpt
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax
from test_torch_train import TINY
from test_train import synthetic_batch
from torch_port_helpers import (BOTTOM_UP, SMALL, jax_model, pooled_shape, port_model,
                                random_variables, small_cfgs, trunk_parity)
import torch_ddp_workers as workers
import torch_extra_backbones as fixtures

FAMILIES = {
    "build_densenet_fpn_backbone": (jeb.DenseNet121, teb.DenseNet121, teb.densenet_out_channels),
    "build_mnasnet_fpn_backbone": (jeb.MNASNet10, teb.MNASNet10, teb.mnasnet_out_channels),
    "build_shufflenet_fpn_backbone": (jeb.ShuffleNetV2, teb.ShuffleNetV2,
                                      teb.shufflenet_out_channels),
}
# classifier heads of each torchvision file, which the detector drops
HEADS = {"build_densenet_fpn_backbone": ("classifier.",),
         "build_mnasnet_fpn_backbone": ("layers.14.", "layers.15.", "classifier."),
         "build_shufflenet_fpn_backbone": ("conv5.", "fc.")}


@pytest.mark.parametrize("builder", list(FAMILIES))
def test_trunk_matches_jax(builder):
    jax_cls, port_cls, out_channels = FAMILIES[builder]
    port = port_cls()
    assert port.out_channels == out_channels() == getattr(jeb, out_channels.__name__)()
    trunk_parity(jax_cls(), jax_cls(train=True), port, (128, 128))


@pytest.mark.parametrize("builder", list(FAMILIES))
def test_torchvision_namespace_loads_with_no_key_left_and_gives_its_features(builder):
    sd = fixtures.imagenet_state_dict(builder, seed=3)
    _, tcfg = small_cfgs(**{"MODEL.BACKBONE.NAME": builder})
    model = rcnn3d.build_model(tcfg, device="cpu", seed=0)
    rep = tckpt.convert_imagenet_backbone(sd, model, builder)
    assert rep["missing"] == [] and rep["unused"] == []
    assert rep["loaded"] == sum(1 for k in sd if not k.startswith(HEADS[builder])
                                and not k.endswith("num_batches_tracked"))
    assert any(k.startswith(HEADS[builder]) for k in sd)
    fixture = fixtures.FIXTURES[builder]()
    fixture.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 3, 96, 128)).astype(
        np.float32))
    with torch.no_grad():
        want = fixture.eval()(x)
        got = model.backbone.bottom_up(x)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()), err_msg=name)


@pytest.mark.parametrize("builder", list(FAMILIES))
def test_imagenet_weights_load_as_jax_converts_them(builder):
    jcfg, tcfg = small_cfgs(**{"MODEL.BACKBONE.NAME": builder})
    variables = random_variables(jax_model(jcfg), seed=0)
    sd = fixtures.imagenet_state_dict(builder, seed=4)
    params, stats, jrep = jckpt.convert_imagenet_backbone(
        sd, variables["params"], variables["batch_stats"], builder)
    want = state_dict_from_flax(params, stats, pooled_shape(tcfg))
    model = port_model(tcfg, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trep = tckpt.convert_imagenet_backbone(sd, model, builder)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], before[k]) != k.startswith(BOTTOM_UP), k   # only the trunk
    assert trep["loaded"] == jrep["loaded"] and not trep["missing"] and not trep["unused"]


def test_channel_shuffle_orders_channels_as_jax_and_torchvision():
    x = np.random.default_rng(6).standard_normal((2, 3, 4, 12)).astype(np.float32)   # NHWC
    want = np.asarray(jeb.channel_shuffle(jnp.asarray(x)))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    for inp in (tx.contiguous(), tx.contiguous(memory_format=torch.channels_last)):
        got = teb.channel_shuffle(inp)
        assert torch.equal(got, fixtures._torch_channel_shuffle(inp.contiguous()))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_one_rank_ddp_step_equals_the_plain_step(tmp_path):
    """ShuffleNetV2 (every parameter gets a gradient, unlike most DLA
    trees) at the narrow widths: one step in a spawned process of a gloo
    group of one, through `make_train_step`'s DistributedDataParallel with
    static_graph=True, against the same step without a group: logs,
    parameters, BN statistics and optimizer state bit-equal."""
    over = {**{".".join(k): v for k, v in SMALL.items()}, **TINY,
            "MODEL.BACKBONE.NAME": "build_shufflenet_fpn_backbone"}
    opts = [x for k, v in over.items() for x in (k, str(v))]
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic_batch(
        np.random.default_rng(7), num_classes=over["MODEL.ROI_HEADS.NUM_CLASSES"]).items()}
    model, opt, _, step = workers._trainer(opts, None)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    R = sum(3 * (64 // s) ** 2 for s in (4, 8, 16, 32, 64))
    noise = ttrain.sampling_noise(torch.Generator().manual_seed(1), 2, R,
                                  32 + batch["gt_boxes"].shape[1], "cpu")
    workers.spawn(workers.step_worker, 1, tmp_path, str(tmp_path), opts, sd, batch, [noise], 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)   # the worker's thread count: the same summation order
    try:
        want = workers._snapshot(model, opt, step, step(batch, noise=noise))
    finally:
        torch.set_num_threads(threads)
    got = torch.load(tmp_path / "rank0.pt")
    assert want["skipped"] == got["skipped"] == 0
    assert got["logs"] == want["logs"]
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert any(not torch.equal(v, sd[k]) for k, v in want["model"].items())
    for i, st in want["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"][i][k], v), (i, k)
