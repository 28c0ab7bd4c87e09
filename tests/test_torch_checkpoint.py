"""The flax -> torch bridge: key mapping, bit-exact round trip through the
JAX package's own converter, and strict loading into the port's model."""
import pathlib

import jax
import numpy as np
import pytest
import torch

from omni3d_tpu.utils import checkpoint as jax_ckpt
from omni3d_tpu_torch.config import get_default_cfg
from omni3d_tpu_torch.models.rcnn3d import build_model
from omni3d_tpu_torch.utils import checkpoint as port_ckpt
from torch_port_helpers import jax_model, pooled_shape, random_variables, small_cfgs


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = small_cfgs()
    variables = random_variables(jax_model(jcfg))
    sd = port_ckpt.state_dict_from_flax(variables["params"], variables["batch_stats"],
                                        pooled_shape(tcfg))
    return tcfg, variables, sd


def _paths(tree):
    return [tuple(getattr(k, "key", str(k)) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_key_mapping_matches_jax(setup):
    _, variables, _ = setup
    paths = _paths(variables["params"]) + _paths(variables["batch_stats"])
    assert len(paths) > 100
    for path in paths:
        mod = path[:-1] if path[-1] in port_ckpt._LEAVES else path
        assert port_ckpt.flax_path_to_torch(mod) == jax_ckpt.flax_path_to_torch(mod), path


def test_round_trip_bit_exact(setup):
    """convert_reference_checkpoint(state_dict_from_flax(v)) == v exactly."""
    tcfg, variables, sd = setup
    new_p, new_s, report = jax_ckpt.convert_reference_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, variables["params"],
        variables["batch_stats"], pooled_shape=pooled_shape(tcfg), strict=True)
    assert report["missing"] == [] and report["unused"] == []
    for tree, new in ((variables["params"], new_p), (variables["batch_stats"], new_s)):
        a = jax.tree_util.tree_leaves(tree)
        b = jax.tree_util.tree_leaves(new)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape and np.array_equal(x, np.asarray(y))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_model_loads_strict(setup, dtype):
    tcfg, _, sd = setup
    model = build_model(tcfg, device="cpu", dtype=dtype)
    own = model.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert own[k].shape == v.shape, k
    model.load_state_dict(sd, strict=True)
    own = model.state_dict()
    # convs and linears hold the compute dtype; BN buffers and priors stay f32
    assert own["backbone.fpn_output2.weight"].dtype == dtype
    assert own["backbone.bottom_up.base_layer.1.running_var"].dtype == torch.float32
    assert own["roi_heads.priors_dims_per_cat"].dtype == torch.float32
    w = sd["roi_heads.box_head.fc1.weight"]
    assert torch.equal(own["roi_heads.box_head.fc1.weight"], w.to(dtype))


def test_first_fc_chw_permutation(setup):
    """The box head's fc1 columns follow detectron2's (C, H, W) flatten."""
    tcfg, variables, sd = setup
    C, H, W = pooled_shape(tcfg)
    k = variables["params"]["box_head"]["fc1"]["kernel"]            # (H*W*C, out)
    x = np.random.default_rng(1).standard_normal((2, H, W, C)).astype(np.float32)
    want = x.reshape(2, -1) @ k
    got = torch.from_numpy(x).permute(0, 3, 1, 2).flatten(1) @ sd["roi_heads.box_head.fc1.weight"].T
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


CONFIGS = sorted(p.stem for p in (pathlib.Path(__file__).resolve().parents[1] / "configs")
                 .glob("cubercnn_*.yaml"))


@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_builds_and_loads_the_jax_models_weights(name):
    """Every model configuration builds on the CPU at full width, and the
    JAX model of the same config (at the narrow test widths) carries its
    variables into the port through `state_dict_from_flax`, every key
    matched (a strict load)."""
    cfg = get_default_cfg()
    cfg.merge_from_file(str(pathlib.Path(__file__).resolve().parents[1] / "configs"
                            / f"{name}.yaml"))
    model = build_model(cfg, device="cpu")
    assert not model.training and model.cfg.MODEL.FPN.OUT_CHANNELS == 256
    jcfg, tcfg = small_cfgs(**{"MODEL.BACKBONE.NAME": cfg.MODEL.BACKBONE.NAME,
                               "MODEL.RESNETS.DEPTH": cfg.MODEL.RESNETS.DEPTH})
    variables = random_variables(jax_model(jcfg))
    sd = port_ckpt.state_dict_from_flax(variables["params"], variables["batch_stats"],
                                        pooled_shape(tcfg))
    build_model(tcfg, device="cpu").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("backbone", [
    ("build_resnet_from_vision_fpn_backbone", 18), ("build_resnet_from_vision_fpn_backbone", 50),
    ("build_densenet_fpn_backbone", 0), ("build_mnasnet_fpn_backbone", 0),
    ("build_shufflenet_fpn_backbone", 0), ("build_dla_from_vision_fpn_backbone", "dla102x")],
    ids=["resnet18", "resnet50", "densenet", "mnasnet", "shufflenet", "dla102x"])
def test_key_mapping_and_round_trip_match_jax_in_every_family(backbone):
    """The port's `flax_path_to_torch` gives the JAX package's key for every
    variable of each family's model, and the JAX package's converter takes
    `state_dict_from_flax`'s output back to the same variables bit for bit."""
    name, variant = backbone
    opts = {"MODEL.BACKBONE.NAME": name}
    if isinstance(variant, str):
        opts["MODEL.DLA.TYPE"] = variant
    elif variant:
        opts["MODEL.RESNETS.DEPTH"] = variant
    jcfg, tcfg = small_cfgs(**opts)
    variables = random_variables(jax_model(jcfg))
    paths = _paths(variables["params"]) + _paths(variables["batch_stats"])
    for path in paths:
        mod = path[:-1] if path[-1] in port_ckpt._LEAVES else path
        assert port_ckpt.flax_path_to_torch(mod) == jax_ckpt.flax_path_to_torch(mod), path
    sd = port_ckpt.state_dict_from_flax(variables["params"], variables["batch_stats"],
                                        pooled_shape(tcfg))
    new_p, new_s, report = jax_ckpt.convert_reference_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, variables["params"],
        variables["batch_stats"], pooled_shape=pooled_shape(tcfg), strict=True)
    assert report["missing"] == [] and report["unused"] == []
    for tree, new in ((variables["params"], new_p), (variables["batch_stats"], new_s)):
        for x, y in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(new)):
            assert x.shape == y.shape and np.array_equal(x, np.asarray(y))
    build_model(tcfg, device="cpu").load_state_dict(sd, strict=True)


def test_unknown_backbone_raises():
    cfg = get_default_cfg()
    cfg.MODEL.BACKBONE.NAME = "build_vgg_fpn_backbone"
    with pytest.raises(ValueError, match="Unknown backbone builder build_vgg_fpn_backbone"):
        build_model(cfg, device="cpu")
