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


@pytest.mark.parametrize("name", ["cubercnn_ResNet34_FPN", "cubercnn_densenet_FPN"])
def test_unported_backbones_raise(name):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(pathlib.Path(__file__).resolve().parents[1] / "configs" / f"{name}.yaml"))
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")
