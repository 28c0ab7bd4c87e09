"""Shared setup for the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same weights: the JAX model's variable shapes come
from `jax.eval_shape` (no init compile), are filled from a numpy seed, and
reach the port through `omni3d_tpu_torch.utils.checkpoint.state_dict_from_flax`.
Widths are narrowed where the JAX modules honour the config (FPN width, FC
width, class count); the DLA-34 trunk keeps its fixed widths.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omni3d_tpu.config.cfg import StaticCfg
from omni3d_tpu.config.defaults import get_default_cfg as jax_default_cfg
from omni3d_tpu.models.rcnn3d import CubeRCNN as JaxCubeRCNN
from omni3d_tpu_torch.config.defaults import get_default_cfg as torch_default_cfg
from omni3d_tpu_torch.models.rcnn3d import build_model
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax

NUM_CLASSES = 5
FPN_CH = 32
FC_DIM = 64

SMALL = {
    ("MODEL", "ROI_HEADS", "NUM_CLASSES"): NUM_CLASSES,
    ("MODEL", "FPN", "OUT_CHANNELS"): FPN_CH,
    ("MODEL", "ROI_BOX_HEAD", "FC_DIM"): FC_DIM,
    ("MODEL", "ROI_CUBE_HEAD", "FC_DIM"): FC_DIM,
    ("TPU", "COMPUTE_DTYPE"): "float32",
}


def small_cfgs(**overrides):
    """(JAX cfg, port cfg) with the narrow test widths; `overrides` maps
    'SECTION.KEY' strings to values applied to both."""
    out = []
    for make in (jax_default_cfg, torch_default_cfg):
        cfg = make()
        for path, v in SMALL.items():
            node = cfg
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = v
        for key, v in overrides.items():
            node = cfg
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = v
        out.append(cfg)
    return out[0], out[1]


def random_variables(jax_model, image_hw=(64, 64), seed=0):
    """Seeded numpy values for every variable of `jax_model`, by shape."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + tuple(image_hw) + (3,), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = leaf.shape
        if name == "kernel":
            return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "bias":
            return 0.1 * rng.standard_normal(shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(shape)
        if name == "mean":
            return 0.1 * rng.standard_normal(shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return rng.uniform(0.5, 2.0, shape)   # priors

    tree = jax.tree_util.tree_map_with_path(
        lambda p, l: fill(p, l).astype(np.float32), shapes)
    return jax.tree.map(np.asarray, tree)


def jax_model(jcfg):
    return JaxCubeRCNN(cfg=StaticCfg(jcfg))


def pooled_shape(cfg):
    P = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    return (cfg.MODEL.FPN.OUT_CHANNELS, P, P)


def port_model(tcfg, variables):
    """The port's model on the CPU holding `variables` (loaded strictly)."""
    model = build_model(tcfg, device="cpu")
    sd = state_dict_from_flax(variables["params"], variables.get("batch_stats"),
                              pooled_shape(tcfg))
    model.load_state_dict(sd, strict=True)
    return model


def to_jnp(variables):
    return jax.tree.map(jnp.asarray, variables)


def t(x, dtype=None):
    """numpy -> torch (CPU)."""
    x = torch.from_numpy(np.array(x))
    return x if dtype is None else x.to(dtype)


BOTTOM_UP = "backbone.bottom_up."


def port_trunk(module, variables):
    """The port's bottom-up `module` holding a JAX trunk's `variables` (its
    own params / batch_stats collections), through `state_dict_from_flax`
    under the model's `backbone` scope; loaded strictly."""
    sd = state_dict_from_flax({"backbone": variables["params"]},
                              {"backbone": variables.get("batch_stats", {})})
    module.load_state_dict({k[len(BOTTOM_UP):]: v for k, v in sd.items()}, strict=True)
    return module


def trunk_parity(jax_trunk, jax_trunk_train, port_module, hw, seed=0, eval_rtol=1e-5,
                 train_rtol=5e-3, jit=True):
    """Hold the port's trunk against the JAX trunk on the same seeded
    weights and a batch of 2 random images at `hw`, in f32: p2..p6 in eval
    mode within eval_rtol of each map's largest magnitude; in train mode
    p2..p6 and the updated BN running statistics within train_rtol of each
    tensor's largest. `jit` False runs the JAX trunks op by op (quicker than
    compiling them for DLA trees; the same XLA CPU arithmetic per op)."""
    maybe_jit = jax.jit if jit else (lambda f: f)
    variables = random_variables(jax_trunk, hw, seed)
    x = np.random.default_rng(seed + 1).standard_normal((2,) + tuple(hw) + (3,)).astype(
        np.float32)
    jv, jx = to_jnp(variables), jnp.asarray(x)
    model = port_trunk(port_module, variables)

    def compare(got, want, rtol, what):
        for name in ("p2", "p3", "p4", "p5", "p6"):
            g = got[name].permute(0, 2, 3, 1).detach().numpy()
            w = np.asarray(want[name])
            assert g.shape == w.shape, (what, name, g.shape, w.shape)
            rel = float(np.abs(g - w).max() / np.abs(w).max())
            assert rel <= rtol, (what, name, rel)

    want = maybe_jit(jax_trunk.apply)(jv, jx)
    with torch.no_grad():
        compare(model.eval()(t(x).permute(0, 3, 1, 2)), want, eval_rtol, "eval")
    want, upd = maybe_jit(lambda v, im: jax_trunk_train.apply(v, im, mutable=["batch_stats"]))(
        jv, jx)
    with torch.no_grad():
        compare(model.train()(t(x).permute(0, 3, 1, 2)), want, train_rtol, "train")
    stats = state_dict_from_flax({}, {"backbone": jax.tree.map(np.asarray, upd["batch_stats"])})
    own = model.state_dict()
    assert len(stats) == sum(k.endswith(("running_mean", "running_var")) for k in own)
    for k, w in stats.items():
        rel = float((own[k[len(BOTTOM_UP):]] - w).abs().max() / w.abs().max())
        assert rel <= train_rtol, (k, rel)
