"""The port's solver (`omni3d_tpu_torch.solver.build`, torch.optim) vs the
JAX package's optax chain: two updates of SGD (momentum, nesterov), Adam
(+amsgrad) and AdamW from the same parameters and gradients, with the
norm / bias / rest groups, BIAS_LR_FACTOR and gradient clipping, and the
WarmupMultiStepLR schedule. Updates agree within 1e-5 of the largest
update of each tensor (float32 arithmetic in another order) plus two
float32 ulps of the largest parameter (the rounding of p - lr * u)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from omni3d_tpu.config.cfg import StaticCfg
from omni3d_tpu.solver import build as jsolver
from omni3d_tpu_torch.models import rcnn3d
from omni3d_tpu_torch.solver import build as tsolver
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax
from torch_port_helpers import jax_model, pooled_shape, random_variables, small_cfgs

SOLVERS = {
    "sgd": {"SOLVER.TYPE": "sgd"},
    "sgd_nesterov_clip_norm": {"SOLVER.TYPE": "sgd", "SOLVER.NESTEROV": True,
                               "SOLVER.CLIP_GRADIENTS.ENABLED": True,
                               "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": "norm",
                               "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 5.0},
    "adam_amsgrad_clip_value": {"SOLVER.TYPE": "adam+amsgrad",
                                "SOLVER.CLIP_GRADIENTS.ENABLED": True,
                                "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 0.5},
    "adamw": {"SOLVER.TYPE": "adamw"},
}
COMMON = {"SOLVER.BASE_LR": 0.05, "SOLVER.WARMUP_FACTOR": 1.0, "SOLVER.WARMUP_ITERS": 1,
          "SOLVER.WEIGHT_DECAY": 0.01, "SOLVER.WEIGHT_DECAY_NORM": 0.002,
          "SOLVER.WEIGHT_DECAY_BIAS": 0.005, "SOLVER.BIAS_LR_FACTOR": 2.0,
          "SOLVER.STEPS": (1,), "SOLVER.GAMMA": 0.5}


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = small_cfgs()
    return random_variables(jax_model(jcfg), (64, 64), seed=8)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_two_updates_match_optax(name, weights):
    jcfg, tcfg = small_cfgs(**COMMON, **SOLVERS[name])
    params = weights["params"]
    rng = np.random.default_rng(9)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(2)]
    for g in grads:   # the priors get no gradient (stopped in the JAX package)
        for k in g:
            if k.startswith("priors"):
                g[k] = np.zeros_like(g[k])

    tx = jsolver.build_optimizer(StaticCfg(jcfg))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)

    shape = pooled_shape(tcfg)
    model = rcnn3d.build_model(tcfg, device="cpu", train=True)
    model.load_state_dict(state_dict_from_flax(params, weights["batch_stats"], shape))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = tsolver.build_optimizer(tcfg, model)
    sched = tsolver.build_lr_schedule(tcfg, opt)
    assert {g["name"] for g in opt.param_groups} == {"norm", "bias", "rest"}
    named = dict(model.named_parameters())
    for g in grads:
        for k, v in state_dict_from_flax(g, None, shape).items():
            if k in named:
                named[k].grad = v.clone()
        tsolver.clip_gradients(tcfg, named.values())
        opt.step()
        sched.step()

    want = state_dict_from_flax(jax.tree.map(np.asarray, jp), None, shape)
    for k, p in named.items():
        d_got = (p.detach() - before[k]).numpy()
        d_want = want[k].numpy() - before[k].numpy()
        scale = np.abs(d_want).max()
        assert scale > 0, k
        ulp = np.finfo(np.float32).eps * np.abs(before[k].numpy()).max()
        assert np.abs(d_got - d_want).max() <= 1e-5 * scale + 2 * ulp, (k, name)
    for k, v in want.items():   # priors: buffers in the port, unchanged in both
        if k not in named:
            np.testing.assert_array_equal(v.numpy(), model.state_dict()[k].numpy())


def test_parameter_groups_follow_the_jax_classes():
    _, tcfg = small_cfgs(**COMMON)
    model = rcnn3d.build_model(tcfg, device="cpu", train=True)
    groups = {g["name"]: g for g in tsolver.param_groups(tcfg, model)}
    ids = {c: {id(p) for p in g["params"]} for c, g in groups.items()}
    named = dict(model.named_parameters())
    assert id(named["backbone.bottom_up.base_layer.1.bias"]) in ids["norm"]   # norm beats bias
    assert id(named["backbone.fpn_lateral2.bias"]) in ids["bias"]
    assert id(named["roi_heads.box_head.fc1.weight"]) in ids["rest"]
    assert (groups["bias"]["lr"], groups["bias"]["weight_decay"]) == (0.1, 0.005)
    assert groups["norm"]["weight_decay"] == 0.002 and groups["rest"]["weight_decay"] == 0.01
    assert sum(len(v) for v in ids.values()) == len(named)
    assert not any("priors" in k for k in named)


def test_lr_schedule_matches_jax():
    jcfg, tcfg = small_cfgs(**{"SOLVER.BASE_LR": 0.01, "SOLVER.WARMUP_ITERS": 10,
                               "SOLVER.STEPS": (100, 200)})
    sched = jsolver.build_lr_schedule(StaticCfg(jcfg))
    for step in (0, 3, 10, 99, 100, 150, 200, 250):
        assert 0.01 * tsolver.lr_factor(tcfg, step) == pytest.approx(float(sched(step)), rel=1e-6)
    model = rcnn3d.build_model(tcfg, device="cpu", train=True)
    opt = tsolver.build_optimizer(tcfg, model)
    lr_sched = tsolver.build_lr_schedule(tcfg, opt)
    for step in range(12):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(sched(step)), rel=1e-6)
        opt.step()
        lr_sched.step()
