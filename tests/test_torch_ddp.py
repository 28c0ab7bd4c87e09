"""Data-parallel training and sharded evaluation of the port in two gloo
processes on the CPU, against the JAX package's shard_map step
(`make_train_step(mesh=make_mesh(2))` over two of the virtual CPU devices
that tests/conftest.py makes):

- one step on the same global batch (4 random 64 x 64 images, 2 per rank,
  as tests/test_torch_train.py holds one device's step), each rank on its
  half with the JAX draws of its images injected: every loss and metric
  rtol 1e-4, the BN
  running statistics rtol 1e-4 / atol 1e-5, each parameter's update within
  1e-3 of the largest update in its tensor (plus one float32 ULP of the
  tensor's largest weight, the rounding of the update into the weight), as
  tests/test_torch_train.py holds one device's step; both ranks bit-equal;
  each rank's step enters stage step.rank_means twice, after the backward
  (the logs' mean) and before the optimizer (the BN running statistics').
  The batch and weights are ones where each half's single-device gradients
  in the two packages already agree that closely: on most random batches
  at these random weights they differ by 1-30% of a tensor's largest in
  deep DLA layers (float32 differences amplified through train-mode BN),
  in one process as in two, and the JAX mesh step equals the mean of its
  halves' single-device gradients to 1e-6;
- a NaN image on one rank only: both ranks skip, nothing moves;
- two `do_train` iterations at world size 2 against the JAX package's two
  loaders (process 0 and 1 of 2) concatenated into the mesh step: every
  loss and metric rtol 1e-4, with tests/test_torch_loop_jax.py's settings
  (the dataset's seed is one where no sampled proposal sits at an IoU
  threshold: at seed 7 one proposal's label differs between the packages'
  float32 forwards at iteration 1, and BoxHead/loss_cls by 1e-3, with or
  without the first update); a resume at world size 2 repeats the
  unbroken run bit for bit;
- `--eval-only` through the CLI at world size 2 against world size 1: the
  same AP dicts and per-image predictions.
The ranks run in processes spawned by tests/torch_ddp_workers.py."""
import json
import os
import pickle
import subprocess
import sys
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_workers as workers
from omni3d_tpu.config.cfg import StaticCfg
from omni3d_tpu.data import build as jbuild
from omni3d_tpu.data import datasets as jds
from omni3d_tpu.engine import train as jtrain
from omni3d_tpu.models.rcnn3d import CubeRCNN as JaxCubeRCNN
from omni3d_tpu.parallel import make_mesh
from omni3d_tpu.solver.build import build_optimizer as jax_build_optimizer
from omni3d_tpu.utils import priors as jpriors
from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset, write_omni3d_stats
from omni3d_tpu_torch.utils.checkpoint import save_checkpoint, state_dict_from_flax
from test_torch_cli import _env
from test_torch_eval_loop import EVAL
from test_torch_loop import CATS, OPTS, ROOT, _argv, _metrics, write_loop_dataset
from test_torch_train import NUM_CLASSES, TINY, jax_noise
from test_train import synthetic_batch
from torch_port_helpers import SMALL, pooled_shape, random_variables, small_cfgs

WORLD = 2
SEED = 3
STRIDES = (4, 8, 16, 32, 64)
# tests/test_torch_loop_jax.py's settings at a global batch of 4 (2 per rank)
OVER = {**TINY, "DATASETS.TRAIN": ("Square_train",), "DATASETS.TEST": (),
        "DATASETS.CATEGORY_NAMES": list(CATS), "INPUT.MIN_SIZE_TRAIN": (128,),
        "INPUT.MAX_SIZE_TRAIN": 200, "SOLVER.IMS_PER_BATCH": 4, "SOLVER.BASE_LR": 1e-4,
        "SOLVER.CHECKPOINT_PERIOD": 1, "DATALOADER.NUM_WORKERS": 0,
        "TPU.TRAIN_SIZE_BUCKETS": 1, "VIS_PERIOD": 0}
STEP_AT = 10   # the single step runs past the warm-up, at BASE_LR


def _opts(over):
    """`KEY VALUE` strings for the workers' `cfg_from_opts`."""
    kv = {".".join(k): v for k, v in SMALL.items()}
    kv.update(over)
    return [x for k, v in kv.items() for x in (k, str(v))]


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _at_step(state, step):
    """`state` with its step count and the LR schedule's count at `step`."""
    opt = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.full_like(x, step) if getattr(p[-1], "name", None) == "count" else x,
        state.opt_state)
    return state.replace(step=jnp.asarray(step, jnp.int32), opt_state=opt)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX mesh step: two iterations from the two loaders' global
    batches (with the dataset's priors), and one step at STEP_AT on a random
    batch (with the random priors)."""
    tmp = tmp_path_factory.mktemp("ddp_jax")
    data_root = str(tmp / "data")
    write_omni3d_stats(data_root)
    write_omni3d_dataset(data_root, "Square_train", 6, 64, 64, "ppm", seed=12, dataset_id=3,
                         objects=(1, 4), categories=CATS)
    jcfg, tcfg = small_cfgs(**OVER)
    opts = _opts(OVER)
    assert workers.cfg_from_opts(opts) == tcfg
    root = os.path.join(data_root, "Omni3D")
    fs = jds.get_filter_settings_from_cfg(jcfg)
    jds.simple_register("Square_train", fs, datasets_root_path=root)
    jds.register_and_store_model_metadata(str(tmp / "jax_meta"), fs,
                                          os.path.join(root, "stats.json"))
    api = jds.Omni3D([os.path.join(root, "Square_train.json")], fs)
    priors = jpriors.priors_to_params(jpriors.compute_priors(jcfg, api, sorted(CATS)), 5)
    records = jbuild.get_detection_dataset_dicts(["Square_train"])

    scfg = StaticCfg(jcfg)
    jm = JaxCubeRCNN(cfg=scfg, train_mode=True)
    variables = random_variables(jm, (64, 64), seed=4)
    params = dict(variables["params"], **priors)
    tx = jax_build_optimizer(jcfg)

    def fresh(params):
        return jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=variables["batch_stats"], opt_state=tx.init(params),
                                 skipped=jnp.zeros((), jnp.int32),
                                 recent_loss=-jnp.ones((), jnp.float32))

    step_fn = jtrain.make_train_step(scfg, jm, tx, mesh=make_mesh(WORLD))
    loaders = [jbuild.build_detection_train_loader(jcfg, records=records, seed=SEED,
                                                   process_index=r, process_count=WORLD)
               for r in range(WORLD)]
    rng = jax.random.PRNGKey(SEED + 100)

    def noise(step, batch):
        B, H, W = batch["images"].shape[:3]
        b = B // WORLD
        R = sum(3 * (H // s) * (W // s) for s in STRIDES)
        return [{k: torch.from_numpy(v) for k, v in jax_noise(
            jax.random.fold_in(rng, step), b, R, 32 + batch["gt_boxes"].shape[1],
            img_offset=r * b).items()} for r in range(WORLD)]

    state, batches, logs, noises = fresh(params), [], [], {}
    for s in range(2):
        parts = [next(loader) for loader in loaders]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        assert batch["images"].shape[:3] == (4, 128, 128)
        noises[s] = noise(s, batch)
        state, out = step_fn(state, batch, rng)
        batches.append(batch)
        logs.append({k: float(v) for k, v in out.items()})
    rand = {k: np.asarray(v) for k, v in synthetic_batch(
        np.random.default_rng(13), B=4, num_classes=NUM_CLASSES).items()}
    step_state, step_logs = step_fn(_at_step(fresh(variables["params"]), STEP_AT), rand, rng)
    sd = state_dict_from_flax(params, variables["batch_stats"], pooled_shape(tcfg))
    return dict(
        opts=opts, sd=sd, records=records, priors={k: np.asarray(v) for k, v in priors.items()},
        logs=logs, noises=noises,
        step=dict(batch=rand, noise=noise(STEP_AT, rand),
                  sd=state_dict_from_flax(variables["params"], variables["batch_stats"],
                                          pooled_shape(tcfg)),
                  logs={k: float(v) for k, v in step_logs.items()},
                  bn=state_dict_from_flax({}, jax.tree.map(np.asarray, step_state.batch_stats)),
                  params=state_dict_from_flax(jax.tree.map(np.asarray, step_state.params), None,
                                              pooled_shape(tcfg))))


def _ranks(path):
    return [torch.load(os.path.join(path, f"rank{r}.pt")) for r in range(WORLD)]


def test_two_rank_step_matches_the_jax_mesh_step(jax_run, tmp_path):
    want = jax_run["step"]
    workers.spawn(workers.step_worker, WORLD, tmp_path, str(tmp_path), jax_run["opts"],
                  want["sd"], _torch(want["batch"]), want["noise"], STEP_AT)
    got, other = _ranks(tmp_path)
    for k, v in other["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["logs"]["finite"] == want["logs"]["finite"] == 1.0
    assert got["logs"]["lr"] == pytest.approx(want["logs"]["lr"], rel=1e-6)
    assert set(got["logs"]) == set(want["logs"])
    for k, v in want["logs"].items():
        np.testing.assert_allclose(got["logs"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert len(want["bn"]) > 0
    for k, v in want["bn"].items():
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    old, moved = want["sd"], 0
    for k, w in want["params"].items():
        base = old[k].double()
        u_want, u_got = w.double() - base, got["model"][k].double() - base
        tol = 1e-3 * float(u_want.abs().max()) + float(base.abs().max()) * 2.0 ** -23
        assert float((u_got - u_want).abs().max()) <= tol, k
        moved += bool(u_want.abs().max() > 0)
    assert moved > 100
    for r in (got, other):   # the accepted step's two means, each after its part of the step
        stages = r["stages"]
        assert stages.count("step.rank_means") == 2, stages
        assert (stages.index("step.backward") < stages.index("step.rank_means")
                < len(stages) - 1 - stages[::-1].index("step.rank_means")
                < stages.index("step.optimizer")), stages


def test_both_ranks_skip_when_one_rank_sees_nan(tmp_path):
    over = {**TINY, "DATASETS.TEST": ()}
    batch = _torch(synthetic_batch(np.random.default_rng(7), B=4, num_classes=NUM_CLASSES))
    workers.spawn(workers.nan_worker, WORLD, tmp_path, str(tmp_path), _opts(over), batch)
    ranks = _ranks(tmp_path)
    for r in ranks:
        before, after = r["before"], r["after"]
        assert before["logs"]["finite"] == 1.0 and after["logs"]["finite"] == 0.0
        assert (after["skipped"], after["step"]) == (1, 2)
        for k, v in before["model"].items():
            assert torch.equal(after["model"][k], v), k
        assert before["optimizer"].keys() == after["optimizer"].keys() and before["optimizer"]
        for i, s in before["optimizer"].items():
            assert torch.equal(after["optimizer"][i]["momentum_buffer"], s["momentum_buffer"])
    for k, v in ranks[0]["after"]["model"].items():
        assert torch.equal(ranks[1]["after"]["model"][k], v), k


def test_two_do_train_iterations_match_jax_and_resume_repeats_them(jax_run, tmp_path):
    args = (jax_run["opts"], jax_run["records"], jax_run["priors"], jax_run["sd"],
            jax_run["noises"])
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    workers.spawn(workers.train_worker, WORLD, tmp_path, str(straight), *args, [(2, False)])
    got = _metrics(straight)
    assert [r["iteration"] for r in got] == [0, 1]
    for w, g in zip(jax_run["logs"], got):
        assert w["finite"] == g["finite"] == 1.0
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k} at iteration {g['iteration']}")
    assert {p.name for p in straight.iterdir() if p.suffix == ".ckpt"} == {
        "model_recent.ckpt", "model_final.ckpt"}

    workers.spawn(workers.train_worker, WORLD, tmp_path, str(resumed), *args,
                  [(1, False), (2, True)])
    again = _metrics(resumed)
    assert [r["iteration"] for r in again] == [0, 1]
    for w, g in zip(got, again):
        assert {k: v for k, v in w.items() if not k.startswith("time/")} == {
            k: v for k, v in g.items() if not k.startswith("time/")}
    states = _ranks(straight) + _ranks(resumed)
    for s in states[1:]:
        for k, v in states[0].items():
            assert torch.equal(s[k], v), k


def test_eval_only_at_world_size_two_equals_world_size_one(tmp_path):
    """`--eval-only` through the CLI: one process, then two (gloo, a file
    store) on 3 + 2 test images at TPU.EVAL_BATCH_SIZE 1: the same AP
    dicts, and per image the same predictions (scores and boxes within
    1e-5)."""
    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.models.rcnn3d import build_model

    data_root = str(tmp_path / "data")
    write_loop_dataset(data_root)
    for name, n, fmt, seed in (("SUNRGBD_test", 3, "ppm", 5), ("KITTI_test", 2, "png", 6)):
        write_omni3d_dataset(data_root, name, n, 48, 64, fmt, seed=seed, dataset_id=1,
                             objects=(1, 4), categories=CATS)
    cfg = get_default_cfg()
    cfg.merge_from_list([x for k, v in OPTS.items() for x in (k, v)])
    ckpt = str(tmp_path / "weights.ckpt")
    save_checkpoint(ckpt, {"model": build_model(cfg, device="cpu", seed=1, train=True)
                           .state_dict()}, {"iteration": 7})
    opts = {"DATASETS.TEST": "('SUNRGBD_test', 'KITTI_test')",
            **{k: str(v) for k, v in EVAL.items()}, "INPUT.MIN_SIZE_TEST": "48",
            "TPU.EVAL_BATCH_SIZE": "1", "MODEL.ROI_HEADS.SCORE_THRESH_TEST": "0.0"}
    cmd = [sys.executable, "-m", "omni3d_tpu_torch.tools.train_net", "--eval-only",
           "--weights", ckpt]
    dist = ["--dist-init", "file://" + str(tmp_path / "store"), "--num-processes", "2"]
    argvs = [_argv(data_root, tmp_path / "w1", 1, **opts)] + [
        _argv(data_root, tmp_path / "w2", 1, *dist, "--process-id", str(r), **opts)
        for r in range(2)]
    logs = [tmp_path / f"run{i}.log" for i in range(3)]
    env, runs = _env(tmp_path), []
    for argv, log in zip(argvs, logs):
        with open(log, "w") as f:
            runs.append(subprocess.Popen(cmd + argv, cwd=ROOT, env=env, stdout=f,
                                         stderr=subprocess.STDOUT, text=True))
    try:
        codes = [p.wait(timeout=240) for p in runs]
    finally:
        for p in runs:
            p.kill()
    outs = [log.read_text() for log in logs]
    assert codes == [0, 0, 0], [out[-3000:] for out in outs]
    assert "Performance on Omni3D" in outs[0] and "Performance on Omni3D" in outs[1]
    assert "Performance on Omni3D" not in outs[2]   # rank 1 prints no tables
    results = {}
    for w in ("w1", "w2"):
        with open(tmp_path / w / "inference" / "iter_final" / "omni3d_results.json") as f:
            results[w] = json.load(f)
    assert set(results["w1"]) == set(results["w2"]) == {"SUNRGBD_test", "KITTI_test"}
    for name in results["w1"]:
        a, b = results["w1"][name], results["w2"][name]
        for k, v in a.items():
            if k.startswith(("AP", "AR")):
                assert b[k] == v or (np.isnan(v) and np.isnan(b[k])), (name, k)
        preds = {}
        for w in ("w1", "w2"):
            with open(tmp_path / w / "inference" / "iter_final" / name
                      / "instances_predictions.pkl", "rb") as f:
                by_image = defaultdict(list)
                for p in pickle.load(f):
                    by_image[p["image_id"]].append(p)
                preds[w] = by_image
        assert preds["w1"].keys() == preds["w2"].keys() and len(preds["w1"]) == (
            3 if name == "SUNRGBD_test" else 2)
        for image, ps in preds["w1"].items():
            qs = preds["w2"][image]
            assert len(ps) == len(qs) > 0
            for p, q in zip(ps, qs):
                assert p["category_id"] == q["category_id"]
                np.testing.assert_allclose(q["score"], p["score"], atol=1e-5)
                np.testing.assert_allclose(q["bbox"], p["bbox"], atol=1e-5)
