"""Two loop iterations of the port's training entry point against the JAX
package on the CPU: its train state and `make_train_step` fed by its loader,
against `engine.loop.do_train` from the same weights, priors, batches and
sampling noise (the JAX draws injected as tests/test_torch_train.py does):
every loss and metric of both iterations within rtol 1e-4."""
import os

import jax
import numpy as np
import torch

from omni3d_tpu.config.cfg import StaticCfg
from omni3d_tpu.data import build as jbuild
from omni3d_tpu.data import datasets as jds
from omni3d_tpu.engine import train as jtrain
from omni3d_tpu.models.rcnn3d import CubeRCNN as JaxCubeRCNN
from omni3d_tpu.solver.build import build_optimizer as jax_build_optimizer
from omni3d_tpu.utils import priors as jpriors
from omni3d_tpu_torch.data import datasets as tds
from omni3d_tpu_torch.engine import loop as tloop
from omni3d_tpu_torch.engine import train as ttrain
from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset, write_omni3d_stats
from omni3d_tpu_torch.utils import events as tevents
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax
from test_torch_loop import CATS, _metrics
from test_torch_train import TINY, jax_noise
from torch_port_helpers import pooled_shape, random_variables, small_cfgs


def test_two_loop_iterations_match_jax(tmp_path, monkeypatch):
    """Random weights give gradients far above the weights (the first
    update at TINY's LR moves the first convolution by ~1% of its largest
    weight), so step 0's update would carry the two packages' f32 gradient
    differences (up to ~10% of the update in deep DLA layers) into
    iteration 1's losses at ~1e-3: BASE_LR 1e-4 makes that update 100x
    smaller, and what it carries stays under 1e-4 (the solver's arithmetic
    is held by tests/test_torch_solver.py). The images fill their 128 x 128 batch: in
    zero padding, train-mode BN's one-pass variance (E[x^2] - E[x]^2, in
    both packages) cancels, and the two summation orders then differ by
    ~1e-3 in the features."""
    monkeypatch.setattr(tevents, "_make_tb_writer", lambda output_dir: None)
    data_root = str(tmp_path / "data")
    write_omni3d_stats(data_root)
    write_omni3d_dataset(data_root, "Square_train", 6, 64, 64, "ppm", seed=7, dataset_id=3,
                         objects=(1, 4), categories=CATS)
    over = {**TINY, "DATASETS.TRAIN": ("Square_train",),
            "DATASETS.CATEGORY_NAMES": list(CATS), "INPUT.MIN_SIZE_TRAIN": (128,),
            "INPUT.MAX_SIZE_TRAIN": 200, "SOLVER.IMS_PER_BATCH": 2, "SOLVER.BASE_LR": 1e-4,
            "DATALOADER.NUM_WORKERS": 0, "TPU.TRAIN_SIZE_BUCKETS": 1, "VIS_PERIOD": 0}
    jcfg, tcfg = small_cfgs(**over)
    seed, root = 3, os.path.join(data_root, "Omni3D")
    for lib, cfg, d in ((jds, jcfg, "jax_meta"), (tds, tcfg, "port_meta")):
        fs = lib.get_filter_settings_from_cfg(cfg)
        lib.simple_register("Square_train", fs, datasets_root_path=root)
        lib.register_and_store_model_metadata(str(tmp_path / d), fs,
                                              os.path.join(root, "stats.json"))
    api = jds.Omni3D([os.path.join(root, "Square_train.json")],
                     jds.get_filter_settings_from_cfg(jcfg))
    priors = jpriors.priors_to_params(jpriors.compute_priors(jcfg, api, sorted(CATS)), 5)
    records = jbuild.get_detection_dataset_dicts(["Square_train"])

    scfg = StaticCfg(jcfg)
    jm = JaxCubeRCNN(cfg=scfg, train_mode=True)
    variables = random_variables(jm, (64, 64), seed=4)
    params = dict(variables["params"], **priors)
    tx = jax_build_optimizer(jcfg)
    state = jtrain.TrainState(step=jax.numpy.zeros((), jax.numpy.int32), params=params,
                              batch_stats=variables["batch_stats"], opt_state=tx.init(params),
                              skipped=jax.numpy.zeros((), jax.numpy.int32),
                              recent_loss=-jax.numpy.ones((), jax.numpy.float32))
    step_fn = jtrain.make_train_step(scfg, jm, tx)
    loader = jbuild.build_detection_train_loader(jcfg, records=records, seed=seed)
    rng = jax.random.PRNGKey(seed + 100)
    want, noises = [], {}
    for s in range(2):
        batch = next(loader)
        B, H, W = batch["images"].shape[:3]
        R = sum(3 * (H // st) * (W // st) for st in (4, 8, 16, 32, 64))
        noises[s] = {k: torch.from_numpy(v) for k, v in jax_noise(
            jax.random.fold_in(rng, s), B, R, 32 + batch["gt_boxes"].shape[1]).items()}
        assert tuple(batch["hw"][0]) == (H, W) == (128, 128)
        state, logs = step_fn(state, batch, rng)
        want.append({k: float(v) for k, v in logs.items()})

    monkeypatch.setattr(tloop, "step_generator", lambda seed, step: step)
    monkeypatch.setattr(ttrain, "sampling_noise", lambda step, *a, **k: noises[step])
    sd = state_dict_from_flax(params, variables["batch_stats"], pooled_shape(tcfg))
    tcfg.DATASETS.TEST = ()
    ok, run = tloop.do_train(tcfg, str(tmp_path / "port"), max_steps=2,
                             records=records, priors={k: np.asarray(v) for k, v in priors.items()},
                             seed=seed, device="cpu",
                             init_variables_fn=lambda m: m.load_state_dict(sd, strict=True))
    assert ok and run.iterations == [0, 1]
    got = _metrics(tmp_path / "port")
    for w, g in zip(want, got):
        assert w["finite"] == g["finite"] == 1.0
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
