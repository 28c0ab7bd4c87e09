"""Train Cube R-CNN with the PyTorch port (the training path of the JAX
package's tools/train_net.py, same flags).

    python -m omni3d_tpu_torch.tools.train_net --config-file configs/cubercnn_DLA34_FPN.yaml \
        --datasets-root datasets/Omni3D [--resume] [--max-steps N] [--weights PATH] \
        [--profile-dir DIR] [--device cuda|cpu] [KEY VALUE ...]

`--datasets-root` holds the Omni3D jsons (<name>.json for every name in
DATASETS.TRAIN) and stats.json; image paths in the jsons are relative to its
parent directory. It computes the per-category priors from the training
annotations, writes category_meta.json to OUTPUT_DIR and trains with
checkpoints (model_recent.ckpt every SOLVER.CHECKPOINT_PERIOD iterations,
model_final.ckpt at the end), metrics.json lines and the retry protocol.
Initial weights, in the reference's precedence (tools/train_net.py:107-170
of the JAX package): MODEL.WEIGHTS_PRETRAIN, then --weights / MODEL.WEIGHTS
(a reference .pth/.pkl, a `cubercnn://` path or a checkpoint of the port),
then ImageNet DLA weights found by `utils.model_zoo.find_imagenet_weights`.
Evaluation (`--eval-only`, TEST.EVAL_PERIOD) waits for ROADMAP item 11 and
multi-process training for item 9.
"""
from __future__ import annotations

import argparse
import os

from ..config import get_default_cfg, validate_cfg
from ..data import datasets as data_lib
from ..data.build import get_detection_dataset_dicts
from ..engine.loop import train_with_retries
from ..utils import checkpoint as ckpt_lib
from ..utils import model_zoo
from ..utils.priors import compute_priors, priors_to_params
from .synthetic import condition_pose_bias_


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="omni3d_tpu_torch training")
    p.add_argument("--config-file", required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-steps", type=int, default=None,
                   help="override SOLVER.MAX_ITER (smoke runs)")
    p.add_argument("--datasets-root", default=None,
                   help="root containing Omni3D/*.json (default ./datasets/Omni3D)")
    p.add_argument("--weights", default=None,
                   help="weights to start from: a checkpoint of the port or a reference "
                        ".pth/.pkl (cubercnn:// paths resolve in the local cache)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of training steps 10-14 here")
    p.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides: KEY VALUE ...")
    return p.parse_args(argv)


def setup(args):
    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    validate_cfg(cfg)
    filter_settings = data_lib.get_filter_settings_from_cfg(cfg)
    root = args.datasets_root or os.path.join("datasets", "Omni3D")
    for name in list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST):
        data_lib.simple_register(name, filter_settings, filter_empty=False,
                                 datasets_root_path=root)
    cfg.freeze()
    return cfg, filter_settings, root


def make_train_init_fn(args, cfg):
    """Training-path weight initialization, reference precedence:

      1. MODEL.WEIGHTS_PRETRAIN: full-model weights (reference
         train_net.py:139-142),
      2. --weights / MODEL.WEIGHTS: full-model weights (train_net.py:145),
      3. neither set: ImageNet backbone weights (reference dla.py:494), and
         the cube head's 6D pose bias at the identity rotation
         (`tools.synthetic.condition_pose_bias_`: with the zero bias, RoIs
         whose head features are all zero get a 6D pose of ~0 and gradients
         that blow up the first steps).

    Returns model -> None, loading in place.
    """
    explicit = args.weights or cfg.MODEL.WEIGHTS
    pretrain = cfg.MODEL.WEIGHTS_PRETRAIN

    def load_full(model, path):
        if path.endswith((".pth", ".pkl")) or path.startswith(model_zoo.PREFIX):
            report = ckpt_lib.convert_reference_checkpoint(
                model_zoo.load_reference_weights(path), model)
            print(f"[weights] train init from {path}: {report['loaded']} tensors"
                  f" missing={len(report['missing'])} unused={len(report['unused'])}")
            return
        state, _ = ckpt_lib.load_checkpoint(path)
        model.load_state_dict(state["model"])
        print(f"[weights] train init from checkpoint {path}")

    def init_fn(model):
        if pretrain:
            load_full(model, pretrain)
        if explicit:
            load_full(model, explicit)
        elif not pretrain:
            condition_pose_bias_(model)
            path = model_zoo.find_imagenet_weights(cfg)
            if path is None:
                print("[weights] no ImageNet weights found "
                      f"(TPU.IMAGENET_WEIGHTS_DIR={cfg.TPU.IMAGENET_WEIGHTS_DIR!r})"
                      " — training the backbone from scratch")
                return
            report = ckpt_lib.convert_imagenet_backbone(
                model_zoo.load_reference_weights(path), model, cfg.MODEL.BACKBONE.NAME)
            print(f"[weights] ImageNet backbone init from {path}: "
                  f"{report['loaded']} tensors missing={len(report['missing'])}"
                  f" unused={len(report['unused'])}")

    return init_fn


def main(argv=None):
    """Train; returns the last attempt's `engine.loop.TrainRun`."""
    args = parse_args(argv)
    cfg, filter_settings, root = setup(args)
    output_dir = cfg.OUTPUT_DIR
    os.makedirs(output_dir, exist_ok=True)

    # model category metadata (reference main:384)
    data_lib.register_and_store_model_metadata(output_dir, filter_settings,
                                               os.path.join(root, "stats.json"))

    # priors from the merged train annotations (reference main:380-424)
    train_jsons = [os.path.join(root, n + ".json") for n in cfg.DATASETS.TRAIN]
    api = data_lib.Omni3D(train_jsons, dict(filter_settings))
    thing_classes = data_lib.metadata("omni3d_model")["thing_classes"]
    priors = priors_to_params(compute_priors(cfg, api, thing_classes),
                              cfg.MODEL.ROI_HEADS.NUM_CLASSES,
                              cfg.MODEL.ROI_CUBE_HEAD.CLUSTER_BINS)
    records = get_detection_dataset_dicts(cfg.DATASETS.TRAIN,
                                          cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)
    run = train_with_retries(
        cfg, output_dir, resume=args.resume, max_steps=args.max_steps, records=records,
        priors=priors, profile_dir=args.profile_dir, seed=max(cfg.SEED, 0),
        init_variables_fn=make_train_init_fn(args, cfg), device=args.device,
    )
    print("[train] finished")
    return run


if __name__ == "__main__":
    main()
