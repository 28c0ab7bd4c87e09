"""Train and evaluate Cube R-CNN with the PyTorch port (the JAX package's
tools/train_net.py, same flags).

    python -m omni3d_tpu_torch.tools.train_net --config-file configs/cubercnn_DLA34_FPN.yaml \
        --datasets-root datasets/Omni3D [--eval-only] [--resume] [--max-steps N] \
        [--weights PATH] [--profile-dir DIR] [--device cuda|cpu]
        [--dist-init HOST:PORT --num-processes N --process-id I] [KEY VALUE ...]

`--datasets-root` holds the Omni3D jsons (<name>.json for every name in
DATASETS.TRAIN and DATASETS.TEST) and stats.json; image paths in the jsons
are relative to its parent directory. Training computes the per-category
priors from the training annotations, writes category_meta.json to
OUTPUT_DIR and trains with checkpoints (model_recent.ckpt every
SOLVER.CHECKPOINT_PERIOD iterations, model_final.ckpt at the end),
metrics.json lines and the retry protocol; every TEST.EVAL_PERIOD
iterations it evaluates the model on DATASETS.TEST. Initial weights, in the
reference's precedence (tools/train_net.py:107-170 of the JAX package):
MODEL.WEIGHTS_PRETRAIN, then --weights / MODEL.WEIGHTS (a reference
.pth/.pkl, a `cubercnn://` path or a checkpoint of the port), then ImageNet
DLA weights found by `utils.model_zoo.find_imagenet_weights`.

`--eval-only` builds the inference model, loads --weights / MODEL.WEIGHTS
(the same three kinds of file) and evaluates it on DATASETS.TEST: AP2D /
AP3D per dataset and across them, with predictions and results under
OUTPUT_DIR/inference/iter_final/. Both run on the CUDA card unless
`--device cpu` is given.

Multi-process training and evaluation run one process per GPU, each started
with the same arguments and its own `--process-id` (0..N-1):
`--dist-init HOST:PORT` is rank 0's address (the JAX CLI's flag; a full
init URL such as `file:///shared/store` also works), `--num-processes` N.
Rank i runs on `cuda:(i % torch.cuda.device_count())` (or the CPU with
`--device cpu`, over gloo). Each rank loads SOLVER.IMS_PER_BATCH / N images
per step and the gradients are averaged (DistributedDataParallel);
TPU.MESH_DATA, when positive, must equal N. Rank 0 writes
category_meta.json, the checkpoints, metrics.json and the evaluation files;
evaluation shards each test split across the ranks and gathers the
predictions on every rank. The JAX package instead runs one process per
host over all of its devices.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..config import get_default_cfg, validate_cfg
from ..data import datasets as data_lib
from ..data.build import get_detection_dataset_dicts
from ..engine.loop import do_test, train_with_retries
from ..models.rcnn3d import build_model
from ..parallel import dist as dist_lib
from ..utils import checkpoint as ckpt_lib
from ..utils import model_zoo
from ..utils.priors import compute_priors, priors_to_params
from ..vis.logperf import print_ap_analysis_table, print_cross_dataset_table
from .synthetic import condition_pose_bias_


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="omni3d_tpu_torch training")
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true",
                   help="evaluate --weights / MODEL.WEIGHTS on DATASETS.TEST; no training")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-steps", type=int, default=None,
                   help="override SOLVER.MAX_ITER (smoke runs)")
    p.add_argument("--datasets-root", default=None,
                   help="root containing Omni3D/*.json (default ./datasets/Omni3D)")
    p.add_argument("--weights", default=None,
                   help="weights to start from or to evaluate: a checkpoint of the port or a "
                        "reference .pth/.pkl (cubercnn:// paths resolve in the local cache)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of training steps 10-14 here")
    p.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    p.add_argument("--dist-init", default=None,
                   help="multi-process: rank 0's HOST:PORT (or an init URL such as file://...)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides: KEY VALUE ...")
    args = p.parse_args(argv)
    if args.dist_init and (args.num_processes is None or args.process_id is None):
        p.error("--dist-init needs --num-processes and --process-id")
    return args


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


def load_weights(model, path: str, what: str = "weights") -> None:
    """Load full-model weights into `model` in place: a reference .pth/.pkl
    or `cubercnn://` path (detectron2 names; reference
    tools/train_net.py:80-104 of the JAX package) or a checkpoint of the
    port (its "model" state dict, priors included)."""
    if path.endswith((".pth", ".pkl")) or path.startswith(model_zoo.PREFIX):
        report = ckpt_lib.convert_reference_checkpoint(
            model_zoo.load_reference_weights(path), model)
        print(f"[weights] {what} from {path}: {report['loaded']} tensors"
              f" missing={len(report['missing'])} unused={len(report['unused'])}")
        return
    state, extra = ckpt_lib.load_checkpoint(path)
    model.load_state_dict(state["model"])
    print(f"[weights] {what} from checkpoint {path} (iteration {extra.get('iteration')})")


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

    def init_fn(model):
        if pretrain:
            load_weights(model, pretrain, "train init")
        if explicit:
            load_weights(model, explicit, "train init")
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
    """Train, or evaluate with --eval-only; returns the last training
    attempt's `engine.loop.TrainRun`, or `engine.loop.do_test`'s results.
    With --dist-init this process joins the process group first and leaves
    it at the end; a caller that already joined one (e.g. over gloo, for
    several ranks on one card) passes no --dist-init and its group is
    used."""
    args = parse_args(argv)
    device = args.device
    if args.dist_init:
        if device == "cuda" and torch.cuda.is_available():
            device = f"cuda:{args.process_id % torch.cuda.device_count()}"
        device = dist_lib.init_distributed(args.dist_init, args.num_processes,
                                           args.process_id, device)
        try:
            return _run(args, device)
        finally:
            torch.distributed.destroy_process_group()
    return _run(args, device)


def _run(args, device):
    cfg, filter_settings, root = setup(args)
    dist_lib.check_world(cfg)
    main_rank = dist_lib.process_index() == 0
    output_dir = cfg.OUTPUT_DIR
    os.makedirs(output_dir, exist_ok=True)

    # model category metadata (reference main:384): rank 0 writes it, the
    # others read it
    stats = os.path.join(root, "stats.json")
    if main_rank:
        data_lib.register_and_store_model_metadata(output_dir, filter_settings, stats)
    dist_lib.barrier()
    if not main_rank:
        data_lib.register_and_store_model_metadata(output_dir, filter_settings, stats)

    def evaluate(model, iteration):
        results = do_test(cfg, model, output_dir, iteration=iteration)
        if main_rank:
            print_ap_analysis_table({k: v for k, v in results.items() if k != "summary"})
        return results

    if args.eval_only:
        model = build_model(cfg, device=device, seed=max(cfg.SEED, 0))
        path = args.weights or cfg.MODEL.WEIGHTS
        if path:
            load_weights(model, path)
        else:
            print("[weights] no --weights or MODEL.WEIGHTS: evaluating seeded random weights")
        results = evaluate(model, "final")
        if results["summary"] and main_rank:
            print_cross_dataset_table(results["summary"])
        return results

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
        init_variables_fn=make_train_init_fn(args, cfg), device=device,
        eval_fn=evaluate if cfg.DATASETS.TEST else None,
    )
    if main_rank:
        print("[train] finished")
    return run


if __name__ == "__main__":
    main()
