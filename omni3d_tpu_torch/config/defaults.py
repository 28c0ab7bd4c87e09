"""Default config namespace, the same keys and values as
`omni3d_tpu.config.defaults` (the port reads the same YAML files).

Reproduces the public config surface the reference consumes: the detectron2
defaults it inherits (SURVEY §2.2; values from detectron2/config/defaults.py
as bound by configs/Base.yaml) plus every cubercnn-specific key
(reference cubercnn/config/config.py:4-159). Key names are preserved verbatim
so reference YAMLs and CLI `KEY VALUE` overrides work unchanged. A `TPU`
section adds the static-shape / sharding knobs that have no reference
equivalent (dynamic shapes are free on GPU, bounded on TPU).
"""
from .cfg import CfgNode as CN


def get_default_cfg() -> CN:
    cfg = CN()

    cfg.VERSION = 2
    cfg.OUTPUT_DIR = "./output"
    cfg.SEED = -1
    cfg.VIS_PERIOD = 0

    # ------------------------------ MODEL ------------------------------
    cfg.MODEL = CN()
    cfg.MODEL.META_ARCHITECTURE = "RCNN3D"
    cfg.MODEL.DEVICE = "tpu"
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.WEIGHTS_PRETRAIN = ""        # pretrain-only weights (config.py:158-159)
    cfg.MODEL.MASK_ON = False
    cfg.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]   # BGR means (Base.yaml:35)
    cfg.MODEL.PIXEL_STD = [57.375, 57.120, 58.395]
    cfg.MODEL.STABILIZE = 0.01             # loss-spike/NaN restart threshold (config.py:102)
    cfg.MODEL.USE_BN = True                # freeze BN when False (config.py:82)

    cfg.MODEL.BACKBONE = CN()
    cfg.MODEL.BACKBONE.NAME = "build_dla_from_vision_fpn_backbone"
    cfg.MODEL.BACKBONE.FREEZE_AT = 0

    cfg.MODEL.DLA = CN()
    cfg.MODEL.DLA.TYPE = "dla34"
    cfg.MODEL.DLA.TRICKS = False

    cfg.MODEL.RESNETS = CN()
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.RESNETS.TORCHVISION = True

    cfg.MODEL.FPN = CN()
    cfg.MODEL.FPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    cfg.MODEL.FPN.OUT_CHANNELS = 256
    cfg.MODEL.FPN.NORM = ""
    cfg.MODEL.FPN.FUSE_TYPE = "sum"

    cfg.MODEL.ANCHOR_GENERATOR = CN()
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    cfg.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    cfg.MODEL.PROPOSAL_GENERATOR = CN()
    cfg.MODEL.PROPOSAL_GENERATOR.NAME = "RPNWithIgnore"
    cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

    cfg.MODEL.RPN = CN()
    cfg.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
    cfg.MODEL.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    cfg.MODEL.RPN.IOU_THRESHOLDS = [0.05, 0.05]          # (Base.yaml:56)
    cfg.MODEL.RPN.IOU_LABELS = [0, -1, 1]
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    cfg.MODEL.RPN.POSITIVE_FRACTION = 1.0                # (Base.yaml:57)
    cfg.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    cfg.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
    cfg.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    cfg.MODEL.RPN.LOSS_WEIGHT = 1.0
    cfg.MODEL.RPN.BOUNDARY_THRESH = -1
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 2000              # per FPN level
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 1000
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 1000
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    cfg.MODEL.RPN.NMS_THRESH = 0.7
    cfg.MODEL.RPN.IGNORE_THRESHOLD = 0.5                 # (config.py:38)
    cfg.MODEL.RPN.OBJECTNESS_UNCERTAINTY = "IoUness"     # (config.py:151)

    cfg.MODEL.ROI_HEADS = CN()
    cfg.MODEL.ROI_HEADS.NAME = "ROIHeads3D"
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 50
    cfg.MODEL.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    cfg.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    cfg.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True

    cfg.MODEL.ROI_BOX_HEAD = CN()
    cfg.MODEL.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    cfg.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    cfg.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    cfg.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    cfg.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    cfg.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False

    # Cube head (reference config.py:41-136)
    cfg.MODEL.ROI_CUBE_HEAD = CN()
    cfg.MODEL.ROI_CUBE_HEAD.NAME = "CubeHead"
    cfg.MODEL.ROI_CUBE_HEAD.POOLER_RESOLUTION = 7
    cfg.MODEL.ROI_CUBE_HEAD.POOLER_SAMPLING_RATIO = 0
    cfg.MODEL.ROI_CUBE_HEAD.POOLER_TYPE = "ROIAlignV2"
    cfg.MODEL.ROI_CUBE_HEAD.NUM_CONV = 0
    cfg.MODEL.ROI_CUBE_HEAD.CONV_DIM = 256
    cfg.MODEL.ROI_CUBE_HEAD.NUM_FC = 2
    cfg.MODEL.ROI_CUBE_HEAD.FC_DIM = 1024
    cfg.MODEL.ROI_CUBE_HEAD.Z_TYPE = "direct"       # direct|sigmoid|log|clusters
    cfg.MODEL.ROI_CUBE_HEAD.POSE_TYPE = "6d"        # 6d|euler|quaternion
    cfg.MODEL.ROI_CUBE_HEAD.INVERSE_Z_WEIGHT = False
    cfg.MODEL.ROI_CUBE_HEAD.VIRTUAL_DEPTH = True
    cfg.MODEL.ROI_CUBE_HEAD.VIRTUAL_FOCAL = 512.0
    cfg.MODEL.ROI_CUBE_HEAD.DISENTANGLED_LOSS = True
    cfg.MODEL.ROI_CUBE_HEAD.CLUSTER_BINS = 1
    cfg.MODEL.ROI_CUBE_HEAD.ALLOCENTRIC_POSE = True
    cfg.MODEL.ROI_CUBE_HEAD.CHAMFER_POSE = True
    cfg.MODEL.ROI_CUBE_HEAD.SHARED_FC = True
    cfg.MODEL.ROI_CUBE_HEAD.DIMS_PRIORS_ENABLED = True
    cfg.MODEL.ROI_CUBE_HEAD.DIMS_PRIORS_FUNC = "exp"   # exp|sigmoid
    cfg.MODEL.ROI_CUBE_HEAD.USE_CONFIDENCE = 1.0
    cfg.MODEL.ROI_CUBE_HEAD.LOSS_W_3D = 1.0
    cfg.MODEL.ROI_CUBE_HEAD.LOSS_W_XY = 1.0
    cfg.MODEL.ROI_CUBE_HEAD.LOSS_W_Z = 1.0
    cfg.MODEL.ROI_CUBE_HEAD.LOSS_W_DIMS = 1.0
    cfg.MODEL.ROI_CUBE_HEAD.LOSS_W_POSE = 1.0
    cfg.MODEL.ROI_CUBE_HEAD.LOSS_W_JOINT = 1.0
    cfg.MODEL.ROI_CUBE_HEAD.SCALE_ROI_BOXES = 0.0

    # ------------------------------ INPUT ------------------------------
    cfg.INPUT = CN()
    cfg.INPUT.MIN_SIZE_TRAIN = (256, 272, 288, 304, 320, 336, 352, 368, 384,
                                400, 416, 432, 448, 464, 480, 496, 512, 528,
                                544, 560, 576, 592, 608, 624, 640)
    cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    cfg.INPUT.MAX_SIZE_TRAIN = 4096
    cfg.INPUT.MIN_SIZE_TEST = 512
    cfg.INPUT.MAX_SIZE_TEST = 4096
    cfg.INPUT.RANDOM_FLIP = "horizontal"
    cfg.INPUT.FORMAT = "BGR"

    # ------------------------------ DATASETS ------------------------------
    cfg.DATASETS = CN()
    cfg.DATASETS.TRAIN = ()
    cfg.DATASETS.TEST = ()
    cfg.DATASETS.CATEGORY_NAMES = []
    cfg.DATASETS.IGNORE_NAMES = []
    cfg.DATASETS.TRUNCATION_THRES = 0.99
    cfg.DATASETS.VISIBILITY_THRES = 0.01
    cfg.DATASETS.MIN_HEIGHT_THRES = 0.00
    cfg.DATASETS.MAX_DEPTH = 1e8
    cfg.DATASETS.MODAL_2D_BOXES = False
    cfg.DATASETS.TRUNC_2D_BOXES = True

    # ------------------------------ DATALOADER ------------------------------
    cfg.DATALOADER = CN()
    cfg.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    cfg.DATALOADER.REPEAT_THRESHOLD = 0.0
    cfg.DATALOADER.BALANCE_DATASETS = False
    cfg.DATALOADER.NUM_WORKERS = 4
    cfg.DATALOADER.ASPECT_RATIO_GROUPING = True
    cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    # ------------------------------ SOLVER ------------------------------
    cfg.SOLVER = CN()
    cfg.SOLVER.TYPE = "sgd"                # sgd|adam|adam+amsgrad|adamw|adamw+amsgrad
    cfg.SOLVER.IMS_PER_BATCH = 32
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.NESTEROV = False
    cfg.SOLVER.WEIGHT_DECAY = 0.0001
    cfg.SOLVER.WEIGHT_DECAY_NORM = 0.0
    cfg.SOLVER.GAMMA = 0.1
    cfg.SOLVER.STEPS = (19200, 25600)
    cfg.SOLVER.MAX_ITER = 32000
    cfg.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    cfg.SOLVER.WARMUP_ITERS = 1000
    cfg.SOLVER.WARMUP_METHOD = "linear"
    cfg.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    cfg.SOLVER.CHECKPOINT_PERIOD = 5000
    cfg.SOLVER.BIAS_LR_FACTOR = 1.0
    cfg.SOLVER.WEIGHT_DECAY_BIAS = None
    cfg.SOLVER.CLIP_GRADIENTS = CN()
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = False
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    cfg.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0

    # ------------------------------ TEST ------------------------------
    cfg.TEST = CN()
    cfg.TEST.EVAL_PERIOD = 16000
    cfg.TEST.DETECTIONS_PER_IMAGE = 100
    cfg.TEST.VISIBILITY_THRES = 1 / 2.0
    cfg.TEST.TRUNCATION_THRES = 1 / 2.0

    # ------------------------------ TPU (new) ------------------------------
    # Static-shape and SPMD knobs with no reference equivalent.
    cfg.TPU = CN()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"      # conv/matmul activations
    cfg.TPU.PARAM_DTYPE = "float32"
    cfg.TPU.MAX_GT_BOXES = 128              # padded GT instances per image
    cfg.TPU.NMS_CANDIDATES = 1024           # padded candidate count for class-NMS
                                            # (final detections: TEST.DETECTIONS_PER_IMAGE)
    cfg.TPU.ROI_SAMPLING_RATIO = 0          # 0 = torchvision adaptive grid
                                            # (reference-exact); >0 = static S
    cfg.TPU.POOLER_EXACT_ROUTING = False    # True: pool with the XLA-gather
                                            # oracle (canonical detectron2
                                            # level routing, no level-bump
                                            # deviation; slower — parity runs)
    cfg.TPU.TRAIN_SIZE_BUCKETS = 8          # multi-scale train shapes bucketed
                                            # to N compiles; must exceed the
                                            # aspect-group count or every batch
                                            # pads to its group's max scale
    cfg.TPU.EVAL_BATCH_SIZE = 1             # eval images per step, grouped by
                                            # padded shape (1 = reference exact)
    cfg.TPU.MESH_DATA = -1                  # data-parallel mesh size (-1 = all devices)
    cfg.TPU.REMAT_BACKBONE = False          # jax.checkpoint the backbone in training
    cfg.TPU.IMAGENET_WEIGHTS_DIR = ""       # local ImageNet .pth dir (no-egress
                                            # stand-in for reference dla.py:300-309)

    return cfg


def get_cfg_defaults(cfg: CN | None = None) -> CN:
    """Reference-compatible entrypoint (cubercnn/config/config.py:4)."""
    base = get_default_cfg()
    if cfg is not None:
        base.merge_from_other(cfg)
    return base


# Keys kept for reference-YAML compatibility whose behavior is FIXED in this
# build: validate_cfg rejects unsupported values instead of silently ignoring
# them. Each entry: dotted key -> tuple of supported values.
FIXED_VALUE_KEYS = {
    "MODEL.META_ARCHITECTURE": ("RCNN3D",),
    "MODEL.MASK_ON": (False,),
    "MODEL.BACKBONE.FREEZE_AT": (0,),
    "MODEL.RESNETS.TORCHVISION": (True,),
    "MODEL.RPN.HEAD_NAME": ("StandardRPNHead",),
    "MODEL.RPN.IOU_LABELS": ([0, -1, 1],),
    "MODEL.RPN.BBOX_REG_LOSS_TYPE": ("smooth_l1",),
    "MODEL.RPN.SMOOTH_L1_BETA": (0.0,),
    "MODEL.RPN.BOUNDARY_THRESH": (-1,),
    "MODEL.ROI_HEADS.IOU_LABELS": ([0, 1],),
    "MODEL.ROI_BOX_HEAD.NUM_CONV": (0,),
    "MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE": ("smooth_l1",),
    "MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA": (0.0,),
    "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG": (False,),
    "MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES": (False,),
    # the poolers honor TPU.ROI_SAMPLING_RATIO (0 = adaptive, matching the
    # reference's fixed sampling_ratio=0 exactly; see ops/roi_align.py)
    "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO": (0,),
    "MODEL.ROI_CUBE_HEAD.NUM_CONV": (0,),
    "MODEL.ROI_CUBE_HEAD.POOLER_SAMPLING_RATIO": (0,),
    "MODEL.ROI_BOX_HEAD.POOLER_TYPE": ("ROIAlignV2",),
    "MODEL.ROI_CUBE_HEAD.POOLER_TYPE": ("ROIAlignV2",),
    "INPUT.MIN_SIZE_TRAIN_SAMPLING": ("choice",),
    "INPUT.FORMAT": ("BGR",),
    "SOLVER.WARMUP_METHOD": ("linear",),
    "SOLVER.LR_SCHEDULER_NAME": ("WarmupMultiStepLR",),
    "SOLVER.CLIP_GRADIENTS.NORM_TYPE": (2.0,),
    "TPU.PARAM_DTYPE": ("float32",),
}

# Purely informational keys (no behavior attached, in the reference either).
INFORMATIONAL_KEYS = (
    "VERSION",
    "MODEL.DEVICE",
    "MODEL.ROI_BOX_HEAD.CONV_DIM",   # only meaningful when NUM_CONV > 0
    "MODEL.ROI_CUBE_HEAD.CONV_DIM",
)


def validate_cfg(cfg: CN):
    """Reject config values this build does not implement (a config surface
    that silently ignores overrides is worse than an honest error)."""
    def get(key):
        node = cfg
        for part in key.split("."):
            node = getattr(node, part)
        return node

    for key, supported in FIXED_VALUE_KEYS.items():
        val = get(key)
        if isinstance(val, (list, tuple)):
            ok = any(list(val) == list(s) for s in supported)
        else:
            ok = val in supported
        if not ok:
            raise ValueError(
                f"config key {key}={val!r} is not supported by this build "
                f"(supported: {supported})"
            )
