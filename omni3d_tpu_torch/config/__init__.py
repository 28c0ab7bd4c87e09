"""Config system (same surface as `omni3d_tpu.config`)."""
from .cfg import CfgNode, StaticCfg  # noqa: F401
from .defaults import get_cfg_defaults, get_default_cfg, validate_cfg  # noqa: F401
