"""Live frames: one camera frame at a time, one closed-loop client, each
frame's latency on the host clock (see `frames`)."""
from .frames import run  # noqa: F401
