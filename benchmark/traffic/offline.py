"""Offline inference over an image set: batches of frames back to back,
one closed-loop client (see `frames`)."""
from .frames import run  # noqa: F401
