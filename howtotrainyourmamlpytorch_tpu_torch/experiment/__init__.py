"""Checkpoints, the run folder's files and the experiment runner."""

from . import checkpoint, storage  # noqa: F401
from .runner import ExperimentRunner  # noqa: F401
