"""Verified, atomically written checkpoints (``repro.checkpoint``'s counterpart)."""
from .checkpoint import (  # noqa: F401
    CheckpointCorruptionError,
    CheckpointManager,
    CheckpointTopologyError,
    latest_step,
    list_steps,
    restore_checkpoint,
    restore_latest_valid,
    save_checkpoint,
    verify_checkpoint,
)
