"""Arena checkpoints of the port (``repro_torch.ckpt``), the counterpart of
``repro.ckpt``: the same two on-disk formats, so a checkpoint written by
either package restores in the other."""
from .checkpoint import (
    CheckpointCorruptError,
    CheckpointManager,
    cleanup,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointCorruptError", "CheckpointManager", "cleanup",
           "latest_step", "restore_checkpoint", "save_checkpoint"]
