"""Atomic checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.checkpoint import (latest_step, list_checkpoints,
                                               restore_checkpoint,
                                               save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_checkpoints"]
