"""Atomic, verified checkpoints of the port's train state (the port of
``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpointing import (
    CheckpointCorruptError,
    CheckpointManager,
    checkpoint_steps,
    cleanup_stale_tmp,
    intact_step,
    latest_step,
    leaf_crc32s,
    quarantine_checkpoint,
    read_extras,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

__all__ = ["CheckpointCorruptError", "CheckpointManager", "checkpoint_steps",
           "cleanup_stale_tmp", "intact_step", "latest_step", "leaf_crc32s", "quarantine_checkpoint",
           "read_extras", "restore_checkpoint", "save_checkpoint", "verify_checkpoint"]
