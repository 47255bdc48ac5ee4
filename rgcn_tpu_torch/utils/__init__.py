"""Utilities: ``logging.ScalarLogger`` (metrics to stdout and JSONL) and
``checkpoint`` (save, find and restore training checkpoints)."""

from rgcn_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
