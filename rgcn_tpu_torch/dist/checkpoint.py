"""Checkpoint and resume of edge-sharded training (counterpart of
``rgcn_tpu/dist/checkpoint.py``).

Parameters and optimizer state are replicated: every rank holds the same
bits (the steps of :mod:`rgcn_tpu_torch.dist.train` keep them so). So
rank 0 alone writes the single-device checkpoint
(:func:`~rgcn_tpu_torch.utils.checkpoint.save_training_state`,
``step_{:08d}/state.pt``), a barrier follows, and every rank restores
from the same files. A job over several hosts needs the checkpoint
directory on a file system they all read.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from rgcn_tpu_torch.utils.checkpoint import restore_training_state, save_training_state

__all__ = ["restore_checkpoint_replicated", "save_checkpoint_replicated"]


def save_checkpoint_replicated(ckpt_dir: str, model, optimizer, step: int,
                               mesh) -> Optional[str]:
    """Rank 0 writes step ``step``; every rank waits for it. Returns the
    file on rank 0, None elsewhere."""
    path = save_training_state(ckpt_dir, model, optimizer, step) \
        if mesh.rank == 0 else None
    dist.barrier(group=mesh.decoder_group)
    return path


def restore_checkpoint_replicated(ckpt_dir: str, model, optimizer, mesh,
                                  step: Optional[int] = None) -> Optional[int]:
    """Every rank loads checkpoint ``step`` (default: the latest), if any,
    onto its device (after a barrier, so no rank reads while another still
    writes); returns its step or None."""
    dist.barrier(group=mesh.decoder_group)
    return restore_training_state(ckpt_dir, model, optimizer, mesh.device, step=step)
