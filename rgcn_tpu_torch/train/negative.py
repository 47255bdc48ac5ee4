"""Negative sampling on the host (counterpart of
``rgcn_tpu/train/negative.py::corrupt_batch_host``).

Each positive is repeated ``num_negatives`` times and corrupted on one
side: the head with probability ``head_prob``, else the tail, by a
uniformly drawn entity. The draws are numpy's, in the JAX function's
order (entities, then sides), so the same generator gives the same
negatives. The JAX package's ``jax.random`` versions (``corrupt_batch``,
``negative_structure``) serve its in-jit step only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["corrupt_batch_host"]


def corrupt_batch_host(rng: np.random.Generator, positives, num_nodes: int,
                       num_negatives: int, head_prob: float,
                       return_structure: bool = False,
                       structure_only: bool = False):
    """``(batch [positives; negatives] (P(1+ns), 3), labels)``; with
    ``return_structure`` also ``(corrupt_head (P·ns,) bool, corrupt_ent
    (P·ns,))``; ``structure_only`` returns just those two (the same
    draws)."""
    positives = np.asarray(positives)
    bsz = positives.shape[0]
    corruptions = rng.integers(0, num_nodes, bsz * num_negatives).astype(positives.dtype)
    corrupt_head = rng.random(bsz * num_negatives) < head_prob
    if structure_only:
        return corrupt_head, corruptions
    expanded = np.repeat(positives, num_negatives, axis=0)
    s = np.where(corrupt_head, corruptions, expanded[:, 0])
    o = np.where(corrupt_head, expanded[:, 2], corruptions)
    negatives = np.stack([s, expanded[:, 1], o], axis=1)
    batch = np.concatenate([positives, negatives], axis=0)
    labels = np.concatenate([np.ones(bsz, dtype=np.float32),
                             np.zeros(len(negatives), dtype=np.float32)])
    if return_structure:
        return batch, labels, corrupt_head, corruptions
    return batch, labels
