"""Negative sampling (counterpart of ``rgcn_tpu/train/negative.py``).

Each positive is repeated ``num_negatives`` times and corrupted on one
side: the head with probability ``head_prob``, else the tail, by a
uniformly drawn entity. No false-negative filtering.

Two forms draw the same process:

* on the host, :func:`corrupt_batch_host` with numpy, in the JAX
  function's order (entities, then sides), so the same generator gives
  the same negatives (the production step's draws);
* on the positives' device, :func:`negative_sampling`,
  :func:`negative_structure` and :func:`corrupt_batch` with an explicit
  ``torch.Generator`` (the JAX package's ``jax.random`` functions, the
  trainer's device-built epochs). Each is a draw step,
  :func:`draw_corruptions` (the entities ``(B·ns,)`` first, then the
  head coin ``(B·ns,)``), and an assemble step. Equal generators give
  bit-identical corruptions in every form, as JAX's key use promises;
  :func:`assemble_negatives` of JAX's own draws reproduces JAX's
  negatives bit for bit. The assemble steps copy nothing to the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "assemble_batch",
    "assemble_negatives",
    "batch_labels",
    "corrupt_batch",
    "corrupt_batch_host",
    "draw_corruptions",
    "negative_sampling",
    "negative_structure",
]


def draw_corruptions(generator: torch.Generator, positives: torch.Tensor,
                     num_nodes: int, num_negatives: int, head_prob: float):
    """``(corrupt_ent (B·ns,), corrupt_head (B·ns,) bool)`` drawn from
    ``generator`` on the positives' device: ``ns`` copies of each positive
    in order, entities uniform in ``[0, num_nodes)`` in the positives'
    dtype, then the head coins ``uniform < head_prob``."""
    if generator.device != positives.device:
        raise ValueError(f"a generator on {generator.device} for positives on "
                         f"{positives.device}: draw on the positives' device")
    n = positives.shape[0] * num_negatives
    dev = positives.device
    ent = torch.randint(0, num_nodes, (n,), generator=generator, device=dev,
                        dtype=positives.dtype)
    head = torch.rand(n, generator=generator, device=dev) < head_prob
    return ent, head


def assemble_negatives(positives: torch.Tensor, corrupt_ent: torch.Tensor,
                       corrupt_head: torch.Tensor) -> torch.Tensor:
    """``(B·ns, 3)`` negatives, parent-major: copy ``j`` of positive ``j
    // ns`` with its head (where ``corrupt_head``) or tail replaced by
    ``corrupt_ent``."""
    bsz = positives.shape[0]
    ns = corrupt_ent.shape[0] // bsz
    expanded = positives[:, None, :].expand(bsz, ns, 3).reshape(bsz * ns, 3)
    ent = corrupt_ent.to(positives.dtype)
    s = torch.where(corrupt_head, ent, expanded[:, 0])
    o = torch.where(corrupt_head, expanded[:, 2], ent)
    return torch.stack([s, expanded[:, 1], o], dim=1)


def batch_labels(num_positives: int, num_negatives: int, device) -> torch.Tensor:
    """f32 labels of ``[positives ; negatives]``: 1, then 0."""
    return torch.cat([torch.ones(num_positives, device=device),
                      torch.zeros(num_negatives, device=device)])


def assemble_batch(positives: torch.Tensor, negatives: torch.Tensor):
    """``([positives ; negatives], labels)``."""
    return torch.cat([positives, negatives]), batch_labels(
        positives.shape[0], negatives.shape[0], positives.device)


def negative_sampling(generator: torch.Generator, positives: torch.Tensor,
                      num_nodes: int, num_negatives: int,
                      head_prob: float) -> torch.Tensor:
    """``(B·ns, 3)`` corrupted triples of ``(B, 3)`` positives."""
    ent, head = draw_corruptions(generator, positives, num_nodes, num_negatives,
                                 head_prob)
    return assemble_negatives(positives, ent, head)


def negative_structure(generator: torch.Generator, positives: torch.Tensor,
                       num_nodes: int, num_negatives: int, head_prob: float):
    """The corruption structure of :func:`negative_sampling` without the
    triples: ``(corrupt_ent (B·ns,), corrupt_head (B·ns,) bool, labels
    (B + B·ns,))``, the same draws from an equal generator; the
    structured scorer's input."""
    ent, head = draw_corruptions(generator, positives, num_nodes, num_negatives,
                                 head_prob)
    return ent, head, batch_labels(positives.shape[0], ent.shape[0], positives.device)


def corrupt_batch(generator: torch.Generator, positives: torch.Tensor,
                  num_nodes: int, num_negatives: int, head_prob: float):
    """``([positives ; negatives] (B(1 + ns), 3), labels)``."""
    return assemble_batch(positives, negative_sampling(
        generator, positives, num_nodes, num_negatives, head_prob))


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
