"""Edge-sharded training steps (counterpart of ``rgcn_tpu/dist/train.py``).

One process per rank, each with a full copy of the parameters and the
optimizer state and its own shard of the graph's edges. A step:

* the model, built with the edge group (``build_nc_model(..., group=)``,
  ``build_lp_model(..., group=, decoder_group=)``), aggregates the
  rank's edges and all-reduces the partial sums inside each layer
  (:mod:`rgcn_tpu_torch.ops.collectives`), so the logits or the node
  embeddings come out replicated;
* node classification: the loss on the replicated logits, computed alike
  on every rank; link prediction: each rank scores its slice of the
  scoring batch, pad rows weighted 0, and the loss is the all-reduced sum
  of the slices' weighted partial losses over the whole batch's real row
  count;
* backward: the collectives' backward rules sum every per-shard gradient
  contribution, so every rank holds the same full gradient and no
  gradient all-reduce follows; the optimizer then steps alike on every
  rank, which keeps one model.

Not ported: the JAX ``make_sharded_lp_step``, which builds the subgraph
in-jit and draws ``jax.random`` negatives (the port builds every subgraph
on the host, as its single-device trainer does).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from rgcn_tpu_torch.ops.collectives import all_reduce, reduce_sum
from rgcn_tpu_torch.train.node_classification import nc_loss

__all__ = [
    "make_sharded_lp_step_hosted",
    "make_sharded_lp_step_hosted_structured",
    "make_sharded_nc_step",
    "pad_to_multiple",
    "sharded_lp_loss",
    "slice_batch",
]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _update(optimizer, loss_fn) -> torch.Tensor:
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_sharded_nc_step(model, optimizer, train_idx: torch.Tensor,
                         train_lbl: torch.Tensor, layer1_l2: float = 0.0,
                         embedding_l2: float = 0.0) -> Callable:
    """Full-batch NC step over this rank's edge shard: ``step(edges) ->
    loss`` (a replicated 0-d tensor). ``model`` is built with the edge
    group; ``edges`` is this rank's shard with its layouts
    (:func:`~rgcn_tpu_torch.dist.mesh.prepare_sharded_layouts` or
    :func:`~rgcn_tpu_torch.dist.mesh.prepare_sharded_pairs_host`) on the
    rank's device."""

    # the logits are replicated after each layer's all-reduce
    return lambda edges: _update(optimizer, lambda: nc_loss(
        model, edges, train_idx, train_lbl, layer1_l2, embedding_l2))


def slice_batch(batch, labels, n_shards: int, shard: int):
    """Rows ``[shard·B/n, (shard+1)·B/n)`` of an assembled ``(P(1 + ns),
    3)`` host batch padded to a multiple of ``n_shards`` with ``(0, 0, 0)``
    rows: ``(batch, labels, weights)``, weights 1 for real
    rows and 0 for pads (the split ``P(all_axes)`` makes of the JAX
    step's padded batch)."""
    import numpy as np

    real = batch.shape[0]
    b_k = pad_to_multiple(real, n_shards) // n_shards
    lo = shard * b_k
    rows = np.arange(lo, lo + b_k)
    keep = rows < real
    safe = np.where(keep, rows, 0)
    batch_k = np.where(keep[:, None], np.asarray(batch)[safe], 0)
    labels_k = np.where(keep, np.asarray(labels)[safe], 0).astype(np.float32)
    return batch_k, labels_k, keep.astype(np.float32)


def sharded_lp_loss(scores, penalty, labels, weights, total, l2: float, group):
    """The all-reduced loss of one rank's scoring slice: ``Σ bce·w /
    total + l2 · penalty`` summed over ``group`` (the penalty is already
    weighted by ``w / total``)."""
    bce = F.binary_cross_entropy_with_logits(scores, labels, reduction="none")
    local = torch.sum(bce * weights) / total + l2 * penalty
    return all_reduce(local, group)


def make_sharded_lp_step_hosted(model, optimizer, decoder_group,
                                decoder_l2_weight: float = 0.0) -> Callable:
    """LP step on an assembled, host-drawn scoring batch:
    ``step(edges, batch, labels, weights, self_masks=None) -> loss``, with
    this rank's edge shard (layouts and reverse,
    :func:`~rgcn_tpu_torch.dist.host.build_sharded_epoch_host`) and its
    slice of the batch (:func:`slice_batch`), on the rank's device. The
    real row count is the all-reduced sum of the weights."""

    def step(edges, batch, labels, weights, self_masks=None):
        total = reduce_sum(weights.sum(), decoder_group)

        def loss_fn():
            scores, penalty = model(edges, batch, self_masks,
                                    penalty_weights=weights, penalty_total=total)
            return sharded_lp_loss(scores, penalty, labels, weights, total,
                                   decoder_l2_weight, decoder_group)

        return _update(optimizer, loss_fn)

    return step


def make_sharded_lp_step_hosted_structured(model, optimizer, decoder_group,
                                           decoder_l2_weight: float = 0.0,
                                           want_penalty: bool = True) -> Callable:
    """LP step with the structured decoder over this rank's structured
    slice (:func:`~rgcn_tpu_torch.dist.host.build_sharded_structured_host`):
    ``step(edges, structured, self_masks=None) -> loss`` with ``structured
    = (positives, corrupt_head, corrupt_ent, labels, weights, layouts)``
    on the rank's device. Pad parents carry weight 0 in the loss and the
    penalty; ``total`` is the all-reduced real row count, as at
    ``rgcn_tpu/dist/train.py:368-413``."""

    def step(edges, structured, self_masks=None):
        pos, ch, ce, labels, w, lays = structured
        total = reduce_sum(w.sum(), decoder_group)
        pw = w / total if want_penalty else torch.zeros_like(w)

        def loss_fn():
            scores, penalty = model.structured_scores(edges, pos, ch, ce, pw, lays,
                                                      self_masks)
            return sharded_lp_loss(scores, penalty, labels, w, total,
                                   decoder_l2_weight, decoder_group)

        return _update(optimizer, loss_fn)

    return step

