"""Candidate-sharded filtered ranking (counterpart of
``rgcn_tpu/dist/evaluate.py``).

The graph is encoded once, unsharded, on rank 0 and its embeddings ``z``
are broadcast, so every rank ranks against the same bits (the kernels
sum in an order that may change from run to run). Each rank of the edge
group then scores its own ``ceil(N / K)`` candidate columns of every
query (:func:`make_sharded_rank_sweep`): the filter indices in its slice
set their scores to ``-inf``, the true triple's score (which lives in one
slice) is recovered with a MAX all-reduce, and the counts of scores above
it and tied with it are SUM all-reduced, so every rank returns the same
ranks as the single-device evaluation:
``#(score > true) + (#(score == true) - 1) // 2 + 1``.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from rgcn_tpu_torch.ops.collectives import reduce_sum
from rgcn_tpu_torch.train.evaluate import ranking_metrics

__all__ = ["evaluate_link_predictor_sharded", "make_sharded_rank_sweep", "ungrouped"]


@contextlib.contextmanager
def ungrouped(model):
    """``model``'s layers run as on one device inside the block (their
    ``group`` set to None), and get their groups back after it."""
    mods = [m for m in model.modules() if hasattr(m, "group")]
    saved = [m.group for m in mods]
    for m in mods:
        m.group = None
    try:
        yield model
    finally:
        for m, g in zip(mods, saved):
            m.group = g


def make_sharded_rank_sweep(method, mesh):
    """``sweep(z, batch, filt, tgt) -> ranks`` for one direction over this
    rank's candidate slice. ``method`` is ``model.score_heads`` or
    ``model.score_tails`` (``(batch, z, candidate_slice)`` -> scores of
    the slice's candidates); ``filt (B, L)`` holds the filtered
    candidates (pads ``N`` mask nothing), ``tgt (B,)`` the targets."""
    k, me, group = mesh.edge_size, mesh.edge_rank, mesh.group

    def sweep(z, batch, filt, tgt):
        n = z.shape[0]
        shard_n = -(-n // k)
        lo = me * shard_n
        z_pad = torch.cat([z, z.new_zeros((shard_n * k - n, z.shape[1]))])
        scores = method(batch, z_pad, candidate_slice=(lo, shard_n))
        gcol = lo + torch.arange(shard_n, device=z.device)
        scores = scores.masked_fill(gcol[None, :] >= n, float("-inf"))
        rows = torch.arange(batch.shape[0], device=z.device)[:, None]
        filt = filt.long()
        in_shard = (filt >= lo) & (filt < lo + shard_n)
        # out-of-slice filters land in an appended column that is dropped
        fl = torch.where(in_shard, filt - lo, shard_n)
        scores = torch.cat([scores, scores.new_zeros((scores.shape[0], 1))], dim=1)
        scores = scores.index_put((rows.expand_as(fl), fl),
                                  scores.new_tensor(float("-inf")))[:, :shard_n]
        tgt = tgt.long()
        t_ok = (tgt >= lo) & (tgt < lo + shard_n)
        t_loc = (tgt - lo).clamp(0, shard_n - 1)
        true_local = torch.where(t_ok, scores.gather(1, t_loc[:, None])[:, 0],
                                 scores.new_tensor(float("-inf")))
        true = reduce_sum(true_local, group, op=dist.ReduceOp.MAX)
        counts = torch.stack([(scores > true[:, None]).sum(1),
                              (scores == true[:, None]).sum(1)])
        raw, ties = reduce_sum(counts, group)
        return raw + torch.div(ties - 1, 2, rounding_mode="floor") + 1

    return sweep


def evaluate_link_predictor_sharded(model, eval_edges, test: np.ndarray, filters, mesh,
                                    batch_size: int = 512
                                    ) -> Tuple[float, Tuple[float, ...], np.ndarray]:
    """Filtered (``filters`` None: raw) MRR, Hits@{1,3,10} and the ranks,
    head ranks first, as :func:`~rgcn_tpu_torch.train.link_prediction.evaluate_link_predictor`
    returns them, on every rank. ``eval_edges``: the whole training graph
    on the rank's device (read on rank 0 only)."""
    dev = mesh.device
    n = model.node_embeddings.shape[0]
    width = model.scoring_function.relations.shape[1]
    with torch.no_grad():
        if mesh.rank == 0:
            with ungrouped(model):
                z = model.encode(eval_edges).contiguous()
        else:
            z = torch.empty((n, width), dtype=torch.float32, device=dev)
        dist.broadcast(z, src=0, group=mesh.decoder_group)
        test_t = torch.as_tensor(np.asarray(test, dtype=np.int64), device=dev)
        num_test = len(test)
        ranks = []
        for method, filt, col in (
            (model.score_heads, None if filters is None else filters.heads, 0),
            (model.score_tails, None if filters is None else filters.tails, 2),
        ):
            sweep = make_sharded_rank_sweep(method, mesh)
            filt = torch.as_tensor(
                np.full((num_test, 1), n, np.int32) if filt is None else filt,
                device=dev)
            parts = [sweep(z, test_t[lo:lo + batch_size], filt[lo:lo + batch_size],
                           test_t[lo:lo + batch_size, col])
                     for lo in range(0, num_test, batch_size)]
            ranks.append(torch.cat(parts).cpu().numpy())
    ranks = np.concatenate(ranks)
    mrr, hits = ranking_metrics(ranks)
    return mrr, hits, ranks
