"""DistMult scoring ops: per-triple scores and dense candidate sweeps.

Counterpart of ``rgcn_tpu/ops/distmult.py``: ``score(s, p, o) = Σ_d
z[s]_d · r[p]_d · z[o]_d`` plus optional per-node subject/object and
per-relation biases. The candidate sweeps score all ``N`` entities of a
batch with one ``(B, d) @ (d, N)`` product. These are plain tensor ops, as
the JAX package computes them outside any Pallas kernel. A sweep's
``candidate_slice=(lo, width)`` scores only candidates ``[lo, lo +
width)`` (the queries still index the whole table): the building block of
the candidate-sharded evaluation (:mod:`rgcn_tpu_torch.dist.evaluate`).
"""

from __future__ import annotations

from typing import Optional

import torch

from rgcn_tpu_torch.ops.ordered import select_rows

__all__ = ["distmult_score", "score_head_candidates", "score_tail_candidates"]


def distmult_score(
    triples: torch.Tensor,
    nodes: torch.Tensor,
    relations: torch.Tensor,
    *,
    sbias: Optional[torch.Tensor] = None,
    pbias: Optional[torch.Tensor] = None,
    obias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scores ``(B,)`` of triples ``(B, 3)``. The rows are gathered with
    :func:`~rgcn_tpu_torch.ops.ordered.select_rows`: ``index_select``,
    whose gradient sums each table's rows by index in a fixed order
    (``index_select``'s own backward adds with atomics)."""
    s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
    scores = torch.sum(select_rows(nodes, s) * select_rows(relations, p)
                       * select_rows(nodes, o), dim=-1)
    if sbias is not None:
        scores = (scores + select_rows(sbias, s) + select_rows(pbias, p)
                  + select_rows(obias, o))
    return scores


def _candidates(nodes, bias, candidate_slice):
    """The candidate rows (and their bias) a sweep scores."""
    if candidate_slice is None:
        return nodes, bias
    lo, width = candidate_slice
    return nodes[lo:lo + width], None if bias is None else bias[lo:lo + width]


def score_head_candidates(
    batch: torch.Tensor,
    nodes: torch.Tensor,
    relations: torch.Tensor,
    *,
    sbias: Optional[torch.Tensor] = None,
    pbias: Optional[torch.Tensor] = None,
    obias: Optional[torch.Tensor] = None,
    candidate_slice=None,
) -> torch.Tensor:
    """``(B, N)`` scores of every entity as the head of ``(B, 3)`` triples
    (column 0 is ignored); ``(B, width)`` under ``candidate_slice``."""
    p, o = batch[:, 1], batch[:, 2]
    cand, cb = _candidates(nodes, sbias, candidate_slice)
    scores = (relations[p] * nodes[o]) @ cand.T
    if sbias is not None:
        scores = scores + cb[None, :] + (pbias[p] + obias[o])[:, None]
    return scores


def score_tail_candidates(
    batch: torch.Tensor,
    nodes: torch.Tensor,
    relations: torch.Tensor,
    *,
    sbias: Optional[torch.Tensor] = None,
    pbias: Optional[torch.Tensor] = None,
    obias: Optional[torch.Tensor] = None,
    candidate_slice=None,
) -> torch.Tensor:
    """``(B, N)`` scores of every entity as the tail of ``(B, 3)`` triples
    (column 2 is ignored); ``(B, width)`` under ``candidate_slice``."""
    s, p = batch[:, 0], batch[:, 1]
    cand, cb = _candidates(nodes, obias, candidate_slice)
    scores = (nodes[s] * relations[p]) @ cand.T
    if sbias is not None:
        scores = scores + cb[None, :] + (sbias[s] + pbias[p])[:, None]
    return scores
