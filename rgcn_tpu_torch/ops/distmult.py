"""DistMult scoring ops: per-triple scores and dense candidate sweeps.

Counterpart of ``rgcn_tpu/ops/distmult.py``: ``score(s, p, o) = Σ_d
z[s]_d · r[p]_d · z[o]_d`` plus optional per-node subject/object and
per-relation biases. The candidate sweeps score all ``N`` entities of a
batch with one ``(B, d) @ (d, N)`` product. These are plain tensor ops, as
the JAX package computes them outside any Pallas kernel. The
``candidate_slice`` argument of the JAX sweeps (the sharded evaluation's
building block) comes with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional

import torch

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
    ``index_select``, whose backward is an ``index_add_``: advanced
    indexing's backward sorts the indices first, about 4× slower on an
    H100 for lp-WN18's 330,000 rows of 200."""
    s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
    scores = torch.sum(nodes.index_select(0, s) * relations.index_select(0, p)
                       * nodes.index_select(0, o), dim=-1)
    if sbias is not None:
        scores = (scores + sbias.index_select(0, s) + pbias.index_select(0, p)
                  + obias.index_select(0, o))
    return scores


def score_head_candidates(
    batch: torch.Tensor,
    nodes: torch.Tensor,
    relations: torch.Tensor,
    *,
    sbias: Optional[torch.Tensor] = None,
    pbias: Optional[torch.Tensor] = None,
    obias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(B, N)`` scores of every entity as the head of ``(B, 3)`` triples
    (column 0 is ignored)."""
    p, o = batch[:, 1], batch[:, 2]
    scores = (relations[p] * nodes[o]) @ nodes.T
    if sbias is not None:
        scores = scores + sbias[None, :] + (pbias[p] + obias[o])[:, None]
    return scores


def score_tail_candidates(
    batch: torch.Tensor,
    nodes: torch.Tensor,
    relations: torch.Tensor,
    *,
    sbias: Optional[torch.Tensor] = None,
    pbias: Optional[torch.Tensor] = None,
    obias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(B, N)`` scores of every entity as the tail of ``(B, 3)`` triples
    (column 2 is ignored)."""
    s, p = batch[:, 0], batch[:, 1]
    scores = (nodes[s] * relations[p]) @ nodes.T
    if sbias is not None:
        scores = scores + obias[None, :] + (sbias[s] + pbias[p])[:, None]
    return scores
