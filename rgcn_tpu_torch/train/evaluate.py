"""Evaluation metrics (counterpart of ``rgcn_tpu/train/evaluate.py``):
node-classification accuracy and link-prediction ranking.

Ranking keeps the JAX package's semantics: head and tail prediction over
all ``N`` candidate entities; the filtered setting sets the scores of
known-true triples other than the target to ``-inf``; the rank is
optimistic with the half-tie correction ``#(score > true) + (#(score ==
true) - 1) // 2 + 1``. The graph is encoded once and each batch's
candidates are one ``(B, d) @ (d, N)`` product
(:func:`rgcn_tpu_torch.train.link_prediction.evaluate_link_predictor`).
The JAX package's ``scan_ranks`` and ``batched_eval_arrays`` (one scanned
XLA program over padded batches) have no counterpart: the port loops over
the batches eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

__all__ = [
    "RankingFilters",
    "accuracy",
    "build_filters",
    "generate_true_dict",
    "ranking_metrics",
    "ranks_from_scores",
]


def accuracy(pred: np.ndarray, labels: np.ndarray) -> float:
    """Classification accuracy in percent (sklearn ``accuracy_score`` × 100,
    as printed by ``experiments/classify_nodes.py:137-140``)."""
    return float(np.mean(np.asarray(pred) == np.asarray(labels)) * 100.0)


def generate_true_dict(all_triples):
    """``(p, o) -> [s]`` and ``(s, p) -> [o]`` maps over all true triples."""
    heads: Dict[Tuple[int, int], List[int]] = {}
    tails: Dict[Tuple[int, int], List[int]] = {}
    for s, p, o in all_triples:
        heads.setdefault((int(p), int(o)), []).append(int(s))
        tails.setdefault((int(s), int(p)), []).append(int(o))
    return heads, tails


@dataclass(frozen=True)
class RankingFilters:
    """Padded known-true indices per test triple; the pad value
    ``num_nodes`` is one past the last candidate and masks nothing."""

    heads: np.ndarray  # (T, Lh) int32: true heads s' != s of (·, p, o)
    tails: np.ndarray  # (T, Lt) int32: true tails o' != o of (s, p, ·)


def build_filters(test: np.ndarray, all_triples: Set[Tuple[int, int, int]],
                  num_nodes: int) -> RankingFilters:
    """The filtered setting's index matrices, by a sort of all true triples
    by each direction's key pair and one ``searchsorted`` range per test
    row (the same rows as the JAX builder's, in the same order)."""
    test = np.asarray(test, dtype=np.int64)
    tri = np.asarray(list(all_triples), dtype=np.int64)
    if tri.size == 0:
        tri = np.zeros((0, 3), dtype=np.int64)

    def direction(key_cols, val_col, test_keys, test_target):
        key = tri[:, key_cols[0]] * (num_nodes + 1) + tri[:, key_cols[1]]
        order = np.argsort(key, kind="stable")
        key_sorted, vals_sorted = key[order], tri[order, val_col]
        tk = test_keys[:, 0] * (num_nodes + 1) + test_keys[:, 1]
        lo = np.searchsorted(key_sorted, tk, side="left")
        hi = np.searchsorted(key_sorted, tk, side="right")
        lens = hi - lo
        width = max(int(lens.max(initial=0)), 1)
        row_of = np.repeat(np.arange(len(tk)), lens)
        pos_in_row = np.arange(int(lens.sum())) - (np.cumsum(lens) - lens)[row_of]
        vals = vals_sorted[lo[row_of] + pos_in_row]
        # the target itself is not filtered
        vals = np.where(vals == test_target[row_of], num_nodes, vals)
        out = np.full((len(tk), width), num_nodes, dtype=np.int32)
        out[row_of, pos_in_row] = vals
        return out

    return RankingFilters(
        heads=direction((1, 2), 0, test[:, 1:3], test[:, 0]),
        tails=direction((0, 1), 2, test[:, 0:2], test[:, 2]),
    )


def ranks_from_scores(scores: torch.Tensor, targets: torch.Tensor,
                      filters: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Filtered optimistic ranks with the half-tie correction of ``(B,
    N)`` candidate scores: ``filters (B, L)`` index candidates to set to
    ``-inf`` (``N`` pads and masks nothing), ``targets (B,)``. ``valid
    (B,)`` bool marks the real rows of a padded batch: the others rank 0,
    as in the JAX package's scanned evaluation."""
    bsz, n = scores.shape
    scores = torch.cat([scores, scores.new_zeros((bsz, 1))], dim=1)
    scores = scores.scatter(1, filters.long(), float("-inf"))[:, :n]
    true = scores.gather(1, targets.long()[:, None])
    raw = (scores > true).sum(1)
    ties = (scores == true).sum(1)
    ranks = raw + torch.div(ties - 1, 2, rounding_mode="floor") + 1
    return ranks if valid is None else torch.where(valid, ranks, 0)


def ranking_metrics(ranks: Sequence[int], hits_at_k: Iterable[int] = (1, 3, 10)
                    ) -> Tuple[float, Tuple[float, ...]]:
    ranks = np.asarray(ranks, dtype=np.float64)
    mrr = float(np.mean(1.0 / ranks))
    hits = tuple(float(np.mean(ranks <= k)) for k in hits_at_k)
    return mrr, hits
