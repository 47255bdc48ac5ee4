"""Triple augmentation: inverse relations and self-loops (counterpart of
``rgcn_tpu/graph/augment.py``).

A knowledge graph with ``R`` relations is expanded so that

* each triple ``(s, p, o)`` gains an inverse ``(o, p + R, s)``,
* every node ``v`` gains a self-loop ``(v, 2R, v)``,
* self-loops come *last*, so positional edge dropout
  (:func:`rgcn_tpu_torch.graph.compat.drop_edges`) can address them.

Host-side numpy, as :mod:`rgcn_tpu_torch.graph.structure` takes its
triples; nothing here runs on the card.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "inverse_triples",
    "self_loop_triples",
    "augment_triples",
    "split_spo",
]


def split_spo(triples):
    """Split a ``(..., 3)`` triple array into (subject, predicate, object).

    Works on numpy arrays or torch tensors of any batch rank."""
    return triples[..., 0], triples[..., 1], triples[..., 2]


def inverse_triples(triples: np.ndarray, num_rels: int) -> np.ndarray:
    """Return the inverse triple ``(o, p + R, s)`` for each ``(s, p, o)``."""
    triples = np.asarray(triples)
    return np.stack(
        [triples[:, 2], triples[:, 1] + num_rels, triples[:, 0]], axis=1
    )


def self_loop_triples(num_nodes: int, num_rels: int) -> np.ndarray:
    """Return the int64 ``(v, 2R, v)`` self-loop triple for every node
    (no keep-mask: self-loop dropout is a mask applied at compute time)."""
    v = np.arange(num_nodes, dtype=np.int64)
    p = np.full(num_nodes, 2 * num_rels, dtype=np.int64)
    return np.stack([v, p, v], axis=1)


def augment_triples(
    triples: np.ndarray, num_nodes: int, num_rels: int
) -> np.ndarray:
    """Concatenate ``originals || inverses || self-loops`` as int64, the
    self-loops last."""
    triples = np.asarray(triples, dtype=np.int64)
    return np.concatenate(
        [
            triples,
            inverse_triples(triples, num_rels),
            self_loop_triples(num_nodes, num_rels),
        ],
        axis=0,
    )
