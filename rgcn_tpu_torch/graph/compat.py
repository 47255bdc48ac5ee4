"""Reference-compatible L1 primitives on tensors (counterpart of
``rgcn_tpu/graph/compat.py``), for tooling and golden tests.

The training and serving paths never materialise stacked adjacencies or
block-diagonal matrices (:mod:`rgcn_tpu_torch.graph.structure`,
:mod:`rgcn_tpu_torch.ops`), but the reference's L1 surface is part of its
behavioural contract:

* :func:`stack_matrices`: COO indices of the vertically or horizontally
  stacked typed adjacency;
* :func:`sum_sparse`: row (or, transposed, column) sums broadcast back to
  the nonzero entries, the divisor of degree normalisation;
* :func:`block_diag`: ``(..., B, i, o)`` block tensors expanded into dense
  block-diagonal matrices;
* :func:`drop_edges`: physical edge dropout, self-loops addressed by
  position in the ordering that
  :func:`rgcn_tpu_torch.graph.augment.augment_triples` produces.

Each takes CPU tensors or numpy arrays (host structures, as
:mod:`rgcn_tpu_torch.graph.structure` takes them) and returns CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["stack_matrices", "sum_sparse", "block_diag", "drop_edges"]


def stack_matrices(
    triples,
    num_nodes: int,
    num_rels: int,
    vertical_stacking: bool = True,
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """COO indices ``(nnz, 2)`` and the shape of the stacked typed adjacency.

    Vertical: entry at ``(p * N + s, o)`` in an ``(R·N, N)`` matrix.
    Horizontal: entry at ``(s, p * N + o)`` in an ``(N, R·N)`` matrix.
    """
    triples = torch.as_tensor(triples)
    n, r = num_nodes, num_rels
    s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
    if vertical_stacking:
        rows, cols = p * n + s, o
        size = (r * n, n)
    else:
        rows, cols = s, p * n + o
        size = (n, r * n)
    return torch.stack([rows, cols], dim=1), size


def sum_sparse(
    indices,
    values,
    size: Tuple[int, int],
    row_normalisation: bool = True,
) -> torch.Tensor:
    """For each nonzero entry, the sum of all values in its row
    (``row_normalisation=True``) or in its column (the transposed index
    order the reference reorders afterwards). Sums in f64, returns f32."""
    indices = torch.as_tensor(indices)
    values = torch.as_tensor(values).to(torch.float64)
    if not row_normalisation:
        indices = indices.flip(1)
        size = (size[1], size[0])
    rows = indices[:, 0].long()
    sums = torch.zeros(size[0], dtype=torch.float64).index_add_(0, rows, values)
    return sums[rows].to(torch.float32)


def block_diag(blocks) -> torch.Tensor:
    """Expand ``(..., B, i, o)`` into ``(..., B·i, B·o)`` block-diagonals."""
    blocks = torch.as_tensor(blocks)
    *lead, nb, bi, bo = blocks.shape
    out = blocks.new_zeros((*lead, nb * bi, nb * bo))
    for b in range(nb):
        out[..., b * bi:(b + 1) * bi, b * bo:(b + 1) * bo] = blocks[..., b, :, :]
    return out


def drop_edges(
    triples,
    num_nodes: int,
    general_dropout: float,
    self_loop_dropout: float,
    rng: np.random.Generator,
) -> torch.Tensor:
    """Physically remove edges (reference semantics; the self-loops are the
    last ``num_nodes`` rows: originals, inverses, then self-loops, as
    :func:`rgcn_tpu_torch.graph.augment.augment_triples` orders them).

    Keeps ``floor(keep_rate * count)`` rows of each group, chosen by
    ``rng.choice`` without replacement: general rows first, then
    self-loops, so a generator in the same state keeps the same rows as
    ``rgcn_tpu.graph.compat.drop_edges``.
    """
    triples = torch.as_tensor(triples)
    nt = len(triples) - num_nodes
    n_keep_general = int(np.floor((1.0 - general_dropout) * nt))
    n_keep_self = int(np.floor((1.0 - self_loop_dropout) * num_nodes))
    general = rng.choice(nt, n_keep_general, replace=False)
    self_loops = nt + rng.choice(num_nodes, n_keep_self, replace=False)
    return triples[torch.as_tensor(np.concatenate([general, self_loops]))]
