"""Plain-PyTorch relational SpMM: the oracle paths.

Counterpart of ``rgcn_tpu/ops/spmm.py``: every weight layout computes

    out[d] = Σ_{e: dst_e = d} val_e · (X[src_e] @ W[rel_e])

over a relation-sorted, tile-padded EdgeSet, with the destination sum as
one ``index_add_`` into ``num_nodes + 1`` rows (the last swallows pads).
Layers take these paths when the EdgeSet has no destination layout.
"""

from __future__ import annotations

import torch

from rgcn_tpu_torch.ops.basis import full_f32_matmul

__all__ = [
    "aggregate_messages",
    "rel_spmm",
    "rel_spmm_block",
    "rel_spmm_featureless",
    "rel_spmm_featureless_basis",
]

# Cap (elements) on the gathered basis rows of the featureless basis
# contraction, as in the JAX package; above it, tile groups run one after
# another. Module-level so tests can lower it and reach the grouped branch.
_ELEM_BUDGET = 64_000_000


def aggregate_messages(
    messages: torch.Tensor, dst: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """Scatter-add per-edge messages ``(E, dout)`` into ``(N, dout)``;
    pad edges target row ``num_nodes``, which is sliced off."""
    out = messages.new_zeros((num_nodes + 1, messages.shape[-1]))
    out.index_add_(0, dst.long(), messages)
    return out[:num_nodes]


def rel_spmm(edges, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Dense-weight relational SpMM; ``weights (R, din, dout)`` covers the
    general relations only (the caller adds the self-loop densely)."""
    tile, n_tiles = edges.tile_size, edges.num_tiles
    xg = x[edges.src.long()].reshape(n_tiles, tile, x.shape[-1])
    msgs = torch.bmm(xg, weights[edges.tile_rel.long()])
    msgs = msgs.reshape(n_tiles * tile, -1) * edges.val[:, None]
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)


def rel_spmm_block(edges, x: torch.Tensor, blocks: torch.Tensor, *,
                   aggregate=None) -> torch.Tensor:
    """Block-diagonal-weight SpMM; ``blocks (R, B, din // B, dout // B)``
    covers the general relations. Messages are computed blockwise, one
    ``(B, ib) @ (B, ib, ob)`` product per edge, so the block-diagonal
    matrix never exists; ``aggregate(msgs, edges)`` overrides the
    destination sum (e.g. K1 over the EdgeSet's layout)."""
    tile, n_tiles = edges.tile_size, edges.num_tiles
    _, nb, ib, ob = blocks.shape
    xg = x[edges.src.long()].reshape(n_tiles, tile, nb, ib)
    msgs = torch.einsum("tnbi,tbio->tnbo", xg, blocks[edges.tile_rel.long()])
    msgs = msgs.reshape(n_tiles * tile, nb * ob) * edges.val[:, None]
    if aggregate is not None:
        return aggregate(msgs, edges)
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)


def rel_spmm_featureless(edges, weights: torch.Tensor, *, aggregate=None) -> torch.Tensor:
    """Featureless SpMM (one-hot identity features): the message of edge
    ``(src, rel)`` is row ``src`` of ``W[rel]``, a gather.

    ``weights (R, N, dout)``; ``aggregate(msgs, edges)`` overrides the
    destination sum (e.g. K1 over the EdgeSet's layout).
    """
    num_rels, n_rows, dout = weights.shape
    flat = weights.reshape(num_rels * n_rows, dout)
    idx = edges.rel.long() * n_rows + edges.src.long()
    msgs = flat[idx] * edges.val[:, None]
    if aggregate is not None:
        return aggregate(msgs, edges)
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)


def rel_spmm_featureless_basis(edges, bases: torch.Tensor, comps: torch.Tensor, *,
                               aggregate=None) -> torch.Tensor:
    """Featureless SpMM under basis decomposition, without expanding
    ``comps @ bases`` to ``(R, N, dout)``: the message of edge ``(src,
    rel)`` is ``Σ_b comps[rel, b] · bases[b, src]``, a contraction of the
    gathered basis rows per relation-uniform tile.

    ``bases (nb, N, dout)``, ``comps (R, nb)`` over the general relations
    (the self-loop term is the caller's). The gather table is node-major
    with the basis innermost, ``(N, dout, nb)``, so a group of ``g`` tiles
    contracts as one ``(g, tile·dout, nb) @ (g, nb, 1)`` product of the
    gathered rows as they lie, in full f32. While ``E_pad·nb·dout`` exceeds
    :data:`_ELEM_BUDGET`, tiles go in groups whose size divides the tile
    count (the JAX package's search), so the gathered rows of one group
    exist at a time. ``aggregate(msgs, edges)`` overrides the destination
    sum (e.g. K1 over the EdgeSet's layout).
    """
    tile, n_tiles = edges.tile_size, edges.num_tiles
    nb, n_rows, dout = bases.shape
    table = bases.permute(1, 2, 0).contiguous().view(n_rows, dout * nb)
    coef = comps[edges.tile_rel.long()][:, :, None]  # (n_tiles, nb, 1)
    group = n_tiles
    if n_tiles * tile * nb * dout > _ELEM_BUDGET:
        group = max(1, _ELEM_BUDGET // (tile * nb * dout))
        while n_tiles % group:
            group -= 1
    src = edges.src.long()
    msgs = torch.empty((n_tiles * tile, dout), dtype=bases.dtype, device=bases.device)
    with full_f32_matmul():
        for t0 in range(0, n_tiles, group):
            lo, hi = t0 * tile, (t0 + group) * tile
            rows = table.index_select(0, src[lo:hi]).view(group, tile * dout, nb)
            torch.bmm(rows, coef[t0:t0 + group], out=msgs[lo:hi].view(group, tile * dout, 1))
    msgs = msgs * edges.val[:, None]
    if aggregate is not None:
        return aggregate(msgs, edges)
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)
