"""Plain-PyTorch relational SpMM: the oracle paths.

Counterpart of ``rgcn_tpu/ops/spmm.py``: every weight layout computes

    out[d] = Σ_{e: dst_e = d} val_e · (X[src_e] @ W[rel_e])

over a relation-sorted, tile-padded EdgeSet, with the destination sum as
one ``index_add_`` into ``num_nodes + 1`` rows (the last swallows pads).
Layers take these paths when the EdgeSet has no destination layout.
"""

from __future__ import annotations

import torch

__all__ = ["aggregate_messages", "rel_spmm", "rel_spmm_block", "rel_spmm_featureless"]


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
