"""Per-epoch training subgraphs built on the host (counterpart of the host
half of ``rgcn_tpu/graph/dynamic.py``).

Link-prediction training samples a fresh positive subgraph every epoch.
:func:`build_edge_set_dynamic_host` turns it into an :class:`EdgeSet` on
the host, bit-equal to the JAX package's builder of the same name, its
(relation, receiver) sorts and destination layouts in the port's C++
counting sorts (:mod:`rgcn_tpu_torch.graph.native`) as the JAX package
runs them, or in numpy with ``prefer_native=False``:

* inverse edges are generated here (relation ``p + R``), and an original
  edge and its inverse share one dropout fate;
* general edge dropout is a value mask: a dropped edge keeps its slot with
  ``val == 0`` and leaves the degree counts, so the normalisation is the
  one of the subsampled graph;
* the padded size is the static bound ``ceil((2B + 2R(T - 1)) / T) · T``
  (:func:`padded_size`), and the destination layouts are padded to their
  static totals, so every epoch's arrays have the same shapes.

:func:`attach_host_layouts` adds the forward destination layout
(:func:`static_layout`) and the reversed edges (:func:`reverse_edges`:
src/dst swapped, values kept, forward pads included with ``val == 0``)
with their own layout: the basis layer's dx runs K4 over that
reverse frame, the block layer's dx K3 then K1. Forward pads become reverse
edges into node 0 whose source is ``num_nodes``, one past the last row:
readers of the reverse frame clamp that index (JAX's gathers clamp it; its
weight is 0).

The JAX package's in-jit builder (``build_edge_set_dynamic``) exists for
XLA's traced static shapes and draws its dropout with ``jax.random``; the
port builds every subgraph here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from rgcn_tpu_torch.graph.structure import EdgeSet

__all__ = [
    "padded_size",
    "auto_layout_row_block",
    "build_edge_set_dynamic_host",
    "static_layout",
    "reverse_edges",
    "attach_host_layouts",
]


def padded_size(num_edges: int, num_general_rels: int, tile_size: int) -> int:
    """Static upper bound on the tile-padded edge count. (The JAX
    function's ``tile_multiple``, for edge-sharded graphs, waits for the
    multi-GPU port.)"""
    bound = num_edges + num_general_rels * (tile_size - 1)
    return ((bound + tile_size - 1) // tile_size) * tile_size


def auto_layout_row_block(num_nodes: int, num_edges: int, chunk: int = 256) -> int:
    """Row block of a (sub)graph's destination layout: every row block costs
    at least one chunk, so escalate from 128 while that floor exceeds 35% of
    the edges, up to 2048."""
    rb = 128
    while rb < 2048 and (-(-num_nodes // rb)) * chunk > 0.35 * max(num_edges, 1):
        rb *= 2
    return rb


def _lexsort_rel_dst(rel: np.ndarray, dst: np.ndarray, num_general: int,
                     num_nodes: int, prefer_native: bool = True) -> np.ndarray:
    """Edge order by ``(rel, dst)``, stable: the port's C++ counting sort
    over ``(num_general, num_nodes + 1)`` bins (``dst`` may hold the pad
    value ``num_nodes``), or with ``prefer_native=False`` ``np.lexsort``,
    which gives the same order."""
    if prefer_native:
        from rgcn_tpu_torch.graph.native import lexsort_rel_dst

        return lexsort_rel_dst(rel, dst, num_general, num_nodes + 1)
    return np.lexsort((dst, rel))


def _tile_pad(src, dst, rel, val, num_nodes: int, num_general: int,
              tile_size: int, e_pad: int):
    """Scatter ``(rel, dst)``-sorted edges into relation segments padded to
    whole tiles of ``e_pad`` slots; returns the padded src, dst, val, the
    per-slot relation and ``tile_rel``."""
    counts = np.bincount(rel, minlength=num_general)
    padded = ((counts + tile_size - 1) // tile_size) * tile_size
    cum_padded = np.cumsum(padded)
    offsets = cum_padded - padded
    starts = np.cumsum(counts) - counts
    pos = offsets[rel] + (np.arange(rel.shape[0]) - starts[rel])

    src_p = np.zeros(e_pad, dtype=np.int32)
    dst_p = np.full(e_pad, num_nodes, dtype=np.int32)
    val_p = np.zeros(e_pad, dtype=np.float32)
    src_p[pos] = src
    dst_p[pos] = dst
    val_p[pos] = val

    tile_starts = np.arange(e_pad // tile_size, dtype=np.int64) * tile_size
    tile_rel = np.searchsorted(cum_padded, tile_starts, side="right")
    tile_rel = np.minimum(tile_rel, num_general - 1).astype(np.int32)
    return src_p, dst_p, val_p, np.repeat(tile_rel, tile_size), tile_rel


def build_edge_set_dynamic_host(
    positives: np.ndarray,
    num_nodes: int,
    num_rels: int,
    tile_size: int = 128,
    *,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[np.random.Generator] = None,
    keep_mask: Optional[np.ndarray] = None,
    with_dst_layout: bool = False,
    row_block: int = 128,
    layout_chunk: int = 256,
    prefer_native: bool = True,
) -> EdgeSet:
    """EdgeSet of a sampled ``(B, 3)`` positive batch (relations in ``[0,
    R)``). ``keep_mask`` (per positive) overrides the dropout draw;
    otherwise ``dropout_rng`` draws keep with probability ``1 -
    dropout_rate``. ``with_dst_layout`` attaches the layouts and the
    reversed edges (:func:`attach_host_layouts`). The sorts and layouts
    run in the port's C++ builders; ``prefer_native=False`` runs them in
    numpy, with the same output."""
    positives = np.asarray(positives)
    bsz = positives.shape[0]
    num_general = 2 * num_rels
    e_raw = 2 * bsz
    e_pad = padded_size(e_raw, num_general, tile_size)

    s = positives[:, 0].astype(np.int32)
    p = positives[:, 1].astype(np.int32)
    o = positives[:, 2].astype(np.int32)
    dst = np.concatenate([s, o])
    src = np.concatenate([o, s])
    rel = np.concatenate([p, p + num_rels])

    if keep_mask is not None:
        keep = np.asarray(keep_mask, dtype=np.float32)
    elif dropout_rate > 0.0 and dropout_rng is not None:
        keep = (dropout_rng.random(bsz) < 1.0 - dropout_rate).astype(np.float32)
    else:
        keep = np.ones(bsz, dtype=np.float32)
    mask = np.concatenate([keep, keep])

    order = _lexsort_rel_dst(rel, dst, num_general, num_nodes, prefer_native)
    src, dst, rel, mask = src[order], dst[order], rel[order], mask[order]

    # 1 / (kept in-degree per (rel, dst)); dropped edges get 0
    key = rel.astype(np.int64) * (num_nodes + 1) + dst
    is_new = np.concatenate([[True], key[1:] != key[:-1]])
    seg = np.cumsum(is_new) - 1
    deg = np.zeros(e_raw, dtype=np.float64)
    np.add.at(deg, seg, mask)
    deg = deg[seg]
    val = np.where(deg > 0, mask / np.maximum(deg, 1.0), 0.0).astype(np.float32)

    src_p, dst_p, val_p, rel_p, tile_rel = _tile_pad(
        src, dst, rel, val, num_nodes, num_general, tile_size, e_pad)
    es = EdgeSet(
        src=src_p, dst=dst_p, rel=rel_p, val=val_p, tile_rel=tile_rel,
        num_nodes=int(num_nodes), num_rels=int(num_general),
        tile_size=int(tile_size), num_edges=int(e_raw),
    )
    if not with_dst_layout:
        return es
    return attach_host_layouts(es, row_block=row_block, layout_chunk=layout_chunk,
                               prefer_native=prefer_native)


def static_layout(dst: np.ndarray, num_nodes: int, row_block: int, chunk: int,
                  prefer_native: bool = True):
    """Destination layout padded to ``nrb·chunk + ceil(E/chunk)·chunk``."""
    from rgcn_tpu_torch.ops.aggregate import build_dst_layout

    nrb = -(-num_nodes // row_block)
    total = nrb * chunk + -(-dst.shape[0] // chunk) * chunk
    return build_dst_layout(dst, num_nodes, row_block=row_block, chunk=chunk,
                            pad_to=total, prefer_native=prefer_native)


def reverse_edges(es: EdgeSet, prefer_native: bool = True) -> EdgeSet:
    """The reversed edges of a host-built subgraph, without layouts: src
    and dst swapped, the values kept, re-tiled by (relation, receiver) at
    the static size; the forward pads ride along with ``val == 0``."""
    num_nodes, num_general, tile = es.num_nodes, es.num_rels, es.tile_size
    src_p, dst_p = np.asarray(es.src), np.asarray(es.dst)
    rel_p, val_p = np.asarray(es.rel), np.asarray(es.val)
    r_order = _lexsort_rel_dst(rel_p, src_p, num_general, num_nodes, prefer_native)
    e_rev = padded_size(src_p.shape[0], num_general, tile)
    rsrc, rdst, rval, rrel, r_tile_rel = _tile_pad(
        dst_p[r_order], src_p[r_order], rel_p[r_order], val_p[r_order],
        num_nodes, num_general, tile, e_rev)
    return EdgeSet(
        src=rsrc, dst=rdst, rel=rrel, val=rval, tile_rel=r_tile_rel,
        num_nodes=int(num_nodes), num_rels=num_general, tile_size=int(tile),
        num_edges=es.num_edges)


def attach_host_layouts(es: EdgeSet, row_block: int = 128,
                        layout_chunk: int = 256,
                        prefer_native: bool = True) -> EdgeSet:
    """The EdgeSet with its destination layout and its reversed edges (with
    their own layout), all at static sizes."""
    rev = reverse_edges(es, prefer_native)
    rev = dataclasses.replace(rev, layout=static_layout(
        rev.dst, es.num_nodes, row_block, layout_chunk, prefer_native))
    return dataclasses.replace(
        es, layout=static_layout(np.asarray(es.dst), es.num_nodes, row_block,
                                 layout_chunk, prefer_native),
        reverse=rev)
