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

The same subgraph is also built on the device, from the positives'
tensor, by :func:`build_edge_set_dynamic` (counterpart of the JAX
package's in-jit builder, the trainer's ``host_graph_build=False`` path):
one stable sort of the int32 composite key ``rel·(N + 1) + dst``,
run-length degrees, the relation-bucket tile padding, its destination
layouts (:func:`build_dst_layout_dynamic`, chunk = the tile size, plain
destination order unless ``src`` is given) and its reverse
(:func:`_reverse_edge_set_dynamic`), optionally the fused layouts, all in
torch ops on that device at the same static shapes. It is bit-equal to
the JAX builder for the same keep mask. Its keep mask is drawn from an
explicit ``torch.Generator`` (``keep_mask`` overrides the draw), as is
:func:`self_loop_keep_mask`'s. The device builders wait for nothing on
the host: no op whose output size depends on the data, no copy to the
host; JAX's out-of-range ``.at[pos].set(..., mode="drop")`` is a write
into one spare slot past the end that is then sliced off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rgcn_tpu_torch.graph.structure import EdgeSet

__all__ = [
    "padded_size",
    "auto_layout_row_block",
    "build_edge_set_dynamic",
    "build_edge_set_dynamic_host",
    "build_dst_layout_dynamic",
    "draw_keep_mask",
    "self_loop_keep_mask",
    "static_layout",
    "reverse_edges",
    "attach_host_layouts",
]


def padded_size(num_edges: int, num_general_rels: int, tile_size: int,
                tile_multiple: int = 1) -> int:
    """Static upper bound on the tile-padded edge count, its tile count
    rounded up to a multiple of ``tile_multiple`` (the shard count of an
    edge-sharded subgraph)."""
    bound = num_edges + num_general_rels * (tile_size - 1)
    out = ((bound + tile_size - 1) // tile_size) * tile_size
    if tile_multiple > 1:
        step = tile_size * tile_multiple
        out = ((out + step - 1) // step) * step
    return out


def auto_layout_row_block(num_nodes: int, num_edges: int, chunk: int = 256,
                          max_row_block: int = 2048) -> int:
    """Row block of a (sub)graph's destination layout: every row block costs
    at least one chunk, so escalate from 128 while that floor exceeds 35% of
    the edges, up to ``max_row_block``."""
    rb = 128
    while rb < max_row_block and (-(-num_nodes // rb)) * chunk > 0.35 * max(num_edges, 1):
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
    tile_multiple: int = 1,
    with_dst_layout: bool = False,
    row_block: int = 128,
    layout_chunk: int = 256,
    prefer_native: bool = True,
) -> EdgeSet:
    """EdgeSet of a sampled ``(B, 3)`` positive batch (relations in ``[0,
    R)``). ``keep_mask`` (per positive) overrides the dropout draw;
    otherwise ``dropout_rng`` draws keep with probability ``1 -
    dropout_rate``. ``tile_multiple`` pads the tile count to a multiple
    of the shard count (:mod:`rgcn_tpu_torch.dist.host` splits it into
    equal tile ranges). ``with_dst_layout`` attaches the layouts and the
    reversed edges (:func:`attach_host_layouts`). The sorts and layouts
    run in the port's C++ builders; ``prefer_native=False`` runs them in
    numpy, with the same output."""
    positives = np.asarray(positives)
    bsz = positives.shape[0]
    num_general = 2 * num_rels
    e_raw = 2 * bsz
    e_pad = padded_size(e_raw, num_general, tile_size, tile_multiple)

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


# -- built on the device -------------------------------------------------------


def _check_sort_key_range(num_general_rels: int, num_nodes: int) -> None:
    """The (relation, receiver) sorts use the int32 key ``rel·(N + 1) +
    dst``: refuse graphs where it would overflow."""
    if num_general_rels * (num_nodes + 1) >= 2**31:
        raise ValueError(
            f"(rel, dst) sort key overflows int32: {num_general_rels} general "
            f"relations x {num_nodes} nodes")


def _scatter_drop(size: int, fill, pos: torch.Tensor, values: torch.Tensor,
                  dtype) -> torch.Tensor:
    """``full(size, fill).at[pos].set(values, mode="drop")`` for ``pos`` in
    ``[0, size]``: position ``size`` lands in a spare slot sliced off."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=values.device)
    return out.scatter_(0, pos, values.to(dtype))[:size]


def _segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=values.dtype, device=values.device).index_add_(
        0, seg, values)


def _bucket_positions(rel: torch.Tensor, num_general: int, tile: int):
    """Slot of each ``rel``-sorted edge in its relation's tile-padded
    bucket, and the buckets' inclusive padded ends."""
    n = rel.shape[0]
    counts = _segment_sum(torch.ones(n, dtype=torch.int64, device=rel.device),
                          rel, num_general)
    padded = (counts + tile - 1) // tile * tile
    cum_padded = torch.cumsum(padded, 0)
    starts = torch.cumsum(counts, 0) - counts
    pos = (cum_padded - padded)[rel] + (
        torch.arange(n, device=rel.device) - starts[rel])
    return pos, cum_padded


def _tile_rel(cum_padded: torch.Tensor, e_pad: int, tile: int, num_general: int):
    """``(tile_rel (T,), rel per slot (E_pad,))`` of tile-padded buckets."""
    n_tiles = e_pad // tile
    starts = torch.arange(n_tiles, device=cum_padded.device, dtype=torch.int64) * tile
    tile_rel = torch.searchsorted(cum_padded, starts, right=True).clamp_max(
        num_general - 1).to(torch.int32)
    return tile_rel, tile_rel[:, None].expand(n_tiles, tile).reshape(-1)


def draw_keep_mask(generator: torch.Generator, num_positives: int,
                   dropout_rate: float) -> torch.Tensor:
    """The general edge dropout's per-positive keep mask on the
    generator's device: ``uniform < 1 - dropout_rate`` as f32 0/1."""
    u = torch.rand(num_positives, generator=generator, device=generator.device)
    return (u < 1.0 - dropout_rate).to(torch.float32)


def self_loop_keep_mask(generator: Optional[torch.Generator], num_nodes: int,
                        keep_prob: float, device=None) -> torch.Tensor:
    """Per-node keep mask ``(N, 1)`` f32 of the structural self-loop
    dropout: ``uniform < keep_prob`` from ``generator`` on its device;
    ones without a generator or with ``keep_prob >= 1`` (on ``device``,
    default the CPU)."""
    if generator is None or keep_prob >= 1.0:
        return torch.ones((num_nodes, 1), device=device)
    u = torch.rand((num_nodes, 1), generator=generator, device=generator.device)
    return (u < keep_prob).to(torch.float32)


def build_edge_set_dynamic(
    positives: torch.Tensor,
    num_nodes: int,
    num_rels: int,
    tile_size: int = 128,
    *,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    keep_mask: Optional[torch.Tensor] = None,
    tile_multiple: int = 1,
    with_dst_layout: bool = False,
    with_fused_layout: bool = False,
    row_block: int = 128,
) -> EdgeSet:
    """The EdgeSet of a ``(B, 3)`` positive tensor, built on its device
    (relations in ``[0, R)``; ``2R`` general relations stored). The keep
    mask is ``keep_mask`` (per positive) if given, else drawn from
    ``generator`` (:func:`draw_keep_mask`) when ``dropout_rate > 0``, else
    ones; an inverse shares its original's fate. ``tile_multiple`` pads
    the tile count to a multiple of the shard count.
    ``with_dst_layout`` attaches the destination layout (chunk =
    ``tile_size``, row block ``row_block``) and the reversed edges with
    theirs; ``with_fused_layout`` also the fused layouts of both
    (quantum ``min(16, tile_size)``). Every shape depends on ``B``,
    ``R``, ``N`` and the sizes only."""
    dev = positives.device
    bsz = positives.shape[0]
    num_general = 2 * num_rels
    e_raw = 2 * bsz
    e_pad = padded_size(e_raw, num_general, tile_size, tile_multiple)

    p32 = positives.to(torch.int32)
    s, p, o = p32[:, 0], p32[:, 1], p32[:, 2]
    dst = torch.cat([s, o])
    src = torch.cat([o, s])
    rel = torch.cat([p, p + num_rels])
    if keep_mask is not None:
        keep = torch.as_tensor(keep_mask).to(device=dev, dtype=torch.float32)
    elif dropout_rate > 0.0 and generator is not None:
        keep = draw_keep_mask(generator, bsz, dropout_rate)
    else:
        keep = torch.ones(bsz, device=dev)
    mask = torch.cat([keep, keep])

    _check_sort_key_range(num_general, num_nodes)
    key, order = torch.sort(rel * (num_nodes + 1) + dst, stable=True)
    src, dst, rel, mask = src[order], dst[order], rel[order], mask[order]

    # 1 / (kept in-degree per (rel, dst)), a run-length count on the sorted keys
    is_new = torch.ones(e_raw, dtype=torch.int64, device=dev)
    is_new[1:] = (key[1:] != key[:-1]).to(torch.int64)
    seg = torch.cumsum(is_new, 0) - 1
    deg = _segment_sum(mask, seg, e_raw)[seg]
    val = torch.where(deg > 0, mask / deg.clamp_min(1.0), torch.zeros((), device=dev))

    rel_l = rel.to(torch.int64)
    pos, cum_padded = _bucket_positions(rel_l, num_general, tile_size)
    tile_rel, rel_p = _tile_rel(cum_padded, e_pad, tile_size, num_general)
    es = EdgeSet(
        src=torch.zeros(e_pad, dtype=torch.int32, device=dev).scatter_(0, pos, src),
        dst=torch.full((e_pad,), num_nodes, dtype=torch.int32, device=dev).scatter_(
            0, pos, dst),
        rel=rel_p, val=torch.zeros(e_pad, device=dev).scatter_(0, pos, val),
        tile_rel=tile_rel, num_nodes=int(num_nodes), num_rels=int(num_general),
        tile_size=int(tile_size), num_edges=int(e_raw),
    )
    if not with_dst_layout:
        return es
    layout = build_dst_layout_dynamic(es.dst, num_nodes, row_block, tile_size)
    rev = _reverse_edge_set_dynamic(es, row_block, tile_size)
    es = dataclasses.replace(es, layout=layout, reverse=rev)
    if with_fused_layout:
        from rgcn_tpu_torch.ops.fused import build_fused_layout_dynamic

        q = min(16, tile_size)
        es = dataclasses.replace(
            es, fused=build_fused_layout_dynamic(es, row_block, tile_size, q),
            reverse=dataclasses.replace(rev, fused=build_fused_layout_dynamic(
                rev, row_block, tile_size, q)))
    return es


def build_dst_layout_dynamic(dst: torch.Tensor, num_nodes: int,
                             row_block: int = 128, chunk: int = 256,
                             src: Optional[torch.Tensor] = None):
    """Destination layout of a padded per-edge ``dst`` tensor (pads
    ``num_nodes``), built on its device at the static total ``nrb·chunk +
    ceil(E/chunk)·chunk``: the :func:`static_layout` of the same ``dst``,
    bit for bit. With ``src`` (and an int32 key that fits) a row block's
    edges are ordered by source instead of by destination; K4 reads a
    block's slots in destination order and takes only the plain
    layout."""
    from rgcn_tpu_torch.ops.aggregate import DstLayout

    dev = dst.device
    e_pad = dst.shape[0]
    nrb = -(-num_nodes // row_block)
    total = nrb * chunk + -(-e_pad // chunk) * chunk
    n_chunks = total // chunk

    by_src = src is not None and (nrb + 1) * (num_nodes + 1) < 2**31
    if by_src:
        pad = dst >= num_nodes
        blk = torch.where(pad, nrb, torch.div(dst, row_block, rounding_mode="floor"))
        key = blk * (num_nodes + 1) + torch.where(pad, num_nodes, src)
        order = torch.sort(key.to(torch.int32), stable=True)[1]
    else:
        order = torch.sort(dst, stable=True)[1]  # pads (== num_nodes) sort last
    dst_sorted = dst[order].to(torch.int64)
    real = dst_sorted < num_nodes
    block_of = torch.div(dst_sorted, row_block, rounding_mode="floor").clamp_max(nrb - 1)

    counts = _segment_sum(real.to(torch.int64), block_of, nrb)
    padded = ((counts + chunk - 1) // chunk).clamp_min(1) * chunk
    cum_padded = torch.cumsum(padded, 0)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(e_pad, device=dev) - starts[block_of]
    pos = torch.where(real, (cum_padded - padded)[block_of] + rank, total)

    perm = _scatter_drop(total, e_pad, pos, order, torch.int32)
    local = _scatter_drop(total, row_block, pos, dst_sorted - block_of * row_block,
                          torch.int32)
    chunk_starts = torch.arange(n_chunks, device=dev, dtype=torch.int64) * chunk
    chunk_block = torch.searchsorted(cum_padded, chunk_starts, right=True).clamp_max(
        nrb - 1).to(torch.int32)
    return DstLayout(perm=perm, local_dst=local.reshape(n_chunks, chunk),
                     chunk_block=chunk_block, num_edges=int(e_pad),
                     num_row_blocks=int(nrb), row_block=int(row_block),
                     chunk=int(chunk), dst_sorted=not by_src)


def _reverse_edge_set_dynamic(es: EdgeSet, row_block: int, chunk: int) -> EdgeSet:
    """The reversed edges of a device-built EdgeSet with their layout: src
    and dst swapped, the values kept, re-tiled by (relation, receiver) at
    ``padded_size(E_pad, 2R, T)``; the forward pads ride along with ``val
    == 0`` (:func:`reverse_edges`, bit for bit)."""
    n, num_general, tile = es.num_nodes, es.num_rels, es.tile_size
    dev = es.src.device
    e_pad = es.src.shape[0]
    new_dst, new_src = es.src, es.dst
    _check_sort_key_range(num_general, n)
    order = torch.sort(es.rel * (n + 1) + new_dst, stable=True)[1]
    new_src, new_dst = new_src[order], new_dst[order]
    rel, val = es.rel[order].to(torch.int64), es.val[order]

    e_rev = padded_size(e_pad, num_general, tile)
    pos, cum_padded = _bucket_positions(rel, num_general, tile)
    tile_rel, rel_p = _tile_rel(cum_padded, e_rev, tile, num_general)
    dst_p = torch.full((e_rev,), n, dtype=torch.int32, device=dev).scatter_(
        0, pos, new_dst)
    return EdgeSet(
        src=torch.zeros(e_rev, dtype=torch.int32, device=dev).scatter_(0, pos, new_src),
        dst=dst_p, rel=rel_p,
        val=torch.zeros(e_rev, device=dev).scatter_(0, pos, val),
        tile_rel=tile_rel, num_nodes=n, num_rels=num_general, tile_size=tile,
        num_edges=es.num_edges,
        layout=build_dst_layout_dynamic(dst_p, n, row_block, chunk))
