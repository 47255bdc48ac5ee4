"""Relation-sorted, tile-padded edge structure (host builders).

Counterpart of ``rgcn_tpu/graph/structure.py``: edges are sorted by
``(relation, receiver)`` and each relation's segment is padded to a
multiple of ``tile_size`` so every tile has one relation (``tile_rel``).
``val[e] = 1 / deg_rel(dst)``; pads carry ``val == 0`` and
``dst == num_nodes``. Self-loops are not edges: layers add them densely.

The builders produce numpy arrays bit-equal to the JAX package's NumPy
builders; :func:`build_edge_set` and the destination layouts run in the
port's C++ builders unless called with ``prefer_native=False``, with the
same output. :meth:`EdgeSet.to` moves the whole structure (destination
layout, fused layout, merged pair layout, reversed edges, the
unique-(src, rel) pair index with its composed layouts) to a device once.

Snapshots of ``val``: ``merged``, ``fused``, ``reverse`` and the pair
layout's ``slot_val`` / ``grad_val`` copy the edge values when they are
built. An EdgeSet whose ``val`` changes goes through
:func:`reweight_edge_set`, which drops all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from rgcn_tpu_torch.device import arrays_to
from rgcn_tpu_torch.graph.augment import inverse_triples

__all__ = [
    "EdgeSet",
    "PairAggLayout",
    "SrcRelPairs",
    "auto_nc_row_block",
    "build_edge_set",
    "build_pair_agg",
    "build_pair_src_layout",
    "build_src_rel_pairs",
    "edge_normalization",
    "reweight_edge_set",
]


@dataclasses.dataclass(frozen=True)
class EdgeSet:
    """Relation-sorted, tile-padded general edges of an augmented graph.

    ``dst`` is the message receiver (the triple's subject), ``src`` the
    source (the object). Array fields are numpy after building and
    tensors after :meth:`to`.
    """

    src: object  # (E_pad,) int32
    dst: object  # (E_pad,) int32
    rel: object  # (E_pad,) int32
    val: object  # (E_pad,) float32
    tile_rel: object  # (E_pad // tile_size,) int32
    num_nodes: int
    num_rels: int  # general relations stored here (2R)
    tile_size: int
    num_edges: int  # real (non-pad) edge count
    # destination-sorted aggregation layout (ops.aggregate.DstLayout)
    layout: Optional[object] = None
    # transposed edges (src/dst swapped, same values), for the backward
    reverse: Optional["EdgeSet"] = None
    # fused relation-quantum layout (ops.fused.FusedLayout)
    fused: Optional[object] = None
    # coalesced-pair layout (graph.coalesce.MergedPairLayout) that the basis
    # ops prefer. It freezes a snapshot of `val` (and `fused` and `reverse`
    # carry copies of it too): an EdgeSet whose `val` changes must rebuild
    # or drop them, or the kernels compute with the old values.
    merged: Optional[object] = None
    # unique-(src, rel) pair index (SrcRelPairs) of the many-basis paths
    pairs: Optional["SrcRelPairs"] = None

    @property
    def num_tiles(self) -> int:
        return self.tile_rel.shape[0]

    def to(self, device) -> "EdgeSet":
        """The same structure with every array a tensor on ``device``."""
        return arrays_to(self, device)


@dataclasses.dataclass(frozen=True)
class PairAggLayout:
    """The pair fan-out composed with the destination layout.

    Forward: slot ``l`` of ``EdgeSet.layout`` reads pair ``slot_pair[l]``
    of the ``(U_pad, dout)`` pair-message table (``U_pad``, an appended
    zero row, for pad slots) scaled by the slot's edge value. Backward:
    ``d_m[u] = Σ_{l: slot_pair_l = u} v_l · g[slot_dst_l]`` is a second
    destination sum over ``grad_layout`` (slots grouped by pair, ``U_pad``
    segments), its rows gathered through ``grad_edge`` / ``grad_dst``
    (sentinels ``E_pad`` / ``num_nodes`` index appended zero rows).

    It freezes the composition with the build-time ``layout.perm``, and
    ``slot_val`` (``val_z[layout.perm]``) and ``grad_val``
    (``val_z[grad_edge]``) freeze ``val`` itself: an EdgeSet whose
    ``val`` changes must drop them (:func:`reweight_edge_set` does; the
    aggregation then gathers the live values through ``layout.perm`` and
    ``grad_edge``), and one whose ``layout`` or ``pairs`` changes must drop
    the whole layout.
    """

    slot_pair: object  # (L,) int32 in [0, U_pad]
    slot_dst: object  # (L,) int32 in [0, num_nodes]
    grad_layout: object  # DstLayout over slot_pair (U_pad segments)
    grad_edge: object  # (Lb,) int32 in [0, E_pad]
    grad_dst: object  # (Lb,) int32 in [0, num_nodes]
    slot_val: Optional[object] = None  # (L,) f32, a snapshot of val
    grad_val: Optional[object] = None  # (Lb,) f32, a snapshot of val


@dataclasses.dataclass(frozen=True)
class SrcRelPairs:
    """Unique ``(src, rel)`` pairs of an EdgeSet's real edges.

    A many-basis message depends only on ``(src, rel)``, so it is
    contracted once per pair and fanned out to the pair's edges.
    ``pair_src`` / ``pair_rel`` are padded to a multiple of the builder's
    ``pad_multiple`` by repeating pair 0; ``edge_pair`` maps every edge to
    its pair (pad edges to pair 0, with ``val == 0``). The index itself
    freezes only ``(src, rel)``; ``agg`` may freeze ``val`` too (see
    :class:`PairAggLayout`).
    """

    pair_src: object  # (U_pad,) int32
    pair_rel: object  # (U_pad,) int32
    edge_pair: object  # (E_pad,) int32
    num_pairs: int  # real unique pairs (<= U_pad)
    # the composed aggregation layout (PairAggLayout)
    agg: Optional[PairAggLayout] = None
    # pairs grouped by source: a DstLayout over pair_src with num_nodes
    # segments, so the wide gather's backward is one destination sum (K1);
    # pad pairs (pair_src 0) are included, their cotangents are zero
    src_layout: Optional[object] = None


def edge_normalization(rel: np.ndarray, dst: np.ndarray, num_nodes: int,
                       mask: Optional[np.ndarray] = None) -> np.ndarray:
    """``1 / deg`` per ``(rel, dst)`` group. With a ``mask``, masked-out
    edges get 0 and do not count toward their group's degree (edge
    dropout as a mask, normalised over the surviving edges)."""
    key = rel.astype(np.int64) * (num_nodes + 1) + dst.astype(np.int64)
    if mask is None:
        _, inv, deg = np.unique(key, return_inverse=True, return_counts=True)
        return (1.0 / deg[inv].astype(np.float32)).astype(np.float32)
    uniq, inv = np.unique(key, return_inverse=True)
    deg = np.zeros(uniq.shape[0], dtype=np.float32)
    np.add.at(deg, inv, mask.astype(np.float32))
    deg_e = deg[inv]
    return np.where(deg_e > 0, mask / np.maximum(deg_e, 1.0), 0.0).astype(np.float32)


def auto_nc_row_block(num_nodes: int, chunk: int = 256) -> int:
    """Aggregation-layout row block for static full-graph NC EdgeSets:
    escalate from 128 until the block count is <= 640 (capped at 2048)."""
    rb = 128
    while rb < 2048 and -(-num_nodes // rb) > 640:
        rb *= 2
    return rb


def build_src_rel_pairs(es: EdgeSet, pad_multiple: int = 1024,
                        order: str = "rel") -> SrcRelPairs:
    """Unique-(src, rel) index over an EdgeSet's real edges (numpy).

    ``order="rel"`` sorts the pairs by ``(rel, src)``, ``"src"`` by
    ``(src, rel)``. Pad edges (``dst == num_nodes``) map to pair 0; the
    pair axis is padded to a multiple of ``pad_multiple`` by repeating
    pair 0.
    """
    src, dst, rel = (np.asarray(a) for a in (es.src, es.dst, es.rel))
    real = dst < es.num_nodes
    if order == "src":
        key = src.astype(np.int64) * (es.num_rels + 1) + rel
    elif order == "rel":
        key = rel.astype(np.int64) * (es.num_nodes + 1) + src
    else:
        raise ValueError(f"unknown pair order {order!r}")
    uniq, inv = np.unique(key[real], return_inverse=True)
    num_pairs = int(uniq.shape[0])
    u_pad = max(pad_multiple, -(-num_pairs // pad_multiple) * pad_multiple)

    pair_src = np.zeros(u_pad, dtype=np.int64)
    pair_rel = np.zeros(u_pad, dtype=np.int64)
    if order == "src":
        pair_src[:num_pairs] = uniq // (es.num_rels + 1)
        pair_rel[:num_pairs] = uniq % (es.num_rels + 1)
    else:
        pair_src[:num_pairs] = uniq % (es.num_nodes + 1)
        pair_rel[:num_pairs] = uniq // (es.num_nodes + 1)
    edge_pair = np.zeros(src.shape[0], dtype=np.int64)
    edge_pair[real] = inv
    return SrcRelPairs(
        pair_src=pair_src.astype(np.int32),
        pair_rel=pair_rel.astype(np.int32),
        edge_pair=edge_pair.astype(np.int32),
        num_pairs=num_pairs,
    )


def build_pair_agg(es: EdgeSet, grad_pad_to: Optional[int] = None) -> PairAggLayout:
    """Compose an EdgeSet's pair fan-out with its destination layout
    (numpy; needs ``es.pairs`` and ``es.layout``). The layout's pad slots
    point at ``E_pad``, which composes to the pair sentinel ``U_pad`` and
    the destination sentinel ``num_nodes``. ``grad_pad_to`` pads the
    backward layout to a fixed slot count (one shape on every shard of an
    edge-sharded graph, :func:`rgcn_tpu_torch.dist.mesh.prepare_sharded_pairs_host`).
    """
    if es.pairs is None or es.layout is None:
        raise ValueError("build_pair_agg needs pairs and a dst layout")
    from rgcn_tpu_torch.ops.aggregate import build_dst_layout

    pi = es.pairs
    perm = np.asarray(es.layout.perm)
    e_pad = es.src.shape[0]
    u_pad = pi.pair_src.shape[0]
    edge_pair_z = np.concatenate([np.asarray(pi.edge_pair), [u_pad]]).astype(np.int64)
    dst_z = np.concatenate([np.asarray(es.dst), [es.num_nodes]]).astype(np.int64)
    slot_pair = edge_pair_z[perm].astype(np.int32)
    slot_dst = dst_z[perm].astype(np.int32)

    # slots grouped by pair; pad slots carry the U_pad sentinel and drop
    chunk = es.layout.chunk
    grad_layout = build_dst_layout(
        slot_pair, u_pad, row_block=auto_nc_row_block(u_pad, chunk=chunk),
        chunk=chunk, pad_to=grad_pad_to)
    perm_z = np.concatenate([perm, [e_pad]]).astype(np.int64)
    grad_edge = perm_z[np.asarray(grad_layout.perm)].astype(np.int32)
    grad_dst = dst_z[grad_edge].astype(np.int32)  # E_pad -> num_nodes
    val_z = np.concatenate([np.asarray(es.val, dtype=np.float32), [0.0]]).astype(np.float32)
    return PairAggLayout(
        slot_pair=slot_pair,
        slot_dst=slot_dst,
        grad_layout=grad_layout,
        grad_edge=grad_edge,
        grad_dst=grad_dst,
        slot_val=val_z[np.minimum(perm, e_pad)],
        grad_val=val_z[grad_edge],
    )


def build_pair_src_layout(es: EdgeSet, pad_to: Optional[int] = None):
    """Pairs grouped by source: a DstLayout over ``pair_src`` with
    ``num_nodes`` segments (numpy), for the wide gather's backward. Pad
    pairs (``pair_src == 0``) are included; their cotangents are zero.
    ``pad_to`` pads it to a fixed slot count (shard-uniform shapes)."""
    if es.pairs is None or es.layout is None:
        raise ValueError("build_pair_src_layout needs pairs and a layout")
    from rgcn_tpu_torch.ops.aggregate import build_dst_layout

    chunk = es.layout.chunk
    return build_dst_layout(
        np.asarray(es.pairs.pair_src), es.num_nodes,
        row_block=auto_nc_row_block(es.num_nodes, chunk=chunk), chunk=chunk,
        pad_to=pad_to)


def reweight_edge_set(es: EdgeSet, val) -> EdgeSet:
    """The EdgeSet with per-edge values ``val``, and every structure that
    froze the old ones dropped: ``merged``, ``fused``, ``reverse`` (it
    carries ``val[r_order]`` and its own fused layout) and the pair
    layout's ``slot_val`` / ``grad_val``. The destination layout, the pair
    index, the composed maps and ``src_layout`` freeze only the topology
    and stay; the composed aggregation then gathers the live values.
    Dropping ``reverse`` and ``fused`` takes away the dense SpMM's backward
    and its K2 route: rebuild with :func:`build_edge_set` for those."""
    pairs = es.pairs
    if pairs is not None and pairs.agg is not None:
        pairs = dataclasses.replace(pairs, agg=dataclasses.replace(
            pairs.agg, slot_val=None, grad_val=None))
    return dataclasses.replace(es, val=val, merged=None, pairs=pairs,
                               fused=None, reverse=None)


def build_edge_set(
    triples: np.ndarray,
    num_nodes: int,
    num_rels: int,
    tile_size: int = 128,
    with_dst_layout: bool = False,
    layout_row_block: Optional[int] = None,
    with_merged_layout: bool = False,
    with_pair_index: bool = False,
    with_pair_agg: bool = False,
    tile_multiple: int = 1,
    prefer_native: bool = True,
    add_inverses: bool = True,
    layout_chunk: Optional[int] = None,
) -> EdgeSet:
    """Preprocess raw ``(s, p, o)`` triples into a static :class:`EdgeSet`.

    ``triples`` holds the original graph (relations in ``[0, R)``); inverse
    edges (relation ``p + R``) are generated here unless ``add_inverses``
    is False (then the general relations are the ``R`` given, and the
    numpy path runs, as in JAX). ``layout_row_block`` and ``layout_chunk``
    set the destination layouts' geometry. ``with_dst_layout=True``
    attaches the destination layout (K1), the fused layout (K2) and the
    reversed edge set with its own layouts. ``with_merged_layout=True``
    attaches the coalesced-pair layout the basis ops prefer (K4), unless
    the general relations exceed ``MERGED_MAX_RELS`` (then it is skipped:
    the basis ops take the unmerged layout). ``with_pair_index=True``
    attaches the unique-(src, rel) pair index (:func:`build_src_rel_pairs`,
    order ``"rel"``), and with ``with_pair_agg=True`` (needs
    ``with_dst_layout``) also its composed aggregation layout and its
    pairs-by-source layout, as the JAX NC trainer builds them for more
    than 8 bases. ``tile_multiple`` rounds the tile count up to a multiple
    with pad tiles (of the last relation).

    The sort, normalisation and tiling, and the destination layouts, run
    in the port's C++ builders (:mod:`rgcn_tpu_torch.graph.native`,
    bit-identical); ``prefer_native=False`` runs them in numpy.
    """
    from rgcn_tpu_torch.graph.coalesce import MERGED_MAX_RELS, build_merged_layout
    from rgcn_tpu_torch.ops.fused import build_fused_layout

    triples = np.asarray(triples, dtype=np.int64)
    if triples.ndim != 2 or triples.shape[1] != 3:
        raise ValueError(f"triples must be (E, 3), got {triples.shape}")

    if prefer_native and add_inverses:
        from rgcn_tpu_torch.graph.native import build_edge_set_native

        es = build_edge_set_native(
            triples, num_nodes, num_rels, tile_size=tile_size,
            tile_multiple=tile_multiple, with_dst_layout=with_dst_layout,
            layout_row_block=layout_row_block, layout_chunk=layout_chunk)
    else:
        num_general = num_rels
        if add_inverses:
            triples = np.concatenate([triples, inverse_triples(triples, num_rels)],
                                     axis=0)
            num_general = 2 * num_rels

        dst = triples[:, 0]  # receiver = subject
        rel = triples[:, 1]
        src = triples[:, 2]  # source = object

        order = np.lexsort((dst, rel))
        src, dst, rel = src[order], dst[order], rel[order]

        val = edge_normalization(rel, dst, num_nodes)

        layout_kw = dict(tile_multiple=tile_multiple, prefer_native=False,
                         layout_chunk=layout_chunk)
        es = _assemble_edge_set(
            src, dst, rel, val, num_nodes, num_general, tile_size,
            with_dst_layout, layout_row_block, **layout_kw)
        if with_dst_layout:
            # transposed copy: swap src/dst, KEEP the forward normalization
            r_order = np.lexsort((src, rel))
            rev = _assemble_edge_set(
                dst[r_order], src[r_order], rel[r_order], val[r_order],
                num_nodes, num_general, tile_size, True, layout_row_block,
                **layout_kw)
            rev = dataclasses.replace(rev, fused=build_fused_layout(rev))
            es = dataclasses.replace(es, reverse=rev, fused=build_fused_layout(es))
    if with_pair_index:
        es = dataclasses.replace(es, pairs=build_src_rel_pairs(es))
        if with_pair_agg:
            if es.layout is None:
                raise ValueError("with_pair_agg requires with_dst_layout")
            es = dataclasses.replace(es, pairs=dataclasses.replace(
                es.pairs, agg=build_pair_agg(es)))
            es = dataclasses.replace(es, pairs=dataclasses.replace(
                es.pairs, src_layout=build_pair_src_layout(es)))
    if with_merged_layout and es.num_rels <= MERGED_MAX_RELS:
        es = dataclasses.replace(es, merged=build_merged_layout(
            es.dst, es.src, es.rel, es.val, es.num_nodes, es.num_rels))
    return es


def _assemble_edge_set(
    src: np.ndarray,
    dst: np.ndarray,
    rel: np.ndarray,
    val: np.ndarray,
    num_nodes: int,
    num_general: int,
    tile_size: int,
    with_dst_layout: bool = False,
    layout_row_block: Optional[int] = None,
    *,
    tile_multiple: int = 1,
    prefer_native: bool = True,
    layout_chunk: Optional[int] = None,
) -> EdgeSet:
    """Tile-pad pre-sorted (by relation) edge arrays into an EdgeSet."""
    counts = np.bincount(rel, minlength=num_general)
    padded = np.maximum(np.ceil(counts / tile_size).astype(np.int64), 0) * tile_size
    offsets = np.concatenate([[0], np.cumsum(padded)])[:-1]
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]

    e_pad = int(padded.sum())
    if e_pad == 0:
        e_pad = tile_size  # an empty graph still gets one masked tile
    if tile_multiple > 1:
        step = tile_size * tile_multiple
        e_pad = -(-e_pad // step) * step
    pos = offsets[rel] + (np.arange(rel.shape[0]) - starts[rel])

    def scatter(values, fill, dtype):
        out = np.full(e_pad, fill, dtype=dtype)
        out[pos] = values
        return out

    src_p = scatter(src, 0, np.int32)
    dst_p = scatter(dst, num_nodes, np.int32)  # pads target the dummy row
    val_p = scatter(val, 0.0, np.float32)

    n_tiles = e_pad // tile_size
    tile_starts = np.arange(n_tiles, dtype=np.int64) * tile_size
    cum_padded = np.cumsum(padded)
    tile_rel = np.searchsorted(cum_padded, tile_starts, side="right")
    tile_rel = np.minimum(tile_rel, max(num_general - 1, 0)).astype(np.int32)
    rel_p = np.repeat(tile_rel, tile_size).astype(np.int32)

    layout = None
    if with_dst_layout:
        from rgcn_tpu_torch.ops.aggregate import build_dst_layout

        kw = {k: v for k, v in (("row_block", layout_row_block),
                                ("chunk", layout_chunk)) if v is not None}
        layout = build_dst_layout(dst_p, num_nodes, prefer_native=prefer_native, **kw)

    return EdgeSet(
        src=src_p,
        dst=dst_p,
        rel=rel_p,
        val=val_p,
        tile_rel=tile_rel,
        num_nodes=int(num_nodes),
        num_rels=int(num_general),
        tile_size=int(tile_size),
        num_edges=int(src.shape[0]),
        layout=layout,
    )
