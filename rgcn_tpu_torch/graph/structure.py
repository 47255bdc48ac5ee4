"""Relation-sorted, tile-padded edge structure (numpy builders).

Counterpart of ``rgcn_tpu/graph/structure.py``: edges are sorted by
``(relation, receiver)`` and each relation's segment is padded to a
multiple of ``tile_size`` so every tile has one relation (``tile_rel``).
``val[e] = 1 / deg_rel(dst)``; pads carry ``val == 0`` and
``dst == num_nodes``. Self-loops are not edges: layers add them densely.

The builders produce numpy arrays bit-equal to the JAX package's NumPy
builders. :meth:`EdgeSet.to` moves the whole structure (destination
layout, fused layout, merged pair layout, reversed edges) to a device once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from rgcn_tpu_torch.device import arrays_to
from rgcn_tpu_torch.graph.augment import inverse_triples

__all__ = [
    "EdgeSet",
    "auto_nc_row_block",
    "build_edge_set",
    "edge_normalization",
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

    @property
    def num_tiles(self) -> int:
        return self.tile_rel.shape[0]

    def to(self, device) -> "EdgeSet":
        """The same structure with every array a tensor on ``device``."""
        return arrays_to(self, device)


def edge_normalization(rel: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """``1 / deg`` per ``(rel, dst)`` group."""
    key = rel.astype(np.int64) * (num_nodes + 1) + dst.astype(np.int64)
    _, inv, deg = np.unique(key, return_inverse=True, return_counts=True)
    return (1.0 / deg[inv].astype(np.float32)).astype(np.float32)


def auto_nc_row_block(num_nodes: int, chunk: int = 256) -> int:
    """Aggregation-layout row block for static full-graph NC EdgeSets:
    escalate from 128 until the block count is <= 640 (capped at 2048)."""
    rb = 128
    while rb < 2048 and -(-num_nodes // rb) > 640:
        rb *= 2
    return rb


def build_edge_set(
    triples: np.ndarray,
    num_nodes: int,
    num_rels: int,
    tile_size: int = 128,
    with_dst_layout: bool = False,
    layout_row_block: Optional[int] = None,
    with_merged_layout: bool = False,
) -> EdgeSet:
    """Preprocess raw ``(s, p, o)`` triples into a static :class:`EdgeSet`.

    ``triples`` holds the original graph (relations in ``[0, R)``); inverse
    edges (relation ``p + R``) are generated here. ``with_dst_layout=True``
    attaches the destination layout (K1), the fused layout (K2) and the
    reversed edge set with its own layouts. ``with_merged_layout=True``
    attaches the coalesced-pair layout the basis ops prefer (K4), unless
    the general relations exceed ``MERGED_MAX_RELS`` (then it is skipped:
    the basis ops take the unmerged layout).
    """
    from rgcn_tpu_torch.graph.coalesce import MERGED_MAX_RELS, build_merged_layout
    from rgcn_tpu_torch.ops.fused import build_fused_layout

    triples = np.asarray(triples, dtype=np.int64)
    if triples.ndim != 2 or triples.shape[1] != 3:
        raise ValueError(f"triples must be (E, 3), got {triples.shape}")

    triples = np.concatenate([triples, inverse_triples(triples, num_rels)], axis=0)
    num_general = 2 * num_rels

    dst = triples[:, 0]  # receiver = subject
    rel = triples[:, 1]
    src = triples[:, 2]  # source = object

    order = np.lexsort((dst, rel))
    src, dst, rel = src[order], dst[order], rel[order]

    val = edge_normalization(rel, dst, num_nodes)

    es = _assemble_edge_set(
        src, dst, rel, val, num_nodes, num_general, tile_size,
        with_dst_layout, layout_row_block,
    )
    if with_dst_layout:
        # transposed copy: swap src/dst, KEEP the forward normalization
        r_order = np.lexsort((src, rel))
        rev = _assemble_edge_set(
            dst[r_order], src[r_order], rel[r_order], val[r_order],
            num_nodes, num_general, tile_size, True, layout_row_block,
        )
        rev = dataclasses.replace(rev, fused=build_fused_layout(rev))
        es = dataclasses.replace(es, reverse=rev, fused=build_fused_layout(es))
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
) -> EdgeSet:
    """Tile-pad pre-sorted (by relation) edge arrays into an EdgeSet."""
    counts = np.bincount(rel, minlength=num_general)
    padded = np.maximum(np.ceil(counts / tile_size).astype(np.int64), 0) * tile_size
    offsets = np.concatenate([[0], np.cumsum(padded)])[:-1]
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]

    e_pad = int(padded.sum())
    if e_pad == 0:
        e_pad = tile_size  # an empty graph still gets one masked tile
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

        kw = {} if layout_row_block is None else {"row_block": layout_row_block}
        layout = build_dst_layout(dst_p, num_nodes, **kw)

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
