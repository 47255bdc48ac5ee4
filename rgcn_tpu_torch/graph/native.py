"""ctypes bindings of the port's native graph builders (counterpart of
``rgcn_tpu/graph/native.py``).

The routines are the port's copies of the JAX package's C++ builders
(``rgcn_tpu_torch/native/csrc/{layout_builder,graph_builder}.cc``), built
with g++ at first use (:mod:`rgcn_tpu_torch.native`). Their outputs are
bit-identical to the numpy builders (``tests/test_torch_native.py``):

* :func:`lexsort_rel_dst`: ``np.lexsort((dst, rel))`` as a two-pass
  counting sort, O(E + bins);
* :func:`build_dst_layout_native`: ``ops/aggregate.py::build_dst_layout``
  as a stable counting sort by destination, O(E + N);
* :func:`build_edge_set_native`: ``graph/structure.py::build_edge_set``'s
  sort, normalisation and tiling, bucketed by relation and sorted per
  relation in parallel (OpenMP).

The numpy builders dispatch here unless called with ``prefer_native=False``.
Unlike the JAX package's bindings, these never return ``None`` for the
caller to fall back on: a library that does not build raises, and so does
an input outside a routine's contract. Each call adds one to its count in
:data:`rgcn_tpu_torch.native.CALLS`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np

from rgcn_tpu_torch import native

__all__ = ["lexsort_rel_dst", "build_dst_layout_native", "build_edge_set_native"]

_INT32_MAX = np.iinfo(np.int32).max


def _ptr(a: np.ndarray, ctype=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _int32(a, what: str) -> np.ndarray:
    """``a`` as a contiguous int32 array (the routines take int32 ids)."""
    a = np.asarray(a)
    if a.dtype != np.int32 and a.size and (a.min() < -_INT32_MAX or a.max() > _INT32_MAX):
        raise ValueError(f"{what}: values outside int32")
    return np.ascontiguousarray(a, dtype=np.int32)


def lexsort_rel_dst(rel: np.ndarray, dst: np.ndarray, num_rel_bins: int,
                    num_dst_bins: int) -> np.ndarray:
    """``np.lexsort((dst, rel))`` (int32; stable: ties keep their order)
    for ``rel`` in ``[0, num_rel_bins)`` and ``dst`` in ``[0,
    num_dst_bins)``; raises ``ValueError`` for a value outside its bins."""
    rel, dst = _int32(rel, "rel"), _int32(dst, "dst")
    if rel.shape != dst.shape or rel.ndim != 1:
        raise ValueError(f"rel {rel.shape} and dst {dst.shape}: one length each")
    order = np.empty(rel.shape[0], dtype=np.int32)
    rc = native.load("host_builders").rgcn_lexsort_rel_dst(
        _ptr(rel), _ptr(dst), rel.shape[0], int(num_rel_bins), int(num_dst_bins),
        _ptr(order))
    if rc != 0:
        raise ValueError(f"lexsort_rel_dst: a relation outside [0, {num_rel_bins}) "
                         f"or a destination outside [0, {num_dst_bins})")
    native.count("lexsort_rel_dst")
    return order


def build_dst_layout_native(dst: np.ndarray, num_nodes: int, row_block: int,
                            chunk: int, pad_to: Optional[int] = None):
    """:func:`rgcn_tpu_torch.ops.aggregate.build_dst_layout` by a stable
    counting sort by destination (pads ``dst >= num_nodes`` dropped)."""
    from rgcn_tpu_torch.ops.aggregate import DstLayout

    dst = _int32(dst, "dst")
    e = dst.shape[0]
    if e >= _INT32_MAX or num_nodes >= _INT32_MAX:
        raise ValueError(f"{e} edges, {num_nodes} nodes: past int32")
    nrb = -(-num_nodes // row_block)
    bad_pad = (f"pad_to={pad_to} < layout total or not a multiple of chunk "
               f"{chunk}")
    if pad_to is not None and pad_to <= 0:
        raise ValueError(bad_pad)
    # a given pad_to is the total; else every block padded one chunk past
    # its real edges bounds it
    cap = int(pad_to) if pad_to is not None else max(
        nrb * chunk + (-(-e // chunk) + nrb) * chunk, chunk)
    perm = np.empty(cap, dtype=np.int32)
    local = np.empty(cap, dtype=np.int32)
    chunk_block = np.empty(cap // chunk + 1, dtype=np.int32)
    total = native.load("host_builders").rgcn_build_dst_layout(
        _ptr(dst), e, num_nodes, row_block, chunk,
        0 if pad_to is None else int(pad_to),
        _ptr(perm), _ptr(local), _ptr(chunk_block), cap)
    if total == -2:
        raise ValueError(bad_pad)
    if total < 0:
        raise RuntimeError("native layout builder: capacity underestimated")
    native.count("build_dst_layout")
    n_chunks = total // chunk
    if total < cap:
        perm, local = perm[:total].copy(), local[:total].copy()
    return DstLayout(
        perm=perm,
        local_dst=local.reshape(n_chunks, chunk),
        chunk_block=chunk_block[:n_chunks].copy(),
        num_edges=int(e),
        num_row_blocks=int(nrb),
        row_block=int(row_block),
        chunk=int(chunk),
    )


def build_edge_set_native(triples: np.ndarray, num_nodes: int, num_rels: int,
                          tile_size: int = 128, tile_multiple: int = 1,
                          with_dst_layout: bool = False,
                          layout_row_block: Optional[int] = None,
                          layout_chunk: Optional[int] = None):
    """:func:`rgcn_tpu_torch.graph.structure.build_edge_set` (inverse
    edges added) through the native builder: the forward edge set, and
    with ``with_dst_layout`` its destination layout, the reversed edges
    with theirs and both fused layouts, as the numpy path attaches them.
    ``tile_multiple`` rounds the tile count up with pad tiles of relation
    ``2R - 1``, as the numpy path does (the JAX package's binding repeats
    the last real tile's relation, which differs when the last relation
    has no edge)."""
    from rgcn_tpu_torch.graph.structure import EdgeSet, _assemble_edge_set
    from rgcn_tpu_torch.ops.aggregate import build_dst_layout
    from rgcn_tpu_torch.ops.fused import build_fused_layout

    triples = np.ascontiguousarray(triples, dtype=np.int64)
    if triples.ndim != 2 or triples.shape[1] != 3:
        raise ValueError(f"triples must be (E, 3), got {triples.shape}")
    e = triples.shape[0]
    if 2 * e >= _INT32_MAX or num_nodes >= _INT32_MAX:
        raise ValueError(f"{e} triples, {num_nodes} nodes: past int32")
    if e and (triples.min() < 0 or triples[:, [0, 2]].max() >= num_nodes
              or triples[:, 1].max() >= num_rels):
        raise ValueError("triples: an id outside its node or relation range")
    num_general = 2 * num_rels
    capacity = 2 * e + num_general * tile_size + tile_size
    src = np.empty(capacity, dtype=np.int32)
    dst = np.empty(capacity, dtype=np.int32)
    rel = np.empty(capacity, dtype=np.int32)
    val = np.empty(capacity, dtype=np.float32)
    tile_rel = np.empty(capacity // tile_size + 1, dtype=np.int32)
    e_pad = native.load("host_builders").rgcn_build_edge_set(
        _ptr(triples, ctypes.c_int64), e, num_nodes, num_rels, tile_size,
        _ptr(src), _ptr(dst), _ptr(rel), _ptr(val, ctypes.c_float),
        _ptr(tile_rel), capacity)
    if e_pad < 0:
        raise RuntimeError("native graph builder: capacity underestimated")
    native.count("build_edge_set")
    src, dst, rel, val = (a[:e_pad].copy() for a in (src, dst, rel, val))
    tile_rel = tile_rel[:e_pad // tile_size].copy()
    if tile_multiple > 1:
        # round the tile count up; pad tiles carry the last relation, as
        # the numpy path's clamped search gives them
        step = tile_size * tile_multiple
        extra = -(-e_pad // step) * step - e_pad
        last = max(num_general - 1, 0)
        src = np.concatenate([src, np.zeros(extra, np.int32)])
        dst = np.concatenate([dst, np.full(extra, num_nodes, np.int32)])
        val = np.concatenate([val, np.zeros(extra, np.float32)])
        rel = np.concatenate([rel, np.full(extra, last, np.int32)])
        tile_rel = np.concatenate([tile_rel, np.full(extra // tile_size, last, np.int32)])
    es = EdgeSet(src=src, dst=dst, rel=rel, val=val, tile_rel=tile_rel,
                 num_nodes=int(num_nodes), num_rels=int(num_general),
                 tile_size=int(tile_size), num_edges=int(2 * e))
    if not with_dst_layout:
        return es
    kw = {k: v for k, v in (("row_block", layout_row_block),
                            ("chunk", layout_chunk)) if v is not None}
    layout = build_dst_layout(es.dst, num_nodes, **kw)
    # transposed copy: swap src/dst on the real edges (pads have val 0),
    # keep the forward normalisation, re-sort by (relation, new receiver)
    real = es.val > 0
    r_src, r_dst, r_rel, r_val = es.dst[real], es.src[real], es.rel[real], es.val[real]
    r_order = lexsort_rel_dst(r_rel, r_dst, num_general, num_nodes)
    rev = _assemble_edge_set(
        r_src[r_order], r_dst[r_order], r_rel[r_order], r_val[r_order],
        num_nodes, num_general, tile_size, True, layout_row_block,
        tile_multiple=tile_multiple, layout_chunk=layout_chunk)
    rev = dataclasses.replace(rev, fused=build_fused_layout(rev))
    return dataclasses.replace(es, layout=layout, reverse=rev,
                               fused=build_fused_layout(es))
