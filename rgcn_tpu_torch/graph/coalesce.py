"""Edge coalescing for the basis and diagonal SpMMs (numpy builders).

Counterpart of ``rgcn_tpu/graph/coalesce.py``, bit-equal to it. With basis
decomposition the per-edge weight is a scalar per basis,
``w[b, e] = val_e · comps[rel_e, b]``, and aggregation is linear, so edges
joining the same ``(receiver, source)`` pair under different relations
merge into one slot whose weight is the sum of theirs:

    Agg_b[d] = Σ_{pairs (d, s)} ( Σ_{e on pair} val_e · comps[rel_e, b] ) · x[s]

The merge is kept as a static per-slot coefficient matrix
``coeff[l, r] = Σ_{e on pair(l), rel_e = r} val_e`` (``(L, R')``), so the
per-slot weights are one small product, ``w = (coeff @ comps).T``. The
diagonal layer (e-RGCN) merges the same way: its per-slot weight is the
vector ``coeff @ dw`` (:mod:`rgcn_tpu_torch.ops.diag`).

Snapshot of ``val``: ``coeff`` (and ``fwd_dedup.coeff_k``, ``rev_coeff``)
freeze the EdgeSet's ``val`` as it was when the layout was built. An
EdgeSet whose ``val`` changes afterwards (a dropout mask, a reweighting)
must have its merged layout rebuilt from the new values, or dropped; the
basis ops would otherwise compute with the old values without notice. The
JAX package's ``reweight_edge_set`` drops ``merged`` for this reason.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from rgcn_tpu_torch.device import arrays_to
from rgcn_tpu_torch.ops.aggregate import DstLayout, build_dst_layout

__all__ = [
    "DedupFwdLayout",
    "MergedPairLayout",
    "build_merged_layout",
    "merge_applicable",
    "MAX_BASES",
    "MERGED_MAX_RELS",
]

#: Largest general-relation vocabulary for which the dense (L, R')
#: coefficient matrix is worth its memory and traffic.
MERGED_MAX_RELS = 128

#: Most bases the aggregation-first basis path takes (K4/K5 keep one sum
#: per basis in registers); wider basis configs expand to dense weights.
MAX_BASES = 8


def merge_applicable(
    num_general_rels: int,
    *,
    decomposition: Optional[str] = None,
    num_bases: int = 0,
    diag: bool = False,
) -> bool:
    """Will some layer path consume a merged layout? The diagonal layer
    (e-RGCN, ``diag=True``) always does; the basis layer for ``0 <
    num_bases <=`` :data:`MAX_BASES`; nothing above
    :data:`MERGED_MAX_RELS` general relations."""
    if num_general_rels > MERGED_MAX_RELS:
        return False
    if diag:
        return True
    return decomposition == "basis" and 0 < num_bases <= MAX_BASES


@dataclasses.dataclass(frozen=True)
class DedupFwdLayout:
    """Source-dedup'd forward frame: within each destination row block,
    pairs sharing a source are packed into one gather slot holding up to
    ``K`` (local destination, coefficient row) lanes, so the source row is
    read once and fanned out (K5). The same terms as the plain merged
    frame, reassociated.

    ``local_k`` uses the row-block convention (empty lanes carry
    ``row_block``); ``coeff_k[k]`` is lane ``k``'s per-slot coefficient
    matrix (zero rows on empty lanes), a snapshot of ``val``.
    """

    src_sorted: object  # (Ld,) int32 — per-slot source (pads -> 0)
    local_k: object  # (K, n_chunks, CH) int32 in [0, RB]
    chunk_block: object  # (n_chunks,) int32
    coeff_k: object  # (K, Ld, R') float32
    num_row_blocks: int
    row_block: int
    chunk: int

    @property
    def num_chunks(self) -> int:
        return self.chunk_block.shape[0]

    @property
    def num_k(self) -> int:
        return self.local_k.shape[0]

    def to(self, device) -> "DedupFwdLayout":
        return arrays_to(self, device)


@dataclasses.dataclass(frozen=True)
class MergedPairLayout:
    """Coalesced ``(receiver, source)`` pair layout for the basis kernels
    and the diagonal layer.

    Forward frame (receiver = destination): ``layout`` (a
    :class:`DstLayout` over the unique pairs), ``src_sorted (L,)`` (pads ->
    0) and ``coeff (L, R')``. Reverse frame (receiver = source), for the
    backward: ``rev_layout``, ``rev_src_sorted``, ``rev_receiver`` and
    ``rev_coeff``. ``fwd_dedup`` is the optional source-dedup'd forward
    frame (``build_merged_layout(dedup_k=K)``); the reverse frames are
    shared with it.
    """

    layout: DstLayout
    src_sorted: object  # (L,) int32
    coeff: object  # (L, R') float32
    rev_layout: DstLayout
    rev_src_sorted: object  # (L',) int32
    rev_receiver: object  # (L',) int32
    rev_coeff: object  # (L', R') float32
    num_nodes: int
    num_rels: int  # R' (general relations, inverses included)
    num_pairs: int  # unique real (dst, src) pairs
    num_edges: int  # real member edges merged into the pairs
    fwd_dedup: Optional[DedupFwdLayout] = None

    def to(self, device) -> "MergedPairLayout":
        return arrays_to(self, device)


def _pair_frame(recv, source, pair_coeff, num_nodes, row_block, chunk, pad_to=None):
    """One frame's (DstLayout over pairs, per-slot source, per-slot coeff)
    from per-pair receiver, source and coefficients; ``pad_to`` as
    :func:`~rgcn_tpu_torch.ops.aggregate.build_dst_layout`'s."""
    layout = build_dst_layout(recv, num_nodes, row_block=row_block, chunk=chunk,
                              pad_to=pad_to)
    src_z = np.concatenate([source, np.zeros((1,), np.int32)])
    coeff_z = np.concatenate(
        [pair_coeff, np.zeros((1, pair_coeff.shape[1]), np.float32)], axis=0
    )
    perm = layout.perm  # pads -> n_pairs (one-past-end -> zero row)
    # np.take, not fancy indexing: numpy's int32-index row gather is slow
    return (
        layout,
        np.take(src_z, perm).astype(np.int32),
        np.take(coeff_z, perm, axis=0),
    )


def _build_dedup_frame(pair_d, pair_s, coeff, num_nodes, row_block, chunk, k):
    """Pack within-(row block) same-source pairs into K-lane gather slots.

    Every pair becomes one (slot, lane) contribution; a group of ``m``
    pairs sharing ``(row block, src)`` takes ``ceil(m / k)`` slots. Block
    slot counts pad to a chunk multiple with at least one chunk, so every
    output row block is reached.
    """
    n = pair_d.shape[0]
    num_row_blocks = -(-num_nodes // row_block)
    blk = (pair_d // row_block).astype(np.int64)
    order = np.lexsort((pair_s, blk))
    b_o = blk[order]
    s_o = pair_s[order]
    local_o = (pair_d[order] - b_o.astype(pair_d.dtype) * row_block).astype(
        np.int32
    )
    coeff_o = np.take(coeff, order, axis=0)

    new = np.ones(n, dtype=bool)
    new[1:] = (b_o[1:] != b_o[:-1]) | (s_o[1:] != s_o[:-1])
    gid = np.cumsum(new) - 1
    first = np.flatnonzero(new)  # (G,) first pair of each group
    rank = np.arange(n) - first[gid]
    slot_in_group = rank // k
    lane = rank % k

    counts = np.diff(np.append(first, n))
    slots_per_group = -(-counts // k)
    g_blk = b_o[first]

    slots_per_block = np.zeros(num_row_blocks, np.int64)
    np.add.at(slots_per_block, g_blk, slots_per_group)
    padded_per_block = np.maximum(-(-slots_per_block // chunk), 1) * chunk
    block_off = np.concatenate([[0], np.cumsum(padded_per_block)[:-1]])

    # each group's slot offset within its block: exclusive cumsum of
    # slots_per_group, rebased at each block boundary (groups are sorted
    # by block)
    gs_excl = np.cumsum(slots_per_group) - slots_per_group
    gnew = np.ones(len(first), dtype=bool)
    gnew[1:] = g_blk[1:] != g_blk[:-1]
    block_start_excl = gs_excl[np.flatnonzero(gnew)]
    group_off = gs_excl - block_start_excl[np.cumsum(gnew) - 1]
    group_base = block_off[g_blk] + group_off

    slot_idx = (group_base[gid] + slot_in_group).astype(np.int64)
    total = int(padded_per_block.sum())

    src_sorted = np.zeros(total, np.int32)
    src_sorted[slot_idx] = s_o  # lanes of one slot share the source
    local_k = np.full((k, total), row_block, np.int32)
    local_k[lane, slot_idx] = local_o
    coeff_k = np.zeros((k, total, coeff.shape[1]), np.float32)
    coeff_k[lane, slot_idx] = coeff_o

    n_chunks = total // chunk
    chunk_block = np.repeat(
        np.arange(num_row_blocks), padded_per_block // chunk
    ).astype(np.int32)

    return DedupFwdLayout(
        src_sorted=src_sorted,
        local_k=local_k.reshape(k, n_chunks, chunk),
        chunk_block=chunk_block,
        coeff_k=coeff_k,
        num_row_blocks=int(num_row_blocks),
        row_block=int(row_block),
        chunk=int(chunk),
    )


def build_merged_layout(
    dst: np.ndarray,
    src: np.ndarray,
    rel: np.ndarray,
    val: np.ndarray,
    num_nodes: int,
    num_rels: int,
    *,
    row_block: int = 128,
    chunk: int = 256,
    max_rels: int = MERGED_MAX_RELS,
    pad_to: Optional[int] = None,
    rev_pad_to: Optional[int] = None,
    dedup_k: int = 0,
) -> MergedPairLayout:
    """Coalesce augmented edges into a :class:`MergedPairLayout`.

    Inputs are the per-edge arrays of the augmented general-relation graph
    (an EdgeSet's fields, padded or not: entries with ``dst >= num_nodes``
    or ``val == 0`` are ignored). Raises when ``num_rels`` exceeds
    ``max_rels`` (default :data:`MERGED_MAX_RELS`). ``pad_to`` /
    ``rev_pad_to`` pad the forward and reverse frames' slot counts (shape-
    stable per-epoch layouts, as ``build_dst_layout``'s ``pad_to``).
    ``dedup_k > 1`` also builds the source-dedup'd forward frame.
    The coefficients are a snapshot of ``val`` (module docstring).
    """
    if num_rels > max_rels:
        raise ValueError(
            f"merged layout needs num_rels <= {max_rels} (got {num_rels}); "
            "use the unmerged basis path"
        )
    dst = np.asarray(dst)
    src = np.asarray(src)
    rel = np.asarray(rel)
    val = np.asarray(val, dtype=np.float32)

    real = (dst < num_nodes) & (val != 0.0)
    d, s, r, v = dst[real], src[real], rel[real], val[real]

    key = d.astype(np.int64) * num_nodes + s.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    n_pairs = uniq.shape[0]
    pair_d = (uniq // num_nodes).astype(np.int32)
    pair_s = (uniq % num_nodes).astype(np.int32)

    coeff = np.zeros((n_pairs, num_rels), dtype=np.float32)
    np.add.at(coeff, (inv, r), v)

    layout, src_sorted, coeff_sorted = _pair_frame(
        pair_d, pair_s, coeff, num_nodes, row_block, chunk, pad_to
    )
    # reverse frame: receiver = forward source, same pairs and coefficients
    rev_layout, rev_src_sorted, rev_coeff_sorted = _pair_frame(
        pair_s, pair_d, coeff, num_nodes, row_block, chunk, rev_pad_to
    )
    recv_z = np.concatenate([pair_s, np.zeros((1,), np.int32)])
    rev_receiver = recv_z[rev_layout.perm].astype(np.int32)

    fwd_dedup = None
    if dedup_k and dedup_k > 1:
        fwd_dedup = _build_dedup_frame(
            pair_d, pair_s, coeff, num_nodes, row_block, chunk, dedup_k
        )

    return MergedPairLayout(
        layout=layout,
        src_sorted=src_sorted,
        coeff=coeff_sorted,
        rev_layout=rev_layout,
        rev_src_sorted=rev_src_sorted,
        rev_receiver=rev_receiver,
        rev_coeff=rev_coeff_sorted,
        num_nodes=int(num_nodes),
        num_rels=int(num_rels),
        num_pairs=int(n_pairs),
        num_edges=int(d.shape[0]),
        fwd_dedup=fwd_dedup,
    )
