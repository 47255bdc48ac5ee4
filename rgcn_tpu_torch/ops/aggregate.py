"""Destination aggregation over a destination-sorted layout (K1).

Counterpart of ``rgcn_tpu/ops/pallas_aggregate.py``. Edges are grouped
into row blocks of ``RB`` consecutive destination rows, each block's slots
padded to a multiple of the chunk size ``CH``; pad slots carry
``local_dst == RB`` and are dropped, and every row block owns at least one
chunk, so every output row is written.

On a CUDA tensor :func:`aggregate_presorted` and :func:`aggregate_sorted`
launch the hand-written kernel ``kernels/csrc/k1_aggregate.cu``; on a CPU
tensor they take the plain PyTorch version beside them. Messages are f32
or bf16 (the edge stage's compute dtype): bf16 messages launch K1's bf16
form (``kernels/csrc/k1_aggregate_bf16.cu``). Both forms share one kernel
header, ``k1_aggregate.cuh``, and one rule for its routes
(``kernels.k1_route``). The two fixed-order routes take one launch with no
memset and sum in an order fixed by the layout, so the same inputs give
the same bits on every launch. A destination-sorted layout
(``DstLayout.dst_sorted``: every builder's but the source-ordered one)
takes the owned-row route: lane
groups sum runs of one destination in registers, each CTA stores every
row whose slots all lie in its span once, zeros included, and a row that
crosses CTAs (a hub over many chunks) is finished by the last of its CTAs
from f32 parts, in CTA order. A source-ordered layout takes the chunk
route: a CTA a chunk sums its slots by destination in slot order, a row
block's chunks finished by their last CTA in chunk order. Over 1,024 CTAs
or more two earlier designs stay where they measured faster: scalar lanes
(a width not a multiple of 4; nc-AM's pair path) take the atomics route,
a memset and every run added with an f32 atomic, in no fixed order; 4-value
lanes on rows of at most 128 columns with 3 slots an output row or more
(e-RGCN nc-AM's diagonal messages) the owned-row route with atomics on the rows two CTAs share
(beside a zeroing launch, and a narrowing one for a bf16 output;
a row over three CTAs or more sums in no fixed order). All sum in f32
into an f32 output, as the Pallas kernel's default ``out_dtype``, or
with ``out_dtype=torch.bfloat16`` into a bf16 one, each element rounded
once from its whole f32 sum (the Pallas kernel rounds each chunk's f32
partial into its bf16 output block, ``pallas_aggregate.py:196-198``: a
difference by design, nearer the f32 sum).

:func:`aggregate_sorted` has a backward (counterpart of ``_agg_ad``,
``pallas_aggregate.py:316-346``): the sum is linear, so the messages'
gradient is the gather ``g[dst]``, read from ``g`` with one zero row
appended for the pad edges (``dst == num_nodes``). :func:`aggregate_presorted`
has none: on the card it refuses inputs that need one.

:func:`aggregate_pairs` (counterpart of ``aggregate_pairs_ad``,
``pallas_aggregate.py:388-453``) sums a ``(U_pad, dout)`` pair-message
table fanned out to the edges, through a
:class:`~rgcn_tpu_torch.graph.structure.PairAggLayout`: K1 over the
destination layout forward, K1 over the slots-grouped-by-pair layout for
the messages' gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rgcn_tpu_torch import kernels
from rgcn_tpu_torch.device import arrays_to

__all__ = [
    "DstLayout",
    "build_dst_layout",
    "blocked_sum",
    "aggregate_presorted",
    "aggregate_presorted_plain",
    "aggregate_sorted",
    "aggregate_sorted_plain",
    "aggregate_pairs",
    "gather_by_dst",
]


@dataclasses.dataclass(frozen=True)
class DstLayout:
    """Destination-sorted chunk layout for aggregation.

    ``perm`` maps layout position -> edge index, with pad positions
    pointing one past the last edge (an appended zero row); ``num_edges``
    is that edge count, the rows edge-order messages must have.
    ``dst_sorted`` is False only for a layout whose row blocks run in
    source order (``build_dst_layout(src=...)``): K1, in either form, then
    takes its chunk route (a CTA a chunk, slots summed by destination in
    slot order), never the owned-row route.
    """

    perm: object  # (L,) int32 — layout position -> edge index
    local_dst: object  # (n_chunks, CH) int32 in [0, RB]
    chunk_block: object  # (n_chunks,) int32 — row block of each chunk
    num_edges: int
    num_row_blocks: int
    row_block: int
    chunk: int
    dst_sorted: bool = True

    @property
    def num_chunks(self) -> int:
        return self.chunk_block.shape[0]

    def to(self, device) -> "DstLayout":
        return arrays_to(self, device)


def build_dst_layout(
    dst: np.ndarray,
    num_nodes: int,
    row_block: int = 128,
    chunk: int = 256,
    pad_to: Optional[int] = None,
    src: Optional[np.ndarray] = None,
    prefer_native: bool = True,
) -> DstLayout:
    """Host-side layout construction for a static graph.

    ``dst`` is the per-edge destination (any order; pads = num_nodes).
    ``pad_to`` pads the layout to a fixed slot count: the appended chunks
    hold pads only and repeat the last row block (the host-built training
    subgraphs take the JAX package's shape-stable totals). ``src``, the
    per-edge source, orders the edges by source within each row block
    instead of by destination (numpy; the JAX package's gather probe;
    ``dst_sorted`` False). K1 takes either order; K4 needs
    destination-sorted blocks, so no path builds this form for it.

    Runs the port's C++ counting sort
    (:func:`rgcn_tpu_torch.graph.native.build_dst_layout_native`,
    bit-identical); ``prefer_native=False`` runs numpy's stable argsort.
    """
    if src is None and prefer_native:
        from rgcn_tpu_torch.graph.native import build_dst_layout_native

        return build_dst_layout_native(dst, num_nodes, row_block, chunk, pad_to)
    dst = np.asarray(dst)
    e = dst.shape[0]
    num_row_blocks = -(-num_nodes // row_block)

    if src is not None:
        src = np.asarray(src)
        keep = np.nonzero(dst < num_nodes)[0]
        order = keep[np.lexsort((src[keep], dst[keep] // row_block))]
        dst_sorted = dst[order]
    else:
        order = np.argsort(dst, kind="stable")
        dst_sorted = dst[order]
        real = dst_sorted < num_nodes
        order, dst_sorted = order[real], dst_sorted[real]

    block_of = dst_sorted // row_block
    counts = np.bincount(block_of, minlength=num_row_blocks)
    # every row block gets >= 1 chunk, so every output row is written
    padded = np.maximum(-(-counts // chunk), 1) * chunk
    offsets = np.concatenate([[0], np.cumsum(padded)])[:-1]
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    total = int(padded.sum())
    total = max(total, chunk)

    pos = offsets[block_of] + (np.arange(order.shape[0]) - starts[block_of])

    if pad_to is not None:
        if pad_to < total or pad_to % chunk:
            raise ValueError(
                f"pad_to={pad_to} < layout total {total} or not a multiple "
                f"of chunk {chunk}"
            )
        total = pad_to

    perm = np.full(total, e, dtype=np.int32)  # pad -> one-past-end slot
    perm[pos] = order
    local = np.full(total, row_block, dtype=np.int32)  # pad -> RB (dropped)
    local[pos] = dst_sorted - block_of * row_block

    n_chunks = total // chunk
    chunk_starts = np.arange(n_chunks) * chunk
    cum_padded = np.cumsum(padded)
    chunk_block = np.searchsorted(cum_padded, chunk_starts, side="right")
    chunk_block = np.minimum(chunk_block, num_row_blocks - 1).astype(np.int32)

    return DstLayout(
        perm=perm.astype(np.int32),
        local_dst=local.reshape(n_chunks, chunk),
        chunk_block=chunk_block,
        num_edges=int(e),
        num_row_blocks=int(num_row_blocks),
        row_block=int(row_block),
        chunk=int(chunk),
        dst_sorted=src is None,
    )


# message dtypes K1 and its plain version take; the plain version also sums
# f64 rows, in f64 (an exact reference for the kernel's f32 sums)
_MSG_DTYPES = (torch.float32, torch.bfloat16)


def _check_msgs(msgs: torch.Tensor, out_dtype=torch.float32) -> None:
    if msgs.dtype not in _MSG_DTYPES:
        raise TypeError(f"messages of dtype {msgs.dtype}: K1 takes float32 or bfloat16")
    if out_dtype not in _MSG_DTYPES:
        raise TypeError(f"out_dtype {out_dtype}: K1 writes float32 or bfloat16")


def blocked_sum(msgs_sorted, local_dst, chunk_block, num_row_blocks,
                 row_block, num_nodes):
    """Plain sum of destination-sorted rows into their row blocks, in f32
    (bf16 rows widened exactly, as K1's bf16 form reads them), or in f64
    for f64 rows (an exact reference for a kernel's f32 sums)."""
    if msgs_sorted.dtype != torch.float64:
        _check_msgs(msgs_sorted)
    chunk = local_dst.shape[1]
    local = local_dst.reshape(-1).long()
    rows = chunk_block.long().repeat_interleave(chunk) * row_block + local
    keep = local < row_block
    dtype = torch.float64 if msgs_sorted.dtype == torch.float64 else torch.float32
    out = torch.zeros(
        (num_row_blocks * row_block, msgs_sorted.shape[-1]),
        dtype=dtype, device=msgs_sorted.device,
    )
    out.index_add_(0, rows[keep], msgs_sorted[keep].to(dtype))
    return out[:num_nodes]


def aggregate_presorted_plain(
    msgs_sorted: torch.Tensor, layout: DstLayout, num_nodes: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of K1 on destination-sorted messages ``(L, dout)``:
    the f32 sums (f64 for f64 rows), rounded once to a bf16
    ``out_dtype``."""
    out = blocked_sum(
        msgs_sorted, layout.local_dst, layout.chunk_block,
        layout.num_row_blocks, layout.row_block, num_nodes,
    )
    return out.to(out_dtype) if out_dtype == torch.bfloat16 else out


def aggregate_sorted_plain(
    messages: torch.Tensor, layout: DstLayout, num_nodes: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of K1 on edge-order messages ``(E, dout)``: permute
    through ``perm`` (pads read an appended zero row), then sum."""
    msgs_z = torch.cat([messages, messages.new_zeros((1, messages.shape[-1]))])
    return aggregate_presorted_plain(msgs_z[layout.perm.long()], layout, num_nodes,
                                     out_dtype)


def aggregate_presorted(
    msgs_sorted: torch.Tensor, layout: DstLayout, num_nodes: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Aggregate already destination-sorted messages ``(L, dout)`` f32 or
    bf16 into ``(num_nodes, dout)`` of ``out_dtype`` (f32, or bf16 rounded
    once from the f32 sum), summed in f32. No backward: on the card, grad
    mode with ``msgs_sorted`` requiring grad raises."""
    if msgs_sorted.shape[0] != layout.num_chunks * layout.chunk:
        raise ValueError(
            f"{msgs_sorted.shape[0]} sorted messages for a layout of "
            f"{layout.num_chunks * layout.chunk} slots"
        )
    _check_msgs(msgs_sorted, out_dtype)
    if msgs_sorted.device.type == "cpu":
        return aggregate_presorted_plain(msgs_sorted, layout, num_nodes, out_dtype)
    kernels.refuse_grad("aggregate_presorted (K1)", msgs_sorted)
    return kernels.launch_k1_aggregate(
        msgs_sorted, None, layout.local_dst, layout.chunk_block,
        num_nodes, layout.row_block, layout.num_row_blocks, out_dtype, layout.dst_sorted,
    )


def gather_by_dst(g: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``g[dst]`` over ``g`` with one zero row appended, so the pad edges'
    ``dst == num_nodes`` read 0 (JAX clamps that index; on the card an
    index past the end is a device assert, so it is never clamped here)."""
    return torch.cat([g, g.new_zeros((1, g.shape[1]))])[dst.long()]


def _aggregate_sorted(messages, layout, num_nodes, out_dtype=torch.float32):
    _check_msgs(messages, out_dtype)
    if messages.device.type == "cpu":
        return aggregate_sorted_plain(messages, layout, num_nodes, out_dtype)
    return kernels.launch_k1_aggregate(
        messages, layout.perm, layout.local_dst, layout.chunk_block,
        num_nodes, layout.row_block, layout.num_row_blocks, out_dtype, layout.dst_sorted,
    )


class _AggregateSorted(torch.autograd.Function):
    """K1 forward; backward :func:`gather_by_dst`, in the messages' dtype."""

    @staticmethod
    def forward(ctx, messages, dst, layout, num_nodes, out_dtype):
        ctx.save_for_backward(dst)
        ctx.msg_dtype = messages.dtype
        return _aggregate_sorted(messages, layout, num_nodes, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return gather_by_dst(g, dst).to(ctx.msg_dtype), None, None, None, None


def aggregate_sorted(
    messages: torch.Tensor, layout: DstLayout, num_nodes: int,
    dst: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Aggregate edge-order messages ``(E, dout)`` f32 or bf16 into
    ``(num_nodes, dout)`` of ``out_dtype`` (f32, or bf16 rounded once from
    the f32 sum). The kernel reads each slot's row through
    ``layout.perm``; the destination-sorted copy never exists.

    Differentiable in ``messages``: with grad enabled and ``messages``
    requiring grad it runs as an autograd Function whose backward gathers
    the output gradient by ``dst``, the edges' destinations (pads
    ``num_nodes``), which must then be given."""
    if messages.shape[0] != layout.num_edges:
        raise ValueError(
            f"{messages.shape[0]} messages for a layout of "
            f"{layout.num_edges} edges"
        )
    if not (torch.is_grad_enabled() and messages.requires_grad):
        return _aggregate_sorted(messages, layout, num_nodes, out_dtype)
    if dst is None or dst.shape[0] != layout.num_edges:
        raise ValueError(
            "aggregate_sorted's backward needs dst, the destination of each "
            f"of the layout's {layout.num_edges} edges"
        )
    return _AggregateSorted.apply(messages, dst, layout, num_nodes, out_dtype)


def _zero_row(t: torch.Tensor) -> torch.Tensor:
    """``t`` with one zero row (or element) appended, for the sentinels."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def _pair_values(frozen, val, index):
    """The slots' edge values: the frozen copy when the PairAggLayout has
    one, else the live ``val`` gathered through ``index`` (sentinel
    ``E_pad`` reads 0)."""
    if frozen is not None:
        return frozen
    return _zero_row(val).index_select(0, index.long())


def _aggregate_pairs(m, val, agg, layout, num_nodes):
    v_slot = _pair_values(agg.slot_val, val, layout.perm)
    msgs = _zero_row(m).index_select(0, agg.slot_pair.long()) * v_slot[:, None]
    return aggregate_presorted(msgs, layout, num_nodes)


class _AggregatePairs(torch.autograd.Function):
    """K1 over the composed layout; backward K1 over ``grad_layout``."""

    @staticmethod
    def forward(ctx, m, val, edge_pair, dst, agg, layout, num_nodes):
        ctx.save_for_backward(m, val, edge_pair, dst)
        ctx.agg = agg
        return _aggregate_pairs(m, val, agg, layout, num_nodes)

    @staticmethod
    def backward(ctx, g):
        m, val, edge_pair, dst = ctx.saved_tensors
        agg = ctx.agg
        g_pad = _zero_row(g)
        d_m = d_val = None
        if ctx.needs_input_grad[0]:
            # d_m[u] = Σ_{slots l of pair u} v_l · g[slot_dst_l]
            v_grad = _pair_values(agg.grad_val, val, agg.grad_edge)
            rows = g_pad.index_select(0, agg.grad_dst.long()) * v_grad[:, None]
            d_m = aggregate_presorted(rows, agg.grad_layout, m.shape[0])
        if ctx.needs_input_grad[1]:
            d_val = (_zero_row(m).index_select(0, edge_pair.long())
                     * g_pad.index_select(0, dst.long())).sum(-1)
        return d_m, d_val, None, None, None, None, None


def aggregate_pairs(m: torch.Tensor, val: torch.Tensor, edge_pair: torch.Tensor,
                    dst: torch.Tensor, agg, layout: DstLayout,
                    num_nodes: int) -> torch.Tensor:
    """``out[n] = Σ_{edges e → n} val_e · m[edge_pair_e]`` for pair
    messages ``m (U_pad, dout)`` f32, without the ``(E, dout)`` fan-out:
    the slots of ``layout`` read their pair's row through
    ``agg.slot_pair`` (pad slots an appended zero row) scaled by the
    slot's value, and K1 sums them.

    The values are ``agg.slot_val`` / ``agg.grad_val`` when the layout
    froze them at build time, else ``val`` gathered through
    ``layout.perm`` / ``agg.grad_edge`` (what remains after
    :func:`~rgcn_tpu_torch.graph.structure.reweight_edge_set`), so an
    EdgeSet reweighted through it stays exact.

    Differentiable in ``m`` and ``val`` when grad is on: the gradient of
    ``m`` is K1 over ``agg.grad_layout`` (``U_pad`` segments) of
    ``v · g[grad_dst]``, that of ``val`` (computed only when asked for)
    ``Σ_cols m[edge_pair] · g[dst]``; ``edge_pair`` and ``dst`` (pads
    ``num_nodes``) serve only the latter. Otherwise K1 runs with no
    Function."""
    if torch.is_grad_enabled() and (m.requires_grad or val.requires_grad):
        return _AggregatePairs.apply(m, val, edge_pair, dst, agg, layout, num_nodes)
    return _aggregate_pairs(m, val, agg, layout, num_nodes)
