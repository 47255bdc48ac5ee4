"""Diagonal-weight relational SpMM on K1 (the e-RGCN first layer).

Counterpart of ``rgcn_tpu/ops/pallas_diag.py``. A diagonal message,
``x[src] ⊙ dw[rel] · val``, is cheap enough to build directly in the
destination-sorted slot order of a :class:`~rgcn_tpu_torch.ops.aggregate.DstLayout`,
so K1 sums it slot by slot (``index`` None) with no edge-order copy and no
permutation. Two frames, each one ``torch.autograd.Function``:

* unmerged (:class:`_DiagUnmerged`): the slot-order ``src/rel/val`` are the
  EdgeSet's arrays with ``(0, 0, 0.0)`` appended, gathered through
  ``layout.perm`` (pad slots point one past the last edge). ``dx`` is the
  same pipeline over ``edges.reverse`` with the cotangent rows in place of
  ``x``; ``d dw[r] = Σ_{e ∈ r} val_e · x[src_e] ⊙ g[dst_e]`` is summed per
  relation run (the edges are sorted by relation) in a fixed order
  (:func:`~rgcn_tpu_torch.ops.ordered.index_sum`), with ``g`` read through
  :func:`~rgcn_tpu_torch.ops.aggregate.gather_by_dst` (a zero row for the
  pad edges' ``dst == num_nodes``; JAX clamps that index);
* merged (:class:`_DiagMerged`, over ``edges.merged``): parallel edges of
  one ``(receiver, source)`` pair share a slot whose weight is the vector
  ``dvec = coeff @ dw``, so K1 sums ``x[src_sorted] ⊙ dvec`` over
  ``merged.layout``; ``dx`` is K1 over ``merged.rev_layout`` with
  ``rev_coeff @ dw``, and the cotangent rows it gathers are reused for
  ``d dw = rev_coeffᵀ @ (x[rev_receiver] ⊙ g[rev_src_sorted])``.

The gathers and products around K1 are torch ops: the TPU computes them
in the kernel's input pipeline (``input_fusion=True``), so the ``(L, d)``
message tensor never lands in its memory; here it does. The small
products (``coeff @ dw``) run in full f32 (the JAX package's
``precision="highest"``). ``compute_dtype`` (bf16 on the card, chosen by
:func:`rgcn_tpu_torch.nn.layers._edge_compute_dtype`; None keeps f32)
builds the messages in bf16 at JAX's cast points (``pallas_diag.py:58-100``,
``:115-170``): ``x``, ``dw`` (or the merged frame's ``dvec``) and ``val``
are cast before the gathers, every product rounds to bf16, and K1's bf16
form sums the half-width ``(L, d)`` messages in f32 into an f32 output;
``d dw`` sums the bf16 products ``x ⊙ (g · val)`` (merged: ``x ⊙ g``) in
f32. ``val`` is read from the EdgeSet
at each call in the unmerged frame; the merged frame's ``coeff`` and
``rev_coeff`` are the layout's snapshot of it (see
:mod:`rgcn_tpu_torch.graph.coalesce`). On CPU tensors K1 is its plain
version (:func:`~rgcn_tpu_torch.ops.aggregate.aggregate_presorted`).

bf16 weights (the layers' ``param_dtype``) with f32 ``x``: the messages
``x ⊙ dw`` promote to f32 as JAX's do (the merged frame's ``coeff @ dw``
widens ``dw`` first), and ``d dw`` sums in f32 and rounds once to ``dw``'s
dtype, as JAX's VJPs end in ``.astype(dw.dtype)``; ``dx`` comes back in
``x``'s dtype.
"""

from __future__ import annotations

import torch

from rgcn_tpu_torch.ops.aggregate import _zero_row, aggregate_presorted, gather_by_dst
from rgcn_tpu_torch.ops.basis import _narrow, full_f32_matmul
from rgcn_tpu_torch.ops.ordered import index_sum

__all__ = [
    "diag_slot_messages",
    "diag_weight_grad",
    "merged_dvec",
    "rel_spmm_diag_ad",
]


def diag_slot_messages(x: torch.Tensor, dw: torch.Tensor, edges,
                       compute_dtype=None) -> torch.Tensor:
    """``(L, d)`` messages ``x[src_s] ⊙ dw[rel_s] · val_s`` in the slot
    order of ``edges.layout``; pad slots read ``(0, 0, 0.0)``. With a
    compute dtype the three operands are cast before the gathers and each
    product rounds to it."""
    perm = edges.layout.perm.long()
    src_s = _zero_row(edges.src)[perm].long()
    rel_s = _zero_row(edges.rel)[perm].long()
    val_s = _narrow(_zero_row(edges.val)[perm], compute_dtype)
    x, dw = _narrow(x, compute_dtype), _narrow(dw, compute_dtype)
    return x[src_s] * dw[rel_s] * val_s[:, None]


def _diag_sorted_agg(x, dw, edges, compute_dtype=None):
    return aggregate_presorted(diag_slot_messages(x, dw, edges, compute_dtype),
                               edges.layout, edges.num_nodes)


def diag_weight_grad(x: torch.Tensor, g: torch.Tensor, edges,
                     compute_dtype=None) -> torch.Tensor:
    """``d dw (R, d)`` f32: ``Σ_{e ∈ r} val_e · x[src_e] ⊙ g[dst_e]``, the
    pad edges reading a zero row of ``g`` (their ``rel`` is their tile's,
    in range). With a compute dtype the products ``x ⊙ (g · val)`` are
    taken in it, as JAX's ``_diag_ad_bwd`` takes them, and summed in
    f32, each relation's run of edges in a fixed order (JAX's
    ``segment_sum``)."""
    src, rel = edges.src.long(), edges.rel.long()
    if compute_dtype is None:
        t = x[src] * gather_by_dst(g, edges.dst) * edges.val[:, None]
    else:
        gv = gather_by_dst(g.to(compute_dtype), edges.dst) * edges.val.to(compute_dtype)[:, None]
        t = (x.to(compute_dtype)[src] * gv).float()
    return index_sum(t, rel, edges.num_rels, sorted_index=True)


class _DiagUnmerged(torch.autograd.Function):
    """K1 over slot-order messages; dx the same over ``edges.reverse``,
    ``d dw`` by :func:`diag_weight_grad`. The EdgeSet rides on ``ctx``."""

    @staticmethod
    def forward(ctx, x, dw, edges, compute_dtype):
        ctx.edges, ctx.compute_dtype = edges, compute_dtype
        ctx.save_for_backward(x, dw)
        return _diag_sorted_agg(x, dw, edges, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, dw = ctx.saved_tensors
        edges, cd = ctx.edges, ctx.compute_dtype
        g = g.contiguous()
        dx = ddw = None
        if ctx.needs_input_grad[0]:
            dx = _diag_sorted_agg(g, dw, edges.reverse, cd).to(x.dtype)
        if ctx.needs_input_grad[1]:
            ddw = diag_weight_grad(x, g, edges, cd).to(dw.dtype)
        return dx, ddw, None, None


def merged_dvec(coeff: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """Per-slot weight vectors ``coeff @ dw`` (``(L, R') @ (R', d)``) in
    full f32 (bf16 ``dw`` widened)."""
    with full_f32_matmul():
        return coeff @ dw.float()


class _DiagMerged(torch.autograd.Function):
    """K1 over the merged pair frame; backward K1 over its reverse frame
    and one small product for ``d dw``. The layout rides on ``ctx``."""

    @staticmethod
    def forward(ctx, x, dw, merged, compute_dtype):
        ctx.merged, ctx.compute_dtype = merged, compute_dtype
        ctx.save_for_backward(x, dw)
        rows = _narrow(x, compute_dtype)[merged.src_sorted.long()]
        dvec = _narrow(merged_dvec(merged.coeff, dw), compute_dtype)
        return aggregate_presorted(rows * dvec, merged.layout, merged.num_nodes)

    @staticmethod
    def backward(ctx, g):
        x, dw = ctx.saved_tensors
        m, cd = ctx.merged, ctx.compute_dtype
        # (L', d) cotangent rows, in the compute dtype, reused for d dw
        gg = _narrow(g.contiguous(), cd)[m.rev_src_sorted.long()]
        dx = ddw = None
        if ctx.needs_input_grad[0]:
            dvec = _narrow(merged_dvec(m.rev_coeff, dw), cd)
            dx = aggregate_presorted(gg * dvec, m.rev_layout, m.num_nodes).to(x.dtype)
        if ctx.needs_input_grad[1]:
            t = (_narrow(x, cd)[m.rev_receiver.long()] * gg).float()
            with full_f32_matmul():
                ddw = (m.rev_coeff.t() @ t).to(dw.dtype)
        return dx, ddw, None, None


def rel_spmm_diag_ad(edges, x: torch.Tensor, dw: torch.Tensor,
                     compute_dtype=None) -> torch.Tensor:
    """Differentiable diagonal SpMM of ``x (N, d)`` f32 with the general
    relations' weight vectors ``dw (R', d)``: the merged frame when
    ``edges.merged`` exists, else the unmerged one, which needs
    ``edges.layout`` and ``edges.reverse`` (``build_edge_set(...,
    with_dst_layout=True)``). ``compute_dtype`` (bf16 or None): the
    messages' dtype (see the module docstring); the result is f32."""
    if edges.merged is not None:
        return _DiagMerged.apply(x, dw, edges.merged, compute_dtype)
    if edges.layout is None or edges.reverse is None:
        raise ValueError(
            "rel_spmm_diag_ad needs an EdgeSet built with with_dst_layout=True "
            "(layout + reverse present)"
        )
    return _DiagUnmerged.apply(x, dw, edges, compute_dtype)
