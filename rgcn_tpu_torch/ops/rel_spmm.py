"""Relational SpMM message stage (K3), the forward dispatch and its backward.

Counterpart of ``rgcn_tpu/ops/pallas_spmm.py``. :func:`fwd_spmm` computes

    out[d] = Σ_{e: dst_e = d} val_e · (x[src_e] @ W[rel_e])

through the fused kernel (K2) when the EdgeSet carries a fused layout and
``W`` fits the shared-memory budget, else through per-tile messages (K3)
aggregated by K1, all in f32 as JAX's ``_fwd_spmm`` (``compute_dtype=None``).
A bf16 ``W`` (the layers' ``param_dtype``) with f32 ``x`` takes the same
routes through K2's and K3's bf16-weight forms (the weights widened
exactly, f32 products, messages and sums), routed by ``W``'s own bytes as
JAX routes it (``pallas_spmm.py:237``); the backward's ``dx`` comes back in
``x``'s dtype and ``dW`` in ``W``'s, each rounded once from its f32 sums.
:func:`rel_spmm_pallas` and :func:`rel_spmm_full` are the JAX package's
two-stage entry points with their ``compute_dtype`` / ``accum_dtype``
(``pallas_spmm.py:151-208``), through K3's and K1's bf16 forms where a
dtype is bf16. :func:`rel_spmm_ad` is the same function with a backward
(counterpart of ``rel_spmm_pallas_ad``, ``pallas_spmm.py:247-289``), whose
cotangents are the same class of computation as the forward:

    dx[s] = Σ_{e: src_e = s} val_e · g[dst_e] @ W[rel_e]ᵀ   (fwd_spmm over edges.reverse)
    dW[r] = Σ_{e ∈ r} val_e · x[src_e]ᵀ ⊗ g[dst_e]          (per-tile products, summed by tile_rel)

so dx runs K2 (or K3 then K1) over the reversed edges, and dW, an XLA einsum
and ``segment_sum(indices_are_sorted=True)`` in the JAX package, is one
``torch.bmm`` and one ``torch.segment_reduce`` here: each relation's tile
partials summed in tile order (a relation's tiles are adjacent, ``tile_rel``
sorted), the same bits on every run where ``index_add_``'s atomics added
them in no fixed order.
:func:`rel_spmm_messages` has no backward: on the card it refuses inputs
that need one.
"""

from __future__ import annotations

import torch

from rgcn_tpu_torch import kernels
from rgcn_tpu_torch.ops.aggregate import aggregate_sorted, gather_by_dst
from rgcn_tpu_torch.ops.basis import full_f32_matmul
from rgcn_tpu_torch.ops.fused import _compute_dtype, check_operands, rel_spmm_fused

__all__ = [
    "FUSED_SMEM_BUDGET",
    "fused_fits",
    "rel_spmm_messages",
    "rel_spmm_messages_plain",
    "rel_spmm_pallas",
    "rel_spmm_full",
    "fwd_spmm",
    "rel_spmm_weight_grad",
    "rel_spmm_ad",
]

# The port takes K2 only while the whole W and a (RB, dout) f32 accumulator
# fit the shared memory one H100 thread block may use (227 KB). The JAX
# package's rule is another: W within 8 MiB (pallas_spmm.py:228-244,
# _FUSED_VMEM_BUDGET). Results agree either way; only the route differs,
# for a W between the two budgets (e.g. 8 relations of 72 x 72), which the
# port sends through K3 + K1 and the JAX package through its fused kernel.
# The rule was set while K2 staged one whole W[rel] per CTA (a W[rel] past
# 227 KB, lp-FB-toy's 1 MB, could not take it); K2 now reads W through L1,
# and the rule stays, so that every path keeps its route. A rule keyed on
# one W[rel] would send nc-AM's layer 2 (W (532, 10, 11) over an
# 11.7M-slot fused layout) to K2, which measured 2.80 ms there against 0.17
# ms for K3 + K1 (chip_smoke.py on an H100 80GB HBM3 at 700 W), so the rule
# keys on the whole W.
FUSED_SMEM_BUDGET = 232_448


def fused_fits(weights: torch.Tensor, row_block: int, compute_dtype=None) -> bool:
    """Do ``W`` in ``compute_dtype`` (None: its own dtype; 2 bytes a value
    in bf16) and a ``(row_block, dout)`` f32 accumulator fit
    :data:`FUSED_SMEM_BUDGET`? (JAX's "W must fit VMEM in compute_dtype",
    ``pallas_fused.py:367``.)"""
    itemsize = (compute_dtype or weights.dtype).itemsize
    return weights.numel() * itemsize + row_block * weights.shape[-1] * 4 \
        <= FUSED_SMEM_BUDGET


def _cast(x: torch.Tensor, weights: torch.Tensor, compute_dtype):
    """``x`` and ``W`` in the compute dtype (None: as given), where the JAX
    functions cast them, before the kernel."""
    compute_dtype = _compute_dtype(compute_dtype)
    if compute_dtype is None:
        return x, weights
    return x.to(compute_dtype), weights.to(compute_dtype)


def rel_spmm_messages_plain(edges, x: torch.Tensor, weights: torch.Tensor,
                            out_dtype=None) -> torch.Tensor:
    """Plain version of K3: ``(x[src] @ W[tile_rel]) · val`` per tile, the
    products of the operands as given (bf16 widened exactly, a bf16 ``W``
    with f32 ``x`` too) summed in f32,
    rounded once to ``out_dtype`` (default the weights' dtype). A source
    past the last row (a reversed pad edge of a training subgraph, ``val ==
    0``) is clamped; K3 never reads the source of such a row."""
    kernels.pair_form(x, weights)
    out_dtype = out_dtype or weights.dtype
    x, weights = x.float(), weights.float()
    tile, n_tiles = edges.tile_size, edges.num_tiles
    src = edges.src.long().clamp_max(x.shape[0] - 1)
    xg = x[src].reshape(n_tiles, tile, x.shape[-1])
    msgs = torch.bmm(xg, weights[edges.tile_rel.long()])
    msgs = msgs.reshape(n_tiles * tile, -1) * edges.val[:, None]
    return msgs.to(out_dtype)


def rel_spmm_messages(edges, x: torch.Tensor, weights: torch.Tensor, *,
                      out_dtype=None) -> torch.Tensor:
    """Per-edge messages ``(E_pad, dout)`` in edge order, for ``x (N,
    din)`` and general-relation ``weights (R, din, dout)``, both f32, both
    bf16, or f32 ``x`` with bf16 ``weights`` (K3's bf16-weight form): f32
    sums, rounded once to ``out_dtype`` (default the
    weights' dtype, as in JAX), f32 or bf16. No backward: on the card, grad
    mode with ``x`` or ``weights`` requiring grad raises."""
    check_operands(x, weights, edges.num_nodes, edges.num_rels)
    if x.device.type == "cpu":
        return rel_spmm_messages_plain(edges, x, weights, out_dtype)
    kernels.refuse_grad("rel_spmm_messages (K3)", x, weights)
    return kernels.launch_k3_messages(
        x, weights, edges.src, edges.val, edges.tile_rel, edges.tile_size,
        out_dtype=out_dtype,
    )


def rel_spmm_pallas(edges, x: torch.Tensor, weights: torch.Tensor, *,
                    compute_dtype=None, accum_dtype=torch.float32) -> torch.Tensor:
    """Two-stage SpMM of the JAX package's ``rel_spmm_pallas``: ``x`` and
    ``W`` cast to ``compute_dtype``, K3 messages in ``accum_dtype``, then
    their destination sum into ``accum_dtype``. JAX sums the messages with
    XLA's ``segment_sum`` (in ``accum_dtype``); the port sums them with K1
    over ``edges.layout`` in f32 and rounds a bf16 ``accum_dtype`` once.
    Needs an EdgeSet built with ``with_dst_layout=True``."""
    if edges.layout is None:
        raise ValueError("rel_spmm_pallas sums with K1: build the EdgeSet with "
                         "with_dst_layout=True")
    x, weights = _cast(x, weights, compute_dtype)
    msgs = rel_spmm_messages(edges, x, weights, out_dtype=accum_dtype)
    return aggregate_sorted(msgs, edges.layout, edges.num_nodes, dst=edges.dst,
                            out_dtype=accum_dtype)


def rel_spmm_full(edges, layout, x: torch.Tensor, weights: torch.Tensor, *,
                  compute_dtype=None, accum_dtype=torch.float32) -> torch.Tensor:
    """Two-stage SpMM: K3 messages, then K1 over the destination layout.
    As ``rel_spmm_pallas_full``: ``x`` and ``W`` cast to ``compute_dtype``,
    the messages in ``compute_dtype`` (else ``accum_dtype``), summed in f32
    into ``accum_dtype``."""
    x, weights = _cast(x, weights, compute_dtype)
    msgs = rel_spmm_messages(edges, x, weights, out_dtype=compute_dtype or accum_dtype)
    return aggregate_sorted(msgs, layout, edges.num_nodes, dst=edges.dst,
                            out_dtype=accum_dtype)


def fwd_spmm(edges, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """K2 when ``edges.fused`` exists and ``W`` fits (at ``W``'s own dtype),
    else K3 then K1; f32 throughout, as JAX's ``_fwd_spmm`` (a bf16 ``W``
    widened inside the kernels' bf16-weight forms)."""
    if edges.fused is not None and fused_fits(weights, edges.fused.row_block):
        return rel_spmm_fused(edges.fused, edges.num_nodes, x, weights, compute_dtype=None)
    return rel_spmm_full(edges, edges.layout, x, weights)


def rel_spmm_weight_grad(edges, x: torch.Tensor, g: torch.Tensor,
                         num_rels: int) -> torch.Tensor:
    """``dW (num_rels, din, dout)``: per tile ``x[src]ᵀ @ (g[dst] · val)``
    in full f32, each relation's partials summed in tile order (``tile_rel``
    is sorted, a relation's tiles adjacent: JAX's ``segment_sum(...,
    indices_are_sorted=True)``, ``pallas_spmm.py:268-271``), a relation
    with no tile 0; the pad edges read a zero row of ``g``. No atomics: the
    same bits on every run."""
    tile, n_tiles = edges.tile_size, edges.num_tiles
    xg = x[edges.src.long()].reshape(n_tiles, tile, x.shape[-1])
    gd = (gather_by_dst(g, edges.dst) * edges.val[:, None]).reshape(n_tiles, tile, -1)
    with full_f32_matmul():
        partials = torch.bmm(xg.transpose(1, 2), gd)
    rel = edges.tile_rel.long()
    starts = torch.searchsorted(rel, torch.arange(num_rels + 1, device=rel.device))
    return torch.segment_reduce(partials, "sum", lengths=starts[1:] - starts[:-1], axis=0)


class _RelSpmm(torch.autograd.Function):
    """:func:`fwd_spmm` with its backward; the EdgeSet rides on ``ctx``."""

    @staticmethod
    def forward(ctx, x, weights, edges):
        ctx.edges = edges
        ctx.save_for_backward(x, weights)
        return fwd_spmm(edges, x, weights)

    @staticmethod
    def backward(ctx, g):
        x, weights = ctx.saved_tensors
        edges = ctx.edges
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = fwd_spmm(edges.reverse, g, weights.transpose(1, 2).contiguous())
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = rel_spmm_weight_grad(edges, x, g, weights.shape[0]).to(weights.dtype)
        return dx, dw, None


def rel_spmm_ad(edges, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`fwd_spmm` for ``x (N, din)`` and general-relation
    ``weights (R, din, dout)``. Needs ``edges.layout`` and ``edges.reverse``
    (``build_edge_set(..., with_dst_layout=True)``). With grad enabled and
    ``x`` or ``weights`` requiring grad it runs as an autograd Function, whose
    backward launches the same kernels over the reversed edges."""
    if edges.layout is None or edges.reverse is None:
        raise ValueError(
            "rel_spmm_ad needs an EdgeSet built with with_dst_layout=True "
            "(layout + reverse present)"
        )
    if torch.is_grad_enabled() and (x.requires_grad or weights.requires_grad):
        return _RelSpmm.apply(x, weights, edges)
    return fwd_spmm(edges, x, weights)
