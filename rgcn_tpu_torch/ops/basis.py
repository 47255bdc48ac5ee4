"""Aggregation-first basis-decomposition SpMM (K4, K5) and its VJP.

Counterpart of ``rgcn_tpu/ops/pallas_basis.py``. With basis decomposition
the relational SpMM aggregates before any weight product:

    out[s] = Σ_b ( Σ_e (val_e · comps[rel_e, b]) · x[src_e] )[s] @ B_b
                   \\______________ Agg_b ______________/

so the edge stage is a weighted destination sum with one scalar per
(basis, slot) over a destination-sorted layout, and the ``nb`` dense
``(N, din) @ (din, dout)`` products are one ``(N, nb·din) @ (nb·din,
dout)`` product (:func:`closing_product`). :func:`weighted_aggregate`
(K4) computes ``Agg`` over a :class:`~rgcn_tpu_torch.ops.aggregate.DstLayout`
frame, gathering the source rows inside the kernel (the ``(L, din)``
gathered rows never exist in device memory); :func:`weighted_aggregate_dedup`
(K5) does the same over the source-dedup'd merged frame. On a CUDA tensor
they launch ``kernels/csrc/k4_weighted_aggregate.cu`` and
``k5_weighted_aggregate_dedup.cu``; on a CPU tensor they take the plain
PyTorch versions beside them. Both routes return ``Agg`` as the JAX
functions do, ``(nb, N, din)``, but as a view of node-major ``(N, nb,
din)`` storage, so the closing product reads it without a copy. A
featureless layer (identity features) needs no closing product:
:func:`rel_spmm_featureless_basis_fwd` runs K4 over the per-basis tables
with the sum over bases in the kernel.

:func:`rel_spmm_basis` over an unmerged destination layout with its
reversed edges (the training subgraphs of LP) is differentiable, the
counterpart of ``_basis_ad_core`` (``pallas_basis.py:346-418``): the
forward is K4 then the closing product, saving ``Agg``; the backward is

    dbases_b = Agg_bᵀ g                       one f32 product
    G_b      = g @ B_bᵀ                       (nb, N, din)
    dx       = K4 over edges.reverse with the per-basis tables G, sum_bases
    dcomps   = Σ_{reverse slots} val · <x[rdst], G_b[rsrc]>, summed by rel

The per-slot weight products (``coeff @ comps``), the closing product and
the backward's products are ordinary products outside the kernels; they
run in full f32 (TF32 off), as the JAX package runs them at
``precision="highest"``. The merged frame's VJP (``_basis_merged_bwd``)
and the featureless layer's are not ported: on the card, grad through
:func:`rel_spmm_basis` over a merged layout, or through
:func:`rel_spmm_featureless_basis_fwd`, raises (K4 and K5 refuse grad);
on the CPU the plain versions are differentiable by torch.

Snapshot of ``val``: over a merged layout the weights come from
``merged.coeff`` (or ``fwd_dedup.coeff_k``), which froze the EdgeSet's
``val`` when the layout was built; only the unmerged path
(:func:`sorted_inputs`) reads ``edges.val`` as it is now. An EdgeSet whose
``val`` changes must rebuild or drop ``merged`` before it reaches
:func:`rel_spmm_basis`.
"""

from __future__ import annotations

import contextlib

import torch

from rgcn_tpu_torch import kernels

__all__ = [
    "full_f32_matmul",
    "closing_product",
    "weighted_aggregate",
    "weighted_aggregate_plain",
    "weighted_aggregate_dedup",
    "weighted_aggregate_dedup_plain",
    "sorted_inputs",
    "merged_wvec",
    "rel_spmm_basis",
    "rel_spmm_featureless_basis_fwd",
]


@contextlib.contextmanager
def full_f32_matmul():
    """Matmuls in full f32 on the card (TF32 off) for the block's length."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _slot_rows(layout, local: torch.Tensor) -> torch.Tensor:
    """Output row of each slot: ``chunk_block * RB + local``."""
    block = layout.chunk_block.long().repeat_interleave(layout.chunk)
    return block * layout.row_block + local


def _check_nodes(layout, num_nodes: int) -> None:
    """Both routes refuse an output that does not cover the layout's row
    blocks exactly (the plain versions would slice, the kernels would
    address rows past the output)."""
    if -(-num_nodes // layout.row_block) != layout.num_row_blocks:
        raise ValueError(
            f"{num_nodes} nodes for a layout of {layout.num_row_blocks} row "
            f"blocks of {layout.row_block}"
        )


def weighted_aggregate_plain(x, src, w, layout, num_nodes: int, *,
                             sum_bases: bool = False) -> torch.Tensor:
    """Plain version of K4: ``Agg[b, n] = Σ_{slots l → n} w[b, l] ·
    row(b, l)`` with ``row(b, l) = x[src[l]]`` (shared ``(rows, din)``
    table) or ``x[b, src[l]]`` (per-basis ``(nb, rows, din)`` tables), pads
    (``local_dst == RB``) dropped. ``sum_bases`` sums over ``b``. Returns
    ``(nb or 1, num_nodes, din)``, a view of node-major storage."""
    local = layout.local_dst.reshape(-1).long()
    keep = local < layout.row_block
    rows = _slot_rows(layout, local)[keep]
    s = src.long()[keep]
    wk = w[:, keep].T[:, :, None]  # (slots, nb, 1)
    msgs = wk * (x[s][:, None] if x.dim() == 2 else x[:, s].transpose(0, 1))
    if sum_bases:
        msgs = msgs.sum(1, keepdim=True)
    out = torch.zeros(
        (layout.num_row_blocks * layout.row_block, msgs.shape[1], x.shape[-1]),
        dtype=torch.float32, device=x.device,
    )
    out.index_add_(0, rows, msgs)
    return out[:num_nodes].permute(1, 0, 2)


def weighted_aggregate(x, src, w, layout, num_nodes: int, *,
                       sum_bases: bool = False) -> torch.Tensor:
    """K4 over a destination-sorted frame: ``x`` f32 ``(rows, din)`` or
    ``(nb, rows, din)``, ``src (L,)`` int32 per-slot source rows, ``w (nb,
    L)`` f32 per-slot weights, ``layout`` a DstLayout of ``L`` slots.
    Returns ``(nb or 1, num_nodes, din)`` f32, a view of node-major
    storage. No backward: on the card, grad mode with ``x`` or ``w``
    requiring grad raises."""
    if w.shape[-1] != layout.num_chunks * layout.chunk:
        raise ValueError(
            f"{w.shape[-1]} slot weights for a layout of "
            f"{layout.num_chunks * layout.chunk} slots"
        )
    _check_nodes(layout, num_nodes)
    if x.device.type == "cpu":
        return weighted_aggregate_plain(x, src, w, layout, num_nodes,
                                        sum_bases=sum_bases)
    kernels.refuse_grad("weighted_aggregate (K4)", x, w)
    return kernels.launch_k4_weighted_aggregate(
        x, src, w, layout.local_dst, layout.chunk_block, num_nodes,
        layout.row_block, layout.num_row_blocks, sum_bases=sum_bases,
    )


def weighted_aggregate_dedup_plain(x, src, w_k, dd, num_nodes: int) -> torch.Tensor:
    """Plain version of K5: ``Agg[b, n] = Σ_{slots l, lanes k → n}
    w_k[k, b, l] · x[src[l]]`` over a DedupFwdLayout ``dd``, empty lanes
    (``local_k == RB``) dropped. Returns ``(nb, num_nodes, din)``, a view
    of node-major storage."""
    kk = dd.local_k.shape[0]
    local = dd.local_k.reshape(kk, -1).long()
    xg = x[src.long()]
    out = torch.zeros(
        (dd.num_row_blocks * dd.row_block, w_k.shape[1], x.shape[-1]),
        dtype=torch.float32, device=x.device,
    )
    for k in range(kk):
        keep = local[k] < dd.row_block
        out.index_add_(0, _slot_rows(dd, local[k])[keep],
                       w_k[k][:, keep].T[:, :, None] * xg[keep][:, None])
    return out[:num_nodes].permute(1, 0, 2)


def weighted_aggregate_dedup(x, src, w_k, dd, num_nodes: int) -> torch.Tensor:
    """K5 over a source-dedup'd frame: ``x (rows, din)`` f32, ``src (Ld,)``
    int32, ``w_k (K, nb, Ld)`` f32 per-lane weights. Returns ``(nb,
    num_nodes, din)`` f32, a view of node-major storage. No backward: on
    the card, grad mode with ``x`` or ``w_k`` requiring grad raises."""
    if tuple(w_k.shape[::2]) != (dd.num_k, dd.num_chunks * dd.chunk):
        raise ValueError(
            f"lane weights {tuple(w_k.shape)} for a frame of {dd.num_k} "
            f"lanes and {dd.num_chunks * dd.chunk} slots"
        )
    _check_nodes(dd, num_nodes)
    if x.device.type == "cpu":
        return weighted_aggregate_dedup_plain(x, src, w_k, dd, num_nodes)
    kernels.refuse_grad("weighted_aggregate_dedup (K5)", x, w_k)
    return kernels.launch_k5_weighted_aggregate_dedup(
        x, src, w_k, dd.local_k, dd.chunk_block, num_nodes, dd.row_block,
        dd.num_row_blocks,
    )


def sorted_inputs(edges, comps: torch.Tensor):
    """Per-slot ``(source, basis weights (nb, L))`` of the EdgeSet's
    destination layout, from the live ``edges.val``; pads read 0. A
    source past the last node (a reversed pad edge, weight 0) is clamped
    to it, as JAX's gather clamps it."""
    perm = edges.layout.perm.long()
    src_z = torch.cat([edges.src, edges.src.new_zeros(1)])
    wvec = edges.val[:, None] * comps[edges.rel.long()]  # (E_pad, nb)
    wvec_z = torch.cat([wvec, wvec.new_zeros((1, comps.shape[1]))])
    return (src_z[perm].clamp_max(edges.num_nodes - 1),
            wvec_z[perm].T.contiguous())


def merged_wvec(coeff: torch.Tensor, comps: torch.Tensor) -> torch.Tensor:
    """``(nb, L)`` per-slot basis weights from the frozen ``(L, R')``
    coefficients, in full f32."""
    with full_f32_matmul():
        return (coeff @ comps).T.contiguous()


def closing_product(agg: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """``Σ_b agg[b] @ bases[b]`` for ``agg (nb, N, din)`` and ``bases (nb,
    din, dout)``, as one full-f32 ``(N, nb·din) @ (nb·din, dout)`` product.
    Over the node-major storage K4/K5 and their plain versions return,
    ``agg.permute(1, 0, 2)`` is contiguous and the reshape copies nothing."""
    nb, n, din = agg.shape
    with full_f32_matmul():
        return agg.permute(1, 0, 2).reshape(n, nb * din) @ bases.reshape(nb * din, -1)


def rel_spmm_featureless_basis_fwd(edges, bases: torch.Tensor,
                                   comps: torch.Tensor) -> torch.Tensor:
    """Featureless basis SpMM, forward (counterpart of
    ``pallas_basis.py::_fl_basis_fwd_impl``): with identity features
    ``out[s] = Σ_b Σ_{e → s} (val_e · comps[rel_e, b]) · bases[b, src_e]``,
    so K4 over the EdgeSet's destination layout gathers from the per-basis
    tables ``bases (nb, N, dout)`` and sums over bases in the kernel.
    ``comps (R, nb)`` covers the general relations. Returns ``(N, dout)``.
    No backward yet: K4 refuses grad on the card."""
    src_sorted, wvec = sorted_inputs(edges, comps)
    return weighted_aggregate(bases, src_sorted, wvec, edges.layout,
                              edges.num_nodes, sum_bases=True)[0]


class _BasisAD(torch.autograd.Function):
    """K4's ``Agg`` over an unmerged destination layout and the closing
    product, with the VJP of ``_basis_ad_core``; the EdgeSet rides on
    ``ctx``."""

    @staticmethod
    def forward(ctx, x, bases, comps, edges):
        src_sorted, wvec = sorted_inputs(edges, comps)
        agg = weighted_aggregate(x, src_sorted, wvec, edges.layout, edges.num_nodes)
        ctx.edges = edges
        ctx.save_for_backward(x, bases, comps, agg)
        return closing_product(agg, bases)

    @staticmethod
    def backward(ctx, g):
        x, bases, comps, agg = ctx.saved_tensors
        edges, rev = ctx.edges, ctx.edges.reverse
        g = g.contiguous()
        nb, din, dout = bases.shape
        n = edges.num_nodes
        with full_f32_matmul():
            # Agg_bᵀ g for every basis, as one (nb·din, N) @ (N, dout) product
            dbases = (agg.permute(1, 0, 2).reshape(n, nb * din).T @ g
                      ).reshape(nb, din, dout)
            G = torch.matmul(g, bases.transpose(1, 2))  # (nb, N, din)
        rsrc, rwvec = sorted_inputs(rev, comps)
        dx = weighted_aggregate(G, rsrc, rwvec, rev.layout, n, sum_bases=True)[0]
        # dcomps in the reverse frame: the reverse slots' sources are the
        # forward receivers, their receivers the forward sources
        perm = rev.layout.perm.long()
        z = rev.src.new_zeros(1)
        rdst = torch.cat([rev.dst, z])[perm].clamp_max(n - 1)
        rrel = torch.cat([rev.rel, z])[perm].long()
        rval = torch.cat([rev.val, rev.val.new_zeros(1)])[perm]
        gg = G[:, rsrc.long()]  # (nb, L', din)
        with full_f32_matmul():
            t = torch.einsum("bli,li->lb", gg, x[rdst.long()]) * rval[:, None]
        dcomps = torch.zeros_like(comps).index_add_(0, rrel, t)
        return dx.contiguous(), dbases, dcomps, None


def rel_spmm_basis(edges, x: torch.Tensor, bases: torch.Tensor,
                   comps: torch.Tensor) -> torch.Tensor:
    """Aggregation-first basis SpMM: ``bases (nb, din, dout)``, ``comps
    (R', nb)`` over the general relations only (the self-loop term is the
    caller's). Takes the EdgeSet's merged layout when it has one (K5 over
    ``merged.fwd_dedup`` when that is set, else K4; no backward: K4 and K5
    refuse grad on the card), else K4 over its destination layout. Over the
    destination layout, with grad enabled and an input requiring grad, it
    runs as an autograd Function whose backward launches K4 over
    ``edges.reverse`` (as the training subgraphs of
    :func:`~rgcn_tpu_torch.graph.dynamic.build_edge_set_dynamic_host` carry
    it). Returns ``(N, dout)``."""
    merged = edges.merged
    if merged is not None:
        dd = merged.fwd_dedup
        if dd is not None:
            with full_f32_matmul():
                w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
            agg = weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd,
                                           merged.num_nodes)
        else:
            agg = weighted_aggregate(x, merged.src_sorted,
                                     merged_wvec(merged.coeff, comps),
                                     merged.layout, merged.num_nodes)
    elif edges.layout is None:
        raise ValueError(
            "rel_spmm_basis needs an EdgeSet with a merged or destination "
            "layout (build_edge_set(..., with_dst_layout=True))"
        )
    elif torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, bases, comps)):
        if edges.reverse is None or edges.reverse.layout is None:
            raise ValueError(
                "the backward of rel_spmm_basis needs the EdgeSet's reversed "
                "edges with their destination layout (with_dst_layout=True)"
            )
        return _BasisAD.apply(x, bases, comps, edges)
    else:
        src_sorted, wvec = sorted_inputs(edges, comps)
        agg = weighted_aggregate(x, src_sorted, wvec, edges.layout, edges.num_nodes)
    return closing_product(agg, bases)
