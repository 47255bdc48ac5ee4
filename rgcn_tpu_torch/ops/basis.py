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

Over a merged layout it is differentiable too (``_basis_merged_core``,
``pallas_basis.py:468-551``): the forward is K4 over ``merged.layout``
(or K5 over ``merged.fwd_dedup``) then the closing product; the backward
reads the frozen coefficients and the merged reverse frame:

    dbases_b = Agg_bᵀ g,   G_b = g @ B_bᵀ
    dx       = K4 over merged.rev_layout with the per-basis tables G
               gathered by rev_src_sorted, weights rev_coeff @ comps, sum_bases
    dcomps   = rev_coeffᵀ t,  t[l, b] = <x[rev_receiver[l]], G_b[rev_src_sorted[l]]>

The featureless layer (:func:`rel_spmm_featureless_basis_fwd`, the
counterpart of ``_fl_basis_ad_core``, ``pallas_basis.py:584-639``)
differentiates with respect to its per-basis tables and its comps:

    dbases_b = K4 over edges.reverse with the shared table g, weights
               val · comps[rel, b], one output per basis
    dcomps   = Σ_e val_e · <B_b[src_e], g[dst_e]>, summed by rel

The per-slot weight products (``coeff @ comps``), the closing product and
the backward's products are ordinary products outside the kernels; they
run in full f32 (TF32 off), as the JAX package runs them at
``precision="highest"``. K4 and K5 themselves refuse grad on the card:
the autograd Functions here call them with grad off, inside their
``forward`` and ``backward``; on the CPU the same Functions run the plain
versions.

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


def _slot_order(t: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``t[perm]`` of a per-edge vector, the pad slots (``perm == E_pad``)
    reading 0."""
    return torch.cat([t, t.new_zeros(1)])[perm]


def _slot_dots(tables: torch.Tensor, index: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """``t[l, b] = <tables[b, index[l]], rows[l]>`` as ``(L, nb)``, one
    basis at a time (the ``(nb, L, d)`` gathered rows never exist at
    once; a batched dot of each slot's ``(nb, d)`` rows runs as a slow
    gemv)."""
    return torch.stack([(tables[b].index_select(0, index) * rows).sum(-1)
                        for b in range(tables.shape[0])], 1)


def sorted_inputs(edges, comps: torch.Tensor):
    """Per-slot ``(source, basis weights (nb, L))`` of the EdgeSet's
    destination layout, from the live ``edges.val``; pads read 0. A
    source past the last node (a reversed pad edge, weight 0) is clamped
    to it, as JAX's gather clamps it. The weights ``val · comps[rel]``
    are formed in slot order, basis-major, from per-slot ``val`` and
    ``rel`` (the same products as JAX's per-edge ones)."""
    perm = edges.layout.perm.long()
    rel = _slot_order(edges.rel, perm).long()
    wvec = comps.T.index_select(1, rel) * _slot_order(edges.val, perm)
    return _slot_order(edges.src, perm).clamp_max(edges.num_nodes - 1), wvec


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


def _featureless_fwd(edges, bases, comps):
    src_sorted, wvec = sorted_inputs(edges, comps)
    return weighted_aggregate(bases, src_sorted, wvec, edges.layout,
                              edges.num_nodes, sum_bases=True)[0]


class _FeaturelessBasisAD(torch.autograd.Function):
    """The featureless basis SpMM with the VJP of ``_fl_basis_ad_core``;
    the EdgeSet rides on ``ctx``."""

    @staticmethod
    def forward(ctx, bases, comps, edges):
        ctx.edges = edges
        ctx.save_for_backward(bases, comps)
        return _featureless_fwd(edges, bases, comps)

    @staticmethod
    def backward(ctx, g):
        bases, comps = ctx.saved_tensors
        edges, rev = ctx.edges, ctx.edges.reverse
        g = g.contiguous()
        n = edges.num_nodes
        # d bases[b][n] = Σ_{e: src_e = n} val_e comps[rel_e, b] · g[dst_e]:
        # the reversed frame (receiver = source), one output per basis;
        # K4 returns a node-major view, the parameter gradient is (nb, N, dout)
        rsrc, rwvec = sorted_inputs(rev, comps)
        dbases = weighted_aggregate(g, rsrc, rwvec, rev.layout, n).contiguous()
        # d comps over the padded edge arrays, one basis at a time: pads
        # (dst == N, val 0) read the appended zero row of g
        gd = torch.cat([g, g.new_zeros((1, g.shape[1]))])[edges.dst.long()]
        t = _slot_dots(bases, edges.src.long(), gd) * edges.val[:, None]
        dcomps = torch.zeros_like(comps).index_add_(0, edges.rel.long(), t)
        return dbases, dcomps, None


def _needs_backward(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_reverse(edges, what: str) -> None:
    if edges.reverse is None or edges.reverse.layout is None:
        raise ValueError(
            f"the backward of {what} needs the EdgeSet's reversed edges with "
            "their destination layout (with_dst_layout=True)"
        )


def rel_spmm_featureless_basis_fwd(edges, bases: torch.Tensor,
                                   comps: torch.Tensor) -> torch.Tensor:
    """Featureless basis SpMM (counterpart of
    ``pallas_basis.py::rel_spmm_featureless_basis_ad``): with identity
    features ``out[s] = Σ_b Σ_{e → s} (val_e · comps[rel_e, b]) ·
    bases[b, src_e]``, so K4 over the EdgeSet's destination layout gathers
    from the per-basis tables ``bases (nb, N, dout)`` and sums over bases
    in the kernel. ``comps (R, nb)`` covers the general relations. Returns
    ``(N, dout)``. With grad enabled and ``bases`` or ``comps`` requiring
    grad it runs as an autograd Function whose backward launches K4 over
    ``edges.reverse``."""
    if _needs_backward(bases, comps):
        _check_reverse(edges, "rel_spmm_featureless_basis_fwd")
        return _FeaturelessBasisAD.apply(bases, comps, edges)
    return _featureless_fwd(edges, bases, comps)


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
        rdst = _slot_order(rev.dst, perm).clamp_max(n - 1).long()
        t = _slot_dots(G, rsrc.long(), x.index_select(0, rdst))
        t = t * _slot_order(rev.val, perm)[:, None]
        dcomps = torch.zeros_like(comps).index_add_(
            0, _slot_order(rev.rel, perm).long(), t)
        return dx.contiguous(), dbases, dcomps, None


def _merged_agg(x, comps, merged):
    """``Agg`` over the merged frame: K5 over ``fwd_dedup`` when it is set,
    else K4 over ``merged.layout``."""
    dd = merged.fwd_dedup
    if dd is not None:
        with full_f32_matmul():
            w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
        return weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, merged.num_nodes)
    return weighted_aggregate(x, merged.src_sorted, merged_wvec(merged.coeff, comps),
                              merged.layout, merged.num_nodes)


class _BasisMergedAD(torch.autograd.Function):
    """K4's (or K5's) ``Agg`` over the merged frame and the closing
    product, with the VJP of ``_basis_merged_core``; the layout rides on
    ``ctx``. Its weights come from the frozen coefficients, never from
    ``edges.val``."""

    @staticmethod
    def forward(ctx, x, bases, comps, merged):
        agg = _merged_agg(x, comps, merged)
        ctx.merged = merged
        ctx.save_for_backward(x, bases, comps, agg)
        return closing_product(agg, bases)

    @staticmethod
    def backward(ctx, g):
        x, bases, comps, agg = ctx.saved_tensors
        m = ctx.merged
        g = g.contiguous()
        nb, din, dout = bases.shape
        n = m.num_nodes
        with full_f32_matmul():
            dbases = (agg.permute(1, 0, 2).reshape(n, nb * din).T @ g
                      ).reshape(nb, din, dout)
            G = torch.matmul(g, bases.transpose(1, 2))  # (nb, N, din)
        # dx over the merged reverse frame: its sources are the forward
        # receivers; pads read slot weight 0 and are dropped by K4
        dx = weighted_aggregate(G, m.rev_src_sorted, merged_wvec(m.rev_coeff, comps),
                                m.rev_layout, n, sum_bases=True)[0]
        t = _slot_dots(G, m.rev_src_sorted.long(),
                       x.index_select(0, m.rev_receiver.long()))
        with full_f32_matmul():
            dcomps = m.rev_coeff.T @ t
        return dx.contiguous(), dbases, dcomps, None


def rel_spmm_basis(edges, x: torch.Tensor, bases: torch.Tensor,
                   comps: torch.Tensor) -> torch.Tensor:
    """Aggregation-first basis SpMM: ``bases (nb, din, dout)``, ``comps
    (R', nb)`` over the general relations only (the self-loop term is the
    caller's). Takes the EdgeSet's merged layout when it has one (K5 over
    ``merged.fwd_dedup`` when that is set, else K4), else K4 over its
    destination layout. With grad enabled and an input requiring grad it
    runs as an autograd Function: over the merged layout its backward
    launches K4 over the merged reverse frame; over the destination
    layout, K4 over ``edges.reverse`` (as the training subgraphs of
    :func:`~rgcn_tpu_torch.graph.dynamic.build_edge_set_dynamic_host` carry
    it). Returns ``(N, dout)``."""
    merged = edges.merged
    grad = _needs_backward(x, bases, comps)
    if merged is not None:
        if grad:
            return _BasisMergedAD.apply(x, bases, comps, merged)
        agg = _merged_agg(x, comps, merged)
    elif edges.layout is None:
        raise ValueError(
            "rel_spmm_basis needs an EdgeSet with a merged or destination "
            "layout (build_edge_set(..., with_dst_layout=True))"
        )
    elif grad:
        _check_reverse(edges, "rel_spmm_basis")
        return _BasisAD.apply(x, bases, comps, edges)
    else:
        src_sorted, wvec = sorted_inputs(edges, comps)
        agg = weighted_aggregate(x, src_sorted, wvec, edges.layout, edges.num_nodes)
    return closing_product(agg, bases)
