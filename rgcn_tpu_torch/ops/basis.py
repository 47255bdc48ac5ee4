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

Compute dtype (``compute_dtype``, the counterpart of the JAX functions'
argument; :func:`rgcn_tpu_torch.nn.layers._edge_compute_dtype` chooses
it: bf16 on the card, None on the CPU). With bf16 the tables K4 and K5
gather are cast to bf16 before they reach the kernel, where JAX casts
them before its gather: ``x`` (and in the backward the per-basis
cotangent tables ``G``) for the featureful ops, the per-basis tables for
the featureless one (and its shared cotangent table ``g``). The kernels'
bf16 forms round each weight to bf16 and sum in f32; the featureful ops'
``Agg`` and ``dx`` come out bf16 (JAX's ``out_dtype=compute_dtype``), the
featureless forward and ``dbases`` f32. The closing product and ``dbases
= Aggᵀ g`` promote a bf16 ``Agg`` to f32, as JAX's einsum does, and
``dcomps`` sums f32 products of the bf16 rows (JAX's
``preferred_element_type=f32``). None keeps everything f32.

bf16 parameters (the layers' ``param_dtype``): ``bases`` and ``comps``
meet f32 operands in the products outside the kernels, where the JAX
functions rely on promotion; here each such product widens the bf16
operand exactly first (``.float()``: these products are full f32 whatever
their operands' dtypes, as the closing product always was). Every gradient comes back in
its input's dtype, summed in f32 and rounded once, as the JAX VJPs end
in ``.astype(bases.dtype)``, ``.astype(comps.dtype)`` and
``.astype(x.dtype)``. A featureless layer's bf16 ``bases`` reach K4 as a
bf16 table (the bf16 form), as JAX's kernel gathers them.

Snapshot of ``val``: over a merged layout the weights come from
``merged.coeff`` (or ``fwd_dedup.coeff_k``), which froze the EdgeSet's
``val`` when the layout was built; only the unmerged path
(:func:`sorted_inputs`) reads ``edges.val`` as it is now. An EdgeSet whose
``val`` changes must rebuild or drop ``merged`` before it reaches
:func:`rel_spmm_basis`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from rgcn_tpu_torch import kernels
from rgcn_tpu_torch.ops.ordered import index_sum

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
def full_f32_matmul(tf32: bool = False):
    """Matmuls in full f32 on the card (TF32 off) for the block's length;
    ``tf32=True`` turns the card's TF32 path on instead (the passes of a
    3xTF32 product, ``ops/spmm.py::product``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
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


def _table_weights(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The weights as the kernels use them: rounded to a bf16 table's dtype
    (the Pallas kernels' ``w.astype(xg.dtype)``), kept f32 otherwise."""
    return w if x.dtype == torch.float32 else w.to(x.dtype).float()


def _node_major(out: torch.Tensor, num_nodes: int, out_dtype) -> torch.Tensor:
    """The f32 sums' first ``num_nodes`` rows, narrowed once to
    ``out_dtype``, as the ``(nb, num_nodes, din)`` view of node-major
    storage."""
    return out[:num_nodes].to(out_dtype).permute(1, 0, 2)


def weighted_aggregate_plain(x, src, w, layout, num_nodes: int, *,
                             sum_bases: bool = False,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K4: ``Agg[b, n] = Σ_{slots l → n} w[b, l] ·
    row(b, l)`` with ``row(b, l) = x[src[l]]`` (shared ``(rows, din)``
    table) or ``x[b, src[l]]`` (per-basis ``(nb, rows, din)`` tables), pads
    (``local_dst == RB``) dropped. ``sum_bases`` sums over ``b``. ``x`` f32
    or bf16: a bf16 table's rows widen exactly and its weights round to
    bf16, the products (exact) and sums are f32, and ``out_dtype`` (bf16
    only for a bf16 table) narrows the sums once. Returns ``(nb or 1,
    num_nodes, din)``, a view of node-major storage."""
    kernels.table_form(x, "x", out_dtype)
    local = layout.local_dst.reshape(-1).long()
    keep = local < layout.row_block
    rows = _slot_rows(layout, local)[keep]
    s = src.long()[keep]
    wk = _table_weights(x, w[:, keep]).T[:, :, None]  # (slots, nb, 1)
    xs = x[s][:, None] if x.dim() == 2 else x[:, s].transpose(0, 1)
    msgs = wk * xs.float()
    if sum_bases:
        msgs = msgs.sum(1, keepdim=True)
    out = torch.zeros(
        (layout.num_row_blocks * layout.row_block, msgs.shape[1], x.shape[-1]),
        dtype=torch.float32, device=x.device,
    )
    out.index_add_(0, rows, msgs)
    return _node_major(out, num_nodes, out_dtype)


def weighted_aggregate(x, src, w, layout, num_nodes: int, *,
                       sum_bases: bool = False,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K4 over a destination-sorted frame: ``x`` f32 or bf16 ``(rows,
    din)`` or ``(nb, rows, din)``, ``src (L,)`` int32 per-slot source rows,
    ``w (nb, L)`` f32 per-slot weights, ``layout`` a DstLayout of ``L``
    slots. A bf16 ``x`` takes K4's bf16 form (weights rounded to bf16, f32
    sums); ``out_dtype`` f32, or bf16 with a bf16 ``x``. Returns ``(nb or
    1, num_nodes, din)``, a view of node-major storage. No backward: on the
    card, grad mode with ``x`` or ``w`` requiring grad raises."""
    if w.shape[-1] != layout.num_chunks * layout.chunk:
        raise ValueError(
            f"{w.shape[-1]} slot weights for a layout of "
            f"{layout.num_chunks * layout.chunk} slots"
        )
    _check_nodes(layout, num_nodes)
    if x.device.type == "cpu":
        return weighted_aggregate_plain(x, src, w, layout, num_nodes,
                                        sum_bases=sum_bases, out_dtype=out_dtype)
    kernels.refuse_grad("weighted_aggregate (K4)", x, w)
    return kernels.launch_k4_weighted_aggregate(
        x, src, w, layout.local_dst, layout.chunk_block, num_nodes,
        layout.row_block, layout.num_row_blocks, sum_bases=sum_bases,
        out_dtype=out_dtype,
    )


def weighted_aggregate_dedup_plain(x, src, w_k, dd, num_nodes: int, *,
                                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K5: ``Agg[b, n] = Σ_{slots l, lanes k → n}
    w_k[k, b, l] · x[src[l]]`` over a DedupFwdLayout ``dd``, empty lanes
    (``local_k == RB``) dropped; dtypes as :func:`weighted_aggregate_plain`'s.
    Returns ``(nb, num_nodes, din)``, a view of node-major storage."""
    kernels.table_form(x, "x", out_dtype)
    kk = dd.local_k.shape[0]
    local = dd.local_k.reshape(kk, -1).long()
    xg = x[src.long()].float()
    w_k = _table_weights(x, w_k)
    out = torch.zeros(
        (dd.num_row_blocks * dd.row_block, w_k.shape[1], x.shape[-1]),
        dtype=torch.float32, device=x.device,
    )
    for k in range(kk):
        keep = local[k] < dd.row_block
        out.index_add_(0, _slot_rows(dd, local[k])[keep],
                       w_k[k][:, keep].T[:, :, None] * xg[keep][:, None])
    return _node_major(out, num_nodes, out_dtype)


def weighted_aggregate_dedup(x, src, w_k, dd, num_nodes: int, *,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K5 over a source-dedup'd frame: ``x (rows, din)`` f32 or bf16 (K5's
    bf16 form, as :func:`weighted_aggregate`'s), ``src (Ld,)`` int32, ``w_k
    (K, nb, Ld)`` f32 per-lane weights. Returns ``(nb, num_nodes, din)`` of
    ``out_dtype``, a view of node-major storage. No backward: on the card,
    grad mode with ``x`` or ``w_k`` requiring grad raises."""
    if tuple(w_k.shape[::2]) != (dd.num_k, dd.num_chunks * dd.chunk):
        raise ValueError(
            f"lane weights {tuple(w_k.shape)} for a frame of {dd.num_k} "
            f"lanes and {dd.num_chunks * dd.chunk} slots"
        )
    _check_nodes(dd, num_nodes)
    if x.device.type == "cpu":
        return weighted_aggregate_dedup_plain(x, src, w_k, dd, num_nodes,
                                              out_dtype=out_dtype)
    kernels.refuse_grad("weighted_aggregate_dedup (K5)", x, w_k)
    return kernels.launch_k5_weighted_aggregate_dedup(
        x, src, w_k, dd.local_k, dd.chunk_block, num_nodes, dd.row_block,
        dd.num_row_blocks, out_dtype=out_dtype,
    )


def _slot_order(t: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``t[perm]`` of a per-edge vector, the pad slots (``perm == E_pad``)
    reading 0."""
    return torch.cat([t, t.new_zeros(1)])[perm]


def _slot_dots(tables: torch.Tensor, index: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """``t[l, b] = <tables[b, index[l]], rows[l]>`` as ``(L, nb)`` f32, one
    basis at a time (the ``(nb, L, d)`` gathered rows never exist at
    once; a batched dot of each slot's ``(nb, d)`` rows runs as a slow
    gemv). bf16 operands widen to f32 first: each product is exact and the
    sums are f32 (JAX's ``preferred_element_type=f32``)."""
    rows = rows.float()
    return torch.stack([(tables[b].index_select(0, index).float() * rows).sum(-1)
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
    coefficients, in full f32 (bf16 ``comps`` widened)."""
    with full_f32_matmul():
        return (coeff @ comps.float()).T.contiguous()


def _narrow(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``t`` cast to the compute dtype (None: as it is)."""
    return t if compute_dtype is None else t.to(compute_dtype)


def _agg_dtype(compute_dtype) -> torch.dtype:
    """The dtype K4/K5 write ``Agg`` and ``dx`` in (JAX's ``out_dtype=
    compute_dtype or float32``)."""
    return compute_dtype or torch.float32


def closing_product(agg: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """``Σ_b agg[b] @ bases[b]`` for ``agg (nb, N, din)`` and ``bases (nb,
    din, dout)``, as one full-f32 ``(N, nb·din) @ (nb·din, dout)`` product
    (a bf16 ``agg`` or ``bases`` promoted to f32, as JAX's einsum promotes
    them). Over the node-major storage K4/K5 and their plain versions
    return, ``agg.permute(1, 0, 2)`` is contiguous and the reshape copies
    nothing."""
    nb, n, din = agg.shape
    with full_f32_matmul():
        return (agg.permute(1, 0, 2).reshape(n, nb * din).float()
                @ bases.reshape(nb * din, -1).float())


def _agg_grad(agg: torch.Tensor, g: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """``dbases_b = Agg_bᵀ g`` for every basis, as one full-f32 ``(nb·din,
    N) @ (N, dout)`` product (a bf16 ``Agg`` promoted to f32), rounded once
    to the bases' dtype."""
    nb, din, dout = bases.shape
    with full_f32_matmul():
        return (agg.permute(1, 0, 2).reshape(g.shape[0], nb * din).float().T @ g
                ).reshape(nb, din, dout).to(bases.dtype)


def _cotangent_rows(g: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """``G_b = g @ B_bᵀ`` ``(nb, N, din)`` in full f32 (bf16 bases
    widened)."""
    with full_f32_matmul():
        return torch.matmul(g, bases.float().transpose(1, 2))


def _rel_sums(t: torch.Tensor, rel: torch.Tensor, comps: torch.Tensor,
              sorted_rel: bool = False) -> torch.Tensor:
    """``dcomps[r] = Σ_{rows of rel r} t`` in f32 and in an order ``rel``
    fixes (:func:`~rgcn_tpu_torch.ops.ordered.index_sum`; ``sorted_rel``:
    ``rel`` is non-decreasing, an EdgeSet's edge order), rounded once to
    the comps' dtype (JAX's ``segment_sum(t).astype(comps.dtype)``)."""
    return index_sum(t, rel, comps.shape[0], sorted_index=sorted_rel).to(comps.dtype)


def _featureless_fwd(edges, bases, comps, compute_dtype):
    src_sorted, wvec = sorted_inputs(edges, comps)
    return weighted_aggregate(_narrow(bases, compute_dtype), src_sorted, wvec,
                              edges.layout, edges.num_nodes, sum_bases=True)[0]


class _FeaturelessBasisAD(torch.autograd.Function):
    """The featureless basis SpMM with the VJP of ``_fl_basis_ad_core``;
    the EdgeSet rides on ``ctx``."""

    @staticmethod
    def forward(ctx, bases, comps, edges, compute_dtype):
        ctx.edges, ctx.compute_dtype = edges, compute_dtype
        ctx.save_for_backward(bases, comps)
        return _featureless_fwd(edges, bases, comps, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        bases, comps = ctx.saved_tensors
        edges, rev, cd = ctx.edges, ctx.edges.reverse, ctx.compute_dtype
        gc = _narrow(g.contiguous(), cd)
        n = edges.num_nodes
        # d bases[b][n] = Σ_{e: src_e = n} val_e comps[rel_e, b] · g[dst_e]:
        # the reversed frame (receiver = source), one output per basis;
        # K4 returns a node-major view, the parameter gradient is (nb, N, dout)
        rsrc, rwvec = sorted_inputs(rev, comps)
        dbases = weighted_aggregate(gc, rsrc, rwvec, rev.layout, n).contiguous().to(
            bases.dtype)
        # d comps over the padded edge arrays, one basis at a time: pads
        # (dst == N, val 0) read the appended zero row of g
        gd = torch.cat([gc, gc.new_zeros((1, gc.shape[1]))])[edges.dst.long()]
        t = _slot_dots(_narrow(bases, cd), edges.src.long(), gd) * edges.val[:, None]
        return dbases, _rel_sums(t, edges.rel.long(), comps, sorted_rel=True), None, None


def _needs_backward(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_reverse(edges, what: str) -> None:
    if edges.reverse is None or edges.reverse.layout is None:
        raise ValueError(
            f"the backward of {what} needs the EdgeSet's reversed edges with "
            "their destination layout (with_dst_layout=True)"
        )


def rel_spmm_featureless_basis_fwd(edges, bases: torch.Tensor, comps: torch.Tensor,
                                   compute_dtype: Optional[torch.dtype] = None
                                   ) -> torch.Tensor:
    """Featureless basis SpMM (counterpart of
    ``pallas_basis.py::rel_spmm_featureless_basis_ad``): with identity
    features ``out[s] = Σ_b Σ_{e → s} (val_e · comps[rel_e, b]) ·
    bases[b, src_e]``, so K4 over the EdgeSet's destination layout gathers
    from the per-basis tables ``bases (nb, N, dout)`` and sums over bases
    in the kernel. ``comps (R, nb)`` covers the general relations. Returns
    ``(N, dout)`` f32. ``compute_dtype`` (bf16 or None) is the tables'
    dtype at the kernel (see the module docstring). With grad enabled and
    ``bases`` or ``comps`` requiring grad it runs as an autograd Function
    whose backward launches K4 over ``edges.reverse``."""
    if _needs_backward(bases, comps):
        _check_reverse(edges, "rel_spmm_featureless_basis_fwd")
        return _FeaturelessBasisAD.apply(bases, comps, edges, compute_dtype)
    return _featureless_fwd(edges, bases, comps, compute_dtype)


class _BasisAD(torch.autograd.Function):
    """K4's ``Agg`` over an unmerged destination layout and the closing
    product, with the VJP of ``_basis_ad_core``; the EdgeSet rides on
    ``ctx``."""

    @staticmethod
    def forward(ctx, x, bases, comps, edges, compute_dtype):
        src_sorted, wvec = sorted_inputs(edges, comps)
        agg = weighted_aggregate(_narrow(x, compute_dtype), src_sorted, wvec,
                                 edges.layout, edges.num_nodes,
                                 out_dtype=_agg_dtype(compute_dtype))
        ctx.edges, ctx.compute_dtype = edges, compute_dtype
        ctx.save_for_backward(x, bases, comps, agg)
        return closing_product(agg, bases)

    @staticmethod
    def backward(ctx, g):
        x, bases, comps, agg = ctx.saved_tensors
        edges, rev, cd = ctx.edges, ctx.edges.reverse, ctx.compute_dtype
        g = g.contiguous()
        n = edges.num_nodes
        dbases = _agg_grad(agg, g, bases)
        G = _narrow(_cotangent_rows(g, bases), cd)  # cast before the gather, as JAX does
        rsrc, rwvec = sorted_inputs(rev, comps)
        dx = weighted_aggregate(G, rsrc, rwvec, rev.layout, n, sum_bases=True,
                                out_dtype=_agg_dtype(cd))[0]
        # dcomps in the reverse frame: the reverse slots' sources are the
        # forward receivers, their receivers the forward sources
        perm = rev.layout.perm.long()
        rdst = _slot_order(rev.dst, perm).clamp_max(n - 1).long()
        t = _slot_dots(G, rsrc.long(), _narrow(x, cd).index_select(0, rdst))
        t = t * _slot_order(rev.val, perm)[:, None]
        dcomps = _rel_sums(t, _slot_order(rev.rel, perm).long(), comps)
        return dx.to(x.dtype).contiguous(), dbases, dcomps, None, None


def _merged_agg(x, comps, merged, compute_dtype=None):
    """``Agg`` over the merged frame: K5 over ``fwd_dedup`` when it is set,
    else K4 over ``merged.layout``; ``x`` cast to the compute dtype first."""
    xc, out_dtype = _narrow(x, compute_dtype), _agg_dtype(compute_dtype)
    dd = merged.fwd_dedup
    if dd is not None:
        with full_f32_matmul():
            w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps.float()).contiguous()
        return weighted_aggregate_dedup(xc, dd.src_sorted, w_k, dd, merged.num_nodes,
                                        out_dtype=out_dtype)
    return weighted_aggregate(xc, merged.src_sorted, merged_wvec(merged.coeff, comps),
                              merged.layout, merged.num_nodes, out_dtype=out_dtype)


class _BasisMergedAD(torch.autograd.Function):
    """K4's (or K5's) ``Agg`` over the merged frame and the closing
    product, with the VJP of ``_basis_merged_core``; the layout rides on
    ``ctx``. Its weights come from the frozen coefficients, never from
    ``edges.val``."""

    @staticmethod
    def forward(ctx, x, bases, comps, merged, compute_dtype):
        agg = _merged_agg(x, comps, merged, compute_dtype)
        ctx.merged, ctx.compute_dtype = merged, compute_dtype
        ctx.save_for_backward(x, bases, comps, agg)
        return closing_product(agg, bases)

    @staticmethod
    def backward(ctx, g):
        x, bases, comps, agg = ctx.saved_tensors
        m, cd = ctx.merged, ctx.compute_dtype
        g = g.contiguous()
        n = m.num_nodes
        dbases = _agg_grad(agg, g, bases)
        G = _narrow(_cotangent_rows(g, bases), cd)
        # dx over the merged reverse frame: its sources are the forward
        # receivers; pads read slot weight 0 and are dropped by K4
        dx = weighted_aggregate(G, m.rev_src_sorted, merged_wvec(m.rev_coeff, comps),
                                m.rev_layout, n, sum_bases=True,
                                out_dtype=_agg_dtype(cd))[0]
        t = _slot_dots(G, m.rev_src_sorted.long(),
                       _narrow(x, cd).index_select(0, m.rev_receiver.long()))
        with full_f32_matmul():
            dcomps = (m.rev_coeff.T @ t).to(comps.dtype)
        return dx.to(x.dtype).contiguous(), dbases, dcomps, None, None


def rel_spmm_basis(edges, x: torch.Tensor, bases: torch.Tensor,
                   comps: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Aggregation-first basis SpMM: ``bases (nb, din, dout)``, ``comps
    (R', nb)`` over the general relations only (the self-loop term is the
    caller's). Takes the EdgeSet's merged layout when it has one (K5 over
    ``merged.fwd_dedup`` when that is set, else K4), else K4 over its
    destination layout. ``compute_dtype`` (bf16 or None) is the gathered
    tables' and ``Agg``'s dtype (see the module docstring). With grad
    enabled and an input requiring grad it runs as an autograd Function:
    over the merged layout its backward launches K4 over the merged reverse
    frame; over the destination layout, K4 over ``edges.reverse`` (as the
    training subgraphs of
    :func:`~rgcn_tpu_torch.graph.dynamic.build_edge_set_dynamic_host` carry
    it). Returns ``(N, dout)`` f32."""
    merged = edges.merged
    grad = _needs_backward(x, bases, comps)
    if merged is not None:
        if grad:
            return _BasisMergedAD.apply(x, bases, comps, merged, compute_dtype)
        agg = _merged_agg(x, comps, merged, compute_dtype)
    elif edges.layout is None:
        raise ValueError(
            "rel_spmm_basis needs an EdgeSet with a merged or destination "
            "layout (build_edge_set(..., with_dst_layout=True))"
        )
    elif grad:
        _check_reverse(edges, "rel_spmm_basis")
        return _BasisAD.apply(x, bases, comps, edges, compute_dtype)
    else:
        src_sorted, wvec = sorted_inputs(edges, comps)
        agg = weighted_aggregate(_narrow(x, compute_dtype), src_sorted, wvec,
                                 edges.layout, edges.num_nodes,
                                 out_dtype=_agg_dtype(compute_dtype))
    return closing_product(agg, bases)
