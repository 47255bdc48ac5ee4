"""Plain-PyTorch relational SpMM: the oracle paths.

Counterpart of ``rgcn_tpu/ops/spmm.py``: every weight layout computes

    out[d] = Σ_{e: dst_e = d} val_e · (X[src_e] @ W[rel_e])

over a relation-sorted, tile-padded EdgeSet, with the destination sum as
one ``index_add_`` into ``num_nodes + 1`` rows (the last swallows pads).
Layers take these paths when the EdgeSet has no destination layout.

The many-basis paths over an EdgeSet's unique-(src, rel) pair index
(``edges.pairs``, the JAX trainer's route for more than 8 bases) contract
the basis rows once per pair (:func:`pair_contract`) and hand the pair
messages to K1 through the composed layout
(:func:`~rgcn_tpu_torch.ops.aggregate.aggregate_pairs`); the wide gather's
backward is K1 too (:func:`gather_rows_agg`), so the training step has no
scatter.

``compute_dtype`` (bf16 on the card, chosen by
:func:`rgcn_tpu_torch.nn.layers._edge_compute_dtype`; None keeps f32) is
the dtype of the basis-row gather table, cast where JAX casts it
(``ops/spmm.py:190-290``, ``:460-493``): the featureless ``bases`` and the
featureful ``H`` before the gather, the coefficients with them. The
per-tile and grouped contractions take exact products of the bf16 values
and sum them in f32; the ungrouped pair contraction rounds each term
``rows · coef`` to bf16 before its f32 sum, where JAX's GEMM form
(``_expand_collapse``, ``ops/spmm.py:434-439``) rounds it. The messages
that reach K1 are f32, as in JAX. The coefficients are rounded to the
compute dtype and widened back before their gather (the same values), so
their gradient sums in f32 and rounds once to bf16, where JAX's bf16
gather scatter-adds in bf16.

bf16 parameters (the layers' ``param_dtype``): each product of a bf16
parameter with an f32 operand widens the parameter exactly first
(:func:`product`), where ``jnp`` promotes it.
The gather table keeps its own dtype: a featureless layer's bf16 bases
are gathered as bf16 (the ungrouped pair contraction then rounds each
term to bf16, as JAX's GEMM form does for a bf16 table) and widened
exactly for the per-tile contraction. A bf16 table's gradient sums in f32
and rounds once (:func:`gather_rows`), where JAX's bf16 gather
scatter-adds in bf16, rounding every update, as the coefficients' above.

``precision`` (the four ops JAX gives it to: :func:`rel_spmm`,
:func:`rel_spmm_block`, :func:`rel_spmm_featureless_basis`,
:func:`rel_spmm_basis_pairs`): the name of a ``jax.lax.Precision``, None,
``"default"``, ``"high"`` or ``"highest"``, for the products these ops
compute with XLA einsums in JAX (:func:`product`). None, ``"default"``
and ``"highest"`` run in full f32 (TF32 off), which is what JAX computes
on the CPU the tests compare with; ``"high"`` runs 3xTF32, each f32
operand split into a TF32 high part and its f32 remainder, three products
on the card's TF32 path (``lo·hi + hi·lo + hi·hi``, about 21 bits of
each product). Any other value raises.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from rgcn_tpu_torch.device import check_plain_path
from rgcn_tpu_torch.ops.aggregate import aggregate_pairs, aggregate_sorted
from rgcn_tpu_torch.ops.basis import _narrow, full_f32_matmul
from rgcn_tpu_torch.ops.ordered import select_rows

__all__ = [
    "aggregate_messages",
    "gather_rows",
    "gather_rows_agg",
    "pair_contract",
    "pair_fan_aggregate",
    "PRECISIONS",
    "check_precision",
    "product",
    "rel_spmm",
    "rel_spmm_basis_pairs",
    "rel_spmm_block",
    "rel_spmm_diag",
    "rel_spmm_featureless",
    "rel_spmm_featureless_basis",
]

# Cap (elements) on the gathered basis rows of the featureless basis
# contraction, as in the JAX package; above it, tile groups run one after
# another. Module-level so tests can lower it and reach the grouped branch.
_ELEM_BUDGET = 64_000_000
# The same cap for the gathered rows of the pair contraction (the JAX
# package's 512M): nc-AM's layers, 236M and 260M elements at AM scale, stay
# ungrouped. Module-level so tests can lower it.
_PAIR_ELEM_BUDGET = 512_000_000


# the jax.lax.Precision names the XLA-route ops take (None: XLA's default)
PRECISIONS = (None, "default", "high", "highest")


def check_precision(precision) -> bool:
    """Is ``precision`` ``"high"`` (3xTF32)? None, ``"default"`` and
    ``"highest"`` are full f32; anything else raises."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS} "
                         "(the names of jax.lax.Precision)")
    return precision == "high"


def _tf32_low(t: torch.Tensor) -> torch.Tensor:
    """The f32 remainder of ``t`` past its TF32 high part (``t`` with its
    low 13 mantissa bits cleared), detached: ``t - low`` is that high part,
    exactly, and carries ``t``'s gradient."""
    t = t.detach().contiguous()
    return t - (t.view(torch.int32) & -8192).view(torch.float32)


def product(fn, a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """``fn(a, b)``, a product bilinear in its operands (``torch.bmm``,
    ``torch.matmul``, an einsum of two), of the operands promoted to one
    dtype (a bf16 parameter widened exactly, as ``jnp`` promotes it), at
    ``precision`` (:func:`check_precision`): full f32, or, for ``"high"``
    on f32 operands, 3xTF32 from split operands, ``fn(a_lo, b_hi) +
    fn(a_hi, b_lo) + fn(a_hi, b_hi)`` with TF32 on. The split parts carry
    the gradient as ``a`` and ``b`` (the low parts are constants, the high
    parts ``a - a_lo``), so the backward is autograd's of ``fn``, in full
    f32. On the CPU the three products are exact f32 and sum to the full
    f32 product up to rounding."""
    high = check_precision(precision)
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    if not high or a.dtype != torch.float32:
        with full_f32_matmul():
            return fn(a, b)
    a_lo, b_lo = _tf32_low(a), _tf32_low(b)
    a_hi, b_hi = a - a_lo, b - b_lo
    with full_f32_matmul(tf32=True):
        return fn(a_lo, b_hi) + fn(a_hi, b_lo) + fn(a_hi, b_hi)


def aggregate_messages(
    messages: torch.Tensor, dst: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """Scatter-add per-edge messages ``(E, dout)`` into ``(N, dout)``;
    pad edges target row ``num_nodes``, which is sliced off."""
    out = messages.new_zeros((num_nodes + 1, messages.shape[-1]))
    out.index_add_(0, dst.long(), messages)
    return out[:num_nodes]


def rel_spmm(edges, x: torch.Tensor, weights: torch.Tensor, *,
             precision=None) -> torch.Tensor:
    """Dense-weight relational SpMM; ``weights (R, din, dout)`` covers the
    general relations only (the caller adds the self-loop densely).
    ``precision``: the per-tile products' (see the module docstring)."""
    tile, n_tiles = edges.tile_size, edges.num_tiles
    xg = x[edges.src.long()].reshape(n_tiles, tile, x.shape[-1])
    msgs = product(torch.bmm, xg, weights[edges.tile_rel.long()], precision)
    msgs = msgs.reshape(n_tiles * tile, -1) * edges.val[:, None]
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)


def _blockwise(xg: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    return torch.einsum("tnbi,tbio->tnbo", xg, b_t)


def rel_spmm_block(edges, x: torch.Tensor, blocks: torch.Tensor, *,
                   precision=None, aggregate=None) -> torch.Tensor:
    """Block-diagonal-weight SpMM; ``blocks (R, B, din // B, dout // B)``
    covers the general relations. Messages are computed blockwise, one
    ``(B, ib) @ (B, ib, ob)`` product per edge, so the block-diagonal
    matrix never exists; ``aggregate(msgs, edges)`` overrides the
    destination sum (e.g. K1 over the EdgeSet's layout). ``precision``:
    the blockwise products' (see the module docstring)."""
    tile, n_tiles = edges.tile_size, edges.num_tiles
    _, nb, ib, ob = blocks.shape
    xg = x[edges.src.long()].reshape(n_tiles, tile, nb, ib)
    msgs = product(_blockwise, xg, blocks[edges.tile_rel.long()], precision)
    msgs = msgs.reshape(n_tiles * tile, nb * ob) * edges.val[:, None]
    if aggregate is not None:
        return aggregate(msgs, edges)
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)


def rel_spmm_diag(edges, x: torch.Tensor, diag_weights: torch.Tensor, *,
                  aggregate=None) -> torch.Tensor:
    """Diagonal-weight SpMM (the e-RGCN first layer): the message of edge
    ``(src, rel)`` is ``x[src] ⊙ dw[rel] · val``, an elementwise product.
    ``diag_weights (R, d)`` covers the general relations (the self-loop
    term is the caller's); ``aggregate(msgs, edges)`` overrides the
    destination sum (e.g. K1 over the EdgeSet's layout). bf16 weights'
    gradient sums in f32 (:func:`gather_rows`), as JAX's diagonal VJP's
    does."""
    msgs = x[edges.src.long()] * gather_rows(diag_weights, edges.rel.long()) \
        * edges.val[:, None]
    if aggregate is not None:
        return aggregate(msgs, edges)
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)


def rel_spmm_featureless(edges, weights: torch.Tensor, *, aggregate=None) -> torch.Tensor:
    """Featureless SpMM (one-hot identity features): the message of edge
    ``(src, rel)`` is row ``src`` of ``W[rel]``, a gather.

    ``weights (R, N, dout)``; ``aggregate(msgs, edges)`` overrides the
    destination sum (e.g. K1 over the EdgeSet's layout). An f32 table's
    gradient sums by indexing's accumulating ``index_put_`` (a fixed order
    on the card), a bf16 table's the same way in f32, rounded once
    (:func:`gather_rows`).
    """
    num_rels, n_rows, dout = weights.shape
    flat = weights.reshape(num_rels * n_rows, dout)
    idx = edges.rel.long() * n_rows + edges.src.long()
    rows = flat[idx] if flat.dtype == torch.float32 else gather_rows(flat, idx)
    msgs = rows * edges.val[:, None]
    if aggregate is not None:
        return aggregate(msgs, edges)
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (``idx`` int64) widened to f32 after the gather (a
    bf16 table's rows read at their own width); with a gradient to keep,
    the gradient sums the rows' f32 cotangents in a fixed order and rounds
    once to a narrow table's dtype
    (:func:`~rgcn_tpu_torch.ops.ordered.select_rows`)."""
    return select_rows(table, idx, torch.float32)


def _rounded(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``t`` rounded to the compute dtype and widened back to f32 (None:
    as it is)."""
    return t if compute_dtype is None else t.to(compute_dtype).float()


def rel_spmm_featureless_basis(edges, bases: torch.Tensor, comps: torch.Tensor, *,
                               precision=None, aggregate=None,
                               compute_dtype=None) -> torch.Tensor:
    """Featureless SpMM under basis decomposition, without expanding
    ``comps @ bases`` to ``(R, N, dout)``: the message of edge ``(src,
    rel)`` is ``Σ_b comps[rel, b] · bases[b, src]``, a contraction of the
    gathered basis rows per relation-uniform tile.

    ``bases (nb, N, dout)``, ``comps (R, nb)`` over the general relations
    (the self-loop term is the caller's). With ``edges.pairs`` the rows
    are contracted once per unique (src, rel) pair (:func:`pair_contract`)
    and fanned out to the edges (:func:`pair_fan_aggregate`). Otherwise,
    per edge: the gather table is node-major
    with the basis innermost, ``(N, dout, nb)``, so a group of ``g`` tiles
    contracts as one ``(g, tile·dout, nb) @ (g, nb, 1)`` product of the
    gathered rows as they lie, widened to f32 (exact products, f32 sums,
    at ``precision``). While ``E_pad·nb·dout`` exceeds
    :data:`_ELEM_BUDGET`, tiles go in groups whose size divides the tile
    count (the JAX package's search), so the gathered rows of one group
    exist at a time, each group's messages written into one buffer.
    ``aggregate(msgs, edges)`` overrides the destination sum (e.g. K1 over
    the EdgeSet's layout). ``compute_dtype``: the gather table's dtype (see
    the module docstring).
    """
    tile, n_tiles = edges.tile_size, edges.num_tiles
    nb, n_rows, dout = bases.shape
    table = _narrow(bases, compute_dtype).permute(1, 2, 0).contiguous().view(
        n_rows, dout * nb)
    if edges.pairs is not None:
        m = pair_contract(table, comps, edges.pairs, nb, dout, compute_dtype, precision)
        return pair_fan_aggregate(m, edges, aggregate)
    coef = _rounded(comps, compute_dtype).float()[edges.tile_rel.long()][:, :, None]
    group = n_tiles
    if n_tiles * tile * nb * dout > _ELEM_BUDGET:
        group = max(1, _ELEM_BUDGET // (tile * nb * dout))
        while n_tiles % group:
            group -= 1
    src = edges.src.long()
    if group < n_tiles and table.requires_grad:
        # one f32 copy of a bf16 table: the groups' gradients summed in f32
        # and rounded once, at the cast
        table = table.float()

    def contract(t0):  # (group·tile, dout) f32 messages of tiles t0 on
        lo, hi = t0 * tile, (t0 + group) * tile
        rows = gather_rows(table, src[lo:hi]).view(group, tile * dout, nb)
        return product(torch.bmm, rows, coef[t0:t0 + group], precision).view(-1, dout)

    if group == n_tiles:
        msgs = contract(0)
    else:  # each group's messages written in place (autograd records the copy)
        msgs = torch.empty((n_tiles * tile, dout), dtype=torch.float32,
                           device=bases.device)
        for t0 in range(0, n_tiles, group):
            msgs[t0 * tile:(t0 + group) * tile] = contract(t0)
    msgs = msgs * edges.val[:, None]
    if aggregate is not None:
        return aggregate(msgs, edges)
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)


class _GatherRowsAgg(torch.autograd.Function):
    """``table[idx]``; backward K1 over ``layout`` through its perm."""

    @staticmethod
    def forward(ctx, table, idx, layout):
        ctx.layout, ctx.num_rows = layout, table.shape[0]
        return table.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, g):
        # K1 sums in f32; the gradient carries the table's dtype, as JAX's
        # _gather_rows_agg_rev narrows it
        d_table = aggregate_sorted(g.contiguous(), ctx.layout, ctx.num_rows)
        return d_table.to(g.dtype), None, None


def gather_rows_agg(table: torch.Tensor, idx: torch.Tensor, layout) -> torch.Tensor:
    """``table[idx]`` whose gradient is a destination sum instead of a
    scatter (counterpart of ``_gather_rows_agg_bwd``, ``ops/spmm.py:369-395``):
    ``layout`` is a DstLayout over ``idx`` with ``table.shape[0]``
    segments, and ``d_table = Σ_{u: idx_u = n} g[u]`` is K1 reading the
    rows of ``g`` through ``layout.perm`` (pad slots are never read, so
    ``g`` is not copied). Without grad, the gather alone."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table.index_select(0, idx.long())
    return _GatherRowsAgg.apply(table, idx, layout)


def _contract(rows: torch.Tensor, coef: torch.Tensor, dout: int, nb: int,
              precision=None) -> torch.Tensor:
    """``m[u] = rows[u] · coef[u]`` for rows laid out ``(dout, nb)``."""
    return product(torch.bmm, rows.view(-1, dout, nb), coef.unsqueeze(-1),
                   precision).view(-1, dout)


def _contract_group(table, src, coef, dout, nb, precision):
    return _contract(gather_rows(table, src), coef, dout, nb, precision)


def _contract_rounded(rows: torch.Tensor, coef: torch.Tensor, dout: int,
                      nb: int, dtype: torch.dtype) -> torch.Tensor:
    """:func:`_contract` with each term ``rows · coef`` (values of
    ``dtype``) taken in ``dtype``, rounded, before the f32 sum: JAX's GEMM
    form ``dot(rows * c_wide, collapse, preferred_element_type=f32)``,
    whose backward rounds each product to ``dtype`` too."""
    return (rows.view(-1, dout, nb).to(dtype) * coef.to(dtype)[:, None, :]).float().sum(-1)


def pair_contract(table: torch.Tensor, comps: torch.Tensor, pairs, nb: int,
                  dout: int, compute_dtype=None, precision=None) -> torch.Tensor:
    """Per-pair contraction ``m[u] = Σ_b comps[pair_rel_u, b] ·
    table[pair_src_u][:, b]`` (counterpart of ``_pair_contract``,
    ``ops/spmm.py:410-456``) of a ``(N, dout·nb)`` table laid out ``(N,
    dout, nb)`` (basis innermost); returns ``(U_pad, dout)`` in full f32.

    The rows are gathered through :func:`gather_rows_agg` when
    ``pairs.src_layout`` exists and contracted as they lie, one ``(U,
    dout, nb) @ (U, nb, 1)`` ``torch.bmm``: unlike the JAX package's GEMM
    form (``_expand_collapse``), no ``(U, nb·dout)`` expanded coefficient
    tensor is written and read again, and the product is the same sum per
    pair. ``comps[pair_rel]`` is gathered by
    :func:`~rgcn_tpu_torch.ops.ordered.select_rows`, whose backward sums
    by relation in a fixed order. While ``U_pad·nb·dout`` exceeds
    :data:`_PAIR_ELEM_BUDGET` the pairs go in groups whose size divides
    ``U_pad`` (the JAX package's search), each under
    ``torch.utils.checkpoint``, so one group's rows exist at a time and
    the backward gathers them again (the JAX ``jax.checkpoint``).

    ``compute_dtype`` set: ``table`` is in it already and ``coef`` is
    rounded to it. A bf16 ``table`` (a compute dtype, or a featureless
    layer's bf16 bases): the ungrouped contraction rounds each term to it
    before the f32 sum (:func:`_contract_rounded`) and the grouped one sums
    exact f32 products, as JAX's two forms do; bf16 ``comps`` are widened
    exactly. ``precision``: the f32 products' (see the module docstring).
    """
    src = pairs.pair_src.long()
    u_pad = src.shape[0]
    # rounded before the gather, widened back: the gather's backward sums in
    # f32 and the gradient rounds once to the compute (or comps') dtype
    coef = select_rows(_rounded(comps, compute_dtype).float(),
                       pairs.pair_rel.long())  # (U_pad, nb)
    if u_pad * nb * dout <= _PAIR_ELEM_BUDGET:
        if pairs.src_layout is not None:
            rows = gather_rows_agg(table, pairs.pair_src, pairs.src_layout)
        else:
            rows = gather_rows(table, src)
        if table.dtype != torch.float32:
            return _contract_rounded(rows, coef.to(table.dtype), dout, nb, table.dtype)
        return _contract(rows, coef, dout, nb, precision)
    group = max(1, _PAIR_ELEM_BUDGET // (nb * dout))
    while u_pad % group:
        group -= 1
    grad = torch.is_grad_enabled() and (table.requires_grad or coef.requires_grad)
    parts = []
    for lo in range(0, u_pad, group):
        args = (table, src[lo:lo + group], coef[lo:lo + group], dout, nb, precision)
        parts.append(checkpoint(_contract_group, *args, use_reentrant=False)
                     if grad else _contract_group(*args))
    return torch.cat(parts)


def pair_fan_aggregate(m: torch.Tensor, edges, aggregate=None) -> torch.Tensor:
    """Fan the ``(U_pad, dout)`` pair messages out to the edges, scale by
    ``val`` and sum by destination (counterpart of ``_pair_fan_aggregate``).
    With ``aggregate`` given (the layer's K1 route) and the composed layout
    present (``edges.pairs.agg`` and ``edges.layout``): K1 reads the pair
    rows straight through it (:func:`aggregate_pairs`), and the ``(E,
    dout)`` messages never exist. Otherwise, on the CPU only, the explicit
    fan-out ``m[edge_pair] · val`` then ``aggregate`` or the plain
    ``index_add_``."""
    pi = edges.pairs
    if aggregate is not None and pi.agg is not None and edges.layout is not None:
        return aggregate_pairs(m, edges.val, pi.edge_pair, edges.dst, pi.agg,
                               edges.layout, edges.num_nodes)
    check_plain_path(m.device)
    msgs = m[pi.edge_pair.long()] * edges.val[:, None]
    if aggregate is not None:
        return aggregate(msgs, edges)
    return aggregate_messages(msgs, edges.dst, edges.num_nodes)


def _stacked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def rel_spmm_basis_pairs(edges, x: torch.Tensor, bases: torch.Tensor,
                         comps: torch.Tensor, *, precision=None, aggregate=None,
                         compute_dtype=None) -> torch.Tensor:
    """Featureful basis SpMM through the unique-(src, rel) pair index
    (counterpart of ``rel_spmm_basis_pairs``, ``ops/spmm.py:459-493``):
    ``H[n] = stack_b(x[n] @ bases_b)``, one ``(N, din) @ (din, dout·nb)``
    product laid out ``(N, dout, nb)``, contracted once per pair
    (:func:`pair_contract`) and fanned out (:func:`pair_fan_aggregate`).
    ``bases (nb, din, dout)``, ``comps (R, nb)`` over the general
    relations; the weights are never expanded to ``(R, din, dout)``.
    ``compute_dtype``: ``H``'s dtype from its product on (see the module
    docstring). ``precision``: the products' (``H`` and the pair
    contraction)."""
    if edges.pairs is None:
        raise ValueError("rel_spmm_basis_pairs requires edges.pairs")
    nb, din, dout = bases.shape
    h = product(_stacked, x, bases.permute(1, 2, 0).reshape(din, dout * nb), precision)
    m = pair_contract(_narrow(h, compute_dtype), comps, edges.pairs, nb, dout,
                      compute_dtype, precision)
    return pair_fan_aggregate(m, edges, aggregate)
