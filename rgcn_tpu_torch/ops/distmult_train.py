"""DistMult training scorers with their scatter-free backward
(counterpart of ``rgcn_tpu/ops/pallas_distmult.py``).

The training batch is ``[positives ; negatives]``, with negative ``j`` of
positive ``i = j // ns`` corrupted on one side by the entity ``ce_j`` (the
head where ``ch_j``, else the tail). The uncorrupted side's query rows are
repeats, so the forward gathers ``q = z[s]·r[p]`` and ``k = r[p]·z[o]`` once
per positive and one fresh row per negative: 3P + Ns row gathers instead
of 3(P + Ns). The backward adds every row cotangent into ``d nodes``
through destination sums over layouts built on the host
(:func:`build_structured_layouts`), never a scatter:

* the corrupted entities' rows ``ge_j · [q ; k][idx_j] + (pc · pw_j) ·
  nodes[ce_j]``: the sum is linear, so K4 over the corrupted-entity layout
  ``c_lay`` sums each term with its source rows gathered inside the
  kernel, two shared-table launches (weights ``ge`` over ``[q ; k]`` with
  ``qk_idx``, then ``pc · pw`` over ``nodes`` with ``ce_sorted``), where
  the JAX package makes one two-basis launch over one concatenated table;
* the positives' subjects and objects: the negatives' cotangents reduced
  densely over ``ns`` first, then K1 over ``s_lay`` / ``o_lay`` through
  their perm (:func:`~rgcn_tpu_torch.ops.aggregate.aggregate_sorted`, as
  JAX's ``_rows_to_nodes``);
* ``d relations``: P rows summed by relation in a fixed order
  (:func:`~rgcn_tpu_torch.ops.ordered.index_sum`; the JAX package's
  one-hot product over a small vocabulary).

Bias-free scoring with the Schlichtkrull penalty (or none) only, as
``LinkPredictionExperiment.structured_decoder_ok`` admits. Without
layouts (``layouts=None``, the trainer's device-built epochs, which build
no scoring layouts) the same forward runs under plain autograd.

An assembled batch ``(B, 3)`` (the trainer's branch for a decoder with
another L2) scores through :func:`distmult_score_agg` (and
:func:`distmult_score_spenalty_agg`, the score fused with the
Schlichtkrull penalty), the counterparts of ``distmult_score_agg_ad`` and
``distmult_score_spenalty_agg_ad``: the forward gathers ``z[s]``,
``r[p]``, ``z[o]`` once and saves them; the backward sums each triple's
subject and object rows into ``d nodes`` by K1 through the perm of
:func:`build_batch_layouts`' two layouts (JAX's ``_rows_to_nodes``), and
``d relations`` by :func:`~rgcn_tpu_torch.ops.ordered.index_sum` (JAX's
one-hot product: the same sum, in a fixed order).

The structured scorer's narrow backward (``bwd_dtype``, the config's
``decoder.bwd_dtype``; ``pallas_distmult.py:336-413``): the ``(P, ns, d)``
corrupted-row residual is saved in it, and the corrupted entities' two K4
sums gather from one ``[q ; k ; nodes]`` table cast to it (K4's bf16 form
rounds each weight to bf16 and sums in f32 into an f32 output). The
forward, its scores and its penalty are the f32 path's bit for bit; the
gradients are sums over the narrowed rows. Without layouts a set
``bwd_dtype`` warns and is ignored, as JAX's ``layouts=None`` does.

bf16 relations (the scorer's ``param_dtype``): the products with the f32
embeddings promote to f32, as JAX's do (``pallas_distmult.py:395``: the
table's dtype is ``q``'s, f32), and ``d relations`` sums in f32 and rounds
once to the relations' dtype, ``d nodes`` to the nodes'.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from rgcn_tpu_torch.ops.aggregate import aggregate_sorted, build_dst_layout
from rgcn_tpu_torch.ops.basis import weighted_aggregate
from rgcn_tpu_torch.ops.ordered import index_sum

__all__ = ["build_batch_layouts", "build_structured_layouts",
           "distmult_score_agg", "distmult_score_spenalty_agg", "narrow_dtype",
           "padded_layout", "scoring_rows", "structured_scores"]


def narrow_dtype(dtype) -> "torch.dtype | None":
    """A config's dtype name (``"bfloat16"``), a torch dtype, or None, as
    a torch dtype or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype), None)
    if not isinstance(found, torch.dtype) or not found.is_floating_point:
        raise ValueError(f"bwd_dtype: {dtype!r} is not a floating-point dtype")
    return found


def padded_layout(ids: np.ndarray, num_nodes: int, row_block: int, chunk: int,
                  prefer_native: bool = True):
    """Destination layout of ``ids`` padded to its static total
    ``nrb·chunk + ceil(len/chunk)·chunk``."""
    total = -(-num_nodes // row_block) * chunk + -(-len(ids) // chunk) * chunk
    return build_dst_layout(ids, num_nodes, row_block=row_block, chunk=chunk,
                            pad_to=total, prefer_native=prefer_native)


def build_batch_layouts(batch: np.ndarray, num_nodes: int, row_block: int = 128,
                        chunk: int = 256, prefer_native: bool = True):
    """``(s_layout, o_layout)``: the :func:`padded_layout` of an assembled
    batch's subject and object columns (JAX ``build_batch_layouts``)."""
    batch = np.asarray(batch)
    return tuple(padded_layout(batch[:, col], num_nodes, row_block, chunk,
                               prefer_native) for col in (0, 2))


def build_structured_layouts(positives: np.ndarray, corrupt_ent: np.ndarray,
                             corrupt_head: Optional[np.ndarray], num_nodes: int,
                             row_block: int = 128, chunk: int = 256,
                             prefer_native: bool = True, *,
                             sorted_corrupt: bool = True,
                             p_row_block: Optional[int] = None,
                             p_chunk: Optional[int] = None):
    """Host layouts of the structured backward, each a
    :func:`padded_layout`: the corrupted entities (Ns) at ``row_block`` /
    ``chunk``, the positives' subjects and objects (P) at ``p_row_block``
    / ``p_chunk`` (default the same); then, with ``sorted_corrupt`` (the
    port's default and its scorer's input; the JAX builder's default is
    False), :func:`scoring_rows`, which needs ``corrupt_head``. The
    layouts run in the port's C++ counting sort; ``prefer_native=False``
    runs numpy's argsort."""
    positives = np.asarray(positives)
    p_rb, p_ch = p_row_block or row_block, p_chunk or chunk
    c_lay = padded_layout(corrupt_ent, num_nodes, row_block, chunk, prefer_native)
    s_lay, o_lay = (padded_layout(positives[:, col], num_nodes, p_rb, p_ch, prefer_native)
                    for col in (0, 2))
    if not sorted_corrupt:
        return c_lay, s_lay, o_lay
    if corrupt_head is None:
        raise ValueError("sorted_corrupt=True requires corrupt_head")
    return c_lay, s_lay, o_lay, scoring_rows(c_lay, corrupt_ent, corrupt_head,
                                             len(positives))


def scoring_rows(c_lay, corrupt_ent: np.ndarray, corrupt_head: np.ndarray,
                 p_count: int):
    """``(ce_sorted, qk_idx)``: each corrupted slot's entity and its query
    row in ``[q ; k]`` (``parent + P`` for a head corruption), in
    ``c_lay``'s slot order (pads read 0)."""
    corrupt_ent = np.asarray(corrupt_ent)
    ns_total = corrupt_ent.shape[0]
    perm = c_lay.perm.astype(np.int64)
    valid = perm < ns_total
    safe = np.where(valid, perm, 0)
    ce_sorted = np.where(valid, corrupt_ent[safe], 0)
    qk_idx = safe // (ns_total // p_count) \
        + p_count * np.asarray(corrupt_head).astype(np.int64)[safe]
    qk_idx = np.where(valid, qk_idx, 0)
    return ce_sorted.astype(np.int32), qk_idx.astype(np.int32)


def _wants_grad(nodes, relations) -> bool:
    return torch.is_grad_enabled() and (nodes.requires_grad or relations.requires_grad)


def _forward(positives, ch, corrupt_ent, nodes, relations, pw):
    p_count = positives.shape[0]
    ns = corrupt_ent.shape[0] // p_count
    d = nodes.shape[-1]
    zs, zo = nodes[positives[:, 0]], nodes[positives[:, 2]]
    rp = relations[positives[:, 1]]
    pos_scores = torch.sum(zs * rp * zo, dim=-1)
    q, k = zs * rp, rp * zo  # tail- and head-corruption queries
    zc = nodes[corrupt_ent].reshape(p_count, ns, d)
    ch = ch.reshape(p_count, ns)
    qk = torch.where(ch[..., None], k[:, None, :], q[:, None, :])
    scores = torch.cat([pos_scores, torch.sum(qk * zc, dim=-1).reshape(-1)])

    # the Schlichtkrull penalty: per-row means of squares, the uncorrupted
    # side's reused from its positive
    a2, b2, c2 = (torch.mean(t ** 2, dim=-1) for t in (zs, rp, zo))
    zc2 = torch.mean(zc ** 2, dim=-1)  # (P, ns)
    neg_rows = zc2 + torch.where(ch, (b2 + c2)[:, None], (a2 + b2)[:, None])
    pw_pos, pw_neg = pw[:p_count], pw[p_count:].reshape(p_count, ns)
    penalty = torch.sum((a2 + b2 + c2) * pw_pos) + torch.sum(neg_rows * pw_neg)
    return scores, penalty, (ch, zs, zo, rp, q, k, zc, pw_pos, pw_neg)


class _Structured(torch.autograd.Function):
    """Scores and penalty of a structured batch; gradients for ``nodes``
    and ``relations`` only. The layouts ride on ``ctx``."""

    @staticmethod
    def forward(ctx, nodes, relations, positives, ch, corrupt_ent, pw, layouts,
                bwd_dtype):
        scores, penalty, res = _forward(positives, ch, corrupt_ent, nodes,
                                        relations, pw)
        ctx.layouts, ctx.bwd_dtype = layouts, bwd_dtype
        ctx.num_rels, ctx.rel_dtype = relations.shape[0], relations.dtype
        if bwd_dtype is not None:  # the corrupted rows, the widest residual
            res = res[:6] + (res[6].to(bwd_dtype),) + res[7:]
        ctx.save_for_backward(nodes, positives, *res)
        return scores, penalty

    @staticmethod
    def backward(ctx, gs, gp):
        nodes, positives, ch, zs, zo, rp, q, k, zc, pw_pos, pw_neg = ctx.saved_tensors
        c_lay, s_lay, o_lay, (ce_sorted, qk_idx) = ctx.layouts
        num_nodes = nodes.shape[0]
        p_count, ns, d = zc.shape
        gs_pos, gs_neg = gs[:p_count], gs[p_count:].reshape(p_count, ns)
        pc = gp * (2.0 / d)
        chf = ch[..., None].to(zc.dtype)

        # 1) corrupted entities: two K4 sums over c_lay in its slot order
        perm = c_lay.perm.long()
        zero = gs.new_zeros(1)
        ge = torch.cat([gs_neg.reshape(-1), zero])[perm]
        pwz = torch.cat([pw_neg.reshape(-1), zero])[perm]
        if ctx.bwd_dtype is None:
            qk_table, ce_table, ce_rows = torch.cat([q, k]), nodes, ce_sorted
        else:  # one narrow [q ; k ; nodes] table, as JAX gathers both terms
            qk_table = ce_table = torch.cat([q, k, nodes]).to(ctx.bwd_dtype)
            ce_rows = ce_sorted + 2 * p_count
        dz = weighted_aggregate(qk_table, qk_idx, ge[None], c_lay, num_nodes)[0]
        dz = dz + weighted_aggregate(ce_table, ce_rows, (pc * pwz)[None], c_lay,
                                     num_nodes)[0]

        # 2) positives' subjects: the positive, the tail-corrupted negatives
        gzc_tail = torch.sum((1.0 - chf) * gs_neg[..., None] * zc, dim=1)
        pw_tail = torch.sum(torch.where(ch, 0.0, pw_neg), dim=1)
        s_rows = (gs_pos[:, None] * rp * zo + rp * gzc_tail
                  + (pc * (pw_pos + pw_tail))[:, None] * zs)
        dz = dz + aggregate_sorted(s_rows, s_lay, num_nodes)

        # 3) positives' objects: the head-corrupted negatives
        gzc_head = torch.sum(chf * gs_neg[..., None] * zc, dim=1)
        pw_head = torch.sum(torch.where(ch, pw_neg, 0.0), dim=1)
        o_rows = (gs_pos[:, None] * rp * zs + rp * gzc_head
                  + (pc * (pw_pos + pw_head))[:, None] * zo)
        dz = dz + aggregate_sorted(o_rows, o_lay, num_nodes)

        # d relations: P rows, the negatives reduced over ns
        pw_all = pw_pos + torch.sum(pw_neg, dim=1)
        rel_rows = (gs_pos[:, None] * zs * zo + zo * gzc_head + zs * gzc_tail
                    + (pc * pw_all)[:, None] * rp)
        drel = index_sum(rel_rows, positives[:, 1], ctx.num_rels)
        return (dz.to(nodes.dtype), drel.to(ctx.rel_dtype), None, None, None, None, None,
                None)


def structured_scores(positives: torch.Tensor, corrupt_head: torch.Tensor,
                      corrupt_ent: torch.Tensor, nodes: torch.Tensor,
                      relations: torch.Tensor, pw: torch.Tensor, layouts,
                      bwd_dtype=None):
    """``(scores [positives ; negatives] (P + Ns,), Schlichtkrull penalty)``
    of a structured batch: ``positives (P, 3)``, ``corrupt_head (Ns,)``
    bool, ``corrupt_ent (Ns,)`` (Ns = P·ns, negative ``j`` of positive ``j
    // ns``), ``pw (P + Ns,)`` per-row penalty weights, ``layouts`` the
    4-tuple of :func:`build_structured_layouts` (on the device). The penalty is ``Σ_rows pw · (mean z_s² + mean r_p² + mean
    z_o²)``. With grad enabled and ``nodes`` or ``relations`` requiring
    grad the backward runs on K4 and K1. ``layouts=None`` is the
    layout-free mode of the device-built epochs: the same forward, so the
    same scores bit for bit, and plain autograd for the backward (the
    row gathers' index-put sums, equal to the layout path up to f32
    reassociation), as JAX's ``layouts=None``. ``bwd_dtype`` (e.g.
    ``torch.bfloat16``) narrows the layout path's backward (see the module
    docstring); without layouts a set value warns and is ignored."""
    positives, corrupt_ent = positives.long(), corrupt_ent.long()
    bwd_dtype = narrow_dtype(bwd_dtype)
    if layouts is None:
        if bwd_dtype is not None:
            warnings.warn(
                "structured_scores: bwd_dtype only applies with host-built "
                "layouts; the layout-free (layouts=None) backward is plain f32 "
                "autograd -- ignoring bwd_dtype", stacklevel=2)
        return _forward(positives, corrupt_head, corrupt_ent, nodes, relations, pw)[:2]
    if _wants_grad(nodes, relations):
        return _Structured.apply(nodes, relations, positives, corrupt_head,
                                 corrupt_ent, pw, layouts, bwd_dtype)
    scores, penalty, _ = _forward(positives, corrupt_head, corrupt_ent, nodes,
                                  relations, pw)
    return scores, penalty


def _batch_forward(triples, nodes, relations, pw):
    zs, rp, zo = nodes[triples[:, 0]], relations[triples[:, 1]], nodes[triples[:, 2]]
    scores = torch.sum(zs * rp * zo, dim=-1)
    if pw is None:
        return scores, None, (zs, rp, zo)
    per_row = (torch.mean(zs ** 2, dim=-1) + torch.mean(rp ** 2, dim=-1)
               + torch.mean(zo ** 2, dim=-1))
    return scores, torch.sum(per_row * pw), (zs, rp, zo)


class _ScoreAgg(torch.autograd.Function):
    """Scores of an assembled batch, with the Schlichtkrull penalty when
    ``pw`` is given; gradients for ``nodes`` and ``relations`` only. The
    layouts ride on ``ctx``."""

    @staticmethod
    def forward(ctx, nodes, relations, triples, pw, layouts):
        scores, penalty, res = _batch_forward(triples, nodes, relations, pw)
        ctx.layouts = layouts
        ctx.num_nodes, ctx.num_rels = nodes.shape[0], relations.shape[0]
        ctx.dtypes = nodes.dtype, relations.dtype
        ctx.with_penalty = pw is not None
        ctx.save_for_backward(triples, *res, *(() if pw is None else (pw,)))
        return scores if pw is None else (scores, penalty)

    @staticmethod
    def backward(ctx, gs, gp=None):
        triples, zs, rp, zo, *pw = ctx.saved_tensors
        s_lay, o_lay = ctx.layouts
        gb = gs[:, None]
        s_rows, o_rows, rel_rows = gb * rp * zo, gb * rp * zs, gb * zs * zo
        if ctx.with_penalty:
            pen = (gp * pw[0] * (2.0 / zs.shape[-1]))[:, None]
            s_rows, o_rows = s_rows + pen * zs, o_rows + pen * zo
            rel_rows = rel_rows + pen * rp
        drel = index_sum(rel_rows, triples[:, 1], ctx.num_rels)
        dz = aggregate_sorted(s_rows, s_lay, ctx.num_nodes)
        dz = dz + aggregate_sorted(o_rows, o_lay, ctx.num_nodes)
        return dz.to(ctx.dtypes[0]), drel.to(ctx.dtypes[1]), None, None, None


def distmult_score_agg(triples: torch.Tensor, nodes: torch.Tensor,
                       relations: torch.Tensor, layouts) -> torch.Tensor:
    """Bias-free DistMult scores ``(B,)`` of ``triples (B, 3)``; ``layouts``
    the :func:`build_batch_layouts` pair (on the device). With grad enabled
    and ``nodes`` or ``relations`` requiring grad the backward sums ``d
    nodes`` by K1 through the layouts' perm."""
    triples = triples.long()
    if _wants_grad(nodes, relations):
        return _ScoreAgg.apply(nodes, relations, triples, None, layouts)
    return _batch_forward(triples, nodes, relations, None)[0]


def distmult_score_spenalty_agg(triples: torch.Tensor, nodes: torch.Tensor,
                                relations: torch.Tensor, pw: torch.Tensor, layouts):
    """``(scores (B,), Σ_rows pw · (mean z_s² + mean r_p² + mean z_o²))``,
    the penalty's cotangent riding the score's K1 sums."""
    triples = triples.long()
    if _wants_grad(nodes, relations):
        return _ScoreAgg.apply(nodes, relations, triples, pw, layouts)
    return _batch_forward(triples, nodes, relations, pw)[:2]
