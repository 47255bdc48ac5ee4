"""R-GCN convolution and the DistMult scorer (counterparts of
``rgcn_tpu/nn/layers.py::RGCNConv`` and ``DistMult``).

Ported weight layouts of :class:`RGCNConv`:

* featureless (``in_features=None``, one-hot identity input): messages are
  rows of ``W[rel]`` gathered per edge, summed by K1 over the EdgeSet's
  destination layout; in training autograd's index backward scatters the
  weight gradient and K1's backward is the gather ``g[dst]``;
* featureful: :func:`~rgcn_tpu_torch.ops.rel_spmm.rel_spmm_ad` (K2, or K3
  then K1; in training its backward runs the same kernels over
  ``edges.reverse`` for dx and a per-tile product for dW);
* featureless basis decomposition (NC layer 1 of nc-MUTAG, nc-BGS,
  nc-AM): ``W = comps @ bases`` is never expanded to ``(R', N, dout)``.
  With more than 8 bases and the EdgeSet's unique-(src, rel) pair index
  (``edges.pairs``, built by the trainer) the basis rows are contracted
  once per pair and summed by K1 through the composed pair layout, with
  K1 as both backward sums (:mod:`rgcn_tpu_torch.ops.spmm`'s pair
  paths); without it (serving) they are gathered per edge and
  contracted with ``comps[tile_rel]`` per tile
  (:func:`~rgcn_tpu_torch.ops.spmm.rel_spmm_featureless_basis`, grouped
  under its element budget) and summed by K1; with at most 8, K4 sums the
  per-basis tables with the weights ``val · comps[rel]``
  (:func:`~rgcn_tpu_torch.ops.basis.rel_spmm_featureless_basis_fwd`). The
  self message is ``comps[-1] @ bases``;
* featureful basis decomposition: with at most 8 bases (the LP encoder)
  ``comps (R', nb)`` and ``bases (nb, din, dout)`` go through the
  aggregation-first :func:`~rgcn_tpu_torch.ops.basis.rel_spmm_basis` (K4
  over the merged or destination layout, K5 over ``merged.fwd_dedup``);
  with more (NC layer 2 of nc-MUTAG, nc-BGS, nc-AM) and ``edges.pairs``,
  :func:`~rgcn_tpu_torch.ops.spmm.rel_spmm_basis_pairs` (``H = stack_b(x
  @ bases_b)`` contracted once per pair, then K1 as above); with more and
  no pairs (serving) they are expanded to dense ``(R', din, dout)``
  weights in full f32 and take the featureful path;
* featureful block decomposition (the lp-FB-toy encoder): ``blocks (r, B,
  din/B, dout/B)`` expanded to block-diagonal ``(r, din, dout)`` matrices
  by one index scatter and run through ``rel_spmm_ad`` (K3 then K1 at
  lp-FB-toy's width), as the JAX package does while ``r·din·dout`` stays
  within 64M elements; above that, blockwise messages
  (:func:`~rgcn_tpu_torch.ops.spmm.rel_spmm_block`) summed by K1.

An EdgeSet without a destination (or merged) layout takes the plain
``index_add_`` paths of :mod:`rgcn_tpu_torch.ops.spmm`, on the CPU only: on
any other device it raises, so the card never runs a forward without its
kernels. The self-loop relation (index ``R' - 1``) is applied densely,
``X @ W_self``. Self-loop dropout (``schlichtkrull-dropout``, the JAX
layer's flax ``Dropout`` over the ``(N, dout)`` self message) takes its
keep mask as an argument, ``self_mask``: the LP trainer draws it on the
host, so the card and the CPU train on the same masks; without one (the
deterministic forward serving runs) it is the identity. The structural
self-loop dropout (any other ``self_loop_type``) is a float ``(N, 1)``
mask of zeros and ones, drawn once a step for every layer and multiplied
into the self message without a rescale. In training,
the featureful basis layer with at most 8 bases differentiates through
:func:`~rgcn_tpu_torch.ops.basis.rel_spmm_basis` (over an unmerged layout,
the LP training subgraph: K4 forward, K4 over the reversed edges for dx;
over the merged frame, NC layer 2 and e-RGCN's ``rgc1``: K4 or K5
forward, K4 over the merged reverse frame for dx), the featureless one
(NC layer 1) through
:func:`~rgcn_tpu_torch.ops.basis.rel_spmm_featureless_basis_fwd` (K4
forward, K4 over the reversed edges for the basis tables' gradient), and
the expanded block
weights go through ``rel_spmm_ad`` (K3 then K1 both ways at lp-FB-toy's
width, K2 both ways for e-RGCN's ``rgc1`` at nc-AIFB; the expansion's
index scatter carries the gradient back to the blocks). Diagonal weights (the e-RGCN first layer, ``diag=True``) are
``weights (R', din)`` with no bias: on the card
:func:`~rgcn_tpu_torch.ops.diag.rel_spmm_diag_ad` (K1 over the merged pair
frame, or over the destination layout in slot order, both ways), on a CPU
tensor the plain :func:`~rgcn_tpu_torch.ops.spmm.rel_spmm_diag`; the self
message is ``x ⊙ weights[-1]``.

Edge-sharded training (:mod:`rgcn_tpu_torch.dist`): with ``group`` set
(a ``torch.distributed`` process group; None means one device) a layer's
EdgeSet is this rank's shard, every edge-partial aggregate is summed over
the group (:func:`~rgcn_tpu_torch.ops.collectives.all_reduce`) and every
replicated input of the per-shard computation (x, weights, bases,
``comps[:-1]``, blocks; the decoder's nodes and relations) passes through
:func:`~rgcn_tpu_torch.ops.collectives.fanout`, at the sites the JAX
layer marks. The block layer fans its blocks before expanding them (the
JAX layer fans the expanded matrices): the expansion's backward only
gathers, so the reduced gradient is the same bits, over an all-reduce B
times smaller (B blocks). The self message, the bias and the loss are
replicated math and take no collective.

:class:`TorchLinear` is the c-RGCN bottleneck: ``x @ kernel + bias`` with
the flax layout ``kernel (din, dout)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rgcn_tpu_torch.device import check_plain_path
from rgcn_tpu_torch.graph.coalesce import MAX_BASES
from rgcn_tpu_torch.nn import init as rinit
from rgcn_tpu_torch.ops import distmult as distmult_ops
from rgcn_tpu_torch.ops import distmult_train
from rgcn_tpu_torch.ops import spmm as spmm_ops
from rgcn_tpu_torch.ops.aggregate import aggregate_sorted
from rgcn_tpu_torch.ops.collectives import maybe_all_reduce, maybe_fanout
from rgcn_tpu_torch.ops.basis import (
    full_f32_matmul,
    rel_spmm_basis,
    rel_spmm_featureless_basis_fwd,
)
from rgcn_tpu_torch.ops.diag import rel_spmm_diag_ad
from rgcn_tpu_torch.ops.rel_spmm import rel_spmm_ad

__all__ = ["RGCNConv", "DistMult", "TorchLinear", "check_plain_path", "expand_blocks"]


def _aggregate_k1(msgs, edges):
    return aggregate_sorted(msgs, edges.layout, edges.num_nodes, dst=edges.dst)


def expand_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Block-diagonal ``(r, din, dout)`` matrices of ``(r, B, ib, ob)``
    blocks: one index scatter into zeros."""
    r, nb, ib, ob = blocks.shape
    din, dout = nb * ib, nb * ob
    rows = torch.arange(din, device=blocks.device)
    cols = (rows // ib)[:, None] * ob + torch.arange(ob, device=blocks.device)
    w = blocks.new_zeros((r, din, dout))
    w[:, rows[:, None], cols] = blocks.reshape(r, din, ob)
    return w


class RGCNConv(nn.Module):
    """Relational graph convolution over a static EdgeSet.

    ``num_relations`` is the augmented count ``R' = 2R + 1`` (the last
    index is the self-loop). Without decomposition ``weights`` is ``(R',
    din, dout)`` with ``din = num_nodes`` when featureless; with
    ``decomposition="basis"`` the parameters are ``bases (nb, din, dout)``
    and ``comps (R', nb)``; with ``decomposition="block"`` they are
    ``blocks (R', B, din/B, dout/B)`` (NC layout: the last relation's blocks
    give the blockwise self message) or, with ``separate_self_weight``
    (LP layout), ``blocks (R' - 1, B, din/B, dout/B)`` and a dense
    ``self_weight (din, dout)``, both drawn Schlichtkrull-normal with the
    fan ``((R'-1)//2, din/B)`` whatever ``weight_init`` says. With
    ``diag=True`` (the e-RGCN first layer) ``weights`` is ``(R', din)``,
    the output is ``din`` wide and there is no bias. ``bias`` is
    ``(dout,)``, or absent when ``bias_init`` is None. Parameters are drawn
    from ``generator`` with the named initializers (NC layers:
    glorot-uniform with the relu gain, zero bias). ``self_loop_dropout`` is
    the rate of the self message's dropout where a keep mask is given.
    ``group``: the edge group of a sharded EdgeSet (see the module
    docstring), None on one device.
    """

    # Expanding block-diagonal weights costs r·din·dout elements; cap it.
    _BLOCK_EXPAND_MAX_ELEMS = 64_000_000

    def __init__(
        self,
        num_nodes: int,
        num_relations: int,
        out_features: int,
        in_features: Optional[int] = None,
        decomposition: Optional[str] = None,
        num_bases: int = 0,
        num_blocks: int = 0,
        separate_self_weight: bool = False,
        diag: bool = False,
        weight_init: str = "glorot-uniform",
        weight_gain: bool = True,
        bias_init: Optional[str] = "zeros",
        self_loop_dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
        group=None,
    ):
        super().__init__()
        self.group = group
        if diag and in_features is None:
            raise ValueError("diagonal weights require explicit features")
        if decomposition not in (None, "basis", "block"):
            raise NotImplementedError(
                f"{decomposition!r} decomposition has not been implemented"
            )
        if decomposition == "basis" and num_bases <= 0:
            raise ValueError("basis decomposition needs num_bases > 0")
        din = num_nodes if in_features is None else in_features
        if decomposition == "block":
            if num_blocks <= 0:
                raise ValueError("block decomposition needs num_blocks > 0")
            if din % num_blocks or out_features % num_blocks:
                raise ValueError(
                    f"block decomposition needs dims ({din}, {out_features}) "
                    f"divisible by num_blocks ({num_blocks})"
                )
            if in_features is None:
                raise NotImplementedError(
                    "featureless block decomposition is unused by the "
                    "reference model family (block LP layers always receive "
                    "embeddings)"
                )
        self.num_nodes = num_nodes
        self.num_relations = num_relations
        self.in_features = in_features
        self.out_features = out_features
        self.decomposition = decomposition
        self.diag = diag
        self.self_loop_dropout = float(self_loop_dropout)
        self.separate_self_weight = separate_self_weight and decomposition == "block"
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        gain = rinit.relu_gain() if weight_gain else 1.0
        w_init = rinit.select_weight_init(weight_init, gain)
        if diag:
            # no bias (torch_rgcn/layers.py:151)
            self.weights = nn.Parameter(w_init((num_relations, din), generator))
            self.register_parameter("bias", None)
            return
        if decomposition == "basis":
            self.bases = nn.Parameter(w_init((num_bases, din, out_features), generator))
            self.comps = nn.Parameter(w_init((num_relations, num_bases), generator))
        elif decomposition == "block":
            ib, ob = din // num_blocks, out_features // num_blocks
            if self.separate_self_weight:
                fan = ((num_relations - 1) // 2, ib)

                def blk_init(shape):
                    return rinit.schlichtkrull_normal(shape, generator, gain,
                                                      fan_shape=fan)

                self.blocks = nn.Parameter(
                    blk_init((num_relations - 1, num_blocks, ib, ob)))
                self.self_weight = nn.Parameter(blk_init((din, out_features)))
            else:
                self.blocks = nn.Parameter(
                    w_init((num_relations, num_blocks, ib, ob), generator))
        else:
            self.weights = nn.Parameter(
                w_init((num_relations, din, out_features), generator))
        if bias_init is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(
                rinit.select_bias_init(bias_init)((out_features,), generator))

    def forward(self, edges, x: Optional[torch.Tensor] = None,
                self_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``self_mask``: a bool ``(N, dout)`` keep mask of the self
        message's dropout (kept entries scaled by ``1 / (1 - rate)``, the
        others 0, as flax ``Dropout`` computes; a rate of 0 leaves it
        whole), or a float ``(N, 1)`` structural mask multiplied into the
        self message; None leaves it whole."""
        if (x is None) != (self.in_features is None):
            raise ValueError("features must be given iff in_features is set")
        if self.diag:
            return self._diag(edges, x, self_mask)
        if self.decomposition == "basis":
            out = self._basis(edges, x, self_mask)
        elif self.decomposition == "block":
            out = self._block(edges, x, self_mask)
        else:
            out = self._dense(edges, x, self.weights, self_mask)
        return out if self.bias is None else out + self.bias

    def _reduce(self, agg: torch.Tensor) -> torch.Tensor:
        """Edge-partial aggregate -> the sum over the edge group."""
        return maybe_all_reduce(agg, self.group)

    def _fan(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated value entering per-shard edge computation."""
        return maybe_fanout(x, self.group)

    def _self(self, self_msg: torch.Tensor, mask) -> torch.Tensor:
        """The self message under ``mask``: a bool keep mask is the
        Schlichtkrull dropout (kept entries rescaled, a rate of 0 leaves
        the message whole); a float ``(N, 1)`` mask is the structural
        dropout, multiplied in as drawn (JAX ``_masked_self``)."""
        if mask is None:
            return self_msg
        if mask.dtype != torch.bool:
            return self_msg * mask
        if self.self_loop_dropout == 0.0:
            return self_msg
        return torch.where(mask, self_msg / (1.0 - self.self_loop_dropout),
                           self_msg.new_zeros(()))

    def _diag(self, edges, x, mask):
        """Diagonal weights: the plain path on a CPU tensor, else K1 (or
        raise, without a layout)."""
        dw, fan = self.weights, self._fan
        if x.device.type == "cpu" or edges.layout is None:
            check_plain_path(x.device)
            agg = spmm_ops.rel_spmm_diag(edges, fan(x), fan(dw[:-1]))
        else:
            agg = rel_spmm_diag_ad(edges, fan(x), fan(dw[:-1]))
        return self._reduce(agg) + self._self(x * dw[-1], mask)

    def _dense(self, edges, x, w, mask):
        """Dense ``w (R', din, dout)``: the general relations through the
        kernels (or the plain path without a layout), the self-loop
        densely."""
        fan = self._fan
        if edges.layout is None:
            check_plain_path(w.device)
        if x is None:
            agg = spmm_ops.rel_spmm_featureless(
                edges, fan(w[:-1]),
                aggregate=_aggregate_k1 if edges.layout is not None else None,
            )
            # X = I: node v receives W_self[v]
            return self._reduce(agg) + self._self(w[-1], mask)
        if edges.layout is not None:
            agg = rel_spmm_ad(edges, fan(x), fan(w[:-1]))
        else:
            agg = spmm_ops.rel_spmm(edges, fan(x), fan(w[:-1]))
        with full_f32_matmul():
            return self._reduce(agg) + self._self(x @ w[-1], mask)

    def _basis(self, edges, x, mask):
        bases, comps = self.bases, self.comps
        fb, fc = self._fan(bases), self._fan(comps[:-1])
        many = comps.shape[1] > MAX_BASES
        if x is None:
            if edges.layout is None:
                check_plain_path(bases.device)
                agg = spmm_ops.rel_spmm_featureless_basis(edges, fb, fc)
            elif many:
                agg = spmm_ops.rel_spmm_featureless_basis(
                    edges, fb, fc, aggregate=_aggregate_k1)
            else:
                agg = rel_spmm_featureless_basis_fwd(edges, fb, fc)
            with full_f32_matmul():
                self_msg = torch.einsum("b,bno->no", comps[-1], bases)
                return self._reduce(agg) + self._self(self_msg, mask)
        if many and edges.pairs is not None:
            # H = stack_b(x @ bases_b), contracted once per (src, rel) pair
            agg = spmm_ops.rel_spmm_basis_pairs(
                edges, self._fan(x), fb, fc,
                aggregate=_aggregate_k1 if edges.layout is not None else None)
            with full_f32_matmul():
                self_msg = x @ torch.einsum("b,bio->io", comps[-1], bases)
                return self._reduce(agg) + self._self(self_msg, mask)
        if many or (edges.merged is None and edges.layout is None):
            # expand to dense per-relation weights: K4/K5 keep one sum per
            # basis in registers and take at most MAX_BASES
            with full_f32_matmul():
                w = torch.einsum("rb,bio->rio", comps, bases)
            return self._dense(edges, x, w, mask)
        agg = rel_spmm_basis(edges, self._fan(x), fb, fc)
        with full_f32_matmul():
            self_msg = x @ torch.einsum("b,bio->io", comps[-1], bases)
            return self._reduce(agg) + self._self(self_msg, mask)

    def _block_messages(self, edges, x, blocks):
        """General-relation messages of ``blocks (r, B, ib, ob)``,
        aggregated (over the edge group): the expanded matrices through
        ``rel_spmm_ad`` while ``r·din·dout`` is within
        :attr:`_BLOCK_EXPAND_MAX_ELEMS`, else blockwise messages summed by
        K1."""
        r, nb, ib, ob = blocks.shape
        x, blocks = self._fan(x), self._fan(blocks)
        if edges.layout is None:
            check_plain_path(blocks.device)
            return self._reduce(spmm_ops.rel_spmm_block(edges, x, blocks))
        if r * (nb * ib) * (nb * ob) <= self._BLOCK_EXPAND_MAX_ELEMS:
            return self._reduce(rel_spmm_ad(edges, x, expand_blocks(blocks)))
        with full_f32_matmul():
            return self._reduce(spmm_ops.rel_spmm_block(edges, x, blocks,
                                                        aggregate=_aggregate_k1))

    def _block(self, edges, x, mask):
        blocks = self.blocks
        if self.separate_self_weight:
            agg = self._block_messages(edges, x, blocks)
            with full_f32_matmul():
                return agg + self._self(x @ self.self_weight, mask)
        agg = self._block_messages(edges, x, blocks[:-1])
        n, (nb, ib, ob) = x.shape[0], blocks.shape[1:]
        with full_f32_matmul():
            self_msg = torch.einsum("nbi,bio->nbo", x.reshape(n, nb, ib), blocks[-1])
        return agg + self._self(self_msg.reshape(n, nb * ob), mask)


class DistMult(nn.Module):
    """DistMult triple scorer: ``relations (R, emb_dim)`` and, with
    ``bias_init``, per-node ``sbias``/``obias`` and per-relation ``pbias``.

    Training scores structured batches
    (:meth:`structured_scores_with_penalty`, bias-free only) or assembled
    ones: bias-free with the batch's layouts, through
    :func:`~rgcn_tpu_torch.ops.distmult_train.distmult_score_agg` (and
    :meth:`score_with_s_penalty`, its fused Schlichtkrull penalty), K1
    for ``d nodes``; with biases, through the plain ``distmult_score``
    and autograd, the JAX package's own route there. The JAX scorer's
    narrow ``bwd_dtype`` option is not ported. ``group``: the ranks a
    sharded scoring batch is split over (its replicated inputs are
    fanned out in the training scorers and penalties), None on one device.
    """

    def __init__(
        self,
        num_nodes: int,
        num_relations: int,  # original relation count R
        emb_dim: int,
        weight_init: str = "standard-normal",
        weight_gain: bool = False,
        bias_init: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        group=None,
    ):
        super().__init__()
        self.group = group
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        gain = rinit.relu_gain() if weight_gain else 1.0
        self.relations = nn.Parameter(rinit.select_weight_init(weight_init, gain)(
            (num_relations, emb_dim), generator))
        if bias_init is None:
            for name in ("sbias", "obias", "pbias"):
                self.register_parameter(name, None)
        else:
            b_init = rinit.select_bias_init(bias_init)
            self.sbias = nn.Parameter(b_init((num_nodes,), generator))
            self.obias = nn.Parameter(b_init((num_nodes,), generator))
            self.pbias = nn.Parameter(b_init((num_relations,), generator))

    def _fan(self, x):
        return x if x is None else maybe_fanout(x, self.group)

    def _biases(self, fan=lambda b: b):
        return dict(sbias=fan(self.sbias), pbias=fan(self.pbias), obias=fan(self.obias))

    def forward(self, triples: torch.Tensor, nodes: torch.Tensor,
                batch_layouts=None) -> torch.Tensor:
        """Scores ``(B,)`` of ``(B, 3)`` triples against ``nodes (N, d)``.
        ``batch_layouts``: the batch's ``(s_layout, o_layout)``
        (:func:`~rgcn_tpu_torch.ops.distmult_train.build_batch_layouts`);
        with them a bias-free scorer takes the scatter-free backward."""
        fan = self._fan
        if batch_layouts is not None and self.sbias is None:
            return distmult_train.distmult_score_agg(triples, fan(nodes),
                                                     fan(self.relations), batch_layouts)
        return distmult_ops.distmult_score(triples, fan(nodes), fan(self.relations),
                                           **self._biases(fan))

    def score_with_s_penalty(self, triples, nodes, pw, batch_layouts):
        """Fused ``(scores, Schlichtkrull penalty)`` with the scatter-free
        backward (``pw``: per-row penalty weights). Bias-free scoring
        only."""
        if self.sbias is not None:
            raise ValueError("the fused score and penalty is bias-free only")
        return distmult_train.distmult_score_spenalty_agg(
            triples, self._fan(nodes), self._fan(self.relations), pw, batch_layouts)

    def s_penalty(self, triples: torch.Tensor, nodes: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  total=None) -> torch.Tensor:
        """Schlichtkrull L2: mean squares of the batch's embeddings (rows
        gathered as in ``distmult_score``). ``weights``/``total`` weigh
        the rows by ``weights / total`` (``total`` default
        ``sum(weights)``): zero-weight pad rows drop out, and the shards'
        partial sums add up to the whole batch's value."""
        nodes, relations = self._fan(nodes), self._fan(self.relations)
        s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
        per_row = (torch.mean(nodes.index_select(0, s) ** 2, dim=-1)
                   + torch.mean(relations.index_select(0, p) ** 2, dim=-1)
                   + torch.mean(nodes.index_select(0, o) ** 2, dim=-1))
        if weights is None:
            return torch.mean(per_row)
        return torch.sum(per_row * weights) / (weights.sum() if total is None else total)

    def l2_penalty(self) -> torch.Tensor:
        """Sum of squares of the relation matrix (fanned out under a
        group: a sharded step scales each rank's share, so the relation
        gradient sums the shares)."""
        return torch.sum(self._fan(self.relations) ** 2)

    def structured_scores_with_penalty(self, positives, corrupt_head, corrupt_ent,
                                       nodes, pw, layouts):
        """``(scores [positives ; negatives], Schlichtkrull penalty)`` of a
        structured batch, with the scatter-free backward
        (:func:`~rgcn_tpu_torch.ops.distmult_train.structured_scores`).
        Bias-free scoring only."""
        if self.sbias is not None:
            raise ValueError("structured scoring is bias-free only")
        return distmult_train.structured_scores(
            positives, corrupt_head, corrupt_ent, self._fan(nodes),
            self._fan(self.relations), pw, layouts)

    def score_heads(self, batch: torch.Tensor, nodes: torch.Tensor,
                    candidate_slice=None) -> torch.Tensor:
        return distmult_ops.score_head_candidates(batch, nodes, self.relations,
                                                  candidate_slice=candidate_slice,
                                                  **self._biases())

    def score_tails(self, batch: torch.Tensor, nodes: torch.Tensor,
                    candidate_slice=None) -> torch.Tensor:
        return distmult_ops.score_tail_candidates(batch, nodes, self.relations,
                                                  candidate_slice=candidate_slice,
                                                  **self._biases())


class TorchLinear(nn.Module):
    """Dense layer with torch ``nn.Linear``'s default initialisation in the
    flax layout: ``kernel (din, dout)`` (``nn.Linear`` stores ``(out,
    in)``) and ``bias (dout,)``, both U(-1/sqrt(din), 1/sqrt(din)), drawn
    kernel first. Counterpart of ``rgcn_tpu/nn/layers.py::TorchLinear``."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.kernel = nn.Parameter(
            rinit.torch_linear_weight((in_features, out_features), generator))
        self.bias = nn.Parameter(
            rinit.torch_linear_bias(in_features)((out_features,), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_f32_matmul():
            return x @ self.kernel + self.bias
