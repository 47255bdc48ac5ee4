"""Link-prediction R-GCN and c-RGCN (counterparts of
``rgcn_tpu/models/link_prediction.py::LinkPredictor`` and
``::CompressionRelationPredictor``, and of
``rgcn_tpu/train/link_prediction.py::build_lp_model``).

Learned node embeddings ``(N, emb_dim)`` plus a broadcast bias row, ReLU,
1-2 R-GCN layers over ``2R + 1`` relations, then DistMult scores. c-RGCN
runs the R-GCN at the compressed width ``hidden1_size`` between two
:class:`~rgcn_tpu_torch.nn.layers.TorchLinear` layers and adds the node
embeddings back: ``z = E + decode(rgc(encode(relu(E + b))))``.
``encode`` is separate from the scoring so a server encodes the graph once
and sweeps all candidates densely. Training scores structured batches
(:meth:`LinkPredictor.structured_scores`), or assembled ones
(:meth:`LinkPredictor.forward` with the batch's layouts) where the decoder
has biases or an L2 other than Schlichtkrull's, with each layer's
self-loop dropout under a mask the trainer draws (``self_masks``). The JAX
model's ``feature_blocks`` option stores the embeddings as <=128-column
blocks for a TPU gather fast path: ``weights.from_jax_params`` joins them
into ``node_embeddings``, and the port keeps one table.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rgcn_tpu_torch.nn import init as rinit
from rgcn_tpu_torch.nn.layers import DistMult, RGCNConv, TorchLinear

__all__ = ["CompressionRelationPredictor", "LinkPredictor", "build_lp_model"]


class LinkPredictor(nn.Module):
    """Encoder-decoder link predictor (R-GCN -> DistMult).

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` in
    the order node embeddings, layers, decoder. ``group``: the edge group
    of an edge-sharded EdgeSet (JAX ``axis_name``); ``decoder_group``: the
    ranks the scoring batch is split over (JAX ``decoder_axis_name``,
    default ``group``; on a 2-D mesh every rank). None on one device.
    """

    def __init__(
        self,
        num_nodes: int,
        num_relations: int,  # original relation count R
        emb_dim: int = 200,
        hidden1_size: Optional[int] = None,
        hidden2_size: Optional[int] = None,
        num_layers: int = 1,
        decomposition: Optional[str] = None,
        num_bases: int = 0,
        num_blocks: int = 0,
        weight_init: str = "glorot-normal",
        include_gain: bool = False,
        bias_init: Optional[str] = None,
        self_loop_dropout: float = 0.0,
        decoder_l2_type: Optional[str] = None,
        decoder_l2: float = 0.0,
        decoder_weight_init: str = "standard-normal",
        decoder_include_gain: bool = False,
        decoder_bias_init: Optional[str] = None,
        seed: int = 0,
        group=None,
        decoder_group=None,
    ):
        super().__init__()
        if not 0 < num_layers < 3:
            raise ValueError("only 1 or 2 RGCN layers are supported")
        self.num_layers = num_layers
        self.decoder_l2_type = decoder_l2_type
        self.decoder_l2 = decoder_l2
        gen = torch.Generator().manual_seed(seed)
        gain = rinit.relu_gain() if include_gain else 1.0
        self.node_embeddings = nn.Parameter(
            rinit.select_weight_init(weight_init, gain)((num_nodes, emb_dim), gen))
        self.node_embeddings_bias = nn.Parameter(torch.zeros((1, emb_dim)))
        r_aug = 2 * num_relations + 1

        def conv(din, dout):
            return RGCNConv(
                num_nodes, r_aug, dout, in_features=din,
                decomposition=decomposition, num_bases=num_bases,
                num_blocks=num_blocks,
                separate_self_weight=(decomposition == "block"),
                weight_init=weight_init, weight_gain=include_gain,
                bias_init=bias_init, self_loop_dropout=self_loop_dropout,
                generator=gen, group=group,
            )

        self._encoder_layers(conv, gen, emb_dim, hidden1_size or emb_dim,
                             hidden2_size)
        self.scoring_function = DistMult(
            num_nodes, num_relations, emb_dim,
            weight_init=decoder_weight_init, weight_gain=decoder_include_gain,
            bias_init=decoder_bias_init, generator=gen,
            group=group if decoder_group is None else decoder_group,
        )

    def _encoder_layers(self, conv, gen, emb_dim, nhid1, hidden2_size):
        self.rgc1 = conv(emb_dim, nhid1)
        if self.num_layers == 2:
            self.rgc2 = conv(nhid1, hidden2_size or nhid1)

    def encode(self, edges, self_masks: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        """Node embeddings after message passing: ``(N, emb_dim)``.
        ``self_masks``: one mask per layer for the self-loop dropout (a
        bool ``(N, dout)`` Schlichtkrull keep mask, or the float ``(N, 1)``
        structural mask), or None (the deterministic forward)."""
        masks = self_masks or (None,) * self.num_layers
        x = torch.relu(self.node_embeddings + self.node_embeddings_bias)
        x = self.rgc1(edges, x, masks[0])
        if self.num_layers == 2:
            x = self.rgc2(edges, torch.relu(x), masks[1])
        return x

    def compute_penalty(self, triples: torch.Tensor, z: torch.Tensor,
                        penalty_weights: Optional[torch.Tensor] = None,
                        penalty_total=None) -> torch.Tensor:
        """Decoder L2 penalty: Schlichtkrull's batch mean of squares, or the
        relation matrix's sum of squares; zero when ``decoder_l2`` is 0.
        ``penalty_weights``/``penalty_total`` weigh the batch rows by ``w
        / total`` (padded or sharded batches: pad rows drop out, the
        shards' values add up to the whole batch's); the plain L2 is then
        scaled by ``sum(w) / total``."""
        if self.decoder_l2 == 0.0:
            return z.new_zeros(())
        if self.decoder_l2_type == "schlichtkrull-l2":
            return self.scoring_function.s_penalty(triples, z, penalty_weights,
                                                   penalty_total)
        l2 = self.scoring_function.l2_penalty()
        if penalty_weights is not None:
            total = penalty_weights.sum() if penalty_total is None else penalty_total
            l2 = l2 * (penalty_weights.sum() / total)
        return l2

    def forward(self, edges, triples: torch.Tensor, self_masks=None,
                batch_layouts=None, penalty_weights=None,
                penalty_total=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(scores (B,), penalty)`` of ``(B, 3)`` triples (JAX
        ``LinkPredictor.__call__``). With ``batch_layouts`` (the batch's
        :func:`~rgcn_tpu_torch.ops.distmult_train.build_batch_layouts`), a
        bias-free decoder and the Schlichtkrull L2, the score and penalty
        are fused; otherwise the scores (scatter-free where the decoder is
        bias-free and layouts are given) and :meth:`compute_penalty`
        (``penalty_weights``, ``penalty_total``: see there)."""
        z = self.encode(edges, self_masks)
        dec = self.scoring_function
        if (batch_layouts is not None and self.decoder_l2 > 0.0
                and self.decoder_l2_type == "schlichtkrull-l2" and dec.sbias is None):
            if penalty_weights is None:
                bsz = triples.shape[0]
                pw = torch.full((bsz,), 1.0 / bsz, device=z.device)
            else:
                pw = penalty_weights / (penalty_weights.sum() if penalty_total is None
                                        else penalty_total)
            return dec.score_with_s_penalty(triples, z, pw, batch_layouts)
        return (dec(triples, z, batch_layouts=batch_layouts),
                self.compute_penalty(triples, z, penalty_weights, penalty_total))

    def structured_scores(self, edges, positives, corrupt_head, corrupt_ent, pw,
                          layouts, self_masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training scores over ``[positives ; structured negatives]`` and
        the Schlichtkrull penalty (see
        :func:`~rgcn_tpu_torch.ops.distmult_train.structured_scores`)."""
        z = self.encode(edges, self_masks)
        return self.scoring_function.structured_scores_with_penalty(
            positives, corrupt_head, corrupt_ent, z, pw, layouts)

    def score_heads(self, batch: torch.Tensor, z: torch.Tensor,
                    candidate_slice=None) -> torch.Tensor:
        return self.scoring_function.score_heads(batch, z, candidate_slice)

    def score_tails(self, batch: torch.Tensor, z: torch.Tensor,
                    candidate_slice=None) -> torch.Tensor:
        return self.scoring_function.score_tails(batch, z, candidate_slice)


class CompressionRelationPredictor(LinkPredictor):
    """c-RGCN: the bottlenecked encoder with a residual decode.

    The R-GCN layers run at ``hidden1_size`` (and ``hidden2_size``)
    between ``encoding_layer`` (``emb_dim -> hidden1_size``) and
    ``decoding_layer`` (back to ``emb_dim``), both
    :class:`~rgcn_tpu_torch.nn.layers.TorchLinear`; ``z = E +
    decoding_layer(x)``, so ``E`` reaches ``z`` through the ReLU and
    directly, and its gradient is the sum of both paths. The decoder,
    penalty and scoring are :class:`LinkPredictor`'s. Parameters are drawn
    from ``torch.Generator().manual_seed(seed)`` in the order node
    embeddings, bias (zeros), encoding layer, decoding layer, R-GCN
    layer(s), decoder.
    """

    def _encoder_layers(self, conv, gen, emb_dim, nhid1, hidden2_size):
        nhid2 = hidden2_size or nhid1
        self.encoding_layer = TorchLinear(emb_dim, nhid1, gen)
        self.decoding_layer = TorchLinear(nhid2 if self.num_layers == 2 else nhid1,
                                          emb_dim, gen)
        super()._encoder_layers(conv, gen, nhid1, nhid1, hidden2_size)

    def encode(self, edges, self_masks: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        masks = self_masks or (None,) * self.num_layers
        e = self.node_embeddings
        x = self.encoding_layer(torch.relu(e + self.node_embeddings_bias))
        x = self.rgc1(edges, x, masks[0])
        if self.num_layers == 2:
            x = self.rgc2(edges, torch.relu(x), masks[1])
        return e + self.decoding_layer(x)


def build_lp_model(cfg, num_nodes: int, num_rels: int, seed: int = 0,
                   group=None, decoder_group=None) -> LinkPredictor:
    """The model a LinkPredictionExperiment config describes (``rgcn`` and
    ``c-rgcn`` encoders), with the self-loop dropout rate of a
    ``schlichtkrull-dropout`` config (general edge dropout is the
    trainer's); ``group``/``decoder_group`` as :class:`LinkPredictor`'s."""
    enc, dec = cfg.encoder, cfg.decoder
    models = {"rgcn": LinkPredictor, "c-rgcn": CompressionRelationPredictor}
    if enc.model not in models:
        raise NotImplementedError(f"{enc.model!r} encoder has not been implemented")
    decomp, ed = enc.decomposition, enc.edge_dropout
    sl_dropout = (ed.self_loop if ed is not None
                  and ed.self_loop_type == "schlichtkrull-dropout" else 0.0)
    return models[enc.model](
        num_nodes=num_nodes,
        num_relations=num_rels,
        emb_dim=enc.node_embedding or 200,
        hidden1_size=enc.hidden1_size,
        hidden2_size=enc.hidden2_size,
        num_layers=enc.num_layers,
        decomposition=decomp.type if decomp else None,
        num_bases=decomp.num_bases if decomp else 0,
        num_blocks=decomp.num_blocks if decomp else 0,
        weight_init=enc.weight_init,
        include_gain=enc.include_gain,
        bias_init=enc.bias_init,
        self_loop_dropout=sl_dropout,
        decoder_l2_type=dec.l2_penalty_type,
        decoder_l2=dec.l2_penalty,
        decoder_weight_init=dec.weight_init,
        decoder_include_gain=dec.include_gain,
        decoder_bias_init=dec.bias_init,
        seed=seed,
        group=group,
        decoder_group=decoder_group,
    )
