"""Link-prediction training (counterpart of
``rgcn_tpu/train/link_prediction.py``, its production step: the training
subgraph and the negatives built on the host, the structured DistMult
scorer where the decoder admits it).

Each epoch is one step on a freshly sampled positive subgraph:

* positives: ``select_sampler(cfg)`` with ``np.random.default_rng((seed,
  epoch))`` (the whole train set when the batch covers it);
* the subgraph: :func:`~rgcn_tpu_torch.graph.dynamic.build_edge_set_dynamic_host`
  with general edge dropout drawn from ``default_rng((seed, epoch, 7))``,
  its layouts at the row block :func:`auto_layout_row_block` picks (chunk
  256) and its reversed edges;
* negatives: :func:`~rgcn_tpu_torch.train.negative.corrupt_batch_host`
  from ``default_rng((seed, epoch, 11))``. With a bias-free decoder and a
  Schlichtkrull (or no) L2 (``cfg.structured_decoder_ok``) they are scored
  structurally over
  :func:`~rgcn_tpu_torch.ops.distmult_train.build_structured_layouts`
  (row block 512, chunk 256); otherwise (decoder biases, a plain L2) the
  same draws are assembled into the ``(P(1 + ns), 3)`` batch, scored by
  :meth:`LinkPredictor.forward` over
  :func:`~rgcn_tpu_torch.ops.distmult_train.build_batch_layouts` (row
  block 128, chunk 256), as the JAX trainer's hosted step does;
* self-loop dropout (``schlichtkrull-dropout``): one bool ``(N, dout)``
  keep mask per layer, ``rng.random((N, dout), dtype=float32) < 1 - rate``
  in layer order from ``default_rng((seed, epoch, 13))``; of any other
  type (structural): one float ``(N, 1)`` mask, ``rng.random((N, 1),
  dtype=float32) < 1 - rate`` from the same generator, shared by every
  layer and multiplied into its self message without a rescale. The JAX
  trainer draws both with ``jax.random``, which numpy cannot reproduce;
  every other draw above is the JAX trainer's own.

The loss is the mean sigmoid cross-entropy over ``[positives ;
negatives]`` plus ``l2_penalty`` times the decoder's penalty
(Schlichtkrull's batch mean of squares, or the relation matrix's sum of
squares); one optimizer step (``train/optim.py``) follows. The subgraph's sorts and
every destination layout run in the port's C++ builders
(:mod:`rgcn_tpu_torch.graph.native`; ``sample_epoch(prefer_native=False)``
runs numpy, with the same batch). A background thread builds the
next two epochs' host data while the card runs the step; each epoch's draws
depend only on ``(seed, epoch)``, so the schedule is the same as without
it. Every ``check_every`` epochs (not the last) and after the last,
:func:`evaluate_link_predictor` encodes the whole training graph once (the
merged layout where the encoder reads one, as the JAX trainer builds it)
and ranks the test triples. Records go to a
:class:`~rgcn_tpu_torch.utils.logging.ScalarLogger` under the JAX
package's names.

On the card the step runs on the kernels: a basis encoder (lp-WN18) K4
forward and K4 over the reversed edges for dx; a block encoder (lp-FB-toy)
K3 then K1 both ways; a c-RGCN encoder (``configs/c-rgcn/``) its dense
R-GCN at the compressed width, K3 then K1 both ways, between two dense
bottleneck products; the structured decoder's backward two K4 sums for
the corrupted entities and K1 for the subjects' and objects' rows, the
assembled batch's K1 for its subjects' and its objects' rows (a biased
decoder scores through plain gathers and autograd, the JAX package's own
route there). The encoder's
``node_embedding_l2_penalty`` (set by ``configs/c-rgcn/lp-FB-toy.yaml``)
is ignored, as the JAX LP trainer ignores it: only its NC trainer reads
that key.

With ``checkpoint_dir`` the trainer saves ``{"params", "opt_state"}``
every ``checkpoint_every`` epochs (default: ``check_every``) and once more
after the last epoch unless that step was just saved or a resumed run
already sits past it; a run that finds a checkpoint there resumes at the
epoch after it, and since every host draw depends on ``(seed, epoch)``
alone, it repeats the epochs an unbroken run would have taken.
``max_epochs`` stops a run early (the last epoch it takes is then the
one the final evaluation and save follow). Not ported: the JAX package's
executable cache and its in-jit step (the traced graph builder and
``jax.random`` negatives).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rgcn_tpu_torch.device import resolve_device
from rgcn_tpu_torch.models.link_prediction import build_lp_model
from rgcn_tpu_torch.train.evaluate import (
    build_filters,
    ranking_metrics,
    ranks_from_scores,
)
from rgcn_tpu_torch.train.optim import make_optimizer
from rgcn_tpu_torch.utils.checkpoint import (
    restore_training_state,
    save_training_state,
)
from rgcn_tpu_torch.utils.logging import ScalarLogger

__all__ = [
    "LinkPredictionTrainer",
    "evaluate_link_predictor",
    "train_link_predictor",
]

PREFETCH_DEPTH = 2
# the stages of LinkPredictionTrainer.sample_epoch, in order
EPOCH_STAGES = ("sampler", "forward_sort", "dst_layout", "reverse_sort",
                "reverse_layout", "corrupt_batch", "corrupt_layout", "subject_layout",
                "object_layout", "scoring_rows", "batch_layouts", "keep_masks")


def evaluate_link_predictor(model, eval_edges, test: np.ndarray, filters,
                            batch_size: int = 512, verbose: bool = False,
                            logger: Optional[ScalarLogger] = None):
    """Filtered (or, with ``filters`` None, raw) MRR and Hits@{1,3,10} over
    head and tail prediction of ``test``: one encode of ``eval_edges``, then
    each batch's candidate scores and ranks on the model's device. Returns
    ``(mrr, hits, ranks)``, the head ranks first."""
    dev = model.node_embeddings.device
    num_test = len(test)
    test_t = torch.as_tensor(np.asarray(test, dtype=np.int64), device=dev)
    with torch.no_grad():
        z = model.encode(eval_edges)
        n = z.shape[0]
        ranks = []
        for tag, score_fn, filt, col in (
            ("head", model.score_heads, None if filters is None else filters.heads, 0),
            ("tail", model.score_tails, None if filters is None else filters.tails, 2),
        ):
            t0 = time.time()
            filt = torch.as_tensor(
                np.full((num_test, 1), n, np.int32) if filt is None else filt,
                device=dev)
            parts = [
                ranks_from_scores(score_fn(test_t[lo:lo + batch_size], z),
                                  test_t[lo:lo + batch_size, col],
                                  filt[lo:lo + batch_size])
                for lo in range(0, num_test, batch_size)
            ]
            ranks.append(torch.cat(parts).cpu().numpy())
            if verbose:
                (logger.info if logger is not None else print)(
                    f"  {tag} sweep: {num_test} triples x {n} candidates "
                    f"in {time.time() - t0:.2f}s")
    ranks = np.concatenate(ranks)
    mrr, hits = ranking_metrics(ranks)
    return mrr, hits, ranks


@dataclasses.dataclass
class EpochBatch:
    """One epoch's step inputs: numpy from :meth:`LinkPredictionTrainer.sample_epoch`,
    tensors after :meth:`to`. A structured epoch carries ``layouts``; an
    assembled one ``batch`` and ``batch_layouts`` instead."""

    positives: object  # (P, 3)
    edges: object  # EdgeSet of the subgraph, with layouts and reverse
    corrupt_head: object  # (Ns,) bool
    corrupt_ent: object  # (Ns,)
    labels: object  # (P + Ns,) f32
    layouts: Optional[tuple]  # (c_lay, s_lay, o_lay, (ce_sorted, qk_idx))
    self_masks: Optional[list]  # per layer (N, dout) bool or (N, 1) f32, or None
    batch: object = None  # (P + Ns, 3): [positives ; negatives]
    batch_layouts: Optional[tuple] = None  # (s_lay, o_lay) of ``batch``
    weights: object = None  # per scoring row, 1 real / 0 pad (a sharded batch)

    def to(self, device) -> "EpochBatch":
        def t(a):
            return None if a is None else torch.as_tensor(a).to(device)

        layouts = None
        if self.layouts is not None:
            c_lay, s_lay, o_lay, (ce_sorted, qk_idx) = self.layouts
            layouts = (c_lay.to(device), s_lay.to(device), o_lay.to(device),
                       (t(ce_sorted), t(qk_idx)))
        return EpochBatch(
            positives=t(self.positives).long(), edges=self.edges.to(device),
            corrupt_head=t(self.corrupt_head),
            corrupt_ent=None if self.corrupt_ent is None else t(self.corrupt_ent).long(),
            labels=t(self.labels), layouts=layouts, weights=t(self.weights),
            self_masks=None if self.self_masks is None
            else [t(m) for m in self.self_masks],
            batch=None if self.batch is None else t(self.batch).long(),
            batch_layouts=None if self.batch_layouts is None
            else tuple(lay.to(device) for lay in self.batch_layouts),
        )


class LinkPredictionTrainer:
    """A link predictor, its optimizer and its evaluation graph on the
    device, and the epoch schedule of the JAX trainer's production step.

    ``init_state``: a port state dict to start from (e.g. the JAX
    initialisation through ``weights.from_jax_params``); None draws the
    port's own from ``seed``. ``device``: None means CUDA, which must then
    be present; ``"cpu"`` runs the plain versions. A block encoder first
    pads ``data`` with null nodes (in place) until N is divisible by
    ``node_embedding // num_blocks``. ``checkpoint_dir``,
    ``checkpoint_every`` and ``max_epochs``: see the module docstring. The
    edge-sharded trainer
    (:class:`rgcn_tpu_torch.dist.driver.ShardedLinkPredictionTrainer`)
    overrides the groups, :meth:`sample_epoch`, :meth:`loss`,
    :meth:`evaluate`, :meth:`save` and :meth:`restore`."""

    group = None  # the encoder's edge group (None: one device)
    decoder_group = None  # the ranks the scoring batch is split over

    def __init__(self, cfg, data, seed: int = 0, tile_size: int = 128,
                 init_state: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, logger: Optional[ScalarLogger] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 max_epochs: Optional[int] = None):
        from rgcn_tpu_torch.graph.coalesce import merge_applicable
        from rgcn_tpu_torch.graph.structure import build_edge_set
        from rgcn_tpu_torch.train.samplers import select_sampler

        logger = logger or ScalarLogger()
        enc, dec = cfg.encoder, cfg.decoder
        ed = enc.edge_dropout
        dev = resolve_device(device)
        decomp = enc.decomposition
        if decomp is not None and decomp.type == "block":
            if not enc.node_embedding:
                raise ValueError("block decomposition requires node_embedding")
            added = data.pad_nodes(enc.node_embedding // decomp.num_blocks)
            if added:
                logger.info(
                    f"nodes padded to {data.num_nodes} to make it divisible by "
                    f"{enc.node_embedding // decomp.num_blocks} (added {added} "
                    "null nodes).")
        self.cfg, self.seed, self.tile_size, self.device = cfg, seed, tile_size, dev
        self.num_nodes, self.num_rels = data.num_nodes, data.num_relations
        self.train_np = np.asarray(data.train, dtype=np.int64)
        self.test_np = np.asarray(data.test, dtype=np.int64)

        model = build_lp_model(cfg, self.num_nodes, self.num_rels, seed=seed,
                               group=self.group, decoder_group=self.decoder_group)
        if init_state is not None:
            model.load_state_dict(init_state)
        self.model = model.to(dev)
        opt = cfg.training.optimiser
        self.optimizer = make_optimizer(self.model.parameters(), opt.algorithm,
                                        opt.learn_rate, opt.weight_decay)

        self.general_dropout = ed.general if ed else 0.0
        # structural self-loop dropout: one (N, 1) mask for every layer
        self.structural_rate = (ed.self_loop if ed is not None and ed.self_loop > 0.0
                                and ed.self_loop_type != "schlichtkrull-dropout"
                                else 0.0)
        self.structured = cfg.structured_decoder_ok(True)
        self.batch_size = min(cfg.training.graph_batch_size or len(self.train_np),
                              len(self.train_np))
        ns_cfg = cfg.training.negative_sampling
        self.num_neg = ns_cfg.sampling_rate if ns_cfg else 10
        self.head_prob = ns_cfg.head_prob if ns_cfg else 0.5
        self.sampler = select_sampler(cfg.training.sampling_method)
        self.l2 = dec.l2_penalty
        self.want_pen = dec.l2_penalty > 0.0 and dec.l2_penalty_type == "schlichtkrull-l2"
        self.epochs = max_epochs if max_epochs is not None else cfg.training.epochs
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every or cfg.evaluation.check_every

        merge_eval = decomp is not None and merge_applicable(
            2 * self.num_rels, decomposition=decomp.type, num_bases=decomp.num_bases)
        self.eval_edges = build_edge_set(
            self.train_np, self.num_nodes, self.num_rels, tile_size=tile_size,
            with_dst_layout=True, with_merged_layout=merge_eval).to(dev)
        self.filters = (build_filters(self.test_np, data.all_triples, self.num_nodes)
                        if cfg.evaluation.filtered else None)
        self.batch: Optional[EpochBatch] = None

    # -- the epoch's host data ----------------------------------------------
    def sample_epoch(self, epoch: int, prefer_native: bool = True,
                     times: Optional[Dict[str, float]] = None) -> EpochBatch:
        """Epoch ``epoch``'s positives, subgraph, negatives, scoring layouts
        and self-loop masks, drawn on the host from ``(seed, epoch)``. The
        sorts and layouts run in the port's C++ builders, or in numpy with
        ``prefer_native=False`` (the same batch); ``times``, when given,
        receives each stage's host seconds (:data:`EPOCH_STAGES`; a stage
        the scoring branch skips reads 0)."""
        from rgcn_tpu_torch.graph.dynamic import (
            auto_layout_row_block,
            build_edge_set_dynamic_host,
            reverse_edges,
            static_layout,
        )
        from rgcn_tpu_torch.ops.distmult_train import (
            build_batch_layouts,
            padded_layout,
            scoring_rows,
        )
        from rgcn_tpu_torch.train.negative import corrupt_batch_host

        times = {} if times is None else times
        clock = [time.perf_counter()]

        def lap(stage):
            now = time.perf_counter()
            times[stage] = now - clock[0]
            clock[0] = now

        seed, n, pn = self.seed, self.num_nodes, prefer_native
        positives = self.positives(epoch)
        lap("sampler")
        # the subgraph (build_edge_set_dynamic_host with its layouts), stage by stage
        edges = build_edge_set_dynamic_host(
            positives, n, self.num_rels, tile_size=self.tile_size,
            dropout_rate=self.general_dropout,
            dropout_rng=np.random.default_rng((seed, epoch, 7)), prefer_native=pn)
        lap("forward_sort")
        rb = auto_layout_row_block(n, 2 * len(positives))
        layout = static_layout(edges.dst, n, rb, 256, pn)
        lap("dst_layout")
        rev = reverse_edges(edges, pn)
        lap("reverse_sort")
        rev = dataclasses.replace(rev, layout=static_layout(rev.dst, n, rb, 256, pn))
        lap("reverse_layout")
        edges = dataclasses.replace(edges, layout=layout, reverse=rev)
        rng = np.random.default_rng((seed, epoch, 11))
        if self.structured:
            ch, ce = corrupt_batch_host(rng, positives, n, self.num_neg, self.head_prob,
                                        structure_only=True)
            lap("corrupt_batch")
            # build_structured_layouts (row block 512, chunk 256), stage by stage
            lays = []
            for stage, ids in (("corrupt_layout", ce),
                               ("subject_layout", positives[:, 0]),
                               ("object_layout", positives[:, 2])):
                lays.append(padded_layout(ids, n, 512, 256, pn))
                lap(stage)
            layouts = (*lays, scoring_rows(lays[0], ce, ch, len(positives)))
            lap("scoring_rows")
            times["batch_layouts"] = 0.0
            batch = batch_layouts = None
        else:
            batch, _, ch, ce = corrupt_batch_host(rng, positives, n, self.num_neg,
                                                  self.head_prob, return_structure=True)
            lap("corrupt_batch")
            times.update(dict.fromkeys(("corrupt_layout", "subject_layout",
                                        "object_layout", "scoring_rows"), 0.0))
            batch_layouts = build_batch_layouts(batch, n, prefer_native=pn)
            lap("batch_layouts")
            layouts = None
        labels = np.concatenate([np.ones(len(positives), np.float32),
                                 np.zeros(len(ce), np.float32)])
        masks = self.self_masks(epoch)
        lap("keep_masks")
        return EpochBatch(positives, edges, ch, ce, labels, layouts, masks,
                          batch, batch_layouts)

    def positives(self, epoch: int) -> np.ndarray:
        """Epoch ``epoch``'s positive triples (the whole train set when the
        batch covers it)."""
        if self.batch_size >= len(self.train_np):
            return self.train_np
        return self.sampler(self.train_np, self.batch_size,
                            np.random.default_rng((self.seed, epoch)))

    def self_masks(self, epoch: int) -> Optional[list]:
        """Epoch ``epoch``'s self-loop dropout masks (see the module
        docstring), or None without self-loop dropout."""
        n, rate = self.num_nodes, self.model.rgc1.self_loop_dropout
        if rate == 0.0 and self.structural_rate == 0.0:
            return None
        rng = np.random.default_rng((self.seed, epoch, 13))
        if rate > 0.0:
            return [rng.random((n, conv.out_features), dtype=np.float32) < 1.0 - rate
                    for conv in self._convs()]
        keep = (rng.random((n, 1), dtype=np.float32)
                < 1.0 - self.structural_rate).astype(np.float32)
        return [keep] * len(self._convs())

    def _convs(self):
        m = self.model
        return [m.rgc1] + ([m.rgc2] if m.num_layers == 2 else [])

    def set_epoch(self, epoch: int, host: Optional[EpochBatch] = None) -> None:
        """Move epoch ``epoch``'s data (``host``, or drawn now) to the
        device for :meth:`loss` and :meth:`step`."""
        self.batch = (host or self.sample_epoch(epoch)).to(self.device)

    # -- the step -------------------------------------------------------------
    def loss(self) -> torch.Tensor:
        """The current epoch's training loss, with the graph for its
        backward."""
        b = self.batch
        if b.batch is not None:
            scores, penalty = self.model(b.edges, b.batch, b.self_masks,
                                         batch_layouts=b.batch_layouts)
            return (F.binary_cross_entropy_with_logits(scores, b.labels)
                    + self.l2 * penalty)
        total = b.labels.shape[0]
        pw = torch.full((total,), 1.0 / total if self.want_pen else 0.0,
                        device=self.device)
        scores, penalty = self.model.structured_scores(
            b.edges, b.positives, b.corrupt_head, b.corrupt_ent, pw, b.layouts,
            b.self_masks)
        return F.binary_cross_entropy_with_logits(scores, b.labels) + self.l2 * penalty

    def step(self) -> float:
        """One update on the current epoch's data; returns the loss."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss()
        loss.backward()
        self.optimizer.step()
        return loss.item()

    def save(self, step: int) -> None:
        save_training_state(self.checkpoint_dir, self.model, self.optimizer, step)

    def restore(self) -> Optional[int]:
        """Load the latest checkpoint, if any; returns its step or None."""
        return restore_training_state(self.checkpoint_dir, self.model,
                                      self.optimizer, self.device)

    def evaluate(self, verbose: bool = False, logger=None):
        ev = self.cfg.evaluation
        return evaluate_link_predictor(self.model, self.eval_edges, self.test_np,
                                       self.filters, batch_size=ev.batch_size,
                                       verbose=verbose, logger=logger)

    def fit(self, logger: Optional[ScalarLogger] = None):
        """Train for the config's epochs (or ``max_epochs``), from the epoch
        after the latest checkpoint when ``checkpoint_dir`` holds one;
        returns the final ``(mrr, hits, ranks)``."""
        logger = logger or ScalarLogger()
        epochs = self.epochs
        ev = self.cfg.evaluation
        tag = "filtered" if ev.filtered else "raw"
        start = 1
        if self.checkpoint_dir:
            ck_step = self.restore()
            if ck_step is not None:
                start = ck_step + 1
                logger.info(f"resumed from checkpoint at epoch {ck_step}")
        pool = ThreadPoolExecutor(max_workers=1)
        pending: dict = {}

        def host_epoch(epoch):
            fut = pending.pop(epoch, None)
            out = fut.result() if fut is not None else self.sample_epoch(epoch)
            for e in range(epoch + 1, min(epoch + 1 + PREFETCH_DEPTH, epochs + 1)):
                if e not in pending:
                    pending[e] = pool.submit(self.sample_epoch, e)
            return out

        try:
            for epoch in range(start, epochs + 1):
                self.set_epoch(epoch, host_epoch(epoch))
                t1 = time.time()
                loss = self.step()
                t2 = time.time()
                if self.checkpoint_dir and epoch % self.checkpoint_every == 0:
                    self.save(epoch)
                if epoch % ev.check_every == 0 and epoch != epochs:
                    logger.info("Starting evaluation...")
                    mrr, hits, _ = self.evaluate(ev.verbose, logger)
                    logger.log_scalar("training.loss", loss, step=epoch)
                    logger.log_scalar("test.mrr", mrr, step=epoch)
                    for k, h in zip((1, 3, 10), hits):
                        logger.log_scalar(f"test.hits_at_{k}", h, step=epoch)
                    logger.info(
                        f"[Epoch {epoch}] Loss: {loss:.5f} Step: {(t2 - t1):.3f}s "
                        f"MRR({tag}): {mrr:.4f} Hits@1: {hits[0]:.4f} "
                        f"Hits@3: {hits[1]:.4f} Hits@10: {hits[2]:.4f}")
                else:
                    logger.log_scalar("training.loss", loss, step=epoch)
                    logger.info(f"[Epoch {epoch}] Loss: {loss:.5f} Step: {(t2 - t1):.3f}s")
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

        # the final state is what a server loads: save it unless a resumed
        # run already sits past the last epoch or the cadence just saved it
        if self.checkpoint_dir and epochs >= start and epochs % self.checkpoint_every:
            self.save(epochs)

        logger.info("Starting final evaluation...")
        mrr, hits, ranks = self.evaluate(ev.verbose, logger)
        logger.log_scalar("test.mrr", mrr, step=epochs)
        for k, h in zip((1, 3, 10), hits):
            logger.log_scalar(f"test.hits_at_{k}", h, step=epochs)
        logger.info(
            f"[Final Scores] Total Epoch {epochs} MRR({tag}): {mrr:.4f} "
            f"Hits@1: {hits[0]:.4f} Hits@3: {hits[1]:.4f} Hits@10: {hits[2]:.4f}")
        return mrr, hits, ranks


def train_link_predictor(cfg, data, seed: int = 0,
                         logger: Optional[ScalarLogger] = None,
                         tile_size: int = 128,
                         init_state: Optional[Dict[str, torch.Tensor]] = None,
                         device=None, checkpoint_dir: Optional[str] = None,
                         checkpoint_every: Optional[int] = None,
                         max_epochs: Optional[int] = None):
    """Train and evaluate; returns ``(mrr, hits, ranks, model)``. See
    :class:`LinkPredictionTrainer` for the keyword arguments."""
    trainer = LinkPredictionTrainer(cfg, data, seed=seed, tile_size=tile_size,
                                    init_state=init_state, device=device,
                                    logger=logger, checkpoint_dir=checkpoint_dir,
                                    checkpoint_every=checkpoint_every,
                                    max_epochs=max_epochs)
    mrr, hits, ranks = trainer.fit(logger)
    return mrr, hits, ranks, trainer.model
