"""Edge-sharded NC and LP training drivers (counterpart of
``rgcn_tpu/dist/driver.py``).

The sharded twins of the single-device trainers, run by every rank of a
mesh (:func:`~rgcn_tpu_torch.dist.mesh.make_mesh`,
:func:`~rgcn_tpu_torch.dist.multihost.make_mesh_2d`): the same
initialisation from ``seed``, the same epoch loop, records and
checkpoint cadence (the single-device trainers' :meth:`fit`), with

* node classification: the whole graph built with its tile count a
  multiple of the edge shards and the rank's shard given its layouts
  (:func:`~rgcn_tpu_torch.dist.mesh.prepare_sharded_layouts`: the dense
  R-GCN's K1 and K3 + K1, e-RGCN's diagonal K1, the few-basis K4; or, for
  more than 8 bases, :func:`~rgcn_tpu_torch.dist.mesh.prepare_sharded_pairs_host`:
  the pair path's K1). The merged (coalesced) layouts stay single-device,
  as in the JAX package; the step is the single-device step, its
  collectives inside the layers;
* link prediction: every rank draws the epoch's positives, subgraph,
  negatives and self-loop masks from ``(seed, epoch)`` as the
  single-device trainer does, in the same background pipeline, and keeps
  its edge shard (:func:`~rgcn_tpu_torch.dist.host.build_sharded_epoch_host`)
  and its slice of the scoring batch: structured
  (:func:`~rgcn_tpu_torch.dist.host.build_sharded_structured_host`) where
  ``cfg.structured_decoder_ok`` admits it, assembled otherwise; the steps
  of :mod:`rgcn_tpu_torch.dist.train`; evaluation candidate-sharded
  (:func:`~rgcn_tpu_torch.dist.evaluate.evaluate_link_predictor_sharded`);
* checkpoints: rank 0 writes, every rank restores
  (:mod:`rgcn_tpu_torch.dist.checkpoint`).

Only rank 0 logs. Not ported: the JAX driver's executable cache
(``exe_cache_dir``, ``exe_search``, ``_pin_sharded``,
``_sharded_chain_runner``): PyTorch compiles nothing per step.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rgcn_tpu_torch.dist.checkpoint import (
    restore_checkpoint_replicated,
    save_checkpoint_replicated,
)
from rgcn_tpu_torch.train.link_prediction import EpochBatch, LinkPredictionTrainer
from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer
from rgcn_tpu_torch.utils.logging import ScalarLogger

__all__ = [
    "ShardedLinkPredictionTrainer",
    "ShardedNodeClassificationTrainer",
    "train_link_predictor_sharded",
    "train_node_classifier_sharded",
]


def _rank_logger(mesh, logger: Optional[ScalarLogger]) -> ScalarLogger:
    if mesh.rank == 0:
        return logger or ScalarLogger()
    return ScalarLogger(verbose=False)


class ShardedNodeClassificationTrainer(NodeClassificationTrainer):
    """:class:`~rgcn_tpu_torch.train.node_classification.NodeClassificationTrainer`
    over this rank's edge shard of ``mesh``."""

    def __init__(self, cfg, data, mesh, seed: int = 0, tile_size: int = 128,
                 init_params: Optional[Dict[str, torch.Tensor]] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 row_block: Optional[int] = None):
        # the shard's destination layouts' row block (None: auto_nc_row_block
        # on the dense path, the pair builder's own choice on the pair path)
        self.mesh, self.group, self.row_block = mesh, mesh.group, row_block
        super().__init__(cfg, data, seed=seed, tile_size=tile_size,
                         init_params=init_params, device=mesh.device,
                         checkpoint_dir=checkpoint_dir,
                         checkpoint_every=checkpoint_every)

    def edge_set(self, cfg, data, tile_size: int):
        from rgcn_tpu_torch.dist.mesh import (
            prepare_sharded_layouts,
            prepare_sharded_pairs_host,
            shard_edge_set,
        )
        from rgcn_tpu_torch.graph.structure import auto_nc_row_block, build_edge_set

        m = self.mesh
        es = build_edge_set(data.triples, data.num_nodes, data.num_relations,
                            tile_size=tile_size, tile_multiple=m.edge_size)
        if self.pair_ok(cfg):
            return prepare_sharded_pairs_host(es, m.edge_size, m.edge_rank,
                                              row_block=self.row_block)
        return prepare_sharded_layouts(
            shard_edge_set(es, m.edge_size, m.edge_rank),
            row_block=self.row_block or auto_nc_row_block(data.num_nodes))

    def save(self, step: int) -> None:
        save_checkpoint_replicated(self.checkpoint_dir, self.model, self.optimizer,
                                   step, self.mesh)

    def restore(self) -> Optional[int]:
        return restore_checkpoint_replicated(self.checkpoint_dir, self.model,
                                             self.optimizer, self.mesh)


def train_node_classifier_sharded(cfg, data, mesh, seed: int = 0,
                                  logger: Optional[ScalarLogger] = None,
                                  tile_size: int = 128,
                                  checkpoint_dir: Optional[str] = None,
                                  checkpoint_every: Optional[int] = None,
                                  log_suffix: str = "",
                                  row_block: Optional[int] = None) -> float:
    """Train over ``mesh``; returns the final test accuracy (percent), the
    same on every rank. ``log_suffix`` is appended to the logged scalars'
    names; ``row_block`` sets the shard layouts' row block (default
    ``auto_nc_row_block(N)`` on the dense path)."""
    trainer = ShardedNodeClassificationTrainer(
        cfg, data, mesh, seed=seed, tile_size=tile_size,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        row_block=row_block)
    return trainer.fit(_rank_logger(mesh, logger), log_suffix=log_suffix)


class ShardedLinkPredictionTrainer(LinkPredictionTrainer):
    """:class:`~rgcn_tpu_torch.train.link_prediction.LinkPredictionTrainer`
    over ``mesh``: this rank's edge shard of each epoch's subgraph and its
    slice of the scoring batch (see the module docstring)."""

    def __init__(self, cfg, data, mesh, seed: int = 0, tile_size: int = 128,
                 init_state: Optional[Dict[str, torch.Tensor]] = None,
                 logger: Optional[ScalarLogger] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 max_epochs: Optional[int] = None):
        from rgcn_tpu_torch.dist.train import (
            make_sharded_lp_step_hosted,
            make_sharded_lp_step_hosted_structured,
        )

        self.mesh, self.group, self.decoder_group = mesh, mesh.group, mesh.decoder_group
        super().__init__(cfg, data, seed=seed, tile_size=tile_size,
                         init_state=init_state, device=mesh.device,
                         logger=_rank_logger(mesh, logger),
                         checkpoint_dir=checkpoint_dir,
                         checkpoint_every=checkpoint_every, max_epochs=max_epochs)
        if self.structured:
            self._step = make_sharded_lp_step_hosted_structured(
                self.model, self.optimizer, mesh.decoder_group,
                decoder_l2_weight=self.l2, want_penalty=self.want_pen)
        else:
            self._step = make_sharded_lp_step_hosted(
                self.model, self.optimizer, mesh.decoder_group,
                decoder_l2_weight=self.l2)

    def sample_epoch(self, epoch: int, prefer_native: bool = True,
                     times: Optional[Dict[str, float]] = None) -> EpochBatch:
        """This rank's share of epoch ``epoch``: its edge shard of the
        subgraph and its slice of the scoring batch, drawn from ``(seed,
        epoch)`` as :meth:`LinkPredictionTrainer.sample_epoch` draws them
        (``times`` is not filled)."""
        from rgcn_tpu_torch.dist.host import (
            build_sharded_epoch_host,
            build_sharded_structured_host,
        )
        from rgcn_tpu_torch.dist.train import slice_batch
        from rgcn_tpu_torch.train.negative import corrupt_batch_host

        m, seed, n = self.mesh, self.seed, self.num_nodes
        positives = self.positives(epoch)
        edges = build_sharded_epoch_host(
            positives, n, self.num_rels, self.tile_size, m.edge_size, m.edge_rank,
            dropout_rate=self.general_dropout,
            dropout_rng=np.random.default_rng((seed, epoch, 7)),
            prefer_native=prefer_native)
        rng = np.random.default_rng((seed, epoch, 11))
        masks = self.self_masks(epoch)
        if self.structured:
            ch, ce = corrupt_batch_host(rng, positives, n, self.num_neg, self.head_prob,
                                        structure_only=True)
            pos_k, ch_k, ce_k, labels, w, lays = build_sharded_structured_host(
                positives, ch, ce, n, m.size, m.rank, prefer_native=prefer_native)
            return EpochBatch(pos_k, edges, ch_k, ce_k, labels, lays, masks, weights=w)
        batch, labels = corrupt_batch_host(rng, positives, n, self.num_neg,
                                           self.head_prob)
        batch_k, labels_k, w = slice_batch(batch, labels, m.size, m.rank)
        return EpochBatch(positives, edges, None, None, labels_k, None, masks,
                          batch=batch_k, weights=w)

    def step(self) -> float:
        """One sharded update on the current epoch's data; returns the
        loss (the same on every rank)."""
        b = self.batch
        if self.structured:
            loss = self._step(b.edges, (b.positives, b.corrupt_head, b.corrupt_ent,
                                        b.labels, b.weights, b.layouts), b.self_masks)
        else:
            loss = self._step(b.edges, b.batch, b.labels, b.weights, b.self_masks)
        return loss.item()

    def evaluate(self, verbose: bool = False, logger=None):
        from rgcn_tpu_torch.dist.evaluate import evaluate_link_predictor_sharded

        return evaluate_link_predictor_sharded(
            self.model, self.eval_edges, self.test_np, self.filters, self.mesh,
            batch_size=max(self.cfg.evaluation.batch_size, 16))

    def save(self, step: int) -> None:
        save_checkpoint_replicated(self.checkpoint_dir, self.model, self.optimizer,
                                   step, self.mesh)

    def restore(self) -> Optional[int]:
        return restore_checkpoint_replicated(self.checkpoint_dir, self.model,
                                             self.optimizer, self.mesh)


def train_link_predictor_sharded(cfg, data, mesh, seed: int = 0,
                                 logger: Optional[ScalarLogger] = None,
                                 tile_size: int = 128,
                                 max_epochs: Optional[int] = None,
                                 checkpoint_dir: Optional[str] = None,
                                 checkpoint_every: Optional[int] = None):
    """Train and evaluate over ``mesh``; returns ``(mrr, hits, ranks,
    model)``, the same on every rank."""
    trainer = ShardedLinkPredictionTrainer(
        cfg, data, mesh, seed=seed, tile_size=tile_size,
        logger=logger, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, max_epochs=max_epochs)
    mrr, hits, ranks = trainer.fit(_rank_logger(mesh, logger))
    return mrr, hits, ranks, trainer.model
