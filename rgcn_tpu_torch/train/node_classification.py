"""Node-classification training (counterpart of
``rgcn_tpu/train/node_classification.py``).

The epoch is the JAX trainer's: full-batch cross-entropy over the train
nodes (mean) plus ``layer1_l2_penalty · layer1_l2()`` (R-GCN) or
``node_embedding_l2_penalty · embedding_l2()`` (e-RGCN), one optimizer step,
the loss read back, then one forward under ``torch.no_grad()`` whose
argmax gives the train and test accuracy; after the last epoch one more
prediction gives the final test accuracy. The records go to a
:class:`~rgcn_tpu_torch.utils.logging.ScalarLogger` under the JAX
package's names and suffixes. The EdgeSet is built as the JAX trainer
builds it (destination, fused and reversed layouts; the merged layout where
``merge_applicable`` says so, e-RGCN's diagonal layer included; for basis
configs with more than 8 bases the unique-(src, rel) pair index with its
composed and by-source layouts; ``auto_nc_row_block``) and moved to the
device once.

On the card every family trains through the kernels. The dense R-GCN
(nc-AIFB): layer 1's K1 with the gather ``g[dst]`` as its backward, layer
2's K2 (or K3 then K1) with dx over ``edges.reverse`` on the same kernels
(:func:`~rgcn_tpu_torch.ops.rel_spmm.rel_spmm_ad`). Basis decomposition
with more than 8 bases (nc-MUTAG, nc-BGS, nc-AM): both layers on the pair
path, K1 as the forward sum and as both backward sums (the pair messages'
gradient over the slots grouped by pair, the basis table's over the pairs
grouped by source; :mod:`rgcn_tpu_torch.ops.spmm`). e-RGCN (diagonal
first layer, dense second): the diagonal layer's K1 forward and K1 dx
(over the merged pair frame below 128 general relations, as on nc-AIFB;
else over the destination layout in slot order, as at AM scale), its
weight gradient a small product or an ``index_add_``, and layer 2 as in
the dense R-GCN. Basis decomposition with at most 8 bases: layer 1's
featureless K4 forward with K4 over ``edges.reverse`` for the basis
tables' gradient, layer 2's K4 over the merged pair frame (at most 128
general relations, nc-AIFB) with K4 over its reverse frame for dx, or
over the destination layout with K4 over ``edges.reverse`` (nc-AM's 532
relations); e-RGCN's ``rgc1`` takes the same basis routes, and with block
decomposition its expanded blocks through K2 (or K3 then K1) both ways.
The R-GCN's featureless layer 1 has no block form: such a config raises
the layer's ``NotImplementedError``, as the JAX package does.

With ``checkpoint_dir`` the trainer saves ``{"params", "opt_state"}``
(:mod:`rgcn_tpu_torch.utils.checkpoint`) every ``checkpoint_every`` epochs
(default 10) and once more after the last epoch unless that step was just
saved or a resumed run already sits past it; a run that finds a checkpoint
there resumes at the epoch after it. The JAX package's executable cache is
not ported: PyTorch compiles nothing per step.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rgcn_tpu_torch.device import resolve_device
from rgcn_tpu_torch.models.node_classification import build_nc_model
from rgcn_tpu_torch.train.evaluate import accuracy
from rgcn_tpu_torch.train.optim import make_optimizer
from rgcn_tpu_torch.utils.checkpoint import (
    restore_training_state,
    save_training_state,
)
from rgcn_tpu_torch.utils.logging import ScalarLogger

__all__ = [
    "NodeClassificationTrainer",
    "build_nc_model",
    "nc_loss",
    "run_repeats",
    "train_node_classifier",
]


def nc_loss(model, edges, train_idx, train_lbl, layer1_l2: float = 0.0,
            embedding_l2: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over the train nodes plus ``layer1_l2 ·
    layer1_l2()`` and ``embedding_l2 · embedding_l2()`` where nonzero."""
    loss = F.cross_entropy(model(edges)[train_idx], train_lbl)
    if layer1_l2 > 0.0:
        loss = loss + layer1_l2 * model.layer1_l2()
    if embedding_l2 > 0.0:
        loss = loss + embedding_l2 * model.embedding_l2()
    return loss


class NodeClassificationTrainer:
    """One model, its optimizer and its EdgeSet on the device: the state
    :func:`train_node_classifier` carries from epoch to epoch.

    ``init_params``: a port state dict to start from (e.g. carried from the
    JAX package by ``weights.from_jax_params``); None draws the port's own
    initialisation from ``seed``. ``device``: None means CUDA, which must
    then be present; ``"cpu"`` runs the plain versions.
    ``checkpoint_dir`` and ``checkpoint_every``: where and how often
    :meth:`fit` saves, and where it resumes from. The edge-sharded trainer
    (:class:`rgcn_tpu_torch.dist.driver.ShardedNodeClassificationTrainer`)
    overrides :attr:`group`, :meth:`edge_set`, :meth:`save` and
    :meth:`restore`."""

    group = None  # the edge group the model reduces over (None: one device)

    def __init__(self, cfg, data, seed: int = 0, tile_size: int = 128,
                 init_params: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None):
        rg = cfg.rgcn
        if rg.node_embedding_l2_penalty > 0.0 and rg.model != "e-rgcn":
            raise ValueError(
                f"cannot apply L2-regularisation on node embeddings for "
                f"{rg.model} model"
            )
        dev = resolve_device(device)
        model = build_nc_model(cfg, data, seed=seed, group=self.group)
        self.edges = self.edge_set(cfg, data, tile_size).to(dev)
        self.train_idx_np, self.train_lbl_np = data.index_labels(data.train)
        self.test_idx_np, self.test_lbl_np = data.index_labels(data.test)
        self.train_idx = torch.as_tensor(self.train_idx_np, device=dev)
        self.train_lbl = torch.as_tensor(self.train_lbl_np, device=dev)

        if init_params is not None:
            model.load_state_dict(init_params)
        self.model = model.to(dev)
        opt = cfg.training.optimiser
        self.optimizer = make_optimizer(self.model.parameters(), opt.algorithm,
                                        opt.learn_rate, opt.weight_decay)
        self.l1_pen = rg.layer1_l2_penalty
        self.emb_pen = rg.node_embedding_l2_penalty
        self.epochs = cfg.training.epochs
        self.device = dev
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every or 10

    @staticmethod
    def pair_ok(cfg) -> bool:
        """The JAX trainer's pair_ok: many-basis layers contract once per
        unique (src, rel) pair."""
        decomp = cfg.rgcn.decomposition
        return (cfg.rgcn.model == "rgcn" and decomp is not None
                and decomp.type == "basis" and decomp.num_bases > 8)

    def edge_set(self, cfg, data, tile_size: int):
        """The host EdgeSet the model trains on."""
        from rgcn_tpu_torch.graph.coalesce import merge_applicable
        from rgcn_tpu_torch.graph.structure import auto_nc_row_block, build_edge_set

        decomp = cfg.rgcn.decomposition
        merge_ok = merge_applicable(
            2 * data.num_relations,
            decomposition=decomp.type if decomp else None,
            num_bases=decomp.num_bases if decomp else 0,
            diag=cfg.rgcn.model == "e-rgcn",
        )
        pair_ok = self.pair_ok(cfg)
        return build_edge_set(
            data.triples, data.num_nodes, data.num_relations,
            tile_size=tile_size, with_dst_layout=True,
            with_merged_layout=merge_ok,
            with_pair_index=pair_ok, with_pair_agg=pair_ok,
            layout_row_block=auto_nc_row_block(data.num_nodes),
        )

    def save(self, step: int) -> None:
        save_training_state(self.checkpoint_dir, self.model, self.optimizer, step)

    def restore(self) -> Optional[int]:
        """Load the latest checkpoint, if any; returns its step or None."""
        return restore_training_state(self.checkpoint_dir, self.model,
                                      self.optimizer, self.device)

    def loss(self) -> torch.Tensor:
        """The training loss, with the graph for its backward."""
        return nc_loss(self.model, self.edges, self.train_idx, self.train_lbl,
                       self.l1_pen, self.emb_pen)

    def step(self) -> float:
        """One update: forward, backward, optimizer step; returns the loss."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss()
        loss.backward()
        self.optimizer.step()
        return loss.item()

    def logits(self) -> torch.Tensor:
        with torch.no_grad():
            return self.model(self.edges)

    def predict(self) -> np.ndarray:
        """Predicted class of every node, on the host."""
        return self.logits().argmax(-1).cpu().numpy()

    def fit(self, logger: Optional[ScalarLogger] = None, log_suffix: str = "") -> float:
        """Train for the config's epochs (from the epoch after the latest
        checkpoint, when ``checkpoint_dir`` holds one); returns the final
        test accuracy (percent)."""
        logger = logger or ScalarLogger()
        start = 1
        if self.checkpoint_dir:
            ck_step = self.restore()
            if ck_step is not None:
                start = ck_step + 1
                logger.info(f"resumed from checkpoint at epoch {ck_step}")
        for epoch in range(start, self.epochs + 1):
            t1 = time.time()
            loss = self.step()
            t2 = time.time()

            pred = self.predict()
            train_acc = accuracy(pred[self.train_idx_np], self.train_lbl_np)
            test_acc = accuracy(pred[self.test_idx_np], self.test_lbl_np)
            t3 = time.time()

            logger.log_scalar(f"training.loss{log_suffix}", loss, step=epoch)
            logger.log_scalar(f"training.accuracy{log_suffix}", train_acc, step=epoch)
            logger.log_scalar(f"test.accuracy{log_suffix}", test_acc, step=epoch)
            logger.info(
                f"[Epoch {epoch}] Loss: {loss:.5f} Step: {(t2 - t1):.3f}s "
                f"Eval: {(t3 - t2):.3f}s Train Accuracy: {train_acc:.2f} "
                f"Test Accuracy: {test_acc:.2f}"
            )
            if self.checkpoint_dir and epoch % self.checkpoint_every == 0:
                self.save(epoch)

        # no final save when a resumed run already sits past the last epoch
        # (its parameters would be mislabelled) or the cadence just saved it
        if self.checkpoint_dir and self.epochs >= start \
                and self.epochs % self.checkpoint_every:
            self.save(self.epochs)

        pred = self.predict()
        test_acc = accuracy(pred[self.test_idx_np], self.test_lbl_np)
        logger.log_scalar(f"test.accuracy{log_suffix}", test_acc)
        logger.info(f"[Evaluation] Test Accuracy: {test_acc:.2f}")
        return test_acc


def train_node_classifier(
    cfg,
    data,
    seed: int = 0,
    logger: Optional[ScalarLogger] = None,
    tile_size: int = 128,
    log_suffix: str = "",
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    device=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
) -> float:
    """Train one model; returns the final test accuracy (percent). See
    :class:`NodeClassificationTrainer` for the keyword arguments."""
    trainer = NodeClassificationTrainer(
        cfg, data, seed=seed, tile_size=tile_size, init_params=init_params,
        device=device, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every)
    return trainer.fit(logger, log_suffix)


def run_repeats(cfg, data, logger: Optional[ScalarLogger] = None,
                tile_size: int = 128, device=None,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every: Optional[int] = None) -> Tuple[float, float]:
    """Repeat training (repeat ``i`` seeded with ``i``) and report mean ±
    standard error (``classify_nodes.py:159-178``). With several repeats,
    repeat ``i`` checkpoints under ``checkpoint_dir/repeat_{i}``."""
    logger = logger or ScalarLogger()
    accs = []
    for i in range(1, cfg.repeats + 1):
        ck = (os.path.join(checkpoint_dir, f"repeat_{i}")
              if checkpoint_dir and cfg.repeats > 1 else checkpoint_dir)
        accs.append(train_node_classifier(
            cfg, data, seed=i, logger=logger, tile_size=tile_size,
            log_suffix=f"_{i}", device=device, checkpoint_dir=ck,
            checkpoint_every=checkpoint_every))
    avg = sum(accs) / len(accs)
    std = statistics.stdev(accs) if len(accs) > 1 else 0.0
    ste = std / (len(accs) ** 0.5)
    logger.log_scalar("test.accuracy", round(avg, 2))
    logger.log_scalar("test.accuracy_ste", round(ste, 2))
    logger.info(
        f"[Summary] Test Accuracy: {avg:.2f} -/+ {ste:.2f}"
        + (f" ({cfg.repeats} runs)" if cfg.repeats > 1 else "")
    )
    return avg, ste
