"""Serving (counterpart of ``rgcn_tpu/serve.py``).

* Node classification: one full forward at construction, queries are row
  lookups.
* Link prediction: the graph is encoded once at construction and ``z``
  stays on the device; queries are DistMult algebra (a ``(B, d) @ (d, N)``
  product and ``top-k``), only the ``(B, k)`` answers cross to the host.

:func:`load_nc_server` and :func:`load_lp_server` serve the parameters of
a training checkpoint (``checkpoint_dir``, :mod:`rgcn_tpu_torch.utils.checkpoint`),
or a ``state_dict`` (e.g. carried from the JAX package with
:func:`rgcn_tpu_torch.weights.from_jax_params`), or with neither the port's
own seeded initialisation.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from rgcn_tpu_torch.device import resolve_device
from rgcn_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint

__all__ = [
    "LinkPredictionServer",
    "NodeClassificationServer",
    "load_lp_server",
    "load_nc_server",
]


class NodeClassificationServer:
    """Logits for every node, computed once; ``classify`` and
    ``probabilities`` answer from the host copy."""

    def __init__(self, model: torch.nn.Module, edges):
        self.model = model
        self.edges = edges
        self.logits = self._forward()

    def _forward(self) -> np.ndarray:
        with torch.inference_mode():
            return self.model(self.edges).float().cpu().numpy()

    def classify(self, nodes) -> np.ndarray:
        """Predicted class ids for the given node ids."""
        return np.argmax(self.logits[np.asarray(nodes)], axis=-1)

    def probabilities(self, nodes) -> np.ndarray:
        logit = self.logits[np.asarray(nodes)]
        e = np.exp(logit - logit.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def refresh(self, state_dict: Optional[Dict[str, torch.Tensor]] = None):
        """Recompute the logits, after loading ``state_dict`` if given."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.logits = self._forward()


def _checkpoint_params(checkpoint_dir: str, state_dict) -> Optional[dict]:
    """The ``params`` of the latest checkpoint under ``checkpoint_dir`` (on
    the host), or None when it holds none."""
    if state_dict is not None:
        raise ValueError("pass either state_dict or checkpoint_dir, not both")
    state, _ = restore_checkpoint(checkpoint_dir, partial_keys=("params",),
                                  map_location="cpu")
    return None if state is None else state["params"]


def load_nc_server(
    cfg,
    data,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    *,
    checkpoint_dir: Optional[str] = None,
    tile_size: int = 128,
    device=None,
) -> Optional[NodeClassificationServer]:
    """Build a node-classification endpoint.

    ``cfg``: a :class:`~rgcn_tpu_torch.config.NodeClassificationExperiment`
    or a path to its YAML file. ``state_dict``: parameters to serve; None
    serves the port's initialisation from seed 0. ``checkpoint_dir``
    instead serves the parameters of its latest training checkpoint, or
    of ``repeat_1``'s when it holds none itself (a run of several
    repeats), and returns None when neither holds one. ``device``: None means
    CUDA, which must then be present; ``"cpu"`` runs the plain versions.
    The EdgeSet is built as the JAX server builds it (tiles of
    ``tile_size`` edges, destination layout, fused layout and reversed edges, and the merged pair layout
    when ``merge_applicable`` says a layer reads it: the e-RGCN diagonal
    layer, or a basis layer with at most 8 bases) and moved to the device
    once.
    """
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.graph.coalesce import merge_applicable
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.models.node_classification import build_nc_model

    dev = resolve_device(device)
    if not hasattr(cfg, "rgcn"):
        cfg = load_experiment(cfg)
    if checkpoint_dir is not None:
        repeat_1 = os.path.join(checkpoint_dir, "repeat_1")
        if latest_step(checkpoint_dir) is None and latest_step(repeat_1) is not None:
            checkpoint_dir = repeat_1
        state_dict = _checkpoint_params(checkpoint_dir, state_dict)
        if state_dict is None:
            return None
    model = build_nc_model(cfg, data)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(dev).eval()
    rg = cfg.rgcn
    decomp = rg.decomposition
    merge = merge_applicable(
        2 * data.num_relations,
        decomposition=decomp.type if decomp else None,
        num_bases=decomp.num_bases if decomp else 0,
        diag=rg.model == "e-rgcn")
    edges = build_edge_set(
        data.triples, data.num_nodes, data.num_relations,
        tile_size=tile_size, with_dst_layout=True, with_merged_layout=merge,
    ).to(dev)
    return NodeClassificationServer(model, edges)


class LinkPredictionServer:
    """Encode-once DistMult serving over a :class:`LinkPredictor`.

    ``edges``: the full-graph EdgeSet to encode, on the model's device
    (built with a merged layout for basis encoders, see
    :func:`rgcn_tpu_torch.graph.coalesce.merge_applicable`). Requests are
    answered in chunks of at most ``max_batch`` queries.

    Two options of the JAX server are left out, with the same answers:
    it pads each chunk to a power-of-two bucket so that XLA compiles one
    program per bucket shape, and its ``exe_cache_dir`` persists those
    compiled programs across processes. PyTorch runs eagerly and compiles
    nothing per request, and the port's kernels are built once per
    checkout (``kernels/build.py``), so neither has work to do here.
    """

    def __init__(self, model, edges, max_batch: int = 1024, known_triples=None):
        self.model = model
        self.edges = edges
        self.max_batch = int(max_batch)
        self._known_tails = None  # (s, p) -> [o] known-true tails
        self._known_heads = None  # (p, o) -> [s] known-true heads
        # filter maps build on the first filtered request: the loop over
        # the known triples is slow at scale and unfiltered servers skip it
        self._pending_filters = known_triples
        self.z = self._encode()
        self.num_nodes = int(self.z.shape[0])

    def _encode(self) -> torch.Tensor:
        with torch.inference_mode():
            return self.model.encode(self.edges)

    def _batches(self, rows: np.ndarray):
        for lo in range(0, len(rows), self.max_batch):
            hi = min(lo + self.max_batch, len(rows))
            yield lo, hi, torch.as_tensor(
                np.asarray(rows[lo:hi], dtype=np.int64), device=self.z.device)

    # -- point scoring ----------------------------------------------------
    def score(self, triples) -> np.ndarray:
        """DistMult scores for ``(B, 3)`` ``(s, p, o)`` triples."""
        triples = np.asarray(triples)
        out = np.empty((len(triples),), np.float32)
        with torch.inference_mode():
            for lo, hi, t in self._batches(triples):
                out[lo:hi] = self.model.scoring_function(t, self.z).cpu().numpy()
        return out

    # -- filtered ranking ---------------------------------------------------
    def set_filters(self, known_triples) -> None:
        """Register the known-true triples that ``filtered=True`` ranking
        masks out (typically the training graph)."""
        tails: dict = {}
        heads: dict = {}
        for s, p, o in np.asarray(known_triples):
            tails.setdefault((int(s), int(p)), []).append(int(o))
            heads.setdefault((int(p), int(o)), []).append(int(s))
        self._known_tails = tails
        self._known_heads = heads
        self._pending_filters = None

    def _filter_rows(self, queries: np.ndarray, tails: bool):
        if self._known_tails is None and self._pending_filters is not None:
            self.set_filters(self._pending_filters)
        known = self._known_tails if tails else self._known_heads
        if known is None:
            raise ValueError(
                "filtered=True requires known triples: construct the server "
                "with known_triples=... or call set_filters() first"
            )
        if tails:
            return [known.get((int(q[0]), int(q[1])), ()) for q in queries]
        return [known.get((int(q[1]), int(q[2])), ()) for q in queries]

    # -- ranking ----------------------------------------------------------
    def topk_tails(self, sp, k: int = 10, filtered: bool = False):
        """Top-``k`` tails for ``(B, 2)`` ``(s, p)`` queries: ``(scores (B,
        k) f32, entities (B, k) int32)``, best first. ``filtered=True``
        masks the known-true candidates to ``-inf``."""
        sp = np.asarray(sp)
        queries = np.stack([sp[:, 0], sp[:, 1], np.zeros(len(sp), sp.dtype)], axis=1)
        return self._rank(queries, k, tails=True, filtered=filtered)

    def topk_heads(self, po, k: int = 10, filtered: bool = False):
        """Top-``k`` heads for ``(B, 2)`` ``(p, o)`` queries."""
        po = np.asarray(po)
        queries = np.stack([np.zeros(len(po), po.dtype), po[:, 0], po[:, 1]], axis=1)
        return self._rank(queries, k, tails=False, filtered=filtered)

    def refresh(self, state_dict: Optional[Dict[str, torch.Tensor]] = None):
        """Re-encode, after loading ``state_dict`` if given (hot swap)."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.z = self._encode()
        self.num_nodes = int(self.z.shape[0])

    def _rank(self, queries: np.ndarray, k: int, tails: bool, filtered: bool):
        rows = self._filter_rows(queries, tails) if filtered else None
        score_fn = self.model.score_tails if tails else self.model.score_heads
        scores = np.empty((len(queries), k), np.float32)
        ents = np.empty((len(queries), k), np.int32)
        with torch.inference_mode():
            for lo, hi, q in self._batches(queries):
                sc = score_fn(q, self.z)  # (B, N)
                if filtered:
                    lens = [len(r) for r in rows[lo:hi]]
                    if sum(lens):
                        flat = (np.repeat(np.arange(hi - lo), lens) * self.num_nodes
                                + np.concatenate([np.asarray(r, np.int64)
                                                  for r in rows[lo:hi] if len(r)]))
                        sc.view(-1).index_fill_(
                            0, torch.as_tensor(flat, device=sc.device), float("-inf"))
                s, e = torch.topk(sc, k, dim=1)
                scores[lo:hi] = s.cpu().numpy()
                ents[lo:hi] = e.int().cpu().numpy()
        return scores, ents


def load_lp_server(
    cfg,
    data,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    *,
    checkpoint_dir: Optional[str] = None,
    tile_size: int = 128,
    max_batch: int = 1024,
    device=None,
    feature_blocks: bool = False,
) -> Optional[LinkPredictionServer]:
    """Build a link-prediction endpoint.

    ``cfg``: a :class:`~rgcn_tpu_torch.config.LinkPredictionExperiment` or a
    path to its YAML file; ``data``: the
    :class:`~rgcn_tpu_torch.data.loaders.LinkPredictionData` to serve (its
    train triples are the graph and the filter). ``state_dict``: parameters
    to serve; None serves the port's initialisation from seed 0.
    ``checkpoint_dir`` instead serves the parameters of its latest
    training checkpoint, and returns None when it holds none.
    ``device``: None means CUDA, which must then be present; ``"cpu"`` runs
    the plain versions. A block encoder first pads ``data`` with null
    nodes until N is divisible by ``node_embedding // num_blocks``
    (:meth:`LinkPredictionData.pad_nodes`, in place, as the JAX server
    does). The EdgeSet is built as the JAX server builds it: tiles of
    ``tile_size`` edges, destination layout, and the merged pair layout
    when a basis encoder consumes it (``merge_applicable``). Queries are
    answered in chunks of at most ``max_batch``.
    """
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.graph.coalesce import merge_applicable
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.models.link_prediction import build_lp_model

    dev = resolve_device(device)
    if not hasattr(cfg, "encoder"):
        cfg = load_experiment(cfg)
    if checkpoint_dir is not None:
        state_dict = _checkpoint_params(checkpoint_dir, state_dict)
        if state_dict is None:
            return None
    decomp = cfg.encoder.decomposition
    if decomp is not None and decomp.type == "block":
        data.pad_nodes(cfg.encoder.node_embedding // decomp.num_blocks)
    num_nodes, num_rels = data.num_nodes, data.num_relations
    model = build_lp_model(cfg, num_nodes, num_rels, feature_blocks=feature_blocks)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(dev).eval()
    merge = decomp is not None and merge_applicable(
        2 * num_rels, decomposition=decomp.type, num_bases=decomp.num_bases)
    train = np.asarray(data.train, dtype=np.int64)
    edges = build_edge_set(
        train, num_nodes, num_rels, tile_size=tile_size,
        with_dst_layout=True, with_merged_layout=merge,
    ).to(dev)
    return LinkPredictionServer(model, edges, max_batch=max_batch,
                                known_triples=train)
