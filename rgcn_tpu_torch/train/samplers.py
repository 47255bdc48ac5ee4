"""Positive-triple samplers for link-prediction training (counterpart of
``rgcn_tpu/train/samplers.py``, the same numpy draws).

* ``uniform``: ``k`` triples without replacement.
* ``edge-neighborhood``: weighted vertex expansion, biased toward edges
  incident to vertices already seen, so the sample is a locally dense
  subgraph. It draws ``chunk`` edges per refresh of the vertex weights
  (``chunk=1`` is the per-edge process).

Each draws from the generator it is given, so a trainer seeded per epoch
reproduces the JAX trainer's positives exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["uniform_sampling", "edge_neighborhood", "select_sampler"]


def uniform_sampling(triples: np.ndarray, sample_size: int,
                     rng: np.random.Generator) -> np.ndarray:
    idx = rng.choice(len(triples), size=sample_size, replace=False)
    return triples[idx]


# vertex -> incident-edges structure of the last graph sampled: the trainer
# samples the same triple array every epoch, and the incidence build (an
# argsort over 2E entries) would dominate otherwise. Keyed on the buffer
# address and shape, checked on a hit against a strided content
# fingerprint (another array at a reused address must rebuild).
_INCIDENCE_CACHE: dict = {}


def _fingerprint(triples: np.ndarray) -> bytes:
    n = len(triples)
    if n == 0:
        return b""
    idx = np.linspace(0, n - 1, num=min(n, 16)).astype(np.int64)
    return np.ascontiguousarray(triples[idx]).tobytes()


def _incidence(triples: np.ndarray, num_nodes: int):
    key = (triples.__array_interface__["data"][0], triples.shape, num_nodes)
    hit = _INCIDENCE_CACHE.get(key)
    if hit is not None and hit[0] == _fingerprint(triples):
        return hit[1]
    n_edges = len(triples)
    inc_idx = np.concatenate([triples[:, 0], triples[:, 2]])
    inc_edge = np.concatenate([np.arange(n_edges), np.arange(n_edges)])
    order = np.argsort(inc_idx, kind="stable")
    inc_idx, inc_edge = inc_idx[order], inc_edge[order]
    starts = np.searchsorted(inc_idx, np.arange(num_nodes + 1))
    degrees = (starts[1:] - starts[:-1]).astype(np.int64)
    out = (inc_edge, starts, degrees)
    _INCIDENCE_CACHE.clear()
    _INCIDENCE_CACHE[key] = (_fingerprint(triples), out)
    return out


def edge_neighborhood(triples: np.ndarray, sample_size: int,
                      rng: np.random.Generator, num_nodes: Optional[int] = None,
                      chunk: int = 2048) -> np.ndarray:
    """Weighted vertex-expansion sampling. Every vertex's weight is its
    count of unpicked incident edges; only seen vertices are eligible (all
    non-isolated ones while none is seen). Pick a vertex by weight, then
    one of its incident edges; drop edges already picked and duplicates
    within a chunk (later chunks make up the shortfall); mark both
    endpoints seen and decrement their counts."""
    n_edges = len(triples)
    if sample_size >= n_edges:
        return triples.copy()
    if num_nodes is None:
        num_nodes = int(triples[:, [0, 2]].max()) + 1

    inc_edge, starts, degrees = _incidence(triples, num_nodes)
    sample_counts = degrees.copy()
    seen = np.zeros(num_nodes, dtype=bool)
    picked = np.zeros(n_edges, dtype=bool)

    chosen: list = []
    n_chosen = 0
    while n_chosen < sample_size:
        weights = sample_counts * seen
        total = weights.sum()
        if total <= 0:
            weights = (sample_counts > 0).astype(np.int64)
            total = weights.sum()
            if total == 0:
                break
        k = min(chunk, sample_size - n_chosen)
        verts = rng.choice(num_nodes, size=k, p=weights / total)

        deg_v = starts[verts + 1] - starts[verts]
        valid = deg_v > 0
        verts, deg_v = verts[valid], deg_v[valid]
        offs = (rng.random(len(verts)) * deg_v).astype(np.int64)
        picks = inc_edge[starts[verts] + offs]
        picks = np.unique(picks[~picked[picks]])
        if len(picks) > sample_size - n_chosen:
            picks = picks[: sample_size - n_chosen]
        if len(picks):
            picked[picks] = True
            chosen.append(picks)
            n_chosen += len(picks)
            a, b = triples[picks, 0], triples[picks, 2]
            sample_counts -= np.bincount(np.concatenate([a, b]), minlength=num_nodes)
            seen[a] = True
            seen[b] = True
        seen[verts] = True

    out = np.concatenate(chosen) if chosen else np.empty(0, np.int64)
    return triples[out[:sample_size].astype(np.int64)]


def select_sampler(method: str):
    method = method.lower()
    if method == "uniform":
        return uniform_sampling
    if method == "edge-neighborhood":
        return edge_neighborhood
    raise NotImplementedError(f"{method!r} sampling method has not been implemented")
