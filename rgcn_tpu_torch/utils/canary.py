"""Machine-health canary: one fixed known-floor workload, measured at the
start of a measuring run (counterpart of ``rgcn_tpu/utils/canary.py``).

A run on a throttled card, or on one shared with other work, reads slow
for reasons no code change made. The canary turns that into a number: ONE
fixed workload, the WN18-scale basis op over the merged pair frame with
its source-dedup'd forward (the JAX package's ``_build_workload``, rebuilt
bit for bit by the port's own graph code), timed with CUDA events over
chains of a data-dependent step. Its time moves only with the machine's
health, so

* a run whose canary ``ratio`` (this measurement over the floor) is at
  most :data:`HEALTHY_RATIO` is comparable to any other run under the same
  gate;
* a run with a higher ratio is flagged (and should be re-run), instead of
  recording congestion or throttling as a regression.

The floor is a ratchet: ``canary_floor.json`` in the cache directory
(default ``build/rgcn_tpu_torch/canary/``) keeps the least time ever
measured for one key, and only ever decreases. The key names what the
time belongs to: the card's name, the built library of the kernel the
step runs (K5's ``<name>-<hash>.so``, whose hash covers its sources), and
the workload's shape. A changed kernel or another card then starts a new
floor instead of reading as congestion.

The step is the JAX step's (``rgcn_tpu/utils/canary.py:105-118``): the
merged basis op with a bf16 compute dtype, so K5's bf16 form over a bf16
table with a bf16 ``Agg``, plus ``x @ w_self`` with ``w_self`` rounded to
bf16 and the product in f32, as JAX promotes it. Nothing falls back: on
the card a kernel that does not build or launch raises. Only a failed floor write is reported on stderr
and passed over. ``device="cpu"`` runs the plain versions, for tests.

Usage::

    from rgcn_tpu_torch.utils.canary import measure_canary
    c = measure_canary()   # {'ms', 'floor_ms', 'ratio', 'healthy', 'steps', 'key'}
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from rgcn_tpu_torch.device import resolve_device
from rgcn_tpu_torch.kernels.build import BUILD_DIR

__all__ = [
    "HEALTHY_RATIO",
    "build_workload",
    "canary_op",
    "canary_step",
    "default_cache_dir",
    "measure_canary",
]

# the JAX package's gate, kept: a ratio above it flags the run
HEALTHY_RATIO = 1.25

_DIM = 200
_NB = 2
_STEP_SCALE = 1e-9  # bounds the chained step's drift, keeps the data dependency


def default_cache_dir() -> str:
    return os.path.join(BUILD_DIR, "canary")


def build_workload(num_nodes: int = 40_943, num_rels: int = 18,
                   num_edges: int = 187_000, device=None):
    """The canary's inputs, ``(edges, x, (w_self, bases, comps))`` on
    ``device`` (None: the card): the synthetic WN18-scale graph (tiles of
    512), its merged pair frame with the K = 2 dedup frame as
    ``edges.merged``, ``x (N, 200)``, ``w_self (200, 200)``, ``bases (2,
    200, 200)`` and ``comps (2R, 2)`` from ``default_rng(0)`` and
    ``default_rng(1)``, drawn as ``rgcn_tpu/utils/canary.py::_build_workload``
    draws them. The defaults are the JAX workload's sizes."""
    from rgcn_tpu_torch.data.synthetic import synthetic_kg
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout
    from rgcn_tpu_torch.graph.structure import build_edge_set

    dev = resolve_device(device)
    triples = synthetic_kg(num_nodes, num_rels, num_edges, seed=0, reciprocity=0.9)
    es = build_edge_set(triples, num_nodes, num_rels, tile_size=512)
    merged = build_merged_layout(
        es.dst, es.src, es.rel, es.val, num_nodes, es.num_rels,
        row_block=128, chunk=256, dedup_k=2,
    )
    rng = np.random.default_rng(0)
    x = rng.normal(size=(num_nodes, _DIM)).astype(np.float32)
    w_self = rng.normal(size=(_DIM, _DIM)).astype(np.float32)
    rng_b = np.random.default_rng(1)
    bases = rng_b.normal(size=(_NB, _DIM, _DIM)).astype(np.float32)
    comps = rng_b.normal(size=(2 * num_rels, _NB)).astype(np.float32)
    edges = dataclasses.replace(es, merged=merged).to(dev)
    pack = tuple(torch.from_numpy(a).to(dev) for a in (w_self, bases, comps))
    return edges, torch.from_numpy(x).to(dev), pack


def canary_op(edges, x: torch.Tensor, pack,
              compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> torch.Tensor:
    """``rel_spmm_basis`` over the merged frame with the compute dtype
    (bf16, the step's: K5's bf16 form over its dedup frame) plus ``x @
    w_self`` with ``w_self`` rounded to it, the products in full f32,
    without grad. ``compute_dtype=None`` is the same op in f32."""
    from rgcn_tpu_torch.ops.basis import full_f32_matmul, rel_spmm_basis

    w_self, bases, comps = pack
    if compute_dtype is not None:
        w_self = w_self.to(compute_dtype).float()
    with torch.no_grad(), full_f32_matmul():
        return rel_spmm_basis(edges, x, bases, comps, compute_dtype=compute_dtype) \
            + x @ w_self


def canary_step(edges, x: torch.Tensor, pack) -> torch.Tensor:
    """The chained step: ``x + canary_op(x) · 1e-9`` (each step reads the
    last one's output, and the values stay bounded)."""
    return x + canary_op(edges, x, pack) * _STEP_SCALE


def _measure_step(step, x, iters: int, reps: int = 3, passes: int = 2):
    """ms per step: the least, over ``passes × reps`` chains of ``iters``
    steps each, of the chain's time over ``iters`` (CUDA events on the
    card, the host clock on the CPU). Returns ``(ms, steps run)``."""
    cuda = x.device.type == "cuda"
    step(x)  # warm: first launches, allocator
    best = float("inf")
    for _ in range(passes * reps):
        y = x
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                y = step(y)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                y = step(y)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best, 1 + passes * reps * iters


def _key(edges, x) -> str:
    """The floor's key: the card, the built library of the step's kernel,
    the workload's shape."""
    from rgcn_tpu_torch.kernels.build import library_path

    # the merged frame carries its dedup frame; the bf16 table takes K5's bf16 form
    name = "k5_weighted_aggregate_dedup_bf16"
    if x.device.type == "cuda":
        card = torch.cuda.get_device_name(x.device)
        kernel = os.path.basename(library_path(name))
    else:
        card, kernel = "cpu", f"{name} (plain)"
    return json.dumps({
        "card": card, "kernel": kernel, "nodes": int(x.shape[0]),
        "dim": int(x.shape[1]), "bases": _NB, "edges": int(edges.num_edges),
        "pairs": int(edges.merged.num_pairs),
    }, sort_keys=True)


def _floor_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, "canary_floor.json")


def _read_floor(cache_dir: str, key: str) -> Optional[float]:
    try:
        with open(_floor_path(cache_dir)) as f:
            d = json.load(f)
    except (FileNotFoundError, NotADirectoryError):  # no floor yet
        return None
    return float(d["floor_ms"]) if d.get("key") == key else None


def _write_floor(cache_dir: str, key: str, floor_ms: float) -> None:
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = _floor_path(cache_dir) + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"key": key, "floor_ms": floor_ms}, f)
        os.replace(tmp, _floor_path(cache_dir))
    except OSError as e:
        print(f"canary: floor write failed ({e})", file=sys.stderr)


def measure_canary(
    cache_dir: Optional[str] = None,
    iters: int = 100,
    passes: int = 2,
    tag: str = "",
    verbose: bool = True,
    device=None,
) -> dict:
    """Measure the canary; returns ``{'ms', 'floor_ms', 'ratio', 'healthy',
    'steps', 'key'}``: this run's ms per step, the floor after it, their
    ratio, whether the ratio is at most :data:`HEALTHY_RATIO`, the steps
    launched (one warm step and ``passes × 3`` chains of ``iters``), and
    the floor's key. ``device``: None means the card, which must then be
    present. The workload is built before the timed chains."""
    cache_dir = cache_dir or default_cache_dir()
    edges, x, pack = build_workload(device=device)
    key = _key(edges, x)
    ms, steps = _measure_step(lambda y: canary_step(edges, y, pack), x, iters,
                              passes=passes)
    floor = _read_floor(cache_dir, key)
    if floor is None or ms < floor:
        _write_floor(cache_dir, key, ms)
        floor = ms
    ratio = ms / floor
    out = {"ms": ms, "floor_ms": floor, "ratio": ratio,
           "healthy": ratio <= HEALTHY_RATIO, "steps": steps, "key": key}
    if verbose:
        state = "healthy" if out["healthy"] else "SLOW: throttled or shared?"
        print(f"canary{f'[{tag}]' if tag else ''}: {ms:.4f} ms (floor "
              f"{floor:.4f}, ratio {ratio:.3f}) -> {state}",
              file=sys.stderr, flush=True)
    return out
