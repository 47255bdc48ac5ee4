"""Process setup for sharded training: one process per rank over
``torch.distributed`` (counterpart of ``rgcn_tpu/dist/multihost.py``).

:func:`initialize_distributed` joins a job: torchrun's ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` unless given. The backend follows the device: CUDA ranks
use NCCL, one card each (``cuda:LOCAL_RANK``); CPU ranks use gloo. Ranks
that share a card (more ranks on a host than it has cards) need
``backend="gloo"`` from the caller, whose collectives pass through host
copies: NCCL refuses two ranks on one card, and nothing switches
quietly. :func:`spawn` starts the ranks of a job on this host itself
(the counterpart of JAX's virtual host devices: ``--virtual-devices``),
with the ``spawn`` start method only, after building the kernels and the
host libraries once in the parent.

:func:`make_mesh_2d` lays the ranks out as (replica × edge): each replica
of ``edge_size`` consecutive ranks holds the whole graph split into edge
shards and reduces its layers' partial sums over its own edge group; the
scoring batch is split over every rank and the decoder reduces over the
world. :func:`collective_bytes_per_step` is the JAX package's analytic
traffic model, unchanged.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rgcn_tpu_torch.device import resolve_device
from rgcn_tpu_torch.dist.mesh import Mesh

__all__ = [
    "REPLICA_AXIS",
    "collective_bytes_per_step",
    "initialize_distributed",
    "make_mesh_2d",
    "same_on_every_rank",
    "spawn",
]

REPLICA_AXIS = "replica"
INIT_TIMEOUT_S = 120


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"{name} is not set: start the ranks with torchrun or "
                         "pass it explicitly")
    return int(os.environ[name])


def initialize_distributed(
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout_s: float = INIT_TIMEOUT_S,
) -> torch.device:
    """Join the job as ``rank`` of ``world_size`` and return this rank's
    device. ``device``: None means CUDA (``cuda:local_rank``, which must
    exist), ``"cpu"`` a CPU rank. ``backend``: None means NCCL on CUDA
    and gloo on the CPU; ranks that share a card raise unless it is
    ``"gloo"``. ``init_method``: default ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); ``file://<path>`` uses a file store."""
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None \
        else int(local_rank)
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        shared = local_world_size > cards
        backend = backend or "nccl"
        if shared and backend != "gloo":
            raise ValueError(
                f"{local_world_size} ranks share {cards} card(s): NCCL takes one "
                f"card a rank, so pass backend='gloo' (asked for {backend!r})")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"CPU ranks reduce with gloo, not {backend!r}")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh_2d(
    num_replicas: Optional[int] = None,
    edge_size: Optional[int] = None,
    device=None,
) -> Mesh:
    """(replica × edge) mesh over every rank of the job: replica ``i`` is
    ranks ``[i·E, (i+1)·E)``. Defaults: one replica per host
    (``WORLD_SIZE / LOCAL_WORLD_SIZE``, so the layers' reductions stay on
    a host); explicit sizes must multiply to the world size. Every rank
    calls this, in the same order, since each edge group is a new
    process group."""
    from rgcn_tpu_torch.dist.mesh import rank_device

    world = dist.get_world_size()
    if num_replicas is None and edge_size is not None:
        num_replicas = world // edge_size
    elif num_replicas is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_replicas = world // local if world % local == 0 else 1
    if edge_size is None:
        edge_size = world // num_replicas
    if num_replicas * edge_size != world:
        raise ValueError(f"mesh {num_replicas}x{edge_size} != {world} ranks")
    rank = dist.get_rank()
    group = dist.group.WORLD
    if num_replicas > 1:
        for i in range(num_replicas):
            g = dist.new_group(list(range(i * edge_size, (i + 1) * edge_size)))
            if rank // edge_size == i:
                group = g
    return Mesh(rank=rank, world_size=world, device=rank_device(device),
                group=group, decoder_group=dist.group.WORLD,
                edge_size=edge_size, num_replicas=num_replicas)


def collective_bytes_per_step(
    num_nodes: int,
    hidden_sizes,
    num_params: int,
    edge_size: int,
    num_replicas: int,
    dtype_bytes: int = 4,
) -> dict:
    """Analytic per-step collective traffic (ring all-reduce model:
    ``2 (K-1)/K × payload`` per reduction), bytes per rank per step, split
    by the group the collective rides."""

    def ring(payload, k):
        return 0 if k <= 1 else int(2 * (k - 1) / k * payload)

    ici = sum(
        ring(num_nodes * h * dtype_bytes, edge_size) for h in hidden_sizes
    )
    k_total = edge_size * num_replicas
    grads = ring(num_params * dtype_bytes, k_total)
    return {
        "ici_bytes_per_step": ici,
        "grad_reduce_bytes_per_step": grads,
        "dcn_bytes_per_step": ring(num_params * dtype_bytes, num_replicas),
    }


# -- spawning the ranks of a job on this host ----------------------------------

def _to_host(obj):
    """Tensors in a rank's result as numpy (results cross a pipe)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world_size, init_method, device, backend, num_threads,
               args, results):
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        dev = initialize_distributed(
            rank, world_size, local_rank=rank, local_world_size=world_size,
            device=device, backend=backend, init_method=init_method)
        results.put((rank, True, _to_host(fn(dev, *args))))
    except BaseException:  # reported to the parent, which fails the job
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _failures(results, rank: int, trace: str, grace_s: float = 2.0) -> str:
    """The first failure, and any other that arrives within ``grace_s``
    (a rank's failure often makes its peers' collectives fail too)."""
    lines = [f"rank {rank} failed:\n{trace}"]
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            other, ok, value = results.get(timeout=max(0.01, deadline - time.monotonic()))
        except queue_mod.Empty:
            break
        if not ok:
            lines.append(f"rank {other} failed:\n{value}")
    return "\n".join(lines)


def spawn(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
          device=None, backend: Optional[str] = None,
          num_threads: Optional[int] = None, timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(device, *args)`` on ``world_size`` new ranks of one job on
    this host and return their results in rank order (tensors come back
    as numpy; ``fn`` must be importable by name, and so must ``args``).
    ``device``/``backend``: as :func:`initialize_distributed` (CPU ranks
    use gloo and, unless ``num_threads`` says otherwise, share the cores;
    CUDA ranks share the cards round-robin, so more ranks than cards need
    ``backend="gloo"``). The job meets through a file store in
    a fresh temporary directory. The kernels (CUDA ranks) and the host
    libraries are built here first, so the ranks load them and no rank
    runs a compiler. A rank that raises, exits or outlives ``timeout_s``
    ends the job: the others are terminated and this raises with the
    failing rank's traceback."""
    import multiprocessing as mp

    dev = resolve_device(device)
    if num_threads is None and dev.type == "cpu":
        num_threads = max(1, (os.cpu_count() or 1) // world_size)
    from rgcn_tpu_torch import native

    native.build_all()
    if dev.type == "cuda":
        from rgcn_tpu_torch.kernels.build import build_all

        build_all()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="rgcn_tpu_torch_ranks_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world_size, init_method, None if dev.type == "cuda" else "cpu",
                  backend, num_threads, tuple(args), results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        out: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"ranks {sorted(set(range(world_size)) - set(out))} gave "
                            f"no result within {timeout_s:.0f} s")
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and not p.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(_failures(results, rank, value))
                out[rank] = value
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
            codes = [p.exitcode for p in procs]
            if any(c != 0 for c in codes):
                raise RuntimeError(f"ranks exited with codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [out[r] for r in range(world_size)]


def same_on_every_rank(results: Sequence[dict]) -> float:
    """Largest absolute difference of any array in ``results[k]`` (dicts,
    nested or not) from ``results[0]``'s (0.0: every rank holds the same
    bits)."""
    worst = 0.0
    for other in results[1:]:
        for key, ref in results[0].items():
            if isinstance(ref, dict):
                worst = max(worst, same_on_every_rank([ref, other[key]]))
                continue
            a, b = np.asarray(other[key], np.float64), np.asarray(ref, np.float64)
            if a.shape != b.shape:
                return float("inf")
            if a.size:
                worst = max(worst, float(np.nan_to_num(np.abs(a - b), nan=np.inf).max()))
    return worst
