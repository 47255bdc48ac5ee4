"""Ranks as a device mesh, and the edge shards of a graph (counterpart of
``rgcn_tpu/dist/mesh.py``).

Scaling model: the relation-sorted edge tiles of an :class:`EdgeSet` are
split into ``n`` equal contiguous tile ranges, one a rank (the split
``P(axis)`` makes in the JAX package, so the tile count must be a multiple
of ``n``: build with ``tile_multiple=n``). Each rank aggregates its own
edges into partial node sums; one all-reduce over the edge group (inside
:class:`~rgcn_tpu_torch.nn.layers.RGCNConv` through its ``group``)
recovers the full sums. Node features and parameters are replicated. The
edge values are the whole graph's normalisation, computed before the
split: a shard never renormalises its own edges.

Every per-shard structure is built on the host, as the port builds all
its structures: :func:`prepare_sharded_layouts` attaches a shard's
destination layout and reversed edges (bit-equal to the JAX package's
in-jit builders run on that shard), :func:`prepare_sharded_pairs_host` a
shard's unique-(src, rel) pair index and composed layouts at bounds that
are the same on every shard, so every rank runs the same collectives on
tensors of one shape, an all-pad shard included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from rgcn_tpu_torch.device import resolve_device
from rgcn_tpu_torch.graph.structure import EdgeSet

__all__ = [
    "EDGE_AXIS",
    "Mesh",
    "make_mesh",
    "prepare_sharded_layouts",
    "prepare_sharded_pairs_host",
    "rank_device",
    "shard_edge_set",
]

EDGE_AXIS = "edge"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (replica × edge) grid of ranks: ``group``
    is its edge group (the ranks that split one copy of the graph; the
    layers reduce over it), ``decoder_group`` every rank (the scoring
    batch is split over all of them). A 1-D mesh has one replica, and
    both groups are the world."""

    rank: int
    world_size: int
    device: torch.device
    group: object
    decoder_group: object
    edge_size: int
    num_replicas: int = 1

    @property
    def edge_rank(self) -> int:
        """This rank's edge shard."""
        return self.rank % self.edge_size

    @property
    def size(self) -> int:
        return self.world_size

    @property
    def shape(self) -> dict:
        return {"replica": self.num_replicas, EDGE_AXIS: self.edge_size}


def rank_device(device=None) -> torch.device:
    """``device`` resolved (None: the CUDA device this rank was set to)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D edge mesh over every rank of the initialised job
    (:func:`~rgcn_tpu_torch.dist.multihost.initialize_distributed`);
    ``num_devices``, when given, must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: call "
                           "rgcn_tpu_torch.dist.initialize_distributed first")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"requested {num_devices} devices, the job has {world} ranks")
    return Mesh(rank=dist.get_rank(), world_size=world, device=rank_device(device),
                group=dist.group.WORLD, decoder_group=dist.group.WORLD,
                edge_size=world)


def _check_tiles(edges: EdgeSet, n_shards: int) -> None:
    if edges.num_tiles % n_shards:
        raise ValueError(
            f"num_tiles ({edges.num_tiles}) not divisible by the edge shards "
            f"({n_shards}); build the EdgeSet with tile_multiple={n_shards}")


def shard_edge_set(edges: EdgeSet, n_shards: int, shard: int) -> EdgeSet:
    """Tiles ``[shard·T/n, (shard+1)·T/n)`` of a host EdgeSet, with the
    whole graph's metadata (``num_edges`` stays the global count) and no
    layouts."""
    _check_tiles(edges, n_shards)
    rows = edges.src.shape[0] // n_shards
    tiles = edges.num_tiles // n_shards
    sl = slice(shard * rows, (shard + 1) * rows)
    return EdgeSet(
        src=edges.src[sl], dst=edges.dst[sl], rel=edges.rel[sl], val=edges.val[sl],
        tile_rel=edges.tile_rel[shard * tiles:(shard + 1) * tiles],
        num_nodes=edges.num_nodes, num_rels=edges.num_rels,
        tile_size=edges.tile_size, num_edges=edges.num_edges)


def prepare_sharded_layouts(edges: EdgeSet, row_block: int = 256) -> EdgeSet:
    """A shard (:func:`shard_edge_set`) with its destination layout and
    reversed edges with theirs, chunk = the tile size: what the JAX
    package's in-jit builders (``build_dst_layout_dynamic``,
    ``_reverse_edge_set_dynamic``) compute on that shard, bit for bit.
    The featureful layers then run K3 + K1 per shard both ways (no fused
    layout), the featureless ones K1."""
    from rgcn_tpu_torch.graph.dynamic import attach_host_layouts

    return attach_host_layouts(edges, row_block=row_block,
                               layout_chunk=edges.tile_size)


def prepare_sharded_pairs_host(
    edges: EdgeSet,
    n_shards: int,
    shard: int,
    row_block: Optional[int] = None,
    chunk: int = 256,
) -> EdgeSet:
    """Shard ``shard`` of a bare host EdgeSet (built with
    ``tile_multiple=n_shards``, no layout) with its destination layout,
    unique-(src, rel) pair index, composed pair aggregation and
    pairs-by-source layout, padded to bounds every shard shares: the
    layout to ``nrb·chunk + ceil(E_local/chunk)·chunk`` slots, the pair
    axis to the largest shard's (extra pads repeat the zero pair), the
    two backward layouts to that pair count's bounds. Bit-equal to shard
    ``shard`` of the JAX package's builder. Pair dedup is per shard: a
    (src, rel) pair in two shards is contracted once in each."""
    from rgcn_tpu_torch.graph.structure import (
        auto_nc_row_block,
        build_pair_agg,
        build_pair_src_layout,
        build_src_rel_pairs,
    )
    from rgcn_tpu_torch.ops.aggregate import build_dst_layout

    _check_tiles(edges, n_shards)
    if edges.layout is not None or edges.pairs is not None:
        raise ValueError("pass the bare EdgeSet (no layout/pairs): per-shard "
                         "structures are built here")
    num_nodes = edges.num_nodes
    if row_block is None:
        row_block = auto_nc_row_block(num_nodes, chunk)
    e_local = edges.src.shape[0] // n_shards
    nrb = -(-num_nodes // row_block)
    l_bound = nrb * chunk + (-(-e_local // chunk)) * chunk

    # the pair axis of every shard, for the largest
    shards = [shard_edge_set(edges, n_shards, k) for k in range(n_shards)]
    u_max = max(build_src_rel_pairs(es_k).pair_src.shape[0] for es_k in shards)
    rb_grad = auto_nc_row_block(u_max, chunk)
    lb_bound = -(-u_max // rb_grad) * chunk + (-(-l_bound // chunk)) * chunk
    rb_src = auto_nc_row_block(num_nodes, chunk)
    ls_bound = -(-num_nodes // rb_src) * chunk + (-(-u_max // chunk)) * chunk

    es_k = shards[shard]
    es_k = dataclasses.replace(es_k, layout=build_dst_layout(
        np.asarray(es_k.dst), num_nodes, row_block=row_block, chunk=chunk,
        pad_to=l_bound))
    pairs = build_src_rel_pairs(es_k)
    extra = u_max - pairs.pair_src.shape[0]
    pairs = dataclasses.replace(
        pairs, pair_src=np.pad(pairs.pair_src, (0, extra)),
        pair_rel=np.pad(pairs.pair_rel, (0, extra)))
    es_k = dataclasses.replace(es_k, pairs=pairs)
    pairs = dataclasses.replace(
        pairs, agg=build_pair_agg(es_k, grad_pad_to=lb_bound),
        src_layout=build_pair_src_layout(es_k, pad_to=ls_bound))
    return dataclasses.replace(es_k, pairs=pairs)
