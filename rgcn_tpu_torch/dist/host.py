"""Host-built epoch inputs of the sharded LP steps (counterpart of
``rgcn_tpu/dist/host.py``).

Every rank draws the same ``(seed, epoch)`` streams, builds the same
subgraph and keeps its own shard of it, so no rank sends another any
input. :func:`build_sharded_epoch_host` builds the epoch's subgraph once
with its tile count padded to a multiple of the edge shards (the edge
values are the whole subgraph's normalisation, computed before the
split), slices out the rank's contiguous tile range and gives it its
destination layout and reversed edges; :func:`build_sharded_structured_host`
slices the structured scoring batch over every rank of the mesh (pad
parents repeat row 0 with weight 0) and builds the slice's structured
layouts. Each shard is bit-equal to the JAX builders' stacked output at
that index. The sorts and layouts run in the port's C++ builders
(``prefer_native=False``: numpy, the same output).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from rgcn_tpu_torch.graph.structure import EdgeSet

__all__ = ["build_sharded_epoch_host", "build_sharded_structured_host"]


def build_sharded_epoch_host(
    positives: np.ndarray,
    num_nodes: int,
    num_rels: int,
    tile_size: int,
    n_shards: int,
    shard: int,
    *,
    dropout_rate: float = 0.0,
    dropout_rng=None,
    keep_mask: Optional[np.ndarray] = None,
    row_block: Optional[int] = None,
    layout_chunk: int = 256,
    prefer_native: bool = True,
) -> EdgeSet:
    """Edge shard ``shard`` of ``n_shards`` of the epoch's subgraph, with
    its layout and reversed edges. ``row_block=None`` picks the row block
    :func:`~rgcn_tpu_torch.graph.dynamic.auto_layout_row_block` gives the
    per-shard (padded) edge count, the same on every shard."""
    from rgcn_tpu_torch.dist.mesh import shard_edge_set
    from rgcn_tpu_torch.graph.dynamic import (
        attach_host_layouts,
        auto_layout_row_block,
        build_edge_set_dynamic_host,
    )

    es = build_edge_set_dynamic_host(
        positives, num_nodes, num_rels, tile_size=tile_size,
        dropout_rate=dropout_rate, dropout_rng=dropout_rng, keep_mask=keep_mask,
        tile_multiple=n_shards, prefer_native=prefer_native)
    if row_block is None:
        row_block = auto_layout_row_block(num_nodes, es.src.shape[0] // n_shards,
                                          layout_chunk)
    return attach_host_layouts(shard_edge_set(es, n_shards, shard), row_block=row_block,
                               layout_chunk=layout_chunk, prefer_native=prefer_native)


def build_sharded_structured_host(
    positives: np.ndarray,
    corrupt_head: np.ndarray,
    corrupt_ent: np.ndarray,
    num_nodes: int,
    n_shards: int,
    shard: int,
    *,
    row_block: int = 512,
    chunk: int = 256,
    prefer_native: bool = True,
):
    """Slice ``shard`` of ``n_shards`` of a structured scoring batch:
    ``(positives, corrupt_head, corrupt_ent, labels, weights, layouts)``.
    The positives are padded to a multiple of ``n_shards`` by repeating
    row 0 (their negatives entity 0) and split into contiguous slices,
    the negatives following their parents; ``weights`` marks the slice's
    real rows of its ``[positives ; negatives]`` (1) and pads (0); the
    caller divides by the whole batch's real row count. ``layouts``:
    :func:`~rgcn_tpu_torch.ops.distmult_train.build_structured_layouts`
    of the slice (row block 512 as the single-device trainer's)."""
    from rgcn_tpu_torch.ops.distmult_train import build_structured_layouts

    positives = np.asarray(positives)
    corrupt_head = np.asarray(corrupt_head).reshape(-1)
    corrupt_ent = np.asarray(corrupt_ent).reshape(-1)
    p_real = positives.shape[0]
    ns = corrupt_ent.shape[0] // p_real
    p_pad = -(-p_real // n_shards) * n_shards
    extra = p_pad - p_real
    if extra:
        positives = np.concatenate([positives, np.repeat(positives[:1], extra, axis=0)])
        corrupt_head = np.concatenate([corrupt_head,
                                       np.zeros(extra * ns, corrupt_head.dtype)])
        corrupt_ent = np.concatenate([corrupt_ent, np.zeros(extra * ns, corrupt_ent.dtype)])
    p_k = p_pad // n_shards
    pos_k = positives[shard * p_k:(shard + 1) * p_k]
    ch_k = corrupt_head[shard * p_k * ns:(shard + 1) * p_k * ns]
    ce_k = corrupt_ent[shard * p_k * ns:(shard + 1) * p_k * ns]
    real_p = min(max(p_real - shard * p_k, 0), p_k)  # pads are a suffix
    weights = np.concatenate([(np.arange(p_k) < real_p).astype(np.float32),
                              (np.arange(p_k * ns) < real_p * ns).astype(np.float32)])
    labels = np.concatenate([np.ones(p_k, np.float32), np.zeros(p_k * ns, np.float32)])
    lays = build_structured_layouts(pos_k, ce_k, ch_k, num_nodes, row_block=row_block,
                                    chunk=chunk, prefer_native=prefer_native)
    return (pos_k.astype(np.int32), ch_k.astype(bool), ce_k.astype(np.int32),
            labels, weights, lays)
