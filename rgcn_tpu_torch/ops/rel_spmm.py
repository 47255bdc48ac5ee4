"""Relational SpMM message stage (K3) and the forward dispatch.

Counterpart of ``rgcn_tpu/ops/pallas_spmm.py``. :func:`fwd_spmm` computes

    out[d] = Σ_{e: dst_e = d} val_e · (x[src_e] @ W[rel_e])

through the fused kernel (K2) when the EdgeSet carries a fused layout and
``W`` fits the shared-memory budget, else through per-tile messages (K3)
aggregated by K1.
"""

from __future__ import annotations

import torch

from rgcn_tpu_torch import kernels
from rgcn_tpu_torch.ops.aggregate import aggregate_sorted
from rgcn_tpu_torch.ops.fused import check_operands, rel_spmm_fused

__all__ = [
    "FUSED_SMEM_BUDGET",
    "fused_fits",
    "rel_spmm_messages",
    "rel_spmm_messages_plain",
    "rel_spmm_full",
    "fwd_spmm",
]

# The port takes K2 only while the whole W and a (RB, dout) f32 accumulator
# fit the shared memory one H100 thread block may use (227 KB). The JAX
# package's rule is another: W within 8 MiB (pallas_spmm.py:228-244,
# _FUSED_VMEM_BUDGET). Results agree either way; only the route differs,
# for a W between the two budgets (e.g. 8 relations of 72 x 72), which the
# port sends through K3 + K1 and the JAX package through its fused kernel.
# K2 stages one whole W[rel] per CTA, so a W[rel] past 227 KB (lp-FB-toy's
# 1 MB) cannot take it whatever the rule. A rule keyed on one W[rel] would
# send nc-AM's layer 2 (W (532, 10, 11) over an 11.7M-slot fused layout) to
# K2, which measured 2.80 ms there against 0.17 ms for K3 + K1 (chip_smoke.py
# on an H100 80GB HBM3 at 700 W), so the rule keys on the whole W.
FUSED_SMEM_BUDGET = 232_448


def fused_fits(weights: torch.Tensor, row_block: int) -> bool:
    """Do ``W`` and a ``(row_block, dout)`` accumulator fit
    :data:`FUSED_SMEM_BUDGET` in f32?"""
    return (weights.numel() + row_block * weights.shape[-1]) * 4 <= FUSED_SMEM_BUDGET


def rel_spmm_messages_plain(edges, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``(x[src] @ W[tile_rel]) · val`` per tile."""
    tile, n_tiles = edges.tile_size, edges.num_tiles
    xg = x[edges.src.long()].reshape(n_tiles, tile, x.shape[-1])
    msgs = torch.bmm(xg, weights[edges.tile_rel.long()])
    return msgs.reshape(n_tiles * tile, -1) * edges.val[:, None]


def rel_spmm_messages(edges, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-edge messages ``(E_pad, dout)`` f32 in edge order, for
    ``x (N, din)`` and general-relation ``weights (R, din, dout)``."""
    check_operands(x, weights, edges.num_nodes, edges.num_rels)
    if x.device.type == "cpu":
        return rel_spmm_messages_plain(edges, x, weights)
    return kernels.launch_k3_messages(
        x, weights, edges.src, edges.val, edges.tile_rel, edges.tile_size
    )


def rel_spmm_full(edges, layout, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Two-stage SpMM: K3 messages, then K1 over the destination layout."""
    msgs = rel_spmm_messages(edges, x, weights)
    return aggregate_sorted(msgs, layout, edges.num_nodes)


def fwd_spmm(edges, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """K2 when ``edges.fused`` exists and ``W`` fits, else K3 then K1."""
    if edges.fused is not None and fused_fits(weights, edges.fused.row_block):
        return rel_spmm_fused(edges.fused, edges.num_nodes, x, weights)
    return rel_spmm_full(edges, edges.layout, x, weights)
