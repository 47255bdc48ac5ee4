"""Single-pass fused relational SpMM over a relation-quantum layout (K2).

Counterpart of ``rgcn_tpu/ops/pallas_fused.py``. Edges are laid out by
``(destination row block, relation)``: each row block's edges are padded
to a multiple of the chunk size ``CH``, and within a chunk each ``Q``-slot
quantum has one relation (runs padded to quantum multiples). Quanta
outside every run carry relation ``-1``; their slots have ``val == 0`` and
``local_dst == RB``.

On a CUDA tensor :func:`rel_spmm_fused` launches
``kernels/csrc/k2_fused.cu``, or with ``compute_dtype=torch.bfloat16`` (its
default, as the JAX function's) ``kernels/csrc/k2_fused_bf16.cu``, or with
``compute_dtype=None`` over f32 ``x`` and a bf16 ``W`` (the layers'
``param_dtype=bfloat16``) ``kernels/csrc/k2_fused_wbf16.cu``; on a CPU
tensor it takes :func:`rel_spmm_fused_plain`, which rounds at the same
places. The kernel gives each chunk its own CTA, stages each real slot's
message (its ``W[rel]`` read through L1) in shared memory, sums each row's
messages in slot order and finishes a row block's chunks by their last
CTA in chunk order: one launch, no memset, the same bits on every
launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rgcn_tpu_torch import kernels
from rgcn_tpu_torch.device import arrays_to
from rgcn_tpu_torch.ops.aggregate import blocked_sum

__all__ = [
    "FusedLayout",
    "build_fused_layout",
    "build_fused_layout_dynamic",
    "check_operands",
    "rel_spmm_fused",
    "rel_spmm_fused_plain",
]


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """Destination-major, relation-quantum edge layout."""

    src: object  # (L,) int32 — source node per fused slot (pads: 0)
    val: object  # (L,) float32 — normalization (pads: 0)
    local_dst: object  # (n_chunks, CH) int32 in [0, RB]; pads = RB
    quantum_rel: object  # (n_quanta,) int32; -1 = gap quantum
    chunk_block: object  # (n_chunks,) int32
    num_rels: int  # relations quantum_rel indexes (the W rows)
    num_row_blocks: int
    row_block: int
    chunk: int
    quantum: int

    @property
    def num_chunks(self) -> int:
        return self.chunk_block.shape[0]

    def to(self, device) -> "FusedLayout":
        return arrays_to(self, device)


def build_fused_layout(
    edges,
    row_block: int = 512,
    chunk: int = 512,
    quantum: int = 64,
) -> FusedLayout:
    """Host-side fused layout from a numpy :class:`EdgeSet`."""
    src = np.asarray(edges.src)
    dst = np.asarray(edges.dst)
    rel = np.asarray(edges.rel)
    val = np.asarray(edges.val)
    n = edges.num_nodes
    num_row_blocks = -(-n // row_block)
    if chunk % quantum:
        raise ValueError("chunk must be a multiple of quantum")

    real = val > 0
    src, dst, rel, val = src[real], dst[real], rel[real], val[real]
    rb = dst // row_block

    # sort by (row_block, rel): runs = (rb, rel) groups
    order = np.lexsort((rel, rb))
    src, dst, rel, val, rb = (
        src[order], dst[order], rel[order], val[order], rb[order],
    )

    key = rb.astype(np.int64) * (edges.num_rels + 1) + rel
    new_run = np.concatenate([[True], key[1:] != key[:-1]])
    run_id = np.cumsum(new_run) - 1
    n_runs = int(run_id[-1]) + 1 if len(run_id) else 0
    run_len = np.bincount(run_id, minlength=n_runs)
    run_rel = rel[new_run]
    run_rb = rb[new_run]
    run_pad = -(-run_len // quantum) * quantum

    # row-block totals (in padded-run space), then chunk-pad each block
    blk_tot = np.zeros(num_row_blocks, dtype=np.int64)
    np.add.at(blk_tot, run_rb, run_pad)
    blk_pad = np.maximum(-(-blk_tot // chunk), 1) * chunk
    blk_off = np.concatenate([[0], np.cumsum(blk_pad)])[:-1]

    # run offsets within blocks (runs are sorted by block)
    run_off = np.zeros(n_runs, dtype=np.int64)
    cursor = blk_off.copy()
    for i in range(n_runs):
        run_off[i] = cursor[run_rb[i]]
        cursor[run_rb[i]] += run_pad[i]

    total = int(blk_pad.sum())
    total = max(total, chunk)
    pos = run_off[run_id] + (
        np.arange(len(src)) - np.concatenate([[0], np.cumsum(run_len)])[:-1][run_id]
    )

    src_f = np.zeros(total, dtype=np.int32)
    val_f = np.zeros(total, dtype=np.float32)
    local = np.full(total, row_block, dtype=np.int32)
    src_f[pos] = src
    val_f[pos] = val
    local[pos] = (dst - rb * row_block).astype(np.int32)

    n_quanta = total // quantum
    qrel = np.full(n_quanta, -1, dtype=np.int32)
    for i in range(n_runs):
        q0 = run_off[i] // quantum
        qn = run_pad[i] // quantum
        qrel[q0 : q0 + qn] = run_rel[i]

    n_chunks = total // chunk
    chunk_starts = np.arange(n_chunks, dtype=np.int64) * chunk
    cumblk = np.cumsum(blk_pad)
    chunk_block = np.searchsorted(cumblk, chunk_starts, side="right")
    chunk_block = np.minimum(chunk_block, num_row_blocks - 1).astype(np.int32)

    return FusedLayout(
        src=src_f,
        val=val_f,
        local_dst=local.reshape(n_chunks, chunk),
        quantum_rel=qrel,
        chunk_block=chunk_block,
        num_rels=int(edges.num_rels),
        num_row_blocks=int(num_row_blocks),
        row_block=int(row_block),
        chunk=int(chunk),
        quantum=int(quantum),
    )


def check_operands(x, weights, num_nodes: int, num_rels: int) -> None:
    """The kernels index ``x`` by source node and ``W`` by relation without
    bounds checks: hold the operands to the graph's sizes."""
    if x.dim() != 2 or x.shape[0] < num_nodes:
        raise ValueError(f"x {tuple(x.shape)} needs ({num_nodes}, din) rows")
    if weights.dim() != 3 or weights.shape[0] != num_rels:
        raise ValueError(
            f"weights {tuple(weights.shape)} need {num_rels} relations"
        )


# the compute dtypes K2 and K3 have forms for (None: f32 as given)
_COMPUTE_DTYPES = (None, torch.float32, torch.bfloat16)


def _compute_dtype(compute_dtype):
    """``compute_dtype`` checked, f32 as None (nothing to cast)."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype {compute_dtype}: the kernels compute in "
                        "float32 or bfloat16")
    return None if compute_dtype == torch.float32 else compute_dtype


def rel_spmm_fused_plain(
    layout: FusedLayout, num_nodes: int, x: torch.Tensor, weights: torch.Tensor,
    compute_dtype=None,
) -> torch.Tensor:
    """Plain version of K2: per-slot messages ``(x[src] @ W[rel_q]) · val``,
    one product per quantum (gap quanta clamp to relation 0 and carry val
    0), summed per row. With a ``compute_dtype``, ``x`` and ``W`` are
    rounded to it and each message is rounded to it (the JAX kernel's
    ``msgs_ref``); the products of the rounded values and every sum stay
    f32. Without one, a bf16 ``W`` with f32 ``x`` is widened exactly (the
    bf16-weight form's products)."""
    compute_dtype = _compute_dtype(compute_dtype)
    if compute_dtype is not None:
        x, weights = x.to(compute_dtype).float(), weights.to(compute_dtype).float()
    else:
        kernels.pair_form(x, weights)
        weights = weights.to(x.dtype)
    rel = layout.quantum_rel.long().clamp(min=0)
    xg = x[layout.src.long()].reshape(rel.shape[0], layout.quantum, x.shape[-1])
    msgs = torch.bmm(xg, weights[rel]).reshape(xg.shape[0] * layout.quantum, -1)
    msgs = msgs * layout.val[:, None]
    if compute_dtype is not None:
        msgs = msgs.to(compute_dtype)
    return blocked_sum(
        msgs, layout.local_dst, layout.chunk_block, layout.num_row_blocks,
        layout.row_block, num_nodes,
    )


def rel_spmm_fused(
    layout: FusedLayout, num_nodes: int, x: torch.Tensor, weights: torch.Tensor,
    *, compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``out[n] = Σ val·(x[src] @ W[rel_q])`` for ``x (N, din)`` and
    ``weights (R, din, dout)``, an f32 output. ``compute_dtype`` (default
    bf16, as ``pallas_fused.py:361``): ``x`` and ``W`` are cast to it, each
    message ``(x[src] @ W) · val`` is summed in f32 and rounded to it, and
    the destination sums are f32; None (or f32) computes in f32 throughout,
    as the model's forward (``ops/rel_spmm.py::fwd_spmm``) does, and then
    takes f32 ``x`` with a bf16 ``W`` as well (bf16 parameters: the
    bf16-weight form, the weights widened exactly). The kernel
    stages a chunk's messages in shared memory; ``ops/rel_spmm.py``
    decides when to take it. No backward of its own
    (``ops/rel_spmm.py::rel_spmm_ad`` has one, over this function at f32):
    on the card, grad mode with ``x`` or ``weights`` requiring grad
    raises."""
    check_operands(x, weights, num_nodes, layout.num_rels)
    compute_dtype = _compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        return rel_spmm_fused_plain(layout, num_nodes, x, weights, compute_dtype)
    kernels.refuse_grad("rel_spmm_fused (K2)", x, weights)
    if compute_dtype is not None:
        x, weights = x.to(compute_dtype), weights.to(compute_dtype)
    return kernels.launch_k2_fused(
        x, weights, layout.src, layout.val, layout.local_dst,
        layout.quantum_rel, layout.chunk_block, num_nodes,
        layout.row_block, layout.num_row_blocks, layout.quantum,
    )


def build_fused_layout_dynamic(edges, row_block: int = 512, chunk: int = 512,
                               quantum: int = 16) -> FusedLayout:
    """The fused layout of a device EdgeSet, built on its device at static
    sizes (counterpart of ``pallas_fused.py::build_fused_layout_dynamic``,
    bit for bit): one stable sort of the int32 key ``(row block, rel)``
    with the edges of ``val == 0`` last, run-length runs, each run padded
    to whole quanta and each row block's runs to whole chunks (at least
    one), at most ``min(E_pad, nrb·R)`` runs and ``E_pad + runs·(Q - 1) +
    nrb·CH`` slots rounded to chunks. Quanta outside every run carry
    relation -1; the trailing chunks hold pads of the last row block."""
    if chunk % quantum:
        raise ValueError("chunk must be a multiple of quantum")
    src, dst, rel, val = edges.src, edges.dst, edges.rel, edges.val
    dev = src.device
    n, num_general = edges.num_nodes, edges.num_rels
    e_pad = src.shape[0]
    nrb = -(-n // row_block)
    b_runs = min(e_pad, nrb * num_general)
    total = e_pad + b_runs * (quantum - 1) + nrb * chunk
    total = -(-total // chunk) * chunk
    n_chunks, n_quanta = total // chunk, total // quantum
    i64 = torch.int64

    real = val > 0
    rb_of = torch.div(dst.to(i64), row_block, rounding_mode="floor").clamp_max(nrb - 1)
    big = nrb * (num_general + 1) + num_general
    key = torch.where(real, rb_of * (num_general + 1) + rel, big).to(torch.int32)
    key_s, order = torch.sort(key, stable=True)
    src_s, dst_s, val_s = src[order], dst[order].to(i64), val[order]
    real_s, rb_s, rel_s = real[order], rb_of[order], rel[order].to(i64)

    pos_idx = torch.arange(e_pad, device=dev)
    is_new = torch.ones(e_pad, dtype=i64, device=dev)
    is_new[1:] = (key_s[1:] != key_s[:-1]).to(i64)
    run_id = (torch.cumsum(is_new, 0) - 1).clamp_max(b_runs - 1)

    def seg(values, ids, size, reduce, identity):
        out = torch.full((size,), identity, dtype=i64, device=dev)
        return out.scatter_reduce_(0, ids, values, reduce=reduce)

    i32_min, i32_max = -(2**31), 2**31 - 1
    run_len = seg(real_s.to(i64), run_id, b_runs, "sum", 0)
    run_rel = seg(torch.where(real_s, rel_s, -1), run_id, b_runs, "amax",
                  i32_min).clamp(0, num_general - 1)
    run_rb = seg(torch.where(real_s, rb_s, -1), run_id, b_runs, "amax",
                 i32_min).clamp(0, nrb - 1)
    run_pad = (run_len + quantum - 1) // quantum * quantum

    blk_tot = seg(run_pad, run_rb, nrb, "sum", 0)
    blk_pad = ((blk_tot + chunk - 1) // chunk).clamp_min(1) * chunk
    cum_blk = torch.cumsum(blk_pad, 0)
    blk_off = cum_blk - blk_pad
    cum_run = torch.cumsum(run_pad, 0) - run_pad  # exclusive, in run order
    blk_first = seg(torch.where(run_len > 0, cum_run, i32_max), run_rb, nrb, "amin",
                    i32_max)
    blk_first = torch.where(blk_tot > 0, blk_first, 0)
    run_off = blk_off[run_rb] + (cum_run - blk_first[run_rb])
    # runs without edges must not break run_off's order for the searchsorted
    run_off = torch.where(run_len > 0, run_off, total + 1)

    run_start = seg(torch.where(real_s, pos_idx, e_pad), run_id, b_runs, "amin", i32_max)
    pos = torch.where(real_s, run_off[run_id] + (pos_idx - run_start[run_id]), total)

    from rgcn_tpu_torch.graph.dynamic import _scatter_drop

    src_f = _scatter_drop(total, 0, pos, src_s, torch.int32)
    val_f = _scatter_drop(total, 0.0, pos, val_s, torch.float32)
    local = _scatter_drop(total, row_block, pos, dst_s - rb_s * row_block, torch.int32)

    q_starts = torch.arange(n_quanta, device=dev, dtype=i64) * quantum
    q_run = (torch.searchsorted(run_off, q_starts, right=True) - 1).clamp(0, b_runs - 1)
    q_in_run = (run_len[q_run] > 0) & (q_starts < run_off[q_run] + run_pad[q_run])
    qrel = torch.where(q_in_run, run_rel[q_run], -1).to(torch.int32)
    chunk_starts = torch.arange(n_chunks, device=dev, dtype=i64) * chunk
    chunk_block = torch.searchsorted(cum_blk, chunk_starts, right=True).clamp_max(
        nrb - 1).to(torch.int32)
    return FusedLayout(
        src=src_f, val=val_f, local_dst=local.reshape(n_chunks, chunk),
        quantum_rel=qrel, chunk_block=chunk_block, num_rels=int(num_general),
        num_row_blocks=int(nrb), row_block=int(row_block), chunk=int(chunk),
        quantum=int(quantum))
