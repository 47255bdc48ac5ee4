"""Sums by key in an order the code fixes: the gradients' segment sums.

The JAX package sums a gradient's rows by key with XLA's ``segment_sum``
(``dcomps``, ``rgcn_tpu/ops/pallas_basis.py:411``; the diagonal layer's
``d dw``, ``pallas_diag.py:94``) or a one-hot product (the decoders' ``d
relations``), and the backward of its gathers is a scatter-add; on one
device each runs in one order, so the same inputs give the same bits.
PyTorch's ``index_add_`` (and the backward of ``index_select``, which is
one) adds with atomics on the card, in the order the threads arrive. Here
instead, :func:`index_sum`:

1. sorts the keys with a stable sort (skipped where they are sorted
   already), so each key's rows lie together in their original order;
2. cuts the sorted rows into blocks of ``B`` rows (``B`` a power of two
   near ``sqrt(n)``, from the row count alone) and sums each run of one key
   within a block, in row order, into a partial row;
3. sums each key's partial rows, in block order, into its output row.

Both sums are an accumulating ``index_put_`` on the card (which sorts its
indices stably and adds each index's rows one after another in a fixed
order; the blocks bound how many rows one index adds, where a hub key
holding most rows would otherwise be one long serial chain) and
``index_add_`` on the CPU (a serial loop; the CPU's accumulating
``index_put_`` adds floats in parallel). No host sync, no atomics on
floats: the same inputs give the same bits on every call. The sums are f32
whatever the rows' dtype; the caller rounds once to a narrower parameter.

:func:`select_rows` is ``table.index_select(0, index)`` whose backward is
:func:`index_sum` in place of ``index_add_``.
"""

from __future__ import annotations

import torch

__all__ = ["index_sum", "select_rows"]


def _block(n: int) -> int:
    """Rows a block: the power of two at least ``sqrt(n)``, 32 to 4,096."""
    b = 32
    while b * b < n and b < 4096:
        b *= 2
    return b


def _accumulate(out: torch.Tensor, index: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``out[index[i]] += rows[i]`` for each i, each index's rows added in
    the order they come (see the module docstring)."""
    if out.device.type == "cuda":
        return out.index_put_((index,), rows, accumulate=True)
    return out.index_add_(0, index, rows)


def index_sum(values: torch.Tensor, index: torch.Tensor, num_rows: int, *,
              sorted_index: bool = False) -> torch.Tensor:
    """``out[r] = Σ_{i: index[i] == r} values[i]`` as f32 ``(num_rows,
    *values.shape[1:])``, in an order fixed by ``index`` alone (the module
    docstring). ``index`` holds values in ``[0, num_rows)``;
    ``sorted_index`` says it is non-decreasing already (the sort is
    skipped: an EdgeSet's edges are sorted by relation)."""
    values = values.float()
    n = index.shape[0]
    rest = tuple(values.shape[1:])
    out = values.new_zeros((num_rows + 1,) + rest)
    if n == 0:
        return out[:num_rows]
    keys = index.long()
    if not sorted_index:
        keys, order = torch.sort(keys, stable=True)
        values = values.index_select(0, order)
    b = _block(n)
    pos = torch.arange(n, device=keys.device)
    starts = torch.ones(n, dtype=torch.bool, device=keys.device)
    starts[1:] = (keys[1:] != keys[:-1]) | (pos[1:] % b == 0)
    seg = torch.cumsum(starts, 0) - 1  # the (block, key) run of each row
    n_seg = min(n, -(-n // b) + num_rows)  # at most: a run a block and a key
    part = _accumulate(values.new_zeros((n_seg,) + rest), seg, values)
    # each run's key (unused runs: the dropped row num_rows)
    seg_key = torch.full((n_seg,), num_rows, dtype=torch.long, device=keys.device)
    seg_key.scatter_(0, seg, keys)
    return _accumulate(out, seg_key, part)[:num_rows]


class _SelectRows(torch.autograd.Function):
    """``table.index_select(0, index)`` cast to ``dtype``; the gradient by
    :func:`index_sum` (in f32, from the cotangent of the cast rows), rounded
    once to the table's dtype."""

    @staticmethod
    def forward(ctx, table, index, dtype):
        ctx.save_for_backward(index)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table.index_select(0, index).to(dtype)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        return index_sum(g, index, ctx.rows).to(ctx.dtype), None, None


def select_rows(table: torch.Tensor, index: torch.Tensor, dtype=None) -> torch.Tensor:
    """``table.index_select(0, index)``, cast to ``dtype`` (None: the
    table's) after the gather, whose gradient sums in a fixed order
    (:func:`index_sum`) where ``index_select``'s backward adds with
    atomics; without a gradient to keep, the plain gather. Widening a bf16
    table's rows here (``dtype`` f32) sums their f32 cotangents and rounds
    once, where a cast after a plain gather would round each row's
    cotangent to bf16 first."""
    dtype = dtype or table.dtype
    if torch.is_grad_enabled() and table.requires_grad:
        return _SelectRows.apply(table, index, dtype)
    return table.index_select(0, index).to(dtype)
