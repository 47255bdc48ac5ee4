"""Manual-AD collectives for edge-sharded training (counterpart of
``rgcn_tpu/ops/collectives.py``).

One process per rank: each rank holds a slice of the graph's edge tiles
and a full copy of the parameters and node features. A differentiated
step crosses between the two kinds of value at two boundaries, and each
is an autograd Function over ``torch.distributed`` whose backward is
right by construction:

* :func:`all_reduce`: per-shard partial → replicated. Forward: the sum
  over the group; backward: the identity (the replicated cotangent is what
  every shard's local computation needs).
* :func:`fanout`: replicated → per-shard use. Forward: the identity;
  backward: the sum over the group (a replicated value feeding every
  shard's local computation gathers one cotangent contribution a shard).

Rule: every replicated value that enters per-shard computation under
autograd passes through :func:`fanout`, and every cross-shard reduction
is :func:`all_reduce`. Purely replicated math (the dense self-loop
product, the loss on replicated logits, the optimizer) needs neither: every
rank computes it alike on identical inputs. :class:`~rgcn_tpu_torch.nn.layers.RGCNConv`
and :class:`~rgcn_tpu_torch.nn.layers.DistMult` apply the rule internally
when their ``group`` is set; the steps in :mod:`rgcn_tpu_torch.dist.train`
close the loop at the loss.

Both reduce out of place: the input is cloned before ``dist.all_reduce``,
because autograd may hand a backward a gradient that another node still
reads. ``group`` is a ``torch.distributed`` process group (``None`` in
the ``maybe_`` forms means one device: no collective).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "fanout", "maybe_all_reduce", "maybe_fanout", "reduce_sum"]


def reduce_sum(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (``op`` default: SUM); ``x``
    itself is left as it was. No autograd."""
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Fanout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` whose backward is the identity (per-shard →
    replicated)."""
    return _AllReduce.apply(x, group)


def fanout(x: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward sums over ``group`` (a replicated value
    entering per-shard computation)."""
    return _Fanout.apply(x, group)


def maybe_all_reduce(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    return x if group is None else all_reduce(x, group)


def maybe_fanout(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    return x if group is None else fanout(x, group)
