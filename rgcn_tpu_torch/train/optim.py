"""Optimizer factory (counterpart of ``rgcn_tpu/train/optim.py``).

adam / adamw / adagrad / sgd with a ``weight_decay`` knob. torch's Adam and
SGD add ``weight_decay · p`` to the gradient before the moment update, which
is the JAX package's ``add_decayed_weights`` placed before the scaling
transform; AdamW decays the parameter, as ``optax.adamw`` does. Adagrad is
the JAX package's own: ``scale_by_rss`` with a zero initial accumulator
and eps 1e-10 *inside* the root (``g / sqrt(Σg² + eps)``, and 0 where
``Σg²`` is 0), which ``torch.optim.Adagrad`` (eps outside) is not.

bf16 parameters (the layers' ``param_dtype``): the optimizer state is kept
in each parameter's dtype, as optax keeps it (``scale_by_adam``'s ``mu``
and ``nu`` are ``zeros_like(params)``, and ``scale_by_rss``'s sum of
squares too), and the update is applied to the parameter as it is. There
is no f32 master copy, because the JAX package keeps none. ``torch.optim``'s
Adam, AdamW and SGD and :class:`_RssAdagrad` already make their state with
``zeros_like(p)``; their arithmetic rounds at other places than optax's
bf16 arithmetic, within bf16's own rounding
(``tests/test_torch_param_dtype.py`` holds one Adam step to optax's).
"""

from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["make_optimizer"]


class _RssAdagrad(torch.optim.Optimizer):
    """``p -= lr · g · rsqrt(Σg² + eps)`` where ``Σg² > 0``, else no
    change; ``weight_decay · p`` is added to ``g`` first."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 eps: float = 1e-10):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.zeros_like(p)
                ss = state["sum_of_squares"]
                ss.addcmul_(g, g)
                scale = torch.where(ss > 0, torch.rsqrt(ss + group["eps"]),
                                    torch.zeros_like(ss))
                p.sub_(g * scale, alpha=group["lr"])
        return loss


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    algorithm: str,
    learn_rate: float,
    weight_decay: float = 0.0,
) -> torch.optim.Optimizer:
    """The optimizer a config's ``training.optimiser`` names, over
    ``params``."""
    algorithm = algorithm.lower()
    if algorithm == "adam":
        return torch.optim.Adam(params, lr=learn_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
    if algorithm == "adamw":
        return torch.optim.AdamW(params, lr=learn_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    if algorithm == "adagrad":
        return _RssAdagrad(params, lr=learn_rate, weight_decay=weight_decay)
    if algorithm == "sgd":
        return torch.optim.SGD(params, lr=learn_rate, weight_decay=weight_decay)
    raise NotImplementedError(f"{algorithm!r} optimiser has not been implemented")
