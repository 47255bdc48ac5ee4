"""Initializers with the reference's distributions (counterpart of
``rgcn_tpu/nn/init.py``), drawn from an explicit ``torch.Generator``.

Torch fan convention for a tensor of shape ``(d0, d1, *rest)``:
``fan_in = d1 * prod(rest)``, ``fan_out = d0 * prod(rest)``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = [
    "torch_fans",
    "relu_gain",
    "schlichtkrull_std",
    "glorot_uniform",
    "glorot_normal",
    "schlichtkrull_normal",
    "schlichtkrull_uniform",
    "standard_normal",
    "standard_uniform",
    "uniform_symmetric",
    "kaiming_normal_fan_in",
    "torch_linear_weight",
    "torch_linear_bias",
    "select_weight_init",
    "select_bias_init",
]

#: ``init(shape, generator) -> f32 tensor``
Initializer = Callable[[Sequence[int], torch.Generator], torch.Tensor]

RELU_GAIN = math.sqrt(2.0)


def relu_gain() -> float:
    return RELU_GAIN


def torch_fans(shape: Sequence[int]) -> Tuple[int, int]:
    """Torch's ``_calculate_fan_in_and_fan_out`` for ``ndim >= 2``."""
    if len(shape) < 2:
        raise ValueError("fan computation needs >= 2 dims")
    receptive = 1
    for d in shape[2:]:
        receptive *= d
    return shape[1] * receptive, shape[0] * receptive


def glorot_uniform(
    shape: Sequence[int], generator: torch.Generator, gain: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """U(-a, a) with ``a = gain * sqrt(6 / (fan_in + fan_out))``."""
    fan_in, fan_out = torch_fans(shape)
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(tuple(shape), dtype=dtype).uniform_(-a, a, generator=generator)


def glorot_normal(
    shape: Sequence[int], generator: torch.Generator, gain: float = 1.0,
) -> torch.Tensor:
    """N(0, std) with ``std = gain * sqrt(2 / (fan_in + fan_out))``."""
    fan_in, fan_out = torch_fans(shape)
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(tuple(shape), generator=generator)


def schlichtkrull_std(shape: Sequence[int], gain: float = 1.0) -> float:
    """``gain * 3 / sqrt(shape[0] + shape[1])`` (only the first two entries
    of ``shape`` count, as in the reference)."""
    return gain * 3.0 / math.sqrt(float(shape[0] + shape[1]))


def schlichtkrull_normal(
    shape: Sequence[int], generator: torch.Generator, gain: float = 1.0,
    fan_shape: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """N(0, std) with the Schlichtkrull std of ``fan_shape`` (default
    ``shape``; the LP block layer passes ``((R'-1)//2, din // num_blocks)``)."""
    std = schlichtkrull_std(shape if fan_shape is None else fan_shape, gain)
    return std * torch.randn(tuple(shape), generator=generator)


def schlichtkrull_uniform(
    shape: Sequence[int], generator: torch.Generator, gain: float = 1.0,
    fan_shape: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """U(-std, std) with the Schlichtkrull std of ``fan_shape`` (default
    ``shape``)."""
    std = schlichtkrull_std(shape if fan_shape is None else fan_shape, gain)
    return torch.empty(tuple(shape)).uniform_(-std, std, generator=generator)


def standard_normal(shape: Sequence[int], generator: torch.Generator,
                    gain: float = 1.0) -> torch.Tensor:
    """N(0, 1) (torch's ``normal_`` defaults). ``gain`` is ignored, as in
    the JAX package: the reference passes none to ``normal_``."""
    del gain
    return torch.randn(tuple(shape), generator=generator)


def standard_uniform(shape: Sequence[int], generator: torch.Generator,
                     gain: float = 1.0) -> torch.Tensor:
    """U(0, 1) (torch's ``uniform_`` defaults). ``gain`` is ignored, as in
    the JAX package."""
    del gain
    return torch.rand(tuple(shape), generator=generator)


def uniform_symmetric(bound: float) -> Initializer:
    """U(-bound, bound) in f32. No config name reaches it: as in the JAX
    package, :func:`select_weight_init` does not dispatch to it."""
    return lambda shape, g: torch.empty(tuple(shape)).uniform_(-bound, bound, generator=g)


def kaiming_normal_fan_in(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Torch ``kaiming_normal_(mode='fan_in')`` with the leaky-relu gain
    ``sqrt(2)``: N(0, sqrt(2 / fan_in)), ``fan_in`` from :func:`torch_fans`
    (``shape[1]``, the embedding width, for an ``(N, d)`` table). The
    e-RGCN node embeddings."""
    fan_in, _ = torch_fans(shape)
    return math.sqrt(2.0 / fan_in) * torch.randn(tuple(shape), generator=generator)


def torch_linear_weight(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Torch ``nn.Linear``'s default weight, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), for a kernel stored ``(in, out)`` as the JAX package
    stores it: ``fan_in = shape[0]``. The c-RGCN bottleneck layers."""
    bound = 1.0 / math.sqrt(shape[0])
    return torch.empty(tuple(shape)).uniform_(-bound, bound, generator=generator)


def torch_linear_bias(fan_in: int) -> Initializer:
    """Torch ``nn.Linear``'s default bias, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) with the layer's input width ``fan_in``."""
    bound = 1.0 / math.sqrt(fan_in)
    return lambda shape, g: torch.empty(tuple(shape)).uniform_(-bound, bound, generator=g)


def select_weight_init(name: str, gain: float = 1.0,
                       fan_shape: Optional[Sequence[int]] = None) -> Initializer:
    """Weight initializer by config name (the JAX package's dispatch);
    ``fan_shape`` reaches the Schlichtkrull initializers' std, as in JAX."""
    name = (name or "").lower()
    if name in ("glorot-uniform", "xavier-uniform"):
        return lambda shape, g: glorot_uniform(shape, g, gain)
    if name in ("glorot-normal", "xavier-normal"):
        return lambda shape, g: glorot_normal(shape, g, gain)
    if name == "schlichtkrull-uniform":
        return lambda shape, g: schlichtkrull_uniform(shape, g, gain, fan_shape)
    if name == "schlichtkrull-normal":
        return lambda shape, g: schlichtkrull_normal(shape, g, gain, fan_shape)
    if name in ("normal", "standard-normal"):
        return standard_normal
    if name == "uniform":
        return standard_uniform
    raise NotImplementedError(f"{name!r} initialisation has not been implemented")


def select_bias_init(name) -> Initializer:
    """Bias initializer by config name (the JAX package's dispatch)."""
    key = str(name).lower() if name is not None else None
    if key in ("zeros", "zero", "0"):
        return lambda shape, g: torch.zeros(tuple(shape))
    if key in ("ones", "one", "1"):
        return lambda shape, g: torch.ones(tuple(shape))
    if key == "uniform":
        return standard_uniform
    if key == "normal":
        return standard_normal
    raise NotImplementedError(f"{name!r} initialisation has not been implemented")
