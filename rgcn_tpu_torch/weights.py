"""Carry parameters from the JAX package's flax tree into the port.

Layouts stay identical: ``(R', din, dout)`` weights with the self-loop
relation last, ``(nb, din, dout)`` bases and ``(R', nb)`` comps, ``(r, B,
din/B, dout/B)`` blocks and the LP block layer's ``(din, dout)``
self_weight, ``(R', din)`` diagonal weights, ``(din, dout)`` kernels of the
c-RGCN bottleneck layers (no transpose: the port's ``TorchLinear`` keeps
the flax layout), ``(dout,)`` biases, ``(N, d)`` node embeddings, ``(R,
d)`` DistMult relations.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_params"]

# leaves the port's modules hold: top-level arrays, and those of a submodule
_TOP_LEAVES = ("node_embeddings", "node_embeddings_bias")
_MODULE_LEAVES = ("weights", "bias", "bases", "comps", "blocks", "self_weight",
                  "kernel", "relations", "sbias", "obias", "pbias")


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": {...}}`` of numpy arrays (or anything ``np.asarray``
    takes) -> the port's ``state_dict`` of f32 CPU tensors: ``rgc1/bases``
    becomes ``rgc1.bases``, ``scoring_function/relations`` becomes
    ``scoring_function.relations``, ``node_embeddings`` stays. A leaf of a
    layer kind the port does not have raises."""
    state = {}
    for name, value in tree["params"].items():
        if not isinstance(value, Mapping):
            if name not in _TOP_LEAVES:
                raise NotImplementedError(
                    f"parameter {name} belongs to a model kind that is not "
                    "ported yet"
                )
            state[name] = _tensor(value)
            continue
        for leaf, array in value.items():
            if leaf not in _MODULE_LEAVES:
                raise NotImplementedError(
                    f"parameter {name}/{leaf} belongs to a layer kind that "
                    "is not ported yet"
                )
            state[f"{name}.{leaf}"] = _tensor(array)
    return state
