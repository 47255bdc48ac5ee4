"""Carry parameters from the JAX package's flax tree into the port.

Layouts stay identical: ``(R', din, dout)`` weights with the self-loop
relation last, ``(nb, din, dout)`` bases and ``(R', nb)`` comps, ``(r, B,
din/B, dout/B)`` blocks and the LP block layer's ``(din, dout)``
self_weight, ``(R', din)`` diagonal weights, ``(din, dout)`` kernels of the
c-RGCN bottleneck layers (no transpose: the port's ``TorchLinear`` keeps
the flax layout), ``(dout,)`` biases, ``(N, d)`` node embeddings, ``(R,
d)`` DistMult relations.

A JAX ``LinkPredictor(feature_blocks=True)`` stores its node embeddings as
``node_embeddings_block0..k``, <=128 columns each; they join, in index
order along the columns, into the port's one ``node_embeddings`` table.
The JAX layer that gathers from those blocks
(``pallas_basis.py::rel_spmm_basis_blocks_ad``) is not ported: its own
comment records it as a TPU gather experiment, measured slower than the
gather from the one table and kept as no default, and it computes the
same function as the one-table layer.

A bf16 leaf (a JAX model with ``param_dtype=jnp.bfloat16``, or a tree
cast to it: numpy holds it as ``ml_dtypes.bfloat16``) arrives as a bf16
tensor, bit for bit; every other leaf as f32.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_params"]

# leaves the port's modules hold: top-level arrays, and those of a submodule
_TOP_LEAVES = ("node_embeddings", "node_embeddings_bias")
_BLOCK_PREFIX = "node_embeddings_block"
_MODULE_LEAVES = ("weights", "bias", "bases", "comps", "blocks", "self_weight",
                  "kernel", "relations", "sbias", "obias", "pbias")


def _tensor(value) -> torch.Tensor:
    """A bf16 array's bits as a bf16 tensor (through a ``uint16`` view),
    anything else as f32."""
    array = np.asarray(value)
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(array).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(array, dtype=np.float32))


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": {...}}`` of numpy arrays (or anything ``np.asarray``
    takes) -> the port's ``state_dict`` of CPU tensors, bf16 where the
    leaf is bf16 and f32 otherwise: ``rgc1/bases``
    becomes ``rgc1.bases``, ``scoring_function/relations`` becomes
    ``scoring_function.relations``, ``node_embeddings`` stays, and
    ``node_embeddings_block{i}`` join along the columns in index order
    into ``node_embeddings``. A leaf of a layer kind the port does not
    have raises."""
    state, blocks = {}, {}
    for name, value in tree["params"].items():
        if name.startswith(_BLOCK_PREFIX) and name[len(_BLOCK_PREFIX):].isdigit():
            blocks[int(name[len(_BLOCK_PREFIX):])] = value
            continue
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
    if blocks:
        if sorted(blocks) != list(range(len(blocks))) or "node_embeddings" in state:
            raise ValueError(
                f"node embedding blocks {sorted(blocks)} do not form one table")
        state["node_embeddings"] = _tensor(
            np.concatenate([np.asarray(blocks[i]) for i in range(len(blocks))], axis=1))
    return state
