"""Checkpoint and resume of parameters and optimizer state (counterpart of
``rgcn_tpu/utils/checkpoint.py``).

The same directory layout as the JAX package: one ``step_{:08d}``
directory per saved step under the checkpoint directory. The port's format
is one ``state.pt`` inside it, written by ``torch.save`` of a dict of
tensors and primitives, typically ``{"params": model.state_dict(),
"opt_state": optimizer.state_dict()}``, and read back with
``torch.load(weights_only=True)``. A step directory that holds the JAX
package's ``orbax/`` or ``state.msgpack`` instead raises: the port reads
no flax or orbax state, and parameters from the JAX package reach it
through :func:`rgcn_tpu_torch.weights.from_jax_params`.
"""

from __future__ import annotations

import os
from typing import Any, Iterable, Optional, Tuple

import torch

__all__ = [
    "latest_step",
    "restore_checkpoint",
    "restore_training_state",
    "save_checkpoint",
    "save_training_state",
]

STATE_NAME = "state.pt"
_JAX_NAMES = ("orbax", "state.msgpack")


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, state: Any, step: int) -> str:
    """Write ``state`` (a dict of tensors and primitives) as step ``step``;
    returns the file written. The file is written beside its final name
    and renamed into place, so a reader never sees half of it."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_NAME)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, target)
    return target


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest saved step under ``ckpt_dir``, or None (also for a
    missing directory). Entries not named ``step_<int>`` are ignored."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        head, _, num = d.partition("_")
        if head == "step" and num.isdigit():
            steps.append(int(num))
    return max(steps) if steps else None


def restore_checkpoint(
    ckpt_dir: str,
    step: Optional[int] = None,
    partial_keys: Optional[Iterable[str]] = None,
    map_location=None,
) -> Tuple[Optional[dict], Optional[int]]:
    """Read step ``step`` (default: the latest) of ``ckpt_dir``.

    ``partial_keys``: keep only these top-level entries (a server asks for
    ``("params",)`` from a training checkpoint that also holds
    ``opt_state``); a checkpoint that lacks one raises ``ValueError``
    naming the entries it holds. ``map_location``: passed to
    ``torch.load`` (the device the tensors land on).

    Returns ``(state, step)``, or ``(None, None)`` when no step exists.
    """
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = _step_dir(ckpt_dir, step)
    target = os.path.join(path, STATE_NAME)
    if not os.path.isfile(target):
        found = [n for n in _JAX_NAMES if os.path.exists(os.path.join(path, n))]
        if found:
            raise ValueError(
                f"{path} holds a checkpoint of the JAX package ({found[0]}), not "
                f"the port's {STATE_NAME}; carry JAX parameters across with "
                "rgcn_tpu_torch.weights.from_jax_params")
        raise FileNotFoundError(f"{path} holds no {STATE_NAME}")
    state = torch.load(target, map_location=map_location, weights_only=True)
    if partial_keys is not None:
        keys = list(partial_keys)
        missing = [k for k in keys if k not in state]
        if missing:
            raise ValueError(
                f"checkpoint at {target} lacks top-level entries {missing}; "
                f"it holds {sorted(state)}")
        state = {k: state[k] for k in keys}
    return state, step


def save_training_state(ckpt_dir: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, step: int) -> str:
    """Save a trainer's ``{"params", "opt_state"}`` as step ``step``."""
    return save_checkpoint(ckpt_dir, {"params": model.state_dict(),
                                      "opt_state": optimizer.state_dict()}, step)


def restore_training_state(ckpt_dir: str, model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer,
                           map_location, step: Optional[int] = None) -> Optional[int]:
    """Load training checkpoint ``step`` (default: the latest) of
    ``ckpt_dir``, if any, into ``model`` and ``optimizer`` (its tensors
    read onto ``map_location``, the parameters' device); returns its step
    or None."""
    state, step = restore_checkpoint(ckpt_dir, step=step, map_location=map_location)
    if state is not None:
        model.load_state_dict(state["params"])
        optimizer.load_state_dict(state["opt_state"])
    return step
