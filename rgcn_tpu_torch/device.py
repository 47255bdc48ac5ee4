"""Explicit device resolution: the card unless the caller asks for the CPU."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "arrays_to", "check_plain_path"]


def arrays_to(obj, device: torch.device):
    """Copy of a frozen graph dataclass with every numpy array field as a
    tensor on ``device`` (dtypes kept: int32 indices, f32 values) and every
    nested structure moved likewise. Tensors already there are moved too."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            changes[f.name] = torch.as_tensor(np.ascontiguousarray(v)).to(device)
        elif isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = arrays_to(v, device)
    return dataclasses.replace(obj, **changes)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA. A CUDA device that is not there raises; nothing
    quietly runs on the CPU unless ``device="cpu"`` is passed."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: rgcn_tpu_torch runs on the GPU by "
            "default; pass device='cpu' (or --cpu) to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_plain_path(device: torch.device) -> None:
    """The layout-free plain paths are the CPU oracle; elsewhere, raise."""
    if device.type != "cpu":
        raise ValueError(
            f"EdgeSet on {device} has no destination layout, so the kernels "
            "cannot run: build it with build_edge_set(..., with_dst_layout=True)"
        )
