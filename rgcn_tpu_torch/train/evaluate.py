"""Evaluation metrics (counterpart of ``rgcn_tpu/train/evaluate.py``; the
node-classification accuracy so far, the LP ranking metrics come with LP
training)."""

from __future__ import annotations

import numpy as np

__all__ = ["accuracy"]


def accuracy(pred: np.ndarray, labels: np.ndarray) -> float:
    """Classification accuracy in percent (sklearn ``accuracy_score`` × 100,
    as printed by ``experiments/classify_nodes.py:137-140``)."""
    return float(np.mean(np.asarray(pred) == np.asarray(labels)) * 100.0)
