"""Experiment tracking: scalar metrics to stdout and JSONL (counterpart of
``rgcn_tpu/utils/logging.py``).

Keeps the JAX package's metric names (``training.loss``,
``training.accuracy``, ``test.accuracy``, ``test.accuracy_ste``) and its
``metrics.jsonl`` records, one JSON object a line with ``metric``,
``value``, ``step`` and ``t`` (seconds since the logger was made), so runs
of the two packages can be diffed record by record.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["ScalarLogger"]


class ScalarLogger:
    def __init__(self, run_dir: Optional[str] = None, name: str = "exp",
                 verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self._fh = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log_scalar(self, metric: str, value, step: Optional[int] = None):
        value = float(value)
        rec = {
            "metric": metric,
            "value": value,
            "step": step,
            "t": round(time.time() - self._t0, 3),
        }
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def info(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
