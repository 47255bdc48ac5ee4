"""Data containers (counterpart of ``NodeClassificationData`` and
``LinkPredictionData`` in ``rgcn_tpu/data/loaders.py``).

The RDF file loaders are not ported yet; the port serves synthetic graphs
(:mod:`rgcn_tpu_torch.data.synthetic`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import numpy as np

__all__ = ["LinkPredictionData", "NodeClassificationData"]


@dataclass
class NodeClassificationData:
    triples: np.ndarray  # (E, 3) int64 [s, p, o]
    n2i: Dict[str, int]
    i2n: List[str]
    r2i: Dict[str, int]
    i2r: List[str]
    train: Dict[str, int]  # node label -> class id
    test: Dict[str, int]
    num_classes: int = field(init=False)

    def __post_init__(self):
        classes = {int(c) for c in self.train.values()} | {
            int(c) for c in self.test.values()
        }
        self.num_classes = len(classes)
        # dense label coding over the shared train ∪ test vocabulary
        self._class_code = {c: i for i, c in enumerate(sorted(classes))}

    @property
    def class_values(self):
        """Original label value per dense class code (code -> value)."""
        return sorted(self._class_code)

    @property
    def num_nodes(self) -> int:
        return len(self.i2n)

    @property
    def num_relations(self) -> int:
        return len(self.i2r)

    def index_labels(self, split: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.array([self.n2i[n] for n in split], dtype=np.int64)
        lbl = np.array(
            [self._class_code[int(split[n])] for n in split], dtype=np.int64
        )
        return idx, lbl


@dataclass
class LinkPredictionData:
    """Link-prediction splits as ``(E, 3)`` int64 ``[s, p, o]`` arrays."""

    train: np.ndarray
    test: np.ndarray
    all_triples: Set[Tuple[int, int, int]]
    n2i: Dict[str, int]
    i2n: List[str]
    r2i: Dict[str, int]
    i2r: List[str]

    @property
    def num_nodes(self) -> int:
        return len(self.i2n)

    @property
    def num_relations(self) -> int:
        return len(self.i2r)

    def pad_nodes(self, block_size: int) -> int:
        """Pad the node vocabulary with null nodes (``null0``, ``null1``,
        ...) until N is divisible by ``block_size``, as block
        decomposition needs. Returns the number of nodes added."""
        added = 0
        while len(self.i2n) % block_size != 0:
            label = f"null{added}"
            self.n2i[label] = len(self.i2n)
            self.i2n.append(label)
            added += 1
        return added
