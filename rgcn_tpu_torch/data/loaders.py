"""Dataset loaders and their containers (counterpart of
``rgcn_tpu/data/loaders.py``).

* NC (:func:`load_node_classification`): the aifb / am / bgs / mutag file
  registry (a gzipped N-Triples graph and train/test TSV files with each
  dataset's headers, BGS's ``(lith)`` file names and AM's misspelled
  ``label_cateogory`` header); the validation run splits the first
  ``val_prop`` of the training rows off as its test split; one label
  coding shared by both splits, in sorted order of the label values; an
  optional 2-hop prune around the labelled nodes; an optional relation
  ``limit`` with a ``.rest`` bucket; a pickle cache keyed by split and
  prune.
* LP (:func:`load_link_prediction`): fb15k / fb15k-237 / fb-toy / wn18 /
  wn18rr ``train/valid/test.txt``; the validation run takes valid as its
  test split; the vocabularies span all three files.

Both give the JAX package's results on the same files (vocabularies in
sorted order, the same triples, splits and class coding), with three
differences in how they get there:

* the TSV files are read with :mod:`csv`, not pandas. A column whose
  values are all integers becomes ``int``, as pandas types it, so integer
  labels (AM's, MUTAG's) sort as numbers (``9 < 10``) and code the
  classes as the JAX package does;
* the cache is ``cache_rgcn_tpu_torch_{test,validation}[_prune].pkl``:
  the JAX package's ``cache_rgcn_tpu_…`` pickles unpickle into
  ``rgcn_tpu`` and are never opened here;
* the graph is parsed by the port's C++ parser
  (:mod:`rgcn_tpu_torch.data.native_nt`, built from
  ``rgcn_tpu_torch/native/csrc/nt_parser.cc``), as the JAX package parses
  it with its own copy; its output is the Python scanner's
  (:mod:`rgcn_tpu_torch.data.nt`, ``tests/test_torch_native.py``), which
  :func:`_parse_graph` runs with ``prefer_native=False``. Unlike the JAX
  loader, a parser that does not build raises instead of falling back.
"""

from __future__ import annotations

import csv
import os
import pickle
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from rgcn_tpu_torch.data.nt import iter_nt_file

__all__ = [
    "DATA_ROOT",
    "LinkPredictionData",
    "NodeClassificationData",
    "load_link_prediction",
    "load_node_classification",
]

DATA_ROOT = os.environ.get(
    "RGCN_TPU_DATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data"),
)

_NC_REGISTRY = {
    # dataset -> (graph file, train tsv, test tsv, label header, node header)
    "aifb": ("aifb/aifb_stripped.nt.gz", "aifb/trainingSet.tsv", "aifb/testSet.tsv",
             "label_affiliation", "person"),
    "am": ("am/am_stripped.nt.gz", "am/trainingSet.tsv", "am/testSet.tsv",
           "label_cateogory", "proxy"),
    "bgs": ("bgs/bgs_stripped.nt.gz", "bgs/trainingSet(lith).tsv",
            "bgs/testSet(lith).tsv", "label_lithogenesis", "rock"),
    "mutag": ("mutag/mutag_stripped.nt.gz", "mutag/trainingSet.tsv",
              "mutag/testSet.tsv", "label_mutagenic", "bond"),
}

_LP_REGISTRY = {
    "fb15k": "fb15k",
    "fb15k-237": "fB15k-237",
    "fb-toy": "fb-toy",
    "wn18": "wn18",
    "wn18rr": "wn18rr",
}

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


_INT = re.compile(r"[+-]?\d+")


def _typed_column(values: List[str]) -> list:
    """A TSV column as pandas' ``read_csv`` types an all-integer one: ``int``
    when every value is an integer (so they sort as numbers), else the
    strings."""
    if values and all(_INT.fullmatch(v) for v in values):
        return [int(v) for v in values]
    return values


def _read_tsv(path: str, label_header: str, nodes_header: str):
    """(node column, label column) of a tab-separated file with a header."""
    with open(path, newline="", encoding="utf8") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    header, body = rows[0], rows[1:]
    try:
        n_col, l_col = header.index(nodes_header), header.index(label_header)
    except ValueError:
        raise KeyError(f"{path}: header {header} lacks {nodes_header!r} or "
                       f"{label_header!r}") from None
    return (_typed_column([r[n_col] for r in body]),
            _typed_column([r[l_col] for r in body]))


def _two_hop_prune(spo: np.ndarray, anchor_ids: Set[int], depth: int = 2) -> np.ndarray:
    """Keep the triples within ``depth`` hops of the anchor nodes, following
    outgoing edges from subjects and incoming edges to objects (the
    reference's ``add_neighbors``), on interned id triples."""
    out_adj: Dict[int, List[int]] = {}
    in_adj: Dict[int, List[int]] = {}
    for i, (s, _, o) in enumerate(spo):
        out_adj.setdefault(int(s), []).append(i)
        in_adj.setdefault(int(o), []).append(i)

    kept: Set[int] = set()
    frontier = set(anchor_ids)
    for _ in range(depth):
        next_frontier: Set[int] = set()
        for node in frontier:
            for i in out_adj.get(node, ()):  # (node, p, o): continue from o
                kept.add(i)
                next_frontier.add(int(spo[i][2]))
            for i in in_adj.get(node, ()):  # (s, p, node): continue from s
                kept.add(i)
                next_frontier.add(int(spo[i][0]))
        frontier = next_frontier
    return spo[sorted(kept)]


def _parse_graph(path: str, prefer_native: bool = True
                 ) -> Tuple[np.ndarray, List[str], List[str]]:
    """An ``.nt(.gz)`` graph as interned id triples and sorted vocabularies:
    the C++ parser, or with ``prefer_native=False`` the Python scanner."""
    if prefer_native:
        from rgcn_tpu_torch.data.native_nt import parse_nt_native

        return parse_nt_native(path)
    triples = list(iter_nt_file(path))
    nodes: Set[str] = set()
    rels: Set[str] = set()
    for s, p, o in triples:
        nodes.add(s)
        nodes.add(o)
        rels.add(p)
    i2n = sorted(nodes)
    i2r = sorted(rels)
    n2i = {n: i for i, n in enumerate(i2n)}
    r2i = {r: i for i, r in enumerate(i2r)}
    spo = np.empty((len(triples), 3), dtype=np.int64)
    for i, (s, p, o) in enumerate(triples):
        spo[i] = (n2i[s], r2i[p], n2i[o])
    return spo, i2n, i2r


def load_node_classification(
    name: str,
    final_run: bool = False,
    limit: Optional[int] = None,
    enable_cache: bool = True,
    val_prop: float = 0.4,
    prune: bool = False,
    data_root: Optional[str] = None,
) -> NodeClassificationData:
    """Load an RDF node-classification dataset (aifb / am / bgs / mutag)
    from ``data_root`` (default :data:`DATA_ROOT`: ``$RGCN_TPU_DATA``, else
    the repository's ``data/``)."""
    root = data_root or DATA_ROOT
    key = name.lower()
    if key not in _NC_REGISTRY:
        raise ValueError(f"could not find {name!r} dataset")
    graph_rel, train_rel, test_rel, label_header, nodes_header = _NC_REGISTRY[key]

    cachefile = os.path.join(
        root, key,
        f"cache_rgcn_tpu_torch{'_test' if final_run else '_validation'}"
        f"{'_prune' if prune else ''}.pkl",
    )
    if enable_cache and limit is None and os.path.isfile(cachefile):
        with open(cachefile, "rb") as f:
            return pickle.load(f)

    nodes_train, labels_train = _read_tsv(
        os.path.join(root, train_rel), label_header, nodes_header)
    if final_run:
        nodes_test, labels_test = _read_tsv(
            os.path.join(root, test_rel), label_header, nodes_header)
    else:
        # the first val_prop of the training rows become the test split
        pivot = int(len(nodes_train) * val_prop)
        nodes_test, labels_test = nodes_train[:pivot], labels_train[:pivot]
        nodes_train, labels_train = nodes_train[pivot:], labels_train[pivot:]

    # one label coding over both splits (the JAX package's fix of the
    # reference's per-file coding)
    cats = sorted(set(labels_train) | set(labels_test))
    lookup = {c: i for i, c in enumerate(cats)}
    train = dict(zip(nodes_train, (lookup[v] for v in labels_train)))
    test = dict(zip(nodes_test, (lookup[v] for v in labels_test)))

    spo, i2n_full, i2r_full = _parse_graph(os.path.join(root, graph_rel))

    if prune:
        n2i_full = {n: i for i, n in enumerate(i2n_full)}
        anchors = {n2i_full[n] for n in (set(train) | set(test)) if n in n2i_full}
        spo = _two_hop_prune(spo, anchors, depth=2)

    # the nodes and relations the (pruned) graph holds, in sorted order
    node_present = np.zeros(len(i2n_full), dtype=bool)
    node_present[spo[:, 0]] = True
    node_present[spo[:, 2]] = True
    old_nodes = np.nonzero(node_present)[0]
    i2n = [i2n_full[i] for i in old_nodes]
    n2i = {n: i for i, n in enumerate(i2n)}
    node_remap = np.full(len(i2n_full), -1, dtype=np.int64)
    node_remap[old_nodes] = np.arange(len(old_nodes))

    rel_counts = np.bincount(spo[:, 1], minlength=len(i2r_full))
    rest = ".rest"
    if limit is not None:
        # Counter.most_common order: count descending, ties by first
        # occurrence in triple order
        present_rels, first_idx = np.unique(spo[:, 1], return_index=True)
        first_of = np.full(len(i2r_full), np.iinfo(np.int64).max, np.int64)
        first_of[present_rels] = first_idx
        order = sorted((int(r) for r in present_rels),
                       key=lambda r: (-int(rel_counts[r]), int(first_of[r])))[:limit]
        i2r = [i2r_full[r] for r in order] + [rest, "inv." + rest]
        rel_remap = np.full(len(i2r_full), len(order), dtype=np.int64)  # .rest
        for new, old in enumerate(order):
            rel_remap[old] = new
    else:
        old_rels = np.nonzero(rel_counts > 0)[0]
        i2r = [i2r_full[r] for r in old_rels]
        rel_remap = np.full(len(i2r_full), -1, dtype=np.int64)
        rel_remap[old_rels] = np.arange(len(old_rels))
    r2i = {r: i for i, r in enumerate(i2r)}

    edges = np.stack(
        [node_remap[spo[:, 0]], rel_remap[spo[:, 1]], node_remap[spo[:, 2]]], axis=1)
    data = NodeClassificationData(
        triples=edges, n2i=n2i, i2n=i2n, r2i=r2i, i2r=i2r, train=train, test=test)

    if enable_cache and limit is None:
        os.makedirs(os.path.dirname(cachefile), exist_ok=True)
        with open(cachefile, "wb") as f:
            pickle.dump(data, f)
    return data


def _load_triple_file(path: str) -> List[List[str]]:
    with open(path, "r", encoding="utf-8") as f:
        return [line.split() for line in f if line.strip()]


def load_link_prediction(
    name: str,
    final_run: bool = False,
    limit: Optional[int] = None,
    data_root: Optional[str] = None,
) -> LinkPredictionData:
    """Load a triple-file link-prediction dataset (fb15k, fb15k-237,
    fb-toy, wn18, wn18rr) from ``data_root`` (default :data:`DATA_ROOT`)."""
    root = data_root or DATA_ROOT
    key = name.lower()
    if key not in _LP_REGISTRY:
        raise ValueError(f"could not find {name!r} dataset")
    d = os.path.join(root, _LP_REGISTRY[key])

    train_s = _load_triple_file(os.path.join(d, "train.txt"))
    val_s = _load_triple_file(os.path.join(d, "valid.txt"))
    test_s = _load_triple_file(os.path.join(d, "test.txt"))
    if not final_run:
        test_s = val_s
    if limit:
        train_s, test_s = train_s[:limit], test_s[:limit]

    nodes: Set[str] = set()
    rels: Set[str] = set()
    for s, p, o in train_s + val_s + test_s:
        nodes.add(s)
        rels.add(p)
        nodes.add(o)
    i2n, i2r = sorted(nodes), sorted(rels)
    n2i = {n: i for i, n in enumerate(i2n)}
    r2i = {r: i for i, r in enumerate(i2r)}

    def idx(rows: List[List[str]]) -> np.ndarray:
        out = np.empty((len(rows), 3), dtype=np.int64)
        for i, (s, p, o) in enumerate(rows):
            out[i] = (n2i[s], r2i[p], n2i[o])
        return out

    all_triples = {(n2i[s], r2i[p], n2i[o]) for s, p, o in train_s + val_s + test_s}
    return LinkPredictionData(train=idx(train_s), test=idx(test_s),
                              all_triples=all_triples, n2i=n2i, i2n=i2n,
                              r2i=r2i, i2r=i2r)
