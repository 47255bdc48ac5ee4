"""Deterministic synthetic knowledge graphs (node classification and link
prediction).

Same numpy random stream as ``rgcn_tpu/data/synthetic.py``, so both
packages build identical graphs from one seed (``skew_triples`` is the
port's own).
"""

from __future__ import annotations

from typing import Set, Tuple

import numpy as np

from rgcn_tpu_torch.data.loaders import LinkPredictionData, NodeClassificationData

__all__ = [
    "synthetic_kg",
    "synthetic_node_classification",
    "synthetic_link_prediction",
    "wn18_like",
    "fb_toy_like",
    "aifb_like",
    "am_like",
    "skew_triples",
    "synthetic_nc_data",
    "synthetic_lp_data",
]


def synthetic_kg(
    num_nodes: int,
    num_rels: int,
    num_edges: int,
    seed: int = 0,
    zipf_nodes: float = 1.1,
    zipf_rels: float = 1.2,
    reciprocity: float = 0.0,
) -> np.ndarray:
    """Random KG with Zipf-skewed node degrees and relation frequencies.

    ``reciprocity``: share of triples whose reciprocal ``(o, partner(p),
    s)`` is also present, relations paired as ``(2k, 2k+1)`` (an odd
    trailing relation is its own partner), as WN18 stores both directions
    of its hierarchy relations. The triple count stays ~``num_edges``.
    """
    rng = np.random.default_rng(seed)

    def zipf_choice(n, size, a):
        w = 1.0 / np.arange(1, n + 1) ** a
        w /= w.sum()
        perm = rng.permutation(n)  # decouple id order from popularity
        return perm[rng.choice(n, size=size, p=w)]

    n_base = int(round(num_edges / (1.0 + max(reciprocity, 0.0))))
    s = zipf_choice(num_nodes, n_base, zipf_nodes)
    o = zipf_choice(num_nodes, n_base, zipf_nodes)
    p = zipf_choice(num_rels, n_base, zipf_rels)
    triples = np.stack([s, p, o], axis=1).astype(np.int64)
    if reciprocity > 0.0:
        flip = rng.random(n_base) < reciprocity
        partner = triples[flip][:, [2, 1, 0]].copy()
        pr = partner[:, 1]
        partner[:, 1] = np.where((pr ^ 1) < num_rels, pr ^ 1, pr)
        triples = np.concatenate([triples, partner], axis=0)
    triples = np.unique(triples, axis=0)
    rng.shuffle(triples)
    return triples


def synthetic_node_classification(
    num_nodes: int = 500,
    num_rels: int = 8,
    num_edges: int = 3000,
    num_classes: int = 4,
    labeled_frac: float = 0.3,
    signal: float = 0.85,
    seed: int = 0,
) -> NodeClassificationData:
    """KG with planted relation-typed class structure: per class a few hub
    nodes; entities link to their class's hubs through typed relations
    (with probability ``signal``), plus uniform noise edges."""
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, num_classes, num_nodes)

    hubs_per_class = max(1, min(3, num_rels // 2))
    hub = {}
    for c in range(num_classes):
        for k in range(hubs_per_class):
            hub[(c, k)] = rng.integers(0, num_nodes)

    rows = []
    for v in range(num_nodes):
        for k in range(hubs_per_class):
            if rng.random() < signal:
                target_class = classes[v]
            else:
                target_class = rng.integers(0, num_classes)
            rows.append((v, k % num_rels, hub[(target_class, k)]))

    n_noise = max(0, num_edges - len(rows))
    noise = np.stack(
        [
            rng.integers(0, num_nodes, n_noise),
            rng.integers(0, num_rels, n_noise),
            rng.integers(0, num_nodes, n_noise),
        ],
        axis=1,
    )
    triples = np.concatenate([np.asarray(rows, dtype=np.int64), noise], axis=0)
    triples = np.unique(triples, axis=0)

    i2n = [f"node{i}" for i in range(num_nodes)]
    i2r = [f"rel{i}" for i in range(num_rels)]
    labeled = rng.permutation(num_nodes)[: int(num_nodes * labeled_frac)]
    split = len(labeled) // 2
    train = {i2n[i]: int(classes[i]) for i in labeled[:split]}
    test = {i2n[i]: int(classes[i]) for i in labeled[split:]}

    return NodeClassificationData(
        triples=triples,
        n2i={n: i for i, n in enumerate(i2n)},
        i2n=i2n,
        r2i={r: i for i, r in enumerate(i2r)},
        i2r=i2r,
        train=train,
        test=test,
    )


def synthetic_link_prediction(
    num_nodes: int = 200,
    num_rels: int = 6,
    num_edges: int = 2000,
    test_frac: float = 0.1,
    seed: int = 0,
    reciprocity: float = 0.0,
) -> LinkPredictionData:
    """:func:`synthetic_kg` split into test (first ``test_frac``) and
    train triples."""
    triples = synthetic_kg(
        num_nodes, num_rels, num_edges, seed=seed, reciprocity=reciprocity
    )
    n_test = max(1, int(len(triples) * test_frac))
    test, train = triples[:n_test], triples[n_test:]
    all_triples: Set[Tuple[int, int, int]] = {
        (int(a), int(b), int(c)) for a, b, c in triples
    }
    i2n = [f"node{i}" for i in range(num_nodes)]
    i2r = [f"rel{i}" for i in range(num_rels)]
    return LinkPredictionData(
        train=train,
        test=test,
        all_triples=all_triples,
        n2i={n: i for i, n in enumerate(i2n)},
        i2n=i2n,
        r2i={r: i for i, r in enumerate(i2r)},
        i2r=i2r,
    )


def wn18_like(seed: int = 0, reciprocity: float = 0.9) -> LinkPredictionData:
    """WN18-scale graph: 40,943 entities, 18 relations, WN18's
    inverse-pair structure at ``reciprocity=0.9``."""
    return synthetic_link_prediction(
        num_nodes=40_943, num_rels=18, num_edges=146_500, test_frac=0.034,
        seed=seed, reciprocity=reciprocity,
    )


def fb_toy_like(seed: int = 0) -> LinkPredictionData:
    """FB-toy scale: ~280 entities, 112 relations."""
    return synthetic_link_prediction(
        num_nodes=280, num_rels=112, num_edges=5_000, test_frac=0.1, seed=seed
    )


def aifb_like(seed: int = 0) -> NodeClassificationData:
    """AIFB-scale NC graph: ~8.3k nodes, 45 relations, ~29k triples."""
    return synthetic_node_classification(
        num_nodes=8_285, num_rels=45, num_edges=29_000, num_classes=4,
        labeled_frac=0.05, seed=seed,
    )


def am_like(seed: int = 9) -> NodeClassificationData:
    """AM-scale NC graph, as ``benchmarks/stress_nc.py`` (lines 25-29, 53,
    66-68) builds it: ``synthetic_kg(300_000, 266, 1_000_000, seed=9)``
    (747,518 unique triples) and 1,000 labeled nodes with 11 classes drawn
    from ``default_rng(seed)``; the first half of them train, the rest
    test. Real AM is not in the repository; the widths nc-AM runs at (40
    bases, hidden 10) come from its config."""
    num_nodes, num_rels, num_labeled = 300_000, 266, 1_000
    triples = synthetic_kg(num_nodes, num_rels, 1_000_000, seed=seed)
    rng = np.random.default_rng(seed)
    idx = rng.choice(num_nodes, num_labeled, replace=False)
    lbl = rng.integers(0, 11, num_labeled)
    i2n = [f"node{i}" for i in range(num_nodes)]
    i2r = [f"rel{i}" for i in range(num_rels)]
    labels = {i2n[i]: int(c) for i, c in zip(idx, lbl)}
    names = list(labels)
    split = num_labeled // 2
    return NodeClassificationData(
        triples=triples,
        n2i={n: i for i, n in enumerate(i2n)},
        i2n=i2n,
        r2i={r: i for i, r in enumerate(i2r)},
        i2r=i2r,
        train={n: labels[n] for n in names[:split]},
        test={n: labels[n] for n in names[split:]},
    )


def skew_triples(seed=3, num_nodes=1536, num_rels=4, num_edges=3000, hub=7,
                 hub_edges=3000, isolated=(512, 1024)) -> np.ndarray:
    """A skewed graph for the aggregation kernels' edge cases (no JAX
    counterpart): random triples over the nodes outside ``isolated``
    (nodes with no edge at all, so their row blocks hold only pads and the
    fused layout gives them chunks of gap quanta only), plus ``hub_edges``
    distinct triples whose subject (the receiver) is ``hub``: more than
    four chunks' worth of slots for one destination in both layouts."""
    rng = np.random.default_rng(seed)
    nodes = np.setdiff1d(np.arange(num_nodes), np.arange(*isolated))
    t = np.stack([rng.choice(nodes, num_edges),
                  rng.integers(0, num_rels, num_edges),
                  rng.choice(nodes, num_edges)], axis=1)
    pair = rng.choice(num_rels * len(nodes), hub_edges, replace=False)
    hub_t = np.stack([np.full(hub_edges, hub), pair // len(nodes),
                      nodes[pair % len(nodes)]], axis=1)
    return np.unique(np.concatenate([t, hub_t]), axis=0).astype(np.int64)


def synthetic_nc_data(dataset_name: str) -> NodeClassificationData:
    """Scale-matched synthetic stand-in for a config's dataset, as the JAX
    CLIs' ``--synthetic`` picks it (``aifb_like`` for AIFB)."""
    if dataset_name.lower() == "aifb":
        return aifb_like()
    return synthetic_node_classification(seed=0)


def synthetic_lp_data(dataset_name: str) -> LinkPredictionData:
    """Scale-matched synthetic stand-in for an LP config's dataset, as the
    JAX CLIs' ``--synthetic`` picks it."""
    name = dataset_name.lower()
    if name == "wn18":
        return wn18_like()
    if name == "fb-toy":
        return fb_toy_like()
    return synthetic_link_prediction(seed=0)
