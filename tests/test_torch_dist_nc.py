"""Edge-sharded node classification in the port against the JAX package
and against the port on one device, on the CPU (gloo ranks spawned here).

One SGD step (lr 0.01) from the JAX initialisation, on 2 and on 4 ranks,
for the dense R-GCN (layer 1 K1, layer 2 K3 + K1 on the card), a 3-basis
R-GCN (K4), a 10-basis R-GCN on the pair path (K1), e-RGCN (the diagonal
K1 and the dense layer) and a graph with all-pad (empty) shards on the
pair path and the dense path: the loss within rtol 1e-5 and every
parameter after the step within 1e-5·max(1, max|ref|) of the JAX sharded
step (``rgcn_tpu.dist.train.make_sharded_nc_step`` on a mesh cut from
conftest's 8 virtual devices) and of the port's single-device step, and
the same bits on every rank. Then the sharded driver for 3 epochs
against the JAX sharded driver (per-epoch records), a run broken after
epoch 2 and resumed, bit-equal to the unbroken one, and ``classify_nodes
--cpu --virtual-devices 2``.

The ranks run functions of this module in fresh processes, so JAX is
imported inside the tests only.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rgcn_tpu_torch.dist.multihost import same_on_every_rank, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE, RB = 8, 8


def random_triples(seed, n, r, e):
    rng = np.random.default_rng(seed)
    t = np.stack([rng.integers(0, n, e), rng.integers(0, r, e), rng.integers(0, n, e)],
                 axis=1)
    return np.unique(t, axis=0).astype(np.int64)


def one_relation_triples(seed, n, e):
    """Every edge in relation 0: the trailing shards hold pad tiles only."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), np.zeros(e, np.int64),
                     rng.integers(0, n, e)], axis=1)


def make_case(name):
    """(model kind, kwargs, triples, train idx, labels, layer1 l2, emb l2, pairs)."""
    rng = np.random.default_rng(len(name))
    if name == "dense":
        n, r, c, kw = 40, 5, 3, {}
    elif name == "basis":
        n, r, c, kw = 40, 5, 3, dict(decomposition="basis", num_bases=3)
    elif name in ("pairs", "empty_pairs"):
        n, r, c, kw = 48, 6, 3, dict(decomposition="basis", num_bases=10)
    else:
        n, r, c, kw = 40, 4, 3, {}
    triples = (one_relation_triples(37, n, 130) if name.startswith("empty")
               else random_triples(20 + len(name), n, r, 150))
    idx = rng.choice(n, 12, replace=False)
    lbl = rng.integers(0, c, 12)
    kind = "e-rgcn" if name == "ergcn" else "rgcn"
    kw = dict(num_nodes=n, num_relations=r, num_classes=c, **kw)
    kw["emb_dim" if kind == "e-rgcn" else "hidden_size"] = 8
    return dict(kind=kind, kw=kw, triples=triples, idx=idx, lbl=lbl,
                l1=0.01 if kind == "rgcn" and not name.startswith("empty") else 0.0,
                emb=0.01 if kind == "e-rgcn" else 0.0,
                pairs=kw.get("num_bases", 0) > 8)


CASES = ("dense", "basis", "pairs", "ergcn", "empty_pairs", "empty_dense")


def tensors(state):
    """Numpy state (what crosses to a rank) -> tensors."""
    return {k: torch.as_tensor(v) for k, v in state.items()}


def host_state(state):
    return {k: v.numpy() for k, v in state.items()}


def port_model(case, group=None):
    from rgcn_tpu_torch.models.node_classification import (
        EmbeddingNodeClassifier,
        NodeClassifier,
    )

    cls = EmbeddingNodeClassifier if case["kind"] == "e-rgcn" else NodeClassifier
    model = cls(**case["kw"], group=group)
    model.load_state_dict(tensors(case["init"]))
    return model


def port_step(case, model, edges):
    from rgcn_tpu_torch.dist.train import make_sharded_nc_step
    from rgcn_tpu_torch.train.optim import make_optimizer

    step = make_sharded_nc_step(
        model, make_optimizer(model.parameters(), "sgd", 0.01),
        torch.as_tensor(case["idx"]), torch.as_tensor(case["lbl"]),
        layer1_l2=case["l1"], embedding_l2=case["emb"])
    loss = step(edges)
    return {"loss": loss, **model.state_dict()}


def _nc_steps_rank(dev, cases):
    """One rank: each case's sharded step over this rank's shard."""
    from rgcn_tpu_torch.dist.mesh import (
        make_mesh,
        prepare_sharded_layouts,
        prepare_sharded_pairs_host,
        shard_edge_set,
    )
    from rgcn_tpu_torch.graph.structure import build_edge_set

    mesh = make_mesh(device=dev)
    out = {}
    for name, case in cases.items():
        kw = case["kw"]
        es = build_edge_set(case["triples"], kw["num_nodes"], kw["num_relations"],
                            tile_size=TILE, tile_multiple=mesh.edge_size)
        if case["pairs"]:
            shard = prepare_sharded_pairs_host(es, mesh.edge_size, mesh.edge_rank,
                                               row_block=RB)
        else:
            shard = prepare_sharded_layouts(
                shard_edge_set(es, mesh.edge_size, mesh.edge_rank), row_block=RB)
        out[name] = port_step(case, port_model(case, mesh.group), shard.to(dev))
    return out


def jax_models(case):
    from rgcn_tpu.dist.mesh import EDGE_AXIS
    from rgcn_tpu.models import EmbeddingNodeClassifier, NodeClassifier

    cls = EmbeddingNodeClassifier if case["kind"] == "e-rgcn" else NodeClassifier
    backend = "pallas" if case["pairs"] else "xla"
    return cls(**case["kw"]), cls(axis_name=EDGE_AXIS, backend=backend, **case["kw"])


def jax_sharded_step(case, params, n):
    """The JAX package's sharded step: the XLA path, or the per-shard host
    pair structures with the Pallas kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    from rgcn_tpu.dist.mesh import (
        make_mesh,
        prepare_sharded_pairs_host,
        shard_edge_set,
    )
    from rgcn_tpu.dist.train import make_sharded_nc_step
    from rgcn_tpu.graph.structure import build_edge_set
    from rgcn_tpu.train.optim import make_optimizer

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    mesh = make_mesh(n)
    kw = case["kw"]
    es = build_edge_set(case["triples"], kw["num_nodes"], kw["num_relations"],
                        tile_size=TILE, tile_multiple=n)
    es = (prepare_sharded_pairs_host(es, mesh, row_block=RB) if case["pairs"]
          else shard_edge_set(es, mesh))
    tx = make_optimizer("sgd", 0.01)
    step = make_sharded_nc_step(
        jax_models(case)[1], tx, mesh, jnp.asarray(case["idx"]), jnp.asarray(case["lbl"]),
        layer1_l2=case["l1"], embedding_l2=case["emb"])
    params_s, _, loss = step(params, tx.init(params), es)
    return float(loss), params_s


def one_device_step(case):
    from rgcn_tpu_torch.graph.structure import build_edge_set

    kw = case["kw"]
    es = build_edge_set(case["triples"], kw["num_nodes"], kw["num_relations"],
                        tile_size=TILE, with_dst_layout=True,
                        with_pair_index=case["pairs"], with_pair_agg=case["pairs"])
    return port_step(case, port_model(case), es.to("cpu"))


def assert_params_close(got, want, what):
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[key]), w, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_nc_steps_match_jax_and_one_device(n):
    import jax

    from rgcn_tpu.graph.structure import build_edge_set as j_build
    from rgcn_tpu_torch.weights import from_jax_params

    cases = {}
    for name in CASES:
        case = make_case(name)
        kw = case["kw"]
        jes = j_build(case["triples"], kw["num_nodes"], kw["num_relations"], tile_size=TILE)
        params = jax_models(case)[0].init(jax.random.key(0), jes)
        case["init"] = host_state(from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                         params)))
        case["jax"] = jax_sharded_step(case, params, n)
        cases[name] = case

    ranks = spawn(_nc_steps_rank, n, ({k: {f: v for f, v in c.items() if f != "jax"}
                                       for k, c in cases.items()},),
                  device="cpu", num_threads=1)
    for name, case in cases.items():
        per_rank = [r[name] for r in ranks]
        assert same_on_every_rank(per_rank) == 0.0, name
        got = per_rank[0]
        j_loss, j_params = case["jax"]
        one = one_device_step(case)
        np.testing.assert_allclose(got["loss"], j_loss, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(got["loss"], one["loss"].numpy(), rtol=1e-5, err_msg=name)
        assert_params_close(got, from_jax_params(jax.tree_util.tree_map(np.asarray, j_params)),
                            f"{name} vs JAX")
        assert_params_close(got, {k: v for k, v in one.items() if k != "loss"},
                            f"{name} vs one device")


# -- the driver -------------------------------------------------------------------


def nc_cfg(epochs, model="rgcn"):
    from rgcn_tpu_torch.config import load_experiment

    rg = {"model": model, "num_layers": 2, "hidden_size": 8}
    if model == "e-rgcn":
        rg = {"model": model, "node_embeddings": 8}
    return load_experiment({
        "dataset": {"name": "synthetic"},
        "training": {"epochs": epochs, "optimiser": {"algorithm": "adam",
                                                     "learn_rate": 0.01,
                                                     "weight_decay": 0.0}},
        "rgcn": rg, "evaluation": {"final_run": True}})


def nc_data():
    from rgcn_tpu_torch.data.synthetic import synthetic_node_classification

    return synthetic_node_classification(num_nodes=200, num_rels=6, num_edges=1200,
                                         num_classes=3, labeled_frac=0.6, signal=0.9,
                                         seed=7)


def _nc_driver_rank(dev, init, run_dir, ck_dir):
    """One rank: 3 epochs straight with records; then 2 epochs with
    checkpoints every epoch and a resumed run to 3."""
    from rgcn_tpu_torch.dist.driver import ShardedNodeClassificationTrainer
    from rgcn_tpu_torch.dist.mesh import make_mesh
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    mesh = make_mesh(device=dev)
    data = nc_data()
    logger = ScalarLogger(run_dir=run_dir if mesh.rank == 0 else None, verbose=False)
    init = tensors(init)
    straight = ShardedNodeClassificationTrainer(nc_cfg(3), data, mesh, seed=3,
                                                tile_size=TILE, init_params=init)
    acc = straight.fit(logger)
    logger.close()
    quiet = ScalarLogger(verbose=False)
    ShardedNodeClassificationTrainer(nc_cfg(2), data, mesh, seed=3, tile_size=TILE,
                                     init_params=init, checkpoint_dir=ck_dir,
                                     checkpoint_every=1).fit(quiet)
    resumed = ShardedNodeClassificationTrainer(nc_cfg(3), data, mesh, seed=3,
                                               tile_size=TILE, checkpoint_dir=ck_dir,
                                               checkpoint_every=1)
    acc_resumed = resumed.fit(quiet)
    return {"acc": acc, "acc_resumed": acc_resumed, "logits": straight.logits(),
            "logits_resumed": resumed.logits(),
            "params": straight.model.state_dict(), "resumed": resumed.model.state_dict()}


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_sharded_nc_driver_matches_jax_driver_and_resumes(tmp_path):
    """The port's sharded driver on 2 ranks against the JAX sharded driver
    on 2 devices (XLA path) from the same initialisation: per-epoch losses
    within rtol 1e-4, accuracies equal; the resumed run bit-equal to the
    unbroken one on every rank; the ranks bit-equal to each other."""
    import jax

    from rgcn_tpu.config import load_experiment as j_load
    from rgcn_tpu.data.synthetic import synthetic_node_classification as j_synth
    from rgcn_tpu.dist.driver import train_node_classifier_sharded as j_driver
    from rgcn_tpu.dist.mesh import make_mesh as j_make_mesh
    from rgcn_tpu.graph.structure import build_edge_set as j_build
    from rgcn_tpu.train.node_classification import build_nc_model as j_build_nc
    from rgcn_tpu.utils.logging import ScalarLogger as JLogger
    from rgcn_tpu_torch.weights import from_jax_params

    jd = j_synth(num_nodes=200, num_rels=6, num_edges=1200, num_classes=3,
                 labeled_frac=0.6, signal=0.9, seed=7)
    jcfg = j_load({
        "dataset": {"name": "synthetic"},
        "training": {"epochs": 3, "optimiser": {"algorithm": "adam", "learn_rate": 0.01,
                                                "weight_decay": 0.0}},
        "rgcn": {"model": "rgcn", "num_layers": 2, "hidden_size": 8},
        "evaluation": {"final_run": True}})
    jes = j_build(jd.triples, jd.num_nodes, jd.num_relations, tile_size=TILE)
    params = j_build_nc(jcfg, jd).init(jax.random.key(3), jes)
    init = host_state(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    j_acc = j_driver(jcfg, jd, j_make_mesh(2), seed=3, tile_size=TILE, backend="xla",
                     logger=JLogger(run_dir=str(tmp_path / "jax"), verbose=False))

    ranks = spawn(_nc_driver_rank, 2, (init, str(tmp_path / "port"), str(tmp_path / "ck")),
                  device="cpu", num_threads=1)
    assert same_on_every_rank(ranks) == 0.0
    got = ranks[0]
    want = {(r["metric"], r["step"]): r["value"] for r in _records(tmp_path / "jax")}
    recs = [r for r in _records(tmp_path / "port") if r["step"] is not None]
    assert [(r["metric"], r["step"]) for r in recs] == list(want)
    for r in recs:
        if r["metric"] == "training.loss":
            np.testing.assert_allclose(r["value"], want[(r["metric"], r["step"])], rtol=1e-4)
        else:
            assert r["value"] == want[(r["metric"], r["step"])], r
    assert got["acc"] == j_acc
    assert got["acc_resumed"] == got["acc"]
    np.testing.assert_array_equal(got["logits_resumed"], got["logits"])
    for key, value in got["params"].items():
        np.testing.assert_array_equal(got["resumed"][key], value, err_msg=key)


def test_classify_nodes_cli_virtual_devices(tmp_path):
    """``classify_nodes --cpu --virtual-devices 2``: two gloo ranks train
    the nc-MUTAG stand-in (the pair path) and rank 0 writes the records."""
    run_dir = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "rgcn_tpu_torch.classify_nodes",
         "--config", os.path.join(ROOT, "configs", "rgcn", "nc-MUTAG.yaml"),
         "--synthetic", "--cpu", "--virtual-devices", "2", "--epochs", "2",
         "--run-dir", str(run_dir)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "'edge': 2" in proc.stdout and "[Evaluation] Test Accuracy" in proc.stdout
    assert proc.stdout.count("[Epoch 2]") == 1  # rank 0 alone prints
    losses = [r for r in _records(run_dir) if r["metric"] == "training.loss"]
    assert len(losses) == 2 and all(np.isfinite(r["value"]) for r in losses)
