"""e-RGCN node classification in the port against the JAX package, on the CPU.

``merge_applicable(diag=)`` against the JAX rule over a grid; the plain
``rel_spmm_diag`` against the JAX one; the diagonal SpMM's autograd
Functions (``rel_spmm_diag_ad``, unmerged and merged frames: forward, dx
and d dw) against ``jax.vjp`` of the JAX ``rel_spmm_diag_ad`` (Pallas in
interpret mode) on a graph with parallel edges and pads; the diagonal
layer's parameters; ``EmbeddingNodeClassifier``'s logits and gradients on
a merged and an unmerged graph against the flax model with
``backend="pallas"``; the trainer's records against the JAX trainer's
(``node_embedding_l2_penalty`` 0 and > 0, merged and unmerged);
``load_nc_server`` against the JAX server; ``classify_nodes --cpu`` on
``configs/e-rgcn/nc-MUTAG.yaml``. Parameters are carried with
``from_jax_params``; the port runs its kernels' plain versions on CPU
tensors. Tolerance atol 1e-5·max(1, max|ref|) (f32 sums in another
order); losses rtol 1e-4, accuracies equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.config import load_experiment as j_load
from rgcn_tpu.data.synthetic import aifb_like as j_aifb_like
from rgcn_tpu.data.synthetic import synthetic_node_classification as j_synth
from rgcn_tpu.graph.coalesce import merge_applicable as j_merge_applicable
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.models.node_classification import EmbeddingNodeClassifier as JENC
from rgcn_tpu.ops import spmm as jspmm
from rgcn_tpu.ops.pallas_diag import rel_spmm_diag_ad as j_diag_ad
from rgcn_tpu.serve import NodeClassificationServer as JServer
from rgcn_tpu.train.node_classification import build_nc_model as j_build_nc_model
from rgcn_tpu.train.node_classification import train_node_classifier as j_train
from rgcn_tpu.utils.logging import ScalarLogger as JScalarLogger
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import aifb_like, synthetic_node_classification
from rgcn_tpu_torch.graph.coalesce import MERGED_MAX_RELS, merge_applicable
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.models.node_classification import (
    EmbeddingNodeClassifier,
    build_nc_model,
)
from rgcn_tpu_torch.nn.layers import RGCNConv
from rgcn_tpu_torch.ops import spmm as tspmm
from rgcn_tpu_torch.ops.diag import rel_spmm_diag_ad
from rgcn_tpu_torch.serve import load_nc_server
from rgcn_tpu_torch.train.node_classification import (
    NodeClassificationTrainer,
    train_node_classifier,
)
from rgcn_tpu_torch.utils.logging import ScalarLogger
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(ROOT, "configs", "e-rgcn", f"{name}.yaml")
       for name in ("nc-AIFB", "nc-MUTAG", "nc-AM")}


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, err_msg
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want), err_msg=err_msg)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_merge_applicable_diag_matches_jax():
    for rels in (2, 16, 90, MERGED_MAX_RELS, MERGED_MAX_RELS + 2, 532):
        for decomp, nb in ((None, 0), ("basis", 2), ("basis", 8), ("basis", 9),
                           ("block", 0)):
            for diag in (False, True):
                kw = dict(decomposition=decomp, num_bases=nb, diag=diag)
                assert merge_applicable(rels, **kw) == j_merge_applicable(rels, **kw), \
                    (rels, kw)
    assert merge_applicable(90, diag=True) and not merge_applicable(532, diag=True)


def _graph(n, r, base, seed, parallel):
    """Random triples and, with ``parallel``, the same (s, o) pairs again
    under other relations (parallel edges that the merged frame coalesces)."""
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, base)
    if parallel:
        extra = t[rng.random(len(t)) < 0.5].copy()
        extra[:, 1] = (extra[:, 1] + 1 + rng.integers(0, r - 1, len(extra))) % r
        t = np.unique(np.concatenate([t, extra]), axis=0)
    return t


def _edge_pair(n, r, base, seed, merged, tile=16):
    t = _graph(n, r, base, seed, parallel=True)
    kw = dict(tile_size=tile, with_dst_layout=True, with_merged_layout=merged)
    jes = j_build(t, n, r, prefer_native=False, **kw)
    tes = build_edge_set(t, n, r, **kw).to("cpu")
    assert (jes.merged is not None) == (tes.merged is not None) == merged
    return jes, tes


def test_rel_spmm_diag_plain_matches_jax():
    n, r, d = 50, 3, 8
    jes, tes = _edge_pair(n, r, 200, seed=1, merged=False)
    assert int(np.sum(np.asarray(jes.val) == 0)) > 0  # tile pads present
    rng = np.random.default_rng(2)
    x, dw = _f32(rng, n, d), _f32(rng, 2 * r, d)
    want = jspmm.rel_spmm_diag(jes, jnp.asarray(x), jnp.asarray(dw))
    _close(tspmm.rel_spmm_diag(tes, torch.from_numpy(x), torch.from_numpy(dw)), want)


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("n,r,base,d", [(40, 3, 160, 8), (130, 5, 500, 12)])
def test_diag_function_matches_jax_vjp(merged, n, r, base, d):
    """Forward, dx and d dw of each frame against ``jax.vjp`` of the JAX
    op, whose aggregation runs the Pallas kernel in interpret mode."""
    jes, tes = _edge_pair(n, r, base, seed=n, merged=merged)
    lay = tes.merged.layout if merged else tes.layout
    assert int((lay.local_dst == lay.row_block).sum()) > 0  # pad slots
    if merged:
        assert tes.merged.num_pairs < tes.merged.num_edges  # parallel edges merged
    rng = np.random.default_rng(3)
    x, dw, g = _f32(rng, n, d), _f32(rng, 2 * r, d), _f32(rng, n, d)

    def f(x, dw):
        return j_diag_ad(jes, x, dw)

    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(dw))
    wdx, wddw = vjp(jnp.asarray(g))
    tx, tdw = (torch.tensor(a, requires_grad=True) for a in (x, dw))
    got = rel_spmm_diag_ad(tes, tx, tdw)
    got.backward(torch.from_numpy(g))
    _close(got, want, "forward")
    _close(tx.grad, wdx, "dx")
    _close(tdw.grad, wddw, "ddw")
    with torch.no_grad():
        _close(rel_spmm_diag_ad(tes, tx, tdw), want, "no-grad forward")


def test_diag_function_needs_a_layout():
    t = _graph(30, 3, 80, seed=0, parallel=False)
    es = build_edge_set(t, 30, 3, tile_size=16).to("cpu")
    with pytest.raises(ValueError, match="with_dst_layout"):
        rel_spmm_diag_ad(es, torch.zeros(30, 4), torch.zeros(6, 4))


def test_diag_conv_parameters():
    conv = RGCNConv(20, 7, 6, in_features=6, diag=True,
                    generator=torch.Generator().manual_seed(0))
    assert set(dict(conv.named_parameters())) == {"weights"}
    assert conv.weights.shape == (7, 6) and conv.bias is None
    bound = np.sqrt(2.0) * np.sqrt(6.0 / (7 + 6))  # glorot-uniform, relu gain
    assert conv.weights.abs().max().item() <= bound
    with pytest.raises(ValueError, match="explicit features"):
        RGCNConv(20, 7, 6, diag=True)


# -- the model -----------------------------------------------------------------------


def _model_pair(merged, seed=0):
    n, r, c = 80, (4 if merged else 70), 3
    t = _graph(n, r, 400, seed=seed + 10, parallel=True)
    jes = j_build(t, n, r, tile_size=16, with_dst_layout=True,
                  with_merged_layout=merged, prefer_native=False)
    tes = build_edge_set(t, n, r, tile_size=16, with_dst_layout=True,
                         with_merged_layout=merged).to("cpu")
    assert (tes.merged is not None) == merged
    jm = JENC(num_nodes=n, num_relations=r, num_classes=c, emb_dim=8, backend="pallas")
    params = jm.init(jax.random.key(seed), jes)
    tm = EmbeddingNodeClassifier(n, r, c, emb_dim=8)
    tm.load_state_dict(from_jax_params(_np_tree(params)))
    return jm, params, jes, tm, tes


@pytest.mark.parametrize("merged", [True, False])
def test_embedding_classifier_matches_flax(merged):
    jm, params, jes, tm, tes = _model_pair(merged)
    w = _f32(np.random.default_rng(1), 80, 3)

    def loss(p):
        return jnp.sum(jm.apply(p, jes) * w) + 0.3 * jm.embedding_l2(p)

    want_logits = jm.apply(params, jes)
    want = from_jax_params(_np_tree(jax.grad(loss)(params)))
    logits = tm(tes)
    _close(logits, want_logits)
    ((logits * torch.from_numpy(w)).sum() + 0.3 * tm.embedding_l2()).backward()
    grads = dict(tm.named_parameters())
    assert set(grads) == set(want) == {
        "node_embeddings", "rgcn_no_hidden.weights", "rgc1.weights", "rgc1.bias"}
    for name, g in want.items():
        _close(grads[name].grad, g, name)


def test_build_nc_model_reads_ergcn_config():
    cfg = load_experiment(CFG["nc-AIFB"])
    data = synthetic_node_classification(num_nodes=60, num_rels=3, num_edges=200)
    m = build_nc_model(cfg, data, seed=4)
    assert isinstance(m, EmbeddingNodeClassifier)
    g = torch.Generator().manual_seed(4)
    from rgcn_tpu_torch.nn import init as rinit

    assert torch.equal(m.node_embeddings, rinit.kaiming_normal_fan_in((60, 32), g))
    assert m.rgcn_no_hidden.weights.shape == (7, 32) and m.rgcn_no_hidden.bias is None
    assert m.rgc1.weights.shape == (7, 32, data.num_classes)
    assert torch.count_nonzero(m.rgc1.bias) == 0


# -- the trainer against the JAX trainer -------------------------------------------


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _with(cfg, epochs, penalty):
    return dataclasses.replace(
        cfg, training=dataclasses.replace(cfg.training, epochs=epochs),
        rgcn=dataclasses.replace(cfg.rgcn, node_embedding_l2_penalty=penalty))


@pytest.mark.parametrize("rels,penalty", [(8, 0.0), (8, 0.005), (70, 0.005)])
def test_trainer_matches_jax_trainer(tmp_path, rels, penalty):
    """8 relations merge (the diagonal layer over the merged frame), 70 do
    not (2·70 > 128 general relations)."""
    kw = dict(num_nodes=300, num_rels=rels, num_edges=2000, seed=0)
    jd, d = j_synth(**kw), synthetic_node_classification(**kw)
    jcfg = _with(j_load(CFG["nc-AIFB"]), 8, penalty)
    cfg = _with(load_experiment(CFG["nc-AIFB"]), 8, penalty)
    jes = j_build(jd.triples, jd.num_nodes, jd.num_relations, tile_size=16,
                  prefer_native=False)
    params = j_build_nc_model(jcfg, jd).init(jax.random.key(0), jes)
    init = from_jax_params(_np_tree(params))
    j_acc = j_train(jcfg, jd, seed=0, tile_size=16,
                    logger=JScalarLogger(run_dir=str(tmp_path / "jax"), verbose=False))
    trainer = NodeClassificationTrainer(cfg, d, tile_size=16, init_params=init,
                                        device="cpu")
    assert (trainer.edges.merged is not None) == (rels == 8)
    logger = ScalarLogger(run_dir=str(tmp_path / "port"), verbose=False)
    acc = trainer.fit(logger)
    logger.close()
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert [(r["metric"], r["step"]) for r in got] == \
        [(r["metric"], r["step"]) for r in want]
    assert len(got) == 3 * 8 + 1
    for a, b in zip(got, want):
        if a["metric"] == "training.loss":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4)
        else:
            assert a["value"] == b["value"], a["metric"]
    assert acc == j_acc
    losses = [r["value"] for r in got if r["metric"] == "training.loss"]
    assert losses[-1] < losses[0]


def test_embedding_penalty_refused_for_rgcn():
    cfg = load_experiment(os.path.join(ROOT, "configs", "rgcn", "nc-AIFB.yaml"))
    cfg = dataclasses.replace(cfg, rgcn=dataclasses.replace(
        cfg.rgcn, node_embedding_l2_penalty=0.1))
    data = synthetic_node_classification(num_nodes=40, num_rels=3, num_edges=120)
    with pytest.raises(ValueError, match="node embeddings"):
        train_node_classifier(cfg, data, device="cpu")


# -- serving and the CLI ----------------------------------------------------------


@pytest.mark.parametrize("graph", ["aifb", "unmerged"])
def test_load_nc_server_matches_jax_server(graph):
    """aifb_like() (90 general relations: merged) at the config's width 32,
    and a 70-relation graph (unmerged)."""
    if graph == "aifb":
        jd, d = j_aifb_like(), aifb_like()
    else:
        kw = dict(num_nodes=300, num_rels=70, num_edges=2000, seed=1)
        jd, d = j_synth(**kw), synthetic_node_classification(**kw)
    jcfg, cfg = j_load(CFG["nc-AIFB"]), load_experiment(CFG["nc-AIFB"])
    jm = j_build_nc_model(jcfg, jd)
    jes = j_build(jd.triples, jd.num_nodes, jd.num_relations, tile_size=128,
                  with_dst_layout=True, prefer_native=False)
    params = jm.init(jax.random.key(3), jes)
    jsrv = JServer(jm, params, jes)
    srv = load_nc_server(cfg, d, from_jax_params(_np_tree(params)), device="cpu")
    assert (srv.edges.merged is not None) == (graph == "aifb")
    _close(srv.logits, jsrv.logits)
    nodes = np.arange(0, d.num_nodes, 7)
    np.testing.assert_array_equal(srv.classify(nodes), jsrv.classify(nodes))


def test_classify_nodes_cli_ergcn_cpu(tmp_path, capsys):
    from rgcn_tpu_torch import classify_nodes

    classify_nodes.main(["--config", CFG["nc-MUTAG"], "--synthetic", "--cpu",
                         "--epochs", "1", "--run-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[synthetic] ")
    assert out[1].startswith("[Epoch 1] Loss: ")
    assert out[2].startswith("[Evaluation] Test Accuracy: ")
    assert out[3].startswith("[Summary] Test Accuracy: ")
    recs = _records(tmp_path)
    assert [r["metric"] for r in recs[:3]] == \
        ["training.loss_1", "training.accuracy_1", "test.accuracy_1"]
    assert all(np.isfinite(r["value"]) for r in recs)
