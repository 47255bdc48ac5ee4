"""NC training in the port against the JAX package, on the CPU.

The two autograd Functions (K1's, whose backward is the gather ``g[dst]``,
and the dense SpMM's, whose dx runs the forward kernels over
``edges.reverse``) against ``jax.vjp`` of the JAX custom VJPs
(``aggregate_messages_ad``, ``rel_spmm_pallas_ad``; Pallas in interpret
mode), the model's gradient against ``jax.grad`` of the flax model with
``backend="pallas"``, ``make_optimizer`` against the optax chains, and the
trainer's ``metrics.jsonl`` records against the JAX trainer's epoch by
epoch from the same initial parameters. The port runs its kernels' plain
versions on CPU tensors. Tolerance atol 1e-5 unless stated (f32 sums in
another order); optimizer updates atol 1e-6; losses rtol 1e-4, accuracies
equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rgcn_tpu.config import load_experiment as j_load_experiment
from rgcn_tpu.data.synthetic import aifb_like as j_aifb_like
from rgcn_tpu.data.synthetic import synthetic_node_classification as j_synth
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.models.node_classification import NodeClassifier as JNodeClassifier
from rgcn_tpu.ops import pallas_aggregate as jagg
from rgcn_tpu.ops import pallas_spmm as jspmm
from rgcn_tpu.train.node_classification import build_nc_model as j_build_nc_model
from rgcn_tpu.train.node_classification import train_node_classifier as j_train
from rgcn_tpu.train.optim import make_optimizer as j_make_optimizer
from rgcn_tpu.utils.logging import ScalarLogger as JScalarLogger
from rgcn_tpu_torch import kernels
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import aifb_like, synthetic_node_classification
from rgcn_tpu_torch.graph.coalesce import build_merged_layout
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.models.node_classification import NodeClassifier
from rgcn_tpu_torch.ops import aggregate as tagg
from rgcn_tpu_torch.ops import basis as tbasis
from rgcn_tpu_torch.ops import fused as tfused
from rgcn_tpu_torch.ops import rel_spmm as trs
from rgcn_tpu_torch.train.node_classification import train_node_classifier
from rgcn_tpu_torch.train.optim import make_optimizer
from rgcn_tpu_torch.utils.logging import ScalarLogger
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(ROOT, "configs", *name.split("/"))
       for name in ("rgcn/nc-AIFB.yaml",)}
ATOL = 1e-5


def _graph(n, r, e, seed):
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    jes = j_build(t, n, r, tile_size=16, with_dst_layout=True, prefer_native=False)
    tes = build_edge_set(t, n, r, tile_size=16, with_dst_layout=True).to("cpu")
    return jes, tes, rng


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# -- the two Functions against the JAX custom VJPs ---------------------------


@pytest.mark.parametrize("n,r,e,seed", [(60, 4, 250, 1), (300, 3, 1200, 2)])
def test_k1_function_vjp_matches_jax(n, r, e, seed):
    jes, tes, rng = _graph(n, r, e, seed)
    assert int((tes.dst == n).sum()) > 0  # pad edges: dst == num_nodes
    msgs = _f32(rng, tes.src.shape[0], 6) * tes.val.numpy()[:, None]
    g = _f32(rng, n, 6)
    want, vjp = jax.vjp(lambda m: jagg.aggregate_messages_ad(m, jes), jnp.asarray(msgs))
    (want_dm,) = vjp(jnp.asarray(g))

    m = torch.from_numpy(msgs).requires_grad_()
    out = tagg.aggregate_sorted(m, tes.layout, n, dst=tes.dst)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    _close(out.detach(), want)
    real = (tes.dst < n).numpy()
    _close(m.grad[real], np.asarray(want_dm)[real])
    # JAX clamps the pads' dst == num_nodes to the last row, a cotangent
    # that their val 0 drops; the port reads the appended zero row
    assert (m.grad[~real] == 0).all()


def test_k1_function_needs_dst_under_grad():
    _, tes, rng = _graph(60, 4, 250, 3)
    m = torch.from_numpy(_f32(rng, tes.src.shape[0], 4)).requires_grad_()
    with pytest.raises(ValueError, match="needs dst"):
        tagg.aggregate_sorted(m, tes.layout, 60)
    with torch.no_grad():  # no backward asked: the plain forward
        assert tagg.aggregate_sorted(m, tes.layout, 60).grad_fn is None


def _without_fused(es):
    return dataclasses.replace(es, fused=None,
                               reverse=dataclasses.replace(es.reverse, fused=None))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "k3_k1"])
@pytest.mark.parametrize("din,dout", [(16, 4), (5, 7)])
def test_spmm_function_vjp_matches_jax(fused, din, dout):
    n = 90
    jes, tes, rng = _graph(n, 4, 400, 4 + din)
    if not fused:
        jes, tes = _without_fused(jes), _without_fused(tes)
    x = np.maximum(_f32(rng, n, din), 0)
    w = _f32(rng, tes.num_rels, din, dout, scale=din ** -0.5)
    g = _f32(rng, n, dout)
    want, vjp = jax.vjp(lambda a, b: jspmm.rel_spmm_pallas_ad(jes, a, b),
                        jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = trs.rel_spmm_ad(tes, xt, wt)
    out.backward(torch.from_numpy(g))
    _close(out.detach(), want)
    _close(xt.grad, want_dx)
    _close(wt.grad, want_dw)
    # dx is the forward over the reversed edges with Wᵀ, dW the per-tile sum
    _close(xt.grad, trs.fwd_spmm(tes.reverse, torch.from_numpy(g),
                                 torch.from_numpy(w).transpose(1, 2).contiguous()))
    _close(wt.grad, trs.rel_spmm_weight_grad(tes, torch.from_numpy(x),
                                             torch.from_numpy(g), tes.num_rels))


def test_spmm_function_needs_reverse():
    _, tes, rng = _graph(60, 3, 200, 5)
    x = torch.from_numpy(_f32(rng, 60, 4)).requires_grad_()
    w = torch.from_numpy(_f32(rng, tes.num_rels, 4, 3))
    with pytest.raises(ValueError, match="layout \\+ reverse"):
        trs.rel_spmm_ad(dataclasses.replace(tes, reverse=None), x, w)
    # only x needs a gradient: dW is not computed
    out = trs.rel_spmm_ad(tes, x, w)
    out.sum().backward()
    assert x.grad is not None and w.grad is None


@pytest.mark.parametrize("layers", [1, 2])
def test_model_gradient_matches_flax_pallas(layers):
    """The whole NodeClassifier's loss gradient (layer 1: the W[rel, src]
    gather and K1's Function; layer 2: the SpMM Function) against
    ``jax.grad`` of the flax model through the Pallas custom VJPs."""
    rng = np.random.default_rng(40 + layers)
    n, r, c = 70, 3, 4
    t = make_random_triples(rng, n, r, 300)
    jes = j_build(t, n, r, tile_size=16, with_dst_layout=True, prefer_native=False)
    jm = JNodeClassifier(num_nodes=n, num_relations=r, num_classes=c,
                         num_layers=layers, backend="pallas")
    params = jm.init(jax.random.key(layers), jes)
    idx = rng.choice(n, 25, replace=False)
    lbl = rng.integers(0, c, 25)

    def j_loss(p):
        logits = jm.apply(p, jes)[idx]
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, lbl).mean()
        return ce + 0.01 * jm.layer1_l2(p)

    want_loss, want_grads = jax.value_and_grad(j_loss)(params)
    tm = NodeClassifier(n, r, c, num_layers=layers)
    tm.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    tes = build_edge_set(t, n, r, tile_size=16, with_dst_layout=True).to("cpu")
    loss = torch.nn.functional.cross_entropy(
        tm(tes)[torch.from_numpy(idx)], torch.from_numpy(lbl)) + 0.01 * tm.layer1_l2()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in tm.named_parameters():
        _close(p.grad, want[name])


def test_kernels_without_backward_refuse_grad_off_the_cpu():
    """K2, K3, K1 presorted, K4 and K5 have no backward: off the CPU (the
    meta device stands in for the card) grad mode with an input that
    requires grad raises before any launch; under no_grad they go on to
    the launchers, which refuse what is not on the card."""
    _, tes, rng = _graph(60, 4, 250, 6)
    meta = tes.to("meta")
    x = torch.empty((60, 8), device="meta", requires_grad=True)
    w = torch.empty((tes.num_rels, 8, 3), device="meta")
    lay = meta.layout
    slots = torch.empty((lay.num_chunks * lay.chunk, 3), device="meta",
                        requires_grad=True)
    m = build_merged_layout(tes.dst.numpy(), tes.src.numpy(), tes.rel.numpy(),
                            tes.val.numpy(), 60, tes.num_rels, dedup_k=2).to("meta")
    wv = torch.empty((2, m.layout.num_chunks * m.layout.chunk), device="meta",
                     requires_grad=True)
    dd = m.fwd_dedup
    w_k = torch.empty((2, 2, dd.num_chunks * dd.chunk), device="meta",
                      requires_grad=True)
    x_plain = x.detach()
    calls = [
        lambda a: tfused.rel_spmm_fused(meta.fused, 60, a, w),
        lambda a: trs.rel_spmm_messages(meta, a, w),
        lambda a: tagg.aggregate_presorted(slots if a is x else slots.detach(), lay, 60),
        lambda a: tbasis.weighted_aggregate(a, m.src_sorted,
                                            wv if a is x else wv.detach(), m.layout, 60),
        lambda a: tbasis.weighted_aggregate_dedup(
            a, dd.src_sorted, w_k if a is x else w_k.detach(), dd, 60),
    ]
    before = dict(kernels.LAUNCHES)
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward on the card"):
            call(x)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
            call(x)
        with pytest.raises(ValueError, match="CUDA tensor"):
            call(x_plain)
    assert kernels.LAUNCHES == before


# -- the optimizer ------------------------------------------------------------


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("algorithm", ["adam", "adamw", "adagrad", "sgd"])
def test_make_optimizer_matches_optax(algorithm, wd):
    rng = np.random.default_rng(7)
    params = {"a": _f32(rng, 6, 5), "b": _f32(rng, 4)}
    grads = []
    for step in range(5):
        g = {"a": _f32(rng, 6, 5, scale=1e-3), "b": _f32(rng, 4)}
        g["a"][0] = 0.0  # a row whose gradient stays 0: Σg² = 0 under adagrad
        g["a"][1] *= 1e-2  # Σg² near adagrad's eps, which sits inside the root
        if step < 2:
            g["b"][1] = 0.0
        grads.append(g)
    lr = 0.01  # the configs' rate
    tx = j_make_optimizer(algorithm, lr, wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.values(), algorithm, lr, wd)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in params:
            _close(tp[k].detach(), jp[k], atol=1e-6)
    if wd == 0.0:
        _close(tp["a"].detach()[0], params["a"][0], atol=0)  # never moved
    with pytest.raises(NotImplementedError, match="rmsprop"):
        make_optimizer(tp.values(), "rmsprop", 0.1)


# -- the trainer against the JAX trainer -------------------------------------


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _with(cfg, epochs, penalty):
    return dataclasses.replace(
        cfg, training=dataclasses.replace(cfg.training, epochs=epochs),
        rgcn=dataclasses.replace(cfg.rgcn, layer1_l2_penalty=penalty))


@pytest.mark.parametrize("graph,epochs,penalty", [
    ("synthetic", 10, 0.0), ("synthetic", 10, 0.01), ("aifb", 2, 0.0),
])
def test_trainer_matches_jax_trainer(tmp_path, graph, epochs, penalty):
    if graph == "aifb":
        jd, d = j_aifb_like(), aifb_like()
    else:
        jd, d = j_synth(seed=0), synthetic_node_classification(seed=0)
    jcfg = _with(j_load_experiment(CFG["rgcn/nc-AIFB.yaml"]), epochs, penalty)
    cfg = _with(load_experiment(CFG["rgcn/nc-AIFB.yaml"]), epochs, penalty)
    # the JAX trainer's initialisation, carried into the port
    jes = j_build(jd.triples, jd.num_nodes, jd.num_relations, tile_size=16,
                  prefer_native=False)
    params = j_build_nc_model(jcfg, jd).init(jax.random.key(0), jes)
    init = from_jax_params(jax.tree_util.tree_map(np.asarray, params))

    j_acc = j_train(jcfg, jd, seed=0, tile_size=16,
                    logger=JScalarLogger(run_dir=str(tmp_path / "jax"), verbose=False))
    logger = ScalarLogger(run_dir=str(tmp_path / "port"), verbose=False)
    acc = train_node_classifier(cfg, d, seed=0, tile_size=16, logger=logger,
                                init_params=init, device="cpu")
    logger.close()
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert [(r["metric"], r["step"]) for r in got] == \
        [(r["metric"], r["step"]) for r in want]
    assert len(got) == 3 * epochs + 1
    for a, b in zip(got, want):
        if a["metric"] == "training.loss":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4)
        else:
            assert a["value"] == b["value"], a["metric"]
    assert acc == j_acc
    losses = [r["value"] for r in got if r["metric"] == "training.loss"]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("config", ["basis-4", "block"])
def test_trainer_refuses_untrainable_configs(config):
    """Once refused by the trainer: with 4 bases the R-GCN now trains (a
    step lowers the loss); with blocks its featureless layer 1 raises the
    layer's own NotImplementedError, as the JAX package's does."""
    from rgcn_tpu_torch.config import DecompositionConfig
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer

    base = load_experiment(CFG["rgcn/nc-AIFB.yaml"])
    decomp = (DecompositionConfig("basis", num_bases=4) if config == "basis-4"
              else DecompositionConfig("block", num_blocks=2))
    cfg = dataclasses.replace(base, rgcn=dataclasses.replace(
        base.rgcn, decomposition=decomp))
    data = synthetic_node_classification(num_nodes=40, num_rels=3, num_edges=120)
    if config == "block":
        with pytest.raises(NotImplementedError, match="featureless block decomposition"):
            train_node_classifier(cfg, data, device="cpu")
        return
    trainer = NodeClassificationTrainer(cfg, data, device="cpu")
    assert trainer.edges.merged is not None  # layer 2 over the merged frame
    first = trainer.step()
    assert np.isfinite(first) and trainer.loss().item() < first


def test_classify_nodes_cli_cpu(tmp_path, capsys):
    from rgcn_tpu_torch import classify_nodes

    cfg = CFG["rgcn/nc-AIFB.yaml"]
    classify_nodes.main(["--config", cfg, "--synthetic", "--cpu", "--epochs", "2",
                         "--run-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[synthetic] AIFB-like graph: N=8285 R=45")
    assert out[1].startswith("[Epoch 1] Loss: ") and out[2].startswith("[Epoch 2] ")
    assert out[3].startswith("[Evaluation] Test Accuracy: ")
    assert out[4].startswith("[Summary] Test Accuracy: ")
    recs = _records(tmp_path)
    assert [r["metric"] for r in recs[:3]] == \
        ["training.loss_1", "training.accuracy_1", "test.accuracy_1"]
    assert [r["metric"] for r in recs[-2:]] == ["test.accuracy", "test.accuracy_ste"]
    with pytest.raises(SystemExit):
        classify_nodes.main(["--config", cfg, "--cpu"])  # --synthetic required
