"""c-RGCN link prediction in the port against the JAX package, on the CPU.

``TorchLinear`` and its initialisers against the flax layer;
``CompressionRelationPredictor``'s encode, scores and penalty against the
JAX model with ``backend="pallas"`` (Pallas in interpret mode), 1 and 2
layers, and its structured-score gradients against ``jax.grad``; the
trainer's records against the JAX trainer's production step
(``pallas_train_step=True, host_graph_build=True``, self-loop dropout 0,
whose masks come from ``jax.random`` there) from the JAX initialisation;
``load_lp_server`` against the JAX server; ``predict_links --cpu`` on
``configs/c-rgcn/lp-FB-toy.yaml``. Parameters are carried with
``from_jax_params``; the port runs its kernels' plain versions on CPU
tensors. Tolerance atol 1e-5·max(1, max|ref|) unless stated (f32 sums in
another order).
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
from rgcn_tpu.data.synthetic import synthetic_link_prediction as j_synth_lp
from rgcn_tpu.graph.dynamic import build_edge_set_dynamic as j_build_dynamic
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.nn.layers import TorchLinear as JTorchLinear
from rgcn_tpu.ops import pallas_distmult as jdm
from rgcn_tpu.serve import LinkPredictionServer as JServer
from rgcn_tpu.train import negative as jneg
from rgcn_tpu.train.link_prediction import build_lp_model as j_build_lp
from rgcn_tpu.train.link_prediction import train_link_predictor as j_train
from rgcn_tpu.utils.logging import ScalarLogger as JScalarLogger
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import synthetic_link_prediction
from rgcn_tpu_torch.graph import dynamic as tdyn
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.models.link_prediction import (
    CompressionRelationPredictor,
    build_lp_model,
)
from rgcn_tpu_torch.nn import init as rinit
from rgcn_tpu_torch.nn.layers import TorchLinear
from rgcn_tpu_torch.ops import distmult_train as tdm
from rgcn_tpu_torch.serve import load_lp_server
from rgcn_tpu_torch.train.link_prediction import train_link_predictor
from rgcn_tpu_torch.utils.logging import ScalarLogger
from rgcn_tpu_torch.weights import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(ROOT, "configs", "c-rgcn", f"{name}.yaml")
       for name in ("lp-WN18", "lp-FB-toy")}


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- TorchLinear and the initialisers ------------------------------------------


@pytest.mark.parametrize("din,dout", [(64, 10), (16, 128)])
def test_torch_linear_matches_flax(din, dout):
    rng = np.random.default_rng(din)
    x, w = _f32(rng, 30, din), _f32(rng, 30, dout)
    jl = JTorchLinear(features=dout)
    params = jl.init(jax.random.key(0), jnp.asarray(x))
    assert params["params"]["kernel"].shape == (din, dout)

    def loss(p, x):
        return jnp.sum(jl.apply(p, x) * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tl = TorchLinear(din, dout)
    state = from_jax_params({"params": {"l": _np_tree(params)["params"]}})
    tl.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    tx = torch.tensor(x, requires_grad=True)
    out = tl(tx)
    _close(out, jl.apply(params, jnp.asarray(x)))
    (out * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, gx)
    _close(tl.kernel.grad, gp["params"]["kernel"])
    _close(tl.bias.grad, gp["params"]["bias"])


def test_initialisers_shapes_and_scales():
    g = torch.Generator().manual_seed(3)
    k = rinit.torch_linear_weight((400, 300), g)
    b = rinit.torch_linear_bias(400)((300,), g)
    bound = 1 / np.sqrt(400)  # fan_in = shape[0] of the (in, out) kernel
    for t in (k, b):
        assert t.abs().max().item() <= bound and t.abs().max().item() > 0.95 * bound
    assert abs(k.std().item() - bound / np.sqrt(3)) < 0.01 * bound
    e = rinit.kaiming_normal_fan_in((5000, 32), g)
    assert e.shape == (5000, 32)
    assert abs(e.std().item() - np.sqrt(2 / 32)) < 0.01  # fan_in = 32, the width
    tl = TorchLinear(64, 10, torch.Generator().manual_seed(1))
    assert tl.kernel.shape == (64, 10) and tl.bias.shape == (10,)
    assert tl.kernel.abs().max().item() <= 1 / 8 and tl.bias.abs().max().item() <= 1 / 8
    same = TorchLinear(64, 10, torch.Generator().manual_seed(1))
    assert torch.equal(tl.kernel, same.kernel) and torch.equal(tl.bias, same.bias)
    # the JAX draws: the same distributions, the same bounds
    from rgcn_tpu.nn import init as jinit

    jw = np.asarray(jinit.torch_linear_weight()(jax.random.key(0), (400, 300)))
    je = np.asarray(jinit.kaiming_normal_fan_in()(jax.random.key(0), (5000, 32)))
    assert abs(np.abs(jw).max() - bound) < 0.05 * bound
    assert abs(je.std() - e.std().item()) < 0.01


# -- the model against the JAX model ----------------------------------------------

SMALL = dict(num_nodes=90, num_relations=3, emb_dim=16, hidden1_size=6,
             weight_init="schlichtkrull-normal", bias_init="zeros",
             decoder_l2_type="schlichtkrull-l2", decoder_l2=0.01)


def _model_pair(layers, seed=0):
    from rgcn_tpu.models.link_prediction import CompressionRelationPredictor as JCRP

    data = synthetic_link_prediction(num_nodes=90, num_rels=3, num_edges=500,
                                      seed=seed, reciprocity=0.8)
    kw = dict(SMALL, num_layers=layers, hidden2_size=5 if layers == 2 else None)
    jm = JCRP(backend="pallas", **kw)
    jes = j_build(data.train, 90, 3, tile_size=16, with_dst_layout=True,
                  prefer_native=False)
    triples = np.asarray(data.test[:16])
    params = jm.init(jax.random.key(seed), jes, jnp.asarray(triples))
    tm = CompressionRelationPredictor(**kw)
    tm.load_state_dict(from_jax_params(_np_tree(params)))
    tes = build_edge_set(data.train, 90, 3, tile_size=16,
                         with_dst_layout=True).to("cpu")
    return data, jm, params, jes, tm.eval(), tes, triples


@pytest.mark.parametrize("layers", [1, 2])
def test_crgcn_matches_flax(layers):
    data, jm, params, jes, tm, tes, triples = _model_pair(layers)
    assert tm.decoding_layer.kernel.shape == ((5 if layers == 2 else 6), 16)
    z_want = np.asarray(jm.apply(params, jes, method=jm.encode))
    s_want, p_want = jm.apply(params, jes, jnp.asarray(triples))
    with torch.inference_mode():
        z = tm.encode(tes)
        s_got, p_got = tm(tes, torch.from_numpy(triples))
        heads = tm.score_heads(torch.from_numpy(triples), z)
        tails = tm.score_tails(torch.from_numpy(triples), z)
    assert z.shape == (90, 16)
    _close(z, z_want)
    _close(s_got, s_want)
    np.testing.assert_allclose(p_got.item(), float(p_want), rtol=1e-5)
    zj = jnp.asarray(z_want)
    _close(heads, jm.apply(params, jnp.asarray(triples), zj, method=jm.score_heads))
    _close(tails, jm.apply(params, jnp.asarray(triples), zj, method=jm.score_tails))


@pytest.mark.parametrize("layers", [1, 2])
def test_crgcn_structured_gradients_match_jax(layers):
    """Every parameter's gradient of the structured training loss over a
    dynamic subgraph (K3 + K1 both ways, K4 + K1 in the decoder), against
    ``jax.grad`` of the JAX model with ``backend="pallas"``. E enters twice
    (through the ReLU and as the residual)."""
    data, jm, params, _, tm, _, _ = _model_pair(layers, seed=1)
    tm.train()
    n, r = 90, 3
    pos = np.asarray(data.train[:60])
    kw = dict(tile_size=8, with_dst_layout=True, row_block=32, layout_chunk=32)
    keep = np.random.default_rng(5).random(len(pos)) >= 0.3
    from rgcn_tpu.graph import dynamic as jdyn

    jes = jdyn.build_edge_set_dynamic_host(pos, n, r, keep_mask=keep, **kw)
    tes = tdyn.build_edge_set_dynamic_host(pos, n, r, keep_mask=keep, **kw).to("cpu")
    ch, ce = jneg.corrupt_batch_host(np.random.default_rng(2), pos, n, 3, 0.5,
                                     structure_only=True)
    jl = jdm.build_structured_layouts(pos, ce, n, row_block=16, chunk=32,
                                      sorted_corrupt=True, corrupt_head=ch)
    tl = tdm.build_structured_layouts(pos, ce, ch, n, row_block=16, chunk=32)
    total = len(pos) * 4
    pw = np.full(total, 1.0 / total, np.float32)
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(ce))]).astype(np.float32)

    def loss(p):
        s, pen = jm.apply(p, jes, pos, ch, ce, pw, jl, method=jm.structured_scores)
        return jnp.mean(jnp.logaddexp(0.0, s) - s * labels) + 0.01 * pen

    want = jax.grad(loss)(params)
    layouts = (tl[0].to("cpu"), tl[1].to("cpu"), tl[2].to("cpu"),
               tuple(torch.from_numpy(a) for a in tl[3]))
    s, pen = tm.structured_scores(tes, torch.from_numpy(pos), torch.from_numpy(ch),
                                  torch.from_numpy(ce), torch.from_numpy(pw), layouts)
    got = torch.nn.functional.binary_cross_entropy_with_logits(
        s, torch.from_numpy(labels)) + 0.01 * pen
    got.backward()
    flat = from_jax_params(_np_tree(want))
    grads = dict(tm.named_parameters())
    assert set(flat) == set(grads)
    for name, g in flat.items():
        # gradients of a mean over 240 scores are far below 1: no floor
        ref = g.numpy()
        np.testing.assert_allclose(grads[name].grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=name)


# -- the trainer against the JAX trainer -------------------------------------------


def _small_cfg(load, name, epochs=4):
    cfg = load(CFG[name])
    enc = dataclasses.replace(
        cfg.encoder, node_embedding=12, hidden1_size=6,
        edge_dropout=dataclasses.replace(cfg.encoder.edge_dropout, general=0.3,
                                         self_loop=0.0))
    tr = cfg.training
    tr = dataclasses.replace(
        tr, epochs=epochs, graph_batch_size=48,
        negative_sampling=dataclasses.replace(tr.negative_sampling, sampling_rate=3))
    ev = dataclasses.replace(cfg.evaluation, check_every=2, batch_size=16, verbose=False)
    return dataclasses.replace(cfg, encoder=enc, training=tr, evaluation=ev)


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", ["lp-WN18", "lp-FB-toy"])
def test_crgcn_trainer_matches_jax_trainer(tmp_path, name):
    jcfg, cfg = _small_cfg(j_load, name), _small_cfg(load_experiment, name)
    jd = j_synth_lp(num_nodes=60, num_rels=3, num_edges=320)
    d = synthetic_link_prediction(num_nodes=60, num_rels=3, num_edges=320)
    tile, seed = 8, 0
    j_mrr, _, j_ranks, _ = j_train(
        jcfg, jd, seed=seed, tile_size=tile, pallas_train_step=True,
        host_graph_build=True,
        logger=JScalarLogger(run_dir=str(tmp_path / "jax"), verbose=False))
    train = np.asarray(jd.train, dtype=np.int64)
    init_pos = jnp.asarray(train[:jcfg.training.graph_batch_size])
    params = j_build_lp(jcfg, jd.num_nodes, jd.num_relations).init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        j_build_dynamic(init_pos, jd.num_nodes, jd.num_relations, tile_size=tile),
        init_pos)
    init = from_jax_params(_np_tree(params))
    assert "encoding_layer.kernel" in init and init["encoding_layer.kernel"].shape == (12, 6)
    logger = ScalarLogger(run_dir=str(tmp_path / "port"), verbose=False)
    mrr, _, ranks, model = train_link_predictor(cfg, d, seed=seed, tile_size=tile,
                                                logger=logger, init_state=init,
                                                device="cpu")
    logger.close()
    assert isinstance(model, CompressionRelationPredictor)
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert [(r["metric"], r["step"]) for r in got] == \
        [(r["metric"], r["step"]) for r in want]
    assert sum(r["metric"] == "training.loss" for r in got) == 4
    for a, b in zip(got, want):
        if a["metric"] == "training.loss":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4)
        else:
            assert abs(a["value"] - b["value"]) <= 1e-3, a["metric"]
    assert abs(mrr - j_mrr) <= 1e-3
    assert np.mean(np.asarray(ranks) == np.asarray(j_ranks)) >= 0.95


# -- serving and the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["lp-WN18", "lp-FB-toy"])
def test_load_lp_server_matches_jax_server(name):
    """The configs' own widths (128 -> 16, 64 -> 10) on a small graph."""
    jcfg, cfg = j_load(CFG[name]), load_experiment(CFG[name])
    data = synthetic_link_prediction(num_nodes=150, num_rels=4, num_edges=900, seed=3)
    n, r = data.num_nodes, data.num_relations
    jm = j_build_lp(jcfg, n, r, backend="pallas")
    jes = j_build(data.train, n, r, tile_size=128, with_dst_layout=True,
                  prefer_native=False)
    test = np.asarray(data.test)
    params = jm.init(jax.random.key(2), jes, jnp.asarray(test[:4]))
    train = np.asarray(data.train)
    jsrv = JServer(jm, params, jes, known_triples=train)
    srv = load_lp_server(cfg, data, from_jax_params(_np_tree(params)), device="cpu")
    assert isinstance(srv.model, CompressionRelationPredictor)
    assert srv.edges.merged is None and srv.edges.fused is not None
    _close(srv.z, jsrv.z)
    _close(srv.score(test), jsrv.score(test))
    for fn, q in (("topk_tails", test[:, :2]), ("topk_heads", test[:, 1:])):
        for filtered in (False, True):
            s_t, e_t = getattr(srv, fn)(q, k=5, filtered=filtered)
            s_j, e_j = getattr(jsrv, fn)(q, k=5, filtered=filtered)
            np.testing.assert_array_equal(e_t, e_j)
            _close(s_t, s_j)


def test_build_lp_model_crgcn_draw_order():
    """The port's own draws: embeddings, (zero bias), encoding layer,
    decoding layer, R-GCN layer, decoder, from one generator."""
    cfg = load_experiment(CFG["lp-FB-toy"])
    m = build_lp_model(cfg, 200, 7, seed=5)
    g = torch.Generator().manual_seed(5)
    emb = rinit.schlichtkrull_normal((200, 64), g)
    enc_k = rinit.torch_linear_weight((64, 10), g)
    rinit.torch_linear_bias(64)((10,), g)
    dec_k = rinit.torch_linear_weight((10, 64), g)
    assert torch.equal(m.node_embeddings, emb)
    assert torch.equal(m.encoding_layer.kernel, enc_k)
    assert torch.equal(m.decoding_layer.kernel, dec_k)
    assert m.rgc1.weights.shape == (15, 10, 10) and m.rgc1.bias.shape == (10,)
    assert m.scoring_function.relations.shape == (7, 64)
    assert torch.count_nonzero(m.node_embeddings_bias) == 0


def test_predict_links_cli_crgcn_cpu(tmp_path, capsys):
    from rgcn_tpu_torch import predict_links

    predict_links.main(["--config", CFG["lp-FB-toy"], "--synthetic", "--cpu",
                        "--epochs", "1", "--run-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[synthetic] FB-toy-like graph: N=280 R=112")
    assert any(line.startswith("[Epoch 1] Loss: ") for line in out)
    assert out[-1].startswith("[Final Scores] Total Epoch 1 MRR(filtered): ")
    recs = _records(tmp_path)
    assert [r["metric"] for r in recs] == ["training.loss", "test.mrr",
                                           "test.hits_at_1", "test.hits_at_3",
                                           "test.hits_at_10"]
    assert all(np.isfinite(r["value"]) for r in recs)
