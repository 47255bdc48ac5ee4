"""LP training in the port against the JAX package, on the CPU.

The host builders (the dynamic training subgraph with its layouts and
reversed edges, the samplers, the host negatives, the structured scoring
layouts) bit-equal to the JAX package's on the same inputs and seeds; the
basis SpMM's autograd Function (``rel_spmm_basis`` over the subgraph's
unmerged layout) against ``jax.vjp`` of ``rel_spmm_basis_ad`` and the structured scorer's against ``jax.vjp`` of
``distmult_structured_agg_ad`` (Pallas in interpret mode); self-loop
dropout under a given keep mask against the flax layer with ``self_mask =
mask / keep``; the block layer's gradient through ``expand_blocks`` and
``rel_spmm_ad`` against ``jax.grad`` of the flax layer with
``backend="pallas"``; filters, ranks and metrics; the trainer's records
against the JAX trainer's production step (``pallas_train_step=True,
host_graph_build=True``) from the JAX initialisation, for a basis and a
block config with self-loop dropout at 0 (its masks come from
``jax.random`` in the JAX trainer); and ``predict_links --cpu``. The port
runs its kernels' plain versions on CPU tensors. Tolerance atol 1e-5
(1e-5·max(1, max|ref|) for the basis VJP, whose cotangents sum many
terms of magnitude ~10) unless stated (f32 sums in another order).
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
from rgcn_tpu.graph import dynamic as jdyn
from rgcn_tpu.graph.dynamic import build_edge_set_dynamic as j_build_dynamic
from rgcn_tpu.nn.layers import RGCNConv as JConv
from rgcn_tpu.ops import pallas_distmult as jdm
from rgcn_tpu.ops.pallas_basis import rel_spmm_basis_ad as j_basis_ad
from rgcn_tpu.train import evaluate as jev
from rgcn_tpu.train import negative as jneg
from rgcn_tpu.train import samplers as jsamp
from rgcn_tpu.train.link_prediction import build_lp_model as j_build_lp
from rgcn_tpu.train.link_prediction import train_link_predictor as j_train
from rgcn_tpu.utils.logging import ScalarLogger as JScalarLogger
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import synthetic_link_prediction
from rgcn_tpu_torch.graph import dynamic as tdyn
from rgcn_tpu_torch.nn.layers import RGCNConv
from rgcn_tpu_torch.ops import distmult_train as tdm
from rgcn_tpu_torch.ops.basis import rel_spmm_basis
from rgcn_tpu_torch.train import evaluate as tev
from rgcn_tpu_torch.train import negative as tneg
from rgcn_tpu_torch.train import samplers as tsamp
from rgcn_tpu_torch.train.link_prediction import train_link_predictor
from rgcn_tpu_torch.utils.logging import ScalarLogger
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(ROOT, "configs", "rgcn", f"{name}.yaml")
       for name in ("lp-WN18", "lp-FB-toy")}
ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _close_scaled(got, want):
    """atol 1e-5·max(1, max|ref|): sums over many edges of large terms."""
    want = np.asarray(want)
    _close(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())))


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _positives(n, r, b, seed):
    return make_random_triples(np.random.default_rng(seed), n, r, b)


def _same_layout(got, want):
    for f in ("perm", "local_dst", "chunk_block"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("num_row_blocks", "row_block", "chunk"):
        assert getattr(got, f) == getattr(want, f), f


def _same_edges(got, want):
    for f in ("src", "dst", "rel", "val", "tile_rel"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("num_nodes", "num_rels", "tile_size", "num_edges"):
        assert getattr(got, f) == getattr(want, f), f


# -- the host builders, bit-equal ---------------------------------------------


@pytest.mark.parametrize("edges,rels,tile", [(1000, 36, 128), (30000, 224, 128),
                                             (7, 3, 8), (0, 5, 4)])
def test_padded_size_and_row_block_match_jax(edges, rels, tile):
    assert tdyn.padded_size(edges, rels, tile) == jdyn.padded_size(edges, rels, tile)
    for n in (40, 40_943, 300_000, 1_000_000):
        assert tdyn.auto_layout_row_block(n, 2 * edges) == \
            jdyn.auto_layout_row_block(n, 2 * edges)


@pytest.mark.parametrize("mode", ["keep_mask", "dropout_rng", "none"])
@pytest.mark.parametrize("n,r,b,tile,rb", [(60, 3, 90, 8, 16), (200, 4, 500, 16, 64)])
def test_dynamic_host_builder_bit_equal(mode, n, r, b, tile, rb):
    pos = _positives(n, r, b, seed=n + b)
    kw = dict(tile_size=tile, with_dst_layout=True, row_block=rb, layout_chunk=32)
    if mode == "keep_mask":
        keep = np.random.default_rng(5).random(b) < 0.6
        kw_j = kw_t = dict(kw, keep_mask=keep)
    elif mode == "dropout_rng":
        kw_j = dict(kw, dropout_rate=0.4, dropout_rng=np.random.default_rng((3, 1, 7)))
        kw_t = dict(kw, dropout_rate=0.4, dropout_rng=np.random.default_rng((3, 1, 7)))
    else:
        kw_j = kw_t = kw
    want = jdyn.build_edge_set_dynamic_host(pos, n, r, **kw_j)
    got = tdyn.build_edge_set_dynamic_host(pos, n, r, **kw_t)
    _same_edges(got, want)
    _same_layout(got.layout, want.layout)
    _same_edges(got.reverse, want.reverse)
    _same_layout(got.reverse.layout, want.reverse.layout)
    if mode != "none":
        assert (np.asarray(got.val) == 0).sum() > (np.asarray(got.dst) == n).sum()
    bare = tdyn.build_edge_set_dynamic_host(pos, n, r, tile_size=tile)
    assert bare.layout is None and bare.reverse is None
    _same_edges(bare, jdyn.build_edge_set_dynamic_host(pos, n, r, tile_size=tile))


@pytest.mark.parametrize("sample,chunk", [(40, 2048), (150, 7), (400, 2048)])
def test_samplers_match_jax(sample, chunk):
    t = _positives(80, 4, 300, seed=11)
    for seed in (0, 1):
        got = tsamp.edge_neighborhood(t, sample, np.random.default_rng((seed, 3)),
                                      chunk=chunk)
        want = jsamp.edge_neighborhood(t, sample, np.random.default_rng((seed, 3)),
                                       chunk=chunk)
        np.testing.assert_array_equal(got, want)
        got = tsamp.uniform_sampling(t, min(sample, len(t)), np.random.default_rng(seed))
        want = jsamp.uniform_sampling(t, min(sample, len(t)), np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
    assert tsamp.select_sampler("Edge-Neighborhood") is tsamp.edge_neighborhood
    assert tsamp.select_sampler("uniform") is tsamp.uniform_sampling
    with pytest.raises(NotImplementedError):
        tsamp.select_sampler("random-walk")


@pytest.mark.parametrize("ns,head_prob", [(3, 0.5), (10, 0.2)])
def test_corrupt_batch_host_matches_jax(ns, head_prob):
    pos = _positives(70, 3, 50, seed=4)
    for kw in ({}, {"return_structure": True}, {"structure_only": True}):
        got = tneg.corrupt_batch_host(np.random.default_rng((2, 5, 11)), pos, 70, ns,
                                      head_prob, **kw)
        want = jneg.corrupt_batch_host(np.random.default_rng((2, 5, 11)), pos, 70, ns,
                                       head_prob, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,p,ns,rb,ch", [(60, 20, 3, 16, 32), (300, 64, 10, 512, 256)])
def test_structured_layouts_bit_equal(n, p, ns, rb, ch):
    pos = _positives(n, 3, p, seed=p)
    c_head, c_ent = jneg.corrupt_batch_host(np.random.default_rng(9), pos, n, ns, 0.5,
                                            structure_only=True)
    got = tdm.build_structured_layouts(pos, c_ent, c_head, n, row_block=rb, chunk=ch)
    want = jdm.build_structured_layouts(pos, c_ent, n, row_block=rb, chunk=ch,
                                        sorted_corrupt=True, corrupt_head=c_head)
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        _same_layout(g, w)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)


# -- the autograd Functions against jax.vjp -----------------------------------


def _dynamic_pair(n, r, b, tile, seed, rate=0.3):
    pos = _positives(n, r, b, seed=seed)
    keep = np.random.default_rng(seed + 1).random(b) >= rate
    kw = dict(tile_size=tile, keep_mask=keep, with_dst_layout=True, row_block=32,
              layout_chunk=32)
    return (jdyn.build_edge_set_dynamic_host(pos, n, r, **kw),
            tdyn.build_edge_set_dynamic_host(pos, n, r, **kw).to("cpu"))


@pytest.mark.parametrize("n,r,b,din,dout,nb", [(50, 3, 80, 8, 12, 2), (120, 4, 300, 16, 8, 3)])
def test_basis_function_vjp_matches_jax(n, r, b, din, dout, nb):
    jes, tes = _dynamic_pair(n, r, b, tile=8, seed=n)
    rng = np.random.default_rng(3)
    x, bases = _f32(rng, n, din), _f32(rng, nb, din, dout)
    comps, g = _f32(rng, 2 * r, nb), _f32(rng, n, dout)

    def f(x, bases, comps):
        return j_basis_ad(jes, x, bases, comps, compute_dtype=None)

    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(bases), jnp.asarray(comps))
    wdx, wdb, wdc = vjp(jnp.asarray(g))
    tx, tb, tc = (torch.tensor(a, requires_grad=True) for a in (x, bases, comps))
    got = rel_spmm_basis(tes, tx, tb, tc)
    got.backward(torch.from_numpy(g))
    _close_scaled(got.detach(), want)
    _close_scaled(tx.grad, wdx)
    _close_scaled(tb.grad, wdb)
    _close_scaled(tc.grad, wdc)
    with torch.no_grad():
        _close_scaled(rel_spmm_basis(tes, tx, tb, tc), want)


@pytest.mark.parametrize("n,r,p,ns,d,pen", [(40, 3, 24, 3, 8, True), (90, 5, 50, 10, 16, False)])
def test_structured_scorer_vjp_matches_jax(n, r, p, ns, d, pen):
    pos = _positives(n, r, p, seed=p)
    c_head, c_ent = jneg.corrupt_batch_host(np.random.default_rng(1), pos, n, ns, 0.5,
                                            structure_only=True)
    jl = jdm.build_structured_layouts(pos, c_ent, n, row_block=16, chunk=32,
                                      sorted_corrupt=True, corrupt_head=c_head)
    tl = tdm.build_structured_layouts(pos, c_ent, c_head, n, row_block=16, chunk=32)
    rng = np.random.default_rng(2)
    nodes, rels = _f32(rng, n, d), _f32(rng, r, d)
    total = len(pos) * (1 + ns)
    pw = np.full(total, 1.0 / total if pen else 0.0, np.float32)
    gs, gp = _f32(rng, total), np.float32(0.7)

    def f(nodes, rels):
        return jdm.distmult_structured_agg_ad(pos, c_head, c_ent, nodes, rels, pw, jl)

    (ws, wp), vjp = jax.vjp(f, jnp.asarray(nodes), jnp.asarray(rels))
    wdn, wdr = vjp((jnp.asarray(gs), jnp.asarray(gp)))
    tn, tr = (torch.tensor(a, requires_grad=True) for a in (nodes, rels))
    layouts = (tl[0].to("cpu"), tl[1].to("cpu"), tl[2].to("cpu"),
               tuple(torch.from_numpy(a) for a in tl[3]))
    s, pen_v = tdm.structured_scores(torch.from_numpy(pos), torch.from_numpy(c_head),
                                     torch.from_numpy(c_ent), tn, tr,
                                     torch.from_numpy(pw), layouts)
    torch.autograd.backward([s, pen_v], [torch.from_numpy(gs), torch.tensor(gp)])
    _close(s.detach(), ws)
    _close(pen_v.detach(), wp)
    _close(tn.grad, wdn)
    _close(tr.grad, wdr)


def _conv_pair(kind, n, din, dout, rate):
    kw = dict(num_nodes=n, num_relations=2 * 3 + 1, out_features=dout, in_features=din,
              weight_init="schlichtkrull-normal", weight_gain=False)
    if kind == "basis":
        kw.update(decomposition="basis", num_bases=2)
    else:
        kw.update(decomposition="block", num_blocks=2, separate_self_weight=True)
    jconv = JConv(**kw, backend="pallas", self_loop_dropout=rate)
    tconv = RGCNConv(**{k: v for k, v in kw.items() if k != "weight_gain"},
                     weight_gain=False, self_loop_dropout=rate)
    return jconv, tconv


def _load_conv(tconv, params):
    state = {k.split(".", 1)[1]: v for k, v in
             from_jax_params({"params": {"c": params["params"]}}).items()}
    tconv.load_state_dict(state)


@pytest.mark.parametrize("kind", ["basis", "block"])
@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_self_loop_dropout_matches_flax_mask(kind, rate):
    n, din, dout = 40, 8, 12
    jes, tes = _dynamic_pair(n, 3, 70, tile=8, seed=7)
    jconv, tconv = _conv_pair(kind, n, din, dout, rate)
    rng = np.random.default_rng(4)
    x = _f32(rng, n, din)
    params = jconv.init(jax.random.key(0), jes, jnp.asarray(x))
    _load_conv(tconv, params)
    keep = rng.random((n, dout)) < 1.0 - rate
    want = jconv.apply(params, jes, jnp.asarray(x), deterministic=True,
                       self_mask=jnp.asarray(keep / (1.0 - rate), jnp.float32))
    with torch.no_grad():
        got = tconv(tes, torch.from_numpy(x), torch.from_numpy(keep))
        whole = tconv(tes, torch.from_numpy(x))
    _close(got, want)
    _close(whole, jconv.apply(params, jes, jnp.asarray(x)))
    assert not np.allclose(got.numpy(), whole.numpy())


@pytest.mark.parametrize("kind", ["block", "basis"])
def test_layer_gradient_matches_flax_pallas(kind):
    n, din, dout = 48, 8, 8
    jes, tes = _dynamic_pair(n, 3, 90, tile=8, seed=9)
    jconv, tconv = _conv_pair(kind, n, din, dout, 0.0)
    rng = np.random.default_rng(6)
    x, w = _f32(rng, n, din), _f32(rng, n, dout)
    params = jconv.init(jax.random.key(1), jes, jnp.asarray(x))
    _load_conv(tconv, params)

    def loss(p, x):
        return jnp.sum(jconv.apply(p, jes, x) * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (tconv(tes, tx) * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, gx)
    for name, g in gp["params"].items():
        _close(getattr(tconv, name).grad, g)


# -- ranking -------------------------------------------------------------------


def test_filters_ranks_and_metrics_match_jax():
    d = synthetic_link_prediction(num_nodes=50, num_rels=3, num_edges=400)
    test = np.asarray(d.test)
    got, want = tev.build_filters(test, d.all_triples, 50), \
        jev.build_filters(test, d.all_triples, 50)
    np.testing.assert_array_equal(got.heads, want.heads)
    np.testing.assert_array_equal(got.tails, want.tails)
    assert tev.generate_true_dict(d.all_triples) == jev.generate_true_dict(d.all_triples)

    rng = np.random.default_rng(0)
    scores = rng.integers(0, 6, (len(test), 50)).astype(np.float32)  # many ties
    for filt, col in ((got.heads, 0), (got.tails, 2)):
        want_r = jev.ranks_from_scores(jnp.asarray(scores), jnp.asarray(test[:, col]),
                                       jnp.asarray(filt), jnp.ones(len(test), bool))
        got_r = tev.ranks_from_scores(torch.from_numpy(scores),
                                      torch.from_numpy(test[:, col]),
                                      torch.from_numpy(filt))
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
        assert tev.ranking_metrics(got_r.numpy()) == jev.ranking_metrics(np.asarray(want_r))


# -- the trainer against the JAX trainer ----------------------------------------


def _small_cfg(load, name, epochs=4):
    cfg = load(CFG[name])
    enc = cfg.encoder
    decomp = (dataclasses.replace(enc.decomposition, num_blocks=2)
              if enc.decomposition.type == "block" else enc.decomposition)
    enc = dataclasses.replace(
        enc, node_embedding=8, hidden1_size=8, decomposition=decomp,
        edge_dropout=dataclasses.replace(enc.edge_dropout, general=0.3, self_loop=0.0))
    tr = cfg.training
    tr = dataclasses.replace(
        tr, epochs=epochs, graph_batch_size=48,
        negative_sampling=dataclasses.replace(tr.negative_sampling, sampling_rate=3))
    ev = dataclasses.replace(cfg.evaluation, check_every=2, batch_size=16, verbose=False)
    return dataclasses.replace(cfg, encoder=enc, training=tr, evaluation=ev)


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name,n", [("lp-WN18", 60), ("lp-FB-toy", 62)])
def test_trainer_matches_jax_trainer(tmp_path, name, n):
    jcfg, cfg = _small_cfg(j_load, name), _small_cfg(load_experiment, name)
    jd = j_synth_lp(num_nodes=n, num_rels=3, num_edges=320)
    d = synthetic_link_prediction(num_nodes=n, num_rels=3, num_edges=320)
    tile, seed = 8, 0
    j_mrr, _, j_ranks, _ = j_train(
        jcfg, jd, seed=seed, tile_size=tile, pallas_train_step=True,
        host_graph_build=True,
        logger=JScalarLogger(run_dir=str(tmp_path / "jax"), verbose=False))
    # the JAX trainer's initialisation (it padded jd's nodes in place)
    train = np.asarray(jd.train, dtype=np.int64)
    init_pos = jnp.asarray(train[:jcfg.training.graph_batch_size])
    params = j_build_lp(jcfg, jd.num_nodes, jd.num_relations).init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        j_build_dynamic(init_pos, jd.num_nodes, jd.num_relations, tile_size=tile),
        init_pos)
    init = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    logger = ScalarLogger(run_dir=str(tmp_path / "port"), verbose=False)
    mrr, _, ranks, _ = train_link_predictor(cfg, d, seed=seed, tile_size=tile,
                                            logger=logger, init_state=init, device="cpu")
    logger.close()
    assert d.num_nodes == jd.num_nodes
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


def test_trainer_refuses_unstructured_decoders():
    """Once refused: a biased decoder now trains on the assembled batch, the
    epoch carrying the batch and its two layouts instead of the structured
    ones, from the same negative draws."""
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    cfg = _small_cfg(load_experiment, "lp-WN18")
    d = synthetic_link_prediction(num_nodes=40, num_rels=3, num_edges=120)
    biased = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                  bias_init="zeros"))
    assert cfg.structured_decoder_ok(True) and not biased.structured_decoder_ok(True)
    assert not cfg.structured_decoder_ok(False)
    got = LinkPredictionTrainer(biased, d, device="cpu").sample_epoch(2)
    want = LinkPredictionTrainer(cfg, d, device="cpu").sample_epoch(2)
    assert got.layouts is None and want.batch is None and want.batch_layouts is None
    np.testing.assert_array_equal(got.corrupt_ent, want.corrupt_ent)
    np.testing.assert_array_equal(got.corrupt_head, want.corrupt_head)
    p = len(got.positives)
    np.testing.assert_array_equal(got.batch[:p], got.positives)
    assert got.batch.shape == (p + len(got.corrupt_ent), 3)
    for lay, col in zip(got.batch_layouts, (0, 2)):
        _same_layout(lay, jdm.build_batch_layouts(got.batch, d.num_nodes)[col // 2])
    trainer = LinkPredictionTrainer(biased, d, device="cpu")
    trainer.set_epoch(2, got)
    assert np.isfinite(trainer.step())


def test_predict_links_cli_cpu(tmp_path, capsys):
    from rgcn_tpu_torch import predict_links

    predict_links.main(["--config", CFG["lp-FB-toy"], "--synthetic", "--cpu",
                        "--epochs", "2", "--run-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[synthetic] FB-toy-like graph: N=280 R=112")
    assert any(line.startswith("[Epoch 2] Loss: ") for line in out)
    assert out[-1].startswith("[Final Scores] Total Epoch 2 MRR(filtered): ")
    recs = _records(tmp_path)
    assert [r["metric"] for r in recs] == ["training.loss", "training.loss", "test.mrr",
                                           "test.hits_at_1", "test.hits_at_3",
                                           "test.hits_at_10"]
    assert all(np.isfinite(r["value"]) for r in recs)
    with pytest.raises(SystemExit):
        predict_links.main(["--config", CFG["lp-FB-toy"], "--cpu"])  # --synthetic required
