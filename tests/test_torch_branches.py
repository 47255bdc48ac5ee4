"""The single-device branches no shipped config reaches, in the port against
the JAX package, on the CPU.

The featureless basis VJP (``rel_spmm_featureless_basis_fwd`` under grad)
against ``jax.vjp`` of ``rel_spmm_featureless_basis_ad`` (nb 1, 2, 4, 8; N
not a multiple of the row block; reverse frames with pad chunks); the
merged frame's VJP (``rel_spmm_basis`` over a merged layout, with and
without ``fwd_dedup``) against ``jax.vjp`` of ``rel_spmm_basis_merged_ad``
on a graph with reciprocal duplicates; the assembled-batch DistMult
scorers against ``jax.vjp`` of ``distmult_score_agg_ad`` and
``distmult_score_spenalty_agg_ad``, and ``build_batch_layouts`` bit-equal
to JAX's (native and numpy); the models' gradients through
``from_jax_params`` against ``jax.grad`` of the flax models with
``backend="pallas"`` (R-GCN NC with 4 bases over a merged and an unmerged
frame, e-RGCN with 4 bases and with 2 blocks, ``LinkPredictor`` with a
biased decoder and with a plain L2 over the batch's layouts); the
trainers' records against the JAX trainers' from the JAX initialisation
(NC few-basis, e-RGCN with blocks and bases, LP with a biased decoder and a
plain L2 through ``pallas_train_step=True, host_graph_build=True``); the
structural self-loop dropout (the layer under a given ``(N, 1)`` mask
against the flax layer's ``self_mask``, the trainer's numpy draws, a
resumed run bit-equal to an unbroken one); ``from_jax_params`` on a JAX
``LinkPredictor(feature_blocks=True)``; the R-GCN's featureless block
refusal. Pallas runs in interpret mode; the port runs its kernels' plain
versions on CPU tensors. Tolerance atol 1e-5·max(1, max|ref|); losses
rtol 1e-4, accuracies equal, LP MRR within 1e-3.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.config import DecompositionConfig as JDecomp
from rgcn_tpu.config import load_experiment as j_load
from rgcn_tpu.data.synthetic import synthetic_link_prediction as j_synth_lp
from rgcn_tpu.data.synthetic import synthetic_node_classification as j_synth_nc
from rgcn_tpu.graph import coalesce as jco
from rgcn_tpu.graph.dynamic import build_edge_set_dynamic as j_build_dynamic
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.models.link_prediction import LinkPredictor as JLP
from rgcn_tpu.models.node_classification import EmbeddingNodeClassifier as JENC
from rgcn_tpu.models.node_classification import NodeClassifier as JNC
from rgcn_tpu.nn.layers import RGCNConv as JConv
from rgcn_tpu.ops import pallas_distmult as jdm
from rgcn_tpu.ops.pallas_basis import rel_spmm_basis_merged_ad as j_merged_ad
from rgcn_tpu.ops.pallas_basis import rel_spmm_featureless_basis_ad as j_fl_ad
from rgcn_tpu.train.link_prediction import build_lp_model as j_build_lp
from rgcn_tpu.train.link_prediction import train_link_predictor as j_train_lp
from rgcn_tpu.train.node_classification import build_nc_model as j_build_nc
from rgcn_tpu.train.node_classification import train_node_classifier as j_train_nc
from rgcn_tpu.utils.logging import ScalarLogger as JScalarLogger
from rgcn_tpu_torch.config import DecompositionConfig, load_experiment
from rgcn_tpu_torch.data.synthetic import (
    synthetic_link_prediction,
    synthetic_node_classification,
)
from rgcn_tpu_torch.graph import coalesce as tco
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.models.link_prediction import LinkPredictor
from rgcn_tpu_torch.models.node_classification import (
    EmbeddingNodeClassifier,
    NodeClassifier,
    build_nc_model,
)
from rgcn_tpu_torch.nn.layers import RGCNConv
from rgcn_tpu_torch.ops import distmult_train as tdm
from rgcn_tpu_torch.ops.basis import rel_spmm_basis, rel_spmm_featureless_basis_fwd
from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer
from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer
from rgcn_tpu_torch.utils.logging import ScalarLogger
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg_path(model, name):
    return os.path.join(ROOT, "configs", model, f"{name}.yaml")


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want), err_msg=err_msg)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _reciprocal(n, r, e, seed):
    """Random triples with half of them reversed again: reciprocal
    duplicates that the merged frame coalesces."""
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    return np.unique(np.concatenate([t, t[: e // 2, ::-1]]), axis=0)


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _same_records(got, want, lp=False):
    assert [(r["metric"], r["step"]) for r in got] == \
        [(r["metric"], r["step"]) for r in want]
    for a, b in zip(got, want):
        if a["metric"] == "training.loss":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4)
        elif lp:
            assert abs(a["value"] - b["value"]) <= 1e-3, a["metric"]
        else:
            assert a["value"] == b["value"], a["metric"]


# -- the basis VJPs ------------------------------------------------------------


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
def test_featureless_basis_vjp_matches_jax(nb):
    n, r, dout, rb = 150, 4, 6, 32  # 150 rows over blocks of 32
    t = make_random_triples(np.random.default_rng(nb), n, r, 1500)
    kw = dict(tile_size=16, with_dst_layout=True, layout_row_block=rb)
    jes = j_build(t, n, r, prefer_native=False, **kw)
    tes = build_edge_set(t, n, r, **kw).to("cpu")
    rev = tes.reverse.layout
    assert n % rb and rev.num_chunks > rev.num_row_blocks  # several chunks a block
    assert int((rev.local_dst == rb).sum()) > 0  # pad slots in the reverse frame
    rng = np.random.default_rng(nb + 10)
    bases, comps, g = _f32(rng, nb, n, dout), _f32(rng, 2 * r, nb), _f32(rng, n, dout)

    def f(bases, comps):
        return j_fl_ad(jes, bases, comps, compute_dtype=None)

    want, vjp = jax.vjp(f, jnp.asarray(bases), jnp.asarray(comps))
    wdb, wdc = vjp(jnp.asarray(g))
    tb, tc = (torch.tensor(a, requires_grad=True) for a in (bases, comps))
    got = rel_spmm_featureless_basis_fwd(tes, tb, tc)
    got.backward(torch.from_numpy(g))
    _close(got, want, "forward")
    _close(tb.grad, wdb, "dbases")
    assert tb.grad.is_contiguous()
    _close(tc.grad, wdc, "dcomps")
    with torch.no_grad():
        _close(rel_spmm_featureless_basis_fwd(tes, tb, tc), want, "no-grad forward")


def test_featureless_basis_vjp_needs_the_reverse():
    t = make_random_triples(np.random.default_rng(0), 30, 3, 80)
    es = build_edge_set(t, 30, 3, tile_size=16, with_dst_layout=True).to("cpu")
    bases = torch.zeros((2, 30, 4), requires_grad=True)
    with pytest.raises(ValueError, match="reversed edges"):
        rel_spmm_featureless_basis_fwd(dataclasses.replace(es, reverse=None), bases,
                                       torch.zeros((6, 2)))


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("nb,din,dout", [(2, 12, 10), (4, 8, 5)])
def test_basis_merged_vjp_matches_jax(dedup, nb, din, dout):
    n, r = 260, 4
    t = _reciprocal(n, r, 1200, seed=nb + din)
    kw = dict(tile_size=16, with_dst_layout=True)
    jes = j_build(t, n, r, prefer_native=False, **kw)
    tes = build_edge_set(t, n, r, **kw)
    args = (jes.dst, jes.src, jes.rel, jes.val, n, jes.num_rels)
    mkw = dict(row_block=64, chunk=128, dedup_k=2 if dedup else 0)
    jm = jco.build_merged_layout(*args, **mkw)
    tm = tco.build_merged_layout(*args, **mkw)
    assert tm.num_pairs < tm.num_edges  # reciprocal duplicates merged
    assert (tm.fwd_dedup is not None) == dedup
    tes = dataclasses.replace(tes, merged=tm).to("cpu")
    rng = np.random.default_rng(din)
    x, bases = _f32(rng, n, din), _f32(rng, nb, din, dout)
    comps, g = _f32(rng, 2 * r, nb), _f32(rng, n, dout)

    def f(x, bases, comps):
        return j_merged_ad(jm, x, bases, comps, compute_dtype=None)

    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(bases), jnp.asarray(comps))
    wdx, wdb, wdc = vjp(jnp.asarray(g))
    tx, tb, tc = (torch.tensor(a, requires_grad=True) for a in (x, bases, comps))
    got = rel_spmm_basis(tes, tx, tb, tc)
    got.backward(torch.from_numpy(g))
    _close(got, want, "forward")
    _close(tx.grad, wdx, "dx")
    _close(tb.grad, wdb, "dbases")
    _close(tc.grad, wdc, "dcomps")
    with torch.no_grad():
        _close(rel_spmm_basis(tes, tx, tb, tc), want, "no-grad forward")


# -- the assembled-batch scorers -----------------------------------------------


def _batch(n, r, p, ns, seed):
    from rgcn_tpu_torch.train.negative import corrupt_batch_host

    pos = make_random_triples(np.random.default_rng(seed), n, r, p)
    batch, _ = corrupt_batch_host(np.random.default_rng(seed + 1), pos, n, ns, 0.5)
    return batch


@pytest.mark.parametrize("n,p,rb,chunk", [(90, 40, 128, 256), (300, 170, 32, 64)])
def test_build_batch_layouts_bit_equal(n, p, rb, chunk):
    batch = _batch(n, 5, p, 3, seed=n)
    want = jdm.build_batch_layouts(batch, n, row_block=rb, chunk=chunk)
    for native in (True, False):
        got = tdm.build_batch_layouts(batch, n, row_block=rb, chunk=chunk,
                                      prefer_native=native)
        for g, w in zip(got, want):
            for f in ("perm", "local_dst", "chunk_block"):
                a, b = getattr(g, f), np.asarray(getattr(w, f))
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
            for f in ("num_row_blocks", "row_block", "chunk"):
                assert getattr(g, f) == getattr(w, f), f


@pytest.mark.parametrize("pen", [False, True])
def test_assembled_scorers_vjp_match_jax(pen):
    n, r, d = 120, 5, 12
    batch = _batch(n, r, 60, 4, seed=3)
    jl = jdm.build_batch_layouts(batch, n, row_block=32, chunk=64)
    tl = tuple(lay.to("cpu") for lay in tdm.build_batch_layouts(
        batch, n, row_block=32, chunk=64))
    rng = np.random.default_rng(5)
    nodes, rels = _f32(rng, n, d), _f32(rng, r, d)
    pw = np.full(len(batch), 1.0 / len(batch), np.float32)
    gs, gp = _f32(rng, len(batch)), np.float32(0.7)
    tn, tr = (torch.tensor(a, requires_grad=True) for a in (nodes, rels))
    tb = torch.from_numpy(batch)
    if pen:
        def f(nodes, rels):
            return jdm.distmult_score_spenalty_agg_ad(batch, nodes, rels, pw, jl)

        (ws, wp), vjp = jax.vjp(f, jnp.asarray(nodes), jnp.asarray(rels))
        wdn, wdr = vjp((jnp.asarray(gs), jnp.asarray(gp)))
        s, penalty = tdm.distmult_score_spenalty_agg(tb, tn, tr, torch.from_numpy(pw), tl)
        _close(penalty, wp, "penalty")
        (s * torch.from_numpy(gs)).sum().add(penalty * float(gp)).backward()
    else:
        def f(nodes, rels):
            return jdm.distmult_score_agg_ad(batch, nodes, rels, jl)

        ws, vjp = jax.vjp(f, jnp.asarray(nodes), jnp.asarray(rels))
        wdn, wdr = vjp(jnp.asarray(gs))
        s = tdm.distmult_score_agg(tb, tn, tr, tl)
        s.backward(torch.from_numpy(gs))
    _close(s, ws, "scores")
    _close(tn.grad, wdn, "dnodes")
    _close(tr.grad, wdr, "drelations")


# -- the models' gradients against jax.grad --------------------------------------


def _grads_match(want_params, module, err=""):
    want = from_jax_params(_np_tree(want_params))
    grads = dict(module.named_parameters())
    assert set(grads) == set(want), (set(grads), set(want))
    for name, g in want.items():
        _close(grads[name].grad, g, f"{err} {name}")


@pytest.mark.parametrize("model,decomp,rels,nb", [
    ("rgcn", "basis", 4, 4),     # merged frame at layer 2
    ("rgcn", "basis", 70, 4),    # 140 general relations: unmerged
    ("e-rgcn", "basis", 4, 4),   # rgc1 over the merged frame
    ("e-rgcn", "basis", 4, 10),  # more than 8 bases: expanded dense weights
    ("e-rgcn", "block", 4, 0),
])
def test_nc_model_gradient_matches_flax_pallas(model, decomp, rels, nb):
    n, c = 90, 4
    t = _reciprocal(n, rels, 420, seed=rels)
    merge = rels * 2 <= tco.MERGED_MAX_RELS
    kw = dict(tile_size=16, with_dst_layout=True, with_merged_layout=merge)
    jes = j_build(t, n, rels, prefer_native=False, **kw)
    tes = build_edge_set(t, n, rels, **kw).to("cpu")
    assert (tes.merged is not None) == merge
    dk = dict(decomposition=decomp, num_bases=nb,
              num_blocks=2 if decomp == "block" else 0)
    if model == "rgcn":
        jm = JNC(num_nodes=n, num_relations=rels, num_classes=c, hidden_size=6,
                 backend="pallas", **dk)
        tm = NodeClassifier(n, rels, c, hidden_size=6, **dk)
    else:
        jm = JENC(num_nodes=n, num_relations=rels, num_classes=c, emb_dim=8,
                  backend="pallas", **dk)
        tm = EmbeddingNodeClassifier(n, rels, c, emb_dim=8, **dk)
    params = jm.init(jax.random.key(rels), jes)
    tm.load_state_dict(from_jax_params(_np_tree(params)))
    w = _f32(np.random.default_rng(1), n, c)

    def loss(p):
        return jnp.sum(jm.apply(p, jes) * w)

    logits = tm(tes)
    _close(logits, jm.apply(params, jes), "logits")
    (logits * torch.from_numpy(w)).sum().backward()
    _grads_match(jax.grad(loss)(params), tm, f"{model}/{decomp}")


@pytest.mark.parametrize("decoder", ["biased", "plain-l2", "schlichtkrull-l2"])
def test_lp_model_gradient_matches_flax_pallas(decoder):
    n, r, d = 70, 3, 8
    t = make_random_triples(np.random.default_rng(2), n, r, 260)
    kw = dict(tile_size=8, with_dst_layout=True)
    jes = j_build(t, n, r, prefer_native=False, **kw)
    tes = build_edge_set(t, n, r, **kw).to("cpu")
    mk = dict(emb_dim=d, num_layers=2, decomposition="basis", num_bases=2,
              decoder_l2=0.01,
              decoder_l2_type="l2" if decoder == "plain-l2" else "schlichtkrull-l2",
              decoder_bias_init="zeros" if decoder == "biased" else None)
    jm = JLP(num_nodes=n, num_relations=r, backend="pallas", **mk)
    tm = LinkPredictor(n, r, **mk)
    batch = _batch(n, r, 30, 3, seed=4)
    jl = jdm.build_batch_layouts(batch, n)
    tl = tuple(lay.to("cpu") for lay in tdm.build_batch_layouts(batch, n))
    params = jm.init(jax.random.key(3), jes, batch)
    if decoder == "biased":  # zero-initialised biases would hide a wrong gradient
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: a + 0.1 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape)
            / a.size if "bias" in jax.tree_util.keystr(path) else a, params)
    tm.load_state_dict(from_jax_params(_np_tree(params)))
    w = _f32(np.random.default_rng(6), len(batch))

    def loss(p):
        s, pen = jm.apply(p, jes, batch, batch_layouts=jl)
        return jnp.sum(s * w) + 3.0 * pen

    (ws, wp) = jm.apply(params, jes, batch, batch_layouts=jl)
    s, pen = tm(tes, torch.from_numpy(batch), batch_layouts=tl)
    _close(s, ws, "scores")
    _close(pen, wp, "penalty")
    ((s * torch.from_numpy(w)).sum() + 3.0 * pen).backward()
    _grads_match(jax.grad(loss)(params), tm, decoder)


# -- the trainers against the JAX trainers --------------------------------------


def _nc_cfg(load, model, decomp, epochs=5):
    cfg = load(_cfg_path(model, "nc-AIFB"))
    rg = dataclasses.replace(cfg.rgcn, decomposition=decomp)
    return dataclasses.replace(cfg, rgcn=rg, training=dataclasses.replace(
        cfg.training, epochs=epochs))


@pytest.mark.parametrize("model,kind,rels", [
    ("rgcn", "basis", 8),     # aifb_like-shaped: layer 2 over the merged frame
    ("rgcn", "basis", 70),    # unmerged layer 2
    ("e-rgcn", "block", 8),
    ("e-rgcn", "basis", 8),
])
def test_nc_trainer_matches_jax_trainer(tmp_path, model, kind, rels):
    kw = dict(num_nodes=300, num_rels=rels, num_edges=2000, seed=0)
    jd, d = j_synth_nc(**kw), synthetic_node_classification(**kw)
    spec = dict(num_bases=4) if kind == "basis" else dict(num_blocks=2)
    jcfg = _nc_cfg(j_load, model, JDecomp(kind, **spec))
    cfg = _nc_cfg(load_experiment, model, DecompositionConfig(kind, **spec))
    if kind == "block":  # e-RGCN's rgc1 maps 32 -> classes in blocks of 2
        assert jd.num_classes % 2 == 0
    jes = j_build(jd.triples, jd.num_nodes, jd.num_relations, tile_size=16,
                  prefer_native=False)
    params = j_build_nc(jcfg, jd).init(jax.random.key(0), jes)
    j_acc = j_train_nc(jcfg, jd, seed=0, tile_size=16,
                       logger=JScalarLogger(run_dir=str(tmp_path / "jax"), verbose=False))
    trainer = NodeClassificationTrainer(cfg, d, tile_size=16, device="cpu",
                                        init_params=from_jax_params(_np_tree(params)))
    assert (trainer.edges.merged is not None) == (rels == 8)
    logger = ScalarLogger(run_dir=str(tmp_path / "port"), verbose=False)
    acc = trainer.fit(logger)
    logger.close()
    got = _records(tmp_path / "port")
    _same_records(got, _records(tmp_path / "jax"))
    assert len(got) == 3 * 5 + 1 and acc == j_acc
    losses = [r["value"] for r in got if r["metric"] == "training.loss"]
    assert losses[-1] < losses[0]


def _lp_cfg(load, decoder, epochs=4, self_loop=0.0):
    cfg = load(_cfg_path("rgcn", "lp-WN18"))
    enc = dataclasses.replace(
        cfg.encoder, node_embedding=8, hidden1_size=8,
        edge_dropout=dataclasses.replace(cfg.encoder.edge_dropout, general=0.3,
                                         self_loop=self_loop,
                                         self_loop_type="structural"))
    dec = cfg.decoder
    if decoder == "biased":
        dec = dataclasses.replace(dec, bias_init="zeros")
    elif decoder == "plain-l2":
        dec = dataclasses.replace(dec, l2_penalty_type="l2")
    tr = dataclasses.replace(
        cfg.training, epochs=epochs, graph_batch_size=48,
        negative_sampling=dataclasses.replace(cfg.training.negative_sampling,
                                              sampling_rate=3))
    ev = dataclasses.replace(cfg.evaluation, check_every=2, batch_size=16, verbose=False)
    return dataclasses.replace(cfg, encoder=enc, decoder=dec, training=tr, evaluation=ev)


@pytest.mark.parametrize("decoder", ["biased", "plain-l2"])
def test_lp_trainer_matches_jax_trainer(tmp_path, decoder):
    jcfg, cfg = _lp_cfg(j_load, decoder), _lp_cfg(load_experiment, decoder)
    assert not cfg.structured_decoder_ok(True)
    kw = dict(num_nodes=60, num_rels=3, num_edges=320)
    jd, d = j_synth_lp(**kw), synthetic_link_prediction(**kw)
    tile, seed = 8, 0
    j_mrr, _, j_ranks, _ = j_train_lp(
        jcfg, jd, seed=seed, tile_size=tile, pallas_train_step=True,
        host_graph_build=True,
        logger=JScalarLogger(run_dir=str(tmp_path / "jax"), verbose=False))
    train = np.asarray(jd.train, dtype=np.int64)
    init_pos = jnp.asarray(train[:jcfg.training.graph_batch_size])
    params = j_build_lp(jcfg, jd.num_nodes, jd.num_relations).init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        j_build_dynamic(init_pos, jd.num_nodes, jd.num_relations, tile_size=tile),
        init_pos)
    logger = ScalarLogger(run_dir=str(tmp_path / "port"), verbose=False)
    trainer = LinkPredictionTrainer(cfg, d, seed=seed, tile_size=tile, device="cpu",
                                    logger=logger,
                                    init_state=from_jax_params(_np_tree(params)))
    mrr, _, ranks = trainer.fit(logger)
    logger.close()
    assert trainer.batch.batch is not None and trainer.batch.layouts is None
    got = _records(tmp_path / "port")
    _same_records(got, _records(tmp_path / "jax"), lp=True)
    assert sum(r["metric"] == "training.loss" for r in got) == 4
    assert abs(mrr - j_mrr) <= 1e-3
    assert np.mean(np.asarray(ranks) == np.asarray(j_ranks)) >= 0.95


# -- structural self-loop dropout ---------------------------------------------------


@pytest.mark.parametrize("kind", ["basis", "block"])
def test_structural_mask_matches_flax_self_mask(kind):
    n, r, din, dout = 48, 3, 8, 8
    t = make_random_triples(np.random.default_rng(8), n, r, 160)
    kw = dict(tile_size=8, with_dst_layout=True)
    jes = j_build(t, n, r, prefer_native=False, **kw)
    tes = build_edge_set(t, n, r, **kw).to("cpu")
    dk = dict(decomposition=kind, num_bases=2 if kind == "basis" else 0,
              num_blocks=2 if kind == "block" else 0)
    jconv = JConv(num_nodes=n, num_relations=2 * r + 1, in_features=din,
                  out_features=dout, separate_self_weight=kind == "block",
                  backend="pallas", **dk)
    tconv = RGCNConv(n, 2 * r + 1, dout, in_features=din,
                     separate_self_weight=kind == "block", **dk)
    rng = np.random.default_rng(9)
    x, w = _f32(rng, n, din), _f32(rng, n, dout)
    params = jconv.init(jax.random.key(2), jes, jnp.asarray(x))
    tconv.load_state_dict({k.split(".", 1)[1]: v for k, v in from_jax_params(
        {"params": {"c": _np_tree(params)["params"]}}).items()})
    mask = (rng.random((n, 1)) < 0.8).astype(np.float32)

    def loss(p):
        return jnp.sum(jconv.apply(p, jes, jnp.asarray(x), self_mask=mask) * w)

    want = jconv.apply(params, jes, jnp.asarray(x), self_mask=mask)
    got = tconv(tes, torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, want)
    assert not np.allclose(got.detach().numpy(),
                           tconv(tes, torch.from_numpy(x)).detach().numpy())
    (got * torch.from_numpy(w)).sum().backward()
    for name, g in _np_tree(jax.grad(loss)(params))["params"].items():
        _close(getattr(tconv, name).grad, g, name)


def test_trainer_structural_masks_are_numpy_draws():
    cfg = _lp_cfg(load_experiment, "schlichtkrull", self_loop=0.2)
    d = synthetic_link_prediction(num_nodes=50, num_rels=3, num_edges=200)
    trainer = LinkPredictionTrainer(cfg, d, seed=5, device="cpu")
    assert trainer.model.rgc1.self_loop_dropout == 0.0
    for epoch in (1, 4):
        masks = trainer.sample_epoch(epoch).self_masks
        want = (np.random.default_rng((5, epoch, 13)).random((50, 1), dtype=np.float32)
                < 0.8).astype(np.float32)
        assert len(masks) == trainer.model.num_layers
        for m in masks:
            assert m.dtype == np.float32 and m.shape == (50, 1)
            np.testing.assert_array_equal(m, want)
        assert 0 < want.sum() < 50


@pytest.mark.parametrize("decoder", ["schlichtkrull", "plain-l2"])
def test_structural_dropout_resume_is_exact(tmp_path, decoder):
    cfg = _lp_cfg(load_experiment, decoder, epochs=4, self_loop=0.2)
    cfg = dataclasses.replace(cfg, evaluation=dataclasses.replace(
        cfg.evaluation, check_every=10))
    d = synthetic_link_prediction(num_nodes=50, num_rels=3, num_edges=200)

    def run(ck, max_epochs=None):
        t = LinkPredictionTrainer(cfg, d, device="cpu", checkpoint_dir=ck,
                                  checkpoint_every=2, max_epochs=max_epochs,
                                  logger=ScalarLogger(verbose=False))
        return t, t.fit(ScalarLogger(verbose=False))

    whole, (mrr, _, ranks) = run(str(tmp_path / "whole"))
    run(str(tmp_path / "broken"), max_epochs=2)
    resumed, (r_mrr, _, r_ranks) = run(str(tmp_path / "broken"))
    assert r_mrr == mrr
    np.testing.assert_array_equal(r_ranks, ranks)
    for (name, a), b in zip(whole.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


# -- the JAX model's feature blocks and the featureless block refusal -----------


def test_from_jax_params_joins_feature_blocks():
    n, r, d = 60, 3, 200  # blocks of 128 and 72
    t = make_random_triples(np.random.default_rng(11), n, r, 200)
    kw = dict(tile_size=8, with_dst_layout=True)
    jes = j_build(t, n, r, prefer_native=False, **kw)
    tes = build_edge_set(t, n, r, **kw).to("cpu")
    mk = dict(emb_dim=d, num_layers=1, decomposition="basis", num_bases=2)
    jm = JLP(num_nodes=n, num_relations=r, backend="pallas", feature_blocks=True, **mk)
    batch = _batch(n, r, 20, 2, seed=12)
    params = jm.init(jax.random.key(4), jes, batch)
    leaves = _np_tree(params)["params"]
    assert [leaves[f"node_embeddings_block{i}"].shape for i in (0, 1)] == \
        [(n, 128), (n, 72)]
    state = from_jax_params(_np_tree(params))
    np.testing.assert_array_equal(
        state["node_embeddings"].numpy(),
        np.concatenate([leaves["node_embeddings_block0"],
                        leaves["node_embeddings_block1"]], axis=1))
    tm = LinkPredictor(n, r, **mk)
    tm.load_state_dict(state)
    with torch.no_grad():
        z = tm.encode(tes)
        s, _ = tm(tes, torch.from_numpy(batch))
    _close(z, jm.apply(params, jes, method=jm.encode), "encode")
    _close(s, jm.apply(params, jes, batch)[0], "scores")


def test_rgcn_featureless_block_raises_as_jax():
    cfg = _nc_cfg(load_experiment, "rgcn", DecompositionConfig("block", num_blocks=2))
    jcfg = _nc_cfg(j_load, "rgcn", JDecomp("block", num_blocks=2))
    d = synthetic_node_classification(num_nodes=40, num_rels=3, num_edges=120)
    jd = j_synth_nc(num_nodes=40, num_rels=3, num_edges=120)
    jes = j_build(jd.triples, 40, 3, tile_size=16, prefer_native=False)
    with pytest.raises(NotImplementedError, match="featureless block") as j_err:
        j_build_nc(jcfg, jd).init(jax.random.key(0), jes)
    with pytest.raises(NotImplementedError, match="featureless block") as t_err:
        NodeClassificationTrainer(cfg, d, device="cpu")
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(NotImplementedError, match="featureless block"):
        build_nc_model(cfg, d)
