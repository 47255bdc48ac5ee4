"""The unique-(src, rel) pair path in the port against the JAX package, f32
on the CPU: the pair builders bit-equal (both orders, the composed and
by-source layouts, ``reweight_edge_set``), ``aggregate_pairs`` against
``aggregate_pairs_ad`` and ``gather_rows_agg`` against
``_gather_rows_agg_bwd`` forward and VJP (Pallas in interpret mode), the
pair contraction ungrouped and in groups, RGCNConv's two pair branches
against the flax layer with ``backend="pallas"`` (outputs and
``jax.grad``), and the trainer's records against the JAX trainer for the
nc-MUTAG, nc-BGS and nc-AM configs.

The graph has parallel (src, rel) edges on purpose: one subject with many
objects under one predicate (its inverse edges share one pair), pad edges
and isolated nodes. Tolerance atol 1e-5 (1e-5·max(1, max|ref|) for
outputs past 1): the same f32 sums in another order; losses rtol 1e-4,
accuracies equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.config import load_experiment as j_load_experiment
from rgcn_tpu.data.synthetic import synthetic_node_classification as j_synth
from rgcn_tpu.graph import structure as jst
from rgcn_tpu.nn.layers import RGCNConv as JConv
from rgcn_tpu.ops import pallas_aggregate as jagg
from rgcn_tpu.ops import spmm as jops
from rgcn_tpu.train.node_classification import build_nc_model as j_build_nc_model
from rgcn_tpu.train.node_classification import train_node_classifier as j_train
from rgcn_tpu.utils.logging import ScalarLogger as JScalarLogger
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import synthetic_node_classification
from rgcn_tpu_torch.graph import structure as tst
from rgcn_tpu_torch.nn.layers import RGCNConv
from rgcn_tpu_torch.ops import aggregate as tagg
from rgcn_tpu_torch.ops import spmm as tops
from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer
from rgcn_tpu_torch.utils.logging import ScalarLogger
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs", "rgcn")
ATOL = 1e-5
N, R = 100, 4  # nodes 90..99 are isolated
HUB = 3  # subject of predicate 0 towards 50 objects


def _triples(seed=0):
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, 90, R, 400)
    hub = np.array([[HUB, 0, o] for o in range(10, 60)])
    return np.unique(np.concatenate([t, hub]), axis=0), rng


def _graphs(seed=0, **kw):
    t, rng = _triples(seed)
    kw = dict(tile_size=16, with_dst_layout=True, with_pair_index=True,
              with_pair_agg=True, **kw)
    return (jst.build_edge_set(t, N, R, prefer_native=False, **kw),
            tst.build_edge_set(t, N, R, **kw), rng)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


def _same(a, b, path):
    """Equal dataclass trees: arrays bit-equal with equal dtypes."""
    assert (a is None) == (b is None), path
    if a is None:
        return
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# -- the builders -------------------------------------------------------------


def test_pair_builders_bit_equal():
    jes, tes, _ = _graphs()
    pi = tes.pairs
    # the hub's inverse edges share one pair: fewer pairs than real edges
    inv = (tes.rel == R) & (tes.src == HUB) & (tes.dst < N)
    assert int(inv.sum()) >= 50 and len(set(pi.edge_pair[inv])) == 1
    assert pi.num_pairs < tes.num_edges and (tes.dst == N).any()
    assert pi.pair_src.shape[0] == 1024 and pi.num_pairs < 1024  # pad pairs
    _same(jes.pairs, pi, "pairs")
    assert pi.agg.slot_val is not None and pi.src_layout is not None


@pytest.mark.parametrize("order", ["rel", "src"])
def test_src_rel_pairs_both_orders(order):
    jes, tes, _ = _graphs()
    want = jst.build_src_rel_pairs(jes, pad_multiple=256, order=order)
    got = tst.build_src_rel_pairs(tes, pad_multiple=256, order=order)
    _same(want, got, order)
    u = got.num_pairs
    keys = (got.pair_rel, got.pair_src) if order == "rel" else (got.pair_src, got.pair_rel)
    np.testing.assert_array_equal(np.lexsort([k[:u] for k in keys[::-1]]), np.arange(u))
    with pytest.raises(ValueError, match="unknown pair order"):
        tst.build_src_rel_pairs(tes, order="dst")


def test_reweight_drops_what_froze_val():
    jes, tes, rng = _graphs(with_merged_layout=True)
    assert tes.merged is not None and tes.fused is not None
    val = tes.val * (rng.random(tes.val.shape[0]) > 0.3).astype(np.float32)
    want, got = jst.reweight_edge_set(jes, val), tst.reweight_edge_set(tes, val)
    for es in (want, got):
        assert es.merged is None and es.fused is None and es.reverse is None
        assert es.pairs.agg.slot_val is None and es.pairs.agg.grad_val is None
        assert es.layout is not None and es.pairs.src_layout is not None
    assert got.val is val and got.pairs.agg.slot_pair is tes.pairs.agg.slot_pair
    _same(want.pairs, got.pairs, "pairs")


def test_edge_set_to_moves_the_pair_layouts():
    _, tes, _ = _graphs()
    moved = tes.to("meta")
    pi = moved.pairs
    for t in (pi.pair_src, pi.edge_pair, pi.agg.slot_pair, pi.agg.grad_dst,
              pi.agg.slot_val, pi.agg.grad_layout.perm,
              pi.agg.grad_layout.local_dst, pi.src_layout.perm,
              pi.src_layout.chunk_block):
        assert isinstance(t, torch.Tensor) and t.device.type == "meta"
    assert pi.agg.grad_layout.perm.dtype == torch.int32
    with pytest.raises(ValueError, match="with_pair_agg requires"):
        tst.build_edge_set(_triples()[0], N, R, with_pair_index=True,
                           with_pair_agg=True)


# -- the two Functions against the JAX custom VJPs ---------------------------


@pytest.mark.parametrize("frozen", [True, False], ids=["slot_val", "live_val"])
def test_aggregate_pairs_matches_jax(frozen):
    jes, tes, rng = _graphs(1)
    if not frozen:  # masked values: slot_val / grad_val dropped
        val = tes.val * (rng.random(tes.val.shape[0]) > 0.3).astype(np.float32)
        jes, tes = jst.reweight_edge_set(jes, val), tst.reweight_edge_set(tes, val)
    tes = tes.to("cpu")
    u_pad, dout = tes.pairs.pair_src.shape[0], 7
    m, g = _f32(rng, u_pad, dout), _f32(rng, N, dout)
    pj = jes.pairs

    def j_fn(m_, v_):
        return jagg.aggregate_pairs_ad(m_, v_, pj.edge_pair, jes.dst, pj.agg,
                                       jes.layout, N)

    want, vjp = jax.vjp(j_fn, jnp.asarray(m), jnp.asarray(jes.val))
    want_dm, want_dval = vjp(jnp.asarray(g))

    mt = torch.from_numpy(m).requires_grad_()
    vt = tes.val.clone().requires_grad_()
    pi = tes.pairs
    out = tagg.aggregate_pairs(mt, vt, pi.edge_pair, tes.dst, pi.agg, tes.layout, N)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    _close(out.detach(), want)
    _close(mt.grad, want_dm)
    _close(vt.grad, want_dval)
    # no value gradient asked: none computed; under no_grad no Function
    mt.grad = None
    out = tagg.aggregate_pairs(mt, tes.val, pi.edge_pair, tes.dst, pi.agg, tes.layout, N)
    out.backward(torch.from_numpy(g))
    _close(mt.grad, want_dm)
    with torch.no_grad():
        plain = tagg.aggregate_pairs(mt, tes.val, pi.edge_pair, tes.dst, pi.agg,
                                     tes.layout, N)
    assert plain.grad_fn is None
    _close(plain, want)


def test_gather_rows_agg_matches_jax():
    jes, tes, rng = _graphs(2)
    tes = tes.to("cpu")
    width = 40  # nb·dout
    table = _f32(rng, N, width)
    u_pad = tes.pairs.pair_src.shape[0]
    g = _f32(rng, u_pad, width)
    want, vjp = jax.vjp(
        lambda t: jops._gather_rows_agg_bwd(t, jes.pairs.pair_src,
                                            jes.pairs.src_layout, N),
        jnp.asarray(table))
    (want_dt,) = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_()
    out = tops.gather_rows_agg(tt, tes.pairs.pair_src, tes.pairs.src_layout)
    out.backward(torch.from_numpy(g))
    _close(out.detach(), want)
    _close(tt.grad, want_dt)
    assert (tt.grad[90:] == 0).all()  # isolated nodes own no pair


@pytest.mark.parametrize("grouped", [False, True])
def test_pair_contract_matches_jax(monkeypatch, grouped):
    """The per-pair contraction (port table laid out (N, dout, nb), JAX's
    (N, nb, dout)) and its gradients in the bases and comps; ``grouped``
    lowers both budgets so the pairs go in groups (300 steps down to a
    divisor of U_pad, 256)."""
    jes, tes, rng = _graphs(3)
    tes = tes.to("cpu")
    nb, dout = 12, 5
    if grouped:
        monkeypatch.setattr(jops, "_PAIR_ELEM_BUDGET", 300 * nb * dout)
        monkeypatch.setattr(tops, "_PAIR_ELEM_BUDGET", 300 * nb * dout)
    bases, comps = _f32(rng, nb, N, dout), _f32(rng, tes.num_rels, nb)
    u_pad = tes.pairs.pair_src.shape[0]
    g = _f32(rng, u_pad, dout)

    def j_fn(b, c):
        table = jnp.swapaxes(b, 0, 1).reshape(N, nb * dout)
        return jops._pair_contract(table, c, jes.pairs, nb, dout)

    want, vjp = jax.vjp(j_fn, jnp.asarray(bases), jnp.asarray(comps))
    want_db, want_dc = vjp(jnp.asarray(g))
    bt = torch.from_numpy(bases).requires_grad_()
    ct = torch.from_numpy(comps).requires_grad_()
    table = bt.permute(1, 2, 0).reshape(N, dout * nb)
    m = tops.pair_contract(table, ct, tes.pairs, nb, dout)
    assert m.shape == (u_pad, dout)
    m.backward(torch.from_numpy(g))
    _close(m.detach(), want)
    _close(bt.grad, want_db)
    _close(ct.grad, want_dc)


# -- RGCNConv's pair branches against the flax layer -------------------------


@pytest.mark.parametrize("kind,nb", [("featureless", 40), ("featureful", 30)])
def test_pair_conv_matches_flax(kind, nb):
    jes, tes, rng = _graphs(4)
    tes = tes.to("cpu")
    din, dout = 16, 6
    featureless = kind == "featureless"
    jconv = JConv(num_nodes=N, num_relations=2 * R + 1, out_features=dout,
                  in_features=None if featureless else din,
                  decomposition="basis", num_bases=nb, backend="pallas")
    x = None if featureless else np.maximum(_f32(rng, N, din), 0)
    cot = _f32(rng, N, dout)
    jx = None if featureless else jnp.asarray(x)
    args = (jes,) if featureless else (jes, jx)
    params = jconv.clone(backend="xla").init(jax.random.key(nb), *args)
    params = {"params": {**params["params"],
                         "bias": jnp.asarray(_f32(rng, dout, scale=0.1))}}

    def j_loss(p, xx):
        out = jconv.apply(p, jes) if featureless else jconv.apply(p, jes, xx)
        return jnp.sum(out * cot), out

    (_, want), (want_dp, want_dx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jx)

    conv = RGCNConv(N, 2 * R + 1, dout, in_features=None if featureless else din,
                    decomposition="basis", num_bases=nb)
    strip = lambda tree: {k[2:]: v for k, v in from_jax_params(  # noqa: E731
        {"params": {"c": jax.tree_util.tree_map(np.asarray, tree["params"])}}).items()}
    conv.load_state_dict(strip(params))
    xt = None if featureless else torch.from_numpy(x).requires_grad_()
    out = conv(tes, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), want)
    want_grads = strip(want_dp)
    for name, p in conv.named_parameters():
        _close(p.grad, want_grads[name])
    if not featureless:
        _close(xt.grad, want_dx)


# -- the trainer against the JAX trainer -------------------------------------


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _epochs(cfg, epochs):
    return dataclasses.replace(
        cfg, training=dataclasses.replace(cfg.training, epochs=epochs))


@pytest.mark.parametrize("name", ["nc-MUTAG", "nc-BGS", "nc-AM"])
def test_trainer_matches_jax_trainer(tmp_path, name):
    """Three epochs of the many-basis configs at full width on the 500-node
    stand-in (tile 16) from the JAX trainer's initialisation: the port's
    records equal the JAX trainer's (its XLA path on the CPU, with the
    Pallas by-source backward in interpret mode)."""
    path = os.path.join(CONFIGS, name + ".yaml")
    jcfg, cfg = _epochs(j_load_experiment(path), 3), _epochs(load_experiment(path), 3)
    jd, d = j_synth(seed=0), synthetic_node_classification(seed=0)
    jes = jst.build_edge_set(jd.triples, jd.num_nodes, jd.num_relations,
                             tile_size=16, prefer_native=False)
    params = j_build_nc_model(jcfg, jd).init(jax.random.key(0), jes)
    init = from_jax_params(jax.tree_util.tree_map(np.asarray, params))

    j_acc = j_train(jcfg, jd, seed=0, tile_size=16,
                    logger=JScalarLogger(run_dir=str(tmp_path / "jax"), verbose=False))
    logger = ScalarLogger(run_dir=str(tmp_path / "port"), verbose=False)
    trainer = NodeClassificationTrainer(cfg, d, seed=0, tile_size=16,
                                        init_params=init, device="cpu")
    assert trainer.edges.pairs.agg is not None  # built as the JAX trainer does
    acc = trainer.fit(logger)
    logger.close()
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert [(r["metric"], r["step"]) for r in got] == \
        [(r["metric"], r["step"]) for r in want]
    assert len(got) == 3 * 3 + 1
    for a, b in zip(got, want):
        if a["metric"] == "training.loss":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4)
        else:
            assert a["value"] == b["value"], a["metric"]
    assert acc == j_acc
