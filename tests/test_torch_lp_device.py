"""LP epochs built on the device (the JAX trainer's ``host_graph_build=False``
path) in the port against the JAX package, on the CPU.

The device builders (``build_edge_set_dynamic`` with its layouts, reverse
and fused layouts, ``build_dst_layout_dynamic`` with and without a source
order, ``build_fused_layout_dynamic``) bit-equal to the JAX in-jit
builders for the same keep mask, every array and dtype; the negatives'
assembly of JAX's own draws bit-equal to ``negative_sampling`` and
``corrupt_batch``, equal generators giving equal corruptions in every
form, their ranges and head share; the layout-free structured scores
bit-equal to the layout path's and against
``distmult_structured_agg_ad(layouts=None)`` within 1e-5·max(1,
max|ref|) (the penalty rtol 1e-6: XLA and torch sum in other orders),
their gradients within 1e-5·max(1, max|ref|); one whole device-path step of
lp-WN18, lp-FB-toy, c-RGCN lp-WN18 and lp-WN18 with a biased decoder (the
assembled batch without layouts) at narrow widths against the JAX model
on the same draws (JAX's edge set, ``negative_structure`` and
``corrupt_batch``): the
loss within rtol 1e-5, every gradient within 1e-5·max(1, max|ref|); a
resumed device-path run equal to an unbroken one and no native host
builder called; ``make_sharded_lp_step`` on 2 gloo CPU ranks (two SGD
steps): the ranks bit-equal, within 1e-5 (loss rtol, gradients and
parameters 1e-5·max(1, max|ref|)) of the single-device device-path step
on the same generators.
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

from rgcn_tpu.config import load_experiment as j_load
from rgcn_tpu.graph import dynamic as jdyn
from rgcn_tpu.ops import pallas_distmult as jdm
from rgcn_tpu.ops import pallas_fused as jfused
from rgcn_tpu.train import negative as jneg
from rgcn_tpu.train.link_prediction import build_lp_model as j_build_lp
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import synthetic_link_prediction
from rgcn_tpu_torch.graph import dynamic as tdyn
from rgcn_tpu_torch.ops import distmult_train as tdm
from rgcn_tpu_torch.ops import fused as tfused
from rgcn_tpu_torch.train import negative as tneg
from rgcn_tpu_torch.train.link_prediction import (
    EpochDraws,
    LinkPredictionTrainer,
    epoch_generator,
)
from rgcn_tpu_torch.utils.logging import ScalarLogger
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE_FIELDS = ("src", "dst", "rel", "val", "tile_rel")
LAYOUT_FIELDS = ("perm", "local_dst", "chunk_block")
FUSED_FIELDS = ("src", "val", "local_dst", "quantum_rel", "chunk_block")


def _bits(got, want, fields, what):
    """Equal arrays, dtypes included."""
    for f in fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, (what, f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.{f}")


def _close_scaled(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _positives(n, r, b, seed):
    return make_random_triples(np.random.default_rng(seed), n, r, b,
                               unique=False).astype(np.int32)


# -- the device builders, bit-equal to the JAX in-jit builders -----------------


@pytest.mark.parametrize("tile_multiple", [1, 2, 4])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("n,r,b,tile,rb", [(50, 3, 90, 8, 16), (300, 6, 700, 16, 128)])
def test_build_edge_set_dynamic_bit_equal(tile_multiple, rate, n, r, b, tile, rb):
    pos = _positives(n, r, b, seed=n + b)
    keep = np.random.default_rng(tile_multiple).random(b) >= rate
    kw = dict(tile_multiple=tile_multiple, with_dst_layout=True, row_block=rb)
    want = jdyn.build_edge_set_dynamic(jnp.asarray(pos), n, r, tile,
                                       keep_mask=jnp.asarray(keep), **kw)
    got = tdyn.build_edge_set_dynamic(torch.from_numpy(pos), n, r, tile,
                                      keep_mask=torch.from_numpy(keep), **kw)
    _bits(got, want, EDGE_FIELDS, "edges")
    _bits(got.layout, want.layout, LAYOUT_FIELDS, "layout")
    _bits(got.reverse, want.reverse, EDGE_FIELDS, "reverse")
    _bits(got.reverse.layout, want.reverse.layout, LAYOUT_FIELDS, "reverse.layout")
    for f in ("num_nodes", "num_rels", "tile_size", "num_edges"):
        assert getattr(got, f) == getattr(want, f) == getattr(got.reverse, f)
    assert got.num_tiles % tile_multiple == 0
    if rate:
        assert (got.val == 0).sum() > (got.dst == n).sum()
    # the host builder of the port gives the same subgraph
    host = tdyn.build_edge_set_dynamic_host(pos, n, r, tile, keep_mask=keep,
                                            tile_multiple=tile_multiple)
    for f in EDGE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(host, f))


@pytest.mark.parametrize("with_src", [False, True])
@pytest.mark.parametrize("n,rb,chunk", [(60, 16, 32), (500, 128, 128)])
def test_build_dst_layout_dynamic_bit_equal(with_src, n, rb, chunk):
    es = jdyn.build_edge_set_dynamic(jnp.asarray(_positives(n, 4, 3 * n, seed=n)), n, 4,
                                     tile_size=16)
    dst, src = np.asarray(es.dst), np.asarray(es.src)
    want = jdyn.build_dst_layout_dynamic(es.dst, n, rb, chunk,
                                         src=es.src if with_src else None)
    got = tdyn.build_dst_layout_dynamic(torch.from_numpy(dst), n, rb, chunk,
                                        src=torch.from_numpy(src) if with_src else None)
    _bits(got, want, LAYOUT_FIELDS, "layout")
    assert (got.num_row_blocks, got.row_block, got.chunk) == \
        (want.num_row_blocks, want.row_block, want.chunk)
    assert got.num_edges == dst.shape[0]


@pytest.mark.parametrize("n,r,b,tile,rb", [(40, 3, 70, 8, 16), (200, 5, 400, 32, 64)])
def test_build_fused_layout_dynamic_bit_equal(n, r, b, tile, rb):
    pos = _positives(n, r, b, seed=b)
    keep = np.random.default_rng(1).random(b) < 0.6
    want = jdyn.build_edge_set_dynamic(jnp.asarray(pos), n, r, tile,
                                       keep_mask=jnp.asarray(keep), with_dst_layout=True,
                                       with_fused_layout=True, row_block=rb)
    got = tdyn.build_edge_set_dynamic(torch.from_numpy(pos), n, r, tile,
                                      keep_mask=torch.from_numpy(keep),
                                      with_dst_layout=True, with_fused_layout=True,
                                      row_block=rb)
    _bits(got.fused, want.fused, FUSED_FIELDS, "fused")
    _bits(got.reverse.fused, want.reverse.fused, FUSED_FIELDS, "reverse.fused")
    assert got.fused.num_rels == 2 * r and got.fused.quantum == min(16, tile)
    # the function alone, at another quantum, and K2's plain version over it
    alone = tfused.build_fused_layout_dynamic(got, row_block=rb, chunk=2 * tile, quantum=4)
    _bits(alone, jfused.build_fused_layout_dynamic(want, row_block=rb, chunk=2 * tile,
                                                   quantum=4), FUSED_FIELDS, "quantum 4")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2 * r, 6, 5)).astype(np.float32))
    ref = torch.zeros(n, 5).index_add_(
        0, got.dst.long().clamp_max(n - 1),
        torch.bmm(x[got.src.long()][:, None], w[got.rel.long()])[:, 0] * got.val[:, None])
    _close_scaled(tfused.rel_spmm_fused(alone, n, x, w, compute_dtype=None), ref)


def test_keep_masks_on_the_generators_device():
    g = torch.Generator().manual_seed(3)
    keep = tdyn.draw_keep_mask(g, 20_000, 0.5)
    assert keep.dtype == torch.float32 and set(keep.unique().tolist()) == {0.0, 1.0}
    assert abs(float(keep.mean()) - 0.5) < 0.02
    es = tdyn.build_edge_set_dynamic(torch.from_numpy(_positives(30, 2, 40, seed=2)), 30,
                                     2, 8, dropout_rate=0.5,
                                     generator=torch.Generator().manual_seed(4))
    again = tdyn.build_edge_set_dynamic(
        torch.from_numpy(_positives(30, 2, 40, seed=2)), 30, 2, 8,
        keep_mask=tdyn.draw_keep_mask(torch.Generator().manual_seed(4), 40, 0.5))
    assert torch.equal(es.val, again.val)
    m = tdyn.self_loop_keep_mask(torch.Generator().manual_seed(5), 5_000, 0.8)
    assert m.shape == (5_000, 1) and m.dtype == torch.float32
    assert abs(float(m.mean()) - 0.8) < 0.03
    assert torch.equal(tdyn.self_loop_keep_mask(None, 7, 0.8), torch.ones(7, 1))
    assert torch.equal(tdyn.self_loop_keep_mask(g, 7, 1.0), torch.ones(7, 1))


# -- negatives ------------------------------------------------------------------


def _jax_draws(key, bsz, n, ns, head_prob, dtype):
    """JAX's own corruptions and coins, as negative_sampling draws them."""
    k_ent, k_side = jax.random.split(key)
    ent = jax.random.randint(k_ent, (bsz * ns,), 0, n, dtype=dtype)
    head = jax.random.bernoulli(k_side, head_prob, (bsz * ns,))
    return np.asarray(ent), np.asarray(head)


@pytest.mark.parametrize("ns,head_prob", [(3, 0.5), (10, 0.2)])
def test_negative_assembly_matches_jax(ns, head_prob):
    n, bsz = 70, 33
    pos = _positives(n, 4, bsz, seed=ns)
    key = jax.random.key(ns)
    ent, head = _jax_draws(key, bsz, n, ns, head_prob, jnp.int32)
    want = np.asarray(jneg.negative_sampling(key, jnp.asarray(pos), n, ns, head_prob))
    got = tneg.assemble_negatives(torch.from_numpy(pos), torch.from_numpy(ent),
                                  torch.from_numpy(head))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    w_batch, w_labels = jneg.corrupt_batch(key, jnp.asarray(pos), n, ns, head_prob)
    g_batch, g_labels = tneg.assemble_batch(torch.from_numpy(pos), got)
    np.testing.assert_array_equal(g_batch.numpy(), np.asarray(w_batch))
    np.testing.assert_array_equal(g_labels.numpy(), np.asarray(w_labels))
    w_ent, w_head, w_lab = jneg.negative_structure(key, jnp.asarray(pos), n, ns, head_prob)
    np.testing.assert_array_equal(ent, np.asarray(w_ent))
    np.testing.assert_array_equal(head, np.asarray(w_head))


def test_equal_generators_equal_corruptions():
    n, ns, hp = 90, 5, 0.5
    pos = torch.from_numpy(_positives(n, 3, 41, seed=1)).long()

    def gen():
        return torch.Generator().manual_seed(17)

    ent, head, labels = tneg.negative_structure(gen(), pos, n, ns, hp)
    negs = tneg.negative_sampling(gen(), pos, n, ns, hp)
    batch, b_labels = tneg.corrupt_batch(gen(), pos, n, ns, hp)
    assert torch.equal(negs, tneg.assemble_negatives(pos, ent, head))
    assert torch.equal(batch, torch.cat([pos, negs])) and torch.equal(labels, b_labels)
    assert labels.shape == (41 * 6,) and labels[:41].eq(1).all() and labels[41:].eq(0).all()
    d_ent, d_head = tneg.draw_corruptions(gen(), pos, n, ns, hp)
    assert torch.equal(d_ent, ent) and torch.equal(d_head, head)
    # parent-major: the uncorrupted side is the parent's
    parent = pos.repeat_interleave(ns, 0)
    assert torch.equal(negs[:, 1], parent[:, 1])
    assert torch.equal(torch.where(head, negs[:, 2], negs[:, 0]),
                       torch.where(head, parent[:, 2], parent[:, 0]))
    with pytest.raises(ValueError, match="device"):
        tneg.draw_corruptions(gen(), pos.to("meta"), n, ns, hp)


@pytest.mark.parametrize("head_prob", [0.2, 0.5])
def test_negative_ranges_and_head_share(head_prob):
    n, bsz, ns = 1_000, 20_000, 10
    pos = torch.from_numpy(_positives(n, 5, bsz, seed=3)).long()
    ent, head = tneg.draw_corruptions(torch.Generator().manual_seed(1), pos, n, ns,
                                      head_prob)
    assert ent.dtype == torch.int64 and head.dtype == torch.bool
    assert int(ent.min()) == 0 and int(ent.max()) == n - 1
    assert abs(float(head.float().mean()) - head_prob) < 0.005
    counts = torch.bincount(ent, minlength=n).float()
    assert float(counts.std() / counts.mean()) < 0.1  # uniform: ~200 draws each


# -- the layout-free structured scores ------------------------------------------


@pytest.mark.parametrize("n,r,p,ns,d,pen", [(40, 3, 24, 3, 8, True), (90, 5, 50, 10, 16, False)])
def test_layout_free_structured_scores_match_jax(n, r, p, ns, d, pen):
    pos = _positives(n, r, p, seed=p)
    ent, head = _jax_draws(jax.random.key(p), p, n, ns, 0.5, jnp.int32)
    rng = np.random.default_rng(2)
    nodes = rng.standard_normal((n, d)).astype(np.float32)
    rels = rng.standard_normal((r, d)).astype(np.float32)
    total = p * (1 + ns)
    pw = np.full(total, 1.0 / total if pen else 0.0, np.float32)
    gs, gp = rng.standard_normal(total).astype(np.float32), np.float32(0.7)

    def f(nodes, rels):
        return jdm.distmult_structured_agg_ad(pos, head, ent, nodes, rels, pw, None)

    (ws, wp), vjp = jax.vjp(f, jnp.asarray(nodes), jnp.asarray(rels))
    wdn, wdr = vjp((jnp.asarray(gs), jnp.asarray(gp)))
    tn, tr = (torch.tensor(a, requires_grad=True) for a in (nodes, rels))
    s, pen_v = tdm.structured_scores(torch.from_numpy(pos), torch.from_numpy(head),
                                     torch.from_numpy(ent), tn, tr, torch.from_numpy(pw),
                                     None)
    # the layout path's forward, bit for bit (JAX's promise for its own)
    lays = tdm.build_structured_layouts(pos, ent, head, n, row_block=16, chunk=32)
    lays = (*(lay.to("cpu") for lay in lays[:3]), tuple(torch.from_numpy(a)
                                                         for a in lays[3]))
    with_lays = tdm.structured_scores(torch.from_numpy(pos), torch.from_numpy(head),
                                      torch.from_numpy(ent), tn, tr, torch.from_numpy(pw),
                                      lays)
    assert torch.equal(s, with_lays[0]) and torch.equal(pen_v, with_lays[1])
    # against JAX: XLA and torch add a row's d products (and the penalty's
    # rows) in other orders
    _close_scaled(s.detach(), ws)
    np.testing.assert_allclose(pen_v.detach().numpy(), np.asarray(wp), rtol=1e-6)
    torch.autograd.backward([s, pen_v], [torch.from_numpy(gs), torch.tensor(gp)])
    _close_scaled(tn.grad, wdn)
    _close_scaled(tr.grad, wdr)


# -- the trainer's device path ------------------------------------------------------


CFGS = {"lp-WN18": os.path.join(ROOT, "configs", "rgcn", "lp-WN18.yaml"),
        "lp-FB-toy": os.path.join(ROOT, "configs", "rgcn", "lp-FB-toy.yaml"),
        "c-rgcn-lp-WN18": os.path.join(ROOT, "configs", "c-rgcn", "lp-WN18.yaml")}


def _narrow_cfg(load, name, epochs=4, self_loop=0.0):
    cfg = load(CFGS[name])
    enc = cfg.encoder
    decomp = enc.decomposition
    if decomp is not None and decomp.type == "block":
        decomp = dataclasses.replace(decomp, num_blocks=2)
    enc = dataclasses.replace(
        enc, node_embedding=8, hidden1_size=4 if enc.model == "c-rgcn" else 8,
        decomposition=decomp,
        edge_dropout=dataclasses.replace(enc.edge_dropout, general=0.5,
                                         self_loop=self_loop))
    tr = cfg.training
    tr = dataclasses.replace(
        tr, epochs=epochs, graph_batch_size=48 if tr.graph_batch_size else None,
        negative_sampling=dataclasses.replace(tr.negative_sampling, sampling_rate=3))
    ev = dataclasses.replace(cfg.evaluation, check_every=2, batch_size=16, verbose=False)
    return dataclasses.replace(cfg, encoder=enc, training=tr, evaluation=ev)


def _jax_init(jcfg, n, r, pos, tile):
    params = j_build_lp(jcfg, n, r).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jdyn.build_edge_set_dynamic(jnp.asarray(pos), n, r, tile_size=tile),
        jnp.asarray(pos))
    return jax.tree_util.tree_map(np.asarray, params)


def _biased(cfg):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                bias_init="zeros"))


@pytest.mark.parametrize("name", ["lp-WN18", "lp-FB-toy", "c-rgcn-lp-WN18",
                                  "lp-WN18-biased"])
def test_device_step_matches_jax_model(name):
    """The structured configs score layout-free; a biased decoder scores
    the assembled batch without layouts (the JAX step's else branch)."""
    n, r, tile = 60, 3, 8
    biased = name.endswith("-biased")
    name = name.removesuffix("-biased")
    cfg, jcfg = _narrow_cfg(load_experiment, name), _narrow_cfg(j_load, name)
    if biased:
        cfg, jcfg = _biased(cfg), _biased(jcfg)
    d = synthetic_link_prediction(num_nodes=n, num_rels=r, num_edges=200)
    trainer = LinkPredictionTrainer(cfg, d, device="cpu", tile_size=tile,
                                    host_graph_build=False)
    pos = trainer.positives(1).astype(np.int32)
    params = _jax_init(jcfg, n, r, pos, tile)
    trainer.model.load_state_dict(from_jax_params(params))
    model = j_build_lp(jcfg, n, r)

    # the draws: a keep mask, and JAX's own negatives
    keep = np.random.default_rng(7).random(len(pos)) < 0.5
    ns, hp = cfg.training.negative_sampling.sampling_rate, 0.5
    key = jax.random.key(9)
    ce, ch, labels = jneg.negative_structure(key, jnp.asarray(pos), n, ns, hp)
    batch, _ = jneg.corrupt_batch(key, jnp.asarray(pos), n, ns, hp)  # the same draws
    jedges = jdyn.build_edge_set_dynamic(jnp.asarray(pos), n, r, tile,
                                         keep_mask=jnp.asarray(keep), with_dst_layout=True,
                                         row_block=trainer.device_row_block)
    total = labels.shape[0]
    pw = jnp.full((total,), 1.0 / total, jnp.float32)

    def loss_fn(p):
        if biased:
            scores, penalty = model.apply(p, jedges, batch)
        else:
            scores, penalty = model.apply(p, jedges, jnp.asarray(pos), ch, ce, pw, None,
                                          method=model.structured_scores)
        return (optax.sigmoid_binary_cross_entropy(scores, labels).mean()
                + cfg.decoder.l2_penalty * penalty)

    j_loss, j_grads = jax.value_and_grad(loss_fn)(params)
    draws = EpochDraws(torch.from_numpy(pos).long(), torch.from_numpy(keep).float(),
                       torch.from_numpy(np.asarray(ce)).long(),
                       torch.from_numpy(np.asarray(ch)), None)
    trainer.batch = trainer.build_epoch(draws)
    b = trainer.batch
    assert b.layouts is None and b.batch_layouts is None
    if biased:
        np.testing.assert_array_equal(b.batch.numpy(), np.asarray(batch))
    else:
        assert b.batch is None
    _bits(b.edges, jedges, EDGE_FIELDS, "edges")
    _bits(b.edges.layout, jedges.layout, LAYOUT_FIELDS, "layout")
    _bits(b.edges.reverse.layout, jedges.reverse.layout, LAYOUT_FIELDS, "reverse.layout")
    np.testing.assert_array_equal(b.labels.numpy(), np.asarray(labels))
    loss = trainer.loss()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    for key, param in trainer.model.named_parameters():
        _close_scaled(param.grad, want[key], key)


def test_device_epochs_draw_from_their_streams():
    cfg = _narrow_cfg(load_experiment, "lp-WN18", self_loop=0.2)
    d = synthetic_link_prediction(num_nodes=50, num_rels=3, num_edges=160)
    trainer = LinkPredictionTrainer(cfg, d, device="cpu", tile_size=8,
                                    host_graph_build=False)
    pos = torch.as_tensor(trainer.positives(3))
    a, b = trainer.draw_epoch(3, pos), trainer.draw_epoch(3, pos)
    c = trainer.draw_epoch(4, pos)
    for f in ("keep", "corrupt_ent", "corrupt_head"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert not torch.equal(getattr(a, f), getattr(c, f)), f
    assert len(a.self_masks) == 1 and a.self_masks[0].dtype == torch.bool
    assert a.self_masks[0].shape == (50, 8) and torch.equal(a.self_masks[0], b.self_masks[0])
    g = epoch_generator(0, 3, 7, "cpu")
    assert torch.equal(a.keep, tdyn.draw_keep_mask(g, len(pos), 0.5))
    g = epoch_generator(0, 3, 11, "cpu")
    ent, head = tneg.draw_corruptions(g, pos.long(), 50, 3, 0.5)
    assert torch.equal(ent, a.corrupt_ent) and torch.equal(head, a.corrupt_head)
    batch = trainer.build_epoch(a)
    assert batch.edges.layout.chunk == 8
    assert batch.edges.layout.row_block == trainer.device_row_block
    assert trainer.host_graph_build is False
    assert LinkPredictionTrainer(cfg, d, device="cpu").host_graph_build is True


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_device_path_resume_equals_unbroken_run(tmp_path):
    from rgcn_tpu_torch import native

    cfg = _narrow_cfg(load_experiment, "lp-WN18", epochs=4, self_loop=0.2)
    d = synthetic_link_prediction(num_nodes=50, num_rels=3, num_edges=160)

    def run(tag, max_epochs, ck):
        logger = ScalarLogger(run_dir=str(tmp_path / tag), verbose=False)
        t = LinkPredictionTrainer(cfg, d, device="cpu", tile_size=8,
                                  checkpoint_dir=str(tmp_path / ck), checkpoint_every=2,
                                  max_epochs=max_epochs, host_graph_build=False)
        native.reset_calls()  # after the evaluation graph's build
        out = t.fit(logger)
        assert not any(native.CALLS.values()), native.CALLS
        logger.close()
        return out, t.model.state_dict()

    (mrr, _, ranks), state = run("whole", None, "ck_whole")
    run("broken", 2, "ck_broken")
    (mrr2, _, ranks2), state2 = run("resumed", None, "ck_broken")
    losses = [x["value"] for x in _records(tmp_path / "whole")
              if x["metric"] == "training.loss"]
    resumed = [x["value"] for x in _records(tmp_path / "broken") + _records(
        tmp_path / "resumed") if x["metric"] == "training.loss"]
    assert len(losses) == 4 and losses == resumed
    assert mrr == mrr2 and np.array_equal(ranks, ranks2)
    for k, v in state.items():
        assert torch.equal(v, state2[k]), k


# -- the sharded step ------------------------------------------------------------------


def _sharded_rank(dev, cfg, num_nodes, num_rels, init, positives, seed):
    from rgcn_tpu_torch.dist.multihost import make_mesh_2d
    from rgcn_tpu_torch.dist.train import make_sharded_lp_step
    from rgcn_tpu_torch.models.link_prediction import build_lp_model
    from rgcn_tpu_torch.train.optim import make_optimizer

    mesh = make_mesh_2d(1, 2, device=dev)
    model = build_lp_model(cfg, num_nodes, num_rels, group=mesh.group,
                           decoder_group=mesh.decoder_group)
    model.load_state_dict(init)
    step = make_sharded_lp_step(
        model, make_optimizer(model.parameters(), "sgd", 0.01),
        mesh, num_nodes, num_rels, 8, cfg.training.negative_sampling.sampling_rate, 0.5,
        general_dropout=cfg.encoder.edge_dropout.general,
        decoder_l2_weight=cfg.decoder.l2_penalty, row_block=16)
    out = {}
    for epoch, pos in positives.items():
        gens = [epoch_generator(seed, epoch, s, dev) for s in (7, 11, 13)]
        loss = step(torch.as_tensor(pos).to(dev), gens)
        out[epoch] = {"loss": loss, **{k: v.clone() for k, v in model.state_dict().items()},
                      **{f"grad.{k}": p.grad.clone() for k, p in model.named_parameters()}}
    return out


def test_sharded_lp_step_matches_device_path():
    """Two SGD steps (lr 0.01; Adam would turn the reassociation of
    gradient entries near 0 into parameter differences up to its
    learning rate): the keep mask, the negatives and the Schlichtkrull
    self-loop masks from the same streams on both; gradients and
    parameters compared."""
    from rgcn_tpu_torch.dist.multihost import same_on_every_rank, spawn
    from rgcn_tpu_torch.train.optim import make_optimizer

    cfg = _narrow_cfg(load_experiment, "lp-WN18", self_loop=0.2)
    d = synthetic_link_prediction(num_nodes=50, num_rels=3, num_edges=160)
    trainer = LinkPredictionTrainer(cfg, d, device="cpu", tile_size=8,
                                    host_graph_build=False)
    trainer.optimizer = make_optimizer(trainer.model.parameters(), "sgd", 0.01)
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    positives = {e: trainer.positives(e) for e in (1, 2)}
    ranks = spawn(_sharded_rank, 2, (cfg, d.num_nodes, d.num_relations, init,
                                     positives, 0), device="cpu", num_threads=1)
    assert same_on_every_rank(ranks) == 0.0
    for epoch, got in ranks[0].items():
        trainer.set_epoch(epoch)
        loss = trainer.step()
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        for k, v in trainer.model.state_dict().items():
            _close_scaled(got[k], v, f"epoch {epoch} {k}")
        for k, p in trainer.model.named_parameters():
            _close_scaled(got[f"grad.{k}"], p.grad, f"epoch {epoch} grad {k}")
