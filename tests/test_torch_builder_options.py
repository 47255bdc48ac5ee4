"""The host builders' geometry options, and the layer, initializer and
evaluation options, in the port against the JAX package on the CPU.

Each builder option is held bit-equal to the JAX builder (numpy there,
the port's numpy and native paths here): ``build_edge_set(add_inverses=
False, layout_chunk=)``, ``build_edge_set_native(layout_chunk=)``,
``edge_normalization(mask=)``, ``build_merged_layout(max_rels=, pad_to=,
rev_pad_to=)``, ``auto_layout_row_block(max_row_block=)``,
``build_dst_layout(src=)`` and ``build_structured_layouts(sorted_corrupt=
False, p_row_block=, p_chunk=)``. Then ``RGCNConv(use_bias=False)``
against the flax layer, the initializers' ``gain`` (ignored by the
standard ones, as in JAX) and ``fan_shape``, ``LinkPredictor(
feature_blocks=True)``'s per-block draws, and ``ranks_from_scores(
valid=)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.graph import coalesce as jco
from rgcn_tpu.graph import dynamic as jdyn
from rgcn_tpu.graph import structure as jstruct
from rgcn_tpu.models.link_prediction import LinkPredictor as JLinkPredictor
from rgcn_tpu.nn import init as jinit
from rgcn_tpu.nn.layers import RGCNConv as JConv
from rgcn_tpu.ops import pallas_aggregate as jagg
from rgcn_tpu.ops import pallas_distmult as jdm
from rgcn_tpu.train import evaluate as jev
from rgcn_tpu_torch.graph import coalesce as tco
from rgcn_tpu_torch.graph import dynamic as tdyn
from rgcn_tpu_torch.graph import structure as tstruct
from rgcn_tpu_torch.graph.native import build_edge_set_native
from rgcn_tpu_torch.models.link_prediction import (
    CompressionRelationPredictor,
    LinkPredictor,
)
from rgcn_tpu_torch.nn import init as tinit
from rgcn_tpu_torch.nn.layers import RGCNConv
from rgcn_tpu_torch.ops import aggregate as tagg
from rgcn_tpu_torch.ops import distmult_train as tdm
from rgcn_tpu_torch.train import evaluate as tev
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

EDGE_FIELDS = ["src", "dst", "rel", "val", "tile_rel"]
EDGE_META = ["num_nodes", "num_rels", "tile_size", "num_edges", "num_tiles"]
LAYOUT_FIELDS = ["perm", "local_dst", "chunk_block"]
LAYOUT_META = ["num_row_blocks", "row_block", "chunk", "num_chunks"]
FUSED_FIELDS = ["src", "val", "local_dst", "quantum_rel", "chunk_block"]


def _same(got, want, fields, what):
    for f in fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f"{what}.{f}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")


def _meta(got, want, fields, what):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f"{what}.{f}"


def _same_layout(got, want, what):
    _same(got, want, LAYOUT_FIELDS, what)
    _meta(got, want, LAYOUT_META, what)


def _same_edge_set(got, want, what="es"):
    _same(got, want, EDGE_FIELDS, what)
    _meta(got, want, EDGE_META, what)
    for part in ("layout", "reverse", "fused"):
        assert (getattr(got, part) is None) == (getattr(want, part) is None), part
    if want.layout is not None:
        _same_layout(got.layout, want.layout, f"{what}.layout")
        _same(got.fused, want.fused, FUSED_FIELDS, f"{what}.fused")
        _same(got.reverse, want.reverse, EDGE_FIELDS, f"{what}.reverse")
        _same_layout(got.reverse.layout, want.reverse.layout, f"{what}.reverse.layout")


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("kw", [dict(add_inverses=False), dict(layout_chunk=64),
                                dict(add_inverses=False, layout_chunk=32, tile_size=16)],
                         ids=["no_inverses", "chunk64", "no_inverses_chunk32"])
def test_build_edge_set_geometry(native, kw):
    rng = np.random.default_rng(11)
    t = make_random_triples(rng, 400, 5, 2500)
    want = jstruct.build_edge_set(t, 400, 5, with_dst_layout=True, prefer_native=False, **kw)
    got = tstruct.build_edge_set(t, 400, 5, with_dst_layout=True, prefer_native=native, **kw)
    _same_edge_set(got, want)
    if "layout_chunk" in kw:
        assert got.layout.chunk == kw["layout_chunk"]
    if kw.get("add_inverses") is False:
        assert got.num_rels == 5


def test_build_edge_set_native_layout_chunk():
    rng = np.random.default_rng(12)
    t = make_random_triples(rng, 300, 4, 1500)
    want = jstruct.build_edge_set(t, 300, 4, with_dst_layout=True, prefer_native=False,
                                  layout_row_block=64, layout_chunk=32)
    got = build_edge_set_native(t, 300, 4, with_dst_layout=True, layout_row_block=64,
                                layout_chunk=32)
    _same_edge_set(got, want)


@pytest.mark.parametrize("keep", [1.0, 0.7, 0.0])
def test_edge_normalization_mask(keep):
    rng = np.random.default_rng(13)
    rel = rng.integers(0, 6, 3000)
    dst = rng.integers(0, 200, 3000)
    mask = (rng.random(3000) < keep).astype(np.float32)
    got = tstruct.edge_normalization(rel, dst, 200, mask=mask)
    want = jstruct.edge_normalization(rel, dst, 200, mask=mask)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tstruct.edge_normalization(rel, dst, 200),
                                  jstruct.edge_normalization(rel, dst, 200))


def test_build_merged_layout_geometry():
    rng = np.random.default_rng(14)
    t = make_random_triples(rng, 500, 6, 3000)
    es = tstruct.build_edge_set(t, 500, 6)
    args = (es.dst, es.src, es.rel, es.val, 500, es.num_rels)
    base = tco.build_merged_layout(*args, chunk=64)
    pad, rev_pad = base.layout.perm.shape[0] + 128, base.rev_layout.perm.shape[0] + 64
    kw = dict(chunk=64, pad_to=pad, rev_pad_to=rev_pad, max_rels=es.num_rels, dedup_k=2)
    got = tco.build_merged_layout(*args, **kw)
    want = jco.build_merged_layout(*args, **kw)
    assert got.layout.perm.shape[0] == pad and got.rev_layout.perm.shape[0] == rev_pad
    for f in ("src_sorted", "coeff", "rev_src_sorted", "rev_receiver", "rev_coeff"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)
    _same_layout(got.layout, want.layout, "layout")
    _same_layout(got.rev_layout, want.rev_layout, "rev_layout")
    for f in ("src_sorted", "local_k", "coeff_k", "chunk_block"):
        np.testing.assert_array_equal(getattr(got.fwd_dedup, f),
                                      np.asarray(getattr(want.fwd_dedup, f)), f)
    for build in (tco.build_merged_layout, jco.build_merged_layout):
        with pytest.raises(ValueError, match="num_rels <= 8"):
            build(*args, max_rels=8)


@pytest.mark.parametrize("max_row_block", [128, 256, 512, 2048, 8192])
def test_auto_layout_row_block_cap(max_row_block):
    for n, e in ((40_000, 60_000), (1_000_000, 100_000), (300, 5000), (2_000_000, 10)):
        assert tdyn.auto_layout_row_block(n, e, max_row_block=max_row_block) \
            == jdyn.auto_layout_row_block(n, e, max_row_block=max_row_block)


@pytest.mark.parametrize("pad", [False, True])
def test_build_dst_layout_src_order(pad):
    rng = np.random.default_rng(15)
    dst = np.concatenate([rng.integers(0, 700, 4000), np.full(200, 700)])  # pads
    src = rng.integers(0, 700, dst.shape[0])
    kw = dict(row_block=128, chunk=64, src=src)
    if pad:
        kw["pad_to"] = tagg.build_dst_layout(dst, 700, 128, 64, src=src).perm.shape[0] + 128
    got = tagg.build_dst_layout(dst, 700, **kw)
    want = jagg.build_dst_layout(dst, 700, prefer_native=False, **kw)
    _same_layout(got, want, "src-ordered layout")
    # the slots of a row block run in source order, and K1's plain sum is
    # the destination-sorted layout's
    msgs = torch.from_numpy(rng.standard_normal((dst.shape[0], 4)).astype(np.float32))
    np.testing.assert_allclose(
        tagg.aggregate_sorted(msgs, got.to("cpu"), 700).numpy(),
        tagg.aggregate_sorted(msgs, tagg.build_dst_layout(dst, 700, 128, 64).to("cpu"),
                              700).numpy(),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("geometry", [dict(), dict(p_row_block=256, p_chunk=32)],
                         ids=["default", "p_geometry"])
def test_build_structured_layouts_forms(geometry):
    rng = np.random.default_rng(16)
    n, p, ns = 900, 120, 4
    pos = np.stack([rng.integers(0, n, p), rng.integers(0, 7, p), rng.integers(0, n, p)], 1)
    ce = rng.integers(0, n, p * ns)
    ch = rng.random(p * ns) < 0.5
    want = jdm.build_structured_layouts(pos, ce, n, row_block=128, chunk=64, **geometry)
    got = tdm.build_structured_layouts(pos, ce, None, n, row_block=128, chunk=64,
                                       sorted_corrupt=False, **geometry)
    assert len(got) == len(want) == 3
    for g, w, what in zip(got, want, ("corrupt", "subjects", "objects")):
        _same_layout(g, w, what)
    if geometry:
        assert got[1].row_block == 256 and got[1].chunk == 32 and got[0].chunk == 64
    want = jdm.build_structured_layouts(pos, ce, n, row_block=128, chunk=64,
                                        sorted_corrupt=True, corrupt_head=ch, **geometry)
    got = tdm.build_structured_layouts(pos, ce, ch, n, row_block=128, chunk=64, **geometry)
    for g, w in zip(got[:3], want[:3]):
        _same_layout(g, w, "sorted form")
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="corrupt_head"):
        tdm.build_structured_layouts(pos, ce, None, n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("use_bias", [False, True])
def test_rgcn_conv_use_bias(use_bias):
    rng = np.random.default_rng(17)
    t = make_random_triples(rng, 80, 3, 300)
    jes = jstruct.build_edge_set(t, 80, 3, prefer_native=False)
    tes = tstruct.build_edge_set(t, 80, 3).to("cpu")
    jconv = JConv(num_nodes=80, num_relations=7, in_features=6, out_features=5,
                  use_bias=use_bias)
    tconv = RGCNConv(80, 7, 5, in_features=6, use_bias=use_bias)
    x = rng.standard_normal((80, 6)).astype(np.float32)
    params = _np_tree(jconv.init(jax.random.key(1), jes, jnp.asarray(x)))
    assert ("bias" in params["params"]) == use_bias
    assert (tconv.bias is not None) == use_bias
    state = {k.split(".", 1)[1]: v for k, v in from_jax_params(
        {"params": {"c": params["params"]}}).items()}
    tconv.load_state_dict(state)
    np.testing.assert_allclose(
        tconv(tes, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jconv.apply(params, jes, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_standard_initializers_ignore_gain():
    for init in (tinit.standard_normal, tinit.standard_uniform):
        a = init((50, 7), torch.Generator().manual_seed(3))
        b = init((50, 7), torch.Generator().manual_seed(3), gain=5.0)
        assert torch.equal(a, b)
    key = jax.random.key(3)
    for init in (jinit.standard_normal, jinit.standard_uniform):
        np.testing.assert_array_equal(np.asarray(init()(key, (50, 7))),
                                      np.asarray(init(5.0)(key, (50, 7))))


@pytest.mark.parametrize("name", ["schlichtkrull-normal", "schlichtkrull-uniform"])
def test_select_weight_init_fan_shape(name):
    """The std comes from fan_shape, not the drawn shape, on both sides:
    each draw divided by its unit draw gives the same scale."""
    shape, fan = (40, 2, 5, 5), (3, 5)
    g = tinit.select_weight_init(name, 1.5, fan_shape=fan)(shape, torch.Generator().manual_seed(4))
    unit = tinit.select_weight_init(name, 1.0)(shape, torch.Generator().manual_seed(4))
    own = tinit.select_weight_init(name, 1.5)(shape, torch.Generator().manual_seed(4))
    key = jax.random.key(4)
    jg = np.asarray(jinit.select_weight_init(name, 1.5, fan_shape=fan)(key, shape))
    junit = np.asarray(jinit.select_weight_init(name, 1.0)(key, shape))
    port_scale = float((g / unit).mean())
    jax_scale = float((jg / junit).mean())
    assert abs(port_scale - jax_scale) <= 1e-5 * jax_scale
    assert abs(float((own / unit).mean()) - port_scale) > 0.01  # fan_shape took effect


def test_link_predictor_feature_blocks():
    """feature_blocks draws the embeddings per <=128-column block at each
    block's shape, as the JAX model's emb_blocks (glorot-normal: the std
    follows the block's fans); one table in the port, and c-RGCN ignores
    the option, as JAX's does."""
    n, emb = 3000, 200
    blocked = LinkPredictor(n, 4, emb, weight_init="glorot-normal", feature_blocks=True)
    plain = LinkPredictor(n, 4, emb, weight_init="glorot-normal")
    jm = JLinkPredictor(num_nodes=n, num_relations=4, emb_dim=emb, weight_init="glorot-normal",
                        feature_blocks=True)
    jp = jm.init(jax.random.key(0), method=lambda m: m.emb_blocks)["params"]
    widths = [np.asarray(jp[f"node_embeddings_block{i}"]).shape[1] for i in range(2)]
    assert widths == [128, 72]
    e = blocked.node_embeddings.detach().numpy()
    assert e.shape == (n, emb)
    for i, (lo, w) in enumerate(((0, 128), (128, 72))):
        want = float(np.sqrt(2.0 / (n + w)))  # glorot-normal over (N, w)
        assert abs(float(e[:, lo:lo + w].std()) - want) <= 0.01 * want
        assert abs(float(np.asarray(jp[f"node_embeddings_block{i}"]).std()) - want) <= 0.01 * want
    # the one table's std follows (N, 200): another scale
    single = float(np.sqrt(2.0 / (n + emb)))
    assert abs(float(plain.node_embeddings.detach().std()) - single) <= 0.01 * single
    assert torch.equal(
        CompressionRelationPredictor(60, 4, 16, hidden1_size=8, feature_blocks=True,
                                     seed=3).node_embeddings,
        CompressionRelationPredictor(60, 4, 16, hidden1_size=8, seed=3).node_embeddings)


def test_ranks_from_scores_valid():
    rng = np.random.default_rng(18)
    scores = rng.standard_normal((6, 30)).astype(np.float32)
    scores[:, 3] = scores[:, 4]  # ties
    targets = rng.integers(0, 30, 6)
    filters = np.stack([rng.integers(0, 31, 5) for _ in range(6)])  # 30 = pad
    valid = np.array([True, True, False, True, False, True])
    want = jev.ranks_from_scores(jnp.asarray(scores), jnp.asarray(targets),
                                 jnp.asarray(filters), jnp.asarray(valid))
    got = tev.ranks_from_scores(torch.from_numpy(scores), torch.from_numpy(targets),
                                torch.from_numpy(filters), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[~valid] == 0).all()
    full = tev.ranks_from_scores(torch.from_numpy(scores), torch.from_numpy(targets),
                                 torch.from_numpy(filters))
    np.testing.assert_array_equal(full.numpy()[valid], got.numpy()[valid])
