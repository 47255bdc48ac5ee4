"""The port's block-decomposition path (lp-FB-toy) against the JAX package.

Inputs come from numpy with fixed seeds; parameters are drawn by flax and
carried with ``from_jax_params`` (or set directly for one layer). Small
graphs run the JAX layer with ``backend="pallas"`` over an EdgeSet without
its fused layout, so its K3 + K1 route runs (Pallas in interpret mode) and
the port takes K3's and K1's plain versions on CPU tensors; the full
``fb_toy_like()`` graph at width 500 and 100 blocks runs the JAX model's
XLA path (blockwise messages) against the port's expanded-weight route.
Tolerance: atol 1e-5·max(1, max|ref|), f32 sums taken in another order.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.config import load_experiment as j_load
from rgcn_tpu.data.synthetic import fb_toy_like as j_fb_toy
from rgcn_tpu.data.synthetic import synthetic_link_prediction as j_synth_lp
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.nn import init as j_init
from rgcn_tpu.nn.layers import RGCNConv as JConv
from rgcn_tpu.ops.spmm import rel_spmm_block as j_rel_spmm_block
from rgcn_tpu.train.link_prediction import build_lp_model as j_build_lp
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import fb_toy_like, synthetic_link_prediction
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.models.link_prediction import build_lp_model
from rgcn_tpu_torch.nn import init as rinit
from rgcn_tpu_torch.nn import layers
from rgcn_tpu_torch.nn.layers import RGCNConv, expand_blocks
from rgcn_tpu_torch.ops import spmm as spmm_ops
from rgcn_tpu_torch.ops.aggregate import aggregate_sorted
from rgcn_tpu_torch.serve import load_lp_server
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FB_CFG = os.path.join(ROOT, "configs", "rgcn", "lp-FB-toy.yaml")


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("block_size", [1, 7, 64, 120])
def test_pad_nodes_matches_jax(block_size):
    data = synthetic_link_prediction(num_nodes=113, num_rels=3, num_edges=300)
    jdata = j_synth_lp(num_nodes=113, num_rels=3, num_edges=300)
    added = data.pad_nodes(block_size)
    assert added == jdata.pad_nodes(block_size)
    assert data.num_nodes % block_size == 0 and data.num_nodes == 113 + added
    assert data.i2n == jdata.i2n and data.n2i == jdata.n2i
    assert data.pad_nodes(block_size) == 0


@pytest.mark.parametrize("which", ["normal", "uniform"])
def test_schlichtkrull_fan_shape(which):
    """The std is gain·3/sqrt(a + b) of fan_shape (a, b), not of the shape
    drawn; without fan_shape the shape's first two entries count."""
    fn = getattr(rinit, f"schlichtkrull_{which}")
    gen = torch.Generator().manual_seed(0)
    shape, fan, gain = (224, 100, 5, 5), (112, 5), 1.5
    w = fn(shape, gen, gain, fan_shape=fan)
    std = gain * 3.0 / np.sqrt(112 + 5)
    assert w.shape == shape
    assert std == pytest.approx(j_init.schlichtkrull_std(fan, gain))
    if which == "normal":
        assert w.std().item() == pytest.approx(std, rel=0.01)
    else:  # U(-std, std): its std is std / sqrt(3)
        assert w.abs().max().item() <= std
        assert w.std().item() == pytest.approx(std / np.sqrt(3), rel=0.01)
    plain = fn((30, 70), gen, 1.0)
    bound = 3.0 / np.sqrt(100)
    assert (plain.std().item() == pytest.approx(bound, rel=0.05) if which == "normal"
            else plain.abs().max().item() <= bound)


def _graph(n, r, e, seed, tile):
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    jes = j_build(t, n, r, tile_size=tile, with_dst_layout=True, prefer_native=False)
    tes = build_edge_set(t, n, r, tile_size=tile, with_dst_layout=True).to("cpu")
    return rng, jes, tes


@pytest.mark.parametrize("nb,ib,ob", [(4, 3, 2), (5, 5, 5), (1, 6, 4)])
def test_rel_spmm_block_matches_jax(nb, ib, ob):
    rng, jes, tes = _graph(90, 4, 500, nb, 16)
    x = rng.standard_normal((90, nb * ib)).astype(np.float32)
    blocks = rng.standard_normal((8, nb, ib, ob)).astype(np.float32)
    want = np.asarray(j_rel_spmm_block(jes, jnp.asarray(x), jnp.asarray(blocks)))
    xt, bt = torch.from_numpy(x), torch.from_numpy(blocks)
    got = spmm_ops.rel_spmm_block(tes, xt, bt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))
    k1 = spmm_ops.rel_spmm_block(
        tes, xt, bt,
        aggregate=lambda m, e: aggregate_sorted(m, e.layout, e.num_nodes)).numpy()
    np.testing.assert_allclose(k1, want, rtol=0, atol=_tol(want))
    # the expansion is the block-diagonal matrix of each relation's blocks
    w = expand_blocks(bt).numpy()
    for rel in (0, 7):
        dense = np.zeros((nb * ib, nb * ob), np.float32)
        for b in range(nb):
            dense[b * ib:(b + 1) * ib, b * ob:(b + 1) * ob] = blocks[rel, b]
        np.testing.assert_array_equal(w[rel], dense)


@pytest.mark.parametrize("separate_self_weight", [True, False])
def test_block_conv_matches_jax_pallas(separate_self_weight):
    """Both parameter layouts; the JAX layer through Pallas K3 + K1 over
    the EdgeSet without its fused layout, the port through the expansion
    and K3's and K1's plain versions (with and without the fused layout,
    which the port's shared-memory rule may take for a W this small)."""
    n, r, din, dout, nb = 64, 3, 12, 8, 4
    rng, jes, tes = _graph(n, r, 400, 11, 16)
    kw = dict(num_nodes=n, num_relations=2 * r + 1, out_features=dout,
              in_features=din, decomposition="block", num_blocks=nb,
              separate_self_weight=separate_self_weight,
              weight_init="glorot-uniform", bias_init="normal")
    jconv = JConv(backend="pallas", **kw)
    jes = dataclasses.replace(jes, fused=None)
    x = np.maximum(rng.standard_normal((n, din)), 0).astype(np.float32)
    params = jconv.init(jax.random.key(3), jes, jnp.asarray(x))
    want = np.asarray(jconv.apply(params, jes, jnp.asarray(x)))
    leaves = _np_tree(params)["params"]
    assert set(leaves) == ({"blocks", "self_weight", "bias"} if separate_self_weight
                           else {"blocks", "bias"})
    conv = RGCNConv(**kw)
    conv.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in leaves.items()})
    with torch.inference_mode():
        for edges in (dataclasses.replace(tes, fused=None), tes):
            got = conv(edges, torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


def test_block_errors_match_jax():
    """The divisibility ValueError and the featureless NotImplementedError,
    worded as in the JAX layer."""
    jes = j_build(np.array([[0, 0, 1]]), 10, 1, tile_size=8, prefer_native=False)
    cases = [
        (dict(in_features=10, out_features=8, num_blocks=4), ValueError),
        (dict(in_features=12, out_features=8, num_blocks=0), ValueError),
        (dict(in_features=None, out_features=10, num_blocks=5), NotImplementedError),
    ]
    for kw, exc in cases:
        jconv = JConv(num_nodes=10, num_relations=3, decomposition="block", **kw)
        x = None if kw["in_features"] is None else jnp.ones((10, kw["in_features"]))
        with pytest.raises(exc) as jerr:
            jconv.init(jax.random.key(0), jes, x)
        with pytest.raises(exc) as terr:
            RGCNConv(10, 3, decomposition="block", **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match=r"dims \(10, 8\) divisible by num_blocks \(4\)"):
        RGCNConv(10, 3, 8, in_features=10, decomposition="block", num_blocks=4)


@pytest.mark.parametrize("over_cap", [False, True])
def test_block_route_by_expansion_cap(monkeypatch, over_cap):
    """At or under _BLOCK_EXPAND_MAX_ELEMS the blocks are expanded and go
    through rel_spmm_ad; above it through rel_spmm_block with K1
    as the aggregation. Both give the same output."""
    n, r, din, dout, nb = 50, 2, 10, 10, 5
    _, _, tes = _graph(n, r, 300, 5, 16)
    conv = RGCNConv(n, 2 * r + 1, dout, in_features=din, decomposition="block",
                    num_blocks=nb, separate_self_weight=True)
    x = torch.relu(torch.randn((n, din), generator=torch.Generator().manual_seed(1)))
    with torch.inference_mode():
        want = conv(dataclasses.replace(tes, layout=None), x)
    elems = 2 * r * din * dout
    monkeypatch.setattr(RGCNConv, "_BLOCK_EXPAND_MAX_ELEMS", elems - 1 if over_cap else elems)
    calls = []
    fwd_ad, blockwise = layers.rel_spmm_ad, spmm_ops.rel_spmm_block
    monkeypatch.setattr(layers, "rel_spmm_ad",
                        lambda *a, **k: calls.append("expand") or fwd_ad(*a, **k))
    monkeypatch.setattr(spmm_ops, "rel_spmm_block",
                        lambda *a, **k: calls.append(("block", k["aggregate"]))
                        or blockwise(*a, **k))
    with torch.inference_mode():
        got = conv(tes, x)
    assert calls == ([("block", layers._aggregate_k1)] if over_cap else ["expand"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=_tol(want.numpy()))


def test_expansion_cap_is_the_jax_value():
    assert RGCNConv._BLOCK_EXPAND_MAX_ELEMS == JConv._BLOCK_EXPAND_MAX_ELEMS == 64_000_000
    # lp-FB-toy: 224 relations of 500 x 500 are expanded (56M elements)
    assert 224 * 500 * 500 <= RGCNConv._BLOCK_EXPAND_MAX_ELEMS


def test_build_lp_model_block_reads_config():
    cfg = load_experiment(FB_CFG)
    m = build_lp_model(cfg, 280, 112)
    assert m.rgc1.blocks.shape == (224, 100, 5, 5)
    assert m.rgc1.self_weight.shape == (500, 500) and m.rgc1.bias.shape == (500,)
    # schlichtkrull-normal with the fan ((R'-1)//2, ib) = (112, 5)
    std = 3 / np.sqrt(117)
    assert m.rgc1.blocks.std().item() == pytest.approx(std, rel=0.01)
    assert m.rgc1.self_weight.std().item() == pytest.approx(std, rel=0.01)
    jm = j_build_lp(j_load(FB_CFG), 280, 112)
    flat = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: jm.init(jax.random.key(0), j_build(np.zeros((1, 3), np.int64),
                                                   280, 112, prefer_native=False),
                        jnp.zeros((1, 3), jnp.int32))))[0]
    shapes = {".".join(str(k.key) for k in path[1:]): tuple(v.shape)
              for path, v in flat}
    assert shapes == {k: tuple(v.shape) for k, v in m.state_dict().items()}


def test_fb_toy_full_width_encode_matches_jax():
    """lp-FB-toy at full width (500, 100 blocks) on the full fb_toy_like
    graph: the port's expanded-weight route (K3 and K1 plain versions)
    against the JAX model's XLA path (blockwise messages)."""
    jcfg, cfg = j_load(FB_CFG), load_experiment(FB_CFG)
    jdata, data = j_fb_toy(), fb_toy_like()
    assert jdata.pad_nodes(5) == 0
    n, r = data.num_nodes, data.num_relations
    assert (n, r) == (280, 112)
    jm = j_build_lp(jcfg, n, r, backend="xla")
    jes = j_build(jdata.train, n, r, tile_size=128, prefer_native=False)
    triples = np.asarray(data.test[:64])
    params = jm.init(jax.random.key(2), jes, jnp.asarray(triples))
    z_want = np.asarray(jm.apply(params, jes, method=jm.encode))
    s_want, _ = jm.apply(params, jes, jnp.asarray(triples))
    srv = load_lp_server(cfg, data, from_jax_params(_np_tree(params)), device="cpu")
    es = srv.edges
    assert es.merged is None and es.layout is not None
    assert (es.num_tiles, es.num_edges, es.layout.num_chunks) == (250, 7368, 31)
    z = srv.z.numpy()
    assert z.shape == (280, 500) and np.isfinite(z).all()
    np.testing.assert_allclose(z, z_want, rtol=0, atol=_tol(z_want))
    np.testing.assert_allclose(srv.score(triples), np.asarray(s_want), rtol=0,
                               atol=_tol(s_want))


def test_load_lp_server_pads_nodes_for_blocks():
    """A block encoder pads the vocabulary to a multiple of node_embedding
    // num_blocks (5 for lp-FB-toy) before building the model and graph."""
    data = synthetic_link_prediction(num_nodes=63, num_rels=4, num_edges=400)
    cfg = load_experiment(FB_CFG)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, node_embedding=20, hidden1_size=20,
        decomposition=dataclasses.replace(cfg.encoder.decomposition, num_blocks=4)))
    srv = load_lp_server(cfg, data, device="cpu")
    assert data.num_nodes == 65 and data.i2n[-2:] == ["null0", "null1"]
    assert srv.z.shape == (65, 20) and srv.edges.num_nodes == 65
    assert srv.model.rgc1.blocks.shape == (8, 4, 5, 5)


def test_serve_links_fb_toy_cli_cpu(capsys):
    from rgcn_tpu_torch import serve_links

    serve_links.main(["--config", FB_CFG, "--synthetic", "--cpu", "--topk", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[synthetic] FB-toy-like graph: N=280 R=112 E=3684"
    assert out[1].startswith("[serve] encoded 280 nodes")
    assert len(out) == 10 and all(ln.startswith("tails (") for ln in out[2:])
