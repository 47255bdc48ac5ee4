"""Many-basis node classification (nc-MUTAG, nc-BGS, nc-AM) in the port
against the JAX package, f32 on the CPU: the featureless basis contraction
(ungrouped and in tile groups), the few-basis featureless forward over K4's
plain version against the Pallas kernel in interpret mode, RGCNConv's basis
branches against the flax layer with ``backend="pallas"``, the served
configs against the JAX server (its XLA path) with the parameters carried
by ``from_jax_params``, ``layer1_l2``, and the AM-scale graph.

Tolerance atol 1e-5 (1e-5·max(1, max|ref|) for layers whose outputs pass
1): the same f32 sums taken in another order.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.config import load_experiment as j_load_experiment
from rgcn_tpu.data.synthetic import synthetic_kg as j_synthetic_kg
from rgcn_tpu.data.synthetic import synthetic_node_classification as j_synth
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.nn.layers import RGCNConv as JConv
from rgcn_tpu.ops import pallas_aggregate as jagg
from rgcn_tpu.ops import pallas_basis as jpb
from rgcn_tpu.ops import spmm as jops
from rgcn_tpu.serve import NodeClassificationServer as JServer
from rgcn_tpu.train.node_classification import build_nc_model as j_build_nc_model
from rgcn_tpu_torch.config import DecompositionConfig, load_experiment
from rgcn_tpu_torch.data.synthetic import am_like, synthetic_nc_data
from rgcn_tpu_torch.graph.structure import build_edge_set as t_build
from rgcn_tpu_torch.models.node_classification import build_nc_model
from rgcn_tpu_torch.nn import init as rinit
from rgcn_tpu_torch.nn.layers import RGCNConv
from rgcn_tpu_torch.ops import aggregate as tagg
from rgcn_tpu_torch.ops import basis as tb
from rgcn_tpu_torch.ops import spmm as tops
from rgcn_tpu_torch.serve import load_nc_server
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs", "rgcn")
ATOL = 1e-5


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _graph(n=90, r=4, e=500, seed=0, **kw):
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    jes = j_build(t, n, r, tile_size=16, prefer_native=False, **kw)
    tes = t_build(t, n, r, tile_size=16, **kw).to("cpu")
    return jes, tes, rng


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("k1", [False, True])
def test_featureless_basis_matches_jax(monkeypatch, grouped, k1):
    """The per-tile contraction of the gathered basis rows, summed by the
    XLA/index_add oracle or by K1 (Pallas interpret / plain version); with
    ``grouped`` both modules' element budgets are lowered so the tiles go
    in groups (the search steps down to a divisor of the tile count)."""
    jes, tes, rng = _graph(with_dst_layout=k1)
    nb, dout = 12, 5
    if grouped:
        budget = 16 * nb * dout * 4  # 4 tiles a group, stepped down to a divisor
        assert jes.num_tiles % 4
        monkeypatch.setattr(jops, "_ELEM_BUDGET", budget)
        monkeypatch.setattr(tops, "_ELEM_BUDGET", budget)
    bases = _f32(rng, nb, 90, dout)
    comps = _f32(rng, jes.num_rels, nb)
    want = jops.rel_spmm_featureless_basis(
        jes, jnp.asarray(bases), jnp.asarray(comps),
        aggregate=jagg.aggregate_messages_ad if k1 else None)
    got = tops.rel_spmm_featureless_basis(
        tes, torch.from_numpy(bases), torch.from_numpy(comps),
        aggregate=(lambda m, es: tagg.aggregate_sorted(m, es.layout, es.num_nodes))
        if k1 else None)
    assert got.shape == (90, dout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("nb", [1, 4, 8])
def test_featureless_basis_few_bases_matches_pallas(nb):
    """K4's plain version over per-basis tables with sum_bases against
    ``rel_spmm_featureless_basis_ad`` (Pallas K4, interpret mode)."""
    jes, tes, rng = _graph(n=150, e=900, seed=nb, with_dst_layout=True)
    bases = _f32(rng, nb, 150, 7)
    comps = _f32(rng, jes.num_rels, nb)
    want = jpb.rel_spmm_featureless_basis_ad(jes, jnp.asarray(bases),
                                             jnp.asarray(comps))
    got = tb.rel_spmm_featureless_basis_fwd(tes, torch.from_numpy(bases),
                                            torch.from_numpy(comps))
    assert got.shape == (150, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


CONV_CASES = [
    ("featureless", 4, "layout"),     # K4 per-basis tables, sum_bases
    ("featureless", 40, "layout"),    # gather + contraction, then K1
    ("featureless", 40, "no_layout"),  # the index_add_ oracle
    ("featureful", 4, "layout"),      # aggregation-first K4
    ("featureful", 30, "layout"),     # expanded weights through K2
    ("featureful", 30, "no_fused"),   # expanded weights through K3 + K1
    ("featureful", 30, "no_layout"),
]


@pytest.mark.parametrize("kind,nb,frame", CONV_CASES,
                         ids=[f"{k}-{b}-{f}" for k, b, f in CONV_CASES])
def test_basis_conv_matches_flax(kind, nb, frame):
    n, r, din, dout = 120, 5, 16, 6
    layout = frame != "no_layout"
    jes, tes, rng = _graph(n=n, r=r, e=700, seed=nb, with_dst_layout=layout)
    if frame == "no_fused":
        jes = dataclasses.replace(jes, fused=None)
        tes = dataclasses.replace(tes, fused=None)
    featureless = kind == "featureless"
    jconv = JConv(num_nodes=n, num_relations=2 * r + 1, out_features=dout,
                  in_features=None if featureless else din,
                  decomposition="basis", num_bases=nb, backend="pallas")
    x = None if featureless else np.maximum(_f32(rng, n, din), 0)
    args = (jes,) if featureless else (jes, jnp.asarray(x))
    # the same parameters as the pallas layer's, without running its
    # interpret-mode kernels at init
    params = jconv.clone(backend="xla").init(jax.random.key(nb), *args)
    # a non-zero bias, so that it is carried and added too
    params = {"params": {**params["params"],
                         "bias": jnp.asarray(_f32(rng, dout, scale=0.1))}}
    want = np.asarray(jconv.apply(params, *args))

    conv = RGCNConv(n, 2 * r + 1, dout, in_features=None if featureless else din,
                    decomposition="basis", num_bases=nb)
    state = from_jax_params({"params": {"c": _np_tree(params["params"])}})
    conv.load_state_dict({k[2:]: v for k, v in state.items()})
    with torch.inference_mode():
        got = conv(tes, None if featureless else torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (n, dout)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def _few_bases(cfg, nb=4):
    return dataclasses.replace(cfg, rgcn=dataclasses.replace(
        cfg.rgcn, decomposition=dataclasses.replace(
            cfg.rgcn.decomposition, num_bases=nb)))


@pytest.mark.parametrize("name", ["nc-MUTAG", "nc-BGS", "nc-AM", "few-bases"])
def test_server_matches_jax_server(name):
    """The served configs at their full widths on the stand-in graph
    ``serve_nodes --synthetic`` picks (500 nodes, 8 relations), and an nc-AM
    config with 4 bases (the merged layout, K4 in both layers)."""
    path = os.path.join(CONFIGS, ("nc-AM" if name == "few-bases" else name) + ".yaml")
    cfg, jcfg = load_experiment(path), j_load_experiment(path)
    if name == "few-bases":
        cfg, jcfg = _few_bases(cfg), _few_bases(jcfg)
    d, jd = synthetic_nc_data(cfg.dataset.name), j_synth(seed=0)
    nb = cfg.rgcn.decomposition.num_bases
    # the JAX package's XLA path (the layer tests above hold each branch
    # against its Pallas kernels in interpret mode)
    jm = j_build_nc_model(jcfg, jd, backend="xla")
    jes = j_build(jd.triples, jd.num_nodes, jd.num_relations, tile_size=128,
                  with_dst_layout=True, with_merged_layout=nb <= 8,
                  prefer_native=False)
    params = jm.init(jax.random.key(0), jes)
    assert params["params"]["rgc1"]["bases"].shape == (nb, 500, cfg.rgcn.hidden_size)
    jsrv = JServer(jm, params, jes)

    srv = load_nc_server(cfg, d, from_jax_params(_np_tree(params)), device="cpu")
    assert (srv.edges.merged is not None) == (nb <= 8)
    np.testing.assert_allclose(srv.logits, jsrv.logits, rtol=0,
                               atol=ATOL * max(1.0, np.abs(jsrv.logits).max()))
    nodes = [d.n2i[k] for k in list(d.test)[:16]]
    np.testing.assert_array_equal(srv.classify(nodes), jsrv.classify(nodes))
    np.testing.assert_allclose(srv.probabilities(nodes), jsrv.probabilities(nodes),
                               rtol=0, atol=ATOL)
    # the layer-1 penalty under basis decomposition: bases² + comps²
    np.testing.assert_allclose(srv.model.layer1_l2().item(),
                               float(jm.layer1_l2(params)), rtol=1e-6)


def test_basis_model_draws_in_the_jax_order():
    """Seeded init of a basis NodeClassifier: per layer bases, then comps,
    then the (zero) bias, from one generator."""
    cfg = load_experiment(os.path.join(CONFIGS, "nc-MUTAG.yaml"))
    d = synthetic_nc_data("MUTAG")
    model = build_nc_model(cfg, d, seed=3)
    gen = torch.Generator().manual_seed(3)
    w_init = rinit.select_weight_init("glorot-uniform", rinit.relu_gain())
    r_aug = 2 * d.num_relations + 1
    for layer, (din, dout) in ((model.rgc1, (500, 16)), (model.rgc2, (16, d.num_classes))):
        assert torch.equal(layer.bases, w_init((30, din, dout), gen))
        assert torch.equal(layer.comps, w_init((r_aug, 30), gen))
        assert torch.count_nonzero(layer.bias) == 0
    want = (model.rgc1.bases ** 2).sum() + (model.rgc1.comps ** 2).sum()
    assert model.layer1_l2().item() == pytest.approx(want.item(), rel=1e-6)


def test_am_like_is_the_stress_graph():
    """``am_like`` builds ``benchmarks/stress_nc.py``'s graph: the triples of
    ``synthetic_kg(300_000, 266, 1_000_000, seed=9)`` bit-equal, and its
    1,000 labeled nodes with 11 classes from ``default_rng(9)``."""
    d = am_like()
    want = j_synthetic_kg(300_000, 266, 1_000_000, seed=9)
    assert d.triples.dtype == want.dtype
    np.testing.assert_array_equal(d.triples, want)
    assert (d.num_nodes, d.num_relations, len(d.triples)) == (300_000, 266, 747_518)
    rng = np.random.default_rng(9)
    idx = rng.choice(300_000, 1_000, replace=False)
    lbl = rng.integers(0, 11, 1_000)
    labels = {**d.train, **d.test}
    assert len(d.train) == len(d.test) == 500 and d.num_classes == 11
    assert labels == {f"node{i}": int(c) for i, c in zip(idx, lbl)}
