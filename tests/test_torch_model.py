"""The port's NodeClassifier and server against the JAX package's, with the
flax parameters carried by ``from_jax_params``. JAX runs ``backend="pallas"``
(interpret mode on the CPU); the port takes its kernels' plain versions on
CPU tensors. Tolerance atol 1e-5 in f32."""

import os

import jax
import numpy as np
import pytest
import torch

from rgcn_tpu.config import load_experiment as j_load_experiment
from rgcn_tpu.data.synthetic import aifb_like as j_aifb_like
from rgcn_tpu.data.synthetic import synthetic_node_classification as j_synth
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.models.node_classification import NodeClassifier as JNodeClassifier
from rgcn_tpu.serve import NodeClassificationServer as JServer
from rgcn_tpu.train.node_classification import build_nc_model as j_build_nc_model
from rgcn_tpu_torch.data.synthetic import aifb_like, synthetic_node_classification
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.models.node_classification import NodeClassifier
from rgcn_tpu_torch.serve import load_nc_server
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIFB_CFG = os.path.join(ROOT, "configs", "rgcn", "nc-AIFB.yaml")
ATOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(triples, n, r, c, layers, backend="pallas", with_layout=True):
    jes = j_build(triples, n, r, tile_size=16, with_dst_layout=with_layout,
                  prefer_native=False)
    jm = JNodeClassifier(num_nodes=n, num_relations=r, num_classes=c,
                         num_layers=layers, backend=backend)
    params = jm.init(jax.random.key(0), jes)
    tm = NodeClassifier(n, r, c, num_layers=layers)
    tm.load_state_dict(from_jax_params(_np_tree(params)))
    tes = build_edge_set(triples, n, r, tile_size=16,
                         with_dst_layout=with_layout).to("cpu")
    return jm, params, jes, tm, tes


@pytest.mark.parametrize("layers", [1, 2])
def test_node_classifier_matches_flax(layers):
    rng = np.random.default_rng(20 + layers)
    triples = make_random_triples(rng, 60, 4, 300)
    jm, params, jes, tm, tes = _pair(triples, 60, 4, 3, layers)
    want = np.asarray(jm.apply(params, jes))
    with torch.inference_mode():
        got = tm(tes).numpy()
    assert got.shape == (60, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tm.layer1_l2().item(), float(jm.layer1_l2(params)), rtol=1e-6)


@pytest.mark.parametrize("layers", [1, 2])
def test_node_classifier_without_layout_matches_xla(layers):
    """No destination layout: both sides take their index_add_ /
    segment_sum oracle paths."""
    rng = np.random.default_rng(30 + layers)
    triples = make_random_triples(rng, 50, 3, 200)
    jm, params, jes, tm, tes = _pair(triples, 50, 3, 4, layers,
                                     backend="xla", with_layout=False)
    want = np.asarray(jm.apply(params, jes))
    with torch.inference_mode():
        got = tm(tes).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("in_features", [None, 8])
def test_layout_free_path_is_cpu_only(in_features):
    """Off the CPU, an EdgeSet without a destination layout raises instead
    of running the plain path (the meta device stands in for the card)."""
    from rgcn_tpu_torch.nn.layers import RGCNConv, check_plain_path

    check_plain_path(torch.device("cpu"))
    with pytest.raises(ValueError, match="with_dst_layout=True"):
        check_plain_path(torch.device("cuda"))
    rng = np.random.default_rng(5)
    es = build_edge_set(make_random_triples(rng, 40, 3, 120), 40, 3,
                        tile_size=16).to("meta")
    conv = RGCNConv(40, 7, 5, in_features=in_features).to("meta")
    x = None if in_features is None else torch.empty((40, 8), device="meta")
    with pytest.raises(ValueError, match="with_dst_layout=True"):
        conv(es, x)


def test_full_aifb_forward_matches_flax():
    """nc-AIFB at full width: aifb_like(), hidden 16, R' = 91."""
    d, jd = aifb_like(), j_aifb_like()
    jes = j_build(jd.triples, jd.num_nodes, jd.num_relations,
                  with_dst_layout=True, prefer_native=False)
    jm = JNodeClassifier(num_nodes=jd.num_nodes, num_relations=jd.num_relations,
                         num_classes=jd.num_classes, hidden_size=16,
                         backend="pallas")
    params = jm.init(jax.random.key(0), jes)
    assert params["params"]["rgc1"]["weights"].shape == (91, 8285, 16)
    want = np.asarray(jm.apply(params, jes))

    tm = NodeClassifier(d.num_nodes, d.num_relations, d.num_classes)
    tm.load_state_dict(from_jax_params(_np_tree(params)))
    tes = build_edge_set(d.triples, d.num_nodes, d.num_relations,
                         with_dst_layout=True).to("cpu")
    with torch.inference_mode():
        got = tm(tes).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_server_matches_jax_server():
    kw = dict(num_nodes=400, num_rels=6, num_edges=1500, num_classes=4,
              seed=3)
    d, jd = synthetic_node_classification(**kw), j_synth(**kw)
    cfg = j_load_experiment(AIFB_CFG)
    jm = j_build_nc_model(cfg, jd, backend="pallas")
    jes = j_build(jd.triples, jd.num_nodes, jd.num_relations, tile_size=128,
                  with_dst_layout=True, prefer_native=False)
    params = jm.init(jax.random.key(0), jes)
    jsrv = JServer(jm, params, jes)

    srv = load_nc_server(AIFB_CFG, d, from_jax_params(_np_tree(params)),
                         device="cpu")
    np.testing.assert_allclose(srv.logits, jsrv.logits, rtol=0, atol=ATOL)
    nodes = [d.n2i[name] for name in list(d.test)[:8]]
    np.testing.assert_array_equal(srv.classify(nodes), jsrv.classify(nodes))
    np.testing.assert_allclose(srv.probabilities(nodes),
                               jsrv.probabilities(nodes), rtol=0, atol=ATOL)

    # refresh with new parameters recomputes the logits
    zero = {k: torch.zeros_like(v) for k, v in srv.model.state_dict().items()}
    srv.refresh(zero)
    assert np.abs(srv.logits).max() == 0.0
    np.testing.assert_allclose(srv.probabilities(nodes), 0.25)


def test_seeded_init():
    a = NodeClassifier(30, 2, 3, seed=1)
    b = NodeClassifier(30, 2, 3, seed=1)
    c = NodeClassifier(30, 2, 3, seed=2)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    assert not torch.equal(a.rgc1.weights, c.rgc1.weights)
    w = a.rgc1.weights
    assert w.shape == (5, 30, 16) and a.rgc2.weights.shape == (5, 16, 3)
    bound = np.sqrt(2.0) * np.sqrt(6.0 / (30 * 16 + 5 * 16))  # torch fans
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.9 * bound
    assert torch.count_nonzero(a.rgc1.bias) == 0


def test_unported_branches_raise():
    # basis layers are ported; as in the JAX package, they need bases
    with pytest.raises(ValueError, match="num_bases > 0"):
        NodeClassifier(10, 2, 3, decomposition="basis")
    with pytest.raises(ValueError, match="1 or 2"):
        NodeClassifier(10, 2, 3, num_layers=3)
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.models.node_classification import build_nc_model

    from rgcn_tpu_torch.models.node_classification import EmbeddingNodeClassifier

    # e-RGCN is ported: the config builds the embedding classifier
    cfg = load_experiment(os.path.join(ROOT, "configs", "e-rgcn", "nc-AIFB.yaml"))
    m = build_nc_model(cfg, aifb_like())
    assert isinstance(m, EmbeddingNodeClassifier)
    assert m.rgcn_no_hidden.weights.shape == (91, 32)
    from rgcn_tpu_torch.weights import from_jax_params as f

    # the c-RGCN bottleneck's kernel carries as it is, (in, out)
    k = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = f({"params": {"encoding_layer": {"kernel": k}}})
    assert np.array_equal(got["encoding_layer.kernel"].numpy(), k)
    # the JAX LP model's feature_blocks storage joins into one table
    blocks = {f"node_embeddings_block{i}": np.full((2, w), i, np.float32)
              for i, w in ((1, 2), (0, 3))}
    got = f({"params": blocks})
    assert list(got) == ["node_embeddings"]
    np.testing.assert_array_equal(got["node_embeddings"].numpy(),
                                  [[0, 0, 0, 1, 1]] * 2)
    # block layers are ported: their leaves carry
    assert set(f({"params": {"rgc1": {"blocks": np.zeros((2, 3, 4, 4)),
                                      "self_weight": np.zeros((12, 12))}}})) \
        == {"rgc1.blocks", "rgc1.self_weight"}
