"""The port's LinkPredictor and LinkPredictionServer against the JAX
package's, with the flax parameters carried by ``from_jax_params``.

A small graph runs the JAX encoder with ``backend="pallas"`` (interpret
mode); the full wn18_like graph at width 200 runs it with ``backend="xla"``
(the dense-weight path, fast on the CPU) against the port's merged K4 path
(plain version on CPU tensors). Tolerance: atol 1e-5·max(1, max|ref|),
f32 sums taken in another order.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.config import load_experiment as j_load
from rgcn_tpu.data.synthetic import wn18_like as j_wn18
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.models.link_prediction import LinkPredictor as JLinkPredictor
from rgcn_tpu.serve import LinkPredictionServer as JServer
from rgcn_tpu.train.link_prediction import build_lp_model as j_build_lp
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import synthetic_link_prediction, wn18_like
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.models.link_prediction import LinkPredictor, build_lp_model
from rgcn_tpu_torch.serve import LinkPredictionServer, load_lp_server
from rgcn_tpu_torch.weights import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WN18_CFG = os.path.join(ROOT, "configs", "rgcn", "lp-WN18.yaml")


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


SMALL = dict(num_nodes=120, num_relations=3, emb_dim=16, num_bases=2,
             decomposition="basis", weight_init="schlichtkrull-normal",
             bias_init="zeros", decoder_l2_type="schlichtkrull-l2",
             decoder_l2=0.01)


def _small_pair(layers=1, decoder_bias_init=None, seed=0):
    data = synthetic_link_prediction(num_nodes=120, num_rels=3,
                                      num_edges=700, seed=seed,
                                      reciprocity=0.8)
    kw = dict(SMALL, num_layers=layers, decoder_bias_init=decoder_bias_init)
    jm = JLinkPredictor(backend="pallas", **kw)
    jes = j_build(data.train, 120, 3, tile_size=16, with_dst_layout=True,
                  with_merged_layout=True, prefer_native=False)
    triples = np.asarray(data.test[:16])
    params = jm.init(jax.random.key(seed), jes, jnp.asarray(triples))
    tm = LinkPredictor(**kw)
    tm.load_state_dict(from_jax_params(_np_tree(params)))
    tes = build_edge_set(data.train, 120, 3, tile_size=16,
                         with_dst_layout=True, with_merged_layout=True).to("cpu")
    return data, jm, params, jes, tm.eval(), tes, triples


@pytest.mark.parametrize("layers,dbias", [(1, None), (2, None), (1, "normal")])
def test_link_predictor_matches_flax(layers, dbias):
    data, jm, params, jes, tm, tes, triples = _small_pair(layers, dbias)
    assert tes.merged is not None
    z_want = np.asarray(jm.apply(params, jes, method=jm.encode))
    s_want, p_want = jm.apply(params, jes, jnp.asarray(triples))
    with torch.inference_mode():
        z = tm.encode(tes)
        s_got, p_got = tm(tes, torch.from_numpy(triples))
        heads = tm.score_heads(torch.from_numpy(triples), z).numpy()
        tails = tm.score_tails(torch.from_numpy(triples), z).numpy()
    z = z.numpy()
    assert z.shape == (120, 16)
    np.testing.assert_allclose(z, z_want, rtol=0, atol=_tol(z_want))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), rtol=0,
                               atol=_tol(s_want))
    np.testing.assert_allclose(p_got.item(), float(p_want), rtol=1e-5)
    zj = jnp.asarray(z_want)
    for got, want in ((heads, jm.apply(params, jnp.asarray(triples), zj,
                                       method=jm.score_heads)),
                      (tails, jm.apply(params, jnp.asarray(triples), zj,
                                       method=jm.score_tails))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=_tol(want))


def test_link_predictor_wn18_full_width_matches_flax():
    """lp-WN18 at full width (200, basis 2) on the full wn18_like graph:
    the port's merged K4 path against the JAX dense-weight XLA path."""
    jcfg, cfg = j_load(WN18_CFG), load_experiment(WN18_CFG)
    jdata, data = j_wn18(), wn18_like()
    n, r = data.num_nodes, data.num_relations
    jm = j_build_lp(jcfg, n, r, backend="xla")
    jes = j_build(jdata.train, n, r, tile_size=128, prefer_native=False)
    triples = np.asarray(data.test[:64])
    params = jm.init(jax.random.key(1), jes, jnp.asarray(triples))
    z_want = np.asarray(jm.apply(params, jes, method=jm.encode))
    s_want, _ = jm.apply(params, jes, jnp.asarray(triples))
    srv = load_lp_server(cfg, data, from_jax_params(_np_tree(params)),
                         device="cpu")
    assert srv.edges.merged is not None and srv.edges.merged.fwd_dedup is None
    z = srv.z.numpy()
    assert z.shape == (40_943, 200) and np.isfinite(z).all()
    np.testing.assert_allclose(z, z_want, rtol=0, atol=_tol(z_want))
    np.testing.assert_allclose(srv.score(triples), np.asarray(s_want), rtol=0,
                               atol=_tol(s_want))


def test_build_lp_model_reads_config():
    cfg = load_experiment(WN18_CFG)
    m = build_lp_model(cfg, 300, 18)
    assert m.node_embeddings.shape == (300, 200)
    assert m.rgc1.bases.shape == (2, 200, 200) and m.rgc1.comps.shape == (37, 2)
    assert m.rgc1.bias.shape == (200,) and m.scoring_function.relations.shape == (18, 200)
    assert m.scoring_function.sbias is None and m.num_layers == 1
    # schlichtkrull-normal std of (2, 200, 200): 3 / sqrt(202)
    assert abs(m.rgc1.bases.std().item() - 3 / np.sqrt(202)) < 0.01
    assert torch.count_nonzero(m.rgc1.bias) == 0
    jm = j_build_lp(j_load(WN18_CFG), 300, 18)
    flat = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: jm.init(jax.random.key(0), j_build(np.zeros((1, 3), np.int64),
                                                   300, 18, prefer_native=False),
                        jnp.zeros((1, 3), jnp.int32))))[0]
    shapes = {".".join(str(k.key) for k in path[1:]): tuple(v.shape)
              for path, v in flat}
    assert shapes == {k: tuple(v.shape) for k, v in m.state_dict().items()}
    # c-RGCN: the whole state dict against the flax tree's shapes, the
    # bottleneck kernels in the flax (in, out) layout
    for name in ("lp-WN18", "lp-FB-toy"):
        path = os.path.join(ROOT, "configs", "c-rgcn", f"{name}.yaml")
        c = build_lp_model(load_experiment(path), 300, 18)
        jc = j_build_lp(j_load(path), 300, 18)
        flat = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
            lambda: jc.init(jax.random.key(0), j_build(np.zeros((1, 3), np.int64),
                                                       300, 18, prefer_native=False),
                            jnp.zeros((1, 3), jnp.int32))))[0]
        shapes = {".".join(str(k.key) for k in path[1:]): tuple(v.shape)
                  for path, v in flat}
        assert shapes == {k: tuple(v.shape) for k, v in c.state_dict().items()}
        emb, hid = c.node_embeddings.shape[1], c.rgc1.weights.shape[1]
        assert c.encoding_layer.kernel.shape == (emb, hid)
        assert c.decoding_layer.kernel.shape == (hid, emb)


def _server_pair(max_batch):
    data, jm, params, jes, tm, tes, _ = _small_pair(1, "normal", seed=2)
    train = np.asarray(data.train)
    jsrv = JServer(jm, params, jes, max_batch=max_batch, known_triples=train)
    tsrv = LinkPredictionServer(tm, tes, max_batch=max_batch, known_triples=train)
    return data, jsrv, tsrv


@pytest.mark.parametrize("max_batch", [4, 1024])
def test_server_matches_jax_server(max_batch):
    data, jsrv, tsrv = _server_pair(max_batch)
    test = np.asarray(data.test)
    np.testing.assert_allclose(tsrv.z.numpy(), np.asarray(jsrv.z), rtol=0,
                               atol=_tol(jsrv.z))
    want = jsrv.score(test)
    np.testing.assert_allclose(tsrv.score(test), want, rtol=0, atol=_tol(want))
    for fn in ("topk_tails", "topk_heads"):
        q = test[:, :2] if fn == "topk_tails" else test[:, 1:]
        for filtered in (False, True):
            s_t, e_t = getattr(tsrv, fn)(q, k=5, filtered=filtered)
            s_j, e_j = getattr(jsrv, fn)(q, k=5, filtered=filtered)
            assert e_t.dtype == np.int32 and s_t.shape == (len(q), 5)
            np.testing.assert_array_equal(e_t, e_j)
            np.testing.assert_allclose(s_t, s_j, rtol=0, atol=_tol(s_j))


def test_server_filters_and_refresh():
    data, jsrv, tsrv = _server_pair(8)
    train = np.asarray(data.train)
    s, p = int(train[0, 0]), int(train[0, 1])
    known = {int(o) for a, b, o in train if a == s and b == p}
    _, ents = tsrv.topk_tails(np.array([[s, p]]), k=20, filtered=True)
    assert not known & set(ents[0].tolist())
    bare = LinkPredictionServer(tsrv.model, tsrv.edges)
    with pytest.raises(ValueError, match="known triples"):
        bare.topk_heads(np.array([[0, 1]]), filtered=True)
    bare.set_filters(train)
    np.testing.assert_array_equal(bare.topk_heads(train[:3, 1:], filtered=True)[1],
                                  tsrv.topk_heads(train[:3, 1:], filtered=True)[1])
    state = {k: v * 0.5 if k == "node_embeddings" else v
             for k, v in tsrv.model.state_dict().items()}
    z0 = tsrv.z.clone()
    tsrv.refresh(state)
    assert not torch.allclose(tsrv.z, z0)
    with torch.inference_mode():
        np.testing.assert_allclose(tsrv.z.numpy(), tsrv.model.encode(tsrv.edges).numpy())


def test_server_dedup_branch_matches_merged():
    """The same model over the EdgeSet whose merged layout carries the
    source-dedup'd frame (K5's plain version) gives the same z."""
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout

    data, _, _, _, tm, tes, _ = _small_pair(1, None, seed=4)
    es = build_edge_set(data.train, 120, 3, tile_size=16, with_dst_layout=True)
    dd = dataclasses.replace(tes, merged=build_merged_layout(
        es.dst, es.src, es.rel, es.val, 120, es.num_rels, dedup_k=2).to("cpu"))
    a = LinkPredictionServer(tm, tes).z.numpy()
    b = LinkPredictionServer(tm, dd).z.numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=_tol(a))


def test_load_lp_server_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = synthetic_link_prediction(num_nodes=40, num_rels=3, num_edges=150)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_lp_server(WN18_CFG, data, device=None)


def test_serve_links_cli_cpu(tmp_path, capsys):
    from rgcn_tpu_torch import serve_links

    q = tmp_path / "q.tsv"
    q.write_text("node1 rel0 node2\nnode1 rel3 ?\n? 2 node7\n5 1 6\n")
    serve_links.main(["--config", WN18_CFG, "--synthetic", "--cpu",
                      "--queries", str(q), "--topk", "3", "--filtered"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[synthetic] WN18-like graph: N=40943 R=18 E=108676"
    assert out[1].startswith("[serve] encoded 40943 nodes")
    assert out[2].startswith("score (1, 0, 2): ") and out[3].startswith("score (5, 1, 6): ")
    assert out[4].startswith("tails (1, 3): ") and out[4].count(":") == 4
    assert out[5].startswith("heads (2, 7): ")
    with pytest.raises(SystemExit):
        serve_links.main(["--config", WN18_CFG, "--cpu"])  # --synthetic required
