"""Plain versions of K4/K5, the port's basis-decomposed RGCNConv and the
DistMult ops against the JAX package: the Pallas kernels in interpret
mode, the flax layer with ``backend="pallas"`` (and ``"xla"`` without a
layout), f32 on the CPU.

Tolerance atol 1e-5 on unit-scale kernel inputs, and 1e-5·max(1, max|ref|)
for the layer, whose outputs reach ~10: the same f32 sums taken in another
order (merged slots, dedup lanes, index_add_ against one-hot matmuls).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.graph import coalesce as jco
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.nn.layers import RGCNConv as JConv
from rgcn_tpu.ops import distmult as jdm
from rgcn_tpu.ops import pallas_basis as jpb
from rgcn_tpu_torch.graph import coalesce as tco
from rgcn_tpu_torch.graph.structure import build_edge_set as t_build
from rgcn_tpu_torch.nn.layers import RGCNConv
from rgcn_tpu_torch.ops import basis as tb
from rgcn_tpu_torch.ops import distmult as tdm
from rgcn_tpu_torch.weights import from_jax_params
from tests.conftest import make_random_triples

ATOL = 1e-5


def _reciprocal(n, r, e, seed):
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    return np.unique(np.concatenate([t, t[: e // 2, ::-1]]), axis=0), rng


def _merged_pair(n, r, e, seed, **kw):
    """Bit-equal JAX and port merged layouts of one graph."""
    t, rng = _reciprocal(n, r, e, seed)
    es = j_build(t, n, r, prefer_native=False)
    args = (es.dst, es.src, es.rel, es.val, n, es.num_rels)
    return (jco.build_merged_layout(*args, **kw),
            tco.build_merged_layout(*args, **kw).to("cpu"), es.num_rels, rng)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("nb,din,per_basis,sum_bases,rb,ch", [
    (1, 12, False, False, 128, 256),
    (2, 20, False, False, 128, 256),
    (3, 13, False, True, 64, 128),
    (2, 9, True, True, 32, 64),
    (3, 21, True, False, 64, 128),
])
def test_k4_plain_matches_pallas(nb, din, per_basis, sum_bases, rb, ch):
    n = 400
    jm, tm, _, rng = _merged_pair(n, 4, 1500, nb + din, row_block=rb, chunk=ch)
    lay = tm.layout
    n_slots = lay.num_chunks * lay.chunk
    x = _f32(rng, *((nb, n, din) if per_basis else (n, din)))
    w = _f32(rng, nb, n_slots) * (np.asarray(jm.layout.local_dst).reshape(-1) < rb)
    src = np.asarray(jm.src_sorted)
    xg = x[:, src] if per_basis else x[src]
    want = jpb.weighted_aggregate_pallas(
        jnp.asarray(xg), jnp.asarray(w), jm.layout, n, sum_bases=sum_bases,
        compute_dtype=None, interpret=True)
    got = tb.weighted_aggregate(torch.from_numpy(x), tm.src_sorted,
                                torch.from_numpy(w), lay, n, sum_bases=sum_bases)
    assert got.shape == want.shape == ((1 if sum_bases else nb), n, din)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kk,nb,din", [(2, 2, 20), (3, 1, 11), (3, 3, 8)])
def test_k5_plain_matches_pallas(kk, nb, din):
    n = 500
    jm, tm, r_gen, rng = _merged_pair(n, 3, 2500, kk * 10 + nb, dedup_k=kk,
                                      row_block=64, chunk=128)
    jd, td = jm.fwd_dedup, tm.fwd_dedup
    comps = _f32(rng, r_gen, nb)
    w_k = np.einsum("klr,rb->kbl", np.asarray(jd.coeff_k), comps).astype(np.float32)
    x = _f32(rng, n, din)
    want = jpb.weighted_aggregate_dedup_pallas(
        jnp.asarray(x[np.asarray(jd.src_sorted)]), jnp.asarray(w_k), jd, n,
        compute_dtype=None, interpret=True)
    got = tb.weighted_aggregate_dedup(torch.from_numpy(x), td.src_sorted,
                                      torch.from_numpy(w_k), td, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # the dedup frame holds the same terms as the plain merged frame
    plain = tb.weighted_aggregate(torch.from_numpy(x), tm.src_sorted,
                                  tb.merged_wvec(tm.coeff, torch.from_numpy(comps)),
                                  tm.layout, n)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=ATOL)


def test_sorted_inputs_and_merged_wvec():
    t, rng = _reciprocal(120, 3, 500, 4)
    jes = j_build(t, 120, 3, with_dst_layout=True, prefer_native=False)
    tes = t_build(t, 120, 3, with_dst_layout=True).to("cpu")
    comps = _f32(rng, jes.num_rels, 2)
    j_src, j_w = jpb._sorted_inputs(jes, jnp.asarray(comps))
    t_src, t_w = tb.sorted_inputs(tes, torch.from_numpy(comps))
    np.testing.assert_array_equal(t_src.numpy(), np.asarray(j_src))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    m = jco.build_merged_layout(jes.dst, jes.src, jes.rel, jes.val, 120, jes.num_rels)
    np.testing.assert_allclose(
        tb.merged_wvec(torch.from_numpy(np.asarray(m.coeff)),
                       torch.from_numpy(comps)).numpy(),
        np.asarray(jpb._merged_wvec(m.coeff, jnp.asarray(comps))),
        rtol=1e-6, atol=1e-7)


def _conv_pair(frame, nb=2, din=12, dout=10, n=300, r=4):
    t, rng = _reciprocal(n, r, 1400, 21)
    layout = frame != "no_layout"
    jes = j_build(t, n, r, tile_size=16, with_dst_layout=layout,
                  with_merged_layout=frame in ("merged", "dedup"),
                  prefer_native=False)
    tes = t_build(t, n, r, tile_size=16, with_dst_layout=layout,
                  with_merged_layout=frame in ("merged", "dedup"))
    if frame == "dedup":
        args = (jes.dst, jes.src, jes.rel, jes.val, n, jes.num_rels)
        jes = dataclasses.replace(jes, merged=jco.build_merged_layout(*args, dedup_k=2))
        tes = dataclasses.replace(tes, merged=tco.build_merged_layout(*args, dedup_k=2))
    kw = dict(decomposition="basis", num_bases=nb,
              weight_init="schlichtkrull-normal", weight_gain=False)
    jconv = JConv(num_nodes=n, num_relations=2 * r + 1, out_features=dout,
                  in_features=din, bias_init="normal",
                  backend="xla" if frame == "no_layout" else "pallas", **kw)
    x = _f32(rng, n, din)
    params = jconv.init(jax.random.key(3), jes, jnp.asarray(x))
    conv = RGCNConv(n, 2 * r + 1, dout, in_features=din, bias_init="normal", **kw)
    state = from_jax_params({"params": {"c": jax.tree_util.tree_map(
        np.asarray, params["params"])}})
    conv.load_state_dict({k[2:]: v for k, v in state.items()})
    return jconv, params, jes, conv, tes.to("cpu"), x


@pytest.mark.parametrize("frame", ["merged", "dedup", "unmerged", "no_layout"])
def test_basis_conv_matches_flax(frame):
    jconv, params, jes, conv, tes, x = _conv_pair(frame)
    want = np.asarray(jconv.apply(params, jes, jnp.asarray(x)))
    with torch.inference_mode():
        got = conv(tes, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (300, 10)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def test_basis_conv_unported_branches_raise():
    # featureless and many-basis layers are ported: they build
    assert RGCNConv(10, 5, 4, decomposition="basis", num_bases=2).bases.shape \
        == (2, 10, 4)
    assert RGCNConv(10, 5, 4, in_features=3, decomposition="basis",
                    num_bases=9).comps.shape == (5, 9)
    # diagonal weights (e-RGCN) are ported: (R', din), no bias
    diag = RGCNConv(10, 5, 4, in_features=4, diag=True)
    assert diag.weights.shape == (5, 4) and diag.bias is None
    with pytest.raises(ValueError, match="num_blocks > 0"):  # block is ported
        RGCNConv(10, 5, 4, in_features=4, decomposition="block")
    with pytest.raises(ValueError, match="num_bases > 0"):
        RGCNConv(10, 5, 4, in_features=3, decomposition="basis")


@pytest.mark.parametrize("biases", [False, True])
def test_distmult_ops_match_jax(biases):
    rng = np.random.default_rng(5 + biases)
    n, r, d = 50, 6, 16
    nodes, rels = _f32(rng, n, d), _f32(rng, r, d)
    b = dict(sbias=_f32(rng, n), pbias=_f32(rng, r), obias=_f32(rng, n)) \
        if biases else {}
    triples = np.stack([rng.integers(0, n, 20), rng.integers(0, r, 20),
                        rng.integers(0, n, 20)], axis=1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tbias = {k: torch.from_numpy(v) for k, v in b.items()}
    for jf, tf in ((jdm.distmult_score, tdm.distmult_score),
                   (jdm.score_head_candidates, tdm.score_head_candidates),
                   (jdm.score_tail_candidates, tdm.score_tail_candidates)):
        want = np.asarray(jf(jnp.asarray(triples), jnp.asarray(nodes),
                             jnp.asarray(rels), **jb))
        got = tf(torch.from_numpy(triples), torch.from_numpy(nodes),
                 torch.from_numpy(rels), **tbias).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
