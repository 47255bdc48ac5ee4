"""The port's link-prediction data and coalesced-pair builders are bit-equal
to the JAX package's (synthetic KGs, merged layouts with both frames and
the source-dedup'd frame, build_edge_set(with_merged_layout=True))."""

import dataclasses

import numpy as np
import pytest
import torch

from rgcn_tpu.data import synthetic as jsyn
from rgcn_tpu.graph import coalesce as jco
from rgcn_tpu.graph import structure as jstruct
from rgcn_tpu_torch.data import synthetic as tsyn
from rgcn_tpu_torch.graph import coalesce as tco
from rgcn_tpu_torch.graph import structure as tstruct
from tests.conftest import make_random_triples

LAYOUT_FIELDS = ["perm", "local_dst", "chunk_block"]
LAYOUT_META = ["num_row_blocks", "row_block", "chunk", "num_chunks"]
MERGED_FIELDS = ["src_sorted", "coeff", "rev_src_sorted", "rev_receiver", "rev_coeff"]
MERGED_META = ["num_nodes", "num_rels", "num_pairs", "num_edges"]
DEDUP_FIELDS = ["src_sorted", "local_k", "chunk_block", "coeff_k"]
DEDUP_META = ["num_row_blocks", "row_block", "chunk", "num_chunks", "num_k"]


def _eq(got, want, arrays, meta, what):
    for f in arrays:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f"{what}.{f}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")
    for f in meta:
        assert getattr(got, f) == getattr(want, f), f"{what}.{f}"


def _eq_merged(got, want):
    _eq(got, want, MERGED_FIELDS, MERGED_META, "merged")
    for frame in ("layout", "rev_layout"):
        _eq(getattr(got, frame), getattr(want, frame), LAYOUT_FIELDS,
            LAYOUT_META, frame)
    assert (got.fwd_dedup is None) == (want.fwd_dedup is None)
    if got.fwd_dedup is not None:
        _eq(got.fwd_dedup, want.fwd_dedup, DEDUP_FIELDS, DEDUP_META, "fwd_dedup")


def _reciprocal_graph(n, r, e, seed):
    """Random triples plus reversed copies: inverse augmentation then puts
    parallel edges on the same (dst, src) pairs."""
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    return np.unique(np.concatenate([t, t[: e // 2, ::-1]]), axis=0)


@pytest.fixture(scope="module")
def wn18():
    got, want = tsyn.wn18_like(), jsyn.wn18_like()
    es = tstruct.build_edge_set(got.train, got.num_nodes, got.num_relations,
                                with_dst_layout=True)
    return got, want, es


def test_wn18_like_identical(wn18):
    got, want, _ = wn18
    np.testing.assert_array_equal(got.train, want.train)
    np.testing.assert_array_equal(got.test, want.test)
    assert got.all_triples == want.all_triples
    assert got.i2n == want.i2n and got.i2r == want.i2r
    assert (got.num_nodes, got.num_relations) == (40_943, 18)
    assert got.train.shape == (108_676, 3)


@pytest.mark.parametrize("kw", [
    dict(num_nodes=300, num_rels=6, num_edges=2000, seed=0),
    dict(num_nodes=500, num_rels=7, num_edges=3000, seed=3, reciprocity=0.5),
    dict(num_nodes=90, num_rels=4, num_edges=400, seed=1, zipf_nodes=1.4),
])
def test_synthetic_kg_identical(kw):
    np.testing.assert_array_equal(tsyn.synthetic_kg(**kw), jsyn.synthetic_kg(**kw))


@pytest.mark.parametrize("name", ["WN18", "FB-toy", "other"])
def test_synthetic_lp_data_matches_jax_dispatch(name):
    got = tsyn.synthetic_lp_data(name)
    want = {"wn18": jsyn.wn18_like, "fb-toy": jsyn.fb_toy_like}.get(
        name.lower(), lambda: jsyn.synthetic_link_prediction(seed=0))()
    np.testing.assert_array_equal(got.train, want.train)
    np.testing.assert_array_equal(got.test, want.test)


@pytest.mark.parametrize("dedup_k", [0, 2])
def test_merged_layout_bit_equal_wn18(wn18, dedup_k):
    """Full WN18 scale: both frames and the dedup frame, field by field."""
    _, _, es = wn18
    args = (es.dst, es.src, es.rel, es.val, es.num_nodes, es.num_rels)
    got = tco.build_merged_layout(*args, dedup_k=dedup_k)
    want = jco.build_merged_layout(*args, dedup_k=dedup_k)
    _eq_merged(got, want)
    # the lp-WN18 shapes the kernels are sized for
    assert got.num_pairs == 95_479 and got.layout.perm.shape == (128_512,)
    assert got.layout.num_chunks == 502 and got.layout.num_row_blocks == 320
    if dedup_k:
        assert got.fwd_dedup.src_sorted.shape == (118_016,)
        assert got.fwd_dedup.num_chunks == 461


@pytest.mark.parametrize("dedup_k,row_block,chunk", [
    (0, 128, 256), (2, 128, 256), (3, 32, 64), (2, 64, 128),
])
def test_merged_layout_bit_equal_small(dedup_k, row_block, chunk):
    t = _reciprocal_graph(700, 5, 3000, 12)
    es = jstruct.build_edge_set(t, 700, 5, prefer_native=False)
    args = (es.dst, es.src, es.rel, es.val, 700, es.num_rels)
    kw = dict(row_block=row_block, chunk=chunk, dedup_k=dedup_k)
    got = tco.build_merged_layout(*args, **kw)
    want = jco.build_merged_layout(*args, **kw)
    _eq_merged(got, want)
    assert got.num_pairs < got.num_edges  # parallel edges did merge


def test_merged_layout_refuses_wide_vocabularies():
    with pytest.raises(ValueError, match="num_rels <= 128"):
        tco.build_merged_layout(np.zeros(3, np.int32), np.zeros(3, np.int32),
                                np.zeros(3, np.int32), np.ones(3, np.float32),
                                5, 129)


@pytest.mark.parametrize("rels,kw", [
    (36, dict(decomposition="basis", num_bases=2)),
    (36, dict(decomposition="basis", num_bases=8)),
    (36, dict(decomposition="basis", num_bases=9)),
    (36, dict(decomposition="basis", num_bases=0)),
    (36, dict(decomposition="block", num_bases=2)),
    (36, dict(decomposition="basis", num_bases=1)),
    (36, dict()),
    (129, dict(decomposition="basis", num_bases=2)),
    (128, dict(decomposition="basis", num_bases=8)),
    (128, dict(decomposition="basis", num_bases=9)),
])
def test_merge_applicable(rels, kw):
    assert tco.merge_applicable(rels, **kw) == jco.merge_applicable(rels, **kw)
    assert tco.MERGED_MAX_RELS == jco.MERGED_MAX_RELS


@pytest.mark.parametrize("r,merged", [(5, True), (70, False)])
def test_edge_set_with_merged_layout(r, merged):
    """Attached as the JAX builder attaches it; skipped above 128 general
    relations (70 relations -> R' = 140)."""
    t = _reciprocal_graph(400, r, 2500, 13)
    got = tstruct.build_edge_set(t, 400, r, with_dst_layout=True,
                                 with_merged_layout=True)
    want = jstruct.build_edge_set(t, 400, r, with_dst_layout=True,
                                  with_merged_layout=True, prefer_native=False)
    assert (got.merged is not None) == merged == (want.merged is not None)
    if merged:
        _eq_merged(got.merged, want.merged)
    assert tstruct.build_edge_set(t, 400, r).merged is None


def test_merged_layout_to_device():
    t = _reciprocal_graph(300, 3, 1200, 14)
    es = tstruct.build_edge_set(t, 300, 3, with_dst_layout=True,
                                with_merged_layout=True)
    es = dataclasses.replace(es, merged=tco.build_merged_layout(
        es.dst, es.src, es.rel, es.val, 300, es.num_rels, dedup_k=2))
    dev = es.to("cpu")
    m = dev.merged
    assert m.src_sorted.dtype == torch.int32 and m.coeff.dtype == torch.float32
    assert m.layout.local_dst.dtype == torch.int32
    assert m.fwd_dedup.local_k.dtype == torch.int32
    np.testing.assert_array_equal(m.fwd_dedup.coeff_k.numpy(), es.merged.fwd_dedup.coeff_k)
    np.testing.assert_array_equal(m.rev_layout.perm.numpy(), es.merged.rev_layout.perm)
    assert m.num_pairs == es.merged.num_pairs and m.fwd_dedup.num_k == 2
