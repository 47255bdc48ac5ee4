"""The port's numpy graph builders are bit-equal to the JAX package's."""

import numpy as np
import pytest
import torch

from rgcn_tpu.data import synthetic as jsyn
from rgcn_tpu.graph import structure as jstruct
from rgcn_tpu.ops import pallas_aggregate as jagg
from rgcn_tpu_torch.data import synthetic as tsyn
from rgcn_tpu_torch.graph import structure as tstruct
from rgcn_tpu_torch.ops import aggregate as tagg
from tests.conftest import make_random_triples

EDGE_FIELDS = ["src", "dst", "rel", "val", "tile_rel"]
EDGE_META = ["num_nodes", "num_rels", "tile_size", "num_edges", "num_tiles"]
LAYOUT_FIELDS = ["perm", "local_dst", "chunk_block"]
LAYOUT_META = ["num_row_blocks", "row_block", "chunk", "num_chunks"]
FUSED_FIELDS = ["src", "val", "local_dst", "quantum_rel", "chunk_block"]
FUSED_META = ["num_row_blocks", "row_block", "chunk", "quantum", "num_chunks"]


def _eq_arrays(got, want, fields, what):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f"{what}.{f}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")


def _eq_meta(got, want, fields, what):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f"{what}.{f}"


def _chunk_fill(layout):
    """Real slots of each chunk, after checking that they fill a prefix of
    it (pads trail), that chunk_block is non-decreasing and that every row
    block owns a chunk."""
    real = layout.local_dst < layout.row_block
    fill = real.sum(axis=1)
    prefix = np.arange(layout.chunk)[None, :] < fill[:, None]
    np.testing.assert_array_equal(real, prefix)
    assert (np.diff(layout.chunk_block) >= 0).all()
    np.testing.assert_array_equal(np.unique(layout.chunk_block),
                                  np.arange(layout.num_row_blocks))
    return fill


def _eq_edge_set(got, want, what="es"):
    _eq_arrays(got, want, EDGE_FIELDS, what)
    _eq_meta(got, want, EDGE_META, what)
    _eq_arrays(got.layout, want.layout, LAYOUT_FIELDS, f"{what}.layout")
    _eq_meta(got.layout, want.layout, LAYOUT_META, f"{what}.layout")
    _eq_arrays(got.fused, want.fused, FUSED_FIELDS, f"{what}.fused")
    _eq_meta(got.fused, want.fused, FUSED_META, f"{what}.fused")
    _chunk_fill(got.layout)


def _graph(kind):
    rng = np.random.default_rng(7)
    if kind == "isolated_nodes":  # most nodes touch no edge
        return make_random_triples(rng, 30, 3, 40) * np.array([3, 1, 3]), 100, 3, {}
    if kind == "empty_relations":  # relations 1, 3, 4 never occur
        t = make_random_triples(rng, 70, 6, 300)
        t = t[np.isin(t[:, 1], [0, 2, 5])]
        return t, 70, 6, {}
    if kind == "several_row_blocks":
        return make_random_triples(rng, 1400, 5, 5000), 1400, 5, {}
    if kind == "custom_row_block":
        return (make_random_triples(rng, 500, 4, 2500), 500, 4,
                dict(layout_row_block=64, tile_size=16))
    if kind == "small_tiles":
        return (make_random_triples(rng, 90, 7, 400), 90, 7,
                dict(tile_size=8))
    raise ValueError(kind)


@pytest.mark.parametrize(
    "kind",
    ["isolated_nodes", "empty_relations", "several_row_blocks",
     "custom_row_block", "small_tiles"],
)
def test_edge_set_bit_equal(kind):
    triples, n, r, kw = _graph(kind)
    got = tstruct.build_edge_set(triples, n, r, with_dst_layout=True, **kw)
    want = jstruct.build_edge_set(
        triples, n, r, with_dst_layout=True, prefer_native=False, **kw
    )
    _eq_edge_set(got, want)
    _eq_edge_set(got.reverse, want.reverse, "reverse")
    assert got.reverse.reverse is None and want.reverse.reverse is None


def test_edge_set_without_layout():
    rng = np.random.default_rng(3)
    t = make_random_triples(rng, 50, 4, 200)
    got = tstruct.build_edge_set(t, 50, 4, tile_size=16)
    want = jstruct.build_edge_set(t, 50, 4, tile_size=16, prefer_native=False)
    _eq_arrays(got, want, EDGE_FIELDS, "es")
    _eq_meta(got, want, EDGE_META, "es")
    assert got.layout is None and got.fused is None and got.reverse is None


def test_aifb_like_identical():
    got, want = tsyn.aifb_like(), jsyn.aifb_like()
    np.testing.assert_array_equal(got.triples, want.triples)
    assert got.train == want.train and got.test == want.test
    assert got.i2n == want.i2n and got.i2r == want.i2r
    assert (got.num_nodes, got.num_relations, got.num_classes) == (8285, 45, 4)
    np.testing.assert_array_equal(got.index_labels(got.test)[1],
                                  want.index_labels(want.test)[1])
    es = tstruct.build_edge_set(got.triples, got.num_nodes, got.num_relations,
                                with_dst_layout=True)
    # the nc-AIFB shapes the kernels are sized for
    assert es.src.shape == (61440,) and es.num_tiles == 480
    assert es.layout.perm.shape == (66816,) and es.layout.num_row_blocks == 65
    assert es.fused.src.shape == (151552,) and es.fused.num_row_blocks == 17


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_nc_identical(seed):
    kw = dict(num_nodes=300, num_rels=5, num_edges=900, num_classes=3,
              seed=seed)
    got = tsyn.synthetic_node_classification(**kw)
    want = jsyn.synthetic_node_classification(**kw)
    np.testing.assert_array_equal(got.triples, want.triples)
    assert got.train == want.train and got.test == want.test


@pytest.mark.parametrize("row_block,chunk", [(64, 64), (128, 256)])
def test_dst_layout_bit_equal(row_block, chunk):
    rng = np.random.default_rng(11)
    dst = rng.integers(0, 301, 700).astype(np.int32)  # 300 = pad edges
    got = tagg.build_dst_layout(dst, 300, row_block=row_block, chunk=chunk)
    want = jagg.build_dst_layout(dst, 300, row_block=row_block, chunk=chunk,
                                 prefer_native=False)
    _eq_arrays(got, want, LAYOUT_FIELDS, "layout")
    _eq_meta(got, want, LAYOUT_META, "layout")
    _chunk_fill(got)


def test_skewed_layouts_bit_equal_and_filled():
    """The skewed graph the kernel tests use (a hub spanning many chunks,
    row blocks of pads only): the JAX-equal fields stay bit-equal, the
    hub's chunks are full and the empty blocks' chunks hold pads only."""
    t = tsyn.skew_triples()
    got = tstruct.build_edge_set(t, 1536, 4, with_dst_layout=True)
    want = jstruct.build_edge_set(t, 1536, 4, with_dst_layout=True,
                                  prefer_native=False)
    _eq_edge_set(got, want)
    _eq_edge_set(got.reverse, want.reverse, "reverse")
    lay = got.layout
    fill = _chunk_fill(lay)
    hub = lay.chunk_block == 0
    assert hub.sum() > 4 and (fill[hub][:-1] == lay.chunk).all()
    empty = (lay.chunk_block >= 4) & (lay.chunk_block < 8)  # nodes 512..1023
    assert empty.sum() == 4 and (fill[empty] == 0).all()


def test_aifb_like_chunk_fill():
    """At nc-AIFB each chunk's real slots fill a prefix of it: 58,000 of the
    layout's 66,816 slots, the rest trailing pads a K1 warp skips after
    one vote."""
    d = tsyn.aifb_like()
    es = tstruct.build_edge_set(d.triples, d.num_nodes, d.num_relations,
                                with_dst_layout=True)
    assert int(_chunk_fill(es.layout).sum()) == 58_000 == es.num_edges


@pytest.mark.parametrize("n", [1, 1000, 82_000, 300_000, 2_000_000])
def test_auto_nc_row_block(n):
    assert tstruct.auto_nc_row_block(n) == jstruct.auto_nc_row_block(n)


@pytest.mark.parametrize("num_edges", [1, 300])
def test_edge_normalization(num_edges):
    rng = np.random.default_rng(2)
    rel = rng.integers(0, 4, num_edges)
    dst = rng.integers(0, 40, num_edges)
    got = tstruct.edge_normalization(rel, dst, 40)
    want = jstruct.edge_normalization(rel, dst, 40)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_edge_set_to_device_keeps_values():
    rng = np.random.default_rng(4)
    t = make_random_triples(rng, 60, 3, 200)
    es = tstruct.build_edge_set(t, 60, 3, tile_size=16, with_dst_layout=True)
    dev = es.to("cpu")
    assert dev.src.dtype == torch.int32 and dev.val.dtype == torch.float32
    assert dev.layout.perm.dtype == torch.int32
    assert dev.fused.quantum_rel.dtype == torch.int32
    np.testing.assert_array_equal(dev.reverse.fused.val.numpy(), es.reverse.fused.val)
    np.testing.assert_array_equal(dev.layout.chunk_block.numpy(),
                                  es.layout.chunk_block)
    assert dev.num_tiles == es.num_tiles and dev.layout.num_chunks == es.layout.num_chunks
