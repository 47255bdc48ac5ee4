"""The dense layer's dW in a fixed order, against the JAX package, on the CPU.

``ops/rel_spmm.py::rel_spmm_weight_grad`` sums each relation's per-tile
partials in tile order (``torch.segment_reduce`` over the sorted
``tile_rel``) where it added them with ``index_add_``; the JAX package's
``_spmm_ad_bwd`` (``rgcn_tpu/ops/pallas_spmm.py:256-273``) sums them with
``segment_sum(indices_are_sorted=True)``. Held against it within
1e-5 * max(1, max|ref|) on layouts with several tiles per relation and a
relation with none, as the JAX tests run it (Pallas in interpret mode on
the CPU); the same bits on a second call; and CPU tensors take no kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.ops import pallas_spmm as jspmm
from rgcn_tpu_torch import kernels
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.ops import rel_spmm as trs
from tests.conftest import make_random_triples


def _graph(n, r, e, seed, tile, unused_rel):
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    if unused_rel:  # relation r - 1 (and its inverse) gets no edge
        t = t[t[:, 1] != r - 1]
    jes = j_build(t, n, r, tile_size=tile, with_dst_layout=True, prefer_native=False)
    tes = build_edge_set(t, n, r, tile_size=tile, with_dst_layout=True).to("cpu")
    return jes, tes, rng


@pytest.mark.parametrize("n,r,e,tile,din,dout,unused_rel", [
    (120, 3, 900, 8, 16, 4, False),   # ~19 tiles a relation
    (200, 4, 1500, 16, 5, 7, True),   # two relations with no tile
    (90, 2, 600, 4, 16, 16, False),   # ~75 tiles a relation
])
def test_weight_grad_matches_jax_segment_sum(n, r, e, tile, din, dout, unused_rel):
    jes, tes, rng = _graph(n, r, e, e + tile, tile, unused_rel)
    counts = np.bincount(tes.tile_rel.numpy(), minlength=tes.num_rels)
    assert counts.max() >= 8 and (counts.min() == 0) == unused_rel
    assert (np.diff(tes.tile_rel.numpy()) >= 0).all()  # sorted: a relation's tiles adjacent
    x = np.maximum(rng.standard_normal((n, din)).astype(np.float32), 0)
    w = (rng.standard_normal((tes.num_rels, din, dout)) * din ** -0.5).astype(np.float32)
    g = rng.standard_normal((n, dout)).astype(np.float32)
    _, want = jspmm._spmm_ad_bwd((jnp.asarray(x), jnp.asarray(w), jes), jnp.asarray(g))[:2]
    want = np.asarray(want)
    before = dict(kernels.LAUNCHES)
    got = trs.rel_spmm_weight_grad(tes, torch.from_numpy(x), torch.from_numpy(g),
                                   tes.num_rels)
    assert kernels.LAUNCHES == before
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= tol
    if unused_rel:
        assert not got[torch.from_numpy(counts == 0)].any()
    again = trs.rel_spmm_weight_grad(tes, torch.from_numpy(x), torch.from_numpy(g),
                                     tes.num_rels)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_weight_grad_is_each_relations_tile_sum():
    """The sum of a relation's partials in tile order: equal to the plain
    sum over that relation's tiles, taken one after another."""
    _, tes, rng = _graph(150, 3, 1000, 7, 8, False)
    x = torch.from_numpy(rng.standard_normal((150, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((150, 3)).astype(np.float32))
    got = trs.rel_spmm_weight_grad(tes, x, g, tes.num_rels)
    tile, nt = tes.tile_size, tes.num_tiles
    xg = x[tes.src.long()].reshape(nt, tile, -1)
    gd = (torch.cat([g, g.new_zeros(1, 3)])[tes.dst.long()] * tes.val[:, None]).reshape(
        nt, tile, -1)
    partials = torch.bmm(xg.transpose(1, 2), gd)
    for rel in range(tes.num_rels):
        want = torch.zeros(6, 3)
        for i in torch.nonzero(tes.tile_rel == rel).reshape(-1).tolist():
            want = want + partials[i]
        torch.testing.assert_close(got[rel], want, rtol=0, atol=1e-5)
