"""K4/K5's node-major output on the CPU: the plain versions return ``(nb,
N, din)`` views of node-major ``(N, nb, din)`` storage with the values of
the JAX package's Pallas kernels (interpret mode), and ``rel_spmm_basis``
closes with one ``(N, nb·din) @ (nb·din, dout)`` product over that storage,
equal to the JAX merged forward (``rel_spmm_basis_merged_ad``).

Tolerance atol 1e-5 on unit-scale inputs (f32 sums in another order), and
1e-5·max(1, max|ref|) for the full product.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.graph import coalesce as jco
from rgcn_tpu.ops import pallas_basis as jpb
from rgcn_tpu_torch.graph import coalesce as tco
from rgcn_tpu_torch.graph.structure import build_edge_set as t_build
from rgcn_tpu_torch.ops import basis as tb
from tests.test_torch_lp_ops import _f32, _merged_pair, _reciprocal

ATOL = 1e-5


def _node_major(got: torch.Tensor, shape) -> None:
    assert tuple(got.shape) == tuple(shape)
    assert got.permute(1, 0, 2).is_contiguous()


@pytest.mark.parametrize("nb,din,per_basis,sum_bases", [
    (2, 200, False, False), (1, 7, False, False), (3, 13, True, False),
    (8, 6, False, True), (2, 9, True, True),
])
def test_k4_plain_is_node_major_and_matches_pallas(nb, din, per_basis, sum_bases):
    n = 300
    jm, tm, _, rng = _merged_pair(n, 4, 1200, nb * 7 + din, row_block=64, chunk=128)
    lay = tm.layout
    x = _f32(rng, *((nb, n, din) if per_basis else (n, din)))
    w = _f32(rng, nb, lay.num_chunks * lay.chunk) \
        * (np.asarray(jm.layout.local_dst).reshape(-1) < lay.row_block)
    src = np.asarray(jm.src_sorted)
    want = jpb.weighted_aggregate_pallas(
        jnp.asarray(x[:, src] if per_basis else x[src]), jnp.asarray(w), jm.layout,
        n, sum_bases=sum_bases, compute_dtype=None, interpret=True)
    got = tb.weighted_aggregate(torch.from_numpy(x), tm.src_sorted,
                                torch.from_numpy(w), lay, n, sum_bases=sum_bases)
    _node_major(got, want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kk,nb,din", [(2, 2, 200), (3, 3, 10)])
def test_k5_plain_is_node_major_and_matches_pallas(kk, nb, din):
    n = 400
    jm, tm, r_gen, rng = _merged_pair(n, 3, 2000, kk * 5 + nb, dedup_k=kk,
                                      row_block=64, chunk=128)
    jd, td = jm.fwd_dedup, tm.fwd_dedup
    w_k = np.einsum("klr,rb->kbl", np.asarray(jd.coeff_k),
                    _f32(rng, r_gen, nb)).astype(np.float32)
    x = _f32(rng, n, din)
    want = jpb.weighted_aggregate_dedup_pallas(
        jnp.asarray(x[np.asarray(jd.src_sorted)]), jnp.asarray(w_k), jd, n,
        compute_dtype=None, interpret=True)
    got = tb.weighted_aggregate_dedup(torch.from_numpy(x), td.src_sorted,
                                      torch.from_numpy(w_k), td, n)
    _node_major(got, want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("dedup_k", [0, 2])
def test_rel_spmm_basis_gemm_matches_jax_merged_forward(dedup_k):
    """The port's closing GEMM against ``rel_spmm_basis_merged_ad``'s einsum
    (f32, Pallas in interpret mode), over the merged and the dedup frame."""
    n, din, dout, nb = 300, 24, 16, 2
    t, rng = _reciprocal(n, 4, 1300, 40 + dedup_k)
    tes = t_build(t, n, 4, tile_size=16, with_dst_layout=True, with_merged_layout=True)
    args = (tes.dst, tes.src, tes.rel, tes.val, n, tes.num_rels)
    jm = jco.build_merged_layout(*args, dedup_k=dedup_k)
    tes = dataclasses.replace(tes, merged=tco.build_merged_layout(*args, dedup_k=dedup_k))
    x, comps = _f32(rng, n, din), _f32(rng, tes.num_rels, nb)
    bases = (_f32(rng, nb, din, dout) / np.sqrt(din)).astype(np.float32)
    want = np.asarray(jpb.rel_spmm_basis_merged_ad(
        jm, jnp.asarray(x), jnp.asarray(bases), jnp.asarray(comps),
        compute_dtype=None))
    got = tb.rel_spmm_basis(tes.to("cpu"), torch.from_numpy(x), torch.from_numpy(bases),
                            torch.from_numpy(comps)).numpy()
    assert got.shape == want.shape == (n, dout)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()))


def test_closing_product_reads_node_major_storage_without_a_copy():
    n, nb, din, dout = 50, 3, 8, 5
    rng = np.random.default_rng(7)
    agg = torch.from_numpy(_f32(rng, n, nb, din)).permute(1, 0, 2)  # (nb, N, din) view
    bases = torch.from_numpy(_f32(rng, nb, din, dout))
    flat = agg.permute(1, 0, 2).reshape(n, nb * din)
    assert flat.data_ptr() == agg.data_ptr() and flat._base is not None
    np.testing.assert_allclose(tb.closing_product(agg, bases).numpy(),
                               torch.einsum("bni,bio->no", agg, bases).numpy(),
                               rtol=0, atol=ATOL)
