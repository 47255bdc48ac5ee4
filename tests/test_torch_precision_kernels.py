"""The plain versions of K1, K4 and K5 on bf16 tables and messages, on the
CPU, against the Pallas kernels with a bf16 compute dtype (interpret
mode): K1's f32 sums of bf16 messages; K4 (shared table, and per-basis
tables summed over bases) and K5 with an f32 and a bf16 output. The
products of bf16 values are exact, so the f32 sums differ only by their
order (1e-5·max(1, max|ref|)) and a bf16 output by half a bf16 ulp more
(2^-8·|ref|). Other dtypes, and a bf16 output of an f32 table, raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.graph import coalesce as jco
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.ops.pallas_aggregate import aggregate_presorted_pallas
from rgcn_tpu.ops.pallas_basis import weighted_aggregate_dedup_pallas as j_k5
from rgcn_tpu.ops.pallas_basis import weighted_aggregate_pallas as j_k4
from rgcn_tpu_torch.graph import coalesce as tco
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.ops import aggregate as tagg
from rgcn_tpu_torch.ops import basis as tbasis
from tests.conftest import make_random_triples
from tests.test_torch_precision import BF16, _f32, _reciprocal


def test_plain_k1_bf16_matches_pallas():
    n, d = 100, 12
    t = make_random_triples(np.random.default_rng(0), n, 3, 500)
    es = build_edge_set(t, n, 3, tile_size=16, with_dst_layout=True).to("cpu")
    lay = es.layout
    msgs = torch.from_numpy(_f32(np.random.default_rng(1), lay.num_chunks * lay.chunk, d))
    m16 = msgs.to(BF16)
    got = tagg.aggregate_presorted(m16, lay, n)
    assert got.dtype == torch.float32
    jlay = j_build(t, n, 3, tile_size=16, with_dst_layout=True, prefer_native=False).layout
    want = aggregate_presorted_pallas(jnp.asarray(m16.float().numpy()).astype(jnp.bfloat16),
                                      jlay, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(np.asarray(want)).max())))
    edge_msgs = torch.from_numpy(_f32(np.random.default_rng(2), lay.num_edges, d)).to(BF16)
    ref = tagg.aggregate_sorted(edge_msgs.float(), lay, n)
    assert torch.allclose(tagg.aggregate_sorted(edge_msgs, lay, n), ref, rtol=0, atol=1e-5)
    for bad in (torch.float16, torch.int32):
        with pytest.raises(TypeError, match="K1 takes float32 or bfloat16"):
            tagg.aggregate_presorted(msgs.to(bad), lay, n)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["k4", "k4-per-basis-sum", "k5"])
def test_plain_k4_k5_bf16_match_pallas(kernel, out):
    n, r, din, nb = 150, 4, 16, 2
    t, rng = _reciprocal(n, r, 600, seed=5)
    jes = j_build(t, n, r, tile_size=16, prefer_native=False)
    args = (jes.dst, jes.src, jes.rel, jes.val, n, jes.num_rels)
    mkw = dict(row_block=32, chunk=64, dedup_k=2)
    jm, tm = jco.build_merged_layout(*args, **mkw), tco.build_merged_layout(*args, **mkw)
    tm = tm.to("cpu")
    out_dtype = BF16 if out == "bf16" else torch.float32
    if kernel == "k5":
        dd, jdd = tm.fwd_dedup, jm.fwd_dedup
        x = _f32(rng, n, din)
        w_k = _f32(rng, dd.num_k, nb, dd.num_chunks * dd.chunk)
        xt = torch.from_numpy(x).to(BF16)
        got = tbasis.weighted_aggregate_dedup(xt, dd.src_sorted, torch.from_numpy(w_k), dd,
                                              n, out_dtype=out_dtype)
        xg = jnp.asarray(xt.float().numpy())[jnp.asarray(jdd.src_sorted)]
        want = j_k5(xg, jnp.asarray(w_k), jdd, n, compute_dtype=jnp.bfloat16)
    else:
        lay, jlay = tm.layout, jm.layout
        per_basis = kernel == "k4-per-basis-sum"
        x = _f32(rng, nb, n, din) if per_basis else _f32(rng, n, din)
        w = _f32(rng, nb, lay.num_chunks * lay.chunk)
        xt = torch.from_numpy(x).to(BF16)
        got = tbasis.weighted_aggregate(xt, tm.src_sorted, torch.from_numpy(w), lay, n,
                                        sum_bases=per_basis, out_dtype=out_dtype)
        xj = jnp.asarray(xt.float().numpy())
        src = jnp.asarray(jm.src_sorted)
        xg = xj[:, src] if per_basis else xj[src]
        want = j_k4(xg, jnp.asarray(w), jlay, n, sum_bases=per_basis,
                    compute_dtype=jnp.bfloat16)
    assert got.dtype == out_dtype
    # the Pallas kernel's f32 sums: the products are exact, so the plain
    # version's f32 sums differ only by their order, and a bf16 output by
    # at most half a bf16 ulp more
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    if out == "bf16":
        tol = tol + (2.0 ** -8) * np.abs(want)
    assert (np.abs(got.float().numpy() - want) <= tol).all()
    for bad_x, bad_out in ((xt.to(torch.float16), torch.float32),
                           (xt.float(), BF16)):
        with pytest.raises(TypeError):
            if kernel == "k5":
                tbasis.weighted_aggregate_dedup(bad_x, dd.src_sorted, torch.from_numpy(w_k),
                                                dd, n, out_dtype=bad_out)
            else:
                tbasis.weighted_aggregate(bad_x, tm.src_sorted, torch.from_numpy(w), lay, n,
                                          sum_bases=per_basis, out_dtype=bad_out)
