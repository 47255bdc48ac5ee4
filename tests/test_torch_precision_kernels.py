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


# -- the layouts K1's owned-row route and K5's passes meet on the card --------
#
# The kernels' ownership rules lean on these layouts' shapes; here the plain
# versions are held against the Pallas kernels on them (the card holds the
# kernels against the plain versions on the same shapes,
# tests/test_torch_kernels_gpu.py).

# (row_block, chunk, pad-only chunks appended, node count): at CH 16 the
# hub's destination spans dozens of chunks (far more than a cluster of
# CTAs holds); single-chunk blocks; a node count off the row blocks (381)
K1_LAYOUTS = [(64, 16, 2, 381), (48, 32, 0, 384), (32, 128, 1, 381)]


def _skew_dst(n):
    """Destinations of the hub graph, both directions (pads ``n``): node 7
    receives ~1,000 edges, nodes 128-191 none."""
    from rgcn_tpu_torch.data.synthetic import skew_triples

    t = skew_triples(num_nodes=384, num_rels=4, num_edges=900, hub=7, hub_edges=900,
                     isolated=(128, 192))
    dst = np.concatenate([t[:, 2], t[:, 0]]).astype(np.int64)
    src = np.concatenate([t[:, 0], t[:, 2]]).astype(np.int64)
    return np.where((dst < n) & (src < n), dst, n), src


def _k1_layouts(geometry, **kw):
    from rgcn_tpu.ops import pallas_aggregate as jagg

    rb, ch, extra, n = geometry
    dst, src = _skew_dst(n)
    pad_to = tagg.build_dst_layout(dst, n, rb, ch).perm.shape[0] + extra * ch if extra else None
    jlay = jagg.build_dst_layout(dst, n, rb, ch, pad_to=pad_to, prefer_native=False, **kw)
    tlay = tagg.build_dst_layout(dst, n, rb, ch, pad_to=pad_to, **kw)
    for f in ("perm", "local_dst", "chunk_block"):
        np.testing.assert_array_equal(np.asarray(getattr(tlay, f)), np.asarray(getattr(jlay, f)))
    return jlay, tlay.to("cpu"), n


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("dout", [10, 16, 32, 200])
@pytest.mark.parametrize("geometry", K1_LAYOUTS, ids=lambda g: "rb{}-ch{}-pad{}-n{}".format(*g))
def test_plain_k1_bf16_adversarial_layouts(geometry, dout, out):
    """K1's plain version on bf16 messages against the Pallas kernel: f32
    sums within 1e-5·max(1, max|ref|); a bf16 output rounded once from the
    f32 sum (within half a bf16 ulp of JAX's f32 sum), so nearer it than
    JAX's bf16 output, which rounds each chunk's partial: over the hub's
    dozens of chunks that drifts past the JAX package's own 8e-3 bound."""
    jlay, lay, n = _k1_layouts(geometry)
    rb, ch, extra, _ = geometry
    local, cb = np.asarray(lay.local_dst), np.asarray(lay.chunk_block)
    hub_chunks = int(((local == 7) & (cb[:, None] == 0)).any(1).sum())
    assert hub_chunks >= (3 if ch <= 32 else 2)  # one destination over several chunks
    assert (np.bincount(cb) == 1).any()  # single-chunk row blocks
    assert int((local >= rb).all(1).sum()) >= extra  # pad-only chunks
    rng = np.random.default_rng(dout + ch)
    msgs = torch.from_numpy(_f32(rng, lay.num_chunks * lay.chunk, dout)).to(BF16)
    jm = jnp.asarray(msgs.float().numpy()).astype(jnp.bfloat16)
    ref32 = np.asarray(aggregate_presorted_pallas(jm, jlay, n, interpret=True))
    if out == "f32":
        got = tagg.aggregate_presorted(msgs, lay, n)
        np.testing.assert_allclose(got.numpy(), ref32, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(ref32).max())))
        return
    got = tagg.aggregate_presorted(msgs, lay, n, out_dtype=BF16)
    want = np.asarray(aggregate_presorted_pallas(jm, jlay, n, out_dtype=jnp.bfloat16,
                                                 interpret=True).astype(jnp.float32))
    assert got.dtype == BF16
    mine = np.abs(got.float().numpy() - ref32)
    assert (mine <= (2.0 ** -8) * np.abs(ref32) + 1e-5 * max(1.0, float(np.abs(ref32).max()))).all()
    assert float(mine.max()) <= float(np.abs(want - ref32).max())
    assert torch.equal(got, tagg.aggregate_presorted(msgs, lay, n).to(BF16))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("kernel,kk", [("k5", 2), ("k5", 3), ("k4", 1),
                                       ("k4-per-basis-sum", 1)])
def test_plain_k4_k5_bf16_many_chunk_blocks(kernel, kk, out):
    """K5 (dedup frame) and K4 (merged frame) on a bf16 table against the
    Pallas kernels where the hub's row block holds 40 and more chunks of 8
    (K5 meets 23 at lp-WN18, K1 219 at nc-AM), beside single-chunk blocks
    (the isolated nodes'), with a node count off the row blocks (380 over
    blocks of 16); K4 also with per-basis tables summed over bases (the
    basis VJP's dx)."""
    n, r, din, nb = 380, 4, 16, 2
    from rgcn_tpu_torch.data.synthetic import skew_triples

    t = skew_triples(num_nodes=n, num_rels=r, num_edges=900, hub=7, hub_edges=900,
                     isolated=(128, 192))
    jes = j_build(t, n, r, tile_size=16, prefer_native=False)
    args = (jes.dst, jes.src, jes.rel, jes.val, n, jes.num_rels)
    mkw = dict(row_block=16, chunk=8, dedup_k=max(kk, 2))
    jm, tm = jco.build_merged_layout(*args, **mkw), tco.build_merged_layout(*args, **mkw).to("cpu")
    frame = tm.fwd_dedup if kernel == "k5" else tm.layout
    counts = np.bincount(np.asarray(frame.chunk_block))
    assert counts.max() >= 40 and (counts == 1).any()
    rng = np.random.default_rng(kk + 10)
    x = torch.from_numpy(_f32(rng, n, din)).to(BF16)
    xj = jnp.asarray(x.float().numpy())
    out_dtype = BF16 if out == "bf16" else torch.float32
    if kernel == "k5":
        dd, jdd = tm.fwd_dedup, jm.fwd_dedup
        w_k = _f32(rng, dd.num_k, nb, dd.num_chunks * dd.chunk)
        got = tbasis.weighted_aggregate_dedup(x, dd.src_sorted, torch.from_numpy(w_k), dd, n,
                                              out_dtype=out_dtype)
        want = j_k5(xj[jnp.asarray(jdd.src_sorted)], jnp.asarray(w_k), jdd, n,
                    compute_dtype=jnp.bfloat16)
    else:
        lay, jlay = tm.layout, jm.layout
        w = _f32(rng, nb, lay.num_chunks * lay.chunk)
        per_basis = kernel == "k4-per-basis-sum"
        if per_basis:
            x = torch.from_numpy(_f32(rng, nb, n, din)).to(BF16)
            xj = jnp.asarray(x.float().numpy())
        src = jnp.asarray(jm.src_sorted)
        got = tbasis.weighted_aggregate(x, tm.src_sorted, torch.from_numpy(w), lay, n,
                                        sum_bases=per_basis, out_dtype=out_dtype)
        want = j_k4(xj[:, src] if per_basis else xj[src], jnp.asarray(w), jlay, n,
                    sum_bases=per_basis, compute_dtype=jnp.bfloat16)
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    if out == "bf16":
        tol = tol + (2.0 ** -8) * np.abs(want)
    assert got.dtype == out_dtype
    assert (np.abs(got.float().numpy() - want) <= tol).all()


def test_dst_layout_records_its_order():
    """``DstLayout.dst_sorted``: True from every builder but the
    source-ordered forms (host and device), on which K1 in either form
    takes its atomics route; kept across ``.to``."""
    from rgcn_tpu_torch.graph import dynamic as tdyn
    from rgcn_tpu_torch.ops import distmult_train as tdm

    dst, src = _skew_dst(381)
    assert tagg.build_dst_layout(dst, 381, 64, 16).dst_sorted
    assert tagg.build_dst_layout(dst, 381, 64, 16, prefer_native=False).dst_sorted
    by_src = tagg.build_dst_layout(dst, 381, 64, 16, src=src)
    assert not by_src.dst_sorted and not by_src.to("cpu").dst_sorted
    assert tdm.padded_layout(dst, 381, 64, 16).dst_sorted
    tdst = torch.from_numpy(dst.astype(np.int32))
    assert tdyn.build_dst_layout_dynamic(tdst, 381, 64, 16).dst_sorted
    dyn_src = tdyn.build_dst_layout_dynamic(tdst, 381, 64, 16,
                                            src=torch.from_numpy(src.astype(np.int32)))
    assert not dyn_src.dst_sorted
    # a destination-sorted layout's slots ascend within each row block
    for lay in (tagg.build_dst_layout(dst, 381, 64, 16),
                tdyn.build_dst_layout_dynamic(tdst, 381, 64, 16)):
        local = np.asarray(lay.local_dst).reshape(-1)
        block = np.repeat(np.asarray(lay.chunk_block), lay.chunk)
        same = block[1:] == block[:-1]
        assert (local[1:][same] >= local[:-1][same]).all()
