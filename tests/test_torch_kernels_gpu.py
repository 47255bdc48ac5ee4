"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without CUDA (decided inside the fixture,
never at collection). Run on a GPU machine with

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

The shapes reach the kernels' edge cases the nc-AIFB run does not: K1 at
every lane mapping (dout 4, 16, 7 and 200: one, four, eight scalar and 32
lanes per slot, the last with two column groups), with and without the
perm index, on small chunks, and at nc-AM's widths (dout 10 and 11,
scalar lanes, also from a msgs view that is not 16-byte aligned, on a
random and the hub graph); K2 at several (din, dout), scalar and vector
gathers; the skewed graph (``skew_triples``: one destination spanning
many chunks, row blocks of pads only, all-gap fused chunks) and a node
count inside the layout's last block; K3 on both routes (the small f32 one
for dout <= 32, the tiled 3xTF32 one, held to the same tolerance) with din
and dout that are not multiples of its 32-deep, 128-wide slabs or of 4,
W[rel] far over 227 KB (lp-FB-toy's 500 x 500), nc-AM's layer-2
(10, 11), tiles with no real row and
zero-val rows in the middle, a relation whose tiles run past one CTA's
64-row window, tiles of one window and of several, into memory that held
NaN (every element is stored once, no memset); the lp-FB-toy encode
through exactly K3 and K1; the featureless basis forward (the
per-tile contraction in tile groups then K1, and K4 with sum_bases) and
the nc-MUTAG and 4-basis NC servers with their launch counts; K4 in both table forms (shared and per-basis rows), with
and without ``sum_bases``, for 1 to 8 bases and widths that are not a
multiple of 32, over merged and unmerged frames; K5 with 2 and 3 lanes;
K4 (every mode) and K5 on the hub graph's merged and dedup frames (one row
block over more than four chunks, pad-only chunks, rows no slot reaches),
for 1, 2, 3 and 8 bases, din 200 and widths that are not a multiple of 4,
into an output whose memory held NaN before (the launchers zero nothing
but the rows of row blocks with several chunks), checking that the result
is a view of node-major storage; K4 and K5 on rows wider than a CTA and on
a table that is not 16-byte aligned. Training: K1's and the SpMM's
autograd Functions with their backward on the card against the CPU (dx
through K2 at (dout, din), nc-AIFB's (4, 16) among them, or K3's small
route then K1; dW), the wrappers without a backward refusing grad, and
three epochs of NC training on the card against the CPU with exact launch
counts on both layer-2 routes. The pair path: ``aggregate_pairs`` forward
and backward (K1 over the composed layout, then over ``grad_layout``) at
nc-AM's widths with frozen and live values, on a graph whose hub pair
spans several chunks; ``gather_rows_agg``'s backward (K1 through the
by-source layout's perm) at dout 400 and 440, also with one source
owning thousands of rows; and three epochs of nc-MUTAG and nc-BGS with
exactly 8E + 2 K1 launches. LP training: the basis layer's Function on
a training subgraph (K4 forward, K4 dx over the reversed subgraph, whose
pad sources are one past the last row), the LP block layer (K3 then K1
both ways, the blocks' gradient through the expansion, no K2) and the
structured DistMult scorer (two K4 sums and K1 twice in its backward).
The paper's variants: the diagonal layer's Function (``rel_spmm_diag_ad``,
merged and unmerged frames, d 32 and 7) against the CPU and the plain
``rel_spmm_diag`` with exactly two K1 launches, the diagonal layer
refusing an EdgeSet without its layout, three epochs of e-RGCN on a
merged and an unmerged graph with exact launches, and the c-RGCN encoder's
gradients over a training subgraph (K3 then K1 both ways, per layer).
Tolerance: max abs diff <= 1e-5 * max(1, max|ref|) (f32 sums in another
order than the plain version's). Every test above runs the layers with the edge stage pinned to
f32 (``_edge_compute_dtype`` patched to None by the ``cuda`` fixture), so
each compares what it compared before the bf16 edge stage.

The bf16 forms (the ``cuda_bf16`` fixture leaves the card's default, a
bf16 edge stage): K1 on bf16 messages at widths 16, 32, 200, 12 (8-byte
vectors of 4), 10 and 7 (scalar lanes), from an unaligned view, with and
without the perm index, on a random and the hub graph; K4 (shared and
per-basis tables, with and without ``sum_bases``, 1 to 8 bases, din 200,
64, 40, 10 and 7) and K5 (2 and 3 lanes) on bf16 tables, with f32 and bf16
outputs, on the hub graph's frames (rows two chunks share, rows no slot
reaches) into memory that held NaN; each against its plain version with
f32 sums (1e-5·max(1, max|ref|)), a bf16 output within 2^-8·|ref| more,
exactly one launch of the bf16 entry point and none of the f32 one; the
wrappers refusing f16 tables and a bf16 output of an f32 table; and the
bf16 ops (the basis op over an unmerged, merged and dedup frame, the
featureless basis op with 4 bases, the diagonal op in both frames, the
pair op) on the card against the CPU's bf16 ops, forward and gradients,
within 8e-3·max(1, max|ref|), with their exact bf16 launches. K4's bf16
form's owned-row kernel (``csrc/k4_owned.cuh``) in every mode at 1,
2, 4 and 8 bases and din 16, 200, 400 and 10 (4-byte pieces, the row's
last vector masked; an unaligned table takes 2-byte pieces), on a layout
with a destination over 40 chunks and one over three, an empty block,
pad-only chunks and rows past the output, into NaN-filled memory, its
pads' weights NaN, its split-run counters left zero, on chunks of 16 and
64; the kernel read from the profile at every width, alignment and chunk
count (the owned-row kernel alone, one event a call); and its scratch and
per-stream counters. K4's f32 form on the same kernel (16-byte vectors of 4
values, 8- and 4-byte pieces at din 10, 7 and 3 and from an unaligned
table) over the same layout and one of more than 1,024 chunks, every mode,
the same bits on a second call. K1's lane map for widths that are not a
multiple of 4 (4-value lanes with a masked tail, in 8-, 4- or 2-byte
pieces) at widths 5, 6, 10, 11 and 13 and at e-RGCN nc-AM's diagonal
shape, both message forms, the same bits twice. A two-epoch lp-WN18 run
with the structural self-loop mask trained twice, bit-equal. K1's and K2's fixed-order designs (K1 in
both message forms and both outputs, K2 in both forms) over adversarial
layouts (a destination over 3+ chunks, pad-only chunks and gap quanta, a
whole row block past num_nodes, a source-ordered layout for K1, dout 4,
10, 16 and 32) into NaN-filled memory, exactly one launch a call and the
same bits on a second launch; their kernel names (one a call, no memset,
no narrowing kernel); the route rule's kernels; and nc-AIFB-like training
twice from one initialisation, bit-equal.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from rgcn_tpu_torch import kernels
from rgcn_tpu_torch.data.synthetic import skew_triples
from rgcn_tpu_torch.nn import layers as tlayers
from rgcn_tpu_torch.graph.structure import (auto_nc_row_block, build_edge_set,
                                            reweight_edge_set)
from rgcn_tpu_torch.graph.coalesce import build_merged_layout
from rgcn_tpu_torch.ops import aggregate as agg
from rgcn_tpu_torch.ops import basis as bs
from rgcn_tpu_torch.ops import fused as fz
from rgcn_tpu_torch.ops import rel_spmm as rs
from rgcn_tpu_torch.ops import spmm as sp
from tests.conftest import make_random_triples

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_bf16():
    """The card, with the edge stage's compute dtype as the layers choose it
    there (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def cuda(cuda_bf16, monkeypatch):
    """The card, with the layers' edge stage pinned to f32."""
    monkeypatch.setattr(tlayers, "_edge_compute_dtype", lambda device: None)
    return cuda_bf16


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= tol


def _nonzero(counts: dict) -> dict:
    """The kernels a run launched, with their counts."""
    return {k: v for k, v in counts.items() if v}


def _edges(n, r, e, seed, dev, **kw):
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    return build_edge_set(t, n, r, with_dst_layout=True, **kw).to(dev), rng


def _t(rng, dev, *shape, scale=1.0):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * scale).to(dev)


@pytest.mark.parametrize("dout,rb", [(16, 128), (4, 128), (200, 128), (7, 64)])
def test_k1(cuda, dout, rb):
    es, rng = _edges(900, 5, 4000, 1, cuda, layout_row_block=rb)
    msgs = _t(rng, cuda, es.src.shape[0], dout)
    n0 = kernels.LAUNCHES["k1_aggregate"]
    _close(agg.aggregate_sorted(msgs, es.layout, 900),
           agg.aggregate_sorted_plain(msgs, es.layout, 900))
    ms = _t(rng, cuda, es.layout.perm.shape[0], dout)
    _close(agg.aggregate_presorted(ms, es.layout, 900),
           agg.aggregate_presorted_plain(ms, es.layout, 900))
    assert kernels.LAUNCHES["k1_aggregate"] == n0 + 2


@pytest.mark.parametrize("graph", ["random", "hub"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dout", [10, 11])
def test_k1_nc_am_widths(cuda, dout, aligned, graph):
    """nc-AM's widths (layer 1 dout 10, layer 2 dout 11): scalar lanes, 16
    a slot; msgs also as a view whose rows start 4 bytes past a 16-byte
    boundary. On the hub graph one destination spans many chunks."""
    if graph == "hub":
        n = 1536
        es = build_edge_set(skew_triples(), n, 4, with_dst_layout=True).to(cuda)
        rng = np.random.default_rng(dout)
    else:
        n = 2000
        es, rng = _edges(n, 7, 9000, dout, cuda)
    rows = es.src.shape[0]
    flat = _t(rng, cuda, rows * dout + 1)
    msgs = (flat[:-1] if aligned else flat[1:]).view(rows, dout)
    n0 = kernels.LAUNCHES["k1_aggregate"]
    got = agg.aggregate_sorted(msgs, es.layout, n)
    _close(got, agg.aggregate_sorted_plain(msgs, es.layout, n))
    assert kernels.LAUNCHES["k1_aggregate"] == n0 + 1
    if graph == "hub":
        assert (got[512:1024] == 0).all()


def test_k1_small_chunks(cuda):
    rng = np.random.default_rng(2)
    dst = rng.integers(0, 301, 700).astype(np.int32)
    lay = agg.build_dst_layout(dst, 300, row_block=64, chunk=64).to(cuda)
    ms = _t(rng, cuda, lay.perm.shape[0], 9)
    _close(agg.aggregate_presorted(ms, lay, 300),
           agg.aggregate_presorted_plain(ms, lay, 300))


@pytest.mark.parametrize("dout", [4, 16, 7, 200])
def test_k1_skewed(cuda, dout):
    """A destination spanning many chunks, and row blocks of pads only."""
    es = build_edge_set(skew_triples(), 1536, 4, with_dst_layout=True).to(cuda)
    lay = es.layout
    hub_chunks = int((lay.chunk_block == 0).sum().item())
    pad_chunks = int((lay.local_dst >= lay.row_block).all(1).sum().item())
    assert hub_chunks > 4 and pad_chunks >= 4
    rng = np.random.default_rng(3)
    msgs = _t(rng, cuda, es.src.shape[0], dout)
    got = agg.aggregate_sorted(msgs, lay, 1536)
    _close(got, agg.aggregate_sorted_plain(msgs, lay, 1536))
    assert (got[512:1024] == 0).all()  # the isolated nodes' rows
    ms = _t(rng, cuda, lay.perm.shape[0], dout)
    _close(agg.aggregate_presorted(ms, lay, 1536),
           agg.aggregate_presorted_plain(ms, lay, 1536))


@pytest.mark.parametrize("dout", [4, 16])
def test_k1_drops_rows_past_the_output(cuda, dout):
    """A node count inside the layout's last block (300 nodes, 290 kept)."""
    rng = np.random.default_rng(4)
    dst = rng.integers(0, 301, 2000).astype(np.int32)
    lay = agg.build_dst_layout(dst, 300, row_block=64, chunk=64).to(cuda)
    ms = _t(rng, cuda, lay.perm.shape[0], dout)
    got = agg.aggregate_presorted(ms, lay, 290)
    assert got.shape == (290, dout)
    _close(got, agg.aggregate_presorted_plain(ms, lay, 300)[:290])


@pytest.mark.parametrize("din,dout", [(16, 4), (32, 40), (64, 8), (6, 5)])
def test_k2(cuda, din, dout):
    es, rng = _edges(1300, 6, 6000, 3, cuda)
    x = torch.relu(_t(rng, cuda, 1300, din))
    w = _t(rng, cuda, 12, din, dout, scale=din ** -0.5)
    assert rs.fused_fits(w, es.fused.row_block)
    n0 = kernels.LAUNCHES["k2_fused"]
    _close(fz.rel_spmm_fused(es.fused, 1300, x, w, compute_dtype=None),
           fz.rel_spmm_fused_plain(es.fused, 1300, x, w))
    assert kernels.LAUNCHES["k2_fused"] == n0 + 1


@pytest.mark.parametrize("din,dout", [(16, 4), (32, 40)])
def test_k2_skewed(cuda, din, dout):
    """A destination spanning more than four fused chunks, all-gap chunks,
    and a node count inside the last row block."""
    es = build_edge_set(skew_triples(), 1536, 4, with_dst_layout=True).to(cuda)
    fl = es.fused
    gap = (fl.quantum_rel.reshape(fl.num_chunks, -1) < 0).all(1)
    assert int((fl.chunk_block == 0).sum().item()) > 4 and bool(gap.any())
    rng = np.random.default_rng(5)
    x = torch.relu(_t(rng, cuda, 1536, din))
    w = _t(rng, cuda, 8, din, dout, scale=din ** -0.5)
    got = fz.rel_spmm_fused(fl, 1536, x, w, compute_dtype=None)
    _close(got, fz.rel_spmm_fused_plain(fl, 1536, x, w))
    assert (got[512:1024] == 0).all()
    got = fz.rel_spmm_fused(fl, 1500, x, w, compute_dtype=None)
    assert got.shape == (1500, dout)
    _close(got, fz.rel_spmm_fused_plain(fl, 1536, x, w)[:1500])


@pytest.mark.parametrize("din,dout", [(16, 4), (128, 128)])
def test_k3(cuda, din, dout):
    es, rng = _edges(500, 4, 2500, 4, cuda)
    x = _t(rng, cuda, 500, din)
    w = _t(rng, cuda, 8, din, dout, scale=din ** -0.5)
    n0 = kernels.LAUNCHES["k3_messages"]
    _close(rs.rel_spmm_messages(es, x, w), rs.rel_spmm_messages_plain(es, x, w))
    assert kernels.LAUNCHES["k3_messages"] == n0 + 1


def _k3_check(es, x, w):
    """K3 into memory that held NaN against its plain version; counts one
    launch."""
    junk = torch.full((es.src.shape[0], w.shape[-1]), float("nan"), device=x.device)
    del junk  # the caching allocator hands this memory to the output
    n0 = kernels.LAUNCHES["k3_messages"]
    got = rs.rel_spmm_messages(es, x, w)
    _close(got, rs.rel_spmm_messages_plain(es, x, w))
    assert kernels.LAUNCHES["k3_messages"] == n0 + 1
    assert (got[es.val == 0] == 0).all()


@pytest.mark.parametrize("din,dout", [
    (500, 500),  # lp-FB-toy: W[rel] 1 MB, 4 column slices, a partial one
    (37, 70),    # neither a multiple of 4: 4-byte copies
    (130, 260),  # multiples of 4, not of the 16-deep or 128-wide slabs
    (8, 33),     # just past the small route
    (16, 4),     # the small route (nc-AIFB's K3 branch)
    (10, 11),    # the small route at nc-AM layer 2: scalar rows
    (0, 40),     # no input columns: every message is 0
])
def test_k3_routes_and_ragged_widths(cuda, din, dout):
    es, rng = _edges(300, 5, 1800, 8, cuda)
    x = torch.relu(_t(rng, cuda, 300, din))
    w = _t(rng, cuda, 10, din, dout, scale=max(din, 1) ** -0.5)
    _k3_check(es, x, w)


@pytest.mark.parametrize("dout", [500, 4])
def test_k3_empty_tiles_and_dropped_rows(cuda, dout):
    """A tile whose rows all have val 0, and zero-val rows in the middle of
    others (dropped edges), come out 0."""
    es, rng = _edges(300, 5, 1800, 9, cuda)
    val = es.val.clone().reshape(es.num_tiles, es.tile_size)
    val[1] = 0
    val[3, ::3] = 0
    es = dataclasses.replace(es, val=val.reshape(-1))
    x = torch.relu(_t(rng, cuda, 300, 64))
    _k3_check(es, x, _t(rng, cuda, 10, 64, dout, scale=0.125))


@pytest.mark.parametrize("tile", [128, 256, 48])
def test_k3_long_relation_runs(cuda, tile):
    """One relation's tiles run far past one CTA's 64-row window (full
    tiles, then a partial one); tiles of 128 and 256 rows take two and
    four windows each, tiles of 48 one."""
    rng = np.random.default_rng(10)
    t = make_random_triples(rng, 400, 1, 1500)
    es = build_edge_set(t, 400, 1, tile_size=tile, with_dst_layout=True).to(cuda)
    assert int((es.tile_rel == 0).sum().item()) * tile > 4 * 128
    x = torch.relu(_t(rng, cuda, 400, 96))
    _k3_check(es, x, _t(rng, cuda, 2, 96, 200, scale=0.1))


def test_lp_fb_toy_encode_launches_k3_and_k1(cuda):
    """lp-FB-toy served at full width (500, 100 blocks): one encode is
    exactly one K3 (the expanded weights) and one K1; z equals the CPU
    plain run within 1e-4."""
    import os

    from rgcn_tpu_torch.data.synthetic import fb_toy_like
    from rgcn_tpu_torch.serve import load_lp_server

    cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "rgcn", "lp-FB-toy.yaml")
    kernels.reset_launches()
    srv = load_lp_server(cfg, fb_toy_like(), device=cuda)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == \
        {"k3_messages": 1, "k1_aggregate": 1}
    state = {k: v.cpu() for k, v in srv.model.state_dict().items()}
    cpu = load_lp_server(cfg, fb_toy_like(), state, device="cpu")
    assert srv.z.shape == (280, 500)
    assert (srv.z.cpu() - cpu.z).abs().max().item() <= 1e-4


@pytest.mark.parametrize("nb", [40, 4])
def test_featureless_basis_forward(cuda, nb):
    """Layer 1 of the many-basis NC configs: the basis rows gathered and
    contracted per tile (torch.bmm, in tile groups under a lowered budget)
    then K1 (nb 40), or K4 over the per-basis tables with sum_bases (nb
    4), through RGCNConv, against the plain path on the CPU."""
    from rgcn_tpu_torch.nn.layers import RGCNConv
    from rgcn_tpu_torch.ops import spmm as spmm_ops

    es, rng = _edges(1100, 6, 5000, 14, cuda)
    conv = RGCNConv(1100, 13, 10, decomposition="basis", num_bases=nb,
                    generator=torch.Generator().manual_seed(nb))
    with torch.inference_mode():
        want = conv(es.to("cpu"))
        conv = conv.to(cuda)
        budget = spmm_ops._ELEM_BUDGET
        spmm_ops._ELEM_BUDGET = es.tile_size * nb * 10 * 5
        try:
            before = dict(kernels.LAUNCHES)
            got = conv(es)
        finally:
            spmm_ops._ELEM_BUDGET = budget
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v > before[k]}
    assert used == ({"k1_aggregate": 1} if nb > 8 else {"k4_weighted_aggregate": 1})
    _close(got, want.to(cuda))


def test_nc_basis_servers_launch(cuda):
    """nc-MUTAG (30 bases) serves through exactly K1 and K2 once, an nc
    config with 4 bases through K4 twice; logits equal the CPU plain run
    within 1e-4 * max(1, max|ref|)."""
    import os

    from rgcn_tpu_torch.config import DecompositionConfig, load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_nc_data
    from rgcn_tpu_torch.serve import load_nc_server

    cfg = load_experiment(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "rgcn", "nc-MUTAG.yaml"))
    few = dataclasses.replace(cfg, rgcn=dataclasses.replace(
        cfg.rgcn, decomposition=DecompositionConfig("basis", num_bases=4)))
    data = synthetic_nc_data("MUTAG")
    for c, want in ((cfg, {"k1_aggregate": 1, "k2_fused": 1}),
                    (few, {"k4_weighted_aggregate": 2})):
        kernels.reset_launches()
        srv = load_nc_server(c, data, device=cuda)
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == want
        state = {k: v.cpu() for k, v in srv.model.state_dict().items()}
        cpu = load_nc_server(c, data, state, device="cpu")
        assert srv.logits.shape == (500, data.num_classes)
        tol = 1e-4 * max(1.0, float(np.abs(cpu.logits).max()))
        assert float(np.abs(srv.logits - cpu.logits).max()) <= tol


def test_fwd_spmm_branches(cuda):
    es, rng = _edges(700, 4, 3000, 5, cuda)
    for width in (16, 72):  # fits K2 / over budget: K3 then K1
        x = torch.relu(_t(rng, cuda, 700, width))
        w = _t(rng, cuda, 8, width, width, scale=width ** -0.5)
        before = dict(kernels.LAUNCHES)
        got = rs.fwd_spmm(es, x, w)
        ref = rs.fwd_spmm(es.to("cpu"), x.cpu(), w.cpu()).to(cuda)
        _close(got, ref)
        used = {k for k, v in kernels.LAUNCHES.items() if v > before[k]}
        fits = rs.fused_fits(w, es.fused.row_block)
        assert used == ({"k2_fused"} if fits else {"k3_messages", "k1_aggregate"})
    nofused = dataclasses.replace(es, fused=None)
    x = torch.relu(_t(rng, cuda, 700, 16))
    w = _t(rng, cuda, 8, 16, 4, scale=0.25)
    _close(rs.fwd_spmm(nofused, x, w), rs.fwd_spmm(es, x, w))


def test_wrappers_check_inputs(cuda):
    es, rng = _edges(200, 3, 800, 6, cuda)
    x = _t(rng, cuda, 200, 8)
    with pytest.raises(TypeError, match="dtype"):
        rs.rel_spmm_messages(es, x.double(), _t(rng, cuda, 6, 8, 4).double())
    with pytest.raises(ValueError, match="contiguous"):
        rs.rel_spmm_messages(es, x.t().contiguous().t(), _t(rng, cuda, 6, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fz.rel_spmm_fused(es.fused.to("cpu"), 200, x, _t(rng, cuda, 6, 8, 4), compute_dtype=None)


def _merged(n, r, e, seed, dev, dedup_k=0, reciprocal=True, **kw):
    """Merged pair layout of a random graph with parallel edges."""
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    if reciprocal:  # (s, p, o) and (o, p', s): inverse augmentation makes pairs
        t = np.unique(np.concatenate([t, t[: e // 2, ::-1]]), axis=0)
    es = build_edge_set(t, n, r, with_dst_layout=True)
    m = build_merged_layout(es.dst, es.src, es.rel, es.val, n, es.num_rels,
                            dedup_k=dedup_k, **kw)
    return m.to(dev), es.to(dev), rng


@pytest.mark.parametrize("nb,din,per_basis,sum_bases", [
    (2, 200, False, False), (1, 7, False, False), (3, 33, False, True),
    (8, 64, False, False), (2, 200, True, True), (3, 40, True, False),
    (8, 5, True, True),
])
def test_k4(cuda, nb, din, per_basis, sum_bases):
    m, _, rng = _merged(1500, 5, 7000, 7, cuda)
    lay = m.layout
    n_slots = lay.num_chunks * lay.chunk
    x = _t(rng, cuda, *((nb, 1500, din) if per_basis else (1500, din)))
    w = _t(rng, cuda, nb, n_slots) * (lay.local_dst.reshape(-1) < lay.row_block)
    n0 = kernels.LAUNCHES["k4_weighted_aggregate"]
    got = bs.weighted_aggregate(x, m.src_sorted, w, lay, 1500, sum_bases=sum_bases)
    ref = bs.weighted_aggregate_plain(x, m.src_sorted, w, lay, 1500,
                                      sum_bases=sum_bases)
    assert got.shape == (1 if sum_bases else nb, 1500, din)
    _close(got, ref)
    assert kernels.LAUNCHES["k4_weighted_aggregate"] == n0 + 1


def test_k4_unmerged_and_small_chunks(cuda):
    """The unmerged DstLayout frame (rel_spmm_basis without `merged`), and a
    64-slot chunk layout (a warp's slots cross no chunk end)."""
    m, es, rng = _merged(900, 4, 4000, 8, cuda, chunk=64)
    comps = _t(rng, cuda, es.num_rels, 2)
    src_sorted, wvec = bs.sorted_inputs(es, comps)
    x = _t(rng, cuda, 900, 48)
    _close(bs.weighted_aggregate(x, src_sorted, wvec, es.layout, 900),
           bs.weighted_aggregate_plain(x, src_sorted, wvec, es.layout, 900))
    w = bs.merged_wvec(m.coeff, comps)
    _close(bs.weighted_aggregate(x, m.src_sorted, w, m.layout, 900),
           bs.weighted_aggregate_plain(x, m.src_sorted, w, m.layout, 900))
    bases = _t(rng, cuda, 2, 48, 24)
    before = dict(kernels.LAUNCHES)
    got = bs.rel_spmm_basis(es, x, bases, comps)
    assert kernels.LAUNCHES["k4_weighted_aggregate"] == before["k4_weighted_aggregate"] + 1
    _close(got, bs.rel_spmm_basis(es.to("cpu"), x.cpu(), bases.cpu(),
                                  comps.cpu()).to(cuda))


@pytest.mark.parametrize("kk,nb,din", [(2, 2, 200), (3, 1, 17), (2, 5, 64)])
def test_k5(cuda, kk, nb, din):
    m, es, rng = _merged(1200, 4, 6000, 9, cuda, dedup_k=kk)
    dd = m.fwd_dedup
    comps = _t(rng, cuda, es.num_rels, nb)
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    x = _t(rng, cuda, 1200, din)
    n0 = kernels.LAUNCHES["k5_weighted_aggregate_dedup"]
    got = bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, 1200)
    _close(got, bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, 1200))
    assert kernels.LAUNCHES["k5_weighted_aggregate_dedup"] == n0 + 1
    # the same Agg as K4 over the plain merged frame
    _close(got, bs.weighted_aggregate_plain(
        x, m.src_sorted, bs.merged_wvec(m.coeff, comps), m.layout, 1200))


def test_k4_k5_wrappers_check_inputs(cuda):
    m, _, rng = _merged(300, 3, 1200, 10, cuda, dedup_k=2)
    lay, dd = m.layout, m.fwd_dedup
    x = _t(rng, cuda, 300, 8)
    w = _t(rng, cuda, 2, lay.num_chunks * lay.chunk)
    with pytest.raises(TypeError, match="dtype"):
        bs.weighted_aggregate(x.double(), m.src_sorted, w, lay, 300)
    with pytest.raises(ValueError, match="nb <= 8"):
        bs.weighted_aggregate(x, m.src_sorted, w.repeat(5, 1), lay, 300)
    with pytest.raises(ValueError, match="per-basis"):
        bs.weighted_aggregate(_t(rng, cuda, 3, 300, 8), m.src_sorted, w, lay, 300)
    w_k = _t(rng, cuda, 2, 2, dd.num_chunks * dd.chunk)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bs.weighted_aggregate_dedup(x, dd.src_sorted.cpu(), w_k, dd, 300)
    with pytest.raises(ValueError, match="do not fill"):
        kernels.launch_k4_weighted_aggregate(
            x, m.src_sorted, w, lay.local_dst, lay.chunk_block, 100,
            lay.row_block, lay.num_row_blocks)
    with pytest.raises(ValueError, match="do not fill"):
        kernels.launch_k5_weighted_aggregate_dedup(
            x, dd.src_sorted, w_k, dd.local_k, dd.chunk_block, 600,
            dd.row_block, dd.num_row_blocks)


def test_k4_k5_drop_rows_past_the_output(cuda):
    """A node count inside the layout's last block: the kernels drop the
    rows past it, as the plain versions' slice does (300 nodes, 290 kept)."""
    m, es, rng = _merged(300, 3, 1200, 11, cuda, dedup_k=2)
    lay, dd = m.layout, m.fwd_dedup
    x = _t(rng, cuda, 300, 40)
    comps = _t(rng, cuda, es.num_rels, 2)
    w = bs.merged_wvec(m.coeff, comps)
    got = bs.weighted_aggregate(x, m.src_sorted, w, lay, 290)
    assert got.shape == (2, 290, 40)
    _close(got, bs.weighted_aggregate_plain(x, m.src_sorted, w, lay, 300)[:, :290])
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    got = bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, 290)
    _close(got, bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, 300)[:, :290])


def _hub(dev, dedup_k=2):
    """The hub graph's merged layout (with its dedup frame) on the card."""
    es = build_edge_set(skew_triples(), 1536, 4, with_dst_layout=True)
    m = build_merged_layout(es.dst, es.src, es.rel, es.val, 1536, es.num_rels,
                            dedup_k=dedup_k)
    return m.to(dev), es.num_rels


def _nan_filled(*shape):
    """Free a NaN-filled block of the output's size, so the caching
    allocator hands that memory to the next ``torch.empty`` of the size."""
    junk = torch.full(shape, float("nan"), device="cuda")
    del junk


def _untouched(layout, local):
    """Nodes (of the first 1536) that no real lane of the frame reaches."""
    block = layout.chunk_block.long().repeat_interleave(layout.chunk)
    hit = torch.zeros(layout.num_row_blocks * layout.row_block, dtype=torch.bool,
                      device=local.device)
    for lk in local.reshape(-1, block.shape[0]):
        real = lk < layout.row_block
        hit[(block * layout.row_block + lk.long())[real]] = True
    return ~hit[:1536]


def _node_major(got, shape):
    assert tuple(got.shape) == shape
    assert got.permute(1, 0, 2).is_contiguous()


@pytest.mark.parametrize("nb,din,per_basis,sum_bases", [
    (2, 200, False, False), (1, 200, False, False), (3, 7, False, True),
    (8, 200, False, False), (2, 13, True, False), (3, 200, True, True),
    (8, 6, True, True), (2, 200, False, True),
])
def test_k4_hub_graph_node_major_no_memset(cuda, nb, din, per_basis, sum_bases):
    m, _ = _hub(cuda)
    lay = m.layout
    assert int((lay.chunk_block == 0).sum().item()) > 4
    assert int((lay.local_dst >= lay.row_block).all(1).sum().item()) >= 4
    rng = np.random.default_rng(nb * 100 + din)
    n_slots = lay.num_chunks * lay.chunk
    x = _t(rng, cuda, *((nb, 1536, din) if per_basis else (1536, din)))
    w = _t(rng, cuda, nb, n_slots) * (lay.local_dst.reshape(-1) < lay.row_block)
    n_out = 1 if sum_bases else nb
    _nan_filled(1536, n_out, din)
    got = bs.weighted_aggregate(x, m.src_sorted, w, lay, 1536, sum_bases=sum_bases)
    _node_major(got, (n_out, 1536, din))
    _close(got, bs.weighted_aggregate_plain(x, m.src_sorted, w, lay, 1536,
                                            sum_bases=sum_bases))
    untouched = _untouched(lay, lay.local_dst)
    assert bool(untouched[512:1024].all())
    assert (got[:, untouched] == 0).all()


@pytest.mark.parametrize("kk,nb,din", [(2, 2, 200), (2, 1, 7), (3, 3, 200),
                                       (2, 8, 13), (3, 2, 6)])
def test_k5_hub_graph_node_major_no_memset(cuda, kk, nb, din):
    m, r_gen = _hub(cuda, dedup_k=kk)
    dd = m.fwd_dedup
    assert int((dd.chunk_block == 0).sum().item()) > 4
    assert int((dd.local_k >= dd.row_block).all(0).all(1).sum().item()) >= 4
    rng = np.random.default_rng(kk * 100 + nb * 10 + din)
    comps = _t(rng, cuda, r_gen, nb)
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    x = _t(rng, cuda, 1536, din)
    _nan_filled(1536, nb, din)
    n0 = kernels.LAUNCHES["k5_weighted_aggregate_dedup"]
    got = bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, 1536)
    assert kernels.LAUNCHES["k5_weighted_aggregate_dedup"] == n0 + 1
    _node_major(got, (nb, 1536, din))
    _close(got, bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, 1536))
    untouched = _untouched(dd, dd.local_k)
    assert bool(untouched[512:1024].all())
    assert (got[:, untouched] == 0).all()
    _close(got, bs.weighted_aggregate_plain(
        x, m.src_sorted, bs.merged_wvec(m.coeff, comps), m.layout, 1536))


@pytest.mark.parametrize("chunk", [16, 256])
def test_k4_k5_sparse_rows_come_out_zero(cuda, chunk):
    """A sparse graph: most rows of every row block receive nothing, in
    blocks of one chunk (256) and of several (16); those rows must be
    exactly 0 though the output's memory held NaN."""
    m, es, rng = _merged(1500, 5, 300, 13, cuda, dedup_k=2, chunk=chunk)
    lay, dd = m.layout, m.fwd_dedup
    blocks = torch.bincount(lay.chunk_block.long())
    assert bool((blocks > 1).any()) == (chunk == 16)
    comps = _t(rng, cuda, es.num_rels, 2)
    x = _t(rng, cuda, 1500, 36)
    w = bs.merged_wvec(m.coeff, comps)
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    for got, ref, frame, local in (
        (lambda: bs.weighted_aggregate(x, m.src_sorted, w, lay, 1500),
         bs.weighted_aggregate_plain(x, m.src_sorted, w, lay, 1500), lay, lay.local_dst),
        (lambda: bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, 1500),
         bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, 1500), dd, dd.local_k),
    ):
        _nan_filled(1500, 2, 36)
        got = got()
        _node_major(got, (2, 1500, 36))
        _close(got, ref)
        untouched = _untouched(frame, local)[:1500]
        assert int(untouched.sum()) > 500
        assert (got[:, untouched] == 0).all()


@pytest.mark.parametrize("din", [200, 1100])
@pytest.mark.parametrize("aligned", [True, False])
def test_k4_k5_wide_and_unaligned_rows(cuda, din, aligned):
    """A row of more vectors than a CTA has threads (1100 columns: two
    column passes, five in scalars), and a table whose rows are not 16-byte
    aligned, which takes the scalar lanes."""
    m, r_gen = _hub(cuda)
    lay, dd = m.layout, m.fwd_dedup
    rng = np.random.default_rng(din)
    flat = _t(rng, cuda, 1536 * din + 1)
    x = (flat[:-1] if aligned else flat[1:]).view(1536, din)
    comps = _t(rng, cuda, r_gen, 2)
    w = bs.merged_wvec(m.coeff, comps)
    got = bs.weighted_aggregate(x, m.src_sorted, w, lay, 1536)
    _node_major(got, (2, 1536, din))
    _close(got, bs.weighted_aggregate_plain(x, m.src_sorted, w, lay, 1536))
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    got = bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, 1536)
    _node_major(got, (2, 1536, din))
    _close(got, bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, 1536))


def test_rel_spmm_basis_closes_with_one_gemm(cuda):
    """The encode's aggregation feeds the closing product without a copy:
    K4's storage is the GEMM's operand."""
    m, es, rng = _merged(800, 4, 3500, 12, cuda)
    es = dataclasses.replace(es, merged=m)
    x = _t(rng, cuda, 800, 40)
    comps = _t(rng, cuda, es.num_rels, 2)
    bases = _t(rng, cuda, 2, 40, 24)
    agg = bs.weighted_aggregate(x, m.src_sorted, bs.merged_wvec(m.coeff, comps),
                                m.layout, 800)
    assert agg.permute(1, 0, 2).reshape(800, 80).data_ptr() == agg.data_ptr()
    got = bs.rel_spmm_basis(es, x, bases, comps)
    _close(got, torch.einsum("bni,bio->no", agg.contiguous(), bases))


def _no_fused(es):
    return dataclasses.replace(es, fused=None,
                               reverse=dataclasses.replace(es.reverse, fused=None))


@pytest.mark.parametrize("dout", [16, 4, 11])
def test_k1_function_backward(cuda, dout):
    """K1's autograd Function on the card: forward K1, backward the gather
    g[dst] over a zero row for the pads, against the CPU."""
    es, rng = _edges(900, 5, 4000, 20 + dout, cuda)
    msgs = _t(rng, cuda, es.src.shape[0], dout) * es.val[:, None]
    g = _t(rng, cuda, 900, dout)
    grads = []
    for dev_es, m in ((es, msgs), (es.to("cpu"), msgs.cpu())):
        m = m.clone().requires_grad_()
        n0 = kernels.LAUNCHES["k1_aggregate"]
        out = agg.aggregate_sorted(m, dev_es.layout, 900, dst=dev_es.dst)
        out.backward(g.to(m.device))
        grads.append((out.detach(), m.grad, kernels.LAUNCHES["k1_aggregate"] - n0))
    (out, dm, launched), (ref_out, ref_dm, _) = grads
    assert launched == 1
    _close(out, ref_out.to(cuda))
    _close(dm, ref_dm.to(cuda))
    assert (dm[es.dst == 900] == 0).all()


@pytest.mark.parametrize("fused", [True, False], ids=["k2", "k3_k1"])
@pytest.mark.parametrize("din,dout", [(16, 4), (10, 11), (32, 40)])
def test_spmm_function_backward(cuda, fused, din, dout):
    """The SpMM Function's dx (the forward kernels over edges.reverse with
    Wᵀ: K2 at (dout, din), e.g. nc-AIFB's (4, 16), or K3's small route then
    K1) and dW on the card against the CPU, with the launches of one
    forward and one backward."""
    es, rng = _edges(1300, 6, 6000, din + dout, cuda)
    if not fused:
        es = _no_fused(es)
    x = torch.relu(_t(rng, cuda, 1300, din))
    w = _t(rng, cuda, es.num_rels, din, dout, scale=din ** -0.5)
    g = _t(rng, cuda, 1300, dout)
    got = {}
    for dev in (cuda, torch.device("cpu")):
        xt = x.detach().to(dev).requires_grad_()
        wt = w.detach().to(dev).requires_grad_()
        before = dict(kernels.LAUNCHES)
        out = rs.rel_spmm_ad(es.to(dev), xt, wt)
        out.backward(g.to(dev))
        used = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v > before[k]}
        got[dev.type] = (out.detach(), xt.grad, wt.grad, used)
    out, dx, dw, used = got["cuda"]
    for a, b in zip((out, dx, dw), got["cpu"][:3]):
        _close(a, b.to(cuda))
    assert got["cpu"][3] == {}
    assert used == ({"k2_fused": 2} if fused else {"k3_messages": 2, "k1_aggregate": 2})


def test_kernels_without_backward_refuse_grad(cuda):
    """K4 over the merged and featureless frames, K5, K2, K3 and K1
    presorted have no backward: on the card, grad mode with an input
    requiring grad raises before any launch; under no_grad they run. (The
    basis ops that call K4 and K5, rel_spmm_basis over any frame and
    rel_spmm_featureless_basis_fwd, are differentiable through their
    autograd Functions: test_basis_function_backward.)"""
    m, es, rng = _merged(600, 4, 2500, 21, cuda, dedup_k=2)
    es = dataclasses.replace(es, merged=m)
    x = _t(rng, cuda, 600, 8)
    bases = _t(rng, cuda, 2, 8, 5).requires_grad_()
    comps = _t(rng, cuda, es.num_rels, 2).requires_grad_()
    w = _t(rng, cuda, es.num_rels, 8, 3).requires_grad_()
    dd = m.fwd_dedup
    src_sorted, wvec = bs.sorted_inputs(es, comps)
    before = dict(kernels.LAUNCHES)
    for call in (
        lambda: bs.weighted_aggregate(x, m.src_sorted, bs.merged_wvec(m.coeff, comps),
                                      m.layout, 600),
        lambda: bs.weighted_aggregate(_t(rng, cuda, 2, 600, 5), src_sorted, wvec,
                                      es.layout, 600, sum_bases=True),
        lambda: bs.weighted_aggregate_dedup(
            x, dd.src_sorted, torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous(),
            dd, 600),
        lambda: fz.rel_spmm_fused(es.fused, 600, x, w, compute_dtype=None),
        lambda: rs.rel_spmm_messages(es, x, w),
        lambda: agg.aggregate_presorted(
            _t(rng, cuda, es.layout.perm.shape[0], 3).requires_grad_(), es.layout, 600),
    ):
        with pytest.raises(RuntimeError, match="no backward on the card"):
            call()
    assert kernels.LAUNCHES == before
    with torch.no_grad():
        bs.rel_spmm_basis(es, x, bases, comps)  # the dedup frame: K5
        bs.rel_spmm_basis(dataclasses.replace(es, merged=None), x, bases, comps)
        fz.rel_spmm_fused(es.fused, 600, x, w, compute_dtype=None)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v > before[k]}
    assert used == {"k5_weighted_aggregate_dedup": 1, "k4_weighted_aggregate": 1,
                    "k2_fused": 1}


def _train_on_card_and_cpu(cuda, config, edit=lambda es: es, epochs=3,
                           variant="rgcn", data=None):
    """``epochs`` of ``configs/<variant>/<config>`` on ``data`` (default
    the 500-node synthetic graph) from one initialisation, on the card and
    on the CPU (the EdgeSet passed through ``edit``): losses within rtol
    1e-4, accuracies equal. Returns the card run's launches."""
    import os

    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_node_classification
    from rgcn_tpu_torch.models.node_classification import build_nc_model
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    class Records(ScalarLogger):
        def __init__(self):
            super().__init__(verbose=False)
            self.records = []

        def log_scalar(self, metric, value, step=None):
            self.records.append((metric, step, float(value)))

    cfg = load_experiment(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", variant, config))
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training,
                                                                epochs=epochs))
    data = synthetic_node_classification(seed=0) if data is None else data
    init = build_nc_model(cfg, data, seed=0).state_dict()
    runs = {}
    for dev in ("cpu", cuda):
        t = NodeClassificationTrainer(cfg, data, init_params=init, device=dev)
        t.edges = edit(t.edges)
        rec = Records()
        kernels.reset_launches()
        t.fit(rec)
        torch.cuda.synchronize()
        runs[str(dev)] = (rec.records, {k: v for k, v in kernels.LAUNCHES.items() if v})
    (ref, none), (got, used) = runs["cpu"], runs["cuda"]
    assert none == {}
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    for (metric, _, v), (_, _, w) in zip(got, ref):
        if metric == "training.loss":
            assert abs(v - w) <= 1e-4 * abs(w)
        else:
            assert v == w
    return used


@pytest.mark.parametrize("fused", [True, False], ids=["k2", "k3_k1"])
def test_nc_training_on_the_card(cuda, fused):
    """Three epochs of the nc-AIFB config on the 500-node synthetic graph
    from one initialisation, on the card and on the CPU: losses within
    rtol 1e-4, accuracies equal, exact launch counts."""
    used = _train_on_card_and_cpu(cuda, "nc-AIFB.yaml",
                                  edit=(lambda es: es) if fused else _no_fused)
    assert used == ({"k1_aggregate": 7, "k2_fused": 10} if fused
                    else {"k1_aggregate": 17, "k3_messages": 10})


def _pair_edges(dev, seed):
    """A graph with a hub pair: node 7 is the subject of predicate 0
    towards 1,000 objects, so its inverse edges share one (src, rel)
    pair, whose slots span several chunks of grad_layout."""
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, 1200, 5, 6000)
    hub = np.array([[7, 0, o] for o in range(100, 1100)])
    t = np.unique(np.concatenate([t, hub]), axis=0)
    es = build_edge_set(t, 1300, 5, with_dst_layout=True, with_pair_index=True,
                        with_pair_agg=True)
    return es, rng


@pytest.mark.parametrize("frozen", [True, False], ids=["slot_val", "live_val"])
@pytest.mark.parametrize("dout", [10, 11])
def test_aggregate_pairs_forward_backward(cuda, dout, frozen):
    """The composed pair aggregation on the card against the CPU: forward
    K1 over the layout, backward K1 over grad_layout (d_m) and the value
    gradient; one launch each."""
    es, rng = _pair_edges(cuda, dout)
    if not frozen:
        es = reweight_edge_set(es, es.val * (rng.random(es.val.shape[0]) > 0.3))
    gl = es.pairs.agg.grad_layout
    hub_chunks = np.bincount(gl.chunk_block).max()
    assert hub_chunks > 4
    u_pad = es.pairs.pair_src.shape[0]
    m, g = _t(rng, cuda, u_pad, dout), _t(rng, cuda, 1300, dout)
    got = []
    for dev in (cuda, torch.device("cpu")):
        e = es.to(dev)
        mt = m.detach().to(dev).requires_grad_()
        vt = e.val.clone().requires_grad_()
        before = dict(kernels.LAUNCHES)
        out = agg.aggregate_pairs(mt, vt, e.pairs.edge_pair, e.dst, e.pairs.agg,
                                  e.layout, 1300)
        out.backward(g.to(dev))
        used = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v > before[k]}
        got.append((out.detach(), mt.grad, vt.grad, used))
    (*card, used), (*ref, none) = got
    for a, b in zip(card, ref):
        _close(a, b.to(cuda))
    assert used == {"k1_aggregate": 2} and none == {}


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("dout", [400, 440])
def test_gather_rows_agg_backward(cuda, dout, hub):
    """The wide gather's backward at the pair path's dT widths: K1 reads
    g's rows through the by-source layout's perm (4 column groups of 32
    lanes); with ``hub`` one source owns 5,000 of the 20,000 rows."""
    n = 3000
    rng = np.random.default_rng(dout + hub)
    idx = rng.integers(0, n, 20_000)
    if hub:
        idx[rng.choice(20_000, 5_000, replace=False)] = 7
    lay = agg.build_dst_layout(idx, n, row_block=auto_nc_row_block(n), chunk=256)
    if hub:
        assert np.bincount(lay.chunk_block).max() > 4
    table, g = _t(rng, cuda, n, dout), _t(rng, cuda, 20_000, dout)
    idx_t = torch.from_numpy(idx.astype(np.int32))
    got = []
    for dev in (cuda, torch.device("cpu")):
        tt = table.detach().to(dev).requires_grad_()
        before = kernels.LAUNCHES["k1_aggregate"]
        out = sp.gather_rows_agg(tt, idx_t.to(dev), lay.to(dev))
        out.backward(g.to(dev))
        got.append((out.detach(), tt.grad, kernels.LAUNCHES["k1_aggregate"] - before))
    (out, d_table, launched), (ref_out, ref_d, none) = got
    _close(out, ref_out.to(cuda))
    _close(d_table, ref_d.to(cuda))
    assert (launched, none) == (1, 0)


@pytest.mark.parametrize("config", ["nc-MUTAG.yaml", "nc-BGS.yaml"])
def test_many_basis_training_on_the_card(cuda, config):
    """Three epochs of the many-basis configs on the pair path: K1 only,
    8 a epoch (forward 2, backward 4, eval 2) and 2 for the final
    prediction."""
    assert _train_on_card_and_cpu(cuda, config) == {"k1_aggregate": 8 * 3 + 2}


# -- LP training: the basis Function, the block layer, the structured scorer --


def _lp_subgraph(n, r, b, seed, dev, tile=8):
    """An LP training subgraph with edge dropout, its layouts and reversed
    edges (forward pads become val-0 reverse edges whose source is n)."""
    from rgcn_tpu_torch.graph.dynamic import build_edge_set_dynamic_host

    rng = np.random.default_rng(seed)
    pos = make_random_triples(rng, n, r, b)
    es = build_edge_set_dynamic_host(
        pos, n, r, tile_size=tile, dropout_rate=0.3, dropout_rng=rng,
        with_dst_layout=True, row_block=64, layout_chunk=32)
    return pos, es.to("cpu"), es.to(dev), rng


def _grads_on_card_and_cpu(fn, inputs, dev, g):
    """fn's output and its inputs' gradients under the cotangent g, on the
    CPU and the card, and the card's launches."""
    out = []
    for d in ("cpu", dev):
        xs = [x.detach().to(d).requires_grad_() for x in inputs]
        before = dict(kernels.LAUNCHES)
        y = fn(d, *xs)
        y.backward(g.to(d))
        torch.cuda.synchronize()
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        out.append((y.detach().cpu(), [x.grad.cpu() for x in xs], launched))
    return out


@pytest.mark.parametrize("nb,din,dout", [(2, 200, 200), (3, 16, 12)])
def test_basis_function_backward(cuda, nb, din, dout):
    """rel_spmm_basis over a training subgraph on the card against the
    CPU: K4 forward, K4 over the reversed subgraph with per-basis tables
    for dx (its pad sources clamped), dbases and dcomps by products."""
    _, cpu_es, card_es, rng = _lp_subgraph(300, 4, 700, 31, cuda)
    ins = [_t(rng, "cpu", 300, din), _t(rng, "cpu", nb, din, dout, scale=0.1),
           _t(rng, "cpu", cpu_es.num_rels, nb)]
    g = _t(rng, "cpu", 300, dout)
    (ref, ref_g, _), (got, got_g, launched) = _grads_on_card_and_cpu(
        lambda d, *xs: bs.rel_spmm_basis(cpu_es if d == "cpu" else card_es, *xs),
        ins, cuda, g)
    _close(got, ref)
    for a, b in zip(got_g, ref_g):
        _close(a, b)
    assert launched["k4_weighted_aggregate"] == 2 and sum(launched.values()) == 2


def test_block_layer_backward(cuda):
    """The LP block layer over a training subgraph: K3 then K1 forward and
    dx (W^T over the reversed subgraph), the blocks' gradient through the
    expansion; K2 never (the subgraph has no fused layout)."""
    from rgcn_tpu_torch.nn.layers import RGCNConv

    _, cpu_es, card_es, rng = _lp_subgraph(120, 3, 300, 32, cuda)
    conv = RGCNConv(120, 7, 40, in_features=40, decomposition="block", num_blocks=4,
                    separate_self_weight=True, weight_init="schlichtkrull-normal",
                    weight_gain=False)
    x, g = _t(rng, "cpu", 120, 40), _t(rng, "cpu", 120, 40)
    res = []
    for d, es in (("cpu", cpu_es), (cuda, card_es)):
        c = copy.deepcopy(conv).to(d)
        xd = x.detach().to(d).requires_grad_()
        before = dict(kernels.LAUNCHES)
        y = c(es, xd)
        y.backward(g.to(d))
        torch.cuda.synchronize()
        res.append((y.detach().cpu(), xd.grad.cpu(), c.blocks.grad.cpu(),
                    c.self_weight.grad.cpu(),
                    {k: kernels.LAUNCHES[k] - before[k] for k in before}))
    for a, b in zip(res[1][:4], res[0][:4]):
        _close(a, b)
    assert _nonzero(res[1][4]) == {"k1_aggregate": 2, "k3_messages": 2}


@pytest.mark.parametrize("ns,d", [(10, 200), (3, 13)])
def test_structured_scorer_backward(cuda, ns, d):
    """The structured DistMult scorer on the card against the CPU: two K4
    sums over the corrupted entities' layout and K1 over the subjects' and
    objects' layouts in the backward, nothing in the forward."""
    from rgcn_tpu_torch.ops import distmult_train as dmt
    from rgcn_tpu_torch.train.negative import corrupt_batch_host

    rng = np.random.default_rng(33)
    n, r = 500, 6
    pos = make_random_triples(rng, n, r, 400)
    ch, ce = corrupt_batch_host(rng, pos, n, ns, 0.5, structure_only=True)
    lays = dmt.build_structured_layouts(pos, ce, ch, n, row_block=128, chunk=64)
    total = len(pos) * (1 + ns)
    out = []
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
        layouts = tuple(lay.to(dev) for lay in lays[:3]) + (tuple(t(a) for a in lays[3]),)
        nodes = _t(np.random.default_rng(1), dev, n, d).requires_grad_()
        rels = _t(np.random.default_rng(2), dev, r, d).requires_grad_()
        pw = torch.full((total,), 1.0 / total, device=dev)
        before = dict(kernels.LAUNCHES)
        s, p = dmt.structured_scores(t(pos), t(ch), t(ce), nodes, rels, pw, layouts)
        torch.autograd.backward([s, p], [torch.ones_like(s) / total, torch.ones_like(p)])
        torch.cuda.synchronize()
        out.append((s.detach().cpu(), p.detach().cpu(), nodes.grad.cpu(),
                    rels.grad.cpu(),
                    {k: kernels.LAUNCHES[k] - before[k] for k in before}))
    for a, b in zip(out[1][:4], out[0][:4]):
        _close(a, b)
    assert out[1][4]["k4_weighted_aggregate"] == 2 and out[1][4]["k1_aggregate"] == 2
    assert sum(out[1][4].values()) == 4


# -- the paper's variants: the diagonal layer (e-RGCN) and c-RGCN ---------------


def _diag_edges(merged, seed):
    """A graph with parallel edges (the same (s, o) pair under several
    relations): 6 relations merge, 70 (140 general) do not."""
    rng = np.random.default_rng(seed)
    r = 6 if merged else 70
    t = make_random_triples(rng, 900, r, 5000)
    extra = t[rng.random(len(t)) < 0.5].copy()
    extra[:, 1] = (extra[:, 1] + 1) % r
    t = np.unique(np.concatenate([t, extra]), axis=0)
    es = build_edge_set(t, 900, r, with_dst_layout=True, with_merged_layout=merged)
    assert (es.merged is not None) == merged
    return es, rng


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "unmerged"])
@pytest.mark.parametrize("d", [32, 7])
def test_diag_function_backward(cuda, merged, d):
    """rel_spmm_diag_ad on the card against the CPU (the same Function over
    K1's plain version) and the plain rel_spmm_diag: forward, dx, d dw;
    exactly K1 twice (the forward and dx), nothing else."""
    from rgcn_tpu_torch.ops.diag import rel_spmm_diag_ad

    es, rng = _diag_edges(merged, seed=41 + d)
    cpu_es, card_es = es.to("cpu"), es.to(cuda)
    ins = [_t(rng, "cpu", 900, d), _t(rng, "cpu", es.num_rels, d, scale=0.3)]
    g = _t(rng, "cpu", 900, d)
    (ref, ref_g, _), (got, got_g, launched) = _grads_on_card_and_cpu(
        lambda dev, *xs: rel_spmm_diag_ad(cpu_es if dev == "cpu" else card_es, *xs),
        ins, cuda, g)
    (plain, plain_g, _), _ = _grads_on_card_and_cpu(
        lambda dev, *xs: sp.rel_spmm_diag(cpu_es, *xs), ins, "cpu", g)
    _close(got, ref)
    _close(got, plain)
    for a, b, c in zip(got_g, ref_g, plain_g):
        _close(a, b)
        _close(a, c)
    assert _nonzero(launched) == {"k1_aggregate": 2}


def test_diag_layer_needs_its_layout_on_the_card(cuda):
    """No quiet fallback: the diagonal layer over an EdgeSet without a
    destination layout raises on the card (the plain path is the CPU's)."""
    from rgcn_tpu_torch.nn.layers import RGCNConv

    rng = np.random.default_rng(5)
    t = make_random_triples(rng, 50, 3, 200)
    es = build_edge_set(t, 50, 3).to(cuda)
    conv = RGCNConv(50, 7, 8, in_features=8, diag=True).to(cuda)
    with pytest.raises(ValueError, match="no destination layout"):
        conv(es, _t(rng, cuda, 50, 8))


@pytest.mark.parametrize("rels", [8, 70], ids=["merged", "unmerged"])
def test_ergcn_training_on_the_card(cuda, rels):
    """Three epochs of configs/e-rgcn/nc-AIFB.yaml on a 500-node graph on
    the card and on the CPU: losses within rtol 1e-4, accuracies equal;
    exactly K1 3E + 1 (the diagonal forward and dx, eval) and K2 3E + 1
    (layer 2 forward, dx, eval; W (2R, 32, 4) within fused_fits)."""
    from rgcn_tpu_torch.data.synthetic import synthetic_node_classification

    data = synthetic_node_classification(num_rels=rels, seed=0)
    used = _train_on_card_and_cpu(cuda, "nc-AIFB.yaml", variant="e-rgcn", data=data)
    assert used == {"k1_aggregate": 10, "k2_fused": 10}


@pytest.mark.parametrize("layers", [1, 2])
def test_crgcn_encode_backward(cuda, layers):
    """The c-RGCN encoder over a training subgraph on the card against the
    CPU: z and every parameter's gradient; its R-GCN at the compressed
    width runs K3 then K1 forward and for dx, per layer."""
    from rgcn_tpu_torch.models.link_prediction import CompressionRelationPredictor

    _, cpu_es, card_es, rng = _lp_subgraph(200, 4, 600, 34, cuda)
    model = CompressionRelationPredictor(200, 4, emb_dim=64, hidden1_size=10,
                                         num_layers=layers, bias_init="zeros",
                                         weight_init="schlichtkrull-normal")
    g = _t(rng, "cpu", 200, 64)
    res = []
    for d, es in (("cpu", cpu_es), (cuda, card_es)):
        m = copy.deepcopy(model).to(d)
        before = dict(kernels.LAUNCHES)
        z = m.encode(es)
        z.backward(g.to(d))
        torch.cuda.synchronize()
        res.append((z.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters()
                                       if p.grad is not None},
                    {k: kernels.LAUNCHES[k] - before[k] for k in before}))
    _close(res[1][0], res[0][0])
    assert set(res[1][1]) == set(res[0][1])
    for k, v in res[0][1].items():
        _close(res[1][1][k], v)
    assert _nonzero(res[1][2]) == {"k1_aggregate": 2 * layers, "k3_messages": 2 * layers}


# -- the bf16 forms of K1, K4 and K5 (the edge stage's compute dtype) ----------

BF16 = torch.bfloat16


def _launched(before):
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v > before[k]}


def _close_bf16_out(got, ref32):
    """A bf16 output against the plain version's f32 sums: half a bf16 ulp
    more than the f32 bound."""
    torch.cuda.synchronize()
    assert got.dtype == BF16 and got.shape == ref32.shape
    tol = 2.0 ** -8 * ref32.abs() + 1e-5 * max(1.0, ref32.abs().max().item())
    assert bool(((got.float() - ref32).abs() <= tol).all())


@pytest.mark.parametrize("graph", ["random", "hub"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dout", [16, 32, 200, 12, 10, 7])
def test_k1_bf16(cuda_bf16, dout, aligned, graph):
    if graph == "hub":
        n = 1536
        es = build_edge_set(skew_triples(), n, 4, with_dst_layout=True).to(cuda_bf16)
        rng = np.random.default_rng(dout)
    else:
        n = 900
        es, rng = _edges(n, 5, 4000, dout, cuda_bf16)
    rows, slots = es.src.shape[0], es.layout.perm.shape[0]
    flat = _t(rng, cuda_bf16, rows * dout + 1).to(BF16)
    msgs = (flat[:-1] if aligned else flat[1:]).view(rows, dout)
    ms = _t(rng, cuda_bf16, slots, dout).to(BF16)
    before = dict(kernels.LAUNCHES)
    got = agg.aggregate_sorted(msgs, es.layout, n)
    assert got.dtype == torch.float32
    _close(got, agg.aggregate_sorted_plain(msgs, es.layout, n))
    _close(agg.aggregate_presorted(ms, es.layout, n),
           agg.aggregate_presorted_plain(ms, es.layout, n))
    assert _launched(before) == {"k1_aggregate_bf16": 2}


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("nb,din,per_basis,sum_bases", [
    (2, 200, False, False), (1, 7, False, False), (3, 40, False, True),
    (8, 64, False, False), (2, 200, True, True), (3, 40, True, False),
    (8, 16, True, True), (2, 10, False, False),
])
def test_k4_bf16_hub_graph(cuda_bf16, nb, din, per_basis, sum_bases, out):
    m, _ = _hub(cuda_bf16)
    lay = m.layout
    rng = np.random.default_rng(nb * 100 + din)
    n_slots = lay.num_chunks * lay.chunk
    x = _t(rng, cuda_bf16, *((nb, 1536, din) if per_basis else (1536, din))).to(BF16)
    w = _t(rng, cuda_bf16, nb, n_slots) * (lay.local_dst.reshape(-1) < lay.row_block)
    n_out = 1 if sum_bases else nb
    out_dtype = BF16 if out == "bf16" else torch.float32
    _nan_filled(1536, n_out, din)
    before = dict(kernels.LAUNCHES)
    got = bs.weighted_aggregate(x, m.src_sorted, w, lay, 1536, sum_bases=sum_bases,
                                out_dtype=out_dtype)
    assert _launched(before) == {"k4_weighted_aggregate_bf16": 1}
    _node_major(got, (n_out, 1536, din))
    ref = bs.weighted_aggregate_plain(x, m.src_sorted, w, lay, 1536, sum_bases=sum_bases)
    if out == "bf16":
        _close_bf16_out(got, ref)
    else:
        _close(got, ref)
    untouched = _untouched(lay, lay.local_dst)
    assert (got[:, untouched] == 0).all()


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("kk,nb,din", [(2, 2, 200), (2, 1, 7), (3, 3, 200),
                                       (2, 8, 16), (3, 2, 10)])
def test_k5_bf16_hub_graph(cuda_bf16, kk, nb, din, out):
    m, r_gen = _hub(cuda_bf16, dedup_k=kk)
    dd = m.fwd_dedup
    rng = np.random.default_rng(kk * 100 + nb * 10 + din)
    comps = _t(rng, cuda_bf16, r_gen, nb)
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    x = _t(rng, cuda_bf16, 1536, din).to(BF16)
    out_dtype = BF16 if out == "bf16" else torch.float32
    _nan_filled(1536, nb, din)
    before = dict(kernels.LAUNCHES)
    got = bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, 1536, out_dtype=out_dtype)
    assert _launched(before) == {"k5_weighted_aggregate_dedup_bf16": 1}
    _node_major(got, (nb, 1536, din))
    ref = bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, 1536)
    if out == "bf16":
        _close_bf16_out(got, ref)
    else:
        _close(got, ref)
    untouched = _untouched(dd, dd.local_k)
    assert (got[:, untouched] == 0).all()


def test_bf16_wrappers_refuse_other_dtypes(cuda_bf16):
    m, _, rng = _merged(300, 3, 1200, 10, cuda_bf16, dedup_k=2)
    lay, dd = m.layout, m.fwd_dedup
    x = _t(rng, cuda_bf16, 300, 8)
    w = _t(rng, cuda_bf16, 2, lay.num_chunks * lay.chunk)
    w_k = _t(rng, cuda_bf16, 2, 2, dd.num_chunks * dd.chunk)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bs.weighted_aggregate(x.half(), m.src_sorted, w, lay, 300)
    with pytest.raises(TypeError, match="gives no"):
        bs.weighted_aggregate(x, m.src_sorted, w, lay, 300, out_dtype=BF16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bs.weighted_aggregate_dedup(x.half(), dd.src_sorted, w_k, dd, 300)
    with pytest.raises(TypeError, match="K1 takes float32 or bfloat16"):
        agg.aggregate_presorted(x.half().repeat(lay.num_chunks * lay.chunk // 300 + 1, 1)[
            :lay.num_chunks * lay.chunk], lay, 300)
    assert kernels.LAUNCHES == before


def _bf16_card_vs_cpu(fn, inputs, dev, g):
    """fn(device, *inputs) with a bf16 compute dtype on the card against the
    CPU (both bf16): output and gradients within 8e-3·max(1, max|ref|);
    returns the card's launches."""
    (ref, ref_grads, _), (got, grads, launched) = _grads_on_card_and_cpu(fn, inputs, dev, g)
    for a, b in zip([got] + grads, [ref] + ref_grads):
        assert a.shape == b.shape and a.dtype == torch.float32
        tol = 8e-3 * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= tol
    return {k: v for k, v in launched.items() if v}


@pytest.mark.parametrize("frame", ["unmerged", "merged", "dedup"])
def test_basis_op_bf16_on_the_card(cuda_bf16, frame):
    n, nb, din, dout = 1500, 2, 200, 64
    if frame == "unmerged":
        _, es_cpu, es_dev, rng = _lp_subgraph(n, 5, 6000, 21, cuda_bf16)
    else:
        m, es, rng = _merged(n, 5, 7000, 21, "cpu", dedup_k=2 if frame == "dedup" else 0)
        es_cpu = dataclasses.replace(es, merged=m)
        es_dev = es_cpu.to(cuda_bf16)
    edges = {"cpu": es_cpu, "cuda": es_dev}
    inputs = [_t(rng, "cpu", n, din), _t(rng, "cpu", nb, din, dout, scale=0.1),
              _t(rng, "cpu", es_cpu.num_rels, nb)]

    def fn(d, x, bases, comps):
        return bs.rel_spmm_basis(edges[torch.device(d).type], x, bases, comps,
                                 compute_dtype=BF16)

    fwd = "k5_weighted_aggregate_dedup_bf16" if frame == "dedup" else \
        "k4_weighted_aggregate_bf16"
    launched = _bf16_card_vs_cpu(fn, inputs, cuda_bf16, _t(rng, "cpu", n, dout))
    want = {fwd: 1, "k4_weighted_aggregate_bf16": 1} if frame == "dedup" else \
        {"k4_weighted_aggregate_bf16": 2}
    assert launched == want


def test_featureless_basis_op_bf16_on_the_card(cuda_bf16):
    n, nb, dout = 1200, 4, 16
    _, es_cpu, es_dev, rng = _lp_subgraph(n, 5, 5000, 22, cuda_bf16)
    edges = {"cpu": es_cpu, "cuda": es_dev}

    def fn(d, bases, comps):
        return bs.rel_spmm_featureless_basis_fwd(edges[torch.device(d).type], bases, comps,
                                                 compute_dtype=BF16)

    inputs = [_t(rng, "cpu", nb, n, dout), _t(rng, "cpu", es_cpu.num_rels, nb)]
    launched = _bf16_card_vs_cpu(fn, inputs, cuda_bf16, _t(rng, "cpu", n, dout))
    assert launched == {"k4_weighted_aggregate_bf16": 2}


@pytest.mark.parametrize("merged", [False, True])
def test_diag_op_bf16_on_the_card(cuda_bf16, merged):
    from rgcn_tpu_torch.ops.diag import rel_spmm_diag_ad

    rng = np.random.default_rng(23)
    t = make_random_triples(rng, 1000, 5 if merged else 70, 6000)
    es = build_edge_set(t, 1000, 5 if merged else 70, with_dst_layout=True,
                        with_merged_layout=merged)
    assert (es.merged is not None) == merged
    edges = {"cpu": es.to("cpu"), "cuda": es.to(cuda_bf16)}

    def fn(d, x, dw):
        return rel_spmm_diag_ad(edges[torch.device(d).type], x, dw, compute_dtype=BF16)

    inputs = [_t(rng, "cpu", 1000, 32), _t(rng, "cpu", es.num_rels, 32)]
    launched = _bf16_card_vs_cpu(fn, inputs, cuda_bf16, _t(rng, "cpu", 1000, 32))
    assert launched == {"k1_aggregate_bf16": 2}


def test_pair_op_bf16_on_the_card(cuda_bf16):
    es, rng = _pair_edges(cuda_bf16, 24)
    edges = {"cpu": es.to("cpu"), "cuda": es.to(cuda_bf16)}
    nb, din, dout = 40, 10, 11

    def fn(d, x, bases, comps):
        e = edges[torch.device(d).type]
        return sp.rel_spmm_basis_pairs(
            e, x, bases, comps, compute_dtype=BF16,
            aggregate=lambda msgs, e: agg.aggregate_sorted(msgs, e.layout, e.num_nodes,
                                                           dst=e.dst))

    inputs = [_t(rng, "cpu", 1300, din), _t(rng, "cpu", nb, din, dout, scale=0.3),
              _t(rng, "cpu", es.num_rels, nb)]
    launched = _bf16_card_vs_cpu(fn, inputs, cuda_bf16, _t(rng, "cpu", 1300, dout))
    # f32 pair messages through K1 both ways; the bf16 table's gradient by
    # K1's bf16 form through the by-source layout
    assert launched == {"k1_aggregate": 2, "k1_aggregate_bf16": 1}



# -- K4's bf16 form: the owned-row kernel (csrc/k4_owned_bf16.cuh) ------------

K4B_NODES = 1000  # the output's rows: inside the layout's last row block of 128


def _k4b_layout(dev, chunk=256):
    """A destination-sorted layout with every shape K4's bf16 units meet
    (layout over 1024 nodes, row blocks of 128): node 5 over more than 40
    chunks of row block 0, node 200 over three chunks of block 1, block 3
    empty (one chunk of pads), two pad-only chunks appended (``pad_to``),
    and slots to rows 1000-1023, past the output's K4B_NODES. Returns the
    layout on ``dev`` and its per-slot source rows (a pad's is far out of
    range: a kernel that read it would fault)."""
    rng = np.random.default_rng(41)
    rand = rng.integers(0, 1024, 3000)
    rand = rand[(rand < 384) | (rand >= 512)]
    dst = np.concatenate([rand, np.full(40 * chunk, 5), np.full(2 * chunk + 50, 200),
                          rng.integers(1000, 1024, 200)])
    base = agg.build_dst_layout(dst, 1024, row_block=128, chunk=chunk)
    total = base.num_chunks * chunk + 2 * chunk
    lay = agg.build_dst_layout(dst, 1024, row_block=128, chunk=chunk, pad_to=total)
    local = lay.local_dst.reshape(-1)
    blocks = np.repeat(lay.chunk_block, chunk)
    assert (np.bincount(lay.chunk_block) >= 40).any()
    assert (local.reshape(-1, chunk) == 128).all(1).sum() >= 3
    src = np.where(local < 128, rng.integers(0, 1024, local.shape[0]), 1 << 30)
    assert ((blocks * 128 + local)[local < 128] >= K4B_NODES).any()
    return lay.to(dev), torch.as_tensor(src, dtype=torch.int32, device=dev)


def _k4b_case(dev, lay, src, nb, din, per_basis, sum_bases, out, aligned=True, table=BF16):
    """K4's bf16 form (``table`` f32: its f32 form) into NaN-filled memory
    against the plain version's f32 sums; pads' weights NaN (never read).
    Returns the output."""
    rng = np.random.default_rng(nb * 1000 + din)
    shape = (nb, 1024, din) if per_basis else (1024, din)
    flat = _t(rng, dev, int(np.prod(shape)) + 1).to(table)
    x = (flat[:-1] if aligned else flat[1:]).view(shape)
    real = lay.local_dst.reshape(-1) < lay.row_block
    w = torch.where(real, _t(rng, dev, nb, real.shape[0]), torch.full_like(real, float("nan"),
                                                                          dtype=torch.float32))
    n_out = 1 if sum_bases else nb
    out_dtype = BF16 if out == "bf16" else torch.float32
    _nan_filled(K4B_NODES, n_out, din)
    before = dict(kernels.LAUNCHES)
    got = bs.weighted_aggregate(x, src, w, lay, K4B_NODES, sum_bases=sum_bases,
                                out_dtype=out_dtype)
    assert _launched(before) == {"k4_weighted_aggregate" + ("_bf16" if table == BF16 else ""): 1}
    _node_major(got, (n_out, K4B_NODES, din))
    ref = bs.weighted_aggregate_plain(x, src, w, lay, K4B_NODES, sum_bases=sum_bases)
    if out == "bf16":
        _close_bf16_out(got, ref)
    else:
        _close(got, ref)
    assert got.dtype == out_dtype
    # the split-run counters are left as they were found: zero
    assert not int(kernels.stream_counters(dev, 1).count_nonzero().item())
    return got


@pytest.mark.parametrize("din", [10, 16, 200, 400])
@pytest.mark.parametrize("nb", [1, 2, 4, 8])
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("per_basis,sum_bases", [(False, False), (False, True),
                                                 (True, False), (True, True)],
                         ids=["shared", "shared-sum", "per-basis", "per-basis-sum"])
def test_k4_bf16_owned_every_mode(cuda_bf16, per_basis, sum_bases, out, nb, din):
    """Every mode of K4's bf16 form (shared or per-basis tables, with and
    without sum_bases, f32 or bf16 out) at 1 to 8 bases and din 16
    (nc-AIFB's: two 16-byte vectors a row), 200 and 400, and 10 (nc-AM's
    hidden width: 4-byte pieces, the row's second vector masked), on the
    adversarial layout: a destination over 40 chunks and one over three
    (runs that cross units, finished by their last unit from two scratch
    rows a unit), an empty block, pad-only chunks, rows past the output
    dropped; every row written (those no slot reaches exactly 0)."""
    lay, src = _k4b_layout(cuda_bf16)
    got = _k4b_case(cuda_bf16, lay, src, nb, din, per_basis, sum_bases, out)
    untouched = _untouched(lay, lay.local_dst)[:K4B_NODES]
    assert bool(untouched[384:512].all())
    assert (got[:, untouched] == 0).all()


@pytest.mark.parametrize("din", [16, 200])
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("per_basis", [False, True])
def test_k4_bf16_owned_unaligned_table(cuda_bf16, per_basis, out, din):
    """A table that is not 16-byte aligned (one bf16 value off) takes the
    same owned-row kernel in 2-byte pieces, with the same answers."""
    lay, src = _k4b_layout(cuda_bf16)
    _k4b_case(cuda_bf16, lay, src, 2, din, per_basis, per_basis, out, aligned=False)


@pytest.mark.parametrize("din,aligned,kernel", [
    (200, True, "k4o::owned_kernel"), (16, True, "k4o::owned_kernel"),
    (10, True, "k4o::owned_kernel"), (200, False, "k4o::owned_kernel")])
def test_k4_bf16_route_runs_the_chosen_kernel(cuda_bf16, din, aligned, kernel):
    """Every width and alignment runs the owned-row kernel alone (one event
    a call, no zeroing or narrowing launch), read from the profile
    (utils/profiling.device_split), in the pieces kernels.k4_piece names:
    8 values (16 bytes), 2 at width 10, 1 from a table one value off."""
    from rgcn_tpu_torch.utils.profiling import device_split

    lay, src = _k4b_layout(cuda_bf16)
    rng = np.random.default_rng(din)
    flat = _t(rng, cuda_bf16, 1024 * din + 1).to(BF16)
    x = (flat[:-1] if aligned else flat[1:]).view(1024, din)
    w = _t(rng, cuda_bf16, 2, lay.num_chunks * lay.chunk)
    want = 8 if aligned and din % 8 == 0 else (2 if aligned else 1)
    assert kernels.k4_piece(din, x.data_ptr(), 2) == want
    split = device_split(lambda: bs.weighted_aggregate(x, src, w, lay, K4B_NODES,
                                                       out_dtype=BF16), iters=3)
    names = list(split["kernels_us"])
    assert any(kernel in k for k in names), names
    assert len(names) == 1 and not any("runs_kernel" in k for k in names), names


@pytest.mark.parametrize("nb,sum_bases,out,owned", [
    (2, False, "bf16", True), (2, True, "bf16", True), (2, False, "f32", True)])
def test_k4_bf16_route_by_chunk_count(cuda_bf16, monkeypatch, nb, sum_bases, out, owned):
    """Whatever the chunk count and output (several bf16 bases, one output,
    an f32 output), every call takes the owned-row kernel alone: no
    weighted_runs.cuh kernel; the same answers and bits each call."""
    from rgcn_tpu_torch.utils.profiling import device_split

    lay, src = _k4b_layout(cuda_bf16)
    rng = np.random.default_rng(5)
    x = _t(rng, cuda_bf16, 1024, 200).to(BF16)
    w = _t(rng, cuda_bf16, nb, lay.num_chunks * lay.chunk)
    out_dtype = BF16 if out == "bf16" else torch.float32

    def kernel_names():
        return list(device_split(lambda: bs.weighted_aggregate(
            x, src, w, lay, K4B_NODES, sum_bases=sum_bases, out_dtype=out_dtype),
            iters=3)["kernels_us"])

    assert owned
    names = kernel_names()
    assert any("k4o::owned_kernel" in k for k in names), names
    assert not any("runs_kernel" in k for k in names), names
    a = _k4b_case(cuda_bf16, lay, src, nb, 200, False, sum_bases, out)
    assert _same_bits(a, _k4b_case(cuda_bf16, lay, src, nb, 200, False, sum_bases, out))


@pytest.mark.parametrize("chunk", [64, 16])
def test_k4_bf16_owned_small_chunks(cuda_bf16, chunk):
    """Chunks of 64 and 16 slots: a unit is a whole chunk, so the hub's
    run crosses hundreds of units (one ballot of 32 units a step in the
    finishing launch)."""
    lay, src = _k4b_layout(cuda_bf16, chunk=chunk)
    for out in ("f32", "bf16"):
        _k4b_case(cuda_bf16, lay, src, 2, 200, False, False, out)
        _k4b_case(cuda_bf16, lay, src, 2, 200, True, True, out)


def test_k4_bf16_scratch_is_two_rows_a_unit(cuda_bf16):
    """The launcher's f32 scratch is two rows a unit (a unit a chunk at
    chunk 256), far less than the output's rows; its counters are made once
    for the stream, and a second stream gets its own."""
    lay, src = _k4b_layout(cuda_bf16)
    units = kernels.k4_units(lay.num_chunks, lay.chunk)
    assert units == lay.num_chunks
    assert kernels.k4_scratch_floats(lay.num_chunks, lay.chunk, 400) == units * 2 * 400
    assert units * 2 < K4B_NODES
    _k4b_case(cuda_bf16, lay, src, 2, 200, False, False, "bf16")
    first = kernels.stream_counters(cuda_bf16, units)
    _k4b_case(cuda_bf16, lay, src, 2, 200, True, True, "f32")
    assert kernels.stream_counters(cuda_bf16, units).data_ptr() == first.data_ptr()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        other = kernels.stream_counters(cuda_bf16, units)
        _k4b_case(cuda_bf16, lay, src, 2, 200, False, False, "f32")
    torch.cuda.synchronize()
    assert other.data_ptr() != first.data_ptr()


# -- the JAX kernels' own dtype options: K1's bf16 output, K2's and K3's bf16
# forms ------------------------------------------------------------------------


def _close_rounded_msgs(got, ref32, abs_sum):
    """An f32 sum of bf16-rounded messages against the plain version's: a
    message whose two f32 sums straddle a bf16 rounding boundary may round
    to the neighbouring value, half a bf16 ulp of it (2^-8·|msg| bounds
    it); ``abs_sum`` is the plain sum of the messages' magnitudes."""
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref32.shape
    tol = 2.0 ** -8 * abs_sum + 1e-5 * max(1.0, ref32.abs().max().item())
    assert bool(((got - ref32).abs() <= tol).all())


@pytest.mark.parametrize("graph", ["random", "hub"])
@pytest.mark.parametrize("msg", ["f32", "bf16"])
@pytest.mark.parametrize("dout", [16, 4, 200, 10])
def test_k1_bf16_output(cuda, dout, msg, graph):
    """K1 with out_dtype=bf16, from f32 (K1's f32 form) and bf16 messages
    (its bf16 form), through the perm and presorted: the f32 sums rounded
    once; every output element written (rows no slot reaches are 0)."""
    if graph == "hub":
        n = 1536
        es = build_edge_set(skew_triples(), n, 4, with_dst_layout=True).to(cuda)
        rng = np.random.default_rng(dout + 1)
    else:
        n = 900
        es, rng = _edges(n, 5, 4000, dout + 1, cuda)
    dt = BF16 if msg == "bf16" else torch.float32
    msgs = _t(rng, cuda, es.src.shape[0], dout).to(dt)
    ms = _t(rng, cuda, es.layout.perm.shape[0], dout).to(dt)
    before = dict(kernels.LAUNCHES)
    got = agg.aggregate_sorted(msgs, es.layout, n, out_dtype=BF16)
    _close_bf16_out(got, agg.aggregate_sorted_plain(msgs, es.layout, n))
    _close_bf16_out(agg.aggregate_presorted(ms, es.layout, n, out_dtype=BF16),
                    agg.aggregate_presorted_plain(ms, es.layout, n))
    assert _launched(before) == {"k1_aggregate" + ("_bf16" if msg == "bf16" else ""): 2}
    if graph == "hub":
        assert (got[512:1024] == 0).all()


@pytest.mark.parametrize("din,dout", [(16, 4), (32, 40), (64, 8), (6, 5), (12, 12)])
def test_k2_bf16(cuda, din, dout):
    """rel_spmm_fused's default compute dtype on the card: K2's bf16 form
    (16-byte x gathers where din % 8 == 0, 8-byte W loads where dout % 4
    == 0) against the plain version rounding at the same places."""
    es, rng = _edges(1300, 6, 6000, 3, cuda)
    x = torch.relu(_t(rng, cuda, 1300, din))
    w = _t(rng, cuda, 12, din, dout, scale=din ** -0.5)
    assert rs.fused_fits(w, es.fused.row_block, BF16)
    before = dict(kernels.LAUNCHES)
    got = fz.rel_spmm_fused(es.fused, 1300, x, w)
    assert _launched(before) == {"k2_fused_bf16": 1}
    ref = fz.rel_spmm_fused_plain(es.fused, 1300, x, w, BF16)
    _close_rounded_msgs(got, ref, fz.rel_spmm_fused_plain(es.fused, 1300, x.abs(), w.abs(),
                                                          BF16))
    assert (got - fz.rel_spmm_fused_plain(es.fused, 1300, x, w)).abs().max().item() > 0


def test_k2_bf16_skewed(cuda):
    """The hub graph (a destination over more than four fused chunks,
    all-gap chunks) and a node count inside the last row block."""
    es = build_edge_set(skew_triples(), 1536, 4, with_dst_layout=True).to(cuda)
    rng = np.random.default_rng(6)
    x = torch.relu(_t(rng, cuda, 1536, 16))
    w = _t(rng, cuda, 8, 16, 4, scale=0.25)
    got = fz.rel_spmm_fused(es.fused, 1536, x, w)
    _close_rounded_msgs(got, fz.rel_spmm_fused_plain(es.fused, 1536, x, w, BF16),
                        fz.rel_spmm_fused_plain(es.fused, 1536, x.abs(), w.abs(), BF16))
    assert (got[512:1024] == 0).all()
    assert fz.rel_spmm_fused(es.fused, 1500, x, w).shape == (1500, 4)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("din,dout", [
    (500, 500),  # lp-FB-toy's widths: 8-byte copies, 4 column slices
    (64, 136),   # 16-byte copies, a partial slice
    (12, 40),    # 8-byte copies, one slab
    (6, 40),     # plain 2-byte loads
    (130, 260),  # several 64-deep slabs, a partial one
    (16, 4),     # the small route, 16-byte x rows
    (10, 11),    # the small route, scalar x rows
    (0, 40),     # no input columns: every message is 0
])
def test_k3_bf16(cuda, din, dout, out):
    """K3's bf16 form on bf16 operands (the tiled route's one-pass bf16
    mma.sync, the small route) with f32 or bf16 messages, into memory that
    held NaN, against the plain version's f32 sums of the same bf16
    values; zero-val rows come out 0."""
    es, rng = _edges(300, 5, 1800, 8, cuda)
    x = torch.relu(_t(rng, cuda, 300, din)).to(BF16)
    w = _t(rng, cuda, 10, din, dout, scale=max(din, 1) ** -0.5).to(BF16)
    od = BF16 if out == "bf16" else torch.float32
    junk = torch.full((es.src.shape[0], dout), float("nan"), device=cuda).to(od)
    del junk
    before = dict(kernels.LAUNCHES)
    got = rs.rel_spmm_messages(es, x, w, out_dtype=od)
    assert _launched(before) == {"k3_messages_bf16": 1}
    ref = rs.rel_spmm_messages_plain(es, x, w, torch.float32)
    if out == "bf16":
        _close_bf16_out(got, ref)
    else:
        _close(got, ref)
    assert (got[es.val == 0] == 0).all()
    # the default output dtype is the weights': bf16
    assert rs.rel_spmm_messages(es, x, w).dtype == BF16


@pytest.mark.parametrize("din,dout", [(500, 500), (37, 70), (16, 4)])
def test_k3_f32_operands_bf16_messages(cuda, din, dout):
    """rel_spmm_messages(out_dtype=bf16) over f32 operands: the f32 form's
    routes (3xTF32 tiled, f32 small) in the bf16 library, the f32 sums
    rounded once."""
    es, rng = _edges(300, 5, 1800, 9, cuda)
    x = torch.relu(_t(rng, cuda, 300, din))
    w = _t(rng, cuda, 10, din, dout, scale=din ** -0.5)
    before = dict(kernels.LAUNCHES)
    got = rs.rel_spmm_messages(es, x, w, out_dtype=BF16)
    assert _launched(before) == {"k3_messages_bf16": 1}
    _close_bf16_out(got, rs.rel_spmm_messages_plain(es, x, w))


@pytest.mark.parametrize("entry", ["pallas", "full"])
@pytest.mark.parametrize("compute,accum", [(BF16, torch.float32), (BF16, BF16),
                                           (None, BF16)])
def test_two_stage_dtypes_on_card(cuda, entry, compute, accum):
    """rel_spmm_pallas / rel_spmm_full with their dtypes on the card
    against the port's CPU run: exactly one K3 bf16 launch and one K1 (its
    f32 or bf16 form by the messages' dtype), within 8e-3·max(1,
    max|ref|)."""
    es, rng = _edges(700, 5, 3000, 12, cuda)
    x = _t(rng, cuda, 700, 24)
    w = _t(rng, cuda, 10, 24, 32, scale=0.2)

    def run(e, a, b):
        if entry == "pallas":
            return rs.rel_spmm_pallas(e, a, b, compute_dtype=compute, accum_dtype=accum)
        return rs.rel_spmm_full(e, e.layout, a, b, compute_dtype=compute, accum_dtype=accum)

    before = dict(kernels.LAUNCHES)
    got = run(es, x, w)
    msg_bf16 = (compute or accum) == BF16 if entry == "full" else accum == BF16
    assert _launched(before) == {"k3_messages_bf16": 1,
                                 "k1_aggregate" + ("_bf16" if msg_bf16 else ""): 1}
    ref = run(es.to("cpu"), x.cpu(), w.cpu())
    assert got.dtype == ref.dtype == accum
    tol = 8e-3 * max(1.0, ref.float().abs().max().item())
    assert (got.float().cpu() - ref.float()).abs().max().item() <= tol


def test_dtype_options_refuse_on_card(cuda):
    """No quiet conversion: mixed or other dtypes raise before any launch,
    and the bf16 forms have no backward."""
    es, rng = _edges(200, 3, 800, 6, cuda)
    x, w = _t(rng, cuda, 200, 8), _t(rng, cuda, 6, 8, 4)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError, match="one dtype"):
        kernels.launch_k2_fused(x.to(BF16), w, es.fused.src, es.fused.val,
                                es.fused.local_dst, es.fused.quantum_rel,
                                es.fused.chunk_block, 200, es.fused.row_block,
                                es.fused.num_row_blocks, es.fused.quantum)
    with pytest.raises(TypeError, match="compute_dtype"):
        fz.rel_spmm_fused(es.fused, 200, x, w, compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="one dtype"):
        rs.rel_spmm_messages(es, x.to(BF16), w)
    with pytest.raises(TypeError, match="out_dtype"):
        rs.rel_spmm_messages(es, x, w, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="out_dtype"):
        agg.aggregate_sorted(_t(rng, cuda, es.src.shape[0], 4), es.layout, 200,
                             out_dtype=torch.float16)
    with pytest.raises(RuntimeError, match="no backward on the card"):
        fz.rel_spmm_fused(es.fused, 200, x.requires_grad_(), w)
    with pytest.raises(RuntimeError, match="no backward on the card"):
        rs.rel_spmm_messages(es, x.to(BF16), w.to(BF16).requires_grad_())
    assert kernels.LAUNCHES == before


# -- K1's owned-row route and K5's passes at adversarial layouts ---------------

# (row_block, chunk, pad-only chunks appended, node count): the hub graph's
# destination 7 spans a dozen chunks at CH 256 and ~190 at CH 16 (more than
# any cluster or loop of CTAs would hold); single-chunk blocks; a node count
# off the row blocks; CH 512 splits a chunk between two owned-row CTAs
K1_GEOMETRIES = [(128, 256, 0, 1536), (64, 32, 2, 1531), (96, 48, 1, 1536),
                 (256, 16, 3, 1531), (32, 512, 0, 1536)]


@pytest.fixture(scope="module")
def k1_routes():
    """K1's two routes forced, both message types (variants/k1_routes.cu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from rgcn_tpu_torch import compare_k1_k5

    fns, _ = compare_k1_k5.build_variants()
    return fns


def _skew_layout(geometry, dev, src_order=False):
    rb, ch, extra, n = geometry
    t = skew_triples()
    dst = np.concatenate([t[:, 2], t[:, 0]]).astype(np.int64)
    src = np.concatenate([t[:, 0], t[:, 2]]).astype(np.int64)
    dst = np.where((dst < n) & (src < n), dst, n)
    pad_to = agg.build_dst_layout(dst, n, rb, ch).perm.shape[0] + extra * ch if extra else None
    lay = agg.build_dst_layout(dst, n, rb, ch, pad_to=pad_to, src=src if src_order else None)
    return lay.to(dev), n


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("msg", ["f32", "bf16"])
@pytest.mark.parametrize("dout", [10, 16, 32, 200])
@pytest.mark.parametrize("geometry", K1_GEOMETRIES, ids=lambda g: "rb{}-ch{}-pad{}-n{}".format(*g))
def test_k1_routes_adversarial(cuda_bf16, k1_routes, geometry, dout, msg, out):
    """The launcher and both forced routes against the plain sums, through
    perm and in slot order, into NaN-filled memory: a destination over
    many chunks, pad-only chunks, single-chunk blocks, rows past the last
    block's nodes."""
    lay, n = _skew_layout(geometry, cuda_bf16)
    assert lay.dst_sorted
    rng = np.random.default_rng(dout + 7 * geometry[1])
    mdt = BF16 if msg == "bf16" else torch.float32
    odt = BF16 if out == "bf16" else torch.float32
    for index, rows in ((lay.perm, lay.num_edges), (None, lay.num_chunks * lay.chunk)):
        msgs = _t(rng, cuda_bf16, rows, dout).to(mdt)
        if index is None:
            ref = agg.aggregate_presorted_plain(msgs, lay, n)
            launched = agg.aggregate_presorted(msgs, lay, n, odt)
        else:
            ref = agg.aggregate_sorted_plain(msgs, lay, n)
            launched = agg.aggregate_sorted(msgs, lay, n, out_dtype=odt)
        for route in ("owned", "atomics", None):
            if route is None:
                got = launched
            else:
                _nan_filled(n, dout)
                got = torch.empty((n, dout), dtype=odt, device=cuda_bf16)
                scratch = torch.empty((n, dout), device=cuda_bf16) if out == "bf16" else None
                fn = k1_routes[f"k1_{route}_{msg}"]
                assert fn(msgs.data_ptr(), None if index is None else index.data_ptr(),
                          lay.local_dst.data_ptr(), lay.chunk_block.data_ptr(), got.data_ptr(),
                          None if scratch is None else scratch.data_ptr(), lay.num_chunks,
                          lay.chunk, lay.row_block, dout, n, 1, int(out == "bf16"),
                          torch.cuda.current_stream().cuda_stream) == 0
            if out == "bf16":
                _close_bf16_out(got, ref)
            else:
                _close(got, ref)
            assert (got[512:1024] == 0).all()  # the isolated nodes' rows


@pytest.mark.parametrize("msg", ["f32", "bf16"])
def test_k1_source_ordered_layout(cuda_bf16, msg):
    """A layout in source order within its row blocks (dst_sorted False):
    the launcher takes the chunk route (chunk_sum.cuh), whatever the size,
    sums right, and gives the same bits twice."""
    for geometry in K1_GEOMETRIES[:3]:
        lay, n = _skew_layout(geometry, cuda_bf16, src_order=True)
        assert not lay.dst_sorted
        rng = np.random.default_rng(geometry[1])
        msgs = _t(rng, cuda_bf16, lay.num_edges, 32).to(BF16 if msg == "bf16" else torch.float32)
        ref = agg.aggregate_sorted_plain(msgs, lay, n)
        got = agg.aggregate_sorted(msgs, lay, n)
        _close(got, ref)
        assert _same_bits(got, agg.aggregate_sorted(msgs, lay, n))
        if msg == "bf16":
            _close_bf16_out(agg.aggregate_sorted(msgs, lay, n, out_dtype=BF16), ref)


def _k1_kernel_names(call) -> set:
    """The device events of one call, from a profile that kept every
    kernel record (a profile that lost one is taken again)."""
    from rgcn_tpu_torch.utils.profiling import device_split

    split = device_split(call, iters=1, warmup=1, tries=8)
    return {name.split("(")[0] for name in split["kernels_us"]}


@pytest.mark.parametrize("msg", ["f32", "bf16"])
def test_k1_route_by_shape(cuda_bf16, msg):
    """The launcher's rule (kernels.k1_route): a destination-sorted layout,
    small, or large and dense or sparse (over 1,024 CTAs at dout 32 and at
    the masked width 10, where the atomics and owned routes took it
    before), takes the fixed-order owned-row kernel alone
    (k1_fixed_kernel: no memset, no narrowing kernel, one event a call); a
    source-ordered one chunk_sum.cuh's kernel alone. Each against the
    plain sums, the same bits twice."""
    mdt = BF16 if msg == "bf16" else torch.float32
    es, rng = _edges(40_000, 5, 150_000, 9, cuda_bf16)  # ~7.5 slots a row, >1024 CTAs
    lay = es.layout
    assert lay.num_chunks >= 1024 and lay.num_chunks * lay.chunk >= 3 * 40_000
    cases = [(es, 32, "k1_fixed_kernel"), (es, 10, "k1_fixed_kernel")]
    small, _ = _edges(900, 5, 4000, 1, cuda_bf16)
    cases.append((small, 32, "k1_fixed_kernel"))
    # >1024 CTAs of CH 64, under 3 slots a row
    sparse, _ = _edges(80_000, 5, 40_000, 9, cuda_bf16, layout_chunk=64)
    assert sparse.layout.num_chunks >= 1024
    cases.append((sparse, 32, "k1_fixed_kernel"))
    by_src, n_src = _skew_layout(K1_GEOMETRIES[0], cuda_bf16, src_order=True)
    for edges, dout, kernel in cases + [(None, 16, "chunk_kernel<k1::")]:
        lay = by_src if edges is None else edges.layout
        n = n_src if edges is None else edges.num_nodes
        msgs = _t(rng, cuda_bf16, lay.num_edges, dout).to(mdt)
        ref = agg.aggregate_sorted_plain(msgs, lay, n)
        for out in (torch.float32, BF16):
            call = lambda: agg.aggregate_sorted(msgs, lay, n, out_dtype=out)  # noqa: E731
            names = _k1_kernel_names(call)
            assert len(names) == 1 and kernel in next(iter(names)), names
            (_close_bf16_out if out == BF16 else _close)(call(), ref)
            assert _same_bits(call(), call())
        _close(agg.aggregate_sorted(msgs, lay, n), agg.aggregate_sorted_plain(msgs, lay, n))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("kk,nb,din", [(2, 2, 200), (3, 2, 10), (2, 1, 16)])
def test_k5_many_chunk_block(cuda_bf16, kk, nb, din, out):
    """K5's bf16 form over a dedup frame whose hub row block holds more
    chunks than K5 meets at lp-WN18 (23): the rows of longer blocks
    zeroed, added to and narrowed by a warp a chunk, into NaN-filled
    memory; untouched rows 0."""
    es = build_edge_set(skew_triples(), 1536, 4, with_dst_layout=True)
    m = build_merged_layout(es.dst, es.src, es.rel, es.val, 1536, es.num_rels,
                            dedup_k=kk, chunk=32).to(cuda_bf16)
    dd = m.fwd_dedup
    assert int(torch.bincount(dd.chunk_block.long()).max().item()) > 23
    rng = np.random.default_rng(kk * 10 + din)
    comps = _t(rng, cuda_bf16, es.num_rels, nb)
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    x = _t(rng, cuda_bf16, 1536, din).to(BF16)
    out_dtype = BF16 if out == "bf16" else torch.float32
    _nan_filled(1536, nb, din)
    _nan_filled(1536 * nb * din)
    before = dict(kernels.LAUNCHES)
    got = bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, 1536, out_dtype=out_dtype)
    assert _launched(before) == {"k5_weighted_aggregate_dedup_bf16": 1}
    ref = bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, 1536)
    if out == "bf16":
        _close_bf16_out(got, ref)
    else:
        _close(got, ref)
    assert (got[:, _untouched(dd, dd.local_k)] == 0).all()


# -- K1's and K2's fixed-order designs: one launch, the same bits twice ---------

def _same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    bits = torch.int16 if a.dtype == BF16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a.view(bits),
                                                                          b.view(bits)))


def _twice_into_nan(call, shape, dtype):
    """``call()`` twice, each into memory that held NaN (nothing is zeroed
    first); both results."""
    out = []
    for _ in range(2):
        _nan_filled(*shape)
        if dtype == BF16:  # a bf16 output takes half the bytes: NaN them too
            _nan_filled(shape[0], -(-shape[1] // 2))
        got = call()
        torch.cuda.synchronize()
        out.append(got)
    return out


# (row_block, chunk, pad-only chunks appended, node count, source order):
# the hub destination spans a dozen chunks at CH 256 and ~190 at CH 16
K1_FIXED_LAYOUTS = [(128, 256, 0, 1536, False), (64, 32, 2, 1531, False),
                    (256, 16, 3, 1531, False), (32, 512, 0, 1536, False),
                    (128, 256, 1, 1536, True), (64, 32, 0, 1531, True)]


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("msg", ["f32", "bf16"])
@pytest.mark.parametrize("dout", [4, 10, 16, 32])
@pytest.mark.parametrize("layout", K1_FIXED_LAYOUTS,
                         ids=lambda g: "rb{}-ch{}-pad{}-n{}-{}".format(
                             *g[:4], "src" if g[4] else "dst"))
def test_k1_fixed_order_adversarial(cuda_bf16, layout, dout, msg, out):
    """K1 in both message forms and both outputs over the hub graph: a
    destination over 3+ chunks (and CTAs), pad-only chunks, a node count
    inside the last block and a call whose num_nodes leaves whole row
    blocks past it, destination- and source-ordered layouts; through perm
    and in slot order, into NaN-filled memory; against the plain sums,
    exactly one launch a call, and the same bits on a second launch."""
    *geometry, src_order = layout
    lay, n = _skew_layout(tuple(geometry), cuda_bf16, src_order=src_order)
    assert lay.dst_sorted != src_order
    hub_chunks = int((lay.chunk_block == lay.chunk_block[0]).sum().item())
    assert hub_chunks >= 3
    rng = np.random.default_rng(dout + 13 * geometry[1])
    mdt = BF16 if msg == "bf16" else torch.float32
    odt = BF16 if out == "bf16" else torch.float32
    name = "k1_aggregate" + ("_bf16" if msg == "bf16" else "")
    for n_out in (n, n - lay.row_block - 5):  # the latter: a whole block past it
        for index in (lay.perm, None):
            rows = lay.num_edges if index is not None else lay.num_chunks * lay.chunk
            msgs = _t(rng, cuda_bf16, rows, dout).to(mdt)
            if index is None:
                ref = agg.aggregate_presorted_plain(msgs, lay, n_out)
                call = lambda: agg.aggregate_presorted(msgs, lay, n_out, odt)  # noqa: E731
            else:
                ref = agg.aggregate_sorted_plain(msgs, lay, n_out)
                call = lambda: agg.aggregate_sorted(msgs, lay, n_out, out_dtype=odt)  # noqa: E731
            before = dict(kernels.LAUNCHES)
            a, b = _twice_into_nan(call, (n_out, dout), odt)
            assert _launched(before) == {name: 2}
            (_close_bf16_out if out == "bf16" else _close)(a, ref)
            assert _same_bits(a, b)
            assert (a[512:1024] == 0).all()  # the isolated nodes' rows


@pytest.mark.parametrize("form", ["f32", "bf16"])
@pytest.mark.parametrize("din,dout", [(16, 4), (16, 16), (10, 10), (8, 32)])
@pytest.mark.parametrize("graph", ["hub", "random"])
def test_k2_fixed_order_adversarial(cuda, graph, din, dout, form):
    """K2 in both forms over the hub graph (a destination over more than
    four fused chunks, all-gap chunks, pad slots) and a random one, at a
    node count inside the last row block and with a whole row block past
    num_nodes, into NaN-filled memory: against the plain version rounding
    at the same places, exactly one launch a call, the same bits on a
    second launch."""
    if graph == "hub":
        n = 1536
        es = build_edge_set(skew_triples(), n, 4, with_dst_layout=True).to(cuda)
        rng = np.random.default_rng(din * dout)
        fl = es.fused
        assert int((fl.chunk_block == 0).sum().item()) > 4
        assert bool((fl.quantum_rel.reshape(fl.num_chunks, -1) < 0).all(1).any())
    else:
        n = 1300
        es, rng = _edges(n, 6, 6000, din + dout, cuda)
        fl = es.fused
    x = torch.relu(_t(rng, cuda, n, din))
    w = _t(rng, cuda, es.num_rels, din, dout, scale=din ** -0.5)
    cd = BF16 if form == "bf16" else None
    name = "k2_fused" + ("_bf16" if form == "bf16" else "")
    for n_out in (n, n - fl.row_block - 3):
        call = lambda: fz.rel_spmm_fused(fl, n_out, x, w, compute_dtype=cd)  # noqa: E731
        before = dict(kernels.LAUNCHES)
        a, b = _twice_into_nan(call, (n_out, dout), torch.float32)
        assert _launched(before) == {name: 2}
        ref = fz.rel_spmm_fused_plain(fl, n_out, x, w, cd)
        if form == "bf16":
            _close_rounded_msgs(a, ref, fz.rel_spmm_fused_plain(fl, n_out, x.abs(), w.abs(),
                                                                cd))
        else:
            _close(a, ref)
        assert _same_bits(a, b)
        if graph == "hub":
            assert (a[512:1024] == 0).all()


def test_k1_k2_one_kernel_a_call(cuda):
    """K1 (both outputs) and K2 (both forms) at nc-AIFB-like sizes: the
    profiler's kernel names of one call are one kernel each, no memset, no
    narrowing launch."""
    es, rng = _edges(8285, 45, 29_000, 3, cuda)
    n = es.num_nodes
    msgs = _t(rng, cuda, es.layout.num_edges, 16)
    x, w = torch.relu(_t(rng, cuda, n, 16)), _t(rng, cuda, es.num_rels, 16, 4, scale=0.25)
    xb, wb = x.to(BF16), w.to(BF16)
    for call, kernel in (
            (lambda: agg.aggregate_sorted(msgs, es.layout, n), "k1_fixed_kernel"),
            (lambda: agg.aggregate_sorted(msgs, es.layout, n, out_dtype=BF16),
             "k1_fixed_kernel"),
            (lambda: fz.rel_spmm_fused(es.fused, n, x, w, compute_dtype=None),
             "chunk_kernel<k2::"),
            # bf16 operands given as bf16: no cast kernel beside K2's
            (lambda: fz.rel_spmm_fused(es.fused, n, xb, wb), "chunk_kernel<k2::")):
        names = _k1_kernel_names(call)
        assert len(names) == 1 and kernel in next(iter(names)), names


def test_nc_training_is_bit_reproducible(cuda):
    """Two trainings of nc-AIFB-like data from one initialisation on the
    card (K1 and K2 both ways, the dense layer's dW by relation in tile
    order) end with the same parameter bits."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import aifb_like
    from rgcn_tpu_torch.models.node_classification import build_nc_model
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "rgcn",
                        "nc-AIFB.yaml")
    base = load_experiment(path)
    cfg = dataclasses.replace(base, training=dataclasses.replace(base.training, epochs=4))
    data = aifb_like()
    init = build_nc_model(cfg, data, seed=0).state_dict()
    states = []
    for _ in range(2):
        t = NodeClassificationTrainer(cfg, data, init_params=init, device=cuda)
        t.fit()
        states.append({k: v.detach().clone() for k, v in t.model.state_dict().items()})
    for k, v in states[0].items():
        assert _same_bits(v, states[1][k]), k


# -- K2's and K3's bf16-weight forms (the layers' param_dtype) ------------------------


@pytest.mark.parametrize("din,dout", [(16, 4), (32, 40), (6, 5)])
def test_k2_wbf16(cuda, din, dout):
    """f32 x with a bf16 W: k2_fused_wbf16 (one launch, nothing else)
    against its plain version (W widened), the same bits on a second
    launch into NaN-filled memory, and the f32 form's bits on W widened
    beforehand (the same products in the same order)."""
    es, rng = _edges(1300, 6, 6000, 3, cuda)
    x = torch.relu(_t(rng, cuda, 1300, din))
    wb = _t(rng, cuda, 12, din, dout, scale=din ** -0.5).to(BF16)
    assert rs.fused_fits(wb, es.fused.row_block)
    before = dict(kernels.LAUNCHES)
    a, b = _twice_into_nan(lambda: fz.rel_spmm_fused(es.fused, 1300, x, wb, compute_dtype=None),
                           (1300, dout), torch.float32)
    assert _launched(before) == {"k2_fused_wbf16": 2}
    _close(a, fz.rel_spmm_fused_plain(es.fused, 1300, x, wb))
    assert _same_bits(a, b)
    assert _same_bits(a, fz.rel_spmm_fused(es.fused, 1300, x, wb.float(), compute_dtype=None))


def test_k2_wbf16_skewed(cuda):
    es = build_edge_set(skew_triples(), 1536, 4, with_dst_layout=True).to(cuda)
    rng = np.random.default_rng(6)
    x = torch.relu(_t(rng, cuda, 1536, 16))
    wb = _t(rng, cuda, 8, 16, 4, scale=0.25).to(BF16)
    got = fz.rel_spmm_fused(es.fused, 1500, x, wb, compute_dtype=None)
    _close(got, fz.rel_spmm_fused_plain(es.fused, 1536, x, wb)[:1500])


@pytest.mark.parametrize("out", [torch.float32, BF16])
@pytest.mark.parametrize("din,dout", [(500, 500), (37, 70), (130, 260), (16, 4), (10, 11)])
def test_k3_wbf16(cuda, din, dout, out):
    """f32 x with a bf16 W: k3_messages_wbf16 (its small route, and its
    tiled route's two TF32 passes) against its plain version's f32 sums,
    rows of val 0 zero, one launch."""
    es, rng = _edges(300, 5, 1800, 8, cuda)
    x = torch.relu(_t(rng, cuda, 300, din))
    wb = _t(rng, cuda, 10, din, dout, scale=din ** -0.5).to(BF16)
    junk = torch.full((es.src.shape[0], dout), float("nan"), device=cuda)
    del junk
    before = dict(kernels.LAUNCHES)
    got = rs.rel_spmm_messages(es, x, wb, out_dtype=out)
    assert _launched(before) == {"k3_messages_wbf16": 1}
    ref = rs.rel_spmm_messages_plain(es, x, wb, torch.float32)
    if out == BF16:
        _close_bf16_out(got, ref)
    else:
        _close(got, ref)
    assert (got[es.val == 0] == 0).all()


def test_bf16_weights_other_mixes_raise(cuda):
    es, rng = _edges(200, 3, 900, 9, cuda)
    x = _t(rng, cuda, 200, 8)
    w = _t(rng, cuda, 6, 8, 4)
    for xx, ww in ((x.to(BF16), w), (x, w.half())):
        with pytest.raises(TypeError):
            kernels.launch_k3_messages(xx, ww, es.src, es.val, es.tile_rel, es.tile_size)
        with pytest.raises(TypeError):
            fz.rel_spmm_fused(es.fused, 200, xx, ww, compute_dtype=None)


@pytest.mark.parametrize("fused", [True, False])
def test_spmm_function_bf16_weights(cuda, fused):
    """rel_spmm_ad with bf16 weights on the card (K2's or K3's bf16-weight
    form both ways, K1 after K3) against the CPU: forward and dx within
    1e-5·max(1, max|ref|), dW (bf16) within one rounding of its f32 sums."""
    es, rng = _edges(700, 5, 3500, 11, cuda)
    if not fused:
        es = _no_fused(es)
    x = torch.relu(_t(rng, cuda, 700, 16))
    wb = _t(rng, cuda, es.num_rels, 16, 8, scale=0.25).to(BF16)
    cot = _t(rng, cuda, 700, 8)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        xx = x.detach().to(dev).clone().requires_grad_()
        ww = wb.detach().to(dev).clone().requires_grad_()
        before = dict(kernels.LAUNCHES)
        out = rs.rel_spmm_ad(es.to(dev), xx, ww)
        out.backward(cot.to(dev))
        runs[dev.type] = (out.detach().cpu(), xx.grad.cpu(), ww.grad.cpu(), _launched(before))
    out, dx, dw, used = runs["cuda"]
    form = {"k2_fused_wbf16": 2} if fused else {"k3_messages_wbf16": 2, "k1_aggregate": 2}
    assert used == form
    assert dw.dtype == BF16 and dx.dtype == torch.float32
    for got, ref in ((out, runs["cpu"][0]), (dx, runs["cpu"][1])):
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= tol
    ref = runs["cpu"][2].float()
    assert bool(((dw.float() - ref).abs()
                 <= 2.0 ** -8 * ref.abs() + 1e-5 * max(1.0, ref.abs().max().item())).all())


def test_bf16_layer_launches_the_bf16_weight_forms(cuda):
    """RGCNConv with param_dtype=bfloat16 on the card: the dense layer's
    forward through k2_fused_wbf16, the block layer (expanded weights past
    the fused budget) through k3_messages_wbf16 and K1; f32 outputs."""
    from rgcn_tpu_torch.nn.layers import RGCNConv

    es, rng = _edges(400, 4, 2000, 12, cuda)
    x = torch.relu(_t(rng, cuda, 400, 16))
    dense = RGCNConv(400, 9, 4, in_features=16, param_dtype=BF16).to(cuda)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        out = dense(es, x)
    assert out.dtype == torch.float32 and _launched(before) == {"k2_fused_wbf16": 1}
    wide = torch.relu(_t(rng, cuda, 400, 400))
    block = RGCNConv(400, 9, 400, in_features=400, decomposition="block", num_blocks=100,
                     separate_self_weight=True, bias_init=None, param_dtype=BF16).to(cuda)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        out = block(es, wide)
    assert out.dtype == torch.float32
    assert _launched(before) == {"k3_messages_wbf16": 1, "k1_aggregate": 1}


# -- every training sum in a fixed order: K4's f32 form, K1's masked lanes ------

def _k4_many_chunks(dev, chunk=16):
    """A destination-sorted layout of more than 1,024 chunks (chunks of 16
    over 1,024 nodes, a hub over hundreds of them) and its sources."""
    rng = np.random.default_rng(43)
    dst = np.concatenate([rng.integers(0, 1024, 15_000), np.full(3000, 77)])
    lay = agg.build_dst_layout(dst, 1024, row_block=128, chunk=chunk)
    assert lay.num_chunks > 1024
    local = lay.local_dst.reshape(-1)
    src = np.where(local < 128, rng.integers(0, 1024, local.shape[0]), 1 << 30)
    return lay.to(dev), torch.as_tensor(src, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("din", [3, 7, 10, 16, 200])
@pytest.mark.parametrize("nb", [1, 2, 8])
@pytest.mark.parametrize("per_basis,sum_bases", [(False, False), (False, True),
                                                 (True, False), (True, True)],
                         ids=["shared", "shared-sum", "per-basis", "per-basis-sum"])
@pytest.mark.parametrize("layout", ["hub", "many_chunks"])
def test_k4_f32_owned_rows(cuda, layout, per_basis, sum_bases, nb, din):
    """K4's f32 form on the owned-row kernel in every mode at 1, 2 and 8
    bases, din 16 and 200 (16-byte vectors), 10 (8-byte pieces), 7 and 3
    (4-byte pieces, the last vector masked), over the adversarial layout (a
    destination over 40 chunks, pad-only chunks, an empty block, rows past
    the output) and one of more than 1,024 chunks, into NaN-filled memory:
    one launch, the plain sums, the same bits on a second call, the
    split-run counters left zero."""
    lay, src = (_k4b_layout if layout == "hub" else _k4_many_chunks)(cuda)
    a = _k4b_case(cuda, lay, src, nb, din, per_basis, sum_bases, "f32", table=torch.float32)
    b = _k4b_case(cuda, lay, src, nb, din, per_basis, sum_bases, "f32", table=torch.float32)
    assert _same_bits(a, b)
    want = 4 if din % 4 == 0 else (2 if din % 2 == 0 else 1)
    x = torch.empty((1024, din), device=cuda)
    assert kernels.k4_piece(din, x.data_ptr(), 4) == want


@pytest.mark.parametrize("table", [torch.float32, BF16])
def test_k4_owned_unaligned_and_many_chunks(cuda, table):
    """A table one value off its 16-byte grid (4-byte pieces of f32, 2-byte
    of bf16) and a bf16 table over more than 1,024 chunks: the owned-row
    kernel alone, the plain sums, the same bits twice."""
    lay, src = _k4_many_chunks(cuda)
    outs = ("f32",) if table == torch.float32 else ("f32", "bf16")
    for out in outs:
        for aligned in (True, False):
            a = _k4b_case(cuda, lay, src, 2, 200, True, False, out, aligned=aligned, table=table)
            b = _k4b_case(cuda, lay, src, 2, 200, True, False, out, aligned=aligned, table=table)
            assert _same_bits(a, b)


@pytest.mark.parametrize("msg", ["f32", "bf16"])
@pytest.mark.parametrize("dout", [5, 6, 10, 11, 13])
@pytest.mark.parametrize("geometry", K1_GEOMETRIES[:3], ids=lambda g: "rb{}-ch{}-pad{}-n{}".format(*g))
def test_k1_masked_lanes(cuda_bf16, geometry, dout, msg):
    """K1's lanes at widths that are not a multiple of 4: 4-value lanes,
    the row's last masked, moved in pieces of 2 values (even widths) or 1
    (odd widths, or a message view one value off), through perm and in slot
    order, both outputs, into NaN-filled memory: the plain sums, one
    launch, the same bits on a second call."""
    lay, n = _skew_layout(geometry, cuda_bf16)
    rng = np.random.default_rng(dout * 31 + geometry[1])
    mdt = BF16 if msg == "bf16" else torch.float32
    for index, rows in ((lay.perm, lay.num_edges), (None, lay.num_chunks * lay.chunk)):
        flat = _t(rng, cuda_bf16, rows * dout + 1).to(mdt)
        for view in (flat[:-1], flat[1:]):
            msgs = view.view(rows, dout)
            piece = kernels.k1_piece(dout, msgs.data_ptr(), msgs.element_size())
            if view.data_ptr() == flat.data_ptr():
                assert piece == (2 if dout % 2 == 0 else 1)
            for odt in (torch.float32, BF16):
                if index is None:
                    ref = agg.aggregate_presorted_plain(msgs, lay, n)
                    call = lambda: agg.aggregate_presorted(msgs, lay, n, odt)  # noqa: E731
                else:
                    ref = agg.aggregate_sorted_plain(msgs, lay, n)
                    call = lambda: agg.aggregate_sorted(msgs, lay, n, out_dtype=odt)  # noqa: E731
                before = dict(kernels.LAUNCHES)
                a, b = _twice_into_nan(call, (n, dout), odt)
                assert sum(_launched(before).values()) == 2
                (_close_bf16_out if odt == BF16 else _close)(a, ref)
                assert _same_bits(a, b)


@pytest.mark.parametrize("msg", ["f32", "bf16"])
def test_k1_diagonal_shape_fixed_order(cuda_bf16, msg):
    """K1 at e-RGCN nc-AM's diagonal shape (slot-order messages at d 32 over
    am_like()'s destination layout, 6,925 chunks, the owned route's before)
    on the fixed-order kernel: the plain sums, the same bits twice."""
    from rgcn_tpu_torch.data.synthetic import am_like
    from rgcn_tpu_torch.ops import diag as dg

    am = am_like()
    es = build_edge_set(am.triples, am.num_nodes, am.num_relations, tile_size=128,
                        with_dst_layout=True).to(cuda_bf16)
    rng = np.random.default_rng(32)
    x, dw = _t(rng, cuda_bf16, es.num_nodes, 32), _t(rng, cuda_bf16, es.num_rels, 32)
    msgs = dg.diag_slot_messages(x, dw, es, compute_dtype=BF16 if msg == "bf16" else None)
    n = es.num_nodes
    a, b = _twice_into_nan(lambda: agg.aggregate_presorted(msgs, es.layout, n), (n, 32),
                           torch.float32)
    ref = agg.aggregate_presorted_plain(msgs.double(), es.layout, n)
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    assert (a.double() - ref).abs().max().item() <= tol
    assert _same_bits(a, b)


def test_lp_structural_trained_twice_bit_equal(cuda):
    """lp-WN18 with the structural self-loop mask (wn18_like(), width 200,
    batch 30,000) trained two epochs twice from the seed-0 initialisation:
    the same launches, losses, parameters and test ranks bit for bit (K4,
    K1, the comps' and relations' gradients all sum in a fixed order)."""
    import os

    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = load_experiment(os.path.join(root, "configs", "rgcn", "lp-WN18.yaml"))
    enc = base.encoder
    cfg = dataclasses.replace(
        base, training=dataclasses.replace(base.training, epochs=2),
        encoder=dataclasses.replace(enc, edge_dropout=dataclasses.replace(
            enc.edge_dropout, self_loop=0.2, self_loop_type="structural")))
    data = wn18_like()

    class Quiet(ScalarLogger):
        def __init__(self):
            super().__init__(verbose=False)
            self.records = []

        def log_scalar(self, metric, value, step=None):
            self.records.append((metric, step, float(value)))

    runs = []
    for _ in range(2):
        t = LinkPredictionTrainer(cfg, data, device=cuda, logger=Quiet())
        before = dict(kernels.LAUNCHES)
        log = Quiet()
        _, _, ranks = t.fit(log)
        torch.cuda.synchronize()
        runs.append((_launched(before), log.records, ranks,
                     {k: v.detach().clone() for k, v in t.model.state_dict().items()}))
    (l0, r0, k0, s0), (l1, r1, k1, s1) = runs
    assert l0 == l1 and r0 == r1 and np.array_equal(k0, k1)
    for name, v in s0.items():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[v.element_size()]
        assert torch.equal(v.view(bits), s1[name].view(bits)), name

