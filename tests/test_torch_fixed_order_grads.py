"""Every training gradient sum in a fixed order, against the JAX package, on the CPU.

``ops/ordered.py::index_sum`` sums rows by key in an order the keys alone
fix (a stable sort, runs of one key within blocks of rows summed in row
order, then each key's partial rows in block order), where ``index_add_``
and ``index_select``'s backward add with atomics on the card. It carries
the basis layers' ``dcomps`` (JAX: ``segment_sum``,
``rgcn_tpu/ops/pallas_basis.py:411``), the decoders' ``d relations``
(JAX: a one-hot product), the diagonal layer's ``d dw`` per relation run
(JAX: ``segment_sum``, ``pallas_diag.py:94``) and, through
``select_rows``, the backward of the relation and penalty gathers. Each
is held against the JAX package on numpy inputs made from a seed (Pallas
in interpret mode) within 1e-5 * max(1, max|ref|); a second call gives the
same bits; CPU tensors take no kernel; and ``index_sum`` equals the sum
taken in its documented order bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rgcn_tpu.graph import dynamic as jdyn
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.ops import pallas_distmult as jdm
from rgcn_tpu.ops.pallas_basis import rel_spmm_basis_ad as j_basis_ad
from rgcn_tpu.ops.pallas_basis import rel_spmm_featureless_basis_ad as j_fl_ad
from rgcn_tpu.ops.pallas_diag import rel_spmm_diag_ad as j_diag_ad
from rgcn_tpu.train import negative as jneg
from rgcn_tpu_torch import kernels
from rgcn_tpu_torch.graph import dynamic as tdyn
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.ops import distmult as tdist
from rgcn_tpu_torch.ops import distmult_train as tdm
from rgcn_tpu_torch.ops import ordered
from rgcn_tpu_torch.ops.basis import rel_spmm_basis, rel_spmm_featureless_basis_fwd
from rgcn_tpu_torch.ops.diag import diag_weight_grad, rel_spmm_diag_ad
from tests.conftest import make_random_triples


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, err=""):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, err
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol, err


def _bits(t):
    t = t.detach().contiguous()
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _keys(rng, n, rows, kind):
    if kind == "uniform":
        return rng.integers(0, rows, n)
    if kind == "hub":  # most rows on one key, a few on the others
        keys = rng.integers(0, rows, n)
        keys[rng.random(n) < 0.8] = rows // 2
        return keys
    return np.sort(rng.integers(0, rows, n))  # sorted, as an EdgeSet's relations


@pytest.mark.parametrize("n,rows,width", [(1, 3, 4), (700, 9, 5), (5000, 40, 0),
                                          (20_000, 37, 3), (3000, 2000, 8)])
@pytest.mark.parametrize("kind", ["uniform", "hub", "sorted"])
def test_index_sum_matches_segment_sum(n, rows, width, kind):
    """index_sum against jax.ops.segment_sum: unsorted keys (uniform, or a
    hub holding 80% of the rows) and sorted keys (the sort skipped), rows
    with no key (exactly 0), 1-D and 2-D values; the same bits twice."""
    rng = np.random.default_rng(n + rows + len(kind))
    keys = _keys(rng, n, rows, kind)
    values = _f32(rng, n, *((width,) if width else ()))
    want = jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(keys), num_segments=rows)
    before = dict(kernels.LAUNCHES)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(values)
    got = ordered.index_sum(tv, tk, rows, sorted_index=kind == "sorted")
    assert kernels.LAUNCHES == before and got.dtype == torch.float32
    _close(got, want)
    assert not got[torch.from_numpy(np.bincount(keys, minlength=rows) == 0)].any()
    assert _same_bits(got, ordered.index_sum(tv, tk, rows, sorted_index=kind == "sorted"))
    if kind != "sorted":  # the unsorted path on sorted keys: the same sums
        _close(ordered.index_sum(tv, tk, rows), want)


def _documented_order(values, keys, rows):
    """index_sum's order in plain Python: a stable sort, each (block, key)
    run summed in row order, then each key's runs in block order, in f32."""
    order = np.argsort(keys, kind="stable")
    k, v = keys[order], values[order]
    n, b = len(k), ordered._block(len(k))
    out = np.zeros((rows,) + values.shape[1:], np.float32)
    i = 0
    while i < n:
        j, part = i, np.zeros(values.shape[1:], np.float32)
        while j < n and k[j] == k[i] and (j == i or j % b):
            part = np.float32(part + v[j])
            j += 1
        out[k[i]] = np.float32(out[k[i]] + part)
        i = j
    return out


@pytest.mark.parametrize("n,rows,kind", [(3000, 11, "hub"), (1500, 200, "uniform")])
def test_index_sum_takes_its_documented_order(n, rows, kind):
    """The sum equals, bit for bit, the order the module documents (a
    stable sort, runs within blocks of sqrt(n) rows, blocks in order)."""
    rng = np.random.default_rng(n)
    keys = _keys(rng, n, rows, kind)
    values = _f32(rng, n, 3)
    got = ordered.index_sum(torch.from_numpy(values), torch.from_numpy(keys), rows)
    assert np.array_equal(got.numpy().view(np.int32),
                          _documented_order(values, keys, rows).view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_rows_gradient_matches_jax(dtype):
    """select_rows' gradient (a table's rows gathered with repeats, the
    hub row most of them) against jax.vjp of jnp.take: summed in f32,
    rounded once to the table's dtype (a bf16 table's rows take their
    cotangent in bf16, as JAX's do); the plain gather without grad."""
    rng = np.random.default_rng(4)
    table = _f32(rng, 30, 6)
    idx = _keys(rng, 500, 30, "hub")
    g = _f32(rng, 500, 6)
    g_in = torch.from_numpy(g).to(dtype).float().numpy()  # the rows' cotangent
    want, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0), jnp.asarray(table))
    (wdt,) = vjp(jnp.asarray(g_in))
    grads = []
    for _ in range(2):
        tt = torch.tensor(table).to(dtype).requires_grad_()
        out = ordered.select_rows(tt, torch.from_numpy(idx))
        out.float().backward(torch.from_numpy(g))
        grads.append(tt.grad)
    assert grads[0].dtype == dtype and _same_bits(grads[0], grads[1])
    if dtype == torch.float32:
        _close(out, want)
        _close(grads[0], wdt)
    else:  # one rounding of the f32 sum
        ref = np.array(wdt)
        assert bool((grads[0].float() - torch.from_numpy(ref)).abs().le(
            2.0 ** -8 * torch.from_numpy(np.abs(ref)) + 1e-6).all())
    with torch.no_grad():
        assert not ordered.select_rows(torch.tensor(table).requires_grad_(),
                                       torch.from_numpy(idx)).requires_grad


def _dynamic_pair(n, r, b, tile, seed, rate=0.3):
    pos = make_random_triples(np.random.default_rng(seed), n, r, b)
    keep = np.random.default_rng(seed + 1).random(b) >= rate
    kw = dict(tile_size=tile, keep_mask=keep, with_dst_layout=True, row_block=32,
              layout_chunk=32)
    return (jdyn.build_edge_set_dynamic_host(pos, n, r, **kw),
            tdyn.build_edge_set_dynamic_host(pos, n, r, **kw).to("cpu"))


@pytest.mark.parametrize("n,r,b,nb", [(60, 3, 200, 2), (150, 5, 900, 4)])
def test_basis_dcomps_matches_jax_segment_sum(n, r, b, nb):
    """The basis Function's dcomps (the reverse frame's slot order, sorted
    by index_sum) against jax.vjp of rel_spmm_basis_ad's segment_sum; the
    whole VJP twice, the same bits; no kernel on CPU tensors."""
    jes, tes = _dynamic_pair(n, r, b, tile=8, seed=n)
    rng = np.random.default_rng(5)
    x, bases = _f32(rng, n, 12), _f32(rng, nb, 12, 7)
    comps, g = _f32(rng, 2 * r, nb), _f32(rng, n, 7)
    _, vjp = jax.vjp(lambda x, bs, c: j_basis_ad(jes, x, bs, c, compute_dtype=None),
                     jnp.asarray(x), jnp.asarray(bases), jnp.asarray(comps))
    wdc = vjp(jnp.asarray(g))[2]
    before = dict(kernels.LAUNCHES)
    runs = []
    for _ in range(2):
        tx, tb, tc = (torch.tensor(a, requires_grad=True) for a in (x, bases, comps))
        rel_spmm_basis(tes, tx, tb, tc).backward(torch.from_numpy(g))
        runs.append((tx.grad, tb.grad, tc.grad))
    assert kernels.LAUNCHES == before
    _close(runs[0][2], wdc, "dcomps")
    assert all(_same_bits(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("nb", [1, 3])
def test_featureless_dcomps_matches_jax_segment_sum(nb):
    """The featureless basis Function's dcomps, summed over the EdgeSet's
    relation-sorted edges (the sort skipped), against jax.vjp of
    rel_spmm_featureless_basis_ad; twice, the same bits."""
    n, r, dout = 120, 4, 5
    t = make_random_triples(np.random.default_rng(nb), n, r, 1200)
    kw = dict(tile_size=16, with_dst_layout=True, layout_row_block=32)
    jes = j_build(t, n, r, prefer_native=False, **kw)
    tes = build_edge_set(t, n, r, **kw).to("cpu")
    assert (np.diff(tes.rel.numpy()) >= 0).all()
    rng = np.random.default_rng(nb + 20)
    bases, comps, g = _f32(rng, nb, n, dout), _f32(rng, 2 * r, nb), _f32(rng, n, dout)
    _, vjp = jax.vjp(lambda bs, c: j_fl_ad(jes, bs, c, compute_dtype=None),
                     jnp.asarray(bases), jnp.asarray(comps))
    wdc = vjp(jnp.asarray(g))[1]
    runs = []
    for _ in range(2):
        tb, tc = (torch.tensor(a, requires_grad=True) for a in (bases, comps))
        rel_spmm_featureless_basis_fwd(tes, tb, tc).backward(torch.from_numpy(g))
        runs.append(tc.grad)
    _close(runs[0], wdc, "dcomps")
    assert _same_bits(*runs)


@pytest.mark.parametrize("n,r,p,ns,d", [(40, 3, 24, 3, 8), (90, 5, 50, 10, 16)])
def test_structured_drelations_match_jax(n, r, p, ns, d):
    """The structured scorer's d relations (P rows by relation) against
    jax.vjp of distmult_structured_agg_ad's one-hot product; twice, the
    same bits."""
    pos = make_random_triples(np.random.default_rng(p), n, r, p)
    c_head, c_ent = jneg.corrupt_batch_host(np.random.default_rng(1), pos, n, ns, 0.5,
                                            structure_only=True)
    jl = jdm.build_structured_layouts(pos, c_ent, n, row_block=16, chunk=32,
                                      sorted_corrupt=True, corrupt_head=c_head)
    tl = tdm.build_structured_layouts(pos, c_ent, c_head, n, row_block=16, chunk=32)
    layouts = (tl[0].to("cpu"), tl[1].to("cpu"), tl[2].to("cpu"),
               tuple(torch.from_numpy(a) for a in tl[3]))
    rng = np.random.default_rng(2)
    nodes, rels = _f32(rng, n, d), _f32(rng, r, d)
    total = len(pos) * (1 + ns)
    pw = np.full(total, 1.0 / total, np.float32)
    gs, gp = _f32(rng, total), np.float32(0.7)
    _, vjp = jax.vjp(lambda a, b: jdm.distmult_structured_agg_ad(pos, c_head, c_ent, a, b,
                                                                  pw, jl),
                     jnp.asarray(nodes), jnp.asarray(rels))
    wdr = vjp((jnp.asarray(gs), jnp.asarray(gp)))[1]
    runs = []
    for _ in range(2):
        tn, tr = (torch.tensor(a, requires_grad=True) for a in (nodes, rels))
        s, pen = tdm.structured_scores(torch.from_numpy(pos), torch.from_numpy(c_head),
                                       torch.from_numpy(c_ent), tn, tr,
                                       torch.from_numpy(pw), layouts)
        torch.autograd.backward([s, pen], [torch.from_numpy(gs), torch.tensor(gp)])
        runs.append(tr.grad)
    _close(runs[0], wdr, "drelations")
    assert _same_bits(*runs)


def test_assembled_drelations_match_jax():
    """The assembled batch's scorer (K1 for the rows, index_sum for d
    relations) against jax.vjp of distmult_score_agg_ad; twice, the same
    bits."""
    from rgcn_tpu_torch.train.negative import corrupt_batch_host

    n, r, d = 120, 5, 12
    pos = make_random_triples(np.random.default_rng(3), n, r, 60)
    batch, _ = corrupt_batch_host(np.random.default_rng(4), pos, n, 4, 0.5)
    jl = jdm.build_batch_layouts(batch, n, row_block=32, chunk=64)
    tl = tuple(lay.to("cpu") for lay in tdm.build_batch_layouts(batch, n, row_block=32,
                                                                 chunk=64))
    rng = np.random.default_rng(5)
    nodes, rels, gs = _f32(rng, n, d), _f32(rng, r, d), _f32(rng, len(batch))
    _, vjp = jax.vjp(lambda a, b: jdm.distmult_score_agg_ad(batch, a, b, jl),
                     jnp.asarray(nodes), jnp.asarray(rels))
    wdr = vjp(jnp.asarray(gs))[1]
    runs = []
    for _ in range(2):
        tn, tr = (torch.tensor(a, requires_grad=True) for a in (nodes, rels))
        tdm.distmult_score_agg(torch.from_numpy(batch), tn, tr, tl).backward(
            torch.from_numpy(gs))
        runs.append(tr.grad)
    _close(runs[0], wdr, "drelations")
    assert _same_bits(*runs)


def test_score_and_penalty_gathers_match_jax():
    """distmult_score's gathers (select_rows) with biases and the
    Schlichtkrull penalty's mean squares: gradients against jax.vjp of the
    same expression with jnp.take; twice, the same bits."""
    rng = np.random.default_rng(6)
    n, r, b, d = 50, 4, 400, 8
    trip = make_random_triples(rng, n, r, b)
    nodes, rels, bias = _f32(rng, n, d), _f32(rng, r, d), _f32(rng, n)
    g = _f32(rng, len(trip))  # the triples are unique: at most b

    def jf(z, rr, bb):
        s, p, o = (jnp.asarray(trip[:, i]) for i in range(3))
        zs, rp, zo = jnp.take(z, s, 0), jnp.take(rr, p, 0), jnp.take(z, o, 0)
        score = jnp.sum(zs * rp * zo, -1) + jnp.take(bb, s) + jnp.take(bb, o)
        pen = jnp.mean(zs ** 2, -1) + jnp.mean(rp ** 2, -1) + jnp.mean(zo ** 2, -1)
        return jnp.sum((score + pen) * jnp.asarray(g))

    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(nodes), jnp.asarray(rels),
                                           jnp.asarray(bias))
    runs = []
    for _ in range(2):
        tz, tr, tb = (torch.tensor(a, requires_grad=True) for a in (nodes, rels, bias))
        tt = torch.from_numpy(trip)
        score = tdist.distmult_score(tt, tz, tr, sbias=tb, pbias=torch.zeros(r),
                                     obias=tb)
        s, p, o = tt[:, 0], tt[:, 1], tt[:, 2]
        pen = (torch.mean(ordered.select_rows(tz, s) ** 2, -1)
               + torch.mean(ordered.select_rows(tr, p) ** 2, -1)
               + torch.mean(ordered.select_rows(tz, o) ** 2, -1))
        ((score + pen) * torch.from_numpy(g)).sum().backward()
        runs.append((tz.grad, tr.grad, tb.grad))
    for got, ref in zip(runs[0], want):
        _close(got, ref)
    assert all(_same_bits(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("n,r,base,d", [(40, 3, 300, 8), (130, 5, 900, 12)])
def test_diag_ddw_matches_jax_segment_sum(n, r, base, d):
    """The unmerged diagonal layer's d dw, summed per relation run over the
    EdgeSet's relation-sorted edges, against jax.vjp of the JAX
    rel_spmm_diag_ad (Pallas K1 in interpret mode); twice, the same bits;
    diag_weight_grad alone too."""
    rng = np.random.default_rng(n)
    t = make_random_triples(rng, n, r, base)
    kw = dict(tile_size=16, with_dst_layout=True, with_merged_layout=False)
    jes = j_build(t, n, r, prefer_native=False, **kw)
    tes = build_edge_set(t, n, r, **kw).to("cpu")
    assert tes.merged is None and (np.diff(tes.rel.numpy()) >= 0).all()
    x, dw, g = _f32(rng, n, d), _f32(rng, 2 * r, d), _f32(rng, n, d)
    _, vjp = jax.vjp(lambda a, b: j_diag_ad(jes, a, b), jnp.asarray(x), jnp.asarray(dw))
    wddw = vjp(jnp.asarray(g))[1]
    runs = []
    for _ in range(2):
        tx, tdw = (torch.tensor(a, requires_grad=True) for a in (x, dw))
        rel_spmm_diag_ad(tes, tx, tdw).backward(torch.from_numpy(g))
        runs.append(tdw.grad)
    _close(runs[0], wddw, "ddw")
    assert _same_bits(*runs)
    direct = diag_weight_grad(torch.from_numpy(x), torch.from_numpy(g), tes)
    _close(direct, wddw, "diag_weight_grad")
