"""The JAX kernels' own dtype options, in the port against the JAX package,
on the CPU: K2's ``compute_dtype`` (``rel_spmm_fused``, bf16 by default in
both packages), K3's ``out_dtype`` and bf16 operands
(``rel_spmm_messages``), the two-stage entry points' ``compute_dtype`` /
``accum_dtype`` (``rel_spmm_pallas``, ``rel_spmm_pallas_full`` /
``rel_spmm_full``), K1's ``out_dtype`` (``aggregate_presorted``,
``aggregate_sorted``) and ``rel_spmm_diag(aggregate=)``. Pallas runs in
interpret mode; the port runs its kernels' plain versions on CPU tensors.

Tolerances: an f32 option within rtol 1e-5, atol 1e-6 (the same f32 sums
in another order); a bf16 one within 8e-3·max(1, max|ref|) of JAX's bf16
result (the JAX package's own bf16 bound, ``tests/test_basis.py:58``)
and, where the port rounds where JAX rounds, at least 4 times nearer it
than the port's f32 result is (max norm). A bf16 destination sum is the
one difference by design: JAX rounds each chunk's partial (K1) or each
add (``segment_sum``) into a bf16 output, the port rounds the whole f32
sum once, so there the port must lie at least as near the f32 sum as
JAX's bf16 result does. ``rel_spmm_pallas`` with a bf16 ``accum_dtype``
sums in XLA's bf16 ``segment_sum``, every add rounded: at these sizes
that lands ~9e-2 from the f32 sum, past 8e-3·max|ref| (~8e-2), so there
the port's bf16 sum is held within 8e-3·max(1, max|ref|) of JAX's f32
sum of the same messages instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.ops import pallas_aggregate as jagg
from rgcn_tpu.ops import pallas_fused as jfused
from rgcn_tpu.ops import pallas_spmm as jspmm
from rgcn_tpu.ops import spmm as jops
from rgcn_tpu_torch.graph.structure import build_edge_set as t_build
from rgcn_tpu_torch.ops import aggregate as tagg
from rgcn_tpu_torch.ops import fused as tfused
from rgcn_tpu_torch.ops import rel_spmm as trs
from rgcn_tpu_torch.ops import spmm as tops
from tests.conftest import make_random_triples

TOL = dict(rtol=1e-5, atol=1e-6)
JDT = {None: None, "f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {None: None, "f32": torch.float32, "bf16": torch.bfloat16}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _close8(got, want, what=""):
    """Within 8e-3·max(1, max|ref|) of JAX's bf16 result."""
    assert _np(got).shape == _np(want).shape, what
    tol = 8e-3 * max(1.0, float(np.abs(_np(want)).max()))
    assert _err(got, want) <= tol, f"{what}: {_err(got, want):.3g} > {tol:.3g}"


def _nearer(got_bf16, got_f32, want, what=""):
    """The bf16 result lies at least 4 times nearer JAX's bf16 result than
    the f32 one does: rounding at other places than JAX misses this."""
    err, gap = _err(got_bf16, want), _err(got_f32, want)
    assert err <= 0.25 * gap, f"{what}: {err:.3g} from JAX's bf16, f32 is {gap:.3g}"


def _nearer_f32_sum(got, jax_bf16, ref32, what=""):
    """A bf16 output rounded once from the f32 sum lies at least as near
    that sum as JAX's, rounded per chunk or per add."""
    mine, theirs = _err(got, ref32), _err(jax_bf16, ref32)
    assert mine <= theirs, f"{what}: {mine:.3g} from the f32 sum, JAX's {theirs:.3g}"
    assert theirs > 0, f"{what}: no bf16 rounding on the JAX side"


def _graph(n=300, r=5, e=2000, seed=0, **kw):
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    jes = j_build(t, n, r, with_dst_layout=True, prefer_native=False, **kw)
    tes = t_build(t, n, r, with_dst_layout=True, **kw).to("cpu")
    return jes, tes, rng


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _operands(rng, n, r, din=16, dout=4):
    """Layer-2-scale operands: relu'd activations, glorot-scale weights."""
    return np.maximum(_f32(rng, n, din), 0), _f32(rng, 2 * r, din, dout, scale=0.25)


def test_rel_spmm_fused_defaults_agree():
    """Both packages' rel_spmm_fused with their own defaults (bf16 compute)
    agree, and the port's default lies 4 times nearer JAX's than its f32
    run: the port used to compute f32 under the same name (1.8e-2 off)."""
    jes, tes, rng = _graph()
    x, w = _operands(rng, 300, 5)
    want = jfused.rel_spmm_fused(jes.fused, 300, jnp.asarray(x), jnp.asarray(w),
                                 interpret=True)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tfused.rel_spmm_fused(tes.fused, 300, tx, tw)
    f32 = tfused.rel_spmm_fused(tes.fused, 300, tx, tw, compute_dtype=None)
    _close8(got, want, "default")
    _nearer(got, f32, want, "default")
    want32 = jfused.rel_spmm_fused(jes.fused, 300, jnp.asarray(x), jnp.asarray(w),
                                   compute_dtype=None, interpret=True)
    np.testing.assert_allclose(_np(f32), _np(want32), **TOL)


@pytest.mark.parametrize("case", [dict(n=60, r=4, e=250, seed=1, tile_size=16),
                                  dict(n=700, r=5, e=3000, seed=2)], ids=["small", "blocks"])
@pytest.mark.parametrize("dtype", ["bf16", "f32", None])
def test_k2_compute_dtype(case, dtype):
    """rel_spmm_fused(compute_dtype=) against the JAX kernel's: bf16 casts
    x and W and rounds each message; f32 and None compute in f32."""
    case = dict(case)
    n, r = case.pop("n"), case.pop("r")
    jes, tes, rng = _graph(n, r, **case)
    x, w = _operands(rng, n, r)
    want = jfused.rel_spmm_fused(jes.fused, n, jnp.asarray(x), jnp.asarray(w),
                                 compute_dtype=JDT[dtype], interpret=True)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tfused.rel_spmm_fused(tes.fused, n, tx, tw, compute_dtype=TDT[dtype])
    assert got.dtype == torch.float32
    if dtype == "bf16":
        _close8(got, want)
        _nearer(got, tfused.rel_spmm_fused(tes.fused, n, tx, tw, compute_dtype=None), want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("operands,out", [("f32", "bf16"), ("bf16", None), ("bf16", "f32")])
def test_k3_out_dtype(operands, out):
    """rel_spmm_messages over f32 or bf16 operands with its out_dtype
    (default the weights' dtype): f32 sums, one rounding to the output."""
    jes, tes, rng = _graph()
    x, w = _f32(rng, 300, 12), _f32(rng, 10, 12, 40, scale=0.3)
    jx, jw = jnp.asarray(x).astype(JDT[operands]), jnp.asarray(w).astype(JDT[operands])
    want = jspmm.rel_spmm_messages(jes, jx, jw, out_dtype=JDT[out], interpret=True)
    tx, tw = torch.from_numpy(x).to(TDT[operands]), torch.from_numpy(w).to(TDT[operands])
    got = trs.rel_spmm_messages(tes, tx, tw, out_dtype=TDT[out])
    assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16 else torch.float32)
    if out == "f32":
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        return
    _close8(got, want)
    # the messages' one rounding: the port's f32 messages of the same
    # operands lie farther off
    f32 = trs.rel_spmm_messages(tes, tx, tw, out_dtype=torch.float32)
    _nearer(got, f32, want)


@pytest.mark.parametrize("entry", ["pallas", "full"])
@pytest.mark.parametrize("compute,accum", [(None, "f32"), ("bf16", "f32"),
                                           ("bf16", "bf16"), (None, "bf16")])
def test_two_stage_dtypes(entry, compute, accum):
    """rel_spmm_pallas (K3, then the JAX package's segment_sum / the port's
    K1) and rel_spmm_pallas_full / rel_spmm_full (K3 then K1) with
    compute_dtype and accum_dtype."""
    jes, tes, rng = _graph()
    x, w = _f32(rng, 300, 12), _f32(rng, 10, 12, 24, scale=0.3)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)

    def jax_run(cd, ad):
        if entry == "pallas":
            return jspmm.rel_spmm_pallas(jes, jx, jw, compute_dtype=JDT[cd],
                                         accum_dtype=JDT[ad], interpret=True)
        return jspmm.rel_spmm_pallas_full(jes, jes.layout, jx, jw, compute_dtype=JDT[cd],
                                          accum_dtype=JDT[ad], interpret=True)

    def port_run(cd, ad):
        if entry == "pallas":
            return trs.rel_spmm_pallas(tes, tx, tw, compute_dtype=TDT[cd],
                                       accum_dtype=TDT[ad])
        return trs.rel_spmm_full(tes, tes.layout, tx, tw, compute_dtype=TDT[cd],
                                 accum_dtype=TDT[ad])

    want, got = jax_run(compute, accum), port_run(compute, accum)
    assert got.dtype == TDT[accum] and got.shape == (300, 24)
    if compute is None and accum == "f32":
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        return
    if accum == "f32":
        _close8(got, want)
        _nearer(got, port_run(None, "f32"), want)
        return
    ref32 = jax_run(compute, "f32")
    _nearer_f32_sum(got, want, ref32)
    # JAX's bf16 segment_sum rounds every add and lands past 8e-3·max|ref|
    # of the f32 sum here; the port is held to that sum, which it rounds once
    _close8(got, want if entry == "full" else ref32)


@pytest.mark.parametrize("form", ["presorted", "sorted"])
@pytest.mark.parametrize("msg_dtype", ["f32", "bf16"])
def test_k1_out_dtype(form, msg_dtype):
    """K1 with a bf16 output, from f32 or bf16 messages: JAX rounds each
    chunk's f32 partial into the bf16 block, the port the whole f32 sum
    once; f32 out as before."""
    jes, tes, rng = _graph(n=700, r=5, e=6000, seed=3)
    rows = jes.layout.perm.shape[0] if form == "presorted" else jes.src.shape[0]
    msgs = _f32(rng, rows, 8)
    jm = jnp.asarray(msgs).astype(JDT[msg_dtype])
    tm = torch.from_numpy(msgs).to(TDT[msg_dtype])

    def jax_run(od):
        if form == "presorted":
            return jagg.aggregate_presorted_pallas(jm, jes.layout, 700, out_dtype=od,
                                                   interpret=True)
        return jagg.aggregate_sorted_pallas(jm, jes.layout, 700, out_dtype=od,
                                            interpret=True)

    def port_run(od):
        if form == "presorted":
            return tagg.aggregate_presorted(tm, tes.layout, 700, out_dtype=od)
        return tagg.aggregate_sorted(tm, tes.layout, 700, out_dtype=od)

    got, want = port_run(torch.bfloat16), jax_run(jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (700, 8)
    _close8(got, want)
    ref32 = jax_run(jnp.float32)
    _nearer_f32_sum(got, want, ref32)
    np.testing.assert_allclose(_np(port_run(torch.float32)), _np(ref32), **TOL)
    # the port's bf16 output is its own f32 sum rounded once
    assert torch.equal(got, port_run(torch.float32).to(torch.bfloat16))


def test_rel_spmm_diag_aggregate():
    """rel_spmm_diag(aggregate=) hands the messages to the caller's sum: K1
    over the layout on both sides, and the default segment sum."""
    jes, tes, rng = _graph()
    x, dw = _f32(rng, 300, 8), _f32(rng, 10, 8)
    jx, jdw = jnp.asarray(x), jnp.asarray(dw)
    tx, tdw = torch.from_numpy(x), torch.from_numpy(dw)
    want = jops.rel_spmm_diag(jes, jx, jdw, aggregate=lambda m, e: jagg.aggregate_sorted_pallas(
        m, e.layout, e.num_nodes, interpret=True))
    seen = []

    def k1(m, e):
        seen.append(m.shape)
        return tagg.aggregate_sorted(m, e.layout, e.num_nodes)

    got = tops.rel_spmm_diag(tes, tx, tdw, aggregate=k1)
    assert seen == [(tes.src.shape[0], 8)]
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tops.rel_spmm_diag(tes, tx, tdw)),
                               _np(jops.rel_spmm_diag(jes, jx, jdw)), **TOL)
