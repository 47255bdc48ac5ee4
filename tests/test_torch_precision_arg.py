"""The XLA-route ops' ``precision=`` and the plain versions of K2's and
K3's bf16-weight forms, in the port against the JAX package, on the CPU.

``rel_spmm``, ``rel_spmm_block``, ``rel_spmm_featureless_basis`` (per
tile and through the pair index) and ``rel_spmm_basis_pairs`` under None,
``"default"``, ``"high"`` and ``"highest"`` against the JAX op under None
and ``jax.lax.Precision.DEFAULT``, ``HIGH``, ``HIGHEST``: forward and
gradients within 1e-5·max(1, max|ref|) (on the CPU XLA computes every
precision in full f32, and the port's ``"high"`` is three exact f32
products of split operands, so only the order of the f32 sums differs);
None, ``"default"`` and ``"highest"`` bit-equal to one another in the
port. An unknown name raises. Then K2's and K3's bf16-weight forms
through their plain versions (f32 ``x``, bf16 ``W``) against
``rel_spmm_fused(compute_dtype=None)`` and ``rel_spmm_messages`` in
interpret mode, and the no-other-mix rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.ops import pallas_fused as jfused
from rgcn_tpu.ops import pallas_spmm as jpspmm
from rgcn_tpu.ops import spmm as jops
from rgcn_tpu_torch.ops import fused as tfused
from rgcn_tpu_torch.ops import rel_spmm as trs
from rgcn_tpu_torch.ops import spmm as tops
from tests.test_torch_precision import _f32, _graphs, _np

PRECISIONS = {None: None, "default": jax.lax.Precision.DEFAULT,
              "high": jax.lax.Precision.HIGH, "highest": jax.lax.Precision.HIGHEST}


def _close5(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err:.3g} > {tol:.3g}"


def _ops(n, r, din, dout, nb, blocks, seed):
    """(name -> (JAX op, port op, numpy inputs), the edge sets, rng)."""
    jes, tes, rng = _graphs(n, r, 300, seed=seed)
    jps, tps, _ = _graphs(n, r, 300, seed=seed, with_pair_index=True, with_pair_agg=True)
    x = np.maximum(_f32(rng, n, din), 0)
    w = _f32(rng, 2 * r, din, dout, scale=0.3)
    blk = _f32(rng, 2 * r, blocks, din // blocks, dout // blocks, scale=0.3)
    bases_fl, bases = _f32(rng, nb, n, dout), _f32(rng, nb, din, dout, scale=0.3)
    comps = _f32(rng, 2 * r, nb)
    return {
        "rel_spmm": (lambda p, x, w: jops.rel_spmm(jes, x, w, precision=p),
                     lambda p, x, w: tops.rel_spmm(tes, x, w, precision=p), (x, w)),
        "rel_spmm_block": (lambda p, x, b: jops.rel_spmm_block(jes, x, b, precision=p),
                           lambda p, x, b: tops.rel_spmm_block(tes, x, b, precision=p),
                           (x, blk)),
        "featureless_basis_tiles": (
            lambda p, b, c: jops.rel_spmm_featureless_basis(jes, b, c, precision=p),
            lambda p, b, c: tops.rel_spmm_featureless_basis(tes, b, c, precision=p),
            (bases_fl, comps)),
        "featureless_basis_pairs": (
            lambda p, b, c: jops.rel_spmm_featureless_basis(jps, b, c, precision=p),
            lambda p, b, c: tops.rel_spmm_featureless_basis(tps, b, c, precision=p),
            (bases_fl, comps)),
        "basis_pairs": (
            lambda p, x, b, c: jops.rel_spmm_basis_pairs(jps, x, b, c, precision=p),
            lambda p, x, b, c: tops.rel_spmm_basis_pairs(tps, x, b, c, precision=p),
            (x, bases, comps)),
    }, rng


OPS = ["rel_spmm", "rel_spmm_block", "featureless_basis_tiles", "featureless_basis_pairs",
       "basis_pairs"]


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("op", OPS)
def test_ops_precision_match_jax(op, precision):
    n, r, din, dout = 50, 4, 12, 8
    ops, rng = _ops(n, r, din, dout, nb=6, blocks=4, seed=OPS.index(op) + 60)
    jf, tf, inputs = ops[op]
    cot = _f32(rng, n, dout)
    want, vjp = jax.vjp(lambda *a: jf(PRECISIONS[precision], *a),
                        *(jnp.asarray(a) for a in inputs))
    wgrads = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    got = tf(precision, *ts)
    got.backward(torch.from_numpy(cot))
    assert got.dtype == torch.float32
    _close5(got, want, "forward")
    for i, (g, w) in enumerate(zip(ts, wgrads)):
        _close5(g.grad, w, f"grad {i}")


@pytest.mark.parametrize("op", OPS)
def test_full_f32_precisions_are_one_path(op):
    """None, "default" and "highest" run the same full-f32 products: the
    same bits; "high" is a different sum of the same products' parts."""
    ops, _ = _ops(50, 4, 12, 8, nb=6, blocks=4, seed=7)
    _, tf, inputs = ops[op]
    ts = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        outs = {p: tf(p, *ts) for p in PRECISIONS}
    assert torch.equal(outs[None], outs["default"]) and torch.equal(outs[None], outs["highest"])
    _close5(outs["high"], outs["highest"], "high")


@pytest.mark.parametrize("bad", ["HIGH", "fastest", 3, jax.lax.Precision.HIGHEST])
def test_unknown_precision_raises(bad):
    ops, _ = _ops(30, 3, 8, 4, nb=3, blocks=2, seed=1)
    _, tf, inputs = ops["rel_spmm"]
    with pytest.raises(ValueError, match="precision"):
        tf(bad, *(torch.from_numpy(a) for a in inputs))
    with pytest.raises(ValueError, match="precision"):
        tops.check_precision(bad)


def test_high_splits_operands_exactly():
    """The split parts: the high part is TF32 (13 low mantissa bits zero)
    and high + low is the operand; a bf16 operand has no low part."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_f32(rng, 64, 9))
    low = tops._tf32_low(a)
    high = a - low
    assert torch.equal((high.view(torch.int32) & 8191), torch.zeros_like(high, dtype=torch.int32))
    assert torch.equal(high + low, a)
    b = a.to(torch.bfloat16).float()
    assert torch.equal(tops._tf32_low(b), torch.zeros_like(b))


# -- K2's and K3's bf16-weight forms (their plain versions) ---------------------------


@pytest.mark.parametrize("case", [dict(n=60, r=4, e=250, seed=1, tile_size=16),
                                  dict(n=700, r=5, e=3000, seed=2)], ids=["small", "blocks"])
def test_k2_wbf16_plain_matches_jax(case):
    """rel_spmm_fused(compute_dtype=None) over f32 x and a bf16 W: JAX's
    kernel promotes W in its dot (f32 messages and sums), the port's plain
    version widens it; within 1e-5·max(1, max|ref|), an f32 output."""
    from tests.test_torch_precision_spmm import _graph

    case = dict(case)
    n, r = case.pop("n"), case.pop("r")
    jes, tes, rng = _graph(n, r, **case)
    x = np.maximum(_f32(rng, n, 16), 0)
    w = jnp.asarray(_f32(rng, 2 * r, 16, 4, scale=0.25)).astype(jnp.bfloat16)
    want = jfused.rel_spmm_fused(jes.fused, n, jnp.asarray(x), w, compute_dtype=None,
                                 interpret=True)
    tw = torch.from_numpy(np.asarray(w).view(np.uint16).copy()).view(torch.bfloat16)
    got = tfused.rel_spmm_fused(tes.fused, n, torch.from_numpy(x), tw, compute_dtype=None)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close5(got, want)
    # the form's function: the f32 kernel's on the widened weights
    assert torch.equal(got, tfused.rel_spmm_fused(tes.fused, n, torch.from_numpy(x),
                                                  tw.float(), compute_dtype=None))


@pytest.mark.parametrize("out", [None, "f32"])
@pytest.mark.parametrize("dims", [(16, 4), (40, 48)], ids=["small", "tiled"])
def test_k3_wbf16_plain_matches_jax(dims, out):
    """rel_spmm_messages over f32 x and a bf16 W: f32 products of the
    widened weights, f32 sums, rounded once to out_dtype (default the
    weights' dtype, bf16, as JAX's)."""
    from tests.test_torch_precision_spmm import _graph

    din, dout = dims
    jes, tes, rng = _graph(n=120, r=4, e=600, seed=dout, tile_size=16)
    x = np.maximum(_f32(rng, 120, din), 0)
    w = jnp.asarray(_f32(rng, 8, din, dout, scale=din ** -0.5)).astype(jnp.bfloat16)
    jdt = None if out is None else jnp.float32
    want = jpspmm.rel_spmm_messages(jes, jnp.asarray(x), w, out_dtype=jdt, interpret=True)
    tw = torch.from_numpy(np.asarray(w).view(np.uint16).copy()).view(torch.bfloat16)
    tdt = None if out is None else torch.float32
    got = trs.rel_spmm_messages(tes, torch.from_numpy(x), tw, out_dtype=tdt)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if out is None:  # one rounding of f32 sums that may differ in order
        ref = _np(want)
        err = np.abs(_np(got) - ref)
        assert (err <= 2.0 ** -8 * np.abs(ref) + 1e-5 * max(1.0, np.abs(ref).max())).all()
    else:
        _close5(got, want)


def test_two_stage_route_with_bf16_weights_matches_jax():
    """rel_spmm_full (K3 then K1, f32 messages) and the differentiable
    rel_spmm_ad over f32 x and a bf16 W, routed as JAX routes them (W's
    own bytes): forward, dx and dW (bf16) against rel_spmm_pallas_ad."""
    from rgcn_tpu.ops.pallas_spmm import rel_spmm_pallas_ad

    jes, tes, rng = _graphs(70, 4, 300, seed=21)
    x = np.maximum(_f32(rng, 70, 10), 0)
    w = jnp.asarray(_f32(rng, 8, 10, 6, scale=0.3)).astype(jnp.bfloat16)
    cot = _f32(rng, 70, 6)
    want, vjp = jax.vjp(lambda a, b: rel_spmm_pallas_ad(jes, a, b), jnp.asarray(x), w)
    wdx, wdw = vjp(jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(np.asarray(w).view(np.uint16).copy()).view(
        torch.bfloat16).requires_grad_()
    for fused in (True, False):
        es = tes if fused else __import__("dataclasses").replace(tes, fused=None)
        tx.grad = tw.grad = None
        got = trs.rel_spmm_ad(es, tx, tw)
        got.backward(torch.from_numpy(cot))
        assert got.dtype == torch.float32 and tw.grad.dtype == torch.bfloat16
        _close5(got, want, "forward")
        _close5(tx.grad, wdx, "dx")
        ref = _np(wdw)  # bf16 on both sides: one rounding of f32 sums
        err = np.abs(_np(tw.grad) - ref)
        assert (err <= 2.0 ** -8 * np.abs(ref) + 1e-5 * max(1.0, np.abs(ref).max())).all()
    full = trs.rel_spmm_full(tes, tes.layout, torch.from_numpy(x), tw.detach())
    _close5(full, want, "rel_spmm_full")


def test_other_operand_mixes_raise():
    jes, tes, rng = _graphs(30, 3, 100, seed=4)
    x = torch.from_numpy(_f32(rng, 30, 8))
    w = torch.from_numpy(_f32(rng, 6, 8, 4))
    for xx, ww in ((x.to(torch.bfloat16), w), (x.double(), w), (x, w.half())):
        with pytest.raises(TypeError):
            tfused.rel_spmm_fused(tes.fused, 30, xx, ww, compute_dtype=None)
        with pytest.raises(TypeError):
            trs.rel_spmm_messages(tes, xx, ww)
