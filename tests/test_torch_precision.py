"""The edge stage's compute dtype, in the port against the JAX package, on
the CPU: its ops (the layer's branches are in
``test_torch_precision_layers.py``, the decoder's narrow backward in
``test_torch_precision_decoder.py``).

``_edge_compute_dtype`` by device. Each op with
``compute_dtype=torch.bfloat16`` (forward and gradients) against the JAX
op with ``compute_dtype=jnp.bfloat16``: the basis op over an unmerged, a
merged and a source-dedup'd merged frame, the featureless basis op (8
bases through K4; more, per tile and through the pair index), the
featureful pair op, and the diagonal op in both frames; the same op in f32
must differ from the bf16 result somewhere (the narrowing happened). The
plain K1, K4 and K5 on bf16 tables are in
``test_torch_precision_kernels.py``. Pallas runs in interpret mode; the
port runs its kernels' plain versions on CPU tensors. Tolerance 8e-3·max(1, max|ref|), the bound of
the JAX package's own bf16 test (``tests/test_basis.py:58``); a narrowing
shows as a difference above 1e-6·max|ref|, and each narrowed result lies
at least 4 times nearer JAX's bf16 result than the port's f32 result does
(max norm), which an op that rounded at other places would miss.

One deliberate difference: the pair contraction's coefficients are
rounded to bf16 and widened back before ``comps[pair_rel]`` (the same
values), so their gradient sums over a relation's pairs in f32 and rounds
once to bf16, where JAX gathers the bf16 coefficients and XLA's bf16
scatter rounds every update (a sum that stagnates once its half-ulp
exceeds a term, ~1% off at these sizes; on the card a bf16 scatter would
add in no fixed order). The pair routes' JAX reference therefore runs
``_pair_contract`` on the widened coefficients
(:func:`_f32_coefficient_sums`): the same casts, an f32 scatter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.graph import coalesce as jco
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.ops import spmm as jspmm
from rgcn_tpu.ops.pallas_basis import rel_spmm_basis_ad as j_basis_ad
from rgcn_tpu.ops.pallas_basis import rel_spmm_basis_merged_ad as j_merged_ad
from rgcn_tpu.ops.pallas_basis import rel_spmm_featureless_basis_ad as j_fl_ad
from rgcn_tpu.ops.pallas_diag import rel_spmm_diag_ad as j_diag_ad
from rgcn_tpu_torch.graph import coalesce as tco
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.nn import layers as tlayers
from rgcn_tpu_torch.ops import spmm as tspmm
from rgcn_tpu_torch.ops.basis import rel_spmm_basis, rel_spmm_featureless_basis_fwd
from rgcn_tpu_torch.ops.diag import rel_spmm_diag_ad
from tests.conftest import make_random_triples

BF16 = torch.bfloat16


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _close8(got, want, what=""):
    """Within 8e-3·max(1, max|ref|) of the JAX bf16 result."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 8e-3 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"


def _narrowed(got_bf16, got_f32, ref, what=""):
    """The bf16 result differs from the f32 one: the narrowing happened."""
    gap = float(np.abs(_np(got_bf16) - _np(got_f32)).max())
    assert gap > 1e-6 * float(np.abs(_np(ref)).max()), f"{what}: no narrowing ({gap})"


def _nearer(got_bf16, got_f32, want, what=""):
    """The bf16 result lies nearer JAX's bf16 result than the f32 one does,
    by a factor of 4 in max norm: ops that rounded at other places than JAX
    pass 8e-3 but not this."""
    err = float(np.abs(_np(got_bf16) - _np(want)).max())
    gap = float(np.abs(_np(got_f32) - _np(want)).max())
    assert err <= 0.25 * gap, f"{what}: {err:.3g} from JAX's bf16, f32 is {gap:.3g}"


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _reciprocal(n, r, e, seed):
    """Random triples with a share reversed again and a share repeated
    under another relation: parallel edges the merged frames coalesce."""
    rng = np.random.default_rng(seed)
    t = make_random_triples(rng, n, r, e)
    extra = t[: e // 3].copy()
    extra[:, 1] = (extra[:, 1] + 1) % r
    return np.unique(np.concatenate([t, t[: e // 2, ::-1], extra]), axis=0), rng


def _graphs(n, r, e, seed, **kw):
    t, rng = _reciprocal(n, r, e, seed)
    kw = dict(tile_size=16, with_dst_layout=True, **kw)
    return j_build(t, n, r, prefer_native=False, **kw), build_edge_set(t, n, r, **kw).to("cpu"), rng


_J_PAIR_CONTRACT = jspmm._pair_contract


def _f32_coefficient_sums(monkeypatch):
    """JAX's pair contraction with its coefficients gathered in f32 and
    cast to the rows' dtype after the gather (``_pair_contract`` casts
    ``c_u`` itself): the forward is unchanged, the coefficient gradient
    scatters in f32 as the port sums it."""
    def contract(table, comps, pi, nb, dout, *, precision=None):
        return _J_PAIR_CONTRACT(table, comps.astype(jnp.float32), pi, nb, dout,
                                precision=precision)

    monkeypatch.setattr(jspmm, "_pair_contract", contract)


def _vjp_pair(jf, tf, inputs, cot):
    """(JAX output and input cotangents, port bf16 and f32 outputs and
    gradients) of ``jf``/``tf`` over the numpy ``inputs`` under ``cot``."""
    want, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in inputs))
    wgrads = vjp(jnp.asarray(cot))
    got = {}
    for dtype in (BF16, None):
        ts = [torch.tensor(a, requires_grad=True) for a in inputs]
        out = tf(*ts, dtype)
        out.backward(torch.from_numpy(cot))
        got[dtype] = (out.detach(), [t.grad for t in ts])
    return want, wgrads, got


def _check_vjp(want, wgrads, got, names):
    out, grads = got[BF16]
    assert out.dtype == torch.float32
    _close8(out, want, "forward")
    _narrowed(out, got[None][0], want, "forward")
    _nearer(out, got[None][0], want, "forward")
    for name, g, w, g32 in zip(names, grads, wgrads, got[None][1]):
        assert g.dtype == torch.float32, name
        _close8(g, w, name)
        _narrowed(g, g32, w, name)
        _nearer(g, g32, w, name)


# -- the compute dtype's one chooser ----------------------------------------------


def test_edge_compute_dtype_by_device():
    assert tlayers._edge_compute_dtype(torch.device("cpu")) is None
    assert tlayers._edge_compute_dtype(torch.device("cuda")) is BF16
    assert tlayers._edge_compute_dtype(torch.device("cuda", 0)) is BF16
    assert tlayers._edge_compute_dtype("cpu") is None


# -- the ops -------------------------------------------------------------------------


@pytest.mark.parametrize("frame", ["unmerged", "merged", "dedup"])
def test_basis_op_bf16_matches_jax(frame):
    n, r, nb, din, dout = 100, 4, 2, 16, 12
    jes, tes, rng = _graphs(n, r, 400, seed=3, layout_row_block=32)
    if frame != "unmerged":
        args = (jes.dst, jes.src, jes.rel, jes.val, n, jes.num_rels)
        mkw = dict(row_block=32, chunk=64, dedup_k=2 if frame == "dedup" else 0)
        jm, tm = jco.build_merged_layout(*args, **mkw), tco.build_merged_layout(*args, **mkw)
        assert (tm.fwd_dedup is not None) == (frame == "dedup")
        tes = dataclasses.replace(tes, merged=tm.to("cpu"))
    x, bases = _f32(rng, n, din), _f32(rng, nb, din, dout)
    comps, cot = _f32(rng, 2 * r, nb), _f32(rng, n, dout)

    def jf(x, bases, comps):
        if frame == "unmerged":
            return j_basis_ad(jes, x, bases, comps, compute_dtype=jnp.bfloat16)
        return j_merged_ad(jm, x, bases, comps, compute_dtype=jnp.bfloat16)

    def tf(x, bases, comps, dtype):
        return rel_spmm_basis(tes, x, bases, comps, compute_dtype=dtype)

    _check_vjp(*_vjp_pair(jf, tf, (x, bases, comps), cot), ("dx", "dbases", "dcomps"))
    with torch.no_grad():
        _close8(tf(*(torch.from_numpy(a) for a in (x, bases, comps)), BF16),
                jf(x, bases, comps), "no-grad forward")


@pytest.mark.parametrize("nb,route", [(8, "k4"), (12, "tiles"), (12, "pairs")])
def test_featureless_basis_op_bf16_matches_jax(nb, route, monkeypatch):
    n, r, dout = 80, 4, 6
    _f32_coefficient_sums(monkeypatch)
    jes, tes, rng = _graphs(n, r, 360, seed=nb, layout_row_block=32,
                            with_pair_index=route == "pairs", with_pair_agg=route == "pairs")
    bases, comps, cot = _f32(rng, nb, n, dout), _f32(rng, 2 * r, nb), _f32(rng, n, dout)

    def jf(bases, comps):
        if route == "k4":
            return j_fl_ad(jes, bases, comps, compute_dtype=jnp.bfloat16)
        return jspmm.rel_spmm_featureless_basis(jes, bases, comps,
                                                compute_dtype=jnp.bfloat16)

    def tf(bases, comps, dtype):
        if route == "k4":
            return rel_spmm_featureless_basis_fwd(tes, bases, comps, compute_dtype=dtype)
        return tspmm.rel_spmm_featureless_basis(tes, bases, comps, compute_dtype=dtype)

    if route == "tiles":  # the serving route: forward only, as the port runs it
        want = jf(bases, comps)
        with torch.no_grad():
            got = {d: tf(torch.from_numpy(bases), torch.from_numpy(comps), d)
                   for d in (BF16, None)}
        _close8(got[BF16], want, "forward")
        _narrowed(got[BF16], got[None], want, "forward")
        _nearer(got[BF16], got[None], want, "forward")
        return
    _check_vjp(*_vjp_pair(jf, tf, (bases, comps), cot), ("dbases", "dcomps"))


def test_pairs_op_bf16_matches_jax(monkeypatch):
    n, r, nb, din, dout = 80, 4, 12, 10, 7
    _f32_coefficient_sums(monkeypatch)
    jes, tes, rng = _graphs(n, r, 360, seed=7, with_pair_index=True, with_pair_agg=True)
    x, bases = np.maximum(_f32(rng, n, din), 0), _f32(rng, nb, din, dout)
    comps, cot = _f32(rng, 2 * r, nb), _f32(rng, n, dout)

    def jf(x, bases, comps):
        return jspmm.rel_spmm_basis_pairs(jes, x, bases, comps, compute_dtype=jnp.bfloat16)

    def tf(x, bases, comps, dtype):
        return tspmm.rel_spmm_basis_pairs(tes, x, bases, comps, compute_dtype=dtype)

    _check_vjp(*_vjp_pair(jf, tf, (x, bases, comps), cot), ("dx", "dbases", "dcomps"))


@pytest.mark.parametrize("merged", [False, True])
def test_diag_op_bf16_matches_jax(merged):
    n, r, d = 90, 5, 12
    jes, tes, rng = _graphs(n, r, 360, seed=11, with_merged_layout=merged)
    assert (tes.merged is not None) == merged
    x, dw, cot = _f32(rng, n, d), _f32(rng, 2 * r, d), _f32(rng, n, d)

    def jf(x, dw):
        return j_diag_ad(jes, x, dw, compute_dtype=jnp.bfloat16)

    def tf(x, dw, dtype):
        return rel_spmm_diag_ad(tes, x, dw, compute_dtype=dtype)

    _check_vjp(*_vjp_pair(jf, tf, (x, dw), cot), ("dx", "ddw"))
