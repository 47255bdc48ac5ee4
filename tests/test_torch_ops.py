"""Plain versions of K1/K2/K3 and the port's SpMM paths against the JAX
package's Pallas kernels (interpret mode) and XLA oracles, f32 on the CPU.

Tolerance rtol 1e-5, atol 1e-6: the same f32 sums taken in another order.
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
from rgcn_tpu_torch.data.synthetic import skew_triples
from rgcn_tpu_torch.graph.structure import build_edge_set as t_build
from rgcn_tpu_torch.ops import aggregate as tagg
from rgcn_tpu_torch.ops import fused as tfused
from rgcn_tpu_torch.ops import rel_spmm as trs
from rgcn_tpu_torch.ops import spmm as tops
from tests.conftest import make_random_triples

TOL = dict(rtol=1e-5, atol=1e-6)


def _graph(n, r, e, seed, **kw):
    rng = np.random.default_rng(seed)
    t = skew_triples(seed) if e is None else make_random_triples(rng, n, r, e)
    jes = j_build(t, n, r, with_dst_layout=True, prefer_native=False, **kw)
    tes = t_build(t, n, r, with_dst_layout=True, **kw).to("cpu")
    return jes, tes, rng


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


CASES = [
    dict(n=60, r=4, e=250, seed=1, tile_size=16),
    dict(n=700, r=5, e=3000, seed=2),  # several row blocks
    dict(n=300, r=3, e=1200, seed=3, layout_row_block=64),
    # a hub spanning many chunks; row blocks of pads only, all-gap chunks
    dict(n=1536, r=4, e=None, seed=4),
]
IDS = ["small", "blocks", "rb64", "skewed"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k1_plain_matches_pallas(case):
    case = dict(case)
    n, r, e, seed = (case.pop(k) for k in ("n", "r", "e", "seed"))
    jes, tes, rng = _graph(n, r, e, seed, **case)
    dout = 8
    msgs = _f32(rng, jes.src.shape[0], dout)
    want = np.asarray(jagg.aggregate_sorted_pallas(
        jnp.asarray(msgs), jes.layout, n, interpret=True))
    got = tagg.aggregate_sorted(torch.from_numpy(msgs), tes.layout, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    sorted_msgs = _f32(rng, jes.layout.perm.shape[0], dout)
    want = np.asarray(jagg.aggregate_presorted_pallas(
        jnp.asarray(sorted_msgs), jes.layout, n, interpret=True))
    got = tagg.aggregate_presorted(torch.from_numpy(sorted_msgs), tes.layout, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k2_plain_matches_pallas(case):
    case = dict(case)
    n, r, e, seed = (case.pop(k) for k in ("n", "r", "e", "seed"))
    jes, tes, rng = _graph(n, r, e, seed, **case)
    # layer-2 scale: relu'd activations, glorot-scale weights
    x = np.maximum(_f32(rng, n, 16), 0)
    w = _f32(rng, 2 * r, 16, 4) * np.float32(0.25)
    want = np.asarray(jfused.rel_spmm_fused(
        jes.fused, n, jnp.asarray(x), jnp.asarray(w), compute_dtype=None,
        interpret=True))
    got = tfused.rel_spmm_fused(tes.fused, n, torch.from_numpy(x),
                                torch.from_numpy(w), compute_dtype=None)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k3_plain_matches_pallas(case):
    case = dict(case)
    n, r, e, seed = (case.pop(k) for k in ("n", "r", "e", "seed"))
    jes, tes, rng = _graph(n, r, e, seed, **case)
    x = _f32(rng, n, 12)
    w = _f32(rng, 2 * r, 12, 6)
    want = np.asarray(jspmm.rel_spmm_messages(
        jes, jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = trs.rel_spmm_messages(tes, torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("width,fused", [(16, True), (72, False)])
def test_fwd_spmm_branches_match_xla(width, fused):
    """K2 when W fits the shared-memory budget; K3 then K1 when it does not
    (8 relations x 72 x 72 f32 plus the accumulator exceed 227 KB)."""
    jes, tes, rng = _graph(60, 4, 250, 9, tile_size=16)
    x = np.maximum(_f32(rng, 60, width), 0)
    w = _f32(rng, 8, width, width) * np.float32(width ** -0.5)
    wt = torch.from_numpy(w)
    assert trs.fused_fits(wt, tes.fused.row_block) == fused
    want = np.asarray(jops.rel_spmm(jes, jnp.asarray(x), jnp.asarray(w)))
    got = trs.fwd_spmm(tes, torch.from_numpy(x), wt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    full = trs.rel_spmm_full(tes, tes.layout, torch.from_numpy(x), wt)
    np.testing.assert_allclose(full.numpy(), want, **TOL)


def test_fwd_spmm_without_fused_layout_takes_k3():
    import dataclasses

    jes, tes, rng = _graph(60, 4, 250, 10, tile_size=16)
    x, w = _f32(rng, 60, 8), _f32(rng, 8, 8, 4)
    want = np.asarray(jops.rel_spmm(jes, jnp.asarray(x), jnp.asarray(w)))
    got = trs.fwd_spmm(dataclasses.replace(tes, fused=None),
                       torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrappers_reject_operands_off_the_graph():
    """The kernels do not bounds-check their gathers: the wrappers hold the
    operands to the graph's sizes on every device."""
    _, tes, rng = _graph(60, 4, 250, 13, tile_size=16)
    e_pad, slots = tes.src.shape[0], tes.layout.perm.shape[0]
    assert tes.layout.num_edges == e_pad and tes.fused.num_rels == 8
    with pytest.raises(ValueError, match="messages for a layout"):
        tagg.aggregate_sorted(torch.zeros(e_pad - 1, 4), tes.layout, 60)
    with pytest.raises(ValueError, match="sorted messages"):
        tagg.aggregate_presorted(torch.zeros(slots + 1, 4), tes.layout, 60)
    x, w = torch.zeros(60, 8), torch.zeros(8, 8, 4)
    for bad_x, bad_w in ((x[:59], w), (x, w[:7]), (x, torch.zeros(9, 8, 4))):
        with pytest.raises(ValueError, match="rows|relations"):
            tfused.rel_spmm_fused(tes.fused, 60, bad_x, bad_w, compute_dtype=None)
        with pytest.raises(ValueError, match="rows|relations"):
            trs.rel_spmm_messages(tes, bad_x, bad_w)


def test_plain_oracles_match_xla():
    jes, tes, rng = _graph(80, 3, 300, 12, tile_size=8)
    msgs = _f32(rng, jes.src.shape[0], 5)
    np.testing.assert_allclose(
        tops.aggregate_messages(torch.from_numpy(msgs), tes.dst, 80).numpy(),
        np.asarray(jops.aggregate_messages(jnp.asarray(msgs), jes.dst, 80)),
        **TOL,
    )
    x, w = _f32(rng, 80, 6), _f32(rng, 6, 6, 3)
    np.testing.assert_allclose(
        tops.rel_spmm(tes, torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jops.rel_spmm(jes, jnp.asarray(x), jnp.asarray(w))),
        **TOL,
    )
    wf = _f32(rng, 6, 80, 4)
    want = np.asarray(jops.rel_spmm_featureless(jes, jnp.asarray(wf)))
    np.testing.assert_allclose(
        tops.rel_spmm_featureless(tes, torch.from_numpy(wf)).numpy(), want, **TOL)
    # the same with K1's plain version as the destination sum
    got = tops.rel_spmm_featureless(
        tes, torch.from_numpy(wf),
        aggregate=lambda m, es: tagg.aggregate_sorted(m, es.layout, es.num_nodes),
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
