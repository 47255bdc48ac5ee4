"""The port's canary (``rgcn_tpu_torch/utils/canary.py``) on the CPU: its
workload bit-equal to ``rgcn_tpu.utils.canary._build_workload``'s at full
size, one step at a cut size against the JAX op (Pallas K5 in interpret
mode, f32), the bf16 step at that size against the JAX step (bf16 table,
within 8e-3·max(1, max|ref|) of its op), and the floor's ratchet."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.data.synthetic import synthetic_kg as j_synthetic_kg
from rgcn_tpu.graph.coalesce import build_merged_layout as j_build_merged_layout
from rgcn_tpu.graph.structure import build_edge_set as j_build_edge_set
from rgcn_tpu.ops.pallas_basis import rel_spmm_basis_merged_ad
from rgcn_tpu.utils import canary as jcanary
from rgcn_tpu_torch.utils import canary

CUT = dict(num_nodes=1_500, num_rels=18, num_edges=6_000)


def _assert_workload_equal(edges, x, pack, jx, jpack):
    jw_self, jbases, jcomps, jm = jpack
    for got, ref in zip((x, *pack), (jx, jw_self, jbases, jcomps)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    m = edges.merged
    for f in ("src_sorted", "coeff", "rev_src_sorted", "rev_receiver", "rev_coeff"):
        np.testing.assert_array_equal(getattr(m, f).numpy(), np.asarray(getattr(jm, f)))
    for frame, jframe in ((m.layout, jm.layout), (m.rev_layout, jm.rev_layout)):
        for f in ("perm", "local_dst", "chunk_block"):
            np.testing.assert_array_equal(getattr(frame, f).numpy(),
                                          np.asarray(getattr(jframe, f)))
    dd, jdd = m.fwd_dedup, jm.fwd_dedup
    for f in ("src_sorted", "local_k", "chunk_block", "coeff_k"):
        np.testing.assert_array_equal(getattr(dd, f).numpy(), np.asarray(getattr(jdd, f)))
    assert (m.num_pairs, m.num_edges) == (jm.num_pairs, jm.num_edges)


def test_workload_bit_equal_to_jax_at_full_size():
    edges, x, pack = canary.build_workload(device="cpu")
    jes, jx, jpack = jcanary._build_workload()
    assert x.shape == (40_943, 200) and edges.num_edges == jes.num_edges
    _assert_workload_equal(edges, x, pack, jx, jpack)


def _jax_workload(num_nodes, num_rels, num_edges):
    """``_build_workload``'s recipe at the given sizes."""
    triples = j_synthetic_kg(num_nodes, num_rels, num_edges, seed=0, reciprocity=0.9)
    es = j_build_edge_set(triples, num_nodes, num_rels, tile_size=512)
    merged = j_build_merged_layout(
        np.asarray(es.dst), np.asarray(es.src), np.asarray(es.rel),
        np.asarray(es.val), num_nodes, es.num_rels,
        row_block=128, chunk=256, dedup_k=2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(num_nodes, 200)).astype(np.float32)
    w_self = rng.normal(size=(200, 200)).astype(np.float32)
    rng_b = np.random.default_rng(1)
    bases = rng_b.normal(size=(2, 200, 200)).astype(np.float32)
    comps = rng_b.normal(size=(2 * num_rels, 2)).astype(np.float32)
    return x, (w_self, bases, comps, merged)


def test_step_matches_jax_op_at_cut_size():
    edges, x, pack = canary.build_workload(**CUT, device="cpu")
    jx, jpack = _jax_workload(**CUT)
    _assert_workload_equal(edges, x, pack, jx, jpack)
    w_self, bases, comps, m = jpack
    # the JAX step's op in f32 (compute_dtype=None: Pallas K5 in interpret mode)
    ref = np.asarray(rel_spmm_basis_merged_ad(m, jnp.asarray(jx), jnp.asarray(bases),
                                              jnp.asarray(comps), compute_dtype=None)
                     + jnp.asarray(jx) @ jnp.asarray(w_self))
    got = canary.canary_op(edges, x, pack, compute_dtype=None).numpy()
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= tol
    step = canary.canary_step(edges, x, pack).numpy()
    np.testing.assert_allclose(step, jx + ref * np.float32(1e-9), rtol=0, atol=1e-6)


def test_bf16_step_matches_jax_step_at_cut_size():
    """The canary's step, as the JAX step runs it: the merged op with a
    bf16 compute dtype (K5 on a bf16 table, a bf16 Agg) plus ``x @
    w_self`` with ``w_self`` rounded to bf16, held to the JAX step's op
    within 8e-3·max(1, max|ref|); the f32 op must differ from it and lie at
    least 4 times farther from the JAX op (max norm)."""
    edges, x, pack = canary.build_workload(**CUT, device="cpu")
    jx, (w_self, bases, comps, m) = _jax_workload(**CUT)
    jx, w_self, bases, comps = map(jnp.asarray, (jx, w_self, bases, comps))
    ref = np.asarray(rel_spmm_basis_merged_ad(m, jx, bases, comps,
                                              compute_dtype=jnp.bfloat16)
                     + jx @ w_self.astype(jnp.bfloat16))
    got = canary.canary_op(edges, x, pack).numpy()
    assert np.abs(got - ref).max() <= 8e-3 * max(1.0, float(np.abs(ref).max()))
    f32 = canary.canary_op(edges, x, pack, compute_dtype=None).numpy()
    assert np.abs(got - f32).max() > 1e-6 * float(np.abs(ref).max())
    assert np.abs(got - ref).max() <= 0.25 * np.abs(f32 - ref).max()
    step = canary.canary_step(edges, x, pack).numpy()
    want = np.asarray(jcanary._make_step()(jx, (w_self, bases, comps, m)))
    np.testing.assert_allclose(step, want, rtol=0, atol=1e-6)


@pytest.fixture
def cut_workload(monkeypatch):
    """build_workload at the cut size, built once per test."""
    built = {}
    real = canary.build_workload

    def build(device=None, **sizes):
        key = tuple(sorted({**CUT, **sizes}.items()))
        if key not in built:
            built[key] = real(**dict(key), device=device)
        return built[key]

    monkeypatch.setattr(canary, "build_workload", build)
    return build


def test_measure_canary_on_cpu(tmp_path, cut_workload):
    out = canary.measure_canary(cache_dir=str(tmp_path), iters=2, passes=1,
                                device="cpu", verbose=False)
    assert out["steps"] == 1 + 1 * 3 * 2
    assert out["ms"] > 0 and out["floor_ms"] == out["ms"] and out["ratio"] == 1.0
    assert out["healthy"] is True
    key = json.loads(out["key"])
    assert key["card"] == "cpu" and key["kernel"].startswith("k5_weighted_aggregate_dedup")
    assert key["nodes"] == CUT["num_nodes"] and key["dim"] == 200
    with open(tmp_path / "canary_floor.json") as f:
        assert json.load(f) == {"key": out["key"], "floor_ms": out["ms"]}


def test_floor_ratchets_down_and_a_new_key_starts_a_new_floor(
        tmp_path, monkeypatch, cut_workload):
    times = iter([2.0, 3.0, 2.4, 1.0, 1.3, 5.0, 6.0])
    monkeypatch.setattr(canary, "_measure_step",
                        lambda step, x, iters, passes=2: (next(times), 7))

    def measure():
        return canary.measure_canary(cache_dir=str(tmp_path), device="cpu",
                                     verbose=False)

    got = [measure() for _ in range(5)]
    assert [g["floor_ms"] for g in got] == [2.0, 2.0, 2.0, 1.0, 1.0]
    assert [g["ratio"] for g in got] == pytest.approx([1.0, 1.5, 1.2, 1.0, 1.3])
    assert [g["healthy"] for g in got] == [True, False, True, True, False]
    assert canary.HEALTHY_RATIO == jcanary.HEALTHY_RATIO == 1.25
    # another workload shape is another key: its own floor, from its first run
    monkeypatch.setattr(canary, "build_workload",
                        lambda device=None: cut_workload(device=device, num_edges=5_000))
    new = measure()
    assert new["key"] != got[0]["key"]
    assert (new["floor_ms"], new["ratio"], new["healthy"]) == (5.0, 1.0, True)
    again = measure()
    assert (again["floor_ms"], again["healthy"]) == (5.0, True)
    assert again["ratio"] == pytest.approx(1.2)


def test_failed_floor_write_is_reported_and_passed_over(tmp_path, capsys, cut_workload):
    blocker = tmp_path / "file"
    blocker.write_text("")  # the cache directory cannot be made under a file
    out = canary.measure_canary(cache_dir=str(blocker / "canary"), iters=1, passes=1,
                                device="cpu", verbose=False)
    assert out["ratio"] == 1.0
    assert "canary: floor write failed" in capsys.readouterr().err
    assert not os.path.exists(blocker / "canary")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        canary.measure_canary(verbose=False)
    assert canary.default_cache_dir().endswith(os.path.join("build", "rgcn_tpu_torch",
                                                            "canary"))
