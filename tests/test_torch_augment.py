"""The port's triple augmentation (``rgcn_tpu_torch/graph/augment.py``)
bit-equal to ``rgcn_tpu.graph.augment`` in values and dtype, physical edge
dropout over the port's own augmented triples against the JAX package's,
and ``nn/init.py::uniform_symmetric`` against the JAX initialiser's
distribution."""

import numpy as np
import pytest
import torch

from rgcn_tpu.graph import augment as jaugment
from rgcn_tpu.graph import compat as jcompat
from rgcn_tpu_torch.graph.augment import (
    augment_triples,
    inverse_triples,
    self_loop_triples,
    split_spo,
)
from rgcn_tpu_torch.graph.compat import drop_edges
from rgcn_tpu_torch.nn.init import select_weight_init, uniform_symmetric


def _seeded(seed, num_nodes, num_rels, num_edges):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, num_nodes, num_edges),
                     rng.integers(0, num_rels, num_edges),
                     rng.integers(0, num_nodes, num_edges)], axis=1)


# (triples, num_nodes, num_rels): the cases of tests/test_graph.py's
# test_augment_exact and test_inverse_and_self_shapes, then three seeded
# graphs (int64, int32 and a graph with isolated nodes)
CASES = {
    "augment_exact": (np.array([[0, 0, 1], [1, 1, 2]]), 3, 2),
    "inverse_and_self": (np.array([[0, 0, 1], [2, 1, 0], [1, 0, 2]]), 4, 2),
    "seed0": (_seeded(0, 50, 4, 400), 50, 4),
    "seed1_int32": (_seeded(1, 200, 7, 1000).astype(np.int32), 200, 7),
    "seed2_isolated": (_seeded(2, 30, 3, 40), 300, 3),
}


def _same(got, ref):
    assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_augment_functions_match_jax(case):
    triples, n, r = CASES[case]
    _same(inverse_triples(triples, r), jaugment.inverse_triples(triples, r))
    _same(self_loop_triples(n, r), jaugment.self_loop_triples(n, r))
    aug = augment_triples(triples, n, r)
    _same(aug, jaugment.augment_triples(triples, n, r))
    assert aug.dtype == np.int64 and self_loop_triples(n, r).dtype == np.int64
    for got, ref in zip(split_spo(aug), jaugment.split_spo(aug)):
        _same(got, ref)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_split_spo_3d(as_tensor):
    batch = _seeded(3, 20, 5, 24).reshape(2, 12, 3)
    given = torch.as_tensor(batch) if as_tensor else batch
    for got, ref in zip(split_spo(given), jaugment.split_spo(batch)):
        assert isinstance(got, torch.Tensor if as_tensor else np.ndarray)
        assert tuple(got.shape) == (2, 12)
        np.testing.assert_array_equal(np.asarray(got), ref)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("rates", [(0.5, 0.25), (0.0, 0.0), (0.9, 1.0)])
def test_drop_edges_over_port_augment_matches_jax(seed, rates):
    triples = np.unique(_seeded(seed, 50, 4, 400), axis=0)
    aug = augment_triples(triples, 50, 4)
    got = drop_edges(aug, 50, *rates, rng=np.random.default_rng(seed))
    ref = jcompat.drop_edges(jaugment.augment_triples(triples, 50, 4), 50, *rates,
                             rng=np.random.default_rng(seed))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bound", [0.05, 1.0, 3.0])
def test_uniform_symmetric_range_and_dtype(bound):
    w = uniform_symmetric(bound)((64, 33, 2), torch.Generator().manual_seed(0))
    assert w.dtype == torch.float32 and tuple(w.shape) == (64, 33, 2)
    assert bool((w >= -bound).all()) and bool((w <= bound).all())
    # both signs, near both ends
    assert float(w.min()) < -0.9 * bound and float(w.max()) > 0.9 * bound


def test_uniform_symmetric_same_generator_same_draw():
    init = uniform_symmetric(0.5)
    a = init((40, 7), torch.Generator().manual_seed(11))
    b = init((40, 7), torch.Generator().manual_seed(11))
    c = init((40, 7), torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_uniform_symmetric_moments_match_jax():
    """Mean and variance (bound^2 / 3) as JAX's uniform_symmetric draws them,
    within 1% at 200,000 draws (the bits differ: jax.random is not torch's
    generator)."""
    import jax

    from rgcn_tpu.nn.init import uniform_symmetric as j_uniform_symmetric

    bound, shape = 0.7, (400, 500)
    got = uniform_symmetric(bound)(shape, torch.Generator().manual_seed(0)).double()
    ref = np.asarray(j_uniform_symmetric(bound)(jax.random.PRNGKey(0), shape),
                     dtype=np.float64)
    var = bound ** 2 / 3
    for draws in (got.numpy(), ref):
        assert draws.size == 200_000
        assert abs(draws.mean()) < 0.01 * bound
        assert abs(draws.var() - var) < 0.01 * var
    assert abs(got.mean().item() - ref.mean()) < 0.01 * bound
    assert abs(got.var().item() - ref.var()) < 0.01 * var


def test_select_weight_init_does_not_dispatch_to_uniform_symmetric():
    with pytest.raises(NotImplementedError):
        select_weight_init("uniform-symmetric")
