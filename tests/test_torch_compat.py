"""The port's L1 compat primitives (``rgcn_tpu_torch/graph/compat.py``)
against the golden cases of ``tests/test_compat.py`` and, on seeded random
graphs augmented by the port's own ``augment_triples``, against
``rgcn_tpu.graph.compat``: stacking and block-diagonals bit-equal,
``drop_edges`` bit-equal under the same generator, ``sum_sparse`` within
one f32 ulp."""

import numpy as np
import pytest
import torch

from rgcn_tpu.graph import compat as jcompat
from rgcn_tpu_torch.graph.augment import augment_triples
from rgcn_tpu_torch.graph.compat import (
    block_diag,
    drop_edges,
    stack_matrices,
    sum_sparse,
)

# the 4-node, 3-relation toy graph of tests/test_compat.py: originals,
# inverses, then self-loops (relation ids 0, 1 = inverse, 2 = self)
TOY = np.array(
    [
        [0, 0, 1],
        [1, 0, 2],
        [2, 0, 3],
        [1, 1, 0],
        [2, 1, 1],
        [3, 1, 2],
        [0, 2, 0],
        [1, 2, 1],
        [2, 2, 2],
        [3, 2, 3],
    ]
)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_stack_matrices_vertical_exact(as_tensor):
    toy = torch.as_tensor(TOY) if as_tensor else TOY
    idx, size = stack_matrices(toy, 4, 3, vertical_stacking=True)
    assert isinstance(idx, torch.Tensor) and size == (12, 4)
    np.testing.assert_array_equal(idx[:, 0].numpy(), TOY[:, 1] * 4 + TOY[:, 0])
    np.testing.assert_array_equal(idx[:, 1].numpy(), TOY[:, 2])
    assert idx[:, 0].max() < 12 and idx[:, 1].max() < 4


def test_stack_matrices_horizontal_exact():
    idx, size = stack_matrices(TOY, 4, 3, vertical_stacking=False)
    assert size == (4, 12)
    np.testing.assert_array_equal(idx[:, 0].numpy(), TOY[:, 0])
    np.testing.assert_array_equal(idx[:, 1].numpy(), TOY[:, 1] * 4 + TOY[:, 2])


def test_sum_sparse_row_normalisation():
    idx, size = stack_matrices(TOY, 4, 3, vertical_stacking=True)
    sums = sum_sparse(idx, np.ones(len(TOY), dtype=np.float32), size,
                      row_normalisation=True)
    assert sums.dtype == torch.float32
    # every (s, p) pair in TOY is unique: every row sum is 1
    np.testing.assert_array_equal(sums.numpy(), np.ones(len(TOY)))

    dup = np.concatenate([TOY, TOY[:1]], axis=0)  # the first edge twice
    idx, size = stack_matrices(dup, 4, 3, vertical_stacking=True)
    sums = sum_sparse(idx, torch.ones(len(dup)), size, row_normalisation=True)
    assert sums[0] == 2.0 and sums[-1] == 2.0
    np.testing.assert_array_equal(sums[1:-1].numpy(), np.ones(len(dup) - 2))


def test_sum_sparse_column_normalisation_with_reorder():
    """Column sums come back in transposed order; after the reference's
    reorder every edge is divided by its subject's out-degree under its
    relation, the vertical row sums."""
    rng = np.random.default_rng(0)
    triples = np.stack(
        [rng.integers(0, 6, 30), rng.integers(0, 2, 30), rng.integers(0, 6, 30)],
        axis=1,
    )
    aug = augment_triples(triples, 6, 2)
    n, i = len(triples), 6  # i: the self-loops

    idx_h, size_h = stack_matrices(aug, 6, 5, vertical_stacking=False)
    sums_h = sum_sparse(idx_h, np.ones(len(aug)), size_h, row_normalisation=False)
    reordered = torch.cat([sums_h[n:2 * n], sums_h[:n], sums_h[-i:]])
    idx_v, size_v = stack_matrices(aug, 6, 5, vertical_stacking=True)
    sums_v = sum_sparse(idx_v, np.ones(len(aug)), size_v, row_normalisation=True)
    np.testing.assert_array_equal(reordered.numpy(), sums_v.numpy())


def test_block_diag_exact():
    out = block_diag(np.ones((4, 3, 2), dtype=np.float32))
    assert out.shape == (12, 8) and out.dtype == torch.float32
    assert out.sum() == 4 * 3 * 2
    assert out[0, 0] == 1 and out[0, 2] == 0 and out[3, 2] == 1


def test_drop_edges_keep_counts():
    aug = augment_triples(TOY[:3], 4, 3)  # 3 + 3 + 4 rows
    kept = drop_edges(aug, 4, general_dropout=0.5, self_loop_dropout=0.25,
                      rng=np.random.default_rng(1))
    # floor(0.5 * 6) general rows + floor(0.75 * 4) self-loops
    assert len(kept) == 3 + 3


def _random_graph(seed, num_nodes=50, num_rels=4, num_edges=400):
    rng = np.random.default_rng(seed)
    triples = np.stack([rng.integers(0, num_nodes, num_edges),
                        rng.integers(0, num_rels, num_edges),
                        rng.integers(0, num_nodes, num_edges)], axis=1)
    return augment_triples(np.unique(triples, axis=0), num_nodes, num_rels)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("vertical", [True, False])
def test_stack_and_sum_sparse_match_jax(seed, vertical):
    n, r = 50, 2 * 4 + 1
    aug = _random_graph(seed)
    idx, size = stack_matrices(aug, n, r, vertical_stacking=vertical)
    jidx, jsize = jcompat.stack_matrices(aug, n, r, vertical_stacking=vertical)
    assert size == jsize and idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), jidx)

    vals = np.random.default_rng(seed + 10).random(len(aug)).astype(np.float32)
    for row_norm in (True, False):
        got = sum_sparse(torch.as_tensor(idx), torch.as_tensor(vals), size,
                         row_normalisation=row_norm).numpy()
        ref = jcompat.sum_sparse(jidx, vals, jsize, row_normalisation=row_norm)
        assert got.dtype == ref.dtype == np.float32
        # the f64 sums may take another order: at most one f32 ulp apart
        assert (np.abs(got - ref) <= np.spacing(np.abs(ref))).all()


@pytest.mark.parametrize("shape", [(4, 3, 2), (2, 5, 3, 4), (3, 1, 2, 2, 6)])
def test_block_diag_matches_jax(shape):
    blocks = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    got = block_diag(torch.as_tensor(blocks))
    ref = jcompat.block_diag(blocks)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("rates", [(0.5, 0.25), (0.0, 0.0), (0.9, 1.0)])
def test_drop_edges_matches_jax(seed, rates):
    aug = _random_graph(seed)
    got = drop_edges(torch.as_tensor(aug), 50, *rates, rng=np.random.default_rng(seed))
    ref = jcompat.drop_edges(aug, 50, *rates, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(got.numpy(), ref)
