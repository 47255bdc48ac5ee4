"""The port's edge-sharding building blocks against the JAX package, on
the CPU: the manual-AD collectives' VJPs (gloo ranks spawned here, 2 and
4) against ``jax.vjp`` of ``all_reduce`` and ``fanout`` under
``shard_map`` on a mesh cut from conftest's 8 virtual devices; the
per-shard structures bit-equal to the JAX builders' (``shard_edge_set``
with ``prepare_sharded_layouts``, ``prepare_sharded_pairs_host`` on
balanced, imbalanced and empty shards, the LP epoch's host shards and
structured slices); the traffic model; and the launcher's refusals (a
failing rank, a hung rank, a CPU rank asked for NCCL).

The ranks run functions of this module in fresh processes, so JAX is
imported inside the tests only: a rank imports this module without it.
"""

import functools

import numpy as np
import pytest
import torch

from rgcn_tpu_torch.dist import mesh as tmesh
from rgcn_tpu_torch.dist.host import (
    build_sharded_epoch_host,
    build_sharded_structured_host,
)
from rgcn_tpu_torch.dist.multihost import (
    collective_bytes_per_step,
    initialize_distributed,
    spawn,
)
from rgcn_tpu_torch.graph.structure import build_edge_set


def random_triples(seed, n, r, e):
    rng = np.random.default_rng(seed)
    t = np.stack([rng.integers(0, n, e), rng.integers(0, r, e), rng.integers(0, n, e)],
                 axis=1)
    return np.unique(t, axis=0).astype(np.int64)


def jax_mesh(n):
    import jax

    from rgcn_tpu.dist.mesh import make_mesh

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return make_mesh(n)


def assert_same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_same_layout(got, want, what=""):
    for field in ("perm", "local_dst", "chunk_block"):
        assert_same(getattr(got, field), getattr(want, field), f"{what}.{field}")
    assert (got.num_row_blocks, got.row_block, got.chunk) == \
        (want.num_row_blocks, want.row_block, want.chunk), what


# -- the collectives -----------------------------------------------------------


def _collective_rank(dev, xs, y, c):
    """One rank: ``loss = Σ c · all_reduce(tanh(x_r) · fanout(y)) + Σ y²``."""
    import torch.distributed as dist

    from rgcn_tpu_torch.ops.collectives import all_reduce, fanout

    group = dist.group.WORLD
    x = torch.tensor(xs[dist.get_rank()], requires_grad=True)
    yy = torch.tensor(y, requires_grad=True)
    out = all_reduce(torch.tanh(x) * fanout(yy, group), group)
    loss = (out * torch.tensor(c)).sum() + (yy ** 2).sum()
    loss.backward()
    return {"loss": loss, "out": out, "dx": x.grad, "dy": yy.grad}


@pytest.mark.parametrize("n", [2, 4])
def test_collective_vjps_match_jax(n):
    """The Functions' forward and backward against ``jax.vjp`` of the JAX
    package's ``all_reduce`` / ``fanout`` in a ``shard_map(check_vma=False)``
    region: the per-shard input's gradient, the replicated input's (a
    fanned use plus a replicated one), the same bits on every rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rgcn_tpu.ops.collectives import all_reduce, fanout

    rng = np.random.default_rng(n)
    xs = rng.standard_normal((n, 5, 3)).astype(np.float32)
    y = rng.standard_normal((5, 3)).astype(np.float32)
    c = rng.standard_normal((5, 3)).astype(np.float32)
    mesh = jax_mesh(n)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("edge"), P()),
                       out_specs=(P(), P(), P("edge"), P()), check_vma=False)
    def region(x, y):
        # differentiated inside the region, as the JAX package's steps are
        def loss_fn(x0, y):
            out = all_reduce(jnp.tanh(x0) * fanout(y, "edge"), "edge")
            return (out * c).sum() + (y ** 2).sum(), out

        loss, vjp, out = jax.vjp(loss_fn, x[0], y, has_aux=True)
        dx, dy = vjp(jnp.ones(()))
        return loss, out, dx[None], dy

    loss, out, dxs, dy = region(jnp.asarray(xs), jnp.asarray(y))

    res = spawn(_collective_rank, n, (xs, y, c), device="cpu", num_threads=1)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(got["out"], out, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["dx"], np.asarray(dxs)[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["dy"], dy, rtol=1e-6, atol=1e-6)
        for key in ("out", "dy"):
            assert_same(got[key], res[0][key], f"rank {r} {key}")


# -- the launcher's refusals ---------------------------------------------------


def _fail_rank(dev, mode):
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        if mode == "raise":
            raise ValueError("rank 1 gives up")
        time.sleep(120)  # leaves rank 0 alone in its all-reduce
    t = torch.ones(1)
    dist.all_reduce(t)
    time.sleep(0.1)
    return t


@pytest.mark.parametrize("mode,match,timeout_s", [
    ("raise", "rank 1 gives up", 240), ("hang", r"ranks \[0, 1\] gave no result", 20)])
def test_spawn_fails_the_job(mode, match, timeout_s):
    """A rank that raises fails the whole job with its traceback; a rank
    left waiting in a collective is cut at the launcher's time limit."""
    with pytest.raises(RuntimeError, match=match):
        spawn(_fail_rank, 2, (mode,), device="cpu", num_threads=1, timeout_s=timeout_s)


def test_backend_follows_the_device():
    """CPU ranks reduce with gloo; asking for NCCL there raises before any
    process group exists, and a mesh needs one."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="gloo"):
        initialize_distributed(0, 1, device="cpu", backend="nccl",
                               init_method="file:///nonexistent/never-used")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_mesh(device="cpu")


def test_collective_bytes_match_jax():
    from rgcn_tpu.dist.multihost import collective_bytes_per_step as j_bytes

    for args in [(8285, (16, 4), 100_000, 2, 1), (40943, (200,), 5_000_000, 4, 2),
                 (10, (3,), 7, 1, 1)]:
        assert collective_bytes_per_step(*args) == j_bytes(*args)


# -- the per-shard structures, bit-equal to the JAX builders' ------------------


@pytest.mark.parametrize("n", [2, 4])
def test_shard_layouts_bit_equal_to_jax(n):
    """``shard_edge_set`` + ``prepare_sharded_layouts`` == shard k of the
    JAX ``prepare_sharded_layouts`` (its in-jit builders per shard): the
    edge arrays, the destination layout, the reversed edges and theirs.
    The values are the whole graph's normalisation."""
    from rgcn_tpu.dist.mesh import prepare_sharded_layouts as j_prepare
    from rgcn_tpu.dist.mesh import shard_edge_set as j_shard
    from rgcn_tpu.graph.structure import build_edge_set as j_build

    triples = random_triples(22, 32, 3, 120)
    mesh = jax_mesh(n)
    j_es = j_prepare(j_shard(j_build(triples, 32, 3, tile_size=8, tile_multiple=n),
                             mesh), mesh, row_block=8)
    t_es = build_edge_set(triples, 32, 3, tile_size=8, tile_multiple=n)

    def part(a, k):
        a = np.asarray(a)
        m = a.shape[0] // n
        return a[k * m:(k + 1) * m]

    for k in range(n):
        got = tmesh.prepare_sharded_layouts(tmesh.shard_edge_set(t_es, n, k), row_block=8)
        for f in ("src", "dst", "rel", "val", "tile_rel"):
            assert_same(getattr(got, f), part(getattr(j_es, f), k), f"shard {k} {f}")
            assert_same(getattr(got.reverse, f), part(getattr(j_es.reverse, f), k),
                        f"shard {k} reverse.{f}")
        for name, g, w in (("layout", got.layout, j_es.layout),
                           ("reverse.layout", got.reverse.layout, j_es.reverse.layout)):
            for field in ("perm", "local_dst", "chunk_block"):
                assert_same(getattr(g, field), part(getattr(w, field), k),
                            f"shard {k} {name}.{field}")
        assert got.num_edges == j_es.num_edges


def _one_relation_triples(seed, n, e):
    """Every edge in relation 0: after relation-sorted tiling most tiles
    hold it, and the trailing shards hold only pad tiles."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), np.zeros(e, np.int64),
                     rng.integers(0, n, e)], axis=1)


@pytest.mark.parametrize("case", ["balanced", "imbalanced"])
def test_shard_pairs_bit_equal_to_jax(case):
    """``prepare_sharded_pairs_host`` == shard k of the JAX builder on 8
    shards: the layout at the shared bound, the pair index padded to the
    largest shard's pair count, the composed layouts at their bounds,
    with all-pad shards in the imbalanced graph."""
    from rgcn_tpu.dist.mesh import prepare_sharded_pairs_host as j_pairs
    from rgcn_tpu.graph.structure import build_edge_set as j_build

    n_nodes, n = 40, 8
    triples = (random_triples(31, 48, 6, 220) if case == "balanced"
               else _one_relation_triples(37, n_nodes, 130))
    nn = 48 if case == "balanced" else n_nodes
    j_es = j_pairs(j_build(triples, nn, 6, tile_size=8, tile_multiple=n), jax_mesh(n),
                   row_block=8)
    t_es = build_edge_set(triples, nn, 6, tile_size=8, tile_multiple=n)
    empty = 0

    def part(a, k):
        a = np.asarray(a)
        m = a.shape[0] // n
        return a[k * m:(k + 1) * m]

    for k in range(n):
        got = tmesh.prepare_sharded_pairs_host(t_es, n, k, row_block=8)
        empty += int(np.all(np.asarray(got.dst) == nn))
        for f in ("src", "dst", "val", "tile_rel"):
            assert_same(getattr(got, f), part(getattr(j_es, f), k), f"shard {k} {f}")
        for field in ("perm", "local_dst", "chunk_block"):
            assert_same(getattr(got.layout, field), part(getattr(j_es.layout, field), k))
        gp, jp = got.pairs, j_es.pairs
        for f in ("pair_src", "pair_rel", "edge_pair"):
            assert_same(getattr(gp, f), part(getattr(jp, f), k), f"shard {k} {f}")
        for f in ("slot_pair", "slot_dst", "grad_edge", "grad_dst", "slot_val", "grad_val"):
            assert_same(getattr(gp.agg, f), part(getattr(jp.agg, f), k), f"shard {k} {f}")
        for name, g, w in (("grad_layout", gp.agg.grad_layout, jp.agg.grad_layout),
                           ("src_layout", gp.src_layout, jp.src_layout)):
            for field in ("perm", "local_dst", "chunk_block"):
                assert_same(getattr(g, field), part(getattr(w, field), k),
                            f"shard {k} {name}.{field}")
            assert (g.num_row_blocks, g.row_block) == (w.num_row_blocks, w.row_block)
    assert (empty > 0) == (case == "imbalanced")


@pytest.mark.parametrize("n", [2, 4])
def test_lp_epoch_shards_bit_equal_to_jax(n):
    """``build_sharded_epoch_host`` shard k == the JAX builder's stacked
    output at k (the subgraph with dropout by a keep mask, its layout, its
    reversed edges and theirs), native and numpy builders alike."""
    from rgcn_tpu.dist.host import build_sharded_epoch_host as j_epoch

    pos = random_triples(27, 48, 4, 200)[:24]
    keep = (np.random.default_rng(5).random(24) < 0.7).astype(np.float32)
    kw = dict(dropout_rate=0.5, keep_mask=keep, row_block=8, layout_chunk=8)
    want = j_epoch(pos, 48, 4, 8, n, **kw)
    for k in range(n):
        for native in (True, False):
            got = build_sharded_epoch_host(pos, 48, 4, 8, n, k, prefer_native=native, **kw)
            for f in ("src", "dst", "rel", "val", "tile_rel"):
                assert_same(getattr(got, f), np.asarray(getattr(want, f))[k], f)
                assert_same(getattr(got.reverse, f), np.asarray(getattr(want.reverse, f))[k])
            for g, w in ((got.layout, want.layout), (got.reverse.layout, want.reverse.layout)):
                for field in ("perm", "local_dst", "chunk_block"):
                    assert_same(getattr(g, field), np.asarray(getattr(w, field))[k], field)


@pytest.mark.parametrize("bsz,n", [(27, 8), (24, 4), (21, 4)])
def test_structured_slices_bit_equal_to_jax(bsz, n):
    """``build_sharded_structured_host`` slice k == the JAX builder's
    stacked output at k: positives padded by repeating row 0, the
    negatives following their parents, the real/pad weights, the labels
    and the slice's structured layouts."""
    from rgcn_tpu.dist.host import build_sharded_structured_host as j_struct
    from rgcn_tpu.train.negative import corrupt_batch_host

    pos = random_triples(33, 48, 4, 200)[:bsz]
    ch, ce = corrupt_batch_host(np.random.default_rng(3), pos, 48, 3, 0.5,
                                structure_only=True)
    want = j_struct(pos, ch, ce, 48, n, row_block=16, chunk=16)
    for k in range(n):
        got = build_sharded_structured_host(pos, ch, ce, 48, n, k, row_block=16, chunk=16)
        for g, w in zip(got[:5], want[:5]):
            assert_same(g, np.asarray(w)[k])
        for g, w in zip(got[5][:3], want[5][:3]):
            for field in ("perm", "local_dst", "chunk_block"):
                assert_same(getattr(g, field), np.asarray(getattr(w, field))[k], field)
        for g, w in zip(got[5][3], want[5][3]):
            assert_same(g, np.asarray(w)[k])
    total = sum(build_sharded_structured_host(pos, ch, ce, 48, n, k, row_block=16,
                                              chunk=16)[4].sum() for k in range(n))
    assert total == bsz * 4


def test_shards_refuse_indivisible_tiles():
    es = build_edge_set(random_triples(1, 20, 2, 40), 20, 2, tile_size=8)
    n = es.num_tiles + 1
    with pytest.raises(ValueError, match="tile_multiple"):
        tmesh.shard_edge_set(es, n, 0)
    with pytest.raises(ValueError, match="tile_multiple"):
        tmesh.prepare_sharded_pairs_host(es, n, 0)
