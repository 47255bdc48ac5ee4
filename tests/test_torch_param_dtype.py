"""bf16 parameters (``param_dtype``) in the port against the JAX package, on
the CPU.

Every ``RGCNConv`` branch (dense, dense featureless, basis with 3 bases,
featureless basis with 4 and with 12 bases, the pair branch with 12 bases,
diagonal, block in the LP and the NC layout), ``DistMult`` with the
structured scorer and ``TorchLinear``: the flax module with
``param_dtype=jnp.bfloat16`` (``backend="pallas"``, Pallas in interpret
mode) against the port's module with ``param_dtype=torch.bfloat16``,
holding the same bf16 parameters (carried by ``from_jax_params``) and
numpy-seeded inputs; a small NodeClassifier with its tree cast to bf16;
one Adam step against optax's. Outputs and gradients within
8e-3·max(1, max|ref|) (the JAX package's own bf16 bound,
``tests/test_basis.py:58``), output and gradient dtypes equal to JAX's.
The port with f32 parameters holding the same values (the f32 answer) is
the yardstick of where the narrowing happens (:func:`_held`): where it
lies more than 1e-6·max|ref| from JAX's bf16 answer, the port's bf16
answer must lie at least 4 times nearer, as
``test_torch_precision_layers.py`` holds the compute dtype, but in mean
norm: a bf16 gradient is an f32 sum rounded once on both sides, and where
the two f32 sums (added in other orders) straddle a rounding boundary
they round one bf16 ulp apart, about as far as the f32 answer's largest
rounding error, so in max norm a single such element decides; a port
that rounded at other places lands about as far as the f32 answer in
either norm. Where the f32 answer does not differ (a bf16 weight widened
exactly into f32 arithmetic changes nothing), the bf16 answer must match
to the f32 tolerance 1e-5·max(1, max|ref|).
Then the bit-equal carries: ``from_jax_params`` of a bf16 tree and a
bf16 module's checkpoint round trip.

The bf16 gathers' gradients: the port gathers the pair branch's bf16
comps widened, and the per-tile featureless branch's bf16 basis rows and
the dense featureless branch's bf16 weight rows with an f32 gradient sum
(``ops/spmm.py::gather_rows``), so these gradients sum in f32 and round
once, where JAX's bf16 gathers scatter in bf16, rounding every update
(several bf16 ulps apart at these sizes). Their JAX references gather in
f32 (``test_torch_precision.py::_f32_coefficient_sums``,
:func:`_f32_table_sums`): the same forward, an f32 scatter, one rounding
at the parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rgcn_tpu.nn.layers as jlayers
from rgcn_tpu.ops import spmm as jspmm
from rgcn_tpu.models.node_classification import NodeClassifier as JNodeClassifier
from rgcn_tpu_torch.models.node_classification import NodeClassifier
from rgcn_tpu_torch.nn.layers import DistMult, RGCNConv, TorchLinear
from rgcn_tpu_torch.train.optim import make_optimizer
from rgcn_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from rgcn_tpu_torch.weights import from_jax_params
from tests.test_torch_precision import _f32, _f32_coefficient_sums, _graphs, _np

BF16 = torch.bfloat16
_J_FL_BASIS = jspmm.rel_spmm_featureless_basis
_J_FL_DENSE = jspmm.rel_spmm_featureless


def _f32_table_sums(monkeypatch):
    """JAX's featureless ops with bf16 tables widened before their
    gathers: the per-tile basis op's bases and comps (``compute_dtype=None``)
    and the dense op's weights. The same exact products, the gathers'
    gradients summed in f32 and rounded once where the parameters' dtype is
    restored."""
    def basis_op(edges, bases, comps, *, compute_dtype=None, **kw):
        if compute_dtype is None:
            bases, comps = bases.astype(jnp.float32), comps.astype(jnp.float32)
        return _J_FL_BASIS(edges, bases, comps, compute_dtype=compute_dtype, **kw)

    def dense_op(edges, weights, **kw):
        return _J_FL_DENSE(edges, weights.astype(jnp.float32), **kw)

    monkeypatch.setattr(jspmm, "rel_spmm_featureless_basis", basis_op)
    monkeypatch.setattr(jspmm, "rel_spmm_featureless", dense_op)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _state(params, name="c"):
    """The port's state of one flax module's parameters."""
    state = from_jax_params({"params": {name: _tree(params["params"])}})
    return {k[len(name) + 1:]: v for k, v in state.items()}


def _held(got, f32, want, what):
    """``got`` (the port, bf16 parameters) against JAX's bf16 answer
    ``want``, with ``f32`` (the port, f32 parameters of the same values) as
    the yardstick (see the module docstring)."""
    got, f32, want = _np(got), _np(f32), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 8e-3 * max(1.0, scale), f"{what}: {err:.3g} past 8e-3"
    gap = np.abs(f32 - want)
    if gap.max() > 1e-6 * scale:
        mean_err, mean_gap = float(np.abs(got - want).mean()), float(gap.mean())
        assert mean_err <= 0.25 * mean_gap, \
            f"{what}: {mean_err:.3g} from JAX's on average, f32 is {mean_gap:.3g}"
    else:
        assert err <= 1e-5 * max(1.0, scale), f"{what}: {err:.3g} where f32 matches"


# (featureless, conv keywords, edge-set options)
BRANCHES = {
    "dense": (False, {}, {}),
    "dense-featureless": (True, {}, {}),
    "basis-3": (False, dict(decomposition="basis", num_bases=3), {}),
    "featureless-basis-4": (True, dict(decomposition="basis", num_bases=4), {}),
    "featureless-basis-12": (True, dict(decomposition="basis", num_bases=12), {}),
    "pairs-12": (False, dict(decomposition="basis", num_bases=12),
                 dict(with_pair_index=True, with_pair_agg=True)),
    "diag": (False, dict(diag=True), {}),
    "block-lp": (False, dict(decomposition="block", num_blocks=2,
                             separate_self_weight=True), {}),
    "block-nc": (False, dict(decomposition="block", num_blocks=2), {}),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_conv_branches_bf16_params_match_flax(branch, monkeypatch):
    featureless, kw, es_kw = BRANCHES[branch]
    n, r, din = 60, 4, 8
    dout = din if kw.get("diag") else 6
    jes, tes, rng = _graphs(n, r, 240, seed=len(branch) + 40, **es_kw)
    jconv = jlayers.RGCNConv(num_nodes=n, num_relations=2 * r + 1, out_features=dout,
                             in_features=None if featureless else din, backend="pallas",
                             param_dtype=jnp.bfloat16, **kw)
    x = None if featureless else np.maximum(_f32(rng, n, din), 0)
    jx = None if featureless else jnp.asarray(x)
    args = (jes,) if featureless else (jes, jx)
    params = jconv.clone(backend="xla").init(jax.random.key(3), *args)
    assert all(a.dtype == jnp.bfloat16 for a in jax.tree_util.tree_leaves(params))
    cot = _f32(rng, n, dout)

    def j_loss(p, xx):
        out = jconv.apply(p, jes) if featureless else jconv.apply(p, jes, xx)
        return jnp.sum(out * cot), out

    _f32_coefficient_sums(monkeypatch)
    _f32_table_sums(monkeypatch)
    (_, want), (want_dp, want_dx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jx)
    want_grads = _state(want_dp)
    state = _state(params)

    got = {}
    for dtype in (BF16, torch.float32):
        conv = RGCNConv(n, 2 * r + 1, dout, in_features=None if featureless else din,
                        param_dtype=dtype, **kw)
        conv.load_state_dict(state)
        assert all(p.dtype == dtype for p in conv.parameters())
        xt = None if featureless else torch.from_numpy(x).requires_grad_()
        out = conv(tes, xt)
        (out * torch.from_numpy(cot)).sum().backward()
        got[dtype] = (out.detach(), {k: p.grad for k, p in conv.named_parameters()},
                      None if featureless else xt.grad)
    out, grads, dx = got[BF16]
    assert out.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    _held(out, got[torch.float32][0], want, "forward")
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        assert g.dtype == BF16 and want_grads[name].dtype == BF16, name
        _held(g, got[torch.float32][1][name], want_grads[name], name)
    if not featureless:
        assert dx.dtype == torch.float32 and want_dx.dtype == jnp.float32
        _held(dx, got[torch.float32][2], want_dx, "dx")


def test_torch_linear_bf16_params_match_flax():
    rng = np.random.default_rng(5)
    x = _f32(rng, 30, 12)
    jlin = jlayers.TorchLinear(features=7, param_dtype=jnp.bfloat16)
    params = jlin.init(jax.random.key(1), jnp.asarray(x))
    cot = _f32(rng, 30, 7)

    def j_loss(p, xx):
        out = jlin.apply(p, xx)
        return jnp.sum(out * cot), out

    (_, want), (want_dp, want_dx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    got = {}
    for dtype in (BF16, torch.float32):
        lin = TorchLinear(12, 7, param_dtype=dtype)
        lin.load_state_dict(_state(params))
        xt = torch.from_numpy(x).requires_grad_()
        out = lin(xt)
        (out * torch.from_numpy(cot)).sum().backward()
        got[dtype] = (out.detach(), {k: p.grad for k, p in lin.named_parameters()}, xt.grad)
    out, grads, dx = got[BF16]
    assert out.dtype == torch.float32
    _held(out, got[torch.float32][0], want, "forward")
    for name, g in grads.items():
        assert g.dtype == BF16
        _held(g, got[torch.float32][1][name], _state(want_dp)[name], name)
    _held(dx, got[torch.float32][2], want_dx, "dx")


def _structured_batch(rng, n, r, p_count, ns):
    positives = np.stack([rng.integers(0, n, p_count), rng.integers(0, r, p_count),
                          rng.integers(0, n, p_count)], 1).astype(np.int32)
    corrupt_head = rng.random(p_count * ns) < 0.5
    corrupt_ent = rng.integers(0, n, p_count * ns).astype(np.int32)
    pw = (rng.random(p_count * (1 + ns)) * 0.1).astype(np.float32)
    return positives, corrupt_head, corrupt_ent, pw


def test_distmult_structured_bf16_relations_match_flax():
    from rgcn_tpu.ops.pallas_distmult import build_structured_layouts as j_layouts
    from rgcn_tpu_torch.ops.distmult_train import build_structured_layouts

    n, r, d, p_count, ns = 50, 5, 16, 12, 3
    rng = np.random.default_rng(9)
    positives, ch, ce, pw = _structured_batch(rng, n, r, p_count, ns)
    nodes = _f32(rng, n, d, scale=0.5)
    jdm = jlayers.DistMult(num_nodes=n, num_relations=r, emb_dim=d, backend="pallas",
                           param_dtype=jnp.bfloat16)
    params = jdm.init(jax.random.key(2), jnp.asarray(positives), jnp.asarray(nodes))
    assert params["params"]["relations"].dtype == jnp.bfloat16
    jlay = j_layouts(positives, ce, n, row_block=16, chunk=32, corrupt_head=ch,
                     sorted_corrupt=True)
    gcot = _f32(rng, p_count * (1 + ns))
    lay = build_structured_layouts(positives, ce, ch, n, row_block=16, chunk=32)
    lay = (lay[0].to("cpu"), lay[1].to("cpu"), lay[2].to("cpu"),
           tuple(torch.from_numpy(a) for a in lay[3]))

    def j_loss(p, z):
        scores, pen = jdm.apply(p, jnp.asarray(positives), jnp.asarray(ch),
                                jnp.asarray(ce), z, jnp.asarray(pw), jlay,
                                method="structured_scores_with_penalty")
        return jnp.sum(scores * gcot) + 3.0 * pen, (scores, pen)

    (_, (want_s, want_p)), (want_dp, want_dz) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(nodes))
    got = {}
    for dtype in (BF16, torch.float32):
        dm = DistMult(n, r, d, param_dtype=dtype)
        dm.load_state_dict(_state(params))
        z = torch.from_numpy(nodes).requires_grad_()
        scores, pen = dm.structured_scores_with_penalty(
            torch.from_numpy(positives), torch.from_numpy(ch), torch.from_numpy(ce), z,
            torch.from_numpy(pw), lay)
        ((scores * torch.from_numpy(gcot)).sum() + 3.0 * pen).backward()
        got[dtype] = (scores.detach(), pen.detach(), dm.relations.grad, z.grad)
    scores, pen, drel, dz = got[BF16]
    f32 = got[torch.float32]
    assert scores.dtype == torch.float32 and drel.dtype == BF16 and dz.dtype == torch.float32
    assert want_dp["params"]["relations"].dtype == jnp.bfloat16
    _held(scores, f32[0], want_s, "scores")
    _held(pen, f32[1], want_p, "penalty")
    _held(drel, f32[2], want_dp["params"]["relations"], "d relations")
    _held(dz, f32[3], want_dz, "d nodes")


def test_distmult_biased_scores_bf16_params_match_flax():
    n, r, d, b = 40, 4, 12, 25
    rng = np.random.default_rng(11)
    triples = np.stack([rng.integers(0, n, b), rng.integers(0, r, b),
                        rng.integers(0, n, b)], 1).astype(np.int64)
    nodes = _f32(rng, n, d, scale=0.5)
    jdm = jlayers.DistMult(num_nodes=n, num_relations=r, emb_dim=d, bias_init="normal",
                           param_dtype=jnp.bfloat16)
    params = jdm.init(jax.random.key(4), jnp.asarray(triples), jnp.asarray(nodes))
    want = jdm.apply(params, jnp.asarray(triples), jnp.asarray(nodes))
    want_tails = jdm.apply(params, jnp.asarray(triples), jnp.asarray(nodes),
                           method="score_tails")
    got = {}
    for dtype in (BF16, torch.float32):
        dm = DistMult(n, r, d, bias_init="normal", param_dtype=dtype)
        dm.load_state_dict(_state(params))
        with torch.no_grad():
            got[dtype] = (dm(torch.from_numpy(triples), torch.from_numpy(nodes)),
                          dm.score_tails(torch.from_numpy(triples), torch.from_numpy(nodes)))
    assert got[BF16][0].dtype == torch.float32
    _held(got[BF16][0], got[torch.float32][0], want, "scores")
    _held(got[BF16][1], got[torch.float32][1], want_tails, "tail sweep")


def _nc_pair(seed):
    rng = np.random.default_rng(seed)
    n, r, c = 60, 4, 3
    jes, tes, _ = _graphs(n, r, 250, seed=seed)
    jm = JNodeClassifier(num_nodes=n, num_relations=r, num_classes=c, num_layers=2,
                         backend="pallas")
    params = jm.init(jax.random.key(0), jes)
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    labels = rng.integers(0, c, n)
    return jm, jes, tes, bf16, labels, (n, r, c)


def test_node_classifier_bf16_tree_matches_flax(monkeypatch):
    jm, jes, tes, params, labels, (n, r, c) = _nc_pair(13)
    _f32_table_sums(monkeypatch)  # layer 1 is the dense featureless branch
    onehot = np.eye(c, dtype=np.float32)[labels]

    def j_loss(p):
        logits = jm.apply(p, jes)
        return -jnp.sum(jax.nn.log_softmax(logits) * onehot), logits

    (_, want), want_dp = jax.value_and_grad(j_loss, has_aux=True)(params)
    want_grads = from_jax_params(_tree(want_dp))
    got = {}
    for dtype in (BF16, torch.float32):
        tm = NodeClassifier(n, r, c, num_layers=2).to(dtype)
        tm.load_state_dict(from_jax_params(_tree(params)))
        logits = tm(tes)
        loss = -(torch.log_softmax(logits, -1) * torch.from_numpy(onehot)).sum()
        loss.backward()
        got[dtype] = (logits.detach(), {k: p.grad for k, p in tm.named_parameters()})
    logits, grads = got[BF16]
    assert logits.dtype == torch.float32
    _held(logits, got[torch.float32][0], want, "logits")
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        assert g.dtype == BF16 == want_grads[name].dtype, name
        _held(g, got[torch.float32][1][name], want_grads[name], name)


def test_adam_step_on_bf16_params_matches_optax(monkeypatch):
    """One Adam step (lr 0.01) of the bf16 NodeClassifier: optax keeps mu
    and nu in bf16, the port's torch.optim.Adam keeps its state in the
    parameters' dtype; the stepped parameters within the bf16 bound."""
    jm, jes, tes, params, labels, (n, r, c) = _nc_pair(17)
    _f32_table_sums(monkeypatch)
    onehot = np.eye(c, dtype=np.float32)[labels]

    def j_loss(p):
        return -jnp.sum(jax.nn.log_softmax(jm.apply(p, jes)) * onehot)

    tx = optax.adam(0.01)
    opt_state = tx.init(params)
    assert all(a.dtype == jnp.bfloat16 for a in jax.tree_util.tree_leaves(opt_state[0].mu))
    updates, _ = tx.update(jax.grad(j_loss)(params), opt_state, params)
    want = from_jax_params(_tree(optax.apply_updates(params, updates)))
    start = from_jax_params(_tree(params))

    tm = NodeClassifier(n, r, c, num_layers=2).to(BF16)
    tm.load_state_dict(start)
    opt = make_optimizer(tm.parameters(), "adam", 0.01)
    loss = -(torch.log_softmax(tm(tes), -1) * torch.from_numpy(onehot)).sum()
    loss.backward()
    opt.step()
    for name, p in tm.named_parameters():
        assert p.dtype == BF16
        state = opt.state[p]
        assert state["exp_avg"].dtype == BF16 and state["exp_avg_sq"].dtype == BF16
        got, ref = _np(p), _np(want[name])
        assert float(np.abs(got - ref).max()) <= 8e-3 * max(1.0, float(np.abs(ref).max())), name
        # the step moved the parameter as optax's did (about lr a step)
        moved = np.abs(ref - _np(start[name])) > 0
        assert np.array_equal(np.abs(got - _np(start[name])) > 0, moved) or \
            float(np.abs(got - ref).max()) <= 2 ** -8 * max(1.0, float(np.abs(ref).max())), name


def test_from_jax_params_carries_bf16_bits():
    rng = np.random.default_rng(1)
    a = jnp.asarray(_f32(rng, 5, 7)).astype(jnp.bfloat16)
    b = _f32(rng, 3)
    state = from_jax_params({"params": {"rgc1": {"bases": np.asarray(a), "bias": b},
                                        "node_embeddings_block0": np.asarray(a),
                                        "node_embeddings_block1": np.asarray(a)}})
    assert state["rgc1.bases"].dtype == BF16 and state["rgc1.bias"].dtype == torch.float32
    bits = np.asarray(a).view(np.uint16)
    assert np.array_equal(state["rgc1.bases"].view(torch.int16).numpy().view(np.uint16), bits)
    assert np.array_equal(state["rgc1.bias"].numpy(), b)
    joined = state["node_embeddings"]
    assert joined.dtype == BF16 and joined.shape == (5, 14)
    assert np.array_equal(joined.view(torch.int16).numpy().view(np.uint16),
                          np.concatenate([bits, bits], 1))


def test_bf16_module_checkpoint_round_trip(tmp_path):
    conv = RGCNConv(30, 7, 5, in_features=6, decomposition="basis", num_bases=2,
                    param_dtype=BF16, generator=torch.Generator().manual_seed(3))
    opt = make_optimizer(conv.parameters(), "adam", 0.01)
    x = torch.randn(30, 6, generator=torch.Generator().manual_seed(4))
    from rgcn_tpu_torch.graph.structure import build_edge_set

    rng = np.random.default_rng(2)
    triples = np.stack([rng.integers(0, 30, 80), rng.integers(0, 3, 80),
                        rng.integers(0, 30, 80)], 1)
    es = build_edge_set(triples, 30, 3, tile_size=16, with_dst_layout=True).to("cpu")
    conv(es, x).square().sum().backward()
    opt.step()
    save_checkpoint(str(tmp_path), {"params": conv.state_dict(),
                                    "opt_state": opt.state_dict()}, 1)
    state, step = restore_checkpoint(str(tmp_path))
    assert step == 1
    again = RGCNConv(30, 7, 5, in_features=6, decomposition="basis", num_bases=2,
                     param_dtype=BF16)
    again.load_state_dict(state["params"])
    for (name, p), q in zip(conv.named_parameters(), again.parameters()):
        assert q.dtype == BF16 and state["params"][name].dtype == BF16
        assert torch.equal(p.view(torch.int16), q.view(torch.int16)), name
    opt2 = make_optimizer(again.parameters(), "adam", 0.01)
    opt2.load_state_dict(state["opt_state"])
    for p, q in zip(conv.parameters(), again.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert opt2.state[q][key].dtype == BF16
            assert torch.equal(opt.state[p][key].view(torch.int16),
                               opt2.state[q][key].view(torch.int16))


def test_param_dtype_creates_bf16_parameters():
    """Drawn in f32 from the generator and rounded once: the bf16 module
    holds the f32 module's values rounded."""
    kw = dict(in_features=8, decomposition="block", num_blocks=2, separate_self_weight=True)
    f32 = RGCNConv(20, 5, 6, generator=torch.Generator().manual_seed(7), **kw)
    bf = RGCNConv(20, 5, 6, generator=torch.Generator().manual_seed(7), param_dtype=BF16, **kw)
    for (name, p), q in zip(f32.named_parameters(), bf.parameters()):
        assert q.dtype == BF16 and torch.equal(p.detach().to(BF16), q.detach()), name
    dm = DistMult(20, 3, 8, bias_init="normal", param_dtype=BF16)
    lin = TorchLinear(8, 4, param_dtype=BF16)
    assert {p.dtype for p in [*dm.parameters(), *lin.parameters()]} == {BF16}


@pytest.mark.parametrize("precision", [None, "high"])
def test_featureless_basis_groups_round_bf16_gradients_once(precision, monkeypatch):
    """The per-tile featureless basis op over tile groups (``_ELEM_BUDGET``
    below the whole) with bf16 bases and comps: the forward and both
    gradients bit-equal to the ungrouped op's (one f32 sum, one rounding,
    however many groups), and within 8e-3·max(1, max|ref|) of JAX's op on
    the tables widened before its gathers."""
    from rgcn_tpu_torch.ops import spmm as tspmm

    jes, tes, rng = _graphs(50, 3, 300, seed=2)
    nb, dout = 4, 5
    bases = jnp.asarray(_f32(rng, nb, 50, dout)).astype(jnp.bfloat16)
    comps = jnp.asarray(_f32(rng, 6, nb)).astype(jnp.bfloat16)
    cot = _f32(rng, 50, dout)

    def j_loss(b, c):
        out = _J_FL_BASIS(jes, b.astype(jnp.float32), c.astype(jnp.float32))
        return jnp.sum(out * cot), out

    (_, want), (wb, wc) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(bases, comps)
    got = []
    for budget in (tspmm._ELEM_BUDGET, tes.tile_size * nb * dout * 2):
        monkeypatch.setattr(tspmm, "_ELEM_BUDGET", budget)
        tb, tc = (torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(BF16)
                  .requires_grad_() for a in (bases, comps))
        out = tspmm.rel_spmm_featureless_basis(tes, tb, tc, precision=precision)
        (out * torch.from_numpy(cot)).sum().backward()
        assert out.dtype == torch.float32 and tb.grad.dtype == tc.grad.dtype == BF16
        got.append((out.detach(), tb.grad, tc.grad))
    for a, b in zip(*got):
        assert torch.equal(a, b)
    for g, ref in zip(got[0], (want, wb, wc)):
        ref = np.asarray(ref, dtype=np.float32)
        assert float(np.abs(_np(g) - ref).max()) <= 8e-3 * max(1.0, float(np.abs(ref).max()))
