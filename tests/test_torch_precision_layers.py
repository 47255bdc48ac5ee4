"""``RGCNConv``'s five compute-dtype branches, in the port against the JAX
package, on the CPU: the port's ``_edge_compute_dtype`` patched to bf16
against the flax layer (``backend="pallas"``, Pallas in interpret mode)
with ``_tpu_compute_dtype`` patched to bf16 (the diagonal layer; the
featureless basis layer with at most 8 bases, with more per tile (the
serving route, forward only) and through the pair index; the featureful
basis layer with at most 8 bases; the featureful pair branch). Outputs and
gradients within 8e-3·max(1, max|ref|); the f32 layer's must differ, and
lie at least 4 times farther from JAX's (every gradient but the bias's,
which does not pass the edge stage). The
pair branches' JAX reference scatters the coefficient gradient in f32 (see
``test_torch_precision.py``).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgcn_tpu.nn.layers as jlayers
from rgcn_tpu_torch.nn import layers as tlayers
from rgcn_tpu_torch.nn.layers import RGCNConv
from rgcn_tpu_torch.weights import from_jax_params
from tests.test_torch_precision import (
    BF16,
    _close8,
    _f32,
    _f32_coefficient_sums,
    _graphs,
    _narrowed,
    _nearer,
)


# -- the layer's five branches ---------------------------------------------------------


def _strip(tree):
    state = from_jax_params({"params": {"c": jax.tree_util.tree_map(np.asarray,
                                                                    tree["params"])}})
    return {k[2:]: v for k, v in state.items()}


# (branch, featureless, nb, diag, edge-set options)
BRANCHES = {
    "diag": (False, 0, True, {}),
    "featureless-few": (True, 4, False, {}),
    "featureless-many": (True, 12, False, {}),
    "featureless-many-pairs": (True, 12, False, dict(with_pair_index=True,
                                                     with_pair_agg=True)),
    "featureful-few": (False, 3, False, {}),
    "pairs": (False, 12, False, dict(with_pair_index=True, with_pair_agg=True)),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_conv_branches_bf16_match_flax(branch, monkeypatch):
    featureless, nb, diag, kw = BRANCHES[branch]
    n, r, din = 60, 4, 8
    dout = din if diag else 6
    jes, tes, rng = _graphs(n, r, 240, seed=len(branch), **kw)
    conv_kw = dict(in_features=None if featureless else din, diag=diag,
                   decomposition=None if diag else "basis", num_bases=nb)
    jconv = jlayers.RGCNConv(num_nodes=n, num_relations=2 * r + 1, out_features=dout,
                             backend="pallas", **conv_kw)
    x = None if featureless else np.maximum(_f32(rng, n, din), 0)
    jx = None if featureless else jnp.asarray(x)
    args = (jes,) if featureless else (jes, jx)
    params = jconv.clone(backend="xla").init(jax.random.key(nb), *args)
    cot = _f32(rng, n, dout)

    def j_loss(p, xx):
        out = jconv.apply(p, jes) if featureless else jconv.apply(p, jes, xx)
        return jnp.sum(out * cot), out

    monkeypatch.setattr(jlayers, "_tpu_compute_dtype", lambda: jnp.bfloat16)
    _f32_coefficient_sums(monkeypatch)
    (_, want), (want_dp, want_dx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jx)
    want_grads = _strip(want_dp)

    # the per-tile featureless route is the port's serving route: no backward
    grad = branch != "featureless-many"
    got = {}
    for dtype in (BF16, None):
        conv = RGCNConv(n, 2 * r + 1, dout, **conv_kw)
        conv.load_state_dict(_strip(params))
        xt = None if featureless else torch.from_numpy(x).requires_grad_()
        with mock.patch.object(tlayers, "_edge_compute_dtype", lambda device: dtype), \
                torch.set_grad_enabled(grad):
            out = conv(tes, xt)
        if not grad:
            got[dtype] = (out, {}, None)
            continue
        (out * torch.from_numpy(cot)).sum().backward()
        grads = {name: p.grad for name, p in conv.named_parameters()}
        got[dtype] = (out.detach(), grads, None if featureless else xt.grad)
    out, grads, dx = got[BF16]
    _close8(out, want, "forward")
    _narrowed(out, got[None][0], want, "forward")
    _nearer(out, got[None][0], want, "forward")
    if not grad:
        return
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        _close8(g, want_grads[name], name)
        if name != "bias":  # the bias's gradient does not pass the edge stage
            _nearer(g, got[None][1][name], want_grads[name], name)
    if not featureless:
        _close8(dx, want_dx, "dx")
        _narrowed(dx, got[None][2], want_dx, "dx")
        _nearer(dx, got[None][2], want_dx, "dx")
