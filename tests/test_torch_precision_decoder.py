"""The structured decoder's narrow backward (``decoder.bwd_dtype``), in the
port against the JAX package, on the CPU: ``structured_scores`` with
``bwd_dtype=bfloat16`` (and the config's name for it) against
``distmult_structured_agg_ad(bwd_dtype=jnp.bfloat16)`` (Pallas in
interpret mode), its scores and penalty bit-equal to the f32 path's, its
gradients within 8e-3·max(1, max|ref|) and differing from f32; the
layout-free mode's warning; the LP trainer routing a config's
``decoder.bwd_dtype`` to the scorer.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.config import load_experiment as j_load
from rgcn_tpu.ops import pallas_distmult as jdm
from rgcn_tpu.train import negative as jneg
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import synthetic_link_prediction
from rgcn_tpu_torch.ops import distmult_train as tdm
from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer
from tests.test_torch_precision import BF16, _close8, _f32, _narrowed, _nearer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the structured decoder's narrow backward ----------------------------------------


def _structured(n=40, r=3, p=20, ns=3, d=12, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.integers(0, n, p), rng.integers(0, r, p),
                    rng.integers(0, n, p)], 1).astype(np.int32)
    c_head, c_ent = jneg.corrupt_batch_host(np.random.default_rng(1), pos, n, ns, 0.5,
                                            structure_only=True)
    jl = jdm.build_structured_layouts(pos, c_ent, n, row_block=16, chunk=32,
                                      sorted_corrupt=True, corrupt_head=c_head)
    tl = tdm.build_structured_layouts(pos, c_ent, c_head, n, row_block=16, chunk=32)
    tl = (tl[0].to("cpu"), tl[1].to("cpu"), tl[2].to("cpu"),
          tuple(torch.from_numpy(a) for a in tl[3]))
    total = p * (1 + ns)
    pw = np.full(total, 1.0 / total, np.float32)
    nodes, rels = _f32(rng, n, d), _f32(rng, r, d)
    return pos, c_head, c_ent, jl, tl, pw, nodes, rels, _f32(rng, total), np.float32(0.7)


def test_structured_scores_bwd_dtype_matches_jax():
    pos, c_head, c_ent, jl, tl, pw, nodes, rels, gs, gp = _structured()

    def jf(nodes, rels):
        return jdm.distmult_structured_agg_ad(pos, c_head, c_ent, nodes, rels, pw, jl,
                                              bwd_dtype=jnp.bfloat16)

    (ws, wp), vjp = jax.vjp(jf, jnp.asarray(nodes), jnp.asarray(rels))
    wdn, wdr = vjp((jnp.asarray(gs), jnp.asarray(gp)))
    got = {}
    for dtype in (BF16, "bfloat16", None):
        tn, tr = (torch.tensor(a, requires_grad=True) for a in (nodes, rels))
        s, pen = tdm.structured_scores(torch.from_numpy(pos), torch.from_numpy(c_head),
                                       torch.from_numpy(c_ent), tn, tr,
                                       torch.from_numpy(pw), tl, bwd_dtype=dtype)
        torch.autograd.backward([s, pen], [torch.from_numpy(gs), torch.tensor(gp)])
        got[dtype] = (s.detach(), pen.detach(), tn.grad, tr.grad)
    s, pen, dn, dr = got[BF16]
    # the forward is computed before any narrowing: bit-equal to f32
    assert torch.equal(s, got[None][0]) and torch.equal(pen, got[None][1])
    _close8(s, ws, "scores")
    _close8(pen, wp, "penalty")
    for g, w, g32, name in ((dn, wdn, got[None][2], "d nodes"),
                            (dr, wdr, got[None][3], "d relations")):
        _close8(g, w, name)
        _narrowed(g, g32, w, name)
        _nearer(g, g32, w, name)
    for a, b in zip(got[BF16], got["bfloat16"]):  # the config's name, the same dtype
        assert torch.equal(a, b)


def test_structured_scores_without_layouts_warns():
    pos, c_head, c_ent, _, _, pw, nodes, rels, _, _ = _structured()
    args = [torch.from_numpy(a) for a in (pos, c_head, c_ent, nodes, rels, pw)]
    with pytest.warns(UserWarning, match="bwd_dtype only applies with host-built"):
        s, pen = tdm.structured_scores(*args, None, bwd_dtype=BF16)
    s32, pen32 = tdm.structured_scores(*args, None)
    assert torch.equal(s, s32) and torch.equal(pen, pen32)
    with pytest.raises(ValueError, match="not a floating-point dtype"):
        tdm.narrow_dtype("int32")


def _lp_cfg(bwd_dtype):
    cfg = load_experiment(os.path.join(ROOT, "configs", "rgcn", "lp-WN18.yaml"))
    enc = dataclasses.replace(
        cfg.encoder, node_embedding=8, hidden1_size=8,
        edge_dropout=dataclasses.replace(cfg.encoder.edge_dropout, self_loop=0.0))
    tr = dataclasses.replace(
        cfg.training, epochs=1, graph_batch_size=48,
        negative_sampling=dataclasses.replace(cfg.training.negative_sampling,
                                              sampling_rate=3))
    dec = dataclasses.replace(cfg.decoder, bwd_dtype=bwd_dtype)
    return dataclasses.replace(cfg, encoder=enc, training=tr, decoder=dec)


def test_trainer_routes_decoder_bwd_dtype():
    """A config with ``decoder.bwd_dtype: bfloat16`` trains with the narrow
    structured backward, as the JAX trainer does: the same loss as f32, the
    gradients of the scorer with ``bwd_dtype=bfloat16``."""
    data = synthetic_link_prediction(num_nodes=60, num_rels=3, num_edges=320)
    assert j_load(os.path.join(ROOT, "configs", "rgcn", "lp-WN18.yaml")).decoder.bwd_dtype \
        is None
    runs = {}
    for name in ("bfloat16", None, "by hand"):
        cfg = _lp_cfg("bfloat16" if name == "bfloat16" else None)
        tr = LinkPredictionTrainer(cfg, data, seed=0, tile_size=8, device="cpu",
                                   host_graph_build=True)
        assert tr.structured
        if name == "by hand":  # the f32 trainer's decoder narrowed directly
            tr.model.scoring_function.bwd_dtype = BF16
        tr.set_epoch(0)
        loss = tr.loss()
        loss.backward()
        runs[name] = (loss.detach(), {k: p.grad.clone() for k, p in tr.model.named_parameters()})
    assert runs["bfloat16"][0] == runs[None][0]  # the forward is f32 either way
    grads, f32, by_hand = runs["bfloat16"][1], runs[None][1], runs["by hand"][1]
    for k in grads:
        assert torch.equal(grads[k], by_hand[k]), k
    _narrowed(grads["node_embeddings"], f32["node_embeddings"], f32["node_embeddings"],
              "d node_embeddings")
