"""Edge-sharded link prediction in the port against the JAX package and
against the port on one device, on the CPU (gloo ranks spawned here).

One SGD step (lr 0.01) of the assembled-batch step and of the structured
step, from the JAX initialisation, on a 1-D mesh of 2 and of 4 ranks and
on a 2×2 (replica × edge) mesh, with scoring batches of 24 and 21
positives (2 negatives each: 21 positives and their 63 rows pad on every
mesh, 24 and 72 divide): the loss within rtol
1e-5 and every parameter after the step within 1e-5·max(1, max|ref|) of
the port's single-device step and of the JAX sharded step
(``make_sharded_lp_step_hosted`` on every mesh at 21 positives,
``make_sharded_lp_step_hosted_structured`` on the 2×2 mesh at 21), the
same bits on every rank; a plain-L2 decoder penalty through the
assembled-batch step against the port's and the JAX package's
single-device steps (the JAX sharded step gives the relations one
shard's share of that penalty's gradient; ROADMAP queue 3); the
candidate-sharded evaluation equal to the
single-device one, ranks for ranks; the sharded driver on a 2×2 mesh for
3 epochs (a block encoder) against the JAX sharded driver, its run broken
after epoch 2 and resumed bit-equal to the unbroken one; and
``predict_links --cpu --virtual-devices 2``.

The ranks run functions of this module in fresh processes, so JAX is
imported inside the tests only.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rgcn_tpu_torch.dist.multihost import same_on_every_rank, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, R, TILE, NS = 48, 4, 8, 2
MODEL_KW = dict(num_nodes=N, num_relations=R, emb_dim=8, hidden1_size=8, num_layers=1,
                decomposition="basis", num_bases=2, weight_init="schlichtkrull-normal",
                bias_init="zeros", decoder_l2_type="schlichtkrull-l2", decoder_l2=0.01)
MESHES = ((1, 2), (1, 4), (2, 2))


def random_triples(seed, n, r, e):
    rng = np.random.default_rng(seed)
    t = np.stack([rng.integers(0, n, e), rng.integers(0, r, e), rng.integers(0, n, e)],
                 axis=1)
    return np.unique(t, axis=0).astype(np.int64)


def tensors(state):
    return {k: torch.as_tensor(v) for k, v in state.items()}


def step_inputs(bsz):
    """One epoch's host draws: positives, a keep mask, the assembled batch
    and its structure (the same draws)."""
    from rgcn_tpu_torch.train.negative import corrupt_batch_host

    pos = random_triples(27, N, R, 200)[:bsz]
    keep = (np.random.default_rng(bsz).random(bsz) < 0.7).astype(np.float32)
    batch, labels, ch, ce = corrupt_batch_host(np.random.default_rng(3), pos, N, NS, 0.5,
                                               return_structure=True)
    return dict(pos=pos, keep=keep, batch=batch, labels=labels, ch=ch, ce=ce)


PLAIN_L2 = dict(decoder_l2_type="l2")  # the relation matrix's sum of squares


def port_lp_model(init, group=None, decoder_group=None, n=N, **over):
    from rgcn_tpu_torch.models.link_prediction import LinkPredictor

    model = LinkPredictor(**dict(MODEL_KW, num_nodes=n, **over), group=group,
                          decoder_group=decoder_group)
    model.load_state_dict(tensors(init))
    return model


def _sgd(model):
    from rgcn_tpu_torch.train.optim import make_optimizer

    return make_optimizer(model.parameters(), "sgd", 0.01)


def _lp_steps_rank(dev, shape, init, inputs, eval_case):
    """One rank: every (step kind, batch) case, then the sharded evaluation."""
    from rgcn_tpu_torch.dist.evaluate import evaluate_link_predictor_sharded
    from rgcn_tpu_torch.dist.host import (
        build_sharded_epoch_host,
        build_sharded_structured_host,
    )
    from rgcn_tpu_torch.dist.multihost import make_mesh_2d
    from rgcn_tpu_torch.dist.train import (
        make_sharded_lp_step_hosted,
        make_sharded_lp_step_hosted_structured,
        slice_batch,
    )

    mesh = make_mesh_2d(*shape, device=dev)
    out = {}
    for bsz, d in inputs.items():
        edges = build_sharded_epoch_host(
            d["pos"], N, R, TILE, mesh.edge_size, mesh.edge_rank, dropout_rate=0.5,
            keep_mask=d["keep"], row_block=8, layout_chunk=TILE).to(dev)
        model = port_lp_model(init, mesh.group, mesh.decoder_group)
        step = make_sharded_lp_step_hosted(model, _sgd(model), mesh.decoder_group, 0.01)
        batch, labels, w = slice_batch(d["batch"], d["labels"], mesh.size, mesh.rank)
        loss = step(edges, torch.as_tensor(batch).long(), torch.as_tensor(labels),
                    torch.as_tensor(w))
        out[f"hosted_{bsz}"] = {"loss": loss, **model.state_dict()}
        if bsz == 21:
            model = port_lp_model(init, mesh.group, mesh.decoder_group, **PLAIN_L2)
            step = make_sharded_lp_step_hosted(model, _sgd(model), mesh.decoder_group,
                                               0.01)
            loss = step(edges, torch.as_tensor(batch).long(), torch.as_tensor(labels),
                        torch.as_tensor(w))
            out["hosted_plain_l2_21"] = {"loss": loss, **model.state_dict()}

        model = port_lp_model(init, mesh.group, mesh.decoder_group)
        step = make_sharded_lp_step_hosted_structured(model, _sgd(model),
                                                      mesh.decoder_group, 0.01)
        pos, ch, ce, labels, w, lays = build_sharded_structured_host(
            d["pos"], d["ch"], d["ce"], N, mesh.size, mesh.rank, row_block=16, chunk=16)
        lays = (*(lay.to(dev) for lay in lays[:3]), tuple(torch.as_tensor(a).to(dev)
                                                          for a in lays[3]))
        loss = step(edges, (torch.as_tensor(pos).long(), torch.as_tensor(ch),
                            torch.as_tensor(ce).long(), torch.as_tensor(labels),
                            torch.as_tensor(w), lays))
        out[f"structured_{bsz}"] = {"loss": loss, **model.state_dict()}

    from rgcn_tpu_torch.graph.structure import build_edge_set

    model = port_lp_model(eval_case["init"], mesh.group, mesh.decoder_group, eval_case["n"])
    eval_edges = build_edge_set(eval_case["train"], eval_case["n"], R, tile_size=TILE,
                                with_dst_layout=True).to(dev)
    mrr, hits, ranks = evaluate_link_predictor_sharded(
        model, eval_edges, eval_case["test"], eval_case["filters"], mesh, batch_size=16)
    out["eval"] = {"mrr": mrr, "hits": np.asarray(hits), "ranks": ranks}
    return out


def one_device_steps(init, inputs):
    import torch.nn.functional as F

    from rgcn_tpu_torch.graph.dynamic import build_edge_set_dynamic_host
    from rgcn_tpu_torch.ops.distmult_train import build_structured_layouts

    out = {}
    for bsz, d in inputs.items():
        edges = build_edge_set_dynamic_host(
            d["pos"], N, R, tile_size=TILE, dropout_rate=0.5, keep_mask=d["keep"],
            with_dst_layout=True, row_block=8, layout_chunk=TILE).to("cpu")
        for key, over in ((f"hosted_{bsz}", {}), ("hosted_plain_l2_21", PLAIN_L2)):
            if over and bsz != 21:
                continue
            model = port_lp_model(init, **over)
            opt = _sgd(model)
            scores, pen = model(edges, torch.as_tensor(d["batch"]).long())
            loss = F.binary_cross_entropy_with_logits(
                scores, torch.as_tensor(d["labels"])) + 0.01 * pen
            loss.backward()
            opt.step()
            out[key] = {"loss": loss.detach(), **model.state_dict()}

        model = port_lp_model(init)
        opt = _sgd(model)
        lays = build_structured_layouts(d["pos"], d["ce"], d["ch"], N, row_block=16,
                                        chunk=16)
        lays = (*(lay.to("cpu") for lay in lays[:3]), tuple(torch.as_tensor(a)
                                                            for a in lays[3]))
        total = bsz * (1 + NS)
        labels = torch.cat([torch.ones(bsz), torch.zeros(bsz * NS)])
        scores, pen = model.structured_scores(
            edges, torch.as_tensor(d["pos"]).long(), torch.as_tensor(d["ch"]),
            torch.as_tensor(d["ce"]).long(), torch.full((total,), 1.0 / total), lays)
        loss = F.binary_cross_entropy_with_logits(scores, labels) + 0.01 * pen
        loss.backward()
        opt.step()
        out[f"structured_{bsz}"] = {"loss": loss.detach(), **model.state_dict()}
    return out


def jax_sharded_steps(shape, params, d, structured):
    """The JAX package's hosted step (XLA path) and, when asked, its
    structured step (Pallas interpret mode) at 21 positives on the same
    host inputs."""
    import jax

    from rgcn_tpu.dist.host import build_sharded_epoch_host, build_sharded_structured_host
    from rgcn_tpu.dist.mesh import EDGE_AXIS
    from rgcn_tpu.dist.multihost import REPLICA_AXIS, make_mesh_2d
    from rgcn_tpu.dist.train import (
        make_sharded_lp_step_hosted,
        make_sharded_lp_step_hosted_structured,
    )
    from rgcn_tpu.models import LinkPredictor as JLinkPredictor
    from rgcn_tpu.train.optim import make_optimizer

    if len(jax.devices()) < shape[0] * shape[1]:
        pytest.skip("needs more virtual devices")
    mesh = make_mesh_2d(*shape, devices=jax.devices()[:shape[0] * shape[1]])
    axes = dict(axis_name=EDGE_AXIS, decoder_axis_name=(REPLICA_AXIS, EDGE_AXIS))
    tx = make_optimizer("sgd", 0.01)
    stacked = build_sharded_epoch_host(d["pos"], N, R, TILE, shape[1], dropout_rate=0.5,
                                       keep_mask=d["keep"], row_block=8, layout_chunk=TILE)
    out = {}
    step = make_sharded_lp_step_hosted(JLinkPredictor(backend="xla", **axes, **MODEL_KW),
                                       tx, mesh, num_nodes=N, decoder_l2_weight=0.01)
    p, _, loss = step(params, tx.init(params), stacked, d["batch"], d["labels"],
                      jax.random.key(8))
    out["hosted"] = (float(loss), p)
    if structured:
        structured_in = build_sharded_structured_host(d["pos"], d["ch"], d["ce"], N,
                                                      mesh.size, row_block=16, chunk=16)
        step = make_sharded_lp_step_hosted_structured(
            JLinkPredictor(backend="pallas", **axes, **MODEL_KW), tx, mesh,
            decoder_l2_weight=0.01, num_nodes=N)
        p, _, loss = step(params, tx.init(params), stacked, structured_in,
                          jax.random.key(8))
        out["structured"] = (float(loss), p)
    return out


def jax_plain_l2_step(params, d):
    """The JAX package's single-device step with a plain L2 decoder
    penalty (its sharded step gives the relations only one shard's share
    of that penalty's gradient; ROADMAP queue 3)."""
    import jax
    import jax.numpy as jnp
    import optax

    from rgcn_tpu.graph.dynamic import build_edge_set_dynamic_host as j_dyn
    from rgcn_tpu.models import LinkPredictor as JLinkPredictor
    from rgcn_tpu.train.optim import make_optimizer

    model = JLinkPredictor(**dict(MODEL_KW, **PLAIN_L2))
    es = j_dyn(d["pos"], N, R, tile_size=TILE, dropout_rate=0.5, keep_mask=d["keep"],
               with_dst_layout=True, row_block=8, layout_chunk=TILE)

    def loss_fn(p):
        scores, pen = model.apply(p, es, jnp.asarray(d["batch"]))
        return optax.sigmoid_binary_cross_entropy(
            scores, jnp.asarray(d["labels"])).mean() + 0.01 * pen

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = make_optimizer("sgd", 0.01)
    upd, _ = tx.update(grads, tx.init(params), params)
    return float(loss), optax.apply_updates(params, upd)


def assert_params_close(got, want, what):
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[key]), w, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"{what} {key}")


def eval_case(init):
    from rgcn_tpu_torch.train.evaluate import build_filters

    n = 50  # 50 % 4 != 0: the last candidate slice is padded
    triples = random_triples(26, n, R, 240)
    train, test = triples[:200], triples[200:]
    return dict(init=init, n=n, train=train, test=test,
                filters=build_filters(test, {tuple(t) for t in triples}, n))


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_lp_steps_and_evaluation(shape):
    import jax

    from rgcn_tpu.models import LinkPredictor as JLinkPredictor
    from rgcn_tpu.graph.dynamic import build_edge_set_dynamic_host as j_dyn
    from rgcn_tpu_torch.train.link_prediction import evaluate_link_predictor
    from rgcn_tpu_torch.weights import from_jax_params

    def port_state(params):
        return {k: v.numpy() for k, v in
                from_jax_params(jax.tree_util.tree_map(np.asarray, params)).items()}

    inputs = {bsz: step_inputs(bsz) for bsz in (24, 21)}
    d = inputs[21]
    params = JLinkPredictor(**MODEL_KW).init(
        {"params": jax.random.key(5)},
        j_dyn(d["pos"], N, R, tile_size=TILE, with_dst_layout=True, row_block=8,
              layout_chunk=TILE), d["pos"])
    init = port_state(params)
    e_params = JLinkPredictor(**dict(MODEL_KW, num_nodes=50)).init(
        {"params": jax.random.key(3)}, j_dyn(d["pos"], 50, R, tile_size=TILE), d["pos"])
    ev = eval_case(port_state(e_params))

    ranks = spawn(_lp_steps_rank, shape[0] * shape[1], (shape, init, inputs, ev),
                  device="cpu", num_threads=1)
    assert same_on_every_rank(ranks) == 0.0
    got = ranks[0]
    one = one_device_steps(init, inputs)
    jx = jax_sharded_steps(shape, params, d, structured=shape == (2, 2))
    for case, want in one.items():
        np.testing.assert_allclose(got[case]["loss"], want["loss"].numpy(), rtol=1e-5,
                                   err_msg=case)
        assert_params_close(got[case], {k: v for k, v in want.items() if k != "loss"},
                            f"{case} vs one device")
    jx["hosted_plain_l2"] = jax_plain_l2_step(params, d)  # one JAX device
    for kind, (j_loss, j_params) in jx.items():
        np.testing.assert_allclose(got[f"{kind}_21"]["loss"], j_loss, rtol=1e-5)
        assert_params_close(got[f"{kind}_21"], port_state(j_params), f"{kind} vs JAX")

    model = port_lp_model(ev["init"], n=ev["n"])
    from rgcn_tpu_torch.graph.structure import build_edge_set

    eval_edges = build_edge_set(ev["train"], ev["n"], R, tile_size=TILE,
                                with_dst_layout=True).to("cpu")
    mrr, hits, want_ranks = evaluate_link_predictor(model, eval_edges, ev["test"],
                                                    ev["filters"], batch_size=16)
    np.testing.assert_array_equal(got["eval"]["ranks"], want_ranks)
    assert got["eval"]["mrr"] == mrr


# -- the driver -------------------------------------------------------------------


def fb_cfg(load, epochs):
    """lp-FB-toy cut to width 16 (4 blocks), 64 positives an epoch, no
    self-loop dropout (its masks are draws the two packages make apart)."""
    cfg = load(os.path.join(ROOT, "configs", "rgcn", "lp-FB-toy.yaml"))
    enc = cfg.encoder
    return dataclasses.replace(
        cfg,
        training=dataclasses.replace(cfg.training, graph_batch_size=64, epochs=epochs),
        evaluation=dataclasses.replace(cfg.evaluation, batch_size=16, check_every=100),
        encoder=dataclasses.replace(
            enc, node_embedding=16, hidden1_size=16,
            decomposition=dataclasses.replace(enc.decomposition, num_blocks=4),
            edge_dropout=dataclasses.replace(enc.edge_dropout, self_loop=0.0)))


def _lp_driver_rank(dev, init, run_dir, ck_dir):
    """One rank on a 2×2 mesh: 3 epochs straight with records; then 2
    epochs with checkpoints every epoch and a resumed run to 3."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_link_prediction
    from rgcn_tpu_torch.dist.driver import ShardedLinkPredictionTrainer
    from rgcn_tpu_torch.dist.multihost import make_mesh_2d
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    mesh = make_mesh_2d(2, 2, device=dev)

    def trainer(epochs, ck=None):
        data = synthetic_link_prediction(num_nodes=80, num_rels=4, num_edges=400, seed=1)
        return ShardedLinkPredictionTrainer(
            fb_cfg(load_experiment, 3), data, mesh, seed=0, tile_size=16,
            init_state=None if init is None else tensors(init), max_epochs=epochs,
            checkpoint_dir=ck, checkpoint_every=1 if ck else None)

    logger = ScalarLogger(run_dir=run_dir if mesh.rank == 0 else None, verbose=False)
    straight = trainer(3)
    mrr, _, ranks = straight.fit(logger)
    logger.close()
    quiet = ScalarLogger(verbose=False)
    trainer(2, ck_dir).fit(quiet)
    resumed = trainer(3, ck_dir)
    mrr_r, _, ranks_r = resumed.fit(quiet)
    return {"mrr": mrr, "ranks": ranks, "mrr_resumed": mrr_r, "ranks_resumed": ranks_r,
            "params": straight.model.state_dict(), "resumed": resumed.model.state_dict()}


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_sharded_lp_driver_matches_jax_driver_and_resumes(tmp_path):
    """The port's sharded driver on a 2×2 mesh (block encoder, structured
    step) against the JAX sharded driver on a 2×2 mesh from the same
    initialisation: per-epoch losses within rtol 1e-4, the final MRR
    within 1e-3 and at least 99% of the ranks equal; the resumed run
    bit-equal to the unbroken one; every rank the same bits."""
    import jax
    import jax.numpy as jnp

    from rgcn_tpu.config import load_experiment as j_load
    from rgcn_tpu.data.synthetic import synthetic_link_prediction as j_synth
    from rgcn_tpu.dist.driver import train_link_predictor_sharded as j_driver
    from rgcn_tpu.dist.multihost import make_mesh_2d
    from rgcn_tpu.graph.dynamic import build_edge_set_dynamic
    from rgcn_tpu.train.link_prediction import build_lp_model as j_build_lp
    from rgcn_tpu.utils.logging import ScalarLogger as JLogger
    from rgcn_tpu_torch.weights import from_jax_params

    jcfg = fb_cfg(j_load, 3)
    jd = j_synth(num_nodes=80, num_rels=4, num_edges=400, seed=1)
    jd_init = j_synth(num_nodes=80, num_rels=4, num_edges=400, seed=1)
    jd_init.pad_nodes(4)
    init_pos = jnp.asarray(np.asarray(jd_init.train, dtype=np.int64)[:64])
    params = j_build_lp(jcfg, jd_init.num_nodes, jd_init.num_relations).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        build_edge_set_dynamic(init_pos, jd_init.num_nodes, jd_init.num_relations,
                               tile_size=16), init_pos)
    init = {k: v.numpy() for k, v in
            from_jax_params(jax.tree_util.tree_map(np.asarray, params)).items()}
    j_mrr, _, j_ranks, _ = j_driver(
        jcfg, jd, make_mesh_2d(2, 2, devices=jax.devices()[:4]), seed=0, tile_size=16,
        logger=JLogger(run_dir=str(tmp_path / "jax"), verbose=False))

    ranks = spawn(_lp_driver_rank, 4, (init, str(tmp_path / "port"), str(tmp_path / "ck")),
                  device="cpu", num_threads=1)
    assert same_on_every_rank(ranks) == 0.0
    got = ranks[0]
    want = [r for r in _records(tmp_path / "jax") if r["metric"] == "training.loss"]
    losses = [r for r in _records(tmp_path / "port") if r["metric"] == "training.loss"]
    assert [r["step"] for r in losses] == [r["step"] for r in want] == [1, 2, 3]
    np.testing.assert_allclose([r["value"] for r in losses], [r["value"] for r in want],
                               rtol=1e-4)
    assert abs(got["mrr"] - j_mrr) <= 1e-3
    assert np.mean(got["ranks"] == np.asarray(j_ranks)) >= 0.99
    assert got["mrr_resumed"] == got["mrr"]
    np.testing.assert_array_equal(got["ranks_resumed"], got["ranks"])
    for key, value in got["params"].items():
        np.testing.assert_array_equal(got["resumed"][key], value, err_msg=key)


def test_predict_links_cli_virtual_devices(tmp_path):
    """``predict_links --cpu --virtual-devices 2``: two gloo ranks train
    lp-FB-toy's stand-in for one epoch and rank 0 prints the final
    scores."""
    proc = subprocess.run(
        [sys.executable, "-m", "rgcn_tpu_torch.predict_links",
         "--config", os.path.join(ROOT, "configs", "rgcn", "lp-FB-toy.yaml"),
         "--synthetic", "--cpu", "--virtual-devices", "2", "--epochs", "1",
         "--run-dir", str(tmp_path / "run")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "'edge': 2" in proc.stdout
    assert proc.stdout.count("[Final Scores]") == 1  # rank 0 alone prints
    mrr = [r for r in _records(tmp_path / "run") if r["metric"] == "test.mrr"]
    assert len(mrr) == 1 and 0.0 < mrr[0]["value"] <= 1.0
