"""Checkpoints in the port against the JAX package's (``tests/test_checkpoint.py``,
``tests/test_serve.py``): the round trip, ``latest_step``, partial
restore, the refusal of a JAX-format step directory, resumed NC and LP
training against an unbroken run (on the CPU both are bit-equal: the same
ops on the same inputs in the same order), ``run_repeats``'s
``repeat_{i}`` directories, and servers built from checkpoints: the port's
from a port checkpoint against the JAX package's from a JAX checkpoint of
the same parameters (carried by ``from_jax_params``), within the serving
tests' tolerance, atol 1e-5 * max(1, max|ref|).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgcn_tpu.config import load_experiment as j_load
from rgcn_tpu.data.synthetic import synthetic_link_prediction as j_synth_lp
from rgcn_tpu.data.synthetic import synthetic_node_classification as j_synth_nc
from rgcn_tpu.graph.dynamic import build_edge_set_dynamic as j_dynamic
from rgcn_tpu.graph.structure import build_edge_set as j_build
from rgcn_tpu.serve import load_lp_server as j_load_lp_server
from rgcn_tpu.serve import load_nc_server as j_load_nc_server
from rgcn_tpu.train.link_prediction import build_lp_model as j_build_lp
from rgcn_tpu.train.node_classification import build_nc_model as j_build_nc
from rgcn_tpu.utils.checkpoint import save_checkpoint as j_save
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.synthetic import (
    synthetic_link_prediction,
    synthetic_node_classification,
)
from rgcn_tpu_torch.models.link_prediction import build_lp_model
from rgcn_tpu_torch.models.node_classification import build_nc_model
from rgcn_tpu_torch.serve import load_lp_server, load_nc_server
from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer
from rgcn_tpu_torch.train.node_classification import (
    NodeClassificationTrainer,
    run_repeats,
)
from rgcn_tpu_torch.train.optim import make_optimizer
from rgcn_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from rgcn_tpu_torch.utils.logging import ScalarLogger
from rgcn_tpu_torch.weights import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs", "rgcn")


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


class Records(ScalarLogger):
    def __init__(self):
        super().__init__(verbose=False)
        self.records = []

    def log_scalar(self, metric, value, step=None):
        self.records.append((metric, step, float(value)))


def test_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)},
             "step": 7, "opt_state": {"state": {0: {"step": torch.tensor(2.0)}},
                                      "param_groups": [{"lr": 0.01, "params": [0]}]}}
    path = save_checkpoint(str(tmp_path), state, step=3)
    assert path == os.path.join(str(tmp_path), "step_00000003", "state.pt")
    restored, step = restore_checkpoint(str(tmp_path))
    assert step == 3 and restored["step"] == 7
    for k in ("w", "b"):
        assert torch.equal(restored["params"][k], state["params"][k])
    assert restored["opt_state"]["param_groups"] == state["opt_state"]["param_groups"]
    assert torch.equal(restored["opt_state"]["state"][0]["step"], torch.tensor(2.0))
    assert not [f for f in os.listdir(os.path.dirname(path)) if f.endswith(".tmp")]


def test_latest_step(tmp_path):
    assert latest_step(str(tmp_path)) is None
    state = {"x": torch.ones(2)}
    save_checkpoint(str(tmp_path), state, step=1)
    save_checkpoint(str(tmp_path), {"x": torch.full((2,), 5.0)}, step=5)
    os.makedirs(tmp_path / "repeat_1")  # not a step: ignored
    os.makedirs(tmp_path / "step_notanumber")
    (tmp_path / "notes.txt").write_text("x")
    assert latest_step(str(tmp_path)) == 5
    restored, step = restore_checkpoint(str(tmp_path))
    assert step == 5 and torch.equal(restored["x"], torch.full((2,), 5.0))
    restored, step = restore_checkpoint(str(tmp_path), step=1)
    assert step == 1 and torch.equal(restored["x"], torch.ones(2))


def test_missing_returns_none(tmp_path):
    assert latest_step(str(tmp_path / "nope")) is None
    assert restore_checkpoint(str(tmp_path / "nope")) == (None, None)


def test_partial_restore(tmp_path):
    save_checkpoint(str(tmp_path), {"params": {"w": torch.ones(2)},
                                    "opt_state": {"state": {}}}, step=2)
    state, step = restore_checkpoint(str(tmp_path), partial_keys=("params",))
    assert list(state) == ["params"] and step == 2
    save_checkpoint(str(tmp_path), {"opt_state": {"state": {}}}, step=4)
    with pytest.raises(ValueError, match=r"lacks top-level entries \['params'\].*"
                                         r"holds \['opt_state'\]"):
        restore_checkpoint(str(tmp_path), partial_keys=("params",))


def test_jax_step_directory_raises(tmp_path):
    """A step directory the JAX package wrote (orbax, or msgpack without
    it) is refused by name, never read as no checkpoint at all."""
    j_save(str(tmp_path), {"params": {"w": jnp.ones(3)}}, step=6)
    assert latest_step(str(tmp_path)) == 6
    with pytest.raises(ValueError, match="checkpoint of the JAX package"):
        restore_checkpoint(str(tmp_path))
    cfg = load_experiment(os.path.join(CONFIGS, "nc-AIFB.yaml"))
    data = synthetic_node_classification(num_nodes=40, num_rels=3, num_edges=120)
    trainer = NodeClassificationTrainer(cfg, data, device="cpu",
                                        checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="checkpoint of the JAX package"):
        trainer.fit(Records())


LP_CFG = {
    # tests/test_checkpoint.py::test_lp_training_resume_equivalence
    "dataset": {"name": "synthetic"},
    "training": {
        "epochs": 4,
        "graph_batch_size": 32,
        "negative_sampling": {"sampling_rate": 2, "head_prob": 0.5},
        "optimiser": {"algorithm": "adam", "learn_rate": 0.01,
                      "weight_decay": 0.0},
    },
    "encoder": {
        "model": "rgcn",
        "num_layers": 1,
        "node_embedding": 8,
        "hidden1_size": 8,
        "weight_init": "schlichtkrull-normal",
        "bias_init": "zeros",
    },
    "decoder": {"model": "distmult", "l2_penalty": 0.0},
    "evaluation": {"final_run": False, "filtered": False,
                   "check_every": 2, "batch_size": 16},
}


def test_lp_training_resume_equivalence(tmp_path):
    """4 epochs straight == 2 epochs (``max_epochs=2``), then a resume to
    4: the checkpoint holds all the state and every host draw is indexed by
    (seed, epoch). Bit-equal on the CPU (tighter than the JAX test's rtol
    1e-5 / atol 1e-6)."""
    cfg = load_experiment(LP_CFG)
    data = synthetic_link_prediction(num_nodes=40, num_rels=3, num_edges=200)

    def trainer(**kw):
        return LinkPredictionTrainer(cfg, data, tile_size=8, device="cpu",
                                     logger=Records(), **kw)

    straight, rec_a = trainer(), Records()
    mrr_a, hits_a, ranks_a = straight.fit(rec_a)
    ck = str(tmp_path / "ck")
    first, rec_b = trainer(checkpoint_dir=ck, max_epochs=2), Records()
    first.fit(rec_b)
    assert latest_step(ck) == 2 and sorted(os.listdir(ck)) == ["step_00000002"]
    resumed, rec_c = trainer(checkpoint_dir=ck), Records()
    mrr_c, hits_c, ranks_c = resumed.fit(rec_c)
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]

    for (k, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert mrr_a == mrr_c and hits_a == hits_c
    np.testing.assert_array_equal(ranks_a, ranks_c)
    losses = [r for r in rec_a.records if r[0] == "training.loss"]
    assert [r for r in rec_b.records if r[0] == "training.loss"] == losses[:2]
    assert [r for r in rec_c.records if r[0] == "training.loss"] == losses[2:]
    # the optimizer state came back whole: Adam's step count and moments
    for p, q in zip(straight.optimizer.state.values(),
                    resumed.optimizer.state.values()):
        assert float(p["step"]) == float(q["step"]) == 4.0
        assert torch.equal(p["exp_avg"], q["exp_avg"])
        assert torch.equal(p["exp_avg_sq"], q["exp_avg_sq"])
    # a run that already sits at its last epoch trains nothing and saves
    # nothing more
    again, rec_d = trainer(checkpoint_dir=ck), Records()
    again.fit(rec_d)
    assert [r for r in rec_d.records if r[0] == "training.loss"] == []
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]


def test_lp_checkpoint_cadence_and_final_save(tmp_path):
    """Saves every ``checkpoint_every`` epochs and once after the last
    when the cadence missed it (5 epochs, every 2: steps 2, 4, 5)."""
    cfg = load_experiment(LP_CFG)
    data = synthetic_link_prediction(num_nodes=40, num_rels=3, num_edges=200)
    ck = str(tmp_path / "ck")
    LinkPredictionTrainer(cfg, data, tile_size=8, device="cpu", logger=Records(),
                          checkpoint_dir=ck, checkpoint_every=2,
                          max_epochs=5).fit(Records())
    assert sorted(os.listdir(ck)) == [f"step_0000000{i}" for i in (2, 4, 5)]


def _nc_cfg(name, epochs, hidden=None):
    cfg = load_experiment(os.path.join(CONFIGS, f"{name}.yaml"))
    rg = cfg.rgcn if hidden is None else dataclasses.replace(cfg.rgcn,
                                                             hidden_size=hidden)
    return dataclasses.replace(cfg, rgcn=rg, training=dataclasses.replace(
        cfg.training, epochs=epochs))


@pytest.mark.parametrize("name", ["nc-AIFB", "nc-MUTAG"])
def test_nc_training_resume_equivalence(tmp_path, name):
    """nc-AIFB (the dense R-GCN) and nc-MUTAG (30 bases: the unique-(src,
    rel) pair path) on a small graph: 4 epochs straight == 2 epochs with a
    checkpoint, then 2 more from it. Bit-equal on the CPU."""
    data = synthetic_node_classification(num_nodes=60, num_rels=4, num_edges=300,
                                         seed=2)
    ck = str(tmp_path / "ck")

    def fit(epochs, **kw):
        t = NodeClassificationTrainer(_nc_cfg(name, epochs, hidden=8), data,
                                      tile_size=16, device="cpu", **kw)
        rec = Records()
        acc = t.fit(rec)
        return t, rec.records, acc

    straight, rec_a, acc_a = fit(4)
    _, rec_b, _ = fit(2, checkpoint_dir=ck, checkpoint_every=2)
    assert sorted(os.listdir(ck)) == ["step_00000002"]
    resumed, rec_c, acc_c = fit(4, checkpoint_dir=ck, checkpoint_every=2)
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]
    for k, v in straight.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    per_epoch = [r for r in rec_a if r[1] is not None]
    assert [r for r in rec_b if r[1] is not None] == per_epoch[:6]
    assert [r for r in rec_c if r[1] is not None] == per_epoch[6:]
    assert acc_a == acc_c


def test_nc_final_save_guard(tmp_path):
    """The default cadence (10) misses epoch 3: one final save at step 3;
    a resumed run that already sits past its target saves nothing."""
    data = synthetic_node_classification(num_nodes=40, num_rels=3, num_edges=120)
    ck = str(tmp_path)
    NodeClassificationTrainer(_nc_cfg("nc-AIFB", 3, hidden=4), data, tile_size=16,
                              device="cpu", checkpoint_dir=ck).fit(Records())
    assert os.listdir(ck) == ["step_00000003"]
    rec = Records()
    NodeClassificationTrainer(_nc_cfg("nc-AIFB", 2, hidden=4), data, tile_size=16,
                              device="cpu", checkpoint_dir=ck).fit(rec)
    assert os.listdir(ck) == ["step_00000003"]
    assert [r for r in rec.records if r[0] == "training.loss"] == []


def test_run_repeats_dirs_and_server_fallback(tmp_path):
    """Several repeats checkpoint under repeat_{i}; load_nc_server on the
    parent directory serves repeat_1's parameters."""
    cfg = dataclasses.replace(_nc_cfg("nc-AIFB", 2, hidden=4), repeats=2)
    data = synthetic_node_classification(num_nodes=40, num_rels=3, num_edges=120)
    run_repeats(cfg, data, logger=Records(), tile_size=16, device="cpu",
                checkpoint_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["repeat_1", "repeat_2"]
    for i in (1, 2):
        assert latest_step(str(tmp_path / f"repeat_{i}")) == 2
    srv = load_nc_server(cfg, data, checkpoint_dir=str(tmp_path), device="cpu")
    params, _ = restore_checkpoint(str(tmp_path / "repeat_1"), partial_keys=("params",))
    direct = load_nc_server(cfg, data, params["params"], device="cpu")
    np.testing.assert_array_equal(srv.logits, direct.logits)
    other, _ = restore_checkpoint(str(tmp_path / "repeat_2"))
    assert not torch.equal(other["params"]["rgc1.weights"],
                           params["params"]["rgc1.weights"])
    assert load_nc_server(cfg, data, checkpoint_dir=str(tmp_path / "missing"),
                          device="cpu") is None
    with pytest.raises(ValueError, match="not both"):
        load_nc_server(cfg, data, params["params"], checkpoint_dir=str(tmp_path),
                       device="cpu")


def test_nc_server_from_checkpoint_matches_jax(tmp_path):
    """The JAX server from a JAX checkpoint and the port's from a port
    checkpoint of the same parameters give the same logits and classes
    (``tests/test_serve.py::test_load_nc_server_checkpoint_roundtrip``'s
    setting, on the R-GCN nc-AIFB config)."""
    path = os.path.join(CONFIGS, "nc-AIFB.yaml")
    jcfg, cfg = j_load(path), load_experiment(path)
    kw = dict(num_nodes=50, num_rels=6, num_edges=250, seed=5)
    jdata, data = j_synth_nc(**kw), synthetic_node_classification(**kw)
    jes = j_build(jdata.triples, jdata.num_nodes, jdata.num_relations, tile_size=16,
                  with_dst_layout=True, prefer_native=False)
    jm = j_build_nc(jcfg, jdata)
    params = jm.init(jax.random.key(3), jes)
    j_save(str(tmp_path / "jax"), {"params": params}, step=3)
    jsrv = j_load_nc_server(jcfg, jdata, str(tmp_path / "jax"), tile_size=16)

    model = build_nc_model(cfg, data)
    model.load_state_dict(from_jax_params(_np_tree(params)))
    opt = make_optimizer(model.parameters(), "adam", 0.01)
    save_checkpoint(str(tmp_path / "port"), {"params": model.state_dict(),
                                             "opt_state": opt.state_dict()}, 3)
    srv = load_nc_server(cfg, data, checkpoint_dir=str(tmp_path / "port"),
                         device="cpu")
    np.testing.assert_allclose(srv.logits, jsrv.logits, rtol=0, atol=_tol(jsrv.logits))
    nodes = np.arange(data.num_nodes)
    np.testing.assert_array_equal(srv.classify(nodes), jsrv.classify(nodes))


def test_lp_server_from_checkpoint_matches_jax(tmp_path):
    """lp-WN18's model (width 200, basis 2) on a 60-node graph: the JAX
    server from a JAX training checkpoint ({params, opt_state}) against the
    port's from a port training checkpoint of the same parameters (scores
    and top-10 tails and heads); absent checkpoints give None
    (``tests/test_serve.py::test_load_lp_server_checkpoint_roundtrip``)."""
    import optax

    path = os.path.join(CONFIGS, "lp-WN18.yaml")
    jcfg, cfg = j_load(path), load_experiment(path)
    kw = dict(num_nodes=60, num_rels=6, num_edges=300, reciprocity=0.5, seed=4)
    jdata, data = j_synth_lp(**kw), synthetic_link_prediction(**kw)
    n, r = data.num_nodes, data.num_relations
    train = np.asarray(data.train, dtype=np.int64)
    jm = j_build_lp(jcfg, n, r)
    init_pos = jnp.asarray(train[:64])
    params = jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                     j_dynamic(init_pos, n, r, tile_size=16), init_pos)
    j_save(str(tmp_path / "jax"), {"params": params,
                                   "opt_state": optax.adam(1e-2).init(params)}, step=7)
    jsrv = j_load_lp_server(jcfg, jdata, str(tmp_path / "jax"), tile_size=16)

    model = build_lp_model(cfg, n, r)
    model.load_state_dict(from_jax_params(_np_tree(params)))
    opt = make_optimizer(model.parameters(), "adam", 0.01)
    save_checkpoint(str(tmp_path / "port"), {"params": model.state_dict(),
                                             "opt_state": opt.state_dict()}, 7)
    srv = load_lp_server(cfg, data, checkpoint_dir=str(tmp_path / "port"),
                         device="cpu")
    np.testing.assert_allclose(srv.z.numpy(), np.asarray(jsrv.z), rtol=0,
                               atol=_tol(jsrv.z))
    batch = train[:10]
    want = jsrv.score(batch)
    np.testing.assert_allclose(srv.score(batch), want, rtol=0, atol=_tol(want))
    for fn, q in (("topk_tails", train[:8, :2]), ("topk_heads", train[:8, 1:])):
        s_t, e_t = getattr(srv, fn)(q, k=10, filtered=True)
        s_j, e_j = getattr(jsrv, fn)(q, k=10, filtered=True)
        np.testing.assert_array_equal(e_t, e_j)
        np.testing.assert_allclose(s_t, s_j, rtol=0, atol=_tol(s_j))
    assert load_lp_server(cfg, data, checkpoint_dir=str(tmp_path / "nope"),
                          device="cpu") is None
    assert j_load_lp_server(jcfg, jdata, str(tmp_path / "nope")) is None
