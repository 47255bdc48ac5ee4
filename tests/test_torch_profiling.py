"""The port's profiling tools (``rgcn_tpu_torch/utils/profiling.py``) on
the CPU: ``StepTimer`` against ``rgcn_tpu.utils.profiling.StepTimer``
under one scripted clock, ``trace`` writing (or not writing) a
``torch.profiler`` trace, and the training CLIs' ``--profile-dir``, one
trace per rank in a sharded run."""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from rgcn_tpu.utils.profiling import StepTimer as JStepTimer
from rgcn_tpu_torch import classify_nodes, predict_links
from rgcn_tpu_torch.utils import profiling
from rgcn_tpu_torch.utils.profiling import StepTimer, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC_CFG = os.path.join(ROOT, "configs", "rgcn", "nc-AIFB.yaml")
LP_CFG = os.path.join(ROOT, "configs", "rgcn", "lp-FB-toy.yaml")


def _traces(d):
    return sorted(glob.glob(os.path.join(str(d), "*.pt.trace.json")))


def _op_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "cpu_op"]


def _drive(timer, steps):
    for _ in range(steps):
        with timer:
            pass
    return (timer.steps, timer.mean_s(), timer.edges_per_s(), timer.summary())


@pytest.mark.parametrize("edges,warmup,steps", [(1000, 2, 6), (37, 0, 3), (5, 4, 2),
                                               (0, 2, 5), (10, 1, 0)])
def test_step_timer_matches_jax_under_one_clock(monkeypatch, edges, warmup, steps):
    ticks = np.cumsum(np.random.default_rng(steps).uniform(1e-4, 5e-2, 2 * steps + 1))
    got = {}
    for name, cls, kw in (("port", StepTimer, {"device": "cpu"}), ("jax", JStepTimer, {})):
        clock = iter(ticks.tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        got[name] = _drive(cls(edges_per_step=edges, warmup=warmup, **kw), steps)
    assert got["port"] == got["jax"]


def test_step_timer_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StepTimer(edges_per_step=10)


def test_trace_writes_one_trace_with_the_ops(tmp_path):
    with trace(str(tmp_path / "prof")):
        a = torch.randn(16, 16)
        (a @ a).relu().sum()
    files = _traces(tmp_path / "prof")
    assert len(files) == 1
    names = _op_names(files[0])
    assert "aten::mm" in names or "aten::matmul" in names
    assert any(n.startswith("aten::") for n in names)


def test_profile_session_opens_the_window_after_the_primer(monkeypatch):
    """With CUDA activity: CUPTI on (prepare_trace), the primer run and
    synchronized, then the capture window opened (start_trace); the card
    synchronized again before the session stops. Without it: a plain
    start and stop."""
    calls = []

    class Recorder:
        def __init__(self, activities, **kwargs):
            calls.append(("init", kwargs.get("on_trace_ready")))

        def prepare_trace(self):
            calls.append("prepare_trace")

        def start_trace(self):
            calls.append("start_trace")

        def start(self):
            calls.append("start")

        def stop(self):
            calls.append("stop")

    monkeypatch.setattr(torch.profiler, "profile", Recorder)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append("sync"))
    monkeypatch.setattr(profiling, "_prime", lambda: calls.append("primer"))
    cpu, cuda = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
    with profiling.profile_session([cpu, cuda], on_trace_ready=print) as prof:
        assert isinstance(prof, Recorder)
        calls.append("block")
    assert calls == [("init", print), "sync", "prepare_trace", "primer", "sync",
                     "start_trace", "block", "sync", "stop"]
    calls.clear()
    with pytest.raises(ValueError):
        with profiling.profile_session([cpu]):
            calls.append("block")
            raise ValueError
    assert calls == [("init", None), "start", "block", "stop"]


def test_trace_disabled_writes_nothing(tmp_path):
    with trace(str(tmp_path / "prof"), enabled=False):
        torch.randn(4, 4).sum()
    assert not os.path.exists(tmp_path / "prof")


def test_classify_nodes_profile_dir(tmp_path, capsys):
    d = tmp_path / "prof"
    classify_nodes.main(["--config", NC_CFG, "--synthetic", "--cpu", "--epochs", "1",
                         "--profile-dir", str(d)])
    files = _traces(d)
    assert len(files) == 1
    assert "[Summary] Test Accuracy" in capsys.readouterr().out
    assert any(n.startswith("aten::") for n in _op_names(files[0]))


def test_predict_links_profile_dir(tmp_path):
    d = tmp_path / "prof"
    predict_links.main(["--config", LP_CFG, "--synthetic", "--cpu", "--epochs", "1",
                        "--profile-dir", str(d)])
    assert len(_traces(d)) == 1


def test_classify_nodes_sharded_profile_dir_per_rank(tmp_path):
    d = tmp_path / "prof"
    classify_nodes.main(["--config", NC_CFG, "--synthetic", "--cpu", "--epochs", "1",
                         "--virtual-devices", "2", "--profile-dir", str(d)])
    assert sorted(os.listdir(d)) == ["rank0", "rank1"]
    for r in ("rank0", "rank1"):
        files = _traces(d / r)
        assert len(files) == 1
        assert any(n.startswith("aten::") for n in _op_names(files[0]))
