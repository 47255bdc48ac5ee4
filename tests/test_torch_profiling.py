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


class _Ev:
    """A profiler event as ``prof.events()`` gives it: its device, name and
    CUPTI correlation id."""

    def __init__(self, device, name, cid, us=1.0):
        self.device_type = (torch.autograd.DeviceType.CUDA if device == "cuda"
                            else torch.autograd.DeviceType.CPU)
        self.name, self.id, self.is_user_annotation = name, cid, False
        self.time_range = type("R", (), {"elapsed_us": lambda self_: us})()


def _launches_and_kernels(launched, recorded):
    return ([_Ev("cpu", "cudaLaunchKernel", c) for c in launched]
            + [_Ev("cpu", "aten::add_", 0), _Ev("cpu", "cudaMemsetAsync", 99)]
            + [_Ev("cuda", "k1_owned_kernel", c) for c in recorded])


@pytest.mark.parametrize("launched,recorded,lost", [
    ([1, 2, 3], [1, 2, 3], 0),            # every launch has its kernel record
    ([1, 2, 3], [1, 3], 1),               # one record lost
    ([1, 2, 3], [], 3),                   # a profile with no device event
    ([], [], 0),                          # nothing launched
    ([4, 5], [4, 5, 6], 0),               # a kernel launched before the window
])
def test_lost_kernel_records(launched, recorded, lost):
    """Launch calls (names with LaunchKernel) whose correlation id no
    device event carries; memsets and host ops are not launches."""
    events = _launches_and_kernels(launched, recorded)
    assert profiling.lost_kernel_records(events) == lost
    events.append(_Ev("cpu", "cuLaunchKernelEx", 77))
    assert profiling.lost_kernel_records(events) == lost + 1


def test_epoch_clock_profiles_through_profile_session(monkeypatch):
    """profile_epoch's busy share: one primed session from epoch ``warm``'s
    loss record to the last's, the next epoch's wall starting after the
    primer; a window that lost records gives no busy share."""
    from rgcn_tpu_torch import profile_epoch

    opened, events = [], []

    class Session:
        def __init__(self, activities):
            opened.append(("open", tuple(activities)))

        def __enter__(self):
            opened.append(time.perf_counter())
            return type("P", (), {"events": lambda self_: list(events)})()

        def __exit__(self, *exc):
            opened.append("close")

    monkeypatch.setattr(profiling, "profile_session", Session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for lost in (False, True):
        opened.clear()
        events[:] = _launches_and_kernels([1, 2], [2] if lost else [1, 2])
        clock = profile_epoch._EpochClock(4, 2, True)
        for epoch in range(1, 5):
            clock.logger.log_scalar("training.loss", 1.0 / epoch, epoch)
            if epoch == 2:
                assert opened[0] == ("open", (torch.profiler.ProfilerActivity.CUDA,))
                assert clock.stamps[2] >= opened[1]  # epoch 3's wall after the primer
        assert opened[-1] == "close" and len(opened) == 3
        assert clock.window >= 0.0
        assert clock.lost_records() == int(lost)
        assert (clock.busy_share() is None) == lost
    quiet = profile_epoch._EpochClock(4, 2, False)
    for epoch in range(1, 5):
        quiet.logger.log_scalar("training.loss", 1.0, epoch)
    assert quiet.busy_share() is None and quiet.lost_records() is None


@pytest.mark.parametrize("losses,calls", [
    ([0], 50),            # the first profile kept every record
    ([1, 0], 25),         # one lost record: taken again over half the calls
    ([3, 1, 0], 12),      # two retakes
    (["empty", 0], 25),   # no device event at all
])
def test_device_split_retakes_a_profile_that_lost_records(monkeypatch, losses, calls):
    """device_split: warm calls, then one profile a try; a profile with a
    launch whose kernel record is missing, or with no device event, is
    taken again over half as many calls and reported to ``retaken``; the
    kept profile gives ms per call, µs per kernel and the calls it holds.
    User annotations on the device are not kernel time."""
    tries = iter(losses)
    ran, retaken = [], []

    class Session:
        def __init__(self, activities):
            self.lost = next(tries)

        def __enter__(self):
            ran.clear()
            return self

        def __exit__(self, *exc):
            pass

        def events(self):
            if self.lost == "empty":
                return [_Ev("cpu", "cudaLaunchKernel", 1)]
            n = len(ran)
            evs = [_Ev("cpu", "cudaLaunchKernel", c) for c in range(2 * n)]
            evs += [_Ev("cuda", "runs_kernel" if c % 2 else "zero_shared_rows", c,
                        us=3.0 if c % 2 else 1.0) for c in range(2 * n - self.lost)]
            note = _Ev("cuda", "phase", 10 ** 6, us=100.0)
            note.is_user_annotation = True
            return evs + [note]

    monkeypatch.setattr(profiling, "profile_session", Session)
    split = profiling.device_split(lambda: ran.append(1), iters=50, warmup=2, tries=5,
                                   retaken=lambda *a: retaken.append(a))
    assert split["calls"] == calls == len(ran)
    assert split["kernels_us"] == pytest.approx({"zero_shared_rows": 1.0, "runs_kernel": 3.0})
    assert split["ms"] == pytest.approx(0.004)
    assert [a[:2] for a in retaken] == [(i + 1, 50 >> i) for i in range(len(losses) - 1)]


def test_device_split_raises_after_its_tries(monkeypatch):
    class Session:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def events(self):
            return [_Ev("cpu", "cudaLaunchKernel", 1)]

    monkeypatch.setattr(profiling, "profile_session", Session)
    seen = []
    with pytest.raises(RuntimeError, match="lost kernel records in 3 profiles"):
        profiling.device_split(lambda: None, iters=8, tries=3,
                               retaken=lambda *a: seen.append(a[1]))
    assert seen == [8, 4, 2]


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
