"""Profiling and throughput instrumentation (counterpart of
``rgcn_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` context that writes a
  TensorBoard-readable trace (``*.pt.trace.json``) of the host's ops and,
  where a card is present, its kernels: the port's own kernels too, which
  launch through ctypes from nvcc-built libraries, since the profiler
  records every kernel launched on the card;
* :func:`profile_session`: the profiler session under :func:`trace` and
  the device-time measurements, primed so that the card's first records
  in a session are kept;
* :class:`StepTimer`: per-step times and the ``edges/s`` counter.

A host clock around a step measures what the host enqueued, not what the
card ran: CUDA calls return before the kernels finish. So on the card
:class:`StepTimer` records a pair of CUDA events around each step on the
current stream and reads them once, when asked for the mean; on the CPU
it reads ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch

from rgcn_tpu_torch.device import resolve_device

__all__ = ["trace", "StepTimer"]


# one-element kernels the card runs between enabling CUPTI and opening the
# capture window (see profile_session)
PRIMER_LAUNCHES = 128


def _prime() -> None:
    primer = torch.zeros(1, device="cuda")
    for _ in range(PRIMER_LAUNCHES):
        primer.add_(1)


@contextlib.contextmanager
def profile_session(activities, **kwargs):
    """A ``torch.profiler.profile(activities=activities, **kwargs)`` over the
    block; yields it, and stops it (``on_trace_ready`` runs) when the block
    ends. With CUDA activity the card is synchronized before the capture
    window opens and before it closes, and between ``prepare_trace`` (CUPTI
    on) and ``start_trace`` (the window open) it runs ``PRIMER_LAUNCHES``
    one-element kernels. On an H100 80GB HBM3, ``chip_smoke.py``'s process
    lost the first records of every session after its phase 22 (its
    nc-AIFB training trace held 197-205 of 207 kernel events); primed
    sessions kept them all. The primer's own records fall before the
    window and are discarded."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=activities, **kwargs)
    cuda = ProfilerActivity.CUDA in activities
    if cuda:
        torch.cuda.synchronize()
        prof.prepare_trace()
        _prime()
        torch.cuda.synchronize()
        prof.start_trace()
    else:
        prof.start()
    try:
        yield prof
    finally:
        if cuda:  # the block's kernels have run before the window closes
            torch.cuda.synchronize()
        prof.stop()


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Profile the block into ``logdir`` (one ``<host>_<pid>.<ms>.pt.trace.json``
    per block, ``torch.profiler.tensorboard_trace_handler``): CPU activity,
    and CUDA activity when ``torch.cuda.is_available()``, through
    :func:`profile_session`. With ``enabled=False`` it does nothing and
    writes nothing."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile_session(activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """Per-step times and edges/s throughput; use as ``with timer: step()``.

    ``device``: None means the card, which must then be present; on it
    each step is timed by CUDA events on the current stream, and
    :meth:`mean_s` synchronizes once, on the last step's end event.
    ``"cpu"`` times with ``time.perf_counter``. The first ``warmup`` steps
    are left out of the mean unless there are no others."""

    def __init__(self, edges_per_step: int = 0, warmup: int = 2, device=None):
        self.edges_per_step = edges_per_step
        self.warmup = warmup
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._times: List[float] = []  # seconds, read from the clock or the events
        self._events: list = []  # (start, end) CUDA events not read yet
        self._t0: Optional[float] = None
        self._start = None

    def __enter__(self):
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self._events.append((self._start, end))
        else:
            self._times.append(time.perf_counter() - self._t0)
        return False

    @property
    def steps(self) -> int:
        return len(self._times) + len(self._events)

    def _seconds(self) -> List[float]:
        if self._events:
            self._events[-1][1].synchronize()
            self._times.extend(s.elapsed_time(e) / 1e3 for s, e in self._events)
            self._events = []
        return self._times

    def mean_s(self) -> float:
        times = self._seconds()
        samples = times[self.warmup:] or times
        return sum(samples) / max(len(samples), 1)

    def edges_per_s(self) -> float:
        m = self.mean_s()
        return self.edges_per_step / m if m > 0 else 0.0

    def summary(self) -> str:
        return (
            f"steps={self.steps} mean={self.mean_s()*1e3:.2f}ms "
            f"edges/s={self.edges_per_s():.3e}"
        )
