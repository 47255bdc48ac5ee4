"""Profiling and throughput instrumentation (counterpart of
``rgcn_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` context that writes a
  TensorBoard-readable trace (``*.pt.trace.json``) of the host's ops and,
  where a card is present, its kernels: the port's own kernels too, which
  launch through ctypes from nvcc-built libraries, since the profiler
  records every kernel launched on the card;
* :func:`profile_session`: the profiler session under :func:`trace` and
  the device-time measurements, primed so that the card's first records
  in a session are kept; :func:`lost_kernel_records` counts the launches
  a finished session holds no kernel record of, and :func:`device_split`
  times a call's kernels, taking again a profile that lost records;
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

__all__ = ["trace", "StepTimer", "lost_kernel_records", "device_split"]


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


def lost_kernel_records(events) -> int:
    """The host's kernel launch calls in a profile's ``events()`` whose
    kernel has no device record: each launch call (a CPU event whose name
    holds ``LaunchKernel``) and its kernel share a CUPTI correlation id (the
    events' ``id``). A profile with lost records undercounts device time."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    launched = {ev.id for ev in events
                if ev.device_type == cpu and "LaunchKernel" in ev.name}
    recorded = {ev.id for ev in events if ev.device_type == cuda}
    return len(launched - recorded)


def device_split(fn, iters: int = 50, warmup: int = 5, tries: int = 5,
                 retaken=None) -> dict:
    """``fn()``'s kernels on the card: ``{"ms": device ms per call,
    "kernels_us": {kernel name: µs per call}, "calls": the calls profiled}``,
    from torch.profiler over ``iters`` back-to-back calls after ``warmup``
    (host launch cost excluded), the card idle when each profile starts.
    A profile that lost records -- a launch
    without its kernel's record (:func:`lost_kernel_records`), or no device
    event at all -- undercounts, and is taken again over half as many calls
    (a longer session loses some more often), down to one call;
    ``retaken(attempt, calls, lost, us)`` is called for each such profile.
    After ``tries`` such profiles it raises RuntimeError."""
    from torch.profiler import ProfilerActivity

    for _ in range(warmup):
        fn()
    for attempt in range(tries):
        if torch.cuda.is_available():
            # work queued before the session (the warm calls, the caller's
            # own) would otherwise run, and be recorded, inside it
            torch.cuda.synchronize()
        with profile_session([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
        events = prof.events()
        per: dict = {}
        for ev in events:
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(ev, "is_user_annotation", False)):
                per[ev.name] = per.get(ev.name, 0.0) + ev.time_range.elapsed_us() / iters
        us = sum(per.values())
        lost = lost_kernel_records(events)
        if us > 0 and not lost:
            return {"ms": us / 1e3, "kernels_us": per, "calls": iters}
        if retaken is not None:
            retaken(attempt + 1, iters, lost, us * iters)
        iters = max(1, iters // 2)
    raise RuntimeError(f"torch.profiler lost kernel records in {tries} profiles")


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
