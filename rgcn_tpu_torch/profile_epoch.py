"""Where the host time of a link-prediction epoch goes, with the port's
native host builders and with numpy.

    python -m rgcn_tpu_torch.profile_epoch [--configs lp_wn18,crgcn_lp_wn18,lp_fb_toy]
        [--reps 5] [--fit-epochs 20] [--cpu] [--out profile_epoch.json]

For each config (lp-WN18: ``configs/rgcn/lp-WN18.yaml``, batch 30,000;
c-RGCN lp-WN18: ``configs/c-rgcn/lp-WN18.yaml``, the whole training split;
lp-FB-toy: ``configs/rgcn/lp-FB-toy.yaml``, batch 300; each on its
synthetic graph) it builds the trainer on the card and reports:

* ``stages_ms``: the host milliseconds of each stage of
  :meth:`LinkPredictionTrainer.sample_epoch` with ``prefer_native`` True
  (``native``) and False (``numpy``), the median over ``--reps`` epochs
  after one warm epoch, the two ways in alternating order: the
  sampler; the subgraph's forward sort (sort, normalisation, tiling), its
  destination layout, the reverse sort and the reverse layout;
  ``corrupt_batch_host``; the corrupted entities', subjects' and objects'
  layouts and the scoring rows; the labels and the self-loop keep masks;
  and ``to_device``, ``EpochBatch.to`` ended by a synchronize. Every
  epoch's native batch must equal its numpy batch bit for bit;
* ``fit``: ``--fit-epochs`` epochs of the trainer's ``fit`` (its
  one-worker prefetch) with each host build, and built on the device
  (``host_graph_build=False``: ``device``), through :class:`StagedTrainer`:
  the epoch wall time (between consecutive loss records), the step's
  host time and ``set_epoch``'s (on the device path the positives' copy
  and the build's enqueue), medians over the epochs after the second;
  the device's busy share over those epochs (summed kernel time from
  ``torch.profiler``, CUDA activity only, over the window's host-clock
  time); the peak device memory; the losses.

The card's name and power limit and the host CPU's model and core count
head the JSON line. With ``--cpu`` the trainer runs on the CPU's plain
versions (a rehearsal: no device metric is measured). Without ``--cpu``
it needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from rgcn_tpu_torch.train.link_prediction import (
    EPOCH_STAGES,
    EpochBatch,
    LinkPredictionTrainer,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "lp_wn18": os.path.join(_ROOT, "configs", "rgcn", "lp-WN18.yaml"),
    "crgcn_lp_wn18": os.path.join(_ROOT, "configs", "c-rgcn", "lp-WN18.yaml"),
    "lp_fb_toy": os.path.join(_ROOT, "configs", "rgcn", "lp-FB-toy.yaml"),
}


def batch_differences(a, b, path: str = "batch") -> list:
    """The fields (dotted paths) where two batches, EdgeSets or layouts
    differ: arrays or tensors (on any device) in dtype, shape or any bit,
    the rest by ``==``."""
    if dataclasses.is_dataclass(a):
        if type(a) is not type(b):
            return [path]
        return [d for f in dataclasses.fields(a)
                for d in batch_differences(getattr(a, f.name), getattr(b, f.name),
                                           f"{path}.{f.name}")]
    if isinstance(a, (tuple, list)):
        if not isinstance(b, (tuple, list)) or len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in batch_differences(x, y, f"{path}[{i}]")]
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return [path]
        a, b = a.cpu().numpy(), b.cpu().numpy()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        same = a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        return [] if same else [path]
    return [] if a == b else [path]


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def stage_times(trainer: LinkPredictionTrainer, reps: int) -> dict:
    """Each stage's median host ms over epochs 2..reps + 1 (epoch 1 warms),
    both ways in alternating order, with ``to_device``; every epoch's two
    batches held equal bit for bit."""
    for prefer_native in (True, False):
        trainer.sample_epoch(1, prefer_native)
    laps = {way: {s: [] for s in (*EPOCH_STAGES, "to_device")}
            for way in ("native", "numpy")}
    for epoch in range(2, reps + 2):
        batches = {}
        # alternate which way goes first, so neither always meets the
        # other's warm caches
        for way in ("native", "numpy")[::1 if epoch % 2 else -1]:
            times: Dict[str, float] = {}
            batches[way] = trainer.sample_epoch(epoch, way == "native", times)
            _sync(trainer.device)
            t0 = time.perf_counter()
            batches[way].to(trainer.device)
            _sync(trainer.device)
            times["to_device"] = time.perf_counter() - t0
            for s, v in times.items():
                laps[way][s].append(v * 1e3)
        diff = batch_differences(batches["native"], batches["numpy"])
        if diff:
            raise RuntimeError(f"epoch {epoch}: native and numpy batches differ in {diff}")
    out = {}
    for way, per in laps.items():
        med = {s: float(np.median(v)) for s, v in per.items()}
        med["total"] = float(sum(med.values()))
        out[way] = med
    return out


class StagedTrainer(LinkPredictionTrainer):
    """The trainer whose epochs sample with the builders ``prefer_native``
    picks, recording each sampled epoch's stage seconds, each step's host
    seconds and each ``set_epoch``'s."""

    def __init__(self, *args, prefer_native: bool = True, **kwargs):
        super().__init__(*args, **kwargs)  # host_graph_build=False: device-built
        self.prefer_native = prefer_native
        self.stage_log: list = []
        self.step_s: list = []
        self.set_epoch_s: list = []

    def sample_epoch(self, epoch: int) -> EpochBatch:
        times: Dict[str, float] = {}
        batch = super().sample_epoch(epoch, self.prefer_native, times)
        self.stage_log.append(times)
        return batch

    def set_epoch(self, epoch: int, host: Optional[EpochBatch] = None) -> None:
        t0 = time.perf_counter()
        super().set_epoch(epoch, host)
        self.set_epoch_s.append(time.perf_counter() - t0)

    def step(self) -> float:
        t0 = time.perf_counter()
        loss = super().step()  # reads the loss back: the step has ended
        self.step_s.append(time.perf_counter() - t0)
        return loss


class _EpochClock:
    """A quiet ScalarLogger that stamps each loss record, and runs a
    CUDA-only profiler from epoch ``warm``'s record to the last's."""

    def __init__(self, epochs: int, warm: int, profile_device: bool):
        from rgcn_tpu_torch.utils.logging import ScalarLogger

        clock = self

        class Logger(ScalarLogger):
            def log_scalar(self, metric, value, step=None):
                super().log_scalar(metric, value, step)
                if metric == "training.loss":
                    clock.stamp(step, float(value))

        self.logger = Logger(verbose=False)
        self.epochs, self.warm, self.profile_device = epochs, warm, profile_device
        self.stamps, self.losses = {}, []
        self.session, self.prof, self.window = None, None, None

    def stamp(self, epoch: int, loss: float) -> None:
        from torch.profiler import ProfilerActivity

        from rgcn_tpu_torch.utils.profiling import profile_session

        self.stamps[epoch] = time.perf_counter()
        self.losses.append(loss)
        if not self.profile_device:
            return
        if epoch == self.warm:
            # primed (profile_session); the next epoch's wall starts after it
            self.session = profile_session([ProfilerActivity.CUDA])
            self.prof = self.session.__enter__()
            self.window = self.stamps[epoch] = time.perf_counter()
        elif epoch == self.epochs and self.prof is not None:
            torch.cuda.synchronize()
            self.window = time.perf_counter() - self.window
            self.session.__exit__(None, None, None)

    def lost_records(self) -> Optional[int]:
        """Launches the profile holds no kernel record of (None: no profile)."""
        from rgcn_tpu_torch.utils.profiling import lost_kernel_records

        return None if self.prof is None else lost_kernel_records(self.prof.events())

    def busy_share(self) -> Optional[float]:
        """The window's summed kernel time over its length; None without a
        profile or where the profile lost records (it would undercount)."""
        if self.prof is None or self.lost_records():
            return None
        busy_us = sum(ev.time_range.elapsed_us() for ev in self.prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and not ev.is_user_annotation)
        return busy_us / (self.window * 1e6) if busy_us else None


def fit_epochs(cfg, data, dev, prefer_native: bool, epochs: int,
               init_state=None, host_graph_build: bool = True) -> dict:
    """``epochs`` epochs of :class:`StagedTrainer` ``fit`` on ``dev``:
    epoch wall ms, step host ms and ``set_epoch`` ms (medians over the
    epochs after the second), the busy share over those epochs and the
    peak memory (GB) on a card, the median stage ms as the prefetch thread
    met them (none on the device-built path), the losses, the final MRR
    and ranks."""
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, epochs=epochs))
    warm = min(2, epochs - 1)
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    trainer = StagedTrainer(cfg, data, device=dev, init_state=init_state,
                            prefer_native=prefer_native,
                            host_graph_build=host_graph_build)
    clock = _EpochClock(epochs, warm, cuda)
    mrr, _, ranks = trainer.fit(clock.logger)
    walls = [(clock.stamps[e] - clock.stamps[e - 1]) * 1e3
             for e in range(warm + 1, epochs + 1)]
    steady = slice(warm, None)
    stages = {s: float(np.median([t[s] for t in trainer.stage_log[steady]]) * 1e3)
              for s in EPOCH_STAGES} if trainer.stage_log else {}
    return {
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        "epochs": epochs,
        "epoch_wall_ms": float(np.median(walls)),
        "epoch_wall_ms_all": walls,
        "step_host_ms": float(np.median(trainer.step_s[steady]) * 1e3),
        "set_epoch_ms": float(np.median(trainer.set_epoch_s[steady]) * 1e3),
        "prefetch_stages_ms": stages,
        "device_busy_share": clock.busy_share(),
        "lost_kernel_records": clock.lost_records(),
        "losses": clock.losses,
        "mrr": float(mrr),
        "ranks": np.asarray(ranks),
    }


def host_cpu() -> str:
    """The host CPU as lscpu names it: model, vendor, family and model
    numbers, and the CPU count."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=60).stdout
    except OSError:
        return f"lscpu not found; {os.cpu_count()} CPUs"
    info = dict(ln.split(":", 1) for ln in out.splitlines() if ":" in ln)
    get = {k.strip(): v.strip() for k, v in info.items()}.get
    return (f"{get('Model name')} ({get('Vendor ID')} family {get('CPU family')} "
            f"model {get('Model')}), {get('CPU(s)')} CPUs")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


FIT_WAYS = ("native", "numpy", "device")


def profile_config(key: str, dev, reps: int, fit: int, ways=FIT_WAYS,
                   path: Optional[str] = None) -> dict:
    """Stage split and the fit each of ``ways`` (the host build with the
    native or the numpy builders, or built on the device) for one config
    of :data:`CONFIGS` (read from ``path`` when given)."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_lp_data

    cfg = load_experiment(path or CONFIGS[key])
    data = synthetic_lp_data(cfg.dataset.name)
    t0 = time.perf_counter()
    trainer = LinkPredictionTrainer(cfg, data, device=dev)
    setup_s = time.perf_counter() - t0
    batch = trainer.sample_epoch(1)
    report = {
        "config": os.path.relpath(CONFIGS[key], _ROOT),
        "sizes": {"nodes": int(trainer.num_nodes), "positives": int(len(batch.positives)),
                  "negatives": int(len(batch.corrupt_ent)),
                  "e_pad": int(batch.edges.src.shape[0]),
                  "layout_slots": int(batch.edges.layout.perm.shape[0]),
                  "corrupt_layout_slots": int(batch.layouts[0].perm.shape[0])},
        "trainer_setup_s": setup_s,
        "stages_ms": stage_times(trainer, reps),
    }
    init = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    del trainer, batch
    if fit:
        report["fit"] = {way: fit_epochs(cfg, data, dev, way != "numpy", fit, init,
                                         host_graph_build=way != "device")
                         for way in ways}
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help=f"comma-separated, of {', '.join(CONFIGS)}; KEY=PATH reads "
                         "that config from PATH")
    ap.add_argument("--reps", type=int, default=5, help="epochs timed per stage")
    ap.add_argument("--fit-epochs", type=int, default=20,
                    help="epochs of each fit (0: none)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a rehearsal: no device metric)")
    ap.add_argument("--out", default=None, help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    from rgcn_tpu_torch.config import tool_config
    from rgcn_tpu_torch.device import resolve_device

    paths = {}
    for entry in args.configs.split(","):
        key, _, path = entry.partition("=")
        if key not in CONFIGS:
            ap.error(f"--configs: {key!r} is none of {', '.join(CONFIGS)}")
        paths[key] = tool_config(ap, f"--configs {key}=PATH", path or CONFIGS[key])

    dev = resolve_device("cpu" if args.cpu else None)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    report = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card() if dev.type == "cuda" else "not measured",
        "host_cpu": host_cpu(),
        "configs": {},
    }
    for key, path in paths.items():
        report["configs"][key] = r = profile_config(key, dev, args.reps, args.fit_epochs,
                                                    path=path)
        for f in r.get("fit", {}).values():
            f.pop("ranks")
        print(json.dumps({key: r}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
