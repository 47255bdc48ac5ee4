"""Trace the nc-AIFB training gate of ``chip_smoke.py`` on the card.

    python -m rgcn_tpu_torch.trace_train_gate [--runs 20] [--poison-runs 10] \\
        [--epochs 5] [--race-repeats 200] [--same] [--out trace_train_gate.json]

Trains ``configs/rgcn/nc-AIFB.yaml`` on ``aifb_like()`` for ``--epochs``
epochs from the seed-0 initialisation, first on the CPU's plain versions
(the reference), then ``--runs`` times on the card through the trainer's
main path (K1 + K2 over the fused layouts), as ``chip_smoke.py``'s
training phase does: one backward for the first gradients, then
``NodeClassificationTrainer.fit``. For each card run it records

* ``logits_diff``: the final logits' max abs difference from the CPU
  run's, and ``tol``, the gate's 1e-4 * max(1, max|ref|);
* ``own_params_diff``: the card's final logits against the CPU's forward
  of the card's own final parameters (what the kernels answer for, free
  of the trajectory);
* ``param_diff``: after each epoch, the largest parameter difference from
  the CPU run at that epoch;
* ``flips``: per parameter, the entries whose first gradient differs in
  sign between card and CPU (zero counts as a sign), with the largest
  such magnitude on each side, and ``adam_first_step``: the largest
  difference between the two first Adam updates those gradients predict
  (``lr * g / (|g| + eps)`` after bias correction);
* ``top``: the five parameter entries that moved furthest from the CPU's,
  with their first gradients on both sides;
* ``params_sha256`` and ``logits_sha256``: digests of the final parameters'
  and logits' bits.

Before the runs, one more card run trains under
``torch.use_deterministic_algorithms(True, warn_only=True)``: the summary's
``nondeterministic_ops`` lists the warnings PyTorch raised for ops on the
path without a deterministic implementation (the ctypes kernels are
outside its sight).

The summary's ``same`` says whether every card run ended with the same
parameter and logit bits and the same ``logits_diff`` (K1, K2 and the
dense layer's dW sum in a fixed order); ``--same`` makes a run that
differs fail the script (exit 1) after it has printed its lines.

``--poison-runs`` more runs first fill the caching allocator's free
memory with NaN (both its small and its large pool), so that a kernel
that read memory it had not written would turn the result NaN. Then
``--race-repeats`` launches each of K1 and K2 on fixed inputs at the
nc-AIFB shapes and reports the largest difference between any two of
their outputs and from the f64 plain version (a lost update shows as a
jump, reordered atomics as f32 rounding). One JSON line per run and one
summary line; ``--out`` keeps them all. Needs CUDA.

    python -m rgcn_tpu_torch.trace_train_gate --smoke-runs 10 [--out ...]

runs ``chip_smoke.py``'s phases 1-5 (environment, build, the nc-AIFB
kernels, the hub graph, serving, and training: the context the gate met
when it failed) ``--smoke-runs`` times, each in a fresh process, and
records each phase-5 path's final-logits distance from the CPU's and its
gate; a gate that fails ends that process as it ends ``chip_smoke.py``,
with its distance recorded.

    python -m rgcn_tpu_torch.trace_train_gate --lp [--runs 3] [--epochs 2] \
        [--same] [--out trace_train_gate_lp.json]

instead trains ``configs/rgcn/lp-WN18.yaml`` (the structured step: the
host-built subgraph, K4 for the basis layer and its dx and the decoder's
corrupted entities, K1 for its positives, ``dcomps`` and ``d relations``
by ``ops/ordered.py``) on ``wn18_like()`` for ``--epochs`` epochs ``--runs``
times from the seed-0 initialisation, plus one run under
``torch.use_deterministic_algorithms(True, warn_only=True)``
(``nondeterministic_ops``), and records each run's launches, per-epoch
losses, final MRR, and the digests of its final parameters and test
ranks; ``same`` (and ``--same``) as above.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(_ROOT, "configs", "rgcn", "nc-AIFB.yaml")
LP_CONFIG = os.path.join(_ROOT, "configs", "rgcn", "lp-WN18.yaml")


def _state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _snapshot_logger(model, store: list):
    """A quiet ScalarLogger that keeps each epoch's parameters (on the
    host) when the trainer logs that epoch's loss (``model`` None: keeps
    nothing but its records)."""
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    class Snap(ScalarLogger):
        def __init__(self):
            super().__init__(verbose=False)
            self.records = []

        def log_scalar(self, metric, value, step=None):
            self.records.append((metric, step, float(value)))
            if metric == "training.loss" and model is not None:
                store.append(_state(model))

    return Snap()


def _poison_allocator(dev) -> float:
    """Fill the caching allocator's free blocks with NaN: allocate NaN
    tensors into both pools (small: <= 1 MB requests in 2 MB segments;
    large), then free them. Returns the GB poisoned."""
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 16,), float("nan"), device=dev) for _ in range(2048)]
    junk += [torch.full((1 << 24,), float("nan"), device=dev) for _ in range(16)]
    gb = sum(t.numel() * 4 for t in junk) / 1e9
    torch.cuda.synchronize()
    del junk
    return gb


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _nondeterministic_ops(train) -> list:
    """``train()`` under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: the distinct warnings it raised."""
    import warnings

    before = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            train()
        finally:
            torch.use_deterministic_algorithms(before)
    return sorted({str(w.message)[:300] for w in caught})


def _flips(card_grads: dict, cpu_grads: dict, lr: float, eps: float = 1e-8) -> dict:
    out = {}
    for name, g in card_grads.items():
        r = cpu_grads[name]
        mask = torch.sign(g) != torch.sign(r)
        a_card = g / (g.abs() + eps)
        a_cpu = r / (r.abs() + eps)
        out[name] = {
            "count": int(mask.sum()),
            "max_abs_cpu": float(r[mask].abs().max()) if mask.any() else 0.0,
            "max_abs_card": float(g[mask].abs().max()) if mask.any() else 0.0,
            "adam_first_step": float(lr * (a_card - a_cpu).abs().max()),
        }
    return out


def _top_moves(card: dict, ref: dict, card_grads: dict, cpu_grads: dict, k=5):
    rows = []
    for name, v in card.items():
        d = (v - ref[name]).abs().reshape(-1)
        top = torch.topk(d, min(k, d.numel()))
        for val, i in zip(top.values.tolist(), top.indices.tolist()):
            rows.append({"param": name, "index": int(i), "diff": val,
                         "grad_card": float(card_grads[name].reshape(-1)[i]),
                         "grad_cpu": float(cpu_grads[name].reshape(-1)[i])})
    return sorted(rows, key=lambda r: -r["diff"])[:k]


def _race_check(dev, data, repeats: int) -> dict:
    """K1 and K2 ``repeats`` times on fixed inputs at the nc-AIFB shapes."""
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import fused as fz

    edges = build_edge_set(data.triples, data.num_nodes, data.num_relations,
                           tile_size=128, with_dst_layout=True).to(dev)
    n, hidden, classes = data.num_nodes, 16, data.num_classes
    rng = np.random.default_rng(0)
    msgs = torch.from_numpy(rng.standard_normal((edges.src.shape[0], hidden))
                            .astype(np.float32)).to(dev) * edges.val[:, None]
    x = torch.relu(torch.from_numpy(rng.standard_normal((n, hidden))
                                    .astype(np.float32)).to(dev))
    w = torch.from_numpy((rng.standard_normal((edges.num_rels, hidden, classes))
                          * 0.3).astype(np.float32)).to(dev)
    out = {}
    for name, call, plain in (
            ("K1", lambda: agg.aggregate_sorted(msgs, edges.layout, n),
             lambda: agg.aggregate_sorted_plain(msgs.double(), edges.layout, n)),
            ("K2", lambda: fz.rel_spmm_fused(edges.fused, n, x, w, compute_dtype=None),
             lambda: fz.rel_spmm_fused_plain(edges.fused, n, x.double(), w.double()))):
        ref = plain()
        first = call()
        spread, err = 0.0, 0.0
        for _ in range(repeats):
            got = call()
            spread = max(spread, (got - first).abs().max().item())
            err = max(err, (got.double() - ref).abs().max().item())
        torch.cuda.synchronize()
        out[name] = {"repeats": repeats, "max_spread": spread,
                     "max_abs_err_f64": err,
                     "max_abs_ref": ref.abs().max().item()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None,
                    help="the config trained (default: the checkout's nc-AIFB, or "
                         "lp-WN18 with --lp)")
    ap.add_argument("--lp", action="store_true",
                    help="instead: lp-WN18's structured step trained --runs times")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--poison-runs", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--race-repeats", type=int, default=200)
    ap.add_argument("--same", action="store_true",
                    help="fail unless every card run ends with the same bits")
    ap.add_argument("--out", default=None, help="write every record here (JSON)")
    ap.add_argument("--smoke-runs", type=int, default=0,
                    help="instead: chip_smoke.py's phases 1-5 this many times, "
                         "each in a fresh process")
    ap.add_argument("--smoke-child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from rgcn_tpu_torch.config import tool_config

    if args.config is None:
        args.config = LP_CONFIG if args.lp else CONFIG
    if not args.smoke_runs and not args.smoke_child:  # the smoke phases read chip_smoke's
        tool_config(ap, "--config", args.config)
    if not torch.cuda.is_available():
        sys.exit("trace_train_gate needs CUDA")
    if args.smoke_child:
        print(json.dumps(smoke_phases()), flush=True)
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.smoke_runs:
        trace_smoke(args.smoke_runs, args.out)
    else:
        summary = (trace_lp if args.lp else trace)(torch.device("cuda"), args)
        if args.same and not summary.get("same"):
            sys.exit("trace_train_gate: the card runs did not all end with the same bits")


def smoke_phases() -> dict:
    """``chip_smoke.py``'s phases 1-5 in this process; each phase-5
    training path's final-logits distance from the CPU's and its gate."""
    sys.path.insert(0, _ROOT)
    import chip_smoke

    gates = []
    check = chip_smoke.check_train_against_cpu

    def recorded(label, got, ref, logits, ref_logits, diagnose=None):
        gates.append({"path": label,
                      "logits_diff": (logits.cpu() - ref_logits).abs().max().item(),
                      "tol": 1e-4 * max(1.0, ref_logits.abs().max().item())})
        return check(label, got, ref, logits, ref_logits, diagnose)

    chip_smoke.check_train_against_cpu = recorded
    exit_code = 0
    try:
        chip_smoke.phase_environment()
        chip_smoke.phase_build()
        chip_smoke.phases_nc_aifb(torch.device("cuda"))
    except SystemExit as e:  # chip_smoke.fail: a failed check ends the phases
        exit_code = e.code
    return {"smoke_phases_1_5": {"exit_code": exit_code, "gates": gates}}


def trace_smoke(runs: int, out=None) -> dict:
    """:func:`smoke_phases` ``runs`` times, each in a fresh process."""
    import subprocess

    records = []
    for i in range(runs):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rgcn_tpu_torch.trace_train_gate", "--smoke-child"],
            cwd=_ROOT, capture_output=True, text=True, timeout=900)
        lines = proc.stdout.strip().splitlines()
        try:
            rec = json.loads(lines[-1])["smoke_phases_1_5"]
        except (IndexError, ValueError, KeyError):
            rec = {"exit_code": proc.returncode, "gates": [],
                   "stderr_tail": proc.stderr[-2000:]}
        rec.update(run=i, seconds=time.perf_counter() - t0)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    diffs = [g["logits_diff"] for r in records for g in r["gates"]]
    summary = {
        "device": torch.cuda.get_device_name(0), "smoke_runs": runs,
        "processes_failed": sum(r["exit_code"] != 0 for r in records),
        "gates_over_tol": sum(g["logits_diff"] > g["tol"] for r in records
                              for g in r["gates"]),
        "logits_diff_max": max(diffs) if diffs else None,
        "logits_diff_median": float(np.median(diffs)) if diffs else None,
    }
    print(json.dumps({"summary": summary}), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"summary": summary, "runs": records}, f, indent=1)
    return summary


def trace_lp(dev, args) -> dict:
    """The runs of ``--lp`` on ``dev``; returns the summary."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    base = load_experiment(args.config)
    cfg = dataclasses.replace(base, training=dataclasses.replace(
        base.training, epochs=args.epochs))
    data = wn18_like()

    def one_run():
        log = _snapshot_logger(None, [])
        t = LinkPredictionTrainer(cfg, data, device=dev, logger=log)
        kernels.reset_launches()
        mrr, _, ranks = t.fit(log)
        torch.cuda.synchronize()
        return t, log, dict(kernels.LAUNCHES), mrr, ranks

    nondeterministic = _nondeterministic_ops(one_run)
    print(json.dumps({"nondeterministic_ops": nondeterministic}), flush=True)
    records = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        t, log, launches, mrr, ranks = one_run()
        rec = {
            "run": i, "seconds": time.perf_counter() - t0, "launches": launches,
            "losses": [v for m, _, v in log.records if m == "training.loss"],
            "mrr": mrr, "params_sha256": _digest(_state(t.model).values()),
            "ranks_sha256": hashlib.sha256(np.asarray(ranks).tobytes()).hexdigest(),
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del t
    device = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    summary = {"device": device, "config": os.path.basename(args.config),
               "epochs": args.epochs, "runs": args.runs,
               "nondeterministic_ops": nondeterministic,
               "same": len({json.dumps({k: r[k] for k in ("launches", "losses", "mrr",
                                                          "params_sha256", "ranks_sha256")})
                            for r in records}) == 1,
               "distinct_params": len({r["params_sha256"] for r in records})}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "runs": records}, f, indent=1)
    return summary


def trace(dev, args) -> dict:
    """The runs of :func:`main` on ``dev``; returns the summary."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import aifb_like
    from rgcn_tpu_torch.models.node_classification import build_nc_model
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer

    base = load_experiment(args.config)
    cfg = dataclasses.replace(base, training=dataclasses.replace(
        base.training, epochs=args.epochs))
    lr = cfg.training.optimiser.learn_rate
    data = aifb_like()
    init = build_nc_model(cfg, data, seed=0).state_dict()

    def trainer(device):
        return NodeClassificationTrainer(cfg, data, init_params=init, device=device)

    t0 = time.perf_counter()
    ref_epochs = []
    cpu = trainer("cpu")
    cpu.loss().backward()
    cpu_grads = {k: p.grad.clone() for k, p in cpu.model.named_parameters()}
    cpu.fit(_snapshot_logger(cpu.model, ref_epochs))
    ref_logits = cpu.logits()
    print(json.dumps({"reference": "cpu", "epochs": args.epochs,
                      "seconds": time.perf_counter() - t0}), flush=True)

    def one_run():
        t = trainer(dev)
        t.loss().backward()
        t.fit(_snapshot_logger(t.model, []))
        t.logits()

    nondeterministic = _nondeterministic_ops(one_run)
    print(json.dumps({"nondeterministic_ops": nondeterministic}), flush=True)

    records = []
    for i in range(args.runs + args.poison_runs):
        poison = i >= args.runs
        poisoned_gb = _poison_allocator(dev) if poison else 0.0
        t = trainer(dev)
        t.loss().backward()
        card_grads = {k: p.grad.detach().cpu().clone()
                      for k, p in t.model.named_parameters()}
        epochs = []
        t.fit(_snapshot_logger(t.model, epochs))
        logits = t.logits().cpu()
        final = _state(t.model)
        cpu.model.load_state_dict(final)  # the CPU forward of these parameters
        own = cpu.logits()
        rec = {
            "run": i, "poisoned_gb": poisoned_gb,
            "finite": bool(torch.isfinite(logits).all()),
            "logits_diff": (logits - ref_logits).abs().max().item(),
            "tol": 1e-4 * max(1.0, ref_logits.abs().max().item()),
            "own_params_diff": (logits - own).abs().max().item(),
            "param_diff": [max((e[k] - r[k]).abs().max().item() for k in e)
                           for e, r in zip(epochs, ref_epochs)],
            "flips": _flips(card_grads, cpu_grads, lr),
            "top": _top_moves(final, ref_epochs[-1], card_grads, cpu_grads),
            "params_sha256": _digest(final.values()),
            "logits_sha256": _digest([logits]),
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)

    race = _race_check(dev, data, args.race_repeats) if args.race_repeats else None
    device = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    summary = {"device": device, "runs": args.runs,
               "poison_runs": args.poison_runs, "race": race,
               "nondeterministic_ops": nondeterministic}
    if records:
        diffs = [r["logits_diff"] for r in records]
        summary.update(
            logits_diff_max=max(diffs), logits_diff_median=float(np.median(diffs)),
            over_tol=sum(r["logits_diff"] > r["tol"] for r in records),
            own_params_diff_max=max(r["own_params_diff"] for r in records),
            all_finite=all(r["finite"] for r in records),
            same=len({(r["params_sha256"], r["logits_sha256"], r["logits_diff"])
                      for r in records}) == 1,
            distinct_params=len({r["params_sha256"] for r in records}))
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "runs": records}, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
