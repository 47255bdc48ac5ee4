"""Where the time of one serving forward, or one training step, goes on the card.

    python -m rgcn_tpu_torch.profile_serve [--nc-config configs/rgcn/nc-AM.yaml]
    python -m rgcn_tpu_torch.profile_serve --lp [--config configs/rgcn/lp-FB-toy.yaml]
    python -m rgcn_tpu_torch.profile_serve --train [--nc-config configs/rgcn/nc-AIFB.yaml]
    python -m rgcn_tpu_torch.profile_serve --train --lp [--config configs/rgcn/lp-FB-toy.yaml]

Without ``--lp``: builds the NC server of ``--nc-config`` (default
``configs/rgcn/nc-AIFB.yaml``) with seeded parameters on its synthetic
graph: AIFB-scale for nc-AIFB, the AM-scale graph (``am_like``: 300,000
nodes, 266 relations) for nc-AM, the 500-node graph ``serve_nodes`` picks
for nc-MUTAG and nc-BGS; the e-RGCN configs (``configs/e-rgcn/``) on the
same graphs. It reports, as one JSON line, the main path (as the server
routes it: for nc-AIFB K1 + K2) and the same model over the EdgeSet
without its fused layout (layer 2 through K3 + K1).

With ``--lp``: builds the LP server of ``--config`` (default
``configs/rgcn/lp-WN18.yaml``) as ``serve_links`` does (its synthetic graph,
seeded parameters) and reports the encode and one batch of 1024 top-10
tail queries. lp-WN18 (width 200, basis 2): the encode over the merged
frame (K4) and the same model over the EdgeSet whose merged layout carries
the source-dedup'd frame (K5). lp-FB-toy (width 500, 100 blocks): the
encode through the expanded block weights (K3 then K1). A c-RGCN config
(``configs/c-rgcn/``): the encode through its dense R-GCN (K2).

With ``--train``: builds the NC trainer of ``--nc-config`` (seed 0, its
synthetic graph, on the card) and reports one warm training step
(forward, backward, optimizer, the loss read back) as ``step``, and the
step's device time split into ``forward_us`` (the loss), ``backward_us``
(forward and backward, less the forward) and ``optimizer_us``, each from
its own profiler window (:func:`profile_train_step`), and the peak device
memory over those windows (``peak_memory_gb``). nc-AM trains at AM scale
(``am_like``) on the unique-(src, rel) pair path. With ``--train --lp``:
the same for one LP training step of ``--config`` (default lp-WN18) on its
synthetic graph, epoch 1's subgraph and negatives (lp-WN18: batch 30,000,
10 negatives each; lp-FB-toy: batch 300).

For each:

* ``host_ms``: host-clock time of the call (ended by a synchronize),
  median and min over 20 runs after warm-up;
* ``kernels_us``: device time per kernel name over a ``torch.profiler``
  window of 20 calls, per call, and ``device_busy_share`` (summed device
  time over the window's host-clock time, profiler on);

and ``row_blocks``: real slots per row block of each layout (max, median,
count) -- the skew a kernel that gives one CTA a row block would meet.

Needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from rgcn_tpu_torch.device import resolve_device

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "rgcn")
ITERS = 20


def _blocks(local_real, chunk_block, chunk: int, num_row_blocks: int) -> dict:
    """Real and total slots per row block of a chunk layout."""
    offsets = np.searchsorted(chunk_block.cpu().numpy(),
                              np.arange(num_row_blocks + 1)) * chunk
    real = np.add.reduceat(local_real.cpu().numpy().astype(np.int64),
                           offsets[:-1])
    return {"count": int(num_row_blocks), "max_real_slots": int(real.max()),
            "median_real_slots": float(np.median(real)),
            "max_slots": int(np.diff(offsets).max())}


def _layout_blocks(layout) -> dict:
    real = layout.local_dst.reshape(-1) < layout.row_block
    return _blocks(real, layout.chunk_block, layout.chunk, layout.num_row_blocks)


def profile_calls(fn, tries: int = 3, host_ops: int = 0) -> dict:
    """Host-clock times of ``fn()`` and its device time per kernel name. A
    profile that holds no device event at all is taken again, up to
    ``tries`` times (the profiler now and then delivers none). With
    ``host_ops`` > 0 also the that many host ops with the most self CPU
    time per call (``host_ops_us``; profiler on)."""
    from torch.profiler import ProfilerActivity

    from rgcn_tpu_torch.utils.profiling import profile_session

    def call():
        fn()
        torch.cuda.synchronize()

    for _ in range(5):
        call()
    host_ms = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        call()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    for _ in range(tries):
        with profile_session([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                call()
            window_us = (time.perf_counter() - t0) * 1e6
        per_name: dict = {}
        for ev in prof.events():
            # a record_function range (e.g. "Optimizer.step#Adam.step") also
            # shows on the device timeline, spanning kernels counted already
            if ev.device_type == torch.autograd.DeviceType.CUDA \
                    and not ev.is_user_annotation:
                per_name[ev.name] = per_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
        if per_name:
            break
    busy_us = sum(per_name.values())
    report = {
        "host_ms": {"median": float(np.median(host_ms)),
                    "min": float(np.min(host_ms)), "iters": ITERS},
        "kernels_us": {k: v / ITERS for k, v in
                       sorted(per_name.items(), key=lambda kv: -kv[1])},
        "device_busy_share": busy_us / window_us if per_name else None,
    }
    if host_ops:
        ops = sorted((a for a in prof.key_averages()
                      if a.device_type == torch.autograd.DeviceType.CPU),
                     key=lambda a: -a.self_cpu_time_total)[:host_ops]
        report["host_ops_us"] = {a.key: a.self_cpu_time_total / ITERS for a in ops}
    return report


def nc_profile_data(cfg):
    """The graph an NC config is profiled on: ``am_like()`` for AM, else
    the synthetic stand-in ``serve_nodes --synthetic`` serves."""
    from rgcn_tpu_torch.data.synthetic import am_like, synthetic_nc_data

    if cfg.dataset.name.lower() == "am":
        return am_like()
    return synthetic_nc_data(cfg.dataset.name)


def profile_nc(dev, config: str) -> dict:
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.serve import NodeClassificationServer, load_nc_server

    cfg = load_experiment(config)
    data = nc_profile_data(cfg)
    srv = load_nc_server(cfg, data, device=dev)
    branch = NodeClassificationServer(
        srv.model, dataclasses.replace(srv.edges, fused=None))
    return {
        "config": os.path.basename(config),
        "graph": {"nodes": data.num_nodes, "relations": data.num_relations,
                  "triples": int(len(data.triples)),
                  "e_pad": int(srv.edges.src.shape[0])},
        "main": profile_calls(srv.refresh),
        "k3_k1_branch": profile_calls(branch.refresh),
        "row_blocks": {"k1_layout": _layout_blocks(srv.edges.layout),
                       "k2_fused": _layout_blocks(srv.edges.fused)},
    }


def _device_us(report: dict) -> float:
    return sum(report["kernels_us"].values())


def profile_train_step(trainer) -> dict:
    """One warm training step of a
    :class:`~rgcn_tpu_torch.train.node_classification.NodeClassificationTrainer`
    (``step``: host clock, device time per kernel, busy share) and its
    device time split into forward, backward and optimizer, each phase
    profiled in a window of its own. The optimizer window steps the
    parameters again and again: profile after what needs them."""

    def fwd_bwd():
        trainer.optimizer.zero_grad(set_to_none=True)
        trainer.loss().backward()

    forward = profile_calls(trainer.loss)
    backward = profile_calls(fwd_bwd)
    optimizer = profile_calls(trainer.optimizer.step)
    step = profile_calls(trainer.step, host_ops=12)
    return {
        "step": step,
        "forward_us": _device_us(forward),
        "backward_us": _device_us(backward) - _device_us(forward),
        "optimizer_us": _device_us(optimizer),
        "step_us": _device_us(step),
        "forward_kernels_us": forward["kernels_us"],
        "backward_kernels_us": backward["kernels_us"],
        "optimizer_kernels_us": optimizer["kernels_us"],
    }


def profile_train(dev, config: str) -> dict:
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer

    cfg = load_experiment(config)
    data = nc_profile_data(cfg)
    trainer = NodeClassificationTrainer(cfg, data, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    report = profile_train_step(trainer)
    return {
        "config": os.path.basename(config),
        "graph": {"nodes": data.num_nodes, "relations": data.num_relations,
                  "triples": int(len(data.triples)),
                  "e_pad": int(trainer.edges.src.shape[0])},
        "train": report,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }


def profile_lp_train(dev, config: str) -> dict:
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_lp_data
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    cfg = load_experiment(config)
    data = synthetic_lp_data(cfg.dataset.name)
    trainer = LinkPredictionTrainer(cfg, data, device=dev)
    trainer.set_epoch(1)
    es = trainer.batch.edges
    torch.cuda.reset_peak_memory_stats(dev)
    report = profile_train_step(trainer)
    return {
        "config": os.path.basename(config),
        "graph": {"nodes": data.num_nodes, "relations": data.num_relations,
                  "train_triples": int(len(data.train)),
                  "positives": int(trainer.batch.positives.shape[0]),
                  "negatives": int(trainer.batch.corrupt_ent.shape[0]),
                  "e_pad": int(es.src.shape[0]), "layout_slots": int(es.layout.perm.shape[0]),
                  "reverse_e_pad": int(es.reverse.src.shape[0])},
        "train": report,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }


def profile_lp(dev, config: str) -> dict:
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_lp_data
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout
    from rgcn_tpu_torch.serve import LinkPredictionServer, load_lp_server

    cfg = load_experiment(config)
    data = synthetic_lp_data(cfg.dataset.name)
    srv = load_lp_server(cfg, data, device=dev)
    es = srv.edges
    train = np.asarray(data.train)
    queries = train[np.random.default_rng(2).integers(0, len(train), 1024), :2]
    if es.merged is None:  # block (K3 then K1) or c-RGCN (K2) encoder
        block = cfg.encoder.decomposition is not None
        return {
            "config": os.path.basename(config),
            "encode_k3_k1" if block else "encode_k2": profile_calls(srv.refresh),
            "topk_tails_1024": profile_calls(lambda: srv.topk_tails(queries, k=10)),
            "row_blocks": {"k1_layout": _layout_blocks(es.layout)},
        }
    dedup = build_merged_layout(*(t.cpu().numpy() for t in (es.dst, es.src, es.rel, es.val)),
                                es.num_nodes, es.num_rels, dedup_k=2).to(dev)
    branch = LinkPredictionServer(srv.model, dataclasses.replace(es, merged=dedup))
    dd = dedup.fwd_dedup
    return {
        "config": os.path.basename(config),
        "encode_k4_merged": profile_calls(srv.refresh),
        "encode_k5_dedup_branch": profile_calls(branch.refresh),
        "topk_tails_1024": profile_calls(lambda: srv.topk_tails(queries, k=10)),
        "row_blocks": {
            "k4_merged": _layout_blocks(es.merged.layout),
            "k5_dedup": _blocks((dd.local_k < dd.row_block).any(0).reshape(-1),
                                dd.chunk_block, dd.chunk, dd.num_row_blocks),
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lp", action="store_true",
                    help="profile LP serving (--config) instead of NC; with "
                         "--train, one LP training step")
    ap.add_argument("--config", default=os.path.join(_CONFIGS, "lp-WN18.yaml"),
                    help="the LP config --lp serves (default lp-WN18)")
    ap.add_argument("--train", action="store_true",
                    help="profile one training step of --nc-config instead")
    ap.add_argument("--nc-config", default=os.path.join(_CONFIGS, "nc-AIFB.yaml"),
                    help="the NC config served (or, with --train, trained) "
                         "without --lp (default nc-AIFB)")
    args = ap.parse_args(argv)
    from rgcn_tpu_torch.config import tool_config

    if args.lp:
        tool_config(ap, "--config", args.config)
    else:
        tool_config(ap, "--nc-config", args.nc_config)
    dev = resolve_device(None)
    if args.lp and args.train:
        report = profile_lp_train(dev, args.config)
    elif args.lp:
        report = profile_lp(dev, args.config)
    elif args.train:
        report = profile_train(dev, args.nc_config)
    else:
        report = profile_nc(dev, args.nc_config)
    print(json.dumps({"device": torch.cuda.get_device_name(dev), **report}))


if __name__ == "__main__":
    main()
