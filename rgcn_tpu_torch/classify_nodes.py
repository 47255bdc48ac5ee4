"""Node-classification training runner on the GPU (counterpart of
``cli/classify_nodes.py``).

    python -m rgcn_tpu_torch.classify_nodes --config configs/rgcn/nc-AIFB.yaml \\
        [--data-root DIR | --synthetic] [--epochs 3] [--repeats 1] [--run-dir DIR] \\
        [--checkpoint-dir DIR] [--checkpoint-every 10] [--tile-size 128] [--cpu] \
        [--mesh N [--virtual-devices N] [--dist-backend gloo] | --distributed --mesh N]

Trains the config's model ``repeats`` times (repeat ``i`` from seed ``i``)
and prints each epoch's loss and accuracies and a summary line (mean test
accuracy -/+ its standard error); ``--run-dir`` also writes the records to
``metrics.jsonl``. Trainable so far: the dense R-GCN (nc-AIFB), basis
configs with more than 8 bases (nc-MUTAG, nc-BGS, nc-AM: the unique-(src,
rel) pair path) and e-RGCN (``configs/e-rgcn/nc-*.yaml``: the diagonal
layer on K1); the other configs raise ``NotImplementedError`` naming
what is missing. The dataset is read from ``--data-root`` (default
``$RGCN_TPU_DATA``, else the repository's ``data/``; the files of
``data/get_data.sh``), or with ``--synthetic`` a scale-matched stand-in
(AIFB-scale for AIFB, the 500-node graph for the others).
``--checkpoint-dir`` saves the parameters and optimizer state every
``--checkpoint-every`` epochs (default 10) and after the last, in
``repeat_{i}`` subdirectories when there are several repeats, and a run
that finds a checkpoint there resumes after it; ``serve_nodes
--checkpoint-dir`` serves it. Without ``--cpu`` the run needs CUDA and
fails without it.

Edge-sharded training (:mod:`rgcn_tpu_torch.dist`, one run from seed 0,
as the JAX CLI's): ``--mesh N`` starts N ranks on this host, one card
each over NCCL (more ranks than cards need ``--dist-backend gloo``), or
with ``--cpu --virtual-devices N`` N gloo ranks on the CPU;
``--distributed`` makes this process one rank of a torchrun job
(``torchrun --nproc-per-node N -m rgcn_tpu_torch.classify_nodes
--distributed --mesh N ...``). Every rank trains the same model on its
share of the edges; rank 0 prints and writes the records. Not ported:
``--backend`` (the JAX per-shard kernel backend), ``--exe-*`` and
``--profile-dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def _train_sharded(dev, cfg, data, args):
    """One rank of ``--mesh``: the sharded trainer over a 1-D edge mesh."""
    from rgcn_tpu_torch.dist.driver import train_node_classifier_sharded
    from rgcn_tpu_torch.dist.mesh import make_mesh
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    mesh = make_mesh(args.mesh, device=dev)
    logger = ScalarLogger(run_dir=args.run_dir if mesh.rank == 0 else None,
                          name="node_class", verbose=mesh.rank == 0)
    logger.info(f"[mesh] {mesh.shape} over {mesh.world_size} ranks on {dev}")
    try:
        return train_node_classifier_sharded(
            cfg, data, mesh, logger=logger, tile_size=args.tile_size,
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every)
    finally:
        logger.close()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--config", required=True, help="YAML experiment config")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None, help="override epochs")
    ap.add_argument("--run-dir", default=None, help="write metrics.jsonl here")
    ap.add_argument("--data-root", default=None,
                    help="dataset directory (default $RGCN_TPU_DATA or data/)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on a scale-matched synthetic graph")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save/resume parameters and optimizer state here "
                         "(repeat_{i} subdirectories when repeats > 1)")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="save cadence in epochs (default: 10)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    ap.add_argument("--tile-size", type=int, default=128)
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="train edge-sharded over N ranks (1-D edge mesh)")
    ap.add_argument("--distributed", action="store_true",
                    help="be one rank of a torchrun job (RANK, WORLD_SIZE, "
                         "LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    ap.add_argument("--virtual-devices", type=int, default=None, metavar="N",
                    help="with --cpu: start N gloo ranks on the CPU")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="collective backend (default: nccl on CUDA, gloo on the CPU)")
    args = ap.parse_args(argv)
    if args.virtual_devices is not None:
        if not args.cpu:
            ap.error("--virtual-devices needs --cpu")
        if args.mesh not in (None, args.virtual_devices):
            ap.error("--mesh must equal --virtual-devices")
        args.mesh = args.virtual_devices
    if args.distributed and args.virtual_devices:
        ap.error("--distributed and --virtual-devices exclude each other")

    from rgcn_tpu_torch.config import NodeClassificationExperiment, load_experiment
    from rgcn_tpu_torch.data.dispatch import load_nc_data
    from rgcn_tpu_torch.device import resolve_device
    from rgcn_tpu_torch.train.node_classification import run_repeats
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    if not os.path.isfile(args.config):
        ap.error(f"config file not found: {args.config}")
    cfg = load_experiment(args.config)
    if not isinstance(cfg, NodeClassificationExperiment):
        ap.error(f"{args.config} is not a node-classification config")
    device = resolve_device("cpu" if args.cpu else None)
    if args.epochs is not None:
        cfg = dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, epochs=args.epochs))
    if args.repeats is not None:
        cfg = dataclasses.replace(cfg, repeats=args.repeats)

    try:
        data = load_nc_data(cfg, args.synthetic, data_root=args.data_root)
    except FileNotFoundError as e:
        ap.error(f"dataset file not found ({e.filename}): fetch the datasets "
                 "(data/get_data.sh), pass --data-root, or --synthetic")
    if not args.synthetic:
        print(f"[data] {cfg.dataset.name}: N={data.num_nodes} R={data.num_relations} "
              f"E={len(data.triples)} train={len(data.train)} test={len(data.test)}")
    if args.distributed or args.mesh:
        from rgcn_tpu_torch.dist.multihost import initialize_distributed, spawn

        dev_arg = "cpu" if args.cpu else None
        if args.distributed:
            dev = initialize_distributed(device=dev_arg, backend=args.dist_backend)
            import torch.distributed as dist

            try:
                _train_sharded(dev, cfg, data, args)
            finally:
                dist.destroy_process_group()
        else:
            spawn(_train_sharded, args.mesh, (cfg, data, args), device=dev_arg,
                  backend=args.dist_backend, timeout_s=24 * 3600)
        return
    logger = ScalarLogger(run_dir=args.run_dir, name="node_class")
    try:
        run_repeats(cfg, data, logger=logger, tile_size=args.tile_size,
                    device=device, checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
