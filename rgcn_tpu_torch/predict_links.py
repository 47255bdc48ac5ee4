"""Link-prediction training runner on the GPU (counterpart of
``cli/predict_links.py``).

    python -m rgcn_tpu_torch.predict_links --config configs/rgcn/lp-WN18.yaml \\
        [--data-root DIR | --synthetic] [--epochs 3] [--run-dir DIR] \\
        [--checkpoint-dir DIR] [--checkpoint-every N] [--tile-size 128] [--cpu] \
        [--mesh RxE [--virtual-devices N] [--dist-backend gloo] | --distributed [--mesh RxE]]

Trains the config's link predictor (R-GCN lp-WN18: basis 2, width 200;
lp-FB-toy: 100 blocks, width 500; c-RGCN ``configs/c-rgcn/lp-WN18.yaml``:
width 128 compressed to 16, ``lp-FB-toy.yaml``: 64 to 10) with the JAX trainer's production step
(the training subgraph and negatives built on the host, the structured
DistMult scorer), prints each epoch's loss, the periodic and final
filtered MRR and Hits@1/3/10, and with ``--run-dir`` writes the records to
``metrics.jsonl``. The dataset is read from ``--data-root`` (default
``$RGCN_TPU_DATA``, else the repository's ``data/``: ``wn18/``,
``fb-toy/`` with ``train/valid/test.txt``), or with ``--synthetic`` a
scale-matched stand-in (``wn18_like()`` for WN18, ``fb_toy_like()`` for
FB-toy). ``--checkpoint-dir`` saves the parameters and optimizer state
every ``--checkpoint-every`` epochs (default: the config's
``check_every``) and after the last, and a run that finds a checkpoint
there resumes after it; ``serve_links --checkpoint-dir`` serves it.
Without ``--cpu`` the run needs CUDA and fails without it.

Edge-sharded training (:mod:`rgcn_tpu_torch.dist`, seed 0, as the JAX
CLI's): ``--mesh RxE`` trains over R replicas of E edge shards (``1x4``:
a 1-D mesh of 4; ``auto``: one replica per host), the scoring batch over
all R·E ranks, evaluation candidate-sharded. Without ``--distributed``
the R·E ranks start on this host, one card each over NCCL (more ranks
than cards need ``--dist-backend gloo``), or with ``--cpu
--virtual-devices N`` as N gloo ranks on the CPU (``--mesh`` then
defaults to ``1xN``); ``--distributed`` makes this process one rank of a
torchrun job. Rank 0 prints and writes the records. Not ported:
``--profile-dir`` (profiling), and ``--exe-cache-dir`` and
``--exe-search``, which exist for XLA's compiled programs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def _mesh_shape(spec):
    """``RxE`` -> (R, E); ``auto`` or None -> (None, None)."""
    if spec in (None, "auto"):
        return None, None
    reps, edges = (int(v) for v in spec.lower().split("x"))
    return reps, edges


def _train_sharded(dev, cfg, data, args):
    """One rank of ``--mesh``: the sharded trainer over a (replica x edge)
    mesh."""
    from rgcn_tpu_torch.dist.driver import train_link_predictor_sharded
    from rgcn_tpu_torch.dist.multihost import make_mesh_2d
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    mesh = make_mesh_2d(*_mesh_shape(args.mesh), device=dev)
    logger = ScalarLogger(run_dir=args.run_dir if mesh.rank == 0 else None,
                          name="link_pred", verbose=mesh.rank == 0)
    logger.info(f"[mesh] {mesh.shape} over {mesh.world_size} ranks on {dev}")
    try:
        mrr, hits, _, _ = train_link_predictor_sharded(
            cfg, data, mesh, logger=logger, tile_size=args.tile_size,
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every)
        return mrr, hits
    finally:
        logger.close()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--config", required=True, help="YAML experiment config")
    ap.add_argument("--epochs", type=int, default=None, help="override epochs")
    ap.add_argument("--run-dir", default=None, help="write metrics.jsonl here")
    ap.add_argument("--data-root", default=None,
                    help="dataset directory (default $RGCN_TPU_DATA or data/)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on a scale-matched synthetic graph")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save/resume parameters and optimizer state here")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="save cadence in epochs (default: check_every)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    ap.add_argument("--tile-size", type=int, default=128)
    ap.add_argument("--mesh", default=None, metavar="RxE",
                    help="train edge-sharded over a (replica x edge) mesh, e.g. "
                         "1x4 or 2x2; 'auto' = one replica per host")
    ap.add_argument("--distributed", action="store_true",
                    help="be one rank of a torchrun job (RANK, WORLD_SIZE, "
                         "LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    ap.add_argument("--virtual-devices", type=int, default=None, metavar="N",
                    help="with --cpu: start N gloo ranks on the CPU")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="collective backend (default: nccl on CUDA, gloo on the CPU)")
    args = ap.parse_args(argv)
    try:
        reps, edge = _mesh_shape(args.mesh)
    except ValueError:
        ap.error(f"--mesh must look like 2x4, got {args.mesh!r}")
    if args.virtual_devices is not None:
        if not args.cpu:
            ap.error("--virtual-devices needs --cpu")
        if args.distributed:
            ap.error("--distributed and --virtual-devices exclude each other")
        if args.mesh is None:
            args.mesh = f"1x{args.virtual_devices}"
        elif reps is None or reps * edge != args.virtual_devices:
            ap.error("--mesh RxE must have R*E == --virtual-devices")
    elif args.mesh is not None and not args.distributed and reps is None:
        ap.error("--mesh auto needs --distributed")

    from rgcn_tpu_torch.config import LinkPredictionExperiment, load_experiment
    from rgcn_tpu_torch.data.dispatch import load_lp_data
    from rgcn_tpu_torch.device import resolve_device
    from rgcn_tpu_torch.train.link_prediction import train_link_predictor
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    if not os.path.isfile(args.config):
        ap.error(f"config file not found: {args.config}")
    cfg = load_experiment(args.config)
    if not isinstance(cfg, LinkPredictionExperiment):
        ap.error(f"{args.config} is not a link-prediction config")
    device = resolve_device("cpu" if args.cpu else None)
    if args.epochs is not None:
        cfg = dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, epochs=args.epochs))

    try:
        data = load_lp_data(cfg, args.synthetic, data_root=args.data_root)
    except FileNotFoundError as e:
        ap.error(f"dataset file not found ({e.filename}): fetch the datasets "
                 "(data/get_data.sh), pass --data-root, or --synthetic")
    if not args.synthetic:
        print(f"[data] {cfg.dataset.name}: N={data.num_nodes} R={data.num_relations} "
              f"train={len(data.train)} test={len(data.test)}")
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
            reps, edge = _mesh_shape(args.mesh)
            spawn(_train_sharded, reps * edge, (cfg, data, args), device=dev_arg,
                  backend=args.dist_backend, timeout_s=24 * 3600)
        return
    logger = ScalarLogger(run_dir=args.run_dir, name="link_pred")
    try:
        train_link_predictor(cfg, data, logger=logger, tile_size=args.tile_size,
                             device=device, checkpoint_dir=args.checkpoint_dir,
                             checkpoint_every=args.checkpoint_every)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
