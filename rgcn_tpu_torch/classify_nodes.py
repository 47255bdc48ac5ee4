"""Node-classification training runner on the GPU (counterpart of
``cli/classify_nodes.py``).

    python -m rgcn_tpu_torch.classify_nodes --config configs/rgcn/nc-AIFB.yaml \\
        [--data-root DIR | --synthetic] [--epochs 3] [--repeats 1] [--run-dir DIR] \\
        [--checkpoint-dir DIR] [--checkpoint-every 10] [--tile-size 128] [--cpu]

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
fails without it. Not ported yet: ``--mesh``, ``--distributed``,
``--backend``, ``--exe-*`` and ``--profile-dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


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
    args = ap.parse_args(argv)

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
    logger = ScalarLogger(run_dir=args.run_dir, name="node_class")
    try:
        run_repeats(cfg, data, logger=logger, tile_size=args.tile_size,
                    device=device, checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
