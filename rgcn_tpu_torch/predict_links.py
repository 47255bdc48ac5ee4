"""Link-prediction training runner on the GPU (counterpart of
``cli/predict_links.py``).

    python -m rgcn_tpu_torch.predict_links --config configs/rgcn/lp-WN18.yaml \\
        [--data-root DIR | --synthetic] [--epochs 3] [--run-dir DIR] \\
        [--checkpoint-dir DIR] [--checkpoint-every N] [--tile-size 128] [--cpu]

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
Without ``--cpu`` the run needs CUDA and fails without it. Not ported
yet: ``--mesh``, ``--distributed`` and ``--virtual-devices`` (multi-GPU),
``--profile-dir`` (profiling), and ``--exe-cache-dir`` and
``--exe-search``, which exist for XLA's compiled programs.
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
    args = ap.parse_args(argv)

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
    logger = ScalarLogger(run_dir=args.run_dir, name="link_pred")
    try:
        train_link_predictor(cfg, data, logger=logger, tile_size=args.tile_size,
                             device=device, checkpoint_dir=args.checkpoint_dir,
                             checkpoint_every=args.checkpoint_every)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
