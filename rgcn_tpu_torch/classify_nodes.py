"""Node-classification training runner on the GPU (counterpart of
``cli/classify_nodes.py``).

    python -m rgcn_tpu_torch.classify_nodes --config configs/rgcn/nc-AIFB.yaml \\
        --synthetic [--epochs 3] [--repeats 1] [--run-dir DIR] [--tile-size 128] [--cpu]

Trains the config's model ``repeats`` times (repeat ``i`` from seed ``i``)
and prints each epoch's loss and accuracies and a summary line (mean test
accuracy -/+ its standard error); ``--run-dir`` also writes the records to
``metrics.jsonl``. Trainable so far: the dense R-GCN (nc-AIFB), basis
configs with more than 8 bases (nc-MUTAG, nc-BGS, nc-AM: the unique-(src,
rel) pair path) and e-RGCN (``configs/e-rgcn/nc-*.yaml``: the diagonal
layer on K1); the other configs raise ``NotImplementedError`` naming
what is missing. Only synthetic graphs for now (``--synthetic``:
AIFB-scale for AIFB, the 500-node graph for the others). Without ``--cpu`` the run needs CUDA
and fails without it. Not ported yet: ``--data-root``, ``--mesh``,
``--distributed``, ``--backend``, ``--checkpoint-*``, ``--exe-*`` and
``--profile-dir``.
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
    ap.add_argument("--synthetic", action="store_true",
                    help="train on a scale-matched synthetic graph (required "
                         "until the RDF loaders are ported)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    ap.add_argument("--tile-size", type=int, default=128)
    args = ap.parse_args(argv)

    from rgcn_tpu_torch.config import NodeClassificationExperiment, load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_nc_data
    from rgcn_tpu_torch.device import resolve_device
    from rgcn_tpu_torch.train.node_classification import run_repeats
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    if not os.path.isfile(args.config):
        ap.error(f"config file not found: {args.config}")
    cfg = load_experiment(args.config)
    if not isinstance(cfg, NodeClassificationExperiment):
        ap.error(f"{args.config} is not a node-classification config")
    if not args.synthetic:
        ap.error("real datasets are not ported yet: pass --synthetic")
    device = resolve_device("cpu" if args.cpu else None)
    if args.epochs is not None:
        cfg = dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, epochs=args.epochs))
    if args.repeats is not None:
        cfg = dataclasses.replace(cfg, repeats=args.repeats)

    data = synthetic_nc_data(cfg.dataset.name)
    print(
        f"[synthetic] {cfg.dataset.name}-like graph: N={data.num_nodes} "
        f"R={data.num_relations} E={len(data.triples)}"
    )
    logger = ScalarLogger(run_dir=args.run_dir, name="node_class")
    try:
        run_repeats(cfg, data, logger=logger, tile_size=args.tile_size,
                    device=device)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
