"""Node-classification serving endpoint on the GPU (counterpart of
``cli/serve_nodes.py``).

    python -m rgcn_tpu_torch.serve_nodes --config configs/rgcn/nc-AIFB.yaml \\
        [--data-root DIR | --synthetic] [--checkpoint-dir DIR] [--nodes node1 42] \\
        [--tile-size 128] [--cpu]

Serves the four ``configs/rgcn/nc-*.yaml``: nc-AIFB (no decomposition) and
nc-MUTAG, nc-BGS, nc-AM (basis decomposition with 30, 40, 40 bases), and
the four e-RGCN ``configs/e-rgcn/nc-*.yaml`` (embeddings 32, the diagonal
layer then a dense one). Runs one full forward of the model at load, then
answers class queries as table lookups. The dataset is read from
``--data-root`` (default ``$RGCN_TPU_DATA``, else the repository's
``data/``), or with ``--synthetic`` the stand-in the JAX CLIs pick:
AIFB-scale for AIFB, a 500-node graph for the others (the AM-scale graph
is ``rgcn_tpu_torch.data.synthetic.am_like``, which ``chip_smoke.py`` and
``profile_serve --nc-config`` serve). ``--checkpoint-dir`` serves the
parameters of the latest checkpoint that ``classify_nodes
--checkpoint-dir`` wrote there (``repeat_1``'s after a run of several
repeats) and fails when it holds none. Without it the served parameters
are the port's seeded initialisation (seed 0), those of an untrained
model; parameters carried from the JAX package go through
``rgcn_tpu_torch.weights.from_jax_params`` and
``rgcn_tpu_torch.serve.load_nc_server(state_dict=...)``. ``--tile-size``
sets the served EdgeSet's tile (edges per relation-uniform tile). Without
``--cpu`` the run needs CUDA and fails without it.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--config", required=True)
    ap.add_argument("--data-root", default=None,
                    help="dataset directory (default $RGCN_TPU_DATA or data/)")
    ap.add_argument("--synthetic", action="store_true",
                    help="serve a scale-matched synthetic graph")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="serve this training checkpoint (default: the seeded "
                         "initialisation)")
    ap.add_argument("--nodes", nargs="*", default=None,
                    help="node names or integer ids to classify")
    ap.add_argument("--tile-size", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)

    from rgcn_tpu_torch.config import NodeClassificationExperiment, load_experiment
    from rgcn_tpu_torch.data.dispatch import load_nc_data
    from rgcn_tpu_torch.serve import load_nc_server

    if not os.path.isfile(args.config):
        ap.error(f"config file not found: {args.config}")
    cfg = load_experiment(args.config)
    if not isinstance(cfg, NodeClassificationExperiment):
        ap.error(f"{args.config} is not a node-classification config")

    try:
        data = load_nc_data(cfg, args.synthetic, data_root=args.data_root)
    except FileNotFoundError as e:
        ap.error(f"dataset file not found ({e.filename}): fetch the datasets "
                 "(data/get_data.sh), pass --data-root, or --synthetic")
    srv = load_nc_server(cfg, data, checkpoint_dir=args.checkpoint_dir,
                         tile_size=args.tile_size,
                         device="cpu" if args.cpu else None)
    if srv is None:
        ap.error(f"no checkpoint found under {args.checkpoint_dir}")
    if args.nodes:
        ids = [data.n2i[t] if t in data.n2i else int(t) for t in args.nodes]
    else:
        ids = [data.n2i[n] for n in list(data.test)[:8]]

    classes = srv.classify(ids)
    probs = srv.probabilities(ids)
    for nid, c, p in zip(ids, classes, probs):
        name = data.i2n[nid] if nid < len(data.i2n) else str(nid)
        print(f"{name}: class {c} (p={p[c]:.3f})")


if __name__ == "__main__":
    main()
