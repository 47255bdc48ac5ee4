"""Node-classification serving endpoint on the GPU.

    python -m rgcn_tpu_torch.serve_nodes --config configs/rgcn/nc-AIFB.yaml \\
        --synthetic [--nodes node1 42] [--cpu]

Serves the four ``configs/rgcn/nc-*.yaml``: nc-AIFB (no decomposition) and
nc-MUTAG, nc-BGS, nc-AM (basis decomposition with 30, 40, 40 bases), and
the four e-RGCN ``configs/e-rgcn/nc-*.yaml`` (embeddings 32, the diagonal
layer then a dense one). Runs one full forward of the model at load, then answers class queries as
table lookups. The synthetic graph is the one the JAX CLIs pick for the
dataset: AIFB-scale for AIFB, a 500-node graph for the others (the
AM-scale graph is ``rgcn_tpu_torch.data.synthetic.am_like``, which
``chip_smoke.py`` and ``profile_serve --nc-config`` serve). Checkpoint
restore is not ported yet: the served parameters are the port's seeded
initialisation (seed 0), so the classes are those of an untrained model.
Parameters carried from the JAX package go
through ``rgcn_tpu_torch.weights.from_jax_params`` and
``rgcn_tpu_torch.serve.load_nc_server(state_dict=...)``. Only synthetic
graphs are served for now (``--synthetic``). Without ``--cpu`` the run
needs CUDA and fails without it.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--config", required=True)
    ap.add_argument("--synthetic", action="store_true",
                    help="serve a scale-matched synthetic graph (required "
                         "until the RDF loaders are ported)")
    ap.add_argument("--nodes", nargs="*", default=None,
                    help="node names or integer ids to classify")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)

    from rgcn_tpu_torch.config import NodeClassificationExperiment, load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_nc_data
    from rgcn_tpu_torch.serve import load_nc_server

    if not os.path.isfile(args.config):
        ap.error(f"config file not found: {args.config}")
    cfg = load_experiment(args.config)
    if not isinstance(cfg, NodeClassificationExperiment):
        ap.error(f"{args.config} is not a node-classification config")
    if not args.synthetic:
        ap.error("real datasets are not ported yet: pass --synthetic")

    data = synthetic_nc_data(cfg.dataset.name)
    print(
        f"[synthetic] {cfg.dataset.name}-like graph: N={data.num_nodes} "
        f"R={data.num_relations} E={len(data.triples)}"
    )
    srv = load_nc_server(cfg, data, device="cpu" if args.cpu else None)
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
