"""Link-prediction serving endpoint on the GPU (counterpart of
``cli/serve_links.py``).

    python -m rgcn_tpu_torch.serve_links --config configs/rgcn/lp-WN18.yaml \\
        [--data-root DIR | --synthetic] [--checkpoint-dir DIR] [--queries f.tsv] \\
        [--topk 10] [--filtered] [--tile-size 128] [--max-batch 1024] [--cpu]

Encodes the graph once at load (a basis encoder such as lp-WN18 through
K4, or K5 over a source-dedup'd frame; a block encoder such as lp-FB-toy
through its expanded block weights, K3 then K1; a c-RGCN encoder from
``configs/c-rgcn/`` through K2 at its compressed width), then answers
queries with DistMult algebra.
``--queries`` is a TSV of ``s p o`` rows (point scores) or ``s p ?`` /
``? p o`` rows (top-k tails / heads); entity and relation columns take
names from the dataset vocabulary or integer ids. Without ``--queries``
it ranks tails for the first 8 test triples. ``--filtered`` masks the
known training triples out of the rankings. ``--tile-size`` sets the
served EdgeSet's tile (edges per relation-uniform tile), ``--max-batch``
the most queries answered in one device call.

The dataset is read from ``--data-root`` (default ``$RGCN_TPU_DATA``, else
the repository's ``data/``), or with ``--synthetic`` the stand-in the JAX
CLIs pick (``wn18_like()`` for WN18, ``fb_toy_like()`` for FB-toy).
``--checkpoint-dir`` serves the parameters of the latest checkpoint that
``predict_links --checkpoint-dir`` wrote there and fails when it holds
none. Without it the served parameters are the port's seeded
initialisation (seed 0), those of an untrained model; parameters carried
from the JAX package go through ``rgcn_tpu_torch.weights.from_jax_params``
and ``rgcn_tpu_torch.serve.load_lp_server(state_dict=...)``. Without
``--cpu`` the run needs CUDA and fails without it.
"""

from __future__ import annotations

import argparse
import os
import time


def _resolve(tok: str, vocab, column: str) -> int:
    if tok in vocab:
        return vocab[tok]
    try:
        return int(tok)
    except ValueError:
        raise SystemExit(
            f"error: {column} token {tok!r} is not in the dataset vocabulary "
            "and is not an integer id"
        )


def read_queries(path: str, data):
    """``(triples, tail queries (s, p), head queries (p, o))`` of a TSV."""
    triples, tails, heads = [], [], []
    with open(path) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    for row in rows:
        if len(row) != 3:
            raise SystemExit(f"error: bad query row (need 3 columns): {row}")
        s, p, o = row
        if s == "?":
            heads.append((_resolve(p, data.r2i, "relation"),
                          _resolve(o, data.n2i, "entity")))
        elif o == "?":
            tails.append((_resolve(s, data.n2i, "entity"),
                          _resolve(p, data.r2i, "relation")))
        else:
            triples.append((_resolve(s, data.n2i, "entity"),
                            _resolve(p, data.r2i, "relation"),
                            _resolve(o, data.n2i, "entity")))
    return triples, tails, heads


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
    ap.add_argument("--queries", default=None, help="TSV query file")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--filtered", action="store_true",
                    help="mask known-true training edges out of top-k rankings")
    ap.add_argument("--tile-size", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=1024,
                    help="most queries scored in one device call")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)

    import numpy as np

    from rgcn_tpu_torch.config import LinkPredictionExperiment, load_experiment
    from rgcn_tpu_torch.data.dispatch import load_lp_data
    from rgcn_tpu_torch.serve import load_lp_server

    if not os.path.isfile(args.config):
        ap.error(f"config file not found: {args.config}")
    cfg = load_experiment(args.config)
    if not isinstance(cfg, LinkPredictionExperiment):
        ap.error(f"{args.config} is not a link-prediction config")

    try:
        data = load_lp_data(cfg, args.synthetic, data_root=args.data_root)
    except FileNotFoundError as e:
        ap.error(f"dataset file not found ({e.filename}): fetch the datasets "
                 "(data/get_data.sh), pass --data-root, or --synthetic")
    t0 = time.perf_counter()
    srv = load_lp_server(cfg, data, checkpoint_dir=args.checkpoint_dir,
                         tile_size=args.tile_size, max_batch=args.max_batch,
                         device="cpu" if args.cpu else None)
    if srv is None:
        ap.error(f"no checkpoint found under {args.checkpoint_dir}")
    print(f"[serve] encoded {srv.num_nodes} nodes in "
          f"{time.perf_counter() - t0:.1f}s; top-k={args.topk}")

    def show_rank(tag, q, scores, ents):
        names = [data.i2n[e] if e < len(data.i2n) else str(e) for e in ents]
        print(f"{tag} {q}: " + ", ".join(
            f"{n}:{s:.3f}" for n, s in zip(names, scores)))

    if args.queries:
        triples, tails, heads = read_queries(args.queries, data)
        if triples:
            for t, sc in zip(triples, srv.score(np.asarray(triples))):
                print(f"score {t}: {sc:.4f}")
        for tag, qs, fn in (("tails", tails, srv.topk_tails),
                            ("heads", heads, srv.topk_heads)):
            if qs:
                sc, en = fn(np.asarray(qs), k=args.topk, filtered=args.filtered)
                for q, s_row, e_row in zip(qs, sc, en):
                    show_rank(tag, q, s_row, e_row)
        return

    test = np.asarray(data.test)[:8]
    sc, en = srv.topk_tails(test[:, :2], k=args.topk, filtered=args.filtered)
    for q, s_row, e_row in zip(test[:, :2], sc, en):
        show_rank("tails", tuple(int(v) for v in q), s_row, e_row)


if __name__ == "__main__":
    main()
