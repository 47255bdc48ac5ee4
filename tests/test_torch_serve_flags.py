"""The serving entry points' tile size and query batch on the CPU:
``load_lp_server(tile_size=, max_batch=)`` as ``rgcn_tpu/serve.py``
builds its server, and ``serve_links --tile-size/--max-batch``,
``serve_nodes --tile-size``."""

import os

import numpy as np

from rgcn_tpu.graph.structure import build_edge_set as j_build_edge_set
from rgcn_tpu_torch import serve_links, serve_nodes
from rgcn_tpu_torch.data.synthetic import fb_toy_like
from rgcn_tpu_torch.serve import load_lp_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LP_CFG = os.path.join(ROOT, "configs", "rgcn", "lp-FB-toy.yaml")
NC_CFG = os.path.join(ROOT, "configs", "rgcn", "nc-AIFB.yaml")


def _answers(srv, data):
    test = np.asarray(data.test)[:20]
    return (srv.score(test),
            *srv.topk_tails(test[:, :2], k=5, filtered=True),
            *srv.topk_heads(test[:, 1:], k=5))


def test_load_lp_server_tile_size_and_max_batch():
    data = fb_toy_like()
    srv = load_lp_server(LP_CFG, data, tile_size=64, max_batch=7, device="cpu")
    ref_edges = j_build_edge_set(np.asarray(data.train, np.int64), data.num_nodes,
                                 data.num_relations, tile_size=64)
    assert srv.edges.tile_size == 64
    assert srv.edges.num_tiles == ref_edges.num_tiles
    assert srv.max_batch == 7

    default_data = fb_toy_like()
    default = load_lp_server(LP_CFG, default_data, device="cpu")
    assert default.max_batch == 1024 and default.edges.tile_size == 128
    assert default.edges.num_tiles != srv.edges.num_tiles
    for got, ref in zip(_answers(srv, data), _answers(default, default_data)):
        np.testing.assert_array_equal(got, ref)


def test_serve_links_tile_size_and_max_batch(capsys):
    serve_links.main(["--config", LP_CFG, "--synthetic", "--cpu", "--tile-size", "64",
                      "--max-batch", "3", "--topk", "4"])
    out = capsys.readouterr().out.splitlines()
    tails = [ln for ln in out if ln.startswith("tails ")]
    assert len(tails) == 8 and all(ln.count(":") == 1 + 4 for ln in tails)


def test_serve_nodes_tile_size(capsys):
    serve_nodes.main(["--config", NC_CFG, "--synthetic", "--cpu", "--tile-size", "64",
                      "--nodes", "node1", "42"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("node1: class ") and out[2].startswith("node42: class ")
