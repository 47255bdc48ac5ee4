"""K3 against the designs it replaced, on the card.

    python -m rgcn_tpu_torch.compare_k3 [--probe]

K3 (``kernels/csrc/k3_messages.cu``) gives each (64-row tile window,
128-column slice) a CTA that computes only the rows with a non-zero value,
streaming x[src] and W[rel] k-slabs through shared memory into 3xTF32
``mma.sync`` products summed in f32; for dout <= 32 it takes its small
route (one CTA per tile, W[rel] in shared memory, f32 (edge, column) dots
over the non-zero rows). Two designs are kept beside it, built here and
launched nowhere else:

* ``kernels/csrc/variants/k3_ffma_tiled.cu``: the same CTAs over 128-row
  windows with exact f32 CUDA-core FMAs (4 x 4 register tiles);
* ``kernels/csrc/variants/k3_edge_column.cu``: the PR 1 design, a CTA per
  tile whose threads compute every (edge, column) dot, pads included,
  reading W[rel] through L2 when it exceeds 48 KB.

They run at two shapes: lp-FB-toy (``fb_toy_like()``, x (280, 500), W (224,
500, 500), 250 tiles of 128: the block layer's expanded weights) and
nc-AIFB's K3 branch (``aifb_like()``, x (8,285, 16), W (90, 16, 4), 480
tiles; K3 and the FMA design share the small route there, so only K3 and
the PR 1 design run). Each is held against ``rel_spmm_messages_plain``
(max abs diff <= 1e-5 * max(1, max|ref|)) and timed in the order new,
older, ..., older, new: device time per call summed over the kernels
torch.profiler records for 20 calls (``compare_k2.compare``). Prints the
card's name and power limit, the variants' ptxas reports, then one JSON
line.

``--probe`` adds, at lp-FB-toy, K3's tiled route with parts of its work
switched off (``kernels/csrc/variants/k3_probe.cu``: no MMA; no W or x
load), timed in the order K3, no MMA, no loads, no loads, no MMA, K3: what
the data movement alone and the in-SM loop alone take.

Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

from rgcn_tpu_torch.compare_k2 import card, compare
from rgcn_tpu_torch.device import resolve_device

# symbol -> source under csrc/, each bound with K3's ctypes signature
VARIANTS = {
    "k3_ffma_tiled": os.path.join("variants", "k3_ffma_tiled.cu"),
    "k3_edge_column": os.path.join("variants", "k3_edge_column.cu"),
}
PROBES = {
    "k3_probe_no_mma": os.path.join("variants", "k3_probe.cu"),
    "k3_probe_no_loads": os.path.join("variants", "k3_probe.cu"),
}


def build_variants(symbols: dict):
    """nvcc the sources of ``{symbol: source}`` (each once, afresh) and bind
    each symbol with K3's signature; returns ({symbol: function}, ptxas
    reports)."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.kernels.build import build_variant

    built, fns = {}, {}
    for name, source in symbols.items():
        if source not in built:
            built[source] = build_variant(source)
        fns[name] = getattr(ctypes.CDLL(built[source][0]), name)
        fns[name].argtypes = kernels._ARGTYPES["k3_messages"]
        fns[name].restype = ctypes.c_int
    return fns, "\n".join(log.strip() for _, log in built.values())


def variant_call(fn, edges, x, weights):
    """A design bound with K3's signature on K3's operands; returns
    ``(E_pad, dout)``."""
    dout = weights.shape[-1]
    out = torch.empty((edges.src.shape[0], dout), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), weights.data_ptr(), edges.src.data_ptr(),
             edges.val.data_ptr(), edges.tile_rel.data_ptr(), out.data_ptr(),
             edges.num_tiles, edges.tile_size, weights.shape[1], dout,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 variant: CUDA error {err} at launch")
    return out


def shape_operands(which: str, dev):
    """``(edges, x, W)`` on ``dev`` at the lp-FB-toy or nc-AIFB shape, from
    seed 0: x = relu(N(0, 1)), W ~ N(0, 1/din)."""
    from rgcn_tpu_torch.data.synthetic import aifb_like, fb_toy_like
    from rgcn_tpu_torch.graph.structure import build_edge_set

    if which == "fb_toy":
        data = fb_toy_like()
        triples, din, dout = data.train, 500, 500
    else:
        data = aifb_like()
        triples, din, dout = data.triples, 16, data.num_classes
    edges = build_edge_set(triples, data.num_nodes, data.num_relations,
                           tile_size=128, with_dst_layout=True).to(dev)
    rng = np.random.default_rng(0)
    x = torch.relu(torch.from_numpy(
        rng.standard_normal((data.num_nodes, din)).astype(np.float32))).to(dev)
    w = torch.from_numpy((rng.standard_normal((edges.num_rels, din, dout))
                          * din ** -0.5).astype(np.float32)).to(dev)
    return edges, x, w


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="store_true",
                    help="also time K3 without its MMAs and without its loads")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False

    from rgcn_tpu_torch.ops import rel_spmm as rs

    print(card(), flush=True)
    fns, ptxas = build_variants(VARIANTS)
    print(ptxas, flush=True)

    report, shapes = {}, {}
    for which, older in (("fb_toy", ("k3_ffma_tiled", "k3_edge_column")),
                         ("nc_aifb", ("k3_edge_column",))):
        edges, x, w = shape_operands(which, dev)
        designs = {f"{which}_k3": lambda: rs.rel_spmm_messages(edges, x, w)}
        designs.update({f"{which}_{name[3:]}": (lambda f=fns[name]: variant_call(f, edges, x, w))
                        for name in older})
        order = list(designs)
        report.update(compare(designs, order + order[::-1],
                              rs.rel_spmm_messages_plain(edges, x, w)))
        shapes[which] = {"x": list(x.shape), "w": list(w.shape),
                         "tiles": edges.num_tiles, "real_rows": edges.num_edges}
    probes = {}
    if args.probe:
        from rgcn_tpu_torch.profile_serve import profile_calls

        fns, ptxas = build_variants(PROBES)
        print(ptxas, flush=True)
        edges, x, w = shape_operands("fb_toy", dev)
        calls = {"k3": lambda: rs.rel_spmm_messages(edges, x, w)}
        calls.update({name: (lambda f=f: variant_call(f, edges, x, w))
                      for name, f in fns.items()})
        order = list(calls)
        for name in order + order[::-1]:
            us = profile_calls(calls[name])["kernels_us"]
            probes.setdefault(name, []).append(sum(us.values()) / 1e3)
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "shapes": shapes,
                      "designs": report, "probe_device_ms": probes}), flush=True)


if __name__ == "__main__":
    main()
