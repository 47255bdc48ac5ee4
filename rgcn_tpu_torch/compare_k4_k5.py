"""K4 and K5 against the other designs tried for them, on the card.

    python -m rgcn_tpu_torch.compare_k4_k5

K4 and K5 (``kernels/csrc/k4_weighted_aggregate.cu``,
``k5_weighted_aggregate_dedup.cu``, both ``weighted_runs.cuh``) give each
chunk a CTA that sorts the chunk's lanes by destination, sums each
destination's run in registers over all din columns and writes a
node-major output once, with no memset of the whole output. Two designs are
kept beside them, built here and launched nowhere else:

* ``kernels/csrc/variants/k45_smem_tile.cu`` (``weighted_tile.cuh``): the
  same sort, but one CTA per (chunk, column slice) merging the runs in a
  shared-memory (RB x nb x columns) tile of at most 48 KB that it then
  writes out once;
* ``kernels/csrc/variants/k4_column_atomics.cu``, ``k5_column_atomics.cu``:
  the designs K4 and K5 replaced, one CTA per (chunk, 32-column group)
  adding every run (K4) or every lane (K5) to a basis-major output with
  global f32 atomics, after a memset of that output.

All run at the lp-WN18 shapes (``wn18_like()``, x (40,943, 200), 2 bases,
the merged pair frame ``load_lp_server`` builds and its dedup frame,
``dedup_k=2``), are held against the plain versions (max abs diff <= 1e-5 *
max(1, max|ref|)), and are timed in the order new, tile, atomics, atomics,
tile, new: device time per call, zeroing included, summed over the kernels
torch.profiler records for 20 calls (``compare_k2.compare``), with each
design's per-kernel split. Prints the card's name and power limit, the
variants' ptxas reports, then one JSON line.

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

_P, _I = ctypes.c_void_p, ctypes.c_int
TILE = os.path.join("variants", "k45_smem_tile.cu")
# variant symbol -> (source under csrc/, ctypes argument types)
VARIANTS = {
    "k4_smem_tile": (TILE, [_P] * 6 + [_I] * 9 + [_P]),
    "k5_smem_tile": (TILE, [_P] * 6 + [_I] * 7 + [_P]),
    "k4_column_atomics": (os.path.join("variants", "k4_column_atomics.cu"),
                          [_P] * 6 + [_I] * 9 + [_P]),
    "k5_column_atomics": (os.path.join("variants", "k5_column_atomics.cu"),
                          [_P] * 6 + [_I] * 7 + [_P]),
}


def build_variants():
    """nvcc the variants; returns ({symbol: function}, ptxas reports)."""
    from rgcn_tpu_torch.kernels.build import build_variant

    built, fns = {}, {}
    for name, (source, argtypes) in VARIANTS.items():
        if source not in built:
            built[source] = build_variant(source)
        fn = getattr(ctypes.CDLL(built[source][0]), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, "\n".join(log.strip() for _, log in built.values())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def k4_variant(fns, name, x, src, w, layout, num_nodes):
    """A K4 variant on a shared table; returns ``(nb, num_nodes, din)``,
    node-major for the tile."""
    nb, din = w.shape[0], x.shape[1]
    tile = name == "k4_smem_tile"
    out = torch.empty((num_nodes, nb, din) if tile else (nb, num_nodes, din),
                      dtype=torch.float32, device=x.device)
    err = fns[name](x.data_ptr(), src.data_ptr(), w.data_ptr(),
                    layout.local_dst.data_ptr(), layout.chunk_block.data_ptr(),
                    out.data_ptr(), layout.num_chunks, layout.chunk, layout.row_block,
                    nb, din, x.shape[0], num_nodes, 0, 0, _stream(x))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return out.permute(1, 0, 2) if tile else out


def k5_variant(fns, name, x, src, w_k, dd, num_nodes):
    """A K5 variant; returns ``(nb, num_nodes, din)``, node-major for the
    tile."""
    kk, nb = w_k.shape[:2]
    din = x.shape[1]
    tile = name == "k5_smem_tile"
    out = torch.empty((num_nodes, nb, din) if tile else (nb, num_nodes, din),
                      dtype=torch.float32, device=x.device)
    err = fns[name](x.data_ptr(), src.data_ptr(), w_k.data_ptr(), dd.local_k.data_ptr(),
                    dd.chunk_block.data_ptr(), out.data_ptr(), dd.num_chunks, dd.chunk,
                    dd.row_block, kk, nb, din, num_nodes, _stream(x))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return out.permute(1, 0, 2) if tile else out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    dev = resolve_device(None)

    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import basis as bs

    print(card(), flush=True)
    fns, ptxas = build_variants()
    print(ptxas, flush=True)

    lp = wn18_like()
    es = build_edge_set(lp.train, lp.num_nodes, lp.num_relations, tile_size=128,
                        with_dst_layout=True, with_merged_layout=True)
    dd = build_merged_layout(es.dst, es.src, es.rel, es.val, es.num_nodes,
                             es.num_rels, dedup_k=2).to(dev).fwd_dedup
    m = es.to(dev).merged
    lay, n, din, nb = m.layout, m.num_nodes, 200, 2
    rng = np.random.default_rng(1)
    x = torch.relu(torch.from_numpy(rng.standard_normal((n, din)).astype(np.float32)).to(dev))
    comps = torch.from_numpy((rng.standard_normal((m.num_rels, nb)) * 0.3)
                             .astype(np.float32)).to(dev)
    w = bs.merged_wvec(m.coeff, comps)
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()

    def k4(name):
        if name == "k4_runs":
            return lambda: bs.weighted_aggregate(x, m.src_sorted, w, lay, n)
        return lambda: k4_variant(fns, name, x, m.src_sorted, w, lay, n)

    def k5(name):
        if name == "k5_runs":
            return lambda: bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, n)
        return lambda: k5_variant(fns, name, x, dd.src_sorted, w_k, dd, n)

    report = {}
    for label, design, ref in (
        ("k4", k4, bs.weighted_aggregate_plain(x, m.src_sorted, w, lay, n)),
        ("k5", k5, bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, n)),
    ):
        names = [f"{label}_runs", f"{label}_smem_tile", f"{label}_column_atomics"]
        report.update(compare({k: design(k) for k in names}, names + names[::-1], ref))
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "shapes": {"x": list(x.shape), "nb": nb,
                                 "k4_slots": lay.num_chunks * lay.chunk,
                                 "k4_chunks": lay.num_chunks,
                                 "k5_slots": dd.num_chunks * dd.chunk,
                                 "k5_chunks": dd.num_chunks,
                                 "row_blocks": lay.num_row_blocks},
                      "designs": report}), flush=True)


if __name__ == "__main__":
    main()
