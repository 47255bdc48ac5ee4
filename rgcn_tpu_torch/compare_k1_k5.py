"""K1's and K5's bf16 designs against the ones they were chosen over, on the card.

    python -m rgcn_tpu_torch.compare_k1_k5 [--out PATH]

K1 (``kernels/csrc/k1_aggregate.cuh``) takes a route by the layout's
shape (``kernels.k1_route``), among them owned rows (a CTA stores each
destination whose slots lie in its span once; only the rows two spans
share are zeroed before and finished with atomics) and atomics (every run
added with an f32 atomic into a memset output).
``kernels/csrc/variants/k1_routes.cu`` forces either of those two, for
both message types, so that both can be timed where the launcher takes
another; ``variants/k1_weighted_runs.cu`` computes K1 by K4's design
(``weighted_runs.cuh`` with one basis, weight 1, the perm or the slot as
the source row), the other design K1's redesign could have taken. K5's
bf16 form (``k5_weighted_aggregate_dedup_bf16.cu``) zeroes the f32 scratch
rows of row blocks with several chunks before its main kernel and narrows
them after, a warp a chunk and 4 values a lane (``weighted_runs.cuh``);
``variants/k5_cta_passes.cu`` is the same call with the passes it replaced
(a CTA a chunk, one value a thread), and ``variants/k5_last_cta.cu`` has
each such block's last CTA narrow it, found by a per-block counter, in
place of the narrowing launch.

Cases, each held against its plain version (f32 out within 1e-5 * max(1,
max|ref|), a bf16 output within 2^-8 * |ref| more) and timed in turns:

* K1 at the port's shapes: nc-AIFB (``aifb_like()``, dout 16 through the
  layout's perm), lp-FB-toy (dout 500), e-RGCN nc-AM's diagonal messages
  in slot order (``am_like()``, dout 32: f32, bf16, bf16 with a bf16
  output), nc-AM through perm at dout 10 (scalar lanes) and 400; then a
  sweep over ``am_like()``'s triples cut to 1/16, 1/8, 1/4 and 1/2 (bf16,
  dout 32) that places the owned route's 1,024 CTAs (``kernels.k1_route``);
* K5 bf16 at lp-WN18 (``wn18_like()``'s dedup frame, din 200, 2 bases,
  bf16 out) against those two variants and against its f32 form.

Times are device time per call: the kernels torch.profiler records over 50
back-to-back calls, summed, with the per-kernel split
(``utils/profiling.device_split``: a profile that holds a launch without
its kernel record is taken again). Prints the card's name
and power limit, then one JSON line (also written to ``--out``).

Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

from rgcn_tpu_torch.compare_k2 import card
from rgcn_tpu_torch.device import resolve_device
from rgcn_tpu_torch.utils.profiling import device_split

_P, _I = ctypes.c_void_p, ctypes.c_int
K1_ROUTES = os.path.join("variants", "k1_routes.cu")
K1_WRUNS = os.path.join("variants", "k1_weighted_runs.cu")
K1_ARGS = [_P] * 6 + [_I] * 7 + [_P]
K5_ARGS = [_P] * 7 + [_I] * 8 + [_P]
# variant symbol -> (source under csrc/, ctypes argument types)
VARIANTS = {
    "k1_owned_f32": (K1_ROUTES, K1_ARGS),
    "k1_atomics_f32": (K1_ROUTES, K1_ARGS),
    "k1_owned_bf16": (K1_ROUTES, K1_ARGS),
    "k1_atomics_bf16": (K1_ROUTES, K1_ARGS),
    "k1_wruns_f32": (K1_WRUNS, K1_ARGS),
    "k1_wruns_bf16": (K1_WRUNS, K1_ARGS),
    "k5_cta_passes": (os.path.join("variants", "k5_cta_passes.cu"), K5_ARGS),
    # K5's arguments, then the per-block counters before the stream
    "k5_last_cta": (os.path.join("variants", "k5_last_cta.cu"), K5_ARGS[:-1] + [_P, _P]),
}
ITERS = 50
SWEEP = (16, 8, 4, 2)  # am_like()'s triples cut to 1/k


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


def held(label: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Max abs error against the plain version's f32 sums (2^-8 * |ref|
    more for a bf16 output); raises past it."""
    err = (got.float() - ref).abs()
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    bound = tol + (2.0 ** -8) * ref.abs() if got.dtype == torch.bfloat16 else tol
    if not bool((err <= bound).all()) or not bool(torch.isfinite(got.float()).all()):
        raise RuntimeError(f"{label}: max abs err {err.max().item()} past its tolerance")
    return err.max().item()


def in_turns(label: str, designs: dict) -> dict:
    """Each design ``name: (call, ref)`` held against its plain version's
    sums ``ref``, then timed in the order of the dict and back (a, b, ...,
    b, a); each design's ms are its two."""
    report = {name: {"max_abs_err": held(f"{label} {name}", call(), ref), "ms": []}
              for name, (call, ref) in designs.items()}
    order = list(designs) + list(designs)[::-1]
    for name in order:
        split = device_split(designs[name][0], ITERS)
        report[name]["ms"].append(split["ms"])
        report[name]["kernels_us"] = {k[:80]: v for k, v in split["kernels_us"].items()}
    line = ", ".join(f"{n} {np.mean(r['ms']):.5f}" for n, r in report.items())
    print(f"{label}: {line}", flush=True)
    return report


def k1_variant(fn, msgs, index, layout, num_nodes, out_dtype=torch.float32):
    """A forced K1 route over ``layout`` (destination-sorted)."""
    bf16_out = out_dtype == torch.bfloat16

    def call():
        out = torch.empty((num_nodes, msgs.shape[1]), dtype=out_dtype, device=msgs.device)
        scratch = torch.empty((num_nodes, msgs.shape[1]), dtype=torch.float32,
                              device=msgs.device) if bf16_out else None
        err = fn(msgs.data_ptr(), None if index is None else index.data_ptr(),
                 layout.local_dst.data_ptr(), layout.chunk_block.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), layout.num_chunks,
                 layout.chunk, layout.row_block, msgs.shape[1], num_nodes, 1, int(bf16_out),
                 torch.cuda.current_stream(msgs.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 variant: CUDA error {err}")
        return out
    return call


def k1_case(fns, label, msgs, index, layout, num_nodes, out_dtype=torch.float32):
    """The launcher's route and both forced routes at one shape."""
    from rgcn_tpu_torch.ops import aggregate as agg

    form = "bf16" if msgs.dtype == torch.bfloat16 else "f32"
    if index is None:
        ref = agg.aggregate_presorted_plain(msgs, layout, num_nodes)
        launcher = lambda: agg.aggregate_presorted(msgs, layout, num_nodes, out_dtype)  # noqa: E731
    else:
        ref = agg.aggregate_sorted_plain(msgs, layout, num_nodes)
        launcher = lambda: agg.aggregate_sorted(msgs, layout, num_nodes, out_dtype=out_dtype)  # noqa: E731
    designs = {
        "launcher": (launcher, ref),
        "owned": (k1_variant(fns[f"k1_owned_{form}"], msgs, index, layout, num_nodes,
                             out_dtype), ref),
        "atomics": (k1_variant(fns[f"k1_atomics_{form}"], msgs, index, layout, num_nodes,
                               out_dtype), ref),
    }
    if form == "bf16" or out_dtype == torch.float32:  # weighted_runs' type pairs
        designs["weighted_runs"] = (k1_variant(fns[f"k1_wruns_{form}"], msgs, index, layout,
                                               num_nodes, out_dtype), ref)
    rep = in_turns(label, designs)
    rep["units"] = layout.num_chunks
    rep["dout"] = int(msgs.shape[1])
    return rep


def _rand(rng, dev, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(dtype)


def compare_k1(fns, dev) -> dict:
    from rgcn_tpu_torch.data.synthetic import aifb_like, am_like, fb_toy_like
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import diag as dg

    bf16 = torch.bfloat16
    rng = np.random.default_rng(20)
    report = {}
    for key, data, dout in (("nc_aifb_d16", aifb_like(), 16), ("lp_fb_toy_d500", fb_toy_like(), 500)):
        triples = data.triples if hasattr(data, "triples") else data.train
        es = build_edge_set(triples, data.num_nodes, data.num_relations, tile_size=128,
                            with_dst_layout=True).to(dev)
        m = _rand(rng, dev, es.layout.num_edges, dout)
        for dt in (torch.float32, bf16):
            report[f"{key}_{'bf16' if dt == bf16 else 'f32'}"] = k1_case(
                fns, f"K1 {key} {dt}", m.to(dt), es.layout.perm, es.layout, es.num_nodes)

    am = am_like()
    es = build_edge_set(am.triples, am.num_nodes, am.num_relations, tile_size=128,
                        with_dst_layout=True).to(dev)
    lay, n = es.layout, es.num_nodes
    x, dw = _rand(rng, dev, n, 32), _rand(rng, dev, es.num_rels, 32) * 0.5
    for key, dt, out_dtype in (("f32", None, torch.float32), ("bf16", bf16, torch.float32),
                               ("bf16_bf16out", bf16, bf16)):
        msgs = dg.diag_slot_messages(x, dw, es, compute_dtype=dt)
        report[f"nc_am_diag_d32_{key}"] = k1_case(fns, f"K1 nc-AM diagonal d32 {key}", msgs,
                                                  None, lay, n, out_dtype)
        del msgs
    for dout in (10, 400):
        m = _rand(rng, dev, lay.num_edges, dout)
        for dt in (torch.float32, bf16):
            report[f"nc_am_perm_d{dout}_{'bf16' if dt == bf16 else 'f32'}"] = k1_case(
                fns, f"K1 nc-AM perm d{dout} {dt}", m.to(dt), lay.perm, lay, n)
        del m
    del es, lay

    for k in SWEEP:  # layout size against the route
        keep = np.random.default_rng(k).permutation(len(am.triples))[: len(am.triples) // k]
        es = build_edge_set(am.triples[keep], am.num_nodes, am.num_relations, tile_size=128,
                            with_dst_layout=True).to(dev)
        msgs = _rand(rng, dev, es.layout.num_chunks * es.layout.chunk, 32, dtype=bf16)
        report[f"sweep_1_{k}"] = k1_case(fns, f"K1 nc-AM 1/{k} d32 bf16", msgs, None,
                                         es.layout, es.num_nodes)
        del es, msgs
    return report


def compare_k5(fns, dev) -> dict:
    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import basis as bs

    data = wn18_like()
    es = build_edge_set(data.train, data.num_nodes, data.num_relations, tile_size=128)
    dd = build_merged_layout(es.dst, es.src, es.rel, es.val, es.num_nodes, es.num_rels,
                             dedup_k=2).to(dev).fwd_dedup
    rng = np.random.default_rng(5)
    n, din, nb = es.num_nodes, 200, 2
    comps = _rand(rng, dev, es.num_rels, nb) * 0.3
    x = torch.relu(_rand(rng, dev, n, din))
    xb = x.to(torch.bfloat16)
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    fn = fns["k5_cta_passes"]

    def cta_passes():
        out = torch.empty((n, nb, din), dtype=torch.bfloat16, device=dev)
        scratch = torch.empty((n, nb, din), dtype=torch.float32, device=dev)
        err = fn(xb.data_ptr(), dd.src_sorted.data_ptr(), w_k.data_ptr(), dd.local_k.data_ptr(),
                 dd.chunk_block.data_ptr(), out.data_ptr(), scratch.data_ptr(), dd.num_chunks,
                 dd.chunk, dd.row_block, dd.num_k, nb, din, n, 1,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"k5_cta_passes: CUDA error {err}")
        return out.permute(1, 0, 2)

    last = fns["k5_last_cta"]
    n_blocks = -(-n // dd.row_block)

    def last_cta():
        out = torch.empty((n, nb, din), dtype=torch.bfloat16, device=dev)
        scratch = torch.empty((n, nb, din), dtype=torch.float32, device=dev)
        block_left = torch.empty(n_blocks, dtype=torch.int32, device=dev)
        err = last(xb.data_ptr(), dd.src_sorted.data_ptr(), w_k.data_ptr(), dd.local_k.data_ptr(),
                   dd.chunk_block.data_ptr(), out.data_ptr(), scratch.data_ptr(), dd.num_chunks,
                   dd.chunk, dd.row_block, dd.num_k, nb, din, n, 1, block_left.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"k5_last_cta: CUDA error {err}")
        return out.permute(1, 0, 2)

    ref = bs.weighted_aggregate_dedup_plain(xb, dd.src_sorted, w_k, dd, n)
    launcher = lambda: bs.weighted_aggregate_dedup(  # noqa: E731
        xb, dd.src_sorted, w_k, dd, n, out_dtype=torch.bfloat16)
    return in_turns("K5 bf16 lp-WN18", {
        "launcher": (launcher, ref),
        "cta_passes": (cta_passes, ref),
        "last_cta": (last_cta, ref),
        "f32_form": (lambda: bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, n),
                     bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, n)),
    })


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON report here")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    fns, ptxas = build_variants()
    print(ptxas, flush=True)
    report = {"card": card(), "k5": compare_k5(fns, dev), "k1": compare_k1(fns, dev)}
    line = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return report


if __name__ == "__main__":
    main()
