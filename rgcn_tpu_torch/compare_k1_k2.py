"""K1's and K2's fixed-order designs against the designs they were chosen over, on the card.

    python -m rgcn_tpu_torch.compare_k1_k2 [--out PATH] [--am]

K1 (``kernels/csrc/k1_aggregate.cuh``) takes one of two routes by the
layout's order (``kernels.k1_route``), both summing in an order fixed by
the layout in one launch with no memset: kFixed, owned rows over a
destination-sorted layout (every model path's), 4-value lanes with a
masked tail and 8- or 4-byte pieces where dout % 4 != 0; kChunk,
``chunk_sum.cuh``'s CTA a chunk. The launcher entry takes the route as an
argument, so each is timed here at shapes where the launcher takes the
other. The two designs kept before at AM scale, in no fixed order, are
built from ``variants/k1_routes.cu`` (kAtomics, every run added with an
f32 atomic into a memset output, a bf16 output summed in an f32 scratch
and narrowed by a second kernel; kOwned, owned rows whose shared rows are
zeroed first and finished with atomics) and timed beside them. K2 (``k2_fused.cuh`` over ``chunk_sum.cuh``) sums
in a fixed order in one launch with no memset; the design before it is
kept as variants and built here: the quantum-a-CTA kernels with vector f32
atomics into a memset output, both forms (``variants/k2_atomics.cu``,
``variants/k2_atomics_bf16.cu``).

Shapes, each design held against its plain version (f32 out within
1e-5 * max(1, max|ref|), a bf16 output within 2^-8 * |ref| more, K2's bf16
form within 2^-8 of the messages' summed magnitudes more) and timed in
turns, the launcher (``new``) first, the others in order, then back:

* K1 at nc-AIFB (``aifb_like()``, msgs (E_pad, 16) through the layout's
  perm): f32 out, and bf16 out from f32 and from bf16 messages (the phase
  27 shape), against the other three routes;
* K2 at nc-AIFB's layer 2 (x (N, 16), W (90, 16, 4), the fused layout
  ``build_edge_set`` makes) in f32 and bf16, and its dx shape (g (N, 4),
  W^T (90, 4, 16) over the reversed edges' fused layout, f32), against the
  atomics design (``old``);
* K2 f32 at c-RGCN lp-WN18's encode (W (36, 16, 16) over the fused layout
  of ``load_lp_server``'s EdgeSet on ``wn18_like()``);
* K1 at the model paths' other shapes: lp-FB-toy's dout 500 against the
  other three routes, nc-AM's pair path width 10 (through perm, f32 and
  bf16; the atomics route took it before) and e-RGCN nc-AM's diagonal
  messages (dout 32 in slot order, f32 and bf16; the owned route took it
  before), each against the three others.

Each design's device time per call is the kernels torch.profiler records
over 50 back-to-back calls, summed, with the per-kernel split
(``compare_k1_k5.in_turns``); the kernel names of one call are listed
(``kernels``: one for each fixed-order design, no memset, no narrowing
kernel). Each design is launched twice more on the same inputs and
``bit_equal`` says whether the two gave the same bits. Prints the card's
name and power limit, then one JSON line (also written to ``--out``).

    python -m rgcn_tpu_torch.compare_k1_k2 --probe [--out PATH]

instead runs the new designs' per-CTA phase probe
(``variants/k1_k2_probe.cu``: %globaltimer at each CTA's phase boundaries)
at nc-AIFB's K1 and K2 shapes and c-RGCN's K2 shape, and reports each
phase boundary's mean and latest time from the kernel's first CTA start,
the CTAs that finished a split run or block and how long that took.

Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

from rgcn_tpu_torch.compare_k1_k5 import VARIANTS as K1_VARIANTS
from rgcn_tpu_torch.compare_k1_k5 import in_turns, k1_variant
from rgcn_tpu_torch.compare_k2 import OLD_K2_ARGS, card
from rgcn_tpu_torch.device import resolve_device

_P, _I = ctypes.c_void_p, ctypes.c_int
PROBE = os.path.join("variants", "k1_k2_probe.cu")
# variant symbol -> (source under csrc/, ctypes argument types)
VARIANTS = {
    # the launchers' arguments with the stamps before the stream
    "k1_probe_f32": (PROBE, [_P] * 7 + [_I] * 7 + [_P, _P]),
    "k2_probe_f32": (PROBE, [_P] * 10 + [_I] * 7 + [_P, _P]),
    # K2's arguments and the probe's switches (chunk_sum.cuh kSkip* bits)
    "k2_switches_f32": (PROBE, [_P] * 10 + [_I] * 8 + [_P]),
    "k2_atomics_f32": (os.path.join("variants", "k2_atomics.cu"), OLD_K2_ARGS),
    "k2_atomics_bf16": (os.path.join("variants", "k2_atomics_bf16.cu"), OLD_K2_ARGS),
}
# K1's designs in no fixed order (compare_k1_k5's variants)
VARIANTS.update({name: K1_VARIANTS[name] for name in (
    "k1_atomics_f32", "k1_atomics_bf16", "k1_owned_f32", "k1_owned_bf16")})
BF16 = torch.bfloat16


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


def kernel_names(call) -> list:
    """The device events of one call, in launch order (a profile that lost
    a record is taken again)."""
    from torch.profiler import ProfilerActivity

    from rgcn_tpu_torch.utils.profiling import lost_kernel_records, profile_session

    call()
    torch.cuda.synchronize()
    for _ in range(8):
        with profile_session([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = prof.events()
        names = [ev.name for ev in sorted(events, key=lambda e: e.time_range.start)
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", False)]
        if names and not lost_kernel_records(events):
            return [n[:100] for n in names]
    raise RuntimeError("torch.profiler lost kernel records in 8 profiles")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN included)."""
    bits = torch.int16 if a.dtype == BF16 else torch.int32
    return a.dtype == b.dtype and bool(torch.equal(a.view(bits), b.view(bits)))


def bit_equal(call) -> bool:
    """Two more launches on the same inputs give the same bits."""
    return same_bits(call(), call())


ROUTE_NAMES = {0: "fixed", 1: "chunk", 2: "atomics", 3: "owned"}


def forced_k1(route, msgs, index, layout, num_nodes, out_dtype=torch.float32, fns=None):
    """K1's launcher entry with its route forced (``kernels.K1_*``), the
    scratch and counters sized as the wrapper sizes them; routes 2 and 3
    (atomics, owned) from ``variants/k1_routes.cu`` in ``fns``."""
    from rgcn_tpu_torch import kernels

    dev, dout = msgs.device, msgs.shape[1]
    bf16_out = out_dtype == BF16
    if route > kernels.K1_CHUNK:
        form = "bf16" if msgs.dtype == BF16 else "f32"
        return k1_variant(fns[f"k1_{ROUTE_NAMES[route]}_{form}"], msgs, index, layout,
                          num_nodes, out_dtype)
    fn = kernels._fn("k1_aggregate" + ("_bf16" if msgs.dtype == BF16 else ""))
    lay = layout
    floats = kernels.k1_scratch_floats(route, lay.num_chunks, lay.chunk, lay.row_block, dout)
    counters = (kernels.k1_fixed_counters(lay.num_chunks, lay.chunk, dout)
                if route == kernels.K1_FIXED else lay.num_chunks)

    def call():
        out = torch.empty((num_nodes, dout), dtype=out_dtype, device=dev)
        scratch = torch.empty(floats, device=dev)
        err = fn(msgs.data_ptr(), None if index is None else index.data_ptr(),
                 lay.local_dst.data_ptr(), lay.chunk_block.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), kernels.stream_counters(dev, counters).data_ptr(),
                 lay.num_chunks, lay.chunk, lay.row_block, dout, num_nodes, route,
                 int(bf16_out), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"K1 route {ROUTE_NAMES[route]}: CUDA error {err}")
        return out
    return call


def old_k2(fn, fl, num_nodes, x, w):
    """K2's quantum-a-CTA atomics kernel (K2's arguments before the
    redesign)."""
    _, din, dout = w.shape

    def call():
        out = torch.empty((num_nodes, dout), device=x.device)
        err = fn(x.data_ptr(), w.data_ptr(), fl.src.data_ptr(), fl.val.data_ptr(),
                 fl.local_dst.data_ptr(), fl.quantum_rel.data_ptr(), fl.chunk_block.data_ptr(),
                 out.data_ptr(), fl.quantum_rel.shape[0], din, dout, fl.row_block, fl.chunk,
                 fl.quantum, num_nodes, torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K2 variant: CUDA error {err}")
        return out
    return call


def case(label, designs, ref, k2_bf16_abs=None) -> dict:
    """The designs ``{name: call}`` held against ``ref`` and timed in turns
    (in order and back: new, old, old, new for two), with one call's kernel
    names and the bit-equality of two more launches of each."""
    designs = {name: (call, ref) for name, call in designs.items()}
    errs = {}
    if k2_bf16_abs is not None:
        # rounded messages: a message whose f32 sums straddle a bf16 rounding
        # boundary may round either way, so 2^-8 of the summed magnitudes
        # more; in_turns then holds each design to its own output
        for name, (call, _) in designs.items():
            err = (call() - ref).abs()
            bound = 1e-5 * max(1.0, ref.abs().max().item()) + 2.0 ** -8 * k2_bf16_abs
            if not bool((err <= bound).all()):
                raise RuntimeError(f"{label} {name}: past 2^-8 sum|msg| + tol")
            errs[name] = err.max().item()
        designs = {k: (c, c()) for k, (c, _) in designs.items()}
    rep = in_turns(label, designs)
    for name, err in errs.items():
        rep[name]["max_abs_err"] = err
    for name, (call, _) in designs.items():
        rep[name]["kernels"] = kernel_names(call)
        rep[name]["bit_equal"] = bit_equal(call)
    return rep


def _rand(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def compare_k1(fns, dev, am_only=False) -> dict:
    from rgcn_tpu_torch.data.synthetic import aifb_like, am_like, fb_toy_like
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import diag as dg

    rng = np.random.default_rng(22)
    report = {}

    def k1(label, m, lay, n, others, index=True, out_dtype=torch.float32):
        """The launcher (``new``) and ``others``, routes forced, at one
        shape."""
        from rgcn_tpu_torch import kernels

        if index:
            ref = agg.aggregate_sorted_plain(m, lay, n)
            new = lambda: agg.aggregate_sorted(m, lay, n, out_dtype=out_dtype)  # noqa: E731
        else:
            ref = agg.aggregate_presorted_plain(m, lay, n)
            new = lambda: agg.aggregate_presorted(m, lay, n, out_dtype)  # noqa: E731
        dout = int(m.shape[1])
        route = ROUTE_NAMES[kernels.k1_route(lay.dst_sorted)]
        designs = {"new": new}
        for name in others:
            if name != route:
                code = next(k for k, v in ROUTE_NAMES.items() if v == name)
                designs[name] = forced_k1(code, m, lay.perm if index else None, lay, n,
                                          out_dtype, fns)
        rep = case(label, designs, ref)
        rep.update(route=route, units=lay.num_chunks, dout=dout,
                   piece=kernels.k1_piece(dout, m.data_ptr(), m.element_size()))
        return rep

    every = ("atomics", "fixed", "chunk", "owned")
    if not am_only:  # nc-AIFB and lp-FB-toy
        aifb = aifb_like()
        es = build_edge_set(aifb.triples, aifb.num_nodes, aifb.num_relations, tile_size=128,
                            with_dst_layout=True).to(dev)
        m = _rand(rng, dev, es.layout.num_edges, 16) * es.val[:, None]
        n = es.num_nodes
        report["nc_aifb_d16_f32"] = k1("K1 nc-AIFB d16 f32", m, es.layout, n, every)
        report["nc_aifb_d16_f32_bf16out"] = k1("K1 nc-AIFB d16 f32 msgs, bf16 out", m, es.layout,
                                               n, every, out_dtype=BF16)
        report["nc_aifb_d16_bf16_bf16out"] = k1("K1 nc-AIFB d16 bf16 msgs, bf16 out",
                                                m.to(BF16), es.layout, n, every,
                                                out_dtype=BF16)
        del es, m

        fb = fb_toy_like()
        es = build_edge_set(fb.train, fb.num_nodes, fb.num_relations, tile_size=128,
                            with_dst_layout=True).to(dev)
        m = _rand(rng, dev, es.layout.num_edges, 500)
        report["lp_fb_toy_d500_f32"] = k1("K1 lp-FB-toy d500 f32", m, es.layout, es.num_nodes,
                                          every)
        del es, m

    am = am_like()
    es = build_edge_set(am.triples, am.num_nodes, am.num_relations, tile_size=128,
                        with_dst_layout=True).to(dev)
    lay, n = es.layout, es.num_nodes
    m = _rand(rng, dev, lay.num_edges, 10)
    for dt in (torch.float32, BF16):
        key = "bf16" if dt == BF16 else "f32"
        report[f"nc_am_perm_d10_{key}"] = k1(f"K1 nc-AM perm d10 {key}", m.to(dt), lay, n,
                                             every)
    del m
    x, dw = _rand(rng, dev, n, 32), _rand(rng, dev, es.num_rels, 32, scale=0.5)
    for key, dt in (("f32", None), ("bf16", BF16)):
        msgs = dg.diag_slot_messages(x, dw, es, compute_dtype=dt)
        report[f"nc_am_diag_d32_{key}"] = k1(f"K1 nc-AM diagonal d32 {key}", msgs, lay, n,
                                             every, index=False)
        del msgs
    return report


def compare_k2(fns, dev) -> dict:
    from rgcn_tpu_torch.data.synthetic import aifb_like, wn18_like
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import fused as fz
    from rgcn_tpu_torch.serve import load_lp_server

    rng = np.random.default_rng(2)
    report = {}

    def k2(label, fl, n, x, w, bf16=False):
        dt = BF16 if bf16 else None
        ref = fz.rel_spmm_fused_plain(fl, n, x, w, dt)
        new = lambda: fz.rel_spmm_fused(fl, n, x, w, compute_dtype=dt)  # noqa: E731
        xo, wo = (x.to(BF16), w.to(BF16)) if bf16 else (x, w)
        old = old_k2(fns[f"k2_atomics_{'bf16' if bf16 else 'f32'}"], fl, n, xo, wo)
        abs_sum = None
        if bf16:  # the plain sums of the rounded messages' magnitudes
            abs_sum = fz.rel_spmm_fused_plain(fl, n, x.to(BF16).float().abs(),
                                              w.to(BF16).float().abs())
        rep = case(label, {"new": new, "old": old}, ref, abs_sum)
        rep.update(chunks=fl.num_chunks, row_block=fl.row_block, quantum=fl.quantum,
                   w=list(w.shape))
        return rep

    aifb = aifb_like()
    es = build_edge_set(aifb.triples, aifb.num_nodes, aifb.num_relations, tile_size=128,
                        with_dst_layout=True).to(dev)
    n = es.num_nodes
    x = torch.relu(_rand(rng, dev, n, 16))
    w = _rand(rng, dev, es.num_rels, 16, aifb.num_classes, scale=0.3)
    report["nc_aifb_layer2_f32"] = k2("K2 nc-AIFB layer 2 f32", es.fused, n, x, w)
    report["nc_aifb_layer2_bf16"] = k2("K2 nc-AIFB layer 2 bf16", es.fused, n, x, w, True)
    g = _rand(rng, dev, n, aifb.num_classes)
    wt = w.transpose(1, 2).contiguous()
    report["nc_aifb_dx_f32"] = k2("K2 nc-AIFB dx f32", es.reverse.fused, n, g, wt)
    del es

    srv = load_lp_server(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "c-rgcn", "lp-WN18.yaml"), wn18_like(),
        device=dev)
    es, n = srv.edges, srv.edges.num_nodes
    del srv
    x = torch.relu(_rand(rng, dev, n, 16))
    w = _rand(rng, dev, es.num_rels, 16, 16, scale=0.25)
    report["crgcn_lp_wn18_f32"] = k2("K2 c-RGCN lp-WN18 W (36, 16, 16) f32", es.fused, n,
                                     x, w)
    return report


def phases(stamps: np.ndarray) -> dict:
    """A probe's stamps (CTAs x 8) as µs from the first CTA's start: each
    boundary's mean and latest, the CTAs that finished something and their
    finishing µs (end less counted in)."""
    t0 = stamps[:, 0].min()
    names = ("start", "staged", "walked", "zeroed", "counted_in", "end")
    out = {"ctas": int(stamps.shape[0]), "sms": int(len(np.unique(stamps[:, 6])))}
    for k, name in enumerate(names):
        got = stamps[:, k][stamps[:, k] > 0]
        if got.size:
            out[name] = {"mean_us": float((got - t0).mean() / 1e3),
                         "max_us": float((got - t0).max() / 1e3)}
    fin = stamps[:, 7] > 0
    out["finishers"] = int(fin.sum())
    if fin.any():
        d = (stamps[fin, 5] - stamps[fin, 4]) / 1e3
        out["finish_us"] = {"mean": float(d.mean()), "max": float(d.max())}
    return out


def probe(fns, dev) -> dict:
    """The new designs' phase probe at nc-AIFB (K1 d16 through perm; K2
    layer 2 and dx) and at c-RGCN lp-WN18's K2 shape."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.data.synthetic import aifb_like, wn18_like
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.serve import load_lp_server

    rng = np.random.default_rng(5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    report = {}

    def k1_probe(lay, m, n):
        units = kernels.k1_fixed_counters(lay.num_chunks, lay.chunk, m.shape[1])
        stamps = torch.zeros((units, 8), dtype=torch.int64, device=dev)
        out = torch.empty((n, m.shape[1]), device=dev)
        scratch = torch.empty(kernels.k1_scratch_floats(kernels.K1_FIXED, lay.num_chunks,
                                                        lay.chunk, lay.row_block, m.shape[1]),
                              device=dev)
        for _ in range(3):
            stamps.zero_()
            err = fns["k1_probe_f32"](
                m.data_ptr(), lay.perm.data_ptr(), lay.local_dst.data_ptr(),
                lay.chunk_block.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                kernels.stream_counters(dev, units).data_ptr(), lay.num_chunks, lay.chunk,
                lay.row_block, m.shape[1], n, kernels.K1_FIXED, 0, stamps.data_ptr(), stream)
            if err:
                raise RuntimeError(f"k1 probe: CUDA error {err}")
        return phases(stamps.cpu().numpy())

    from rgcn_tpu_torch.utils.profiling import device_split

    def k2_switches(fl, n, x, w):
        """Device ms with parts of the kernel switched off (wrong results):
        none, no messages, no row sums, neither, no row stores."""
        out = torch.empty((n, w.shape[2]), device=dev)
        part = torch.empty(kernels.chunk_scratch_floats(fl.num_chunks, fl.row_block,
                                                        w.shape[2]), device=dev)
        times = {}
        for cfg, name in ((0, "all"), (1, "no_messages"), (2, "no_row_sums"),
                          (3, "no_messages_no_row_sums"), (4, "no_row_stores")):
            def call(cfg=cfg):
                err = fns["k2_switches_f32"](
                    x.data_ptr(), w.data_ptr(), fl.src.data_ptr(), fl.val.data_ptr(),
                    fl.local_dst.data_ptr(), fl.quantum_rel.data_ptr(),
                    fl.chunk_block.data_ptr(), out.data_ptr(), part.data_ptr(),
                    kernels.stream_counters(dev, fl.num_chunks).data_ptr(),
                    fl.quantum_rel.shape[0], w.shape[1], w.shape[2], fl.row_block, fl.chunk,
                    fl.quantum, n, cfg, stream)
                if err:
                    raise RuntimeError(f"k2 switches {cfg}: CUDA error {err}")
            times[name] = device_split(call, 20)["ms"]
        return times

    def k2_probe(fl, n, x, w):
        report[f"switches_{len(report)}"] = k2_switches(fl, n, x, w)
        stamps = torch.zeros((fl.num_chunks, 8), dtype=torch.int64, device=dev)
        out = torch.empty((n, w.shape[2]), device=dev)
        part = torch.empty(kernels.chunk_scratch_floats(fl.num_chunks, fl.row_block,
                                                        w.shape[2]), device=dev)
        for _ in range(3):
            stamps.zero_()
            err = fns["k2_probe_f32"](
                x.data_ptr(), w.data_ptr(), fl.src.data_ptr(), fl.val.data_ptr(),
                fl.local_dst.data_ptr(), fl.quantum_rel.data_ptr(), fl.chunk_block.data_ptr(),
                out.data_ptr(), part.data_ptr(), kernels.stream_counters(dev, fl.num_chunks)
                .data_ptr(), fl.quantum_rel.shape[0], w.shape[1], w.shape[2], fl.row_block,
                fl.chunk, fl.quantum, n, stamps.data_ptr(), stream)
            if err:
                raise RuntimeError(f"k2 probe: CUDA error {err}")
        return phases(stamps.cpu().numpy())

    aifb = aifb_like()
    es = build_edge_set(aifb.triples, aifb.num_nodes, aifb.num_relations, tile_size=128,
                        with_dst_layout=True).to(dev)
    n = es.num_nodes
    report["k1_nc_aifb_d16"] = k1_probe(es.layout, _rand(rng, dev, es.layout.num_edges, 16), n)
    x = torch.relu(_rand(rng, dev, n, 16))
    w = _rand(rng, dev, es.num_rels, 16, aifb.num_classes, scale=0.3)
    report["k2_nc_aifb_layer2"] = k2_probe(es.fused, n, x, w)
    report["k2_nc_aifb_dx"] = k2_probe(es.reverse.fused, n,
                                       _rand(rng, dev, n, aifb.num_classes),
                                       w.transpose(1, 2).contiguous())
    srv = load_lp_server(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "c-rgcn", "lp-WN18.yaml"), wn18_like(),
        device=dev)
    ces, n = srv.edges, srv.edges.num_nodes
    del srv
    report["k2_crgcn_lp_wn18"] = k2_probe(ces.fused, n, torch.relu(_rand(rng, dev, n, 16)),
                                          _rand(rng, dev, ces.num_rels, 16, 16, scale=0.25))
    for key, rep in report.items():
        print(f"probe {key}: {json.dumps(rep)}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON report here")
    ap.add_argument("--probe", action="store_true",
                    help="the new designs' per-CTA phase probe instead")
    ap.add_argument("--am", action="store_true",
                    help="K1 at nc-AM's shapes only (the pair path, the diagonal)")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    fns, ptxas = build_variants()
    print(ptxas, flush=True)
    if args.probe:
        report = {"card": card(), "probe": probe(fns, dev)}
    else:
        report = {"card": card(), "k1": compare_k1(fns, dev, args.am)}
        if not args.am:
            report["k2"] = compare_k2(fns, dev)
    line = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return report


if __name__ == "__main__":
    main()
