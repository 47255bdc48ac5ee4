"""K4's bf16 form against the designs it was chosen over, on the card.

    python -m rgcn_tpu_torch.compare_k4_bf16 [--out PATH] [--quick]

K4's bf16 launcher (``kernels/csrc/k4_weighted_aggregate_bf16.cu``) runs
the owned-row kernel of ``k4_owned.cuh``: the destination-sorted
frame read as it is, a CTA a unit of ``span`` slots, each thread's next
rows in flight in a ring of cp.async copies, rows held whole stored once,
the runs that cross a unit boundary finished by the last of their units to
count in on a counter. Beside it, this script times:

* the form the owned-row kernel replaced, ``weighted_runs.cuh`` with a
  bf16 table (a counting sort of each chunk, the rows two chunks share
  finished with atomics in no fixed order; three launches for a bf16
  output, with an f32 scratch of the output's shape), kept for the
  comparisons in ``kernels/csrc/variants/k4_weighted_runs.cu``;
* ``k4_bf16_variant`` (``kernels/csrc/variants/k4_bf16_forms.cu``, for
  this comparison only): the owned-row kernel with one of the launcher's
  choices changed (``OWNED_VARIANTS``: plain output stores in place of
  evict-first ones; 16 or 4 row vectors in flight a thread in place of 8;
  the rows in flight in a register ring in place of the copy ring; copies
  through L2 only in place of L1; the zero rows stored before or after the
  walk whatever the output type; CTAs of 128 or 64 threads), for 16-byte
  columns and 1, 2 or 4 bases.

The launcher itself is also called with units of part of a chunk
(``owned_span128``, ``64``, ``32``: ``SPANS``). Every K4 bf16 shape a model path runs is taken, each
at its model's size (seeded random tables and weights):

* lp-WN18 (``wn18_like()``, the merged frame ``load_lp_server`` builds):
  the forward's Agg (x (40,943, 200), 2 bases, bf16 out), the same with an
  f32 output, and the basis VJP's dx (per-basis G (2, 40,943, 200) over the
  merged reverse frame, ``sum_bases``, bf16 out);
* the structured decoder's backward under ``decoder.bwd_dtype`` (30,000
  positives, 10 negatives each, the [q ; k ; nodes] bf16 table, one basis,
  f32 out): its two sums over the corrupted entities' layout;
* nc-AIFB with 4 bases (``aifb_like()``, hidden 16): the featureless layer
  (per-basis (4, N, 16), ``sum_bases``, f32 out) and its ``dbases``
  (shared g, 4 outputs, f32 out) over the destination layouts, layer 2's
  Agg (bf16 out) and dx over the merged frames;
* nc-AM with 4 bases at AM scale (``am_like()``, hidden 10: scalar columns):
  the featureless layer and layer 2's Agg over the destination layout.

Each design is held against the plain version's f32 sums (f32 out within
1e-5 * max(1, max|ref|), a bf16 output within 2^-8 * |ref| more) and timed
in turns (launcher, old form, the variants, span 128, then back): device
time per call from torch.profiler over 50 calls
(``utils/profiling.device_split``), with the per-kernel split. Each shape
has its bound (bytes at 3.35 TB/s: the real slots' indices and weights,
the layout, each distinct source row once, the output once). Prints the
card's name and power limit, the variants' ptxas report, a line a shape,
then one JSON line (also written to ``--out``). ``--quick`` takes the
lp-WN18 shapes only.

Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

from rgcn_tpu_torch.compare_k1_k5 import in_turns
from rgcn_tpu_torch.compare_k2 import card
from rgcn_tpu_torch.device import resolve_device

_P, _I = ctypes.c_void_p, ctypes.c_int
FORMS = os.path.join("variants", "k4_bf16_forms.cu")
RUNS = os.path.join("variants", "k4_weighted_runs.cu")
# variant symbol -> (source under csrc/, ctypes argument types): the
# launcher's
VARIANTS = {
    # the launcher's arguments, then the variant before the stream
    "k4_bf16_variant": (FORMS, [_P] * 8 + [_I] * 12 + [_P]),
    # the launcher's arguments, then the stamps before the stream
    "k4_bf16_probe": (FORMS, [_P] * 8 + [_I] * 11 + [_P, _P]),
    # the design the launchers replaced: (x, src, w, local_dst, chunk_block,
    # out, scratch, n_chunks, ..., out_bf16, stream)
    "k4_runs_f32": (RUNS, [_P] * 7 + [_I] * 10 + [_P]),
    "k4_runs_bf16": (RUNS, [_P] * 7 + [_I] * 10 + [_P]),
}
# the design the launchers replaced, by the table's dtype
RUNS_FN = {torch.float32: "k4_runs_f32", torch.bfloat16: "k4_runs_bf16"}
ROUTES_ONLY = False  # the launcher and the design it replaced only (compare_k4)
# k4_bf16_variant's variants: the launcher's choices (k4o::Launcher) with one
# changed
OWNED_VARIANTS = {"plain_stores": (0, 256), "flight16": (1, 256), "flight4": (2, 256),
                  "register_ring": (3, 256), "l2_copies": (4, 256), "zero_rows_early": (5, 256),
                  "zero_rows_late": (6, 256), "cta128": (7, 128), "cta64": (8, 64)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
SPANS = (128,)  # the launcher's kernel over units of part of a chunk
STAMPS_DIR = None  # --stamps: where each probe's per-CTA stamps are saved
DIAG = False  # --uniform-src: lp-WN18's Agg also with uniformly drawn source rows


def build_variants():
    """nvcc the variants; returns ({symbol: function}, ptxas report)."""
    from rgcn_tpu_torch.kernels.build import build_variant

    libs, logs = {}, []
    for source in ((RUNS,) if ROUTES_ONLY else (FORMS, RUNS)):
        path, log = build_variant(source)
        libs[source] = ctypes.CDLL(path)
        logs.append(log.strip())
    fns = {}
    for name, (source, argtypes) in VARIANTS.items():
        if source not in libs:
            continue
        fn = getattr(libs[source], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    if FORMS in libs:
        occ = libs[FORMS].k4_bf16_blocks_per_sm
        occ.argtypes, occ.restype = [_I] * 5, ctypes.c_int
        fns["k4_bf16_blocks_per_sm"] = occ
    return fns, "\n".join(logs)


def k4_call(fn, x, src, w, layout, num_nodes, sum_bases, out_dtype, span, old=False,
            variant=None):
    """One K4 call through the C function ``fn`` with the launcher's
    arguments: the owned-row kernel's scratch (two rows a unit) and
    counters, or with ``old`` the arguments of variants/k4_weighted_runs.cu
    (a scratch of the output's shape for a bf16 output); ``variant`` for
    k4_bf16_variant."""
    from rgcn_tpu_torch import kernels

    nb = w.shape[0]
    per_basis = x.dim() == 3
    din, rows = x.shape[-1], x.shape[-2]
    nb_out = 1 if sum_bases else nb
    n_chunks, chunk = layout.local_dst.shape
    bf16_out = out_dtype == torch.bfloat16
    dev = x.device

    def call():
        out = torch.empty((num_nodes, nb_out, din), dtype=out_dtype, device=dev)
        if old:
            scratch = torch.empty((num_nodes, nb_out, din), dtype=torch.float32,
                                  device=dev) if bf16_out else None
        else:
            scratch = torch.empty(kernels.k4_scratch_floats(
                n_chunks, chunk, kernels.k4_row_floats(nb_out, din, x.element_size()), span),
                dtype=torch.float32, device=dev)
        new = () if old else (kernels.stream_counters(
            dev, kernels.k4_units(n_chunks, chunk, span)).data_ptr(),)
        err = fn(x.data_ptr(), src.data_ptr(), w.data_ptr(), layout.local_dst.data_ptr(),
                 layout.chunk_block.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), *new,
                 n_chunks, chunk, layout.row_block, nb, din, rows, num_nodes, int(per_basis),
                 int(sum_bases), int(bf16_out), *(() if old else (span,)),
                 *(() if variant is None else (variant,)),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"K4 design: CUDA error {err}")
        return out.permute(1, 0, 2)
    return call


def probe(fns, label, x, src, w, layout, num_nodes, sum_bases, out_dtype,
          span=None) -> dict:
    """The launcher's kernel with its CTAs' phase times (%globaltimer, ns)
    and SMs: per phase (staging, zero rows, walk and merge, counting in on
    the split runs, finishing them) the mean, median, 90th percentile and
    maximum over the CTAs; the spread of the CTAs' start times; the most
    CTAs an SM ran at once; and the occupancy the runtime reports."""
    from rgcn_tpu_torch import kernels

    span = span or kernels.K4_SPAN
    n_chunks, chunk = layout.local_dst.shape
    units = kernels.k4_units(n_chunks, chunk, span)
    stamps = torch.zeros((units, 8), dtype=torch.int64, device=x.device)
    fn = fns["k4_bf16_probe"]
    call = k4_call(lambda *args: fn(*args[:-1], stamps.data_ptr(), args[-1]), x, src, w,
                   layout, num_nodes, sum_bases, out_dtype, span)
    for _ in range(3):  # warm: the last call's stamps are kept
        call()
    torch.cuda.synchronize()
    st = stamps.cpu().numpy().astype(np.float64)
    if STAMPS_DIR:
        os.makedirs(STAMPS_DIR, exist_ok=True)
        np.save(os.path.join(STAMPS_DIR, label.replace(" ", "_") + ".npy"), st)
    t0 = st[:, 0] - st[:, 0].min()
    early = st[:, 6] > 0  # the zero rows stored before the walk
    walk_from = np.where(early, st[:, 6], st[:, 1])
    phases = {"staging": st[:, 1] - st[:, 0],
              "zero_rows": np.where(early, st[:, 6] - st[:, 1], st[:, 3] - st[:, 2]),
              "walk": st[:, 2] - walk_from, "count_in": st[:, 4] - st[:, 3],
              "finish": st[:, 5] - st[:, 4], "cta": st[:, 5] - st[:, 0]}
    rep = {k: {"mean_us": float(v.mean() / 1e3), "p50_us": float(np.median(v) / 1e3),
               "p90_us": float(np.percentile(v, 90) / 1e3), "max_us": float(v.max() / 1e3)}
           for k, v in phases.items()}
    rep["kernel_us"] = float((st[:, 5].max() - st[:, 0].min()) / 1e3)
    rep["start_us"] = {q: float(np.percentile(t0, q) / 1e3) for q in (50, 90, 100)}
    most = 0
    for sm in np.unique(st[:, 7]):
        ev = sorted([(a, 1) for a in st[st[:, 7] == sm, 0]] +
                    [(b, -1) for b in st[st[:, 7] == sm, 5]], key=lambda t: (t[0], t[1]))
        live = 0
        for _, d in ev:
            live += d
            most = max(most, live)
    rep["most_ctas_on_an_sm"] = most
    rep["sms"] = int(len(np.unique(st[:, 7])))
    rep["blocks_per_sm"] = int(fns["k4_bf16_blocks_per_sm"](
        int(w.shape[0]), int(x.dim() == 3), int(out_dtype == torch.bfloat16), span,
        layout.row_block))
    rep["span"] = span
    slowest = int(np.argmax(phases["cta"]))
    rep["slowest_cta"] = {"unit": slowest, **{k: float(v[slowest] / 1e3)
                                              for k, v in phases.items()}}
    print(f"  probe {label}: {json.dumps(rep)}", flush=True)
    return rep


def bound_ms(x, src, w, layout, out_elems, out_dtype) -> float:
    """Bytes the function must move at 3.35 TB/s: each real slot's source
    index and nb weights, the layout, each distinct source row once (nb rows
    for per-basis tables), the output once."""
    keep = layout.local_dst.reshape(-1) < layout.row_block
    real = int(keep.sum().item())
    n_rows = int(torch.unique(src[keep]).numel())
    tables = x.shape[0] if x.dim() == 3 else 1
    nbytes = (real * (4 + 4 * w.shape[0]) + 4 * layout.local_dst.numel()
              + 4 * layout.chunk_block.numel() + tables * n_rows * x.shape[-1] * x.element_size()
              + out_elems * (2 if out_dtype == torch.bfloat16 else 4))
    return nbytes / HBM_BYTES_PER_S * 1e3


def compare_shape(fns, label, x, src, w, layout, num_nodes, sum_bases, out_dtype) -> dict:
    """The launcher and the other designs at one shape, in turns."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.ops import basis as bs

    ref = bs.weighted_aggregate_plain(x, src, w, layout, num_nodes, sum_bases=sum_bases)
    launcher = lambda: bs.weighted_aggregate(  # noqa: E731
        x, src, w, layout, num_nodes, sum_bases=sum_bases, out_dtype=out_dtype)
    bf16 = x.dtype == torch.bfloat16
    owned = kernels._fn("k4_weighted_aggregate" + ("_bf16" if bf16 else ""))
    designs = {
        "launcher": (launcher, ref),
        "weighted_runs": (k4_call(fns[RUNS_FN[x.dtype]], x, src, w, layout, num_nodes,
                                  sum_bases, out_dtype, kernels.K4_SPAN, old=True), ref),
    }
    full = bf16 and x.shape[-1] % 8 == 0 and not ROUTES_ONLY
    if full and w.shape[0] in (1, 2, 4):  # the variants' shapes
        for name, (variant, span) in OWNED_VARIANTS.items():
            designs[name] = (k4_call(fns["k4_bf16_variant"], x, src, w, layout, num_nodes,
                                     sum_bases, out_dtype, span, variant=variant), ref)
    for span in SPANS:
        if span < layout.chunk and full:
            designs[f"owned_span{span}"] = (k4_call(owned, x, src, w, layout, num_nodes,
                                                    sum_bases, out_dtype, span), ref)
    rep = in_turns(label, designs)
    if full and w.shape[0] in (1, 2, 4):
        rep["probe"] = probe(fns, label, x, src, w, layout, num_nodes, sum_bases, out_dtype)
        if layout.chunk > 64:
            rep["probe_span64"] = probe(fns, label + " span 64", x, src, w, layout,
                                        num_nodes, sum_bases, out_dtype, span=64)
    counters = kernels.stream_counters(x.device, 1)
    if int(counters.count_nonzero().item()):
        raise RuntimeError(f"{label}: a design left split-run counters set")
    nb_out = 1 if sum_bases else w.shape[0]
    rep["bound_ms"] = bound_ms(x, src, w, layout, num_nodes * nb_out * x.shape[-1], out_dtype)
    rep["shape"] = {"x": list(x.shape), "table": "bf16" if bf16 else "f32",
                    "nb": int(w.shape[0]), "sum_bases": bool(sum_bases),
                    "out": "bf16" if out_dtype == torch.bfloat16 else "f32",
                    "slots": layout.num_chunks * layout.chunk,
                    "real": int((layout.local_dst < layout.row_block).sum().item()),
                    "chunks": layout.num_chunks, "row_block": layout.row_block}
    print(f"  {label}: bound {rep['bound_ms']:.5f} ms, {json.dumps(rep['shape'])}", flush=True)
    return rep


def _rand(rng, dev, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)


def lp_shapes(fns, dev, table=torch.bfloat16) -> dict:
    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import basis as bs

    bf16 = torch.bfloat16
    lp = wn18_like()
    es = build_edge_set(lp.train, lp.num_nodes, lp.num_relations, tile_size=128,
                        with_dst_layout=True, with_merged_layout=True).to(dev)
    m = es.merged
    n, din, nb = m.num_nodes, 200, 2
    rng = np.random.default_rng(21)
    comps = _rand(rng, dev, m.num_rels, nb, scale=0.3)
    xb = torch.relu(_rand(rng, dev, n, din)).to(table)
    w = bs.merged_wvec(m.coeff, comps)
    form = "bf16" if table == bf16 else "f32"
    outs = (("lp_wn18_agg", bf16), ("lp_wn18_agg_f32out", torch.float32)) if table == bf16 \
        else (("lp_wn18_agg", torch.float32),)
    report = {}
    for key, out_dtype in outs:
        report[key] = compare_shape(fns, f"K4 {form} {key}", xb, m.src_sorted, w, m.layout, n,
                                    False, out_dtype)
    if DIAG:  # the same frame with its source rows drawn uniformly: no hot rows
        rsrc = torch.from_numpy(rng.integers(0, n, m.src_sorted.shape[0]).astype(np.int32))
        report["lp_wn18_agg_uniform_src"] = compare_shape(
            fns, "K4 bf16 lp_wn18_agg_uniform_src", xb, rsrc.to(dev), w, m.layout, n, False,
            bf16)
    G = _rand(rng, dev, nb, n, din, scale=0.1).to(table)
    report["lp_wn18_dx"] = compare_shape(
        fns, f"K4 {form} lp_wn18_dx", G, m.rev_src_sorted, bs.merged_wvec(m.rev_coeff, comps),
        m.rev_layout, n, True, table)
    del G, xb
    return report


def decoder_shapes(fns, dev, table=torch.bfloat16, data=None, d=200, p=30_000, ns=10,
                   name="decoder") -> dict:
    """The structured decoder's two K4 sums (in bf16 under
    decoder.bwd_dtype) at an LP config's training batch, by default
    lp-WN18's."""
    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.ops.distmult_train import build_structured_layouts

    lp = data or wn18_like()
    n = lp.num_nodes
    rng = np.random.default_rng(22)
    train = np.asarray(lp.train)
    positives = train[rng.choice(len(train), p, replace=False)]
    corrupt_ent = rng.integers(0, n, p * ns)
    corrupt_head = rng.random(p * ns) < 0.5
    c_lay, _, _, (ce_sorted, qk_idx) = build_structured_layouts(
        positives, corrupt_ent, corrupt_head, n)
    c_lay = c_lay.to(dev)
    rows_t = _rand(rng, dev, 2 * p + n, d, scale=0.5).to(table)
    slots = c_lay.num_chunks * c_lay.chunk
    real = (c_lay.local_dst.reshape(-1) < c_lay.row_block)
    form = "bf16" if table == torch.bfloat16 else "f32"
    report = {}
    for key, rows in ((f"{name}_qk", qk_idx), (f"{name}_ce", ce_sorted + 2 * p)):
        idx = torch.as_tensor(np.asarray(rows), dtype=torch.int32, device=dev)
        wv = (_rand(rng, dev, 1, slots) * real)
        report[key] = compare_shape(fns, f"K4 {form} {key}", rows_t, idx, wv, c_lay, n, False,
                                    torch.float32)
    return report


def nc_shapes(fns, dev, table=torch.bfloat16, keys=("nc_aifb4", "nc_am4")) -> dict:
    from rgcn_tpu_torch.data.synthetic import aifb_like, am_like
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import basis as bs

    bf16 = torch.bfloat16
    nb = 4
    rng = np.random.default_rng(23)
    report = {}
    form = "bf16" if table == bf16 else "f32"
    small = table == torch.float32  # an f32 table's Agg and dx are f32
    for key, make, hidden, merged in (("nc_aifb4", aifb_like, 16, True),
                                      ("nc_am4", am_like, 10, False)):
        if key not in keys:
            continue
        data = make()
        es = build_edge_set(data.triples, data.num_nodes, data.num_relations, tile_size=128,
                            with_dst_layout=True, with_merged_layout=merged).to(dev)
        n = es.num_nodes
        comps = _rand(rng, dev, es.num_rels, nb, scale=0.3)
        src_sorted, wvec = bs.sorted_inputs(es, comps)
        bases = _rand(rng, dev, nb, n, hidden, scale=0.3).to(table)
        report[f"{key}_featureless"] = compare_shape(
            fns, f"K4 {form} {key} featureless", bases, src_sorted, wvec, es.layout, n, True,
            torch.float32)
        del bases
        x = torch.relu(_rand(rng, dev, n, hidden)).to(table)
        out = torch.float32 if small else bf16
        if merged:
            m = es.merged
            report[f"{key}_agg"] = compare_shape(
                fns, f"K4 {form} {key} layer-2 Agg", x, m.src_sorted,
                bs.merged_wvec(m.coeff, comps), m.layout, n, False, out)
            G = _rand(rng, dev, nb, n, hidden, scale=0.1).to(table)
            report[f"{key}_dx"] = compare_shape(
                fns, f"K4 {form} {key} layer-2 dx", G, m.rev_src_sorted,
                bs.merged_wvec(m.rev_coeff, comps), m.rev_layout, n, True, out)
            rsrc, rwvec = bs.sorted_inputs(es.reverse, comps)
            report[f"{key}_dbases"] = compare_shape(
                fns, f"K4 {form} {key} featureless dbases", x, rsrc, rwvec, es.reverse.layout,
                n, False, torch.float32)
        else:
            report[f"{key}_agg"] = compare_shape(
                fns, f"K4 {form} {key} layer-2 Agg", x, src_sorted, wvec, es.layout, n, False,
                out)
        del es, x
        torch.cuda.empty_cache()
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON report here")
    ap.add_argument("--quick", action="store_true", help="the lp-WN18 shapes only")
    ap.add_argument("--uniform-src", action="store_true",
                    help="also time lp-WN18's Agg with its source rows drawn uniformly")
    ap.add_argument("--stamps", default=None,
                    help="save each probe's per-CTA stamps (.npy) in this directory")
    args = ap.parse_args(argv)
    global STAMPS_DIR, DIAG
    STAMPS_DIR, DIAG = args.stamps, args.uniform_src
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    fns, ptxas = build_variants()
    print(ptxas, flush=True)
    report = {"card": card(), "lp": lp_shapes(fns, dev)}
    if not args.quick:
        report["decoder"] = decoder_shapes(fns, dev)
        report["nc"] = nc_shapes(fns, dev)
    line = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return report


if __name__ == "__main__":
    main()
