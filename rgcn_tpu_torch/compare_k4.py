"""K4's fixed-order kernel against the design it replaced, both forms, on the card.

    python -m rgcn_tpu_torch.compare_k4 [--out PATH] [--quick]

Both K4 launchers (``kernels/csrc/k4_weighted_aggregate.cu`` for f32
tables, ``k4_weighted_aggregate_bf16.cu`` for bf16 tables) run the
owned-row kernel of ``k4_owned.cuh`` on every layout: the
destination-sorted frame read as it is, each destination's slots summed
in slot order, the rows several CTAs share finished by the last of them
from f32 parts in unit order, one launch, the same bits on every launch.
This script times each against the design it replaced,
``weighted_runs.cuh`` (``kernels/csrc/variants/k4_weighted_runs.cu``: a
counting sort of each chunk with shared-memory atomics, the rows two
chunks share zeroed before and finished with f32 atomics, in no fixed
order), in turns, at the shapes the model paths run, each at its model's
size (seeded random tables and weights), with f32 and bf16 tables:

* lp-WN18 (``wn18_like()``, the merged frame): the forward's Agg (x
  (40,943, 200), 2 bases; bf16 tables with a bf16 and an f32 output) and
  the basis VJP's dx (per-basis G (2, 40,943, 200), ``sum_bases``);
* the structured decoder's two corrupted-entity sums at lp-WN18's batch
  (30,000 positives, 10 negatives each, the [q ; k ; nodes] table, width
  200, 1,492 chunks) and at lp-FB-toy's (300 positives of
  ``fb_toy_like()``, width 500);
* nc-AIFB with 4 bases (``aifb_like()``, hidden 16) and nc-AM with 4
  bases at AM scale (``am_like()``, hidden 10: 8-byte pieces of f32,
  4-byte pieces of bf16): the featureless layer and layer 2's Agg (and
  nc-AIFB's dx and dbases over its merged frames).

Each design is held against the plain version's f32 sums (as
``compare_k4_bf16``) and timed by torch.profiler over 50 calls, launcher
then old design then back; each shape has its bound (bytes at 3.35 TB/s).
The launcher is also called twice more and must give the same bits. Prints
the card's name and power limit, a line a shape, then one JSON line (also
written to ``--out``). ``--quick`` takes lp-WN18's shapes only.

Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from rgcn_tpu_torch import compare_k4_bf16 as base
from rgcn_tpu_torch.compare_k2 import card
from rgcn_tpu_torch.device import resolve_device


# the shape comparison the shape builders call, before main() wraps it
_COMPARE = base.compare_shape


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def compare_repeat(fns, label, x, src, w, layout, num_nodes, sum_bases, out_dtype) -> dict:
    """``compare_k4_bf16.compare_shape`` (the launcher and the old design in
    turns), then two more launcher calls held bit for bit."""
    from rgcn_tpu_torch.ops import basis as bs

    for attempt in range(3):  # a profile that keeps losing records: the shape again
        try:
            rep = _COMPARE(fns, label, x, src, w, layout, num_nodes, sum_bases, out_dtype)
            break
        except RuntimeError as e:
            if "lost kernel records" not in str(e) or attempt == 2:
                raise
            print(f"  {label}: {e}; timing the shape again", flush=True)
    a, b = (bs.weighted_aggregate(x, src, w, layout, num_nodes, sum_bases=sum_bases,
                                  out_dtype=out_dtype) for _ in range(2))
    rep["bits_equal"] = bool(torch.equal(_bits(a), _bits(b)))
    if not rep["bits_equal"]:
        raise RuntimeError(f"{label}: two launcher calls gave different bits")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON report here")
    ap.add_argument("--quick", action="store_true", help="lp-WN18's shapes only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_k4 times kernels on the card: CUDA is not available")
    from rgcn_tpu_torch.data.synthetic import fb_toy_like

    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    base.ROUTES_ONLY = True
    base.compare_shape = compare_repeat
    try:
        fns, ptxas = base.build_variants()
        print(ptxas, flush=True)
        report = {"card": card()}
        for table, form in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            report[f"lp_{form}"] = base.lp_shapes(fns, dev, table)
            if args.quick:
                continue
            report[f"decoder_{form}"] = base.decoder_shapes(fns, dev, table)
            report[f"decoder_fb_{form}"] = base.decoder_shapes(
                fns, dev, table, data=fb_toy_like(), d=500, p=300, ns=10, name="decoder_fb")
            report[f"nc_{form}"] = base.nc_shapes(fns, dev, table)
    finally:
        base.ROUTES_ONLY = False
        base.compare_shape = _COMPARE
    line = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return report


if __name__ == "__main__":
    main()
