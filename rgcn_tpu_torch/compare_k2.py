"""K2 against the designs it was chosen over, on the card.

    python -m rgcn_tpu_torch.compare_k2

K2 (``kernels/csrc/k2_fused.cu``) gives each chunk a CTA that stages its
slots' messages in shared memory, sums each row's in slot order and
finishes a row block's chunks by their last CTA in chunk order. Two designs
it replaced or beat are built here and launched nowhere else, both with
K2's arguments before its redesign (:data:`OLD_K2_ARGS`):
``kernels/csrc/variants/k2_atomics.cu`` gives each relation quantum a CTA
and adds every real slot's outputs straight into a memset output with
global f32 atomics; ``kernels/csrc/variants/k2_fused_tile.cu`` gives each
chunk a CTA that sums its slots into a shared-memory (RB x dout) tile with
shared atomics and then adds the tile's non-zero entries to the output;
both compute the per-slot product with the atomics design's own code.

All run at the nc-AIFB layer-2 shapes (``aifb_like()``, x (N, 16), W
(90, 16, 4), the fused layout ``load_nc_server`` builds), are held against
``rel_spmm_fused_plain`` (max abs diff <= 1e-5 * max(1, max|ref|)), and are
timed in the order K2, atomics, tile, tile, atomics, K2: device time per
call, any memset included, summed over the kernels torch.profiler records
for 20 calls (``profile_serve.profile_calls``). Prints the card's name and
power limit (``nvidia-smi``), the variants' ptxas reports, then one JSON
line.

Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from rgcn_tpu_torch.device import resolve_device

VARIANT = os.path.join("variants", "k2_fused_tile.cu")
ATOMICS = os.path.join("variants", "k2_atomics.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
# K2's C arguments before its fixed-order redesign: (x, w, src, val,
# local_dst, quantum_rel, chunk_block, out, n_quanta, din, dout, row_block,
# chunk, quantum, num_nodes, stream), as the variants take them
OLD_K2_ARGS = [_P] * 8 + [_I] * 7 + [_P]


def _build(source: str, symbol: str):
    from rgcn_tpu_torch.kernels.build import build_variant

    path, ptxas = build_variant(source)
    fn = getattr(ctypes.CDLL(path), symbol)
    fn.argtypes = OLD_K2_ARGS
    fn.restype = ctypes.c_int
    return fn, ptxas


def build_tile():
    """nvcc the tile variant (always afresh: it includes k2_atomics.cu) and
    bind it; returns (function, ptxas report)."""
    return _build(VARIANT, "k2_fused_tile")


def build_atomics():
    """nvcc the quantum-a-CTA atomics design and bind it; returns
    (function, ptxas report)."""
    return _build(ATOMICS, "k2_atomics_f32")


def tile_call(fn, layout, num_nodes, x, weights):
    """A variant (K2's arguments before its redesign) on K2's operands;
    returns ``(num_nodes, dout)``."""
    _, din, dout = weights.shape
    out = torch.empty((num_nodes, dout), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), weights.data_ptr(), layout.src.data_ptr(),
             layout.val.data_ptr(), layout.local_dst.data_ptr(),
             layout.quantum_rel.data_ptr(), layout.chunk_block.data_ptr(),
             out.data_ptr(), layout.quantum_rel.shape[0], din, dout,
             layout.row_block, layout.chunk, layout.quantum, num_nodes,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 variant: CUDA error {err} at launch")
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip()


def compare(designs: dict, order, ref: torch.Tensor) -> dict:
    """Hold each of ``designs`` (name -> call) against ``ref`` (max abs
    diff <= 1e-5 * max(1, max|ref|), else raise), then take each one's
    device ms per call (``profile_calls``) in ``order``; returns ``{name:
    {"max_abs_err", "tol", "device_ms": [...], "kernels_us": {...}}}``, the
    last with the per-kernel split of the design's last profile."""
    from rgcn_tpu_torch.profile_serve import profile_calls

    tol = 1e-5 * max(1.0, ref.abs().max().item())
    report = {}
    for name, call in designs.items():
        err = (call() - ref).abs().max().item()
        if not err <= tol:
            raise RuntimeError(f"{name}: max abs err {err} > {tol}")
        report[name] = {"max_abs_err": err, "tol": tol, "device_ms": []}
    for name in order:
        prof = profile_calls(designs[name])
        report[name]["device_ms"].append(sum(prof["kernels_us"].values()) / 1e3)
        report[name]["kernels_us"] = prof["kernels_us"]
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    dev = resolve_device(None)

    from rgcn_tpu_torch.data.synthetic import aifb_like
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import fused as fz

    print(card(), flush=True)
    fn, ptxas = build_tile()
    atomics, ptxas_atomics = build_atomics()
    print(ptxas.strip() + "\n" + ptxas_atomics.strip(), flush=True)

    data = aifb_like()
    edges = build_edge_set(data.triples, data.num_nodes, data.num_relations,
                           tile_size=128, with_dst_layout=True).to(dev)
    fl, n = edges.fused, data.num_nodes
    rng = np.random.default_rng(0)
    x = torch.relu(torch.from_numpy(
        rng.standard_normal((n, 16)).astype(np.float32)).to(dev))
    w = torch.from_numpy((rng.standard_normal((edges.num_rels, 16, data.num_classes))
                          * 0.3).astype(np.float32)).to(dev)
    designs = {
        "k2_fixed_order": lambda: fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None),
        "k2_global_atomics": lambda: tile_call(atomics, fl, n, x, w),
        "k2_shared_tile": lambda: tile_call(fn, fl, n, x, w),
    }
    order = list(designs) + list(designs)[::-1]
    report = compare(designs, order, fz.rel_spmm_fused_plain(fl, n, x, w))
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "shapes": {"x": list(x.shape), "w": list(w.shape),
                                 "slots": fl.src.shape[0], "chunks": fl.num_chunks,
                                 "quanta": fl.quantum_rel.shape[0]},
                      "designs": report}), flush=True)


if __name__ == "__main__":
    main()
