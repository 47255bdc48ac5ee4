// K4: weighted destination aggregation with the source-row gather inside,
// for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_basis.py::weighted_aggregate_pallas. Over a
// destination-sorted chunk layout (DstLayout, or the merged pair frame's)
// it computes, for every basis b < nb,
//     agg[n, b] = sum over slots l with destination n of w[b, l] * row(b, l)
// where slot l of chunk c targets node chunk_block[c] * RB + local_dst[l]
// (local_dst == RB marks a pad, skipped before anything else of the slot is
// read) and row(b, l) = x[src[l]] for a shared (rows, din) table, or
// x[b, src[l]] for per-basis (nb, rows, din) tables. With sum_bases the nb
// products are summed into one output, agg[n, 0]. The output is node-major,
// (num_nodes, nb or 1, din): the encode's closing product reads it as one
// (N, nb * din) matrix.
//
// Bound on the H100: bytes. One multiply-add per (real slot, basis,
// column) against a row of din floats read per slot: 2 * nb flops per 4
// bytes, far below the f32 ridge. At lp-WN18 (95,479 real slots, din 200,
// nb 2) the card must read the table rows the slots reference and write
// the whole output once: 83 MB, 24.8 us at 3.35 TB/s, of which the output
// write is 19.6 us.
//
// Design: the owned-row kernel of k4_owned.cuh with f32 rows (16-byte
// vectors of 4 values, or 8- and 4-byte pieces where din % 4 != 0 or the
// table is not 16-byte aligned), as the TPU kernel carries each row
// block's sum in VMEM from chunk to chunk in a sequential grid: the sorted
// frame read as it is, each destination's slots summed in slot order, every
// output row stored once, the runs that cross a unit boundary finished in
// the same launch by their last unit from f32 parts in ``scratch`` (two
// rows a unit of ``span`` slots) on ``counters`` (one a unit, zero on entry,
// left zero). One launch, no memset, no atomics on the output: the same
// bits on every launch. The hub blocks (24 chunks against a median of 1 at
// lp-WN18) are spread over as many CTAs as they have units.

#include "k4_owned.cuh"

// The parameters are the bf16 form's (k4_weighted_aggregate_bf16.cu), so one
// argument list binds both: out_bf16 must be 0.
extern "C" int k4_weighted_aggregate(const float* x, const int* src, const float* w,
                                     const int* local_dst, const int* chunk_block, float* out,
                                     float* scratch, unsigned* counters, int n_chunks,
                                     int chunk, int row_block, int nb, int din, int table_rows,
                                     int num_nodes, int per_basis_rows, int sum_bases,
                                     int out_bf16, int span, void* stream) {
  if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const k4o::Args a = k4o::make_args(x, src, w, local_dst, chunk_block, out, scratch, counters,
                                     n_chunks, chunk, row_block, din, table_rows, num_nodes,
                                     sum_bases);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(per_basis_rows ? k4o::run<float, float, true>(a, nb, span, st)
                                         : k4o::run<float, float, false>(a, nb, span, st));
}
