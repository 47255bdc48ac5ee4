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
// Design: weighted_runs.cuh, as the frame with one lane per slot, sorted by
// destination within each row block (the layout builders guarantee it; K4
// relies on it). One CTA per chunk sums each destination's run in registers
// over all din columns and stores it once; a chunk owns the rows from its
// first destination to the next chunk's, so only the rows two chunks share
// (at most one per chunk boundary) are zeroed by a small launch before and
// finished with atomics. No memset of the whole output. The TPU kernel
// carried each row block's sum in VMEM from chunk to chunk in a sequential
// grid; here chunks run in parallel, so the hub blocks (24 chunks against a
// median of 1 at lp-WN18) are spread over as many CTAs as they have chunks.

#include "weighted_runs.cuh"

// The parameters are the bf16 form's (k4_weighted_aggregate_bf16.cu), so one
// argument list binds both: scratch is unused here and out_bf16 must be 0.
extern "C" int k4_weighted_aggregate(const float* x, const int* src,
                                     const float* w, const int* local_dst,
                                     const int* chunk_block, float* out,
                                     float* /*scratch*/, int n_chunks, int chunk,
                                     int row_block, int nb, int din, int table_rows,
                                     int num_nodes, int per_basis_rows,
                                     int sum_bases, int out_bf16, void* stream) {
  if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
  wruns::Args a{};
  a.x = x;
  a.src = src;
  a.w = w;
  a.local = local_dst;
  a.chunk_block = chunk_block;
  a.out = out;
  a.acc = out;
  a.num_slots = static_cast<long long>(n_chunks) * chunk;
  a.table_plane = static_cast<long long>(table_rows) * din;
  a.n_chunks = n_chunks;
  a.chunk = chunk;
  a.row_block = row_block;
  a.kk = 1;
  a.din = din;
  a.num_nodes = num_nodes;
  a.sum_bases = sum_bases;
  a.dst_sorted = 1;  // every DstLayout builder sorts a block's slots by destination
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(per_basis_rows ? wruns::run<float, float, true>(a, nb, st)
                                         : wruns::run<float, float, false>(a, nb, st));
}
