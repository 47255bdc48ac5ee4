// K5: weighted aggregation over the source-dedup'd merged frame, with the
// source-row gather inside, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_basis.py::weighted_aggregate_dedup_pallas.
// Over a DedupFwdLayout each gather slot l holds one source row x[src[l]]
// and up to K (local destination, weight) lanes: for every basis b < nb,
//     agg[n, b] = sum over slots l, lanes k with destination n of
//                 w_k[k, b, l] * x[src[l]]
// where lane k of slot l in chunk c targets chunk_block[c] * RB +
// local_k[k, l] and local_k == RB marks an empty lane. A slot whose lanes
// are all empty is a pad: its src and weights are never read. The output
// is node-major, (num_nodes, nb, din).
//
// Bound on the H100: bytes, as K4's: 2 * nb flops per lane and column
// against 4 bytes of row. At lp-WN18 (118,016 slots of which the real ones
// carry 95,479 lanes, din 200, nb 2) the card must read the referenced rows
// and write the whole output once: 83 MB, 24.9 us at 3.35 TB/s.
//
// Design: weighted_runs.cuh, as the frame with K lanes per slot. A block's
// slots are sorted by source, so a destination's lanes lie scattered over
// the chunk (at lp-WN18 about 207 real lanes over 47 destinations a chunk);
// the CTA sorts its chunk's lanes by destination in shared memory (a
// counting sort), sums each destination's run in registers over all din
// columns and writes it once: plain stores for a row block's only chunk
// (zeros where no lane reaches), vector atomics into rows zeroed by a
// small launch before for the chunks of a row block with several. A lane's
// row is gathered per lane, not once per slot: the sort trades the frame's
// shared gather for one merged write per destination.

#include "weighted_runs.cuh"

// The parameters are the bf16 form's (k5_weighted_aggregate_dedup_bf16.cu),
// so one argument list binds both: scratch is unused here and out_bf16 must
// be 0.
extern "C" int k5_weighted_aggregate_dedup(const float* x, const int* src,
                                           const float* w_k,
                                           const int* local_k,
                                           const int* chunk_block, float* out,
                                           float* /*scratch*/, int n_chunks,
                                           int chunk, int row_block, int kk,
                                           int nb, int din, int num_nodes,
                                           int out_bf16, void* stream) {
  if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
  wruns::Args a{};
  a.x = x;
  a.src = src;
  a.w = w_k;
  a.local = local_k;
  a.chunk_block = chunk_block;
  a.out = out;
  a.acc = out;
  a.num_slots = static_cast<long long>(n_chunks) * chunk;
  a.n_chunks = n_chunks;
  a.chunk = chunk;
  a.row_block = row_block;
  a.kk = kk;
  a.din = din;
  a.num_nodes = num_nodes;
  a.dst_sorted = 0;  // a block's slots are sorted by source
  return static_cast<int>(
      wruns::run<float, float, false>(a, nb, static_cast<cudaStream_t>(stream)));
}
