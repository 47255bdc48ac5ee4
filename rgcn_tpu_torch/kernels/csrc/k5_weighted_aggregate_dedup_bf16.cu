// K5 on a bf16 table: weighted aggregation over the source-dedup'd merged
// frame, with the source-row gather inside, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_basis.py::weighted_aggregate_dedup_pallas
// with a bf16 compute dtype (the merged basis op's forward on the card,
// pallas_basis.py:468-494, and the JAX canary's step, utils/canary.py:105-118):
// bf16 rows, each lane's weight rounded to bf16, exact products and f32
// sums, an f32 output or a bf16 one (out_bf16) narrowed once per element
// from its whole f32 sum.
//
// Bound on the H100: bytes, as the f32 form's, with half the row bytes and,
// for a bf16 output, half the output bytes: about half the f32 form's
// ~83 MB at lp-WN18 (din 200, nb 2).
//
// Design: weighted_runs.cuh instantiated with TX = __nv_bfloat16 over K5's
// frame (k5_weighted_aggregate_dedup.cu). Every row of a row block with
// several chunks is finished with f32 atomics: into the output itself for
// an f32 output, else into ``scratch`` (f32, the output's shape; only those
// rows are zeroed and read), narrowed after.

#include "weighted_runs.cuh"

extern "C" int k5_weighted_aggregate_dedup_bf16(const __nv_bfloat16* x, const int* src,
                                                const float* w_k, const int* local_k,
                                                const int* chunk_block, void* out,
                                                float* scratch, int n_chunks,
                                                int chunk, int row_block, int kk,
                                                int nb, int din, int num_nodes,
                                                int out_bf16, void* stream) {
  wruns::Args a{};
  a.x = x;
  a.src = src;
  a.w = w_k;
  a.local = local_k;
  a.chunk_block = chunk_block;
  a.out = out;
  a.acc = out_bf16 ? scratch : static_cast<float*>(out);
  a.num_slots = static_cast<long long>(n_chunks) * chunk;
  a.n_chunks = n_chunks;
  a.chunk = chunk;
  a.row_block = row_block;
  a.kk = kk;
  a.din = din;
  a.num_nodes = num_nodes;
  a.dst_sorted = 0;  // a block's slots are sorted by source
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  return static_cast<int>(out_bf16 ? wruns::run<bf16, bf16, false>(a, nb, st)
                                   : wruns::run<bf16, float, false>(a, nb, st));
}
