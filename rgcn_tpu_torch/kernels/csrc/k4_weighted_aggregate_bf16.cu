// K4 on bf16 tables: weighted destination aggregation with the source-row
// gather inside, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_basis.py::weighted_aggregate_pallas with a
// bf16 compute dtype (the edge stage of the basis layers on the card,
// rgcn_tpu/nn/layers.py:45-55, and the structured decoder's bwd_dtype
// backward, rgcn_tpu/ops/pallas_distmult.py:395-413): the table rows are
// bf16, each slot weight is rounded to bf16 (w.astype(xg.dtype)), the
// products are exact in f32 and the sums are f32, as the MXU's
// preferred_element_type=f32 gives them. The output is f32, or bf16
// (out_bf16) narrowed once per element from its whole f32 sum, as the Pallas
// kernel narrows its f32 VMEM scratch on a row block's closing chunk.
//
// Bound on the H100: bytes, as the f32 form's (k4_weighted_aggregate.cu),
// with half the row bytes read and, for a bf16 output, half the output
// bytes written: about half the f32 form's ~83 MB at lp-WN18 (din 200,
// nb 2).
//
// Design: weighted_runs.cuh instantiated with TX = __nv_bfloat16, the same
// frame and the same ownership of output rows as the f32 form. A thread
// loads 16-byte vectors of 8 bf16 values where din % 8 == 0 (one value
// otherwise, e.g. nc-AM's hidden width 10). With a bf16 output the rows two
// chunks share are summed with f32 atomics into ``scratch`` (f32, the
// output's shape; only those rows are zeroed and read) and narrowed after.

#include "weighted_runs.cuh"

extern "C" int k4_weighted_aggregate_bf16(const __nv_bfloat16* x, const int* src,
                                          const float* w, const int* local_dst,
                                          const int* chunk_block, void* out,
                                          float* scratch, int n_chunks, int chunk,
                                          int row_block, int nb, int din,
                                          int table_rows, int num_nodes,
                                          int per_basis_rows, int sum_bases,
                                          int out_bf16, void* stream) {
  wruns::Args a{};
  a.x = x;
  a.src = src;
  a.w = w;
  a.local = local_dst;
  a.chunk_block = chunk_block;
  a.out = out;
  a.acc = out_bf16 ? scratch : static_cast<float*>(out);
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
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (out_bf16)
    err = per_basis_rows ? wruns::run<bf16, bf16, true>(a, nb, st)
                         : wruns::run<bf16, bf16, false>(a, nb, st);
  else
    err = per_basis_rows ? wruns::run<bf16, float, true>(a, nb, st)
                         : wruns::run<bf16, float, false>(a, nb, st);
  return static_cast<int>(err);
}
