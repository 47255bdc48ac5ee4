// K4's f32 and bf16 forms by the design they replaced (sm_90a):
// weighted_runs.cuh over the destination-sorted frame, a CTA a chunk that
// sorts its lanes by destination with shared-memory atomics, the rows two
// chunks share zeroed by a launch before and finished with f32 atomics (a
// bf16 output summed in an f32 scratch of its shape and narrowed after),
// in no fixed order. No model path launches it; rgcn_tpu_torch/compare_k4.py
// and compare_k4_bf16.py time it beside the launchers (k4_owned.cuh).
// Arguments: (x, src, w, local_dst, chunk_block, out, scratch (unused for an
// f32 output; the output's f32 sums for a bf16 one), n_chunks, chunk,
// row_block, nb, din, table_rows, num_nodes, per_basis_rows, sum_bases,
// out_bf16, stream).

#include "../weighted_runs.cuh"

namespace {
template <typename TX>
int runs(const TX* x, const int* src, const float* w, const int* local_dst,
         const int* chunk_block, void* out, float* scratch, int n_chunks, int chunk,
         int row_block, int nb, int din, int table_rows, int num_nodes, int per_basis_rows,
         int sum_bases, int out_bf16, void* stream) {
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
  a.dst_sorted = 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if constexpr (sizeof(TX) == 4) {
    if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(per_basis_rows ? wruns::run<float, float, true>(a, nb, st)
                                           : wruns::run<float, float, false>(a, nb, st));
  } else {
    if (out_bf16)
      return static_cast<int>(per_basis_rows ? wruns::run<bf16, bf16, true>(a, nb, st)
                                             : wruns::run<bf16, bf16, false>(a, nb, st));
    return static_cast<int>(per_basis_rows ? wruns::run<bf16, float, true>(a, nb, st)
                                           : wruns::run<bf16, float, false>(a, nb, st));
  }
}
}  // namespace

extern "C" int k4_runs_f32(const float* x, const int* src, const float* w, const int* local_dst,
                           const int* chunk_block, void* out, float* scratch, int n_chunks,
                           int chunk, int row_block, int nb, int din, int table_rows,
                           int num_nodes, int per_basis_rows, int sum_bases, int out_bf16,
                           void* stream) {
  return runs(x, src, w, local_dst, chunk_block, out, scratch, n_chunks, chunk, row_block, nb,
              din, table_rows, num_nodes, per_basis_rows, sum_bases, out_bf16, stream);
}

extern "C" int k4_runs_bf16(const __nv_bfloat16* x, const int* src, const float* w,
                            const int* local_dst, const int* chunk_block, void* out,
                            float* scratch, int n_chunks, int chunk, int row_block, int nb,
                            int din, int table_rows, int num_nodes, int per_basis_rows,
                            int sum_bases, int out_bf16, void* stream) {
  return runs(x, src, w, local_dst, chunk_block, out, scratch, n_chunks, chunk, row_block, nb,
              din, table_rows, num_nodes, per_basis_rows, sum_bases, out_bf16, stream);
}
