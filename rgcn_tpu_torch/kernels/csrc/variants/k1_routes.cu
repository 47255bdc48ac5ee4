// K1's memset-and-atomics route and its owned-row route with atomics on
// split rows (k1_atomic_routes.cuh: kAtomics, kOwned) forced, for
// rgcn_tpu_torch/compare_k1_k2.py and compare_k1_k5.py (sm_90a). The
// launchers take the fixed-order routes for every layout (kernels.k1_route);
// these entry points take one of the designs those replaced, so the
// comparisons can time them. The owned-row route needs a
// destination-sorted layout. Arguments: (msgs, index, local_dst,
// chunk_block, out, scratch (an f32 scratch of the output's size for a
// bf16 output), n_chunks, chunk, row_block, dout, num_nodes, dst_sorted
// (unused: the route is forced), out_bf16, stream).

#include "k1_atomic_routes.cuh"

namespace {
template <typename TM>
int forced(int route, const TM* msgs, const int* index, const int* local_dst,
           const int* chunk_block, void* out, float* scratch, int n_chunks, int chunk,
           int row_block, int dout, int num_nodes, int out_bf16, void* stream) {
  return k1::run_forced<TM>(route, msgs, index, local_dst, chunk_block, out, scratch, n_chunks,
                            chunk, row_block, dout, num_nodes, out_bf16, stream);
}
}  // namespace

extern "C" int k1_owned_f32(const float* msgs, const int* index, const int* local_dst,
                            const int* chunk_block, void* out, float* scratch, int n_chunks,
                            int chunk, int row_block, int dout, int num_nodes, int dst_sorted,
                            int out_bf16, void* stream) {
  return forced(k1::kOwned, msgs, index, local_dst, chunk_block, out, scratch, n_chunks, chunk,
                row_block, dout, num_nodes, out_bf16, stream);
}

extern "C" int k1_atomics_f32(const float* msgs, const int* index, const int* local_dst,
                              const int* chunk_block, void* out, float* scratch, int n_chunks,
                              int chunk, int row_block, int dout, int num_nodes, int dst_sorted,
                              int out_bf16, void* stream) {
  return forced(k1::kAtomics, msgs, index, local_dst, chunk_block, out, scratch, n_chunks,
                chunk, row_block, dout, num_nodes, out_bf16, stream);
}

extern "C" int k1_owned_bf16(const __nv_bfloat16* msgs, const int* index, const int* local_dst,
                             const int* chunk_block, void* out, float* scratch, int n_chunks,
                             int chunk, int row_block, int dout, int num_nodes, int dst_sorted,
                             int out_bf16, void* stream) {
  return forced(k1::kOwned, msgs, index, local_dst, chunk_block, out, scratch, n_chunks, chunk,
                row_block, dout, num_nodes, out_bf16, stream);
}

extern "C" int k1_atomics_bf16(const __nv_bfloat16* msgs, const int* index,
                               const int* local_dst, const int* chunk_block, void* out,
                               float* scratch, int n_chunks, int chunk, int row_block, int dout,
                               int num_nodes, int dst_sorted, int out_bf16, void* stream) {
  return forced(k1::kAtomics, msgs, index, local_dst, chunk_block, out, scratch, n_chunks,
                chunk, row_block, dout, num_nodes, out_bf16, stream);
}
