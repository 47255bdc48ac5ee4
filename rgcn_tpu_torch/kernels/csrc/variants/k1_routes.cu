// K1's two routes forced, for rgcn_tpu_torch/compare_k1_k5.py (sm_90a). No
// serving path launches them: k1_aggregate.cu and k1_aggregate_bf16.cu pick
// the route by the layout's shape (k1_aggregate.cuh, run()), and these
// entry points take one whatever the shape, so the comparison can time
// both where the launcher takes only one. The owned-row route needs a
// destination-sorted layout. Arguments as K1's launchers'.

#include "../k1_aggregate.cuh"

extern "C" int k1_owned_f32(const float* msgs, const int* index, const int* local_dst,
                            const int* chunk_block, void* out, float* scratch, int n_chunks,
                            int chunk, int row_block, int dout, int num_nodes, int dst_sorted,
                            int out_bf16, void* stream) {
  return k1::run<float, k1::kOwned>(msgs, index, local_dst, chunk_block, out, scratch,
                                    n_chunks, chunk, row_block, dout, num_nodes, dst_sorted,
                                    out_bf16, stream);
}

extern "C" int k1_atomics_f32(const float* msgs, const int* index, const int* local_dst,
                              const int* chunk_block, void* out, float* scratch, int n_chunks,
                              int chunk, int row_block, int dout, int num_nodes, int dst_sorted,
                              int out_bf16, void* stream) {
  return k1::run<float, k1::kAtomics>(msgs, index, local_dst, chunk_block, out, scratch,
                                      n_chunks, chunk, row_block, dout, num_nodes, dst_sorted,
                                      out_bf16, stream);
}

extern "C" int k1_owned_bf16(const __nv_bfloat16* msgs, const int* index, const int* local_dst,
                             const int* chunk_block, void* out, float* scratch, int n_chunks,
                             int chunk, int row_block, int dout, int num_nodes, int dst_sorted,
                             int out_bf16, void* stream) {
  return k1::run<__nv_bfloat16, k1::kOwned>(msgs, index, local_dst, chunk_block, out, scratch,
                                            n_chunks, chunk, row_block, dout, num_nodes,
                                            dst_sorted, out_bf16, stream);
}

extern "C" int k1_atomics_bf16(const __nv_bfloat16* msgs, const int* index,
                               const int* local_dst, const int* chunk_block, void* out,
                               float* scratch, int n_chunks, int chunk, int row_block, int dout,
                               int num_nodes, int dst_sorted, int out_bf16, void* stream) {
  return k1::run<__nv_bfloat16, k1::kAtomics>(msgs, index, local_dst, chunk_block, out,
                                              scratch, n_chunks, chunk, row_block, dout,
                                              num_nodes, dst_sorted, out_bf16, stream);
}
