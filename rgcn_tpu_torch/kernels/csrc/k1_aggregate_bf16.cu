// K1 on bf16 messages: segmented destination sum over a DstLayout, for
// Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_aggregate.py::aggregate_presorted_pallas
// where its messages come in bf16 (the diagonal layer's messages and the
// pair path's table gradient under the edge stage's compute dtype,
// rgcn_tpu/ops/pallas_diag.py:58-100 and ops/spmm.py:369-395): the Pallas
// kernel reads bf16 rows and sums them in f32 into its default f32 output.
// So does this form: each bf16 value widens exactly to f32 (cuda_bf16.h's
// __bfloat162float), the sums and the atomics are f32, the output is f32,
// or bf16 (out_bf16) rounded once per element as k1_aggregate.cu says.
//
// Bound on the H100: bytes, as the f32 form's, with half the message bytes:
// 2 bytes a value read against 4 bytes a value of output written once.
//
// Design: k1_aggregate.cu's, instantiated for __nv_bfloat16 (k1_aggregate.cuh).
// A lane loads an 8-byte vector of 4 bf16 values where dout is a multiple of
// 4 and msgs is 8-byte aligned, else one value (nc-AM's hidden width 10
// takes the scalar lanes), so the lanes map to slots and columns as the f32
// form's do, and adds its run's f32 sums with one red.global.add.v4.f32.

#include "k1_aggregate.cuh"

extern "C" int k1_aggregate_bf16(const __nv_bfloat16* msgs, const int* index,
                                 const int* local_dst, const int* chunk_block,
                                 void* out, float* scratch, int n_chunks, int chunk,
                                 int row_block, int dout, int num_nodes, int out_bf16,
                                 void* stream) {
  return k1::run<__nv_bfloat16>(msgs, index, local_dst, chunk_block, out, scratch, n_chunks,
                                chunk, row_block, dout, num_nodes, out_bf16, stream);
}
