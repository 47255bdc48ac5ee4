// K1 on bf16 messages: segmented destination sum over a DstLayout, for
// Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_aggregate.py::aggregate_presorted_pallas
// where its messages come in bf16 (the diagonal layer's messages and the
// pair path's table gradient under the edge stage's compute dtype,
// rgcn_tpu/ops/pallas_diag.py:58-100 and ops/spmm.py:369-395): the Pallas
// kernel reads bf16 rows and sums them in f32 into its default f32 output.
// So does this form: each bf16 value widens exactly to f32 (cuda_bf16.h's
// __bfloat162float), the sums are f32, the output is f32, or bf16
// (out_bf16) rounded once per element from its whole f32 sum.
//
// Bound on the H100: bytes. The card must read each real slot's bf16
// message row (and index), the layout's local_dst, and write the output
// once: at e-RGCN nc-AM's diagonal messages (dout 32, f32 out) the output
// is 38.4 MB beside the ~100 MB of messages.
//
// Design: k1_aggregate.cu's (k1_aggregate.cuh), the same lane map on
// bf16 rows (lanes of 4 values, 8-byte loads, or 4- and 2-byte pieces
// where dout % 4 != 0 such as nc-AM's hidden width 10, a row's last lane
// masked; groups of LPS lanes on a row, each walking 8 or LPS consecutive
// slots with 8 row loads in flight a lane), as the Pallas kernel keeps a
// row block's output resident across the block's chunks, zeroes it at the
// first and writes it once (pallas_aggregate.py:186-199): each destination
// whose slots lie in a CTA's span is stored once (a bf16 output rounded
// from the registers that summed it), the rows no slot reaches as zeros,
// and a destination that crosses CTAs is finished by the last of them, in
// CTA order, from f32 parts. One launch, no memset, no f32 scratch of the
// output's size, and the same bits on every launch, at every layout.

#include "k1_aggregate.cuh"

extern "C" int k1_aggregate_bf16(const __nv_bfloat16* msgs, const int* index,
                                 const int* local_dst, const int* chunk_block,
                                 void* out, float* scratch, unsigned* counters, int n_chunks,
                                 int chunk, int row_block, int dout, int num_nodes, int route,
                                 int out_bf16, void* stream) {
  return k1::run<__nv_bfloat16>(msgs, index, local_dst, chunk_block, out, scratch, counters,
                                n_chunks, chunk, row_block, dout, num_nodes, route, out_bf16,
                                stream);
}
