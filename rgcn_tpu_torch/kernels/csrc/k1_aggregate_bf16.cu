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
// What held the atomics design (k1_aggregate.cu) back here: every run
// ended in a red.global.add.v4.f32 into an output the launcher memset whole
// first, so the output's bytes went to the card three times (the memset,
// the atomics' reads and writes in L2) and the atomics' throughput, not
// the message bytes, set the pace: halving the message bytes left the bf16
// form no faster than the f32 one.
//
// Design: owned rows (k1_owned_kernel, k1_aggregate.cuh), as the Pallas
// kernel keeps a row block's output resident across the block's chunks,
// zeroes it at the first and writes it once (pallas_aggregate.py:186-199).
// The lane map is the atomics design's (lanes of 4 values, 8-byte loads of
// bf16, or scalars where dout % 4 != 0 such as nc-AM's hidden width 10;
// groups of LPS lanes on a row, each walking 8 or LPS consecutive slots
// with 8 row loads in flight a lane). A CTA takes a span of one chunk (the
// whole chunk at CH 256 and dout 32). In a destination-sorted row block a
// destination's slots are consecutive, so a destination all of whose slots
// lie in the span is the CTA's: the runs its lane groups split are merged
// through shared memory (a group leaves a run that goes on from the group
// before as a partial row there; the group the run starts in adds those
// partials after a barrier), and its row is stored once with plain
// coalesced stores (bf16 output: rounded from the registers that summed
// it). The rows of the span's range that no slot reaches (one bit a row)
// are stored as zeros. Only the at most two destinations the span shares
// with the spans beside it are zeroed by a small launch before
// (zero_split_rows, a warp a span) and finished with f32 atomics, into an
// f32 scratch for a bf16 output, narrowed by a small launch after
// (narrow_split_rows). No memset of the output. The f32 form takes this
// route at the same shapes. A layout ordered by source within its row
// blocks (dst_sorted 0), scalar lanes, and a launch of fewer CTAs than
// kOwnedMinUnits (latency-bound: nc-AIFB) take the atomics design, which
// measured faster there (k1_aggregate.cuh).

#include "k1_aggregate.cuh"

extern "C" int k1_aggregate_bf16(const __nv_bfloat16* msgs, const int* index,
                                 const int* local_dst, const int* chunk_block,
                                 void* out, float* scratch, int n_chunks, int chunk,
                                 int row_block, int dout, int num_nodes, int dst_sorted,
                                 int out_bf16, void* stream) {
  return k1::run<__nv_bfloat16>(msgs, index, local_dst, chunk_block, out, scratch, n_chunks,
                                chunk, row_block, dout, num_nodes, dst_sorted, out_bf16,
                                stream);
}
