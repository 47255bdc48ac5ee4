// K2's bf16-weight form: fused relation-quantum SpMM over a FusedLayout
// with f32 x and a bf16 W, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_fused.py::rel_spmm_fused (kernel
// _make_fused_kernel) with compute_dtype=None over a bf16 W: the layers'
// param_dtype=bfloat16, where the model's forward and its dx over
// edges.reverse (pallas_spmm.py::_fwd_spmm, compute_dtype=None) hand the
// kernel f32 activations and the bf16 parameters as they are. The Pallas
// kernel computes jnp.dot(xq, w_q, preferred_element_type=f32)
// (pallas_fused.py:339): each bf16 weight widened exactly, f32 products and
// sums, an f32 message scaled by val in f32, f32 destination sums. So does
// this form. Computes
//     out[n] = sum over fused slots l with destination n of
//              val[l] * (x[src[l]] @ f32(W[quantum_rel[l / Q]]))
// with the layout contract of k2_fused.cu (gap quanta -1, pad slots RB,
// rows at or past num_nodes dropped, a block's chunks adjacent).
//
// Bound on the H100: bytes, and in practice latency, as the f32 form's,
// with half of W's bytes: at nc-AIFB's layer 2 (x (N, 16) f32, W (90, 16,
// 4) bf16) the referenced x rows, W, the real slots' src and val and the
// layout once, and the f32 output once.
//
// Design: k2_fused.cu's (k2_fused.cuh over chunk_sum.cuh, a CTA a chunk,
// each row's messages summed in slot order, a block's chunks by their last
// CTA in chunk order: one launch, no memset, the same bits on every
// launch), with W's own type: x rows gathered 4 f32 values to a 16-byte
// load, W read through L1 as bf16, 4 values to an 8-byte load (half the
// f32 form's bytes), each widened to f32 in registers where it multiplies.
// W is not staged in shared memory, as in the f32 form: a chunk's quanta
// may each have another relation, and a warp's slots share a quantum, so
// its W loads are broadcasts out of L1. The products are the f32 form's on
// the widened values, in the same order: this form gives the f32 form's
// bits for W widened to f32 beforehand.

#include "k2_fused.cuh"

extern "C" int k2_fused_wbf16(const float* x, const __nv_bfloat16* w, const int* src,
                              const float* val, const int* local_dst, const int* quantum_rel,
                              const int* chunk_block, float* out, float* part,
                              unsigned* counters, int n_quanta, int din, int dout,
                              int row_block, int chunk, int quantum, int num_nodes,
                              void* stream) {
  return k2::run<float, 0, __nv_bfloat16>(x, w, src, val, local_dst, quantum_rel,
                                          chunk_block, out, part, counters, n_quanta, din,
                                          dout, row_block, chunk, quantum, num_nodes, stream);
}
