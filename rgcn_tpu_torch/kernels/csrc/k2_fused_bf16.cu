// K2's bf16 form: fused relation-quantum SpMM over a FusedLayout with bf16
// x and W, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_fused.py::rel_spmm_fused (kernel
// _make_fused_kernel) with its default compute_dtype=bf16: x and W cast to
// bf16 (pallas_fused.py:376-378), each quantum's products of two bf16
// values summed in f32 (preferred_element_type=f32) and scaled by val in
// f32, each slot's message rounded to bf16 (the msgs_ref scratch,
// :339-343), and the one-hot destination sum of the bf16 messages taken in
// f32 into an f32 output (:346-349). Computes
//     out[n] = sum over fused slots l with destination n of
//              bf16(val[l] * (x[src[l]] @ W[quantum_rel[l / Q]]))
// with the layout contract of k2_fused.cu (gap quanta -1, pad slots RB,
// rows at or past num_nodes dropped, a block's chunks adjacent).
//
// Bound on the H100: bytes, and in practice latency, as the f32 form's,
// with half the x and W bytes: at nc-AIFB's layer 2 (x (N, 16), W (90, 16,
// 4)) the referenced x rows, W, the real slots' src and val and the layout
// once, and the f32 output once.
//
// Design: k2_fused.cu's (k2_fused.cuh over chunk_sum.cuh) on bf16
// operands: x rows gathered 8 values to a 16-byte load, W read through L1
// 4 values to an 8-byte load, each value widened exactly to f32; each
// slot's message rounded to bf16 where it is staged in shared memory (as
// f32), then summed by row in slot order, a block's chunks in chunk order:
// one launch, no memset, the same bits on every launch. The design before
// it (a CTA a quantum, W[rel] staged as bf16, vector f32 atomics into a
// memset output) is kept in variants/k2_atomics_bf16.cu.

#include "k2_fused.cuh"

extern "C" int k2_fused_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const int* src,
                             const float* val, const int* local_dst, const int* quantum_rel,
                             const int* chunk_block, float* out, float* part,
                             unsigned* counters, int n_quanta, int din, int dout,
                             int row_block, int chunk, int quantum, int num_nodes,
                             void* stream) {
  return k2::run<__nv_bfloat16>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,
                                part, counters, n_quanta, din, dout, row_block, chunk,
                                quantum, num_nodes, stream);
}
