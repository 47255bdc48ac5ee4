// K2: fused relation-quantum SpMM over a FusedLayout, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_fused.py::rel_spmm_fused (kernel
// _make_fused_kernel) with compute_dtype=None (f32 throughout, as the
// model's forward and its dx run it). Computes
//     out[n] = sum over fused slots l with destination n of
//              val[l] * (x[src[l]] @ W[quantum_rel[l / Q]])
// Slots come in Q-slot quanta of one relation; quantum_rel == -1 marks a
// gap quantum (its slots carry val 0) and local_dst == RB a pad slot. Slot
// l of chunk c targets node chunk_block[c] * RB + local_dst[l]; rows at or
// past num_nodes are dropped. Every row block has at least one chunk and a
// block's chunks are adjacent, as both fused builders lay them out.
//
// Bound on the H100: bytes, and in practice latency. The products are
// 2 * din * dout flops per real slot (~7 MFLOP at nc-AIFB layer 2, din 16,
// dout 4: nothing against 67 TFLOP/s f32); the card must read x, W, the
// real slots' src and val and the layout once and write the output once
// (~1.8 MB, ~0.5 us).
//
// Design (k2_fused.cuh over chunk_sum.cuh): a CTA a chunk (296 at nc-AIFB)
// of a thread a slot and a row. Each real slot's thread gathers its x row,
// reads W[rel] through L1 (no staging: a chunk's quanta may each have
// another relation), and writes its message to shared memory; each row's
// messages are then added in slot order, as the TPU kernel's one-hot
// product sums a chunk (pallas_fused.py:346-350), and a row block of
// several chunks is finished by its last CTA adding the chunks' tiles in
// chunk order: one launch, no memset, no atomics on the output, the same
// bits on every launch. The design before it (a CTA a quantum, each slot's
// outputs added with vector f32 atomics into a memset output) is kept in
// variants/k2_atomics.cu; a shared-memory tile with shared atomics
// (variants/k2_fused_tile.cu) was 4.2x slower than that at nc-AIFB.
//
// No tensor cores: at nc-AIFB a quantum's product is (<= 64 x 16) @ (16 x
// 4), ~7 MFLOP in all, and a 64-row wgmma tile with N = 4 would be mostly
// empty while the gather, not the product, sets the time. They pay once
// the product per slot outweighs its row gather, at widths of about 64 and
// up on both sides (din * dout >= 4096: 2 * din * dout flops per 4 * din
// bytes gathered passes the f32 CUDA-core ridge of ~20 flop/byte near dout
// 40, and the TF32 or bf16 tensor-core rates need dout >= 64 to fill an
// N tile).

#include "k2_fused.cuh"

// part: an (RB, dout) f32 tile a chunk; counters: one zeroed counter a
// chunk, left zero (rgcn_tpu_torch.kernels keeps both).
extern "C" int k2_fused(const float* x, const float* w, const int* src, const float* val,
                        const int* local_dst, const int* quantum_rel, const int* chunk_block,
                        float* out, float* part, unsigned* counters, int n_quanta, int din,
                        int dout, int row_block, int chunk, int quantum, int num_nodes,
                        void* stream) {
  return k2::run<float>(x, w, src, val, local_dst, quantum_rel, chunk_block, out, part,
                        counters, n_quanta, din, dout, row_block, chunk, quantum, num_nodes,
                        stream);
}
