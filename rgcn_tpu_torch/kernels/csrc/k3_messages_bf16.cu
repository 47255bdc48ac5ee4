// K3's bf16 forms: per-tile relational messages with bf16 operands or bf16
// messages, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_spmm.py::rel_spmm_messages (kernel
// _msgs_kernel) where its operands or its out_dtype are bf16: the Pallas
// kernel computes jnp.dot(x[src], W[rel], preferred_element_type=f32),
// scales by val in f32 and rounds once to out_dtype. So does this library:
//   x_bf16 = 1: x and W bf16 (rel_spmm_pallas / rel_spmm_pallas_full with
//     compute_dtype=bf16), each product of two bf16 values exact in f32,
//     f32 sums, messages f32 or bf16 (out_bf16);
//   x_bf16 = 0, out_bf16 = 1: f32 operands through the f32 form's routes
//     (3xTF32 tiled, f32 small), the messages rounded once to bf16
//     (rel_spmm_messages(out_dtype=bf16)).
//
// Bound on the H100 at lp-FB-toy (x (280, 500), W (224, 500, 500), 250
// tiles of 128 holding 7,368 real rows): bytes. In bf16 the card must read
// W once (112 MB, half the f32 form's 224 MB) and write the (32,000, 500)
// messages (64 MB in f32, 32 MB in bf16): ~53 us, or ~43 us with bf16
// messages, at 3.35 TB/s, against 3.7 GFLOP of real rows, ~4 us at 989
// TFLOP/s in bf16.
//
// Design (tiled route, bf16 operands). The f32 form's CTA (a 64-row window
// of a tile, compacted to its rows with val != 0, by a 128-column slice;
// slices fastest, so the CTAs of a relation share W[rel] in L2) and its
// 4-stage cp.async ring of x and W slabs, with bf16 slabs 64 deep (a stage
// holds the f32 route's bytes). Each warp owns 16 columns over the
// window's live m16 tiles and multiplies on the tensor cores in one pass:
// mma.sync m16n8k16 bf16 with f32 accumulators, each 64-deep slab's
// products summed there and added to the running f32 sums on the CUDA
// cores. No split is needed: a bf16 value is exact as a tensor-core
// operand. The A fragments are 32-bit shared loads of two adjacent bf16
// values; the B fragments (two values adjacent in k, one column) are
// packed from two 16-bit shared loads. Copies are 16 bytes (8 values)
// where din and dout are multiples of 8, else 8 bytes (4 values; lp-FB-toy's
// width 500), else plain 2-byte loads. wgmma and TMA are later work.
//
// Small route (dout <= 32, W[rel] within 48 KB as f32): the f32 form's,
// W[rel] widened to f32 in shared memory, x rows read in 16-byte vectors
// of 8 bf16 values where din % 8 == 0 (one value otherwise).

#include "k3_messages.cuh"

extern "C" int k3_messages_bf16(const void* x, const void* w, const int* src,
                                const float* val, const int* tile_rel, void* out,
                                int num_tiles, int tile, int din, int dout,
                                int x_bf16, int out_bf16, void* stream) {
  using bf16 = __nv_bfloat16;
  if (x_bf16) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    return out_bf16
               ? k3::dispatch_bf16<bf16>(xb, wb, src, val, tile_rel, static_cast<bf16*>(out),
                                         num_tiles, tile, din, dout, stream)
               : k3::dispatch_bf16<float>(xb, wb, src, val, tile_rel,
                                          static_cast<float*>(out), num_tiles, tile, din,
                                          dout, stream);
  }
  if (!out_bf16) return cudaErrorInvalidValue;  // f32 in and out: k3_messages
  return k3::dispatch_f32<0, bf16>(static_cast<const float*>(x), static_cast<const float*>(w),
                                   src, val, tile_rel, static_cast<bf16*>(out), num_tiles,
                                   tile, din, dout, stream);
}
