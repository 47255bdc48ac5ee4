// K3's bf16-weight form: per-tile relational messages with f32 x and a bf16
// W, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_spmm.py::rel_spmm_messages (kernel
// _msgs_kernel, :53-67) where W is bf16 and x f32: the layers'
// param_dtype=bfloat16 on the two-stage route (rel_spmm_pallas_full with
// compute_dtype=None, out_dtype f32), which the model's forward and its dx
// take when W does not fit the fused kernel. The Pallas kernel computes
// jnp.dot(x[src], W[rel], preferred_element_type=f32): each bf16 weight
// widened exactly, f32 products and sums, scaled by val in f32, and
// rounded once to out_dtype (f32 on the models' route; bf16, the weights'
// dtype, where rel_spmm_messages is called without one). So does this
// form:
//     msgs[e] = out_dtype((x[src[e]] @ f32(W[tile_rel[t]])) * val[e])
// rows whose val is 0 come out 0 uncomputed, as in k3_messages.cu.
//
// Bound on the H100 at lp-FB-toy's block layer (x (280, 500) f32, the
// expanded W (224, 500, 500) bf16, 250 tiles of 128 holding 7,368 real
// rows): bytes. The card must read W once (112 MB, half the f32 form's
// 224 MB), the referenced x rows, and write the (32,000, 500) f32 messages
// (64 MB): ~53 us at 3.35 TB/s, against 3.7 GFLOP of real rows.
//
// Design (tiled route). The f32 form's CTA (a 64-row window of a tile,
// compacted to its rows with val != 0, by a 128-column slice; slices
// fastest, so the CTAs of a relation share W[rel] in L2), its 4-stage
// cp.async ring of 32-deep x and W slabs and its mma.sync m16n8k8 TF32
// tiles, with W's slab kept as bf16 (8-byte copies of 4 values: half the
// bytes of the f32 form's slab in memory and in shared memory). Every bf16
// value is exact in TF32 (8 of its 10 mantissa bits), so W's low part is 0
// and the f32 form's 3xTF32 product lo*hi + hi*lo + hi*hi needs two
// passes, x_lo * W + x_hi * W: about 21 bits of x kept, W exact. Each slab's
// products are summed on the tensor cores and added to the running f32
// sums on the CUDA cores. din or dout that is not a multiple of 4, or
// unaligned operands, take one value a copy.
//
// Small route (dout <= 32, W[rel] within 48 KB as f32): the f32 form's,
// W[rel] widened to f32 in shared memory, exact f32 dots per (edge,
// column).

#include "k3_messages.cuh"

extern "C" int k3_messages_wbf16(const float* x, const __nv_bfloat16* w, const int* src,
                                 const float* val, const int* tile_rel, void* out,
                                 int num_tiles, int tile, int din, int dout, int out_bf16,
                                 void* stream) {
  if (out_bf16)
    return k3::dispatch_wbf16<__nv_bfloat16>(x, w, src, val, tile_rel,
                                             static_cast<__nv_bfloat16*>(out), num_tiles, tile,
                                             din, dout, stream);
  return k3::dispatch_wbf16<float>(x, w, src, val, tile_rel, static_cast<float*>(out),
                                   num_tiles, tile, din, dout, stream);
}
