// K3: per-tile relational messages, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_spmm.py::rel_spmm_messages (kernel
// _msgs_kernel). For each relation-uniform tile t of T edges computes
//     msgs[e] = (x[src[e]] @ W[tile_rel[t]]) * val[e]
// in edge order, (E_pad, dout) f32. Rows whose val is 0 (pads, dropped
// edges) come out 0 and are not computed.
//
// Bound on the H100 at lp-FB-toy (the block layer's expanded weights: x
// (280, 500), W (224, 500, 500), 250 tiles of 128 holding 7,368 real rows,
// 77% of the slots pads): bytes, near the f32 ridge. The card must read W
// once (224 MB) and write the (32,000, 500) messages (64 MB): ~86 us at
// 3.35 TB/s, against 3.7 GFLOP of real rows, ~55 us at 67 TFLOP/s.
//
// Design (tiled route). One CTA per (tile window of at most 64 rows, slice
// of 128 output columns), slices fastest, so the CTAs of one tile, and the
// tiles of one relation (tile_rel is sorted), run side by side and share x
// rows and W[rel] in L2: W streams from memory about once. A tile is a
// relation's full tile (128 real rows) or its last, partial one. The CTA
// first compacts the window's rows with val != 0 (ballots) and stores
// zeros for the others; a window with none returns after that. The
// compacted rows' x[src] k-slabs and W[rel]'s (32 x 128) k-slabs stream
// through shared memory with cp.async in a 4-stage ring (zero-filled past
// din, dout and the last real row). Each warp owns 16 columns (two n8
// tiles) over the window's live m16 row tiles (the real rows rounded up to
// 16; the launcher's switch instantiates 1-4 of them) and multiplies with
// mma.sync m16n8k8 in 3xTF32: each f32 operand is split into a tf32 high
// part (its top mantissa bits, by masking) and the f32 remainder, and
// lo*hi + hi*lo + hi*hi are accumulated, which keeps about 21 bits of each
// product. Each 32-deep slab's products are summed on the tensor cores and
// added to the running f32 sums on the CUDA cores, so the tensor cores'
// reduced-precision accumulation spans 32 terms, not din. At lp-FB-toy the
// error against the plain f32 version is about a tenth of the port's
// tolerance 1e-5 * max(1, max|ref|) (chip_smoke.py prints it). The exact
// CUDA-core FMA design this replaced is variants/k3_ffma_tiled.cu: its FMA
// loop, one 16-byte shared load per 8 FMAs, ran at ~20 TFLOP/s and set its
// time. din or dout that is not a multiple of 4, or unaligned operands,
// take 4-byte copies instead.
//
// What holds it back now (compare_k3 --probe at lp-FB-toy): the kernel
// without its MMAs, moving every byte, and the kernel without its loads
// each take well over half the time; they overlap only in part.
//
// Small route. For dout <= 32 with W[rel] within 48 KB (nc-AIFB's fallback
// branch: din 16, dout 4, 480 tiles) 128-column slices would waste most of
// their work; there one CTA per tile stages W[rel] in shared memory and
// each thread computes (edge, column) dots in f32, skipping rows whose val
// is 0 (the design of variants/k3_edge_column.cu, which computed every
// row).
//
// The kernels live in k3_messages.cuh, templated on the operand and
// message types; this form instantiates f32 operands and f32 messages
// (k3_messages_bf16.cu the others).

#include "k3_messages.cuh"

namespace {

// K3's f32 form; kProbe as in k3_messages.cuh (variants/k3_probe.cu)
template <int kProbe>
int k3_dispatch(const float* x, const float* w, const int* src, const float* val,
                const int* tile_rel, float* out, int num_tiles, int tile, int din,
                int dout, void* stream) {
  return k3::dispatch_f32<kProbe, float>(x, w, src, val, tile_rel, out, num_tiles, tile,
                                         din, dout, stream);
}

}  // namespace

extern "C" int k3_messages(const float* x, const float* w, const int* src,
                           const float* val, const int* tile_rel, float* out,
                           int num_tiles, int tile, int din, int dout,
                           void* stream) {
  return k3_dispatch<0>(x, w, src, val, tile_rel, out, num_tiles, tile, din,
                        dout, stream);
}
