// K3's first design (the design the current k3_messages.cu replaced), kept
// for comparison: python -m rgcn_tpu_torch.compare_k3 builds it and times
// it beside K3. Same arguments as k3_messages; entry point k3_edge_column.
//
// Replaces rgcn_tpu/ops/pallas_spmm.py::rel_spmm_messages (kernel
// _msgs_kernel). For each relation-uniform tile t of T edges computes
//     msgs[e] = (x[src[e]] @ W[tile_rel[t]]) * val[e]
// in edge order, (E_pad, dout) f32. Pads carry val 0, so their messages
// are 0.
//
// Bound on the H100: bytes. 2*din*dout flops per edge is negligible; the
// card must read x, W, src, val once and write the (E_pad, dout) messages.
//
// Design. The TPU kernel takes a materialized x[src] tile and re-DMAs
// W[tile_rel] only when the relation changes between sequential grid
// steps. Here one CTA owns one tile: it stages W[tile_rel] (din x dout
// f32) in shared memory when it fits 48 KB (else it reads W through L2),
// and gathers the source rows x[src] itself, so x[src] is never
// materialized. Threads walk (edge, output column) pairs, column-fastest,
// so each warp writes whole message rows, coalesced. Every output element
// is written once, a plain dot on CUDA-core FMAs: results match a
// sequential f32 dot up to FMA contraction. At nc-AIFB's fallback branch
// the grid is 480 CTAs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemFloats = 48 * 1024 / 4;

__global__ void __launch_bounds__(kThreads)
k3_messages_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ src, const float* __restrict__ val,
                   const int* __restrict__ tile_rel, float* __restrict__ out,
                   int tile, int din, int dout, int stage_w) {
  extern __shared__ float w_s[];
  const int t = blockIdx.x;
  const float* wr = w + static_cast<long long>(tile_rel[t]) * din * dout;
  if (stage_w) {  // uniform across the block
    for (int i = threadIdx.x; i < din * dout; i += blockDim.x) w_s[i] = wr[i];
    __syncthreads();
    wr = w_s;
  }
  const long long e0 = static_cast<long long>(t) * tile;
  for (int k = threadIdx.x; k < tile * dout; k += blockDim.x) {
    const long long e = e0 + k / dout;
    const int o = k % dout;
    const float* xr = x + static_cast<long long>(src[e]) * din;
    float m = 0.f;
    for (int i = 0; i < din; ++i) m = fmaf(xr[i], wr[i * dout + o], m);
    out[e * dout + o] = m * val[e];
  }
}

}  // namespace

extern "C" int k3_edge_column(const float* x, const float* w, const int* src,
                           const float* val, const int* tile_rel, float* out,
                           int num_tiles, int tile, int din, int dout,
                           void* stream) {
  if (num_tiles < 1) return cudaErrorInvalidValue;
  const int stage_w = din * dout <= kSmemFloats ? 1 : 0;
  const size_t smem = stage_w ? sizeof(float) * din * dout : 0;
  k3_messages_kernel<<<num_tiles, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, w, src, val, tile_rel, out, tile, din, dout, stage_w);
  return static_cast<int>(cudaGetLastError());
}
