// K2's f32 form as designed before its fixed-order redesign (sm_90a): the
// quantum-a-CTA kernel with global f32 atomics into a memset output. No
// serving path launches it: rgcn_tpu_torch/compare_k1_k2.py builds it and
// times it beside the launcher (../k2_fused.cu), and variants/
// k2_fused_tile.cu reuses its per-slot product. Entry point k2_atomics_f32,
// K2's arguments before its redesign (no scratch, no counters). It replaced
// rgcn_tpu/ops/pallas_fused.py::rel_spmm_fused (kernel _make_fused_kernel).
// Computes
//     out[n] = sum over fused slots l with destination n of
//              val[l] * (x[src[l]] @ W[quantum_rel[l / Q]])
// Slots come in Q-slot quanta of one relation; quantum_rel == -1 marks a
// gap quantum (its slots carry val 0) and local_dst == RB a pad slot. Slot
// l of chunk c targets node chunk_block[c] * RB + local_dst[l]; rows at or
// past num_nodes are dropped.
//
// Bound on the H100: bytes, and in practice latency. The products are
// 2 * din * dout flops per real slot (~7 MFLOP at nc-AIFB layer 2, din 16,
// dout 4: nothing against 67 TFLOP/s f32); the card must read x, W, the
// real slots' src and val and the layout once and write the output once
// (~1.8 MB, ~0.5 us). Giving each row block to one CTA that stages all of
// W and walks the block's (slot, column) items serially, as the TPU
// kernel's sequential grid suggests, left 17 CTAs on 132 SMs reloading src
// and the x row once per output column, about 790x the bound.
//
// Design. The unit of work is one quantum: one CTA of Q threads (Q rounded
// up to a warp, at most 256; a larger quantum loops), 2,368 CTAs at
// nc-AIFB, so no CTA walks more than one chunk. A gap quantum returns after
// its one quantum_rel load. Otherwise the CTA stages W[rel] (din x dout,
// 256 B at nc-AIFB) in shared memory, the only relation it uses, and each
// thread takes one slot: it loads local_dst, src and val together, gathers
// the x row as 16-byte vectors, computes dout outputs in registers (4 at a
// time, W read from shared memory as broadcast float4s), scales them by
// val and adds them to the output with one vector f32 atomic per 4 outputs
// (red.global.add.v4.f32). The launcher zeroes the output on the same
// stream first, so rows no real slot reaches come out zero. Atomics add in
// no fixed order: results equal a sequential f32 sum up to reassociation.
// Summing each chunk in a shared-memory (RB x dout) tile first and
// flushing its non-zero entries (variants/k2_fused_tile.cu, timed beside
// this kernel by rgcn_tpu_torch/compare_k2.py) was 4.2x slower at nc-AIFB
// on an H100 80GB HBM3 at 700 W: every chunk pays a zeroed tile, two
// barriers and a full tile scan, and a hub row's slots queue on one
// shared-memory address.
//
// No tensor cores: at nc-AIFB a quantum's product is (<= 64 x 16) @ (16 x
// 4), ~7 MFLOP in all, and a 64-row wgmma tile with N = 4 would be mostly
// empty while the gather, not the product, sets the time. They pay once
// the product per slot outweighs its row gather, at widths of about 64 and
// up on both sides (din * dout >= 4096: 2 * din * dout flops per 4 * din
// bytes gathered passes the f32 CUDA-core ridge of ~20 flop/byte near dout
// 40, and the TF32 or bf16 tensor-core rates need dout >= 64 to fill an
// N tile).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr size_t kStaticSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // per-block opt-in limit on sm_90

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// acc[0..DO) = x row @ W[:, o0 : o0 + DO), x row gathered VX floats at a time
template <int VX, int DO>
__device__ __forceinline__ void row_times_w(const float* __restrict__ xr,
                                            const float* w_s, int din,
                                            int dout, int o0, float (&acc)[DO]) {
#pragma unroll
  for (int o = 0; o < DO; ++o) acc[o] = 0.f;
#pragma unroll 4
  for (int i = 0; i < din; i += VX) {
    float xv[VX];
    load_vec<VX>(xr + i, xv);
#pragma unroll
    for (int k = 0; k < VX; ++k) {
      const float* wk = w_s + (i + k) * dout + o0;
      if constexpr (DO == 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wk);
        acc[0] = fmaf(xv[k], wv.x, acc[0]);
        acc[1] = fmaf(xv[k], wv.y, acc[1]);
        acc[2] = fmaf(xv[k], wv.z, acc[2]);
        acc[3] = fmaf(xv[k], wv.w, acc[3]);
      } else {
        acc[0] = fmaf(xv[k], wk[0], acc[0]);
      }
    }
  }
}

template <int VX, int DO>
__global__ void __launch_bounds__(kMaxThreads)
k2_atomics_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ src, const float* __restrict__ val,
                const int* __restrict__ local_dst,
                const int* __restrict__ quantum_rel,
                const int* __restrict__ chunk_block,
                float* __restrict__ out, int din, int dout, int row_block,
                int chunk, int quantum, int num_nodes) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // W[rel], din x dout
  const int rel = quantum_rel[blockIdx.x];
  if (rel < 0) return;  // gap quantum: CTA-uniform
  const int w_size = din * dout;
  const float* wr = w + static_cast<long long>(rel) * w_size;
  for (int i = threadIdx.x; i < w_size; i += blockDim.x) w_s[i] = __ldg(wr + i);
  const long long slot0 = static_cast<long long>(blockIdx.x) * quantum;
  const long long block_base =
      static_cast<long long>(chunk_block[slot0 / chunk]) * row_block;
  __syncthreads();

  for (int t = threadIdx.x; t < quantum; t += blockDim.x) {
    const long long slot = slot0 + t;
    const int ld = local_dst[slot];
    const int s = src[slot];
    const float v = val[slot];
    const long long node = block_base + ld;
    if (ld >= row_block || node >= num_nodes) continue;  // pad, or dropped
    const float* xr = x + static_cast<long long>(s) * din;
    for (int o0 = 0; o0 < dout; o0 += DO) {
      float acc[DO];
      row_times_w<VX, DO>(xr, w_s, din, dout, o0, acc);
#pragma unroll
      for (int o = 0; o < DO; ++o) acc[o] *= v;
      add_vec<DO>(out + node * dout + o0, acc);
    }
  }
}

template <int VX, int DO>
cudaError_t launch(const float* x, const float* w, const int* src,
                   const float* val, const int* local_dst,
                   const int* quantum_rel, const int* chunk_block, float* out,
                   int n_quanta, int din, int dout, int row_block, int chunk,
                   int quantum, int num_nodes, cudaStream_t stream) {
  const size_t smem = sizeof(float) * din * dout;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        k2_atomics_kernel<VX, DO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = quantum < kMaxThreads ? (quantum + 31) / 32 * 32 : kMaxThreads;
  k2_atomics_kernel<VX, DO><<<n_quanta, threads, smem, stream>>>(
      x, w, src, val, local_dst, quantum_rel, chunk_block, out, din, dout,
      row_block, chunk, quantum, num_nodes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k2_atomics_f32(const float* x, const float* w, const int* src,
                        const float* val, const int* local_dst,
                        const int* quantum_rel, const int* chunk_block,
                        float* out, int n_quanta, int din, int dout,
                        int row_block, int chunk, int quantum, int num_nodes,
                        void* stream) {
  if (n_quanta < 1 || din < 1 || dout < 1 || quantum < 1 || chunk % quantum)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * static_cast<size_t>(num_nodes) * dout, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte x gathers when every row starts on a 16-byte boundary; 4
  // outputs a step (and vector atomics) when dout is a multiple of 4
  const bool vx = din % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const bool do4 = dout % 4 == 0;
  if (vx && do4)
    err = launch<4, 4>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,
                       n_quanta, din, dout, row_block, chunk, quantum, num_nodes, st);
  else if (vx)
    err = launch<4, 1>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,
                       n_quanta, din, dout, row_block, chunk, quantum, num_nodes, st);
  else if (do4)
    err = launch<1, 4>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,
                       n_quanta, din, dout, row_block, chunk, quantum, num_nodes, st);
  else
    err = launch<1, 1>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,
                       n_quanta, din, dout, row_block, chunk, quantum, num_nodes, st);
  return static_cast<int>(err);
}
