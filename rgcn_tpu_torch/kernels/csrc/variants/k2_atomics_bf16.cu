// K2's bf16 form as designed before its fixed-order redesign (sm_90a): the
// quantum-a-CTA kernel with global f32 atomics into a memset output. No
// serving path launches it: rgcn_tpu_torch/compare_k1_k2.py builds it and
// times it beside the launcher (../k2_fused_bf16.cu). Entry point
// k2_atomics_bf16, K2's arguments before its redesign. It replaced
// rgcn_tpu/ops/pallas_fused.py::rel_spmm_fused (kernel _make_fused_kernel) with its default compute_dtype=bf16: x and W cast to
// bf16 (pallas_fused.py:376-378), each quantum's products of two bf16
// values summed in f32 (preferred_element_type=f32) and scaled by val in
// f32, each slot's message rounded to bf16 (the msgs_ref scratch,
// :339-343), and the one-hot destination sum of the bf16 messages taken in
// f32 into an f32 output (:346-349). Computes
//     out[n] = sum over fused slots l with destination n of
//              bf16(val[l] * (x[src[l]] @ W[quantum_rel[l / Q]]))
// with the layout contract of k2_atomics.cu (gap quanta -1, pad slots RB,
// rows at or past num_nodes dropped).
//
// Bound on the H100: bytes, and in practice latency, as the f32 form's,
// with half the x and W bytes: at nc-AIFB's layer 2 (x (N, 16), W (90, 16,
// 4)) the referenced x rows, W, the real slots' src and val and the layout
// once, and the f32 output once.
//
// Design: k2_atomics.cu's, on bf16 operands. One CTA per quantum (a gap
// quantum returns after its quantum_rel load) stages W[rel] in shared
// memory as bf16, half the f32 form's bytes; each thread takes one slot,
// gathers the x row in 16-byte vectors of 8 bf16 values (din % 8 == 0 and
// x 16-byte aligned; one value otherwise), widens each value exactly to
// f32, computes dout outputs in registers, 4 at a time from 8-byte shared
// loads of W (dout % 4 == 0; one at a time otherwise), scales them by val,
// rounds each to bf16 and widens it back, and adds it to the output with
// one vector f32 atomic per 4 outputs into an output the launcher zeroes
// on the same stream first. The atomics add bf16 values in no fixed
// order: results equal an f32 sum of the rounded messages up to
// reassociation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr size_t kStaticSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // per-block opt-in limit on sm_90

__device__ __forceinline__ float bf16_at(unsigned word, int half) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(word >> (16 * half))));
}

// VX values of an x row as f32: 8 bf16 in one 16-byte load, or one value
template <int VX>
__device__ __forceinline__ void load_x(const __nv_bfloat16* __restrict__ p, float (&v)[VX]) {
  if constexpr (VX == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = bf16_at(w[e / 2], e % 2);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// DO consecutive W values of one shared row as f32: 4 from one 8-byte
// load, or one
template <int DO>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float (&v)[DO]) {
  if constexpr (DO == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_at(t.x, 0); v[1] = bf16_at(t.x, 1);
    v[2] = bf16_at(t.y, 0); v[3] = bf16_at(t.y, 1);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int DO>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[DO]) {
  if constexpr (DO == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

template <int VX, int DO>
__global__ void __launch_bounds__(kMaxThreads)
k2_atomics_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w, const int* __restrict__ src,
                     const float* __restrict__ val, const int* __restrict__ local_dst,
                     const int* __restrict__ quantum_rel,
                     const int* __restrict__ chunk_block, float* __restrict__ out,
                     int din, int dout, int row_block, int chunk, int quantum,
                     int num_nodes) {
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem16);  // W[rel], din x dout
  const int rel = quantum_rel[blockIdx.x];
  if (rel < 0) return;  // gap quantum: CTA-uniform
  const int w_size = din * dout;
  const __nv_bfloat16* wr = w + static_cast<long long>(rel) * w_size;
  for (int i = threadIdx.x; i < w_size; i += blockDim.x) w_s[i] = wr[i];
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
    const __nv_bfloat16* xr = x + static_cast<long long>(s) * din;
    for (int o0 = 0; o0 < dout; o0 += DO) {
      float acc[DO];
#pragma unroll
      for (int o = 0; o < DO; ++o) acc[o] = 0.f;
#pragma unroll 2
      for (int i = 0; i < din; i += VX) {
        float xv[VX];
        load_x<VX>(xr + i, xv);
#pragma unroll
        for (int k = 0; k < VX; ++k) {
          float wv[DO];
          load_w<DO>(w_s + (i + k) * dout + o0, wv);
#pragma unroll
          for (int o = 0; o < DO; ++o) acc[o] = fmaf(xv[k], wv[o], acc[o]);
        }
      }
      // the message as the Pallas kernel keeps it: f32 sum times val,
      // rounded to bf16
#pragma unroll
      for (int o = 0; o < DO; ++o) acc[o] = __bfloat162float(__float2bfloat16_rn(acc[o] * v));
      add_vec<DO>(out + node * dout + o0, acc);
    }
  }
}

template <int VX, int DO>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const int* src,
                   const float* val, const int* local_dst, const int* quantum_rel,
                   const int* chunk_block, float* out, int n_quanta, int din, int dout,
                   int row_block, int chunk, int quantum, int num_nodes,
                   cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * din * dout;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        k2_atomics_bf16_kernel<VX, DO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = quantum < kMaxThreads ? (quantum + 31) / 32 * 32 : kMaxThreads;
  k2_atomics_bf16_kernel<VX, DO><<<n_quanta, threads, smem, stream>>>(
      x, w, src, val, local_dst, quantum_rel, chunk_block, out, din, dout, row_block,
      chunk, quantum, num_nodes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k2_atomics_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const int* src,
                             const float* val, const int* local_dst,
                             const int* quantum_rel, const int* chunk_block, float* out,
                             int n_quanta, int din, int dout, int row_block, int chunk,
                             int quantum, int num_nodes, void* stream) {
  if (n_quanta < 1 || din < 1 || dout < 1 || quantum < 1 || chunk % quantum)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * static_cast<size_t>(num_nodes) * dout, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte x gathers (8 values) when every row starts on a 16-byte
  // boundary; 4 outputs a step (8-byte W loads, vector atomics) when dout
  // is a multiple of 4
  const bool vx = din % 8 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const bool do4 = dout % 4 == 0;
  if (vx && do4)
    err = launch<8, 4>(x, w, src, val, local_dst, quantum_rel, chunk_block, out, n_quanta,
                       din, dout, row_block, chunk, quantum, num_nodes, st);
  else if (vx)
    err = launch<8, 1>(x, w, src, val, local_dst, quantum_rel, chunk_block, out, n_quanta,
                       din, dout, row_block, chunk, quantum, num_nodes, st);
  else if (do4)
    err = launch<1, 4>(x, w, src, val, local_dst, quantum_rel, chunk_block, out, n_quanta,
                       din, dout, row_block, chunk, quantum, num_nodes, st);
  else
    err = launch<1, 1>(x, w, src, val, local_dst, quantum_rel, chunk_block, out, n_quanta,
                       din, dout, row_block, chunk, quantum, num_nodes, st);
  return static_cast<int>(err);
}
