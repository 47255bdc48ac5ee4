// K1's kernel, templated on the message type: f32 (k1_aggregate.cu) or bf16
// (k1_aggregate_bf16.cu). Sums are f32. The output is f32, or bf16
// (out_bf16, either message type): then the atomics add into an f32
// scratch of the output's shape and narrow_output rounds each element once
// from its whole f32 sum. The design is described in k1_aggregate.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace k1 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;  // warps of a CTA
constexpr int kBatch = 8;     // row loads a lane issues before it sums them

// VEC consecutive message values as f32: 4 values (a 16-byte f32 vector or
// an 8-byte bf16 one) or one scalar. bf16 widens through the cuda_bf16.h
// intrinsics, exactly.
template <typename TM, int VEC>
__device__ __forceinline__ void load_vec(const TM* __restrict__ p, float (&v)[VEC]) {
  if constexpr (sizeof(TM) == 4) {
    if constexpr (VEC == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = __ldg(reinterpret_cast<const float*>(p));
    }
  } else {
    if constexpr (VEC == 4) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      const unsigned w[2] = {t.x, t.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = __bfloat162float(__ushort_as_bfloat16(
            static_cast<unsigned short>(w[e / 2] >> (16 * (e % 2)))));
    } else {
      v[0] = __bfloat162float(
          __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
    }
  }
}

template <int VEC>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    atomicAdd(p, v[0]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      atomicAdd(reinterpret_cast<float4*>(p + e),
                make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]));
  }
}

// slots a lane group walks, and the warp's span of slots
template <int LPS>
__host__ __device__ constexpr int group_slots() { return LPS > 8 ? LPS : 8; }
template <int LPS>
__host__ __device__ constexpr int warp_span() { return 32 * (group_slots<LPS>() / LPS); }

template <typename TM, int VEC, int LPS>
__global__ void __launch_bounds__(32 * kMaxWarps)
k1_aggregate_kernel(const TM* __restrict__ msgs,
                    const int* __restrict__ index,
                    const int* __restrict__ local_dst,
                    const int* __restrict__ chunk_block,
                    float* __restrict__ out,
                    int chunk, int row_block, int dout, int num_nodes) {
  constexpr int K = group_slots<LPS>();
  constexpr int M = K / LPS;  // slots whose local_dst and index a lane loads
  const int lane = threadIdx.x & 31;
  const int q = lane % LPS;   // lane within its group
  const int g0 = lane - q;    // first lane of the group
  const int c = blockIdx.x;
  const int first = (blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5)) * warp_span<LPS>();
  if (first >= chunk) return;  // a warp past the chunk: warp-uniform
  const int last = min(first + warp_span<LPS>(), chunk);
  const long long chunk0 = static_cast<long long>(c) * chunk;

  // the group's slot j lives in lane g0 + j % LPS, register j / LPS
  const int gfirst = first + (lane / LPS) * K;
  int ld[M];
  bool live = false;
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int s = gfirst + q + LPS * t;
    ld[t] = s < last ? local_dst[chunk0 + s] : row_block;
    live |= ld[t] < row_block;
  }
  if (!__any_sync(kFull, live)) return;  // a span of pads only: warp-uniform
  long long row[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const long long s = chunk0 + gfirst + q + LPS * t;
    row[t] = 0;
    if (ld[t] < row_block) row[t] = index ? static_cast<long long>(index[s]) : s;
  }
  const long long block_base = static_cast<long long>(chunk_block[c]) * row_block;

  const int n_groups = (dout + LPS * VEC - 1) / (LPS * VEC);
  for (int cg = 0; cg < n_groups; ++cg) {
    const int col = (cg * LPS + q) * VEC;
    const bool col_ok = col < dout;
    float acc[VEC] = {};
    int cur = -1;
#pragma unroll
    for (int jb = 0; jb < K; jb += kBatch) {
      int l[kBatch];
      float v[kBatch][VEC];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int jj = jb + j;
        l[j] = __shfl_sync(kFull, ld[jj / LPS], g0 + jj % LPS);
        const long long r = __shfl_sync(kFull, row[jj / LPS], g0 + jj % LPS);
        if (l[j] < row_block && col_ok) {
          load_vec<TM, VEC>(msgs + r * dout + col, v[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (l[j] >= row_block) continue;  // pad: group-uniform
        if (l[j] != cur) {
          if (cur >= 0 && col_ok && block_base + cur < num_nodes)
            add_vec<VEC>(out + (block_base + cur) * dout + col, acc);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
          cur = l[j];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += v[j][e];
      }
    }
    if (cur >= 0 && col_ok && block_base + cur < num_nodes)
      add_vec<VEC>(out + (block_base + cur) * dout + col, acc);
  }
}

template <typename TM, int VEC, int LPS>
cudaError_t launch(const TM* msgs, const int* index, const int* local_dst,
                   const int* chunk_block, float* out, int n_chunks, int chunk,
                   int row_block, int dout, int num_nodes, cudaStream_t stream) {
  const int warps = (chunk + warp_span<LPS>() - 1) / warp_span<LPS>();
  const int per_cta = warps < kMaxWarps ? warps : kMaxWarps;
  const dim3 grid(n_chunks, (warps + per_cta - 1) / per_cta);
  k1_aggregate_kernel<TM, VEC, LPS><<<grid, 32 * per_cta, 0, stream>>>(
      msgs, index, local_dst, chunk_block, out, chunk, row_block, dout,
      num_nodes);
  return cudaGetLastError();
}

template <typename TM, int VEC>
cudaError_t launch_vec(int lps, const TM* msgs, const int* index,
                       const int* local_dst, const int* chunk_block,
                       float* out, int n_chunks, int chunk, int row_block,
                       int dout, int num_nodes, cudaStream_t stream) {
  switch (lps) {
#define K1_CASE(L)                                                              \
  case L:                                                                       \
    return launch<TM, VEC, L>(msgs, index, local_dst, chunk_block, out,         \
                              n_chunks, chunk, row_block, dout, num_nodes,      \
                              stream);
    K1_CASE(1) K1_CASE(2) K1_CASE(4) K1_CASE(8) K1_CASE(16) K1_CASE(32)
#undef K1_CASE
  }
  return cudaErrorInvalidValue;
}

// After the sum, for a bf16 output: each element rounded once from its f32
// sum in the scratch.
__global__ void narrow_output(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                              long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += stride)
    out[i] = __float2bfloat16_rn(acc[i]);
}

// Zero the f32 sums on the stream (the output, or the scratch of a bf16
// output), then sum: lanes of 4 values (16 bytes of f32, 8 of bf16) when
// every row starts on such a boundary, scalar lanes else. Both message
// types take the same lane map: a bf16 lane keeps the f32 lane's 4
// columns, so the warps' span of slots and the lanes on a row are the f32
// form's (8 bf16 values a lane halve the lanes a row gets and double the
// slots a warp walks, which measured slower on the H100). A bf16 output is
// narrowed after.
template <typename TM>
int run(const TM* msgs, const int* index, const int* local_dst,
        const int* chunk_block, void* out, float* scratch, int n_chunks, int chunk,
        int row_block, int dout, int num_nodes, int out_bf16, void* stream) {
  if (n_chunks < 1 || chunk < 1 || dout < 1) return cudaErrorInvalidValue;
  if (out_bf16 && scratch == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc = out_bf16 ? scratch : static_cast<float*>(out);
  const long long n_out = static_cast<long long>(num_nodes) * dout;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * static_cast<size_t>(n_out), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kVec = 4;
  const bool wide = dout % kVec == 0 &&
                    reinterpret_cast<std::uintptr_t>(msgs) % (kVec * sizeof(TM)) == 0;
  const int units = wide ? dout / kVec : dout;  // vectors per row
  int lps = 1;
  while (lps < units && lps < 32) lps *= 2;
  err = wide ? launch_vec<TM, kVec>(lps, msgs, index, local_dst, chunk_block, acc,
                                    n_chunks, chunk, row_block, dout, num_nodes, st)
             : launch_vec<TM, 1>(lps, msgs, index, local_dst, chunk_block, acc,
                                 n_chunks, chunk, row_block, dout, num_nodes, st);
  if (err != cudaSuccess || !out_bf16 || n_out == 0) return static_cast<int>(err);
  constexpr int kNarrowThreads = 256;
  const long long want = (n_out + kNarrowThreads - 1) / kNarrowThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  narrow_output<<<blocks, kNarrowThreads, 0, st>>>(
      acc, static_cast<__nv_bfloat16*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k1
