// K1: segmented destination sum over a DstLayout, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_aggregate.py::aggregate_presorted_pallas
// (kernel _agg_kernel). Computes
//     out[n] = sum over layout slots l with destination n of msgs[row(l)]
// where slot l of chunk c targets node chunk_block[c] * RB + local_dst[l],
// local_dst == RB marks a pad (dropped), and row(l) = index[l] when an
// index (the layout's perm into edge-order messages) is given, else l.
// Rows at or past num_nodes are dropped.
//
// Bound on the H100: bytes, and in practice latency. The work is one add
// per real slot and column; the card must read each real slot's message
// row and index, the layout's local_dst, and write the output once (at
// nc-AIFB, dout 16: ~4.7 MB, ~1.4 us at 3.35 TB/s). What the time is made
// of instead is the chain of dependent loads (local_dst and index, then
// the message row) and how many of those chains run at once. Giving each
// row block to one CTA, as the TPU kernel's sequential grid suggests, left
// 65 CTAs on 132 SMs and walked the hub blocks (4,685 real slots against a
// median of 513) serially, about 160x the bound.
//
// Design. No CTA walks more than one chunk, and no warp more than a fixed
// span of it: the grid is (chunk, part of the chunk), so the hub blocks are
// spread over as many CTAs as they have chunks (261 chunks at nc-AIFB).
// Lanes map to (slot, 16-byte column vector): a row of dout floats takes
// LPS lanes (the power of two >= dout / 4, at most 32; wider rows loop
// over column groups), so a warp loads 8 slots' 64-byte rows at dout 16
// and 32 slots' rows at dout 4 in one instruction. A dout that is not a
// multiple of 4 (or an unaligned msgs) takes scalar lanes instead. Each
// group of LPS lanes walks K = max(8, LPS) consecutive slots: the group's
// lanes load those slots' local_dst once (one per lane, shared by
// shuffles), and a warp whose whole span holds pads returns after that
// one coalesced load and a vote, so a chunk of pads costs one check per
// warp. The lanes then load the real slots' index, issue all the row
// loads, and sum the rows in registers while the destination stays the
// same (build_dst_layout sorts each block's slots by destination),
// flushing each run with one vector f32 atomic (red.global.add.v4.f32). A
// destination that spans groups, warps or chunks is finished by those
// atomics; the launcher zeroes the output on the same stream first, so
// rows no real slot reaches come out zero. Atomics add in no fixed order:
// results equal a sequential f32 sum up to reassociation.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;  // warps of a CTA
constexpr int kBatch = 8;     // row loads a lane issues before it sums them

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

// slots a lane group walks, and the warp's span of slots
template <int LPS>
__host__ __device__ constexpr int group_slots() { return LPS > 8 ? LPS : 8; }
template <int LPS>
__host__ __device__ constexpr int warp_span() { return 32 * (group_slots<LPS>() / LPS); }

template <int VEC, int LPS>
__global__ void __launch_bounds__(32 * kMaxWarps)
k1_aggregate_kernel(const float* __restrict__ msgs,
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
          load_vec<VEC>(msgs + r * dout + col, v[j]);
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

template <int VEC, int LPS>
cudaError_t launch(const float* msgs, const int* index, const int* local_dst,
                   const int* chunk_block, float* out, int n_chunks, int chunk,
                   int row_block, int dout, int num_nodes, cudaStream_t stream) {
  const int warps = (chunk + warp_span<LPS>() - 1) / warp_span<LPS>();
  const int per_cta = warps < kMaxWarps ? warps : kMaxWarps;
  const dim3 grid(n_chunks, (warps + per_cta - 1) / per_cta);
  k1_aggregate_kernel<VEC, LPS><<<grid, 32 * per_cta, 0, stream>>>(
      msgs, index, local_dst, chunk_block, out, chunk, row_block, dout,
      num_nodes);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_vec(int lps, const float* msgs, const int* index,
                       const int* local_dst, const int* chunk_block,
                       float* out, int n_chunks, int chunk, int row_block,
                       int dout, int num_nodes, cudaStream_t stream) {
  switch (lps) {
#define K1_CASE(L)                                                            \
  case L:                                                                     \
    return launch<VEC, L>(msgs, index, local_dst, chunk_block, out, n_chunks, \
                          chunk, row_block, dout, num_nodes, stream);
    K1_CASE(1) K1_CASE(2) K1_CASE(4) K1_CASE(8) K1_CASE(16) K1_CASE(32)
#undef K1_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int k1_aggregate(const float* msgs, const int* index,
                            const int* local_dst, const int* chunk_block,
                            float* out, int n_chunks, int chunk,
                            int row_block, int dout, int num_nodes,
                            void* stream) {
  if (n_chunks < 1 || chunk < 1 || dout < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * static_cast<size_t>(num_nodes) * dout, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte lanes when every row starts on a 16-byte boundary
  const bool vec4 =
      dout % 4 == 0 && reinterpret_cast<std::uintptr_t>(msgs) % 16 == 0;
  const int units = vec4 ? dout / 4 : dout;  // vectors per row
  int lps = 1;
  while (lps < units && lps < 32) lps *= 2;
  err = vec4 ? launch_vec<4>(lps, msgs, index, local_dst, chunk_block, out,
                             n_chunks, chunk, row_block, dout, num_nodes, st)
             : launch_vec<1>(lps, msgs, index, local_dst, chunk_block, out,
                             n_chunks, chunk, row_block, dout, num_nodes, st);
  return static_cast<int>(err);
}
