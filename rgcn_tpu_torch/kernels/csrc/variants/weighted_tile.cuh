// K4's and K5's rejected design: a shared-memory tile per (chunk, column
// slice), written to a node-major output once (sm_90a). No serving path
// launches it; variants/k45_smem_tile.cu binds it, and
// rgcn_tpu_torch/compare_k4_k5.py times it beside K4 and K5
// (weighted_runs.cuh), which sum each destination's run in registers over
// all din columns and write it straight from there instead.
//
// Frame. Slot t of chunk c (global slot l = c * CH + t) holds one source
// row src[l] and KK lanes; lane k targets node chunk_block[c] * RB +
// local[k * L + l] (local == RB: an empty lane) with the weight
// w[(k * NB + b) * L + l] for basis b < NB. K4 is the frame with KK = 1
// (a DstLayout: local_dst, w (NB, L)); K5 the source-dedup'd frame (local_k
// (KK, L), w_k (KK, NB, L)). The output is node-major, out[n][o][col] with
// o < NB_OUT, and each lane adds
//     shared rows (rows, din):        o = b:  w_b * x[src]
//                                     sum_bases (NB_OUT 1): (sum_b w_b) * x[src]
//     per-basis rows (NB, rows, din): o = b:  w_b * x[b][src]
//                                     sum_bases: sum_b w_b * x[b][src]
// Rows at or past num_nodes are dropped. A slot whose lanes are all empty
// is a pad: its src and weights are never read.
//
// Bound on the H100: bytes. 2 * NB flops per lane and column against the
// row gather (served mostly from the 50 MB L2) and one write of the whole
// output; at lp-WN18 (N 40,943, din 200, NB 2) that write is 65.5 MB of
// the ~83 MB the function must move.
//
// Design, one CTA per (chunk, slice of CW columns), CW chosen by the
// launcher so that an (RB x NB_OUT x CW) f32 tile fits a 48 KB budget:
//  1. The CTA zeroes the tile and counts its chunk's real lanes per local
//     destination (shared-memory integer atomics), stages the sources of
//     the slots that have a real lane, scans the counts into offsets, and
//     places every real lane at its destination's place (a counting sort).
//     Whatever order the frame has (K4's slots are destination-sorted, K5's
//     source-sorted), each destination's lanes are now contiguous.
//  2. The lanes are split evenly over groups of NV threads (NV = the
//     slice's 16-byte column vectors, scalars where din % 4 != 0 or a table
//     is not 16-byte aligned); a thread of a group owns one vector of
//     every lane in the group's span. It issues the row loads and weight
//     loads of several lanes before it sums them, and sums a run of one
//     destination in registers. A run that lies inside the span belongs to
//     this group alone and is stored into the tile; the first and last runs
//     may continue in the neighbouring spans and are added with
//     shared-memory atomics.
//  3. The tile goes to the output once. The CTA that holds the only chunk
//     of its row block (known from chunk_block[c - 1] and chunk_block[c + 1];
//     the builders give every row block at least one chunk and keep a
//     block's chunks adjacent) stores all RB rows of the block with plain
//     coalesced stores, the rows no lane reaches as zeros. The CTAs of a row
//     block with several chunks add the rows their lanes reach with vector
//     f32 atomics (red.global.add.v4.f32), into rows that a small launch
//     before (zero_multi_chunk_blocks) has zeroed. No other row is zeroed:
//     the launchers issue no memset of the output.
// Sums are taken in another order than a sequential sum (the counting
// sort and the atomics order lanes freely): results equal it up to f32
// reassociation.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace wtile {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;                    // row loads a thread issues before it sums
constexpr size_t kStaticSmem = 48 * 1024;    // above this only with the attribute set
constexpr size_t kMaxSmem = 232448;          // dynamic shared memory a block may use
constexpr int kTileBytes = 48 * 1024;       // shared-memory budget of the tile

struct Args {
  const float* x;          // (rows, din), or (NB, rows, din) per-basis tables
  const int* src;          // (L,)
  const float* w;          // (KK, NB, L)
  const int* local;        // (KK, L)
  const int* chunk_block;  // (n_chunks,)
  float* out;              // (num_nodes, NB_OUT, din)
  long long num_slots;     // L = n_chunks * CH
  long long table_plane;   // rows * din: the stride of per-basis tables
  int n_chunks, chunk, row_block, kk, din, num_nodes;
  int sum_bases;
  int cw;                  // columns of one CTA's slice (a multiple of 4)
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Exclusive scan of a[0, n) in place, a[n] = the total; blockDim.x threads,
// each a contiguous segment. Ends with the block synchronised.
__device__ void block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n);
  const int hi = min(lo + per, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int v = s;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, ws, d);
      if (lane >= d) ws += t;
    }
    if (lane < n_warps) warp_sums[lane] = ws;
  }
  __syncthreads();
  int run = v - s + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  if (threadIdx.x == 0) a[n] = warp_sums[n_warps - 1];
  __syncthreads();
}

// Shared-memory bytes of one CTA: the tile, the sorted lanes, the offsets
// and cursors, the staged sources, the scan's warp sums.
inline size_t smem_bytes(int row_block, int nb_out, int cw, int kk, int chunk) {
  return sizeof(float) * static_cast<size_t>(row_block) * nb_out * cw +
         sizeof(int2) * static_cast<size_t>(kk) * chunk +
         sizeof(int) * (2 * static_cast<size_t>(row_block) + 1 + chunk + kWarps);
}

// Zero the output rows of every row block that has more than one chunk
// (one CTA per chunk; the block's first chunk does it).
__global__ void zero_multi_chunk_blocks(const int* __restrict__ chunk_block,
                                        float* __restrict__ out, int n_chunks,
                                        int row_block, int row_len,
                                        int num_nodes) {
  const int c = blockIdx.x;
  const int blk = chunk_block[c];
  if ((c > 0 && chunk_block[c - 1] == blk) || c + 1 >= n_chunks ||
      chunk_block[c + 1] != blk)
    return;
  const long long r0 = static_cast<long long>(blk) * row_block;
  const long long r1 = min(r0 + row_block, static_cast<long long>(num_nodes));
  if (r1 <= r0) return;
  float* p = out + r0 * row_len;
  const long long n = (r1 - r0) * row_len;
  // scalars up to a 16-byte boundary, then vectors, then the scalar tail
  const long long head =
      min(n, static_cast<long long>((4 - (reinterpret_cast<std::uintptr_t>(p) / 4) % 4) % 4));
  if (threadIdx.x < head) p[threadIdx.x] = 0.f;
  float4* p4 = reinterpret_cast<float4*>(p + head);
  const long long n4 = (n - head) / 4;
  for (long long i = threadIdx.x; i < n4; i += blockDim.x)
    p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

template <int VEC, int NB>
__device__ __forceinline__ void flush_run(float* tile, const float (&acc)[NB][VEC],
                                          int row, int nb_out, int cw, int v,
                                          bool shared) {
#pragma unroll
  for (int o = 0; o < NB; ++o) {
    if (o >= nb_out) break;
    float* p = tile + (row * nb_out + o) * cw + v * VEC;
    if (shared) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) atomicAdd(p + e, acc[o][e]);
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
    } else {
      *p = acc[o][0];
    }
  }
}

template <int VEC, int NB, bool PER_BASIS>
__global__ void __launch_bounds__(kThreads) tile_kernel(const Args a) {
  constexpr int NX = PER_BASIS ? NB : 1;  // row loads per lane
  constexpr int B = PER_BASIS ? (kLoads / NB > 0 ? kLoads / NB : 1) : kLoads;
  extern __shared__ float4 smem4[];
  const int RB = a.row_block, CH = a.chunk;
  const int nb_out = a.sum_bases ? 1 : NB;
  float* tile = reinterpret_cast<float*>(smem4);
  const int tile_len = RB * nb_out * a.cw;
  int2* lanes = reinterpret_cast<int2*>(tile + tile_len);
  int* off = reinterpret_cast<int*>(lanes + a.kk * CH);  // RB + 1
  int* cursor = off + RB + 1;                            // RB
  int* s_src = cursor + RB;                              // CH
  int* warp_sums = s_src + CH;                           // kWarps

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const long long slot0 = static_cast<long long>(c) * CH;
  const int blk = a.chunk_block[c];
  const bool single = (c == 0 || a.chunk_block[c - 1] != blk) &&
                      (c == a.n_chunks - 1 || a.chunk_block[c + 1] != blk);
  const int col0 = blockIdx.y * a.cw;
  const int nvec = (min(a.cw, a.din - col0) + VEC - 1) / VEC;

  // 1. zero the tile and the counts; count lanes per destination; stage
  // the sources of slots with a real lane; sort the lanes by destination
  for (int i = tid; i < tile_len / 4; i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < RB; i += kThreads) off[i] = 0;
  __syncthreads();
  for (int t = tid; t < CH; t += kThreads) {
    bool real = false;
    for (int k = 0; k < a.kk; ++k) {
      const int ld = a.local[k * a.num_slots + slot0 + t];
      if (ld < RB) {
        atomicAdd(off + ld, 1);
        real = true;
      }
    }
    if (real) s_src[t] = a.src[slot0 + t];
  }
  __syncthreads();
  block_exclusive_scan(off, RB, warp_sums);
  for (int i = tid; i < RB; i += kThreads) cursor[i] = off[i];
  __syncthreads();
  for (int t = tid; t < CH; t += kThreads)
    for (int k = 0; k < a.kk; ++k) {
      const int ld = a.local[k * a.num_slots + slot0 + t];
      if (ld < RB) lanes[atomicAdd(cursor + ld, 1)] = make_int2(k * CH + t, ld);
    }
  __syncthreads();

  // 2. each group of nvec threads sums its span of lanes into the tile
  const int n_lanes = off[RB];
  const int groups = kThreads / nvec;
  const int g = tid / nvec, v = tid - g * nvec;
  const int span = (n_lanes + groups - 1) / groups;
  const int lo = g * span, hi = min(lo + span, n_lanes);
  if (g < groups && lo < hi) {
    const int prev_ld = lo > 0 ? lanes[lo - 1].y : -1;   // runs shared with
    const int next_ld = hi < n_lanes ? lanes[hi].y : -1;  // the neighbours
    const float* xc = a.x + col0 + v * VEC;
    float acc[NB][VEC];
#pragma unroll
    for (int o = 0; o < NB; ++o)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[o][e] = 0.f;
    int cur = lanes[lo].y;
    bool first = true;
    for (int i0 = lo; i0 < hi; i0 += B) {
      int ld[B];
      float wv[B][NB];
      float xv[B][NX][VEC];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        ld[j] = -1;
        if (i0 + j < hi) {
          const int2 e = lanes[i0 + j];
          const int k = e.x / CH, t = e.x - k * CH;
          const long long slot = slot0 + t;
          const long long row = static_cast<long long>(s_src[t]) * a.din;
          ld[j] = e.y;
#pragma unroll
          for (int b = 0; b < NB; ++b) wv[j][b] = __ldg(a.w + (k * NB + b) * a.num_slots + slot);
#pragma unroll
          for (int q = 0; q < NX; ++q) load_vec<VEC>(xc + q * a.table_plane + row, xv[j][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < B; ++j) {
        if (ld[j] < 0) break;  // past the span's end
        if (ld[j] != cur) {    // the run before ended inside the span
          flush_run<VEC, NB>(tile, acc, cur, nb_out, a.cw, v, first && cur == prev_ld);
#pragma unroll
          for (int o = 0; o < NB; ++o)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[o][e] = 0.f;
          cur = ld[j];
          first = false;
        }
        if (a.sum_bases) {
          if constexpr (PER_BASIS) {
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[0][e] += wv[j][b] * xv[j][b][e];
          } else {
            float ws = 0.f;
#pragma unroll
            for (int b = 0; b < NB; ++b) ws += wv[j][b];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[0][e] += ws * xv[j][0][e];
          }
        } else {
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[b][e] += wv[j][b] * xv[j][PER_BASIS ? b : 0][e];
        }
      }
    }
    flush_run<VEC, NB>(tile, acc, cur, nb_out, a.cw, v,
                       (first && cur == prev_ld) || cur == next_ld);
  }
  __syncthreads();

  // 3. the tile to the output, once
  const long long base = static_cast<long long>(blk) * RB;
  const int n_rows = static_cast<int>(min(static_cast<long long>(RB), a.num_nodes - base));
  const int per_row = nb_out * nvec;
  const long long row_len = static_cast<long long>(nb_out) * a.din;
  for (int i = tid; i < n_rows * per_row; i += kThreads) {
    const int r = i / per_row;
    if (!single && off[r + 1] == off[r]) continue;  // no lane of this chunk reaches row r
    const int o = (i - r * per_row) / nvec;
    const int vv = i - r * per_row - o * nvec;
    const float* p = tile + (r * nb_out + o) * a.cw + vv * VEC;
    float* q = a.out + (base + r) * row_len + o * a.din + col0 + vv * VEC;
    if constexpr (VEC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      if (single) *reinterpret_cast<float4*>(q) = t;
      else atomicAdd(reinterpret_cast<float4*>(q), t);
    } else {
      if (single) *q = *p;
      else atomicAdd(q, *p);
    }
  }
}

template <int VEC, int NB, bool PER_BASIS>
cudaError_t launch_tile(const Args& a, int n_slices, size_t smem, cudaStream_t st) {
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_kernel<VEC, NB, PER_BASIS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  tile_kernel<VEC, NB, PER_BASIS><<<dim3(a.n_chunks, n_slices), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool PER_BASIS>
cudaError_t dispatch(const Args& a, int nb, bool vec4, int n_slices, size_t smem,
                     cudaStream_t st) {
  switch (nb) {
#define WT_CASE(N)                                                               \
  case N:                                                                        \
    return vec4 ? launch_tile<4, N, PER_BASIS>(a, n_slices, smem, st)            \
                : launch_tile<1, N, PER_BASIS>(a, n_slices, smem, st);
    WT_CASE(1) WT_CASE(2) WT_CASE(3) WT_CASE(4)
    WT_CASE(5) WT_CASE(6) WT_CASE(7) WT_CASE(8)
#undef WT_CASE
  }
  return cudaErrorInvalidValue;
}

// Zero the multi-chunk row blocks' rows, then run the tile kernel (with
// per-basis tables when PER_BASIS). The slice width is the widest multiple
// of 4 columns (at most one vector per thread) whose tile fits kTileBytes,
// evened out over the slices din needs.
template <bool PER_BASIS>
cudaError_t run(Args a, int nb, cudaStream_t st) {
  if (a.n_chunks < 1 || a.chunk < 1 || a.row_block < 1 || a.din < 1 || a.kk < 1 ||
      nb < 1 || nb > 8)
    return cudaErrorInvalidValue;
  const int nb_out = a.sum_bases ? 1 : nb;
  const std::uintptr_t xs = reinterpret_cast<std::uintptr_t>(a.x);
  const std::uintptr_t os = reinterpret_cast<std::uintptr_t>(a.out);
  const bool vec4 = a.din % 4 == 0 && xs % 16 == 0 && os % 16 == 0;
  const long long per_col = 4LL * a.row_block * nb_out;
  const long long fit = kTileBytes / per_col;
  const int max_cols = static_cast<int>(
      std::max(4LL, std::min(fit, kThreads * (vec4 ? 4LL : 1LL)) / 4 * 4));
  const int want = (a.din + max_cols - 1) / max_cols;  // slices
  a.cw = ((a.din + want - 1) / want + 3) / 4 * 4;
  const int n_slices = (a.din + a.cw - 1) / a.cw;
  const size_t smem = smem_bytes(a.row_block, nb_out, a.cw, a.kk, a.chunk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  zero_multi_chunk_blocks<<<a.n_chunks, kThreads, 0, st>>>(
      a.chunk_block, a.out, a.n_chunks, a.row_block, nb_out * a.din, a.num_nodes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dispatch<PER_BASIS>(a, nb, vec4, n_slices, smem, st);
}

}  // namespace wtile
