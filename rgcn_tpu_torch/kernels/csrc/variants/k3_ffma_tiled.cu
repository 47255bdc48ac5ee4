// K3's exact-f32 tiled route (CUDA-core FMAs), the design the 3xTF32
// tensor-core route of k3_messages.cu replaced, kept for comparison:
// python -m rgcn_tpu_torch.compare_k3 builds it and times it beside K3.
// Same arguments as k3_messages; entry point k3_ffma_tiled. The text below
// is that design's own.
//
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
// Design (tiled route). One CTA per (tile window of at most 128 rows,
// slice of 128 output columns), slices fastest, so the CTAs of one tile,
// and the tiles of one relation (tile_rel is sorted), run side by side and
// share x rows and W[rel] in L2: W streams from memory about once. A tile
// is a relation's full tile (128 real rows) or its last, partial one, so a
// CTA per tile loses nothing to a CTA per relation run. The CTA first
// compacts the window's rows with val != 0 (ballots) and stores zeros for
// the others; a window with none returns after that. The compacted rows'
// x[src] k-slabs and W[rel]'s (32 x 128) k-slabs stream through shared
// memory with cp.async in a 3-stage ring (zero-filled past din, dout and
// the last real row), so the loads of two slabs are in flight while one is
// computed. Each thread holds 4 rows x 4 columns of sums per 32 rows in
// registers (SGEMM-style register tiling; a warp covers 8 rows x 64
// columns, the 8 warps 32 rows x 128) and reads float4 of both slabs per 4
// k; a warp whose rows are all past the real rows skips the FMAs, so work
// follows the real rows rounded up to 8 and all 8 warps work for a tile of
// ~30 real rows. Plain f32 FMAs in ascending k: each sum equals a
// sequential f32 dot up to FMA contraction (no TF32). din or dout that is
// not a multiple of 4, or unaligned operands, take 4-byte copies instead.
//
// What held it back: the same kernel without its FMAs, moving every byte,
// took about 55% of its time, without any load about 90%: its FMA loop
// (4 x 4 tiles, one 16-byte shared load per 8 FMAs) ran at ~20 TFLOP/s.
//
// Small route. For dout <= 32 with W[rel] within 48 KB (nc-AIFB's fallback
// branch: din 16, dout 4, 480 tiles) 128-column slices would waste most of
// their work; there one CTA per tile stages W[rel] in shared memory and
// each thread computes (edge, column) dots, skipping rows whose val is 0
// (the design of variants/k3_edge_column.cu, which computed every row).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- small route -----------------------------------------------------------

constexpr int kSmallThreads = 128;
constexpr int kSmallDoutMax = 32;
constexpr int kSmallSmemFloats = 48 * 1024 / 4;

__global__ void __launch_bounds__(kSmallThreads)
k3_small_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ src, const float* __restrict__ val,
                const int* __restrict__ tile_rel, float* __restrict__ out,
                int tile, int din, int dout) {
  extern __shared__ float w_s[];
  const int t = blockIdx.x;
  const float* wr = w + static_cast<long long>(tile_rel[t]) * din * dout;
  for (int i = threadIdx.x; i < din * dout; i += blockDim.x) w_s[i] = wr[i];
  __syncthreads();
  const long long e0 = static_cast<long long>(t) * tile;
  for (int k = threadIdx.x; k < tile * dout; k += blockDim.x) {
    const long long e = e0 + k / dout;
    const int o = k % dout;
    const float v = val[e];
    float m = 0.f;
    if (v != 0.f) {
      const float* xr = x + static_cast<long long>(src[e]) * din;
      for (int i = 0; i < din; ++i) m = fmaf(xr[i], w_s[i * dout + o], m);
    }
    out[e * dout + o] = m * v;
  }
}

// ---- tiled route -----------------------------------------------------------

constexpr int kThreads = 256;  // 8 warps

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float lane_of(const float4& a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

// The tiling: a CTA owns a window of kWin = 128 tile rows and kBN = 128
// columns; a warp's lanes are kRG = 2 row groups of kCG = 16 column
// groups; a thread sums kTM = 4 rows x (kTN4 = 1 float4) columns; the 8
// warps are kWR = 4 rows of kWC = 2 columns of warp tiles (8 rows x 64
// columns); kJ = 4 row steps cover the window; 32-deep slabs in a 3-stage
// ring; 2 CTAs an SM bound the registers to 128.
struct K3Tiling {
  static constexpr int kCG = 16, kTM = 4, kTN4 = 1, kWC = 2;
  static constexpr int kBK = 32, kStages = 3, kWin = 128, kMinBlocks = 2;
  static constexpr int kRG = 32 / kCG;
  static constexpr int kWR = (kThreads / 32) / kWC;
  static constexpr int kWarpRows = kRG * kTM;
  static constexpr int kWarpCols = kCG * 4 * kTN4;
  static constexpr int kRowsPerJ = kWR * kWarpRows;
  static constexpr int kJ = kWin / kRowsPerJ;
  static constexpr int kBN = kWC * kWarpCols;
  static constexpr int kXStride = kBK + 4;  // float4 rows, no bank conflicts
  static constexpr size_t kSmem =
      sizeof(float) * kStages * (kWin * kXStride + kBK * kBN) + sizeof(int) * 4 * kWin;
  static_assert(kJ * kRowsPerJ == kWin && kWin % 32 == 0 && kWin <= kThreads &&
                kBK % 4 == 0, "tiling");
};

// kProbe: bit 0 skips the FMAs, bit 1 the W slab loads, bit 2 the x slab
// loads (the probes that measured this design; 0 here)
template <bool kVec, int kProbe>
__global__ void __launch_bounds__(kThreads, K3Tiling::kMinBlocks)
k3_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ src, const float* __restrict__ val,
                const int* __restrict__ tile_rel, float* __restrict__ out,
                int tile, int din, int dout, int slices, int windows) {
  using T = K3Tiling;
  constexpr int kBN = T::kBN, kBK = T::kBK, kStages = T::kStages;
  constexpr int kXStride = T::kXStride, kTM = T::kTM, kTN4 = T::kTN4;
  constexpr int kWin = T::kWin;
  extern __shared__ __align__(16) float smem[];
  float* xs_all = smem;                                // [stage][kWin][kXStride]
  float* ws_all = xs_all + kStages * kWin * kXStride;  // [stage][kBK][kBN]
  int* srow = reinterpret_cast<int*>(ws_all + kStages * kBK * kBN);  // src row
  float* sval = reinterpret_cast<float*>(srow + kWin);  // val
  int* live_at = reinterpret_cast<int*>(sval + kWin);   // window row, computed
  int* dead_at = live_at + kWin;                        // window row, zero
  __shared__ int counts[2][kWin / 32];

  const int tid = threadIdx.x;
  const int slice = blockIdx.x % slices;
  const int tw = blockIdx.x / slices;
  const int t = tw / windows;
  const int r0 = (tw % windows) * kWin;
  const int rows = min(kWin, tile - r0);
  const long long e0 = static_cast<long long>(t) * tile + r0;
  const int c0 = slice * kBN;
  const float* wr = w + static_cast<long long>(tile_rel[t]) * din * dout;

  // compact the window's rows: val != 0 are computed, the rest stored as 0
  bool live = false, dead = false;
  float v = 0.f;
  unsigned live_mask = 0, dead_mask = 0;
  if (tid < kWin) {
    if (tid < rows) {
      v = val[e0 + tid];
      live = v != 0.f;
      dead = !live;
    }
    live_mask = __ballot_sync(kFull, live);
    dead_mask = __ballot_sync(kFull, dead);
    if ((tid & 31) == 0) {
      counts[0][tid >> 5] = __popc(live_mask);
      counts[1][tid >> 5] = __popc(dead_mask);
    }
  }
  __syncthreads();
  int m = 0, z = 0, live_base = 0, dead_base = 0;
#pragma unroll
  for (int q = 0; q < kWin / 32; ++q) {
    if (q < (tid >> 5)) {
      live_base += counts[0][q];
      dead_base += counts[1][q];
    }
    m += counts[0][q];
    z += counts[1][q];
  }
  if (tid < kWin) {
    const unsigned below = (1u << (tid & 31)) - 1u;
    if (live) {
      const int p = live_base + __popc(live_mask & below);
      srow[p] = src[e0 + tid];
      sval[p] = v;
      live_at[p] = tid;
    } else if (dead) {
      dead_at[dead_base + __popc(dead_mask & below)] = tid;
    }
  }
  __syncthreads();

  // zero rows: plain stores of this slice's columns
  for (int i = tid; i < z * (kBN / 4); i += kThreads) {
    const int c = c0 + (i % (kBN / 4)) * 4;
    float* o = out + (e0 + dead_at[i / (kBN / 4)]) * dout;
    if (kVec) {
      if (c < dout) *reinterpret_cast<float4*>(o + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < dout) o[c + u] = 0.f;
    }
  }
  if (m == 0) return;

  // x rows are loaded up to the warp tile that holds the last real row
  const int m_pad = (m + T::kWarpRows - 1) / T::kWarpRows * T::kWarpRows;
  const int n_k = (din + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int kt) {
    float* xs = xs_all + stage * kWin * kXStride;
    float* ws = ws_all + stage * kBK * kBN;
    const int k0 = kt * kBK;
    if (kVec) {
      for (int i = tid; i < m_pad * (kBK / 4); i += kThreads) {
        const int r = i / (kBK / 4), k = k0 + (i % (kBK / 4)) * 4;
        const bool ok = !(kProbe & 4) && r < m && k < din;
        cp_async16(xs + r * kXStride + (k - k0),
                   ok ? x + static_cast<long long>(srow[r]) * din + k : x, ok);
      }
      for (int i = tid; i < kBK * (kBN / 4); i += kThreads) {
        const int kr = i / (kBN / 4), c = c0 + (i % (kBN / 4)) * 4;
        const bool ok = !(kProbe & 2) && k0 + kr < din && c < dout;
        cp_async16(ws + kr * kBN + (c - c0),
                   ok ? wr + static_cast<long long>(k0 + kr) * dout + c : w, ok);
      }
    } else {
      for (int i = tid; i < m_pad * kBK; i += kThreads) {
        const int r = i / kBK, k = k0 + i % kBK;
        const bool ok = !(kProbe & 4) && r < m && k < din;
        cp_async4(xs + r * kXStride + (k - k0),
                  ok ? x + static_cast<long long>(srow[r]) * din + k : x, ok);
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int kr = i / kBN, c = c0 + i % kBN;
        const bool ok = !(kProbe & 2) && k0 + kr < din && c < dout;
        cp_async4(ws + kr * kBN + (c - c0),
                  ok ? wr + static_cast<long long>(k0 + kr) * dout + c : w, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wrow = warp / T::kWC, wcol = warp % T::kWC;
  const int rg = lane / T::kCG, cg = lane % T::kCG;
  const int row0 = wrow * T::kWarpRows + rg * kTM;  // + j * kRowsPerJ + i
  const int col0 = wcol * T::kWarpCols + cg * 4;    // + h * kCG * 4 + u
  float acc[T::kJ][kTM][kTN4 * 4];
#pragma unroll
  for (int j = 0; j < T::kJ; ++j)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int u = 0; u < kTN4 * 4; ++u) acc[j][i][u] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab kt landed; slab kt - 1 is no longer read
    if (kt + kStages - 1 < n_k) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();

    const float* xs = xs_all + (kt % kStages) * kWin * kXStride;
    const float* ws = ws_all + (kt % kStages) * kBK * kBN + col0;
#pragma unroll
    for (int j = 0; j < T::kJ; ++j) {
      // warp-uniform: skip warp tiles past the real rows
      if ((kProbe & 1) || j * T::kRowsPerJ + wrow * T::kWarpRows >= m) continue;
      const float* xr = xs + (j * T::kRowsPerJ + row0) * kXStride;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 a[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          a[i] = *reinterpret_cast<const float4*>(xr + i * kXStride + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 b[kTN4];
#pragma unroll
          for (int h = 0; h < kTN4; ++h)
            b[h] = *reinterpret_cast<const float4*>(ws + (kk + q) * kBN + h * T::kCG * 4);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float av = lane_of(a[i], q);
#pragma unroll
            for (int h = 0; h < kTN4; ++h) {
              acc[j][i][h * 4 + 0] = fmaf(av, b[h].x, acc[j][i][h * 4 + 0]);
              acc[j][i][h * 4 + 1] = fmaf(av, b[h].y, acc[j][i][h * 4 + 1]);
              acc[j][i][h * 4 + 2] = fmaf(av, b[h].z, acc[j][i][h * 4 + 2]);
              acc[j][i][h * 4 + 3] = fmaf(av, b[h].w, acc[j][i][h * 4 + 3]);
            }
          }
        }
      }
    }
  }

  // computed rows: sums times val, each element stored once
#pragma unroll
  for (int j = 0; j < T::kJ; ++j) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int ci = j * T::kRowsPerJ + row0 + i;
      if (ci >= m) continue;
      const float s = sval[ci];
      float* o = out + (e0 + live_at[ci]) * dout;
#pragma unroll
      for (int h = 0; h < kTN4; ++h) {
        const int col = c0 + col0 + h * T::kCG * 4;
        if (kVec) {
          if (col < dout)
            *reinterpret_cast<float4*>(o + col) =
                make_float4(acc[j][i][h * 4] * s, acc[j][i][h * 4 + 1] * s,
                            acc[j][i][h * 4 + 2] * s, acc[j][i][h * 4 + 3] * s);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (col + u < dout) o[col + u] = acc[j][i][h * 4 + u] * s;
        }
      }
    }
  }
}

template <bool kVec, int kProbe>
cudaError_t launch_tiled(const float* x, const float* w, const int* src,
                         const float* val, const int* tile_rel, float* out,
                         int num_tiles, int tile, int din, int dout,
                         cudaStream_t stream) {
  using T = K3Tiling;
  const int slices = (dout + T::kBN - 1) / T::kBN;
  const int windows = (tile + T::kWin - 1) / T::kWin;
  const long long blocks = static_cast<long long>(num_tiles) * windows * slices;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k3_tiled_kernel<kVec, kProbe>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  k3_tiled_kernel<kVec, kProbe><<<static_cast<int>(blocks), kThreads, T::kSmem, stream>>>(
      x, w, src, val, tile_rel, out, tile, din, dout, slices, windows);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <int kProbe>
int k3_dispatch(const float* x, const float* w, const int* src, const float* val,
                const int* tile_rel, float* out, int num_tiles, int tile, int din,
                int dout, void* stream) {
  if (num_tiles < 1 || tile < 1 || din < 0 || dout < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dout <= kSmallDoutMax && static_cast<long long>(din) * dout <= kSmallSmemFloats) {
    k3_small_kernel<<<num_tiles, kSmallThreads, sizeof(float) * din * dout, s>>>(
        x, w, src, val, tile_rel, out, tile, din, dout);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = din % 4 == 0 && dout % 4 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  const cudaError_t err =
      vec ? launch_tiled<true, kProbe>(x, w, src, val, tile_rel, out, num_tiles, tile,
                                       din, dout, s)
          : launch_tiled<false, kProbe>(x, w, src, val, tile_rel, out, num_tiles, tile,
                                        din, dout, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int k3_ffma_tiled(const float* x, const float* w, const int* src,
                           const float* val, const int* tile_rel, float* out,
                           int num_tiles, int tile, int din, int dout,
                           void* stream) {
  return k3_dispatch<0>(x, w, src, val, tile_rel, out, num_tiles, tile, din,
                        dout, stream);
}
