// K3's kernels, templated on the operand types (TX for x, TW for W: f32 or
// bf16) and the message type TO (f32 or bf16). The f32 form
// (k3_messages.cu) instantiates f32 operands and messages; the bf16 form
// (k3_messages_bf16.cu) bf16 operands with f32 or bf16 messages, and f32
// operands with bf16 messages; the bf16-weight form (k3_messages_wbf16.cu)
// f32 x and a bf16 W with f32 messages. Every form sums in f32, scales by
// val in f32 and rounds each message once to TO. The designs are described
// in k3_messages.cu (the f32 routes), k3_messages_bf16.cu (the bf16 ones)
// and k3_messages_wbf16.cu (the bf16-weight ones).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace k3 {

constexpr unsigned kFull = 0xffffffffu;

// one value of TX widened to f32 (exact for bf16), one f32 rounded to TO
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TO>
__device__ __forceinline__ TO narrow(float v) {
  if constexpr (sizeof(TO) == 4) return v;
  else return __float2bfloat16_rn(v);
}

// two adjacent messages (p aligned to 2 elements)
template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b) {
  if constexpr (sizeof(TO) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
}

// four zero messages (p aligned to 4 elements)
template <typename TO>
__device__ __forceinline__ void store4_zero(TO* p) {
  if constexpr (sizeof(TO) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
  }
}

// ---- small route -----------------------------------------------------------

constexpr int kSmallThreads = 128;
constexpr int kSmallDoutMax = 32;
constexpr int kSmallSmemFloats = 48 * 1024 / 4;

// VX values of an x row as f32: 8 bf16 in one 16-byte load, or one value
template <int VX, typename TX>
__device__ __forceinline__ void load_x(const TX* __restrict__ p, float (&v)[VX]) {
  if constexpr (VX == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __bfloat162float(__ushort_as_bfloat16(
          static_cast<unsigned short>(w[e / 2] >> (16 * (e % 2)))));
  } else {
    v[0] = widen(p[0]);
  }
}

// One CTA per tile stages W[rel] (widened to f32) in shared memory; each
// thread computes (edge, column) dots in f32, skipping rows whose val is 0.
template <typename TX, typename TW, typename TO, int VX>
__global__ void __launch_bounds__(kSmallThreads)
k3_small_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                const int* __restrict__ src, const float* __restrict__ val,
                const int* __restrict__ tile_rel, TO* __restrict__ out,
                int tile, int din, int dout) {
  extern __shared__ float w_s[];
  const int t = blockIdx.x;
  const TW* wr = w + static_cast<long long>(tile_rel[t]) * din * dout;
  for (int i = threadIdx.x; i < din * dout; i += blockDim.x) w_s[i] = widen(wr[i]);
  __syncthreads();
  const long long e0 = static_cast<long long>(t) * tile;
  for (int k = threadIdx.x; k < tile * dout; k += blockDim.x) {
    const long long e = e0 + k / dout;
    const int o = k % dout;
    const float v = val[e];
    float m = 0.f;
    if (v != 0.f) {
      const TX* xr = x + static_cast<long long>(src[e]) * din;
      for (int i = 0; i < din; i += VX) {
        float xv[VX];
        load_x<VX>(xr + i, xv);
#pragma unroll
        for (int u = 0; u < VX; ++u) m = fmaf(xv[u], w_s[(i + u) * dout + o], m);
      }
    }
    out[e * dout + o] = narrow<TO>(m * v);
  }
}

// ---- tiled routes: shared pieces ---------------------------------------------

constexpr int kThreads = 256;  // 8 warps
constexpr int kWin = 64;       // rows of a CTA's window (up to four m16 tiles)
constexpr int kBN = 128;       // columns of a CTA's slice (a warp 16)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(gmem), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
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

// The window's rows compacted: rows with val != 0 go to srow/sval/live_at
// (their source, val and window row), the others get zeros stored in this
// slice's columns. Returns the count of live rows (block-uniform).
// kVecOut: dout % 4 == 0 and out aligned to 4 elements.
template <typename TO, bool kVecOut>
__device__ __forceinline__ int compact_window(const int* __restrict__ src,
                                              const float* __restrict__ val,
                                              TO* __restrict__ out, long long e0, int rows,
                                              int c0, int dout, int* srow, float* sval,
                                              int* live_at, int* dead_at, int* counts) {
  const int tid = threadIdx.x;
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
      counts[tid >> 5] = __popc(live_mask);
      counts[kWin / 32 + (tid >> 5)] = __popc(dead_mask);
    }
  }
  __syncthreads();
  int m = 0, z = 0, live_base = 0, dead_base = 0;
#pragma unroll
  for (int q = 0; q < kWin / 32; ++q) {
    if (q < (tid >> 5)) {
      live_base += counts[q];
      dead_base += counts[kWin / 32 + q];
    }
    m += counts[q];
    z += counts[kWin / 32 + q];
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
    TO* o = out + (e0 + dead_at[i / (kBN / 4)]) * dout;
    if (kVecOut) {
      if (c < dout) store4_zero<TO>(o + c);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < dout) o[c + u] = narrow<TO>(0.f);
    }
  }
  return m;
}

// The computed rows' sums times val, each element stored once; the sum of
// fragment (mt, nt) element u is row mt*16 + g (+8 for u >= 2), column
// nt*8 + 2*tq (+1 for odd u) of the warp's 16 (the m16n8 accumulator
// layout of both mma shapes).
template <typename TO, bool kVecOut>
__device__ __forceinline__ void store_rows(TO* __restrict__ out, long long e0, int m,
                                           int c0, int dout, int warp, int g, int tq,
                                           const float* sval, const int* live_at,
                                           const float (&acc)[4][2][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = mt * 16 + g + half * 8;
      if (ci >= m) continue;
      const float s = sval[ci];
      TO* o = out + (e0 + live_at[ci]) * dout;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = c0 + warp * 16 + nt * 8 + 2 * tq;
        const float v0 = acc[mt][nt][half * 2] * s, v1 = acc[mt][nt][half * 2 + 1] * s;
        if (kVecOut) {
          if (col < dout) store2<TO>(o + col, v0, v1);
        } else {
          if (col < dout) o[col] = narrow<TO>(v0);
          if (col + 1 < dout) o[col + 1] = narrow<TO>(v1);
        }
      }
    }
  }
}

// ---- tiled route, f32 operands (3xTF32 mma.sync) -------------------------------

// f = hi + lo: hi is f with its low 13 mantissa bits cleared (a tf32
// value), lo the exact f32 remainder, read by the tensor cores as tf32
__device__ __forceinline__ void split_tf32(float f, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(f) & 0xffffe000u;
  lo = __float_as_uint(f - __uint_as_float(hi));
}

// d += a (16 x 8, row-major fragment) * b (8 x 8, column fragment)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A CTA owns kWin rows and kBN columns (a warp 16); kBK-deep slabs in a
// kStages ring; 2 CTAs an SM bound the registers. TW: the W slab's values,
// float, or unsigned short (bf16 bits) for the bf16-weight form, whose W
// slab takes half the bytes (its B fragment loads stay conflict-free: a
// row of 136 halves is 68 words, 4 banks on from the row before).
template <typename TW = float>
struct K3Tiling {
  static constexpr int kBK = 32, kStages = 4, kMinBlocks = 2;
  static constexpr int kXStride = kBK + 4;  // A fragment loads conflict-free
  static constexpr int kWStride = kBN + 8;  // B fragment loads conflict-free
  static constexpr size_t kSmem = sizeof(float) * kStages * kWin * kXStride +
                                  sizeof(TW) * kStages * kBK * kWStride + sizeof(int) * 4 * kWin;
  static_assert(kBN == (kThreads / 32) * 16 && kWin % 32 == 0 && kBK % 8 == 0, "tiling");
};

// A W value's tf32 parts: an f32 value split as split_tf32 does; a bf16
// value (its bits) is exact in tf32 (8 of its 10 mantissa bits), so its
// high part is the value and its low part 0
__device__ __forceinline__ void split_w(float f, unsigned& hi, unsigned& lo) {
  split_tf32(f, hi, lo);
}
__device__ __forceinline__ void split_w(unsigned short b, unsigned& hi, unsigned& lo) {
  hi = static_cast<unsigned>(b) << 16;
  lo = 0u;
}

// kProbe (variants/k3_probe.cu only): bit 0 skips the MMAs, bit 1 the W
// slab loads, bit 2 the x slab loads (zero-filled instead)

// the pipelined k loop over kMT live m16 tiles; acc holds the f32 sums.
// An f32 W takes three passes (lo*hi + hi*lo + hi*hi); a bf16 W, whose low
// parts are 0, two (x_lo*W + x_hi*W)
template <int kMT, int kProbe, typename TW, class Load>
__device__ __forceinline__ void mma_steps(const float* xs_all, const TW* ws_all, int n_k,
                                          int warp, int g, int tq, Load load_stage,
                                          float (&acc)[4][2][4]) {
  using T = K3Tiling<TW>;
  constexpr int kBK = T::kBK, kS = T::kStages, kXS = T::kXStride, kWS = T::kWStride;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kS - 2>();
    __syncthreads();  // slab kt landed; slab kt - 1 is no longer read
    if (kt + kS - 1 < n_k) load_stage((kt + kS - 1) % kS, kt + kS - 1);
    cp_async_commit();
    if (kProbe & 1) continue;
    const float* xs = xs_all + (kt % kS) * kWin * kXS;
    const TW* ws = ws_all + (kt % kS) * kBK * kWS + warp * 16 + g;
    float part[kMT][2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) part[mt][nt][u] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      // fragments: A[g][tq], A[g+8][tq], A[g][tq+4], A[g+8][tq+4];
      // B[tq][g], B[tq+4][g]
      unsigned bh[2][2], bl[2][2], ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        split_w(ws[(k8 + tq) * kWS + nt * 8], bh[nt][0], bl[nt][0]);
        split_w(ws[(k8 + tq + 4) * kWS + nt * 8], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* xa = xs + (mt * 16 + g) * kXS + k8 + tq;
        split_tf32(xa[0], ah[mt][0], al[mt][0]);
        split_tf32(xa[8 * kXS], ah[mt][1], al[mt][1]);
        split_tf32(xa[4], ah[mt][2], al[mt][2]);
        split_tf32(xa[8 * kXS + 4], ah[mt][3], al[mt][3]);
      }
      // small terms first; independent tiles back to back
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_tf32(part[mt][nt], al[mt], bh[nt]);
      if constexpr (sizeof(TW) == 4) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_tf32(part[mt][nt], ah[mt], bl[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_tf32(part[mt][nt], ah[mt], bh[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[mt][nt][u] += part[mt][nt][u];
  }
}

// kVec: 16-byte x copies and 16-byte (f32) or 8-byte (bf16) W copies of 4
// values, else 4-byte x copies and 4-byte (f32) or plain 2-byte (bf16) W
// copies of one
template <bool kVec, int kProbe, typename TO, typename TW = float>
__global__ void __launch_bounds__(kThreads, K3Tiling<TW>::kMinBlocks)
k3_tiled_kernel(const float* __restrict__ x, const TW* __restrict__ w,
                const int* __restrict__ src, const float* __restrict__ val,
                const int* __restrict__ tile_rel, TO* __restrict__ out,
                int tile, int din, int dout, int slices, int windows) {
  using T = K3Tiling<TW>;
  constexpr int kBK = T::kBK, kS = T::kStages;
  constexpr int kXS = T::kXStride, kWS = T::kWStride;
  extern __shared__ __align__(16) float smem[];
  float* xs_all = smem;                         // [stage][kWin][kXS]
  TW* ws_all = reinterpret_cast<TW*>(xs_all + kS * kWin * kXS);  // [stage][kBK][kWS]
  int* srow = reinterpret_cast<int*>(ws_all + kS * kBK * kWS);  // src row
  float* sval = reinterpret_cast<float*>(srow + kWin);          // val
  int* live_at = reinterpret_cast<int*>(sval + kWin);  // window row, computed
  int* dead_at = live_at + kWin;                       // window row, zero
  __shared__ int counts[2 * (kWin / 32)];

  const int tid = threadIdx.x;
  const int slice = blockIdx.x % slices;
  const int tw = blockIdx.x / slices;
  const int t = tw / windows;
  const int r0 = (tw % windows) * kWin;
  const int rows = min(kWin, tile - r0);
  const long long e0 = static_cast<long long>(t) * tile + r0;
  const int c0 = slice * kBN;
  const TW* wr = w + static_cast<long long>(tile_rel[t]) * din * dout;

  const int m = compact_window<TO, kVec>(src, val, out, e0, rows, c0, dout, srow, sval,
                                         live_at, dead_at, counts);
  if (m == 0) return;

  const int m_pad = (m + 15) & ~15;  // whole m16 tiles
  const int n_k = (din + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int kt) {
    float* xs = xs_all + stage * kWin * kXS;
    TW* ws = ws_all + stage * kBK * kWS;
    const int k0 = kt * kBK;
    if (kVec) {
      for (int i = tid; i < m_pad * (kBK / 4); i += kThreads) {
        const int r = i / (kBK / 4), k = k0 + (i % (kBK / 4)) * 4;
        const bool ok = !(kProbe & 4) && r < m && k < din;
        cp_async16(xs + r * kXS + (k - k0),
                   ok ? x + static_cast<long long>(srow[r]) * din + k : x, ok);
      }
      for (int i = tid; i < kBK * (kBN / 4); i += kThreads) {
        const int kr = i / (kBN / 4), c = c0 + (i % (kBN / 4)) * 4;
        const bool ok = !(kProbe & 2) && k0 + kr < din && c < dout;
        const TW* gp = ok ? wr + static_cast<long long>(k0 + kr) * dout + c : w;
        if constexpr (sizeof(TW) == 4) cp_async16(ws + kr * kWS + (c - c0), gp, ok);
        else cp_async8(ws + kr * kWS + (c - c0), gp, ok);
      }
    } else {
      for (int i = tid; i < m_pad * kBK; i += kThreads) {
        const int r = i / kBK, k = k0 + i % kBK;
        const bool ok = !(kProbe & 4) && r < m && k < din;
        cp_async4(xs + r * kXS + (k - k0),
                  ok ? x + static_cast<long long>(srow[r]) * din + k : x, ok);
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int kr = i / kBN, c = c0 + i % kBN;
        const bool ok = !(kProbe & 2) && k0 + kr < din && c < dout;
        const TW* gp = ok ? wr + static_cast<long long>(k0 + kr) * dout + c : w;
        if constexpr (sizeof(TW) == 4) cp_async4(ws + kr * kWS + (c - c0), gp, ok);
        else ws[kr * kWS + (c - c0)] = ok ? *gp : static_cast<TW>(0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row / column groups
  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mt][nt][u] = 0.f;
  switch (m_pad / 16) {  // block-uniform: straight-line code per count
    case 1: mma_steps<1, kProbe, TW>(xs_all, ws_all, n_k, warp, g, tq, load_stage, acc); break;
    case 2: mma_steps<2, kProbe, TW>(xs_all, ws_all, n_k, warp, g, tq, load_stage, acc); break;
    case 3: mma_steps<3, kProbe, TW>(xs_all, ws_all, n_k, warp, g, tq, load_stage, acc); break;
    default: mma_steps<4, kProbe, TW>(xs_all, ws_all, n_k, warp, g, tq, load_stage, acc); break;
  }
  store_rows<TO, kVec>(out, e0, m, c0, dout, warp, g, tq, sval, live_at, acc);
}

// ---- tiled route, bf16 operands (one-pass bf16 mma.sync) -----------------------

// d += a (16 x 16 bf16, row-major fragment) * b (16 x 8 bf16, column
// fragment), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 values as one 32-bit fragment register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(unsigned short lo, unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// The f32 route's window and slice with bf16 slabs: a slab is kBK = 64
// values deep, so a stage holds as many bytes as the f32 route's 32.
struct K3TilingBf16 {
  static constexpr int kBK = 64, kStages = 4, kMinBlocks = 2;
  static constexpr int kXStride = kBK + 8;  // A fragment loads conflict-free
  static constexpr int kWStride = kBN + 8;  // B fragment loads conflict-free
  static constexpr size_t kSmem =
      sizeof(unsigned short) * kStages * (kWin * kXStride + kBK * kWStride) +
      sizeof(int) * 4 * kWin;
  static_assert(kBK % 16 == 0 && (kXStride * 2) % 16 == 0 && (kWStride * 2) % 16 == 0,
                "tiling");
};

template <int kMT, class Load>
__device__ __forceinline__ void mma_steps_bf16(const unsigned short* xs_all,
                                               const unsigned short* ws_all, int n_k,
                                               int warp, int g, int tq, Load load_stage,
                                               float (&acc)[4][2][4]) {
  using T = K3TilingBf16;
  constexpr int kBK = T::kBK, kS = T::kStages, kXS = T::kXStride, kWS = T::kWStride;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kS - 2>();
    __syncthreads();  // slab kt landed; slab kt - 1 is no longer read
    if (kt + kS - 1 < n_k) load_stage((kt + kS - 1) % kS, kt + kS - 1);
    cp_async_commit();
    const unsigned short* xs = xs_all + (kt % kS) * kWin * kXS;
    const unsigned short* ws = ws_all + (kt % kS) * kBK * kWS + warp * 16 + g;
    float part[kMT][2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) part[mt][nt][u] = 0.f;
#pragma unroll
    for (int k16 = 0; k16 < kBK; k16 += 16) {
      // fragments: A[g][2tq:+2], A[g+8][2tq:+2], A[g][2tq+8:+2],
      // A[g+8][2tq+8:+2]; B[2tq:+2][g], B[2tq+8:+2][g]
      unsigned b[2][2], a[kMT][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const unsigned short* wb = ws + (k16 + 2 * tq) * kWS + nt * 8;
        b[nt][0] = pack_bf16(wb[0], wb[kWS]);
        b[nt][1] = pack_bf16(wb[8 * kWS], wb[9 * kWS]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const unsigned short* xa = xs + (mt * 16 + g) * kXS + k16 + 2 * tq;
        a[mt][0] = *reinterpret_cast<const unsigned*>(xa);
        a[mt][1] = *reinterpret_cast<const unsigned*>(xa + 8 * kXS);
        a[mt][2] = *reinterpret_cast<const unsigned*>(xa + 8);
        a[mt][3] = *reinterpret_cast<const unsigned*>(xa + 8 * kXS + 8);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(part[mt][nt], a[mt], b[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[mt][nt][u] += part[mt][nt][u];
  }
}

// kE: bf16 values per copy, 8 (16-byte cp.async), 4 (8-byte cp.async) or 1
// (plain loads and stores into the slab); kE > 1 also stores 4 messages
// (zeros) and 2 (sums) at a time.
template <int kE, typename TO>
__global__ void __launch_bounds__(kThreads, K3TilingBf16::kMinBlocks)
k3_tiled_bf16_kernel(const __nv_bfloat16* __restrict__ x_in,
                     const __nv_bfloat16* __restrict__ w_in,
                     const int* __restrict__ src, const float* __restrict__ val,
                     const int* __restrict__ tile_rel, TO* __restrict__ out,
                     int tile, int din, int dout, int slices, int windows) {
  using T = K3TilingBf16;
  constexpr int kBK = T::kBK, kS = T::kStages;
  constexpr int kXS = T::kXStride, kWS = T::kWStride;
  const unsigned short* x = reinterpret_cast<const unsigned short*>(x_in);
  const unsigned short* w = reinterpret_cast<const unsigned short*>(w_in);
  extern __shared__ __align__(16) unsigned short smem_b[];
  unsigned short* xs_all = smem_b;                  // [stage][kWin][kXS]
  unsigned short* ws_all = xs_all + kS * kWin * kXS;  // [stage][kBK][kWS]
  int* srow = reinterpret_cast<int*>(ws_all + kS * kBK * kWS);  // src row
  float* sval = reinterpret_cast<float*>(srow + kWin);          // val
  int* live_at = reinterpret_cast<int*>(sval + kWin);  // window row, computed
  int* dead_at = live_at + kWin;                       // window row, zero
  __shared__ int counts[2 * (kWin / 32)];

  const int tid = threadIdx.x;
  const int slice = blockIdx.x % slices;
  const int tw = blockIdx.x / slices;
  const int t = tw / windows;
  const int r0 = (tw % windows) * kWin;
  const int rows = min(kWin, tile - r0);
  const long long e0 = static_cast<long long>(t) * tile + r0;
  const int c0 = slice * kBN;
  const unsigned short* wr = w + static_cast<long long>(tile_rel[t]) * din * dout;

  const int m = compact_window<TO, (kE > 1)>(src, val, out, e0, rows, c0, dout, srow, sval,
                                             live_at, dead_at, counts);
  if (m == 0) return;

  const int m_pad = (m + 15) & ~15;  // whole m16 tiles
  const int n_k = (din + kBK - 1) / kBK;

  // kE consecutive values of a row into the slab, zero past the operand
  auto copy = [&](unsigned short* s, const unsigned short* gp, bool ok) {
    if constexpr (kE == 8) {
      cp_async16(s, ok ? gp : w, ok);
    } else if constexpr (kE == 4) {
      cp_async8(s, ok ? gp : w, ok);
    } else {
      *s = ok ? *gp : static_cast<unsigned short>(0);
    }
  };
  auto load_stage = [&](int stage, int kt) {
    unsigned short* xs = xs_all + stage * kWin * kXS;
    unsigned short* ws = ws_all + stage * kBK * kWS;
    const int k0 = kt * kBK;
    for (int i = tid; i < m_pad * (kBK / kE); i += kThreads) {
      const int r = i / (kBK / kE), k = k0 + (i % (kBK / kE)) * kE;
      const bool ok = r < m && k < din;
      copy(xs + r * kXS + (k - k0), x + static_cast<long long>(ok ? srow[r] : 0) * din + k,
           ok);
    }
    for (int i = tid; i < kBK * (kBN / kE); i += kThreads) {
      const int kr = i / (kBN / kE), c = c0 + (i % (kBN / kE)) * kE;
      const bool ok = k0 + kr < din && c < dout;
      copy(ws + kr * kWS + (c - c0), wr + static_cast<long long>(k0 + kr) * dout + c, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row / column groups
  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mt][nt][u] = 0.f;
  switch (m_pad / 16) {  // block-uniform: straight-line code per count
    case 1: mma_steps_bf16<1>(xs_all, ws_all, n_k, warp, g, tq, load_stage, acc); break;
    case 2: mma_steps_bf16<2>(xs_all, ws_all, n_k, warp, g, tq, load_stage, acc); break;
    case 3: mma_steps_bf16<3>(xs_all, ws_all, n_k, warp, g, tq, load_stage, acc); break;
    default: mma_steps_bf16<4>(xs_all, ws_all, n_k, warp, g, tq, load_stage, acc); break;
  }
  store_rows<TO, (kE > 1)>(out, e0, m, c0, dout, warp, g, tq, sval, live_at, acc);
}

// ---- launchers -------------------------------------------------------------------

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) & (bytes - 1u)) == 0;
}

template <class Kernel>
cudaError_t launch_tiled_kernel(Kernel kernel, size_t smem, int num_tiles, int tile,
                                int dout, cudaStream_t stream, long long& blocks,
                                int& slices, int& windows) {
  slices = (dout + kBN - 1) / kBN;
  windows = (tile + kWin - 1) / kWin;
  blocks = static_cast<long long>(num_tiles) * windows * slices;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kVec, int kProbe, typename TO, typename TW = float>
cudaError_t launch_tiled(const float* x, const TW* w, const int* src,
                         const float* val, const int* tile_rel, TO* out,
                         int num_tiles, int tile, int din, int dout,
                         cudaStream_t stream) {
  long long blocks;
  int slices, windows;
  const cudaError_t err = launch_tiled_kernel(k3_tiled_kernel<kVec, kProbe, TO, TW>,
                                              K3Tiling<TW>::kSmem, num_tiles, tile, dout,
                                              stream, blocks, slices, windows);
  if (err != cudaSuccess) return err;
  k3_tiled_kernel<kVec, kProbe, TO, TW>
      <<<static_cast<int>(blocks), kThreads, K3Tiling<TW>::kSmem, stream>>>(
          x, w, src, val, tile_rel, out, tile, din, dout, slices, windows);
  return cudaGetLastError();
}

template <int kE, typename TO>
cudaError_t launch_tiled_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                              const int* src, const float* val, const int* tile_rel,
                              TO* out, int num_tiles, int tile, int din, int dout,
                              cudaStream_t stream) {
  long long blocks;
  int slices, windows;
  const cudaError_t err = launch_tiled_kernel(k3_tiled_bf16_kernel<kE, TO>,
                                              K3TilingBf16::kSmem, num_tiles, tile, dout,
                                              stream, blocks, slices, windows);
  if (err != cudaSuccess) return err;
  k3_tiled_bf16_kernel<kE, TO>
      <<<static_cast<int>(blocks), kThreads, K3TilingBf16::kSmem, stream>>>(
          x, w, src, val, tile_rel, out, tile, din, dout, slices, windows);
  return cudaGetLastError();
}

inline bool small_route(int din, int dout) {
  return dout <= kSmallDoutMax && static_cast<long long>(din) * dout <= kSmallSmemFloats;
}

// f32 operands, TO messages: the small route, or the 3xTF32 tiled route
template <int kProbe, typename TO>
int dispatch_f32(const float* x, const float* w, const int* src, const float* val,
                 const int* tile_rel, TO* out, int num_tiles, int tile, int din, int dout,
                 void* stream) {
  if (num_tiles < 1 || tile < 1 || din < 0 || dout < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small_route(din, dout)) {
    k3_small_kernel<float, float, TO, 1><<<num_tiles, kSmallThreads, sizeof(float) * din * dout, s>>>(
        x, w, src, val, tile_rel, out, tile, din, dout);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = din % 4 == 0 && dout % 4 == 0 && aligned(x, 16) && aligned(w, 16) &&
                   aligned(out, 16);
  const cudaError_t err =
      vec ? launch_tiled<true, kProbe, TO>(x, w, src, val, tile_rel, out, num_tiles, tile,
                                           din, dout, s)
          : launch_tiled<false, kProbe, TO>(x, w, src, val, tile_rel, out, num_tiles, tile,
                                            din, dout, s);
  return static_cast<int>(err);
}

// bf16 operands, TO messages: the small route (16-byte x loads where din
// % 8 == 0), or the bf16 tiled route with 16-byte, 8-byte or 2-byte copies
template <typename TO>
int dispatch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const int* src,
                  const float* val, const int* tile_rel, TO* out, int num_tiles, int tile,
                  int din, int dout, void* stream) {
  if (num_tiles < 1 || tile < 1 || din < 0 || dout < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (small_route(din, dout)) {
    const size_t smem = sizeof(float) * din * dout;
    if (din % 8 == 0 && aligned(x, 16))
      k3_small_kernel<bf16, bf16, TO, 8><<<num_tiles, kSmallThreads, smem, s>>>(
          x, w, src, val, tile_rel, out, tile, din, dout);
    else
      k3_small_kernel<bf16, bf16, TO, 1><<<num_tiles, kSmallThreads, smem, s>>>(
          x, w, src, val, tile_rel, out, tile, din, dout);
    return static_cast<int>(cudaGetLastError());
  }
  const bool out4 = aligned(out, 4 * sizeof(TO));
  cudaError_t err;
  if (din % 8 == 0 && dout % 8 == 0 && aligned(x, 16) && aligned(w, 16) && out4)
    err = launch_tiled_bf16<8, TO>(x, w, src, val, tile_rel, out, num_tiles, tile, din,
                                   dout, s);
  else if (din % 4 == 0 && dout % 4 == 0 && aligned(x, 8) && aligned(w, 8) && out4)
    err = launch_tiled_bf16<4, TO>(x, w, src, val, tile_rel, out, num_tiles, tile, din,
                                   dout, s);
  else
    err = launch_tiled_bf16<1, TO>(x, w, src, val, tile_rel, out, num_tiles, tile, din,
                                   dout, s);
  return static_cast<int>(err);
}

// f32 x, bf16 W, TO messages: the small route (W[rel] widened to f32 in
// shared memory), or the tiled route with a bf16 W slab and two TF32
// passes (8-byte W copies and 16-byte x copies where din and dout are
// multiples of 4, else one value a copy)
template <typename TO>
int dispatch_wbf16(const float* x, const __nv_bfloat16* w, const int* src, const float* val,
                   const int* tile_rel, TO* out, int num_tiles, int tile, int din, int dout,
                   void* stream) {
  if (num_tiles < 1 || tile < 1 || din < 0 || dout < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small_route(din, dout)) {
    k3_small_kernel<float, __nv_bfloat16, TO, 1>
        <<<num_tiles, kSmallThreads, sizeof(float) * din * dout, s>>>(
            x, w, src, val, tile_rel, out, tile, din, dout);
    return static_cast<int>(cudaGetLastError());
  }
  using u16 = unsigned short;
  const u16* wb = reinterpret_cast<const u16*>(w);
  const bool vec = din % 4 == 0 && dout % 4 == 0 && aligned(x, 16) && aligned(w, 8) &&
                   aligned(out, 4 * sizeof(TO));
  const cudaError_t err =
      vec ? launch_tiled<true, 0, TO, u16>(x, wb, src, val, tile_rel, out, num_tiles, tile,
                                           din, dout, s)
          : launch_tiled<false, 0, TO, u16>(x, wb, src, val, tile_rel, out, num_tiles, tile,
                                            din, dout, s);
  return static_cast<int>(err);
}

}  // namespace k3
