// K1's kernels, templated on the message type: f32 (k1_aggregate.cu) or
// bf16 (k1_aggregate_bf16.cu), and on the output type, f32 or bf16. Sums
// are f32. Two routes, chosen by the wrapper from the layout
// (rgcn_tpu_torch.kernels.k1_route) and passed in; both take one launch,
// no memset and no atomics on the output, and sum in an order fixed by
// the layout (the same inputs give the same bits on every launch):
//  * kFixed, destination-sorted layouts (every builder's order but the
//    source-ordered one): k1_fixed_kernel below, owned rows. A CTA (a
//    unit) takes one span of a chunk and one column group; its lane
//    groups (4 values a lane, the row's last lane masked where dout % 4
//    != 0) sum runs of one destination in registers, merged across groups
//    in group order through shared memory; each row whose slots all lie in
//    the unit is stored once, the rows of its range no slot reaches as
//    zeros. A run that crosses a unit boundary (at most two a unit) and
//    ends within the next unit's first 32 slots is finished by the unit it
//    begins in, which reads those slots' messages itself (the next unit
//    drops its part): no wait on another CTA. Any other crossing run (a
//    hub) leaves each unit's part as f32 in a scratch of two rows a unit;
//    the last of the run's units to count in (atomicInc on a counter of
//    the run's first unit, found by ballots over the units' first slots,
//    so a hub may span any number of units) adds the parts in unit order
//    and stores the row once.
//  * kChunk, layouts ordered by source within their row blocks
//    (dst_sorted false, the JAX package's gather probe; no model path
//    builds one): chunk_sum.cuh, a CTA a chunk summing its slots by
//    destination in slot order, a block's chunks finished by their last
//    CTA in chunk order.
// The two designs kept before for AM-scale launches (memset and atomics;
// owned rows with atomics on the rows two CTAs share), in no fixed order,
// are variants/k1_atomic_routes.cuh's, for the comparison scripts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "chunk_sum.cuh"

namespace k1 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;  // warps of a CTA
constexpr int kBatch = 8;     // row loads a lane issues before it sums them

enum Route { kFixed = 0, kChunk = 1 };

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

// slots a lane group walks, and the warp's span of slots
template <int LPS>
__host__ __device__ constexpr int group_slots() { return LPS > 8 ? LPS : 8; }
template <int LPS>
__host__ __device__ constexpr int warp_span() { return 32 * (group_slots<LPS>() / LPS); }

// VEC f32 sums to VEC consecutive elements of an f32 or a bf16 row (each
// rounded once).
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <typename TO, int VEC>
__device__ __forceinline__ void store_vec(TO* p, const float (&v)[VEC]) {
  if constexpr (sizeof(TO) == 4) {
    if constexpr (VEC == 1) *reinterpret_cast<float*>(p) = v[0];
    else *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    if constexpr (VEC == 1) *p = __float2bfloat16_rn(v[0]);
    else *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
  }
}

// A lane's VEC values of a row in pieces of P values (P == VEC: one
// vector; else the first nvalid values, P at a time, the rest read as 0):
// rows that are not whole vectors or not aligned to them (nc-AM's width 10
// moves 8-byte pieces of f32, 4-byte pieces of bf16).
template <typename TM, int VEC, int P>
__device__ __forceinline__ void load_lane(const TM* __restrict__ p, float (&v)[VEC], int nvalid) {
  if constexpr (P == VEC) {
    load_vec<TM, VEC>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += P) {
      if (e < nvalid) {
        if constexpr (P == 1) {
          float t[1];
          load_vec<TM, 1>(p + e, t);
          v[e] = t[0];
        } else if constexpr (sizeof(TM) == 4) {
          const float2 t = __ldg(reinterpret_cast<const float2*>(p + e));
          v[e] = t.x;
          v[e + 1] = t.y;
        } else {
          const unsigned t = __ldg(reinterpret_cast<const unsigned*>(p + e));
          v[e] = __uint_as_float(t << 16);
          v[e + 1] = __uint_as_float(t & 0xffff0000u);
        }
      } else {
#pragma unroll
        for (int k = 0; k < P; ++k) v[e + k] = 0.f;
      }
    }
  }
}

// The first nvalid of a lane's VEC sums to a row, in pieces of P values.
template <typename TO, int VEC, int P>
__device__ __forceinline__ void store_lane(TO* p, const float (&v)[VEC], int nvalid) {
  if constexpr (P == VEC) {
    store_vec<TO, VEC>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += P) {
      if (e >= nvalid) break;
      if constexpr (P == 1) {
        const float t[1] = {v[e]};
        store_vec<TO, 1>(p + e, t);
      } else if constexpr (sizeof(TO) == 4) {
        *reinterpret_cast<float2*>(p + e) = make_float2(v[e], v[e + 1]);
      } else {
        *reinterpret_cast<unsigned*>(p + e) = bf16x2(v[e], v[e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- kFixed

// The units of a launch: unit u is part u % parts of chunk u / parts, slots
// [part * span, + span) of the chunk (the last part what is left).
struct Units {
  const int* local_dst;
  const int* chunk_block;
  int n_chunks, chunk, span, parts;
  long long* stamps;  // a probe's, as chunk_sum.cuh's; null on every serving path
  __device__ __forceinline__ long long start(int u) const {
    const int c = u / parts;
    return static_cast<long long>(c) * chunk + static_cast<long long>(u - c * parts) * span;
  }
  __device__ __forceinline__ int count() const { return n_chunks * parts; }
};

// For the 32 units v before a unit (back[j], v = u - 1 - j): the local
// destinations of v's first slot and of the slot before it, and those
// slots' row blocks; for the 32 after it (on[j], v = u + 1 + j): its first
// slot's local destination and row block. Out of range: local -2, block -1.
__device__ __forceinline__ int4 near_back(const Units& a, int v) {
  if (v < 0) return make_int4(-2, -2, -1, -1);
  const long long s0 = a.start(v);
  return s0 == 0 ? make_int4(a.local_dst[0], -2, a.chunk_block[0], -1)
                 : make_int4(a.local_dst[s0], a.local_dst[s0 - 1], a.chunk_block[s0 / a.chunk],
                             a.chunk_block[(s0 - 1) / a.chunk]);
}
__device__ __forceinline__ int2 near_on(const Units& a, int v) {
  if (v >= a.count()) return make_int2(-2, -1);
  const long long s0 = a.start(v);
  return make_int2(a.local_dst[s0], a.chunk_block[s0 / a.chunk]);
}

// Units [o, e] of the run of row r in block blk that unit u holds part of:
// o the unit its first slot lies in (u, or found back from u when
// ``back``), e the unit its last slot lies in (found on from u when
// ``on``). One warp, a unit a lane, 32 a step: the first step from what
// the unit read (back0, on0: a lane each), any further (a run over more
// than 33 units) from the layout. Every lane gets both.
__device__ __forceinline__ void run_units(const Units& a, const int4* back0, const int2* on0,
                                          int u, int blk, int r, bool back, bool on, int& o,
                                          int& e) {
  const int lane = threadIdx.x & 31;
  o = u;
  if (back) {  // the first unit v < u that does not begin inside the run
    for (int j0 = 1;; j0 += 32) {
      const int4 t = j0 == 1 ? back0[lane] : near_back(a, u - j0 - lane);
      const bool stop = t.x != r || t.y != r || t.w != blk;
      const unsigned m = __ballot_sync(kFull, stop);
      if (m) {
        o = u - j0 - (__ffs(m) - 1);
        break;
      }
    }
  }
  e = u;
  if (on) {  // the units after u that begin with row r in the block
    for (int j0 = 1;; j0 += 32) {
      const int2 t = j0 == 1 ? on0[lane] : near_on(a, u + j0 + lane);
      const unsigned m = __ballot_sync(kFull, t.x == r && t.y == blk);
      if (m != kFull) {
        e = u + j0 - 1 + (__ffs(~m) - 1);
        break;
      }
    }
  }
}

// Shared memory of a unit's CTA: its span's local_dst, one bit a row of the
// block (a slot of the span reaches it), each lane's partial row of VEC
// floats, and the unit's part of the run it hands on (dout floats).
// Slots of the next unit a unit reads to finish the run it hands on
// itself: a run that ends within the next unit's first kShortRun slots.
constexpr int kShortRun = 32;

// ... and, for that, the rows of those slots in the CTA's column group
// (kShortRun x LPS x VEC floats).
inline size_t fixed_smem(int span, int row_block, int warps, int vec, int dout, int lps) {
  return sizeof(int) * ((static_cast<size_t>(span) + (row_block + 31) / 32 + 3) & ~size_t{3}) +
         sizeof(float) * (static_cast<size_t>(warps) * 32 * vec + ((dout + 3) & ~3) +
                          static_cast<size_t>(kShortRun) * lps * vec);
}

// CTAs an SM the kernel is compiled for: at 8 lanes to a row (dout 17-32;
// e-RGCN nc-AM's diagonal width is 32) 4, 64 registers (at 5, 48
// registers, it spilled 272 bytes); elsewhere what its registers allow.
template <int VEC, int LPS>
__host__ __device__ constexpr int fixed_min_ctas() {
  return VEC == 4 && LPS == 8 ? 4 : 1;
}

// A row of the f32 scratch: dout rounded up to whole 4-value lanes.
__host__ __device__ constexpr int part_width(int dout) { return (dout + 3) & ~3; }

template <typename TM, typename TO, int VEC, int LPS, int PC>
__global__ void __launch_bounds__(32 * kMaxWarps, (fixed_min_ctas<VEC, LPS>()))
k1_fixed_kernel(const TM* __restrict__ msgs, const int* __restrict__ index, const Units a,
                TO* out, float* part, unsigned* counters, int row_block, int dout,
                int num_nodes) {
  constexpr int K = group_slots<LPS>();
  constexpr int M = K / LPS;  // slots whose local_dst and index a lane loads
  extern __shared__ __align__(16) int smem[];
  const int RB = row_block, span = a.span, chunk = a.chunk;
  const int n_words = (RB + 31) / 32;
  int* ld_s = smem;                                           // the span's local_dst
  unsigned* seen = reinterpret_cast<unsigned*>(smem + span);  // a bit a row
  // [group][lane q][VEC], on a 16-byte boundary (tail_s takes vector stores)
  float* gpart = reinterpret_cast<float*>(smem + ((span + n_words + 3) & ~3));
  float* tail_s = gpart + blockDim.x * VEC;  // this unit's part of a short run it hands on
  float* cont_s = tail_s + ((dout + 3) & ~3);  // that run's rows in the next unit, [slot][column]
  __shared__ int s_frame[5];  // block, blocks of the slots before and after, their locals
  __shared__ int s_next_ld[kShortRun];         // the next unit's first slots: local_dst
  __shared__ long long s_next_row[kShortRun];  // and message row
  __shared__ int s_run[2][3];  // per split run: first unit, last unit, 1 if this CTA finishes it
  __shared__ int4 s_prev;      // near_back of the unit before
  __shared__ int4 s_back[32];  // the 32 units before this one (near_back), for a long run
  __shared__ int2 s_on[32];    // and after it (near_on)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane % LPS;  // lane within its group
  const int g0 = lane - q;   // first lane of the group
  const int grp = warp * (32 / LPS) + lane / LPS;
  const int c = blockIdx.x, p = blockIdx.y, u = c * a.parts + p;
  // the CTA's column group: columns [c_lo, c_hi), LPS lanes of VEC values
  const int cg = blockIdx.z, c_lo = cg * LPS * VEC, c_hi = min(dout, c_lo + LPS * VEC);
  const int s0 = p * span;
  const int n = min(span, chunk - s0);  // the CTA's slots [s0, s0 + n) of chunk c
  const long long slot0 = static_cast<long long>(c) * chunk + s0;
  const long long total = static_cast<long long>(a.n_chunks) * chunk;
  csum::stamp(a.stamps, 0);

  // 1. staging, all loads at once: the span's slots (local_dst and index:
  // a pad's index is loaded and never used), the unit's frame (thread t <
  // 6) and the next unit's first slots (warp 0), read in case a run
  // crosses into it
  const int gfirst = grp * K;
  int ld[M];
  long long row[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int s = gfirst + q + LPS * t;
    ld[t] = RB;
    row[t] = 0;
    if (s < n) {
      ld[t] = a.local_dst[slot0 + s];
      row[t] = index ? static_cast<long long>(index[slot0 + s]) : slot0 + s;
    }
  }
  if (tid < 5) {
    int v;
    if (tid == 0) v = a.chunk_block[c];
    else if (tid == 1) v = s0 > 0 ? a.chunk_block[c] : (c > 0 ? a.chunk_block[c - 1] : -1);
    else if (tid == 2) v = s0 + n < chunk ? a.chunk_block[c] : (c + 1 < a.n_chunks ? a.chunk_block[c + 1] : -1);
    else if (tid == 3) v = slot0 > 0 ? a.local_dst[slot0 - 1] : -2;
    else v = slot0 + n < total ? a.local_dst[slot0 + n] : -2;
    s_frame[tid] = v;
  }
  // the next unit's slots: the rest of this chunk's, else the next chunk's
  const int n_next = s0 + n < chunk ? min(span, chunk - s0 - n)
                                    : (c + 1 < a.n_chunks ? min(span, chunk) : 0);
  if (tid == 5) s_prev = near_back(a, u - 1);  // is the unit before inside a run?
  if (warp == 0) {
    const long long sl = slot0 + n + lane;
    const bool in = lane < n_next;
    s_next_ld[lane] = in ? a.local_dst[sl] : -3;
    s_next_row[lane] = in ? (index ? static_cast<long long>(index[sl]) : sl) : 0;
  }
  for (int i = tid; i < n_words; i += blockDim.x) seen[i] = 0u;
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int s = gfirst + q + LPS * t;
    if (s < n) ld_s[s] = ld[t];
  }
  __syncthreads();
  csum::stamp(a.stamps, 1);
  // 2. the unit's place: rows [own_lo, own_hi) of the block are its, from
  // its first destination (0 for the block's first unit) to the next
  // unit's (RB for the block's last), less the at most two rows it shares
  // with the units beside it (split_lo, split_hi)
  const int blk = s_frame[0];
  const bool first = s_frame[1] != blk, last = s_frame[2] != blk;
  const int f = ld_s[0], l = ld_s[n - 1];
  const int before = first ? -1 : s_frame[3];
  const int after = last ? RB : s_frame[4];
  const int own_lo = first ? 0 : f, own_hi = after;
  const bool head_split = !first && f < RB && before == f;
  const bool tail_split = !last && l < RB && after == l;
  const bool middle = head_split && tail_split && f == l;  // one run, both ends split
  // A run that crosses into the next unit and ends within its first
  // kShortRun slots, having begun in this unit, is this unit's: it adds
  // the run's slots in the next unit to its own part and stores the row
  // (short_tail), and the next unit drops its part (short_head, the same
  // test from its side). Any other split run is finished from the units'
  // parts by the last of them.
  int lt = 0, lh = 0;
  while (lt < kShortRun && lt < n_next && s_next_ld[lt] == l) ++lt;
  while (lh < kShortRun && lh < n && ld_s[lh] == f) ++lh;
  const int4 prev_unit = s_prev;
  const bool short_tail = tail_split && !middle && lt < n_next && lt < kShortRun;
  const bool short_head = head_split && !(prev_unit.x == f && prev_unit.y == f &&
                                          prev_unit.w == blk) &&
                          lh < n && lh < kShortRun;
  const int split_lo = head_split ? f : -1, split_hi = tail_split ? l : -1;
  // one bit a row a slot reaches, set by the first slot of each run
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int s = gfirst + q + LPS * t;
    if (ld[t] < RB && (s == 0 || ld_s[s - 1] != ld[t]))
      atomicOr(seen + (ld[t] >> 5), 1u << (ld[t] & 31));
  }
  const long long base = static_cast<long long>(blk) * RB;
  const bool finish_tail = short_tail && base + l < num_nodes;  // CTA-uniform
  // the destinations of the slots just before and after the group's, in
  // this unit: a run that goes on into a neighbouring group
  const int prev_ld = gfirst > 0 && gfirst <= n ? ld_s[gfirst - 1] : -1;
  const int next_ld = gfirst + K < n ? ld_s[gfirst + K] : -1;
  float* my_part = gpart + (grp * LPS + q) * VEC;
  // the unit's parts of its split runs: part[u][0] the run it continues,
  // part[u][1] the run it hands on
  const int dp = part_width(dout);
  float* part0 = part + static_cast<long long>(u) * 2 * dp;
  float* part1 = part0 + dp;

  // 3. the walk, over the CTA's column group
  {
    const int col = (cg * LPS + q) * VEC;
    const bool col_ok = col < dout;
    const int nvalid = dout - col;  // the lane's values in the row, if under VEC
    float acc[VEC] = {};
    int cur = -1;
    bool head = true;    // the current run is the group's first
    bool finish = false;
    // a run's sums over this unit to where they go: the unit's part of a
    // split run, else its output row (rows at or past num_nodes dropped)
    auto to_row = [&](int r) {
      if (!col_ok || base + r >= num_nodes) return;
      if (r == split_lo) {
        if (!short_head) store_vec<float, VEC>(part0 + col, acc);
      } else if (r == split_hi) {
        store_vec<float, VEC>((short_tail ? tail_s : part1) + col, acc);
      } else {
        store_lane<TO, VEC, PC>(out + (base + r) * dout + col, acc, nvalid);
      }
    };
    // a run ends: its row gets it, unless it goes on from the previous
    // group (left in shared memory) or into the next (kept for after the
    // barrier)
    auto end_run = [&](bool last_run) {
      if (head && cur == prev_ld) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) my_part[e] = acc[e];
      } else if (last_run && cur == next_ld) {
        finish = true;
      } else {
        to_row(cur);
      }
    };
#pragma unroll
    for (int jb = 0; jb < K; jb += kBatch) {
      int lj[kBatch];
      float v[kBatch][VEC];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int jj = jb + j;
        lj[j] = __shfl_sync(kFull, ld[jj / LPS], g0 + jj % LPS);
        const long long r = __shfl_sync(kFull, row[jj / LPS], g0 + jj % LPS);
        if (lj[j] < RB && col_ok) {
          load_lane<TM, VEC, PC>(msgs + r * dout + col, v[j], nvalid);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (lj[j] >= RB) continue;  // pad: group-uniform
        if (lj[j] != cur) {
          if (cur >= 0) {
            end_run(false);
            head = false;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
          cur = lj[j];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += v[j][e];
      }
    }
    if (cur >= 0) end_run(true);
    __syncthreads();
    if (finish) {  // add the partials of the groups the run goes on into, in order
      for (int g2 = grp + 1;; ++g2) {
        const float* p2 = gpart + (g2 * LPS + q) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += p2[e];
        const int nxt = (g2 + 1) * K;
        if (nxt >= n || ld_s[nxt] != cur) break;  // the run ends in group g2
      }
      to_row(cur);
    }
    __syncthreads();  // tail_s stored; the partials are free again
  }

  csum::stamp(a.stamps, 2);
  // 4. the owned rows no slot reaches: zeros, a warp a row
  const int own_end = static_cast<int>(min(static_cast<long long>(own_hi), num_nodes - base));
  const int warps = blockDim.x >> 5;
  const float zeros[VEC] = {};
  for (int r = own_lo + warp; r < own_end; r += warps) {
    if ((seen[r >> 5] >> (r & 31)) & 1u) continue;  // warp-uniform
    TO* pr = out + (base + r) * dout;
    for (int i = c_lo + lane * VEC; i < c_hi; i += 32 * VEC)
      store_lane<TO, VEC, PC>(pr + i, zeros, dout - i);
  }

  // 5. a short run handed on: this unit's part (tail_s, stored by the walk
  // before its last barrier), then the run's slots in the next unit in slot
  // order, to the row: their rows loaded all at once into cont_s, a (slot,
  // vector) a thread, then each vector's sum in slot order
  if (finish_tail) {  // CTA-uniform
    const int cols = (c_hi - c_lo + VEC - 1) / VEC;  // vectors of the column group
    for (int i = tid; i < lt * cols; i += blockDim.x) {
      const int j = i / cols, cv = i - j * cols;
      float v[VEC];
      load_lane<TM, VEC, PC>(msgs + s_next_row[j] * dout + c_lo + cv * VEC, v,
                            dout - c_lo - cv * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) cont_s[i * VEC + e] = v[e];
    }
    __syncthreads();
    for (int cv = tid; cv < cols; cv += blockDim.x) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = tail_s[c_lo + cv * VEC + e];
      for (int j = 0; j < lt; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += cont_s[(j * cols + cv) * VEC + e];
      store_lane<TO, VEC, PC>(out + (base + l) * dout + c_lo + cv * VEC, acc,
                             dout - c_lo - cv * VEC);
    }
  }

  // 6. the other split runs: this unit's parts are stored; count the unit
  // in on each run's counter (after a barrier, one thread's fence makes
  // the CTA's stores visible first); the last to arrive adds the run's
  // parts, part[o][1] then part[v][0] for v in (o, e], and stores its row
  csum::stamp(a.stamps, 3);
  const bool long_head = head_split && !short_head, long_tail = tail_split && !short_tail;
  if (!long_head && !long_tail) {  // CTA-uniform
    csum::stamp(a.stamps, 5);
    return;
  }
  __syncthreads();
  if (warp == 0) {
    // the units around this one: where a long run begins and ends
    s_back[lane] = near_back(a, u - 1 - lane);
    s_on[lane] = near_on(a, u + 1 + lane);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool has = k == 0 ? long_head : long_tail && !middle;
      int o = -1, e = -1, fin = 0;
      if (has) {
        const int r = k == 0 ? f : l;
        run_units(a, s_back, s_on, u, blk, r, k == 0, k == 1 || middle, o, e);
        if (lane == 0) {
          __threadfence();
          // a counter a (run's first unit, column group)
          unsigned* counter = counters + static_cast<long long>(o) * gridDim.z + cg;
          const unsigned old = atomicInc(counter, static_cast<unsigned>(e - o));
          fin = old == static_cast<unsigned>(e - o);
          if (fin) __threadfence();
        }
      }
      if (lane == 0) {
        s_run[k][0] = o;
        s_run[k][1] = e;
        s_run[k][2] = fin;
      }
    }
  }
  __syncthreads();
  csum::stamp(a.stamps, 4);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!s_run[k][2]) continue;  // CTA-uniform
    const int o = s_run[k][0], e = s_run[k][1];
    const long long r = base + (k == 0 ? f : l);
    if (r >= num_nodes) continue;
    TO* q_out = out + r * dout;
    // columns of VEC floats over the threads, the units split P ways where
    // the row has fewer columns than the CTA threads (a hub's run may span
    // hundreds of units), the P sums added in shared memory (the groups'
    // partials, free now) in a fixed order
    const int cols = (c_hi - c_lo + VEC - 1) / VEC;  // vectors of the column group
    const int T = blockDim.x;
    const int P = cols >= T ? 1 : T / cols;
    for (int c0 = 0; c0 < cols; c0 += T) {  // once where P > 1
      const int cc = c0 + (P == 1 ? tid : tid % cols), pp = P == 1 ? 0 : tid / cols;
      const bool on = cc < cols && pp < P;
      float s[VEC];
#pragma unroll
      for (int w = 0; w < VEC; ++w) s[w] = 0.f;
      if (on) {
#pragma unroll 4
        for (int v = o + pp; v <= e; v += P) {
          const float* src =
              part + (2 * static_cast<long long>(v) + (v == o)) * dp + c_lo + cc * VEC;
          if constexpr (VEC == 4) {
            const float4 t = __ldcg(reinterpret_cast<const float4*>(src));
            s[0] += t.x;
            s[1] += t.y;
            s[2] += t.z;
            s[3] += t.w;
          } else {
            s[0] += __ldcg(src);
          }
        }
      }
      if (P > 1) {
        if (on)
#pragma unroll
          for (int w = 0; w < VEC; ++w) gpart[(pp * cols + cc) * VEC + w] = s[w];
        __syncthreads();
        if (on && pp == 0)
          for (int p2 = 1; p2 < P; ++p2)
#pragma unroll
            for (int w = 0; w < VEC; ++w) s[w] += gpart[(p2 * cols + cc) * VEC + w];
        __syncthreads();
      }
      if (on && pp == 0) store_lane<TO, VEC, PC>(q_out + c_lo + cc * VEC, s, dout - c_lo - cc * VEC);
    }
  }
  if (a.stamps != nullptr && tid == 0)
    a.stamps[8 * (static_cast<long long>(u) * gridDim.z + cg) + 7] =
        s_run[0][2] + 2 * s_run[1][2];
  csum::stamp(a.stamps, 5);
}

// A unit's span of a chunk: at most kMaxWarps warps' slots.
inline int fixed_span(int lps, int chunk) {
  const int most = kMaxWarps * 32 * ((lps > 8 ? lps : 8) / lps);  // warp_span<lps>()
  return chunk < most ? chunk : most;
}

template <typename TM, typename TO, int VEC, int LPS, int P>
cudaError_t launch_fixed(const TM* msgs, const int* index, const int* local_dst,
                         const int* chunk_block, TO* out, float* part, unsigned* counters,
                         int n_chunks, int chunk, int row_block, int dout, int num_nodes,
                         cudaStream_t stream, long long* stamps) {
  const int span = fixed_span(LPS, chunk);
  const int warps = (span + warp_span<LPS>() - 1) / warp_span<LPS>();
  const int parts = (chunk + span - 1) / span;
  if (static_cast<long long>(n_chunks) * parts * 2 > INT_MAX / 32) return cudaErrorInvalidValue;
  const size_t smem = fixed_smem(span, row_block, warps, VEC, dout, LPS);
  const int n_groups = (dout + LPS * VEC - 1) / (LPS * VEC);
  const auto kernel = k1_fixed_kernel<TM, TO, VEC, LPS, P>;
  if (smem > 32 * 1024) {  // past 48 KB with the static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const Units a{local_dst, chunk_block, n_chunks, chunk, span, parts, stamps};
  kernel<<<dim3(n_chunks, parts, n_groups), 32 * warps, smem, stream>>>(
      msgs, index, a, out, part, counters, row_block, dout, num_nodes);
  return cudaGetLastError();
}

template <typename TM, typename TO, int P>
cudaError_t launch_fixed_lps(int lps, const TM* msgs, const int* index, const int* local_dst,
                             const int* chunk_block, TO* out, float* part, unsigned* counters,
                             int n_chunks, int chunk, int row_block, int dout, int num_nodes,
                             cudaStream_t stream, long long* stamps) {
  constexpr int VEC = 4;
  switch (lps) {
#define K1_FIXED_CASE(L)                                                                  \
  case L:                                                                                 \
    return launch_fixed<TM, TO, VEC, L, P>(msgs, index, local_dst, chunk_block, out, part, \
                                           counters, n_chunks, chunk, row_block, dout,     \
                                           num_nodes, stream, stamps);
    K1_FIXED_CASE(1) K1_FIXED_CASE(2) K1_FIXED_CASE(4) K1_FIXED_CASE(8)
    K1_FIXED_CASE(16) K1_FIXED_CASE(32)
#undef K1_FIXED_CASE
  }
  return cudaErrorInvalidValue;
}

// The values a load or store of a lane moves (kernels.k1_piece): all 4 of
// its values where rows are whole lanes of an aligned message table, else
// 2 (dout even, the table aligned to 2 values), else 1.
template <typename TM>
inline int lane_piece(const TM* msgs, int dout) {
  const auto addr = reinterpret_cast<std::uintptr_t>(msgs);
  int p = 4;
  while (p > 1 && (dout % p != 0 || addr % (p * sizeof(TM)) != 0)) p /= 2;
  return p;
}

template <typename TM, typename TO>
cudaError_t launch_fixed_piece(int piece, int lps, const TM* msgs, const int* index,
                               const int* local_dst, const int* chunk_block, TO* out,
                               float* part, unsigned* counters, int n_chunks, int chunk,
                               int row_block, int dout, int num_nodes, cudaStream_t stream,
                               long long* stamps) {
  switch (piece) {
    case 4:
      return launch_fixed_lps<TM, TO, 4>(lps, msgs, index, local_dst, chunk_block, out, part,
                                         counters, n_chunks, chunk, row_block, dout, num_nodes,
                                         stream, stamps);
    case 2:
      return launch_fixed_lps<TM, TO, 2>(lps, msgs, index, local_dst, chunk_block, out, part,
                                         counters, n_chunks, chunk, row_block, dout, num_nodes,
                                         stream, stamps);
    case 1:
      return launch_fixed_lps<TM, TO, 1>(lps, msgs, index, local_dst, chunk_block, out, part,
                                         counters, n_chunks, chunk, row_block, dout, num_nodes,
                                         stream, stamps);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- kChunk

// chunk_sum.cuh's producer: a slot's message is its row of msgs (index[l],
// or l without an index), widened to f32.
template <typename TM>
struct Rows {
  const TM* msgs;
  const int* index;
  int dout;
  struct Slot {
    long long row;
  };
  __device__ __forceinline__ Slot load(long long slot) const {
    return {index ? static_cast<long long>(index[slot]) : slot};
  }
  __device__ __forceinline__ bool live(const Slot&) const { return true; }
  template <int KS>
  __device__ __forceinline__ void message(const Slot& s, int o0, int ns, float (&m)[KS]) const {
    const TM* r = msgs + s.row * dout + o0;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      if (j >= ns) break;
      if constexpr (sizeof(TM) == 4) m[j] = __ldg(reinterpret_cast<const float*>(r + j));
      else m[j] = __bfloat162float(r[j]);
    }
  }
};

// ---------------------------------------------------------------- run()

// The lanes: 4 values each (kFixed), LPS lanes a row, the power of two at
// least the row's lanes, at most 32 (kFixed gives each group of LPS x 4
// columns of a wider row a CTA of its own), a row's last lane masked where
// dout % 4 != 0; a lane's values moved in pieces (lane_piece). A bf16 lane
// keeps the f32 lane's 4 columns, so the warps' span of slots and the
// lanes on a row are the f32 form's (8 bf16 values a lane halve the lanes
// a row gets and double the slots a warp walks, which measured slower on
// the H100). ``scratch`` holds the route's f32 parts (kFixed: two rows a
// unit, each part_width(dout) wide; kChunk: an (RB, dout) tile a chunk),
// ``counters`` one zeroed counter a (unit, column group) or chunk; both
// are the wrapper's (rgcn_tpu_torch.kernels).
template <typename TM>
int run(const TM* msgs, const int* index, const int* local_dst, const int* chunk_block,
        void* out, float* scratch, unsigned* counters, int n_chunks, int chunk, int row_block,
        int dout, int num_nodes, int route, int out_bf16, void* stream,
        long long* stamps = nullptr) {
  if (n_chunks < 1 || chunk < 1 || dout < 1 || row_block < 1 || scratch == nullptr ||
      counters == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (route == kChunk) {
    const csum::Frame f{local_dst, chunk_block, out, scratch, counters,
                        n_chunks, chunk, row_block, dout, num_nodes, stamps};
    const Rows<TM> prod{msgs, index, dout};
    return static_cast<int>(out_bf16 ? csum::launch<Rows<TM>, bf16>(f, prod, st)
                                     : csum::launch<Rows<TM>, float>(f, prod, st));
  }
  if (route != kFixed) return cudaErrorInvalidValue;
  const auto al = [](const void* p, size_t b) { return reinterpret_cast<std::uintptr_t>(p) % b == 0; };
  if (!al(out, 16) || !al(scratch, 16)) return cudaErrorInvalidValue;
  const int lanes = (dout + 3) / 4;  // 4-value lanes a row
  int lps = 1;
  while (lps < lanes && lps < 32) lps *= 2;
  const int piece = lane_piece(msgs, dout);
  cudaError_t err;
  if (out_bf16)
    err = launch_fixed_piece<TM, bf16>(piece, lps, msgs, index, local_dst, chunk_block,
                                       static_cast<bf16*>(out), scratch, counters, n_chunks,
                                       chunk, row_block, dout, num_nodes, st, stamps);
  else
    err = launch_fixed_piece<TM, float>(piece, lps, msgs, index, local_dst, chunk_block,
                                        static_cast<float*>(out), scratch, counters, n_chunks,
                                        chunk, row_block, dout, num_nodes, st, stamps);
  return static_cast<int>(err);
}

}  // namespace k1
