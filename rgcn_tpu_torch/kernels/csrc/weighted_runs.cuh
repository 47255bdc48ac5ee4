// The design K4 (k4_weighted_aggregate.cu) and K5
// (k5_weighted_aggregate_dedup.cu) share: a weighted destination sum over a
// chunked row-block frame, merged per destination on chip and written to a
// node-major output once, for Hopper (sm_90a).
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
// Design, one CTA per chunk, all din columns (the chunk's local, src and
// weights are read by one CTA, once):
//  1. The CTA counts its chunk's real lanes per local destination
//     (shared-memory atomics, one per distinct destination of a warp,
//     found with __match_any_sync), scans the counts into offsets, and
//     places every real lane, with its source row and its nb weights, at
//     its destination's place (a counting sort). Whatever order the frame
//     has (K4's slots are destination-sorted, K5's source-sorted), each
//     destination's lanes are now contiguous in shared memory.
//  2. Groups of T threads (T = the power of two at or above the row's
//     16-byte column vectors, at most the CTA, so that groups of 32 or more
//     fill whole warps; scalars where din % 4 != 0 or a table is not
//     16-byte aligned) split the sorted lanes into even spans; a thread
//     owns one vector of every lane in its group's span, issues the row
//     loads of several lanes before it sums them, and sums each run of one
//     destination in registers.
//  3. Each element of the output is written once where one CTA can own
//     it. The CTA that holds the only chunk of its row block (known from
//     chunk_block[c - 1] and chunk_block[c + 1]; the builders give every
//     row block at least one chunk and keep a block's chunks adjacent) owns
//     the whole block. In a destination-sorted frame (K4) a chunk of a
//     longer block owns the rows from its first destination to the next
//     chunk's (from 0 for the block's first chunk, to RB for its last),
//     less the at most two rows it shares with a neighbouring chunk. An
//     owning CTA moves its spans' ends to destination boundaries, so that
//     every run is a whole destination: it stores each run with plain
//     coalesced stores and stores zeros to the owned rows no lane reaches.
//     The rows no CTA owns -- the shared rows of a sorted frame, every row
//     of a longer block in K5's frame -- are zeroed by a small launch
//     before (zero_shared_rows) and added to with vector f32 atomics
//     (red.global.add.v4.f32). No other row is zeroed: the launchers issue
//     no memset of the output.
// Sums are taken in another order than a sequential sum (the counting
// sort and the atomics order lanes freely): results equal it up to f32
// reassociation.
//
// Types (the edge stage's compute dtype, rgcn_tpu/nn/layers.py:45-55). The
// table TX is f32 or bf16 and the output TO f32 or, with a bf16 table,
// bf16; the sums are f32 in every form. With a bf16 table each lane's
// weight is rounded to bf16 first (the Pallas kernel's w.astype(xg.dtype),
// pallas_basis.py:138), each product of two bf16 values is exact in f32,
// and the rows load as 16-byte vectors of 8 values where din % 8 == 0 (one
// value a thread otherwise). A bf16 output is narrowed once per element from
// its whole f32 sum, as the Pallas kernel narrows its f32 scratch on a row
// block's closing chunk: an owned row from the registers that summed it;
// the rows finished with atomics are summed in an f32 scratch (the rows
// zero_shared_rows zeroes) and narrowed after by narrow_shared_rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wruns {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kStaticSmem = 48 * 1024;  // above this only with the attribute set
constexpr size_t kMaxSmem = 232448;        // dynamic shared memory a block may use

struct Args {
  const void* x;           // (rows, din), or (NB, rows, din) per-basis tables, of TX
  const int* src;          // (L,)
  const float* w;          // (KK, NB, L)
  const int* local;        // (KK, L)
  const int* chunk_block;  // (n_chunks,)
  void* out;               // (num_nodes, NB_OUT, din) of TO
  float* acc;              // f32 rows the atomics add to: out itself when TO is
                           // f32, else an f32 scratch of out's shape
  long long num_slots;     // L = n_chunks * CH
  long long table_plane;   // rows * din: the stride of per-basis tables
  int n_chunks, chunk, row_block, kk, din, num_nodes;
  int sum_bases;
  int dst_sorted;          // each row block's slots sorted by destination (K4)
  void* hook_data;         // a variant's own (see Frame); unused by the launchers
};

// VEC consecutive values of a table row as loaded (16 bytes, or one value);
// get(e) widens value e to f32, exactly (bf16 through cuda_bf16.h).
template <typename TX, int VEC>
struct RowVec;
template <>
struct RowVec<float, 4> {
  float4 v;
  __device__ __forceinline__ float get(int e) const { return (&v.x)[e]; }
};
template <>
struct RowVec<float, 1> {
  float v;
  __device__ __forceinline__ float get(int) const { return v; }
};
template <>
struct RowVec<__nv_bfloat16, 8> {
  uint4 v;
  __device__ __forceinline__ float get(int e) const {
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>((&v.x)[e / 2] >> (16 * (e % 2)))));
  }
};
template <>
struct RowVec<__nv_bfloat16, 1> {
  unsigned short v;
  __device__ __forceinline__ float get(int) const { return __bfloat162float(__ushort_as_bfloat16(v)); }
};

template <typename TX, int VEC>
__device__ __forceinline__ RowVec<TX, VEC> load_vec(const TX* __restrict__ p) {
  RowVec<TX, VEC> r;
  if constexpr (sizeof(TX) * VEC == 16) {
    r.v = __ldg(reinterpret_cast<const decltype(r.v)*>(p));
  } else if constexpr (sizeof(TX) == 4) {
    r.v = __ldg(reinterpret_cast<const float*>(p));
  } else {
    r.v = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return r;
}

// A lane's weight as the kernel uses it: rounded to the table's type first.
template <typename TX>
__device__ __forceinline__ float table_weight(float w) {
  if constexpr (sizeof(TX) == 4) return w;
  else return __bfloat162float(__float2bfloat16_rn(w));
}

// VEC f32 sums to VEC consecutive elements of type TO (narrowed once).
template <typename TO, int VEC>
__device__ __forceinline__ void store_vec(TO* q, const float (&s)[VEC]) {
  if constexpr (sizeof(TO) == 4) {
    if constexpr (VEC == 1) {
      *reinterpret_cast<float*>(q) = s[0];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(q) + e) =
            make_float4(s[e], s[e + 1], s[e + 2], s[e + 3]);
    }
  } else {
    if constexpr (VEC == 1) {
      *q = __float2bfloat16_rn(s[0]);
    } else {
      unsigned w[VEC / 2];
#pragma unroll
      for (int e = 0; e < VEC; e += 2)
        w[e / 2] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(s[e]))) |
                   (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(s[e + 1]))) << 16);
      *reinterpret_cast<uint4*>(q) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void add_vec(float* q, const float (&s)[VEC]) {
  if constexpr (VEC == 1) {
    atomicAdd(q, s[0]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      atomicAdd(reinterpret_cast<float4*>(q + e), make_float4(s[e], s[e + 1], s[e + 2], s[e + 3]));
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

// Shared-memory ints before the sorted lanes: the offsets and cursors and
// the scan's warp sums, rounded up to 16 bytes.
__host__ __device__ constexpr int head_ints(int row_block) {
  return (2 * row_block + 2 + kWarps + 3) / 4 * 4;
}

// Shared-memory bytes of one CTA: the head, then a lane's {source row,
// local destination} and its nb weights, then the groups' partial sums (nb
// vectors of vec floats a thread at most).
inline size_t smem_bytes(int row_block, int kk, int chunk, int nb, int vec) {
  return sizeof(int) * static_cast<size_t>(head_ints(row_block)) +
         (sizeof(int2) + sizeof(float) * nb) * static_cast<size_t>(kk) * chunk +
         sizeof(float) * vec * kThreads * nb;
}

// The rows [r0, r1) that the main kernel adds to with atomics on behalf of
// chunk c. A destination-sorted frame (dst_sorted) has only the rows its
// chunks split: the last row of chunk c when chunk c + 1 of the same block
// starts with it. Any other frame has every row of a block with several
// chunks, counted at the block's first chunk c.
__device__ __forceinline__ bool shared_rows(const int* __restrict__ chunk_block,
                                            const int* __restrict__ local, int c, int n_chunks,
                                            int chunk, int row_block, int num_nodes,
                                            int dst_sorted, long long& r0, long long& r1) {
  const int blk = chunk_block[c];
  if (c + 1 >= n_chunks || chunk_block[c + 1] != blk) return false;
  const long long base = static_cast<long long>(blk) * row_block;
  if (dst_sorted) {
    const long long t = static_cast<long long>(c + 1) * chunk;
    const int r = local[t];
    if (local[t - 1] != r) return false;
    r0 = base + r;
    r1 = r0 + 1;
  } else {
    if (c > 0 && chunk_block[c - 1] == blk) return false;
    r0 = base;
    r1 = base + row_block;
  }
  r1 = min(r1, static_cast<long long>(num_nodes));
  return r1 > r0;
}

// The passes over those rows before and after the main kernel give each
// chunk a warp (a CTA of kWarps warps takes kWarps chunks): most chunks
// have no such rows, and a CTA a chunk spent its time scheduling CTAs that
// found none (K5's frame at lp-WN18: 7,376 CTAs of 16 parts a chunk, 1,184
// with rows). An unsorted frame's block rows are split over kRowParts warps
// (blockIdx.y), a sorted frame's one row taken by one warp. With the
// narrowing's vectors below, on an H100 the two passes of K5's bf16 call
// at lp-WN18 took 6.0 and 10.4 us of its 45.7, against 6.6 and 16.6 of
// 52.5 as CTAs a chunk narrowing a value a thread (compare_k1_k5.py).
constexpr int kRowParts = 32;

inline dim3 rows_grid(int n_chunks, int dst_sorted) {
  return dim3((n_chunks + kWarps - 1) / kWarps, dst_sorted ? 1 : kRowParts);
}

// Part blockIdx.y of [0, n) of a warp's rows, each lane every 32nd.
__device__ __forceinline__ void warp_part(long long n, long long& lo, long long& hi) {
  const long long part = (n + gridDim.y - 1) / gridDim.y;
  lo = min(n, blockIdx.y * part);
  hi = min(n, lo + part);
}

// A warp's part (blockIdx.y) of zeroing p[0, n).
__device__ __forceinline__ void warp_zero(float* __restrict__ p, long long n, int lane) {
  // scalars up to a 16-byte boundary, then vectors, then the scalar tail
  const long long head =
      min(n, static_cast<long long>((4 - (reinterpret_cast<std::uintptr_t>(p) / 4) % 4) % 4));
  const long long n4 = (n - head) / 4;
  if (blockIdx.y == 0) {
    if (lane < head) p[lane] = 0.f;
    for (long long i = head + 4 * n4 + lane; i < n; i += 32) p[i] = 0.f;
  }
  float4* p4 = reinterpret_cast<float4*>(p + head);
  long long lo, hi;
  warp_part(n4, lo, hi);
  for (long long i = lo + lane; i < hi; i += 32) p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Before the main kernel: zero the f32 rows it adds to with atomics.
__global__ void zero_shared_rows(const int* __restrict__ chunk_block,
                                 const int* __restrict__ local,
                                 float* __restrict__ out, int n_chunks, int chunk,
                                 int row_block, int row_len, int num_nodes,
                                 int dst_sorted) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  long long r0, r1;
  if (c >= n_chunks || !shared_rows(chunk_block, local, c, n_chunks, chunk, row_block,
                                    num_nodes, dst_sorted, r0, r1))
    return;  // warp-uniform
  warp_zero(out + r0 * row_len, (r1 - r0) * row_len, threadIdx.x & 31);
}

// After the main kernel, for a bf16 output: narrow the rows the atomics
// finished in the f32 scratch, each element once: 16-byte loads of 4 sums
// and 8-byte stores of their 4 bf16 values where the row length is a
// multiple of 4 (K5's rows at lp-WN18 are 400 long), else one value a
// lane.
__global__ void narrow_shared_rows(const int* __restrict__ chunk_block,
                                   const int* __restrict__ local,
                                   const float* __restrict__ acc,
                                   __nv_bfloat16* __restrict__ out, int n_chunks,
                                   int chunk, int row_block, int row_len, int num_nodes,
                                   int dst_sorted) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  long long r0, r1;
  if (c >= n_chunks || !shared_rows(chunk_block, local, c, n_chunks, chunk, row_block,
                                    num_nodes, dst_sorted, r0, r1))
    return;  // warp-uniform
  const long long at = r0 * row_len, n = (r1 - r0) * row_len;
  const bool vec = row_len % 4 == 0 && reinterpret_cast<std::uintptr_t>(acc) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 8 == 0;
  long long lo, hi;
  warp_part(vec ? n / 4 : n, lo, hi);
  if (!vec) {
    for (long long i = lo + lane; i < hi; i += 32) out[at + i] = __float2bfloat16_rn(acc[at + i]);
    return;
  }
#pragma unroll 4
  for (long long i = lo + lane; i < hi; i += 32) {
    const float4 v = *reinterpret_cast<const float4*>(acc + at + 4 * i);
    const unsigned w0 = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v.x))) |
                        (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v.y))) << 16);
    const unsigned w1 = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v.z))) |
                        (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v.w))) << 16);
    *reinterpret_cast<uint2*>(out + at + 4 * i) = make_uint2(w0, w1);
  }
}

// What the main kernel reads of a lane, and does after its sums, as the
// launchers use it: the source row a.src[slot] and the weight w (rounded
// to the table's type), nothing after. The variants under variants/ (timed
// by rgcn_tpu_torch/compare_k1_k5.py) instantiate the kernel with hooks of
// their own, to time designs the launchers did not take; this default
// leaves the launchers' kernel as it was without them.
struct Frame {
  __device__ __forceinline__ static int src(const Args& a, long long slot) {
    return a.src[slot];
  }
  template <typename TX>
  __device__ __forceinline__ static float weight(const float* wl, long long off) {
    return table_weight<TX>(wl[off]);
  }
  template <typename TO>
  __device__ __forceinline__ static void after(const Args&, int, bool, bool, long long) {}
};

// One run's sums to its row: stored (narrowed to TO) where this CTA owns
// the row, else added to the f32 row ``acc_row`` with atomics.
template <typename TO, int VEC, int NB>
__device__ __forceinline__ void write_run(TO* __restrict__ row, float* __restrict__ acc_row,
                                          const float (&acc)[NB][VEC], int nb_out, int din,
                                          bool store) {
#pragma unroll
  for (int o = 0; o < NB; ++o) {
    if (o >= nb_out) break;
    if (store) store_vec<TO, VEC>(row + o * din, acc[o]);
    else add_vec<VEC>(acc_row + o * din, acc[o]);
  }
}

// lanes a thread loads before it sums them: 4 rows, fewer where each lane
// brings NB per-basis rows or NB accumulators take the registers. With up
// to 2 bases the kernel is held to 64 registers, 4 CTAs (32 warps) an SM:
// at lp-WN18 the warps in flight, more than the rows a warp loads at once,
// set the kernel's pace.
// A thread of a bf16 table's 16-byte vectors (8 values) keeps twice the f32
// form's sums, so it loads half as many lanes at once: with 4, the bf16
// forms spilled to local memory under these register bounds.
template <int NB, bool PER_BASIS, int VEC>
__host__ __device__ constexpr int batch() {
  constexpr int b = PER_BASIS ? (NB >= 4 ? 1 : 4 / NB) : (NB <= 4 ? 4 : 2);
  return VEC > 4 ? (b > 1 ? b / 2 : 1) : b;
}

// Occupancy: 4 CTAs an SM (64 registers) up to 2 bases, else 2 (128); with
// a bf16 table's 8-value vectors and more than 4 bases the sums alone take
// NB * 8 registers (and per-basis tables NB row vectors), so those forms
// ask for 1 CTA an SM (255 registers) rather than spill.
template <int NB, int VEC>
__host__ __device__ constexpr int min_ctas() {
  return NB <= 2 ? 4 : (NB <= 4 || VEC <= 4 ? 2 : 1);
}

template <typename TX, typename TO, int VEC, int NB, bool PER_BASIS, typename Hooks = Frame>
__global__ void __launch_bounds__(kThreads, min_ctas<NB, VEC>()) runs_kernel(const Args a) {
  constexpr int NX = PER_BASIS ? NB : 1;  // row loads per lane
  constexpr int B = batch<NB, PER_BASIS, VEC>();
  extern __shared__ int smem[];
  const int RB = a.row_block, CH = a.chunk;
  int* off = smem;                   // RB + 1
  int* cursor = off + RB + 1;        // RB + 1
  int* warp_sums = cursor + RB + 1;  // kWarps
  int2* lanes = reinterpret_cast<int2*>(smem + head_ints(RB));  // {source row, local dst}
  float* lane_w = reinterpret_cast<float*>(lanes + a.kk * CH);  // NB weights a lane

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x;
  const long long slot0 = static_cast<long long>(c) * CH;
  const int blk = a.chunk_block[c];
  const bool first = c == 0 || a.chunk_block[c - 1] != blk;
  const bool last = c == a.n_chunks - 1 || a.chunk_block[c + 1] != blk;
  const int nb_out = a.sum_bases ? 1 : NB;
  // rows [own_lo, own_hi) of the block are this CTA's to write whole: the
  // whole block for its only chunk; in a destination-sorted frame, from its
  // first destination (0 for the block's first chunk) to the next chunk's
  // (RB for the last), less the rows it splits with its neighbours, which
  // are zeroed before and added to (split_lo, split_hi). Otherwise nothing:
  // every row is added to.
  int own_lo = 0, own_hi = 0, split_lo = -1, split_hi = -1;
  if (first && last) {
    own_hi = RB;
  } else if (a.dst_sorted) {
    const int f0 = a.local[slot0];
    own_lo = first ? 0 : f0;
    own_hi = last ? RB : a.local[slot0 + CH];
    if (!first && a.local[slot0 - 1] == f0) split_lo = f0;
    if (!last && a.local[slot0 + CH - 1] == own_hi) split_hi = own_hi;
  }

  // 1. count lanes per destination, sort lanes by destination
  for (int i = tid; i < RB; i += kThreads) off[i] = 0;
  __syncthreads();
  for (int t0 = warp * 32; t0 < CH; t0 += kThreads) {  // warp-uniform trips
    const int t = t0 + lane;
    for (int k = 0; k < a.kk; ++k) {
      const int ld = t < CH ? a.local[k * a.num_slots + slot0 + t] : RB;
      const unsigned peers = __match_any_sync(kFull, ld);
      if (ld < RB && lane == __ffs(peers) - 1) atomicAdd(off + ld, __popc(peers));
    }
  }
  __syncthreads();
  block_exclusive_scan(off, RB, warp_sums);
  for (int i = tid; i < RB; i += kThreads) cursor[i] = off[i];
  __syncthreads();
  for (int t0 = warp * 32; t0 < CH; t0 += kThreads) {
    const int t = t0 + lane;
    for (int k = 0; k < a.kk; ++k) {
      const int ld = t < CH ? a.local[k * a.num_slots + slot0 + t] : RB;
      const unsigned peers = __match_any_sync(kFull, ld);
      if (ld < RB) {
        const int leader = __ffs(peers) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(cursor + ld, __popc(peers));
        at = __shfl_sync(peers, at, leader) + __popc(peers & ((1u << lane) - 1));
        lanes[at] = make_int2(Hooks::src(a, slot0 + t), ld);
        const float* wl = a.w + k * NB * a.num_slots + slot0 + t;
#pragma unroll
        for (int b = 0; b < NB; ++b)
          lane_w[at * NB + b] = Hooks::template weight<TX>(wl, b * a.num_slots);
      }
    }
  }
  __syncthreads();

  // 2-3. each group sums its span's runs and writes them; a run that goes
  // on into the next groups' spans is finished by the group it starts in,
  // which adds the partial sums those groups leave in shared memory
  const long long base = static_cast<long long>(blk) * RB;
  const long long row_len = static_cast<long long>(nb_out) * a.din;
  const int n_lanes = off[RB];
  const int nv = (a.din + VEC - 1) / VEC;
  int T = 1;  // threads of a group: a power of two, so groups of 32 or more fill warps
  while (T < nv && T < kThreads) T *= 2;
  const int groups = kThreads / T;
  const int g = tid / T, gt = tid - g * T;
  const int span = (n_lanes + groups - 1) / groups;
  const int lo = min(g * span, n_lanes), hi = min(lo + span, n_lanes);
  const int prev_ld = lo > 0 && lo < hi ? lanes[lo - 1].y : -1;  // run shared with the
  const int next_ld = hi > lo && hi < n_lanes ? lanes[hi].y : -1;  // neighbouring spans
  float* partial = lane_w + a.kk * CH * NB + (g * nb_out * T + gt) * VEC;  // [g][o][gt][VEC]
  const int n_pass = (nv + T - 1) / T;
  for (int pass = 0; pass < n_pass; ++pass) {  // uniform: every thread meets the barriers
    const int v = pass * T + gt;
    const bool active = g < groups && lo < hi && v < nv;
    const TX* xc = static_cast<const TX*>(a.x) + v * VEC;
    float acc[NB][VEC];
#pragma unroll
    for (int o = 0; o < NB; ++o)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[o][e] = 0.f;
    // the run's sums to row r of the output (or of a.acc); the row's address
    // is formed here from the kernel's parameters, not held in registers
    auto run_to_row = [&](int r) {
      const long long at = (base + r) * row_len + v * VEC;
      write_run<TO, VEC, NB>(static_cast<TO*>(a.out) + at, a.acc + at, acc, nb_out, a.din,
                             r >= own_lo && r < own_hi && r != split_lo && r != split_hi);
    };
    int cur = -1;
    bool head = true;  // the current run is the span's first
    bool finish = false;
    // a run ends: its row gets it, unless it goes on from the previous span
    // (left in shared memory) or into the next (kept for after the barrier)
    auto end_run = [&](bool last_run) {
      if (head && cur == prev_ld) {
#pragma unroll
        for (int o = 0; o < NB; ++o)
          if (o < nb_out)
#pragma unroll
            for (int e = 0; e < VEC; ++e) partial[o * T * VEC + e] = acc[o][e];
      } else if (last_run && cur == next_ld) {
        finish = true;
      } else if (base + cur < a.num_nodes) {
        run_to_row(cur);
      }
    };
    if (active) {
      for (int i0 = lo; i0 < hi; i0 += B) {
        int ld[B];
        RowVec<TX, VEC> xv[B][NX];
#pragma unroll
        for (int j = 0; j < B; ++j) {
          ld[j] = -1;
          if (i0 + j < hi) {
            const int2 e = lanes[i0 + j];
            const long long row = static_cast<long long>(e.x) * a.din;
            ld[j] = e.y;
#pragma unroll
            for (int q = 0; q < NX; ++q) xv[j][q] = load_vec<TX, VEC>(xc + q * a.table_plane + row);
          }
        }
#pragma unroll
        for (int j = 0; j < B; ++j) {
          if (ld[j] < 0) break;  // past the span's end
          if (ld[j] != cur) {
            if (cur >= 0) {
              end_run(false);
              head = false;
            }
#pragma unroll
            for (int o = 0; o < NB; ++o)
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[o][e] = 0.f;
            cur = ld[j];
          }
          const float* wv = lane_w + (i0 + j) * NB;
          if (a.sum_bases) {
            if constexpr (PER_BASIS) {
#pragma unroll
              for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[0][e] += wv[b] * xv[j][b].get(e);
            } else {
              float ws = 0.f;
#pragma unroll
              for (int b = 0; b < NB; ++b) ws += wv[b];
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[0][e] += ws * xv[j][0].get(e);
            }
          } else {
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[b][e] += wv[b] * xv[j][PER_BASIS ? b : 0].get(e);
          }
        }
      }
      end_run(true);
    }
    __syncthreads();
    if (finish) {  // add the partials of the spans the run goes on into
      for (int g2 = g + 1; g2 < groups; ++g2) {
        const float* p2 = partial + (g2 - g) * nb_out * T * VEC;
#pragma unroll
        for (int o = 0; o < NB; ++o)
          if (o < nb_out)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[o][e] += p2[o * T * VEC + e];
        const int hi2 = min((g2 + 1) * span, n_lanes);
        if (hi2 >= n_lanes || lanes[hi2].y != cur) break;  // the run ends in span g2
      }
      if (base + cur < a.num_nodes) run_to_row(cur);
    }
    __syncthreads();  // the partials are reused by the next pass
  }

  // the owned rows that no lane reaches: zeros, a warp a row (a row of the
  // node-major output is nb_out * din consecutive values)
  const int own_end = static_cast<int>(min(static_cast<long long>(own_hi), a.num_nodes - base));
  const int n_vec = static_cast<int>(row_len / VEC);
  const float zeros[VEC] = {};
  for (int r = own_lo + warp; r < own_end; r += kWarps) {
    if (off[r + 1] != off[r]) continue;  // warp-uniform
    TO* q = static_cast<TO*>(a.out) + (base + r) * row_len;
    for (int i = lane; i < n_vec; i += 32) store_vec<TO, VEC>(q + i * VEC, zeros);
  }
  Hooks::template after<TO>(a, blk, first, last, row_len);
}

template <typename TX, typename TO, int VEC, int NB, bool PER_BASIS, typename Hooks = Frame>
cudaError_t launch_runs(const Args& a, size_t smem, cudaStream_t st) {
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        runs_kernel<TX, TO, VEC, NB, PER_BASIS, Hooks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  runs_kernel<TX, TO, VEC, NB, PER_BASIS, Hooks><<<a.n_chunks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// Zero the f32 rows the main kernel adds to, run it (with per-basis tables
// when PER_BASIS), and for a bf16 output narrow those rows after. A table
// of TX, an output of TO: (f32, f32), (bf16, f32) or (bf16, bf16).
template <typename TX, typename TO, bool PER_BASIS, typename Hooks = Frame>
cudaError_t run(const Args& a, int nb, cudaStream_t st) {
  if (a.n_chunks < 1 || a.chunk < 1 || a.row_block < 1 || a.din < 1 || a.kk < 1 ||
      nb < 1 || nb > 8 || (a.dst_sorted && a.kk != 1) || a.acc == nullptr)
    return cudaErrorInvalidValue;
  const int nb_out = a.sum_bases ? 1 : nb;
  constexpr int kVec = 16 / sizeof(TX);  // values of a 16-byte row vector
  const bool wide = a.din % kVec == 0 && reinterpret_cast<std::uintptr_t>(a.x) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(a.out) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(a.acc) % 16 == 0;
  const size_t smem = smem_bytes(a.row_block, a.kk, a.chunk, nb, wide ? kVec : 1);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 rows = rows_grid(a.n_chunks, a.dst_sorted);
  zero_shared_rows<<<rows, kThreads, 0, st>>>(
      a.chunk_block, a.local, a.acc, a.n_chunks, a.chunk, a.row_block, nb_out * a.din,
      a.num_nodes, a.dst_sorted);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (nb) {
#define WR_CASE(N)                                                          \
  case N:                                                                   \
    err = wide ? launch_runs<TX, TO, kVec, N, PER_BASIS, Hooks>(a, smem, st) \
               : launch_runs<TX, TO, 1, N, PER_BASIS, Hooks>(a, smem, st);   \
    break;
    WR_CASE(1) WR_CASE(2) WR_CASE(3) WR_CASE(4)
    WR_CASE(5) WR_CASE(6) WR_CASE(7) WR_CASE(8)
#undef WR_CASE
  }
  if (err != cudaSuccess || sizeof(TO) == 4) return err;
  narrow_shared_rows<<<rows, kThreads, 0, st>>>(
      a.chunk_block, a.local, a.acc, static_cast<__nv_bfloat16*>(a.out), a.n_chunks, a.chunk,
      a.row_block, nb_out * a.din, a.num_nodes, a.dst_sorted);
  return cudaGetLastError();
}

}  // namespace wruns
