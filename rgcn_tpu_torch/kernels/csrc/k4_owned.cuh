// K4 as designed for Hopper (sm_90a), f32 and bf16 tables alike: a
// weighted destination sum over a destination-sorted DstLayout, read as it
// is, with the source rows gathered through a ring of asynchronous copies
// and every output row written once, in one launch and in an order the
// layout fixes. Used by k4_weighted_aggregate.cu (f32 tables, f32 output)
// and k4_weighted_aggregate_bf16.cu (bf16 tables, f32 or bf16 output).
// Over the slots l of node n it computes
//     shared rows (rows, din):        out[n][b]  = sum w_b * x[src]
//                                     sum_bases: (sum_b w_b) * x[src]
//     per-basis rows (NB, rows, din): out[n][b]  = sum w_b * x[b][src]
//                                     sum_bases: sum_b w_b * x[b][src]
// with f32 products and sums; a bf16 table rounds each weight to bf16 first
// (the products of two bf16 values are exact in f32) and a bf16 output is
// narrowed once per element.
//
// What the shared design (weighted_runs.cuh, which K5 keeps) cost here: a
// counting sort of every chunk though K4's frame is sorted already (two
// __match_any_sync passes, a shared-memory atomic a slot, a block scan,
// four barriers), so that a destination's lanes were added in the order the
// atomics placed them; the rows two CTAs share zeroed by a launch before and
// finished with f32 atomics (red.global.add), in the order the CTAs
// arrived; row loads held in registers; for a bf16 output three launches
// and an f32 scratch of the whole output's size.
//
// Design. A unit is a span of consecutive slots of one chunk (the whole
// chunk by default); one CTA a unit. Its destination-sorted slots are
// taken as they come:
//  1. Staging. The unit's local_dst, and for each real slot (local < RB)
//     its source row and nb weights (summed over bases for a shared table
//     with sum_bases), are read once, coalesced, into shared memory. Pads
//     are never read past their local_dst. A run is a maximal stretch of
//     slots with one destination; the frame is sorted, so each
//     destination's slots are one run of the block, which may go on over
//     the next units of the block.
//  2. Columns. A row is V = ceil(din / VEC) vectors of 16 bytes (VEC = 4
//     f32 or 8 bf16 values). A vector is moved whole where din % VEC == 0
//     and the table is 16-byte aligned; else in pieces of 8, 4 or 2 bytes
//     (the most that din and the table's alignment allow: nc-AM's width 10
//     moves 8-byte pieces of f32 and 4-byte pieces of bf16), the last
//     vector of a row masked. A group is T = min(V, THREADS) consecutive
//     threads, one vector each (T = 25 at din 200 in bf16, 50 in f32);
//     groups need not fill warps, since nothing but shared memory passes
//     between threads. G = THREADS / T groups, at most kMaxGroups, split the
//     unit's slots into G even segments. The kernel is compiled twice: for
//     whole vectors (WHOLE: no piece or mask code in the walk) and in
//     pieces.
//  3. The walk. Each thread walks its segment's slots in slot order with
//     the vectors of the next slots in flight (kFlight vectors a thread) as
//     cp.async.ca copies into a ring of its own in shared memory, so that
//     the rows in flight take no registers and a row many slots read is
//     served by L1 (lp-WN18's hubs are read 700-3,000 times). A run's sums
//     stay in registers; a run that goes on from the group before is left
//     in shared memory, and the group the run starts in adds the groups'
//     parts after a barrier in group order; kMaxGroups bounds that serial
//     merge (a run over every group of a unit: 2 vectors a row at din 16
//     in bf16 would make 128 groups; 128 groups measured slower than 32 on
//     an H100 at nc-AIFB's and nc-AM's narrow rows, compare_k4).
//  4. Ownership. A unit owns the rows whose first slot at or past them in
//     the block lies in the unit: (local of the slot before the unit,
//     local of its last slot], from row 0 for the block's first unit and
//     to row RB - 1 for its last. A run that starts and ends in the unit is
//     stored to its output row once (coalesced streaming stores, narrowed
//     from the f32 sums for a bf16 output); an owned row no slot reaches is
//     stored as zeros (one bit a row marks the rows a run starts in). No
//     memset.
//  5. Split rows. Only a run that crosses a unit boundary is not finished
//     in one unit (at most two a unit: the run it continues and the run it
//     hands on). Each unit stores its part of such a run as f32 into a
//     scratch of two rows a unit (part[u][0]: the run it continues from
//     the unit before; part[u][1]: the run it starts and hands on; a basis
//     din rounded up to whole vectors wide), then finds the run's first and
//     last units (one ballot over 32 units' first slots a step, the first
//     step from the neighbours' slots read while staging: a destination
//     may span any number of units) and counts itself in with atomicInc on
//     a counter of the run's first unit, bounded by the run's unit count:
//     the last unit to arrive adds the parts in unit order (split P ways
//     by a fixed rule of the row's width, the P sums added in order) and
//     stores the row once, and atomicInc's wrap leaves the counter 0
//     again. The counters are the launcher's to keep (zeroed once, one set
//     per stream; a call leaves them as it found them). One launch, no f32
//     scratch of the output's size, no zeroing, no atomics on the output.
// Every sum is taken in an order fixed by the layout alone (segments in
// slot order, groups in group order, split runs in unit order), so two
// launches on the same inputs give the same bits; results equal a
// sequential sum up to f32 reassociation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace k4o {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNbMax = 8;
constexpr int kMaxGroups = 32;  // groups a unit's slots are split into, at most
constexpr size_t kMaxSmem = 232448;

// values of a 16-byte column vector of a TX table: 4 f32 or 8 bf16
template <typename TX>
__host__ __device__ constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(TX));
}

struct Args {
  const void* x;           // TX (rows, din), or (nb, rows, din) per-basis tables
  const int* src;          // (L,)
  const float* w;          // (nb, L)
  const int* local;        // (L,): (n_chunks, chunk) local destinations, RB a pad
  const int* chunk_block;  // (n_chunks,)
  void* out;               // (num_nodes, nb_out, din)
  float* part;             // (units, 2, nb_out * din_p) f32 parts of split runs
  unsigned* counters;      // (units,) zero on entry and on exit
  long long num_slots;     // L
  long long table_plane;   // rows * din: the stride of per-basis tables
  int n_chunks, chunk, span, parts, row_block, din, num_nodes, sum_bases;
  int nb_out;              // sum_bases ? 1 : nb
  int piece;               // values a copy or a store moves: VEC, or fewer (prepare())
  int din_p;               // din rounded up to whole vectors: a basis's width in part
  long long* stamps;       // a probe's phase times (Cfg STAMPS), else unused
};

// The design's choices (the launcher's, and the variants' under variants/):
// FLIGHT row vectors in flight a thread; RING the copy ring (else a register
// ring, the walk unrolled by its depth: whole 16-byte vectors only); STREAM
// the output stored with evict-first (.cs) stores, so that it does not push
// the table out of L2; L1 the copies through L1 (cp.async.ca, else .cg: L2
// only, whole vectors only), so that a row many slots read (lp-WN18's hubs
// are read 700-3,000 times by hundreds of CTAs at once) is served by the
// SM's L1; ZERO when the owned rows no run starts in are stored as zeros: 0
// before the walk (the stores overlap its gathers), 1 after it, 2 before it
// where an output row is at most kZeroEarlyRowBytes, else after it (the
// better of the two each way at lp-WN18: before, the zero rows of its
// 400-byte dx rows cost nothing, while those of its 800- and 1,600-byte Agg
// rows slowed the walk); THREADS a CTA (256, 128 or 64, a unit being at
// most as many slots). STAMPS (a probe only): thread 0 of each CTA records
// %globaltimer and its SM at the phase boundaries into a.stamps[unit][8]
// (start, staged, walked, zero rows stored after the walk, split runs
// counted in, end, zero rows stored before the walk, SM).
template <int FLIGHT, bool RING, bool STREAM, bool L1, int ZERO, int THREADS = 256,
          bool STAMPS = false>
struct Cfg {
  static constexpr int kFlight = FLIGHT, kThreads = THREADS, kZero = ZERO;
  static constexpr bool kRing = RING, kStream = STREAM, kL1 = L1, kStamps = STAMPS;
};
using Launcher = Cfg<8, true, true, true, 2>;
constexpr int kZeroEarlyRowBytes = 512;

// The launcher's arguments as Args (span, parts, nb_out, piece and din_p
// are prepare()'s).
inline Args make_args(const void* x, const int* src, const float* w, const int* local_dst,
                      const int* chunk_block, void* out, float* part, unsigned* counters,
                      int n_chunks, int chunk, int row_block, int din, int table_rows,
                      int num_nodes, int sum_bases) {
  Args a{};
  a.x = x;
  a.src = src;
  a.w = w;
  a.local = local_dst;
  a.chunk_block = chunk_block;
  a.out = out;
  a.part = part;
  a.counters = counters;
  a.num_slots = static_cast<long long>(n_chunks) * chunk;
  a.table_plane = static_cast<long long>(table_rows) * din;
  a.n_chunks = n_chunks;
  a.chunk = chunk;
  a.row_block = row_block;
  a.din = din;
  a.num_nodes = num_nodes;
  a.sum_bases = sum_bases;
  return a;
}

// The units of a chunk: ``span`` slots each, the last one what is left. The
// scratch holds two rows a unit (kernels.k4_scratch_floats).
inline int unit_parts(int chunk, int span) { return (chunk + span - 1) / span; }

// Slot s0 of unit u.
__device__ __forceinline__ long long unit_start(const Args& a, int u) {
  const int c = u / a.parts;
  return static_cast<long long>(c) * a.chunk + static_cast<long long>(u - c * a.parts) * a.span;
}

// A unit's place in the frame: slots [a, a + n) of its chunk, in row block
// blk; whether it is the block's first or last unit; the local destinations
// of the slot before it (prev, -1 for the block's first unit), of its first
// and last slots (f, l) and of the slot after it (next, RB for the block's
// last unit).
struct Unit {
  long long a;
  int n, blk, prev, f, l, next;
  bool first, last;
  // its first run goes on from the unit before; its last into the unit after
  __device__ __forceinline__ bool head_split(int rb) const { return !first && prev == f && f < rb; }
  __device__ __forceinline__ bool tail_split(int rb) const { return !last && next == l && l < rb; }
};

__device__ __forceinline__ Unit unit_at(const Args& a, int u) {
  Unit t;
  const int c = u / a.parts, p = u - c * a.parts;
  t.a = unit_start(a, u);
  t.n = min(a.span, a.chunk - p * a.span);
  t.blk = a.chunk_block[c];
  t.first = p == 0 && (c == 0 || a.chunk_block[c - 1] != t.blk);
  t.last = p == a.parts - 1 && (c + 1 == a.n_chunks || a.chunk_block[c + 1] != t.blk);
  t.prev = t.first ? -1 : a.local[t.a - 1];
  t.f = a.local[t.a];
  t.l = a.local[t.a + t.n - 1];
  t.next = t.last ? a.row_block : a.local[t.a + t.n];
  return t;
}

// A 16-byte column vector of a TX table row: VEC values, widened to f32
// exactly.
template <typename TX>
struct Vec {
  uint4 v;
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(TX) == 4) {
      return __uint_as_float((&v.x)[e]);
    } else {
      const unsigned w = (&v.x)[e / 2];
      return __uint_as_float(e % 2 ? (w & 0xffff0000u) : (w << 16));
    }
  }
  __device__ __forceinline__ void load(const TX* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
};

// BYTES (16, 8 or 4) from global to shared memory, asynchronously: through
// L1 (.ca) or, for 16 bytes, L2 only (.cg).
template <int BYTES, bool L1>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16 && !L1)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first nvalid values of a vector into its ring slot in pieces of P
// values (2-byte pieces, a bf16 table's odd widths, by a plain load: no
// cp.async moves 2 bytes).
template <typename TX, int P, bool L1>
__device__ __forceinline__ void copy_pieces(uint4* slot, const TX* row, int nvalid) {
  constexpr int VEC = vec_of<TX>(), B = P * static_cast<int>(sizeof(TX));
#pragma unroll
  for (int e = 0; e < VEC; e += P) {
    if (e >= nvalid) break;
    char* d = reinterpret_cast<char*>(slot) + e * sizeof(TX);
    if constexpr (B >= 4)
      cp_async<B, L1>(d, row + e);
    else
      *reinterpret_cast<unsigned short*>(d) =
          __ldg(reinterpret_cast<const unsigned short*>(row + e));
  }
}

template <typename TX, bool L1, bool WHOLE>
__device__ __forceinline__ void copy_vec(uint4* slot, const TX* row, int nvalid, int piece) {
  constexpr int VEC = vec_of<TX>();
  if (WHOLE || piece == VEC) {  // whole vectors: every vector of a row is full
    cp_async<16, L1>(slot, row);
  } else if (VEC == 8 && piece == 4) {
    copy_pieces<TX, (VEC == 8 ? 4 : 1), L1>(slot, row, nvalid);
  } else if (piece == 2) {
    copy_pieces<TX, 2, L1>(slot, row, nvalid);
  } else {
    copy_pieces<TX, 1, L1>(slot, row, nvalid);
  }
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Stores of 16, 8, 4 or 2 bytes: plain, or evict-first (.cs).
template <bool CS>
__device__ __forceinline__ void st16(void* p, uint4 v) {
  if constexpr (CS)
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
                 "r"(v.z), "r"(v.w)
                 : "memory");
  else
    *reinterpret_cast<uint4*>(p) = v;
}
template <bool CS>
__device__ __forceinline__ void st8(void* p, unsigned x, unsigned y) {
  if constexpr (CS)
    asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};\n" ::"l"(p), "r"(x), "r"(y) : "memory");
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(x, y);
}
template <bool CS>
__device__ __forceinline__ void st4(void* p, unsigned x) {
  if constexpr (CS)
    asm volatile("st.global.cs.u32 [%0], %1;\n" ::"l"(p), "r"(x) : "memory");
  else
    *reinterpret_cast<unsigned*>(p) = x;
}
template <bool CS>
__device__ __forceinline__ void st2(void* p, unsigned short x) {
  if constexpr (CS)
    asm volatile("st.global.cs.u16 [%0], %1;\n" ::"l"(p), "h"(x) : "memory");
  else
    *reinterpret_cast<unsigned short*>(p) = x;
}

// VEC (1, 2, 4 or 8) f32 sums (or zeros) to VEC consecutive elements of an
// f32 or a bf16 row (narrowed once).
template <typename TO, int VEC, bool CS>
__device__ __forceinline__ void store_vec(TO* q, const float* s) {
  if constexpr (sizeof(TO) == 4) {
    if constexpr (VEC == 1) {
      st4<CS>(q, __float_as_uint(s[0]));
    } else if constexpr (VEC == 2) {
      st8<CS>(q, __float_as_uint(s[0]), __float_as_uint(s[1]));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        st16<CS>(reinterpret_cast<float*>(q) + e,
                 make_uint4(__float_as_uint(s[e]), __float_as_uint(s[e + 1]),
                            __float_as_uint(s[e + 2]), __float_as_uint(s[e + 3])));
    }
  } else {
    if constexpr (VEC == 1) {
      st2<CS>(q, __bfloat16_as_ushort(__float2bfloat16_rn(s[0])));
    } else if constexpr (VEC == 2) {
      st4<CS>(q, bf16x2(s[0], s[1]));
    } else if constexpr (VEC == 4) {
      st8<CS>(q, bf16x2(s[0], s[1]), bf16x2(s[2], s[3]));
    } else {
      st16<CS>(q, make_uint4(bf16x2(s[0], s[1]), bf16x2(s[2], s[3]), bf16x2(s[4], s[5]),
                             bf16x2(s[6], s[7])));
    }
  }
}

// The first nvalid of N sums to an output row, in pieces of P values.
template <typename TO, int N, int P, bool CS>
__device__ __forceinline__ void store_pieces(TO* q, const float* s, int nvalid) {
#pragma unroll
  for (int e = 0; e < N; e += P)
    if (e < nvalid) store_vec<TO, P, CS>(q + e, s + e);
}

// A vector's N sums, the first nvalid of them stored: whole where the
// pieces are whole vectors, else in pieces of ``piece`` values.
template <typename TO, int N, bool CS, bool WHOLE>
__device__ __forceinline__ void store_part(TO* q, const float* s, int nvalid, int piece) {
  if (WHOLE || piece >= N) store_vec<TO, N, CS>(q, s);
  else if (N == 8 && piece == 4) store_pieces<TO, N, (N == 8 ? 4 : 1), CS>(q, s, nvalid);
  else if (piece == 2) store_pieces<TO, N, 2, CS>(q, s, nvalid);
  else store_pieces<TO, N, 1, CS>(q, s, nvalid);
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// Ring stages: FLIGHT row vectors in flight a thread, NX of them a slot.
__host__ __device__ constexpr int stages(int flight, int nx) {
  return flight / nx >= 2 ? flight / nx : 2;
}

// Registers: 4 CTAs an SM (64 registers) up to 2 bases (sums of 16
// floats), 2 up to 4, else 1.
template <int NB>
__host__ __device__ constexpr int min_ctas() {
  return NB <= 2 ? 4 : (NB <= 4 ? 2 : 1);
}

// Shared memory of a unit's CTA: the copy ring (16-byte vectors, nx a
// slot), the groups' partial sums (at most threads * nb_out * vec floats),
// the span's local_dst, source rows and weights, and a bit a row of the
// block.
inline size_t smem_bytes(int threads, int span, int row_block, int nb, int nx, bool ring,
                         int flight, int vec) {
  return (ring ? static_cast<size_t>(16) * threads * nx * stages(flight, nx) : 0) +
         sizeof(float) * static_cast<size_t>(threads) * nb * vec +
         sizeof(int) * (static_cast<size_t>(span) * (2 + nb) + (row_block + 31) / 32);
}

// The frame around a unit with a split run, read while it stages its slots:
// for the 32 units v before it (back[j], v = u - 1 - j) the local
// destinations of v's first slot and of the slot before it and those
// slots' row blocks; for the 32 after it (on[j], v = u + 1 + j) its first
// slot's local destination and row block. Out of range: local -2, block -1.
struct Near {
  int4 back[32];
  int2 on[32];
};

__device__ __forceinline__ int4 near_back(const Args& a, int v) {
  if (v < 0) return make_int4(-2, -2, -1, -1);
  const long long s0 = unit_start(a, v);
  return s0 == 0 ? make_int4(a.local[0], -2, a.chunk_block[0], -1)
                 : make_int4(a.local[s0], a.local[s0 - 1], a.chunk_block[s0 / a.chunk],
                             a.chunk_block[(s0 - 1) / a.chunk]);
}
__device__ __forceinline__ int2 near_on(const Args& a, int v) {
  if (v >= a.n_chunks * a.parts) return make_int2(-2, -1);
  const long long s0 = unit_start(a, v);
  return make_int2(a.local[s0], a.chunk_block[s0 / a.chunk]);
}

// Units [o, e] of the run of row r that unit u holds part of: o the unit
// its first slot lies in (u, or found back from u), e the unit its last slot
// lies in (found on from u when ``on``). One warp, a unit a lane, 32 at a
// step: the first step from ``near``, any further (a run over more than 33
// units) from the frame. Every lane gets both.
__device__ __forceinline__ void run_units(const Args& a, const Near& near, int u, int blk,
                                          int r, bool back, bool on, int& o, int& e) {
  const int lane = threadIdx.x & 31;
  o = u;
  if (back) {  // the first unit v < u that does not begin inside the run
    for (int j0 = 1;; j0 += 32) {
      const int4 t = j0 == 1 ? near.back[lane] : near_back(a, u - j0 - lane);
      // v begins the run's first slot, or lies before it
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
      const int2 t = j0 == 1 ? near.on[lane] : near_on(a, u + j0 + lane);
      const unsigned m = __ballot_sync(kFull, t.x == r && t.y == blk);
      if (m != kFull) {
        e = u + j0 - 1 + (__ffs(~m) - 1);
        break;
      }
    }
  }
}

template <typename TX, typename TO, int NB, bool PER_BASIS, bool WHOLE, typename C>
__global__ void __launch_bounds__(C::kThreads, (min_ctas<NB>() * 256 / C::kThreads))
owned_kernel(const Args a) {
  constexpr int kThreads = C::kThreads, kWarps = kThreads / 32;
  constexpr int VEC = vec_of<TX>();
  constexpr int NX = PER_BASIS ? NB : 1;  // row vectors a slot
  constexpr bool RING = C::kRing;
  constexpr int S = stages(C::kFlight, NX);
  constexpr bool CS = C::kStream;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_run[2][3];  // per split run: first unit, last unit, 1 if this CTA finishes it
  __shared__ Near near;       // the frame around a unit with a split run
  const int RB = a.row_block, span = a.span;
  const int nb_out = a.nb_out, din = a.din, piece = WHOLE ? VEC : a.piece;
  const bool wsum = !PER_BASIS && a.sum_bases;  // one summed weight a slot
  uint4* ring = reinterpret_cast<uint4*>(smem);  // [stage][b][thread]
  float* partial = reinterpret_cast<float*>(smem + (RING ? sizeof(uint4) * kThreads * S * NX : 0));
  int* ld_s = reinterpret_cast<int*>(partial + kThreads * NB * VEC);  // span
  int* src_s = ld_s + span;                                           // span
  float* w_s = reinterpret_cast<float*>(src_s + span);                // [b][span]
  unsigned* seen = reinterpret_cast<unsigned*>(w_s + NB * span);      // a bit a row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u = blockIdx.x;
  long long* stamp = a.stamps + 8 * static_cast<long long>(u);
  if constexpr (C::kStamps)
    if (tid == 0) {
      stamp[0] = global_ns();
      stamp[7] = sm_id();
    }
  const Unit un = unit_at(a, u);
  const int n = un.n;
  const long long L = a.num_slots;

  // 1. staging: pads' source rows and weights are not read
  const bool head_split = un.head_split(RB), tail_split = un.tail_split(RB);
  if (head_split && tid < 32) near.back[tid] = near_back(a, u - 1 - tid);
  if (tail_split && tid >= 32 && tid < 64) near.on[tid - 32] = near_on(a, u - 31 + tid);
  for (int i = tid; i < (RB + 31) / 32; i += kThreads) seen[i] = 0u;
  for (int t = tid; t < n; t += kThreads) {
    const long long l = un.a + t;
    const int ld = a.local[l];
    ld_s[t] = ld;
    if (ld < RB) {
      src_s[t] = a.src[l];
      float ws = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float wb = a.w[b * L + l];
        if constexpr (sizeof(TX) == 2) wb = __bfloat162float(__float2bfloat16_rn(wb));
        ws += wb;
        if (!wsum) w_s[b * span + t] = wb;
      }
      if (wsum) w_s[t] = ws;
    }
  }
  __syncthreads();
  if constexpr (C::kStamps)
    if (tid == 0) stamp[1] = global_ns();
  for (int t = tid; t < n; t += kThreads) {  // a bit a row a run starts in
    const int ld = ld_s[t];
    if (ld < RB && (t == 0 || ld_s[t - 1] != ld)) atomicOr(seen + (ld >> 5), 1u << (ld & 31));
  }
  const long long base = static_cast<long long>(un.blk) * RB;
  const int row_len = nb_out * din;
  const int row_p = nb_out * a.din_p;  // a scratch row: whole vectors a basis
  // 4. the owned rows no run starts in: zeros, a warp a row (whole vectors
  // where rows are whole vectors, else a value a lane)
  auto zero_rows = [&]() {
    const int own_lo = un.first ? 0 : un.prev + 1;
    const int own_hi = un.last ? RB : min(un.l + 1, RB);
    const int own_end =
        static_cast<int>(min(static_cast<long long>(own_hi), a.num_nodes - base));
    const float zeros[VEC] = {};
    const int step = WHOLE || piece == VEC ? VEC : 1;
    for (int r = own_lo + warp; r < own_end; r += kWarps) {
      if ((seen[r >> 5] >> (r & 31)) & 1u) continue;  // warp-uniform
      TO* p = static_cast<TO*>(a.out) + (base + r) * row_len;
      if (step == VEC)
        for (int i = lane * VEC; i < row_len; i += 32 * VEC) store_vec<TO, VEC, CS>(p + i, zeros);
      else
        for (int i = lane; i < row_len; i += 32) store_vec<TO, 1, CS>(p + i, zeros);
    }
  };
  const bool zero_late =
      C::kZero == 1 || (C::kZero == 2 && row_len * sizeof(TO) > kZeroEarlyRowBytes);
  if (!zero_late) {  // CTA-uniform
    __syncthreads();
    zero_rows();
    if constexpr (C::kStamps)
      if (tid == 0) stamp[6] = global_ns();
  }

  // the unit's own rows of the scratch for the split runs it has a part of
  float* part0 = a.part + (static_cast<long long>(u) * 2) * row_p;
  float* part1 = part0 + row_p;

  const int V = (din + VEC - 1) / VEC;
  const int T = V < kThreads ? V : kThreads;
  const int G = min(kThreads / T, kMaxGroups);
  const int g = tid / T, q = tid - g * T;
  const int seg = (n + G - 1) / G;
  const int lo = min(g * seg, n), hi = min(lo + seg, n);
  const int prev_ld = lo > 0 && lo < hi ? ld_s[lo - 1] : -1;  // a run from the group before
  const int next_ld = hi > lo && hi < n ? ld_s[hi] : -1;      // a run into the group after
  float* my_part = partial + (static_cast<long long>(g) * nb_out * T + q) * VEC;  // [g][o][q][e]
  const int n_pass = (V + T - 1) / T;

  for (int pass = 0; pass < n_pass; ++pass) {  // uniform: every thread meets the barriers
    const int v = pass * T + q;
    const bool active = g < G && lo < hi && v < V;
    const int nvalid = WHOLE ? VEC : min(VEC, din - v * VEC);  // values of this vector
    const TX* xc = static_cast<const TX*>(a.x) + static_cast<long long>(v) * VEC;
    float acc[NB][VEC];
#pragma unroll
    for (int o = 0; o < NB; ++o)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[o][e] = 0.f;
    int cur = -1;
    bool head = true, finish = false;

    // a run's sums over this unit to where they go: the scratch row of a
    // split run, else the output row (rows at or past num_nodes dropped)
    auto route = [&](int r) {
      float* p = nullptr;
      if (head_split && r == un.f) p = part0;
      else if (tail_split && r == un.l) p = part1;
      if (p != nullptr) {
#pragma unroll
        for (int o = 0; o < NB; ++o)
          if (o < nb_out) store_vec<float, VEC, false>(p + o * a.din_p + v * VEC, acc[o]);
      } else if (base + r < a.num_nodes) {
        TO* row = static_cast<TO*>(a.out) + (base + r) * row_len + v * VEC;
#pragma unroll
        for (int o = 0; o < NB; ++o)
          if (o < nb_out) store_part<TO, VEC, CS, WHOLE>(row + o * din, acc[o], nvalid, piece);
      }
    };
    auto end_run = [&](bool last_run) {
      if (head && cur == prev_ld) {
#pragma unroll
        for (int o = 0; o < NB; ++o)
          if (o < nb_out)
#pragma unroll
            for (int e = 0; e < VEC; ++e) my_part[o * T * VEC + e] = acc[o][e];
      } else if (last_run && cur == next_ld) {
        finish = true;
      } else {
        route(cur);
      }
    };
    // slot t's vectors into stage s: copies into the ring, or registers
    Vec<TX> reg[RING ? 1 : S][NX];
    auto fetch = [&](int s, int t) {
      if (t >= hi || ld_s[t] >= RB) return;
      const TX* row = xc + static_cast<long long>(src_s[t]) * din;
#pragma unroll
      for (int b = 0; b < NX; ++b) {
        if constexpr (RING)
          copy_vec<TX, C::kL1, WHOLE>(ring + (s * NX + b) * kThreads + tid,
                                      row + b * a.table_plane, nvalid, piece);
        else reg[s][b].load(row + b * a.table_plane);
      }
    };
    auto consume = [&](int s, int t) {
      const int ld = ld_s[t];
      if (ld >= RB) return;  // a pad
      if (ld != cur) {
        if (cur >= 0) {
          end_run(false);
          head = false;
        }
#pragma unroll
        for (int o = 0; o < NB; ++o)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[o][e] = 0.f;
        cur = ld;
      }
      Vec<TX> xv[NX];
#pragma unroll
      for (int b = 0; b < NX; ++b) {
        if constexpr (RING) xv[b].v = ring[(s * NX + b) * kThreads + tid];
        else xv[b] = reg[s][b];
      }
      if (wsum) {
        const float ws = w_s[t];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[0][e] += ws * xv[0].get(e);
      } else if (PER_BASIS && a.sum_bases) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float wb = w_s[b * span + t];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[0][e] += wb * xv[b].get(e);
        }
      } else {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float wb = w_s[b * span + t];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[b][e] += wb * xv[PER_BASIS ? b : 0].get(e);
        }
      }
    };

    if (active) {
      // 3. the walk: slot lo + j in stage j % S, S slots in flight
      const int len = hi - lo;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        fetch(s, lo + s);
        if constexpr (RING) cp_async_commit();
      }
      if constexpr (RING) {
        for (int j = 0; j < len; ++j) {
          const int s = j % S;
          cp_async_wait<S - 1>();
          consume(s, lo + j);
          fetch(s, lo + j + S);
          cp_async_commit();
        }
      } else {
        for (int j0 = 0; j0 < len; j0 += S) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int t = lo + j0 + s;
            if (t >= hi) break;
            consume(s, t);
            fetch(s, t + S);
          }
        }
      }
      if constexpr (RING) cp_async_wait<0>();
      if (cur >= 0) end_run(true);
    }
    __syncthreads();
    if (finish) {  // add the partials of the groups the run goes on into
      for (int g2 = g + 1; g2 < G; ++g2) {
        const float* p2 = partial + (static_cast<long long>(g2) * nb_out * T + q) * VEC;
#pragma unroll
        for (int o = 0; o < NB; ++o)
          if (o < nb_out)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[o][e] += p2[o * T * VEC + e];
        const int after = (g2 + 1) * seg;
        if (after >= n || ld_s[after] != cur) break;  // the run ends in group g2
      }
      route(cur);
    }
    __syncthreads();  // the partials are reused by the next pass
  }

  if constexpr (C::kStamps)
    if (tid == 0) stamp[2] = global_ns();
  if (zero_late) zero_rows();

  // 5. the split runs: this unit's parts are stored; count this unit in on
  // each run's counter (after a barrier, one thread's fence makes the CTA's
  // stores visible first, as cooperative groups' grid sync does); the last
  // to arrive adds the run's parts and stores its row
  if constexpr (C::kStamps)
    if (tid == 0) stamp[3] = stamp[4] = stamp[5] = global_ns();
  if (!head_split && !tail_split) return;  // CTA-uniform
  const bool middle = head_split && tail_split && un.f == un.l;  // one run, both ends split
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool has = k == 0 ? head_split : tail_split && !middle;
      int o = -1, e = -1, last = 0;
      if (has) {
        const int r = k == 0 ? un.f : un.l;
        run_units(a, near, u, un.blk, r, k == 0, k == 1 || middle, o, e);
        if (lane == 0) {
          __threadfence();
          const unsigned old = atomicInc(a.counters + o, static_cast<unsigned>(e - o));
          last = old == static_cast<unsigned>(e - o);
          if (last) __threadfence();
        }
      }
      if (lane == 0) {
        s_run[k][0] = o;
        s_run[k][1] = e;
        s_run[k][2] = last;
      }
    }
  }
  __syncthreads();
  if constexpr (C::kStamps)
    if (tid == 0) stamp[4] = stamp[5] = global_ns();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!s_run[k][2]) continue;  // CTA-uniform
    const int o = s_run[k][0], e = s_run[k][1];
    const long long row = base + (k == 0 ? un.f : un.l);
    if (row >= a.num_nodes) continue;
    TO* qrow = static_cast<TO*>(a.out) + row * row_len;
    // the run's parts, part[o][1] and part[v][0] for v in (o, e]: columns of
    // W floats of the scratch row over the threads, the units split P ways
    // where the row has fewer columns than the CTA threads (a hub's run may
    // span hundreds of units), the P sums added in shared memory (the
    // groups' partials, free now) in order
    constexpr int W = 4;
    const int cols = row_p / W;
    const int P = cols >= kThreads ? 1 : kThreads / cols;
    for (int c0 = 0; c0 < cols; c0 += kThreads) {  // once where P > 1
      const int c = c0 + (P == 1 ? tid : tid % cols), p = P == 1 ? 0 : tid / cols;
      const bool on = c < cols && p < P;
      float s[W];
#pragma unroll
      for (int w = 0; w < W; ++w) s[w] = 0.f;
      if (on) {
#pragma unroll 4
        for (int v = o + p; v <= e; v += P) {
          const float4 t = __ldcg(reinterpret_cast<const float4*>(
              a.part + (2 * static_cast<long long>(v) + (v == o)) * row_p + c * W));
          s[0] += t.x;
          s[1] += t.y;
          s[2] += t.z;
          s[3] += t.w;
        }
      }
      if (P > 1) {
        if (on)
#pragma unroll
          for (int w = 0; w < W; ++w) partial[(p * cols + c) * W + w] = s[w];
        __syncthreads();
        if (on && p == 0)
          for (int p2 = 1; p2 < P; ++p2)
#pragma unroll
            for (int w = 0; w < W; ++w) s[w] += partial[(p2 * cols + c) * W + w];
        __syncthreads();
      }
      if (on && p == 0) {
        // scratch column c * W: basis ob, columns [col, col + W) of its row
        const int ob = c * W / a.din_p, col = c * W - ob * a.din_p;
        TO* qc = qrow + ob * din + col;
        if (col + W <= din && din % W == 0) store_vec<TO, W, CS>(qc, s);
        else store_pieces<TO, W, 1, CS>(qc, s, din - col);
      }
    }
  }
  if constexpr (C::kStamps)
    if (tid == 0) stamp[5] = global_ns();
}

// The owned-row kernel: one launch, its whole-vector form where the pieces
// are whole vectors.
template <typename TX, typename TO, int NB, bool PER_BASIS, typename C>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr int NX = PER_BASIS ? NB : 1;
  const size_t smem = smem_bytes(C::kThreads, a.span, a.row_block, NB, NX, C::kRing,
                                 C::kFlight, vec_of<TX>());
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const auto kernel = a.piece == vec_of<TX>() ? owned_kernel<TX, TO, NB, PER_BASIS, true, C>
                                              : owned_kernel<TX, TO, NB, PER_BASIS, false, C>;
  // all of the SM's 228 KB as shared memory, so that its CTAs fit side by side
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<a.n_chunks * a.parts, C::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// CTAs of the kernel an SM holds at once (occupancy), for a probe.
template <typename TX, typename TO, int NB, bool PER_BASIS, typename C>
int blocks_per_sm(const Args& a) {
  constexpr int NX = PER_BASIS ? NB : 1;
  const size_t smem = smem_bytes(C::kThreads, a.span, a.row_block, NB, NX, C::kRing,
                                 C::kFlight, vec_of<TX>());
  const auto kernel = owned_kernel<TX, TO, NB, PER_BASIS, true, C>;
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, C::kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// Values a copy moves for a table of rows ``din`` wide at ``x``: a whole
// 16-byte vector, else the most values (a power of two) that divide din
// and the table's alignment (kernels.k4_piece).
template <typename TX>
inline int choose_piece(const void* x, int din) {
  const auto addr = reinterpret_cast<std::uintptr_t>(x);
  int p = vec_of<TX>();
  while (p > 1 && (din % p != 0 || addr % (p * sizeof(TX)) != 0)) p /= 2;
  return p;
}

// The units of a launch: span clipped to the chunk, the pieces, the
// launcher's checks (the output and the scratch 16-byte aligned, a table
// aligned to its values; a register ring takes whole vectors only).
template <typename TX, typename C>
inline bool prepare(Args& a, int nb, int span) {
  const auto al = [](const void* p, std::uintptr_t b) {
    return reinterpret_cast<std::uintptr_t>(p) % b == 0;
  };
  if (a.n_chunks < 1 || a.chunk < 1 || a.row_block < 1 || a.din < 1 || nb < 1 ||
      nb > kNbMax || span < 1 || a.part == nullptr || a.counters == nullptr ||
      !al(a.out, 16) || !al(a.part, 16) || !al(a.x, sizeof(TX)))
    return false;
  constexpr int VEC = vec_of<TX>();
  a.piece = choose_piece<TX>(a.x, a.din);
  if ((!C::kRing || !C::kL1) && a.piece != VEC) return false;
  a.din_p = (a.din + VEC - 1) / VEC * VEC;
  a.span = span < a.chunk ? span : a.chunk;
  a.parts = unit_parts(a.chunk, a.span);
  if (static_cast<long long>(a.n_chunks) * a.parts > 0x7fffffffLL / 64) return false;
  a.nb_out = a.sum_bases ? 1 : nb;
  return true;
}

// K4 over units of ``span`` slots: a TX table, per-basis when PER_BASIS;
// an output of TO (f32, or bf16 from a bf16 table); ``a.part`` the scratch
// of two rows a unit, ``a.counters`` one zeroed counter a unit; a kernel
// for each nb.
template <typename TX, typename TO, bool PER_BASIS, typename C = Launcher>
cudaError_t run(Args a, int nb, int span, cudaStream_t st) {
  if (!prepare<TX, C>(a, nb, span)) return cudaErrorInvalidValue;
  switch (nb) {
#define K4O_CASE(N) \
  case N:           \
    return launch<TX, TO, N, PER_BASIS, C>(a, st);
    K4O_CASE(1) K4O_CASE(2) K4O_CASE(3) K4O_CASE(4)
    K4O_CASE(5) K4O_CASE(6) K4O_CASE(7) K4O_CASE(8)
#undef K4O_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace k4o
