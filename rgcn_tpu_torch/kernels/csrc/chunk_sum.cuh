// A chunk's slots summed by their local destination in slot order, and the
// chunks of a row block finished by the last of their CTAs in chunk order,
// for Hopper (sm_90a). Used by K2 (k2_fused.cu, k2_fused_bf16.cu) and by
// K1's route for layouts whose row blocks are not sorted by destination
// (k1_aggregate.cuh, kChunk). One launch, no memset, no atomics on the
// output: the same inputs give the same bits on every launch.
//
// The frame: slot l of chunk c targets row chunk_block[c] * RB +
// local_dst[l] (RB marks a pad); every row block has at least one chunk and
// a block's chunks are adjacent (chunk_block is non-decreasing), as every
// builder lays them out; rows at or past num_nodes are dropped.
//
// Design. A CTA takes one chunk, a warp 32 consecutive slots at a time. A
// producer P (K2: val * (x[src] @ W[rel]); K1: msgs[row]) gives each live
// slot's message, a slice of at most kSlice columns at a time, in
// registers; each run of slots of one destination within the warp (the
// fused layout keeps a relation's slots in destination order, so a hub's
// slots come in runs) is summed to its first lane by a fixed tree of
// shuffles, and that lane stores the run's sum as f32 in shared memory and
// sets its bit in its row's mask there (one bit a slot, words laid out
// [word][row] so that a warp's rows read distinct banks), and one bit a row
// marks the rows the chunk reaches. Then each thread takes a (row, 16-byte
// vector) of the block, so that a warp's stores are consecutive, and adds
// the runs of its row's set bits in increasing slot order. Every sum is
// taken in an order fixed by the layout (a row's runs of a 512-slot chunk
// are at most 16 bits, where a sum slot by slot walked a hub's 512 one
// after another). A block of one chunk stores its rows (zeros where no
// slot reaches) straight to the output. A block of several chunks stores
// the rows each chunk reaches to its (RB, dout) partial tile in the f32
// scratch ``part``, and its row bits after the tiles, and counts the CTA
// in on its block's counter (atomicInc on the counter of the block's first
// chunk, bounded by the block's chunk count, after a fence); the last to
// arrive adds, for each row, the tiles of the chunks that reached it in
// chunk order and stores the row once, and atomicInc's wrap leaves the
// counter 0 again. The counters are the launcher's to keep (zeroed once,
// one set a stream).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace csum {

constexpr int kMaxThreads = 512;
constexpr int kSlice = 32;  // output columns a pass holds, at most
constexpr size_t kMaxSmem = 232448;

// Output columns a pass holds: the power of two at least dout, from 4 to
// kSlice (a compile-time width, so that a narrow row keeps few registers).
inline int slice(int dout) {
  int ks = 4;
  while (ks < dout && ks < kSlice) ks *= 2;
  return ks;
}

struct Frame {
  const int* local_dst;    // (n_chunks, chunk)
  const int* chunk_block;  // (n_chunks,)
  void* out;               // (num_nodes, dout), f32 or bf16
  float* part;             // (n_chunks, row_block, dout) partial tiles, then each
                           // chunk's (row_block + 31) / 32 words of reached rows
  unsigned* counters;      // (n_chunks,): zero on entry and on exit
  int n_chunks, chunk, row_block, dout, num_nodes;
  // a probe's %globaltimer stamps, 8 a CTA (start, staged, rows summed and
  // stored, messages staged, counted in, end, SM, 1 if it finished its
  // block), else null
  long long* stamps;
};

// Threads of a CTA: a slot or a row each, 64 to kMaxThreads.
inline int threads(int chunk, int row_block) {
  int t = chunk > row_block ? chunk : row_block;
  t = (t + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

// Floats between two slots' messages in shared memory: the slice, and 4
// more from 8 columns up, so that the 16-byte reads of a warp's rows (slots
// at random) spread over all 32 banks rather than over 8 (a stride of 16 or
// 32 floats maps every slot to the same few banks).
__host__ __device__ constexpr int pitch(int ks) { return ks == 4 ? 4 : ks + 4; }

// Shared memory of a CTA: a slice's columns of each slot's message, and a
// bit a slot for each row of the block.
inline size_t smem_bytes(int chunk, int row_block, int dout) {
  return sizeof(float) * static_cast<size_t>(chunk) * pitch(slice(dout)) +
         sizeof(unsigned) * (static_cast<size_t>((chunk + 31) / 32) * row_block +
                             (row_block + 31) / 32);
}

template <typename TO>
__device__ __forceinline__ void put(TO* p, float v) {
  if constexpr (sizeof(TO) == 4) *p = v;
  else *p = __float2bfloat16_rn(v);
}

// 4 consecutive f32 sums to an f32 (one 16-byte store) or a bf16 row.
template <typename TO>
__device__ __forceinline__ void put4(TO* p, float4 v) {
  if constexpr (sizeof(TO) == 4) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = __float2bfloat16_rn(v.x);
    p[1] = __float2bfloat16_rn(v.y);
    p[2] = __float2bfloat16_rn(v.z);
    p[3] = __float2bfloat16_rn(v.w);
  }
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

// A probe's stamp k of this CTA (thread 0; nothing without ``stamps``).
__device__ __forceinline__ void stamp(long long* stamps, int k) {
  if (stamps != nullptr && threadIdx.x == 0) {
    long long* at =
        stamps + 8 * ((static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y) * gridDim.z +
                      blockIdx.z);
    at[k] = global_ns();
    if (k == 0) at[6] = sm_id();
  }
}

// Unroll of the last CTA's loads: that many chunks' values in flight a
// thread before they are added, in chunk order.
constexpr int kFinishBatch = 8;

// The first (dir -1) or last (dir +1) chunk of chunk c's row block b: one
// warp, 32 neighbours a step.
__device__ __forceinline__ int block_edge(const int* __restrict__ chunk_block, int c, int b,
                                          int n_chunks, int dir) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 1;; j0 += 32) {
    const int v = c + dir * (j0 + lane);
    const bool stop = v < 0 || v >= n_chunks || chunk_block[v] != b;
    const unsigned m = __ballot_sync(0xffffffffu, stop);
    if (m) return c + dir * (j0 + __ffs(m) - 2);
  }
}

// A probe's switches (variants/k1_k2_probe.cu; 0 on every serving path):
// kSkipMessage leaves each message 0 (its slot's loads stay), kSkipRows
// skips the rows' sums and stores, kSkipStores keeps the sums but stores
// nothing. The results are then wrong; only the time is read.
constexpr int kSkipMessage = 1, kSkipRows = 2, kSkipStores = 4;

// Two CTAs an SM (at most 64 registers a thread): with all 128 registers
// a thread may have, one 512-thread CTA held a whole SM and a layout of 296
// chunks ran in 2.25 waves.
template <typename P, typename TO, int KS, int PROBE = 0>
__global__ void __launch_bounds__(kMaxThreads, 2) chunk_kernel(const Frame f, const P prod) {
  extern __shared__ float4 smem4[];
  const int RB = f.row_block, ch = f.chunk, dout = f.dout;
  const int words = (ch + 31) / 32, rwords = (RB + 31) / 32;
  constexpr int st = pitch(KS);  // floats a slot's message takes in shared memory
  float* msg_s = reinterpret_cast<float*>(smem4);                     // [slot][st]
  unsigned* mask = reinterpret_cast<unsigned*>(msg_s + static_cast<size_t>(ch) * st);  // [word][row]
  unsigned* rmask = mask + static_cast<size_t>(words) * RB;  // a bit a row a slot reaches
  __shared__ int s_edge[2];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, T = blockDim.x;
  const int c = blockIdx.x;
  stamp(f.stamps, 0);
  const int b = f.chunk_block[c];
  const long long chunk0 = static_cast<long long>(c) * ch;
  const long long base = static_cast<long long>(b) * RB;
  const int rows = static_cast<int>(min(static_cast<long long>(RB), f.num_nodes - base));
  if (warp < 2) {  // the block's first and last chunk
    const int e = block_edge(f.chunk_block, c, b, f.n_chunks, warp == 0 ? -1 : 1);
    if ((tid & 31) == 0) s_edge[warp] = e;
  }
  for (int i = tid; i < words * RB + rwords; i += T) mask[i] = 0u;
  __syncthreads();
  const int c0 = s_edge[0], c1 = s_edge[1];
  const bool alone = c0 == c1;
  const long long tile_len = static_cast<long long>(RB) * dout;
  float* tile = f.part + static_cast<long long>(c) * tile_len;
  // after the tiles, each chunk's rmask (a bit a row it reached)
  unsigned* part_mask = reinterpret_cast<unsigned*>(f.part + f.n_chunks * tile_len);
  const bool vec4 = dout % 4 == 0;  // rows of whole 16-byte vectors
  const int unit = vec4 ? 4 : 1;     // columns a thread of the row pass takes
  stamp(f.stamps, 1);

  for (int o0 = 0; o0 < dout; o0 += KS) {
    const int ns = min(KS, dout - o0);
    // the slice's messages, a warp 32 consecutive slots: each run of one
    // destination within the warp (a hub's slots come in such runs) summed
    // to its first lane by a fixed tree of shuffles, which stores the sum
    // and, on the first slice, sets its bit in the row's mask
    for (int t0 = warp * 32; t0 < ch; t0 += T) {  // warp-uniform
      const int t = t0 + lane;
      int key = -1;  // the slot's row, -1 for a pad, a gap or a dropped row
      float m[KS];
#pragma unroll
      for (int j = 0; j < KS; ++j) m[j] = 0.f;
      if (t < ch) {
        const long long slot = chunk0 + t;
        const int ld = f.local_dst[slot];
        const typename P::Slot s = prod.load(slot);
        if (ld < RB && ld < rows && prod.live(s)) {
          key = ld;
          if constexpr (!(PROBE & kSkipMessage)) prod.template message<KS>(s, o0, ns, m);
        }
      }
      const int prev = __shfl_up_sync(0xffffffffu, key, 1);
      const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || key != prev);
      const unsigned later = lane == 31 ? 0u : heads & (~0u << (lane + 1));
      const int end = later ? __ffs(later) - 1 : 32;  // the lane after this run
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const float o = __shfl_down_sync(0xffffffffu, m[j], off);
          if (lane + off < end) m[j] += o;
        }
      }
      if (key >= 0 && ((heads >> lane) & 1u)) {
        float* q = msg_s + static_cast<long long>(t) * st;
#pragma unroll
        for (int j = 0; j < KS; j += 4)
          *reinterpret_cast<float4*>(q + j) = make_float4(m[j], m[j + 1], m[j + 2], m[j + 3]);
        if (o0 == 0) {
          atomicOr(mask + (t >> 5) * RB + key, 1u << (t & 31));
          atomicOr(rmask + (key >> 5), 1u << (key & 31));
        }
      }
    }
    __syncthreads();
    if (o0 == 0) stamp(f.stamps, 3);
    // each row's sum in slot order, a thread a (row, vector): to the output
    // (zeros where no slot reaches), or the reached rows to the chunk's
    // tile; a warp's stores are consecutive vectors of consecutive rows
    const int per_row = (ns + unit - 1) / unit;
    const int items = ((PROBE & kSkipRows) ? 0 : rows) * per_row;
    for (int i = tid; i < items; i += T) {
      const int r = i / per_row, j0 = (i - r * per_row) * unit;
      const bool reached = (rmask[r >> 5] >> (r & 31)) & 1u;
      if (!alone && !reached) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (reached) {
        for (int w = 0; w < words; ++w) {
          unsigned bits = mask[w * RB + r];
          while (bits) {
            const int t = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            const float* m = msg_s + static_cast<long long>(t) * st + j0;
            if (vec4) {
              const float4 v = *reinterpret_cast<const float4*>(m);
              acc[0] += v.x;
              acc[1] += v.y;
              acc[2] += v.z;
              acc[3] += v.w;
            } else {
              acc[0] += m[0];
            }
          }
        }
      }
      if constexpr ((PROBE & kSkipStores) != 0) {
        if (acc[0] != -1.2345f) continue;  // keeps the sums, stores next to nothing
      }
      const long long at = static_cast<long long>(r) * dout + o0 + j0;
      if (alone) {
        TO* q = static_cast<TO*>(f.out) + base * dout + at;
        if (vec4) put4<TO>(q, make_float4(acc[0], acc[1], acc[2], acc[3]));
        else put<TO>(q, acc[0]);
      } else {
        if (vec4) *reinterpret_cast<float4*>(tile + at) = make_float4(acc[0], acc[1], acc[2], acc[3]);
        else tile[at] = acc[0];
      }
    }
    __syncthreads();  // the messages are rewritten by the next slice
  }
  stamp(f.stamps, 2);
  if (alone) {  // CTA-uniform
    stamp(f.stamps, 5);
    return;
  }

  // count this chunk in, its rmask stored first; the block's last CTA adds
  // the tiles' reached rows in chunk order
  for (int w = tid; w < rwords; w += T) part_mask[static_cast<long long>(c) * rwords + w] = rmask[w];
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const unsigned old = atomicInc(f.counters + c0, static_cast<unsigned>(c1 - c0));
    s_last = old == static_cast<unsigned>(c1 - c0);
    if (s_last) __threadfence();
  }
  __syncthreads();
  stamp(f.stamps, 4);
  if (!s_last) return;
  const int n_tiles = c1 - c0 + 1;
  const float* first = f.part + static_cast<long long>(c0) * tile_len;
  // the block's rmasks, in shared memory where they fit (the messages' room)
  const unsigned* masks = part_mask + static_cast<long long>(c0) * rwords;
  const bool cached = static_cast<long long>(n_tiles) * rwords <= static_cast<long long>(ch) * st;
  if (cached) {
    unsigned* ms = reinterpret_cast<unsigned*>(msg_s);
    for (int i = tid; i < n_tiles * rwords; i += T) ms[i] = __ldcg(masks + i);
    masks = ms;
  }
  __syncthreads();
  TO* out = static_cast<TO*>(f.out) + base * dout;
  const int per_row = (dout + unit - 1) / unit;
  // a thread a (row, vector): the chunks that reached the row, kFinishBatch
  // loads in flight, added in chunk order
  for (int i = tid; i < rows * per_row; i += T) {
    const int r = i / per_row, j0 = (i - r * per_row) * unit;
    const long long at = static_cast<long long>(r) * dout + j0;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cc = 0; cc < n_tiles; cc += kFinishBatch) {
      float4 v[kFinishBatch];
      bool hit[kFinishBatch];
#pragma unroll
      for (int k = 0; k < kFinishBatch; ++k) {
        hit[k] = cc + k < n_tiles && ((masks[(cc + k) * rwords + (r >> 5)] >> (r & 31)) & 1u);
        if (hit[k]) {
          const float* src = first + (cc + k) * tile_len + at;
          if (vec4) v[k] = __ldcg(reinterpret_cast<const float4*>(src));
          else v[k] = make_float4(__ldcg(src), 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < kFinishBatch; ++k) {
        if (hit[k]) {
          s.x += v[k].x;
          s.y += v[k].y;
          s.z += v[k].z;
          s.w += v[k].w;
        }
      }
    }
    if (vec4) put4<TO>(out + at, s);
    else put<TO>(out + at, s.x);
  }
  if (f.stamps != nullptr && tid == 0) f.stamps[8 * static_cast<long long>(c) + 7] = 1;
  stamp(f.stamps, 5);
}

// One launch over the layout's chunks; the caller checks the frame.
template <typename P, typename TO, int KS, int PROBE = 0>
cudaError_t launch_ks(const Frame& f, const P& prod, cudaStream_t st) {
  const size_t smem = smem_bytes(f.chunk, f.row_block, f.dout);
  if (smem > kMaxSmem || f.part == nullptr || f.counters == nullptr) return cudaErrorInvalidValue;
  const auto kernel = chunk_kernel<P, TO, KS, PROBE>;
  if (smem > 32 * 1024) {  // past 48 KB with the static shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<f.n_chunks, threads(f.chunk, f.row_block), smem, st>>>(f, prod);
  return cudaGetLastError();
}

template <typename P, typename TO, int PROBE = 0>
cudaError_t launch(const Frame& f, const P& prod, cudaStream_t st) {
  switch (slice(f.dout)) {
    case 4: return launch_ks<P, TO, 4, PROBE>(f, prod, st);
    case 8: return launch_ks<P, TO, 8, PROBE>(f, prod, st);
    case 16: return launch_ks<P, TO, 16, PROBE>(f, prod, st);
    default: return launch_ks<P, TO, kSlice, PROBE>(f, prod, st);
  }
}

}  // namespace csum
