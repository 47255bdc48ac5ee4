// K5's earlier design: (chunk, 32-column group) CTAs and one f32 atomic
// per (lane, basis, column) into a zeroed basis-major output (sm_90a).
//
// No serving path launches it; rgcn_tpu_torch/compare_k4_k5.py builds it
// and times it beside K5 (k5_weighted_aggregate_dedup.cu), which replaced
// it. Unlike K5 it writes the output basis-major, (nb, num_nodes, din), and
// its launcher memsets the whole output first.
//
// Replaces rgcn_tpu/ops/pallas_basis.py::weighted_aggregate_dedup_pallas.
// Over a DedupFwdLayout each gather slot l holds one source row x[src[l]]
// and up to K (local destination, weight) lanes: for every basis b < nb,
//     agg[b, n] = sum over slots l, lanes k with destination n of
//                 w_k[k, b, l] * x[src[l]]
// where lane k of slot l in chunk c targets chunk_block[c] * RB +
// local_k[k, l] and local_k == RB marks an empty lane. A slot whose lanes
// are all empty is a pad: its src and weights are never read.
//
// Bound on the H100: bytes, as K4's: 2 * nb flops per lane and column
// against 4 bytes of row read once per slot. At lp-WN18 (118,016 slots of
// which the real ones carry 95,479 lanes, din 200, nb 2) the card must read
// the referenced rows and write the (nb, N, din) output once.
//
// Design. As K4: (chunk, 32-column group) CTAs of 8 warps, warp w owns 32
// consecutive slots, lane i owns one column. Each lane loads one slot's
// src (only when some lane of the slot is real); the warp walks its slots
// with shuffles and gathers each source row segment once, then fans it out
// to the slot's K lanes. The slots of a block are sorted by source, not by
// destination, so each real lane adds w * row to its destination with an
// f32 atomic (a fire-and-forget reduction) into the output, which the
// launcher zeroes first on the same stream. Results equal a sequential f32
// sum up to reassociation.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <int NB>
__global__ void __launch_bounds__(kThreads)
k5_weighted_aggregate_dedup_kernel(const float* __restrict__ x,
                                   const int* __restrict__ src,
                                   const float* __restrict__ w_k,
                                   const int* __restrict__ local_k,
                                   const int* __restrict__ chunk_block,
                                   float* __restrict__ out,
                                   int chunk, int row_block, int kk, int din,
                                   long long num_slots, int num_nodes) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  const bool col_ok = c < din;
  const long long block_base =
      static_cast<long long>(chunk_block[blockIdx.x]) * row_block;
  const long long plane = static_cast<long long>(num_nodes) * din;

  for (int s0 = warp * 32; s0 < chunk; s0 += kThreads) {
    const long long slot0 = static_cast<long long>(blockIdx.x) * chunk + s0;
    int my_src = -1;  // -1: pad slot (every lane empty)
    if (s0 + lane < chunk) {
      bool real = false;
      for (int k = 0; k < kk; ++k)
        real |= local_k[k * num_slots + slot0 + lane] < row_block;
      if (real) my_src = src[slot0 + lane];
    }
    for (int j = 0; j < 32; ++j) {
      const int s = __shfl_sync(kFull, my_src, j);
      if (s < 0 || !col_ok) continue;  // no shuffle follows in this trip
      const long long slot = slot0 + j;
      const float v = x[static_cast<long long>(s) * din + c];
      for (int k = 0; k < kk; ++k) {
        const int ld = local_k[k * num_slots + slot];
        if (ld >= row_block) continue;  // empty lane
        if (block_base + ld >= num_nodes) continue;  // past the output
        float* dst = out + (block_base + ld) * din + c;
        const float* wl = w_k + static_cast<long long>(k) * NB * num_slots + slot;
#pragma unroll
        for (int b = 0; b < NB; ++b) atomicAdd(dst + b * plane, wl[b * num_slots] * v);
      }
    }
  }
}

template <int NB>
cudaError_t launch(const float* x, const int* src, const float* w_k,
                   const int* local_k, const int* chunk_block, float* out,
                   int n_chunks, int chunk, int row_block, int kk, int din,
                   int num_nodes, cudaStream_t stream) {
  const dim3 grid(n_chunks, (din + 31) / 32);
  k5_weighted_aggregate_dedup_kernel<NB><<<grid, kThreads, 0, stream>>>(
      x, src, w_k, local_k, chunk_block, out, chunk, row_block, kk, din,
      static_cast<long long>(n_chunks) * chunk, num_nodes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k5_column_atomics(const float* x, const int* src,
                                           const float* w_k,
                                           const int* local_k,
                                           const int* chunk_block, float* out,
                                           int n_chunks, int chunk,
                                           int row_block, int kk, int nb,
                                           int din, int num_nodes,
                                           void* stream) {
  if (n_chunks < 1 || chunk < 1 || din < 1 || kk < 1 || nb < 1 || nb > 8)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * nb * num_nodes * din, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (nb) {
#define K5_CASE(N)                                                         \
  case N:                                                                  \
    err = launch<N>(x, src, w_k, local_k, chunk_block, out, n_chunks,      \
                    chunk, row_block, kk, din, num_nodes, st);             \
    break;
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4)
    K5_CASE(5) K5_CASE(6) K5_CASE(7) K5_CASE(8)
#undef K5_CASE
  }
  return static_cast<int>(err);
}
