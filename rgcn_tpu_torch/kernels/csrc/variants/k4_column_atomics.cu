// K4's earlier design: (chunk, 32-column group) CTAs and f32 atomics into
// a zeroed basis-major output (sm_90a).
//
// No serving path launches it; rgcn_tpu_torch/compare_k4_k5.py builds it
// and times it beside K4 (k4_weighted_aggregate.cu), which replaced it.
// Unlike K4 it writes the output basis-major, (nb or 1, num_nodes, din),
// and its launcher memsets the whole output first.
//
// Replaces rgcn_tpu/ops/pallas_basis.py::weighted_aggregate_pallas. Over a
// destination-sorted chunk layout (DstLayout, or the merged pair frame's)
// it computes, for every basis b < nb,
//     agg[b, n] = sum over slots l with destination n of w[b, l] * row(b, l)
// where slot l of chunk c targets node chunk_block[c] * RB + local_dst[l]
// (local_dst == RB marks a pad, skipped before anything else of the slot is
// read) and row(b, l) = x[src[l]] for a shared (rows, din) table, or
// x[b, src[l]] for per-basis (nb, rows, din) tables. With sum_bases the
// nb products are summed into one output, agg[0, n].
//
// Bound on the H100: bytes. One multiply-add per (real slot, basis,
// column) against a row of din floats read per slot: 2 * nb flops per 4
// bytes, far below the f32 ridge. At lp-WN18 (95,479 real slots, din 200,
// nb 2) the card must read the table rows the slots reference and write
// the (nb, N, din) output once, about 100 MB, ~30 us at 3.35 TB/s.
//
// Design. The TPU kernel walks chunks in order and carries each row block's
// sum in VMEM; a row block with many chunks (the hubs: 24 chunks against a
// median of 1 at lp-WN18) is one long serial run. Here the work is spread
// over (chunk, 32-column group) CTAs of 8 warps; warp w of a CTA owns 32
// consecutive slots of the chunk and lane i owns column 32 * group + i.
// Each lane loads one slot's local_dst and, for a real slot, its src; the
// warp walks its 32 slots with shuffles, gathering one coalesced 128-byte
// row segment per slot, and keeps per-basis sums in registers while the
// destination stays the same (slots are destination-sorted within a
// block). When the destination changes the sums go to the output with
// f32 atomics (fire-and-forget reductions), so a destination split over
// warps, CTAs or chunks is finished there. The launcher zeroes the output
// first on the same stream: rows that no real slot reaches come out zero.
// Atomics add in no fixed order: results equal a sequential f32 sum up to
// reassociation.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <int NB>
__device__ __forceinline__ void flush(float* __restrict__ out, const float (&acc)[NB],
                                      int n_out, long long node, int c,
                                      int din, long long plane,
                                      int num_nodes) {
  if (node >= num_nodes) return;  // past the output: dropped, as the plain slice
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b < n_out) atomicAdd(out + b * plane + node * din + c, acc[b]);
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
k4_weighted_aggregate_kernel(const float* __restrict__ x,
                             const int* __restrict__ src,
                             const float* __restrict__ w,
                             const int* __restrict__ local_dst,
                             const int* __restrict__ chunk_block,
                             float* __restrict__ out,
                             int chunk, int row_block, int din,
                             long long num_slots, long long table_plane,
                             int num_nodes, int per_basis_rows,
                             int sum_bases) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  const bool col_ok = c < din;
  const long long block_base =
      static_cast<long long>(chunk_block[blockIdx.x]) * row_block;
  const long long plane = static_cast<long long>(num_nodes) * din;
  const int n_out = sum_bases ? 1 : NB;

  for (int s0 = warp * 32; s0 < chunk; s0 += kThreads) {
    const long long slot0 = static_cast<long long>(blockIdx.x) * chunk + s0;
    int my_ld = row_block;
    int my_src = 0;
    if (s0 + lane < chunk) {
      my_ld = local_dst[slot0 + lane];
      if (my_ld < row_block) my_src = src[slot0 + lane];
    }
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    int cur = -1;
    for (int j = 0; j < 32; ++j) {
      const int ld = __shfl_sync(kFull, my_ld, j);
      const int s = __shfl_sync(kFull, my_src, j);
      if (ld >= row_block) continue;  // pad: warp-uniform
      if (ld != cur) {
        if (cur >= 0 && col_ok) flush<NB>(out, acc, n_out, block_base + cur, c, din, plane, num_nodes);
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b] = 0.f;
        cur = ld;
      }
      if (col_ok) {
        const long long slot = slot0 + j;
        const long long row = static_cast<long long>(s) * din + c;
        if (per_basis_rows && sum_bases) {
          float t = 0.f;
#pragma unroll
          for (int b = 0; b < NB; ++b) t += w[b * num_slots + slot] * x[b * table_plane + row];
          acc[0] += t;
        } else if (per_basis_rows) {
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[b] += w[b * num_slots + slot] * x[b * table_plane + row];
        } else {
          const float v = x[row];
          if (sum_bases) {
            float t = 0.f;
#pragma unroll
            for (int b = 0; b < NB; ++b) t += w[b * num_slots + slot];
            acc[0] += t * v;
          } else {
#pragma unroll
            for (int b = 0; b < NB; ++b) acc[b] += w[b * num_slots + slot] * v;
          }
        }
      }
    }
    if (cur >= 0 && col_ok) flush<NB>(out, acc, n_out, block_base + cur, c, din, plane, num_nodes);
  }
}

template <int NB>
cudaError_t launch(const float* x, const int* src, const float* w,
                   const int* local_dst, const int* chunk_block, float* out,
                   int n_chunks, int chunk, int row_block, int din,
                   int table_rows, int num_nodes, int per_basis_rows,
                   int sum_bases, cudaStream_t stream) {
  const dim3 grid(n_chunks, (din + 31) / 32);
  k4_weighted_aggregate_kernel<NB><<<grid, kThreads, 0, stream>>>(
      x, src, w, local_dst, chunk_block, out, chunk, row_block, din,
      static_cast<long long>(n_chunks) * chunk,
      static_cast<long long>(table_rows) * din, num_nodes, per_basis_rows,
      sum_bases);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k4_column_atomics(const float* x, const int* src,
                                     const float* w, const int* local_dst,
                                     const int* chunk_block, float* out,
                                     int n_chunks, int chunk, int row_block,
                                     int nb, int din, int table_rows,
                                     int num_nodes, int per_basis_rows,
                                     int sum_bases, void* stream) {
  if (n_chunks < 1 || chunk < 1 || din < 1 || nb < 1 || nb > 8)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_out = sum_bases ? 1 : nb;
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * n_out * num_nodes * din, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (nb) {
#define K4_CASE(N)                                                           \
  case N:                                                                    \
    err = launch<N>(x, src, w, local_dst, chunk_block, out, n_chunks, chunk, \
                    row_block, din, table_rows, num_nodes, per_basis_rows,   \
                    sum_bases, st);                                          \
    break;
    K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4)
    K4_CASE(5) K4_CASE(6) K4_CASE(7) K4_CASE(8)
#undef K4_CASE
  }
  return static_cast<int>(err);
}
