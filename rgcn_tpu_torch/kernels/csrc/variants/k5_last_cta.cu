// K5's bf16 form with the narrowing after its main kernel done by each row
// block's last CTA (sm_90a), in place of the narrow_shared_rows launch: the
// TPU kernel narrows its f32 accumulator on a block's closing chunk
// (rgcn_tpu/ops/pallas_basis.py:281-287), and here the closing chunk is the
// CTA that finds, after a __threadfence, that the block's other chunks have
// all counted themselves out of a per-block counter. No serving path
// launches it; rgcn_tpu_torch/compare_k1_k5.py builds it and times it
// beside k5_weighted_aggregate_dedup_bf16.cu.
//
// One launch before the main kernel zeroes the f32 rows of blocks with
// several chunks (weighted_runs.cuh's warp a chunk) and sets each such
// block's counter to its chunk count; the main kernel (weighted_runs.cuh,
// with the hooks below) adds to those rows with atomics, and the block's
// last CTA narrows all its rows, 256 threads, each loading 8 vectors of 4
// sums before it stores them. Arguments as K5's launcher's, then
// ``block_left``: an int a row block (at least ceil(num_nodes /
// row_block)); out_bf16 must be 1.

#include "../weighted_runs.cuh"

namespace {

// zero_shared_rows for an unsorted frame, and the block's counter set to
// the number of its chunks (its chunks are adjacent from its first, c)
__global__ void zero_and_count(const int* __restrict__ chunk_block, float* __restrict__ acc,
                               int* __restrict__ block_left, int n_chunks, int row_block,
                               int row_len, int num_nodes) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * wruns::kWarps + (threadIdx.x >> 5);
  long long r0, r1;
  if (c >= n_chunks || !wruns::shared_rows(chunk_block, nullptr, c, n_chunks, 0, row_block,
                                           num_nodes, 0, r0, r1))
    return;  // warp-uniform
  if (blockIdx.y == 0) {
    const int blk = chunk_block[c];
    int count = 0;
    for (int c0 = c;; c0 += 32) {
      const unsigned same = __ballot_sync(wruns::kFull,
                                          c0 + lane < n_chunks && chunk_block[c0 + lane] == blk);
      count += __ffs(~same) ? __ffs(~same) - 1 : 32;
      if (same != wruns::kFull) break;
    }
    if (lane == 0) block_left[blk] = count;
  }
  wruns::warp_zero(acc + r0 * row_len, (r1 - r0) * row_len, lane);
}

}  // namespace

// (a named namespace: a __global__ template's arguments may not be types of an
// unnamed one)
namespace k5_variant {

// weighted_runs.cuh's frame, and after the sums: a CTA of a row block with
// several chunks fences its atomics and counts itself out of the block's
// counter (Args::hook_data); the one that counts it to 0 narrows the block.
struct LastCtaNarrows : wruns::Frame {
  template <typename TO>
  __device__ static void after(const wruns::Args& a, int blk, bool first, bool last,
                               long long row_len) {
    if (first && last) return;  // CTA-uniform: the block's only chunk stored its rows
    __shared__ int is_last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicSub(static_cast<int*>(a.hook_data) + blk, 1) == 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const long long r0 = static_cast<long long>(blk) * a.row_block;
    const long long r1 = min(r0 + a.row_block, static_cast<long long>(a.num_nodes));
    if (r1 <= r0) return;
    const long long at = r0 * row_len, n = (r1 - r0) * row_len;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + at;
    const float* acc = a.acc + at;
    if (row_len % 4 != 0) {
      for (long long i = threadIdx.x; i < n; i += blockDim.x)
        out[i] = __float2bfloat16_rn(__ldcg(acc + i));
      return;
    }
    constexpr int kDepth = 8;  // vectors a thread loads before it stores
    const long long n4 = n / 4, step = static_cast<long long>(blockDim.x) * kDepth;
    for (long long i0 = threadIdx.x; i0 < n4; i0 += step) {
      float4 v[kDepth];
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        const long long i = i0 + j * static_cast<long long>(blockDim.x);
        if (i < n4) v[j] = __ldcg(reinterpret_cast<const float4*>(acc) + i);
      }
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        const long long i = i0 + j * static_cast<long long>(blockDim.x);
        if (i >= n4) break;
        const unsigned w0 =
            static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[j].x))) |
            (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[j].y))) << 16);
        const unsigned w1 =
            static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[j].z))) |
            (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[j].w))) << 16);
        reinterpret_cast<uint2*>(out)[i] = make_uint2(w0, w1);
      }
    }
  }
};

}  // namespace k5_variant

extern "C" int k5_last_cta(const __nv_bfloat16* x, const int* src, const float* w_k,
                           const int* local_k, const int* chunk_block, void* out, float* scratch,
                           int n_chunks, int chunk, int row_block, int kk, int nb, int din,
                           int num_nodes, int out_bf16, int* block_left, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!out_bf16 || nb < 1 || nb > 8 || scratch == nullptr || block_left == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  wruns::Args a{};
  a.x = x;
  a.src = src;
  a.w = w_k;
  a.local = local_k;
  a.chunk_block = chunk_block;
  a.out = out;
  a.acc = scratch;
  a.num_slots = static_cast<long long>(n_chunks) * chunk;
  a.n_chunks = n_chunks;
  a.chunk = chunk;
  a.row_block = row_block;
  a.kk = kk;
  a.din = din;
  a.num_nodes = num_nodes;
  a.hook_data = block_left;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = din % 8 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(scratch) % 16 == 0;
  const size_t smem = wruns::smem_bytes(row_block, kk, chunk, nb, wide ? 8 : 1);
  if (smem > wruns::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  zero_and_count<<<wruns::rows_grid(n_chunks, 0), wruns::kThreads, 0, st>>>(
      chunk_block, scratch, block_left, n_chunks, row_block, nb * din, num_nodes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  using Hooks = k5_variant::LastCtaNarrows;
  switch (nb) {
#define K5_CASE(N)                                                                 \
  case N:                                                                          \
    err = wide ? wruns::launch_runs<bf16, bf16, 8, N, false, Hooks>(a, smem, st)   \
               : wruns::launch_runs<bf16, bf16, 1, N, false, Hooks>(a, smem, st);  \
    break;
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4) K5_CASE(5) K5_CASE(6) K5_CASE(7) K5_CASE(8)
#undef K5_CASE
  }
  return static_cast<int>(err);
}
