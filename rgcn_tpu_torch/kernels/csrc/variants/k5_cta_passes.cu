// K5's bf16 form with the passes around its main kernel as they were before
// (sm_90a): a CTA a chunk for the zeroing before and the narrowing after,
// and the narrowing one f32 value read and one bf16 value written a thread.
// No serving path launches it; rgcn_tpu_torch/compare_k1_k5.py builds it
// and times it beside k5_weighted_aggregate_dedup_bf16.cu, whose passes
// (weighted_runs.cuh) give each chunk a warp and narrow 4 values a lane.
// The main kernel is weighted_runs.cuh's. Arguments as K5's launcher's;
// out_bf16 must be 1.

#include "../weighted_runs.cuh"

namespace {

constexpr int kParts = 16;  // CTAs over one row block's rows

// every row of a row block with several chunks, for the CTAs of its first
// chunk c = blockIdx.x (K5's frame is sorted by source within a block)
__device__ bool block_rows(const int* __restrict__ chunk_block, int n_chunks, int row_block,
                           int num_nodes, long long& r0, long long& r1) {
  const int c = blockIdx.x;
  const int blk = chunk_block[c];
  if (c + 1 >= n_chunks || chunk_block[c + 1] != blk) return false;
  if (c > 0 && chunk_block[c - 1] == blk) return false;
  r0 = static_cast<long long>(blk) * row_block;
  r1 = min(r0 + row_block, static_cast<long long>(num_nodes));
  return r1 > r0;
}

__global__ void zero_cta(const int* __restrict__ chunk_block, float* __restrict__ acc,
                         int n_chunks, int row_block, int row_len, int num_nodes) {
  long long r0, r1;
  if (!block_rows(chunk_block, n_chunks, row_block, num_nodes, r0, r1)) return;
  float* p = acc + r0 * row_len;
  const long long n = (r1 - r0) * row_len;
  // scalars up to a 16-byte boundary, then vectors, then the scalar tail
  const long long head =
      min(n, static_cast<long long>((4 - (reinterpret_cast<std::uintptr_t>(p) / 4) % 4) % 4));
  const long long n4 = (n - head) / 4;
  if (blockIdx.y == 0) {
    if (threadIdx.x < head) p[threadIdx.x] = 0.f;
    for (long long i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
  }
  float4* p4 = reinterpret_cast<float4*>(p + head);
  const long long part = (n4 + gridDim.y - 1) / gridDim.y;
  const long long end = min(n4, (blockIdx.y + 1) * part);
  for (long long i = blockIdx.y * part + threadIdx.x; i < end; i += blockDim.x)
    p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void narrow_cta(const int* __restrict__ chunk_block, const float* __restrict__ acc,
                           __nv_bfloat16* __restrict__ out, int n_chunks, int row_block,
                           int row_len, int num_nodes) {
  long long r0, r1;
  if (!block_rows(chunk_block, n_chunks, row_block, num_nodes, r0, r1)) return;
  const long long lo = r0 * row_len, n = (r1 - r0) * row_len;
  const long long part = (n + gridDim.y - 1) / gridDim.y;
  const long long end = min(n, (blockIdx.y + 1) * part);
  for (long long i = blockIdx.y * part + threadIdx.x; i < end; i += blockDim.x)
    out[lo + i] = __float2bfloat16_rn(acc[lo + i]);
}

}  // namespace

extern "C" int k5_cta_passes(const __nv_bfloat16* x, const int* src, const float* w_k,
                             const int* local_k, const int* chunk_block, void* out,
                             float* scratch, int n_chunks, int chunk, int row_block, int kk,
                             int nb, int din, int num_nodes, int out_bf16, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!out_bf16 || nb < 1 || nb > 8 || scratch == nullptr)
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = din % 8 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(scratch) % 16 == 0;
  const size_t smem = wruns::smem_bytes(row_block, kk, chunk, nb, wide ? 8 : 1);
  if (smem > wruns::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_chunks, kParts);
  zero_cta<<<grid, wruns::kThreads, 0, st>>>(chunk_block, scratch, n_chunks, row_block,
                                             nb * din, num_nodes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (nb) {
#define K5_CASE(N)                                                                 \
  case N:                                                                          \
    err = wide ? wruns::launch_runs<bf16, bf16, 8, N, false>(a, smem, st)          \
               : wruns::launch_runs<bf16, bf16, 1, N, false>(a, smem, st);         \
    break;
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4) K5_CASE(5) K5_CASE(6) K5_CASE(7) K5_CASE(8)
#undef K5_CASE
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  narrow_cta<<<grid, wruns::kThreads, 0, st>>>(chunk_block, scratch, static_cast<bf16*>(out),
                                               n_chunks, row_block, nb * din, num_nodes);
  return static_cast<int>(cudaGetLastError());
}
