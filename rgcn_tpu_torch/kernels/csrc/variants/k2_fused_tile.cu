// K2's rejected alternative: a shared-memory tile per chunk (sm_90a).
//
// The same function as K2, with the C signature K2 had before its
// fixed-order redesign; no serving path launches it.
// rgcn_tpu_torch/compare_k2.py builds it and times it against K2 on the
// card; it lost to the atomics design it was measured against then
// (k2_atomics.cu).
//
// Design. One CTA per chunk (296 at nc-AIFB) of min(chunk, 512) threads,
// one slot a thread. The CTA zeroes an (RB x dout) f32 tile in shared
// memory and stages the W[rel] of each of the chunk's quanta (gap quanta
// stage nothing); after a barrier each real slot computes its dout outputs
// exactly as K2 does (row_times_w, from k2_atomics.cu), scales them by val and
// adds them to its tile row with shared-memory atomics; after a second
// barrier the CTA adds the tile's non-zero entries to the output with
// global f32 atomics (a row block spans several chunks), into an output
// the launcher zeroes first.

#include "k2_atomics.cu"

namespace {

constexpr int kTileThreads = 512;

template <int VX, int DO>
__global__ void __launch_bounds__(kTileThreads)
k2_fused_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const int* __restrict__ src, const float* __restrict__ val,
                     const int* __restrict__ local_dst,
                     const int* __restrict__ quantum_rel,
                     const int* __restrict__ chunk_block,
                     float* __restrict__ out, int din, int dout,
                     int row_block, int chunk, int quantum, int num_nodes) {
  extern __shared__ float4 tile_smem4[];
  float* tile = reinterpret_cast<float*>(tile_smem4);  // RB x dout
  float* w_s = tile + row_block * dout;  // W[rel] of each quantum, din x dout
  const int nq = chunk / quantum;
  const int w_size = din * dout;
  const long long q0 = static_cast<long long>(blockIdx.x) * nq;
  for (int i = threadIdx.x; i < row_block * dout; i += blockDim.x) tile[i] = 0.f;
  for (int i = threadIdx.x; i < nq * w_size; i += blockDim.x) {
    const int rel = quantum_rel[q0 + i / w_size];
    if (rel >= 0) w_s[i] = __ldg(w + static_cast<long long>(rel) * w_size + i % w_size);
  }
  __syncthreads();

  const long long slot0 = static_cast<long long>(blockIdx.x) * chunk;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    const int k = t / quantum;
    if (quantum_rel[q0 + k] < 0) continue;  // gap quantum
    const int ld = local_dst[slot0 + t];
    if (ld >= row_block) continue;  // pad
    const float v = val[slot0 + t];
    const float* xr = x + static_cast<long long>(src[slot0 + t]) * din;
    for (int o0 = 0; o0 < dout; o0 += DO) {
      float acc[DO];
      row_times_w<VX, DO>(xr, w_s + k * w_size, din, dout, o0, acc);
#pragma unroll
      for (int o = 0; o < DO; ++o) atomicAdd(tile + ld * dout + o0 + o, acc[o] * v);
    }
  }
  __syncthreads();

  const long long base = static_cast<long long>(chunk_block[blockIdx.x]) * row_block;
  for (int i = threadIdx.x; i < row_block * dout; i += blockDim.x) {
    const float s = tile[i];
    const long long node = base + i / dout;
    if (s != 0.f && node < num_nodes) atomicAdd(out + node * dout + i % dout, s);
  }
}

template <int VX, int DO>
cudaError_t launch_tile(const float* x, const float* w, const int* src,
                        const float* val, const int* local_dst,
                        const int* quantum_rel, const int* chunk_block,
                        float* out, int n_chunks, int din, int dout,
                        int row_block, int chunk, int quantum, int num_nodes,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(row_block) * dout + static_cast<size_t>(chunk / quantum) * din * dout);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        k2_fused_tile_kernel<VX, DO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = chunk < kTileThreads ? (chunk + 31) / 32 * 32 : kTileThreads;
  k2_fused_tile_kernel<VX, DO><<<n_chunks, threads, smem, stream>>>(
      x, w, src, val, local_dst, quantum_rel, chunk_block, out, din, dout,
      row_block, chunk, quantum, num_nodes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k2_fused_tile(const float* x, const float* w, const int* src,
                             const float* val, const int* local_dst,
                             const int* quantum_rel, const int* chunk_block,
                             float* out, int n_quanta, int din, int dout,
                             int row_block, int chunk, int quantum,
                             int num_nodes, void* stream) {
  if (n_quanta < 1 || din < 1 || dout < 1 || quantum < 1 || chunk % quantum)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * static_cast<size_t>(num_nodes) * dout, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = n_quanta / (chunk / quantum);
  const bool vx = din % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const bool do4 = dout % 4 == 0;
  if (vx && do4)
    err = launch_tile<4, 4>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,
                            n_chunks, din, dout, row_block, chunk, quantum, num_nodes, st);
  else if (vx)
    err = launch_tile<4, 1>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,
                            n_chunks, din, dout, row_block, chunk, quantum, num_nodes, st);
  else if (do4)
    err = launch_tile<1, 4>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,
                            n_chunks, din, dout, row_block, chunk, quantum, num_nodes, st);
  else
    err = launch_tile<1, 1>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,
                            n_chunks, din, dout, row_block, chunk, quantum, num_nodes, st);
  return static_cast<int>(err);
}
