// K1 computed by K4's design (sm_90a): weighted_runs.cuh over K1's
// DstLayout as the frame with one basis, no weight read (each lane's
// weight 1) and the source row = the layout's perm entry, or the slot
// itself for messages in slot order. It is the other design K1's redesign
// could have taken beside its own owned-row route (k1_aggregate.cuh); no
// serving path launches it. rgcn_tpu_torch/compare_k1_k5.py builds it and
// times it beside K1's launcher and forced routes. Arguments as K1's
// launchers' (dst_sorted must be 1); f32 messages take an f32 output only.

#include "../weighted_runs.cuh"

// (a named namespace: a __global__ template's arguments may not be types of
// an unnamed one)
namespace k1_variant {

// K1's frame in weighted_runs.cuh's terms: the source row is the index
// entry, or the slot itself without an index; every weight is 1 (no read)
struct UnitFrame : wruns::Frame {
  __device__ __forceinline__ static int src(const wruns::Args& a, long long slot) {
    return a.src != nullptr ? a.src[slot] : static_cast<int>(slot);
  }
  template <typename TX>
  __device__ __forceinline__ static float weight(const float*, long long) {
    return 1.f;
  }
};

}  // namespace k1_variant

namespace {

template <typename TX>
int k1_runs(const TX* msgs, const int* index, const int* local_dst, const int* chunk_block,
            void* out, float* scratch, int n_chunks, int chunk, int row_block, int dout,
            int num_nodes, int dst_sorted, int out_bf16, void* stream) {
  if (!dst_sorted || (out_bf16 && (sizeof(TX) == 4 || scratch == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  wruns::Args a{};
  a.x = msgs;
  a.src = index;  // nullptr: the slot (UnitFrame)
  a.w = nullptr;  // not read (UnitFrame)
  a.local = local_dst;
  a.chunk_block = chunk_block;
  a.out = out;
  a.acc = out_bf16 ? scratch : static_cast<float*>(out);
  a.num_slots = static_cast<long long>(n_chunks) * chunk;
  a.n_chunks = n_chunks;
  a.chunk = chunk;
  a.row_block = row_block;
  a.kk = 1;
  a.din = dout;
  a.num_nodes = num_nodes;
  a.dst_sorted = 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(TX) == 4) {
    return static_cast<int>(wruns::run<float, float, false, k1_variant::UnitFrame>(a, 1, st));
  } else {
    return static_cast<int>(out_bf16 ? wruns::run<TX, TX, false, k1_variant::UnitFrame>(a, 1, st)
                                     : wruns::run<TX, float, false, k1_variant::UnitFrame>(a, 1, st));
  }
}

}  // namespace

extern "C" int k1_wruns_f32(const float* msgs, const int* index, const int* local_dst,
                            const int* chunk_block, void* out, float* scratch, int n_chunks,
                            int chunk, int row_block, int dout, int num_nodes, int dst_sorted,
                            int out_bf16, void* stream) {
  return k1_runs(msgs, index, local_dst, chunk_block, out, scratch, n_chunks, chunk, row_block,
                 dout, num_nodes, dst_sorted, out_bf16, stream);
}

extern "C" int k1_wruns_bf16(const __nv_bfloat16* msgs, const int* index, const int* local_dst,
                             const int* chunk_block, void* out, float* scratch, int n_chunks,
                             int chunk, int row_block, int dout, int num_nodes, int dst_sorted,
                             int out_bf16, void* stream) {
  return k1_runs(msgs, index, local_dst, chunk_block, out, scratch, n_chunks, chunk, row_block,
                 dout, num_nodes, dst_sorted, out_bf16, stream);
}
