// K4's bf16 form by the designs its launcher was chosen over (sm_90a); no
// serving path launches them. rgcn_tpu_torch/compare_k4_bf16.py builds
// this file and times it beside the launcher (k4_weighted_aggregate_bf16.cu:
// the owned-row kernel of k4_owned.cuh with k4o::Launcher's choices) and
// the form it replaced (variants/k4_weighted_runs.cu). Both take the
// launcher's arguments, one more before the stream:
//  * k4_bf16_variant: the owned-row kernel with other choices (k4o::Cfg),
//    ``variant`` picking one (listed at the function); 1, 2 or 4 bases
//    only (the model paths' shapes), else cudaErrorInvalidValue.
//  * k4_bf16_probe: the launcher's kernel recording its CTAs' phase times.
// k4_bf16_blocks_per_sm reports the launcher's kernel's occupancy.

#include "../k4_owned.cuh"

namespace k4o_variant {

// (FLIGHT, RING, STREAM, L1, ZERO, THREADS): the launcher's choices (8,
// true, true, true, 2, 256) with one changed
using PlainStores = k4o::Cfg<8, true, false, true, 2>;
using Deep = k4o::Cfg<16, true, true, true, 2>;
using Shallow = k4o::Cfg<4, true, true, true, 2>;
using RegisterRing = k4o::Cfg<8, false, true, true, 2>;
using L2Copies = k4o::Cfg<8, true, true, false, 2>;
using ZeroEarly = k4o::Cfg<8, true, true, true, 0>;
using ZeroLate = k4o::Cfg<8, true, true, true, 1>;
using Cta128 = k4o::Cfg<8, true, true, true, 2, 128>;
using Cta64 = k4o::Cfg<8, true, true, true, 2, 64>;

template <typename TO, bool PB, typename C>
cudaError_t wide(k4o::Args a, int nb, int span, cudaStream_t st) {
  if (!k4o::prepare<__nv_bfloat16, C>(a, nb, span)) return cudaErrorInvalidValue;
  switch (nb) {
    case 1:
      return k4o::launch<__nv_bfloat16, TO, 1, PB, C>(a, st);
    case 2:
      return k4o::launch<__nv_bfloat16, TO, 2, PB, C>(a, st);
    case 4:
      return k4o::launch<__nv_bfloat16, TO, 4, PB, C>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename C>
cudaError_t forms(const k4o::Args& a, int nb, int span, int per_basis, int out_bf16,
                  cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (out_bf16)
    return per_basis ? wide<bf16, true, C>(a, nb, span, st) : wide<bf16, false, C>(a, nb, span, st);
  return per_basis ? wide<float, true, C>(a, nb, span, st) : wide<float, false, C>(a, nb, span, st);
}

}  // namespace k4o_variant

// variant: 0 plain (not evict-first) output stores, 1 16 vectors in flight
// a thread, 2 4 in flight, 3 the register ring, 4 copies through L2 only
// (.cg), 5 the zero rows stored before the walk, 6 after it, 7 CTAs of 128
// threads, 8 of 64 (``span`` at most the CTA's threads: the caller's scratch
// and counters are for it)
extern "C" int k4_bf16_variant(const __nv_bfloat16* x, const int* src, const float* w,
                               const int* local_dst, const int* chunk_block, void* out,
                               float* scratch, unsigned* counters, int n_chunks, int chunk,
                               int row_block, int nb, int din, int table_rows, int num_nodes,
                               int per_basis_rows, int sum_bases, int out_bf16,
                               int span, int variant, void* stream) {
  namespace v = k4o_variant;
  const k4o::Args a = k4o::make_args(x, src, w, local_dst, chunk_block, out, scratch, counters,
                                     n_chunks, chunk, row_block, din, table_rows, num_nodes,
                                     sum_bases);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (variant) {
    case 0: err = v::forms<v::PlainStores>(a, nb, span, per_basis_rows, out_bf16, st); break;
    case 1: err = v::forms<v::Deep>(a, nb, span, per_basis_rows, out_bf16, st); break;
    case 2: err = v::forms<v::Shallow>(a, nb, span, per_basis_rows, out_bf16, st); break;
    case 3: err = v::forms<v::RegisterRing>(a, nb, span, per_basis_rows, out_bf16, st); break;
    case 4: err = v::forms<v::L2Copies>(a, nb, span, per_basis_rows, out_bf16, st); break;
    case 5: err = v::forms<v::ZeroEarly>(a, nb, span, per_basis_rows, out_bf16, st); break;
    case 6: err = v::forms<v::ZeroLate>(a, nb, span, per_basis_rows, out_bf16, st); break;
    case 7: err = v::forms<v::Cta128>(a, nb, span, per_basis_rows, out_bf16, st); break;
    case 8: err = v::forms<v::Cta64>(a, nb, span, per_basis_rows, out_bf16, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

// A probe of the launcher's kernel (k4o::Launcher's choices): the same call
// with %globaltimer and the SM recorded by each CTA's thread 0 at its
// phase boundaries into ``stamps`` (8 int64 a unit: start, staged, walked,
// zero rows stored, split runs counted in, end, -, SM); 16-byte columns and
// 1, 2 or 4 bases.
extern "C" int k4_bf16_probe(const __nv_bfloat16* x, const int* src, const float* w,
                             const int* local_dst, const int* chunk_block, void* out,
                             float* scratch, unsigned* counters, int n_chunks, int chunk,
                             int row_block, int nb, int din, int table_rows, int num_nodes,
                             int per_basis_rows, int sum_bases, int out_bf16,
                             int span, long long* stamps, void* stream) {
  using Probe = k4o::Cfg<8, true, true, true, 2, 256, true>;
  k4o::Args a = k4o::make_args(x, src, w, local_dst, chunk_block, out, scratch, counters,
                               n_chunks, chunk, row_block, din, table_rows, num_nodes,
                               sum_bases);
  a.stamps = stamps;
  return static_cast<int>(k4o_variant::forms<Probe>(a, nb, span, per_basis_rows, out_bf16,
                                                    static_cast<cudaStream_t>(stream)));
}

// CTAs an SM holds of the launcher's kernel for 16-byte columns at nb (1, 2
// or 4) bases (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 else.
extern "C" int k4_bf16_blocks_per_sm(int nb, int per_basis_rows, int out_bf16, int span,
                                     int row_block) {
  k4o::Args a{};
  a.span = span;
  a.row_block = row_block;
  using L = k4o::Launcher;
  using bf16 = __nv_bfloat16;
#define K4O_OCC(N)                                                                 \
  if (nb == N)                                                                     \
    return out_bf16 ? (per_basis_rows ? k4o::blocks_per_sm<bf16, bf16, N, true, L>(a)     \
                                      : k4o::blocks_per_sm<bf16, bf16, N, false, L>(a))   \
                    : (per_basis_rows ? k4o::blocks_per_sm<bf16, float, N, true, L>(a)    \
                                      : k4o::blocks_per_sm<bf16, float, N, false, L>(a));
  K4O_OCC(1)
  K4O_OCC(2)
  K4O_OCC(4)
#undef K4O_OCC
  return -1;
}
