// K4 on bf16 tables: weighted destination aggregation with the source-row
// gather inside, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_basis.py::weighted_aggregate_pallas with a
// bf16 compute dtype (the edge stage of the basis layers on the card,
// rgcn_tpu/nn/layers.py:45-55, and the structured decoder's bwd_dtype
// backward, rgcn_tpu/ops/pallas_distmult.py:395-413): the table rows are
// bf16, each slot weight is rounded to bf16 (w.astype(xg.dtype)), the
// products are exact in f32 and the sums are f32, as the MXU's
// preferred_element_type=f32 gives them. The output is f32, or bf16
// (out_bf16) narrowed once per element from its whole f32 sum, as the Pallas
// kernel narrows its f32 VMEM scratch on a row block's closing chunk.
//
// Bound on the H100: bytes. The card must read each real slot's source
// index and nb weights, the layout, each distinct source row once (bf16;
// per-basis tables nb rows), and write the output once: at lp-WN18 (din
// 200, nb 2, bf16 out) ~42 MB, of which the output is 32.8 MB.
//
// Design: the owned-row kernel of k4_owned_bf16.cuh, which reads the
// destination-sorted frame as it is (no counting sort), keeps each
// thread's next rows in flight in a ring of cp.async copies in shared
// memory, spreads a row's 16-byte vectors over groups of exactly as many
// threads, stores each row its unit holds whole once, and finishes the runs
// that cross a unit boundary in the same launch: each unit's part in an f32
// scratch of two rows a unit of ``span`` slots (``scratch``), the last unit
// of a run to count in on its counter (``counters``: one a unit, zero on
// entry, left zero) adds the parts.
// ``route`` 1 takes it; ``route`` 0 takes the shared design of
// weighted_runs.cuh (a CTA a chunk sorting its lanes, the rows two chunks
// share zeroed before and finished with f32 atomics, into ``scratch`` of
// the output's shape for a bf16 output, narrowed after), which the wrapper
// picks where the owned-row kernel does not go (din % 8 != 0, a table that
// is not 16-byte aligned) or did not measure faster on an H100 (more than
// 1,024 chunks, and a bf16 output of several bases over more than 384:
// kernels.k4_bf16_route). K4's f32 form and K5 keep weighted_runs.cuh
// alone.

#include "k4_owned_bf16.cuh"
#include "weighted_runs.cuh"

extern "C" int k4_weighted_aggregate_bf16(const __nv_bfloat16* x, const int* src,
                                          const float* w, const int* local_dst,
                                          const int* chunk_block, void* out,
                                          float* scratch, unsigned* counters,
                                          int n_chunks, int chunk, int row_block, int nb,
                                          int din, int table_rows, int num_nodes,
                                          int per_basis_rows, int sum_bases, int out_bf16,
                                          int route, int span, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (route == 0) {
    wruns::Args a{};
    a.x = x;
    a.src = src;
    a.w = w;
    a.local = local_dst;
    a.chunk_block = chunk_block;
    a.out = out;
    a.acc = out_bf16 ? scratch : static_cast<float*>(out);
    a.num_slots = static_cast<long long>(n_chunks) * chunk;
    a.table_plane = static_cast<long long>(table_rows) * din;
    a.n_chunks = n_chunks;
    a.chunk = chunk;
    a.row_block = row_block;
    a.kk = 1;
    a.din = din;
    a.num_nodes = num_nodes;
    a.sum_bases = sum_bases;
    a.dst_sorted = 1;  // every DstLayout builder sorts a block's slots by destination
    if (out_bf16)
      err = per_basis_rows ? wruns::run<bf16, bf16, true>(a, nb, st)
                           : wruns::run<bf16, bf16, false>(a, nb, st);
    else
      err = per_basis_rows ? wruns::run<bf16, float, true>(a, nb, st)
                           : wruns::run<bf16, float, false>(a, nb, st);
    return static_cast<int>(err);
  }
  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  const k4b::Args a = k4b::make_args(x, src, w, local_dst, chunk_block, out, scratch, counters,
                                     n_chunks, chunk, row_block, din, table_rows, num_nodes,
                                     sum_bases);
  if (out_bf16)
    err = per_basis_rows ? k4b::run<bf16, true>(a, nb, span, st)
                         : k4b::run<bf16, false>(a, nb, span, st);
  else
    err = per_basis_rows ? k4b::run<float, true>(a, nb, span, st)
                         : k4b::run<float, false>(a, nb, span, st);
  return static_cast<int>(err);
}
