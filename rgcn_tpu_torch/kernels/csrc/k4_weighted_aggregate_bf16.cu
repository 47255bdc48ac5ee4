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
// Design: the owned-row kernel of k4_owned.cuh with bf16 rows (16-byte
// vectors of 8 values, or 8-, 4- and 2-byte pieces where din % 8 != 0,
// nc-AM's width 10, or the table is not 16-byte aligned), which reads the
// destination-sorted frame as it is (no counting sort), keeps each
// thread's next rows in flight in a ring of cp.async copies in shared
// memory, spreads a row's vectors over groups of exactly as many threads,
// stores each row its unit holds whole once, and finishes the runs that
// cross a unit boundary in the same launch: each unit's part in an f32
// scratch of two rows a unit of ``span`` slots (``scratch``), the last unit
// of a run to count in on its counter (``counters``: one a unit, zero on
// entry, left zero) adds the parts in unit order. Every layout takes it:
// one launch, no memset, the same bits on every launch. The design it
// replaced (weighted_runs.cuh, which K5 keeps) is kept for the comparison
// scripts in variants/k4_weighted_runs.cu.

#include "k4_owned.cuh"

extern "C" int k4_weighted_aggregate_bf16(const __nv_bfloat16* x, const int* src,
                                          const float* w, const int* local_dst,
                                          const int* chunk_block, void* out,
                                          float* scratch, unsigned* counters,
                                          int n_chunks, int chunk, int row_block, int nb,
                                          int din, int table_rows, int num_nodes,
                                          int per_basis_rows, int sum_bases, int out_bf16,
                                          int span, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const k4o::Args a = k4o::make_args(x, src, w, local_dst, chunk_block, out, scratch, counters,
                                     n_chunks, chunk, row_block, din, table_rows, num_nodes,
                                     sum_bases);
  cudaError_t err;
  if (out_bf16)
    err = per_basis_rows ? k4o::run<bf16, bf16, true>(a, nb, span, st)
                         : k4o::run<bf16, bf16, false>(a, nb, span, st);
  else
    err = per_basis_rows ? k4o::run<bf16, float, true>(a, nb, span, st)
                         : k4o::run<bf16, float, false>(a, nb, span, st);
  return static_cast<int>(err);
}
