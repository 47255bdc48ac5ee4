// K1's and K2's launchers with their per-CTA phase probe (sm_90a), for
// rgcn_tpu_torch/compare_k1_k2.py --probe; no serving path launches them.
// Each takes its launcher's arguments and, before the stream, ``stamps``:
// 8 int64 a CTA (K1: a unit, in unit order; K2: a chunk) that thread 0
// fills with %globaltimer at the phase boundaries and its SM
// (chunk_sum.cuh, k1_aggregate.cuh): start, staged, walked or summed, zero
// rows stored (K1), counted in, end, SM, and which split runs (K1: 1 the
// head, 2 the tail) or block (K2: 1) the CTA finished. k2_switches_f32
// takes K2's arguments and a probe's switches ``cfg`` (chunk_sum.cuh's
// kSkip* bits) before the stream: its results are wrong, its time is read.

#include "../k1_aggregate.cuh"
#include "../k2_fused.cuh"

extern "C" int k1_probe_f32(const float* msgs, const int* index, const int* local_dst,
                            const int* chunk_block, void* out, float* scratch,
                            unsigned* counters, int n_chunks, int chunk, int row_block,
                            int dout, int num_nodes, int route, int out_bf16, long long* stamps,
                            void* stream) {
  return k1::run<float>(msgs, index, local_dst, chunk_block, out, scratch, counters, n_chunks,
                        chunk, row_block, dout, num_nodes, route, out_bf16, stream, stamps);
}

extern "C" int k2_probe_f32(const float* x, const float* w, const int* src, const float* val,
                            const int* local_dst, const int* quantum_rel, const int* chunk_block,
                            float* out, float* part, unsigned* counters, int n_quanta, int din,
                            int dout, int row_block, int chunk, int quantum, int num_nodes,
                            long long* stamps, void* stream) {
  return k2::run<float>(x, w, src, val, local_dst, quantum_rel, chunk_block, out, part,
                        counters, n_quanta, din, dout, row_block, chunk, quantum, num_nodes,
                        stream, stamps);
}

extern "C" int k2_switches_f32(const float* x, const float* w, const int* src,
                               const float* val, const int* local_dst, const int* quantum_rel,
                               const int* chunk_block, float* out, float* part,
                               unsigned* counters, int n_quanta, int din, int dout,
                               int row_block, int chunk, int quantum, int num_nodes, int cfg,
                               void* stream) {
  switch (cfg) {
#define K2_SWITCH(C)                                                                      \
  case C:                                                                                 \
    return k2::run<float, C>(x, w, src, val, local_dst, quantum_rel, chunk_block, out,    \
                             part, counters, n_quanta, din, dout, row_block, chunk, quantum, \
                             num_nodes, stream);
    K2_SWITCH(0) K2_SWITCH(1) K2_SWITCH(2) K2_SWITCH(3) K2_SWITCH(4) K2_SWITCH(5)
#undef K2_SWITCH
  }
  return cudaErrorInvalidValue;
}
