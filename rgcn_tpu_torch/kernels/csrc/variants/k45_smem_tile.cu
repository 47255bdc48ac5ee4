// K4 and K5 over the rejected shared-memory-tile design
// (weighted_tile.cuh), with K4's and K5's C signatures.
// rgcn_tpu_torch/compare_k4_k5.py builds and times it; no serving path
// launches it.

#include "weighted_tile.cuh"

extern "C" int k4_smem_tile(const float* x, const int* src, const float* w,
                            const int* local_dst, const int* chunk_block,
                            float* out, int n_chunks, int chunk, int row_block,
                            int nb, int din, int table_rows, int num_nodes,
                            int per_basis_rows, int sum_bases, void* stream) {
  wtile::Args a{};
  a.x = x;
  a.src = src;
  a.w = w;
  a.local = local_dst;
  a.chunk_block = chunk_block;
  a.out = out;
  a.num_slots = static_cast<long long>(n_chunks) * chunk;
  a.table_plane = static_cast<long long>(table_rows) * din;
  a.n_chunks = n_chunks;
  a.chunk = chunk;
  a.row_block = row_block;
  a.kk = 1;
  a.din = din;
  a.num_nodes = num_nodes;
  a.sum_bases = sum_bases;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(per_basis_rows ? wtile::run<true>(a, nb, st)
                                         : wtile::run<false>(a, nb, st));
}

extern "C" int k5_smem_tile(const float* x, const int* src, const float* w_k,
                            const int* local_k, const int* chunk_block,
                            float* out, int n_chunks, int chunk, int row_block,
                            int kk, int nb, int din, int num_nodes, void* stream) {
  wtile::Args a{};
  a.x = x;
  a.src = src;
  a.w = w_k;
  a.local = local_k;
  a.chunk_block = chunk_block;
  a.out = out;
  a.num_slots = static_cast<long long>(n_chunks) * chunk;
  a.n_chunks = n_chunks;
  a.chunk = chunk;
  a.row_block = row_block;
  a.kk = kk;
  a.din = din;
  a.num_nodes = num_nodes;
  return static_cast<int>(
      wtile::run<false>(a, nb, static_cast<cudaStream_t>(stream)));
}
