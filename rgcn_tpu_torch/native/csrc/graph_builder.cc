// Native graph preprocessing for rgcn_tpu_torch: the port's copy of the
// JAX package's native/graph_builder.cc.
//
// Builds the relation-sorted, tile-padded edge layout of a static graph
// (rgcn_tpu_torch/graph/structure.py::build_edge_set) with the inverse
// edges generated here, bucketing by relation and sorting each bucket by
// receiver in parallel across relations (OpenMP). On AM-scale RDF graphs
// the NumPy lexsort/bincount pipeline is the dominant preprocessing cost.
//
// Contract (bit-identical to the NumPy path; tests/test_torch_native.py):
//   * edges = originals ++ inverses (inverse relation = p + R)
//   * sorted stably by (relation, receiver); receiver = subject,
//     source = object
//   * val[e] = 1 / #(edges with same (relation, receiver))
//   * each relation segment padded to a multiple of tile_size; pad slots:
//     src = 0, dst = num_nodes, val = 0
//   * tile_rel[t] = relation of tile t

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Returns the padded edge count (== tiles * tile_size), or -1 if the caller
// buffer capacity is insufficient. Outputs are written only on success.
int64_t rgcn_build_edge_set(const int64_t* triples,  // (e, 3) [s, p, o]
                            int64_t num_triples, int64_t num_nodes,
                            int64_t num_rels, int64_t tile_size,
                            int32_t* src_out, int32_t* dst_out,
                            int32_t* rel_out, float* val_out,
                            int32_t* tile_rel_out, int64_t capacity) {
  const int64_t e = 2 * num_triples;          // originals + inverses
  const int64_t num_general = 2 * num_rels;   // doubled relation vocabulary

  std::vector<int32_t> dst(e), rel(e), src(e);
  for (int64_t i = 0; i < num_triples; ++i) {
    const int64_t s = triples[3 * i + 0];
    const int64_t p = triples[3 * i + 1];
    const int64_t o = triples[3 * i + 2];
    dst[i] = static_cast<int32_t>(s);          // receiver = subject
    rel[i] = static_cast<int32_t>(p);
    src[i] = static_cast<int32_t>(o);          // source = object
    dst[num_triples + i] = static_cast<int32_t>(o);  // inverse edge
    rel[num_triples + i] = static_cast<int32_t>(p + num_rels);
    src[num_triples + i] = static_cast<int32_t>(s);
  }

  // Bucket edges by relation (counting sort pass; stable).
  std::vector<int64_t> counts(num_general, 0);
  for (int64_t i = 0; i < e; ++i) counts[rel[i]]++;
  std::vector<int64_t> starts(num_general + 1, 0);
  for (int64_t r = 0; r < num_general; ++r) starts[r + 1] = starts[r] + counts[r];

  std::vector<int64_t> order(e);
  {
    std::vector<int64_t> cursor(starts.begin(), starts.end() - 1);
    for (int64_t i = 0; i < e; ++i) order[cursor[rel[i]]++] = i;
  }

  // Within each relation bucket, stable-sort by receiver (parallel across
  // relations — knowledge graphs have enough of them to load-balance, and a
  // skewed giant relation still sorts in one task at O(k log k)).
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t r = 0; r < num_general; ++r) {
    std::stable_sort(order.begin() + starts[r], order.begin() + starts[r + 1],
                     [&](int64_t a, int64_t b) { return dst[a] < dst[b]; });
  }

  // Padded layout.
  std::vector<int64_t> padded(num_general), offsets(num_general + 1, 0);
  for (int64_t r = 0; r < num_general; ++r) {
    padded[r] = (counts[r] + tile_size - 1) / tile_size * tile_size;
    offsets[r + 1] = offsets[r] + padded[r];
  }
  int64_t e_pad = offsets[num_general];
  if (e_pad == 0) e_pad = tile_size;
  if (e_pad > capacity) return -1;

  // Fill pads first.
  for (int64_t i = 0; i < e_pad; ++i) {
    src_out[i] = 0;
    dst_out[i] = static_cast<int32_t>(num_nodes);
    val_out[i] = 0.0f;
  }

  // Scatter real edges + degree normalization (run lengths over the sorted
  // (rel, dst) runs).
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t r = 0; r < num_general; ++r) {
    const int64_t lo = starts[r], hi = starts[r + 1];
    int64_t run_start = lo;
    while (run_start < hi) {
      int64_t run_end = run_start;
      const int32_t d = dst[order[run_start]];
      while (run_end < hi && dst[order[run_end]] == d) run_end++;
      const float val = 1.0f / static_cast<float>(run_end - run_start);
      for (int64_t i = run_start; i < run_end; ++i) {
        const int64_t pos = offsets[r] + (i - lo);
        const int64_t edge = order[i];
        src_out[pos] = src[edge];
        dst_out[pos] = dst[edge];
        val_out[pos] = val;
      }
      run_start = run_end;
    }
  }

  // Tile relations (pads inherit their tile's relation).
  const int64_t n_tiles = e_pad / tile_size;
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t start = t * tile_size;
    int64_t r = 0;
    while (r < num_general - 1 && offsets[r + 1] <= start) r++;
    tile_rel_out[t] = static_cast<int32_t>(r);
  }
  for (int64_t t = 0; t < n_tiles; ++t)
    for (int64_t i = 0; i < tile_size; ++i)
      rel_out[t * tile_size + i] = tile_rel_out[t];

  return e_pad;
}

int rgcn_native_version() { return 1; }

}  // extern "C"
