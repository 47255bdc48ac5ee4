// Native destination-layout builder: the port's copy of the JAX package's
// native/layout_builder.cc.
//
// Link-prediction training builds several DstLayouts per epoch on the host
// (the subgraph's forward and reverse layouts, and the structured
// scorer's three: rgcn_tpu_torch/ops/aggregate.py::build_dst_layout,
// graph/dynamic.py, ops/distmult_train.py::build_structured_layouts). The
// NumPy builder is dominated by an O(E log E) argsort; destinations are
// bounded by num_nodes, so a stable counting sort does the same work in
// O(E + N).
//
// Contract (bit-identical to the NumPy build_dst_layout,
// tests/test_torch_native.py):
//   * edges stably ordered by destination; pads (dst >= num_nodes) dropped
//   * per row block of `row_block` destination rows, edges padded to a
//     multiple of `chunk`; every block gets >= 1 chunk
//   * perm[slot] = original edge index (pad slots -> e, one past the end)
//   * local[slot] = dst - block * row_block (pad slots -> row_block)
//   * chunk_block[c] = row block of chunk c (clamped to the last block)
//   * optional pad_to appends all-pad chunks repeating the last row block

#include <cstdint>
#include <vector>

extern "C" {

// Returns total slot count, or -1 if capacity is insufficient, -2 if
// pad_to is invalid (positive but < total or not a multiple of chunk).
// perm_out/local_out need `total` slots; chunk_block_out `total / chunk`.
int64_t rgcn_build_dst_layout(const int32_t* dst, int64_t e,
                              int64_t num_nodes, int64_t row_block,
                              int64_t chunk, int64_t pad_to,
                              int32_t* perm_out, int32_t* local_out,
                              int32_t* chunk_block_out, int64_t capacity) {
  const int64_t nrb = (num_nodes + row_block - 1) / row_block;

  // Stable counting sort by destination value (== np.argsort(dst,
  // kind="stable") restricted to real edges).
  std::vector<int64_t> value_count(num_nodes + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    const int32_t d = dst[i];
    if (d >= 0 && d < num_nodes) ++value_count[d];
  }
  std::vector<int64_t> value_off(num_nodes + 1, 0);
  for (int64_t v = 1; v <= num_nodes; ++v)
    value_off[v] = value_off[v - 1] + value_count[v - 1];

  // Per-row-block real counts, chunk-padded extents, and slot offsets.
  std::vector<int64_t> counts(nrb, 0), padded(nrb), offsets(nrb), starts(nrb);
  for (int64_t b = 0; b < nrb; ++b) {
    const int64_t lo = b * row_block;
    const int64_t hi = std::min<int64_t>(lo + row_block, num_nodes);
    counts[b] = value_off[hi] - value_off[lo];
  }
  int64_t total = 0, start = 0;
  for (int64_t b = 0; b < nrb; ++b) {
    int64_t p = ((counts[b] + chunk - 1) / chunk) * chunk;
    if (p == 0) p = chunk;  // every block gets >= 1 chunk
    padded[b] = p;
    offsets[b] = total;
    starts[b] = start;
    total += p;
    start += counts[b];
  }
  if (total < chunk) total = chunk;
  if (pad_to > 0) {
    if (pad_to < total || pad_to % chunk) return -2;
    total = pad_to;
  }
  if (total > capacity) return -1;

  for (int64_t s = 0; s < total; ++s) {
    perm_out[s] = static_cast<int32_t>(e);
    local_out[s] = static_cast<int32_t>(row_block);
  }

  // Scatter: edge at stable-sorted rank i of block b lands at slot
  // offsets[b] + (i - starts[b]). The rank is value_off[dst] advanced per
  // occurrence (original order within equal dst == stability).
  std::vector<int64_t> cursor(value_off);
  for (int64_t i = 0; i < e; ++i) {
    const int32_t d = dst[i];
    if (d < 0 || d >= num_nodes) continue;
    const int64_t rank = cursor[d]++;
    const int64_t b = d / row_block;
    const int64_t slot = offsets[b] + (rank - starts[b]);
    perm_out[slot] = static_cast<int32_t>(i);
    local_out[slot] = static_cast<int32_t>(d - b * row_block);
  }

  // chunk -> row block map; appended pad chunks repeat the last block.
  const int64_t n_chunks = total / chunk;
  int64_t b = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t cs = c * chunk;
    while (b < nrb - 1 && offsets[b] + padded[b] <= cs) ++b;
    chunk_block_out[c] = static_cast<int32_t>(b);
  }
  return total;
}

// Stable (relation, receiver) ordering: order_out = np.lexsort((dst, rel))
// — primary key rel, secondary dst, ties in original order. Two-pass LSD
// counting sort, O(E + bins) instead of the NumPy lexsort's O(E log E)
// Values must lie in [0, num_*_bins); returns -1 otherwise.
int64_t rgcn_lexsort_rel_dst(const int32_t* rel, const int32_t* dst,
                             int64_t e, int64_t num_rel_bins,
                             int64_t num_dst_bins, int32_t* order_out) {
  for (int64_t i = 0; i < e; ++i) {
    if (rel[i] < 0 || rel[i] >= num_rel_bins || dst[i] < 0 ||
        dst[i] >= num_dst_bins)
      return -1;
  }
  // pass 1: stable counting sort by the secondary key (dst)
  std::vector<int64_t> off1(num_dst_bins + 1, 0);
  for (int64_t i = 0; i < e; ++i) ++off1[dst[i] + 1];
  for (int64_t v = 1; v <= num_dst_bins; ++v) off1[v] += off1[v - 1];
  std::vector<int32_t> tmp(e);
  for (int64_t i = 0; i < e; ++i)
    tmp[off1[dst[i]]++] = static_cast<int32_t>(i);
  // pass 2: stable counting sort by the primary key (rel)
  std::vector<int64_t> off2(num_rel_bins + 1, 0);
  for (int64_t i = 0; i < e; ++i) ++off2[rel[i] + 1];
  for (int64_t v = 1; v <= num_rel_bins; ++v) off2[v] += off2[v - 1];
  for (int64_t i = 0; i < e; ++i)
    order_out[off2[rel[tmp[i]]]++] = tmp[i];
  return 0;
}

}  // extern "C"
