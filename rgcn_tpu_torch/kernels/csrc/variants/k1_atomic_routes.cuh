// K1's two designs in no fixed order, kept for the comparison scripts
// (compare_k1_k2.py, compare_k1_k5.py; sm_90a): no model path launches
// them since the launchers take k1_aggregate.cuh's fixed-order routes for
// every layout.
//  * kOwned (k1_owned_kernel): the ownership of k1_fixed_kernel without its
//    split-run bookkeeping (a lighter CTA, 5 an SM at 8 lanes a row), the
//    rows two CTAs share zeroed before (zero_split_rows) and finished with
//    f32 atomics, into an f32 scratch for a bf16 output (narrow_split_rows
//    after). A row two CTAs share sums the same either way round; one over
//    three or more does not. The launchers took it for e-RGCN nc-AM's
//    diagonal messages before kFixed took every layout.
//  * kAtomics: every run added with an f32 atomic into a memset output (a
//    bf16 output summed in an f32 scratch and narrowed by a second kernel),
//    in no fixed order. The launchers took it for nc-AM's pair path at width
//    10 before kFixed took every layout.
// Lanes as the launchers' were then: 4 values where dout % 4 == 0
// and the table is aligned to them, else scalar lanes.

#pragma once

#include "../k1_aggregate.cuh"

namespace k1 {

enum VariantRoute { kAtomics = 2, kOwned = 3 };

// -------------------------------------------------------------- kAtomics

// The atomics design: every run added with an f32 atomic into a zeroed
// output (an f32 scratch for a bf16 output, narrowed after by
// narrow_output): a memset, the sum and, for a bf16 output, the
// narrowing, and its sums in no fixed order. add_vec also finishes
// kOwned's split rows.
template <int VEC>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    atomicAdd(p, v[0]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      atomicAdd(reinterpret_cast<float4*>(p + e),
                make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]));
  }
}

template <typename TM, int VEC, int LPS>
__global__ void __launch_bounds__(32 * kMaxWarps)
k1_aggregate_kernel(const TM* __restrict__ msgs,
                    const int* __restrict__ index,
                    const int* __restrict__ local_dst,
                    const int* __restrict__ chunk_block,
                    float* __restrict__ out,
                    int chunk, int row_block, int dout, int num_nodes) {
  constexpr int K = group_slots<LPS>();
  constexpr int M = K / LPS;  // slots whose local_dst and index a lane loads
  const int lane = threadIdx.x & 31;
  const int q = lane % LPS;   // lane within its group
  const int g0 = lane - q;    // first lane of the group
  const int c = blockIdx.x;
  const int first = (blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5)) * warp_span<LPS>();
  if (first >= chunk) return;  // a warp past the chunk: warp-uniform
  const int last = min(first + warp_span<LPS>(), chunk);
  const long long chunk0 = static_cast<long long>(c) * chunk;

  // the group's slot j lives in lane g0 + j % LPS, register j / LPS
  const int gfirst = first + (lane / LPS) * K;
  int ld[M];
  bool live = false;
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int s = gfirst + q + LPS * t;
    ld[t] = s < last ? local_dst[chunk0 + s] : row_block;
    live |= ld[t] < row_block;
  }
  if (!__any_sync(kFull, live)) return;  // a span of pads only: warp-uniform
  long long row[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const long long s = chunk0 + gfirst + q + LPS * t;
    row[t] = 0;
    if (ld[t] < row_block) row[t] = index ? static_cast<long long>(index[s]) : s;
  }
  const long long block_base = static_cast<long long>(chunk_block[c]) * row_block;

  const int n_groups = (dout + LPS * VEC - 1) / (LPS * VEC);
  for (int cg = 0; cg < n_groups; ++cg) {
    const int col = (cg * LPS + q) * VEC;
    const bool col_ok = col < dout;
    float acc[VEC] = {};
    int cur = -1;
#pragma unroll
    for (int jb = 0; jb < K; jb += kBatch) {
      int l[kBatch];
      float v[kBatch][VEC];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int jj = jb + j;
        l[j] = __shfl_sync(kFull, ld[jj / LPS], g0 + jj % LPS);
        const long long r = __shfl_sync(kFull, row[jj / LPS], g0 + jj % LPS);
        if (l[j] < row_block && col_ok) {
          load_vec<TM, VEC>(msgs + r * dout + col, v[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (l[j] >= row_block) continue;  // pad: group-uniform
        if (l[j] != cur) {
          if (cur >= 0 && col_ok && block_base + cur < num_nodes)
            add_vec<VEC>(out + (block_base + cur) * dout + col, acc);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
          cur = l[j];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += v[j][e];
      }
    }
    if (cur >= 0 && col_ok && block_base + cur < num_nodes)
      add_vec<VEC>(out + (block_base + cur) * dout + col, acc);
  }
}

template <typename TM, int VEC, int LPS>
cudaError_t launch(const TM* msgs, const int* index, const int* local_dst,
                   const int* chunk_block, float* out, int n_chunks, int chunk,
                   int row_block, int dout, int num_nodes, cudaStream_t stream) {
  const int warps = (chunk + warp_span<LPS>() - 1) / warp_span<LPS>();
  const int per_cta = warps < kMaxWarps ? warps : kMaxWarps;
  const dim3 grid(n_chunks, (warps + per_cta - 1) / per_cta);
  k1_aggregate_kernel<TM, VEC, LPS><<<grid, 32 * per_cta, 0, stream>>>(
      msgs, index, local_dst, chunk_block, out, chunk, row_block, dout,
      num_nodes);
  return cudaGetLastError();
}

template <typename TM, int VEC>
cudaError_t launch_vec(int lps, const TM* msgs, const int* index,
                       const int* local_dst, const int* chunk_block,
                       float* out, int n_chunks, int chunk, int row_block,
                       int dout, int num_nodes, cudaStream_t stream) {
  switch (lps) {
#define K1_CASE(L)                                                              \
  case L:                                                                       \
    return launch<TM, VEC, L>(msgs, index, local_dst, chunk_block, out,         \
                              n_chunks, chunk, row_block, dout, num_nodes,      \
                              stream);
    K1_CASE(1) K1_CASE(2) K1_CASE(4) K1_CASE(8) K1_CASE(16) K1_CASE(32)
#undef K1_CASE
  }
  return cudaErrorInvalidValue;
}

// After the sum, for a bf16 output: each element rounded once from its f32
// sum in the scratch.
__global__ void narrow_output(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                              long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += stride)
    out[i] = __float2bfloat16_rn(acc[i]);
}

// ---------------------------------------------------------------- kOwned

// Shared memory of an owned-row CTA: its span's local_dst, one bit a row of
// the block (a slot of the span reaches it), and each lane's partial row of
// VEC floats.
inline size_t owned_smem(int span, int row_block, int warps, int vec) {
  return sizeof(int) * (static_cast<size_t>(span) + (row_block + 31) / 32) +
         sizeof(float) * static_cast<size_t>(warps) * 32 * vec;
}

// The row an owned-row CTA (unit u: chunk u / parts, part u % parts, slots
// [part * span, + span) of the chunk) shares with the CTA before it: its
// first slot's destination where the slot before it, in the same row
// block, has it too; -1 where there is none or it lies past num_nodes.
__device__ __forceinline__ long long split_row(const int* __restrict__ local_dst,
                                               const int* __restrict__ chunk_block, int u,
                                               int parts, int chunk, int span, int row_block,
                                               int num_nodes) {
  const int c = u / parts, s0 = (u - c * parts) * span;
  if (s0 == 0 && (c == 0 || chunk_block[c - 1] != chunk_block[c])) return -1;
  const long long slot0 = static_cast<long long>(c) * chunk + s0;
  const int f = local_dst[slot0];
  if (f >= row_block || local_dst[slot0 - 1] != f) return -1;
  const long long r = static_cast<long long>(chunk_block[c]) * row_block + f;
  return r < num_nodes ? r : -1;
}

// Before the owned-row kernel: zero the f32 rows two CTAs share (a warp a
// unit; a row split over several units is zeroed by each).
__global__ void zero_split_rows(const int* __restrict__ local_dst,
                                const int* __restrict__ chunk_block, float* __restrict__ acc,
                                int units, int parts, int chunk, int span, int row_block,
                                int dout, int num_nodes) {
  const int lane = threadIdx.x & 31;
  const int u = static_cast<int>((blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5);
  if (u >= units) return;  // warp-uniform
  long long r = lane == 0 ? split_row(local_dst, chunk_block, u, parts, chunk, span,
                                      row_block, num_nodes)
                          : 0;
  r = __shfl_sync(kFull, r, 0);
  if (r < 0) return;
  for (int i = lane; i < dout; i += 32) acc[r * dout + i] = 0.f;
}

// After it, for a bf16 output: narrow those rows from the f32 scratch.
__global__ void narrow_split_rows(const int* __restrict__ local_dst,
                                  const int* __restrict__ chunk_block,
                                  const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                                  int units, int parts, int chunk, int span, int row_block,
                                  int dout, int num_nodes) {
  const int lane = threadIdx.x & 31;
  const int u = static_cast<int>((blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5);
  if (u >= units) return;
  long long r = lane == 0 ? split_row(local_dst, chunk_block, u, parts, chunk, span,
                                      row_block, num_nodes)
                          : 0;
  r = __shfl_sync(kFull, r, 0);
  if (r < 0) return;
  for (int i = lane; i < dout; i += 32) out[r * dout + i] = __float2bfloat16_rn(acc[r * dout + i]);
}

// CTAs an SM the owned-row kernel is compiled for: at 4-wide lanes 8 to a
// row (dout 20-32; e-RGCN nc-AM's diagonal width is 32) 5, which holds it
// to 48 registers (a few bytes of spill) and measured faster on an H100
// than the 4 its 62 registers allow (6, at 40 registers, spilled and ran
// slower); elsewhere what its registers allow.
template <int VEC, int LPS>
__host__ __device__ constexpr int owned_min_ctas() {
  return VEC == 4 && LPS == 8 ? 5 : 1;
}

template <typename TM, typename TO, int VEC, int LPS>
__global__ void __launch_bounds__(32 * kMaxWarps, (owned_min_ctas<VEC, LPS>()))
k1_owned_kernel(const TM* __restrict__ msgs, const int* __restrict__ index,
                const int* __restrict__ local_dst, const int* __restrict__ chunk_block,
                TO* out, float* acc_rows, int n_chunks, int chunk,
                int span, int row_block, int dout, int num_nodes) {
  constexpr int K = group_slots<LPS>();
  constexpr int M = K / LPS;  // slots whose local_dst and index a lane loads
  extern __shared__ int smem[];
  const int n_words = (row_block + 31) / 32;
  int* ld_s = smem;                                           // the span's local_dst
  unsigned* seen = reinterpret_cast<unsigned*>(smem + span);  // a bit a row
  float* part = reinterpret_cast<float*>(seen + n_words);     // [group][lane q][VEC]
  __shared__ int own[4];  // own_lo, own_hi, split_lo, split_hi

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane % LPS;  // lane within its group
  const int g0 = lane - q;   // first lane of the group
  const int grp = warp * (32 / LPS) + lane / LPS;
  const int c = blockIdx.x;
  const int s0 = blockIdx.y * span;
  const int n = min(span, chunk - s0);  // the CTA's slots [s0, s0 + n) of chunk c
  const long long slot0 = static_cast<long long>(c) * chunk + s0;
  for (int i = tid; i < n_words; i += blockDim.x) seen[i] = 0u;
  // the group's slot j lives in lane g0 + j % LPS, register j / LPS; its
  // local_dst and index are loaded together (a pad's index is loaded and
  // never used)
  const int gfirst = grp * K;
  int ld[M];
  long long row[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int s = gfirst + q + LPS * t;
    ld[t] = row_block;
    row[t] = 0;
    if (s < n) {
      ld[t] = local_dst[slot0 + s];
      row[t] = index ? static_cast<long long>(index[slot0 + s]) : slot0 + s;
    }
  }
  const int blk = chunk_block[c];
  if (tid == 0) {
    // rows [own_lo, own_hi) of the block are this CTA's: from its first
    // destination (0 for the block's first span) to the next span's (RB for
    // the block's last), less the rows it shares with the spans beside it
    const bool first = s0 == 0 && (c == 0 || chunk_block[c - 1] != blk);
    const bool last = s0 + n == chunk && (c + 1 == n_chunks || chunk_block[c + 1] != blk);
    const int f = local_dst[slot0], l = local_dst[slot0 + n - 1];
    const int before = first ? -1 : local_dst[slot0 - 1];
    const int after = last ? row_block : local_dst[slot0 + n];
    own[0] = first ? 0 : f;
    own[1] = after;
    own[2] = f < row_block && before == f ? f : -1;
    own[3] = !last && l < row_block && after == l ? l : -1;
  }
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int s = gfirst + q + LPS * t;
    if (s < n) ld_s[s] = ld[t];
  }
  __syncthreads();
  // one bit a row a slot reaches, set by the first slot of each run
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int s = gfirst + q + LPS * t;
    if (ld[t] < row_block && (s == 0 || ld_s[s - 1] != ld[t]))
      atomicOr(seen + (ld[t] >> 5), 1u << (ld[t] & 31));
  }
  const int own_lo = own[0], own_hi = own[1], split_lo = own[2], split_hi = own[3];
  const long long base = static_cast<long long>(blk) * row_block;
  // the destinations of the slots just before and after the group's, in
  // this CTA: a run that goes on into a neighbouring group
  const int prev_ld = gfirst > 0 && gfirst <= n ? ld_s[gfirst - 1] : -1;
  const int next_ld = gfirst + K < n ? ld_s[gfirst + K] : -1;
  float* my_part = part + (grp * LPS + q) * VEC;

  const int n_groups = (dout + LPS * VEC - 1) / (LPS * VEC);
  for (int cg = 0; cg < n_groups; ++cg) {  // uniform: every thread meets the barriers
    const int col = (cg * LPS + q) * VEC;
    const bool col_ok = col < dout;
    float acc[VEC] = {};
    int cur = -1;
    bool head = true;    // the current run is the group's first
    bool finish = false;
    // a whole destination's sums to its row: stored where this CTA owns it,
    // else added with atomics
    auto to_row = [&](int r) {
      if (!col_ok || base + r >= num_nodes) return;
      const long long at = (base + r) * dout + col;
      if (r != split_lo && r != split_hi) store_vec<TO, VEC>(out + at, acc);
      else add_vec<VEC>(acc_rows + at, acc);
    };
    // a run ends: its row gets it, unless it goes on from the previous
    // group (left in shared memory) or into the next (kept for after the
    // barrier)
    auto end_run = [&](bool last_run) {
      if (head && cur == prev_ld) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) my_part[e] = acc[e];
      } else if (last_run && cur == next_ld) {
        finish = true;
      } else {
        to_row(cur);
      }
    };
#pragma unroll
    for (int jb = 0; jb < K; jb += kBatch) {
      int l[kBatch];
      float v[kBatch][VEC];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int jj = jb + j;
        l[j] = __shfl_sync(kFull, ld[jj / LPS], g0 + jj % LPS);
        const long long r = __shfl_sync(kFull, row[jj / LPS], g0 + jj % LPS);
        if (l[j] < row_block && col_ok) {
          load_vec<TM, VEC>(msgs + r * dout + col, v[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (l[j] >= row_block) continue;  // pad: group-uniform
        if (l[j] != cur) {
          if (cur >= 0) {
            end_run(false);
            head = false;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
          cur = l[j];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += v[j][e];
      }
    }
    if (cur >= 0) end_run(true);
    __syncthreads();
    if (finish) {  // add the partials of the groups the run goes on into
      for (int g2 = grp + 1;; ++g2) {
        const float* p2 = part + (g2 * LPS + q) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += p2[e];
        const int after = (g2 + 1) * K;
        if (after >= n || ld_s[after] != cur) break;  // the run ends in group g2
      }
      to_row(cur);
    }
    __syncthreads();  // the partials are reused by the next column group
  }

  // the owned rows no slot reaches: zeros, a warp a row
  const int own_end = static_cast<int>(min(static_cast<long long>(own_hi), num_nodes - base));
  const int warps = blockDim.x >> 5;
  const float zeros[VEC] = {};
  for (int r = own_lo + warp; r < own_end; r += warps) {
    if ((seen[r >> 5] >> (r & 31)) & 1u) continue;  // warp-uniform
    TO* p = out + (base + r) * dout;
    for (int i = lane * VEC; i < dout; i += 32 * VEC) store_vec<TO, VEC>(p + i, zeros);
  }
}

// The owned-row route: split rows zeroed, the sum, and for a bf16 output the
// split rows narrowed. A CTA takes kFixed's span (fixed_span).
template <typename TM, typename TO, int VEC, int LPS>
cudaError_t launch_owned(const TM* msgs, const int* index, const int* local_dst,
                         const int* chunk_block, TO* out, float* acc, int n_chunks,
                         int chunk, int row_block, int dout, int num_nodes,
                         cudaStream_t stream) {
  const int span = fixed_span(LPS, chunk);
  const int warps = (span + warp_span<LPS>() - 1) / warp_span<LPS>();
  const int parts = (chunk + span - 1) / span;
  const long long units = static_cast<long long>(n_chunks) * parts;
  if (units * 32 > INT_MAX) return cudaErrorInvalidValue;
  const int unit_blocks = static_cast<int>((units * 32 + 255) / 256);
  zero_split_rows<<<unit_blocks, 256, 0, stream>>>(local_dst, chunk_block, acc,
                                                    static_cast<int>(units), parts, chunk,
                                                    span, row_block, dout, num_nodes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = owned_smem(span, row_block, warps, VEC);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(k1_owned_kernel<TM, TO, VEC, LPS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  k1_owned_kernel<TM, TO, VEC, LPS><<<dim3(n_chunks, parts), 32 * warps, smem, stream>>>(
      msgs, index, local_dst, chunk_block, out, acc, n_chunks, chunk, span, row_block, dout,
      num_nodes);
  err = cudaGetLastError();
  if constexpr (sizeof(TO) == 4) {
    return err;
  } else {
    if (err != cudaSuccess) return err;
    narrow_split_rows<<<unit_blocks, 256, 0, stream>>>(local_dst, chunk_block, acc, out,
                                                        static_cast<int>(units), parts, chunk,
                                                        span, row_block, dout, num_nodes);
    return cudaGetLastError();
  }
}

template <typename TM, typename TO, int VEC>
cudaError_t launch_owned_vec(int lps, const TM* msgs, const int* index,
                             const int* local_dst, const int* chunk_block, TO* out,
                             float* acc, int n_chunks, int chunk, int row_block, int dout,
                             int num_nodes, cudaStream_t stream) {
  switch (lps) {
#define K1_OWNED_CASE(L)                                                              \
  case L:                                                                             \
    return launch_owned<TM, TO, VEC, L>(msgs, index, local_dst, chunk_block, out, acc, \
                                        n_chunks, chunk, row_block, dout, num_nodes,   \
                                        stream);
    K1_OWNED_CASE(1) K1_OWNED_CASE(2) K1_OWNED_CASE(4) K1_OWNED_CASE(8)
    K1_OWNED_CASE(16) K1_OWNED_CASE(32)
#undef K1_OWNED_CASE
  }
  return cudaErrorInvalidValue;
}


// A forced route (kAtomics or kOwned) over any layout (kOwned needs a
// destination-sorted one): ``scratch`` a bf16 output's f32 sums (an f32
// output takes none).
template <typename TM>
int run_forced(int route, const TM* msgs, const int* index, const int* local_dst,
               const int* chunk_block, void* out, float* scratch, int n_chunks, int chunk,
               int row_block, int dout, int num_nodes, int out_bf16, void* stream) {
  if (n_chunks < 1 || chunk < 1 || dout < 1 || row_block < 1 || (out_bf16 && scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  constexpr int kVec = 4;
  const auto al = [](const void* p, size_t b) { return reinterpret_cast<std::uintptr_t>(p) % b == 0; };
  const bool wide = dout % kVec == 0 && al(msgs, kVec * sizeof(TM)) && al(out, 16) &&
                    (scratch == nullptr || al(scratch, 16));
  const int units = wide ? dout / kVec : dout;  // vectors per row
  int lps = 1;
  while (lps < units && lps < 32) lps *= 2;
  cudaError_t err;
  if (route == kAtomics) {  // scratch: the f32 sums of a bf16 output
    float* acc = out_bf16 ? scratch : static_cast<float*>(out);
    const long long n_out = static_cast<long long>(num_nodes) * dout;
    err = cudaMemsetAsync(acc, 0, sizeof(float) * static_cast<size_t>(n_out), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = dout % kVec == 0 && al(msgs, kVec * sizeof(TM));
    err = vec ? launch_vec<TM, kVec>(lps, msgs, index, local_dst, chunk_block, acc, n_chunks,
                                     chunk, row_block, dout, num_nodes, st)
              : launch_vec<TM, 1>(lps, msgs, index, local_dst, chunk_block, acc, n_chunks,
                                  chunk, row_block, dout, num_nodes, st);
    if (err != cudaSuccess || !out_bf16 || n_out == 0) return static_cast<int>(err);
    constexpr int kNarrowThreads = 256;
    const long long want = (n_out + kNarrowThreads - 1) / kNarrowThreads;
    narrow_output<<<static_cast<int>(want < 4096 ? want : 4096), kNarrowThreads, 0, st>>>(
        acc, static_cast<bf16*>(out), n_out);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kOwned) return cudaErrorInvalidValue;
  float* acc = out_bf16 ? scratch : static_cast<float*>(out);
  if (out_bf16)
    err = wide ? launch_owned_vec<TM, bf16, kVec>(lps, msgs, index, local_dst, chunk_block,
                                                 static_cast<bf16*>(out), acc, n_chunks, chunk,
                                                 row_block, dout, num_nodes, st)
               : launch_owned_vec<TM, bf16, 1>(lps, msgs, index, local_dst, chunk_block,
                                              static_cast<bf16*>(out), acc, n_chunks, chunk,
                                              row_block, dout, num_nodes, st);
  else
    err = wide ? launch_owned_vec<TM, float, kVec>(lps, msgs, index, local_dst, chunk_block, acc,
                                                  acc, n_chunks, chunk, row_block, dout,
                                                  num_nodes, st)
               : launch_owned_vec<TM, float, 1>(lps, msgs, index, local_dst, chunk_block, acc,
                                               acc, n_chunks, chunk, row_block, dout, num_nodes,
                                               st);
  return static_cast<int>(err);
}

}  // namespace k1
