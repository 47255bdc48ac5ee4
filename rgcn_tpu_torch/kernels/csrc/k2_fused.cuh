// K2's kernel, templated on the type of x (TX) and of W (TW, by default
// TX's): f32 (k2_fused.cu), bf16 (k2_fused_bf16.cu), or f32 x with a bf16
// W (k2_fused_wbf16.cu). chunk_sum.cuh's chunk-a-CTA fixed-order sum, with
// a slot's message computed where it is staged:
//     f32, f32 x with bf16 W:  val[l] * (x[src[l]] @ W[rel])
//     bf16: bf16(val[l] * (x[src[l]] @ W[rel])), the products of bf16
//           values summed in f32 (pallas_fused.py:339-343)
// where rel = quantum_rel[l / Q]; a slot of a gap quantum (rel -1) sends
// nothing. Every value is widened exactly to f32 where it multiplies. The
// x row is gathered in 16-byte vectors (4 f32 or 8 bf16 values) where din
// and x allow it, else a value at a time; W[rel] is read through L1 (a
// warp's slots share a quantum, so its loads are broadcasts), 4 outputs a
// step (16 bytes of f32, 8 of bf16) where dout and W allow it, else one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "chunk_sum.cuh"

namespace k2 {

// VX values of an x row as f32: a 16-byte vector or one value.
template <typename TX, int VX>
__device__ __forceinline__ void load_x(const TX* __restrict__ p, float (&v)[VX]) {
  if constexpr (sizeof(TX) == 4) {
    if constexpr (VX == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = __ldg(reinterpret_cast<const float*>(p));
    }
  } else {
    if constexpr (VX == 8) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(e % 2 ? (w[e / 2] & 0xffff0000u) : (w[e / 2] << 16));
    } else {
      v[0] = __bfloat162float(p[0]);
    }
  }
}

// DO consecutive W values of one row as f32: 4 from one vector load (16
// bytes of f32, 8 of bf16), or one.
template <typename TX, int DO>
__device__ __forceinline__ void load_w(const TX* __restrict__ p, float (&v)[DO]) {
  if constexpr (sizeof(TX) == 4) {
    if constexpr (DO == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = __ldg(reinterpret_cast<const float*>(p));
    }
  } else {
    if constexpr (DO == 4) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = __uint_as_float(t.x << 16);
      v[1] = __uint_as_float(t.x & 0xffff0000u);
      v[2] = __uint_as_float(t.y << 16);
      v[3] = __uint_as_float(t.y & 0xffff0000u);
    } else {
      v[0] = __bfloat162float(p[0]);
    }
  }
}

// chunk_sum.cuh's producer: a fused slot's message.
template <typename TX, typename TW, int VX, int DO>
struct Msgs {
  const TX* x;             // (N, din)
  const TW* w;             // (R, din, dout)
  const int* src;          // (L,)
  const float* val;        // (L,)
  const int* quantum_rel;  // (L / Q,)
  int din, dout, quantum;
  struct Slot {
    int rel, src;
    float val;
  };
  __device__ __forceinline__ Slot load(long long slot) const {
    return {quantum_rel[slot / quantum], src[slot], val[slot]};
  }
  __device__ __forceinline__ bool live(const Slot& s) const { return s.rel >= 0; }
  // columns [o0, o0 + ns) of the message, as f32, to m[0, ns)
  template <int KS>
  __device__ __forceinline__ void message(const Slot& s, int o0, int ns, float (&m)[KS]) const {
    const TX* xr = x + static_cast<long long>(s.src) * din;
    const TW* wr = w + static_cast<long long>(s.rel) * din * dout + o0;
#pragma unroll
    for (int j = 0; j < KS; j += DO) {
      if (j >= ns) break;
      float acc[DO];
#pragma unroll
      for (int o = 0; o < DO; ++o) acc[o] = 0.f;
#pragma unroll 2
      for (int i = 0; i < din; i += VX) {
        float xv[VX];
        load_x<TX, VX>(xr + i, xv);
#pragma unroll
        for (int k = 0; k < VX; ++k) {
          float wv[DO];
          load_w<TW, DO>(wr + (i + k) * dout + j, wv);
#pragma unroll
          for (int o = 0; o < DO; ++o) acc[o] = fmaf(xv[k], wv[o], acc[o]);
        }
      }
#pragma unroll
      for (int o = 0; o < DO; ++o) {
        const float v = acc[o] * s.val;
        // the bf16 form's message as the Pallas kernel keeps it: rounded
        // (f32 x keeps an f32 message, as compute_dtype=None does)
        m[j + o] = sizeof(TX) == 4 ? v : __bfloat162float(__float2bfloat16_rn(v));
      }
    }
  }
};

template <typename TX, typename TW, int VX, int DO, int PROBE>
cudaError_t launch(const csum::Frame& f, const TX* x, const TW* w, const int* src,
                   const float* val, const int* quantum_rel, int din, int quantum,
                   cudaStream_t st) {
  const Msgs<TX, TW, VX, DO> prod{x, w, src, val, quantum_rel, din, f.dout, quantum};
  return csum::launch<Msgs<TX, TW, VX, DO>, float, PROBE>(f, prod, st);
}

// The launcher of every form: n_quanta quanta of Q slots, chunks of CH;
// ``part`` an (RB, dout) f32 tile a chunk, ``counters`` one zeroed counter
// a chunk (the wrapper's, rgcn_tpu_torch.kernels); ``stamps`` and PROBE: a
// probe's (chunk_sum.cuh), null and 0 on every serving path.
template <typename TX, int PROBE = 0, typename TW = TX>
int run(const TX* x, const TW* w, const int* src, const float* val, const int* local_dst,
        const int* quantum_rel, const int* chunk_block, float* out, float* part,
        unsigned* counters, int n_quanta, int din, int dout, int row_block, int chunk,
        int quantum, int num_nodes, void* stream, long long* stamps = nullptr) {
  if (n_quanta < 1 || din < 1 || dout < 1 || quantum < 1 || chunk < 1 || chunk % quantum ||
      (static_cast<long long>(n_quanta) * quantum) % chunk)
    return cudaErrorInvalidValue;
  const int n_chunks = static_cast<int>(static_cast<long long>(n_quanta) * quantum / chunk);
  const csum::Frame f{local_dst, chunk_block, out, part, counters,
                      n_chunks, chunk, row_block, dout, num_nodes, stamps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto al = [](const void* p, size_t b) { return reinterpret_cast<std::uintptr_t>(p) % b == 0; };
  // 16-byte x gathers when every row starts on a 16-byte boundary; 4
  // outputs a step when every W row's 4-column groups are whole vectors
  constexpr int kVx = 16 / sizeof(TX);
  const bool vx = din % kVx == 0 && al(x, 16);
  const bool do4 = dout % 4 == 0 && al(w, 4 * sizeof(TW));
  cudaError_t err;
  if (vx && do4)
    err = launch<TX, TW, kVx, 4, PROBE>(f, x, w, src, val, quantum_rel, din, quantum, st);
  else if (vx)
    err = launch<TX, TW, kVx, 1, PROBE>(f, x, w, src, val, quantum_rel, din, quantum, st);
  else if (do4)
    err = launch<TX, TW, 1, 4, PROBE>(f, x, w, src, val, quantum_rel, din, quantum, st);
  else
    err = launch<TX, TW, 1, 1, PROBE>(f, x, w, src, val, quantum_rel, din, quantum, st);
  return static_cast<int>(err);
}

}  // namespace k2
