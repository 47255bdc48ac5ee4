// K3's tiled route with parts of its work switched off, to see which part
// sets its time: python -m rgcn_tpu_torch.compare_k3 --probe builds it and
// times each entry point beside K3 at lp-FB-toy. Same arguments as
// k3_messages; the outputs of the probes are not K3's messages.
//
//   k3_probe_no_mma    every load and store, no MMA (the data movement)
//   k3_probe_no_loads  MMAs over zero-filled slabs, no W or x load (the
//                      in-SM loop and the zero stores)

#include "../k3_messages.cu"

extern "C" int k3_probe_no_mma(const float* x, const float* w, const int* src,
                               const float* val, const int* tile_rel, float* out,
                               int num_tiles, int tile, int din, int dout,
                               void* stream) {
  return k3_dispatch<1>(x, w, src, val, tile_rel, out, num_tiles, tile, din,
                        dout, stream);
}

extern "C" int k3_probe_no_loads(const float* x, const float* w, const int* src,
                                 const float* val, const int* tile_rel, float* out,
                                 int num_tiles, int tile, int din, int dout,
                                 void* stream) {
  return k3_dispatch<6>(x, w, src, val, tile_rel, out, num_tiles, tile, din,
                        dout, stream);
}
