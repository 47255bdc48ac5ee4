// K1: segmented destination sum over a DstLayout, for Hopper (sm_90a).
//
// Replaces rgcn_tpu/ops/pallas_aggregate.py::aggregate_presorted_pallas
// (kernel _agg_kernel). Computes
//     out[n] = sum over layout slots l with destination n of msgs[row(l)]
// where slot l of chunk c targets node chunk_block[c] * RB + local_dst[l],
// local_dst == RB marks a pad (dropped), and row(l) = index[l] when an
// index (the layout's perm into edge-order messages) is given, else l.
// Rows at or past num_nodes are dropped. The output is f32, or bf16
// (out_bf16: aggregate_presorted_pallas(out_dtype=bf16)), each element
// rounded once from its whole f32 sum where the kernel stores it, where the
// Pallas kernel rounds each chunk's f32 partial into its bf16 output block
// (pallas_aggregate.py:196-198).
//
// Bound on the H100: bytes, and in practice latency. The work is one add
// per real slot and column; the card must read each real slot's message
// row and index, the layout's local_dst, and write the output once (at
// nc-AIFB, dout 16: ~4.7 MB, ~1.4 us at 3.35 TB/s). What the time is made
// of instead is the chain of dependent loads (local_dst and index, then
// the message row) and how many of those chains run at once. Giving each
// row block to one CTA, as the TPU kernel's sequential grid suggests, left
// 65 CTAs on 132 SMs and walked the hub blocks (4,685 real slots against a
// median of 513) serially, about 160x the bound.
//
// Design (k1_aggregate.cuh). No CTA walks more than one span of one chunk:
// the grid is (chunk, part of the chunk, column group), so the hub blocks
// are spread over as many CTAs as they have chunks (261 chunks at
// nc-AIFB). Lanes map to (slot, 4 columns): a row of dout floats takes LPS
// lanes (the power of two >= dout / 4, at most 32; wider rows take a CTA
// a column group), so a warp loads 8 slots' 64-byte rows at dout 16 and 32
// slots' rows at dout 4 in one instruction. A dout that is not a multiple
// of 4 masks the row's last lane, and a lane moves its 4 values in 8- or
// 4-byte pieces where the rows are not whole 16-byte vectors (nc-AM's
// width 10: 3 lanes a row, two of 16 bytes and one of 8, in 8-byte
// pieces). Each group of LPS lanes walks K = max(8, LPS) consecutive
// slots, loading their local_dst and index once (one per lane, shared by
// shuffles), issues all the row loads, and sums the rows in registers
// while the destination stays the same (build_dst_layout sorts each
// block's slots by destination). A CTA owns the rows from its first slot's
// destination to the next CTA's, and stores each once, zeros where no slot
// reaches: no memset. A run that goes on into the next group is merged in
// group order through shared memory; one that crosses into the next CTA
// leaves an f32 part, which the last of the run's CTAs adds in CTA order.
// Every sum is taken in one order fixed by the layout, so two launches
// give the same bits (the atomics design before it added each run with a
// vector f32 atomic into a memset output, in the order the warps arrived;
// it is kept for the comparison scripts in variants/). A layout in source
// order within its blocks (dst_sorted 0) takes chunk_sum.cuh's route
// instead.

#include "k1_aggregate.cuh"

// The parameters are the bf16 form's (k1_aggregate_bf16.cu): one argument
// list binds both. scratch: the route's f32 parts; counters: one zeroed
// counter a (unit, column group) (kFixed) or chunk (kChunk), left zero;
// route: k1::Route, the wrapper's (rgcn_tpu_torch.kernels.k1_route).
extern "C" int k1_aggregate(const float* msgs, const int* index,
                            const int* local_dst, const int* chunk_block,
                            void* out, float* scratch, unsigned* counters, int n_chunks,
                            int chunk, int row_block, int dout, int num_nodes, int route,
                            int out_bf16, void* stream) {
  return k1::run<float>(msgs, index, local_dst, chunk_block, out, scratch, counters, n_chunks,
                        chunk, row_block, dout, num_nodes, route, out_bf16, stream);
}
