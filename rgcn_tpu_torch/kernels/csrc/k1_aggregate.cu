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
// rounded once from its whole f32 sum, where the Pallas kernel rounds each
// chunk's f32 partial into its bf16 output block (pallas_aggregate.py:
// 196-198); the sums then go to an f32 scratch the wrapper allocates, and
// a second kernel narrows it.
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
// Design. No CTA walks more than one chunk, and no warp more than a fixed
// span of it: the grid is (chunk, part of the chunk), so the hub blocks are
// spread over as many CTAs as they have chunks (261 chunks at nc-AIFB).
// Lanes map to (slot, 16-byte column vector): a row of dout floats takes
// LPS lanes (the power of two >= dout / 4, at most 32; wider rows loop
// over column groups), so a warp loads 8 slots' 64-byte rows at dout 16
// and 32 slots' rows at dout 4 in one instruction. A dout that is not a
// multiple of 4 (or an unaligned msgs) takes scalar lanes instead. Each
// group of LPS lanes walks K = max(8, LPS) consecutive slots: the group's
// lanes load those slots' local_dst once (one per lane, shared by
// shuffles), and a warp whose whole span holds pads returns after that
// one coalesced load and a vote, so a chunk of pads costs one check per
// warp. The lanes then load the real slots' index, issue all the row
// loads, and sum the rows in registers while the destination stays the
// same (build_dst_layout sorts each block's slots by destination),
// flushing each run with one vector f32 atomic (red.global.add.v4.f32). A
// destination that spans groups, warps or chunks is finished by those
// atomics; the launcher zeroes the output on the same stream first, so
// rows no real slot reaches come out zero. Atomics add in no fixed order:
// results equal a sequential f32 sum up to reassociation.
//
// That is the atomics route. A destination-sorted layout (dst_sorted) with
// rows of 4-wide lanes and enough CTAs to fill the card several times
// takes the owned-row route instead (k1_aggregate_bf16.cu describes it):
// each destination whose slots lie in one CTA's span is stored once, with
// no memset and no atomic; only the rows two spans share are zeroed before
// and finished with atomics. There the atomics, not the bytes, set the
// pace: at e-RGCN nc-AM's diagonal messages (dout 32) the owned route
// measured 0.100 ms against 0.141 on an H100. Small layouts (nc-AIFB, a
// few CTAs an SM) and scalar lanes keep the atomics route, which measured
// faster there (k1_aggregate.cuh, kOwnedMinUnits).

#include "k1_aggregate.cuh"

// The parameters are the bf16 form's (k1_aggregate_bf16.cu): one argument
// list binds both. dst_sorted: each row block's slots sorted by
// destination (every builder's order but the source-ordered one).
extern "C" int k1_aggregate(const float* msgs, const int* index,
                            const int* local_dst, const int* chunk_block,
                            void* out, float* scratch, int n_chunks, int chunk,
                            int row_block, int dout, int num_nodes, int dst_sorted,
                            int out_bf16, void* stream) {
  return k1::run<float>(msgs, index, local_dst, chunk_block, out, scratch, n_chunks, chunk,
                        row_block, dout, num_nodes, dst_sorted, out_bf16, stream);
}
