#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (rgcn_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN (f32 comparisons stay f32);
2. build: nvcc builds every kernel of kernels/csrc/ in parallel and
   reports each source's entry points, registers and spill stores; beside
   it g++ builds the port's two host libraries from native/csrc/ (the
   builders, and the N-Triples parser with zlib);
3. kernels, nc-AIFB: K1 (layer 1, dout 16), K2 and K3 (its small route)
   at the nc-AIFB shapes, and K1 at the K3 branch's layer-2 width (dout
   4, its own torch.index_add yardstick), each held against its plain PyTorch
   version on the card (f32, max abs diff <= 1e-5 * max(1, max|ref|): the
   kernels reorder f32 sums). "ms", "plain_ms" and "library_ms" (the
   one-call yardstick) are device time per call, the summed kernel time
   torch.profiler records over 50 calls; "call_ms", "plain_call_ms" and
   "library_call_ms" are the CUDA-event time per call of 50 calls back to
   back, which includes the host's launch cost when that is the longer.
   Then the hub case: K1 (dout 16 and 4, and 400 and 440, the pair
   path's dT widths, through its perm), K2, and K4 and K5 (width 200,
   2 bases, over the graph's merged frame and its dedup frame) on a skewed
   graph where one destination receives more than four chunks' worth of
   slots and a row block holds pad chunks only (fused: gap quanta only),
   against their plain versions; K4 and K5 write into memory that held NaN
   and must leave the isolated nodes' rows 0 and return node-major storage;
4. serving nc-AIFB, two paths, each with the launch counts zeroed just
   before it and read just after: the main path, load_nc_server on
   configs/rgcn/nc-AIFB.yaml with the AIFB-scale synthetic graph at full
   width (hidden 16, R' = 91), three classify requests of 8 test nodes
   and one probabilities request, must launch exactly K1 once and K2
   once; the same model served from the EdgeSet without its fused layout
   (the K3 + K1 branch) must launch K3 once and K1 twice. The logits must
   be finite, (N, C), and match the same parameters run through the plain
   versions on the CPU (atol 1e-4), and the predicted classes must agree;
5. training nc-AIFB, counts zeroed before each path: five epochs of
   configs/rgcn/nc-AIFB.yaml on the AIFB-scale graph from the seed-0
   initialisation, through the trainer on the card, held against the same
   training on the CPU's plain versions (per-epoch loss within rtol 1e-4,
   accuracies equal, final logits within 1e-4 * max(1, max|ref|)); every
   parameter's gradient after one backward within 1e-5 * max(1,
   max|ref|); the main path must launch exactly K1 2E + 1 and K2 3E + 1
   times (E epochs; the extra K2 a step is layer 2's dx over
   edges.reverse), the same training without fused layouts K1 5E + 2 and
   K3 3E + 1; the main path trained a second time from the same
   initialisation (a fresh trainer, counts zeroed) must launch the same and
   end with the same records and bit-equal final parameters and logits (K1
   and K2 sum in a fixed order, the dense layer's dW by relation in tile
   order: train_main_twice), checked before the CPU gate; then K2 and K3
   (small route) at the dx shape (g (N, 4), W^T
   (90, 4, 16) over the reversed edges) held and timed as in phase 3, and
   one warm training step profiled (train_timing_ms: host median of 20
   steps, device time split into forward, backward and optimizer, busy
   share);
6. kernels, lp-WN18: K4 over the merged pair frame (shared rows, the main
   path's shapes), K4 with per-basis rows and sum_bases (the form of the
   featureless-basis forward and the training backward), K4 over the
   unmerged destination layout, and K5 over the source-dedup'd frame, each
   held against its plain version with the same tolerance and timed as in
   phase 3; the yardstick is one torch.sparse.mm of the (nb*N, N) CSR
   matrix carrying w[b, slot] at (b*N + dst, src) with x. Then the encode's
   closing product over K4's node-major output (one (N, nb*200) @
   (nb*200, 200) GEMM) against the einsum over a basis-major copy, each
   profiled (device time per kernel, one JSON line);
7. serving lp-WN18, two paths, counts zeroed before each: the main path,
   load_lp_server on configs/rgcn/lp-WN18.yaml with wn18_like() at full
   width (200, basis 2), answering point scores of 8 test triples, top-10
   tails of 32 (s, p) and heads of 32 (p, o) queries and one filtered
   top-10 tail request, must launch exactly K4 once (one encode); the same
   model over the EdgeSet whose merged layout carries the dedup frame
   (dedup_k=2) must launch exactly K5 once. z must be finite, (N, 200),
   and match the CPU plain run within atol 1e-4, as must the point scores;
   top-k entities must equal the CPU's wherever the k-th and (k+1)-th CPU
   scores are more than 1e-4 apart. Reports the encode time (host clock,
   median of 20 refresh() calls) and one 1024-query top-10 tail batch;
8. kernels, lp-FB-toy (the block layer's expanded weights, fb_toy_like(),
   width 500): K3 at x (280, 500), W (224, 500, 500), 250 tiles of 128
   (its tiled route: 3xTF32 on the tensor cores, held to the same f32
   tolerance), its yardstick one torch.bmm over x[src] tiles and
   W[tile_rel] gathered beforehand (TF32 off, the gathers not timed); its
   bound counts the real rows' FLOPs only (pad rows are zeros by
   contract); K1 at dout 500 over the FB-toy destination layout, with its
   torch.index_add yardstick; each held and timed as in phase 3;
9. serving lp-FB-toy, counts zeroed before it: load_lp_server on
   configs/rgcn/lp-FB-toy.yaml with fb_toy_like() at full width (500, 100
   blocks), the requests of phase 6, must launch exactly K3 once and K1
   once (one encode); z, scores and top-k checked against the CPU plain
   run as in phase 6; reports the encode's host-clock median of 20
   refresh() calls;
10. serving the many-basis NC configs on their stand-in graph, counts
   zeroed before each path: nc-MUTAG (30 bases, hidden 16) and nc-BGS (40
   bases) on the 500-node graph serve_nodes picks, each exactly K1 once
   (layer 1: the basis rows gathered and contracted per tile, then K1)
   and K2 once (layer 2: comps @ bases expanded to dense weights); and
   the few-basis branch, an nc config with 4 bases built in memory on
   aifb_like(), exactly K4 twice (layer 1 over the per-basis tables with
   sum_bases, layer 2 over the merged frame). Logits finite, (N, C),
   within 1e-4 * max(1, max|ref|) of the CPU plain run, classes equal
   the CPU's on three requests of 8 test nodes;
11. nc-AM at AM scale (am_like(): 300,000 nodes, 266 relations, so R' 533;
   747,518 triples; 40 bases, hidden 10, 11 classes): load_nc_server on
   configs/rgcn/nc-AM.yaml, counts zeroed before it, exactly the launches
   of AM_PATH, logits checked against the CPU plain run as in phase 9,
   the forward's host-clock median of 20 refresh() calls; then, on the
   served EdgeSet, K1 at dout 10 (layer 1) and 11 (layer 2 over K3 + K1),
   K3 (small route) and K2 at layer 2's x (300,000, 10), W (532, 10, 11),
   each held and timed as in phase 3, and layer 2's two routes (K2 over
   the fused layout, K3 then K1 over the destination layout) held against
   the plain version and timed in turns (K2, K3 + K1, K3 + K1, K2);
12. training the many-basis configs on the unique-(src, rel) pair path,
   counts zeroed before each path: nc-MUTAG and nc-BGS on the 500-node
   stand-in for 5 epochs, nc-AM at AM scale (the graph of phase 11) for 2,
   each from the seed-0 initialisation on the card and on the CPU's plain
   versions: every gradient after one backward within 1e-5 * max(1,
   max|ref|), per-epoch loss within rtol 1e-4, accuracies equal, final
   logits within 1e-4 * max(1, max|ref|), and exactly K1 8E + 2 launches
   and no other kernel (per epoch: train forward 2, backward 4 (each
   layer's pair-message gradient and basis-table gradient), eval forward
   2; then the final prediction's 2), with the run's peak device memory;
   nc-AM trained again from the seed-0 initialisation must repeat the
   first run's launches, records, parameters and logits bit for bit
   (check_repeat: K1's fixed-order kernel at width 10, 4-value lanes with
   a masked tail in 8-byte pieces, and the relation gathers' fixed-order
   backward); then K1 in the path's modes at nc-AM's shapes, held and timed as in
   phase 3 with a torch.index_add yardstick (the composed forward at dout
   10 and 11, the pair messages' gradient over grad_layout at 10 and 11,
   the basis table's gradient over src_layout at 400 and 440), and the
   AM-scale step profiled as in phase 5;
13. training lp-WN18 (wn18_like(), width 200, 2 bases, batch 30,000, 10
   negatives a positive) and lp-FB-toy (fb_toy_like(), width 500, 100
   blocks, batch 300) for 2 epochs each through the trainer's production
   step (subgraph, negatives and scoring layouts built on the host; the
   structured DistMult scorer), counts zeroed before each path: from the
   seed-0 initialisation on the card and on the CPU's plain versions,
   every gradient after one backward within 1e-5 * max(1, max|ref|),
   per-epoch loss within rtol 1e-4, the final filtered MRR within 1e-3
   and at least 99% of the ranks of the whole test split equal, after the
   card has trained again from the same initialisation and repeated its
   launches, records, parameters and test ranks bit for bit
   (check_lp_repeat: K4 and K1 sum in a fixed order, dcomps and d
   relations by ops/ordered.py's segment sums); exactly
   K4 4E + 1 and K1 2E (lp-WN18: per step K4 forward, K4 dx over the
   reversed subgraph, two K4 terms of the corrupted entities, K1 for the
   subjects' and the objects' rows; one K4 encode over the merged frame
   to evaluate) and K3 2E + 1, K1 4E + 1, K4 2E (lp-FB-toy: K3 then K1
   forward and dx, the same decoder; one K3 + K1 encode) and nothing
   else; then the new modes held and timed as in phase 3 at the paths'
   shapes (K4 per-basis sum_bases over the reversed subgraph, the two
   corrupted-entity terms at Ns 300,000, K1 over the subjects' and
   objects' layouts at P 30,000, d 200; K3 with W^T and K1 at dout 500
   over lp-FB-toy's reversed subgraph), and each step profiled as in
   phase 5 with the card's name and power limit beside it;
14. serving c-RGCN (configs/c-rgcn/lp-WN18.yaml on wn18_like(), width
   128 compressed to 16; lp-FB-toy.yaml on fb_toy_like(), 64 to 10)
   through load_lp_server, counts zeroed before each: exactly K2 once per
   encode (the dense R-GCN at the compressed width; the bottleneck layers
   are matmuls); z and point scores within 1e-4 * max(1, max|ref|) of the
   CPU plain run, top-10 sets as in phase 7; each encode's host-clock
   median of 20;
15. training c-RGCN on both configs for 2 epochs, full batch (no
   graph_batch_size: every training triple a positive, 10 negatives
   each), gated as in phase 13 but for the ranks: every test rank must
   lie within the CPU model's band of ranks whose scores are within 1e-4 *
   max(1, max|score|) of the true triple's (this untrained model's
   candidates score so densely that f32 noise moves ~1% of exact ranks:
   a second CPU run from the initialisation moved by 1e-7 relative shows
   it), the shares of equal ranks reported; exactly K3 2E, K1 4E, K4 2E
   and K2 1 (a
   step: K3 then K1 forward and dx over the reversed subgraph, the
   decoder's two K4 and two K1; the final evaluation's encode K2), each
   step profiled as in phase 5;
16. serving e-RGCN (configs/e-rgcn/, embeddings 32): nc-AIFB on aifb_like()
   (90 general relations: the diagonal layer over the merged pair frame)
   exactly K1 1 and K2 1, nc-AM on am_like() at AM scale (532: unmerged,
   slot order) exactly K1 2 and K3 1; logits and classes as in phase 10;
   each forward's host-clock median of 20;
17. training e-RGCN: nc-AIFB for 4 epochs (exactly K1 3E + 1, K2 3E + 1)
   and nc-AM at AM scale for 2 (exactly K1 6E + 2, K3 3E + 1), gated as
   in phase 12, nc-AM trained twice bit-equal (check_repeat: the diagonal
   layer's K1 on its fixed-order kernel, d dw by relation run), each step
   profiled as in phase 5;
18. K1 in the diagonal layer's four modes at d 32 (merged forward and dx
   on the nc-AIFB training EdgeSet, unmerged forward and dx at AM scale),
   held against the plain version run in f64 on the same rows (at AM
   scale the plain f32 sum over the reverse frame's hub is itself about
   as far from the exact sum as the tolerance) and timed as in phase 12
   with a torch.index_add yardstick; the torch ops around K1 on those
   paths (the slot-order message build, and the same build through
   index_select for comparison, d dw's index_add_, the merged frame's
   row product, coeff @ dw, rev_coeff @ dw and its d dw product) timed as
   in phase 3 (one "diag_around" line each); K2 at the c-RGCN encode
   shapes (W (36, 16, 16) and (224, 10, 10), the latter on K2's scalar
   path) held and timed as in phase 3, and at each shape both routes of
   the encode timed in turns (a "crgcn_encode_routes" line each). Phases
   14-18 print their seconds;
19. from dataset files on disk, in a temporary directory: aifb_like()
   written as AIFB's files (aifb/aifb_stripped.nt.gz with URIs,
   trainingSet.tsv and testSet.tsv whose labels are the integers 7, 42,
   105 and 1000) and loaded with load_node_classification(final_run=True),
   which must give back the same graph and class codes; nc-AIFB trained 6
   epochs on the card with checkpoints every 2, and a run broken after
   epoch 4 and resumed from step 4 to 6 (counts zeroed before the resumed
   leg: exactly K1 2E + 1 and K2 3E + 1 for its E = 2 epochs), both held
   against each other and against the CPU under phase 5's gates; a server
   built from the checkpoint (exactly K1 1, K2 1), its logits within
   1e-4 * max(1, max|ref|) of the trained model's and its classes its
   argmax wherever the top two logits are apart. wn18_like() written as
   WN18's files (its test split halved into valid.txt and test.txt; the
   loaded graph holds the entities its triples reach) and loaded with
   load_link_prediction; lp-WN18 trained 4 epochs straight (checkpoints
   every 2) and 2 epochs (max_epochs) then resumed to 4 (the resumed leg
   exactly K4 4E + 1 and K1 2E for its E = 2), held against each other and
   against the CPU under phase 13's gates (losses rtol 1e-4, MRR 1e-3,
   99% of ranks equal); a server from the checkpoint (exactly K4 1), its z
   within 1e-4 * max(1, max|z|) of the trained model's encode and its
   top-10 tails of 256 test queries those of the model wherever the 10th
   and 11th scores are more than 1e-4 apart (at least half of them). One
   line of host-clock seconds: each write, load, save, restore and
   server build, with the card's name and power limit. When a final-logits
   gate of phases 5 and 19 fails, the run first logs the card's logits
   against the CPU forward of the card's own parameters and each
   parameter's distance from the CPU run's;
20. the native host builders on the card's host, with the card's name
   and power limit and the host CPU's model and core count: a 20M-edge
   native lexsort in a second thread must leave this thread at least 0.3
   of its loop rate (ctypes released the GIL); for lp-WN18 (batch 30,000),
   c-RGCN lp-WN18 (full batch) and lp-FB-toy, profile_epoch's measurement:
   each sample_epoch stage's host ms with the native and the numpy
   builders (median of 3 epochs after a warm one; every epoch's two
   batches equal bit for bit, the first equal to sample_epoch's own) and
   4-epoch fits on the card both ways (epoch wall time, the step's host
   time, the device's busy share; losses within rtol 1e-4 of each other);
   each config trained 1 epoch on the CPU by the trainer and with the
   numpy builders, losses, MRR and every rank bit-identical; lp-WN18
   trained 2 epochs on the card by the trainer with the native calls and
   the launches zeroed just before it: exactly 1 edge set, 4 + 5E
   layouts and 1 + 2E lexsorts, and phase 13's launches; am_like()'s
   build_edge_set with layouts and am_like() written as AM's .nt.gz
   graph and parsed, once each way, outputs equal (the parse also to the
   source's triples), host seconds; one "host_build_ms" line (keys ending
   in _s are seconds);
21. the single-device branches no shipped config reaches, each trained on
   the card and on the CPU's plain versions from the same initialisation,
   counts zeroed just before each path: nc-AIFB R-GCN with 4 bases on
   aifb_like() for 3 epochs (layer 1 the featureless basis Function,
   layer 2 the merged frame's: exactly K4 6E + 2), nc-AM R-GCN with 4
   bases on am_like() at AM scale for 2 (532 general relations: layer 2
   over the destination layout; exactly K4 6E + 2), e-RGCN nc-AIFB with 4
   bases (K1 3E + 1, K4 3E + 1) and with 2 blocks (rgc1's expanded blocks
   on K2 both ways: K1 3E + 1, K2 3E + 1) for 3 each, under phase 12's
   gates; lp-WN18 (wn18_like(), width 200, batch 30,000) for 2 epochs with
   a biased decoder (the assembled batch scored by plain gathers and
   autograd: K4 2E + 1), a plain L2 (the assembled batch's scorer, K1 for
   the subjects' and objects' rows: K4 2E + 1, K1 2E) and the structural
   self-loop mask (one (N, 1) mask, structured scorer: K4 4E + 1, K1 2E,
   trained twice bit-equal before the gates against the CPU, as in phase
   13), under phase 13's gates, the assembled branch's sample_epoch stages
   timed; each step profiled as in phase 5; then one forward and backward
   of the merged-frame basis Function over phase 6's dedup frame (exactly
   K5 1 and K4 1) held against the same Function over the plain merged
   frame within 1e-5 * max(1, max|ref|), both timed, and K4 under grad
   outside the Functions must raise; K4's f32 form at nc-AM's width 10
   (8-byte pieces) over the 4-basis branch's layout, held and timed as in
   phase 3; one "branches" line;
22. edge-sharded training (rgcn_tpu_torch.dist), each case on ranks the
   script starts (spawn) and against the port's single-device trainer on
   the card from the same seed (seed 0, its epochs): nc-AIFB R-GCN
   (aifb_like(), hidden 16) 2 epochs on 2 ranks sharing the card over
   gloo (each shard's layer 1 on K1, layer 2 K3 + K1 both ways), nc-AM at
   AM scale (am_like(), 40 bases) 1 epoch on the pair path (K1), lp-WN18
   (wn18_like(), width 200, batch 30,000, 300,000 negatives) 1 epoch on
   the structured step (K4, K1) with the final candidate-sharded
   evaluation, all three on one 2-rank job; lp-FB-toy (fb_toy_like(),
   width 500, 100 blocks) 1 epoch on a 2x2 mesh of 4 gloo ranks (K3, K1,
   K4); nc-AIFB again on one NCCL rank, and on 2 NCCL ranks of one card
   each where the machine has two (else a line says it did not run); and
   lp-WN18 once more on the 2-rank job on the card's default edge stage
   (bf16; the other cases run pinned to f32).
   Gates: every rank's losses, final logits or ranks and parameter bits
   equal rank 0's; losses within rtol 1e-4 of the single-device run,
   final logits within 1e-4 * max(1, max|ref|), MRR within 1e-3 and at
   least 99% of the ranks equal; each rank's launches exactly the
   single-device trainer's on its shard (sharded_expect), counts zeroed
   just before each case's fit; the bf16 case held instead to the CPU's
   one-device run with the edge stage pinned to bf16 (losses within 8e-3
   * max(1, |ref|), MRR within 1e-3, ranks equal reported), its encoder
   through K4's bf16 form; and initialize_distributed must refuse
   NCCL for more ranks than cards. Lines per rank: set-up and fit
   seconds, every step's synchronised host ms, one all-reduce of an (N,
   width) tensor; one "sharded" JSON line and the phase's seconds. These
   are correctness runs: ranks that share a card reduce through host
   copies, and their times are no scaling figure;
23. tooling (rgcn_tpu_torch/utils/profiling.py, utils/canary.py), counts
   zeroed just before each path: nc-AIFB trained 2 epochs through
   classify_nodes.main and lp-WN18 1 epoch through predict_links.main
   (both --synthetic) with --profile-dir; the one *.pt.trace.json each
   writes must hold CUDA kernel events, and its events of K1 in both forms
   (k1_fixed_kernel; chunk_kernel<k1:: over a source-ordered layout),
   K2 in both forms (chunk_kernel<k2::), K3 (k3_tiled_kernel,
   k3_small_kernel) and K4 + K5 in both forms (K4's k4o::owned_kernel<...>,
   K5's weighted_runs.cuh runs_kernel<...>) must equal the launch counters over the same run (the
   kernels launch through ctypes from the nvcc-built libraries), K1 and
   K2 (nc-AIFB), K1 and K4 (lp-WN18) at least once; measure_canary called
   twice on one fresh floor file (the WN18-scale merged basis op over its
   dedup frame with a bf16 compute dtype, as the JAX canary steps):
   exactly K5's bf16 form once a step and nothing else, the second call
   reading the first's floor (ratio >= 1), and one step's K5 held against
   its plain version within 1e-5 * max(1, max|ref|) (f32) and its bf16
   form within 2^-8 * |ref| more (bf16 table and output); StepTimer (CUDA events)
   over 50 chained canary steps within 2x of cuda_ms of the same step (a
   unit and synchronisation check, no speed gate), its edges/s over the
   merged frame's real pairs; one "tooling" line and the phase's seconds;
24. installed package: "setup.py build_py" lays the port out, as "pip
   install ." installs it, into a fresh temporary directory, made
   read-only; a child process run from there, with neither the checkout
   nor JAX importable (it loads this script by path), builds every kernel
   (the five, the bf16 forms of K1-K5 and K2's and K3's bf16-weight forms;
   nvcc, in parallel) and both host libraries (g++) from scratch
   into the per-user cache ($XDG_CACHE_HOME/rgcn_tpu_torch, a fresh
   directory; the copy must be left as it was), serves nc-AIFB (aifb_like(), exactly K1 1, K2 1) and
   lp-WN18 (wn18_like(), 2 bases, width 200, exactly K4 1) with counts
   zeroed just before each, and holds K1-K3 on the nc-AIFB server's edges
   and K4, K5 on the lp-WN18 server's (phase 3's and 6's shapes and
   tolerance), and the bf16 forms there (f32 outputs; K2's bf16-rounded
   messages with phase 27's bound) and the bf16-weight forms (f32 x, W in
   bf16), against their plain versions; the
   edge stage pinned to f32; then lp-WN18 served once more
   on the card's default edge stage (exactly K4's bf16 form once; phase 26
   holds its answers to the CPU's bf16 run); no library of the checkout's
   build/ may be mapped. Gates: each library's name (its source hash)
   equals the checkout's; the synthetic graphs equal the checkout's; the
   answers equal phases 4 and 6's within their tolerances (logits, z and
   point scores 1e-4, classes equal, top-10 sets equal where the
   checkout's 10th and 11th scores are apart). One "installed" line:
   each kernel's build seconds from scratch, its max abs error and its
   launches in both serves, and the phase's seconds;
25. device-built LP epochs (host_graph_build=False: the host samples the
   positives, the card draws the keep mask, negatives and self-loop masks
   from per-epoch torch generators and builds the subgraph, its layouts
   and reverse; the structured decoder layout-free), counts zeroed just
   before each path: lp-WN18 (wn18_like(), width 200, 2 bases, batch
   30,000) for 4 epochs, c-RGCN lp-WN18 (full batch) for 2 and
   lp-FB-toy (width 500, 100 blocks) for 3, each against the CPU's plain
   run of the card's own draws (replayed on the card, copied back): the
   first epoch's EdgeSet with its layouts and reverse bit-equal to the
   CPU builder's for those draws, built under
   torch.cuda.set_sync_debug_mode("error") (a host sync fails); at every
   epoch of the card's fit, from the card's parameters of that moment,
   the loss within rtol 1e-4 and every gradient within 1e-5 * max|ref|
   of the CPU's; the final filtered MRR within 1e-3 of the CPU's
   evaluation of the card's final parameters (99% of the ranks equal but
   for c-RGCN); a second card run's per-epoch losses against the first
   reported (the card's own spread); exactly K4 2E +
   1 (lp-WN18), K3 2E, K1 2E, K2 1 (c-RGCN), K3 2E + 1, K1 2E + 1
   (lp-FB-toy) and no native host-builder call; then lp-WN18 with a
   biased decoder for 2 (the assembled batch, no layouts: K4 2E + 1) under
   the same gates; K2 over the fused layouts
   the card builds for lp-WN18's first epoch (forward and reverse, x (N,
   16), W (36, 16, 16)) against its plain version, timed as in phase 3;
   make_sharded_lp_step for lp-WN18 on 2 gloo ranks sharing the card for
   2 SGD steps: the ranks bit-equal, exactly K4 2E a rank, within rtol
   1e-5 (loss) and 1e-5 * max(1, max|ref|) (gradients, parameters) of
   the single-device device-built trainer on the card from the same
   generators; then
   profile_epoch's fits of lp-WN18 and c-RGCN lp-WN18, 4 epochs each way
   in turns (host, device, device, host): epoch wall, step and set_epoch
   host ms, busy share, peak memory, the build's device ms (CUDA
   events) and one device-built step profiled as in phase 5; one
   "device_epochs" line and one "host_vs_device_epoch_ms" line;
26. edge precision: the card's default edge stage, bf16 tables and
   messages with f32 sums at the five branches where the JAX layer narrows
   it (phases 3-25 run with it pinned to f32, spawned ranks and the
   installed copy's child too, so each of their gates holds what it held
   before, but for phase 22's and 24's bf16 runs; the canary's step is
   bf16 by design). Serving on the default
   path: lp-WN18 (merged frame, and its dedup frame), nc-MUTAG on its
   stand-in, nc-AM with 4 bases and e-RGCN nc-AM at AM scale (on the
   am_like() triples phase 11 made), e-RGCN nc-AIFB; exact launches, the
   bf16 forms' counters counting every bf16 operand and the f32 forms'
   none; answers within 8e-3 * max(1, max|ref|) of the CPU's run of the
   same model and EdgeSet with the edge stage pinned to bf16, and z and
   logits within a quarter of the same server's f32 answers' distance
   from it (+ 1e-5 * max(1, max|ref|)); the installed copy's bf16 lp-WN18
   answers (phase 24) held to the same CPU run; the gap to the f32
   answers and both serve times. The bf16 forms
   against their plain versions (f32 sums) at lp-WN18's merged frame (bf16
   and f32 outputs), its merged reverse frame with per-basis tables summed
   over bases, nc-AIFB's merged frame with 4 bases (K4's owned-row kernel,
   which the route rule takes there), lp-WN18's dedup frame, and e-RGCN
   nc-AM's diagonal messages: f32
   outputs within 1e-5 * max(1, max|ref|), bf16 outputs within 2^-8 * |ref|
   more; each timed beside its f32 form, with torch.sparse.mm in bf16 as
   the yardstick where torch takes it. One training step (loss and
   backward, exact launches) per branch from the same parameters against
   the CPU's bf16 step, gradients within 8e-3 * max(1, max|ref|) (lp-WN18:
   8e-3 * max|ref|) and within a quarter of the card's f32 gradients'
   distance from them (as the answers): nc-AIFB with 4 bases, nc-MUTAG
   (pairs), e-RGCN nc-AIFB and nc-AM, lp-WN18, and lp-WN18 with
   decoder.bwd_dtype bfloat16 (its scores and penalty bit-equal to the f32
   decoder's); the step times both ways; two lp-WN18 epochs with finite
   losses, trained again by a fresh trainer from the same parameters with
   the same launches and bit-equal losses and parameters (K4's bf16 form
   on its owned-row kernel at every layout); lp-WN18 trained 1 epoch through predict_links.main with
   --profile-dir on the default path (the trace's events equal the
   counters, exactly K4's bf16 form 2E + 1, its f32 form and K1 2E each,
   the first loss within 8e-3 * max(1, |ref|) of the CPU's bf16 loss);
   2 device-built lp-WN18 epochs under phase 25's gates with the CPU
   pinned to bf16 and bf16 bounds (loss 8e-3 * max(1, |ref|), gradients
   8e-3 * max(1, max|ref|), exactly K4's bf16 form 2E + 1, MRR within
   1e-3, ranks equal reported); the canary once (exactly K5's bf16 form a
   step);
27. kernel dtype options (the JAX kernels' own compute_dtype, accum_dtype
   and out_dtype): K2's bf16 form at nc-AIFB's layer 2 (W (90, 16, 4),
   rel_spmm_fused's default), K3's bf16 form at lp-FB-toy (x (280, 500),
   W (224, 500, 500): bf16 operands on its one-pass bf16 mma.sync tiled
   route, f32 and bf16 messages; f32 operands with bf16 messages) and K1
   with a bf16 output over the nc-AIFB layout (f32 and bf16 messages),
   each against its plain version's f32 sums of the same bf16 values
   (f32 outputs within 1e-5 * max(1, max|ref|), bf16 outputs within 2^-8
   * |ref| more, K2's bf16-rounded messages within 2^-8 * sum|msg| more),
   timed beside its f32 form, with torch.bmm in bf16 over pre-gathered
   tiles as K3's yardstick (K1 and K2: none, the row says why); then, the
   counts zeroed before each, rel_spmm_fused with its default, rel_spmm_full
   with compute_dtype bf16 at lp-FB-toy, rel_spmm_full with bf16 compute
   and accum at nc-AIFB and rel_spmm_pallas with bf16 compute, each with
   exactly the launches of DTYPE_PATHS and within 8e-3 * max(1, max|ref|)
   of the port's CPU run (and a quarter of the f32 answer's distance from
   it); one dtype_options line and one dtype_modes line;
28. bf16 parameters (the layers' param_dtype, PARAM_PATHS): K2's
   bf16-weight form at nc-AIFB's layer 2 (x f32, W (90, 16, 4) bf16) and
   K3's at lp-FB-toy's block layer (x (280, 500) f32, W (224, 500, 500)
   bf16, its tiled route's two TF32 passes), each against its plain
   version's f32 sums (1e-5 * max(1, max|ref|)), timed beside its f32 form
   on W widened beforehand (K2's form must give that form's bits), no
   PyTorch call as yardstick (the row says why); nc-AIFB at full width
   with its layers in bf16 from the seed-0 initialisation: the served
   forward (exactly K1 and K2's bf16-weight form once) and one loss and
   backward (K1 once, the form twice: layer 2's forward and dx) against
   the CPU's with the same parameters and the edge stage pinned to bf16
   (logits, loss and every gradient, bf16 for the parameters, within 8e-3
   * max(1, max|ref|)), then PARAM_NC_STEPS Adam steps trained twice from
   that initialisation, bit-equal; lp-WN18 (width 200, 2 bases) and
   lp-FB-toy (width 500, 100 blocks) with their encoder layers and DistMult
   in bf16: lp-WN18's encode (K4's bf16 form) and each one's epoch-1 loss
   and backward (lp-WN18: K4's bf16 form and K1; lp-FB-toy: K3's
   bf16-weight form and K1) against the CPU's (8e-3 * max|ref|); and
   rel_spmm_featureless_basis at nc-AM layer 1's shapes (am_like(), 40
   bases, width 10, summed by K1) under precision None, "highest" and
   "high": None and "highest" bit-equal, "high" (3xTF32) within 1e-5 *
   max(1, max|ref|), each timed with CUDA events; one param_dtype line and
   one param_dtype_modes line;
29. summary: one JSON line of each path's launch counts (serving, and
   training), the training steps' timing (nc-AIFB, nc-AM, lp-WN18,
   lp-FB-toy, the c-RGCN and e-RGCN configs), one of the extra nc modes
   (K1 at dout 4, K3 at nc-AIFB, K2 and K3 at the dx shape,
   K1 at dout 500 over the FB-toy layout, the nc-AM kernels with their
   launches on the nc-AM path, K1's pair-path modes with their launches
   on the nc-AM training path, the diagonal layer's K1 modes and K2 at
   the c-RGCN shapes with their launches on their paths), one
   of the extra K4 modes, one of the LP training modes, one of the rows
   around the diagonal layer's K1, and the "kernels"
   line, whose "launches" for each kernel is its count on the path named
   beside it and "train_launches" its count on each training path, and
   just before that line the host_build_ms line of phase 20 and the
   branches line of phase 21 (the branches' training paths are in each
   row's "train_launches") and the sharded line of phase 22 (each row's
   "sharded_launches": its count on every rank of each sharded case)
   and the tooling line of phase 23 (each row's "tooling_launches": its
   count on each traced run and over the two canary calls) and the
   installed line of phase 24 (each row's "installed_launches": its
   count in each of the copy's serves) and the two lines of phase 25
   (each row's "device_launches": its count on each device-built path),
   and the edge_precision and bf16_modes lines of phase 26 (each row's
   "precision_launches": its count on each of phase 26's paths; the bf16
   forms' rows, "K1 bf16", "K4 bf16" and "K5 bf16", each with its count on
   the default path that serves through it, and "K4 bf16 owned", K4's
   owned-row kernel at nc-AIFB with 4 bases, with its count on that
   config's bf16 step, each with its counts on phase 22's and 24's paths
   and its time beside its f32 form's), and the dtype_options
   and dtype_modes lines of phase 27 (the rows "K2 bf16", "K3 bf16" and "K1
   bf16-out", each with its count on the phase-27 path that launches it;
   K1's bf16 output counts as its message form's launch), and the
   param_dtype and param_dtype_modes lines of phase 28 (the rows "K2
   bf16-W" and "K3 bf16-W", each with its count on the phase-28 path
   that launches it: nc-AIFB's served forward, lp-FB-toy's step), and the
   rows "K1 masked lanes" (K1's fixed-order kernel at nc-AM's width 10,
   the pair path's composed forward) and "K4 f32 pieces" (phase 21's row)
   with their counts on the nc-AM training paths; then the routes line:
   every K1 and K4 launch of the run by route and lane piece
   (kernels.ROUTES), which must name only the fixed-order routes;
30. last line: {"ok": true, "device": {...}}.

Needs CUDA (exits 1 without it) and the repository around it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "rgcn", "nc-AIFB.yaml")
LP_CONFIG = os.path.join(ROOT, "configs", "rgcn", "lp-WN18.yaml")
FB_CONFIG = os.path.join(ROOT, "configs", "rgcn", "lp-FB-toy.yaml")
MUTAG_CONFIG = os.path.join(ROOT, "configs", "rgcn", "nc-MUTAG.yaml")
BGS_CONFIG = os.path.join(ROOT, "configs", "rgcn", "nc-BGS.yaml")
AM_CONFIG = os.path.join(ROOT, "configs", "rgcn", "nc-AM.yaml")
C_WN18_CONFIG = os.path.join(ROOT, "configs", "c-rgcn", "lp-WN18.yaml")
C_FB_CONFIG = os.path.join(ROOT, "configs", "c-rgcn", "lp-FB-toy.yaml")
E_AIFB_CONFIG = os.path.join(ROOT, "configs", "e-rgcn", "nc-AIFB.yaml")
E_AM_CONFIG = os.path.join(ROOT, "configs", "e-rgcn", "nc-AM.yaml")

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, f32
# CUDA-core FLOP/s (the kernels' f32 work, and the products of bf16 values
# summed in f32 on CUDA cores), bf16 tensor-core FLOP/s (K3's bf16 form)
# and TF32 tensor-core FLOP/s (K3's tiled route: three passes of f32
# operands, two of f32 x with a bf16 W, whose low part is zero)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_TF32_TC_FLOPS = 495e12

TIMING_ITERS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = TIMING_ITERS, warmup: int = 5, tries: int = 12) -> float:
    """Summed device time of the kernels ``fn()`` launches, per call, from
    torch.profiler over ``iters`` calls (host launch cost excluded), by
    ``utils/profiling.device_split``: a profile that lost records is taken
    again over half as many calls (on an H100 one plain version's profiles
    lost records five times running), down to one call, up to ``tries``
    times; then the run fails. A reading from a retaken profile is logged
    with the number of calls it rests on."""
    from rgcn_tpu_torch.utils.profiling import device_split

    def retaken(attempt, calls, lost, us):
        log(f"  profile {attempt} of {tries} ({calls} calls) lost records ({lost} "
            f"launches without a kernel record, {us:.1f} us of device time): taken again")

    try:
        split = device_split(fn, iters, warmup, tries, retaken)
    except RuntimeError as e:
        fail(str(e))
    if split["calls"] < iters:
        log(f"  device ms {split['ms']:.5f} from a retaken profile of {split['calls']} calls")
    return split["ms"]


def timed(fn) -> tuple:
    """(device ms per call, CUDA-event ms per back-to-back call)."""
    return device_ms(fn), cuda_ms(fn)


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor,
                floor: float = 1.0) -> float:
    """Max abs error, held to 1e-5 * max(floor, max|ref|); ``floor=0``
    makes the tolerance relative to the output alone."""
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != plain {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - ref).abs().max().item() if got.numel() else 0.0
    tol = 1e-5 * max(floor, ref.abs().max().item() if ref.numel() else 0.0)
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        fail(f"{name}: max abs err {err} > {tol}")
    return err


def check_rounded(name: str, got: torch.Tensor, ref: torch.Tensor,
                  abs_sum: torch.Tensor) -> float:
    """An f32 sum of bf16-rounded messages (K2's bf16 form) against its
    plain version: a message whose two f32 sums straddle a bf16 rounding
    boundary may round to the neighbouring value, so 2^-8 * ``abs_sum``
    (the plain sums of the messages' magnitudes) more than
    :func:`check_close`'s bound. Returns the max abs error."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{name}: {tuple(got.shape)} (finite {bool(torch.isfinite(got).all())}) "
             f"against {tuple(ref.shape)}")
    err_t = (got - ref).abs()
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    err = err_t.max().item() if got.numel() else 0.0
    log(f"  {name}: max_abs_err {err:.3e} (tol 2^-8 sum|msg| + {tol:.3e})")
    if not bool((err_t <= 2.0 ** -8 * abs_sum + tol).all()):
        fail(f"{name}: differs from its plain version past 2^-8 sum|msg| + {tol}")
    return err


# --------------------------------------------------------------------------


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_environment():
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} (count {torch.cuda.device_count()})")
    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return name


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from rgcn_tpu_torch import native
    from rgcn_tpu_torch.kernels.build import build_all

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(native.build_all)  # g++, beside nvcc
        built = build_all()
        try:
            host_built = host.result()
        except RuntimeError as e:
            fail(str(e))
    log(f"build: {len(built)} kernels and {len(host_built)} host libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for lname, info in host_built.items():
        log(f"  {lname}: {'cached' if info['cached'] else 'built'} "
            f"{os.path.basename(info['path'])} ({info['seconds']:.1f} s)")
    for kname, info in built.items():
        # ptxas -v: one "Used N registers" and one spill line per entry point
        regs = [int(w[w.index("Used") + 1]) for w in
                (ln.split() for ln in info["log"].splitlines()) if "registers," in w]
        spill = sum(int(w[w.index("spill") - 2]) for w in
                    (ln.split() for ln in info["log"].splitlines()) if "spill" in w)
        report = (f"{len(regs)} entry points, {min(regs)}-{max(regs)} registers, "
                  f"{spill} bytes of spill stores" if regs else "no ptxas report")
        log(f"  {kname}: {'cached' if info['cached'] else 'built'}, {report}")


def phase_kernels(dev, data, edges):
    """Each kernel at the nc-AIFB shapes against its plain version."""
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import fused as fz
    from rgcn_tpu_torch.ops import rel_spmm as rs

    rng = np.random.default_rng(0)
    n = data.num_nodes
    hidden, classes = 16, data.num_classes
    r_gen = edges.num_rels
    e_pad = edges.src.shape[0]
    lay, fl = edges.layout, edges.fused

    def rand(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    rows = []
    log("kernels (nc-AIFB shapes):")

    # K1 -- layer 1: edge-order messages (E_pad, hidden) through perm
    msgs = rand(e_pad, hidden) * edges.val[:, None]
    ref = agg.aggregate_sorted_plain(msgs, lay, n)
    got = agg.aggregate_sorted(msgs, lay, n)
    torch.cuda.synchronize()
    err = check_close("K1 aggregate_sorted", got, ref)
    msgs_sorted = torch.cat([msgs, msgs.new_zeros((1, hidden))])[lay.perm.long()]
    check_close("K1 aggregate_presorted",
                agg.aggregate_presorted(msgs_sorted, lay, n),
                agg.aggregate_presorted_plain(msgs_sorted, lay, n))
    dst_long = edges.dst.long()
    # the function needs each real slot's local_dst, perm index and message
    # row (pads, local_dst == RB, contribute nothing), chunk_block, and the
    # output written once
    real_slots = int((lay.local_dst < lay.row_block).sum().item())

    def k1_row(label, m, err):
        dout = m.shape[1]
        zeros = torch.zeros((n + 1, dout), device=dev)
        k1_bytes = real_slots * (dout * 4 + 4 + 4) + nbytes(lay.chunk_block) \
            + n * dout * 4
        ms, call = timed(lambda: agg.aggregate_sorted(m, lay, n))
        plain_ms, plain_call = timed(lambda: agg.aggregate_sorted_plain(m, lay, n))
        lib_ms, lib_call = timed(lambda: torch.index_add(zeros, 0, dst_long, m))
        return dict(
            name="K1", mode=label, route="cuda",
            source="rgcn_tpu_torch/kernels/csrc/k1_aggregate.cu",
            replaces="rgcn_tpu/ops/pallas_aggregate.py:203",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
            _bound=bound_ms(k1_bytes, real_slots * dout),
        )

    rows.append(k1_row(f"K1 dout {hidden} (layer 1)", msgs, err))
    # K1 at the K3 branch's layer-2 width: edge-order messages (E_pad, C)
    msgs_c = rand(e_pad, classes) * edges.val[:, None]
    err = check_close(f"K1 aggregate_sorted dout {classes}",
                      agg.aggregate_sorted(msgs_c, lay, n),
                      agg.aggregate_sorted_plain(msgs_c, lay, n))
    modes = [k1_row(f"K1 dout {classes} (K3 branch layer 2)", msgs_c, err)]

    # K2 -- layer 2: x (N, hidden) through W (R, hidden, classes)
    x = torch.relu(rand(n, hidden))
    w = rand(r_gen, hidden, classes, scale=0.3)
    if not rs.fused_fits(w, fl.row_block):
        fail("K2: nc-AIFB weights do not fit the shared-memory budget")
    ref = fz.rel_spmm_fused_plain(fl, n, x, w)
    got = fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None)
    torch.cuda.synchronize()
    err = check_close("K2 rel_spmm_fused", got, ref)
    # the function needs quantum_rel and chunk_block whole; local_dst, src
    # and val of the real slots (not a pad, not in a gap quantum); the x
    # rows and W[rel] those slots reference, once each; the output once
    keep = (fl.local_dst.reshape(-1) < fl.row_block) \
        & (fl.quantum_rel.repeat_interleave(fl.quantum) >= 0)
    real = int(keep.sum().item())
    x_rows = int(torch.unique(fl.src[keep]).numel())
    w_rels = int(torch.unique(fl.quantum_rel[fl.quantum_rel >= 0]).numel())
    k2_bytes = real * 12 + (x_rows + w_rels * classes) * hidden * 4 \
        + nbytes(fl.quantum_rel, fl.chunk_block) + n * classes * 4
    ms, call = timed(lambda: fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None))
    plain_ms, plain_call = timed(lambda: fz.rel_spmm_fused_plain(fl, n, x, w))
    rows.append(dict(
        name="K2", route="cuda",
        source="rgcn_tpu_torch/kernels/csrc/k2_fused.cu",
        replaces="rgcn_tpu/ops/pallas_fused.py:355",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        call_ms=call, plain_call_ms=plain_call, library_call_ms=None,
        _bound=bound_ms(k2_bytes, real * (2 * hidden * classes + 2 * classes)),
    ))

    # K3 -- layer 2's fallback branch: per-tile messages in edge order
    ref = rs.rel_spmm_messages_plain(edges, x, w)
    got = rs.rel_spmm_messages(edges, x, w)
    torch.cuda.synchronize()
    err = check_close("K3 rel_spmm_messages", got, ref)
    k3_bytes = nbytes(x, w, edges.src, edges.val, edges.tile_rel) \
        + e_pad * classes * 4
    ms, call = timed(lambda: rs.rel_spmm_messages(edges, x, w))
    plain_ms, plain_call = timed(lambda: rs.rel_spmm_messages_plain(edges, x, w))
    real = int((edges.val != 0).sum().item())
    modes.append(dict(
        name="K3", mode="K3 nc-AIFB (K3 branch layer 2, small route)", route="cuda",
        source="rgcn_tpu_torch/kernels/csrc/k3_messages.cu",
        replaces="rgcn_tpu/ops/pallas_spmm.py:70",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        call_ms=call, plain_call_ms=plain_call, library_call_ms=None,
        _bound=bound_ms(k3_bytes, real * (2 * hidden * classes + classes)),
    ))
    for r in rows + modes:
        r["bound_ms"], r["bound_by"] = r.pop("_bound")
        log(json.dumps({"kernel_check": r}))
    return rows, modes


def phase_skew(dev):
    """K1, K2, K4 and K5 on a hub graph against their plain versions: one
    destination with more than four chunks' worth of slots, row blocks of
    pad chunks only (K4 and K5 into memory that held NaN: the rows no slot
    reaches must come out 0 without a memset)."""
    from rgcn_tpu_torch.data.synthetic import skew_triples
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import basis as bs
    from rgcn_tpu_torch.ops import fused as fz

    n = 1536
    es = build_edge_set(skew_triples(), n, 4, with_dst_layout=True).to(dev)
    lay, fl = es.layout, es.fused
    hub_slots = int((es.dst == 7).sum().item())
    k1_hub = int((lay.chunk_block == 0).sum().item())
    k2_hub = int((fl.chunk_block == 0).sum().item())
    pad_chunks = int((lay.local_dst >= lay.row_block).all(1).sum().item())
    gap_chunks = int((fl.quantum_rel.reshape(fl.num_chunks, -1) < 0).all(1).sum().item())
    log(f"kernels (hub graph: N {n}, hub receives {hub_slots} slots; K1 hub "
        f"block {k1_hub} chunks of {lay.chunk}, {pad_chunks} pad-only chunks; "
        f"K2 hub block {k2_hub} chunks of {fl.chunk}, {gap_chunks} all-gap chunks):")
    if not (hub_slots > 4 * fl.chunk and pad_chunks and gap_chunks):
        fail("hub graph: no hub past four chunks, or no pad-only block")
    rng = np.random.default_rng(4)

    def rand(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    for dout in (16, 4, 400, 440):  # 400, 440: the pair path's dT widths
        m = rand(es.src.shape[0], dout)
        check_close(f"K1 hub aggregate_sorted dout {dout}",
                    agg.aggregate_sorted(m, lay, n),
                    agg.aggregate_sorted_plain(m, lay, n))
    x, w = torch.relu(rand(n, 16)), rand(8, 16, 4, scale=0.3)
    check_close("K2 hub rel_spmm_fused", fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None),
                fz.rel_spmm_fused_plain(fl, n, x, w))

    # K4 (merged frame) and K5 (its dedup frame) at lp-WN18's width and bases
    m = build_merged_layout(es.dst.cpu().numpy(), es.src.cpu().numpy(),
                            es.rel.cpu().numpy(), es.val.cpu().numpy(), n,
                            es.num_rels, dedup_k=2).to(dev)
    lay, dd = m.layout, m.fwd_dedup
    hub4 = int((lay.chunk_block == 0).sum().item())
    hub5 = int((dd.chunk_block == 0).sum().item())
    log(f"  K4 hub block {hub4} chunks of {lay.chunk}, K5 hub block {hub5} chunks")
    if not (hub4 > 4 and hub5 > 4):
        fail("hub graph: the merged or dedup frame has no hub past four chunks")
    x, comps = torch.relu(rand(n, 200)), rand(es.num_rels, 2, scale=0.3)
    wv = bs.merged_wvec(m.coeff, comps)
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    for label, call, plain in (
        ("K4 hub merged", lambda: bs.weighted_aggregate(x, m.src_sorted, wv, lay, n),
         lambda: bs.weighted_aggregate_plain(x, m.src_sorted, wv, lay, n)),
        ("K5 hub dedup", lambda: bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, n),
         lambda: bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, n)),
    ):
        junk = torch.full((n, 2, 200), float("nan"), device=dev)
        del junk  # the caching allocator hands this memory to the output
        got = call()
        if not got.permute(1, 0, 2).is_contiguous():
            fail(f"{label}: the output is not a view of node-major storage")
        ref = plain()
        check_close(label, got, ref)
        if not bool((got[:, 512:1024] == 0).all()):
            fail(f"{label}: the isolated nodes' rows are not 0")


def launches(**counts) -> dict:
    """Expected launch counts: the named kernels, every other kernel 0."""
    from rgcn_tpu_torch.kernels.build import SOURCES

    return {name: counts.get(name, 0) for name in SOURCES}


# launches per path: one serving forward (the server runs it at load)
MAIN_PATH = dict(k1_aggregate=1, k2_fused=1)
K3_BRANCH = dict(k1_aggregate=2, k3_messages=1)
LP_MAIN = dict(k4_weighted_aggregate=1)
LP_DEDUP = dict(k5_weighted_aggregate_dedup=1)
FB_PATH = dict(k3_messages=1, k1_aggregate=1)
NC_BASIS_PATH = dict(k1_aggregate=1, k2_fused=1)  # nc-MUTAG, nc-BGS stand-ins
NC_FEW_BASES = dict(k4_weighted_aggregate=2)
# nc-AM at AM scale: layer 1 K1; layer 2's W (532, 10, 11) with a (512, 11)
# accumulator is past fused_fits' budget, so K3 then K1 (K2 there is the
# slower route: phase 10 times both)
AM_PATH = dict(k1_aggregate=2, k3_messages=1)


def data_digest(triples) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(triples, dtype=np.int64)).hexdigest()


def serve_path(label, build, requests, expect):
    """Zero the launch counts, build a server (its one forward) and answer
    the requests, read the counts; they must equal ``expect``."""
    from rgcn_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    srv = build()
    answers = [srv.classify(q) for q in requests]
    probs = srv.probabilities(requests[0])
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"serving [{label}]: build + forward + requests "
        f"{time.perf_counter() - t0:.2f} s, launches {counts}")
    if counts != launches(**expect):
        fail(f"serving [{label}]: launches {counts}, expected {launches(**expect)}")
    if not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
        fail(f"serving [{label}]: probabilities do not sum to 1")
    return srv, answers, counts


def phase_serving(dev, data):
    from rgcn_tpu_torch.serve import NodeClassificationServer, load_nc_server

    requests = nc_requests(data)
    srv, answers, main = serve_path(
        "main: fused layout", lambda: load_nc_server(CONFIG, data, device=dev),
        requests, MAIN_PATH)
    # the same model over the EdgeSet without its fused layout: K3 + K1
    fallback, fallback_answers, branch = serve_path(
        "K3 + K1 branch",
        lambda: NodeClassificationServer(
            srv.model, dataclasses.replace(srv.edges, fused=None)),
        requests, K3_BRANCH)

    n, c = data.num_nodes, data.num_classes
    for s in (srv, fallback):
        if s.logits.shape != (n, c) or not np.isfinite(s.logits).all():
            fail(f"serving: logits {s.logits.shape} not finite (N, C) = {(n, c)}")

    state = {k: v.detach().cpu() for k, v in srv.model.state_dict().items()}
    cpu = load_nc_server(CONFIG, data, state, device="cpu")
    diff = float(np.abs(srv.logits - cpu.logits).max())
    diff_fb = float(np.abs(fallback.logits - cpu.logits).max())
    log(f"  logits vs CPU plain: max abs diff {diff:.3e} (fused), "
        f"{diff_fb:.3e} (K3+K1)")
    if diff > 1e-4 or diff_fb > 1e-4:
        fail("serving: logits differ from the CPU plain versions beyond 1e-4")
    for q, a, b in zip(requests, answers, fallback_answers):
        want = cpu.classify(q)
        if not (np.array_equal(a, want) and np.array_equal(b, want)):
            fail(f"serving: classes {a} / {b} != CPU {want}")
    log(f"  classify: {[a.tolist() for a in answers]}")
    agree = float((srv.logits.argmax(-1) == cpu.logits.argmax(-1)).mean())
    log(f"  argmax agreement over all {n} nodes: {agree:.6f}")

    fwd_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.refresh()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"  serve forward (host clock, logits to host): median "
        f"{sorted(fwd_ms)[10]:.3f} ms over 20")
    served = {"logits": srv.logits, "answers": answers, "data": data_digest(data.triples)}
    return {"main": main, "k3_k1_branch": branch}, served


TRAIN_EPOCHS = 5


def train_main_path(epochs: int) -> dict:
    """Launches of training nc-AIFB for ``epochs`` (fused layouts): per
    epoch the train forward (K1 layer 1, K2 layer 2), the backward (K2 over
    edges.reverse for layer 2's dx; K1's backward and layer 1's weight
    gradient are a gather and a scatter, no kernel) and the eval forward
    (K1, K2); then the final prediction's forward (K1, K2)."""
    return dict(k1_aggregate=2 * epochs + 1, k2_fused=3 * epochs + 1)


def train_k3_branch(epochs: int) -> dict:
    """The same without fused layouts: layer 2's forward and its dx are K3
    then K1 each, so K1 runs 1 + 1 (train forward) + 1 (dx) + 2 (eval) a
    epoch and K3 3, plus one more forward."""
    return dict(k1_aggregate=5 * epochs + 2, k3_messages=3 * epochs + 1)


def without_fused(es):
    """The EdgeSet with its and its reverse's fused layouts dropped."""
    return dataclasses.replace(es, fused=None,
                               reverse=dataclasses.replace(es.reverse, fused=None))


def records_logger():
    """A ScalarLogger that keeps the (metric, step, value) records."""
    from rgcn_tpu_torch.utils.logging import ScalarLogger

    class Records(ScalarLogger):
        def __init__(self):
            super().__init__(verbose=False)
            self.records = []

        def log_scalar(self, metric, value, step=None):
            self.records.append((metric, step, float(value)))

    return Records()


def top_kernels(kernels_us: dict, n: int) -> dict:
    """The ``n`` largest device times by kernel name cut to 80 characters
    (names that share their first 80 are summed)."""
    cut: dict = {}
    for name, us in kernels_us.items():
        cut[name[:80]] = cut.get(name[:80], 0.0) + us
    return dict(sorted(cut.items(), key=lambda kv: -kv[1])[:n])


def check_train_against_cpu(label, got, ref, logits, ref_logits, diagnose=None):
    """Records equal in name and step, losses within rtol 1e-4, accuracies
    equal; final logits within 1e-4 * max(1, max|ref|). ``diagnose``: a
    callable whose line is logged before a failure of the logits gate
    (which of the trajectory and the kernels moved)."""
    if [r[:2] for r in got] != [r[:2] for r in ref]:
        fail(f"training [{label}]: records {[r[:2] for r in got]} != CPU's")
    worst = 0.0
    for (metric, step, v), (_, _, w) in zip(got, ref):
        if metric == "training.loss":
            worst = max(worst, abs(v - w) / abs(w))
            if not abs(v - w) <= 1e-4 * abs(w):
                fail(f"training [{label}]: epoch {step} loss {v} != CPU {w} (rtol 1e-4)")
        elif v != w:
            fail(f"training [{label}]: {metric} at epoch {step}: {v} != CPU {w}")
    diff = (logits.cpu() - ref_logits).abs().max().item()
    tol = 1e-4 * max(1.0, ref_logits.abs().max().item())
    log(f"  [{label}] losses vs CPU: max rel diff {worst:.3e}; accuracies equal; "
        f"final logits max abs diff {diff:.3e} (tol {tol:.3e})")
    if not diff <= tol:
        if diagnose is not None:
            log(f"  [{label}] {diagnose()}")
        fail(f"training [{label}]: final logits differ from the CPU beyond {tol}")
    return worst, diff


def diagnose_params(cfg, data, model, logits, ref_state) -> str:
    """For a failed final-logits gate: the card's logits against the CPU's
    plain forward of the card's own final parameters (the kernels), and
    the largest parameter difference from the CPU run (the trajectory)."""
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer

    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    own = NodeClassificationTrainer(cfg, data, init_params=state, device="cpu").logits()
    moved = {k: (v - ref_state[k]).abs().max().item() for k, v in state.items()}
    return (f"card logits vs the CPU forward of the card's own parameters: max abs "
            f"diff {(logits.cpu() - own).abs().max().item():.3e}; parameters vs "
            f"the CPU run's: {moved}")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(a.contiguous().view(bits), b.contiguous().view(bits)))


def check_repeat(label, first, logits, records, again, expect) -> dict:
    """The first card run trained again from the same initialisation
    (``again``, counts zeroed just before its fit): exactly the same
    launches, and records, final parameters and final logits bit-equal to
    the first run's (K1, K2 and the dense layer's dW sum in a fixed
    order)."""
    from rgcn_tpu_torch import kernels

    kernels.reset_launches()
    got = records_logger()
    again.fit(got)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    if counts != launches(**expect):
        fail(f"training [{label}] again: launches {counts}, expected {launches(**expect)}")
    state0, state1 = first.model.state_dict(), again.model.state_dict()
    differ = {k: (v - state1[k]).abs().max().item() for k, v in state0.items()
              if not same_bits(v, state1[k])}
    logits1 = again.logits()
    out = {"params_bit_equal": not differ, "logits_bit_equal": same_bits(logits, logits1),
           "records_equal": got.records == records}
    log(f"  [{label}] trained twice from the seed-0 initialisation: {json.dumps(out)}"
        + (f"; parameters that differ (max abs): {differ}" if differ else "")
        + ("" if out["logits_bit_equal"] else
           f"; logits max abs diff {(logits - logits1).abs().max().item():.3e}"))
    if not all(out.values()):
        fail(f"training [{label}]: two card runs from one initialisation differ")
    return out


def train_against_cpu(name, cfg, data, dev, runs, repeat_first=False):
    """Train ``cfg`` on ``data`` on the card and on the CPU's plain versions
    from the seed-0 initialisation. Every gradient after one backward must
    be within 1e-5 * max(1, max|ref|); then the CPU trains, and each of
    ``runs`` (key, label, ``edit`` of the EdgeSet, the launches expected)
    trains on the card with the counts zeroed just before it, held to
    exactly those launches and to the CPU's records and final logits
    (check_train_against_cpu). The first run reuses the trainer whose
    gradients were checked (it took no step); with ``repeat_first`` a fresh
    trainer runs it again, held bit-equal to it (check_repeat, under
    ``checks["<key>_repeat"]``). Returns (launches per key, the checks per
    key, the first run's trainer, that run's peak device GB)."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.models.node_classification import build_nc_model
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer

    init = build_nc_model(cfg, data, seed=0).state_dict()

    def trainer(device):
        return NodeClassificationTrainer(cfg, data, init_params=init, device=device)

    t0 = time.perf_counter()
    cpu, card = trainer("cpu"), trainer(dev)
    es, pi = card.edges, card.edges.pairs
    pairs = "" if pi is None else (
        f", {pi.num_pairs} pairs (U_pad {pi.pair_src.shape[0]}), grad_layout L "
        f"{pi.agg.grad_layout.perm.shape[0]}, src_layout L {pi.src_layout.perm.shape[0]}")
    log(f"training {name} ({cfg.training.epochs} epochs, seed-0 init): N "
        f"{data.num_nodes}, E_pad {es.src.shape[0]}, layout L {es.layout.perm.shape[0]}"
        f"{pairs} (set-up {time.perf_counter() - t0:.1f} s)")
    losses = []
    for t in (cpu, card):
        loss = t.loss()
        loss.backward()
        losses.append(loss.item())
    log(f"  first loss card {losses[1]:.7f}, CPU {losses[0]:.7f}")
    ref_grads = dict(cpu.model.named_parameters())
    for pname, p in card.model.named_parameters():
        check_close(f"[{name}] grad {pname}", p.grad.cpu(), ref_grads[pname].grad)

    t0 = time.perf_counter()
    ref = records_logger()
    cpu.fit(ref)
    ref_logits = cpu.logits()
    ref_state = cpu.model.state_dict()
    log(f"  CPU plain training {time.perf_counter() - t0:.1f} s; losses "
        f"{[round(r[2], 6) for r in ref.records if r[0] == 'training.loss']}; "
        f"accuracies (train, test) {[r[2] for r in ref.records if r[0] != 'training.loss']}")
    del cpu

    paths, checks, first, peak_gb = {}, {}, None, None
    for key, label, edit, expect in runs:
        t = card if first is None else trainer(dev)
        t.edges = edit(t.edges)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = records_logger()
        t.fit(got)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"training [{label}]: {cfg.training.epochs} epochs + final prediction "
            f"{time.perf_counter() - t0:.2f} s, launches {counts}, peak memory "
            f"{peak:.3f} GB")
        if counts != launches(**expect):
            fail(f"training [{label}]: launches {counts}, expected {launches(**expect)}")
        logits = t.logits()
        if tuple(logits.shape) != (data.num_nodes, data.num_classes) \
                or not torch.isfinite(logits).all():
            fail(f"training [{label}]: logits {tuple(logits.shape)} not finite (N, C)")
        if first is None and repeat_first:  # before the gate: a diagnosis either way
            again = trainer(dev)
            again.edges = edit(again.edges)
            checks[f"{key}_repeat"] = check_repeat(label, t, logits, got.records, again,
                                                   expect)
            del again
        checks[key] = check_train_against_cpu(
            label, got.records, ref.records, logits, ref_logits,
            diagnose=lambda: diagnose_params(cfg, data, t.model, logits, ref_state))
        paths[key] = counts
        if first is None:
            first, peak_gb = t, peak
    return paths, checks, first, peak_gb


def phase_train(dev, data, edges):
    """Train nc-AIFB on the card from the seed-0 initialisation, held
    against the same training on the CPU's plain versions; gradients after
    one backward; exact launch counts on both layer-2 routes; K2 and K3 at
    the dx shapes; the step's timing. Returns (launches per path, the mode
    rows, the timing line)."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.profile_serve import profile_train_step

    base = load_experiment(CONFIG)
    cfg = dataclasses.replace(base, training=dataclasses.replace(
        base.training, epochs=TRAIN_EPOCHS))
    paths, checks, main, _ = train_against_cpu("nc-AIFB", cfg, data, dev, (
        ("train_main", "main: fused layouts", lambda es: es,
         train_main_path(TRAIN_EPOCHS)),
        ("train_k3_k1_branch", "K3 + K1 branch", without_fused,
         train_k3_branch(TRAIN_EPOCHS)),
    ), repeat_first=True)
    repeat = checks.pop("train_main_repeat")
    modes = phase_dx_kernels(dev, data, edges, paths)
    prof = profile_train_step(main)
    timing = {
        "step_host_median": prof["step"]["host_ms"]["median"],
        "step_host_min": prof["step"]["host_ms"]["min"],
        "device_forward": prof["forward_us"] / 1e3,
        "device_backward": prof["backward_us"] / 1e3,
        "device_optimizer": prof["optimizer_us"] / 1e3,
        "device_step": prof["step_us"] / 1e3,
        "device_busy_share": prof["step"]["device_busy_share"],
        "step_kernels_us": top_kernels(prof["step"]["kernels_us"], 12),
        "step_host_ops_us": prof["step"]["host_ops_us"],
        "loss_max_rel_diff": {k: v[0] for k, v in checks.items()},
        "logits_max_abs_diff": {k: v[1] for k, v in checks.items()},
        "train_main_twice": repeat,
    }
    return paths, modes, timing


def phase_dx_kernels(dev, data, edges, paths):
    """K2 and K3 (small route) at the shape of layer 2's dx, over the
    reversed edges with Wᵀ, against their plain versions; timed as in
    phase 3."""
    from rgcn_tpu_torch.ops import fused as fz
    from rgcn_tpu_torch.ops import rel_spmm as rs

    rng = np.random.default_rng(7)
    n, hidden, classes = data.num_nodes, 16, data.num_classes
    rev = edges.reverse
    fl = rev.fused
    g = torch.from_numpy(rng.standard_normal((n, classes)).astype(np.float32)).to(dev)
    w_t = torch.from_numpy((rng.standard_normal((rev.num_rels, classes, hidden))
                            * 0.3).astype(np.float32)).to(dev)
    log(f"kernels (layer 2's dx: g {tuple(g.shape)}, Wᵀ {tuple(w_t.shape)} over "
        f"edges.reverse):")
    if not rs.fused_fits(w_t, fl.row_block):
        fail("K2 dx: Wᵀ does not fit the shared-memory budget")
    err = check_close("K2 rel_spmm_fused dx", fz.rel_spmm_fused(fl, n, g, w_t, compute_dtype=None),
                      fz.rel_spmm_fused_plain(fl, n, g, w_t))
    keep = (fl.local_dst.reshape(-1) < fl.row_block) \
        & (fl.quantum_rel.repeat_interleave(fl.quantum) >= 0)
    real = int(keep.sum().item())
    x_rows = int(torch.unique(fl.src[keep]).numel())
    w_rels = int(torch.unique(fl.quantum_rel[fl.quantum_rel >= 0]).numel())
    ms, call = timed(lambda: fz.rel_spmm_fused(fl, n, g, w_t, compute_dtype=None))
    plain_ms, plain_call = timed(lambda: fz.rel_spmm_fused_plain(fl, n, g, w_t))
    modes = [dict(
        name="K2", mode=f"K2 dx (din {classes}, dout {hidden}, edges.reverse.fused)",
        route="cuda", source="rgcn_tpu_torch/kernels/csrc/k2_fused.cu",
        replaces="rgcn_tpu/ops/pallas_fused.py:355", path="train_main",
        launches=paths["train_main"]["k2_fused"], dx_launches=TRAIN_EPOCHS,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        call_ms=call, plain_call_ms=plain_call, library_call_ms=None,
        _bound=bound_ms(real * 12 + (x_rows + w_rels * hidden) * classes * 4
                        + nbytes(fl.quantum_rel, fl.chunk_block) + n * hidden * 4,
                        real * (2 * classes * hidden + 2 * hidden)),
    )]

    err = check_close("K3 rel_spmm_messages dx (small route)",
                      rs.rel_spmm_messages(rev, g, w_t),
                      rs.rel_spmm_messages_plain(rev, g, w_t))
    real = int((rev.val != 0).sum().item())
    gg = g[rev.src.long()].reshape(rev.num_tiles, rev.tile_size, classes)
    wg = w_t[rev.tile_rel.long()]
    ms, call = timed(lambda: rs.rel_spmm_messages(rev, g, w_t))
    plain_ms, plain_call = timed(lambda: rs.rel_spmm_messages_plain(rev, g, w_t))
    lib_ms, lib_call = timed(lambda: torch.bmm(gg, wg))
    modes.append(dict(
        name="K3", mode=f"K3 dx (K3 branch, small route, din {classes}, dout {hidden})",
        route="cuda", source="rgcn_tpu_torch/kernels/csrc/k3_messages.cu",
        replaces="rgcn_tpu/ops/pallas_spmm.py:70", path="train_k3_k1_branch",
        launches=paths["train_k3_k1_branch"]["k3_messages"], dx_launches=TRAIN_EPOCHS,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
        library="torch.bmm over g[src] tiles and Wᵀ[tile_rel] gathered "
                "beforehand (TF32 off, gathers not timed)",
        _bound=bound_ms(nbytes(g, w_t, rev.src, rev.val, rev.tile_rel)
                        + rev.src.shape[0] * hidden * 4,
                        real * (2 * classes * hidden + hidden)),
    ))
    for r in modes:
        r["bound_ms"], r["bound_by"] = r.pop("_bound")
        log(json.dumps({"kernel_check": r}))
    return modes


def lp_csr(rows, cols, vals, shape):
    """CSR matrix of (row, col, value) entries (duplicates summed), the
    torch.sparse.mm yardstick's operand."""
    import warnings

    idx = torch.stack([rows, cols])
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, vals, shape).coalesce().to_sparse_csr()


def slot_nodes(layout, local):
    """Destination node of each slot of a DstLayout-like frame."""
    block = layout.chunk_block.long().repeat_interleave(layout.chunk)
    return block * layout.row_block + local.reshape(-1).long()


def phase_lp_kernels(dev, edges, dedup):
    """K4 (three modes) and K5 at the lp-WN18 shapes against their plain
    versions; returns (main-path rows for K4 and K5, extra K4 modes)."""
    from rgcn_tpu_torch.ops import basis as bs
    from rgcn_tpu_torch.profile_serve import profile_calls

    rng = np.random.default_rng(1)
    m = edges.merged
    n, din, nb = m.num_nodes, 200, 2

    def rand(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    x = torch.relu(rand(n, din))
    comps = rand(m.num_rels, nb, scale=0.3)
    rows = []
    log("kernels (lp-WN18 shapes):")

    def k4_row(label, table, src, w, layout, sum_bases, lib):
        ref = bs.weighted_aggregate_plain(table, src, w, layout, n,
                                          sum_bases=sum_bases)
        got = bs.weighted_aggregate(table, src, w, layout, n, sum_bases=sum_bases)
        torch.cuda.synchronize()
        err = check_close(label, got, ref)
        local = layout.local_dst.reshape(-1)
        keep = local < layout.row_block
        real = int(keep.sum().item())
        # real slots read src and their nb weights; the table rows they
        # reference are read once; local_dst and chunk_block for every slot
        n_rows = int(torch.unique(src[keep]).numel())
        tables = 1 if table.dim() == 2 else nb
        k_bytes = real * (4 + nb * 4) + nbytes(layout.local_dst, layout.chunk_block) \
            + tables * n_rows * din * 4 + got.numel() * 4
        a, operand = lib
        lib_out = torch.sparse.mm(a, operand)
        lib_err = (lib_out.reshape(got.shape) - ref).abs().max().item()
        log(f"  {label} torch.sparse.mm vs plain: max abs diff {lib_err:.3e}")
        ms, call = timed(lambda: bs.weighted_aggregate(table, src, w, layout, n,
                                                       sum_bases=sum_bases))
        plain_ms, plain_call = timed(lambda: bs.weighted_aggregate_plain(
            table, src, w, layout, n, sum_bases=sum_bases))
        lib_ms, lib_call = timed(lambda: torch.sparse.mm(a, operand))
        return dict(
            name="K4", mode=label, route="cuda",
            source="rgcn_tpu_torch/kernels/csrc/k4_weighted_aggregate.cu",
            replaces="rgcn_tpu/ops/pallas_basis.py:53",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
            _bound=bound_ms(k_bytes, 2 * nb * real * din),
        )

    # K4, main path: merged frame, shared (N, 200) rows
    lay = m.layout
    w = bs.merged_wvec(m.coeff, comps)
    keep = lay.local_dst.reshape(-1) < lay.row_block
    node, src_k = slot_nodes(lay, lay.local_dst)[keep], m.src_sorted.long()[keep]
    a = lp_csr(torch.cat([b * n + node for b in range(nb)]), src_k.repeat(nb),
               w[:, keep].reshape(-1), (nb * n, n))
    rows.append(k4_row("K4 merged", x, m.src_sorted, w, lay, False, (a, x)))

    # the encode's closing product over K4's node-major output: one GEMM,
    # against the einsum over a basis-major aggregate (the layout K4 wrote
    # before), which copies its operand first; device time per kernel
    agg = bs.weighted_aggregate(x, m.src_sorted, w, lay, n)
    bases = rand(nb, din, 200, scale=din ** -0.5)
    basis_major = agg.contiguous()
    check_close("closing product vs einsum", bs.closing_product(agg, bases),
                torch.einsum("bni,bio->no", basis_major, bases))
    log(json.dumps({"closing_product_us": {
        "node_major_gemm": profile_calls(lambda: bs.closing_product(agg, bases))["kernels_us"],
        "basis_major_einsum": profile_calls(
            lambda: torch.einsum("bni,bio->no", basis_major, bases))["kernels_us"],
    }}))

    # K4, per-basis (nb, N, 200) rows summed over bases
    xb = rand(nb, n, din)
    a = lp_csr(node.repeat(nb), torch.cat([b * n + src_k for b in range(nb)]),
               w[:, keep].reshape(-1), (n, nb * n))
    extra = [k4_row("K4 per-basis sum_bases", xb, m.src_sorted, w, lay, True,
                    (a, xb.reshape(nb * n, din)))]

    # K4 over the unmerged destination layout
    src_u, w_u = bs.sorted_inputs(edges, comps)
    lay_u = edges.layout
    keep_u = lay_u.local_dst.reshape(-1) < lay_u.row_block
    node_u = slot_nodes(lay_u, lay_u.local_dst)[keep_u]
    a = lp_csr(torch.cat([b * n + node_u for b in range(nb)]),
               src_u.long()[keep_u].repeat(nb), w_u[:, keep_u].reshape(-1),
               (nb * n, n))
    extra.append(k4_row("K4 unmerged", x, src_u, w_u, lay_u, False, (a, x)))

    # K5 over the source-dedup'd frame
    dd = dedup.fwd_dedup
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    ref = bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, n)
    got = bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, n)
    torch.cuda.synchronize()
    err = check_close("K5 dedup", got, ref)
    check_close("K5 dedup vs K4 merged plain", got,
                bs.weighted_aggregate_plain(x, m.src_sorted, w, lay, n))
    lanes = dd.local_k.reshape(dd.num_k, -1) < dd.row_block
    real_slots = lanes.any(0)
    n_lanes = int(lanes.sum().item())
    n_rows = int(torch.unique(dd.src_sorted[real_slots]).numel())
    k5_bytes = int(real_slots.sum().item()) * 4 + n_lanes * nb * 4 \
        + nbytes(dd.local_k, dd.chunk_block) + n_rows * din * 4 + got.numel() * 4
    lane_rows, lane_cols, lane_vals = [], [], []
    for k in range(dd.num_k):
        kp = lanes[k]
        nd = slot_nodes(dd, dd.local_k[k])[kp]
        for b in range(nb):
            lane_rows.append(b * n + nd)
            lane_cols.append(dd.src_sorted.long()[kp])
            lane_vals.append(w_k[k, b][kp])
    a = lp_csr(torch.cat(lane_rows), torch.cat(lane_cols), torch.cat(lane_vals),
               (nb * n, n))
    ms, call = timed(lambda: bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, n))
    plain_ms, plain_call = timed(lambda: bs.weighted_aggregate_dedup_plain(
        x, dd.src_sorted, w_k, dd, n))
    lib_ms, lib_call = timed(lambda: torch.sparse.mm(a, x))
    rows.append(dict(
        name="K5", mode="K5 dedup", route="cuda",
        source="rgcn_tpu_torch/kernels/csrc/k5_weighted_aggregate_dedup.cu",
        replaces="rgcn_tpu/ops/pallas_basis.py:188",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
        _bound=bound_ms(k5_bytes, 2 * nb * n_lanes * din),
    ))
    for r in rows + extra:
        r["bound_ms"], r["bound_by"] = r.pop("_bound")
        log(json.dumps({"kernel_check": r}))
    return rows, extra


def k3_needed_bytes(edges, x, w) -> int:
    """What K3 must move: the x rows and W[rel] matrices its rows with a
    non-zero value reference (rows with val 0 are zeros by contract), src,
    val and tile_rel, and every message row written once."""
    live = edges.val != 0
    live_tiles = live.reshape(edges.num_tiles, -1).any(1)
    n_rels = int(torch.unique(edges.tile_rel[live_tiles]).numel())
    n_rows = int(torch.unique(edges.src[live]).numel())
    _, din, dout = w.shape
    return (n_rels * din * dout + n_rows * din) * 4 \
        + nbytes(edges.src, edges.val, edges.tile_rel) + edges.src.shape[0] * dout * 4


def phase_fb_kernels(dev, edges):
    """K3 and K1 at the lp-FB-toy shapes against their plain versions;
    returns (the K3 row, the K1 dout-500 row)."""
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import rel_spmm as rs

    rng = np.random.default_rng(5)
    n, din, dout = edges.num_nodes, 500, 500
    lay, e_pad = edges.layout, edges.src.shape[0]

    def rand(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    log("kernels (lp-FB-toy shapes):")
    x = torch.relu(rand(n, din))
    w = rand(edges.num_rels, din, dout, scale=din ** -0.5)
    if rs.fused_fits(w, edges.fused.row_block):
        fail("K3: lp-FB-toy weights fit the fused budget; the path would take K2")
    ref = rs.rel_spmm_messages_plain(edges, x, w)
    got = rs.rel_spmm_messages(edges, x, w)
    torch.cuda.synchronize()
    err = check_close("K3 rel_spmm_messages (lp-FB-toy)", got, ref)
    real = int((edges.val != 0).sum().item())
    k3_bytes = k3_needed_bytes(edges, x, w)
    # the yardstick's operands, gathered before it is timed
    xg = x[edges.src.long()].reshape(edges.num_tiles, edges.tile_size, din)
    wg = w[edges.tile_rel.long()]
    lib = (torch.bmm(xg, wg).reshape(e_pad, dout) * edges.val[:, None] - ref).abs().max().item()
    log(f"  K3 torch.bmm yardstick (times val) vs plain: max abs diff {lib:.3e}")
    ms, call = timed(lambda: rs.rel_spmm_messages(edges, x, w))
    plain_ms, plain_call = timed(lambda: rs.rel_spmm_messages_plain(edges, x, w))
    lib_ms, lib_call = timed(lambda: torch.bmm(xg, wg))
    del wg
    k3 = dict(
        name="K3", mode="K3 lp-FB-toy (tiled route)", route="cuda",
        source="rgcn_tpu_torch/kernels/csrc/k3_messages.cu",
        replaces="rgcn_tpu/ops/pallas_spmm.py:70",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
        library="torch.bmm over x[src] tiles and W[tile_rel] gathered "
                "beforehand (TF32 off, gathers not timed)",
        real_rows=real, tiles=edges.num_tiles,
        _bound=bound_ms(k3_bytes, real * (2 * din * dout + dout), PEAK_TF32_TC_FLOPS / 3),
    )

    # K1 at dout 500: the encode's aggregation of K3's messages
    msgs = rand(e_pad, dout) * edges.val[:, None]
    err = check_close("K1 aggregate_sorted dout 500 (lp-FB-toy)",
                      agg.aggregate_sorted(msgs, lay, n),
                      agg.aggregate_sorted_plain(msgs, lay, n))
    real_slots = int((lay.local_dst < lay.row_block).sum().item())
    zeros = torch.zeros((n + 1, dout), device=dev)
    dst_long = edges.dst.long()
    ms, call = timed(lambda: agg.aggregate_sorted(msgs, lay, n))
    plain_ms, plain_call = timed(lambda: agg.aggregate_sorted_plain(msgs, lay, n))
    lib_ms, lib_call = timed(lambda: torch.index_add(zeros, 0, dst_long, msgs))
    k1 = dict(
        name="K1", mode=f"K1 dout {dout} (lp-FB-toy, {lay.num_chunks} chunks)",
        route="cuda", source="rgcn_tpu_torch/kernels/csrc/k1_aggregate.cu",
        replaces="rgcn_tpu/ops/pallas_aggregate.py:203",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
        _bound=bound_ms(real_slots * (dout * 4 + 4 + 4) + nbytes(lay.chunk_block)
                        + n * dout * 4, real_slots * dout),
    )
    for r in (k3, k1):
        r["bound_ms"], r["bound_by"] = r.pop("_bound")
        log(json.dumps({"kernel_check": r}))
    return k3, k1


def topk_agree(name, got, cpu_scores, cpu_ents, k):
    """Top-k entity sets equal the CPU's on rows where the CPU's k-th and
    (k+1)-th scores are more than 1e-4 apart; returns the rows checked."""
    clear = (cpu_scores[:, k - 1] - cpu_scores[:, k]) > 1e-4
    for i in np.flatnonzero(clear):
        if set(got[i].tolist()) != set(cpu_ents[i, :k].tolist()):
            fail(f"{name}: row {i} top-{k} {sorted(got[i])} != CPU "
                 f"{sorted(cpu_ents[i, :k])}")
    return int(clear.sum())


def host_ms(fn, iters=20):
    """Median host-clock ms of ``fn()``, each call ended by a synchronize."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def lp_requests(srv, data, k=10):
    """Point scores of 8 test triples, top-k tails of 32 (s, p) and heads of
    32 (p, o) test queries, one filtered top-k tail request."""
    test = np.asarray(data.test)
    sp, po = test[:32, :2], test[32:64, 1:]
    return (srv.score(test[:8]), srv.topk_tails(sp, k=k),
            srv.topk_heads(po, k=k), srv.topk_tails(sp, k=k, filtered=True))


def check_lp_against_cpu(label, srv, answers, cpu, data, k=10, scaled=False):
    """z and point scores within 1e-4 of the CPU plain run (``scaled``:
    within 1e-4 * max(1, max|ref|) each), top-k sets equal wherever the
    CPU's k-th and (k+1)-th scores are apart."""
    cpu_ans = lp_requests(cpu, data, k=k + 1)
    dz = float((srv.z.cpu() - cpu.z).abs().max())
    ds = float(np.abs(answers[0] - cpu_ans[0]).max())
    tz = 1e-4 * (max(1.0, float(cpu.z.abs().max())) if scaled else 1.0)
    ts = 1e-4 * (max(1.0, float(np.abs(cpu_ans[0]).max())) if scaled else 1.0)
    log(f"  [{label}] z vs CPU plain: max abs diff {dz:.3e} (tol {tz:.3e}); point "
        f"scores {ds:.3e} (tol {ts:.3e})")
    if not (dz <= tz and ds <= ts):
        fail(f"lp serving [{label}]: z or scores differ from the CPU beyond tolerance")
    checked = [topk_agree(f"lp {label} {what}", got[1], ref[0], ref[1], k)
               for what, got, ref in zip(("tails", "heads", "filtered tails"),
                                         answers[1:], cpu_ans[1:])]
    log(f"  [{label}] top-{k} sets equal the CPU's on {checked} of 32 rows "
        "each (rows with a k-th/(k+1)-th gap > 1e-4)")


def phase_fb_serving(dev, data):
    """lp-FB-toy served at full width through the block layer: exactly K3
    and K1 once for the one encode."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.serve import load_lp_server

    kernels.reset_launches()
    t0 = time.perf_counter()
    srv = load_lp_server(FB_CONFIG, data, device=dev)
    answers = lp_requests(srv, data)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"serving [lp-FB-toy: block, expanded]: build + encode + requests "
        f"{time.perf_counter() - t0:.2f} s, launches {counts}")
    if counts != launches(**FB_PATH):
        fail(f"serving [lp-FB-toy]: launches {counts}, expected {launches(**FB_PATH)}")
    z = srv.z
    if tuple(z.shape) != (data.num_nodes, 500) or not torch.isfinite(z).all():
        fail(f"serving [lp-FB-toy]: z {tuple(z.shape)} not finite (N, 500)")
    state = {key: v.detach().cpu() for key, v in srv.model.state_dict().items()}
    cpu = load_lp_server(FB_CONFIG, data, state, device="cpu")
    check_lp_against_cpu("lp-FB-toy", srv, answers, cpu, data)
    log(f"  scores: {[round(float(v), 6) for v in answers[0]]}")
    timing = {"encode_ms_fb_toy": host_ms(srv.refresh)}
    log(f"  lp-FB-toy timing (host clock, median of 20): {json.dumps(timing)}")
    return {"lp_fb_toy": counts}, timing


def phase_lp_serving(dev, data, dedup):
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.serve import LinkPredictionServer, load_lp_server

    k = 10

    def path(label, build, expect):
        kernels.reset_launches()
        t0 = time.perf_counter()
        srv = build()
        answers = lp_requests(srv, data, k=k)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        log(f"serving [{label}]: build + encode + requests "
            f"{time.perf_counter() - t0:.2f} s, launches {counts}")
        if counts != launches(**expect):
            fail(f"serving [{label}]: launches {counts}, expected {launches(**expect)}")
        z = srv.z
        if tuple(z.shape) != (data.num_nodes, 200) or not torch.isfinite(z).all():
            fail(f"serving [{label}]: z {tuple(z.shape)} not finite (N, 200)")
        return srv, answers, counts

    srv, main_ans, main = path(
        "lp main: merged frame", lambda: load_lp_server(LP_CONFIG, data, device=dev),
        LP_MAIN)
    if srv.edges.merged is None or srv.edges.merged.fwd_dedup is not None:
        fail("lp serving: the main path's EdgeSet has no plain merged layout")
    branch_edges = dataclasses.replace(srv.edges, merged=dedup)
    train = np.asarray(data.train, dtype=np.int64)
    dsrv, dedup_ans, branch = path(
        "lp dedup branch",
        lambda: LinkPredictionServer(srv.model, branch_edges, known_triples=train),
        LP_DEDUP)

    state = {key: v.detach().cpu() for key, v in srv.model.state_dict().items()}
    cpu = load_lp_server(LP_CONFIG, data, state, device="cpu")
    for label, s, ans in (("merged", srv, main_ans), ("dedup", dsrv, dedup_ans)):
        check_lp_against_cpu(label, s, ans, cpu, data, k=k)
    log(f"  scores: {[round(float(v), 6) for v in main_ans[0]]}")
    served = {"z": srv.z.cpu(), "answers": lp_requests(srv, data, k=k + 1),
              "data": data_digest(data.train)}

    big = np.asarray(train[np.random.default_rng(2).integers(0, len(train), 1024), :2])
    timing = {
        "encode_ms_main": host_ms(srv.refresh),
        "encode_ms_dedup": host_ms(dsrv.refresh),
        "topk_tails_1024_ms": host_ms(lambda: srv.topk_tails(big, k=k), iters=10),
    }
    log(f"  lp timing (host clock, medians): {json.dumps(timing)}")
    return {"lp_main": main, "lp_dedup_branch": branch}, timing, served


def nc_requests(data):
    """Three requests of 8 test nodes."""
    test_ids = [data.n2i[name] for name in list(data.test)[:24]]
    return [test_ids[i:i + 8] for i in range(0, 24, 8)]


def check_nc_against_cpu(label, srv, answers, requests, cfg, data):
    """Logits finite (N, C) and within 1e-4 * max(1, max|ref|) of the same
    parameters on the CPU plain path; classes equal on the requests."""
    from rgcn_tpu_torch.serve import load_nc_server

    n, c = data.num_nodes, data.num_classes
    if srv.logits.shape != (n, c) or not np.isfinite(srv.logits).all():
        fail(f"serving [{label}]: logits {srv.logits.shape} not finite (N, C) = {(n, c)}")
    state = {k: v.detach().cpu() for k, v in srv.model.state_dict().items()}
    t0 = time.perf_counter()
    cpu = load_nc_server(cfg, data, state, device="cpu")
    diff = float(np.abs(srv.logits - cpu.logits).max())
    tol = 1e-4 * max(1.0, float(np.abs(cpu.logits).max()))
    log(f"  [{label}] logits vs CPU plain: max abs diff {diff:.3e} (tol {tol:.3e}; "
        f"CPU run {time.perf_counter() - t0:.1f} s)")
    if not diff <= tol:
        fail(f"serving [{label}]: logits differ from the CPU plain run beyond {tol}")
    for q, a in zip(requests, answers):
        want = cpu.classify(q)
        if not np.array_equal(a, want):
            fail(f"serving [{label}]: classes {a} != CPU {want}")
    log(f"  [{label}] classify: {[a.tolist() for a in answers]}")
    return diff


def phase_nc_basis_serving(dev):
    """nc-MUTAG and nc-BGS on their stand-in graph (exactly K1 and K2 once),
    and the few-basis featureless branch on aifb_like() (exactly K4
    twice)."""
    from rgcn_tpu_torch.config import DecompositionConfig, load_experiment
    from rgcn_tpu_torch.data.synthetic import aifb_like, synthetic_nc_data
    from rgcn_tpu_torch.serve import load_nc_server

    paths = {}
    for key, path in (("nc_mutag", MUTAG_CONFIG), ("nc_bgs", BGS_CONFIG)):
        cfg = load_experiment(path)
        data = synthetic_nc_data(cfg.dataset.name)
        requests = nc_requests(data)
        srv, answers, paths[key] = serve_path(
            f"{key}: {cfg.rgcn.decomposition.num_bases} bases, stand-in graph "
            f"N {data.num_nodes}", lambda: load_nc_server(cfg, data, device=dev),
            requests, NC_BASIS_PATH)
        check_nc_against_cpu(key, srv, answers, requests, cfg, data)

    base = load_experiment(CONFIG)
    cfg = dataclasses.replace(base, rgcn=dataclasses.replace(
        base.rgcn, decomposition=DecompositionConfig("basis", num_bases=4)))
    data = aifb_like()
    requests = nc_requests(data)
    srv, answers, paths["nc_few_bases"] = serve_path(
        "nc few bases: nc-AIFB with 4 bases, aifb_like()",
        lambda: load_nc_server(cfg, data, device=dev), requests, NC_FEW_BASES)
    if srv.edges.merged is None:
        fail("nc few bases: the EdgeSet has no merged layout")
    check_nc_against_cpu("nc_few_bases", srv, answers, requests, cfg, data)
    return paths


def phase_am(dev, data):
    """nc-AM served at AM scale (``data``: am_like()) with its launch counts
    held, checked against the CPU plain run and timed; then its kernels at
    their shapes."""
    from rgcn_tpu_torch.serve import load_nc_server

    requests = nc_requests(data)
    srv, answers, counts = serve_path(
        "nc-AM at AM scale", lambda: load_nc_server(AM_CONFIG, data, device=dev),
        requests, AM_PATH)
    es = srv.edges
    log(f"  E_pad {es.src.shape[0]} ({es.num_tiles} tiles), layout L "
        f"{es.layout.perm.shape[0]} ({es.layout.num_chunks} chunks, "
        f"{es.layout.num_row_blocks} blocks), fused L {es.fused.src.shape[0]}")
    check_nc_against_cpu("nc_am", srv, answers, requests, AM_CONFIG, data)
    timing = {"forward_ms_nc_am": host_ms(srv.refresh)}
    log(f"  nc-AM timing (host clock, median of 20): {json.dumps(timing)}")
    modes = phase_am_kernels(dev, es, hidden=10, classes=data.num_classes)
    return {"nc_am": counts}, timing, modes


def phase_am_kernels(dev, edges, hidden, classes):
    """K1 (dout 10 and 11), K3 (small route) and K2 at nc-AM's shapes
    against their plain versions, and layer 2's two routes timed in turns;
    returns the mode rows."""
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import fused as fz
    from rgcn_tpu_torch.ops import rel_spmm as rs

    rng = np.random.default_rng(6)
    n, r_gen, e_pad = edges.num_nodes, edges.num_rels, edges.src.shape[0]
    lay, fl = edges.layout, edges.fused

    def rand(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    log("kernels (nc-AM shapes):")
    modes = []
    real_slots = int((lay.local_dst < lay.row_block).sum().item())
    dst_long = edges.dst.long()
    for dout, what in ((hidden, "layer 1"), (classes, "layer 2, K3 + K1 route")):
        m = rand(e_pad, dout) * edges.val[:, None]
        err = check_close(f"K1 aggregate_sorted dout {dout} (nc-AM {what})",
                          agg.aggregate_sorted(m, lay, n),
                          agg.aggregate_sorted_plain(m, lay, n))
        zeros = torch.zeros((n + 1, dout), device=dev)
        ms, call = timed(lambda: agg.aggregate_sorted(m, lay, n))
        plain_ms, plain_call = timed(lambda: agg.aggregate_sorted_plain(m, lay, n))
        lib_ms, lib_call = timed(lambda: torch.index_add(zeros, 0, dst_long, m))
        modes.append(dict(
            name="K1", mode=f"K1 dout {dout} (nc-AM {what}, scalar lanes)",
            route="cuda", source="rgcn_tpu_torch/kernels/csrc/k1_aggregate.cu",
            replaces="rgcn_tpu/ops/pallas_aggregate.py:203",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
            _bound=bound_ms(real_slots * (dout * 4 + 4 + 4) + nbytes(lay.chunk_block)
                            + n * dout * 4, real_slots * dout),
        ))

    x = torch.relu(rand(n, hidden))
    w = rand(r_gen, hidden, classes, scale=hidden ** -0.5)
    log(f"  layer 2 W {tuple(w.shape)}: fused_fits {rs.fused_fits(w, fl.row_block)}")
    # K3, small route
    ref = rs.rel_spmm_messages_plain(edges, x, w)
    err = check_close("K3 rel_spmm_messages (nc-AM, small route)",
                      rs.rel_spmm_messages(edges, x, w), ref)
    real = int((edges.val != 0).sum().item())
    xg = x[edges.src.long()].reshape(edges.num_tiles, edges.tile_size, hidden)
    wg = w[edges.tile_rel.long()]
    ms, call = timed(lambda: rs.rel_spmm_messages(edges, x, w))
    plain_ms, plain_call = timed(lambda: rs.rel_spmm_messages_plain(edges, x, w))
    lib_ms, lib_call = timed(lambda: torch.bmm(xg, wg))
    modes.append(dict(
        name="K3", mode="K3 nc-AM layer 2 (small route)", route="cuda",
        source="rgcn_tpu_torch/kernels/csrc/k3_messages.cu",
        replaces="rgcn_tpu/ops/pallas_spmm.py:70",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
        library="torch.bmm over x[src] tiles and W[tile_rel] gathered "
                "beforehand (TF32 off, gathers not timed)",
        _bound=bound_ms(nbytes(x, w, edges.src, edges.val, edges.tile_rel)
                        + e_pad * classes * 4, real * (2 * hidden * classes + classes)),
    ))
    del xg, wg

    # K2 over the fused layout
    ref = fz.rel_spmm_fused_plain(fl, n, x, w)
    err = check_close("K2 rel_spmm_fused (nc-AM layer 2)",
                      fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None), ref)
    keep = (fl.local_dst.reshape(-1) < fl.row_block) \
        & (fl.quantum_rel.repeat_interleave(fl.quantum) >= 0)
    real = int(keep.sum().item())
    x_rows = int(torch.unique(fl.src[keep]).numel())
    w_rels = int(torch.unique(fl.quantum_rel[fl.quantum_rel >= 0]).numel())
    ms, call = timed(lambda: fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None))
    plain_ms, plain_call = timed(lambda: fz.rel_spmm_fused_plain(fl, n, x, w))
    modes.append(dict(
        name="K2", mode=f"K2 nc-AM layer 2 (fused L {fl.src.shape[0]}, {real} real)",
        route="cuda", source="rgcn_tpu_torch/kernels/csrc/k2_fused.cu",
        replaces="rgcn_tpu/ops/pallas_fused.py:355",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        call_ms=call, plain_call_ms=plain_call, library_call_ms=None,
        _bound=bound_ms(real * 12 + (x_rows + w_rels * classes) * hidden * 4
                        + nbytes(fl.quantum_rel, fl.chunk_block) + n * classes * 4,
                        real * (2 * hidden * classes + 2 * classes)),
    ))

    # layer 2's two routes, each against the plain two-stage version, in turns
    ref = agg.aggregate_sorted_plain(rs.rel_spmm_messages_plain(edges, x, w), lay, n)
    routes = {"k2": lambda: fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None),
              "k3_k1": lambda: rs.rel_spmm_full(edges, lay, x, w)}
    for key, fn in routes.items():
        check_close(f"nc-AM layer 2 route {key} vs plain", fn(), ref)
    order = ("k2", "k3_k1", "k3_k1", "k2")
    times = [(key, timed(routes[key])) for key in order]
    log(json.dumps({"nc_am_layer2_routes": {
        "order": list(order),
        "device_ms": [t[1][0] for t in times],
        "call_ms": [t[1][1] for t in times],
    }}))
    for r in modes:
        r["bound_ms"], r["bound_by"] = r.pop("_bound")
        log(json.dumps({"kernel_check": r}))
    return modes


PAIR_EPOCHS = 4  # nc-MUTAG, nc-BGS on the stand-in
AM_EPOCHS = 2  # nc-AM at AM scale


def train_pair_path(epochs: int) -> dict:
    """Launches of training a many-basis config on the pair path for
    ``epochs``: per epoch the train forward (K1 once a layer over the
    composed pair layout), the backward (per layer K1 for the pair
    messages' gradient over grad_layout and K1 for the basis table's over
    src_layout) and the eval forward (K1 twice); then the final
    prediction's forward (K1 twice). No other kernel."""
    return dict(k1_aggregate=8 * epochs + 2)


def phase_train_pairs(dev, am_data):
    """nc-MUTAG and nc-BGS on the stand-in, nc-AM at AM scale: trained on
    the pair path and held against the CPU (train_against_cpu); then K1
    in the path's new modes at nc-AM's shapes and the AM-scale step's
    timing. Returns (launches per path, the mode rows, the timing)."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_nc_data
    from rgcn_tpu_torch.profile_serve import profile_train_step

    paths, checks, repeats = {}, {}, {}
    for key, path, epochs in (("train_nc_mutag", MUTAG_CONFIG, PAIR_EPOCHS),
                              ("train_nc_bgs", BGS_CONFIG, PAIR_EPOCHS),
                              ("train_nc_am", AM_CONFIG, AM_EPOCHS)):
        base = load_experiment(path)
        cfg = dataclasses.replace(base, training=dataclasses.replace(
            base.training, epochs=epochs))
        data = am_data if key == "train_nc_am" else synthetic_nc_data(cfg.dataset.name)
        got, check, card, peak_gb = train_against_cpu(
            key, cfg, data, dev, ((key, key, lambda es: es, train_pair_path(epochs)),),
            repeat_first=key == "train_nc_am")
        if card.edges.pairs is None or card.edges.pairs.agg is None:
            fail(f"training [{key}]: the trainer built no composed pair layout")
        paths.update(got)
        repeats.update({k: check.pop(k) for k in list(check) if k.endswith("_repeat")})
        checks.update(check)
    modes = phase_pair_kernels(dev, card, counts=paths["train_nc_am"])
    prof = profile_train_step(card)
    timing = {
        "config": "nc-AM at AM scale (am_like)",
        "step_host_median": prof["step"]["host_ms"]["median"],
        "step_host_min": prof["step"]["host_ms"]["min"],
        "device_forward": prof["forward_us"] / 1e3,
        "device_backward": prof["backward_us"] / 1e3,
        "device_optimizer": prof["optimizer_us"] / 1e3,
        "device_step": prof["step_us"] / 1e3,
        "device_busy_share": prof["step"]["device_busy_share"],
        "peak_memory_gb": peak_gb,
        "step_kernels_us": top_kernels(prof["step"]["kernels_us"], 16),
        "step_host_ops_us": prof["step"]["host_ops_us"],
        "loss_max_rel_diff": {k: v[0] for k, v in checks.items()},
        "logits_max_abs_diff": {k: v[1] for k, v in checks.items()},
        "train_nc_am_twice": repeats["train_nc_am_repeat"],
    }
    log(json.dumps({"train_nc_am_step": timing}))
    return paths, modes, timing


def phase_pair_kernels(dev, trainer, counts):
    """K1 in the pair path's modes at the shapes of ``trainer`` (nc-AM),
    against its plain version, timed with its bound and a torch.index_add
    yardstick: the composed forward (destination-sorted slot rows over the
    layout) at dout hidden and classes (10, 11), the pair messages'
    gradient over grad_layout (U_pad segments) at the same widths, the
    basis table's gradient over src_layout through its perm at dout
    nb*hidden and nb*classes (400, 440)."""
    from rgcn_tpu_torch.ops import aggregate as agg

    rng = np.random.default_rng(8)
    edges = trainer.edges
    n, pi = edges.num_nodes, edges.pairs
    u_pad = pi.pair_src.shape[0]
    lay, glay, slay = edges.layout, pi.agg.grad_layout, pi.src_layout
    nb, hidden, classes = trainer.model.rgc2.bases.shape
    ag = pi.agg
    # each slot's output row as index_add takes it (pad slots: one spare row)
    slot_dst = ag.slot_dst.long()
    grad_pair = torch.cat([ag.slot_pair, ag.slot_pair.new_tensor([u_pad])]
                          )[glay.perm.long()].long()
    epochs = AM_EPOCHS
    log(f"kernels (nc-AM pair path: U_pad {u_pad}, layout L {lay.perm.shape[0]}, "
        f"grad_layout L {glay.perm.shape[0]} ({glay.num_row_blocks} blocks of "
        f"{glay.row_block}), src_layout L {slay.perm.shape[0]} "
        f"({slay.num_row_blocks} blocks of {slay.row_block})):")

    def rand(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def zero_row(t):
        return torch.cat([t, t.new_zeros((1, t.shape[1]))])

    # the rows each mode sums, formed as the path forms them from random
    # pair messages (forward) or output gradients (backward)
    def slot_rows(dout):  # m_z[slot_pair] * slot_val
        return zero_row(rand(u_pad, dout))[ag.slot_pair.long()] * ag.slot_val[:, None]

    def grad_rows(dout):  # g_z[grad_dst] * grad_val
        return zero_row(rand(n, dout))[ag.grad_dst.long()] * ag.grad_val[:, None]

    def real(layout):
        return int((layout.local_dst < layout.row_block).sum().item())

    modes = []
    for label, layout, rows_n, dout, make, lib_idx, launched in (
        ("composed forward, layer 1", lay, n, hidden, slot_rows, slot_dst, 2 * epochs + 1),
        ("composed forward, layer 2", lay, n, classes, slot_rows, slot_dst, 2 * epochs + 1),
        ("d_m over grad_layout, layer 1", glay, u_pad, hidden, grad_rows, grad_pair, epochs),
        ("d_m over grad_layout, layer 2", glay, u_pad, classes, grad_rows, grad_pair, epochs),
        ("dT over src_layout, layer 1", slay, n, nb * hidden, None, pi.pair_src.long(),
         epochs),
        ("dT over src_layout, layer 2", slay, n, nb * classes, None, pi.pair_src.long(),
         epochs),
    ):
        perm = make is None
        if perm:  # the rows' cotangent (U_pad, dout), read through the perm
            m = rand(layout.num_edges, dout)

            def call(m=m, layout=layout, rows_n=rows_n):
                return agg.aggregate_sorted(m, layout, rows_n)

            def plain(m=m, layout=layout, rows_n=rows_n):
                return agg.aggregate_sorted_plain(m, layout, rows_n)
        else:  # destination-sorted slot rows
            m = make(dout)

            def call(m=m, layout=layout, rows_n=rows_n):
                return agg.aggregate_presorted(m, layout, rows_n)

            def plain(m=m, layout=layout, rows_n=rows_n):
                return agg.aggregate_presorted_plain(m, layout, rows_n)
        lib_rows = m
        err = check_close(f"K1 {label} (dout {dout})", call(), plain())
        zeros = torch.zeros((rows_n + 1, dout), device=dev)
        ms, call_ms = timed(call)
        plain_ms, plain_call = timed(plain)
        lib_ms, lib_call = timed(
            lambda z=zeros, i=lib_idx, r=lib_rows: torch.index_add(z, 0, i, r))
        r_slots = real(layout)
        # real slots' local_dst (and perm index) and message row,
        # chunk_block, the output once
        k_bytes = r_slots * (dout * 4 + 4 + (4 if perm else 0)) \
            + nbytes(layout.chunk_block) + rows_n * dout * 4
        modes.append(dict(
            name="K1", mode=f"K1 {label} (dout {dout}, {r_slots} real slots)",
            route="cuda", source="rgcn_tpu_torch/kernels/csrc/k1_aggregate.cu",
            replaces="rgcn_tpu/ops/pallas_aggregate.py:203", path="train_nc_am",
            launches=counts["k1_aggregate"], mode_launches=launched,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            call_ms=call_ms, plain_call_ms=plain_call, library_call_ms=lib_call,
            library="torch.index_add of the same rows by destination",
            _bound=bound_ms(k_bytes, r_slots * dout),
        ))
        del m, lib_rows, zeros
    for r in modes:
        r["bound_ms"], r["bound_by"] = r.pop("_bound")
        log(json.dumps({"kernel_check": r}))
    return modes


LP_TRAIN_EPOCHS = 2  # lp-WN18 and lp-FB-toy at full width, each trained twice


def train_lp_path(decomposition: str, epochs: int) -> dict:
    """Launches of training an LP config for ``epochs`` and its final
    evaluation (check_every is past ``epochs``, so one encode). A step:
    the encoder's forward and its dx over the reversed edges (basis: K4
    each; block: K3 then K1 each), the decoder's backward (K4 twice for
    the corrupted entities, K1 for the subjects' and the objects' rows).
    The evaluation encodes the whole graph once (basis: K4 over the
    merged frame; block: K3 then K1)."""
    if decomposition == "basis":
        return dict(k4_weighted_aggregate=4 * epochs + 1, k1_aggregate=2 * epochs)
    return dict(k3_messages=2 * epochs + 1, k1_aggregate=4 * epochs + 1,
                k4_weighted_aggregate=2 * epochs)


def rank_bands(trainer):
    """For each test rank of ``trainer``'s evaluation (heads, then tails):
    the band of ranks its model's scores allow when every candidate whose
    score is within 1e-4 * max(1, max|score|) of the true triple's (per
    query, filtered candidates out) may fall on either side: (lo, hi)."""
    model, filters = trainer.model, trainer.filters
    test = torch.as_tensor(trainer.test_np)
    n = trainer.num_nodes
    lo, hi = [], []
    with torch.no_grad():
        z = model.encode(trainer.eval_edges)
        for score_fn, filt, col in (
                (model.score_heads, None if filters is None else filters.heads, 0),
                (model.score_tails, None if filters is None else filters.tails, 2)):
            for at in range(0, len(test), 512):
                q = test[at:at + 512]
                sc = score_fn(q, z)
                if filt is not None:
                    sc = torch.cat([sc, sc.new_zeros((len(q), 1))], 1).scatter(
                        1, torch.as_tensor(filt[at:at + 512]).long(), float("-inf"))[:, :n]
                true = sc.gather(1, q[:, col:col + 1])
                tol = 1e-4 * sc.masked_fill(torch.isinf(sc), 0.0).abs().amax(
                    1, keepdim=True).clamp(min=1.0)
                lo.append((1 + (sc > true + tol).sum(1)).numpy())
                hi.append((sc >= true - tol).sum(1).numpy())
    return np.concatenate(lo), np.concatenate(hi)


def check_lp_repeat(key, cfg, data, dev, first, records, ranks, expect) -> dict:
    """An LP config trained again on the card from the same initialisation
    as ``first`` (a fresh trainer, the same one-backward gradient check
    before its fit, counts zeroed just before the fit): exactly the same
    launches, and records, final parameters and test ranks equal to the
    first run's bit for bit (K1 and K4 sum in a fixed order, the gradients'
    segment sums too)."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    t0 = time.perf_counter()
    again = LinkPredictionTrainer(cfg, data, device=dev, logger=records_logger())
    again.set_epoch(1)
    again.loss().backward()
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = records_logger()
    _, _, ranks1 = again.fit(got)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    if counts != expect:
        fail(f"training [{key}] again: launches {counts}, expected {expect}")
    state0, state1 = first.model.state_dict(), again.model.state_dict()
    differ = {k: (v - state1[k]).abs().max().item() for k, v in state0.items()
              if not same_bits(v, state1[k])}
    out = {"params_bit_equal": not differ, "records_equal": got.records == records,
           "ranks_equal": bool(np.array_equal(ranks, ranks1))}
    log(f"  [{key}] trained twice from the seed-0 initialisation "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(out)}"
        + (f"; parameters that differ (max abs): {differ}" if differ else "")
        + ("" if out["ranks_equal"] else
           f"; ranks equal {float(np.mean(ranks == ranks1)):.4%}"))
    if not all(out.values()):
        fail(f"training [{key}]: two card runs from one initialisation differ")
    return out


def lp_train_against_cpu(key, path, data, dev, epochs, expect=None, rank_band=False,
                         edit=None, repeat=False):
    """Train an LP config on the card and on the CPU's plain versions from
    the seed-0 initialisation and the same epoch schedule: every gradient
    after one backward within 1e-5 * max|ref| of its own parameter (the
    gradients of a mean over 300k scores are far below 1, so a floor of 1
    would pass a wrong backward); per-epoch loss
    within rtol 1e-4; the final filtered MRR within 1e-3 and at least 99%
    of the test ranks equal, over the whole test split (``rank_band``:
    instead, every test rank within the CPU model's rank_bands, and the
    share of equal ranks reported beside that of a second CPU run from the
    initialisation moved by 1e-7 relative); exactly ``expect``
    (default train_lp_path's launches), counts zeroed just before the
    card's run. ``edit``: a function of the loaded config, applied before
    the epochs are set (phase 21's branches). ``repeat``: before the
    gates against the CPU, the card trains again from the same
    initialisation and must repeat its launches, records, parameters and
    ranks bit for bit (check_lp_repeat, ``checks["repeat"]``).
    Returns (launches, checks, the card's trainer, its peak device GB)."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    base = load_experiment(path)
    if edit is not None:
        base = edit(base)
    cfg = dataclasses.replace(base, training=dataclasses.replace(
        base.training, epochs=epochs))
    quiet = records_logger()
    t0 = time.perf_counter()
    cpu = LinkPredictionTrainer(cfg, data, device="cpu", logger=quiet)
    init = ({k: v.clone() for k, v in cpu.model.state_dict().items()}
            if rank_band else None)
    card = LinkPredictionTrainer(cfg, data, device=dev, logger=quiet)
    losses = []
    for t in (cpu, card):
        t.set_epoch(1)
        loss = t.loss()
        loss.backward()
        losses.append(loss.item())
    b = card.batch
    scoring = (f"c_lay L {b.layouts[0].perm.shape[0]}, s_lay L "
               f"{b.layouts[1].perm.shape[0]}" if b.layouts is not None else
               f"assembled batch {tuple(b.batch.shape)}, s_lay L "
               f"{b.batch_layouts[0].perm.shape[0]}, o_lay L "
               f"{b.batch_layouts[1].perm.shape[0]}")
    log(f"training {key} ({epochs} epochs, seed-0 init): N {data.num_nodes}, P "
        f"{b.positives.shape[0]}, Ns {b.corrupt_ent.shape[0]}, E_pad "
        f"{b.edges.src.shape[0]} (layout L {b.edges.layout.perm.shape[0]}, row block "
        f"{b.edges.layout.row_block}), reverse E_pad {b.edges.reverse.src.shape[0]} "
        f"(L {b.edges.reverse.layout.perm.shape[0]}), {scoring} "
        f"(set-up {time.perf_counter() - t0:.1f} s)")
    log(f"  first loss card {losses[1]:.7f}, CPU {losses[0]:.7f}")
    ref_grads = dict(cpu.model.named_parameters())
    for pname, p in card.model.named_parameters():
        check_close(f"[{key}] grad {pname}", p.grad.cpu(), ref_grads[pname].grad,
                    floor=0.0)

    t0 = time.perf_counter()
    ref = records_logger()
    ref_mrr, ref_hits, ref_ranks = cpu.fit(ref)
    log(f"  CPU plain training {time.perf_counter() - t0:.1f} s; losses "
        f"{[round(r[2], 6) for r in ref.records if r[0] == 'training.loss']}; "
        f"MRR {ref_mrr:.6f}, Hits@1/3/10 {ref_hits}")
    bands = rank_bands(cpu) if rank_band else None
    del cpu
    if rank_band:
        # the f32 noise floor of exact rank equality: the CPU once more,
        # from the initialisation moved by 1e-7 relative
        rng = np.random.default_rng(17)
        moved = {k: v * (1.0 + 1e-7 * torch.from_numpy(
            rng.standard_normal(tuple(v.shape)).astype(np.float32)))
            for k, v in init.items()}
        t0 = time.perf_counter()
        twin = LinkPredictionTrainer(cfg, data, device="cpu", logger=quiet,
                                     init_state=moved)
        _, _, twin_ranks = twin.fit(records_logger())
        del twin
        twin_equal = float(np.mean(twin_ranks == ref_ranks))
        twin_in_band = float(np.mean((twin_ranks >= bands[0]) & (twin_ranks <= bands[1])))
        log(f"  [{key}] CPU run from the initialisation moved by 1e-7 relative "
            f"({time.perf_counter() - t0:.1f} s): {twin_equal:.4%} of ranks equal the "
            f"CPU's, {twin_in_band:.4%} within its score band")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = records_logger()
    mrr, hits, ranks = card.fit(got)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if expect is None:
        expect = launches(**train_lp_path(cfg.encoder.decomposition.type, epochs))
    log(f"training [{key}]: {epochs} epochs + final evaluation "
        f"{time.perf_counter() - t0:.2f} s, launches {counts}, peak memory "
        f"{peak:.3f} GB")
    if counts != expect:
        fail(f"training [{key}]: launches {counts}, expected {expect}")
    repeated = (check_lp_repeat(key, cfg, data, dev, card, got.records, ranks, expect)
                if repeat else None)
    if [r[:2] for r in got.records] != [r[:2] for r in ref.records]:
        fail(f"training [{key}]: records {[r[:2] for r in got.records]} != CPU's")
    worst = 0.0
    for (metric, step, v), (_, _, w) in zip(got.records, ref.records):
        if metric == "training.loss":
            worst = max(worst, abs(v - w) / abs(w))
            if not abs(v - w) <= 1e-4 * abs(w):
                fail(f"training [{key}]: epoch {step} loss {v} != CPU {w} (rtol 1e-4)")
    same = float(np.mean(ranks == ref_ranks))
    log(f"  [{key}] losses vs CPU: max rel diff {worst:.3e}; MRR {mrr:.6f} (CPU "
        f"{ref_mrr:.6f}), Hits@1/3/10 {hits} (CPU {ref_hits}); {same:.4%} of "
        f"{len(ranks)} ranks equal")
    checks = dict(loss_max_rel_diff=worst, mrr=mrr, cpu_mrr=ref_mrr, hits=hits,
                  cpu_hits=ref_hits, ranks_equal=same)
    if repeated is not None:
        checks["repeat"] = repeated
    if bands is not None:
        lo, hi = bands
        inside = float(np.mean((ranks >= lo) & (ranks <= hi)))
        checks.update(ranks_in_band=inside, band_width_median=float(np.median(hi - lo)),
                      cpu_twin_ranks_equal=twin_equal, cpu_twin_ranks_in_band=twin_in_band,
                      cpu_ranks_in_band=float(np.mean((ref_ranks >= lo)
                                                      & (ref_ranks <= hi))))
        log(f"  [{key}] ranks within the CPU's 1e-4 score band: {inside:.4%} (CPU's "
            f"own {checks['cpu_ranks_in_band']:.4%}; median band width "
            f"{checks['band_width_median']})")
        if not (abs(mrr - ref_mrr) <= 1e-3 and inside == 1.0 and np.isfinite(mrr)):
            fail(f"training [{key}]: MRR {mrr} vs CPU {ref_mrr} (tol 1e-3) or ranks "
                 f"within the CPU's score band {inside} < 1")
    elif not (abs(mrr - ref_mrr) <= 1e-3 and same >= 0.99 and np.isfinite(mrr)):
        fail(f"training [{key}]: MRR {mrr} vs CPU {ref_mrr} (tol 1e-3) or ranks "
             f"equal {same} < 0.99")
    return counts, checks, card, peak


def mode_row(name, label, call, plain, library, k_bytes, flops, ref=None,
             peak_flops=PEAK_F32_FLOPS, **meta):
    """Hold ``call()`` against ``plain()`` (or ``ref()``, the plain version
    on the same inputs in f64, where given) and time ``call``, ``plain``
    and the yardstick ``library`` as in phase 3, the bound's operations at
    ``peak_flops``; one kernel_check row."""
    source = {"K1": ("k1_aggregate.cu", "rgcn_tpu/ops/pallas_aggregate.py:203"),
              "K3": ("k3_messages.cu", "rgcn_tpu/ops/pallas_spmm.py:70"),
              "K4": ("k4_weighted_aggregate.cu", "rgcn_tpu/ops/pallas_basis.py:53")}[name]
    err = check_close(label, call(), plain() if ref is None else ref())
    ms, call_ms = timed(call)
    plain_ms, plain_call = timed(plain)
    lib_ms, lib_call = timed(library)
    bound, by = bound_ms(k_bytes, flops, peak_flops)
    row = dict(name=name, mode=label, route="cuda",
               source=f"rgcn_tpu_torch/kernels/csrc/{source[0]}", replaces=source[1],
               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound, bound_by=by, call_ms=call_ms, plain_call_ms=plain_call,
               library_call_ms=lib_call, **meta)
    log(json.dumps({"kernel_check": row}))
    return row


def real_slot_mask(layout):
    return layout.local_dst.reshape(-1) < layout.row_block


def lp_wn18_modes(dev, trainer, counts):
    """K4 and K1 in lp-WN18 training's new modes at its shapes (the last
    epoch's batch): K4 with the per-basis tables G and sum_bases over the
    reversed subgraph (dx), its two corrupted-entity terms over c_lay
    (Ns 300,000), K1 over s_lay and o_lay through their perm (P 30,000,
    d 200). Yardsticks: torch.sparse.mm of the same weighted sum, and
    torch.index_add of the same rows."""
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import basis as bs

    rng = np.random.default_rng(12)
    b, n = trainer.batch, trainer.num_nodes
    d = trainer.model.node_embeddings.shape[1]
    p_count, ns_total = b.positives.shape[0], b.corrupt_ent.shape[0]

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    meta = dict(path="train_lp_wn18")
    modes = []
    log("kernels (lp-WN18 training modes):")
    # dx: K4 over the reversed subgraph with per-basis tables, sum_bases
    rev = b.edges.reverse
    comps = trainer.model.rgc1.comps.detach()[:-1]
    nb = comps.shape[1]
    rsrc, rw = bs.sorted_inputs(rev, comps)
    g_tab = rand(nb, n, d)
    keep = real_slot_mask(rev.layout)
    node = slot_nodes(rev.layout, rev.layout.local_dst)[keep]
    a = lp_csr(node.repeat(nb), torch.cat([i * n + rsrc.long()[keep] for i in range(nb)]),
               rw[:, keep].reshape(-1), (n, nb * n))
    flat = g_tab.reshape(nb * n, d)
    real = int(keep.sum().item())
    n_rows = int(torch.unique(rsrc[keep]).numel())
    modes.append(mode_row(
        "K4", f"K4 per-basis sum_bases, dx over the reversed subgraph ({real} real slots)",
        lambda: bs.weighted_aggregate(g_tab, rsrc, rw, rev.layout, n, sum_bases=True),
        lambda: bs.weighted_aggregate_plain(g_tab, rsrc, rw, rev.layout, n, sum_bases=True),
        lambda: torch.sparse.mm(a, flat),
        real * (4 + nb * 4) + nbytes(rev.layout.local_dst, rev.layout.chunk_block)
        + nb * n_rows * d * 4 + n * d * 4, 2 * nb * real * d,
        launches=counts["k4_weighted_aggregate"], mode_launches=LP_TRAIN_EPOCHS, **meta))

    # the decoder's corrupted entities: two shared-table K4 sums over c_lay
    c_lay, s_lay, o_lay, (ce_sorted, qk_idx) = b.layouts
    z, rel = rand(n, d), rand(trainer.num_rels, d)
    pos = b.positives
    q, k = z[pos[:, 0]] * rel[pos[:, 1]], rel[pos[:, 1]] * z[pos[:, 2]]
    qk = torch.cat([q, k])
    perm = c_lay.perm.long()
    # O(1) weights: K4 is linear in w, and the step's own weights (~1e-6
    # after the mean over P + Ns scores) would sit below any useful tolerance
    ge = torch.cat([rand(ns_total), z.new_zeros(1)])[perm][None]
    pwz = torch.cat([rand(ns_total), z.new_zeros(1)])[perm][None]
    keep = real_slot_mask(c_lay)
    node = slot_nodes(c_lay, c_lay.local_dst)[keep]
    real = int(keep.sum().item())
    for label, table, src, w in (("[q ; k] term", qk, qk_idx, ge),
                                 ("nodes term", z, ce_sorted, pwz)):
        a_t = lp_csr(node, src.long()[keep], w[0, keep], (n, table.shape[0]))
        n_rows = int(torch.unique(src[keep]).numel())
        modes.append(mode_row(
            "K4", f"K4 corrupted entities, {label} over c_lay ({real} real slots)",
            lambda t=table, s=src, w=w: bs.weighted_aggregate(t, s, w, c_lay, n),
            lambda t=table, s=src, w=w: bs.weighted_aggregate_plain(t, s, w, c_lay, n),
            lambda a=a_t, t=table: torch.sparse.mm(a, t),
            real * 8 + nbytes(c_lay.local_dst, c_lay.chunk_block) + n_rows * d * 4
            + n * d * 4, 2 * real * d,
            launches=counts["k4_weighted_aggregate"], mode_launches=LP_TRAIN_EPOCHS,
            **meta))

    # the positives' subjects and objects: K1 through the layouts' perm
    zeros = torch.zeros((n, d), device=dev)
    for label, lay, col in (("s_lay", s_lay, 0), ("o_lay", o_lay, 2)):
        rows = rand(p_count, d)
        ids = pos[:, col]
        real = int(real_slot_mask(lay).sum().item())
        modes.append(mode_row(
            "K1", f"K1 {label} through perm (P {p_count}, d {d})",
            lambda r=rows, lay=lay: agg.aggregate_sorted(r, lay, n),
            lambda r=rows, lay=lay: agg.aggregate_sorted_plain(r, lay, n),
            lambda r=rows, i=ids: torch.index_add(zeros, 0, i, r),
            real * (d * 4 + 8) + nbytes(lay.chunk_block) + n * d * 4, real * d,
            launches=counts["k1_aggregate"], mode_launches=LP_TRAIN_EPOCHS, **meta))
    return modes


def lp_fb_modes(dev, trainer, counts):
    """K3 with Wᵀ and K1 at dout 500 over lp-FB-toy training's reversed
    subgraph (the block layer's dx), at the last epoch's batch; yardsticks
    one torch.bmm over pre-gathered tiles and torch.index_add."""
    from rgcn_tpu_torch.nn.layers import expand_blocks
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import rel_spmm as rs

    rng = np.random.default_rng(13)
    rev, n = trainer.batch.edges.reverse, trainer.num_nodes
    with torch.no_grad():
        wt = expand_blocks(trainer.model.rgc1.blocks).transpose(1, 2).contiguous()
    din, dout = wt.shape[1:]
    g = torch.from_numpy(rng.standard_normal((n, din)).astype(np.float32)).to(dev)
    meta = dict(path="train_lp_fb_toy")
    log("kernels (lp-FB-toy training modes):")
    real = int((rev.val != 0).sum().item())
    xg = g[rev.src.long().clamp_max(n - 1)].reshape(rev.num_tiles, rev.tile_size, din)
    wg = wt[rev.tile_rel.long()]
    k3 = mode_row(
        "K3", f"K3 dx, W^T over the reversed subgraph ({rev.num_tiles} tiles, {real} "
        "real rows)",
        lambda: rs.rel_spmm_messages(rev, g, wt),
        lambda: rs.rel_spmm_messages_plain(rev, g, wt),
        lambda: torch.bmm(xg, wg),
        k3_needed_bytes(rev, g, wt), real * (2 * din * dout + dout),
        peak_flops=PEAK_TF32_TC_FLOPS / 3,
        launches=counts["k3_messages"], mode_launches=LP_TRAIN_EPOCHS, **meta)
    del xg, wg
    msgs = rs.rel_spmm_messages(rev, g, wt)
    lay = rev.layout
    real = int(real_slot_mask(lay).sum().item())
    zeros = torch.zeros((n + 1, dout), device=dev)
    dst = rev.dst.long()
    k1 = mode_row(
        "K1", f"K1 dout {dout} over the reversed subgraph ({real} real slots)",
        lambda: agg.aggregate_sorted(msgs, lay, n),
        lambda: agg.aggregate_sorted_plain(msgs, lay, n),
        lambda: torch.index_add(zeros, 0, dst, msgs),
        real * (dout * 4 + 8) + nbytes(lay.chunk_block) + n * dout * 4, real * dout,
        launches=counts["k1_aggregate"], mode_launches=LP_TRAIN_EPOCHS, **meta)
    return [k3, k1]


def phase_train_lp(dev):
    """lp-WN18 (wn18_like) and lp-FB-toy (fb_toy_like) trained at full width
    on the card against the CPU (lp_train_against_cpu), each path with its
    counts zeroed just before it; then the kernels' new modes at the
    paths' shapes and each step's timing. Returns (launches per path, the
    mode rows, the timing)."""
    from rgcn_tpu_torch.data.synthetic import fb_toy_like, wn18_like
    from rgcn_tpu_torch.profile_serve import profile_train_step

    paths, modes, timing = {}, [], {}
    card = card_line()
    for key, path, data, mode_fn in (
            ("train_lp_wn18", LP_CONFIG, wn18_like(), lp_wn18_modes),
            ("train_lp_fb_toy", FB_CONFIG, fb_toy_like(), lp_fb_modes)):
        counts, checks, trainer, peak = lp_train_against_cpu(
            key, path, data, dev, LP_TRAIN_EPOCHS, repeat=True)
        paths[key] = counts
        modes.extend(mode_fn(dev, trainer, counts))
        torch.cuda.reset_peak_memory_stats()
        prof = profile_train_step(trainer)
        timing[key] = {
            "card": card,
            "step_host_median": prof["step"]["host_ms"]["median"],
            "step_host_min": prof["step"]["host_ms"]["min"],
            "device_forward": prof["forward_us"] / 1e3,
            "device_backward": prof["backward_us"] / 1e3,
            "device_optimizer": prof["optimizer_us"] / 1e3,
            "device_step": prof["step_us"] / 1e3,
            "device_busy_share": prof["step"]["device_busy_share"],
            "peak_memory_gb_training_run": peak,
            "peak_memory_gb_profiled_step": torch.cuda.max_memory_allocated() / 1e9,
            "step_kernels_us": top_kernels(prof["step"]["kernels_us"], 16),
            "step_host_ops_us": prof["step"]["host_ops_us"],
            **checks,
        }
        log(json.dumps({f"{key}_step": timing[key]}))
        del trainer
    return paths, modes, timing


# -- the paper's variants: c-RGCN link prediction, e-RGCN node classification --

# one c-RGCN encode: the dense R-GCN at the compressed width, W (36, 16, 16)
# (lp-WN18) or (224, 10, 10) (lp-FB-toy), within fused_fits, so K2 once;
# the bottleneck layers are plain matmuls
C_SERVE = dict(k2_fused=1)
# e-RGCN on aifb_like() (90 general relations, so the merged pair frame):
# the diagonal layer K1 once, layer 2's W (90, 32, 4) K2 once
E_AIFB_PATH = dict(k1_aggregate=1, k2_fused=1)
# e-RGCN at AM scale (532 general relations, unmerged): the diagonal layer
# K1 once in slot order, layer 2's W (532, 32, 11) past fused_fits, K3 + K1
E_AM_PATH = dict(k1_aggregate=2, k3_messages=1)
C_TRAIN_EPOCHS = 2  # lp-WN18 and lp-FB-toy, c-RGCN, full batch
E_AIFB_EPOCHS = 4
E_AM_EPOCHS = 2


def train_crgcn_path(epochs: int) -> dict:
    """Launches of training a c-RGCN config for ``epochs`` and its final
    evaluation. A step: the R-GCN forward over the training subgraph (no
    fused layout: K3 then K1) and its dx over the reversed subgraph (K3
    then K1), the decoder's backward (K4 twice for the corrupted entities,
    K1 for the subjects' and the objects' rows). The evaluation encodes
    the whole graph once, through K2 (check_every is past ``epochs``)."""
    return dict(k3_messages=2 * epochs, k1_aggregate=4 * epochs,
                k4_weighted_aggregate=2 * epochs, k2_fused=1)


def train_ergcn_merged(epochs: int) -> dict:
    """Launches of training e-RGCN on aifb_like() for ``epochs``: per epoch
    the diagonal forward (K1 over the merged frame), layer 2's K2 forward,
    layer 2's dx over edges.reverse (K2), the diagonal dx (K1 over
    merged.rev_layout; d dw is a small product), the eval forward (K1,
    K2); then the final prediction's (K1, K2)."""
    return dict(k1_aggregate=3 * epochs + 1, k2_fused=3 * epochs + 1)


def train_ergcn_unmerged(epochs: int) -> dict:
    """The same at AM scale, unmerged: the diagonal forward and dx are K1
    once each (slot order over edges.layout and edges.reverse.layout; d dw
    an index_add_), layer 2's forward and dx K3 then K1 each; K1 6 and K3
    3 an epoch with the eval forward, plus the final prediction's K1 2,
    K3 1."""
    return dict(k1_aggregate=6 * epochs + 2, k3_messages=3 * epochs + 1)


def lp_path(label, build, data, expect, width):
    """Zero the counts, build an LP server (its one encode) and answer the
    requests of lp_requests; the counts must equal ``expect``, z finite
    (N, width)."""
    from rgcn_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    srv = build()
    answers = lp_requests(srv, data)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"serving [{label}]: build + encode + requests "
        f"{time.perf_counter() - t0:.2f} s, launches {counts}")
    if counts != launches(**expect):
        fail(f"serving [{label}]: launches {counts}, expected {launches(**expect)}")
    z = srv.z
    if tuple(z.shape) != (data.num_nodes, width) or not torch.isfinite(z).all():
        fail(f"serving [{label}]: z {tuple(z.shape)} not finite (N, {width})")
    return srv, answers, counts


def phase_crgcn_serving(dev, wn18, fb):
    """c-RGCN served through load_lp_server on both configs at full width
    (lp-WN18: 128 compressed to 16 on wn18_like(); lp-FB-toy: 64 to 10 on
    fb_toy_like()), counts zeroed before each: exactly K2 once per encode
    (C_SERVE); z and point scores within 1e-4 * max(1, max|ref|) of the
    CPU plain run, top-10 sets equal where the CPU's 10th and 11th scores
    are more than 1e-4 apart; each encode's host-clock median of 20.
    Returns (launches per path, timing, the servers' EdgeSets with the
    R-GCN's width)."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.serve import load_lp_server

    paths, timing, edges = {}, {}, {}
    for key, path, data in (("crgcn_lp_wn18", C_WN18_CONFIG, wn18),
                            ("crgcn_lp_fb_toy", C_FB_CONFIG, fb)):
        enc = load_experiment(path).encoder
        srv, answers, paths[key] = lp_path(
            f"{key}: c-RGCN", lambda: load_lp_server(path, data, device=dev), data,
            C_SERVE, enc.node_embedding)
        if srv.edges.merged is not None or srv.edges.fused is None:
            fail(f"serving [{key}]: expected a fused layout and no merged frame")
        state = {k: v.detach().cpu() for k, v in srv.model.state_dict().items()}
        cpu = load_lp_server(path, data, state, device="cpu")
        check_lp_against_cpu(key, srv, answers, cpu, data, scaled=True)
        timing[f"encode_ms_{key}"] = host_ms(srv.refresh)
        edges[key] = (srv.edges, enc.hidden1_size)
        del srv, cpu
    log(f"  c-RGCN timing (host clock, median of 20): {json.dumps(timing)}")
    return paths, timing, edges


def train_step_timing(trainer, **extra) -> dict:
    """One warm step of ``trainer`` profiled (profile_train_step), with the
    card's name and power limit."""
    from rgcn_tpu_torch.profile_serve import profile_train_step

    torch.cuda.reset_peak_memory_stats()
    prof = profile_train_step(trainer)
    return {
        "card": card_line(),
        "step_host_median": prof["step"]["host_ms"]["median"],
        "step_host_min": prof["step"]["host_ms"]["min"],
        "device_forward": prof["forward_us"] / 1e3,
        "device_backward": prof["backward_us"] / 1e3,
        "device_optimizer": prof["optimizer_us"] / 1e3,
        "device_step": prof["step_us"] / 1e3,
        "device_busy_share": prof["step"]["device_busy_share"],
        "peak_memory_gb_profiled_step": torch.cuda.max_memory_allocated() / 1e9,
        "forward_kernels_us": top_kernels(prof["forward_kernels_us"], 12),
        "backward_kernels_us": top_kernels(prof["backward_kernels_us"], 12),
        "step_kernels_us": top_kernels(prof["step"]["kernels_us"], 16),
        "step_host_ops_us": prof["step"]["host_ops_us"],
        **extra,
    }


def phase_crgcn_train(dev, wn18, fb):
    """c-RGCN lp-WN18 and lp-FB-toy trained for C_TRAIN_EPOCHS each, full
    batch (neither config sets graph_batch_size), on the card against the
    CPU (lp_train_against_cpu: gradients 1e-5 * max|ref| of each
    parameter, losses rtol 1e-4, MRR 1e-3, every test rank within the CPU
    model's 1e-4 score band), exactly train_crgcn_path's launches; each
    step profiled. Returns (launches per path, timing).

    The ranks are held to a score band and not to "99% equal": this
    untrained c-RGCN scores its 40,943 candidates so densely (median rank
    about half of them) that f32 noise alone moves about 1% of exact
    ranks. The phase shows it: the CPU trains once more from the
    initialisation moved by 1e-7 relative, and its share of ranks equal to
    the first CPU run's is reported beside the card's."""
    paths, timing = {}, {}
    for key, path, data in (("train_crgcn_lp_wn18", C_WN18_CONFIG, wn18),
                            ("train_crgcn_lp_fb_toy", C_FB_CONFIG, fb)):
        counts, checks, trainer, peak = lp_train_against_cpu(
            key, path, data, dev, C_TRAIN_EPOCHS,
            expect=launches(**train_crgcn_path(C_TRAIN_EPOCHS)), rank_band=True)
        paths[key] = counts
        timing[key] = train_step_timing(trainer, peak_memory_gb_training_run=peak,
                                        **checks)
        log(json.dumps({f"{key}_step": timing[key]}))
        del trainer
    return paths, timing


def phase_ergcn_serving(dev, aifb, am):
    """e-RGCN served through load_nc_server: nc-AIFB on aifb_like() (the
    merged frame), nc-AM on am_like() at AM scale (unmerged), counts zeroed
    before each: exactly E_AIFB_PATH and E_AM_PATH; logits within 1e-4 *
    max(1, max|ref|) of the CPU plain run, classes equal on three
    requests; each forward's host-clock median of 20. Returns (launches
    per path, timing)."""
    from rgcn_tpu_torch.serve import load_nc_server

    paths, timing = {}, {}
    for key, path, data, expect, merged in (
            ("ergcn_nc_aifb", E_AIFB_CONFIG, aifb, E_AIFB_PATH, True),
            ("ergcn_nc_am", E_AM_CONFIG, am, E_AM_PATH, False)):
        requests = nc_requests(data)
        srv, answers, paths[key] = serve_path(
            f"{key}: e-RGCN, {'merged' if merged else 'unmerged'} diagonal layer",
            lambda: load_nc_server(path, data, device=dev), requests, expect)
        if (srv.edges.merged is not None) != merged:
            fail(f"serving [{key}]: merged frame present {srv.edges.merged is not None}")
        check_nc_against_cpu(key, srv, answers, requests, path, data)
        timing[f"forward_ms_{key}"] = host_ms(srv.refresh)
        del srv
    log(f"  e-RGCN timing (host clock, median of 20): {json.dumps(timing)}")
    return paths, timing


def phase_ergcn_train(dev, aifb, am):
    """e-RGCN nc-AIFB (E_AIFB_EPOCHS, merged) and nc-AM at AM scale
    (E_AM_EPOCHS, unmerged) trained on the card against the CPU
    (train_against_cpu: gradients 1e-5 * max(1, max|ref|), losses rtol
    1e-4, accuracies equal, final logits), exactly train_ergcn_merged's
    and train_ergcn_unmerged's launches; each step profiled. Returns
    (launches per path, timing, the trainers' EdgeSets)."""
    from rgcn_tpu_torch.config import load_experiment

    paths, timing, edges = {}, {}, {}
    for key, path, data, epochs, expect in (
            ("train_ergcn_nc_aifb", E_AIFB_CONFIG, aifb, E_AIFB_EPOCHS,
             train_ergcn_merged(E_AIFB_EPOCHS)),
            ("train_ergcn_nc_am", E_AM_CONFIG, am, E_AM_EPOCHS,
             train_ergcn_unmerged(E_AM_EPOCHS))):
        base = load_experiment(path)
        cfg = dataclasses.replace(base, training=dataclasses.replace(
            base.training, epochs=epochs))
        got, check, card, peak = train_against_cpu(
            key, cfg, data, dev, ((key, key, lambda es: es, expect),),
            repeat_first=key == "train_ergcn_nc_am")
        paths.update(got)
        twice = {f"{key}_twice": check[f"{key}_repeat"]} if f"{key}_repeat" in check else {}
        timing[key] = train_step_timing(
            card, peak_memory_gb_training_run=peak,
            loss_max_rel_diff=check[key][0], logits_max_abs_diff=check[key][1], **twice)
        log(json.dumps({f"{key}_step": timing[key]}))
        edges[key] = card.edges
        del card
    return paths, timing, edges


def phase_diag_modes(dev, merged_edges, unmerged_edges, counts):
    """K1 in the diagonal layer's four modes, held within 1e-5 * max(1,
    max|ref|) against its plain version run in f64 on the same rows (at AM
    scale the plain f32 sum over the reverse frame's hub, tens of
    thousands of slots, is itself about as far from the exact sum as that
    tolerance) and timed as in phase 3 with
    its bound (bytes of the real slots) and a torch.index_add yardstick:
    the merged frame's forward (over merged.layout) and dx (over
    merged.rev_layout) on the nc-AIFB training EdgeSet, the unmerged
    forward (edges.layout, slot order) and dx (edges.reverse.layout) at AM
    scale, all at d 32. Then the torch ops around K1 on those paths, timed
    the same way: the slot-order message build (unmerged, forward; and the
    same messages through index_select, held equal), d dw's index_add_
    (unmerged), the merged frame's row gather and product, its
    coeff @ dw and rev_coeff @ dw, and its d dw product. Returns (the mode
    rows, the rows around the kernel)."""
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import diag as dg

    rng = np.random.default_rng(14)
    d = 32

    def rand(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    modes, around = [], []
    log("kernels (e-RGCN diagonal layer, d 32):")

    def k1_mode(label, rows, layout, n, key, mode_launches):
        keep = real_slot_mask(layout)
        real = int(keep.sum().item())
        idx = torch.where(keep, slot_nodes(layout, layout.local_dst), n)
        zeros = torch.zeros((n + 1, d), device=dev)
        modes.append(mode_row(
            "K1", f"K1 {label} ({real} real slots, d {d})",
            lambda: agg.aggregate_presorted(rows, layout, n),
            lambda: agg.aggregate_presorted_plain(rows, layout, n),
            lambda: torch.index_add(zeros, 0, idx, rows),
            real * (d * 4 + 4) + nbytes(layout.chunk_block) + n * d * 4, real * d,
            ref=lambda: agg.aggregate_presorted_plain(rows.double(), layout, n),
            path=key, launches=counts[key]["k1_aggregate"], mode_launches=mode_launches))

    def around_row(label, fn, k_bytes, flops, **meta):
        ms, call_ms = timed(fn)
        bound, by = bound_ms(k_bytes, flops)
        row = dict(what=label, ms=ms, call_ms=call_ms, bound_ms=bound, bound_by=by,
                   **meta)
        log(json.dumps({"diag_around": row}))
        around.append(row)

    # merged frame, nc-AIFB training EdgeSet
    es, key, e = merged_edges, "train_ergcn_nc_aifb", E_AIFB_EPOCHS
    m, n = es.merged, es.num_nodes
    x, dw, g = rand(n, d), rand(es.num_rels, d, scale=0.3), rand(n, d)
    rows = x[m.src_sorted.long()] * dg.merged_dvec(m.coeff, dw)
    k1_mode("diag merged forward (nc-AIFB)", rows, m.layout, n, key, 2 * e + 1)
    g_rows = g[m.rev_src_sorted.long()] * dg.merged_dvec(m.rev_coeff, dw)
    k1_mode("diag merged dx over rev_layout (nc-AIFB)", g_rows, m.rev_layout, n, key, e)
    slots, rev_slots = m.src_sorted.shape[0], m.rev_src_sorted.shape[0]
    r = es.num_rels
    dvec = dg.merged_dvec(m.coeff, dw)
    around_row("merged forward rows x[src_sorted] * dvec (nc-AIFB)",
               lambda: x[m.src_sorted.long()] * dvec,
               slots * (4 + 2 * d * 4) + n * d * 4, slots * d, slots=slots, path=key)
    around_row("merged coeff @ dw (nc-AIFB)", lambda: dg.merged_dvec(m.coeff, dw),
               slots * r * 4 + r * d * 4 + slots * d * 4, 2 * slots * r * d,
               slots=slots, path=key)
    around_row("merged rev_coeff @ dw (nc-AIFB)",
               lambda: dg.merged_dvec(m.rev_coeff, dw),
               rev_slots * r * 4 + r * d * 4 + rev_slots * d * 4,
               2 * rev_slots * r * d, slots=rev_slots, path=key)
    gg = g[m.rev_src_sorted.long()]
    xr = x[m.rev_receiver.long()]
    around_row("merged d dw = rev_coeff^T @ (x[rev_receiver] * gg) (nc-AIFB)",
               lambda: m.rev_coeff.t() @ (xr * gg),
               rev_slots * (r * 4 + 2 * d * 4) + r * d * 4,
               2 * rev_slots * r * d + rev_slots * d, slots=rev_slots, path=key)
    del rows, g_rows, dvec, gg, xr

    # unmerged, AM scale training EdgeSet
    es, key, e = unmerged_edges, "train_ergcn_nc_am", E_AM_EPOCHS
    n = es.num_nodes
    x, dw, g = rand(n, d), rand(es.num_rels, d, scale=0.3), rand(n, d)
    rows = dg.diag_slot_messages(x, dw, es)
    k1_mode("diag unmerged forward, slot order (AM scale)", rows, es.layout, n, key,
            2 * e + 1)
    del rows
    rev = es.reverse
    g_rows = dg.diag_slot_messages(g, dw, rev)
    k1_mode("diag unmerged dx over reverse.layout (AM scale)", g_rows, rev.layout, n,
            key, e)
    del g_rows
    slots = es.layout.perm.shape[0]
    real = int(real_slot_mask(es.layout).sum().item())
    e_pad = es.src.shape[0]
    around_row("unmerged slot-order messages x[src_s] * dw[rel_s] * val_s (AM scale)",
               lambda: dg.diag_slot_messages(x, dw, es),
               slots * (4 + d * 4) + e_pad * 12 + n * d * 4 + es.num_rels * d * 4,
               2 * real * d, slots=slots, message_mb=slots * d * 4 / 1e6, path=key)
    # the same messages through index_select (the port's build indexes
    # with advanced indexing): a measurement for the queue, not a path
    perm = es.layout.perm.long()

    def by_index_select():
        def z(t):
            return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
        src_s = z(es.src).index_select(0, perm).long()
        rel_s = z(es.rel).index_select(0, perm).long()
        val_s = z(es.val).index_select(0, perm)
        return x.index_select(0, src_s) * dw.index_select(0, rel_s) * val_s[:, None]

    check_close("slot-order messages by index_select vs the port's build",
                by_index_select(), dg.diag_slot_messages(x, dw, es), floor=0.0)
    around_row("the same messages through index_select (AM scale; not a path)",
               by_index_select,
               slots * (4 + d * 4) + e_pad * 12 + n * d * 4 + es.num_rels * d * 4,
               2 * real * d, slots=slots, path=key)
    around_row("unmerged d dw index_add_ onto R' rows (AM scale)",
               lambda: dg.diag_weight_grad(x, g, es),
               e_pad * 12 + 2 * n * d * 4 + es.num_rels * d * 4, 3 * e_pad * d,
               rows=e_pad, relation_rows=es.num_rels, path=key)
    return modes, around


def phase_crgcn_k2(dev, edges):
    """K2 at the c-RGCN encode shapes over the served EdgeSets' fused
    layouts (``edges``: key -> (EdgeSet, the R-GCN's width)): W (36, 16,
    16) (lp-WN18) and (224, 10, 10) (lp-FB-toy, its scalar path: dout not
    a multiple of 4), each held against its plain
    version and timed as in phase 3; at each shape the two routes (K2 over
    the fused layout, K3 then K1 over the destination layout) held against
    the plain two-stage version and timed in turns (K2, K3 + K1, K3 + K1,
    K2). The route rule is fused_fits', unchanged."""
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import fused as fz
    from rgcn_tpu_torch.ops import rel_spmm as rs

    rng = np.random.default_rng(15)
    modes = []
    for key, (es, hidden) in edges.items():
        n, r_gen, fl = es.num_nodes, es.num_rels, es.fused
        x = torch.relu(torch.from_numpy(rng.standard_normal((n, hidden)).astype(
            np.float32)).to(dev))
        w = torch.from_numpy((rng.standard_normal((r_gen, hidden, hidden))
                              * hidden ** -0.5).astype(np.float32)).to(dev)
        if not rs.fused_fits(w, fl.row_block):
            fail(f"K2 {key}: W {tuple(w.shape)} does not fit fused_fits")
        err = check_close(f"K2 rel_spmm_fused ({key} encode, W {tuple(w.shape)})",
                          fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None),
                          fz.rel_spmm_fused_plain(fl, n, x, w))
        keep = (fl.local_dst.reshape(-1) < fl.row_block) \
            & (fl.quantum_rel.repeat_interleave(fl.quantum) >= 0)
        real = int(keep.sum().item())
        x_rows = int(torch.unique(fl.src[keep]).numel())
        w_rels = int(torch.unique(fl.quantum_rel[fl.quantum_rel >= 0]).numel())
        ms, call = timed(lambda: fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None))
        plain_ms, plain_call = timed(lambda: fz.rel_spmm_fused_plain(fl, n, x, w))
        bound, by = bound_ms(real * 12 + (x_rows + w_rels * hidden) * hidden * 4
                             + nbytes(fl.quantum_rel, fl.chunk_block) + n * hidden * 4,
                             real * (2 * hidden * hidden + 2 * hidden))
        row = dict(
            name="K2", mode=f"K2 c-RGCN encode W {tuple(w.shape)} ({key}, fused L "
            f"{fl.src.shape[0]}, {real} real{'; scalar path' if hidden % 4 else ''})",
            route="cuda", source="rgcn_tpu_torch/kernels/csrc/k2_fused.cu",
            replaces="rgcn_tpu/ops/pallas_fused.py:355", path=key,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
            call_ms=call, plain_call_ms=plain_call, library_call_ms=None,
            bound_ms=bound, bound_by=by)
        log(json.dumps({"kernel_check": row}))
        modes.append(row)
        lay = es.layout
        ref = agg.aggregate_sorted_plain(rs.rel_spmm_messages_plain(es, x, w), lay, n)
        routes = {"k2": lambda: fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None),
                  "k3_k1": lambda: rs.rel_spmm_full(es, lay, x, w)}
        for rkey, fn in routes.items():
            check_close(f"{key} encode route {rkey} vs plain", fn(), ref)
        order = ("k2", "k3_k1", "k3_k1", "k2")
        times = [(rkey, timed(routes[rkey])) for rkey in order]
        log(json.dumps({"crgcn_encode_routes": {
            "path": key, "order": list(order),
            "device_ms": [t[1][0] for t in times],
            "call_ms": [t[1][1] for t in times],
        }}))
    return modes


def phase_variants(dev, am_data):
    """The paper's two variants (phases 14-18): c-RGCN serving and
    training, e-RGCN serving and training, the diagonal layer's K1 modes
    and K2 at the c-RGCN encode shapes; each phase's seconds. Returns
    (serve launches, train launches, serve timing, train timing, the mode
    rows, the rows around the diagonal layer's kernel)."""
    from rgcn_tpu_torch.data.synthetic import aifb_like, fb_toy_like, wn18_like

    def clock(label, t0):
        log(f"phase {label}: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    wn18, fb = wn18_like(), fb_toy_like()
    serve, serve_timing, c_edges = phase_crgcn_serving(dev, wn18, fb)
    clock("c-RGCN serving", t0)
    t0 = time.perf_counter()
    train, train_timing = phase_crgcn_train(dev, wn18, fb)
    clock("c-RGCN training", t0)
    del wn18, fb
    t0 = time.perf_counter()
    aifb = aifb_like()
    e_serve, e_timing = phase_ergcn_serving(dev, aifb, am_data)
    serve.update(e_serve)
    serve_timing.update(e_timing)
    clock("e-RGCN serving", t0)
    t0 = time.perf_counter()
    e_train, e_train_timing, e_edges = phase_ergcn_train(dev, aifb, am_data)
    train.update(e_train)
    train_timing.update(e_train_timing)
    clock("e-RGCN training", t0)
    t0 = time.perf_counter()
    modes, around = phase_diag_modes(dev, e_edges["train_ergcn_nc_aifb"],
                                     e_edges["train_ergcn_nc_am"], train)
    del e_edges
    modes.extend(phase_crgcn_k2(dev, c_edges))
    for r in modes:
        if r["name"] == "K2":
            r["launches"] = serve[r["path"]]["k2_fused"]
    clock("diagonal K1 modes and c-RGCN K2", t0)
    return serve, train, serve_timing, train_timing, modes, around


# -- from dataset files on disk: train with checkpoints, resume, serve --

FILES_NC_EPOCHS = 6  # nc-AIFB: checkpoints every 2; the broken run stops after 4
FILES_NC_BREAK = 4
FILES_LP_EPOCHS = 4  # lp-WN18: the broken run stops after 2 (max_epochs)
FILES_LP_BREAK = 2
# integer labels of different digit lengths, in class order: read as
# numbers they code the classes 0-3 as aifb_like does; read as strings
# ("1000" < "105" < "42" < "7") they would not
FILES_LABELS = (7, 42, 105, 1000)


def write_aifb_files(root, data) -> None:
    """``data`` (aifb_like) as AIFB's files: ``aifb/aifb_stripped.nt.gz``
    with URIs, ``trainingSet.tsv`` and ``testSet.tsv`` (person,
    label_affiliation) with the labels of FILES_LABELS."""
    import gzip

    d = os.path.join(root, "aifb")
    os.makedirs(d)
    uri = "http://aifb.example.org/"
    with gzip.open(os.path.join(d, "aifb_stripped.nt.gz"), "wt") as f:
        f.writelines(f"<{uri}{data.i2n[s]}> <{uri}{data.i2r[p]}> <{uri}{data.i2n[o]}> .\n"
                     for s, p, o in data.triples)
    for name, split in (("trainingSet.tsv", data.train), ("testSet.tsv", data.test)):
        with open(os.path.join(d, name), "w") as f:
            f.write("person\tlabel_affiliation\n")
            f.writelines(f"{uri}{n}\t{FILES_LABELS[c]}\n" for n, c in split.items())


def write_wn18_files(root, data) -> None:
    """``data`` (wn18_like) as WN18's files: ``wn18/train.txt`` the train
    split, ``valid.txt`` and ``test.txt`` the two halves of its test split;
    entities as WN18's 8-digit synset ids, relations ``_rel{p}``."""
    d = os.path.join(root, "wn18")
    os.makedirs(d)
    half = len(data.test) // 2
    for name, rows in (("train.txt", data.train), ("valid.txt", data.test[:half]),
                       ("test.txt", data.test[half:])):
        with open(os.path.join(d, name), "w") as f:
            f.writelines(f"{s:08d}\t_rel{p:02d}\t{o:08d}\n" for s, p, o in rows)


def timed_s(fn):
    """(result, host-clock seconds) of ``fn()``, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def checkpoint_times(trainer, ck, dev) -> dict:
    """Host seconds of one more save of ``trainer``'s state into ``ck`` and
    of its restore onto ``dev``, and the step file's size."""
    from rgcn_tpu_torch.utils.checkpoint import restore_checkpoint, save_training_state

    path, save_s = timed_s(lambda: save_training_state(ck, trainer.model,
                                                       trainer.optimizer, 999))
    (state, _), restore_s = timed_s(lambda: restore_checkpoint(ck, map_location=dev))
    if state is None or not all(v.device.type == dev.type
                                for v in state["params"].values()):
        fail(f"restore of {ck}: the parameters did not land on {dev}")
    return {"save_s": save_s, "restore_s": restore_s,
            "step_mb": os.path.getsize(path) / 1e6}


def files_nc(dev, root, timing) -> dict:
    """nc-AIFB from files: six epochs on the card with checkpoints every 2,
    a run broken after epoch 4 and resumed to 6, both against each other
    and the CPU under phase 5's gates; the resumed leg's exact launches; a
    server built from the checkpoint. Returns that leg's launches."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.loaders import load_node_classification
    from rgcn_tpu_torch.data.synthetic import aifb_like
    from rgcn_tpu_torch.models.node_classification import build_nc_model
    from rgcn_tpu_torch.serve import load_nc_server
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer
    from rgcn_tpu_torch.utils.checkpoint import latest_step

    source = aifb_like()
    _, timing["nc_write_s"] = timed_s(lambda: write_aifb_files(root, source))
    data, timing["nc_load_s"] = timed_s(
        lambda: load_node_classification("AIFB", final_run=True, data_root=root))
    again, timing["nc_load_cached_s"] = timed_s(
        lambda: load_node_classification("AIFB", final_run=True, data_root=root))
    # the loaded graph is the source renamed: same sizes, and each labelled
    # node's class code is its class in the source (numbers sort as numbers)
    n_src = {n: f"http://aifb.example.org/{n}" for n in source.i2n}
    coded = {n_src[n]: c for n, c in {**source.train, **source.test}.items()}
    if (data.num_nodes, data.num_relations, len(data.triples)) != \
            (source.num_nodes, source.num_relations, len(source.triples)) \
            or {**data.train, **data.test} != coded or again.train != data.train:
        fail("nc-AIFB files: the loaded dataset is not the one written")
    log(f"nc-AIFB from files: N {data.num_nodes}, R {data.num_relations}, "
        f"{len(data.triples)} triples, train {len(data.train)}, test {len(data.test)}, "
        f"classes coded from labels {FILES_LABELS}; load {timing['nc_load_s']:.2f} s, "
        f"from the cache {timing['nc_load_cached_s']:.3f} s")

    base = load_experiment(CONFIG)

    def config(epochs):
        return dataclasses.replace(base, training=dataclasses.replace(
            base.training, epochs=epochs))

    cfg = config(FILES_NC_EPOCHS)
    init = build_nc_model(cfg, data, seed=0).state_dict()

    def trainer(device, epochs=FILES_NC_EPOCHS, ck=None):
        return NodeClassificationTrainer(config(epochs), data, init_params=init,
                                         device=device, checkpoint_dir=ck,
                                         checkpoint_every=2)

    cpu, ref = trainer("cpu"), records_logger()
    cpu.fit(ref)
    ref_logits = cpu.logits()
    ref_state = cpu.model.state_dict()
    del cpu

    def diagnose(t, logits):
        return lambda: diagnose_params(cfg, data, t.model, logits, ref_state)

    ck_a, ck_b = os.path.join(root, "ck_nc_straight"), os.path.join(root, "ck_nc_broken")
    straight, rec_a = trainer(dev, ck=ck_a), records_logger()
    straight.fit(rec_a)
    logits_a = straight.logits()
    check_train_against_cpu("files nc-AIFB straight", rec_a.records, ref.records,
                            logits_a, ref_logits, diagnose(straight, logits_a))
    first, rec_b1 = trainer(dev, epochs=FILES_NC_BREAK, ck=ck_b), records_logger()
    first.fit(rec_b1)
    if sorted(os.listdir(ck_b)) != ["step_00000002", "step_00000004"]:
        fail(f"nc-AIFB broken run: checkpoints {sorted(os.listdir(ck_b))}")
    resumed, rec_b2 = trainer(dev, ck=ck_b), records_logger()
    torch.cuda.synchronize()
    kernels.reset_launches()
    resumed.fit(rec_b2)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    legs = FILES_NC_EPOCHS - FILES_NC_BREAK
    log(f"training [files nc-AIFB resumed at {FILES_NC_BREAK}]: epochs "
        f"{FILES_NC_BREAK + 1}-{FILES_NC_EPOCHS} + final prediction, launches {counts}")
    if counts != launches(**train_main_path(legs)):
        fail(f"files nc-AIFB resumed: launches {counts}, expected "
             f"{launches(**train_main_path(legs))}")
    joined = rec_b1.records[:-1] + rec_b2.records  # less the broken run's final record
    logits_b = resumed.logits()
    check_train_against_cpu("files nc-AIFB resumed vs CPU", joined, ref.records,
                            logits_b, ref_logits, diagnose(resumed, logits_b))
    check_train_against_cpu("files nc-AIFB resumed vs straight card", joined,
                            rec_a.records, logits_b, logits_a.cpu())
    if {latest_step(ck_a), latest_step(ck_b)} != {FILES_NC_EPOCHS}:
        fail("nc-AIFB: the last checkpoint is not the last epoch's")

    kernels.reset_launches()
    srv, timing["nc_server_from_checkpoint_s"] = timed_s(
        lambda: load_nc_server(CONFIG, data, checkpoint_dir=ck_b, device=dev))
    if srv is None or dict(kernels.LAUNCHES) != launches(**MAIN_PATH):
        fail(f"files nc-AIFB server: {srv} with launches {dict(kernels.LAUNCHES)}")
    want = logits_b.cpu().numpy()
    diff = float(np.abs(srv.logits - want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4 * max(1.0, float(np.abs(want).max()))
    classes = srv.classify(np.arange(data.num_nodes))
    agree = bool((classes == want.argmax(1))[clear].all())
    log(f"  [files nc-AIFB server] from {ck_b}: logits vs the trained model's max abs "
        f"diff {diff:.3e}; classes equal its argmax on all {int(clear.sum())} of "
        f"{data.num_nodes} nodes whose top two logits are apart: {agree}")
    if not (diff <= 1e-4 * max(1.0, float(np.abs(want).max())) and agree):
        fail("files nc-AIFB: the server from the checkpoint disagrees with the model")
    timing["nc_checkpoint"] = checkpoint_times(resumed, ck_b, dev)
    return counts


def files_lp(dev, root, timing) -> dict:
    """lp-WN18 from files: four epochs straight on the card (checkpoints
    every 2), and two (max_epochs) then a resume to four, both against each
    other and the CPU under phase 13's gates; the resumed leg's exact
    launches; a server from the checkpoint whose top-10 tails equal the
    trained model's. Returns that leg's launches."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.loaders import load_link_prediction
    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.serve import load_lp_server
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    source = wn18_like()
    _, timing["lp_write_s"] = timed_s(lambda: write_wn18_files(root, source))
    data, timing["lp_load_s"] = timed_s(
        lambda: load_link_prediction("WN18", final_run=True, data_root=root))
    half = len(source.test) // 2
    if (len(data.train), len(data.test), data.num_relations) != \
            (len(source.train), len(source.test) - half, source.num_relations) \
            or [int(x) for x in np.asarray(data.i2n)[data.train[:, 0]][:100]] \
            != source.train[:100, 0].tolist():
        fail("lp-WN18 files: the loaded dataset is not the one written")
    log(f"lp-WN18 from files: N {data.num_nodes} (the entities its triples reach), "
        f"R {data.num_relations}, train {len(data.train)}, valid {half}, test "
        f"{len(data.test)}; load {timing['lp_load_s']:.2f} s")

    base = load_experiment(LP_CONFIG)
    cfg = dataclasses.replace(base, training=dataclasses.replace(
        base.training, epochs=FILES_LP_EPOCHS))
    quiet = records_logger()

    def trainer(device, **kw):
        return LinkPredictionTrainer(cfg, data, device=device, logger=quiet, **kw)

    def losses(rec):
        return [r for r in rec.records if r[0] == "training.loss"]

    def check(label, got_losses, mrr, ranks, ref_losses, ref_mrr, ref_ranks):
        if [r[:2] for r in got_losses] != [r[:2] for r in ref_losses]:
            fail(f"[{label}]: loss records {got_losses} != {ref_losses}")
        worst = max(abs(a[2] - b[2]) / abs(b[2]) for a, b in zip(got_losses, ref_losses))
        same = float(np.mean(ranks == ref_ranks))
        log(f"  [{label}] losses max rel diff {worst:.3e}; MRR {mrr:.6f} vs "
            f"{ref_mrr:.6f}; {same:.4%} of {len(ranks)} ranks equal")
        if not (worst <= 1e-4 and abs(mrr - ref_mrr) <= 1e-3 and same >= 0.99
                and np.isfinite(mrr)):
            fail(f"[{label}]: losses (rtol 1e-4), MRR (1e-3) or ranks (99%) differ")
        return {"loss_max_rel_diff": worst, "mrr": mrr, "ranks_equal": same}

    ref = records_logger()
    ref_mrr, _, ref_ranks = trainer("cpu").fit(ref)
    ck_a, ck_b = os.path.join(root, "ck_lp_straight"), os.path.join(root, "ck_lp_broken")
    rec_a = records_logger()
    mrr_a, _, ranks_a = trainer(dev, checkpoint_dir=ck_a, checkpoint_every=2).fit(rec_a)
    checks = {"straight_vs_cpu": check("files lp-WN18 straight vs CPU", losses(rec_a),
                                       mrr_a, ranks_a, losses(ref), ref_mrr, ref_ranks)}
    rec_b1 = records_logger()
    trainer(dev, checkpoint_dir=ck_b, max_epochs=FILES_LP_BREAK).fit(rec_b1)
    if sorted(os.listdir(ck_b)) != [f"step_{FILES_LP_BREAK:08d}"]:
        fail(f"lp-WN18 broken run: checkpoints {sorted(os.listdir(ck_b))}")
    resumed, rec_b2 = trainer(dev, checkpoint_dir=ck_b), records_logger()
    torch.cuda.synchronize()
    kernels.reset_launches()
    mrr_b, _, ranks_b = resumed.fit(rec_b2)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    legs = FILES_LP_EPOCHS - FILES_LP_BREAK
    expect = launches(k4_weighted_aggregate=4 * legs + 1, k1_aggregate=2 * legs)
    log(f"training [files lp-WN18 resumed at {FILES_LP_BREAK}]: epochs "
        f"{FILES_LP_BREAK + 1}-{FILES_LP_EPOCHS} + final evaluation, launches {counts}")
    if counts != expect:
        fail(f"files lp-WN18 resumed: launches {counts}, expected {expect}")
    if sorted(os.listdir(ck_b))[-1] != f"step_{FILES_LP_EPOCHS:08d}":
        fail(f"lp-WN18 resumed run: checkpoints {sorted(os.listdir(ck_b))}")
    joined = losses(rec_b1) + losses(rec_b2)
    checks["resumed_vs_cpu"] = check("files lp-WN18 resumed vs CPU", joined, mrr_b,
                                     ranks_b, losses(ref), ref_mrr, ref_ranks)
    checks["resumed_vs_straight"] = check("files lp-WN18 resumed vs straight card",
                                          joined, mrr_b, ranks_b, losses(rec_a), mrr_a,
                                          ranks_a)
    timing["lp_checks"] = checks

    kernels.reset_launches()
    srv, timing["lp_server_from_checkpoint_s"] = timed_s(
        lambda: load_lp_server(LP_CONFIG, data, checkpoint_dir=ck_b, device=dev))
    if srv is None or dict(kernels.LAUNCHES) != launches(**LP_MAIN):
        fail(f"files lp-WN18 server: {srv} with launches {dict(kernels.LAUNCHES)}")
    q_np = np.asarray(data.test[:256])
    queries = torch.as_tensor(q_np, device=dev)
    with torch.no_grad():
        z = resumed.model.encode(resumed.eval_edges)
        want_s, want_e = torch.topk(resumed.model.score_tails(queries, z), 11, dim=1)
    dz = (srv.z - z).abs().max().item()
    _, got_e = srv.topk_tails(q_np[:, :2], k=10)
    rows = topk_agree("files lp-WN18 server top-10 tails", got_e,
                      want_s.cpu().numpy(), want_e.cpu().numpy(), 10)
    log(f"  [files lp-WN18 server] from {ck_b}: z vs the trained model's encode max abs "
        f"diff {dz:.3e}; top-10 tails equal on {rows} of {len(q_np)} queries (rows "
        f"with a 10th/11th gap > 1e-4)")
    if not dz <= 1e-4 * max(1.0, z.abs().max().item()) or 2 * rows < len(q_np):
        fail("files lp-WN18: the server from the checkpoint disagrees with the model")
    timing["lp_checkpoint"] = checkpoint_times(resumed, ck_b, dev)
    return counts


def phase_files(dev):
    """nc-AIFB and lp-WN18 from dataset files this run writes, trained with
    checkpoints, resumed and served from the checkpoint, in a temporary
    directory. Returns (launches of each resumed leg, the timing line)."""
    import tempfile

    t0 = time.perf_counter()
    timing = {"card": card_line()}
    with tempfile.TemporaryDirectory(prefix="rgcn_files_") as root:
        paths = {"files_nc_aifb_resumed": files_nc(dev, root, timing),
                 "files_lp_wn18_resumed": files_lp(dev, root, timing)}
    log(json.dumps({"files_timing_s": timing}))
    log(f"phase files: {time.perf_counter() - t0:.1f} s")
    return paths, timing


# -- the native host builders: the LP epoch's host build, stage by stage --

HOST_REPS = 3  # epochs timed per stage, each way, after a warm one
HOST_FIT_EPOCHS = 4  # each card fit, each way (two timed after two warm)
HOST_CPU_EPOCHS = 1  # the CPU trainings held bit-identical, each way
HOST_TRAIN_EPOCHS = 2  # the counted run on the card
HOST_AM_REPS = 1  # am_like()'s edge set built each way


def native_train_calls(epochs: int) -> dict:
    """Native calls of the lp-WN18 training path: the evaluation graph (the
    edge set; its reverse sort; the forward, reverse and the merged frame's
    two layouts), then per epoch the subgraph's two sorts and two layouts
    and the three structured layouts."""
    return {"build_edge_set": 1, "build_dst_layout": 4 + 5 * epochs,
            "lexsort_rel_dst": 1 + 2 * epochs, "parse_nt": 0}


def gil_share() -> float:
    """A 20M-edge native lexsort in a second thread against this thread's
    loop: the share of its solo rate the loop kept during the sort (near 1
    if ctypes released the GIL, near 0 if not)."""
    import threading

    from rgcn_tpu_torch.graph.native import lexsort_rel_dst

    rng = np.random.default_rng(0)
    rel = rng.integers(0, 64, 20_000_000).astype(np.int32)
    dst = rng.integers(0, 1_000_000, 20_000_000).astype(np.int32)
    lexsort_rel_dst(rel[:100], dst[:100], 64, 1_000_000)  # load the library

    def loop(stop):
        n, t0 = 0, time.perf_counter()
        while not stop.is_set():
            n += 1
        return n, time.perf_counter() - t0

    stop = threading.Event()
    threading.Timer(0.3, stop.set).start()
    n, dt = loop(stop)
    rate = n / dt
    stop, started = threading.Event(), threading.Event()

    def sort():
        started.set()
        lexsort_rel_dst(rel, dst, 64, 1_000_000)
        stop.set()

    th = threading.Thread(target=sort)
    th.start()
    started.wait()
    n, dt = loop(stop)
    th.join()
    share = n / (rate * dt)
    log(f"host builders: this thread kept {share:.3f} of its loop rate during a "
        f"{dt * 1e3:.0f} ms native lexsort in another thread (the GIL released)")
    return share


def host_epochs_card(dev, timing) -> None:
    """profile_epoch's stage split (both ways, every epoch's batches equal
    bit for bit) and its two card fits of each LP config, the fits' losses
    within phase 13's rtol of each other."""
    from rgcn_tpu_torch import profile_epoch

    for key in profile_epoch.CONFIGS:
        t0 = time.perf_counter()
        try:
            r = profile_epoch.profile_config(key, dev, HOST_REPS, HOST_FIT_EPOCHS,
                                             ways=("native", "numpy"))
        except RuntimeError as e:
            fail(f"host build [{key}]: {e}")
        nat, npy = r["fit"]["native"], r["fit"]["numpy"]
        worst = max(abs(a - b) / abs(b) for a, b in zip(nat["losses"], npy["losses"]))
        st = r["stages_ms"]
        log(f"host build [{key}] {r['sizes']}: stages native {st['native']['total']:.2f} "
            f"ms, numpy {st['numpy']['total']:.2f} ms (bit-equal batches); fit epoch "
            f"wall native {nat['epoch_wall_ms']:.2f}, numpy {npy['epoch_wall_ms']:.2f} "
            f"ms, step host {nat['step_host_ms']:.2f} / {npy['step_host_ms']:.2f} ms, "
            f"busy {nat['device_busy_share']} / {npy['device_busy_share']}; losses max "
            f"rel diff {worst:.3e} ({time.perf_counter() - t0:.1f} s)")
        if not worst <= 1e-4 or not all(np.isfinite(nat["losses"] + npy["losses"])):
            fail(f"host build [{key}]: the card's fits differ (losses rtol 1e-4)")
        for f in (nat, npy):
            f.pop("ranks")
        nat["losses_equal_numpy_fit"] = nat["losses"] == npy["losses"]
        timing[key] = r


def host_trainings_cpu(timing) -> None:
    """Each LP config trained HOST_CPU_EPOCHS epochs on the CPU by the
    trainer (native builders) and with the numpy builders: losses, MRR and
    every rank bit-identical."""
    from rgcn_tpu_torch import profile_epoch
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import synthetic_lp_data
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    for key, path in profile_epoch.CONFIGS.items():
        t0 = time.perf_counter()
        base = load_experiment(path)
        cfg = dataclasses.replace(base, training=dataclasses.replace(
            base.training, epochs=HOST_CPU_EPOCHS))
        data = synthetic_lp_data(cfg.dataset.name)
        ways = []
        for trainer in (
                lambda: LinkPredictionTrainer(cfg, data, device="cpu"),
                lambda: profile_epoch.StagedTrainer(cfg, data, device="cpu",
                                                    prefer_native=False)):
            rec = records_logger()
            mrr, _, ranks = trainer().fit(rec)
            ways.append(([r[2] for r in rec.records if r[0] == "training.loss"], mrr,
                         np.asarray(ranks)))
        (l_a, m_a, r_a), (l_b, m_b, r_b) = ways
        same = l_a == l_b and m_a == m_b and np.array_equal(r_a, r_b)
        log(f"host build [{key}] CPU training {HOST_CPU_EPOCHS} epochs, native vs "
            f"numpy builders: losses {l_a} vs {l_b}, MRR {m_a} vs {m_b}, {len(r_a)} "
            f"ranks bit-identical: {same} ({time.perf_counter() - t0:.1f} s)")
        if not same:
            fail(f"host build [{key}]: CPU training differs between the builders")
        timing[key]["cpu_training_bit_identical"] = same


def host_counts_card(dev, timing) -> None:
    """lp-WN18 trained HOST_TRAIN_EPOCHS epochs on the card by the trainer,
    the native calls and the kernel launches zeroed just before it: exactly
    native_train_calls and phase 13's launches."""
    from rgcn_tpu_torch import kernels, native
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    base = load_experiment(LP_CONFIG)
    cfg = dataclasses.replace(base, training=dataclasses.replace(
        base.training, epochs=HOST_TRAIN_EPOCHS))
    data = wn18_like()
    torch.cuda.synchronize()
    native.reset_calls()
    kernels.reset_launches()
    LinkPredictionTrainer(cfg, data, device=dev, logger=records_logger()).fit(
        records_logger())
    torch.cuda.synchronize()
    calls, counts = dict(native.CALLS), dict(kernels.LAUNCHES)
    e = HOST_TRAIN_EPOCHS
    want = launches(k4_weighted_aggregate=4 * e + 1, k1_aggregate=2 * e)
    log(f"host build [lp-WN18 training path, {e} epochs]: native calls {calls}, "
        f"launches {counts}")
    if calls != native_train_calls(e):
        fail(f"lp-WN18 training path: native calls {calls}, expected "
             f"{native_train_calls(e)}")
    if counts != want:
        fail(f"lp-WN18 training path: launches {counts}, expected {want}")
    timing["lp_wn18_train_native_calls"] = calls


def write_am_nt(path, data) -> None:
    """``data`` (am_like) as a gzipped N-Triples graph with URIs."""
    import gzip

    uri = "http://am.example.org/"
    with gzip.open(path, "wt", compresslevel=6) as f:
        f.writelines(f"<{uri}{data.i2n[s]}> <{uri}{data.i2r[p]}> <{uri}{data.i2n[o]}> .\n"
                     for s, p, o in data.triples)


def host_am(am_data, timing) -> None:
    """am_like()'s static edge set (with layouts) and its graph file's
    parse, each both ways: equal outputs, host seconds."""
    import tempfile

    from rgcn_tpu_torch.data.loaders import _parse_graph
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.profile_epoch import batch_differences

    d = am_data
    built, secs = {}, {"native": [], "numpy": []}
    for _ in range(HOST_AM_REPS):
        for way in ("native", "numpy"):
            t0 = time.perf_counter()
            built[way] = build_edge_set(d.triples, d.num_nodes, d.num_relations,
                                        tile_size=128, with_dst_layout=True,
                                        prefer_native=way == "native")
            secs[way].append(time.perf_counter() - t0)
    diff = batch_differences(built["native"], built["numpy"])
    log(f"host build [am_like build_edge_set, with_dst_layout]: native "
        f"{[round(x, 4) for x in secs['native']]} s, numpy "
        f"{[round(x, 4) for x in secs['numpy']]} s; differing fields {diff}")
    if diff:
        fail(f"am_like edge set: native and numpy differ in {diff}")
    timing["am_edge_set_s"] = secs
    del built

    with tempfile.TemporaryDirectory(prefix="rgcn_am_nt_") as root:
        path = os.path.join(root, "am_stripped.nt.gz")
        _, timing["am_nt_write_s"] = timed_s(lambda: write_am_nt(path, d))
        parsed, secs = {}, {"native": [], "python": []}
        for way in ("native", "python"):
            t0 = time.perf_counter()
            parsed[way] = _parse_graph(path, prefer_native=way == "native")
            secs[way].append(time.perf_counter() - t0)
        size_mb = os.path.getsize(path) / 1e6
    spo, nodes, rels = parsed["native"]
    back = np.array([int(x.rsplit("node", 1)[1]) for x in nodes])[spo[:, [0, 2]]]
    rel_back = np.array([int(x.rsplit("rel", 1)[1]) for x in rels])[spo[:, 1]]
    diff = batch_differences(parsed["native"], parsed["python"])
    source_ok = np.array_equal(back, np.asarray(d.triples)[:, [0, 2]]) and \
        np.array_equal(rel_back, np.asarray(d.triples)[:, 1])
    log(f"host build [am_like as AM's .nt.gz, {size_mb:.1f} MB, "
        f"{len(spo)} triples, {len(nodes)} nodes, {len(rels)} relations]: parse native "
        f"{[round(x, 3) for x in secs['native']]} s, Python scanner "
        f"{[round(x, 3) for x in secs['python']]} s; differing {diff}; the source's "
        f"triples: {source_ok}")
    if diff or not source_ok:
        fail("am_like graph file: the parsers disagree or lose the source's triples")
    timing["am_nt_parse_s"] = {**secs, "file_mb": size_mb, "triples": int(len(spo))}


def phase_host_build(dev, am_data):
    """The native host builders on the card's host: the GIL released in a
    native call; the LP epoch's host build stage by stage both ways on each
    LP config (profile_epoch) and each config's card fits both ways; the
    same configs trained on the CPU with either builders, bit-identical;
    the lp-WN18 training path's exact native calls and launches; am_like's
    edge set and graph file both ways. Returns the host_build_ms line."""
    from rgcn_tpu_torch import profile_epoch

    t0 = time.perf_counter()
    timing = {"card": card_line(), "host_cpu": profile_epoch.host_cpu()}
    log(f"host build: {timing['card']}; host CPU {timing['host_cpu']}")
    timing["gil_released_share"] = gil_share()
    if not timing["gil_released_share"] > 0.3:
        fail("a native builder holds the GIL for its call")
    host_epochs_card(dev, timing)
    host_trainings_cpu(timing)
    host_counts_card(dev, timing)
    host_am(am_data, timing)
    log(f"phase host build: {time.perf_counter() - t0:.1f} s")
    return timing


# -- phase 21: the single-device branches no shipped config reaches --

BRANCH_NC_EPOCHS = 3  # nc-AIFB R-GCN and e-RGCN with 4 bases, e-RGCN with blocks
BRANCH_AM_EPOCHS = 2  # nc-AM R-GCN with 4 bases at AM scale
BRANCH_LP_EPOCHS = 2  # lp-WN18: biased decoder, plain L2, structural self-loop mask
BRANCH_HOST_EPOCHS = 5  # sample_epoch's stages timed on the assembled branch


def train_few_bases(epochs: int) -> dict:
    """Launches of training an R-GCN with at most 8 bases for ``epochs``:
    per epoch the train forward (K4 layer 1 over the per-basis tables with
    sum_bases, K4 layer 2 over the merged frame or the destination layout),
    the backward (K4 over the merged reverse frame or edges.reverse for
    layer 2's dx, K4 over edges.reverse with the shared g for layer 1's
    basis tables) and the eval forward (K4 twice); then the final
    prediction's two."""
    return dict(k4_weighted_aggregate=6 * epochs + 2)


def train_ergcn_bases(epochs: int) -> dict:
    """e-RGCN with at most 8 bases: the diagonal layer's K1 and rgc1's K4
    over the merged frame, each once in the train forward, once in the
    backward (dx over the merged reverse frame) and once in the eval
    forward; one more of each for the final prediction."""
    return dict(k1_aggregate=3 * epochs + 1, k4_weighted_aggregate=3 * epochs + 1)


def train_lp_assembled(epochs: int, plain_l2: bool) -> dict:
    """lp-WN18 on the assembled batch: per step K4 forward and K4 dx over
    the reversed subgraph, and for a bias-free decoder (plain L2) K1 for
    the subjects' and the objects' rows (a biased decoder scores through
    plain gathers and autograd: no kernel); one K4 encode to evaluate."""
    out = dict(k4_weighted_aggregate=2 * epochs + 1)
    if plain_l2:
        out["k1_aggregate"] = 2 * epochs
    return out


def nc_branch_cfg(path, decomposition, epochs):
    from rgcn_tpu_torch.config import load_experiment

    base = load_experiment(path)
    return dataclasses.replace(
        base, rgcn=dataclasses.replace(base.rgcn, decomposition=decomposition),
        training=dataclasses.replace(base.training, epochs=epochs))


def lp_biased(cfg):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                bias_init="zeros"))


def lp_plain_l2(cfg):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                l2_penalty_type="l2"))


def lp_structural(cfg):
    enc = cfg.encoder
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        enc, edge_dropout=dataclasses.replace(enc.edge_dropout, self_loop=0.2,
                                              self_loop_type="structural")))


def branch_summary(counts, timing, **diffs) -> dict:
    """The branches line's entry of one path."""
    return {"launches": counts, "step_host_median_ms": timing["step_host_median"],
            "device_step_ms": timing["device_step"],
            "device_busy_share": timing["device_busy_share"],
            "peak_memory_gb_training_run": timing["peak_memory_gb_training_run"],
            **diffs}


def host_stage_ms(trainer, epochs: int) -> dict:
    """sample_epoch's stages on the card's host, native builders: the median
    ms of each over ``epochs`` epochs after a warm one."""
    from rgcn_tpu_torch.train.link_prediction import EPOCH_STAGES

    trainer.sample_epoch(2)
    laps = {st: [] for st in EPOCH_STAGES}
    for epoch in range(3, 3 + epochs):
        times: dict = {}
        trainer.sample_epoch(epoch, times=times)
        for st, v in times.items():
            laps[st].append(v * 1e3)
    return {st: float(np.median(v)) for st, v in laps.items()}


def branch_k5_grad(dev, lp_edges, dedup):
    """One forward and backward of the merged-frame basis Function over the
    lp-WN18 dedup frame (exactly K5 1 forward, K4 1 dx), held against the
    same Function over the plain merged frame on the card (K4 both ways),
    1e-5 * max(1, max|ref|); each timed (CUDA events, 20 calls). A grad
    through K4 outside the Functions must still raise. Returns (launches,
    the row)."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.ops.basis import rel_spmm_basis, weighted_aggregate

    n, r, d = lp_edges.num_nodes, lp_edges.num_rels, 200
    gen = torch.Generator().manual_seed(21)
    x, g = (torch.randn((n, d), generator=gen).to(dev) for _ in range(2))
    bases = (torch.randn((2, d, d), generator=gen) / d ** 0.5).to(dev)
    comps = torch.randn((r, 2), generator=gen).to(dev)
    frame = dataclasses.replace(lp_edges, merged=dedup)

    def run(edges):
        leaves = [t.clone().requires_grad_() for t in (x, bases, comps)]
        out = rel_spmm_basis(edges, *leaves)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    torch.cuda.synchronize()
    kernels.reset_launches()
    got = run(frame)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"K5 under grad: launches {counts}")
    if counts != launches(k5_weighted_aggregate_dedup=1, k4_weighted_aggregate=1):
        fail(f"K5 under grad: launches {counts}, expected one K5 and one K4")
    ref = run(lp_edges)
    errs = {name: check_close(f"[K5 under grad] {name} vs the plain merged frame", a, b)
            for name, a, b in zip(("out", "dx", "dbases", "dcomps"), got, ref)}
    m = lp_edges.merged
    src, w = m.src_sorted, torch.ones((2, m.coeff.shape[0]), device=dev)
    try:
        weighted_aggregate(x.clone().requires_grad_(), src, w, m.layout, n)
    except RuntimeError as e:
        log(f"  K4 outside the Functions under grad raises: {e}")
    else:
        fail("K4 under grad outside the autograd Functions did not raise")
    row = {"card": card_line(), "max_abs_err": errs,
           "dedup_fwd_bwd_ms": cuda_ms(lambda: run(frame), iters=20),
           "merged_fwd_bwd_ms": cuda_ms(lambda: run(lp_edges), iters=20)}
    log(f"  K5 under grad: {json.dumps(row)}")
    return counts, row


def k4_pieces_row(dev, edges) -> dict:
    """K4's f32 form at nc-AM's hidden width 10 (40-byte rows: 8-byte
    pieces, the last 4-value vector of a row masked) over ``edges``'
    destination layout, as the featureless 4-basis layer sums it
    (per-basis (4, N, 10) tables, sum_bases): held against its plain
    version, timed with its bound and a torch.sparse.mm yardstick."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.ops import basis as bs

    rng = np.random.default_rng(24)
    n, nb, din = edges.num_nodes, 4, 10
    comps = torch.from_numpy((rng.standard_normal((edges.num_rels, nb)) * 0.3)
                             .astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.standard_normal((nb, n, din)).astype(np.float32)).to(dev)
    src, w = bs.sorted_inputs(edges, comps)
    lay = edges.layout
    if kernels.k4_piece(din, table.data_ptr(), 4) != 2:
        fail("K4 at width 10: not the 8-byte pieces")
    label = "K4 f32 pieces: nc-AM featureless sum, (4, N, 10), sum_bases"
    err = check_close(label, bs.weighted_aggregate(table, src, w, lay, n, sum_bases=True),
                      bs.weighted_aggregate_plain(table, src, w, lay, n, sum_bases=True))
    keep = lay.local_dst.reshape(-1) < lay.row_block
    real = int(keep.sum().item())
    n_rows = int(torch.unique(src[keep]).numel())
    k_bytes = real * (4 + nb * 4) + nbytes(lay.local_dst, lay.chunk_block) \
        + nb * n_rows * din * 4 + n * din * 4
    node, src_k = slot_nodes(lay, lay.local_dst)[keep], src.long()[keep]
    a = lp_csr(node.repeat(nb), torch.cat([b * n + src_k for b in range(nb)]),
               w[:, keep].reshape(-1), (n, nb * n))
    flat = table.reshape(nb * n, din)
    ms, call = timed(lambda: bs.weighted_aggregate(table, src, w, lay, n, sum_bases=True))
    plain_ms, plain_call = timed(lambda: bs.weighted_aggregate_plain(
        table, src, w, lay, n, sum_bases=True))
    lib_ms, lib_call = timed(lambda: torch.sparse.mm(a, flat))
    bound, by = bound_ms(k_bytes, 2 * nb * real * din)
    row = dict(name="K4 f32 pieces", mode=label, route="cuda",
               source="rgcn_tpu_torch/kernels/csrc/k4_owned.cuh",
               replaces="rgcn_tpu/ops/pallas_basis.py:166", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
               call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call)
    log(json.dumps({"kernel_check": row}))
    return row


def phase_branches(dev, am, wn18, lp_edges, dedup):
    """Phase 21: train the branches no shipped config reaches on the card,
    each against the CPU from the same initialisation, counts zeroed just
    before each path; each step profiled. Returns (launches per path, the
    timing per path, the branches line, K4's f32 row at nc-AM's width 10
    over branch_nc_am_basis4's layout)."""
    from rgcn_tpu_torch.config import DecompositionConfig
    from rgcn_tpu_torch.data.synthetic import aifb_like

    basis4 = DecompositionConfig("basis", num_bases=4)
    blocks2 = DecompositionConfig("block", num_blocks=2)
    aifb = aifb_like()
    paths, timing, summary = {}, {}, {}
    for key, path, data, decomp, epochs, expect, merged in (
            ("branch_nc_aifb_basis4", CONFIG, aifb, basis4, BRANCH_NC_EPOCHS,
             train_few_bases(BRANCH_NC_EPOCHS), True),
            ("branch_nc_am_basis4", AM_CONFIG, am, basis4, BRANCH_AM_EPOCHS,
             train_few_bases(BRANCH_AM_EPOCHS), False),
            ("branch_ergcn_nc_aifb_basis4", E_AIFB_CONFIG, aifb, basis4,
             BRANCH_NC_EPOCHS, train_ergcn_bases(BRANCH_NC_EPOCHS), True),
            ("branch_ergcn_nc_aifb_blocks2", E_AIFB_CONFIG, aifb, blocks2,
             BRANCH_NC_EPOCHS, train_ergcn_merged(BRANCH_NC_EPOCHS), True)):
        t0 = time.perf_counter()
        cfg = nc_branch_cfg(path, decomp, epochs)
        got, check, card, peak = train_against_cpu(
            key, cfg, data, dev, ((key, key, lambda es: es, expect),))
        if (card.edges.merged is not None) != merged:
            fail(f"training [{key}]: merged frame present {card.edges.merged is not None}")
        if key == "branch_nc_am_basis4":
            pieces_row = k4_pieces_row(dev, card.edges)
        paths.update(got)
        timing[key] = train_step_timing(
            card, peak_memory_gb_training_run=peak,
            loss_max_rel_diff=check[key][0], logits_max_abs_diff=check[key][1])
        summary[key] = branch_summary(got[key], timing[key],
                                      loss_max_rel_diff=check[key][0],
                                      logits_max_abs_diff=check[key][1])
        log(json.dumps({f"{key}_step": timing[key]}))
        log(f"phase 21 [{key}]: {time.perf_counter() - t0:.1f} s")
        del card
    for key, edit, expect in (
            ("branch_lp_wn18_biased", lp_biased,
             train_lp_assembled(BRANCH_LP_EPOCHS, plain_l2=False)),
            ("branch_lp_wn18_plain_l2", lp_plain_l2,
             train_lp_assembled(BRANCH_LP_EPOCHS, plain_l2=True)),
            ("branch_lp_wn18_structural", lp_structural,
             train_lp_path("basis", BRANCH_LP_EPOCHS))):
        t0 = time.perf_counter()
        counts, checks, trainer, peak = lp_train_against_cpu(
            key, LP_CONFIG, wn18, dev, BRANCH_LP_EPOCHS, expect=launches(**expect),
            edit=edit, repeat=key == "branch_lp_wn18_structural")
        b = trainer.batch
        assembled = key != "branch_lp_wn18_structural"
        if (b.batch is not None) != assembled:
            fail(f"training [{key}]: assembled batch present {b.batch is not None}")
        if not assembled and (b.self_masks is None or b.self_masks[0].shape[1] != 1
                              or b.self_masks[0].dtype != torch.float32):
            fail(f"training [{key}]: no structural (N, 1) f32 self-loop mask")
        paths[key] = counts
        extra = {}
        if assembled:
            extra["host_stage_ms"] = host_stage_ms(trainer, BRANCH_HOST_EPOCHS)
            log(f"  [{key}] sample_epoch stages (host ms, median of "
                f"{BRANCH_HOST_EPOCHS}): {json.dumps(extra['host_stage_ms'])}")
        timing[key] = train_step_timing(trainer, peak_memory_gb_training_run=peak,
                                        **checks, **extra)
        summary[key] = branch_summary(
            counts, timing[key], loss_max_rel_diff=checks["loss_max_rel_diff"],
            mrr=checks["mrr"], cpu_mrr=checks["cpu_mrr"],
            ranks_equal=checks["ranks_equal"],
            **({"repeat": checks["repeat"]} if "repeat" in checks else {}))
        log(json.dumps({f"{key}_step": timing[key]}))
        log(f"phase 21 [{key}]: {time.perf_counter() - t0:.1f} s")
        del trainer
    counts, row = branch_k5_grad(dev, lp_edges, dedup)
    paths["branch_k5_grad"] = counts
    summary["branch_k5_grad"] = {"launches": counts, **row}
    return paths, timing, summary, pieces_row


# -- phase 22: edge-sharded training, ranks on the card ------------------------

SHARDED_NC_EPOCHS = 2  # nc-AIFB R-GCN
SHARDED_AM_EPOCHS = 1  # nc-AM at AM scale, pair path
SHARDED_LP_EPOCHS = 1  # lp-WN18, structured step, final sharded evaluation
SHARDED_FB_EPOCHS = 1  # lp-FB-toy on the 2x2 mesh (block layer)


def epochs_cfg(path, epochs):
    from rgcn_tpu_torch.config import load_experiment

    base = load_experiment(path)
    return dataclasses.replace(base, training=dataclasses.replace(base.training,
                                                                  epochs=epochs))


def param_digests(model) -> dict:
    """sha256 of every parameter's bytes: equal digests, equal bits."""
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in model.state_dict().items()}


def step_timer(trainer) -> list:
    """Wrap ``trainer.step`` so each call's synchronised host ms is kept in
    the returned list."""
    times, step = [], trainer.step

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return loss

    trainer.step = timed
    return times


def collective_ms(mesh, rows: int, width: int, reps: int = 10) -> float:
    """One all-reduce of a (rows, width) f32 tensor over the edge group, ms
    (host clock, synchronised, mean of ``reps`` after one warm-up)."""
    from rgcn_tpu_torch.ops.collectives import reduce_sum

    x = torch.ones((rows, width), device=mesh.device)
    reduce_sum(x, mesh.group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        reduce_sum(x, mesh.group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def sharded_case(mesh, spec) -> dict:
    """One case on this rank: the sharded trainer (the drivers' trainer
    classes) over ``spec``'s config and data, its launches counted from 0
    just before ``fit``."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.dist.driver import (
        ShardedLinkPredictionTrainer,
        ShardedNodeClassificationTrainer,
    )

    t0 = time.perf_counter()
    cfg = epochs_cfg(spec["config"], spec["epochs"])
    if spec["kind"] == "nc":
        trainer = ShardedNodeClassificationTrainer(cfg, spec["data"], mesh, seed=0)
        width = cfg.rgcn.hidden_size
    else:
        trainer = ShardedLinkPredictionTrainer(cfg, spec["data"], mesh, seed=0)
        width = trainer.model.scoring_function.relations.shape[1]
    setup_s = time.perf_counter() - t0
    times = step_timer(trainer)
    rec = records_logger()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = trainer.fit(rec)
    torch.cuda.synchronize()
    out = {"launches": dict(kernels.LAUNCHES), "fit_s": time.perf_counter() - t0,
           "setup_s": setup_s, "step_ms": times,
           "losses": [v for m, _, v in rec.records if m == "training.loss"],
           "digest": param_digests(trainer.model),
           "collective_ms": collective_ms(mesh, spec["data"].num_nodes, width)}
    if spec["kind"] == "nc":
        out.update(acc=result, logits=trainer.logits())
    else:
        out.update(mrr=result[0], ranks=result[2])
    del trainer
    torch.cuda.empty_cache()
    return out


def sharded_rank(dev, cases):
    """One rank of phase 22: each (key, spec) case in turn, on a mesh of
    ``spec["shape"]`` (replicas, edge shards): the edge stage pinned to f32,
    as the f32 cases compare it, or (``spec["bf16"]``) the card's default."""
    from rgcn_tpu_torch.dist.multihost import make_mesh_2d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for key, spec in cases:
        with contextlib.nullcontext() if spec.get("bf16") else edge_stage(None):
            out[key] = sharded_case(make_mesh_2d(*spec["shape"], device=dev), spec)
    return out


def one_device_reference(spec, dev) -> dict:
    """The port's own single-device trainer on the card, seed 0, the same
    epochs: the reference of a sharded case."""
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer

    t0 = time.perf_counter()
    cfg = epochs_cfg(spec["config"], spec["epochs"])
    rec = records_logger()
    if spec["kind"] == "nc":
        trainer = NodeClassificationTrainer(cfg, spec["data"], seed=0, device=dev)
        times = step_timer(trainer)
        out = {"acc": trainer.fit(rec), "logits": trainer.logits().cpu().numpy()}
    else:
        trainer = LinkPredictionTrainer(cfg, spec["data"], seed=0, device=dev, logger=rec)
        times = step_timer(trainer)
        mrr, _, ranks = trainer.fit(rec)
        out = {"mrr": mrr, "ranks": ranks}
    out.update(losses=[v for m, _, v in rec.records if m == "training.loss"],
               step_ms=times, seconds=time.perf_counter() - t0)
    del trainer
    torch.cuda.empty_cache()
    return out


def sharded_expect(spec, rank: int) -> dict:
    """Each kernel's launches on ``rank`` for ``spec``: what the
    single-device trainer launches on the same per-shard structures. NC
    (no fused layout per shard): nc-AIFB K1 5E + 2, K3 3E + 1
    (train_k3_branch), the pair path K1 8E + 2 (train_pair_path), on every
    rank. LP: a step's K4 forward, K4 dx, two K4 and two K1 of the
    decoder (basis), or K3 then K1 both ways and the same decoder (block);
    the final evaluation's one encode runs on rank 0 only (it broadcasts
    z), so rank 0 has train_lp_path's counts and the others one encode
    fewer. A bf16 case (basis): the encoder's K4 both ways and the encode
    run K4's bf16 form, the decoder's K4 its f32 form."""
    e = spec["epochs"]
    if spec["kind"] == "nc":
        return launches(**(train_pair_path(e) if spec["pairs"] else train_k3_branch(e)))
    counts = train_lp_path(spec["decomposition"], e)
    if rank != 0:
        for name in (("k4_weighted_aggregate",) if spec["decomposition"] == "basis"
                     else ("k3_messages", "k1_aggregate")):
            counts[name] -= 1
    if spec.get("bf16"):
        counts["k4_weighted_aggregate"] = 2 * e
        counts["k4_weighted_aggregate_bf16"] = 2 * e + (rank == 0)
    return launches(**counts)


def check_sharded(key, spec, ranks, ref, backend) -> dict:
    """Phase 22's gates for one case; returns its summary row. A bf16 case
    (``spec["bf16"]``, on the card's default edge stage) is held to the
    CPU's one-device run with the edge stage pinned to bf16: every loss
    within 8e-3 * max(1, |ref|) and the MRR within 1e-3; the share of equal
    ranks is reported, not gated."""
    from rgcn_tpu_torch.dist.multihost import same_on_every_rank

    n = len(ranks)
    cross = same_on_every_rank([{k: v for k, v in r.items()
                                 if k in ("losses", "logits", "ranks", "mrr", "acc")}
                                for r in ranks])
    digests_equal = all(r["digest"] == ranks[0]["digest"] for r in ranks)
    if cross != 0.0 or not digests_equal:
        fail(f"sharded [{key}]: ranks differ from rank 0 (max diff {cross}, parameter "
             f"bits equal: {digests_equal})")
    got, want = np.asarray(ranks[0]["losses"]), np.asarray(ref["losses"])
    if got.shape != want.shape:
        fail(f"sharded [{key}]: {got.shape[0]} losses, one device {want.shape[0]}")
    loss_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    bf16 = bool(spec.get("bf16"))
    if bf16:
        if not (np.abs(got - want) <= BF16_TOL * np.maximum(1.0, np.abs(want))).all():
            fail(f"sharded [{key}]: losses {got.tolist()} vs the CPU's bf16 run "
                 f"{want.tolist()} (tol {BF16_TOL} x max(1, |ref|))")
    elif not loss_rel <= 1e-4:
        fail(f"sharded [{key}]: losses {got.tolist()} vs one device {want.tolist()} "
             f"(max rel diff {loss_rel} > 1e-4)")
    row = {"ranks": n, "backend": backend, "mesh": "x".join(map(str, spec["shape"])),
           "epochs": spec["epochs"], "loss_max_rel_diff": loss_rel,
           "cross_rank_max_diff": cross, "parameter_bits_equal": digests_equal,
           "losses": got.tolist(), "one_device_losses": want.tolist()}
    if spec["kind"] == "nc":
        lg, lr = np.asarray(ranks[0]["logits"]), ref["logits"]
        err = float(np.abs(lg - lr).max())
        tol = 1e-4 * max(1.0, float(np.abs(lr).max()))
        if not (np.isfinite(lg).all() and err <= tol):
            fail(f"sharded [{key}]: final logits max abs diff {err} > {tol}")
        row.update(logits_max_abs_diff=err, logits_tol=tol, acc=ranks[0]["acc"],
                   one_device_acc=ref["acc"])
    else:
        mrr, same = ranks[0]["mrr"], float(np.mean(ranks[0]["ranks"] == ref["ranks"]))
        if not (np.isfinite(mrr) and abs(mrr - ref["mrr"]) <= 1e-3
                and (bf16 or same >= 0.99)):
            fail(f"sharded [{key}]: MRR {mrr} vs one device {ref['mrr']} (tol 1e-3) or "
                 f"ranks equal {same} < 0.99")
        row.update(mrr=mrr, one_device_mrr=ref["mrr"], ranks_equal=same)
    expect = [sharded_expect(spec, r) for r in range(n)]
    counts = [r["launches"] for r in ranks]
    if counts != expect:
        fail(f"sharded [{key}]: per-rank launches {counts}, expected {expect} (the "
             "single-device trainer's on the same per-shard structures)")
    for r, res in enumerate(ranks):
        log(f"  [{key}] rank {r}: set-up {res['setup_s']:.1f} s, fit {res['fit_s']:.1f} s, "
            f"step ms {[round(t, 2) for t in res['step_ms']]}, one all-reduce of "
            f"({spec['data'].num_nodes}, w) {res['collective_ms']:.2f} ms, launches "
            f"{ {k: v for k, v in res['launches'].items() if v} }")
    log(f"  [{key}] {n} ranks ({backend}): losses max rel diff {loss_rel:.3e} vs one "
        f"device (step ms {[round(t, 2) for t in ref['step_ms']]}), cross-rank max diff "
        f"{cross}, parameters bit-equal on every rank")
    row.update(launches=counts, step_ms=[r["step_ms"] for r in ranks],
               one_device_step_ms=ref["step_ms"],
               collective_ms=[r["collective_ms"] for r in ranks],
               setup_s=[r["setup_s"] for r in ranks], fit_s=[r["fit_s"] for r in ranks])
    return row


def phase_sharded(dev, aifb, am, wn18, fb):
    """Phase 22: the edge-sharded trainers on ranks that share the card
    (gloo through host copies), and nc-AIFB on one NCCL rank (and on two
    cards over NCCL where there are two), each case against the port's
    single-device trainer on the card from the same seed; NCCL asked for
    ranks that share a card must raise. Returns (the "sharded" summary,
    each case's per-rank launches)."""
    from rgcn_tpu_torch.dist.multihost import initialize_distributed, spawn

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    try:
        initialize_distributed(0, cards + 1, local_rank=0, local_world_size=cards + 1,
                               backend="nccl", init_method="file:///nonexistent")
    except ValueError as e:
        refusal = str(e)
    else:
        fail("NCCL for ranks that share a card did not raise")
    log(f"phase 22: NCCL for {cards + 1} ranks on {cards} card(s) refused: {refusal}")

    nc = dict(kind="nc", config=CONFIG, data=aifb, epochs=SHARDED_NC_EPOCHS, pairs=False)
    specs = {
        "nc_aifb": dict(nc, shape=(1, 2)),
        "nc_am": dict(kind="nc", config=AM_CONFIG, data=am, epochs=SHARDED_AM_EPOCHS,
                      pairs=True, shape=(1, 2)),
        "lp_wn18": dict(kind="lp", config=LP_CONFIG, data=wn18, epochs=SHARDED_LP_EPOCHS,
                        decomposition="basis", shape=(1, 2)),
        "lp_fb_toy_2x2": dict(kind="lp", config=FB_CONFIG, data=fb,
                              epochs=SHARDED_FB_EPOCHS, decomposition="block",
                              shape=(2, 2)),
        "nc_aifb_nccl_1": dict(nc, shape=(1, 1)),
    }
    # lp-WN18 on the card's default edge stage (bf16), against the CPU's
    # one-device run pinned to bf16
    specs["lp_wn18_bf16"] = dict(specs["lp_wn18"], bf16=True)
    refs = {}
    for key in ("nc_aifb", "nc_am", "lp_wn18", "lp_fb_toy_2x2", "lp_wn18_bf16"):
        if key == "lp_wn18_bf16":
            with edge_stage(torch.bfloat16):
                refs[key] = one_device_reference(specs[key], torch.device("cpu"))
        else:
            refs[key] = one_device_reference(specs[key], dev)
        log(f"  [{key}] one device: {refs[key]['seconds']:.1f} s, losses "
            f"{[round(v, 6) for v in refs[key]['losses']]}")
    refs["nc_aifb_nccl_1"] = refs["nc_aifb"]
    jobs = [("gloo", 2, ["nc_aifb", "nc_am", "lp_wn18", "lp_wn18_bf16"]),
            ("gloo", 4, ["lp_fb_toy_2x2"]), ("nccl", 1, ["nc_aifb_nccl_1"])]
    if cards >= 2:
        specs["nc_aifb_nccl_2"] = dict(nc, shape=(1, 2))
        refs["nc_aifb_nccl_2"] = refs["nc_aifb"]
        jobs.append(("nccl", 2, ["nc_aifb_nccl_2"]))
    else:
        log("  nc-AIFB on 2 ranks over NCCL, one card each: not run (1 card)")
    rows, counts = {}, {}
    torch.cuda.empty_cache()
    for backend, n, keys in jobs:
        t0 = time.perf_counter()
        try:
            ranks = spawn(sharded_rank, n, ([(k, specs[k]) for k in keys],),
                          backend=backend, timeout_s=600)
        except RuntimeError as e:
            fail(f"sharded {keys} on {n} {backend} rank(s): {e}")
        log(f"  {n} {backend} rank(s), cases {keys}: {time.perf_counter() - t0:.1f} s "
            "with the ranks' start")
        for key in keys:
            per_rank = [r[key] for r in ranks]
            rows[key] = check_sharded(key, specs[key], per_rank, refs[key], backend)
            counts[key] = [r["launches"] for r in per_rank]
    seconds = time.perf_counter() - t_phase
    log(f"phase 22 (sharded): {seconds:.1f} s ({card_line()})")
    summary = {"card": card_line(), "seconds": seconds, "cases": rows,
               "nccl_shared_card_refused": refusal,
               "nccl_two_cards": "ran" if cards >= 2 else "not run: 1 card"}
    return summary, counts


TOOLING_NC_EPOCHS = 2  # nc-AIFB under --profile-dir
TOOLING_LP_EPOCHS = 1  # lp-WN18 under --profile-dir: the trace holds every op
TOOLING_TIMER_STEPS = 50  # the canary step under StepTimer
# each launch counter's kernel events in a trace, by the demangled names
# CUPTI records: K1's f32 and bf16 forms run one kernel a call and nothing
# beside it, k1::k1_fixed_kernel<TM, TO, VEC, LPS, P> over a
# destination-sorted layout or csum::chunk_kernel<k1::Rows<TM>, TO, KS>
# over a source-ordered one; K2's two forms csum::chunk_kernel<k2::Msgs<TX,
# VX, DO>, float> alone (no memset); K4's two forms k4_owned.cuh's
# k4o::owned_kernel<TX, TO, NB, PER_BASIS, Cfg> alone; K5 and its bf16 form
# weighted_runs.cuh's templated runs_kernel<TX, TO, VEC, NB, PER_BASIS>
# (beside one zero_shared_rows each, and narrow_shared_rows for a bf16
# output)
TRACE_NAMES = {
    "k1_aggregate+k1_aggregate_bf16": ("k1_fixed_kernel", "chunk_kernel<k1::"),
    "k2_fused+k2_fused_bf16": ("chunk_kernel<k2::",),
    "k3_messages": ("k3_tiled_kernel", "k3_small_kernel"),
    "k4_weighted_aggregate+k5_weighted_aggregate_dedup+k4_weighted_aggregate_bf16"
    "+k5_weighted_aggregate_dedup_bf16": ("runs_kernel<", "k4o::owned_kernel<"),
}


def trace_kernel_events(logdir) -> dict:
    """The kernel events of the one ``*.pt.trace.json`` under ``logdir``,
    counted per TRACE_NAMES key, with the count of all kernel events, of
    the host's launch calls whose kernel the trace lacks, and the file's
    MB, and (under "_by_key") each key's events as (CUPTI correlation id,
    start us, name) for a diagnosis. Fails unless there is
    exactly one trace and it holds a CUDA kernel event."""
    import glob

    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"{logdir}: {len(files)} traces, expected 1")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernel = [e for e in events if e.get("cat") == "kernel"]
    names = [e.get("name", "") for e in kernel]
    if not names:
        fail(f"{files[0]}: the trace holds no CUDA kernel event")
    # host launch calls whose kernel has no record in the trace
    recorded = {e.get("args", {}).get("correlation") for e in kernel}
    orphans = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                  and "Launch" in e.get("name", "")
                  and e.get("args", {}).get("correlation") not in recorded)
    by_key = {key: [(e.get("args", {}).get("correlation"), e.get("ts"), e["name"][:60])
                    for e in kernel if any(s in e.get("name", "") for s in subs)]
              for key, subs in TRACE_NAMES.items()}
    return {"events": {key: len(v) for key, v in by_key.items()},
            "all_kernel_events": len(names), "launches_without_kernel": orphans,
            "trace_mb": os.path.getsize(files[0]) / 2**20, "_by_key": by_key}


def traced_cli(label, main_fn, argv, logdir, need, dev) -> dict:
    """Run a training CLI with ``--profile-dir``, launch counts zeroed just
    before it; each kernel's events in the trace must equal its counter's
    delta, and the kernels in ``need`` must have launched."""
    from rgcn_tpu_torch import kernels

    argv = argv + ["--profile-dir", logdir] + (["--cpu"] if dev.type == "cpu" else [])
    kernels.reset_launches()
    t0 = time.perf_counter()
    main_fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    found = trace_kernel_events(logdir)
    by_key = found.pop("_by_key")
    launched = {key: sum(counts[k] for k in key.split("+")) for key in TRACE_NAMES}
    log(f"tooling [{label}]: {seconds:.1f} s traced; launches {counts}; trace kernel "
        f"events {found['events']} of {found['all_kernel_events']} "
        f"({found['trace_mb']:.1f} MB; {found['launches_without_kernel']} launch calls "
        "without a kernel record)")
    if found["events"] != launched:
        for key, n in launched.items():  # the events of a short key, for a diagnosis
            if found["events"][key] != n:
                print(f"  [{label}] {key}: {n} launches, trace events (correlation, ts, "
                      f"name): {by_key[key]}", file=sys.stderr, flush=True)
        fail(f"tooling [{label}]: trace kernel events {found['events']} != launch "
             f"counters {launched}")
    missing = [k for k in need if counts[k] < 1]
    if missing:
        fail(f"tooling [{label}]: {missing} never launched")
    return dict(found, launches=counts, seconds=seconds)


def phase_tooling(dev):
    """Phase 23: the tooling modules on the card. nc-AIFB and lp-WN18
    trained through their CLIs with --profile-dir (the trace's kernel
    events against the launch counters), the canary measured twice (its
    floor set, then read) with its kernel against the plain version, and
    StepTimer's CUDA events against cuda_ms on the canary step. Returns
    (the "tooling" summary, each path's launches)."""
    import tempfile

    from rgcn_tpu_torch import classify_nodes, kernels, predict_links
    from rgcn_tpu_torch.ops import basis
    from rgcn_tpu_torch.utils import canary
    from rgcn_tpu_torch.utils.profiling import StepTimer

    t_phase = time.perf_counter()
    paths, rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        rows["nc_aifb_traced"] = traced_cli(
            "nc-AIFB", classify_nodes.main,
            ["--config", CONFIG, "--synthetic", "--epochs", str(TOOLING_NC_EPOCHS)],
            os.path.join(tmp, "nc"), ("k1_aggregate", "k2_fused"), dev)
        rows["lp_wn18_traced"] = traced_cli(
            "lp-WN18", predict_links.main,
            ["--config", LP_CONFIG, "--synthetic", "--epochs", str(TOOLING_LP_EPOCHS)],
            os.path.join(tmp, "lp"), ("k1_aggregate", "k4_weighted_aggregate"), dev)
        for key in ("nc_aifb_traced", "lp_wn18_traced"):
            paths[key] = rows[key].pop("launches")

        runs, canary_counts = [], launches()
        for i in range(2):
            kernels.reset_launches()
            runs.append(canary.measure_canary(cache_dir=os.path.join(tmp, "canary"),
                                              tag=f"phase 23, call {i + 1}", device=dev))
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
            if counts != launches(k5_weighted_aggregate_dedup_bf16=runs[-1]["steps"]):
                fail(f"canary call {i + 1}: launches {counts}, expected K5's bf16 "
                     f"form {runs[-1]['steps']} and nothing else")
            canary_counts = {k: canary_counts[k] + counts[k] for k in counts}
    paths["canary"] = canary_counts
    first, second = runs
    if second["key"] != first["key"] or second["ratio"] < 1.0 \
            or second["floor_ms"] != min(first["ms"], second["ms"]):
        fail(f"canary: the second call did not read the first's floor: {first} {second}")

    # one step's K5 against its plain version on the same inputs
    edges, x, pack = canary.build_workload(device=dev)
    m, dd = edges.merged, edges.merged.fwd_dedup
    with basis.full_f32_matmul():
        w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, pack[2]).contiguous()
    err = check_close("canary K5", basis.weighted_aggregate_dedup(
        x, dd.src_sorted, w_k, dd, m.num_nodes), basis.weighted_aggregate_dedup_plain(
        x, dd.src_sorted, w_k, dd, m.num_nodes))
    # the step's own kernel: K5's bf16 form, bf16 table and output, against
    # its plain version's f32 sums (half a bf16 ulp more than the f32 bound)
    xb = x.to(torch.bfloat16)
    got = basis.weighted_aggregate_dedup(xb, dd.src_sorted, w_k, dd, m.num_nodes,
                                         out_dtype=torch.bfloat16).float()
    ref = basis.weighted_aggregate_dedup_plain(xb, dd.src_sorted, w_k, dd, m.num_nodes)
    err_bf16 = (got - ref).abs().max().item()
    if not bool(((got - ref).abs() <= 2.0 ** -8 * ref.abs()
                 + 1e-5 * max(1.0, ref.abs().max().item())).all()):
        fail(f"canary K5 bf16: max abs err {err_bf16} beyond half a bf16 ulp")
    log(f"  canary K5 bf16 (bf16 out): max_abs_err {err_bf16:.3e} against the f32 sums")

    # StepTimer on CUDA events against cuda_ms, the canary step (no speed gate)
    timer = StepTimer(edges_per_step=m.num_pairs, device=dev)
    y = x
    for _ in range(TOOLING_TIMER_STEPS):
        with timer:
            y = canary.canary_step(edges, y, pack)
    timer_ms = timer.mean_s() * 1e3
    step_ms = cuda_ms(lambda: canary.canary_step(edges, x, pack))
    log(f"StepTimer: {timer.summary()}; cuda_ms {step_ms:.4f} ms a step")
    if not 0.5 <= timer_ms / step_ms <= 2.0:
        fail(f"StepTimer's mean {timer_ms} ms is not within 2x of cuda_ms {step_ms}")

    seconds = time.perf_counter() - t_phase
    log(f"phase 23 (tooling): {seconds:.1f} s ({card_line()})")
    summary = {
        "card": card_line(), "seconds": seconds, **rows,
        "canary": {"ms": second["ms"], "floor_ms": second["floor_ms"],
                   "ratio": second["ratio"], "healthy": second["healthy"],
                   "first_ms": first["ms"], "steps_a_call": second["steps"],
                   "k5_max_abs_err": err, "k5_bf16_max_abs_err": err_bf16,
                   "key": json.loads(second["key"])},
        "step_timer": {"mean_ms": timer_ms, "cuda_ms": step_ms,
                       "edges_per_step": m.num_pairs, "edges_per_s": timer.edges_per_s(),
                       "steps": timer.steps},
    }
    return summary, paths


# -- phase 24: an installed copy of the port, built from scratch -------------

INSTALLED_TIMEOUT_S = 600


def chmod_tree(root, writable: bool) -> None:
    """Every file and directory under ``root`` read-only, or back."""
    for d, _, files in os.walk(root):
        for f in files:
            os.chmod(os.path.join(d, f), 0o644 if writable else 0o444)
        os.chmod(d, 0o755 if writable else 0o555)


def tree_stamp(root) -> dict:
    """Every path under ``root`` with its size and mtime."""
    out = {}
    for d, dirs, files in os.walk(root):
        for f in dirs + files:
            st = os.lstat(os.path.join(d, f))
            out[os.path.relpath(os.path.join(d, f), root)] = (st.st_size, st.st_mtime_ns)
    return out
# the child: loads this script by path (not as a module of the checkout) and
# runs installed_child from the copy, which is its cwd and sys.path[0]
INSTALLED_BOOT = (
    "import importlib.util, sys\n"
    "spec = importlib.util.spec_from_file_location('chip_smoke_installed', sys.argv[1])\n"
    "smoke = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(smoke)\n"
    "smoke.installed_child(sys.argv[2], sys.argv[3])\n"
)


def installed_child(out_path, device):
    """Phase 24's child, run with the installed copy as its cwd: neither the
    checkout nor JAX importable. Builds every kernel (the f32 forms and
    the bf16 forms of K1, K4 and K5) and both host libraries from scratch
    into the copy's build/, serves nc-AIFB and lp-WN18 (launch counts
    zeroed just before each) with the edge stage pinned to f32, as the
    checkout's phases 4 and 6 served them, holds K1-K3 on the nc-AIFB
    server's edges and K4, K5 on the lp-WN18 server's, and the bf16 forms
    there, against their plain versions, serves lp-WN18 once more on the
    card's default edge stage (bf16; phase 26 holds its answers to the
    CPU's bf16 run), and pickles the answers to ``out_path``."""
    import pickle

    site = os.path.abspath(os.getcwd())
    on_path = [p for p in sys.path if os.path.abspath(p or os.curdir) == ROOT]
    if on_path:
        fail(f"installed: the checkout {ROOT} is on sys.path")
    sys.modules["jax"] = None
    import rgcn_tpu_torch
    from rgcn_tpu_torch import native
    from rgcn_tpu_torch.kernels import build

    if not os.path.abspath(rgcn_tpu_torch.__file__).startswith(site + os.sep):
        fail(f"installed: rgcn_tpu_torch imported from {rgcn_tpu_torch.__file__}")
    cache = os.path.join(os.environ["XDG_CACHE_HOME"], "rgcn_tpu_torch")
    if not build.BUILD_DIR == native.BUILD_DIR == cache:
        fail(f"installed: the read-only copy builds into {build.BUILD_DIR} and "
             f"{native.BUILD_DIR}, not the user cache {cache}")
    if os.path.exists(build.BUILD_DIR):
        fail(f"installed: {build.BUILD_DIR} exists before the build")
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with edge_stage(None):  # the checkout's phases 4 and 6 served in f32
        got = installed_serve(dev, site)
    got.update(installed_serve_bf16(dev))
    with open(out_path, "wb") as f:
        pickle.dump(got, f)


def installed_serve_bf16(dev) -> dict:
    """lp-WN18 served from the installed copy on the card's default edge
    stage: exactly BF16_SERVE's launches (K4's bf16 form). Returns its
    launches and answers."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.serve import load_lp_server

    wn18 = wn18_like()
    kernels.reset_launches()
    srv = load_lp_server(LP_CONFIG, wn18, device=dev)
    answers = lp_requests(srv, wn18)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"installed serving [lp-WN18, bf16 edge stage]: launches {counts}")
    if counts != launches(**BF16_SERVE["lp_wn18"]):
        fail(f"installed serving [lp-WN18, bf16 edge stage]: launches {counts}, "
             f"expected {launches(**BF16_SERVE['lp_wn18'])}")
    return {"lp_wn18_bf16": {"z": srv.z.cpu(), "answers": answers,
                             "data": data_digest(wn18.train), "launches": counts}}


def installed_serve(dev, site) -> dict:
    """installed_child's builds, serves and kernel checks; returns what the
    child pickles."""
    from concurrent.futures import ThreadPoolExecutor

    from rgcn_tpu_torch import kernels, native
    from rgcn_tpu_torch.data.synthetic import aifb_like, wn18_like
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout
    from rgcn_tpu_torch.kernels import build
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import basis as bs
    from rgcn_tpu_torch.ops import fused as fz
    from rgcn_tpu_torch.ops import rel_spmm as rs
    from rgcn_tpu_torch.serve import load_lp_server, load_nc_server

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(native.build_all)  # g++, beside nvcc
        built = build.build_all()
        host_built = host.result()
    build_s = time.perf_counter() - t0
    cached = [n for n, v in {**built, **host_built}.items() if v["cached"]]
    if cached:
        fail(f"installed: {cached} found built, not built from scratch")
    log(f"installed: {len(built)} kernels and {len(host_built)} host libraries "
        f"built from scratch in {build_s:.1f} s")

    rng = np.random.default_rng(0)

    def rand(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    def serve(label, load, ask, expect):
        kernels.reset_launches()
        t = time.perf_counter()
        srv = load()
        answers = ask(srv)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        log(f"installed serving [{label}]: build + forward + requests "
            f"{time.perf_counter() - t:.2f} s, launches {counts}")
        if counts != launches(**expect):
            fail(f"installed serving [{label}]: launches {counts}, expected "
                 f"{launches(**expect)}")
        return srv, answers, counts

    errs = {}
    aifb = aifb_like()
    requests = nc_requests(aifb)
    nc, nc_answers, nc_counts = serve(
        "nc-AIFB", lambda: load_nc_server(CONFIG, aifb, device=dev),
        lambda srv: [srv.classify(q) for q in requests], MAIN_PATH)
    # K1-K3 at phase 3's nc-AIFB shapes, on the server's edges
    edges, n = nc.edges, aifb.num_nodes
    hidden, classes = 16, aifb.num_classes
    msgs = rand(edges.src.shape[0], hidden) * edges.val[:, None]
    errs["K1"] = check_close("installed K1 aggregate_sorted",
                             agg.aggregate_sorted(msgs, edges.layout, n),
                             agg.aggregate_sorted_plain(msgs, edges.layout, n))
    x = torch.relu(rand(n, hidden))
    w = rand(edges.num_rels, hidden, classes, scale=0.3)
    errs["K2"] = check_close("installed K2 rel_spmm_fused",
                             fz.rel_spmm_fused(edges.fused, n, x, w, compute_dtype=None),
                             fz.rel_spmm_fused_plain(edges.fused, n, x, w))
    errs["K3"] = check_close("installed K3 rel_spmm_messages",
                             rs.rel_spmm_messages(edges, x, w),
                             rs.rel_spmm_messages_plain(edges, x, w))
    m16 = msgs.to(torch.bfloat16)  # K1's bf16 form: f32 sums, so the f32 bound
    errs["K1 bf16"] = check_close("installed K1 bf16 aggregate_sorted",
                                  agg.aggregate_sorted(m16, edges.layout, n),
                                  agg.aggregate_sorted_plain(m16, edges.layout, n))
    # K2's bf16 form (rel_spmm_fused's default): bf16-rounded messages, so
    # phase 27's bound; K3's on bf16 operands with f32 messages: f32 sums
    errs["K2 bf16"] = check_rounded(
        "installed K2 bf16 rel_spmm_fused", fz.rel_spmm_fused(edges.fused, n, x, w),
        fz.rel_spmm_fused_plain(edges.fused, n, x, w, torch.bfloat16),
        fz.rel_spmm_fused_plain(edges.fused, n, x.abs(), w.abs(), torch.bfloat16))
    xb16, wb16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
    errs["K3 bf16"] = check_close(
        "installed K3 bf16 rel_spmm_messages",
        rs.rel_spmm_messages(edges, xb16, wb16, out_dtype=torch.float32),
        rs.rel_spmm_messages_plain(edges, xb16, wb16, torch.float32))
    # the bf16-weight forms (f32 x, bf16 W): f32 sums, the f32 bound
    errs["K2 bf16-W"] = check_close(
        "installed K2 bf16-W rel_spmm_fused",
        fz.rel_spmm_fused(edges.fused, n, x, wb16, compute_dtype=None),
        fz.rel_spmm_fused_plain(edges.fused, n, x, wb16))
    errs["K3 bf16-W"] = check_close(
        "installed K3 bf16-W rel_spmm_messages",
        rs.rel_spmm_messages(edges, x, wb16, out_dtype=torch.float32),
        rs.rel_spmm_messages_plain(edges, x, wb16, torch.float32))

    wn18 = wn18_like()
    lp, lp_answers, lp_counts = serve(
        "lp-WN18", lambda: load_lp_server(LP_CONFIG, wn18, device=dev),
        lambda srv: lp_requests(srv, wn18), LP_MAIN)
    # K4 and K5 at phase 6's lp-WN18 shapes: the server's merged frame, its
    # dedup frame built as main() builds it
    es, m = lp.edges, lp.edges.merged
    n = m.num_nodes
    dedup = build_merged_layout(es.dst.cpu().numpy(), es.src.cpu().numpy(),
                                es.rel.cpu().numpy(), es.val.cpu().numpy(), n,
                                es.num_rels, dedup_k=2).to(dev)
    x = torch.relu(rand(n, 200))
    comps = rand(m.num_rels, 2, scale=0.3)
    wv = bs.merged_wvec(m.coeff, comps)
    errs["K4"] = check_close(
        "installed K4 merged", bs.weighted_aggregate(x, m.src_sorted, wv, m.layout, n),
        bs.weighted_aggregate_plain(x, m.src_sorted, wv, m.layout, n))
    dd = dedup.fwd_dedup
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    errs["K5"] = check_close(
        "installed K5 dedup", bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, n),
        bs.weighted_aggregate_dedup_plain(x, dd.src_sorted, w_k, dd, n))
    xb = x.to(torch.bfloat16)  # the bf16 forms with f32 outputs: the f32 bound
    errs["K4 bf16"] = check_close(
        "installed K4 bf16 merged", bs.weighted_aggregate(xb, m.src_sorted, wv, m.layout, n),
        bs.weighted_aggregate_plain(xb, m.src_sorted, wv, m.layout, n))
    errs["K5 bf16"] = check_close(
        "installed K5 bf16 dedup", bs.weighted_aggregate_dedup(xb, dd.src_sorted, w_k, dd, n),
        bs.weighted_aggregate_dedup_plain(xb, dd.src_sorted, w_k, dd, n))
    torch.cuda.synchronize()

    # every kernel ran from the copy's own libraries, none from the checkout's
    maps = open("/proc/self/maps").read() if dev.type == "cuda" else ""
    if os.path.join(ROOT, "build") in maps:
        fail("installed: a library of the checkout's build/ is mapped")
    unmapped = [n for n, v in built.items() if dev.type == "cuda" and v["path"] not in maps]
    if unmapped:
        fail(f"installed: {unmapped} not loaded from {build.BUILD_DIR}")
    jax_loaded = sorted(k for k, v in sys.modules.items()
                        if (k in ("jax", "rgcn_tpu") or k.startswith(("jax.", "rgcn_tpu.")))
                        and v is not None)
    if jax_loaded:
        fail(f"installed: {jax_loaded} imported")
    return {
        "build_s": build_s,
        "kernels": {n: {"path": v["path"], "build_s": v["seconds"]}
                    for n, v in built.items()},
        "native": {n: {"path": v["path"], "build_s": v["seconds"]}
                   for n, v in host_built.items()},
        "max_abs_err": errs,
        "launches": {"nc_aifb": nc_counts, "lp_wn18": lp_counts},
        "nc_aifb": {"logits": nc.logits, "answers": nc_answers,
                    "data": data_digest(aifb.triples)},
        "lp_wn18": {"z": lp.z.cpu(), "answers": lp_answers,
                    "data": data_digest(wn18.train)},
    }


def check_installed_answers(got, checkout, k=10):
    """The installed copy's served answers against the checkout's
    (``checkout``: phases 4 and 6's) under those phases' tolerances: nc-AIFB logits within 1e-4 and
    classes equal; lp-WN18 z and point scores within 1e-4 and the top-k
    sets equal wherever the checkout's k-th and (k+1)-th scores are more
    than 1e-4 apart. Returns the differences."""
    ref, cur = checkout["nc_aifb"], got["nc_aifb"]
    lref, lcur = checkout["lp_wn18"], got["lp_wn18"]
    if cur["data"] != ref["data"] or lcur["data"] != lref["data"]:
        fail("installed: the synthetic graphs differ from the checkout's")
    nc_diff = float(np.abs(cur["logits"] - ref["logits"]).max())
    for a, b in zip(cur["answers"], ref["answers"]):
        if not np.array_equal(a, b):
            fail(f"installed nc-AIFB: classes {a} != the checkout's {b}")
    dz = float((lcur["z"] - lref["z"]).abs().max())
    ds = float(np.abs(lcur["answers"][0] - lref["answers"][0]).max())
    log(f"  installed vs checkout: nc-AIFB logits {nc_diff:.3e}, lp-WN18 z {dz:.3e}, "
        f"point scores {ds:.3e} (tol 1e-4 each)")
    if not (nc_diff <= 1e-4 and dz <= 1e-4 and ds <= 1e-4):
        fail("installed: served answers differ from the checkout's beyond 1e-4")
    checked = [topk_agree(f"installed lp-WN18 {what}", a[1], b[0], b[1], k)
               for what, a, b in zip(("tails", "heads", "filtered tails"),
                                     lcur["answers"][1:], lref["answers"][1:])]
    log(f"  installed lp-WN18: top-{k} sets equal the checkout's on {checked} of "
        "32 rows each")
    return {"nc_logits": nc_diff, "lp_z": dz, "lp_scores": ds, "topk_rows": checked}


def phase_installed(dev, checkout):
    """Phase 24: ``setup.py build_py`` lays the port out as ``pip install .``
    installs it, into a fresh temporary directory; a child process run
    from there (installed_child) builds and holds every kernel and serves
    nc-AIFB and lp-WN18. The libraries must hash as the checkout's and the
    answers match ``checkout``, what phases 4 and 6 served (``{"nc_aifb":
    ..., "lp_wn18": ...}``). Returns (the "installed" summary, each serve's
    launches, the bf16 lp-WN18 serve's answers for phase 26)."""
    import pickle
    import tempfile

    from rgcn_tpu_torch import native
    from rgcn_tpu_torch.kernels import build

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        site = os.path.join(os.path.realpath(tmp), "site")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "setup.py", "build_py", "-d", site],
                             cwd=ROOT, capture_output=True, text=True, timeout=120)
        build_py_s = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"installed: setup.py build_py failed:\n{out.stdout}{out.stderr}")
        # a read-only install: the builds go to the user cache, the copy
        # stays as it was (no bytecode either)
        cache = os.path.join(os.path.realpath(tmp), "cache")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(XDG_CACHE_HOME=cache, PYTHONDONTWRITEBYTECODE="1")
        result = os.path.join(tmp, "installed.pkl")
        chmod_tree(site, writable=False)
        before = tree_stamp(site)
        try:
            child = subprocess.run(
                [sys.executable, "-c", INSTALLED_BOOT, os.path.abspath(__file__),
                 result, dev.type],
                cwd=site, env=env, capture_output=True, text=True,
                timeout=INSTALLED_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"installed: the child ran past {INSTALLED_TIMEOUT_S} s")
        finally:
            after = tree_stamp(site)
            chmod_tree(site, writable=True)
        if after != before:
            fail(f"installed: the read-only copy changed: "
                 f"{sorted(set(after) ^ set(before))[:10]}")
        for line in child.stdout.splitlines():
            log(f"  | {line}")
        if child.returncode != 0:
            fail(f"installed: the child exited {child.returncode}:\n{child.stderr}")
        with open(result, "rb") as f:
            got = pickle.load(f)
    for kind, libs, path_of in (("kernel", got["kernels"], build.library_path),
                                ("host library", got["native"], native.library_path)):
        for name, lib in libs.items():
            if not lib["path"].startswith(os.path.join(cache, "rgcn_tpu_torch") + os.sep):
                fail(f"installed: {kind} {name} built outside the user cache: "
                     f"{lib['path']}")
            if os.path.basename(lib["path"]) != os.path.basename(path_of(name)):
                fail(f"installed: {kind} {name} is {os.path.basename(lib['path'])}, "
                     f"the checkout's {os.path.basename(path_of(name))}")
    diffs = check_installed_answers(got, checkout)
    bf16 = got.pop("lp_wn18_bf16")
    got["launches"]["lp_wn18_bf16"] = bf16.pop("launches")
    seconds = time.perf_counter() - t_phase
    log(f"phase 24 (installed package): {seconds:.1f} s ({card_line()})")
    short = {"K1": "k1_aggregate", "K2": "k2_fused", "K3": "k3_messages",
             "K4": "k4_weighted_aggregate", "K5": "k5_weighted_aggregate_dedup",
             "K1 bf16": "k1_aggregate_bf16", "K2 bf16": "k2_fused_bf16",
             "K3 bf16": "k3_messages_bf16", "K4 bf16": "k4_weighted_aggregate_bf16",
             "K5 bf16": "k5_weighted_aggregate_dedup_bf16",
             "K2 bf16-W": "k2_fused_wbf16", "K3 bf16-W": "k3_messages_wbf16"}
    summary = {
        "card": card_line(), "seconds": seconds, "build_py_s": build_py_s,
        "build_s": got["build_s"],
        "kernels": {k: {"build_s": got["kernels"][name]["build_s"],
                        "max_abs_err": got["max_abs_err"][k],
                        "library": os.path.basename(got["kernels"][name]["path"]),
                        "launches": {p: c[name] for p, c in got["launches"].items()}}
                    for k, name in short.items()},
        "native": {n: {"build_s": v["build_s"], "library": os.path.basename(v["path"])}
                   for n, v in got["native"].items()},
        "vs_checkout": diffs,
    }
    return summary, got["launches"], bf16


DEVICE_WN18_EPOCHS = 4  # lp-WN18 built on the card
DEVICE_CRGCN_EPOCHS = 2  # c-RGCN lp-WN18, full batch
DEVICE_FB_EPOCHS = 3  # lp-FB-toy
DEVICE_BIASED_EPOCHS = 2  # lp-WN18 with a biased decoder: the assembled batch
DEVICE_FIT_EPOCHS = 4  # each fit of the host-vs-device comparison (two timed)
DEVICE_SHARDED_EPOCHS = 2  # make_sharded_lp_step on 2 ranks sharing the card


def device_lp_path(kind: str, epochs: int) -> dict:
    """Launches of ``epochs`` device-built LP epochs and the final
    evaluation. A step: the encoder's forward and its dx over the reversed
    subgraph (basis: K4 each; block and the c-RGCN's dense R-GCN: K3 then
    K1 each); the layout-free decoder launches nothing. The evaluation
    encodes the whole graph once (basis: K4 over the merged frame; block:
    K3 then K1; c-RGCN: K2)."""
    if kind == "basis":
        return dict(k4_weighted_aggregate=2 * epochs + 1)
    if kind == "block":
        return dict(k3_messages=2 * epochs + 1, k1_aggregate=2 * epochs + 1)
    return dict(k3_messages=2 * epochs, k1_aggregate=2 * epochs, k2_fused=1)


def replay_trainer(cfg, data, card, logger):
    """A CPU trainer of the device-built path whose epochs are built from
    the card trainer's draws of them (the same generators, replayed on the
    card, copied back): the CPU plain run of the card's own draws."""
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    class Replay(LinkPredictionTrainer):
        def set_epoch(self, epoch, host=None):
            pos = torch.as_tensor(self.positives(epoch)).to(card.device)
            self.batch = self.build_epoch(card.draw_epoch(epoch, pos).to("cpu"))

    return Replay(cfg, data, device="cpu", logger=logger, host_graph_build=False)


def device_build_synced(card, epoch):
    """Epoch ``epoch``'s draws and build on the card under
    ``torch.cuda.set_sync_debug_mode("error")`` (the positives moved
    there first): a wait for the card raises. Returns (draws, batch)."""
    pos = torch.as_tensor(card.positives(epoch)).to(card.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        draws = card.draw_epoch(epoch, pos)
        batch = card.build_epoch(draws)
    except RuntimeError as e:
        fail(f"device-built epoch: the build waited for the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return draws, batch


def device_epochs_against_cpu(key, path, data, dev, epochs, edit=None, bf16=False):
    """Train ``path``'s config for ``epochs`` device-built epochs on the
    card through ``fit`` and hold every epoch against the CPU's plain
    versions on the card's own draws (replayed on the card, copied back):
    the epoch-1 EdgeSet (layouts and reverse included) bit-equal to the
    CPU builder's, built with no host sync; at every epoch, from the
    card's parameters of that moment, the loss within rtol 1e-4 and every
    gradient within 1e-5 * max|ref|; the final evaluation's MRR within
    1e-3 of the CPU's evaluation of the card's final parameters (and,
    but for c-RGCN's dense scores, 99% of the ranks equal); exactly
    device_lp_path's launches and no native host-builder call over the
    card's fit (counts zeroed just before it). The CPU is held to the
    card's trajectory, not run on its own: two card runs of the same
    epochs part after ~12 epochs (the kernels' atomics, amplified by the
    training), reported beside the gates. ``edit``: a function of the
    config (phase 21's branches). ``bf16`` (phase 26; a basis config): the
    card on its default edge stage, the CPU pinned to bf16, each loss
    within 8e-3 * max(1, |ref|) and each gradient within 8e-3 * max(1,
    max|ref|), K4's bf16 form 2E + 1 times, the MRR within 1e-3, the share
    of equal ranks reported and no second card run. Returns (launches,
    checks, peak GB)."""
    from rgcn_tpu_torch import kernels, native
    from rgcn_tpu_torch.profile_epoch import batch_differences
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    cfg = epochs_cfg(path, epochs)
    if edit is not None:
        cfg = edit(cfg)
    quiet = records_logger()
    t0 = time.perf_counter()
    card = LinkPredictionTrainer(cfg, data, device=dev, logger=quiet,
                                 host_graph_build=False)
    cpu = replay_trainer(cfg, data, card, quiet)
    draws, batch = device_build_synced(card, 1)
    ref = cpu.build_epoch(draws.to("cpu"))
    diff = batch_differences(batch.edges, ref.edges, "edges")
    if diff:
        fail(f"device-built [{key}]: the card's EdgeSet differs from the CPU "
             f"builder's in {diff}")
    e = batch.edges
    log(f"device-built [{key}] ({epochs} epochs, seed-0 init): N {data.num_nodes}, P "
        f"{batch.positives.shape[0]}, Ns {batch.corrupt_ent.shape[0]}, E_pad "
        f"{e.src.shape[0]} (layout L {e.layout.perm.shape[0]}, row block "
        f"{e.layout.row_block}, chunk {e.layout.chunk}), reverse E_pad "
        f"{e.reverse.src.shape[0]}; EdgeSet bit-equal to the CPU builder's, no sync "
        f"(set-up {time.perf_counter() - t0:.1f} s)")
    del draws, batch, ref

    # every epoch of the card's fit, held against the CPU from the card's
    # parameters of that moment and the card's draws
    rel_diffs, grad_worst, cpu_s = [], 0.0, [0.0]
    card_set_epoch, card_step = card.set_epoch, card.step

    def cpu_stage():
        return edge_stage(torch.bfloat16) if bf16 else contextlib.nullcontext()

    def set_epoch(epoch, host=None):
        card_set_epoch(epoch, host)
        cpu.model.load_state_dict({k: v.detach().cpu()
                                   for k, v in card.model.state_dict().items()})
        t = time.perf_counter()
        cpu.set_epoch(epoch)
        cpu.model.zero_grad(set_to_none=True)
        with cpu_stage():
            loss = cpu.loss()
            loss.backward()
        cpu_s[0] += time.perf_counter() - t
        set_epoch.ref = (epoch, loss.item())

    def step():
        nonlocal grad_worst
        loss = card_step()
        epoch, want = set_epoch.ref
        rel_diffs.append(abs(loss - want) / abs(want))
        loss_tol = BF16_TOL * max(1.0, abs(want)) if bf16 else 1e-4 * abs(want)
        if not abs(loss - want) <= loss_tol:
            fail(f"device-built [{key}]: epoch {epoch} loss {loss} != CPU {want} (tol "
                 f"{loss_tol})")
        ref_grads = dict(cpu.model.named_parameters())
        for pname, p in card.model.named_parameters():
            ref_g = ref_grads[pname].grad
            err = float((p.grad.cpu() - ref_g).abs().max())
            tol = BF16_TOL * max(1.0, float(ref_g.abs().max())) if bf16 \
                else 1e-5 * float(ref_g.abs().max())
            grad_worst = max(grad_worst, err / tol if tol else 0.0)
            if not err <= tol:
                fail(f"device-built [{key}]: epoch {epoch} grad {pname} off by {err} > "
                     f"{tol}")
        return loss

    card.set_epoch, card.step = set_epoch, step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    got = records_logger()
    mrr, hits, ranks = card.fit(got)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, calls = dict(kernels.LAUNCHES), dict(native.CALLS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    kind = ("c-rgcn" if cfg.encoder.model == "c-rgcn"
            else cfg.encoder.decomposition.type)
    expect = launches(**device_lp_path(kind, epochs))
    if bf16:
        expect = launches(k4_weighted_aggregate_bf16=2 * epochs + 1)
    log(f"device-built [{key}]: {epochs} epochs + final evaluation {fit_s:.2f} s (the "
        f"CPU's epochs {cpu_s[0]:.1f} s of it), launches {counts}, native calls {calls}, "
        f"peak memory {peak:.3f} GB")
    if counts != expect:
        fail(f"device-built [{key}]: launches {counts}, expected {expect}")
    if any(calls.values()):
        fail(f"device-built [{key}]: native host builders called {calls}")
    if len(rel_diffs) != epochs:
        fail(f"device-built [{key}]: {len(rel_diffs)} epochs held, expected {epochs}")
    cpu.model.load_state_dict({k: v.detach().cpu()
                               for k, v in card.model.state_dict().items()})
    with cpu_stage():
        ref_mrr, ref_hits, ref_ranks = cpu.evaluate()
    same = float(np.mean(ranks == ref_ranks))
    log(f"  [{key} device-built] per-epoch loss rel diff vs CPU: "
        f"{[float(f'{x:.2e}') for x in rel_diffs]}; gradients at most "
        f"{grad_worst:.3f} of their tolerance")
    log(f"  [{key} device-built] final evaluation: MRR {mrr:.6f} (CPU {ref_mrr:.6f} from "
        f"the card's parameters), Hits@1/3/10 {hits} (CPU {ref_hits}); {same:.4%} of "
        f"{len(ranks)} ranks equal")
    if not (abs(mrr - ref_mrr) <= 1e-3 and np.isfinite(mrr)):
        fail(f"device-built [{key}]: MRR {mrr} vs CPU {ref_mrr} (tol 1e-3)")
    if kind != "c-rgcn" and not bf16 and same < 0.99:
        fail(f"device-built [{key}]: ranks equal {same} < 0.99")
    del cpu
    card_rel = None
    if not bf16:
        # the card's own spread: a second card trainer from the same
        # initialisation over the same draws
        twin = LinkPredictionTrainer(cfg, data, device=dev, logger=quiet,
                                     host_graph_build=False)
        twin_log = records_logger()
        twin.fit(twin_log)
        card_rel = [abs(v - w) / abs(w) for (m, _, v), (_, _, w)
                    in zip(twin_log.records, got.records) if m == "training.loss"]
        log(f"  [{key} device-built] a second card run vs the first, per-epoch loss rel "
            f"diff: {[float(f'{x:.2e}') for x in card_rel]}")
        del twin
    checks = dict(loss_rel_diff=rel_diffs, grad_err_over_tol=grad_worst,
                  card_rerun_rel_diff=card_rel, mrr=mrr, cpu_mrr=ref_mrr,
                  ranks_equal=same, fit_s=fit_s, cpu_s=cpu_s[0],
                  losses=[r[2] for r in got.records if r[0] == "training.loss"])
    return counts, checks, peak


def device_build_ms(key, path, data, dev) -> dict:
    """Device ms of one epoch's draws and build on the card (CUDA events,
    mean of 20 after 3 warm), and one warm device-built step profiled as
    in phase 5 (the layout-free decoder's backward among its kernels)."""
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    card = LinkPredictionTrainer(epochs_cfg(path, 1), data, device=dev,
                                 logger=records_logger(), host_graph_build=False)
    pos = torch.as_tensor(card.positives(1)).to(dev)
    ms = cuda_ms(lambda: card.build_epoch(card.draw_epoch(1, pos)), iters=20, warmup=3)
    draw_ms = cuda_ms(lambda: card.draw_epoch(1, pos), iters=20, warmup=3)
    card.set_epoch(1)
    step = train_step_timing(card)
    del card
    torch.cuda.empty_cache()
    return {"build_ms": ms, "draw_ms": draw_ms, "step": step}


def host_vs_device(dev, configs) -> dict:
    """profile_epoch's fit both ways (the host build with the native
    builders, and built on the card), in turns host, device, device, host,
    from one initialisation: epoch wall ms, step host ms, set_epoch ms,
    busy share, peak memory; losses of the two runs of a way equal."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.models.link_prediction import build_lp_model
    from rgcn_tpu_torch.profile_epoch import fit_epochs

    out = {}
    for key, (path, data) in configs.items():
        cfg = load_experiment(path)
        init = {k: v.detach().clone() for k, v in build_lp_model(
            cfg, data.num_nodes, data.num_relations).state_dict().items()}
        runs = {"host": [], "device": []}
        for way in ("host", "device", "device", "host"):
            r = fit_epochs(cfg, data, dev, True, DEVICE_FIT_EPOCHS, init,
                           host_graph_build=way == "host")
            r.pop("ranks")
            runs[way].append(r)
            torch.cuda.empty_cache()
        for way, (a, b) in runs.items():
            if a["losses"] != b["losses"]:
                worst = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
                log(f"  [{key} {way}] two fits' losses differ by {worst:.3e} relative")
        out[key] = {way: {f: [r[f] for r in rs] for f in (
            "epoch_wall_ms", "step_host_ms", "set_epoch_ms", "device_busy_share",
            "peak_memory_gb")} for way, rs in runs.items()}
        out[key].update(device_build_ms(key, path, data, dev))
        log(f"host vs device [{key}] ({card_line()}): {json.dumps(out[key])}")
    return out


def device_fused_k2(dev, data) -> dict:
    """K2 over the fused layout the card builds for lp-WN18's first epoch
    (with_fused_layout, chunk 128, quantum 16) and its reverse's, at the
    c-RGCN encode's width (x (N, 16), W (2R, 16, 16)), held against the
    plain version and timed as in phase 3; the fused builds' device ms."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.graph.dynamic import build_edge_set_dynamic
    from rgcn_tpu_torch.ops import fused as fz
    from rgcn_tpu_torch.profile_epoch import batch_differences
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    card = LinkPredictionTrainer(epochs_cfg(LP_CONFIG, 1), data, device=dev,
                                 logger=records_logger(), host_graph_build=False)
    pos = torch.as_tensor(card.positives(1)).to(dev)
    draws = card.draw_epoch(1, pos)
    n, rb = data.num_nodes, card.device_row_block

    def build():
        return build_edge_set_dynamic(pos, n, data.num_relations, 128,
                                      keep_mask=draws.keep, with_dst_layout=True,
                                      with_fused_layout=True, row_block=rb)

    es = build()
    build_ms = cuda_ms(build, iters=10, warmup=2)
    cpu_es = build_edge_set_dynamic(pos.cpu(), n, data.num_relations, 128,
                                    keep_mask=draws.keep.cpu(), with_dst_layout=True,
                                    with_fused_layout=True, row_block=rb)
    diff = batch_differences(es.fused, cpu_es.fused, "fused") + batch_differences(
        es.reverse.fused, cpu_es.reverse.fused, "reverse.fused")
    if diff:
        fail(f"device-built fused layout differs from the CPU builder's in {diff}")
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)).to(dev)
    w = torch.from_numpy((0.3 * rng.standard_normal((es.num_rels, 16, 16))
                          ).astype(np.float32)).to(dev)
    rows = []
    for label, lay in (("forward", es.fused), ("reverse", es.reverse.fused)):
        kernels.reset_launches()
        got = fz.rel_spmm_fused(lay, n, x, w, compute_dtype=None)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["k2_fused"] != 1:
            fail(f"device-built fused [{label}]: K2 launches {kernels.LAUNCHES}")
        err = check_close(f"K2 over the device-built fused layout ({label})", got,
                          fz.rel_spmm_fused_plain(lay, n, x, w))
        ms, call_ms = timed(lambda: fz.rel_spmm_fused(lay, n, x, w, compute_dtype=None))
        plain_ms = device_ms(lambda: fz.rel_spmm_fused_plain(lay, n, x, w))
        real = int((lay.val > 0).sum())
        bnd, by = bound_ms(real * 16 * 4 + nbytes(lay.src, lay.val, lay.local_dst,
                                                  lay.quantum_rel, lay.chunk_block, w)
                           + n * 16 * 4, 2 * real * 16 * 16)
        rows.append({"name": "K2", "mode": f"device-built fused layout, {label}",
                     "max_abs_err": err, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                     "slots": int(lay.src.shape[0]), "real_slots": real,
                     "row_block": lay.row_block, "chunk": lay.chunk,
                     "quantum": lay.quantum})
    del card
    return {"fused_build_ms": build_ms, "k2": rows}


def device_sharded_rank(dev, cfg, num_nodes, num_rels, init, positives):
    """One rank of phase 25's sharded case: make_sharded_lp_step over a
    1x2 mesh, one step an epoch from the epoch's generators, launches
    counted from 0 before the first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with edge_stage(None):  # a spawned rank: phase 25 compares f32 paths
        return device_sharded_steps(dev, cfg, num_nodes, num_rels, init, positives)


def device_sharded_steps(dev, cfg, num_nodes, num_rels, init, positives):
    """device_sharded_rank's steps."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.dist.multihost import make_mesh_2d
    from rgcn_tpu_torch.dist.train import make_sharded_lp_step
    from rgcn_tpu_torch.models.link_prediction import build_lp_model
    from rgcn_tpu_torch.train.link_prediction import epoch_generator
    from rgcn_tpu_torch.train.optim import make_optimizer

    mesh = make_mesh_2d(1, 2, device=dev)
    model = build_lp_model(cfg, num_nodes, num_rels, group=mesh.group,
                           decoder_group=mesh.decoder_group).to(dev)
    model.load_state_dict(init)
    ed = cfg.encoder.edge_dropout
    step = make_sharded_lp_step(
        model, make_optimizer(model.parameters(), "sgd", 0.01),
        mesh, num_nodes, num_rels, 128, cfg.training.negative_sampling.sampling_rate,
        cfg.training.negative_sampling.head_prob, general_dropout=ed.general,
        decoder_l2_weight=cfg.decoder.l2_penalty)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out, times = {}, []
    for epoch, pos in positives.items():
        gens = [epoch_generator(0, epoch, s, dev) for s in (7, 11, 13)]
        t0 = time.perf_counter()
        loss = step(torch.as_tensor(pos).to(dev), gens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        out[f"epoch{epoch}"] = {
            "loss": loss.cpu(),
            **{k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            **{f"grad.{k}": p.grad.detach().cpu().clone()
               for k, p in model.named_parameters()}}
    out["launches"] = dict(kernels.LAUNCHES)
    out["step_ms"] = times
    return out


def device_sharded(dev, data) -> dict:
    """make_sharded_lp_step for lp-WN18 at full width on 2 gloo ranks
    sharing the card, DEVICE_SHARDED_EPOCHS steps: the ranks bit-equal,
    each rank exactly K4 2E (its shard's forward and dx), and within 1e-5
    of the single-device device-built trainer on the card from the same
    generators: loss rtol 1e-5, every gradient and every parameter after
    the step 1e-5 * max(1, max|ref|) (the relations' gradient sums 330,000
    cancelling terms, in another order on each side). Both step with SGD
    (lr 0.01), as tests/test_torch_dist_lp.py does: the config's Adam
    turns the f32 reassociation of gradient entries near 0 into
    parameter differences up to its learning rate."""
    from rgcn_tpu_torch.dist.multihost import same_on_every_rank, spawn
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer
    from rgcn_tpu_torch.train.optim import make_optimizer

    t0 = time.perf_counter()
    cfg = epochs_cfg(LP_CONFIG, DEVICE_SHARDED_EPOCHS)
    one = LinkPredictionTrainer(cfg, data, device=dev, logger=records_logger(),
                                host_graph_build=False)
    one.optimizer = make_optimizer(one.model.parameters(), "sgd", 0.01)
    init = {k: v.detach().cpu().clone() for k, v in one.model.state_dict().items()}
    positives = {e: one.positives(e) for e in range(1, DEVICE_SHARDED_EPOCHS + 1)}
    try:
        ranks = spawn(device_sharded_rank, 2,
                      (cfg, data.num_nodes, data.num_relations, init, positives),
                      backend="gloo", timeout_s=600)
    except RuntimeError as e:
        fail(f"device-built sharded on 2 gloo ranks: {e}")
    cross = same_on_every_rank([{k: v for k, v in r.items() if k.startswith("epoch")}
                                for r in ranks])
    if cross != 0.0:
        fail(f"device-built sharded: ranks differ by {cross}")
    expect = launches(k4_weighted_aggregate=2 * DEVICE_SHARDED_EPOCHS)
    for k, r in enumerate(ranks):
        if r["launches"] != expect:
            fail(f"device-built sharded: rank {k} launches {r['launches']}, "
                 f"expected {expect}")
    worst_loss, worst_param, worst_grad = 0.0, 0.0, 0.0
    for epoch in positives:
        one.set_epoch(epoch, positives[epoch])
        loss = one.step()
        got = ranks[0][f"epoch{epoch}"]
        rel = abs(float(got["loss"]) - loss) / abs(loss)
        worst_loss = max(worst_loss, rel)
        if not rel <= 1e-5:
            fail(f"device-built sharded: epoch {epoch} loss {float(got['loss'])} vs one "
                 f"device {loss} (rtol 1e-5)")
        refs = {k: v.detach().cpu() for k, v in one.model.state_dict().items()}
        refs.update({f"grad.{k}": p.grad.detach().cpu()
                     for k, p in one.model.named_parameters()})
        for k, ref in refs.items():
            err = float((torch.as_tensor(got[k]) - ref).abs().max())
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            if k.startswith("grad."):
                worst_grad = max(worst_grad, err / tol)
            else:
                worst_param = max(worst_param, err / tol)
            if not err <= tol:
                fail(f"device-built sharded: epoch {epoch} {k} off by {err} > {tol}")
    out = {"ranks": 2, "epochs": DEVICE_SHARDED_EPOCHS, "cross_rank_max_diff": cross,
           "loss_max_rel_diff": worst_loss, "param_err_over_tol": worst_param,
           "grad_err_over_tol": worst_grad,
           "launches": [r["launches"] for r in ranks],
           "step_ms": [r["step_ms"] for r in ranks],
           "seconds": time.perf_counter() - t0}
    log(f"device-built sharded lp-WN18 (2 gloo ranks on one card): {json.dumps(out)}")
    return out


def phase_device_epochs(dev, wn18, fb):
    """Phase 25: LP epochs built on the card (host_graph_build=False).
    Returns (the "device_epochs" summary, each path's launches, the
    host_vs_device_epoch_ms line)."""
    t_phase = time.perf_counter()
    paths, checks, peaks = {}, {}, {}
    for key, path, data, epochs, edit in (
            ("lp_wn18_device", LP_CONFIG, wn18, DEVICE_WN18_EPOCHS, None),
            ("crgcn_lp_wn18_device", C_WN18_CONFIG, wn18, DEVICE_CRGCN_EPOCHS, None),
            ("lp_fb_toy_device", FB_CONFIG, fb, DEVICE_FB_EPOCHS, None),
            ("lp_wn18_biased_device", LP_CONFIG, wn18, DEVICE_BIASED_EPOCHS, lp_biased)):
        paths[key], checks[key], peaks[key] = device_epochs_against_cpu(
            key, path, data, dev, epochs, edit)
        torch.cuda.empty_cache()
    fused = device_fused_k2(dev, wn18)
    sharded = device_sharded(dev, wn18)
    timing = host_vs_device(dev, {"lp_wn18": (LP_CONFIG, wn18),
                                  "crgcn_lp_wn18": (C_WN18_CONFIG, wn18)})
    seconds = time.perf_counter() - t_phase
    log(f"phase 25 (device-built LP epochs): {seconds:.1f} s ({card_line()})")
    summary = {"card": card_line(), "seconds": seconds, "checks": checks,
               "peak_memory_gb": peaks, "fused": fused, "sharded": sharded}
    return summary, paths, {"card": card_line(), **timing}


# -- phase 26: the edge stage in bf16, the card's default ---------------------

PRECISION_LP_EPOCHS = 2  # lp-WN18 on the default (bf16) path: finite, trained twice
DEVICE_BF16_EPOCHS = 2  # device-built lp-WN18 epochs on the default path
# the JAX package's bf16 bound (tests/test_basis.py:58): x max(1, max|ref|)
BF16_TOL = 8e-3
# serving on the default path (one forward or encode): where a branch
# reaches K1, K4 or K5 with a bf16 operand, its bf16 form runs; nc-MUTAG's
# per-tile contraction gathers a bf16 table but hands K1 f32 messages
BF16_SERVE = {
    "lp_wn18": dict(k4_weighted_aggregate_bf16=1),
    "lp_wn18_dedup": dict(k5_weighted_aggregate_dedup_bf16=1),
    "nc_mutag": dict(k1_aggregate=1, k2_fused=1),
    "nc_am_basis4": dict(k4_weighted_aggregate_bf16=2),
    "ergcn_nc_aifb": dict(k1_aggregate_bf16=1, k2_fused=1),
    "ergcn_nc_am": dict(k1_aggregate_bf16=1, k1_aggregate=1, k3_messages=1),
}
# one training step (loss and backward) on the default path: the few-basis
# layers' K4 both ways and the diagonal layer's K1 both ways in bf16; the
# pair branches' f32 pair messages through K1 both ways, their bf16
# tables' gradient by K1's bf16 form; the LP decoder's K4 in bf16 only
# with decoder.bwd_dtype
BF16_STEP = {
    "nc_aifb_basis4": dict(k4_weighted_aggregate_bf16=4),
    "nc_mutag": dict(k1_aggregate=4, k1_aggregate_bf16=2),
    "ergcn_nc_aifb": dict(k1_aggregate_bf16=2, k2_fused=2),
    "ergcn_nc_am": dict(k1_aggregate_bf16=2, k1_aggregate=2, k3_messages=2),
    "lp_wn18": dict(k4_weighted_aggregate_bf16=2, k4_weighted_aggregate=2,
                    k1_aggregate=2),
    "lp_wn18_bwd_bf16": dict(k4_weighted_aggregate_bf16=4, k1_aggregate=2),
}
BF16_SOURCES = {
    "K1 bf16": ("k1_aggregate_bf16.cu", "rgcn_tpu/ops/pallas_aggregate.py:203"),
    "K1 bf16-out": ("k1_aggregate.cuh", "rgcn_tpu/ops/pallas_aggregate.py:203"),
    "K2 bf16": ("k2_fused_bf16.cu", "rgcn_tpu/ops/pallas_fused.py:355"),
    "K3 bf16": ("k3_messages_bf16.cu", "rgcn_tpu/ops/pallas_spmm.py:70"),
    "K4 bf16": ("k4_weighted_aggregate_bf16.cu", "rgcn_tpu/ops/pallas_basis.py:53"),
    "K4 bf16 owned": ("k4_owned.cuh", "rgcn_tpu/ops/pallas_basis.py:53"),
    "K5 bf16": ("k5_weighted_aggregate_dedup_bf16.cu", "rgcn_tpu/ops/pallas_basis.py:188"),
    "K2 bf16-W": ("k2_fused_wbf16.cu", "rgcn_tpu/ops/pallas_fused.py:339"),
    "K3 bf16-W": ("k3_messages_wbf16.cu", "rgcn_tpu/ops/pallas_spmm.py:53"),
}


@contextlib.contextmanager
def edge_stage(dtype):
    """The layers' edge-stage compute dtype pinned to ``dtype`` (None: f32)
    for the block's length. Phases 3-25 run pinned to f32 (their spawned
    ranks and phase 24's child pin their f32 cases themselves), so each
    gate compares what it compared before the card's bf16 edge stage. The
    bf16 default runs unpinned: phase 26, phase 22's lp_wn18_bf16 case and
    the child's second lp-WN18 serve; their CPU references are pinned to
    bf16."""
    from unittest import mock

    from rgcn_tpu_torch.nn import layers

    with mock.patch.object(layers, "_edge_compute_dtype", lambda device: dtype):
        yield


def bf16_close(label, got, ref, floor=1.0, f32=None) -> float:
    """A bf16-path answer against the CPU's bf16 run: max abs diff within
    8e-3 * max(floor, max|ref|). With ``f32``, the same answer on the card
    with the edge stage pinned to f32: also within a quarter of the f32
    answer's distance from ``ref``, plus the f32 kernels' 1e-5 * max(1,
    max|ref|) for what does not pass the edge stage. An op that rounded at
    other places than the CPU's bf16 run lands about as far off as f32."""
    got, ref = torch.as_tensor(got).float().cpu(), torch.as_tensor(ref).float().cpu()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{label}: {tuple(got.shape)} (finite {bool(torch.isfinite(got).all())}) "
             f"against {tuple(ref.shape)}")
    err = (got - ref).abs().max().item()
    tol = BF16_TOL * max(floor, ref.abs().max().item())
    near = ""
    if f32 is not None:
        gap = (torch.as_tensor(f32).float().cpu() - ref).abs().max().item()
        near_tol = 0.25 * gap + 1e-5 * max(1.0, ref.abs().max().item())
        near = f", f32 {gap:.3e} off (tol {near_tol:.3e})"
        if not err <= near_tol:
            fail(f"{label}: bf16 answers {err} from the CPU's bf16 run, not nearer than "
                 f"a quarter of the f32 answers' {gap} (+ 1e-5 * max(1, max|ref|))")
    log(f"  {label}: max abs diff {err:.3e} (tol {tol:.3e}){near}")
    if not err <= tol:
        fail(f"{label}: bf16 answers differ from the CPU's bf16 run by {err} > {tol}")
    return err


def bf16_kernel_row(name, label, call, ref32, f32_call, k_bytes, flops, library,
                    rounded=None, peak_flops=PEAK_F32_FLOPS):
    """A bf16 form against its plain version's f32 sums on the same inputs
    (``ref32``): an f32 output within the f32 kernels' 1e-5 * max(1,
    max|ref|) (the products are exact, only the order of the sums
    differs), a bf16 output within half a bf16 ulp more (2^-8 * |ref|);
    ``rounded``: the plain sums of the magnitudes of bf16-rounded messages
    (K2's), each of which may round to the neighbouring bf16 value where
    the two f32 sums straddle a rounding boundary (2^-8 * rounded more).
    The form and its f32 form at the same shape (``f32_call``) timed in
    turns, its plain version and the yardstick as in phase 3; the bound's
    operations at ``peak_flops``. ``library``: (call, None) or (None, why
    there is none). One kernel_check row."""
    got = call()
    ref = ref32()
    torch.cuda.synchronize()
    err_t = (got.float() - ref).abs()
    err = err_t.max().item()
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    bf16_out = got.dtype == torch.bfloat16
    if bf16_out:
        ok = bool((err_t <= (2.0 ** -8) * ref.abs() + tol).all())
    elif rounded is not None:
        ok = bool((err_t <= (2.0 ** -8) * rounded() + tol).all())
    else:
        ok = err <= tol
    log(f"  {label}: max_abs_err {err:.3e} against the f32 sums (tol "
        f"{'2^-8 |ref| + ' if bf16_out else '2^-8 sum|msg| + ' if rounded else ''}"
        f"{tol:.3e})")
    if not ok or not torch.isfinite(got).all():
        fail(f"{label}: the bf16 form differs from its plain version")
    # the form and its f32 form in turns (form, f32, f32, form), each the
    # mean of its two
    first, f32_a, f32_b, last = timed(call), timed(f32_call), timed(f32_call), timed(call)
    ms, call_ms = ((a + b) / 2 for a, b in zip(first, last))
    f32_ms, f32_call_ms = ((a + b) / 2 for a, b in zip(f32_a, f32_b))
    plain_ms, plain_call = timed(ref32)
    lib, why = library
    lib_ms = lib_call = None
    if lib is not None:
        lib_ms, lib_call = timed(lib)
    bound, by = bound_ms(k_bytes, flops, peak_flops)
    src, replaces = BF16_SOURCES[name]
    row = dict(name=name, mode=label, route="cuda",
               source=f"rgcn_tpu_torch/kernels/csrc/{src}", replaces=replaces,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, f32_form_ms=f32_ms,
               library_ms=lib_ms, library_note=why, bound_ms=bound, bound_by=by,
               call_ms=call_ms, plain_call_ms=plain_call, f32_form_call_ms=f32_call_ms,
               library_call_ms=lib_call)
    log(json.dumps({"kernel_check": row}))
    return row


def bf16_sparse_mm(rows, cols, vals, shape, dense):
    """torch.sparse.mm of a bf16 CSR with a bf16 dense operand, the
    yardstick of K4's and K5's bf16 forms: (call, None), or (None, the
    reason) where torch refuses it on the card."""
    try:
        a = lp_csr(rows, cols, vals.to(torch.bfloat16), shape)
        torch.sparse.mm(a, dense)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        why = str(e).strip().splitlines()[0][:200]
        log(f"  torch.sparse.mm in bf16 refused: {why}")
        return None, f"torch.sparse.mm refuses a bf16 CSR on the card: {why}"
    return (lambda: torch.sparse.mm(a, dense)), None


def precision_kernels(dev, lp_edges, dedup, am_es):
    """K4 (merged frame, f32 and bf16 outputs; per-basis tables summed over
    bases over the merged reverse frame), K5 (dedup frame) and K1 (e-RGCN
    nc-AM's diagonal messages in slot order) in bf16 at the lp-WN18 and
    AM shapes against their plain versions, each timed beside its f32
    form. Returns the rows."""
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import basis as bs
    from rgcn_tpu_torch.ops import diag as dg

    bf16 = torch.bfloat16
    rng = np.random.default_rng(26)

    def rand(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    m = lp_edges.merged
    n, din, nb = m.num_nodes, 200, 2
    comps = rand(m.num_rels, nb, scale=0.3)
    x = torch.relu(rand(n, din))
    xb = x.to(bf16)
    rows = []
    log("kernels in bf16 (lp-WN18 and nc-AM shapes):")

    def k4_bytes(src, layout, tables, out):
        keep = layout.local_dst.reshape(-1) < layout.row_block
        real = int(keep.sum().item())
        n_rows = int(torch.unique(src[keep]).numel())
        return real, real * (4 + nb * 4) + nbytes(layout.local_dst, layout.chunk_block) \
            + tables * n_rows * din * 2 + out.numel() * out.element_size()

    lay = m.layout
    w = bs.merged_wvec(m.coeff, comps)
    keep = lay.local_dst.reshape(-1) < lay.row_block
    node, src_k = slot_nodes(lay, lay.local_dst)[keep], m.src_sorted.long()[keep]
    for out_dtype, tag in ((bf16, "bf16 out: the forward's Agg"),
                           (torch.float32, "f32 out")):
        def call(out_dtype=out_dtype):
            return bs.weighted_aggregate(xb, m.src_sorted, w, lay, n, out_dtype=out_dtype)

        out = call()
        real, k_bytes = k4_bytes(m.src_sorted, lay, 1, out)
        lib = bf16_sparse_mm(torch.cat([b * n + node for b in range(nb)]), src_k.repeat(nb),
                             w[:, keep].reshape(-1), (nb * n, n), xb) \
            if out_dtype == bf16 else (None, "the bf16 sparse.mm writes bf16: see the bf16-out row")
        rows.append(bf16_kernel_row(
            "K4 bf16", f"K4 bf16 merged ({tag})", call,
            lambda: bs.weighted_aggregate_plain(xb, m.src_sorted, w, lay, n),
            lambda: bs.weighted_aggregate(x, m.src_sorted, w, lay, n),
            k_bytes, 2 * nb * real * din, lib))

    # per-basis cotangent tables G summed over bases, the basis VJP's dx, over
    # the merged reverse frame
    G = rand(nb, n, din, scale=0.1).to(bf16)
    rlay, rw = m.rev_layout, bs.merged_wvec(m.rev_coeff, comps)
    out = bs.weighted_aggregate(G, m.rev_src_sorted, rw, rlay, n, sum_bases=True,
                                out_dtype=bf16)
    real, k_bytes = k4_bytes(m.rev_src_sorted, rlay, nb, out)
    rkeep = rlay.local_dst.reshape(-1) < rlay.row_block
    rnode, rsrc = slot_nodes(rlay, rlay.local_dst)[rkeep], m.rev_src_sorted.long()[rkeep]
    rows.append(bf16_kernel_row(
        "K4 bf16", "K4 bf16 per-basis sum_bases (bf16 out: the VJP's dx)",
        lambda: bs.weighted_aggregate(G, m.rev_src_sorted, rw, rlay, n, sum_bases=True,
                                      out_dtype=bf16),
        lambda: bs.weighted_aggregate_plain(G, m.rev_src_sorted, rw, rlay, n,
                                            sum_bases=True),
        lambda: bs.weighted_aggregate(G.float(), m.rev_src_sorted, rw, rlay, n,
                                      sum_bases=True),
        k_bytes, 2 * nb * real * din,
        bf16_sparse_mm(rnode.repeat(nb), torch.cat([b * n + rsrc for b in range(nb)]),
                       rw[:, rkeep].reshape(-1), (n, nb * n), G.reshape(nb * n, din))))

    # K4's owned-row kernel (k4_owned.cuh, every layout's) on nc-AIFB's
    # 4-basis layouts: layer 2's Agg
    # over the merged frame, hidden 16, 4 bases, bf16 out
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.data.synthetic import aifb_like
    from rgcn_tpu_torch.graph.structure import build_edge_set

    aifb = aifb_like()
    am4 = build_edge_set(aifb.triples, aifb.num_nodes, aifb.num_relations, tile_size=128,
                         with_dst_layout=True, with_merged_layout=True).to(dev).merged
    na, ha, nba = am4.num_nodes, 16, 4
    xa16 = torch.relu(rand(na, ha)).to(bf16)
    wa = bs.merged_wvec(am4.coeff, rand(am4.num_rels, nba, scale=0.3))
    alay4 = am4.layout
    if kernels.k4_piece(ha, xa16.data_ptr(), 2) != 8:
        fail("K4 bf16 at nc-AIFB with 4 bases: not whole 16-byte vectors")
    oa = bs.weighted_aggregate(xa16, am4.src_sorted, wa, alay4, na, out_dtype=bf16)
    akeep4 = alay4.local_dst.reshape(-1) < alay4.row_block
    a_real4 = int(akeep4.sum().item())
    oa_bytes = a_real4 * (4 + nba * 4) + nbytes(alay4.local_dst, alay4.chunk_block) \
        + int(torch.unique(am4.src_sorted[akeep4]).numel()) * ha * 2 + oa.numel() * 2
    rows.append(bf16_kernel_row(
        "K4 bf16 owned", "K4 bf16 owned-row kernel, nc-AIFB layer 2 with 4 bases (bf16 out)",
        lambda: bs.weighted_aggregate(xa16, am4.src_sorted, wa, alay4, na, out_dtype=bf16),
        lambda: bs.weighted_aggregate_plain(xa16, am4.src_sorted, wa, alay4, na),
        lambda: bs.weighted_aggregate(xa16.float(), am4.src_sorted, wa, alay4, na),
        oa_bytes, 2 * nba * a_real4 * ha,
        bf16_sparse_mm(torch.cat([b * na + slot_nodes(alay4, alay4.local_dst)[akeep4]
                                  for b in range(nba)]),
                       am4.src_sorted.long()[akeep4].repeat(nba), wa[:, akeep4].reshape(-1),
                       (nba * na, na), xa16)))

    # K5 over the source-dedup'd frame, bf16 out (the dedup forward's Agg)
    dd = dedup.fwd_dedup
    w_k = torch.einsum("klr,rb->kbl", dd.coeff_k, comps).contiguous()
    lanes = dd.local_k.reshape(dd.num_k, -1) < dd.row_block
    real_slots = lanes.any(0)
    n_lanes = int(lanes.sum().item())
    out = bs.weighted_aggregate_dedup(xb, dd.src_sorted, w_k, dd, n, out_dtype=bf16)
    n_rows = int(torch.unique(dd.src_sorted[real_slots]).numel())
    k5_bytes = int(real_slots.sum().item()) * 4 + n_lanes * nb * 4 \
        + nbytes(dd.local_k, dd.chunk_block) + n_rows * din * 2 + out.numel() * 2
    lr, lc, lv = [], [], []
    for k in range(dd.num_k):
        kp = lanes[k]
        nd = slot_nodes(dd, dd.local_k[k])[kp]
        for b in range(nb):
            lr.append(b * n + nd)
            lc.append(dd.src_sorted.long()[kp])
            lv.append(w_k[k, b][kp])
    rows.append(bf16_kernel_row(
        "K5 bf16", "K5 bf16 dedup (bf16 out)",
        lambda: bs.weighted_aggregate_dedup(xb, dd.src_sorted, w_k, dd, n, out_dtype=bf16),
        lambda: bs.weighted_aggregate_dedup_plain(xb, dd.src_sorted, w_k, dd, n),
        lambda: bs.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, n),
        k5_bytes, 2 * nb * n_lanes * din,
        bf16_sparse_mm(torch.cat(lr), torch.cat(lc), torch.cat(lv), (nb * n, n), xb)))

    # K1 over e-RGCN nc-AM's diagonal messages (slot order, d 32), f32 out
    d = 32
    xa, dw = rand(am_es.num_nodes, d), rand(am_es.num_rels, d, scale=0.5)
    msgs = dg.diag_slot_messages(xa, dw, am_es, compute_dtype=bf16)
    msgs32 = dg.diag_slot_messages(xa, dw, am_es)
    alay = am_es.layout
    akeep = alay.local_dst.reshape(-1) < alay.row_block
    a_real = int(akeep.sum().item())
    k1_bytes = a_real * d * 2 + nbytes(alay.local_dst, alay.chunk_block) \
        + am_es.num_nodes * d * 4
    rows.append(bf16_kernel_row(
        "K1 bf16", "K1 bf16 e-RGCN nc-AM diagonal messages (f32 out)",
        lambda: agg.aggregate_presorted(msgs, alay, am_es.num_nodes),
        lambda: agg.aggregate_presorted_plain(msgs, alay, am_es.num_nodes),
        lambda: agg.aggregate_presorted(msgs32, alay, am_es.num_nodes),
        k1_bytes, a_real * d,
        (None, "index_add_ writes the messages' dtype: no one call sums bf16 rows "
               "into f32")))
    return rows


def cpu_server(srv, kind, **kw):
    """The card server's model and EdgeSet on the CPU (no second graph
    build), served with the edge stage pinned to bf16."""
    import copy

    from rgcn_tpu_torch.serve import LinkPredictionServer, NodeClassificationServer

    model = copy.deepcopy(srv.model).cpu()
    with edge_stage(torch.bfloat16):
        if kind == "nc":
            return NodeClassificationServer(model, srv.edges.to("cpu"))
        return LinkPredictionServer(model, srv.edges.to("cpu"), **kw)


def precision_serving(dev, lp, dedup, am_data, installed):
    """Serving on the default path (bf16 edge stage): lp-WN18 (merged frame,
    and its dedup frame), nc-MUTAG (stand-in), nc-AM with 4 bases and e-RGCN
    nc-AM at AM scale on am_like()'s triples, e-RGCN nc-AIFB; exact
    launches (BF16_SERVE); answers within 8e-3 * max(1, max|ref|) of the
    CPU's bf16 run of the same model and EdgeSet, z and logits nearer it
    than the same server's f32 answers (edge stage pinned to f32;
    bf16_close); the gap to those and both serve times. ``installed``:
    phase 24's lp-WN18 served from the installed copy on its default path,
    held to the same CPU run. Returns (launches, timing, gaps, the e-RGCN
    nc-AM EdgeSet)."""
    from rgcn_tpu_torch.config import DecompositionConfig, load_experiment
    from rgcn_tpu_torch.data.synthetic import aifb_like, synthetic_nc_data
    from rgcn_tpu_torch.serve import LinkPredictionServer, load_lp_server, load_nc_server

    paths, timing, gaps = {}, {}, {}
    train = np.asarray(lp.train, dtype=np.int64)
    width = load_experiment(LP_CONFIG).encoder.node_embedding

    def both_ms(key, srv):
        timing[f"{key}_bf16_ms"] = host_ms(srv.refresh, iters=10)
        with edge_stage(None):
            timing[f"{key}_f32_ms"] = host_ms(srv.refresh, iters=10)
            out32 = srv.z.clone() if hasattr(srv, "z") else srv.logits.copy()
        srv.refresh()
        return out32

    srv, answers, paths["lp_wn18"] = lp_path(
        "lp_wn18 (bf16 edge stage)", lambda: load_lp_server(LP_CONFIG, lp, device=dev),
        lp, BF16_SERVE["lp_wn18"], width)
    dsrv, d_answers, paths["lp_wn18_dedup"] = lp_path(
        "lp_wn18_dedup (bf16 edge stage)",
        lambda: LinkPredictionServer(srv.model, dataclasses.replace(srv.edges, merged=dedup),
                                     known_triples=train),
        lp, BF16_SERVE["lp_wn18_dedup"], width)
    for key, s, ans in (("lp_wn18", srv, answers), ("lp_wn18_dedup", dsrv, d_answers)):
        cpu = cpu_server(s, "lp", known_triples=train)
        with edge_stage(torch.bfloat16):
            cpu_ans = lp_requests(cpu, lp)
        z32 = both_ms(key, s)
        bf16_close(f"[{key}] z vs CPU bf16", s.z, cpu.z, f32=z32)
        bf16_close(f"[{key}] point scores vs CPU bf16", ans[0], cpu_ans[0])
        if key == "lp_wn18":
            if installed["data"] != data_digest(lp.train):
                fail("installed lp-WN18 (bf16): the synthetic graph differs from the checkout's")
            bf16_close("[installed lp_wn18] z vs CPU bf16", installed["z"], cpu.z, f32=z32)
            bf16_close("[installed lp_wn18] point scores vs CPU bf16",
                       installed["answers"][0], cpu_ans[0])
        gaps[key] = (s.z - z32).abs().max().item()
        log(f"  [{key}] gap to the f32 encode: max |z - z_f32| {gaps[key]:.3e}")
    del srv, dsrv

    base = load_experiment(AM_CONFIG)
    am4 = dataclasses.replace(base, rgcn=dataclasses.replace(
        base.rgcn, decomposition=DecompositionConfig("basis", num_bases=4)))
    mutag = load_experiment(MUTAG_CONFIG)
    am_es = None
    for key, cfg, data in (
            ("nc_mutag", mutag, synthetic_nc_data(mutag.dataset.name)),
            ("ergcn_nc_aifb", load_experiment(E_AIFB_CONFIG), aifb_like()),
            ("nc_am_basis4", am4, am_data),
            ("ergcn_nc_am", load_experiment(E_AM_CONFIG), am_data)):
        t0 = time.perf_counter()
        requests = nc_requests(data)
        srv, _, paths[key] = serve_path(f"{key} (bf16 edge stage)",
                                        lambda: load_nc_server(cfg, data, device=dev),
                                        requests, BF16_SERVE[key])
        cpu = cpu_server(srv, "nc")
        logits32 = both_ms(key, srv)
        bf16_close(f"[{key}] logits vs CPU bf16", srv.logits, cpu.logits, f32=logits32)
        gaps[key] = float(np.abs(srv.logits - logits32).max())
        agree = float((srv.logits.argmax(-1) == logits32.argmax(-1)).mean())
        log(f"  [{key}] gap to the f32 forward: max abs {gaps[key]:.3e}, argmax "
            f"agreement {agree:.6f} ({time.perf_counter() - t0:.1f} s)")
        if key == "ergcn_nc_am":
            am_es = srv.edges
        del srv, cpu
    log(f"  serve ms on the card, bf16 and f32 edge stage (host clock, median of "
        f"10): {json.dumps(timing)}")
    return paths, timing, gaps, am_es


def step_launches(key, trainer) -> float:
    """One loss and backward on the card with the counts zeroed just
    before; they must equal BF16_STEP[key]. Returns the loss."""
    from rgcn_tpu_torch import kernels

    trainer.optimizer.zero_grad(set_to_none=True)
    kernels.reset_launches()
    loss = trainer.loss()
    loss.backward()
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"training step [{key}] (bf16 edge stage): launches {counts}")
    if counts != launches(**BF16_STEP[key]):
        fail(f"training step [{key}]: launches {counts}, expected "
             f"{launches(**BF16_STEP[key])}")
    return loss.item()


def step_against_cpu(key, card, cpu, floor=1.0) -> dict:
    """``card`` (default path) and ``cpu`` (edge stage pinned to bf16) from
    the same parameters on the same batch: one loss and backward each;
    every gradient within 8e-3 * max(floor, max|ref|) and nearer the CPU's
    than the card's gradient with the edge stage pinned to f32 is
    (bf16_close). Then both step times on the card (loss and backward, host
    clock, median of 10), with the default edge stage and pinned to f32."""
    loss = step_launches(key, card)
    grads = {n: p.grad.detach().clone() for n, p in card.model.named_parameters()}
    with edge_stage(None):
        card.optimizer.zero_grad(set_to_none=True)
        card.loss().backward()
    grads32 = {n: p.grad for n, p in card.model.named_parameters()}
    with edge_stage(torch.bfloat16):
        ref = cpu.loss()
        ref.backward()
    log(f"  [{key}] loss card {loss:.7f}, CPU bf16 {ref.item():.7f}")
    if not abs(loss - ref.item()) <= BF16_TOL * max(1.0, abs(ref.item())):
        fail(f"training step [{key}]: loss {loss} against the CPU's {ref.item()}")
    ref_grads = dict(cpu.model.named_parameters())
    worst = 0.0
    for pname, g in grads.items():
        worst = max(worst, bf16_close(f"[{key}] grad {pname}", g, ref_grads[pname].grad,
                                      floor=floor, f32=grads32[pname]))

    def step():
        card.optimizer.zero_grad(set_to_none=True)
        card.loss().backward()

    out = {"loss": loss, "cpu_loss": ref.item(), "grad_max_abs_diff": worst,
           "step_bf16_ms": host_ms(step, iters=10)}
    with edge_stage(None):
        out["step_f32_ms"] = host_ms(step, iters=10)
    log(f"  [{key}] step (loss + backward) host ms: bf16 {out['step_bf16_ms']:.3f}, "
        f"f32 {out['step_f32_ms']:.3f}")
    return out


def precision_training(dev, lp, am_es, am_data):
    """One training step per compute-dtype branch on the card (default
    path) against the CPU's bf16 step from the same parameters: nc-AIFB
    with 4 bases (the featureless and featureful few-basis layers),
    nc-MUTAG on its stand-in (the pair branches), e-RGCN nc-AIFB (merged
    diagonal layer) and nc-AM at AM scale (unmerged, on the serving
    EdgeSet), lp-WN18 (the training subgraph's basis layer) and lp-WN18
    with decoder.bwd_dtype bfloat16 (its scores bit-equal to the f32
    decoder's); then PRECISION_LP_EPOCHS lp-WN18 epochs on the default
    path with finite losses. Returns the per-step rows."""
    from rgcn_tpu_torch.config import DecompositionConfig, load_experiment
    from rgcn_tpu_torch.data.synthetic import aifb_like, synthetic_nc_data
    from rgcn_tpu_torch.models.node_classification import build_nc_model
    from rgcn_tpu_torch.ops import distmult_train
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer

    def on_edges(edges):
        """The trainer over an EdgeSet built already (the serving one)."""
        class OnServingEdges(NodeClassificationTrainer):
            def edge_set(self, cfg, data, tile_size):
                return edges
        return OnServingEdges

    out = {}
    aifb = aifb_like()
    mutag = load_experiment(MUTAG_CONFIG)
    for key, cfg, data, edges in (
            ("nc_aifb_basis4", nc_branch_cfg(CONFIG, DecompositionConfig("basis", num_bases=4), 1),
             aifb, None),
            ("nc_mutag", mutag, synthetic_nc_data(mutag.dataset.name), None),
            ("ergcn_nc_aifb", load_experiment(E_AIFB_CONFIG), aifb, None),
            ("ergcn_nc_am", load_experiment(E_AM_CONFIG), am_data, am_es)):
        t0 = time.perf_counter()
        init = build_nc_model(cfg, data, seed=0).state_dict()
        cls = NodeClassificationTrainer if edges is None else on_edges(edges)
        card = cls(cfg, data, init_params=init, device=dev)
        cpu = cls(cfg, data, init_params=init, device="cpu")
        out[key] = step_against_cpu(key, card, cpu)
        log(f"  [{key}] {time.perf_counter() - t0:.1f} s")
        del card, cpu

    quiet = records_logger()
    base = load_experiment(LP_CONFIG)
    for key, bwd in (("lp_wn18", None), ("lp_wn18_bwd_bf16", "bfloat16")):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(base, decoder=dataclasses.replace(base.decoder,
                                                                    bwd_dtype=bwd))
        card = LinkPredictionTrainer(cfg, lp, device=dev, logger=quiet)
        state = {k: v.detach().cpu() for k, v in card.model.state_dict().items()}
        cpu = LinkPredictionTrainer(cfg, lp, init_state=state, device="cpu", logger=quiet)
        for t in (card, cpu):
            t.set_epoch(1)
        out[key] = step_against_cpu(key, card, cpu, floor=0.0)
        log(f"  [{key}] {time.perf_counter() - t0:.1f} s")
        if key == "lp_wn18":
            losses = []
            for epoch in range(1, 1 + PRECISION_LP_EPOCHS):
                card.set_epoch(epoch)
                losses.append(card.step())
            log(f"  lp_wn18 on the default path, {PRECISION_LP_EPOCHS} epochs: losses "
                f"{losses}")
            if not np.isfinite(losses).all():
                fail(f"lp_wn18 (bf16 edge stage): losses {losses} not finite")
            out[key]["epoch_losses"] = losses
            out[key]["twice"] = bf16_lp_repeat(cfg, lp, dev, state, card, losses)
        else:
            # the structured scorer's forward under grad, from one encode,
            # with and without the narrow backward: bit-equal
            b = card.batch
            total = b.labels.shape[0]
            pw = torch.full((total,), 1.0 / total, device=dev)
            z = card.model.encode(b.edges, b.self_masks)
            rel = card.model.scoring_function.relations
            scores = [distmult_train.structured_scores(
                b.positives, b.corrupt_head, b.corrupt_ent, z, rel, pw, b.layouts,
                bwd_dtype=bwd) for bwd in (None, torch.bfloat16)]
            same = all(torch.equal(u, v) for u, v in zip(*scores))
            log(f"  [{key}] scores and penalty bit-equal to the f32 decoder's: {same}")
            if not same:
                fail("decoder.bwd_dtype changed the structured scorer's forward")
            out[key]["scores_bit_equal_to_f32"] = same
        del card, cpu
    return out


def bf16_lp_repeat(cfg, data, dev, state, first, losses) -> dict:
    """The bf16 default lp-WN18 epochs trained again on the card from the
    same parameters ``state`` as ``first`` (a fresh trainer, counts zeroed
    just before): the launches of PRECISION_LP_EPOCHS steps (BF16_STEP's
    each) and losses and final parameters bit-equal to ``first``'s."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    again = LinkPredictionTrainer(cfg, data, init_state=state, device=dev,
                                  logger=records_logger())
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = []
    for epoch in range(1, 1 + PRECISION_LP_EPOCHS):
        again.set_epoch(epoch)
        got.append(again.step())
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    want = launches(**{k: PRECISION_LP_EPOCHS * v for k, v in BF16_STEP["lp_wn18"].items()})
    if counts != want:
        fail(f"lp_wn18 (bf16 edge stage) again: launches {counts}, expected {want}")
    state0, state1 = first.model.state_dict(), again.model.state_dict()
    differ = {k: (v - state1[k]).abs().max().item() for k, v in state0.items()
              if not same_bits(v, state1[k])}
    out = {"params_bit_equal": not differ, "losses_equal": got == losses,
           "launches": counts}
    log(f"  lp_wn18 (bf16 edge stage) trained twice from one state: {json.dumps(out)}"
        + (f"; parameters that differ (max abs): {differ}" if differ else ""))
    if not (out["params_bit_equal"] and out["losses_equal"]):
        fail("lp_wn18 (bf16 edge stage): two card runs from one state differ")
    return out


def precision_entry_points(dev, lp, cpu_loss):
    """Entry points of phases 23 and 25 on the card's default edge stage:
    lp-WN18 trained through its CLI for TOOLING_LP_EPOCHS with
    --profile-dir (traced_cli: the trace's kernel events equal the
    counters; K4's bf16 form 2E + 1 times, its f32 form and K1 2E each; the
    first epoch's loss, read from --run-dir's metrics.jsonl, within 8e-3 *
    max(1, |ref|) of ``cpu_loss``, the CPU's bf16 loss at epoch 1 from the
    same initialisation), and DEVICE_BF16_EPOCHS device-built lp-WN18
    epochs held to the CPU pinned to bf16 (device_epochs_against_cpu).
    Returns (each path's launches, the summary)."""
    import tempfile

    from rgcn_tpu_torch import predict_links

    e = TOOLING_LP_EPOCHS
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        traced = traced_cli(
            "lp-WN18 (bf16 edge stage)", predict_links.main,
            ["--config", LP_CONFIG, "--synthetic", "--epochs", str(e), "--run-dir", run_dir],
            os.path.join(tmp, "trace"), ("k4_weighted_aggregate_bf16",), dev)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            losses = [r["value"] for r in map(json.loads, f) if r["metric"] == "training.loss"]
    paths = {"cli_traced_lp_wn18": traced.pop("launches")}
    expect = launches(k4_weighted_aggregate_bf16=2 * e + 1, k4_weighted_aggregate=2 * e,
                      k1_aggregate=2 * e)
    if paths["cli_traced_lp_wn18"] != expect:
        fail(f"traced CLI lp-WN18 (bf16): launches {paths['cli_traced_lp_wn18']}, "
             f"expected {expect}")
    log(f"  traced CLI lp-WN18 (bf16): losses {losses}, the CPU's bf16 epoch 1 {cpu_loss}")
    if len(losses) != e or not abs(losses[0] - cpu_loss) <= BF16_TOL * max(1.0, abs(cpu_loss)):
        fail(f"traced CLI lp-WN18 (bf16): losses {losses} against the CPU's bf16 "
             f"{cpu_loss} at epoch 1")
    traced.update(losses=losses, cpu_loss=cpu_loss)
    paths["device_lp_wn18"], device, peak = device_epochs_against_cpu(
        "lp_wn18_device_bf16", LP_CONFIG, lp, dev, DEVICE_BF16_EPOCHS, bf16=True)
    device["peak_memory_gb"] = peak
    return paths, {"cli_traced_lp_wn18": traced, "device_lp_wn18": device}


def precision_canary(dev) -> dict:
    """The canary once (its bf16 step: exactly K5's bf16 form once a
    step) on a fresh floor."""
    import tempfile

    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.utils import canary

    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        run = canary.measure_canary(cache_dir=tmp, tag="phase 26", device=dev)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    if counts != launches(k5_weighted_aggregate_dedup_bf16=run["steps"]):
        fail(f"canary (bf16): launches {counts}, expected K5's bf16 form "
             f"{run['steps']} and nothing else")
    return {"ms": run["ms"], "steps": run["steps"], "key": json.loads(run["key"]),
            "launches": counts}


def phase_precision(dev, lp, lp_edges, dedup, am_data, installed):
    """Phase 26: the edge stage on the card's default, bf16 (the JAX
    package's compute dtype on a TPU). ``installed``: phase 24's bf16
    lp-WN18 serve. Returns (the "edge_precision" summary, the bf16 kernel
    rows, each path's launches)."""
    t0 = time.perf_counter()
    serve, serve_timing, gaps, am_es = precision_serving(dev, lp, dedup, am_data, installed)
    rows = precision_kernels(dev, lp_edges, dedup, am_es)
    train = precision_training(dev, lp, am_es, am_data)
    del am_es
    entry_paths, entry = precision_entry_points(dev, lp, train["lp_wn18"]["cpu_loss"])
    can = precision_canary(dev)
    seconds = time.perf_counter() - t0
    log(f"phase 26 (edge precision): {seconds:.1f} s ({card_line()})")
    paths = dict(serve)
    paths.update({f"step_{k}": launches(**BF16_STEP[k]) for k in BF16_STEP})
    paths.update(entry_paths)
    paths["canary"] = can.pop("launches")
    summary = {"card": card_line(), "seconds": seconds, "serve_ms": serve_timing,
               "serve_gap_to_f32": gaps, "steps": train, "entry_points": entry,
               "canary": can,
               "kernels": [{k: r[k] for k in ("mode", "max_abs_err", "ms", "f32_form_ms",
                                              "plain_ms", "library_ms", "bound_ms")}
                           for r in rows]}
    return summary, rows, paths


# phase 27's paths, counts zeroed before each: rel_spmm_fused with its
# default (bf16) compute dtype at nc-AIFB layer 2; rel_spmm_full with bf16
# compute at lp-FB-toy (bf16 messages into K1's bf16 form, f32 out); the
# same at nc-AIFB with a bf16 accum_dtype (K1's bf16 output) and
# rel_spmm_pallas with bf16 compute (f32 messages into K1's f32 form)
DTYPE_PATHS = {
    "fused_default": dict(k2_fused_bf16=1),
    "full_bf16_fb_toy": dict(k3_messages_bf16=1, k1_aggregate_bf16=1),
    "full_bf16_accum_bf16": dict(k3_messages_bf16=1, k1_aggregate_bf16=1),
    "pallas_bf16": dict(k3_messages_bf16=1, k1_aggregate=1),
}


def dtype_path(label, call, cpu_call, f32_call=None):
    """Zero the counts, run ``call`` on the card, read the counts (exactly
    DTYPE_PATHS[label]); the answer against the port's CPU run within
    8e-3 * max(1, max|ref|) (and, with ``f32_call``, nearer it than the
    f32 answer on the card). Returns (counts, max abs diff)."""
    from rgcn_tpu_torch import kernels

    kernels.reset_launches()
    got = call()
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"dtype path [{label}]: launches {counts}")
    if counts != launches(**DTYPE_PATHS[label]):
        fail(f"dtype path [{label}]: launches {counts}, expected "
             f"{launches(**DTYPE_PATHS[label])}")
    ref = cpu_call()
    f32 = None if f32_call is None else f32_call()
    return counts, bf16_close(f"{label} against the CPU", got, ref, f32=f32)


def phase_dtype_options(dev, fb_edges):
    """Phase 27: the JAX kernels' own dtype options on the card. K2's bf16
    form at nc-AIFB's layer 2 (W (90, 16, 4)), K3's bf16 form at
    lp-FB-toy (x (280, 500), W (224, 500, 500)) with f32 and bf16 messages
    and over f32 operands with bf16 messages, K1 with a bf16 output over
    the nc-AIFB layout (f32 and bf16 messages), each against its plain
    version and timed beside its f32 form; then DTYPE_PATHS end to end
    against the port's CPU run with exact launches. Returns (the summary,
    the rows, each path's launches)."""
    from rgcn_tpu_torch.data.synthetic import aifb_like
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops import aggregate as agg
    from rgcn_tpu_torch.ops import fused as fz
    from rgcn_tpu_torch.ops import rel_spmm as rs

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    rng = np.random.default_rng(27)

    def rand(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    data = aifb_like()
    es = build_edge_set(data.triples, data.num_nodes, data.num_relations, tile_size=128,
                        with_dst_layout=True).to(dev)
    es_cpu = es.to("cpu")
    n, hidden, classes = data.num_nodes, 16, data.num_classes
    fl, lay = es.fused, es.layout
    rows = []
    log("phase 27 (kernel dtype options):")

    # K2 bf16 at nc-AIFB layer 2
    x = torch.relu(rand(n, hidden))
    w = rand(es.num_rels, hidden, classes, scale=0.3)
    xb, wb = x.to(bf16), w.to(bf16)
    if not rs.fused_fits(w, fl.row_block, bf16):
        fail("K2 bf16: nc-AIFB weights do not fit the shared-memory budget")
    keep = (fl.local_dst.reshape(-1) < fl.row_block) \
        & (fl.quantum_rel.repeat_interleave(fl.quantum) >= 0)
    real = int(keep.sum().item())
    x_rows = int(torch.unique(fl.src[keep]).numel())
    w_rels = int(torch.unique(fl.quantum_rel[fl.quantum_rel >= 0]).numel())
    k2_bytes = real * 12 + (x_rows + w_rels * classes) * hidden * 2 \
        + nbytes(fl.quantum_rel, fl.chunk_block) + n * classes * 4
    rows.append(bf16_kernel_row(
        "K2 bf16", "K2 bf16 nc-AIFB layer 2 (W (90, 16, 4))",
        lambda: fz.rel_spmm_fused(fl, n, xb, wb),
        lambda: fz.rel_spmm_fused_plain(fl, n, x, w, bf16),
        lambda: fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None),
        k2_bytes, real * (2 * hidden * classes + 2 * classes),
        (None, "none: no one PyTorch call computes the fused relation-quantum "
               "SpMM (a bmm per quantum, a rounding and a segment sum are three)"),
        rounded=lambda: fz.rel_spmm_fused_plain(fl, n, x.abs(), w.abs(), bf16)))

    # K3 bf16 at lp-FB-toy: bf16 operands, f32 and bf16 messages; f32
    # operands with bf16 messages
    fe = fb_edges
    din = dout = 500
    x3 = torch.relu(rand(fe.num_nodes, din))
    w3 = rand(fe.num_rels, din, dout, scale=din ** -0.5)
    x3b, w3b = x3.to(bf16), w3.to(bf16)
    live = fe.val != 0
    real3 = int(live.sum().item())
    live_tiles = live.reshape(fe.num_tiles, -1).any(1)
    n_rels = int(torch.unique(fe.tile_rel[live_tiles]).numel())
    n_rows = int(torch.unique(fe.src[live]).numel())
    xg = x3b[fe.src.long()].reshape(fe.num_tiles, fe.tile_size, din)
    wg = w3b[fe.tile_rel.long()]
    bmm = (lambda: torch.bmm(xg, wg)), None
    for od, tag in ((torch.float32, "f32 messages"), (bf16, "bf16 messages")):
        k3_bytes = (n_rels * din * dout + n_rows * din) * 2 \
            + nbytes(fe.src, fe.val, fe.tile_rel) + fe.src.shape[0] * dout * (4 if od == torch.float32 else 2)
        rows.append(bf16_kernel_row(
            "K3 bf16", f"K3 bf16 lp-FB-toy (tiled route, {tag})",
            lambda od=od: rs.rel_spmm_messages(fe, x3b, w3b, out_dtype=od),
            lambda: rs.rel_spmm_messages_plain(fe, x3b, w3b, torch.float32),
            lambda: rs.rel_spmm_messages(fe, x3, w3),
            k3_bytes, real3 * (2 * din * dout + dout), bmm,
            peak_flops=PEAK_BF16_TC_FLOPS))
    del xg, wg
    k3_bytes = (n_rels * din * dout + n_rows * din) * 4 \
        + nbytes(fe.src, fe.val, fe.tile_rel) + fe.src.shape[0] * dout * 2
    rows.append(bf16_kernel_row(
        "K3 bf16", "K3 bf16 lp-FB-toy (f32 operands, bf16 messages: 3xTF32)",
        lambda: rs.rel_spmm_messages(fe, x3, w3, out_dtype=bf16),
        lambda: rs.rel_spmm_messages_plain(fe, x3, w3),
        lambda: rs.rel_spmm_messages(fe, x3, w3),
        k3_bytes, real3 * (2 * din * dout + dout),
        (None, "none: torch.bmm writes its operands' dtype; f32 sums rounded once "
               "to bf16 are no one call"), peak_flops=PEAK_TF32_TC_FLOPS / 3))

    # K1 with a bf16 output over the nc-AIFB layout
    real_slots = int((lay.local_dst < lay.row_block).sum().item())
    for md in (torch.float32, bf16):
        msgs = (rand(es.src.shape[0], hidden) * es.val[:, None]).to(md)
        k1_bytes = real_slots * (hidden * msgs.element_size() + 4 + 4) \
            + nbytes(lay.chunk_block) + n * hidden * 2
        rows.append(bf16_kernel_row(
            "K1 bf16-out", f"K1 {'bf16' if md == bf16 else 'f32'} messages, bf16 out "
                           f"(nc-AIFB, dout {hidden})",
            lambda m=msgs: agg.aggregate_sorted(m, lay, n, out_dtype=bf16),
            lambda m=msgs: agg.aggregate_sorted_plain(m, lay, n),
            lambda m=msgs: agg.aggregate_sorted(m, lay, n),
            k1_bytes, real_slots * hidden,
            (None, "none: index_add_ adds in the output's dtype; no one call sums "
                   "in f32 into a bf16 output")))

    # the entry points end to end against the port's CPU run
    fe_cpu = fe.to("cpu")
    paths, gaps = {}, {}
    paths["fused_default"], gaps["fused_default"] = dtype_path(
        "fused_default", lambda: fz.rel_spmm_fused(fl, n, x, w),
        lambda: fz.rel_spmm_fused(es_cpu.fused, n, x.cpu(), w.cpu()),
        lambda: fz.rel_spmm_fused(fl, n, x, w, compute_dtype=None))
    paths["full_bf16_fb_toy"], gaps["full_bf16_fb_toy"] = dtype_path(
        "full_bf16_fb_toy",
        lambda: rs.rel_spmm_full(fe, fe.layout, x3, w3, compute_dtype=bf16),
        lambda: rs.rel_spmm_full(fe_cpu, fe_cpu.layout, x3.cpu(), w3.cpu(),
                                 compute_dtype=bf16),
        lambda: rs.rel_spmm_full(fe, fe.layout, x3, w3))
    x2, w2 = torch.relu(rand(n, hidden)), rand(es.num_rels, hidden, 24, scale=0.3)
    paths["full_bf16_accum_bf16"], gaps["full_bf16_accum_bf16"] = dtype_path(
        "full_bf16_accum_bf16",
        lambda: rs.rel_spmm_full(es, lay, x2, w2, compute_dtype=bf16, accum_dtype=bf16),
        lambda: rs.rel_spmm_full(es_cpu, es_cpu.layout, x2.cpu(), w2.cpu(),
                                 compute_dtype=bf16, accum_dtype=bf16))
    paths["pallas_bf16"], gaps["pallas_bf16"] = dtype_path(
        "pallas_bf16", lambda: rs.rel_spmm_pallas(es, x2, w2, compute_dtype=bf16),
        lambda: rs.rel_spmm_pallas(es_cpu, x2.cpu(), w2.cpu(), compute_dtype=bf16),
        lambda: rs.rel_spmm_pallas(es, x2, w2))
    seconds = time.perf_counter() - t0
    log(f"phase 27 (kernel dtype options): {seconds:.1f} s ({card_line()})")
    summary = {"card": card_line(), "seconds": seconds, "cpu_gaps": gaps,
               "kernels": [{k: r[k] for k in ("mode", "max_abs_err", "ms", "f32_form_ms",
                                              "plain_ms", "library_ms", "bound_ms")}
                           for r in rows]}
    return summary, rows, paths


# phase 28: bf16 parameters (the layers' param_dtype). The paths' exact
# launches, counts zeroed before each: nc-AIFB's served forward (layer 1's
# messages through K1, layer 2 through K2's bf16-weight form) and one loss
# and backward (K2's bf16-weight form again for layer 2's dx)
PARAM_PATHS = {
    "nc_aifb_serve": dict(k1_aggregate=1, k2_fused_wbf16=1),
    "nc_aifb_step": dict(k1_aggregate=1, k2_fused_wbf16=2),
}
PARAM_NC_STEPS = 5  # Adam steps of nc-AIFB in bf16, trained twice
# the kernels each LP path must launch (its other counts are logged)
PARAM_LP_NEEDS = {
    "lp_wn18_encode": ("k4_weighted_aggregate_bf16",),
    "lp_wn18_step": ("k4_weighted_aggregate_bf16", "k1_aggregate"),
    "lp_fb_toy_step": ("k3_messages_wbf16", "k1_aggregate"),
}
PARAM_AM_ITERS = 10  # CUDA-event timing of the AM-scale contraction


def bf16_params(model):
    """``model`` with every RGCNConv, DistMult and TorchLinear in bf16 (the
    layers' param_dtype; an LP model's node embeddings stay f32, as the
    JAX layers' param_dtype leaves the model's own parameters)."""
    from rgcn_tpu_torch.nn.layers import DistMult, RGCNConv, TorchLinear

    for m in model.modules():
        if isinstance(m, (RGCNConv, DistMult, TorchLinear)):
            m.to(torch.bfloat16)
    return model


def counted(label, fn, expect=None, needs=()):
    """Zero the counts, run ``fn`` on the card, read the counts: exactly
    ``expect``, or each of ``needs`` at least once. Returns (fn's result,
    the counts)."""
    from rgcn_tpu_torch import kernels

    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"  [{label}] launches {({k: v for k, v in counts.items() if v})}")
    if expect is not None and counts != launches(**expect):
        fail(f"param dtype [{label}]: launches {counts}, expected {launches(**expect)}")
    missing = [k for k in needs if counts[k] < 1]
    if missing:
        fail(f"param dtype [{label}]: {missing} never launched ({counts})")
    return out, counts


def grads_close(label, card, cpu, floor=1.0) -> float:
    """Every gradient of ``card``'s model (bf16 for the bf16 parameters)
    within 8e-3 * max(floor, max|ref|) of ``cpu``'s, in the same dtype."""
    ref = dict(cpu.model.named_parameters())
    worst = 0.0
    for name, p in card.model.named_parameters():
        if p.grad.dtype != ref[name].grad.dtype or p.grad.dtype != p.dtype:
            fail(f"[{label}] grad {name}: {p.grad.dtype}, CPU {ref[name].grad.dtype}, "
                 f"parameter {p.dtype}")
        worst = max(worst, bf16_close(f"[{label}] grad {name}", p.grad, ref[name].grad,
                                      floor=floor))
    return worst


def param_dtype_kernels(dev, aifb_es, fb_edges):
    """K2's bf16-weight form at nc-AIFB's layer 2 (x (N, 16) f32, W (90,
    16, 4) bf16) and K3's at lp-FB-toy's block layer (x (280, 500) f32, W
    (224, 500, 500) bf16), each against its plain version's f32 sums
    (1e-5 * max(1, max|ref|)) and timed beside its f32 form on W widened
    beforehand (bf16_kernel_row); K2's form must give that f32 form's bits.
    Returns the two rows."""
    from rgcn_tpu_torch.ops import fused as fz
    from rgcn_tpu_torch.ops import rel_spmm as rs

    bf16 = torch.bfloat16
    rng = np.random.default_rng(28)

    def rand(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    fl, n, hidden, classes = aifb_es.fused, aifb_es.num_nodes, 16, 4
    x = torch.relu(rand(n, hidden))
    wb = rand(aifb_es.num_rels, hidden, classes, scale=0.3).to(bf16)
    if not rs.fused_fits(wb, fl.row_block):
        fail("K2 bf16-W: nc-AIFB's bf16 weights do not fit the shared-memory budget")
    got = fz.rel_spmm_fused(fl, n, x, wb, compute_dtype=None)
    same = same_bits(got, fz.rel_spmm_fused(fl, n, x, wb.float(), compute_dtype=None))
    log(f"  K2 bf16-W: the f32 form's bits on W widened: {same}")
    if not same:
        fail("K2 bf16-W differs from the f32 form on the widened weights")
    keep = (fl.local_dst.reshape(-1) < fl.row_block) \
        & (fl.quantum_rel.repeat_interleave(fl.quantum) >= 0)
    real = int(keep.sum().item())
    x_rows = int(torch.unique(fl.src[keep]).numel())
    w_rels = int(torch.unique(fl.quantum_rel[fl.quantum_rel >= 0]).numel())
    k2_bytes = real * 12 + x_rows * hidden * 4 + w_rels * hidden * classes * 2 \
        + nbytes(fl.quantum_rel, fl.chunk_block) + n * classes * 4
    rows = [bf16_kernel_row(
        "K2 bf16-W", "K2 bf16-W nc-AIFB layer 2 (x f32, W (90, 16, 4) bf16)",
        lambda: fz.rel_spmm_fused(fl, n, x, wb, compute_dtype=None),
        lambda: fz.rel_spmm_fused_plain(fl, n, x, wb),
        lambda: fz.rel_spmm_fused(fl, n, x, wb.float(), compute_dtype=None),
        k2_bytes, real * (2 * hidden * classes + classes),
        (None, "none: no one PyTorch call computes the fused relation-quantum SpMM, "
               "and torch.bmm takes operands of one dtype"))]
    rows[-1]["bit_equal_to_f32_form"] = same

    fe = fb_edges
    din = dout = 500
    x3 = torch.relu(rand(fe.num_nodes, din))
    w3b = rand(fe.num_rels, din, dout, scale=din ** -0.5).to(bf16)
    live = fe.val != 0
    real3 = int(live.sum().item())
    live_tiles = live.reshape(fe.num_tiles, -1).any(1)
    n_rels = int(torch.unique(fe.tile_rel[live_tiles]).numel())
    n_rows = int(torch.unique(fe.src[live]).numel())
    k3_bytes = n_rels * din * dout * 2 + n_rows * din * 4 \
        + nbytes(fe.src, fe.val, fe.tile_rel) + fe.src.shape[0] * dout * 4
    w3 = w3b.float()
    rows.append(bf16_kernel_row(
        "K3 bf16-W", "K3 bf16-W lp-FB-toy (x f32, W (224, 500, 500) bf16: two TF32 passes)",
        lambda: rs.rel_spmm_messages(fe, x3, w3b, out_dtype=torch.float32),
        lambda: rs.rel_spmm_messages_plain(fe, x3, w3b, torch.float32),
        lambda: rs.rel_spmm_messages(fe, x3, w3),
        k3_bytes, real3 * (2 * din * dout + dout),
        (None, "none: torch.bmm takes operands of one dtype; f32 x with bf16 "
               "weights needs a cast before it"), peak_flops=PEAK_TF32_TC_FLOPS / 2))
    return rows


def param_dtype_nc(dev, data):
    """nc-AIFB (configs/rgcn/nc-AIFB.yaml, aifb_like()) with its layers in
    bf16 from the seed-0 initialisation: a served forward and one loss and
    backward (PARAM_PATHS) against the CPU with the same parameters (edge
    stage pinned to bf16), then PARAM_NC_STEPS Adam steps trained twice,
    each from that initialisation, ending with the same bits."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.models.node_classification import build_nc_model
    from rgcn_tpu_torch.serve import NodeClassificationServer
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer

    cfg = load_experiment(CONFIG)
    init = build_nc_model(cfg, data, seed=0).state_dict()

    def trainer(device):
        t = NodeClassificationTrainer(cfg, data, init_params=init, device=device)
        bf16_params(t.model)
        return t

    card, cpu = trainer(dev), trainer("cpu")
    srv, serve = counted("nc_aifb_serve", lambda: NodeClassificationServer(card.model, card.edges),
                         PARAM_PATHS["nc_aifb_serve"])
    with edge_stage(torch.bfloat16), torch.no_grad():
        ref = cpu.model(cpu.edges)
    out = {"logits_max_abs_diff": bf16_close("nc_aifb served logits", srv.logits, ref)}

    def loss_backward(t):
        t.optimizer.zero_grad(set_to_none=True)
        loss = t.loss()
        loss.backward()
        return loss.item()

    loss, step = counted("nc_aifb_step", lambda: loss_backward(card), PARAM_PATHS["nc_aifb_step"])
    with edge_stage(torch.bfloat16):
        cpu_loss = loss_backward(cpu)
    log(f"  [nc_aifb] loss card {loss:.7f}, CPU {cpu_loss:.7f}")
    if not abs(loss - cpu_loss) <= BF16_TOL * max(1.0, abs(cpu_loss)):
        fail(f"param dtype nc_aifb: loss {loss} against the CPU's {cpu_loss}")
    out["grad_max_abs_diff"] = grads_close("nc_aifb", card, cpu)
    del cpu

    runs = []
    for _ in range(2):
        t = trainer(dev)
        (losses, logits), counts = counted(
            "nc_aifb_train", lambda t=t: ([t.step() for _ in range(PARAM_NC_STEPS)], t.logits()),
            needs=("k1_aggregate", "k2_fused_wbf16"))
        runs.append((losses, logits, {k: v.detach().clone() for k, v in t.model.state_dict().items()},
                     counts))
    (l0, z0, s0, c0), (l1, z1, s1, c1) = runs
    same = l0 == l1 and c0 == c1 and same_bits(z0, z1) and all(
        same_bits(v, s1[k]) for k, v in s0.items())
    log(f"  [nc_aifb] {PARAM_NC_STEPS} Adam steps twice: losses {l0}, bit-equal {same}")
    if not same or not np.isfinite(l0).all():
        fail(f"param dtype nc_aifb: two trainings differ ({l0} / {l1}, {c0} / {c1})")
    if any(v.dtype != torch.bfloat16 for v in s0.values()):
        fail("param dtype nc_aifb: a parameter left bf16 in training")
    out.update(losses=l0, bit_equal=same)
    return out, {"nc_aifb_serve": serve, "nc_aifb_step": step, "nc_aifb_train": c0}


def param_dtype_lp(dev, key, config, data):
    """``config`` (lp-WN18 or lp-FB-toy) with its encoder layers and
    DistMult in bf16 from the seed-0 initialisation, epoch 1's batch: one
    encode of the evaluation graph (lp-WN18) and one loss and backward
    against the CPU with the same parameters (edge stage pinned to bf16):
    z and every gradient within 8e-3 * max|ref| (floor 0, as phase 26's LP
    steps), the loss within 8e-3 * max(1, |ref|)."""
    from rgcn_tpu_torch.config import load_experiment
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer

    quiet = records_logger()
    cfg = load_experiment(config)
    card = LinkPredictionTrainer(cfg, data, device=dev, logger=quiet)
    bf16_params(card.model)
    state = {k: v.detach().cpu() for k, v in card.model.state_dict().items()}
    cpu = LinkPredictionTrainer(cfg, data, init_state=state, device="cpu", logger=quiet)
    bf16_params(cpu.model)
    out, paths = {}, {}
    if key == "lp_wn18":
        with torch.no_grad():
            z, paths["lp_wn18_encode"] = counted(
                "lp_wn18_encode", lambda: card.model.encode(card.eval_edges),
                needs=PARAM_LP_NEEDS["lp_wn18_encode"])
            with edge_stage(torch.bfloat16):
                ref = cpu.model.encode(cpu.eval_edges)
        out["z_max_abs_diff"] = bf16_close("lp_wn18 encode z", z, ref, floor=0.0)
    for t in (card, cpu):
        t.set_epoch(1)

    def loss_backward(t):
        t.optimizer.zero_grad(set_to_none=True)
        loss = t.loss()
        loss.backward()
        return loss.item()

    loss, paths[f"{key}_step"] = counted(f"{key}_step", lambda: loss_backward(card),
                                         needs=PARAM_LP_NEEDS[f"{key}_step"])
    with edge_stage(torch.bfloat16):
        cpu_loss = loss_backward(cpu)
    log(f"  [{key}] loss card {loss:.7f}, CPU {cpu_loss:.7f}")
    if not abs(loss - cpu_loss) <= BF16_TOL * max(1.0, abs(cpu_loss)):
        fail(f"param dtype {key}: loss {loss} against the CPU's {cpu_loss}")
    out.update(loss=loss, cpu_loss=cpu_loss, grad_max_abs_diff=grads_close(key, card, cpu, 0.0))
    return out, paths


def param_dtype_precision(dev, am_data):
    """rel_spmm_featureless_basis at nc-AM layer 1's shapes (am_like(): the
    served EdgeSet, 40 bases, width 10) under precision None, "highest" and
    "high": its per-edge messages (the products ``precision`` sets, before
    K1's sum) under None and "highest" bit-equal (one full-f32 path),
    under "high" (3xTF32) within 1e-5 * max(1, max|ref|) of "highest"; the
    op with K1's sum timed under each with CUDA events (PARAM_AM_ITERS
    calls)."""
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.nn import layers
    from rgcn_tpu_torch.ops import spmm

    es = build_edge_set(am_data.triples, am_data.num_nodes, am_data.num_relations,
                        tile_size=128, with_dst_layout=True).to(dev)
    rng = np.random.default_rng(128)
    nb, hidden = 40, 10
    bases = torch.from_numpy(rng.standard_normal((nb, es.num_nodes, hidden)).astype(
        np.float32) * 0.01).to(dev)
    comps = torch.from_numpy(rng.standard_normal((es.num_rels, nb)).astype(np.float32)).to(dev)

    def call(p, aggregate=layers._aggregate_k1):
        return spmm.rel_spmm_featureless_basis(es, bases, comps, precision=p,
                                               aggregate=aggregate)

    out = {}
    with torch.no_grad():
        got = {p: call(p, lambda msgs, edges: msgs) for p in (None, "highest", "high")}
        torch.cuda.synchronize()
        same = same_bits(got[None], got["highest"])
        log(f"  AM layer 1 (E_pad {es.src.shape[0]}, nb {nb}, dout {hidden}): messages "
            f"under None and 'highest' bit-equal {same}")
        if not same:
            fail("precision None and 'highest' differ at nc-AM layer 1")
        out["high_max_abs_err"] = check_close(
            "AM layer 1 messages, precision 'high' against 'highest'", got["high"],
            got["highest"])
        del got
        for p in (None, "highest", "high"):
            out[f"{p}_ms"] = cuda_ms(lambda p=p: call(p), iters=PARAM_AM_ITERS, warmup=2)
    log(f"  AM layer 1 ms (CUDA events, {card_line()}): None {out['None_ms']:.3f}, "
        f"highest {out['highest_ms']:.3f}, high {out['high_ms']:.3f}")
    out["bit_equal_none_highest"] = same
    return out


def phase_param_dtype(dev, fb_edges, wn18, fb, am_data):
    """Phase 28: bf16 parameters. The two bf16-weight forms' kernel rows,
    nc-AIFB (served, a step against the CPU, trained twice), lp-WN18 and
    lp-FB-toy (a step against the CPU; lp-WN18's encode too) and the XLA
    ops' precision at nc-AM layer 1. Returns (the summary, the two rows,
    each path's launches)."""
    from rgcn_tpu_torch.data.synthetic import aifb_like
    from rgcn_tpu_torch.graph.structure import build_edge_set

    t0 = time.perf_counter()
    log("phase 28 (bf16 parameters):")
    aifb = aifb_like()
    aifb_es = build_edge_set(aifb.triples, aifb.num_nodes, aifb.num_relations,
                             tile_size=128, with_dst_layout=True).to(dev)
    rows = param_dtype_kernels(dev, aifb_es, fb_edges)
    del aifb_es
    log(f"  the two forms: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    nc, paths = param_dtype_nc(dev, aifb)
    log(f"  [nc_aifb] {time.perf_counter() - t1:.1f} s")
    lp = {}
    for key, config, data in (("lp_wn18", LP_CONFIG, wn18), ("lp_fb_toy", FB_CONFIG, fb)):
        t1 = time.perf_counter()
        lp[key], p = param_dtype_lp(dev, key, config, data)
        paths.update(p)
        log(f"  [{key}] {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    precision = param_dtype_precision(dev, am_data)
    log(f"  precision at AM layer 1: {time.perf_counter() - t1:.1f} s")
    seconds = time.perf_counter() - t0
    log(f"phase 28 (bf16 parameters): {seconds:.1f} s ({card_line()})")
    summary = {"card": card_line(), "seconds": seconds, "nc_aifb": nc, **lp,
               "precision_am_layer1": precision,
               "kernels": [{k: r[k] for k in ("mode", "max_abs_err", "ms", "f32_form_ms",
                                              "plain_ms", "library_ms", "bound_ms")}
                           for r in rows]}
    return summary, rows, paths


def phases_nc_aifb(dev):
    """Phases 3-5 on aifb_like(): the kernels, the hub graph, serving and
    training. Returns (kernel rows, the nc mode rows, serving launches,
    training launches, the training timing, the served answers)."""
    from rgcn_tpu_torch.data.synthetic import aifb_like
    from rgcn_tpu_torch.graph.structure import build_edge_set

    data = aifb_like()
    edges = build_edge_set(
        data.triples, data.num_nodes, data.num_relations, tile_size=128,
        with_dst_layout=True,
    ).to(dev)
    log(f"nc-AIFB graph: N {data.num_nodes}, R' {2 * data.num_relations + 1}, "
        f"E_pad {edges.src.shape[0]}, layout L {edges.layout.perm.shape[0]} "
        f"({edges.layout.num_row_blocks} blocks), fused L "
        f"{edges.fused.src.shape[0]} ({edges.fused.num_row_blocks} blocks)")
    rows, nc_modes = phase_kernels(dev, data, edges)
    phase_skew(dev)
    paths, served = phase_serving(dev, data)
    train_paths, train_modes, train_timing = phase_train(dev, data, edges)
    nc_modes.extend(train_modes)
    return rows, nc_modes, paths, train_paths, train_timing, served


def main():
    t_start = time.perf_counter()
    name = phase_environment()
    sys.path.insert(0, ROOT)
    try:
        import rgcn_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"rgcn_tpu_torch is not importable next to this script: {e}")
    for cfg in (CONFIG, LP_CONFIG, FB_CONFIG, MUTAG_CONFIG, BGS_CONFIG, AM_CONFIG,
                C_WN18_CONFIG, C_FB_CONFIG, E_AIFB_CONFIG, E_AM_CONFIG):
        if not os.path.isfile(cfg):
            fail(f"config not found: {cfg}")

    from rgcn_tpu_torch.data.synthetic import am_like, fb_toy_like, wn18_like
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout
    from rgcn_tpu_torch.graph.structure import build_edge_set

    dev = torch.device("cuda")
    phase_build()
    # phases 3-25 with the layers' edge stage pinned to f32: each gate holds
    # what it held before the card's bf16 default, which phase 26 runs (and
    # phase 22's lp_wn18_bf16 case and phase 24's child, unpinned)
    f32_phases = contextlib.ExitStack()
    f32_phases.enter_context(edge_stage(None))
    rows, nc_modes, paths, train_paths, train_timing, nc_served = phases_nc_aifb(dev)

    lp = wn18_like()
    lp_np = build_edge_set(lp.train, lp.num_nodes, lp.num_relations,
                           tile_size=128, with_dst_layout=True,
                           with_merged_layout=True)
    dedup = build_merged_layout(lp_np.dst, lp_np.src, lp_np.rel, lp_np.val,
                                lp_np.num_nodes, lp_np.num_rels, dedup_k=2).to(dev)
    lp_edges = lp_np.to(dev)
    m = lp_edges.merged
    log(f"lp-WN18 graph: N {lp.num_nodes}, R' {lp_np.num_rels + 1}, train "
        f"{len(lp.train)}, E_pad {lp_np.src.shape[0]}; merged {m.num_pairs} pairs "
        f"in L {m.layout.perm.shape[0]} ({m.layout.num_chunks} chunks, "
        f"{m.layout.num_row_blocks} blocks); dedup L "
        f"{dedup.fwd_dedup.src_sorted.shape[0]} ({dedup.fwd_dedup.num_chunks} chunks)")
    lp_rows, extra = phase_lp_kernels(dev, lp_edges, dedup)
    lp_paths, timing, lp_served = phase_lp_serving(dev, lp, dedup)
    paths.update(lp_paths)

    fb = fb_toy_like()
    fb_edges = build_edge_set(fb.train, fb.num_nodes, fb.num_relations,
                              tile_size=128, with_dst_layout=True).to(dev)
    log(f"lp-FB-toy graph: N {fb.num_nodes}, R' {fb_edges.num_rels + 1}, train "
        f"{len(fb.train)}, E_pad {fb_edges.src.shape[0]} ({fb_edges.num_tiles} tiles, "
        f"{fb_edges.num_edges} real); layout {fb_edges.layout.num_chunks} chunks, "
        f"{fb_edges.layout.num_row_blocks} blocks")
    k3_row, k1_fb = phase_fb_kernels(dev, fb_edges)
    nc_modes.append(k1_fb)
    fb_paths, fb_timing = phase_fb_serving(dev, fb)
    paths.update(fb_paths)
    timing.update(fb_timing)

    paths.update(phase_nc_basis_serving(dev))
    t0 = time.perf_counter()
    am_data = am_like()
    log(f"nc-AM graph (am_like): N {am_data.num_nodes}, R' "
        f"{2 * am_data.num_relations + 1}, {len(am_data.triples)} triples, "
        f"{am_data.num_classes} classes ({time.perf_counter() - t0:.1f} s)")
    am_paths, am_timing, am_modes = phase_am(dev, am_data)
    paths.update(am_paths)
    timing.update(am_timing)
    kname = {"K1": "k1_aggregate", "K2": "k2_fused", "K3": "k3_messages"}
    for r in am_modes:
        r["path"], r["launches"] = "nc_am", am_paths["nc_am"][kname[r["name"]]]
    nc_modes.extend(am_modes)
    pair_paths, pair_modes, pair_timing = phase_train_pairs(dev, am_data)
    train_paths.update(pair_paths)
    train_timing = {"nc_aifb": train_timing, "nc_am": pair_timing}
    nc_modes.extend(pair_modes)
    lp_train_paths, lp_train_modes, lp_train_timing = phase_train_lp(dev)
    train_paths.update(lp_train_paths)
    train_timing.update(lp_train_timing)
    v_serve, v_train, v_serve_timing, v_train_timing, v_modes, diag_around = \
        phase_variants(dev, am_data)
    paths.update(v_serve)
    timing.update(v_serve_timing)
    train_paths.update(v_train)
    train_timing.update(v_train_timing)
    nc_modes.extend(v_modes)
    files_paths, files_timing = phase_files(dev)
    train_paths.update(files_paths)
    host_build = phase_host_build(dev, am_data)
    t0 = time.perf_counter()
    branch_paths, branch_timing, branches, k4_pieces = phase_branches(
        dev, am_data, lp, lp_edges, dedup)
    log(f"phase 21 (single-device branches): {time.perf_counter() - t0:.1f} s")
    train_paths.update(branch_paths)
    train_timing.update(branch_timing)
    from rgcn_tpu_torch.data.synthetic import aifb_like

    sharded, sharded_counts = phase_sharded(dev, aifb_like(), am_data, lp, fb)
    tooling, tooling_counts = phase_tooling(dev)
    installed, installed_counts, installed_bf16 = phase_installed(
        dev, {"nc_aifb": nc_served, "lp_wn18": lp_served})
    device_epochs, device_counts, host_vs_device_ms = phase_device_epochs(dev, lp, fb)
    f32_phases.close()
    precision, bf16_rows, precision_counts = phase_precision(dev, lp, lp_edges, dedup,
                                                             am_data, installed_bf16)
    dtype_options, dtype_rows, dtype_counts = phase_dtype_options(dev, fb_edges)
    param_dtype, param_rows, param_counts = phase_param_dtype(dev, fb_edges, lp, fb, am_data)

    # each kernel's count on the path that serves through it
    key = {"K1": ("k1_aggregate", "main"), "K2": ("k2_fused", "main"),
           "K3": ("k3_messages", "lp_fb_toy"),
           "K4": ("k4_weighted_aggregate", "lp_main"),
           "K5": ("k5_weighted_aggregate_dedup", "lp_dedup_branch")}
    out = []
    for r in rows + lp_rows + [k3_row]:
        kname, path = key[r["name"]]
        out.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "status": "ported",
            "path": path, "launches": paths[path][kname],
            "train_launches": {tp: c[kname] for tp, c in train_paths.items()},
            "sharded_launches": {case: [c[kname] for c in per_rank]
                                 for case, per_rank in sharded_counts.items()},
            "tooling_launches": {tp: c[kname] for tp, c in tooling_counts.items()},
            "installed_launches": {ip: c[kname] for ip, c in installed_counts.items()},
            "device_launches": {dp: c[kname] for dp, c in device_counts.items()},
            "precision_launches": {pp: c[kname] for pp, c in precision_counts.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
            "library_call_ms": r["library_call_ms"],
        })
    # the fixed-order kernels' lane maps for rows that are not whole 16-byte
    # vectors: K1's 4-value lanes with a masked tail in 8-byte pieces (the
    # nc-AM pair path's composed forward at width 10) and K4's f32 form in
    # 8-byte pieces (nc-AM's featureless 4-basis sum at width 10)
    for r, path, kname in ((dict(pair_modes[0], name="K1 masked lanes"), "train_nc_am",
                            "k1_aggregate"),
                           (k4_pieces, "branch_nc_am_basis4", "k4_weighted_aggregate")):
        out.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "status": "ported", "mode": r["mode"],
            "path": path, "launches": train_paths[path][kname],
            "train_launches": {tp: c[kname] for tp, c in train_paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
            "library_call_ms": r["library_call_ms"],
        })
    # the bf16 forms (phase 26): each form's first mode, on the default path
    # that serves through it
    bf16_key = {"K1 bf16": ("k1_aggregate_bf16", "ergcn_nc_aifb"),
                "K4 bf16": ("k4_weighted_aggregate_bf16", "lp_wn18"),
                "K4 bf16 owned": ("k4_weighted_aggregate_bf16", "step_nc_aifb_basis4"),
                "K5 bf16": ("k5_weighted_aggregate_dedup_bf16", "lp_wn18_dedup")}
    for form, (kname, path) in bf16_key.items():
        r = next(r for r in bf16_rows if r["name"] == form)
        out.append({
            "name": form, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "status": "ported", "mode": r["mode"],
            "path": path, "launches": precision_counts[path][kname],
            "precision_launches": {pp: c[kname] for pp, c in precision_counts.items()},
            "sharded_launches": {case: [c[kname] for c in per_rank]
                                 for case, per_rank in sharded_counts.items()},
            "installed_launches": {ip: c[kname] for ip, c in installed_counts.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "f32_form_ms": r["f32_form_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_note": r["library_note"],
            "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
            "library_call_ms": r["library_call_ms"],
        })
    # the kernel dtype options (phase 27): each form's first mode, on the
    # phase-27 path that launches it (K1's bf16 output counts as its message
    # form, here k1_aggregate_bf16 on the path whose accum_dtype is bf16)
    dtype_key = {"K2 bf16": ("k2_fused_bf16", "fused_default"),
                 "K3 bf16": ("k3_messages_bf16", "full_bf16_fb_toy"),
                 "K1 bf16-out": ("k1_aggregate_bf16", "full_bf16_accum_bf16")}
    for form, (kname, path) in dtype_key.items():
        r = next(r for r in dtype_rows if r["name"] == form)
        out.append({
            "name": form, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "status": "ported", "mode": r["mode"],
            "path": path, "launches": dtype_counts[path][kname],
            "dtype_launches": {pp: c[kname] for pp, c in dtype_counts.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "f32_form_ms": r["f32_form_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_note": r["library_note"],
            "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
            "library_call_ms": r["library_call_ms"],
        })
    # the bf16-weight forms (phase 28): each on the phase-28 path that
    # launches it
    param_key = {"K2 bf16-W": ("k2_fused_wbf16", "nc_aifb_serve"),
                 "K3 bf16-W": ("k3_messages_wbf16", "lp_fb_toy_step")}
    for form, (kname, path) in param_key.items():
        r = next(r for r in param_rows if r["name"] == form)
        out.append({
            "name": form, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "status": "ported", "mode": r["mode"],
            "path": path, "launches": param_counts[path][kname],
            "param_dtype_launches": {pp: c[kname] for pp, c in param_counts.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "f32_form_ms": r["f32_form_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_note": r["library_note"],
            "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
            "library_call_ms": r["library_call_ms"],
        })
    print(json.dumps({"serve_launches": paths}), flush=True)
    print(json.dumps({"serve_timing_ms": timing}), flush=True)
    print(json.dumps({"train_launches": train_paths}), flush=True)
    print(json.dumps({"train_timing_ms": train_timing}), flush=True)
    print(json.dumps({"files_timing_s": files_timing}), flush=True)
    print(json.dumps({"nc_modes": nc_modes}), flush=True)
    print(json.dumps({"k4_modes": extra}), flush=True)
    print(json.dumps({"lp_train_modes": lp_train_modes}), flush=True)
    print(json.dumps({"diag_around": diag_around}), flush=True)
    print(json.dumps({"pending_kernels": []}), flush=True)
    print(json.dumps({"host_build_ms": host_build}), flush=True)
    print(json.dumps({"branches": branches}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"tooling": tooling}), flush=True)
    print(json.dumps({"installed": installed}), flush=True)
    print(json.dumps({"device_epochs": device_epochs}), flush=True)
    print(json.dumps({"host_vs_device_epoch_ms": host_vs_device_ms}), flush=True)
    print(json.dumps({"edge_precision": precision}), flush=True)
    print(json.dumps({"bf16_modes": bf16_rows}), flush=True)
    print(json.dumps({"dtype_options": dtype_options}), flush=True)
    print(json.dumps({"dtype_modes": dtype_rows}), flush=True)
    print(json.dumps({"param_dtype": param_dtype}), flush=True)
    print(json.dumps({"param_dtype_modes": param_rows}), flush=True)
    # every K1 and K4 launch of the run by route and lane piece: the
    # fixed-order routes only (K1 kFixed or kChunk, K4's owned-row kernel)
    from rgcn_tpu_torch import kernels

    print(json.dumps({"routes": kernels.ROUTES}), flush=True)
    if any(not k.startswith(("k1_fixed_", "k1_chunk_", "k4_owned_")) for k in kernels.ROUTES):
        fail(f"a launch took a route in no fixed order: {kernels.ROUTES}")
    log(f"command time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
