#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's forecast and training paths on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one line; any failure raises and exits non-zero):

1. card name and power limit (``nvidia-smi``); build the CUDA kernels from
   ``quadtree_mpnnlstm_tpu_torch/csrc`` with ``nvcc`` and load them;
2. main path: ``NextFramePredictorS2S.predict`` on 16 Moving-MNIST 64×64
   videos made from ``--seed`` — T_in=4 → T_out=10, quadtree thresh=0.1
   with a remesh every decoder step, ChebConv GConvLSTM, hidden 16, 2×2
   layers, n_max=2048, e_max=10240, node_budget=2048, NT=128,
   EB=SW=1024, f32, random weights from the seed. Checks finite outputs of
   shape (16, 10, 64, 64, 1) and zero mesh overflow; times one batch after
   a warm-up and counts the kernel launches of that batch, K7's (73: node
   counts, pooling and degrees of every mesh, the state carried across
   each remesh) as read from the code;
3. each kernel against its plain PyTorch version on the operands of the
   main path (the Â windows of the meshes the first decoder steps run on;
   the z of every width F the path uses): K1 exact, K2 ≤1e-5; times
   each kernel by CUDA graph (``ms``: 20 calls captured in one graph, the
   card's own time) and by CUDA events (``events_ms``: with the host's
   launches), the plain version by events and the library call by graph
   where torch lets it be captured (``library_timing`` says how). K2 and
   K2b (here and in phases 7, 12b, 27, 43 and 55) must also equal the
   row-a-warp kernel they replaced (``csrc/spmm_rowwarp.cu``) bit for bit,
   whose times stand beside theirs (``rowwarp_ms``);
4. the whole rollout again with the plain versions on the card: the first
   decoder step's meshes must be identical, and frames must agree to
   ≤1e-4 up to the first step where a sample's mesh differs (a quadtree
   cell near the threshold can flip; such a flip is reported);
5. train path: ``train_step`` (fwd + bwd + clipped Adam, lr 0.01,
   dropout 0.1) at the same width on batches of 16 made from ``--seed`` as
   ``bench.py`` ``measure`` makes them: one warm-up step (in which every
   Â·z whose input requires grad must carry the K2b autograd node), then
   8 timed steps with the loss and overflow fetched one step late. Checks
   a finite loss, zero overflow and the launches per step read from the
   code (K1 11, K2 112, K2b 110, K7 119); prints steps/s, frames/s and
   peak memory;
6. train entry: one epoch of ``train()`` over 2 training batches and 1
   test batch, then ``score()``; finite losses;
7. gradients vs plain: K2b against its plain version on the cotangents of
   every width F of one train step (≤1e-5, timed like K2: graph and
   events), then one whole
   train step with the kernels and one with the plain versions from the
   same weights and generator: the meshes must be identical, and every
   gradient leaf must agree to ≤1e-4 × max(1, max|g|);
8. train determinism: the same train step twice gives a bit-identical
   loss and gradients;
9. attention path: ``predict`` with the TransformerConv model at the same
   width (``bench.py --conv TransformerConv``: fused attention gate
   stacks, 8 streams × d 16 = HD 128; head convs HD 16 and 1; attention
   windows NT 128, EB = SW = 1024): finite frames of shape
   (16, 10, 64, 64, 1), overflow 0, K3 and K7 launches as read from the
   code (56 and 62) and no K1/K2; times one batch after a warm-up;
10. attention kernels vs plain: K3 against ``attn_plain`` on the first
   decoder step's operands at every HD of the path (≤1e-5), bit-identical
   on a repeat, with its launch plan (``fwd_plan``) and the geometry the C
   entry reports; K3 at 8 heads × d 32 (HD 256, the ice-quadtree width)
   on the same windows with q, k, v, Wₑ from ``--seed`` (``k3_wide``,
   ≤1e-5, timed beside its bound); K4 against
   autograd through ``attn_plain`` on the cotangents of one train step at
   every HD (≤1e-5 × max(1, max|grad|)), through the graph's slot view,
   bit-identical on a repeat, with its plan (``bwd_plan``) and the
   geometry the C entry reports;
   K3 and K4's whole backward (both kernels, the dWₑ sum) timed by CUDA
   graph and by events, beside their bounds; the per-mesh
   view builds (pixel view, K4's slot view) timed on a decoder mesh; K7
   on this path's own operand sets (a forecast's and a train step's, the
   node counts apart) as in phase 21 (``k7_by_set``);
11. attention train path: ``train_step`` (attention dropout 0.1 from the
   trainer's generator): a warm-up step in which every K3 output whose
   inputs need a gradient carries the ``AttnApply`` node, then 8 timed
   steps; finite loss, overflow 0, K3, K4 and K7 launches per step as
   read from the code (56, 56, 108), no K1/K2; frames/s and peak memory;
12. attention gradients vs plain and determinism: one train step on the
   kernels and one on the plain versions from the same weights and
   generator (identical meshes, every gradient leaf ≤1e-4 ×
   max(1, max|g|)), and the kernel step again, bit-identical;
12b. window gate: one teacher-forced train step (ratio 1.0: every
   decoder step remeshes on a true frame of the sprite-rendered batch) of
   the ChebConv model and one of the TransformerConv model; every K1 call
   exact, every K2, K2b, K3 call ≤1e-5 and every K4 call ≤1e-5 ×
   max(1, max|grad|) against the plain versions on those near-capacity
   meshes; prints the largest window fill (edges a tile against EB,
   source spread against SW) and checks the overflow counter is 0;
13. grid path: the sea-ice flagship through ``predict`` — the JAX
   package's committed config (``bench.py`` ice workload): the pixelwise
   224×304 grid (``aggregation="grid"``, the ice mask), 5 variables,
   T_in 10 → T_out 90, hidden 32, 1 layer × 3 conv layers,
   TransformerConv with gate stacks as 8 streams × d 32 = H 256 and head
   convs at H 32 and 1, climatology concat, batch 1, f32; inputs are
   ``IceDataset`` June windows of synthetic 2016 fields made from
   ``--seed``. Finite frames, overflow 0, K5 launches as read from the
   code (300 a forecast), no K1-K4 and no K7 (the grid has no segment
   sums); seconds per forecast after a warm-up;
14. grid kernels vs plain: K5 against ``grid_attn_plain`` on the first
   decoder step's operands at H 256, 32 and 1, with and without a keep
   plane (bit-identical; with its plan, ``fwd_plan``: row bands at H 256
   and 32, tiles at H 1), K6 against autograd through ``grid_attn_plain`` on the
   cotangents of one train step at each H, with and without its keep
   planes (≤1e-5 × max(1, max|grad|)); all timed by CUDA graph and by
   events beside their bounds;
15. grid rollout vs plain: the whole 90-step forecast on the plain K5,
   bit-identical to the one on K5 (the mesh is fixed, and K5 keeps every
   sum in the plain version's order);
16. grid train path: ``train_step`` at batch 1 (full BPTT, attention
   dropout 0.1): a warm-up step in which every K5 output whose inputs need
   a gradient carries the ``GridAttnApply`` node, then 3 timed steps;
   finite loss, K5 and K6 launches per step as read from the code (300
   each), no K1-K4, no K7; frames/s and peak memory;
17. grid gradients vs plain and 18. determinism: one train step on the
   kernels and one on the plain versions (T_out 6: the plain version keeps
   D shifted copies of k and v a call) from the same weights and
   generator, every gradient leaf ≤1e-4 × max(1, max|g|), and the kernel
   step again, bit-identical;
19. (printed last) the ``kernels`` JSON line (K1, K2, K2b, K3, K4, K5,
   K6, K7 in f32, then K1, K2, K2b, K7, K3, K4, K5, K6 in bf16, each with
   its ``dtype``; K7's entries add ``by_operand_set``, every set of phases
   10, 21, 27, 27b, 32 and 45 with its path, and ``ms_by_path``, the
   launch-weighted means of the main path, TransformerConv and the edge
   list, each over its own sets; K2's and K2b's add ``gcn_by_width``,
   phase 43's rows, and K1, K2, K2b and K7 the GCN path's launches; K7's
   also the preset meshes' sets of phases 50-51 and every kernel the
   launches of phases 50-53 and 55-58, K1 on a shared mesh (``shared_mesh``), K2, K2b,
   K3 and K4 on shared meshes (``shared_by_width``), K7 on capped views and
   bf16 messages; K7 on the mesh-design sets of phase 61 and every kernel's
   launches in phase 63's profiled run; the launches of a data-parallel
   rank's step and of every CLI run of phases 66-72), then the card line
   and the result line;
20. edge path: the flagship on the pixelwise edge list (``bench.py
   --workload ice-xla``: ``aggregation="xla"``, n_max 68,096, e_max
   272,384) through ``predict``: finite frames, overflow 0, K7 launches as read from the code (304 a
   forecast), no K1-K6; seconds per forecast after a warm-up; ungated, the
   largest difference from the grid model with the same weights over the
   valid pixels;
21. K7 on the path's own operands, bit-identical to the entry-ordered sum
   (``segment_sum_plain`` on the CPU, torch on one thread) or the phase
   fails, and within 1e-6 × max(1, max|out|) of ``segment_sum_plain`` on
   the card: the messages at F 256, 32 and 1 over the sorted edge_dst, the
   gather cotangents over edge_src and edge_dst, the pooling and counts
   over pixel_node, from one forecast and one T_out-6 train step; each with
   its launch plan (``segment_plan``) and its launches in the train step,
   timed beside its bound, the plain version, ``index_add_`` and its CSR
   view's build, as the card's own time (many calls captured in one CUDA
   graph, so the host's launch rate does not enter) and by CUDA events;
22. the 90-step edge-list forecast with K7 swapped for its plain version:
   ≤1e-4 at every step;
23. edge train path: ``train_step`` with truncated BPTT of 30 steps and
   attention dropout 0.1 from the trainer's generator: a warm-up step in
   which every K7 output that needs a gradient carries the ``SegmentSum``
   node, then 3 timed steps; finite loss, K7 launches per step as read
   from the code (1542), no K1-K6; frames/s and peak memory;
24. edge gradients vs plain (a T_out-6 step on K7 and one on its plain
   version, same weights and generator, every gradient leaf ≤1e-4 ×
   max(1, max|g|)) and 25. determinism (the kernel step again,
   bit-identical).

26. bf16 path: ``predict`` with the main path's model in bf16
   (``compute_dtype="bfloat16"``, ``bench.py``'s default dtype: f32 master
   weights cast at use, f32 LayerNorm statistics, f32 predictions; no
   remat, which ``bench.py`` turns on): finite f32 frames of shape
   (16, 10, 64, 64, 1), overflow 0, the bf16 kernels' launches as read from
   the code (K1 11, K2 112, K7 62; only the node counts' K7, 11, stays
   f32); times one batch after a warm-up, peak memory;
27. bf16 kernels vs plain: K1 bit-identical, K2 (per width F), K2b (per
   width of one bf16 train step's cotangents) and K7 (per operand set of a
   forecast and a train step: pooling, degrees, the gathers' cotangents)
   within one bf16 rounding (2⁻⁷ × max(1, max|plain|)) of their plain
   versions, K7 also bit-identical to the CPU's entry-ordered sum as in
   phase 21; each timed by CUDA graph and events beside its bound (2-byte
   operands, the bf16 rate), its plain version, its library call in bf16
   (``torch.sparse.mm``, ``index_add_``; a refusal is printed) and the f32
   kernel on the same operands in f32; K7's f32 sets (the same sums in
   f32 and the node counts, which stay f32) are measured as in phase 21,
   the main path's K7 in f32 (``k7_f32_by_set``);
27b. K7 on the pixel views of quadtree meshes of three densities built
   from the phase-2 frames (``K7_MESH_THRESHOLDS``: 64 nodes of 64
   pixels, ~430 and ~1400 nodes of 1-64 pixels) at F 1, 3 and 16 in f32
   and bf16, measured as in phase 21;
28. bf16 train path: ``train_step`` as phase 5 in bf16: finite f32 loss,
   overflow 0, launches per step (K1 11, K2 112, K2b 110, K7 108 in
   bf16; K7 11 in f32), f32 masters and gradients; frames/s, peak memory;
   one epoch of ``train()`` and ``score()`` in bf16, finite losses;
29. bf16 gradients vs plain: one teacher-forced bf16 step (ratio 1.0, so
   both runs share their meshes) on the kernels and one on the plain
   versions, every gradient leaf ≤2e-2 × max(1, max|g|); every K1 call of
   the kernel step exact and every K2/K2b call within one bf16 rounding on
   those near-capacity windows; the kernel step again, bit-identical;
30. bf16 vs f32: the same weights' forecasts on the card; on the samples
   whose encoder mesh agrees (the criterion reads the bf16 frame), the
   first decoder step's frames within 2e-2 on average (the largest
   difference is printed: bf16 and f32 differ by more at single pixels).

31. bf16 attention path: ``predict`` with the TransformerConv model of
   phase 9 in bf16 (``bench.py --conv TransformerConv``'s default dtype):
   finite f32 frames, overflow 0, bf16 K3 56 and K7 51 launches, only the
   node counts' K7 (11) in f32, nothing else; a forecast's peak memory
   above its start, bf16 beside f32;
32. K3 in bf16 on the first decoder step's operands at HD 128, 16 and 1,
   K4 in bf16 on one bf16 train step's cotangents: within one bf16
   rounding (2⁻⁷ × max(1, max|plain|)) of their plain versions, K3
   bit-identical on a repeat; each timed by CUDA graph and events beside
   its bound (2-byte operands), its plain version and the f32 kernel on
   the same operands in f32; K7's bf16 sets of this path as in phase 27;
33. bf16 attention train path: ``train_step`` as phase 11 in bf16: K3 =
   K4 = 56 and K7 97 bf16 launches a step (11 K7 f32), finite f32 loss,
   f32 masters and gradients; frames/s, a step's peak above its start,
   bf16 beside f32;
34. a teacher-forced bf16 step (ratio 1.0: the runs share their meshes)
   on K3/K4 against one on their plain versions: the loss within 1e-2,
   every gradient leaf no further from the plain step's than the plain
   step in bf16 is from the plain step in f32 (× max(1, max|g|): K3 and
   its plain version differ by a bf16 rounding at a few outputs, which the
   model amplifies as it amplifies bf16 against f32); K4 alone, on the
   kernel step's forward, ≤2e-2 × max(1, max|g|); the kernel step again,
   bit-identical;
35. bf16 grid path: the flagship of phase 13 in bf16 (``bench.py``
   ``measure_ice``'s default dtype): finite f32 frames, 300 bf16 K5 a
   forecast and no other launch; a forecast's peak above its start and
   its frames' distance from the f32 forecast, bf16 beside f32;
36. K5 in bf16 at H 256, 32 and 1 with and without keep planes,
   bit-identical to its plain version (the f32 sums of the plain order,
   rounded once), with its plan; K6 in bf16 on one T_out-6 bf16 step's cotangents with
   and without keep planes, within one bf16 rounding; timed as phase 32;
37. bf16 grid train path: full-BPTT ``train_step`` (3 timed steps):
   K5 = K6 = 300 bf16 launches a step, finite f32 loss, f32 masters and
   gradients; a step's peak above its start, bf16 beside f32;
38. a bf16 T_out-6 step on K5/K6 against one on their plain versions
   (≤2e-2 × max(1, max|g|)), and the kernel step again, bit-identical.

``bench.py``'s workloads as it configures them (phases 39-42; every
phase above runs ``remat=False``, so its numbers stay comparable with
earlier runs):

39. main path under remat (``bench.py`` ``measure()``'s default:
   ChebConv, batch 16, bf16, ``--remat full``): one ``train_step`` with
   remat "none", "full" and "mesh" from the same weights and generator
   (dropout 0.1, teacher forcing 0.5): loss and every gradient leaf
   bit-identical, the generator where "none" leaves it; K1, K2, K2b and K7
   launches a step as read from the code (a replay launches its step's
   forward again: K2 224 in every remat mode, "full" also K1 21 and K7
   189, "mesh" K1 11 and K7 119); each mode's step peak above its start
   and time;
40. the flagship at ``bench.py --workload ice`` defaults: the grid,
   bf16, per-gate stacks (``fused_gates=False``), remat full, T_out 90,
   full BPTT: ``predict`` (300 K5) and 3 timed ``train_step`` s (600 K5 with
   the replays, 300 K6), finite, overflow 0; K5 (bit-identical) and K6
   (one bf16 rounding) against their plain versions on this path's
   operands, timed; a step's peak beside the same step without remat; the
   per-gate step's gradients against the fused model's on weights stacked
   by ``fuse_attn_gates`` (≤2e-2 × max(1, max|g|), phase 34's K4 gate);
41. the flagship on the pixelwise edge list, f32, full BPTT under remat
   full (``bench.py --workload ice-xla --dtype float32``): finite loss,
   overflow 0, K7 1594 a step as read from the code, its peak; at T_out 6
   remat full against "none": bit-identical loss and gradients;
42. ice-quadtree at its defaults (``bench.py --workload ice-quadtree``:
   ``make_ice_quadtree_model``, bf16, remat full): ``predict`` (K3 300,
   K7 452) and 2 timed ``train_step`` s (K3 600, K4 300, K7 1080), finite,
   overflow 0; K3 and K4 at HD 256 (8 streams × d 32) against their plain
   versions on this path's first decoder windows and one step's
   cotangents, in bf16 and f32, timed by CUDA graph beside their bounds;
   the fullest window against EB and SW.

GCNConv, the JAX package's default conv, and bf16 on the edge list
(phases 43-45):

43. the main path with ``--conv GCNConv`` (``bench.py``'s model, GCN
   gate stacks applying each stream's weights first and aggregating all
   2·G streams in one Â·z of width 2·G·d = 128, GCN head convs): a
   forecast (``predict``) in f32 and bf16, finite, overflow 0, K1 11, K2
   56 and K7 73 launches (bf16: only the node counts' 11 K7 in f32); K2
   at every width of the first decoder step (F 128, 16, 1) against its
   plain version (≤1e-5 in f32, one bf16 rounding in bf16) and K2b on one
   step's cotangents, timed by CUDA graph and events beside the bound,
   the plain version and ``torch.sparse.mm``; a ``train_step`` in each
   dtype under remat none and full (dropout 0.1, teacher forcing 0.5):
   launches K1 11 / 21, K2 56 / 112, K2b 56, K7 119 / 189, every K2
   output carrying the K2b node, "full" bit-identical to "none"; a
   teacher-forced f32 step against one on the plain versions (identical
   meshes, every leaf ≤1e-4 × max(1, max|g|)) and the kernel step again,
   bit-identical;
44. the JAX package's experiment 1 (``cli/ice_exp.py``): GCNConv on the
   flagship's 224×304 grid, per-gate, f32, remat full: ``predict`` and a
   full-BPTT ``train_step``, finite, overflow 0, no kernel launched (Â·z
   is the grid's plain shift stencil), the step's peak and time; the
   per-gate step's gradients against the fused model's on weights stacked
   by ``fuse_gcn_gates`` (≤1e-4 × max(1, max|g|));
45. ``bench.py --workload ice-xla`` at its defaults (the pixelwise edge
   list, bf16, per-gate, remat full): ``predict`` and a full-BPTT
   ``train_step``, finite, overflow 0, K7 launches as read from the code
   (all bf16 but the node counts), peaks and times; K7 in bf16 on the edge
   list's sets (messages at F 256, 32, 1, the gathers' cotangents, the
   pooling) bit-identical to the entry-ordered f32 sum rounded once, timed
   beside its bound, plain version and ``index_add_`` in bf16; a T_out-6
   bf16 step against an f32 step from the same weights, each on K7 and on
   its plain version, gated by the plain path's own bf16-vs-f32 spread as
   phase 34 gates.

The convs and cells of ROADMAP Queue 1 item 7 (phases 46-49), each
kernel's launches as read from the code (``expected_*_launches``):

46. ``--conv MHTransformerConv`` (3 heads concatenated and mixed back
   down; the fused gate stacks' 2·G streams × 3 heads × d 16 = HD 384 in
   one attention call, the head convs HD 48 and 3) on the attention
   windows: a forecast in f32 and bf16 (finite, overflow 0, K3 56 and K7
   62, no K1/K2 as on the TransformerConv path); K3 at HD 384, 48 and 3
   against its plain version (≤1e-5 in f32, one rounding in bf16,
   bit-identical on a repeat) and K4 on one step's cotangents (≤1e-5 ×
   max(1, max|g|), one rounding in bf16), timed by CUDA graph and events
   beside their bounds and plain versions; a train step in each dtype
   under remat none and full (dropout 0.1, teacher forcing 0.5), "full"
   bit-identical to "none"; a teacher-forced f32 step against one on the
   plain versions (≤1e-4 × max(1, max|g|)) and again, bit-identical;
47. ``--conv GATConv`` and ``--conv GATv2Conv``: the quadtree keeps its
   edge list beside its Â blocks, and every GAT pass (the 2·G gate
   streams of a cell layer as the heads of one pass) sums over the mesh's
   self-loop list on K7 once; a forecast and a train step in f32 and
   bf16 (K1 11, no K2, K7 as read from the code), the step again,
   bit-identical; K7 on the self-loop sets (the messages over their dst
   view, the gathers' cotangents over both views) bit-identical to the
   entry-ordered sum on the CPU (bf16: that f32 sum rounded once), timed
   beside its bound, plain version and ``index_add_``; f32 gradients
   against the plain path's;
48. the cells with ChebConv: the fused and per-gate GRU, the shared-conv
   LSTM, the split LSTM (``torch.nn.LSTM`` along the node axis, cuDNN's
   deterministic settings) and ``dummy=True``: a forecast and a train step
   each in f32 (finite, overflow 0, K1, K2, K2b and K7 as read from the
   code), the step again, bit-identical; the GRU in bf16 under remat full
   against remat none, bit-identical; the per-gate GRU's gradients against
   the fused GRU's on weights stacked by ``fuse_cell_gates`` (≤1e-6 ×
   max(1, max|g|));
49. ``bench.py --workload ice --conv MHTransformerConv`` at its defaults
   (the 224×304 grid, bf16, per-gate, remat full, hidden 32: 24 heads ×
   d 32 = H 768 a cell call, one launch of K5 and of K6): a forecast and a
   full-BPTT step (finite, K5/K6 launches as read from the code, peaks
   and times); K5 at H 768 bit-identical to its plain version at that
   width (bf16 and f32), K6 on a T_out-6 step's cotangents (one bf16
   rounding; ≤1e-5 × max(1, max|g|) in f32), bit-identical on a repeat,
   one launch a call each;
   K3/K4 at HD 768 (24 heads × 32, slices of heads) on one ice-quadtree
   mesh with operands, keep windows and a cotangent from ``--seed``,
   ≤1e-5 (one rounding in bf16), one launch a call each, K3 bit-identical
   on a repeat; all timed beside their bounds and plain versions.

ROADMAP Queue 1 item 8 and the baselines (phases 50-54), each kernel's
launches as read from the code (``expected_preset_launches``,
``expected_remesh_launches``, ``expected_baseline_launches``):

50. the JAX package's sea-ice experiment 9 (``cli/ice_exp.py``): the
   heterogeneous preset mesh of the flagship's 224×304 mask
   (``graph/static.py``, ``max_grid_size=4``, ``resolution=1/12``, built
   once on the card: live nodes and edges beside n_max 68,096 and e_max
   272,384, overflow 0), the flagship model on it (TransformerConv, fused
   gates, hidden 32, 1 × 3 layers, climatology, ``dist_from_05``, the
   synthetic corridor as high-interest region, remat full): a forecast at
   T_out 90 (every step on the preset, K7 only), ``predict`` over two
   windows as one batch riding the preset as views (window 0 ≤1e-4 from
   its forecast alone), K7 on the preset's sets (the sorted edge_dst,
   edge_src, the pixel map at every F of a forecast and a T_out-6 step)
   bit-identical to the CPU's entry-ordered sum, timed beside its bound,
   plain version and ``index_add_``; a full-BPTT step (K7 as read); at
   T_out 6 a step on K7 against one on its plain version (≤1e-4 ×
   max(1, max|g|)) and remat full against none, bit for bit; a bf16
   forecast and full-BPTT step (every K7 in bf16), its K7 sets as above;
51. the same for experiment 10 (the homogeneous preset mesh);
52. ``remesh_input`` and ``remesh_every=2`` on ``bench.py``'s model (batch
   16, ChebConv on Â blocks) in f32 and bf16: a forecast and a train step
   each (K1, K2, K2b, K7 as read; bf16: only each mesh's node counts in
   f32), overflow 0; remat full against none (teacher forcing 0.5), bit
   for bit; a teacher-forced step on the kernels against one on the plain
   versions (identical meshes; ≤1e-4 × max(1, max|g|), bf16 2e-2);
53. ``MPNNLSTM`` and ``MPNNLSTMI`` forwards at hidden 32 in f32 and bf16
   on the flagship's pixelwise edge list (T_in 10, batch 1; K7) and on a
   ``bench.py`` quadtree mesh's Â blocks (K2), each against the same
   forward on the plain versions (≤1e-4, bf16 2e-2);
54. the debug modes: a NaN in a decoder (encoder) weight raises the error
   that names the decoder step t=0 (the encoder); a clean debug step
   equals the plain step bit for bit (loss, gradients, updated weights,
   generator); ``debug_overflow`` raises on an undersized build and is
   silent on the main path's;
55. shared-mesh batched training (``TrainConfig.shared_mesh``) at
   ``bench.py``'s model under remat full: bf16 at batch 8 and 32 (``bench.py
   --full``'s ``pallas_bf16_shared_b8``/``_b32``) and f32 at batch 16, each
   beside the per-sample path at the same batch: finite losses, overflow
   0, launches a step as the per-sample path's (read from the code), every
   K1 build of batch 1 (once a mesh, not B times); B identical samples
   through the shared mesh bit-identical to the per-sample path (ChebConv:
   forecast and a train step without dropout; TransformerConv: forecast);
   K1 on a shared mesh beside a per-sample build, timed; K2 and K2b on a
   shared mesh's blocks (batch 1) for the batch at every width (f32 batch
   16 ≤1e-5, bf16 batch 32 within one rounding), and K3 and K4 on its
   windows at every HD (TransformerConv, batch 16, ≤1e-5, K4 ≤1e-5 ×
   max(1, max|grad|)) against their plain versions, timed beside their
   bounds, the plain versions and ``torch.sparse.mm`` on the batch folded
   into the features;
56. the csum adjacency: ``bench.py --workload ice-quadtree --adjacency
   csum`` (bf16, batch 1): the card's csum list of an input mesh equal to
   the CPU's element for element and to the sort list as a set, a forecast
   and a full-BPTT step with overflow 0 and the launches of phase 42; the
   Moving-MNIST model on csum Â blocks: the first build's blocks within
   1e-6 of the sort build's, its forecast on the kernels within 1e-4 of
   the one on their plain versions until a mesh flips (the sort model's
   forecast beside it, ungated: the degree sums' order differs);
57. bf16 messages (``GraphConfig.message_dtype``) in the f32 Moving-MNIST
   model on the quadtree edge list: 112 bf16 K7 launches a forecast and a
   step (one an aggregation), the rest f32; K7's bf16 sets bit-identical
   to the entry-ordered sum;
58. the CSR degree cap (``GraphConfig.max_degree``) on that model: a cap
   at the degree bound gives the uncapped forecast and step bit for bit;
   a cap of 4 counts overflow > 0, and K7 on the capped views (F 1 and 16)
   is the entry-ordered capped sum bit for bit, timed.

ROADMAP Queue 1 items 10 (data and eval) and 11 (the CNN-LSTM baseline
family), phases 59-63:

59. ``NextFramePredictorCNNLSTM`` at ``cli/ice_exp_cnnlstm.py`` experiment
   0's widths (hidden 32, 2 layers, kernel 3, dropout 0.1, lr 1e-3, T_in
   10 → T_out 90, batch 1) on the flagship's 224×304 synthetic fields and
   mask, with one input channel and no climatology (the JAX package fails
   on that CLI's five x_vars and on climatology; the port raises): a
   forecast and three train steps in f32 and in bf16, finite, masked
   pixels 0, times and peaks above their start; no graph kernel launched;
   at 16×16, hidden 4, T_out 3 (dropout 0, teacher forcing 1) the card's
   forecast ≤1e-4 and one training forward's gradients ≤1e-4 ×
   max(1, max|g|) and running statistics ≤1e-5 against the port on the
   CPU (TF32 off);
60. one epoch of that trainer (2 training windows, 1 test window) fed
   through ``prefetch_to_device`` equals the epoch fed by the plain loader
   bit for bit (losses, weights, running statistics, generator); the
   prefetched x and y are CUDA tensors, the launch dates host numpy;
61. ``eval/mesh_design`` at 224×304: ``sweep_meshes`` over the June
   ``seasonal_variance`` of the synthetic siconc at four thresholds with
   the ice mask; node counts and reconstructions (≤1e-6) equal the CPU's
   (a mesh that differs prints the differing cell's criterion on both
   devices); K7 launches as read from the code (3 a mesh:
   ``expected_mesh_design_k7``), and K7 on one design's sets (node
   counts, pooling, degrees) bit-identical to the entry-ordered sum,
   timed beside its bound, plain version and ``index_add_``;
62. ``eval/results``: f32 CNN-LSTM forecasts of two launch months (June,
   September) through ``create_heatmap``, ``persistence_heatmap``,
   ``climatology_heatmap`` and ``full_report`` (the CSV path where
   matplotlib is absent): ``heatmap.csv`` and ``heatmap_clim.csv`` finite
   in the launch months' rows only;
63. ``eval/trace_summary``: one forecast and one train step of
   ``bench.py``'s model (ChebConv, f32, batch 16, remat none) under
   ``torch.profiler`` with CUDA activity, written by
   ``tensorboard_trace_handler`` and summarised: the trace's
   ``build_blocks_kernel``, ``apply_kernel`` and ``segment_*_kernel`` rows
   count the K1, K2 + K2b and K7 launch counters of the same run.

ROADMAP Queue 1 items 12 (data parallelism) and 13 (the CLIs and the
native host toolkit), phases 64-73, each through its entry point:

64. ``NextFramePredictorS2S(dp_devices=2)`` on ``bench.py``'s model
   (ChebConv, f32, no remat, global batch 16) in two ranks that
   ``parallel/dp.py`` ``launch`` spawns over gloo, sharing the card (8
   samples each), 2 steps at dropout 0 and 0.1 against the one-process
   steps on the same batches: losses within 1e-5, each step's gradients
   within 1e-4 × max(1, max|g|) and the first step's per parameter
   tensor within 1e-4 of its largest (2⁻²³ of the step's largest at
   least), weights within 1e-4 / 1e-6 plus twice Adam's first-order
   response to the gradient difference, the ranks' weights equal; K1 11, K2 112, K2b 110 and K7 119 launches a rank step, as the
   one-process step's, and each held against its plain version on the
   rank's shard (batch 8); each
   step's s and each all-reduce's ms (CUDA events) and bytes; each rank's
   draws are the global batch's rows of its shard, and the two differ;
65. one NCCL rank: bit for bit the one-process step; its all-reduce's ms;
66. ``cli/ice_exp.py -e 0`` at the flagship's widths (224×304 synthetic
   fields, 5 variables, hidden 32, 1 × 3 layers, per-gate stacks,
   climatology, remat full; T_out 10, 2 synthetic years, 1 epoch, batch
   8): the loss JSON, the weights and the validation predictions written,
   finite; K5 and K6 launches as read from the code;
67. ``cli/ice_inf.py`` on those weights: the validation predictions bit
   for bit ``ice_exp``'s, K5 as read;
68. ``ice_exp -e 9`` at the same size (batch 12): the multires curriculum
   (5 epochs on the 112×152 grid, K5/K6) into the heterogeneous preset
   mesh on the edge list (K7), launches as read; its peak;
69. ``cli/ice_exp_nwt.py`` (seed 7's 32×32 fields, no climatology, the
   pixelwise edge list, batch 64): K7 as read;
70. ``cli/ice_exp_cnnlstm.py`` raises the ``ValueError`` that the port's
   trainer raises where the JAX CLI fails;
71. ``cli/ice_profile.py --trace-dir --trace-summary``: the trace's K7 rows
   count the K7 launches of the traced ``train()``;
72. ``cli/mnist_demo.py`` on 16 videos (T_out 3): finite scores, K7 only;
73. ``native_ext.py`` built with g++ on this machine: the
   ``backend="native"`` Moving-MNIST videos repeat under their seed.

The CLI runs lift the divergence guard (``--max-loss``): random weights
are not trained to its bound. Phases 64-69, 71 and 72 keep the
operands of each kernel's first call at every width and grid of their
run and hold the kernel against its plain version on them (K1 bit for
bit, K2/K2b ≤1e-5, K5/K6 ≤1e-5 and K7 ≤1e-6, each × max(1, max|plain|)),
at the batch and the grid the entry point gave it.

Every plain run (phases 4, 7, 12, 15, 17, 22, 24, 29, 34, 38, 43, 45, 46,
47, 50-53) swaps each kernel it would launch for its plain version.

It fails at once without a CUDA card, and when the port's package is not
beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Optional
from unittest import mock

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, f32
# outside the tensor cores (the kernels use no TF32) and dense bf16
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

DEVICE = "cuda"
CANVAS, DIGIT = (64, 64), (18, 18)
T_IN, T_OUT, BATCH = 4, 10, 16
K2_TOL, ROLLOUT_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4
K3_TOL, K4_TOL = 1e-5, 1e-5
# bf16 (phases 26-38): kernels within one bf16 rounding of their plain
# versions (× max(1, max|plain|)), a kernel step's gradients within 2e-2 ×
# max(1, max|g|) of a plain step's, the first bf16 frame within 2e-2 of the
# f32 frame on average
BF16_TOL, BF16_GRAD_TOL, BF16_FRAME_TOL = 2.0**-7, 2e-2, 2e-2
REPS = 20
TRAIN_STEPS, LR = 8, 0.01


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = REPS, replays: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the card alone: ``reps``
    calls captured in one CUDA graph, replayed ``replays`` times between
    CUDA events, so that the host's launch rate does not enter."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def make_model(seed: int, run_dir: str = "runs", conv: str = "ChebConv",
               teacher_forcing_ratio: float = 0.0, dtype: str = "float32", remat=False,
               remesh_every: int = 1, graph_extra: Optional[dict] = None, **extra):
    """``bench.py``'s 64×64 Moving-MNIST model; ``remat`` is the per-step
    remat mode (False for the phases that predate it, so their numbers
    stay comparable); ``graph_extra`` overrides its ``graph_kwargs``
    (``adjacency``, ``aggregation``, ``message_dtype``, ``max_degree``);
    ``extra`` goes to the predictor (``remesh_input``, ``debug``,
    ``shared_mesh``)."""
    from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

    return NextFramePredictorS2S(
        image_shape=CANVAS, thresh=0.1,
        input_features=1, input_timesteps=T_IN, output_timesteps=T_OUT,
        device=DEVICE, seed=seed, run_dir=run_dir,
        teacher_forcing_ratio=teacher_forcing_ratio, **extra,
        model_kwargs=dict(hidden_size=16, n_layers=2, n_conv_layers=2,
                          convolution_type=conv, compute_dtype=dtype, remat=remat,
                          remesh_every=remesh_every),
        graph_kwargs=dict(dict(max_grid_size=8, n_max=2048, e_max=10240, node_budget=2048,
                               agg_eb=1024, agg_sw=1024, aggregation="pallas"),
                          **(graph_extra or {})),
    )


class Capture:
    """Wraps the kernel launchers during one extra forecast and keeps the
    operands of the first two mesh builds and, per width F, of the first
    decoder step's Â·z (or the first call at a width the decoder does not
    use), plus the number of calls at each width."""

    def __init__(self, spmm, enc_calls: int, dec_step_calls: int):
        self.spmm = spmm
        self.builds, self.per_width = [], {}
        self.first_ops, self.dec0_ops = {}, {}
        self.calls = 0
        self.dec0 = range(enc_calls, enc_calls + dec_step_calls)
        self._build, self._apply = spmm._build_blocks_cuda, spmm._apply_cuda

    def build(self, *args):
        if len(self.builds) < 2:
            self.builds.append(args)
        return self._build(*args)

    def apply(self, *args):
        f = args[0].shape[-1]
        self.per_width[f] = self.per_width.get(f, 0) + 1
        (self.dec0_ops if self.calls in self.dec0 else self.first_ops).setdefault(f, args)
        self.calls += 1
        return self._apply(*args)

    def operands(self):
        """{F: args}: the first decoder step's where it has F, else the
        first call's."""
        return dict(sorted({**self.first_ops, **self.dec0_ops}.items()))

    def __enter__(self):
        self._patches = [mock.patch.object(self.spmm, "_build_blocks_cuda", self.build),
                         mock.patch.object(self.spmm, "_apply_cuda", self.apply)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in reversed(self._patches):
            p.stop()


def make_trainer(seed: int, run_dir: str, conv: str = "ChebConv",
                 teacher_forcing_ratio: float = 0.0, dtype: str = "float32", remat=False,
                 **extra):
    """The main path's model, ready to train (Adam at lr 0.01, γ 0.95);
    ``extra`` as :func:`make_model` takes it."""
    model = make_model(seed, run_dir, conv, teacher_forcing_ratio, dtype, remat, **extra)
    model.initiate_training(lr=LR, lr_decay=0.95)
    return model


def expected_launches(cfg) -> dict:
    """Kernel launches of one full-BPTT train step, read from the code:
    K1 once per mesh (the encoder's and one remesh after every decoder
    step); K2 twice per conv layer (K = 3 taps) of every encoder cell
    step, decoder cell step (1 conv layer each) and head conv (2); K2b
    for every K2 whose input requires grad, which is all of them but the
    first conv layer of encoder layer 0 at step 0: there ``[x ‖ h]`` holds
    the input frame and the zero initial state, and no parameter. K7 as
    :func:`expected_quadtree_k7` reads it."""
    k2 = 2 * (T_IN * cfg.n_layers * cfg.n_conv_layers + T_OUT * (cfg.n_layers + 2))
    return {"spmm_build_blocks": 1 + T_OUT, "spmm_apply": k2, "spmm_apply_bwd": k2 - 2,
            "segment_sum": expected_quadtree_k7(cfg, 3, train=True)}


def expected_quadtree_k7(cfg, per_mesh: int, train: bool = False) -> int:
    """K7 launches of one forecast batch (``train``: one full-BPTT train
    step) on the remeshing quadtree paths, read from the code: every mesh
    (the encoder's and one remesh after each decoder step) sums its node
    counts and pools its pixels, and the ChebConv path also sums its
    degrees (``per_mesh`` 3, else 2); every remesh pools each layer's H
    and C onto the new mesh. A train step's backward adds the gather of
    every decoder step's frame and of the H and C that every remesh but
    the last carries (the last one's feed no loss)."""
    k7 = (1 + T_OUT) * per_mesh + T_OUT * 2 * cfg.n_layers
    if train:
        k7 += T_OUT + (T_OUT - 1) * 2 * cfg.n_layers
    return k7


def k7_plain(values, ids, n_out: int, view):
    """K7's plain version with its launcher's signature, to swap in."""
    from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import segment_sum_plain

    return segment_sum_plain(values, ids, n_out)


def expected_attn_launches(cfg) -> int:
    """K3 launches of one forecast batch or train step of the
    TransformerConv model, read from the code: one per conv layer of every
    encoder cell step (the 2·4 gate streams of a layer run as the heads of
    one call), one per decoder cell step (1 conv layer each) and one per
    head conv (2) per decoder step. A train step launches K4 as often:
    every q, k and v is a projection with parameters, so each call needs
    its gradient."""
    return T_IN * cfg.n_layers * cfg.n_conv_layers + T_OUT * (cfg.n_layers + 2)


def train_batches(seed: int, n: int):
    """``n`` batches of 16 made as ``bench.py`` ``measure`` makes them."""
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    ds = ModMovingMNISTDataset(
        BATCH * n, input_timesteps=T_IN, output_timesteps=T_OUT, canvas_size=CANVAS,
        digit_size=DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=seed,
    )
    return ds, [(ds.x[i * BATCH:(i + 1) * BATCH], ds.y[i * BATCH:(i + 1) * BATCH])
                for i in range(n)]


class GradFnCheck:
    """Wraps a differentiable op (``spmm_apply`` or ``attn_apply``) for one
    train step and records every output whose first input requires grad
    but whose autograd node is not ``node``."""

    def __init__(self, module, name: str, node: str):
        self.module, self.name, self.node = module, name, node
        self.calls, self.bad = 0, []
        self._apply = getattr(module, name)

    def __call__(self, z, *args):
        out = self._apply(z, *args)
        if z.requires_grad:
            self.calls += 1
            if type(out.grad_fn).__name__ != self.node:
                self.bad.append(type(out.grad_fn).__name__)
        return out

    def __enter__(self):
        self._patch = mock.patch.object(self.module, self.name, self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


class CaptureBwd:
    """Wraps a backward launcher (K2b's or K4's) during one train step and
    keeps the operands of the first call at each width F (the last axis of
    its first operand), with the calls per F."""

    def __init__(self, module, name: str):
        self.module, self.name, self.first, self.per_width = module, name, {}, {}
        self._launch = getattr(module, name)

    def __call__(self, *args):
        f = args[0].shape[-1]
        self.per_width[f] = self.per_width.get(f, 0) + 1
        self.first.setdefault(f, args)
        return self._launch(*args)

    def __enter__(self):
        self._patch = mock.patch.object(self.module, self.name, self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


class Record:
    """Wraps a module function during a run and keeps the arguments and
    the result of every call."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls, self.results = module, name, [], []
        self._fn = getattr(module, name)

    def __call__(self, *args):
        self.calls.append(args)
        self.results.append(self._fn(*args))
        return self.results[-1]

    def __enter__(self):
        self._patch = mock.patch.object(self.module, self.name, self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


class FirstAtWidth:
    """Wraps a launcher during a run and keeps the arguments of its first
    call whose first argument is ``width`` wide (detached), passing every
    call through."""

    def __init__(self, module, name: str, width: int):
        self.module, self.name, self.width, self.args = module, name, width, None
        self._fn = getattr(module, name)

    def __call__(self, *args):
        if self.args is None and args[0].shape[-1] == self.width:
            self.args = tuple(a.detach() if hasattr(a, "detach") else a for a in args)
        return self._fn(*args)

    def __enter__(self):
        self._patch = mock.patch.object(self.module, self.name, self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


class AttnCapture:
    """Wraps an attention forward launcher (K3's or K5's) during one
    forecast and keeps, per width HD, the operands of the first decoder
    step's call (or of the first call at a width the decoder does not use),
    plus the calls at each width."""

    def __init__(self, module, name: str, enc_calls: int, dec_step_calls: int):
        self.module, self.name, self.calls, self.per_width = module, name, 0, {}
        self.first_ops, self.dec0_ops = {}, {}
        self.dec0 = range(enc_calls, enc_calls + dec_step_calls)
        self._launch = getattr(module, name)

    def __call__(self, *args):
        hd = args[0].shape[-1]
        self.per_width[hd] = self.per_width.get(hd, 0) + 1
        (self.dec0_ops if self.calls in self.dec0 else self.first_ops).setdefault(hd, args)
        self.calls += 1
        return self._launch(*args)

    def operands(self):
        return dict(sorted({**self.first_ops, **self.dec0_ops}.items()))

    def __enter__(self):
        self._patch = mock.patch.object(self.module, self.name, self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def held_launchers(spmm, grid_attn, segment_sum):
    """Every f32 kernel launcher an entry point's run may reach, with its
    plain version and its tolerance × max(1, max|plain|) (0: bit for
    bit): (kernel, module, launcher, plain)."""
    return [("spmm_build_blocks", spmm, "_build_blocks_cuda", spmm.build_blocks_plain, 0.0),
            ("spmm_apply", spmm, "_apply_cuda", spmm.apply_plain, K2_TOL),
            ("spmm_apply_bwd", spmm, "_apply_bwd_cuda", spmm.apply_plain, K2_TOL),
            ("grid_attn_apply", grid_attn, "_grid_attn_fwd_cuda", grid_attn.grid_attn_plain,
             K6_TOL),
            ("grid_attn_apply_bwd", grid_attn, "_grid_attn_bwd_cuda",
             grid_attn.grid_attn_bwd_plain, K6_TOL),
            ("segment_sum", segment_sum, "_segment_sum_cuda", k7_plain, K7_TOL)]


class HoldCapture:
    """Wraps the launchers of :func:`held_launchers` during an entry
    point's run and keeps the operands of each kernel's first call at
    every operand shape but the batch (a width, a grid, an edge count),
    passing every call through; :meth:`hold` then holds each kernel
    against its plain version on those operands, at the batch and the
    grid the run gave it."""

    def __init__(self, launchers):
        self.launchers, self.first, self._patches = launchers, {}, []

    def _wrap(self, kernel, launch):
        def call(*args, **kw):
            self.first.setdefault((kernel, tuple(args[0].shape[1:])), (args, kw))
            return launch(*args, **kw)
        return call

    def __enter__(self):
        for kernel, module, name, _, _ in self.launchers:
            patch = mock.patch.object(module, name, self._wrap(kernel, getattr(module, name)))
            patch.start()
            self._patches.append(patch)
        return self

    def __exit__(self, *exc):
        for patch in reversed(self._patches):
            patch.stop()

    def hold(self, what: str) -> list:
        """Each kept call again, on the kernel and on its plain version:
        one row per (kernel, shape) with the batch, the shape and the
        error; fails the phase when a kernel disagrees. The operands are
        dropped afterwards."""
        import torch

        rows = []
        for (kernel, shape), (args, kw) in sorted(self.first.items(), key=str):
            _, module, name, plain, tol = next(h for h in self.launchers if h[0] == kernel)
            with torch.no_grad():
                got, want = getattr(module, name)(*args, **kw), plain(*args, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = [float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
                    for a, b in zip(got, want)]
            rel = max(e / max(1.0, float(b.abs().max()) if b.numel() else 1.0)
                      for e, b in zip(errs, want))
            check(rel <= tol, f"{what}: {kernel} differs from its plain version at batch "
                              f"{args[0].shape[0]}, operand {tuple(args[0].shape)}: {rel}")
            rows.append(dict(kernel=kernel, batch=int(args[0].shape[0]),
                             operand=list(args[0].shape), max_abs_err=max(errs),
                             err_rel_to_max=rel, tol=tol,
                             bit_identical=all(torch.equal(a, b) for a, b in zip(got, want))))
        self.first.clear()
        return rows


def step_with_meshes(trainer, x, y, seed: int):
    """One ``train_step`` with its own generator; returns (loss, overflow,
    {name: grad}, meshes (T_out, B, P) the decoder ran on)."""
    import torch

    seq = trainer.model
    meshes = []
    decode = seq.decode

    def recording_decode(*args, **kw):
        out = decode(*args, **kw)
        meshes.append(out[2])
        return out

    seq.decode = recording_decode
    try:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        loss, overflow = trainer.train_step(x, y, generator=gen)
    finally:
        del seq.decode
    grads = {n: p.grad.detach().clone() for n, p in seq.named_parameters()}
    return loss, overflow, grads, torch.cat(meshes)


def _peak_flops(itemsize: int) -> float:
    """The card's peak rate for the operands' type: f32 (4 B) or bf16 (2 B)."""
    return PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS


def k1_bound_ms(src_rel, dst_rel, live, nt, sw, itemsize: int = 4):
    """Least time for K1's work: read the live tiles' windows (3 × 4 B a
    slot) and write every block once (``itemsize`` B an entry: 4 in f32, 2
    in bf16); one add a valid slot."""
    import torch

    b, t, eb = src_rel.shape
    n_live = int(live.long().sum())
    nbytes = n_live * eb * 12 + b * t * nt * sw * itemsize
    tile = torch.arange(t, device=src_rel.device)[None, :, None]
    valid = (src_rel >= 0) & (dst_rel >= 0) & (tile < live[:, None, None])
    ops = int(valid.sum())
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / _peak_flops(itemsize) * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def k2_bound_ms(s0, blocks, live, n_max, nt, sw, f, batch):
    """Least time for K2's work: per live tile its Â block (NT·SW entries)
    read once, each row of z that a live tile's source window covers read
    once (windows of one sample overlap), the output written once, each in
    the blocks' type (4 B in f32, 2 B in bf16); one multiply and add a
    feature for every non-zero of the live tiles' blocks (the work depends
    on the data: a zero entry adds nothing), at that type's peak rate."""
    import torch

    size = blocks.element_size()
    n_live = int(live.long().sum())
    alive = torch.arange(blocks.shape[1], device=blocks.device)[None, :] < live[:, None]
    rows = s0.long()[..., None] + torch.arange(sw, device=s0.device)  # (B, T, SW)
    hit = alive[..., None] & (rows < n_max)
    covered = torch.zeros(batch, n_max + 1, dtype=torch.bool, device=s0.device)
    covered.scatter_(1, torch.where(hit, rows, n_max).reshape(batch, -1), True)
    nbytes = (n_live * nt * sw + int(covered[:, :n_max].sum()) * f + batch * n_max * f) * size
    ops = 2 * f * int((blocks[alive] != 0).sum())
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / _peak_flops(size) * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def attn_bound_ms(attn, args, backward: bool):
    """Least time for K3's (or K4's) work on these operands: per slot that
    reaches a visible row, its indices, attributes and keep values read
    once (4 B each); each q row with a slot, each k and v row that is a
    source (and, for K4, each g row with a slot) read once; Wₑ read once;
    the output (K4: dq, dk, dv, dWₑ) written once, in q's type (4 B in f32,
    2 B in bf16). Operations per such slot: the edge term, logit and
    weighted sum, 2·A·HD + 4·HD (K4: recompute plus backward, 4·A·HD +
    11·HD), at the peak rate of q's type."""
    import torch

    q, _k, _v, we, keep, meta, dims = args[:7]
    b, n_max, hd = q.shape
    size = q.element_size()
    a = we.shape[0]
    kh = 0 if keep is None else keep.shape[2]
    dst, src = attn.slot_nodes(meta, dims)
    base = torch.arange(b, device=q.device)[:, None] * n_max
    n_slots = int((dst >= 0).sum())
    rows_q = int(torch.unique((dst + base)[dst >= 0]).numel())
    rows_kv = int(torch.unique((src + base)[src >= 0]).numel())
    nbytes = (n_slots * (8 + 4 * a + 4 * kh) + (rows_q + 2 * rows_kv) * hd * size
              + a * hd * size + b * n_max * hd * size)
    ops = n_slots * (2 * a * hd + 4 * hd)
    if backward:
        nbytes += rows_q * hd * size + 2 * b * n_max * hd * size + a * hd * size
        ops = n_slots * (4 * a * hd + 11 * hd)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / _peak_flops(size) * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


# ---------------------------------------------------------------- sea ice
# The JAX package's committed sea-ice flagship (bench.py ice workload,
# cli/ice_exp.py): pixelwise 224×304 grid, 5 variables, 10 → 90 days,
# hidden 32, 1 LSTM layer × 3 conv layers, TransformerConv, climatology
# concat, batch 1; synthetic fields and the Hudson-Bay-like mask from the
# port's own copies, made from --seed.
ICE_SHAPE, ICE_T_IN, ICE_T_OUT = (224, 304), 10, 90
ICE_VARS = ["siconc", "t2m", "v10", "u10", "sshf"]
ICE_MONTH, ICE_FORECASTS, ICE_TRAIN_STEPS = 6, 2, 3
ICE_SHORT_T_OUT = 6  # the kernel-vs-plain step pair: plain keeps D shifted copies a call
ICE_TBPTT = 0        # full BPTT
K6_TOL = 1e-5


def make_ice_model(seed: int, run_dir: str = "runs", t_out: Optional[int] = None,
                   aggregation: str = "grid", dtype: str = "float32", remat=False,
                   fused_gates: bool = True, conv: str = "TransformerConv",
                   transform_func=None):
    """The flagship forecaster (T_out ``t_out``, default 90) on the
    pixelwise grid or, with ``aggregation="xla"``, the pixelwise edge list,
    computing in ``dtype``, with per-step ``remat``, the fused or
    per-gate gate layout, the convolution ``conv`` (GCNConv: the JAX
    package's experiment 1, ``cli/ice_exp.py``) and the predictor's
    ``transform_func``; random weights from ``seed``. Experiments 9 and
    10 (``ice_exp.py`` :333-366) are this model on the edge list with
    remat and ``dist_from_05`` (:func:`make_preset_model`)."""
    from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

    return NextFramePredictorS2S(
        image_shape=ICE_SHAPE, thresh=float("-inf"), decompose=False,
        input_features=len(ICE_VARS), input_timesteps=ICE_T_IN,
        output_timesteps=ICE_T_OUT if t_out is None else t_out,
        transform_func=transform_func,
        use_climatology=True, device=DEVICE, seed=seed, run_dir=run_dir,
        model_kwargs=dict(hidden_size=32, dropout=0.1, n_layers=1, n_conv_layers=3,
                          convolution_type=conv, fused_gates=fused_gates,
                          compute_dtype=dtype, remat=remat),
        graph_kwargs=dict(aggregation=aggregation),
    )


# bench.py make_ice_predictor(mesh="quadtree") at its defaults (:343-357,
# :376-388): the flagship's model on quadtree meshes of the transformed
# criterion, remeshed every decoder step, on attention windows
ICE_QUAD_BUDGET = 16384


def make_ice_quadtree_model(seed: int, run_dir: str = "runs", t_out: Optional[int] = None,
                            dtype: str = "bfloat16", remat=True, adjacency: str = "sort"):
    """The ice-quadtree forecaster (``bench.py --workload ice-quadtree``):
    thresh 0.15 on ``dist_from_05`` of the criterion, max_grid_size 8,
    n_max = node_budget 16384, e_max 8 × 16384, attention windows NT 128,
    EB = SW = 1024, the "sort" adjacency (``adjacency``: ``bench.py
    --adjacency``); TransformerConv with fused gates
    (8 streams × d 32 = HD 256), hidden 32, 1 × 3 layers, climatology,
    bf16 and full remat by default; random weights from ``seed``."""
    from quadtree_mpnnlstm_tpu_torch.graph.quadtree import dist_from_05
    from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

    return NextFramePredictorS2S(
        image_shape=ICE_SHAPE, thresh=0.15, decompose=True, transform_func=dist_from_05,
        input_features=len(ICE_VARS), input_timesteps=ICE_T_IN,
        output_timesteps=ICE_T_OUT if t_out is None else t_out,
        use_climatology=True, device=DEVICE, seed=seed, run_dir=run_dir,
        model_kwargs=dict(hidden_size=32, dropout=0.1, n_layers=1, n_conv_layers=3,
                          convolution_type="TransformerConv", fused_gates=True,
                          compute_dtype=dtype, remat=remat),
        graph_kwargs=dict(max_grid_size=8, n_max=ICE_QUAD_BUDGET, e_max=8 * ICE_QUAD_BUDGET,
                          node_budget=ICE_QUAD_BUDGET, aggregation="pallas", agg_nt=128,
                          agg_eb=1024, agg_sw=1024, adjacency=adjacency),
    )


def ice_data(seed: int):
    """(IceDataset test windows of one month, climatology (366, rows, cols),
    mask) from the synthetic fields of 2016 and the ice mask (the union of
    the fields' open-water band and the land mask is what the model sees)."""
    from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import (
        IceDataset,
        climatology_from_dataset,
        ice_mask,
        synthetic_dataset,
    )

    ds, band = synthetic_dataset(shape=ICE_SHAPE, years=(2016, 2017), seed=seed)
    data = IceDataset(ds, [2016], ICE_MONTH, ICE_T_IN, ICE_T_OUT, ICE_VARS, ["siconc"])
    return data, climatology_from_dataset(ds, "siconc"), ice_mask(ICE_SHAPE, seed) | band


def expected_grid_launches(cfg) -> int:
    """K5 launches of one flagship forecast (or train step: K6 as many),
    read from the code: one per conv layer of every encoder step (the 2·4
    gate streams of a layer are the heads of one call), one per decoder
    step's cell (1 conv layer) and one per head conv (2) per decoder step."""
    return (ICE_T_IN * cfg.n_layers * cfg.n_conv_layers
            + cfg.output_timesteps * (cfg.n_layers + 2))


def grid_bound_ms(args, backward: bool):
    """Least time for K5's (or K6's) work on these operands: the rows of
    q, k, v (K6 also g) and the keep planes at valid pixels read once (a
    masked pixel and its edges add nothing), e_dir and valid read once, the
    output (K6: dq, dk, dv, de_dir) written once at every pixel, as the
    wrappers allocate it; rows, e_dir and valid in q's type (4 B in f32, 2 B
    in bf16), keep 4 B. Operations per edge (a valid pixel's valid
    neighbour): the edge term, logit and weighted sum, 6·H (K6: recompute
    plus backward, 14·H), at the peak rate of q's type."""
    from quadtree_mpnnlstm_tpu_torch.ops.grid import neighbor_valid, shifts_for

    q, _k, _v, e_dir, valid, keep, dims = args[:7]
    b, p, h = q.shape
    size = q.element_size()
    n_valid = int((valid != 0).sum())
    rows_in, rows_out = b * n_valid * h * size, b * p * h * size
    fixed = (e_dir.numel() * size + valid.numel() * size
             + (0 if keep is None else b * dims.ndirs * n_valid * dims.heads * 4))
    valid2d = (valid != 0).reshape(1, dims.rows, dims.cols)
    edges = b * sum(int(neighbor_valid(valid2d, dr, dc).sum())
                    for dr, dc in shifts_for(dims.ndirs == 8))
    if backward:
        nbytes, ops = 4 * rows_in + 3 * rows_out + fixed + e_dir.numel() * size, 14 * h * edges
    else:
        nbytes, ops = 3 * rows_in + rows_out + fixed, 6 * h * edges
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / _peak_flops(size) * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def block_diag_csr(s0, blocks, n_max, nt, sw):
    """Â of every sample as one block-diagonal sparse CSR matrix, for the
    library yardstick (torch.sparse.mm)."""
    import torch

    b, t = s0.shape
    bi, ti, ri, si = torch.nonzero(blocks, as_tuple=True)
    rows = bi * n_max + ti * nt + ri
    cols = bi * n_max + s0.long()[bi, ti] + si
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), blocks[bi, ti, ri, si],
                                  (b * n_max, b * n_max), check_invariants=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "CSR support is in beta"
        return coo.coalesce().to_sparse_csr()


def train_phases(seed: int, card: str, spmm, segment_sum, cfg, nt: int, sw: int, n_max: int):
    """Phases 5-8 on the training path; returns the launches of the timed
    train steps and K2b's per-width measurements."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader

    # ---- phase 5: the train path through train_step
    run_dir = tempfile.TemporaryDirectory()
    trainer = make_trainer(seed, run_dir.name)
    want = expected_launches(cfg)
    _, batches = train_batches(seed, TRAIN_STEPS + 1)
    with GradFnCheck(spmm, "spmm_apply", "SpmmApplyBackward") as gcheck:
        loss, overflow = trainer.train_step(*batches[0])  # warm-up
    check(float(loss) == float(loss), "warm-up loss is NaN")
    check(not gcheck.bad and gcheck.calls == want["spmm_apply_bwd"],
          f"Â·z outputs without the K2b node: {gcheck.bad[:3]} "
          f"({gcheck.calls} outputs required grad)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmm.reset_launch_counts()
    segment_sum.reset_launch_counts()
    t0 = time.perf_counter()
    losses, worst, pending = [], 0, None
    for x_b, y_b in batches[1:]:
        loss, overflow = trainer.train_step(x_b, y_b)
        if pending is not None:  # one step late, as train() drains
            losses.append(float(pending[0]))
            worst = max(worst, int(pending[1]))
        pending = (loss, overflow)
    losses.append(float(pending[0]))
    worst = max(worst, int(pending[1]))
    train_s = time.perf_counter() - t0
    train_launches = {**spmm.LAUNCHES, **segment_sum.LAUNCHES}
    per_step = {k: v / TRAIN_STEPS for k, v in train_launches.items()}
    check(bool(np.isfinite(losses).all()), f"non-finite training loss {losses}")
    check(worst == 0, f"mesh overflow {worst} in training")
    check(per_step == {k: float(v) for k, v in want.items()},
          f"launches per step {per_step}, expected {want}")
    print(json.dumps({
        "phase": "train_path", "card": card, "batch": BATCH, "steps": TRAIN_STEPS,
        "seconds": train_s, "steps_per_s": TRAIN_STEPS / train_s,
        "frames_per_s": TRAIN_STEPS * BATCH * T_OUT / train_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": losses, "overflow": worst, "launches_per_step": per_step,
        "k2_outputs_checked": gcheck.calls,
    }), flush=True)

    # ---- phase 6: one epoch of train(), then score()
    entry = make_trainer(seed, run_dir.name)
    train_set = ArrayDataset(np.concatenate([b[0] for b in batches[:2]]),
                             np.concatenate([b[1] for b in batches[:2]]), np.zeros(2 * BATCH))
    loader_train = DataLoader(train_set, batch_size=BATCH)
    loader_test = DataLoader(ArrayDataset(batches[2][0], batches[2][1], np.zeros(BATCH)),
                             batch_size=BATCH)
    t0 = time.perf_counter()
    entry.train(loader_train, loader_test, n_epochs=1, divergence_threshold=float("inf"))
    epoch_s = time.perf_counter() - t0
    score = entry.score(loader_test)
    check(bool(np.isfinite(entry.loss["train_loss"] + entry.loss["test_loss"]).all()),
          f"non-finite epoch losses {entry.loss}")
    check(np.isfinite(score["MSE"]), f"score() gave {score}")
    print(json.dumps({"phase": "train_entry", "card": card, "epoch_s": epoch_s,
                      "train_loss": entry.loss["train_loss"][0],
                      "test_loss": entry.loss["test_loss"][0], "score": score}), flush=True)

    # ---- phase 7: K2b vs its plain version, then a step on each path
    x_g, y_g = batches[0]
    with CaptureBwd(spmm, "_apply_bwd_cuda") as cap_b:
        make_trainer(seed, run_dir.name).train_step(x_g, y_g)
    bwd_widths = []
    for f, bargs in sorted(cap_b.first.items()):
        g, s0, blocks, live = bargs[:4]
        kern = spmm._apply_bwd_cuda(*bargs)
        plain = spmm.apply_plain(*bargs)
        err = float((kern - plain).abs().max())
        check(err <= K2_TOL, f"K2b differs from its plain version at F={f}: {err}")
        csr = block_diag_csr(s0, blocks, n_max, nt, sw)
        gf = g.reshape(-1, f)
        bound, b_ms, o_ms = k2_bound_ms(s0, blocks, live, n_max, nt, sw, f, g.shape[0])
        bwd_widths.append(dict(
            F=f, calls=cap_b.per_width[f], max_abs_err=err, live_tiles=int(live.long().sum()),
            ms=graph_ms(lambda: spmm._apply_bwd_cuda(*bargs)),
            events_ms=cuda_ms(lambda: spmm._apply_bwd_cuda(*bargs)),
            **rowwarp_times(spmm, bargs, kern, f"K2b at F={f}"),
            plain_ms=cuda_ms(lambda: spmm.apply_plain(*bargs)),
            **library_times(lambda: torch.sparse.mm(csr, gf)),
            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms,
        ))
    check(sum(w["calls"] for w in bwd_widths) == want["spmm_apply_bwd"],
          "capture step disagrees with the train path")
    loss_k, _, grads_k, meshes_k = step_with_meshes(make_trainer(seed, run_dir.name),
                                                    x_g, y_g, seed=1)
    with mock.patch.object(spmm, "_build_blocks_cuda", spmm.build_blocks_plain), \
            mock.patch.object(spmm, "_apply_cuda", spmm.apply_plain), \
            mock.patch.object(spmm, "_apply_bwd_cuda", spmm.apply_plain), \
            mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain):
        loss_p, _, grads_p, meshes_p = step_with_meshes(
            make_trainer(seed, run_dir.name), x_g, y_g, seed=1)
    check(torch.equal(meshes_k, meshes_p), "kernel and plain train steps ran on different meshes")
    leaf_err = max(float((grads_k[n] - grads_p[n]).abs().max())
                   / max(1.0, float(grads_p[n].abs().max())) for n in grads_p)
    check(leaf_err <= GRAD_TOL, f"gradients differ from the plain path by {leaf_err}")
    print(json.dumps({
        "phase": "grads_vs_plain", "card": card, "k2b_by_width": bwd_widths,
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
        "max_leaf_err_rel": leaf_err, "leaves": len(grads_p), "meshes_identical": True,
    }), flush=True)

    # ---- phase 8: the same train step again is bit-identical
    loss_k2, _, grads_k2, meshes_k2 = step_with_meshes(make_trainer(seed, run_dir.name),
                                                       x_g, y_g, seed=1)
    same = (torch.equal(loss_k, loss_k2) and torch.equal(meshes_k, meshes_k2)
            and all(torch.equal(grads_k[n], grads_k2[n]) for n in grads_k))
    check(same, "two identical train steps differ")
    print(json.dumps({"phase": "train_determinism", "card": card, "loss": float(loss_k2),
                      "bit_identical": same}), flush=True)
    run_dir.cleanup()
    return train_launches, bwd_widths


def attn_phases(seed: int, card: str, spmm, attn, segment, segment_sum, loader, x):
    """Phases 9-12 on the TransformerConv path; returns the forecast's and
    the timed train steps' launches, K3's and K4's per-width measurements
    and K7's per operand set of this path."""
    import torch

    run_dir = tempfile.TemporaryDirectory()
    conv = "TransformerConv"

    def reset():
        for m in (spmm, attn, segment_sum):
            m.reset_launch_counts()

    def counts():
        return {**spmm.LAUNCHES, **attn.LAUNCHES, **segment_sum.LAUNCHES}

    # ---- phase 9: predict() on the attention path
    model = make_model(seed, run_dir.name, conv)
    cfg = model.cfg
    k3 = expected_attn_launches(cfg)
    check(model.gcfg.attn_windows and not model.gcfg.carry_edges,
          f"the predictor did not switch to attention windows: {model.gcfg}")
    model.predict(loader)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    y = model.predict(loader)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = counts()
    check(y.shape == (BATCH, T_OUT, *CANVAS, 1), f"attention predict shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite attention forecast")
    check(model.last_overflow == 0, f"attention mesh overflow {model.last_overflow}")
    k7 = expected_quadtree_k7(cfg, 2)
    check(launches["attn_apply"] == k3 and launches["attn_apply_bwd"] == 0
          and launches["segment_sum"] == k7,
          f"attention forecast launches {launches}, expected K3 {k3}, K7 {k7}")
    check(all(launches[n] == 0 for n in spmm.LAUNCHES), f"Â-block kernels ran: {launches}")
    print(json.dumps({
        "phase": "attn_path", "card": card, "batch": BATCH, "batch_s": batch_s,
        "frames_per_s": BATCH * T_OUT / batch_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "overflow": model.last_overflow, "launches": launches,
    }), flush=True)

    # ---- phase 10: K3 and K4 against their plain versions
    enc_calls = T_IN * cfg.n_layers * cfg.n_conv_layers
    p = CANVAS[0] * CANVAS[1]
    with AttnCapture(attn, "_attn_fwd_cuda", enc_calls, cfg.n_layers + 2) as cap, \
            SegmentCapture(segment, p, keep=True, counts=True) as seg_f:
        model.forecast(x)
    check(cap.calls == k3, "attention capture run disagrees with the path")

    def k3_measure(args, calls):
        geometry = {}
        with torch.no_grad():
            out = attn._attn_fwd_cuda(*args, geometry=geometry)
            err = float((out - attn.attn_plain(*args)).abs().max())
            check(torch.equal(out, attn._attn_fwd_cuda(*args)),
                  f"K3 differs from itself on a repeat at HD={args[0].shape[-1]}")
        check(err <= K3_TOL, f"K3 differs from attn_plain at HD={args[0].shape[-1]}: {err}")
        bound, b_ms, o_ms = attn_bound_ms(attn, args, backward=False)
        return dict(HD=args[0].shape[-1], calls=calls, max_abs_err=err, repeat_identical=True,
                    live_tiles=int(args[5].live.long().sum()),
                    plan=attn.fwd_plan(args[6])._asdict(), geometry=geometry,
                    ms=graph_ms(lambda: attn._attn_fwd_cuda(*args)),
                    events_ms=cuda_ms(lambda: attn._attn_fwd_cuda(*args)),
                    plain_ms=cuda_ms(lambda: attn.attn_plain(*args)),
                    bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms)

    fwd = [k3_measure(args, cap.per_width[hd]) for hd, args in cap.operands().items()]
    check(sorted(w["HD"] for w in fwd) == [1, 16, 128], f"K3 widths {[w['HD'] for w in fwd]}")
    # K3 at 8 heads × d 32 on the HD-128 call's windows, operands from the seed
    q128, _, _, we128, _, meta, dims = cap.operands()[128]
    gen = torch.Generator(DEVICE).manual_seed(seed)
    wide_dims = dims._replace(heads=8, d=32)
    qkv = [torch.randn(*q128.shape[:2], 256, device=DEVICE, generator=gen) for _ in range(3)]
    wide = k3_measure((*qkv, torch.randn(we128.shape[0], 256, device=DEVICE, generator=gen),
                       None, meta, wide_dims), 0)
    _, batches = train_batches(seed, TRAIN_STEPS + 1)
    x_g, y_g = batches[0]
    segment_sum.reset_launch_counts()
    with CaptureBwd(attn, "_attn_bwd_cuda") as cap_b, \
            SegmentCapture(segment, p, keep=True, counts=True) as seg_t:
        make_trainer(seed, run_dir.name, conv).train_step(x_g, y_g)
    check(sum(cap_b.per_width.values()) == k3, f"K4 calls {cap_b.per_width}, expected {k3}")
    check(sum(seg_t.calls.values()) == segment_sum.LAUNCHES["segment_sum"],
          f"K7 capture {seg_t.calls} disagrees with the step's launches")
    # K7 on this path's own operands: each set of the train step, with the
    # forecast's operands where it has the set
    sets = {**seg_t.ops, **seg_f.ops}
    k7_sets = [k7_measure(segment_sum, key, sets[key], seg_t.calls.get(key, 0))
               for key in sorted(sets)]
    del seg_f, seg_t, sets
    bwd = []
    for hd, args in sorted(cap_b.first.items()):
        errs, rel, geometry = {}, {}, {}
        kern = attn._attn_bwd_cuda(*args, geometry=geometry)
        for name, a, p in zip(("dq", "dk", "dv", "dwe"), kern, attn.attn_bwd_plain(*args)):
            errs[name] = float((a - p).abs().max())
            rel[name] = errs[name] / max(1.0, float(p.abs().max()))
        check(max(rel.values()) <= K4_TOL, f"K4 differs from the plain backward at HD={hd}: "
              f"{rel}")
        check(all(torch.equal(a, b) for a, b in zip(kern, attn._attn_bwd_cuda(*args))),
              f"K4 differs from itself on a repeat at HD={hd}")
        check(args[8] is not None, "K4 ran without the graph's slot view")
        bound, b_ms, o_ms = attn_bound_ms(attn, args, backward=True)
        # the whole backward: both kernels, the dWₑ sum and the allocations,
        # on the graph's view; by graph (the card's own time) and by events
        bwd.append(dict(HD=hd, calls=cap_b.per_width[hd], abs_err=errs, err_rel_to_max=rel,
                        max_abs_err=max(errs.values()), keep=args[4] is not None,
                        live_tiles=int(args[5].live.long().sum()), repeat_identical=True,
                        plan=attn.bwd_plan(args[6])._asdict(), geometry=geometry,
                        ms=graph_ms(lambda: attn._attn_bwd_cuda(*args)),
                        events_ms=cuda_ms(lambda: attn._attn_bwd_cuda(*args)),
                        plain_ms=cuda_ms(lambda: attn.attn_bwd_plain(*args)),
                        bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
    # the per-mesh views a remesh builds on this path: the pixel view (K7's
    # pooling) and K4's source-sorted slot view, timed on one decoder mesh
    from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
    from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding

    graph, _ = image_to_graph(add_positional_encoding(torch.as_tensor(y_g[:, :1],
                                                                      device=DEVICE)),
                              model.gcfg)
    vdims = attn.AttnDims(model.gcfg.n_max, model.gcfg.agg_nt, model.gcfg.agg_eb,
                          model.gcfg.agg_sw, 1, 1)
    views = dict(pixel_view_ms=cuda_ms(lambda: segment_sum.segment_view(graph.pixel_node,
                                                                         model.gcfg.n_max)),
                 slot_view_ms=cuda_ms(lambda: attn.slot_view(graph.attn_meta, vdims)),
                 meshes_per_step=1 + T_OUT)
    views["per_step_ms"] = views["meshes_per_step"] * (views["pixel_view_ms"]
                                                      + views["slot_view_ms"])
    print(json.dumps({"phase": "attn_kernels_vs_plain", "card": card, "k3_by_width": fwd,
                      "k3_wide": wide, "k4_by_width": bwd, "views": views,
                      "k7_by_set": k7_sets}), flush=True)

    # ---- phase 11: train_step on the attention path
    trainer = make_trainer(seed, run_dir.name, conv)
    with GradFnCheck(attn, "attn_apply", "AttnApplyBackward") as gcheck:
        loss, _ = trainer.train_step(x_g, y_g)  # warm-up
    check(float(loss) == float(loss), "attention warm-up loss is NaN")
    check(not gcheck.bad and gcheck.calls == k3,
          f"K3 outputs without the AttnApply node: {gcheck.bad[:3]} "
          f"({gcheck.calls} outputs required grad)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    losses, worst, pending = [], 0, None
    for x_b, y_b in batches[1:]:
        loss, overflow = trainer.train_step(x_b, y_b)
        if pending is not None:  # one step late, as train() drains
            losses.append(float(pending[0]))
            worst = max(worst, int(pending[1]))
        pending = (loss, overflow)
    losses.append(float(pending[0]))
    worst = max(worst, int(pending[1]))
    train_s = time.perf_counter() - t0
    train_launches = counts()
    per_step = {k: v / TRAIN_STEPS for k, v in train_launches.items()}
    check(bool(np.isfinite(losses).all()), f"non-finite attention training loss {losses}")
    check(worst == 0, f"mesh overflow {worst} in attention training")
    k7_step = expected_quadtree_k7(cfg, 2, train=True)
    check(per_step["attn_apply"] == per_step["attn_apply_bwd"] == k3
          and per_step["segment_sum"] == k7_step,
          f"attention launches per step {per_step}, expected K3 = K4 = {k3}, K7 {k7_step}")
    check(all(train_launches[n] == 0 for n in spmm.LAUNCHES), f"Â-block kernels ran: {per_step}")
    print(json.dumps({
        "phase": "attn_train_path", "card": card, "batch": BATCH, "steps": TRAIN_STEPS,
        "seconds": train_s, "steps_per_s": TRAIN_STEPS / train_s,
        "frames_per_s": TRAIN_STEPS * BATCH * T_OUT / train_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": losses, "overflow": worst, "launches_per_step": per_step,
        "k3_outputs_checked": gcheck.calls,
    }), flush=True)

    # ---- phase 12: a kernel step vs a plain step; the kernel step again
    loss_k, _, grads_k, meshes_k = step_with_meshes(make_trainer(seed, run_dir.name, conv),
                                                    x_g, y_g, seed=1)
    with mock.patch.object(attn, "_attn_fwd_cuda", attn.attn_plain), \
            mock.patch.object(attn, "_attn_bwd_cuda", attn.attn_bwd_plain), \
            mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain):
        loss_p, _, grads_p, meshes_p = step_with_meshes(
            make_trainer(seed, run_dir.name, conv), x_g, y_g, seed=1)
    check(torch.equal(meshes_k, meshes_p),
          "kernel and plain attention train steps ran on different meshes")
    leaf_err = max(float((grads_k[n] - grads_p[n]).abs().max())
                   / max(1.0, float(grads_p[n].abs().max())) for n in grads_p)
    check(leaf_err <= GRAD_TOL, f"attention gradients differ from the plain path by {leaf_err}")
    print(json.dumps({
        "phase": "attn_grads_vs_plain", "card": card, "loss_kernel": float(loss_k),
        "loss_plain": float(loss_p), "max_leaf_err_rel": leaf_err, "leaves": len(grads_p),
        "meshes_identical": True,
    }), flush=True)
    loss_k2, _, grads_k2, meshes_k2 = step_with_meshes(make_trainer(seed, run_dir.name, conv),
                                                       x_g, y_g, seed=1)
    same = (torch.equal(loss_k, loss_k2) and torch.equal(meshes_k, meshes_k2)
            and all(torch.equal(grads_k[n], grads_k2[n]) for n in grads_k))
    check(same, "two identical attention train steps differ")
    print(json.dumps({"phase": "attn_determinism", "card": card, "loss": float(loss_k2),
                      "bit_identical": same}), flush=True)
    run_dir.cleanup()
    return launches, train_launches, fwd, wide, bwd, k7_sets


def window_fill(src_rel, dst_rel, live):
    """(edges in the fullest live tile, the widest source spread of a live
    tile): what a mesh asks of EB and SW."""
    import torch

    tile = torch.arange(src_rel.shape[1], device=src_rel.device)[None, :, None]
    ok = (dst_rel >= 0) & (tile < live[:, None, None])
    spread = torch.where(ok, src_rel.long(), -1).amax(dim=-1) + 1
    return int(ok.sum(dim=-1).max()), int(spread.max())


def capacity_phase(seed: int, card: str, spmm, attn) -> dict:
    """Phase 12b: K1-K4 against their plain versions on near-capacity
    windows: every call of one teacher-forced train step
    (``teacher_forcing_ratio=1.0``, so each decoder step remeshes on a true
    frame of the sprite-rendered batch) of the ChebConv model (K1, K2, K2b)
    and of the TransformerConv model (K3, K4), with the windows' largest
    fill against EB and SW and the overflow counter."""
    import torch

    run_dir = tempfile.TemporaryDirectory()
    _, batches = train_batches(seed, 1)
    x_g, y_g = batches[0]
    meshes = 1 + T_OUT

    trainer = make_trainer(seed, run_dir.name, "ChebConv", teacher_forcing_ratio=1.0)
    with Record(spmm, "_build_blocks_cuda") as k1, Record(spmm, "_apply_cuda") as k2, \
            Record(spmm, "_apply_bwd_cuda") as k2b:
        _, overflow_c = trainer.train_step(x_g, y_g)
    check(len(k1.calls) == meshes, f"K1 built {len(k1.calls)} meshes, expected {meshes}")
    fills = [window_fill(a[0], a[1], a[3]) for a in k1.calls]
    for i, a in enumerate(k1.calls):
        check(torch.equal(spmm._build_blocks_cuda(*a), spmm.build_blocks_plain(*a)),
              f"K1 differs from its plain version on near-capacity mesh {i}")
    errs, rowwarp_same = {}, True
    with torch.no_grad():
        for name, rec, launch in (("k2", k2, spmm._apply_cuda),
                                  ("k2b", k2b, spmm._apply_bwd_cuda)):
            errs[name] = 0.0
            for a in rec.calls:
                out = launch(*a)
                errs[name] = max(errs[name], float((out - spmm.apply_plain(*a)).abs().max()))
                rowwarp_same &= torch.equal(out, spmm._apply_rowwarp_cuda(*a))
    k2_err, k2b_err = errs["k2"], errs["k2b"]
    check(k2_err <= K2_TOL and k2b_err <= K2_TOL,
          f"K2 / K2b differ from the plain product on near-capacity windows: {k2_err}, "
          f"{k2b_err}")
    check(rowwarp_same, "K2 / K2b differ from the row-a-warp kernel on near-capacity windows")
    k2_calls, k2b_calls = len(k2.calls), len(k2b.calls)
    del trainer, k1, k2, k2b

    trainer = make_trainer(seed, run_dir.name, "TransformerConv", teacher_forcing_ratio=1.0)
    with Record(attn, "_attn_fwd_cuda") as k3, Record(attn, "_attn_bwd_cuda") as k4, \
            Record(attn, "attn_tile_meta") as windows:
        _, overflow_t = trainer.train_step(x_g, y_g)
    check(len(windows.results) == meshes, f"{len(windows.results)} window builds, expected "
          f"{meshes}")
    # every mesh but the last remesh's (which feeds no step) runs K3
    ran = {a[5].src_rel.data_ptr() for a in k3.calls}
    check(len(ran) == T_OUT, f"K3 ran on {len(ran)} meshes, expected {T_OUT}")
    k3_err, k4_rel = 0.0, 0.0
    for a in k3.calls:
        with torch.no_grad():
            k3_err = max(k3_err, float((attn._attn_fwd_cuda(*a) - attn.attn_plain(*a))
                                       .abs().max()))
    for a in k4.calls:
        for kern, plain in zip(attn._attn_bwd_cuda(*a), attn.attn_bwd_plain(*a)):
            k4_rel = max(k4_rel, float((kern - plain).abs().max())
                         / max(1.0, float(plain.abs().max())))
    check(k3_err <= K3_TOL and k4_rel <= K4_TOL,
          f"K3 / K4 differ from their plain versions on near-capacity windows: {k3_err}, "
          f"{k4_rel}")
    fills += [window_fill(m.src_rel, m.dst_rel, m.live) for m, _ in windows.results]
    overflow = max(int(overflow_c), int(overflow_t))
    check(overflow == 0, f"mesh overflow {overflow} on the teacher-forced meshes")
    eb, sw = trainer.gcfg.agg_eb, trainer.gcfg.agg_sw
    result = dict(phase="window_gate", card=card, teacher_forcing_ratio=1.0, meshes=meshes,
                  overflow=overflow, eb=eb, sw=sw,
                  max_edges_per_tile=max(f[0] for f in fills),
                  max_source_spread=max(f[1] for f in fills),
                  decoder_edges_per_tile=[f[0] for f in fills[1:meshes]],
                  decoder_source_spread=[f[1] for f in fills[1:meshes]],
                  k1_builds=meshes, k1_exact=True, k2_calls=k2_calls, k2_max_abs_err=k2_err,
                  k2b_calls=k2b_calls, k2b_max_abs_err=k2b_err,
                  k2_k2b_rowwarp_bit_identical=rowwarp_same,
                  k3_calls=len(k3.calls), k3_max_abs_err=k3_err,
                  k4_calls=len(k4.calls), k4_max_err_rel=k4_rel)
    print(json.dumps(result), flush=True)
    run_dir.cleanup()
    return result


def _library_spmm(s0, blocks, n_max, nt, sw, z):
    """``torch.sparse.mm`` of the block-diagonal CSR Â by z, as a callable,
    or the message with which torch refuses the operands' type."""
    import torch

    csr = block_diag_csr(s0, blocks, n_max, nt, sw)
    zf = z.reshape(-1, z.shape[-1])
    try:
        torch.sparse.mm(csr, zf)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return None, str(exc).splitlines()[0][:200]
    return (lambda: torch.sparse.mm(csr, zf)), None


def library_times(fn) -> dict:
    """A PyTorch call's time (the library yardstick), by CUDA graph as the
    kernels are timed where torch lets the call be captured, and by
    events; where capture is refused, ``library_ms`` is the events' time
    and ``library_timing`` says why."""
    import torch

    events = cuda_ms(fn)
    try:
        return dict(library_ms=graph_ms(fn), library_events_ms=events, library_timing="graph")
    except RuntimeError as exc:
        torch.cuda.synchronize()
        return dict(library_ms=events, library_events_ms=events,
                    library_timing="events; capture refused: " + str(exc).splitlines()[0][:160])


def rowwarp_times(spmm, args, out, what: str) -> dict:
    """The row-a-warp K2 that the staged kernel replaced
    (``spmm._apply_rowwarp_cuda``, its yardstick) on the same operands:
    checks that ``out`` equals its output bit for bit, and times it by
    graph and events."""
    import torch

    with torch.no_grad():
        same = torch.equal(out, spmm._apply_rowwarp_cuda(*args))
    check(same, f"{what} differs from the row-a-warp kernel's output")
    return dict(rowwarp_ms=graph_ms(lambda: spmm._apply_rowwarp_cuda(*args)),
                rowwarp_events_ms=cuda_ms(lambda: spmm._apply_rowwarp_cuda(*args)),
                rowwarp_bit_identical=same)


def _spmm_width(spmm, args, calls, fn, n_max, nt, sw):
    """K2 (or K2b, ``fn``) against ``apply_plain`` on one width's operands:
    in bf16 within one bf16 rounding, in f32 within ``K2_TOL``, and bit
    for bit the row-a-warp kernel; timed by graph and events beside its
    bound, its plain version, ``torch.sparse.mm`` (:func:`library_times`),
    the row-a-warp kernel (:func:`rowwarp_times`) and in bf16 the f32
    kernel's time on the same operands in f32 (``f32_ms``, by graph)."""
    import torch

    z, s0, blocks, live = args[:4]
    kern, plain = fn(*args), spmm.apply_plain(*args)
    check(kern.dtype == plain.dtype == z.dtype, f"K2 returned {kern.dtype} for {z.dtype} z")
    err = float((kern.float() - plain.float()).abs().max())
    scale = max(1.0, float(plain.float().abs().max()))
    f = z.shape[-1]
    bf16 = z.dtype == torch.bfloat16
    check(err <= (BF16_TOL * scale if bf16 else K2_TOL),
          f"{z.dtype} K2 differs from its plain version at F={f}: {err}")
    library, refused = _library_spmm(s0, blocks, n_max, nt, sw, z)
    bound, b_ms, o_ms = k2_bound_ms(s0, blocks, live, n_max, nt, sw, f, z.shape[0])
    f32_args = (z.float(), s0, blocks.float()) + tuple(args[3:])
    return dict(F=f, calls=calls, max_abs_err=err, err_rel_to_max=err / scale,
                bit_identical=bool((kern == plain).all()), live_tiles=int(live.long().sum()),
                ms=graph_ms(lambda: fn(*args)), events_ms=cuda_ms(lambda: fn(*args)),
                **rowwarp_times(spmm, args, kern, f"{z.dtype} K2 at F={f}"),
                f32_ms=graph_ms(lambda: fn(*f32_args)) if bf16 else None,
                plain_ms=cuda_ms(lambda: spmm.apply_plain(*args)),
                **(library_times(library) if library is not None else
                   dict(library_ms=None, library_events_ms=None, library_timing=None)),
                library_refused=refused, bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms)


def peak_above_start_gib(fn) -> float:
    """Peak device memory that ``fn`` allocates above what is allocated
    when it starts (GiB): what it needs, whatever earlier phases keep."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - start) / 2**30


def bf16_phases(seed: int, card: str, spmm, segment, segment_sum, loader, x):
    """Phases 26-30: the main path in bf16 (``compute_dtype="bfloat16"``,
    ``bench.py``'s default dtype); returns the kernels line's bf16 entries
    (K1, K2, K2b, K7) and the f32 K7's measurements on the same sums and the
    node counts."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader

    run_dir = tempfile.TemporaryDirectory()
    bf16 = torch.bfloat16

    def reset():
        spmm.reset_launch_counts()
        segment_sum.reset_launch_counts()

    def counts():
        """({bf16 kernel: launches}, {f32 kernel: launches}) since reset()."""
        return ({**spmm.LAUNCHES_BF16, **segment_sum.LAUNCHES_BF16},
                {**spmm.LAUNCHES, **segment_sum.LAUNCHES})

    # ---- phase 26: predict() in bf16
    model = make_model(seed, run_dir.name, dtype="bfloat16")
    cfg, gcfg = model.cfg, model.gcfg
    nt, sw, n_max = gcfg.agg_nt, gcfg.agg_sw, gcfg.n_max
    model.predict(loader)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    y = model.predict(loader)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches, f32_launches = counts()
    # as f32's (phase 2): K1 a mesh, K2 twice a conv layer, K7 as
    # expected_quadtree_k7 reads it; only the node counts (a sum of ones)
    # stay f32
    meshes = 1 + T_OUT
    want = {"spmm_build_blocks": meshes,
            "spmm_apply": expected_launches(cfg)["spmm_apply"], "spmm_apply_bwd": 0,
            "segment_sum": expected_quadtree_k7(cfg, 3) - meshes}
    want_f32 = {k: (meshes if k == "segment_sum" else 0) for k in want}
    check(y.shape == (BATCH, T_OUT, *CANVAS, 1) and y.dtype == np.float32,
          f"bf16 predict gave {y.shape} {y.dtype}")
    check(bool(np.isfinite(y).all()), "non-finite bf16 forecast")
    check(model.last_overflow == 0, f"mesh overflow {model.last_overflow} in bf16")
    check(launches == want and f32_launches == want_f32,
          f"bf16 main path launches {launches} (f32 {f32_launches}), expected {want} "
          f"({want_f32})")
    print(json.dumps({
        "phase": "bf16_path", "card": card, "batch": BATCH, "batch_s": batch_s,
        "frames_per_s": BATCH * T_OUT / batch_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "overflow": model.last_overflow, "launches_bf16": launches,
        "launches_f32": f32_launches,
    }), flush=True)

    # ---- phase 27: K1, K2, K2b and K7 in bf16 against their plain versions
    enc_calls = T_IN * cfg.n_layers * cfg.n_conv_layers * 2
    dec_step_calls = cfg.n_layers * 2 + 2 * 2
    p = CANVAS[0] * CANVAS[1]
    with Capture(spmm, enc_calls, dec_step_calls) as cap, \
            SegmentCapture(segment, p, keep=True, dtype=torch.float32, counts=True) as seg_c, \
            SegmentCapture(segment, p, keep=True, dtype=bf16) as seg_f:
        model.forecast(x)
    check(cap.calls == want["spmm_apply"], "bf16 capture run disagrees with the bf16 path")
    n_builds = len(cap.builds)
    for i, bargs in enumerate(cap.builds):
        kern, plain = spmm._build_blocks_cuda(*bargs), spmm.build_blocks_plain(*bargs)
        check(kern.dtype == bf16 and torch.equal(kern, plain),
              f"bf16 K1 differs from its plain version (build {i})")
    bargs = cap.builds[0]
    k1 = dict(ms=graph_ms(lambda: spmm._build_blocks_cuda(*bargs)),
              events_ms=cuda_ms(lambda: spmm._build_blocks_cuda(*bargs)),
              f32_ms=graph_ms(lambda: spmm._build_blocks_cuda(*bargs[:6])),
              plain_ms=cuda_ms(lambda: spmm.build_blocks_plain(*bargs)))
    k1["bound_ms"], k1_b, k1_o = k1_bound_ms(bargs[0], bargs[1], bargs[3], nt, sw, 2)
    k1["bound_by"] = "bytes" if k1_b >= k1_o else "operations"
    widths = [_spmm_width(spmm, a, cap.per_width[f], spmm._apply_cuda, n_max, nt, sw)
              for f, a in cap.operands().items()]
    trainer = make_trainer(seed, run_dir.name, dtype="bfloat16")
    _, batches = train_batches(seed, TRAIN_STEPS + 1)
    with CaptureBwd(spmm, "_apply_bwd_cuda") as cap_b, \
            SegmentCapture(segment, p, keep=True, dtype=bf16) as seg_t:
        trainer.train_step(*batches[0])
    bwd = [_spmm_width(spmm, a, cap_b.per_width[f], spmm._apply_bwd_cuda, n_max, nt, sw)
           for f, a in sorted(cap_b.first.items())]
    check(sum(w["calls"] for w in bwd) == expected_launches(cfg)["spmm_apply_bwd"],
          "bf16 K2b capture disagrees with the code")
    sets = {**seg_t.ops, **seg_f.ops}  # the forecast's operands where it has the set
    k7_sets = [k7_measure(segment_sum, key, sets[key], seg_t.calls.get(key, 0), BF16_TOL)
               for key in sorted(sets)]
    # the f32 kernel on the same sums (f32_ms), measured in full beside the
    # f32 node counts (pixel ids, F 1), which the bf16 path keeps in f32
    k7_f32_sets = []
    for w, key in zip(k7_sets, sorted(sets)):
        values, ids, n_out, view = sets[key]
        w32 = k7_measure(segment_sum, key, (values.float(), ids, n_out, view), w["calls"])
        w["f32_ms"] = w32["ms"]
        k7_f32_sets.append(w32)
    k7_f32_sets += [k7_measure(segment_sum, key, seg_c.ops[key], seg_c.calls[key])
                    for key in sorted(seg_c.ops)]
    check(all(ops[0].dtype == bf16 for ops in sets.values()), "a K7 set is not bf16")
    check(list(seg_c.calls) == [("counts", 1)] and seg_c.calls[("counts", 1)] == meshes,
          f"the bf16 forecast's f32 sums {seg_c.calls}, expected the {meshes} node counts")
    del cap, cap_b, seg_f, seg_c, sets
    print(json.dumps({"phase": "bf16_kernels_vs_plain", "card": card, "k1": k1,
                      "k1_builds_exact": n_builds, "k2_by_width": widths, "k2b_by_width": bwd,
                      "k7_by_set": k7_sets, "k7_f32_by_set": k7_f32_sets}), flush=True)

    # ---- phase 28: train_step in bf16
    with GradFnCheck(spmm, "spmm_apply", "SpmmApplyBackward") as gcheck:
        loss, overflow = trainer.train_step(*batches[0])  # warm-up
    want_step = expected_launches(cfg)
    check(not gcheck.bad and gcheck.calls == want_step["spmm_apply_bwd"],
          f"bf16 Â·z outputs without the K2b node: {gcheck.bad[:3]} ({gcheck.calls})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    losses, worst, pending = [], 0, None
    for x_b, y_b in batches[1:]:
        loss, overflow = trainer.train_step(x_b, y_b)
        if pending is not None:  # one step late, as train() drains
            losses.append(float(pending[0]))
            worst = max(worst, int(pending[1]))
        pending = (loss, overflow)
    losses.append(float(pending[0]))
    worst = max(worst, int(pending[1]))
    train_s = time.perf_counter() - t0
    train_launches, train_f32 = counts()
    per_step = {k: v / TRAIN_STEPS for k, v in train_launches.items()}
    want_bf16 = {**want_step, "segment_sum": want_step["segment_sum"] - meshes}
    check(loss.dtype == torch.float32 and bool(np.isfinite(losses).all()),
          f"bf16 training loss {losses} ({loss.dtype})")
    check(worst == 0, f"mesh overflow {worst} in bf16 training")
    check(per_step == {k: float(v) for k, v in want_bf16.items()}
          and train_f32 == {k: TRAIN_STEPS * v for k, v in want_f32.items()},
          f"bf16 launches per step {per_step} (f32 {train_f32}), expected {want_bf16}")
    check(all(q.dtype == q.grad.dtype == torch.float32 for q in trainer.model.parameters()),
          "bf16 training left a master weight or gradient that is not float32")
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    # a step's own peak, bf16 and f32 (a fresh trainer after its warm-up)
    # measured alike
    step_peak = {"bfloat16": peak_above_start_gib(lambda: trainer.train_step(*batches[1]))}
    f32_trainer = make_trainer(seed, run_dir.name)
    f32_trainer.train_step(*batches[0])
    step_peak["float32"] = peak_above_start_gib(lambda: f32_trainer.train_step(*batches[1]))
    del f32_trainer
    # the train() entry in bf16: one epoch over 2 batches, then score()
    entry = make_trainer(seed, run_dir.name, dtype="bfloat16")
    loaders = [DataLoader(ArrayDataset(np.concatenate([b[0] for b in bs]),
                                       np.concatenate([b[1] for b in bs]),
                                       np.zeros(BATCH * len(bs))), batch_size=BATCH)
               for bs in (batches[1:3], batches[:1])]
    entry.train(*loaders, n_epochs=1, divergence_threshold=float("inf"))
    score = entry.score(loaders[1])
    check(bool(np.isfinite(entry.loss["train_loss"] + entry.loss["test_loss"]).all())
          and np.isfinite(score["MSE"]), f"bf16 train()/score() gave {entry.loss}, {score}")
    del entry
    print(json.dumps({
        "phase": "bf16_train_path", "card": card, "batch": BATCH, "steps": TRAIN_STEPS,
        "seconds": train_s, "steps_per_s": TRAIN_STEPS / train_s,
        "frames_per_s": TRAIN_STEPS * BATCH * T_OUT / train_s,
        "peak_mem_gib": peak_mem, "step_peak_above_start_gib": step_peak,
        "losses": losses, "overflow": worst, "launches_per_step": per_step,
        "f32_launches_per_step": {k: v / TRAIN_STEPS for k, v in train_f32.items()},
        "k2_outputs_checked": gcheck.calls, "train_entry_score": score,
    }), flush=True)
    del trainer

    # ---- phase 29: a bf16 step on the kernels vs one on the plain
    # versions, teacher-forced (every decoder mesh from a true frame, so the
    # two runs share their meshes); every K1, K2, K2b call of the kernel
    # step on those near-capacity windows; the kernel step again
    x_g, y_g = batches[0]
    forced = lambda: make_trainer(seed, run_dir.name, teacher_forcing_ratio=1.0,  # noqa: E731
                                  dtype="bfloat16")
    with Record(spmm, "_build_blocks_cuda") as r1, Record(spmm, "_apply_cuda") as r2, \
            Record(spmm, "_apply_bwd_cuda") as r2b:
        loss_k, ovf_k, grads_k, meshes_k = step_with_meshes(forced(), x_g, y_g, seed=1)
    for a, out in zip(r1.calls, r1.results):
        check(torch.equal(out, spmm.build_blocks_plain(*a)),
              "bf16 K1 differs from its plain version on a teacher-forced mesh")
    near = 0.0
    with torch.no_grad():
        for rec in (r2, r2b):
            for a, out in zip(rec.calls, rec.results):
                plain = spmm.apply_plain(*a).float()
                near = max(near, float((out.float() - plain).abs().max())
                           / max(1.0, float(plain.abs().max())))
    check(near <= BF16_TOL, f"bf16 K2 / K2b differ on the teacher-forced windows: {near}")
    fills = [window_fill(a[0], a[1], a[3]) for a in r1.calls]
    n_calls = (len(r1.calls), len(r2.calls), len(r2b.calls))
    del r1, r2, r2b
    with mock.patch.object(spmm, "_build_blocks_cuda", spmm.build_blocks_plain), \
            mock.patch.object(spmm, "_apply_cuda", spmm.apply_plain), \
            mock.patch.object(spmm, "_apply_bwd_cuda", spmm.apply_plain), \
            mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain):
        loss_p, _, grads_p, meshes_p = step_with_meshes(forced(), x_g, y_g, seed=1)
    check(torch.equal(meshes_k, meshes_p), "bf16 kernel and plain steps ran on different meshes")
    leaf_err = max(float((grads_k[n] - grads_p[n]).abs().max())
                   / max(1.0, float(grads_p[n].abs().max())) for n in grads_p)
    check(int(ovf_k) == 0 and leaf_err <= BF16_GRAD_TOL,
          f"bf16 gradients differ from the plain path by {leaf_err} (overflow {int(ovf_k)})")
    loss_k2, _, grads_k2, meshes_k2 = step_with_meshes(forced(), x_g, y_g, seed=1)
    same = (torch.equal(loss_k, loss_k2) and torch.equal(meshes_k, meshes_k2)
            and all(torch.equal(grads_k[n], grads_k2[n]) for n in grads_k))
    check(same, "two identical bf16 train steps differ")
    print(json.dumps({
        "phase": "bf16_grads_vs_plain", "card": card, "teacher_forcing_ratio": 1.0,
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
        "max_leaf_err_rel": leaf_err, "leaves": len(grads_p), "meshes_identical": True,
        "k1_k2_k2b_calls": n_calls, "k2_k2b_max_err_rel": near,
        "max_edges_per_tile": max(f[0] for f in fills),
        "max_source_spread": max(f[1] for f in fills), "bit_identical_repeat": same,
    }), flush=True)

    # ---- phase 30: the bf16 forecast against the f32 one, same weights
    f32_model = make_model(seed, run_dir.name)
    f32_model.forecast(x)  # warm-up
    got = {}
    peaks = {dtype: peak_above_start_gib(lambda m=m, d=dtype: got.setdefault(d, m.forecast(x)))
             for dtype, m in (("bfloat16", model), ("float32", f32_model))}
    (y16, _, m16), (y32, _, m32) = got["bfloat16"], got["float32"]
    same0 = (m16[0] == m32[0]).all(dim=-1)  # the encoder's meshes, per sample
    check(bool(same0.any()), "no sample's encoder mesh agrees between bf16 and f32")
    err0 = (y16[:, 0] - y32[:, 0]).abs()[same0]
    check(float(err0.mean()) <= BF16_FRAME_TOL,
          f"the first bf16 frame differs from f32 by {float(err0.mean())} on average")
    err = (y16 - y32).abs()
    print(json.dumps({
        "phase": "bf16_vs_f32", "card": card, "samples_on_the_same_mesh": int(same0.sum()),
        "forecast_peak_above_start_gib": peaks,
        "first_frame_mean_abs": float(err0.mean()), "first_frame_max_abs": float(err0.max()),
        "mean_abs_by_step": err.mean(dim=(0, 2, 3, 4)).tolist(),
        "max_abs_by_step": err.amax(dim=(0, 2, 3, 4)).tolist(),
    }), flush=True)
    run_dir.cleanup()

    # the kernels line's bf16 entries: launches from phase 28's steps, K2
    # and K2b launch-weighted over their widths, K7 over its operand sets
    # weighted by a train step's calls
    def mean(ws, key):
        n = sum(w["calls"] for w in ws)
        vals = [w[key] for w in ws]
        if any(v is None for v in vals):
            return None
        return sum(w["calls"] * v for w, v in zip(ws, vals)) / n

    def entry(name, source, replaces, ws, **extra):
        return dict(name=f"{name}_bf16", dtype="bfloat16", route="cuda",
                    source=f"quadtree_mpnnlstm_tpu_torch/csrc/{source}", replaces=replaces,
                    launches=train_launches[name],
                    max_abs_err=max(w["max_abs_err"] for w in ws),
                    ms=mean(ws, "ms"), events_ms=mean(ws, "events_ms" if "events_ms" in ws[0]
                                                      else "ms_events"),
                    f32_ms=mean(ws, "f32_ms"),
                    plain_ms=mean(ws, "plain_ms"), bound_ms=mean(ws, "bound_ms"),
                    bound_by="bytes" if mean(ws, "bytes_ms") >= mean(ws, "ops_ms")
                    else "operations", library_ms=mean(ws, "library_ms"),
                    launches_by_path={"predict_batch": launches[name],
                                      f"train_{TRAIN_STEPS}_steps": train_launches[name]},
                    **extra)

    pallas = "quadtree_mpnnlstm_tpu/ops/pallas_spmm.py"
    k1_entry = entry("spmm_build_blocks", "spmm.cu", f"{pallas}:249",
                     [dict(k1, calls=1, max_abs_err=0.0, bytes_ms=k1_b, ops_ms=k1_o,
                           library_ms=None)])
    k7_ws = [w for w in k7_sets if w["calls"]]
    return [k1_entry,
            entry("spmm_apply", "spmm.cu", f"{pallas}:322", widths,
                  rowwarp_ms=mean(widths, "rowwarp_ms"),
                  library_refused=sorted({w["library_refused"] for w in widths
                                          if w["library_refused"]})),
            entry("spmm_apply_bwd", "spmm.cu", f"{pallas}:363-365", bwd,
                  rowwarp_ms=mean(bwd, "rowwarp_ms"),
                  library_refused=sorted({w["library_refused"] for w in bwd
                                          if w["library_refused"]})),
            entry("segment_sum", "segment.cu", "quadtree_mpnnlstm_tpu/ops/pallas_segment.py:87",
                  k7_ws, by_operand_set=[dict(w, path="main") for w in k7_sets],
                  ms_by_path={"main": k7_path_means(k7_sets)})], k7_f32_sets


def grid_phases(seed: int, card: str, spmm, attn, grid_attn, segment_sum):
    """Phases 13-18 on the sea-ice flagship (the pixelwise grid); returns
    the forecast's and the timed train steps' launches and K5's and K6's
    per-width measurements."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader

    run_dir = tempfile.TemporaryDirectory()
    modules = (spmm, attn, grid_attn, segment_sum)

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def counts():
        return {k: v for m in modules for k, v in m.LAUNCHES.items()}

    # ---- phase 13: the flagship forecast through predict()
    t0 = time.perf_counter()
    data, clim, mask = ice_data(seed)
    data_s = time.perf_counter() - t0
    windows = lambda i, j: ArrayDataset(data.x[i:j], data.y[i:j],  # noqa: E731
                                        data.launch_dates[i:j])
    model = make_ice_model(seed, run_dir.name)
    cfg = model.cfg
    k5 = expected_grid_launches(cfg)
    check(model.gcfg.aggregation == "grid" and not model.gcfg.attn_windows,
          f"the predictor did not configure the grid: {model.gcfg}")
    model.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    y = model.predict(DataLoader(windows(0, ICE_FORECASTS)), climatology=clim, mask=mask)
    torch.cuda.synchronize()
    forecast_s = (time.perf_counter() - t0) / ICE_FORECASTS
    launches = counts()
    check(y.shape == (ICE_FORECASTS, ICE_T_OUT, *ICE_SHAPE, 1), f"grid predict shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite grid forecast")
    check(model.last_overflow == 0, f"grid mesh overflow {model.last_overflow}")
    check(launches["grid_attn_apply"] == k5 * ICE_FORECASTS
          and launches["grid_attn_apply_bwd"] == 0,
          f"grid forecast launches {launches}, expected K5 {k5} a forecast")
    others = {k: v for k, v in launches.items() if not k.startswith("grid_attn")}
    check(not any(others.values()), f"K1-K4 or K7 ran on the grid path: {others}")
    print(json.dumps({
        "phase": "grid_path", "card": card, "batch": 1, "forecasts": ICE_FORECASTS,
        "grid": ICE_SHAPE, "t_in": ICE_T_IN, "t_out": ICE_T_OUT, "windows": len(data),
        "valid_pixels": int((~mask).sum()), "data_s": data_s, "s_per_forecast": forecast_s,
        "frames_per_s": ICE_T_OUT / forecast_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "overflow": model.last_overflow, "k5_per_forecast": k5, "launches": launches,
    }), flush=True)

    # ---- phase 14: K5 and K6 against their plain versions
    enc_calls = ICE_T_IN * cfg.n_layers * cfg.n_conv_layers
    x0, y0, ld0 = data.x[:1], data.y[:1], data.launch_dates[:1]
    clim0 = model._clim_batch(clim, ld0)
    with AttnCapture(grid_attn, "_grid_attn_fwd_cuda", enc_calls, cfg.n_layers + 2) as cap:
        model.forecast(x0, mask=mask, climatology=clim0)
    check(cap.calls == k5, "grid capture run disagrees with the path")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    fwd = []
    for hd, args in cap.operands().items():
        q, dims = args[0], args[6]
        keep = (torch.rand((q.shape[0], dims.ndirs, q.shape[1], dims.heads), generator=gen,
                           device=DEVICE) < 0.9).float() / 0.9
        for kargs in (args, args[:5] + (keep, dims)):
            with torch.no_grad():
                kern = grid_attn._grid_attn_fwd_cuda(*kargs)
                plain = grid_attn.grid_attn_plain(*kargs)
            err = float((kern - plain).abs().max())
            # d divides 32 at every flagship width: K5 sums in the plain order
            check(torch.equal(kern, plain),
                  f"K5 is not bit-identical to grid_attn_plain at H={hd}: {err}")
            bound, b_ms, o_ms = grid_bound_ms(kargs, backward=False)
            fwd.append(dict(H=hd, heads=dims.heads, calls=cap.per_width[hd],
                            keep=kargs[5] is not None, max_abs_err=err, bit_identical=True,
                            plan=grid_attn.fwd_plan(dims, 4, q.shape[0])._asdict(),
                            ms=graph_ms(lambda: grid_attn._grid_attn_fwd_cuda(*kargs)),
                            events_ms=cuda_ms(lambda: grid_attn._grid_attn_fwd_cuda(*kargs)),
                            plain_ms=cuda_ms(lambda: grid_attn.grid_attn_plain(*kargs)),
                            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
    check(sorted({w["H"] for w in fwd}) == [1, 32, 256], f"K5 widths {[w['H'] for w in fwd]}")
    short = make_ice_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT)
    short.initiate_training(lr=LR, lr_decay=0.95)
    y_s, clim_s = y0[:, :ICE_SHORT_T_OUT], clim0[:, :ICE_SHORT_T_OUT]
    with CaptureBwd(grid_attn, "_grid_attn_bwd_cuda") as cap_b:
        short.train_step(x0, y_s, mask=mask, climatology=clim_s)
    check(sum(cap_b.per_width.values()) == expected_grid_launches(short.cfg),
          f"K6 calls {cap_b.per_width}")
    bwd = []
    for hd, args in sorted(cap_b.first.items()):
        check(args[5] is not None, "a training step's K6 operands carry no keep planes")
        for kargs in (args, args[:5] + (None,) + args[6:]):
            errs, rel = {}, {}
            for name, a, p in zip(("dq", "dk", "dv", "de_dir"),
                                  grid_attn._grid_attn_bwd_cuda(*kargs),
                                  grid_attn.grid_attn_bwd_plain(*kargs)):
                errs[name] = float((a - p).abs().max())
                rel[name] = errs[name] / max(1.0, float(p.abs().max()))
            check(max(rel.values()) <= K6_TOL,
                  f"K6 differs from the plain backward at H={hd}: {rel}")
            bound, b_ms, o_ms = grid_bound_ms(kargs, backward=True)
            # a flagship train step launches K6 once per K5 of its forward,
            # so it weighs the widths as the forecast does
            # the whole backward (the kernel and the de_dir sum), by graph
            # (the card's own time) and by events
            bwd.append(dict(H=hd, calls=cap.per_width[hd], keep=kargs[5] is not None,
                            abs_err=errs, err_rel_to_max=rel, max_abs_err=max(errs.values()),
                            plan=grid_attn.bwd_plan(kargs[6], 4, 1)._asdict(),
                            ms=graph_ms(lambda: grid_attn._grid_attn_bwd_cuda(*kargs)),
                            events_ms=cuda_ms(lambda: grid_attn._grid_attn_bwd_cuda(*kargs)),
                            plain_ms=cuda_ms(lambda: grid_attn.grid_attn_bwd_plain(*kargs)),
                            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
    del cap, cap_b, args, kargs
    print(json.dumps({"phase": "grid_kernels_vs_plain", "card": card, "k5_by_width": fwd,
                      "k6_by_width": bwd, "library": None}), flush=True)

    # ---- phase 15: the 90-step forecast on the plain versions
    y_k, _, _ = model.forecast(x0, mask=mask, climatology=clim0)
    with mock.patch.object(grid_attn, "_grid_attn_fwd_cuda", grid_attn.grid_attn_plain):
        y_p, _, _ = model.forecast(x0, mask=mask, climatology=clim0)
    step_err = (y_k - y_p).abs().amax(dim=(0, 2, 3, 4))  # (T_out,)
    check(float(step_err.max()) <= ROLLOUT_TOL,
          f"grid rollout differs from the plain one by {float(step_err.max())}")
    # K5 keeps every sum in the plain version's order (ops/grid_attn.py)
    check(torch.equal(y_k, y_p), "the grid rollout on K5 is not bit-identical to the plain one")
    print(json.dumps({"phase": "grid_rollout_vs_plain", "card": card, "steps": ICE_T_OUT,
                      "max_abs_err": float(step_err.max()),
                      "max_abs_err_last_step": float(step_err[-1]), "bit_identical": True,
                      "max_abs_value": float(y_p.abs().max())}), flush=True)
    del model, y_k, y_p

    # ---- phase 16: train_step on the flagship
    trainer = make_ice_model(seed, run_dir.name)
    trainer.initiate_training(lr=LR, lr_decay=0.95)
    batches = [(data.x[i:i + 1], data.y[i:i + 1],
                trainer._clim_batch(clim, data.launch_dates[i:i + 1]))
               for i in range(ICE_TRAIN_STEPS + 1)]

    def step(batch):
        x_b, y_b, c_b = batch
        return trainer.train_step(x_b, y_b, mask=mask, climatology=c_b,
                                  truncated_backprop=ICE_TBPTT)

    with GradFnCheck(grid_attn, "grid_attn_apply", "GridAttnApplyBackward") as gcheck:
        loss, _ = step(batches[0])  # warm-up
    check(float(loss) == float(loss), "grid warm-up loss is NaN")
    check(not gcheck.bad and gcheck.calls == k5,
          f"K5 outputs without the GridAttnApply node: {gcheck.bad[:3]} "
          f"({gcheck.calls} outputs required grad)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    losses, worst, pending = [], 0, None
    for batch in batches[1:]:
        loss, overflow = step(batch)
        if pending is not None:  # one step late, as train() drains
            losses.append(float(pending[0]))
            worst = max(worst, int(pending[1]))
        pending = (loss, overflow)
    losses.append(float(pending[0]))
    worst = max(worst, int(pending[1]))
    train_s = time.perf_counter() - t0
    train_launches = counts()
    per_step = {k: v / ICE_TRAIN_STEPS for k, v in train_launches.items()}
    check(bool(np.isfinite(losses).all()), f"non-finite grid training loss {losses}")
    check(worst == 0, f"mesh overflow {worst} in grid training")
    check(per_step["grid_attn_apply"] == per_step["grid_attn_apply_bwd"] == k5,
          f"grid launches per step {per_step}, expected K5 = K6 = {k5}")
    check(not any(v for k, v in per_step.items() if not k.startswith("grid_attn")),
          f"K1-K4 or K7 ran on the grid train path: {per_step}")
    print(json.dumps({
        "phase": "grid_train_path", "card": card, "batch": 1, "steps": ICE_TRAIN_STEPS,
        "truncated_backprop": ICE_TBPTT, "seconds": train_s,
        "steps_per_s": ICE_TRAIN_STEPS / train_s,
        "frames_per_s": ICE_TRAIN_STEPS * ICE_T_OUT / train_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": losses, "overflow": worst, "launches_per_step": per_step,
        "k5_outputs_checked": gcheck.calls,
    }), flush=True)
    del trainer, batches
    torch.cuda.empty_cache()

    # ---- phases 17-18: a kernel step vs a plain step (T_out 6); the
    # kernel step again
    def short_step():
        tr = make_ice_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT)
        tr.initiate_training(lr=LR, lr_decay=0.95)
        gen_s = torch.Generator(device=DEVICE).manual_seed(1)
        loss_s, _ = tr.train_step(x0, y_s, mask=mask, climatology=clim_s, generator=gen_s)
        return loss_s, {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()}

    loss_k, grads_k = short_step()
    with mock.patch.object(grid_attn, "_grid_attn_fwd_cuda", grid_attn.grid_attn_plain), \
            mock.patch.object(grid_attn, "_grid_attn_bwd_cuda", grid_attn.grid_attn_bwd_plain):
        loss_p, grads_p = short_step()
    leaf_err = max(float((grads_k[n] - grads_p[n]).abs().max())
                   / max(1.0, float(grads_p[n].abs().max())) for n in grads_p)
    check(leaf_err <= GRAD_TOL, f"grid gradients differ from the plain path by {leaf_err}")
    print(json.dumps({
        "phase": "grid_grads_vs_plain", "card": card, "t_out": ICE_SHORT_T_OUT,
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
        "max_leaf_err_rel": leaf_err, "leaves": len(grads_p),
    }), flush=True)
    del grads_p
    torch.cuda.empty_cache()
    loss_k2, grads_k2 = short_step()
    same = torch.equal(loss_k, loss_k2) and all(torch.equal(grads_k[n], grads_k2[n])
                                                 for n in grads_k)
    check(same, "two identical grid train steps differ")
    print(json.dumps({"phase": "grid_determinism", "card": card, "t_out": ICE_SHORT_T_OUT,
                      "loss": float(loss_k2), "bit_identical": same}), flush=True)
    run_dir.cleanup()
    return launches, train_launches, fwd, bwd


# ---------------------------------------------------------------- edge list
# The JAX package's ice-xla workload (bench.py --workload ice-xla,
# make_ice_predictor(mesh="pixelwise-xla")): the flagship above on the
# pixelwise edge list (aggregation="xla": n_max 68,096 raster-ordered
# nodes, e_max 272,384 edge slots), every segment sum on K7, training by
# the trainer's truncated BPTT.
EDGE_TBPTT = 30  # decoder chunk of a train step (the reference's experiment 6)
K7_TOL = 1e-6    # × max(1, max|out|)


def _attention_calls(cfg, t_out: int) -> int:
    """Attention calls of one encode and ``t_out`` decoder steps: one per
    conv layer of every encoder step, one per decoder step's cell and one
    per head conv."""
    return ICE_T_IN * cfg.n_layers * cfg.n_conv_layers + t_out * (cfg.n_layers + 2)


def expected_edge_launches(cfg, t_out: int, chunk: int = 0, train: bool = False) -> int:
    """K7 launches of one edge-list forecast (``train``: one train step with
    decoder chunks of ``chunk`` steps, 0 for full BPTT), read from the
    code. Every encode (one per chunk in training) builds the mesh: node
    counts, the pixel→node pooling of the inputs and the degrees of the
    symmetric norm, one each; the decoder pools its chunk's climatology
    once; every attention call aggregates its messages once. A train
    step's backward adds the gathers of k and v at the sources and of q at
    the destinations of every attention call and ``unflatten``'s gather of
    every decoder step; the edge softmax's sums stay plain."""
    if not train:
        return 4 + _attention_calls(cfg, t_out)
    chunk = chunk if 0 < chunk < t_out else t_out
    steps = [min(chunk, t_out - t0) for t0 in range(0, t_out, chunk)]
    return sum(4 + 4 * _attention_calls(cfg, n) + n for n in steps)


class SegmentCapture:
    """Wraps K7's dispatch (``ops/segment.py`` ``segment_sum``, which
    ``segment_sum_nodes`` and the gathers' backwards call) and counts
    its calls by operand set (ids, F): ids ``dst`` (the sorted edge_dst),
    ``src`` (edge_src) or ``pixel`` (pixel_node). With ``keep`` it also
    keeps the last call's operands of each set, detached; with ``dtype``
    it sees only the calls on values of that type. Every call must carry
    its graph's CSR view, but with ``counts`` the quadtree build's node
    counts (f32 ones over the pixels, summed before their graph and its
    view exist), keyed ``("counts", 1)``. With ``loops`` (a mesh's e_max)
    the GAT self-loop lists (e_max + n_max entries) are ``loops_dst`` (its
    edge part sorted) and ``loops_src``."""

    def __init__(self, segment, n_pixels: int, keep: bool = False, dtype=None,
                 counts: bool = False, loops: int = 0):
        self.segment, self.n_pixels, self.keep, self.dtype = segment, n_pixels, keep, dtype
        self.counts, self.loops = counts, loops
        self.calls, self.ops = {}, {}
        self._fn = segment.segment_sum

    def __call__(self, values, ids, n_out, view=None, grad_ids=None):
        import torch

        if self.dtype is not None and values.dtype != self.dtype:
            return self._fn(values, ids, n_out, view, grad_ids)
        if view is None:
            check(self.counts and ids.shape[1] == self.n_pixels and values.ndim == 2
                  and values.dtype == torch.float32,
                  "a segment sum on the card ran without its graph's CSR view")
            key = ("counts", 1)
        elif self.loops and ids.shape[1] > self.loops and ids.shape[1] != self.n_pixels:
            edges = ids[:, :self.loops]
            site = "loops_dst" if bool((edges[:, 1:] >= edges[:, :-1]).all()) else "loops_src"
            key = (site, values[0, 0].numel())
        else:
            site = ("pixel" if ids.shape[1] == self.n_pixels
                    else "dst" if view.order is None else "src")
            key = (site, values[0, 0].numel())
        self.calls[key] = self.calls.get(key, 0) + 1
        if self.keep:
            from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import segment_view

            kept = view if view is not None else segment_view(ids, n_out)
            self.ops[key] = (values.detach(), ids, n_out, kept)
        return self._fn(values, ids, n_out, view, grad_ids)

    def __enter__(self):
        self._patch = mock.patch.object(self.segment, "segment_sum", self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def k7_bound_ms(ids, n_out: int, f: int, itemsize: int = 4):
    """Least time for K7's work on these operands: each valid entry's F
    values read once, the ids read once (4 B each), every output row
    written once (``itemsize`` B a value: 4 in f32, 2 in bf16); one add
    per valid value."""
    n_valid = int(((ids >= 0) & (ids < n_out)).sum())
    nbytes = n_valid * f * itemsize + ids.numel() * 4 + ids.shape[0] * n_out * f * itemsize
    ops = n_valid * f
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / _peak_flops(itemsize) * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms, n_valid


def entry_ordered_sum(segment_sum, values, ids, n_out: int):
    """The sequential, entry-ordered segment sum: ``segment_sum_plain`` on
    the CPU with torch on one thread (its accumulating ``index_put_`` adds
    serially there; on the card it reduces a bucket of 32 or more entries
    at F 1 by warps), returned on the CPU."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return segment_sum.segment_sum_plain(values.cpu(), ids.cpu(), n_out)
    finally:
        torch.set_num_threads(threads)


def k7_measure(segment_sum, key, ops, calls, tol: float = K7_TOL):
    """K7 on one operand set: bit-identical to the entry-ordered sum on the
    CPU (:func:`entry_ordered_sum`) or the phase fails, and against
    ``segment_sum_plain`` on the card (≤ ``tol`` × max(1, max|out|));
    its plan (``segment_plan``); ``calls``: its launches in one train step
    (0: the forecast's alone). Timed beside its bound, the plain version,
    ``index_add_`` (in the values' type) and the view's build, each by
    :func:`graph_ms` (``ms_events``: K7 by CUDA events between host
    launches, as the other kernels are timed)."""
    import torch

    values, ids, n_out, view = ops
    b, length = ids.shape
    flat = values.reshape(b, length, -1).contiguous()
    f = flat.shape[-1]
    kern = segment_sum._segment_sum_cuda(flat, ids, n_out, view)
    exact = torch.equal(kern.cpu(), entry_ordered_sum(segment_sum, flat, ids, n_out))
    check(exact, f"K7 is not the entry-ordered sum on {key} ({flat.dtype})")
    plain = segment_sum.segment_sum_plain(flat, ids, n_out)
    err = float((kern - plain).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    check(err <= tol * scale, f"K7 differs from segment_sum_plain on {key}: {err}")
    plan = None  # a checkout from before K7's plans (chip_ab.py --tree) has none
    if hasattr(segment_sum, "segment_plan"):
        plan = segment_sum.segment_plan(f, flat.element_size(), n_out, view.order is None,
                                        segment_sum._alignment(flat))._asdict()
    # the library yardstick: one index_add_ into a discard row per sample
    valid = (ids >= 0) & (ids < n_out)
    base = torch.arange(b, device=ids.device)[:, None] * (n_out + 1)
    gid = (torch.where(valid, ids, n_out) + base).reshape(-1)
    rows = flat.reshape(-1, f)

    def library():
        return torch.zeros((b * (n_out + 1), f), dtype=flat.dtype,
                           device=flat.device).index_add_(0, gid, rows)

    lib_err = float((library().reshape(b, n_out + 1, f)[:, :n_out] - plain).abs().max())
    bound, b_ms, o_ms, n_valid = k7_bound_ms(ids, n_out, f, flat.element_size())
    sorted_ids = view.order is None
    return dict(
        ids=key[0], F=f, dtype=str(flat.dtype).replace("torch.", ""), calls=calls,
        entries=b * length, valid_entries=n_valid, plan=plan,
        max_abs_err=err, err_rel_to_max=err / scale, bit_identical=exact,
        library_max_abs_err=lib_err,
        ms=graph_ms(lambda: segment_sum._segment_sum_cuda(flat, ids, n_out, view)),
        ms_events=cuda_ms(lambda: segment_sum._segment_sum_cuda(flat, ids, n_out, view)),
        plain_ms=graph_ms(lambda: segment_sum.segment_sum_plain(flat, ids, n_out)),
        library_ms=graph_ms(library),
        view_ms=graph_ms(lambda: segment_sum.segment_view(ids, n_out, sorted_ids)),
        bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms)


# split thresholds of K7's mesh-density sets on the Moving-MNIST frames: 1e9
# splits nothing (64 nodes of 64 pixels, the mesh random weights coarsen every
# decoder step to), the path's own 0.1 (the encoder's input mesh, ~430
# nodes of 1-64 pixels) and 0.05 (~1400 nodes, mostly single pixels and a
# few 8 × 8 leaves, as a detailed frame gives)
K7_MESH_THRESHOLDS = (1e9, 0.1, 0.05)


def k7_mesh_sets(segment_sum, x, seed: int) -> list:
    """K7 on the pixel views of quadtree meshes of three densities
    (``K7_MESH_THRESHOLDS``) built from the frames ``x`` (B, T, rows, cols,
    1) as the main path builds them (n_max 2048, 8 × 8 largest cells): the
    pooling at F 1, 3 and 16 in f32 and bf16, values from ``seed``, each
    measured as :func:`k7_measure` does (bit-identical to the entry-ordered
    sum or the phase fails; timed beside its bound and ``index_add_``)."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
    from quadtree_mpnnlstm_tpu_torch.graph.quadtree import (decompose_levels,
                                                            pixel_nodes_from_levels)

    gen = torch.Generator(device=x.device).manual_seed(seed)
    out = []
    for thresh in K7_MESH_THRESHOLDS:
        gcfg = GraphConfig(image_shape=CANVAS, thresh=thresh, max_grid_size=8, n_max=2048,
                           e_max=10240)
        level = decompose_levels(x[..., 0].amax(dim=1), gcfg)
        ids, n_nodes, _ = pixel_nodes_from_levels(level, gcfg)
        check(int(n_nodes.max()) <= gcfg.n_max, f"mesh overflow at thresh {thresh}")
        view = segment_sum.segment_view(ids, gcfg.n_max)
        for f in (1, 3, 16):
            values = torch.randn((*ids.shape, f), generator=gen, device=x.device)
            for dtype, tol in ((torch.float32, K7_TOL), (torch.bfloat16, BF16_TOL)):
                w = k7_measure(segment_sum, ("pixel", f), (values.to(dtype), ids, gcfg.n_max,
                                                           view), 0, tol)
                w.update(thresh=thresh, nodes_mean=float(n_nodes.float().mean()),
                         nodes_max=int(n_nodes.max()))
                out.append(w)
    return out


def k7_path_means(ws) -> dict:
    """K7's per-set numbers (:func:`k7_measure`) averaged over the sets a
    train step launches, weighted by its launches of each."""
    ws = [w for w in ws if w["calls"]]
    n = sum(w["calls"] for w in ws)
    means = {k: sum(w["calls"] * w[k] for w in ws) / n
             for k in ("ms", "ms_events", "plain_ms", "library_ms", "bound_ms")}
    return dict(means, launches_per_step=n)


def edge_phases(seed: int, card: str, modules, segment, segment_sum):
    """Phases 20-25 on the flagship's pixelwise edge list; returns the
    forecasts' and the timed train steps' launches, K7's measurements per
    operand set and the train steps' K7 calls per operand set."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader

    run_dir = tempfile.TemporaryDirectory()
    p = ICE_SHAPE[0] * ICE_SHAPE[1]

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def counts():
        return {k: v for m in modules for k, v in m.LAUNCHES.items()}

    def others(launches):
        return {k: v for k, v in launches.items() if k != "segment_sum" and v}

    # ---- phase 20: the edge-list forecast through predict()
    data, clim, mask = ice_data(seed)
    windows = lambda i, j: ArrayDataset(data.x[i:j], data.y[i:j],  # noqa: E731
                                        data.launch_dates[i:j])
    model = make_ice_model(seed, run_dir.name, aggregation="xla")
    cfg = model.cfg
    k7 = expected_edge_launches(cfg, ICE_T_OUT)
    check(model.gcfg.aggregation == "xla" and model.gcfg.pixelwise and model.gcfg.carry_edges
          and (model.gcfg.n_max, model.gcfg.e_max) == (p, 4 * p),
          f"the predictor did not configure the pixelwise edge list: {model.gcfg}")
    model.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    y = model.predict(DataLoader(windows(0, ICE_FORECASTS)), climatology=clim, mask=mask)
    torch.cuda.synchronize()
    forecast_s = (time.perf_counter() - t0) / ICE_FORECASTS
    launches = counts()
    check(y.shape == (ICE_FORECASTS, ICE_T_OUT, *ICE_SHAPE, 1), f"edge predict shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite edge-list forecast")
    check(model.last_overflow == 0, f"edge-list mesh overflow {model.last_overflow}")
    check(launches["segment_sum"] == k7 * ICE_FORECASTS,
          f"edge forecast launches {launches}, expected K7 {k7} a forecast")
    check(not others(launches), f"K1-K6 ran on the edge-list path: {others(launches)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # ungated: the same weights on the pixelwise grid, over the valid pixels
    x0, y0, ld0 = data.x[:1], data.y[:1], data.launch_dates[:1]
    clim0 = model._clim_batch(clim, ld0)
    grid = make_ice_model(seed, run_dir.name)
    grid.model.load_state_dict(model.model.state_dict())
    y_e = model.forecast(x0, mask=mask, climatology=clim0)[0]
    y_g = grid.forecast(x0, mask=mask, climatology=clim0)[0]
    valid = torch.as_tensor(~mask, device=DEVICE)
    vs_grid = (y_e - y_g)[:, :, valid].abs().amax(dim=(0, 2, 3))  # (T_out,)
    del grid, y_g
    print(json.dumps({
        "phase": "edge_path", "card": card, "batch": 1, "forecasts": ICE_FORECASTS,
        "grid": ICE_SHAPE, "t_in": ICE_T_IN, "t_out": ICE_T_OUT,
        "n_max": model.gcfg.n_max, "e_max": model.gcfg.e_max, "valid_pixels": int(valid.sum()),
        "s_per_forecast": forecast_s, "frames_per_s": ICE_T_OUT / forecast_s,
        "peak_mem_gib": peak, "overflow": model.last_overflow, "k7_per_forecast": k7,
        "launches": launches, "max_abs_diff_vs_grid": float(vs_grid.max()),
        "max_abs_diff_vs_grid_step1": float(vs_grid[0]),
        "max_abs_value": float(y_e.abs().max()),
    }), flush=True)

    # ---- phase 21: K7 against its plain version on the path's operands
    with SegmentCapture(segment, p, keep=True) as cap:
        model.forecast(x0, mask=mask, climatology=clim0)
    check(sum(cap.calls.values()) == k7, f"K7 capture {cap.calls}, expected {k7}")
    short = make_ice_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT, aggregation="xla")
    short.initiate_training(lr=LR, lr_decay=0.95)
    y_s, clim_s = y0[:, :ICE_SHORT_T_OUT], clim0[:, :ICE_SHORT_T_OUT]
    with SegmentCapture(segment, p, keep=True) as cap_t:
        short.train_step(x0, y_s, mask=mask, climatology=clim_s, truncated_backprop=EDGE_TBPTT)
    want_short = expected_edge_launches(short.cfg, ICE_SHORT_T_OUT, EDGE_TBPTT, train=True)
    check(sum(cap_t.calls.values()) == want_short,
          f"K7 calls of a short train step {cap_t.calls}, expected {want_short}")
    sets = {**cap_t.ops, **cap.ops}  # the forecast's operands where it has the set
    calls = {**cap_t.calls, **cap.calls}
    k7_sets = [k7_measure(segment_sum, key, sets[key], calls[key]) for key in sorted(sets)]
    check({"dst", "src", "pixel"} <= {w["ids"] for w in k7_sets}
          and {256, 32, 1} <= {w["F"] for w in k7_sets if w["ids"] == "dst"},
          f"K7 operand sets {[(w['ids'], w['F']) for w in k7_sets]}")
    del cap, cap_t, sets, short
    print(json.dumps({"phase": "segment_kernel_vs_plain", "card": card, "k7_by_set": k7_sets,
                      "bit_identical": all(w["bit_identical"] for w in k7_sets)}), flush=True)

    # ---- phase 22: the 90-step forecast with K7's plain version
    y_k = model.forecast(x0, mask=mask, climatology=clim0)[0]
    reset()
    with mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain):
        y_p = model.forecast(x0, mask=mask, climatology=clim0)[0]
    check(counts()["segment_sum"] == 0, "K7 ran in the plain rollout")
    step_err = (y_k - y_p).abs().amax(dim=(0, 2, 3, 4))  # (T_out,)
    check(float(step_err.max()) <= ROLLOUT_TOL,
          f"edge-list rollout differs from the plain one by {float(step_err.max())}")
    print(json.dumps({"phase": "edge_rollout_vs_plain", "card": card, "steps": ICE_T_OUT,
                      "max_abs_err": float(step_err.max()),
                      "max_abs_err_last_step": float(step_err[-1]),
                      "bit_identical": bool(torch.equal(y_k, y_p)),
                      "max_abs_value": float(y_p.abs().max())}), flush=True)
    del model, y_k, y_p, y_e
    torch.cuda.empty_cache()

    # ---- phase 23: train_step on the edge list
    trainer = make_ice_model(seed, run_dir.name, aggregation="xla")
    trainer.initiate_training(lr=LR, lr_decay=0.95)
    batches = [(data.x[i:i + 1], data.y[i:i + 1],
                trainer._clim_batch(clim, data.launch_dates[i:i + 1]))
               for i in range(ICE_TRAIN_STEPS + 1)]
    want = expected_edge_launches(cfg, ICE_T_OUT, EDGE_TBPTT, train=True)
    chunks = len(trainer._chunks(EDGE_TBPTT))
    with_grad = sum(_attention_calls(cfg, n) for _, n in trainer._chunks(EDGE_TBPTT))

    def step(batch):
        x_b, y_b, c_b = batch
        return trainer.train_step(x_b, y_b, mask=mask, climatology=c_b,
                                  truncated_backprop=EDGE_TBPTT)

    with GradFnCheck(segment, "segment_sum", "SegmentSumBackward") as gcheck:
        loss, _ = step(batches[0])  # warm-up
    check(float(loss) == float(loss), "edge-list warm-up loss is NaN")
    check(not gcheck.bad and gcheck.calls == with_grad,
          f"K7 outputs without the SegmentSum node: {gcheck.bad[:3]} "
          f"({gcheck.calls} outputs required grad, expected {with_grad})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    losses, worst, pending = [], 0, None
    with SegmentCapture(segment, p) as tally:
        for batch in batches[1:]:
            loss, overflow = step(batch)
            if pending is not None:  # one step late, as train() drains
                losses.append(float(pending[0]))
                worst = max(worst, int(pending[1]))
            pending = (loss, overflow)
        losses.append(float(pending[0]))
        worst = max(worst, int(pending[1]))
    train_s = time.perf_counter() - t0
    train_launches = counts()
    per_step = {k: v / ICE_TRAIN_STEPS for k, v in train_launches.items()}
    check(bool(np.isfinite(losses).all()), f"non-finite edge-list training loss {losses}")
    check(worst == 0, f"mesh overflow {worst} in edge-list training")
    check(per_step["segment_sum"] == want,
          f"edge-list launches per step {per_step}, expected K7 {want}")
    check(not others(train_launches), f"K1-K6 ran on the edge-list train path: {per_step}")
    print(json.dumps({
        "phase": "edge_train_path", "card": card, "batch": 1, "steps": ICE_TRAIN_STEPS,
        "truncated_backprop": EDGE_TBPTT, "chunks": chunks, "seconds": train_s,
        "steps_per_s": ICE_TRAIN_STEPS / train_s,
        "frames_per_s": ICE_TRAIN_STEPS * ICE_T_OUT / train_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": losses, "overflow": worst, "launches_per_step": per_step,
        "k7_per_step_by_set": {f"{s}:{f}": c / ICE_TRAIN_STEPS
                               for (s, f), c in sorted(tally.calls.items())},
        "k7_outputs_checked": gcheck.calls,
    }), flush=True)
    del trainer, batches
    torch.cuda.empty_cache()

    # ---- phases 24-25: a kernel step vs a plain step (T_out 6); the
    # kernel step again
    def short_step():
        tr = make_ice_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT, aggregation="xla")
        tr.initiate_training(lr=LR, lr_decay=0.95)
        gen_s = torch.Generator(device=DEVICE).manual_seed(1)
        loss_s, _ = tr.train_step(x0, y_s, mask=mask, climatology=clim_s, generator=gen_s,
                                  truncated_backprop=EDGE_TBPTT)
        return loss_s, {n: q.grad.detach().clone() for n, q in tr.model.named_parameters()}

    loss_k, grads_k = short_step()
    reset()
    with mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain):
        loss_p, grads_p = short_step()
    check(counts()["segment_sum"] == 0, "K7 ran in the plain train step")
    leaf_err = max(float((grads_k[n] - grads_p[n]).abs().max())
                   / max(1.0, float(grads_p[n].abs().max())) for n in grads_p)
    check(leaf_err <= GRAD_TOL, f"edge-list gradients differ from the plain path by {leaf_err}")
    print(json.dumps({
        "phase": "edge_grads_vs_plain", "card": card, "t_out": ICE_SHORT_T_OUT,
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
        "max_leaf_err_rel": leaf_err, "leaves": len(grads_p),
        "bit_identical": all(torch.equal(grads_k[n], grads_p[n]) for n in grads_p),
    }), flush=True)
    del grads_p
    loss_k2, grads_k2 = short_step()
    same = torch.equal(loss_k, loss_k2) and all(torch.equal(grads_k[n], grads_k2[n])
                                                 for n in grads_k)
    check(same, "two identical edge-list train steps differ")
    print(json.dumps({"phase": "edge_determinism", "card": card, "t_out": ICE_SHORT_T_OUT,
                      "loss": float(loss_k2), "bit_identical": same}), flush=True)
    run_dir.cleanup()
    return launches, train_launches, k7_sets, tally.calls


# ---------------------------------------------------------------- bf16 attention
# The TransformerConv model (phases 9-12) and the grid flagship (phases
# 13-18) in bf16, bench.py's default dtype (make_predictor(conv=
# "TransformerConv", dtype="bfloat16"), make_ice_predictor(dtype=
# "bfloat16")): f32 masters cast at use, f32 LayerNorm statistics, keep
# windows and planes, window attributes, loss and predictions; bf16 K3/K4
# and K5/K6.


def _bf16_kernel_row(measure, args, kern_fn, plain_fn, bound_fn, calls):
    """Times of one bf16 attention launch: by CUDA graph and events, its
    plain version by events, the f32 kernel on the same operands in f32 by
    graph, and its bound at 2-byte operands."""
    import torch

    f32_args = tuple(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x
                     for x in args)
    bound, b_ms, o_ms = bound_fn(args)
    return dict(calls=calls, **measure,
                ms=graph_ms(lambda: kern_fn(*args)), events_ms=cuda_ms(lambda: kern_fn(*args)),
                plain_ms=cuda_ms(lambda: plain_fn(*args)),
                f32_ms=graph_ms(lambda: kern_fn(*f32_args)),
                bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms)


def _bf16_err(kern, plain, what: str):
    """(max |kern − plain|, that over max(1, max|plain|)), both bf16; within
    one bf16 rounding or the phase fails."""
    import torch

    check(kern.dtype == plain.dtype == torch.bfloat16, f"{what}: {kern.dtype}, {plain.dtype}")
    err = float((kern.float() - plain.float()).abs().max())
    rel = err / max(1.0, float(plain.float().abs().max()))
    check(rel <= BF16_TOL, f"{what} differs from its plain version by {rel} (relative)")
    return err, rel


def bf16_attn_phases(seed: int, card: str, spmm, attn, grid_attn, segment, segment_sum,
                     loader, x):
    """Phases 31-38: the TransformerConv model on attention windows and the
    sea-ice flagship on the grid, in bf16; returns the kernels line's bf16
    entries of K3, K4, K5 and K6, and K7's bf16 measurements per operand set
    of the TransformerConv path."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader

    run_dir = tempfile.TemporaryDirectory()
    conv, bf16 = "TransformerConv", torch.bfloat16
    modules = (spmm, attn, grid_attn, segment_sum)

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def counts():
        """({bf16 kernel: launches}, {f32 kernel: launches}) since reset()."""
        return ({k: v for m in modules for k, v in m.LAUNCHES_BF16.items()},
                {k: v for m in modules for k, v in m.LAUNCHES.items()})

    def others(launches, keep):
        return {k: v for k, v in launches.items() if k not in keep and v}

    # ---- phase 31: predict() with the TransformerConv model in bf16
    model = make_model(seed, run_dir.name, conv, dtype="bfloat16")
    cfg = model.cfg
    k3 = expected_attn_launches(cfg)
    meshes = 1 + T_OUT
    model.predict(loader)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    y = model.predict(loader)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches, f32_launches = counts()
    # as f32's (phase 9); only the node counts (a sum of ones) stay f32
    k7 = expected_quadtree_k7(cfg, 2)
    check(y.shape == (BATCH, T_OUT, *CANVAS, 1) and y.dtype == np.float32,
          f"bf16 attention predict gave {y.shape} {y.dtype}")
    check(bool(np.isfinite(y).all()) and model.last_overflow == 0,
          f"bf16 attention forecast: finite {bool(np.isfinite(y).all())}, "
          f"overflow {model.last_overflow}")
    check(launches["attn_apply"] == k3 and launches["segment_sum"] == k7 - meshes
          and f32_launches["segment_sum"] == meshes
          and not others(launches, ("attn_apply", "segment_sum"))
          and not others(f32_launches, ("segment_sum",)),
          f"bf16 attention forecast launches {launches} (f32 {f32_launches}), expected "
          f"K3 {k3}, K7 {k7 - meshes} in bf16, K7 {meshes} in f32")
    f32_model = make_model(seed, run_dir.name, conv)
    f32_model.forecast(x)  # warm-up
    peaks = {d: peak_above_start_gib(lambda m=m: m.forecast(x))
             for d, m in (("bfloat16", model), ("float32", f32_model))}
    del f32_model
    print(json.dumps({
        "phase": "bf16_attn_path", "card": card, "batch": BATCH, "batch_s": batch_s,
        "frames_per_s": BATCH * T_OUT / batch_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "forecast_peak_above_start_gib": peaks, "overflow": model.last_overflow,
        "launches_bf16": launches, "launches_f32": f32_launches,
    }), flush=True)

    # ---- phase 32: K3 and K4 in bf16 against their plain versions
    enc_calls = T_IN * cfg.n_layers * cfg.n_conv_layers
    p = CANVAS[0] * CANVAS[1]
    with AttnCapture(attn, "_attn_fwd_cuda", enc_calls, cfg.n_layers + 2) as cap, \
            SegmentCapture(segment, p, keep=True, dtype=bf16) as seg_f:
        model.forecast(x)
    check(cap.calls == k3, "bf16 attention capture run disagrees with the path")
    fwd = []
    for hd, args in cap.operands().items():
        check(args[0].dtype == args[3].dtype == bf16 and args[5].attr.dtype == torch.float32,
              f"K3 operands at HD={hd}: {args[0].dtype}, we {args[3].dtype}")
        with torch.no_grad():
            kern = attn._attn_fwd_cuda(*args)
            err, rel = _bf16_err(kern, attn.attn_plain(*args), f"bf16 K3 at HD={hd}")
            check(torch.equal(kern, attn._attn_fwd_cuda(*args)),
                  f"bf16 K3 differs from itself on a repeat at HD={hd}")
        fwd.append(_bf16_kernel_row(
            dict(HD=hd, max_abs_err=err, err_rel_to_max=rel, repeat_identical=True,
                 plan=attn.fwd_plan(args[6], 2)._asdict()),
            args, attn._attn_fwd_cuda, attn.attn_plain,
            lambda a: attn_bound_ms(attn, a, backward=False), cap.per_width[hd]))
    check(sorted(w["HD"] for w in fwd) == [1, 16, 128], f"bf16 K3 widths {fwd}")
    del cap
    _, batches = train_batches(seed, TRAIN_STEPS + 1)
    x_g, y_g = batches[0]
    trainer = make_trainer(seed, run_dir.name, conv, dtype="bfloat16")
    segment_sum.reset_launch_counts()
    with CaptureBwd(attn, "_attn_bwd_cuda") as cap_b, \
            SegmentCapture(segment, p, keep=True, dtype=bf16) as seg_t:
        trainer.train_step(x_g, y_g)
    check(sum(cap_b.per_width.values()) == k3, f"bf16 K4 calls {cap_b.per_width}")
    check(sum(seg_t.calls.values()) == segment_sum.LAUNCHES_BF16["segment_sum"],
          f"bf16 K7 capture {seg_t.calls} disagrees with the step's launches")
    sets = {**seg_t.ops, **seg_f.ops}
    k7_sets = [k7_measure(segment_sum, key, sets[key], seg_t.calls.get(key, 0), BF16_TOL)
               for key in sorted(sets)]
    check(all(ops[0].dtype == bf16 for ops in sets.values()), "a K7 set is not bf16")
    del seg_f, seg_t, sets
    bwd = []
    for hd, args in sorted(cap_b.first.items()):
        errs = {name: _bf16_err(a, p, f"bf16 K4 {name} at HD={hd}")
                for name, a, p in zip(("dq", "dk", "dv", "dwe"), attn._attn_bwd_cuda(*args),
                                      attn.attn_bwd_plain(*args))}
        bwd.append(_bf16_kernel_row(
            dict(HD=hd, err_rel_to_max={n: e[1] for n, e in errs.items()},
                 max_abs_err=max(e[0] for e in errs.values()), keep=args[4] is not None),
            args, attn._attn_bwd_cuda, attn.attn_bwd_plain,
            lambda a: attn_bound_ms(attn, a, backward=True), cap_b.per_width[hd]))
    del cap_b
    print(json.dumps({"phase": "bf16_attn_kernels_vs_plain", "card": card, "k3_by_width": fwd,
                      "k4_by_width": bwd, "k7_by_set": k7_sets}), flush=True)

    # ---- phase 33: train_step in bf16 on the attention path
    with GradFnCheck(attn, "attn_apply", "AttnApplyBackward") as gcheck:
        loss, _ = trainer.train_step(x_g, y_g)  # warm-up
    check(not gcheck.bad and gcheck.calls == k3,
          f"bf16 K3 outputs without the AttnApply node: {gcheck.bad[:3]} ({gcheck.calls})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    losses, worst, pending = [], 0, None
    for x_b, y_b in batches[1:]:
        loss, overflow = trainer.train_step(x_b, y_b)
        if pending is not None:  # one step late, as train() drains
            losses.append(float(pending[0]))
            worst = max(worst, int(pending[1]))
        pending = (loss, overflow)
    losses.append(float(pending[0]))
    worst = max(worst, int(pending[1]))
    train_s = time.perf_counter() - t0
    train_launches, train_f32 = counts()
    per_step = {k: v / TRAIN_STEPS for k, v in train_launches.items() if v}
    k7_step = expected_quadtree_k7(cfg, 2, train=True)
    want = {"attn_apply": k3, "attn_apply_bwd": k3, "segment_sum": k7_step - meshes}
    check(loss.dtype == torch.float32 and bool(np.isfinite(losses).all()) and worst == 0,
          f"bf16 attention training: losses {losses} ({loss.dtype}), overflow {worst}")
    check(per_step == {k: float(v) for k, v in want.items()}
          and {k: v for k, v in train_f32.items() if v} == {"segment_sum": TRAIN_STEPS * meshes},
          f"bf16 attention launches per step {per_step} (f32 {train_f32}), expected {want}")
    check(all(q.dtype == q.grad.dtype == torch.float32 for q in trainer.model.parameters()),
          "bf16 attention training left a master weight or gradient that is not float32")
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    step_peak = {"bfloat16": peak_above_start_gib(lambda: trainer.train_step(*batches[1]))}
    del trainer
    f32_trainer = make_trainer(seed, run_dir.name, conv)
    f32_trainer.train_step(*batches[0])
    step_peak["float32"] = peak_above_start_gib(lambda: f32_trainer.train_step(*batches[1]))
    del f32_trainer
    print(json.dumps({
        "phase": "bf16_attn_train_path", "card": card, "batch": BATCH, "steps": TRAIN_STEPS,
        "seconds": train_s, "steps_per_s": TRAIN_STEPS / train_s,
        "frames_per_s": TRAIN_STEPS * BATCH * T_OUT / train_s, "peak_mem_gib": peak_mem,
        "step_peak_above_start_gib": step_peak, "losses": losses, "overflow": worst,
        "launches_per_step": per_step,
        "f32_launches_per_step": {k: v / TRAIN_STEPS for k, v in train_f32.items() if v},
        "k3_outputs_checked": gcheck.calls,
    }), flush=True)

    # ---- phase 34: a teacher-forced bf16 step on K3/K4 vs one on their
    # plain versions (every decoder mesh from a true frame, so the runs
    # share their meshes); the kernel step again. K3 and attn_plain differ
    # by a bf16 rounding at a few outputs a call, and this model amplifies
    # such flips in its gradients about as much as it amplifies bf16 against
    # f32 (PERF.md §6): so the whole swap is held to the plain path's own
    # bf16-vs-f32 spread, and K4 alone, on the kernel step's forward, to
    # BF16_GRAD_TOL.
    def forced(dtype="bfloat16"):
        return make_trainer(seed, run_dir.name, conv, teacher_forcing_ratio=1.0, dtype=dtype)

    def plain(fwd=True):
        stack = contextlib.ExitStack()
        if fwd:
            stack.enter_context(mock.patch.object(attn, "_attn_fwd_cuda", attn.attn_plain))
            stack.enter_context(mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain))
        stack.enter_context(mock.patch.object(attn, "_attn_bwd_cuda", attn.attn_bwd_plain))
        return stack

    def leaf_err(ga, gb):
        return max(float((ga[n] - gb[n]).abs().max()) / max(1.0, float(gb[n].abs().max()))
                   for n in gb)

    loss_k, ovf_k, grads_k, meshes_k = step_with_meshes(forced(), x_g, y_g, seed=1)
    with plain():
        loss_p, _, grads_p, meshes_p = step_with_meshes(forced(), x_g, y_g, seed=1)
    with plain():
        loss_f, _, grads_f, meshes_f = step_with_meshes(forced("float32"), x_g, y_g, seed=1)
    with plain(fwd=False):
        _, _, grads_b, _ = step_with_meshes(forced(), x_g, y_g, seed=1)
    check(torch.equal(meshes_k, meshes_p) and torch.equal(meshes_k, meshes_f),
          "bf16 attention kernel and plain steps ran on different meshes")
    errs = {"kernel_vs_plain": leaf_err(grads_k, grads_p),
            "plain_bf16_vs_f32": leaf_err(grads_p, grads_f),
            "k4_vs_plain_backward": leaf_err(grads_k, grads_b)}
    del grads_p, grads_f, grads_b
    check(int(ovf_k) == 0 and abs(float(loss_k) - float(loss_p)) <= 1e-2 * abs(float(loss_p)),
          f"bf16 attention loss {float(loss_k)} against the plain path's {float(loss_p)}")
    check(errs["kernel_vs_plain"] <= errs["plain_bf16_vs_f32"]
          and errs["k4_vs_plain_backward"] <= BF16_GRAD_TOL,
          f"bf16 attention gradients against the plain path: {errs}")
    loss_k2, _, grads_k2, meshes_k2 = step_with_meshes(forced(), x_g, y_g, seed=1)
    same = (torch.equal(loss_k, loss_k2) and torch.equal(meshes_k, meshes_k2)
            and all(torch.equal(grads_k[n], grads_k2[n]) for n in grads_k))
    check(same, "two identical bf16 attention train steps differ")
    print(json.dumps({
        "phase": "bf16_attn_grads_vs_plain", "card": card, "teacher_forcing_ratio": 1.0,
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_plain_f32": float(loss_f),
        "max_leaf_err_rel": errs, "leaves": len(grads_k), "meshes_identical": True,
        "bit_identical_repeat": same,
    }), flush=True)
    del grads_k, grads_k2, model
    attn_launches = (launches, train_launches)

    # ---- phase 35: the flagship forecast in bf16
    data, clim, mask = ice_data(seed)
    windows = lambda i, j: ArrayDataset(data.x[i:j], data.y[i:j],  # noqa: E731
                                        data.launch_dates[i:j])
    model = make_ice_model(seed, run_dir.name, dtype="bfloat16")
    cfg = model.cfg
    k5 = expected_grid_launches(cfg)
    model.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    y = model.predict(DataLoader(windows(0, ICE_FORECASTS)), climatology=clim, mask=mask)
    torch.cuda.synchronize()
    forecast_s = (time.perf_counter() - t0) / ICE_FORECASTS
    launches, f32_launches = counts()
    check(y.shape == (ICE_FORECASTS, ICE_T_OUT, *ICE_SHAPE, 1) and y.dtype == np.float32
          and bool(np.isfinite(y).all()), f"bf16 grid forecast {y.shape} {y.dtype}")
    check(launches["grid_attn_apply"] == k5 * ICE_FORECASTS
          and not others(launches, ("grid_attn_apply",)) and not any(f32_launches.values()),
          f"bf16 grid forecast launches {launches} (f32 {f32_launches}), expected K5 {k5} a "
          "forecast")
    x0, y0 = data.x[:1], data.y[:1]
    clim0 = model._clim_batch(clim, data.launch_dates[:1])
    f32_model = make_ice_model(seed, run_dir.name)
    f32_model.forecast(x0, mask=mask, climatology=clim0)  # warm-up
    got = {}
    peaks = {d: peak_above_start_gib(
        lambda m=m, d=d: got.setdefault(d, m.forecast(x0, mask=mask, climatology=clim0)[0]))
        for d, m in (("bfloat16", model), ("float32", f32_model))}
    err = (got["bfloat16"] - got["float32"]).abs()
    del f32_model, got
    print(json.dumps({
        "phase": "bf16_grid_path", "card": card, "batch": 1, "forecasts": ICE_FORECASTS,
        "s_per_forecast": forecast_s, "frames_per_s": ICE_T_OUT / forecast_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "forecast_peak_above_start_gib": peaks, "launches_bf16": launches,
        "launches_f32": f32_launches, "k5_per_forecast": k5,
        "vs_f32_mean_abs_by_step": err.mean(dim=(0, 2, 3, 4))[[0, 9, 89]].tolist(),
    }), flush=True)

    # ---- phase 36: K5 and K6 in bf16 against their plain versions
    enc_calls = ICE_T_IN * cfg.n_layers * cfg.n_conv_layers
    with AttnCapture(grid_attn, "_grid_attn_fwd_cuda", enc_calls, cfg.n_layers + 2) as cap:
        model.forecast(x0, mask=mask, climatology=clim0)
    check(cap.calls == k5, "bf16 grid capture run disagrees with the path")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    grid_fwd = []
    for hd, args in cap.operands().items():
        q, dims = args[0], args[6]
        check(q.dtype == args[3].dtype == args[4].dtype == bf16,
              f"K5 operands at H={hd}: {q.dtype}, e_dir {args[3].dtype}, valid {args[4].dtype}")
        keep = (torch.rand((q.shape[0], dims.ndirs, q.shape[1], dims.heads), generator=gen,
                           device=DEVICE) < 0.9).float() / 0.9
        for kargs in (args, args[:5] + (keep, dims)):
            with torch.no_grad():
                kern = grid_attn._grid_attn_fwd_cuda(*kargs)
                plain = grid_attn.grid_attn_plain(*kargs)
            # d divides 32 at every flagship width: the f32 sums of the
            # plain order, rounded once
            check(kern.dtype == bf16 and torch.equal(kern, plain),
                  f"bf16 K5 is not bit-identical to grid_attn_plain at H={hd}")
            grid_fwd.append(_bf16_kernel_row(
                dict(H=hd, keep=kargs[5] is not None, max_abs_err=0.0, bit_identical=True,
                     plan=grid_attn.fwd_plan(dims, 2, q.shape[0])._asdict()),
                kargs, grid_attn._grid_attn_fwd_cuda, grid_attn.grid_attn_plain,
                lambda a: grid_bound_ms(a, backward=False),
                cap.per_width[hd]))
    check(sorted({w["H"] for w in grid_fwd}) == [1, 32, 256], f"bf16 K5 widths {grid_fwd}")
    short = make_ice_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT, dtype="bfloat16")
    short.initiate_training(lr=LR, lr_decay=0.95)
    y_s, clim_s = y0[:, :ICE_SHORT_T_OUT], clim0[:, :ICE_SHORT_T_OUT]
    with CaptureBwd(grid_attn, "_grid_attn_bwd_cuda") as cap_b:
        short.train_step(x0, y_s, mask=mask, climatology=clim_s)
    check(sum(cap_b.per_width.values()) == expected_grid_launches(short.cfg),
          f"bf16 K6 calls {cap_b.per_width}")
    grid_bwd = []
    for hd, args in sorted(cap_b.first.items()):
        check(args[5] is not None, "a bf16 training step's K6 operands carry no keep planes")
        for kargs in (args, args[:5] + (None,) + args[6:]):
            errs = {name: _bf16_err(a, p, f"bf16 K6 {name} at H={hd}")
                    for name, a, p in zip(("dq", "dk", "dv", "de_dir"),
                                          grid_attn._grid_attn_bwd_cuda(*kargs),
                                          grid_attn.grid_attn_bwd_plain(*kargs))}
            grid_bwd.append(_bf16_kernel_row(
                dict(H=hd, keep=kargs[5] is not None,
                     err_rel_to_max={n: e[1] for n, e in errs.items()},
                     max_abs_err=max(e[0] for e in errs.values())),
                kargs, grid_attn._grid_attn_bwd_cuda, grid_attn.grid_attn_bwd_plain,
                lambda a: grid_bound_ms(a, backward=True),
                cap.per_width[hd]))
    del cap, cap_b, args, kargs, short
    print(json.dumps({"phase": "bf16_grid_kernels_vs_plain", "card": card,
                      "k5_by_width": grid_fwd, "k6_by_width": grid_bwd}), flush=True)
    del model
    torch.cuda.empty_cache()

    # ---- phase 37: full-BPTT train_step on the flagship in bf16
    trainer = make_ice_model(seed, run_dir.name, dtype="bfloat16")
    trainer.initiate_training(lr=LR, lr_decay=0.95)
    batches = [(data.x[i:i + 1], data.y[i:i + 1],
                trainer._clim_batch(clim, data.launch_dates[i:i + 1]))
               for i in range(ICE_TRAIN_STEPS + 1)]

    def step(tr, batch):
        x_b, y_b, c_b = batch
        return tr.train_step(x_b, y_b, mask=mask, climatology=c_b, truncated_backprop=ICE_TBPTT)

    with GradFnCheck(grid_attn, "grid_attn_apply", "GridAttnApplyBackward") as gcheck:
        step(trainer, batches[0])  # warm-up
    check(not gcheck.bad and gcheck.calls == k5,
          f"bf16 K5 outputs without the GridAttnApply node: {gcheck.bad[:3]} ({gcheck.calls})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    losses, pending = [], None
    for batch in batches[1:]:
        loss, _ = step(trainer, batch)
        if pending is not None:  # one step late, as train() drains
            losses.append(float(pending))
        pending = loss
    losses.append(float(pending))
    train_s = time.perf_counter() - t0
    grid_train, grid_train_f32 = counts()
    per_step = {k: v / ICE_TRAIN_STEPS for k, v in grid_train.items() if v}
    check(loss.dtype == torch.float32 and bool(np.isfinite(losses).all()),
          f"bf16 grid training losses {losses} ({loss.dtype})")
    check(per_step == {"grid_attn_apply": k5, "grid_attn_apply_bwd": k5}
          and not any(grid_train_f32.values()),
          f"bf16 grid launches per step {per_step} (f32 {grid_train_f32}), expected K5 = K6 = "
          f"{k5}")
    check(all(q.dtype == q.grad.dtype == torch.float32 for q in trainer.model.parameters()),
          "bf16 grid training left a master weight or gradient that is not float32")
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    step_peak = {"bfloat16": peak_above_start_gib(lambda: step(trainer, batches[1]))}
    del trainer
    torch.cuda.empty_cache()
    f32_trainer = make_ice_model(seed, run_dir.name)
    f32_trainer.initiate_training(lr=LR, lr_decay=0.95)
    step(f32_trainer, batches[0])
    step_peak["float32"] = peak_above_start_gib(lambda: step(f32_trainer, batches[1]))
    del f32_trainer
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "bf16_grid_train_path", "card": card, "batch": 1, "steps": ICE_TRAIN_STEPS,
        "truncated_backprop": ICE_TBPTT, "seconds": train_s,
        "steps_per_s": ICE_TRAIN_STEPS / train_s,
        "frames_per_s": ICE_TRAIN_STEPS * ICE_T_OUT / train_s, "peak_mem_gib": peak_mem,
        "step_peak_above_start_gib": step_peak, "losses": losses,
        "launches_per_step": per_step, "k5_outputs_checked": gcheck.calls,
    }), flush=True)

    # ---- phase 38: a bf16 step (T_out 6) on K5/K6 vs one on their plain
    # versions; the kernel step again
    def short_step():
        tr = make_ice_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT, dtype="bfloat16")
        tr.initiate_training(lr=LR, lr_decay=0.95)
        gen_s = torch.Generator(device=DEVICE).manual_seed(1)
        loss_s, _ = tr.train_step(x0, y_s, mask=mask, climatology=clim_s, generator=gen_s)
        return loss_s, {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()}

    loss_k, grads_k = short_step()
    with mock.patch.object(grid_attn, "_grid_attn_fwd_cuda", grid_attn.grid_attn_plain), \
            mock.patch.object(grid_attn, "_grid_attn_bwd_cuda", grid_attn.grid_attn_bwd_plain):
        loss_p, grads_p = short_step()
    leaf_err = max(float((grads_k[n] - grads_p[n]).abs().max())
                   / max(1.0, float(grads_p[n].abs().max())) for n in grads_p)
    check(leaf_err <= BF16_GRAD_TOL, f"bf16 grid gradients differ from the plain path by "
          f"{leaf_err}")
    del grads_p
    torch.cuda.empty_cache()
    loss_k2, grads_k2 = short_step()
    same = torch.equal(loss_k, loss_k2) and all(torch.equal(grads_k[n], grads_k2[n])
                                                 for n in grads_k)
    check(same, "two identical bf16 grid train steps differ")
    print(json.dumps({
        "phase": "bf16_grid_grads_vs_plain", "card": card, "t_out": ICE_SHORT_T_OUT,
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
        "max_leaf_err_rel": leaf_err, "leaves": len(grads_k), "bit_identical_repeat": same,
    }), flush=True)
    run_dir.cleanup()

    # the kernels line's bf16 entries: launch-weighted means over the
    # widths (K5 without keep planes, as the forecast runs it; K6 with
    # them, as training does)
    def entry(name, source, replaces, ws, paths):
        n = sum(w["calls"] for w in ws)
        avg = lambda key: sum(w["calls"] * w[key] for w in ws) / n  # noqa: E731
        fwd_l, train_l, steps = paths
        return dict(name=f"{name}_bf16", dtype="bfloat16", route="cuda",
                    source=f"quadtree_mpnnlstm_tpu_torch/csrc/{source}", replaces=replaces,
                    launches=train_l[name], max_abs_err=max(w["max_abs_err"] for w in ws),
                    ms=avg("ms"), events_ms=avg("events_ms"), f32_ms=avg("f32_ms"),
                    plain_ms=avg("plain_ms"), bound_ms=avg("bound_ms"),
                    bound_by="bytes" if avg("bytes_ms") >= avg("ops_ms") else "operations",
                    # no PyTorch call adds per-edge (or per-direction)
                    # terms to keys and values
                    library_ms=None,
                    launches_by_path={"predict_batch": fwd_l[name],
                                      f"train_{steps}_steps": train_l[name]})

    windows_paths = (*attn_launches, TRAIN_STEPS)
    grid_paths = (launches, grid_train, ICE_TRAIN_STEPS)
    pallas, grid_src = "quadtree_mpnnlstm_tpu/ops/pallas_attn.py", \
        "quadtree_mpnnlstm_tpu/ops/pallas_grid_attn.py"
    return [entry("attn_apply", "attn.cuh", f"{pallas}:372", fwd, windows_paths),
            entry("attn_apply_bwd", "attn_bwd.cuh", f"{pallas}:424", bwd, windows_paths),
            entry("grid_attn_apply", "grid_attn.cu", f"{grid_src}:446",
                  [w for w in grid_fwd if not w["keep"]], grid_paths),
            entry("grid_attn_apply_bwd", "grid_attn.cu", f"{grid_src}:446",
                  [w for w in grid_bwd if w["keep"]], grid_paths)], k7_sets

# ---------------------------------------------------------------- bench.py's defaults
# Phases 39-42: per-step remat (bench.py --remat, default full), the
# per-gate stacks measure_ice takes on pixelwise meshes, and the
# ice-quadtree workload.
REMAT_MODES = ("none", "full", "mesh")
ICE_QUAD_TRAIN_STEPS = 2


def launch_totals(modules) -> dict:
    """Each kernel's launches, f32 and bf16 together."""
    out = {}
    for m in modules:
        for counts in (m.LAUNCHES, m.LAUNCHES_BF16):
            for k, v in counts.items():
                out[k] = out.get(k, 0) + v
    return out


def expected_remat_launches(cfg, mode: str) -> dict:
    """Launches of one full-BPTT ChebConv train step (phase 5's) under
    per-step remat, read from the code: a replay launches its step's
    forward again. Every K2 runs inside an encoder or decoder step, so
    every mode but "none" launches each twice; "full" also replays every
    decoder step's remesh (K1, then K7 for the new mesh's node counts,
    pooling and degrees and for each layer's H and C carried onto it);
    "mesh" builds each mesh once, outside the replayed cell."""
    want = expected_launches(cfg)
    if mode != "none":
        want["spmm_apply"] *= 2
    if mode == "full":
        want["spmm_build_blocks"] += T_OUT
        want["segment_sum"] += T_OUT * (3 + 2 * cfg.n_layers)
    return want


def expected_ice_quadtree_launches(cfg, train: bool) -> dict:
    """K3, K4 and K7 launches of one ice-quadtree forecast (or full-BPTT
    train step under remat full), read from the code: one attention call
    per conv layer of every encoder step and per cell and head conv of
    every decoder step (K3; a train step replays each, and K4 runs once
    per call); K7 for every mesh's node counts and pooling, each layer's H
    and C carried onto each remesh and each decoder step's climatology
    pooled onto its mesh; a train step's backward adds the gather of every
    frame and of the H and C of every remesh but the last, and the replay
    repeats every decoder step's remesh (counts, pooling, H and C)."""
    k3 = _attention_calls(cfg, cfg.output_timesteps)
    t_out, per_remesh = cfg.output_timesteps, 2 + 2 * cfg.n_layers
    k7 = 2 * (1 + t_out) + 2 * cfg.n_layers * t_out + t_out
    if not train:
        return {"attn_apply": k3, "attn_apply_bwd": 0, "segment_sum": k7}
    k7 += t_out + (t_out - 1) * 2 * cfg.n_layers + t_out * per_remesh
    return {"attn_apply": 2 * k3, "attn_apply_bwd": k3, "segment_sum": k7}


def _stacked_grads(per_gate_model):
    """A per-gate model's gradients in the fused layout (stacked by
    ``fuse_attn_gates``), by parameter name."""
    from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax, params_to_jax

    grads = {n: p.grad for n, p in per_gate_model.named_parameters()}
    return params_from_jax(params_to_jax(grads), fuse_gates=True)


def _leaf_err(ga, gb) -> float:
    return max(float((ga[n].cpu() - gb[n].cpu()).abs().max())
               / max(1.0, float(gb[n].abs().max())) for n in gb)


def bench_default_phases(seed: int, card: str, spmm, attn, grid_attn, segment_sum) -> dict:
    """Phases 39-42; returns what the kernels line adds: K5/K6 rows of the
    per-gate flagship and K3/K4 rows at HD 256 on the ice-quadtree
    windows, with the launches of those paths."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader

    run_dir = tempfile.TemporaryDirectory()
    modules = (spmm, attn, grid_attn, segment_sum)

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def grads_of(trainer):
        return {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}

    # ---- phase 39: the main path under remat none / full / mesh
    _, batches = train_batches(seed, 1)
    x_b, y_b = batches[0]
    modes = {}
    for mode in REMAT_MODES:
        trainer = make_trainer(seed, run_dir.name, teacher_forcing_ratio=0.5, dtype="bfloat16",
                               remat=mode)
        check(trainer.model.remat == mode, f"remat {trainer.model.remat}, asked {mode}")
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        out = {}
        reset()
        peak = peak_above_start_gib(
            lambda: out.update(step=trainer.train_step(x_b, y_b, generator=gen)))
        launches = launch_totals(modules)
        grads = grads_of(trainer)
        t0 = time.perf_counter()
        float(trainer.train_step(x_b, y_b)[0])
        modes[mode] = dict(loss=out["step"][0], overflow=int(out["step"][1]), grads=grads,
                           generator=gen.get_state(), launches=launches, peak_gib=peak,
                           step_s=time.perf_counter() - t0)
        want = expected_remat_launches(trainer.cfg, mode)
        got = {k: launches[k] for k in want}
        check(got == want, f"remat {mode}: launches a step {got}, expected {want}")
        del trainer
    ref = modes["none"]
    for mode, r in modes.items():
        check(bool(torch.isfinite(r["loss"])) and r["overflow"] == 0,
              f"remat {mode}: loss {float(r['loss'])}, overflow {r['overflow']}")
        same = (torch.equal(r["loss"], ref["loss"]) and torch.equal(r["generator"],
                                                                    ref["generator"])
                and all(torch.equal(r["grads"][n], g) for n, g in ref["grads"].items()))
        check(same, f"remat {mode}: the step is not bit-identical to remat none")
    print(json.dumps({
        "phase": "remat_main_path", "card": card, "batch": BATCH, "dtype": "bfloat16",
        "dropout": 0.1, "teacher_forcing_ratio": 0.5, "bit_identical": True,
        "leaves": len(ref["grads"]),
        "modes": {m: {"loss": float(r["loss"]), "step_s": r["step_s"],
                      "step_peak_above_start_gib": r["peak_gib"],
                      "launches_per_step": {k: v for k, v in r["launches"].items() if v}}
                  for m, r in modes.items()},
    }), flush=True)
    del modes, ref
    torch.cuda.empty_cache()

    # ---- phase 40: the flagship at bench.py --workload ice defaults
    data, clim, mask = ice_data(seed)
    windows = lambda i, j: ArrayDataset(data.x[i:j], data.y[i:j],  # noqa: E731
                                        data.launch_dates[i:j])
    x0, y0 = data.x[:1], data.y[:1]
    model = make_ice_model(seed, run_dir.name, dtype="bfloat16", remat=True, fused_gates=False)
    cfg = model.cfg
    check(not cfg.fused_gates and model.model.remat == "full", f"ice defaults: {cfg}")
    clim0 = model._clim_batch(clim, data.launch_dates[:1])
    k5 = expected_grid_launches(cfg)
    model.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    y = model.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)
    torch.cuda.synchronize()
    forecast_s = time.perf_counter() - t0
    fwd_launches = launch_totals(modules)
    check(bool(np.isfinite(y).all()) and model.last_overflow == 0,
          f"per-gate bf16 grid forecast: finite {bool(np.isfinite(y).all())}, "
          f"overflow {model.last_overflow}")
    check({k: v for k, v in fwd_launches.items() if v} == {"grid_attn_apply": k5},
          f"per-gate grid forecast launches {fwd_launches}, expected K5 {k5}")
    enc_calls = ICE_T_IN * cfg.n_layers * cfg.n_conv_layers
    with AttnCapture(grid_attn, "_grid_attn_fwd_cuda", enc_calls, cfg.n_layers + 2) as cap:
        model.forecast(x0, mask=mask, climatology=clim0)
    k5_rows = []
    for hd, args in cap.operands().items():
        with torch.no_grad():
            kern = grid_attn._grid_attn_fwd_cuda(*args)
            plain = grid_attn.grid_attn_plain(*args)
        check(kern.dtype == torch.bfloat16 and torch.equal(kern, plain),
              f"per-gate bf16 K5 is not bit-identical to its plain version at H={hd}")
        k5_rows.append(_bf16_kernel_row(
            dict(H=hd, keep=False, max_abs_err=0.0, bit_identical=True,
                 plan=grid_attn.fwd_plan(args[6], 2, args[0].shape[0])._asdict()), args,
            grid_attn._grid_attn_fwd_cuda, grid_attn.grid_attn_plain,
            lambda a: grid_bound_ms(a, backward=False), cap.per_width[hd]))
    del model, cap
    short = make_ice_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT, dtype="bfloat16",
                           remat=True, fused_gates=False)
    short.initiate_training(lr=LR, lr_decay=0.95)
    y_s, clim_s = y0[:, :ICE_SHORT_T_OUT], clim0[:, :ICE_SHORT_T_OUT]
    with CaptureBwd(grid_attn, "_grid_attn_bwd_cuda") as cap_b:
        short.train_step(x0, y_s, mask=mask, climatology=clim_s)
    k6_rows = []
    for hd, args in sorted(cap_b.first.items()):
        errs = {name: _bf16_err(a, p, f"per-gate bf16 K6 {name} at H={hd}")
                for name, a, p in zip(("dq", "dk", "dv", "de_dir"),
                                      grid_attn._grid_attn_bwd_cuda(*args),
                                      grid_attn.grid_attn_bwd_plain(*args))}
        k6_rows.append(_bf16_kernel_row(
            dict(H=hd, keep=args[5] is not None,
                 err_rel_to_max={n: e[1] for n, e in errs.items()},
                 max_abs_err=max(e[0] for e in errs.values())),
            args, grid_attn._grid_attn_bwd_cuda, grid_attn.grid_attn_bwd_plain,
            lambda a: grid_bound_ms(a, backward=True), cap_b.per_width[hd]))
    del short, cap_b, args
    torch.cuda.empty_cache()

    def ice_step(tr, batch, gen=None, truncated=ICE_TBPTT):
        x_i, y_i, c_i = batch
        return tr.train_step(x_i, y_i, mask=mask, climatology=c_i, generator=gen,
                             truncated_backprop=truncated)

    def timed_steps(tr, steps):
        """(seconds, losses, worst overflow) of ``steps`` train steps, each
        step's loss and overflow fetched one step late, as train() does."""
        t0 = time.perf_counter()
        losses, worst, pending = [], 0, None
        for batch in steps:
            loss, overflow = ice_step(tr, batch)
            if pending is not None:
                losses.append(float(pending[0]))
                worst = max(worst, int(pending[1]))
            pending = (loss, overflow)
        losses.append(float(pending[0]))
        worst = max(worst, int(pending[1]))
        return time.perf_counter() - t0, losses, worst

    trainer = make_ice_model(seed, run_dir.name, dtype="bfloat16", remat=True, fused_gates=False)
    trainer.initiate_training(lr=LR, lr_decay=0.95)
    ice_batches = [(data.x[i:i + 1], data.y[i:i + 1],
                    trainer._clim_batch(clim, data.launch_dates[i:i + 1]))
                   for i in range(ICE_TRAIN_STEPS + 1)]
    ice_step(trainer, ice_batches[0])  # warm-up
    torch.cuda.synchronize()
    reset()
    train_s, losses, worst = timed_steps(trainer, ice_batches[1:])
    grid_train = {k: v / ICE_TRAIN_STEPS for k, v in launch_totals(modules).items() if v}
    check(bool(np.isfinite(losses).all()) and worst == 0,
          f"per-gate bf16 grid training: losses {losses}, overflow {worst}")
    check(grid_train == {"grid_attn_apply": 2 * k5, "grid_attn_apply_bwd": k5},
          f"per-gate grid launches a step {grid_train}, expected K5 {2 * k5} (with the "
          f"replays), K6 {k5}")
    peaks = {"full": peak_above_start_gib(lambda: ice_step(trainer, ice_batches[1]))}
    del trainer
    torch.cuda.empty_cache()
    no_remat = make_ice_model(seed, run_dir.name, dtype="bfloat16", remat=False,
                              fused_gates=False)
    no_remat.initiate_training(lr=LR, lr_decay=0.95)
    ice_step(no_remat, ice_batches[0])
    peaks["none"] = peak_above_start_gib(lambda: ice_step(no_remat, ice_batches[1]))
    del no_remat
    torch.cuda.empty_cache()
    # the per-gate step against the fused model on the same weights,
    # stacked by fuse_attn_gates, from the same generator
    from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax, params_to_jax

    per_gate = make_ice_model(seed, run_dir.name, dtype="bfloat16", remat=True,
                              fused_gates=False)
    fused = make_ice_model(seed, run_dir.name, dtype="bfloat16", remat=True)
    fused.model.load_state_dict(params_from_jax(params_to_jax(per_gate.model.state_dict()),
                                                fuse_gates=True))
    steps = {}
    for name, tr in (("per_gate", per_gate), ("fused", fused)):
        tr.initiate_training(lr=LR, lr_decay=0.95)
        loss, _ = ice_step(tr, ice_batches[0], torch.Generator(device=DEVICE).manual_seed(1))
        steps[name] = (loss, _stacked_grads(tr.model) if name == "per_gate"
                       else grads_of(tr))
    layout_err = _leaf_err(steps["per_gate"][1], steps["fused"][1])
    layout_same = (torch.equal(steps["per_gate"][0], steps["fused"][0])
                   and all(torch.equal(steps["per_gate"][1][n].to(DEVICE), g)
                           for n, g in steps["fused"][1].items()))
    check(layout_err <= BF16_GRAD_TOL,
          f"per-gate gradients differ from the fused model's by {layout_err}")
    del per_gate, fused, steps
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "ice_defaults", "card": card, "mesh": "grid", "dtype": "bfloat16",
        "fused_gates": False, "remat": "full", "t_out": ICE_T_OUT, "truncated_backprop": 0,
        "s_per_forecast": forecast_s, "forecast_launches": fwd_launches, "overflow": worst,
        "train_steps": ICE_TRAIN_STEPS, "seconds": train_s,
        "steps_per_s": ICE_TRAIN_STEPS / train_s,
        "frames_per_s": ICE_TRAIN_STEPS * ICE_T_OUT / train_s, "losses": losses,
        "launches_per_step": grid_train, "step_peak_above_start_gib": peaks,
        "per_gate_vs_fused": {"max_leaf_err_rel": layout_err, "bit_identical": layout_same},
        "k5_by_width": k5_rows, "k6_by_width": k6_rows,
    }), flush=True)

    # ---- phase 41: the edge list, f32, full BPTT under remat full
    edge = make_ice_model(seed, run_dir.name, aggregation="xla", remat=True)
    edge.initiate_training(lr=LR, lr_decay=0.95)
    edge_batch = (x0, y0, edge._clim_batch(clim, data.launch_dates[:1]))
    reset()
    out = {}
    t0 = time.perf_counter()
    edge_peak = peak_above_start_gib(lambda: out.update(step=ice_step(edge, edge_batch)))
    edge_s = time.perf_counter() - t0
    edge_launches = launch_totals(modules)
    k7_edge = expected_edge_launches(edge.cfg, ICE_T_OUT, train=True) \
        + _attention_calls(edge.cfg, ICE_T_OUT)  # the replays' aggregations
    check(bool(torch.isfinite(out["step"][0])) and int(out["step"][1]) == 0,
          f"edge-list full-BPTT step: loss {float(out['step'][0])}, "
          f"overflow {int(out['step'][1])}")
    check({k: v for k, v in edge_launches.items() if v} == {"segment_sum": k7_edge},
          f"edge-list full-BPTT launches {edge_launches}, expected K7 {k7_edge}")
    edge_loss = float(out["step"][0])
    del edge, out
    torch.cuda.empty_cache()

    def short_edge(mode):
        tr = make_ice_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT, aggregation="xla",
                            remat=mode)
        tr.initiate_training(lr=LR, lr_decay=0.95)
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        loss, _ = ice_step(tr, (x0, y_s, clim_s), gen)
        return loss, grads_of(tr), gen.get_state()

    full, none = short_edge("full"), short_edge("none")
    same = (torch.equal(full[0], none[0]) and torch.equal(full[2], none[2])
            and all(torch.equal(full[1][n], g) for n, g in none[1].items()))
    check(same, "edge-list remat full step differs from remat none")
    del full, none
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "edge_full_bptt", "card": card, "dtype": "float32", "remat": "full",
        "t_out": ICE_T_OUT, "truncated_backprop": 0, "loss": edge_loss, "overflow": 0,
        "step_s": edge_s, "step_peak_above_start_gib": edge_peak,
        "launches_per_step": {k: v for k, v in edge_launches.items() if v},
        "short_t_out": ICE_SHORT_T_OUT, "remat_full_vs_none_bit_identical": same,
    }), flush=True)

    # ---- phase 42: ice-quadtree at its defaults
    quad = make_ice_quadtree_model(seed, run_dir.name)
    qcfg, gcfg = quad.cfg, quad.gcfg
    check(gcfg.attn_windows and not gcfg.carry_edges and gcfg.adjacency == "sort"
          and quad.model.remat == "full" and qcfg.compute_dtype == "bfloat16",
          f"ice-quadtree configuration: {qcfg}, {gcfg}")
    quad.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    with Record(attn, "attn_tile_meta") as built:
        y = quad.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)
    torch.cuda.synchronize()
    quad_forecast_s = time.perf_counter() - t0
    quad_fwd = launch_totals(modules)
    want = expected_ice_quadtree_launches(qcfg, train=False)
    check(bool(np.isfinite(y).all()) and quad.last_overflow == 0,
          f"ice-quadtree forecast: finite {bool(np.isfinite(y).all())}, "
          f"overflow {quad.last_overflow}")
    check({k: v for k, v in quad_fwd.items() if v} == {k: v for k, v in want.items() if v},
          f"ice-quadtree forecast launches {quad_fwd}, expected {want}")
    fills = [window_fill(m.src_rel, m.dst_rel, m.live) for m, _ in built.results]
    max_nodes = max(int(a[7].max()) for a in built.calls)  # attn_tile_meta's n_nodes
    del built
    enc_calls = ICE_T_IN * qcfg.n_layers * qcfg.n_conv_layers
    with AttnCapture(attn, "_attn_fwd_cuda", enc_calls, qcfg.n_layers + 2) as cap:
        quad.forecast(x0, mask=mask, climatology=clim0)
    fwd_args = cap.operands()[256]
    del cap

    def as_f32(args):
        return tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
                     for a in args)

    def k3_row(args, dtype):
        with torch.no_grad():
            kern = attn._attn_fwd_cuda(*args)
            plain = attn.attn_plain(*args)
            check(torch.equal(kern, attn._attn_fwd_cuda(*args)),
                  f"K3 at HD 256 differs from itself on a repeat ({dtype})")
        if dtype == "bfloat16":
            err = _bf16_err(kern, plain, "K3 at HD 256")[0]
        else:
            err = float((kern - plain).abs().max())
            check(err <= K3_TOL, f"K3 differs from attn_plain at HD 256 (f32): {err}")
        bound, b_ms, o_ms = attn_bound_ms(attn, args, backward=False)
        return dict(HD=256, dtype=dtype, max_abs_err=err, repeat_identical=True,
                    live_tiles=int(args[5].live.long().sum()),
                    ms=graph_ms(lambda: attn._attn_fwd_cuda(*args)),
                    events_ms=cuda_ms(lambda: attn._attn_fwd_cuda(*args)),
                    plain_ms=cuda_ms(lambda: attn.attn_plain(*args)),
                    bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms)

    k3_256 = [k3_row(fwd_args, "bfloat16"), k3_row(as_f32(fwd_args), "float32")]
    del quad, fwd_args
    torch.cuda.empty_cache()

    trainer = make_ice_quadtree_model(seed, run_dir.name)
    trainer.initiate_training(lr=LR, lr_decay=0.95)
    with CaptureBwd(attn, "_attn_bwd_cuda") as cap_b:
        ice_step(trainer, ice_batches[0])  # warm-up
    bwd_args = cap_b.first[256]
    k4_calls = cap_b.per_width[256]
    del cap_b
    torch.cuda.synchronize()
    reset()
    quad_train_s, quad_losses, quad_worst = timed_steps(
        trainer, ice_batches[1:1 + ICE_QUAD_TRAIN_STEPS])
    quad_train = {k: v / ICE_QUAD_TRAIN_STEPS for k, v in launch_totals(modules).items() if v}
    want = expected_ice_quadtree_launches(qcfg, train=True)
    check(bool(np.isfinite(quad_losses).all()) and quad_worst == 0,
          f"ice-quadtree training: losses {quad_losses}, overflow {quad_worst}")
    check(quad_train == want, f"ice-quadtree launches a step {quad_train}, expected {want}")
    quad_peak = peak_above_start_gib(lambda: ice_step(trainer, ice_batches[1]))
    del trainer
    torch.cuda.empty_cache()

    def k4_row(args, dtype):
        kern = attn._attn_bwd_cuda(*args)
        plain = attn.attn_bwd_plain(*args)
        if dtype == "bfloat16":
            errs = {n: _bf16_err(a, p, f"K4 {n} at HD 256")
                    for n, a, p in zip(("dq", "dk", "dv", "dwe"), kern, plain)}
        else:
            errs = {}
            for n, a, p in zip(("dq", "dk", "dv", "dwe"), kern, plain):
                err = float((a - p).abs().max())
                errs[n] = (err, err / max(1.0, float(p.abs().max())))
            check(max(e[1] for e in errs.values()) <= K4_TOL,
                  f"K4 differs from its plain backward at HD 256 (f32): {errs}")
        bound, b_ms, o_ms = attn_bound_ms(attn, args, backward=True)
        return dict(HD=256, dtype=dtype, calls=k4_calls,
                    err_rel_to_max={n: e[1] for n, e in errs.items()},
                    max_abs_err=max(e[0] for e in errs.values()),
                    keep=args[4] is not None, live_tiles=int(args[5].live.long().sum()),
                    ms=graph_ms(lambda: attn._attn_bwd_cuda(*args)),
                    events_ms=cuda_ms(lambda: attn._attn_bwd_cuda(*args)),
                    plain_ms=cuda_ms(lambda: attn.attn_bwd_plain(*args)),
                    bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms)

    k4_256 = [k4_row(bwd_args, "bfloat16"), k4_row(as_f32(bwd_args), "float32")]
    del bwd_args
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "ice_quadtree", "card": card, "dtype": "bfloat16", "remat": "full",
        "thresh": 0.15, "transform": "dist_from_05", "n_max": gcfg.n_max, "e_max": gcfg.e_max,
        "eb": gcfg.agg_eb, "sw": gcfg.agg_sw, "s_per_forecast": quad_forecast_s,
        "forecast_launches": {k: v for k, v in quad_fwd.items() if v},
        "mesh_builds": len(fills), "max_edges_per_tile": max(f[0] for f in fills),
        "max_source_spread": max(f[1] for f in fills), "max_nodes": max_nodes,
        "overflow": quad_worst, "train_steps": ICE_QUAD_TRAIN_STEPS, "seconds": quad_train_s,
        "steps_per_s": ICE_QUAD_TRAIN_STEPS / quad_train_s,
        "frames_per_s": ICE_QUAD_TRAIN_STEPS * ICE_T_OUT / quad_train_s,
        "losses": quad_losses, "launches_per_step": quad_train,
        "step_peak_above_start_gib": quad_peak, "k3_hd256": k3_256, "k4_hd256": k4_256,
    }), flush=True)
    run_dir.cleanup()
    return {"k5_per_gate": k5_rows, "k6_per_gate": k6_rows, "grid_per_gate_train": grid_train,
            "grid_per_gate_forecast": fwd_launches, "k3_hd256": k3_256, "k4_hd256": k4_256,
            "quadtree_forecast": quad_fwd, "quadtree_train": quad_train}


# ---------------------------------------------------------------- GCN, bf16 edge lists
# Phases 43-45: GCNConv, the JAX package's default conv (ModelConfig.
# convolution_type), on the main path's Â blocks (bench.py --conv GCNConv)
# and on the flagship's grid (the JAX package's experiment 1,
# cli/ice_exp.py:54-55, per-gate); then bench.py --workload ice-xla at its
# defaults (bf16, per-gate, remat full on the pixelwise edge list).
GCN_REMAT_MODES = ("none", "full")


def expected_gcn_launches(cfg, mode: str = "none", train: bool = True) -> dict:
    """Launches of one full-BPTT train step (``train`` False: one forecast)
    of the main path's model with GCNConv, read from the code. K1 and K7
    as ChebConv's (:func:`expected_launches`): the meshes and their sums do
    not depend on the conv. K2 once per GCN layer, where ChebConv takes K −
    1 = 2: the fused stack applies each stream's weights first and
    aggregates all 2·G streams in one Â·z, for every encoder cell step's
    conv layers, every decoder cell step (1 layer each) and each head conv
    (2). K2b once per K2: every Â·z input is a product with a weight, the
    first encoder step's too (ChebConv's takes the frame and the zero
    state, with no parameter). Remat "full" replays every K2 and every
    decoder step's remesh (K1, K7), as :func:`expected_remat_launches`
    reads it."""
    k2 = T_IN * cfg.n_layers * cfg.n_conv_layers + T_OUT * (cfg.n_layers + 2)
    if not train:
        return {"spmm_build_blocks": 1 + T_OUT, "spmm_apply": k2,
                "segment_sum": expected_quadtree_k7(cfg, 3)}
    want = {"spmm_build_blocks": 1 + T_OUT, "spmm_apply": k2, "spmm_apply_bwd": k2,
            "segment_sum": expected_quadtree_k7(cfg, 3, train=True)}
    if mode == "full":
        want["spmm_apply"] *= 2
        want["spmm_build_blocks"] += T_OUT
        want["segment_sum"] += T_OUT * (3 + 2 * cfg.n_layers)
    return want


def gcn_phases(seed: int, card: str, spmm, attn, grid_attn, segment, segment_sum,
               loader, x) -> dict:
    """Phases 43-45; returns what the kernels line adds: K2/K2b rows at
    GCN's widths (f32 and bf16) with the GCN path's launches, and K7's
    bf16 rows on the edge list's sets with the ice-xla path's launches."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
    from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax, params_to_jax

    run_dir = tempfile.TemporaryDirectory()
    modules = (spmm, attn, grid_attn, segment_sum)
    bf16 = torch.bfloat16

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def f32_launches():
        return {k: v for m in modules for k, v in m.LAUNCHES.items() if v}

    def nonzero(d):
        return {k: v for k, v in d.items() if v}

    def grads_of(trainer):
        return {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}

    def same_step(a, b):
        return (torch.equal(a["loss"], b["loss"]) and torch.equal(a["generator"], b["generator"])
                and all(torch.equal(a["grads"][n], g) for n, g in b["grads"].items()))

    # ---- phase 43: the main path with GCNConv, f32 and bf16, remat none/full
    out43 = {"forecast": {}, "k2": {}, "k2b": {}, "steps": {}}
    for dtype in ("float32", "bfloat16"):
        model = make_model(seed, run_dir.name, "GCNConv", dtype=dtype)
        cfg, gcfg = model.cfg, model.gcfg
        nt, sw, n_max = gcfg.agg_nt, gcfg.agg_sw, gcfg.n_max
        check(cfg.convolution_type == "GCNConv" and gcfg.aggregation == "pallas"
              and not gcfg.carry_edges and not gcfg.attn_windows,
              f"GCN main path configuration: {cfg}, {gcfg}")
        model.predict(loader)  # warm-up
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        y = model.predict(loader)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        launches, f32 = nonzero(launch_totals(modules)), f32_launches()
        want = expected_gcn_launches(cfg, train=False)
        check(y.shape == (BATCH, T_OUT, *CANVAS, 1) and bool(np.isfinite(y).all())
              and model.last_overflow == 0,
              f"GCN {dtype} forecast: {y.shape}, finite {bool(np.isfinite(y).all())}, "
              f"overflow {model.last_overflow}")
        check(launches == want, f"GCN {dtype} forecast launches {launches}, expected {want}")
        if dtype == "bfloat16":  # only the node counts (a sum of ones) stay f32
            check(f32 == {"segment_sum": 1 + T_OUT}, f"GCN bf16 forecast's f32 launches {f32}")
        # K2 at each width on the first decoder step's operands (2·G·d = 128
        # on the gate stacks, 16 and 1 on the head convs)
        with Capture(spmm, T_IN * cfg.n_layers * cfg.n_conv_layers, cfg.n_layers + 2) as cap:
            model.forecast(x)
        check(cap.calls == want["spmm_apply"], "GCN capture run disagrees with the forecast")
        k2 = [_spmm_width(spmm, a, cap.per_width[f], spmm._apply_cuda, n_max, nt, sw)
              for f, a in cap.operands().items()]
        check(128 in cap.per_width, f"GCN K2 widths {sorted(cap.per_width)}: no F 128")
        out43["forecast"][dtype] = dict(batch_s=batch_s, frames_per_s=BATCH * T_OUT / batch_s,
                                        launches=launches, f32_launches=f32)
        out43["k2"][dtype] = k2
        del model, cap

    _, batches = train_batches(seed, 2)
    x_b, y_b = batches[0]
    for dtype in ("float32", "bfloat16"):
        runs = {}
        for mode in GCN_REMAT_MODES:
            trainer = make_trainer(seed, run_dir.name, "GCNConv", teacher_forcing_ratio=0.5,
                                   dtype=dtype, remat=mode)
            check(trainer.model.remat == mode, f"remat {trainer.model.remat}, asked {mode}")
            gen = torch.Generator(device=DEVICE).manual_seed(1)
            step = {}
            reset()
            with CaptureBwd(spmm, "_apply_bwd_cuda") as cap_b, \
                    GradFnCheck(spmm, "spmm_apply", "SpmmApplyBackward") as gcheck:
                peak = peak_above_start_gib(
                    lambda: step.update(out=trainer.train_step(x_b, y_b, generator=gen)))
            launches, f32 = nonzero(launch_totals(modules)), f32_launches()
            want = expected_gcn_launches(cfg, mode)
            check(launches == want, f"GCN {dtype} remat {mode}: launches a step {launches}, "
                  f"expected {want}")
            check(not gcheck.bad and gcheck.calls == want["spmm_apply"],
                  f"GCN Â·z outputs without the K2b node: {gcheck.bad[:3]} ({gcheck.calls})")
            if dtype == "bfloat16":
                # the node counts of every mesh and of every replayed remesh
                counts = 1 + T_OUT + (T_OUT if mode == "full" else 0)
                check(f32 == {"segment_sum": counts}, f"GCN bf16 step's f32 launches {f32}")
            loss, overflow = step["out"]
            check(bool(torch.isfinite(loss)) and int(overflow) == 0,
                  f"GCN {dtype} remat {mode}: loss {float(loss)}, overflow {int(overflow)}")
            check(all(q.dtype == q.grad.dtype == torch.float32
                      for q in trainer.model.parameters()),
                  "a GCN master weight or gradient is not float32")
            runs[mode] = dict(loss=loss, generator=gen.get_state(), grads=grads_of(trainer),
                              launches=launches, f32_launches=f32, peak_gib=peak)
            t0 = time.perf_counter()
            float(trainer.train_step(*batches[1])[0])
            runs[mode]["step_s"] = time.perf_counter() - t0
            if mode == "none":
                out43["k2b"][dtype] = [
                    _spmm_width(spmm, a, cap_b.per_width[f], spmm._apply_bwd_cuda, n_max, nt, sw)
                    for f, a in sorted(cap_b.first.items())]
                check(sum(w["calls"] for w in out43["k2b"][dtype]) == want["spmm_apply_bwd"],
                      "GCN K2b capture disagrees with the code")
            del trainer, cap_b
        check(same_step(runs["full"], runs["none"]),
              f"GCN {dtype}: the remat full step is not bit-identical to remat none")
        out43["steps"][dtype] = {
            m: {"loss": float(r["loss"]), "step_s": r["step_s"],
                "step_peak_above_start_gib": r["peak_gib"], "launches_per_step": r["launches"],
                "f32_launches_per_step": r["f32_launches"]} for m, r in runs.items()}
        del runs
        torch.cuda.empty_cache()
    # a whole f32 step on the kernels against one on the plain versions,
    # teacher-forced (every decoder mesh from a true frame, so both run on
    # the same meshes); the kernel step again, bit-identical
    forced = lambda: make_trainer(seed, run_dir.name, "GCNConv",  # noqa: E731
                                  teacher_forcing_ratio=1.0)
    loss_k, _, grads_k, meshes_k = step_with_meshes(forced(), x_b, y_b, seed=1)
    with mock.patch.object(spmm, "_build_blocks_cuda", spmm.build_blocks_plain), \
            mock.patch.object(spmm, "_apply_cuda", spmm.apply_plain), \
            mock.patch.object(spmm, "_apply_bwd_cuda", spmm.apply_plain), \
            mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain):
        loss_p, _, grads_p, meshes_p = step_with_meshes(forced(), x_b, y_b, seed=1)
    check(torch.equal(meshes_k, meshes_p), "GCN kernel and plain steps ran on different meshes")
    grad_err = _leaf_err(grads_k, grads_p)
    check(grad_err <= GRAD_TOL, f"GCN gradients differ from the plain path by {grad_err}")
    loss_k2, _, grads_k2, meshes_k2 = step_with_meshes(forced(), x_b, y_b, seed=1)
    repeat = (torch.equal(loss_k, loss_k2) and torch.equal(meshes_k, meshes_k2)
              and all(torch.equal(grads_k[n], grads_k2[n]) for n in grads_k))
    check(repeat, "two identical GCN train steps differ")
    del grads_p, grads_k2
    print(json.dumps({
        "phase": "gcn_main_path", "card": card, "conv": "GCNConv", "batch": BATCH,
        "forecast": out43["forecast"], "train_steps": out43["steps"],
        "remat_full_vs_none_bit_identical": True,
        "k2_by_width": out43["k2"], "k2b_by_width": out43["k2b"],
        "grads_vs_plain": {"teacher_forcing_ratio": 1.0, "loss_kernel": float(loss_k),
                           "loss_plain": float(loss_p), "max_leaf_err_rel": grad_err,
                           "leaves": len(grads_k), "meshes_identical": True},
        "bit_identical_repeat": repeat,
    }), flush=True)
    del grads_k
    torch.cuda.empty_cache()

    # ---- phase 44: experiment 1 on the grid (GCN, per-gate, f32, remat full)
    data, clim, mask = ice_data(seed)
    windows = lambda i, j: ArrayDataset(data.x[i:j], data.y[i:j],  # noqa: E731
                                        data.launch_dates[i:j])
    x0, y0 = data.x[:1], data.y[:1]

    def ice_step(tr, batch, gen=None):
        x_i, y_i, c_i = batch
        return tr.train_step(x_i, y_i, mask=mask, climatology=c_i, generator=gen,
                             truncated_backprop=ICE_TBPTT)

    def exp1(**kw):
        return make_ice_model(seed, run_dir.name, conv="GCNConv", remat=True, **kw)

    model = exp1(fused_gates=False)
    cfg = model.cfg
    check(cfg.convolution_type == "GCNConv" and not cfg.fused_gates
          and model.model.remat == "full" and model.gcfg.aggregation == "grid",
          f"experiment 1 configuration: {cfg}, {model.gcfg}")
    batch0 = (x0, y0, model._clim_batch(clim, data.launch_dates[:1]))
    model.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    y = model.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)
    torch.cuda.synchronize()
    forecast_s = time.perf_counter() - t0
    grid_fwd = nonzero(launch_totals(modules))
    check(y.shape == (1, ICE_T_OUT, *ICE_SHAPE, 1) and bool(np.isfinite(y).all())
          and model.last_overflow == 0,
          f"experiment 1 forecast: {y.shape}, finite {bool(np.isfinite(y).all())}, "
          f"overflow {model.last_overflow}")
    # Â·z on the grid is grid_a_mul's shift stencil (plain on both devices,
    # as the JAX package's is XLA); the grid has no segment sum
    check(not grid_fwd, f"experiment 1 forecast launched {grid_fwd}")
    max_abs = float(np.abs(y).max())
    del model
    trainer = exp1(fused_gates=False)
    trainer.initiate_training(lr=LR, lr_decay=0.95)
    ice_step(trainer, batch0)  # warm-up
    batch1 = (data.x[1:2], data.y[1:2], trainer._clim_batch(clim, data.launch_dates[1:2]))
    torch.cuda.synchronize()
    reset()
    step = {}
    t0 = time.perf_counter()
    grid_peak = peak_above_start_gib(lambda: step.update(out=ice_step(trainer, batch1)))
    grid_step_s = time.perf_counter() - t0
    grid_train = nonzero(launch_totals(modules))
    check(bool(torch.isfinite(step["out"][0])) and int(step["out"][1]) == 0 and not grid_train
          and grid_peak > 0,
          f"experiment 1 step: loss {float(step['out'][0])}, overflow {int(step['out'][1])}, "
          f"launches {grid_train}, peak {grid_peak}")
    grid_loss = float(step["out"][0])
    del trainer, step
    torch.cuda.empty_cache()
    # the per-gate step against the fused model on the same weights,
    # stacked by fuse_gcn_gates, from the same generator
    per_gate, fused = exp1(fused_gates=False), exp1()
    fused.model.load_state_dict(params_from_jax(params_to_jax(per_gate.model.state_dict()),
                                                fuse_gates=True))
    steps = {}
    for name, tr in (("per_gate", per_gate), ("fused", fused)):
        tr.initiate_training(lr=LR, lr_decay=0.95)
        loss, _ = ice_step(tr, batch0, torch.Generator(device=DEVICE).manual_seed(1))
        steps[name] = (loss, _stacked_grads(tr.model) if name == "per_gate" else grads_of(tr))
    layout_err = _leaf_err(steps["per_gate"][1], steps["fused"][1])
    layout_same = (torch.equal(steps["per_gate"][0], steps["fused"][0])
                   and all(torch.equal(steps["per_gate"][1][n].to(DEVICE), g)
                           for n, g in steps["fused"][1].items()))
    check(layout_err <= GRAD_TOL,
          f"experiment 1: per-gate gradients differ from the fused model's by {layout_err}")
    del per_gate, fused, steps
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "gcn_grid_experiment_1", "card": card, "conv": "GCNConv", "mesh": "grid",
        "dtype": "float32", "fused_gates": False, "remat": "full", "t_out": ICE_T_OUT,
        "truncated_backprop": 0, "s_per_forecast": forecast_s, "forecast_launches": grid_fwd,
        "max_abs_value": max_abs, "step_s": grid_step_s, "loss": grid_loss, "overflow": 0,
        "step_peak_above_start_gib": grid_peak, "train_launches": grid_train,
        "per_gate_vs_fused": {"max_leaf_err_rel": layout_err, "bit_identical": layout_same},
    }), flush=True)

    # ---- phase 45: bench.py --workload ice-xla at its defaults
    p = ICE_SHAPE[0] * ICE_SHAPE[1]

    def ice_xla(**kw):
        return make_ice_model(seed, run_dir.name, aggregation="xla", fused_gates=False,
                              remat=True, **{"dtype": "bfloat16", **kw})

    model = ice_xla()
    cfg, gcfg = model.cfg, model.gcfg
    check(cfg.compute_dtype == "bfloat16" and not cfg.fused_gates and model.model.remat == "full"
          and gcfg.aggregation == "xla" and gcfg.pixelwise and gcfg.carry_edges
          and (gcfg.n_max, gcfg.e_max) == (p, 4 * p),
          f"ice-xla configuration: {cfg}, {gcfg}")
    clim0 = model._clim_batch(clim, data.launch_dates[:1])
    model.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)  # warm-up
    torch.cuda.synchronize()
    reset()
    got = {}
    t0 = time.perf_counter()
    edge_fwd_peak = peak_above_start_gib(lambda: got.update(
        y=model.predict(DataLoader(windows(0, 1)), climatology=clim, mask=mask)))
    edge_forecast_s = time.perf_counter() - t0
    edge_fwd, edge_fwd_f32 = nonzero(launch_totals(modules)), f32_launches()
    k7_fwd = expected_edge_launches(cfg, ICE_T_OUT)
    check(bool(np.isfinite(got["y"]).all()) and model.last_overflow == 0,
          f"ice-xla forecast: finite {bool(np.isfinite(got['y']).all())}, "
          f"overflow {model.last_overflow}")
    # K7 only; in bf16 but the node counts, a sum of f32 ones
    check(edge_fwd == {"segment_sum": k7_fwd} and edge_fwd_f32 == {"segment_sum": 1},
          f"ice-xla forecast launches {edge_fwd} (f32 {edge_fwd_f32}), expected K7 {k7_fwd}")
    # K7 in bf16 on the edge list's sets: a forecast's, a short step's
    with SegmentCapture(segment, p, keep=True, dtype=bf16) as cap:
        model.forecast(x0, mask=mask, climatology=clim0)
    del model, got
    short = ice_xla(t_out=ICE_SHORT_T_OUT)
    short.initiate_training(lr=LR, lr_decay=0.95)
    y_s, clim_s = y0[:, :ICE_SHORT_T_OUT], clim0[:, :ICE_SHORT_T_OUT]
    with SegmentCapture(segment, p, keep=True, dtype=bf16) as cap_t:
        ice_step(short, (x0, y_s, clim_s))
    del short
    sets = {**cap_t.ops, **cap.ops}  # the forecast's operands where it has the set
    k7_rows = [k7_measure(segment_sum, key, sets[key], cap_t.calls.get(key, 0), BF16_TOL)
               for key in sorted(sets)]
    check({"dst", "src", "pixel"} <= {w["ids"] for w in k7_rows}
          and {256, 32, 1} <= {w["F"] for w in k7_rows if w["ids"] == "dst"}
          and all(w["dtype"] == "bfloat16" for w in k7_rows),
          f"K7 bf16 operand sets {[(w['ids'], w['F'], w['dtype']) for w in k7_rows]}")
    del cap, cap_t, sets
    torch.cuda.empty_cache()
    # one full-BPTT step (T_out 90) at the defaults: launches, peak, time
    trainer = ice_xla()
    trainer.initiate_training(lr=LR, lr_decay=0.95)
    reset()
    step = {}
    t0 = time.perf_counter()
    edge_peak = peak_above_start_gib(lambda: step.update(out=ice_step(trainer, batch0)))
    edge_step_s = time.perf_counter() - t0
    edge_train, edge_train_f32 = nonzero(launch_totals(modules)), f32_launches()
    k7_train = expected_edge_launches(cfg, ICE_T_OUT, train=True) \
        + _attention_calls(cfg, ICE_T_OUT)  # the replays' aggregations
    check(bool(torch.isfinite(step["out"][0])) and int(step["out"][1]) == 0,
          f"ice-xla step: loss {float(step['out'][0])}, overflow {int(step['out'][1])}")
    check(edge_train == {"segment_sum": k7_train} and edge_train_f32 == {"segment_sum": 1},
          f"ice-xla step launches {edge_train} (f32 {edge_train_f32}), expected K7 {k7_train}")
    check(all(q.dtype == q.grad.dtype == torch.float32 for q in trainer.model.parameters()),
          "an ice-xla master weight or gradient is not float32")
    edge_loss = float(step["out"][0])
    t0 = time.perf_counter()
    float(ice_step(trainer, batch1)[0])
    edge_step2_s = time.perf_counter() - t0
    del trainer, step
    torch.cuda.empty_cache()
    # a bf16 step against an f32 step from the same weights and generator
    # (T_out 6), each on K7 and on its plain version. Gated by the plain
    # path's own bf16-vs-f32 spread, as phase 34 gates: the bf16 kernel step
    # no further from the bf16 plain step than that spread, and no further
    # from the f32 kernel step than twice it; the bf16 losses of the kernel
    # and the plain step within 1e-2 of each other
    short_batch = (x0, y_s, clim_s)

    def short_step(dtype, plain):
        tr = ice_xla(t_out=ICE_SHORT_T_OUT, dtype=dtype)
        tr.initiate_training(lr=LR, lr_decay=0.95)
        ctx = (mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain) if plain
               else contextlib.nullcontext())
        with ctx:
            loss, _ = ice_step(tr, short_batch, torch.Generator(device=DEVICE).manual_seed(1))
        return float(loss), grads_of(tr)

    pair = {(d, plain): short_step(d, plain) for d in ("bfloat16", "float32")
            for plain in (False, True)}
    spread = {"kernel_vs_plain_bf16": _leaf_err(pair["bfloat16", False][1],
                                                pair["bfloat16", True][1]),
              "plain_bf16_vs_f32": _leaf_err(pair["bfloat16", True][1],
                                             pair["float32", True][1]),
              "kernel_bf16_vs_f32": _leaf_err(pair["bfloat16", False][1],
                                              pair["float32", False][1]),
              "kernel_vs_plain_f32": _leaf_err(pair["float32", False][1],
                                               pair["float32", True][1])}
    losses = {f"{d}_{'plain' if plain else 'kernel'}": v[0] for (d, plain), v in pair.items()}
    del pair
    check(spread["kernel_vs_plain_bf16"] <= spread["plain_bf16_vs_f32"]
          and spread["kernel_bf16_vs_f32"] <= 2 * spread["plain_bf16_vs_f32"]
          and abs(losses["bfloat16_kernel"] - losses["bfloat16_plain"])
          <= 1e-2 * abs(losses["bfloat16_plain"]),
          f"ice-xla bf16 step against f32: {spread}, losses {losses}")
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "ice_xla_defaults", "card": card, "mesh": "edge_list", "dtype": "bfloat16",
        "fused_gates": False, "remat": "full", "t_out": ICE_T_OUT, "truncated_backprop": 0,
        "n_max": gcfg.n_max, "e_max": gcfg.e_max, "s_per_forecast": edge_forecast_s,
        "forecast_peak_above_start_gib": edge_fwd_peak, "forecast_launches": edge_fwd,
        "forecast_f32_launches": edge_fwd_f32, "loss": edge_loss, "overflow": 0,
        "step_s": [edge_step_s, edge_step2_s], "step_peak_above_start_gib": edge_peak,
        "launches_per_step": edge_train, "f32_launches_per_step": edge_train_f32,
        "k7_bf16_by_set": k7_rows, "bf16_vs_f32": {"t_out": ICE_SHORT_T_OUT,
                                                   "max_leaf_err_rel": spread,
                                                   "losses": losses},
    }), flush=True)
    run_dir.cleanup()
    return {"gcn_forecast": out43["forecast"], "gcn_steps": out43["steps"],
            "k2_gcn": out43["k2"], "k2b_gcn": out43["k2b"], "k7_edge_bf16": k7_rows,
            "edge_bf16_forecast": edge_fwd, "edge_bf16_train": edge_train}


def add_gcn_paths(entries, gcn: dict, dtype: str) -> None:
    """Adds the GCN main path (phase 43) to the kernels line's K1, K2, K2b
    and K7 entries of ``dtype``: its launches a forecast batch and a train
    step (remat none; bf16 entries count their bf16 launches, which are
    all but K7's node counts), and K2's and K2b's rows at GCN's widths
    (``gcn_by_width``)."""
    forecast = gcn["gcn_forecast"][dtype]
    step = gcn["gcn_steps"][dtype]["none"]
    rows = {"spmm_apply": gcn["k2_gcn"][dtype], "spmm_apply_bwd": gcn["k2b_gcn"][dtype]}
    for entry in entries:
        name = entry["name"].removesuffix("_bf16")
        if name not in ("spmm_build_blocks", "spmm_apply", "spmm_apply_bwd", "segment_sum"):
            continue
        for path, counts, f32 in (("gcn_predict_batch", forecast["launches"],
                                   forecast["f32_launches"]),
                                  ("gcn_train_step", step["launches_per_step"],
                                   step["f32_launches_per_step"])):
            n = counts.get(name, 0)
            entry["launches_by_path"][path] = n - f32.get(name, 0) if dtype == "bfloat16" else n
        if name in rows:
            entry["gcn_by_width"] = rows[name]


# ---------------------------------------------------------------- Queue 1 item 7
# Phases 46-49: the convs and cells the port runs since ROADMAP Queue 1 item
# 7, on bench.py's model (--conv MHTransformerConv, GATConv, GATv2Conv; the
# GRU, shared-conv, split and dummy cells with ChebConv), then
# MHTransformerConv at the sea-ice widths (bench.py --workload ice --conv
# MHTransformerConv), where K3/K4 and K5/K6 take HD/H 768 in one launch.
MH_REMAT_MODES = ("none", "full")
CELL_VARIANTS = {"GRU": dict(rnn_type="GRU"),
                 "GRU-per_gate": dict(rnn_type="GRU", fused_gates=False),
                 "SimpleLSTM": dict(rnn_type="SimpleLSTM"),
                 "SplitLSTM": dict(rnn_type="SplitLSTM"),
                 "dummy": dict(dummy=True)}
GRU_LAYOUT_TOL = 1e-6  # per-gate GRU against the fused GRU, × max(1, max|g|)


def make_variant(seed: int, run_dir: str, teacher_forcing_ratio: float = 0.0,
                 dtype: str = "float32", remat=False, train: bool = True, **model):
    """``bench.py``'s model with ``model`` overriding its model kwargs
    (``rnn_type``, ``fused_gates``, ``dummy``), ready to train (Adam at lr
    0.01) unless ``train`` is False."""
    from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

    predictor = NextFramePredictorS2S(
        image_shape=CANVAS, thresh=0.1,
        input_features=1, input_timesteps=T_IN, output_timesteps=T_OUT,
        device=DEVICE, seed=seed, run_dir=run_dir,
        teacher_forcing_ratio=teacher_forcing_ratio,
        model_kwargs=dict(dict(hidden_size=16, n_layers=2, n_conv_layers=2,
                               convolution_type="ChebConv", compute_dtype=dtype, remat=remat),
                          **model),
        graph_kwargs=dict(max_grid_size=8, n_max=2048, e_max=10240, node_budget=2048,
                          agg_eb=1024, agg_sw=1024, aggregation="pallas"),
    )
    if train:
        predictor.initiate_training(lr=LR, lr_decay=0.95)
    return predictor


def expected_gat_launches(cfg, train: bool) -> dict:
    """Launches of one GAT forecast (or full-BPTT train step, remat none),
    read from the code. The quadtree keeps its edge list beside its Â
    blocks (GAT is not among the predictor's convs that drop it): K1 once a
    mesh, no K2, and K7 as ChebConv's (:func:`expected_quadtree_k7`: node
    counts, pooling and degrees a mesh, the state carried across each
    remesh). Every GAT pass (one per conv layer of every encoder cell step,
    the 2·G gate streams of both sides as its heads; one per decoder cell
    step and head conv) sums Σ α·x[src] over the mesh's self-loop list
    once; a train step's backward adds K7 for each of the pass's three
    gathers (GATConv: x·att_src at the sources, x·att_dst at the
    destinations, x at the sources; GATv2Conv: x_l and x_r for the logits,
    x_l for the messages)."""
    passes = expected_attn_launches(cfg)
    k7 = expected_quadtree_k7(cfg, 3, train) + passes * (4 if train else 1)
    return {"spmm_build_blocks": 1 + T_OUT, "segment_sum": k7}


def _cell_conv_calls(cfg, n_conv_layers: int) -> int:
    """Â·z of one cell call on ChebConv (K = 3: two a conv layer): a fused
    LSTM stack 2 a layer; a GRU's two stacks (or its per-gate streams and
    ``conv_h_candidate``) and the shared-conv LSTM's two ``GraphConv``
    stacks 4; the split LSTM's one ``GraphConv`` 2; a dummy model none."""
    per_layer = {"LSTM": 2, "GRU": 4, "SimpleLSTM": 4, "SplitLSTM": 2}[cfg.rnn_type]
    return 0 if cfg.dummy else per_layer * n_conv_layers


def expected_cell_launches(cfg, train: bool, mode: str = "none") -> dict:
    """Launches of one forecast (or full-BPTT train step without teacher
    forcing) of ``bench.py``'s ChebConv model with the cell of ``cfg``,
    read from the code. K1 once a mesh; K2 per cell call
    (:func:`_cell_conv_calls`) of every encoder and decoder step and 2 per
    head conv; K2b for every K2 whose input needs a gradient, which is all
    but those on the data and on the zero state: the first conv layer of
    encoder layer 0 at step 0 ([x ‖ h] of the frame and the zero state) for
    the fused and per-gate stacks; for the shared-conv LSTM, ``conv_x`` on
    every input frame, ``conv_h`` on the zero state (layer 0 at step 0, and
    every upper layer at every encoder step) and ``conv_x`` on the first
    decoder input; for the split LSTM its conv on every input frame and on
    the first decoder input; for the dummy model the first head conv on
    the first decoder input and its concat. K7 as
    :func:`expected_quadtree_k7` reads it, less the backward gathers of
    state that never needs a gradient (a GRU's C, which passes through; a
    dummy model's H and C; the shared-conv LSTM's top-layer C carried into
    the last decoder step, which reaches no loss, its output gate reading
    no C). Remat "full" replays every K2 and every decoder step's remesh
    (K1, and K7 for its counts, pooling, degrees and the state that needs
    a gradient: the replay stops after the last value the backward saves,
    and a GRU's C, carried last, saves none)."""
    L, C = cfg.n_layers, cfg.n_conv_layers
    k2 = T_IN * L * _cell_conv_calls(cfg, C) + T_OUT * (L * _cell_conv_calls(cfg, 1) + 4)
    if not train:
        return {"spmm_build_blocks": 1 + T_OUT, "spmm_apply": k2,
                "segment_sum": expected_quadtree_k7(cfg, 3)}
    no_grad = {"LSTM": 2, "GRU": 2, "SimpleLSTM": 2 * T_IN * L + 4,
               "SplitLSTM": 2 * T_IN + 2}[cfg.rnn_type]
    stateless = {"GRU": L, "LSTM": 0}.get(cfg.rnn_type, 0)
    if cfg.dummy:
        no_grad, stateless = 2, 2 * L
    dead = 1 if cfg.rnn_type == "SimpleLSTM" and not cfg.dummy else 0
    want = {"spmm_build_blocks": 1 + T_OUT, "spmm_apply": k2, "spmm_apply_bwd": k2 - no_grad,
            "segment_sum": expected_quadtree_k7(cfg, 3, train=True) - (T_OUT - 1) * stateless
            - dead}
    if mode == "full":
        want["spmm_apply"] *= 2
        want["spmm_build_blocks"] += T_OUT
        want["segment_sum"] += T_OUT * (3 + 2 * L - stateless)
    return want


def expected_ice_mh_launches(cfg, train: bool) -> dict:
    """K5 (and K6) launches of one flagship forecast (or full-BPTT step
    under remat full) with MHTransformerConv, read from the code: one a
    cell's attention call (2·G streams × 3 heads × d 32 = 768 features, in
    one launch) and one a head conv (3 × 32 and 3 × 1); a train step
    replays every forward call and runs K6 once a forward call."""
    cells = ICE_T_IN * cfg.n_layers * cfg.n_conv_layers + cfg.output_timesteps * cfg.n_layers
    k5 = cells + 2 * cfg.output_timesteps
    if not train:
        return {"grid_attn_apply": k5}
    return {"grid_attn_apply": 2 * k5, "grid_attn_apply_bwd": k5}


def item7_phases(seed: int, card: str, spmm, attn, grid_attn, segment, segment_sum,
                 loader, x) -> dict:
    """Phases 46-49; returns what the kernels line adds: K3/K4 rows at the
    MH widths and at HD 768, K5/K6 rows at H 768 (each one launch), K7 rows on GAT's self-loop sets, and each new path's
    launches."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
    from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax, params_to_jax

    run_dir = tempfile.TemporaryDirectory()
    modules = (spmm, attn, grid_attn, segment_sum)
    bf16 = torch.bfloat16
    out = {}

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def nonzero(d):
        return {k: v for k, v in d.items() if v}

    def f32_launches():
        return nonzero({k: v for m in modules for k, v in m.LAUNCHES.items()})

    def grads_of(trainer):
        return {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}

    def same_step(a, b):
        return (torch.equal(a["loss"], b["loss"]) and torch.equal(a["generator"], b["generator"])
                and all(torch.equal(a["grads"][n], g) for n, g in b["grads"].items()))

    def timed_forecast(model):
        """(seconds, launches, f32 launches, frames) of one timed predict()
        after a warm-up."""
        model.predict(loader)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        y = model.predict(loader)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, nonzero(launch_totals(modules)), f32_launches(), y

    def check_forecast(name, model, y):
        check(y.shape == (BATCH, T_OUT, *CANVAS, 1) and bool(np.isfinite(y).all())
              and model.last_overflow == 0,
              f"{name} forecast: {y.shape}, finite {bool(np.isfinite(y).all())}, "
              f"overflow {model.last_overflow}")

    def one_step(trainer, batch, gen_seed=1):
        """A train step from a generator of ``gen_seed``: its loss,
        overflow, gradients, the generator's state after it, launches and
        peak above its start."""
        gen = torch.Generator(device=DEVICE).manual_seed(gen_seed)
        got = {}
        reset()
        peak = peak_above_start_gib(
            lambda: got.update(out=trainer.train_step(*batch, generator=gen)))
        loss, overflow = got["out"]
        check(bool(torch.isfinite(loss)) and int(overflow) == 0,
              f"train step: loss {float(loss)}, overflow {int(overflow)}")
        check(all(q.dtype == q.grad.dtype == torch.float32 for q in trainer.model.parameters()),
              "a master weight or gradient is not float32")
        return dict(loss=loss, grads=grads_of(trainer), generator=gen.get_state(),
                    launches=nonzero(launch_totals(modules)), f32_launches=f32_launches(),
                    peak_gib=peak)

    def step_time(trainer, batch):
        t0 = time.perf_counter()
        float(trainer.train_step(*batch)[0])
        return time.perf_counter() - t0

    def vs_plain(factory, patches):
        """A teacher-forced f32 step (every decoder mesh from a true frame)
        on the kernels and one with ``patches`` (launcher, plain version)
        swapped in, from the same weights and generator; the kernel step
        again. Returns (max leaf error relative to max(1, max|g|), the
        losses, bit-identical repeat)."""
        loss_k, _, grads_k, meshes_k = step_with_meshes(factory(), x_b, y_b, seed=1)
        with contextlib.ExitStack() as stack:
            for module, name, plain in patches:
                stack.enter_context(mock.patch.object(module, name, plain))
            loss_p, _, grads_p, meshes_p = step_with_meshes(factory(), x_b, y_b, seed=1)
        check(torch.equal(meshes_k, meshes_p), "kernel and plain steps ran on different meshes")
        err = _leaf_err(grads_k, grads_p)
        check(err <= GRAD_TOL, f"gradients differ from the plain path's by {err}")
        loss_k2, _, grads_k2, meshes_k2 = step_with_meshes(factory(), x_b, y_b, seed=1)
        repeat = (torch.equal(loss_k, loss_k2) and torch.equal(meshes_k, meshes_k2)
                  and all(torch.equal(grads_k[n], grads_k2[n]) for n in grads_k))
        check(repeat, "two identical train steps differ")
        return err, (float(loss_k), float(loss_p)), repeat

    plain_attn = [(attn, "_attn_fwd_cuda", attn.attn_plain),
                  (attn, "_attn_bwd_cuda", attn.attn_bwd_plain),
                  (segment_sum, "_segment_sum_cuda", k7_plain)]
    plain_blocks = [(spmm, "_build_blocks_cuda", spmm.build_blocks_plain),
                    (spmm, "_apply_cuda", spmm.apply_plain),
                    (spmm, "_apply_bwd_cuda", spmm.apply_plain),
                    (segment_sum, "_segment_sum_cuda", k7_plain)]
    _, batches = train_batches(seed, 2)
    x_b, y_b = batches[0]
    p = CANVAS[0] * CANVAS[1]

    # ---- phase 46: MHTransformerConv on attention windows
    conv = "MHTransformerConv"
    mh = {"forecast": {}, "steps": {}, "k3": {}, "k4": {}}
    for dtype in ("float32", "bfloat16"):
        model = make_model(seed, run_dir.name, conv, dtype=dtype)
        cfg, gcfg = model.cfg, model.gcfg
        check(gcfg.attn_windows and not gcfg.carry_edges,
              f"the MH predictor did not ride the attention windows: {gcfg}")
        k3 = expected_attn_launches(cfg)
        batch_s, launches, f32, y = timed_forecast(model)
        check_forecast(f"MH {dtype}", model, y)
        k7 = expected_quadtree_k7(cfg, 2)
        check(launches == {"attn_apply": k3, "segment_sum": k7},
              f"MH {dtype} forecast launches {launches}, expected K3 {k3}, K7 {k7}")
        if dtype == "bfloat16":
            check(f32 == {"segment_sum": 1 + T_OUT}, f"MH bf16 forecast's f32 launches {f32}")
        with AttnCapture(attn, "_attn_fwd_cuda", T_IN * cfg.n_layers * cfg.n_conv_layers,
                         cfg.n_layers + 2) as cap:
            model.forecast(x)
        check(sorted(cap.per_width) == [3, 48, 384], f"MH K3 widths {sorted(cap.per_width)}")
        rows = []
        for hd, args in cap.operands().items():
            with torch.no_grad():
                kern, plain = attn._attn_fwd_cuda(*args), attn.attn_plain(*args)
                check(torch.equal(kern, attn._attn_fwd_cuda(*args)),
                      f"MH K3 differs from itself on a repeat at HD {hd}")
            if dtype == "bfloat16":
                err = _bf16_err(kern, plain, f"MH K3 at HD {hd}")[0]
            else:
                err = float((kern - plain).abs().max())
                check(err <= K3_TOL, f"MH K3 differs from attn_plain at HD {hd}: {err}")
            bound, b_ms, o_ms = attn_bound_ms(attn, args, backward=False)
            rows.append(dict(HD=hd, heads=args[6].heads, d=args[6].d, dtype=dtype,
                             calls=cap.per_width[hd], max_abs_err=err, repeat_identical=True,
                             ms=graph_ms(lambda: attn._attn_fwd_cuda(*args)),
                             events_ms=cuda_ms(lambda: attn._attn_fwd_cuda(*args)),
                             plain_ms=cuda_ms(lambda: attn.attn_plain(*args)),
                             bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
        mh["forecast"][dtype] = dict(batch_s=batch_s, frames_per_s=BATCH * T_OUT / batch_s,
                                     launches=launches, f32_launches=f32)
        mh["k3"][dtype] = rows
        del model, cap
        runs = {}
        for mode in MH_REMAT_MODES:
            trainer = make_trainer(seed, run_dir.name, conv, teacher_forcing_ratio=0.5,
                                   dtype=dtype, remat=mode)
            if mode == "none":
                with CaptureBwd(attn, "_attn_bwd_cuda") as cap_b:
                    runs[mode] = one_step(trainer, (x_b, y_b))
            else:
                runs[mode] = one_step(trainer, (x_b, y_b))
            k7 = expected_quadtree_k7(cfg, 2, train=True)
            want = {"attn_apply": k3, "attn_apply_bwd": k3, "segment_sum": k7}
            if mode == "full":
                want["attn_apply"] *= 2
                want["segment_sum"] += T_OUT * (2 + 2 * cfg.n_layers)
            check(runs[mode]["launches"] == want, f"MH {dtype} remat {mode}: launches a step "
                  f"{runs[mode]['launches']}, expected {want}")
            runs[mode]["step_s"] = step_time(trainer, batches[1])
            del trainer
        check(same_step(runs["full"], runs["none"]),
              f"MH {dtype}: the remat full step is not bit-identical to remat none")
        rows = []
        for hd, args in sorted(cap_b.first.items()):
            kern, plain = attn._attn_bwd_cuda(*args), attn.attn_bwd_plain(*args)
            if dtype == "bfloat16":
                errs = {n: _bf16_err(a, b, f"MH K4 {n} at HD {hd}")
                        for n, a, b in zip(("dq", "dk", "dv", "dwe"), kern, plain)}
            else:
                errs = {}
                for n, a, b in zip(("dq", "dk", "dv", "dwe"), kern, plain):
                    e = float((a - b).abs().max())
                    errs[n] = (e, e / max(1.0, float(b.abs().max())))
                check(max(e[1] for e in errs.values()) <= K4_TOL,
                      f"MH K4 differs from its plain backward at HD {hd}: {errs}")
            bound, b_ms, o_ms = attn_bound_ms(attn, args, backward=True)
            rows.append(dict(HD=hd, dtype=dtype, calls=cap_b.per_width[hd],
                             err_rel_to_max={n: e[1] for n, e in errs.items()},
                             max_abs_err=max(e[0] for e in errs.values()),
                             keep=args[4] is not None,
                             ms=graph_ms(lambda: attn._attn_bwd_cuda(*args)),
                             events_ms=cuda_ms(lambda: attn._attn_bwd_cuda(*args)),
                             plain_ms=cuda_ms(lambda: attn.attn_bwd_plain(*args)),
                             bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
        check(sorted(r["HD"] for r in rows) == [3, 48, 384], f"MH K4 widths {rows}")
        mh["k4"][dtype] = rows
        mh["steps"][dtype] = {
            m: {"loss": float(r["loss"]), "step_s": r["step_s"],
                "step_peak_above_start_gib": r["peak_gib"], "launches_per_step": r["launches"],
                "f32_launches_per_step": r["f32_launches"]} for m, r in runs.items()}
        del runs, cap_b
        torch.cuda.empty_cache()
    mh_err, mh_losses, mh_repeat = vs_plain(
        lambda: make_trainer(seed, run_dir.name, conv, teacher_forcing_ratio=1.0), plain_attn)
    print(json.dumps({
        "phase": "mh_windows", "card": card, "conv": conv, "batch": BATCH,
        "forecast": mh["forecast"], "train_steps": mh["steps"],
        "remat_full_vs_none_bit_identical": True, "k3_by_width": mh["k3"],
        "k4_by_width": mh["k4"],
        "grads_vs_plain": {"teacher_forcing_ratio": 1.0, "max_leaf_err_rel": mh_err,
                           "losses_kernel_plain": mh_losses, "meshes_identical": True},
        "bit_identical_repeat": mh_repeat,
    }), flush=True)
    out["mh"] = mh
    torch.cuda.empty_cache()

    # ---- phase 47: GATConv and GATv2Conv on the quadtree's edge list
    gat = {"forecast": {}, "steps": {}, "k7": []}
    for conv in ("GATConv", "GATv2Conv"):
        for dtype in ("float32", "bfloat16"):
            model = make_model(seed, run_dir.name, conv, dtype=dtype)
            cfg, gcfg = model.cfg, model.gcfg
            check(gcfg.carry_edges and not gcfg.attn_windows and gcfg.aggregation == "pallas"
                  and gcfg.use_edge_attrs == (conv == "GATConv"),
                  f"{conv} configuration: {cfg}, {gcfg}")
            batch_s, launches, f32, y = timed_forecast(model)
            check_forecast(f"{conv} {dtype}", model, y)
            want = expected_gat_launches(cfg, train=False)
            check(launches == want, f"{conv} {dtype} forecast launches {launches}, "
                  f"expected {want}")
            if dtype == "bfloat16":  # the node counts (a sum of f32 ones) stay f32
                check(f32 == {"segment_sum": 1 + T_OUT},
                      f"{conv} bf16 forecast's f32 launches {f32}")
            loops = gcfg.e_max + gcfg.n_max
            with SegmentCapture(segment, p, keep=True, counts=True, loops=gcfg.e_max) as cap:
                model.forecast(x)
            passes = {k: v for k, v in cap.calls.items() if k[0].startswith("loops")}
            check(sum(passes.values()) == expected_attn_launches(cfg)
                  and all(k[0] == "loops_dst" for k in passes),
                  f"{conv} {dtype}: self-loop sums {passes}, expected one a GAT pass "
                  f"({expected_attn_launches(cfg)})")
            gat["forecast"][f"{conv}-{dtype}"] = dict(
                batch_s=batch_s, frames_per_s=BATCH * T_OUT / batch_s, launches=launches,
                f32_launches=f32)
            del model
            trainer = make_trainer(seed, run_dir.name, conv, dtype=dtype)
            with SegmentCapture(segment, p, keep=True, counts=True, loops=gcfg.e_max) as cap_t:
                step = one_step(trainer, (x_b, y_b))
            want = expected_gat_launches(cfg, train=True)
            check(step["launches"] == want,
                  f"{conv} {dtype} step launches {step['launches']}, expected {want}")
            step["step_s"] = step_time(trainer, batches[1])
            del trainer
            again = one_step(make_trainer(seed, run_dir.name, conv, dtype=dtype), (x_b, y_b))
            check(same_step(step, again), f"{conv} {dtype}: two identical train steps differ")
            sets = {**cap_t.ops, **cap.ops}
            for key in sorted(k for k in sets if k[0].startswith("loops")):
                check(sets[key][1].shape[1] == loops, f"{conv} self-loop set {key}")
                row = k7_measure(segment_sum, key, sets[key], cap_t.calls.get(key, 0),
                                 K7_TOL if dtype == "float32" else BF16_TOL)
                gat["k7"].append(dict(row, conv=conv))
            gat["steps"][f"{conv}-{dtype}"] = {
                "loss": float(step["loss"]), "step_s": step["step_s"],
                "step_peak_above_start_gib": step["peak_gib"],
                "launches_per_step": step["launches"],
                "f32_launches_per_step": step["f32_launches"], "bit_identical_repeat": True}
            del cap, cap_t, sets, step, again
            torch.cuda.empty_cache()
        gat[f"{conv}_grads_vs_plain"] = vs_plain(
            lambda: make_trainer(seed, run_dir.name, conv, teacher_forcing_ratio=1.0),
            plain_blocks)
    check({(r["ids"], r["dtype"]) for r in gat["k7"]}
          >= {("loops_dst", "float32"), ("loops_src", "float32"), ("loops_dst", "bfloat16")},
          f"K7 self-loop sets {[(r['ids'], r['F'], r['dtype']) for r in gat['k7']]}")
    print(json.dumps({
        "phase": "gat_edge_list", "card": card, "batch": BATCH, "forecast": gat["forecast"],
        "train_steps": gat["steps"], "k7_by_self_loop_set": gat["k7"],
        "grads_vs_plain": {c: {"max_leaf_err_rel": gat[f"{c}_grads_vs_plain"][0],
                               "losses_kernel_plain": gat[f"{c}_grads_vs_plain"][1],
                               "bit_identical_repeat": gat[f"{c}_grads_vs_plain"][2]}
                           for c in ("GATConv", "GATv2Conv")},
    }), flush=True)
    out["gat"] = gat
    torch.cuda.empty_cache()

    # ---- phase 48: the GRU, shared-conv, split and dummy cells (ChebConv)
    cells = {"forecast": {}, "steps": {}}
    for name, variant in CELL_VARIANTS.items():
        model = make_variant(seed, run_dir.name, train=False, **variant)
        cfg = model.cfg
        batch_s, launches, _, y = timed_forecast(model)
        check_forecast(name, model, y)
        want = expected_cell_launches(cfg, train=False)
        check(launches == nonzero(want), f"{name} forecast launches {launches}, expected {want}")
        cells["forecast"][name] = dict(batch_s=batch_s, frames_per_s=BATCH * T_OUT / batch_s,
                                       launches=launches)
        del model
        step = one_step(make_variant(seed, run_dir.name, **variant), (x_b, y_b))
        want = expected_cell_launches(cfg, train=True)
        check(step["launches"] == nonzero(want),
              f"{name} step launches {step['launches']}, expected {want}")
        trainer = make_variant(seed, run_dir.name, **variant)
        again = one_step(trainer, (x_b, y_b))
        repeat = same_step(step, again)
        check(repeat, f"{name}: two identical train steps differ")
        cells["steps"][name] = {"loss": float(step["loss"]), "step_s": step_time(trainer,
                                                                                  batches[1]),
                                "step_peak_above_start_gib": step["peak_gib"],
                                "launches_per_step": step["launches"],
                                "bit_identical_repeat": repeat}
        del step, again, trainer
        torch.cuda.empty_cache()
    # the GRU in bf16 under remat full (bench.py's defaults), against remat none
    gru = {}
    for mode in MH_REMAT_MODES:
        trainer = make_variant(seed, run_dir.name, teacher_forcing_ratio=0.5, dtype="bfloat16",
                               remat=mode, rnn_type="GRU")
        gru[mode] = one_step(trainer, (x_b, y_b))
        want = expected_cell_launches(trainer.cfg, train=True, mode=mode)
        got = {k: gru[mode]["launches"].get(k, 0) for k in want}
        check(got == want, f"GRU bf16 remat {mode}: launches a step {got}, expected {want}")
        # the node counts of every mesh and of every replayed remesh stay f32
        counts = 1 + T_OUT + (T_OUT if mode == "full" else 0)
        check(gru[mode]["f32_launches"] == {"segment_sum": counts},
              f"GRU bf16 remat {mode}: f32 launches {gru[mode]['f32_launches']}")
        gru[mode]["step_s"] = step_time(trainer, batches[1])
        del trainer
    check(same_step(gru["full"], gru["none"]), "GRU bf16: remat full differs from remat none")
    model = make_variant(seed, run_dir.name, dtype="bfloat16", remat="full", train=False,
                         rnn_type="GRU")
    batch_s, launches, f32, y = timed_forecast(model)
    check_forecast("GRU bf16", model, y)
    cells["gru_bf16"] = {
        "forecast": dict(batch_s=batch_s, frames_per_s=BATCH * T_OUT / batch_s,
                         launches=launches, f32_launches=f32),
        "steps": {m: {"loss": float(r["loss"]), "step_s": r["step_s"],
                      "step_peak_above_start_gib": r["peak_gib"],
                      "launches_per_step": r["launches"],
                      "f32_launches_per_step": r["f32_launches"]} for m, r in gru.items()},
        "remat_full_vs_none_bit_identical": True}
    del model, gru
    # per-gate GRU gradients against the fused GRU's, the per-gate weights
    # stacked into the fused layout (fuse_cell_gates)
    per_gate = make_variant(seed, run_dir.name, teacher_forcing_ratio=1.0, train=False,
                            rnn_type="GRU", fused_gates=False)
    fused = make_variant(seed, run_dir.name, teacher_forcing_ratio=1.0, train=False,
                         rnn_type="GRU")
    fused.model.load_state_dict(params_from_jax(params_to_jax(per_gate.model.state_dict()),
                                                fuse_gates=True))
    steps = {}
    for name, tr in (("per_gate", per_gate), ("fused", fused)):
        tr.initiate_training(lr=LR, lr_decay=0.95)
        loss, _ = tr.train_step(x_b, y_b, generator=torch.Generator(device=DEVICE).manual_seed(1))
        steps[name] = (loss, _stacked_grads(tr.model) if name == "per_gate" else grads_of(tr))
    layout_err = _leaf_err(steps["per_gate"][1], steps["fused"][1])
    check(layout_err <= GRU_LAYOUT_TOL,
          f"per-gate GRU gradients differ from the fused GRU's by {layout_err}")
    cells["gru_per_gate_vs_fused"] = {
        "max_leaf_err_rel": layout_err,
        "losses": [float(steps["per_gate"][0]), float(steps["fused"][0])],
        "bit_identical": all(torch.equal(steps["per_gate"][1][n].to(DEVICE), g)
                             for n, g in steps["fused"][1].items())}
    del per_gate, fused, steps
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "cells", "card": card, "conv": "ChebConv", "batch": BATCH,
                      **cells}), flush=True)
    out["cells"] = cells

    # ---- phase 49: MHTransformerConv at the sea-ice widths
    data, clim, mask = ice_data(seed)
    x0, y0 = data.x[:1], data.y[:1]

    def ice_mh(**kw):
        return make_ice_model(seed, run_dir.name, dtype="bfloat16", remat=True,
                              fused_gates=False, conv="MHTransformerConv", **kw)

    model = ice_mh()
    cfg = model.cfg
    check(not cfg.fused_gates and model.model.remat == "full"
          and model.gcfg.aggregation == "grid", f"ice MH configuration: {cfg}, {model.gcfg}")
    clim0 = model._clim_batch(clim, data.launch_dates[:1])
    loader0 = DataLoader(ArrayDataset(data.x[:1], data.y[:1], data.launch_dates[:1]))
    model.predict(loader0, climatology=clim, mask=mask)  # warm-up
    torch.cuda.synchronize()
    reset()
    got = {}
    t0 = time.perf_counter()
    fwd_peak = peak_above_start_gib(lambda: got.update(
        y=model.predict(loader0, climatology=clim, mask=mask)))
    forecast_s = time.perf_counter() - t0
    fwd = nonzero(launch_totals(modules))
    check(bool(np.isfinite(got["y"]).all()) and model.last_overflow == 0,
          f"ice MH forecast: finite {bool(np.isfinite(got['y']).all())}")
    want = expected_ice_mh_launches(cfg, train=False)
    check(fwd == want, f"ice MH forecast launches {fwd}, expected {want}")
    with FirstAtWidth(grid_attn, "_grid_attn_fwd_cuda", 768) as cap:
        model.forecast(x0, mask=mask, climatology=clim0)
    wide = cap.args
    del cap, model, got
    k5_rows = []
    for dtype, args in (("bfloat16", wide), ("float32", tuple(
            a.float() if torch.is_tensor(a) and a.dtype == bf16 else a for a in wide))):
        reset()
        with torch.no_grad():
            kern = grid_attn._grid_attn_fwd_cuda(*args)
        launched = launch_totals(modules)["grid_attn_apply"]
        check(launched == 1, f"K5 at H 768 ({dtype}) launched {launched}, not once")
        plain = grid_attn.grid_attn_plain(*args)
        check(torch.equal(kern, plain), f"K5 at H 768 ({dtype}) is not bit-identical "
              "to its plain version")
        bound, b_ms, o_ms = grid_bound_ms(args, backward=False)
        k5_rows.append(dict(
            H=768, dtype=dtype, keep=args[5] is not None, max_abs_err=0.0,
            bit_identical=True, launches_per_call=launched,
            plan=grid_attn.fwd_plan(args[6], args[0].element_size(), args[0].shape[0])._asdict(),
            ms=graph_ms(lambda: grid_attn._grid_attn_fwd_cuda(*args)),
            events_ms=cuda_ms(lambda: grid_attn._grid_attn_fwd_cuda(*args)),
            plain_ms=cuda_ms(lambda: grid_attn.grid_attn_plain(*args)),
            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
    del wide
    # a full-BPTT step at the defaults: launches, peak, time
    trainer = ice_mh()
    trainer.initiate_training(lr=LR, lr_decay=0.95)
    batch0 = (x0, y0, clim0)

    def ice_step(tr, batch):
        return tr.train_step(batch[0], batch[1], mask=mask, climatology=batch[2],
                             truncated_backprop=ICE_TBPTT)

    reset()
    step = {}
    t0 = time.perf_counter()
    step_peak = peak_above_start_gib(lambda: step.update(out=ice_step(trainer, batch0)))
    step_s = time.perf_counter() - t0
    train = nonzero(launch_totals(modules))
    check(bool(torch.isfinite(step["out"][0])) and int(step["out"][1]) == 0 and step_peak > 0,
          f"ice MH step: loss {float(step['out'][0])}, peak {step_peak}")
    want = expected_ice_mh_launches(cfg, train=True)
    check(train == want, f"ice MH step launches {train}, expected {want}")
    loss49 = float(step["out"][0])
    del trainer, step
    torch.cuda.empty_cache()
    # K6 at H 768 on a short step's cotangents (with its keep planes)
    short = ice_mh(t_out=ICE_SHORT_T_OUT)
    short.initiate_training(lr=LR, lr_decay=0.95)
    with FirstAtWidth(grid_attn, "_grid_attn_bwd_cuda", 768) as cap:
        ice_step(short, (x0, y0[:, :ICE_SHORT_T_OUT], clim0[:, :ICE_SHORT_T_OUT]))
    bwd_args = cap.args
    del cap, short
    k6_rows = []
    for dtype in ("bfloat16", "float32"):
        args = bwd_args if dtype == "bfloat16" else tuple(
            a.float() if torch.is_tensor(a) and a.dtype == bf16 else a for a in bwd_args)
        reset()
        kern = grid_attn._grid_attn_bwd_cuda(*args)
        launched = launch_totals(modules)["grid_attn_apply_bwd"]
        check(launched == 1, f"K6 at H 768 ({dtype}) launched {launched}, not once")
        check(all(torch.equal(a, b) for a, b in zip(grid_attn._grid_attn_bwd_cuda(*args), kern)),
              f"two launches of K6 at H 768 ({dtype}) differ")
        plain = grid_attn.grid_attn_bwd_plain(*args)
        if dtype == "bfloat16":
            errs = {n: _bf16_err(a, b, f"K6 {n} at H 768")
                    for n, a, b in zip(("dq", "dk", "dv", "de_dir"), kern, plain)}
        else:
            errs = {}
            for n, a, b in zip(("dq", "dk", "dv", "de_dir"), kern, plain):
                e = float((a - b).abs().max())
                errs[n] = (e, e / max(1.0, float(b.abs().max())))
            check(max(e[1] for e in errs.values()) <= K6_TOL,
                  f"K6 at H 768 differs from its plain version: {errs}")
        bound, b_ms, o_ms = grid_bound_ms(args, backward=True)
        k6_rows.append(dict(
            H=768, dtype=dtype, keep=args[5] is not None,
            err_rel_to_max={n: e[1] for n, e in errs.items()},
            max_abs_err=max(e[0] for e in errs.values()), launches_per_call=launched,
            repeat_bit_identical=True,
            plan=grid_attn.bwd_plan(args[6], args[0].element_size(),
                                    args[0].shape[0])._asdict(),
            ms=graph_ms(lambda: grid_attn._grid_attn_bwd_cuda(*args)),
            events_ms=cuda_ms(lambda: grid_attn._grid_attn_bwd_cuda(*args)),
            plain_ms=cuda_ms(lambda: grid_attn.grid_attn_bwd_plain(*args)),
            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
    del bwd_args
    torch.cuda.empty_cache()
    # K3/K4 at HD 768 (24 heads × d 32, one launch a call: the plans cut a
    # row into slices of heads) on one ice-quadtree mesh, operands and
    # cotangent from the seed
    quad = make_ice_quadtree_model(seed, run_dir.name)
    graph, _ = quad.model._graph(torch.as_tensor(x0, device=DEVICE).to(bf16),
                                 torch.as_tensor(mask, device=DEVICE))
    g = quad.gcfg
    del quad
    dims = attn.AttnDims(g.n_max, g.agg_nt, g.agg_eb, g.agg_sw, 24, 32)
    meta = graph.attn_meta
    gen = torch.Generator(DEVICE).manual_seed(seed)
    qkv = [torch.randn(1, g.n_max, 768, device=DEVICE, generator=gen) for _ in range(4)]
    we = torch.randn(meta.attr.shape[-1], 768, device=DEVICE, generator=gen)
    keep = ((torch.rand(1, meta.s0.shape[1], 24, g.agg_eb, device=DEVICE, generator=gen)
             < 0.9).float() / 0.9)
    k34_rows = []
    for dtype in ("float32", "bfloat16"):
        cast = (lambda t: t.to(bf16)) if dtype == "bfloat16" else (lambda t: t)
        q, k, v, cot = (cast(t) for t in qkv)
        fargs = (q, k, v, cast(we), keep, meta, dims)
        reset()
        with torch.no_grad():
            kern = attn._attn_fwd_cuda(*fargs)
            launched = launch_totals(modules)["attn_apply"]
            check(launched == 1, f"K3 at HD 768 launched {launched}, not once")
            check(torch.equal(attn._attn_fwd_cuda(*fargs), kern),
                  f"two launches of K3 at HD 768 ({dtype}) differ")
        plain = attn.attn_plain(*fargs)
        if dtype == "bfloat16":
            err = _bf16_err(kern, plain, "K3 at HD 768")[0]
        else:
            err = float((kern - plain).abs().max())
            check(err <= K3_TOL, f"K3 at HD 768 differs from attn_plain: {err}")
        bound, b_ms, o_ms = attn_bound_ms(attn, fargs, backward=False)
        k34_rows.append(dict(
            kernel="attn_apply", HD=768, dtype=dtype, keep=True,
            max_abs_err=err, launches_per_call=launched, repeat_bit_identical=True,
            live_tiles=int(meta.live.long().sum()),
            plan=attn.fwd_plan(dims, q.element_size())._asdict(),
            ms=graph_ms(lambda: attn._attn_fwd_cuda(*fargs)),
            events_ms=cuda_ms(lambda: attn._attn_fwd_cuda(*fargs)),
            plain_ms=cuda_ms(lambda: attn.attn_plain(*fargs)),
            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
        bargs = fargs + (cot, graph.slot_view)
        reset()
        kern = attn._attn_bwd_cuda(*bargs)
        launched = launch_totals(modules)["attn_apply_bwd"]
        check(launched == 1, f"K4 at HD 768 launched {launched}, not once")
        plain = attn.attn_bwd_plain(*bargs)
        if dtype == "bfloat16":
            errs = {n: _bf16_err(a, b, f"K4 {n} at HD 768")
                    for n, a, b in zip(("dq", "dk", "dv", "dwe"), kern, plain)}
        else:
            errs = {}
            for n, a, b in zip(("dq", "dk", "dv", "dwe"), kern, plain):
                e = float((a - b).abs().max())
                errs[n] = (e, e / max(1.0, float(b.abs().max())))
            check(max(e[1] for e in errs.values()) <= K4_TOL,
                  f"K4 at HD 768 differs from its plain backward: {errs}")
        bound, b_ms, o_ms = attn_bound_ms(attn, bargs, backward=True)
        k34_rows.append(dict(
            kernel="attn_apply_bwd", HD=768, dtype=dtype, keep=True,
            err_rel_to_max={n: e[1] for n, e in errs.items()},
            max_abs_err=max(e[0] for e in errs.values()), launches_per_call=launched,
            plan=attn.bwd_plan(dims, q.element_size())._asdict(),
            ms=graph_ms(lambda: attn._attn_bwd_cuda(*bargs)),
            events_ms=cuda_ms(lambda: attn._attn_bwd_cuda(*bargs)),
            plain_ms=cuda_ms(lambda: attn.attn_bwd_plain(*bargs)),
            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
    del graph, meta, qkv, we, keep
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "ice_mh", "card": card, "conv": "MHTransformerConv", "mesh": "grid",
        "dtype": "bfloat16", "fused_gates": False, "remat": "full", "t_out": ICE_T_OUT,
        "truncated_backprop": 0, "s_per_forecast": forecast_s,
        "forecast_peak_above_start_gib": fwd_peak, "forecast_launches": fwd,
        "loss": loss49, "overflow": 0, "step_s": step_s, "step_peak_above_start_gib": step_peak,
        "launches_per_step": train, "k5_hd768": k5_rows, "k6_hd768": k6_rows,
        "quadtree_hd768": k34_rows,
    }), flush=True)
    out["ice_mh"] = dict(forecast=fwd, train=train, k5=k5_rows, k6=k6_rows, k34=k34_rows)
    run_dir.cleanup()
    return out


def add_item7_paths(f32_entries, bf16_entries, item7: dict) -> None:
    """Adds phases 46-49 to the kernels line: each kernel's launches on the
    new paths (a forecast batch and a train step, remat none; bf16 entries
    count their bf16 launches), K3's and K4's rows at the MH widths
    (``mh_by_width``) and at HD 768 in one launch (``hd768``),
    K5's and K6's at H 768 in one launch (``hd768``) and K7's on GAT's
    self-loop sets (``by_operand_set``, path ``gat``)."""
    mh, gat, cells, ice = item7["mh"], item7["gat"], item7["cells"], item7["ice_mh"]
    for dtype, entries in (("float32", f32_entries), ("bfloat16", bf16_entries)):
        for entry in entries:
            name = entry["name"].removesuffix("_bf16")
            paths = entry["launches_by_path"]

            def add(path, counts, f32=None):
                n = counts.get(name, 0)
                if dtype == "bfloat16" and f32 is not None:
                    n -= f32.get(name, 0)
                if n:
                    paths[path] = n

            add("mh_predict_batch", mh["forecast"][dtype]["launches"],
                mh["forecast"][dtype]["f32_launches"])
            add("mh_train_step", mh["steps"][dtype]["none"]["launches_per_step"],
                mh["steps"][dtype]["none"]["f32_launches_per_step"])
            for conv in ("GATConv", "GATv2Conv"):
                key = f"{conv}-{dtype}"
                add(f"{conv.lower()}_predict_batch", gat["forecast"][key]["launches"],
                    gat["forecast"][key]["f32_launches"])
                add(f"{conv.lower()}_train_step", gat["steps"][key]["launches_per_step"],
                    gat["steps"][key]["f32_launches_per_step"])
            if dtype == "float32":
                for variant, step in cells["steps"].items():
                    add(f"{variant.lower()}_train_step", step["launches_per_step"])
            else:
                gru = cells["gru_bf16"]
                add("gru_remat_full_predict_batch", gru["forecast"]["launches"],
                    gru["forecast"]["f32_launches"])
                add("gru_remat_full_train_step", gru["steps"]["full"]["launches_per_step"],
                    gru["steps"]["full"]["f32_launches_per_step"])
                add("ice_mh_predict", ice["forecast"])
                add("ice_mh_train_step", ice["train"])
            if name in ("attn_apply", "attn_apply_bwd"):
                entry["mh_by_width"] = mh["k3" if name == "attn_apply" else "k4"][dtype]
                entry["hd768"] = [r for r in ice["k34"]
                                  if r["kernel"] == name and r["dtype"] == dtype]
            if name in ("grid_attn_apply", "grid_attn_apply_bwd"):
                entry["hd768"] = [r for r in ice["k5" if name == "grid_attn_apply" else "k6"]
                                  if r["dtype"] == dtype]
            if name == "segment_sum":
                rows = [r for r in gat["k7"] if r["dtype"] == dtype]
                entry["by_operand_set"] += [dict(r, path="gat") for r in rows]
                entry["ms_by_path"]["gat"] = k7_path_means(rows)


# ROADMAP Queue 1 item 8 and item 7's last part (phases 50-54): the sea-ice
# experiments 9 and 10 on their preset meshes (cli/ice_exp.py :70-75,
# :317-366, :425-453), the remeshing modes of bench.py's model, the
# MPNNLSTM/MPNNLSTMI baselines and the debug modes.
PRESET_KINDS = {"heterogeneous": 9, "homogeneous": 10}
PRESET_GRID, PRESET_RESOLUTION = 4, 1 / 12  # ice_exp.py's preset GraphConfig
REMESH_MODES = {"remesh_input": dict(remesh_input=True), "remesh_every_2": dict(remesh_every=2)}
BASELINE_HIDDEN = 32


def make_preset_model(seed: int, run_dir: str = "runs", **kw):
    """The model of experiments 9 and 10: :func:`make_ice_model` on the
    pixelwise edge list (no graph_kwargs: ``aggregation="xla"``) with
    ``dist_from_05`` and remat at the predictor's default (full); ``kw``
    as there."""
    from quadtree_mpnnlstm_tpu_torch.graph.quadtree import dist_from_05

    return make_ice_model(seed, run_dir, **{"aggregation": "xla", "remat": True,
                                             "transform_func": dist_from_05, **kw})


def make_preset(kind: str, mask):
    """Experiment 9's (``heterogeneous``) or 10's (``homogeneous``) preset
    mesh of the 224×304 mask, built once on the card."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
    from quadtree_mpnnlstm_tpu_torch.graph import static

    cfg = GraphConfig(image_shape=ICE_SHAPE, max_grid_size=PRESET_GRID,
                      resolution=PRESET_RESOLUTION, use_edge_attrs=True)
    mask_t = torch.as_tensor(mask, device=DEVICE)
    if kind == "heterogeneous":
        return static.create_static_heterogeneous_graph(cfg, mask=mask_t, device=DEVICE)
    return static.create_static_homogeneous_graph(cfg, mask_t, device=DEVICE)


def expected_preset_launches(cfg, t_out: int, train: bool = False) -> int:
    """K7 launches of one forecast on a preset mesh (``train``: one
    full-BPTT step under remat full), read from the code: as on the
    pixelwise edge list (:func:`expected_edge_launches`) but for the mesh
    build, which the preset did once: an encode pools the inputs and no
    node counts or degrees. A train step's replays repeat every attention
    call's aggregation."""
    k7 = expected_edge_launches(cfg, t_out, train=train) - 2
    if train:
        k7 += _attention_calls(cfg, t_out)
    return k7


def expected_remesh_launches(cfg, train: bool = False) -> dict:
    """K1, K2, K2b and K7 launches of one forecast batch (``train``: one
    full-BPTT train step without remat) of ``bench.py``'s ChebConv model
    under ``remesh_input`` or ``remesh_every``, read from the code. K1 once
    a mesh: the encoder's (with ``remesh_input`` the first frame's and one
    for each later input frame) and one after each decoder step t with (t
    + 1) % remesh_every == 0. K2 as with a remesh every step (a step that
    keeps its mesh runs its cells and head all the same), K2b for all of
    them but encoder step 0's first conv layer (:func:`expected_launches`).
    K7 three times a mesh (node counts, pooling, degrees) and once for
    each layer's H and C carried onto a new mesh; a train step's backward
    adds the gather of every decoder frame and of each carried H and C
    that reaches the loss: an encoder step reads only the top layer's
    state of the step before it (the reference's quirk), the decoder every
    layer's, and a remesh after the last step feeds nothing."""
    enc_meshes = cfg.input_timesteps if cfg.remesh_input else 1
    remeshes = sum((t + 1) % cfg.remesh_every == 0 for t in range(cfg.output_timesteps))
    carried = 2 * cfg.n_layers * (enc_meshes - 1 + remeshes)
    k2 = 2 * (cfg.input_timesteps * cfg.n_layers * cfg.n_conv_layers
              + cfg.output_timesteps * (cfg.n_layers + 2))
    want = {"spmm_build_blocks": enc_meshes + remeshes, "spmm_apply": k2,
            "segment_sum": 3 * (enc_meshes + remeshes) + carried}
    if train:
        last = 1 if cfg.output_timesteps % cfg.remesh_every == 0 else 0
        want["spmm_apply_bwd"] = k2 - 2
        want["segment_sum"] += (cfg.output_timesteps + 2 * (enc_meshes - 1)
                                + 2 * cfg.n_layers * (remeshes - last))
    return want


def expected_baseline_launches(kind: str, t_in: int, n_layers: int = 2) -> int:
    """Aggregations (K7 on an edge list, K2 on Â blocks) of one forward,
    read from the code: ``MPNNLSTM``'s three GCN blocks aggregate every
    frame in one Â·z each; each ``MPNNLSTMI`` GCN cell once a frame (its
    fused stack aggregates all its gate streams at once)."""
    return 3 if kind == "MPNNLSTM" else t_in * n_layers


def item8_phases(seed: int, card: str, spmm, attn, grid_attn, segment, segment_sum,
                 loader, x) -> dict:
    """Phases 50-54; returns what the kernels line adds: K7's rows on the
    preset meshes' sets in f32 and bf16, and each new path's launches."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
    from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph, pixelwise_graph
    from quadtree_mpnnlstm_tpu_torch.models.mpnnlstm import MPNNLSTM, MPNNLSTMI
    from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding
    from quadtree_mpnnlstm_tpu_torch.utils.weights import init_params

    run_dir = tempfile.TemporaryDirectory()
    modules = (spmm, attn, grid_attn, segment_sum)
    bf16 = torch.bfloat16
    out = {"preset": {}, "remesh": {}, "baselines": {}}

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def nonzero(d):
        return {k: v for k, v in d.items() if v}

    def f32_launches():
        return nonzero({k: v for m in modules for k, v in m.LAUNCHES.items()})

    def bf16_launches():
        return nonzero({k: v for m in modules for k, v in m.LAUNCHES_BF16.items()})

    def grads_of(trainer):
        return {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}

    plain_k7 = [(segment_sum, "_segment_sum_cuda", k7_plain)]
    plain_blocks = [(spmm, "_build_blocks_cuda", spmm.build_blocks_plain),
                    (spmm, "_apply_cuda", spmm.apply_plain),
                    (spmm, "_apply_bwd_cuda", spmm.apply_plain)] + plain_k7

    def plain(patches):
        stack = contextlib.ExitStack()
        for module, name, fn in patches:
            stack.enter_context(mock.patch.object(module, name, fn))
        return stack

    # ---- phases 50 and 51: experiments 9 and 10 on their preset meshes
    from quadtree_mpnnlstm_tpu_torch.cli.ice_exp import synthetic_hir

    data, clim, mask = ice_data(seed)
    hir = synthetic_hir(ICE_SHAPE)
    x0, y0, ld0 = data.x[:1], data.y[:1], data.launch_dates[:1]
    p = ICE_SHAPE[0] * ICE_SHAPE[1]
    windows = ArrayDataset(data.x[:2], data.y[:2], data.launch_dates[:2])
    k7_rows = {"float32": [], "bfloat16": []}
    for kind, exp in PRESET_KINDS.items():
        t0 = time.perf_counter()
        preset = make_preset(kind, mask)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        live = {"nodes": int(preset.n_nodes[0]), "edges": int(preset.n_edges[0])}
        check(int(preset.overflow.max()) == 0 and preset.n_max == p
              and preset.edge_src.shape[1] == 4 * p
              and None not in (preset.pixel_view, preset.dst_view, preset.src_view),
              f"experiment {exp} preset: overflow {int(preset.overflow.max())}, capacities "
              f"{preset.n_max}/{preset.edge_src.shape[1]}, views")
        model = make_preset_model(seed, run_dir.name)
        cfg = model.cfg
        check(model.gcfg.aggregation == "xla" and model.gcfg.pixelwise
              and model.model.remat == "full" and cfg.fused_gates
              and (model.gcfg.n_max, model.gcfg.e_max) == (p, 4 * p),
              f"experiment {exp} configuration: {cfg}, {model.gcfg}")
        clim0 = model._clim_batch(clim, ld0)
        mesh = dict(high_interest_region=hir, graph_structure=preset)
        model.forecast(x0, mask=mask, climatology=clim0, **mesh)  # warm-up
        torch.cuda.synchronize()
        reset()
        got = {}
        t0 = time.perf_counter()
        fwd_peak = peak_above_start_gib(lambda: got.update(
            y=model.forecast(x0, mask=mask, climatology=clim0, **mesh)))
        forecast_s = time.perf_counter() - t0
        fwd = nonzero(launch_totals(modules))
        y_f, ovf, meshes = got["y"]
        k7_fwd = expected_preset_launches(cfg, ICE_T_OUT)
        check(bool(torch.isfinite(y_f).all()) and int(ovf.max()) == 0
              and bool((meshes == preset.pixel_node[0]).all()),
              f"experiment {exp} forecast: finite {bool(torch.isfinite(y_f).all())}, overflow "
              f"{int(ovf.max())}, every step on the preset")
        check(fwd == {"segment_sum": k7_fwd},
              f"experiment {exp} forecast launches {fwd}, expected K7 {k7_fwd}")
        # predict over two windows, the batch riding the preset as views
        reset()
        y2 = model.predict(DataLoader(windows, batch_size=2), climatology=clim, mask=mask, **mesh)
        check(y2.shape == (2, ICE_T_OUT, *ICE_SHAPE, 1) and bool(np.isfinite(y2).all())
              and model.last_overflow == 0
              and model.model._preset_cache[1] == 2
              and model.model._preset_cache[2].edge_src.stride(0) == 0,
              f"experiment {exp} predict over 2 windows: {y2.shape}")
        check(nonzero(launch_totals(modules)) == {"segment_sum": k7_fwd},
              f"experiment {exp} predict launches {nonzero(launch_totals(modules))}")
        first = float(np.abs(y2[0] - y_f[0].cpu().numpy()).max())
        check(first <= ROLLOUT_TOL, f"experiment {exp}: window 0 alone and in a batch of 2 "
              f"differ by {first}")
        del got, y_f, y2
        # the K7 sets of a forecast and a T_out-6 step, measured as phase 21
        short = make_preset_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT)
        short.initiate_training(lr=LR, lr_decay=0.95)
        y_s, clim_s = y0[:, :ICE_SHORT_T_OUT], clim0[:, :ICE_SHORT_T_OUT]
        with SegmentCapture(segment, p, keep=True) as cap:
            model.forecast(x0, mask=mask, climatology=clim0, **mesh)
        with SegmentCapture(segment, p, keep=True) as cap_t:
            short.train_step(x0, y_s, mask=mask, climatology=clim_s, **mesh)
        sets = {**cap_t.ops, **cap.ops}
        rows = [dict(k7_measure(segment_sum, key, sets[key], cap_t.calls.get(key, 0)),
                     path=f"preset_{kind}", live_edges=live["edges"])
                for key in sorted(sets)]
        check({"dst", "src", "pixel"} <= {w["ids"] for w in rows},
              f"experiment {exp} K7 sets {[(w['ids'], w['F']) for w in rows]}")
        k7_rows["float32"] += rows
        del cap, cap_t, sets, short
        torch.cuda.empty_cache()
        # one full-BPTT step at full width (remat full)
        model.initiate_training(lr=LR, lr_decay=0.95)
        batch = (x0, y0)
        reset()
        step = {}
        t0 = time.perf_counter()
        step_peak = peak_above_start_gib(lambda: step.update(out=model.train_step(
            *batch, mask=mask, climatology=clim0, **mesh)))
        step_s = time.perf_counter() - t0
        train = nonzero(launch_totals(modules))
        k7_step = expected_preset_launches(cfg, ICE_T_OUT, train=True)
        check(bool(torch.isfinite(step["out"][0])) and int(step["out"][1]) == 0,
              f"experiment {exp} step: loss {float(step['out'][0])}")
        check(train == {"segment_sum": k7_step},
              f"experiment {exp} step launches {train}, expected K7 {k7_step}")
        loss = float(step["out"][0])
        del model, step
        torch.cuda.empty_cache()

        # a T_out-6 step on K7 against one on its plain version; remat full
        # against none, bit for bit
        def short_step(remat="full", patches=(), dtype="float32"):
            tr = make_preset_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT, remat=remat,
                                   dtype=dtype)
            tr.initiate_training(lr=LR, lr_decay=0.95)
            gen = torch.Generator(device=DEVICE).manual_seed(1)
            with plain(patches):
                loss_, _ = tr.train_step(x0, y_s, mask=mask, climatology=clim_s, generator=gen,
                                         **mesh)
            return loss_, grads_of(tr), gen.get_state()

        kern, none = short_step(), short_step("none")
        same = (torch.equal(kern[0], none[0]) and torch.equal(kern[2], none[2])
                and all(torch.equal(kern[1][n], g) for n, g in none[1].items()))
        check(same, f"experiment {exp}: remat full step differs from remat none")
        vs_plain = _leaf_err(kern[1], short_step(patches=plain_k7)[1])
        check(vs_plain <= GRAD_TOL, f"experiment {exp}: K7 step vs plain {vs_plain}")
        del kern, none
        torch.cuda.empty_cache()
        # bf16: a forecast and a full-BPTT step at full width, and K7's bf16
        # sets of a forecast and a T_out-6 step
        model = make_preset_model(seed, run_dir.name, dtype="bfloat16")
        model.forecast(x0, mask=mask, climatology=clim0, **mesh)  # warm-up
        torch.cuda.synchronize()
        reset()
        got = {}
        t0 = time.perf_counter()
        bf16_fwd_peak = peak_above_start_gib(lambda: got.update(
            y=model.forecast(x0, mask=mask, climatology=clim0, **mesh)))
        bf16_forecast_s = time.perf_counter() - t0
        bf16_fwd, bf16_fwd_f32 = nonzero(launch_totals(modules)), f32_launches()
        check(bool(torch.isfinite(got["y"][0]).all())
              and bf16_fwd == {"segment_sum": k7_fwd} and not bf16_fwd_f32,
              f"experiment {exp} bf16 forecast launches {bf16_fwd} (f32 {bf16_fwd_f32})")
        with SegmentCapture(segment, p, keep=True, dtype=bf16) as cap:
            model.forecast(x0, mask=mask, climatology=clim0, **mesh)
        del got
        short = make_preset_model(seed, run_dir.name, t_out=ICE_SHORT_T_OUT, dtype="bfloat16")
        short.initiate_training(lr=LR, lr_decay=0.95)
        with SegmentCapture(segment, p, keep=True, dtype=bf16) as cap_t:
            short.train_step(x0, y_s, mask=mask, climatology=clim_s, **mesh)
        sets = {**cap_t.ops, **cap.ops}
        k7_rows["bfloat16"] += [dict(k7_measure(segment_sum, key, sets[key],
                                                cap_t.calls.get(key, 0), BF16_TOL),
                                     path=f"preset_{kind}", live_edges=live["edges"])
                                for key in sorted(sets)]
        del cap, cap_t, sets, short
        model.initiate_training(lr=LR, lr_decay=0.95)
        reset()
        step = {}
        t0 = time.perf_counter()
        bf16_step_peak = peak_above_start_gib(lambda: step.update(out=model.train_step(
            *batch, mask=mask, climatology=clim0, **mesh)))
        bf16_step_s = time.perf_counter() - t0
        bf16_train, bf16_train_f32 = nonzero(launch_totals(modules)), f32_launches()
        check(bool(torch.isfinite(step["out"][0])) and int(step["out"][1]) == 0
              and bf16_train == {"segment_sum": k7_step} and not bf16_train_f32,
              f"experiment {exp} bf16 step: loss {float(step['out'][0])}, launches "
              f"{bf16_train} (f32 {bf16_train_f32})")
        check(all(q.dtype == q.grad.dtype == torch.float32 for q in model.model.parameters()),
              f"experiment {exp}: a bf16 master weight or gradient is not float32")
        bf16_loss = float(step["out"][0])
        del model, step, preset
        torch.cuda.empty_cache()
        out["preset"][kind] = dict(forecast=fwd, train=train, bf16_forecast=bf16_fwd,
                                   bf16_train=bf16_train)
        print(json.dumps({
            "phase": f"experiment_{exp}_{kind}", "card": card, "mesh": "edge_list",
            "n_max": p, "e_max": 4 * p, "live_nodes": live["nodes"],
            "live_edges": live["edges"], "live_edge_share": live["edges"] / (4 * p),
            "overflow": 0, "build_s": build_s, "t_out": ICE_T_OUT, "truncated_backprop": 0,
            "remat": "full", "s_per_forecast": forecast_s,
            "forecast_peak_above_start_gib": fwd_peak, "forecast_launches": fwd,
            "loss": loss, "step_s": step_s, "step_peak_above_start_gib": step_peak,
            "launches_per_step": train, "short_t_out": ICE_SHORT_T_OUT,
            "remat_full_vs_none_bit_identical": same, "k7_vs_plain_max_leaf_err_rel": vs_plain,
            "bf16": {"s_per_forecast": bf16_forecast_s, "forecast_launches": bf16_fwd,
                     "forecast_peak_above_start_gib": bf16_fwd_peak, "loss": bf16_loss,
                     "step_s": bf16_step_s, "launches_per_step": bf16_train,
                     "step_peak_above_start_gib": bf16_step_peak},
            "k7_by_set": [w for w in k7_rows["float32"] if w["path"] == f"preset_{kind}"],
            "k7_bf16_by_set": [w for w in k7_rows["bfloat16"] if w["path"] == f"preset_{kind}"],
        }), flush=True)
    out["k7"] = k7_rows
    del clim, windows

    # ---- phase 52: remesh_input and remesh_every=2 on bench.py's model
    _, batches = train_batches(seed, 1)
    x_b, y_b = batches[0]
    rows52 = {}
    for name, kw in REMESH_MODES.items():
        for dtype in ("float32", "bfloat16"):
            model = make_model(seed, run_dir.name, dtype=dtype, **kw)
            cfg = model.cfg
            model.predict(loader)  # warm-up
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            y = model.predict(loader)
            torch.cuda.synchronize()
            forecast_s = time.perf_counter() - t0
            fwd, fwd_f32 = nonzero(launch_totals(modules)), f32_launches()
            want = expected_remesh_launches(cfg)
            meshes = want["spmm_build_blocks"]
            check(y.shape == (BATCH, T_OUT, *CANVAS, 1) and bool(np.isfinite(y).all())
                  and model.last_overflow == 0,
                  f"{name} {dtype} forecast: finite {bool(np.isfinite(y).all())}, overflow "
                  f"{model.last_overflow}")
            check(fwd == want and (dtype == "float32" or fwd_f32 == {"segment_sum": meshes}),
                  f"{name} {dtype} forecast launches {fwd} (f32 {fwd_f32}), expected {want}")
            trainer = make_model(seed, run_dir.name, dtype=dtype, **kw)
            trainer.initiate_training(lr=LR, lr_decay=0.95)
            reset()
            t0 = time.perf_counter()
            loss, overflow = trainer.train_step(x_b, y_b)
            check(bool(torch.isfinite(loss)) and int(overflow) == 0,
                  f"{name} {dtype} step: loss {float(loss)}, overflow {int(overflow)}")
            step_s = time.perf_counter() - t0
            train, train_f32 = nonzero(launch_totals(modules)), f32_launches()
            want_t = expected_remesh_launches(cfg, train=True)
            check(train == want_t and (dtype == "float32"
                                       or train_f32 == {"segment_sum": meshes}),
                  f"{name} {dtype} step launches {train} (f32 {train_f32}), expected {want_t}")

            # remat full against none; a teacher-forced step (every decoder
            # mesh from a true frame) on the kernels against the plain
            # versions
            def step_of(remat=False, patches=(), tf=0.0):
                tr = make_model(seed, run_dir.name, dtype=dtype, remat=remat,
                                teacher_forcing_ratio=tf, **kw)
                tr.initiate_training(lr=LR, lr_decay=0.95)
                with plain(patches):
                    loss_, _, grads, meshes_ = step_with_meshes(tr, x_b, y_b, seed=1)
                return loss_, grads, meshes_

            full, none = step_of("full", tf=0.5), step_of(False, tf=0.5)
            same = (torch.equal(full[0], none[0]) and torch.equal(full[2], none[2])
                    and all(torch.equal(full[1][n], g) for n, g in none[1].items()))
            check(same, f"{name} {dtype}: remat full step differs from remat none")
            kern, ref = step_of(tf=1.0), step_of(patches=plain_blocks, tf=1.0)
            check(torch.equal(kern[2], ref[2]), f"{name} {dtype}: kernel and plain steps ran "
                  "on different meshes")
            err = _leaf_err(kern[1], ref[1])
            tol = GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL
            check(err <= tol, f"{name} {dtype}: step vs plain versions {err}")
            rows52[name, dtype] = dict(
                mode=name, dtype=dtype, batch_s=forecast_s, forecast_launches=fwd,
                forecast_f32_launches=fwd_f32, loss=float(loss), step_s=step_s,
                launches_per_step=train, f32_launches_per_step=train_f32,
                remat_full_vs_none_bit_identical=same, vs_plain_max_leaf_err_rel=err)
            del model, trainer, full, none, kern, ref
            torch.cuda.empty_cache()
    out["remesh"] = rows52
    print(json.dumps({"phase": "remesh_modes", "card": card, "batch": BATCH,
                      "rows": list(rows52.values())}), flush=True)

    # ---- phase 53: MPNNLSTM and MPNNLSTMI forwards
    ice_x = torch.as_tensor(data.x[:1], device=DEVICE)
    ice_mask_t = torch.as_tensor(mask, device=DEVICE)
    edge_cfg = GraphConfig(image_shape=ICE_SHAPE, thresh=float("-inf"))
    quad_cfg = make_model(seed, run_dir.name).gcfg
    rows53 = []
    for dtype in (torch.float32, bf16):
        graphs = {"edge_list": pixelwise_graph(add_positional_encoding(ice_x.to(dtype)),
                                               edge_cfg, mask=ice_mask_t),
                  "blocks": image_to_graph(add_positional_encoding(x[:1].to(dtype)), quad_cfg)}
        for mesh_name, (graph, data_) in graphs.items():
            frames = data_[0]
            t_in, features = frames.shape[0], frames.shape[-1]
            for kind, cls, kw in (("MPNNLSTM", MPNNLSTM, dict(input_timesteps=t_in)),
                                  ("MPNNLSTMI", MPNNLSTMI, dict(n_layers=2))):
                model = cls(features, BASELINE_HIDDEN, dtype=dtype, **kw).to(DEVICE).eval()
                init_params(model, torch.Generator().manual_seed(seed))
                with torch.no_grad():
                    model(frames, graph)  # warm-up
                    torch.cuda.synchronize()
                    reset()
                    t0 = time.perf_counter()
                    y = model(frames, graph)
                    torch.cuda.synchronize()
                    forward_s = time.perf_counter() - t0
                    # the run's dtype counts its launches; the other dtype
                    # must have launched nothing
                    launches, other = f32_launches(), bf16_launches()
                    if dtype == bf16:
                        launches, other = other, launches
                    with plain(plain_blocks):
                        y_plain = model(frames, graph)
                n_agg = expected_baseline_launches(kind, t_in)
                want = ({"segment_sum": n_agg} if mesh_name == "edge_list"
                        else {"spmm_apply": n_agg})
                err = float((y - y_plain).abs().max())
                tol = ROLLOUT_TOL if dtype == torch.float32 else BF16_FRAME_TOL
                check(y.shape == (graph.n_max, 1) and y.dtype == torch.float32
                      and bool(torch.isfinite(y).all()) and launches == want and not other
                      and err <= tol,
                      f"{kind} on {mesh_name} ({dtype}): shape {tuple(y.shape)}, launches "
                      f"{launches} (other dtype {other}), expected {want}, vs plain {err}")
                rows53.append(dict(model=kind, mesh=mesh_name, dtype=str(dtype)[6:],
                                   n_max=graph.n_max, t_in=t_in, forward_s=forward_s,
                                   launches=launches, vs_plain_max_abs_err=err))
                del model
        del graphs
    out["baselines"] = rows53
    print(json.dumps({"phase": "mpnnlstm_baselines", "card": card, "hidden": BASELINE_HIDDEN,
                      "rows": rows53}), flush=True)
    del data, ice_x
    torch.cuda.empty_cache()

    # ---- phase 54: the debug modes
    debug_rows = {}
    for needle, message in (("decoder", "non-finite output in module=decoder at rollout step "
                                        "t=0"),
                            ("encoder", "non-finite hidden state in module=encoder "
                                        "(fixed-mesh scan step)")):
        trainer = make_model(seed, run_dir.name, debug=True)
        trainer.initiate_training(lr=LR, lr_decay=0.95)
        with torch.no_grad():
            for n, q in trainer.model.named_parameters():
                if n.startswith(needle + "."):
                    q.fill_(float("nan"))
        try:
            trainer.train_step(x_b, y_b)
            raised = None
        except ValueError as exc:
            raised = str(exc)
        check(raised is not None and message in raised,
              f"a NaN {needle} weight raised {raised!r}, not {message!r}")
        debug_rows[needle] = raised
        del trainer
    steps = {}
    for debug in (False, True):
        trainer = make_model(seed, run_dir.name, debug=debug, teacher_forcing_ratio=0.5)
        trainer.initiate_training(lr=LR, lr_decay=0.95)
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        loss, _ = trainer.train_step(x_b, y_b, generator=gen)
        steps[debug] = (loss, grads_of(trainer), gen.get_state(),
                        {n: q.detach().clone() for n, q in trainer.model.named_parameters()})
        del trainer
    clean = (torch.equal(steps[True][0], steps[False][0])
             and torch.equal(steps[True][2], steps[False][2])
             and all(torch.equal(steps[True][k][n], v) for k in (1, 3)
                     for n, v in steps[False][k].items()))
    check(clean, "a clean debug step differs from the plain step")
    frames = add_positional_encoding(x[:2])
    overflow_cfg = quad_cfg.replace(debug_overflow=True)
    graph, _ = image_to_graph(frames, overflow_cfg)
    try:
        image_to_graph(frames, overflow_cfg.replace(n_max=64, e_max=256, node_budget=None,
                                                    aggregation="xla", carry_edges=True))
        overflow_raised = None
    except RuntimeError as exc:
        overflow_raised = str(exc)
    check(int(graph.overflow.max()) == 0 and overflow_raised is not None
          and "graph capacity overflow" in overflow_raised,
          f"debug_overflow: silent build overflow {int(graph.overflow.max())}, undersized "
          f"build raised {overflow_raised!r}")
    print(json.dumps({"phase": "debug_modes", "card": card, "nan_messages": debug_rows,
                      "clean_debug_step_bit_identical": clean,
                      "overflow_message": overflow_raised}), flush=True)
    run_dir.cleanup()
    return out


def add_item8_paths(f32_entries, bf16_entries, item8: dict) -> None:
    """Adds phases 50-53 to the kernels line: K7's rows on the preset
    meshes' sets (``by_operand_set``, paths ``preset_heterogeneous`` and
    ``preset_homogeneous``, with their launch-weighted means), and each
    kernel's launches on the new paths (a forecast and a full-BPTT step of
    each experiment, a forecast batch and a train step of each remesh mode
    and a forward of each baseline; bf16 entries count their bf16
    launches)."""
    for dtype, entries in (("float32", f32_entries), ("bfloat16", bf16_entries)):
        for entry in entries:
            name = entry["name"].removesuffix("_bf16")
            paths = entry["launches_by_path"]

            def add(path, counts, f32=None):
                n = counts.get(name, 0) - ((f32 or {}).get(name, 0) if dtype != "float32"
                                           else 0)
                if n:
                    paths[path] = n

            for kind, runs in item8["preset"].items():
                prefix = "" if dtype == "float32" else "bf16_"
                add(f"preset_{kind}_predict", runs[prefix + "forecast"])
                add(f"preset_{kind}_train_step", runs[prefix + "train"])
            for (mode, run_dtype), row in item8["remesh"].items():
                if run_dtype == dtype:
                    add(f"{mode}_predict_batch", row["forecast_launches"],
                        row["forecast_f32_launches"])
                    add(f"{mode}_train_step", row["launches_per_step"],
                        row["f32_launches_per_step"])
            for row in item8["baselines"]:
                if row["dtype"] == dtype:
                    add(f"{row['model'].lower()}_{row['mesh']}_forward", row["launches"])
            if name == "segment_sum":
                rows = item8["k7"][dtype]
                entry["by_operand_set"] += rows
                for kind in PRESET_KINDS:
                    entry["ms_by_path"][f"preset_{kind}"] = k7_path_means(
                        [r for r in rows if r["path"] == f"preset_{kind}"])


# ---------------------------------------------------------------- item 9
# Phases 55-58: the alternative backends (ROADMAP Queue 1 item 9) at
# bench.py's model (make_model): shared-mesh batched training (bench.py
# --shared-mesh and the --full rows pallas_bf16_shared_b8/_b32, plus f32 at
# batch 16), the csum adjacency (bench.py --adjacency csum), bf16 messages
# and the CSR degree cap.
SHARED_RUNS = (("bfloat16", 8), ("bfloat16", 32), ("float32", 16))
SHARED_STEPS = 2
CAP_BELOW = 4  # below the quadtree meshes' node degrees: truncates


def shared_batches(seed: int, batch: int, n: int):
    """``n`` batches of ``batch`` videos made as ``bench.py`` ``measure``
    makes them."""
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    ds = ModMovingMNISTDataset(
        batch * n, input_timesteps=T_IN, output_timesteps=T_OUT, canvas_size=CANVAS,
        digit_size=DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=seed,
    )
    return [(ds.x[i * batch:(i + 1) * batch], ds.y[i * batch:(i + 1) * batch])
            for i in range(n)]


def k2_shared_bound_ms(s0, blocks, live, n_max, nt, sw, f, batch):
    """Least time for K2's (or K2b's) work on one mesh's blocks for
    ``batch`` samples: the blocks read once (the mesh is shared), each
    sample's covered z rows read and its output written once, and each
    sample's multiply-adds; :func:`k2_bound_ms` for one sample, scaled."""
    bound, b_ms, o_ms = k2_bound_ms(s0, blocks, live, n_max, nt, sw, f, 1)
    size = blocks.element_size()
    block_ms = int(live.long().sum()) * nt * sw * size / PEAK_BYTES_PER_S * 1e3
    b_ms = block_ms + (b_ms - block_ms) * batch
    o_ms *= batch
    return max(b_ms, o_ms), b_ms, o_ms


def attn_shared_bound_ms(attn, args, backward: bool):
    """:func:`attn_bound_ms` on a shared mesh's windows (batch 1) for a
    batch of B: each sample's rows and operations, the windows' indices and
    attributes read once, not B times."""
    q, meta, dims = args[0], args[5], args[6]
    b = q.shape[0]
    _, b_ms, o_ms = attn_bound_ms(attn, args[:5] + (attn.for_batch(meta, b),) + args[6:],
                                  backward)
    n_slots = int((attn.slot_nodes(meta, dims)[0] >= 0).sum())
    b_ms -= (b - 1) * n_slots * (8 + 4 * args[3].shape[0]) / PEAK_BYTES_PER_S * 1e3
    return max(b_ms, o_ms), b_ms, o_ms


def item9_phases(seed: int, card: str, spmm, attn, grid_attn, segment, segment_sum,
                 loader, x) -> dict:
    """Phases 55-58; returns what the kernels line adds: K1, K2, K2b, K3
    and K4 on shared meshes and K7 on capped views and bf16 messages, with
    each new path's launches."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
    from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
    from quadtree_mpnnlstm_tpu_torch.graph.quadtree import dist_from_05
    from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding

    run_dir = tempfile.TemporaryDirectory()
    modules = (spmm, attn, grid_attn, segment_sum)
    out = {"paths": {}, "rows": {}}

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def nonzero(d):
        return {k: v for k, v in d.items() if v}

    def by_dtype(per: int = 1):
        """(f32 launches, bf16 launches) since the last reset, over ``per``."""
        return tuple({k: v / per for m in modules for k, v in getattr(m, table).items() if v}
                     for table in ("LAUNCHES", "LAUNCHES_BF16"))

    def grads_of(trainer):
        return {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}

    def steps(trainer, batches):
        """(seconds, losses, worst overflow) of one train step a batch, the
        loss and overflow fetched one step late, as train() does."""
        t0 = time.perf_counter()
        losses, worst, pending = [], 0, None
        for xb, yb in batches:
            loss, overflow = trainer.train_step(xb, yb)
            if pending is not None:
                losses.append(float(pending[0]))
                worst = max(worst, int(pending[1]))
            pending = (loss, overflow)
        losses.append(float(pending[0]))
        worst = max(worst, int(pending[1]))
        return time.perf_counter() - t0, losses, worst

    # ---- phase 55: shared-mesh batched training at bench.py's model
    runs = []
    k1_batches = []
    for dtype, batch in SHARED_RUNS:
        batches = shared_batches(seed, batch, SHARED_STEPS + 1)
        row = dict(dtype=dtype, batch=batch, remat="full")
        for shared in (True, False):
            trainer = make_trainer(seed, run_dir.name, dtype=dtype, remat="full",
                                   shared_mesh=shared)
            check(trainer.shared_mesh == shared and trainer.model.remat == "full",
                  f"shared_mesh {trainer.shared_mesh}, remat {trainer.model.remat}")
            trainer.train_step(*batches[0])  # warm-up
            torch.cuda.synchronize()
            reset()
            with Record(spmm, "_build_blocks_cuda") as built:
                seconds, losses, worst = steps(trainer, batches[1:])
            launches = {k: v / SHARED_STEPS for k, v in nonzero(launch_totals(modules)).items()}
            split = by_dtype(SHARED_STEPS)
            key = "shared" if shared else "per_sample"
            check(bool(np.isfinite(losses).all()) and worst == 0,
                  f"{key} {dtype} batch {batch}: losses {losses}, overflow {worst}")
            want = expected_remat_launches(trainer.cfg, "full")
            check({k: launches.get(k, 0) for k in want} == want,
                  f"{key} {dtype} batch {batch}: launches a step {launches}, expected {want}")
            build_batches = sorted({int(a[0].shape[0]) for a in built.calls})
            check(build_batches == ([1] if shared else [batch]),
                  f"{key} {dtype} batch {batch}: K1 built batches of {build_batches}")
            k1_batches.append(built.calls[0])
            peak = peak_above_start_gib(lambda: trainer.train_step(*batches[1]))
            row[key] = dict(seconds=seconds, steps=SHARED_STEPS,
                            steps_per_s=SHARED_STEPS / seconds,
                            frames_per_s=SHARED_STEPS * batch * T_OUT / seconds,
                            losses=losses, overflow=worst, launches_per_step=launches,
                            k1_batch=build_batches[0], step_peak_above_start_gib=peak)
            if shared:
                out["paths"][f"shared_{dtype}_b{batch}_train_step"] = split
            del trainer, built
            torch.cuda.empty_cache()
        runs.append(row)

    # B identical samples: the shared mesh is each sample's own, so the
    # forecast (eval) and a train step without dropout are the per-sample
    # path's bit for bit
    x1, y1 = shared_batches(seed, 1, 1)[0]
    xs, ys = np.repeat(x1, BATCH, 0), np.repeat(y1, BATCH, 0)
    same = {}
    for conv in ("ChebConv", "TransformerConv"):
        got = []
        for shared in (False, True):
            trainer = make_trainer(seed, run_dir.name, conv=conv, shared_mesh=shared)
            model = trainer.model.eval()
            with torch.no_grad():
                state = model.encode(torch.as_tensor(xs, device=DEVICE), shared_mesh=shared)
                _, y_hat, meshes = model.decode(state, T_OUT)
            step = None
            if conv == "ChebConv":
                model.decoder.dropout = 0.0
                gen = torch.Generator(device=DEVICE).manual_seed(1)
                loss, _ = trainer.train_step(xs, ys, generator=gen)
                step = (loss, grads_of(trainer))
            got.append((y_hat, meshes, step))
            del trainer
        (ya, ma, sa), (yb, mb, sb) = got
        ok = torch.equal(ya, yb) and torch.equal(ma, mb)
        if sa is not None:
            ok = ok and torch.equal(sa[0], sb[0]) and all(torch.equal(g, sb[1][n])
                                                          for n, g in sa[1].items())
        check(ok, f"{conv}: B identical samples on the shared mesh differ from the "
              "per-sample path")
        same[conv] = True
    torch.cuda.empty_cache()

    # K1 once a mesh: one build of a shared step against one of a
    # per-sample step, each timed (the f32 batch-16 run's)
    k1_rows = []
    for args, kind in zip(k1_batches[-2:], ("shared", "per_sample")):
        bound, b_ms, o_ms = k1_bound_ms(args[0], args[1], args[3], args[4], args[5])
        k1_rows.append(dict(kind=kind, batch=int(args[0].shape[0]),
                            ms=graph_ms(lambda: spmm._build_blocks_cuda(*args)),
                            events_ms=cuda_ms(lambda: spmm._build_blocks_cuda(*args)),
                            plain_ms=cuda_ms(lambda: spmm.build_blocks_plain(*args)),
                            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms,
                            bound_by="bytes" if b_ms >= o_ms else "operations",
                            max_abs_err=float((spmm._build_blocks_cuda(*args)
                                               - spmm.build_blocks_plain(*args)).abs().max())))
        check(k1_rows[-1]["max_abs_err"] == 0.0, f"K1 ({kind}) differs from its plain version")

    # K2 and K2b on a shared mesh's blocks (batch 1) for the batch, per
    # width, against their plain versions (f32, batch 16; bf16, batch 32)
    k2_rows = []
    for dtype, batch in (("float32", BATCH), ("bfloat16", 32)):
        trainer = make_trainer(seed, run_dir.name, dtype=dtype, remat="full", shared_mesh=True)
        xb, yb = shared_batches(seed, batch, 1)[0]
        with CaptureBwd(spmm, "_apply_cuda") as fwd, CaptureBwd(spmm, "_apply_bwd_cuda") as bwd:
            trainer.train_step(xb, yb)
        for name, cap, launch in (("spmm_apply", fwd, spmm._apply_cuda),
                                  ("spmm_apply_bwd", bwd, spmm._apply_bwd_cuda)):
            for f, args in sorted(cap.first.items()):
                z, s0, blocks, live, n_max, nt, sw = args
                check(s0.shape[0] == 1 and z.shape[0] == batch,
                      f"{name} ran on blocks of batch {s0.shape[0]} for {z.shape[0]} samples")
                with torch.no_grad():
                    kern, plain = launch(*args), spmm.apply_plain(*args)
                err = float((kern.float() - plain.float()).abs().max())
                tol = K2_TOL if dtype == "float32" else BF16_TOL * max(
                    1.0, float(plain.float().abs().max()))
                check(err <= tol, f"{name} on shared blocks differs from its plain version "
                      f"at F={f} ({dtype}): {err}")
                # the library yardstick: Â as one CSR matrix times the
                # batch folded into the features, (n, B·F), as the JAX
                # package folds it
                folded = z.permute(1, 0, 2).reshape(1, n_max, batch * f).contiguous()
                library, refused = _library_spmm(s0, blocks, n_max, nt, sw, folded)
                bound, b_ms, o_ms = k2_shared_bound_ms(s0, blocks, live, n_max, nt, sw, f,
                                                       batch)
                k2_rows.append(dict(
                    name=name, dtype=dtype, batch=batch, F=f, folded_width=batch * f,
                    calls=cap.per_width[f], max_abs_err=err,
                    ms=graph_ms(lambda: launch(*args)), events_ms=cuda_ms(lambda: launch(*args)),
                    **rowwarp_times(spmm, args, kern, f"{name} on shared blocks at F={f}"),
                    plain_ms=cuda_ms(lambda: spmm.apply_plain(*args)),
                    **(library_times(library) if library is not None else
                       dict(library_ms=None, library_events_ms=None, library_timing=None)),
                    library_refused=refused, bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
        del trainer, fwd, bwd
        torch.cuda.empty_cache()

    # K3 and K4 on a shared mesh's windows: one TransformerConv step at
    # bench.py's width, batch 16, f32, every width
    trainer = make_trainer(seed, run_dir.name, conv="TransformerConv", shared_mesh=True)
    xb, yb = shared_batches(seed, BATCH, 1)[0]
    trainer.train_step(xb, yb)  # warm-up
    reset()
    with CaptureBwd(attn, "_attn_fwd_cuda") as fwd, CaptureBwd(attn, "_attn_bwd_cuda") as bwd:
        loss, overflow = trainer.train_step(xb, yb)
    attn_step = nonzero(launch_totals(modules))
    out["paths"]["shared_transformer_train_step"] = by_dtype()
    k3 = expected_attn_launches(trainer.cfg)
    want = {"attn_apply": k3, "attn_apply_bwd": k3,
            "segment_sum": expected_quadtree_k7(trainer.cfg, 2, train=True)}
    check(bool(torch.isfinite(loss)) and int(overflow) == 0 and attn_step == want,
          f"shared TransformerConv step: loss {float(loss)}, overflow {int(overflow)}, "
          f"launches {attn_step}, expected {want}")
    attn_rows = []
    for name, cap, launch in (("attn_apply", fwd, attn._attn_fwd_cuda),
                              ("attn_apply_bwd", bwd, attn._attn_bwd_cuda)):
        for hd, args in sorted(cap.first.items()):
            meta = args[5]
            check(meta.s0.shape[0] == 1 and args[0].shape[0] == BATCH,
                  f"{name} ran on windows of batch {meta.s0.shape[0]}")
            if name == "attn_apply":
                with torch.no_grad():
                    kern, plain = launch(*args), attn.attn_plain(*args)
                err = float((kern - plain).abs().max())
                rel = err
                check(err <= K3_TOL, f"K3 on shared windows differs at HD {hd}: {err}")
                plain_fn = attn.attn_plain
            else:
                kern, plain = launch(*args), attn.attn_bwd_plain(*args)
                err = max(float((a - p).abs().max()) for a, p in zip(kern, plain))
                rel = max(float((a - p).abs().max()) / max(1.0, float(p.abs().max()))
                          for a, p in zip(kern, plain))
                check(rel <= K4_TOL, f"K4 on shared windows differs at HD {hd}: {rel}")
                plain_fn = attn.attn_bwd_plain
            bound, b_ms, o_ms = attn_shared_bound_ms(attn, args, name == "attn_apply_bwd")
            attn_rows.append(dict(
                name=name, HD=hd, batch=BATCH, calls=cap.per_width[hd], max_abs_err=err,
                err_rel_to_max=rel, ms=graph_ms(lambda: launch(*args)),
                events_ms=cuda_ms(lambda: launch(*args)),
                plain_ms=cuda_ms(lambda: plain_fn(*args)), library_ms=None,
                bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms))
    del trainer, fwd, bwd
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "shared_mesh", "card": card, "runs": runs,
        "identical_samples_bit_identical": same, "k1": k1_rows, "k2": k2_rows,
        "k3_k4": attn_rows,
    }), flush=True)
    out["rows"].update(k1=k1_rows, k2=k2_rows, k3_k4=attn_rows)

    # ---- phase 56: the csum adjacency
    # (a) bench.py --workload ice-quadtree --adjacency csum: a forecast and
    # a full-BPTT step, bf16, batch 1
    data, clim, mask = ice_data(seed)
    quad = make_ice_quadtree_model(seed, run_dir.name, adjacency="csum")
    qcfg, qg = quad.cfg, quad.gcfg
    check(qg.adjacency == "csum" and qg.attn_windows and qcfg.compute_dtype == "bfloat16",
          f"ice-quadtree csum configuration: {qg}")
    x0, y0 = data.x[:1], data.y[:1]
    clim0 = quad._clim_batch(clim, data.launch_dates[:1])
    # the card's csum list of the first input mesh against the CPU's
    frames = torch.as_tensor(x0, device=DEVICE)[..., :1]
    cfg_ice = qg.replace(carry_edges=True, attn_windows=False, aggregation="xla")
    mask_t = torch.as_tensor(mask, device=DEVICE)
    card_g, _ = image_to_graph(add_positional_encoding(frames), cfg_ice, mask=mask_t,
                               transform_func=dist_from_05)
    cpu_g, _ = image_to_graph(add_positional_encoding(frames.cpu()), cfg_ice,
                              mask=mask_t.cpu(), transform_func=dist_from_05)
    sort_g, _ = image_to_graph(add_positional_encoding(frames.cpu()),
                               cfg_ice.replace(adjacency="sort"), mask=mask_t.cpu(),
                               transform_func=dist_from_05)
    same_list = all(torch.equal(getattr(card_g, n).cpu(), getattr(cpu_g, n))
                    for n in ("edge_src", "edge_dst", "edge_valid", "n_edges"))
    v = cpu_g.edge_valid[0]
    pairs = lambda g: set(zip(g.edge_src[0][g.edge_valid[0]].tolist(),  # noqa: E731
                              g.edge_dst[0][g.edge_valid[0]].tolist()))
    check(same_list and pairs(cpu_g) == pairs(sort_g) and int(v.sum()) > 0
          and not torch.equal(cpu_g.edge_src, sort_g.edge_src),
          "the card's csum list differs from the CPU's, or its edge set from the sort list's")
    quad.forecast(x0, mask=mask, climatology=clim0)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    y_q, ovf_q, _ = quad.forecast(x0, mask=mask, climatology=clim0)
    torch.cuda.synchronize()
    quad_s = time.perf_counter() - t0
    quad_fwd = nonzero(launch_totals(modules))
    out["paths"]["ice_quadtree_csum_predict"] = by_dtype()
    want = nonzero(expected_ice_quadtree_launches(qcfg, train=False))
    check(bool(torch.isfinite(y_q).all()) and int(ovf_q.max()) == 0 and quad_fwd == want,
          f"ice-quadtree csum forecast: overflow {int(ovf_q.max())}, launches {quad_fwd}, "
          f"expected {want}")
    del y_q
    quad.initiate_training(lr=LR, lr_decay=0.95)
    reset()
    t0 = time.perf_counter()
    q_loss, q_ovf = quad.train_step(x0, y0, mask=mask, climatology=clim0)
    q_loss = float(q_loss)
    quad_step_s = time.perf_counter() - t0
    quad_train = nonzero(launch_totals(modules))
    out["paths"]["ice_quadtree_csum_train_step"] = by_dtype()
    want = nonzero(expected_ice_quadtree_launches(qcfg, train=True))
    check(np.isfinite(q_loss) and int(q_ovf) == 0 and quad_train == want,
          f"ice-quadtree csum step: loss {q_loss}, overflow {int(q_ovf)}, launches "
          f"{quad_train}, expected {want}")
    del quad
    torch.cuda.empty_cache()
    # (b) the Moving-MNIST model of phase 55 with csum on Â blocks: its
    # forecast on the kernels against one on their plain versions; the sort
    # model's forecast beside it, ungated (the degree sums add the same
    # weights in another order, so Â differs in its last bits)
    csum = make_model(seed, run_dir.name, graph_extra=dict(adjacency="csum"))
    sort = make_model(seed, run_dir.name)
    xt = torch.as_tensor(x, device=DEVICE)
    csum.forecast(xt)  # warm-up
    reset()
    with Record(spmm, "_build_blocks_cuda") as built:
        y_c, ovf_c, m_c = csum.forecast(xt)
    mm_fwd = nonzero(launch_totals(modules))
    out["paths"]["csum_predict_batch"] = by_dtype()
    with mock.patch.object(spmm, "_build_blocks_cuda", spmm.build_blocks_plain), \
            mock.patch.object(spmm, "_apply_cuda", spmm.apply_plain), \
            mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain):
        y_p, _, m_p = csum.forecast(xt)
    with Record(spmm, "_build_blocks_cuda") as built_s:
        y_s, _, m_s = sort.forecast(xt)
    want = {"spmm_build_blocks": 1 + T_OUT,
            "spmm_apply": 2 * (T_IN * csum.cfg.n_layers * csum.cfg.n_conv_layers
                               + T_OUT * (csum.cfg.n_layers + 2)),
            "segment_sum": expected_quadtree_k7(csum.cfg, 3)}
    blocks_diff = float((built.results[0] - built_s.results[0]).abs().max())
    check(bool(torch.isfinite(y_c).all()) and int(ovf_c.max()) == 0 and mm_fwd == want
          and blocks_diff <= 1e-6 and torch.equal(m_c[0], m_p[0]) and torch.equal(m_c[0], m_s[0]),
          f"Moving-MNIST csum forecast: overflow {int(ovf_c.max())}, launches {mm_fwd} "
          f"(expected {want}), first blocks differ from the sort build's by {blocks_diff}")

    def before_flip(y_a, m_a, y_b, m_b):
        same_mesh = (m_a == m_b).all(dim=-1)
        first_ = [int(torch.nonzero(~same_mesh[:, i])[0]) if not same_mesh[:, i].all()
                  else T_OUT for i in range(same_mesh.shape[1])]
        return first_, max((float((y_a[i, :f_] - y_b[i, :f_]).abs().max())
                            for i, f_ in enumerate(first_) if f_ > 0), default=0.0)

    first, agree = before_flip(y_c, m_c, y_p, m_p)
    check(agree <= ROLLOUT_TOL, f"csum forecast on the kernels and on the plain versions "
          f"differ by {agree} before a flip")
    first_sort, vs_sort = before_flip(y_c, m_c, y_s, m_s)
    del csum, sort, built, built_s
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "csum_adjacency", "card": card,
        "ice_quadtree": dict(card_list_equals_cpu_list=same_list,
                             edges=int(v.sum()), s_per_forecast=quad_s,
                             forecast_launches=quad_fwd, step_s=quad_step_s, loss=q_loss,
                             overflow=0, launches_per_step=quad_train),
        "moving_mnist": dict(forecast_launches=mm_fwd, first_blocks_max_abs_diff=blocks_diff,
                             first_mesh_flip_step=first, max_abs_err_before_flip=agree,
                             vs_sort_first_flip_step=first_sort,
                             vs_sort_max_abs_diff_before_flip=vs_sort),
    }), flush=True)

    # ---- phase 57: bf16 messages (message_dtype) in an f32 model: bench.py's
    # model on the quadtree edge list
    edge = dict(aggregation="xla")
    msg = make_trainer(seed, run_dir.name, graph_extra=dict(edge, message_dtype="bfloat16"))
    f32m = make_trainer(seed, run_dir.name, graph_extra=edge)
    cfg = msg.cfg
    check(msg.gcfg.message_dtype == "bfloat16" and cfg.compute_dtype == "float32"
          and msg.gcfg.carry_edges, f"bf16 messages configuration: {msg.gcfg}")
    aggregations = 2 * (T_IN * cfg.n_layers * cfg.n_conv_layers + T_OUT * (cfg.n_layers + 2))
    msg.forecast(xt)  # warm-up
    reset()
    y_m, ovf_m, _ = msg.forecast(xt)
    msg_fwd = out["paths"]["bf16_messages_predict_batch"] = by_dtype()
    y_f, _, _ = f32m.forecast(xt)
    check(bool(torch.isfinite(y_m).all()) and int(ovf_m.max()) == 0
          and msg_fwd[1] == {"segment_sum": aggregations} and msg_fwd[0].get("segment_sum"),
          f"bf16-message forecast: launches f32 {msg_fwd[0]}, bf16 {msg_fwd[1]}, expected "
          f"{aggregations} bf16")
    xb, yb = shared_batches(seed, BATCH, 1)[0]
    reset()
    m_loss, m_ovf = msg.train_step(xb, yb)
    msg_step = out["paths"]["bf16_messages_train_step"] = by_dtype()
    check(bool(torch.isfinite(m_loss)) and int(m_ovf) == 0
          and msg_step[1] == {"segment_sum": aggregations},
          f"bf16-message step: loss {float(m_loss)}, launches bf16 {msg_step[1]}")
    with SegmentCapture(segment, CANVAS[0] * CANVAS[1], keep=True, dtype=torch.bfloat16,
                        counts=True) as cap:
        msg.forecast(xt)
    msg_rows = [dict(k7_measure(segment_sum, key, cap.ops[key], 0, BF16_TOL), path="bf16_messages")
                for key in sorted(cap.ops)]
    check(msg_rows and all(w["dtype"] == "bfloat16" for w in msg_rows),
          f"bf16-message K7 sets {[(w['ids'], w['dtype']) for w in msg_rows]}")
    out["rows"]["k7_bf16_messages"] = msg_rows
    print(json.dumps({
        "phase": "bf16_messages", "card": card, "compute_dtype": "float32",
        "message_dtype": "bfloat16", "forecast_k7_f32": msg_fwd[0], "forecast_k7_bf16": msg_fwd[1],
        "step_k7_f32": msg_step[0], "step_k7_bf16": msg_step[1], "loss": float(m_loss),
        "first_frame_max_abs_diff_from_f32_messages": float((y_m[:, 0] - y_f[:, 0]).abs().max()),
        "max_abs_diff_from_f32_messages": float((y_m - y_f).abs().max()),
        "k7_by_set": msg_rows,
    }), flush=True)
    del msg, f32m, cap
    torch.cuda.empty_cache()

    # ---- phase 58: the CSR degree cap on the same edge-list model
    bound = GraphConfig(image_shape=CANVAS, max_grid_size=8, n_max=2048, e_max=10240).degree_bound

    def capped_run(cap_):
        tr = make_trainer(seed, run_dir.name, graph_extra=dict(edge, max_degree=cap_))
        y_, ovf_, meshes_ = tr.forecast(xt)
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        loss_, ovf_s = tr.train_step(xb, yb, generator=gen)
        return y_, int(ovf_.max()), meshes_, loss_, int(ovf_s), grads_of(tr)

    uncapped, above = capped_run(0), capped_run(bound)
    same_cap = (torch.equal(uncapped[0], above[0]) and torch.equal(uncapped[2], above[2])
                and torch.equal(uncapped[3], above[3])
                and all(torch.equal(g, above[5][n]) for n, g in uncapped[5].items()))
    check(same_cap and above[1] == 0 and above[4] == 0,
          f"max_degree {bound} (above every degree) is not the uncapped run bit for bit")
    below = make_trainer(seed, run_dir.name, graph_extra=dict(edge, max_degree=CAP_BELOW))
    reset()
    y_b, ovf_b, _ = below.forecast(xt)
    cap_fwd = nonzero(launch_totals(modules))
    out["paths"]["capped_predict_batch"] = by_dtype()
    check(bool(torch.isfinite(y_b).all()) and int(ovf_b.min()) > 0,
          f"max_degree {CAP_BELOW}: finite {bool(torch.isfinite(y_b).all())}, overflow "
          f"{ovf_b.tolist()}")
    # K7 on the capped views of one mesh, against the entry-ordered capped sum
    g_cap, _ = image_to_graph(add_positional_encoding(xt), below.gcfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    cap_rows = []
    for ids, view, name in ((g_cap.edge_dst_cap, g_cap.dst_cap_view, "dst_capped"),
                            (g_cap.edge_src_cap, g_cap.src_cap_view, "src_capped")):
        for f in (1, 16):
            values = torch.randn((*ids.shape, f), generator=gen, device=DEVICE)
            cap_rows.append(dict(k7_measure(segment_sum, (name, f),
                                            (values, ids, g_cap.n_max, view), 0),
                                 path="capped_views", max_degree=CAP_BELOW))
    out["rows"]["k7_capped"] = cap_rows
    print(json.dumps({
        "phase": "degree_cap", "card": card, "degree_bound": bound,
        "above_bit_identical_to_uncapped": same_cap, "below": CAP_BELOW,
        "below_overflow": ovf_b.tolist(), "below_forecast_launches": cap_fwd,
        "k7_by_set": cap_rows,
    }), flush=True)
    del below, g_cap
    torch.cuda.empty_cache()
    run_dir.cleanup()
    return out


def add_item9_paths(f32_entries, bf16_entries, item9: dict) -> None:
    """Adds phases 55-58 to the kernels line: each kernel's launches on
    the new paths (f32 entries their f32 launches, bf16 entries their bf16
    ones); K1 on a shared mesh beside a per-sample build
    (``shared_mesh``), K2, K2b, K3 and K4 on shared meshes per width
    (``shared_by_width``), and K7's rows on capped views (f32) and bf16
    messages (bf16) in ``by_operand_set``."""
    rows = item9["rows"]
    for dtype, entries in (("float32", f32_entries), ("bfloat16", bf16_entries)):
        for entry in entries:
            name = entry["name"].removesuffix("_bf16")
            for path, (f32, bf16) in item9["paths"].items():
                n = (f32 if dtype == "float32" else bf16).get(name, 0)
                if n:
                    entry["launches_by_path"][path] = n
            if name == "spmm_build_blocks" and dtype == "float32":
                entry["shared_mesh"] = rows["k1"]
            if name in ("spmm_apply", "spmm_apply_bwd"):
                entry["shared_by_width"] = [r for r in rows["k2"]
                                            if r["name"] == name and r["dtype"] == dtype]
            if name in ("attn_apply", "attn_apply_bwd") and dtype == "float32":
                entry["shared_by_width"] = [r for r in rows["k3_k4"] if r["name"] == name]
            if name == "segment_sum":
                entry["by_operand_set"] += (rows["k7_capped"] if dtype == "float32"
                                            else rows["k7_bf16_messages"])


# ---------------------------------------------------------------- data, eval, CNN-LSTM
# Phases 59-63: ROADMAP Queue 1 items 10 (data and eval) and 11 (the
# CNN-LSTM baseline family). The CNN-LSTM runs cli/ice_exp_cnnlstm.py
# experiment 0's widths (:25-45) on the flagship's 224×304 synthetic
# fields, but with one input channel and no climatology: the JAX package
# raises flax's ScopeParamShapeError at that CLI's five x_vars and with
# use_climatology=True (models/cnnlstm.py:197-207,
# train/cnn_predictor.py:86-93), and so does the port (a ValueError).
CNN_HIDDEN, CNN_LAYERS, CNN_KERNEL, CNN_DROPOUT, CNN_LR = 32, 2, 3, 0.1, 1e-3
CNN_TRAIN_STEPS = 3
CNN_SMALL = dict(shape=(16, 16), hidden=4, t_out=3)  # the card-vs-CPU parity size
CNN_WINDOWS = 3       # phase 60: 2 training windows and 1 test window
CNN_EVAL_MONTHS = (6, 9)  # phase 62: one IceDataset a launch month
CNN_EVAL_WINDOWS = 2  # forecasts a month
# phase 61: split thresholds on the June variance map of the synthetic siconc
# (0.004-0.026 over the valid pixels; 3e-2 splits no base cell)
MESH_THRESHOLDS = (5e-3, 1e-2, 2e-2, 3e-2)
MESH_RECON_TOL = 1e-6
# the kernel function names a torch.profiler trace shows for K1, K2/K2b
# (one kernel) and K7; the look-behind keeps PyTorch's
# multi_tensor_apply_kernel (Adam) out of apply_kernel
TRACE_KERNELS = {
    "spmm_build_blocks": r"(?<![A-Za-z_])build_blocks_kernel",
    "spmm_apply+spmm_apply_bwd": r"(?<![A-Za-z_])apply_kernel",
    "segment_sum": r"(?<![A-Za-z_])segment_(spans|sum)_kernel",
}


def make_cnn_model(seed: int, run_dir: str = "runs", dtype: str = "float32", shape=None,
                   hidden: int = CNN_HIDDEN, t_out: Optional[int] = None,
                   dropout: float = CNN_DROPOUT, teacher_forcing_ratio: float = 0.5,
                   device: Optional[str] = None):
    """The CNN-LSTM forecaster of ``cli/ice_exp_cnnlstm.py`` experiment 0
    (hidden 32, 2 layers, kernel 3, dropout 0.1, T_in 10 → T_out 90,
    teacher forcing 0.5) on one input channel (siconc), without
    climatology; random weights from ``seed``."""
    from quadtree_mpnnlstm_tpu_torch.train.cnn_predictor import NextFramePredictorCNNLSTM

    return NextFramePredictorCNNLSTM(
        image_shape=ICE_SHAPE if shape is None else shape, experiment_name="cnnlstm",
        input_features=1, hidden_size=hidden, input_timesteps=ICE_T_IN,
        output_timesteps=ICE_T_OUT if t_out is None else t_out, n_layers=CNN_LAYERS,
        dropout=dropout, kernel_size=CNN_KERNEL, teacher_forcing_ratio=teacher_forcing_ratio,
        device=DEVICE if device is None else device, use_climatology=False, seed=seed,
        compute_dtype=dtype, run_dir=run_dir)


def cnn_ice_data(seed: int, month: int = ICE_MONTH):
    """(IceDataset test windows of ``month`` with siconc as the only input
    and output, the synthetic GriddedDataset, mask) from the synthetic
    fields of 2016 and the ice mask, as :func:`ice_data` makes them."""
    from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import (
        IceDataset,
        ice_mask,
        synthetic_dataset,
    )

    ds, band = synthetic_dataset(shape=ICE_SHAPE, years=(2016, 2017), seed=seed)
    data = IceDataset(ds, [2016], month, ICE_T_IN, ICE_T_OUT, ["siconc"], ["siconc"])
    return data, ds, ice_mask(ICE_SHAPE, seed) | band


def expected_mesh_design_k7(n_meshes: int) -> int:
    """K7 launches of ``n_meshes`` ``design_mesh`` calls, read from the
    code: each edge-list quadtree build sums its node counts, pools the
    map (and the positional channels) onto the nodes and sums its
    degrees (``compute_sym_norm``); the reconstruction's ``unflatten`` is a
    gather, whose backward alone would sum."""
    return 3 * n_meshes


def item10_11_phases(seed: int, card: str, spmm, attn, grid_attn, segment, segment_sum,
                     loader, x) -> dict:
    """Phases 59-63; returns what the kernels line adds: K7's rows on the
    mesh-design sets and its launches there, and each kernel's launches in
    the profiled step of phase 63."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import (ArrayDataset, DataLoader,
                                                         prefetch_to_device)
    from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import IceDataset, climatology_from_dataset
    from quadtree_mpnnlstm_tpu_torch.eval import mesh_design, results, trace_summary
    from quadtree_mpnnlstm_tpu_torch.models.cells import deterministic_cudnn
    from quadtree_mpnnlstm_tpu_torch.train.losses import masked_mse

    run_dir = tempfile.TemporaryDirectory()
    modules = (spmm, attn, grid_attn, segment_sum)
    out = {}

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def launched():
        return {k: v for k, v in launch_totals(modules).items() if v}

    # ---- phase 59: the CNN-LSTM at experiment 0's widths, f32 and bf16
    data, ds, mask = cnn_ice_data(seed)
    x0, y0 = data.x[:1], data.y[:1]
    m_dev = torch.as_tensor(mask, device=DEVICE)
    reset()
    runs = {}
    for dtype in ("float32", "bfloat16"):
        trainer = make_cnn_model(seed, run_dir.name, dtype)
        trainer.forecast(x0, mask)  # warm-up (cuDNN's first calls, the allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        y_hat = trainer.forecast(x0, mask)
        torch.cuda.synchronize()
        forecast_s = time.perf_counter() - t0
        forecast_peak = (torch.cuda.max_memory_allocated() - start) / 2**30
        check(y_hat.shape == (1, ICE_T_OUT, *ICE_SHAPE, 1) and y_hat.dtype == torch.float32,
              f"CNN-LSTM {dtype} forecast {tuple(y_hat.shape)} {y_hat.dtype}")
        check(bool(torch.isfinite(y_hat).all()), f"non-finite CNN-LSTM {dtype} forecast")
        check(bool((y_hat[:, :, m_dev] == 0).all()), "masked pixels are not 0")
        trainer.initiate_training(CNN_LR, 0.95)
        trainer.train_step(x0, y0, mask)  # warm-up
        peak = peak_above_start_gib(lambda: trainer.train_step(x0, y0, mask))
        t0 = time.perf_counter()
        losses, pending = [], None
        for _ in range(CNN_TRAIN_STEPS):
            loss = trainer.train_step(x0, y0, mask)
            if pending is not None:
                losses.append(float(pending))
            pending = loss
        losses.append(float(pending))
        step_s = (time.perf_counter() - t0) / CNN_TRAIN_STEPS
        check(bool(np.isfinite(losses).all()), f"CNN-LSTM {dtype} losses {losses}")
        check(all(p.dtype == torch.float32 for p in trainer.model.parameters()),
              "the CNN-LSTM's masters are not f32")
        runs[dtype] = dict(s_per_forecast=forecast_s, forecast_peak_above_start_gib=forecast_peak,
                           s_per_train_step=step_s, train_steps=CNN_TRAIN_STEPS,
                           step_peak_above_start_gib=peak, losses=losses,
                           n_params=trainer.get_n_params())
        del trainer, y_hat
        torch.cuda.empty_cache()
    big = launched()
    check(not big, f"the CNN-LSTM launched graph kernels: {big}")

    # the card against the port on the CPU at a small size (TF32 is off)
    rows, cols = CNN_SMALL["shape"]
    small = dict(shape=CNN_SMALL["shape"], hidden=CNN_SMALL["hidden"], t_out=CNN_SMALL["t_out"],
                 dropout=0.0, teacher_forcing_ratio=1.0)
    r0, c0 = (ICE_SHAPE[0] - rows) // 2, (ICE_SHAPE[1] - cols) // 2
    crop = (slice(r0, r0 + rows), slice(c0, c0 + cols))
    xs = np.ascontiguousarray(data.x[:2, :, crop[0], crop[1]])
    ys = np.ascontiguousarray(data.y[:2, :CNN_SMALL["t_out"], crop[0], crop[1]])
    ms = mask[crop]
    pair = [make_cnn_model(seed, run_dir.name, device=dev, **small) for dev in (DEVICE, "cpu")]
    f_card, f_cpu = (p.forecast(xs, ms).cpu() for p in pair)
    forecast_err = float((f_card - f_cpu).abs().max())
    check(forecast_err <= ROLLOUT_TOL, f"CNN-LSTM forecast: card vs CPU {forecast_err}")
    grads = []
    for p in pair:
        model = p.model.train()
        with deterministic_cudnn():
            y_hat = model(p._tensor(xs), p._tensor(ys), None, p._mask(ms), p.generator)
            loss = masked_mse(y_hat, p._tensor(ys), p._mask(ms)).mean()
            loss.backward()
        grads.append({n: q.grad.detach().cpu() for n, q in model.named_parameters()})
        grads[-1].update({n: b.detach().cpu() for n, b in model.named_buffers()
                          if n.endswith((".mean", ".var"))})
    scale = max(1.0, max(float(g.abs().max()) for n, g in grads[1].items()
                         if not n.endswith((".mean", ".var"))))
    grad_err = max(float((grads[0][n] - grads[1][n]).abs().max()) for n in grads[1]
                   if not n.endswith((".mean", ".var")))
    stats_err = max(float((grads[0][n] - grads[1][n]).abs().max()) for n in grads[1]
                    if n.endswith((".mean", ".var")))
    check(grad_err <= GRAD_TOL * scale, f"CNN-LSTM gradients: card vs CPU {grad_err}")
    check(stats_err <= K2_TOL, f"CNN-LSTM running statistics: card vs CPU {stats_err}")
    del pair
    check(not launched(), f"the CNN-LSTM launched graph kernels: {launched()}")
    print(json.dumps({
        "phase": "cnnlstm", "card": card, "grid": ICE_SHAPE, "t_in": ICE_T_IN,
        "t_out": ICE_T_OUT, "batch": 1, "hidden": CNN_HIDDEN, "n_layers": CNN_LAYERS,
        "kernel_size": CNN_KERNEL, "dropout": CNN_DROPOUT, "lr": CNN_LR,
        "differs_from_ice_exp_cnnlstm": "x_vars ['siconc'] (one input channel) and "
        "use_climatology=False: the JAX package raises ScopeParamShapeError on the CLI's "
        "five x_vars and with climatology, and the port raises ValueError",
        "runs": runs, "graph_kernel_launches": big,
        "small_vs_cpu": dict(CNN_SMALL, forecast_max_abs_err=forecast_err,
                             grad_max_abs_err=grad_err, grad_scale=scale,
                             running_stats_max_abs_err=stats_err),
    }), flush=True)

    # ---- phase 60: prefetch_to_device feeds the trainer as the plain loader does
    windows = ArrayDataset(data.x[:CNN_WINDOWS], data.y[:CNN_WINDOWS],
                           data.launch_dates[:CNN_WINDOWS])
    train_set = ArrayDataset(windows.x[:2], windows.y[:2], windows.launch_dates[:2])
    test_set = ArrayDataset(windows.x[2:], windows.y[2:], windows.launch_dates[2:])
    fed = list(prefetch_to_device(DataLoader(windows), device=DEVICE))
    check(len(fed) == CNN_WINDOWS and all(a.is_cuda and b.is_cuda and isinstance(c, np.ndarray)
                                          for a, b, c in fed),
          "prefetch_to_device did not yield CUDA x, y and host launch dates")
    check(all(np.array_equal(a.cpu().numpy(), windows.x[i:i + 1])
              and np.array_equal(b.cpu().numpy(), windows.y[i:i + 1])
              for i, (a, b, _) in enumerate(fed)), "prefetched batches differ from the loader's")
    del fed
    epochs = []
    for fetch in (False, True):
        trainer = make_cnn_model(seed, run_dir.name)
        start_state = trainer.generator.get_state()
        train_l, test_l = DataLoader(train_set), DataLoader(test_set)
        if fetch:
            train_l = prefetch_to_device(train_l, device=DEVICE)
            test_l = prefetch_to_device(test_l, device=DEVICE)
        t0 = time.perf_counter()
        trainer.train(train_l, test_l, n_epochs=1, lr=CNN_LR, mask=mask)
        torch.cuda.synchronize()
        epochs.append(dict(seconds=time.perf_counter() - t0, train_loss=trainer.train_loss,
                           test_loss=trainer.test_loss, start=start_state,
                           end=trainer.generator.get_state(),
                           state={k: v.detach().clone() for k, v in
                                  trainer.model.state_dict().items()}))
        del trainer
    same = (epochs[0]["train_loss"] == epochs[1]["train_loss"]
            and epochs[0]["test_loss"] == epochs[1]["test_loss"]
            and torch.equal(epochs[0]["start"], epochs[1]["start"])
            and torch.equal(epochs[0]["end"], epochs[1]["end"])
            and all(torch.equal(v, epochs[1]["state"][k]) for k, v in epochs[0]["state"].items()))
    check(same, "an epoch through prefetch_to_device differs from the plain loader's")
    check(not launched(), f"the CNN-LSTM launched graph kernels: {launched()}")
    print(json.dumps({
        "phase": "prefetch_to_device", "card": card, "train_windows": 2, "test_windows": 1,
        "bit_identical": same, "train_loss": epochs[0]["train_loss"],
        "test_loss": epochs[0]["test_loss"],
        "epoch_s": {"plain": epochs[0]["seconds"], "prefetch": epochs[1]["seconds"]},
    }), flush=True)
    del epochs
    torch.cuda.empty_cache()

    # ---- phase 61: mesh design at 224×304 on the card
    varmap = mesh_design.seasonal_variance(ds.variables["siconc"], ds.times, ICE_MONTH)
    reset()
    t0 = time.perf_counter()
    table = mesh_design.sweep_meshes(varmap, mask, MESH_THRESHOLDS, device=DEVICE)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = launched()
    want_k7 = expected_mesh_design_k7(len(MESH_THRESHOLDS))
    check(sweep_launches == {"segment_sum": want_k7},
          f"mesh design launches {sweep_launches}, expected K7 {want_k7}")
    designs, flips = [], []
    for thresh in MESH_THRESHOLDS:
        g_card, r_card, n_card = mesh_design.design_mesh(varmap, mask, thresh, device=DEVICE)
        g_cpu, r_cpu, n_cpu = mesh_design.design_mesh(varmap, mask, thresh, device="cpu")
        same_mesh = torch.equal(g_card.pixel_node.cpu(), g_cpu.pixel_node)
        if not same_mesh:
            # a cell that flips: its criterion (the cell's max) on both devices
            diff = (g_card.pixel_node.cpu() != g_cpu.pixel_node)[0].reshape(ICE_SHAPE)
            i, j = (int(v) for v in torch.nonzero(diff)[0])
            base = 4
            cell = varmap[i // base * base:(i // base + 1) * base,
                          j // base * base:(j // base + 1) * base]
            flips.append(dict(thresh=thresh, pixel=[i, j], cell_max=float(cell.max()),
                              n_nodes=[n_card, n_cpu]))
            print(json.dumps({"phase": "mesh_design_flip", "card": card, **flips[-1]}),
                  flush=True)
            continue
        err = float(np.abs(r_card - r_cpu).max())
        check(n_card == n_cpu == table[thresh] and err <= MESH_RECON_TOL,
              f"mesh design at {thresh}: nodes {n_card} / {n_cpu} / {table[thresh]}, "
              f"reconstruction {err}")
        designs.append(dict(thresh=thresh, n_nodes=n_card, recon_max_abs_err=err))
    check(all(abs(f["cell_max"] - f["thresh"]) <= 1e-7 for f in flips),
          f"meshes differ away from the split threshold: {flips}")
    check(len({d["n_nodes"] for d in designs}) > 1, f"the thresholds give one mesh: {designs}")
    # K7 on one design's sets (node counts, pooling, degrees), timed
    cap = SegmentCapture(segment, ICE_SHAPE[0] * ICE_SHAPE[1], keep=True, counts=True)
    with cap:
        mesh_design.design_mesh(varmap, mask, MESH_THRESHOLDS[1], device=DEVICE)
    k7_rows = [dict(k7_measure(segment_sum, key, ops, cap.calls[key]),
                    thresh=MESH_THRESHOLDS[1]) for key, ops in sorted(cap.ops.items())]
    check(sum(cap.calls.values()) == expected_mesh_design_k7(1),
          f"one design's K7 calls {cap.calls}")
    out["mesh_design"] = dict(rows=k7_rows, launches=sweep_launches["segment_sum"])
    print(json.dumps({
        "phase": "mesh_design", "card": card, "grid": ICE_SHAPE, "month": ICE_MONTH,
        "thresholds": list(MESH_THRESHOLDS), "n_nodes": {str(k): v for k, v in table.items()},
        "designs_vs_cpu": designs, "flips": flips, "sweep_s": sweep_s,
        "launches": sweep_launches, "k7_by_set": k7_rows,
    }), flush=True)

    # ---- phase 62: eval of f32 forecasts of two launch months
    trainer = make_cnn_model(seed, run_dir.name)
    y_hat, y_true, lds = [], [], []
    for month in CNN_EVAL_MONTHS:
        month_data = IceDataset(ds, [2016], month, ICE_T_IN, ICE_T_OUT, ["siconc"], ["siconc"])
        check(len(month_data) >= 10 + CNN_EVAL_WINDOWS, f"month {month}: {len(month_data)} windows")
        # mid-month windows: a launch date's month reads local time
        pick = slice(10, 10 + CNN_EVAL_WINDOWS)
        sub = ArrayDataset(month_data.x[pick], month_data.y[pick], month_data.launch_dates[pick])
        y_hat.append(trainer.predict(DataLoader(sub), mask=mask))
        y_true.append(sub.y)
        lds.append(sub.launch_dates)
    y_hat, y_true, lds = (np.concatenate(a) for a in (y_hat, y_true, lds))
    del trainer
    clim = climatology_from_dataset(ds, "siconc")
    t0 = time.perf_counter()
    heat = results.create_heatmap(y_hat, y_true, lds, mask)
    pers = results.persistence_heatmap(y_true, lds, mask)
    clim_heat = results.climatology_heatmap(y_true, lds, clim, mask)
    report_dir = tempfile.TemporaryDirectory()
    report = results.full_report(y_hat, y_true, lds, mask, clim, report_dir.name)
    eval_s = time.perf_counter() - t0
    rows_of = sorted({m - 1 for m in CNN_EVAL_MONTHS})
    others = [r for r in range(12) if r not in rows_of]
    written = sorted(os.listdir(report_dir.name))
    for name in ("heatmap.csv", "heatmap_clim.csv"):
        check(name in written, f"full_report wrote no {name}: {written}")
        csv = np.loadtxt(os.path.join(report_dir.name, name), delimiter=",")
        check(csv.shape == (12, ICE_T_OUT) and np.isfinite(csv[rows_of]).all()
              and np.isnan(csv[others]).all(),
              f"{name}: finite rows {np.nonzero(np.isfinite(csv).all(1))[0].tolist()}")
    check(np.array_equal(report, heat, equal_nan=True), "full_report's heatmap differs")
    for h in (pers, clim_heat):
        check(np.isfinite(h[rows_of]).all() and np.isnan(h[others]).all(),
              "a baseline heatmap's finite rows are not the launch months'")
    print(json.dumps({
        "phase": "eval_report", "card": card, "months": list(CNN_EVAL_MONTHS),
        "forecasts": int(len(y_hat)), "files": written, "eval_s": eval_s,
        "rmse_mean": {"model": float(np.nanmean(heat)), "persistence": float(np.nanmean(pers)),
                      "climatology": float(np.nanmean(clim_heat))},
    }), flush=True)
    report_dir.cleanup()
    del y_hat, y_true

    # ---- phase 63: trace_summary of a profiled forecast and train step
    trainer = make_trainer(seed, run_dir.name)
    _, batches = train_batches(seed, 1)
    xb, yb = batches[0]
    trainer.forecast(x)  # warm-up
    trainer.train_step(xb, yb)
    torch.cuda.synchronize()
    trace_dir = tempfile.TemporaryDirectory()
    reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir.name)):
        trainer.forecast(x)
        trainer.train_step(xb, yb)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    counters = launched()
    rows = trace_summary.summarize_trace(trace_dir.name, top=10**9)
    check(rows and all(r.plane == "kernel" for r in rows), "the trace holds no device kernel")
    traced = {key: sum(r.count for r in rows if re.search(pattern, r.name))
              for key, pattern in TRACE_KERNELS.items()}
    want = {"spmm_build_blocks": counters.get("spmm_build_blocks", 0),
            "spmm_apply+spmm_apply_bwd": counters.get("spmm_apply", 0)
            + counters.get("spmm_apply_bwd", 0),
            "segment_sum": counters.get("segment_sum", 0)}
    check(traced == want and all(want.values()),
          f"trace rows {traced} against the launch counters {counters}")
    out["traced"] = {k: counters.get(k, 0) for k in ("spmm_build_blocks", "spmm_apply",
                                                     "spmm_apply_bwd", "segment_sum")}
    print(json.dumps({
        "phase": "trace_summary", "card": card, "path": "ChebConv f32 batch 16, remat none: "
        "one forecast and one train step", "traced_s": traced_s, "trace_rows": traced,
        "counters": counters,
        # K2 and K2b are one kernel: the counters split its trace rows
        "k2_from_trace": traced["spmm_apply+spmm_apply_bwd"] - counters.get("spmm_apply_bwd", 0),
        "kernels": len(rows), "kernel_launches": sum(r.count for r in rows),
        "busy_ms": sum(r.total_ms for r in rows),
        "top": [r._asdict() for r in rows[:8]],
    }), flush=True)
    trace_dir.cleanup()
    del trainer
    torch.cuda.empty_cache()
    return out


def add_item10_11_paths(f32_entries, item10: dict) -> None:
    """Adds phases 61 and 63 to the kernels line: K7's mesh-design sets in
    ``by_operand_set`` and its launches on the sweep, and each kernel's
    launches in the profiled forecast and step (``launches_by_path``)."""
    for entry in f32_entries:
        name = entry["name"]
        if name == "segment_sum":
            entry["by_operand_set"] += [dict(w, path="mesh_design")
                                        for w in item10["mesh_design"]["rows"]]
            entry["launches_by_path"]["mesh_design_sweep"] = item10["mesh_design"]["launches"]
            entry["ms_by_path"]["mesh_design"] = k7_path_means(item10["mesh_design"]["rows"])
        if name in item10["traced"]:
            entry["launches_by_path"]["profiled_forecast_and_step"] = item10["traced"][name]


# ---------------------------------------------------------------- items 12-13
# Data parallelism (phases 64-65) on bench.py's model, and the CLIs and the
# native host toolkit (phases 66-73), each through its entry point.
DP_WORLD, DP_STEPS = 2, 2  # two gloo ranks sharing the card, 8 samples each
DP_LOSS_RTOL, DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-5, 1e-4, 1e-6  # tests/test_parallel.py
DP_GRAD_RTOL = 1e-4  # × each parameter tensor's largest gradient
CLI_MONTH, CLI_T_OUT, CLI_YEARS = 6, 10, 2
# batches: the flagship's 92 training windows of a month in 12 and 8 steps
CLI_BATCH, CLI_PRESET_BATCH, NWT_BATCH, PROFILE_BATCH = 8, 12, 64, 16
# T_out 3: random weights' longer rollouts trip the demo's divergence guard
MNIST_DEMO = ["--canvas", "64", "--digit", "18", "--train-samples", "16", "--epochs", "1",
              "--batch-size", "16", "--t-out", "3", "--sweep-thresholds"]


def make_dp_model(seed: int, run_dir: str, dropout: float, dp_devices: int = 1,
                  device: Optional[str] = None):
    """:func:`make_model`'s configuration (``bench.py``'s model, f32, no
    remat) with attention-free ChebConv, ``dropout`` and ``dp_devices``."""
    from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

    return NextFramePredictorS2S(
        image_shape=CANVAS, thresh=0.1, input_features=1, input_timesteps=T_IN,
        output_timesteps=T_OUT, device=device or DEVICE, seed=seed, run_dir=run_dir,
        dp_devices=dp_devices,
        model_kwargs=dict(hidden_size=16, n_layers=2, n_conv_layers=2,
                          convolution_type="ChebConv", dropout=dropout, remat=False),
        graph_kwargs=dict(max_grid_size=8, n_max=2048, e_max=10240, node_budget=2048,
                          agg_eb=1024, agg_sw=1024, aggregation="pallas"))


def dp_steps(model, batches) -> dict:
    """``train_step`` on each global batch: the losses, each step's
    clipped gradients and the final weights (host arrays), each step's s
    (synced), the last step's kernel launches, and each all-reduce's ms
    (CUDA events around ``parallel/dp.py`` ``all_reduce_step``) and bytes."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum, spmm
    from quadtree_mpnnlstm_tpu_torch.parallel import dp

    reduce_ms, reduce_bytes = [], []
    real = dp.all_reduce_step

    def timed(params, loss, overflow):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(params, loss, overflow)
        end.record()
        end.synchronize()
        reduce_ms.append(start.elapsed_time(end))
        reduce_bytes.append(4 * (sum(p.grad.numel() for p in params if p.grad is not None) + 1))
        return out

    losses, grads, step_s = [], [], []
    with mock.patch.object(dp, "all_reduce_step", timed):
        for xb, yb in batches:
            spmm.reset_launch_counts()
            segment_sum.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, overflow = model.train_step(xb, yb)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            check(int(overflow) == 0, f"data-parallel step overflow {int(overflow)}")
            losses.append(float(loss))
            grads.append(torch.cat([p.grad.reshape(-1) for p in model.model.parameters()])
                         .cpu().numpy())
    launches = {k: v for k, v in {**spmm.LAUNCHES, **segment_sum.LAUNCHES}.items() if v}
    params = torch.cat([p.detach().reshape(-1) for p in model.model.parameters()]).cpu().numpy()
    return dict(losses=losses, grads=grads, params=params, step_s=step_s, launches=launches,
                reduce_ms=reduce_ms, reduce_bytes=reduce_bytes,
                sizes=[p.numel() for p in model.model.parameters()])


def dp_rank(rank: int, device, seed: int, run_dir: str, dropouts) -> dict:
    """One data-parallel rank (``parallel/dp.py`` ``launch``): bench.py's
    model with ``dp_devices`` the group's size, two steps of the global
    batches at each dropout rate, each kernel held against its plain
    version on the rank's shard; whether every rank ends with rank 0's
    weights; and every rank's first draw for its shard from ``seed``."""
    import torch
    import torch.distributed as dist

    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn, segment_sum, spmm
    from quadtree_mpnnlstm_tpu_torch.utils import draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size()
    _, batches = train_batches(seed, DP_STEPS)
    out = {}
    for dropout in dropouts:
        model = make_dp_model(seed, run_dir, dropout, world, str(device))
        model.initiate_training(lr=LR, lr_decay=0.95)
        with HoldCapture(held_launchers(spmm, grid_attn, segment_sum)) as held:
            run = dp_steps(model, batches)
        # each kernel on the rank's shard, after the steps' launches were read
        run["held"] = held.hold(f"rank {rank}")
        mine = torch.as_tensor(run["params"], device=device)
        theirs = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(theirs, mine)
        run["replicas_equal"] = all(torch.equal(theirs[0], t) for t in theirs)
        out[dropout] = run
    gen = torch.Generator(device=device).manual_seed(seed)
    with draws.batch_shard(rank, world):
        u = draws.uniform((BATCH // world, 64), gen, device)
    us = [torch.empty_like(u) for _ in range(world)]
    dist.all_gather(us, u)
    out["draws"] = [t.cpu().numpy() for t in us]
    return out


def dp_compare(got: dict, ref: dict) -> dict:
    """A data-parallel run against the one-process run: the losses within
    ``tests/test_parallel.py``'s rtol 1e-5; each step's gradients at the
    port's gradient tolerance (≤1e-4 × max(1, max|g|)), and the first
    step's, where both runs start from the same weights and differ only
    in the order of their sums, per parameter tensor within 1e-4 of the
    tensor's largest (never tighter than 2⁻²³ of the step's largest, the
    f32 rounding of its sums: a tensor whose gradient is zero but for
    rounding); every weight within that file's rtol 1e-4 / atol 1e-6 plus
    twice Adam's first-order response to the measured gradient difference
    (:func:`adam_response`), since Adam divides each entry's step by the
    entry's own gradient and so passes a rounding of a small gradient on
    as a share of lr."""
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], ref["losses"]))
    g, r = np.asarray(got["grads"], np.float64), np.asarray(ref["grads"], np.float64)
    gp, rp = got["params"], ref["params"]
    grad_ratio, start = 0.0, 0
    for n in ref["sizes"]:
        allow = max(DP_GRAD_RTOL * np.abs(r[0, start:start + n]).max(),
                    2.0**-23 * np.abs(r[0]).max())
        diff = np.abs(g[0, start:start + n] - r[0, start:start + n]).max()
        grad_ratio, start = max(grad_ratio, float(diff / allow)), start + n
    response = adam_response(g, r, LR)
    err = np.abs(gp - rp)
    param_ratio = float((err / (DP_PARAM_ATOL + DP_PARAM_RTOL * np.abs(rp)
                                + 2 * response)).max())
    out = dict(loss_max_rel_err=loss_err, grad_max_abs_err=float(np.abs(g - r).max()),
               first_grad_err_over_tol=grad_ratio, param_max_abs_err=float(err.max()),
               param_err_over_tol=param_ratio,
               adam_response_max=float(response.max()),
               entries_beyond_rtol_atol=int((err > DP_PARAM_ATOL
                                             + DP_PARAM_RTOL * np.abs(rp)).sum()),
               entries=int(err.size))
    check(loss_err <= DP_LOSS_RTOL, f"data-parallel loss {got['losses']} vs {ref['losses']}")
    for step, (gs, rs) in enumerate(zip(g, r)):
        step_err = float(np.abs(gs - rs).max())
        check(step_err <= GRAD_TOL * max(1.0, float(np.abs(rs).max())),
              f"data-parallel gradients off by {step_err} at step {step}")
    check(grad_ratio <= 1, f"data-parallel first gradients off: {out}")
    check(param_ratio <= 1, f"data-parallel weights off: {out}")
    return out


def adam_response(g, r, lr: float, eps: float = 1e-8):
    """Adam's first-order response to the gradients ``g`` in place of
    ``r`` (steps × entries, β 0.9/0.999): step t's update m̂/(√v̂ + ε)
    moves by at most about Σ_{s≤t} |g_s − r_s| / (√v̂_t + ε), for m̂ is a
    weighted mean of the gradients so far and √v̂ their weighted root mean
    square; lr times the sum over the steps."""
    diff = np.abs(np.asarray(g, np.float64) - np.asarray(r, np.float64))
    v = np.zeros(diff.shape[1])
    acc, out = np.zeros_like(v), np.zeros_like(v)
    for t, rt in enumerate(np.asarray(r, np.float64)):
        v = 0.999 * v + 0.001 * rt ** 2
        acc += diff[t]
        out += lr * acc / (np.sqrt(v / (1 - 0.999 ** (t + 1))) + eps)
    return out


def _window_batches(years, month: int, t_in: int, t_out: int, batch: int, train: bool = False,
                    data_years: int = CLI_YEARS):
    """Batches of an IceDataset of ``years`` × ``month`` at ``batch`` over
    ``data_years`` synthetic years from 2007: the window count depends on
    the dates alone, so a 2×2 field gives it."""
    from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import IceDataset, synthetic_dataset

    ds, _ = synthetic_dataset(shape=(2, 2), years=(2007, 2007 + data_years))
    n = len(IceDataset(ds, years, month, t_in, t_out, ["siconc"], ["siconc"], train=train))
    return -(-n // batch)


def item12_13_phases(seed: int, card: str, spmm, attn, grid_attn, segment_sum) -> dict:
    """Phases 64-73; returns each kernel's launches on the new paths for
    the kernels line."""
    import types

    import torch

    from quadtree_mpnnlstm_tpu_torch.cli import (
        ice_exp,
        ice_exp_cnnlstm,
        ice_exp_nwt,
        ice_inf,
        ice_profile,
        mnist_demo,
    )
    from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import synthetic_dataset
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
    from quadtree_mpnnlstm_tpu_torch.eval import trace_summary
    from quadtree_mpnnlstm_tpu_torch.parallel import dp

    run_dir = tempfile.TemporaryDirectory()
    modules = (spmm, attn, grid_attn, segment_sum)
    launchers = held_launchers(spmm, grid_attn, segment_sum)
    out = {}

    def reset():
        for m in modules:
            m.reset_launch_counts()

    def launched():
        return {k: v for k, v in launch_totals(modules).items() if v}

    # ---- phase 64: two gloo ranks on the card against one process
    _, batches = train_batches(seed, DP_STEPS)
    ref = {}
    for dropout in (0.0, 0.1):
        model = make_dp_model(seed, run_dir.name, dropout)
        model.initiate_training(lr=LR, lr_decay=0.95)
        ref[dropout] = dp_steps(model, batches)
        want = expected_launches(model.cfg)
        check(ref[dropout]["launches"] == want,
              f"one-process step launches {ref[dropout]['launches']}, expected {want}")
        del model
    t0 = time.perf_counter()
    ranks = dp.launch(dp_rank, DP_WORLD, backend="gloo", device="cuda:0",
                      args=(seed, run_dir.name, (0.0, 0.1)), timeout=600)
    gloo_s = time.perf_counter() - t0
    rows = {}
    for dropout in (0.0, 0.1):
        got = ranks[dropout]
        check(got["replicas_equal"], f"the ranks' weights differ (dropout {dropout})")
        check(got["launches"] == want,
              f"a rank's step launches {got['launches']}, expected {want}")
        rows[str(dropout)] = dict(dp_compare(got, ref[dropout]), held_rank0=got["held"],
                                  rank_step_s=got["step_s"],
                                  one_process_step_s=ref[dropout]["step_s"],
                                  allreduce_ms=got["reduce_ms"],
                                  allreduce_bytes=got["reduce_bytes"][0])
    # each rank draws the global batch's rows of its shard, no two alike
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    u = torch.rand((BATCH, 64), generator=gen, device=DEVICE).cpu().numpy()
    per = BATCH // DP_WORLD
    for r, drawn in enumerate(ranks["draws"]):
        check(np.array_equal(drawn, u[r * per:(r + 1) * per]),
              f"rank {r}'s draws are not the global batch's rows")
    check(not np.array_equal(ranks["draws"][0], ranks["draws"][1]), "the ranks share a mask")
    out["dp_rank_step"] = want
    print(json.dumps({
        "phase": "dp_gloo", "card": card, "world": DP_WORLD, "backend": "gloo",
        "global_batch": BATCH, "steps": DP_STEPS, "by_dropout": rows,
        "rank_launches_a_step": want, "launch_s": gloo_s,
        "masks": "each rank's draws are the global batch's rows of its shard",
    }), flush=True)

    # ---- phase 65: one NCCL rank, bit for bit the one-process step
    t0 = time.perf_counter()
    nccl = dp.launch(dp_rank, 1, backend="nccl", args=(seed, run_dir.name, (0.0,)), timeout=600)
    nccl_s = time.perf_counter() - t0
    got = nccl[0.0]
    check(got["losses"] == ref[0.0]["losses"]
          and all(np.array_equal(a, b) for a, b in zip(got["grads"], ref[0.0]["grads"]))
          and np.array_equal(got["params"], ref[0.0]["params"]),
          "one NCCL rank differs from the one-process step")
    check(got["launches"] == want, f"NCCL rank launches {got['launches']}")
    print(json.dumps({
        "phase": "dp_nccl", "card": card, "world": 1, "backend": "nccl",
        "bit_identical": True, "rank_step_s": got["step_s"],
        "one_process_step_s": ref[0.0]["step_s"], "allreduce_ms": got["reduce_ms"],
        "allreduce_bytes": got["reduce_bytes"][0], "launch_s": nccl_s, "held": got["held"],
    }), flush=True)
    del ref, ranks, nccl
    torch.cuda.empty_cache()

    # ---- phase 66: ice_exp experiment 0 at the flagship's widths
    res0 = tempfile.TemporaryDirectory()
    data_args = ["--synthetic", "--shape", *map(str, ICE_SHAPE), "--t-out", str(CLI_T_OUT),
                 "--synthetic-years", str(CLI_YEARS), "--batch-size", str(CLI_BATCH),
                 "--device", DEVICE]
    # random weights: the divergence guard's default bound (4) does not apply
    argv = ["-m", str(CLI_MONTH), "-e", "0", *data_args, "--epochs", "1",
            "--max-loss", "1e30", "--results-dir", res0.name]
    cfg0 = ice_exp.experiment_config(0)
    years = range(2007, 2007 + CLI_YEARS - 1)  # the CLI's clamp at 2 synthetic years
    name = ice_exp.experiment_name(CLI_MONTH, years, cfg0["input_timesteps"], CLI_T_OUT)
    t_in = cfg0["input_timesteps"]
    windows = _window_batches([years[-1] + 1], CLI_MONTH, t_in, CLI_T_OUT, 1)
    nb = dict(train=_window_batches(years, CLI_MONTH, t_in, CLI_T_OUT, CLI_BATCH, train=True),
              test=_window_batches([years[-1] + 1], CLI_MONTH, t_in, CLI_T_OUT, CLI_BATCH),
              val=_window_batches([years[-1] + 1], CLI_MONTH, t_in, CLI_T_OUT, CLI_BATCH))
    per = expected_grid_launches(types.SimpleNamespace(n_layers=1, n_conv_layers=3,
                                                       output_timesteps=CLI_T_OUT))
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with HoldCapture(launchers) as held:
        run0 = ice_exp.main(argv)
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0
    got = launched()
    peak0 = torch.cuda.max_memory_allocated() / 2**30
    # remat (the predictor's default) replays a step's forward: 2 K5 a call
    want0 = {"grid_attn_apply": per * (2 * nb["train"] + nb["test"] + nb["val"]),
             "grid_attn_apply_bwd": per * nb["train"]}
    check(got == want0, f"ice_exp -e 0 launches {got}, expected {want0}")
    files = sorted(os.listdir(res0.name))
    check(files == sorted([f"{name}.pt", f"loss_{name}.json", f"valpredictions_{name}.npz"]),
          f"ice_exp -e 0 wrote {files}")
    loss = json.load(open(os.path.join(res0.name, f"loss_{name}.json")))
    check(np.isfinite(loss["train_loss"]).all() and np.isfinite(loss["test_loss"]).all(),
          f"ice_exp -e 0 loss {loss}")
    saved = dict(np.load(run0["predictions"]))
    check(saved["y_hat"].shape == (windows, CLI_T_OUT, *ICE_SHAPE, 1)
          and np.isfinite(saved["y_hat"]).all(), "ice_exp -e 0 predictions")
    out["ice_exp_e0"] = got
    print(json.dumps({
        "phase": "cli_ice_exp_e0", "card": card, "argv": argv[:-1], "wall_s": wall0,
        "batch": CLI_BATCH,
        "batches": nb, "launches": got, "files": files, "loss": loss,
        "peak_gib": peak0, "held": held.hold("ice_exp -e 0"),
    }), flush=True)

    # ---- phase 67: ice_inf on those weights, bit for bit
    reset()
    t0 = time.perf_counter()
    with HoldCapture(launchers) as held:
        inf = ice_inf.main(["-m", str(CLI_MONTH), "-e", "0", *data_args,
                            "--results-dir", res0.name])
    torch.cuda.synchronize()
    wall_inf = time.perf_counter() - t0
    check(np.array_equal(inf["val_predictions"], saved["y_hat"]),
          "ice_inf's predictions differ from ice_exp's")
    again = np.load(inf["predictions"])
    check(all(np.array_equal(again[k], saved[k]) for k in saved), "ice_inf's file differs")
    got = launched()
    check(got == {"grid_attn_apply": per * nb["val"]}, f"ice_inf launches {got}")
    out["ice_inf"] = got
    print(json.dumps({"phase": "cli_ice_inf", "card": card, "wall_s": wall_inf,
                      "bit_identical": True, "launches": got,
                      "held": held.hold("ice_inf")}), flush=True)
    res0.cleanup()
    del run0, inf, saved

    # ---- phase 68: experiment 9, the multires curriculum into the preset
    cfg9 = ice_exp.experiment_config(9)
    _, band = synthetic_dataset(shape=ICE_SHAPE, years=(2007, 2007))  # the mask alone
    reset()
    ice_exp.preset_mesh(cfg9, ICE_SHAPE, band, DEVICE)
    build = launched().get("segment_sum", 0)
    b9 = CLI_PRESET_BATCH
    nb9 = dict(train=_window_batches(years, CLI_MONTH, t_in, CLI_T_OUT, b9, train=True),
               test=_window_batches([years[-1] + 1], CLI_MONTH, t_in, CLI_T_OUT, b9),
               val=_window_batches([years[-1] + 1], CLI_MONTH, t_in, CLI_T_OUT, b9))
    cfg_edge = types.SimpleNamespace(n_layers=1, n_conv_layers=3)
    want9 = {"grid_attn_apply": ice_exp.HALF_EPOCHS * per * (2 * nb9["train"] + nb9["test"]),
             "grid_attn_apply_bwd": ice_exp.HALF_EPOCHS * per * nb9["train"],
             "segment_sum": build
             + nb9["train"] * expected_preset_launches(cfg_edge, CLI_T_OUT, train=True)
             + (nb9["test"] + nb9["val"]) * expected_preset_launches(cfg_edge, CLI_T_OUT)}
    res9 = tempfile.TemporaryDirectory()
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with HoldCapture(launchers) as held:
        run9 = ice_exp.main(["-m", str(CLI_MONTH), "-e", "9", *data_args, "--epochs", "1",
                             "--batch-size", str(b9), "--max-loss", "1e30",
                             "--results-dir", res9.name])
    torch.cuda.synchronize()
    wall9 = time.perf_counter() - t0
    got = launched()
    peak9 = torch.cuda.max_memory_allocated() / 2**30
    check(got == want9, f"ice_exp -e 9 launches {got}, expected {want9}")
    check(np.isfinite(run9["loss"]["train_loss"]).all()
          and np.isfinite(run9["val_predictions"]).all(), "ice_exp -e 9 not finite")
    out["ice_exp_e9"] = got
    print(json.dumps({
        "phase": "cli_ice_exp_e9", "card": card, "batch": b9, "wall_s": wall9,
        "batches": nb9, "preset_build_k7": build, "launches": got, "loss": run9["loss"],
        "peak_gib": peak9, "held": held.hold("ice_exp -e 9"),
    }), flush=True)
    res9.cleanup()
    del run9
    torch.cuda.empty_cache()

    # ---- phase 69: ice_exp_nwt (seed 7's 32×32 fields, no climatology)
    resn = tempfile.TemporaryDirectory()
    reset()
    t0 = time.perf_counter()
    with HoldCapture(launchers) as held:
        nwt = ice_exp_nwt.main(["-m", str(CLI_MONTH), "--synthetic", "--epochs", "1",
                                "--batch-size", str(NWT_BATCH), "--max-loss", "1e30",
                                "--results-dir", resn.name, "--device", DEVICE])
    torch.cuda.synchronize()
    wall_nwt = time.perf_counter() - t0
    got = launched()
    # the pixelwise edge list without climatology: no climatology pooling
    # (one K7 fewer an encode than expected_edge_launches counts); remat
    # replays every attention call's aggregation in a step
    nwt_years = range(2007, 2013)
    nbn = dict(train=_window_batches(nwt_years, CLI_MONTH, t_in, CLI_T_OUT, NWT_BATCH,
                                     train=True, data_years=11),
               test=_window_batches([2013], CLI_MONTH, t_in, CLI_T_OUT, NWT_BATCH,
                                    data_years=11),
               val=_window_batches(range(2014, 2018), CLI_MONTH, t_in, CLI_T_OUT, NWT_BATCH,
                                   data_years=11))
    step_k7 = (expected_edge_launches(cfg_edge, CLI_T_OUT, train=True) - 1
               + _attention_calls(cfg_edge, CLI_T_OUT))
    fwd_k7 = expected_edge_launches(cfg_edge, CLI_T_OUT) - 1
    want_nwt = {"segment_sum": nbn["train"] * step_k7 + (nbn["test"] + nbn["val"]) * fwd_k7}
    check(got == want_nwt and np.isfinite(nwt["loss"]["train_loss"]).all()
          and np.isfinite(nwt["val_predictions"]).all(),
          f"ice_exp_nwt launches {got}, expected {want_nwt}")
    out["ice_exp_nwt"] = got
    print(json.dumps({"phase": "cli_ice_exp_nwt", "card": card, "wall_s": wall_nwt,
                      "batch": NWT_BATCH, "batches": nbn, "launches": got, "loss": nwt["loss"],
                      "files": sorted(os.listdir(resn.name)),
                      "held": held.hold("ice_exp_nwt")}), flush=True)
    resn.cleanup()
    del nwt

    # ---- phase 70: ice_exp_cnnlstm raises where the JAX CLI fails
    try:
        ice_exp_cnnlstm.main(["-m", str(CLI_MONTH), "--synthetic", "--epochs", "1",
                              "--device", DEVICE])
        raised = None
    except ValueError as exc:
        raised = str(exc)
    check(raised is not None and "use_climatology=True" in raised,
          f"ice_exp_cnnlstm did not raise its ValueError: {raised}")
    print(json.dumps({"phase": "cli_ice_exp_cnnlstm", "card": card, "raised": raised[:160]}),
          flush=True)

    # ---- phase 71: ice_profile --trace-dir: trace rows = launch counters
    trace_dir = tempfile.TemporaryDirectory()
    counted = {}
    train = ice_profile.NextFramePredictorS2S.train

    def counted_train(self, *a, **kw):  # the traced span is train() itself
        reset()
        try:
            return train(self, *a, **kw)
        finally:
            torch.cuda.synchronize()
            counted.update(launched())

    reset()
    t0 = time.perf_counter()
    with mock.patch.object(ice_profile.NextFramePredictorS2S, "train", counted_train), \
            HoldCapture(launchers) as held:
        ice_profile.main(["--epochs", "1", "--batch-size", str(PROFILE_BATCH),
                          "--trace-dir", trace_dir.name, "--trace-summary",
                          "--device", DEVICE])
    wall_prof = time.perf_counter() - t0
    rows = trace_summary.summarize_trace(trace_dir.name, top=10**9)
    check(rows and all(r.plane == "kernel" for r in rows), "the ice_profile trace has no kernel")
    traced = {key: sum(r.count for r in rows if re.search(pattern, r.name))
              for key, pattern in TRACE_KERNELS.items()}
    want_t = {"spmm_build_blocks": counted.get("spmm_build_blocks", 0),
              "spmm_apply+spmm_apply_bwd": counted.get("spmm_apply", 0)
              + counted.get("spmm_apply_bwd", 0),
              "segment_sum": counted.get("segment_sum", 0)}
    check(traced == want_t and want_t["segment_sum"] > 0,
          f"ice_profile trace rows {traced} against the counters {counted}")
    out["ice_profile_train"] = counted
    print(json.dumps({"phase": "cli_ice_profile", "card": card, "wall_s": wall_prof,
                      "trace_rows": traced, "counters": counted,
                      "busy_ms": sum(r.total_ms for r in rows),
                      "held": held.hold("ice_profile")}), flush=True)
    trace_dir.cleanup()

    # ---- phase 72: mnist_demo on a few videos
    demo_dir = tempfile.TemporaryDirectory()
    cwd = os.getcwd()
    reset()
    t0 = time.perf_counter()
    try:
        os.chdir(demo_dir.name)  # the sweep writes its PNGs to the working directory
        with HoldCapture(launchers) as held:
            scores = mnist_demo.main(MNIST_DEMO + ["--device", DEVICE])
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    wall_demo = time.perf_counter() - t0
    got = launched()
    check(np.isfinite(scores["RMSE"]) and set(got) == {"segment_sum"},
          f"mnist_demo: scores {scores}, launches {got}")
    out["mnist_demo"] = got
    print(json.dumps({"phase": "cli_mnist_demo", "card": card, "argv": MNIST_DEMO,
                      "wall_s": wall_demo, "scores": scores, "launches": got,
                      "held": held.hold("mnist_demo")}), flush=True)
    demo_dir.cleanup()

    # ---- phase 73: the native host toolkit built here, deterministic
    from quadtree_mpnnlstm_tpu_torch import native_ext

    t0 = time.perf_counter()
    lib = native_ext.build()
    build_s = time.perf_counter() - t0
    kw = dict(input_timesteps=T_IN, output_timesteps=T_OUT, canvas_size=CANVAS,
              digit_size=DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=seed)
    t0 = time.perf_counter()
    native = ModMovingMNISTDataset(BATCH, backend="native", **kw)
    native_s = time.perf_counter() - t0
    again = ModMovingMNISTDataset(BATCH, backend="native", **kw)
    t0 = time.perf_counter()
    ModMovingMNISTDataset(BATCH, **kw)
    numpy_s = time.perf_counter() - t0
    check(np.array_equal(native.x, again.x) and np.array_equal(native.y, again.y),
          "the native generator is not deterministic under its seed")
    check(native.x.shape == (BATCH, T_IN, *CANVAS, 1) and np.isfinite(native.x).all(),
          f"native videos {native.x.shape}")
    print(json.dumps({"phase": "native_host", "card": card, "library": lib.name,
                      "build_s": build_s, "native_s": native_s, "numpy_s": numpy_s,
                      "videos": BATCH, "deterministic": True}), flush=True)
    run_dir.cleanup()
    return out


def add_item12_13_paths(f32_entries, item12: dict) -> None:
    """Adds phases 64-72's launches to the kernels line
    (``launches_by_path``): a data-parallel rank's train step and every
    CLI run's totals."""
    for entry in f32_entries:
        for path in ("dp_rank_step", "ice_exp_e0", "ice_inf", "ice_exp_e9", "ice_exp_nwt",
                     "ice_profile_train", "mnist_demo"):
            if entry["name"] in item12[path]:
                entry["launches_by_path"][path] = item12[path][entry["name"]]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's kernels need one", file=sys.stderr)
        return 2
    try:
        from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
        from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
        from quadtree_mpnnlstm_tpu_torch.ops import (
            attn,
            cuda_build,
            grid_attn,
            segment,
            segment_sum,
            spmm,
        )
    except ImportError as exc:
        print(f"chip_smoke: the port's package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    # ---- phase 1: build
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    for src in libs:
        cuda_build.load_library(src)  # raises if it does not load
    ptxas = [ln.strip() for src in libs for ln in
             libs[src].with_suffix(".log").read_text().splitlines() if "registers" in ln]
    print(json.dumps({"phase": "build", "card": card, "sources": sorted(libs),
                      "seconds": time.perf_counter() - t0, "ptxas": ptxas}), flush=True)

    # ---- phase 2: main path through predict()
    ds = ModMovingMNISTDataset(
        BATCH, input_timesteps=T_IN, output_timesteps=T_OUT, canvas_size=CANVAS,
        digit_size=DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=args.seed,
    )
    loader = DataLoader(ds, batch_size=BATCH)
    model = make_model(args.seed)
    model.predict(loader)  # warm-up (first launches, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmm.reset_launch_counts()
    segment_sum.reset_launch_counts()
    t0 = time.perf_counter()
    y = model.predict(loader)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = {**spmm.LAUNCHES, **segment_sum.LAUNCHES}
    check(y.shape == (BATCH, T_OUT, *CANVAS, 1), f"predict shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite forecast")
    check(model.last_overflow == 0, f"mesh overflow {model.last_overflow}")
    for name in ("spmm_build_blocks", "spmm_apply"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    check(launches["segment_sum"] == expected_quadtree_k7(model.cfg, 3),
          f"main path K7 launches {launches['segment_sum']}, "
          f"expected {expected_quadtree_k7(model.cfg, 3)}")
    print(json.dumps({
        "phase": "main_path", "card": card, "batch": BATCH, "batch_s": batch_s,
        "frames_per_s": BATCH * T_OUT / batch_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "overflow": model.last_overflow, "launches": launches,
    }), flush=True)

    # ---- phase 3: kernels vs plain versions on the main path's operands
    cfg = model.cfg
    enc_calls = T_IN * cfg.n_layers * cfg.n_conv_layers * 2  # K=3: 2 Â·z a layer
    dec_step_calls = cfg.n_layers * 2 + 2 * 2                # cells + the head
    x = torch.as_tensor(ds.x, device=DEVICE)
    with Capture(spmm, enc_calls, dec_step_calls) as cap:
        model.forecast(x)
    check(cap.calls == launches["spmm_apply"], "capture run disagrees with main path")
    gcfg = model.gcfg
    nt, sw, n_max = gcfg.agg_nt, gcfg.agg_sw, gcfg.n_max

    k1_err, k1 = 0.0, {}
    for i, bargs in enumerate(cap.builds):
        kern = spmm._build_blocks_cuda(*bargs)
        plain = spmm.build_blocks_plain(*bargs)
        check(torch.equal(kern, plain), f"K1 differs from its plain version (build {i})")
        k1_err = max(k1_err, float((kern - plain).abs().max()))
    bargs = cap.builds[0]
    k1["ms"] = graph_ms(lambda: spmm._build_blocks_cuda(*bargs))
    k1["events_ms"] = cuda_ms(lambda: spmm._build_blocks_cuda(*bargs))
    k1["plain_ms"] = cuda_ms(lambda: spmm.build_blocks_plain(*bargs))
    k1["bound_ms"], k1_bytes_ms, k1_ops_ms = k1_bound_ms(bargs[0], bargs[1], bargs[3], nt, sw)
    k1["bound_by"] = "bytes" if k1_bytes_ms >= k1_ops_ms else "operations"

    widths = []
    for f, aargs in cap.operands().items():
        z, s0, blocks, live = aargs[:4]
        kern = spmm._apply_cuda(*aargs)
        plain = spmm.apply_plain(*aargs)
        err = float((kern - plain).abs().max())
        check(err <= K2_TOL, f"K2 differs from its plain version at F={f}: {err}")
        csr = block_diag_csr(s0, blocks, n_max, nt, sw)
        zf = z.reshape(-1, f)
        lib_err = float((torch.sparse.mm(csr, zf).reshape(z.shape) - plain).abs().max())
        bound, b_ms, o_ms = k2_bound_ms(s0, blocks, live, n_max, nt, sw, f, z.shape[0])
        widths.append(dict(
            F=f, calls=cap.per_width[f], max_abs_err=err, library_max_abs_err=lib_err,
            live_tiles=int(live.long().sum()),
            ms=graph_ms(lambda: spmm._apply_cuda(*aargs)),
            events_ms=cuda_ms(lambda: spmm._apply_cuda(*aargs)),
            **rowwarp_times(spmm, aargs, kern, f"K2 at F={f}"),
            plain_ms=cuda_ms(lambda: spmm.apply_plain(*aargs)),
            **library_times(lambda: torch.sparse.mm(csr, zf)),
            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms,
        ))
    check(sorted(w["F"] for w in widths) == sorted(cap.per_width), "a width was not checked")
    print(json.dumps({"phase": "kernels_vs_plain", "card": card, "k1_max_abs_err": k1_err,
                      "k1_builds_checked": len(cap.builds), "k2_by_width": widths}),
          flush=True)

    # ---- phase 4: the rollout on the plain versions, on the card
    y_k, ovf_k, meshes_k = model.forecast(x)
    with mock.patch.object(spmm, "_build_blocks_cuda", spmm.build_blocks_plain), \
            mock.patch.object(spmm, "_apply_cuda", spmm.apply_plain), \
            mock.patch.object(segment_sum, "_segment_sum_cuda", k7_plain):
        y_p, ovf_p, meshes_p = model.forecast(x)
    check(torch.equal(meshes_k[0], meshes_p[0]), "first decoder step's meshes differ")
    same = (meshes_k == meshes_p).all(dim=-1)  # (T_out, B)
    first_diff = [int(torch.nonzero(~same[:, b])[0]) if not same[:, b].all() else T_OUT
                  for b in range(BATCH)]
    frame_err = (y_k - y_p).abs().amax(dim=(2, 3, 4))  # (B, T_out)
    agree = max((float(frame_err[b, :first_diff[b]].max()) for b in range(BATCH)
                 if first_diff[b] > 0), default=0.0)
    check(agree <= ROLLOUT_TOL, f"frames differ by {agree} before any mesh flip")
    nodes = lambda m: (m.max(dim=-1).values + 1).tolist()  # noqa: E731
    print(json.dumps({
        "phase": "rollout_vs_plain", "card": card, "max_abs_err_before_flip": agree,
        "first_mesh_flip_step": first_diff, "overflow_kernel": int(ovf_k.max()),
        "overflow_plain": int(ovf_p.max()), "n_nodes_kernel": nodes(meshes_k),
        "n_nodes_plain": nodes(meshes_p),
    }), flush=True)

    train_launches, bwd_widths = train_phases(args.seed, card, spmm, segment_sum, cfg, nt, sw,
                                              n_max)
    bf16_kernels, k7_main_sets = bf16_phases(args.seed, card, spmm, segment, segment_sum,
                                             loader, x)
    # ---- phase 27b: K7 on the pixel views of coarse to fine meshes
    k7_mesh = k7_mesh_sets(segment_sum, x, args.seed)
    print(json.dumps({"phase": "k7_mesh_density", "card": card, "k7_by_set": k7_mesh}),
          flush=True)
    attn_launches, attn_train_launches, k3_widths, k3_wide, k4_widths, k7_attn_sets = \
        attn_phases(args.seed, card, spmm, attn, segment, segment_sum, loader, x)
    capacity_phase(args.seed, card, spmm, attn)
    grid_launches, grid_train_launches, k5_widths, k6_widths = grid_phases(
        args.seed, card, spmm, attn, grid_attn, segment_sum)
    edge_launches, edge_train_launches, k7_sets, k7_calls = edge_phases(
        args.seed, card, (spmm, attn, grid_attn, segment_sum), segment, segment_sum)
    bf16_attn_kernels, k7_attn_bf16_sets = bf16_attn_phases(
        args.seed, card, spmm, attn, grid_attn, segment, segment_sum, loader, x)
    bench = bench_default_phases(args.seed, card, spmm, attn, grid_attn, segment_sum)
    gcn = gcn_phases(args.seed, card, spmm, attn, grid_attn, segment, segment_sum, loader, x)
    item7 = item7_phases(args.seed, card, spmm, attn, grid_attn, segment, segment_sum, loader, x)
    item8 = item8_phases(args.seed, card, spmm, attn, grid_attn, segment, segment_sum, loader, x)
    item9 = item9_phases(args.seed, card, spmm, attn, grid_attn, segment, segment_sum, loader, x)
    item10 = item10_11_phases(args.seed, card, spmm, attn, grid_attn, segment, segment_sum,
                              loader, x)
    item12 = item12_13_phases(args.seed, card, spmm, attn, grid_attn, segment_sum)
    for k in bf16_attn_kernels:  # the per-gate flagship's K5/K6 (phase 40)
        name = k["name"].removesuffix("_bf16")
        if name.startswith("grid_attn"):
            k["per_gate_by_width"] = bench["k5_per_gate" if name == "grid_attn_apply"
                                           else "k6_per_gate"]
            k["launches_by_path"]["per_gate_remat_predict"] = \
                bench["grid_per_gate_forecast"][name]
            k["launches_by_path"]["per_gate_remat_train_step"] = \
                bench["grid_per_gate_train"][name]
    k7_bf16 = next(k for k in bf16_kernels if k["name"] == "segment_sum_bf16")
    k7_bf16["by_operand_set"] += (
        [dict(w, path="transformer_conv") for w in k7_attn_bf16_sets]
        + [dict(w, path="mesh_density") for w in k7_mesh if w["dtype"] == "bfloat16"])
    k7_bf16["ms_by_path"]["transformer_conv"] = k7_path_means(k7_attn_bf16_sets)
    # the ice-xla path at bench.py's defaults (phase 45): K7 in bf16 on the
    # edge list's sets; its node counts (1 a forecast and a step) stay f32
    k7_bf16["by_operand_set"] += [dict(w, path="edge_list") for w in gcn["k7_edge_bf16"]]
    k7_bf16["ms_by_path"]["edge_list"] = k7_path_means(gcn["k7_edge_bf16"])
    k7_bf16["launches_by_path"]["ice_xla_predict"] = \
        gcn["edge_bf16_forecast"]["segment_sum"] - 1
    k7_bf16["launches_by_path"]["ice_xla_train_step"] = gcn["edge_bf16_train"]["segment_sum"] - 1
    add_gcn_paths(bf16_kernels, gcn, "bfloat16")
    bf16_kernels += bf16_attn_kernels

    # ---- phase 19: the kernels line
    n = sum(w["calls"] for w in widths)
    mean = lambda key: sum(w["calls"] * w[key] for w in widths) / n  # noqa: E731
    nb = sum(w["calls"] for w in bwd_widths)
    mean_b = lambda key: sum(w["calls"] * w[key] for w in bwd_widths) / nb  # noqa: E731
    by_path = lambda name: {"predict_batch": launches.get(name, 0),  # noqa: E731
                            f"train_{TRAIN_STEPS}_steps": train_launches[name]}
    source = "quadtree_mpnnlstm_tpu_torch/csrc/spmm.cu"
    kernels = [
        dict(name="spmm_build_blocks", route="cuda", source=source,
             replaces="quadtree_mpnnlstm_tpu/ops/pallas_spmm.py:249",
             launches=train_launches["spmm_build_blocks"], max_abs_err=k1_err, ms=k1["ms"],
             events_ms=k1["events_ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"],
             library_ms=None, launches_by_path=by_path("spmm_build_blocks")),
        dict(name="spmm_apply", route="cuda", source=source,
             replaces="quadtree_mpnnlstm_tpu/ops/pallas_spmm.py:322",
             launches=train_launches["spmm_apply"],
             max_abs_err=max(w["max_abs_err"] for w in widths),
             ms=mean("ms"), events_ms=mean("events_ms"), rowwarp_ms=mean("rowwarp_ms"),
             plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
             bound_by="bytes" if mean("bytes_ms") >= mean("ops_ms") else "operations",
             library_ms=mean("library_ms"), launches_by_path=by_path("spmm_apply")),
        dict(name="spmm_apply_bwd", route="cuda", source=source,
             replaces="quadtree_mpnnlstm_tpu/ops/pallas_spmm.py:363-365",
             launches=train_launches["spmm_apply_bwd"],
             max_abs_err=max(w["max_abs_err"] for w in bwd_widths),
             ms=mean_b("ms"), events_ms=mean_b("events_ms"), rowwarp_ms=mean_b("rowwarp_ms"),
             plain_ms=mean_b("plain_ms"), bound_ms=mean_b("bound_ms"),
             bound_by="bytes" if mean_b("bytes_ms") >= mean_b("ops_ms") else "operations",
             library_ms=mean_b("library_ms"), launches_by_path=by_path("spmm_apply_bwd")),
    ]

    def attn_entry(name, source, replaces, widths, fwd_launches, train_launches, steps):
        """Launch-weighted means over the widths the attention path uses."""
        n_calls = sum(w["calls"] for w in widths)
        avg = lambda key: sum(w["calls"] * w[key] for w in widths) / n_calls  # noqa: E731
        return dict(
            name=name, route="cuda", source=f"quadtree_mpnnlstm_tpu_torch/csrc/{source}",
            replaces=replaces, launches=train_launches[name],
            max_abs_err=max(w["max_abs_err"] for w in widths), ms=avg("ms"),
            plain_ms=avg("plain_ms"), bound_ms=avg("bound_ms"),
            bound_by="bytes" if avg("bytes_ms") >= avg("ops_ms") else "operations",
            # no PyTorch call adds per-edge (or per-direction) terms to keys
            # and values
            library_ms=None,
            events_ms=avg("events_ms"),
            launches_by_path={"predict_batch": fwd_launches[name],
                              f"train_{steps}_steps": train_launches[name]})

    grid_src = "quadtree_mpnnlstm_tpu/ops/pallas_grid_attn.py"
    k3_entry = attn_entry("attn_apply", "attn.cuh", "quadtree_mpnnlstm_tpu/ops/pallas_attn.py:372",
                          k3_widths, attn_launches, attn_train_launches, TRAIN_STEPS)
    # HD 256 (8 × d 32) on the same windows; the ice-quadtree path's own
    # windows are in ice_quadtree_hd256 (phase 42)
    k3_entry["k3_wide"] = {k: k3_wide[k] for k in ("HD", "max_abs_err", "ms", "events_ms",
                                                   "plain_ms", "bound_ms", "plan")}
    k4_entry = attn_entry("attn_apply_bwd", "attn_bwd.cuh",
                          "quadtree_mpnnlstm_tpu/ops/pallas_attn.py:424",
                          k4_widths, attn_launches, attn_train_launches, TRAIN_STEPS)
    # the ice-quadtree path (phase 42): HD 256 on its own windows, bf16 and f32
    for entry, rows in ((k3_entry, bench["k3_hd256"]), (k4_entry, bench["k4_hd256"])):
        entry["ice_quadtree_hd256"] = rows
        entry["launches_by_path"]["ice_quadtree_predict"] = \
            bench["quadtree_forecast"].get(entry["name"], 0)
        entry["launches_by_path"]["ice_quadtree_train_step"] = \
            bench["quadtree_train"][entry["name"]]
    kernels += [
        k3_entry,
        k4_entry,
        # the forecast runs K5 without keep planes, training K6 with them
        attn_entry("grid_attn_apply", "grid_attn.cu", f"{grid_src}:446",
                   [w for w in k5_widths if not w["keep"]], grid_launches,
                   grid_train_launches, ICE_TRAIN_STEPS),
        attn_entry("grid_attn_apply_bwd", "grid_attn.cu", f"{grid_src}:446",
                   [w for w in k6_widths if w["keep"]], grid_launches, grid_train_launches,
                   ICE_TRAIN_STEPS),
    ]
    # K7: means over the operand sets phase 21 measured (the card's time,
    # by graph_ms), weighted by the timed train steps' calls of each set
    measured = {(w["ids"], w["F"]): w for w in k7_sets}
    weights = {k: c for k, c in k7_calls.items() if k in measured}
    n7 = sum(weights.values())
    avg7 = lambda key: sum(c * measured[k][key] for k, c in weights.items()) / n7  # noqa: E731
    kernels.append(dict(
        name="segment_sum", route="cuda", source="quadtree_mpnnlstm_tpu_torch/csrc/segment.cu",
        replaces="quadtree_mpnnlstm_tpu/ops/pallas_segment.py:87",
        launches=edge_train_launches["segment_sum"],
        max_abs_err=max(w["max_abs_err"] for w in k7_sets), ms=avg7("ms"),
        events_ms=avg7("ms_events"),
        plain_ms=avg7("plain_ms"), bound_ms=avg7("bound_ms"),
        bound_by="bytes" if avg7("bytes_ms") >= avg7("ops_ms") else "operations",
        library_ms=avg7("library_ms"),
        # every operand set: the edge list's (phase 21), the main path's in
        # f32 (phase 27), the TransformerConv path's (phase 10) and the
        # mesh densities' (phase 27b), with the launch-weighted means of
        # each path
        by_operand_set=([dict(w, path="edge_list") for w in k7_sets]
                        + [dict(w, path="main") for w in k7_main_sets]
                        + [dict(w, path="transformer_conv") for w in k7_attn_sets]
                        + [dict(w, path="mesh_density") for w in k7_mesh
                           if w["dtype"] == "float32"]),
        ms_by_path={"edge_list": dict(k7_path_means(
                        [dict(measured[k], calls=c) for k, c in weights.items()]),
                        launches_per_step=edge_train_launches["segment_sum"] / ICE_TRAIN_STEPS),
                    "main": k7_path_means(k7_main_sets),
                    "transformer_conv": k7_path_means(k7_attn_sets)},
        launches_by_path={
            "predict_batch": edge_launches["segment_sum"],
            f"train_{ICE_TRAIN_STEPS}_steps": edge_train_launches["segment_sum"],
            "chebconv_predict_batch": launches["segment_sum"],
            f"chebconv_train_{TRAIN_STEPS}_steps": train_launches["segment_sum"],
            "attention_predict_batch": attn_launches["segment_sum"],
            f"attention_train_{TRAIN_STEPS}_steps": attn_train_launches["segment_sum"],
            "grid_predict_batch": grid_launches["segment_sum"],
            f"grid_train_{ICE_TRAIN_STEPS}_steps": grid_train_launches["segment_sum"],
            "ice_quadtree_predict": bench["quadtree_forecast"]["segment_sum"],
            "ice_quadtree_train_step": bench["quadtree_train"]["segment_sum"]}))
    add_gcn_paths(kernels, gcn, "float32")
    add_item7_paths(kernels, bf16_kernels, item7)
    add_item8_paths(kernels, bf16_kernels, item8)
    add_item9_paths(kernels, bf16_kernels, item9)
    add_item10_11_paths(kernels, item10)
    add_item12_13_paths(kernels, item12)
    for k in kernels:
        k["dtype"] = "float32"
    print(json.dumps({"kernels": kernels + bf16_kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
