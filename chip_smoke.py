#!/usr/bin/env python3
"""Smoke run of the PyTorch/Hopper port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Builds the eleven hand-written kernel sources of ``src/repro_torch/csrc``
   with nvcc for sm_90a (at first use, into ``build/repro_torch/``), one
   nvcc per source, all started together.
2. Serves DBRX-132B at full width, its 40 layers cut to 4 to fit one card,
   through ``DecodeServer`` over 8 EP ranks hosted on the card: batch 128,
   prompt 8, 16 generated tokens, in the preset's LL ``nccl_ep`` layout,
   then in the LL ``deepep`` layout with fp8 dispatch, through the
   baseline a2a dispatcher and without EP (dense), on the same weights and
   prompts. Both servers step through their compiled step: the step is
   captured once as a CUDA graph and replayed. Each layout is served twice
   captured and twice through the uncompiled ``_step_factory()`` step (the
   eager reference), alternating: every token stream must be bitwise equal,
   and the baseline's equal the ``nccl_ep`` serve's. The launch counters
   advance only where a wrapper runs: per step in an eager serve, for the
   warm-up and the capture in a captured one; each must equal the count
   the path implies. Reports each serve's ITL mean and p99, each graph's
   capture time and private pool bytes. Then ``pipeline_depth=2`` in
   ``nccl_ep``: its tokens must equal depth 1's.
3. Serves 256 requests through ``ContinuousDecodeServer`` on the same model
   and weights, twice captured and twice eager: 128 slots over paged KV
   (page 16), prompts of 4 to 32 tokens, 8 to 32 new tokens each, Poisson
   arrivals of 4 per step. Every request must complete with in-vocabulary
   tokens, bitwise equal in every run, every page must come back, and the
   launch counts of all kernels must equal the count the path implies.
   Once more captured with a ``Tracer`` and a ``TimeSeries``
   (``runtime/telemetry.py``, after the traces of step 4): streams bitwise
   equal to the untraced serve's, one ``serve_step`` and one ``admission``
   span a step, one ``admit`` and one ``complete`` instant a request, one
   series row a step; its Chrome trace written under ``build/traces/`` and
   held by the port's validator; its ITL printed beside the untraced one.
4. Steady-state EP decode (``runtime/decode.py``): MoE layer 0 over the 8
   ranks, a micro-batch pair of 16 tokens per rank, in the three layouts:
   ``decode_loop`` over 4 steps (a changed routing, a replayed one) and a
   captured ``pipelined_decode_step`` on replay must be bitwise equal to
   ``naive_decode_step``; reports the device time of each pair, of a
   refresh against ``ep_create_handle``, and the two streams' overlap.
   Then traces one replayed step of each captured server: the card's busy
   time, its device events and idle share against the captured ITL, and
   the EP launches per replayed step from the kernels' names, which must
   equal the path's count. Every graph is released.
5. Runs the prefill forward, ``get_model(cfg).forward``, of the same model
   and weights under the ``train_4k`` preset (HT flat EP, fp8 dispatch,
   capacity factors 1.25) on 8 x 4096 tokens, 4096 per hosted rank: the
   loss must be finite and the launch counts exact (flash attention once per
   layer). Reports its wall time after a warm-up, prefill tokens per second,
   peak memory and each MoE layer's dropped-entry share, then traces one
   forward with the profiler: the card's busy share and its time by kernel.
   The forward must be bitwise equal on a repeat. Then the same forward
   with the MoE layers on the hierarchical HT path: EP over two pods of
   four (``LocalComm(8, axes=(("pod", 2), ("data", 4)))``), two stages,
   2 chunks; the same checks, exact launch counts per layer and rank, its
   numbers beside the flat forward's and its trace.
6. Holds each EP kernel against its plain PyTorch version on the inputs one
   EP rank gets in one MoE layer of the first serve (8 ranks, 16 tokens
   each): bitwise for the two gathers, in copy and in fp8 mode, the pack in
   copy mode also at the combine send ([256, 6144] rows into [8, 32] slots);
   within 2e-2 for the reduce, and bitwise between two of its calls; and at
   the prefill's HT shapes (4096 tokens per rank, [8, 2560] send blocks,
   [2, 10240] expert regions): fp8 pack, dequant unpack and the combine
   send's copy-mode pack bitwise, the reduce as at decode; at the
   hierarchical prefill's shapes, B2's copy mode at the stage-2 fan on fp8
   payload rows and on their f32 scale rows bitwise, and B4 at the
   combine's three sums (slot domain, rail over pods, source over rails)
   as at decode, each timed beside its plain version, its bound and a
   library call. The
   copy-mode gathers are timed beside ``index_select`` over rows padded with
   one zero row. Holds the bf16 grouped GEMM at the four shapes the paths
   give it: the decode gate [2, 128, 6144] @ [2, 6144, 10752] and down
   [2, 128, 10752] @ [2, 10752, 6144] projections with the ``nccl_ep``
   routing's counts and with every row live (the ``deepep`` and baseline
   layouts), and the HT gate and down projections over [2, 10240] expert
   regions with the ``train_4k`` routing's counts: within 2e-2 per element
   and 5e-3 relative over the whole output, rows past the count exactly
   zero, two calls bitwise equal; each timed beside its plain version,
   ``torch.bmm`` and its bound. The standalone fp8 pair bitwise:
   dequantize on what one rank receives in the ``deepep`` serve, quantize
   at the decode and HT x of a rank in bf16 and f32, blocks 128 and 64,
   against ``dispatch_pack``'s quant mode and between two calls;
   ``combine_reduce`` within 2e-2 (bf16) and 1e-5 (f32) at 16 and 4096
   tokens of K = 4, bitwise between two calls and against
   ``combine_gather_reduce`` over identity rows; dequantize's time is the
   median of five readings. Holds the
   paged decode attention kernel
   against its plain version within 1e-4: at the shapes the continuous serve
   gives it (bf16 pools of the serve's 512 + 1 pages, table width 4, 4
   splits, up to 64 tokens), at DBRX widths over long contexts (128
   requests up to 32768 tokens), both with shuffled tables and garbage in
   unreferenced pages, and in the shared-pool mode at DeepSeek-V3's
   absorbed-MLA widths; idle rows must be exactly 0 and the output bitwise
   unchanged when the garbage changes. Holds flash attention against its
   plain version at the prefill's shapes (causal, a window of 1024,
   non-causal) and at G = 1, in bf16 within 5e-3 relative error over the
   whole output and 2e-2 per element, and within 1e-4 in f32; two calls
   bitwise equal, and SDPA within 2e-2 of it in each of the three cases
   (the window as a boolean band mask, on the memory-efficient backend).
   Times on the card each kernel, its plain version and, where one PyTorch
   call computes the same function, that call.
7. Holds each MoE layer's EP output against the dense fallback on the same
   input (every capacity is zero-drop here): relative error <= 2e-2, in the
   ``nccl_ep``, ``deepep`` (with and without fp8) and baseline layouts; the
   same for the HT layer at 512 tokens per rank and zero drop, without fp8
   and with it (both fed the plain quantize-dequantize round trip of x);
   ``prefill_moe`` with 2 micro-batches must be bitwise equal to
   ``sequential_prefill``. The hierarchical HT layer likewise against the
   dense fallback (2 chunks, with and without fp8), with 2 and 4 chunks
   bitwise equal to 1 (dispatch tensor, counts, combined tokens), and
   ``prefill_moe`` bitwise equal to ``sequential_prefill`` over it. Reports the greedy-token agreement of the EP
   server with a dense one. Reruns two requests that joined and left
   mid-stream alone, one after the other through a fresh engine: their
   token streams must be bitwise equal. Holds the paged decode step against the dense step on the
   same tokens: in bf16 over the 4 layers, bitwise at the first step and
   the median row's logits within 2e-2 at the second; in f32 with one
   layer, the logits within 2e-4 at every step. Reads each layout's send
   and receive buffer bytes per rank and MoE layer from its tensors.

8. EPLB through both servers (``eplb_phase``), with the reference serving
   example's settings: ``track_expert_heat``, a rebalance every 16 steps,
   8 redundant slots (24 slots, 3 a rank). First B3 at the decode shapes
   with 2 and 3 experts a rank: which tiles stream-K splits depends on L,
   a row's bits must not (the first two experts' rows bitwise equal).
   Then ``DecodeServer`` at 128 x (8 + 64) without EPLB (the reference),
   and with it in logical mode (each step gathers the slots' experts from
   the logical weights) and in physical mode (adopt-once: the weights
   rebound in place at each swap), each captured (every placement's step
   warmed up and captured anew) and eager: tokens bitwise equal to the
   reference's, exact launch counts, at least one swap; the placements'
   fingerprints, the ITL of the step after a swap apart from the rest,
   each capture's and the adoptions' time, the heat's max/mean and the
   peak printed. ``ContinuousDecodeServer`` on step 3's 256 requests in
   both modes, captured: streams bitwise equal to step 3's, the same
   admissions, each window's heat max/mean per expert and per rank. Last
   the EP layer under skew: MoE layer 0's experts over 8 ranks, 16 tokens
   a rank with Zipf-like routing on rank 0's block, through
   ``rebalancing_decode_loop`` under the contiguous, the rebalanced (R 0)
   and the redundant (R 8) placement: outputs bitwise equal, the largest
   receive a rank against the mean and the experts' card time printed.
   Then elastic EP (``elastic_phase``): the fixed batch 128 x (8 + 64) in
   physical mode from the redundant placement (16 redundant slots, every
   expert on two ranks, 4 slots a rank; the scheduler runs for the
   detector, with no periodic rebalance), rank 2 killed at step 20 and
   rejoined at step 44 (``FaultInjector``, ``miss_threshold`` 2), captured
   and eager: tokens bitwise equal to the serve without EPLB, the
   recoveries a shrink at step 21 (28 slots on 7 ranks, still 4 a rank)
   and an expand, no expert lost, no restore, rank 2's row of the degraded
   table all ``EMPTY``, ``degraded_steps`` the schedule's 23, three
   distinct fingerprints, at most two cached steps; each transition's repack, adoption and
   recapture time, the degraded steps' ITL beside the healthy ones' and
   the peak printed. The continuous serve of step 3's 256 requests under
   the same schedule: streams and admissions equal, the page tables clean.
   Last, on a one-layer cut of DBRX at full width (16 experts, 8.3 GiB of
   weights, the checkpoint's disk write sets the cut), the identity
   placement: a kill without ``ckpt_dir`` warns ``DegradedRecovery`` and
   raises; with a checkpoint of step 0 (in a temporary directory under
   ``build/``, deleted at the end) it restores and serves the
   uninterrupted tokens; SIGTERM before a ``pipeline_depth=2`` serve
   drains, checkpoints and returns ``preempted=True`` at the first
   boundary, its checkpoint restores bitwise with the placement's
   fingerprint. The free space and each write's and read's GB/s printed.

9. Serves DeepSeek-V3-671B at full width (``configs/deepseek_v3_671b.py``,
   ``decode_32k``: d_model 7168, MLA with 128 heads, 256 experts top-8 with
   sigmoid group-limited routing, a selection bias and a shared expert, LL
   ``nccl_ep`` with fp8 dispatch), its 61 layers cut to 5 (the 3 dense and
   2 MoE layers, 49.6 GiB), once every DBRX tensor is freed, through the
   same phases as DBRX with one server alive at a time. ``DecodeServer``,
   batch 128, prompt 8, 16 generated, once captured and once eager: tokens
   bitwise equal, exact launch counts (B1 in quant mode at the dispatch
   send and in copy mode at the combine send, B2 dequantizing, B3, B4), one
   replayed step traced (the EP kernels by name, B3's share, the idle
   share). ``ContinuousDecodeServer``, 128 slots over the paged MLA pools
   (page 16), 64 requests, once captured and once eager: exact launch
   counts (B6 in its shared-pool mode once per layer), a replayed step
   traced; then every request served alone through one engine must give
   its tokens bitwise. The paged MLA step against the absorbed
   dense-cache step (bf16 over 5 layers: step 0 bitwise, the median row
   within 2e-2 at step 1; f32 over one dense layer within 2e-4); each MoE
   layer against the dense fallback within 2e-2; B1, B2, B3, B4 and B6 at
   DeepSeek's shapes against their plain versions (gathers and fp8
   bitwise, B3 and B4 as above, B6 within 1e-4 at the serve's lengths and
   up to 32768 tokens) and timed, B6 beside ``scaled_dot_product_attention``
   over the pool rows gathered dense (the backend it took printed) and
   with the kernel each timed call ran, which must be the shared-pool
   tensor-core path; ``ep_create_handle``'s card time for one
   MoE layer at E 256, K 8; the phase's peak device memory. Its rows join
   the kernels JSON. Then, those weights freed, DeepSeek-V3's ``train_4k``
   prefill forward with MTP (HT flat, fp8 dispatch, capacity 1.25): the 3
   dense layers and 1 MoE layer plus the MTP layer, a second 256-expert MoE
   layer (49.8 GiB), 4 x 4096 tokens over 4 EP ranks hosted on the card.
   The loss finite and bitwise equal on a repeat, the MTP term present (the
   loss without it, on the same parameters less the ``mtp_*`` leaves,
   differs), the EP launches exact for both MoE layers and every hosted
   rank, no flash or paged launches (MLA's prefill takes ``MlaChunked``,
   plain torch, one batch row at a time). Reports its wall time after a
   warm-up, tok/s, peak memory, dropped shares and the plan's host time,
   and traces one forward: the device time by kernel, and the shares of
   the f32 head products, of ``MlaChunked``'s loop (and of its GEMMs) and of B3
   (each range must be recorded). Last, B1 to B4 at this forward's HT
   shapes (rank 0 of MoE layer 0 over ``LocalComm(4)``, 4096 tokens a rank:
   64 local experts, fp8 blocks over H 7168, top-8 combine) against their
   plain versions, as at DBRX's HT shapes, and timed.

10. The dense configs of the ``lm`` family at full width and full depth,
   one at a time, each freed before the next (``dense_phase``):
   ChatGLM3-6B (28 layers, GQA 32/2 heads, RoPE on half of each head),
   InternLM2-20B (48 layers, GQA 48/8) and MiniCPM3-4B (62 layers, MLA over
   40 heads padded to 48, tied embeddings), random weights. Each through
   ``DecodeServer`` without EP, 128 x (8 + 16), captured and eager (tokens
   bitwise equal, no kernel launched: the dense-cache decode is plain
   torch), ``ContinuousDecodeServer`` with the 256 requests of step 3,
   captured and eager (B6 once a layer and step: GQA on ``paged_gqa_kernel``,
   MiniCPM3's shared pool at dk 288 / dv 256 on the CUDA-core path), each
   server's replayed step traced, and the ``train_4k`` forward at the
   preset's microbatch of 4096-token rows (B7 once a GQA layer; MiniCPM3's
   MLA takes ``MlaChunked``), finite and bitwise on a repeat. Then B6 at
   the serve's shapes and B7 at the forward's against their plain versions
   (within 1e-4; 5e-3 relative and 2e-2), timed beside SDPA for B7; their
   rows join the kernels JSON.

10b. The ``gemma3`` and ``vlm`` families (A12a), one model at a time, each
   freed before the next. Gemma3-27B whole at full width (``gemma3_phase``:
   62 layers, 10 super-blocks of 5 windowed local layers and a causal
   global one, a tail of 2 local; 50.31 GiB): ``DecodeServer`` at 16 x (8 +
   16) over caches of 2048 (cut from ``decode_32k``'s 128 x 32768, whose
   global caches alone would take 320 GiB; ring caches of 1024 rows in the
   local layers), captured and eager, tokens bitwise equal, no kernel
   launched, the replayed step traced; the ``train_4k`` forward at 2 x 4096
   (cut from 8 rows), B7 in all 62 layers, bitwise on a repeat, its peak
   against the reckoned one, traced (B7's share), B7's windowed launches
   counted apart. Its ring check at 8 layers (``gemma3_ring_phase``): 4 x
   (1100 + 16), every ring wrapping, captured and eager bitwise equal; the
   first local layer's ring rows against keys and values recomputed from
   the tokens; every local layer's mask keeping exactly the window's
   positions; the served sequence through the captured ring step against
   a linear-cache reference with the window as a mask, the last logits
   within 2e-2 with wq and wk tempered (f32 and bf16), printed at the
   drawn weights. Phi-3-vision-4.2B whole (``phi3v_phase``):
   ``dense_config_phase`` with the forward's ``img_embeds`` [4, 576, 3072]
   (B7 at head width 96 once a layer; B6 at dk 96, G 1, on the CUDA-core
   path). B7 at Gemma3's local and global shapes and at d 96 in three
   masks at G 1 and 2, and B6 at dk 96, against their plain versions and
   timed beside SDPA; their rows join the kernels JSON.

11. One EP rank per process (``comm.DistComm``), in spawned child processes
   once every weight of the main process is freed (``dist_phase``). (a)
   NCCL at world = the card count, one process per card: the primitives
   against ``LocalComm(world)`` on the same stacked inputs (all-to-all and
   all-gather bitwise in bf16, int32 and fp8, all-reduce within f32
   rounding) and each one's time beside ``LocalComm``'s; DBRX's MoE layer 0
   at full width through the EP API at N = world over batch 128, in
   ``nccl_ep`` and ``deepep`` + fp8, bitwise against ``LocalComm(world)``,
   with B1 to B4 launched, and captured by ``CompiledStep`` with its replay
   bitwise equal to eager; ``DecodeServer(comm=DistComm)`` over DBRX (its
   4 layers), 128 x (8 + 16), captured; ``ContinuousDecodeServer(comm=
   DistComm)``, 128 slots over paged KV (page 16, 512 pages), 64 requests,
   captured, exact launch counts, two requests that joined and left
   mid-stream served again alone through the same engine bitwise, the
   per-step token gather timed. At world 1 both servers' tokens must
   equal the dense-path servers' on the card bitwise, and the prefill
   forward does not run (EP extent 1 takes the dense MoE path): a line
   says so. (b) With several cards the same child runs at EP extent =
   world: each server's first-step logits within 2e-2 of
   ``LocalComm(world)``'s on one card (cuBLAS picks its kernel by the row
   count, so tokens are compared, not required equal); then the
   ``train_4k`` prefill forward, 8 x 4096 global, fp8, capacity 1.25, HT
   flat at EP extent 4 and, over two pods of two, hierarchical at 1 and 2
   chunks: each loss finite, bitwise on a repeat, within 1e-3 relative of
   ``LocalComm(4)``'s on card 0, its EP launches exact; 2 chunks bitwise
   equal to 1. Each rank prints a progress line as each sub-phase ends,
   and the continuous serve each batch rank's share of the live rows.
   On one card a line says (b) did not run and why. (c) Two
   processes sharing the card over gloo (CUDA tensors through the host),
   EP extent 2, eager (a gloo step is not captured): the fixed-batch serve,
   its ITL printed as "gloo via host", the continuous serve and the flat
   prefill forward, with the checks of (b) against ``LocalComm(2)``.
   Every rank's continuous admission log, (step, rid, slot), must be the
   same. A child that fails fails the script. ``python3 chip_smoke.py
   --dist-only`` builds the kernels and runs this phase alone (for a
   machine with several cards). At world 4 (four cards), after DBRX's
   sub-phases, DeepSeek-V3 at one EP rank a card (``ds_dist_phase``): the
   fixed-batch serve at 5 layers captured, its first-step logits within
   2e-2 of ``LocalComm(4)``'s on card 0; the ``train_4k`` forward with MTP
   at the one-card cut (4 layers + the MTP layer, 4 x 4096, one row a
   card) within 1e-3 relative of ``LocalComm(4)``'s; the fixed-batch serve
   at 3 dense + ``DS_DEEP_MOE_LAYERS`` MoE layers (5.64 GB of experts a
   layer and card) captured and eager, tokens bitwise equal, no one-card
   reference fitting; last, the continuous serve of 256 requests over the
   MLA pools (every batch rank stepping live rows), held like DBRX's. A
   continuous serve's first-step logits are held against ``LocalComm``'s
   step fed one batch rank's rows at a time (``blocked_step0_logits``), so
   that its bf16 products run at a process's row count: the idle rows'
   shared input sits at a routing near-tie that the row count moves; the
   whole-batch comparison is printed too, and ``ProductShapes`` prints the
   products of each by rows and checks the blocked reference's bf16 ones
   against a process's. Between DBRX's sub-phases and DeepSeek-V3's, over
   NCCL at world > 1, each child runs DBRX with the EPLB hook (``dist_eplb_phase``): physical mode, a rebalance
   every 16 steps, 4 redundant slots (5 a card), 128 x (8 + 64), captured:
   tokens bitwise equal to the same ``DistComm`` serve without EPLB, every
   rank's placement fingerprints equal (all-gathered), each card's
   migrated expert rows bitwise equal to its slots of rank 0's
   ``LocalComm`` adoption, the first-step logits under the last table
   within 2e-2 of ``LocalComm(4)``'s; each swap's migration bytes and
   time printed. Then ``dist_elastic_phase``: the same serve with 16
   redundant slots (8 a card) under the floor of 2, rank 2 killed at step
   20 and rejoined at 44: tokens bitwise equal to the serve without EPLB,
   every rank's recovery events, alive sets and fingerprints equal
   (all-gathered), no byte to card 2 in the shrink, the rows after the
   rejoin bitwise equal to the ``LocalComm`` adoption; a whole-pod kill
   (pods of two cards, pod 1 at step 20, back at 44): one shrink for
   ranks 2 and 3, no restore, tokens bitwise equal; SIGTERM raised in
   rank 1 alone: all four return ``preempted=True`` at one boundary with
   the same tokens. The control all-reduce's time a call, each
   migration's bytes and seconds and the degraded ITL printed. Last in
   each child at EP extent > 1, training over ``DistComm``
   (``dist_train_check``): DBRX-132B ``train_4k`` at full width, 1 layer,
   one row of 2048 tokens a process, one step of the ``Trainer`` with bf16
   moments, after rank 0 ran the same step over ``LocalComm`` of the EP
   extent on card 0 while the others waited: the loss within 1e-3
   relative, the gradient norm within 1e-2, every replicated leaf bitwise
   equal on every process after the step (broadcast from rank 0), the
   launches exact for one hosted rank (``train_launches``), no plain
   version reached; the step, gradient-reduce (with its bytes) and
   optimizer seconds and the peak printed (on the gloo pair the two
   processes' peaks summed: the card's). At world 1 a line says training
   does not run (EP extent 1 takes the dense MoE path). At world 4 over
   NCCL then ``dist_train_full``: the ``Trainer`` at EP 4 (4 experts a
   card), the preset's seq 4096, 16 rows in 2 micro-batches, 4 steps on
   the repeated batch, 4 layers unless a 1-layer step's peak plus the
   reckoned state of 3 more layers passes 72 GiB on some card (then 3):
   the losses finite and falling, the launches exact, no plain version
   reached; the step, micro-batch, gradient-reduce and optimizer seconds,
   train tok/s over the mesh and a card, the peak; then one micro-batch
   traced on rank 0 (the card's busy share, NCCL's share of it, the top
   kernels). Then, the flat runs freed, the one-step check in hierarchical
   HT over ``DistComm`` on two pods of two (against ``LocalComm(4)`` on the
   same axes), in ``deepep`` and in the baseline at EP 4, each held as the
   flat check is; and the four-card Trainer on the hierarchical path (2
   chunks), with the same layer rule, lines and trace, its median step
   printed against the flat one's (``dist_train_phase``). Last, DBRX
   freed, DeepSeek-V3-671B ``train_4k`` at full width with one EP rank a
   card (``ds_train_full``: EP 4, 64 experts a card, HT flat, fp8 dispatch,
   capacities 1.25, remat, MTP off, 8 x 4096 in 2 micro-batches, one row a
   card in each, bf16 moments, 3 Trainer steps on the repeated batch): one
   MoE layer probed with a step, then a dense layer before it if the
   probe's peak plus its reckoned state stays within 72 GiB on every card;
   the losses finite and falling, the gradient norms finite, every
   replicated leaf bitwise equal on every process, the launches exact for
   one hosted rank, ``MlaChunked``'s calls exact, no plain version
   reached; the cuts, the step, micro-batch, reduce and optimizer seconds,
   tok/s over the mesh and a card, the peak and one traced micro-batch on
   rank 0 printed.

12. Training (``train_phase``), last, once every other tensor is freed:
   ``Trainer`` on DBRX-132B at full width under ``train_4k`` (HT flat, fp8
   dispatch, capacities 1.25, remat), 1 of its 40 layers, a global batch
   of 16 x 2048 in 2 micro-batches over ``LocalComm(8)``, AdamW moments in
   bf16. First the backward kernels at the slice's shapes (rank 0 of the
   layer at 2048 tokens a rank) against their plain versions, timed beside
   them, their bounds and a library call: ``grouped_gemm_dw`` at the gate
   and down projections (2e-2 per element, 5e-3 relative, two calls
   bitwise, NaNs in the rows past the counts changing no bit), B3 as dX
   on the [L, F, H] copy of the weights (the copy timed),
   ``combine_gather_reduce_bwd`` (d_recv bitwise, d_w 1e-5
   relative), flash attention's LSE (1e-3) and its dQ / dK-dV pair at [8,
   2048, 48/8, 128] (``FLASH_BWD_REL`` over each gradient, two calls
   bitwise) beside SDPA's backward; the EP transposes bitwise against
   plain gathers and k-order sums on every rank; MoE layer 0's gradients
   (tokens, router, the three expert weights) through the kernels against
   the same layer with every ``kernels/ops.py`` entry on its plain version
   (``MOE_GRAD_REL``). Then ``Trainer.run`` for 4 steps on a repeated
   batch: every gradient of step 1 finite and nonzero, step 1's loss
   within ``PF_LOSS_REL`` of the ``train_4k`` forward's on the same
   parameters and batch, the loss falling, each step's launches exact
   (``train_launches``), no plain version reached; step, micro-batch and
   optimizer times, train tok/s and the peak printed; one micro-batch's
   forward and backward traced (busy share, time by kernel). Before it,
   ``train_layout_phase``: the EP round trip's backward at DBRX train_4k
   widths (8 ranks of 2048 tokens, H 6144, zero drop; expert e scaling its
   rows by 1 + e) in HT flat, ``deepep`` (bf16 and fp8), the baseline and
   hierarchical HT over two pods of four (1 and 2 chunks, bf16 and fp8):
   d_x and d_w within 2e-2 of the analytic gradient and of HT flat's of
   the same precision, 2 chunks bitwise equal to 1, each transpose's
   launches exact and its device time printed. After it, the Trainer for
   2 steps with its MoE layer on the hierarchical path over two pods of
   four (2 chunks, fp8, capacities 1.25): the losses finite and falling,
   the launches exact, the step, tok/s and peak printed, the first loss
   and the step beside HT flat's. Before ``train_layout_phase``,
   ``mla_phase``: MLA's chunked attention with its recomputing backward
   (``MlaChunked``) against autograd through the plain loop at DeepSeek-V3's
   and MiniCPM3-4B's ``train_4k`` widths (one row of 4096 tokens, bf16):
   the forward bitwise, each gradient within 2e-2 of its largest value,
   each one's seconds and peak memory, the Function's peak at most a third
   of the loop's. After ``train_phase``, ``minicpm_train_phase``: the
   ``Trainer`` on MiniCPM3-4B ``train_4k`` (its 62 layers whole unless the
   reckoned state does not fit, 4 x 4096 in 2 micro-batches, 2 steps, bf16
   moments): the losses falling, no kernel launched, ``MlaChunked``'s calls
   exact; the step seconds, tok/s and the peak printed.

Exits non-zero, printing no result, without a CUDA device or without the
repository beside it. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import faulthandler
import gc
from collections import Counter
import json
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.comm import DistComm, LocalComm  # noqa: E402
from repro_torch.configs.dbrx_132b import full_config  # noqa: E402
from repro_torch.configs.deepseek_v3_671b import full_config as ds_full_config  # noqa: E402
from repro_torch.core import (EpGroupConfig, ep_combine, ep_complete,  # noqa: E402
                              ep_create_group, ep_create_handle, ep_dispatch,
                              ep_handle_refresh, route, slots)
from repro_torch.core import ht as HT  # noqa: E402
from repro_torch.core import ll as LL  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ops as ops_mod  # noqa: E402
from repro_torch.kernels import combine_gather_reduce as cg_mod  # noqa: E402
from repro_torch.kernels import combine_reduce as cr_mod  # noqa: E402
from repro_torch.kernels import decode_attention as da_mod  # noqa: E402
from repro_torch.kernels import dispatch_pack as dp_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import fp8 as fp8_mod  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg_mod  # noqa: E402
from repro_torch.kernels import recv_unpack as ru_mod  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf_mod  # noqa: E402
from repro_torch.models.moe import (_expert_ffn, _moe_dense_fallback,  # noqa: E402
                                    ep_group, moe_block, router_config)
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models.layers import apply_rope, ffn_apply, logits_out, rmsnorm  # noqa: E402
from repro_torch.models.transformer import (_decode_splits, _index,  # noqa: E402
                                            init_decode_state,
                                            init_paged_decode_state,
                                            lm_decode_step, lm_paged_decode_step)
from repro_torch.runtime.decode import (decode_loop, naive_decode_step,  # noqa: E402
                                        pipelined_decode_step, rebalancing_decode_loop)
from repro_torch.checkpoint import (adopt_expert_params, latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.runtime.fault import DegradedRecovery, FaultInjector  # noqa: E402
from repro_torch.core import placement as PL  # noqa: E402
from repro_torch.runtime.prefill import _handle, prefill_moe, sequential_prefill  # noqa: E402
from repro_torch.models.kv_pages import PageAllocator  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousScheduler, Request  # noqa: E402
from repro_torch.runtime.server import (ContinuousDecodeServer,  # noqa: E402
                                        DecodeServer)
from repro_torch.runtime import steps as steps_mod  # noqa: E402
from repro_torch.runtime.steps import CompiledStep, capture_stream  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.telemetry import (TimeSeries, Tracer, load_chrome_trace,  # noqa: E402
                                           validate_chrome_trace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.weights import init_params, is_cut  # noqa: E402
from repro_torch.device import disable_tf32  # noqa: E402
from repro_torch.launch.mesh import init_process, spawn  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12            # f32 outside the tensor cores
# torch.cuda._sleep's cycles per second: above the H100 SXM's 1.98 GHz
# boost clock, so a spin lasts at least as long as asked
SPIN_CYCLES_S = 2e9
# short spin kernels launched ahead of the calls a profiler session times:
# a session late in a run can lose its first events (1, 5, 10 and 20 of
# them in the runs on record), and these take the loss
LEAD_SPINS = 64

RANKS, BATCH, PROMPT, GEN, LAYERS = 8, 128, 8, 16, 4
# the fixed-batch servers' cache length: two slots beyond the served tokens,
# for the traced replayed step and the traced eager step
MAX_LEN = PROMPT + GEN + 2
# serves of each fixed-batch layout and of the continuous serve per mode
# (captured, eager)
SERVES = 2
TOL = 2e-2                   # bf16 tolerance (tests/test_kernels.py tol())
# flash attention in bf16: ||got - want|| / ||want|| over the whole output.
# Rounding p to bf16 for the PV product and the output to bf16 give about
# half of it at the prefill's shapes on an H100; a kernel that skips one of
# the 32 KV tiles of 128 keys gives thirteen times it and more
# (tools/flash_fault_check.py, PERF.md).
FLASH_REL = 5e-3
# grouped_gemm in bf16: the same relative limit over the whole output. Its
# f32 sums run in another order than the plain version's and the output is
# rounded to bf16: about 2e-4 at the path shapes on an H100.
GEMM_REL = 5e-3
# the continuous serve: requests, arrivals per step, prompt and new-token
# ranges (inclusive), page size; slots are the preset's batch
REQUESTS, RATE, PROMPTS, NEWS, PAGE = 256, 4.0, (4, 32), (8, 32), 16
CMAX_LEN = PROMPTS[1] + NEWS[1]
# paged attention sums in f32 over up to 32k positions in another order
# than its plain version
PAGED_TOL = 1e-4
KV_PAGES = 2048              # page-table width of the paged kernel phase
DS_KV_PAGES = 2048           # likewise, DeepSeek-V3's shared pool (32k tokens)
DEV = torch.device("cuda")
# profiler ranges of one forward's parts (``forward_ranges``)
HEAD_RANGE, MLA_RANGE = "f32 head product (logits_out)", "MLA chunked attention (MlaChunked)"
RANGES = (HEAD_RANGE, MLA_RANGE)
# the prefill forward: batch rows x tokens (one row of 4096 per hosted rank,
# the paper's HT regime); tokens per rank of the HT oracle
PF_BATCH, PF_SEQ, ORACLE_T = 8, 4096, 512
# the hierarchical prefill: the EP mesh of two pods of four (the smallest
# with an inter-pod hop on 8 ranks) and the chunks of the pipeline
HIER_AXES, HIER_CHUNKS = (("pod", 2), ("data", 4)), 2
# readings of dequantize_fp8's time, whose median its record keeps
DEQUANT_REPEATS = 5

# name -> (source, TPU kernel it replaces)
KERNELS = {
    "dispatch_pack": ("src/repro_torch/csrc/dispatch_pack.cu",
                      "src/repro/kernels/dispatch_pack.py:42"),
    "recv_unpack": ("src/repro_torch/csrc/recv_unpack.cu",
                    "src/repro/kernels/recv_unpack.py:43"),
    "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                     "src/repro/kernels/grouped_gemm.py:53"),
    "combine_gather_reduce": ("src/repro_torch/csrc/combine_gather_reduce.cu",
                              "src/repro/kernels/combine_gather_reduce.py:44"),
    "paged_decode_attention": ("src/repro_torch/csrc/paged_decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:112"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:86"),
    "quantize_fp8": ("src/repro_torch/csrc/fp8.cu", "src/repro/kernels/fp8.py:50"),
    "dequantize_fp8": ("src/repro_torch/csrc/fp8.cu", "src/repro/kernels/fp8.py:76"),
    "combine_reduce": ("src/repro_torch/csrc/combine_reduce.cu",
                       "src/repro/kernels/combine_reduce.py:32"),
}
PAGED, FLASH = "paged_decode_attention", "flash_attention"
FLASH_W = "flash_attention (window)"   # B7's launches with a window, among FLASH's
DP_QUANT = "dispatch_pack (quant mode)"
# launch counter -> (wrapper module, its attribute)
COUNTERS = {
    "dispatch_pack": (dp_mod, "launches"),
    DP_QUANT: (dp_mod, "quant_launches"),
    "recv_unpack": (ru_mod, "launches"),
    "grouped_gemm": (gg_mod, "launches"),
    "combine_gather_reduce": (cg_mod, "launches"),
    PAGED: (da_mod, "launches"),
    "paged_decode_attention (stage 2)": (da_mod, "stage2_launches"),
    FLASH: (fa_mod, "launches"), FLASH_W: (fa_mod, "window_launches"),
    "quantize_fp8": (fp8_mod, "quantize_launches"),
    "dequantize_fp8": (fp8_mod, "dequantize_launches"),
    "combine_reduce": (cr_mod, "launches"),
    # the training backward
    "grouped_gemm_dw": (gg_mod, "dw_launches"),
    "combine_gather_reduce_bwd": (cg_mod, "bwd_launches"),
    "flash_attention_bwd": (fa_mod, "bwd_launches"),
}
# EP launches per MoE layer, per hosted rank, per decode step (or forward),
# by path; HT flat runs the nccl_ep phases over its own maps. No path calls
# quantize_fp8 or combine_reduce.
EP_LAUNCHES = {
    "nccl_ep": dict(dispatch_pack=2, recv_unpack=1, dequantize_fp8=0, grouped_gemm=3,
                    combine_gather_reduce=1, quantize_fp8=0, combine_reduce=0),
    "deepep_fp8": dict(dispatch_pack=1, recv_unpack=0, dequantize_fp8=1, grouped_gemm=3,
                       combine_gather_reduce=1, quantize_fp8=0, combine_reduce=0),
    "baseline": dict(dispatch_pack=1, recv_unpack=0, dequantize_fp8=0, grouped_gemm=3,
                     combine_gather_reduce=1, quantize_fp8=0, combine_reduce=0),
}


def hier_launches(nc: int, fp8: bool) -> dict:
    """EP launches per MoE layer and hosted rank of the hierarchical HT
    path with nc chunks (``core/ht.py``): B1 packs each chunk's stage 1;
    B2 fans each chunk's held rows over the pods (and their scales under
    fp8) and finishes the dispatch once; B4 sums the slot domain once, each
    chunk at the rail, and once at the source."""
    return dict(dispatch_pack=nc, recv_unpack=nc * (2 if fp8 else 1) + 1,
                dequantize_fp8=0, grouped_gemm=3, combine_gather_reduce=nc + 2,
                quantize_fp8=0, combine_reduce=0)


EP_LAUNCHES["hier"] = hier_launches(HIER_CHUNKS, True)
# the layouts that land rows by position: their transposes are swaps
POSITIONAL_PATHS = ("deepep", "deepep_fp8", "baseline")


def ep_transpose_launches(path: str, chunks: int = HIER_CHUNKS) -> tuple[dict, dict]:
    """EP launches of one backward per MoE layer and hosted rank on
    ``path``, as (the dispatch's transpose, the combine's): on ``nccl_ep``
    (and HT flat) B1 packs the cotangent through ``comb_send_gmap`` and B4
    sums it with unit weights, then ``combine_gather_reduce_bwd`` and B2
    through the inverse of ``comb_send_gmap``; the positional layouts swap
    instead of packing and gathering; the hierarchical path sums with B4 at
    the slot domain, at each chunk's rail and at the source, and packs (B1)
    and fans (B2) each chunk of the combine's cotangent, in copy mode,
    before ``combine_gather_reduce_bwd``."""
    if path == "hier":
        return (dict(combine_gather_reduce=chunks + 2),
                dict(dispatch_pack=chunks, recv_unpack=chunks, combine_gather_reduce_bwd=1))
    if path in POSITIONAL_PATHS:
        return dict(combine_gather_reduce=1), dict(combine_gather_reduce_bwd=1)
    return (dict(dispatch_pack=1, combine_gather_reduce=1),
            dict(combine_gather_reduce_bwd=1, recv_unpack=1))
# the MoE options of each served layout over the decode_32k preset
LAYOUTS = {"deepep_fp8": dict(ll_layout="deepep", quantize_dispatch=True),
           "baseline": dict(ep_mode="baseline")}
# the fixed-batch serves' layouts ("dense" serves the nccl_ep config without EP)
FIXED_PATHS = ("nccl_ep", "deepep_fp8", "baseline", "dense")


def leaves(tree) -> list:
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """A nested dict of ``fn`` of each tensor."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    mla_mod.mla_chunked_calls = mla_mod.mla_chunked_bwd_calls = 0


def mla_calls() -> tuple[int, int]:
    """Calls of MLA's chunked attention Function (``MlaChunked``) since the
    last ``reset_counts``: (forwards, backwards). Plain torch, so kept apart
    from the kernels' launch counters."""
    return mla_mod.mla_chunked_calls, mla_mod.mla_chunked_bwd_calls


def counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def moe_layers(cfg) -> int:
    """MoE layers of a config: those after its dense prefix (none in a
    dense config)."""
    return 0 if cfg.moe is None else cfg.num_layers - cfg.moe.first_k_dense


def hosted(cfg) -> int:
    """EP ranks a one-card server hosts: RANKS, or 1 (no EP) in a dense
    config."""
    return RANKS if cfg.moe else 1


def forward_moe_layers(cfg) -> int:
    """MoE layers one forward runs: the stack's, and the MTP layer's."""
    return moe_layers(cfg) + int(cfg.mtp)


def flash_layers(cfg) -> int:
    """Flash attention launches of one forward: one per GQA layer (and the
    MTP layer's); MLA's prefill takes ``MlaChunked``, plain torch."""
    return 0 if cfg.attn.kind == "mla" else cfg.num_layers + int(cfg.mtp)


def ep_launches(cfg, path: str, chunks: int = HIER_CHUNKS) -> dict:
    """EP launches per MoE layer and hosted rank of one step (or forward)
    of ``cfg`` on ``path``: EP_LAUNCHES[path] (on the hierarchical path,
    ``hier_launches`` of ``chunks`` chunks), and of B1's, those in quant
    mode: under fp8 dispatch each dispatch send (one, or one per chunk on
    the hierarchical path), else none."""
    fp8 = bool(cfg.moe and cfg.moe.quantize_dispatch)
    per = hier_launches(chunks, fp8) if path == "hier" else dict(EP_LAUNCHES[path])
    per[DP_QUANT] = (chunks if path == "hier" else 1) if fp8 else 0
    return per


def check_ep_counts(launches: dict, cfg, steps: int, where: str,
                    path: str = "nccl_ep", ranks: int = RANKS,
                    layers: int | None = None) -> None:
    """The EP launches of ``steps`` steps over ``layers`` MoE layers (the
    stack's by default) and ``ranks`` hosted ranks."""
    layers = moe_layers(cfg) if layers is None else layers
    for name, per in ep_launches(cfg, path).items():
        want = per * layers * ranks * steps
        check(launches[name] == want, f"{name} launched {launches[name]} times "
              f"on {where}, expected {want}")


def record(name: str, err: float, ms: float, plain_ms: float, bnd, library_ms) -> dict:
    """A kernel's line of the JSON; ``launches`` is filled from a main path."""
    source, replaces = KERNELS[name] if name in KERNELS else TRAIN_KERNELS[name]
    return dict(name=name, route="cuda", source=source,
                replaces=replaces, launches=None, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=library_ms)


def call_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls
    (CUDA events, after one warm-up call). For a small kernel this is the
    host's launch rate, not the kernel's time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def is_range(e) -> bool:
    """Whether a profiler event is a ``record_function`` range (on the card,
    the span of the kernels launched inside it), not a kernel."""
    return getattr(e, "is_user_annotation", False) or e.name in RANGES


def device_intervals(prof) -> list[tuple[float, float, str]]:
    """(start_us, end_us, name) of every kernel, copy and set the profiler
    saw on the card, in start order."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and not is_range(e))


def busy_us(iv) -> float:
    """Time the card spent running something: the union of the intervals."""
    total, reach = 0.0, float("-inf")
    for s, e, _ in iv:
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def queued_ms(fn, iters: int) -> tuple[float, bool]:
    """Mean device time of one of ``iters`` back-to-back calls from CUDA
    events, the card held on a spin kernel while the host queues them (for
    twice the time the host took to queue them once), so that the host's
    launch cost is left out; the gaps between kernels on the card are not.
    Also whether the card was still spinning when the last call was queued
    (else the host's pace may show)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_S) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    held = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / iters, held


def device_ms(fn, iters: int) -> float:
    """Mean device time of one call: the card's busy time over ``iters``
    calls, from the profiler's CUDA trace, so host launch cost is left out.
    LEAD_SPINS short spin kernels before the calls and one after, left out
    of the sum, take the place of the events a profiler session can drop at
    its edges. Every call launches the same
    kernels, so a session that saw each kernel a multiple of ``iters`` times
    lost nothing. One in which each kernel was seen within a tenth of a
    multiple of ``iters`` times (k a call) lost a few of its events: the
    time of a call is then the sum over kernels of k times the kernel's
    mean duration. Any other session (a session now and then records none
    of the calls' events, or drops many of them) is run again, twice at
    most; after that the calls are timed with CUDA events behind a spin
    kernel (``queued_ms``), which counts the gaps between kernels too, and
    the fallback is printed."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(1000)
            for _ in range(iters):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        iv = [e for e in device_intervals(prof) if "spin_kernel" not in e[2]]
        seen = Counter(name for _, _, name in iv)
        if iv and all(n % iters == 0 for n in seen.values()):
            return busy_us(iv) / iters / 1e3
        per_call = {name: round(n / iters) for name, n in seen.items()}
        if iv and all(k >= 1 and abs(seen[name] - k * iters) <= max(1, k * iters // 10)
                      for name, k in per_call.items()):
            dur: Counter = Counter()
            for s, e, name in iv:
                dur[name] += e - s
            print(f"  (profiler session {attempt + 1} saw {len(iv)} device events for "
                  f"{iters} calls, a few short; each kernel's mean time times its "
                  f"launches per call)")
            return sum(dur[n] / seen[n] * k for n, k in per_call.items()) / 1e3
        print(f"  (profiler session {attempt + 1} saw {len(iv)} device events for "
              f"{iters} calls; measuring again)")
    ms, held = queued_ms(fn, iters)
    print(f"  (three profiler sessions lost device events: {ms:.4f} ms from CUDA "
          f"events over {iters} calls queued behind a spin kernel"
          f"{'' if held else ', the card idle before the host had queued them all'})")
    return ms


def short_name(name: str) -> str:
    """A profiler kernel name without namespaces, template or argument lists."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].split("::")[-1]


def kernel_names(fn) -> list[str]:
    """The distinct names (without their argument lists) of the kernels one
    call of ``fn`` ran on the card, from a profiler session behind
    LEAD_SPINS spins; a session that saw none is run again, twice at most."""
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        names = sorted({short_name(n) for _, _, n in device_intervals(prof)
                        if "spin_kernel" not in n})
        if names:
            return names
    return []


def sdpa_backend(names: list[str]) -> str:
    """The backend of scaled_dot_product_attention that ran these kernels."""
    joined = " ".join(names).lower()
    for key, backend in (("flash", "flash"), ("cudnn", "cuDNN"), ("fmha", "memory-efficient"),
                         ("efficient", "memory-efficient")):
        if key in joined:
            return backend
    return "math"


def bound(nbytes: int, ops: int, ops_rate: float) -> tuple[float, str]:
    """Least time in ms for the work: the larger of bytes over the memory rate
    and operations over the peak rate for their type."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / ops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(t: torch.Tensor, rows: int | None = None) -> int:
    """Bytes of ``t``, or of ``rows`` of its rows (those the data needs)."""
    if rows is None:
        return t.numel() * t.element_size()
    return rows * (t.numel() // t.shape[0]) * t.element_size()


def read_rows(idx: torch.Tensor, n: int) -> int:
    """Rows of an n-row source that a map reads, each once: its distinct
    entries below the sentinel n, however many slots name the same row."""
    return int(torch.unique(idx[idx < n]).numel())


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build() -> None:
    t0 = time.perf_counter()
    _build.library()
    how = ("built" if _build.build_seconds is not None
           else "loaded an existing build of the same sources")
    print(f"kernels: {how} in {time.perf_counter() - t0:.1f} s, {len(_build.SOURCES)} "
          f"sources (nvcc -gencode arch=compute_90a,code=sm_90a, one process per source)")
    fn = None
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "Used" in line and fn is not None:
            print(f"  ptxas {fn}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and " 0 bytes spill stores" not in line:
            print(f"  ptxas {fn}: {line.strip()}")


def padded_gather(rows: torch.Tensor, gmap: torch.Tensor):
    """The library yardstick of the copy-mode gathers (dispatch_pack,
    recv_unpack): one ``index_select`` over ``rows`` with one zero row
    appended for the sentinel, the padding and the index made outside the
    timed call. The port never calls it."""
    padded = torch.cat([rows, torch.zeros_like(rows[:1])])
    idx = gmap.flatten().long()
    return lambda: torch.index_select(padded, 0, idx)


def copy_case(label: str, rows: torch.Tensor, gmap: torch.Tensor, iters: int) -> None:
    """dispatch_pack in copy mode at one of its path shapes: bitwise equal to
    its plain version; the kernel, its plain version and the library
    yardstick timed beside the bound."""
    dt = rows.dtype
    got, _ = dp_mod.dispatch_pack(rows, gmap, out_dtype=dt)
    check(torch.equal(got, ref.dispatch_pack(rows, gmap, None, dt)[0]),
          f"dispatch_pack (copy, {label}) differs from its plain version")
    live = int((gmap < rows.shape[0]).sum())
    bnd = bound(nbytes(rows, read_rows(gmap, rows.shape[0])) + nbytes(got) + nbytes(gmap), 0,
                F32_OPS_S)

    def kernel():
        return dp_mod.dispatch_pack(rows, gmap, out_dtype=dt)
    ms = device_ms(kernel, iters)
    plain_ms = device_ms(lambda: ref.dispatch_pack(rows, gmap, None, dt), iters)
    lib_ms = device_ms(padded_gather(rows, gmap), iters)
    print(f"dispatch_pack copy, {label}: {list(rows.shape)} -> {list(got.shape)}, {live} "
          f"live slots: bitwise equal; kernel {ms:.5f} ms ({call_ms(kernel, iters):.4f} ms "
          f"per call from the host), plain {plain_ms:.5f} ms, library {lib_ms:.5f} ms "
          f"(index_select over rows padded with a zero row), bound {bnd[0]:.5f} ms "
          f"({bnd[1]})")


def kernel_phase(cfg, params) -> dict:
    """Each kernel and its plain version on what rank 0 gets in MoE layer 0."""
    dev, dt, d = DEV, cfg.dtype, cfg.d_model
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    comm = LocalComm(RANKS)
    T = BATCH // RANKS
    group = ep_group(cfg, comm, T)
    L, A = group.local_experts, group.ll_expert_cap
    gen = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.randn((T, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    rs = [route(x.float() @ p["router"], router_config(cfg.moe)) for x in xs]
    hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
    plans = [h.plan for h in hs]
    pl = plans[0]
    print(f"capacities: ll_disp_cap {group.ll_disp_cap}, ll_comb_cap "
          f"{group.ll_comb_cap}, ll_expert_cap {A}; rank 0 expert counts "
          f"{pl.disp_counts.tolist()}")
    out = {}

    def timed(name, err, kernel, plain, bnd, library, shape, iters=50):
        """Time the kernel, its plain version and the library call on the
        card; keep the kernel's line for the JSON."""
        ms, plain_ms = device_ms(kernel, iters), device_ms(plain, iters)
        library_ms = None if library is None else device_ms(library, iters)
        out[name] = record(name, err, ms, plain_ms, bnd, library_ms)
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        print(f"{name} {shape}: max_abs_err {err:.3g}, kernel {ms:.4f} ms on the "
              f"card ({call_ms(kernel, iters):.4f} ms per call from the host), "
              f"plain {plain_ms:.4f} ms{lib}, bound {bnd[0]:.4f} ms ({bnd[1]})")

    # ---- dispatch_pack: rank 0's dispatch send, copy mode (the main path)
    x0, g0 = xs[0], pl.disp_send_gmap
    got, _ = dp_mod.dispatch_pack(x0, g0, out_dtype=dt)
    want, _ = ref.dispatch_pack(x0, g0, None, dt)
    check(torch.equal(got, want), "dispatch_pack (copy) differs from its plain version")
    q, s = dp_mod.dispatch_pack(x0, g0, quant_block=128)
    wq, ws = ref.dispatch_pack(x0, g0, 128)
    check(torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws),
          "dispatch_pack (fp8) differs from its plain version")
    live = int((g0 < T).sum())
    timed("dispatch_pack", max_err(got, want),
          lambda: dp_mod.dispatch_pack(x0, g0, out_dtype=dt),
          lambda: ref.dispatch_pack(x0, g0, None, dt),
          bound(nbytes(x0, read_rows(g0, T)) + nbytes(got) + nbytes(g0), 0, F32_OPS_S),
          padded_gather(x0, g0), f"[{T},{d}] -> {list(got.shape)}")
    fp8_ms = device_ms(lambda: dp_mod.dispatch_pack(x0, g0, quant_block=128), 50)
    fp8_bnd = bound(nbytes(x0, read_rows(g0, T)) + nbytes(q) + nbytes(s) + nbytes(g0),
                    3 * live * d, F32_OPS_S)
    print(f"dispatch_pack fp8 mode: kernel {fp8_ms:.4f} ms, plain "
          f"{device_ms(lambda: ref.dispatch_pack(x0, g0, 128), 50):.4f} ms, "
          f"bound {fp8_bnd[0]:.4f} ms ({fp8_bnd[1]})")

    # ---- recv_unpack: rank 0's dispatch recv into [L, A, H]
    recv0 = comm.all_to_all([ref.dispatch_pack(x, pn.disp_send_gmap, None, dt)[0]
                             for x, pn in zip(xs, plans)])[0].reshape(-1, d)
    gr = pl.disp_recv_gmap
    y3d = ru_mod.recv_unpack(recv0, gr)
    want = ref.recv_unpack(recv0, gr)
    check(torch.equal(y3d, want), "recv_unpack (copy) differs from its plain version")
    qs = [ref.dispatch_pack(x, pn.disp_send_gmap, 128) for x, pn in zip(xs, plans)]
    qrecv = comm.all_to_all([a for a, _ in qs])[0].reshape(-1, d)
    srecv = comm.all_to_all([b for _, b in qs])[0].reshape(qrecv.shape[0], -1)
    check(torch.equal(ru_mod.recv_unpack(qrecv, gr, srecv, out_dtype=dt),
                      ref.recv_unpack(qrecv, gr, srecv, dt)),
          "recv_unpack (fp8 dequant) differs from its plain version")
    live = int((gr < recv0.shape[0]).sum())
    timed("recv_unpack", max_err(y3d, want),
          lambda: ru_mod.recv_unpack(recv0, gr),
          lambda: ref.recv_unpack(recv0, gr),
          bound(nbytes(recv0, read_rows(gr, recv0.shape[0])) + nbytes(y3d) + nbytes(gr), 0,
                F32_OPS_S),
          padded_gather(recv0, gr), f"{list(recv0.shape)} -> {list(y3d.shape)}")

    # ---- grouped_gemm: rank 0's gate projection (up is the same shape) and
    # its down projection, with the ragged counts of this routing (the
    # nccl_ep layout), then both with every row of the 128-row expert
    # region live (the deepep and baseline layouts)
    counts = pl.disp_counts
    w1, w3, w2 = p["w_gate"][:L], p["w_up"][:L], p["w_down"][:L]
    want = ref.grouped_gemm(y3d, w1, counts)
    hmid = (F.silu(want.float()) * ref.grouped_gemm(y3d, w3, counts).float()).to(dt)
    # rows past the count are zero in y3d and hmid, so bmm computes the same
    gate = gemm_case("decode gate, nccl_ep counts", y3d, w1, counts, 10, 10)
    out["grouped_gemm"] = record("grouped_gemm", *gate)
    gemm_case("decode down, nccl_ep counts", hmid, w2, counts, 10, 10)
    full = torch.full_like(counts, A)
    xf = torch.randn((L, A, d), generator=gen, device=dev).to(dt)
    gemm_case("decode gate, full counts", xf, w1, full, 10, 10)
    hf = (F.silu(ref.grouped_gemm(xf, w1, full).float())
          * ref.grouped_gemm(xf, w3, full).float()).to(dt)
    gemm_case("decode down, full counts", hf, w2, full, 10, 10)

    # ---- combine_gather_reduce: rank 0's combine recv
    y3ds = [torch.randn((L, A, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    # ---- dispatch_pack again: rank 0's combine send (copy mode, the same
    # kernel as the dispatch send at another shape)
    copy_case("decode combine send", y3ds[0].reshape(-1, d), pl.comb_send_gmap, 50)
    crecv = comm.all_to_all([ref.dispatch_pack(y.reshape(-1, d), pn.comb_send_gmap, None, dt)[0]
                             for y, pn in zip(y3ds, plans)])[0].reshape(-1, d)
    crows, cw = pl.comb_recv_rows, hs[0].topk_weights
    got = cg_mod.combine_gather_reduce(crecv, crows, cw)
    want = ref.combine_gather_reduce(crecv, crows, cw)
    check(torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL),
          "combine_gather_reduce differs from its plain version beyond 2e-2")
    check(torch.equal(cg_mod.combine_gather_reduce(crecv, crows, cw), got),
          "combine_gather_reduce: two calls differ")
    valid = int((crows < crecv.shape[0]).sum())
    library = None
    if valid == crows.numel():      # no sentinel: embedding_bag is the same sum
        idx, wb = crows.long(), cw.to(dt)   # it wants weights of the table's type

        def library():
            return F.embedding_bag(idx, crecv, per_sample_weights=wb, mode="sum")
    timed("combine_gather_reduce", max_err(got, want),
          lambda: cg_mod.combine_gather_reduce(crecv, crows, cw),
          lambda: ref.combine_gather_reduce(crecv, crows, cw),
          bound(nbytes(crecv, read_rows(crows, crecv.shape[0])) + nbytes(crows) + nbytes(cw)
                + nbytes(got), 2 * valid * d, F32_OPS_S), library,
          f"{list(crecv.shape)} rows {list(crows.shape)}")
    return out


def trace_phase(label: str, run, itl_s: float, untraced: str = "ITL mean"):
    """One more step under the profiler: the card's busy time against the
    untraced step time ``itl_s`` (``untraced`` names it), and where the
    device time goes. Returns the device intervals, the traced wall time in
    seconds and the profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    iv = device_intervals(prof)
    busy = busy_us(iv)
    print(f"trace of one {label}: card busy {busy / 1e3:.2f} ms, "
          f"{len(iv)} device events; idle share {1 - busy / (itl_s * 1e6):.3f} of the "
          f"untraced step ({itl_s * 1e3:.2f} ms {untraced}), "
          f"{1 - busy / wall_us:.3f} of the traced one ({wall_us / 1e3:.2f} ms)")
    by_name: dict[str, list[float]] = {}
    for s, e, name in iv:
        by_name.setdefault(name, []).append(e - s)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, ds in top:
        print(f"  {sum(ds) / 1e3:8.3f} ms  {len(ds):5d}x  {name[:100]}")
    gemm = [e - s for s, e, n in iv if "grouped_gemm_bf16" in n]
    print(f"  grouped_gemm: {sum(gemm) / 1e3:.3f} ms in {len(gemm)} calls, "
          f"{sum(gemm) / busy:.4f} of the busy time")
    return iv, wall_us / 1e6, prof


def serve_prompts(vocab: int, batch: int = BATCH) -> torch.Tensor:
    """The fixed-batch serves' prompts, the same for every server."""
    return torch.randint(0, vocab, (batch, PROMPT), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))


def layout_cfg(cfg, path: str):
    """The decode_32k preset in a served layout ("dense" is the nccl_ep
    config served without EP)."""
    if path in LAYOUTS:
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **LAYOUTS[path]))
    return cfg


def eager(srv: DecodeServer) -> DecodeServer:
    """Step ``srv`` through its uncompiled ``_step_factory()`` step: the
    eager reference of the captured step."""
    srv._serve_step = srv._step_factory()
    return srv


def graph_line(step) -> str:
    """A captured step's capture time and the bytes of its graph's private
    memory pool, from the allocator's segments."""
    pool = tuple(step.graph.pool())
    segs = [s for s in torch.cuda.memory_snapshot() if tuple(s["segment_pool_id"]) == pool]
    return (f"capture {step.capture_s:.4f} s; graph private pool "
            f"{sum(s['total_size'] for s in segs)} bytes reserved, "
            f"{sum(s['allocated_size'] for s in segs)} allocated")


def serve_run(srv: DecodeServer, card: str, path: str, mode: str) -> tuple[dict, dict]:
    """``DecodeServer.serve`` on the seeded prompts, every launch counter
    read. The eager run's counts must be the path's per step; the captured
    run's are those of two steps: the warm-up, and the capture that records
    the launches every later step replays. Returns the launches and the
    metrics."""
    cfg = srv.cfg
    reset_counts()
    metrics = srv.serve(serve_prompts(cfg.vocab, srv.batch), GEN)
    launches = counts()
    if path != "dense":
        check_ep_counts(launches, cfg, PROMPT + GEN if mode == "eager" else 2,
                        f"the {cfg.name} {path} DecodeServer path ({mode})", path)
    check(launches[PAGED] == 0 and launches[FLASH] == 0,
          "the dense decode path launched paged or flash attention")
    if path == "dense":
        check(not any(launches.values()), f"the {cfg.name} serve without EP launched "
              f"{ {k: n for k, n in launches.items() if n} }")
    toks = srv.last_tokens
    check(toks.shape == (srv.batch, GEN + 1) and toks.min() >= 0 and toks.max() < cfg.vocab,
          f"bad token stream {toks.shape}")
    # the fault fields count recoveries, of which a serve without faults has none
    faults = ("degraded_steps", "recovery_count", "checkpoint_restores", "preempted")
    m = {k: v for k, v in metrics.as_dict().items()
         if v is not None and k != "stragglers_flagged" and k not in faults}
    check(all(np.isfinite(v) and v > 0 for v in m.values())
          and metrics.stragglers_flagged >= 0
          and not any(getattr(metrics, k) for k in faults), f"bad metrics {metrics.as_dict()}")
    graph = ""
    if mode == "captured":
        check(srv._serve_step.graph is not None, f"the {path} server captured no graph")
        graph = "; " + graph_line(srv._serve_step)
    print(f"{cfg.name} serve, {path}, {mode} ({card}): ttft {m['ttft_s']:.4f} s, itl mean "
          f"{m['itl_mean_s']:.5f} s, itl p99 {m['itl_p99_s']:.5f} s, "
          f"{m['output_tok_s']:.1f} output tok/s, {m['total_tokens']} tokens{graph}; "
          f"launches {launches}")
    return launches, m


def trace_fixed(path: str, srv: DecodeServer, itl: float) -> None:
    """One replayed step of a captured fixed-batch server under the
    profiler, against its captured ITL mean; its EP launches, read from the
    kernels' names, must be the path's."""
    tok = torch.zeros((srv.batch, 1), dtype=torch.int32, device=DEV)
    iv, _, _ = trace_phase(f"replayed {srv.cfg.name} {path} decode step", lambda: srv.step(tok),
                        itl, "captured ITL mean")
    if path != "dense":
        check_replayed_launches(iv, expected_device_kernels(srv.cfg, path),
                                f"the replayed {path} step")


def fixed_serve_phase(cfg, params, card: str, paths=FIXED_PATHS, serves: int = SERVES,
                      keep: bool = True, batch: int = BATCH, max_len: int = MAX_LEN) -> dict:
    """The fixed-batch main paths: DecodeServer.serve in each of ``paths``
    (for DBRX the preset's LL nccl_ep layout, whose first captured serve is
    the main path, the LL deepep layout with fp8 dispatch, the baseline
    dispatcher and no EP, dense), on the same weights and prompts. Each is
    served ``serves`` times through its captured step and as often through
    the uncompiled step, alternating: every token stream must be bitwise
    equal to the first. The baseline computes every row with the same
    kernels in the same k order as nccl_ep, so its tokens must equal
    nccl_ep's; fp8 changes tokens, so the deepep agreement is reported, and
    the dense server's. With ``keep``, each path's first captured server is
    kept (for the traced replay); without it, its replayed step is traced at
    once and the server closed, so that one server at a time is alive.
    Returns, per path, that server (or None), that serve's launches and the
    ITLs of both modes. ``batch`` x PROMPT prompts, caches of ``max_len``."""
    out = {}
    for path in paths:
        c = layout_cfg(cfg, path)
        ep = 1 if path == "dense" else RANKS
        runs = {"captured": [], "eager": []}
        kept, first, toks = None, None, None
        for _ in range(serves):
            for mode in ("captured", "eager"):
                srv = DecodeServer(c, batch, max_len, ep_size=ep, params=params)
                if mode == "eager":
                    eager(srv)
                launches, m = serve_run(srv, card, path, mode)
                if path == "nccl_ep" and first is None:
                    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                if toks is None:
                    toks = srv.last_tokens
                check(np.array_equal(srv.last_tokens, toks),
                      f"{path}: the {mode} serve's tokens differ from the first serve's")
                runs[mode].append(m)
                if mode == "captured" and first is None:
                    first = launches
                    if keep:
                        kept = srv
                    else:
                        trace_fixed(path, srv, m["itl_mean_s"])
                        srv.close()
                elif mode == "captured":
                    srv.close()
                del srv
                if not keep:
                    gc.collect()
                    torch.cuda.empty_cache()
        means = {k: [m["itl_mean_s"] for m in v] for k, v in runs.items()}
        p99s = {k: [m["itl_p99_s"] for m in v] for k, v in runs.items()}
        print(f"{cfg.name} {path}: tokens bitwise equal over {serves} captured and {serves} "
              f"eager serves; ITL mean captured {means['captured']} s, eager {means['eager']} "
              f"s; ITL p99 captured {p99s['captured']} s, eager {p99s['eager']} s; "
              f"captured/eager mean {np.mean(means['captured']) / np.mean(means['eager']):.4f}")
        if path != "nccl_ep" and "nccl_ep" in out:
            agree = toks == out["nccl_ep"]["tokens"]
            print(f"  greedy tokens equal to the nccl_ep serve: {agree.mean():.4f} of all, "
                  f"{agree[:, 0].mean():.4f} of the first; bitwise equal stream "
                  f"{bool(agree.all())}")
            if path == "baseline":
                check(bool(agree.all()), "the baseline serve's tokens differ from nccl_ep's")
        out[path] = dict(srv=kept, launches=first, tokens=toks,
                         itl=float(np.mean(means["captured"])),
                         itl_eager=float(np.mean(means["eager"])))
    return out


def pipelined_phase(cfg, params, card: str, want: np.ndarray) -> None:
    """DecodeServer(pipeline_depth=2) in the nccl_ep layout, captured: up to
    two steps in flight, the next token fed device to device. Its tokens
    must equal the depth-1 serves'."""
    srv = DecodeServer(cfg, BATCH, MAX_LEN, ep_size=RANKS, params=params, pipeline_depth=2)
    m = srv.serve(serve_prompts(cfg.vocab), GEN)
    check(np.array_equal(srv.last_tokens, want),
          "the pipelined serve's tokens differ from depth 1's")
    print(f"serve, nccl_ep, captured, pipeline_depth 2 ({card}): ttft {m.ttft_s:.4f} s, "
          f"itl mean {m.itl_mean_s:.5f} s, itl p99 {m.itl_p99_s:.5f} s over {GEN - 1} "
          f"steady-state intervals, {m.output_tok_s:.1f} output tok/s; tokens bitwise "
          f"equal to depth 1")
    srv.close()


def oracle_phase(cfg, params) -> None:
    """Each MoE layer's EP output against the dense fallback, same input;
    under fp8 dispatch both sides get the plain quantize->dequantize round
    trip of x."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    for i in range(moe_layers(cfg)):
        p = _index(params["moe_stack"]["moe"], i)
        x = torch.randn((BATCH, 1, cfg.d_model), generator=gen, device=DEV).to(cfg.dtype)
        if cfg.moe.quantize_dispatch:
            x = ref.dequantize_fp8(*ref.quantize_fp8(x, 128), cfg.dtype)
        ep, _ = moe_block(p, x, cfg, LocalComm(RANKS))
        dn = _moe_dense_fallback(p, x, cfg)
        check(ep.shape == dn.shape == x.shape and bool(torch.isfinite(ep).all()),
              f"{cfg.name} MoE layer {i}: bad EP output")
        rel = float((ep.float() - dn.float()).norm() / dn.float().norm())
        print(f"oracle: {cfg.name} MoE layer {i} EP vs dense relative error {rel:.3g} "
              f"(limit {TOL})")
        check(rel <= TOL, f"{cfg.name} MoE layer {i}: EP output off the dense fallback by {rel}")
        del ep, dn


class RecordingComm(LocalComm):
    """``LocalComm`` that logs, for each all-to-all, the bytes of rank 0's
    send and receive buffers, read from the tensors."""

    def __init__(self, n: int):
        super().__init__(n)
        self.log: list[tuple[int, int]] = []

    def all_to_all(self, sends, axis=None):
        recvs = super().all_to_all(sends, axis)
        self.log.append((sends[0].nbytes, recvs[0].nbytes))
        return recvs


def layout_oracle_phase(cfg, params) -> None:
    """Each MoE layer in the deepep layout (fp8 and bf16 payloads) and
    through the baseline against the dense fallback on the same input; with
    fp8 both sides get the plain quantize->dequantize round trip of x. Then
    one line with each layout's all-to-all buffer bytes per rank and layer."""
    gen = torch.Generator(device=DEV).manual_seed(16)
    cases = {"nccl_ep": {}, "deepep_fp8": LAYOUTS["deepep_fp8"],
             "deepep": dict(ll_layout="deepep"), "baseline": LAYOUTS["baseline"]}
    sizes = {}
    for label, moe in cases.items():
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        for i in range(LAYERS if label != "nccl_ep" else 1):
            p = {k: v[i] for k, v in params["moe_stack"]["moe"].items()}
            x = torch.randn((BATCH, 1, cfg.d_model), generator=gen, device=DEV).to(cfg.dtype)
            if c.moe.quantize_dispatch:
                x = ref.dequantize_fp8(*ref.quantize_fp8(x, 128), cfg.dtype)
            comm = RecordingComm(RANKS)
            ep, _ = moe_block(p, x, c, comm)
            if i == 0:      # dispatch: payload (and scales); combine: the last
                disp = comm.log[:-1]
                sizes[label] = (sum(a for a, _ in disp), sum(b for _, b in disp),
                                *comm.log[-1])
            if label == "nccl_ep":      # oracle_phase holds this layout
                continue
            dn = _moe_dense_fallback(p, x, c)
            check(ep.shape == dn.shape == x.shape and bool(torch.isfinite(ep).all()),
                  f"{label} MoE layer {i}: bad EP output")
            rel = float((ep.float() - dn.float()).norm() / dn.float().norm())
            print(f"oracle: {label} MoE layer {i} EP vs dense relative error {rel:.3g} "
                  f"(limit {TOL})")
            check(rel <= TOL, f"{label} MoE layer {i} off the dense fallback by {rel}")
    mib = 2 ** 20
    print("all-to-all buffer bytes per rank and MoE layer (send / receive, from the "
          "tensors): " + "; ".join(
              f"{k} dispatch {a / mib:.4f} / {b / mib:.4f} MiB, combine {c / mib:.4f} / "
              f"{d / mib:.4f} MiB" for k, (a, b, c, d) in sizes.items()))


def fp8_kernel_phase(cfg, params) -> dict:
    """The standalone fp8 pair. dequantize_fp8 on what rank 0 receives in
    MoE layer 0 of the deepep serve ([L, N·B] rows after the transpose),
    bitwise; quantize_fp8 bitwise at the decode and HT x of a rank, bf16 and
    f32, blocks 128 and 64, bitwise equal to dispatch_pack's quant mode
    through an identity map (the two share one quantizer) and between two
    calls. Returns both records."""
    dev, dt, d = DEV, cfg.dtype, cfg.d_model
    c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **LAYOUTS["deepep_fp8"]))
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    comm = LocalComm(RANKS)
    T = BATCH // RANKS
    group = ep_group(c, comm, T)
    L, qb = group.local_experts, group.cfg.quant_block
    gen = torch.Generator(device=dev).manual_seed(17)
    xs = [torch.randn((T, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    rs = [route(x.float() @ p["router"], router_config(c.moe)) for x in xs]
    hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
    packs = [ref.dispatch_pack(x, h.plan.disp_send_gmap, qb) for x, h in zip(xs, hs)]
    q = slots.swap_blocks(comm.all_to_all([a for a, _ in packs])[0], RANKS, L)
    sc = slots.swap_blocks(comm.all_to_all([b for _, b in packs])[0], RANKS, L)
    got = fp8_mod.dequantize_fp8(q, sc, dt)
    want = ref.dequantize_fp8(q, sc, dt)
    check(torch.equal(got, want), "dequantize_fp8 differs from its plain version")
    bnd = bound(nbytes(q) + nbytes(sc) + nbytes(got), q.numel(), F32_OPS_S)
    # its time sits near twice its bound within the spread of one reading:
    # the median of DEQUANT_REPEATS readings says on which side it is
    reps = [device_ms(lambda: fp8_mod.dequantize_fp8(q, sc, dt), 50)
            for _ in range(DEQUANT_REPEATS)]
    ms = float(np.median(reps))
    plain_ms = device_ms(lambda: ref.dequantize_fp8(q, sc, dt), 50)
    print(f"dequantize_fp8 {list(q.shape)} fp8 + {list(sc.shape)} f32 -> {dt}: bitwise "
          f"equal; kernel {ms:.5f} ms on the card, the median of {DEQUANT_REPEATS} readings "
          f"{[round(r, 5) for r in reps]} ({bnd[0] / ms:.3f} of the bound's rate; "
          f"{call_ms(lambda: fp8_mod.dequantize_fp8(q, sc, dt), 50):.4f} "
          f"ms per call from the host), plain {plain_ms:.5f} ms, library none, bound "
          f"{bnd[0]:.5f} ms ({bnd[1]}, {(nbytes(q) + nbytes(sc) + nbytes(got)) / 1e6:.3f} MB)")
    records = {"dequantize_fp8": record("dequantize_fp8", 0.0, ms, plain_ms, bnd, None)}
    del packs, q, sc, got, want

    for rows, xdt, block in ((T, dt, 128), (PF_SEQ, dt, 128), (T, torch.float32, 128),
                             (PF_SEQ, torch.float32, 128), (T, dt, 64), (PF_SEQ, dt, 64)):
        x = (torch.randn((rows, d), generator=gen, device=dev) * 30).to(xdt)
        x[1, :block] = 0.0                                  # an all-zero block: scale 1
        qk, sk = fp8_mod.quantize_fp8(x, block)
        wq, ws = ref.quantize_fp8(x, block)
        check(torch.equal(qk.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(sk, ws),
              f"quantize_fp8 [{rows}, {d}] {xdt} block {block} differs from its plain version")
        ident = torch.arange(rows, device=dev, dtype=torch.int32).view(1, rows)
        pq, ps = dp_mod.dispatch_pack(x, ident, quant_block=block)
        check(torch.equal(pq[0].view(torch.uint8), qk.view(torch.uint8))
              and torch.equal(ps[0], sk),
              f"quantize_fp8 [{rows}, {d}] {xdt} block {block} differs from dispatch_pack")
        q2, s2 = fp8_mod.quantize_fp8(x, block)
        check(torch.equal(q2.view(torch.uint8), qk.view(torch.uint8)) and torch.equal(s2, sk),
              f"quantize_fp8 [{rows}, {d}] {xdt} block {block}: two calls differ")
        bnd = bound(nbytes(x) + nbytes(qk) + nbytes(sk), 2 * x.numel(), F32_OPS_S)
        ms = device_ms(lambda: fp8_mod.quantize_fp8(x, block), 50 if rows == T else 20)
        plain_ms = device_ms(lambda: ref.quantize_fp8(x, block), 20 if rows == T else 5)
        print(f"quantize_fp8 [{rows}, {d}] {xdt} block {block}: bitwise equal to its plain "
              f"version, to dispatch_pack's quant mode and between two calls; kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, library none, bound {bnd[0]:.5f} ms ({bnd[1]})")
        if (rows, xdt, block) == (T, dt, 128):
            records["quantize_fp8"] = record("quantize_fp8", max_err(qk, wq), ms,
                                             plain_ms, bnd, None)
    return records


def combine_reduce_phase(d: int) -> dict:
    """combine_reduce at K = 4 over 16 and 4096 tokens of width d: bf16 within
    2e-2, f32 within 1e-5 of its plain version, bitwise between two calls,
    and bitwise equal to combine_gather_reduce over ``y.view(T·K, d)`` with
    identity rows (the two share one reduce; the weights are f32). The
    library is one ``torch.bmm(w.unsqueeze(1), y)`` on f32 copies, the copies
    made outside the timed call. Returns the record of the bf16 case at 16
    tokens."""
    gen = torch.Generator(device=DEV).manual_seed(18)
    out = None
    for rows, dt, tol in ((BATCH // RANKS, torch.bfloat16, TOL), (PF_SEQ, torch.bfloat16, TOL),
                          (BATCH // RANKS, torch.float32, 1e-5), (PF_SEQ, torch.float32, 1e-5)):
        y = torch.randn((rows, 4, d), generator=gen, device=DEV).to(dt)
        w = torch.rand((rows, 4), generator=gen, device=DEV)
        got = cr_mod.combine_reduce(y, w)
        want = ref.combine_reduce(y, w)
        err = max_err(got, want)
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"combine_reduce [{rows}, 4, {d}] {dt} off its plain version by {err}")
        check(torch.equal(cr_mod.combine_reduce(y, w), got),
              f"combine_reduce [{rows}, 4, {d}] {dt}: two calls differ")
        ident = torch.arange(rows * 4, device=DEV, dtype=torch.int32).view(rows, 4)
        check(torch.equal(cg_mod.combine_gather_reduce(y.view(rows * 4, d), ident, w), got),
              f"combine_reduce [{rows}, 4, {d}] {dt} differs from combine_gather_reduce "
              "over identity rows")
        yf, wf = y.float(), w.float().unsqueeze(1)
        iters = 50 if rows < PF_SEQ else 10
        ms = device_ms(lambda: cr_mod.combine_reduce(y, w), iters)
        plain_ms = device_ms(lambda: ref.combine_reduce(y, w), iters)
        library_ms = device_ms(lambda: torch.bmm(wf, yf), iters)
        bnd = bound(nbytes(y) + nbytes(w) + nbytes(got), 2 * y.numel(), F32_OPS_S)
        print(f"combine_reduce [{rows}, 4, {d}] {dt}: max_abs_err {err:.3g} (limit {tol}), "
              f"bitwise between two calls and equal to combine_gather_reduce over identity "
              f"rows; kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, library {library_ms:.5f} ms "
              f"(torch.bmm on f32 copies), bound {bnd[0]:.5f} ms ({bnd[1]})")
        if out is None:
            out = record("combine_reduce", err, ms, plain_ms, bnd, library_ms)
        del y, w, yf, wf, got, want
    return out


def make_requests(vocab: int, n: int = REQUESTS, seed: int = 4) -> list[Request]:
    """n requests from a numpy seed: Poisson arrivals of RATE per step from
    step 0, prompt and new-token counts uniform in their ranges."""
    rng = np.random.default_rng(seed)
    per_step = rng.poisson(RATE, size=4 * n)
    arrivals = np.repeat(np.arange(per_step.size), per_step)[:n]
    plens = rng.integers(PROMPTS[0], PROMPTS[1] + 1, n)
    news = rng.integers(NEWS[0], NEWS[1] + 1, n)
    return [Request(i, rng.integers(0, vocab, int(plens[i])), int(news[i]),
                    arrival_step=int(arrivals[i])) for i in range(n)]


def served_tokens(cfg, srv: ContinuousDecodeServer, metrics, reqs) -> list:
    """Each request's tokens of a finished ``serve_requests``, once every
    request has completed with in-vocabulary tokens and every page and
    reservation has come back."""
    sched = srv.reqsched
    check(sched.done and metrics.requests_completed == len(reqs),
          f"{metrics.requests_completed} of {len(reqs)} requests completed")
    toks = [sched.tokens_for(r.rid) for r in reqs]
    for r, t in zip(reqs, toks):
        check(len(t) == r.max_new_tokens and t.min() >= 0 and t.max() < cfg.vocab,
              f"request {r.rid}: bad token stream {t}")
    check(sched.alloc.live_count == 0 and sched._reserved == 0
          and sched.alloc.free_count == srv.num_pages,
          f"pages not returned: {sched.alloc.live_count} live, {sched._reserved} reserved")
    return toks


def continuous_phase(cfg, params, card: str, n: int = REQUESTS, seed: int = 4,
                     serves: int = SERVES, keep: bool = True):
    """The continuous-batching main path: ContinuousDecodeServer.
    serve_requests of n requests, ``serves`` times through the captured step
    (the first is the main path) and as often through the uncompiled step,
    alternating, every launch counter read: the eager counts per step, the
    captured ones those of the warm-up and the capture. Every request's
    tokens must be bitwise equal across the runs. With ``keep`` the first
    captured server is kept; without it, its replayed step is traced at once
    and the server closed, so that one server at a time is alive. Returns
    that server (or None) and its launches, the requests, the captured and
    eager ITL means, each request's tokens and the servers' page-table
    width and page count."""
    reqs = make_requests(cfg.vocab, n, seed)
    kept, first, itls, want = None, None, {"captured": [], "eager": []}, None
    for _ in range(serves):
        for mode in ("captured", "eager"):
            srv = ContinuousDecodeServer(cfg, BATCH, CMAX_LEN, ep_size=hosted(cfg),
                                         params=params, page_size=PAGE)
            if mode == "eager":
                eager(srv)
            reset_counts()
            metrics = srv.serve_requests(reqs)
            launches = counts()
            sched, steps = srv.reqsched, metrics.serve_steps
            toks = served_tokens(cfg, srv, metrics, reqs)
            if want is None:
                want = toks
            check(all(np.array_equal(a, b) for a, b in zip(toks, want)),
                  f"the {mode} continuous serve's tokens differ from the first serve's")
            check(metrics.pages_peak <= metrics.pages_dense_equiv,
                  f"pages_peak {metrics.pages_peak} > dense {metrics.pages_dense_equiv}")
            m = metrics.as_dict()
            scalars = {k: v for k, v in m.items() if isinstance(v, (int, float))}
            check(all(np.isfinite(v) and v >= 0 for v in scalars.values()),
                  f"bad metrics {scalars}")
            counted = steps if mode == "eager" else 2
            check_ep_counts(launches, cfg, counted, f"the {cfg.name} continuous path ({mode})")
            # stage 2 runs only where a request of the table's width could be
            # split (not at the serve's 64 tokens)
            split = da_mod.splits_possible(_decode_splits(cfg, srv.max_pages), srv.max_pages,
                                           PAGE)
            for key, want_n in ((PAGED, cfg.num_layers * counted),
                                ("paged_decode_attention (stage 2)",
                                 cfg.num_layers * counted if split else 0)):
                check(launches[key] == want_n, f"{key} launched {launches[key]} "
                      f"times on the continuous path ({mode}), expected {want_n}")
            ivs = np.concatenate([np.asarray(r["itl_s"]) for r in m["per_request"]
                                  if r["itl_s"]])
            graph = ""
            if mode == "captured":
                check(srv._serve_step.graph is not None, "the continuous server captured no graph")
                graph = "; " + graph_line(srv._serve_step)
            print(f"{cfg.name} continuous serve, {mode} ({card}): {n} requests, {steps} steps, "
                  f"{metrics.total_tokens} tokens, {metrics.output_tok_s:.1f} output tok/s; "
                  f"ttft p50 {m['ttft_p50_s']:.4f} s, p95 {m['ttft_p95_s']:.4f} s, "
                  f"p99 {m['ttft_p99_s']:.4f} s; itl mean {m['itl_mean_s']:.5f} s, "
                  f"p50 {m['itl_p50_s']:.5f} s, p95 {m['itl_p95_s']:.5f} s, "
                  f"p99 {m['itl_p99_s']:.5f} s ({ivs.size} intervals); pages peak "
                  f"{metrics.pages_peak} of {metrics.pages_dense_equiv} dense "
                  f"({metrics.pages_peak / metrics.pages_dense_equiv:.3f}){graph}; "
                  f"launches {launches}")
            itls[mode].append(m["itl_mean_s"])
            table = (srv.max_pages, srv.num_pages)
            if mode == "captured" and first is None:
                first = launches
                if keep:
                    kept = srv
                else:
                    trace_continuous(srv, m["itl_mean_s"])
                    srv.close()
            elif mode == "captured":
                srv.close()
            del srv, sched
            if not keep:
                gc.collect()
                torch.cuda.empty_cache()
    print(f"{cfg.name} continuous serve: per-request tokens bitwise equal over {serves} "
          f"captured and {serves} eager serves; ITL mean captured {itls['captured']} s, eager "
          f"{itls['eager']} s; captured/eager {np.mean(itls['captured']) / np.mean(itls['eager']):.4f}")
    return (kept, first, reqs, (float(np.mean(itls["captured"])), float(np.mean(itls["eager"]))),
            {r.rid: t for r, t in zip(reqs, want)}, table)


def mid_stream(srv: ContinuousDecodeServer, reqs, n: int) -> list:
    """n requests of a finished serve that joined after step 0 and left
    before its last step, spread over them."""
    fin = srv.reqsched.finished
    last = max(s.tok_times[-1] for s in fin.values())
    picks = [r for r in reqs if r.arrival_step > 0 and fin[r.rid].tok_times[-1] < last]
    return [picks[len(picks) * (i + 1) // (2 * n)] for i in range(n)]


def solo_phase(cfg, params, reqs, want: dict) -> None:
    """Each of ``reqs`` served alone, one after another through one fresh
    engine (released after), whose pages each finds as the one before left
    them: its tokens must be bitwise equal to its stream among co-residents
    (``want``)."""
    solo = ContinuousDecodeServer(cfg, BATCH, CMAX_LEN, ep_size=RANKS, params=params,
                                  page_size=PAGE)
    t0 = time.perf_counter()
    for r in reqs:
        solo.serve_requests([Request(r.rid, r.prompt, r.max_new_tokens)])
        got = solo.reqsched.tokens_for(r.rid)
        check(np.array_equal(got, want[r.rid]), f"{cfg.name} request {r.rid} alone gives "
              f"{got}, among co-residents {want[r.rid]}")
    solo.close()
    del solo
    gc.collect()
    torch.cuda.empty_cache()
    shown = ", ".join(f"{r.rid} (arrived at step {r.arrival_step}, prompt {r.prompt.size}, "
                      f"{r.max_new_tokens} new)" for r in reqs[:4])
    print(f"solo parity: {len(reqs)} {cfg.name} requests, each served alone in turn through "
          f"one engine, bitwise equal to their streams among co-residents "
          f"({time.perf_counter() - t0:.1f} s): {shown}{', ...' if len(reqs) > 4 else ''}")


def _compare_steps(cfg, params, label: str, steps: int = 4) -> list:
    """Teacher-forced paged and dense decode steps on the same weights and
    tokens, every slot active at the same length. Returns, per step, the
    logits' relative error, whether they are bitwise equal and the median
    over rows of each row's relative error."""
    comm, mp = LocalComm(RANKS), 4
    dense = init_decode_state(cfg, BATCH, steps, DEV)
    paged = init_paged_decode_state(cfg, BATCH * mp, PAGE, DEV)
    tbl = torch.arange(BATCH * mp, dtype=torch.int32, device=DEV).view(BATCH, mp)
    toks = torch.randint(0, cfg.vocab, (BATCH, steps), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5)).to(DEV)
    ones = torch.ones(BATCH, dtype=torch.int32, device=DEV)
    out = []
    for t in range(steps):
        tok = toks[:, t:t + 1]
        ld, dense = lm_decode_step(params, dense, {"tokens": tok}, cfg, comm)
        lp, paged = lm_paged_decode_step(params, paged, dict(
            tokens=tok, page_tbl=tbl, kv_lens=ones * t, active=ones), cfg, comm)
        rel = float((lp - ld).norm() / ld.norm())
        rows = ((lp - ld).norm(dim=-1) / ld.norm(dim=-1)).flatten()
        agree = float((lp.argmax(-1) == ld.argmax(-1)).float().mean())
        print(f"  paged vs dense, {label}, step {t}: logits relative error {rel:.3g}, "
              f"bitwise {torch.equal(lp, ld)}; per row median {float(rows.median()):.3g}, "
              f"max {float(rows.max()):.3g}, {int((rows > TOL).sum())} of {BATCH} above "
              f"{TOL}; greedy tokens equal {agree:.4f}")
        out.append((rel, torch.equal(lp, ld), float(rows.median())))
    return out


def _first_layer_f32(tree):
    if isinstance(tree, dict):
        return {k: _first_layer_f32(v) for k, v in tree.items()}
    return tree[:1].float()


def paged_vs_dense_phase(cfg, params) -> None:
    """The paged decode step against the dense one. In bf16 the dense path
    rounds the attention probabilities to bf16 before the PV product and the
    paged kernel does not, so from step 1 on the two differ by that rounding,
    amplified through the layers (the MoE routing flips for some rows) and
    carried into each cache. So over every bf16 layer, step 0, where both
    attend over one token and neither rounds, must be bitwise equal, and at
    step 1, after one step of that rounding, the median row's relative error
    must be within 2e-2; later steps are reported. In f32 (the first layer
    only, the first dense one where the config has a dense prefix: the
    layers' f32 weights do not fit beside the bf16 ones) the logits must
    agree within 2e-4 relative at every step, the JAX package's tolerance
    for this comparison
    (tests/test_paged_kv.py::test_paged_step_matches_dense_step_logits)."""
    bf16 = _compare_steps(cfg, params, f"{cfg.name} bf16, {cfg.num_layers} layers")
    check(bf16[0][1], f"{cfg.name} bf16 step 0: the paged and the dense logits differ")
    med1 = bf16[1][2]
    check(med1 <= TOL, f"{cfg.name} bf16 step 1: median row off the dense step's by {med1}")
    stack = "dense_stack" if cfg.moe.first_k_dense else "moe_stack"
    cfg32 = dataclasses.replace(cfg, num_layers=1, dtype=torch.float32, moe=dataclasses.replace(
        cfg.moe, first_k_dense=min(cfg.moe.first_k_dense, 1)))
    p32 = {k: v.float() for k, v in params.items() if not k.endswith("_stack")}
    p32[stack] = _first_layer_f32(params[stack])
    worst = max(rel for rel, _, _ in _compare_steps(cfg32, p32, f"{cfg.name} f32, 1 layer"))
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{cfg.name} paged vs dense decode step: bf16 step 0 bitwise equal, step 1 median "
          f"row relative error {med1:.3g} (limit {TOL}); f32 logits relative error "
          f"{worst:.3g} (limit 2e-4)")
    check(worst <= 2e-4, f"{cfg.name} f32 paged step logits off the dense step's by {worst}")


def paged_case(rng, B, Hq, Hkv, dk, dv, max_pages, lens, share_kv, dt=torch.bfloat16,
               num_pages=None):
    """Pools of ``num_pages`` pages (default: the live ones and 1024 spare)
    with every live page at a shuffled place, garbage in the rest, the pad
    page last (garbage too), and q, on the card."""
    dev = DEV
    pages = -(-lens // PAGE)
    P = int(pages.sum()) + 1024 if num_pages is None else num_pages
    check(int(pages.sum()) <= P, f"{int(pages.sum())} live pages exceed a pool of {P}")
    perm = rng.permutation(P)
    tbl = np.full((B, max_pages), P, np.int32)
    offs = np.concatenate([[0], np.cumsum(pages)])
    for b in range(B):
        tbl[b, :pages[b]] = perm[offs[b]:offs[b + 1]]
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    kp = torch.randn((P + 1, PAGE, Hkv, dk), generator=gen, device=dev, dtype=dt)
    vp = None if share_kv else torch.randn((P + 1, PAGE, Hkv, dv), generator=gen,
                                           device=dev, dtype=dt)
    q = torch.randn((B, Hq, dk), generator=gen, device=dev, dtype=dt)
    used = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    used[torch.from_numpy(perm[:offs[-1]]).to(dev)] = True
    return q, kp, vp, torch.from_numpy(tbl).to(dev), torch.from_numpy(lens.astype(np.int32)).to(dev), ~used


def check_paged(label, q, kp, vp, tbl, lens, unused, chunk, **kw):
    """Kernel against the plain version (in chunks of ``chunk`` requests),
    idle rows exactly 0, output bitwise unchanged under new garbage."""
    got = da_mod.paged_decode_attention(q, kp, vp, tbl, lens, **kw)
    parts = [slice(i, i + chunk) for i in range(0, q.shape[0], chunk)]

    def plain():
        return torch.cat([ref.paged_decode_attention(q[c], kp, vp, tbl[c], lens[c], **kw)
                          for c in parts])
    want = plain()
    err = max_err(got, want)
    check(torch.allclose(got, want, rtol=PAGED_TOL, atol=PAGED_TOL),
          f"paged_decode_attention ({label}) off its plain version by {err}")
    check(not got[lens == 0].any(), f"paged_decode_attention ({label}): idle rows not 0")
    gen = torch.Generator(device=DEV).manual_seed(9)
    n = int(unused.sum())
    kp[unused] = torch.randn((n,) + kp.shape[1:], generator=gen, device=DEV).mul_(50).to(kp.dtype)
    if vp is not None:
        vp[unused] = torch.randn((n,) + vp.shape[1:], generator=gen, device=DEV).mul_(50).to(vp.dtype)
    check(torch.equal(da_mod.paged_decode_attention(q, kp, vp, tbl, lens, **kw), got),
          f"paged_decode_attention ({label}) changed with the unreferenced pages")
    print(f"paged_decode_attention {label}: max_abs_err {err:.3g} (limit {PAGED_TOL}), "
          f"{int((lens == 0).sum())} idle rows exactly 0, bitwise unchanged under "
          f"new garbage in {n} unreferenced pages")
    return got, err, plain


def paged_bound(lens, q, lt, out, Hkv, dk, dv, elt,
                share: bool = False) -> tuple[tuple[float, str], int]:
    """Bound of one paged attention call: the live K/V rows (of the shared
    pool, one [ckv | k_rope] row, the values its leading dv columns), q,
    the lengths, the table entries read and the output, each moved once;
    2 (dk + dv) operations per live token and query head at the rate of
    the pools' type (bf16). Returns the bound and the bytes."""
    live = int(lens.sum())
    pages_read = int((-(-lens // PAGE)).sum())
    nb = (live * Hkv * (dk if share else dk + dv) * elt + nbytes(q) + nbytes(lt)
          + pages_read * 4 + nbytes(out))
    return bound(nb, 2 * live * q.shape[1] * (dk + dv), BF16_OPS_S), nb


def paged_main_shape_phase(cfg, csrv: ContinuousDecodeServer) -> float:
    """paged_decode_attention at the shapes the continuous serve gives it:
    bf16 pools of the server's num_pages + 1 pages, its page-table width and
    split count, lengths up to CMAX_LEN with idle rows, full rows, exact page
    multiples and ragged tails. Returns the largest error."""
    a = cfg.attn
    Hq, Hkv, d = cfg.padded_heads(), a.n_kv, a.head_dim
    mp = csrv.max_pages
    S = _decode_splits(cfg, mp)
    rng = np.random.default_rng(7)
    lens = rng.integers(1, mp * PAGE + 1, BATCH)
    lens[:8] = 0                                            # idle slots
    lens[8:8 + mp] = np.arange(1, mp + 1) * PAGE            # page multiples, a full row
    lens[8 + mp:16 + mp] = rng.integers(0, mp, 8) * PAGE + rng.integers(1, PAGE, 8)
    q, kp, vp, tbl, lt, unused = paged_case(rng, BATCH, Hq, Hkv, d, d, mp, lens, False,
                                            num_pages=csrv.num_pages)
    pool = next(iter(csrv.state.values()))["k"]
    check(kp.shape == pool.shape[1:] and kp.dtype == pool.dtype,
          f"pool {list(kp.shape)} {kp.dtype} is not the serve's {list(pool.shape[1:])} "
          f"{pool.dtype}")
    kw = dict(scale=d ** -0.5, num_kv_splits=S)
    label = (f"main-path shapes (q [{BATCH}, {Hq}, {d}], pools {list(kp.shape)} "
             f"bf16, table [{BATCH}, {mp}], {S} splits, kv_lens {lens.min()} to "
             f"{lens.max()})")
    out, err, plain = check_paged(label, q, kp, vp, tbl, lt, unused, BATCH, **kw)

    def kernel():
        return da_mod.paged_decode_attention(q, kp, vp, tbl, lt, **kw)
    ms = device_ms(kernel, 50)
    bnd, nb = paged_bound(lens, q, lt, out, Hkv, d, d, kp.element_size())
    print(f"paged_decode_attention at main-path shapes: kernel {ms:.4f} ms on the card "
          f"({call_ms(kernel, 50):.4f} ms per call from the host; stage 2 launched: "
          f"{da_mod.splits_possible(S, mp, PAGE)}), plain {device_ms(plain, 10):.4f} ms, "
          f"bound {bnd[0]:.5f} ms ({bnd[1]}, {nb / 1e6:.3f} MB)")
    return err


def paged_kernel_phase(cfg, main_err: float) -> dict:
    """paged_decode_attention at DBRX decode widths over long contexts, and
    in the shared-pool mode at DeepSeek-V3's absorbed-MLA widths. The JSON
    line's error is the largest of these and ``main_err``."""
    a = cfg.attn
    Hq, Hkv, d = cfg.padded_heads(), a.n_kv, a.head_dim
    B, max_pages = BATCH, KV_PAGES
    S = _decode_splits(cfg, max_pages)
    rng = np.random.default_rng(6)
    lens = rng.integers(1, max_pages * PAGE + 1, B)
    lens[:3] = 0                                            # idle slots
    lens[3] = max_pages * PAGE                              # a full row
    lens[4:8] = rng.integers(1, max_pages, 4) * PAGE        # exact page multiples
    lens[8:12] = rng.integers(1, max_pages - 1, 4) * PAGE + rng.integers(1, PAGE, 4)
    q, kp, vp, tbl, lt, unused = paged_case(rng, B, Hq, Hkv, d, d, max_pages, lens, False)
    kw = dict(scale=d ** -0.5, num_kv_splits=S)
    shape = (f"q [{B}, {Hq}, {d}], pools {list(kp.shape)} bf16 ({2 * kp.numel() * 2 / 1e9:.2f} GB), "
             f"table [{B}, {max_pages}], {S} splits, kv_lens mean {lens.mean():.0f} max {lens.max()}")
    print(f"paged_decode_attention at DBRX widths: {shape}")
    out, err, plain = check_paged("GQA", q, kp, vp, tbl, lt, unused, 16, **kw)

    def kernel():
        return da_mod.paged_decode_attention(q, kp, vp, tbl, lt, **kw)
    ms, plain_ms = device_ms(kernel, 10), device_ms(plain, 2)
    bnd, nbytes_moved = paged_bound(lens, q, lt, out, Hkv, d, d, kp.element_size())
    # yardstick: SDPA over the same K/V gathered dense (padded to the longest
    # row), gather excluded; the port never calls it
    sdpa_ms = 0.0
    L = max_pages * PAGE
    for i in range(0, B, 16):
        c = slice(i, i + 16)
        idx = tbl[c].long()
        kd = kp[idx].reshape(16, L, Hkv, d).transpose(1, 2).contiguous()
        vd = vp[idx].reshape(16, L, Hkv, d).transpose(1, 2).contiguous()
        mask = (torch.arange(L, device=DEV)[None, :] < lt[c][:, None])[:, None, None, :]
        qd = q[c][:, :, None, :]
        sdpa_ms += device_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, scale=d ** -0.5, enable_gqa=True), 3)
        del kd, vd
    print(f"paged_decode_attention GQA: kernel {ms:.4f} ms on the card (stage 1 + "
          f"stage 2), plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, "
          f"{nbytes_moved / 1e9:.3f} GB); library none; yardstick only: "
          f"scaled_dot_product_attention over the K/V gathered dense to {L} "
          f"tokens, gather excluded, {sdpa_ms:.4f} ms")
    del q, kp, vp, out
    torch.cuda.empty_cache()

    # absorbed MLA: one shared pool of [ckv | k_rope] rows, values the
    # leading r_kv columns (DeepSeek-V3: 128 heads, 512 + 64)
    Hq, dk, dv, mp = 128, 576, 512, 256
    lens = np.array([mp * PAGE, 1000, 0, 77, 2 * PAGE])
    q, kp, _, tbl, lt, unused = paged_case(rng, lens.size, Hq, 1, dk, dv, mp, lens, True)
    kw = dict(scale=dk ** -0.5, num_kv_splits=4, dv=dv)
    _, mla_err, _ = check_paged(f"share_kv (q [{lens.size}, {Hq}, {dk}], dv {dv}, kv_lens "
                                f"{lens.tolist()})", q, kp, None, tbl, lt, unused,
                                lens.size, **kw)
    return record(PAGED, max(err, mla_err, main_err), ms, plain_ms, bnd, None)


@contextlib.contextmanager
def handle_probe(sink: list):
    """While open, each MoE layer's ``ep_create_handle`` call appends (the
    dropped share of its routed entries, its seconds with the card
    synchronised on both sides) to ``sink``."""
    orig = moe_mod.ep_create_handle

    def probe(group, topk_idx, topk_weights, num_tokens=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = orig(group, topk_idx, topk_weights, num_tokens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        A = group.ht_expert_cap if group.mode == "ht" else group.ll_expert_cap
        kept = sum(int(h.plan.disp_counts.clamp(max=A).sum()) for h in hs)
        total = sum(int(h.tokens_per_expert.sum()) for h in hs)
        sink.append((1 - kept / total, dt))
        return hs
    moe_mod.ep_create_handle = probe
    try:
        yield
    finally:
        moe_mod.ep_create_handle = orig


def prefill_config():
    full = full_config("train_4k")
    return full, dataclasses.replace(full, num_layers=LAYERS)


def hier_config(cfg, **moe):
    """The train_4k preset with the hierarchical HT options: EP over
    ("pod", "data"), two stages, HIER_CHUNKS chunks."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep_axis=tuple(a for a, _ in HIER_AXES), ht_hierarchical=True,
        ht_num_chunks=HIER_CHUNKS, **moe))


def hier_comm() -> LocalComm:
    return LocalComm(RANKS, axes=HIER_AXES)


def prefill_run(label: str, params, cfg, comm, card: str, path: str,
                rows: int = PF_BATCH, seq: int = PF_SEQ, extra: dict | None = None) -> dict:
    """One prefill forward, ``get_model(cfg).forward``, on the seeded batch
    of ``rows`` x ``seq`` tokens with every launch counter read (the EP
    counts must be ``path``'s over the MoE layers and the MTP layer, flash
    attention once per GQA layer and never under MLA), then a second after
    it, timed: its loss must be bitwise equal to the first's. Returns the
    launches, the loss, the wall time, tokens per second, peak memory, the
    dropped shares, the plan's host time and the batch. ``extra``: more
    batch entries (a vlm's ``img_embeds``)."""
    m = cfg.moe
    ranks, nmoe = (1 if comm is None else comm.size), forward_moe_layers(cfg)
    if m is None:
        ep = "dense FFNs, no EP"
    else:
        group = ep_group(cfg, comm, rows * seq // ranks)
        geo = (f"two stages over {comm.axes}, {group.cfg.ht_num_chunks} chunks: C1 "
               f"{group.ht_stage1_cap}, C2 {group.ht_stage2_cap}" if group.hierarchical
               else f"flat: ht_pair_cap {group.ht_pair_cap}")
        ep = (f"EP {group.mode} ({geo}), fp8 dispatch {m.quantize_dispatch} (block "
              f"{group.cfg.quant_block}), capacity factors {m.capacity_factor}/"
              f"{m.expert_capacity_factor}: ht_expert_cap {group.ht_expert_cap}")
    print(f"{label}: {cfg.name} train_4k preset, {cfg.num_layers} layers"
          f"{' + the MTP layer' if cfg.mtp else ''} ({nmoe} MoE), batch {rows} x {seq} "
          f"tokens over {ranks} hosted ranks ({rows * seq // ranks} per rank); {ep}")
    rng = np.random.default_rng(10)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (rows, seq))
                                        .astype(np.int32)).to(DEV), **(extra or {})}
    forward = get_model(cfg).forward
    probes: list = []
    reset_counts()
    with handle_probe(probes):
        loss, aux = forward(params, batch, cfg, comm)
        torch.cuda.synchronize()
    launches = counts()
    check(bool(torch.isfinite(loss)), f"{label}: loss {loss.item()} is not finite")
    check_ep_counts(launches, cfg, 1, f"the {label}", path, ranks, nmoe)
    check(launches[FLASH] == flash_layers(cfg), f"flash_attention launched "
          f"{launches[FLASH]} times in the {label}, expected {flash_layers(cfg)}")
    check(launches[PAGED] == 0, f"the {label} launched paged attention")
    check(len(probes) == nmoe, f"{len(probes)} MoE handles for {nmoe} MoE layers")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss2, _ = forward(params, batch, cfg, comm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(torch.equal(loss, loss2), f"{label}: a repeat gave loss {loss2.item()}, "
          f"the first {loss.item()}")
    ntok = rows * seq
    out = dict(launches=launches, loss=loss.item(), wall=wall, tok_s=ntok / wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               dropped=[round(d, 6) for d, _ in probes],
               plan_s=sum(dt for _, dt in probes), batch=batch)
    per = {k: v / (nmoe * ranks) for k, v in launches.items()
           if k in EP_LAUNCHES[path] and nmoe}
    print(f"{label} ({card}): loss {loss.item():.6f} (aux "
          f"{aux['aux'].item() if 'aux' in aux else 0.0:.6f}; "
          f"ln of the vocabulary {np.log(cfg.vocab):.4f}), repeat bitwise equal; wall "
          f"{wall:.3f} s after a warm-up, {out['tok_s']:.1f} prefill tok/s; peak device "
          f"memory {out['peak_gib']:.2f} GiB; dropped-entry share by MoE layer "
          f"{out['dropped']}; plan host time {out['plan_s']:.3f} s (handle creation, "
          f"card synchronised, in the first forward); launches {launches}; EP launches "
          f"per layer and rank {per}")
    del loss, loss2, aux
    return out


def prefill_phase(params, card: str):
    """The prefill forward under the train_4k preset, HT flat. Returns the
    config and the run's numbers."""
    _, cfg = prefill_config()
    return cfg, prefill_run("prefill forward", params, cfg, LocalComm(RANKS), card,
                            "nccl_ep")


def hier_prefill_phase(params, card: str, flat: dict) -> None:
    """The hierarchical prefill: the same forward with the MoE layers over
    two pods of four, two stages and HIER_CHUNKS chunks; its numbers beside
    the flat preset's from this run."""
    _, cfg = prefill_config()
    hcfg = hier_config(cfg)
    run = prefill_run("hierarchical prefill forward", params, hcfg, hier_comm(), card,
                      "hier")
    prefill_trace_phase(params, hcfg, run["batch"], run["wall"], hier_comm(),
                        "hierarchical prefill forward")
    print(f"hierarchical / flat prefill ({card}): wall {run['wall']:.3f} / "
          f"{flat['wall']:.3f} s, {run['tok_s']:.1f} / {flat['tok_s']:.1f} tok/s, "
          f"peak {run['peak_gib']:.2f} / {flat['peak_gib']:.2f} GiB, dropped shares "
          f"{run['dropped']} / {flat['dropped']}")




@contextlib.contextmanager
def forward_ranges():
    """While open, each f32 head product (``logits_out``) and each call of
    MLA's chunked attention (the loop that ``MlaChunked`` runs) runs inside
    a profiler range named HEAD_RANGE or MLA_RANGE."""
    orig = tf_mod.logits_out, mla_mod._mla_loop

    def ranged(name, fn):
        def run(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return run
    tf_mod.logits_out, mla_mod._mla_loop = ranged(HEAD_RANGE, orig[0]), ranged(MLA_RANGE,
                                                                            orig[1])
    try:
        yield
    finally:
        tf_mod.logits_out, mla_mod._mla_loop = orig


def range_device_us(prof, name: str) -> tuple[int, float, float]:
    """The ``record_function`` ranges named ``name``: their count, their
    device time (the card-side span of each range: the first of its kernels
    to start until the last to end, the profiler's GPU annotation) and of
    it the GEMM kernels' time (each kernel linked to the op that launched
    it, in the range's CPU event)."""
    n, total, gemm = 0, 0.0, 0.0

    def gemms(e) -> float:
        return (sum(k.duration for k in e.kernels if "gemm" in k.name.lower())
                + sum(gemms(c) for c in e.cpu_children))
    for e in prof.events():
        if e.name != name:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.time_range.end - e.time_range.start
        else:
            n += 1
            gemm += gemms(e)
    return n, total, gemm


def prefill_trace_phase(params, cfg, batch, wall: float, comm=None,
                        label: str = "prefill forward") -> None:
    """One traced forward: busy share, time by kernel, flash attention's
    and B4's shares, the f32 head products' and (under MLA) the chunked
    attention's, and the plan's share of the traced forward (handle
    creation with the card synchronised on both sides)."""
    probes: list = []
    comm = comm or LocalComm(RANKS)
    with handle_probe(probes), forward_ranges():
        iv, traced, prof = trace_phase(label, lambda: get_model(cfg).forward(
            params, batch, cfg, comm), wall, "forward")
    busy = busy_us(iv)
    flash_us = sum(e - s for s, e, n in iv if "flash_" in n)
    reduce_us = sum(e - s for s, e, n in iv if "reduce_rows_kernel" in n)
    plan_s = sum(dt for _, dt in probes)
    print(f"  flash attention: {flash_us / 1e3:.3f} ms, {flash_us / busy:.4f} of "
          f"the busy time; combine_gather_reduce: {reduce_us / 1e3:.3f} ms, "
          f"{reduce_us / busy:.4f}; EP plans (handle creation of "
          f"{forward_moe_layers(cfg)} MoE layers x {comm.size} ranks): {plan_s:.3f} s, "
          f"{plan_s / traced:.4f} of the traced forward")
    for name, runs in ((HEAD_RANGE, True), (MLA_RANGE, cfg.attn.kind == "mla")):
        if not runs:
            continue
        n, total, gemm = range_device_us(prof, name)
        check(n > 0 and total > 0, f"{label}: the profiler recorded {n} ranges named "
              f"{name!r} ({total} us on the card): forward_ranges no longer reaches it")
        print(f"  {name}: {n} calls, {total / 1e3:.3f} ms of device time, "
              f"{total / busy:.4f} of the busy time; its GEMM kernels {gemm / 1e3:.3f} "
              f"ms, {gemm / busy:.4f}")


def ht_kernel_phase(cfg, params, comm=None, tokens: int = PF_SEQ, model: str = "") -> None:
    """The EP kernels at a prefill's HT shapes: rank 0 of MoE layer 0 of
    ``cfg`` over ``comm`` (default LocalComm(RANKS)) at ``tokens`` tokens per
    rank. fp8 pack and dequant unpack bitwise against their plain versions,
    the grouped GEMMs and the combine within their limits; every kernel
    timed beside its plain version and bound. ``model`` prefixes the lines."""
    dev, dt, d = DEV, cfg.dtype, cfg.d_model
    p = _index(params["moe_stack"]["moe"], 0)
    comm = comm or LocalComm(RANKS)
    n = comm.size
    group = ep_group(cfg, comm, tokens)
    L, qb = group.local_experts, group.cfg.quant_block
    gen = torch.Generator(device=dev).manual_seed(12)
    xs = [torch.randn((tokens, d), generator=gen, device=dev).to(dt) for _ in range(n)]
    rs = [route(x.float() @ p["router"], router_config(cfg.moe), p.get("sel_bias")) for x in xs]
    hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
    pl = hs[0].plan
    x0, g0 = xs[0], pl.disp_send_gmap
    q, sc = dp_mod.dispatch_pack(x0, g0, quant_block=qb)
    wq, ws = ref.dispatch_pack(x0, g0, qb)
    check(torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(sc, ws),
          f"dispatch_pack (fp8) differs from its plain version at {model}HT shapes")
    live = int((g0 < tokens).sum())
    bnd = bound(nbytes(x0, read_rows(g0, tokens)) + nbytes(q) + nbytes(sc) + nbytes(g0),
                3 * live * d, F32_OPS_S)
    print(f"{model}HT shapes (rank 0 of {n}, MoE layer 0): dispatch_pack fp8 [{tokens}, {d}] -> "
          f"{list(q.shape)} + scales {list(sc.shape)}, {live} live slots: bitwise equal; "
          f"kernel {device_ms(lambda: dp_mod.dispatch_pack(x0, g0, quant_block=qb), 20):.4f} ms, "
          f"plain {device_ms(lambda: ref.dispatch_pack(x0, g0, qb), 5):.4f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})")
    packs = [ref.dispatch_pack(x, h.plan.disp_send_gmap, qb) for x, h in zip(xs, hs)]
    qrecv = comm.all_to_all([a for a, _ in packs])[0].reshape(-1, d)
    srecv = comm.all_to_all([b for _, b in packs])[0].reshape(qrecv.shape[0], -1)
    del packs
    gr = pl.disp_recv_gmap
    y3d = ru_mod.recv_unpack(qrecv, gr, srecv, out_dtype=dt)
    check(torch.equal(y3d, ref.recv_unpack(qrecv, gr, srecv, dt)),
          f"recv_unpack (fp8 dequant) differs from its plain version at {model}HT shapes")
    live = int((gr < qrecv.shape[0]).sum())
    src = read_rows(gr, qrecv.shape[0])
    bnd = bound(nbytes(qrecv, src) + nbytes(srecv, src) + nbytes(y3d) + nbytes(gr),
                live * d, F32_OPS_S)
    print(f"  recv_unpack fp8 dequant {list(qrecv.shape)} -> {list(y3d.shape)}, {live} "
          f"live rows: bitwise equal; kernel "
          f"{device_ms(lambda: ru_mod.recv_unpack(qrecv, gr, srecv, out_dtype=dt), 20):.4f} ms, "
          f"plain {device_ms(lambda: ref.recv_unpack(qrecv, gr, srecv, dt), 5):.4f} ms, "
          f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    counts_ = pl.disp_counts
    w1, w3, w2 = p["w_gate"][:L], p["w_up"][:L], p["w_down"][:L]
    del qrecv, srecv
    # the HT combine send: dispatch_pack's copy mode over the expert regions
    copy_case(f"{model}HT combine send", y3d.reshape(-1, d), pl.comb_send_gmap, 20)
    gemm_case(f"{model}HT gate", y3d, w1, counts_, 5, 2)
    hmid = (F.silu(ref.grouped_gemm(y3d, w1, counts_).float())
            * ref.grouped_gemm(y3d, w3, counts_).float()).to(dt)
    gemm_case(f"{model}HT down", hmid, w2, counts_, 5, 2)
    del hmid
    crecv = torch.randn((n * group.ht_pair_cap, d), generator=gen, device=dev).to(dt)
    crows, cw = pl.comb_recv_rows, hs[0].topk_weights
    got = cg_mod.combine_gather_reduce(crecv, crows, cw)
    want = ref.combine_gather_reduce(crecv, crows, cw)
    err = max_err(got, want)
    check(torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL),
          f"combine_gather_reduce differs from its plain version beyond 2e-2 at {model}HT shapes")
    check(torch.equal(cg_mod.combine_gather_reduce(crecv, crows, cw), got),
          f"combine_gather_reduce: two calls differ at {model}HT shapes")
    del want
    valid = int((crows < crecv.shape[0]).sum())
    bnd = bound(nbytes(crecv, read_rows(crows, crecv.shape[0])) + nbytes(crows) + nbytes(cw)
                + nbytes(got), 2 * valid * d, F32_OPS_S)
    lib = "none (sentinel rows)"
    if valid == crows.numel():      # no sentinel: embedding_bag is the same sum
        idx, wb = crows.long(), cw.to(dt)
        lib = f"{device_ms(lambda: F.embedding_bag(idx, crecv, per_sample_weights=wb, mode='sum'), 20):.4f} ms (embedding_bag)"
    print(f"  combine_gather_reduce {list(crecv.shape)} rows {list(crows.shape)} "
          f"({valid} valid): max_abs_err {err:.3g}, two calls bitwise equal; kernel "
          f"{device_ms(lambda: cg_mod.combine_gather_reduce(crecv, crows, cw), 20):.4f} ms, "
          f"plain {device_ms(lambda: ref.combine_gather_reduce(crecv, crows, cw), 5):.4f} ms, "
          f"library {lib}, bound {bnd[0]:.4f} ms ({bnd[1]})")


def gemm_case(label: str, x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor,
              iters: int, plain_iters: int) -> tuple:
    """grouped_gemm at one of its path shapes against its plain version:
    within TOL per element, within GEMM_REL over the whole output, rows
    past the count exactly zero, two calls bitwise equal. Times the kernel,
    the plain version and ``torch.bmm`` (which computes every row) on the
    card; returns (max_abs_err, ms, plain_ms, bound, bmm_ms)."""
    got = gg_mod.grouped_gemm(x, w, counts)
    want = ref.grouped_gemm(x, w, counts)
    err, rel = flash_errors(got, want)
    L, A, H = x.shape
    c = counts.clamp(max=A)
    check(torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL),
          f"grouped_gemm ({label}) differs from its plain version beyond 2e-2")
    check(rel <= GEMM_REL, f"grouped_gemm ({label}): relative error {rel:.3g} over "
          f"the output, above {GEMM_REL}")
    check(all(not got[l, int(c[l]):].any() for l in range(L)),
          f"grouped_gemm ({label}): rows past the count are not zero")
    check(torch.equal(got, gg_mod.grouped_gemm(x, w, counts)),
          f"grouped_gemm ({label}): two calls differ")
    rows, live_e = int(c.sum()), int((c > 0).sum())
    bnd = bound(live_e * nbytes(w[0]) + nbytes(x[0], rows) + nbytes(got) + nbytes(counts),
                2 * rows * H * w.shape[2], BF16_OPS_S)
    del got, want
    ms = device_ms(lambda: gg_mod.grouped_gemm(x, w, counts), iters)
    plain_ms = device_ms(lambda: ref.grouped_gemm(x, w, counts), plain_iters)
    bmm_ms = device_ms(lambda: torch.bmm(x, w), iters)
    sched = gg_mod.plan(L, A, H, w.shape[2]).schedule
    print(f"grouped_gemm {label}: {list(x.shape)} @ {list(w.shape)}, counts "
          f"{counts.tolist()}, {sched} schedule: max_abs_err {err:.3g}, relative "
          f"{rel:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{bmm_ms:.4f} ms (torch.bmm), bound {bnd[0]:.4f} ms ({bnd[1]}); "
          f"{ms / bnd[0]:.2f}x the bound, {ms / bmm_ms:.2f}x torch.bmm")
    return err, ms, plain_ms, bnd, bmm_ms


def flash_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(largest absolute error, Frobenius-norm relative error)."""
    d = got.float() - want.float()
    return float(d.abs().max()), float(d.norm() / want.float().norm())


def flash_case(label, q, k, v, tol, **kw) -> float:
    """flash_attention_bshd against the plain version on [B, S, H, d]
    tensors; returns the largest error. bf16 (``tol`` = TOL): relative error
    within FLASH_REL and every element within TOL; f32: every element within
    ``tol``."""
    got = fa_mod.flash_attention_bshd(q, k, v, **kw)
    want = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               **kw).transpose(1, 2)
    err, rel = flash_errors(got, want)
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    limits = f"limit {tol}"
    if q.dtype == torch.bfloat16:
        ok = ok and rel <= FLASH_REL
        limits += f"; relative {rel:.3g}, limit {FLASH_REL}"
    print(f"flash_attention {label}: q {list(q.shape)}, k/v {list(k.shape)} {q.dtype}: "
          f"max_abs_err {err:.3g} ({limits})")
    check(ok, f"flash_attention ({label}) off its plain version by {err} (relative {rel})")
    return err


def flash_main_inputs(cfg) -> tuple:
    """q, k, v [B, S, H, d] bf16 at the prefill's shapes (seed 13) and the
    scale: the inputs of the main-path cases."""
    a = cfg.attn
    B, S, Hq, Hkv, d = PF_BATCH, PF_SEQ, cfg.padded_heads(), a.n_kv, a.head_dim
    gen = torch.Generator(device=DEV).manual_seed(13)
    q, k, v = (torch.randn((B, S, h, d), generator=gen, device=DEV).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    return q, k, v, d ** -0.5


# the main-path cases of flash attention: label -> options
FLASH_CASES = {"causal (main path)": {}, "window 1024": dict(window=1024),
               "non-causal": dict(causal=False)}


def flash_kernel_phase(cfg) -> dict:
    """flash_attention at the prefill's shapes ([B, S, H, d] as the model
    gives it): causal, a window of 1024 and non-causal, G = 1 at a smaller
    shape, each within FLASH_REL relative and TOL per element of the plain
    version; f32 within 1e-4; two calls bitwise equal. Times the kernel,
    its plain version and SDPA on the main case, and the kernel, its plain
    version and SDPA on the window and non-causal ones."""
    q, k, v, scale = flash_main_inputs(cfg)
    B, S, Hq, d = q.shape
    Hkv = k.shape[2]
    gen = torch.Generator(device=DEV).manual_seed(15)

    def rand(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEV).to(dt)
    kw = dict(scale=scale)
    err = max(flash_case(f"{label}, G {Hq // Hkv}", q, k, v, TOL, **kw, **extra)
              for label, extra in FLASH_CASES.items())
    g1 = [rand(2, 2048, Hkv, d) for _ in range(3)]
    err = max(err, flash_case("G 1", *g1, TOL, **kw))
    f32 = [rand(1, 1024, n, d, dt=torch.float32) for n in (8, 2, 2)]
    flash_case("f32, G 4", *f32, 1e-4, **kw)
    del g1, f32

    def kernel():
        return fa_mod.flash_attention_bshd(q, k, v, **kw)

    def plain():
        return ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True, **kw)
    out = kernel()
    check(torch.allclose(library().transpose(1, 2).float(), out.float(), rtol=TOL, atol=TOL),
          "scaled_dot_product_attention disagrees with the kernel")
    check(torch.equal(kernel(), out), "flash_attention: two calls on the same inputs differ")
    del out
    ms, plain_ms, library_ms = device_ms(kernel, 10), device_ms(plain, 2), device_ms(library, 10)
    W = 1024                     # live pairs: causal, a window of W, none
    ops, win_ops, nc_ops = (4 * B * Hq * d * n for n in
                            (S * (S + 1) // 2, W * (W + 1) // 2 + (S - W) * W, S * S))
    bnd = bound(ref.hbm_bytes(B, Hq, Hkv, S, S, d, 2), ops, BF16_OPS_S)
    win_ms = device_ms(lambda: fa_mod.flash_attention_bshd(q, k, v, window=W, **kw), 10)
    nc_ms = device_ms(lambda: fa_mod.flash_attention_bshd(q, k, v, causal=False, **kw), 10)
    # the library cells of the other two cases: SDPA non-causal (the same
    # flash backend as the causal call), and SDPA with a boolean band mask for
    # the window, which flash SDPA does not take: the memory-efficient backend,
    # given K/V repeated to the query heads outside the timed call
    pos = torch.arange(S, device=DEV)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    kr, vr = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (kt, vt))

    def nc_library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=False, enable_gqa=True, **kw)

    def win_library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qt, kr, vr, attn_mask=band, **kw)
    for label, lib, extra in (("non-causal", nc_library, dict(causal=False)),
                              (f"window {W}", win_library, dict(window=W))):
        want = fa_mod.flash_attention_bshd(q, k, v, **kw, **extra)
        check(torch.allclose(lib().transpose(1, 2).float(), want.float(), rtol=TOL, atol=TOL),
              f"scaled_dot_product_attention ({label}) disagrees with the kernel")
        del want
    nc_lib_ms, win_lib_ms = device_ms(nc_library, 10), device_ms(win_library, 10)
    win_plain_ms, nc_plain_ms = (device_ms(lambda: ref.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw, **extra), 2)
        for extra in (dict(window=W), dict(causal=False)))
    del kr, vr, band
    print(f"flash_attention at main-path shapes: kernel {ms:.4f} ms on the card "
          f"({call_ms(kernel, 10):.4f} ms per call from the host), plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms (scaled_dot_product_attention, is_causal, "
          f"enable_gqa), bound {bnd[0]:.4f} ms ({bnd[1]}: {ops / 1e12:.3f} TFLOP, "
          f"{ref.hbm_bytes(B, Hq, Hkv, S, S, d, 2) / 1e9:.3f} GB), "
          f"{ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {ms / library_ms:.3f}x the library; "
          f"window {W} {win_ms:.4f} ms ({win_ops / (win_ms * 1e-3) / 1e12:.1f} TFLOP/s), "
          f"plain {win_plain_ms:.4f} ms, "
          f"library {win_lib_ms:.4f} ms (SDPA with a boolean band mask, memory-efficient "
          f"backend), bound {bound(ref.hbm_bytes(B, Hq, Hkv, S, S, d, 2), win_ops, BF16_OPS_S)[0]:.4f} ms; "
          f"non-causal {nc_ms:.4f} ms ({nc_ops / (nc_ms * 1e-3) / 1e12:.1f} TFLOP/s), "
          f"plain {nc_plain_ms:.4f} ms, "
          f"library {nc_lib_ms:.4f} ms (SDPA, is_causal=False, enable_gqa), bound "
          f"{bound(ref.hbm_bytes(B, Hq, Hkv, S, S, d, 2), nc_ops, BF16_OPS_S)[0]:.4f} ms")
    return record(FLASH, err, ms, plain_ms, bnd, library_ms)


def ht_oracle_phase(cfg, params) -> None:
    """The HT layer (MoE layer 0's weights, 512 tokens per rank) against the
    dense fallback at zero drop, without fp8 and with it; both sides get the
    plain quantize->dequantize round trip of x in the fp8 case, so only the
    kernels' second quantization of that x separates them. Then
    ``prefill_moe`` against ``sequential_prefill`` under the preset (fp8,
    capacity 1.25), 2 micro-batches: bitwise."""
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    gen = torch.Generator(device=DEV).manual_seed(14)
    x = torch.randn((RANKS, ORACLE_T, cfg.d_model), generator=gen, device=DEV).to(cfg.dtype)
    zero = dict(capacity_factor=None, expert_capacity_factor=None)
    for fp8 in (False, True):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, quantize_dispatch=fp8,
                                                             **zero))
        xin = ref.dequantize_fp8(*ref.quantize_fp8(x, 128), cfg.dtype) if fp8 else x
        ep, _ = moe_block(p, xin, c, LocalComm(RANKS))
        dn = _moe_dense_fallback(p, xin, c)
        check(ep.shape == dn.shape == x.shape and bool(torch.isfinite(ep).all()),
              "HT oracle: bad EP output")
        rel = float((ep.float() - dn.float()).norm() / dn.float().norm())
        print(f"HT oracle (zero drop, fp8 {fp8}, {ORACLE_T} tokens per rank): EP vs dense "
              f"relative error {rel:.3g} (limit {TOL})")
        check(rel <= TOL, f"HT layer (fp8 {fp8}) off the dense fallback by {rel}")
    L = cfg.moe.num_experts // RANKS
    rcfg = router_config(cfg.moe)

    def router_fn(xt):
        r = route(xt.float() @ p["router"], rcfg)
        return r.topk_idx, r.topk_weights

    group = ep_group(cfg, LocalComm(RANKS), ORACLE_T // 2)

    def expert_fn(rank, y3d, counts_):
        sl = slice(rank * L, (rank + 1) * L)
        return _expert_ffn(group, y3d, counts_, p["w_gate"][sl], p["w_up"][sl],
                           p["w_down"][sl])
    xs = list(x.unbind(0))
    pipe = prefill_moe(group, router_fn, expert_fn, xs, 2)
    seq = sequential_prefill(group, router_fn, expert_fn, xs, 2)
    check(all(torch.equal(a, b) for a, b in zip(pipe, seq)),
          "prefill_moe differs from sequential_prefill")
    print(f"prefill_moe (2 micro-batches of {ORACLE_T // 2} tokens per rank, fp8, "
          f"capacity 1.25) bitwise equal to sequential_prefill")


def hier_roundtrip(cfg, p, xs: list, comm: LocalComm):
    """One hierarchical EP round trip of MoE layer 0 over ``comm``: router,
    handle, dispatch, the layer's SwiGLU experts on B3, combine. Returns
    the group, [(y3d, counts)] and the combined tokens per rank."""
    group = ep_group(cfg, comm, xs[0].shape[0])
    L = group.local_experts
    rs = [route(x.float() @ p["router"], router_config(cfg.moe)) for x in xs]
    hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
    recv = ep_dispatch(group, hs, xs)
    y3ds = [_expert_ffn(group, y, c, p["w_gate"][r * L:(r + 1) * L],
                        p["w_up"][r * L:(r + 1) * L], p["w_down"][r * L:(r + 1) * L])
            for r, (y, c) in zip(comm.ranks, recv)]
    return group, recv, ep_combine(group, hs, y3ds)


def hier_oracle_phase(cfg, params) -> None:
    """The hierarchical HT layer (MoE layer 0, ORACLE_T tokens per rank, two
    pods of four) at zero drop, in bf16 and with fp8 dispatch (fed the
    plain quantize->dequantize round trip of x): against the dense fallback
    within TOL relative, through moe_block; and 2 and 4 chunks against 1,
    the dispatch tensor, its counts and the combined tokens bitwise. Then
    prefill_moe against sequential_prefill over the hierarchical group of
    the preset (fp8, capacity 1.25), 2 micro-batches: bitwise."""
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    gen = torch.Generator(device=DEV).manual_seed(15)
    x = torch.randn((RANKS, ORACLE_T, cfg.d_model), generator=gen, device=DEV).to(cfg.dtype)
    comm = hier_comm()
    zero = dict(capacity_factor=None, expert_capacity_factor=None)
    for fp8 in (False, True):
        xin = ref.dequantize_fp8(*ref.quantize_fp8(x, 128), cfg.dtype) if fp8 else x
        c = hier_config(cfg, quantize_dispatch=fp8, **zero)
        ep, _ = moe_block(p, xin, c, comm)
        dn = _moe_dense_fallback(p, xin, c)
        check(ep.shape == dn.shape == x.shape and bool(torch.isfinite(ep).all()),
              "hierarchical oracle: bad EP output")
        rel = float((ep.float() - dn.float()).norm() / dn.float().norm())
        print(f"hierarchical HT oracle (zero drop, fp8 {fp8}, {HIER_CHUNKS} chunks, "
              f"{ORACLE_T} tokens per rank): EP vs dense relative error {rel:.3g} "
              f"(limit {TOL})")
        check(rel <= TOL, f"hierarchical HT layer (fp8 {fp8}) off the dense fallback by {rel}")
        del ep, dn
        xs = list(xin.unbind(0))
        runs = {}
        for nc in (1, 2, 4):
            cn = dataclasses.replace(c, moe=dataclasses.replace(c.moe, ht_num_chunks=nc))
            runs[nc] = hier_roundtrip(cn, p, xs, comm)
            check(runs[nc][0].cfg.ht_num_chunks == nc, f"{nc} chunks did not resolve")
        _, r1, o1 = runs[1]
        for nc in (2, 4):
            _, rn, on = runs[nc]
            check(all(torch.equal(a, b) and torch.equal(ca, cb)
                      for (a, ca), (b, cb) in zip(r1, rn)),
                  f"fp8 {fp8}: {nc} chunks' dispatch differs from the monolithic one")
            check(all(torch.equal(a, b) for a, b in zip(o1, on)),
                  f"fp8 {fp8}: {nc} chunks' combine differs from the monolithic one")
        print(f"  2 and 4 chunks bitwise equal to 1 (fp8 {fp8}): dispatch tensors "
              f"{list(r1[0][0].shape)}, counts, combined tokens")
        del runs, r1, o1
    L = cfg.moe.num_experts // RANKS
    rcfg = router_config(cfg.moe)
    hcfg = hier_config(cfg)

    def router_fn(xt):
        r = route(xt.float() @ p["router"], rcfg)
        return r.topk_idx, r.topk_weights

    group = ep_group(hcfg, comm, ORACLE_T // 2)
    check(group.hierarchical, "the prefill_moe group is not hierarchical")

    def expert_fn(rank, y3d, counts_):
        sl = slice(rank * L, (rank + 1) * L)
        return _expert_ffn(group, y3d, counts_, p["w_gate"][sl], p["w_up"][sl],
                           p["w_down"][sl])
    xs = list(x.unbind(0))
    pipe = prefill_moe(group, router_fn, expert_fn, xs, 2)
    seq = sequential_prefill(group, router_fn, expert_fn, xs, 2)
    check(all(torch.equal(a, b) for a, b in zip(pipe, seq)),
          "prefill_moe differs from sequential_prefill over the hierarchical group")
    print(f"prefill_moe over the hierarchical group (2 micro-batches of {ORACLE_T // 2} "
          f"tokens per rank, {HIER_CHUNKS} chunks, fp8, capacity 1.25) bitwise equal "
          f"to sequential_prefill")


def unpack_case(label: str, rows: torch.Tensor, gmap: torch.Tensor, iters: int) -> None:
    """recv_unpack in copy mode at a hierarchical stage-2 fan: bitwise
    against its plain version; the kernel, its plain version and the
    library yardstick timed beside the bound."""
    got = ru_mod.recv_unpack(rows, gmap)
    check(torch.equal(got.view(torch.uint8), ref.recv_unpack(rows, gmap).view(torch.uint8)),
          f"recv_unpack (copy, {label}) differs from its plain version")
    live = int((gmap < rows.shape[0]).sum())
    bnd = bound(nbytes(rows, read_rows(gmap, rows.shape[0])) + nbytes(got) + nbytes(gmap), 0,
                F32_OPS_S)
    kernel = lambda: ru_mod.recv_unpack(rows, gmap)  # noqa: E731
    ms = device_ms(kernel, iters)
    plain_ms = device_ms(lambda: ref.recv_unpack(rows, gmap), iters)
    src = rows.view(torch.uint8) if rows.element_size() == 1 else rows
    lib_ms = device_ms(padded_gather(src, gmap), iters)
    print(f"recv_unpack copy, {label}: {list(rows.shape)} {rows.dtype} -> "
          f"{list(got.shape)}, {live} live slots: bitwise equal; kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, library {lib_ms:.5f} ms (index_select over rows padded "
          f"with a zero row), bound {bnd[0]:.5f} ms ({bnd[1]}); {ms / bnd[0]:.2f}x the bound")


def reduce_case(label: str, recv: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
                iters: int) -> None:
    """combine_gather_reduce at one of the hierarchical combine's three
    sums: within TOL of its plain version, two calls bitwise equal; timed
    beside its plain version, the bound and ``embedding_bag`` over recv
    padded with a zero row (the sentinel's; padding outside the timed call,
    the weights in the table's type)."""
    got = cg_mod.combine_gather_reduce(recv, rows, w)
    want = ref.combine_gather_reduce(recv, rows, w)
    err = max_err(got, want)
    check(torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL),
          f"combine_gather_reduce ({label}) differs from its plain version beyond 2e-2")
    check(torch.equal(cg_mod.combine_gather_reduce(recv, rows, w), got),
          f"combine_gather_reduce ({label}): two calls differ")
    del want
    valid = int((rows < recv.shape[0]).sum())
    bnd = bound(nbytes(recv, read_rows(rows, recv.shape[0])) + nbytes(rows) + nbytes(w)
                + nbytes(got), 2 * valid * recv.shape[1], F32_OPS_S)
    padded = torch.cat([recv, torch.zeros_like(recv[:1])])
    idx, wb = rows.long(), w.to(recv.dtype)
    kernel = lambda: cg_mod.combine_gather_reduce(recv, rows, w)  # noqa: E731
    ms = device_ms(kernel, iters)
    plain_ms = device_ms(lambda: ref.combine_gather_reduce(recv, rows, w), max(2, iters // 4))
    lib_ms = device_ms(lambda: F.embedding_bag(idx, padded, per_sample_weights=wb,
                                               mode="sum"), iters)
    print(f"combine_gather_reduce, {label}: recv {list(recv.shape)} rows "
          f"{list(rows.shape)} ({valid} valid) -> {list(got.shape)}: max_abs_err {err:.3g}, "
          f"two calls bitwise equal; kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, library "
          f"{lib_ms:.5f} ms (embedding_bag), bound {bnd[0]:.5f} ms ({bnd[1]}); "
          f"{ms / bnd[0]:.2f}x the bound")


def hier_kernel_phase(cfg, params) -> None:
    """B2 and B4 at the hierarchical prefill's shapes: rank 0 of MoE layer
    0 at 4096 tokens per rank over two pods of four, chunk 0. B2's copy
    mode at the stage-2 fan, on the fp8 payload rows and on their f32
    scale rows; B4 at the combine's three sums (the slot domain of every
    chunk, the rail's sum over pods, the source's over rails)."""
    dev, dt, d = DEV, cfg.dtype, cfg.d_model
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    hcfg = hier_config(cfg)
    comm = hier_comm()
    group = ep_group(hcfg, comm, PF_SEQ)
    qb, ax_i = group.cfg.quant_block, group.cfg.ep_axis[-1]
    gen = torch.Generator(device=dev).manual_seed(16)
    xs = [torch.randn((PF_SEQ, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    rs = [route(x.float() @ p["router"], router_config(hcfg.moe)) for x in xs]
    hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
    pl = hs[0].plan
    packs = [ref.dispatch_pack(x, h.plan.h_gmap1[0], qb) for x, h in zip(xs, hs)]
    del xs
    recv1 = comm.all_to_all([a for a, _ in packs], axis=ax_i)[0].reshape(-1, d)
    recv1_s = comm.all_to_all([b for _, b in packs], axis=ax_i)[0].reshape(recv1.shape[0], -1)
    del packs
    g2 = pl.h_gmap2[0]
    print(f"hierarchical shapes (rank 0, MoE layer 0, chunk 0 of {group.cfg.ht_num_chunks}): "
          f"C1 {group.ht_stage1_cap}, C2 {group.ht_stage2_cap}, expert region "
          f"{group.ht_expert_cap}")
    unpack_case("stage-2 fan, fp8 payload", recv1, g2, 20)
    unpack_case("stage-2 fan, f32 scales", recv1_s, g2, 20)
    del recv1, recv1_s
    L, A = group.local_experts, group.ht_expert_cap
    y = torch.randn((L * A, d), generator=gen, device=dev).to(dt)
    w = torch.cat([pl.h_w_slot, pl.h_w_slot.new_zeros(1)])[pl.h_slot_rows.long()]
    reduce_case("slot domain (every chunk)", y, pl.h_slot_rows, w, 10)
    del y
    back2 = torch.randn((group.outer_size * group.ht_stage2_cap, d), generator=gen,
                        device=dev).to(dt)
    rail = pl.h_rail_rows[0]
    reduce_case("rail, over pods (chunk 0)", back2, rail,
                torch.ones(rail.shape, dtype=torch.float32, device=dev), 10)
    del back2
    back1 = torch.randn((pl.h_gmap1.shape[0] * group.inner_size * group.ht_stage1_cap, d),
                        generator=gen, device=dev).to(dt)
    reduce_case("source, over rails", back1, pl.h_src_rows,
                torch.ones(pl.h_src_rows.shape, dtype=torch.float32, device=dev), 10)


def stream_busy_us(fn, calls: int = 3) -> tuple[float, float, int]:
    """``calls`` calls of ``fn`` under the profiler, after one outside it:
    per call, the card's busy time (the union of its kernels' intervals)
    and the sum of each stream's own busy time, and the number of streams.
    The sum exceeds the union by the time two streams ran at once."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_stream: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_stream.setdefault(e.device_resource_id, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    union = busy_us(sorted(iv for v in by_stream.values() for iv in v))
    per = sum(busy_us(sorted(v)) for v in by_stream.values())
    return union / calls, per / calls, len(by_stream)


def decode_loop_phase(cfg, params, card: str) -> None:
    """Steady-state EP decode (runtime/decode.py): MoE layer 0 of the
    decode_32k group over the 8 hosted ranks, a micro-batch pair of the
    group's 16 tokens per rank, the layer's SwiGLU experts on B3, in the
    nccl_ep, deepep + fp8 and baseline layouts. decode_loop over 4 steps
    (step 1 changes the routing, step 2 replays step 1's inputs, which
    takes the refresh's fast branch, step 3 changes it again) must be
    bitwise equal to naive_decode_step per micro-batch; so must a captured
    steady-state pipelined_decode_step, replayed over a replayed routing
    (the fast branch) and two changed ones. Reports the device and host
    times of the naive pair, the pipelined pair and its replay, of a
    refresh on a replayed routing against ep_create_handle, and how long
    the two chains' streams ran at once."""
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    T, d, dt = BATCH // RANKS, cfg.d_model, cfg.dtype
    for path in ("nccl_ep", "deepep_fp8", "baseline"):
        c = layout_cfg(cfg, path)
        group = ep_group(c, LocalComm(RANKS), T)
        L, rcfg = group.local_experts, router_config(c.moe)

        def router_fn(x):
            r = route(x.float() @ p["router"], rcfg)
            return r.topk_idx, r.topk_weights

        def expert_fn(rank, y3d, counts_):
            sl = slice(rank * L, (rank + 1) * L)
            return _expert_ffn(group, y3d, counts_, p["w_gate"][sl], p["w_up"][sl],
                               p["w_down"][sl])
        gen = torch.Generator(device=DEV).manual_seed(21)

        def pair():
            return [[torch.randn((T, d), generator=gen, device=DEV).to(dt)
                     for _ in range(RANKS)] for _ in range(2)]
        x0, x1, x3 = pair(), pair(), pair()
        steps = [x0, x1, x1, x3]
        outs = decode_loop(group, router_fn, expert_fn, [tuple(s) for s in steps])
        want = {id(s): [naive_decode_step(group, router_fn, expert_fn, s[m]) for m in range(2)]
                for s in (x0, x1, x3)}
        for i, s in enumerate(steps):
            for m in range(2):
                check(all(torch.equal(a, b) for a, b in zip(outs[i][m], want[id(s)][m])),
                      f"{path}: decode_loop step {i} micro-batch {m} differs from the naive step")
        handles = (_handle(group, router_fn, x1[0]), _handle(group, router_fn, x1[1]))
        xa, xb = ([x.clone() for x in mb] for mb in x1)
        side = capture_stream(DEV)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):                    # the warm-up
            pipelined_decode_step(group, router_fn, expert_fn, handles, xa, xb)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=side):
            (oa, ob), _ = pipelined_decode_step(group, router_fn, expert_fn, handles, xa, xb)
        capture_s = time.perf_counter() - t0
        torch.cuda.current_stream().wait_stream(side)

        def feed(s):
            for dst, src in zip(xa + xb, s[0] + s[1]):
                dst.copy_(src)
        for s in (x3, x0, x1):          # two changed routings, then the fast branch
            feed(s)
            graph.replay()
            torch.cuda.synchronize()
            for o, m in ((oa, 0), (ob, 1)):
                check(all(torch.equal(a, b) for a, b in zip(o, want[id(s)][m])),
                      f"{path}: the captured pipelined step differs from the naive step")

        def naive_pair():
            return [naive_decode_step(group, router_fn, expert_fn, x) for x in x1]

        def pipelined():
            return pipelined_decode_step(group, router_fn, expert_fn, handles, x1[0], x1[1])
        routed = [router_fn(x) for x in x1[0]]
        idx, w = [r[0] for r in routed], [r[1] for r in routed]

        def refresh():
            return ep_handle_refresh(group, handles[0], w, idx)

        def create():
            return ep_create_handle(group, idx, w)
        print(f"decode_loop, {path} ({card}): 4 steps bitwise equal to the naive step per "
              f"micro-batch; captured pipelined step (capture {capture_s:.4f} s) bitwise equal "
              f"on replay over a replayed routing and two changed ones")
        for name, fn in (("naive pair", naive_pair), ("pipelined pair", pipelined),
                         ("pipelined pair, replayed graph", graph.replay),
                         ("refresh (replayed routing)", refresh),
                         ("ep_create_handle", create)):
            union, per, n = stream_busy_us(fn)
            print(f"  {name}: card busy {union / 1e3:.4f} ms per call on {n} streams, "
                  f"{call_ms(fn, 3, 3):.4f} ms per call from the host; the streams' own busy "
                  f"times sum to {per / 1e3:.4f} ms: two ran at once for "
                  f"{(per - union) / 1e3:.4f} ms")
        del graph


def expected_device_kernels(cfg, path: str) -> Counter:
    """EP kernel launches of one decode step as the profiler names them:
    ``ep_launches`` x MoE layers x ranks, each wrapper's count under the
    kernel it runs at the decode shapes (B1's copy mode and B2's share
    csrc/gather.cuh's gather_copy_kernel, B1's quant mode runs
    csrc/quant.cuh's quant_lanes_kernel, B2's fused dequant at the 16-byte
    route recv_unpack.cu's dequant16_kernel, B4 csrc/reduce.cuh's
    reduce_rows_kernel)."""
    per = ep_launches(cfg, path)
    quant = per.pop(DP_QUANT)
    names = dict(recv_unpack="dequant16_kernel" if quant else "gather_copy_kernel",
                 grouped_gemm="grouped_gemm_bf16_kernel",
                 combine_gather_reduce="reduce_rows_kernel",
                 dequantize_fp8="dequantize_fp8_kernel", quantize_fp8="quant_lanes_kernel",
                 combine_reduce="reduce_rows_kernel")
    n = moe_layers(cfg) * RANKS
    want: Counter = Counter()
    for w, k in per.items():
        if w == "dispatch_pack":
            want["quant_lanes_kernel"] += quant * n
            want["gather_copy_kernel"] += (k - quant) * n
        elif k:
            want[names[w]] += k * n
    return +want


def check_replayed_launches(iv, want: Counter, where: str) -> None:
    """The EP kernels the profiler saw in one replayed step, by the
    fragments of their names, against ``want`` (``expected_device_kernels``)."""
    got = Counter(frag for _, _, name in iv for frag in want if frag in name)
    print(f"  EP kernels in the replayed step: {dict(got)} (want {dict(want)})")
    check(got == want, f"{where}: the replayed step ran EP kernels {dict(got)}, "
          f"expected {dict(want)}")


def trace_continuous(csrv: ContinuousDecodeServer, itl: float) -> None:
    """One replayed step of a captured continuous server, every slot active
    at CMAX_LEN // 2 tokens, under the profiler against its captured ITL
    mean: its EP launches must be the path's and paged attention must run
    once per layer."""
    cfg, mp = csrv.cfg, csrv.max_pages
    feed = dict(tokens=np.zeros((BATCH, 1), np.int32),
                page_tbl=np.arange(BATCH * mp, dtype=np.int32).reshape(BATCH, mp),
                kv_lens=np.full(BATCH, CMAX_LEN // 2, np.int32),
                active=np.ones(BATCH, np.int32))
    iv, _, _ = trace_phase(f"replayed {cfg.name} continuous step (all {BATCH} slots at "
                        f"{CMAX_LEN // 2} tokens)", lambda: csrv.step_feed(feed), itl,
                        "captured ITL mean")
    check_replayed_launches(iv, expected_device_kernels(cfg, "nccl_ep"),
                            "the replayed continuous step")
    paged = [e - s for s, e, n in iv if "paged_" in n]
    check(len(paged) == cfg.num_layers, f"{len(paged)} paged attention kernels in the "
          f"replayed continuous step, expected {cfg.num_layers}")
    ran = sorted({short_name(n) for _, _, n in iv if "paged_" in n})
    print(f"  paged attention: {sum(paged) / 1e3:.3f} ms, {sum(paged) / busy_us(iv):.4f} "
          f"of the busy time; kernels {ran}")


def replay_trace_phase(fixed: dict, csrv: ContinuousDecodeServer, citl: tuple) -> None:
    """One replayed step of each captured server under the profiler, then
    one step of its uncompiled step on the same server: busy time, device
    events and idle share against the captured and the eager ITL mean, and
    the EP launches per replayed step from the kernels' names."""
    tok = torch.zeros((BATCH, 1), dtype=torch.int32, device=DEV)
    for path, info in fixed.items():
        srv = info["srv"]
        trace_fixed(path, srv, info["itl"])
        step = srv._step_factory()
        trace_phase(f"eager {path} decode step",
                    lambda: step(srv.params, srv.state, {"tokens": tok}),
                    info["itl_eager"], "eager ITL mean")
    trace_continuous(csrv, citl[0])
    step = csrv._step_factory()
    trace_phase(f"eager continuous step (all {BATCH} slots at {CMAX_LEN // 2} tokens)",
                lambda: step(csrv.params, csrv.state, csrv._feed), citl[1], "eager ITL mean")


# ---------------------------------------------------------------------------
# DeepSeek-V3 at full width: MLA (absorbed dense and paged decode), sigmoid
# group-limited routing over 256 experts, fp8 nccl_ep dispatch
# ---------------------------------------------------------------------------

# the 3 dense layers and 2 of the 58 MoE layers (22.5 GB of experts each)
DS_LAYERS = 5
# the continuous serve's requests, from their own seed
DS_REQUESTS, DS_SEED = 64, 14
# the train_4k forward (HT flat, fp8 dispatch, capacity 1.25, MTP on): the 3
# dense layers and 1 MoE layer, plus the MTP layer, a second MoE layer of 256
# experts (about 53 GB); a global batch of 4 x 4096 tokens over 4 hosted EP
# ranks, one row each (S >= 2048: MLA takes MlaChunked)
DS_PF_LAYERS, DS_PF_RANKS, DS_PF_BATCH, DS_PF_SEQ = 4, 4, 4, 4096


def ds_config():
    full = ds_full_config("decode_32k")
    return full, dataclasses.replace(full, num_layers=DS_LAYERS)


def ds_prefill_config():
    full = ds_full_config("train_4k")
    return full, dataclasses.replace(full, num_layers=DS_PF_LAYERS)


def model_record(base: str, label: str, err, ms, plain_ms, bnd, library_ms, launches,
                 model: str = "DeepSeek-V3") -> dict:
    """A row of the kernels JSON at another model's shapes: the kernel's
    own record, named for the model and shape, with the launches of that
    model's main path."""
    r = record(base, err, ms, plain_ms, bnd, library_ms)
    r["name"] = f"{base} [{model} {label}]"
    r["launches"] = launches
    return r


def ds_kernel_phase(cfg, params, launches: dict, paged_launches: dict, table: tuple) -> list:
    """Each kernel of the DeepSeek-V3 path against its plain version at the
    shapes one EP rank gets in MoE layer 0 (16 tokens, 32 local experts, fp8
    blocks of 128), then timed beside its plain version, its bound and a
    library call: B1's quant mode at the dispatch send and its copy mode at
    the combine send, B2's fused dequant, B3's gate and down products, B4
    at top-8; B6 in its shared-pool mode at the serve's shapes and over
    long contexts. Also the card's busy time of ep_create_handle for one MoE
    layer (8 ranks) at E 256, K 8. Returns the JSON rows."""
    dev, dt, d = DEV, cfg.dtype, cfg.d_model
    p = _index(params["moe_stack"]["moe"], 0)
    comm = LocalComm(RANKS)
    T = BATCH // RANKS
    group = ep_group(cfg, comm, T)
    L, A, qb = group.local_experts, group.ll_expert_cap, group.cfg.quant_block
    gen = torch.Generator(device=dev).manual_seed(24)
    xs = [torch.randn((T, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    rcfg = router_config(cfg.moe)
    rs = [route(x.float() @ p["router"], rcfg, p["sel_bias"]) for x in xs]
    idx, w = [r.topk_idx for r in rs], [r.topk_weights for r in rs]
    hs = ep_create_handle(group, idx, w)
    plans = [h.plan for h in hs]
    pl = plans[0]
    print(f"DeepSeek-V3 capacities: ll_disp_cap {group.ll_disp_cap}, ll_comb_cap "
          f"{group.ll_comb_cap}, ll_expert_cap {A}; rank 0's {L} experts hold "
          f"{int(pl.disp_counts.sum())} rows, counts {pl.disp_counts.tolist()}")
    union, per, n = stream_busy_us(lambda: ep_create_handle(group, idx, w))
    print(f"ep_create_handle at E {cfg.moe.num_experts}, K {cfg.moe.top_k}, 8 hosted ranks "
          f"(one MoE layer): card busy {union / 1e3:.4f} ms per call on {n} streams, "
          f"{call_ms(lambda: ep_create_handle(group, idx, w), 3, 3):.4f} ms per call "
          f"from the host")
    rows = []

    def timed(base, label, err, kernel, plain, bnd, library, shape, n_launch, iters=50,
              plain_iters=None):
        ms, plain_ms = device_ms(kernel, iters), device_ms(plain, plain_iters or iters)
        library_ms = None if library is None else device_ms(library, iters)
        rows.append(model_record(base, label, err, ms, plain_ms, bnd, library_ms, n_launch))
        lib = "" if library_ms is None else f", library {library_ms:.5f} ms"
        print(f"{base} [DeepSeek-V3 {label}] {shape}: max_abs_err {err:.3g}, kernel {ms:.5f} ms "
              f"on the card ({call_ms(kernel, iters):.4f} ms per call from the host), plain "
              f"{plain_ms:.5f} ms{lib}, bound {bnd[0]:.5f} ms ({bnd[1]}); {ms / bnd[0]:.2f}x "
              f"the bound")

    # ---- B1 quant mode: rank 0's dispatch send
    g0 = pl.disp_send_gmap
    q, s = dp_mod.dispatch_pack(xs[0], g0, quant_block=qb)
    wq, ws = ref.dispatch_pack(xs[0], g0, qb)
    check(torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws),
          "dispatch_pack (fp8, DeepSeek-V3) differs from its plain version")
    live = int((g0 < T).sum())
    timed("dispatch_pack", "fp8 dispatch send", 0.0,
          lambda: dp_mod.dispatch_pack(xs[0], g0, quant_block=qb),
          lambda: ref.dispatch_pack(xs[0], g0, qb),
          bound(nbytes(xs[0], read_rows(g0, T)) + nbytes(q) + nbytes(s) + nbytes(g0),
                3 * live * d, F32_OPS_S), None, f"[{T}, {d}] -> {list(q.shape)} fp8 + {list(s.shape)} f32",
          launches[DP_QUANT])

    # ---- B2 fused dequant: rank 0's dispatch recv into [L, A, H]
    packs = [ref.dispatch_pack(x, pn.disp_send_gmap, qb) for x, pn in zip(xs, plans)]
    qrecv = comm.all_to_all([a for a, _ in packs])[0].reshape(-1, d)
    srecv = comm.all_to_all([b for _, b in packs])[0].reshape(qrecv.shape[0], -1)
    gr = pl.disp_recv_gmap
    y3d = ru_mod.recv_unpack(qrecv, gr, srecv, out_dtype=dt)
    check(torch.equal(y3d, ref.recv_unpack(qrecv, gr, srecv, dt)),
          "recv_unpack (fp8 dequant, DeepSeek-V3) differs from its plain version")
    live, src = int((gr < qrecv.shape[0]).sum()), read_rows(gr, qrecv.shape[0])
    timed("recv_unpack", "fp8 dispatch recv, fused dequant", 0.0,
          lambda: ru_mod.recv_unpack(qrecv, gr, srecv, out_dtype=dt),
          lambda: ref.recv_unpack(qrecv, gr, srecv, dt),
          bound(nbytes(qrecv, src) + nbytes(srecv, src) + nbytes(y3d) + nbytes(gr),
                live * d, F32_OPS_S), None,
          f"{list(qrecv.shape)} fp8 + {list(srecv.shape)} f32 -> {list(y3d.shape)}",
          launches["recv_unpack"])
    del packs

    # ---- B3: rank 0's gate and down products with this routing's counts
    counts_ = pl.disp_counts
    w1, w3, w2 = p["w_gate"][:L], p["w_up"][:L], p["w_down"][:L]
    gate = gemm_case("DeepSeek-V3 gate, nccl_ep counts", y3d, w1, counts_, 10, 3)
    rows.append(model_record("grouped_gemm", "decode gate", *gate, launches["grouped_gemm"]))
    hmid = (F.silu(ref.grouped_gemm(y3d, w1, counts_).float())
            * ref.grouped_gemm(y3d, w3, counts_).float()).to(dt)
    down = gemm_case("DeepSeek-V3 down, nccl_ep counts", hmid, w2, counts_, 10, 3)
    rows.append(model_record("grouped_gemm", "decode down", *down, launches["grouped_gemm"]))
    del hmid

    # ---- B1 copy mode at the combine send, then B4 at rank 0's combine recv
    y3ds = [torch.randn((L, A, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    yrows, gc0 = y3ds[0].reshape(-1, d), pl.comb_send_gmap
    got, _ = dp_mod.dispatch_pack(yrows, gc0, out_dtype=dt)
    check(torch.equal(got, ref.dispatch_pack(yrows, gc0, None, dt)[0]),
          "dispatch_pack (copy, DeepSeek-V3 combine send) differs from its plain version")
    live = int((gc0 < yrows.shape[0]).sum())
    timed("dispatch_pack", "combine send", 0.0,
          lambda: dp_mod.dispatch_pack(yrows, gc0, out_dtype=dt),
          lambda: ref.dispatch_pack(yrows, gc0, None, dt),
          bound(nbytes(yrows, read_rows(gc0, yrows.shape[0])) + nbytes(got) + nbytes(gc0), 0,
                F32_OPS_S),
          padded_gather(yrows, gc0), f"{list(yrows.shape)} -> {list(got.shape)}",
          launches["dispatch_pack"] - launches[DP_QUANT])
    crecv = comm.all_to_all([ref.dispatch_pack(y.reshape(-1, d), pn.comb_send_gmap, None, dt)[0]
                             for y, pn in zip(y3ds, plans)])[0].reshape(-1, d)
    del y3ds, yrows, got
    crows, cw = pl.comb_recv_rows, hs[0].topk_weights
    got = cg_mod.combine_gather_reduce(crecv, crows, cw)
    want = ref.combine_gather_reduce(crecv, crows, cw)
    check(torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL),
          "combine_gather_reduce (DeepSeek-V3 top-8) differs from its plain version beyond 2e-2")
    check(torch.equal(cg_mod.combine_gather_reduce(crecv, crows, cw), got),
          "combine_gather_reduce (DeepSeek-V3): two calls differ")
    valid = int((crows < crecv.shape[0]).sum())
    library = None
    if valid == crows.numel():
        cidx, wb = crows.long(), cw.to(dt)

        def library():
            return F.embedding_bag(cidx, crecv, per_sample_weights=wb, mode="sum")
    timed("combine_gather_reduce", "top-8 combine recv", max_err(got, want),
          lambda: cg_mod.combine_gather_reduce(crecv, crows, cw),
          lambda: ref.combine_gather_reduce(crecv, crows, cw),
          bound(nbytes(crecv, read_rows(crows, crecv.shape[0])) + nbytes(crows) + nbytes(cw)
                + nbytes(got), 2 * valid * d, F32_OPS_S), library,
          f"{list(crecv.shape)} rows {list(crows.shape)}", launches["combine_gather_reduce"])
    del crecv, got, want, y3d
    torch.cuda.empty_cache()

    # ---- B6, shared-pool mode: q [B, 128, 576] over pools of [ckv | k_rope]
    m = cfg.mla
    Hq, dk, dv = cfg.padded_heads(), m.kv_lora_rank + m.qk_rope_dim, m.kv_lora_rank
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    mp, num_pages = table
    rng = np.random.default_rng(25)
    lens = rng.integers(1, mp * PAGE + 1, BATCH)
    lens[:8] = 0
    lens[8:8 + mp] = np.arange(1, mp + 1) * PAGE
    cases = [("serve shapes", mp, lens, num_pages, 50, 10)]
    lens = rng.integers(1, DS_KV_PAGES * PAGE + 1, BATCH)
    lens[:3] = 0
    lens[3] = DS_KV_PAGES * PAGE
    cases.append(("long contexts", DS_KV_PAGES, lens, None, 10, 2))
    for label, width, lens, pages, iters, plain_iters in cases:
        q, kp, _, tbl, lt, unused = paged_case(rng, BATCH, Hq, 1, dk, dv, width, lens, True,
                                               num_pages=pages)
        kw = dict(scale=scale, num_kv_splits=_decode_splits(cfg, width), dv=dv)
        out, err, plain = check_paged(
            f"DeepSeek-V3 share_kv, {label} (q [{BATCH}, {Hq}, {dk}], pool "
            f"{list(kp.shape)} bf16, table [{BATCH}, {width}], dv {dv}, kv_lens "
            f"{lens.min()} to {lens.max()})", q, kp, None, tbl, lt, unused, 16, **kw)
        bnd, nb = paged_bound(lens, q, lt, out, 1, dk, dv, kp.element_size(), share=True)

        def kernel():
            return da_mod.paged_decode_attention(q, kp, None, tbl, lt, **kw)
        timed(PAGED, f"share_kv, {label}", err, kernel, plain, bnd, None,
              f"{nb / 1e6:.3f} MB, {int(lens.sum())} live tokens", paged_launches[PAGED],
              iters, plain_iters)
        ran = kernel_names(kernel)
        print(f"  {PAGED} [DeepSeek-V3 share_kv, {label}] ran {ran}")
        check("paged_mla_kernel" in ran, f"B6 share_kv at DeepSeek-V3's widths ({label}) "
              f"did not take the shared-pool tensor-core path: {ran}")
        # yardstick only (the port never calls it): SDPA over the pool rows
        # gathered dense (padded to the table's width, gather excluded), the
        # 128 heads as the query rows of the one kv head, V the rows' first
        # dv columns, in chunks of 16 requests
        L, sdpa_ms, backends = width * PAGE, 0.0, set()
        for i in range(0, BATCH, 16):
            c = slice(i, i + 16)
            kd = kp[tbl[c].long()].reshape(16, 1, L, dk)
            vd = kd[..., :dv].contiguous()
            mask = (torch.arange(L, device=DEV)[None, :] < lt[c][:, None])[:, None, None, :]
            qd = q[c][:, None]

            def library():
                return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, scale=scale)
            sdpa_ms += device_ms(library, plain_iters)
            backends.add(sdpa_backend(kernel_names(library)))
            del kd, vd
        print(f"  {PAGED} [DeepSeek-V3 share_kv, {label}]: yardstick "
              f"scaled_dot_product_attention ({', '.join(sorted(backends))} backend) over the "
              f"pool rows gathered dense to {L} tokens, gather excluded, {sdpa_ms:.5f} ms; "
              f"kernel {rows[-1]['ms'] / sdpa_ms:.3f}x it")
        del q, kp, tbl, lt, unused, out
        torch.cuda.empty_cache()
    return rows


def deepseek_phase(card: str) -> list:
    """DeepSeek-V3 at full width, cut to DS_LAYERS layers, on the card alone
    (DBRX's weights are freed first), one server alive at a time: the
    fixed-batch main path captured and eager, the continuous main path
    captured and eager, every request again alone, paged against dense, the
    MoE layers against the dense fallback, and the kernels at DeepSeek's
    shapes. Prints the peak device memory of the phase. Returns the kernels
    JSON rows."""
    full, cfg = ds_config()
    m = cfg.moe
    print(f"DeepSeek-V3 at full width: d_model {cfg.d_model}, MLA {cfg.attn.n_heads} heads "
          f"(q_lora {cfg.mla.q_lora_rank}, kv_lora {cfg.mla.kv_lora_rank}, nope "
          f"{cfg.mla.qk_nope_dim}, rope {cfg.mla.qk_rope_dim}, v {cfg.mla.v_head_dim}), d_ff "
          f"{cfg.d_ff}, {m.num_experts} experts top-{m.top_k} (d_ff_expert {m.d_ff_expert}) + "
          f"{m.shared_experts} shared, sigmoid, {m.n_groups} groups top-{m.topk_groups}, "
          f"selection bias, routed scaling {m.routed_scaling}; LL {m.ll_layout}, fp8 dispatch, "
          f"expert capacity factor {m.expert_capacity_factor}; vocab {cfg.vocab}, {cfg.dtype}; "
          f"num_layers cut from {full.num_layers} to {DS_LAYERS} ({m.first_k_dense} dense, "
          f"{moe_layers(cfg)} MoE) for memory; {RANKS} EP ranks on one card")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, DEV)
    torch.cuda.synchronize()
    print(f"DeepSeek-V3 init: random weights on the card in {time.perf_counter() - t0:.1f} s, "
          f"{sum(t.nbytes for t in leaves(params)) / 2**30:.2f} GiB")
    fixed = fixed_serve_phase(cfg, params, card, ("nccl_ep",), 1, keep=False)
    _, claunches, reqs, _, want, table = continuous_phase(cfg, params, card, DS_REQUESTS,
                                                          DS_SEED, 1, keep=False)
    solo_phase(cfg, params, reqs, want)
    paged_vs_dense_phase(cfg, params)
    oracle_phase(cfg, params)
    rows = ds_kernel_phase(cfg, params, fixed["nccl_ep"]["launches"], claunches, table)
    check(all(r["launches"] for r in rows), "a DeepSeek-V3 kernel was not launched on its "
          f"main path: {[(r['name'], r['launches']) for r in rows]}")
    print(f"DeepSeek-V3 phase: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB (of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def deepseek_forward_phase(card: str) -> None:
    """DeepSeek-V3's train_4k prefill forward with MTP at full width, on the
    card alone once the decode phase's weights are freed: DS_PF_LAYERS
    layers plus the MTP layer over LocalComm(DS_PF_RANKS), DS_PF_BATCH x
    DS_PF_SEQ tokens. The loss finite and bitwise equal on a repeat, the EP
    launches exact for every MoE layer (the MTP layer's too) and hosted
    rank, no flash or paged attention (MLA's prefill takes MlaChunked),
    and the MTP term present: the forward with mtp off, on the same
    parameters less the mtp_* leaves, gives another loss. Then one traced
    forward."""
    full, cfg = ds_prefill_config()
    m = cfg.moe
    print(f"DeepSeek-V3 prefill forward at full width: train_4k preset (HT "
          f"{'hierarchical' if m.ht_hierarchical else 'flat'}, fp8 dispatch "
          f"{m.quantize_dispatch}, capacity factors {m.capacity_factor}/"
          f"{m.expert_capacity_factor}, MTP {cfg.mtp}); num_layers cut from "
          f"{full.num_layers} to {DS_PF_LAYERS} ({m.first_k_dense} dense, {moe_layers(cfg)} "
          f"MoE) plus the MTP layer for memory; widths not cut; global batch "
          f"{DS_PF_BATCH} x {DS_PF_SEQ} (the preset's microbatch of {full.microbatch} rows "
          f"cut to {DS_PF_BATCH}) over {DS_PF_RANKS} EP ranks on one card")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, DEV)
    torch.cuda.synchronize()
    print(f"DeepSeek-V3 forward init: random weights on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(t.nbytes for t in leaves(params)) / 2**30:.2f} GiB")
    comm = LocalComm(DS_PF_RANKS)
    label = "DeepSeek-V3 prefill forward"
    run = prefill_run(label, params, cfg, comm, card, "nccl_ep", DS_PF_BATCH, DS_PF_SEQ)
    ncfg = dataclasses.replace(cfg, mtp=False)
    nparams = {k: v for k, v in params.items() if not k.startswith("mtp")}
    nloss, _ = get_model(ncfg).forward(nparams, run["batch"], ncfg, comm)
    nloss = nloss.item()
    check(np.isfinite(nloss) and nloss != run["loss"], f"{label}: with mtp off the loss "
          f"is {nloss!r}, with it {run['loss']!r}: the MTP term is missing")
    print(f"{label}: without MTP (its {len(params) - len(nparams)} mtp_* leaves dropped) "
          f"loss {nloss:.6f}, with it {run['loss']:.6f}: the MTP term is in the loss")
    prefill_trace_phase(params, cfg, run["batch"], run["wall"], comm, label)
    ht_kernel_phase(cfg, params, comm, DS_PF_BATCH * DS_PF_SEQ // DS_PF_RANKS, "DeepSeek-V3 ")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"DeepSeek-V3 forward phase: peak device memory {peak:.2f} GiB (of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f})")
    del params, nparams, run
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the dense configs of the lm family, whole on one card
# ---------------------------------------------------------------------------

# id -> the name their kernel rows carry
DENSE_ARCHS = {"chatglm3-6b": "ChatGLM3-6B", "internlm2-20b": "InternLM2-20B",
               "minicpm3-4b": "MiniCPM3-4B"}
G3_ARCH, VLM_ARCH = "gemma3-27b", "phi-3-vision-4.2b"
MODEL_NAMES = {**DENSE_ARCHS, G3_ARCH: "Gemma3-27B", VLM_ARCH: "Phi-3-vision-4.2B"}


def dense_paged_row(cfg, model: str, table: tuple, launches: int) -> dict:
    """B6 at the continuous serve's shapes of a dense config (bf16 pools of
    the serve's pages, its table width and split count, lengths up to the
    table's with idle rows): GQA over K and V pools, MLA over the shared
    pool of [ckv | k_rope] (values its leading kv_lora columns). Against
    the plain version, the kernel it ran named, timed."""
    mp, num_pages = table
    rng = np.random.default_rng(31)
    lens = rng.integers(1, mp * PAGE + 1, BATCH)
    lens[:8] = 0
    lens[8:8 + mp] = np.arange(1, mp + 1) * PAGE
    Hq = cfg.padded_heads()
    if cfg.attn.kind == "mla":
        m = cfg.mla
        Hkv, dk, dv, share = 1, m.kv_lora_rank + m.qk_rope_dim, m.kv_lora_rank, True
        scale, want_kernel = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5, "paged_stage1_kernel"
    else:
        a = cfg.attn
        Hkv, dk, dv, share = a.n_kv, a.head_dim, a.head_dim, False
        # the tensor-core GQA path takes head widths 64 and 128; Phi-3-vision's
        # 96 takes the CUDA-core path
        scale, want_kernel = a.head_dim ** -0.5, ("paged_gqa_kernel" if dk in (64, 128)
                                                  else "paged_stage1_kernel")
    q, kp, vp, tbl, lt, unused = paged_case(rng, BATCH, Hq, Hkv, dk, dv, mp, lens, share,
                                            num_pages=num_pages)
    kw = dict(scale=scale, num_kv_splits=_decode_splits(cfg, mp), dv=dv if share else None)
    label = (f"{'share_kv' if share else 'GQA'} at the serve's shapes (q [{BATCH}, {Hq}, {dk}], "
             f"pool {list(kp.shape)} bf16, table [{BATCH}, {mp}], dv {dv}, kv_lens "
             f"{lens.min()} to {lens.max()})")
    out, err, plain = check_paged(f"{model} {label}", q, kp, vp, tbl, lt, unused, BATCH, **kw)

    def kernel():
        return da_mod.paged_decode_attention(q, kp, vp, tbl, lt, **kw)
    ran = kernel_names(kernel)
    check(want_kernel in " ".join(ran), f"B6 at {model}'s shapes ran {ran}, not {want_kernel}")
    bnd, nb = paged_bound(lens, q, lt, out, Hkv, dk, dv, kp.element_size(), share)
    ms, plain_ms = device_ms(kernel, 50), device_ms(plain, 10)
    print(f"{PAGED} [{model} {label}]: kernel {ms:.5f} ms on the card ({call_ms(kernel, 50):.4f} "
          f"ms per call from the host), ran {ran}, plain {plain_ms:.5f} ms, bound "
          f"{bnd[0]:.5f} ms ({bnd[1]}, {nb / 1e6:.3f} MB); {ms / bnd[0]:.2f}x the bound; "
          f"{launches} launches on the continuous path")
    row = model_record(PAGED, "continuous serve", err, ms, plain_ms, bnd, None, launches, model)
    del q, kp, vp, tbl, lt, unused, out
    torch.cuda.empty_cache()
    return row


def live_pairs(S: int, causal: bool = True, window: int | None = None) -> int:
    """(query, key) pairs of one head that a mask leaves live, over S x S."""
    if not causal:
        return S * S
    W = window or S
    return sum(min(i + 1, W) for i in range(S))


def flash_row(model: str, label: str, rows: int, Hq: int, Hkv: int, d: int,
              launches: int, **extra) -> dict:
    """B7 at [rows, PF_SEQ, H, d] bf16 (seed 33) under ``extra`` (a window,
    or causal=False) against the plain version (FLASH_REL relative, TOL per
    element), two calls bitwise, SDPA within TOL: ``is_causal`` with
    ``enable_gqa``, or for a window a boolean band mask on the
    memory-efficient backend, K/V repeated to the query heads outside the
    timed call. The kernel, the plain version and SDPA timed; the bound
    from the mask's live pairs."""
    gen = torch.Generator(device=DEV).manual_seed(33)
    q, k, v = (torch.randn((rows, PF_SEQ, h, d), generator=gen, device=DEV).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    kw = dict(scale=d ** -0.5, **extra)
    G, W, causal = Hq // Hkv, extra.get("window"), extra.get("causal", True)
    err = flash_case(f"{model} {label}" + ("" if "G " in label else f", G {G}"), q, k, v, TOL,
                     **kw)

    def kernel():
        return fa_mod.flash_attention_bshd(q, k, v, **kw)

    def plain():
        return ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if W:
        pos = torch.arange(PF_SEQ, device=DEV)
        band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
        kr, vr = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
        lib_label = "SDPA, a boolean band mask, memory-efficient backend"

        def library():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(qt, kr, vr, attn_mask=band,
                                                      scale=kw["scale"])
    else:
        lib_label = f"SDPA, is_causal={causal}, enable_gqa"

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True,
                                                  scale=kw["scale"])
    out = kernel()
    check(torch.equal(kernel(), out), f"flash_attention at {model}'s {label}: two calls differ")
    check(torch.allclose(library().transpose(1, 2).float(), out.float(), rtol=TOL, atol=TOL),
          f"scaled_dot_product_attention disagrees with the kernel at {model}'s {label}")
    del out
    ms, plain_ms, library_ms = device_ms(kernel, 10), device_ms(plain, 2), device_ms(library, 10)
    ops = 4 * rows * Hq * d * live_pairs(PF_SEQ, causal, W)
    bnd = bound(ref.hbm_bytes(rows, Hq, Hkv, PF_SEQ, PF_SEQ, d, 2), ops, BF16_OPS_S)
    print(f"{FLASH} [{model} {label}] q {list(q.shape)}, k/v {list(k.shape)}: kernel {ms:.4f} ms "
          f"({ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms ({lib_label}; {ms / library_ms:.3f}x), bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}, {ops / 1e12:.4f} TFLOP); {launches} launches in the "
          f"forward")
    row = model_record(FLASH, label, err, ms, plain_ms, bnd, library_ms, launches, model)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def dense_flash_row(cfg, model: str, rows: int, launches: int) -> dict:
    """B7 at a dense GQA config's forward shapes ([rows, PF_SEQ, H, d],
    causal): ``flash_row``."""
    a = cfg.attn
    return flash_row(model, "forward", rows, cfg.padded_heads(), a.n_kv, a.head_dim, launches)


def dense_config_phase(arch: str, card: str) -> list:
    """One dense config at full width and full depth on the card alone: the
    fixed-batch serve, BATCH x (PROMPT + GEN), captured and eager (tokens
    bitwise equal, no kernel launched: the dense-cache decode is plain
    torch); the continuous serve of REQUESTS requests over BATCH slots,
    captured and eager (B6 once a layer and step, streams bitwise equal);
    each traced on one replayed step; the train_4k forward at the preset's
    microbatch of PF_SEQ tokens (B7 once a GQA layer, none under MLA: S >=
    2048 takes MlaChunked), bitwise on a repeat; a vlm's with seeded
    ``img_embeds`` [rows, img_tokens, d_model] in place of the first
    positions' embeddings. Then, the weights freed, B6 at the serve's
    shapes and B7 at the forward's against their plain versions, timed.
    Returns the kernels JSON rows."""
    model = MODEL_NAMES[arch]
    cfg, pcfg = get_config(arch, "decode_32k"), get_config(arch, "train_4k")
    a = cfg.attn
    attn = (f"MLA over {a.n_heads} heads (padded to {cfg.padded_heads()}; q_lora "
            f"{cfg.mla.q_lora_rank}, kv_lora {cfg.mla.kv_lora_rank}, nope {cfg.mla.qk_nope_dim}, "
            f"rope {cfg.mla.qk_rope_dim}, v {cfg.mla.v_head_dim})" if a.kind == "mla" else
            f"{a.n_heads}/{a.n_kv} heads of {a.head_dim}, rope fraction {a.rope_fraction}, "
            f"base {a.rope_base:g}")
    print(f"{model} at full width and depth: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{attn}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied embeddings {cfg.tie_embeddings}, "
          f"{cfg.dtype}; dense, no EP; nothing cut")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, DEV)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    print(f"{model} init: random weights on the card in {time.perf_counter() - t0:.1f} s, "
          f"{n / 1e9:.3f} B parameters, {sum(t.nbytes for t in leaves(params)) / 2**30:.2f} GiB")
    fixed_serve_phase(cfg, params, card, ("dense",), 1, keep=False)
    _, claunches, _, _, _, table = continuous_phase(cfg, params, card, REQUESTS, 4, 1, keep=False)
    label = f"{model} prefill forward"
    extra = None
    if cfg.family == "vlm":
        gen = torch.Generator(device=DEV).manual_seed(35)
        extra = {"img_embeds": torch.randn((pcfg.microbatch, pcfg.img_tokens, pcfg.d_model),
                                           generator=gen, device=DEV).to(pcfg.dtype)}
        label += f" with img_embeds {list(extra['img_embeds'].shape)}"
    flash = prefill_run(label, params, pcfg, None, card, "nccl_ep", pcfg.microbatch,
                        PF_SEQ, extra)["launches"][FLASH]
    print(f"{label}: {pcfg.microbatch} x {PF_SEQ} tokens, the train_4k preset's microbatch, "
          f"not cut")
    del extra
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rows = [dense_paged_row(cfg, model, table, claunches[PAGED])]
    if a.kind != "mla":
        rows.append(dense_flash_row(pcfg, model, pcfg.microbatch, flash))
    print(f"{model} phase: peak device memory {peak:.2f} GiB (of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}); "
          f"{time.perf_counter() - t0:.1f} s")
    return rows


def dense_phase(card: str) -> list:
    """Every dense config in turn, each freed before the next."""
    rows = []
    for arch in DENSE_ARCHS:
        rows += dense_config_phase(arch, card)
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the gemma3 and vlm families (A12a) on one card
# ---------------------------------------------------------------------------

# Gemma3-27B's fixed-batch serve, cut from decode_32k's 128 x 32768 (its 10
# global layers' caches alone would take 320 GiB): 16 rows, caches of 2048
G3_BATCH, G3_MAX_LEN = 16, 2048
G3_PF_ROWS = 2               # the forward's rows, cut from train_4k's 8 (the f32
#                              logits alone are 8 GiB for 2 rows of 4096)
# the ring check: one super-block and the tail at full width, a prompt past
# the local window so that every ring wraps
G3_RING_BATCH, G3_RING_PROMPT = 4, 1100
G3_RING_TOL = 2e-2           # the ring path against its linear-cache reference


def gemma3_peak_gib(cfg, rows: int, seq: int, weights: int) -> float:
    """The forward's reckoned peak: the weights, the tied table's f32 copy
    and the f32 logits of rows x seq tokens, two CE_ROWS blocks of f32
    log-sum-exp temporaries, and one layer's FFN activations (three
    [tokens, d_ff] bf16)."""
    v, d = cfg.padded_vocab(), cfg.d_model
    return (weights + 4 * v * d + 4 * rows * seq * v + 2 * 4 * 1024 * v
            + 3 * 2 * rows * seq * cfg.d_ff) / 2**30


def gemma3_phase(card: str) -> list:
    """Gemma3-27B whole at full width (62 layers: 10 super-blocks of 5
    local + 1 global, a tail of 2 local; random weights drawn on the card):
    the fixed-batch DecodeServer, G3_BATCH x (PROMPT + GEN) over caches of
    G3_MAX_LEN (ring caches of 1024 rows in the local layers), captured and
    eager, tokens bitwise equal, no kernel launched (the dense-cache decode
    is plain torch), the replayed step traced; then the train_4k forward at
    G3_PF_ROWS x PF_SEQ: B7 once a layer (windowed in the local ones), the
    loss finite and bitwise on a repeat, its peak against the reckoned one,
    one forward traced (B7's share of the busy time). Then, the weights
    freed, B7 at the local and global layers' shapes against its plain
    version, timed beside SDPA. Returns the kernels JSON rows."""
    model = MODEL_NAMES[G3_ARCH]
    cfg, pcfg = get_config(G3_ARCH, "decode_32k"), get_config(G3_ARCH, "train_4k")
    a, (loc, glob) = cfg.attn, cfg.local_global
    counts_ = tf_mod._g3_counts(cfg)
    print(f"{model} at full width and depth: {cfg.num_layers} layers ({counts_[2]} super-block(s) "
          f"of {loc} local + {glob} global, a tail of {counts_[3]} local), d_model "
          f"{cfg.d_model}, {a.n_heads}/{a.n_kv} heads of {a.head_dim}, qk-norm {a.qk_norm}, "
          f"local window {cfg.local_window}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied "
          f"embeddings, {cfg.dtype}; dense, no EP; the serve cut from decode_32k's 128 x 32768 "
          f"to {G3_BATCH} x {G3_MAX_LEN}, the forward from train_4k's {pcfg.microbatch} rows "
          f"to {G3_PF_ROWS}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, DEV)
    torch.cuda.synchronize()
    weights = sum(t.nbytes for t in leaves(params))
    n = sum(t.numel() for t in leaves(params))
    print(f"{model} init: random weights on the card in {time.perf_counter() - t0:.1f} s, "
          f"{n / 1e9:.3f} B parameters, {weights / 2**30:.2f} GiB")
    cache = sum(c.k.nbytes + c.v.nbytes for c in tf_mod.init_decode_state(
        cfg, G3_BATCH, G3_MAX_LEN, "meta").values())
    print(f"{model} serve: decode caches {cache / 2**30:.2f} GiB ({G3_BATCH} rows: rings of "
          f"{min(cfg.local_window, G3_MAX_LEN)} in {counts_[2] * loc + counts_[3]} local "
          f"layers, {G3_MAX_LEN} in {counts_[2] * glob} global)")
    fixed = fixed_serve_phase(cfg, params, card, ("dense",), 1, keep=False, batch=G3_BATCH,
                              max_len=G3_MAX_LEN)["dense"]
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{model} serve: ITL captured {fixed['itl']:.5f} s, eager {fixed['itl_eager']:.5f} s; "
          f"peak device memory {serve_peak:.2f} GiB")
    label = f"{model} prefill forward"
    want_peak = gemma3_peak_gib(pcfg, G3_PF_ROWS, PF_SEQ, weights)
    print(f"{label}: reckoned peak {want_peak:.2f} GiB (weights, the tied table in f32, the "
          f"f32 logits, the cross-entropy's blocks, one layer's FFN activations)")
    torch.cuda.reset_peak_memory_stats()
    run = prefill_run(label, params, pcfg, None, card, "nccl_ep", G3_PF_ROWS, PF_SEQ)
    flash, windowed = run["launches"][FLASH], run["launches"][FLASH_W]
    nloc, nglob = counts_[2] * loc + counts_[3], counts_[2] * glob
    check(flash == pcfg.num_layers, f"{label}: B7 launched {flash} times, not once a layer")
    check(windowed == nloc and flash - windowed == nglob, f"{label}: B7 launched {windowed} "
          f"times with a window and {flash - windowed} without, expected {nloc} and {nglob}")
    prefill_trace_phase(params, pcfg, run["batch"], run["wall"], LocalComm(1), label)
    print(f"{label}: {G3_PF_ROWS} x {PF_SEQ} tokens, {flash} B7 launches ({windowed} "
          f"windowed, {flash - windowed} causal); wall {run['wall']:.3f} s, "
          f"{run['tok_s']:.1f} tok/s; peak {run['peak_gib']:.2f} GiB (reckoned {want_peak:.2f})")
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    Hq = cfg.padded_heads()
    rows = [flash_row(model, f"local layers (window {cfg.local_window})", G3_PF_ROWS, Hq,
                      a.n_kv, a.head_dim, windowed, window=cfg.local_window),
            flash_row(model, "global layers (causal)", G3_PF_ROWS, Hq, a.n_kv, a.head_dim,
                      flash - windowed)]
    print(f"{model} phase: {time.perf_counter() - t0:.1f} s")
    return rows


def ring_positions(length: int, wlen: int) -> torch.Tensor:
    """The position each of a ring's ``wlen`` rows holds once ``length``
    tokens were written in order, row p % wlen for position p: the largest
    p < length congruent to the row."""
    rows = torch.arange(wlen, device=DEV)
    return (length - 1) - torch.remainder(length - 1 - rows, wlen)


def ring_contents_err(params, cfg, cache, tokens: torch.Tensor, wlen: int) -> float:
    """The first local layer's ring rows against the keys and values
    recomputed from the tokens at the positions the rows must hold
    (``ring_positions``): that layer's K and V depend on its own token
    alone, so a row holding another position is off by the whole key. The
    largest error over K and V relative to their largest entry."""
    a, length = cfg.attn, tokens.shape[1]
    p0 = _index(_index(params["super"], 0), 0)
    h = rmsnorm(tf_mod._g3_embed(params, tokens, cfg), p0["ln1"], cfg.norm_eps)
    pos = torch.arange(length, device=DEV)[None].expand(tokens.shape[0], length)
    k = apply_rope(torch.einsum("bsd,dhk->bshk", h, p0["attn"]["wk"]), pos, a.rope_base,
                   a.rope_fraction)
    v = torch.einsum("bsd,dhk->bshk", h, p0["attn"]["wv"])
    at = ring_positions(length, wlen)
    return max(float((c.float() - w[:, at].float()).abs().max() / w[:, at].float().abs().max())
               for c, w in ((cache.k[0, 0], k), (cache.v[0, 0], v)))


def ring_live_sets(params, cfg, state, token: torch.Tensor, length: int, wlen: int) -> int:
    """One decode step at position ``length`` on a copy of ``state``, the
    mask each local layer hands its attention recorded: every one must keep
    exactly the ring rows that hold positions length - wlen + 1 to length
    (``ring_positions``, reckoned apart from the decode's arithmetic), the
    rows a linear cache's window keeps, however the scores fall. Returns
    the number of local layers seen."""
    copy = {k: ATT.KVCache(k=c.k.clone(), v=c.v.clone(), length=c.length.clone())
            for k, c in state.items()}
    sdpa, masks = ATT._sdpa, []

    def recorded(q, k, v, mask, *rest):
        if k.shape[1] == wlen:               # a ring; the global caches are longer
            masks.append(mask.clone())
        return sdpa(q, k, v, mask, *rest)
    ATT._sdpa = recorded
    try:
        tf_mod.gemma3_decode_step(params, copy, {"tokens": token}, cfg, None)
    finally:
        ATT._sdpa = sdpa
    held = ring_positions(length + 1, wlen)
    want = torch.arange(length + 1 - wlen, length + 1, device=DEV)
    for i, m in enumerate(masks):
        check(m.shape == (1, wlen) and torch.equal(held[m[0]].sort().values, want),
              f"local layer {i}'s ring mask keeps positions other than {length + 1 - wlen} "
              f"to {length}")
    del copy
    return len(masks)


def ring_teacher_logits(params, cfg, seq: torch.Tensor, max_len: int) -> torch.Tensor:
    """The logits [B, V] f32 of the last of ``seq``'s tokens, each fed in
    turn through ``gemma3_decode_step`` captured (``CompiledStep``) over
    fresh ring and linear caches of ``max_len``: the ring path, past the
    wrap when ``seq`` is longer than the window."""
    state = init_decode_state(cfg, seq.shape[0], max_len, DEV)
    step = CompiledStep(lambda p, st, b: tf_mod.gemma3_decode_step(p, st, b, cfg, None))
    batch = {"tokens": seq[:, :1].clone()}
    for i in range(seq.shape[1]):
        batch["tokens"].copy_(seq[:, i:i + 1])
        out, _ = step(params, state, batch)
    del step, state
    return out[:, -1].float()


def linear_window_logits(params, cfg, seq: torch.Tensor, wlen: int,
                         reverse: bool = False) -> torch.Tensor:
    """The same logits from the whole of ``seq`` at once, every layer's
    keys laid out linearly (position p at row p, as in a linear cache):
    the local layers in the ring decode's arithmetic (no qk-norm, RoPE at
    each position) with the window as a mask, the global ones through
    ``layer_apply``, causal, as the decode's. ``reverse``: the local
    layers' keys and values summed in reverse order, the same function."""
    loc, glob, n_super, tail = tf_mod._g3_counts(cfg)
    a, (B, S) = cfg.attn, seq.shape
    pos = torch.arange(S, device=DEV)
    mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < wlen)

    def local(p, x):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = (torch.einsum("bsd,dhk->bshk", h, p["attn"][w]) for w in ("wq", "wk", "wv"))
        q, k = (apply_rope(t, pos[None].expand(B, S), a.rope_base, a.rope_fraction)
                for t in (q, k))
        m = mask
        if reverse:
            k, v, m = k.flip(1), v.flip(1), mask.flip(1)
        y = x + torch.einsum("bshk,hkd->bsd",
                             ATT._sdpa(q, k, v, m, a.logit_softcap, a.head_dim ** -0.5),
                             p["attn"]["wo"])
        return y + ffn_apply(p["ffn"], rmsnorm(y, p["ln2"], cfg.norm_eps), cfg.act)
    x = tf_mod._g3_embed(params, seq, cfg)
    for i in range(n_super):
        sp = _index(params["super"], i)
        for j in range(loc + glob):
            pj = _index(sp, j)
            x = local(pj, x) if j < loc else tf_mod.layer_apply(pj, x, cfg, None,
                                                                window=None)[0]
    for i in range(tail):
        x = local(_index(params["tail"], i), x)
    return tf_mod._head(params, x[:, -1:], cfg)[:, -1].float()


def local_score_std(params, cfg, seq: torch.Tensor) -> float:
    """The std of the first local layer's scaled scores q.k (no qk-norm,
    as the ring decode computes them) over the first 256 positions, one
    query head of each group."""
    a, p0 = cfg.attn, _index(_index(params["super"], 0), 0)
    h = rmsnorm(tf_mod._g3_embed(params, seq[:, :256], cfg), p0["ln1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p0["attn"]["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p0["attn"]["wk"])
    q = q[:, :, ::q.shape[2] // k.shape[2]]          # one query head of each group
    return float((torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                  * a.head_dim ** -0.5).std())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def temper_qk(params) -> None:
    """Every layer's wq and wk scaled in place to std 1/sqrt(d_model).
    ``init_params`` takes the reference's fan-in, the heads axis, so they
    are drawn at 1/sqrt(heads) and the ring layers' scores (no qk-norm)
    spread to a std of about 240 at Gemma3-27B's widths; scaled, to about
    1, where a trained model's qk-norm keeps them."""
    for stack in ("super", "tail"):
        at = params[stack]["attn"]
        for w in ("wq", "wk"):
            at[w].mul_((at[w].shape[-2] / at[w].shape[-3]) ** 0.5)


def gemma3_ring_phase(card: str) -> None:
    """Gemma3-27B at full width, one super-block and the tail (8 layers):
    DecodeServer over G3_RING_BATCH rows, a G3_RING_PROMPT-token prompt
    through the captured step (every local ring of 1024 rows wraps) and GEN
    new tokens, captured and eager, tokens bitwise equal. On the captured
    server's state: the first local layer's ring rows against the keys and
    values recomputed from the tokens at the positions the ring arithmetic
    assigns them; one more step, every local layer's mask keeping exactly
    the window's positions (``ring_live_sets``). Then the chained check:
    the served sequence fed token by token through the captured ring step
    (``ring_teacher_logits``) against a linear-cache reference of the same
    arithmetic (``linear_window_logits``), the last token's logits, in f32
    at the drawn weights (printed with the reference against itself in
    reverse key order: with no qk-norm in the ring layers, their scores
    spread so far that the sum's order alone moves the logits), then with
    wq and wk tempered (``temper_qk``) in f32 and in bf16, each within
    G3_RING_TOL of the reference's largest logit."""
    full = get_config(G3_ARCH, "decode_32k")
    cfg = dataclasses.replace(full, num_layers=sum(full.local_global) + 2)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, DEV)
    n = sum(t.numel() for t in leaves(params))
    max_len = G3_RING_PROMPT + GEN + 2
    wlen = min(cfg.local_window, max_len)
    prompts = torch.randint(0, cfg.vocab, (G3_RING_BATCH, G3_RING_PROMPT), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(7))
    print(f"Gemma3-27B ring check: {cfg.num_layers} of {full.num_layers} layers at full width "
          f"(one super-block and the tail of 2; {n / 1e9:.3f} B parameters), "
          f"{G3_RING_BATCH} x ({G3_RING_PROMPT} + {GEN}), caches of {max_len}, rings of {wlen}")
    srvs, toks = {}, {}
    for mode in ("captured", "eager"):
        srv = DecodeServer(cfg, G3_RING_BATCH, max_len, params=params)
        if mode == "eager":
            eager(srv)
        reset_counts()
        m = srv.serve(prompts, GEN)
        check(not any(counts().values()), f"the ring serve ({mode}) launched {counts()}")
        if mode == "captured":
            check(srv._serve_step.graph is not None, "the ring serve captured no graph")
        toks[mode], srvs[mode] = srv.last_tokens, srv
        print(f"Gemma3-27B ring serve, {mode} ({card}): ttft {m.ttft_s:.3f} s "
              f"({G3_RING_PROMPT} prompt steps), itl mean {m.itl_mean_s:.5f} s, p99 "
              f"{m.itl_p99_s:.5f} s")
    check(np.array_equal(toks["captured"], toks["eager"]),
          "the ring serve's captured tokens differ from the eager ones")
    srv = srvs["captured"]
    length = G3_RING_PROMPT + GEN
    check(all(int(c.length) == length for c in srv.state.values()),
          f"ring serve lengths {[int(c.length) for c in srv.state.values()]}, not {length}")
    stream = torch.from_numpy(toks["captured"]).to(DEV)
    seq = torch.cat([prompts.to(DEV), stream], dim=1)            # positions 0 .. length
    loc, glob, n_super, tail = tf_mod._g3_counts(cfg)
    with torch.no_grad():
        rows_err = ring_contents_err(params, cfg, srv.state["local"], seq[:, :length], wlen)
        nlive = ring_live_sets(params, cfg, srv.state, seq[:, length:], length, wlen)
    print(f"Gemma3-27B ring check ({card}): layer 0's ring rows hold positions "
          f"{length - wlen} to {length - 1}, {rows_err:.3g} off the keys and values recomputed "
          f"from the tokens (relative to their largest; limit {G3_RING_TOL}); at the step of "
          f"position {length} (written at ring row {length % wlen}) each of {nlive} local "
          f"layers' masks keeps exactly positions {length + 1 - wlen} to {length}")
    check(rows_err <= G3_RING_TOL, f"the ring's rows are {rows_err} off their positions' keys")
    check(nlive == n_super * loc + tail, f"{nlive} ring masks seen, not one a local layer")
    for srv in srvs.values():
        srv.close()
    del srvs, srv
    gc.collect()
    torch.cuda.empty_cache()
    # the chained check: the served sequence, positions 0 .. length, through
    # the ring step and through the linear reference
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tree_map(lambda t: t.float(), params)
    del params
    errs = {}
    with torch.no_grad():
        for weights in ("drawn", "tempered"):
            if weights == "tempered":
                temper_qk(p32)
            std = local_score_std(p32, cfg32, seq)
            t1 = time.perf_counter()
            want = linear_window_logits(p32, cfg32, seq, wlen)
            ring = ring_teacher_logits(p32, cfg32, seq, max_len)
            errs[weights, "f32"] = rel_err(ring, want)
            line = (f"Gemma3-27B chained ring check, {weights} weights (local scores' std "
                    f"{std:.4g}; {card}): {seq.shape[1]} tokens through the captured ring step "
                    f"against the linear-cache reference, the last token's logits in f32 "
                    f"{errs[weights, 'f32']:.4g} off relative to the reference's largest")
            if weights == "drawn":
                errs["reversed"] = rel_err(linear_window_logits(p32, cfg32, seq, wlen, True),
                                           want)
                line += (f"; the reference against itself with the local keys in reverse "
                         f"order {errs['reversed']:.4g} off")
            else:
                pbf = tree_map(lambda t: t.to(cfg.dtype), p32)
                errs[weights, "bf16"] = rel_err(ring_teacher_logits(pbf, cfg, seq, max_len),
                                                want)
                del pbf
                line += f"; the ring step in bf16 {errs[weights, 'bf16']:.4g} off"
            print(f"{line} (limit {G3_RING_TOL}); {time.perf_counter() - t1:.1f} s")
    for key in (("tempered", "f32"), ("tempered", "bf16")):
        check(errs[key] <= G3_RING_TOL, f"the ring path's logits ({', '.join(key)}) are "
              f"{errs[key]} off the linear-cache reference's")
    print(f"Gemma3-27B ring phase: {time.perf_counter() - t0:.1f} s")
    del p32, want, ring, seq
    gc.collect()
    torch.cuda.empty_cache()


def phi3v_phase(card: str) -> list:
    """Phi-3-vision-4.2B whole (its vlm backbone; the CLIP tower is a stub
    in the reference too): ``dense_config_phase`` (both servers, the
    forward at the preset's 4 x 4096 with img_embeds [4, 576, 3072], B7 at
    head width 96 once a layer, B6 at dk 96, G 1 on the CUDA-core path);
    then B7 at d 96 windowed and non-causal, and at G 2 in the three masks,
    against its plain version, timed beside SDPA. Returns the kernels JSON
    rows."""
    rows = dense_config_phase(VLM_ARCH, card)
    cfg = get_config(VLM_ARCH, "train_4k")
    model, a, Hq = MODEL_NAMES[VLM_ARCH], cfg.attn, cfg.padded_heads()
    W = 1024
    cases = [("window 1024", Hq, dict(window=W)), ("non-causal", Hq, dict(causal=False)),
             ("causal, G 2", Hq // 2, {}), ("window 1024, G 2", Hq // 2, dict(window=W)),
             ("non-causal, G 2", Hq // 2, dict(causal=False))]
    for label, hkv, extra in cases:
        rows.append(flash_row(model, label, cfg.microbatch, Hq, hkv, a.head_dim, 0, **extra))
    return rows


# ---------------------------------------------------------------------------
# training (A11) on one card
# ---------------------------------------------------------------------------

# DBRX-132B's train_4k preset (HT flat, fp8 dispatch, capacities 1.25, remat)
# with 1 of its 40 layers, 2 micro-batches of 8 x 2048 tokens (S >= 2048 keeps
# flash attention on the path) over 8 EP ranks hosted on the card, bf16 AdamW
# moments: f32 moments do not fit beside the f32 gradient sums
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 1, 16, 2048, 2, 4
TRAIN_LR = 3e-4
# the backward kernels on the training path, as the kernels line names them
TRAIN_KERNELS = {
    "grouped_gemm_dw": ("src/repro_torch/csrc/grouped_gemm_dw.cu",
                        "src/repro/kernels/grouped_gemm.py:53"),
    "combine_gather_reduce_bwd": ("src/repro_torch/csrc/combine_gather_reduce_bwd.cu",
                                  "src/repro/kernels/combine_gather_reduce.py:44"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:86"),
}
# flash attention's backward pair in bf16 against its plain version: relative
# error over each gradient. Both sum in f32 from the same bf16 inputs, output
# and LSE, in another order, and round once to bf16; the forward's limit,
# doubled for the longer sums of dK and dV over the G query heads and every
# query row
FLASH_BWD_REL = 1e-2
# one MoE layer's gradients at full width through the kernels against the
# same layer through the plain versions: relative error over each gradient.
# Both round every product to bf16 where the layer does; a last-bit
# difference of an f32 sum flips a rounding now and then and carries on
MOE_GRAD_REL = 2e-2
# the plain versions the training path must not reach on the card
PLAIN_FNS = ("dispatch_pack", "recv_unpack", "grouped_gemm", "grouped_gemm_dw",
             "combine_gather_reduce", "combine_gather_reduce_bwd", "flash_attention",
             "flash_attention_fwd", "flash_attention_bwd", "quantize_fp8",
             "dequantize_fp8", "combine_reduce")


def tracked(tree):
    """A nested dict of detached copies (the same storage) of ``tree``'s
    tensors, the floating ones requiring grad: gradients without marking
    the caller's tensors."""
    if isinstance(tree, dict):
        return {k: tracked(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(tree.is_floating_point())


def leaf_names(tree, prefix: str = "") -> list:
    """The path of each tensor of a nested dict, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def train_config():
    full = full_config("train_4k")
    return full, dataclasses.replace(full, num_layers=TRAIN_LAYERS, microbatch=TRAIN_MICRO)


def train_launches(cfg, ranks: int = RANKS, path: str = "nccl_ep",
                   chunks: int = HIER_CHUNKS) -> dict:
    """Kernel launches of one train step of ``cfg`` (its MoE layers on
    ``path``, HT flat's being ``nccl_ep``'s): with remat each micro-batch
    runs a stack layer's forward twice (once more in the backward), the
    MTP layer's once, and the backward once. A MoE layer's forward: the EP
    launches of ``ep_launches`` per rank (B1 in quant mode under fp8); its
    backward per rank: the EP transposes (``ep_transpose_launches``), B3 as
    dX and ``grouped_gemm_dw`` for each of the three projections. A GQA
    layer: flash attention once a forward, and its pair, two launches (its
    dQ and its dK/dV kernel), a backward; an MLA layer (and a dense FFN, a
    shared expert, the router) launches no kernel."""
    g = cfg.microbatch
    stack_fwd = (2 if cfg.remat else 1) * g

    def fwd(stack_layers: int) -> int:        # forwards a step, the MTP layer's among them
        return stack_layers * stack_fwd + int(cfg.mtp) * g
    moe_fwd, moe_bwd = fwd(moe_layers(cfg)), forward_moe_layers(cfg) * g
    out = {k: v * moe_fwd * ranks for k, v in ep_launches(cfg, path, chunks).items()}
    gqa = cfg.attn.kind != "mla"
    out[FLASH] = fwd(cfg.num_layers) if gqa else 0
    out["grouped_gemm"] += 3 * moe_bwd * ranks
    out["grouped_gemm_dw"] = 3 * moe_bwd * ranks
    for part in ep_transpose_launches(path, chunks):
        for k, v in part.items():
            out[k] = out.get(k, 0) + v * moe_bwd * ranks
    out["flash_attention_bwd"] = 2 * (cfg.num_layers + int(cfg.mtp)) * g if gqa else 0
    return out


def mla_train_calls(cfg, rows: int) -> tuple[int, int]:
    """``MlaChunked``'s calls in one train step of an MLA config whose
    micro-batches give a process ``rows`` rows of at least
    CHUNKED_ATTN_THRESHOLD tokens: (forwards, backwards), one a row and a
    layer each, with remat a stack layer's forward twice."""
    if cfg.attn.kind != "mla":
        return 0, 0
    g = cfg.microbatch * rows
    return (cfg.num_layers * (2 if cfg.remat else 1) + int(cfg.mtp)) * g, \
        (cfg.num_layers + int(cfg.mtp)) * g


@contextlib.contextmanager
def plain_calls(sink: Counter):
    """While open, every call of a plain version in ``kernels/ref.py`` that
    the kernel entries route to is counted in ``sink``."""
    orig = {n: getattr(ref, n) for n in PLAIN_FNS}

    def counted(name, fn):
        def run(*a, **kw):
            sink[name] += 1
            return fn(*a, **kw)
        return run
    for n, fn in orig.items():
        setattr(ref, n, counted(n, fn))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(ref, n, fn)


@contextlib.contextmanager
def plain_route():
    """While open, every kernel entry of ``kernels/ops.py`` takes its plain
    version, on the card too: the reference side of the layer checks."""
    orig = ops_mod._plain
    ops_mod._plain = lambda t: True
    try:
        yield
    finally:
        ops_mod._plain = orig


def ksum_plain(recv: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """combine_gather_reduce's sum written out in k order, one f32 add per
    k (the kernel's FMA order): with unit weights the same bits."""
    pad = torch.zeros((1, recv.shape[1]), dtype=recv.dtype, device=recv.device)
    y = torch.cat([recv, pad])[rows.long()].float()
    acc = torch.zeros(y[:, 0].shape, device=recv.device)
    for k in range(rows.shape[1]):
        acc = acc + y[:, k] * w[:, k:k + 1]
    return acc.to(recv.dtype)


def autograd_ms(fn, inputs, cot, iters: int) -> float:
    """Device time of autograd's backward of ``fn`` (a plain version): the
    graph of one call ``fn(*inputs)`` on detached copies that require grad,
    walked with the cotangent ``cot`` ``iters`` times."""
    ins = [t.detach().requires_grad_() for t in inputs]
    out = fn(*ins)
    ms = device_ms(lambda: torch.autograd.grad(out, ins, cot, retain_graph=True), iters)
    del out, ins
    return ms


def dw_case(label: str, x_: torch.Tensor, dy: torch.Tensor, counts_: torch.Tensor,
            w_: torch.Tensor | None = None) -> dict:
    """grouped_gemm_dw at one projection's shapes against its plain version
    (TOL per element, GEMM_REL relative, two calls bitwise, NaNs in the
    rows past the counts changing no bit), timed beside the plain version,
    autograd's backward of the plain grouped GEMM over the weights ``w_``
    (dX and dW together; skipped without ``w_``), ``torch.bmm`` and its
    bound; returns its record."""
    dev, L, H_, fo = x_.device, x_.shape[0], x_.shape[2], dy.shape[2]
    rows = int(counts_.clamp(max=x_.shape[1]).sum())
    got = gg_mod.grouped_gemm_dw(x_, dy, counts_)
    want = ref.grouped_gemm_dw(x_, dy, counts_)
    err, rel = flash_errors(got, want)
    check(torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL) and rel <= GEMM_REL,
          f"grouped_gemm_dw ({label}) off its plain version: {err}, relative {rel}")
    check(torch.equal(got, gg_mod.grouped_gemm_dw(x_, dy, counts_)),
          f"grouped_gemm_dw ({label}): two calls differ")
    # the rows past the counts may hold anything: NaNs there in both
    # operands change no bit (the kernel zeroes them in its last stage)
    dead = (torch.arange(x_.shape[1], device=dev)[None, :] >= counts_[:, None])[..., None]
    nan_equal = torch.equal(got, gg_mod.grouped_gemm_dw(
        x_.masked_fill(dead, float("nan")), dy.masked_fill(dead, float("nan")), counts_))
    check(nan_equal, f"grouped_gemm_dw ({label}): NaN rows past the counts change the result")
    del got, want, dead
    bnd = bound(nbytes(x_[0], rows) + nbytes(dy[0], rows) + L * H_ * fo * 2 + nbytes(counts_),
                2 * rows * H_ * fo, BF16_OPS_S)
    ms = device_ms(lambda: gg_mod.grouped_gemm_dw(x_, dy, counts_), 3)
    plain_ms = device_ms(lambda: ref.grouped_gemm_dw(x_, dy, counts_), 2)
    ag = ""
    if w_ is not None:
        ag_ms = autograd_ms(lambda a, b: ref.grouped_gemm(a, b, counts_), (x_, w_), dy, 2)
        ag = f"autograd of the plain grouped_gemm {ag_ms:.4f} ms (dX and dW together), "
    xt = x_.transpose(1, 2)
    lib_ms = device_ms(lambda: torch.bmm(xt, dy), 3)
    counts_line = (counts_.tolist() if L <= 16 else
                   f"{L} experts of {int(counts_.min())} to {int(counts_.max())}")
    print(f"grouped_gemm_dw {label} (dW): x {list(x_.shape)}, dy {list(dy.shape)}, counts "
          f"{counts_line} ({rows} live rows): max_abs_err {err:.3g}, relative "
          f"{rel:.3g} (limits {TOL} per element, {GEMM_REL} relative), two calls bitwise "
          f"equal, NaN rows past the counts change no bit; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {ag}library {lib_ms:.4f} ms "
          f"(torch.bmm over every row), bound {bnd[0]:.4f} ms ({bnd[1]}); "
          f"{2 * rows * H_ * fo / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {ms / bnd[0]:.2f}x the "
          f"bound, {ms / lib_ms:.2f}x torch.bmm")
    return record("grouped_gemm_dw", err, ms, plain_ms, bnd, lib_ms)


def dx_case(label: str, dy: torch.Tensor, w: torch.Tensor, counts_: torch.Tensor) -> tuple:
    """B3 as dX: dY through a contiguous [L, F, H] copy of the weights ``w``
    [L, H, F] made in the backward, the copy timed beside its byte bound,
    then ``gemm_case``; returns gemm_case's tuple and the copy's ms."""
    wt = w.transpose(1, 2).contiguous()
    copy_ms = device_ms(lambda: w.transpose(1, 2).contiguous(), 3)
    print(f"B3 as dX: the [L, F, H] copy of the weights {list(wt.shape)} "
          f"{copy_ms:.4f} ms, bound "
          f"{bound(2 * nbytes(wt), 0, BF16_OPS_S)[0]:.4f} ms (bytes)")
    out = gemm_case(label, dy, wt, counts_, 3, 2)
    del wt
    return out, copy_ms


def train_kernel_phase(cfg, p) -> dict:
    """The backward kernels at the slice's shapes, on rank 0 of MoE layer 0
    (``p``) over 8 ranks at 2048 tokens a rank, each against its plain
    version and timed beside it, its bound and a library call; then the EP
    transposes bitwise against plain gathers and k-order sums."""
    dev, dt, d = DEV, cfg.dtype, cfg.d_model
    comm = LocalComm(RANKS)
    T = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ // RANKS
    group = ep_group(cfg, comm, T)
    L, F_ = group.local_experts, cfg.moe.d_ff_expert
    gen = torch.Generator(device=dev).manual_seed(31)
    xs = [torch.randn((T, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    rs = [route(x.float() @ p["router"], router_config(cfg.moe)) for x in xs]
    hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
    recv = ep_complete(group, hs, ep_dispatch(group, hs, xs, send_only=True))
    y3d, counts_ = recv[0]
    records = {}
    # grouped_gemm_dw at the gate (and the down) projection's shapes
    for label, x_, fo in (("gate", y3d, F_), ("down", None, d)):
        if x_ is None:
            x_ = torch.randn((L, y3d.shape[1], F_), generator=gen, device=dev).to(dt)
        dy = (torch.randn((L, y3d.shape[1], fo), generator=gen, device=dev) * 0.1).to(dt)
        rec = dw_case(label, x_, dy, counts_, p["w_gate" if label == "gate" else "w_down"][:L])
        if label == "gate":
            records["grouped_gemm_dw"] = rec
            # B3 as dX: the gradient of the gate output through Wᵀ, a
            # contiguous [L, F, H] copy of the weights made in the backward
            dx_case("HT gate dX (B3 on dY, Wᵀ)", dy, p["w_gate"][:L], counts_)
        del dy, x_
    # combine_gather_reduce_bwd at the combine's recv
    pl, w0 = hs[0].plan, hs[0].topk_weights
    crecv = torch.randn((RANKS * group.ht_pair_cap, d), generator=gen, device=dev).to(dt)
    dout = torch.randn((T, d), generator=gen, device=dev).to(dt)
    crows = pl.comb_recv_rows
    d_recv, d_w = cg_mod.combine_gather_reduce_bwd(crecv, crows, w0, dout)
    w_recv, w_w = ref.combine_gather_reduce_bwd(crecv, crows, w0, dout)
    check(torch.equal(d_recv, w_recv), "combine_gather_reduce_bwd: d_recv differs from its "
          "plain version")
    err, rel = flash_errors(d_w, w_w)
    check(rel <= 1e-5, f"combine_gather_reduce_bwd: d_w off its plain version by {rel}")
    valid = int((crows < crecv.shape[0]).sum())
    bnd = bound(nbytes(crecv, valid) + nbytes(dout) + nbytes(crows) + nbytes(w0)
                + nbytes(d_recv) + nbytes(d_w), 3 * valid * d, F32_OPS_S)
    ms = device_ms(lambda: cg_mod.combine_gather_reduce_bwd(crecv, crows, w0, dout), 20)
    plain_ms = device_ms(lambda: ref.combine_gather_reduce_bwd(crecv, crows, w0, dout), 5)
    ag_ms = autograd_ms(lambda a, b: ref.combine_gather_reduce(a, crows, b), (crecv, w0), dout, 5)
    print(f"combine_gather_reduce_bwd: recv {list(crecv.shape)}, rows {list(crows.shape)} "
          f"({valid} valid), dout {list(dout.shape)}: d_recv bitwise equal, d_w relative "
          f"{rel:.3g} (limit 1e-5, f32 sums in another order); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, autograd of the plain combine_gather_reduce {ag_ms:.4f} ms, "
          f"library none (no one call), bound {bnd[0]:.4f} ms ({bnd[1]})")
    records["combine_gather_reduce_bwd"] = record("combine_gather_reduce_bwd", err, ms,
                                                  plain_ms, bnd, None)
    del d_recv, d_w, w_recv, w_w, crecv, dout
    # the EP transposes on the card against plain gathers and k-order sums
    d_y3ds = [torch.randn(y.shape, generator=gen, device=dev).to(dt) for y, _ in recv]
    d_x = LL.dispatch_transpose(group, hs, d_y3ds)
    sends = [ref.dispatch_pack(slots.flat_rows(d), h.plan.comb_send_gmap)[0]
             for d, h in zip(d_y3ds, hs)]
    backs = comm.all_to_all(sends)
    for r, (got, b, h) in enumerate(zip(d_x, backs, hs)):
        rr = h.plan.comb_recv_rows
        check(torch.equal(got, ksum_plain(slots.flat_rows(b), rr, torch.ones(rr.shape, device=dev))),
              f"the dispatch's backward (d_x) of rank {r} differs from the plain gather and sum")
    couts = [torch.randn((T, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    crecvs = [torch.randn((RANKS, group.ht_pair_cap, d), generator=gen, device=dev).to(dt)
              for _ in range(RANKS)]
    d_y3d_k, d_w_k = LL.combine_transpose(group, hs, crecvs, couts)
    with plain_route():
        d_y3d_p, d_w_p = LL.combine_transpose(group, hs, crecvs, couts)
    check(all(torch.equal(a, b) for a, b in zip(d_y3d_k, d_y3d_p)),
          "the combine's backward (d_y3d) differs from the plain scatter and gather")
    dw_rel = max(flash_errors(a, b)[1] for a, b in zip(d_w_k, d_w_p))
    check(dw_rel <= 1e-5, f"the combine's backward (d_w) off the plain version by {dw_rel}")
    print(f"EP transposes over {RANKS} ranks at {T} tokens a rank: the dispatch's backward "
          f"(B1 copy pack through comb_send_gmap, the exchange, B4 with unit weights) "
          f"bitwise equal to the plain gather and k-order sum on every rank; the combine's "
          f"(combine_gather_reduce_bwd, the exchange, B2 through the inverse of "
          f"comb_send_gmap) d_y3d bitwise equal to the plain version's, d_w within "
          f"{dw_rel:.3g} relative")
    del d_y3ds, d_x, sends, backs, couts, crecvs, d_y3d_k, d_w_k, d_y3d_p, d_w_p, recv, y3d
    return records


def train_flash_phase(cfg) -> dict:
    """Flash attention's LSE and backward pair at the slice's shapes ([8,
    2048, 48, 128] queries, 8 kv heads), against their plain versions,
    timed beside the plain backward, SDPA's backward and the bound; the
    forward re-timed with its LSE output."""
    a = cfg.attn
    B, S, Hq, Hkv, dh = TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, cfg.padded_heads(), a.n_kv, a.head_dim
    gen = torch.Generator(device=DEV).manual_seed(33)
    q, k, v, do = (torch.randn((B, S, h, dh), generator=gen, device=DEV).to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv, Hq))
    kw = dict(scale=dh ** -0.5)
    out, lse = fa_mod.flash_attention_bshd(q, k, v, with_lse=True, **kw)
    t = [x.transpose(1, 2) for x in (q, k, v)]
    _, want_lse = ref.flash_attention_fwd(*t, **kw)
    lse_err = max_err(lse, want_lse)
    check(lse_err <= 1e-3, f"flash attention's LSE off its plain version by {lse_err}")
    got = fa_mod.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    want = ref.flash_attention_bwd(*t, out.transpose(1, 2), do.transpose(1, 2), lse, **kw)
    errs = [flash_errors(g_, w_.transpose(1, 2)) for g_, w_ in zip(got, want)]
    del want
    check(all(r <= FLASH_BWD_REL for _, r in errs),
          f"flash attention's backward off its plain version: {errs}")
    again = fa_mod.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    check(all(torch.equal(x, y) for x, y in zip(again, got)),
          "flash attention's backward: two calls differ")
    del again, got
    fwd_ms = device_ms(lambda: fa_mod.flash_attention_bshd(q, k, v, **kw), 5)
    fwd_lse_ms = device_ms(lambda: fa_mod.flash_attention_bshd(q, k, v, with_lse=True, **kw), 5)
    ms = device_ms(lambda: fa_mod.flash_attention_bwd(q, k, v, out, do, lse, **kw), 2)
    plain_ms = device_ms(lambda: ref.flash_attention_bwd(
        *t, out.transpose(1, 2), do.transpose(1, 2), lse, **kw), 1)
    ag_ms = autograd_ms(lambda a, b, c: ref.flash_attention(a, b, c, **kw), t,
                        do.transpose(1, 2), 1)
    gc.collect()
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True, **kw)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = device_ms(lambda: torch.autograd.grad(lo, (qt, kt, vt), dot, retain_graph=True), 3)
    del lo, qt, kt, vt
    pairs = B * Hq * S * (S + 1) // 2
    ops = 10 * dh * pairs          # five products of 2 d operations per live pair
    nb = (nbytes(q) * 3 + nbytes(k) * 4 + nbytes(lse) + nbytes(out) + nbytes(do))
    bnd = bound(nb, ops, BF16_OPS_S)
    print(f"flash attention backward at [{B}, {S}, {Hq}/{Hkv}, {dh}] bf16: LSE within "
          f"{lse_err:.3g} of the plain forward's; dq, dk, dv relative "
          f"{[round(r, 6) for _, r in errs]} (limit {FLASH_BWD_REL}), two calls bitwise "
          f"equal; the pair {ms:.4f} ms, plain {plain_ms:.4f} ms (the plain backward), "
          f"autograd of the plain flash_attention {ag_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms (scaled_dot_product_attention's backward), bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}: {ops / 1e12:.3f} TFLOP); "
          f"{ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {ms / lib_ms:.2f}x the library; the "
          f"forward {fwd_ms:.4f} ms, with its LSE {fwd_lse_ms:.4f} ms")
    return {"flash_attention_bwd": record("flash_attention_bwd", max(e for e, _ in errs),
                                          ms, plain_ms, bnd, lib_ms)}


def moe_grad_phase(cfg, p) -> None:
    """MoE layer 0 at full width over 8 ranks, 8 x 2048 tokens (one
    micro-batch): the gradients of the tokens, the router and the three
    expert weights through the kernels against the same layer with every
    kernel entry on its plain version, within MOE_GRAD_REL."""
    gen = torch.Generator(device=DEV).manual_seed(35)
    p = tracked(p)
    shape = (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, cfg.d_model)
    x0 = torch.randn(shape, generator=gen, device=DEV).to(cfg.dtype)
    gy = torch.randn(shape, generator=gen, device=DEV).to(cfg.dtype)
    names = ("router", "w_gate", "w_up", "w_down")

    def grads():
        x = x0.clone().requires_grad_()
        y, aux = moe_block(p, x, cfg, LocalComm(RANKS))
        out = torch.autograd.grad((y.float() * gy.float()).sum() + aux,
                                  [x] + [p[n] for n in names])
        torch.cuda.synchronize()
        return out
    t0 = time.perf_counter()
    got = grads()
    k_s = time.perf_counter() - t0
    with plain_route():
        want = grads()
    rels = {n: flash_errors(g_, w_)[1] for n, g_, w_ in zip(("x",) + names, got, want)}
    check(all(bool(torch.isfinite(g_).all()) and bool(g_.abs().amax() > 0) for g_ in got),
          "an MoE gradient is not finite or all zero")
    check(all(r <= MOE_GRAD_REL for r in rels.values()),
          f"the MoE layer's gradients off the plain layer's: {rels}")
    print(f"MoE layer 0 at full width, {shape[0]} x {shape[1]} tokens over {RANKS} ranks: "
          f"gradients through the kernels against the plain versions, relative "
          f"{ {n: round(r, 6) for n, r in rels.items()} } (limit {MOE_GRAD_REL}); forward and "
          f"backward through the kernels {k_s:.3f} s")


# the EP transposes at DBRX train_4k widths (train_layout_phase): tokens a
# rank, the relative limit against the analytic gradient and against HT
# flat's on the same routing (bf16 rows and cotangents, f32 sums in other
# orders), and the layouts: name -> (group options, launch path, chunks,
# the HT flat reference of the same dispatch precision)
TL_T, TL_REL = 2048, 2e-2
_TL_HIER = dict(mode="ht", ep_axis=tuple(a for a, _ in HIER_AXES), ht_hierarchical=True)
TL_LAYOUTS = {
    "HT flat": (dict(mode="ht"), "nccl_ep", 1, None),
    "HT flat, fp8": (dict(mode="ht", quantize_dispatch=True), "nccl_ep", 1, None),
    "deepep": (dict(mode="ll", ll_layout="deepep"), "deepep", 1, "HT flat"),
    "deepep, fp8": (dict(mode="ll", ll_layout="deepep", quantize_dispatch=True), "deepep_fp8",
                    1, "HT flat, fp8"),
    "baseline": (dict(mode="baseline"), "baseline", 1, "HT flat"),
    "hierarchical, 1 chunk": (dict(_TL_HIER, ht_num_chunks=1), "hier", 1, "HT flat"),
    "hierarchical, 2 chunks": (dict(_TL_HIER, ht_num_chunks=2), "hier", 2, "HT flat"),
    "hierarchical, 1 chunk, fp8": (dict(_TL_HIER, ht_num_chunks=1, quantize_dispatch=True),
                                   "hier", 1, "HT flat, fp8"),
    "hierarchical, 2 chunks, fp8": (dict(_TL_HIER, ht_num_chunks=2, quantize_dispatch=True),
                                    "hier", 2, "HT flat, fp8"),
}


def check_launches(got: dict, want: dict, where: str) -> None:
    """Every counter of ``got`` and ``want`` equal (a missing one is 0)."""
    bad = {k: (got.get(k, 0), want.get(k, 0)) for k in set(want) | set(got)
           if got.get(k, 0) != want.get(k, 0)}
    check(not bad, f"{where}: launches (got, expected) {bad}")


@contextlib.contextmanager
def pass_bytes(comm, sink: list):
    """While open, each data pass of an EP transpose adds to ``sink[0]`` the
    bytes it must move, its inputs read once (a gather's source row once,
    however many slots name it) and its outputs written once: B1, B2, B4 and
    ``combine_gather_reduce_bwd`` through the kernels' entries, each block
    of ``comm``'s exchange read and written, the positional layouts' swap
    read and written. The sum over a transpose's passes, over the memory
    rate, is its byte bound."""
    from repro_torch.core import slots as slots_mod
    orig = {n: getattr(ops_mod, n) for n in ("dispatch_pack", "recv_unpack",
                                             "combine_gather_reduce",
                                             "combine_gather_reduce_bwd")}
    swap, a2a = slots_mod.swap_blocks, comm.all_to_all

    def outs(r) -> int:
        return sum(nbytes(t) for t in (r if isinstance(r, tuple) else (r,)) if t is not None)

    def gather(name):            # (source, map, ...): the named rows, the map, the rest
        def run(src, idx, *a, **kw):
            r = orig[name](src, idx, *a, **kw)
            rest = [t for t in list(a) + list(kw.values()) if isinstance(t, torch.Tensor)]
            if name == "recv_unpack" and rest:          # the scales: the named rows only
                rest = [nbytes(rest[0], read_rows(idx, src.shape[0]))]
            else:
                rest = [nbytes(t) for t in rest]
            sink[0] += (nbytes(src, read_rows(idx, src.shape[0])) + nbytes(idx) + sum(rest)
                        + outs(r))
            return r
        return run

    def swapped(x, a, b):
        sink[0] += 2 * nbytes(x)
        return swap(x, a, b)

    def exchanged(xs, axis=None):
        sink[0] += 2 * sum(nbytes(x) for x in xs)
        return a2a(xs, axis)
    for n in orig:
        setattr(ops_mod, n, gather(n))
    slots_mod.swap_blocks, comm.all_to_all = swapped, exchanged
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(ops_mod, n, fn)
        slots_mod.swap_blocks = swap
        del comm.all_to_all


def train_layout_phase(card: str) -> None:
    """The EP round trip's backward in every layout at DBRX train_4k widths
    (H 6144, 16 experts top-4, LocalComm(8), TL_T tokens a rank, bf16
    payload, zero-drop capacities): dispatch, expert e scaling its rows by
    1 + e, combine, under autograd on a seeded cotangent. d_x and d_w held
    within TL_REL against the analytic gradient in f32 (d_x[t] = Σ_k
    w·(1+e_k)·c[t], d_w[t, k] = (1+e_k)·x[t]·c[t], x the dequantized tokens
    under fp8) and against HT flat's of the same precision on the same
    routing; the hierarchical path's at 2 chunks bitwise equal to 1's. Each
    transpose's launches per rank exact (``ep_transpose_launches``) and its
    device time printed beside its byte bound (``pass_bytes``) and the
    same transpose on the plain versions (``plain_route``)."""
    t_start = time.perf_counter()
    full = full_config("train_4k")
    d, m, dt = full.d_model, full.moe, full.dtype
    E, Kk, T = m.num_experts, m.top_k, TL_T
    gen = torch.Generator(device=DEV).manual_seed(37)
    xs0 = [torch.randn((T, d), generator=gen, device=DEV).to(dt) for _ in range(RANKS)]
    topk = [torch.rand((T, E), generator=gen, device=DEV).argsort(-1)[:, :Kk].to(torch.int32)
            for _ in range(RANKS)]
    ws0 = [torch.softmax(torch.randn((T, Kk), generator=gen, device=DEV), -1)
           for _ in range(RANKS)]
    cots = [torch.randn((T, d), generator=gen, device=DEV).to(dt) for _ in range(RANKS)]
    x_q = [ref.dequantize_fp8(*ref.quantize_fp8(x, 128), torch.float32) for x in xs0]
    res = {}
    print(f"EP transposes at DBRX-132B train_4k widths ({card}): H {d}, {E} experts top-{Kk}, "
          f"{RANKS} ranks of {T} tokens, bf16 payload, zero-drop capacities; the round trip "
          f"scales expert e's rows by 1 + e")
    for name, (opts, path, nc, flat) in TL_LAYOUTS.items():
        hier = opts.get("ht_hierarchical", False)
        comm = hier_comm() if hier else LocalComm(RANKS)
        group = ep_create_group(EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=d,
                                              top_k=Kk, payload_dtype=dt, **opts), comm)
        check(group.hierarchical == hier, f"{name}: the group resolved another path")
        L = group.local_experts
        xs = [x.clone().requires_grad_() for x in xs0]
        ws = [w.clone().requires_grad_() for w in ws0]
        hs = ep_create_handle(group, topk, ws)
        recv = LL.ep_dispatch_autograd(group, hs, xs)
        ys = [y * (1.0 + torch.arange(r * L, (r + 1) * L, device=DEV)).to(y.dtype)[:, None, None]
              for r, (y, _) in zip(comm.ranks, recv)]
        torch.autograd.backward(LL.ep_combine_autograd(group, hs, ys), cots)
        d_x = torch.stack([x.grad for x in xs]).float()
        d_w = torch.stack([w.grad for w in ws]).float()
        scale = 1.0 + torch.stack(topk).float()
        wx = (torch.stack(ws0) * scale).sum(-1, keepdim=True) * torch.stack(cots).float()
        xe = torch.stack(x_q if opts.get("quantize_dispatch") else xs0).float()
        ww = scale * (xe * torch.stack(cots).float()).sum(-1, keepdim=True)
        errs = {"d_x": flash_errors(d_x, wx)[1], "d_w": flash_errors(d_w, ww)[1]}
        if flat is not None:
            errs["d_x vs flat"] = flash_errors(d_x, res[flat]["d_x"])[1]
            errs["d_w vs flat"] = flash_errors(d_w, res[flat]["d_w"])[1]
        check(all(e <= TL_REL for e in errs.values()),
              f"the {name} round trip's gradients off (limit {TL_REL}): {errs}")
        del recv, ys, xs, ws
        # each transpose alone: its launches and its card time
        want_d, want_c = ep_transpose_launches(path, nc)
        g2 = torch.Generator(device=DEV).manual_seed(38)
        fwd = ep_complete(group, hs, ep_dispatch(group, hs, xs0, send_only=True))
        d_y3ds = [torch.randn(y.shape, generator=g2, device=DEV).to(y.dtype) for y, _ in fwd]
        y3ds = [y for y, _ in fwd]
        # what EpCombine keeps for its backward: the expert rows the
        # hierarchical slot-domain sum reads, else the rows each rank received
        saved = ([HT.combine_rows(group, y) for y in y3ds] if hier else
                 [p_.recv for p_ in ep_combine(group, hs, y3ds, send_only=True)])
        moved = [0], [0]          # bytes of the dispatch's and the combine's passes
        reset_counts()
        with pass_bytes(comm, moved[0]):
            LL.dispatch_transpose(group, hs, d_y3ds)
        torch.cuda.synchronize()
        check_launches(counts(), {k: v * RANKS for k, v in want_d.items()},
                       f"{name}: the dispatch's backward")
        reset_counts()
        with pass_bytes(comm, moved[1]):
            LL.combine_transpose(group, hs, saved, cots)
        torch.cuda.synchronize()
        check_launches(counts(), {k: v * RANKS for k, v in want_c.items()},
                       f"{name}: the combine's backward")
        disp_ms = device_ms(lambda: LL.dispatch_transpose(group, hs, d_y3ds), 3)
        comb_ms = device_ms(lambda: LL.combine_transpose(group, hs, saved, cots), 3)
        with plain_route():       # the same passes on the plain versions
            plain = [device_ms(lambda: LL.dispatch_transpose(group, hs, d_y3ds), 2),
                     device_ms(lambda: LL.combine_transpose(group, hs, saved, cots), 2)]
        bnd = [bound(b[0], 0, 1.0)[0] for b in moved]
        res[name] = dict(d_x=d_x, d_w=d_w)
        print(f"  {name}: d_x {errs['d_x']:.3g}, d_w {errs['d_w']:.3g} off the analytic "
              f"gradient" + (f", {errs['d_x vs flat']:.3g} / {errs['d_w vs flat']:.3g} off "
                             f"{flat}'s" if flat else "")
              + f" (limit {TL_REL}); the dispatch's backward {disp_ms:.4f} ms ({RANKS} ranks, "
              f"launches a rank {want_d}; its passes move {moved[0][0] / 1e9:.4f} GB, bound "
              f"{bnd[0]:.4f} ms; on the plain versions {plain[0]:.4f} ms), the combine's "
              f"{comb_ms:.4f} ms (launches a rank {want_c}; {moved[1][0] / 1e9:.4f} GB, bound "
              f"{bnd[1]:.4f} ms; plain {plain[1]:.4f} ms)")
        del fwd, d_y3ds, y3ds, saved, hs, group
        gc.collect()
        torch.cuda.empty_cache()
    for fp8 in ("", ", fp8"):
        one, two = res[f"hierarchical, 1 chunk{fp8}"], res[f"hierarchical, 2 chunks{fp8}"]
        check(torch.equal(one["d_x"], two["d_x"]) and torch.equal(one["d_w"], two["d_w"]),
              f"the hierarchical gradients{fp8} at 2 chunks differ from 1 chunk's")
    print(f"  hierarchical: 2 chunks' d_x and d_w bitwise equal to 1 chunk's, bf16 and fp8; "
          f"train_layout_phase {time.perf_counter() - t_start:.1f} s")


def train_trace(cfg, params, batch, comm=None, traced: bool = True) -> dict:
    """One micro-batch's forward and backward (micro-batch 0, the trained
    parameters) over ``comm`` (``LocalComm(RANKS)`` by default) traced
    with the profiler: the card's busy share of the wall time, NCCL's
    share of the busy time and the kernels that took most of it, and a
    line saying so. Over a ``DistComm`` every process runs it (its
    collectives need all of them) and the one with ``traced`` traces it;
    the others get an empty dict."""
    comm = LocalComm(RANKS) if comm is None else comm
    fwd = get_model(cfg).forward
    micro = {k: v[0] for k, v in batch.items()}
    params = tracked(params)
    inputs = [t for t in leaves(params) if t.is_floating_point()]

    def run():
        loss, _ = fwd(params, micro, cfg, comm)
        # a selection bias picks experts and weighs none: no gradient
        torch.autograd.grad(loss, inputs, allow_unused=True)
        torch.cuda.synchronize()
    run()
    if not traced:
        run()
        return {}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    wall_us = (time.perf_counter() - t0) * 1e6
    iv = [e for e in device_intervals(prof) if "spin_kernel" not in e[2]]
    check(bool(iv), "the traced micro-batch recorded no device event")
    busy = busy_us(iv)
    by: Counter = Counter()
    for s_, e_, name in iv:
        by[short_name(name)] += e_ - s_
    nccl = busy_us([e for e in iv if "nccl" in e[2].lower()])
    top = ", ".join(f"{n} {us / 1e3:.1f} ms ({us / busy:.3f})" for n, us in by.most_common(8))
    line = (f"one traced micro-batch (forward + backward) over {type(comm).__name__}"
            f"({comm.size}): wall {wall_us / 1e6:.3f} s, card busy {busy / 1e6:.3f} s "
            f"({busy / wall_us:.3f} of the wall; idle {1 - busy / wall_us:.3f}), NCCL "
            f"{nccl / 1e6:.3f} s ({nccl / busy:.3f} of the busy time), {len(iv)} device "
            f"events; by kernel: {top}")
    return dict(wall_s=wall_us / 1e6, busy=busy / wall_us, nccl=nccl / busy, line=line)


def run_trainer(tr: Trainer, params, opt, batch) -> dict:
    """``tr``'s own loop from (params, opt) over the repeated global
    ``batch``: each step timed with the card synchronised and its launches
    counted; the optimizer, and over a ``DistComm`` the gradient reduce,
    timed on their own (``runtime/steps.py``'s, looked up by name);
    step 1's gradients finite and not all zero (a selection bias's all
    zero: no loss term reaches it); no plain version reached.
    Returns the trained params and state, the losses and gradient norms,
    the step, optimizer and reduce seconds, the reduce's bytes, each
    step's launches and ``MlaChunked`` calls (``mla_calls``) and the peak
    device memory allocated and reserved (GiB)."""
    tr.init_state = lambda: (params, opt)
    tr.data.batch_at = lambda step: batch
    opt_s, reduce_s, reduce_bytes, step_info = [], [], [], []
    update, reduce = steps_mod.adamw_update, steps_mod.reduce_grads

    def timed_update(prm, grads, state, oc, **kw):
        torch.cuda.synchronize()
        if not opt_s:              # step 1: every gradient finite and not all zero
            # but a selection bias's, which no loss term reaches: all zero
            bad = [n for n, g_ in zip(leaf_names(grads), leaves(grads))
                   if not bool(torch.isfinite(g_).all())
                   or bool(g_.abs().amax() > 0) == n.endswith("sel_bias")]
            check(not bad, f"step 1: gradients not finite, all zero, or (a selection "
                  f"bias's) not zero: {bad}")
        t0 = time.perf_counter()
        out = update(prm, grads, state, oc, **kw)
        torch.cuda.synchronize()
        opt_s.append(time.perf_counter() - t0)
        return out

    def timed_reduce(sums, cfg, comm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = reduce(sums, cfg, comm)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
        reduce_bytes.append(n)
        return n
    inner = tr.step_fn

    def step(prm, state, b):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(prm, state, b)
        torch.cuda.synchronize()
        step_info.append((time.perf_counter() - t0, counts(), mla_calls()))
        return out
    tr.step_fn = step
    calls: Counter = Counter()
    steps_mod.adamw_update, steps_mod.reduce_grads = timed_update, timed_reduce
    torch.cuda.reset_peak_memory_stats()
    try:
        with plain_calls(calls):
            params, opt = tr.run()
    finally:
        steps_mod.adamw_update, steps_mod.reduce_grads = update, reduce
        tr.step_fn = inner
    check(not calls, f"the training path reached plain versions: {dict(calls)}")
    check(not any(t_.requires_grad for t_ in leaves(params)),
          "the trained parameters came back requiring grad")
    return dict(params=params, opt=opt, losses=[r["loss"] for r in tr.metrics_log],
                gnorms=[r["gnorm"] for r in tr.metrics_log],
                step_s=[t_ for t_, _, _ in step_info], opt_s=opt_s, reduce_s=reduce_s,
                reduce_bytes=reduce_bytes, launches=[c for _, c, _ in step_info],
                mla=[m_ for _, _, m_ in step_info],
                peak=torch.cuda.max_memory_allocated() / 2**30,
                peak_reserved=torch.cuda.max_memory_reserved() / 2**30)


def check_train_launches(launches: list, want: dict, where: str) -> None:
    """Each step's launches (``run_trainer``) must be ``want``."""
    for i, got in enumerate(launches):
        check_launches(got, want, f"{where} {i + 1}")


def train_phase(card: str) -> list:
    """The Trainer on DBRX-132B at full width (``train_4k``, 1 layer, 2
    micro-batches of 8 x 2048, bf16 moments) over 8 EP ranks on the card,
    after the backward kernels' checks and one MoE layer's gradients."""
    t_start = time.perf_counter()
    print(f"training phase: {memory_line()} before")
    full, cfg = train_config()
    m = cfg.moe
    print(f"training: DBRX-132B train_4k at full width ({cfg.d_model} wide, "
          f"{m.num_experts} experts top-{m.top_k}, HT flat, fp8 dispatch "
          f"{m.quantize_dispatch}, capacity {m.capacity_factor}, remat {cfg.remat}); "
          f"{TRAIN_LAYERS} of {full.num_layers} layers, global batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} in {TRAIN_MICRO} micro-batches (the preset's {full.microbatch}), "
          f"{RANKS} EP ranks on one card, AdamW moments in bf16")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=1,
                          state_dtype=torch.bfloat16)
    tr = Trainer(cfg, TrainerConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                                    seq_len=TRAIN_SEQ, log_every=1), comm=LocalComm(RANKS),
                 opt_cfg=opt_cfg, device=DEV)
    params, opt = tr.init_state()
    torch.cuda.synchronize()
    print(f"  parameters {tree_bytes(params) / 2**30:.2f} GiB, moments "
          f"{tree_bytes(opt) / 2**30:.2f} GiB")
    p0 = _index(params["moe_stack"]["moe"], 0)
    records = train_kernel_phase(cfg, p0)
    records.update(train_flash_phase(cfg))
    gc.collect()
    torch.cuda.empty_cache()
    moe_grad_phase(cfg, _index(params["moe_stack"]["moe"], 0))
    del p0
    gc.collect()
    torch.cuda.empty_cache()
    batch = tr.data.batch_at(0)
    fwd = get_model(cfg).forward
    with torch.no_grad():
        ref_loss = sum(fwd(params, {k: v[i] for k, v in batch.items()}, cfg, LocalComm(RANKS))[0]
                       for i in range(TRAIN_MICRO)) / TRAIN_MICRO
    ref_loss = float(ref_loss)
    gc.collect()
    torch.cuda.empty_cache()
    # the Trainer's own loop, over the repeated batch 0 and the state above
    run = run_trainer(tr, params, opt, batch)
    params, opt, losses = run.pop("params"), run.pop("opt"), run["losses"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"losses {losses}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    check(rel <= PF_LOSS_REL, f"step 1's loss {losses[0]} differs from the train_4k "
          f"forward's {ref_loss} by {rel:.3g} (limit {PF_LOSS_REL})")
    check(losses[-1] < losses[0], f"the loss did not fall over {TRAIN_STEPS} steps on a "
          f"repeated batch: {losses}")
    check_train_launches(run["launches"], train_launches(cfg), "train step")
    total = Counter()
    for got in run["launches"]:
        total.update(got)
    step_s, opt_times = run["step_s"], run["opt_s"]
    micro_s = [(s_ - o) / TRAIN_MICRO for s_, o in zip(step_s, opt_times)]
    print(f"Trainer ({card}): losses {[round(x, 6) for x in losses]} over {TRAIN_STEPS} steps "
          f"on a repeated batch (falling); step 1's loss within {rel:.3g} of the train_4k "
          f"forward's {ref_loss:.6f} (limit {PF_LOSS_REL}); grad norms "
          f"{[round(g, 4) for g in run['gnorms']]}; every gradient of step 1 "
          f"finite and nonzero; no plain version reached")
    print(f"  step {[round(s_, 4) for s_ in step_s]} s, per micro-batch (forward + backward) "
          f"{[round(s_, 4) for s_ in micro_s]} s, optimizer {[round(s_, 4) for s_ in opt_times]} "
          f"s; {TRAIN_BATCH * TRAIN_SEQ / np.median(step_s):.1f} train tok/s (median step); "
          f"peak device memory {run['peak']:.2f} GiB; launches per step {run['launches'][0]}")
    for name in TRAIN_KERNELS:
        records[name]["launches"] = total[name]
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {train_trace(cfg, params, batch)['line']}")
    del params, batch, tr
    gc.collect()
    torch.cuda.empty_cache()
    hier_train_run(card, losses[0], float(np.median(step_s)))
    print(f"training phase {time.perf_counter() - t_start:.1f} s; {memory_line()} after")
    return list(records.values())


# the hierarchical training step: the Trainer's steps on the repeated batch
# (its seq: TRAIN_SEQ, or 1024 had the card's peak passed 74 GiB)
HIER_TRAIN_STEPS, HIER_TRAIN_SEQ = 2, TRAIN_SEQ


def hier_train_run(card: str, flat_loss: float, flat_step_s: float) -> None:
    """The Trainer on DBRX-132B train_4k (1 layer, TRAIN_BATCH x
    HIER_TRAIN_SEQ in TRAIN_MICRO micro-batches, bf16 moments) with its MoE
    layer on the hierarchical HT path over LocalComm(8) on two pods of four
    (HIER_CHUNKS chunks, the preset's fp8 dispatch and capacities 1.25),
    HIER_TRAIN_STEPS steps on the repeated batch: the losses finite and
    falling, each step's launches exact (``train_launches`` on the
    hierarchical path), no plain version reached; the step seconds, tok/s
    and the peak printed, and the first loss beside HT flat's on the same
    parameters and batch (their drops differ, so it is not held)."""
    t0 = time.perf_counter()
    _, flat = train_config()
    cfg = hier_config(flat)
    tr = Trainer(cfg, TrainerConfig(steps=HIER_TRAIN_STEPS, global_batch=TRAIN_BATCH,
                                    seq_len=HIER_TRAIN_SEQ, log_every=1), comm=hier_comm(),
                 opt_cfg=AdamWConfig(lr=TRAIN_LR, total_steps=HIER_TRAIN_STEPS, warmup_steps=1,
                                     state_dtype=torch.bfloat16), device=DEV)
    params, opt = tr.init_state()
    run = run_trainer(tr, params, opt, tr.data.batch_at(0))
    del params, opt
    losses, step_s = run["losses"], run["step_s"]
    check(len(losses) == HIER_TRAIN_STEPS and all(np.isfinite(losses)),
          f"hierarchical losses {losses}")
    check(losses[-1] < losses[0], f"the hierarchical loss did not fall over "
          f"{HIER_TRAIN_STEPS} steps on a repeated batch: {losses}")
    check_train_launches(run["launches"], train_launches(cfg, RANKS, "hier", HIER_CHUNKS),
                         "hierarchical train step")
    micro_s = [(s_ - o) / TRAIN_MICRO for s_, o in zip(step_s, run["opt_s"])]
    med = float(np.median(step_s))
    print(f"Trainer, hierarchical HT ({card}): DBRX-132B train_4k at full width, "
          f"{cfg.num_layers} layer, {TRAIN_BATCH} x {HIER_TRAIN_SEQ} in {TRAIN_MICRO} "
          f"micro-batches over LocalComm({RANKS}) on {HIER_AXES}, {HIER_CHUNKS} chunks, fp8 "
          f"dispatch {cfg.moe.quantize_dispatch}, capacity {cfg.moe.capacity_factor}, bf16 "
          f"moments: losses {[round(x, 6) for x in losses]} (falling; HT flat's first "
          f"{flat_loss:.6f} on the same parameters and batch, not held: the drops differ); "
          f"grad norms {[round(g, 4) for g in run['gnorms']]}; step "
          f"{[round(x, 4) for x in step_s]} s, per micro-batch {[round(x, 4) for x in micro_s]} "
          f"s, optimizer {[round(x, 4) for x in run['opt_s']]} s; "
          f"{TRAIN_BATCH * HIER_TRAIN_SEQ / med:.1f} train tok/s (median step; HT flat's step "
          f"{flat_step_s:.4f} s, hierarchical / flat {med / flat_step_s:.3f}); peak device "
          f"memory {run['peak']:.2f} GiB; launches per step {run['launches'][0]} = "
          f"train_launches on the hierarchical path; no plain version reached; "
          f"{time.perf_counter() - t0:.1f} s")
    del run, tr
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# MLA's recomputing backward, and training an MLA config on one card
# ---------------------------------------------------------------------------

# the chunked MLA attention at full width: one row of MLA_SEQ tokens, bf16,
# the train_4k preset's kv_chunk. Each gradient of MlaChunked within
# MLA_GRAD_REL of autograd through the plain loop (relative to its largest
# value: both sum in f32 from the same bf16 inputs in another order, and
# round once), the forward bitwise, and the Function's peak above its
# inputs at most MLA_PEAK_SHARE of the loop's
MLA_SEQ, MLA_GRAD_REL, MLA_PEAK_SHARE = 4096, 2e-2, 1 / 3
MLA_ARCHS = {"deepseek-v3-671b": "DeepSeek-V3", "minicpm3-4b": "MiniCPM3-4B"}


def mla_inputs(cfg, seq: int, seed: int) -> tuple[list, torch.Tensor, float]:
    """(q_nope, q_rope, ckv, k_rope, wk_b, wv_b) of one row of ``seq``
    tokens at ``cfg``'s MLA widths in its dtype (unit queries, keys and
    latents; the up-projections at init scale, so the scores have unit
    spread), an f32 output cotangent rounded through the dtype, and the
    softmax scale."""
    m, h = cfg.mla, cfg.padded_heads()
    g = torch.Generator(device=DEV).manual_seed(seed)

    def rnd(shape, scale=1.0, dt=cfg.dtype):
        return (torch.randn(shape, generator=g, device=DEV) * scale).to(dt)
    r = m.kv_lora_rank
    ins = [rnd((1, seq, h, m.qk_nope_dim)), rnd((1, seq, h, m.qk_rope_dim)), rnd((1, seq, r)),
           rnd((1, seq, m.qk_rope_dim)), rnd((r, h, m.qk_nope_dim), r ** -0.5),
           rnd((r, h, m.v_head_dim), r ** -0.5)]
    cot = rnd((1, seq, h, m.v_head_dim)).float()
    return ins, cot, (m.qk_nope_dim + m.qk_rope_dim) ** -0.5


def mla_grad_run(fn, ins: list, cot: torch.Tensor) -> tuple:
    """``fn``'s forward and backward on copies of ``ins`` that require
    grad, the card synchronised: (the input gradients, seconds, the peak
    device memory above what was allocated before, GiB)."""
    xs = [t.detach().clone().requires_grad_() for t in ins]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn(*xs).backward(cot)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return [t.grad for t in xs], sec, peak


def mla_phase(card: str) -> None:
    """MLA's chunked attention with its recomputing backward (``MlaChunked``)
    against the plain loop at each MLA config's train_4k widths (one row of
    MLA_SEQ tokens, bf16): the forward bitwise, with and without grad;
    each gradient within MLA_GRAD_REL of autograd through the loop; the
    backward run once a call; each one's forward + backward seconds (the
    second of two runs) and its peak above its inputs, the Function's at
    most MLA_PEAK_SHARE of the loop's."""
    t_start = time.perf_counter()
    for i, (arch, model) in enumerate(MLA_ARCHS.items()):
        cfg = get_config(arch, "train_4k")
        m, chunk = cfg.mla, cfg.attn.kv_chunk
        ins, cot, scale = mla_inputs(cfg, MLA_SEQ, 60 + i)

        def loop(qn, qr, ck, kr, wk, wv):
            return mla_mod._mla_chunked({"wk_b": wk, "wv_b": wv}, qn, qr, ck, kr, scale,
                                        cfg.dtype, chunk=chunk)

        def fn(*a):
            return mla_mod.MlaChunked.apply(*a, scale, cfg.dtype, chunk)
        with torch.no_grad():
            want = loop(*ins)
            check(torch.equal(fn(*ins), want), f"{model}: MlaChunked's forward differs from "
                  "the plain loop's")
        xs = [t.detach().clone().requires_grad_() for t in ins]
        check(torch.equal(fn(*xs).detach(), want), f"{model}: MlaChunked's forward under "
              "grad differs from the plain loop's")
        del want, xs
        runs = {}
        for name, f in (("loop", loop), ("MlaChunked", fn)):
            for _ in range(2):
                reset_counts()
                runs[name] = mla_grad_run(f, ins, cot)
            check(mla_calls() == ((1, 1) if name == "MlaChunked" else (0, 0)),
                  f"{model}: {name}'s run called MlaChunked {mla_calls()} times")
        (lg, ls, lp), (fg, fs, fp) = runs["loop"], runs["MlaChunked"]
        names = ("q_nope", "q_rope", "ckv", "k_rope", "wk_b", "wv_b")
        errs = {n: max_err(a, b) / float(b.float().abs().max()) for n, a, b in zip(names, fg, lg)}
        bad = {n: e for n, e in errs.items() if not e <= MLA_GRAD_REL}
        check(not bad, f"{model}: MlaChunked's gradients off autograd of the loop by {bad} "
              f"(limit {MLA_GRAD_REL})")
        check(fp <= MLA_PEAK_SHARE * lp, f"{model}: MlaChunked's peak {fp:.3f} GiB is over "
              f"{MLA_PEAK_SHARE:.3f} of the loop's {lp:.3f} GiB")
        err_line = ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
        print(f"MLA backward, {model} train_4k widths ({card}): one row of {MLA_SEQ} tokens, "
              f"{cfg.padded_heads()} heads (of {cfg.attn.n_heads}), nope {m.qk_nope_dim}, rope "
              f"{m.qk_rope_dim}, kv_lora {m.kv_lora_rank}, v {m.v_head_dim}, chunk {chunk}, "
              f"{cfg.dtype}: MlaChunked's forward bitwise equal to the plain loop's (with and "
              f"without grad); its gradients off autograd of the loop by {err_line} relative "
              f"to each one's largest (limit {MLA_GRAD_REL}); forward + backward "
              f"{fs * 1e3:.1f} ms against the loop's {ls * 1e3:.1f} ms; peak above the inputs "
              f"{fp:.3f} GiB against the loop's {lp:.3f} GiB ({fp / lp:.3f}, limit "
              f"{MLA_PEAK_SHARE:.3f})")
        del ins, cot, runs, lg, fg
        gc.collect()
        torch.cuda.empty_cache()
    print(f"MLA phase {time.perf_counter() - t_start:.1f} s")


# MiniCPM3-4B train_4k on one card: its LAYERS layers whole unless the
# reckoned state (DT_STATE_PER_PARAM bf16 copies of each parameter) plus
# MC_ACT_GIB of activations passes DT_MAX_GIB, then cut to fit; a global
# batch of MC_BATCH x 4096 in MC_MICRO micro-batches, MC_STEPS steps on the
# repeated batch, bf16 moments
MC_BATCH, MC_MICRO, MC_STEPS, MC_ACT_GIB = 4, 2, 2, 12.0


def minicpm_train_phase(card: str) -> None:
    """The Trainer on MiniCPM3-4B at full width (train_4k: MLA over 40 heads
    padded to 48, tied embeddings, remat), the one-card path through
    ``MlaChunked`` at its widths: the losses finite and falling, no kernel
    launched (MLA and the dense FFN are plain torch), ``MlaChunked``'s
    calls exact (``mla_train_calls``), no plain version reached; the step
    and optimizer seconds, train tok/s and the peak printed."""
    t0 = time.perf_counter()
    full = get_config("minicpm3-4b", "train_4k")
    spec = tf_mod.lm_spec(full)
    per_layer = sum(np.prod(s.shape) for s in leaves(spec["dense_stack"])) / full.num_layers
    rest = sum(np.prod(s.shape) for s in leaves(spec)) - per_layer * full.num_layers
    state = lambda n: DT_STATE_PER_PARAM * 2 * (rest + per_layer * n) / 2**30  # noqa: E731
    layers = full.num_layers
    while state(layers) + MC_ACT_GIB > DT_MAX_GIB:
        layers -= 1
    cfg = dataclasses.replace(full, num_layers=layers, microbatch=MC_MICRO)
    tr = Trainer(cfg, TrainerConfig(steps=MC_STEPS, global_batch=MC_BATCH, seq_len=DT_SEQ,
                                    log_every=1), opt_cfg=AdamWConfig(
                     lr=TRAIN_LR, total_steps=MC_STEPS, warmup_steps=1,
                     state_dtype=torch.bfloat16), device=DEV)
    params, opt = tr.init_state()
    weights = tree_bytes(params) / 2**30
    run = run_trainer(tr, params, opt, tr.data.batch_at(0))
    del params, opt
    losses, step_s = run["losses"], run["step_s"]
    check(len(losses) == MC_STEPS and all(np.isfinite(losses)), f"MiniCPM3 losses {losses}")
    check(losses[-1] < losses[0], f"the MiniCPM3 loss did not fall over {MC_STEPS} steps on "
          f"a repeated batch: {losses}")
    check_train_launches(run["launches"], {}, "MiniCPM3 train step")
    want = mla_train_calls(cfg, MC_BATCH // MC_MICRO)
    check(all(c == want for c in run["mla"]), f"MiniCPM3 train steps called MlaChunked "
          f"{run['mla']} times (forwards, backwards), expected {want} a step")
    med = float(np.median(step_s))
    print(f"Trainer, MiniCPM3-4B train_4k at full width ({card}): {layers} of "
          f"{full.num_layers} layers ({'whole' if layers == full.num_layers else 'cut: the '
          f'reckoned state of more passes {DT_MAX_GIB} GiB'}; {state(layers):.2f} GiB of "
          f"state reckoned), {cfg.padded_heads()} heads (of {cfg.attn.n_heads}), tied "
          f"embeddings, remat {cfg.remat}, {MC_BATCH} x {DT_SEQ} in {MC_MICRO} micro-batches "
          f"(the preset's {full.microbatch}), bf16 moments: losses "
          f"{[round(x, 6) for x in losses]} (falling); grad norms "
          f"{[round(g_, 4) for g_ in run['gnorms']]}; step {[round(x, 4) for x in step_s]} s, "
          f"optimizer {[round(x, 4) for x in run['opt_s']]} s; {MC_BATCH * DT_SEQ / med:.1f} "
          f"train tok/s (median step); weights {weights:.2f} GiB, peak {run['peak']:.2f} GiB; "
          f"no kernel launched; MlaChunked calls a step {run['mla'][0]} (forwards, backwards) "
          f"= mla_train_calls; no plain version reached; {time.perf_counter() - t0:.1f} s")
    del run, tr
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the serving telemetry on the card
# ---------------------------------------------------------------------------

def traced_continuous_phase(cfg, params, card: str, reqs, want: dict) -> None:
    """DBRX's continuous serve of ``reqs`` twice more, captured, back to
    back: untraced, then with a Tracer and a TimeSeries. Every stream of
    each bitwise equal to the first serve's (``want``); in the traced one
    one serve_step and one admission span a step, one admit and one
    complete instant a request, one series row a step; its Chrome trace
    written under the build dir and held by the port's validator; the two
    ITLs side by side (what tracing costs, in one process state)."""
    itl = {}
    for traced in (False, True):
        tracer, series = (Tracer(), TimeSeries()) if traced else (None, None)
        srv = ContinuousDecodeServer(cfg, BATCH, CMAX_LEN, ep_size=hosted(cfg), params=params,
                                     page_size=PAGE, tracer=tracer, series=series)
        m = srv.serve_requests(reqs)
        toks = served_tokens(cfg, srv, m, reqs)
        what = "traced" if traced else "untraced"
        check(all(np.array_equal(t, want[r.rid]) for r, t in zip(reqs, toks)),
              f"the {what} continuous serve's tokens differ from the first serve's")
        check(srv._serve_step.graph is not None, f"the {what} continuous serve captured no graph")
        srv.close()
        itl[what] = m.itl_mean_s
    path = tracer.write_chrome_trace(_build.BUILD_DIR.parent / "traces" /
                                     f"{cfg.name}_continuous.json")
    ev = validate_chrome_trace(load_chrome_trace(path))
    tl, steps = m.timeline, m.serve_steps
    want_counts = {"serve_step": steps, "admission": steps, "admit": len(reqs),
                   "complete": len(reqs)}
    got_counts = {k: v["count"] for k, v in tl.items()}
    check(got_counts == want_counts and len(m.series) == steps,
          f"the traced serve's timeline {got_counts} and {len(m.series)} series rows, "
          f"expected {want_counts} and {steps}")
    rows = np.asarray([r["itl_s"] for r in m.series])
    print(f"{cfg.name} continuous serve, captured, traced ({card}): streams bitwise equal to "
          f"the untraced serve's; itl mean {itl['traced']:.5f} s (the untraced serve just "
          f"before {itl['untraced']:.5f} s, {itl['traced'] / itl['untraced']:.4f}x), step-row "
          f"itl mean {rows.mean():.5f} s (step 0's warm-up and capture included), "
          f"p99 {np.percentile(rows, 99):.5f} s; spans serve_step {tl['serve_step']['total_s']:.4f} "
          f"s over {steps} steps, admission {tl['admission']['total_s']:.4f} s; "
          f"{len(ev)} trace events in {path.relative_to(_build.BUILD_DIR.parent.parent)}, "
          f"valid; series rows {len(m.series)}, queue depth peak "
          f"{max(r['queue_depth'] for r in m.series)}, pages peak {m.series[-1]['pages_peak']}")


# ---------------------------------------------------------------------------
# one EP rank per process (comm.DistComm): NCCL at world = the card count,
# two ranks sharing a card over gloo
# ---------------------------------------------------------------------------

# per-call timings: calls a reading, readings
DIST_ITERS = 50
# a child's whole run, and the process group's timeout inside it: DBRX's
# sub-phases alone (worlds 1 and 2), and with DeepSeek-V3's (world 4: 180 s
# more, about five times the 34.3 s its sub-phases took on four H100s)
DIST_TIMEOUT_S = 420
DS_DIST_TIMEOUT_S = 600


def dist_timeout(world: int) -> int:
    return DS_DIST_TIMEOUT_S if world == DS_DIST_WORLD else DIST_TIMEOUT_S


def check_dist_counts(launches: dict, cfg, path: str, calls: int, where: str,
                      chunks: int = HIER_CHUNKS) -> None:
    """The EP launches over ``calls`` layer calls of ``path``, one call
    per MoE layer and hosted rank, must be ``ep_launches``' count for
    each."""
    for name, per in ep_launches(cfg, path, chunks).items():
        check(launches.get(name, 0) == per * calls, f"{name} launched "
              f"{launches.get(name, 0)} times on {where}, expected {per * calls}")


def dist_cfg():
    return dataclasses.replace(full_config("decode_32k"), num_layers=LAYERS)


def dist_layer_params(cfg, dev) -> dict:
    """MoE layer 0 of DBRX at full width, all 16 experts: router and expert
    weights drawn on ``dev`` from a seed, the same in every process."""
    m, d = cfg.moe, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(11)

    def rnd(shape, fan_in, dt=cfg.dtype):
        return (torch.randn(shape, generator=gen, device=dev) / fan_in ** 0.5).to(dt)
    return dict(router=rnd((d, m.num_experts), d, torch.float32),
                w_gate=rnd((m.num_experts, d, m.d_ff_expert), d),
                w_up=rnd((m.num_experts, d, m.d_ff_expert), d),
                w_down=rnd((m.num_experts, m.d_ff_expert, d), m.d_ff_expert))


def dist_layer_step(cfg, comm, p):
    """The EP API over ``comm`` on one MoE layer as a step for
    ``CompiledStep``: route, handle, staged dispatch, the expert FFN over
    the hosted ranks' experts (``p`` holds them in rank order), staged
    combine. batch: {"tokens": [hosted ranks, T, D]}."""
    def step(params, state, batch):
        xs = list(batch["tokens"].unbind(0))
        group = ep_group(cfg, comm, xs[0].shape[0])
        L = group.local_experts
        rs = [route(x.float() @ params["router"], router_config(cfg.moe)) for x in xs]
        hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
        recv = ep_complete(group, hs, ep_dispatch(group, hs, xs, send_only=True))
        ys = [_expert_ffn(group, y, c, params["w_gate"][i * L:(i + 1) * L],
                          params["w_up"][i * L:(i + 1) * L], params["w_down"][i * L:(i + 1) * L])
              for i, (y, c) in enumerate(recv)]
        outs = ep_complete(group, hs, ep_combine(group, hs, ys, send_only=True))
        return torch.stack([o.to(xs[0].dtype) for o in outs]), state
    return step


def dist_peak() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def memory_line() -> str:
    return (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, peak {dist_peak():.2f}")


def dist_primitives(comm, lc, dev, rank: int) -> dict:
    """DistComm's collectives against LocalComm(world)'s on the same stacked
    inputs at the decode layer's shapes: bitwise for bf16, int32 and fp8
    (as bytes), all_reduce within f32 rounding. Returns each call's time
    (CUDA events over DIST_ITERS calls, and queued behind a spin)."""
    W = comm.size
    gen = torch.Generator(device=dev).manual_seed(12)
    C, H = BATCH // W, dist_cfg().d_model
    cases = {
        "bf16": torch.randn((W, W, C, H), generator=gen, device=dev).to(torch.bfloat16),
        "int32": torch.randint(-2**30, 2**30, (W, W, C, 4), generator=gen, device=dev,
                               dtype=torch.int32),
        "fp8": torch.randint(0, 256, (W, W, C, H), generator=gen, device=dev,
                             dtype=torch.uint8).view(torch.float8_e4m3fn),
    }
    for name, x in cases.items():
        want = lc.all_to_all(list(x.unbind(0)))[rank]
        got = comm.all_to_all([x[rank]])[0]
        check(got.dtype == want.dtype and torch.equal(got.view(torch.uint8),
                                                      want.view(torch.uint8)),
              f"DistComm all_to_all differs from LocalComm's in {name}")
        want = lc.all_gather(list(x[:, 0].unbind(0)))[rank]
        got = comm.all_gather([x[rank, 0]])[0]
        check(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
              f"DistComm all_gather differs from LocalComm's in {name}")
    xf = torch.randn((W, C, H), generator=gen, device=dev)
    want = lc.all_reduce(list(xf.unbind(0)))[rank]
    got = comm.all_reduce([xf[rank]])[0]
    err = float((got - want).abs().max())
    check(err <= 1e-6 * float(want.abs().max()) * W, f"DistComm all_reduce off by {err}")
    send = cases["bf16"][rank]
    topk = torch.randint(0, 16, (C, 4), generator=gen, device=dev, dtype=torch.int32)
    times = {}
    for label, fn in (("all_to_all", lambda: comm.all_to_all([send])),
                      ("LocalComm all_to_all", lambda: lc.all_to_all(list(cases["bf16"]))),
                      ("all_gather", lambda: comm.all_gather([topk])),
                      ("LocalComm all_gather", lambda: lc.all_gather([topk] * W))):
        times[label] = (call_ms(fn, DIST_ITERS), queued_ms(fn, DIST_ITERS)[0])
    return dict(times=times, reduce_err=err, shapes=dict(a2a=tuple(send.shape),
                                                         gather=tuple(topk.shape)))


def dist_layer_phase(cfg, comm, lc, dev, rank: int) -> dict:
    """DBRX's MoE layer 0 at full width through the EP API over DistComm at
    N = world (batch 128 over the ranks), in nccl_ep and deepep + fp8:
    bitwise against LocalComm(world) running the same calls here, the EP
    kernels launched on the DistComm run, and, over NCCL, the step captured
    by CompiledStep replaying bitwise what it ran eagerly (a gloo step is
    not captured: ``CompiledStep(capture=comm.capturable)`` runs it
    eagerly). Then decode_loop on two streams against the naive step."""
    p = dist_layer_params(cfg, dev)
    W, L = comm.size, cfg.moe.num_experts // comm.size
    mine = {k: (v if k == "router" else v[rank * L:(rank + 1) * L].contiguous())
            for k, v in p.items()}
    gen = torch.Generator(device=dev).manual_seed(13)
    x = (torch.randn((W, BATCH // W, cfg.d_model), generator=gen, device=dev)
         .to(cfg.dtype))
    out = {}
    for path in ("nccl_ep", "deepep_fp8"):
        c = layout_cfg(cfg, path)
        want = dist_layer_step(c, lc, p)(p, {}, {"tokens": x})[0][rank]
        reset_counts()
        got = dist_layer_step(c, comm, mine)(mine, {}, {"tokens": x[rank:rank + 1]})[0][0]
        torch.cuda.synchronize()
        launches = {k: n for k, n in counts().items() if n}
        check_dist_counts(launches, c, path, 1, f"the DistComm {path} layer")
        check(torch.equal(got, want), f"the DistComm {path} layer differs from "
              f"LocalComm({W})'s (max {float((got.float() - want.float()).abs().max())})")
        step = CompiledStep(dist_layer_step(c, comm, mine), capture=comm.capturable)
        state, batch = {}, {"tokens": x[rank:rank + 1].clone()}
        eager_out, _ = step(mine, state, batch)          # warm-up, then the capture
        replay, _ = step(mine, state, batch)
        torch.cuda.synchronize()
        check((step.graph is not None) == comm.capturable,
              f"the {path} layer over {comm.backend}: captured {step.graph is not None}")
        check(torch.equal(eager_out[0], got) and torch.equal(replay[0], got),
              f"the compiled {path} layer's second call differs from its eager run")
        out[path] = dict(launches=launches, capture_s=step.capture_s,
                         call_ms=call_ms(lambda: step(mine, state, batch), 20))
        del step
    # decode_loop on two streams (their collectives serialise on NCCL's
    # stream) against the naive step, micro-batch pairs of the layer's rows
    group = ep_group(cfg, comm, BATCH // W // 2)
    rcfg = router_config(cfg.moe)

    def router_fn(t):
        r = route(t.float() @ mine["router"], rcfg)
        return r.topk_idx, r.topk_weights

    def expert_fn(r, y, c):
        return _expert_ffn(group, y, c, mine["w_gate"], mine["w_up"], mine["w_down"])

    xr = x[rank]
    pairs = [([xr[:BATCH // W // 2] * (1 + s)], [xr[BATCH // W // 2:] * (1 + s)])
             for s in (0, 1, 1)]
    loop = decode_loop(group, router_fn, expert_fn, pairs)
    torch.cuda.synchronize()
    for s, pair in enumerate(pairs):
        for got, xs in zip(loop[s], pair):
            check(torch.equal(got[0], naive_decode_step(group, router_fn, expert_fn, xs)[0]),
                  f"decode_loop over DistComm differs from the naive step at step {s}")
    return out


def dist_serve(cfg, params, comm, dev, mode: str) -> tuple:
    """DecodeServer.serve on the seeded prompts (the global batch) through
    ``comm`` (a DistComm, a LocalComm or None: dense), every launch counter
    read; "compiled" steps through the server's compiled step, which
    captures unless the comm cannot be captured. Returns the global tokens,
    the metrics, the launches and whether a graph was captured."""
    srv = DecodeServer(cfg, BATCH, MAX_LEN, comm=comm, params=params, device=dev)
    if mode == "eager":
        eager(srv)
    reset_counts()
    m = srv.serve(serve_prompts(cfg.vocab), GEN)
    launches = {k: n for k, n in counts().items() if n}
    toks = srv.last_tokens
    check(toks.shape == (srv.batch, GEN + 1) and toks.min() >= 0 and toks.max() < cfg.vocab,
          f"bad token stream {toks.shape}")
    graphed = mode == "compiled" and srv._serve_step.graph is not None
    srv.close()
    return toks, m, launches, graphed


def step0_logits(cfg, params, comm, dev) -> torch.Tensor:
    """The f32 logits [B, V] of the first prompt token through one decode
    step of this process's rows on a fresh cache, gathered over the batch
    (every process of a DistComm takes part)."""
    rows = comm.batch_rows(BATCH) if comm is not None else slice(0, BATCH)
    tok = serve_prompts(cfg.vocab)[rows, :1].to(dev)
    state = init_decode_state(cfg, tok.shape[0], MAX_LEN, dev)
    logits, _ = lm_decode_step(params, state, {"tokens": tok}, cfg, comm)
    out = logits[:, -1, :cfg.vocab].float()
    return comm.gather_batch(out) if comm is not None else out


def row_invariance(cfg, params, dev, rows: int) -> str:
    """Whether MoE layer 0's bf16 K (under MLA, latent) projection and the
    f32 logits product give the first ``rows`` rows of a batch the same bits
    computed alone as in the whole batch (cuBLAS picks its kernel by the row
    count)."""
    h = (torch.randn((BATCH, 1, cfg.d_model), generator=torch.Generator(device=dev)
                     .manual_seed(14), device=dev)).to(cfg.dtype)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    attn = params["moe_stack"]["attn"]
    what, w = ("K", attn["wk"]) if "wk" in attn else ("MLA latent (wkv_a)", attn["wkv_a"])
    wk = w[0].reshape(cfg.d_model, -1)
    parts = []
    for label, fn in ((f"bf16 {what} projection", lambda t: t @ wk),
                      ("f32 logits product", lambda t: logits_out(t, table))):
        whole, part = fn(h)[:rows].float(), fn(h[:rows]).float()
        parts.append(f"{label} of {rows} rows alone " + (
            "equals the same rows in a batch" if torch.equal(whole, part) else
            f"is up to {float((whole - part).abs().max()):.3g} off the same rows in a "
            f"batch of {BATCH}"))
    return "; ".join(parts)


def logit_errors(got: torch.Tensor, want: torch.Tensor, live=None) -> str:
    """First-step logits [B, V] against a reference's: relative to the
    largest, and by row (each row's largest error over its largest logit);
    given the live rows' mask (a continuous step's ``active``), the live and
    the idle rows apart."""
    rows = (got - want).abs().amax(-1) / want.abs().amax(-1)
    out = (f"first-step logits {float((got - want).abs().max() / want.abs().max()):.3g} off "
           f"relative to their largest; by row median {float(rows.median()):.3g}, max "
           f"{float(rows.max()):.3g}, {int((rows > TOL).sum())} of {rows.numel()} rows above "
           f"{TOL}")
    if live is not None:
        live = torch.as_tensor(np.asarray(live) == 1, device=rows.device)
        for name, part in (("live", rows[live]), ("idle", rows[~live])):
            if part.numel():
                out += (f"; {part.numel()} {name} rows: by row min {float(part.min()):.3g}, "
                        f"max {float(part.max()):.3g}, {int((part > TOL).sum())} above {TOL}")
    return out


def model_label(cfg) -> str:
    return f"{cfg.name} {cfg.num_layers} layers"


def dist_serve_phase(cfg, comm, dev, rank: int, world: int) -> dict:
    """DecodeServer(comm=DistComm) over ``cfg`` (DBRX's or DeepSeek-V3's
    decode_32k preset, full width, cut in depth) on its compiled step
    (captured over NCCL, eager over gloo), exact EP launch counts; then, on
    rank 0 alone, the reference on this card: the dense server at EP extent
    1 (the path DistComm's extent 1 runs, on the same rows: tokens bitwise),
    else LocalComm(EP extent), whose dense products see the whole batch
    where each process sees its rows: the first step's logits within TOL,
    the token agreement printed."""
    # rank 0 may still be running the last phase's reference: start every
    # process's clock together
    dist.barrier()
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, dev, comm=comm)
    toks, m, launches, graphed = dist_serve(cfg, params, comm, dev, "compiled")
    check(graphed == comm.capturable, f"the DistComm server over {comm.backend} "
          f"{'did not capture' if comm.capturable else 'captured'} its step")
    if comm.size > 1:      # captured: the warm-up and the capture; else every step
        steps = 2 if graphed else PROMPT + GEN
        check_dist_counts(launches, cfg, "nccl_ep", steps * moe_layers(cfg),
                          f"the DistComm server over {comm.backend}")
    logits = step0_logits(cfg, params, comm, dev)
    progress(rank, f"{model_label(cfg)}: its DistComm serve", t)
    out = dict(itl=m.itl_mean_s, p99=m.itl_p99_s, ttft=m.ttft_s, tok_s=m.output_tok_s,
               launches=launches, peak_gib=dist_peak(), ep=comm.size, graphed=graphed,
               rows=comm.batch_rows(BATCH).stop - comm.batch_rows(BATCH).start,
               model=model_label(cfg))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        progress(rank, f"{model_label(cfg)}: the shard freed ({memory_line()})", t)
        full = init_params(cfg, 0, dev)
        ref_comm = None if comm.size == 1 else LocalComm(comm.size)
        want, rm, _, _ = dist_serve(cfg, full, ref_comm, dev,
                                    "compiled" if comm.capturable else "eager")
        want_logits = step0_logits(cfg, full, ref_comm, dev)
        err = float((logits - want_logits).abs().max() / want_logits.abs().max())
        progress(rank, f"{model_label(cfg)}: the reference serve "
                 f"({logit_errors(logits, want_logits)})", t)
        agree = toks == want
        out.update(ref_itl=rm.itl_mean_s, logits_err=err, agree=float(agree.mean()),
                   agree_first=float(agree[:, 0].mean()), bitwise=bool(agree.all()),
                   rows_line=row_invariance(cfg, full, dev, out["rows"]))
        if comm.size == 1:
            check(bool(agree.all()), "the DistComm server's tokens differ from the dense "
                  f"server's: {agree.mean():.4f} equal")
        check(err <= TOL, f"the DistComm server's first-step logits are {err:.3g} off "
              f"LocalComm({comm.size})'s")
        del full
    out["seconds"] = time.perf_counter() - t
    return out


# ---------------------------------------------------------------------------
# EPLB: heat-driven placement swaps through both servers (one card)
# ---------------------------------------------------------------------------

# the reference serving example's settings (examples/serve_decode.py): a
# swap every EPLB_EVERY steps, EPLB_R redundant slots (DBRX: 16 + 8 = 24
# slots, 3 a rank over 8); the fixed batch decodes EPLB_GEN tokens, so the
# swaps fall after steps 15, 31 and 47 and later steps run under each table
EPLB_EVERY, EPLB_R, EPLB_GEN = 16, 8, 64
EPLB_MAX_LEN = PROMPT + EPLB_GEN + 2
# the skewed EP layer: Zipf-like routing p(e) ~ (1+e)^-EPLB_SKEW over the
# experts, concentrated on rank 0's block (benchmarks/bench_imbalance.py)
EPLB_SKEW, EPLB_LAYER_STEPS = 1.2, 4


def eplb_cfg(cfg, physical: bool):
    """``cfg`` tracking expert heat, its expert weights logical or in the
    placement's slot order (adopt-once)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, track_expert_heat=True, params_physical=physical))


def to_logical(params, cfg) -> None:
    """Rebind a physical server's expert weights back to logical order, in
    place (each expert's primary replica)."""
    pl = cfg.moe.placement
    if pl is not None:
        spec = tf_mod.lm_spec(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, params_physical=False)))
        adopt_expert_params(params, spec, pl, None)


def eplb_fixed_run(cfg, params, card: str, mode: str, want: np.ndarray) -> dict:
    """DecodeServer with the EPLB hook over 8 hosted ranks, BATCH x (PROMPT
    + EPLB_GEN), captured (each placement's step warmed up and captured
    anew) or eager (every placement's uncompiled step): tokens bitwise
    equal to the serve without EPLB, launch counts exact, at least one swap
    adopted, L = 3 slots a rank after it."""
    tr = Tracer()
    srv = DecodeServer(cfg, BATCH, EPLB_MAX_LEN, ep_size=RANKS, params=params,
                       rebalance_every=EPLB_EVERY, num_redundant_experts=EPLB_R, tracer=tr)
    made = []
    if mode == "eager":
        srv._compiled_step = srv._step_factory
        srv._serve_step = srv._step_factory()
    else:
        compiled = srv._compiled_step

        def record_step():
            step = compiled()
            made.append(step)
            return step
        srv._compiled_step = record_step
        made.append(srv._serve_step)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    m = srv.serve(serve_prompts(cfg.vocab), EPLB_GEN)
    wall = time.perf_counter() - t0
    launches = counts()
    pls = list(srv.placements)
    check(len(pls) >= 1, f"the EPLB {mode} serve adopted no placement")
    check(np.array_equal(srv.last_tokens, want), f"the EPLB serve ({mode}, "
          f"{'physical' if cfg.moe.params_physical else 'logical'}) differs from the serve "
          f"without EPLB: first at (row, step) "
          f"{np.argwhere(srv.last_tokens != want)[:1].tolist()}")
    check(srv.cfg.moe.placement.slots_per_rank == 3, "the adopted tables do not hold 3 slots a rank")
    swaps = [i for i in range(EPLB_GEN) if (i + 1) % EPLB_EVERY == 0]
    if mode == "eager":
        steps = PROMPT + EPLB_GEN
    else:
        ran = [st for st in made if st.graph is not None]
        steps = 2 * len(ran)
        # one compiled step a placement; one adopted after the last step
        # never runs
        check(len(made) == 1 + len(pls) and len(made) - len(ran) <= 1,
              f"{len(ran)} captured of {len(made)} compiled steps for {len(pls)} adoptions")
    check_ep_counts(launches, cfg, steps, f"the EPLB {mode} serve")
    itls = srv.last_itls
    after = [itls[i + 1] for i in swaps if i + 1 < len(itls)]
    rest = [t for j, t in enumerate(itls) if j not in {i + 1 for i in swaps}]
    summ = tr.summary()
    out = dict(tokens=srv.last_tokens, placements=[(p.version, p.fingerprint()) for p in pls],
               itl=float(np.mean(rest)), itl_after=float(np.mean(after)), ttft=m.ttft_s,
               heat=m.heat_max_mean, rank_heat=m.rank_heat_max_mean, wall=wall,
               captures=[st.capture_s for st in made if st.capture_s is not None],
               adopt=summ.get("adopt", {}).get("total_s", 0.0),
               adopts=summ.get("adopt", {}).get("count", 0),
               rebalance=summ.get("rebalance", {}).get("total_s", 0.0),
               peak=torch.cuda.max_memory_allocated() / 2**30, launches=launches)
    srv.close()
    to_logical(params, srv.cfg if cfg.moe.params_physical else cfg)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def eplb_continuous_run(cfg, params, reqs, want: dict, admissions) -> dict:
    """ContinuousDecodeServer with the EPLB hook, captured: streams bitwise
    equal to the serve without EPLB, the same admissions; the heat's
    max/mean per expert and per rank of each window (the first ran under
    the contiguous layout, the second under the first adopted table)."""
    se = TimeSeries()
    srv = ContinuousDecodeServer(cfg, BATCH, CMAX_LEN, ep_size=RANKS, params=params,
                                 page_size=PAGE, rebalance_every=EPLB_EVERY,
                                 num_redundant_experts=EPLB_R, series=se)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    m = srv.serve_requests(reqs)
    toks = served_tokens(cfg, srv, m, reqs)
    check(all(np.array_equal(t, want[r.rid]) for r, t in zip(reqs, toks)),
          "the EPLB continuous serve's streams differ from the serve without EPLB")
    check(list(srv.reqsched.admissions) == list(admissions),
          "the EPLB continuous serve admitted otherwise than the serve without EPLB")
    check(len(srv.placements) >= 1, "the EPLB continuous serve adopted no placement")
    wins = [r for r in se.rows if r["kind"] == "rebalance"]
    out = dict(steps=m.serve_steps, itl=m.itl_mean_s, tok_s=m.output_tok_s,
               placements=[(p.version, p.fingerprint()) for p in srv.placements],
               windows=[(r["step"], r["heat_max_mean"], r["imbalance"]) for r in wins[:3]],
               heat=m.heat_max_mean, rank_heat=m.rank_heat_max_mean,
               peak=torch.cuda.max_memory_allocated() / 2**30, launches=counts())
    srv.close()
    if cfg.moe.params_physical:
        to_logical(params, srv.cfg)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def eplb_layer_phase(cfg, params, card: str) -> None:
    """The EP layer under skew at DBRX's widths: MoE layer 0's experts (the
    adopt-once rows of ``rebalancing_decode_loop``) over 8 hosted ranks,
    BATCH / RANKS tokens a rank, Zipf-like routing on rank 0's block;
    ``rebalancing_decode_loop`` with a swap after EPLB_LAYER_STEPS / 2 steps
    of the same inputs: its first window runs the contiguous layout, its
    second the rebalanced table (R = 0) or the redundant one (R =
    EPLB_R). Prints the largest received-token count a rank against the
    mean and the experts' card time a step (the three B3 calls a rank and
    the SiLU) under each; the outputs must be bitwise equal across the
    three. A printed line, not a claim."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    t = BATCH // RANKS
    rng = np.random.default_rng(21)
    p = (1.0 + np.arange(E)) ** -EPLB_SKEW
    p /= p.sum()
    topk = [torch.from_numpy(np.stack([rng.choice(E, K, replace=False, p=p)
                                       for _ in range(t)]).astype(np.int32)).to(DEV)
            for _ in range(RANKS)]
    w = [torch.softmax(torch.from_numpy(rng.standard_normal((t, K)).astype(np.float32)), -1)
         .to(DEV) for _ in range(RANKS)]
    xs = [(torch.randn((t, cfg.d_model), generator=torch.Generator(device=DEV).manual_seed(30 + r),
                       device=DEV) * 0.5).to(cfg.dtype) for r in range(RANKS)]
    # zero-drop, so that no placement drops an entry another keeps
    base = dataclasses.replace(ep_group(cfg, LocalComm(RANKS), t).cfg, capacity_factor=None,
                               expert_capacity_factor=None)
    moe = params["moe_stack"]["moe"]
    layer0 = {k: moe[k][0] for k in ("w_gate", "w_up", "w_down")}
    seen: dict = {}

    def make_window(group, rows):
        L = group.local_experts
        name = ("contiguous" if group.placement is None else
                "redundant" if group.placement.num_redundant else "rebalanced")

        def cycle():
            handles = ep_create_handle(group, topk, w)
            recv = ep_dispatch(group, handles, xs)
            ffn = lambda: [_expert_ffn(group, y3d, c, *(rows[k][i * L:(i + 1) * L]  # noqa: E731
                                                        for k in ("w_gate", "w_up", "w_down")))
                           for i, (y3d, c) in enumerate(recv)]
            return handles, recv, ffn

        def window(steps):
            outs = []
            for _ in steps:
                handles, _, ffn = cycle()
                outs.append(torch.stack(ep_combine(group, handles, ffn())))
            handles, _, ffn = cycle()
            recv_rank = [int(h.tokens_per_expert.sum()) for h in handles]
            seen[name] = dict(out=outs[-1], recv=recv_rank, ms=device_ms(ffn, 3), L=L)
            return outs, PL.heat_from_topk(torch.stack(topk), E)
        return window

    for r in (0, EPLB_R):
        rebalancing_decode_loop(base, make_window, list(range(EPLB_LAYER_STEPS)),
                                rebalance_every=EPLB_LAYER_STEPS // 2, ep_size=RANKS,
                                comm=LocalComm(RANKS), num_redundant=r, params=dict(layer0),
                                donate_params=False)
    check(sorted(seen) == ["contiguous", "rebalanced", "redundant"], f"placements run {sorted(seen)}")
    for name in ("rebalanced", "redundant"):
        check(torch.equal(seen[name]["out"], seen["contiguous"]["out"]),
              f"the skewed EP layer's output under the {name} placement differs from the "
              "contiguous layout's")
    parts = []
    for name in ("contiguous", "rebalanced", "redundant"):
        v = seen[name]
        parts.append(f"{name} (L {v['L']}): max {max(v['recv'])} against mean "
                     f"{np.mean(v['recv']):.1f} received entries a rank "
                     f"({max(v['recv']) / np.mean(v['recv']):.3f}), experts {v['ms']:.4f} ms "
                     "of card time a step")
    print(f"EPLB EP layer 0 under skew ({card}): {RANKS} ranks x {t} tokens, top-{K} over "
          f"{E} experts, p(e) ~ (1+e)^-{EPLB_SKEW}; outputs bitwise equal under the three "
          f"placements; " + "; ".join(parts))
    del layer0, seen
    gc.collect()
    torch.cuda.empty_cache()


def gemm_slot_phase(cfg, params, card: str) -> None:
    """B3 at the decode shapes with 2 and with 3 experts a rank (the slots a
    rank holds without EPLB and with 8 redundant slots over 8 ranks): which
    tiles stream-K splits, and where, depends on L and on an expert's slot,
    a row's bits must not. The first two experts' outputs at L = 3 bitwise
    equal to L = 2's and to L = 3's with the slots in reverse order, gate
    and down, and within GEMM_REL of the plain version."""
    moe = params["moe_stack"]["moe"]
    g = torch.Generator(device=DEV).manual_seed(23)
    parts = []
    for label, w in (("gate", moe["w_gate"][0][:3]), ("down", moe["w_down"][0][:3])):
        x = (torch.randn((3, BATCH, w.shape[1]), generator=g, device=DEV) * 0.5).to(cfg.dtype)
        counts3 = torch.tensor([BATCH, 41, 97], dtype=torch.int32, device=DEV)
        out3 = gg_mod.grouped_gemm(x, w, counts3)
        out2 = gg_mod.grouped_gemm(x[:2].contiguous(), w[:2].contiguous(), counts3[:2].contiguous())
        want = ref.grouped_gemm(x, w, counts3)
        rel = float((out3.float() - want.float()).norm() / want.float().norm())
        check(torch.equal(out3[:2], out2), f"grouped_gemm {label}: the rows of L = 3 differ "
              f"from the same rows at L = 2 (max {float((out3[:2].float() - out2.float()).abs().max()):.3g})")
        check(rel <= GEMM_REL, f"grouped_gemm {label} at L = 3 off its plain version by {rel:.3g}")
        rev = gg_mod.grouped_gemm(x.flip(0).contiguous(), w.flip(0).contiguous(),
                                  counts3.flip(0).contiguous()).flip(0)
        check(torch.equal(rev, out3), f"grouped_gemm {label}: an expert's rows move when "
              f"its slot does (max {float((rev.float() - out3.float()).abs().max()):.3g})")
        p2, p3 = (gg_mod.plan(n, BATCH, w.shape[1], w.shape[2]) for n in (2, 3))
        parts.append(f"{label} [L, {BATCH}, {w.shape[1]}] @ [L, {w.shape[1]}, {w.shape[2]}]: "
                     f"{p2.sk_tiles} and {p3.sk_tiles} split tiles at L 2 and 3, segments of "
                     f"{p3.seg} k blocks; rows bitwise equal, and in reversed slots; {rel:.3g} "
                     "relative to the plain version")
    print(f"grouped_gemm over the slot counts of EPLB ({card}): " + "; ".join(parts))


def eplb_phase(cfg, params, card: str, reqs, want: dict, admissions) -> np.ndarray:
    """EPLB through both servers on one card (the reference's serving example:
    track_expert_heat, rebalance_every=16, num_redundant_experts=8): the
    fixed batch without EPLB as the reference; with EPLB in logical mode
    (each step gathers the slots' experts from the logical weights) and in
    physical mode (adopt-once: the weights rebound in place at each swap),
    each captured and eager; the continuous serve of the continuous phase's
    requests in both modes, captured; then the skewed EP layer. Leaves
    ``params`` logical; returns the reference's tokens. Prints the ITL of the steps just after a swap apart
    from the rest, each recapture's and adoption's time, the peaks and the
    heat's max/mean before and after the first swap."""
    t0 = time.perf_counter()
    gemm_slot_phase(cfg, params, card)
    srv = DecodeServer(cfg, BATCH, EPLB_MAX_LEN, ep_size=RANKS, params=params)
    srv.serve(serve_prompts(cfg.vocab), EPLB_GEN)
    base = srv.last_tokens
    base_itl = float(np.mean(srv.last_itls))
    srv.close()
    del srv
    print(f"EPLB reference ({card}): {cfg.name} {BATCH} x ({PROMPT} + {EPLB_GEN}) without "
          f"EPLB, captured, itl mean {base_itl:.5f} s")
    for physical in (False, True):
        mode = "physical" if physical else "logical"
        c = eplb_cfg(cfg, physical)
        runs = {m: eplb_fixed_run(c, params, card, m, base) for m in ("captured", "eager")}
        check(np.array_equal(runs["captured"]["tokens"], runs["eager"]["tokens"]),
              f"EPLB {mode}: captured and eager tokens differ")
        check(runs["captured"]["placements"] == runs["eager"]["placements"],
              f"EPLB {mode}: captured and eager adopted other placements")
        for m, r in runs.items():
            caps = ", ".join(f"{x:.4f}" for x in r["captures"])
            print(f"EPLB fixed serve, {mode}, {m} ({card}): {BATCH} x ({PROMPT} + {EPLB_GEN}), "
                  f"rebalance every {EPLB_EVERY}, {EPLB_R} redundant slots (3 a rank); tokens "
                  f"bitwise equal to the serve without EPLB; placements (version, fingerprint) "
                  f"{r['placements']}; itl mean {r['itl']:.5f} s, the step after a swap "
                  f"{r['itl_after']:.5f} s; ttft {r['ttft']:.4f} s; "
                  + (f"captures {caps} s; " if caps else "")
                  + f"rebalance {r['rebalance']:.4f} s in all, adopt {r['adopt']:.4f} s in "
                  f"{r['adopts']}; heat max/mean {r['heat']:.4f} per expert, "
                  f"{r['rank_heat']:.4f} per rank; peak {r['peak']:.2f} GiB; {r['wall']:.1f} s; "
                  f"launches {r['launches']}")
        cs = eplb_continuous_run(c, params, reqs, want, admissions)
        wins = "; ".join(f"window to step {st}: heat max/mean {h:.4f} per expert, {i:.4f} per "
                         f"rank" for st, h, i in cs["windows"])
        print(f"EPLB continuous serve, {mode}, captured ({card}): {len(reqs)} requests, "
              f"{cs['steps']} steps, {cs['tok_s']:.1f} output tok/s, itl mean {cs['itl']:.5f} "
              f"s; streams bitwise equal to the serve without EPLB, admissions equal; "
              f"placements {cs['placements']}; {wins}; over the serve {cs['heat']:.4f} per "
              f"expert, {cs['rank_heat']:.4f} per rank; peak {cs['peak']:.2f} GiB; launches "
              f"{cs['launches']}")
    eplb_layer_phase(cfg, params, card)
    print(f"EPLB phase {time.perf_counter() - t0:.1f} s")
    return base


# ---------------------------------------------------------------------------
# elastic EP: rank death, shrink and re-expand, checkpoints, preemption
# ---------------------------------------------------------------------------

# the elastic serves: R = E redundant slots (every expert on two ranks);
# rank ELASTIC_DEAD dies at step ELASTIC_KILL and rejoins at ELASTIC_REJOIN,
# and is declared dead after ELASTIC_MISS silent boundaries. On one card the
# serves start from the redundant placement with no periodic rebalance and
# no floor: a floor of 2 on 7 survivors needs 35 slots, 5 a rank (63 GB of
# experts at 4 layers, beside the 51 GB of 4 a rank), where without it the
# survivors hold 28, still 4 a rank. Four cards take the floor
# (ELASTIC_MIN) and a rebalance every EPLB_EVERY steps
ELASTIC_R, ELASTIC_MIN, ELASTIC_MISS = 16, 2, 2
ELASTIC_KILL, ELASTIC_REJOIN, ELASTIC_DEAD = 20, 44, 2
# the checkpoint cut: one of DBRX's layers at full width (16 experts,
# 8.3 GiB), its disk write sets the size; a kill at CKPT_KILL, declared at
# once, over CKPT_GEN steps
CKPT_LAYERS, CKPT_GEN, CKPT_KILL = 1, 8, 2
CKPT_MAX_LEN = PROMPT + CKPT_GEN + 2


def elastic_injector(n: int, **kw) -> FaultInjector:
    if kw:
        return FaultInjector(n, **kw)
    return FaultInjector(n, kill={ELASTIC_KILL: ELASTIC_DEAD},
                         rejoin={ELASTIC_REJOIN: ELASTIC_DEAD})


def elastic_degraded_steps() -> int:
    """The reference's count for the schedule: a rank killed at step k last
    heartbeats at k - 1 and is declared dead at boundary k + miss - 1; its
    heartbeat at the rejoin step is seen there; every boundary in between
    counts as served degraded."""
    return ELASTIC_REJOIN - (ELASTIC_KILL + ELASTIC_MISS - 1)


def transitions(srv) -> list:
    """Wrap ``srv._recover`` to keep each transition's (table before, table
    after)."""
    out, recover = [], srv._recover

    def rec(i, report):
        before = srv.cfg.moe.placement
        recover(i, report)
        out.append((before, srv.cfg.moe.placement))
    srv._recover = rec
    return out


def check_elastic(srv, trans, where: str, dead=(ELASTIC_DEAD,)) -> None:
    """The recoveries of a kill at ELASTIC_KILL and a rejoin at
    ELASTIC_REJOIN: a shrink at the boundary after the kill's, an expand,
    nothing lost or restored, the dead rows all EMPTY, the degraded steps
    the schedule's, three distinct tables, at most two cached steps."""
    ev = srv.recoveries
    check([e["kind"] for e in ev] == ["shrink", "expand"], f"{where}: recoveries "
          f"{[(e['kind'], e['step']) for e in ev]}")
    check(ev[0]["step"] == ELASTIC_KILL + ELASTIC_MISS - 1 and ev[0]["died"] == list(dead)
          and ev[1]["step"] == ELASTIC_REJOIN and ev[1]["rejoined"] == list(dead),
          f"{where}: the shrink or expand at the wrong step: {ev}")
    check(all(e["lost_experts"] == [] and e["restored_from"] is None for e in ev)
          and srv._ckpt_restores == 0, f"{where}: a recovery lost experts or restored")
    deg = trans[0][1]
    check(deg.dead_ranks() == tuple(dead)
          and all(e == PL.EMPTY for r in dead for e in deg.slot_expert[r]),
          f"{where}: the degraded table gives the dead ranks slots: {deg.slot_expert}")
    check(srv._degraded_steps == elastic_degraded_steps(),
          f"{where}: {srv._degraded_steps} degraded steps, the schedule's "
          f"{elastic_degraded_steps()}")
    fps = {p.fingerprint() for p in (trans[0][0], trans[0][1], trans[1][1])}
    check(len(fps) == 3, f"{where}: the transitions' fingerprints repeat")
    check(len(srv._step_cache) <= 2, f"{where}: {len(srv._step_cache)} cached steps")
    check(srv._detector.alive == tuple(range(srv._detector.num_ranks)),
          f"{where}: alive {srv._detector.alive} at the end")


def elastic_itls(itls, ev, every: int) -> tuple[float, float, list]:
    """(the degraded steps' ITL mean, the healthy steps', the ITL of the
    step after each transition), the steps after a swap (every ``every``
    steps; 0: none) or a transition (they warm up and capture a step)
    apart."""
    swaps = ({i for i in range(len(itls)) if (i + 1) % every == 0} if every else set()) \
        | {e["step"] for e in ev}
    after = {i + 1 for i in swaps}
    lo, hi = ev[0]["step"] + 1, ev[1]["step"]
    deg = [t for i, t in enumerate(itls) if lo <= i <= hi and i not in after]
    ok = [t for i, t in enumerate(itls) if not lo <= i <= hi and i not in after]
    return (float(np.mean(deg)), float(np.mean(ok)),
            [float(itls[e["step"] + 1]) for e in ev if e["step"] + 1 < len(itls)])


def elastic_cfg(cfg, params):
    """``cfg`` physical from the redundant placement, and ``params`` (logical)
    adopted into it in place."""
    pl = PL.redundant_placement(cfg.moe.num_experts, RANKS, ELASTIC_R)
    c = eplb_cfg(cfg, True)
    adopt_expert_params(params, tf_mod.lm_spec(c), None, pl)
    return dataclasses.replace(c, moe=dataclasses.replace(c.moe, placement=pl))


def elastic_fixed_run(cfg, params, card: str, mode: str, want: np.ndarray) -> dict:
    """DecodeServer over 8 hosted ranks, physical from the redundant
    placement, the fault schedule, captured or eager. Leaves ``params``
    logical."""
    tr = Tracer()
    cfg = elastic_cfg(cfg, params)
    srv = DecodeServer(cfg, BATCH, EPLB_MAX_LEN, ep_size=RANKS, params=params,
                       num_redundant_experts=ELASTIC_R, fault_injector=elastic_injector(RANKS),
                       miss_threshold=ELASTIC_MISS, tracer=tr)
    made = []
    if mode == "eager":
        srv._compiled_step = srv._step_factory
        srv._serve_step = srv._step_factory()
    else:
        compiled = srv._compiled_step

        def record_step():
            step = compiled()
            made.append((srv.cfg.moe.placement, step))
            return step
        srv._compiled_step = record_step
        made.append((cfg.moe.placement, srv._serve_step))
    trans = transitions(srv)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    m = srv.serve(serve_prompts(cfg.vocab), EPLB_GEN)
    wall = time.perf_counter() - t0
    launches = counts()
    check(np.array_equal(srv.last_tokens, want), f"the elastic serve ({mode}) differs "
          f"from the serve without EPLB: first at (row, step) "
          f"{np.argwhere(srv.last_tokens != want)[:1].tolist()}")
    check_elastic(srv, trans, f"the elastic fixed serve ({mode})")
    check(m.degraded_steps == elastic_degraded_steps() and m.recovery_count == 2
          and m.checkpoint_restores == 0 and m.alive_ranks == list(range(RANKS))
          and not m.preempted, f"the elastic serve's metrics {m.as_dict()}")
    if mode == "eager":
        steps = PROMPT + EPLB_GEN
    else:
        ran = [st for _, st in made if st.graph is not None]
        steps = 2 * len(ran)
        check(len(made) == 1 + len(srv.placements) and len(made) - len(ran) <= 1,
              f"{len(ran)} captured of {len(made)} compiled steps for "
              f"{len(srv.placements)} adoptions")
    check_ep_counts(launches, cfg, steps, f"the elastic {mode} serve")
    caps = {pl: st.capture_s for pl, st in made}
    deg, ok, after = elastic_itls(srv.last_itls, srv.recoveries, 0)
    summ = tr.summary()
    out = dict(tokens=srv.last_tokens, deg_itl=deg, itl=ok, after=after, wall=wall,
               events=[(e["kind"], e["step"], e["phases"].get("repack_s", 0.0),
                        e["phases"].get("adopt_s", 0.0), caps.get(after_pl))
                       for e, (_, after_pl) in zip(srv.recoveries, trans)],
               fps=[p.fingerprint() for p in (trans[0][0], trans[0][1], trans[1][1])],
               spans={k: summ[k]["count"] for k in ("fault_poll", "recover:shrink",
                                                    "recover:expand", "recover:repack",
                                                    "recover:adopt", "placement_swap")
                      if k in summ},
               slots=trans[0][1].slots_per_rank, latency=m.recovery_latency_s,
               peak=torch.cuda.max_memory_allocated() / 2**30, launches=launches)
    srv.close()
    to_logical(params, srv.cfg)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def elastic_continuous_run(cfg, params, reqs, want: dict, admissions) -> dict:
    """ContinuousDecodeServer, captured, physical from the redundant
    placement, the fault schedule: streams and admissions equal to the
    serve without EPLB, the page tables clean. Leaves ``params`` logical."""
    cfg = elastic_cfg(cfg, params)
    srv = ContinuousDecodeServer(cfg, BATCH, CMAX_LEN, ep_size=RANKS, params=params,
                                 page_size=PAGE, num_redundant_experts=ELASTIC_R,
                                 fault_injector=elastic_injector(RANKS),
                                 miss_threshold=ELASTIC_MISS)
    trans = transitions(srv)
    torch.cuda.reset_peak_memory_stats()
    m = srv.serve_requests(reqs)
    toks = served_tokens(cfg, srv, m, reqs)
    check(all(np.array_equal(t, want[r.rid]) for r, t in zip(reqs, toks)),
          "the elastic continuous serve's streams differ from the serve without EPLB")
    check(list(srv.reqsched.admissions) == list(admissions),
          "the elastic continuous serve admitted otherwise than the serve without EPLB")
    sched = srv.reqsched
    check(bool(np.all(sched._tbl == sched.alloc.pad_page)) and not sched._active.any(),
          "the elastic continuous serve left page-table rows or active slots")
    check_elastic(srv, trans, "the elastic continuous serve")
    out = dict(steps=m.serve_steps, itl=m.itl_mean_s, tok_s=m.output_tok_s,
               degraded=m.degraded_steps, latency=m.recovery_latency_s,
               events=[(e["kind"], e["step"]) for e in srv.recoveries],
               peak=torch.cuda.max_memory_allocated() / 2**30)
    srv.close()
    to_logical(params, srv.cfg)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tree_bytes(tree) -> int:
    return sum(t.nbytes for t in leaves(tree))


def ckpt_phase(card: str) -> None:
    """Checkpoints and preemption on CKPT_LAYERS of DBRX at full width, the
    identity placement (no replica), fresh weights from seed 0: (a) a kill
    without ``ckpt_dir`` warns DegradedRecovery and raises; (b) with step
    0's checkpoint the kill restores (rebound to the degraded table) and
    the tokens equal the uninterrupted serve's; (c) SIGTERM before a
    pipelined serve drains, checkpoints and returns preempted at the first
    boundary, and that checkpoint restores bitwise."""
    t0 = time.perf_counter()
    full = full_config("decode_32k")
    base_cfg = eplb_cfg(dataclasses.replace(full, num_layers=CKPT_LAYERS), True)
    pl = PL.identity_placement(base_cfg.moe.num_experts, RANKS)
    cfg = dataclasses.replace(base_cfg, moe=dataclasses.replace(base_cfg.moe, placement=pl))
    params = init_params(cfg, 0, DEV)
    nbytes = tree_bytes(params)
    work = _build.BUILD_DIR.parent
    work.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(work).free
    check(free > 3 * nbytes, f"{free / 2**30:.1f} GiB free under build/: the checkpoints "
          f"need {3 * nbytes / 2**30:.1f} GiB")
    prompts = serve_prompts(cfg.vocab)
    srv = DecodeServer(cfg, BATCH, CKPT_MAX_LEN, ep_size=RANKS, params=params)
    srv.serve(prompts, CKPT_GEN)
    base = srv.last_tokens
    srv.close()
    # (a) no replica, no checkpoint: warned, raised
    srv = DecodeServer(cfg, BATCH, CKPT_MAX_LEN, ep_size=RANKS, params=params,
                       fault_injector=FaultInjector(RANKS, kill={CKPT_KILL: ELASTIC_DEAD}),
                       miss_threshold=1)
    raised = ""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        try:
            srv.serve(prompts, CKPT_GEN)
        except RuntimeError as e:          # the raise this check expects
            raised = str(e)
    srv.close()
    warned = [str(w.message) for w in got if issubclass(w.category, DegradedRecovery)]
    check("unrecoverable" in raised and any("lost every replica" in w for w in warned),
          f"the no-replica kill without a checkpoint: raised {raised!r}, warned {warned}")
    check(srv.recoveries[-1]["lost_experts"] == [2 * ELASTIC_DEAD, 2 * ELASTIC_DEAD + 1],
          f"lost experts {srv.recoveries[-1]['lost_experts']}")
    del srv
    d = pathlib.Path(tempfile.mkdtemp(prefix="ckpt_", dir=work))
    try:
        # (b) the same kill, restored from step 0's checkpoint
        t = time.perf_counter()
        save_checkpoint(d, 0, params, placement=pl)
        write_s = time.perf_counter() - t
        srv = DecodeServer(cfg, BATCH, CKPT_MAX_LEN, ep_size=RANKS, params=params,
                           fault_injector=FaultInjector(RANKS, kill={CKPT_KILL: ELASTIC_DEAD}),
                           miss_threshold=1, ckpt_dir=str(d))
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            srv.serve(prompts, CKPT_GEN)
        warned = [str(w.message) for w in got if issubclass(w.category, DegradedRecovery)]
        ev = srv.recoveries[0]
        check(any("restoring from checkpoint step 0" in w for w in warned)
              and ev["restored_from"] == 0 and srv._ckpt_restores == 1,
              f"the restore: warned {warned}, event {ev}")
        check(np.array_equal(srv.last_tokens, base), "the restored serve's tokens differ "
              f"from the uninterrupted serve: first at (row, step) "
              f"{np.argwhere(srv.last_tokens != base)[:1].tolist()}")
        deg = srv.cfg.moe.placement
        read_s = ev["phases"]["restore_s"]
        restored_bytes = tree_bytes(srv.params)
        srv.close()
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(d)
        d.mkdir()
        # (c) SIGTERM before a pipelined serve
        srv = DecodeServer(cfg, BATCH, CKPT_MAX_LEN, ep_size=RANKS, params=params,
                           pipeline_depth=2, ckpt_dir=str(d))
        signal.raise_signal(signal.SIGTERM)
        t = time.perf_counter()
        m = srv.serve(prompts, CKPT_GEN)
        serve_s = time.perf_counter() - t
        srv.close()
        step = latest_step(d)
        check(m.preempted and srv.last_tokens.shape[1] == 2 and step == 1,
              f"the preemption: preempted {m.preempted}, tokens {srv.last_tokens.shape}, "
              f"checkpoint step {step}")
        check(np.array_equal(srv.last_tokens, base[:, :2]),
              "the preempted serve's tokens differ from the uninterrupted serve's")
        t = time.perf_counter()
        restored, idx = restore_checkpoint(d, step, tf_mod.lm_spec(cfg), placement=pl,
                                           device=DEV)
        torch.cuda.synchronize()
        read2_s = time.perf_counter() - t
        same = all(torch.equal(a, b) for a, b in zip(leaves(srv.params), leaves(restored)))
        check(same and idx["expert_layout"]["fingerprint"] == pl.fingerprint()
              and idx["extra"]["preempted"], "the preemption's checkpoint does not restore "
              "the server's params bitwise under the placement's fingerprint")
        del restored, srv
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    gb = nbytes / 1e9
    print(f"elastic checkpoints ({card}): DBRX-132B at full width, {CKPT_LAYERS} of "
          f"{full.num_layers} layers (the checkpoint's disk write sets the cut), "
          f"{base_cfg.moe.num_experts} experts over {RANKS} ranks, identity placement, "
          f"{nbytes / 2**30:.2f} GiB of weights, {BATCH} x ({PROMPT} + {CKPT_GEN}); "
          f"{free / 2**30:.1f} GiB free under build/ before the writes; (a) a kill of rank "
          f"{ELASTIC_DEAD} at step {CKPT_KILL} without ckpt_dir warned DegradedRecovery and "
          f"raised RuntimeError; (b) with step 0's checkpoint (written in {write_s:.2f} s, "
          f"{gb / write_s:.3f} GB/s) the kill restored it rebound to the degraded table "
          f"({deg.slots_per_rank} slots a rank, {restored_bytes / 2**30:.2f} GiB; read and "
          f"rebound in {read_s:.2f} s, {gb / read_s:.3f} GB/s, warm page cache) and the "
          f"tokens equal the uninterrupted serve's; (c) SIGTERM before a pipeline_depth=2 "
          f"serve: preempted at the first boundary, its checkpoint written within the "
          f"serve's {serve_s:.2f} s, restored to the card in {read2_s:.2f} s "
          f"({gb / read2_s:.3f} GB/s, warm) bitwise equal, its fingerprint the "
          f"placement's; {time.perf_counter() - t0:.1f} s")


def elastic_phase(cfg, params, card: str, reqs, want: dict, admissions,
                  base: np.ndarray) -> None:
    """Elastic EP through both servers on one card (LocalComm(8)): the fixed
    batch captured and eager and the continuous serve under the fault
    schedule, then the checkpoint cut. ``base`` is eplb_phase's serve
    without EPLB. Leaves ``params`` logical."""
    t0 = time.perf_counter()
    runs = {m: elastic_fixed_run(cfg, params, card, m, base) for m in ("captured", "eager")}
    check(runs["captured"]["fps"] == runs["eager"]["fps"],
          "elastic: captured and eager adopted other tables")
    for m, r in runs.items():
        ev = "; ".join(f"{k} at step {st}: repack {rp:.4f} s, adopt {ad:.4f} s"
                       + (f", recapture {cp:.4f} s" if cp is not None else "")
                       for k, st, rp, ad, cp in r["events"])
        after = ", ".join(f"{x:.5f}" for x in r["after"])
        print(f"elastic fixed serve, {m} ({card}): {BATCH} x ({PROMPT} + {EPLB_GEN}), "
              f"physical from the redundant placement ({ELASTIC_R} redundant slots), no "
              f"periodic rebalance ({r['slots']} slots a rank degraded), rank {ELASTIC_DEAD} killed "
              f"at step {ELASTIC_KILL} and rejoined at {ELASTIC_REJOIN} (miss threshold "
              f"{ELASTIC_MISS}); tokens bitwise equal to the serve without EPLB; {ev}; "
              f"{elastic_degraded_steps()} degraded steps, itl mean {r['deg_itl']:.5f} s "
              f"degraded against {r['itl']:.5f} s healthy, the step after each transition "
              f"{after} s; recovery {r['latency']:.4f} s in all; fingerprints {r['fps']}; "
              f"spans {r['spans']}; peak {r['peak']:.2f} GiB; {r['wall']:.1f} s; launches "
              f"{r['launches']}")
    cs = elastic_continuous_run(cfg, params, reqs, want, admissions)
    print(f"elastic continuous serve, captured ({card}): {len(reqs)} requests, "
          f"{cs['steps']} steps, {cs['tok_s']:.1f} output tok/s, itl mean {cs['itl']:.5f} s; "
          f"recoveries {cs['events']}, {cs['degraded']} degraded steps, recovery "
          f"{cs['latency']:.4f} s; streams bitwise equal to the serve without EPLB, "
          f"admissions equal, page tables clean; peak {cs['peak']:.2f} GiB")
    ckpt_phase(card)
    print(f"elastic phase {time.perf_counter() - t0:.1f} s")


# the dist phase's continuous serve: DIST_REQUESTS requests of
# make_requests (the continuous phase's generator and seed) over BATCH
# slots, DIST_SOLO of them served again alone
DIST_REQUESTS, DIST_SOLO = 64, 2
# a DistComm prefill forward's loss against LocalComm(EP extent)'s on one
# card, relative: the dense products of a process see its rows, LocalComm's
# the whole batch, and cuBLAS picks its kernel by the row count
PF_LOSS_REL = 1e-3
# the hierarchical dist prefill's mesh (four processes): two pods of two
DIST_HIER_AXES = (("pod", 2), ("data", 2))


def dist_continuous_serve(cfg, params, comm, dev, reqs) -> tuple:
    """ContinuousDecodeServer.serve_requests of ``reqs`` over ``comm`` (a
    DistComm, a LocalComm or None: dense) on its compiled step, every
    launch counter read (``served_tokens`` checks the serve). Returns the
    server, its metrics, the launches and each request's tokens by id."""
    srv = ContinuousDecodeServer(cfg, BATCH, CMAX_LEN, comm=comm, params=params,
                                 device=dev, page_size=PAGE)
    reset_counts()
    m = srv.serve_requests(reqs)
    launches = {k: n for k, n in counts().items() if n}
    toks = served_tokens(cfg, srv, m, reqs)
    return srv, m, launches, {r.rid: t for r, t in zip(reqs, toks)}


def dist_mid_stream(reqs, admissions, steps: int, n: int) -> list:
    """n requests admitted after step 0 whose last token came before the
    serve's last step, spread over them. A request admitted at step s
    emits its last token at step s + prompt + new - 2, so the picks follow
    from the admission log alone, the same in every process."""
    at = {rid: step for step, rid, _ in admissions}
    picks = [r for r in reqs if at[r.rid] > 0
             and at[r.rid] + r.prompt.size + r.max_new_tokens - 2 < steps - 1]
    return [picks[len(picks) * (i + 1) // (2 * n)] for i in range(n)]


def continuous_step0_feed(reqs, table: tuple) -> dict:
    """The scheduler's step-0 inputs over the global batch for a pool of
    ``table`` = (page-table width, pages)."""
    max_pages, num_pages = table
    sched = ContinuousScheduler(reqs, BATCH, max_pages, PageAllocator(num_pages, PAGE))
    return sched.advance(0, now=0.0)


def continuous_step0_logits(cfg, params, comm, dev, reqs, table: tuple) -> torch.Tensor:
    """The f32 logits [B, V] of the continuous serve's first step: the
    scheduler's step-0 inputs, this process's rows of them, through one
    paged step on fresh pools of ``table``, gathered over the batch (every
    process of a DistComm takes part)."""
    num_pages = table[1]
    rows = comm.batch_rows(BATCH) if comm is not None else slice(0, BATCH)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(dev)
             for k, v in continuous_step0_feed(reqs, table).items()}
    state = init_paged_decode_state(cfg, num_pages, PAGE, dev)
    logits, _ = lm_paged_decode_step(params, state, batch, cfg, comm)
    out = logits[:, -1, :cfg.vocab].float()
    return comm.gather_batch(out) if comm is not None else out


def blocked_step0_logits(cfg, params, ep: int, dev, reqs, table: tuple,
                         blocks: int) -> torch.Tensor:
    """The continuous serve's first-step logits [B, V] computed as a
    ``DistComm`` mesh of ``blocks`` batch ranks computes them, on one card:
    for each batch rank b, one paged step over ``LocalComm(ep)`` fed only
    rank b's rows of the step-0 inputs (``comm.batch_rows``' contiguous
    block), on fresh pools of ``table``; the blocks concatenated. Every
    dense product of the attention, the dense layers, the shared expert and
    the head then runs at a process's row count, where the whole-batch
    reference (``continuous_step0_logits`` over ``LocalComm``) runs them
    over all BATCH rows; the function is the same (bitwise on the CPU in
    f32, ``tests/test_torch_blocked_reference.py``)."""
    feed = continuous_step0_feed(reqs, table)
    b = BATCH // blocks
    outs = []
    for i in range(blocks):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[i * b:(i + 1) * b])).to(dev)
                 for k, v in feed.items()}
        state = init_paged_decode_state(cfg, table[1], PAGE, dev)
        logits, _ = lm_paged_decode_step(params, state, batch, cfg, LocalComm(ep))
        outs.append(logits[:, -1, :cfg.vocab].float())
        del state
    return torch.cat(outs)


class ProductShapes(TorchDispatchMode):
    """Counts the dense products (``mm``, ``addmm``, ``bmm``, ``baddbmm``)
    a call runs, by (op, left operand's shape, right operand's shape,
    dtype): which products see how many rows. The hand-written kernels
    (B3's grouped GEMM among them) are not aten ops and do not appear."""

    OPS = {"mm": (0, 1), "addmm": (1, 2), "bmm": (0, 1), "baddbmm": (1, 2)}

    def __init__(self):
        super().__init__()
        self.seen: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.OPS:
            a, b = (args[i] for i in self.OPS[name])
            self.seen[(name, tuple(a.shape), tuple(b.shape), str(a.dtype))] += 1
        return func(*args, **(kwargs or {}))

    def rows(self, dtype: str | None = None) -> dict:
        """{rows of the left operand (all but its last dim): products}."""
        out: Counter = Counter()
        for (_, a, _, dt), n in self.seen.items():
            if dtype is None or dt == dtype:
                out[int(np.prod(a[:-1]))] += n
        return dict(sorted(out.items()))

    def of(self, dtype: str) -> Counter:
        return Counter({k: n for k, n in self.seen.items() if k[3] == dtype})


def product_line(shapes: dict) -> str:
    """Each call's products by dtype and row count."""
    return "; ".join(f"{label}: " + ", ".join(
        f"{dt.replace('torch.', '')} " + " ".join(f"{r} rows x{n}" for r, n in ps.rows(dt).items())
        for dt in sorted({k[3] for k in ps.seen})) for label, ps in shapes.items())


def live_shares(reqs, admissions, ep: int) -> list[float]:
    """Each batch rank's share of the live row-steps of a continuous serve,
    from its admission log: a request admitted at step s into slot i holds
    its slot, on batch rank i // (BATCH / ep), for prompt + new - 1 steps."""
    per = BATCH // ep
    at = {rid: (step, slot) for step, rid, slot in admissions}
    live = [0] * ep
    for r in reqs:
        live[at[r.rid][1] // per] += r.prompt.size + r.max_new_tokens - 1
    return [n / sum(live) for n in live]


def dist_continuous_phase(cfg, comm, dev, rank: int, n: int = DIST_REQUESTS) -> dict:
    """ContinuousDecodeServer(comm=DistComm) over ``cfg`` (DBRX's or
    DeepSeek-V3's decode_32k preset, full width, cut in depth): n requests
    over BATCH slots of paged KV (page PAGE, the default pool) on
    its compiled step (captured over NCCL, eager over gloo); exact launch
    counts (B6 on every layer, B1 to B4 at EP extent > 1); each batch
    rank's share of the live rows; DIST_SOLO requests that joined and left
    mid-stream served again alone through the same engine, bitwise; the
    per-step token gather timed. Then, on rank 0 alone, the reference on
    this card: the dense-path continuous server at EP extent 1 (the path
    DistComm's extent 1 runs, on the same rows: streams bitwise), else
    LocalComm(EP extent)'s (first-step logits within TOL, the stream
    agreement printed); either way the same admission log."""
    # rank 0 may still be running the last phase's reference: start every
    # process's clock together
    dist.barrier()
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, dev, comm=comm)
    reqs = make_requests(cfg.vocab, n)
    srv, m, launches, toks = dist_continuous_serve(cfg, params, comm, dev, reqs)
    graphed = srv._serve_step.graph is not None
    where = f"the DistComm continuous server over {comm.backend}"
    check(graphed == comm.capturable,
          f"{where} {'did not capture' if comm.capturable else 'captured'} its step")
    # captured: the warm-up and the capture; else every step
    steps = 2 if graphed else m.serve_steps
    if comm.size > 1:
        check_dist_counts(launches, cfg, "nccl_ep", steps * moe_layers(cfg), where)
    check(launches.get(PAGED, 0) == cfg.num_layers * steps,
          f"{PAGED} launched {launches.get(PAGED, 0)} times on {where}, expected "
          f"{cfg.num_layers * steps}")
    admissions, table = list(srv.reqsched.admissions), (srv.max_pages, srv.num_pages)
    md = m.as_dict()
    picks = dist_mid_stream(reqs, admissions, m.serve_steps, DIST_SOLO)
    for r in picks:
        srv.serve_requests([Request(r.rid, r.prompt, r.max_new_tokens)])
        got = srv.reqsched.tokens_for(r.rid)
        check(np.array_equal(got, toks[r.rid]), f"request {r.rid} alone through the "
              f"DistComm engine gives {got}, among co-residents {toks[r.rid]}")
    b = srv.rows.stop - srv.rows.start
    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    gather = (call_ms(lambda: comm.gather_batch(tok), DIST_ITERS),
              queued_ms(lambda: comm.gather_batch(tok), DIST_ITERS)[0])
    srv.close()
    with ProductShapes() as dist_products:
        logits = continuous_step0_logits(cfg, params, comm, dev, reqs, table)
    progress(rank, f"{model_label(cfg)}: its DistComm continuous serve", t)
    out = dict(ep=comm.size, rows=b, graphed=graphed, steps=m.serve_steps,
               tokens=m.total_tokens, tok_s=m.output_tok_s, itl=m.itl_mean_s,
               ttft_p50=md["ttft_p50_s"], ttft_p99=md["ttft_p99_s"],
               itl_p50=md["itl_p50_s"], itl_p99=md["itl_p99_s"], pages_peak=m.pages_peak,
               pages_dense=m.pages_dense_equiv, launches=launches, admissions=admissions,
               solo=[(r.rid, r.arrival_step) for r in picks], gather=gather,
               peak_gib=dist_peak(), model=model_label(cfg), requests=n,
               live=live_shares(reqs, admissions, comm.size))
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        progress(rank, f"{model_label(cfg)}: the shard freed ({memory_line()})", t)
        full = init_params(cfg, 0, dev)
        ref_comm = None if comm.size == 1 else LocalComm(comm.size)
        rsrv, rm, _, want = dist_continuous_serve(cfg, full, ref_comm, dev, reqs)
        same = list(rsrv.reqsched.admissions) == admissions
        rsrv.close()
        del rsrv
        # the whole-batch reference stays on the record; the check holds the
        # serve to the reference whose dense products see a process's rows
        with ProductShapes() as whole_products:
            whole_logits = continuous_step0_logits(cfg, full, ref_comm, dev, reqs, table)
        blocks = BATCH // b
        if comm.size == 1:          # one process steps the whole batch
            want_logits, blocked_products = whole_logits, whole_products
        else:
            with ProductShapes() as blocked_products:
                want_logits = blocked_step0_logits(cfg, full, comm.size, dev, reqs, table,
                                                   blocks)
        whole_err = float((logits - whole_logits).abs().max() / whole_logits.abs().max())
        err = float((logits - want_logits).abs().max() / want_logits.abs().max())
        live = continuous_step0_feed(reqs, table)["active"]
        bf16 = str(torch.bfloat16)
        rows_equal = blocked_products.of(bf16) == Counter(
            {k: n * (1 if comm.size == 1 else blocks) for k, n in dist_products.of(bf16).items()})
        progress(rank, f"{model_label(cfg)}: the reference continuous serve (admissions "
                 f"{'equal' if same else 'differ'}; against the whole-batch "
                 f"LocalComm({comm.size}) step: {logit_errors(logits, whole_logits, live)}; "
                 f"against {blocks} blocks of {b} rows over LocalComm({comm.size}): "
                 f"{logit_errors(logits, want_logits, live)}; {memory_line()})", t)
        out["products"] = product_line({
            "a DistComm process's step": dist_products,
            f"LocalComm({comm.size}) over the whole batch": whole_products,
            f"LocalComm({comm.size}) over {blocks} blocks": blocked_products})
        print(f"dist rank 0: {model_label(cfg)} continuous step 0, products by rows: "
              f"{out['products']}; the bf16 products of the blocked reference "
              f"{'are' if rows_equal else 'are not'} those of {blocks} processes' steps",
              file=sys.stderr, flush=True)
        check(same, "the DistComm continuous server's admissions differ from the one-card "
              "server's")
        check(rows_equal, "the blocked reference runs a bf16 product at another shape than "
              f"a DistComm process: {out['products']}")
        agree = np.asarray([np.array_equal(toks[r.rid], want[r.rid]) for r in reqs])
        out.update(ref_itl=rm.itl_mean_s, logits_err=err, whole_err=whole_err,
                   whole_line=logit_errors(logits, whole_logits, live),
                   blocked_line=logit_errors(logits, want_logits, live),
                   agree=float(agree.mean()), bitwise=bool(agree.all()))
        if comm.size == 1:
            check(bool(agree.all()), "the DistComm continuous server's streams differ from "
                  f"the dense-path server's: {agree.mean():.4f} equal")
        check(err <= TOL, f"the DistComm continuous server's first-step logits are "
              f"{err:.3g} off LocalComm({comm.size})'s over {blocks} blocks of {b} rows "
              f"(the process's row count)")
        del full
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    out["seconds"] = time.perf_counter() - t
    return out


def dist_prefill_run(cfg, params, comm, dev, path: str, chunks: int = 1,
                     rows: int = PF_BATCH) -> dict:
    """The prefill forward of this process's rows of the seeded batch of
    rows x PF_SEQ tokens (the prefill phase's tokens) over ``comm`` (a
    DistComm, or the LocalComm hosting its mesh), every launch counter read
    (the EP counts exact for ``path``, the MoE and MTP layers and the hosted
    ranks, flash attention once per GQA layer and never under MLA), then a
    timed repeat whose loss must be bitwise equal. Returns the loss, wall,
    tokens per second, peak memory, plan host time and dropped shares."""
    tokens = np.random.default_rng(10).integers(0, cfg.vocab, (rows, PF_SEQ))
    mine = comm.batch_rows(rows)
    batch = {"tokens": torch.from_numpy(tokens[mine].astype(np.int32)).to(dev)}
    forward = get_model(cfg).forward
    probes: list = []
    reset_counts()
    with handle_probe(probes):
        loss, aux = forward(params, batch, cfg, comm)
        torch.cuda.synchronize()
    launches = {k: n for k, n in counts().items() if n}
    label = f"the {path} prefill over {type(comm).__name__}({comm.size})"
    check(bool(torch.isfinite(loss)), f"{label}: loss {loss.item()} is not finite")
    check_dist_counts(launches, cfg, path, forward_moe_layers(cfg) * len(comm.ranks), label,
                      chunks)
    check(launches.get(FLASH, 0) == flash_layers(cfg) and PAGED not in launches,
          f"{label}: {launches.get(FLASH, 0)} flash and {launches.get(PAGED, 0)} paged "
          f"attention launches, expected {flash_layers(cfg)} and 0")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss2, _ = forward(params, batch, cfg, comm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(torch.equal(loss, loss2), f"{label}: a repeat gave loss {loss2.item()}, the "
          f"first {loss.item()}")
    n = batch["tokens"].numel()
    return dict(loss=loss.item(), aux=aux["aux"].item(), wall=wall, tok_s=n / wall,
                total_tok_s=rows * PF_SEQ / wall, peak_gib=dist_peak(), batch=rows,
                plan_s=sum(dt for _, dt in probes), dropped=[round(d, 6) for d, _ in probes],
                launches=launches, rows=tuple(batch["tokens"].shape))


def dist_hier_config(cfg, chunks: int):
    """The train_4k preset on the hierarchical path with ``chunks`` chunks."""
    h = hier_config(cfg)
    return dataclasses.replace(h, moe=dataclasses.replace(h.moe, ht_num_chunks=chunks))


def dist_prefill_phase(cfg, comm, hcomm, dev, rank: int, rows: int = PF_BATCH) -> dict | None:
    """The train_4k prefill forward of ``cfg`` (full width, cut in depth;
    PF_BATCH x PF_SEQ global, fp8 dispatch, capacity 1.25) with one EP rank
    per process: HT flat at EP extent = the world, and over ``hcomm`` (a
    DistComm of DIST_HIER_AXES, or None) the hierarchical path at 1 and 2
    chunks, 2 bitwise equal to 1; each run's loss finite, bitwise on a
    repeat, its EP launches exact. Then, on rank 0 alone,
    LocalComm's loss of each run on this card (the same mesh hosted in one
    process): within PF_LOSS_REL. None at EP extent 1, where the MoE layers
    take the dense path and no HT runs."""
    if comm.size == 1:
        return None
    dist.barrier()
    t = time.perf_counter()
    runs = {}
    plans = [("flat", cfg, comm, "nccl_ep", 1)]
    if hcomm is not None:
        plans += [(f"hierarchical, {nc} chunk{'s' if nc > 1 else ''}",
                   dist_hier_config(cfg, nc), hcomm, "hier", nc) for nc in (1, 2)]
    for name, c, cm, path, nc in plans:
        torch.cuda.reset_peak_memory_stats()
        params = init_params(c, 0, dev, comm=cm)
        weights = sum(t.nbytes for t in leaves(params)) / 2**30
        runs[name] = dict(dist_prefill_run(c, params, cm, dev, path, nc, rows),
                          ep=cm.size, axes=cm.axes, model=model_label(c), mtp=c.mtp,
                          weights_gib=weights)
        progress(rank, f"{model_label(c)}: the DistComm {name} forward", t)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if hcomm is not None:
        one, two = runs["hierarchical, 1 chunk"], runs["hierarchical, 2 chunks"]
        check(one["loss"] == two["loss"] and one["aux"] == two["aux"],
              f"the hierarchical prefill's loss at 2 chunks, {two['loss']!r}, differs from "
              f"1 chunk's, {one['loss']!r} (dropped shares {two['dropped']})")
    if rank == 0:
        progress(rank, f"{model_label(cfg)}: the shards freed ({memory_line()})", t)
        full = init_params(cfg, 0, dev)
        for name, c, cm, path, nc in plans:
            ref_comm = LocalComm(cm.size, axes=cm.axes)
            want = dist_prefill_run(c, full, ref_comm, dev, path, nc, rows)
            r = runs[name]
            r["ref_loss"], r["ref_wall"] = want["loss"], want["wall"]
            r["loss_err"] = abs(r["loss"] - want["loss"]) / abs(want["loss"])
            check(r["loss_err"] <= PF_LOSS_REL, f"the DistComm {name} prefill's loss "
                  f"{r['loss']!r} is {r['loss_err']:.3g} off LocalComm({cm.size})'s "
                  f"{want['loss']!r}")
            progress(rank, f"{model_label(c)}: the LocalComm {name} forward", t)
            gc.collect()
            torch.cuda.empty_cache()
        del full
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return dict(runs=runs, seconds=time.perf_counter() - t)


# ---------------------------------------------------------------------------
# training with one EP rank per process
# ---------------------------------------------------------------------------

# the check: DBRX-132B train_4k at full width, 1 layer, one row of 2048
# tokens a process, one micro-batch, one step, against the same step over
# LocalComm(EP extent) on card 0 (the loss within PF_LOSS_REL). The grad
# norm's limit: it sums 1.1e10 squares in another order, of gradients whose
# bf16 products ran at other row counts
DT_CHECK_LAYERS, DT_CHECK_SEQ, DT_NORM_REL = 1, 2048, 1e-2
# the four-card run: the preset's seq 4096, a global batch of 16 in 2
# micro-batches (2 rows a card each), 4 steps on the repeated batch, 4
# layers unless the peak reckoned from a 1-layer step passes DT_MAX_GIB
# (then 3). A layer's state on a card is 6 times its parameters: the
# parameters, their f32 sums (2), the bf16 moments (2) and one
# micro-batch's bf16 gradients
DT_SEQ, DT_BATCH, DT_MICRO, DT_STEPS, DT_LAYERS, DT_MAX_GIB = 4096, 16, 2, 4, 4, 72.0
DT_STATE_PER_PARAM = 6


def dist_train_config(layers: int, micro: int):
    return dataclasses.replace(full_config("train_4k"), num_layers=layers, microbatch=micro)


def dist_trainer(cfg, comm, dev, steps: int, batch: int, seq: int) -> Trainer:
    """A Trainer of ``cfg`` over ``comm`` with bf16 AdamW moments, logging
    every step."""
    return Trainer(cfg, TrainerConfig(steps=steps, global_batch=batch, seq_len=seq,
                                      log_every=1), comm=comm,
                   opt_cfg=AdamWConfig(lr=TRAIN_LR, total_steps=steps, warmup_steps=1,
                                       state_dtype=torch.bfloat16), device=dev)


def replicated_equal(params, cfg, comm) -> int:
    """Every leaf this process holds whole, bit for bit against rank 0's
    (broadcast as bytes over the mesh, one leaf at a time); returns the
    number of leaves compared."""
    n = 0
    for name, t in zip(leaf_names(params), leaves(params)):
        if is_cut(tuple(name.split("/")), cfg, comm):
            continue
        mine = t.contiguous().view(-1).view(torch.uint8)
        theirs = mine.clone()
        dist.broadcast(theirs, src=0)
        check(torch.equal(mine, theirs), f"the replicated leaf {name} differs from rank 0's")
        n += 1
    return n


def pair_peaks(dev, peak: float, world: int) -> tuple[float, float]:
    """The sums over the processes of each one's peak allocated and peak
    reserved device memory (GiB): the card's when they share it."""
    t = torch.tensor([peak, torch.cuda.max_memory_reserved() / 2**30], dtype=torch.float64,
                     device=dev)
    dist.all_reduce(t)
    return float(t[0]), float(t[1])


# the layouts the four-card checks train beside HT flat: name -> (the
# train_4k preset's MoE options, launch path; the hierarchical one runs over
# DIST_HIER_AXES). The baseline never quantizes, so its fp8 flag is off
DT_LAYOUTS = {
    "hierarchical HT": (dict(ep_axis=tuple(a for a, _ in DIST_HIER_AXES), ht_hierarchical=True,
                             ht_num_chunks=HIER_CHUNKS), "hier"),
    "deepep": (dict(ep_mode="ll", ll_layout="deepep"), "deepep_fp8"),
    "baseline": (dict(ep_mode="baseline", quantize_dispatch=False), "baseline"),
}


def dist_layout(cfg, layout: str | None) -> tuple:
    """(``cfg`` with the MoE options of DT_LAYOUTS[layout], its launch
    path); None: ``cfg`` as it is, HT flat."""
    if layout is None:
        return cfg, "nccl_ep"
    moe, path = DT_LAYOUTS[layout]
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)), path


def dist_train_check(comm, dev, rank: int, world: int, layout: str | None = None) -> dict:
    """One train step over ``comm`` held against the same step over
    ``LocalComm`` on the same mesh: DBRX-132B train_4k at full width (in
    the ``layout`` of DT_LAYOUTS, or HT flat), DT_CHECK_LAYERS layer,
    one row of DT_CHECK_SEQ tokens a process, one micro-batch. Rank 0
    first runs the step over LocalComm(EP extent) on its card while the
    others wait, and frees it; then every process steps its shard
    (``init_params(..., comm=)``) and its row through ``run_trainer``: the
    loss within PF_LOSS_REL of LocalComm's, the gradient norm within
    DT_NORM_REL, every replicated leaf bitwise equal on every process after
    the step, the launches exact for one hosted rank (``train_launches``),
    no plain version reached."""
    t = time.perf_counter()
    cfg, path = dist_layout(dist_train_config(DT_CHECK_LAYERS, 1), layout)
    out = dict(ep=comm.size, batch=world, model=model_label(cfg), layout=layout or "HT flat",
               axes=comm.axes)
    dist.barrier()
    if rank == 0:
        tr = dist_trainer(cfg, LocalComm(comm.size, axes=comm.axes), dev, 1, world, DT_CHECK_SEQ)
        params, opt = tr.init_state()
        r = run_trainer(tr, params, opt, tr.data.batch_at(0))
        check_train_launches(r["launches"], train_launches(cfg, comm.size, path),
                             f"the LocalComm({comm.size}) {out['layout']} check step")
        out.update(ref_loss=r["losses"][0], ref_gnorm=r["gnorms"][0], ref_step_s=r["step_s"][0],
                   ref_peak=r["peak"])
        del tr, params, opt, r
        gc.collect()
        torch.cuda.empty_cache()
        progress(rank, f"the LocalComm({comm.size}) train step ({memory_line()})", t)
    dist.barrier()
    tr = dist_trainer(cfg, comm, dev, 1, world, DT_CHECK_SEQ)
    params, opt = tr.init_state()
    weights = tree_bytes(params) / 2**30
    torch.cuda.reset_peak_memory_stats()
    r = run_trainer(tr, params, opt, tr.data.batch_at(0))
    check_train_launches(r["launches"], train_launches(cfg, 1, path),
                         f"the DistComm {out['layout']} check step")
    loss, gnorm = r["losses"][0], r["gnorms"][0]
    check(bool(np.isfinite(loss) and np.isfinite(gnorm)), f"the DistComm check step: loss "
          f"{loss}, grad norm {gnorm}")
    out.update(loss=loss, gnorm=gnorm, step_s=r["step_s"][0], opt_s=r["opt_s"][0],
               reduce_s=r["reduce_s"][0], reduce_bytes=r["reduce_bytes"][0],
               launches=r["launches"][0], peak=r["peak"], weights_gib=weights)
    out["pair_peak"] = pair_peaks(dev, r["peak"], world)
    params = r["params"]
    del opt, r, tr
    gc.collect()
    out["replicated"] = replicated_equal(params, cfg, comm)
    if rank == 0:
        out["loss_err"] = abs(loss - out["ref_loss"]) / abs(out["ref_loss"])
        out["gnorm_err"] = abs(gnorm - out["ref_gnorm"]) / abs(out["ref_gnorm"])
        check(out["loss_err"] <= PF_LOSS_REL, f"the DistComm check step's loss {loss!r} is "
              f"{out['loss_err']:.3g} off LocalComm({comm.size})'s {out['ref_loss']!r}")
        check(out["gnorm_err"] <= DT_NORM_REL, f"the DistComm check step's grad norm "
              f"{gnorm!r} is {out['gnorm_err']:.3g} off LocalComm({comm.size})'s "
              f"{out['ref_gnorm']!r}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["seconds"] = time.perf_counter() - t
    return out


def dist_train_full(comm, dev, rank: int, world: int, layout: str | None = None) -> dict:
    """DBRX-132B train_4k at full width with one EP rank a card (in the
    ``layout`` of DT_LAYOUTS, or HT flat): the preset's seq DT_SEQ, global
    batch DT_BATCH in DT_MICRO micro-batches, DT_STEPS steps of the Trainer
    on the repeated batch, DT_LAYERS layers unless the peak that a 1-layer
    step measures, plus the reckoned state of each further layer, passes
    DT_MAX_GIB on some card (then one fewer). The losses finite and
    falling, each step's launches exact for one hosted rank, no plain
    version reached; then one micro-batch traced on rank 0."""
    t = time.perf_counter()
    probe, path = dist_layout(dist_train_config(1, DT_MICRO), layout)
    tr = dist_trainer(probe, comm, dev, 1, DT_BATCH, DT_SEQ)
    params, opt = tr.init_state()
    layer_gib = DT_STATE_PER_PARAM * tree_bytes(params["moe_stack"]) / 2**30
    r = run_trainer(tr, params, opt, tr.data.batch_at(0))
    probe_peak = r["peak"]
    del tr, params, opt, r
    gc.collect()
    torch.cuda.empty_cache()
    reckoned = probe_peak + (DT_LAYERS - 1) * layer_gib
    worst = comm.control_max([int(reckoned * 1024)])[0] / 1024
    layers = DT_LAYERS if worst <= DT_MAX_GIB else DT_LAYERS - 1
    progress(rank, f"the 1-layer probe step (peak {probe_peak:.2f} GiB; {DT_LAYERS} layers "
             f"reckoned at {reckoned:.2f}, at most {worst:.2f} on a card): {layers} layers", t)
    cfg, _ = dist_layout(dist_train_config(layers, DT_MICRO), layout)
    tr = dist_trainer(cfg, comm, dev, DT_STEPS, DT_BATCH, DT_SEQ)
    params, opt = tr.init_state()
    weights = tree_bytes(params) / 2**30
    batch = tr.data.batch_at(0)
    r = run_trainer(tr, params, opt, batch)
    losses = r["losses"]
    check(len(losses) == DT_STEPS and all(np.isfinite(losses)), f"four-card losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall over {DT_STEPS} steps on a "
          f"repeated batch: {losses}")
    want = train_launches(cfg, 1, path)
    check_train_launches(r["launches"], want, "four-card train step")
    out = dict(layers=layers, probe_peak=probe_peak, reckoned=reckoned, worst=worst,
               weights_gib=weights, model=model_label(cfg), ep=comm.size,
               experts=cfg.moe.num_experts // comm.size, layout=layout or "HT flat",
               axes=comm.axes,
               **{k: r[k] for k in ("losses", "gnorms", "step_s", "opt_s", "reduce_s",
                                    "reduce_bytes", "peak")}, launches=r["launches"][0],
               want=want)
    params = r["params"]
    del opt, r, tr
    gc.collect()
    torch.cuda.empty_cache()
    rows = comm.batch_rows(DT_BATCH // DT_MICRO)
    out["trace"] = train_trace(cfg, params, {k: v[:, rows] for k, v in batch.items()}, comm,
                               traced=rank == 0)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    return out


# DeepSeek-V3-671B train_4k at one EP rank a card (EP 4 over data, 64 experts
# a card; HT flat, fp8 dispatch, capacities 1.25, remat), bf16 moments: a
# global batch of DS_TRAIN_BATCH x DT_SEQ in DS_TRAIN_MICRO micro-batches
# (one row a card in each), DS_TRAIN_STEPS steps of the Trainer on the
# repeated batch. MTP off: its MoE layer would add about 37 GB of state a
# card (the MTP gradient is held on the CPU). Depth: one MoE layer
# (first_k_dense 0: 4.905 B parameters a card, 54.8 GiB of state) probed
# with one step, then one dense layer before it (first_k_dense 1: 5.488 B,
# 61.3 GiB) if the probe's peak reserved by the allocator (its allocated
# peak and the free blocks it could not reuse) plus the dense layer's
# reckoned state stays within DT_MAX_GIB on every card. With the allocated
# peak instead (61.67 + 6.52 = 68.19 GiB) the dense layer was taken and the
# third step ran out of memory with 65.31 GiB allocated and 10.08 GiB held
# in blocks none of which fit a 2 GiB score tile (H100 80GB HBM3, 700 W)
DS_TRAIN_BATCH, DS_TRAIN_MICRO, DS_TRAIN_STEPS = 8, 2, 3


def ds_train_config(dense: int):
    """(the train_4k preset, its cut: ``dense`` dense layers and one MoE
    layer, MTP off, DS_TRAIN_MICRO micro-batches)."""
    full = ds_full_config("train_4k")
    return full, dataclasses.replace(full, num_layers=dense + 1, mtp=False,
                                     microbatch=DS_TRAIN_MICRO,
                                     moe=dataclasses.replace(full.moe, first_k_dense=dense))


def ds_train_full(comm, dev, rank: int, world: int) -> dict:
    """The Trainer on DeepSeek-V3-671B train_4k at full width with one EP
    rank a card (``ds_train_config``; the depth by a one-step probe of
    the reserved peak): the
    losses finite and falling, the gradient norms finite, every replicated
    leaf bitwise equal on every process after the steps, each step's
    launches exact for one hosted rank (``train_launches``: B1 in fp8
    mode, B2, B3, ``grouped_gemm_dw``, B4 and its backward; MLA launches
    none), ``MlaChunked``'s calls exact (``mla_train_calls``), no plain
    version reached; then the backward's GEMMs at the step's shapes
    (``ds_train_kernels``) and one micro-batch traced on rank 0."""
    t = time.perf_counter()
    full, probe = ds_train_config(0)
    tr = dist_trainer(probe, comm, dev, 1, DS_TRAIN_BATCH, DT_SEQ)
    params, opt = tr.init_state()
    gc.collect()
    torch.cuda.empty_cache()             # the init's one-layer expert draw
    r = run_trainer(tr, params, opt, tr.data.batch_at(0))
    probe_peak, probe_reserved, probe_s = r["peak"], r["peak_reserved"], r["step_s"][0]
    del tr, params, opt, r
    gc.collect()
    torch.cuda.empty_cache()
    spec = tf_mod.lm_spec(ds_train_config(1)[1])["dense_stack"]
    dense_gib = DT_STATE_PER_PARAM * 2 * sum(int(np.prod(s_.shape)) for s_ in leaves(spec)) / 2**30
    reckoned = probe_reserved + dense_gib
    worst = comm.control_max([int(reckoned * 1024)])[0] / 1024
    dense = 1 if worst <= DT_MAX_GIB else 0
    progress(rank, f"DeepSeek-V3's 1-layer probe step (peak {probe_peak:.2f} GiB allocated, "
             f"{probe_reserved:.2f} reserved; with a dense layer reckoned at {reckoned:.2f}, at "
             f"most {worst:.2f} on a card): first_k_dense {dense}", t)
    _, cfg = ds_train_config(dense)
    tr = dist_trainer(cfg, comm, dev, DS_TRAIN_STEPS, DS_TRAIN_BATCH, DT_SEQ)
    params, opt = tr.init_state()
    gc.collect()
    torch.cuda.empty_cache()
    weights = tree_bytes(params) / 2**30
    params_card = sum(t_.numel() for t_ in leaves(params)) / 1e9
    batch = tr.data.batch_at(0)
    r = run_trainer(tr, params, opt, batch)
    losses = r["losses"]
    check(len(losses) == DS_TRAIN_STEPS and all(np.isfinite(losses))
          and all(np.isfinite(r["gnorms"])), f"DeepSeek-V3 four-card losses {losses}, grad "
          f"norms {r['gnorms']}")
    check(losses[-1] < losses[0], f"the DeepSeek-V3 loss did not fall over {DS_TRAIN_STEPS} "
          f"steps on a repeated batch: {losses}")
    want = train_launches(cfg, 1, "nccl_ep")
    check_train_launches(r["launches"], want, "DeepSeek-V3 four-card train step")
    rows = DS_TRAIN_BATCH // DS_TRAIN_MICRO // world
    want_mla = mla_train_calls(cfg, rows)
    check(all(c == want_mla for c in r["mla"]), f"DeepSeek-V3 train steps called MlaChunked "
          f"{r['mla']} times (forwards, backwards), expected {want_mla} a step")
    out = dict(dense=dense, probe_peak=probe_peak, probe_reserved=probe_reserved,
               probe_s=probe_s, reckoned=reckoned,
               worst=worst, weights_gib=weights, params_card=params_card,
               layers=cfg.num_layers, full_layers=full.num_layers, ep=comm.size,
               experts=cfg.moe.num_experts // comm.size, axes=comm.axes, rows=rows,
               **{k: r[k] for k in ("losses", "gnorms", "step_s", "opt_s", "reduce_s",
                                    "reduce_bytes", "peak", "peak_reserved")},
               launches=r["launches"][0], mla=r["mla"][0])
    params = r["params"]
    del opt, r, tr
    gc.collect()
    torch.cuda.empty_cache()
    out["replicated"] = replicated_equal(params, cfg, comm)
    with torch.no_grad():
        ds_train_kernels(cfg, params, comm, dev, rank)
    sl = comm.batch_rows(DS_TRAIN_BATCH // DS_TRAIN_MICRO)
    out["trace"] = train_trace(cfg, params, {k: v[:, sl] for k, v in batch.items()}, comm,
                               traced=rank == 0)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    return out


def ds_train_kernels(cfg, params, comm, dev, rank: int) -> None:
    """The training backward's GEMMs at the four-card step's shapes: every
    process dispatches one row of DT_SEQ tokens (seeded by its rank)
    through MoE layer 0's router over ``comm``, so each card holds its 64
    experts' rows at the step's capacity; rank 0 then runs
    ``grouped_gemm_dw`` at the gate and down projections (``dw_case``) and
    B3 as dX on the Wᵀ copy (``dx_case``), each against its plain version
    and timed beside ``torch.bmm`` and its bound, while the others wait."""
    p = _index(params["moe_stack"]["moe"], 0)
    d, dt, F_ = cfg.d_model, cfg.dtype, cfg.moe.d_ff_expert
    group = ep_group(cfg, comm, DT_SEQ)
    gen = torch.Generator(device=dev).manual_seed(71 + rank)
    x = torch.randn((DT_SEQ, d), generator=gen, device=dev).to(dt)
    r = route(x.float() @ p["router"], router_config(cfg.moe), p.get("sel_bias"))
    hs = ep_create_handle(group, [r.topk_idx], [r.topk_weights])
    (y3d, counts_), = ep_complete(group, hs, ep_dispatch(group, hs, [x], send_only=True))
    dist.barrier()
    if rank == 0:
        L, A = y3d.shape[:2]
        print(f"DeepSeek-V3 backward GEMMs at the four-card step's shapes (rank 0, {L} experts, "
              f"capacity {A} rows, {int(counts_.clamp(max=A).sum())} live):")
        for label, x_, w in (("gate", y3d, p["w_gate"]), ("down", None, p["w_down"])):
            if x_ is None:
                x_ = torch.randn((L, A, F_), generator=gen, device=dev).to(dt)
            dy = (torch.randn((L, A, w.shape[2]), generator=gen, device=dev) * 0.1).to(dt)
            dw_case(f"DeepSeek-V3 {label}", x_, dy, counts_)
            dx_case(f"DeepSeek-V3 {label} dX (B3 on dY, Wᵀ)", dy, w, counts_)
            del dy, x_
    del y3d, hs
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()


def ds_train_line(f: dict, who: str, label: str, card: str) -> None:
    """The DeepSeek-V3 four-card Trainer's lines (``ds_train_full``)."""
    micro = [(s_ - o - rd) / DS_TRAIN_MICRO for s_, o, rd in zip(f["step_s"], f["opt_s"],
                                                                f["reduce_s"])]
    med = float(np.median(f["step_s"]))
    tok = DS_TRAIN_BATCH * DT_SEQ
    print(f"dist ({label}) Trainer(comm=DistComm), {who}, DeepSeek-V3-671B train_4k at full "
          f"width, EP extent {f['ep']} over {f['axes']} ({f['experts']} experts a card), HT "
          f"flat, fp8 dispatch, capacity 1.25, remat, MLA through MlaChunked ({card}); cut "
          f"(reduced): num_layers {f['full_layers']} -> {f['layers']} (first_k_dense 3 -> "
          f"{f['dense']}), mtp on -> off, the mesh {f['ep']} cards one EP rank each, the "
          f"batch {DS_TRAIN_BATCH} x {DT_SEQ} global in {DS_TRAIN_MICRO} micro-batches "
          f"({f['rows']} row a card each; the preset's microbatch 8): losses "
          f"{[round(x, 6) for x in f['losses']]} over {DS_TRAIN_STEPS} steps on a repeated "
          f"batch (falling); grad norms {[round(g_, 4) for g_ in f['gnorms']]} (finite); "
          f"{f['replicated']} replicated leaves bitwise equal on every process; step "
          f"{[round(x, 4) for x in f['step_s']]} s, per micro-batch (forward + backward, the "
          f"norm) {[round(x, 4) for x in micro]} s, gradient reduce "
          f"{[round(x, 4) for x in f['reduce_s']]} s of {f['reduce_bytes'][0] / 2**30:.3f} "
          f"GiB, optimizer {[round(x, 4) for x in f['opt_s']]} s; {tok / med:.1f} train tok/s "
          f"over the mesh, {tok / med / f['ep']:.1f} a card (median step); "
          f"{f['params_card']:.3f} B parameters a card, weights {f['weights_gib']:.2f} GiB, "
          f"peak {f['peak']:.2f} GiB a card ({f['peak_reserved']:.2f} reserved; the "
          f"1-MoE-layer probe {f['probe_peak']:.2f}, {f['probe_reserved']:.2f} reserved, its "
          f"step {f['probe_s']:.3f} s; with a dense layer reckoned at {f['reckoned']:.2f} "
          f"reserved, at most {f['worst']:.2f} on a card, limit {DT_MAX_GIB}); launches per step "
          f"{f['launches']} = train_launches for one hosted rank; MlaChunked calls a step "
          f"{f['mla']} (forwards, backwards) = mla_train_calls; no plain version reached; "
          f"{f['seconds']:.1f} s")
    if f["trace"]:
        print(f"dist ({label}) Trainer(comm=DistComm), {who}, DeepSeek-V3 ({card}): "
              f"{f['trace']['line']}")


def dist_train_phase(out: dict, comm, hcomm, dev, rank: int, world: int, backend: str,
                     t0: float) -> None:
    """The training sub-phases of one rank, into ``out``: at EP extent > 1
    the HT flat check (``dist_train_check``); at world DS_DIST_WORLD over
    NCCL then the four-card Trainer in HT flat (``dist_train_full``), and,
    every tensor of the flat runs freed, the check in each of DT_LAYOUTS
    (the hierarchical one over ``hcomm``, a DistComm of DIST_HIER_AXES),
    the four-card Trainer on the hierarchical path and, DBRX freed,
    DeepSeek-V3's four-card Trainer (``ds_train_full``)."""
    if comm.size == 1:
        return
    out["train"] = dist_train_check(comm, dev, rank, world)
    progress(rank, "DBRX's train step check", t0)
    if world != DS_DIST_WORLD or backend != "nccl":
        return
    out["train_full"] = dist_train_full(comm, dev, rank, world)
    progress(rank, "DBRX's four-card Trainer", t0)
    out["train_layouts"] = {}
    for name in DT_LAYOUTS:
        gc.collect()
        torch.cuda.empty_cache()
        cm = hcomm if name == "hierarchical HT" else comm
        out["train_layouts"][name] = dist_train_check(cm, dev, rank, world, name)
        progress(rank, f"DBRX's {name} train step check", t0)
    gc.collect()
    torch.cuda.empty_cache()
    out["train_hier_full"] = dist_train_full(hcomm, dev, rank, world, "hierarchical HT")
    progress(rank, "DBRX's four-card hierarchical Trainer", t0)
    gc.collect()
    torch.cuda.empty_cache()
    out["train_ds"] = ds_train_full(comm, dev, rank, world)
    progress(rank, "DeepSeek-V3's four-card Trainer", t0)


def dist_train_lines(out: dict, who: str, label: str, card: str, gloo: bool) -> None:
    """The training sub-phases' lines of one rank."""
    c = out.get("train")
    if c is None:
        print(f"dist ({label}) training, {who}: not run, EP extent 1 takes the dense MoE "
              "path, so no EP dispatch or combine trains")
        return
    for c in [c] + list(out.get("train_layouts", {}).values()):
        dist_check_line(c, who, label, card, gloo)
    f = out.get("train_full")
    if f is None:
        return
    dist_full_line(f, who, label, card)
    h = out.get("train_hier_full")
    if h is not None:
        dist_full_line(h, who, label, card)
        ratio = float(np.median(h["step_s"])) / float(np.median(f["step_s"]))
        print(f"dist ({label}) Trainer(comm=DistComm), {who} ({card}): hierarchical / flat "
              f"median step {ratio:.3f} ({h['layers']} and {f['layers']} layers; one NVLink "
              f"node, where the reference expects flat to win)")
    d = out.get("train_ds")
    if d is not None:
        ds_train_line(d, who, label, card)


def dist_check_line(c: dict, who: str, label: str, card: str, gloo: bool) -> None:
    """One train step check's line (``dist_train_check``)."""
    ref = ""
    if "ref_loss" in c:
        ref = (f"; LocalComm({c['ep']}) on card 0: loss {c['ref_loss']:.6f}, grad norm "
               f"{c['ref_gnorm']:.6f}, step {c['ref_step_s']:.3f} s, peak "
               f"{c['ref_peak']:.2f} GiB; off by {c['loss_err']:.3g} (limit {PF_LOSS_REL}) "
               f"and {c['gnorm_err']:.3g} (limit {DT_NORM_REL})")
    pair = (f"; the processes' peaks sum to {c['pair_peak'][0]:.2f} GiB allocated, "
            f"{c['pair_peak'][1]:.2f} GiB reserved on the shared card" if gloo else "")
    print(f"dist ({label}) train step check, {who}, {c['layout']} over {c['axes']}, EP extent "
          f"{c['ep']}, {c['model']} train_4k, "
          f"{c['batch']} x {DT_CHECK_SEQ} global, one row a process, one micro-batch, bf16 "
          f"moments ({card}): loss {c['loss']:.6f}, grad norm {c['gnorm']:.6f}{ref}; "
          f"{c['replicated']} replicated leaves bitwise equal on every process; step "
          f"{c['step_s']:.3f} s{' (gloo via host)' if gloo else ''}, gradient reduce "
          f"{c['reduce_s']:.3f} s ({c['reduce_bytes'] / 2**30:.3f} GiB), optimizer "
          f"{c['opt_s']:.3f} s; weights {c['weights_gib']:.2f} GiB, peak {c['peak']:.2f} GiB"
          f"{pair}; launches {c['launches']}; {c['seconds']:.1f} s")


def dist_full_line(f: dict, who: str, label: str, card: str) -> None:
    """The four-card Trainer's lines (``dist_train_full``)."""
    micro = [(s_ - o - rd) / DT_MICRO for s_, o, rd in zip(f["step_s"], f["opt_s"],
                                                          f["reduce_s"])]
    med = float(np.median(f["step_s"]))
    print(f"dist ({label}) Trainer(comm=DistComm), {who}, {f['model']} train_4k at full "
          f"width, EP extent {f['ep']} ({f['experts']} experts a card), {f['layout']} over "
          f"{f['axes']}, fp8 dispatch, capacity 1.25, remat, {DT_BATCH} x {DT_SEQ} global in "
          f"{DT_MICRO} micro-batches ({DT_BATCH // DT_MICRO // f['ep']} rows a card each), bf16 "
          f"moments ({card}): losses {[round(x, 6) for x in f['losses']]} over {DT_STEPS} steps "
          f"on a repeated batch (falling); grad norms {[round(g, 4) for g in f['gnorms']]}; step "
          f"{[round(x, 4) for x in f['step_s']]} s, per micro-batch (forward + backward, the "
          f"norm) {[round(x, 4) for x in micro]} s, gradient reduce "
          f"{[round(x, 4) for x in f['reduce_s']]} s of {f['reduce_bytes'][0] / 2**30:.3f} "
          f"GiB, optimizer {[round(x, 4) for x in f['opt_s']]} s; "
          f"{DT_BATCH * DT_SEQ / med:.1f} train tok/s over the mesh, "
          f"{DT_BATCH * DT_SEQ / med / f['ep']:.1f} a card (median step); weights "
          f"{f['weights_gib']:.2f} GiB, peak {f['peak']:.2f} GiB a card (the 1-layer probe "
          f"{f['probe_peak']:.2f}; {DT_LAYERS} layers reckoned at {f['reckoned']:.2f}, at most "
          f"{f['worst']:.2f} on a card, limit {DT_MAX_GIB}); launches per step "
          f"{f['launches']} = train_launches for one hosted rank; {f['seconds']:.1f} s")
    if f["trace"]:
        print(f"dist ({label}) Trainer(comm=DistComm), {who}, {f['layout']} ({card}): "
              f"{f['trace']['line']}")


# DeepSeek-V3 at one EP rank a card: the world it runs at; its continuous
# serve's requests (make_requests' arrivals of RATE a step and lives of 11 to
# 63 steps keep about 150 live, so every batch rank steps live rows); the
# deep serve's MoE layers after the 3 dense ones (5.64 GB of experts a card
# each, as a deployment's card holds them): 63.59 GiB of weights a card and
# a peak of 70.65 GiB, when the 7.5 GB of one layer's stacked expert leaf is
# drawn, of an H100's 79.18 (8 MoE layers: 59.27 GiB)
DS_DIST_WORLD, DS_DIST_REQUESTS, DS_DEEP_MOE_LAYERS = 4, 256, 10


def ds_deep_config():
    _, cfg = ds_config()
    return dataclasses.replace(cfg, num_layers=cfg.moe.first_k_dense + DS_DEEP_MOE_LAYERS)


def ds_deep_serve_phase(comm, dev, rank: int) -> dict:
    """DeepSeek-V3's fixed-batch serve at ds_deep_config()'s depth over
    DistComm, no one-card reference fitting: captured and eager, tokens
    bitwise equal, exact EP launches in each."""
    cfg = ds_deep_config()
    dist.barrier()
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, dev, comm=comm)
    weights = sum(x.nbytes for x in leaves(params)) / 2**30
    progress(rank, f"{model_label(cfg)}: the shard drawn, {weights:.2f} GiB "
             f"({memory_line()})", t)
    runs = {}
    for mode in ("compiled", "eager"):
        toks, m, launches, graphed = dist_serve(cfg, params, comm, dev, mode)
        check(graphed == (mode == "compiled" and comm.capturable),
              f"the deep DistComm serve ({mode}) captured {graphed}")
        steps = 2 if graphed else PROMPT + GEN
        check_dist_counts(launches, cfg, "nccl_ep", steps * moe_layers(cfg),
                          f"the deep DistComm serve ({mode})")
        runs[mode] = dict(toks=toks, itl=m.itl_mean_s, p99=m.itl_p99_s, ttft=m.ttft_s,
                          tok_s=m.output_tok_s, launches=launches)
        progress(rank, f"{model_label(cfg)}: its {mode} DistComm serve ({memory_line()})", t)
    check(np.array_equal(runs["compiled"]["toks"], runs["eager"]["toks"]),
          f"the deep DistComm serve's captured tokens differ from eager: "
          f"{float((runs['compiled']['toks'] == runs['eager']['toks']).mean()):.4f} equal")
    out = dict(model=model_label(cfg), ep=comm.size, weights_gib=weights, peak_gib=dist_peak(),
               rows=comm.batch_rows(BATCH).stop - comm.batch_rows(BATCH).start,
               runs={k: {a: b for a, b in v.items() if a != "toks"} for k, v in runs.items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["seconds"] = time.perf_counter() - t
    return out


def ds_dist_phase(comm, dev, rank: int, who: str, label: str, card: str) -> dict:
    """DeepSeek-V3 at one EP rank a card (EP extent DS_DIST_WORLD): the
    fixed-batch serve at DS_LAYERS held to LocalComm's on card 0; the
    train_4k forward with MTP at the one-card cut, one row a card, within
    PF_LOSS_REL of LocalComm's; the deep fixed-batch serve, captured =
    eager; last, the continuous serve of DS_DIST_REQUESTS requests at
    DS_LAYERS held to LocalComm's (every batch rank's share of its live
    rows above 0). Each sub-phase's line is printed as it ends."""
    out = {}
    _, cfg = ds_config()
    t0 = time.perf_counter()
    out["serve"] = dist_serve_phase(cfg, comm, dev, rank, comm.size)
    serve_line(out["serve"], who, label, card, False)
    progress(rank, "DeepSeek-V3's fixed-batch serve", t0)
    gc.collect()
    torch.cuda.empty_cache()
    out["prefill"] = dist_prefill_phase(ds_prefill_config()[1], comm, None, dev, rank,
                                        DS_PF_BATCH)
    prefill_lines(out["prefill"], who, label, card)
    progress(rank, "DeepSeek-V3's prefill forward", t0)
    out["deep"] = ds_deep_serve_phase(comm, dev, rank)
    deep_line(out["deep"], who, label, card)
    progress(rank, "DeepSeek-V3's deep serve", t0)
    out["continuous"] = cs = dist_continuous_phase(cfg, comm, dev, rank, DS_DIST_REQUESTS)
    continuous_line(cs, who, label, card, False)
    check(all(x > 0 for x in cs["live"]), f"DeepSeek-V3's continuous serve over "
          f"{comm.size} ranks left a batch rank idle: live shares {cs['live']}")
    progress(rank, "DeepSeek-V3's continuous serve", t0)
    return out


# redundant slots of the four-card EPLB serve: DBRX's 16 experts + 4 = 20
# slots, 5 a card
DIST_EPLB_R = 4
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def dist_eplb_phase(cfg, comm, dev, rank: int) -> dict:
    """DBRX with the EPLB hook at one EP rank a card over NCCL, physical
    mode, rebalance every EPLB_EVERY steps, DIST_EPLB_R redundant slots,
    BATCH x (PROMPT + EPLB_GEN), captured: tokens bitwise equal to the same
    DistComm serve without EPLB; every rank's placement fingerprints equal
    (all-gathered); each card's migrated expert rows bitwise equal to its
    slots of rank 0's LocalComm adoption of the last table (its leaves
    broadcast one at a time); the first-step logits under that table and
    those rows within TOL of LocalComm's on card 0. Each swap's migration
    time and bytes are kept."""
    dist.barrier()
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    c = eplb_cfg(cfg, True)
    prompts = serve_prompts(cfg.vocab)
    params = init_params(c, 0, dev, comm=comm)
    srv = DecodeServer(c, BATCH, EPLB_MAX_LEN, comm=comm, params=params, device=dev)
    srv.serve(prompts, EPLB_GEN)
    base, base_itl = srv.last_tokens, float(np.mean(srv.last_itls))
    srv.close()
    del srv
    srv = DecodeServer(c, BATCH, EPLB_MAX_LEN, comm=comm, params=params, device=dev,
                       rebalance_every=EPLB_EVERY, num_redundant_experts=DIST_EPLB_R)
    reset_counts()
    m = srv.serve(prompts, EPLB_GEN)
    launches = {k: n for k, n in counts().items() if n}
    check(np.array_equal(srv.last_tokens, base), "the DistComm EPLB serve's tokens differ "
          f"from the serve without EPLB: first at (row, step) "
          f"{np.argwhere(srv.last_tokens != base)[:1].tolist()}")
    pls = list(srv.placements)
    check(len(pls) >= 1, "the DistComm EPLB serve adopted no placement")
    fps = torch.tensor([p.fingerprint() for p in pls], dtype=torch.int64, device=dev)
    every = comm.all_gather([fps])[0]
    check(bool((every == fps).all()), f"the ranks adopted other placements: {every.tolist()}")
    # the table adopted after the last step has a step that never ran
    check(any(st.graph is not None for st in srv._step_cache.values())
          or not comm.capturable, "the DistComm EPLB server did not capture its step")
    logits = step0_logits(srv.cfg, srv.params, comm, dev)
    pl, pcfg = srv.cfg.moe.placement, srv.cfg
    rows = {k: srv.params["moe_stack"]["moe"][k] for k in EXPERT_KEYS}
    out = dict(ep=comm.size, itl=m.itl_mean_s, base_itl=base_itl, ttft=m.ttft_s, base=base,
               placements=[(p.version, p.fingerprint()) for p in pls],
               migrations=srv.migrations, heat=m.heat_max_mean, rank_heat=m.rank_heat_max_mean,
               launches=launches, slots=pl.slots_per_rank, model=model_label(cfg))
    srv.close()
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    same, full = rows_equal_local(cfg, pl, rows, comm, dev, rank)
    check(same, f"rank {rank}'s migrated expert rows differ from its slots of the "
          "LocalComm adoption")
    out["rows_equal"] = same
    if rank == 0:
        want = step0_logits(pcfg, full, LocalComm(comm.size), dev)
        err = float((logits - want).abs().max() / want.abs().max())
        out["logits_line"] = logit_errors(logits, want)
        check(err <= TOL, f"the DistComm EPLB serve's first-step logits under the last "
              f"table are {err:.3g} off LocalComm({comm.size})'s")
        del full
    del params, rows
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["peak_gib"], out["seconds"] = dist_peak(), time.perf_counter() - t
    return out


def rows_equal_local(cfg, pl, rows: dict, comm, dev, rank: int) -> tuple:
    """Each card's expert rows against its slots of rank 0's LocalComm
    adoption of ``pl`` (the full logical tree drawn from seed 0, each leaf
    broadcast in turn). Returns (equal, rank 0's adopted tree or None)."""
    full = None
    if rank == 0:
        full = init_params(cfg, 0, dev)
        adopt_expert_params(full, tf_mod.lm_spec(cfg), None, pl)
    me, S = comm.ranks[0], pl.slots_per_rank
    same = True
    for k in EXPERT_KEYS:
        shape = (rows[k].shape[0], pl.num_slots) + tuple(rows[k].shape[2:])
        buf = (full["moe_stack"]["moe"][k] if rank == 0 else
               torch.empty(shape, dtype=rows[k].dtype, device=dev))
        dist.broadcast(buf, src=0)
        same &= torch.equal(rows[k], buf[:, me * S:(me + 1) * S])
        del buf
    return same, full


# the four-card elastic serves: R = E, 8 slots a card, the floor of 2; the
# whole-pod kill's pods of two cards; SIGTERM in DIST_SIGTERM_RANK at its
# decode step DIST_SIGTERM_STEP; control all-reduces timed
DIST_ELASTIC_R, DIST_POD = 16, 2
DIST_SIGTERM_RANK, DIST_SIGTERM_STEP, CONTROL_CALLS = 1, 10, 200


def dist_elastic_serve(c, comm, dev, base: np.ndarray, where: str, **kw) -> tuple:
    """One DistComm serve with the EPLB hook, the floor and a fault
    schedule; its tokens must equal ``base``. Returns (server, metrics)."""
    params = init_params(c, 0, dev, comm=comm)
    srv = DecodeServer(c, BATCH, EPLB_MAX_LEN, comm=comm, params=params, device=dev,
                       rebalance_every=EPLB_EVERY, num_redundant_experts=DIST_ELASTIC_R,
                       min_replicas=ELASTIC_MIN, miss_threshold=ELASTIC_MISS, **kw)
    trans = transitions(srv)
    m = srv.serve(serve_prompts(c.vocab), EPLB_GEN)
    check(np.array_equal(srv.last_tokens, base), f"{where}: tokens differ from the serve "
          f"without EPLB: first at (row, step) "
          f"{np.argwhere(srv.last_tokens != base)[:1].tolist()}")
    mine = dict(events=[{k: v for k, v in e.items() if k not in ("latency_s", "phases")}
                        for e in srv.recoveries],
                alive=list(srv._detector.alive),
                fps=[p.fingerprint() for p in srv.placements])
    every = [None] * comm.size
    dist.all_gather_object(every, mine)
    check(all(e == mine for e in every), f"{where}: the ranks' recovery events, alive sets "
          f"or fingerprints differ")
    return srv, m, trans


def dist_elastic_phase(cfg, comm, dev, rank: int, base: np.ndarray) -> dict:
    """DBRX's elastic serves at one EP rank a card over NCCL (physical,
    rebalance every EPLB_EVERY, DIST_ELASTIC_R redundant slots, the floor
    of 2, captured), each against ``base``, dist_eplb_phase's serve without
    EPLB: rank ELASTIC_DEAD killed and rejoined (no byte to it in the
    shrink, the rows after the rejoin bitwise equal to the LocalComm
    adoption), a whole pod killed and rejoined, SIGTERM in one rank."""
    dist.barrier()
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    c = eplb_cfg(cfg, True)
    out = dict(ep=comm.size, model=model_label(cfg))
    # the control all-reduce's time a call
    comm.control_max([0] * (1 + comm.size))
    t0 = time.perf_counter()
    for _ in range(CONTROL_CALLS):
        comm.control_max([0] * (1 + comm.size))
    out["control_ms"] = (time.perf_counter() - t0) / CONTROL_CALLS * 1e3
    # one rank killed and rejoined
    srv, m, trans = dist_elastic_serve(c, comm, dev, base, "the four-card elastic serve",
                                       fault_injector=elastic_injector(comm.size))
    check_elastic(srv, trans, f"the four-card elastic serve (rank {rank})")
    moves = [mv for mv in srv.migrations if mv["kind"] in ("shrink", "expand")]
    got = [None] * comm.size
    dist.all_gather_object(got, [mv["bytes_received"] for mv in moves])
    check(got[ELASTIC_DEAD][0] == 0, f"the shrink moved {got[ELASTIC_DEAD][0]} bytes to "
          f"card {ELASTIC_DEAD}")
    out["dead_received"] = got[ELASTIC_DEAD]
    out["moves"] = [(mv["kind"], mv["step"], mv["bytes_sent"], mv["bytes_received"],
                     mv["seconds"]) for mv in srv.migrations]
    deg, ok, after = elastic_itls(srv.last_itls, srv.recoveries, EPLB_EVERY)
    out.update(deg_itl=deg, itl=ok, after=after, slots=trans[0][1].slots_per_rank,
               latency=m.recovery_latency_s, degraded=m.degraded_steps,
               events=[(e["kind"], e["step"]) for e in srv.recoveries])
    pl = srv.cfg.moe.placement
    rows = {k: srv.params["moe_stack"]["moe"][k] for k in EXPERT_KEYS}
    srv.close()
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    same, full = rows_equal_local(cfg, pl, rows, comm, dev, rank)
    check(same, f"rank {rank}'s expert rows after the rejoin differ from its slots of the "
          "LocalComm adoption")
    del full, rows
    gc.collect()
    torch.cuda.empty_cache()
    # a whole pod killed and rejoined
    dom = PL.domains_from_geometry(comm.size, DIST_POD)
    pod = dom.domain_of[ELASTIC_DEAD]
    srv, m, trans = dist_elastic_serve(
        c, comm, dev, base, "the four-card whole-pod serve", fault_domains=dom,
        fault_injector=elastic_injector(comm.size, domains=dom,
                                        kill_domains={ELASTIC_KILL: pod},
                                        rejoin_domains={ELASTIC_REJOIN: pod}))
    check_elastic(srv, trans, f"the four-card whole-pod serve (rank {rank})",
                  dead=dom.ranks_in(pod))
    out["pod"] = dict(events=[(e["kind"], e["step"], e["died"] or e["rejoined"])
                              for e in srv.recoveries],
                      slots=trans[0][1].slots_per_rank,
                      deg_itl=elastic_itls(srv.last_itls, srv.recoveries, EPLB_EVERY)[0],
                      latency=m.recovery_latency_s)
    srv.close()
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    # SIGTERM in one rank
    params = init_params(c, 0, dev, comm=comm)
    srv = DecodeServer(c, BATCH, EPLB_MAX_LEN, comm=comm, params=params, device=dev)
    inner, calls = srv.step, []

    def step(tok):
        calls.append(1)
        if rank == DIST_SIGTERM_RANK and len(calls) == PROMPT + DIST_SIGTERM_STEP:
            signal.raise_signal(signal.SIGTERM)
        return inner(tok)
    srv.step = step
    m = srv.serve(serve_prompts(c.vocab), EPLB_GEN)
    srv.close()
    got = [None] * comm.size
    dist.all_gather_object(got, (m.preempted, srv.last_tokens.shape[1], len(calls)))
    n = srv.last_tokens.shape[1]
    check(all(g == got[0] for g in got) and got[0][0] and n < EPLB_GEN + 1,
          f"the ranks stopped apart after SIGTERM in rank {DIST_SIGTERM_RANK}: {got}")
    check(np.array_equal(srv.last_tokens, base[:, :n]),
          "the preempted serve's tokens differ from the serve without EPLB")
    out["sigterm"] = dict(tokens=n, steps=len(calls) - PROMPT)
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["peak_gib"], out["seconds"] = dist_peak(), time.perf_counter() - t
    return out


def elastic_dist_line(e: dict, who: str, label: str, card: str) -> None:
    moves = "; ".join(f"{k} after step {st}: {sent / 2**30:.3f} GiB sent, {got / 2**30:.3f} "
                      f"GiB received, {sec:.3f} s" for k, st, sent, got, sec in e["moves"])
    after = ", ".join(f"{x:.5f}" for x in e["after"])
    p = e["pod"]
    print(f"dist ({label}) elastic DecodeServer(comm=DistComm), {who}, EP extent {e['ep']}, "
          f"{e['model']}, physical, rebalance every {EPLB_EVERY}, {DIST_ELASTIC_R} redundant "
          f"slots, floor {ELASTIC_MIN}, {BATCH} x ({PROMPT} + {EPLB_GEN}), captured ({card}): "
          f"the control all-reduce (gloo, {1 + e['ep']} integers) {e['control_ms']:.4f} ms a "
          f"call; rank {ELASTIC_DEAD} killed at step {ELASTIC_KILL}, rejoined at "
          f"{ELASTIC_REJOIN}: recoveries {e['events']}, tokens bitwise equal to the serve "
          f"without EPLB, every rank's events, alive sets and fingerprints equal, card "
          f"{ELASTIC_DEAD} received {e['dead_received']} bytes in the (shrink, expand), the "
          f"rows after the rejoin bitwise equal to the LocalComm adoption; migrations "
          f"{moves}; {e['degraded']} degraded steps ({e['slots']} slots a card), itl mean "
          f"{e['deg_itl']:.5f} s degraded against {e['itl']:.5f} s healthy, the step after "
          f"each transition {after} s, recovery {e['latency']:.4f} s in all; whole pod "
          f"killed and rejoined: {p['events']}, one shrink, no restore, tokens bitwise "
          f"equal, {p['slots']} slots a card degraded, itl mean {p['deg_itl']:.5f} s "
          f"degraded, recovery {p['latency']:.4f} s; SIGTERM in rank {DIST_SIGTERM_RANK} "
          f"at its decode step {DIST_SIGTERM_STEP}: every rank preempted after "
          f"{e['sigterm']['steps']} steps with {e['sigterm']['tokens']} tokens a row; peak "
          f"{e['peak_gib']:.2f} GiB; {e['seconds']:.1f} s")


def eplb_dist_line(e: dict, who: str, label: str, card: str) -> None:
    moves = "; ".join(f"after step {mv['step']}: {mv['bytes_sent'] / 2**30:.3f} GiB sent, "
                      f"{mv['bytes_local'] / 2**30:.3f} GiB copied on the card, "
                      f"{mv['seconds']:.3f} s" for mv in e["migrations"])
    ref = (f"; first-step logits under the last table against LocalComm({e['ep']}) on "
           f"card 0: {e['logits_line']}" if "logits_line" in e else "")
    print(f"dist ({label}) EPLB DecodeServer(comm=DistComm), {who}, EP extent {e['ep']}, "
          f"{e['model']}, physical, rebalance every {EPLB_EVERY}, {DIST_EPLB_R} redundant slots "
          f"({e['slots']} a card), {BATCH} x ({PROMPT} + {EPLB_GEN}), captured ({card}): tokens "
          f"bitwise equal to the serve without EPLB (its itl {e['base_itl']:.5f} s); every "
          f"rank's placements equal {e['placements']}; migrated expert rows bitwise equal to "
          f"the LocalComm adoption; itl mean {e['itl']:.5f} s, ttft {e['ttft']:.4f} s; "
          f"migrations {moves}; heat max/mean {e['heat']:.4f} per expert, {e['rank_heat']:.4f} "
          f"per rank{ref}; launches {e['launches']}; peak {e['peak_gib']:.2f} GiB; "
          f"{e['seconds']:.1f} s")


def progress(rank: int, what: str, t0: float) -> None:
    """A child's progress line on stderr (a run that times out shows how far
    each rank got)."""
    print(f"dist rank {rank}: {what} done at {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)


def dist_child(rank: int, world: int, init_method: str, backend: str, card: str,
               label: str) -> dict:
    """One rank of a DistComm mesh of ``world`` processes over ``backend``:
    NCCL takes card ``rank``; gloo puts every process on card 0 (CUDA
    tensors staged through the host). The primitives, the EP layer, the
    fixed-batch serve, the continuous serve, the prefill forward (flat,
    and hierarchical over two pods of two when the world is 4), all over
    DBRX; then, at world DS_DIST_WORLD over NCCL, DeepSeek-V3's
    sub-phases. The rank prints its lines as they end, so that a later
    failure loses none."""
    t0 = time.perf_counter()
    # a rank that raises leaves with os._exit: nothing may wait in a buffer
    sys.stdout.reconfigure(line_buffering=True)
    # every thread's stack on stderr shortly before the parent's timeout
    faulthandler.dump_traceback_later(dist_timeout(world) - 60, exit=False)
    axes = (("data", world),)
    tmo = datetime.timedelta(seconds=dist_timeout(world))
    dev = init_process(axes, None if backend == "nccl" else "cuda:0", init_method, rank=rank,
                       world=world, backend=backend, timeout=tmo)
    disable_tf32()
    comm = DistComm(axes, timeout=tmo)
    hcomm = DistComm(DIST_HIER_AXES, timeout=tmo) if world == 4 else None
    lc = LocalComm(world)
    out = dict(rank=rank, device=str(dev), backend=comm.backend)
    t = time.perf_counter()
    out["prims"] = dist_primitives(comm, lc, dev, rank)
    out["prims"]["seconds"] = time.perf_counter() - t
    out["prims"]["peak_gib"] = dist_peak()
    cfg = dist_cfg()
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out["layer"] = dist_layer_phase(cfg, comm, lc, dev, rank)
    out["layer_seconds"], out["layer_peak_gib"] = time.perf_counter() - t, dist_peak()
    progress(rank, "primitives and DBRX's EP layer", t0)
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = dist_serve_phase(cfg, comm, dev, rank, world)
    progress(rank, "DBRX's fixed-batch serve", t0)
    gc.collect()
    torch.cuda.empty_cache()
    out["continuous"] = dist_continuous_phase(cfg, comm, dev, rank)
    progress(rank, "DBRX's continuous serve", t0)
    out["prefill"] = dist_prefill_phase(prefill_config()[1], comm, hcomm, dev, rank)
    progress(rank, "DBRX's prefill forward", t0)
    dist_lines([out], world, card, label)
    if world > 1 and backend == "nccl":
        gc.collect()
        torch.cuda.empty_cache()
        out["eplb"] = dist_eplb_phase(cfg, comm, dev, rank)
        eplb_dist_line(out["eplb"], dist_who(out, world), label, card)
        progress(rank, "DBRX's EPLB serve", t0)
        gc.collect()
        torch.cuda.empty_cache()
        out["elastic"] = dist_elastic_phase(cfg, comm, dev, rank, out["eplb"].pop("base"))
        elastic_dist_line(out["elastic"], dist_who(out, world), label, card)
        progress(rank, "DBRX's elastic serves", t0)
    else:
        print(f"dist ({label}) EPLB and elastic serves, {dist_who(out, world)}: not run (they "
              "run at EP extent > 1 over NCCL, one card a rank)")
    if world == DS_DIST_WORLD and backend == "nccl":
        out["ds"] = ds_dist_phase(comm, dev, rank, dist_who(out, world), label, card)
    # training last, every serving tensor freed first
    gc.collect()
    torch.cuda.empty_cache()
    dist_train_phase(out, comm, hcomm, dev, rank, world, backend, t0)
    dist_train_lines(out, dist_who(out, world), label, card, backend == "gloo")
    faulthandler.cancel_dump_traceback_later()
    out["seconds"] = time.perf_counter() - t0
    return out


def serve_line(sv: dict, who: str, label: str, card: str, gloo: bool) -> None:
    ref = ""
    if "ref_itl" in sv:
        name = "the dense server" if sv["ep"] == 1 else f"LocalComm({sv['ep']})"
        ref = (f"; against {name} on one card (its itl {sv['ref_itl']:.5f} s): tokens "
               f"{'bitwise equal' if sv['bitwise'] else 'not bitwise equal'} ({sv['agree']:.4f} "
               f"of all, {sv['agree_first']:.4f} of the first), first-step logits "
               f"{sv['logits_err']:.3g} off relative to their largest; {sv['rows_line']}")
    print(f"dist ({label}) DecodeServer(comm=DistComm), {who}, EP extent {sv['ep']}, "
          f"{sv['rows']} rows a process, {sv['model']}, {BATCH} x ({PROMPT} + {GEN}), "
          f"{'captured' if sv['graphed'] else 'eager'} ({card}): itl mean {sv['itl']:.5f} s"
          f"{' (gloo via host)' if gloo else ''}, p99 {sv['p99']:.5f} s, ttft "
          f"{sv['ttft']:.4f} s{ref}; launches {sv['launches']}; peak {sv['peak_gib']:.2f} "
          f"GiB; {sv['seconds']:.1f} s")


def continuous_line(cs: dict, who: str, label: str, card: str, gloo: bool) -> None:
    ref = ""
    if "ref_itl" in cs:
        name = "the dense-path server" if cs["ep"] == 1 else f"LocalComm({cs['ep']})"
        ref = (f"; against {name} on one card (its itl {cs['ref_itl']:.5f} s): the same "
               f"admissions, streams {'bitwise equal' if cs['bitwise'] else 'not bitwise equal'}"
               f" ({cs['agree']:.4f} of the requests); first-step logits against its "
               f"step over the process's row blocks (the check, limit {TOL}): "
               f"{cs['blocked_line']}; against its step over the whole batch (on the "
               f"record): {cs['whole_line']}; products by rows: {cs['products']}")
    solo = ", ".join(f"{rid} (arrived at step {a})" for rid, a in cs["solo"])
    live = ", ".join(f"{x:.4f}" for x in cs["live"])
    print(f"dist ({label}) ContinuousDecodeServer(comm=DistComm), {who}, EP extent "
          f"{cs['ep']}, {cs['rows']} of {BATCH} slots a process, {cs['model']}, "
          f"{cs['requests']} requests, page {PAGE}, "
          f"{'captured' if cs['graphed'] else 'eager'} ({card}): {cs['steps']} steps, "
          f"{cs['tokens']} tokens, {cs['tok_s']:.1f} output tok/s; ttft p50 "
          f"{cs['ttft_p50']:.4f} s, p99 {cs['ttft_p99']:.4f} s; itl mean {cs['itl']:.5f} s"
          f"{' (gloo via host)' if gloo else ''}, p50 {cs['itl_p50']:.5f} s, p99 "
          f"{cs['itl_p99']:.5f} s; live row-steps by batch rank {live}; pages peak "
          f"{cs['pages_peak']} of {cs['pages_dense']} dense; the step's token gather "
          f"{cs['gather'][0]:.5f} ms a call ({cs['gather'][1]:.5f} ms queued); requests "
          f"{solo} alone through the same engine bitwise equal{ref}; launches "
          f"{cs['launches']}; peak {cs['peak_gib']:.2f} GiB; {cs['seconds']:.1f} s")


def prefill_lines(pf: dict | None, who: str, label: str, card: str) -> None:
    if pf is None:
        print(f"dist ({label}) prefill forward, {who}: not run, EP extent 1 takes the "
              "dense MoE path, so no HT dispatch or combine runs")
        return
    for name, run in pf["runs"].items():
        ref = ""
        if "ref_loss" in run:
            ref = (f"; LocalComm({run['ep']}) on one card: loss {run['ref_loss']:.6f}, "
                   f"{run['loss_err']:.3g} off relative (limit {PF_LOSS_REL}), wall "
                   f"{run['ref_wall']:.3f} s")
        print(f"dist ({label}) prefill forward {name}, {who}, EP over {run['axes']}, "
              f"{run['model']}{' + MTP' if run['mtp'] else ''} train_4k, {run['batch']} x {PF_SEQ} "
              f"global, rows {run['rows']} a process, fp8 dispatch, capacity 1.25 "
              f"({card}): loss {run['loss']:.6f} (aux {run['aux']:.6f}), repeat bitwise "
              f"equal; wall {run['wall']:.3f} s after a warm-up, {run['tok_s']:.1f} prefill "
              f"tok/s this card, {run['total_tok_s']:.1f} in total; weights "
              f"{run['weights_gib']:.2f} GiB, peak {run['peak_gib']:.2f} GiB; plan host "
              f"time {run['plan_s']:.3f} s (handle creation, card synchronised); dropped "
              f"shares {run['dropped']}{ref}; launches {run['launches']}")
    if "hierarchical, 2 chunks" in pf["runs"]:
        print(f"dist ({label}) prefill, {who}: hierarchical 2 chunks bitwise equal to 1 "
              f"chunk (loss and aux); {pf['seconds']:.1f} s")


def dist_who(r: dict, world: int) -> str:
    return f"rank {r['rank']} of {world}, {r['backend']} on {r['device']}"


def dist_lines(res: list, world: int, card: str, label: str) -> None:
    """One line per rank and sub-phase of a dist child's DBRX results."""
    for r in res:
        who = dist_who(r, world)
        gloo = r["backend"] == "gloo"
        pr = r["prims"]
        times = "; ".join(f"{k} {v[0]:.5f} ms a call ({v[1]:.5f} ms queued)"
                          for k, v in pr["times"].items())
        print(f"dist ({label}) primitives, {who} ({card}): all_to_all, all_gather bitwise "
              f"against LocalComm({world}) in bf16, int32, fp8; all_reduce off by "
              f"{pr['reduce_err']:.3g}; a2a send {pr['shapes']['a2a']} bf16, gather "
              f"{pr['shapes']['gather']} int32: {times}; peak {pr['peak_gib']:.2f} GiB; "
              f"{pr['seconds']:.1f} s")
        lay = "; ".join(f"{k}: " + (f"capture {v['capture_s']:.4f} s, replay"
                                    if v["capture_s"] is not None else "eager")
                        + f" {v['call_ms']:.4f} ms a call, launches {v['launches']}"
                        for k, v in r["layer"].items())
        print(f"dist ({label}) EP layer 0, {who}, batch {BATCH} over {world}: bitwise against "
              f"LocalComm({world}); the compiled step's calls bitwise against eager; {lay}; "
              f"decode_loop on two streams bitwise against the naive step over 3 steps; "
              f"peak {r['layer_peak_gib']:.2f} GiB; {r['layer_seconds']:.1f} s")
        serve_line(r["serve"], who, label, card, gloo)
        continuous_line(r["continuous"], who, label, card, gloo)
        prefill_lines(r["prefill"], who, label, card)


def deep_line(d: dict, who: str, label: str, card: str) -> None:
    """The deep DeepSeek-V3 serve's line."""
    modes = "; ".join(f"{k}: itl mean {v['itl']:.5f} s, p99 {v['p99']:.5f} s, ttft "
                      f"{v['ttft']:.4f} s, {v['tok_s']:.1f} tok/s, launches {v['launches']}"
                      for k, v in d["runs"].items())
    print(f"dist ({label}) deep DecodeServer(comm=DistComm), {who}, EP extent {d['ep']}, "
          f"{d['rows']} rows a process, {d['model']}, {BATCH} x ({PROMPT} + {GEN}) ({card}): "
          f"captured tokens bitwise equal to eager; {modes}; weights {d['weights_gib']:.2f} "
          f"GiB a card, peak {d['peak_gib']:.2f} GiB; {d['seconds']:.1f} s")


def dist_phase(card: str) -> None:
    """One EP rank per process, in child processes (the parent's weights are
    freed first): (a) NCCL at world = the card count, one card each, which
    is (b) when there are several cards; (c) two ranks sharing card 0 over
    gloo. A child that fails fails the phase; the others are killed."""
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    work = _build.BUILD_DIR.parent
    for n, backend, label in ((world, "nccl", "a" if world == 1 else "a, b"),
                              (2, "gloo", "c")):
        res = spawn(dist_child, n, backend, card, label, timeout=dist_timeout(n), workdir=work)
        for model, key in (("DBRX", None), ("DeepSeek-V3", "ds")):
            if key is not None and key not in res[0]:
                continue
            logs = [(r if key is None else r[key])["continuous"]["admissions"] for r in res]
            check(all(log == logs[0] for log in logs),
                  f"dist ({label}): the ranks' {model} continuous admission logs differ")
            print(f"dist ({label}) every rank's {model} continuous admission log equal: "
                  f"{len(logs[0])} admissions (step, rid, slot), the first {logs[0][:3]}")
        if backend == "nccl" and world < 2:
            print(f"dist (b) did not run: world {world}, this machine has one card, and "
                  "NCCL puts no two ranks of a communicator on one card")
        print(f"dist ({label}) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    build()
    if args == ["--dist-only"]:
        # the one-process-per-rank phase alone, for a machine with several cards
        dist_phase(card)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args:
        print(f"chip_smoke: unknown arguments {args}; run it with none, or --dist-only",
              file=sys.stderr)
        return 2
    full = full_config("decode_32k")
    cfg = dataclasses.replace(full, num_layers=LAYERS)
    m = cfg.moe
    print(f"DBRX-132B at full width: d_model {cfg.d_model}, {cfg.attn.n_heads}/"
          f"{cfg.attn.n_kv} heads of {cfg.attn.head_dim}, {m.num_experts} experts "
          f"top-{m.top_k}, d_ff_expert {m.d_ff_expert}, vocab {cfg.vocab}, {cfg.dtype}; "
          f"num_layers cut from {full.num_layers} to {LAYERS} for memory; "
          f"{RANKS} EP ranks on one card, batch {BATCH}, prompt {PROMPT}, {GEN} generated")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, DEV)
    torch.cuda.synchronize()
    print(f"init: random weights on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    # the main paths run first, before any profiling touches the card
    fixed = fixed_serve_phase(cfg, params, card)
    pipelined_phase(cfg, params, card, fixed["nccl_ep"]["tokens"])
    csrv, claunches, reqs, citl, want, _ = continuous_phase(cfg, params, card)
    cadmissions = list(csrv.reqsched.admissions)
    decode_loop_phase(cfg, params, card)
    replay_trace_phase(fixed, csrv, citl)
    # release every captured graph and its pool, and the fixed-batch servers,
    # before the prefill forward
    for info in fixed.values():
        info.pop("srv").close()
    csrv.close()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"graphs released: {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (the weights "
          f"{sum(t.nbytes for t in leaves(params)) / 2**30:.2f} GiB)")
    traced_continuous_phase(cfg, params, card, reqs, want)
    pcfg, flat_run = prefill_phase(params, card)
    plaunches = flat_run["launches"]
    prefill_trace_phase(params, pcfg, flat_run["batch"], flat_run["wall"])
    gc.collect()
    torch.cuda.empty_cache()
    hier_prefill_phase(params, card, flat_run)
    del flat_run
    gc.collect()
    torch.cuda.empty_cache()
    records = kernel_phase(cfg, params)
    ht_kernel_phase(pcfg, params)
    hier_kernel_phase(pcfg, params)
    records[PAGED] = paged_kernel_phase(cfg, paged_main_shape_phase(cfg, csrv))
    records[FLASH] = flash_kernel_phase(pcfg)
    records.update(fp8_kernel_phase(cfg, params))
    records["combine_reduce"] = combine_reduce_phase(cfg.d_model)
    oracle_phase(cfg, params)
    layout_oracle_phase(cfg, params)
    ht_oracle_phase(pcfg, params)
    hier_oracle_phase(pcfg, params)
    solo_phase(cfg, params, mid_stream(csrv, reqs, 2), want)
    paged_vs_dense_phase(cfg, params)
    for name, n in fixed["nccl_ep"]["launches"].items():
        if name in records:
            records[name]["launches"] = n
    records[PAGED]["launches"] = claunches[PAGED]
    records[FLASH]["launches"] = plaunches[FLASH]
    for name in ("quantize_fp8", "dequantize_fp8", "combine_reduce"):
        records[name]["launches"] = fixed["deepep_fp8"]["launches"][name]
    check(sorted(records) == sorted(KERNELS)
          and all(r["launches"] is not None for r in records.values()),
          f"kernel records {sorted(records)}")
    base = eplb_phase(cfg, params, card, reqs, want, cadmissions)
    elastic_phase(cfg, params, card, reqs, want, cadmissions, base)
    # DeepSeek-V3 runs alone on the card: every DBRX tensor goes first
    del params, csrv, fixed, reqs, want
    gc.collect()
    torch.cuda.empty_cache()
    print(f"DBRX released: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    ds_rows = deepseek_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    deepseek_forward_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    dense_rows = dense_phase(card)
    dense_rows += gemma3_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    gemma3_ring_phase(card)
    dense_rows += phi3v_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    dist_phase(card)
    # training last: what its allocator keeps cached cannot crowd the
    # spawned processes that share the card in dist_phase
    gc.collect()
    torch.cuda.empty_cache()
    mla_phase(card)
    train_layout_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_rows = train_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    minicpm_train_phase(card)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values()) + ds_rows + dense_rows + train_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
