#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, in order; any failure exits non-zero and prints no result line:

1. Print the card's name and power limit (``nvidia-smi``), then build every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all started together) and print the build time.
2. Hold each kernel against its plain PyTorch version at the main paths'
   shapes: the GEMMs K1-K3 at minicpm-2b's M in {4, 512} x (K, N) in
   {(2304, 2304), (2304, 5760), (5760, 2304), (2304, 122753)} and
   minicpm-2b's local pieces at tensor-parallel size 2, (K, N) in {(2304,
   1152), (2304, 2880), (1152, 2304), (2880, 2304)} at M 4 and 512,
   falcon-mamba-7b's M in {4, 128} x (K, N) in {(4096, 16384), (8192, 288),
   (256, 8192), (8192, 4096), (4096, 65024)}, gemma3-4b's unembed and
   zamba2-1.2b's dtp and bc_proj at decode (M 4; (2560, 262144), (2048,
   64), (2048, 128)), in bf16 (beta unfolded) and
   int8 (beta folded, as the int8 dense layer calls them); the flash kernel
   K4 at BH = 4 x 36 over the prefill buckets S in {16, 32, 64, 128} and
   the trained S 256 (d 64, causal), d 128, d 40, a window of 32 and
   non-causal, bf16 and f32, and at deepseek-v2-lite-16b's MLA widths (d
   192 against dv 128, BH = 4 x 16, S 16-128 and 512, bf16; the f32 kernels
   must refuse them), gemma3-4b's d 256 (BH 4 x 8 at S 128 and 8 at S 2048,
   windows 0, 1024 and 37; the f32 kernels must refuse d 256 and the bf16
   ones d 320) and mixtral-8x22b's and starcoder2-3b's prefill at d 128
   (FLASH_CASES), whisper-small's encoder (BH 4 x 12, non-causal at its
   ragged S 1500) and pixtral-12b's prefill (BH 4 x 32, S 384, d 128);
   the paged kernel K5 at decode
   (B 4, H = KV = 36, Sq 1 and 4, d 64, pages of 16, 16 pages a sequence,
   lengths 17-256 and one of 0), a
   64-row prefill chunk, GQA group 4, a window of 40 and the absorbed MLA's
   d 576, dv 512 at decode and in a 64-row chunk, gemma3-4b's decode and a
   64-row chunk past its window (H 8, KV 4, d 256; once more zero-padded to
   d 264, the (576, 512) body d 256 ran in before its own) and the GQA
   ratios 6 and 12 of mixtral-8x22b and starcoder2-3b and pixtral-12b's
   decode (H 32, KV 8, d 128), in bf16 and f32; the
   fused conv K7 at seven ResNet-50 / AlexNet
   convs at batch 8 (CONV_CASES), baseline, FIP and FFIP, f32 and int8
   (beta folded), each in the tile ``conv_blocks`` picks; the selective
   scan K6 at falcon-mamba-7b's prefill (B 1, S 16 / 64 / 128, di 8192,
   N 16, bf16), two chunks at B 2, f32, a nonzero
   h0, and a state carried across two calls (SCAN_CASES); the flash backward
   K8 at BH 144, d 64, S 256 / 128 / 200, a window of 32 and non-causal,
   bf16 and f32, at MLA's d 192 / dv 128, BH 2 x 16, S 256, and at
   gemma3-4b's (256, 256), BH 8, S 128 and 2048, windows 0, 1024 and 37,
   and whisper-small's encoder (BH 2 x 12, non-causal at S 1500), bf16
   (FLASH_BWD_CASES); the scan backward K9 at falcon-mamba-7b's
   widths, B 2 S 256 (two chunks), B 1 S 128 and S 64, f32
   (SCAN_BWD_CASES). Tolerances: int8
   exact; K6's y, h_final and h_starts bit for bit (beside the earlier
   bars, rtol = atol = 1e-4 of the plain f32 values and bf16 y one ulp),
   the carried state bit for bit; K8's f32
   dq/dk/dv rtol 1e-4, atol 1e-4 * max|plain|, cast to bf16 one ulp beyond
   that atol; K9's five gradients bit for bit; bf16 and f32
   GEMMs and K7 the
   reference's f32 GEMM bar (rtol 1e-4, atol 1e-3 * max(1, K // 64)), both
   sides summing the same products in f32 in another order; flash o at 2**-7
   (one bf16 rounding of o) and lse at 2e-3; K5 at 2**-7, with exact zeros
   for a sequence of length 0. Each call is timed with CUDA events, L2
   flushed between launches (K1-K6, K8, K9, the carry table and their
   library yardsticks by CUDA-graph replay, the time around the call beside
   it; the floor of such a reading, a one-element add_ replayed the same
   way, is printed first), beside its plain
   version (timed on the call that checks it, after a warm call for the
   cheap K4/K5 ones), its library yardstick and its bound. The GEMM lines
   start with the registers and spills (the build's ``-Xptxas -v``) of each
   instantiation of K1's tensor-core body and of K2/K3's pair body, the
   K4-K9 lines with those of K4's tensor-core body, K5's kernels, K6,
   K7's FIP/FFIP pair kernels, K8's tensor-core passes and K9; K6 and K9
   print their issue-slot floors (scan_fwd_issue_ms, scan_bwd_issue_ms).
   K3's carry-table kernel is held bit for bit to its plain version on
   each weight's y and timed on
   the card (the derivation runs once per weight, memoized beside y; the
   K3 calls are timed with it memoized).
3. Batch invariance, bit for bit: rows 0-3 of an M = 512 K1/K2/K3 call
   against the same rows at M = 4, 64 and 256 (f32 and bf16), rows 0-3 of
   falcon-mamba-7b's in_proj (K 4096, N 16384) at M = 128 against M = 1, 4
   and 16, and image 0 of a batch-8 K7 call against the batch-1 call.
   Then phase faults (ROADMAP queue 3): F7, the torch provider's baseline
   conv (``vision.layers._nchw_conv``) at ResNet-50 s2b1.c2's geometry,
   batch 2, unit-normal data, under PyTorch's default cuDNN flags, within
   the reference's f32 GEMM bar of the host's conv and leaving the flags as
   it found them (``F.conv2d`` as called before the repair printed beside
   it); F6, the zamba2 and minicpm smoke models in bf16 served int8 FFIP
   through the kernels give the host's tokens.
4. Serve minicpm-2b at its published widths (random weights from --seed)
   through ``BatchServer(gemm_impl="cuda")``: 4 slots, 8 requests of 16-128
   prompt tokens, 8 new tokens each, once each with gemm_algo ffip, fip and
   baseline and once int8 (quantized, ffip). Launch counts are zeroed just
   before each run and read just after. Every request must complete with its
   exact budget.
4a. The reports (phase reports): the meta-device cost model
   (``repro_torch.launch.costs``, ``launch.dryrun``) against the card, on
   minicpm-2b at that depth. One bucketed prefill dispatch (4 x 128) and
   one decode step at 4 slots, FFIP float and int8, as the server runs
   them (``dryrun.served_steps``): the launches the trace predicts must be
   the launches counted on the card; each dispatch's CUDA-event time
   against the trace's bound gives its roofline share, which must not pass
   REPORT_SHARE_MAX; the bytes the params, the int8 entries and the cache
   ask the allocator for must be the trace's (the allocator's blocks and
   the trace's peak of live storage printed beside the card's). Then
   ``launch.dryrun`` over minicpm-2b's four shapes on the 16x16 mesh,
   timed. Phase dist and its sharded scan hold each rank's collectives in
   one decode step (minicpm-2b and falcon-mamba-7b at 8 layers, float and
   int8 FFIP) to one rank's meta trace on a shape-only mesh.
5. Check the tokens against the plain path (torch.matmul / the plain int8
   algebra, plain attention, one prompt at a time): each served first token
   against a plain prefill of its prompt, each second token against a plain
   decode step fed the served first token. A token must be the plain argmax
   or within a bar of standard deviations of the plain logits' max
   (FLOAT_BAR_SD, INT8_BAR_SD). Each bar is held between readings taken in
   the same run: the sound ones (the served shortfalls; for float also each
   prompt's kernel-vs-plain prefill deviation; the int8 run once more with
   plain attention, which must also read within PLAIN_ATTENTION_BAR_SD
   0.05) below it, and served
   runs with a planted fault (a middle layer's attn.wo taken from the next
   layer, served float FFIP and int8 FFIP) above it.
6. Serve minicpm-2b paged (``paged=True``, K5 for all attention): 4 slots,
   max_len 256 in pages of 16, prefill chunks of 64, 8 prompts of 16-128
   tokens (the even ones behind a shared 64-token prefix, the last a copy of
   the first), 8 new tokens each: flash ffip at decode_chunk 4 and flash
   int8 at decode_chunk 1, their first and second tokens held to the plain
   path under the same bars. Then, at the first IDENTITY_LAYERS layers:
   int8 and float FFIP with every prompt in one chunk must give the tokens
   they give in chunks of 64, and gather-paged int8 with plain attention the
   contiguous server's tokens. Every paged run must hit the
   prefix index, copy on write, drain its page reservations, balance the
   allocator, peak below slots x max_pages pages, and launch K5 exactly
   n_layers x (prefill chunks + decode dispatches x decode_chunk) times and
   K4 never. K7 must never launch on the LM paths.
7. The CNN path (VISION_RUNS): ResNet-50 (224) in float ffip, fip and
   baseline and int8 ffip, AlexNet (227) in float ffip and int8 ffip, batch
   8, published widths, 1000 classes, f32 weights from --seed, through
   ``repro_torch.vision`` with ``GemmConfig(impl="cuda")``. Each forward
   must launch K7 once per conv (53 / 5) and its FC kernel once per FC
   (1 / 3) and nothing else; float logits within a relative L2 error of
   1e-3 of the plain path's (F.conv2d with TF32 off, torch.matmul), or for
   FIP/FFIP, where the plain path's own FIP/FFIP algebra misses that, no
   further off than it; int8 logits equal to the plain int8 path's bit for
   bit and within 0.35 of the plain float logits.
8. Count and profile one contiguous prefill dispatch and decode step, one
   paged decode step, one paged prefill chunk and one ResNet-50 forward.
8a. The autotuner (phase tune): ``launch.tune --arch minicpm-2b`` into a
   temporary ``REPRO_TUNE_CACHE`` over the served (K, N) set at the M
   buckets of 4. (TUNE_M), ffip / fip / baseline in bf16 and int8, and the
   prefills' flash buckets; ``tune.tune_conv`` on ResNet-50 s2b1.c2 (batch
   8, f32 FFIP). Each bucket's tuned and default times are printed, and
   every candidate is held to the default bit for bit by the tuner. A
   second run with ``--expect-cached`` must measure nothing. minicpm-2b is
   served ffip once more with ``gemm_block="auto"``: no lookup may miss and
   the tokens must be 4.'s ffip tokens.
8b. Prepared artifacts (phase prepare): ``launch.prepare`` writes
   minicpm-2b at its published widths and PREPARE_LAYERS of 40 layers, int8
   FFIP, with the tune phase's schedule slice (bytes printed); it is loaded
   (seconds printed) and the prompts of 4. served through
   ``BatchServer(prepared=, gemm_block="auto")``: ``recomputed == 0``, no
   lookup missed, no carry table launched while serving, and the tokens of
   an unprepared server on the same weights; each server's first step
   (preparation and first prefill) is timed.
8c. Tensor parallelism (phase dist) on a (1, DIST_TP) mesh, one process a
   rank through ``launch.serve``'s rank entry (``spawn_ranks``,
   ``serve_job``): gloo with both ranks on the one card, which shows the
   sharded computation and its collectives, not a multi-card speed. The
   tensor-parallel dense layers against the whole layer
   (``repro_torch.dist.parity``, minicpm-2b's widths, M 4 and 512: int8
   column- and row-parallel bit for bit, bf16 row-parallel within the f32
   GEMM bar); then, DIST_MAX_NEW new tokens a request, minicpm-2b at 40
   layers served float and int8 FFIP, read against phase serve's plain path
   under the same bars, with the count of tokens equal to phase serve's
   own; a planted fault (rank 1's piece of layer 0's ``ffn.down`` taken
   from rank 0's, float FFIP) above the float bar; phase prepare's artifact
   cut per rank, ``recomputed == 0`` and the single-device prepared
   server's tokens; deepseek-v2-lite-16b at DIST_MOE_LAYERS of 27, int8
   FFIP, ``moe_partition`` "expert" and "ffn", each read against the plain
   path replaying its dispatches (``Replay``). Every rank must launch its
   GEMM kernel and K4, and return rank 0's tokens; each rank's peak memory,
   launches, prefill s and decode ms/step are printed.
9. The router and ``repro_torch.obs`` (phase fleet), on the same
   minicpm-2b weights at their first IDENTITY_LAYERS layers (the run's
   time), every replica sharing its weights and its tier's one
   ``repro_torch.prepare`` preparation (float or int8: no server derives y,
   carry tables or int8 weights), 2 slots each, the
   prompts of 4., 8 new tokens: no-fault oracles (ffip with the profiler
   hooks toggled every step, its decode ms/step with them off and on
   printed; int8-ffip; paged flash fip), then ``ReplicaRouter`` on a FakeClock over ffip +
   int8-ffip under each fault plan of tests/test_serve_router.py (raise,
   hang, exhaust, poison; FLEET_PLANS) and over paged flash fip (K2, K5)
   + int8-ffip under exhaust. Every request must end DONE with its
   configuration's oracle tokens (a difference is read against the plain
   path and fails the run), each fault must fire, every page ledger
   drain, and no replica step may raise what its plan did not inject
   (both parts). Then the SLO loop through ``launch.serve.main``
   (``--replicas 2 --quantized-replicas 1 --fault-plan flaky --slo
   "ttft_ms p99 < 2000"``, the baseline GEMM K1), ``launch.obs_check`` on its metrics and trace
   (tighten, probe and recover counted, the alert cleared) and one
   ``launch.dash`` frame.
10. The Mamba1 path (phase ssm): falcon-mamba-7b at its published widths and
   20 of its 64 layers (SSM_SERVE_LAYERS), bf16, random weights from --seed, served as in
   4. (every prompt in its own scatter-prefill dispatch) with ffip, fip,
   baseline and int8 ffip. Each run must meet every budget, launch its GEMM
   kernel, and launch K6 exactly once per layer per prompt. Tokens against
   the plain path (plain selective scan included) under the same bars, with
   ssm.out_proj taken from the next layer as the planted fault; then one
   128-token prefill and one decode step profiled.
11. The training path (phase train, TRAIN_RUNS): minicpm-2b at its
   published widths and 40 layers (batch 4 x 256) and falcon-mamba-7b at its
   widths and 48 of 64 layers (batch 2 x 256; 64 layers' bf16 params, grads
   and f32 moments would pass the card's 80 GB), bf16, random weights from
   --seed, 8 AdamW steps (lr TRAIN_LR, WSD, 2 warmup steps) through
   ``train.loop.train`` on batches of the port's data pipeline. Every step
   must launch K4 and K8 (K6 and K9) once per layer and none of K1-K3, K5,
   K7; losses and gradient norms finite, the last loss below the first.
   ms per step, tokens/s, peak memory and one profiled step are printed.
   Then one step's gradients through the kernels against the plain path
   (plain attention; autograd through the plain f32 recurrence) at the
   first IDENTITY_LAYERS layers: the largest per-leaf relative L2 error
   must lie below GRAD_BAR and a planted fault's (a middle layer's output
   projection taken from the next layer) above it. minicpm-2b is trained
   once more at AdamWConfig's default learning rate through the kernels and
   through the plain path: where the plain path's last loss falls below its
   first, the kernels' must too.
12. The MLA + MoE path (phase moe): deepseek-v2-lite-16b at its published
   widths and 4 of its 27 layers (MOE_SERVE_LAYERS), bf16, random weights
   from --seed, served as in 4.
   with ffip, fip, baseline and int8 ffip (every prefill dispatch launches
   K4 at d 192 / dv 128 once per layer, decode attends through the absorbed
   einsums and launches no attention kernel) and paged as in 6. (flash
   ffip at decode_chunk 4, int8 at 1: K5 on the absorbed latent, H 16, one
   kv head, d 576, dv 512). First and second tokens are held under the same
   bars to a replay of each served run through the plain path (``Replay``:
   the same dispatches, batches and padding, the served ids fed back), since
   an expert's capacity depends on every token of a dispatch; the kernels'
   prefill of each prompt alone against the plain one's is a float sound
   reading as before, and a middle MoE layer's attn.wo taken from the next
   layer the planted fault. Then trained as in 10. at MOE_TRAIN_RUNS' depth
   (K4 + K8 once per layer a step; the aux loss finite) with its gradient
   reading.
13. The other LM families (phase families, FAMILY_RUNS), each at its
   published widths, bf16, random weights from --seed: gemma3-4b at 34
   layers (5 local : 1 global, windows of 1024, thetas 1e4 / 1e6, K4, K8
   and K5 at d 256), mixtral-8x22b at 6 of 56 (GQA 48 : 8 + MoE 8 experts
   top-2, window 4096), starcoder2-3b at 8 of 30 (layernorm, gelu, a qkv bias,
   GQA 24 : 2) and deepseek-coder-33b at 10 of 62 (GQA 56 : 8), the cuts
   being the run's time. Each is served contiguous (gemma3 ffip,
   baseline and int8 ffip; the others ffip and int8 ffip) and, but for
   deepseek-coder, paged (flash ffip) as in 4. and 6., every prefill
   dispatch launching K4 once a layer and every paged one K5; gemma3's and
   mixtral's prompts include one past the window (1100-1499 and 4200-4399
   tokens). Tokens are held under the same bars to the plain path (each
   prompt alone, or for mixtral a replay of the served run with its expert
   choices; the plain int8 products by an exact float64 matmul), with a
   middle layer's attn.wo taken from the next layer the planted fault
   (float and int8). gemma3 is then trained as in 10. at batch 1 x 1536
   through K4 + K8 at (256, 256), with its gradient reading.
14. The encoder-decoder and the patch prefix (phase encdec), each at its
   published widths, bf16, random weights and stub frontend inputs from
   --seed. whisper-small at its 12 + 12 layers (d 768, 12 heads of 64,
   layernorm, gelu, a qkv bias, vocab 51865 tied): the frontend entry point
   ``Model.prefill(frames=)`` on 4 rows of 1500 stub frames and a 32-token
   decoder prompt (the encoder through K4 non-causal at S 1500, the cross
   K/V cached), then 16 greedy ``decode_step``s against the cached cross
   K/V, in ffip, baseline and int8 ffip, every GEMM through K1/K3 and K4
   launched once a layer (24); BatchServer ffip on the served prompts (one
   scatter prefill a prompt, over a fresh cache's zeroed cross K/V, as the
   reference serves it); then trained 8 AdamW steps through K4 + K8 with
   ``Model.loss(frames=)`` at batch 2 x 448 (K4 = K8 = 24 a step), the
   loss finite and falling, one step's gradients under GRAD_BAR and a
   planted fault's above it. pixtral-12b at 32 of its 40 layers (one
   card's memory; d 5120, 32 heads of 128 over 8 kv heads, d_ff 14336,
   vocab 131072 untied, rope theta 1e9): ``Model.prefill(patches=)`` on 4
   rows of 256 stub patches and a 128-token prompt (K4 at S 384, d 128),
   16 greedy steps at positions that count the prefix, ffip and int8 ffip;
   then text only through BatchServer, contiguous ffip and paged flash
   ffip (K5 at GQA 4, d 128). Every token of a frontend run is read against
   the plain path fed the served tokens before it, under the float / int8
   bars; the planted faults (whisper: a middle encoder layer's attn.wo, and
   a middle decoder layer's cross wk and wv, each taken from the next
   layer's; pixtral: a middle layer's attn.wo from the next, and the same
   prompts prefilled without their patches) must read above them.
14b. The other families on a mesh (phase dist families, DIST_FAMILY_RUNS),
   tensor-parallel on a (1, DIST_TP) mesh as in 8c., all in one
   ``spawn_ranks``: gemma3-4b at 6 of 34 layers (one global layer; a
   prompt past the window of 1024), mixtral-8x22b at 2 of 56 ("ffn" float
   and int8, "expert" int8), starcoder2-3b, deepseek-coder-33b and
   pixtral-12b (text) at 8, whisper-small at its 12 + 12 (over a fresh
   cache's zeroed cross K/V, as 14. serves it), each at its published
   widths, float and int8 FFIP, DIST_MAX_NEW new tokens; every rank must
   launch K3 and K4 on its pieces and return rank 0's tokens. Each run is
   held to the same family at the same depth and weights on one card: the
   count of tokens equal to the single card's run (int8 equal wherever the
   partition sums int32, all but mixtral's "ffn" experts), and the
   readings against the plain path under the float / int8 bars (mixtral:
   a replay of the run with its expert choices). The planted fault
   (gemma3: rank 1's piece of layer 0's ``ffn.down`` from rank 0's) must
   read above the float bar. whisper's frontend entry at tp 2 (4 x 1500
   stub frames through the encoder, K4 non-causal on 6 heads a rank, then
   decode over the rank's cross K/V) against 14.'s single-card runs, and
   pixtral's (256 patches, 8 layers) against a single-card run at its
   depth, each read against ``FrontendPlain``. One decode step's
   collectives of whisper and gemma3, float and int8, counted on each rank
   and equal to the meta-device trace's. The router on the mesh
   (``launch.serve.router_job``, minicpm-2b at DIST_ROUTER_LAYERS,
   ``--replicas 2 --quantized-replicas 1 --fault-plan flaky``): every
   request DONE with its tier's no-fault tokens, no unplanned failure, the
   ranks' router events, outcomes and tokens identical. Each rank's peak
   memory and launches are printed, and the kernels line carries each
   rank's launches of this phase.
14c. Training on a mesh (phase dist train, DIST_TRAIN_RUNS), two gloo
   ranks sharing the card in one ``spawn_ranks``, each run on its own
   ("data", "model") mesh over them, at the published widths:
   minicpm-2b at 4 layers, 4 x 256, at (2, 1) and (1, 2); falcon-mamba-7b
   at 4, 2 x 256, at (1, 2) (K6 and K9 on a rank's 4096 of 8192 channels)
   and (2, 1); deepseek-v2-lite-16b at 3, 2 x 256, at (1, 2) "expert" and
   "ffn" and (2, 1). Each rank holds its pieces of the weights and of
   AdamW's moments (``train_specs``: the ZeRO "data" cut and the "model"
   cut) and takes DIST_TRAIN_STEPS steps on the pipeline's global batches.
   Step 0's gradients, every leaf gathered whole, must read under GRAD_BAR
   (per-leaf relative L2) against one card's step on the whole weights
   (rank 0; the MoE with the mesh run's gathered expert choices), and a
   planted fault (minicpm-2b at (1, 2): rank 1's piece of a middle layer's
   attn.wo taken from the next layer) above it; the losses are printed
   beside one card's. deepseek's keep masks at (2, 1) must equal, bit for
   bit, the global rule applied to the ranks' gathered expert choices.
   Each rank's collectives of step 0 must equal the meta-device trace's
   (``launch.dryrun.train_collectives``); every rank must launch K4 and K8
   (falcon: K6 and K9) once a layer a step and nothing else. minicpm-2b's
   state is saved at (2, 1) (``CheckpointManager.save(shardings=)``, whole
   leaves from rank 0) and restored at (1, 2) (``restore(shardings=)``):
   the restored params and moments, gathered whole on each rank, must
   equal the saved leaves bit for bit, and the next step's loss lie within
   DIST_TRAIN_LOSS_RTOL of the unbroken run's. The kernels line carries
   each rank's launches of this phase.
15. The Mamba2 + shared attention hybrid (phase hybrid): zamba2-1.2b at its
   published widths and HYBRID_LAYERS of its 38 layers (3 groups of 6
   Mamba2 layers, each group followed by the one shared GQA block, then a
   tail of 2; the run's time), bf16,
   random weights from --seed, served as in 4. with ffip, fip, baseline and
   int8 ffip: every prompt in its own scatter-prefill dispatch (the state
   has no sequence axis to bucket), each dispatch launching K4 once per
   group (6) and decode none; K5, K6 and K7 never. Tokens against the plain
   path (plain GEMMs or int8 algebra, plain attention, the same SSD code)
   under the same bars, with a middle Mamba2 layer's ssm.out_proj taken
   from the next layer the planted fault; one 128-token prefill and one
   decode step profiled. Then trained as in 11. at batch 2 x 256 (K4 = K8
   = 6 a step) with its gradient reading at HYBRID_GRAD_LAYERS layers.
16. Print the kernels line (JSON), then the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The H100's peaks and the per-kernel cost model behind every bound this
# script prints live in the package (repro_torch.launch.costs): a kernel's
# bound is its kernel_cost's (bytes at HBM_BYTES_S against its operations'
# time), the same counts the meta-device reports charge.
# pair_counts stays importable from here (tools/pair_probe.py).
from repro_torch.launch.costs import (BOOST_CLOCK_HZ,  # noqa: E402,F401
                                      kernel_cost, pair_counts,
                                      pair_seconds)


def pair_ms(adds: float, mads: float, integer: bool) -> float:
    """Least ms of the pair arithmetic (``costs.pair_seconds``)."""
    return pair_seconds(adds, mads, integer) * 1e3

# GEMM checks, (M, K, N): minicpm-2b's projections and tied logits at decode
# (M 4) and prefill (M 512); falcon-mamba-7b's in_proj, x_proj (N 288, not a
# multiple of 64), dt_proj (K 256: 16 FFIP splits), out_proj and tied logits
# at decode (M 4) and at a 128-token prompt (M 128); gemma3-4b's tied
# unembed (N 262144, the widest the port serves) at decode; zamba2-1.2b's
# narrowest projections at decode, dtp (N 64, one column a head) and
# bc_proj (N 128, B and C); minicpm-2b's local shapes at tensor-parallel
# size 2 (phase dist: a rank's piece of wq / wo, up / gate and down); and
# the SSM pieces at tp 2 (phase dist, the sharded scan): falcon-mamba-7b's
# in_proj (x | z halves) and out_proj pieces at decode and a 128-token
# prompt, its x_proj (row-parallel, K 4096) and dt_proj (N 4096) pieces at
# decode; zamba2-1.2b's z_proj / x_proj_in / out_proj (2048 x 2048), dtp (N
# 32) and the shared block's wq (N 1024) and wo (K 1024) pieces at decode;
# the other families' pieces at tp 2 (phase dist families) at decode and a
# 128-token bucket: gemma3-4b's wq (4 of 8 heads of 256), pixtral-12b's wo
# (K 2048: 16 of 32 heads of 128), whisper-small's up (N 1536) and
# starcoder2-3b's wk (one of its 2 KV heads: N 128)
GEMM_CASES = tuple(
    (m, k, n) for ms, kns in (
        ((4, 512), ((2304, 2304), (2304, 5760), (5760, 2304),
                    (2304, 122753))),
        ((4, 512), ((2304, 1152), (2304, 2880), (1152, 2304),
                    (2880, 2304))),
        ((4, 128), ((4096, 16384), (8192, 288), (256, 8192), (8192, 4096),
                    (4096, 65024))),
        ((4,), ((2560, 262144), (2048, 64), (2048, 128))),
        ((4, 128), ((4096, 8192), (4096, 4096))),
        ((4,), ((4096, 288), (256, 4096), (2048, 2048), (2048, 32),
                (2048, 1024), (1024, 2048))),
        ((4, 512), ((2560, 1024), (2048, 5120), (768, 1536), (3072, 128))))
    for m in ms for k, n in kns)
HEADLINE_GEMM = (4, 2304, 5760, "bf16")     # decode up/gate projection
# K4 checks: (label, BH, S, d, dv, window, causal, dtypes). At BH = 4 x 36
# (minicpm-2b's heads at 4 slots or training batch 4), bf16 and f32: S
# 16-128 are the served prefill buckets, S 256 the trained sequence; d 128
# runs the second tensor-core instantiation, d 40 the first zero-filled. At
# BH = 4 x 16, deepseek-v2-lite-16b's MLA prefill: d 192 (nope 128 + rope
# 64) against dv 128, bf16 only (the f32 kernel takes d <= 128 and dv == d;
# check_flash_refusal holds it to that), the served buckets and S 512. At
# gemma3-4b's head_dim 256 (bf16, the (256, 256) instantiation): BH = 4 x 8
# (a served bucket of 4 slots) at S 128 and BH 8 (one long prompt; training
# at batch 1) at S 2048, each with no window, a local layer's 1024 and an odd
# 37. At d 128, mixtral-8x22b's and starcoder2-3b's prefill (K4 takes kv
# heads repeated to the query heads: BH = 4 x 48 and 4 x 24), mixtral's
# window 4096 past S. whisper-small's encoder: BH = 4 x 12, non-causal at
# its 1500 frames (11 x 128 + 92: the last key block ragged with no causal
# mask above its padded keys); pixtral-12b's prefill: 256 patches + a
# 128-token prompt, GQA 32 : 8 repeated to BH = 4 x 32, d 128. zamba2-1.2b's
# shared block at tp 2: a rank's 16 of its 32 heads of 64, one prompt a
# scatter prefill (BH = 1 x 16). The other families at tp 2 (phase dist
# families), a rank's half of the heads: gemma3-4b's 4 of 8 at d 256 (a
# 4-slot bucket, and one long prompt past a local layer's window),
# mixtral-8x22b's 24 of 48, starcoder2-3b's 12 of 24, deepseek-coder-33b's
# 28 of 56 (d 128), whisper-small's encoder at 6 of 12 (non-causal, S 1500)
# and pixtral-12b's 16 of 32 behind its patches (S 384).
BF16_F32 = ("bf16", "f32")
MLA_D, MLA_DV = 192, 128
GEMMA_D = 256
FAMILY_WINDOWS = (("", 0), (" window 1024", 1024), (" window 37", 37))
FLASH_CASES = (
    ("S 16", 144, 16, 64, 64, 0, True, BF16_F32),
    ("S 32", 144, 32, 64, 64, 0, True, BF16_F32),
    ("S 64", 144, 64, 64, 64, 0, True, BF16_F32),
    ("S 128", 144, 128, 64, 64, 0, True, BF16_F32),
    ("S 256", 144, 256, 64, 64, 0, True, BF16_F32),
    ("S 128 d 128", 144, 128, 128, 128, 0, True, BF16_F32),
    ("S 128 d 40", 144, 128, 40, 40, 0, True, BF16_F32),
    ("window 32", 144, 256, 64, 64, 32, True, BF16_F32),
    ("non-causal", 144, 128, 64, 64, 0, False, BF16_F32),
) + tuple((f"MLA S {s}", 4 * 16, s, MLA_D, MLA_DV, 0, True, ("bf16",))
          for s in (16, 32, 64, 128, 512)) + tuple(
    (f"gemma3 S {s}{wl}", bh, s, GEMMA_D, GEMMA_D, w, True, ("bf16",))
    for s, bh in ((128, 4 * 8), (2048, 8)) for wl, w in FAMILY_WINDOWS) + (
    ("mixtral S 128", 4 * 48, 128, 128, 128, 4096, True, ("bf16",)),
    ("starcoder2 S 128", 4 * 24, 128, 128, 128, 0, True, ("bf16",)),
    ("whisper encoder S 1500", 4 * 12, 1500, 64, 64, 0, False, ("bf16",)),
    ("pixtral S 384", 4 * 32, 384, 128, 128, 0, True, ("bf16",)),
    ("zamba2 tp2 S 128", 1 * 16, 128, 64, 64, 0, True, ("bf16",)),
    ("gemma3 tp2 S 128", 4 * 4, 128, GEMMA_D, GEMMA_D, 0, True, ("bf16",)),
    ("gemma3 tp2 S 2048 window 1024", 4, 2048, GEMMA_D, GEMMA_D, 1024, True,
     ("bf16",)),
    ("mixtral tp2 S 128", 4 * 24, 128, 128, 128, 4096, True, ("bf16",)),
    ("starcoder2 tp2 S 128", 4 * 12, 128, 128, 128, 0, True, ("bf16",)),
    ("deepseek-coder tp2 S 128", 4 * 28, 128, 128, 128, 0, True, ("bf16",)),
    ("whisper encoder tp2 S 1500", 4 * 6, 1500, 64, 64, 0, False,
     ("bf16",)),
    ("pixtral tp2 S 384", 4 * 16, 384, 128, 128, 0, True, ("bf16",)))
HEADLINE_FLASH = ("S 128", "bf16")
# Token bars, in standard deviations of the plain-path logits. Each lies
# between the sound readings of its tier and the planted faults it must see;
# every run prints both and fails if the bar no longer lies between them.
# Float: a prompt's prefill logits through the kernels differ from the plain
# path's by up to 0.083-0.111 sd for minicpm-2b (40 layers) and 0.219-0.276
# sd for falcon-mamba-7b (64 layers): bf16 outputs rounded after f32 sums in
# other orders. A served token can fall short of the plain max by about
# twice that (0.552); the served shortfalls read up to 0.122. A middle
# layer's output projection taken from the next layer reads 1.104 (minicpm
# attn.wo) and 0.999 (falcon ssm.out_proj), served through float FFIP.
# (H100 readings; the bar was 0.05 sd before, below the path's own noise.)
# int8: the per-token activation quantization turns bf16-level differences
# (flash vs plain attention) into whole int8 steps. Sound runs read up to
# 0.098 sd (0 with plain attention on both sides); the wrong-layer faults
# 1.006 (minicpm) and 1.046 (falcon).
FLOAT_BAR_SD = 0.6
INT8_BAR_SD = 0.25
# The int8 run with plain attention on both sides, whose int8 sums are exact,
# shows that the flash kernel is the only source of the int8 gap: it is held
# to the float bar's old value, and reads 0 (H100 readings).
PLAIN_ATTENTION_BAR_SD = 0.05
BARS_SD = {"float": FLOAT_BAR_SD, "int8": INT8_BAR_SD}
# K6 checks: (label, B, S, di, N, chunk, dtype, h0 scale), falcon-mamba-7b's
# prefill (the scatter prefill runs one prompt at a time) and the edges;
# check_scan adds every length phase ssm serves (full 32-step tiles and a
# ragged last one); "tp2 prefill S 128" is a rank's half of d_inner at
# tensor-parallel size 2 (phase dist, the sharded scan)
SCAN_CASES = (
    ("prefill S 16", 1, 16, 8192, 16, 128, "bf16", 0.0),
    ("prefill S 64", 1, 64, 8192, 16, 128, "bf16", 0.0),
    ("prefill S 128", 1, 128, 8192, 16, 128, "bf16", 0.0),
    ("two chunks", 2, 256, 8192, 16, 128, "bf16", 0.1),
    ("f32", 1, 128, 8192, 16, 128, "f32", 0.1),
    ("nonzero h0", 1, 128, 8192, 16, 128, "bf16", 0.1),
    ("tp2 prefill S 128", 1, 128, 4096, 16, 128, "bf16", 0.0),
)
HEADLINE_SCAN = "prefill S 128"
REPLACES = {
    "baseline_gemm": "src/repro/kernels/baseline_gemm.py:58",
    "fip_gemm": "src/repro/kernels/fip_gemm.py:65",
    "ffip_gemm_y": "src/repro/kernels/ffip_gemm.py:92",
    "ffip_carry_table": "src/repro/kernels/ffip_gemm.py:57",
    "flash_fwd": "src/repro/kernels/flash_attention.py:81",
    "flash_paged": "src/repro/kernels/flash_attention.py:335",
    "conv_gemm": "src/repro/kernels/conv_gemm.py:172",
    "selective_scan": "src/repro/kernels/selective_scan.py:72",
    "flash_bwd": "src/repro/kernels/flash_attention.py:191",
    "selective_scan_bwd": "src/repro/kernels/selective_scan.py:196",
}
SOURCES = {
    "baseline_gemm": "src/repro_torch/kernels/csrc/baseline_gemm.cu",
    "fip_gemm": "src/repro_torch/kernels/csrc/fip_gemm.cu",
    "ffip_gemm_y": "src/repro_torch/kernels/csrc/ffip_gemm.cu",
    "ffip_carry_table": "src/repro_torch/kernels/csrc/ffip_gemm.cu",
    "flash_fwd": "src/repro_torch/kernels/csrc/flash_fwd.cu",
    "flash_paged": "src/repro_torch/kernels/csrc/flash_paged.cu",
    "conv_gemm": "src/repro_torch/kernels/csrc/conv_gemm.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
    "flash_bwd": "src/repro_torch/kernels/csrc/flash_bwd.cu",
    "selective_scan_bwd": "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
}
# K7 checks at batch 8: (label, h, w, cin, cout, kh, kw, stride, pad,
# groups), ResNet-50's and AlexNet's convs at their published widths
CONV_BATCH = 8
CONV_CASES = (
    ("resnet50 conv1", 224, 224, 3, 64, 7, 7, 2, 3, 1),
    ("resnet50 s2b1.c2", 56, 56, 64, 64, 3, 3, 1, 1, 1),
    ("resnet50 s3b1.c1", 56, 56, 256, 128, 1, 1, 2, 0, 1),
    ("resnet50 s4b2.c2", 14, 14, 256, 256, 3, 3, 1, 1, 1),
    ("resnet50 s5b3.c3", 7, 7, 512, 2048, 1, 1, 1, 0, 1),
    ("alexnet conv1", 227, 227, 3, 96, 11, 11, 4, 0, 1),
    ("alexnet conv2", 27, 27, 96, 256, 5, 5, 1, 2, 2),
)
HEADLINE_CONV = ("resnet50 s2b1.c2", "f32", "ffip")
# The vision runs: (model, image size, [(label, algo, quantized)]), batch 8,
# published widths, 1000 classes, f32 weights from --seed
VISION_RUNS = (
    ("resnet50", 224, (("ffip", "ffip", False), ("fip", "fip", False),
                       ("baseline", "baseline", False),
                       ("int8-ffip", "ffip", True))),
    ("alexnet", 227, (("ffip", "ffip", False), ("int8-ffip", "ffip", True))),
)
# Relative L2 error of the logits against the plain float path (the
# launcher's bars). A float FIP/FFIP run is held to the larger of 1e-3 and
# the error of the plain path in its own algebra (the reference's float
# FIP/FFIP, materialised): in f32 the pre-add (a + b) drops the low bits of
# b when |a| >> |b|, and the BN-free random ResNet-50 grows its activations
# block by block, so that algebra itself misses 1e-3 there.
VISION_FLOAT_BAR = 1e-3
VISION_INT8_BAR = 0.35
# K5 checks: (label, B, H, KV, Sq, d, dv, page size, max_pages, window,
# scale). Decode lengths are drawn from 17-256 with the first set to 0 (its
# rows must be exact zeros); a prefill chunk is a prompt's second 64-row
# chunk (q_start 64, lengths 128), and a chunk past the window the 64 rows
# that end a 1344-key context. The MLA cases are deepseek-v2-lite-16b's
# absorbed paged attention: H 16, one kv head, k = [latent 512, rope 64],
# v = the latent, the pre-absorption scale 192^-1/2. gemma3-4b's decode (H
# 8, KV 4, d 256, contexts to 1536, its window 1024), mixtral-8x22b's
# and starcoder2-3b's GQA ratios 6 and 12 at d 128, and pixtral-12b's
# decode (H 32, KV 8, d 128, contexts to 512: a 256-patch prefix, the
# prompt and the new tokens).
PAGED_CASES = (
    ("decode", 4, 36, 36, 1, 64, 64, 16, 16, 0, None),
    ("decode Sq 4", 4, 36, 36, 4, 64, 64, 16, 16, 0, None),
    ("prefill chunk", 1, 36, 36, 64, 64, 64, 16, 16, 0, None),
    ("GQA group 4", 4, 36, 9, 1, 64, 64, 16, 16, 0, None),
    ("window 40", 4, 36, 36, 4, 64, 64, 16, 16, 40, None),
    ("MLA-like", 4, 16, 1, 1, 576, 512, 16, 16, 0, 192 ** -0.5),
    ("MLA prefill chunk", 1, 16, 1, 64, 576, 512, 16, 16, 0, 192 ** -0.5),
    ("gemma3 decode", 4, 8, 4, 1, 256, 256, 16, 96, 1024, None),
    ("gemma3 chunk past window", 1, 8, 4, 64, 256, 256, 16, 96, 1024, None),
    ("mixtral GQA 6", 4, 48, 8, 1, 128, 128, 16, 288, 4096, None),
    ("starcoder2 GQA 12", 4, 24, 2, 1, 128, 128, 16, 16, 0, None),
    ("pixtral decode", 4, 32, 8, 1, 128, 128, 16, 32, 0, None),
)
# gemma3's K5 cases run once more zero-padded to d 264 (scale 1/16 as at
# 256), which takes the (576, 512) body that d 256 ran in before its own
# (256, 256) one: the "before" of that body, held to the same plain version.
PAGED_PADDED = 264
HEADLINE_PAGED = ("decode", "bf16")
# The paged workload: 4 slots, max_len 256 in pages of 16, prefill chunks of
# 64; 8 prompts of 16-128 tokens, the even ones behind a shared 64-token
# prefix, the last a copy of the first.
PAGED_SLOTS, PAGED_MAX_LEN, PAGE_SIZE, PREFILL_CHUNK = 4, 256, 16, 64
# Phase fleet: 2-slot replicas behind the router; the fault plans of
# tests/test_serve_router.py (replica 0, seed 3): kind -> (at_dispatch,
# duration). The poison window is stretched from 8 to 24 dispatches: a
# poison fires only on a completion, and with 8 new tokens replica 0's
# first one comes at its 8th dispatch (5 new tokens in the test).
FLEET_SLOTS = 2
FLEET_PLANS = {"raise": (1, 2), "hang": (1, 2), "exhaust": (0, 3),
               "poison": (0, 24)}
# Depth of the paged identity runs (chunk widths, gather vs contiguous) and
# of phase fleet: the first layers of the same weights, to keep the whole
# run short (at 40 layers phase fleet took 121.4-167.6 s, PRs 26-27).
IDENTITY_LAYERS = 8
# K8 checks: (label, BH, S, d, dv, window, causal, dtypes). At BH = 4 x 36,
# d 64 (minicpm-2b's attention at training batch 4), bf16 and f32: S 256 is
# the trained sequence; S 200 leaves a ragged last block. At BH = 2 x 16,
# deepseek-v2-lite-16b's MLA training (batch 2 x 256): d 192 against dv 128,
# bf16 only. At BH 8, gemma3-4b's (256, 256) (training at batch 1), S 128
# and 2048, windows 0, 1024 and 37. At BH = 2 x 12, whisper-small's encoder
# trained at batch 2: non-causal at S 1500, the last block ragged.
FLASH_BWD_CASES = (
    ("S 256", 144, 256, 64, 64, 0, True, BF16_F32),
    ("S 128", 144, 128, 64, 64, 0, True, BF16_F32),
    ("S 200", 144, 200, 64, 64, 0, True, BF16_F32),
    ("window 32", 144, 256, 64, 64, 32, True, BF16_F32),
    ("non-causal", 144, 128, 64, 64, 0, False, BF16_F32),
    ("MLA S 256", 2 * 16, 256, MLA_D, MLA_DV, 0, True, ("bf16",)),
    ("whisper encoder S 1500", 2 * 12, 1500, 64, 64, 0, False, ("bf16",)),
) + tuple((f"gemma3 S {s}{wl}", 8, s, GEMMA_D, GEMMA_D, w, True, ("bf16",))
          for s in (128, 2048) for wl, w in FAMILY_WINDOWS)
HEADLINE_FLASH_BWD = ("S 256", "bf16")
# K9 checks at falcon-mamba-7b's widths, f32 as the Function passes them:
# (label, B, S, di, N, chunk); the trained shape walks two chunks' h_starts,
# S 64 lies below the chunk.
SCAN_BWD_CASES = (
    ("train B 2 S 256", 2, 256, 8192, 16, 128),
    ("B 1 S 128", 1, 128, 8192, 16, 128),
    ("B 1 S 64", 1, 64, 8192, 16, 128),
)
HEADLINE_SCAN_BWD = "train B 2 S 256"
# phase train: (arch, layers, batch, seq). minicpm-2b at its published 40
# layers; falcon-mamba-7b at 48 of its 64: bf16 params and grads and f32
# AdamW moments take 12 B a parameter, 88 GB at 64 layers (7.3 B params),
# more than the card's 80 GB; 48 layers (5.3 B params, ~64 GB) leave room
# for the activations and AdamW's f32 slices.
TRAIN_RUNS = (("minicpm-2b", 40, 4, 256), ("falcon-mamba-7b", 48, 2, 256))
# Depth of the served runs of phases ssm and moe: falcon-mamba-7b at 20 of
# its 64 layers, deepseek-v2-lite-16b at 4 of 27, widths kept, so that the
# whole run, the mesh phases included, stays under its 1200-s limit on a
# card whose host runs slow (at 40 and 8 a run took 1368.1 s on one H100;
# at their published depths 837.9 s before phases encdec and fleet).
SSM_SERVE_LAYERS = 20
MOE_SERVE_LAYERS = 4
# phase moe: deepseek-v2-lite-16b (MLA + MoE) served at its published widths
# (27 layers: 15.7 B parameters, 31 GB in bf16; MOE_SERVE_LAYERS of them
# here), and trained at 10 of 27:
# an MoE layer's bf16 params and grads and f32 AdamW moments take 7.0 GB
# (6.54 GiB), the untied embedding and unembedding 5.0 GB. 9 layers peaked
# at 61.5 GiB on the H100, so 10 (1 dense + 9 MoE) take ~68 GiB and 11 would
# leave under 5 GiB of the card's 79 for the allocator; 27 would need ~188 GB.
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_TRAIN_RUNS = ((MOE_ARCH, 10, 2, 256),)
# phase families: the four LM families served beside minicpm-2b, each at its
# published widths, random weights from --seed, bf16: (arch, short tag,
# depth, max_len, long prompt's length range or None, contiguous variants,
# paged run, training (batch, seq) or None). The depths follow one card's 80
# GB; a served run's peak is about 6.7 B a parameter with FFIP's derived
# copies (bf16 weights, f32 y and its carry table) and 7.6 B in int8 FFIP
# (minicpm-2b's 18.78 and 21.09 GiB for 2.72 B parameters, PERF.md).
# - gemma3-4b (3.88 B params) at all 34 layers, one prompt of 1100-1499
#   tokens (past the local layers' window of 1024: five layers in six then
#   mask inside K4 at prefill and K5 paged), and trained at batch 1 x 1536
#   through K4 + K8 at (256, 256): 3.88 B x 12 B (bf16 params and grads, f32
#   moments) = 47 GB plus activations.
# - mixtral-8x22b at 6 of 56 layers (the run's time; 12 fit): a layer is
#   2.47 B params of experts (4.5 GiB in bf16; the expert einsums are
#   library calls, with no derived copies) and 88 M of attention (0.6 GiB
#   in int8 FFIP). At 12 layers the int8 run with a prompt of 4200-4399
#   tokens (past its window of 4096; a 4 x 4608-row prefill dispatch, ~6
#   GiB of capacity buffers) peaked at 69.5 GiB on the H100; at 13 it
#   peaked at 75.4 GiB of the card's 79.2, and the planted fault's run (a
#   copy of the faulty attn.wo beside the weights) then ran out of memory.
# - starcoder2-3b at 8 of 30 layers (the run's time; at 30, 4.16 B params,
#   it served in 55.2 s of PR 27's run).
# - deepseek-coder-33b at 10 of 62 layers (the run's time; 19 fit): 0.53
#   B params a layer (3.5 GiB in int8 FFIP). At 18 layers the int8 run
#   peaked at 66.3 GiB on the H100, so 19 take ~69.8 GiB and its planted
#   fault's run ~71.6 (a copy of attn.wo); 20 (~75 GiB) is where mixtral's
#   fault run failed.
FAMILY_RUNS = (
    ("gemma3-4b", "gemma3", 34, 1536, (1100, 1500),
     (("ffip", False), ("baseline", False), ("ffip", True)), True, (1, 1536)),
    ("mixtral-8x22b", "mixtral", 6, 4608, (4200, 4400),
     (("ffip", False), ("ffip", True)), True, None),
    ("starcoder2-3b", "starcoder2", 8, 256, None,
     (("ffip", False), ("ffip", True)), True, None),
    ("deepseek-coder-33b", "deepseek-coder", 10, 256, None,
     (("ffip", False), ("ffip", True)), False, None),
)
# phase encdec: whisper-small (the encoder-decoder) at its published 12 + 12
# layers and pixtral-12b (a 256-patch prefix before mistral-nemo's decoder)
# at PIXTRAL_LAYERS of 40, each at its published widths, bf16, random
# weights and stub frontend inputs from --seed. ENCDEC_ROWS rows a batch:
# whisper's 1500 frames and a WHISPER_PROMPT-token decoder prompt, pixtral's
# patches and a PIXTRAL_PROMPT-token prompt. pixtral's layer holds 273 M
# parameters, its untied embeddings 1.34 G; a served run's peak is about 7 B
# a parameter in int8 FFIP (deepseek-coder-33b's 70.6 GiB at 10.5 B), so 32
# layers (10.1 B) would take about 67 GiB of the card's 79; 16 keep the
# run's time. whisper is trained at
# WHISPER_TRAIN: batch 2 x 448 decoder tokens (its decoder's length) over
# 1500 frames.
# phase hybrid: zamba2-1.2b at its published widths and HYBRID_LAYERS of
# its 38 layers (the run's time; at 38, 1.06 B parameters, 2.1 GB in bf16,
# it took 124.4 s of the run), trained at HYBRID_TRAIN (bf16 params and
# grads and f32 AdamW moments: ~13 GB); its gradient reading at 2 groups of
# 6 Mamba2 layers, each with its shared attention block.
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_LAYERS = 20
HYBRID_TRAIN = (2, 256)
HYBRID_GRAD_LAYERS = 12
# phase tune: the M buckets minicpm-2b's served runs dispatch (decode: 4
# slots; bucketed prefill: 4 slots x prompt buckets of 16-128 tokens)
TUNE_M = "4,64,128,256,512"
TUNE_SEQ = "16,32,64,128"
# phase prepare: minicpm-2b at its published widths and 8 of 40 layers
# (0.49 B dense parameters and the 0.28 B tied embedding; ~5 GB of bf16
# weights, int8 codes and y deltas written and loaded), the cut for the
# run's time and the artifact's bytes
PREPARE_LAYERS = 8
# phase dist: tensor parallelism on a (1, DIST_TP) mesh, one process a rank
# (gloo with both ranks on the one card: the sharded computation and its
# collectives, not a multi-card speed). minicpm-2b at DIST_LAYERS of 40
# served float and int8 FFIP, its planted fault, phase prepare's artifact (8
# layers) cut per rank; deepseek-v2-lite-16b at DIST_MOE_LAYERS of 27 (the
# dense first layer and three MoE layers: the phase's time), int8 FFIP in
# both MoE partitions; the tensor-parallel dense layers at minicpm-2b's
# widths (DIST_LAYER_SHAPES: wq / wo, up / gate, down at M 4 and 512).
# DIST_MAX_NEW new tokens a request: a decode step of two ranks sharing the
# card takes 0.5-1 s (each all-reduce waits for both processes' kernels),
# and the readings need the first two. minicpm-2b is cut to 8 layers for
# the run's time, which the sharded scan below needs (at all 40 the phase
# took 82.8-85.5 s on the H100, PERF.md section 6).
DIST_TP = 2
DIST_MAX_NEW = 8
DIST_LAYERS = 8
DIST_MOE_LAYERS = 4
DIST_LAYER_SHAPES = tuple((m, k, n) for m in (4, 512) for k, n in (
    (2304, 2304), (2304, 5760), (5760, 2304)))
# phase dist, the sharded scan (run inside phase hybrid, whose zamba2 runs
# and plain paths it reads against): falcon-mamba-7b at its published widths
# and DIST_SSM_LAYERS of 64 layers (the run's time), zamba2-1.2b at
# HYBRID_LAYERS,
# each served float and int8 FFIP at tp 2, falcon's planted fault (in_proj
# cut contiguously over x | z, the layout bug the halves cut prevents); the
# mixers at both archs' full widths against the whole mixer (B x S of
# DIST_MIXER_CASES: a 4-slot decode step and the longest served prefill),
# and K6 on a rank's half of falcon's d_inner against the whole K6's columns
# (DIST_SCAN_CASES).
DIST_SSM_LAYERS = 8
DIST_MIXER_CASES = ((4, 1), (1, 128))
DIST_SCAN_CASES = ((1, 128), (2, 256))
ENCDEC_ROWS = 4
WHISPER_PROMPT = 32
PIXTRAL_LAYERS = 16
PIXTRAL_PROMPT = 128
WHISPER_TRAIN = (2, 448)
# the served prompt that the long one replaces: odd (not behind the paged
# workload's shared prefix), and not the last (a copy of the first)
LONG_PROMPT_INDEX = 5
TRAIN_STEPS = 8
# AdamW's peak learning rate in phase train (WSD, 2 warmup steps of 8, as
# the launcher schedules minicpm-2b). At AdamWConfig's default (3e-4) the
# random 40-layer minicpm-2b's loss rises over the 8 steps; every run
# repeats that run through the kernels and through the plain path
# (attention_impl="naive") as the witness that the rise is the model's and
# the schedule's, not the kernels' (lr_witness). Eight steps leave no room
# for the thousands of warmup steps a real run takes.
TRAIN_LR = 1e-4
# Gradient bar: the largest per-leaf relative L2 error of one step's
# gradients through the kernels (K4 + K8, K6 + K9) against the plain path
# (plain attention; autograd through the plain f32 recurrence), on the first
# IDENTITY_LAYERS layers of the same weights and batch. Every run prints the
# largest sound reading and the reading of a planted fault (a middle layer's
# output projection taken from the next layer, on the kernel side only) and
# fails if the bar no longer lies between them. Sound readings: up to 0.0200
# (minicpm-2b, attn.wq: bf16 attention rounded in other places) and 0.0221
# (falcon-mamba-7b, ssm.x_proj: K6's y rounded to bf16 where the plain
# recurrence keeps f32); planted faults 0.950 (minicpm) and 1.138 (falcon)
# (H100 readings).
GRAD_BAR = 0.1

_flush_buf = None


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each between its own
    CUDA events, with the 50 MB L2 flushed (a 64 MiB write) before each, as
    the serving loop finds a layer's weights cold."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if warm:
        fn()
    events = []
    for _ in range(reps):
        _flush_buf.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn`` replayed from a CUDA graph, L2 flushed before
    each replay: for a kernel shorter than its wrapper's host work, which a
    pair of events around the call would time instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                      # warm, off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


# The floor of a graph_ms reading: a one-element add_ replayed the same way
# (L2 flushed, events around the replay), read once at the start of phase
# kernels (the least of three readings after a warm one: the card idles
# through the build); the shortest kernels' times are read against it.
_replay_floor_ms = None


def replay_floor_ms(dev) -> float:
    global _replay_floor_ms
    if _replay_floor_ms is None:
        z = torch.zeros(1, device=dev)
        graph_ms(lambda: z.add_(1))
        _replay_floor_ms = min(graph_ms(lambda: z.add_(1)) for _ in range(3))
    return _replay_floor_ms


def timed(fn):
    """(fn's result, its device ms): one call between CUDA events, for the
    plain versions, whose checking call is also their timing."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def reps_for(ms: float) -> int:
    return max(3, min(20, int(300.0 / max(ms, 1e-3))))


def yardstick_ms(fn, replay: bool = False):
    """Time of the library call that computes the same function (by CUDA
    graph replay with ``replay``, as the kernel it stands beside is timed),
    or None where PyTorch has none for these operands (``torch._int_mm``
    refuses some shapes)."""
    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"  (no library yardstick: {str(e).splitlines()[0]})")
        return None
    return graph_ms(fn, 5) if replay else time_ms(fn, 5)


def _err(got: torch.Tensor, want: torch.Tensor):
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d / want.double().abs().clamp_min(1e-6)).max())


def _allclose(got, want, rtol, atol) -> bool:
    return bool(((got.double() - want.double()).abs()
                 <= atol + rtol * want.double().abs()).all())


def gemm_bound(name: str, m: int, k: int, n: int, dtype: str):
    """(bound_ms, bound_by) of one GEMM call: ``costs.kernel_cost`` (each
    input read once: A, then B or, for FFIP, its f32/int32 deltas y and
    their carry table; the f32/int32 output written once; baseline at the
    tensor-core peak of its type, FIP/FFIP in issue slots; int8 beta
    folded)."""
    return kernel_cost(name, m=m, k=k, n=n, dtype=dtype,
                       fold_beta=dtype == "int8").bound_ms()


def ptxas_lines(source: str, key: str):
    """(kernel, "registers, spills") for each kernel of ``source`` whose
    name holds ``key``, from the build's ``-Xptxas -v`` output, demangled
    by c++filt where the toolkit's host has it."""
    from repro_torch.kernels import compat

    out, name = [], None
    for line in compat.build_log.get(source, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            if key in name:
                regs = line.split(":", 1)[1].strip()
                out.append((name, f"{regs}; {spills}"))
            name = None
    try:
        shown = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True,
                               timeout=60).stdout.split("\n")
        out = [(shown[i] or n, v) for i, (n, v) in enumerate(out)]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return out


def check_carry(y: torch.Tensor, carry: torch.Tensor, dtype: str,
                first_ms: float):
    """K3's carry-table kernel on one weight's y against its plain version,
    bit for bit (the same adds in the same order), timed on the card; the
    library yardstick is torch.cumsum over the rows (the table is its every
    32nd column, shifted by one group). ``first_ms``: the memoizing first
    derivation on the host clock."""
    from repro_torch.kernels.ffip_gemm import carry_table, carry_table_plain

    k, n = y.shape
    want, plain_ms = timed(lambda: carry_table_plain(y))
    ok = torch.equal(carry, want)
    abs_err = float((carry.double() - want.double()).abs().max())
    fn = lambda: carry_table(y)                  # noqa: E731
    one = time_ms(fn, 1)
    call_ms = time_ms(fn, reps_for(one), warm=False)
    ms = graph_ms(fn, reps_for(one))
    lib_ms = yardstick_ms(lambda: torch.cumsum(y, 1), replay=True)
    bound_ms, bound_by = kernel_cost("ffip_carry_table", k=k,
                                     n=n).bound_ms()
    print(f"  ffip_carry_table y ({k}, {n}) {y.dtype} -> "
          f"{tuple(carry.shape)} (y {y.numel() * 4 / 2 ** 30:.3f} GiB, "
          f"table {carry.numel() * 4 / 2 ** 30:.3f} GiB) "
          f"{'ok ' if ok else 'BAD'} (bit for bit) "
          f"max_abs={abs_err:.3g}  {ms:.4f} ms (graph replay; {call_ms:.4f} "
          f"ms around the call; first derivation {first_ms:.2f} ms host "
          f"clock)  plain {plain_ms:.3f} ms  cumsum {lib_ms:.4f} ms (graph "
          f"replay)  bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return dict(kernel="ffip_carry_table", k=k, n=n, dtype=dtype, ok=ok,
                max_abs_err=abs_err, max_rel_err=0.0 if ok else float("nan"),
                tol="bit for bit", ms=ms, call_ms=call_ms, first_ms=first_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_gemms(dev):
    """K1-K3 against their plain versions at the main path's shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.baseline_gemm import (baseline_gemm,
                                                   baseline_gemm_plain)
    from repro_torch.kernels.ffip_gemm import (carry_for, ffip_gemm_y,
                                               ffip_gemm_y_plain, y_for)
    from repro_torch.kernels.fip_gemm import fip_gemm, fip_gemm_plain

    for source, key in (("baseline_gemm", "baseline_tc"),
                        ("fip_gemm", "fip_pair_kernel"),
                        ("ffip_gemm", "ffip_pair_kernel"),
                        ("ffip_gemm", "carry_table_kernel")):
        for name, regs in ptxas_lines(source, key):
            print(f"  ptxas {name}: {regs}", flush=True)
    records, carried = [], set()
    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in GEMM_CASES:
        # pairs per plain-version step: its (M, pairs, N) temporaries
        # stay near 64 MiB
        kc = max(1, min(16, (64 << 20) // (m * n * 4)))
        for dtype in ("bf16", "int8"):
            if dtype == "int8":
                a = torch.randint(-128, 128, (m, k), generator=g,
                                  device=dev).to(torch.int8)
                b = torch.randint(-128, 128, (k, n), generator=g,
                                  device=dev).to(torch.int8)
                fold = True
                lib = lambda: torch._int_mm(a, b)     # noqa: E731
            else:
                a = torch.randn((m, k), generator=g, device=dev).to(
                    torch.bfloat16)
                b = (torch.randn((k, n), generator=g, device=dev)
                     / k ** 0.5).to(torch.bfloat16)
                fold = False
                lib = lambda: torch.matmul(a, b)      # noqa: E731
            mac = dict(zip(("bm", "bn", "bk"),
                           ops.choose_blocks(m, n, k, "baseline", a.dtype)))
            blk = dict(zip(("bm", "bn", "bk"),
                           ops.choose_blocks(m, n, k, "ffip")))
            y = y_for(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry = carry_for(y)          # the K3 calls below reuse it
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            if (k, n, dtype) not in carried:
                carried.add((k, n, dtype))
                records.append(check_carry(y, carry, dtype, first_ms))
            calls = {
                "baseline_gemm": (
                    lambda: baseline_gemm(a, b, **mac),
                    lambda: baseline_gemm_plain(a, b, **mac)),
                "fip_gemm": (
                    lambda: fip_gemm(a, b, fold_beta=fold, **blk),
                    lambda: fip_gemm_plain(a, b, fold_beta=fold,
                                           k_chunk=kc, **blk)),
                "ffip_gemm_y": (
                    lambda: ffip_gemm_y(a, y, fold_beta=fold, **blk),
                    lambda: ffip_gemm_y_plain(a, y, fold_beta=fold,
                                              k_chunk=kc, **blk)),
            }
            lib_ms = yardstick_ms(lib, replay=True)
            for name, (kern, plain) in calls.items():
                got = kern()
                torch.cuda.synchronize()
                want, plain_ms = timed(plain)
                abs_err, rel_err = _err(got, want)
                if dtype == "int8":
                    ok, tol = torch.equal(got, want), "exact"
                else:
                    atol = 1e-3 * max(1, k // 64)
                    ok = _allclose(got, want, 1e-4, atol)
                    tol = f"rtol 1e-4 atol {atol:g}"
                one = time_ms(kern, 1)
                call_ms = time_ms(kern, reps_for(one), warm=False)
                ms = graph_ms(kern, reps_for(one))
                bound_ms, bound_by = gemm_bound(name, m, k, n, dtype)
                tiles = mac if name == "baseline_gemm" else blk
                rec = dict(kernel=name, m=m, k=k, n=n, dtype=dtype,
                           tile=(tiles["bm"], tiles["bn"]),
                           fold_beta=fold, ok=ok, max_abs_err=abs_err,
                           max_rel_err=rel_err, tol=tol, ms=ms,
                           call_ms=call_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
                records.append(rec)
                print(f"  {name:13s} M={m:<3d} K={k:<4d} N={n:<6d} "
                      f"{dtype:4s} tile {tiles['bm']}x{tiles['bn']} "
                      f"{'ok ' if ok else 'BAD'} "
                      f"max_abs={abs_err:.3g} max_rel={rel_err:.3g} "
                      f"({tol})  {ms:.4f} ms (call {call_ms:.4f})  "
                      f"plain {plain_ms:.3f} ms  "
                      f"lib {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                      f" ms  bound {bound_ms:.4f} ms ({bound_by})",
                      flush=True)
                del got, want
            del a, b, y, carry
    return records


def ptxas_of(source: str, key: str, inst: str) -> str:
    """The ptxas line (registers; spills) of the kernel of ``source`` whose
    demangled name holds ``key`` and the instantiation text ``inst``, or
    "not built here" when this process found the kernel built."""
    for name, regs in ptxas_lines(source, key):
        if inst in name.replace(" ", ""):
            return regs
    return "not built here"


def flash_inst(d: int, dv: int):
    """(D, DV, bands) of the bf16 body K4 and K8 run at widths (d, dv), as
    the C entries of flash_fwd.cu and flash_bwd.cu dispatch: a narrower
    width runs zero-filled to D; at (256, 256) each query block of K4 and
    of K8's dq pass, and each key block of its dk/dv pass, is two CTAs,
    each a band of the output columns."""
    for D, DV in ((64, 64), (128, 128), (192, 128)):
        if d <= D and dv <= DV:
            return D, DV, 1
    return 256, 256, 2


def sdpa_backend(q, k, v, causal: bool) -> str:
    """The first of SDPA's fused backends (flash, memory-efficient, cuDNN)
    that takes these operands, or why none does; the default call then
    runs it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    why = []
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            torch.cuda.synchronize()
            return name
        except RuntimeError as e:
            why.append(f"{name}: {str(e).splitlines()[0][:80]}")
    return "none (" + "; ".join(why) + ")"


def check_flash(dev):
    """K4 against its plain version at FLASH_CASES, bf16 (tensor cores) and
    f32 (CUDA cores): o within 2**-7 (bf16) or 2e-3 (f32), lse within 2e-3.
    K4 and the library yardstick (scaled_dot_product_attention, a boolean
    mask for the window; the backend that takes MLA's dv != d is named) are
    both timed by CUDA-graph replay, L2 flushed. Bound: q and k (width d),
    v and o (width dv) read or written once and lse written once, against
    2 (d + dv) flops per kept (q, k) pair (the QK and PV products) at the
    bf16 tensor-core peak, or the f32 CUDA-core peak for f32."""
    from repro_torch.kernels.flash_attention import _flash_fwd, _flash_fwd_plain
    import torch.nn.functional as F

    for name, regs in ptxas_lines("flash_fwd", "_tc_kernel"):
        print(f"  ptxas {name}: {regs}", flush=True)
    records = []
    g = torch.Generator(device=dev).manual_seed(1)
    for label, bh, s, d, dv, window, causal, dtypes in FLASH_CASES:
        pos = torch.arange(s, device=dev)
        keep = torch.ones((s, s), dtype=torch.bool, device=dev)
        if causal:
            keep &= pos[:, None] >= pos[None, :]
        if window > 0:
            keep &= (pos[:, None] - pos[None, :]) < window
        pairs = int(keep.sum())
        for dname in dtypes:
            dtype = torch.bfloat16 if dname == "bf16" else torch.float32
            q, k = (torch.randn((bh, s, d), generator=g, device=dev).to(
                dtype) for _ in range(2))
            v = torch.randn((bh, s, dv), generator=g, device=dev).to(dtype)
            kern = lambda: _flash_fwd(q, k, v, window,        # noqa: E731
                                      causal=causal)
            o, lse = kern()
            torch.cuda.synchronize()
            plain = lambda: _flash_fwd_plain(q, k, v, window,  # noqa: E731
                                             causal=causal)
            plain()                               # warm: first-use set-up
            (o_ref, lse_ref), plain_ms = timed(plain)
            o_err, _ = _err(o, o_ref)
            lse_err, _ = _err(lse, lse_ref)
            o_tol = 2 ** -7 if dtype == torch.bfloat16 else 2e-3
            ok = (_allclose(o, o_ref, o_tol, o_tol)
                  and _allclose(lse, lse_ref, 2e-3, 2e-3))
            if window > 0:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q[None], k[None], v[None], attn_mask=keep)
            else:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q[None], k[None], v[None], is_causal=causal)
            wide = dv != d or d > 128
            backend = (sdpa_backend(q[None], k[None], v[None], causal)
                       if wide else None)
            call_ms = time_ms(kern, 20)
            ms = graph_ms(kern)
            lib_ms = yardstick_ms(lib, replay=True)
            bound_ms, bound_by = kernel_cost(
                "flash_fwd", bh=bh, sq=s, sk=s, d=d, dv=dv, dtype=dname,
                window=window, causal=causal).bound_ms()
            rec = dict(kernel="flash_fwd", case=label, bh=bh, s=s, d=d,
                       dv=dv, window=window, causal=causal, dtype=dname,
                       ok=ok, max_abs_err=max(o_err, lse_err), ms=ms,
                       call_ms=call_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by, kept_pairs=pairs * bh,
                       tol=f"o {o_tol:g}, lse 2e-3")
            extra = ""
            if wide:
                D, DV, bands = flash_inst(d, dv)
                inst = f"<{D},{DV},4,{bands}>"
                rec["sdpa_backend"] = backend
                rec["ptxas"] = ptxas_of("flash_fwd", "_tc_kernel", inst)
                extra = (f"  sdpa backend {backend}; ptxas {inst}: "
                         f"{rec['ptxas']}")
            records.append(rec)
            lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
            print(f"  flash_fwd     {label:11s} BH={bh} S={s:<3d} d={d:<3d} "
                  f"dv={dv:<3d} {dname:4s} {'ok ' if ok else 'BAD'} "
                  f"o_err={o_err:.3g} lse_err={lse_err:.3g}  {ms:.4f} ms "
                  f"(graph replay; {call_ms:.4f} ms around the call)  plain "
                  f"{plain_ms:.3f} ms  sdpa {lib_txt}  bound "
                  f"{bound_ms:.5f} ms ({bound_by}){extra}", flush=True)
            del q, k, v, o, lse, o_ref, lse_ref
    return records


def check_flash_refusal(dev) -> list:
    """The f32 flash kernels take d <= 128 and dv == d, the bf16 ones d and
    dv <= 256: at MLA's d 192 / dv 128 and gemma3's 256 in f32, and at d 320
    in bf16, both wrappers must raise (naming ROADMAP queue 2 section A),
    never fall back. Returns what failed to raise."""
    from repro_torch.kernels.flash_attention import _flash_bwd, _flash_fwd

    missed = []
    for d, dv, dtype in ((MLA_D, MLA_DV, torch.float32),
                         (GEMMA_D, GEMMA_D, torch.float32),
                         (320, 320, torch.bfloat16)):
        q = torch.zeros((2, 16, d), device=dev, dtype=dtype)
        v = torch.zeros((2, 16, dv), device=dev, dtype=dtype)
        lse = torch.zeros((2, 16), device=dev)
        for name, call in (("flash_fwd", lambda: _flash_fwd(q, q, v)),
                           ("flash_bwd",
                            lambda: _flash_bwd(q, q, v, v, lse, v))):
            what = f"{name} {str(dtype)[6:]} d {d} dv {dv}"
            try:
                call()
                missed.append(f"{what} was taken")
            except ValueError as e:
                print(f"  {what}: refused ({e})", flush=True)
    return missed


def paged_bound(q, k_pool, v_pool, page_table, lengths, q_start, window):
    """(bound_ms, bound_by) of one K5 call on this call's data
    (``costs.kernel_cost``): bytes are the valid K/V rows (each read once),
    q, o, the table and the two length vectors; operations are 2 (d + dv)
    per kept (q, k) pair and head (the QK and PV products), at the peak for
    the input type (bf16 tensor cores, or the f32 CUDA cores)."""
    b, h, sq, d = q.shape
    _, ps, kv, _ = k_pool.shape
    return kernel_cost(
        "flash_paged", b=b, h=h, sq=sq, d=d, dv=v_pool.shape[-1], kv=kv,
        ps=ps, max_pages=page_table.shape[1],
        dtype="bf16" if q.dtype == torch.bfloat16 else "f32", window=window,
        causal=True, lengths=lengths.cpu().numpy(),
        q_start=q_start.cpu().numpy()).bound_ms()


def check_paged(dev):
    """K5 against its plain version at the paged path's shapes, bf16 and
    f32, under K4's bar (2**-7); rows with no valid key must be exact
    zeros. The yardstick is the page gather (``_paged_view``) of K and V
    plus ``scaled_dot_product_attention`` under a boolean mask: PyTorch has
    no single call for paged attention. K5 and the yardstick are timed by
    CUDA-graph replay (the wrapper's host work is longer than the kernel),
    the time around the call beside."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_paged import (flash_attention_paged,
                                                 flash_attention_paged_plain)
    from repro_torch.models.attention import _paged_view

    for name, regs in ptxas_lines("flash_paged", "flash_paged_"):
        print(f"  ptxas {name}: {regs}", flush=True)
    records = []
    g = torch.Generator(device=dev).manual_seed(2)
    for (label, b, h, kv, sq, d, dv, ps, mp, window,
         scale) in PAGED_CASES:
        for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            n_pages = b * mp
            q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
            kp = torch.randn((n_pages, ps, kv, d), generator=g,
                             device=dev).to(dtype)
            vp = torch.randn((n_pages, ps, kv, dv), generator=g,
                             device=dev).to(dtype)
            pt = torch.randperm(n_pages, generator=g, device=dev).reshape(
                b, mp).to(torch.int32)
            if "prefill chunk" in label:
                lengths = torch.full((b,), 128, device=dev)
                q_start = torch.full((b,), 64, device=dev)
            elif "past window" in label:
                lengths = torch.full((b,), window + 320, device=dev)
                q_start = lengths - sq
            else:
                lengths = torch.randint(17, ps * mp + 1, (b,), generator=g,
                                        device=dev)
                lengths[0] = 0
                q_start = (lengths - sq).clamp_min(0)
            args = (q, kp, vp, pt, lengths, q_start, window)
            kern = lambda: flash_attention_paged(    # noqa: E731
                *args, scale=scale)
            plain = lambda: flash_attention_paged_plain(  # noqa: E731
                *args, scale=scale)
            o = kern()
            torch.cuda.synchronize()
            plain()                               # warm: first-use set-up
            want, plain_ms = timed(plain)
            abs_err, _ = _err(o, want)
            ok = _allclose(o, want, 2 ** -7, 2 ** -7)
            zeros = "n/a"
            if "chunk" not in label:
                zeros = bool(torch.count_nonzero(o[0]) == 0)
                ok = ok and zeros
            k_pos = torch.arange(mp * ps, device=dev)
            q_pos = q_start[:, None] + torch.arange(sq, device=dev)
            diff = q_pos[:, :, None] - k_pos[None, None, :]
            mask = (k_pos[None, None, :] < lengths[:, None, None]) & (diff >= 0)
            if window > 0:
                mask &= diff < window
            mask = mask[:, None]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, _paged_view(kp, pt).transpose(1, 2),
                _paged_view(vp, pt).transpose(1, 2), attn_mask=mask,
                scale=scale, enable_gqa=h != kv)
            call_ms = time_ms(kern, 20)
            ms = graph_ms(kern)
            lib_ms = yardstick_ms(lib, replay=True)
            bound_ms, bound_by = paged_bound(*args)
            records.append(dict(
                kernel="flash_paged", case=label, dtype=dname, b=b, h=h, kv=kv,
                sq=sq, d=d, dv=dv, ps=ps, max_pages=mp, window=window, ok=ok,
                max_abs_err=abs_err, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by,
                tol="2**-7; rows with no valid key exactly 0"))
            print(f"  flash_paged   {label:13s} B={b} H={h} KV={kv} Sq={sq} "
                  f"d={d} dv={dv} w={window} {dname:4s} "
                  f"{'ok ' if ok else 'BAD'} max_abs={abs_err:.3g} zero rows "
                  f"{zeros}  {ms:.4f} ms (graph replay; {call_ms:.4f} ms "
                  f"around the call)  plain {plain_ms:.3f} ms  gather+sdpa "
                  f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms "
                  f"(graph replay)  bound {bound_ms:.5f} ms ({bound_by})  "
                  f"{ms / replay_floor_ms(dev):.2f}x the replay floor",
                  flush=True)
            if label.startswith("gemma3") and dname == "bf16":
                records.append(paged_padded(records[-1], args, want, scale,
                                            d))
            del q, kp, vp, o, want
    return records


def paged_padded(rec: dict, args, want, scale, d: int) -> dict:
    """The same K5 call with q, k and v zero-padded to PAGED_PADDED columns
    (and the scale of d): the (576, 512) body that ran d 256 before the
    (256, 256) one, held to the same plain version; its ms beside the new
    body's. Zero columns add nothing to a score, and the extra output
    columns are dropped."""
    from repro_torch.kernels.flash_paged import flash_attention_paged

    pad = lambda t: torch.nn.functional.pad(  # noqa: E731
        t, (0, PAGED_PADDED - t.shape[-1]))
    q, kp, vp, pt, lengths, q_start, window = args
    padded = (pad(q), pad(kp), pad(vp), pt, lengths, q_start, window)
    sc = d ** -0.5 if scale is None else scale
    kern = lambda: flash_attention_paged(  # noqa: E731
        *padded, scale=sc)[..., :d]
    o = kern()
    torch.cuda.synchronize()
    abs_err, _ = _err(o, want)
    ok = _allclose(o, want, 2 ** -7, 2 ** -7)
    ms = graph_ms(kern)
    out = dict(rec, case=rec["case"] + " (576, 512) body, before", ok=ok,
               max_abs_err=abs_err, ms=ms, call_ms=time_ms(kern, 20),
               padded_to=PAGED_PADDED)
    print(f"  flash_paged   {out['case']}: {'ok ' if ok else 'BAD'} max_abs="
          f"{abs_err:.3g}  {ms:.4f} ms (graph replay) against "
          f"{rec['ms']:.4f} ms in the (256, 256) body", flush=True)
    return out


def conv_bound(algo: str, dtype: str, xp: torch.Tensor, stack: torch.Tensor,
               m: int, k: int, fold_beta: bool):
    """(bound_ms, bound_by) of one K7 call (``costs.kernel_cost``): the
    padded input read once, the weights (FFIP: their f32/int32 deltas) and
    the f32/int32 output once. Baseline: 2 M N K operations (over all
    groups) at the f32 CUDA-core peak (no TF32), or the int8 tensor-core
    peak for int8. FIP/FFIP: issue slots (:func:`pair_counts` per group,
    :func:`pair_ms`)."""
    g, _, ng = stack.shape
    return kernel_cost("conv_gemm", algo=algo, dtype=dtype,
                       x_numel=xp.numel(), groups=g, ng=ng, m=m, k=k,
                       fold_beta=fold_beta).bound_ms()


def check_convs(dev):
    """K7 against its plain version (A gathered through the Algorithm-1
    indices, then the plain K1/K2/K3 per group in K7's blocks) at ResNet-50's
    and AlexNet's conv shapes, batch 8; f32 at the GEMM bar, int8 exact
    (FIP and FFIP with beta folded, as the int8 conv calls them). The
    yardstick is F.conv2d in f32 with TF32 off; PyTorch has no CUDA int8
    convolution, so int8 has none."""
    import torch.nn.functional as F

    from repro_torch.kernels import conv_gemm as cg

    for name, regs in ptxas_lines("conv_gemm", "pair_kernel"):
        print(f"  ptxas {name}: {regs}", flush=True)
    records = []
    g = torch.Generator(device=dev).manual_seed(3)
    for label, h, w, cin, cout, kh, kw, st, pad, groups in CONV_CASES:
        geom = cg.ConvGeom(h=h + 2 * pad, w=w + 2 * pad, cin=cin, kh=kh,
                           kw=kw, sh=st, sw=st, groups=groups,
                           ng=cout // groups)
        m = CONV_BATCH * geom.m
        for dtype in ("f32", "int8"):
            if dtype == "int8":
                x = torch.randint(-128, 128, (CONV_BATCH, h, w, cin),
                                  generator=g, device=dev).to(torch.int8)
                kern = torch.randint(-128, 128, (kh, kw, cin // groups, cout),
                                     generator=g, device=dev).to(torch.int8)
                lib_ms = None
            else:
                x = torch.randn((CONV_BATCH, h, w, cin), generator=g,
                                device=dev)
                kern = torch.randn((kh, kw, cin // groups, cout), generator=g,
                                   device=dev) / geom.k ** 0.5
                lib_ms = yardstick_ms(lambda: F.conv2d(
                    x.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1),
                    stride=st, padding=pad, groups=groups))
            xp = F.pad(x, (0, 0, pad, pad, pad, pad))
            stack = cg._kernel_to_stack(kern, groups)
            for algo in ("baseline", "fip", "ffip"):
                fold = dtype == "int8" and algo != "baseline"
                bg = {"baseline": stack, "fip": cg._evenize_k(stack),
                      "ffip": cg._y_even(stack)}[algo]
                bm, bn, bk = cg.conv_blocks(m, cout // groups, bg.shape[1],
                                            algo, groups)
                kern_fn = lambda: cg.fused_conv_raw(   # noqa: E731
                    xp, stack, kh=kh, kw=kw, stride=st, groups=groups,
                    algo=algo, fold_beta=fold)
                got = kern_fn()
                torch.cuda.synchronize()
                want, plain_ms = timed(lambda: cg.fused_conv_plain(
                    xp, bg, geom, algo=algo, bm=bm, bn=bn, bk=bk,
                    fold_beta=fold))
                abs_err, rel_err = _err(got, want)
                if dtype == "int8":
                    ok, tol = torch.equal(got, want), "exact"
                else:
                    atol = 1e-3 * max(1, geom.k // 64)
                    ok = _allclose(got, want, 1e-4, atol)
                    tol = f"rtol 1e-4 atol {atol:g}"
                one = time_ms(kern_fn, 1)
                ms = time_ms(kern_fn, reps_for(one), warm=False)
                bound_ms, bound_by = conv_bound(algo, dtype, xp, bg, m,
                                                geom.k, fold)
                records.append(dict(
                    kernel="conv_gemm", case=label, algo=algo, dtype=dtype,
                    batch=CONV_BATCH, m=m, k=geom.k, n=cout, groups=groups,
                    tile=f"{bm}x{bn}",
                    fold_beta=fold, ok=ok, max_abs_err=abs_err,
                    max_rel_err=rel_err, tol=tol, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by))
                lib = ("none (no CUDA int8 conv)" if lib_ms is None
                       else f"{lib_ms:.4f} ms")
                print(f"  conv_gemm     {label:17s} M={m:<6d} K={geom.k:<4d} "
                      f"N={cout:<4d} g{groups} {algo:8s} {dtype:4s} "
                      f"{bm}x{bn} "
                      f"{'ok ' if ok else 'BAD'} max_abs={abs_err:.3g} "
                      f"({tol})  {ms:.4f} ms  plain {plain_ms:.3f} ms  "
                      f"conv2d {lib}  bound {bound_ms:.4f} ms ({bound_by})",
                      flush=True)
                del got, want
            del x, kern, xp, stack
    return records


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              atol: float = 0.0) -> float:
    """Largest |got - want| beyond ``atol`` in units of the bf16 spacing at
    ``want`` (2**(e - 7) for |want| in [2**e, 2**(e + 1))). K8 passes its f32
    bar's atol: a gradient that cancels to near 0 is noise at that floor in
    either type."""
    _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), e - 8)
    excess = ((got.float() - want.float()).abs() - atol).clamp_min(0)
    return float((excess / ulp).max())


def scan_bound(bt: int, s: int, di: int, n: int, chunk: int, elt: int):
    """(bound_ms, bound_by) of one K6 call (``costs.kernel_cost``): x, dt,
    B, C read once and y written once in the input type; A, h0, h_final and
    the h_starts checkpoints in f32; against the S di N exponentials at
    SFU_EXP_S (the recurrence's other five f32 operations per state and
    step take a third of that time at the CUDA-core peak)."""
    return kernel_cost("selective_scan", bt=bt, s=s, di=di, n=n,
                       chunk=chunk, dtype={2: "bf16", 4: "f32"}[elt]
                       ).bound_ms()


# K6's instructions, counted from its loops (csrc/selective_scan.cu), per
# (t, d, n): in the step loop the accurate expf's 8, dt a, (dt x) b, the h
# update's multiply and add and h c (13), one shared store of the thread's
# products a step, and a 16-byte shared load of (dt, dt x) a channel every
# two steps and of (b, c) for every two (step, state)s; per (t, d) in the
# sum over N, N / 4 16-byte shared loads, N - 1 adds, and the rounding,
# address and store of y (3).
SCAN_FWD_STEP_INSTR = 13
SCAN_FWD_Y_INSTR = 3


def scan_fwd_instr(spt: int, n: int) -> float:
    """K6's instructions a (t, d, n) at ``spt`` states a thread."""
    step = SCAN_FWD_STEP_INSTR + 1 / spt + 1 / (2 * spt) + 1 / 2
    return step + (n / 4 + n - 1 + SCAN_FWD_Y_INSTR) / n


def scan_fwd_issue_ms(bt: int, s: int, di: int, n: int, spt: int) -> float:
    """K6's issue-slot floor: :func:`scan_fwd_instr` over every (t, d, n),
    a warp instruction for 32 of them, at one warp instruction a clock on
    each of the 4 schedulers of the 132 SMs at the boost clock."""
    return (bt * s * di * n * scan_fwd_instr(spt, n) / 32
            / (4 * 132 * BOOST_CLOCK_HZ) * 1e3)


def check_scan(dev, served_lengths):
    """K6 against its plain version (SCAN_CASES, and falcon-mamba-7b's
    prefill at each of ``served_lengths``): y, h_final and h_starts equal
    to the plain version's bit for bit (the same rounded products and sums
    in the same order), beside the earlier bars, which stay: h_final and
    h_starts within rtol = atol = 1e-4 of the plain f32 values (the bar
    tests/test_selective_scan.py holds the reference kernel to), y within
    one bf16 ulp in bf16 and 1e-4 in f32. Then a state carried across two
    128-step calls must equal one 256-step call bit for bit. PyTorch has no
    call that computes a selective scan, so there is no library
    yardstick; the issue-slot floor (:func:`scan_fwd_issue_ms`) stands
    beside the bound, and the graph-replay floor beside the time."""
    from repro_torch.kernels.selective_scan import (scan_plan,
                                                    selective_scan,
                                                    selective_scan_plain)

    for name, regs in ptxas_lines("selective_scan", "selective_scan_kernel"):
        print(f"  ptxas {name}: {regs}", flush=True)
    floor = replay_floor_ms(dev)
    records = []
    g = torch.Generator(device=dev).manual_seed(5)

    def operands(bt, s, di, n, dtype, h0_scale):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)
        x = rnd(bt, s, di).to(dtype)
        dt = torch.nn.functional.softplus(rnd(bt, s, di) - 1).to(dtype)
        b, c = rnd(bt, s, n).to(dtype), rnd(bt, s, n).to(dtype)
        a = -torch.exp(rnd(di, n) * 0.3)
        return x, dt, b, c, a, rnd(bt, di, n) * h0_scale

    served = tuple((f"served S {s}", 1, s, 8192, 16, 128, "bf16", 0.0)
                   for s in sorted(set(served_lengths)))
    for label, bt, s, di, n, chunk, dname, h0_scale in SCAN_CASES + served:
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        args = operands(bt, s, di, n, dtype, h0_scale)
        kern = lambda: selective_scan(*args, chunk=chunk)     # noqa: E731
        y, h, starts = kern()
        torch.cuda.synchronize()
        plain = lambda: selective_scan_plain(*args, chunk=chunk)  # noqa: E731
        plain()                                   # warm: first-use set-up
        (y_ref, h_ref, starts_ref), plain_ms = timed(plain)
        state_ok = (_allclose(h, h_ref, 1e-4, 1e-4)
                    and _allclose(starts, starts_ref, 1e-4, 1e-4))
        if dtype == torch.bfloat16:
            y_err = bf16_ulps(y, y_ref)
            y_ok, tol = y_err <= 1.0, "y 1 bf16 ulp, h rtol=atol=1e-4"
            y_txt = f"y {y_err:.2f} ulp"
        else:
            y_ok, tol = _allclose(y, y_ref, 1e-4, 1e-4), "rtol=atol=1e-4"
            y_txt = f"y max_abs {_err(y, y_ref)[0]:.3g}"
        state_err = max(_err(h, h_ref)[0], _err(starts, starts_ref)[0])
        abs_err = max(_err(y, y_ref)[0], state_err)
        exact = sum(int(torch.equal(p, q)) for p, q in
                    ((y, y_ref), (h, h_ref), (starts, starts_ref)))
        ok = y_ok and state_ok and exact == 3
        call_ms = time_ms(kern, 20)
        ms = graph_ms(kern)
        bound_ms, bound_by = scan_bound(bt, s, di, n, chunk,
                                        y.element_size())
        plan = scan_plan(bt, di, n)
        issue_ms = scan_fwd_issue_ms(bt, s, di, n, plan.states)
        records.append(dict(kernel="selective_scan", case=label, b=bt, s=s,
                            di=di, n=n, chunk=chunk, dtype=dname, ok=ok,
                            exact_outputs=exact, max_abs_err=abs_err, ms=ms,
                            call_ms=call_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, tol=f"bit for bit; {tol}"))
        print(f"  selective_scan {label:13s} B={bt} S={s:<3d} di={di} N={n} "
              f"chunk {chunk} {dname:4s} {'ok ' if ok else 'BAD'} "
              f"{exact}/3 bit for bit (y, h_final, h_starts); {y_txt}, "
              f"h/h_starts max_abs {state_err:.3g} ({tol})  {ms:.4f} ms "
              f"(graph replay, {ms / floor:.2f}x its floor; {call_ms:.4f} "
              f"ms around the call)  plain {plain_ms:.3f} ms  library none  "
              f"bound {bound_ms:.5f} ms ({bound_by})  issue floor "
              f"{issue_ms:.4f} ms ({plan.states} state(s) a thread, "
              f"{plan.warps_per_sm:.2f} warps an SM)", flush=True)
        del args, y, h, starts, y_ref, h_ref, starts_ref
    # a state carried across two calls equals one call
    x, dt, b, c, a, h0 = operands(1, 256, 8192, 16, torch.bfloat16, 0.1)
    whole = selective_scan(x, dt, b, c, a, h0)
    parts = [selective_scan(x[:, :128].contiguous(), dt[:, :128].contiguous(),
                            b[:, :128].contiguous(), c[:, :128].contiguous(),
                            a, h0)]
    parts.append(selective_scan(
        x[:, 128:].contiguous(), dt[:, 128:].contiguous(),
        b[:, 128:].contiguous(), c[:, 128:].contiguous(), a, parts[0][1]))
    torch.cuda.synchronize()
    same = (torch.equal(torch.cat([parts[0][0], parts[1][0]], 1), whole[0])
            and torch.equal(parts[1][1], whole[1])
            and torch.equal(torch.cat([parts[0][2], parts[1][2]], 1),
                            whole[2]))
    print(f"  selective_scan carried state: two calls of 128 steps vs one of "
          f"256 (y, h_final, h_starts): {'identical' if same else 'DIFFER'}",
          flush=True)
    records.append(dict(kernel="selective_scan", case="carried state", b=1,
                        s=256, di=8192, n=16, chunk=128, dtype="bf16",
                        ok=same, max_abs_err=0.0 if same else float("nan"),
                        tol="bit for bit"))
    return records


def flash_bwd_bound(bh: int, s: int, d: int, window: int, causal: bool,
                    dtype: str, dv: int = 0):
    """(bound_ms, bound_by) of one K8 call (``costs.kernel_cost``): q and k
    (width d), v, o and do (width dv) read once in their type and lse in
    f32; dq, dk (width d) and dv written once in f32; against 6 d + 4 dv
    flops per kept (q, k) pair at the bf16 tensor-core peak."""
    return kernel_cost("flash_bwd", bh=bh, sq=s, sk=s, d=d, dv=dv or d,
                       dtype=dtype, window=window, causal=causal).bound_ms()


def check_flash_bwd(dev):
    """K8 against its plain version (FLASH_BWD_CASES, bf16 and f32): the
    f32 dq, dk, dv within rtol 1e-4, atol 1e-4 * max|plain| (the same
    products summed in another block order); the outputs cast to bf16, as
    the Function casts them for bf16 inputs, within one bf16 ulp beyond that
    atol (a row that keeps one key has dp - delta = 0 up to the order of two
    sums: its dq is ~1e-8 in the plain version and 0 in the kernel). o and lse
    come from K4. K8 and the library yardstick (``sdpa_backward``) are both
    timed by CUDA-graph replay. At MLA's d 192 / dv 128 the passes' ptxas
    registers and spills print beside the time."""
    from repro_torch.kernels.flash_attention import (_flash_bwd,
                                                     _flash_bwd_plain,
                                                     _flash_fwd)

    for name, regs in ptxas_lines("flash_bwd", "_tc_kernel"):
        print(f"  ptxas {name}: {regs}", flush=True)
    records = []
    g = torch.Generator(device=dev).manual_seed(11)
    for label, bh, s, d, dv, window, causal, dtypes in FLASH_BWD_CASES:
        pos = torch.arange(s, device=dev)
        keep = torch.ones((s, s), dtype=torch.bool, device=dev)
        if causal:
            keep &= pos[:, None] >= pos[None, :]
        if window > 0:
            keep &= (pos[:, None] - pos[None, :]) < window
        pairs = int(keep.sum())
        for dname in dtypes:
            dtype = torch.bfloat16 if dname == "bf16" else torch.float32
            q, k = (torch.randn((bh, s, d), generator=g, device=dev).to(dtype)
                    for _ in range(2))
            v, do = (torch.randn((bh, s, dv), generator=g,
                                 device=dev).to(dtype) for _ in range(2))
            o, lse = _flash_fwd(q, k, v, window, causal=causal)
            kern = lambda: _flash_bwd(q, k, v, o, lse, do, window,  # noqa
                                      causal=causal)
            got = kern()
            torch.cuda.synchronize()
            plain = lambda: _flash_bwd_plain(q, k, v, o, lse, do,   # noqa
                                             window, causal=causal)
            plain()                               # warm: first-use set-up
            want, plain_ms = timed(plain)
            errs = [_err(a, b)[0] for a, b in zip(got, want)]
            atols = [1e-4 * float(b.abs().max()) for b in want]
            ok = all(_allclose(a, b, 1e-4, t)
                     for a, b, t in zip(got, want, atols))
            ulps = max(bf16_ulps(a.to(torch.bfloat16), b.to(torch.bfloat16),
                                 atol=t)
                       for a, b, t in zip(got, want, atols))
            ok = ok and ulps <= 1.0
            call_ms = time_ms(kern, 20)
            ms = graph_ms(kern)
            bias = None
            if window > 0:
                bias = torch.zeros((s, s), dtype=dtype, device=dev)
                bias = bias.masked_fill(~keep, float("-inf"))[None, None]
                bias = bias.expand(1, bh, s, s)
            lib_op, lib_ms, lib_err = sdpa_backward(
                q, k, v, do, bias, causal and window <= 0, want[0])
            bound_ms, bound_by = flash_bwd_bound(bh, s, d, window, causal,
                                                 dname, dv)
            rec = dict(kernel="flash_bwd", case=label, bh=bh, s=s, d=d,
                       dv=dv, window=window, causal=causal, dtype=dname,
                       ok=ok, max_abs_err=max(errs), bf16_ulps=ulps, ms=ms,
                       call_ms=call_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library_op=lib_op,
                       bound_ms=bound_ms, bound_by=bound_by,
                       kept_pairs=pairs * bh,
                       tol="rtol 1e-4, atol 1e-4 max|plain|; bf16 cast 1 "
                           "ulp beyond that atol")
            extra = ""
            if dv != d or d > 128:
                inst = "<%d,%d,%d>" % flash_inst(d, dv)
                rec["ptxas"] = {
                    p_: ptxas_of("flash_bwd", f"flash_bwd_{p_}_tc_kernel",
                                 inst) for p_ in ("dq", "dkdv")}
                extra = "  ptxas " + "; ".join(
                    f"{k_} {inst}: {v_}" for k_, v_ in
                    rec["ptxas"].items())
            records.append(rec)
            print(f"  flash_bwd     {label:10s} BH={bh} S={s:<3d} d={d} "
                  f"dv={dv} {dname:4s} {'ok ' if ok else 'BAD'} dq/dk/dv "
                  f"max_abs {max(errs):.3g}, bf16 cast {ulps:.2f} ulp  "
                  f"{ms:.4f} ms (graph replay; {call_ms:.4f} ms around the "
                  f"call)  plain {plain_ms:.3f} ms  {lib_op} {lib_ms} ms "
                  f"(its dq off the plain by {lib_err})  bound "
                  f"{bound_ms:.5f} ms ({bound_by}){extra}", flush=True)
            del q, k, v, do, o, lse, got, want, bias
    return records


def sdpa_backward(q, k, v, do, bias, is_causal: bool, plain_dq):
    """(op, ms, max |dq - plain dq|) of scaled_dot_product_attention's own
    backward kernel, called directly on the saved outputs of its forward at
    (1, BH, S, d), as SDPA picks them: flash attention's for bf16 with no
    mask and v of q's width, memory-efficient attention's for f32, a mask
    (an additive bias) or dv != d. Timed alone by CUDA-graph replay; (op,
    None, None) where the call is refused."""
    aten = torch.ops.aten
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    try:
        if (q.dtype == torch.bfloat16 and bias is None
                and v.shape[-1] == q.shape[-1]):
            op = "flash_attention_backward"
            o, lse, cq, ck, mq, mk, seed, off = \
                aten._scaled_dot_product_flash_attention(
                    q4, k4, v4, 0.0, is_causal)[:8]

            def bwd():
                return aten._scaled_dot_product_flash_attention_backward(
                    do4, q4, k4, v4, o, lse, cq, ck, mq, mk, 0.0, is_causal,
                    seed, off)
        else:
            op = "efficient_attention_backward"
            o, lse, seed, off = aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, bias, True, 0.0, is_causal)

            def bwd():
                return aten._scaled_dot_product_efficient_attention_backward(
                    do4, q4, k4, v4, bias, o, lse, seed, off, 0.0,
                    [True, True, True, False], is_causal)
        dq = bwd()[0][0]
        torch.cuda.synchronize()
        err = float((dq.double() - plain_dq.double()).abs().max())
        return op, graph_ms(bwd), err
    except (RuntimeError, TypeError) as e:
        print(f"  (no library yardstick: {str(e).splitlines()[0]})")
        return "sdpa backward", None, None


def scan_bwd_bound(bt: int, s: int, di: int, n: int, chunk: int):
    """(bound_ms, bound_by) of one K9 call, all f32 (``costs.kernel_cost``):
    x, dt, dy, B, C, A and h_starts read once; dx, ddt, the summed dB, dC
    and dA written once; against the S di N exponentials the function needs
    at SFU_EXP_S: one exp(dt A) per (t, d, n) serves both the recomputed h_t
    and the adjoint's dh_{t-1} (K9 itself takes each twice: its passes 1
    and 2)."""
    return kernel_cost("selective_scan_bwd", bt=bt, s=s, di=di, n=n,
                       chunk=chunk).bound_ms()


# K9's instructions per (t, d, n), counted from its source loops: each
# forward step 12 (the accurate expf's 8, dt A, (dt x) b, the h update's
# multiply and add), run by pass 1 on all but a chunk's last sub-tile and by
# pass 2 on every step; the adjoint 13 products and sums, 7 for the
# reduce-scatter channel tree of dB and dC (28 a step over 4 states), and 3
# for the step's shared work (the sums over N, dx and ddt, the loads).
SCAN_BWD_FWD_INSTR = 12
SCAN_BWD_ADJ_INSTR = 13 + 7 + 3


def scan_bwd_issue_ms(bt: int, s: int, di: int, n: int, chunk: int) -> float:
    """K9's issue-slot floor: its instructions (SCAN_BWD_FWD_INSTR,
    SCAN_BWD_ADJ_INSTR) over every (t, d, n), a warp instruction for 32 of
    them, at one warp instruction a clock on each of the 4 schedulers of the
    132 SMs at the boost clock."""
    chunk = min(chunk, s)
    ts = 128 // n                       # the steps of a sub-tile
    n_sub = -(-chunk // ts)
    pass1 = (n_sub - 1) / n_sub         # pass 1 skips the last sub-tile
    per = SCAN_BWD_FWD_INSTR * (1 + pass1) + SCAN_BWD_ADJ_INSTR
    return bt * s * di * n * per / 32 / (4 * 132 * BOOST_CLOCK_HZ) * 1e3


def check_scan_bwd(dev):
    """K9 against its plain version (SCAN_BWD_CASES): dx, ddt, dB, dC and
    dA equal to the plain f32 values bit for bit (both recompute h from
    K6's h_starts with K6's rounding and sum in the same orders); fewer than
    5 of 5 equal fails. No PyTorch call computes a selective-scan backward:
    no library yardstick."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_bwd,
                                                    selective_scan_bwd_plain)

    for name, regs in ptxas_lines("selective_scan_bwd", "scan_bwd"):
        print(f"  ptxas {name}: {regs}", flush=True)
    records = []
    g = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for label, bt, s, di, n, chunk in SCAN_BWD_CASES:
        x = rnd(bt, s, di)
        dt = torch.nn.functional.softplus(rnd(bt, s, di) - 1)
        b, c = rnd(bt, s, n), rnd(bt, s, n)
        a = -torch.exp(rnd(di, n) * 0.3)
        dy = rnd(bt, s, di)
        h0 = torch.zeros((bt, di, n), device=dev)
        _, _, starts = selective_scan(x, dt, b, c, a, h0, chunk=chunk)
        args = (x, dt, b, c, a, starts, dy)
        kern = lambda: selective_scan_bwd(*args, chunk=chunk)   # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        plain = lambda: selective_scan_bwd_plain(*args, chunk=chunk)  # noqa
        plain()
        want, plain_ms = timed(plain)
        exact = sum(int(torch.equal(p, q)) for p, q in zip(got, want))
        ok = exact == 5
        abs_err = max(_err(p, q)[0] for p, q in zip(got, want))
        call_ms = time_ms(kern, 20)
        ms = graph_ms(kern)
        bound_ms, bound_by = scan_bwd_bound(bt, s, di, n, chunk)
        issue_ms = scan_bwd_issue_ms(bt, s, di, n, chunk)
        records.append(dict(kernel="selective_scan_bwd", case=label, b=bt,
                            s=s, di=di, n=n, chunk=chunk, dtype="f32", ok=ok,
                            exact_outputs=exact, max_abs_err=abs_err, ms=ms,
                            call_ms=call_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, tol="bit for bit"))
        print(f"  selective_scan_bwd {label:15s} B={bt} S={s:<3d} di={di} "
              f"N={n} chunk {min(chunk, s)} f32 {'ok ' if ok else 'BAD'} "
              f"dx/ddt/dB/dC/dA max_abs {abs_err:.3g}, {exact}/5 bit for bit"
              f"  {ms:.4f} ms (graph replay; {call_ms:.4f} "
              f"ms around the call)  plain {plain_ms:.3f} ms  library none  "
              f"bound {bound_ms:.5f} ms ({bound_by})  issue floor "
              f"{issue_ms:.4f} ms", flush=True)
        del x, dt, b, c, a, dy, starts, args, got, want
    return records


def check_batch_invariance(dev):
    """Bit for bit: rows 0-3 of an M = 512 K1/K2/K3 call against the same
    rows at M = 4, 64 and 256 (f32 and bf16, at the served (K, N) pairs),
    rows 0-3 of falcon-mamba-7b's in_proj (K 4096, N 16384) at M = 128
    against M = 1, 4 and 16 (row 0 at M = 1), and image 0 of a batch-8 K7
    call against the batch-1 call (f32, the three algos, ResNet-50's
    s2b1.c2). Returns the failures."""
    from repro_torch.kernels import conv_gemm as cg
    from repro_torch.kernels import ops
    from repro_torch.kernels.baseline_gemm import baseline_gemm
    from repro_torch.kernels.ffip_gemm import ffip_gemm_y, y_for
    from repro_torch.kernels.fip_gemm import fip_gemm

    bad = []
    g = torch.Generator(device=dev).manual_seed(7)
    for m_full, k, n, ms in ((512, 2304, 5760, (4, 64, 256)),
                             (512, 5760, 2304, (4, 64, 256)),
                             (128, 4096, 16384, (1, 4, 16))):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((m_full, k), generator=g, device=dev).to(dtype)
            b = (torch.randn((k, n), generator=g, device=dev)
                 / k ** 0.5).to(dtype)
            y = y_for(b)

            def blk(rows, algo):
                return dict(zip(("bm", "bn", "bk"),
                                ops.choose_blocks(rows, n, k, algo, dtype)))
            fns = {"baseline_gemm": lambda a_: baseline_gemm(
                       a_, b, **blk(len(a_), "baseline")),
                   "fip_gemm": lambda a_: fip_gemm(
                       a_, b, **blk(len(a_), "fip")),
                   "ffip_gemm_y": lambda a_: ffip_gemm_y(
                       a_, y, **blk(len(a_), "ffip"))}
            for name, fn in fns.items():
                full = fn(a)[:4]
                same = {m: torch.equal(fn(a[:m].contiguous())[:4],
                                       full[:min(m, 4)])
                        for m in ms}
                print(f"  batch invariance {name:13s} K={k} N={n} "
                      f"{str(dtype)[6:]:8s} rows 0-3 at M={m_full} vs "
                      f"M={'/'.join(map(str, ms))}: "
                      f"{'identical' if all(same.values()) else same}",
                      flush=True)
                if not all(same.values()):
                    bad.append(f"{name} K={k} N={n} {dtype}: {same}")
            del a, b, y
    label, h, w, cin, cout, kh, kw, st, pad, groups = CONV_CASES[1]
    x = torch.randn((CONV_BATCH, h, w, cin), generator=g, device=dev)
    kern = torch.randn((kh, kw, cin, cout), generator=g, device=dev) / 24.0
    for algo in ("baseline", "fip", "ffip"):
        full = cg.conv_gemm_fused(x, kern, stride=st, pad=pad, algo=algo)
        one = cg.conv_gemm_fused(x[:1].contiguous(), kern, stride=st,
                                 pad=pad, algo=algo)
        same = torch.equal(full[:1], one)
        print(f"  batch invariance conv_gemm     {label} {algo:8s} f32 image 0 "
              f"of batch {CONV_BATCH} vs batch 1: "
              f"{'identical' if same else 'DIFFER'}", flush=True)
        if not same:
            bad.append(f"conv_gemm {label} {algo}: image 0 differs")
    return bad


@contextlib.contextmanager
def plain_scan():
    """The Mamba1 mixer calls K6's plain version instead of the kernel while
    this is open (the plain path's counterpart of plain attention)."""
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.models import ssm

    ssm.ssk = types.SimpleNamespace(selective_scan=ssk.selective_scan_plain)
    try:
        yield
    finally:
        ssm.ssk = ssk


@contextlib.contextmanager
def plain_flash():
    """The attention layers call K4's, K8's and K5's plain versions instead
    of the kernels while this is open, whatever the device (the plain path
    of the MLA model: its attention in the formulation the kernels compute,
    where attention_impl="naive" would run the absorbed decode's algebra on
    the prompt, another rounding of the same function). The flash Function
    keeps its shape: the plain forward, and the plain backward under
    autograd."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_paged as fp
    from repro_torch.models import attention as A

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, window, causal):
            o, lse = fa._flash_fwd_plain(q, k, v, window, causal=causal)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.window, ctx.causal = int(window), bool(causal)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            dq, dk, dv = fa._flash_bwd_plain(q, k, v, o, lse, do.contiguous(),
                                             ctx.window, causal=ctx.causal)
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None

    def flash(q, k, v, window=0, causal=True):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return PlainFlash.apply(q, k, v, window, causal)
        return fa._flash_fwd_plain(q, k, v, window, causal=causal)[0]

    saved = A.flash_attention, A.flash_attention_paged
    A.flash_attention = flash
    A.flash_attention_paged = fp.flash_attention_paged_plain
    try:
        yield
    finally:
        A.flash_attention, A.flash_attention_paged = saved


@contextlib.contextmanager
def routing(recorded=None):
    """The MoE routers' expert choices while this is open. Without
    ``recorded`` each top-k (in call order) is kept in the yielded list;
    with it, each top-k returns the recorded experts instead, their
    probabilities gathered from this forward's own router. So two forwards
    of the same weights and batch can be compared with the same discrete
    choices: a near-tie between the 6th and 7th of 64 experts flips on a
    bf16 difference anywhere upstream and moves every later gradient of
    that token, which is routing, not arithmetic."""
    from repro_torch.models import moe

    orig, calls = moe.top_k, []
    replay = iter(recorded) if recorded is not None else None

    def record(probs, k):
        vals, idx = orig(probs, k)
        calls.append(idx)
        return vals, idx

    def fixed(probs, k):
        idx = next(replay)
        return torch.gather(probs, -1, idx), idx

    moe.top_k = record if recorded is None else fixed
    try:
        yield calls
    finally:
        moe.top_k = orig
    if replay is not None and next(replay, None) is not None:
        raise RuntimeError("the replayed forward routed fewer times than "
                           "the recorded one")


class PlainPath:
    """The plain path on one prompt set: torch.matmul (float) or the plain
    int8 algebra, plain attention and the plain selective scan, one prompt
    at a time. It keeps each prompt's prefill logits and cache, so that a
    decode step fed a served first token gives the plain logits of the
    served second token. With ``kernels_plain`` the attention keeps the
    model's own formulation and runs the flash kernels' plain versions
    (``plain_flash``) instead of attention_impl="naive"."""

    def __init__(self, model, params, prompts, quantized: bool,
                 kernels_plain: bool = False):
        from repro_torch.core.gemm import GemmConfig
        from repro_torch.core.quant import attach_quantized_weights
        from repro_torch.models.model import Model

        self.kernels_plain = kernels_plain
        self.model = Model(model.cfg if kernels_plain else dataclasses.replace(
            model.cfg, attention_impl="naive"), device=model.device)
        self.gemm = (GemmConfig(algo="ffip", impl="torch", quantized=True,
                                k_chunk=64)
                     if quantized else GemmConfig(algo="baseline",
                                                  impl="torch"))
        self.params = (attach_quantized_weights(params) if quantized
                       else params)
        self.lens = [len(p) for p in prompts]
        self.first, self.caches = [], []
        self._second = {}
        with self._scope():
            for prompt in prompts:
                tok = torch.as_tensor(prompt, device=model.device)[None]
                cache, logits = self.model.prefill(
                    self.params, tok, self.model.init_cache(1, len(prompt) + 1))
                self.first.append(logits[0].float())
                self.caches.append(cache)

    def _scope(self):
        from repro_torch.core.gemm import use_gemm
        stack = contextlib.ExitStack()
        stack.enter_context(use_gemm(self.gemm))
        stack.enter_context(torch.no_grad())
        stack.enter_context(plain_scan())
        if self.kernels_plain:
            stack.enter_context(plain_flash())
        return stack

    def second(self, rid: int, first_tok: int) -> torch.Tensor:
        """Plain logits after the prompt and ``first_tok``, kept per
        (request, token): the served runs mostly agree on first tokens.
        Each call decodes from a copy of the prompt's cache: a K/V row would
        merely be rewritten, but an SSM state is advanced in place."""
        key = (rid, first_tok)
        if key not in self._second:
            tok = torch.tensor([[first_tok]], device=self.model.device)
            cache = _tree_clone(self.caches[rid])
            with self._scope():
                _, logits = self.model.decode_step(self.params, tok, cache,
                                                   self.lens[rid])
            self._second[key] = logits[0].float()
        return self._second[key]


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def kernel_deviation(model, params, prompts, plain: PlainPath,
                     algo: str):
    """Per prompt, max |logit| difference between a prefill through the
    kernels (the prompt alone) and the plain path, in standard deviations
    of the plain logits: the noise a float token reading sits in."""
    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.kernels import compat

    out = []
    with use_gemm(GemmConfig(algo=algo, impl="cuda")), torch.no_grad(), \
            compat.use_derived(compat.DerivedCache()):
        for i, prompt in enumerate(prompts):
            tok = torch.as_tensor(prompt, device=model.device)[None]
            _, logits = model.prefill(params, tok,
                                      model.init_cache(1, len(prompt) + 1))
            ref = plain.first[i]
            out.append(float((logits[0].float() - ref).abs().max()
                             / ref.std()))
    return out


def shortfall(logits: torch.Tensor, tok: int) -> float:
    """How far below the plain logits' max the served token's plain logit
    is, in standard deviations of those logits (0 when it is the argmax)."""
    return float((logits.max() - logits[tok]) / logits.std())


def token_readings(done, plain: PlainPath):
    """(first tokens equal to the plain argmax, worst first-token shortfall,
    worst second-token shortfall, with the plain decode step fed the served
    first token)."""
    exact, first, second = 0, 0.0, 0.0
    for r in done:
        lg = plain.first[r.rid]
        exact += int(r.out_tokens[0] == int(lg.argmax()))
        first = max(first, shortfall(lg, r.out_tokens[0]))
        second = max(second, shortfall(plain.second(r.rid, r.out_tokens[0]),
                                       r.out_tokens[1]))
    return exact, first, second


def _with_leaf(tree, path, leaf):
    """A copy of ``tree`` with the leaf at ``path`` (a key path) replaced;
    the dicts along the path are copied, everything else shared."""
    if not path:
        return leaf
    out = dict(tree)
    out[path[0]] = _with_leaf(tree[path[0]], path[1:], leaf)
    return out


def next_layer_fault(params, paths, n_layers: int):
    """(label, params) with a middle layer of each stacked weight at
    ``paths`` taken from the next layer: a fault every token check must
    see."""
    mid = (n_layers - 1) // 2
    for path in paths:
        w = params
        for k in path:
            w = w[k]
        bad = w.clone()
        bad[mid] = w[mid + 1]
        params = _with_leaf(params, path, bad)
    names = " and ".join(".".join(p[:-1]).removeprefix("layers.")
                         for p in paths)
    return f"{names} of layer {mid} taken from layer {mid + 1}", params


def wrong_layer(params, group: str, name: str, n_layers: int):
    """``next_layer_fault`` of the decoder layers' ``<group>.<name>``."""
    return next_layer_fault(params, [("layers", group, name, "w")], n_layers)


def int8_step_faults(params, n_layers: int):
    """Faults below what a token check resolves, printed and not gated: one
    int8 quantization step (the column's range / 255) more in every weight
    of the last layer's, then of every layer's, ``ffn.down``. Their readings
    fall among the sound ones; the exact int8 kernel checks and the
    bit-exact CPU tests stand for that size of fault."""
    down = params["layers"]["ffn"]["down"]["w"]

    def one_step_high(layers):
        out = down.clone()
        sel = down[layers].float()
        step = (sel.amax(-2, keepdim=True) - sel.amin(-2, keepdim=True)) / 255
        out[layers] = (sel + step).to(down.dtype)
        return out

    path = ("layers", "ffn", "down", "w")
    return {
        f"ffn.down of layer {n_layers - 1} one int8 step high": _with_leaf(
            params, path, one_step_high(slice(-1, None))),
        "ffn.down of every layer one int8 step high": _with_leaf(
            params, path, one_step_high(slice(None))),
    }


@contextlib.contextmanager
def record_samples():
    """Every id tensor the served run's greedy sampling returns, kept in
    call order while this is open: a replay feeds them back."""
    from repro_torch.models import transformer as T

    orig, calls = T.sample_fn, []

    def recording(params, hidden, cfg):
        ids = orig(params, hidden, cfg)
        calls.append(ids)
        return ids

    T.sample_fn = recording
    try:
        yield calls
    finally:
        T.sample_fn = orig


class Replay:
    """The plain path through a served run's own dispatches: the same
    BatchServer schedule, batches, padding and cache positions, with
    torch.matmul (float) or the plain int8 algebra and the attention
    kernels' plain versions (``plain_flash``), the served run's sampled ids
    fed back at every dispatch (``record_samples``) so that each dispatch
    sees the served tokens, and its expert choices (``routing``), so that
    a near-tied choice that flipped on a bf16 difference does not stand in
    for the arithmetic. It keeps each request's
    plain first-token logits (its prefill dispatch's row) and second-token
    logits (its slot's row in the first decode dispatch after it). For an
    MoE model this is the comparison that holds: the capacity of an expert
    depends on every token of a dispatch, so one prompt alone is another
    function of the weights. Same interface as PlainPath for
    ``token_readings``."""

    def __init__(self, model, params, prompts, samples, routes,
                 max_new: int, *, quantized: bool, **server_kw):
        from repro_torch.core.gemm import GemmConfig
        from repro_torch.models import transformer as T
        from repro_torch.models.model import Model
        from repro_torch.serve.batcher import BatchServer, Request

        plain = Model(model.cfg, device=model.device)
        self.first, self._second = {}, {}
        logits, waiting, decoding = [], {}, [False]
        orig_sample, orig_place = T.sample_fn, BatchServer._place
        orig_steps = Model.sample_steps

        def sample(p, hidden, cfg):
            i = len(logits)
            if i >= len(samples):
                raise RuntimeError("the replay dispatched more than the "
                                   "served run")
            lg = T.logits_fn(p, hidden, cfg).float().reshape(-1, cfg.vocab)
            logits.append(lg)
            if decoding[0]:
                for slot, rid in waiting.items():
                    self._second[rid] = lg[slot]
                waiting.clear()
            return samples[i]

        def place(srv, slot_i, req, first):
            orig_place(srv, slot_i, req, first)
            lg = logits[-1]
            self.first[req.rid] = lg[slot_i if lg.shape[0] > 1 else 0]
            if srv.slots[slot_i].req is req:
                waiting[slot_i] = req.rid

        def steps(m, *a, **kw):
            decoding[0] = True
            try:
                return orig_steps(m, *a, **kw)
            finally:
                decoding[0] = False

        T.sample_fn, BatchServer._place, Model.sample_steps = (sample, place,
                                                                steps)
        try:
            srv = BatchServer(plain, device=plain.device, quantized=quantized,
                              gemm_algo="ffip",
                              gemm_impl="torch" if quantized else None,
                              **server_kw)
            if quantized:     # chunk the plain int8 cross term, as PlainPath
                srv._gemm_cfg = GemmConfig(algo="ffip", impl="torch",
                                           quantized=True, k_chunk=64)
            for i, prompt in enumerate(prompts):
                srv.submit(Request(rid=i, prompt=prompt,
                                   max_new_tokens=max_new))
            with torch.no_grad(), plain_flash(), routing(routes):
                srv.run_until_drained(params)
        finally:
            T.sample_fn, BatchServer._place, Model.sample_steps = (
                orig_sample, orig_place, orig_steps)
        if len(logits) != len(samples):
            raise RuntimeError(f"the replay dispatched {len(logits)} "
                               f"samplings, the served run {len(samples)}")

    def second(self, rid: int, first_tok: int) -> torch.Tensor:
        return self._second[rid]


class Readings:
    """Token readings against the plain path, and the witnesses of each
    bar: every sound reading must lie below it, every reading of a planted
    fault it must see above it."""

    def __init__(self, problems):
        self.problems = problems
        self.sound = {"float": {}, "int8": {}}
        self.faults = {"float": {}, "int8": {}}

    def read(self, label, done, plain: PlainPath, tier: str, *,
             fault: bool = False, gated: bool = True) -> float:
        """Print a run's worst first- and second-token shortfall; a sound
        run must not exceed its tier's bar."""
        bar = BARS_SD[tier]
        every = hasattr(plain, "token_readings")
        exact, first, second = (plain.token_readings(done) if every
                                else token_readings(done, plain))
        worst = max(first, second)
        print(f"  [{label}] first token = plain-path argmax for {exact}/"
              f"{len(done)} requests; worst shortfall {first:.4f} sd (first "
              f"token), {second:.4f} sd "
              f"({'every later token' if every else 'second token'}) of the "
              f"plain logits ({tier} bar {bar})", flush=True)
        if gated:
            (self.faults if fault else self.sound)[tier][label] = worst
        if gated and not fault and worst > bar:
            self.problems.append(f"{label}: tokens off the plain path")
        return worst

    def deviation(self, label, devs):
        """A float run's kernel-vs-plain prefill deviations: sound readings
        of the float bar."""
        print(f"  [{label}] kernel-path prefill logits vs plain, max |diff| "
              f"per request: {[round(d, 4) for d in devs]} sd", flush=True)
        self.sound["float"][f"{label} (kernel deviation)"] = max(devs)

    def gate(self):
        for tier, bar in BARS_SD.items():
            sound = self.sound[tier]
            faults = self.faults[tier]
            top = max(sound, key=sound.get)
            low = min(faults, key=faults.get)
            print(f"  {tier} bar {bar} sd: largest sound reading "
                  f"{sound[top]:.4f} ({top}); smallest reading of a planted "
                  f"fault {faults[low]:.4f} ({low})", flush=True)
            if not sound[top] < bar < faults[low]:
                self.problems.append(
                    f"the {tier} bar {bar} does not lie between its sound "
                    f"readings (up to {sound[top]:.4f}) and its planted "
                    f"faults (from {faults[low]:.4f})")


def served_prompts(vocab: int, seed: int):
    """The 8 prompts of 16-128 tokens that phases serve and ssm serve; their
    lengths depend on ``seed`` only."""
    from repro_torch.launch.serve import make_prompts
    return make_prompts(vocab, 8, np.random.default_rng(seed), 16, 129)


SERVED_VARIANTS = (("ffip", False), ("fip", False), ("baseline", False),
                   ("ffip", True))


def drive_main_path(model, params, prompts, max_new: int, tag: str = "",
                    variants=SERVED_VARIANTS, max_len: int = 256):
    """The served runs, one per (gemm_algo, quantized) of ``variants``, 4
    slots of ``max_len`` rows; launch counts zeroed before and read after
    each."""
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import serve

    runs = []
    for algo, quantized in variants:
        label = tag + ("int8-" if quantized else "") + algo
        torch.cuda.reset_peak_memory_stats()
        compat.reset_counters()
        with record_samples() as samples, routing() as routes:
            srv, done, wall = serve(model, params, prompts, max_new=max_new,
                                    batch_slots=4, max_len=max_len,
                                    quantized=quantized, gemm_algo=algo,
                                    gemm_impl="cuda")
        counts = compat.launch_counts()
        st = dict(srv.stats)
        tokens = sum(len(r.out_tokens) for r in done)
        budget_ok = (len(done) == len(prompts)
                     and all(len(r.out_tokens) == max_new for r in done))
        busy = st["prefill_s"] + st["decode_s"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  [{label}] {len(done)}/{len(prompts)} requests, {tokens} "
              f"tokens, exact budgets {budget_ok}; wall {wall:.3f} s "
              f"(incl. one-time weight preparation); prefill "
              f"{st['prefill_s']:.3f} s ({st['prefill_tokens']} tok / "
              f"{st['prefill_dispatches']} dispatches), decode "
              f"{st['decode_s']:.3f} s ({st['decode_tokens']} tok / "
              f"{st['steps']} steps, "
              f"{1e3 * st['decode_s'] / max(1, st['steps']):.1f} ms/step); "
              f"{tokens / busy:.1f} tok/s over "
              f"prefill+decode; peak memory {peak:.2f} GiB; launches "
              f"{counts}", flush=True)
        runs.append(dict(label=label, algo=algo, quantized=quantized,
                         done=done, counts=counts, stats=st, wall_s=wall,
                         budget_ok=budget_ok, peak_gib=peak, samples=samples,
                         routes=routes))
        del srv
        torch.cuda.empty_cache()      # the next run's weights start afresh
    return runs


KERNEL_GROUPS = (("conv_", "conv_gemm"),
                 ("ConvA", "conv_gemm"),
                 ("selective_scan_kernel", "selective_scan"),
                 ("selective_scan_bwd_kernel", "selective_scan_bwd"),
                 ("flash_bwd_", "flash_bwd"),
                 ("ffip_pair_kernel", "ffip_gemm_y"),
                 ("carry_", "ffip_carry_table"),
                 ("fip_pair_kernel", "fip_gemm"),
                 ("baseline_kernel", "baseline_gemm"),
                 ("baseline_tc", "baseline_gemm"),
                 ("reduce_units", "split-K reduce"),
                 ("flash_fwd_", "flash_fwd"),
                 ("flash_paged_", "flash_paged"))


def _group(kernel_name: str) -> str:
    for key, group in KERNEL_GROUPS:
        if key in kernel_name:
            return group
    return "torch ops"


def profile(steps):
    """Each of ``steps`` (name -> callable) under FFIP through the kernels,
    once to warm up and once profiled: launches counted, host wall time, and
    device time by kernel from ``torch.profiler`` (busy = the sum of kernel
    times; "not measured" where the profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.kernels import compat

    out = {}
    with use_gemm(GemmConfig(algo="ffip", impl="cuda")), torch.no_grad(), \
            compat.use_derived(compat.DerivedCache()):
        for phase, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            compat.reset_counters()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            launches = compat.launch_counts()
            device_ms: dict = {}
            for ev in prof.key_averages():
                us = getattr(ev, "self_device_time_total", 0) or 0
                if us > 0:
                    g = _group(ev.key)
                    device_ms[g] = device_ms.get(g, 0.0) + us / 1e3
            busy = sum(device_ms.values()) if device_ms else "not measured"
            out[phase] = dict(wall_ms=wall_ms, launches=launches,
                              device_ms=dict(sorted(
                                  device_ms.items(), key=lambda kv: -kv[1])),
                              busy_ms=busy)
    return out


def contiguous_steps(model, params, prompt_len: int):
    """One bucketed prefill dispatch (4 slots x ``prompt_len``) and one
    decode step over the contiguous cache."""
    dev = model.device
    cache = model.init_cache(4, 256)
    tokens = torch.zeros((4, prompt_len), dtype=torch.long, device=dev)
    lengths = torch.full((4,), prompt_len, dtype=torch.long, device=dev)
    mask = torch.ones((4,), dtype=torch.bool, device=dev)
    pos = torch.full((4,), prompt_len, dtype=torch.long, device=dev)
    return {
        "prefill": lambda: model.prefill_sample(params, tokens, cache,
                                                lengths, mask),
        "decode_step": lambda: model.sample_step(params, tokens[:, :1],
                                                 cache, pos),
    }


def paged_steps(model, params):
    """One paged decode step (4 slots at 128 cached rows) and one 64-row
    prefill chunk (a prompt's second) through K5 over the paged pool."""
    dev = model.device
    mp = PAGED_MAX_LEN // PAGE_SIZE
    cache = model.init_paged_cache(PAGED_SLOTS * mp, PAGE_SIZE)
    table = torch.arange(PAGED_SLOTS * mp, dtype=torch.int32,
                         device=dev).reshape(PAGED_SLOTS, mp)
    tok = torch.zeros((PAGED_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((PAGED_SLOTS,), 128, dtype=torch.long, device=dev)
    chunk = torch.zeros((1, PREFILL_CHUNK), dtype=torch.long, device=dev)
    return {
        "paged decode_step": lambda: model.sample_step(
            params, tok, cache, pos, page_table=table, paged_impl="flash"),
        "paged prefill chunk": lambda: model.prefill_chunk_paged(
            params, chunk, cache, table[:1], PREFILL_CHUNK, PREFILL_CHUNK,
            PREFILL_CHUNK, paged_impl="flash"),
    }


def _first_layers(tree, n: int):
    """The first ``n`` layers of a stacked parameter tree, as views."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _same(a: dict, b: dict) -> str:
    """'identical', or the requests whose tokens differ and where first."""
    diff = {rid: next((i for i, (x, y) in enumerate(zip(toks, other))
                       if x != y), min(len(toks), len(other)))
            for rid, toks in a["tokens"].items()
            for other in [b["tokens"].get(rid, [])] if toks != other}
    return "identical" if not diff else f"differ (request: first index) {diff}"


def serve_paged(model, params, prompts, max_new: int, label: str,
                max_len: int = PAGED_MAX_LEN, **kw):
    """One paged serve of ``prompts`` (launch counts zeroed just before and
    read just after) and the page-ledger checks every paged run must pass.
    Returns (record, problems)."""
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats()
    compat.reset_counters()
    srv, done, wall = serve(model, params, prompts, max_new=max_new,
                            batch_slots=PAGED_SLOTS, max_len=max_len,
                            gemm_impl="cuda", paged=True,
                            page_size=PAGE_SIZE, **kw)
    counts = compat.launch_counts()
    st = dict(srv.stats)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_layers = model.cfg.n_layers
    ledger = dict(reserved=srv._reserved, free=srv.alloc.free_count,
                  in_use=srv.alloc.in_use, num_pages=srv.alloc.num_pages,
                  contiguous_pages=srv.b * srv.max_pages)
    problems = []
    if (len(done) != len(prompts)
            or any(len(r.out_tokens) != max_new for r in done)):
        problems.append(f"{label}: a request missed its token budget")
    if st["prefix_hit_tokens"] <= 0 or st["cow_copies"] < 1:
        problems.append(f"{label}: no prefix hit or no copy on write")
    if ledger["reserved"] or ledger["free"] + ledger["in_use"] != \
            ledger["num_pages"]:
        problems.append(f"{label}: the page ledger does not balance {ledger}")
    if st["pages_peak"] >= ledger["contiguous_pages"]:
        problems.append(f"{label}: pages_peak {st['pages_peak']} not below "
                        f"slots x max_pages")
    want_k5 = 0
    if srv.paged_attention == "flash":
        want_k5 = n_layers * (st["prefill_chunks"]
                              + st["decode_dispatches"] * srv.decode_chunk)
    if counts["flash_paged"] != want_k5 or counts["flash_fwd"] != 0:
        problems.append(f"{label}: flash_paged launched "
                        f"{counts['flash_paged']} times (want {want_k5}), "
                        f"flash_fwd {counts['flash_fwd']} (want 0)")
    steps_ms = 1e3 * st["decode_s"] / max(1, st["steps"])
    print(f"  [{label}] {len(done)}/{len(prompts)} requests; prefill "
          f"{st['prefill_s']:.3f} s ({st['prefill_tokens']} tok / "
          f"{st['prefill_chunks']} chunks), decode {st['decode_s']:.3f} s "
          f"({st['decode_tokens']} tok / {st['steps']} steps / "
          f"{st['decode_dispatches']} dispatches, {steps_ms:.1f} ms/step); "
          f"peak memory {peak:.2f} GiB; pages_peak {st['pages_peak']} of "
          f"{ledger['num_pages']} (contiguous equivalent "
          f"{ledger['contiguous_pages']}), prefix_hit_tokens "
          f"{st['prefix_hit_tokens']}, cow_copies {st['cow_copies']}; "
          f"ledger {ledger}; launches {counts}", flush=True)
    rec = dict(label=label, done=done, counts=counts, stats=st, wall_s=wall,
               peak_gib=peak, ms_per_step=steps_ms,
               tokens={r.rid: list(r.out_tokens) for r in done})
    del srv
    return rec, problems


def run_vision(dev, seed: int):
    """ResNet-50 and AlexNet at their published widths, batch 8, through
    ``repro_torch.vision`` with ``GemmConfig(impl="cuda")`` (every conv
    through K7, the FCs through K1-K3), each forward's launch counts zeroed
    before and read after, against the plain path (F.conv2d with TF32 off
    and torch.matmul for float; the materialising int8 reference and the
    plain int8 dense for int8; the materialised FIP/FFIP algebra for the
    bar of a float FIP/FFIP run). Returns (records, problems)."""
    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.kernels import compat
    from repro_torch.launch.vision import rel_err
    from repro_torch.vision import models as vm

    fc_kernel = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
                 "baseline": "baseline_gemm"}
    records, problems = [], []
    for name, size, runs in VISION_RUNS:
        model = vm.build(name, num_classes=1000, image_size=size)
        n_convs = len(vm.conv_layers(model))
        n_fcs = sum(isinstance(layer, vm.FC) for layer in model)
        params = vm.init_params(model, seed, device=dev)
        qparams = vm.attach_quantized(model, params)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        x = torch.randn((CONV_BATCH, size, size, 3), generator=gen,
                        device=dev)

        def forward(cfg, p):
            """(logits, host wall ms, device ms, peak GiB, launches)."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            compat.reset_counters()
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            with use_gemm(cfg), torch.no_grad():
                t0 = time.perf_counter()
                s_ev.record()
                out = vm.apply(model, p, x)
                e_ev.record()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = {k: v for k, v in compat.launch_counts().items() if v}
            return (out, wall, s_ev.elapsed_time(e_ev),
                    torch.cuda.max_memory_allocated() / 2 ** 30, counts)

        plain_cfgs = {"float": GemmConfig(algo="baseline", impl="torch"),
                      "int8": GemmConfig(algo="ffip", impl="torch",
                                         quantized=True, k_chunk=16)}
        plain_cfgs.update({algo: GemmConfig(algo=algo, impl="torch")
                           for _, algo, q in runs
                           if not q and algo != "baseline"})
        plain = {key: forward(cfg, qparams if key == "int8" else params)[0]
                 for key, cfg in plain_cfgs.items()}
        float_ref = plain["float"]
        algebra_err = {key: rel_err(out, float_ref)
                       for key, out in plain.items() if key in ("fip", "ffip")}
        print(f"  [{name} plain] top1 {float_ref.argmax(-1).tolist()}; "
              f"max |logit| {float(float_ref.abs().max()):.4g}; the plain "
              f"FIP/FFIP algebra's own rel_err vs plain float "
              f"{ {k: round(v, 6) for k, v in algebra_err.items()} }",
              flush=True)
        for label, algo, quantized in runs:
            cfg = GemmConfig(algo=algo, impl="cuda", quantized=quantized)
            p = qparams if quantized else params
            forward(cfg, p)                          # warm: first-use set-up
            out, wall, dev_ms, peak, counts = forward(cfg, p)
            err = rel_err(out, float_ref)
            want = {"conv_gemm": n_convs, fc_kernel[algo]: n_fcs}
            got = {k: counts.get(k, 0) for k in want}
            other = {k: v for k, v in counts.items() if k not in want}
            line = (f"  [{name} {label}] wall {wall:.1f} ms, device "
                    f"{dev_ms:.1f} ms, peak {peak:.2f} GiB, top1 "
                    f"{out.argmax(-1).tolist()}, rel_err vs plain float "
                    f"{err:.3g}")
            if quantized:
                same = torch.equal(out, plain["int8"])
                line += f", logits = plain int8: {same}"
                if not same:
                    problems.append(f"{name} {label}: logits differ from the "
                                    f"plain int8 path")
            bar = (VISION_INT8_BAR if quantized
                   else max(VISION_FLOAT_BAR, algebra_err.get(algo, 0.0)))
            line += f" (bar {bar:.4g})"
            if not (bool(torch.isfinite(out).all()) and err <= bar):
                problems.append(f"{name} {label}: rel_err {err:.3g} > {bar} "
                                f"(or logits not finite)")
            if got != want or other:
                problems.append(f"{name} {label}: launches {counts}, want "
                                f"{want} and nothing else")
            print(f"{line}; launches {counts}", flush=True)
            records.append(dict(model=name, label=label, wall_ms=wall,
                                device_ms=dev_ms, peak_gib=peak,
                                rel_err=err, bar=bar, counts=counts,
                                top1=out.argmax(-1).tolist()))
        del params, qparams, plain, float_ref
        torch.cuda.empty_cache()
    return records, problems


def vision_step(dev, seed: int):
    """One ResNet-50 forward at batch 8, for the profile."""
    from repro_torch.vision import models as vm

    model = vm.build("resnet50", num_classes=1000, image_size=224)
    params = vm.init_params(model, seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((CONV_BATCH, 224, 224, 3), generator=gen, device=dev)
    return lambda: vm.apply(model, params, x)


def ssm_steps(model, params, prompt_len: int = 128, tag: str = "falcon"):
    """One prefill of a ``prompt_len``-token prompt (the scatter prefill's
    batch-1 forward) and one decode step over 4 slots, of an SSM or hybrid
    model."""
    dev = model.device
    cache = model.init_cache(4, 256)
    prompt = torch.zeros((1, prompt_len), dtype=torch.long, device=dev)
    ids = torch.zeros((4, 1), dtype=torch.long, device=dev)
    pos = torch.full((4,), prompt_len, dtype=torch.long, device=dev)
    return {
        f"{tag} prefill": lambda: model.prefill(
            params, prompt, model.init_cache(1, 256)),
        f"{tag} decode_step": lambda: model.sample_step(params, ids, cache,
                                                        pos),
    }


def print_profile(steps, want_fn, problems):
    """Profile ``steps`` (FFIP through the kernels) and hold each one's
    launches to ``want_fn(phase)``."""
    for phase, rec in profile(steps).items():
        top = ", ".join(f"{k} {v:.3f}" for k, v in rec["device_ms"].items())
        busy = rec["busy_ms"]
        share = ("not measured" if isinstance(busy, str)
                 else f"{busy / rec['wall_ms']:.3f}")
        scan = rec["device_ms"].get("selective_scan")
        scan_txt = ("" if scan is None or isinstance(busy, str) else
                    f"; selective_scan {scan:.3f} ms ({scan / busy:.4f} of "
                    f"busy)")
        print(f"phase profile {phase} (ffip; LM: 4 slots x 128 / a 64-row "
              f"chunk / one 128-token prompt; vision: batch {CONV_BATCH}): "
              f"wall {rec['wall_ms']:.3f} ms, device busy {busy} ms (share "
              f"{share}){scan_txt}; device ms by kernel: "
              f"{top or 'not measured'}; launches {rec['launches']}",
              flush=True)
        want = want_fn(phase)
        got = {k: rec["launches"][k] for k in want}
        if got != want:
            problems.append(f"{phase} launched {got}, expected {want}")


def run_fleet(args, model, params, prompts, problems):
    """Phase fleet: the router and repro_torch.obs on minicpm-2b's model
    (the main phase's weights, shared by every replica). (a) Oracles: one
    no-fault 2-slot server a configuration (ffip with the profiler hooks
    toggled every step, for their decode cost), then two-replica routers on
    a FakeClock under each fault plan: ffip + int8-ffip (contiguous, K3
    and K4) under raise, hang, exhaust and poison, and paged flash fip (K2
    and K5) + int8-ffip under exhaust. Every request must end DONE with its
    configuration's oracle tokens, each fault must fire, every paged ledger
    drain. (b) The SLO loop through ``launch.serve.main`` with the
    baseline GEMM (K1), then ``launch.obs_check`` on its files and one
    ``launch.dash`` frame. In both, a replica step that raises what no
    fault plan injected (an out-of-memory error, a kernel's) is a problem,
    not a failover (``launch.serve.unplanned_failures``). Returns the
    phase's launch counts."""
    import tempfile

    from repro_torch import obs
    from repro_torch.kernels import compat
    from repro_torch.launch import dash, obs_check
    from repro_torch.launch import serve as launch
    from repro_torch.serve.batcher import BatchServer, Request
    from repro_torch.serve.faults import FakeClock, FaultPlan, FaultSpec
    from repro_torch.serve.lifecycle import Lifecycle
    from repro_torch.serve.router import ReplicaRouter, RouterConfig

    from repro_torch import prepare

    t0 = time.perf_counter()
    print(f"phase fleet: minicpm-2b, {model.cfg.n_layers} layers, replicas "
          f"of {FLEET_SLOTS} slots sharing its weights, the {len(prompts)} "
          f"served prompts, {args.max_new} new tokens each", flush=True)
    # one preparation a tier (repro_torch.prepare), which every server of
    # the tier shares: no server derives y, carry tables or int8 weights
    compat.reset_counters()
    tiers = {q: prepare.prepare_lm(params, quantized=q) for q in (False,
                                                                  True)}
    torch.cuda.synchronize()
    prepared_at = prepare.counters_snapshot()
    print(f"  one preparation a tier: float {len(tiers[False].derived)} y "
          f"deltas, int8 {len(tiers[True].derived)}; carry tables "
          f"{compat.launch_counts()['ffip_carry_table']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    base = dict(batch_slots=FLEET_SLOTS, max_len=PAGED_MAX_LEN,
                gemm_impl="cuda", device=model.device)
    kinds = {"ffip": dict(gemm_algo="ffip", prepared=tiers[False]),
             "int8-ffip": dict(gemm_algo="ffip", quantized=True,
                               prepared=tiers[True]),
             "paged flash fip": dict(gemm_algo="fip", paged=True,
                                     page_size=PAGE_SIZE,
                                     prefill_chunk=PREFILL_CHUNK,
                                     paged_attention="flash",
                                     prepared=tiers[False])}

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=args.max_new,
                        eos_id=-1) for i, p in enumerate(prompts)]

    compat.reset_counters()
    # The oracles: one no-fault server a configuration. The ffip one
    # toggles the profiler hooks every step, so its decode steps with the
    # hooks off and on interleave in one run and share its warm-up.
    oracle, step_ms = {}, {False: [], True: []}
    hooks = obs.profile.enable(False)
    for label in kinds:
        t1 = time.perf_counter()
        srv = BatchServer(model, registry=obs.Registry(), **base,
                          **kinds[label])
        for r in requests():
            srv.submit(r)
        toggle = label == "ffip"
        for i in range(10_000):
            on = not toggle or i % 2 == 1
            obs.profile.enable(on)
            before = (srv.stats["decode_s"], srv.stats["decode_dispatches"])
            work = srv.step(params)
            if toggle and srv.stats["decode_dispatches"] > before[1]:
                step_ms[on].append(1e3 * (srv.stats["decode_s"] - before[0]))
            if work == 0 and not srv.has_queued():
                break
        obs.profile.enable(False)
        done = srv.take_completed()
        oracle[label] = {r.rid: list(r.out_tokens) for r in done}
        st = srv.stats
        budget_ok = (len(done) == len(prompts)
                     and all(len(r.out_tokens) == args.max_new for r in done))
        if not budget_ok:
            problems.append(f"fleet oracle {label}: a request missed its "
                            f"budget")
        print(f"  [fleet oracle {label}] {len(done)}/{len(prompts)} "
              f"requests, exact budgets {budget_ok}; decode "
              f"{1e3 * st['decode_s'] / max(1, st['steps']):.2f} ms/step "
              f"over {st['steps']} steps; prefill {st['prefill_s']:.3f} s; "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        del srv
    # the hooks' own host cost, apart from the steps' spread: one decode
    # step's on_gemm calls (7 a layer and the unembed) at its shapes
    x = torch.zeros(FLEET_SLOTS, model.cfg.d_model, device=model.device)
    w = torch.zeros(model.cfg.d_model, model.cfg.d_ff, device=model.device)
    calls = 7 * model.cfg.n_layers + 1
    obs.profile.enable(True)
    t1 = time.perf_counter()
    for _ in range(calls):
        obs.profile.on_gemm(x, w, "ffip")
    hook_ms = 1e3 * (time.perf_counter() - t1)
    obs.profile.enable(hooks)
    off, on = (float(np.mean(step_ms[k])) for k in (False, True))
    print(f"fleet profiler hooks: decode {off:.2f} ms/step off "
          f"({len(step_ms[False])} steps), {on:.2f} ms/step on "
          f"({len(step_ms[True])} steps), {on - off:+.2f} ms (the ffip "
          f"oracle, 2 slots, the hooks toggled every step); a step's "
          f"{calls} on_gemm calls alone take {hook_ms:.3f} ms of host time",
          flush=True)
    del x, w
    t_oracles, t_runs = time.perf_counter() - t0, time.perf_counter()

    outcomes, stats = {}, {}
    plain = {}
    for labels, kind in ([(("ffip", "int8-ffip"), k) for k in FLEET_PLANS]
                         + [(("paged flash fip", "int8-ffip"), "exhaust")]):
        t1 = time.perf_counter()
        clock, reg = FakeClock(), obs.Registry()
        servers = [BatchServer(model, registry=reg, clock=clock, **base,
                               **kinds[lb]) for lb in labels]
        at, duration = FLEET_PLANS[kind]
        plan = FaultPlan([FaultSpec(kind=kind, replica=0, at_dispatch=at,
                                    duration=duration)], seed=3)
        rt = ReplicaRouter(servers, params, fault_plan=plan, clock=clock,
                           registry=reg,
                           cfg=RouterConfig(step_timeout_s=5.0,
                                            quarantine_s=0.2, max_retries=4))
        for r in requests():
            rt.submit(r)
        recs = rt.drive(max_ticks=5000)
        tier_label = {s.tier: lb for s, lb in zip(servers, labels)}
        wrong = {rid: rec for rid, rec in recs.items()
                 if rec.state is Lifecycle.DONE
                 and rec.tokens != oracle[tier_label[rec.tier]][rid]}
        fired = rt.stats["replica_failures"] + rt.stats["poisoned"]
        causes = launch.unplanned_failures(rt.events)
        ledgers = [(s._reserved, s.alloc.free_count + s.alloc.in_use
                    == s.num_pages) for s in servers if s.paged]
        got = rt.outcome_counts()
        name = f"fleet {kind}: {' + '.join(labels)}"
        print(f"  [{name}] outcomes {got}; faults fired {fired}; tokens "
              f"identical to the oracles {not wrong}; paged ledgers "
              f"(reserved, balanced) {ledgers}; {rt.ticks} ticks, "
              f"{time.perf_counter() - t1:.1f} s; router {rt.stats}",
              flush=True)
        for k, v in got.items():
            outcomes[k] = outcomes.get(k, 0) + v
        for k, v in rt.stats.items():
            stats[k] = stats.get(k, 0) + v
        if got != {"done": len(prompts)}:
            problems.append(f"{name}: outcomes {got}")
        if fired < 1:
            problems.append(f"{name}: the fault never fired")
        if causes:
            problems.append(f"{name}: {causes}")
        if any(res != 0 or not bal for res, bal in ledgers):
            problems.append(f"{name}: a page ledger did not drain")
        for rid, rec in wrong.items():
            want = oracle[tier_label[rec.tier]][rid]
            at_tok = next(i for i, (a, b) in enumerate(zip(rec.tokens, want))
                          if a != b)
            q = rec.tier == "int8"
            if q not in plain:
                plain[q] = PlainPath(model, params, prompts, q)
            read = [token_readings([types.SimpleNamespace(
                rid=rid, out_tokens=t)], plain[q]) for t in (rec.tokens,
                                                             want)]
            problems.append(f"{name}: rid {rid} ({rec.tier}) differs from "
                            f"its oracle from token {at_tok} (0 = the "
                            f"prefill's); readings served {read[0]}, "
                            f"oracle {read[1]}")
        # the router and its records hold each other (the lifecycle
        # observer, the tracer's clock): collect them before the next run
        del rt, servers, recs, wrong
        free_device()
    counts = compat.launch_counts()
    print(f"fleet: 5 router runs, outcomes {outcomes}, router stats summed "
          f"{stats}; launches {counts}; {time.perf_counter() - t0:.1f} s "
          f"(oracles {t_oracles:.1f} s, router runs "
          f"{time.perf_counter() - t_runs:.1f} s)", flush=True)
    derived = {k: v - prepared_at[k]
               for k, v in prepare.counters_snapshot().items()}
    print(f"  offline work of the fleet's servers beside their tiers' "
          f"preparations: {derived}", flush=True)
    if any(derived.values()) and not plain:
        problems.append(f"fleet: servers derived what their tier's "
                        f"preparation holds: {derived}")
    del plain, tiers, kinds
    free_device()

    # (b) the SLO loop through the launcher, as the reference's README runs
    # it (4 new tokens a request), on the baseline GEMM (K1) and flash
    # prefill (K4)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        m, t = f"{tmp}/metrics.json", f"{tmp}/trace.jsonl"
        launch.main(["--arch", "minicpm-2b", "--layers",
                     str(model.cfg.n_layers),
                     "--requests", "8", "--slots", "2", "--replicas", "2",
                     "--quantized-replicas", "1", "--fault-plan", "flaky",
                     "--slo", "ttft_ms p99 < 2000", "--slo-windows", "2,8",
                     "--slo-min-count", "2", "--slo-drain-ticks", "1600",
                     "--gemm-impl", "cuda", "--gemm-algo", "baseline",
                     "--max-new", "4", "--seed", str(args.seed),
                     "--metrics-json", m,
                     "--trace-out", t])
        for name, n in compat.launch_counts().items():
            counts[name] += n
        free_device()
        rc = obs_check.main(["--metrics-json", m, "--trace", t,
                             "--replicas", "2", "--requests", "8",
                             "--min-retries", "1", "--expect-slo", "ttft_ms",
                             "--expect-controller", "tighten,probe,recover",
                             "--expect-recovery"])
        if rc:
            problems.append("fleet: obs_check failed on the launcher's files")
        with open(m) as f:
            print(dash.render(json.load(f), source="fleet SLO loop"),
                  flush=True)
    print(f"phase fleet: {time.perf_counter() - t0:.1f} s (the SLO loop "
          f"{time.perf_counter() - t1:.1f} s); launches {counts}", flush=True)
    return counts


def run_ssm(args, readings: Readings, problems):
    """falcon-mamba-7b at its published widths through the Mamba1 path:
    served four ways (every prefill layer through K6, the projections
    through K1-K3), tokens held to the plain path (torch.matmul or the plain
    int8 algebra, the plain selective scan), planted faults read, one
    prefill and one decode step profiled. Returns the served runs."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    full = configs.get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(full, n_layers=SSM_SERVE_LAYERS)
    s_cfg = cfg.ssm
    print(f"phase ssm: {cfg.name} d_model {cfg.d_model}, d_inner "
          f"{s_cfg.expand * cfg.d_model}, d_state {s_cfg.d_state}, dt_rank "
          f"{s_cfg.dt_rank}, d_conv {s_cfg.d_conv}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype}, tied; n_layers {cfg.n_layers} (published "
          f"{full.n_layers})", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    prompts = served_prompts(cfg.vocab, args.seed)
    print(f"  4 slots, max_len 256, prompt lengths "
          f"{[len(p) for p in prompts]}, {args.max_new} new tokens each; "
          f"weights from seed {args.seed} in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    runs = drive_main_path(model, params, prompts, args.max_new,
                           tag="falcon ")
    gemm = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
            "baseline": "baseline_gemm"}
    want_scan = cfg.n_layers * len(prompts)
    for r in runs:
        c = r["counts"]
        if not r["budget_ok"]:
            problems.append(f"{r['label']}: a request missed its token budget")
        if c[gemm[r["algo"]]] == 0:
            problems.append(f"{r['label']}: {gemm[r['algo']]} never launched")
        if c["selective_scan"] != want_scan:
            problems.append(f"{r['label']}: selective_scan launched "
                            f"{c['selective_scan']} times, want {want_scan} "
                            f"(one per layer per prompt)")
        if any(c.get(k) for k in ("flash_fwd", "flash_paged", "conv_gemm")):
            problems.append(f"{r['label']}: attention or conv kernels "
                            f"launched {c}")
    print(f"phase ssm serve: {time.perf_counter() - t0:.1f} s", flush=True)

    t1 = time.perf_counter()
    plain = {q: PlainPath(model, params, prompts, q) for q in (False, True)}
    print(f"  plain paths built in {time.perf_counter() - t1:.1f} s",
          flush=True)
    for r in runs:
        tier = "int8" if r["quantized"] else "float"
        readings.read(r["label"], r["done"], plain[r["quantized"]], tier)
        if not r["quantized"]:
            readings.deviation(r["label"], kernel_deviation(
                model, params, prompts, plain[False], r["algo"]))
    label, faulty = wrong_layer(params, "ssm", "out_proj", cfg.n_layers)
    for quantized in (True, False):
        _, done, _ = serve(model, faulty, prompts, max_new=2, batch_slots=4,
                           max_len=256, quantized=quantized, gemm_algo="ffip",
                           gemm_impl="cuda")
        tier = "int8" if quantized else "float"
        readings.read(f"falcon planted fault: {label}, {tier} ffip", done,
                      plain[quantized], tier, fault=True)
    del faulty, plain
    print(f"phase ssm check: {time.perf_counter() - t1:.1f} s", flush=True)

    n = cfg.n_layers
    print_profile(ssm_steps(model, params), lambda phase: {
        "ffip_gemm_y": 4 * n + 1,
        "selective_scan": n if phase == "falcon prefill" else 0}, problems)
    print(f"phase ssm: {time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def run_moe(args, readings: Readings, problems):
    """deepseek-v2-lite-16b at its published widths and MOE_SERVE_LAYERS
    layers through
    the MLA + MoE path: served contiguous four ways (every prefill dispatch
    through K4 at d 192 / dv 128 once per layer, decode through the
    absorbed einsums, the projections and routers through K1-K3) and paged
    through K5 (absorbed: H 16, one kv head, d 576, dv 512), tokens held to
    a replay of each served run through the plain path, planted faults
    read, one dispatch of each kind profiled; then trained (MOE_TRAIN_RUNS)
    through K4 + K8. Returns (served runs, paged runs, train records)."""
    from repro_torch import configs
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    full = configs.get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS)
    m, e = cfg.mla, cfg.moe
    print(f"phase moe: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, MLA kv_lora {m.kv_lora_rank} / rope {m.rope_head_dim} / "
          f"nope {m.nope_head_dim} / v {m.v_head_dim}, MoE {e.n_experts} "
          f"experts top-{e.top_k} of d_ff {e.d_ff_expert} + {e.n_shared} "
          f"shared, capacity factor {e.capacity_factor}, first "
          f"{cfg.first_k_dense} dense, vocab {cfg.vocab}, untied, "
          f"{cfg.param_dtype}; n_layers {cfg.n_layers} (published "
          f"{full.n_layers}), "
          f"{cfg.param_count() / 1e9:.2f} B params", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    prompts = served_prompts(cfg.vocab, args.seed)
    n = cfg.n_layers
    n_moe = n - cfg.first_k_dense
    print(f"  4 slots, max_len 256, prompt lengths "
          f"{[len(p) for p in prompts]}, {args.max_new} new tokens each; "
          f"weights from seed {args.seed} in {time.perf_counter() - t0:.1f} "
          f"s; {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    runs = drive_main_path(model, params, prompts, args.max_new,
                           tag="deepseek ")
    gemm = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
            "baseline": "baseline_gemm"}
    for r in runs:
        c, st = r["counts"], r["stats"]
        want_k4 = n * st["prefill_dispatches"]
        print(f"  [{r['label']}] flash_fwd {c['flash_fwd']} = {n} layers x "
              f"{st['prefill_dispatches']} prefill dispatches: "
              f"{c['flash_fwd'] == want_k4}", flush=True)
        if not r["budget_ok"]:
            problems.append(f"{r['label']}: a request missed its token budget")
        if c[gemm[r["algo"]]] == 0:
            problems.append(f"{r['label']}: {gemm[r['algo']]} never launched")
        if c["flash_fwd"] != want_k4:
            problems.append(f"{r['label']}: flash_fwd launched "
                            f"{c['flash_fwd']} times, want {want_k4} (once "
                            f"per layer per prefill dispatch, never at "
                            f"decode)")
        if any(c.get(k) for k in ("flash_paged", "conv_gemm",
                                  "selective_scan")):
            problems.append(f"{r['label']}: paged, conv or scan kernels "
                            f"launched {c}")
    print(f"phase moe serve: {time.perf_counter() - t0:.1f} s", flush=True)

    t1 = time.perf_counter()
    contiguous = dict(batch_slots=4, max_len=256)
    for r in runs:
        tier = "int8" if r["quantized"] else "float"
        plain = Replay(model, params, prompts, r["samples"], r["routes"],
                       args.max_new, quantized=r["quantized"], **contiguous)
        readings.read(r["label"], r["done"], plain, tier)
        del plain
    alone = PlainPath(model, params, prompts, False, kernels_plain=True)
    for r in runs:
        if not r["quantized"]:
            readings.deviation(r["label"], kernel_deviation(
                model, params, prompts, alone, r["algo"]))
    del alone
    label, faulty = wrong_layer(params, "attn", "wo", n_moe)
    for quantized in (True, False):
        with record_samples() as samples, routing() as routes:
            _, done, _ = serve(model, faulty, prompts, max_new=2,
                               quantized=quantized, gemm_algo="ffip",
                               gemm_impl="cuda", **contiguous)
        tier = "int8" if quantized else "float"
        plain = Replay(model, params, prompts, samples, routes, 2,
                       quantized=quantized, **contiguous)
        readings.read(f"deepseek planted fault: {label}, {tier} ffip", done,
                      plain, tier, fault=True)
        del plain
    del faulty
    free_device()
    print(f"phase moe check: {time.perf_counter() - t1:.1f} s", flush=True)

    # paged through K5: the absorbed MLA over page pools of the latent and
    # the rope key, prefix sharing, copy on write, 64-row prefill chunks
    t1 = time.perf_counter()
    paged_prompts = make_prompts(cfg.vocab, 8,
                                 np.random.default_rng(args.seed), 16, 65,
                                 shared_prefix=64)
    print(f"  paged: {PAGED_SLOTS} slots, max_len {PAGED_MAX_LEN}, pages of "
          f"{PAGE_SIZE}, prefill chunks of {PREFILL_CHUNK}; prompt lengths "
          f"{[len(p) for p in paged_prompts]}", flush=True)
    paged_runs = []
    for tag, quantized, chunk in (("ffip", False, 4), ("int8-ffip", True, 1)):
        with record_samples() as samples, routing() as routes:
            rec, found = serve_paged(
                model, params, paged_prompts, args.max_new,
                f"deepseek paged flash {tag}", gemm_algo="ffip",
                quantized=quantized, decode_chunk=chunk,
                paged_attention="flash", prefill_chunk=PREFILL_CHUNK)
        problems.extend(found)
        paged_runs.append(rec)
        plain = Replay(model, params, paged_prompts, samples, routes,
                       args.max_new, quantized=quantized,
                       batch_slots=PAGED_SLOTS,
                       max_len=PAGED_MAX_LEN, paged=True, page_size=PAGE_SIZE,
                       prefill_chunk=PREFILL_CHUNK, decode_chunk=chunk)
        readings.read(rec["label"], rec["done"], plain,
                      "int8" if quantized else "float")
        del plain
        free_device()
    print(f"phase moe paged: {time.perf_counter() - t1:.1f} s", flush=True)

    # one dispatch of each kind, counted and profiled: K4 once per layer in
    # the contiguous prefill, K5 once per layer in either paged dispatch
    steps = {f"deepseek {k}": v for k, v in contiguous_steps(
        model, params, 128).items()}
    steps.update({f"deepseek {k}": v for k, v in paged_steps(
        model, params).items()})
    print_profile(steps, lambda phase: {
        "flash_fwd": n if phase == "deepseek prefill" else 0,
        "flash_paged": n if "paged" in phase else 0}, problems)
    del steps, model, params
    free_device()
    print(f"phase moe serving: {time.perf_counter() - t0:.1f} s", flush=True)

    t1 = time.perf_counter()
    train_recs, _ = run_train(args, problems, runs=MOE_TRAIN_RUNS)
    free_device()
    print(f"phase moe train: {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"phase moe: {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, paged_runs, train_recs


def family_prompts(vocab: int, seed: int, long_range, paged: bool):
    """The 8 prompts of a family's served runs: served_prompts' (16-128
    tokens) or, paged, the paged phases' workload (16-64 tokens, the even
    ones behind a shared 64-token prefix, the last a copy of the first),
    with prompt LONG_PROMPT_INDEX replaced by one of ``long_range`` tokens
    where the family has a window to pass."""
    from repro_torch.launch.serve import make_prompts

    prompts = (make_prompts(vocab, 8, np.random.default_rng(seed), 16, 65,
                            shared_prefix=64) if paged
               else served_prompts(vocab, seed))
    if long_range:
        rng = np.random.default_rng(seed + 1)
        n = int(rng.integers(*long_range))
        prompts[LONG_PROMPT_INDEX] = rng.integers(0, vocab, size=(n,))
    return prompts


def family_plain(model, params, prompts, run, max_new: int, **server_kw):
    """The plain path a served run of a family is read against: for an MoE
    model a replay of the run (``Replay``: its dispatches, ids and expert
    choices), else each prompt alone (``PlainPath``)."""
    if model.cfg.moe is not None:
        return Replay(model, params, prompts, run["samples"], run["routes"],
                      max_new, quantized=run["quantized"], **server_kw)
    return PlainPath(model, params, prompts, run["quantized"])


def run_family(args, readings: Readings, problems, arch, tag, layers,
               max_len, long_range, variants, paged, train_shape):
    """One family of phase families (FAMILY_RUNS): served contiguous
    through K1-K4 (every prefill dispatch launches K4 once a layer, decode
    attends through the plain cache attention) and, where asked, paged
    through K5; each run's first and second tokens held to its plain path
    under the float / int8 bars, a middle layer's attn.wo taken from the
    next layer the planted fault (float and int8 FFIP); then, where asked,
    trained through K4 + K8 (run_train). Returns (served runs, paged runs,
    train records)."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    win, theta = T.window_theta_arrays(cfg, layers)
    local = int((win > 0).sum())
    moe = (f", MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
           f"{cfg.moe.d_ff_expert}, capacity factor "
           f"{cfg.moe.capacity_factor}" if cfg.moe else "")
    print(f"phase families: {arch} d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}x{cfg.hd} (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}{', tied' if cfg.tie_embeddings else ''}, norm "
          f"{cfg.norm}, act {cfg.act}, qkv bias {cfg.qkv_bias}{moe}; window "
          f"{cfg.sliding_window} on {local} of {layers} layers, rope theta "
          f"{sorted(set(float(t) for t in theta))}; n_layers {layers} "
          f"(published {full.n_layers}), {cfg.param_count() / 1e9:.2f} B "
          f"params, {cfg.param_dtype}", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    prompts = family_prompts(cfg.vocab, args.seed, long_range, False)
    print(f"  4 slots, max_len {max_len}, prompt lengths "
          f"{[len(p) for p in prompts]}, {args.max_new} new tokens each; "
          f"weights in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    runs = drive_main_path(model, params, prompts, args.max_new,
                           tag=f"{tag} ", variants=variants, max_len=max_len)
    gemm = {"ffip": "ffip_gemm_y", "baseline": "baseline_gemm"}
    others = ("flash_paged", "flash_bwd", "conv_gemm", "selective_scan",
              "selective_scan_bwd")
    for r in runs:
        c, st = r["counts"], r["stats"]
        want_k4 = layers * st["prefill_dispatches"]
        print(f"  [{r['label']}] flash_fwd {c['flash_fwd']} = {layers} layers "
              f"x {st['prefill_dispatches']} prefill dispatches: "
              f"{c['flash_fwd'] == want_k4}", flush=True)
        if not r["budget_ok"]:
            problems.append(f"{r['label']}: a request missed its token budget")
        if c[gemm[r["algo"]]] == 0:
            problems.append(f"{r['label']}: {gemm[r['algo']]} never launched")
        if c["flash_fwd"] != want_k4:
            problems.append(f"{r['label']}: flash_fwd launched "
                            f"{c['flash_fwd']} times, want {want_k4}")
        if any(c.get(k) for k in others):
            problems.append(f"{r['label']}: launched {c}")
    # the planted faults are served before any plain path is built: a
    # served int8 run of the deepest family takes most of the card
    contiguous = dict(batch_slots=4, max_len=max_len)
    label, faulty = wrong_layer(params, "attn", "wo", layers)
    faults = []
    for quantized in (False, True):
        with record_samples() as samples, routing() as routes:
            _, done, _ = serve(model, faulty, prompts, max_new=2,
                               quantized=quantized, gemm_algo="ffip",
                               gemm_impl="cuda", **contiguous)
        faults.append(dict(done=done, samples=samples, routes=routes,
                           quantized=quantized,
                           label=f"{tag} planted fault: {label}, "
                                 f"{'int8' if quantized else 'float'} ffip"))
    del faulty
    free_device()
    plains = {}
    for r in runs + faults:
        tier = "int8" if r["quantized"] else "float"
        fault = any(r is f for f in faults)
        # the plain int8 paths are built and read (PlainPath.second decodes
        # on demand) with their products by one float64 matmul
        with (int8_products_by_f64() if r["quantized"]
              else contextlib.nullcontext()):
            if cfg.moe is not None or r["quantized"] not in plains:
                plains[r["quantized"]] = family_plain(
                    model, params, prompts, r,
                    2 if fault else args.max_new, **contiguous)
            readings.read(r["label"], r["done"], plains[r["quantized"]],
                          tier, fault=fault)
        if cfg.moe is None and r.get("algo") == "ffip" and not r["quantized"]:
            readings.deviation(r["label"], kernel_deviation(
                model, params, prompts, plains[False], "ffip"))
    del plains
    free_device()
    paged_runs = []
    if paged:
        paged_prompts = family_prompts(cfg.vocab, args.seed, long_range, True)
        print(f"  paged: {PAGED_SLOTS} slots, max_len {max_len}, pages of "
              f"{PAGE_SIZE}, prefill chunks of {PREFILL_CHUNK}; prompt "
              f"lengths {[len(p) for p in paged_prompts]}", flush=True)
        kw = dict(gemm_algo="ffip", decode_chunk=4, paged_attention="flash",
                  prefill_chunk=PREFILL_CHUNK)
        with record_samples() as samples, routing() as routes:
            rec, found = serve_paged(model, params, paged_prompts,
                                     args.max_new, f"{tag} paged flash ffip",
                                     max_len=max_len, **kw)
        problems.extend(found)
        paged_runs.append(rec)
        plain = family_plain(
            model, params, paged_prompts, dict(samples=samples, routes=routes,
                                               quantized=False),
            args.max_new, batch_slots=PAGED_SLOTS, max_len=max_len,
            paged=True, page_size=PAGE_SIZE, prefill_chunk=PREFILL_CHUNK,
            decode_chunk=4)
        readings.read(rec["label"], rec["done"], plain, "float")
        del plain
        free_device()
    if cfg.moe is None:
        # one dispatch of each kind, counted and profiled: 7 projections a
        # layer and the unembed through K3, attention once a layer (K4 in
        # the contiguous prefill, K5 in either paged dispatch)
        steps = {f"{tag} {k}": v for k, v in contiguous_steps(
            model, params, 128).items()}
        if paged:
            steps.update({f"{tag} {k}": v for k, v in paged_steps(
                model, params).items()})
        print_profile(steps, lambda phase: {
            "ffip_gemm_y": 7 * layers + 1,
            "flash_fwd": layers if phase.endswith(" prefill") else 0,
            "flash_paged": layers if "paged" in phase else 0}, problems)
        del steps
    del model, params
    free_device()
    print(f"phase families {arch} serving: {time.perf_counter() - t0:.1f} s",
          flush=True)
    train_recs = []
    if train_shape:
        t1 = time.perf_counter()
        train_recs, _ = run_train(args, problems,
                                  runs=((arch, layers, *train_shape),),
                                  witness=False)
        free_device()
        print(f"phase families {arch} train: "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    return runs, paged_runs, train_recs


@contextlib.contextmanager
def int8_products_by_f64():
    """While this is open, the plain int8 path's integer product (the
    Eq. 15/16 algebra of ``quant.quantized_dense_apply(impl="torch")``,
    which builds an (M, pairs, N) cross term) is computed as one float64
    matmul instead: the same int32 values, since Eq. 16 with the folded beta
    is A_q W_q exactly and every int8 x int8 sum here is below 2**53 in
    magnitude. Phase families opens it only around building and reading its
    plain int8 paths, never around a served run, and reads prompts of up to
    4608 rows a dispatch through it, where the cross term would take
    minutes."""
    from repro_torch.core import fip, quant

    def exact(a, b, bias_folded, *, k_chunk=0):
        prod = torch.matmul(a.double(), b.double()).to(torch.int32)
        return prod + fip.fip_beta(b) + bias_folded

    quant.fip = types.SimpleNamespace(**{
        k: getattr(fip, k) for k in dir(fip) if not k.startswith("__")})
    quant.fip.fip_matmul_beta_folded = exact
    try:
        yield
    finally:
        quant.fip = fip


def run_families(args, readings: Readings, problems):
    """Phase families: every entry of FAMILY_RUNS in turn. Returns the
    served, paged and training records of all of them."""
    t0 = time.perf_counter()
    out = ([], [], [])
    for fam in FAMILY_RUNS:
        got = run_family(args, readings, problems, *fam)
        for acc, recs in zip(out, got):
            acc.extend(recs)
    print(f"phase families: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


@contextlib.contextmanager
def plain_recurrence():
    """The Mamba1 mixer's fused scan replaced, while this is open, by
    autograd through the plain f32 recurrence (``ssm._mamba1_scan``): the
    plain side of the falcon gradient reading."""
    from repro_torch.models import ssm

    fused = ssm._selective_scan_fused

    def plain(xs, dt, bmat, cmat, A, h0, chunk, *, trainable=False,
              mesh=None):
        f32 = torch.float32
        no_d = torch.zeros(A.shape[0], dtype=f32, device=A.device)
        y, h = ssm._mamba1_scan(xs.to(f32), dt.to(f32), bmat.to(f32),
                                cmat.to(f32), A, no_d, h0, chunk)
        return y, (None if trainable else h)

    ssm._selective_scan_fused = plain
    try:
        yield
    finally:
        ssm._selective_scan_fused = fused


def _leaf_names(tree, prefix=""):
    """Leaf paths in flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def one_step_grads(model, params, batch):
    """(loss, {leaf path: gradient}) of one training step's loss, on a copy
    of ``params``, as the train step computes them (``train.step.
    value_and_grad``, the reference's value_and_grad)."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    p = adamw.tree_map(lambda t: t.detach().clone(), params)
    loss, grads = tstep.value_and_grad(model, p, batch)
    return float(loss), dict(zip(_leaf_names(p), adamw.tree_leaves(grads)))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same dtype, shape and bits."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def grad_reading(arch: str, cfg, seed: int, batch_size: int, seq: int,
                 layers: int = IDENTITY_LAYERS):
    """One step's loss and per-stacked-leaf gradient relative L2 error
    through the kernels against the plain path (plain attention; for MLA
    the flash Function's plain versions, with the kernel side's expert
    choices; or autograd through the plain f32 recurrence) at the first
    ``layers`` layers, same weights and batch; then the same reading of a
    planted fault on the kernel side (a middle layer's output projection,
    for the hybrid a Mamba2 layer's, taken from the next layer). Returns
    (largest sound reading, the fault's reading)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model

    n_id = min(layers, cfg.n_layers)
    cfg_id = dataclasses.replace(cfg, n_layers=n_id)
    model = Model(cfg_id)
    params = model.init(seed)
    stack = "layers"
    data = SyntheticLM(DataConfig(global_batch=batch_size, seq_len=seq,
                                  vocab=cfg.vocab, seed=seed)).batch_at(0)
    batch = {k: torch.from_numpy(v).to(model.device)
             for k, v in data.items()}
    if cfg.encoder is not None:     # whisper: stub frames for the encoder
        from repro_torch.models.frontends import audio_frames_stub
        batch["frames"] = audio_frames_stub(
            torch.Generator(device=model.device).manual_seed(seed),
            batch_size, cfg, device=model.device)
    if cfg.family == "ssm":
        plain_model, scope = model, plain_recurrence
        group, name = "ssm", "out_proj"
    elif cfg.mla is not None:
        # MLA: the flash Function's plain versions (K4's and K8's), in the
        # formulation the kernels compute
        plain_model, scope = model, plain_flash
        group, name = "attn", "wo"
    else:
        plain_model = Model(dataclasses.replace(cfg_id,
                                                attention_impl="naive"))
        scope, group, name = contextlib.nullcontext, "attn", "wo"
        if cfg.family == "hybrid":
            stack, group, name = "hybrid_groups", "ssm", "out_proj"
    # an MoE model's plain side takes the kernel side's expert choices
    # (``routing``), the planted fault's run as the sound one's
    moe = cfg.moe is not None
    with routing() as chosen:
        loss_k, g_k = one_step_grads(model, params, batch)
    with scope(), routing(chosen if moe else None):
        loss_p, g_p = one_step_grads(plain_model, params, batch)
    sound = {k: _rel_l2(g_k[k], g_p[k]) for k in g_p}
    del g_k
    label, faulty = next_layer_fault(
        params, [(stack, group, name, "w")],
        params[stack][group][name]["w"].shape[0])
    with routing() as chosen:
        loss_f, g_f = one_step_grads(model, faulty, batch)
    if moe:
        del g_p
        with scope(), routing(chosen):
            _, g_p = one_step_grads(plain_model, params, batch)
    fault = {k: _rel_l2(g_f[k], g_p[k]) for k in g_p}
    top = max(sound, key=sound.get)
    worst = max(fault, key=fault.get)
    print(f"  [{arch} gradients, {n_id} layers, batch {batch_size} x {seq}] "
          f"loss through the kernels {loss_k:.6f}, plain {loss_p:.6f} "
          f"(rel {abs(loss_k - loss_p) / abs(loss_p):.3g}); per-leaf "
          f"relative L2 error of the gradients: largest {sound[top]:.4g} "
          f"({top}); all: "
          f"{', '.join(f'{k} {v:.3g}' for k, v in sound.items())}",
          flush=True)
    print(f"  [{arch} planted fault: {label}] loss {loss_f:.6f}; largest "
          f"per-leaf gradient error {fault[worst]:.4g} ({worst})", flush=True)
    del g_p, g_f, params, faulty, model, plain_model
    return sound[top], fault[worst]


TRAIN_OTHER_KERNELS = ("baseline_gemm", "fip_gemm", "ffip_gemm_y",
                       "flash_paged", "conv_gemm")


def profile_train_step(model, out, tcfg, batch):
    """Device time by kernel of one more training step (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.train.step import make_train_step

    step_fn = make_train_step(model, tcfg)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(out["params"], out["opt_state"], batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's device time is also its kernels', and
    # autograd's backward thread makes the two overlap
    device_ms: dict = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "device_time_total", 0) or 0)
        if us > 0:
            g = _group(ev.key)
            device_ms[g] = device_ms.get(g, 0.0) + us / 1e3
    busy = sum(device_ms.values())
    top = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
        device_ms.items(), key=lambda kv: -kv[1])[:8])
    share = f"{busy / wall_ms:.3f}" if busy else "not measured"
    print(f"  profiled step: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms (share {share}); device ms by kernel: "
          f"{top or 'not measured'}", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy, device_ms=device_ms)


def run_train(args, problems, runs=TRAIN_RUNS, witness: bool = True):
    """Train ``runs`` (minicpm-2b and falcon-mamba-7b, TRAIN_RUNS; phase moe
    deepseek-v2-lite-16b, MOE_TRAIN_RUNS) at full width through
    ``train.loop.train``: AdamW with the launcher's minicpm choice (WSD, 2
    warmup steps over 8), batches from the port's pipeline. Every step must
    launch K4 and K8 (K6 and K9) once per layer and nothing else of the
    kernels; losses and gradient norms finite (and an MoE model's aux loss);
    the last loss below the first. Then the gradient readings, and for the
    dense model the lr witness. Returns (records, readings)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import compat
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import TrainConfig

    records, readings = [], []
    for arch, n_layers, batch_size, seq in runs:
        t0 = time.perf_counter()
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=n_layers)
        model = Model(cfg)
        n_params = cfg.param_count()
        print(f"phase train: {arch} d_model {cfg.d_model}, vocab "
              f"{cfg.vocab}, {cfg.param_dtype}; n_layers {n_layers} "
              f"(published {full.n_layers}), {n_params / 1e9:.2f} B params; "
              f"batch {batch_size} x seq {seq}, {TRAIN_STEPS} AdamW steps "
              f"(lr {TRAIN_LR}, WSD, warmup 2), weights from seed "
              f"{args.seed}", flush=True)
        # attention layers: the hybrid's one shared block runs once a group
        n_attn = (n_layers // cfg.hybrid_attn_period
                  if cfg.family == "hybrid" else n_layers)
        if cfg.family == "ssm":
            want = {"selective_scan": n_layers, "selective_scan_bwd": n_layers,
                    "flash_fwd": 0, "flash_bwd": 0}
        else:
            want = {"flash_fwd": n_attn, "flash_bwd": n_attn,
                    "selective_scan": 0, "selective_scan_bwd": 0}
        want.update({k: 0 for k in TRAIN_OTHER_KERNELS})
        marks = []

        def log(m):
            marks.append((time.perf_counter(), compat.launch_counts(), m))

        tcfg = TrainConfig(optimizer=AdamWConfig(
            lr=TRAIN_LR, schedule="wsd", warmup_steps=2,
            total_steps=TRAIN_STEPS))
        torch.cuda.reset_peak_memory_stats()
        compat.reset_counters()
        t_start = time.perf_counter()
        out = train(model, loop_cfg=LoopConfig(
            total_steps=TRAIN_STEPS, global_batch=batch_size, seq_len=seq,
            log_every=1, seed=args.seed), train_cfg=tcfg, log_fn=log)
        counts = compat.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        times = [marks[0][0] - t_start] + [b[0] - a[0] for a, b in
                                           zip(marks, marks[1:])]
        prev: dict = {}
        per_step = []
        for _, c, _ in marks:
            per_step.append({k: c.get(k, 0) - prev.get(k, 0) for k in want})
            prev = c
        bad_steps = [i for i, c in enumerate(per_step) if c != want]
        hist = out["history"]
        losses = [h["loss"] for h in hist]
        norms = [h["grad_norm"] for h in hist]
        finite = all(np.isfinite(losses)) and all(np.isfinite(norms))
        falls = losses[-1] < losses[0]
        steady = times[1:]
        ms_step = 1e3 * sum(steady) / len(steady)
        tok_s = batch_size * seq / (ms_step / 1e3)
        lrs = ", ".join(f"{h['lr']:.3g}" for h in hist)
        print(f"  losses {[round(v, 4) for v in losses]}; grad norms "
              f"{[round(v, 3) for v in norms]}; lr [{lrs}]", flush=True)
        step_ms = [round(1e3 * t, 1) for t in times]
        print(f"  [{arch} train] {len(hist)} steps, finite {finite}, last "
              f"loss below the first {falls}; step ms {step_ms} (the first "
              f"includes init and first use); "
              f"{ms_step:.1f} ms/step over steps 2-{TRAIN_STEPS}, "
              f"{tok_s:.0f} tokens/s; peak memory {peak:.2f} GiB; launches "
              f"per step {per_step[0]} (every step as wanted: "
              f"{not bad_steps}); total {counts}", flush=True)
        if not finite:
            problems.append(f"{arch} train: a loss or gradient norm is not "
                            f"finite")
        if not falls:
            problems.append(f"{arch} train: the last loss {losses[-1]} is not "
                            f"below the first {losses[0]}")
        if bad_steps or len(marks) != TRAIN_STEPS:
            problems.append(f"{arch} train: steps {bad_steps} launched "
                            f"{[per_step[i] for i in bad_steps]}, want {want}")
        data = SyntheticLM(DataConfig(global_batch=batch_size, seq_len=seq,
                                      vocab=cfg.vocab, seed=args.seed))
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in data.batch_at(TRAIN_STEPS).items()}
        aux = None
        if cfg.moe is not None:
            with torch.no_grad():
                aux = float(T.forward(out["params"], batch["tokens"],
                                      cfg)[1])
            print(f"  [{arch} train] aux loss of the trained weights on the "
                  f"next batch {aux:.6f} (finite {np.isfinite(aux)})",
                  flush=True)
            if not np.isfinite(aux):
                problems.append(f"{arch} train: the aux loss is not finite")
        prof = profile_train_step(model, out, tcfg, batch)
        records.append(dict(arch=arch, n_layers=n_layers, batch=batch_size,
                            seq=seq, losses=losses, grad_norms=norms,
                            step_s=times, ms_per_step=ms_step,
                            tokens_per_s=tok_s, peak_gib=peak, aux=aux,
                            counts=counts, profile=prof))
        del out, model, batch
        free_device()
        readings.append((arch, *grad_reading(
            arch, cfg, args.seed, batch_size, seq,
            HYBRID_GRAD_LAYERS if cfg.family == "hybrid"
            else IDENTITY_LAYERS)))
        free_device()
        if cfg.family == "dense" and witness:
            lr_witness(arch, cfg, args.seed, batch_size, seq, problems)
            free_device()
        print(f"phase train {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    sound = max(r[1] for r in readings)
    fault = min(r[2] for r in readings)
    print(f"  gradient bar {GRAD_BAR}: largest sound reading {sound:.4g}; "
          f"smallest reading of a planted fault {fault:.4g}", flush=True)
    if not sound < GRAD_BAR < fault:
        problems.append(f"the gradient bar {GRAD_BAR} does not lie between "
                        f"its sound readings (up to {sound:.4g}) and its "
                        f"planted faults (from {fault:.4g})")
    return records, readings


def lr_witness(arch: str, cfg, seed: int, batch_size: int, seq: int,
               problems):
    """Train ``cfg`` for TRAIN_STEPS steps at AdamWConfig's default learning
    rate (WSD, 2 warmup steps), through the kernels and through the plain
    path (attention_impl="naive"), from the same weights and batches, and
    print both losses step by step. Where the plain path's last loss falls
    below its first and the kernels' does not, the kernels are at fault."""
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import TrainConfig

    opt = AdamWConfig(schedule="wsd", warmup_steps=2, total_steps=TRAIN_STEPS)
    losses = {}
    for impl in ("flash", "naive"):
        model = Model(dataclasses.replace(cfg, attention_impl=impl))
        out = train(model, loop_cfg=LoopConfig(
            total_steps=TRAIN_STEPS, global_batch=batch_size, seq_len=seq,
            log_every=1, seed=seed), train_cfg=TrainConfig(optimizer=opt),
            log_fn=lambda m: None)
        losses[impl] = [h["loss"] for h in out["history"]]
        del out, model
        free_device()
    kern, plain = losses["flash"], losses["naive"]
    rel = [abs(a - b) / abs(b) for a, b in zip(kern, plain)]
    print(f"  [{arch} lr witness, lr {opt.lr}] losses through the kernels "
          f"{[round(v, 4) for v in kern]}; plain path "
          f"{[round(v, 4) for v in plain]}; relative difference by step "
          f"{[float(f'{r:.3g}') for r in rel]}; last loss below the first: "
          f"kernels {kern[-1] < kern[0]}, plain {plain[-1] < plain[0]}",
          flush=True)
    if plain[-1] < plain[0] and not kern[-1] < kern[0]:
        problems.append(f"{arch} lr witness: at lr {opt.lr} the plain path's "
                        f"loss falls ({plain[0]} -> {plain[-1]}) and the "
                        f"kernels' does not ({kern[0]} -> {kern[-1]})")


# --- phase encdec: whisper-small and pixtral-12b ---------------------------

class FrontendPlain:
    """The plain path of a frontend run (``frontend_run``): the same batch
    prefilled with its frames or patches through torch.matmul (float) or the
    plain int8 algebra and plain attention (attention_impl "naive"), then
    decode steps fed the served tokens, so that every served token is read
    against the plain logits after the served tokens before it
    (``token_readings``)."""

    def __init__(self, model, params, tokens, quantized: bool, steps: int,
                 *, frames=None, patches=None):
        from repro_torch.core.gemm import GemmConfig
        from repro_torch.core.quant import attach_quantized_weights
        from repro_torch.models.model import Model

        self.model = Model(dataclasses.replace(model.cfg,
                                               attention_impl="naive"),
                           device=model.device)
        self.gemm = (GemmConfig(algo="ffip", impl="torch", quantized=True,
                                k_chunk=64)
                     if quantized else GemmConfig(algo="baseline",
                                                  impl="torch"))
        self.params = (attach_quantized_weights(params) if quantized
                       else params)
        b, s = tokens.shape
        self.pos = s + (0 if patches is None else patches.shape[1])
        with self._scope():
            self.cache, logits = self.model.prefill(
                self.params, tokens,
                self.model.init_cache(b, self.pos + steps + 1),
                frames=frames, patches=patches)
        self.first = [row.float() for row in logits]

    def _scope(self):
        from repro_torch.core.gemm import use_gemm
        stack = contextlib.ExitStack()
        stack.enter_context(use_gemm(self.gemm))
        stack.enter_context(torch.no_grad())
        return stack

    def token_readings(self, done):
        """(first tokens equal to the plain argmax, worst first-token
        shortfall, worst shortfall of every later token), each token read
        against the plain logits after the served tokens before it (one
        batched plain decode step a position, from a copy of the prompt's
        cache; ``done`` lists the batch's rows in order)."""
        from repro_torch.optim import adamw

        ids = torch.tensor([r.out_tokens for r in done],
                           device=self.model.device)
        exact = sum(int(ids[i, 0]) == int(lg.argmax())
                    for i, lg in enumerate(self.first))
        first = max(shortfall(lg, int(ids[i, 0]))
                    for i, lg in enumerate(self.first))
        later = 0.0
        cache = adamw.tree_map(torch.clone, self.cache)
        with self._scope():
            for t in range(1, ids.shape[1]):
                cache, logits = self.model.decode_step(
                    self.params, ids[:, t - 1:t], cache, self.pos + t - 1)
                later = max([later] + [shortfall(lg.float(), int(ids[i, t]))
                                       for i, lg in enumerate(logits)])
        return exact, first, later


def frontend_run(model, params, tokens, steps: int, label: str, *, algo,
                 quantized, frames=None, patches=None):
    """The frontend entry point through the kernels on one card
    (``dist.parity.frontend_run``): ``Model.prefill`` with the batch's
    frames or patches, then ``steps`` greedy ``decode_step``s at positions
    that count the prefix, in the GEMM scope of a
    ``BatchServer(gemm_algo=algo, gemm_impl="cuda", quantized=)`` and on
    the weights it prepares first (int8 copies, FFIP y-deltas and carry
    tables); the launch counts zeroed before and read after."""
    from repro_torch.dist import parity

    b, s = tokens.shape
    rec = parity.frontend_run(None, model.device, cfg=model.cfg, rows=b,
                              prompt=s, steps=steps, quantized=quantized,
                              algo=algo, params=params, tokens=tokens,
                              frames=frames, patches=patches)
    free_device()
    done = [types.SimpleNamespace(rid=i, out_tokens=row)
            for i, row in enumerate(rec["tokens"])]
    print(f"  [{label}] {b} rows x {s} tokens"
          f"{'' if patches is None else f' behind {patches.shape[1]} patches'}"
          f"{'' if frames is None else f' over {frames.shape[1]} frames'}: "
          f"prefill {rec['prefill_s']:.3f} s, {steps} decode steps "
          f"{rec['ms_per_step']:.1f} ms/step; peak memory "
          f"{rec['peak_gib']:.2f} GiB; launches {rec['launches']}",
          flush=True)
    return dict(label=label, algo=algo, quantized=quantized, done=done,
                counts=rec["launches"], first=rec["first"].to(model.device),
                prefill_s=rec["prefill_s"], ms_per_step=rec["ms_per_step"],
                peak_gib=rec["peak_gib"])


def read_frontend(readings: Readings, runs, faults, model, params, tokens,
                  **inputs):
    """Every served token of each run against the plain path of the same
    batch and inputs (a sound float run's kernel-path prefill logits too, as
    a sound reading), then each planted fault's run, which must read above
    its tier's bar. The plain int8 paths are built and read with their
    products by one float64 matmul."""
    plains = {}
    for r in runs + faults:
        quantized = r["quantized"]
        fault = any(r is f for f in faults)
        with (int8_products_by_f64() if quantized
              else contextlib.nullcontext()):
            if quantized not in plains:
                plains[quantized] = FrontendPlain(
                    model, params, tokens, quantized,
                    max(len(x["done"][0].out_tokens) for x in runs + faults),
                    **inputs)
            plain = plains[quantized]
            readings.read(r["label"], r["done"], plain,
                          "int8" if quantized else "float", fault=fault)
        if not quantized and not fault:
            readings.deviation(r["label"], [
                float((got - ref).abs().max() / ref.std())
                for got, ref in zip(r["first"], plain.first)])
    del plains
    free_device()


# kernels an LM's served run must not launch unless it names them
LM_IDLE_KERNELS = ("flash_fwd", "flash_paged", "flash_bwd", "conv_gemm",
                   "selective_scan", "selective_scan_bwd")


def check_launches(problems, r, want: dict):
    """A run's launch counts against ``want``: a count, or None for a
    kernel that must launch; the attention, conv and scan kernels it does
    not name must not launch."""
    c = r["counts"]
    for name in set(want) | set(LM_IDLE_KERNELS):
        n, got = want.get(name, 0), c.get(name, 0)
        if (n is None and got == 0) or (n is not None and got != n):
            problems.append(f"{r['label']}: {name} launched {got} times, "
                            f"want {'some' if n is None else n}")


def whisper_train(args, problems, model, params):
    """whisper-small trained TRAIN_STEPS AdamW steps (lr TRAIN_LR, WSD, 2
    warmup steps) through ``Model.loss(frames=)``: K4 and K8 once per
    encoder layer (non-causal, S n_frames) and once per decoder layer
    (causal) a step, no other kernel; batches of the port's data pipeline
    at WHISPER_TRAIN, new stub frames each step. Then ``grad_reading``
    under GRAD_BAR. Returns the training record."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import compat
    from repro_torch.models.frontends import audio_frames_stub
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig, make_train_step

    cfg, dev = model.cfg, model.device
    batch_size, seq = WHISPER_TRAIN
    n_att = cfg.n_layers + cfg.encoder.n_layers
    want = {"flash_fwd": n_att, "flash_bwd": n_att}
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=TRAIN_LR, schedule="wsd", warmup_steps=2, total_steps=TRAIN_STEPS))
    step = make_train_step(model, tcfg)
    data = SyntheticLM(DataConfig(global_batch=batch_size, seq_len=seq,
                                  vocab=cfg.vocab, seed=args.seed))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def batch_at(i):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(i).items()}
        batch["frames"] = audio_frames_stub(gen, batch_size, cfg, device=dev)
        return batch

    p = adamw.tree_map(lambda t: t.clone(), params)
    state = adamw.init(p)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, bad, counts = [], [], [], [], {}
    for i in range(TRAIN_STEPS):
        batch = batch_at(i)
        compat.reset_counters()
        t0 = time.perf_counter()
        p, state, m = step(p, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
        c = compat.launch_counts()
        if any(c[k] != want.get(k, 0) for k in c):
            bad.append((i, c))
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = all(np.isfinite(losses)) and all(np.isfinite(norms))
    falls = losses[-1] < losses[0]
    ms_step = 1e3 * sum(times[1:]) / (len(times) - 1)
    print(f"  losses {[round(v, 4) for v in losses]}; grad norms "
          f"{[round(v, 3) for v in norms]}", flush=True)
    print(f"  [whisper-small train] {TRAIN_STEPS} steps at batch "
          f"{batch_size} x {seq} tokens over {cfg.encoder.n_frames} frames, "
          f"finite {finite}, last loss below the first {falls}; step ms "
          f"{[round(1e3 * t, 1) for t in times]}; {ms_step:.1f} ms/step over "
          f"steps 2-{TRAIN_STEPS}; peak memory {peak:.2f} GiB; launches per "
          f"step {want} (every step as wanted: {not bad})", flush=True)
    if not finite:
        problems.append("whisper-small train: a loss or gradient norm is not "
                        "finite")
    if not falls:
        problems.append(f"whisper-small train: the last loss {losses[-1]} "
                        f"is not below the first {losses[0]}")
    if bad:
        problems.append(f"whisper-small train: steps launched {bad}, want "
                        f"{want}")
    del p, state
    free_device()
    sound, fault = grad_reading("whisper-small", cfg, args.seed, batch_size,
                                seq)
    if not sound < GRAD_BAR < fault:
        problems.append(f"whisper-small: the gradient bar {GRAD_BAR} does "
                        f"not lie between its sound reading {sound:.4g} and "
                        f"its planted fault {fault:.4g}")
    free_device()
    return dict(arch="whisper-small", losses=losses, grad_norms=norms,
                step_s=times, ms_per_step=ms_step, peak_gib=peak,
                counts=counts)


def run_whisper(args, readings: Readings, problems):
    """whisper-small at its published 12 + 12 layers and widths: the
    frontend entry point (``Model.prefill(frames=)``, ENCDEC_ROWS rows of
    1500 stub frames and a WHISPER_PROMPT-token decoder prompt, then
    greedy decode steps against the cached cross K/V) in ffip, baseline and
    int8 ffip; the planted faults; BatchServer (the scatter prefill, as the
    reference serves it, over a fresh cache's zeroed cross K/V); then
    trained. Returns the runs whose launches the kernels line counts."""
    from repro_torch import configs
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import serve
    from repro_torch.models.frontends import audio_frames_stub
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = configs.get_config("whisper-small")
    enc = cfg.encoder
    print(f"phase encdec: {cfg.name} d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}x{cfg.hd} (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, tied, norm {cfg.norm}, act {cfg.act}, qkv "
          f"bias {cfg.qkv_bias}; encoder {enc.n_layers} layers over "
          f"{enc.n_frames} frames, decoder {cfg.n_layers} layers (published, "
          f"no cut), {cfg.param_count() / 1e9:.3f} B params, "
          f"{cfg.param_dtype}", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    frames = audio_frames_stub(gen, ENCDEC_ROWS, cfg, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (ENCDEC_ROWS, WHISPER_PROMPT))).to(dev)
    n_att = enc.n_layers + cfg.n_layers
    gemm = {"ffip": "ffip_gemm_y", "baseline": "baseline_gemm"}
    runs = []
    for algo, quantized in (("ffip", False), ("baseline", False),
                            ("ffip", True)):
        r = frontend_run(model, params, tokens, args.max_new,
                         f"whisper {'int8-' if quantized else ''}{algo}",
                         algo=algo, quantized=quantized, frames=frames)
        check_launches(problems, r, {"flash_fwd": n_att, gemm[algo]: None})
        runs.append(r)
    faults = []
    for paths, n in (((("encoder", "layers", "attn", "wo", "w"),),
                      enc.n_layers),
                     ((("layers", "xattn", "wk", "w"),
                       ("layers", "xattn", "wv", "w")), cfg.n_layers)):
        label, faulty = next_layer_fault(params, paths, n)
        for quantized in (False, True):
            tier = "int8" if quantized else "float"
            faults.append(frontend_run(
                model, faulty, tokens, args.max_new,
                f"whisper planted fault: {label}, {tier} ffip", algo="ffip",
                quantized=quantized, frames=frames))
        del faulty
    print(f"phase encdec whisper serve: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t1 = time.perf_counter()
    read_frontend(readings, runs, faults, model, params, tokens,
                  frames=frames)
    print(f"phase encdec whisper check: {time.perf_counter() - t1:.1f} s",
          flush=True)

    t1 = time.perf_counter()
    prompts = served_prompts(cfg.vocab, args.seed)
    compat.reset_counters()
    srv, done, wall = serve(model, params, prompts, max_new=args.max_new,
                            batch_slots=4, max_len=256, gemm_algo="ffip",
                            gemm_impl="cuda")
    st = srv.stats
    del srv
    served = dict(label="whisper BatchServer ffip", quantized=False,
                  done=done, counts=compat.launch_counts())
    print(f"  [{served['label']}] {len(done)}/{len(prompts)} requests, "
          f"{st['prefill_dispatches']} scatter-prefill dispatches (one a "
          f"prompt), {st['steps']} decode steps, "
          f"{1e3 * st['decode_s'] / max(1, st['steps']):.1f} ms/step; "
          f"launches {served['counts']}", flush=True)
    check_launches(problems, served, {
        "flash_fwd": cfg.n_layers * len(prompts), "ffip_gemm_y": None,
        "ffip_carry_table": None})
    if (st["prefill_dispatches"] != len(prompts)
            or any(len(r.out_tokens) != args.max_new for r in done)):
        problems.append("whisper BatchServer: not one scatter prefill a "
                        "prompt, or a request missed its budget")
    readings.read(served["label"], done,
                  PlainPath(model, params, prompts, False), "float")
    free_device()
    print(f"phase encdec whisper BatchServer: {time.perf_counter() - t1:.1f} "
          f"s", flush=True)

    t1 = time.perf_counter()
    train_rec = whisper_train(args, problems, model, params)
    print(f"phase encdec whisper train: {time.perf_counter() - t1:.1f} s",
          flush=True)
    del model, params, frames
    free_device()
    print(f"phase encdec whisper: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return runs + faults + [served, train_rec]


def run_pixtral(args, readings: Readings, problems):
    """pixtral-12b at its published widths and PIXTRAL_LAYERS layers (one
    card's memory): the frontend entry point (``Model.prefill(patches=)``,
    ENCDEC_ROWS rows of frontend_tokens stub patch embeddings and a
    PIXTRAL_PROMPT-token prompt, then greedy decode steps at positions that
    count the prefix) in ffip and int8 ffip; the planted faults (attn.wo
    from the next layer; the prompts without their patches); then text only
    through BatchServer, contiguous and paged through K5. Returns the runs
    whose launches the kernels line counts."""
    from repro_torch import configs
    from repro_torch.models.frontends import vision_patches_stub
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    full = configs.get_config("pixtral-12b")
    cfg = dataclasses.replace(full, n_layers=PIXTRAL_LAYERS)
    print(f"phase encdec: {cfg.name} d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}x{cfg.hd} (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, untied, rope theta {cfg.rope_theta:g}, "
          f"{cfg.frontend_tokens} patch tokens; n_layers {cfg.n_layers} "
          f"(published {full.n_layers}), {cfg.param_count() / 1e9:.2f} B "
          f"params, {cfg.param_dtype}", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    patches = vision_patches_stub(gen, ENCDEC_ROWS, cfg, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (ENCDEC_ROWS, PIXTRAL_PROMPT))).to(dev)
    print(f"  weights in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    n = cfg.n_layers
    runs = []
    for quantized in (False, True):
        r = frontend_run(model, params, tokens, args.max_new,
                         f"pixtral {'int8-' if quantized else ''}ffip",
                         algo="ffip", quantized=quantized, patches=patches)
        check_launches(problems, r, {"flash_fwd": n, "ffip_gemm_y": None})
        runs.append(r)
    label, faulty = next_layer_fault(params, (("layers", "attn", "wo", "w"),),
                                     n)
    faults = [frontend_run(model, faulty, tokens, args.max_new,
                           f"pixtral planted fault: {label}, {tier} ffip",
                           algo="ffip", quantized=q, patches=patches)
              for q, tier in ((False, "float"), (True, "int8"))]
    del faulty
    free_device()
    faults += [frontend_run(model, params, tokens, args.max_new,
                            f"pixtral planted fault: the prompts without "
                            f"their patches, {tier} ffip", algo="ffip",
                            quantized=q)
               for q, tier in ((False, "float"), (True, "int8"))]
    print(f"phase encdec pixtral serve: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t1 = time.perf_counter()
    read_frontend(readings, runs, faults, model, params, tokens,
                  patches=patches)
    print(f"phase encdec pixtral check: {time.perf_counter() - t1:.1f} s",
          flush=True)

    t1 = time.perf_counter()
    prompts = served_prompts(cfg.vocab, args.seed)
    served = drive_main_path(model, params, prompts, args.max_new,
                             tag="pixtral text ", variants=(("ffip", False),))
    for r in served:
        check_launches(problems, r, {
            "flash_fwd": n * r["stats"]["prefill_dispatches"],
            "ffip_gemm_y": None, "ffip_carry_table": None})
        if not r["budget_ok"]:
            problems.append(f"{r['label']}: a request missed its budget")
        readings.read(r["label"], r["done"],
                      PlainPath(model, params, prompts, False), "float")
    free_device()
    paged_prompts = family_prompts(cfg.vocab, args.seed, None, True)
    rec, found = serve_paged(model, params, paged_prompts, args.max_new,
                             "pixtral text paged flash ffip",
                             max_len=PAGED_MAX_LEN, gemm_algo="ffip",
                             decode_chunk=4, paged_attention="flash",
                             prefill_chunk=PREFILL_CHUNK)
    problems.extend(found)
    readings.read(rec["label"], rec["done"],
                  PlainPath(model, params, paged_prompts, False), "float")
    del model, params, patches
    free_device()
    print(f"phase encdec pixtral BatchServer: {time.perf_counter() - t1:.1f} "
          f"s", flush=True)
    print(f"phase encdec pixtral: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return runs + faults + served + [rec]


def run_encdec(args, readings: Readings, problems):
    """Phase encdec: whisper-small, then pixtral-12b. Returns every run
    whose launches the kernels line counts."""
    t0 = time.perf_counter()
    recs = run_whisper(args, readings, problems)
    recs += run_pixtral(args, readings, problems)
    print(f"phase encdec: {time.perf_counter() - t0:.1f} s", flush=True)
    return recs


def run_hybrid(args, readings: Readings, problems):
    """zamba2-1.2b at its published widths and HYBRID_LAYERS layers through the
    Mamba2 + shared attention path: served four ways (every prompt its own
    scatter prefill, K4 once per group's shared block, the projections
    through K1-K3, the SSD in torch ops), tokens held to the plain path
    (torch.matmul or the plain int8 algebra, plain attention, the same SSD
    code), a middle Mamba2 layer's ssm.out_proj from the next layer the
    planted fault, one prefill and one decode step profiled; then trained
    (K4 + K8 once per group a step) with its gradient reading. Returns the
    served runs and the training records."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    full = configs.get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, n_layers=HYBRID_LAYERS)
    s_cfg = cfg.ssm
    period = cfg.hybrid_attn_period
    n_groups = cfg.n_layers // period
    n_grouped = n_groups * period
    di = s_cfg.expand * cfg.d_model
    print(f"phase hybrid: {cfg.name} d_model {cfg.d_model}, d_inner {di} in "
          f"{di // s_cfg.head_dim} heads of {s_cfg.head_dim}, d_state "
          f"{s_cfg.d_state}, n_groups "
          f"{s_cfg.n_groups}, chunk {s_cfg.chunk}; shared attention "
          f"{cfg.n_heads}x{cfg.hd} (kv {cfg.n_kv_heads}) after each of "
          f"{n_groups} groups of {period}, a tail of "
          f"{cfg.n_layers - n_grouped}; vocab {cfg.vocab}, {cfg.param_dtype}, "
          f"tied; n_layers {cfg.n_layers} (published {full.n_layers}), "
          f"{cfg.param_count() / 1e9:.3f} B params", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    prompts = served_prompts(cfg.vocab, args.seed)
    print(f"  4 slots, max_len 256, prompt lengths "
          f"{[len(p) for p in prompts]}, {args.max_new} new tokens each; "
          f"weights from seed {args.seed} in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    runs = drive_main_path(model, params, prompts, args.max_new,
                           tag="zamba2 ")
    gemm = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
            "baseline": "baseline_gemm"}
    for r in runs:
        dispatches = r["stats"]["prefill_dispatches"]
        if not r["budget_ok"]:
            problems.append(f"{r['label']}: a request missed its token budget")
        if dispatches != len(prompts):
            problems.append(f"{r['label']}: {dispatches} prefill dispatches, "
                            f"want one scatter prefill a prompt")
        # K4 once per group's shared block a prefill dispatch, never at
        # decode (plain attention over the cache, as the reference's)
        check_launches(problems, r, {gemm[r["algo"]]: None,
                                     "flash_fwd": n_groups * dispatches})
    print(f"phase hybrid serve: {time.perf_counter() - t0:.1f} s", flush=True)

    t1 = time.perf_counter()
    with int8_products_by_f64():
        plain = {q: PlainPath(model, params, prompts, q)
                 for q in (False, True)}
        for r in runs:
            tier = "int8" if r["quantized"] else "float"
            readings.read(r["label"], r["done"], plain[r["quantized"]], tier)
    print(f"  plain paths built and read in {time.perf_counter() - t1:.1f} s",
          flush=True)
    for r in runs:
        if not r["quantized"]:
            readings.deviation(r["label"], kernel_deviation(
                model, params, prompts, plain[False], r["algo"]))
    label, faulty = next_layer_fault(
        params, [("hybrid_groups", "ssm", "out_proj", "w")], n_grouped)
    for quantized in (True, False):
        _, done, _ = serve(model, faulty, prompts, max_new=2, batch_slots=4,
                           max_len=256, quantized=quantized, gemm_algo="ffip",
                           gemm_impl="cuda")
        tier = "int8" if quantized else "float"
        with int8_products_by_f64():
            readings.read(f"zamba2 planted fault: {label}, {tier} ffip",
                          done, plain[quantized], tier, fault=True)
    del faulty
    print(f"phase hybrid check: {time.perf_counter() - t1:.1f} s", flush=True)
    # the sharded scan reads its zamba2 runs against these runs and paths
    tp_counts = run_dist_ssm(args, readings, problems, dict(
        model=model, prompts=prompts, runs=runs, plain=plain))
    del plain
    free_device()

    # per token: 5 Mamba2 projections a layer, 4 in each group's shared
    # block, the tied unembed
    gemms = 5 * cfg.n_layers + 4 * n_groups + 1
    print_profile(ssm_steps(model, params, tag="zamba2"), lambda phase: {
        "ffip_gemm_y": gemms,
        "flash_fwd": n_groups if phase == "zamba2 prefill" else 0},
        problems)
    del model, params
    free_device()
    print(f"phase hybrid serve and check: {time.perf_counter() - t0:.1f} s",
          flush=True)
    train_recs, _ = run_train(args, problems, runs=(
        (HYBRID_ARCH, cfg.n_layers, *HYBRID_TRAIN),), witness=False)
    print(f"phase hybrid: {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, train_recs, tp_counts


def run_faults(dev, problems):
    """Phase faults (ROADMAP queue 3). F7: ResNet-50 s2b1.c2's geometry at
    batch 2 on unit-normal data under PyTorch's default cuDNN flags (TF32
    allowed), ``F.conv2d`` as called before the repair and the baseline
    conv of the torch provider (``vision.layers._nchw_conv``) after it,
    each against the host's f32 conv under the reference's f32 GEMM bar;
    the repaired one must hold it and leave the flags as it found them.
    F6: the zamba2 and minicpm smoke models, bf16, int8 FFIP through the
    kernels, give the host's tokens (the prompts and schedule of
    tests/test_torch_cuda.py's zamba2 case)."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import Model
    from repro_torch.vision import layers as vl

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 56, 56, 64), generator=g)
    w = torch.randn((3, 3, 64, 64), generator=g)

    def nchw(x_, w_):
        return F.conv2d(x_.permute(0, 3, 1, 2), w_.permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)

    cudnn = torch.backends.cudnn
    legacy = cudnn.allow_tf32
    cudnn.allow_tf32 = True                  # PyTorch's default
    try:
        flags = (cudnn.allow_tf32,
                 getattr(getattr(cudnn, "conv", None), "fp32_precision",
                         None))
        with torch.no_grad(), use_gemm(GemmConfig()):
            want = nchw(x, w).double()
            before = nchw(x.to(dev), w.to(dev)).cpu().double()
            after = vl.conv2d(x.to(dev), {"w": w.to(dev)},
                              pad=1).cpu().double()
        kept = flags == (cudnn.allow_tf32,
                         getattr(getattr(cudnn, "conv", None),
                                 "fp32_precision", None))
    finally:
        cudnn.allow_tf32 = legacy
    bar = 1e-3 * (3 * 3 * 64 // 64) + 1e-4 * want.abs()
    for label, got in (("F.conv2d under the default flags (before)", before),
                       ("vision.layers._nchw_conv (after)", after)):
        d = (got - want).abs()
        print(f"  F7 {label}: max abs err {float(d.max()):.6g}, worst "
              f"err / bar {float((d / bar).max()):.4g}, "
              f"{int((d > bar).sum())} of {d.numel()} over the bar",
              flush=True)
    if bool(((after - want).abs() > bar).any()) or not kept:
        problems.append(f"F7: the baseline conv misses the f32 bar or "
                        f"changed the caller's flags (kept {kept})")

    for arch in ("zamba2-1.2b", "minicpm-2b"):
        cfg = dataclasses.replace(
            configs.smoke_config(configs.get_config(arch)),
            param_dtype="bfloat16")
        prompts = make_prompts(cfg.vocab, 6, np.random.default_rng(5), 3,
                               16)
        kw = dict(max_new=6, batch_slots=2, max_len=32, gemm_algo="ffip",
                  gemm_impl="cuda", quantized=True, decode_chunk=4)
        host = Model(cfg, device="cpu")
        params = host.init(0)
        _, want_t, _ = serve(host, params, prompts, **kw)
        _, got_t, _ = serve(Model(cfg, device=dev), _tree_to(params, dev),
                            prompts, **kw)
        same = ({r.rid: r.out_tokens for r in got_t}
                == {r.rid: r.out_tokens for r in want_t})
        print(f"  F6 {arch} smoke, bf16 int8 ffip: card tokens equal to "
              f"the host's: {same}", flush=True)
        if not same:
            problems.append(f"F6: {arch} int8 tokens on the card differ "
                            f"from the host's")
    print(f"phase faults: {time.perf_counter() - t0:.1f} s", flush=True)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def run_tune(args, model, params, prompts, ffip_done, problems):
    """Phase tune: ``launch.tune --arch minicpm-2b`` over its served (K, N)
    set at the M buckets the served runs dispatch (decode 4, bucketed
    prefill 4 x 16..128), ffip / fip / baseline in bf16 and int8, and the
    flash buckets of their prefills, into a temporary REPRO_TUNE_CACHE; one
    ResNet-50 conv (s2b1.c2, batch 8, f32 FFIP) through
    ``tune.tune_conv``. The tuner holds every candidate against the
    default bit for bit (``tune.measure``). A second CLI run with
    ``--expect-cached`` must measure nothing. Then minicpm-2b served ffip
    with ``gemm_block="auto"``: no miss, the main phase's ffip tokens.
    Returns the phase's launch counts and the tuned entries."""
    import os
    import tempfile

    from repro_torch import tune
    from repro_torch.kernels import compat
    from repro_torch.launch import tune as launch_tune
    from repro_torch.launch.serve import serve
    from repro_torch.tune import measure

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tune_")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp, "schedules.json")
    print(f"phase tune: minicpm-2b's GEMM buckets (M {TUNE_M}), "
          f"ffip/fip/baseline x bf16/int8, its flash buckets; ResNet-50 "
          f"s2b1.c2 f32 ffip; cache {os.environ['REPRO_TUNE_CACHE']}",
          flush=True)
    compat.reset_counters()
    argv = ["--arch", "minicpm-2b", "--m", TUNE_M, "--slots", "4",
            "--seq", TUNE_SEQ, "--algos", "ffip,fip,baseline",
            "--dtypes", "bfloat16,int8", "--iters", "3"]
    timed0 = measure.counters["timed_candidates"]
    if launch_tune.main(argv) != 0:
        problems.append("tune: the tuner failed")
    conv = tune.tune_conv(CONV_BATCH, 56, 56, 64, 64, 3, 3, torch.float32,
                          pad=1, algo="ffip", iters=3)
    print(f"  [tuned ] conv ffip float32 resnet50 s2b1.c2 batch "
          f"{CONV_BATCH} -> {conv['blocks']} ({conv['us']}us, default "
          f"{conv['default_blocks']} {conv['default_us']}us, "
          f"{conv['candidates']} candidates)", flush=True)
    tune.get_cache().save()
    timed = measure.counters["timed_candidates"] - timed0
    print(f"  {timed} candidates timed, each bit for bit the default's "
          f"({measure.counters['failed_candidates']} failed); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if measure.counters["failed_candidates"]:
        problems.append("tune: a candidate failed or disagreed")
    warm0 = measure.counters["timed_candidates"]
    if launch_tune.main(argv + ["--expect-cached"]) != 0 or (
            measure.counters["timed_candidates"] != warm0):
        problems.append("tune: the warm --expect-cached run measured")
    print(f"  warm --expect-cached: "
          f"{measure.counters['timed_candidates'] - warm0} measurements",
          flush=True)
    entries = tune.get_cache().entries_for_device(compat.device_kind())
    tune.reset_stats()
    _, done, _ = serve(model, params, prompts, max_new=args.max_new,
                       batch_slots=4, max_len=256, gemm_algo="ffip",
                       gemm_impl="cuda", gemm_block="auto")
    same = ({r.rid: r.out_tokens for r in done}
            == {r.rid: r.out_tokens for r in ffip_done})
    print(f"  served ffip with gemm_block='auto': {dict(tune.stats)} "
          f"lookups, tokens equal to the static default's: {same}",
          flush=True)
    if tune.stats["misses"] or not same:
        problems.append(f"tune: auto serving missed {tune.stats['misses']} "
                        f"lookups or changed tokens ({same})")
    counts = compat.launch_counts()
    print(f"phase tune: {time.perf_counter() - t0:.1f} s; launches {counts}",
          flush=True)
    return counts, entries


def run_prepare(args, prompts, problems, tmp: str):
    """Phase prepare: ``launch.prepare`` on minicpm-2b at its published
    widths and PREPARE_LAYERS of its 40 layers, int8 FFIP, with the tune
    phase's schedule slice; loaded, and the prompts served through
    ``BatchServer(prepared=, gemm_block="auto")``: nothing recomputed, no
    schedule miss, no carry table built while serving, and the tokens of an
    unprepared server on the same weights. Prints the bytes written, the
    load's seconds and each server's first step (its preparation, if any,
    and first prefill dispatch). The artifact stays in ``tmp`` for phase
    dist; returns (the prepared run's launch counts, the artifact's path,
    its tokens)."""
    from repro_torch import configs, prepare, tune
    from repro_torch.kernels import compat
    from repro_torch.launch import prepare as launch_prepare
    from repro_torch.models.model import Model
    from repro_torch.serve.batcher import BatchServer, Request

    t0 = time.perf_counter()
    full = configs.get_config("minicpm-2b")
    cfg = dataclasses.replace(full, n_layers=PREPARE_LAYERS)
    out = f"{tmp}/minicpm-2b.prepared"
    print(f"phase prepare: minicpm-2b at {PREPARE_LAYERS} of {full.n_layers} "
          f"layers, int8 ffip -> {out}", flush=True)
    t1 = time.perf_counter()
    if launch_prepare.main(["--arch", "minicpm-2b", "--layers",
                            str(PREPARE_LAYERS), "--quantized", "--out",
                            out, "--seed", str(args.seed)]) != 0:
        problems.append("prepare: the launcher failed")
    written = sum(f.stat().st_size for f in pathlib.Path(out).iterdir())
    print(f"  launch.prepare: {time.perf_counter() - t1:.1f} s, "
          f"{written} bytes written", flush=True)
    free_device()
    t1 = time.perf_counter()
    pm = prepare.load(out)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    print(f"  load: {load_s:.2f} s ({len(pm.derived)} y deltas, "
          f"{len(pm.schedule)} schedule entries, built at load "
          f"{pm.built})", flush=True)
    model = Model(cfg)
    tokens, first_s = {}, {}
    for label in ("prepared", "unprepared"):
        tune.reset_stats()
        compat.reset_counters()
        base = pm.recompute_report()
        kw = (dict(prepared=pm, gemm_block="auto")
              if label == "prepared" else {})
        srv = BatchServer(model, batch_slots=4, max_len=256,
                          quantized=True, gemm_algo="ffip",
                          gemm_impl="cuda", **kw)
        for i, p in enumerate(prompts):
            srv.submit(Request(rid=i, prompt=p,
                               max_new_tokens=args.max_new))
        params = None if label == "prepared" else model.init(args.seed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        srv.step(params)
        torch.cuda.synchronize()
        first_s[label] = time.perf_counter() - t1
        done = srv.run_until_drained(params)
        tokens[label] = {r.rid: list(r.out_tokens) for r in done}
        counts = compat.launch_counts()
        work = {k: v - base[k]
                for k, v in pm.recompute_report().items()}
        print(f"  [{label}] {len(done)}/{len(prompts)} requests; first "
              f"step (preparation and first prefill) "
              f"{first_s[label]:.3f} s; offline work while serving "
              f"{work}; tune {dict(tune.stats)}; launches {counts}",
              flush=True)
        if label == "prepared":
            served = counts
            if (pm.recomputed or tune.stats["misses"]
                    or counts["ffip_carry_table"]):
                problems.append(f"prepare: the prepared server derived "
                                f"{pm.recompute_report()} or missed "
                                f"{tune.stats['misses']} lookups")
        del srv, params
        free_device()
    same = tokens["prepared"] == tokens["unprepared"]
    print(f"  tokens prepared vs unprepared: "
          f"{'identical' if same else 'DIFFER'}; first step "
          f"{first_s['prepared']:.3f} s vs {first_s['unprepared']:.3f} s",
          flush=True)
    if not same:
        problems.append("prepare: the prepared server's tokens differ")
    del pm, model
    free_device()
    print(f"phase prepare: {time.perf_counter() - t0:.1f} s", flush=True)
    return served, out, tokens["prepared"]


def plant_down_shard(params, mesh):
    """Phase dist's planted fault, through the params: on rank 1 the whole
    weight's second half of layer 0's ``ffn.down`` rows (rank 1's piece once
    the server cuts K in two) set to the first half (rank 0's)."""
    if mesh.index("model") != 1:
        return params
    path = ("layers", "ffn", "down", "w")
    w = params["layers"]["ffn"]["down"]["w"]
    bad = w.clone()
    half = w.shape[-2] // 2
    bad[0, half:] = w[0, :half]
    return _with_leaf(params, path, bad)


def plant_in_proj_contiguous(params, mesh):
    """Phase dist's planted fault for the sharded scan, through the params:
    every Mamba1 layer's ``in_proj`` arranged so that the server's x | z
    cut hands each rank the contiguous piece of the concatenated width, the
    layout bug that cut prevents (at tp 2: rank 0 all of x, rank 1 all of
    z)."""
    tp, r = mesh.size("model"), mesh.index("model")
    w = params["layers"]["ssm"]["in_proj"]["w"]
    di = w.shape[-1] // 2
    n = di // tp
    bad = w.clone()
    bad[..., r * n:(r + 1) * n] = w[..., 2 * r * n:2 * r * n + n]
    bad[..., di + r * n:di + (r + 1) * n] = w[..., 2 * r * n + n:
                                              2 * (r + 1) * n]
    return _with_leaf(params, ("layers", "ssm", "in_proj", "w"), bad)


def contiguous_in_proj(specs):
    """The same layout bug planted in the mixer check's cut: every
    ``in_proj`` leaf's x | z halves spec replaced by a contiguous cut of the
    concatenated width."""
    from repro_torch.dist.sharding import Blocked, P

    if isinstance(specs, dict):
        return {k: contiguous_in_proj(v) for k, v in specs.items()}
    return P(*specs) if isinstance(specs, Blocked) else specs


def recorded_serve_job(mesh, device, **kw):
    """``launch.serve.serve_job`` with every sampled id tensor and MoE
    top-k kept (``record_samples``, ``routing``), so that ``Replay`` can
    replay the rank's dispatches through the plain path."""
    from repro_torch.launch.serve import serve_job

    with record_samples() as samples, routing() as routes:
        out = serve_job(mesh, device, **kw)
    out["samples"] = [t.cpu() for t in samples]
    out["routes"] = [t.cpu() for t in routes]
    return out


def collective_job(mesh, device, *, arch: str, layers: int, seed: int,
                   quantized: bool):
    """A rank's collectives in one decode step at 4 slots, as a server on
    the mesh runs it (``dryrun.served_steps``, after a warm-up step):
    ``(kind, bytes, group size)`` each, as ``dist.context`` issues them."""
    from repro_torch import configs
    from repro_torch.dist import context as dctx
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    model = Model(cfg, device=device)
    steps, _ = dryrun.served_steps(model, model.init(seed),
                                   quantized=quantized, mesh=mesh)
    steps["decode"]()
    with dctx.record_collectives() as records:
        steps["decode"]()
    return records


def collective_jobs(arch: str, layers: int, seed: int) -> list:
    return [(collective_job, dict(arch=arch, layers=layers, seed=seed,
                                  quantized=q)) for q in (False, True)]


def check_collectives(ranks, first: int, arch: str, layers: int, seed: int,
                      problems):
    """Each rank's counted collectives of :func:`collective_jobs` (from job
    ``first`` of each rank's results) against one rank's meta-device
    trace on a shape-only (1, DIST_TP) mesh."""
    from repro_torch import configs
    from repro_torch.dist import context as dctx
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    meta = Model(cfg, device="meta")
    mparams = meta.init(seed)
    mesh = dctx.make_mesh((1, DIST_TP), ("data", dctx.MODEL))
    for i, quantized in enumerate((False, True)):
        steps, state = dryrun.served_steps(meta, mparams,
                                           quantized=quantized, mesh=mesh)
        want = dryrun.predict_dispatch(steps["decode"], state).collectives
        tier = "int8-ffip" if quantized else "ffip"
        for r, rank in enumerate(ranks):
            got = rank[first + i]
            same = got == want
            print(f"  [tp{DIST_TP} {arch} {layers} layers {tier} decode "
                  f"step] collectives predicted {len(want)} "
                  f"({sum(b for _, b, _ in want):.0f} B), rank {r} counted "
                  f"{len(got)} ({sum(b for _, b, _ in got):.0f} B): "
                  f"{'equal' if same else 'DIFFER'}", flush=True)
            if not same:
                problems.append(f"dist {arch} {tier}: rank {r} issued "
                                f"{got}, the trace predicts {want}")


def _dist_line(label, recs):
    """Print a tensor-parallel run: rank 0's stats, every rank's peak
    memory and launches."""
    st = recs[0]["stats"]
    print(f"  [{label}] {len(recs[0]['tokens'])} requests, "
          f"{sum(len(t) for t in recs[0]['tokens'].values())} tokens; "
          f"wall {recs[0]['wall_s']:.3f} s (incl. weight preparation); "
          f"prefill {st['prefill_s']:.3f} s ({st['prefill_tokens']} tok / "
          f"{st['prefill_dispatches']} dispatches), decode "
          f"{st['decode_s']:.3f} s ({st['decode_tokens']} tok / "
          f"{st['steps']} steps, "
          f"{1e3 * st['decode_s'] / max(1, st['steps']):.1f} ms/step)",
          flush=True)
    for r, rec in enumerate(recs):
        busy = {k: v for k, v in rec["launches"].items() if v}
        print(f"    rank {r}: peak memory {rec['peak_gib']:.2f} GiB; "
              f"launches {busy}", flush=True)


def run_dist(args, prompts, artifact: str, prepared_tokens,
             readings: Readings, problems):
    """Phase dist: tensor-parallel serving on a (1, DIST_TP) mesh through
    ``launch.serve``'s rank entry (``spawn_ranks``, ``serve_job``), one
    process a rank. The tensor-parallel dense layers against the whole
    layer (``repro_torch.dist.parity``); minicpm-2b at DIST_LAYERS, float
    and int8 FFIP, read against the plain path at that depth under the
    bars, beside the count of tokens equal to a single-device run at that
    depth; the planted fault
    (``plant_down_shard``) above the float bar; phase prepare's artifact
    cut per rank, ``recomputed == 0`` and the single-device prepared
    server's tokens; deepseek-v2-lite-16b at DIST_MOE_LAYERS, int8 FFIP,
    ``moe_partition`` "expert" and "ffn", each read against the plain path
    replaying its dispatches (``Replay``), beside the count of tokens
    equal to a single-device run at the same depth. Returns the ranks'
    launch counts."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.dist import parity
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import (RankError, mesh_backend, serve,
                                          serve_job, spawn_ranks)
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    backend, devices = mesh_backend(DIST_TP, "cuda")
    print(f"phase dist: tp {DIST_TP} on a (1, {DIST_TP}) mesh, {backend}, "
          f"ranks on {devices} ({torch.cuda.device_count()} card(s): ranks "
          f"sharing one card show the sharded computation and its "
          f"collectives, not a multi-card speed)", flush=True)
    kw = dict(batch_slots=4, max_len=256, gemm_impl="cuda", gemm_algo="ffip")
    mc = dict(arch="minicpm-2b", layers=DIST_LAYERS, seed=args.seed,
              prompts=prompts, max_new=DIST_MAX_NEW)
    ds_cfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                                 n_layers=DIST_MOE_LAYERS)
    ds_prompts = served_prompts(ds_cfg.vocab, args.seed)
    ds = dict(arch=MOE_ARCH, layers=DIST_MOE_LAYERS, seed=args.seed,
              prompts=ds_prompts, max_new=DIST_MAX_NEW)
    labels = ["ffip", "int8-ffip", "planted fault", "prepared int8-ffip",
              "deepseek int8-ffip expert", "deepseek int8-ffip ffn"]
    jobs = [
        (parity.layer_parity, dict(shapes=DIST_LAYER_SHAPES, dtype="bf16")),
        (serve_job, dict(mc, server_kw=dict(kw, quantized=False))),
        (serve_job, dict(mc, server_kw=dict(kw, quantized=True))),
        (serve_job, dict(mc, server_kw=dict(kw, quantized=False),
                         plant=plant_down_shard)),
        (serve_job, dict(mc, layers=PREPARE_LAYERS, prepared=artifact,
                         server_kw=dict(kw, quantized=True,
                                        gemm_block="auto"))),
        (recorded_serve_job, dict(ds, server_kw=dict(
            kw, quantized=True, moe_partition="expert"))),
        (recorded_serve_job, dict(ds, server_kw=dict(
            kw, quantized=True, moe_partition="ffn"))),
    ] + collective_jobs("minicpm-2b", DIST_LAYERS, args.seed)
    totals = {name: 0 for name in compat.launch_counts()}
    try:
        ranks = spawn_ranks(DIST_TP, jobs, device="cuda", timeout_s=600)
    except RankError as e:
        problems.append(f"dist: {e}")
        return totals
    ranks_s = time.perf_counter() - t0
    print(f"  ranks: {ranks_s:.1f} s (start, weights, serving)", flush=True)
    check_collectives(ranks, 1 + len(labels), "minicpm-2b", DIST_LAYERS,
                      args.seed, problems)

    worst = {}
    for r, rank in enumerate(ranks):
        for label, rec in rank[0].items():
            kind = label.split(" M=")[0]
            worst[kind] = max(worst.get(kind, 0.0), rec["max_abs_err"])
            if not rec["ok"]:
                problems.append(f"dist: rank {r}: {label} off the whole "
                                f"layer ({rec['tol']}): {rec['max_abs_err']}")
    print(f"  layer checks ({len(ranks[0][0])} a rank, M in (4, 512), K x N "
          f"in {[kn[1:] for kn in DIST_LAYER_SHAPES[:3]]}): worst max_abs "
          f"{worst}", flush=True)
    by = {label: [rank[i + 1] for rank in ranks]
          for i, label in enumerate(labels)}
    for label, recs in by.items():
        _dist_line(f"tp{DIST_TP} {label}", recs)
        for r, rec in enumerate(recs):
            for name, n in rec["launches"].items():
                totals[name] += n
            if rec["tokens"] != recs[0]["tokens"]:
                problems.append(f"dist {label}: rank {r}'s tokens differ "
                                f"from rank 0's")
            if not (rec["launches"]["ffip_gemm_y"]
                    and rec["launches"]["flash_fwd"]):
                problems.append(f"dist {label}: rank {r} launched no "
                                f"ffip_gemm_y or flash_fwd")
        if any(len(t) != DIST_MAX_NEW for t in recs[0]["tokens"].values()):
            problems.append(f"dist {label}: a request missed its budget")

    def done(rec):
        return [SimpleNamespace(rid=rid, out_tokens=toks)
                for rid, toks in sorted(rec["tokens"].items())]

    mc_model = Model(dataclasses.replace(configs.get_config("minicpm-2b"),
                                         n_layers=DIST_LAYERS))
    mc_params = mc_model.init(args.seed)
    plain = {q: PlainPath(mc_model, mc_params, prompts, q)
             for q in (False, True)}
    for label, tier, quantized in (("ffip", "float", False),
                                   ("int8-ffip", "int8", True)):
        rec = by[label][0]
        _, single, _ = serve(mc_model, mc_params, prompts,
                             max_new=DIST_MAX_NEW, quantized=quantized, **kw)
        same = sum(a == b for r in single
                   for a, b in zip(rec["tokens"][r.rid], r.out_tokens))
        print(f"  [tp{DIST_TP} {label}] {same} of "
              f"{sum(map(len, rec['tokens'].values()))} tokens equal to "
              f"the single-device run at {DIST_LAYERS} layers", flush=True)
        readings.read(f"tp{DIST_TP} {label} ({DIST_LAYERS} layers)",
                      done(rec), plain[quantized], tier)
    readings.read(f"tp{DIST_TP} planted fault: rank 1's piece of layer 0's "
                  f"ffn.down taken from rank 0's, float ffip",
                  done(by["planted fault"][0]), plain[False], "float",
                  fault=True)
    del mc_model, mc_params, plain
    for r, rec in enumerate(by["prepared int8-ffip"]):
        print(f"  [tp{DIST_TP} prepared int8-ffip] rank {r}: recomputed "
              f"{rec['recomputed']}, built at the cut {rec['built']}, "
              f"schedule misses {rec['tune_misses']} (a rank's local "
              f"buckets; a miss takes the static default)", flush=True)
        if any(rec["recomputed"].values()):
            problems.append(f"dist prepared: rank {r} recomputed "
                            f"{rec['recomputed']}")
    n = min(DIST_MAX_NEW, args.max_new)
    same = {rid: toks[:n] for rid, toks in
            by["prepared int8-ffip"][0]["tokens"].items()} == {
        rid: toks[:n] for rid, toks in prepared_tokens.items()}
    print(f"  [tp{DIST_TP} prepared int8-ffip] tokens vs the single-device "
          f"prepared server's: {'identical' if same else 'DIFFER'}",
          flush=True)
    if not same:
        problems.append("dist prepared: tokens differ from the single-device "
                        "prepared server's")

    ds_model = Model(ds_cfg)
    ds_params = ds_model.init(args.seed)
    _, single, _ = serve(ds_model, ds_params, ds_prompts,
                         max_new=DIST_MAX_NEW, quantized=True, **kw)
    single = {r.rid: list(r.out_tokens) for r in single}
    for part in ("expert", "ffn"):
        rec = by[f"deepseek int8-ffip {part}"][0]
        same = sum(a == b for rid in single
                   for a, b in zip(rec["tokens"][rid], single[rid]))
        print(f"  [tp{DIST_TP} deepseek int8-ffip {part}] {same} of "
              f"{sum(map(len, single.values()))} tokens equal to the "
              f"single-device run at {DIST_MOE_LAYERS} layers", flush=True)
        replay = Replay(ds_model, ds_params, ds_prompts,
                        [t.cuda() for t in rec["samples"]],
                        [t.cuda() for t in rec["routes"]], DIST_MAX_NEW,
                        quantized=True, batch_slots=4, max_len=256)
        readings.read(f"tp{DIST_TP} deepseek int8-ffip {part} "
                      f"({DIST_MOE_LAYERS} layers)", done(rec), replay,
                      "int8")
        del replay
    del ds_model, ds_params
    print(f"phase dist: {time.perf_counter() - t0:.1f} s", flush=True)
    return totals


def run_dist_ssm(args, readings: Readings, problems, zamba: dict):
    """Phase dist, the sharded scan, on a (1, DIST_TP) mesh (``spawn_ranks``,
    ``serve_job``): K6 on a rank's half of falcon-mamba-7b's d_inner against
    the whole K6's columns and the Mamba1 and Mamba2 mixers at full widths
    against the whole mixer (``repro_torch.dist.parity``), each mixer's
    output deviation read in sd of the whole mixer's output beside the
    token readings; falcon-mamba-7b at DIST_SSM_LAYERS and zamba2-1.2b at
    HYBRID_LAYERS, float and int8 FFIP, each read against the plain path
    under the bars beside the count of tokens equal to a single card
    (falcon: a single-device run at the same depth, read against its own
    plain paths; zamba2: phase hybrid's runs and plain paths, ``zamba``).
    The planted fault, falcon's in_proj cut contiguously over x | z: read
    in the mixer check (gated: above each tier's bar) and in a served
    float run (its tokens, printed ungated: at 8 random layers a falcon
    token follows its prompt's last embedding, which the mixers barely
    move). Returns the ranks' launch counts."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.dist import parity
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import (RankError, serve, serve_job,
                                          spawn_ranks)
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    f_cfg = dataclasses.replace(configs.get_config("falcon-mamba-7b"),
                                n_layers=DIST_SSM_LAYERS)
    f_di = f_cfg.ssm.expand * f_cfg.d_model
    z_cfg = zamba["model"].cfg
    n_groups = z_cfg.n_layers // z_cfg.hybrid_attn_period
    print(f"phase dist, the sharded scan: tp {DIST_TP}, falcon-mamba-7b "
          f"d_inner {f_di} ({f_di // DIST_TP} a rank) at "
          f"{DIST_SSM_LAYERS} of 64 layers, zamba2-1.2b "
          f"{z_cfg.ssm.expand * z_cfg.d_model // z_cfg.ssm.head_dim} heads "
          f"of {z_cfg.ssm.head_dim} and its shared block's {z_cfg.n_heads} "
          f"attention heads ({DIST_TP} ranks: half each) at "
          f"{z_cfg.n_layers} layers", flush=True)
    kw = dict(batch_slots=4, max_len=256, gemm_impl="cuda", gemm_algo="ffip")
    f_prompts = served_prompts(f_cfg.vocab, args.seed)
    fc = dict(arch="falcon-mamba-7b", layers=DIST_SSM_LAYERS, seed=args.seed,
              prompts=f_prompts, max_new=DIST_MAX_NEW)
    zc = dict(arch=HYBRID_ARCH, layers=z_cfg.n_layers, seed=args.seed,
              prompts=zamba["prompts"], max_new=DIST_MAX_NEW)
    checks = [(parity.scan_columns, dict(di=f_di, n=f_cfg.ssm.d_state,
                                         cases=DIST_SCAN_CASES)),
              (parity.mixer_parity, dict(arch="falcon-mamba-7b",
                                         cases=DIST_MIXER_CASES)),
              (parity.mixer_parity, dict(arch=HYBRID_ARCH,
                                         cases=DIST_MIXER_CASES)),
              (parity.mixer_parity, dict(arch="falcon-mamba-7b",
                                         cases=DIST_MIXER_CASES[-1:],
                                         plant=contiguous_in_proj))]
    labels = ["falcon ffip", "falcon int8-ffip", "falcon planted fault",
              "zamba2 ffip", "zamba2 int8-ffip"]
    jobs = checks + [
        (serve_job, dict(fc, server_kw=dict(kw, quantized=False))),
        (serve_job, dict(fc, server_kw=dict(kw, quantized=True))),
        (serve_job, dict(fc, server_kw=dict(kw, quantized=False),
                         plant=plant_in_proj_contiguous)),
        (serve_job, dict(zc, server_kw=dict(kw, quantized=False))),
        (serve_job, dict(zc, server_kw=dict(kw, quantized=True))),
    ] + collective_jobs("falcon-mamba-7b", DIST_SSM_LAYERS, args.seed)
    totals = {name: 0 for name in compat.launch_counts()}
    try:
        ranks = spawn_ranks(DIST_TP, jobs, device="cuda", timeout_s=600)
    except RankError as e:
        problems.append(f"dist ssm: {e}")
        return totals
    print(f"  ranks: {time.perf_counter() - t0:.1f} s (start, weights, "
          f"checks, serving)", flush=True)
    check_collectives(ranks, len(checks) + len(labels), "falcon-mamba-7b",
                      DIST_SSM_LAYERS, args.seed, problems)

    for r, rank in enumerate(ranks):
        for i, res in enumerate(rank[:len(checks)]):
            planted = i == len(checks) - 1
            for label, rec in res.items():
                print(f"  rank {r}: {'planted fault, in_proj cut '
                                     'contiguously: ' if planted else ''}"
                      f"{label}: {'ok' if rec['ok'] else 'off'} max_abs "
                      f"{rec['max_abs_err']:.4g} ({rec['tol']})"
                      + (f", {rec['sd']:.4g} sd of the whole mixer's output"
                         if "sd" in rec else ""), flush=True)
                # the planted fault is gated by its reading in sd below: the
                # f32 GEMM bar's atol at K = d_inner is wider than the spread
                # of a mixer's output
                if not (planted or rec["ok"]):
                    problems.append(f"dist ssm: rank {r}: {label} off the "
                                    f"whole ({rec['tol']}): "
                                    f"{rec['max_abs_err']}")
                if "sd" in rec:
                    tier = "int8" if " int8 " in label else "float"
                    (readings.faults if planted else readings.sound)[tier][
                        f"rank {r} {label}{' planted' if planted else ''}"
                        f" (mixer output)"] = rec["sd"]
    by = {label: [rank[len(checks) + i] for rank in ranks]
          for i, label in enumerate(labels)}
    for label, recs in by.items():
        _dist_line(f"tp{DIST_TP} {label}", recs)
        falcon = label.startswith("falcon")
        want = ({"selective_scan": DIST_SSM_LAYERS * len(f_prompts),
                 "flash_fwd": 0} if falcon else
                {"selective_scan": 0,
                 "flash_fwd": n_groups * len(zamba["prompts"])})
        for r, rec in enumerate(recs):
            for name, n in rec["launches"].items():
                totals[name] += n
            if rec["tokens"] != recs[0]["tokens"]:
                problems.append(f"dist {label}: rank {r}'s tokens differ "
                                f"from rank 0's")
            got = {k: rec["launches"][k] for k in want}
            if got != want or not rec["launches"]["ffip_gemm_y"]:
                problems.append(f"dist {label}: rank {r} launched "
                                f"{rec['launches']}, want {want} and "
                                f"ffip_gemm_y")
        if any(len(t) != DIST_MAX_NEW for t in recs[0]["tokens"].values()):
            problems.append(f"dist {label}: a request missed its budget")

    def done(rec):
        return [SimpleNamespace(rid=rid, out_tokens=toks)
                for rid, toks in sorted(rec["tokens"].items())]

    def count_same(rec, single, what):
        same = sum(a == b for rid in single
                   for a, b in zip(rec["tokens"][rid], single[rid]))
        print(f"  [tp{DIST_TP} {what}] {same} of "
              f"{sum(map(len, rec['tokens'].values()))} tokens equal to "
              f"the single card's", flush=True)

    model = Model(f_cfg)
    params = model.init(args.seed)
    plain = {q: PlainPath(model, params, f_prompts, q)
             for q in (False, True)}
    for label, tier, quantized in (("ffip", "float", False),
                                   ("int8-ffip", "int8", True)):
        rec = by[f"falcon {label}"][0]
        _, single, _ = serve(model, params, f_prompts, max_new=DIST_MAX_NEW,
                             quantized=quantized, **kw)
        count_same(rec, {r.rid: list(r.out_tokens) for r in single},
                   f"falcon {label}, {DIST_SSM_LAYERS} layers")
        readings.read(f"tp{DIST_TP} falcon {label} ({DIST_SSM_LAYERS} "
                      f"layers)", done(rec), plain[quantized], tier)
    readings.read(f"tp{DIST_TP} falcon planted fault: in_proj cut "
                  f"contiguously over x | z, float ffip, {DIST_SSM_LAYERS} "
                  f"layers (tokens; ungated)",
                  done(by["falcon planted fault"][0]), plain[False],
                  "float", fault=True, gated=False)
    del model, params, plain
    own = {r["label"]: {d.rid: list(d.out_tokens) for d in r["done"]}
           for r in zamba["runs"]}
    for label, tier, quantized in (("ffip", "float", False),
                                   ("int8-ffip", "int8", True)):
        rec = by[f"zamba2 {label}"][0]
        count_same(rec, own[f"zamba2 {label}"],
                   f"zamba2 {label}, phase hybrid's run")
        with int8_products_by_f64():
            readings.read(f"tp{DIST_TP} zamba2 {label}", done(rec),
                          zamba["plain"][quantized], tier)
    print(f"phase dist, the sharded scan: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return totals


# phase dist families: the six other families served tensor-parallel on a
# (1, DIST_TP) mesh (gloo, both ranks on the one card), each at its published
# widths, bf16, random weights from --seed, 4 slots, DIST_MAX_NEW new tokens
# a request, float and int8 FFIP: (arch, short tag, depth, max_len, long
# prompt's length range or None). serve_job draws the whole weights on each
# rank before the cut and keeps them, so a rank holds the whole model and
# its half (with FFIP's derived copies) beside the other rank's, and the
# parent its single-card model after them.
# - gemma3-4b at 6 of 34 layers: layer 5 is its first global one
#   (local_global_period 6), so both kinds run; one prompt of 1100-1499
#   tokens passes the local layers' window of 1024 (as in phase families).
# - mixtral-8x22b at 2 of 56: a layer is ~5.1 GB of bf16 (experts, which
#   the einsums read with no derived copies), the untied embeddings 0.8 GB;
#   whole + half on each of two ranks is ~33 GB at 2 layers, ~64 GB at 4,
#   where the parent's single-card model (~21 GB) no longer fits beside
#   them. Its config's "ffn" partition (float and int8) and the "expert"
#   one (int8).
# - starcoder2-3b, deepseek-coder-33b and pixtral-12b at 4 layers (the
#   run's time; deepseek-coder's 4.7 B parameters at 8 were ~27 GB a rank
#   in int8 FFIP).
# - whisper-small at its published 12 + 12.
# Beside them: the planted fault (gemma3, float: rank 1's piece of layer
# 0's ffn.down taken from rank 0's), the frontend entry points at tp 2
# (whisper: ENCDEC_ROWS x 1500 stub frames through the encoder, K4
# non-causal at BH 4 x 6; pixtral at its 4 layers: 256 patches + a
# PIXTRAL_PROMPT-token prompt), one decode step's collectives of whisper
# and gemma3 against the meta-device trace, and the router's replicas on
# the mesh (minicpm-2b at DIST_ROUTER_LAYERS: --replicas 2
# --quantized-replicas 1 --fault-plan flaky, 2 slots each).
DIST_FAMILY_RUNS = (
    ("gemma3-4b", "gemma3", 6, 1536, (1100, 1500)),
    ("mixtral-8x22b", "mixtral", 2, 256, None),
    ("starcoder2-3b", "starcoder2", 4, 256, None),
    ("deepseek-coder-33b", "deepseek-coder", 4, 256, None),
    ("pixtral-12b", "pixtral", 4, 256, None),
    ("whisper-small", "whisper", 12, 256, None),
)
DIST_ROUTER_LAYERS = 8


def _family_runs(arch: str):
    """(label suffix, quantized, moe_partition) of a family's served runs
    in phase dist families."""
    runs = [("ffip", False), ("int8-ffip", True)]
    if arch != "mixtral-8x22b":
        return [(label, q, "expert") for label, q in runs]
    return ([(f"{label} ffn", q, "ffn") for label, q in runs]
            + [("int8-ffip expert", True, "expert")])


def run_dist_families(args, readings: Readings, problems, encdec):
    """Phase dist families (ROADMAP item 15c): every family beside
    minicpm-2b, deepseek-v2-lite-16b and the SSM stacks served on a
    (1, DIST_TP) mesh through ``launch.serve``'s rank entry, one process a
    rank (DIST_FAMILY_RUNS), all in one ``spawn_ranks``: each family float
    and int8 FFIP, every rank launching K3 and K4 on its pieces; the
    planted fault; whisper's and pixtral's frontend entry at tp 2
    (``parity.frontend_run``); one decode step's collectives (whisper,
    gemma3) against the meta-device trace; and ``--replicas 2
    --mesh-model 2 --fault-plan flaky`` (``router_job``). Then, in this
    process, each family at the same depth and weights on one card: the
    count of tokens equal to its single-card run (int8 equal wherever the
    partition sums int32, all but mixtral's "ffn" experts: gated), and the
    readings against the plain path under the float / int8 bars (mixtral
    a replay of each run with its expert choices); the frontend runs
    against phase encdec's single-card whisper runs (``encdec``) and a
    single-card pixtral run at 8 layers, read against ``FrontendPlain``.
    Returns the ranks' launch counts, summed and by rank."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.dist import parity
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import (RankError, router_job, serve,
                                          serve_job, spawn_ranks)
    from repro_torch.models.frontends import (audio_frames_stub,
                                              vision_patches_stub)
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    print(f"phase dist families: tp {DIST_TP}, gloo with both ranks on the "
          f"one card; " + ", ".join(
              f"{a} at {n} of {configs.get_config(a).n_layers} layers"
              for a, _, n, _, _ in DIST_FAMILY_RUNS), flush=True)
    jobs, labels, families = [], [], {}
    for arch, tag, layers, max_len, long_range in DIST_FAMILY_RUNS:
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
        prompts = family_prompts(cfg.vocab, args.seed, long_range, False)
        kw = dict(batch_slots=4, max_len=max_len, gemm_impl="cuda",
                  gemm_algo="ffip")
        families[arch] = (tag, cfg, prompts, kw)
        base = dict(arch=arch, layers=layers, seed=args.seed,
                    prompts=prompts, max_new=DIST_MAX_NEW)
        fn = recorded_serve_job if cfg.moe else serve_job
        for label, quantized, part in _family_runs(arch):
            jobs.append((fn, dict(base, server_kw=dict(
                kw, quantized=quantized, moe_partition=part))))
            labels.append((arch, label))
        if arch == "gemma3-4b":
            jobs.append((serve_job, dict(base, server_kw=dict(
                kw, quantized=False), plant=plant_down_shard)))
            labels.append((arch, "planted fault"))
    w_cfg = configs.get_config("whisper-small")
    p_cfg = dataclasses.replace(configs.get_config("pixtral-12b"),
                                n_layers=families["pixtral-12b"][1].n_layers)
    fronts = [(w_cfg, WHISPER_PROMPT), (p_cfg, PIXTRAL_PROMPT)]
    for cfg, prompt in fronts:
        for quantized in (False, True):
            jobs.append((parity.frontend_run, dict(
                cfg=cfg, rows=ENCDEC_ROWS, prompt=prompt, steps=DIST_MAX_NEW,
                seed=args.seed, quantized=quantized)))
            labels.append((cfg.name, "frontend " + ("int8-ffip" if quantized
                                                    else "ffip")))
    first_coll = len(jobs)
    coll = [("whisper-small", w_cfg.n_layers),
            ("gemma3-4b", families["gemma3-4b"][1].n_layers)]
    for arch, layers in coll:
        jobs += collective_jobs(arch, layers, args.seed)
    mc_cfg = configs.get_config("minicpm-2b")
    router_prompts = served_prompts(mc_cfg.vocab, args.seed)
    router_args = dict(replicas=2, quantized_replicas=1, quantized=False,
                       fault_plan="flaky", deadline_ms=None, slo=None,
                       slo_windows="5,30", slo_min_count=3,
                       slo_drain_ticks=0, max_new=DIST_MAX_NEW, paged=False)
    jobs.append((router_job, dict(
        arch="minicpm-2b", layers=DIST_ROUTER_LAYERS, seed=args.seed,
        prompts=router_prompts, router_args=router_args,
        server_kw=dict(batch_slots=FLEET_SLOTS, max_len=256,
                       gemm_impl="cuda", gemm_algo="ffip"))))
    totals = {name: 0 for name in compat.launch_counts()}
    by_rank = [dict(totals) for _ in range(DIST_TP)]
    try:
        ranks = spawn_ranks(DIST_TP, jobs, device="cuda", timeout_s=900)
    except RankError as e:
        problems.append(f"dist families: {e}")
        return totals, by_rank
    print(f"  ranks: {time.perf_counter() - t0:.1f} s (start, weights, "
          f"serving, frontends, router)", flush=True)
    for i, (arch, layers) in enumerate(coll):
        check_collectives(ranks, first_coll + 2 * i, arch, layers, args.seed,
                          problems)
    for r, rank in enumerate(ranks):
        for rec in rank[:first_coll] + rank[-1:]:
            for name, n in rec["launches"].items():
                totals[name] += n
                by_rank[r][name] += n
    by = {key: [rank[i] for rank in ranks] for i, key in enumerate(labels)}

    def done(rec):
        return [SimpleNamespace(rid=rid, out_tokens=toks)
                for rid, toks in sorted(rec["tokens"].items())]

    for arch, (tag, cfg, prompts, kw) in families.items():
        t1 = time.perf_counter()
        runs = _family_runs(arch)
        if arch == "gemma3-4b":
            runs.append(("planted fault", False, "expert"))
        for label, _, _ in runs:
            recs = by[arch, label]
            _dist_line(f"tp{DIST_TP} {tag} {cfg.n_layers} layers {label}",
                       recs)
            for r, rec in enumerate(recs):
                if rec["tokens"] != recs[0]["tokens"]:
                    problems.append(f"dist {tag} {label}: rank {r}'s "
                                    f"tokens differ from rank 0's")
                c = rec["launches"]
                if not (c["ffip_gemm_y"] and c["flash_fwd"]):
                    problems.append(f"dist {tag} {label}: rank {r} launched "
                                    f"no ffip_gemm_y or flash_fwd: {c}")
            if any(len(t) != DIST_MAX_NEW
                   for t in recs[0]["tokens"].values()):
                problems.append(f"dist {tag} {label}: a request missed its "
                                f"budget")
        model = Model(cfg)
        params = model.init(args.seed)
        plain = {}
        for label, quantized, part in runs:
            rec = by[arch, label][0]
            tier = "int8" if quantized else "float"
            fault = label == "planted fault"
            if not fault:
                _, single, _ = serve(model, params, prompts,
                                     max_new=DIST_MAX_NEW,
                                     quantized=quantized, **kw)
                same = sum(a == b for s in single
                           for a, b in zip(rec["tokens"][s.rid],
                                           s.out_tokens))
                total = sum(map(len, rec["tokens"].values()))
                print(f"  [tp{DIST_TP} {tag} {label}] {same} of {total} "
                      f"tokens equal to the single card's at "
                      f"{cfg.n_layers} layers", flush=True)
                if quantized and part != "ffn" and same != total:
                    problems.append(f"dist {tag} {label}: the int8 layers "
                                    f"sum int32, yet {total - same} tokens "
                                    f"differ from the single card's")
                del single
            with (int8_products_by_f64() if quantized
                  else contextlib.nullcontext()):
                if cfg.moe is not None:
                    plain_path = Replay(
                        model, params, prompts,
                        [t.cuda() for t in rec["samples"]],
                        [t.cuda() for t in rec["routes"]], DIST_MAX_NEW,
                        quantized=quantized, batch_slots=4,
                        max_len=kw["max_len"])
                elif quantized not in plain:
                    plain_path = plain[quantized] = PlainPath(
                        model, params, prompts, quantized)
                else:
                    plain_path = plain[quantized]
                readings.read(f"tp{DIST_TP} {tag} {label} ({cfg.n_layers} "
                              f"layers)" + (": rank 1's piece of layer 0's "
                                            "ffn.down from rank 0's, float "
                                            "ffip" if fault else ""),
                              done(rec), plain_path, tier, fault=fault)
            del plain_path
        del model, params, plain
        free_device()
        print(f"  [tp{DIST_TP} {tag}] single card and plain path: "
              f"{time.perf_counter() - t1:.1f} s", flush=True)

    # the frontend entry points at tp 2: whisper against phase encdec's
    # single-card runs (the same weights, frames and prompt), pixtral
    # against a single-card run at the same depth
    singles = {r.get("label"): r for r in encdec}
    for cfg, prompt in fronts:
        t1 = time.perf_counter()
        tag = cfg.name.split("-")[0]
        model = Model(cfg)
        params = model.init(args.seed)
        dev = model.device
        tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, cfg.vocab, (ENCDEC_ROWS, prompt))).to(dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        inputs = ({"frames": audio_frames_stub(gen, ENCDEC_ROWS, cfg,
                                               device=dev)}
                  if cfg.encoder is not None else
                  {"patches": vision_patches_stub(gen, ENCDEC_ROWS, cfg,
                                                  device=dev)})
        for quantized in (False, True):
            label = "frontend " + ("int8-ffip" if quantized else "ffip")
            recs = by[cfg.name, label]
            tier = "int8" if quantized else "float"
            n_att = (cfg.encoder.n_layers if cfg.encoder else 0) \
                + cfg.n_layers
            for r, rec in enumerate(recs):
                print(f"  [tp{DIST_TP} {tag} {label}] rank {r}: "
                      f"{ENCDEC_ROWS} rows x {prompt} tokens behind "
                      f"{next(iter(inputs.values())).shape[1]} "
                      f"{next(iter(inputs))}, {cfg.n_layers} layers: "
                      f"prefill {rec['prefill_s']:.3f} s, "
                      f"{rec['ms_per_step']:.1f} ms/step; peak memory "
                      f"{rec['peak_gib']:.2f} GiB; launches "
                      f"{ {k: v for k, v in rec['launches'].items() if v} }",
                      flush=True)
                if rec["tokens"] != recs[0]["tokens"]:
                    problems.append(f"dist {tag} {label}: rank {r}'s "
                                    f"tokens differ from rank 0's")
                if (rec["launches"]["flash_fwd"] != n_att
                        or not rec["launches"]["ffip_gemm_y"]):
                    problems.append(f"dist {tag} {label}: rank {r} "
                                    f"launched {rec['launches']}, want "
                                    f"flash_fwd {n_att} and ffip_gemm_y")
            rec = recs[0]
            if cfg.encoder is not None:
                single = singles[f"whisper {'int8-' if quantized else ''}"
                                 f"ffip"]
                ids = [r.out_tokens for r in single["done"]]
                first = single["first"]
                what = "phase encdec's single-card run"
            else:
                single = parity.frontend_run(
                    None, dev, cfg=cfg, rows=ENCDEC_ROWS, prompt=prompt,
                    steps=DIST_MAX_NEW, seed=args.seed, quantized=quantized,
                    params=params)
                ids, first = single["tokens"], single["first"]
                what = f"a single-card run at {cfg.n_layers} layers"
            same = sum(a == b for got, want in zip(rec["tokens"], ids)
                       for a, b in zip(got, want))
            dev_sd = max(float((g.float() - w.float().cpu()).abs().max()
                               / w.float().std())
                         for g, w in zip(rec["first"], first))
            print(f"  [tp{DIST_TP} {tag} {label}] {same} of "
                  f"{sum(map(len, rec['tokens']))} tokens equal to {what}; "
                  f"prefill logits off its by up to {dev_sd:.4f} sd",
                  flush=True)
            done_rows = [SimpleNamespace(rid=i, out_tokens=list(row))
                         for i, row in enumerate(rec["tokens"])]
            with (int8_products_by_f64() if quantized
                  else contextlib.nullcontext()):
                plain = FrontendPlain(model, params, tokens, quantized,
                                      DIST_MAX_NEW, **inputs)
                readings.read(f"tp{DIST_TP} {tag} {label}", done_rows, plain,
                              tier)
            del plain
        del model, params, inputs
        free_device()
        print(f"  [tp{DIST_TP} {tag} frontend] single card and plain path: "
              f"{time.perf_counter() - t1:.1f} s", flush=True)

    res = [rank[-1] for rank in ranks]
    print(f"  [tp{DIST_TP} router] minicpm-2b {DIST_ROUTER_LAYERS} layers, "
          f"--replicas 2 --quantized-replicas 1 --fault-plan flaky, "
          f"{FLEET_SLOTS} slots a replica, rank 0's router:", flush=True)
    print("    " + res[0]["printed"].rstrip().replace("\n", "\n    "),
          flush=True)
    for r, rec in enumerate(res):
        busy = {k: v for k, v in rec["launches"].items() if v}
        print(f"    rank {r}: peak memory {rec['peak_gib']:.2f} GiB; "
              f"launches {busy}; {len(rec['events'])} router events, "
              f"outcomes {rec['outcomes']}", flush=True)
        problems += [f"dist router: rank {r}: {p}" for p in rec["problems"]]
    differ = [f"rank {r}'s router {key}" for r, rec in enumerate(res)
              for key in ("events", "outcomes", "tokens")
              if rec[key] != res[0][key]]
    problems += [f"dist router: {d} differ from rank 0's" for d in differ]
    if res[0]["outcomes"] != {"done": len(router_prompts)}:
        problems.append(f"dist router: outcomes {res[0]['outcomes']}, want "
                        f"every request done")
    print(f"  [tp{DIST_TP} router] ranks' events, outcomes and tokens "
          f"identical: {not differ}", flush=True)
    print(f"phase dist families: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return totals, by_rank


# phase reports: the prompt length of its bucketed prefill dispatch (4
# slots), the runs each dispatch is timed over, and the largest roofline
# share a dispatch may read (above it the cost model overcounts)
# phase dist train (ROADMAP item 15d): training on a ("data", "model") mesh
# of two gloo ranks sharing the card, at the published widths: (arch,
# layers, batch, seq, ((mesh shape, moe_partition), ...)). Each run takes
# DIST_TRAIN_STEPS AdamW steps against one card's at the same depth and
# batch. minicpm-2b's 4 layers and falcon-mamba-7b's and deepseek's 2 x 256
# batches keep the phase near two minutes: each gloo all-reduce crosses the
# host, the ZeRO gathers of a (2, 1) mesh every weight a step.
DIST_TRAIN_RUNS = (
    ("minicpm-2b", 4, 4, 256, (((2, 1), "expert"), ((1, 2), "expert"))),
    ("falcon-mamba-7b", 4, 2, 256, (((1, 2), "expert"), ((2, 1), "expert"))),
    ("deepseek-v2-lite-16b", 3, 2, 256, (((1, 2), "expert"), ((1, 2), "ffn"),
                                         ((2, 1), "expert"))))
DIST_TRAIN_STEPS = 2
# the loss of a step after a restore across mesh shapes against the
# unbroken run's: both are bf16 steps of the same state, rounded in other
# places. The restored state itself is held to the saved bits.
DIST_TRAIN_LOSS_RTOL = 1e-3


def dist_train_job(mesh, device, *, arch: str, layers: int, batch_size: int,
                   seq: int, seed: int, runs, fault: bool = False,
                   ckpt_dir: str = "", smoke: bool = False):
    """A rank's part of phase dist train for one arch: for each (mesh
    shape, moe_partition) of ``runs``, a ("data", "model") mesh over the
    two ranks, the rank's pieces of the whole weights from ``seed``
    (``train_specs``) and DIST_TRAIN_STEPS AdamW steps on the pipeline's
    global batches (every rank the same). Step 0 records the routing, the
    collectives and the gradients, gathered whole; rank 0 then takes one
    card's step on the whole weights (an MoE with the mesh run's gathered
    expert choices: ``routing``) and reads each leaf's relative L2 error.
    With ``fault``, rank 1's piece of a middle layer's output projection
    taken from the next layer's, at the "model" mesh. With ``ckpt_dir``
    the (2, 1) state is saved after its steps and a third step taken (the
    unbroken run); the (1, 2) run restores it (``restore(shardings=)``)
    and takes the same step. Returns one record a run: losses, readings,
    keep-mask mismatches, collectives, launches, times and peak memory.
    ``smoke``: the smoke widths (a rehearsal on the CPU)."""
    from repro_torch import configs
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import context as dctx
    from repro_torch.dist import parity
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import compat
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    base = _dist_train_cfg(arch, layers, smoke)
    data = SyntheticLM(DataConfig(global_batch=batch_size, seq_len=seq,
                                  vocab=base.vocab, seed=seed))
    cuda = device.type == "cuda"
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}
               for i in range(DIST_TRAIN_STEPS + 1)]
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(
        lr=TRAIN_LR, schedule="const", warmup_steps=1))
    params = Model(base, device=device).init(seed)
    names = _leaf_names(params)
    stack, group, proj = (("layers", "ssm", "out_proj") if base.ssm
                          else ("layers", "attn", "wo"))

    def sync_s(t):
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter() - t

    out = []
    for shape, part in runs:
        cfg = base if base.moe is None else dataclasses.replace(
            base, moe=dataclasses.replace(base.moe, partition=part))
        model = Model(cfg, device=device)
        m = dctx.make_mesh(shape, ("data", dctx.MODEL))
        specs = shd.train_specs(params, m, cfg)
        full = shd.Shardings(tstep.state_specs(specs), m)
        pieces = shd.own_pieces(params, specs, m)
        opt = adamw.init(pieces)
        step = tstep.make_train_step(model, tcfg, specs=specs)
        rec = dict(shape=shape, part=part, losses=[], step_s=[],
                   peak_gib=0.0)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        compat.reset_counters()
        with dctx.mesh_context(m):
            got: list = []
            t = time.perf_counter()
            with parity.record_routing() as rr, routing() as chosen, \
                    dctx.record_collectives() as coll:
                pieces, opt, met = step(pieces, opt, batches[0],
                                        grads_out=got)
            rec["step_s"].append(sync_s(t))
            rec["losses"].append(float(met["loss"]))
            for i in range(1, DIST_TRAIN_STEPS):
                t = time.perf_counter()
                pieces, opt, met = step(pieces, opt, batches[i])
                rec["step_s"].append(sync_s(t))
                rec["losses"].append(float(met["loss"]))
            rec["launches"] = compat.launch_counts()
            rec["collectives"] = coll
            rec["keep"] = parity.keep_mismatches(rr, cfg)
            choices = [dctx.all_gather(c, 0, dctx.batch_axes())
                       for c in chosen]
            with torch.no_grad():
                whole = dict(zip(names, adamw.tree_leaves(
                    shd.unshard_tree(got[0], specs))))
            del got, rr
            if cuda:
                rec["peak_gib"] = (torch.cuda.max_memory_allocated(device)
                                   / 2 ** 30)
            if ckpt_dir and shape == (2, 1):
                CheckpointManager(ckpt_dir).save(
                    DIST_TRAIN_STEPS, (pieces, opt), shardings=full)
                _, _, met = step(pieces, opt, batches[DIST_TRAIN_STEPS])
                rec["loss_unbroken"] = float(met["loss"])
            if ckpt_dir and shape == (1, 2):
                mgr = CheckpointManager(ckpt_dir)
                state, _ = mgr.restore((pieces, opt), shardings=full)
                # the restored pieces gathered whole against the saved
                # leaves, read back whole
                with torch.no_grad():
                    back = shd.unshard_tree(state, full.specs)
                saved = adamw.tree_leaves(mgr.restore(adamw.tree_map(
                    lambda t: torch.empty(t.shape, dtype=t.dtype), back))[0])
                back = adamw.tree_leaves(back)
                rec["restored_leaves"] = (sum(
                    not _same_bits(a.cpu(), b)
                    for a, b in zip(back, saved)), len(saved))
                del back, saved
                _, _, met = step(*state, batches[DIST_TRAIN_STEPS])
                rec["loss_restored"] = float(met["loss"])
                del state
        del pieces, opt
        ref = None
        if mesh.rank == 0:
            # one card: the same step on the whole weights
            t = time.perf_counter()
            with routing(choices if cfg.moe else None):
                loss, ref = one_step_grads(model, params, batches[0])
            p1 = adamw.tree_map(torch.clone, params)
            adamw.update(tcfg.optimizer, adamw.tree_unflatten(
                params, [ref[n] for n in names]), adamw.init(p1), p1)
            with torch.no_grad():
                loss1 = float(model.loss(p1, batches[1]))
            del p1
            rec["one_card"] = dict(losses=[loss, loss1], s=sync_s(t))
            rec["rel_l2"] = {n: _rel_l2(whole[n], ref[n]) for n in names}
        del whole
        if fault and shape == (1, 2):
            n_layers = params[stack][group][proj]["w"].shape[0]
            mid = (n_layers - 1) // 2
            pf = shd.own_pieces(params, specs, m)
            w = pf[stack][group][proj]["w"]
            if m.index(dctx.MODEL) == 1:
                w[mid].copy_(w[mid + 1])
            got = []
            with dctx.mesh_context(m):
                step(pf, adamw.init(pf), batches[0], grads_out=got)
                with torch.no_grad():
                    faulty = dict(zip(names, adamw.tree_leaves(
                        shd.unshard_tree(got[0], specs))))
            del pf, got
            if ref is not None:
                rec["fault"] = (f"rank 1's piece of {stack}.{group}.{proj}"
                                f"[{mid}] from layer {mid + 1}",
                                max(_rel_l2(faulty[n], ref[n])
                                    for n in names))
            del faulty
        del ref, choices
        out.append(rec)
    return out


def _dist_train_cfg(arch: str, layers: int, smoke: bool):
    from repro_torch import configs

    cfg = configs.get_config(arch)
    if smoke:       # the smoke widths in the card's dtype
        cfg = dataclasses.replace(configs.smoke_config(cfg),
                                  param_dtype=cfg.param_dtype)
    return dataclasses.replace(cfg, n_layers=layers)


def run_dist_train(args, problems, runs=DIST_TRAIN_RUNS, device="cuda",
                   smoke: bool = False):
    """Phase dist train (ROADMAP item 15d): DIST_TRAIN_RUNS trained on
    ("data", "model") meshes of two gloo ranks sharing the card, all in one
    ``spawn_ranks`` (``dist_train_job``): every leaf's gradient, gathered
    whole, under GRAD_BAR against one card's step (rank 0), the planted
    fault above it; the MoE keep masks at (2, 1) equal to the global rule
    on the gathered expert choices, bit for bit; each rank's collectives of
    one step equal to the meta-device trace's (``launch.dryrun.
    train_collectives``, traced here while the ranks run); the launches of
    K4 and K8 (K6 and K9) once a layer a step and nothing else; the
    checkpoint saved at (2, 1) and restored at (1, 2). Returns the ranks'
    launch counts by rank. ``runs``, ``device`` and ``smoke``: a
    rehearsal on the CPU at the smoke widths."""
    import threading

    from repro_torch import configs
    from repro_torch.kernels import compat
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import RankError, spawn_ranks
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    print(f"phase dist train: two gloo ranks on the one card; " + "; ".join(
        f"{a} at {n} of {configs.get_config(a).n_layers} layers, {b} x {s}, "
        f"meshes " + ", ".join(f"{d}x{m}" + (f" {p}" if a.startswith(
            "deepseek") else "") for (d, m), p in runs)
        for a, n, b, s, runs in runs), flush=True)
    by_rank = [{name: 0 for name in compat.launch_counts()}
               for _ in range(DIST_TP)]
    want: dict = {}

    def traces():
        for arch, layers, b, s, shapes in runs:
            base = _dist_train_cfg(arch, layers, smoke)
            mparams = Model(base, device="meta").init(args.seed)
            batch = {k: torch.empty((b, s), dtype=torch.int32,
                                    device="meta")
                     for k in ("tokens", "labels")}
            for shape, part in shapes:
                cfg = base if base.moe is None else dataclasses.replace(
                    base, moe=dataclasses.replace(base.moe, partition=part))
                try:
                    want[(arch, shape, part)] = dryrun.train_collectives(
                        cfg, mparams, batch, shape, ("data", "model"))
                except Exception as e:  # noqa: BLE001 - reported below
                    want[(arch, shape, part)] = f"{type(e).__name__}: {e}"

    ckpt = tempfile.mkdtemp(prefix="dist_train_ckpt_")
    jobs = [(dist_train_job, dict(
        arch=arch, layers=layers, batch_size=b, seq=s, seed=args.seed,
        runs=shapes, fault=arch == "minicpm-2b", smoke=smoke,
        ckpt_dir=ckpt if arch == "minicpm-2b" else ""))
        for arch, layers, b, s, shapes in runs]
    if device != "cpu":
        compat.build_all()
    tracer = threading.Thread(target=traces)
    tracer.start()
    try:
        ranks = spawn_ranks(DIST_TP, jobs, device=device, timeout_s=600)
    except RankError as e:
        problems.append(f"dist train: {e}")
        return by_rank
    finally:
        tracer.join()
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"  ranks: {time.perf_counter() - t0:.1f} s (start, weights, "
          f"steps, one card's steps, checks); meta traces done",
          flush=True)
    for i, (arch, layers, b, s, shapes) in enumerate(runs):
        pair = (("selective_scan", "selective_scan_bwd")
                if arch == "falcon-mamba-7b" else ("flash_fwd", "flash_bwd"))
        if device == "cpu":          # the plain versions launch nothing
            pair = ()
        for j, (shape, part) in enumerate(shapes):
            recs = [rank[i][j] for rank in ranks]
            r0 = recs[0]
            tag = (f"{arch} {shape[0]}x{shape[1]}"
                   + (f" {part}" if arch.startswith("deepseek") else ""))
            one = r0["one_card"]
            top = max(r0["rel_l2"], key=r0["rel_l2"].get)

            def nums(xs, fmt):
                return ", ".join(format(x, fmt) for x in xs)

            print(f"  [{tag}] losses {nums(r0['losses'], '.6f')} (one card "
                  f"{nums(one['losses'], '.6f')}); step s "
                  f"{nums(r0['step_s'], '.3f')} (one card's step and next "
                  f"loss {one['s']:.3f}); largest per-leaf gradient error "
                  f"{r0['rel_l2'][top]:.4g} ({top}); peak GiB by rank "
                  f"{nums([r['peak_gib'] for r in recs], '.2f')}",
                  flush=True)
            worst = sorted(r0["rel_l2"].items(), key=lambda kv: -kv[1])[:5]
            print(f"    per-leaf errors, the largest: " + ", ".join(
                f"{k} {v:.4g}" for k, v in worst), flush=True)
            if r0["rel_l2"][top] >= GRAD_BAR:
                problems.append(f"dist train {tag}: gradient error "
                                f"{r0['rel_l2'][top]:.4g} ({top}) over "
                                f"GRAD_BAR {GRAD_BAR}")
            if "fault" in r0:
                label, worst = r0["fault"]
                print(f"  [{tag} planted fault: {label}] largest per-leaf "
                      f"gradient error {worst:.4g}", flush=True)
                if worst <= GRAD_BAR:
                    problems.append(f"dist train {tag}: the planted fault "
                                    f"reads {worst:.4g}, under GRAD_BAR")
            if any(r["losses"] != r0["losses"] for r in recs):
                problems.append(f"dist train {tag}: the ranks' losses "
                                f"differ")
            if arch.startswith("deepseek"):
                keep = [r["keep"] for r in recs]
                print(f"  [{tag}] keep-mask elements off the global rule, "
                      f"a layer, by rank: {keep}", flush=True)
                if any(any(k) for k in keep) or not all(keep):
                    problems.append(f"dist train {tag}: keep masks {keep}")
            w = want.get((arch, shape, part), "not traced")
            if isinstance(w, str):
                problems.append(f"dist train {tag}: the meta trace failed: "
                                f"{w}")
                w = []
            for r, rec in enumerate(recs):
                got = rec["collectives"]
                same = got == w
                busy = {k: v for k, v in rec["launches"].items() if v}
                print(f"    rank {r}: collectives of step 0 predicted "
                      f"{len(w)} ({sum(x for _, x, _ in w):.0f} B), counted "
                      f"{len(got)} ({sum(x for _, x, _ in got):.0f} B): "
                      f"{'equal' if same else 'DIFFER'}; launches {busy}",
                      flush=True)
                if not same:
                    problems.append(f"dist train {tag}: rank {r} issued "
                                    f"{len(got)} collectives, the trace "
                                    f"predicts {len(w)}")
                n = layers * DIST_TRAIN_STEPS
                bad = {k: v for k, v in rec["launches"].items()
                       if v != (n if k in pair else 0)}
                if bad:
                    problems.append(f"dist train {tag}: rank {r} launched "
                                    f"{bad}, want {pair} {n} each")
                for k, v in rec["launches"].items():
                    by_rank[r][k] += v
            if "loss_restored" in r0:
                unbroken = ranks[0][i][0]["loss_unbroken"]
                got = r0["loss_restored"]
                off = [r["restored_leaves"] for r in recs]
                print(f"  [{arch} checkpoint saved at 2x1, restored at 1x2] "
                      f"leaves (params, AdamW's step, m, v) gathered whole "
                      f"off the saved bits, by rank: "
                      f"{', '.join(f'{a} of {n}' for a, n in off)}; next "
                      f"step's loss {got:.6f}, unbroken run's "
                      f"{unbroken:.6f}", flush=True)
                if any(a for a, _ in off):
                    problems.append(f"dist train: restored leaves off the "
                                    f"saved bits, by rank: {off}")
                if abs(got - unbroken) > DIST_TRAIN_LOSS_RTOL * abs(unbroken):
                    problems.append(f"dist train: the restored step's loss "
                                    f"{got} is off the unbroken {unbroken}")
    print(f"phase dist train: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_rank


REPORT_PROMPT = 128
REPORT_REPS = 3
REPORT_SHARE_MAX = 1.05


def _launched(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def run_reports(args, model, params, problems):
    """Phase reports: the meta-device cost model (``launch.costs``,
    ``launch.dryrun``) held against the card. For one bucketed prefill
    dispatch (4 x REPORT_PROMPT) and one decode step at 4 slots, FFIP float
    and int8, as ``BatchServer`` runs them (``dryrun.served_steps``): the
    kernels the trace predicts must be the kernels the card launches, each
    as often; each dispatch's time by CUDA events against the trace's
    bound, a roofline share above REPORT_SHARE_MAX failing the phase; the
    bytes the trace predicts for the params, the int8 entries and the
    cache must be what the allocator holds for them, and the trace's peak
    of live storage is printed beside the card's. Then ``dryrun`` over
    minicpm-2b's four shapes on the 16x16 mesh, timed."""
    from repro_torch.core.quant import attach_quantized_weights
    from repro_torch.kernels import compat
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = model.cfg
    print(f"phase reports: {cfg.name} at {cfg.n_layers} layers, meta-device "
          f"traces against the card", flush=True)
    meta = Model(cfg, device="meta")
    mparams = meta.init(args.seed)

    def allocated(make):
        """(result, bytes its tensors asked the allocator for, bytes the
        allocator's blocks hold for them): deltas of
        ``memory_stats()["requested_bytes.all.current"]`` and of
        ``memory_allocated()``."""
        torch.cuda.synchronize()
        req0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
        held0 = torch.cuda.memory_allocated()
        out = make()
        torch.cuda.synchronize()
        return (out, torch.cuda.memory_stats()[
            "requested_bytes.all.current"] - req0,
            torch.cuda.memory_allocated() - held0)

    def check_bytes(label, make, mtree):
        # the requested bytes must be the trace's to the byte; the blocks
        # held are rounded to 512 B, and a large block whose remainder is
        # at most 1 MiB is not split: that slack is printed, not predicted
        made, req, held = allocated(make)
        want = dryrun.storage_bytes(mtree)
        print(f"  {label}: predicted {want} B, requested {req} B: "
              f"{'equal' if want == req else 'DIFFER'}; allocator blocks "
              f"{held} B (predicted in 512-B granules "
              f"{dryrun.storage_bytes(mtree, 512)} B)", flush=True)
        if want != req:
            problems.append(f"reports: {label} predicted {want} B, "
                            f"requested {req} B")
        del made

    check_bytes("params", lambda: model.init(args.seed), mparams)
    for quantized in (False, True):
        tier = "int8-ffip" if quantized else "ffip"
        steps, state = dryrun.served_steps(model, params,
                                           quantized=quantized)
        msteps, mstate = dryrun.served_steps(meta, mparams,
                                             quantized=quantized)
        check_bytes(f"[{tier}] cache", lambda: model.init_cache(4, 256),
                    mstate[1])
        if quantized:
            check_bytes(f"[{tier}] int8 entries", lambda: q_entries(
                attach_quantized_weights(params), "q"),
                q_entries(mstate[0], "q"))
        for name in ("prefill", "decode"):
            mode = dryrun.predict_dispatch(msteps[name], mstate)
            steps[name]()                        # warm: y, carry tables
            torch.cuda.synchronize()
            compat.reset_counters()
            torch.cuda.reset_peak_memory_stats()
            steps[name]()
            torch.cuda.synchronize()
            counted = _launched(compat.launch_counts())
            peak = torch.cuda.max_memory_allocated()
            predicted = _launched(mode.launches)
            ms = time_ms(steps[name], REPORT_REPS)
            bound_ms, bound_by = mode.total.bound_ms()
            share = bound_ms / ms
            same = predicted == counted
            print(f"  [{tier} {name}] launches predicted {predicted}, "
                  f"counted {counted}: {'equal' if same else 'DIFFER'}; "
                  f"{ms:.3f} ms (CUDA events, mean of {REPORT_REPS}) "
                  f"against the trace's bound {bound_ms:.4f} ms "
                  f"({bound_by}: {mode.total.bytes:.4g} B, "
                  f"{mode.total.flops:.4g} FLOPs): roofline share "
                  f"{share:.4f}; peak live storage predicted "
                  f"{mode.peak_live_bytes / 2 ** 30:.3f} GiB, card "
                  f"max_memory_allocated {peak / 2 ** 30:.3f} GiB (all "
                  f"the card holds; a split-K workspace is bounded by "
                  f"compat.WORKSPACE_BYTES = "
                  f"{compat.WORKSPACE_BYTES / 2 ** 20:.0f} MiB)", flush=True)
            if not same:
                problems.append(f"reports {tier} {name}: launches predicted "
                                f"{predicted}, counted {counted}")
            if share > REPORT_SHARE_MAX:
                problems.append(f"reports {tier} {name}: roofline share "
                                f"{share:.4f} above {REPORT_SHARE_MAX}: the "
                                f"cost model overcounts")
        del steps, state
        free_device()
    out = tempfile.mkdtemp(prefix="dryrun_")
    try:
        t1 = time.perf_counter()
        rc = dryrun.main(["--arch", cfg.name, "--out", out])
        sweep_s = time.perf_counter() - t1
        rows = [json.loads(f.read_text())
                for f in sorted(pathlib.Path(out).glob("*.json"))]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    status = [r["status"] for r in rows]
    print(f"  dryrun --arch {cfg.name} (16x16, full depth, meta): "
          f"{status.count('ok')} ok, {status.count('skipped')} skipped, "
          f"{status.count('failed')} failed in {sweep_s:.1f} s", flush=True)
    if rc or status.count("ok") != 3:
        problems.append(f"reports: dryrun over {cfg.name}'s shapes gave "
                        f"{status}")
    print(f"phase reports: {time.perf_counter() - t0:.1f} s", flush=True)


def q_entries(tree, key: str) -> list:
    """Every subtree under ``key`` (the int8 ``q`` entries) of a params
    tree."""
    if not isinstance(tree, dict):
        return []
    return [v for k, v in tree.items() if k == key] + [
        x for k, v in tree.items() if k != key
        for x in q_entries(v, key)]


def free_device():
    """Drop the module memo and every unreachable cycle (a router and its
    records) before returning the cached blocks."""
    import gc

    from repro_torch.kernels import compat
    compat.derived.clear()
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="depth of minicpm-2b (published: 40); widths stay")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new", type=int, default=8)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import Model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    build_s = compat.build_all()
    print(f"phase build: {len(compat.build_log)} kernel sources compiled "
          f"for sm_90a in {build_s:.1f} s (parallel nvcc)", flush=True)
    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    print("phase kernels: hand-written kernel vs plain version", flush=True)
    print(f"  graph-replay floor: a one-element add_ by CUDA-graph replay, L2 "
          f"flushed before each replay as for the kernels: "
          f"{replay_floor_ms(dev):.4f} ms", flush=True)
    recs = check_gemms(dev)
    recs += (check_flash(dev) + check_paged(dev)
            + check_convs(dev) + check_scan(dev, [
                len(p) for p in served_prompts(
                    configs.get_config("falcon-mamba-7b").vocab,
                    args.seed)])
            + check_flash_bwd(dev) + check_scan_bwd(dev))
    bad = [r for r in recs if not r["ok"]]
    bad += check_flash_refusal(dev)
    print(f"phase kernels: {len(recs)} checks, {len(bad)} failed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        print(f"FAIL: kernels disagree with their plain versions: {bad}",
              file=sys.stderr)
        return 1
    free_device()
    t0 = time.perf_counter()
    print("phase invariance: a row's bits must not depend on the rows "
          "beside it", flush=True)
    varying = check_batch_invariance(dev)
    print(f"phase invariance: {time.perf_counter() - t0:.1f} s", flush=True)
    if varying:
        print(f"FAIL: results depend on the batch: {varying}",
              file=sys.stderr)
        return 1
    free_device()

    # the faults of ROADMAP queue 3: F7 (TF32 in the baseline conv) and F6
    # (int8 tokens on the card against the host's)
    print("phase faults: F7 and F6 against the host", flush=True)
    fault_problems = []
    run_faults(dev, fault_problems)
    free_device()

    # 3. minicpm-2b served at full width, contiguous cache
    t0 = time.perf_counter()
    full = configs.get_config("minicpm-2b")
    cfg = dataclasses.replace(full, n_layers=args.layers)
    print(f"phase serve: {cfg.name} d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}x{cfg.hd} (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.param_dtype}; n_layers {cfg.n_layers} "
          f"(published {full.n_layers})", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    naive = Model(dataclasses.replace(cfg, attention_impl="naive"))
    prompts = served_prompts(cfg.vocab, args.seed)
    runs = drive_main_path(model, params, prompts, args.max_new)
    expect = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
              "baseline": "baseline_gemm"}
    problems = [f"{r['label']}: {expect[r['algo']]} never launched"
                for r in runs if r["counts"][expect[r["algo"]]] == 0]
    problems += [f"{r['label']}: a request missed its token budget"
                 for r in runs if not r["budget_ok"]]
    problems += fault_problems
    print(f"phase serve: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3b. the reports: meta-device traces against the card's launches,
    # times and bytes
    run_reports(args, model, params, problems)

    # 4. first and second tokens against the plain path, and the bars'
    # witnesses: an int8 run without the flash kernel (held to
    # PLAIN_ATTENTION_BAR_SD), and served runs with planted faults
    t0 = time.perf_counter()
    readings = Readings(problems)
    plain = {q: PlainPath(model, params, prompts, q) for q in (False, True)}
    print(f"  plain paths built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for r in runs:
        readings.read(r["label"], r["done"], plain[r["quantized"]],
                      "int8" if r["quantized"] else "float")
        if not r["quantized"]:
            readings.deviation(r["label"], kernel_deviation(
                model, params, prompts, plain[False], r["algo"]))
    # plain attention on both sides: only the GEMM kernels and the batching
    # differ
    _, done, _ = serve(naive, params, prompts, max_new=2, batch_slots=4,
                       max_len=256, quantized=True, gemm_algo="ffip",
                       gemm_impl="cuda")
    worst = readings.read("int8-ffip, plain attention", done, plain[True],
                          "int8")
    if worst > PLAIN_ATTENTION_BAR_SD:
        problems.append(f"int8-ffip with plain attention reads {worst:.4f} "
                        f"sd, above {PLAIN_ATTENTION_BAR_SD}")
    for label, faulty in int8_step_faults(params, cfg.n_layers).items():
        _, done, _ = serve(model, faulty, prompts, max_new=2, batch_slots=4,
                           max_len=256, quantized=True, gemm_algo="ffip",
                           gemm_impl="cuda")
        readings.read(f"planted fault: {label}", done, plain[True], "int8",
                      fault=True, gated=False)
    label, faulty = wrong_layer(params, "attn", "wo", cfg.n_layers)
    for quantized in (True, False):
        _, done, _ = serve(model, faulty, prompts, max_new=2, batch_slots=4,
                           max_len=256, quantized=quantized, gemm_algo="ffip",
                           gemm_impl="cuda")
        tier = "int8" if quantized else "float"
        readings.read(f"planted fault: {label}, {tier} ffip", done,
                      plain[quantized], tier, fault=True)
    del faulty
    print(f"phase check: {time.perf_counter() - t0:.1f} s", flush=True)

    # 5. paged serving through K5: the page pool, prefix sharing, copy on
    # write and chunked prefill; the served runs and their token checks
    t0 = time.perf_counter()
    paged_prompts = make_prompts(cfg.vocab, 8,
                                 np.random.default_rng(args.seed), 16, 65,
                                 shared_prefix=64)
    print(f"phase paged: {PAGED_SLOTS} slots, max_len {PAGED_MAX_LEN}, "
          f"pages of {PAGE_SIZE}, prefill chunks of {PREFILL_CHUNK}; prompt "
          f"lengths {[len(p) for p in paged_prompts]}", flush=True)
    paged_runs = []

    def run_paged(label, m, p, **kw):
        rec, found = serve_paged(m, p, paged_prompts, args.max_new, label,
                                 **kw)
        problems.extend(found)
        paged_runs.append(rec)
        return rec

    flash = dict(paged_attention="flash", prefill_chunk=PREFILL_CHUNK)
    ffip = run_paged("paged flash ffip", model, params, gemm_algo="ffip",
                     decode_chunk=4, **flash)
    int8 = run_paged("paged flash int8-ffip", model, params,
                     gemm_algo="ffip", quantized=True, decode_chunk=1,
                     **flash)
    plain = {q: PlainPath(model, params, paged_prompts, q)
             for q in (False, True)}
    readings.read(ffip["label"], ffip["done"], plain[False], "float")
    readings.read(int8["label"], int8["done"], plain[True], "int8")
    del plain
    # Identity runs, at IDENTITY_LAYERS (the first layers of the same
    # weights). Chunking must not change a token: with every prompt in one
    # chunk, int8 and float FFIP must give the tokens they give in chunks of
    # 64 (the GEMMs' k-split plans do not depend on the rows of a dispatch,
    # and K5 and the norms do a row's arithmetic the same way at any chunk
    # width). And the reference's bit-identity contract: gather-paged int8
    # with plain attention must give the contiguous server's tokens.
    n_id = min(IDENTITY_LAYERS, cfg.n_layers)
    cfg_id = dataclasses.replace(cfg, n_layers=n_id)
    model_id = Model(cfg_id)
    naive_id = Model(dataclasses.replace(cfg_id, attention_impl="naive"))
    params_id = dict(params, layers=_first_layers(params["layers"], n_id))
    same = _same(*[run_paged(f"paged flash int8-ffip, {n_id} layers, "
                             f"prefill_chunk {c}", model_id, params_id,
                             gemm_algo="ffip", quantized=True,
                             decode_chunk=1, paged_attention="flash",
                             prefill_chunk=c)
                   for c in (PREFILL_CHUNK, PAGED_MAX_LEN)])
    print(f"  prefill_chunk {PREFILL_CHUNK} vs {PAGED_MAX_LEN} ({n_id} "
          f"layers): int8 tokens {same}", flush=True)
    if same != "identical":
        problems.append("int8 tokens change with the prefill chunk")
    same = _same(*[run_paged(f"paged flash ffip, {n_id} layers, "
                             f"prefill_chunk {c}", model_id, params_id,
                             gemm_algo="ffip", decode_chunk=1,
                             paged_attention="flash", prefill_chunk=c)
                   for c in (PREFILL_CHUNK, PAGED_MAX_LEN)])
    print(f"  prefill_chunk {PREFILL_CHUNK} vs {PAGED_MAX_LEN} ({n_id} "
          f"layers): float ffip tokens {same}", flush=True)
    if same != "identical":
        problems.append("float tokens change with the prefill chunk")
    gather = run_paged(f"paged gather int8-ffip, plain attention, {n_id} "
                       f"layers", naive_id, params_id, gemm_algo="ffip",
                       quantized=True, decode_chunk=1,
                       paged_attention="gather", prefill_chunk=PREFILL_CHUNK)
    _, done, _ = serve(naive_id, params_id, paged_prompts,
                       max_new=args.max_new, batch_slots=PAGED_SLOTS,
                       max_len=PAGED_MAX_LEN, quantized=True,
                       gemm_algo="ffip", gemm_impl="cuda")
    contiguous = dict(tokens={r.rid: list(r.out_tokens) for r in done})
    print(f"  gather-paged vs contiguous (int8, plain attention, {n_id} "
          f"layers): tokens {_same(gather, contiguous)}", flush=True)
    if gather["tokens"] != contiguous["tokens"]:
        problems.append("gather-paged tokens differ from the contiguous "
                        "cache's")
    print(f"phase paged: {time.perf_counter() - t0:.1f} s", flush=True)

    totals = {name: sum(r["counts"][name] for r in runs + paged_runs)
              for name in compat.launch_counts()}
    # the vision, SSM and training paths
    elsewhere = ("conv_gemm", "selective_scan", "flash_bwd",
                 "selective_scan_bwd")
    problems += [f"{name} never launched on the served path"
                 for name, n in totals.items()
                 if n == 0 and name not in elsewhere]
    problems += [f"{name} launched {totals[name]} times on the minicpm paths"
                 for name in elsewhere if totals[name]]
    print(f"launches over the minicpm served runs {totals}", flush=True)

    # 6. the CNN path: ResNet-50 and AlexNet through K7 (convs) and K1-K3
    # (FCs), against the plain path
    t0 = time.perf_counter()
    print(f"phase vision: ResNet-50 (224) and AlexNet (227), batch "
          f"{CONV_BATCH}, published widths, 1000 classes, f32 weights from "
          f"seed {args.seed}", flush=True)
    vision_recs, found = run_vision(dev, args.seed)
    problems += found
    totals["conv_gemm"] = sum(r["counts"].get("conv_gemm", 0)
                              for r in vision_recs)
    print(f"phase vision: {time.perf_counter() - t0:.1f} s", flush=True)

    # 7. one dispatch of each kind, counted and profiled. LM: 7 projections
    # per layer plus the unembed; attention once per layer: K4 in the
    # contiguous prefill, K5 in either paged dispatch. Vision: K7 for each
    # of the 53 convs, K3 for the FC.
    steps = contiguous_steps(model, params, 128)
    steps.update(paged_steps(model, params))
    steps["resnet50 forward"] = vision_step(dev, args.seed)
    print_profile(steps, lambda phase: (
        {"conv_gemm": 53, "ffip_gemm_y": 1}
        if phase == "resnet50 forward" else
        {"ffip_gemm_y": 7 * cfg.n_layers + 1,
         "flash_fwd": cfg.n_layers if phase == "prefill" else 0,
         "flash_paged": cfg.n_layers if "paged" in phase else 0}), problems)
    del steps, naive, model_id, naive_id, params_id
    free_device()

    # the autotuner and the prepared artifacts: the served GEMM and flash
    # buckets tuned, served with gemm_block="auto"; an 8-layer int8 FFIP
    # artifact written, loaded and served warm
    tune_counts, _ = run_tune(args, model, params, prompts, runs[0]["done"],
                              problems)
    free_device()
    art_dir = tempfile.mkdtemp(prefix="prepare_")
    try:
        prep_counts, artifact, prepared_tokens = run_prepare(
            args, prompts, problems, art_dir)
        # 8c. tensor parallelism: minicpm-2b and deepseek-v2-lite-16b
        # served on two ranks sharing the card
        dist_counts = run_dist(args, prompts, artifact, prepared_tokens,
                               readings, problems)
    finally:
        shutil.rmtree(art_dir, ignore_errors=True)
    free_device()
    for name in totals:
        totals[name] += (tune_counts[name] + prep_counts[name]
                         + dist_counts[name])

    # 8. the router and repro_torch.obs over replicas of the same model, at
    # its first IDENTITY_LAYERS layers
    n_fleet = min(IDENTITY_LAYERS, cfg.n_layers)
    fleet = run_fleet(args, Model(dataclasses.replace(cfg, n_layers=n_fleet)),
                      dict(params, layers=_first_layers(params["layers"],
                                                        n_fleet)),
                      prompts, problems)
    for name in totals:
        totals[name] += fleet[name]
    del model, params
    free_device()
    print(f"  device memory still allocated after the minicpm phases: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)

    # 8. the Mamba1 path: falcon-mamba-7b through K6 and K1-K3
    ssm_runs = run_ssm(args, readings, problems)
    totals["selective_scan"] += sum(r["counts"]["selective_scan"]
                                    for r in ssm_runs)
    for name in ("baseline_gemm", "fip_gemm", "ffip_gemm_y",
                 "ffip_carry_table"):
        totals[name] += sum(r["counts"][name] for r in ssm_runs)
    free_device()

    # 9. the training path: minicpm-2b through K4 + K8, falcon-mamba-7b
    # through K6 + K9, and the gradient readings
    t0 = time.perf_counter()
    train_recs, _ = run_train(args, problems)
    for name in ("flash_fwd", "flash_bwd", "selective_scan",
                 "selective_scan_bwd"):
        totals[name] += sum(r["counts"][name] for r in train_recs)
    print(f"phase train: {time.perf_counter() - t0:.1f} s", flush=True)
    free_device()

    # 10. the MLA + MoE path: deepseek-v2-lite-16b served through K1-K5 and
    # trained through K4 + K8
    moe_runs, moe_paged, moe_train = run_moe(args, readings, problems)
    for name in totals:
        totals[name] += sum(r["counts"].get(name, 0)
                            for r in moe_runs + moe_paged + moe_train)
    free_device()

    # 12. the four LM families: gemma3-4b, mixtral-8x22b, starcoder2-3b and
    # deepseek-coder-33b served (and gemma3 trained) at their published
    # widths
    fam = run_families(args, readings, problems)
    for name in totals:
        totals[name] += sum(r["counts"].get(name, 0)
                            for recs_ in fam for r in recs_)
    free_device()

    # 13. the encoder-decoder whisper-small served (its frontend entry point
    # and BatchServer) and trained, pixtral-12b served behind its patches
    # and as text (contiguous and paged)
    encdec = run_encdec(args, readings, problems)
    for name in totals:
        totals[name] += sum(r["counts"].get(name, 0) for r in encdec)
    free_device()

    # 13b. the other families on a mesh: gemma3-4b, mixtral-8x22b,
    # starcoder2-3b, deepseek-coder-33b, pixtral-12b and whisper-small
    # served on two ranks sharing the card, whisper's and pixtral's
    # frontend entry points at tp 2, the router's replicas on the mesh
    fam_tp, fam_tp_ranks = run_dist_families(args, readings, problems,
                                             encdec)
    for name in totals:
        totals[name] += fam_tp[name]
    del encdec
    free_device()

    # 13c. training on a mesh: minicpm-2b, falcon-mamba-7b and
    # deepseek-v2-lite-16b trained on (2, 1) and (1, 2) meshes of two ranks
    # sharing the card
    train_tp_ranks = run_dist_train(args, problems)
    for name in totals:
        totals[name] += sum(rank[name] for rank in train_tp_ranks)
    free_device()

    # 14. the Mamba2 + shared attention hybrid zamba2-1.2b served through
    # K1-K4 and trained through K4 + K8
    # ... and, inside it, phase dist's sharded scan: falcon-mamba-7b and
    # zamba2-1.2b served on two ranks sharing the card
    hybrid_runs, hybrid_train, tp_counts = run_hybrid(args, readings,
                                                      problems)
    for name in totals:
        totals[name] += tp_counts[name] + sum(
            r["counts"].get(name, 0) for r in hybrid_runs + hybrid_train)
    free_device()
    readings.gate()
    if problems:
        print("FAIL:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    # 15. the kernels line and the result line
    kernels = []
    for name in SOURCES:
        recs_k = [r for r in recs if r["kernel"] == name]
        if name == "conv_gemm":
            head = next(r for r in recs_k if (r["case"], r["dtype"],
                                              r["algo"]) == HEADLINE_CONV)
            shape = (f"{head['case']} batch {head['batch']} (M={head['m']} "
                     f"K={head['k']} N={head['n']}) f32 ffip; library: "
                     f"F.conv2d f32, TF32 off (none for int8: no CUDA int8 "
                     f"conv in PyTorch)")
        elif name == "selective_scan":
            head = next(r for r in recs_k if r["case"] == HEADLINE_SCAN)
            shape = (f"B={head['b']} S={head['s']} di={head['di']} "
                     f"N={head['n']} chunk {head['chunk']} bf16, falcon "
                     f"prefill; library: none (no PyTorch call computes a "
                     f"selective scan)")
        elif name == "flash_bwd":
            head = next(r for r in recs_k if (r["case"], r["dtype"])
                        == HEADLINE_FLASH_BWD)
            shape = (f"BH={head['bh']} S={head['s']} d={head['d']} causal "
                     f"bf16, minicpm-2b training; ms by CUDA-graph replay; "
                     f"library: aten._scaled_dot_product_"
                     f"{head['library_op']} on its forward's saved outputs, "
                     f"by CUDA-graph replay")
        elif name == "selective_scan_bwd":
            head = next(r for r in recs_k if r["case"] == HEADLINE_SCAN_BWD)
            shape = (f"B={head['b']} S={head['s']} di={head['di']} "
                     f"N={head['n']} chunk {head['chunk']} f32, falcon-mamba "
                     f"training; ms by CUDA-graph replay (the kernel and the "
                     f"wrapper's sums of its partials); library: none (no "
                     f"PyTorch call computes a selective-scan backward)")
        elif name == "ffip_carry_table":
            _, k, n, dt = HEADLINE_GEMM
            head = next(r for r in recs_k if (r["k"], r["n"], r["dtype"])
                        == (k, n, dt))
            shape = (f"y K={k} N={n} f32 (of {dt} weights) -> ({k}, "
                     f"{-(-n // 32)}), once per weight, memoized beside y; "
                     f"ms by CUDA-graph replay; "
                     f"library: torch.cumsum(y, 1), by CUDA-graph replay")
        elif name == "flash_fwd":
            head = next(r for r in recs_k if (r["case"], r["dtype"])
                        == HEADLINE_FLASH)
            shape = (f"BH={head['bh']} S={head['s']} d={head['d']} causal "
                     f"bf16, minicpm-2b prefill; ms by CUDA-graph replay; "
                     f"library: scaled_dot_product_attention, by CUDA-graph "
                     f"replay")
        elif name == "flash_paged":
            head = next(r for r in recs_k if (r["case"], r["dtype"])
                        == HEADLINE_PAGED)
            shape = (f"B={head['b']} H={head['h']} KV={head['kv']} "
                     f"Sq={head['sq']} d={head['d']} ps={head['ps']} "
                     f"max_pages={head['max_pages']} bf16 decode; ms by "
                     f"CUDA-graph replay; library: page gather + "
                     f"scaled_dot_product_attention, by CUDA-graph replay")
        else:
            m, k, n, dt = HEADLINE_GEMM
            head = next(r for r in recs_k if (r["m"], r["k"], r["n"],
                                              r["dtype"]) == (m, k, n, dt))
            shape = f"M={m} K={k} N={n} {dt}"
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs_k),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": shape,
            "fleet_launches": fleet[name],
            "dist_families_launches_by_rank": [
                rank[name] for rank in fam_tp_ranks],
            "dist_train_launches_by_rank": [
                rank[name] for rank in train_tp_ranks],
            "per_shape": [{k: v for k, v in r.items()
                           if k not in ("kernel", "ok")} for r in recs_k]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
