#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases (every failure exits nonzero):
  1. the card: name, power limit, count;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
  3. each kernel against its plain PyTorch version at the shapes its path
     gives it: ``nvfp4_qdq`` (bitwise) and ``nvfp4_matmul`` (within one
     bf16 ulp of the f32 product plus the f32 summation-order bound) at
     the acereason-7b serving shapes (M = 4 for decode, M = 4 * 64 for
     prefill); the KL forward and backward (tolerances below) at the
     olmo-1b training shape (T = 8 * 512, V = 50304), at a full
     acereason-7b vocabulary (T = 1024, V = 152064), at MoE QAD's
     (T = 4 * 512, V = 151936) and data-free QAD's (T = 8 * 128, V = 50304)
     shapes, with a ragged V, a
     masked-out row and identical logits; ``paged_attention`` (tolerance
     below) at the engine's acereason-7b shapes (decode: 8 slots against
     pages [272, 16, 4, 128] through tables [8, 34], pos 1..544; a paged
     prefill chunk of 16 queries; a decode step at 4096 keys), with a dead
     table tail, a window, FP8 pages, 4096 and 32768 keys and pos on the
     boundaries of the blocks' key parts; ``nvfp4_qdq`` with its own amax
     (bitwise) in the scopes the engine and the trainer use (row at decode
     and exact prefill, token in a paged chunk, tensor in training, also
     on the qwen2-moe-a2.7b expert stacks [60, 1408, 2048] and
     [60, 2048, 1408] and its routed experts' input slab; bf16 and f32),
     on a misaligned view and with a NaN and an inf; one device
     kernel for one K1 call and for one decode-shaped K7 call (the
     profiler); ``nvfp4_matmul_grouped`` (K3) at the qwen2-moe-a2.7b expert
     stacks (60 experts, (K, N) = (2048, 1408) and (1408, 2048); M = 8 at
     decode, 42 at an exact 512-token prefill, 16 in a paged-prefill chunk),
     within K2's tolerance of its plain version and bitwise equal to K2 run
     on each expert's slices, with a shared and a per-expert tensor scale
     and a padded K; ``nvfp4_matmul_tp`` (K4): each tp = 2 rank tile of
     the acereason-7b sites (M = 8 and 256) through K2 within K2's
     tolerance, the row-mode sum of the two tiles within the summation
     bound of the full-K plain product; at every acereason-7b site the
     rows of the M = 256 product (the tensor-core tile form) bitwise equal
     to the same rows computed at M = 16 (a paged-prefill chunk), M = 4
     and alone, bf16 and f32 out (row invariance, which the engine's
     bitwise gates rely on); the largest |kernel - plain| / tolerance of
     every K2, K3 and K4 shape is printed; at the rglru_hybrid family's
     shapes (nemotron-nano-9b-sim: K and N of 4480 and 15680, 15680 not a
     multiple of 128; recurrentgemma-2b: 2560 and 7680) K2 on one
     [layer, inner] slice of a weight stacked over two leading axes,
     packed as PTQ packs ``blocks/rec``, at M = 8 and 256 within its
     bound, rows bitwise equal, and K1 in row scope at [8, 1, K] bitwise
     (phase 3h);
     at the shapes of rwkv6-3b (K2 at (K, N) = (2560, 64), (2560, 160)
     below one 128-row weight tile, (2560, 2560), (2560, 8960), (8960,
     2560)), whisper-tiny (the cross-attention KV's (384, 1152) at M =
     12000, 8 slots x 1500 frames; (1536, 384)) and qwen2-vl-2b ((1536,
     2048), (8960, 1536)) at M = 8 and the larger M within K2's bound,
     rows bitwise equal across M, and K1 in row scope at [8, 1, K] for K =
     2560, 8960, 384, 1536 bitwise (phase 3i);
     ``paged_attention`` at the speculative verify's shape (8 slots, 5
     queries each at positions across block and part boundaries,
     acereason-7b's heads) within tolerance and each query's rows bitwise
     a one-query call's, and on FP8 pages at qwen2-moe-a2.7b's 16/16 heads
     (decode, 3 queries with the same row gate, a 16-query chunk);
     ``fp8_quantize`` on the card bitwise the CPU's, E4M3 ties included
     (phase 3k); whether the BF16 GEMM rows (every config's lm_head, the
     BF16 attention and MoE router sites) and RMSNorm rows at M = 1, 4, 8,
     24, 40 equal rows computed one at a time (printed), and the slab
     decode attention's rows at 4 slots bitwise batch-1 calls (phase 3l);
  4. smoke-size models on the card against the same weights on the CPU:
     serving prefill and greedy tokens, and one QAD training step, for
     acereason-7b / olmo-1b and for rwkv6-3b, whisper-tiny (each sequence
     with encoder frames) and qwen2-vl-2b (a patch grid, pos3), whose QAD
     step launches one K5, one K6 and two K1 a quantized site; qwen2-vl-2b
     (a head of 32) with NVFP4 activations at per-token scales, prefill of
     40 and 8 decode steps, each step's logits within LOGIT_TOL["nvfp4"]
     of the CPU's (ROADMAP C.1 (a));
  5. the static serving path: ``acereason-7b`` at full width and 14 of its
     28 layers, packed NVFP4 weights from a seed, ``serve_batch`` with
     batch 4, prompt 64, gen 16, with the launch counters read around it; a traced decode
     step; then the QDQ-format replay from the same seed, whose first-step
     logits must agree with the packed path's (see the tolerances below);
  5b. the engine (``repro_torch.serve.Engine``) over packed weights of
     ``acereason-7b`` at full width and depth.  Run A: 16 requests of prompt lengths 64..512, 16 greedy
     tokens each, 8 submitted at the start and one after each step, 8
     slots over a pool of 272 blocks of 16, exact prefill, worst-case
     reservation; every request finishes, the pool drains, K7 launches 28
     times per decode step, first tokens equal single-request
     ``serve_batch``'s, and the first decode step's logits agree with the
     same engine with ``fused_kernels="off"``; a traced decode step.  Run
     B: 8 requests sharing a 256-token prefix with suffixes of 16..128
     tokens, paged prefill, on-demand paging and the prefix cache; tokens
     bitwise equal to the same workload with the cache off;
  5c. MoE serving: the engine over packed weights of ``qwen2-moe-a2.7b``
     at full width and depth (24 layers, 60 experts top-4 and a shared
     expert), ``fused_kernels="on"``.  Run M: run A's traffic; every
     request finishes, the pool drains, K3 launches 3 x 24 times per
     forward and K7 24 times per decode step, and the prefill logits and
     the first decode step's logits (on the fused run's first token) agree
     with the same engine with ``fused_kernels="off"`` on the first 8
     requests; the dropped fraction at prefill; a traced decode step.  Run M-B: 4 requests sharing a 256-token prefix, 8 tokens each,
     paged prefill (token dispatch, K3 at M = 16), prefix cache on against
     off: tokens bitwise equal;
  5d. tensor-parallel serving: the engine over packed weights of
     ``acereason-7b`` at full width and depth at tp = 2, two ranks (two
     processes, a gloo group) sharing the card, exact prefill.  First,
     on each rank, K4's wrapper ``ops.nvfp4_matmul_tp`` on the rank's tile
     of every site (M = 8 and 256) against ``ref.nvfp4_matmul_tp_ref`` on
     the same inputs at K2's tolerance, the row sites' f32 result against
     the full-K plain product at the summation bound.  Run TP:
     the first 8 of run A's requests, 16 greedy tokens each, 8 slots, run
     A's pool; every request finishes and every rank's pool drains, the
     ranks agree on every token, every packed leaf and the KV pool are
     sharded (per-rank pool bytes x 2 = run A's), each rank launches
     ``nvfp4_matmul_tp`` (K4) 5 x 28 times per forward and neither K2 nor
     K7, and each request's prefill logits lie within LOGIT_TOL of run A's
     on the same prompt; a traced decode step on rank 0;
  5e. the rglru_hybrid family on the slab engine: ``nemotron-nano-9b-sim``
     at full width and depth (56 layers, 18.4 B params, packed, the hybrid
     recipe: attention in BF16), the slab plan recurrent + dense_kv, run
     A's traffic: every request finishes and every slot is released, K1
     and K2 launch as many times as the code's quantized sites say per
     forward, and each request's prefill and first-decode-step logits lie
     within LOGIT_TOL of ``serve_batch``'s path on its prompt; load and
     serving peak, state bytes a slot, the decode step's byte bound and a
     traced decode step printed;
  5f. ``recurrentgemma-2b`` at full size (26 layers, window 2048): 4
     requests of prompts 2100..2600 tokens and 16 greedy tokens, so its
     ring wraps in prefill and in decode: served one slot at a time and
     over 4 slots, tokens equal to single-request ``serve_batch``'s, the
     first decode step's logits within LOGIT_TOL; every slot released;
     and, printed, the 4-slot streams with the BF16 GEMMs one row at a
     time and the attention's products batched as before (ROADMAP C.1
     (b));
  5g. (inside 5b, on its weights) chunked prefill: run A's traffic with
     ``prefill_mode="chunked"`` and chunks of 256: every request finishes,
     the pool drains, K1, K2 and K7 launch counts, each request's prefill
     logits within LOGIT_TOL of run A's exact prefill (chunk-granular
     activation amaxes make them approximate), a 256-token prompt in one
     chunk against exact prefill; TTFT beside run A's;
  5h. ``rwkv6-3b`` at full size (32 layers, 40 WKV heads of 64, 3.10 B
     params) on the slab engine, plan ("recurrent",), 8 slots: run A's
     arrivals, 16 prompts of 64 k tokens (k = 1..8, each twice: the
     chunked WKV takes at most 64 tokens or a multiple of 64) from its own
     vocabulary, 16 greedy tokens: every request finishes and every slot
     is released, K1 and K2 launch 320 times a forward, each request's
     prefill logits bitwise the static path's and its first decode step
     within LOGIT_TOL, 1 request one slot at a time equal to
     ``serve_batch``'s tokens; load and serving peak, state a slot, the
     decode step's byte bound and a traced decode step printed;
  5i. ``whisper-tiny`` at full size (4 + 4 layers, 1500 encoder frames) on
     the slab engine, plan dense_kv + encoder_output, 8 slots of 448
     positions: 16 requests, each with its own seeded ``enc_frames``,
     prompts 4..192, 64 greedy tokens: 5h's gates (K1 and K2: 44 a
     prefill, 28 a decode step; one slot at a time against the static
     path at the slab's 448 positions), and a request without frames
     refused at admission;
  5j. ``qwen2-vl-2b`` at full size (28 layers, M-RoPE sections (16, 24,
     24)), packed: 2 sequences of 512 tokens with a 16 x 16 patch grid at
     16 (``vis_embeds`` from the seed, pos3 in Qwen2-VL's layout): prefill
     of 480 tokens and 32 ``decode_step``s with their pos3 against
     teacher-forcing ``apply`` over all 512, with BF16 activations within
     LOGIT_TOL["bf16_act"] and with NVFP4 activations (per-token scales)
     printed (the reference's decode parts from its teacher forcing as
     far; phase 4 gates the NVFP4 decode against the CPU); K1 and K2
     launch counts; the engine refuses it (``vision_prefix``);
  5k. FP8 KV: qwen2-moe-a2.7b at full size with ``quant_recipe=
     "moe_hybrid"`` (attention BF16, an FP8 pool, experts packed), run M's
     traffic through the fused tier: every request finishes, the pool
     drains and holds the layout's bytes (E4M3 pages and f32 scales), K3
     and K7 launch counts, each request's first token equal to the static
     path's at batch 1 (FP8 dense cache) and its first decode step within
     LOGIT_TOL, a traced decode step with one K7 kernel a layer; the decode
     step's byte bound; then the speculative engine at k = 2 (self-qdq) on
     all 16 requests (more than the 8 slots), 8 tokens: streams equal to
     the plain run's
     (gated where phase 3l found the BF16 GEMM rows invariant across M = 8
     and 24), first tokens, the first verify's logits within LOGIT_TOL;
  5l. speculative decoding (``repro_torch.spec.SpecEngine``): acereason-7b
     on run A's loads and all 16 of its requests on the 8 slots (so a
     request takes a slot, pool blocks and draft blocks another released),
     8 tokens, with a self-qdq
     draft at k = 4, self-truncate at 14 layers and a 2-layer two-model
     draft (seed 99), each run's streams equal to run A's token for token,
     the pool drained, accepted + rolled back = drafted, acceptance and
     tokens a round printed; rwkv6-3b (inside 5h) with a self-qdq draft at
     k = 3 on 2 requests, 8 tokens, its streams equal to run H's;
  5m. serving telemetry (``repro_torch.obs``) on 5l's loads: (a) run A's
     traffic through three engines, telemetry off, metrics, metrics and
     trace, one warm-up each, then stepped in lockstep (their order
     rotated every round): streams bitwise
     equal across the three, the trace and snapshot valid
     (``obs.validate``: balanced lanes, each request's lane opening
     ``request`` and ``queue`` and closing ``request``; the Prometheus
     text), each ``kernel_dispatch_total{kernel}`` equal to the launches
     counted around that engine's own steps and ``qeinsum_dispatch_total
     {pallas_2d}`` to its K2 launches; the per-token decode-latency floor
     and p50 of each mode and the overhead on each printed, not gated; (b) the speculative engine (self-qdq, k = 2) at 14 of the 28
     layers, 8 requests, 16 tokens, traced: streams equal to the plain
     engine's at that depth, the draft, accepted and rolled-back
     counters equal to ``stats()``, the verify histogram's count the
     verify steps; (c) run B's load traced: streams equal run B's, the
     cache counters the pool's; (d) the shadow teacher (the BF16 seed-0
     tree on the card beside the student) on 8 of run A's requests, 16
     tokens, rate 0.25: streams equal the run without it, sampled
     records, a finite live KL >= 0, top-1 in [0, 1], per-layer SQNR,
     the snapshot valid, clean against clean passing the drift gate;
     then on ``inject_quant_noise(params, 0.3)``: the gate trips on amax
     or KL; seconds a shadow step, live KL, top-1, SQNR printed; (e)
     whisper-tiny at full size, run I's first 8 requests, 16 tokens, traced
     with the shadow: the trace valid, streams equal telemetry off;
  5n. the decoder's remaining serving paths under tensor parallelism, two
     ranks sharing the card: (a) qwen2-moe-a2.7b under ``moe_hybrid`` at
     full size, each rank drawing its tiles leaf by leaf, the 60 experts
     split on E (30 a rank) and the FP8 pool by KV head, run K's first 8
     requests, 8 tokens: the ranks' streams bitwise equal, pools drained,
     the per-rank FP8 pool half of run K's, experts and FP8 scales
     sharded, 5 K1 and 3 K4 launches a layer a forward (and no K2, K3 or
     K7), prefill logits within TP_LOGIT_TOL of run K's and of the same
     prefills through run K's engine with ``fused_kernels="off"`` (the
     tier a TP rank runs), and a planted fault (each rank's experts one
     place off, K's first 4 requests) outside it; each first token among
     the fused-off logits' top TP_FIRST_RANK, later tokens' agreement
     printed (random weights' near-flat logits flip a greedy token under
     any change of summation order: the card's fused and fused-off tiers
     part on 3 of these 8 first tokens); a traced decode step (every
     slot busy) of the run on rank 0; (b) the
     same with ``moe_shard="tp"`` (each expert's FFN dim split: 704
     features, 44 whole blocks a rank), 4 requests, 4 tokens, the same
     gates; (c) on phase 5d's tiles, run A's 4 shortest prompts, 8
     tokens: a self-qdq ``SpecEngine`` at k = 2: streams equal the rank's
     plain TP engine's, acceptance 1.000, drafted = accepted + rolled
     back, the ranks agree, the draft pool's local KV heads, and the
     gather-then-attend attention's rows at the verify's 3 queries
     bitwise one query a call; (d) the BF16 teacher's tiles drawn leaf by
     leaf, the shadow's record of the same 4 prompts as contexts on every
     rank identical and against the single-device shadow on run A's tree
     (computed before the ranks start): the same sites and stats,
     per-layer SQNR within 1 dB, live KL within 10%; then (c)'s requests
     with the shadow at rate 0.25: tokens bitwise equal to (c)'s plain
     run.  (c), (d), then (a) and (b) run in 5d's two ranks after run TP;
  5o. the slab families under tensor parallelism, in the same two ranks
     after 5n, each model at full width and depth drawn leaf by leaf and
     freed before the next, on its one-card run's prompts and engine
     geometry (the one-card runs' prefill logits and streams copied to the
     host before the spawn, which runs after 5j): (a) nemotron-nano-9b-sim
     on run E's 4 shortest prompts, 4 tokens; (b) recurrentgemma-2b on run
     F's 4 prompts past its window (its one KV head, and so its ring,
     whole on both ranks), 8 tokens; (c) rwkv6-3b on run H's 4 shortest,
     8 tokens, then a self-qdq ``SpecEngine`` at k = 2 on 2 of them, 4
     tokens; (d) whisper-tiny on run I's first 8 with their frames, 16
     tokens.  Gates: every request finishes and every slot is released,
     the ranks' tokens bitwise equal; the first 4 requests' prefill logits
     within TP_SLAB_TOL of the one-card run's (its static path's), by
     family and activation format (BF16 activations for the RG-LRU
     hybrids and RWKV, whose NVFP4 readings at full depth are printed;
     both for whisper), a planted fault on those requests outside it (the
     RG-LRU's post-conv gather in reversed rank order on (a), RWKV's
     receptance gather so on (c), whisper's cross-attention ``x_wqkv`` cut
     contiguously on (d)), and each first token among the one-card logits'
     top TP_SLAB_RANK; the served path (NVFP4 activations) of (a)-(c) on a
     copy cut in depth (TP_SLAB_CUT, full width) within TP_CUT_TOL of one
     card on the same cut, a planted fault (each rank's own amax at the
     row sites) outside it; the shard report
     (every packed leaf split but those the rules keep whole; each split
     state leaf's bytes half one card's, the whole ones (recurrentgemma's
     ring, RWKV's shift carries, whisper's ``enc_out``) one card's); K1,
     K2 and K4
     launches per forward (no K3 or K7); the speculative run's streams
     equal the plain TP engine's, drafted = accepted + rolled back.
     Printed: TTFT p50, the decode step p50 and tok/s, collectives a
     forward and their host seconds, each rank's load and run peaks, the
     state a slot a rank, each run's seconds;
  6. the training path: ``launch.train.train`` on ``olmo-1b`` at full size
     (16 layers, d_model 2048, vocab 50304) under its config's
     rematerialization (``remat="full"``: the student's QDQ runs twice a
     step), one QAD step of batch 8 x 512 tokens with an eval after it,
     the launch counters read around it; a traced step; then one step
     under each of remat "none", "dots" and "full" from one host copy of
     the state: the updated student and moments bitwise equal, the step ms
     and peak memory of each, "full"'s peak at most 75% of "none"'s;
  6h. (after phase 6, its state freed from the card) QAD on a (2, 2) data x
     model mesh: one spawn of four gloo ranks sharing the card, each
     rank running ``launch.train.train_on_mesh`` (what ``train(mesh=(2,
     2), rules=...)`` runs in every rank).  Run 1: ``fsdp_tp`` on olmo-1b
     at full size, phase 6's ``TRAIN`` settings (one step of 8 x 512, an
     eval after it): its train loss and the eval KL beside phase 6's,
     the update (final - initial student) against phase 6's by relative
     L2 (phase 6's final student read from a host file with
     ``torch.load(mmap=True)``, each rank cutting its own shards); the
     planted fault (each rank's own activation amax, no maximum over the
     data group) at full depth, step 1's loss (the KL at the initial
     weights: a forward alone) against phase 6's.  Run 2, in the ranks
     before run 1: ``fsdp_only``, ``tp_only``, ``dp_only`` and the fault
     (under ``fsdp_tp``) for one step each on a copy cut to 4 of the 16
     layers at full width, each against a one-card step on the cut run
     in the parent before the spawn: the loss, the update and AdamW's
     first moment.  On the same cut under ``fsdp_tp``: a step with the
     numerics probes and a checkpoint (``--ckpt-dir``; its probes against
     the parent's cut step, run with the probes on, within
     ``MESH_NUMERICS_TOL``, every rank's snapshot equal), a run resumed
     from that checkpoint for step 2 against an uninterrupted 2-step run
     (bitwise on every rank), the checkpoint restored on one card by
     ``train()`` after the spawn (each rank's shards of it bitwise the
     rank's own), and ``qad_chunked`` against a one-card chunked step.
     MoE: qwen2-moe-a2.7b at full width cut to 2 layers (``MESH_MOE``),
     one step under ``fsdp_tp`` with the experts on E, one with
     ``moe_shard="tp"`` (their FFN dim), and the planted fault (each
     rank's own expert-stack amax), against a one-card step on the cut:
     the loss, the update and the layers' first moment within
     ``MESH_MOE_TOL``, the fault outside on the last two.  The slab
     families and the VLM (``MESH_SLAB``): nemotron-nano-9b-sim,
     recurrentgemma-2b and rwkv6-3b at full width cut in depth as phase
     5o cuts them, qwen2-vl-2b at 2 of its 28 layers, whisper-tiny whole,
     one ``fsdp_tp`` step each through ``core.qad.make_train_step(mesh=,
     rules=)`` on its own global batch (whisper's encoder frames, the
     VLM's grid), against a one-card step on the same cut run in the
     parent before the spawn: the loss and the layer stacks' largest leaf
     update and first moment within ``MESH_SLAB_TOL``; the planted faults
     (recurrentgemma's gates' reduce-scatter, rwkv6's receptance gather,
     each with no backward) outside on the update or the moment; the
     MQA KV head of recurrentgemma's fused QKV tile bitwise equal on
     every model rank.  Gates: finite
     metrics, every rank's equal; the leaves
     a group replicates bitwise equal on its ranks; each rank's stored
     student, teacher and moments its partition factors' share; K1, K5
     and K6 launches per rank as ``mesh_launches`` predicts from the
     code; each reading within ``MESH_TOL`` of one card, the faults
     outside (at full depth on the step-1 loss, on the cut on the update
     and the layers' moment).  Printed: each group's collectives a step
     and their host seconds, the step ms, the bytes and the peak GB a
     rank, the card line;
  6b. MoE QAD: ``launch.train.train`` on ``qwen2-moe-a2.7b`` at full width
     (d_model 2048, 60 experts top-4 of d_ff 1408, a shared expert of
     5632, vocab 151936) and 4 of its 24 layers (the config cut in depth
     here), remat "full", local dispatch, 3 steps of 4 x 512 with an eval
     after each: K1, K5 and K6 launch counts, finite metrics, a changed
     student, the step ms against a bound from the active parameters; a
     traced step;
  6c. data-free QAD: olmo-1b's BF16 teacher generates 8 x 128 tokens from
     BOS (``data.generated``, temperature 1, top_p 1), and 2 QAD steps of
     8 x 128 train on them: tokens in the vocabulary after the BOS id, a
     finite KL, a changed student, the generation's tok/s;
  6d. the numerics plane: 2 olmo-1b steps through ``train.train`` with
     ``numerics=True, metrics_out=...`` and 2 without, and the probe-free
     run once more as a control: the student and moments bitwise equal
     across all three, the snapshot and its ``.prom`` valid
     (``obs.validate``), per-layer SQNR and hidden divergence printed;
     then ``core.ptq.calibrate_activations`` (max, percentile, mse) over
     the teacher's 16 hidden taps on a batch of 2 x 512;
  6e. QAD on ``nemotron-nano-9b-sim`` at full width cut to one
     super-block (n_layers 5, attn_period 5: 4 RG-LRU layers and 1
     attention layer, 2.67 B params), remat "full", 2 steps of 4 x 512
     with an eval after each: K1, K5 and K6 launch counts, finite metrics,
     a changed student, the step ms against 10 N T and the peak;
  6f. QAD on ``rwkv6-3b`` at full width and 16 of its 32 layers through
     ``launch.train.train``, remat "full", 2 steps of 4 x 512 with an eval
     after each: K1, K5 and K6 launch counts, finite metrics, a changed
     student, the step ms against 10 N T and the peak;
  6g. QAD on ``qwen2-vl-2b`` at full size through ``core.qad.
     make_train_step`` on batches in 5j's layout (one grid a sequence),
     remat "full", 2 steps of 4 x 512 with an eval after each: as 6f;
  7. (run after phase 5d, before phase 6, so that the training paths
     run without phase 3's tensors resident) kernel, plain, bound and
     library times (CUDA events around each call, the L2 flushed between
     calls, the median; the floor of one tiny kernel between two events
     is printed), K2 also at M = 16 (the
     engine's paged-prefill chunk), K4 as K2 on each rank's tile of every
     acereason-7b site at M = 8 and 256, K1 as the engine and the trainer
     call it (each site alone and one layer's five sites back to back,
     beside the former call with the torch amax), K7 at decode, in a paged
     chunk and at 4096 keys, K2 at rwkv6-3b's sites at M = 8 and at
     whisper-tiny's cross-KV at M = 12000, K7 at the verify shape and on
     FP8 pages at qwen2-moe-a2.7b's heads.  Every traced step counts its device ops: the
     port's kernels (a QDQ kernel for each QDQ call) and the others;
  8. a ``kernels`` JSON line, the card line, and the final JSON line.

Exits 2 without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

SEED = 0
BATCH, PROMPT, GEN = 4, 64, 16
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
L2_FLUSH_BYTES = 128 << 20     # larger than the 50 MB L2
SPIN_CYCLES = 100_000_000      # about 50 ms of one SM: the host queues ahead
# Packed (kernel) vs QDQ (cuBLAS) paths on bitwise-equal weights, relative
# L2.  The two differ only in each GEMM's f32 summation order, which moves
# a rare bf16 output by one ulp.
#  * One layer on the QDQ path's input, relative to the layer's update:
#    1e-2 with BF16 activations; 0.15 with NVFP4 activations, where the
#    layer's four activation quantizers carry a one-ulp difference across
#    E2M1 rounding ties (0.081 measured on an H100).
#  * First-step logits of the whole stack: the random-weight stack
#    compounds those differences (0.018 with BF16 activations and 0.33 with
#    NVFP4 activations measured on an H100 over all 28 layers; these
#    tolerances were set after that measurement, and the phase now runs
#    SERVE_DEPTH of them).  Logits with nothing in common differ by about 1.4,
#    so 0.5 still catches a wrong kernel.
LAYER_TOL = {"bf16_act": 1e-2, "nvfp4": 0.15}
LOGIT_TOL = {"bf16_act": 5e-2, "nvfp4": 0.5}
# KL kernels against their plain versions on the same logits:
#  * forward (K5): per-token KL within rtol 1e-4 plus 16 f32 ulps of
#    |z_t| + |z_s| (the KL is a small difference of two terms of about
#    log V, and the two versions sum e^x in other orders); each logsumexp
#    within 8 f32 ulps;
#  * backward (K6), given the same logsumexps: within one ulp of the
#    output dtype of the plain version's f32 value, plus 4 f32 ulps of
#    (p_s + p_t) |g| for the two expf.
KL_SHAPES = {"train": (8 * 512, 50304), "acereason_row": (1024, 152064),
             "moe_train": (4 * 512, 151936), "data_free": (8 * 128, 50304),
             "nemo_train": (4 * 512, 131072)}
# paged attention (K7) against its plain version: within one bf16 ulp of
# the larger of the two values plus this absolute term.  The two sum the
# dot products, the exps and p V in other f32 orders, which moves a rare
# probability by one bf16 ulp, about 1e-4 of the output at these shapes.
K7_ATOL = 1e-3
# the engine runs (acereason-7b): pool geometry, run A's and run B's traffic
ENGINE = dict(n_slots=8, block_size=16, max_blocks_per_slot=34, n_blocks=272)
# the engine's paged-prefill chunk: rows a GEMM sees per chunk
CHUNK = 16
RUN_A = dict(requests=16, min_prompt=64, max_prompt=512, gen=16)
# (run B takes 8 requests, M-B 4: the script's time limit, with phase 6h's
# MoE and checkpoint runs; 16 and 8 before)
RUN_B = dict(requests=8, prefix=256, min_suffix=16, max_suffix=128, gen=8)
# fused (K7) against unfused (gather + attend) decode: the first decode
# step's logits per request, relative L2.  The attention outputs differ by
# f32 summation order only, which moves a rare bf16 output by one ulp; the
# first decode step came out bitwise equal for all 16 requests on an H100,
# the NVFP4 quantizer of each layer's attention output absorbing the
# flips.  One flip that crosses an E2M1 boundary in any of the 28
# random-weight layers moves the logits as far as the packed-vs-QDQ GEMM
# differences do (0.33 measured on an H100, LOGIT_TOL below), so the gate
# sits at that level.  Logits with nothing in common differ by about 1.4.
# The MoE run (qwen2-moe-a2.7b) holds its prefill logits and its first
# decode step's logits (each request fed the fused run's first token) to
# the same level: there the grouped GEMM (K3) sums in another order than
# the unfused path's dequantize-and-multiply too.
FUSED_TOL = 0.5
# the static serving path runs at this depth (full width): the engine's
# runs below take the full 28 layers
SERVE_DEPTH = 14
# MoE serving (qwen2-moe-a2.7b, full size): run M takes run A's traffic;
# the fused-off comparison replays its first 8 requests for 4 tokens; run
# M-B is paged prefill over a shared prefix
MOE_ARCH = "qwen2-moe-a2.7b"
RUN_M_OFF = dict(requests=8, gen=4)
# run K's speculative engine takes all 16 requests at 8 tokens (16 at 32
# took about 26 s, before phase 5o): more requests than the 8 slots, so
# a request is admitted into a slot, its pool blocks and its draft
# mirror's that a finished one released
RUN_KSPEC = dict(requests=16, gen=8)
RUN_MB = dict(requests=4, prefix=256, min_suffix=16, max_suffix=128, gen=8)
# tensor-parallel serving (acereason-7b, full size): two ranks share the
# card; run A's first 8 requests, 16 tokens each
TP_SIZE = 2
RUN_TP = dict(requests=8, gen=16)
# the decoder's remaining serving paths at tp = 2 (phase 5n): qwen2-moe-
# a2.7b under moe_hybrid with its experts split on E (run K's first 8
# requests, 8 tokens) and on their FFN dim (4 requests, 4 tokens); on
# phase 5d's acereason-7b tiles, run A's 4 shortest prompts: a self-qdq
# draft at k = 2 and the plain engine, 8 tokens; the shadow teacher's
# record of each as a context, then the shadow on at rate 0.25 (all in 5d's
# ranks)
# (8 and 4 tokens keep the script well inside its time limit on a slow
# host; (a) needs every one of the 8 slots busy at a decode step, which it
# traces), and a planted fault on the first 4 requests
RUN_KTP = dict(requests=8, gen=8, ffn_requests=4, ffn_gen=4,
               fault_requests=4)
# phase 5n (a) and (b)'s prefill logits against one card's (relative L2),
# and where the fused-off card's logits may rank TP's first token.  Read
# on the H100 (PERF.md, section 6): sound TP 0.090-0.153 from either one-card
# tier (the two tiers 0.081-0.145 apart), a planted fault (each rank's
# experts one place off) 0.472-0.561, which LOGIT_TOL's 0.5 let through;
# TP's first tokens rank 0-3 there, the fused tier's own 0-2.  Random
# weights' near-flat logits flip a greedy token under another summation
# order, so the tokens themselves are not gated equal
TP_LOGIT_TOL = 0.25
TP_FIRST_RANK = 8
# (the shadow at rate 0.2, one shadow step in 5n-c's 8 tokens: it took
# 0.5, 4 steps and about 25 s, before phase 5o; 0.25, 2 steps, before phase
# 6h's slab run)
RUN_NTP = dict(spec_k=2, spec_gen=8, shadow_contexts=4, shadow_rate=0.2,
               sqnr_db=1.0, kl_rel=0.1)
# the slab families at tp = 2 (phase 5o, in 5d's ranks after 5n), each at
# full width and depth on its one-card run's prompts and engine geometry:
# nemotron-nano-9b-sim on run E's 4 shortest prompts, 4 tokens;
# recurrentgemma-2b on run F's 4 (past its window), 8 tokens; rwkv6-3b on
# run H's 8 shortest, 8 tokens, then a self-qdq draft at k = 2 on 4 of
# them, 4 tokens; whisper-tiny on run I's first 8 with their frames, 16
# tokens; a planted fault on the first 4 requests of each family
# (rwkv6 on 4 requests and its draft on 2: 8 and 4 before phase 6h's MoE
# runs)
RUN_OTP = dict(nemo_requests=4, nemo_gen=4, rgemma_gen=8, rwkv_requests=4,
               rwkv_gen=8, spec_k=2, spec_requests=2, spec_gen=4,
               whisper_requests=8, whisper_gen=16, fault_requests=4)
# phase 5o's prefill logits against the one-card run's (relative L2), by
# family and activation format, each limit set between the sound readings
# and a planted fault's (H100, PERF.md section 6).  With NVFP4 activations
# (the served path) the RG-LRU hybrids and RWKV part from one card at full
# depth (0.50-1.06) nearly as far as a fault (1.24-1.33): random weights
# at full depth carry any change of summation order through the
# quantizers.  Those two are gated here with BF16 activations, where TP
# reads 0.032-0.059 (RG-LRU) and 0.20-0.34 (RWKV), the faults 1.23-1.29,
# and their served path on a copy cut in depth (TP_SLAB_CUT below).
# whisper-tiny: BF16 0.0067-0.0080 against 0.43-0.46, NVFP4 0-0.125
# against 0.44-0.48
TP_SLAB_TOL = {"rglru_hybrid": {"bf16": 0.25}, "rwkv6": {"bf16": 0.7},
               "encdec": {"bf16": 0.1, "nvfp4": 0.3}}
# phase 5o's gate of the served path (NVFP4 activations) where the full
# depth decorrelates it: each RG-LRU and RWKV model cut in depth at full
# width (nemotron-nano-9b-sim to one super-block of one RG-LRU layer and
# one attention layer, recurrentgemma-2b to one of its own super-blocks,
# rwkv6-3b to 2 layers), its prefill logits at tp = 2 against one card on
# the same cut, and a planted fault (each rank's own amax at the row
# sites) outside the limit.  Read on the H100 (PERF.md, section 6): sound
# 0.033-0.045 (nemotron), 0.029-0.089 (recurrentgemma, its prompts past
# the window), 0-0.080 (rwkv6; the readings move with the prompts); the
# fault 0.237-0.247, 0.277-0.330, 0.296-0.361
TP_SLAB_CUT = {"nemotron-nano-9b-sim": dict(n_layers=2, attn_period=2),
               "recurrentgemma-2b": dict(n_layers=3),
               "rwkv6-3b": dict(n_layers=2)}
TP_CUT_TOL = 0.17
# where the one-card logits may rank TP's first token, by family (in the
# gated formats): sound RG-LRU 0-2, whisper 0, RWKV 0-16, whose BF16
# logits part by 0.20-0.34 (the RG-LRU faults' tokens rank 5689-84785,
# RWKV's 164-24464; whisper's 0-7, its fault caught by the logits alone)
TP_SLAB_RANK = {"rglru_hybrid": TP_FIRST_RANK, "rwkv6": 64,
                "encdec": TP_FIRST_RANK}
# the rglru_hybrid family (the slab engine): nemotron-nano-9b-sim at full
# width and depth takes run A's traffic (phase 5e); recurrentgemma-2b at
# full size serves prompts longer than its window of 2048, so its ring
# wraps in prefill and in decode (phase 5f)
NEMO_ARCH = "nemotron-nano-9b-sim"
# (16 tokens: it took 32 before phase 5o; prompts of 2060-2160 tokens, past
# the window still: 2100-2600 before phase 6h's slab run)
RGEMMA = dict(arch="recurrentgemma-2b", requests=4, min_prompt=2060,
              max_prompt=2160, gen=16)
# chunked prefill on run A's engine and traffic (phase 5g)
RUN_G = dict(chunk=256)
# the training path
# (1 step: phase 6h's run 1 repeats it on the mesh at 8-10 s a step; it
# took 4 before phase 6h's MoE and checkpoint runs, 2 before its slab run)
TRAIN = dict(arch="olmo-1b", steps=1, lr=1e-5, batch=8, seq=512)
# the training mesh (phase 6h): one spawn of 4 gloo ranks sharing the card
# as a (2, 2) data x model mesh; run 1 is fsdp_tp on full-size olmo-1b
# (TRAIN's steps), run 2 the other three rules for one step each on a copy
# cut to 4 of its 16 layers (dp_only holds the whole state on every rank:
# four full replicas and their activations do not fit beside each other)
MESH_TRAIN = dict(shape=(2, 2), cut_layers=4,
                  rules=("fsdp_only", "tp_only", "dp_only"))
# phase 6h's limits against one card (relative), read on the H100
# (PERF.md section 6): run 1's step-1 train loss (sound 1.36e-3, the
# planted fault, each rank's own activation amax, 4.09e-3) and every
# step's (sound up to 7.7e-3 when it took 2 steps: the runs part as they
# train), its update (final - initial student, relative L2: sound 0.465
# after 2 steps, 0.468 after the one it takes now; Adam's first step
# moves a weight by about lr sign(g), below a bf16 ulp of most weights,
# so a rounding tie or a tiny gradient's sign flips an element); on the
# cut copy the loss (sound 0 without and 1.2e-3 with a model split, the
# fault 1.39e-3: it does not part there), the update (sound 0.020 and
# 0.334, the fault 0.714) and the layers' first moment, AdamW's m after
# the step (sound 0.0028 and 0.052, the fault 0.35-0.36)
MESH_TOL = {"step1_loss": 2.5e-3, "loss": 0.02, "full_update": 0.6,
            "cut_loss": 5e-3, "update": 0.5, "moment": 0.15}
# phase 6h's runs of the three options on the 4-layer cut (all fsdp_tp):
# the chunked KL for one step against a one-card qad_chunked step; the
# numerics probes on one step (an eval after it, a checkpoint written)
# against the one-card cut oracle's own probes (run with them on), within
# MESH_NUMERICS_TOL by stat; a run resumed from that checkpoint for step 2
# against an uninterrupted 2-step run with the probes off (bitwise), and
# the checkpoint restored on one card against the gathered shards
# (bitwise)
# (the card's activations follow the mesh's other products: a tensor's
# amax, its largest element, moved by 4.4% at one site on the cut, and
# the scales' use and the clip fraction with it, on an H100; these
# limits were set after that reading, PERF.md section 6)
MESH_NUMERICS_TOL = {"sqnr_db": ("abs", 0.5), "amax": ("rel", 0.1),
                     "clip_frac": ("abs", 1e-2), "scale_util": ("abs", 2e-2),
                     "hidden_cos": ("abs", 1e-3), "hidden_mse": ("rel", 5e-2),
                     "grad_norm": ("rel", 5e-2)}
# MoE QAD on the mesh: qwen2-moe-a2.7b at full width cut to 2 of its 24
# layers (1.77 B weights: 21 GB of state, about 5.3 GB stored a rank under
# fsdp_tp beside each rank's gathered tiles, gradient and activations),
# one step of 4 x 512 under fsdp_tp with the experts on E (30 a rank) and
# with moe_shard="tp" set here (704 FFN columns a rank), and the planted
# fault (each rank's own expert-stack amax, under "ep"), each against one
# card's step on the same cut run in the parent before the spawn.  Limits
# read on an H100 (PERF.md section 6): sound update 0.421, layers'
# first moment 0.162-0.165, the fault's 0.692 and 0.384; the loss (sound
# 1.2e-4-9.5e-4, the fault 1.26e-3) does not part, as on the dense cut
MESH_MOE = dict(layers=2, batch=4, seq=512)
MESH_MOE_TOL = {"loss": 5e-3, "update": 0.55, "moment": 0.25}
# the slab families and the VLM on the mesh (phase 6h's slab run): each at
# full width, the RG-LRU hybrids and RWKV6 cut in depth as phase 5o cuts
# them (TP_SLAB_CUT: nemotron-nano-9b-sim to one RG-LRU and one attention
# layer, about 1.7 B weights; recurrentgemma-2b to one super-block with its
# MQA window layer, 0.9 B; rwkv6-3b to 2 of its 32 layers, 0.5 B),
# qwen2-vl-2b to 2 of its 28 layers, whisper-tiny whole (vocab 51865, 1500
# encoder frames); one fsdp_tp step each of 4 x 512 (whisper's 4 x 448, the
# VLM's in 5j's layout) through core.qad.make_train_step(mesh=, rules=),
# against one card's step on the same cut and batch run in the parent
# before the spawn; the planted faults on the two smaller RG-LRU and RWKV
# models, a gather's backward taken away
MESH_SLAB = {**TP_SLAB_CUT, "qwen2-vl-2b": dict(n_layers=2),
             "whisper-tiny": {}}
MESH_SLAB_BATCH = dict(batch=4, seq=512, whisper_seq=448)
MESH_SLAB_FAULTS = {"recurrentgemma-2b": "gates", "rwkv6-3b": "receptance"}
# the slab run's limits against one card: the loss (relative), the layer
# stacks' largest leaf update (final - initial) and first moment (relative
# L2), read on the H100 (PERF.md section 6): sound loss 2.7e-5 to 6.1e-4,
# update 0.31-0.65, moment 0.080-0.35 (recurrentgemma's attention layer's
# MLP the largest: Adam's first step below a bf16 ulp, as on the olmo-1b
# cut); each fault 1.0 on both (the leaves it takes the gradient from),
# its loss the sound run's (the forward is unchanged)
MESH_SLAB_TOL = {"loss": 5e-3, "update": 0.8, "moment": 0.6}
# MoE QAD (qwen2-moe-a2.7b at full width, cut in depth), data-free QAD from
# the teacher's own tokens, the numerics runs and activation calibration
MOE_TRAIN = dict(layers=4, steps=3, batch=4, seq=512)
# QAD on nemotron-nano-9b-sim at full width and one super-block (4 RG-LRU
# layers and 1 attention layer): its 56 layers' training state does not
# fit one card (phase 6e)
# (2 steps: 3 before phase 6h's slab run trained the family on the mesh)
NEMO_TRAIN = dict(layers=5, steps=2, batch=4, seq=512)
# the last model families: rwkv6-3b on the slab engine with run A's
# arrivals (prompts of 64 k tokens: the chunked WKV takes at most 64 tokens
# or a multiple of 64), 2 requests again one slot at a time; whisper-tiny
# with each request's encoder frames, 8 slots of its 448-token text
# context; qwen2-vl-2b's M-RoPE over a 16 x 16 patch grid (phases 5h-5j);
# their QAD (rwkv6 at 16 of its 32 layers: the full depth's training state
# would come to about 70 GB; phases 6f, 6g)
# (16 tokens, one request one slot at a time, the speculative run on 4
# requests at 8 tokens: the script's time limit, with phase 5o)
RWKV = dict(arch="rwkv6-3b", gen=16, one_slot=1, spec_k=3, spec_requests=2,
            spec_gen=8)
WHISPER = dict(arch="whisper-tiny", requests=16, min_prompt=4, max_prompt=192,
               gen=64, s_alloc=448, one_slot=4)
QWEN_VL = dict(arch="qwen2-vl-2b", batch=2, seq=512, grid_at=16, grid=16,
               prompt=480)
# (2 steps each: 3 before phase 6h's slab run trained them on the mesh)
RWKV_TRAIN = dict(layers=16, steps=2, batch=4, seq=512)
VL_TRAIN = dict(steps=2, batch=4, seq=512)
# (128 new tokens: 256 took 13.6-24.2 s of generation, before phase 6h)
DATA_FREE = dict(batch=8, n_new=128, steps=2)
NUMERICS = dict(steps=2)
# calibration runs one batch (its MSE search took 52 s over two, 46 over
# one): with the FP8 KV and speculative phases the script passed 700 s;
# with phase 5o the MSE search takes every fourth tap (it took 28-38 s
# over all 16)
CALIB = dict(batches=1, batch=2, seq=512, mse_every=4)
# one smoke QAD step on the card against the CPU, same weights and batch:
# the forwards differ by bf16 GEMM summation order, which NVFP4 rounding
# amplifies; loss and gradient norm within these relative tolerances, each
# updated parameter within one bf16 ulp (of the larger of the two) plus
# 2 lr (step 1 of Adam moves each weight by lr g / (|g| + eps), at most lr)
STEP_TOL = {"loss": 2e-2, "grad_norm": 5e-2}
# speculative decoding on acereason-7b with run A's traffic (phase 5l): the
# draft length, the self-truncate draft's depth and the two-model draft's
# (run A's 16 requests on 8 slots, so slots, pool blocks and the draft
# mirror's blocks are reused; 8 of their 16 tokens: the script's time
# limit, with phase 5o)
SPEC = dict(k=4, truncate_layers=14, two_model_layers=2, requests=16, gen=8)
# serving telemetry (phase 5m): the speculative run's draft length, depth,
# requests and tokens; the shadow teacher's requests, tokens, rate and the
# noise canary's scale; whisper-tiny's requests
# (whisper's at 16 tokens, 4 shadow steps: it took 64, 16 shadow steps
# and about 25 s, before phase 5o; the shadow's at 8 tokens, 2 shadow
# steps a run: 16 took about 15 s a run)
OBS = dict(spec_k=2, spec_depth=14, spec_requests=8, spec_gen=16,
           shadow_requests=8, shadow_gen=8, shadow_rate=0.25, noise=0.3,
           whisper_requests=8, whisper_gen=16)
# the drift gate's thresholds (tests/test_numerics_obs.py::THRESHOLDS)
SHADOW_GATE = {"max_sqnr_drop_db": 1.0, "max_kl_increase": 0.05,
               "max_cos_drop": 0.02, "max_amax_rel": 0.1}


# spin kernels a training step's trace records ahead of the step, and how
# many more each retrace records: a profile's dropped records have stuck to
# the same records through one process's retraces (318 QDQ records of 320
# in all three, the last whole run of the script), as a drop at a fixed
# offset of the profiler's record buffers would, so each retrace moves the
# step's records against those offsets
WARMUP_SPINS = 32
RETRACE_SPINS = 19
# tokens each request of a traced engine decode step is given: the slots
# stay full for three traced steps after they fill
TRACE_GEN = 16
# the port's kernels by the names the profiler shows them under
PORT_KERNELS = ("qdq_one_pass", "qdq_two_pass", "paged_attention_kernel",
                "mma_kernel", "wg_kernel", "kl_fwd_kernel", "kl_bwd_kernel")


def trace_ops(prof, steps=1):
    """From a profile of ``steps`` steps, per step: ms by device kernel
    name, and the counts of device ops that are the port's kernels, that
    are QDQ kernels, and that are anything else (torch's kernels, copies);
    ``trace_step``'s warm-up spin kernels left out."""
    from torch.autograd import DeviceType
    by_kernel, n_port, n_qdq, n_other = {}, 0, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name:
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3 / steps)
            port = any(k in e.name for k in PORT_KERNELS)
            n_port += port
            n_qdq += "qdq_" in e.name
            n_other += not port
    return by_kernel, n_port / steps, n_qdq / steps, n_other / steps


def trace_step(label, step, qdq_gate: bool = True) -> None:
    """Trace one training step, ``step()`` (it returns the gradient norm),
    and print it: wall and busy ms, the idle share, its device ops (one
    QDQ kernel for each QDQ launch) and its time by kind of kernel.  The
    profiler first records WARMUP_SPINS spin kernels, which ``trace_ops``
    leaves out, so that it is running when the step starts (profiles have
    missed a few of a step's kernel records).  A profile that holds another
    number of QDQ kernels than the step launched is printed and the step
    traced again, RETRACE_SPINS more spins ahead of it, up to three times
    in all; a third mismatch fails under ``qdq_gate``, and is printed
    otherwise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    for attempt in (1, 2, 3):
        torch.cuda.synchronize()
        ops.reset_launches()
        spins = WARMUP_SPINS + RETRACE_SPINS * (attempt - 1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grad_norm = step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.launches)
        by_kernel, n_port, n_qdq, n_other = trace_ops(prof)
        if n_qdq == launches["nvfp4_qdq"]:
            break
        n_spin = sum(e.device_type == DeviceType.CUDA
                     and "spin_kernel" in e.name for e in prof.events())
        print(f"[trace] {label}: the profile holds {n_qdq:.0f} QDQ kernels "
              f"for {launches['nvfp4_qdq']} QDQ launches (trace {attempt}; "
              f"{n_spin} of {spins} spin kernels recorded)", flush=True)
    else:
        if qdq_gate:
            fail(f"{label}: {n_qdq} QDQ kernels for {launches['nvfp4_qdq']} "
                 "QDQ calls in three traces")
    if not math.isfinite(grad_norm):
        fail(f"{label}: non-finite gradient norm {grad_norm}")
    busy_ms = sum(by_kernel.values())
    print(f"[trace] {label} (traced): wall_ms={wall_ms:.1f} "
          f"device_busy_ms={busy_ms:.1f} idle_share={1 - busy_ms / wall_ms:.3f} "
          f"grad_norm={grad_norm:.4g}; device ops: {n_port:.0f} of "
          f"the port's kernels ({n_qdq:.0f} QDQ for "
          f"{launches['nvfp4_qdq']} QDQ calls), {n_other:.0f} others",
          flush=True)
    print_by_kind(label, by_kernel)
    for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[trace]   {ms:8.2f} ms  {kname[:110]}")


def profile_step(step, spins: int = WARMUP_SPINS) -> dict:
    """One call of ``step`` under the profiler, ``spins`` spin kernels
    recorded ahead of it (``trace_ops`` leaves them out): its device ops
    (``trace_ops``'s four values), its wall ms and its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    before = dict(ops.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(spins):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, n_port, n_qdq, n_other = trace_ops(prof)
    from torch.autograd import DeviceType
    n_k7 = sum(e.device_type == DeviceType.CUDA
               and "paged_attention_kernel" in e.name for e in prof.events())
    return dict(by_kernel=by_kernel, n_port=n_port, n_qdq=n_qdq,
                n_other=n_other, wall_ms=wall_ms, n_k7=n_k7,
                launches={k: v - before[k] for k, v in ops.launches.items()})


def all_decoding(eng) -> bool:
    """Every slot of ``eng`` decodes and no request waits."""
    return not eng.sched.waiting and len(eng.sched.running()) == eng.n_slots


def trace_steps(eng, label, tp=None):
    """``profile_step`` of an engine step, every slot decoding (the
    caller makes it so, with tokens to spare for two more steps).  The
    profiler drops a kernel's record now and then but never adds one: a
    profile that holds fewer QDQ kernels than the step launched is printed
    and the next step traced, RETRACE_SPINS more spins ahead of it, up to
    three in all, while every slot still decodes.  The caller gates the
    count of the last profile, which carries its ``attempt`` and, on a TP
    engine, the step's ``collectives`` and their host ``collective_ms``.
    Under ``tp`` every rank takes three steps (the collectives meet) and
    rank 0 alone traces: the other ranks get None."""
    t = None
    for attempt in (1, 2, 3):
        done = t is not None and (t["n_qdq"] >= t["launches"]["nvfp4_qdq"]
                                  or not all_decoding(eng))
        if done or (tp is not None and tp.rank):
            if tp is None:
                break
            eng.step()
            continue
        if t is not None:
            print(f"[trace] {label}: the profile holds {t['n_qdq']:.0f} QDQ "
                  f"kernels for {t['launches']['nvfp4_qdq']} QDQ launches "
                  f"(trace {attempt - 1})", flush=True)
        c0 = dict(eng.mesh.counts) if eng.mesh is not None else None
        t = profile_step(eng.step,
                         WARMUP_SPINS + RETRACE_SPINS * (attempt - 1))
        t["attempt"] = attempt
        if c0 is not None:
            t.update(collectives=eng.mesh.counts["calls"] - c0["calls"],
                     collective_ms=(eng.mesh.counts["seconds"]
                                    - c0["seconds"]) * 1e3)
    return t


def trace_filled(eng, prompts, label, tp=None, extras=None):
    """Fill every slot with ``prompts`` (TRACE_GEN tokens each; ``extras``
    each prompt's extras), ``trace_steps`` a decode step, then drain.
    Returns the trace (None on a TP rank other than 0)."""
    extras = extras or [None] * len(prompts)
    for p, e in zip(prompts[:eng.n_slots], extras):
        eng.submit(p, TRACE_GEN, extras=e)
    while not all_decoding(eng):
        eng.step()
    t = trace_steps(eng, label, tp)
    eng.drain()
    return t


def tp_trace_record(t) -> dict:
    """A TP rank's trace (``trace_steps``) as host data: device ops, wall
    and busy ms, K4's ms, the step's collectives, the top kernels."""
    by_kernel = t["by_kernel"]
    return dict(n_port=t["n_port"], n_qdq=t["n_qdq"], n_other=t["n_other"],
                qdq_calls=t["launches"]["nvfp4_qdq"], attempt=t["attempt"],
                launches=t["launches"], wall_ms=t["wall_ms"],
                busy_ms=sum(by_kernel.values()),
                k4_ms=sum(ms for kname, ms in by_kernel.items()
                          if "mma_kernel<false" in kname
                          or "wg_kernel<false" in kname),
                collective_ms=t["collective_ms"], collectives=t["collectives"],
                top=sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])


def print_by_kind(label, by_kernel) -> None:
    """Print a trace's device ms by kind of kernel."""
    groups = {}
    for kname, ms in by_kernel.items():
        has = lambda *words: any(w in kname for w in words)
        g = ("port kernels" if has(*PORT_KERNELS)
             else "gemm" if has("nvjet", "gemm", "cutlass", "sm90_xmma")
             else "copy/cast" if "copy" in kname
             else "reduction" if "reduce" in kname
             else "elementwise" if "elementwise" in kname else "other")
        groups[g] = groups.get(g, 0.0) + ms
    print(f"[trace] {label} by kind: " + ", ".join(
        f"{g} {ms:.2f} ms" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])),
        flush=True)


def to_host(tree):
    """A tree of tensors (dicts, named tuples, None) copied to the host."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_host(t) for t in tree))
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return None if tree is None else tree.to("cpu")


def to_device(tree, device="cuda"):
    """``to_host``'s inverse."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(t, device) for t in tree))
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


def clone_tree(tree):
    """A tree of tensors (dicts, named tuples, None) cloned where it
    lies."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(t) for t in tree))
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def k4_rank_check(tp, cfg):
    """K4's wrapper, ``ops.nvfp4_matmul_tp``, on this rank's tile of each
    acereason-7b site at M = 8 and 256 (runs in a rank's process): held
    against its plain version, ``ref.nvfp4_matmul_tp_ref``, on the same
    inputs at K2's tolerance (one bf16 ulp of the f32 result plus the f32
    summation bound of |x| |W| over what it sums), and the row sites' f32
    result against the full-K plain product at that bound.  Every rank
    draws the same weights and inputs.  One record per (site, M)."""
    import torch

    from repro_torch.core import nvfp4
    from repro_torch.kernels import ops, ref

    dev = tp.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    d, ff, qkv = cfg.d_model, cfg.d_ff, cfg.qkv_dim
    sites = (("wqkv", d, qkv, "column"), ("wo", d, d, "row"),
             ("wg", d, ff, "column"), ("wu", d, ff, "column"),
             ("wd", ff, d, "row"))
    out = []
    for m in (ENGINE["n_slots"], BATCH * PROMPT):
        for wname, k, n, mode in sites:
            x = ops.nvfp4_qdq((torch.randn((m, k), generator=gen, device=dev)
                               * 2.0).to(torch.bfloat16))
            p = ops.pack_weight((torch.randn((k, n), generator=gen, device=dev)
                                 / math.sqrt(k)).to(torch.bfloat16))
            tile = nvfp4.tp_tile(p, mode, tp.rank, tp.size)
            xl = (x if mode == "column"
                  else x.chunk(tp.size, -1)[tp.rank].contiguous())
            y = ops.nvfp4_matmul_tp(xl, tile, tp, mode)
            y32 = ref.nvfp4_matmul_tp_ref(xl, tile, tp, mode, torch.float32)
            # column: this rank's N over the whole K; row: every N over
            # the whole K, summed over the group
            absref = x.float().abs() @ nvfp4.unpack(
                p if mode == "row" else tile, torch.bfloat16).float().abs().T
            one_ulp = torch.exp2(torch.floor(torch.log2(
                y32.abs().clamp_min(1e-30))) - 7)
            diff = (y.float() - y32).abs()
            rec = dict(site=wname, mode=mode, m=m, max_abs_err=float(diff.max()),
                       ok=bool((diff <= one_ulp + 2.0 ** -20 * absref).all()))
            if mode == "row":
                full = ref.nvfp4_matmul_ref(x, p, torch.float32)
                fdiff = (ops.nvfp4_matmul_tp(xl, tile, tp, mode, torch.float32)
                         - full).abs()
                rec.update(full_err=float(fdiff.max()), full_ok=bool(
                    (fdiff <= 2.0 ** -20 * absref).all()))
            out.append(rec)
            del x, p, tile, xl, y, y32, absref, one_ulp, diff
    torch.cuda.synchronize()
    return out


def tp_rank(tp, prompts, n_gen, contexts, moe_prompts, slab_runs):
    """One rank of phase 5d (runs in its own process): K4's wrapper held
    to its plain version (``k4_rank_check``); the seed-0 weights drawn on
    the card with the rank's own generator, only its tiles kept;
    the engine over them; run TP's traffic; one traced decode step on
    rank 0; then phase 5n in the same process: (c) and (d) on the same
    tiles (``tp_rank_spec_shadow``), (a) and (b) on qwen2-moe-a2.7b
    (``tp_moe_rank``); then phase 5o, the slab families
    (``tp_slab_rank``).  Returns host data only."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = configs.get_config("acereason-7b")
    k4_check = k4_rank_check(tp, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, qcfg = serve.load_quantized(cfg, SEED, "packed", tp.device, tp=tp)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 1e9
    eng = Engine(cfg, params, qcfg, device=tp.device, mesh=tp, **ENGINE)
    del params
    report = serve.tp_shard_report(eng)
    pre = prefill_logits(eng)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng.mesh.reset_counts()
    t0 = time.perf_counter()
    rids, out = serve.run_workload(eng, prompts, n_gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    coll = dict(eng.mesh.counts)
    st = eng.stats()
    res = dict(k4_check=k4_check,
               tokens=[out[r] for r in rids], pre=[pre[r].cpu() for r in rids],
               finished=len(out), stats=st, report=report, launches=launches,
               collectives=coll, wall=wall, load_s=load_s, load_peak=load_peak,
               peak=torch.cuda.max_memory_allocated() / 1e9,
               drained=not eng.state.leaked()
               and eng.pool.used_blocks == eng.pool.cached_blocks)
    del pre
    t = trace_filled(eng, prompts, "TP decode step", tp)
    res["trace"] = None if t is None else tp_trace_record(t)
    res.update(tp_rank_spec_shadow(tp, eng, qcfg, contexts))
    # nothing of 5d or 5n (c)/(d) may stay on the card: (a) and (b)
    # measure their own load and run peaks
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res["moe"] = tp_moe_rank(tp, moe_prompts)
    res["slab"] = tp_slab_rank(tp, slab_runs)
    return res


def shadow_host(aux) -> dict:
    """A shadow record as {site/stat: f64 numpy} on the host."""
    import torch
    return {f"{site}/{stat}": v.detach().to("cpu", torch.float64).numpy()
            for site, stats in aux.items() for stat, v in stats.items()}


def tp_rank_spec_shadow(tp, eng, qcfg, contexts) -> dict:
    """Phase 5n (c) and (d) on a rank of 5d, over its engine's tiles
    (``eng.params``), the contexts (run A's shortest prompts) as the
    requests: the plain TP engine and a self-qdq ``SpecEngine`` at k = 2;
    the gather-then-attend attention's rows at the verify's k + 1 queries
    against one query a call, bitwise; the BF16 teacher's tiles drawn leaf
    by leaf, the shadow's record of each context, then an engine with the
    shadow on (its tokens against the plain engine's: the shadow off).
    Host data only."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import attention as mattn
    from repro_torch.models import common
    from repro_torch.serve import Engine
    from repro_torch.spec import SpecEngine

    cfg, dev, out = eng.cfg, tp.device, {}

    prompts = [np.asarray(c, np.int32) for c in contexts]

    def run(e, gen):
        ops.reset_launches()
        e.mesh.reset_counts()
        t0 = time.perf_counter()
        rids, got = serve.run_workload(e, prompts, gen)
        torch.cuda.synchronize()
        return dict(tokens=[got[r] for r in rids], stats=e.stats(),
                    launches=dict(ops.launches), wall=time.perf_counter() - t0,
                    collectives=dict(e.mesh.counts),
                    drained=not e.state.leaked()
                    and e.pool.used_blocks == e.pool.cached_blocks)

    t0 = time.perf_counter()
    out["c_plain"] = run(Engine(cfg, eng.params, qcfg, device=dev, mesh=tp,
                                **ENGINE), RUN_NTP["spec_gen"])
    seng = SpecEngine(cfg, eng.params, qcfg, draft_k=RUN_NTP["spec_k"],
                      draft="self-qdq", device=dev, mesh=tp, **ENGINE)
    out["c_spec"] = run(seng, RUN_NTP["spec_gen"])
    out["c_draft_heads"] = seng.proposer.data["k"].shape[3]
    del seng
    # the two-step attention at the verify's k + 1 queries a row (this
    # rank's heads) against each query alone
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    hkv = cfg.n_kv_heads // tp.size
    h, hd, nb, bs = cfg.n_heads // tp.size, cfg.head_dim, 64, ENGINE["block_size"]
    layer = {n: torch.randn((nb, bs, hkv, hd), generator=gen, device=dev)
             .to(torch.bfloat16) for n in ("k", "v")}
    ns, k1 = ENGINE["n_slots"], RUN_NTP["spec_k"] + 1
    bt = torch.randperm(nb, generator=gen, device=dev)[:ns * 8].reshape(ns, 8)
    lens = torch.randint(1, 8 * bs - k1, (ns,), generator=gen, device=dev)
    q = torch.randn((ns, k1, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    pos = lens[:, None] + torch.arange(1, k1 + 1, device=dev)[None]
    many = mattn.paged_attend(q, layer, bt, pos)
    one = torch.cat([mattn.paged_attend(q[:, i:i + 1], layer, bt, pos[:, i])
                     for i in range(k1)], 1)
    out["c_attn_rows_equal"] = bool(torch.equal(many, one))
    out["c_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    teacher = serve.load_teacher(cfg, SEED, dev, tp=tp)
    torch.cuda.synchronize()
    out["d_teacher_s"] = time.perf_counter() - t0
    out["d_teacher_bytes"] = sum(t.numel() * t.element_size()
                                 for t in common.tree_leaves(teacher))
    out["d_teacher_peak"] = torch.cuda.max_memory_allocated() / 1e9
    sh = Engine(cfg, eng.params, qcfg, device=dev, mesh=tp,
                shadow_teacher=teacher, shadow_rate=RUN_NTP["shadow_rate"],
                **ENGINE)
    del teacher
    ops.reset_launches()
    t1 = time.perf_counter()
    out["d_records"] = [shadow_host(sh.shadow_score(c)) for c in contexts]
    torch.cuda.synchronize()
    out["d_record_s"] = time.perf_counter() - t1
    out["d_record_launches"] = dict(ops.launches)
    out["d_on"] = run(sh, RUN_NTP["spec_gen"])
    out["d_on"]["shadow_steps"], out["d_on"]["shadow_s"] = (sh.shadow_steps,
                                                            sh.shadow_s)
    del sh
    gc.collect()
    torch.cuda.empty_cache()
    out["d_s"] = time.perf_counter() - t0
    out["tokens_equal"] = bool(all(np.array_equal(a, b) for a, b in zip(
        out["d_on"]["tokens"], out["c_plain"]["tokens"])))
    return out


def run_traced(tp, eng, prompts, gen, trace: bool):
    """``serve.run_workload``'s arrivals on a TP engine; with ``trace``,
    the first time every slot decodes, ``trace_steps`` on every rank (rank
    0 traces).  The traced steps stay in the run: its launch and
    collective counts keep them.  Returns (rids, outputs, rank 0's trace
    record or None)."""
    half = len(prompts) // 2
    rids = [eng.submit(p, gen) for p in prompts[:half]]
    for p in prompts[half:]:
        eng.step()
        rids.append(eng.submit(p, gen))
    t, traced = None, not trace
    while eng.sched.has_work():
        if not traced and all_decoding(eng):
            t, traced = trace_steps(eng, "TP MoE decode step", tp), True
        else:
            eng.step()
    if not traced:
        raise RuntimeError("no decode step with every slot busy to trace")
    return rids, eng.drain(), None if t is None else tp_trace_record(t)


def tp_moe_rank(tp, oracle_prompts):
    """Phase 5n (a) and (b) on a rank of 5d: qwen2-moe-a2.7b under
    moe_hybrid at full size, its tiles drawn leaf by leaf, with the
    experts split on E (a: run K's first requests) and then on their FFN
    dim (b: fewer requests and tokens); each run's tokens, prefill logits,
    shard report, launches, collectives and memory; a traced decode step
    of (a) on rank 0 (``run_traced``).  Host data only."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    res = {"resident_gb": torch.cuda.memory_allocated() / 1e9}
    for part, shard, n, gen in (("a", "ep", RUN_KTP["requests"], RUN_KTP["gen"]),
                                ("b", "tp", RUN_KTP["ffn_requests"],
                                 RUN_KTP["ffn_gen"])):
        t_part = time.perf_counter()
        c = dataclasses.replace(configs.get_config(MOE_ARCH),
                                quant_recipe="moe_hybrid", moe_shard=shard)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, qcfg = serve.load_quantized(c, SEED, "packed", tp.device, tp=tp)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        eng = Engine(c, params, qcfg, device=tp.device, mesh=tp, **ENGINE)
        del params
        report = serve.tp_shard_report(eng)
        pre = prefill_logits(eng)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        eng.mesh.reset_counts()
        t0 = time.perf_counter()
        rids, out, trace = run_traced(tp, eng, oracle_prompts[:n], gen,
                                      trace=part == "a")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = dict(tokens=[out[i] for i in rids], pre=[pre[i].cpu() for i in rids],
                 finished=len(out), stats=eng.stats(), report=report,
                 launches=dict(ops.launches), collectives=dict(eng.mesh.counts),
                 wall=wall, load_s=load_s, load_peak=load_peak,
                 peak=torch.cuda.max_memory_allocated() / 1e9,
                 drained=not eng.state.leaked()
                 and eng.pool.used_blocks == eng.pool.cached_blocks,
                 fp8=eng.pool.fp8, fused=eng.fused, n_layers=c.n_layers,
                 trace=trace)
        if part == "a":
            # a planted fault: each rank's experts one place off (expert j
            # computed with expert j + 1's weights), the first requests'
            # prefill logits read as the sound ones are
            feng = Engine(c, roll_experts(eng.params), qcfg, device=tp.device,
                          mesh=tp, **ENGINE)
            fpre = prefill_logits(feng)
            frids, _ = serve.run_workload(
                feng, oracle_prompts[:RUN_KTP["fault_requests"]], 1)
            r["pre_fault"] = [fpre[i].cpu() for i in frids]
            del feng, fpre
        r["seconds"] = time.perf_counter() - t_part
        res[part] = r
        del eng, pre
    gc.collect()
    torch.cuda.empty_cache()
    return res


def roll_experts(params):
    """A parameter tree with every layer's expert stacks (``moe_wg``,
    ``moe_wu``, ``moe_wd``: [L, E, ...], packed or not) rolled by one
    along E; the other leaves shared."""
    import torch

    from repro_torch.core.nvfp4 import PackedNVFP4

    lay = dict(params["layers"])
    for name in ("moe_wg", "moe_wu", "moe_wd"):
        w = lay[name]
        n_e = (w.codes if isinstance(w, PackedNVFP4) else w).shape[1]

        def roll(t):
            if t.ndim < 2 or t.shape[1] != n_e:
                return t
            if t.element_size() == 1:       # no roll on the card for FP8
                return torch.roll(t.view(torch.uint8), 1, 1).view(t.dtype)
            return torch.roll(t, 1, 1)
        lay[name] = (dataclasses.replace(w, codes=roll(w.codes),
                                         scales=roll(w.scales),
                                         tensor_scale=roll(w.tensor_scale))
                     if isinstance(w, PackedNVFP4) else roll(w))
    return {**params, "layers": lay}


def reversed_gather_tp(tp, width: int):
    """A planted fault: ``tp``'s group, whose all-gather of a tensor
    ``width`` wide along the gathered dim returns the ranks' parts in
    reversed rank order (every other collective as it was)."""
    import torch

    from repro_torch.distributed.ctx import TP

    class Reversed(TP):
        def all_gather(self, x, dim=-1):
            out = super().all_gather(x, dim)
            if x.shape[dim] != width:
                return out
            return torch.cat(out.chunk(self.size, dim)[::-1], dim)
    return Reversed(group=tp.group, rank=tp.rank, size=tp.size,
                    device=tp.device)


def local_amax_tp(tp):
    """A planted fault: ``tp``'s group, whose max all-reduce returns each
    rank's own value, so every row-parallel site's NVFP4 activation scale
    comes from the rank's slice alone (every other collective as it was)."""
    from repro_torch.distributed.ctx import TP

    class Local(TP):
        def all_reduce(self, x, op="sum"):
            return x if op == "max" else super().all_reduce(x, op)
    return Local(group=tp.group, rank=tp.rank, size=tp.size, device=tp.device)


def slab_cut_prefills(tp, c, prompts, extras, engine) -> dict:
    """Phase 5o's NVFP4 gate on a rank: ``c`` cut in depth to
    ``TP_SLAB_CUT`` (full width, seed-0 weights) and each prompt's prefill
    logits with NVFP4 activations (the served path) through the slab
    engine: on one device over the whole weights ("one"), at tp = 2 over
    the rank's tiles ("tp"), and at tp = 2 with a planted fault ("fault":
    ``local_amax_tp``).  Host tensors, and the seconds it took."""
    from repro_torch.launch import serve
    from repro_torch.serve import Engine

    t0 = time.perf_counter()
    cc = dataclasses.replace(c, name=f"{c.name}-cut", **TP_SLAB_CUT[c.name])

    def prefills(params_, mesh_, q):
        e = Engine(cc, params_, q, device=tp.device, mesh=mesh_, **engine)
        got = prefill_logits(e)
        ids, _ = serve.run_workload(e, prompts, 1, extras)
        return [got[i].cpu() for i in ids]
    whole, q = serve.load_quantized(cc, SEED, "packed", tp.device)
    out = {"one": prefills(whole, None, q)}
    del whole
    tiles, q = serve.load_quantized(cc, SEED, "packed", tp.device, tp=tp)
    out["tp"] = prefills(tiles, tp, q)
    out["fault"] = prefills(tiles, local_amax_tp(tp), q)
    out["layers"] = cc.n_layers
    out["seconds"] = time.perf_counter() - t0
    return out


def contiguous_cross_qkv(params, full, tp):
    """A planted fault: whisper's tiles ``params`` with the cross-attention's
    ``x_wqkv`` and ``x_bqkv`` cut contiguously from ``full``, as a
    ``FUSED_QKV`` that matched whole names only cut them: the rank's tile
    then holds the wrong heads' rows."""
    from repro_torch.core import nvfp4
    dec = dict(params["dec_layers"])
    for name in ("x_wqkv", "x_bqkv"):
        w = full["dec_layers"][name]
        dec[name] = (nvfp4.tp_tile(w, "column", tp.rank, tp.size)
                     if isinstance(w, nvfp4.PackedNVFP4)
                     else w.chunk(tp.size, -1)[tp.rank].contiguous())
    return {**params, "dec_layers": dec}


def leaf_bytes(specs, path: str = "") -> dict:
    """{tree path: bytes} of a spec tree's leaves (paths as
    ``tp_shard_report``'s ``state_leaves``)."""
    from repro_torch.models import common
    if isinstance(specs, dict):
        return {k: v for name, sp in specs.items()
                for k, v in leaf_bytes(sp, f"{path}.{name}" if path
                                       else name).items()}
    return {path: common.spec_bytes(specs)}


def tp_slab_rank(tp, runs) -> dict:
    """Phase 5o on a rank of 5d, after 5n: the slab families at full size,
    each model's tiles drawn leaf by leaf on the card and freed before the
    next.  ``runs``: part -> arch, prompts, extras, tokens, engine
    geometry, the planted fault ("z": the RG-LRU's post-conv gather in
    reversed rank order, "receptance": RWKV's, "x_wqkv": whisper's
    cross-attention cut contiguously) and a speculative run.  Each run's
    tokens, prefill logits, shard report, the whole state's bytes by leaf,
    launches, collectives, memory and seconds; the fault's prefill logits
    on the first requests; the speculative run's tokens, counts and
    launches.  Host data only."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import Engine
    from repro_torch.spec import SpecEngine

    res = {}
    for part, run in runs.items():
        t_part = time.perf_counter()
        c = configs.get_config(run["arch"])
        prompts, gen_n = run["prompts"], run["gen"]
        extras = run["extras"] or [None] * len(prompts)
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, qcfg = serve.load_quantized(c, SEED, "packed", tp.device, tp=tp)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        eng = Engine(c, params, qcfg, device=tp.device, mesh=tp,
                     **run["engine"])
        del params
        report = serve.tp_shard_report(eng)
        pre = prefill_logits(eng)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        eng.mesh.reset_counts()
        t0 = time.perf_counter()
        rids, out = serve.run_workload(eng, prompts, gen_n, extras)
        torch.cuda.synchronize()
        r = dict(tokens=[out[i] for i in rids], pre=[pre[i].cpu() for i in rids],
                 finished=len(out), stats=eng.stats(), report=report,
                 whole_state=leaf_bytes(eng.state.specs),
                 launches=dict(ops.launches), collectives=dict(eng.mesh.counts),
                 wall=time.perf_counter() - t0, load_s=load_s,
                 load_peak=load_peak, resident=resident,
                 peak=torch.cuda.max_memory_allocated() / 1e9,
                 drained=not eng.state.leaked(), slots=eng.n_slots)
        del pre
        # the first requests' prefill logits again with BF16 activations,
        # and with the planted fault under both activation formats
        n_f = RUN_OTP["fault_requests"]
        bq = dataclasses.replace(qcfg, quantize_activations=False)

        def prefills(params_, mesh_, q):
            e = Engine(c, params_, q, device=tp.device, mesh=mesh_,
                       **run["engine"])
            got = prefill_logits(e)
            ids, _ = serve.run_workload(e, prompts[:n_f], 1, extras[:n_f])
            return [got[i].cpu() for i in ids]
        r["pre_bf16"] = prefills(eng.params, tp, bq)
        if run["fault"] == "x_wqkv":
            full, _ = serve.load_quantized(c, SEED, "packed", tp.device)
            fparams, fmesh = contiguous_cross_qkv(eng.params, full, tp), tp
            del full
        elif run["fault"]:
            width = (c.d_rnn if run["fault"] == "z" else c.d_model) // tp.size
            fparams, fmesh = eng.params, reversed_gather_tp(tp, width)
        if run["fault"]:
            gated = TP_SLAB_TOL[c.family]
            if "nvfp4" in gated:
                r["pre_fault"] = prefills(fparams, fmesh, qcfg)
            r["pre_fault_bf16"] = prefills(fparams, fmesh, bq)
            del fparams
        if c.name in TP_SLAB_CUT:
            r["cut"] = slab_cut_prefills(tp, c, prompts[:n_f], extras[:n_f],
                                         run["engine"])
        if run.get("spec"):
            sp = run["spec"]
            seng = SpecEngine(c, eng.params, qcfg, draft_k=sp["k"],
                              draft="self-qdq", device=tp.device, mesh=tp,
                              **run["engine"])
            ops.reset_launches()
            t0 = time.perf_counter()
            srids, sout = serve.run_workload(seng, prompts[:sp["requests"]],
                                             sp["gen"])
            torch.cuda.synchronize()
            r["spec"] = dict(k=sp["k"], tokens=[sout[i] for i in srids],
                             stats=seng.stats(), launches=dict(ops.launches),
                             wall=time.perf_counter() - t0,
                             drained=not seng.state.leaked())
            del seng
        del eng
        r["seconds"] = time.perf_counter() - t_part
        res[part] = r
    gc.collect()
    torch.cuda.empty_cache()
    return res


def slab_prefill_controls(eng, prompts, extras) -> dict:
    """Phase 5o's one-card control on the first requests: each prompt's
    prefill logits through the static path (which the slab engine's
    prefill equals bitwise) with BF16 activations ("bf16", the oracle of
    5o's BF16 gate).  Host tensors."""
    import numpy as np
    import torch
    q = dataclasses.replace(eng.sq, quantize_activations=False)
    out = []
    n = RUN_OTP["fault_requests"]
    with torch.inference_mode():
        for p, ex in zip(prompts[:n], (extras or [None] * n)[:n]):
            batch = {"tokens": torch.from_numpy(p[None].astype(np.int64))
                     .to(eng.device),
                     **{k: torch.as_tensor(v, device=eng.device)[None]
                        for k, v in (ex or {}).items()}}
            lg, _ = eng.model.prefill(eng.cfg, eng.params, batch, q, None)
            out.append(lg[0, -1].float().cpu())
            del lg
    return {"bf16": out}


def slab_tp_sites(c, n_prefill: int, n_decode: int) -> dict:
    """Launches of K1, K2 and K4 over a tp = 2 slab run of ``n_prefill``
    prefills and ``n_decode`` decode steps on a rank: every quantized site
    a K1; a packed site that splits a K4, one the rules keep whole (RWKV's
    ts_w1 and dec_w1) a K2."""
    from repro_torch.launch import specs
    if c.family == "rglru_hybrid":
        per_rec, per_attn, n_rec, n_attn = rec_sites(c, specs.serve_qconfig(c))
        k1 = (per_rec * n_rec + per_attn * n_attn) * (n_prefill + n_decode)
        return {"nvfp4_qdq": k1, "nvfp4_matmul_tp": k1, "nvfp4_matmul": 0}
    if c.family == "rwkv6":
        n = c.n_layers * (n_prefill + n_decode)
        return {"nvfp4_qdq": 10 * n, "nvfp4_matmul_tp": 8 * n,
                "nvfp4_matmul": 2 * n}
    k1 = family_sites(c) * n_prefill + family_sites(c, True) * n_decode
    return {"nvfp4_qdq": k1, "nvfp4_matmul_tp": k1, "nvfp4_matmul": 0}


def phase_5o(ranks, oracles) -> dict:
    """Phase 5o's lines, then its gates, from 5d's ranks: each slab run
    against its one-card run (E, F, H, I): prefill logits within
    ``TP_SLAB_TOL`` of its family and the planted fault outside it, each
    first token among the one-card logits' top ``TP_FIRST_RANK``; the
    ranks' tokens bitwise equal, the slots drained; the shard report (every
    packed leaf split but those the rules keep whole, each split state
    leaf's bytes half one card's, the whole ones one card's, the state's
    total one card's pool); K1, K2 and K4 launches; the speculative run's
    counts and streams.  Returns rank 0's launches of each run."""
    import numpy as np
    import torch

    from repro_torch import configs

    ranks = [r["slab"] for r in ranks]
    reads, out = {}, {}
    for part, orc in oracles.items():
        r0 = ranks[0][part]
        st, rep = r0["stats"], r0["report"]
        c = configs.get_config(orc["arch"])
        n, gen_n = len(r0["tokens"]), len(r0["tokens"][0])
        n_fwd = n + st["decode_steps"]
        label = f"[engine 5o-{part}]"
        print(f"{label} {c.name} full size, packed, tp={TP_SIZE} (gloo, one "
              f"card), slab plan {'+'.join(orc['plan'])}: {n} requests "
              f"({orc['what']}), gen {gen_n}, {r0['slots']} slots: wall "
              f"{r0['wall']:.2f}s; ttft_p50_ms={st['ttft_p50_s'] * 1e3:.1f} "
              f"decode_step_p50_ms={st['decode_step_p50_s'] * 1e3:.2f} "
              f"decode_tok_s={st['decode_tok_s']:.1f}; collectives "
              f"{r0['collectives']['calls'] / n_fwd:.1f} a forward "
              f"({r0['collectives']['calls']} over {n_fwd} forwards, "
              f"{r0['collectives']['seconds']:.2f}s on the host); state "
              f"{rep['state_bytes_per_slot'] / 2**20:.3f} MiB a slot a rank "
              f"({rep['state_bytes_per_slot_total'] / 2**20:.3f} one card's); "
              f"{r0['seconds']:.1f}s", flush=True)
        for i, rk in enumerate(ranks):
            r = rk[part]
            print(f"{label} rank {i}: {r['resident']:.2f} GB on the card "
                  f"before; load+pack+cut {r['load_s']:.1f}s (peak "
                  f"{r['load_peak']:.2f} GB), peak in the run {r['peak']:.2f} "
                  f"GB, launches {r['launches']}", flush=True)
        leaves = {k: (v["split"], v["bytes"])
                  for k, v in rep["state_leaves"].items()}
        print(f"{label} tp_shard_report (rank 0): "
              f"{ {k: v for k, v in rep.items() if k != 'state_leaves'} }; "
              f"state leaves (split, bytes): {leaves}", flush=True)
        def rels(got, want):
            return [rel_l2(p, q) for p, q in zip(got, want)]

        def first_ranks(got, want):
            """Where the one-card logits rank each of ``got``'s argmaxes."""
            return [int((w.float() > w.float()[int(torch.argmax(g))]).sum())
                    for g, w in zip(got, want)]
        read = {"nvfp4": rels(r0["pre"], orc["pre"]),
                "nvfp4_fault": rels(r0.get("pre_fault", []), orc["pre"]),
                "nvfp4_ranks": first_ranks(r0["pre"], orc["pre"]),
                "nvfp4_fault_ranks": first_ranks(r0.get("pre_fault", []),
                                                 orc["pre"]),
                "bf16": rels(r0["pre_bf16"], orc["bf16"]),
                "bf16_fault": rels(r0.get("pre_fault_bf16", []), orc["bf16"]),
                "bf16_ranks": first_ranks(r0["pre_bf16"], orc["bf16"]),
                "bf16_fault_ranks": first_ranks(r0.get("pre_fault_bf16", []),
                                                orc["bf16"])}
        later = float(np.mean([np.mean(t[1:] == o[1:len(t)]) for t, o in
                               zip(r0["tokens"], orc["tokens"])]))
        tol = TP_SLAB_TOL[c.family]

        def line(kind):
            fault = read[f"{kind}_fault"]
            return (" ".join(f"{x:.4g}" for x in read[kind])
                    + (f"; planted fault ({orc['fault']}), the first "
                       f"{len(fault)} requests: "
                       + " ".join(f"{x:.4g}" for x in fault)
                       + f" (first tokens ranked {read[f'{kind}_fault_ranks']})"
                       if fault else "")
                    + f"; first tokens ranked {read[f'{kind}_ranks']} in the "
                    "one-card logits"
                    + (f" (tolerance {tol[kind]}, ranks below "
                       f"{TP_SLAB_RANK[c.family]})" if kind in tol
                       else " (printed, not gated)"))
        same = sum(int(t[0]) == int(o[0])
                   for t, o in zip(r0["tokens"], orc["tokens"]))
        print(f"{label} prefill logits rel_l2 vs the one-card run, NVFP4 "
              f"activations (the served path): {line('nvfp4')}; first "
              f"tokens equal on {same}/{n}, later tokens at {later:.3f} of "
              "positions (printed)", flush=True)
        print(f"{label} the first {len(read['bf16'])} requests with BF16 "
              f"activations: {line('bf16')}", flush=True)
        if "cut" in r0:
            cut = r0["cut"]
            read["cut"] = rels(cut["tp"], cut["one"])
            read["cut_fault"] = rels(cut["fault"], cut["one"])
            print(f"{label} cut to {cut['layers']} layers (full width), "
                  f"NVFP4 activations, the first {len(cut['tp'])} requests "
                  "against one card on the same cut: "
                  + " ".join(f"{x:.4g}" for x in read["cut"])
                  + "; planted fault (each rank's own amax at the row "
                  "sites): " + " ".join(f"{x:.4g}" for x in read["cut_fault"])
                  + f" (tolerance {TP_CUT_TOL}); {cut['seconds']:.1f}s",
                  flush=True)
        if "spec" in r0:
            sp = r0["spec"]
            ss = sp["stats"]
            print(f"{label} speculative k={sp['k']} self-qdq on "
                  f"{len(sp['tokens'])} requests, gen "
                  f"{len(sp['tokens'][0])}: wall {sp['wall']:.2f}s, "
                  f"acceptance {ss['acceptance_rate']}, drafted "
                  f"{ss['drafted_tokens']}, accepted {ss['accepted_tokens']}, "
                  f"rolled back {ss['rolled_back_tokens']}, verify steps "
                  f"{ss['verify_steps']}; launches {sp['launches']}", flush=True)
        reads[part] = (read, tol)
    for part, orc in oracles.items():
        read, tol = reads[part]
        r0 = ranks[0][part]
        c = configs.get_config(orc["arch"])
        n = len(r0["tokens"])
        want = slab_tp_sites(c, n, r0["stats"]["decode_steps"])
        for i, rk in enumerate(ranks):
            r = rk[part]
            rp, ln = r["report"], r["launches"]
            if (r["finished"] != n or not r["drained"]
                    or any(len(t) != len(r0["tokens"][0]) for t in r["tokens"])):
                fail(f"engine 5o-{part} rank {i}: {r['finished']} of {n} "
                     "finished, or a slot was not released")
            if any(not np.array_equal(a, b) for a, b in zip(r["tokens"],
                                                             r0["tokens"])):
                fail(f"engine 5o-{part}: rank {i}'s tokens differ from rank 0's")
            leaves = rp["state_leaves"]
            split = {k for k, v in leaves.items() if v["split"]}
            if not (rp["packed_sharded"] == rp["packed_total"]
                    - rp["packed_rule_whole"] > 0
                    and set(leaves) - split == orc["whole"]
                    and all(v["bytes"] * (TP_SIZE if v["split"] else 1)
                            == r["whole_state"][k] for k, v in leaves.items())
                    and rp["kv_pool_bytes_total"] == orc["pool_bytes"]):
                fail(f"engine 5o-{part} rank {i}: shard report {rp}, the whole "
                     f"state {r['whole_state']} (the one-card run's "
                     f"{orc['pool_bytes']} B; whole by the rules: "
                     f"{orc['whole']})")
            if any(ln[k] != v for k, v in want.items()) \
                    or ln["nvfp4_matmul_grouped"] or ln["paged_attention"]:
                fail(f"engine 5o-{part} rank {i} launched {ln}, expected "
                     f"{want} over {n} prefills and "
                     f"{r0['stats']['decode_steps']} decode steps, no K3 or K7")
            if "spec" in r:
                sp, ss = r["spec"], r["spec"]["stats"]
                plain = [t[:len(sp["tokens"][0])] for t in r["tokens"]]
                if not (sp["drained"] and ss["drafted_tokens"]
                        == ss["accepted_tokens"] + ss["rolled_back_tokens"] > 0
                        and all(np.array_equal(a, b) for a, b in
                                zip(sp["tokens"], plain))):
                    fail(f"engine 5o-{part} spec rank {i}: {ss}; streams "
                         f"{[t.tolist() for t in sp['tokens']]} against the "
                         f"plain TP engine's {[t.tolist() for t in plain]}")
        for kind, limit in tol.items():
            if max(read[kind]) > limit:
                fail(f"engine 5o-{part}: prefill logits ({kind} activations) "
                     f"{max(read[kind])} from the one-card run's (tolerance "
                     f"{limit})")
            fault = read[f"{kind}_fault"]
            if fault and min(fault) <= limit:
                fail(f"engine 5o-{part}: a planted fault ({kind} activations) "
                     f"reads {min(fault)}, within the tolerance {limit}")
            if max(read[f"{kind}_ranks"]) >= TP_SLAB_RANK[c.family]:
                fail(f"engine 5o-{part}: a first token ({kind} activations) "
                     f"ranks {max(read[f'{kind}_ranks'])} in the one-card "
                     "logits")
        if "cut" in read:
            if (max(read["cut"]) > TP_CUT_TOL
                    or min(read["cut_fault"]) <= TP_CUT_TOL):
                fail(f"engine 5o-{part}: the depth-cut copy's NVFP4 prefill "
                     f"logits {read['cut']} from one card's, the planted "
                     f"fault's {read['cut_fault']} (tolerance {TP_CUT_TOL})")
        out[part] = r0["launches"]
        if "spec" in r0:
            out[f"{part}_spec"] = r0["spec"]["launches"]
    print(f"[engine 5o] the slab families at tp={TP_SIZE}: "
          f"{sum(r['seconds'] for r in ranks[0].values()):.1f}s in the ranks",
          flush=True)
    return out


def shadow_oracle(dev, cfg, params, qcfg, contexts) -> list:
    """Phase 5n (d)'s oracle, in this process on run A's tree: the BF16
    teacher drawn whole, the single-device shadow's record of each
    context; everything freed before the ranks start."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.serve import Engine

    t0 = time.perf_counter()
    teacher = serve.load_teacher(cfg, SEED, dev)
    eng = Engine(cfg, params, qcfg, device=dev, shadow_teacher=teacher,
                 shadow_rate=RUN_NTP["shadow_rate"], **ENGINE)
    recs = [shadow_host(eng.shadow_score(c)) for c in contexts]
    torch.cuda.synchronize()
    print(f"[engine 5n-d] single-device shadow on {len(contexts)} contexts "
          f"of {[len(c) for c in contexts]} tokens (run A's tree, the BF16 "
          f"teacher whole): {time.perf_counter() - t0:.1f}s", flush=True)
    del eng, teacher
    gc.collect()
    torch.cuda.empty_cache()
    return recs


def shadow_compare(mine, want) -> dict:
    """Per-layer SQNR's largest gap (dB) and the live KL's relative gap
    (the mean over the contexts) of TP records against single-device
    ones; the keys must be the same."""
    import numpy as np
    for m, w in zip(mine, want):
        if sorted(m) != sorted(w):
            fail(f"phase 5n (d): the TP shadow's sites {sorted(m)} differ "
                 f"from single-device's {sorted(w)}")
    gaps = [float(np.nanmax(np.abs(m[k] - w[k]))) for m, w in zip(mine, want)
            for k in m if k.endswith("/sqnr_db")]
    kl_m = float(np.mean([float(m["shadow/kl"]) for m in mine]))
    kl_w = float(np.mean([float(w["shadow/kl"]) for w in want]))
    return dict(sqnr_gap=max(gaps), kl=kl_m, kl_single=kl_w,
                kl_rel=abs(kl_m - kl_w) / max(abs(kl_w), 1e-12),
                kls=[float(m["shadow/kl"]) for m in mine],
                kls_single=[float(w["shadow/kl"]) for w in want],
                sites=len(mine[0]))


def phase_5n_spec_shadow(ranks, cfg, single) -> dict:
    """Phase 5n (c) and (d)'s gates and lines from 5d's ranks; returns
    rank 0's launches of each run."""
    import numpy as np
    r0 = ranks[0]
    for i, r in enumerate(ranks):
        pl, sp = r["c_plain"], r["c_spec"]
        st = sp["stats"]
        eq = [np.array_equal(a, b) for a, b in zip(sp["tokens"], pl["tokens"])]
        print(f"[engine 5n-c] rank {i}: self-qdq k={RUN_NTP['spec_k']} at "
              f"tp={TP_SIZE}, {len(sp['tokens'])} requests (run A's "
              f"shortest), {RUN_NTP['spec_gen']} tokens: streams equal the "
              f"plain TP "
              f"engine's {sum(eq)}/{len(eq)}; acceptance "
              f"{st['acceptance_rate']:.3f}, {st['accepted_per_step']:.3f} a "
              f"round, drafted {st['drafted_tokens']} = accepted "
              f"{st['accepted_tokens']} + rolled back "
              f"{st['rolled_back_tokens']}; round p50 "
              f"{st['decode_step_p50_s'] * 1e3:.1f} ms (plain step "
              f"{pl['stats']['decode_step_p50_s'] * 1e3:.1f} ms), ttft p50 "
              f"{st['ttft_p50_s'] * 1e3:.1f} ms, decode "
              f"{st['decode_tok_s']:.1f} tok/s (plain "
              f"{pl['stats']['decode_tok_s']:.1f}); draft pool KV heads "
              f"{r['c_draft_heads']}; the two-step attention's rows at "
              f"{RUN_NTP['spec_k'] + 1} queries equal one query a call: "
              f"{r['c_attn_rows_equal']}; launches {sp['launches']}; "
              f"{r['c_s']:.1f}s", flush=True)
        if not all(eq) or not pl["drained"] or not sp["drained"]:
            fail(f"engine 5n-c rank {i}: speculative streams differ from the "
                 "plain TP engine's, or a pool did not drain")
        if st["acceptance_rate"] != 1.0 or st["drafted_tokens"] != (
                st["accepted_tokens"] + st["rolled_back_tokens"]):
            fail(f"engine 5n-c rank {i}: acceptance {st['acceptance_rate']}, "
                 f"drafted {st['drafted_tokens']}")
        if not r["c_attn_rows_equal"]:
            fail(f"engine 5n-c rank {i}: the gather-then-attend rows differ "
                 "between the verify's queries and one query a call")
        if r["c_draft_heads"] * TP_SIZE != cfg.n_kv_heads:
            fail(f"engine 5n-c rank {i}: the draft pool holds "
                 f"{r['c_draft_heads']} KV heads")
        if any(not np.array_equal(a, b) for a, b in zip(
                sp["tokens"], r0["c_spec"]["tokens"])):
            fail(f"engine 5n-c: rank {i}'s speculative tokens differ from "
                 "rank 0's")
    for i, r in enumerate(ranks):
        for a, b in zip(r["d_records"], r0["d_records"]):
            if sorted(a) != sorted(b) or any(
                    not np.array_equal(a[k], b[k], equal_nan=True) for k in a):
                fail(f"engine 5n-d: rank {i}'s shadow records differ from "
                     "rank 0's")
        if not r["tokens_equal"] or not r["d_on"]["drained"]:
            fail(f"engine 5n-d rank {i}: tokens with the shadow on differ "
                 "from it off, or the pool did not drain")
    cmp = shadow_compare(r0["d_records"], single)
    on, off = r0["d_on"], r0["c_plain"]
    print(f"[engine 5n-d] shadow at tp={TP_SIZE}: teacher tiles "
          f"{r0['d_teacher_bytes'] / 1e9:.2f} GB a rank drawn leaf by leaf in "
          f"{r0['d_teacher_s']:.1f}s (peak {r0['d_teacher_peak']:.2f} GB); "
          f"{len(r0['d_records'])} contexts in {r0['d_record_s']:.2f}s, "
          f"{cmp['sites']} site stats, the same on every rank; SQNR's "
          f"largest gap to single-device {cmp['sqnr_gap']:.3f} dB (gate "
          f"{RUN_NTP['sqnr_db']}), live KL {cmp['kl']:.4f} against "
          f"{cmp['kl_single']:.4f}, rel {cmp['kl_rel']:.4f} (gate "
          f"{RUN_NTP['kl_rel']}); per context {['%.4f' % k for k in cmp['kls']]}"
          f" vs {['%.4f' % k for k in cmp['kls_single']]}", flush=True)
    print(f"[engine 5n-d] shadow rate {RUN_NTP['shadow_rate']}, 5n-c's "
          f"requests and tokens: {on['shadow_steps']} shadow steps, "
          f"{on['shadow_s'] / max(on['shadow_steps'], 1):.2f}s a step; tokens "
          f"equal shadow off (5n-c's plain run) on every rank: "
          f"{all(r['tokens_equal'] for r in ranks)}; decode step p50 on "
          f"{on['stats']['decode_step_p50_s'] * 1e3:.1f} ms, off "
          f"{off['stats']['decode_step_p50_s'] * 1e3:.1f} ms; {r0['d_s']:.1f}s",
          flush=True)
    if cmp["sqnr_gap"] > RUN_NTP["sqnr_db"] or cmp["kl_rel"] > RUN_NTP["kl_rel"]:
        fail(f"engine 5n-d: the TP shadow parts from single-device's: SQNR "
             f"{cmp['sqnr_gap']} dB, live KL rel {cmp['kl_rel']}")
    if on["shadow_steps"] < 1:
        fail("engine 5n-d: the shadow-on run took no shadow step")
    return {"c_plain": r0["c_plain"]["launches"],
            "c_spec": r0["c_spec"]["launches"],
            "d_records": r0["d_record_launches"],
            "d_on": on["launches"]}


def phase_5n_moe(ranks, oracle) -> dict:
    """Phase 5n (a) and (b)'s gates and lines from 5d's ranks (qwen2-moe
    against run K: its prefill logits and pool bytes; the tokens printed),
    PERF.md's TP table; returns rank 0's launches of each run."""
    import numpy as np
    import torch

    ranks = [r["moe"] for r in ranks]
    out = {}
    for part, label in (("a", "experts on E (ep)"),
                        ("b", "experts' FFN dim (tp)")):
        r0 = ranks[0][part]
        st, rep = r0["stats"], r0["report"]
        n, n_layers = len(r0["tokens"]), r0["n_layers"]
        n_fwd = n + st["decode_steps"]
        print(f"[engine 5n-{part}] {MOE_ARCH} full size, moe_hybrid, "
              f"tp={TP_SIZE}, {label}: {n} requests (run K's first), gen "
              f"{len(r0['tokens'][0])}, wall {r0['wall']:.2f}s; "
              f"ttft_p50_ms={st['ttft_p50_s'] * 1e3:.1f} "
              f"decode_step_p50_ms={st['decode_step_p50_s'] * 1e3:.2f} "
              f"decode_step_p95_ms={st['decode_step_p95_s'] * 1e3:.2f} "
              f"decode_tok_s={st['decode_tok_s']:.1f} collectives="
              f"{r0['collectives']['calls']} ({r0['collectives']['seconds']:.2f}"
              f"s on the host) over {n_fwd} forwards; {r0['seconds']:.1f}s",
              flush=True)
        for i, rk in enumerate(ranks):
            r = rk[part]
            print(f"[engine 5n-{part}] rank {i}: {rk['resident_gb']:.2f} GB "
                  f"on the card before; load+pack+cut "
                  f"{r['load_s']:.1f}s (peak {r['load_peak']:.2f} GB), peak in "
                  f"the run {r['peak']:.2f} GB, launches {r['launches']}",
                  flush=True)
        print(f"[engine 5n-{part}] tp_shard_report (rank 0): {rep}", flush=True)
        for i, rk in enumerate(ranks):
            r = rk[part]
            rp, ln = r["report"], r["launches"]
            if r["finished"] != n or not r["drained"] or r["fused"]:
                fail(f"engine 5n-{part} rank {i}: {r['finished']} of {n} "
                     "finished, or the pool did not drain, or the fused tier "
                     "ran")
            if any(not np.array_equal(a, b) for a, b in zip(
                    r["tokens"], r0["tokens"])):
                fail(f"engine 5n-{part}: rank {i}'s tokens differ from rank 0's")
            if not (rp["experts_sharded"] and rp["fp8_scales_sharded"]
                    and rp["kv_sharded"] and r["fp8"]
                    and rp["kv_pool_bytes_per_device"] * TP_SIZE
                    == oracle["pool_bytes"]):
                fail(f"engine 5n-{part} rank {i}: shard report {rp} (run K's "
                     f"pool {oracle['pool_bytes']} B)")
            want = {"nvfp4_qdq": 5 * n_layers * n_fwd,
                    "nvfp4_matmul_tp": 3 * n_layers * n_fwd}
            if any(ln[k] != v for k, v in want.items()) or ln["nvfp4_matmul"] \
                    or ln["nvfp4_matmul_grouped"] or ln["paged_attention"]:
                fail(f"engine 5n-{part} rank {i} launched {ln}, expected "
                     f"{want} (5 K1 and 3 K4 a layer) and no K2, K3 or K7")
        def rel_to(ref, got=None):
            return [float((p.float() - q.float()).norm() / q.float().norm())
                    for p, q in zip(got or r0["pre"], ref)]
        rel, rel_u = rel_to(oracle["pre"]), rel_to(oracle["pre_unfused"])
        tiers = rel_to(oracle["pre_unfused"], oracle["pre"][:n])
        k_first = [int(k[0]) for k in oracle["tokens"][:n]]
        u_first = oracle["first_unfused"][:n]
        mine = [int(t[0]) for t in r0["tokens"]]

        def rank(i, logits):
            """Where the fused-off card's logits rank request i's token."""
            u = oracle["pre_unfused"][i].float()
            return int((u > u[int(torch.argmax(logits))]).sum())
        ranks_tp = [rank(i, p) for i, p in enumerate(r0["pre"])]
        ranks_k = [rank(i, p) for i, p in enumerate(oracle["pre"][:n])]
        later = float(np.mean([np.mean(t[1:] == k[1:len(t)])
                               for t, k in zip(r0["tokens"], oracle["tokens"])]))
        print(f"[engine 5n-{part}] prefill logits rel_l2 vs run K (one card, "
              f"fused tier): " + " ".join(f"{x:.4g}" for x in rel)
              + f"; vs one card with the fused tier off: "
              + " ".join(f"{x:.4g}" for x in rel_u)
              + f" (tolerance {TP_LOGIT_TOL}; the two one-card tiers apart: "
              + " ".join(f"{x:.4g}" for x in tiers) + f"); first tokens: "
              f"run K {k_first}, fused off {u_first}, TP {mine}; where the "
              f"fused-off logits rank TP's {ranks_tp} and run K's {ranks_k} "
              f"(gate: below {TP_FIRST_RANK}); later tokens equal run K's at "
              f"{later:.3f} of positions (printed, not gated)", flush=True)
        if part == "a":
            fault = rel_to(oracle["pre_unfused"], r0["pre_fault"])
            ranks_f = [rank(i, p) for i, p in enumerate(r0["pre_fault"])]
            print(f"[engine 5n-a] planted fault (each rank's experts one place "
                  f"off), the first {len(fault)} requests: prefill logits "
                  f"rel_l2 vs the fused-off card "
                  + " ".join(f"{x:.4g}" for x in fault)
                  + f", first tokens ranked {ranks_f} there; the sound run's "
                  f"largest {max(rel + rel_u):.4g}, the tolerance "
                  f"{TP_LOGIT_TOL} between", flush=True)
            if min(fault) <= TP_LOGIT_TOL:
                fail(f"engine 5n-a: a planted fault reads {min(fault)}, within "
                     f"the tolerance {TP_LOGIT_TOL}")
        if max(rel) > TP_LOGIT_TOL or max(rel_u) > TP_LOGIT_TOL:
            fail(f"engine 5n-{part}: prefill logits {max(rel)} from run K's, "
                 f"{max(rel_u)} from the fused-off card's")
        if max(ranks_tp) >= TP_FIRST_RANK:
            fail(f"engine 5n-{part}: a first token ranks {max(ranks_tp)} in "
                 "the fused-off card's logits")
        out[f"{part}_ep" if part == "a" else f"{part}_tp"] = r0["launches"]
    tr = ranks[0]["a"]["trace"]
    print(f"[trace] 5n-a TP MoE decode step, 8 slots, rank 0 (traced): "
          f"wall_ms={tr['wall_ms']:.3f} device_busy_ms={tr['busy_ms']:.3f} "
          f"idle_share={1 - tr['busy_ms'] / tr['wall_ms']:.3f} "
          f"collective_ms={tr['collective_ms']:.3f} ({tr['collectives']} "
          f"collectives, host-staged); device ops: {tr['n_port']:.0f} of the "
          f"port's kernels ({tr['n_qdq']:.0f} QDQ for {tr['qdq_calls']} QDQ "
          f"calls; trace {tr['attempt']}), {tr['n_other']:.0f} others",
          flush=True)
    if tr["n_qdq"] != tr["qdq_calls"]:
        fail(f"engine 5n-a decode step: {tr['n_qdq']} QDQ kernels for "
             f"{tr['qdq_calls']} QDQ calls")
    for kname, ms in tr["top"]:
        print(f"[trace]   {ms:8.3f} ms  {kname[:110]}")
    print(f"[engine 5n] qwen2-moe at tp={TP_SIZE}: "
          f"{sum(ranks[0][p]['seconds'] for p in ('a', 'b')):.1f}s in the "
          "ranks", flush=True)
    return out


def q_bound(x):
    """The least time of one K1 call on x (ms): its bytes or its operations."""
    from repro_torch.kernels import nvfp4_qdq as kqdq
    return max(kqdq.bytes_moved(x) / HBM_BYTES_S,
               kqdq.OPS_PER_ELEM * x.numel() / F32_FLOPS) * 1e3


def old_call(x, scope):
    """The op as it was called before the amax moved into the kernel:
    ``q_act``'s torch amax (the tensor scope's the wrapper's
    ``vector_norm``), then the kernel given it."""
    import torch

    from repro_torch.kernels import nvfp4_qdq as kqdq
    from repro_torch.kernels import ops
    amax = (torch.linalg.vector_norm(x, ord=float("inf")).float()
            if scope == "tensor" else kqdq.scope_amax(x, scope))
    return ops.nvfp4_qdq(x, amax)


def qdq_equal(got, want):
    """Bitwise equal, NaNs where the other has them."""
    import torch
    gn, wn = torch.isnan(got), torch.isnan(want)
    return bool(torch.equal(gn, wn)) and bool(torch.equal(
        got[~gn].view(torch.int16 if got.dtype == torch.bfloat16
                      else torch.int32),
        want[~wn].view(torch.int16 if want.dtype == torch.bfloat16
                       else torch.int32)))


def first_decode_logits(eng):
    """Record each request's logits at its first decode step."""
    got, inner = {}, eng.state.decode

    def decode(reqs, toks, lens, active):
        logits = inner(reqs, toks, lens, active)
        for r in reqs:
            if len(r.output) == 1:
                got[r.rid] = logits[r.slot, 0].clone()
        return logits
    eng.state.decode = decode
    return got


def prefill_logits(eng_, force=None):
    """Record each request's prefill logits; with ``force`` (prompt
    bytes -> token), emit that first token instead of the sampled one."""
    got, inner = {}, eng_._sample_one

    def sample_one(req, logits):
        got[req.rid] = logits[0].float().clone()
        tok = inner(req, logits)
        return tok if force is None else force[req.prompt.tobytes()]
    eng_._sample_one = sample_one
    return got


def trace_slab_step(eng, prompts, label, extras=None):
    """Fill every slot, then trace one engine step (a decode step and
    nothing else) and print it: wall and busy ms, the idle share,
    device ops and time by kind.  ``extras``: each prompt's extras."""
    t = trace_filled(eng, prompts, f"{label} decode step", extras=extras)
    by_kernel, n_port, n_qdq, n_other, wall_ms, launches = (
        t["by_kernel"], t["n_port"], t["n_qdq"], t["n_other"], t["wall_ms"],
        t["launches"])
    busy_ms = sum(by_kernel.values())
    print(f"[trace] {label} decode step, {eng.n_slots} slots (traced): "
          f"wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
          f"idle_share={1 - busy_ms / wall_ms:.3f}; device ops: "
          f"{n_port:.0f} of the port's kernels ({n_qdq:.0f} QDQ for "
          f"{launches['nvfp4_qdq']} QDQ calls), {n_other:.0f} others",
          flush=True)
    print_by_kind(f"{label} decode step", by_kernel)
    for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[trace]   {ms:8.3f} ms  {kname[:110]}")


def slab_drained(eng, what):
    if eng.state.leaked() or eng.stats()["used_slots"]:
        fail(f"engine {what}: a state slot was not released")

# ---------------------------------------------------------------------------
# the last model families: rwkv6-3b and whisper-tiny on the slab engine,
# qwen2-vl-2b's M-RoPE (phases 3i, 4, 5h-5j, 6f, 6g)
# ---------------------------------------------------------------------------


def params_to(tree, device):
    """A parameter tree of dense and packed leaves, copied to ``device``."""
    from repro_torch.core import nvfp4
    from repro_torch.models import common
    return common.tree_map(
        lambda t: (nvfp4.PackedNVFP4(t.codes.to(device), t.scales.to(device),
                                     t.tensor_scale.to(device), t.orig_k)
                   if isinstance(t, nvfp4.PackedNVFP4) else t.to(device)),
        tree)


def family_sites(cfg, decode: bool = False) -> int:
    """Quantized GEMM sites of one forward under the "all" recipe, each a
    K1 launch on its input and, packed, a K2 launch: an rwkv6 layer's
    ts_w1, wr, wk, wv, wg, dec_w1, wo and the channel mix's three; a
    whisper encoder layer's wqkv, wo, wi, wd and a decoder layer's those,
    x_wqkv twice (the queries, the encoder output's KV) and x_wo (a
    decode step runs the decoder alone); a decoder layer's wqkv, wo, wg,
    wu, wd (``models/``)."""
    if cfg.family == "rwkv6":
        return 10 * cfg.n_layers
    if cfg.family == "encdec":
        return 7 * cfg.n_layers + (0 if decode else 4 * cfg.n_enc_layers)
    return 5 * cfg.n_layers


def rec_sites(c, qc):
    """Quantized GEMM sites of one rglru_hybrid forward: (per recurrent
    layer, per attention layer, recurrent layers, attention layers).  A
    recurrent layer runs wx, wgate, w_a, w_i, wo and the MLP's three; an
    attention layer its MLP, and wqkv and wo unless the recipe keeps
    attention in BF16 (``models/rglru.py``)."""
    from repro_torch.models import rglru
    n_sb, n_rec, n_rem = rglru._counts(c)
    per_rec = 8 if qc.quantizes("recurrent") else 3
    per_attn = 3 + (2 if qc.quantizes("attn") else 0)
    return per_rec, per_attn, n_sb * n_rec + n_rem, n_sb


def vlm_pos3(n: int, start: int, side: int):
    """Qwen2-VL's (t, h, w) position ids [n, 3] for ``n`` tokens with a
    ``side`` x ``side`` patch grid at ``start``: text before it at
    t = h = w = i, the grid at t = start, h = start + row, w = start +
    column, text after it from the largest position + 1 on."""
    import numpy as np
    pos = np.zeros((n, 3), np.int64)
    pos[:start] = np.arange(start)[:, None]
    g = np.arange(side * side)
    pos[start:start + g.size] = np.stack(
        [np.full(g.size, start), start + g // side, start + g % side], 1)
    pos[start + g.size:] = (np.arange(n - start - g.size)
                            + start + side)[:, None]
    return pos


def vlm_batch(cfg, b: int, n: int, start: int, side: int, gen, device):
    """``b`` sequences of ``n`` seeded tokens, each with a ``side`` x
    ``side`` patch grid at ``start``: ``vis_embeds`` drawn from ``gen``
    (the vision frontend is a stub), ``vis_mask`` over the grid and
    ``pos3`` in Qwen2-VL's layout.  Test inputs, built here."""
    import torch
    mask = torch.zeros((b, n), dtype=torch.bool, device=device)
    mask[:, start:start + side * side] = True
    return {"tokens": torch.randint(4, cfg.vocab_size, (b, n), generator=gen,
                                    device=device),
            "vis_mask": mask,
            "vis_embeds": torch.randn((b, n, cfg.d_model), generator=gen,
                                      device=device),
            "pos3": torch.from_numpy(vlm_pos3(n, start, side)).to(device)
            .expand(b, n, 3)}


def rel_l2(got, want) -> float:
    """Relative L2 distance of ``got`` from ``want``."""
    return float((got.float() - want.float()).norm() / want.float().norm())


def ulp(x, mant_bits):
    """One unit in the last place of |x| for ``mant_bits`` mantissa bits
    (7: bf16, 23: f32), normals only."""
    import torch
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - mant_bits)


def phase_3i(dev, gen, rows, err, err_bound):
    """K1 and K2 at the shapes of rwkv6-3b, whisper-tiny and qwen2-vl-2b
    against their plain versions: K2 within its bound at each site's M,
    the largest M's first 8 rows bitwise the M = 8 product's; K1 in row
    scope at [8, 1, K] bitwise.  The rwkv6 sites at M = 8 and whisper's
    cross-KV site at M = 12000 join phase 7's timings."""
    import torch

    from repro_torch import configs
    from repro_torch.core import nvfp4
    from repro_torch.kernels import nvfp4_matmul as kmm
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    rw, wh, vl = (configs.get_config(a) for a in (RWKV["arch"], WHISPER["arch"],
                                                 QWEN_VL["arch"]))
    n_slots = ENGINE["n_slots"]
    d, ff = rw.d_model, rw.d_ff
    cross_m = n_slots * wh.enc_seq
    # (arch, site, K, N, Ms): the decay LoRA's N = 64 and the token shift's
    # N = 160 sit below one 128-row weight tile
    sites = [(rw, "dec_w1", d, 64, (n_slots, 512)),
             (rw, "ts_w1", d, 160, (n_slots, 512)),
             (rw, "wr", d, d, (n_slots, 512)),
             (rw, "cm_wk", d, ff, (n_slots, 512)),
             (rw, "cm_wv", ff, d, (n_slots, 512)),
             (wh, "x_wqkv (cross-KV)", wh.d_model, wh.qkv_dim,
              (n_slots, cross_m)),
             (wh, "wd", wh.d_ff, wh.d_model, (n_slots, 512)),
             (vl, "wqkv", vl.d_model, vl.qkv_dim, (n_slots, 512)),
             (vl, "wd", vl.d_ff, vl.d_model, (n_slots, 512))]
    for c, wname, k, n, ms in sites:
        x = (torch.randn((ms[-1], k), generator=gen, device=dev) * 2.0
             ).to(torch.bfloat16)
        xq = ops.nvfp4_qdq(x, scope="row")
        p = ops.pack_weight((torch.randn((k, n), generator=gen, device=dev)
                             / math.sqrt(k)).to(torch.bfloat16))
        wdq = nvfp4.unpack(p, torch.bfloat16)
        for m in ms:
            y = ops.nvfp4_matmul(xq[:m], p)
            y32 = ref.nvfp4_matmul_ref(xq[:m], p, torch.float32)
            absref = xq[:m].float().abs() @ wdq.float().abs().T
            one_ulp = torch.exp2(torch.floor(torch.log2(
                y32.abs().clamp_min(1e-30))) - 7)
            diff = (y.float() - y32).abs()
            ratio = float((diff / (one_ulp + 2.0 ** -20 * absref)).max())
            if ratio > 1.0:
                fail(f"nvfp4_matmul at {c.name} {wname} (K={k}, N={n}) outside "
                     f"tolerance at M={m}: err/bound {ratio}")
            err["nvfp4_matmul"] = max(err["nvfp4_matmul"], float(diff.max()))
            err_bound["nvfp4_matmul"] = max(err_bound["nvfp4_matmul"], ratio)
            print(f"[kernel] nvfp4_matmul {c.name} {wname} M={m} (K={k}, N={n}): "
                  f"max err/bound {ratio:.4f}", flush=True)
            del y, y32, absref, one_ulp
        if not torch.equal(ops.nvfp4_matmul(xq, p)[:n_slots].view(torch.int16),
                           ops.nvfp4_matmul(xq[:n_slots], p).view(torch.int16)):
            fail(f"nvfp4_matmul rows of {c.name} {wname} differ between "
                 f"M={ms[-1]} and M={n_slots}")
        timed_m = (n_slots if c is rw else cross_m if wname.startswith("x_")
                   else None)
        if timed_m:
            xt = xq[:timed_m]
            bts, fl = kmm.bytes_moved(xt, p, torch.bfloat16), kmm.flops(xt, p)
            rows["nvfp4_matmul"].append(dict(
                m=timed_m, k=k, n=n, site=f"{c.name} {wname}", phase=c.name,
                bound_ms=max(bts / HBM_BYTES_S, fl / BF16_FLOPS) * 1e3,
                bound_by=("bytes" if bts / HBM_BYTES_S >= fl / BF16_FLOPS
                          else "operations"),
                max_abs_err=float(diff.max()),
                fns=((lambda xt=xt, p=p: ops.nvfp4_matmul(xt, p)),
                     (lambda xt=xt, p=p: ref.nvfp4_matmul_ref(xt, p)),
                     (lambda xt=xt, w=wdq.T: torch.matmul(xt, w)))))
        del x, xq, diff
    for k in (d, ff, wh.d_model, wh.d_ff):
        x = (torch.randn((n_slots, 1, k), generator=gen, device=dev) * 3.0
             ).to(torch.bfloat16)
        if not qdq_equal(ops.nvfp4_qdq(x, scope="row"),
                         ref.nvfp4_qdq_ref(x, None, "row")):
            fail(f"nvfp4_qdq row scope not bitwise at [{n_slots}, 1, {k}]")
    print(f"[kernel] 3i, the slab families' shapes: nvfp4_matmul within its "
          f"bound at {len(sites)} sites (rwkv6 N = 64 and 160 below one "
          f"128-row weight tile; whisper's cross-KV at M = {cross_m}), rows "
          f"bitwise equal across M; nvfp4_qdq row scope bitwise at "
          f"[{n_slots}, 1, K] for K in ({d}, {ff}, {wh.d_model}, {wh.d_ff}) "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)


# ---------------------------------------------------------------------------
# FP8 KV and speculative decoding (phases 3k, 3l, 5k, 5l)
# ---------------------------------------------------------------------------


def fp8_tie_rows(n_amax: int = 64):
    """Rows [amax, x] (bf16 values, f32) on which x / scale and
    x * (1 / scale) round to different E4M3 values: the rounding ties and
    near-ties a division form must get right.  Test inputs, built here."""
    import numpy as np
    import torch
    allb = torch.arange(0, 0x7F80, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).float()
    rng = np.random.default_rng(SEED)
    pos = allb[allb > 1e-3]
    out = []
    inv = float(np.float32(1.0) / np.float32(448.0))
    for a in pos[torch.from_numpy(rng.choice(len(pos), n_amax))]:
        s = a * inv
        xs = allb[allb <= a]
        d = (xs / s).to(torch.float8_e4m3fn).view(torch.uint8)
        r = (xs * (1.0 / s)).to(torch.float8_e4m3fn).view(torch.uint8)
        for x in xs[d != r][:4]:
            out.append([float(a), float(x)])
    return torch.tensor(out, dtype=torch.float32).to(torch.bfloat16)


def phase_3k(dev, gen, rows, err):
    """K7 at the speculative verify's shape (8 slots, S_q = 5, acereason-7b's
    28/4 heads of 128, per-query positions across block and part
    boundaries): within K7_ATOL of its plain version, and each query's
    rows bitwise equal to a one-query call at the same position (greedy
    speculative parity on the paged path rests on it); K7 on FP8 pages at
    qwen2-moe-a2.7b's 16/16 heads of 128 (the moe_hybrid recipe's pool),
    at decode, at S_q = 3 (verify at k = 2, rows bitwise as above) and at
    a 16-query chunk; ``core.nvfp4.fp8_quantize`` on the card bitwise the
    CPU's, E4M3 ties included.  The verify and FP8 decode calls join
    phase 7's timings."""
    import torch

    from repro_torch import configs
    from repro_torch.core import nvfp4
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models import attention as attn
    t0 = time.perf_counter()
    ace, moe = configs.get_config("acereason-7b"), configs.get_config(MOE_ARCH)
    ns, blk, mbs, n_blk = (ENGINE["n_slots"], ENGINE["block_size"],
                           ENGINE["max_blocks_per_slot"], ENGINE["n_blocks"])

    def case(c, b, pos, fp8):
        """Random pages (bf16, or FP8 through the engine's ``_quant_kv``),
        tables of distinct blocks, queries [b, S, H, hd]."""
        shape = (n_blk, blk, c.n_kv_heads, c.head_dim)
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        if fp8:
            (kq, ks), (vq, vs) = attn._quant_kv(k), attn._quant_kv(v)
            pool = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            pool = {"k": k, "v": v}
        bt = torch.randperm(n_blk, generator=gen, device=dev)[: b * mbs]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        s_q = 1 if pos.ndim == 1 else pos.shape[1]
        q = torch.randn((b, s_q, c.n_heads, c.head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
        return q, pool, bt.reshape(b, mbs).to(torch.int32), pos

    def check(what, q, pool, bt, pos):
        got = ops.paged_attention(q, pool, bt, pos)
        want = ref.paged_attention_ref(q, pool, bt, pos).float()
        d = (got.float() - want).abs()
        if not bool((d <= ulp(torch.maximum(got.float().abs(), want.abs()), 7)
                     + K7_ATOL).all()):
            fail(f"paged_attention outside tolerance ({what}): max abs err "
                 f"{float(d.max())}")
        err["paged_attention"] = max(err["paged_attention"], float(d.max()))
        return got

    def rows_bitwise(what, q, pool, bt, pos, got):
        for i in range(q.shape[1]):
            one = ops.paged_attention(q[:, i:i + 1], pool, bt, pos[:, i])
            if not torch.equal(got[:, i].view(torch.int16),
                               one[:, 0].view(torch.int16)):
                bad = (got[:, i] != one[:, 0]).reshape(got.shape[0], -1).any(1)
                fail(f"paged_attention {what}: query {i}'s rows differ from a "
                     f"one-query call at its position (slots "
                     f"{bad.nonzero().flatten().tolist()}, pos "
                     f"{pos[:, i].tolist()})")

    # lens so that the k + 1 positions straddle block boundaries (16) and
    # the parts' boundaries (96 keys a part at 544 keys, 6 parts)
    lens = [12, 93, 189, 285, 380, 475, 531, 539]
    for c, k1, fp8, label in ((ace, 5, False, "verify"),
                              (moe, 3, True, "verify_fp8")):
        pos = torch.tensor(lens)[:, None] + torch.arange(1, k1 + 1)[None, :]
        cs = case(c, ns, pos, fp8)
        got = check(f"{label}, S_q = {k1}", *cs)
        rows_bitwise(f"{label}, S_q = {k1}", *cs, got)
        if label == "verify":
            q, pool, bt, pos_ = cs
            kb = kpa.bytes_moved(q, pool["k"], bt, pos_, fp8=False)
            kf = kpa.flops(q, pool["k"], bt, pos_)
            rows["paged_attention"].append(dict(
                site="verify", shape=f"q {list(q.shape)} pages "
                f"{list(pool['k'].shape)} tables {list(bt.shape)}",
                library_ms=None,
                bound_ms=max(kb / HBM_BYTES_S, kf / BF16_FLOPS) * 1e3,
                bound_by=("bytes" if kb / HBM_BYTES_S >= kf / BF16_FLOPS
                          else "operations"),
                fns=((lambda c_=cs: ops.paged_attention(*c_)),
                     (lambda c_=cs: ref.paged_attention_ref(*c_)), None)))
    dec_pos = torch.linspace(1, mbs * blk, ns).round().int()
    cs = case(moe, ns, dec_pos, True)
    check("FP8 pages at 16/16 x 128, decode", *cs)
    q, pool, bt, pos_ = cs
    kb = kpa.bytes_moved(q, pool["k"], bt, pos_, fp8=True)
    kf = kpa.flops(q, pool["k"], bt, pos_)
    rows["paged_attention"].append(dict(
        site="decode_fp8", shape=f"q {list(q.shape)} e4m3 pages "
        f"{list(pool['k'].shape)} tables {list(bt.shape)}", library_ms=None,
        bound_ms=max(kb / HBM_BYTES_S, kf / BF16_FLOPS) * 1e3,
        bound_by="bytes" if kb / HBM_BYTES_S >= kf / BF16_FLOPS else "operations",
        fns=((lambda c_=cs: ops.paged_attention(*c_)),
             (lambda c_=cs: ref.paged_attention_ref(*c_)), None)))
    check("FP8 pages at 16/16 x 128, a 16-query chunk",
          *case(moe, 1, (256 + torch.arange(1, blk + 1)).reshape(1, blk), True))
    # fp8_quantize: the card's bytes and scales against the CPU's
    x = torch.cat([
        (torch.randn((64, 128), generator=torch.Generator().manual_seed(SEED))
         * 3.0).to(torch.bfloat16),
        torch.zeros((1, 128), dtype=torch.bfloat16)], 0)
    ties = fp8_tie_rows()
    for xx in (x, ties):
        a, b = nvfp4.fp8_quantize(xx), nvfp4.fp8_quantize(xx.to(dev))
        if not (torch.equal(a.values.view(torch.uint8),
                            b.values.cpu().view(torch.uint8))
                and torch.equal(a.scale, b.scale.cpu())):
            fail(f"fp8_quantize on the card differs from the CPU's "
                 f"({tuple(xx.shape)})")
    print(f"[kernel] 3k, paged_attention at the verify shape (8 slots, S_q = 5, "
          f"{ace.n_heads}/{ace.n_kv_heads} x {ace.head_dim}): within "
          f"tolerance, every query's rows bitwise a one-query call's; FP8 pages "
          f"at {moe.n_heads}/{moe.n_kv_heads} x {moe.head_dim}: decode, S_q = 3 "
          f"(rows bitwise as well), a 16-query chunk within tolerance; "
          f"fp8_quantize bitwise the CPU's on 65 rows and {len(ties)} E4M3 "
          f"near-tie rows ({time.perf_counter() - t0:.1f}s)", flush=True)


# (arch, site, K, N) of the BF16 GEMMs a decode step runs (``layers.
# _matmul``): every config's lm_head (tied: the embedding), and the hybrid
# and moe_hybrid recipes' BF16 attention projections
def bf16_sites():
    from repro_torch import configs
    out = []
    for arch in ("acereason-7b", MOE_ARCH, NEMO_ARCH, RGEMMA["arch"],
                 RWKV["arch"], WHISPER["arch"], QWEN_VL["arch"]):
        c = configs.get_config(arch)
        out.append((arch, "lm_head", c.d_model, c.vocab_size))
        if arch in (MOE_ARCH, NEMO_ARCH, RGEMMA["arch"]):
            out.append((arch, "wqkv", c.d_model, c.qkv_dim))
            out.append((arch, "wo", c.n_heads * c.head_dim, c.d_model))
        if arch == MOE_ARCH:
            out.append((arch, "router", c.d_model, c.n_experts))
            out.append((arch, "sh_gate", c.d_model, 1))
    return out


def phase_3l(dev, gen) -> dict:
    """Whether a row's result depends on how many rows share the call, on
    the card: each dense-GEMM site (``layers._matmul``, whose rows are
    padded to a multiple of ``layers.MIN_ROWS``) and each norm width
    (``layers.row_mean``) at M = 1, 4, 8, 24 and 40 (one slot,
    recurrentgemma's 4 slots, 8 slots, 8 slots x (k + 1) at k = 2 and 4)
    against the same rows computed one at a time, bitwise, over 3 draws:
    gated; the plain ``torch.matmul`` and ``torch.mean`` beside them,
    printed.  Returns {(arch, site): {M: equal}} of the port's calls."""
    import torch

    from repro_torch.models import layers
    t0 = time.perf_counter()
    ms = (1, 4, 8, 24, 40)

    def invariant(fn, x):
        one = torch.cat([fn(x[i:i + 1]) for i in range(x.shape[0])])
        return {m: bool(torch.equal(fn(x[:m]), one[:m])) for m in ms}

    def draws(k, fn_of_w, n_draws=3):
        out = {m: True for m in ms}
        for _ in range(n_draws):
            x = (torch.randn((40, k), generator=gen, device=dev) * 2.0
                 ).to(torch.bfloat16)
            for m, e in invariant(fn_of_w, x).items():
                out[m] = out[m] and e
        return out

    res, raw = {}, {}
    for arch, site, k, n in bf16_sites():
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
             ).to(torch.bfloat16)
        res[(arch, site)] = draws(k, lambda x: layers._matmul(x, w))
        raw[(arch, site)] = draws(k, lambda x: torch.matmul(x, w))
        del w
    for d in sorted({k for _, _, k, _ in bf16_sites()}):
        res[("row_mean", f"d={d}")] = draws(
            d, lambda x: layers.row_mean(x.float() ** 2))
        raw[("row_mean", f"d={d}")] = draws(
            d, lambda x: torch.mean(x.float() ** 2, -1, keepdim=True))
    # the slab decode's attention at recurrentgemma-2b's shapes (4 slots
    # against a ring of its window): its products one row a call
    # (``attention._per_row``), and the batched einsum they replaced
    from repro_torch import configs
    from repro_torch.models import attention as mattn
    rc = configs.get_config(RGEMMA["arch"])
    shape = (4, rc.window, rc.n_kv_heads, rc.head_dim)
    cache = {k: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
             for k in ("k", "v")}
    q = torch.randn((4, 1, rc.n_heads, rc.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = torch.tensor([2100, 2300, 2500, 2600], device=dev)
    one = torch.cat([mattn.decode_attend(
        q[i:i + 1], {k: v[i:i + 1] for k, v in cache.items()}, pos[i:i + 1],
        window=rc.window) for i in range(4)])
    att = bool(torch.equal(mattn.decode_attend(q, cache, pos, window=rc.window),
                           one))
    kf = mattn.repeat_kv(cache["k"], rc.n_heads // rc.n_kv_heads).float()
    s4 = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)
    s1 = torch.cat([torch.einsum("bqhd,bkhd->bhqk", q[i:i + 1].float(),
                                 kf[i:i + 1]) for i in range(4)])
    res[("decode_attend", RGEMMA["arch"])] = {4: att}
    raw[("decode_attend", RGEMMA["arch"])] = {4: bool(torch.equal(s4, s1))}
    for key, eq in res.items():
        print(f"[rows] {key[0]} {key[1]}: rows at M = "
              + ", ".join(f"{m} {'==' if e else '!='}" for m, e in eq.items())
              + " the rows computed one at a time (the port's call); plain "
              + ("torch.matmul" if key[0] not in ("row_mean", "decode_attend")
                 else "torch.mean" if key[0] == "row_mean"
                 else "batched einsum")
              + ": " + ", ".join(f"{m} {'==' if e else '!='}"
                                 for m, e in raw[key].items()), flush=True)
    bad = [key for key, eq in res.items() if not all(eq.values())]
    if bad:
        fail(f"rows depend on the number of rows that share the call: {bad}")
    print(f"[rows] dense GEMM, norm and slab attention rows do not depend on M "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return res


def spec_run(label, eng, prompts, gen, want):
    """Drive ``eng`` (a ``SpecEngine``) over run A's arrivals: every request
    finishes, the pool (and its draft mirror, which shares its block ids)
    drains, drafted = accepted + rolled back, and each greedy stream
    equals ``want`` (the plain engine's on the same requests) token for
    token when ``want`` is given.  Returns (stats, launches, outputs)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launches()
    t0 = time.perf_counter()
    rids, out = serve.run_workload(eng, prompts, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = eng.stats()
    outs = [out.get(r, np.empty(0, np.int32)) for r in rids]
    if len(out) != len(prompts) or any(len(o) != gen for o in outs):
        fail(f"engine {label}: {len(out)} of {len(prompts)} requests finished")
    if eng.state.leaked() or (eng.pool is not None
                              and eng.pool.used_blocks != eng.pool.cached_blocks):
        fail(f"engine {label}: the pool or a state slot did not drain")
    if st["drafted_tokens"] != st["accepted_tokens"] + st["rolled_back_tokens"]:
        fail(f"engine {label}: drafted {st['drafted_tokens']} != accepted "
             f"{st['accepted_tokens']} + rolled back {st['rolled_back_tokens']}")
    eq = None
    if want is not None:
        eq = [bool(np.array_equal(o, w)) for o, w in zip(outs, want)]
    acc = st["acceptance_rate"]
    print(f"[engine {label}] speculative k={eng.spec_k} draft "
          f"{eng.draft_mode}: wall {wall:.2f}s, verify steps "
          f"{st['verify_steps']}, acceptance "
          f"{acc if acc is None else round(acc, 4)}, accepted/step "
          f"{st['accepted_per_step']:.3f}, drafted {st['drafted_tokens']}, "
          f"rolled back {st['rolled_back_tokens']}; ttft_p50_ms="
          f"{st['ttft_p50_s']*1e3:.1f} decode_step_p50_ms="
          f"{st['decode_step_p50_s']*1e3:.2f} decode_tok_s="
          f"{st['decode_tok_s']:.1f} e2e_tok_s={st['e2e_tok_s']:.1f}; draft "
          f"state {st['draft_pool_bytes'] / 1e9:.3f} GB"
          + ("" if eq is None else f"; streams equal to the plain engine's "
             f"on {sum(eq)}/{len(eq)} requests")
          + f"; launches {launches}", flush=True)
    return st, launches, outs, eq, rids


def phase_5l_ace(dev, cfg, params, qcfg, prompts, want, st_a) -> dict:
    """Speculative decoding on acereason-7b (run A's loads, traffic and
    streams): a self-qdq draft at k = 4, self-truncate at 14 layers, and a
    two-model draft of 2 layers (a fresh QDQ model from seed 99); each
    run's greedy streams gated token for token against run A's (the plain
    engine on the same requests).  Returns each run's launches."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.spec import SpecEngine
    t0 = time.perf_counter()
    out = {}
    dcfg = dataclasses.replace(cfg, n_layers=SPEC["two_model_layers"],
                               name=f"{cfg.name}-2m")
    dparams, dqcfg = serve.load_quantized(dcfg, 99, "qdq", dev)
    for name, kw in (("self-qdq", dict(draft="self-qdq")),
                     ("self-truncate", dict(draft="self-truncate",
                                            draft_layers=SPEC["truncate_layers"])),
                     ("two-model", dict(draft_model=(dcfg, dparams, dqcfg)))):
        eng = SpecEngine(cfg, params, qcfg, draft_k=SPEC["k"], device=dev,
                         **kw, **ENGINE)
        st, launches, _, eq, _ = spec_run(
            f"L {name}", eng, prompts[:SPEC["requests"]], SPEC["gen"],
            [w[:SPEC["gen"]] for w in want[:SPEC["requests"]]])
        if not all(eq):
            fail(f"engine L {name}: greedy streams differ from the plain "
                 f"engine's on {eq.count(False)} requests")
        if launches["paged_attention"] == 0:
            fail(f"engine L {name} never launched paged_attention")
        out[name] = launches
        del eng
    print(f"[engine L] acereason-7b speculative: every draft's streams equal "
          f"run A's token for token (run A: decode_step_p50_ms="
          f"{st_a['decode_step_p50_s']*1e3:.2f} decode_tok_s="
          f"{st_a['decode_tok_s']:.1f}); {time.perf_counter() - t0:.1f}s",
          flush=True)
    del dparams
    return out


def obs_artifacts_ok(eng, label, expect_spec=False, expect_cache=False):
    """An instrumented engine's snapshot, its Prometheus text and (with a
    tracer) its trace through ``obs.validate``; every request lane opens
    ``request`` then ``queue`` and closes ``request``.  Returns the
    snapshot."""
    from repro_torch.obs import export, validate
    snap = export.metrics_snapshot(eng)
    errs = validate.check_metrics(snap, expect_spec, expect_cache)
    errs += validate.check_prometheus(export.to_prometheus(snap,
                                                           eng.obs.metrics))
    if eng.obs.trace.enabled:
        doc = eng.obs.trace.to_chrome()
        errs += validate.check_trace(doc, expect_spec, expect_cache)
        lanes = {}
        for e in doc["traceEvents"]:
            if e["ph"] in "BEi" and e["tid"]:
                lanes.setdefault(e["tid"], []).append((e["ph"], e["name"]))
        errs += [f"lane {tid}: {ev[:2]} ... {ev[-1]}"
                 for tid, ev in sorted(lanes.items())
                 if ev[:2] != [("B", "request"), ("B", "queue")]
                 or ev[-1] != ("E", "request")]
    if errs:
        fail(f"engine {label}: telemetry artifacts invalid: {errs[:5]}")
    return snap


def dispatch_equals_launches(eng, launches, label) -> dict:
    """Gate: each ``kernel_dispatch_total{kernel}`` equals the launches
    ``ops`` counted over the engine's own steps, and
    ``qeinsum_dispatch_total{pallas_2d}`` its K2 launches.  Returns the
    kernel dispatch counts."""
    snap = eng.obs.metrics.snapshot()
    kern = {c["labels"]["kernel"]: int(c["value"])
            for c in snap["kernel_dispatch_total"]["labels"]}
    gemm = {c["labels"]["backend"]: int(c["value"])
            for c in snap["qeinsum_dispatch_total"]["labels"]}
    want = {k: v for k, v in launches.items() if v}
    if kern != want or gemm.get("pallas_2d", 0) != want.get("nvfp4_matmul", 0):
        fail(f"engine {label}: dispatch counters {kern} (qeinsum {gemm}) "
             f"against launches {want}")
    return kern


def phase_5m(dev, cfg, params, qcfg, a_prompts, b_prompts, b_out) -> dict:
    """Serving telemetry on acereason-7b's loaded tree (full width, 28
    layers, packed): (a) run A's traffic through three engines, telemetry
    off, metrics, metrics and trace, stepped in lockstep after one warm-up
    each; (b) the speculative engine (self-qdq, k = 2) at 14 layers with
    metrics and trace; (c) run B's shared-prefix load traced; (d) the
    shadow teacher (the BF16 seed-0 tree beside the student) on 8 of run
    A's requests, then on the noisy weights; (e) whisper-tiny at full size
    on run I's first 8 requests, traced, with the shadow.  ``b_prompts``
    and ``b_out`` are run B's prompts and streams.  Returns each run's
    launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import common
    from repro_torch.obs import Observability
    from repro_torch.obs import compare
    from repro_torch.serve import Engine
    from repro_torch.spec import SpecEngine
    t_start = time.perf_counter()
    out = {}

    def stepped(eng, counts):
        """One engine step, its kernel launches added to ``counts``."""
        before = dict(ops.launches)
        eng.step()
        for k, v in ops.launches.items():
            counts[k] = counts.get(k, 0) + v - before[k]

    # (a) off, metrics, trace in lockstep: the staggered arrivals of
    # run_workload, one step of each engine at a time, the engines' order
    # rotated every round so that no mode always steps first
    modes = {"off": None, "metrics": Observability(metrics=True),
             "trace": Observability(metrics=True, trace=True)}
    rounds = []

    def rotated():
        names = list(modes)
        k = len(rounds) % len(names)
        rounds.append(k)
        return names[k:] + names[:k]
    engines = {m: Engine(cfg, params, qcfg, device=dev, obs=o, **ENGINE)
               for m, o in modes.items()}
    counts = {m: {} for m in modes}
    for m, eng in engines.items():               # warm-up, untimed
        for p in a_prompts[:2]:
            eng.submit(p, 2)
        while eng.sched.has_work():
            stepped(eng, counts[m])
        eng.token_lat_s.clear()
    rids = {m: [] for m in modes}
    half = len(a_prompts) // 2
    for m, eng in engines.items():
        rids[m] += [eng.submit(p, RUN_A["gen"]) for p in a_prompts[:half]]
    for p in a_prompts[half:]:
        for m in rotated():
            stepped(engines[m], counts[m])
            rids[m].append(engines[m].submit(p, RUN_A["gen"]))
    while any(e.sched.has_work() for e in engines.values()):
        for m in rotated():
            if engines[m].sched.has_work():
                stepped(engines[m], counts[m])
    torch.cuda.synchronize()
    streams = {m: [engines[m].sched.finished[r].output for r in rids[m]]
               for m in modes}
    for m in ("metrics", "trace"):
        if streams[m] != streams["off"]:
            n = sum(a != b for a, b in zip(streams[m], streams["off"]))
            fail(f"engine 5m-a: {m} streams differ from telemetry off on "
                 f"{n} requests")
    floor, p50 = {}, {}
    for m, eng in engines.items():
        if eng.state.leaked():
            fail(f"engine 5m-a {m}: the pool did not drain")
        lat = eng.token_lat_s
        floor[m], p50[m] = min(lat), float(np.percentile(lat, 50))
        print(f"[engine 5m-a] {m}: per-token decode latency floor "
              f"{floor[m]*1e3:.3f} ms, p50 {p50[m]*1e3:.3f} ms over "
              f"{len(lat)} tokens; launches {counts[m]}", flush=True)
        out[f"a_{m}"] = counts[m]
        if eng.obs.enabled:
            obs_artifacts_ok(eng, f"5m-a {m}")
            dispatch_equals_launches(eng, counts[m], f"5m-a {m}")
    print(f"[engine 5m-a] overhead on the floor (printed, not gated): metrics "
          f"{100 * (floor['metrics'] / floor['off'] - 1):+.2f}%, trace "
          f"{100 * (floor['trace'] / floor['off'] - 1):+.2f}%; on the p50: "
          f"metrics {100 * (p50['metrics'] / p50['off'] - 1):+.2f}%, trace "
          f"{100 * (p50['trace'] / p50['off'] - 1):+.2f}%; {len(rounds)} "
          f"rounds, the order rotated; streams bitwise equal across the "
          f"three; trace events {len(engines['trace'].obs.trace.events)}",
          flush=True)
    del engines

    # (b) speculative, 14 layers: the plain engine's streams are the oracle
    c14 = dataclasses.replace(cfg, n_layers=OBS["spec_depth"])
    p14 = dict(params, layers=common.tree_map(
        lambda a: a[:OBS["spec_depth"]], params["layers"]))
    sp = a_prompts[:OBS["spec_requests"]]
    ops.reset_launches()
    r0, o0 = serve.run_workload(Engine(c14, p14, qcfg, device=dev, **ENGINE),
                                sp, OBS["spec_gen"])
    out["b_plain"] = dict(ops.launches)
    obs = Observability(metrics=True, trace=True)
    eng = SpecEngine(c14, p14, qcfg, draft_k=OBS["spec_k"], device=dev,
                     obs=obs, **ENGINE)
    st, out["b_spec"], _, eq, _ = spec_run(
        "5m-b", eng, sp, OBS["spec_gen"], [o0[r] for r in r0])
    if not all(eq):
        fail(f"engine 5m-b: speculative streams with telemetry differ from "
             f"the plain engine's on {eq.count(False)} requests")
    obs_artifacts_ok(eng, "5m-b", expect_spec=True)
    dispatch_equals_launches(eng, out["b_spec"], "5m-b")
    snap = obs.metrics.snapshot()
    by_kind = {name: {c["labels"]["draft"]: int(c["value"])
                      for c in snap[name]["labels"]}
               for name in ("spec_draft_tokens_total",
                            "spec_accepted_tokens_total",
                            "spec_rolled_back_tokens_total")}
    want = {"spec_draft_tokens_total": st["drafted_tokens"],
            "spec_accepted_tokens_total": st["accepted_tokens"],
            "spec_rolled_back_tokens_total": st["rolled_back_tokens"]}
    if any(by_kind[k] != {"self-qdq": v} for k, v in want.items()) \
            or snap["spec_verify_seconds"]["count"] != st["verify_steps"]:
        fail(f"engine 5m-b: counters {by_kind}, verify histogram "
             f"{snap['spec_verify_seconds']['count']} against stats {want}, "
             f"{st['verify_steps']} verify steps")
    print(f"[engine 5m-b] counters equal stats: {by_kind}; verify steps "
          f"{st['verify_steps']}; draft steps "
          f"{int(snap['spec_draft_steps_total']['value'])}", flush=True)
    del eng, p14

    # (c) run B's load, traced: the counters against the pool's own
    obs = Observability(metrics=True, trace=True)
    eng = Engine(cfg, params, qcfg, device=dev, prefill_mode="paged",
                 kv_alloc="ondemand", prefix_cache=True, obs=obs, **ENGINE)
    ops.reset_launches()
    rids_c, out_c = serve.run_workload(eng, b_prompts, RUN_B["gen"])
    torch.cuda.synchronize()
    out["c_cache"] = dict(ops.launches)
    if [out_c[r].tolist() for r in rids_c] != [o.tolist() for o in b_out]:
        fail("engine 5m-c: traced streams differ from run B's")
    obs_artifacts_ok(eng, "5m-c", expect_cache=True)
    dispatch_equals_launches(eng, out["c_cache"], "5m-c")
    snap = obs.metrics.snapshot()
    cache = eng.state.cache
    got = (snap["prefix_cache_hit_total"]["value"],
           snap["prefix_cache_miss_total"]["value"],
           snap["prefix_cache_evict_total"]["value"])
    if got != (cache.hits, cache.misses, cache.evictions) or not cache.hits:
        fail(f"engine 5m-c: cache counters {got} against the pool's "
             f"{(cache.hits, cache.misses, cache.evictions)}")
    print(f"[engine 5m-c] run B traced: streams equal run B's, cache "
          f"counters hits/misses/evictions {got} equal the pool's; "
          f"{len(obs.trace.events)} trace events", flush=True)
    del eng

    # (d) the shadow teacher: the BF16 tree the student was quantized from
    t0 = time.perf_counter()
    teacher = serve.load_teacher(cfg, SEED, dev)
    torch.cuda.synchronize()
    t_teacher = time.perf_counter() - t0
    dp = a_prompts[:OBS["shadow_requests"]]
    ops.reset_launches()
    r0, o0 = serve.run_workload(Engine(cfg, params, qcfg, device=dev, **ENGINE),
                                dp, OBS["shadow_gen"])
    out["d_base"] = dict(ops.launches)
    torch.cuda.reset_peak_memory_stats()

    def shadow_run(p, label, want):
        """The shadow on weights ``p``; ``want``: the streams without it
        (the noisy weights' streams differ: not compared)."""
        eng = Engine(cfg, p, qcfg, device=dev, obs=Observability(metrics=True),
                     shadow_teacher=teacher, shadow_rate=OBS["shadow_rate"],
                     **ENGINE)
        ops.reset_launches()
        t0 = time.perf_counter()
        rids, got = serve.run_workload(eng, dp, OBS["shadow_gen"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        if want is not None and [got[r].tolist() for r in rids] != want:
            fail(f"engine 5m-d {label}: streams with the shadow differ from "
                 "the run without it")
        snap = obs_artifacts_ok(eng, f"5m-d {label}")
        dispatch_equals_launches(eng, launches, f"5m-d {label}")
        num = snap["numerics"]
        kl = num["series"].get("qad_live_kl", [])
        top1 = num["series"].get("qad_top1_agree", [])
        if not (num["sampled_records"] > 0 and kl and top1
                and all(math.isfinite(v) and v >= 0 for _, v in kl)
                and all(0.0 <= v <= 1.0 for _, v in top1)
                and num["sqnr_db_min"] is not None
                and any(s.startswith("layers.") and "sqnr_db" in st
                        for s, st in num["per_layer"].items())):
            fail(f"engine 5m-d {label}: shadow records {num['sampled_records']}"
                 f", live KL {kl}, top-1 {top1}, SQNR min {num['sqnr_db_min']}")
        print(f"[engine 5m-d] {label}: {eng.shadow_steps} shadow steps of "
              f"{len(dp)} requests at rate {OBS['shadow_rate']}, "
              f"{eng.shadow_s / eng.shadow_steps:.3f} s a shadow step, wall "
              f"{wall:.2f}s; live KL {[round(v, 5) for _, v in kl]}, top-1 "
              f"{[round(v, 3) for _, v in top1]}, SQNR min "
              f"{num['sqnr_db_min']:.2f} dB mean {num['sqnr_db_mean']:.2f} dB,"
              f" records {num['sampled_records']}"
              + ("" if want is None else "; streams equal the run without "
                 "the shadow")
              + f"; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
        return snap, launches

    clean, out["d_shadow"] = shadow_run(params, "clean",
                                        [o0[r].tolist() for r in r0])
    if compare.gate_violations(clean, clean, SHADOW_GATE):
        fail("engine 5m-d: the drift gate trips on clean against clean")
    noisy_params = serve.inject_quant_noise(params, OBS["noise"])
    noisy, out["d_noisy"] = shadow_run(noisy_params, f"noise {OBS['noise']}",
                                       None)
    violations = compare.gate_violations(clean, noisy, SHADOW_GATE)
    if not any("amax" in v or "kl" in v for v in violations):
        fail(f"engine 5m-d: the noise canary did not trip the gate: "
             f"{violations[:5]}")
    print(f"[engine 5m-d] teacher {t_teacher:.1f}s to draw; the noise canary "
          f"trips the gate: {len(violations)} violations, e.g. "
          f"{violations[:2]}", flush=True)
    del teacher, noisy_params
    gc.collect()
    torch.cuda.empty_cache()

    # (e) whisper-tiny, traced, with the shadow: the slab spans and the
    # shadow's extras
    c, wparams, wqcfg, _, _, _ = load_full(WHISPER["arch"], dev)
    wteacher = serve.load_teacher(c, SEED, dev)
    n = OBS["whisper_requests"]
    wp = serve.mixed_prompts(WHISPER["requests"], WHISPER["min_prompt"],
                             WHISPER["max_prompt"], c.vocab_size, SEED + 6)[:n]
    extras = [{"enc_frames": f}
              for f in serve.enc_frames(c, WHISPER["requests"], SEED)[:n]]
    bs = ENGINE["block_size"]
    kw = dict(n_slots=ENGINE["n_slots"], block_size=bs,
              max_blocks_per_slot=WHISPER["s_alloc"] // bs)
    ops.reset_launches()
    r0, o0 = serve.run_workload(Engine(c, wparams, wqcfg, device=dev, **kw),
                                wp, OBS["whisper_gen"], extras)
    out["e_off"] = dict(ops.launches)
    obs = Observability(metrics=True, trace=True)
    eng = Engine(c, wparams, wqcfg, device=dev, obs=obs, shadow_teacher=wteacher,
                 shadow_rate=OBS["shadow_rate"], **kw)
    ops.reset_launches()
    rids_e, out_e = serve.run_workload(eng, wp, OBS["whisper_gen"], extras)
    torch.cuda.synchronize()
    out["e_shadow"] = dict(ops.launches)
    if [out_e[r].tolist() for r in rids_e] != [o0[r].tolist() for r in r0]:
        fail("engine 5m-e: whisper streams with trace and shadow differ from "
             "telemetry off")
    snap = obs_artifacts_ok(eng, "5m-e")
    dispatch_equals_launches(eng, out["e_shadow"], "5m-e")
    num = snap["numerics"]
    if not num["sampled_records"] or num["sqnr_db_min"] is None:
        fail(f"engine 5m-e: shadow records {num['sampled_records']}")
    kl = num["series"]["qad_live_kl"]
    print(f"[engine 5m-e] {c.name}: {n} requests, {OBS['whisper_gen']} tokens, "
          f"traced ({len(obs.trace.events)} events) with the shadow "
          f"({eng.shadow_steps} steps, {eng.shadow_s / eng.shadow_steps:.3f} s "
          f"each): streams equal telemetry off; live KL "
          f"{min(v for _, v in kl):.5f}..{max(v for _, v in kl):.5f}, SQNR "
          f"min {num['sqnr_db_min']:.2f} dB", flush=True)
    del eng, wparams, wteacher
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[engine 5m] serving telemetry: {time.perf_counter() - t_start:.1f}s",
          flush=True)
    return out


def phase_5k(dev, row_inv) -> dict:
    """FP8 KV, the moe_hybrid recipe on qwen2-moe-a2.7b at full size
    (``dataclasses.replace`` here: attention BF16, experts packed, an FP8
    pool), run M's traffic through the fused tier; then speculative
    decoding on it at k = 2 (self-qdq).  Returns each run's launches."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import Engine
    from repro_torch.spec import SpecEngine
    t_start = time.perf_counter()
    c = dataclasses.replace(configs.get_config(MOE_ARCH),
                            quant_recipe="moe_hybrid")
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, qcfg = serve.load_quantized(c, SEED, "packed", dev)
    torch.cuda.synchronize()
    load_s, load_peak = (time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated() / 1e9)
    wr = serve.weight_report(params)
    embed_b = params["embed"].numel() * params["embed"].element_size()
    lp = params["layers"]
    attn_b = sum(lp[k].numel() * lp[k].element_size() for k in ("wqkv", "wo"))
    n_attn = sum(lp[k].numel() for k in ("wqkv", "wo"))
    # the pool's layout: E4M3 K and V pages and one f32 scale a (slot, head)
    slots_total = ENGINE["n_blocks"] * ENGINE["block_size"]
    page_b = 2 * c.n_layers * slots_total * c.n_kv_heads * c.head_dim
    scale_b = 2 * c.n_layers * slots_total * c.n_kv_heads * 4
    # a decode step reads every weight but the embedding (a lookup) once,
    # and the slots' valid KV (run A's mean context of about 300 tokens)
    mean_ctx = (RUN_A["min_prompt"] + RUN_A["max_prompt"]) / 2 + RUN_A["gen"] / 2
    kv_b = ENGINE["n_slots"] * mean_ctx * (page_b + scale_b) / slots_total
    step_b = wr["total_bytes"] - embed_b + kv_b
    print(f"[engine K] {c.name} full size, quant_recipe=moe_hybrid (attention "
          f"BF16, FP8 KV, experts packed): load + PTQ {load_s:.1f}s, peak "
          f"{load_peak:.2f} GB ({resident:.2f} resident before); weights "
          f"{wr['total_bytes'] / 1e9:.3f} GB, packed {wr['q_params'] / 1e9:.3f} "
          f"B params in {wr['q_bytes'] / 1e9:.3f} GB, BF16 attention "
          f"{n_attn / 1e6:.1f} M params in {attn_b / 1e9:.3f} GB (packed: "
          f"{n_attn * 0.5625 / 1e9:.3f}); decode bound {step_b / 1e9:.3f} GB a "
          f"step ({kv_b / 1e9:.4f} of it FP8 KV at {mean_ctx:.0f} tokens a slot) "
          f"= {step_b / HBM_BYTES_S * 1e3:.3f} ms at "
          f"{HBM_BYTES_S / 1e12:.2f} TB/s", flush=True)
    prompts = serve.mixed_prompts(RUN_A["requests"], RUN_A["min_prompt"],
                                  RUN_A["max_prompt"], c.vocab_size, SEED + 2)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(c, params, qcfg, device=dev, fused_kernels="on", **ENGINE)
    first = first_decode_logits(eng)
    k_pre = prefill_logits(eng)          # the oracle of phase 5n's runs
    ops.reset_launches()
    t0 = time.perf_counter()
    rids, out = serve.run_workload(eng, prompts, RUN_A["gen"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats()
    pool_b = eng.pool.nbytes()
    print(f"[engine K] {RUN_A['requests']} requests, run M's traffic, fused "
          f"on ({st['packed_backend']}), FP8 pool {ENGINE['n_blocks']}x"
          f"{ENGINE['block_size']}: wall {wall:.2f}s, steps {st['steps']}, "
          f"decode steps {st['decode_steps']}; ttft_p50_ms="
          f"{st['ttft_p50_s']*1e3:.1f} ttft_p95_ms={st['ttft_p95_s']*1e3:.1f} "
          f"decode_step_p50_ms={st['decode_step_p50_s']*1e3:.2f} "
          f"decode_step_p95_ms={st['decode_step_p95_s']*1e3:.2f} "
          f"decode_tok_s={st['decode_tok_s']:.1f} e2e_tok_s={st['e2e_tok_s']:.1f} "
          f"peak_mem_gb={peak:.2f}; pool {pool_b / 1e6:.1f} MB (E4M3 pages "
          f"{page_b / 1e6:.1f} + f32 scales {scale_b / 1e6:.1f}; BF16 pages "
          f"would be {2 * page_b / 1e6:.1f}, ratio {pool_b / (2 * page_b):.3f}); "
          f"launches {launches}", flush=True)
    if len(out) != len(prompts) or any(len(out[r]) != RUN_A["gen"] for r in rids):
        fail(f"engine K: {len(out)} of {len(prompts)} requests finished")
    if eng.state.leaked() or eng.pool.used_blocks != eng.pool.cached_blocks:
        fail("engine K: the FP8 pool did not drain")
    if not st["fp8"] or eng.pool.data["k"].dtype != torch.float8_e4m3fn:
        fail("engine K: the pool is not FP8")
    if pool_b != page_b + scale_b:
        fail(f"engine K: the pool holds {pool_b} bytes, the layout "
             f"{page_b + scale_b}")
    n_fwd = len(prompts) + st["decode_steps"]
    if launches["paged_attention"] != c.n_layers * st["decode_steps"]:
        fail(f"engine K launched paged_attention {launches['paged_attention']} "
             f"times, expected {c.n_layers} x {st['decode_steps']} decode steps")
    if launches["nvfp4_matmul_grouped"] != 3 * c.n_layers * n_fwd:
        fail(f"engine K launched nvfp4_matmul_grouped "
             f"{launches['nvfp4_matmul_grouped']} times, expected 3 x "
             f"{c.n_layers} x {n_fwd} forwards")
    # each request against the static path at batch 1 (FP8 dense cache):
    # the first token, and the first decode step's logits fed it
    ref_q = dataclasses.replace(qcfg, packed_backend=eng.sq.packed_backend,
                                quantize_weights=False)
    first_ok, rel = 0, []
    with torch.inference_mode():
        for rid, p in zip(rids, prompts):
            toks = torch.from_numpy(p[None].astype(np.int64)).to(dev)
            lp, cache = eng.model.prefill(eng.cfg, params, {"tokens": toks},
                                          ref_q, s_max=len(p) + 2)
            if cache["k"].dtype != torch.float8_e4m3fn:
                fail("serve_batch's dense cache is not FP8 under moe_hybrid")
            tok = torch.argmax(lp[:, -1:], -1)
            first_ok += int(tok[0, 0]) == int(out[rid][0])
            ld, _ = eng.model.decode_step(eng.cfg, params, cache,
                                          {"tokens": torch.full_like(
                                              tok, int(out[rid][0]))}, ref_q)
            rel.append(rel_l2(first[rid], ld[0, -1]))
            del cache
    print(f"[engine K] against the static path at batch 1 (FP8 dense cache): "
          f"first tokens equal on {first_ok}/{len(rids)}; first decode step's "
          f"logits rel_l2 max {max(rel):.4g} median {float(np.median(rel)):.4g} "
          f"(tolerance {LOGIT_TOL['nvfp4']})", flush=True)
    if first_ok != len(rids):
        fail("engine K: a first token differs from the static path's")
    if max(rel) > LOGIT_TOL["nvfp4"]:
        fail(f"engine K: first decode step's logits differ by {max(rel)}")
    # a traced decode step: one K7 kernel (FP8 pages) for each layer
    t = trace_filled(eng, prompts, "FP8 MoE engine decode step")
    busy = sum(t["by_kernel"].values())
    k7_ms = sum(ms for k, ms in t["by_kernel"].items()
                if "paged_attention_kernel" in k)
    print(f"[trace] FP8 MoE engine decode step, 8 slots (traced): wall_ms="
          f"{t['wall_ms']:.3f} device_busy_ms={busy:.3f} idle_share="
          f"{1 - busy / t['wall_ms']:.3f} paged_attention_ms={k7_ms:.3f} "
          f"({t['n_k7']} kernels for {t['launches']['paged_attention']} "
          f"launches); device ops: {t['n_port']:.0f} of the port's kernels "
          f"({t['n_qdq']:.0f} QDQ for {t['launches']['nvfp4_qdq']} QDQ calls), "
          f"{t['n_other']:.0f} others", flush=True)
    if t["n_k7"] != c.n_layers or t["launches"]["paged_attention"] != c.n_layers:
        fail(f"engine K decode step: {t['n_k7']} paged_attention kernels, "
             f"expected one for each of {c.n_layers} layers")
    print_by_kind("FP8 MoE engine decode step", t["by_kernel"])
    want = [out[r] for r in rids]
    del eng
    gc.collect()

    # speculative decoding on the FP8 MoE engine: self-qdq at k = 2.  Its
    # verify runs the BF16 GEMMs (attention, router, lm_head) at M = 8 x 3
    # where the plain decode runs them at M = 8: the token gate holds when
    # phase 3l found those rows invariant across M
    invariant = all(row_inv[(MOE_ARCH, site)][m] for site in
                    ("lm_head", "wqkv", "wo", "router", "sh_gate")
                    for m in (ENGINE["n_slots"], ENGINE["n_slots"] * 3))
    seng = SpecEngine(c, params, qcfg, draft_k=2, draft="self-qdq", device=dev,
                      fused_kernels="on", **ENGINE)
    vfirst, inner = {}, seng._accept

    def accept(logits, draft_toks, draft_probs, st_):
        for r in seng.sched.running():
            if len(r.output) == 1:
                vfirst[r.rid] = logits[r.slot, 0].clone()
        return inner(logits, draft_toks, draft_probs, st_)
    seng._accept = accept
    n_s, g_s = RUN_KSPEC["requests"], RUN_KSPEC["gen"]
    sst, slaunches, souts, eq, srids = spec_run(
        "K spec", seng, prompts[:n_s], g_s, [w[:g_s] for w in want[:n_s]])
    if not sst["fp8"] or seng.proposer.data["k"].dtype != torch.float8_e4m3fn:
        fail("engine K spec: the pool or the draft pool is not FP8")
    first_eq = sum(int(o[0]) == int(w[0]) for o, w in zip(souts, want))
    vrel = [rel_l2(vfirst[a], first[b]) for a, b in zip(srids, rids)]
    agree = float(np.mean([np.mean(o == w[:g_s]) for o, w in
                           zip(souts, want)]))
    print(f"[engine K spec] BF16 GEMM rows invariant across M = "
          f"{ENGINE['n_slots']} and {ENGINE['n_slots'] * 3} (phase 3l): "
          f"{invariant}; streams equal {sum(eq)}/{len(eq)} (gated: "
          f"{invariant}), first tokens {first_eq}/{len(eq)}, {agree:.3f} of "
          f"positions; first verify's logits against the plain engine's "
          f"first decode step rel_l2 max {max(vrel):.4g} (tolerance "
          f"{LOGIT_TOL['nvfp4']})", flush=True)
    if invariant and not all(eq):
        fail(f"engine K spec: greedy streams differ from the plain engine's "
             f"on {eq.count(False)} requests")
    if first_eq != len(eq):
        fail("engine K spec: a first token differs from the plain engine's")
    if max(vrel) > LOGIT_TOL["nvfp4"]:
        fail(f"engine K spec: first verify logits differ by {max(vrel)}")
    # phase 5n's oracle: run K's prefill logits and first tokens of its
    # first requests, and the same prefills through the tier a TP rank
    # runs: this engine's with fused_kernels="off" (the expert stacks
    # dequantized and multiplied, the gather-then-attend attention)
    n_tp = RUN_KTP["requests"]
    ueng = Engine(c, params, qcfg, device=dev, fused_kernels="off", **ENGINE)
    u_pre = prefill_logits(ueng)
    u_rids, u_out = serve.run_workload(ueng, prompts[:n_tp], 1)
    oracle = dict(prompts=prompts[:n_tp], tokens=want[:n_tp], pool_bytes=pool_b,
                  pre=[k_pre[r].cpu() for r in rids[:n_tp]],
                  pre_unfused=[u_pre[r].cpu() for r in u_rids],
                  first_unfused=[int(u_out[r][0]) for r in u_rids])
    del ueng, u_pre
    del seng, params, first, k_pre
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[engine K] {time.perf_counter() - t_start:.1f}s", flush=True)
    return {"fp8": launches, "spec": slaunches, "tp_oracle": oracle}


def gemm_rows_batched_attention():
    """A context for ROADMAP C.1 (b)'s check: the BF16 GEMMs
    (``layers._matmul``: attention and the tied lm_head) one row at a time,
    M = 1 each as a batch-1 ``serve_batch`` runs them, and the slab
    decode's attention products batched over the slots in one einsum, as
    they were before ``attention._per_row``."""
    import contextlib

    import torch

    from repro_torch.models import attention as mattn
    from repro_torch.models import layers as mlayers

    @contextlib.contextmanager
    def ctx():
        mm, per_row = mlayers._matmul, mattn._per_row

        def matmul_rows(x, w):
            x2 = x.reshape(-1, x.shape[-1])
            y = torch.cat([mm(x2[i:i + 1], w) for i in range(x2.shape[0])])
            return y.reshape(*x.shape[:-1], y.shape[-1])
        mlayers._matmul = matmul_rows
        mattn._per_row = torch.einsum
        try:
            yield
        finally:
            mlayers._matmul, mattn._per_row = mm, per_row
    return ctx()


def phase_5f_rows(dev, c, params, qcfg, prompts, mb, want) -> tuple:
    """ROADMAP C.1 (b): run F's 4-slot streams with the BF16 GEMMs one row
    at a time and the slab attention's products batched as they were,
    against ``serve_batch``'s streams ``want``.  Printed (the main run's
    token gate holds the fix); returns (requests equal, share of
    positions equal)."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.serve import Engine
    eng = Engine(c, params, qcfg, device=dev, n_slots=len(prompts),
                 block_size=ENGINE["block_size"], max_blocks_per_slot=mb)
    with gemm_rows_batched_attention():
        rids, got = serve.run_workload(eng, prompts, RGEMMA["gen"])
    slab_drained(eng, "F, the former attention")
    eq = sum(np.array_equal(got[r], w) for r, w in zip(rids, want))
    share = float(np.mean([np.mean(got[r] == w) for r, w in zip(rids, want)]))
    print(f"[engine F] {len(prompts)} slots with the BF16 GEMMs one row at a "
          f"time and the attention's products batched (its former form): "
          f"streams equal to serve_batch's on {eq}/{len(prompts)} requests, "
          f"{share:.3f} of positions (printed: C.1 (b)'s check)", flush=True)
    return eq, share


def vlm_nvfp4_card_vs_cpu(dev) -> float:
    """ROADMAP C.1 (a): qwen2-vl-2b's decode with NVFP4 activations (per-
    token scales) parts from teacher forcing as far in the reference as in
    the port (``tests/test_torch_mrope.py``), so its parity is held here:
    the smoke config with a head of 32 (every M-RoPE section read), packed
    weights from the seed, 2 sequences of 48 tokens with a 4 x 4 grid,
    prefill of 40 and 8 ``decode_step``s, the card's logits at each step
    within LOGIT_TOL["nvfp4"] relative L2 of the CPU's.  Returns the
    largest."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve, specs
    from repro_torch.models import decoder
    c = dataclasses.replace(configs.get_smoke(QWEN_VL["arch"]), d_head=32)
    p_cpu, _ = serve.load_quantized(c, SEED, "packed", "cpu")
    p_dev = params_to(p_cpu, dev)
    batch = vlm_batch(c, 2, 48, 3, 4, torch.Generator().manual_seed(SEED + 9),
                      "cpu")
    tq = dataclasses.replace(specs.serve_qconfig(c), act_scope="token")
    steps = {}
    for where, params, b in (("cpu", p_cpu, batch),
                             ("card", p_dev, to_device(batch, dev))):
        with torch.inference_mode():
            lg, cache = decoder.prefill(c, params, {k: v[:, :40] for k, v in
                                                    b.items()}, tq, s_max=48)
            out = [lg[:, 0].float().cpu()]
            for i in range(40, 48):
                lg, cache = decoder.decode_step(
                    c, params, cache, {"tokens": b["tokens"][:, i:i + 1],
                                       "pos3": b["pos3"][:, i:i + 1]}, tq)
                out.append(lg[:, 0].float().cpu())
        steps[where] = out
    rel = [rel_l2(a, b) for a, b in zip(steps["card"], steps["cpu"])]
    print(f"[smoke] {c.name} (head 32), NVFP4 activations at per-token "
          f"scales: card vs CPU prefill + 8 decode steps rel_l2 "
          + " ".join(f"{x:.3g}" for x in rel)
          + f" (tolerance {LOGIT_TOL['nvfp4']})", flush=True)
    if max(rel) > LOGIT_TOL["nvfp4"]:
        fail(f"{c.name}: NVFP4 decode on the card parts from the CPU's by "
             f"{max(rel)}")
    return max(rel)


def phase_4_families(dev):
    """Phase 4 for rwkv6, whisper and qwen2-vl at smoke size: the same
    weights and inputs on the card and on the CPU.  Prefill logits within
    1e-2 (gated), greedy tokens compared (printed); one QAD step within
    STEP_TOL and each updated parameter within one bf16 ulp plus 2 lr,
    with one K5, one K6 and two K1 launches a quantized site (the
    activation and the weight)."""
    import torch

    from repro_torch import configs
    from repro_torch.core import qad
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, specs
    from repro_torch.models import common, get_model
    from repro_torch.optim import AdamW, warmup_cosine
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 7)

    def extras(c, b, s):
        if c.family == "encdec":
            return {"enc_frames": torch.randn((b, c.enc_seq, c.d_model),
                                              generator=gen)}
        if c.mrope_sections:
            vb = vlm_batch(c, b, s, 2, 2, gen, "cpu")
            return {k: vb[k] for k in ("vis_mask", "vis_embeds", "pos3")}
        return {}

    def greedy(c, params, batch, n):
        """Greedy tokens: ``serve_batch``, or for M-RoPE (whose decode
        steps take pos3) prefill and decode_step with each new token at
        the text positions after the prompt's largest."""
        if not c.mrope_sections:
            ex = {k: v for k, v in batch.items() if k != "tokens"}
            return serve.serve_batch(c, params, batch["tokens"], n,
                                     extras=ex)[0]
        model, sq = get_model(c), specs.serve_qconfig(c)
        b, s = batch["tokens"].shape
        nxt = int(batch["pos3"].max()) + 1
        with torch.inference_mode():
            logits, cache = model.prefill(c, params, batch, sq, s_max=s + n)
            out = [torch.argmax(logits[:, -1:], -1)]
            for i in range(n - 1):
                p3 = torch.full((b, 1, 3), nxt + i, dtype=torch.long,
                                device=logits.device)
                logits, cache = model.decode_step(
                    c, params, cache, {"tokens": out[-1], "pos3": p3}, sq)
                out.append(torch.argmax(logits[:, -1:], -1))
        return torch.cat(out, 1)

    for arch in (RWKV["arch"], WHISPER["arch"], QWEN_VL["arch"]):
        c = configs.get_smoke(arch)
        model = get_model(c)
        p_cpu, _ = serve.load_quantized(c, SEED, "packed", "cpu")
        p_dev = params_to(p_cpu, dev)
        batch = {"tokens": torch.randint(4, c.vocab_size, (2, 8),
                                         generator=torch.Generator()
                                         .manual_seed(SEED)),
                 **extras(c, 2, 8)}
        sq = specs.serve_qconfig(c)
        with torch.inference_mode():
            l_cpu, _ = model.prefill(c, p_cpu, batch, sq)
            l_dev, _ = model.prefill(c, p_dev, to_device(batch, dev), sq)
        # torch.allclose's test, |card - CPU| <= 1e-2 + 1e-2 |CPU|, as a
        # fraction of its limit
        l_at = float(((l_dev.float().cpu() - l_cpu.float()).abs()
                      / (1e-2 + 1e-2 * l_cpu.float().abs())).max())
        if l_at > 1.0:
            fail(f"{c.name} smoke prefill logits on the card differ from the "
                 f"CPU's: at {l_at:.3f} of the tolerance")
        agree = torch.equal(greedy(c, p_cpu, batch, 6),
                            greedy(c, p_dev, to_device(batch, dev), 6).cpu())

        tb = make_batch(DataConfig(c.vocab_size, 32, 4, seed=SEED), 0)
        tb.update(extras(c, 4, 32))
        opt = AdamW(lr=warmup_cosine(1e-3, 0, 10), clip_norm=1.0)
        step_fn = qad.make_train_step(model, c, specs.recipe_qconfig(c), opt)
        st_cpu = qad.init_state(model, c, torch.Generator().manual_seed(SEED),
                                opt, device="cpu")
        st_dev = qad.TrainState(
            step=st_cpu.step.to(dev), student=params_to(st_cpu.student, dev),
            teacher=params_to(st_cpu.teacher, dev),
            opt_state=type(st_cpu.opt_state)(*(params_to(t, dev)
                                                for t in st_cpu.opt_state)))
        new_cpu, m_cpu = step_fn(st_cpu, tb)
        ops.reset_launches()
        new_dev, m_dev = step_fn(st_dev, to_device(tb, dev))
        torch.cuda.synchronize()
        want = {"kl_loss": 1, "kl_loss_bwd": 1,
                "nvfp4_qdq": 2 * family_sites(c)}
        if any(ops.launches[k] != n for k, n in want.items()):
            fail(f"{c.name} smoke QAD step on the card: launches "
                 f"{ops.launches}, expected {want}")
        srel = {k: abs(float(m_dev[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
                for k in STEP_TOL}
        worst = 0.0
        for a, b in zip(common.tree_leaves(new_dev.student),
                        common.tree_leaves(new_cpu.student)):
            a, b = a.float().cpu(), b.float()
            lim = ulp(torch.maximum(a.abs(), b.abs()), 7) + 2 * 1e-3
            worst = max(worst, float(((a - b).abs() / lim).max()))
        if c.mrope_sections:
            vlm_nvfp4_card_vs_cpu(dev)
        print(f"[smoke] {c.name}: card vs CPU prefill logits within 1e-2 "
              f"(at {l_at:.3f} of the tolerance); "
              f"greedy tokens {'AGREE' if agree else 'DISAGREE'}; QAD step "
              f"loss {float(m_dev['loss']):.6g} vs {float(m_cpu['loss']):.6g} "
              f"(rel {srel['loss']:.2e}), grad_norm rel "
              f"{srel['grad_norm']:.2e}, updated params at {worst:.3f} of "
              f"their tolerance, launches {want}", flush=True)
        for k, tol in STEP_TOL.items():
            if srel[k] > tol:
                fail(f"{c.name} smoke QAD step: {k} on the card differs from "
                     f"the CPU's by {srel[k]}")
        if worst > 1.0:
            fail(f"{c.name} smoke QAD step: updated parameters differ beyond "
                 "1 bf16 ulp + 2 lr")
    print(f"[smoke] the slab families and M-RoPE: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def slab_oracle(eng, rids, prompts, extras, gen_n, first, pre, label):
    """Each request of a slab-engine run against the static path at batch
    1 on its prompt (``prefill``, then ``decode_step`` fed the engine's
    first token): the prefill logits bitwise, the first decode step's
    logits within LOGIT_TOL (printed)."""
    import numpy as np
    import torch

    from repro_torch.launch import specs
    c, params, dev = eng.cfg, eng.params, eng.device
    model, sq = eng.model, specs.serve_qconfig(eng.cfg)
    n_eq, rel = 0, []
    with torch.inference_mode():
        for rid, p, ex in zip(rids, prompts, extras):
            batch = {"tokens": torch.from_numpy(p[None].astype(np.int64)).to(dev),
                     **{k: torch.as_tensor(v, device=dev)[None]
                        for k, v in (ex or {}).items()}}
            lp, cache = model.prefill(c, params, batch, sq, s_max=len(p) + gen_n)
            n_eq += bool(torch.equal(pre[rid], lp[0, -1].float()))
            tok = torch.argmax(lp[:, -1:], -1)
            ld, _ = model.decode_step(c, params, cache, {"tokens": tok}, sq)
            rel.append(rel_l2(first[rid], ld[0, -1]))
            del cache
    print(f"[engine {label}] against the static path at batch 1: prefill "
          f"logits bitwise equal on {n_eq}/{len(pre)} requests; first decode "
          f"step's logits rel_l2 max {max(rel):.4g} median "
          f"{float(np.median(rel)):.4g} (tolerance {LOGIT_TOL['nvfp4']})",
          flush=True)
    if n_eq != len(pre):
        fail(f"engine {label}: prefill logits not bitwise the static path's")
    if max(rel) > LOGIT_TOL["nvfp4"]:
        fail(f"engine {label}: first decode step's logits differ by {max(rel)}")


def slab_engine_run(c, params, qcfg, dev, prompts, extras, gen_n, label,
                    resident, **engine_kw):
    """Run A's arrivals over the slab engine: (engine, rids, outputs,
    launches, prefill logits, first decode logits); every request must
    finish and every slot be released.  ``resident``: GB held before the
    weights were loaded, which the serving peak is printed net of."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import Engine
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(c, params, qcfg, device=dev, **engine_kw)
    first, pre = first_decode_logits(eng), prefill_logits(eng)
    ops.reset_launches()
    t0 = time.perf_counter()
    rids, out = serve.run_workload(eng, prompts, gen_n, extras)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(out) != len(prompts) or any(len(out[r]) != gen_n for r in rids):
        fail(f"engine {label}: {len(out)} of {len(prompts)} requests finished")
    slab_drained(eng, label)
    st = eng.stats()
    print(f"[engine {label}] {c.name} full size, packed, slab plan "
          f"{'+'.join(eng.state_plan)}: {len(prompts)} requests, gen {gen_n}, "
          f"{eng.n_slots} slots: wall {wall:.2f}s, steps {st['steps']}, decode "
          f"steps {st['decode_steps']}; ttft_p50_ms={st['ttft_p50_s']*1e3:.1f} "
          f"ttft_p95_ms={st['ttft_p95_s']*1e3:.1f} "
          f"decode_step_p50_ms={st['decode_step_p50_s']*1e3:.2f} "
          f"decode_step_p95_ms={st['decode_step_p95_s']*1e3:.2f} "
          f"decode_tok_s={st['decode_tok_s']:.1f} e2e_tok_s={st['e2e_tok_s']:.1f}"
          f" prefill_s={st['prefill_s']:.2f} decode_s={st['decode_s']:.2f}; "
          f"state {st['state_bytes_per_slot'] / 2**20:.3f} MiB a slot "
          f"({st['pool_bytes'] / 1e9:.4f} GB for {eng.n_slots}); serving peak "
          f"{peak - resident:.2f} GB net of the {resident:.2f} GB resident "
          f"before the load; launches {launches}", flush=True)
    if (launches["paged_attention"] or launches["nvfp4_matmul_grouped"]
            or launches["kl_loss"]):
        fail(f"engine {label} launched a kernel off its path: {launches}")
    return eng, rids, out, launches, pre, first


def load_full(arch, dev):
    """A full-size config's packed weights from the seed: (cfg, params,
    qcfg, load s, load peak GB, resident GB before)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    c = configs.get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, qcfg = serve.load_quantized(c, SEED, "packed", dev)
    torch.cuda.synchronize()
    return (c, params, qcfg, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9, resident)


def phase_5h(dev) -> tuple:
    """rwkv6-3b at full size on the slab engine: run A's arrivals, prompts
    of 64 k tokens (k = 1..8, each twice), 32 greedy tokens.  Returns the
    run's launches, the speculative run's and phase 5o's oracle (the
    shortest prompts' prefill logits and streams, on the host)."""
    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import common, rwkv6
    from repro_torch.serve import Engine
    t_start = time.perf_counter()
    c, params, qcfg, load_s, load_peak, resident = load_full(RWKV["arch"], dev)
    wr = serve.weight_report(params)
    n_total = sum(math.prod(sp.shape) for sp in
                  common.tree_leaves(rwkv6.param_specs(c)))
    embed_b = params["embed"].numel() * params["embed"].element_size()
    head_b = params["lm_head"].numel() * params["lm_head"].element_size()
    lora_b = sum(params["layers"][k].numel() * 2 for k in ("ts_w2", "dec_w2"))
    state_b = common.spec_bytes(rwkv6.slot_state_specs(c, ENGINE["n_slots"], 0))
    # a decode step reads every weight but the embedding (a lookup) once,
    # and reads and writes the slots' state
    step_b = wr["total_bytes"] - embed_b + 2 * state_b
    print(f"[engine H] {c.name}: {c.n_layers} layers, d_model {c.d_model}, "
          f"{c.d_model // c.rwkv_head_dim} WKV heads of {c.rwkv_head_dim}, "
          f"d_ff {c.d_ff}, vocab {c.vocab_size}, {n_total / 1e9:.3f} B params; "
          f"load + PTQ {load_s:.1f}s, peak {load_peak:.2f} GB ({resident:.2f} "
          f"resident before); packed {wr['q_params'] / 1e9:.3f} B params in "
          f"{wr['q_bytes'] / 1e9:.3f} GB, BF16 lm_head {head_b / 1e9:.3f} GB, "
          f"BF16 LoRA mats {lora_b / 1e9:.4f} GB, {ENGINE['n_slots']} slots' "
          f"state {state_b / 1e9:.4f} GB read and written; decode bound "
          f"{step_b / 1e9:.3f} GB a step = {step_b / HBM_BYTES_S * 1e3:.3f} ms "
          f"at {HBM_BYTES_S / 1e12:.2f} TB/s", flush=True)
    g = torch.Generator().manual_seed(SEED + 5)
    lens = [64 * k for k in range(1, 9)] * 2
    prompts = [torch.randint(4, c.vocab_size, (n,), generator=g).numpy()
               .astype(np.int32) for n in lens]
    eng, rids, out, launches, pre, first = slab_engine_run(
        c, params, qcfg, dev, prompts, None, RWKV["gen"], "H", resident,
        **ENGINE)
    per_fwd = family_sites(c)
    n_fwd = len(prompts) + eng.stats()["decode_steps"]
    for k in ("nvfp4_qdq", "nvfp4_matmul"):
        if launches[k] != per_fwd * n_fwd:
            fail(f"engine H launched {k} {launches[k]} times, expected "
                 f"{per_fwd} a forward x {n_fwd} forwards")
    print(f"[engine H] K1 and K2 {per_fwd} launches a forward (10 sites x "
          f"{c.n_layers} layers) x {n_fwd} forwards", flush=True)
    slab_oracle(eng, rids, prompts, [None] * len(prompts), RWKV["gen"], first,
                pre, "H")
    # one slot at a time: every GEMM sees the rows serve_batch's do
    n1 = RWKV["one_slot"]
    eng1 = Engine(c, params, qcfg, device=dev, n_slots=1,
                  block_size=ENGINE["block_size"],
                  max_blocks_per_slot=ENGINE["max_blocks_per_slot"])
    r1, o1 = serve.run_workload(eng1, prompts[:n1], RWKV["gen"])
    slab_drained(eng1, "H, one slot")
    for rid, p in zip(r1, prompts[:n1]):
        want, _ = serve.serve_batch(c, params, torch.from_numpy(
            p[None].astype(np.int64)).to(dev), RWKV["gen"])
        if not np.array_equal(want[0].cpu().numpy(), o1[rid]):
            fail(f"engine H at one slot: request {rid} {o1[rid][:12].tolist()} "
                 f"against serve_batch's {want[0, :12].tolist()}")
    agree = np.mean([np.mean(out[r] == o1[q]) for r, q in zip(rids, r1)])
    print(f"[engine H] one slot at a time: greedy tokens equal to serve_batch "
          f"on {n1}/{n1} requests; the 8-slot run's tokens equal to them at "
          f"{agree:.3f} of positions (printed)", flush=True)
    trace_slab_step(eng, prompts, "rwkv6 engine")
    # 5l on the slab engine: the stepped verify's snapshot / restore over
    # cumulative state, its streams against run H's (the plain engine's
    # rows do not depend on the other slots: M = 8 in every step)
    from repro_torch.spec import SpecEngine
    n_s, g_s = RWKV["spec_requests"], RWKV["spec_gen"]
    seng = SpecEngine(c, params, qcfg, draft_k=RWKV["spec_k"], draft="self-qdq",
                      device=dev, **ENGINE)
    _, spec_launches, _, eq, _ = spec_run(
        "H spec", seng, prompts[:n_s], g_s, [out[r][:g_s] for r in rids[:n_s]])
    if not all(eq):
        fail(f"engine H spec: greedy streams differ from the plain slab "
             f"engine's on {eq.count(False)} requests")
    # phase 5o's oracle: the shortest prompts' prefill logits and streams
    short = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
    short = short[:RUN_OTP["rwkv_requests"]]
    oracle = dict(
        arch=RWKV["arch"], plan=eng.state_plan, what="run H's shortest",
        prompts=[prompts[i] for i in short], extras=None,
        gen=RUN_OTP["rwkv_gen"], engine=ENGINE, fault="receptance",
        spec=dict(k=RUN_OTP["spec_k"], requests=RUN_OTP["spec_requests"],
                  gen=RUN_OTP["spec_gen"]),
        pre=[pre[rids[i]].cpu() for i in short],
        tokens=[out[rids[i]] for i in short],
        pool_bytes=eng.stats()["pool_bytes"], whole={"x_prev_tm", "x_prev_cm"},
        **slab_prefill_controls(eng, [prompts[i] for i in short], None))
    del eng, eng1, seng, params
    print(f"[engine H] {time.perf_counter() - t_start:.1f}s", flush=True)
    return launches, spec_launches, oracle


def phase_5i(dev) -> tuple:
    """whisper-tiny at full size on the slab engine: 16 requests, each with
    its own encoder frames [1500, 384], decoder prompts of 4..192 tokens,
    64 greedy tokens, 8 slots of 448 self-attention positions.  Returns
    the run's launches and phase 5o's oracle (the first requests' prefill
    logits and streams, on the host)."""
    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import common, whisper
    from repro_torch.serve import Engine
    t_start = time.perf_counter()
    c, params, qcfg, load_s, load_peak, resident = load_full(WHISPER["arch"],
                                                             dev)
    n_total = sum(math.prod(sp.shape) for sp in
                  common.tree_leaves(whisper.param_specs(c)))
    bs = ENGINE["block_size"]
    kw = dict(n_slots=ENGINE["n_slots"], block_size=bs,
              max_blocks_per_slot=WHISPER["s_alloc"] // bs)
    prompts = serve.mixed_prompts(WHISPER["requests"], WHISPER["min_prompt"],
                                  WHISPER["max_prompt"], c.vocab_size, SEED + 6)
    frames = serve.enc_frames(c, len(prompts), SEED)
    extras = [{"enc_frames": f} for f in frames]
    print(f"[engine I] {c.name}: {c.n_enc_layers} + {c.n_layers} layers, "
          f"d_model {c.d_model}, {c.n_heads} heads, d_ff {c.d_ff}, tied vocab "
          f"{c.vocab_size}, enc_seq {c.enc_seq}, {n_total / 1e6:.2f} M params; "
          f"load + PTQ {load_s:.1f}s, peak {load_peak:.2f} GB ({resident:.2f} "
          "resident before)", flush=True)
    eng, rids, out, launches, pre, first = slab_engine_run(
        c, params, qcfg, dev, prompts, extras, WHISPER["gen"], "I", resident,
        **kw)
    n_dec = eng.stats()["decode_steps"]
    want = family_sites(c) * len(prompts) + family_sites(c, True) * n_dec
    for k in ("nvfp4_qdq", "nvfp4_matmul"):
        if launches[k] != want:
            fail(f"engine I launched {k} {launches[k]} times, expected "
                 f"{family_sites(c)} a prefill x {len(prompts)} + "
                 f"{family_sites(c, True)} a decode step x {n_dec}")
    print(f"[engine I] K1 and K2 {family_sites(c)} launches a prefill (the "
          f"encoder's 4 x {c.n_enc_layers} and the decoder's 7 x {c.n_layers}) "
          f"and {family_sites(c, True)} a decode step: {want} each", flush=True)
    slab_oracle(eng, rids, prompts, extras, WHISPER["gen"], first, pre, "I")
    try:
        eng.submit(prompts[0], 4)
    except ValueError as e:
        if "extras['enc_frames']" not in str(e):
            fail(f"engine I refused a request without frames with {e}")
        print(f"[engine I] a request without enc_frames is refused: {e}",
              flush=True)
    else:
        fail("engine I took a request without enc_frames")
    # one slot at a time against the static path at the slab's 448
    # positions (serve_batch's prefill and decode steps; its own s_max,
    # prompt + gen, would sum the attention over another length)
    n1 = WHISPER["one_slot"]
    eng1 = Engine(c, params, qcfg, device=dev, **dict(kw, n_slots=1))
    r1, o1 = serve.run_workload(eng1, prompts[:n1], WHISPER["gen"], extras[:n1])
    slab_drained(eng1, "I, one slot")
    sq = eng1.sq
    with torch.inference_mode():
        for rid, p, ex in zip(r1, prompts[:n1], extras[:n1]):
            batch = {"tokens": torch.from_numpy(p[None].astype(np.int64)).to(dev),
                     "enc_frames": torch.as_tensor(ex["enc_frames"], device=dev)[None]}
            lg, cache = whisper.prefill(c, params, batch, sq, WHISPER["s_alloc"])
            toks = [torch.argmax(lg[:, -1:], -1)]
            for _ in range(WHISPER["gen"] - 1):
                lg, cache = whisper.decode_step(c, params, cache,
                                                {"tokens": toks[-1]}, sq)
                toks.append(torch.argmax(lg[:, -1:], -1))
            want_t = torch.cat(toks, 1)[0].cpu().numpy()
            if not np.array_equal(want_t, o1[rid]):
                fail(f"engine I at one slot: request {rid} "
                     f"{o1[rid][:12].tolist()} against the static path's "
                     f"{want_t[:12].tolist()}")
    agree = np.mean([np.mean(out[r] == o1[q]) for r, q in zip(rids, r1)])
    print(f"[engine I] one slot at a time: greedy tokens equal to the static "
          f"path on {n1}/{n1} requests; the 8-slot run's at {agree:.3f} of "
          f"positions (printed)", flush=True)
    trace_slab_step(eng, prompts, "whisper engine", extras)
    # phase 5o's oracle: the first requests' prefill logits and streams
    n_o = RUN_OTP["whisper_requests"]
    oracle = dict(
        arch=WHISPER["arch"], plan=eng.state_plan, what="run I's first",
        prompts=prompts[:n_o], extras=extras[:n_o],
        gen=RUN_OTP["whisper_gen"], engine=kw, fault="x_wqkv",
        pre=[pre[r].cpu() for r in rids[:n_o]],
        tokens=[out[r] for r in rids[:n_o]],
        pool_bytes=eng.stats()["pool_bytes"], whole={"enc_out"},
        **slab_prefill_controls(eng, prompts[:n_o], extras[:n_o]))
    del eng, eng1, params
    print(f"[engine I] {time.perf_counter() - t_start:.1f}s", flush=True)
    return launches, oracle


def phase_5j(dev) -> dict:
    """qwen2-vl-2b at full size, packed, M-RoPE over a 16 x 16 patch grid:
    prefill of 480 tokens and 32 decode steps with their pos3 against
    teacher-forcing ``apply`` over all 512, first with BF16 activations
    (gated at LOGIT_TOL["bf16_act"]: the positions, the splice and the
    cache, with K2 on every packed weight), then with NVFP4 activations in
    per-token scope (printed: over 28 random-weight layers the NVFP4
    rounding amplifies the decode attention's other summation order to
    about 0.6 rel L2, measured); the engine's refusal.  Returns the
    launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models import decoder
    from repro_torch.serve import Engine, UnsupportedStateError
    t_start = time.perf_counter()
    c, params, qcfg, load_s, load_peak, resident = load_full(QWEN_VL["arch"],
                                                             dev)
    b, n, p_len = QWEN_VL["batch"], QWEN_VL["seq"], QWEN_VL["prompt"]
    batch = vlm_batch(c, b, n, QWEN_VL["grid_at"], QWEN_VL["grid"],
                      torch.Generator(device=dev).manual_seed(SEED + 8), dev)
    sq = specs.serve_qconfig(c)
    print(f"[vlm J] {c.name} full size ({c.n_layers} layers, d_model "
          f"{c.d_model}, GQA {c.n_heads}/{c.n_kv_heads} of {c.head_dim}, d_ff "
          f"{c.d_ff}, tied vocab {c.vocab_size}, sections {c.mrope_sections}), "
          f"packed, load {load_s:.1f}s, peak {load_peak:.2f} GB ({resident:.2f} "
          f"resident before); {b} x {n} "
          f"tokens, a {QWEN_VL['grid']} x {QWEN_VL['grid']} grid at "
          f"{QWEN_VL['grid_at']}", flush=True)
    ops.reset_launches()
    worst = {}
    for mode, q in (("bf16_act", dataclasses.replace(
            sq, quantize_activations=False)),
            ("nvfp4", dataclasses.replace(sq, act_scope="token"))):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = decoder.apply(c, params, batch, q)
            torch.cuda.synchronize()
            t_apply = time.perf_counter() - t0
            lg, cache = decoder.prefill(c, params, {k: v[:, :p_len] for k, v
                                                    in batch.items()},
                                        q, s_max=n)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0 - t_apply
            rel, agree = [rel_l2(lg[:, 0], full[:, p_len - 1])], []
            t0 = time.perf_counter()
            for i in range(p_len, n):
                lg, cache = decoder.decode_step(
                    c, params, cache, {"tokens": batch["tokens"][:, i:i + 1],
                                       "pos3": batch["pos3"][:, i:i + 1]}, q)
                rel.append(max(rel_l2(lg[j, 0], full[j, i]) for j in range(b)))
                agree.append(float((lg[:, 0].argmax(-1)
                                    == full[:, i].argmax(-1)).float().mean()))
            torch.cuda.synchronize()
            t_dec = (time.perf_counter() - t0) / (n - p_len)
        worst[mode] = max(rel)
        print(f"[vlm J] {mode}: apply {t_apply * 1e3:.1f} ms, prefill of "
              f"{p_len} {t_pre * 1e3:.1f} ms, decode step {t_dec * 1e3:.2f} ms; "
              f"logits against apply's rel_l2 max {max(rel):.4g} median "
              f"{sorted(rel)[len(rel) // 2]:.4g} over the prefill and "
              f"{n - p_len} decode steps, argmax agreement "
              f"{sum(agree) / len(agree):.3f}"
              + (f" (tolerance {LOGIT_TOL['bf16_act']})" if mode == "bf16_act"
                 else " (printed: the reference's own decode parts from its "
                 "teacher forcing as far; its parity is phase 4's card-vs-CPU "
                 "gate)"), flush=True)
        del full, cache
    if worst["bf16_act"] > LOGIT_TOL["bf16_act"]:
        fail(f"qwen2-vl decode logits differ from apply's by "
             f"{worst['bf16_act']} with BF16 activations")
    launches = dict(ops.launches)
    n_fwd = 2 + (n - p_len)
    want = {"nvfp4_matmul": 2 * family_sites(c) * n_fwd,
            "nvfp4_qdq": family_sites(c) * n_fwd}
    print(f"[vlm J] launches {launches} (expected {want}: {family_sites(c)} "
          f"a forward x {n_fwd} forwards, K1 in the NVFP4 pass alone)",
          flush=True)
    if any(launches[k] != v for k, v in want.items()):
        fail(f"qwen2-vl launched {launches}, expected {want}")
    try:
        Engine(c, params, qcfg, device=dev, **ENGINE)
    except UnsupportedStateError as e:
        if "vision_prefix" not in str(e):
            fail(f"the engine refused qwen2-vl-2b for another reason: {e}")
        print(f"[vlm J] the engine refuses it: [serve] unsupported: {e}",
              flush=True)
    else:
        fail("the engine took qwen2-vl-2b (M-RoPE)")
    del params
    print(f"[vlm J] {time.perf_counter() - t_start:.1f}s", flush=True)
    return launches


def qad_report(label, c, n_all, n_eff, tokens, steps_ms, peak, resident,
               launches, expect, hist, changed):
    """Print a QAD run and hold its launch counts, metrics and student."""
    bound_ms = 10 * n_eff * tokens / BF16_FLOPS * 1e3
    print(f"[{label}] {c.name} ({c.n_layers} layers, {n_all / 1e9:.3f} B "
          f"params), remat={c.remat}: step_ms "
          + " ".join(f"{x:.1f}" for x in steps_ms)
          + f"; bound {bound_ms:.1f} ms (10 N T, N {n_eff / 1e9:.3f} B, T "
          f"{tokens}); peak_mem_gb={peak:.2f} ({resident:.2f} resident "
          "before)", flush=True)
    print(f"[{label}] per-step eval KL " + " ".join(f"{h['kl']:.6g}" for h in hist)
          + " | CE " + " ".join(f"{h['ce']:.5g}" for h in hist)
          + " | train loss " + " ".join(f"{h['loss']:.6g}" for h in hist),
          flush=True)
    print(f"[{label}] launches {launches} (expected {expect}); student "
          f"elements changed: {changed}", flush=True)
    for k, n_want in expect.items():
        if launches[k] != n_want:
            fail(f"{label}: launched {k} {launches[k]} times, expected {n_want}")
    for h in hist:
        if not all(math.isfinite(h[k]) for k in ("kl", "ce", "loss")):
            fail(f"{label}: non-finite metrics {h}")
    if changed == 0:
        fail(f"{label}: the student's parameters did not change")


def phase_6f(dev) -> dict:
    """QAD on rwkv6-3b at full width, cut to RWKV_TRAIN["layers"] of its
    32 layers, through ``launch.train.train``.  Returns the launches."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import common, rwkv6
    t_start = time.perf_counter()
    full = configs.get_config(RWKV["arch"])
    cut = dataclasses.replace(full, n_layers=RWKV_TRAIN["layers"])
    get_config = configs.get_config
    configs.get_config = lambda name: cut if name == RWKV["arch"] else get_config(name)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        state, hist = train.train(RWKV["arch"], smoke=False,
                                  steps=RWKV_TRAIN["steps"], lr=TRAIN["lr"],
                                  method="qad", batch=RWKV_TRAIN["batch"],
                                  seq=RWKV_TRAIN["seq"], eval_every=1,
                                  seed=SEED, device=dev,
                                  log=lambda msg: print(msg, flush=True))
    finally:
        configs.get_config = get_config
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    specs_ = rwkv6.param_specs(cut)
    n_all = sum(math.prod(sp.shape) for sp in common.tree_leaves(specs_))
    n_eff = n_all - math.prod(specs_["embed"].shape)
    steps, evals = RWKV_TRAIN["steps"], 2 * RWKV_TRAIN["steps"]
    per_fwd = 2 * family_sites(cut)
    expect = {"nvfp4_qdq": per_fwd * ((1 if cut.remat == "none" else 2) * steps
                                      + evals),
              "kl_loss": steps + evals, "kl_loss_bwd": steps,
              "nvfp4_matmul": 0, "paged_attention": 0}
    changed = sum(int((a != b).sum()) for a, b in zip(
        common.tree_leaves(state.student), common.tree_leaves(state.teacher)))
    qad_report("train-rwkv6", cut, n_all, n_eff,
               RWKV_TRAIN["batch"] * RWKV_TRAIN["seq"],
               [h["step_s"] * 1e3 for h in hist],
               torch.cuda.max_memory_allocated() / 1e9, resident, launches,
               expect, hist, changed)
    del state, hist
    print(f"[train-rwkv6] {time.perf_counter() - t_start:.1f}s", flush=True)
    return launches


def phase_6g(dev) -> dict:
    """QAD on qwen2-vl-2b at full size through ``core.qad.make_train_step``
    on VLM batches (5j's layout, one grid a sequence), an eval after each
    step.  Returns the launches."""
    import torch

    from repro_torch import configs
    from repro_torch.core import qad
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models import common, decoder
    from repro_torch.optim import AdamW, warmup_cosine
    t_start = time.perf_counter()
    c = configs.get_config(QWEN_VL["arch"])
    b, n, steps = VL_TRAIN["batch"], VL_TRAIN["seq"], VL_TRAIN["steps"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)

    def vl_train_batch():
        vb = vlm_batch(c, b, n, QWEN_VL["grid_at"], QWEN_VL["grid"], gen, dev)
        vb["labels"] = torch.randint(4, c.vocab_size, (b, n), generator=gen,
                                     device=dev)
        vb["mask"] = torch.ones((b, n), device=dev)
        return vb

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    opt = AdamW(lr=warmup_cosine(TRAIN["lr"], 0, steps), clip_norm=1.0)
    with torch.no_grad():
        state = qad.init_state(decoder, c, torch.Generator(device=dev)
                               .manual_seed(SEED), opt, device=dev)
    qc = specs.recipe_qconfig(c)
    step_fn = qad.make_train_step(decoder, c, qc, opt)
    eval_fn = qad.make_eval_step(decoder, c, qc)
    held = vl_train_batch()
    ops.reset_launches()
    hist = []
    for _ in range(steps):
        batch = vl_train_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ev = eval_fn(state, held)
        hist.append({"kl": float(ev["kl"]), "ce": float(ev["ce"]),
                     "loss": float(m["loss"]), "step_s": dt})
    launches = dict(ops.launches)
    n_all = sum(math.prod(sp.shape) for sp in
                common.tree_leaves(decoder.param_specs(c)))
    per_fwd = 2 * family_sites(c)
    expect = {"nvfp4_qdq": per_fwd * ((1 if c.remat == "none" else 2) * steps
                                      + steps),
              "kl_loss": 2 * steps, "kl_loss_bwd": steps, "nvfp4_matmul": 0,
              "paged_attention": 0}
    changed = sum(int((x != y).sum()) for x, y in zip(
        common.tree_leaves(state.student), common.tree_leaves(state.teacher)))
    # the tied embedding counts once, as the unembedding's GEMM
    qad_report("train-vlm", c, n_all, n_all, b * n,
               [h["step_s"] * 1e3 for h in hist],
               torch.cuda.max_memory_allocated() / 1e9, resident, launches,
               expect, hist, changed)
    del state
    print(f"[train-vlm] {time.perf_counter() - t_start:.1f}s", flush=True)
    return launches


def local_amax_mesh(mesh):
    """A planted fault: ``mesh`` whose data group's max all-reduce returns
    each rank's own value, so every activation's NVFP4 tensor scale comes
    from the rank's rows alone (every other collective as it was)."""
    from repro_torch.distributed.ctx import TP

    class Local(TP):
        def all_reduce(self, x, op="sum"):
            return x if op == "max" else super().all_reduce(x, op)
    d = mesh.data
    return dataclasses.replace(mesh, data=Local(
        group=d.group, rank=d.rank, size=d.size, device=d.device))


def flat_paths(tree, path: str = "") -> dict:
    """{dotted path: leaf} of a nested dict (empty dicts dropped)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_paths(tree[k], f"{path}.{k}" if path else k))
        return out
    return {path: tree}


def leaf_digest(x):
    """Two int64 sums over a tensor's bits (plain, and weighted by position)
    that equal bitwise-equal tensors' and, in practice, only theirs."""
    import torch
    d = x.contiguous().view(torch.int16 if x.element_size() == 2
                            else torch.int32).reshape(-1).to(torch.int64)
    w = torch.arange(d.numel(), device=d.device) % 65521 + 1
    return torch.stack([d.sum(), (d * w).sum()])


def replicas_differ(mesh, state, places, replicated=None) -> list:
    """The leaves of the student and the moments whose stored shard is not
    bitwise equal on the ranks that hold the same piece (checked over the
    data group where the leaf does not split over data, and over the model
    group where it does not split over model; with ``replicated``,
    ``sharding.replicated_tree``, also the columns of a model tile that
    every model rank holds: an MQA fused QKV tile's KV head)."""
    bad = []
    cols = flat_paths(replicated) if replicated is not None else {}
    for name, tree in (("student", state.student), ("m", state.opt_state.m),
                       ("v", state.opt_state.v)):
        pls = flat_paths(places)
        for path, x in flat_paths(tree).items():
            pl = pls[path]
            checks = [(leaf_digest(x), mesh.data, pl.data_dim),
                      (leaf_digest(x), mesh.model, pl.model_dim)]
            if cols.get(path) is not None:
                checks.append((leaf_digest(x[..., cols[path]]), mesh.model,
                               None))
            for dg, tp, split in checks:
                if split is None and tp.size > 1:
                    every = tp.all_gather(dg[None], 0)
                    if not bool((every == every[0]).all()):
                        bad.append(f"{name}.{path}")
    return bad


def shard_rel_l2(mesh, cfg, specs, places, rules, mine, ref, base=None):
    """The relative L2 over the whole model, and by leaf, of a tree of this
    rank's stored shards ``mine`` (less ``base``, shards too) against a
    one-card tree of whole leaves ``ref`` on the host (less ``base``),
    each rank cutting its own shards of ``ref``: each shard's sums
    weighted by 1 / its replication, summed over every rank."""
    import torch

    from repro_torch.distributed import sharding
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    sp, pl, ref = flat_paths(specs), flat_paths(places), flat_paths(ref)
    base = flat_paths(base) if base is not None else {}
    paths, sums = [], []
    for path, x in flat_paths(mine).items():
        r = sharding.shard_tensor(sp[path], ref[path], mesh, rules, path,
                                  heads).to(mesh.device).float()
        u = x.float()
        if path in base:
            u, r = u - base[path].float(), r - base[path].float()
        w = 1.0 / sharding.replication(pl[path], mesh.shape)
        paths.append(path)
        sums.append(w * torch.stack([torch.sum((u - r) ** 2),
                                     torch.sum(r * r)]))
        del r, u
    sums = mesh.world.all_reduce(torch.stack(sums)).cpu()
    total = sums.sum(0)

    def rel(v):
        """A relative L2 (0 where both are zero: a norm's weights, which
        a step of lr moves by less than a bf16 ulp on one card and the
        mesh alike)."""
        if float(v[1]) == 0.0:
            return 0.0 if float(v[0]) == 0.0 else math.inf
        return float(torch.sqrt(v[0] / v[1]))
    return rel(total), {p: rel(v) for p, v in zip(paths, sums)}


def state_digests(state) -> dict:
    """``leaf_digest`` of every leaf of a ``TrainState``'s student, teacher
    and moments, by path (host lists)."""
    trees = (("student", state.student), ("teacher", state.teacher),
             ("m", state.opt_state.m), ("v", state.opt_state.v))
    return {f"{name}.{path}": leaf_digest(x).tolist()
            for name, tree in trees for path, x in flat_paths(tree).items()}


@contextlib.contextmanager
def own_expert_amax():
    """A planted fault: ``core.qad._tile_amaxes`` whose expert-stack
    entries hold each rank's own tile's amax (no maximum over the model
    group)."""
    import torch

    from repro_torch.core import qad
    from repro_torch.distributed import ctx, sharding

    keep = qad._tile_amaxes

    def faulty(tiles, plan, qcfg, mesh, rules):
        table = keep(tiles, plan, qcfg, mesh, rules)
        for name in sharding.EXPERT_STACKS:
            t = tiles["layers"][name]
            for i in range(t.shape[0]):
                key = ctx.tile_key(t[i])
                if key in table:
                    table[key] = torch.amax(torch.abs(t[i].float()))
        return table
    qad._tile_amaxes = faulty
    try:
        yield
    finally:
        qad._tile_amaxes = keep


def mesh_train_run(mesh, cfg, rule, steps, one_file, log, fault=None,
                   eval_every=0, batch=None, seq=None, tile_fault=False,
                   **opts) -> dict:
    """One run of the training mesh's path on this rank:
    ``launch.train.train_on_mesh`` (``TRAIN``'s batch, lr and seed unless
    ``batch``/``seq`` are given, an eval every ``eval_every`` steps and
    after the last, none at 0; ``opts`` passed on: ``method``,
    ``ckpt_dir``, ``numerics``); its history and report, the update's
    relative L2 against the one-card run in ``one_file`` (when given),
    the leaves whose replicas differ, the digests of this rank's final
    shards, the seconds.  ``fault`` wraps the mesh; ``tile_fault`` plants
    ``own_expert_amax``."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    with own_expert_amax() if tile_fault else contextlib.nullcontext():
        state, hist, rep = train.train_on_mesh(
            mesh if fault is None else fault(mesh), cfg, rule, steps=steps,
            lr=TRAIN["lr"], batch=batch or TRAIN["batch"],
            seq=seq or TRAIN["seq"], eval_every=eval_every, seed=SEED,
            log=log, **opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    specs = get_model(cfg).param_specs(cfg)
    table = sharding.make_rules(rule)
    places = sharding.placements(specs, mesh.shape, table)
    out = dict(history=hist, report=rep, seconds=secs, layers=cfg.n_layers,
               remat=cfg.remat, rule=rule, fault=fault is not None or tile_fault,
               qdq_fwd=student_qdqs(cfg), evals=len(hist),
               replicas_differ=replicas_differ(
                   mesh, state, places, sharding.replicated_tree(
                       specs, places, mesh.shape,
                       (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim))),
               digests=state_digests(state), update_rel=None, moment_rel=None)
    if one_file is not None:
        # the update (final - initial, the initial weights the teacher's)
        # and, where the file holds it, AdamW's first moment
        one = torch.load(one_file, mmap=True, weights_only=True)
        out["update_rel"], out["update_leaves"] = shard_rel_l2(
            mesh, cfg, specs, places, table, state.student, one["student"],
            state.teacher)
        if "m" in one:
            out["moment_rel"], out["moment_leaves"] = shard_rel_l2(
                mesh, cfg, specs, places, table, state.opt_state.m, one["m"])
        del one
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_fault_loss(mesh, cfg) -> dict:
    """The planted fault at full depth: the seed-0 student's KL at its
    initial weights on step 1's batch (what step 1's train loss is: a
    forward alone, the eval step) on ``mesh`` with each rank's own
    activation amax (``local_amax_mesh``), under ``fsdp_tp``; its
    launches and seconds."""
    import torch

    from repro_torch.core import qad
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models import get_model
    from repro_torch.optim import AdamW

    t0 = time.perf_counter()
    model, rules = get_model(cfg), sharding.make_rules("fsdp_tp")
    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    with torch.no_grad():
        state = qad.init_state_on_mesh(model, cfg, gen, AdamW(), mesh, rules)
    batch = make_batch(DataConfig(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"],
                                  seed=SEED), 0, device=mesh.device)
    ops.reset_launches()
    ev = qad.make_eval_step(model, cfg, specs.recipe_qconfig(cfg),
                            mesh=local_amax_mesh(mesh), rules=rules)(state,
                                                                     batch)
    out = dict(loss=float(ev["kl"]), launches=dict(ops.launches),
               seconds=time.perf_counter() - t0)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_mesh_rank(mesh, tcfg, ccut, full_file, cut_file, work,
                    mcut=None, slab: bool = False) -> dict:
    """One rank of phase 6h (its own process): run 2 first (each rule and
    the planted fault, ``local_amax_mesh``, on the copy ``ccut`` cut in
    depth, one step each against the parent's one-card step on the cut);
    the three options on the cut under ``fsdp_tp`` (the probes with a
    checkpoint, a resume from it and an uninterrupted run, the chunked
    KL); MoE QAD on ``mcut`` (experts on E, on their FFN dim, the planted
    expert-amax fault) against the parent's one-card step files in
    ``work``; with ``slab``, each ``MESH_SLAB`` config's step and its
    planted fault (``slab_mesh_run``) against the parent's one-card step
    files in ``work``; then run 1, ``fsdp_tp`` on full-size olmo-1b for
    ``TRAIN``'s steps against phase 6's update; then the fault at full
    depth (``mesh_fault_loss``).  Host data only."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    quiet = lambda msg: None
    log = ((lambda msg: print(f"[train-mesh] rank 0: {msg}", flush=True))
           if mesh.rank == 0 else quiet)
    runs = {}
    for rule in MESH_TRAIN["rules"]:
        runs[f"cut/{rule}"] = mesh_train_run(mesh, ccut, rule, 1, cut_file,
                                             quiet)
    runs["cut/fault"] = mesh_train_run(mesh, ccut, "fsdp_tp", 1, cut_file,
                                       quiet, local_amax_mesh)
    ckpt = os.path.join(work, "mesh_ckpt")
    runs["cut/fsdp_tp"] = mesh_train_run(mesh, ccut, "fsdp_tp", 1, cut_file,
                                         quiet, eval_every=1, numerics=True,
                                         ckpt_dir=ckpt)
    runs["ckpt/resumed"] = mesh_train_run(mesh, ccut, "fsdp_tp", 2, None,
                                          quiet, ckpt_dir=ckpt)
    runs["ckpt/straight"] = mesh_train_run(mesh, ccut, "fsdp_tp", 2, None,
                                           quiet)
    runs["chunked"] = mesh_train_run(
        mesh, ccut, "fsdp_tp", 1, os.path.join(work, "chunked_state.pt"),
        quiet, method="qad_chunked")
    if mcut is not None:
        moe_file = os.path.join(work, "moe_state.pt")
        moe = dict(batch=MESH_MOE["batch"], seq=MESH_MOE["seq"])
        runs["moe/ep"] = mesh_train_run(mesh, mcut, "fsdp_tp", 1, moe_file,
                                        quiet, **moe)
        runs["moe/tp"] = mesh_train_run(
            mesh, dataclasses.replace(mcut, moe_shard="tp"), "fsdp_tp", 1,
            moe_file, quiet, **moe)
        runs["moe/fault"] = mesh_train_run(mesh, mcut, "fsdp_tp", 1,
                                           moe_file, quiet, tile_fault=True,
                                           **moe)
    for arch in MESH_SLAB if slab else ():
        c, f = slab_cfg(arch), os.path.join(work, f"slab_{arch}.pt")
        runs[f"slab/{arch}"] = slab_mesh_run(mesh, c, f)
        if arch in MESH_SLAB_FAULTS:
            runs[f"slab/{arch}/fault"] = slab_mesh_run(
                mesh, c, f, MESH_SLAB_FAULTS[arch])
    # run 1 evaluates after its last step (phase 6 after each)
    runs["full"] = mesh_train_run(mesh, tcfg, "fsdp_tp", TRAIN["steps"],
                                  full_file, log,
                                  eval_every=TRAIN["steps"])
    return {"runs": runs, "full_fault": mesh_fault_loss(mesh, tcfg),
            "coords": mesh.coords}


def student_qdqs(c) -> int:
    """K1 launches of one student forward of ``c`` under its recipe, an
    activation and a weight at each quantized GEMM site: 10 a dense
    decoder layer (``family_sites``: olmo-1b's, qwen2-vl-2b's), 15 a
    qwen2-moe layer (as phase 6b counts them), an RG-LRU hybrid's by
    ``rec_sites`` (phase 6e's), RWKV6's and whisper's by
    ``family_sites`` (phase 6f's; 5i's)."""
    from repro_torch.launch import specs
    if c.family == "rglru_hybrid":
        per_rec, per_attn, n_rec, n_attn = rec_sites(
            c, specs.recipe_qconfig(c))
        return 2 * (per_rec * n_rec + per_attn * n_attn)
    if c.n_experts:
        return 15 * c.n_layers
    return 2 * family_sites(c)


def mesh_launches(per_fwd: int, steps: int, n_evals: int,
                  chunked: bool = False, remat: str = "full") -> dict:
    """K1, K5 and K6 launches a rank of a mesh run should count: the
    student's QDQs a forward (``per_fwd``, ``student_qdqs``), twice a
    train step under remat "full", once each of the two eval batches at
    each of its ``n_evals`` evals; one KL forward a step and an eval
    batch, one KL backward a step (the chunked KL of ``qad_chunked`` is
    plain torch: no KL kernel in its steps)."""
    evals = 2 * n_evals
    kl = 0 if chunked else steps
    fwd = 1 if remat == "none" else 2
    return {"nvfp4_qdq": per_fwd * (fwd * steps + evals),
            "kl_loss": kl + evals, "kl_loss_bwd": kl}


def cut_tree(cut, specs, tree, head: str):
    """A ``TrainState`` tree's shards by ``cut`` (``core.qad.
    shard_cutter``: ``head`` the checkpoint path's first names)."""
    names = tuple(head.split("/"))
    out = {}
    for path, x in flat_paths(tree).items():
        node, keys = out, path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = cut(names + tuple(keys), x)
    return out


# the layer stacks of every family (a decoder's and RWKV6's; an RG-LRU
# hybrid's super-blocks and trailing recurrent layers; whisper's encoder and
# decoder)
STACKS = ("layers", "blocks", "rem", "enc_layers", "dec_layers")


def layers_moment(run, part: str = "moment") -> float:
    """The largest first-moment (or, ``part="update"``, update) relative L2
    over the layer stacks' leaves (the embedding's gradient sums its rows'
    tokens in another order)."""
    return max(v for k, v in run[f"{part}_leaves"].items()
               if k.split(".")[0] in STACKS)


def numerics_gaps(mine: dict, want: dict) -> dict:
    """Each stat's largest gap (``MESH_NUMERICS_TOL``'s kind) between two
    snapshots' per-layer numerics; raises unless they hold the same
    sites and stats."""
    if sorted(mine) != sorted(want):
        fail(f"phase 6h numerics: the mesh's sites {sorted(mine)[:4]}... are "
             f"not one card's {sorted(want)[:4]}...")
    gaps = {}
    for site, stats in want.items():
        if sorted(mine[site]) != sorted(stats):
            fail(f"phase 6h numerics: {site} holds {sorted(mine[site])}, one "
                 f"card {sorted(stats)}")
        for k, v in stats.items():
            kind, _ = MESH_NUMERICS_TOL[k]
            g = abs(mine[site][k] - v)
            if kind == "rel":
                g /= max(abs(v), 1e-30)
            if g >= gaps.get(k, (0.0, ""))[0]:
                gaps[k] = (g, site)
    return gaps


def mesh_options_gates(ranks, ccut, khist, one_numerics, restored,
                       restored_step, restore_s) -> None:
    """Phase 6h's gates and lines of the three options on the cut: the
    chunked KL against one card's, the probes (every rank's summary equal,
    each stat within ``MESH_NUMERICS_TOL`` of one card's) and their cost,
    the resume (bitwise the uninterrupted run on every rank) and the
    checkpoint restored on one card (bitwise the gathered shards)."""
    r0 = ranks[0]["runs"]
    ck = r0["chunked"]
    k_rel = abs(ck["report"]["loss"][0] - khist[0]["loss"]) / abs(khist[0]["loss"])
    k_mom = layers_moment(ck)
    print(f"[train-mesh] cut, qad_chunked (fsdp_tp, the vocabulary split over "
          f"the model group): loss {ck['report']['loss'][0]:.7g} (one card "
          f"{khist[0]['loss']:.7g}), rel {k_rel:.3g}; update rel L2 "
          f"{ck['update_rel']:.4g}; layers' first moment rel L2 {k_mom:.4g}; "
          f"step ms {ck['report']['step_s'][0] * 1e3:.1f}", flush=True)
    if (k_rel > MESH_TOL["cut_loss"] or ck["update_rel"] > MESH_TOL["update"]
            or k_mom > MESH_TOL["moment"]):
        fail(f"phase 6h chunked: loss rel {k_rel:.3g}, update "
             f"{ck['update_rel']:.3g}, moment {k_mom:.3g} outside {MESH_TOL}")
    # the probes
    num = r0["cut/fsdp_tp"]["report"]["numerics"]
    for r in ranks:
        if r["runs"]["cut/fsdp_tp"]["report"]["numerics"] != num:
            fail(f"phase 6h numerics: rank {r['coords']}'s snapshot differs "
                 "from rank 0's")
    gaps = numerics_gaps(num["per_layer"], one_numerics)
    on_ms = r0["cut/fsdp_tp"]["report"]["step_s"][0] * 1e3
    off_ms = r0["ckpt/straight"]["report"]["step_s"][0] * 1e3
    print(f"[train-mesh] cut, numerics probes (fsdp_tp, step 1): every rank's "
          f"snapshot equal ({len(num['per_layer'])} per-layer sites, SQNR min "
          f"{num['sqnr_db_min']:.3f} dB); largest gap to one card by stat "
          + ", ".join(f"{k} {v:.3g} ({site})"
                      for k, (v, site) in sorted(gaps.items()))
          + f" (limits {MESH_NUMERICS_TOL}); step ms with the probes "
          f"{on_ms:.1f}, without {off_ms:.1f} (x{on_ms / off_ms:.2f})",
          flush=True)
    for k, (g, site) in gaps.items():
        if g > MESH_NUMERICS_TOL[k][1]:
            fail(f"phase 6h numerics: {k} at {site} parts from one card's "
                 f"by {g:.3g}")
    # the resume and the checkpoint
    for r in ranks:
        runs = r["runs"]
        if runs["ckpt/resumed"]["report"]["start"] != 1:
            fail(f"phase 6h resume: rank {r['coords']} resumed from step "
                 f"{runs['ckpt/resumed']['report']['start']}, not 1")
        bad = [k for k, v in runs["ckpt/straight"]["digests"].items()
               if runs["ckpt/resumed"]["digests"][k] != v]
        if bad:
            fail(f"phase 6h resume: rank {r['coords']}'s step 2 differs from "
                 f"the uninterrupted run's in {bad[:4]}")
    for r in ranks:
        mine = r["runs"]["cut/fsdp_tp"]["digests"]
        bad = [k for k, v in mine.items() if restored[tuple(
            r["coords"].values())].get(k) != v]
        if restored_step != 1 or bad:
            fail(f"phase 6h checkpoint: one card restored step "
                 f"{restored_step}; rank {r['coords']}'s shards of it differ "
                 f"from the rank's own in {bad[:4]}")
    res = r0["ckpt/resumed"]
    print(f"[train-mesh] cut, checkpoint: step 1 written by rank 0 (the "
          f"whole state gathered, {r0['cut/fsdp_tp']['seconds']:.1f} s for "
          f"the run), resumed on every rank ({res['seconds']:.1f} s for the "
          f"resume and step 2): step 2 bitwise the uninterrupted run's "
          f"(probes off) on every rank; restored on one card in "
          f"{restore_s:.1f} s: each rank's shards of it (cut on one card) "
          "bitwise the rank's own", flush=True)


def mesh_moe_gates(ranks, mcut, mhist) -> None:
    """Phase 6h's MoE runs against one card's step on the cut: the loss,
    the update and the layers' first moment within ``MESH_MOE_TOL``, the
    planted fault outside on the update and the moment."""
    r0 = ranks[0]["runs"]
    read = {}
    for key in ("moe/ep", "moe/tp", "moe/fault"):
        run = r0[key]
        rel = abs(run["report"]["loss"][0] - mhist[0]["loss"]) / abs(mhist[0]["loss"])
        read[key] = dict(loss=rel, update=run["update_rel"],
                         moment=layers_moment(run))
        c = run["report"]["collectives"][-1]
        print(f"[train-mesh] {mcut.name} at full width, {mcut.n_layers} of 24 "
              f"layers, {MESH_MOE['batch']} x {MESH_MOE['seq']}, fsdp_tp, "
              f"{key[4:]}{' (planted fault: each rank own expert amax)' if run['fault'] else ''}: "
              f"loss {run['report']['loss'][0]:.7g} (one card "
              f"{mhist[0]['loss']:.7g}), rel {rel:.3g}; update rel L2 "
              f"{run['update_rel']:.4g}; layers' first moment rel L2 "
              f"{read[key]['moment']:.4g}; step ms "
              f"{run['report']['step_s'][0] * 1e3:.1f} ({run['seconds']:.1f} "
              "s for the run); collectives "
              + ", ".join(f"{g} {v['calls']} ({v['seconds']:.3f} host s)"
                          for g, v in c.items())
              + "; by leaf, update " + " ".join(
                  f"{k} {v:.3g}" for k, v in run["update_leaves"].items()),
              flush=True)
    for key in ("moe/ep", "moe/tp"):
        if any(read[key][k] > MESH_MOE_TOL[k] for k in MESH_MOE_TOL):
            fail(f"phase 6h {key}: {read[key]} outside {MESH_MOE_TOL}")
    if not (read["moe/fault"]["update"] > MESH_MOE_TOL["update"]
            and read["moe/fault"]["moment"] > MESH_MOE_TOL["moment"]):
        fail(f"phase 6h MoE planted fault reads {read['moe/fault']}, inside "
             f"{MESH_MOE_TOL}")


def slab_cfg(arch: str):
    """A config of phase 6h's slab run: ``arch`` at full width, cut in
    depth by ``MESH_SLAB``."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch), **MESH_SLAB[arch])


def slab_batch(c, device) -> dict:
    """The global batch of ``c``'s slab run, drawn on the card from the
    seed (every rank and the one-card oracle draw the same): tokens,
    labels and a full mask of ``MESH_SLAB_BATCH``; whisper's with its
    encoder frames [B, 1500, d_model] (the stub's embeddings); the VLM's
    in 5j's layout (``vlm_batch``: one 16 x 16 patch grid a sequence,
    ``pos3``, ``vis_embeds``, ``vis_mask``)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    b = MESH_SLAB_BATCH["batch"]
    n = MESH_SLAB_BATCH["whisper_seq" if c.family == "encdec" else "seq"]
    if c.mrope_sections:
        out = vlm_batch(c, b, n, QWEN_VL["grid_at"], QWEN_VL["grid"], gen,
                        device)
    else:
        out = {"tokens": torch.randint(4, c.vocab_size, (b, n), generator=gen,
                                       device=device)}
    out["labels"] = torch.randint(4, c.vocab_size, (b, n), generator=gen,
                                  device=device)
    out["mask"] = torch.ones((b, n), device=device)
    if c.family == "encdec":
        out["enc_frames"] = torch.randn((b, c.enc_seq, c.d_model),
                                        generator=gen, device=device)
    return out


def slab_opt():
    """The slab run's optimizer (``train.train``'s for one step)."""
    from repro_torch.optim import AdamW, warmup_cosine
    return AdamW(lr=warmup_cosine(TRAIN["lr"], 0, 1), clip_norm=1.0)


def stacks(tree) -> dict:
    """A parameter tree's layer stacks (``STACKS``): what the slab run
    compares (the embedding's gradient sums its rows' tokens in another
    order on one card)."""
    return {k: v for k, v in tree.items() if k in STACKS}


def slab_one_card(dev, c, file) -> float:
    """A slab run's oracle, in the parent before the spawn: one card's
    step of ``c`` on its batch from the seed's draw, the layer stacks of
    the student and of AdamW's first moment written to ``file``; its
    loss."""
    import torch

    from repro_torch.core import qad
    from repro_torch.launch import specs
    from repro_torch.models import get_model
    model, opt = get_model(c), slab_opt()
    with torch.no_grad():
        state = qad.init_state(model, c, torch.Generator(device=dev)
                               .manual_seed(SEED), opt, device=dev)
    step = qad.make_train_step(model, c, specs.recipe_qconfig(c), opt)
    state, m = step(state, slab_batch(c, dev))
    torch.save({"student": to_host(stacks(state.student)),
                "m": to_host(stacks(state.opt_state.m))}, file)
    loss = float(m["loss"])
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return loss


@contextlib.contextmanager
def forward_only(fault: str | None):
    """A planted fault of the slab run, for the duration: "gates", the
    RG-LRU gates' reduce-scatter with no backward (``ctx.
    scatter_from_model``: only the gates call it); "receptance", RWKV6's
    channel-mix receptance gather with no backward (``rwkv6.
    _gather_receptance``).  Neither changes the forward."""
    from repro_torch.distributed import ctx
    from repro_torch.models import rwkv6
    if fault is None:
        yield
        return
    if fault == "gates":
        owner, attr = ctx, "scatter_from_model"

        def fn(x, tp, dim=-1):
            return tp.reduce_scatter(x.detach(), dim)
    else:
        owner, attr = rwkv6, "_gather_receptance"

        def fn(r):
            return ctx.current().all_gather(r.detach(), -1)
    keep = getattr(owner, attr)
    setattr(owner, attr, fn)
    try:
        yield
    finally:
        setattr(owner, attr, keep)


def slab_mesh_run(mesh, c, one_file, fault=None) -> dict:
    """One slab run on this rank: ``core.qad.make_train_step(mesh=,
    rules=)`` under ``fsdp_tp``, one step of ``c`` on its global batch
    (``slab_batch``: the step keeps the data rank's rows) from the seed's
    draw cut to this rank's shards, ``fault`` planted
    (``forward_only``).  The same record as ``mesh_train_run``'s: the
    metrics, the report (launches, collectives by group, stored bytes and
    their share, step seconds, the peak), the update's and the first
    moment's relative L2 over the layer stacks against the one-card step
    in ``one_file``, the leaves whose replicas differ."""
    import torch

    from repro_torch.core import qad
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, opt = get_model(c), slab_opt()
    rules = sharding.make_rules("fsdp_tp")
    with torch.no_grad():
        state = qad.init_state_on_mesh(
            model, c, torch.Generator(device=mesh.device).manual_seed(SEED),
            opt, mesh, rules)
    step = qad.make_train_step(model, c, specs.recipe_qconfig(c), opt,
                               mesh=mesh, rules=rules)
    batch = slab_batch(c, mesh.device)
    ops.reset_launches()
    mesh.reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with forward_only(fault):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    counts, launches = mesh.counts(), dict(ops.launches)
    specs_ = model.param_specs(c)
    places = sharding.placements(specs_, mesh.shape, rules)
    heads = (c.n_heads, c.n_kv_heads, c.head_dim)
    share = lambda tree: sharding.stored_share(tree, specs_, places, heads,
                                               mesh.shape)
    report = {"launches": launches, "collectives": [counts],
              "loss": [float(m["loss"])], "step_s": [step_s], "bytes": {
                  "student": share(state.student),
                  "teacher": share(state.teacher),
                  "moments": tuple(map(sum, zip(*(
                      share(t) for t in state.opt_state))))},
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    one = torch.load(one_file, mmap=True, weights_only=True)
    upd, upd_leaves = shard_rel_l2(mesh, c, specs_, places, rules,
                                   stacks(state.student), one["student"],
                                   stacks(state.teacher))
    mom, mom_leaves = shard_rel_l2(mesh, c, specs_, places, rules,
                                   stacks(state.opt_state.m), one["m"])
    del one
    out = dict(history=[{k: float(v) for k, v in m.items()}], report=report,
               seconds=time.perf_counter() - t0, layers=c.n_layers,
               remat=c.remat, rule="fsdp_tp", fault=fault is not None,
               qdq_fwd=student_qdqs(c), evals=0,
               replicas_differ=replicas_differ(
                   mesh, state, places, sharding.replicated_tree(
                       specs_, places, mesh.shape, heads)),
               update_rel=upd, update_leaves=upd_leaves, moment_rel=mom,
               moment_leaves=mom_leaves)
    del state, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_slab_gates(ranks, losses: dict, card: str) -> None:
    """Phase 6h's slab runs against one card's step on the same cut (the
    parent's ``losses`` by arch): the loss, the layer stacks' largest
    leaf update and first moment within ``MESH_SLAB_TOL``; each planted
    fault outside on the update or the moment."""
    r0 = ranks[0]["runs"]
    read = {}
    for key in [k for k in r0 if k.startswith("slab/")]:
        run, arch = r0[key], key.split("/")[1]
        want = losses[arch]
        rel = abs(run["report"]["loss"][0] - want) / abs(want)
        read[key] = dict(loss=rel, update=layers_moment(run, "update"),
                         moment=layers_moment(run))
        c = run["report"]["collectives"][-1]
        gb = {p: held / 1e9 for p, (held, _) in run["report"]["bytes"].items()}
        print(f"[train-mesh] slab {arch} at full width, {run['layers']} "
              f"layers, fsdp_tp"
              + (f", planted fault ({MESH_SLAB_FAULTS[arch]} forward-only)"
                 if run["fault"] else "")
              + f": loss {run['report']['loss'][0]:.7g} (one card "
              f"{want:.7g}), rel {rel:.3g}; layers' largest leaf update rel "
              f"L2 {read[key]['update']:.4g}, first moment "
              f"{read[key]['moment']:.4g} (the stacks' whole update "
              f"{run['update_rel']:.4g}, moment {run['moment_rel']:.4g}); step ms "
              f"{run['report']['step_s'][0] * 1e3:.1f} ({run['seconds']:.1f} s "
              "for the run); collectives "
              + ", ".join(f"{g} {v['calls']} ({v['seconds']:.3f} host s)"
                          for g, v in c.items())
              + "; stored GB a rank student {student:.3f} teacher {teacher:.3f}"
              " moments {moments:.3f}".format(**gb)
              + "; peak GB a rank " + " ".join(
                  f"{r['runs'][key]['report']['peak_gb']:.2f}" for r in ranks)
              + f"; card {card}; by leaf, update " + " ".join(
                  f"{k} {v:.3g}" for k, v in run["update_leaves"].items())
              + ", moment " + " ".join(
                  f"{k} {v:.3g}" for k, v in run["moment_leaves"].items()),
              flush=True)
    lim = MESH_SLAB_TOL
    for key, rd in read.items():
        if key.endswith("/fault"):
            if rd["loss"] > lim["loss"] or not (rd["update"] > lim["update"]
                                                 or rd["moment"] > lim["moment"]):
                fail(f"phase 6h {key}: the planted fault reads {rd}, inside "
                     f"{lim} (or its loss outside)")
        elif any(rd[k] > lim[k] for k in lim):
            fail(f"phase 6h {key}: {rd} outside {lim}")


def phase_6h(dev, tcfg, p6_hist, full_file, work) -> dict:
    """Phase 6h in the parent: the one-card step on the cut copy (the
    oracle of run 2, written to ``work``), the spawn of the (2, 2) mesh's
    four ranks (``train_mesh_rank``), then every gate and the readings."""
    import torch

    from repro_torch import configs
    from repro_torch.core import qad
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train
    from repro_torch.models import get_model

    t_phase = time.perf_counter()
    ccut = dataclasses.replace(tcfg, n_layers=MESH_TRAIN["cut_layers"])
    mcut = dataclasses.replace(configs.get_config(MOE_ARCH),
                               n_layers=MESH_MOE["layers"])

    def one_card(c, file, **kw):
        """``train.train`` on the cut config ``c`` for one step (an eval
        after it): its state's student and first moment saved to ``file``
        in ``work``, its history."""
        get_config = configs.get_config
        configs.get_config = lambda name: c if name == c.name else get_config(name)
        try:
            st, h = train.train(c.name, smoke=False, steps=1, lr=TRAIN["lr"],
                                eval_every=1, seed=SEED, device=dev,
                                log=lambda msg: None, **kw)
        finally:
            configs.get_config = get_config
        torch.save({"student": to_host(st.student),
                    "m": to_host(st.opt_state.m)}, os.path.join(work, file))
        del st
        gc.collect()
        torch.cuda.empty_cache()
        return h

    # the oracles: the cut's step with the probes on (its state is the
    # probe-free step's), its chunked-KL step, the MoE cut's step
    snap_file = os.path.join(work, "cut_numerics.json")
    chist = one_card(ccut, "cut_state.pt", batch=TRAIN["batch"],
                     seq=TRAIN["seq"], numerics=True, metrics_out=snap_file)
    with open(snap_file) as f:
        one_numerics = json.load(f)["numerics"]["per_layer"]
    khist = one_card(ccut, "chunked_state.pt", batch=TRAIN["batch"],
                     seq=TRAIN["seq"], method="qad_chunked")
    mhist = one_card(mcut, "moe_state.pt", batch=MESH_MOE["batch"],
                     seq=MESH_MOE["seq"])
    t0 = time.perf_counter()
    slab_losses = {arch: slab_one_card(dev, slab_cfg(arch), os.path.join(
        work, f"slab_{arch}.pt")) for arch in MESH_SLAB}
    slab_oracle_s = time.perf_counter() - t0
    cut_file = os.path.join(work, "cut_state.pt")
    cut_loss = chist[0]["loss"]
    oracle_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    ranks = launch_mesh.spawn_mesh(train_mesh_rank, MESH_TRAIN["shape"], tcfg,
                                   ccut, full_file, cut_file, work, mcut,
                                   True, device=dev, timeout=900)
    for arch in MESH_SLAB:
        os.remove(os.path.join(work, f"slab_{arch}.pt"))
    spawn_s = time.perf_counter() - t0
    # the mesh's checkpoint of the cut's step 1, restored by the one-card
    # train() (nothing left to run)
    t0 = time.perf_counter()
    get_config = configs.get_config
    configs.get_config = lambda name: ccut if name == ccut.name else get_config(name)
    try:
        rstate, _ = train.train(ccut.name, smoke=False, steps=1,
                                lr=TRAIN["lr"], batch=TRAIN["batch"],
                                seq=TRAIN["seq"], eval_every=0, seed=SEED,
                                ckpt_dir=os.path.join(work, "mesh_ckpt"),
                                device=dev, log=lambda msg: None)
    finally:
        configs.get_config = get_config
    restored = {}
    specs = get_model(ccut).param_specs(ccut)
    rules = sharding.make_rules("fsdp_tp")
    for d in range(MESH_TRAIN["shape"][0]):
        for m in range(MESH_TRAIN["shape"][1]):
            at = types.SimpleNamespace(
                shape=dict(zip(("data", "model"), MESH_TRAIN["shape"])),
                coords={"data": d, "model": m})
            cut = qad.shard_cutter(get_model(ccut), ccut, at, rules)
            restored[(d, m)] = state_digests(type(rstate)(
                step=rstate.step, opt_state=type(rstate.opt_state)(
                    *(cut_tree(cut, specs, t, "opt_state/x")
                      for t in rstate.opt_state)),
                student=cut_tree(cut, specs, rstate.student, "student"),
                teacher=cut_tree(cut, specs, rstate.teacher, "teacher")))
    restored_step = int(rstate.step)
    del rstate
    gc.collect()
    torch.cuda.empty_cache()
    restore_s = time.perf_counter() - t0
    card = card_line()
    r0 = ranks[0]["runs"]
    full = r0["full"]
    # every rank reports the same global metrics (its own step times)
    metrics = lambda run: ([{k: v for k, v in h.items() if k != "step_s"}
                            for h in run["history"]], run["report"]["loss"])
    for r in ranks:
        for key in r0:
            if metrics(r["runs"][key]) != metrics(r0[key]):
                fail(f"phase 6h {key}: rank {r['coords']}'s metrics differ "
                     "from rank 0's")
        if r["full_fault"]["loss"] != ranks[0]["full_fault"]["loss"]:
            fail(f"phase 6h: rank {r['coords']}'s full-depth fault loss "
                 "differs from rank 0's")
    # each step's train loss (phase 6 evaluates after each step, run 1
    # after its last)
    losses = full["report"]["loss"]
    loss_rel = [abs(h - p["loss"]) / abs(p["loss"])
                for h, p in zip(losses, p6_hist)]
    print(f"[train-mesh] card {card}; (2, 2) mesh of 4 gloo ranks, fsdp_tp, "
          f"{tcfg.name} full size ({tcfg.n_layers} layers, remat "
          f"{tcfg.remat}), {TRAIN['steps']} steps of {TRAIN['batch']} x "
          f"{TRAIN['seq']}", flush=True)
    print("[train-mesh] train loss (phase 6): "
          + " ".join(f"{h:.7g} ({p['loss']:.7g})"
                     for h, p in zip(losses, p6_hist))
          + "; rel " + " ".join(f"{x:.3g}" for x in loss_rel), flush=True)
    print(f"[train-mesh] eval KL after step {TRAIN['steps']} (phase 6): "
          f"{full['history'][-1]['kl']:.7g} ({p6_hist[-1]['kl']:.7g})",
          flush=True)
    print(f"[train-mesh] update (final - initial) relative L2 against phase "
          f"6's: {full['update_rel']:.4g}; by leaf " + " ".join(
              f"{k} {v:.3g}" for k, v in full["update_leaves"].items()),
          flush=True)
    ff = ranks[0]["full_fault"]
    fault_rel = abs(ff["loss"] - p6_hist[0]["loss"]) / abs(p6_hist[0]["loss"])
    print(f"[train-mesh] full depth, planted fault (each rank's own "
          f"activation amax): KL at the initial weights on step 1's batch "
          f"(step 1's train loss) {ff['loss']:.7g}, rel {fault_rel:.3g} from "
          f"phase 6's (sound {loss_rel[0]:.3g}); {ff['seconds']:.1f} s",
          flush=True)
    for key in [k for k in r0 if k.startswith("cut/")]:
        run = r0[key]
        rel = abs(run["report"]["loss"][0] - cut_loss) / abs(cut_loss)
        run["loss_rel"] = rel
        print(f"[train-mesh] cut to {ccut.n_layers} layers, {key[4:]}"
              f"{' (planted fault, fsdp_tp)' if run['fault'] else ''}: loss "
              f"{run['report']['loss'][0]:.7g} (one card {cut_loss:.7g}), "
              f"rel {rel:.3g}; update rel L2 {run['update_rel']:.4g}; first "
              f"moment rel L2 {run['moment_rel']:.4g}; {run['seconds']:.1f} s; "
              "by leaf, update " + " ".join(
                  f"{k} {v:.3g}" for k, v in run["update_leaves"].items())
              + ", moment " + " ".join(
                  f"{k} {v:.3g}" for k, v in run["moment_leaves"].items()),
              flush=True)
    # the readings: collectives, bytes, step ms, peaks
    for key in r0:
        run = r0[key]
        last = run["report"]["collectives"][-1]
        gb = {p: held / 1e9 for p, (held, _) in run["report"]["bytes"].items()}
        print(f"[train-mesh] {key} ({run['rule']}, {run['layers']} layers) "
              "rank 0: collectives a step "
              + ", ".join(f"{g} {c['calls']} ({c['seconds']:.3f} host s)"
                          for g, c in last.items())
              + "; step ms " + " ".join(f"{x * 1e3:.1f}" for x in
                                        run["report"]["step_s"])
              + "; stored GB student {student:.3f} teacher {teacher:.3f} "
              "moments {moments:.3f}".format(**gb)
              + "; peak GB a rank " + " ".join(
                  f"{r['runs'][key]['report'].get('peak_gb', math.nan):.2f}"
                  for r in ranks)
              + f"; launches {run['report']['launches']}", flush=True)
    # the gates: metrics, replicas, bytes, launches, loss and update
    for key in r0:
        for r in ranks:
            run = r["runs"][key]
            for h in run["history"] + [{"loss": x}
                                       for x in run["report"]["loss"]]:
                if not all(math.isfinite(v) for v in h.values()):
                    fail(f"phase 6h {key}: non-finite metrics {h}")
            if run["replicas_differ"]:
                fail(f"phase 6h {key}: replicated leaves differ on rank "
                     f"{r['coords']}: {run['replicas_differ'][:4]}")
            for part, (held, share) in run["report"]["bytes"].items():
                if held != share:
                    fail(f"phase 6h {key}: rank {r['coords']} stores {held} B "
                         f"of the {part}, its partition factors' share is "
                         f"{share}")
            want = mesh_launches(run["qdq_fwd"], len(run["report"]["loss"]),
                                 run["evals"], key == "chunked", run["remat"])
            got = {k: run["report"]["launches"][k] for k in want}
            if got != want:
                fail(f"phase 6h {key}: rank {r['coords']} launched {got}, "
                     f"expected {want}")
    for r in ranks:
        # the fault's forward: the student's QDQs once, one KL forward
        want = {"nvfp4_qdq": 10 * tcfg.n_layers, "kl_loss": 1, "kl_loss_bwd": 0}
        got = {k: r["full_fault"]["launches"][k] for k in want}
        if got != want or not math.isfinite(r["full_fault"]["loss"]):
            fail(f"phase 6h full-depth fault: rank {r['coords']} launched "
                 f"{got} (expected {want}), loss {r['full_fault']['loss']}")
    # the layers' first moment (the embedding's gradient sums its rows'
    # tokens in another order on one card: printed, not gated)
    for key in [k for k in r0 if k.startswith("cut/")]:
        r0[key]["layers_moment"] = layers_moment(r0[key])
    sound = [r0[k] for k in r0 if k.startswith("cut/") and not r0[k]["fault"]]
    fault = r0["cut/fault"]
    for run in sound:
        if (run["loss_rel"] > MESH_TOL["cut_loss"]
                or run["update_rel"] > MESH_TOL["update"]
                or run["layers_moment"] > MESH_TOL["moment"]):
            fail(f"phase 6h cut {run['rule']}: loss rel {run['loss_rel']:.3g}, "
                 f"update {run['update_rel']:.3g}, layers' moment "
                 f"{run['layers_moment']:.3g} outside {MESH_TOL}")
    if (fault["update_rel"] <= MESH_TOL["update"]
            or fault["layers_moment"] <= MESH_TOL["moment"]):
        fail(f"phase 6h: the planted fault on the cut reads update "
             f"{fault['update_rel']:.3g}, layers' moment "
             f"{fault['layers_moment']:.3g}, inside the limits {MESH_TOL}")
    if loss_rel[0] > MESH_TOL["step1_loss"] or fault_rel <= MESH_TOL["step1_loss"]:
        fail(f"phase 6h run 1: step-1 loss rel {loss_rel[0]:.3g}, the planted "
             f"fault's {fault_rel:.3g}, against {MESH_TOL['step1_loss']}")
    if max(loss_rel) > MESH_TOL["loss"] or full["update_rel"] > MESH_TOL["full_update"]:
        fail(f"phase 6h run 1: loss rel {max(loss_rel):.3g}, update rel "
             f"{full['update_rel']:.3g} outside {MESH_TOL}")
    mesh_options_gates(ranks, ccut, khist, one_numerics, restored,
                       restored_step, restore_s)
    mesh_moe_gates(ranks, mcut, mhist)
    mesh_slab_gates(ranks, slab_losses, card)
    secs = time.perf_counter() - t_phase
    slab_s = sum(r0[k]["seconds"] for k in r0 if k.startswith("slab/"))
    print(f"[train-mesh] phase 6h: {secs:.1f} s (one-card oracles "
          f"{oracle_s:.1f} s, the slab run's {slab_oracle_s:.1f} s of them; "
          f"the spawn {spawn_s:.1f} s; in the ranks run 1 "
          f"{full['seconds']:.1f} s, the slab run {slab_s:.1f} s); card "
          f"{card}", flush=True)
    return {"seconds": secs, "launches": full["report"]["launches"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: nothing to measure", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import nvfp4
    from repro_torch.core import qad
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import kl_loss as kkl
    from repro_torch.kernels import nvfp4_matmul as kmm
    from repro_torch.kernels import nvfp4_qdq as kqdq
    from repro_torch.launch import serve, specs, train
    from repro_torch.models import common, get_model
    from repro_torch.optim import AdamW, warmup_cosine

    t_start = time.perf_counter()

    def elapsed(phase: str) -> None:
        """The script's seconds as the phase starts (its time budget)."""
        print(f"[chip_smoke] {time.perf_counter() - t_start:.1f}s at phase "
              f"{phase}", flush=True)

    dev = torch.device("cuda")
    # plain f32 products in full f32; the QDQ replay's cuBLAS bf16 GEMMs
    # accumulate in f32 throughout, as the nvfp4_matmul kernel does
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    elapsed("1")
    # ---- 1. the card ------------------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[chip_smoke] card: {card}", flush=True)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device={name} count={count}", flush=True)

    elapsed("2")
    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _, log = _build.build()
    secs = time.perf_counter() - t0
    _build.library()
    print(f"[chip_smoke] built kernels in {secs:.1f}s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")

    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed(fn, iters: int) -> float:
        """Device ms of one call: CUDA events around each of ``iters``
        calls, the L2 flushed before each (cold weights, as a decode step
        finds them), the median.  A spin kernel ahead of the loop holds the
        card while the host queues every call, so no call waits for the
        host between its two events."""
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(SPIN_CYCLES)
        for a, b in ev:
            flush_buf.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in ev)
        return times[len(times) // 2]

    # ---- 3. kernels against their plain versions --------------------------
    cfg = configs.get_config("acereason-7b")
    d, ff, qkv = cfg.d_model, cfg.d_ff, cfg.qkv_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # one layer's launches, in order: (K, N) of wqkv, wo, wg, wu, wd; the
    # qdq inputs have the same K
    layer = [("wqkv", d, qkv), ("wo", d, d), ("wg", d, ff), ("wu", d, ff),
             ("wd", ff, d)]
    rows = {"nvfp4_qdq": [], "nvfp4_matmul": []}
    err = {"nvfp4_qdq": 0.0, "nvfp4_matmul": 0.0}
    # the largest |kernel - plain| / tolerance over each GEMM's checks
    err_bound = {"nvfp4_matmul": 0.0, "nvfp4_matmul_grouped": 0.0,
                 "nvfp4_matmul_tp": 0.0}

    def act(m, k):
        return (torch.randn((m, k), generator=gen, device=dev) * 2.0
                ).to(torch.bfloat16)

    for m in (BATCH, BATCH * PROMPT):
        for wname, k, n in layer:
            x = act(m, k)
            # K1: bitwise against the plain version, tensor scope as served
            got, want = ops.nvfp4_qdq(x), ref.nvfp4_qdq_ref(x)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                n_bad = int((got.view(torch.int16) != want.view(torch.int16)).sum())
                fail(f"nvfp4_qdq not bitwise at ({m}, {k}): {n_bad} elements")

            # K2: within one bf16 ulp of the f32 product + summation bound
            w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
            p = ops.pack_weight(w.to(torch.bfloat16))
            xq = got
            y = ops.nvfp4_matmul(xq, p)
            y32 = ref.nvfp4_matmul_ref(xq, p, torch.float32)
            wdq = nvfp4.unpack(p, torch.bfloat16)             # [N, K]
            absref = xq.float().abs() @ wdq.float().abs().T
            one_ulp = torch.exp2(torch.floor(torch.log2(
                y32.abs().clamp_min(1e-30))) - 7)
            diff = (y.float() - y32).abs()
            if not bool((diff <= one_ulp + 2.0 ** -20 * absref).all()):
                fail(f"nvfp4_matmul outside tolerance at M={m} K={k} N={n}: "
                     f"max abs err {float(diff.max())}")
            err["nvfp4_matmul"] = max(err["nvfp4_matmul"], float(diff.max()))
            ratio = float((diff / (one_ulp + 2.0 ** -20 * absref)).max())
            err_bound["nvfp4_matmul"] = max(err_bound["nvfp4_matmul"], ratio)
            print(f"[kernel] nvfp4_matmul M={m} {wname} (K={k}, N={n}): max "
                  f"err/bound {ratio:.4f}", flush=True)
            if m == BATCH * PROMPT:
                # a token's row does not depend on M or on the other rows:
                # rows of the prefill product (tile form) equal bitwise the
                # same rows at a paged chunk (M = 16), at decode (M = 4)
                # and alone, in bf16 and f32
                for od in (torch.bfloat16, torch.float32):
                    yb = ops.nvfp4_matmul(xq, p, od)
                    iv = torch.int16 if od == torch.bfloat16 else torch.int32
                    for sl in (slice(0, CHUNK), slice(100, 100 + BATCH),
                               slice(m - 1, m)):
                        if not torch.equal(ops.nvfp4_matmul(xq[sl], p, od).view(iv),
                                           yb[sl].view(iv)):
                            fail(f"nvfp4_matmul rows {sl.start}..{sl.stop} of "
                                 f"{wname} differ between M={m} and "
                                 f"M={sl.stop - sl.start} ({od})")
                xc = xq[:CHUNK]
                bc = kmm.bytes_moved(xc, p, torch.bfloat16)
                fc = kmm.flops(xc, p)
                rows["nvfp4_matmul"].append(dict(
                    m=CHUNK, k=k, n=n, site=wname, phase="chunk",
                    bound_ms=max(bc / HBM_BYTES_S, fc / BF16_FLOPS) * 1e3,
                    bound_by=("bytes" if bc / HBM_BYTES_S >= fc / BF16_FLOPS
                              else "operations"),
                    max_abs_err=float(diff[:CHUNK].max()),
                    fns=((lambda xc=xc, p=p: ops.nvfp4_matmul(xc, p)),
                         (lambda xc=xc, p=p: ref.nvfp4_matmul_ref(xc, p)),
                         (lambda xc=xc, w=wdq.T: torch.matmul(xc, w)))))
            bts = kmm.bytes_moved(xq, p, torch.bfloat16)
            fl = kmm.flops(xq, p)
            mm_bound = max(bts / HBM_BYTES_S, fl / BF16_FLOPS) * 1e3
            by = "bytes" if bts / HBM_BYTES_S >= fl / BF16_FLOPS else "operations"
            wdq_t = wdq.T
            rows["nvfp4_matmul"].append(dict(
                m=m, k=k, n=n, site=wname, bound_ms=mm_bound, bound_by=by,
                max_abs_err=float(diff.max()), err_over_bound=ratio,
                fns=((lambda xq=xq, p=p: ops.nvfp4_matmul(xq, p)),
                     (lambda xq=xq, p=p: ref.nvfp4_matmul_ref(xq, p)),
                     (lambda xq=xq, w=wdq_t: torch.matmul(xq, w)))))
            del w, absref, y, y32
    print("[kernel] nvfp4_qdq bitwise and nvfp4_matmul within its bound at "
          "every shape of the layer, M in (4, 256); rows of the M=256 product "
          f"bitwise equal at M in ({CHUNK}, {BATCH}, 1) (max err/bound "
          f"{err_bound['nvfp4_matmul']:.4f})", flush=True)

    # edge cases: M = 1, a ragged N, K padded (orig_k < stored K), f32 in/out,
    # and one amax per row
    x = act(1, 40)
    wpad = torch.nn.functional.pad(torch.randn((24, 40), generator=gen,
                                               device=dev), (0, 8))
    p = dataclasses.replace(nvfp4.pack(wpad), orig_k=40)
    for xe in (x, x.float()):
        for out_dtype in (torch.bfloat16, torch.float32):
            ye = ops.nvfp4_matmul(xe, p, out_dtype).float()
            re = ref.nvfp4_matmul_ref(xe, p, torch.float32)
            if not torch.allclose(ye, re, rtol=1e-2, atol=1e-3):
                fail(f"nvfp4_matmul padded-K edge case {xe.dtype}->{out_dtype}")
    xr = torch.randn((3, 5, 64), generator=gen, device=dev)
    amax = xr.abs().amax(dim=(1, 2), keepdim=True)
    if not torch.equal(ops.nvfp4_qdq(xr, amax), ref.nvfp4_qdq_ref(xr, amax)):
        fail("nvfp4_qdq with one amax per row is not bitwise")
    print("[kernel] edge cases (M=1, padded K, f32 in/out, per-row amax) OK",
          flush=True)

    # K1 as the engine and the trainer call it: the op takes the scope's
    # amax in the same launch; bitwise against the plain version with the
    # amax taken by torch, one device kernel a call, a misaligned view read
    # in place, a NaN and an inf as the plain version has them
    def device_ops(fn):
        """The device ops of one call of ``fn``, WARMUP_SPINS spin kernels
        recorded ahead of it and left out; an empty profile (a dropped
        record: the profiler adds none) is taken again, up to three in
        all."""
        fn()
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(WARMUP_SPINS):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "spin_kernel" not in e.name]
            if names:
                return names
        return names

    tcfg_full = configs.get_config(TRAIN["arch"])
    mcfg_full = configs.get_config(MOE_ARCH)
    m_e, m_d, m_ff = mcfg_full.n_experts, mcfg_full.d_model, mcfg_full.moe_d_ff
    m_cap = int(max(1, (MOE_TRAIN["seq"] * mcfg_full.experts_per_tok
                        * mcfg_full.capacity_factor) // m_e))
    # (phase, site, shape, scope): a decode step at 8 slots, an exact
    # 512-token prefill (row scope over the whole prompt), a paged chunk's
    # tokens, the training step's activations; MoE QAD's expert stacks
    # (blocked along their contraction axis, moved last) and its routed
    # experts' input slab [B, E, capacity, d]
    k1_sites = ([("decode", w, (ENGINE["n_slots"], 1, k), "row") for w, k, _ in layer]
                + [("prefill", w, (1, 512, k), "row") for w, k, _ in layer]
                + [("chunk", "wd", (1, CHUNK, ff), "token")]
                + [("train", w, (TRAIN["batch"], TRAIN["seq"], k), "tensor")
                   for w, k in (("wqkv", tcfg_full.d_model),
                                ("wd", tcfg_full.d_ff))]
                + [("train_moe", "moe_wg", (m_e, m_ff, m_d), "tensor"),
                   ("train_moe", "moe_wd", (m_e, m_d, m_ff), "tensor"),
                   ("train_moe", "xe", (MOE_TRAIN["batch"], m_e, m_cap, m_d),
                    "tensor")])
    for dt in (torch.bfloat16, torch.float32):
        for ph, wname, shape, scope in k1_sites + [("big", "-", (4096, 8192), "tensor")]:
            x = (torch.randn(shape, generator=gen, device=dev) * 2.0).to(dt)
            got = ops.nvfp4_qdq(x, scope=scope)
            if not qdq_equal(got, ref.nvfp4_qdq_ref(x, None, scope)):
                fail(f"nvfp4_qdq with its own {scope} amax not bitwise at "
                     f"{shape} {dt}")
            if dt == torch.bfloat16 and ph != "big":
                rows["nvfp4_qdq"].append(dict(
                    m=shape[0] * shape[1], k=shape[-1], site=wname, phase=ph,
                    shape=f"{list(shape)} {scope}", bound_ms=q_bound(x),
                    library_ms=None,
                    fns=((lambda x=x, sc=scope: ops.nvfp4_qdq(x, scope=sc)),
                         (lambda x=x, sc=scope: ref.nvfp4_qdq_ref(x, None, sc)),
                         None),
                    old=(lambda x=x, sc=scope: old_call(x, sc))))
            del x, got
    for scope in ("row", "token", "tensor"):
        base = (torch.randn(8 * ff + 16, generator=gen, device=dev) * 2.0
                ).to(torch.bfloat16)
        xm = base[3:3 + 8 * ff].view(8, 1, ff)          # 6 bytes off
        if not qdq_equal(ops.nvfp4_qdq(xm, scope=scope),
                         ref.nvfp4_qdq_ref(xm, None, scope)):
            fail(f"nvfp4_qdq on a misaligned view ({scope}) not bitwise")
        xm = xm.clone()
        xm.view(-1)[77] = float("nan")
        xm.view(-1)[-3] = float("inf")
        if not qdq_equal(ops.nvfp4_qdq(xm, scope=scope),
                         ref.nvfp4_qdq_ref(xm, None, scope)):
            fail(f"nvfp4_qdq with a NaN and an inf ({scope}) differs from "
                 "its plain version")
    k1_old_ops = {}                  # device ops of the former call, by phase
    for ph, wname, shape, scope in k1_sites:
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        names = device_ops(lambda: ops.nvfp4_qdq(x, scope=scope))
        if len(names) != 1:
            fail(f"nvfp4_qdq {shape} {scope} ran {len(names)} device ops: {names}")
        k1_old_ops[ph] = len(device_ops(lambda: old_call(x, scope)))
    print(f"[kernel] nvfp4_qdq with its own amax bitwise in every scope at the "
          f"engine's and the trainer's shapes ({len(k1_sites)} sites, bf16 and "
          f"f32) and at [4096, 8192]; a misaligned view, a NaN and an inf as "
          f"the plain version; one device kernel a call (the former call, the "
          f"torch amax and the kernel: {k1_old_ops} device ops a call by site)",
          flush=True)

    # K4: each rank's tile through K2, the tiles together against the
    # full-K plain product ------------------------------------------------
    rows["nvfp4_matmul_tp"] = []
    err["nvfp4_matmul_tp"] = 0.0
    tp_mode = {"wqkv": "column", "wo": "row", "wg": "column", "wu": "column",
               "wd": "row"}
    for m in (ENGINE["n_slots"], BATCH * PROMPT):
        for wname, k, n in layer:
            mode = tp_mode[wname]
            x = ops.nvfp4_qdq(act(m, k))
            w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
            p = ops.pack_weight(w.to(torch.bfloat16))
            wdq = nvfp4.unpack(p, torch.bfloat16).float()
            absref = x.float().abs() @ wdq.abs().T
            full = ref.nvfp4_matmul_ref(x, p, torch.float32)
            parts = []
            for rank in range(TP_SIZE):
                tile = nvfp4.tp_tile(p, mode, rank, TP_SIZE)
                xl = (x if mode == "column"
                      else x.chunk(TP_SIZE, -1)[rank].contiguous())
                y = ops.nvfp4_matmul(xl, tile)
                y32 = ref.nvfp4_matmul_ref(xl, tile, torch.float32)
                tabs = xl.float().abs() @ nvfp4.unpack(
                    tile, torch.bfloat16).float().abs().T
                one_ulp = torch.exp2(torch.floor(torch.log2(
                    y32.abs().clamp_min(1e-30))) - 7)
                diff = (y.float() - y32).abs()
                if not bool((diff <= one_ulp + 2.0 ** -20 * tabs).all()):
                    fail(f"nvfp4_matmul_tp tile {rank} of {wname} ({mode}) "
                         f"outside K2's tolerance at M={m}: max abs err "
                         f"{float(diff.max())}")
                err["nvfp4_matmul_tp"] = max(err["nvfp4_matmul_tp"],
                                             float(diff.max()))
                ratio = float((diff / (one_ulp + 2.0 ** -20 * tabs)).max())
                err_bound["nvfp4_matmul_tp"] = max(err_bound["nvfp4_matmul_tp"],
                                                   ratio)
                print(f"[kernel] nvfp4_matmul_tp M={m} {wname} {mode} tile "
                      f"{rank}: max err/bound {ratio:.4f}", flush=True)
                parts.append(ops.nvfp4_matmul(xl, tile, torch.float32))
                bts = kmm.bytes_moved(xl, tile, torch.bfloat16)
                fl = kmm.flops(xl, tile)
                rows["nvfp4_matmul_tp"].append(dict(
                    m=m, k=xl.shape[-1], n=tile.codes.shape[0],
                    site=f"{wname} {mode}, rank {rank}", rank=rank,
                    bound_ms=max(bts / HBM_BYTES_S, fl / BF16_FLOPS) * 1e3,
                    bound_by=("bytes" if bts / HBM_BYTES_S >= fl / BF16_FLOPS
                              else "operations"),
                    fns=((lambda xl=xl, t=tile: ops.nvfp4_matmul(xl, t)),
                         (lambda xl=xl, t=tile: ref.nvfp4_matmul_ref(xl, t)),
                         None),
                    # the dequantized tile is made when it is timed, so the
                    # tiles of every site do not stay alive until phase 7
                    lib_make=(lambda xl=xl, t=tile: (
                        lambda w=nvfp4.unpack(t, torch.bfloat16).T:
                        torch.matmul(xl, w)))))
            got = torch.cat(parts, -1) if mode == "column" else sum(parts)
            if not bool(((got - full).abs() <= 2.0 ** -20 * absref).all()):
                fail(f"nvfp4_matmul_tp: the {mode} tiles of {wname} at M={m} "
                     f"do not make the full-K product: max abs err "
                     f"{float((got - full).abs().max())}")
            del w, wdq, absref, full, parts
    print(f"[kernel] nvfp4_matmul_tp: every tp={TP_SIZE} tile of wqkv, wo, wg, "
          f"wu, wd within K2's tolerance, the tiles together within the "
          f"summation bound of the full-K product, M in "
          f"({ENGINE['n_slots']}, {BATCH * PROMPT}) (max abs err "
          f"{err['nvfp4_matmul_tp']:.3g})", flush=True)

    # K3 against its plain version and, bitwise, against K2 on each group --
    mcfg = configs.get_config(MOE_ARCH)
    n_exp, mdm, ffe = mcfg.n_experts, mcfg.d_model, mcfg.moe_d_ff
    rows["nvfp4_matmul_grouped"] = []
    err["nvfp4_matmul_grouped"] = 0.0
    # rows per expert: a decode step (8 slots, capacity 1 each), the exact
    # prefill of a 512-token prompt, a 16-token paged-prefill chunk (token
    # dispatch, capacity 1 per token)
    k3_m = {"decode": 8,
            "prefill": int(max(1, (512 * mcfg.experts_per_tok
                                   * mcfg.capacity_factor) // n_exp)),
            "chunk": 16}

    def k3_check(x, p, what):
        y = ops.nvfp4_matmul_grouped(x, p)
        y32 = ref.nvfp4_matmul_grouped_ref(x, p, torch.float32)
        wdq = nvfp4.unpack(p, torch.bfloat16)[..., : p.k].float()
        absref = torch.bmm(x.float().abs(), wdq.abs().transpose(1, 2))
        ulp_y = torch.exp2(torch.floor(torch.log2(
            y32.abs().clamp_min(1e-30))) - 7)
        diff = (y.float() - y32).abs()
        if not bool((diff <= ulp_y + 2.0 ** -20 * absref).all()):
            fail(f"nvfp4_matmul_grouped outside tolerance ({what}): max abs "
                 f"err {float(diff.max())}")
        ts = p.tensor_scale.reshape(-1)
        for g in range(x.shape[0]):
            sl = nvfp4.PackedNVFP4(p.codes[g], p.scales[g],
                                   ts[g if ts.numel() > 1 else 0], p.orig_k)
            if not torch.equal(y[g].view(torch.int16),
                               ops.nvfp4_matmul(x[g], sl).view(torch.int16)):
                fail(f"nvfp4_matmul_grouped group {g} is not K2 on its "
                     f"slices bitwise ({what})")
        err["nvfp4_matmul_grouped"] = max(err["nvfp4_matmul_grouped"],
                                          float(diff.max()))
        ratio = float((diff / (ulp_y + 2.0 ** -20 * absref)).max())
        err_bound["nvfp4_matmul_grouped"] = max(
            err_bound["nvfp4_matmul_grouped"], ratio)
        print(f"[kernel] nvfp4_matmul_grouped {what}: max err/bound "
              f"{ratio:.4f}", flush=True)
        return float(diff.max())

    for site, k, n in (("wg/wu", mdm, ffe), ("wd", ffe, mdm)):
        w = (torch.randn((n_exp, n, k), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        p = nvfp4.pack(w)                    # one scale per stack, as served
        wdq_t = nvfp4.unpack(p, torch.bfloat16).transpose(1, 2).contiguous()
        del w
        for mname, m in k3_m.items():
            x = ops.nvfp4_qdq(act(n_exp * m, k)).reshape(n_exp, m, k)
            e_max = k3_check(x, p, f"{site} {mname} M={m}")
            bts = kmm.bytes_moved_grouped(x, p, torch.bfloat16)
            fl = kmm.flops_grouped(x, p)
            rows["nvfp4_matmul_grouped"].append(dict(
                m=m, k=k, n=n, site=site, phase=mname, max_abs_err=e_max,
                shape=f"G={n_exp} M={m:2d} K={k:4d} N={n:4d} {mname}",
                bound_ms=max(bts / HBM_BYTES_S, fl / BF16_FLOPS) * 1e3,
                bound_by=("bytes" if bts / HBM_BYTES_S >= fl / BF16_FLOPS
                          else "operations"),
                fns=((lambda x=x, p=p: ops.nvfp4_matmul_grouped(x, p)),
                     (lambda x=x, p=p: ref.nvfp4_matmul_grouped_ref(x, p)),
                     (lambda x=x, w=wdq_t: torch.bmm(x, w)))))
    # a scale per expert (experts of different magnitude), and K padded
    w = (torch.randn((n_exp, ffe, mdm), generator=gen, device=dev)
         * torch.arange(1, n_exp + 1, device=dev)[:, None, None]).to(torch.bfloat16)
    k3_check(ops.nvfp4_qdq(act(n_exp * 8, mdm)).reshape(n_exp, 8, mdm),
             nvfp4.pack(w, n_lead=1), "per-expert scale")
    wpad = torch.nn.functional.pad(torch.randn((3, 24, 40), generator=gen,
                                               device=dev), (0, 8))
    k3_check(act(15, 40).reshape(3, 5, 40),
             dataclasses.replace(nvfp4.pack(wpad, n_lead=1), orig_k=40),
             "padded K")
    del w, wpad, p, wdq_t
    print(f"[kernel] nvfp4_matmul_grouped within K2's tolerance of its plain "
          f"version and bitwise equal to K2 per expert at G={n_exp}, "
          f"(K, N) = ({mdm}, {ffe}) and ({ffe}, {mdm}), M in "
          f"{tuple(k3_m.values())}; per-expert scale and padded K OK (max "
          f"abs err {err['nvfp4_matmul_grouped']:.3g})", flush=True)

    # K5 and K6 against their plain versions ------------------------------
    rows["kl_loss"], rows["kl_loss_bwd"] = [], []
    err["kl_loss"] = err["kl_loss_bwd"] = 0.0

    def check_kl(tl, sl, g, what):
        kl, zt, zs = kkl.launch_fwd(tl, sl)
        pk, pzt, pzs = kkl.plain_fwd(tl, sl)
        e_kl = (kl - pk).abs()
        ok = bool((e_kl <= 1e-4 * pk.abs() + 16 * ulp(pzt.abs() + pzs.abs(), 23)).all()
                  and ((zt - pzt).abs() <= 8 * ulp(pzt, 23)).all()
                  and ((zs - pzs).abs() <= 8 * ulp(pzs, 23)).all())
        if not ok:
            fail(f"kl_loss forward outside tolerance ({what}): max |dkl| "
                 f"{float(e_kl.max())}, max |dz_t| {float((zt - pzt).abs().max())}")
        ds = kkl.launch_bwd(tl, sl, zt, zs, g).float()
        p_s = torch.exp(sl.float() - zs[:, None])
        p_t = torch.exp(tl.float() - zt[:, None])
        want = (p_s - p_t) * g[:, None]
        mant = 7 if sl.dtype == torch.bfloat16 else 23
        e_ds = (ds - want).abs()
        if not bool((e_ds <= ulp(want, mant) + 4 * 2.0 ** -23 * (p_s + p_t)
                     * g.abs()[:, None]).all()):
            fail(f"kl_loss backward outside tolerance ({what}): max |dds| "
                 f"{float(e_ds.max())}")
        if bool((g == 0).any()) and bool(ds[g == 0].any()):
            fail(f"kl_loss backward: a masked-out row has a gradient ({what})")
        torch.cuda.synchronize()
        err["kl_loss"] = max(err["kl_loss"], float(e_kl.max()))
        err["kl_loss_bwd"] = max(err["kl_loss_bwd"], float(e_ds.max()))
        return zt, zs

    for shape_name, (t_rows, vocab) in KL_SHAPES.items():
        tl = (torch.randn((t_rows, vocab), generator=gen, device=dev) * 2
              ).to(torch.bfloat16)
        sl = (tl.float() + 0.3 * torch.randn((t_rows, vocab), generator=gen,
                                             device=dev)).to(torch.bfloat16)
        mask = (torch.rand(t_rows, generator=gen, device=dev) > 0.1).float()
        mask[0] = 0.0
        g_tok = mask / mask.sum()
        zt, zs = check_kl(tl, sl, g_tok, f"T={t_rows} V={vocab}")
        n_bytes = kkl.bytes_fwd(tl)
        b_bytes = kkl.bytes_bwd(tl)
        rows["kl_loss"].append(dict(
            m=t_rows, k=vocab, site=shape_name, library_ms=None,
            bound_ms=max(n_bytes / HBM_BYTES_S,
                         kkl.OPS_FWD * tl.numel() / F32_FLOPS) * 1e3,
            fns=((lambda tl=tl, sl=sl: kkl.launch_fwd(tl, sl)),
                 (lambda tl=tl, sl=sl: kkl.plain_fwd(tl, sl)), None)))
        rows["kl_loss_bwd"].append(dict(
            m=t_rows, k=vocab, site=shape_name, library_ms=None,
            bound_ms=max(b_bytes / HBM_BYTES_S,
                         kkl.OPS_BWD * tl.numel() / F32_FLOPS) * 1e3,
            fns=((lambda a=(tl, sl, zt, zs, g_tok): kkl.launch_bwd(*a)),
                 (lambda a=(tl, sl, zt, zs, g_tok): kkl.plain_bwd(*a)), None)))
    # ragged V (rows start off a 16-byte boundary), tiny rows, f32 logits,
    # and identical logits (KL exactly 0)
    for t_rows, vocab, dt in ((33, 50303, torch.bfloat16), (7, 5, torch.bfloat16),
                              (16, 1001, torch.float32), (3, 1, torch.float32)):
        tl = (torch.randn((t_rows, vocab), generator=gen, device=dev) * 2).to(dt)
        sl = (tl.float() + 0.3 * torch.randn((t_rows, vocab), generator=gen,
                                             device=dev)).to(dt)
        g_tok = torch.rand(t_rows, generator=gen, device=dev) / t_rows
        g_tok[0] = 0.0
        check_kl(tl, sl, g_tok, f"T={t_rows} V={vocab} {dt}")
    tl = torch.randn((64, 50304), generator=gen, device=dev).to(torch.bfloat16)
    kl, zt, zs = kkl.launch_fwd(tl, tl)
    if bool(kl.any()) or not torch.equal(zt, zs):
        fail("kl_loss forward: identical logits do not give KL 0")
    print(f"[kernel] kl_loss forward and backward within tolerance at "
          f"{list(KL_SHAPES.values())}, ragged V, tiny rows, f32, a masked "
          f"row; KL 0 for identical logits (max |dkl| {err['kl_loss']:.3g}, "
          f"max |dds| {err['kl_loss_bwd']:.3g})", flush=True)

    # K7 against its plain version at the engine's shapes -----------------
    from repro_torch.kernels import paged_attention as kpa
    rows["paged_attention"] = []
    err["paged_attention"] = 0.0
    n_heads, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_blk, blk, mbs = (ENGINE["n_blocks"], ENGINE["block_size"],
                       ENGINE["max_blocks_per_slot"])

    def k7_case(b, s_q, pos, fp8=False, n_pages=n_blk, mb=mbs):
        """Random pages (bf16, or e4m3 with one f32 scale per row), tables
        of distinct blocks, queries."""
        k = torch.randn((n_pages, blk, n_kv, hd), generator=gen, device=dev)
        v = torch.randn((n_pages, blk, n_kv, hd), generator=gen, device=dev)
        if fp8:
            def quant(x):
                sc = x.abs().amax(-1).clamp_min(1e-30) / 448.0
                return (x / sc[..., None]).to(torch.float8_e4m3fn), sc
            (k, ks), (v, vs) = quant(k), quant(v)
            pool = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
        else:
            pool = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        bt = torch.randperm(n_pages, generator=gen, device=dev)[: b * mb]
        q = torch.randn((b, s_q, n_heads, hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        return (q, pool, bt.reshape(b, mb).to(torch.int32),
                torch.as_tensor(pos, dtype=torch.int32, device=dev))

    def check_k7(what, q, pool, bt, pos, window=0):
        got = ops.paged_attention(q, pool, bt, pos, window=window).float()
        want = ref.paged_attention_ref(q, pool, bt, pos, window=window).float()
        d = (got - want).abs()
        if not bool((d <= ulp(torch.maximum(got.abs(), want.abs()), 7)
                     + K7_ATOL).all()):
            fail(f"paged_attention outside tolerance ({what}): max abs err "
                 f"{float(d.max())}")
        err["paged_attention"] = max(err["paged_attention"], float(d.max()))
        return got

    dec_pos = torch.linspace(1, mbs * blk, ENGINE["n_slots"]).round().int()
    pre_pos = (256 + torch.arange(1, blk + 1)).reshape(1, blk)
    long_mb = 4096 // blk + 2                # a 4k-key decode step
    for site, case in (("decode", k7_case(ENGINE["n_slots"], 1, dec_pos)),
                       ("paged_prefill", k7_case(1, blk, pre_pos)),
                       ("decode_4k", k7_case(
                           ENGINE["n_slots"], 1, [4096] * ENGINE["n_slots"],
                           n_pages=ENGINE["n_slots"] * long_mb, mb=long_mb))):
        check_k7(site, *case)
        q, pool, bt, pos = case
        kb = kpa.bytes_moved(q, pool["k"], bt, pos, fp8=False)
        kf = kpa.flops(q, pool["k"], bt, pos)
        rows["paged_attention"].append(dict(
            site=site, shape=f"q {list(q.shape)} pages {list(pool['k'].shape)} "
            f"tables {list(bt.shape)}", library_ms=None,
            bound_ms=max(kb / HBM_BYTES_S, kf / BF16_FLOPS) * 1e3,
            bound_by="bytes" if kb / HBM_BYTES_S >= kf / BF16_FLOPS else "operations",
            fns=((lambda c=case: ops.paged_attention(*c)),
                 (lambda c=case: ref.paged_attention_ref(*c)), None)))
    # a dead table tail: pages past every pos are never read
    q, pool, bt, pos = k7_case(ENGINE["n_slots"], 1, [3, 17, 40, 16, 33, 1, 64, 20])
    got = check_k7("dead tail", q, pool, bt, pos)
    dead = bt[:, 5:].reshape(-1).long()
    for a in pool.values():
        a[dead] = 1e4
    bt[:, 5:] = 1 << 30
    if not torch.equal(ops.paged_attention(q, pool, bt, pos).float(), got):
        fail("paged_attention read a page past every query's pos")
    check_k7("window 100", *k7_case(ENGINE["n_slots"], 1, dec_pos), window=100)
    check_k7("window 40, 16 queries", *k7_case(1, blk, pre_pos), window=40)
    check_k7("fp8 pages", *k7_case(ENGINE["n_slots"], 1, dec_pos, fp8=True))
    check_k7("fp8 pages, 16 queries", *k7_case(1, blk, pre_pos, fp8=True))
    qn, pool, bt, pos = k7_case(ENGINE["n_slots"], 1, dec_pos)
    qn = qn.transpose(1, 2).contiguous().transpose(1, 2)
    check_k7("non-contiguous q", qn, pool, bt, pos)
    # long contexts (every block loops over its chunks); pos on the
    # boundaries of the blocks' parts, at 1 and at MB x bs
    for keys in (4096, 32768):
        mbl = keys // blk + 2
        check_k7(f"{keys} keys", *k7_case(2, 1, [keys, keys - 77],
                                          n_pages=2 * mbl + 4, mb=mbl))
    cs = kpa._part_len(mbs * blk, kpa.split_plan(
        1, n_heads // n_kv, mbs, blk, hd).n_split)      # keys a block's part
    check_k7("split edges", *k7_case(ENGINE["n_slots"], 1,
                                     [cs, 2 * cs, 3 * cs, 1, mbs * blk, cs - 1,
                                      cs + 1, mbs * blk]))
    case = k7_case(ENGINE["n_slots"], 1, dec_pos)
    names = device_ops(lambda: ops.paged_attention(*case))
    if len(names) != 1:
        fail(f"paged_attention at decode ran {len(names)} device ops: {names}")
    print(f"[kernel] paged_attention within one bf16 ulp + {K7_ATOL} of its "
          f"plain version: decode, paged-prefill chunk, 4k-key decode, dead "
          f"table tail, windows, FP8 pages, a strided q, 4096 and 32768 keys, "
          f"split edges (max abs err {err['paged_attention']:.3g}); one device "
          f"kernel a decode call", flush=True)
    del q, qn, pool, bt, pos, got, case

    # ---- 3k, 3l. K7 at the verify shape and on FP8 pages; row invariance --
    phase_3k(dev, gen, rows, err)
    row_inv = phase_3l(dev, gen)

    elapsed("3h")
    # ---- 3h. the rglru_hybrid family's shapes (phases 5e-5f, 6e) ---------
    # K2 on one [layer, inner] slice of a weight stacked over two leading
    # axes and packed as PTQ packs blocks/rec (a tensor scale per slice),
    # at decode (M = 8 slots) and prefill (M = 256) within its bound, the
    # prefill rows bitwise equal to the decode rows; K1 in row scope at the
    # decode inputs [8, 1, K], bitwise.  nemotron-nano-9b-sim's K = 15680 is
    # the first K that is not a multiple of 128 (245 chunks of 64)
    from repro_torch.core import ptq as cptq
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models.common import ParamSpec
    rg_sites = []
    for arch in (NEMO_ARCH, RGEMMA["arch"]):
        c = configs.get_config(arch)
        rg_sites += [(arch, "wx", c.d_model, c.d_rnn),
                     (arch, "wg", c.d_model, c.d_ff),
                     (arch, "wd", c.d_ff, c.d_model)]
    n_slots = ENGINE["n_slots"]
    for arch, wname, k, n in rg_sites:
        spec = ParamSpec((2, 2, k, n), ("layers", "inner", "embed", "mlp"),
                         kind="mlp", contract_axis=2)
        w = (torch.randn((2, 2, k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        stack = cptq.quantize_leaf(spec, w, QuantConfig(weight_format="packed"))
        del w
        p = stack[1][0]
        if p.k != k or p.tensor_scale.shape != (1, 1):
            fail(f"a slice of the {arch} {wname} stack lost orig_k or its "
                 f"scale shape: {p.k}, {tuple(p.tensor_scale.shape)}")
        x = act(BATCH * PROMPT, k)
        got = ops.nvfp4_qdq(x[:n_slots, None], scope="row")
        if not qdq_equal(got, ref.nvfp4_qdq_ref(x[:n_slots, None], None, "row")):
            fail(f"nvfp4_qdq row scope not bitwise at [{n_slots}, 1, {k}]")
        xq = ops.nvfp4_qdq(x, scope="row")
        wdq = nvfp4.unpack(p, torch.bfloat16)
        for m in (n_slots, BATCH * PROMPT):
            y = ops.nvfp4_matmul(xq[:m], p)
            y32 = ref.nvfp4_matmul_ref(xq[:m], p, torch.float32)
            absref = xq[:m].float().abs() @ wdq.float().abs().T
            one_ulp = torch.exp2(torch.floor(torch.log2(
                y32.abs().clamp_min(1e-30))) - 7)
            diff = (y.float() - y32).abs()
            ratio = float((diff / (one_ulp + 2.0 ** -20 * absref)).max())
            if ratio > 1.0:
                fail(f"nvfp4_matmul on a {arch} stack slice ({wname}, K={k}, "
                     f"N={n}) outside tolerance at M={m}: err/bound {ratio}")
            err["nvfp4_matmul"] = max(err["nvfp4_matmul"], float(diff.max()))
            err_bound["nvfp4_matmul"] = max(err_bound["nvfp4_matmul"], ratio)
            print(f"[kernel] nvfp4_matmul {arch} {wname} stack slice M={m} "
                  f"(K={k}, N={n}): max err/bound {ratio:.4f}", flush=True)
        if not torch.equal(ops.nvfp4_matmul(xq, p)[:n_slots].view(torch.int16),
                           ops.nvfp4_matmul(xq[:n_slots], p).view(torch.int16)):
            fail(f"nvfp4_matmul rows of {arch} {wname} differ between M=256 "
                 f"and M={n_slots}")
        xd = xq[:n_slots]
        bts, fl = kmm.bytes_moved(xd, p, torch.bfloat16), kmm.flops(xd, p)
        rows["nvfp4_matmul"].append(dict(
            m=n_slots, k=k, n=n, site=f"{arch} {wname}", phase=arch,
            bound_ms=max(bts / HBM_BYTES_S, fl / BF16_FLOPS) * 1e3,
            bound_by=("bytes" if bts / HBM_BYTES_S >= fl / BF16_FLOPS
                      else "operations"),
            max_abs_err=float(diff.max()),
            fns=((lambda xd=xd, p=p: ops.nvfp4_matmul(xd, p)),
                 (lambda xd=xd, p=p: ref.nvfp4_matmul_ref(xd, p)),
                 (lambda xd=xd, w=wdq.T: torch.matmul(xd, w)))))
        xr = x[:n_slots, None]
        rows["nvfp4_qdq"].append(dict(
            m=n_slots, k=k, site=wname, phase=f"decode {arch}",
            shape=f"{list(xr.shape)} row", bound_ms=q_bound(xr),
            library_ms=None,
            fns=((lambda x=xr: ops.nvfp4_qdq(x, scope="row")),
                 (lambda x=xr: ref.nvfp4_qdq_ref(x, None, "row")), None),
            old=(lambda x=xr: old_call(x, "row"))))
        del stack, x, y, y32, absref, diff, one_ulp
    print(f"[kernel] rglru_hybrid shapes: nvfp4_matmul on [layer, inner] "
          f"slices of two-axis stacks within its bound at M in ({n_slots}, "
          f"{BATCH * PROMPT}), rows bitwise equal; nvfp4_qdq row scope "
          f"bitwise at [{n_slots}, 1, K] ({len(rg_sites)} sites)", flush=True)

    elapsed("3i")
    # ---- 3i. the shapes of rwkv6-3b, whisper-tiny and qwen2-vl-2b ---------
    phase_3i(dev, gen, rows, err, err_bound)

    elapsed("4")
    # ---- 4. smoke model: card vs CPU on the same weights ------------------
    scfg = configs.get_smoke("acereason-7b")
    sparams, _ = serve.load_quantized(scfg, SEED, "packed", "cpu")
    cparams = params_to(sparams, dev)
    sprompt = torch.randint(4, scfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(SEED))
    model = get_model(scfg)
    sq = specs.serve_qconfig(scfg)
    with torch.inference_mode():
        l_cpu, _ = model.prefill(scfg, sparams, {"tokens": sprompt}, sq)
        l_gpu, _ = model.prefill(scfg, cparams, {"tokens": sprompt.to(dev)}, sq)
    if not torch.allclose(l_gpu.float().cpu(), l_cpu.float(), rtol=1e-2,
                          atol=1e-2):
        fail("smoke prefill logits on the card differ from the CPU's")
    t_cpu, _ = serve.serve_batch(scfg, sparams, sprompt, 6)
    t_gpu, _ = serve.serve_batch(scfg, cparams, sprompt.to(dev), 6)
    print(f"[smoke] {scfg.name}: card vs CPU prefill logits within 1e-2; "
          f"greedy tokens {'AGREE' if torch.equal(t_cpu, t_gpu.cpu()) else 'DISAGREE'}",
          flush=True)

    # one smoke QAD step, card against CPU: the same weights and batch
    tcfg = configs.get_smoke(TRAIN["arch"])
    tmodel = get_model(tcfg)
    topt = AdamW(lr=warmup_cosine(1e-3, 0, 10), clip_norm=1.0)
    tq = specs.recipe_qconfig(tcfg)
    step_fn = qad.make_train_step(tmodel, tcfg, tq, topt)
    st_cpu = qad.init_state(tmodel, tcfg, torch.Generator().manual_seed(SEED),
                            topt, device="cpu")
    to_dev = lambda tree: common.tree_map(lambda t: t.to(dev), tree)
    st_gpu = qad.TrainState(
        step=st_cpu.step.to(dev), student=to_dev(st_cpu.student),
        teacher=to_dev(st_cpu.teacher),
        opt_state=type(st_cpu.opt_state)(*map(to_dev, st_cpu.opt_state)))
    sbatch = make_batch(DataConfig(tcfg.vocab_size, 32, 4, seed=SEED), 0)
    new_cpu, m_cpu = step_fn(st_cpu, sbatch)
    ops.reset_launches()
    new_gpu, m_gpu = step_fn(st_gpu, {k: v.to(dev) for k, v in sbatch.items()})
    torch.cuda.synchronize()
    if not (ops.launches["kl_loss"] == ops.launches["kl_loss_bwd"] == 1
            and ops.launches["nvfp4_qdq"] == 10 * tcfg.n_layers):
        fail(f"smoke QAD step on the card: launches {ops.launches}")
    srel = {k: abs(float(m_gpu[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
            for k in STEP_TOL}
    worst = 0.0
    for a, b in zip(common.tree_leaves(new_gpu.student),
                    common.tree_leaves(new_cpu.student)):
        a, b = a.float().cpu(), b.float()
        lim = ulp(torch.maximum(a.abs(), b.abs()), 7) + 2 * 1e-3
        worst = max(worst, float(((a - b).abs() / lim).max()))
    print(f"[smoke] {tcfg.name} QAD step, card vs CPU: loss {float(m_gpu['loss']):.6g} "
          f"vs {float(m_cpu['loss']):.6g} (rel {srel['loss']:.2e}), grad_norm rel "
          f"{srel['grad_norm']:.2e}, updated params at {worst:.3f} of their "
          f"tolerance", flush=True)
    for k, tol in STEP_TOL.items():
        if srel[k] > tol:
            fail(f"smoke QAD step: {k} on the card differs from the CPU's by {srel[k]}")
    if worst > 1.0:
        fail("smoke QAD step: updated parameters differ beyond 1 bf16 ulp + 2 lr")
    del st_gpu, new_gpu, st_cpu, new_cpu
    # the slab families and M-RoPE at smoke size
    phase_4_families(dev)

    elapsed("5")
    # ---- 5. the static serving path: acereason-7b, full width, packed -----
    scfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, pqcfg = serve.load_quantized(scfg, SEED, "packed", dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    wr = serve.weight_report(params)
    print(f"[serve] {scfg.name} full width, depth {scfg.n_layers}: weights "
          f"total={wr['total_bytes']/1e9:.3f}GB quantized-gemm="
          f"{wr['q_bytes']/1e9:.3f}GB over {wr['q_params']/1e9:.3f}B params "
          f"({wr['q_bytes_per_param']:.4f} B/param) load+pack={t_load:.1f}s",
          flush=True)
    if abs(wr["q_bytes_per_param"] - nvfp4.BYTES_PER_ELEM) > 0.01:
        fail(f"packed weights cost {wr['q_bytes_per_param']} B/param")
    prompts = torch.randint(4, scfg.vocab_size, (BATCH, PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    ops.reset_launches()
    toks, stats = serve.serve_batch(scfg, params, prompts, GEN)
    launches = dict(ops.launches)
    per_forward = 5 * scfg.n_layers
    print(f"[serve] batch={BATCH} prompt={PROMPT} gen={GEN} "
          f"prefill_ms={stats['prefill_s']*1e3:.2f} "
          f"decode_ms_per_step={stats['decode_s']*1e3/stats['decode_steps']:.3f} "
          f"decode_tok_s={stats['decode_tok_s']:.1f} "
          f"e2e_tok_s={stats['e2e_tok_s']:.1f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated()/1e9:.2f}", flush=True)
    print(f"[serve] launches {launches} (expected {GEN * per_forward} each: "
          f"{per_forward} per forward x {GEN} forwards)", flush=True)
    for k in ("nvfp4_qdq", "nvfp4_matmul"):
        if launches[k] == 0:
            fail(f"the main path never launched {k}")
        if launches[k] != GEN * per_forward:
            fail(f"{k} launched {launches[k]} times, expected {GEN * per_forward}")
    if tuple(toks.shape) != (BATCH, GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= scfg.vocab_size:
        fail(f"bad tokens {tuple(toks.shape)}")
    print(f"[serve] sample tokens: {toks[0].tolist()}", flush=True)

    model = get_model(scfg)
    sq = specs.serve_qconfig(scfg)
    with torch.inference_mode():
        lp, cache = model.prefill(scfg, params, {"tokens": prompts}, sq,
                                  s_max=PROMPT + 4)
        # where a decode step's time goes: device busy vs wall, by kernel
        nxt = lp[:, -1:].argmax(-1)
        model.decode_step(scfg, params, cache, {"tokens": nxt}, sq)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                model.decode_step(scfg, params, cache, {"tokens": nxt}, sq)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    by_kernel, n_port, n_qdq, n_other = trace_ops(prof, 2)
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"[trace] decode step (traced): wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / wall_ms:.3f}; "
          f"device ops per step: {n_port:.0f} of the port's kernels ({n_qdq:.0f} "
          f"QDQ), {n_other:.0f} others", flush=True)
    for kname, ms in top:
        print(f"[trace]   {ms:8.3f} ms  {kname[:110]}")
    lp = lp.float()
    if not bool(torch.isfinite(lp).all()) or lp.shape != (BATCH, 1, scfg.vocab_size):
        fail(f"packed prefill logits not finite or shape {tuple(lp.shape)}")
    del cache
    qparams, _ = serve.load_quantized(scfg, SEED, "qdq", dev)
    sq_w = dataclasses.replace(sq, quantize_activations=False)
    with torch.inference_mode():
        lq, _ = model.prefill(scfg, qparams, {"tokens": prompts}, sq)
        lpw, _ = model.prefill(scfg, params, {"tokens": prompts}, sq_w)
        lqw, _ = model.prefill(scfg, qparams, {"tokens": prompts}, sq_w)
        # layer by layer on the QDQ path's hidden states: each packed layer
        # against its QDQ twin on the same input (no compounding), and the
        # packed stack run on its own (compounding)
        from repro_torch.models import decoder
        pos = torch.arange(PROMPT, device=dev).expand(BATCH, PROMPT)
        layer_err = {"bf16_act": [], "nvfp4": []}
        free_err = []
        for mode, qc in (("bf16_act", sq_w), ("nvfp4", sq)):
            x = qparams["embed"][prompts]
            hp = x
            for li in range(scfg.n_layers):
                pl = common.layer_slice(params["layers"], li)
                ql = common.layer_slice(qparams["layers"], li)
                yq = decoder._block(qc, scfg, ql, x, pos, "train", None, None).float()
                yp = decoder._block(qc, scfg, pl, x, pos, "train", None, None).float()
                layer_err[mode].append(
                    float((yp - yq).norm() / (yq - x.float()).norm()))
                if mode == "nvfp4":
                    hp = decoder._block(qc, scfg, pl, hp, pos, "train", None, None)
                    free_err.append(float((hp.float() - yq).norm() / yq.norm()))
                x = yq.to(torch.bfloat16)
    for mode, errs in layer_err.items():
        print(f"[serve] per layer, packed vs qdq on the same input, {mode} "
              f"(rel. to the layer's update; tolerance {LAYER_TOL[mode]}): "
              + " ".join(f"{e:.2e}" for e in errs), flush=True)
    print("[serve] per layer, packed stack vs qdq stack, nvfp4 (rel. to the "
          "hidden state): " + " ".join(f"{e:.2e}" for e in free_err), flush=True)

    rel = {"bf16_act": rel_l2(lpw, lqw), "nvfp4": rel_l2(lp, lq)}
    top1 = float((lp.argmax(-1) == lq.float().argmax(-1)).float().mean())
    print(f"[serve] packed vs qdq first-step logits, BF16 activations: "
          f"rel_l2={rel['bf16_act']:.4g} (tolerance {LOGIT_TOL['bf16_act']})",
          flush=True)
    print(f"[serve] packed vs qdq first-step logits, NVFP4 activations: "
          f"rel_l2={rel['nvfp4']:.4g} max_abs={float((lp - lq.float()).abs().max()):.4g} "
          f"max_logit={float(lq.float().abs().max()):.4g} top1_agree={top1:.2f} "
          f"(tolerance {LOGIT_TOL['nvfp4']})", flush=True)
    qtoks, _ = serve.serve_batch(scfg, qparams, prompts, GEN)
    agree = bool(torch.equal(toks, qtoks))
    print(f"[serve] packed-vs-qdq greedy tokens {'AGREE' if agree else 'DISAGREE'} "
          f"({float((toks == qtoks).float().mean()):.3f} of positions)", flush=True)
    del qparams, ql, pl, params
    for mode in LOGIT_TOL:
        if max(layer_err[mode]) > LAYER_TOL[mode]:
            fail(f"a packed layer differs from its QDQ twin ({mode}): "
                 f"{max(layer_err[mode])}")
        if rel[mode] > LOGIT_TOL[mode]:
            fail(f"packed and QDQ first-step logits differ ({mode}): {rel[mode]}")
    serve_launches = launches
    torch.cuda.empty_cache()

    elapsed("5b")
    # ---- 5b. the engine: full-size acereason-7b, packed --------------------
    from repro_torch.serve import Engine

    params, pqcfg = serve.load_quantized(cfg, SEED, "packed", dev)

    def drained(eng, what):
        if eng.state.leaked() or eng.pool.used_blocks != eng.pool.cached_blocks:
            fail(f"engine {what}: the pool did not drain "
                 f"({eng.pool.active_blocks} blocks still referenced)")

    a_prompts = serve.mixed_prompts(RUN_A["requests"], RUN_A["min_prompt"],
                                    RUN_A["max_prompt"], cfg.vocab_size, SEED + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, pqcfg, device=dev, **ENGINE)
    a_first = first_decode_logits(eng)
    a_pre = prefill_logits(eng)
    ops.reset_launches()
    t0 = time.perf_counter()
    a_rids, a_out = serve.run_workload(eng, a_prompts, RUN_A["gen"])
    torch.cuda.synchronize()
    a_wall = time.perf_counter() - t0
    a_launches = dict(ops.launches)
    a_peak = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats()
    print(f"[engine A] {cfg.name} full size, packed: {RUN_A['requests']} requests, "
          f"prompts {RUN_A['min_prompt']}..{RUN_A['max_prompt']}, gen {RUN_A['gen']}, "
          f"{ENGINE['n_slots']} slots, pool {ENGINE['n_blocks']}x{ENGINE['block_size']}, "
          f"exact prefill, reserve: wall {a_wall:.2f}s, steps {st['steps']}, "
          f"decode steps {st['decode_steps']}", flush=True)
    print(f"[engine A] ttft_p50_ms={st['ttft_p50_s']*1e3:.1f} "
          f"ttft_p95_ms={st['ttft_p95_s']*1e3:.1f} "
          f"decode_step_p50_ms={st['decode_step_p50_s']*1e3:.2f} "
          f"decode_step_p95_ms={st['decode_step_p95_s']*1e3:.2f} "
          f"decode_tok_s={st['decode_tok_s']:.1f} e2e_tok_s={st['e2e_tok_s']:.1f} "
          f"prefill_s={st['prefill_s']:.2f} decode_s={st['decode_s']:.2f} "
          f"peak_pool_util={st['peak_utilization']:.2f} peak_mem_gb={a_peak:.2f}",
          flush=True)
    print(f"[engine A] launches {a_launches}", flush=True)
    if len(a_out) != RUN_A["requests"] or any(
            len(a_out[r]) != RUN_A["gen"] for r in a_rids):
        fail(f"engine A: {len(a_out)} of {RUN_A['requests']} requests finished")
    drained(eng, "A")
    if a_launches["paged_attention"] != cfg.n_layers * st["decode_steps"]:
        fail(f"engine A launched paged_attention {a_launches['paged_attention']} "
             f"times, expected {cfg.n_layers} x {st['decode_steps']} decode steps")
    for k in ("nvfp4_qdq", "nvfp4_matmul"):
        if a_launches[k] == 0:
            fail(f"engine A never launched {k}")
    first_ok = 0
    for rid, p in zip(a_rids, a_prompts):
        ref_tok, _ = serve.serve_batch(cfg, params, torch.from_numpy(
            p[None].astype("int64")).to(dev), 1)
        first_ok += int(ref_tok[0, 0]) == int(a_out[rid][0])
    print(f"[engine A] first tokens equal to single-request serve_batch: "
          f"{first_ok}/{len(a_rids)}", flush=True)
    if first_ok != len(a_rids):
        fail("engine A: a first token differs from single-request serve_batch")

    # one traced decode step: 8 running requests, nothing left to prefill
    t = trace_filled(eng, a_prompts, "engine decode step")
    by_kernel, n_port, n_qdq, n_other, wall_ms, step_launches = (
        t["by_kernel"], t["n_port"], t["n_qdq"], t["n_other"], t["wall_ms"],
        t["launches"])
    busy_ms = sum(by_kernel.values())
    k7_ms = sum(ms for kname, ms in by_kernel.items()
                if "paged_attention_kernel" in kname)
    print(f"[trace] engine decode step, 8 slots (traced): wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / wall_ms:.3f} "
          f"paged_attention_ms={k7_ms:.3f} ({step_launches['paged_attention']} "
          f"launches); device ops: {n_port:.0f} of the port's kernels "
          f"({n_qdq:.0f} QDQ for {step_launches['nvfp4_qdq']} QDQ calls), "
          f"{n_other:.0f} others", flush=True)
    if n_qdq != step_launches["nvfp4_qdq"]:
        fail(f"engine A decode step: {n_qdq} QDQ kernels for "
             f"{step_launches['nvfp4_qdq']} QDQ calls")
    engine_a_trace = dict(wall_ms=wall_ms, busy_ms=busy_ms, k7_ms=k7_ms,
                          n_port=n_port, n_qdq=n_qdq, n_other=n_other)
    for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[trace]   {ms:8.3f} ms  {kname[:110]}")

    # the same traffic with the two-step attention
    eng_off = Engine(cfg, params, pqcfg, device=dev, fused_kernels="off", **ENGINE)
    off_first = first_decode_logits(eng_off)
    off_rids, off_out = serve.run_workload(eng_off, a_prompts, RUN_A["gen"])
    drained(eng_off, "A, unfused")
    fused_rel = [float((a_first[a].float() - off_first[b].float()).norm()
                       / off_first[b].float().norm())
                 for a, b in zip(a_rids, off_rids)]
    agree = sum(np.array_equal(a_out[a], off_out[b]) for a, b in zip(a_rids, off_rids))
    pos_agree = float(np.mean([np.mean(a_out[a] == off_out[b])
                               for a, b in zip(a_rids, off_rids)]))
    print(f"[engine A] fused vs unfused first-decode logits rel_l2: max "
          f"{max(fused_rel):.4g} median {float(np.median(fused_rel)):.4g} "
          f"(tolerance {FUSED_TOL}); greedy streams equal {agree}/{len(a_rids)}, "
          f"{pos_agree:.3f} of positions (printed, not gated)", flush=True)
    if max(fused_rel) > FUSED_TOL:
        fail(f"engine A: fused and unfused first-decode logits differ by "
             f"{max(fused_rel)}")
    engine_a = dict(st=st, wall=a_wall, peak=a_peak)
    # the oracle of the TP run (5d): run A's prefill logits of its first
    # requests, on the host
    a_pre_all = [a_pre[r] for r in a_rids]       # phase 5g's oracle
    a_pre = [a_pre[r].cpu() for r in a_rids[:RUN_TP["requests"]]]
    del eng, eng_off, a_first, off_first

    # run B: shared 256-token prefix, paged prefill, prefix cache
    bgen = torch.Generator().manual_seed(SEED + 3)
    head = torch.randint(4, cfg.vocab_size, (RUN_B["prefix"],), generator=bgen)
    b_prompts = [torch.cat([head, torch.randint(4, cfg.vocab_size, (int(n),),
                                                generator=bgen)]).numpy().astype("int32")
                 for n in np.linspace(RUN_B["min_suffix"], RUN_B["max_suffix"],
                                      RUN_B["requests"]).round()]

    def run_b(prefix_cache):
        e = Engine(cfg, params, pqcfg, device=dev, prefill_mode="paged",
                   kv_alloc="ondemand", prefix_cache=prefix_cache, **ENGINE)
        ops.reset_launches()
        t0 = time.perf_counter()
        rids, out = serve.run_workload(e, b_prompts, RUN_B["gen"])
        torch.cuda.synchronize()
        return e, rids, out, time.perf_counter() - t0, dict(ops.launches)

    eng_b, b_rids, b_out, b_wall, b_launches = run_b(True)
    stb = eng_b.stats()
    cst = stb["prefix_cache"]
    chunks = sum(-(-(r.prompt_len - r.n_cache_hit) // ENGINE["block_size"])
                 for r in eng_b.sched.finished.values())
    print(f"[engine B] shared {RUN_B['prefix']}-token prefix, suffixes "
          f"{RUN_B['min_suffix']}..{RUN_B['max_suffix']}, gen {RUN_B['gen']}, paged "
          f"prefill, on-demand, prefix cache: wall {b_wall:.2f}s, "
          f"ttft_p50_ms={stb['ttft_p50_s']*1e3:.1f} ttft_p95_ms={stb['ttft_p95_s']*1e3:.1f} "
          f"decode_step_p50_ms={stb['decode_step_p50_s']*1e3:.2f} "
          f"decode_tok_s={stb['decode_tok_s']:.1f} e2e_tok_s={stb['e2e_tok_s']:.1f} "
          f"hits={cst['hits']} misses={cst['misses']} evictions={cst['evictions']} "
          f"preempts={stb['preempts']} prefill chunks={chunks} "
          f"decode steps={stb['decode_steps']}", flush=True)
    print(f"[engine B] launches {b_launches}", flush=True)
    drained(eng_b, "B")
    if b_launches["paged_attention"] != cfg.n_layers * (chunks + stb["decode_steps"]):
        fail(f"engine B launched paged_attention {b_launches['paged_attention']} "
             f"times, expected {cfg.n_layers} x ({chunks} chunks + "
             f"{stb['decode_steps']} decode steps)")
    eng_c, c_rids, c_out, c_wall, _ = run_b(False)
    drained(eng_c, "B, cache off")
    same = all(np.array_equal(b_out[a], c_out[b]) for a, b in zip(b_rids, c_rids))
    print(f"[engine B] cache on vs off (wall {c_wall:.2f}s): greedy tokens "
          f"{'bitwise EQUAL' if same else 'DIFFER'}; preempts "
          f"{stb['preempts']} / {eng_c.preempts}", flush=True)
    if not same:
        fail("engine B: tokens with the prefix cache differ from without it")
    if cst["hits"] == 0 or stb["preempts"] or eng_c.preempts:
        fail("engine B: no cache hit, or a preemption the sizing rules out")
    engine_b = dict(st=stb, wall=b_wall)
    del eng_b, eng_c

    elapsed("5g")
    # ---- 5g. chunked prefill: run A's traffic, chunks of 256 ---------------
    # each chunk's activation amaxes cover the chunk (padding included), so
    # a request's prefill logits approximate exact prefill's, run A's
    from repro_torch.models import decoder as mdecoder
    chunk = RUN_G["chunk"]
    eng_g = Engine(cfg, params, pqcfg, device=dev, prefill_mode="chunked",
                   prefill_chunk=chunk, **ENGINE)
    g_pre = prefill_logits(eng_g)
    ops.reset_launches()
    t0 = time.perf_counter()
    g_rids, g_out = serve.run_workload(eng_g, a_prompts, RUN_A["gen"])
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    g_launches = dict(ops.launches)
    stg, sta = eng_g.stats(), engine_a["st"]
    g_chunks = sum(-(-len(p) // chunk) for p in a_prompts)
    print(f"[engine G] {cfg.name} full size, packed: run A's traffic, chunked "
          f"prefill ({chunk}-token chunks, {g_chunks} of them, budget "
          f"{eng_g.prefill_budget}): wall {g_wall:.2f}s, steps {stg['steps']}, "
          f"decode steps {stg['decode_steps']}; ttft_p50_ms="
          f"{stg['ttft_p50_s']*1e3:.1f} ttft_p95_ms={stg['ttft_p95_s']*1e3:.1f} "
          f"(run A, exact prefill: {sta['ttft_p50_s']*1e3:.1f} / "
          f"{sta['ttft_p95_s']*1e3:.1f}); decode_step_p50_ms="
          f"{stg['decode_step_p50_s']*1e3:.2f} decode_tok_s="
          f"{stg['decode_tok_s']:.1f} prefill_s={stg['prefill_s']:.2f} "
          f"(run A {sta['prefill_s']:.2f})", flush=True)
    print(f"[engine G] launches {g_launches}", flush=True)
    if len(g_out) != RUN_A["requests"] or any(
            len(g_out[r]) != RUN_A["gen"] for r in g_rids):
        fail(f"engine G: {len(g_out)} of {RUN_A['requests']} requests finished")
    drained(eng_g, "G")
    n_fwd = g_chunks + stg["decode_steps"]
    g_expect = {"nvfp4_qdq": 5 * cfg.n_layers * n_fwd,
                "nvfp4_matmul": 5 * cfg.n_layers * n_fwd,
                "paged_attention": cfg.n_layers * stg["decode_steps"]}
    for k, n_want in g_expect.items():
        if g_launches[k] != n_want:
            fail(f"engine G launched {k} {g_launches[k]} times, expected "
                 f"{n_want} ({g_chunks} chunks + {stg['decode_steps']} decode "
                 "steps)")
    g_rel = [float((g_pre[g].float() - a.float()).norm() / a.float().norm())
             for g, a in zip(g_rids, a_pre_all)]
    g_agree = float(np.mean([np.mean(g_out[g] == a_out[a])
                             for g, a in zip(g_rids, a_rids)]))
    one = [i for i, p in enumerate(a_prompts) if len(p) <= chunk]
    print(f"[engine G] prefill logits vs run A's exact prefill, rel_l2: max "
          f"{max(g_rel):.4g} median {float(np.median(g_rel)):.4g} (one-chunk "
          f"prompts {[len(a_prompts[i]) for i in one]}: "
          + " ".join(f"{g_rel[i]:.4g}" for i in one)
          + f"; tolerance {LOGIT_TOL['nvfp4']}); tokens equal to run A's at "
          f"{g_agree:.3f} of positions (printed, not gated)", flush=True)
    if max(g_rel) > LOGIT_TOL["nvfp4"]:
        fail(f"engine G: chunked prefill logits differ from exact prefill's "
             f"by {max(g_rel)}")
    # a prompt of exactly one chunk: the chunk's amaxes are the prompt's
    p1 = torch.randint(4, cfg.vocab_size, (1, chunk), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(SEED + 5))
    with torch.inference_mode():
        ex, _ = mdecoder.prefill(cfg, params, {"tokens": p1}, eng_g.sq, None)
        scratch = common.zeros_from_specs(
            mdecoder.prefill_scratch_specs(cfg, eng_g.s_alloc), dev)
        pool1 = mdecoder.init_paged_pool(cfg, eng_g.max_blocks_per_slot,
                                         ENGINE["block_size"], dev)
        ch = mdecoder.prefill_chunk_paged(
            cfg, params, scratch, pool1,
            torch.arange(eng_g.max_blocks_per_slot, device=dev), 0, chunk,
            {"tokens": p1}, eng_g.sq)
    one_rel = float((ch[0, -1].float() - ex[0, -1].float()).norm()
                    / ex[0, -1].float().norm())
    one_equal = bool(torch.equal(ch[0, -1], ex[0, -1]))
    print(f"[engine G] a {chunk}-token prompt in one chunk against exact "
          f"prefill: logits {'bitwise EQUAL' if one_equal else 'differ'}, "
          f"rel_l2 {one_rel:.4g} (tolerance {LOGIT_TOL['nvfp4']})", flush=True)
    if one_rel > LOGIT_TOL["nvfp4"]:
        fail(f"engine G: a one-chunk prompt's logits differ from exact "
             f"prefill's by {one_rel}")
    del eng_g, g_pre, a_pre_all, scratch, pool1, ch, ex
    gc.collect()

    elapsed("5l")
    # ---- 5l. speculative decoding on run A's loads and traffic ------------
    l_launches = phase_5l_ace(dev, cfg, params, pqcfg, a_prompts,
                              [a_out[r] for r in a_rids], engine_a["st"])

    elapsed("5m")
    # ---- 5m. serving telemetry on run A's loads ----------------------------
    m5_launches = phase_5m(dev, cfg, params, pqcfg, a_prompts, b_prompts,
                           [b_out[r] for r in b_rids])
    # ---- 5n (d), its oracle: the single-device shadow on run A's tree -----
    n_ctx = RUN_NTP["shadow_contexts"]
    shadow_ctx = [np.asarray(p, np.int64) for p in
                  sorted(a_prompts, key=len)[:n_ctx]]
    shadow_single = shadow_oracle(dev, cfg, params, pqcfg, shadow_ctx)
    del params
    # the engines whose decode the recorders wrap sit in reference cycles
    # (engine -> state -> wrapper -> state): collect them, or their weights
    # stay alive into the next phase's peak-memory reading
    gc.collect()
    torch.cuda.empty_cache()

    elapsed("5c")
    # ---- 5c. MoE serving: full-size qwen2-moe-a2.7b through the engine ----
    from repro_torch.models import layers as mlayers

    n_moe = mcfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mparams, mqcfg = serve.load_quantized(mcfg, SEED, "packed", dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    wr = serve.weight_report(mparams)
    print(f"[engine M] {mcfg.name} full size ({n_moe} layers, {n_exp} experts "
          f"top-{mcfg.experts_per_tok}, shared expert {mcfg.shared_d_ff}): "
          f"weights total={wr['total_bytes']/1e9:.3f}GB quantized-gemm="
          f"{wr['q_bytes']/1e9:.3f}GB over {wr['q_params']/1e9:.3f}B params "
          f"({wr['q_bytes_per_param']:.4f} B/param) load+pack={t_load:.1f}s "
          f"peak_mem_gb={torch.cuda.max_memory_allocated()/1e9:.2f}", flush=True)
    if abs(wr["q_bytes_per_param"] - nvfp4.BYTES_PER_ELEM) > 0.01:
        fail(f"packed MoE weights cost {wr['q_bytes_per_param']} B/param")
    m_prompts = serve.mixed_prompts(RUN_A["requests"], RUN_A["min_prompt"],
                                    RUN_A["max_prompt"], mcfg.vocab_size,
                                    SEED + 2)
    # the dropped fraction of every prefill's MoE layers, read after the run
    prefill_drops, inner_moe = [], mlayers.moe_ffn

    def moe_recording(qcfg_, cfg_, x, *a):
        out, aux = inner_moe(qcfg_, cfg_, x, *a)
        if x.shape[1] > 1:
            prefill_drops.append(aux["moe_dropped_frac"])
        return out, aux

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(mcfg, mparams, mqcfg, device=dev, fused_kernels="on", **ENGINE)
    m_first = first_decode_logits(eng)
    m_pre = prefill_logits(eng)
    mlayers.moe_ffn = moe_recording
    ops.reset_launches()
    t0 = time.perf_counter()
    m_rids, m_out = serve.run_workload(eng, m_prompts, RUN_A["gen"])
    torch.cuda.synchronize()
    m_wall = time.perf_counter() - t0
    m_launches = dict(ops.launches)
    mlayers.moe_ffn = inner_moe
    m_peak = torch.cuda.max_memory_allocated() / 1e9
    stm = eng.stats()
    drop = float(torch.stack(prefill_drops).mean()) if prefill_drops else 0.0
    print(f"[engine M] {RUN_A['requests']} requests, prompts {RUN_A['min_prompt']}.."
          f"{RUN_A['max_prompt']}, gen {RUN_A['gen']}, {ENGINE['n_slots']} slots, "
          f"pool {ENGINE['n_blocks']}x{ENGINE['block_size']}, exact prefill, "
          f"reserve, fused on ({stm['packed_backend']}, dispatch "
          f"{stm['moe_dispatch']}): wall {m_wall:.2f}s, steps {stm['steps']}, "
          f"decode steps {stm['decode_steps']}", flush=True)
    print(f"[engine M] ttft_p50_ms={stm['ttft_p50_s']*1e3:.1f} "
          f"ttft_p95_ms={stm['ttft_p95_s']*1e3:.1f} "
          f"decode_step_p50_ms={stm['decode_step_p50_s']*1e3:.2f} "
          f"decode_step_p95_ms={stm['decode_step_p95_s']*1e3:.2f} "
          f"decode_tok_s={stm['decode_tok_s']:.1f} e2e_tok_s={stm['e2e_tok_s']:.1f} "
          f"prefill_s={stm['prefill_s']:.2f} decode_s={stm['decode_s']:.2f} "
          f"peak_pool_util={stm['peak_utilization']:.2f} peak_mem_gb={m_peak:.2f} "
          f"prefill_dropped_frac={drop:.4f} ({len(prefill_drops)} MoE layers)",
          flush=True)
    print(f"[engine M] launches {m_launches}", flush=True)
    if len(m_out) != RUN_A["requests"] or any(
            len(m_out[r]) != RUN_A["gen"] for r in m_rids):
        fail(f"engine M: {len(m_out)} of {RUN_A['requests']} requests finished")
    drained(eng, "M")
    m_forwards = RUN_A["requests"] + stm["decode_steps"]
    if m_launches["nvfp4_matmul_grouped"] != 3 * n_moe * m_forwards:
        fail(f"engine M launched nvfp4_matmul_grouped "
             f"{m_launches['nvfp4_matmul_grouped']} times, expected 3 x "
             f"{n_moe} x {m_forwards} forwards")
    if m_launches["paged_attention"] != n_moe * stm["decode_steps"]:
        fail(f"engine M launched paged_attention {m_launches['paged_attention']} "
             f"times, expected {n_moe} x {stm['decode_steps']} decode steps")
    for k in ("nvfp4_qdq", "nvfp4_matmul"):
        if m_launches[k] == 0:
            fail(f"engine M never launched {k}")

    # one traced decode step: 8 running requests, nothing left to prefill
    t = trace_filled(eng, m_prompts, "MoE engine decode step")
    by_kernel, n_port, n_qdq, n_other, wall_ms, step_launches = (
        t["by_kernel"], t["n_port"], t["n_qdq"], t["n_other"], t["wall_ms"],
        t["launches"])
    busy_ms = sum(by_kernel.values())
    k3_ms = sum(ms for kname, ms in by_kernel.items()
                if "mma_kernel<true" in kname or "wg_kernel<true" in kname)
    k7_ms = sum(ms for kname, ms in by_kernel.items()
                if "paged_attention_kernel" in kname)
    print(f"[trace] MoE engine decode step, 8 slots (traced): wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / wall_ms:.3f} "
          f"nvfp4_matmul_grouped_ms={k3_ms:.3f} ({3 * n_moe} launches) "
          f"paged_attention_ms={k7_ms:.3f}; device ops: {n_port:.0f} of the "
          f"port's kernels ({n_qdq:.0f} QDQ for {step_launches['nvfp4_qdq']} QDQ "
          f"calls), {n_other:.0f} others", flush=True)
    if n_qdq != step_launches["nvfp4_qdq"]:
        fail(f"engine M decode step: {n_qdq} QDQ kernels for "
             f"{step_launches['nvfp4_qdq']} QDQ calls")
    for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[trace]   {ms:8.3f} ms  {kname[:110]}")
    engine_m = dict(st=stm, wall=m_wall, peak=m_peak, drop=drop,
                    busy_ms=busy_ms, wall_ms=wall_ms, k3_ms=k3_ms, k7_ms=k7_ms,
                    n_port=n_port, n_qdq=n_qdq, n_other=n_other)

    # the first 8 requests with the expert stacks dequantized and the
    # two-step attention.  Each request's first token is the fused run's, so
    # both first decode steps see the same input: a prefill near-tie can
    # flip the argmax (a top-2 gap of one bf16 ulp was seen on an H100)
    m_rids_off = m_rids[:RUN_M_OFF["requests"]]
    eng_off = Engine(mcfg, mparams, mqcfg, device=dev, fused_kernels="off",
                     **ENGINE)
    off_first = first_decode_logits(eng_off)
    off_pre = prefill_logits(eng_off, force={
        p.tobytes(): int(m_out[r][0]) for p, r in zip(m_prompts, m_rids_off)})
    ops.reset_launches()
    off_rids, off_out = serve.run_workload(eng_off, m_prompts[:RUN_M_OFF["requests"]],
                                           RUN_M_OFF["gen"])
    if ops.launches["nvfp4_matmul_grouped"] or ops.launches["paged_attention"]:
        fail(f"engine M with fused_kernels off launched {dict(ops.launches)}")
    drained(eng_off, "M, unfused")

    def rels(a_, b_):
        return [float((a_[a].float() - b_[b].float()).norm() / b_[b].float().norm())
                for a, b in zip(m_rids_off, off_rids)]
    m_rel, pre_rel = rels(m_first, off_first), rels(m_pre, off_pre)
    own_first = sum(int(m_out[a][0]) == int(off_pre[b].argmax())
                    for a, b in zip(m_rids_off, off_rids))
    n_cmp = RUN_M_OFF["gen"]
    m_agree = float(np.mean([np.mean(m_out[a][:n_cmp] == off_out[b])
                             for a, b in zip(m_rids_off, off_rids)]))
    print(f"[engine M] fused vs unfused over {len(m_rel)} requests (tolerance "
          f"{FUSED_TOL}): prefill logits rel_l2 " + " ".join(f"{x:.4g}" for x in pre_rel)
          + "; first-decode logits rel_l2 " + " ".join(f"{x:.4g}" for x in m_rel)
          + f"; unfused argmax first tokens equal {own_first}/{len(m_rel)}; "
          f"first {n_cmp} tokens equal at {m_agree:.3f} of positions (printed, "
          f"not gated)", flush=True)
    if max(m_rel + pre_rel) > FUSED_TOL:
        fail(f"engine M: fused and unfused logits differ by "
             f"{max(m_rel + pre_rel)}")
    del eng, eng_off, m_first, off_first, m_pre, off_pre

    # run M-B: shared 256-token prefix, paged prefill, prefix cache
    bgen = torch.Generator().manual_seed(SEED + 3)
    head = torch.randint(4, mcfg.vocab_size, (RUN_MB["prefix"],), generator=bgen)
    mb_prompts = [torch.cat([head, torch.randint(4, mcfg.vocab_size, (int(n),),
                                                 generator=bgen)]).numpy().astype("int32")
                  for n in np.linspace(RUN_MB["min_suffix"], RUN_MB["max_suffix"],
                                       RUN_MB["requests"]).round()]

    def run_mb(prefix_cache):
        e = Engine(mcfg, mparams, mqcfg, device=dev, fused_kernels="on",
                   prefill_mode="paged", kv_alloc="ondemand",
                   prefix_cache=prefix_cache, **ENGINE)
        ops.reset_launches()
        t0 = time.perf_counter()
        rids, out = serve.run_workload(e, mb_prompts, RUN_MB["gen"])
        torch.cuda.synchronize()
        return e, rids, out, time.perf_counter() - t0, dict(ops.launches)

    eng_mb, mb_rids, mb_out, mb_wall, mb_launches = run_mb(True)
    stmb = eng_mb.stats()
    cst = stmb["prefix_cache"]
    mb_chunks = sum(-(-(r.prompt_len - r.n_cache_hit) // ENGINE["block_size"])
                    for r in eng_mb.sched.finished.values())
    print(f"[engine M-B] shared {RUN_MB['prefix']}-token prefix, suffixes "
          f"{RUN_MB['min_suffix']}..{RUN_MB['max_suffix']}, gen {RUN_MB['gen']}, "
          f"paged prefill (dispatch {eng_mb.pcfg.moe_dispatch}), on-demand, "
          f"prefix cache: wall {mb_wall:.2f}s, "
          f"ttft_p50_ms={stmb['ttft_p50_s']*1e3:.1f} "
          f"decode_step_p50_ms={stmb['decode_step_p50_s']*1e3:.2f} "
          f"e2e_tok_s={stmb['e2e_tok_s']:.1f} hits={cst['hits']} "
          f"misses={cst['misses']} preempts={stmb['preempts']} prefill "
          f"chunks={mb_chunks} decode steps={stmb['decode_steps']}", flush=True)
    print(f"[engine M-B] launches {mb_launches}", flush=True)
    drained(eng_mb, "M-B")
    mb_forwards = mb_chunks + stmb["decode_steps"]
    if mb_launches["nvfp4_matmul_grouped"] != 3 * n_moe * mb_forwards:
        fail(f"engine M-B launched nvfp4_matmul_grouped "
             f"{mb_launches['nvfp4_matmul_grouped']} times, expected 3 x "
             f"{n_moe} x ({mb_chunks} chunks + {stmb['decode_steps']} decode steps)")
    if mb_launches["paged_attention"] != n_moe * mb_forwards:
        fail(f"engine M-B launched paged_attention {mb_launches['paged_attention']} "
             f"times, expected {n_moe} x {mb_forwards}")
    eng_mc, mc_rids, mc_out, mc_wall, _ = run_mb(False)
    drained(eng_mc, "M-B, cache off")
    same = all(np.array_equal(mb_out[a], mc_out[b]) for a, b in zip(mb_rids, mc_rids))
    print(f"[engine M-B] cache on vs off (wall {mc_wall:.2f}s): greedy tokens "
          f"{'bitwise EQUAL' if same else 'DIFFER'}; preempts "
          f"{stmb['preempts']} / {eng_mc.preempts}", flush=True)
    if not same:
        fail("engine M-B: tokens with the prefix cache differ from without it")
    if cst["hits"] == 0 or stmb["preempts"] or eng_mc.preempts:
        fail("engine M-B: no cache hit, or a preemption the sizing rules out")
    engine_mb = dict(st=stmb, wall=mb_wall, wall_off=mc_wall)
    del eng_mb, eng_mc, mparams
    gc.collect()
    torch.cuda.empty_cache()

    elapsed("5k")
    # ---- 5k. FP8 KV: qwen2-moe-a2.7b under moe_hybrid; speculative on it --
    k_launches = phase_5k(dev, row_inv)


    elapsed("5e")
    # ---- 5e. the rglru_hybrid family through the slab engine ---------------
    from repro_torch.models import rglru

    # nemotron-nano-9b-sim at full width and depth, packed, the hybrid
    # recipe; run A's traffic on the slab plan (recurrent + dense_kv)
    ncfg = configs.get_config(NEMO_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nparams, nqcfg = serve.load_quantized(ncfg, SEED, "packed", dev)
    torch.cuda.synchronize()
    n_load_s = time.perf_counter() - t0
    n_load_peak = torch.cuda.max_memory_allocated() / 1e9
    nwr = serve.weight_report(nparams)
    n_total = sum(math.prod(sp.shape) for sp in
                  common.tree_leaves(rglru.param_specs(ncfg)))
    embed_b = nparams["embed"].numel() * nparams["embed"].element_size()
    attn_b = sum(a.numel() * a.element_size()
                 for a in common.tree_leaves(nparams["blocks"]["attn"])
                 if not isinstance(a, nvfp4.PackedNVFP4))
    head_b = nparams["lm_head"].numel() * nparams["lm_head"].element_size()
    # a decode step reads every weight once but the embedding (a lookup)
    n_step_b = nwr["total_bytes"] - embed_b
    print(f"[engine E] {ncfg.name}: {ncfg.n_layers} layers ({rglru._counts(ncfg)[0]} "
          f"super-blocks of {ncfg.attn_period - 1} RG-LRU layers and one "
          f"attention layer), d_model {ncfg.d_model}, {n_total / 1e9:.3f} B params "
          f"({2 * n_total / 1e9:.2f} GB in bf16); load + PTQ {n_load_s:.1f}s, "
          f"peak {n_load_peak:.2f} GB ({resident_gb:.2f} resident before); "
          f"packed {nwr['q_params'] / 1e9:.3f} B params in "
          f"{nwr['q_bytes'] / 1e9:.3f} GB ({nwr['q_bytes_per_param']:.4f} B/param), "
          f"BF16 attention {attn_b / 1e9:.3f} GB, lm_head {head_b / 1e9:.3f} GB; "
          f"decode bound {n_step_b / 1e9:.3f} GB a step at "
          f"{HBM_BYTES_S / 1e12:.2f} TB/s = {n_step_b / HBM_BYTES_S * 1e3:.2f} ms "
          "(every weight but the embedding read once; the state slabs "
          "besides)", flush=True)
    # run A's lengths, tokens from nemotron's (smaller) vocabulary
    e_prompts = serve.mixed_prompts(RUN_A["requests"], RUN_A["min_prompt"],
                                    RUN_A["max_prompt"], ncfg.vocab_size,
                                    SEED + 2)
    torch.cuda.reset_peak_memory_stats()
    eng_e = Engine(ncfg, nparams, nqcfg, device=dev, **ENGINE)
    e_first = first_decode_logits(eng_e)
    e_pre = prefill_logits(eng_e)
    ops.reset_launches()
    t0 = time.perf_counter()
    e_rids, e_out = serve.run_workload(eng_e, e_prompts, RUN_A["gen"])
    torch.cuda.synchronize()
    e_wall = time.perf_counter() - t0
    e_launches = dict(ops.launches)
    e_peak = torch.cuda.max_memory_allocated() / 1e9
    ste = eng_e.stats()
    print(f"[engine E] {ncfg.name} full size, packed, slab plan "
          f"{'+'.join(eng_e.state_plan)}: run A's traffic ({RUN_A['requests']} "
          f"requests, prompts {RUN_A['min_prompt']}..{RUN_A['max_prompt']}, gen "
          f"{RUN_A['gen']}, {ENGINE['n_slots']} slots, exact prefill): wall "
          f"{e_wall:.2f}s, steps {ste['steps']}, decode steps "
          f"{ste['decode_steps']}; state {ste['state_bytes_per_slot'] / 2**20:.2f} "
          f"MiB a slot ({ste['pool_bytes'] / 1e9:.3f} GB for "
          f"{ENGINE['n_slots']}, dense KV bound {ste['state_dense_bound']})",
          flush=True)
    print(f"[engine E] ttft_p50_ms={ste['ttft_p50_s']*1e3:.1f} "
          f"ttft_p95_ms={ste['ttft_p95_s']*1e3:.1f} "
          f"decode_step_p50_ms={ste['decode_step_p50_s']*1e3:.2f} "
          f"decode_step_p95_ms={ste['decode_step_p95_s']*1e3:.2f} "
          f"decode_tok_s={ste['decode_tok_s']:.1f} e2e_tok_s={ste['e2e_tok_s']:.1f} "
          f"prefill_s={ste['prefill_s']:.2f} decode_s={ste['decode_s']:.2f} "
          f"serving_peak_gb={e_peak:.2f} load_peak_gb={n_load_peak:.2f}",
          flush=True)
    print(f"[engine E] launches {e_launches}", flush=True)
    if len(e_out) != RUN_A["requests"] or any(
            len(e_out[r]) != RUN_A["gen"] for r in e_rids):
        fail(f"engine E: {len(e_out)} of {RUN_A['requests']} requests finished")
    slab_drained(eng_e, "E")
    per_rec, per_attn, n_rec_l, n_attn_l = rec_sites(ncfg, eng_e.sq)
    per_fwd = per_rec * n_rec_l + per_attn * n_attn_l
    e_fwd = RUN_A["requests"] + ste["decode_steps"]
    for k in ("nvfp4_qdq", "nvfp4_matmul"):
        if e_launches[k] != per_fwd * e_fwd:
            fail(f"engine E launched {k} {e_launches[k]} times, expected "
                 f"{per_fwd} a forward ({per_rec} x {n_rec_l} recurrent + "
                 f"{per_attn} x {n_attn_l} attention layers) x {e_fwd} "
                 f"forwards ({RUN_A['requests']} prefills + "
                 f"{ste['decode_steps']} decode steps)")
    if e_launches["paged_attention"] or e_launches["nvfp4_matmul_grouped"]:
        fail(f"engine E launched a paged-plan kernel: {e_launches}")
    # each request against the port's serve_batch path on its prompt:
    # prefill at s_max = prompt + gen, then one decode step fed the
    # engine's first token
    nsq = specs.serve_qconfig(ncfg)
    e_rel_p, e_rel_d = [], []
    with torch.inference_mode():
        for rid, p in zip(e_rids, e_prompts):
            toks = torch.from_numpy(p[None].astype("int64")).to(dev)
            lp, cache = rglru.prefill(ncfg, nparams, {"tokens": toks}, nsq,
                                      s_max=len(p) + RUN_A["gen"])
            first = torch.full((1, 1), int(e_out[rid][0]), dtype=torch.int64,
                               device=dev)
            ld, _ = rglru.decode_step(ncfg, nparams, cache, {"tokens": first},
                                      nsq)
            for got, want, acc in ((e_pre[rid], lp[0, -1], e_rel_p),
                                   (e_first[rid], ld[0, -1], e_rel_d)):
                acc.append(float((got.float() - want.float()).norm()
                                 / want.float().norm()))
            del cache
    print(f"[engine E] against serve_batch's prefill and first decode step "
          f"on each prompt, rel_l2: prefill max {max(e_rel_p):.4g} median "
          f"{float(np.median(e_rel_p)):.4g}, first decode step max "
          f"{max(e_rel_d):.4g} median {float(np.median(e_rel_d)):.4g} "
          f"(tolerance {LOGIT_TOL['nvfp4']})", flush=True)
    if max(e_rel_p + e_rel_d) > LOGIT_TOL["nvfp4"]:
        fail(f"engine E: logits differ from serve_batch's by "
             f"{max(e_rel_p + e_rel_d)}")
    trace_slab_step(eng_e, e_prompts, "nemotron engine")
    # phase 5o's oracle: the shortest prompts' prefill logits and streams
    n_o = RUN_OTP["nemo_requests"]
    slab_oracles = {"a": dict(
        arch=NEMO_ARCH, plan=eng_e.state_plan, what="run E's shortest",
        prompts=e_prompts[:n_o], extras=None, gen=RUN_OTP["nemo_gen"],
        engine=ENGINE, fault="z", pre=[e_pre[r].cpu() for r in e_rids[:n_o]],
        tokens=[e_out[r] for r in e_rids[:n_o]], pool_bytes=ste["pool_bytes"],
        whole=set(), **slab_prefill_controls(eng_e, e_prompts[:n_o], None))}
    del eng_e, e_first, e_pre, nparams
    gc.collect()
    torch.cuda.empty_cache()

    elapsed("5f")
    # ---- 5f. recurrentgemma-2b at full size: the window ring wraps ---------
    rcfg = configs.get_config(RGEMMA["arch"])
    rparams, rqcfg = serve.load_quantized(rcfg, SEED, "packed", dev)
    f_prompts = serve.mixed_prompts(RGEMMA["requests"], RGEMMA["min_prompt"],
                                    RGEMMA["max_prompt"], rcfg.vocab_size,
                                    SEED + 4)
    bs = ENGINE["block_size"]
    f_mb = -(-(RGEMMA["max_prompt"] + RGEMMA["gen"]) // bs)
    eng_f = Engine(rcfg, rparams, rqcfg, device=dev,
                   n_slots=RGEMMA["requests"], block_size=bs,
                   max_blocks_per_slot=f_mb)
    f_first, f_pre = first_decode_logits(eng_f), prefill_logits(eng_f)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    f_rids, f_out = serve.run_workload(eng_f, f_prompts, RGEMMA["gen"])
    torch.cuda.synchronize()
    f_wall = time.perf_counter() - t0
    f_launches = dict(ops.launches)
    stf = eng_f.stats()
    print(f"[engine F] {rcfg.name} full size ({rcfg.n_layers} layers, window "
          f"{rcfg.window}), packed, slab plan {'+'.join(eng_f.state_plan)}: "
          f"{RGEMMA['requests']} requests of prompts "
          f"{[len(p) for p in f_prompts]}, gen {RGEMMA['gen']}: wall "
          f"{f_wall:.2f}s, ttft_p50_ms={stf['ttft_p50_s']*1e3:.1f} "
          f"decode_step_p50_ms={stf['decode_step_p50_s']*1e3:.2f} "
          f"decode_tok_s={stf['decode_tok_s']:.1f}; state "
          f"{stf['state_bytes_per_slot'] / 2**20:.2f} MiB a slot; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{f_launches}", flush=True)
    if len(f_out) != RGEMMA["requests"] or any(
            len(f_out[r]) != RGEMMA["gen"] for r in f_rids):
        fail(f"engine F: {len(f_out)} of {RGEMMA['requests']} requests finished")
    slab_drained(eng_f, "F")
    # the same requests one slot at a time and at 4 slots: the greedy
    # streams must equal serve_batch's token for token in both.  (At 4
    # slots they parted after the first token until the slab decode's
    # attention ran its f32 products one slot a call: cuBLAS's batched
    # kernel summed a slot's scores in an order that depended on the batch;
    # the BF16 GEMMs' rows do not depend on M at these shapes, phase 3l.)
    eng_1 = Engine(rcfg, rparams, rqcfg, device=dev, n_slots=1, block_size=bs,
                   max_blocks_per_slot=f_mb)
    one_rids, one_out = serve.run_workload(eng_1, f_prompts, RGEMMA["gen"])
    slab_drained(eng_1, "F, one slot")
    nsq = specs.serve_qconfig(rcfg)
    f_agree, f_rel, f_want = [], [], []
    for rid, orid, p in zip(f_rids, one_rids, f_prompts):
        toks = torch.from_numpy(p[None].astype("int64")).to(dev)
        want, _ = serve.serve_batch(rcfg, rparams, toks, RGEMMA["gen"])
        want = want[0].cpu().numpy()
        f_want.append(want)
        if not np.array_equal(want, one_out[orid]):
            fail(f"engine F at one slot: request {orid} {one_out[orid][:12].tolist()} "
                 f"against serve_batch's {want[:12].tolist()}")
        f_agree.append(float(np.mean(want == f_out[rid])))
        if not np.array_equal(want, f_out[rid]):
            fail(f"engine F at {RGEMMA['requests']} slots: request {rid} "
                 f"{f_out[rid][:12].tolist()} against serve_batch's "
                 f"{want[:12].tolist()}")
        with torch.inference_mode():
            _, cache = rglru.prefill(rcfg, rparams, {"tokens": toks}, nsq,
                                     s_max=len(p) + RGEMMA["gen"])
            ld, _ = rglru.decode_step(rcfg, rparams, cache, {"tokens": torch.full(
                (1, 1), int(want[0]), dtype=torch.int64, device=dev)}, nsq)
        f_rel.append(float((f_first[rid].float() - ld[0, -1].float()).norm()
                           / ld[0, -1].float().norm()))
        del cache
    print(f"[engine F] greedy tokens equal to single-request serve_batch "
          f"one slot at a time on {len(one_rids)}/{len(one_rids)} requests and "
          f"at {RGEMMA['requests']} slots on {len(f_rids)}/{len(f_rids)} "
          f"({float(np.mean(f_agree)):.3f} of positions; the ring wrapped in "
          f"prefill and decode); first decode step's logits rel_l2 "
          + " ".join(f"{x:.4g}" for x in f_rel)
          + f" (tolerance {LOGIT_TOL['nvfp4']})", flush=True)
    if max(f_rel) > LOGIT_TOL["nvfp4"]:
        fail(f"engine F: first decode step logits differ from serve_batch's "
             f"by {max(f_rel)}")
    phase_5f_rows(dev, rcfg, rparams, rqcfg, f_prompts, f_mb, f_want)
    slab_oracles["b"] = dict(
        arch=RGEMMA["arch"], plan=eng_f.state_plan,
        what="run F's, past the window", prompts=f_prompts, extras=None,
        gen=RUN_OTP["rgemma_gen"], engine=dict(
            n_slots=RGEMMA["requests"], block_size=bs, max_blocks_per_slot=f_mb),
        fault=None, pre=[f_pre[r].cpu() for r in f_rids],
        tokens=[f_out[r] for r in f_rids], pool_bytes=stf["pool_bytes"],
        whole={"blocks.kv.k", "blocks.kv.v"},
        **slab_prefill_controls(eng_f, f_prompts, None))
    del eng_f, eng_1, f_first, f_pre, rparams
    gc.collect()
    torch.cuda.empty_cache()

    elapsed("5h-5j")
    # ---- 5h-5j. rwkv6-3b and whisper-tiny on the slab engine, qwen2-vl-2b --
    h_launches, h_spec_launches, slab_oracles["c"] = phase_5h(dev)
    i_launches, slab_oracles["d"] = phase_5i(dev)
    j_launches = phase_5j(dev)
    gc.collect()
    torch.cuda.empty_cache()

    elapsed("5d")
    # ---- 5d. tensor-parallel serving: acereason-7b at tp = 2 -------------
    # two ranks, two processes in a gloo group, share the card; the
    # kernels are built (phase 2), this process holds no engine
    from repro_torch.launch import mesh as tp_mesh

    gc.collect()
    torch.cuda.empty_cache()
    tp_prompts = a_prompts[:RUN_TP["requests"]]
    t0 = time.perf_counter()
    slab_runs = {p: {k: o.get(k) for k in ("arch", "prompts", "extras",
                                            "gen", "engine", "fault", "spec")}
                 for p, o in slab_oracles.items()}
    ranks = tp_mesh.spawn(tp_rank, TP_SIZE, tp_prompts, RUN_TP["gen"],
                          shadow_ctx, k_launches["tp_oracle"]["prompts"],
                          slab_runs, device="cuda", timeout=1000)
    tp_wall = time.perf_counter() - t0
    r0 = ranks[0]
    for i, r in enumerate(ranks):
        for c in r["k4_check"]:
            if not c["ok"] or not c.get("full_ok", True):
                fail(f"nvfp4_matmul_tp on rank {i}, {c['site']} ({c['mode']}) "
                     f"at M={c['m']}: max abs err {c['max_abs_err']} against "
                     f"its plain version, {c.get('full_err')} against the "
                     "full-K plain product")
    k4_wrap_err = max(c["max_abs_err"] for r in ranks for c in r["k4_check"])
    k4_full_err = max(c["full_err"] for r in ranks for c in r["k4_check"]
                      if "full_err" in c)
    err["nvfp4_matmul_tp"] = max(err["nvfp4_matmul_tp"], k4_wrap_err)
    print(f"[kernel] nvfp4_matmul_tp wrapper on {TP_SIZE} ranks (gloo, one "
          f"card): every rank's tile of wqkv, wg, wu (column) and wo, wd "
          f"(row) at M in ({ENGINE['n_slots']}, {BATCH * PROMPT}) within K2's "
          f"tolerance of nvfp4_matmul_tp_ref on the same inputs (max abs err "
          f"{k4_wrap_err:.3g}); the row results within the summation bound of "
          f"the full-K plain product (max abs err {k4_full_err:.3g})",
          flush=True)
    stt, rep0 = r0["stats"], r0["report"]
    n_fwd = RUN_TP["requests"] + stt["decode_steps"]
    print(f"[engine TP] {cfg.name} full size, packed, tp={TP_SIZE} (gloo, "
          f"{TP_SIZE} processes on one card): {RUN_TP['requests']} requests "
          f"(run A's first), gen {RUN_TP['gen']}, {ENGINE['n_slots']} slots, "
          f"pool {ENGINE['n_blocks']}x{ENGINE['block_size']}, exact prefill: "
          f"wall {r0['wall']:.2f}s (spawn to results {tp_wall:.1f}s), steps "
          f"{stt['steps']}, decode steps {stt['decode_steps']}", flush=True)
    print(f"[engine TP] ttft_p50_ms={stt['ttft_p50_s']*1e3:.1f} "
          f"ttft_p95_ms={stt['ttft_p95_s']*1e3:.1f} "
          f"decode_step_p50_ms={stt['decode_step_p50_s']*1e3:.2f} "
          f"decode_step_p95_ms={stt['decode_step_p95_s']*1e3:.2f} "
          f"decode_tok_s={stt['decode_tok_s']:.1f} e2e_tok_s={stt['e2e_tok_s']:.1f} "
          f"collectives={r0['collectives']['calls']} "
          f"({r0['collectives']['seconds']:.2f}s on the host)", flush=True)
    for i, r in enumerate(ranks):
        print(f"[engine TP] rank {i}: load+pack+cut {r['load_s']:.1f}s "
              f"(peak {r['load_peak']:.2f} GB), peak in the run "
              f"{r['peak']:.2f} GB, launches {r['launches']}", flush=True)
    print(f"[engine TP] tp_shard_report (rank 0): {rep0}", flush=True)
    pool_1 = engine_a["st"]["pool_bytes"]
    for i, r in enumerate(ranks):
        rp, ln = r["report"], r["launches"]
        if r["finished"] != RUN_TP["requests"] or any(
                len(t) != RUN_TP["gen"] for t in r["tokens"]):
            fail(f"engine TP rank {i}: {r['finished']} of "
                 f"{RUN_TP['requests']} requests finished")
        if not r["drained"]:
            fail(f"engine TP rank {i}: the pool did not drain")
        if not (rp["packed_sharded"] == rp["packed_total"] > 0
                and rp["kv_sharded"]
                and rp["kv_pool_bytes_per_device"] * TP_SIZE == pool_1):
            fail(f"engine TP rank {i}: shard report {rp} (single-device "
                 f"pool {pool_1} B)")
        if ln["nvfp4_matmul_tp"] != 5 * cfg.n_layers * n_fwd:
            fail(f"engine TP rank {i} launched nvfp4_matmul_tp "
                 f"{ln['nvfp4_matmul_tp']} times, expected 5 x "
                 f"{cfg.n_layers} x {n_fwd} forwards")
        if ln["nvfp4_matmul"] or ln["paged_attention"]:
            fail(f"engine TP rank {i} launched K2 or K7 bare: {ln}")
        if any(not np.array_equal(a, b) for a, b in zip(r["tokens"],
                                                         r0["tokens"])):
            fail(f"engine TP: rank {i}'s tokens differ from rank 0's")
    tp_rel = [float((p.float() - q.float()).norm() / q.float().norm())
              for p, q in zip(r0["pre"], a_pre)]
    tp_agree = float(np.mean([np.mean(t == a_out[rid][: RUN_TP["gen"]])
                              for t, rid in zip(r0["tokens"], a_rids)]))
    print(f"[engine TP] prefill logits vs run A (one card) rel_l2: "
          + " ".join(f"{x:.4g}" for x in tp_rel)
          + f" (tolerance {LOGIT_TOL['nvfp4']}); tokens equal to run A's at "
          f"{tp_agree:.3f} of positions (printed, not gated)", flush=True)
    if max(tp_rel) > LOGIT_TOL["nvfp4"]:
        fail(f"engine TP: prefill logits differ from one card's by {max(tp_rel)}")
    tr = r0["trace"]
    print(f"[trace] TP engine decode step, 8 slots, rank 0 (traced): "
          f"wall_ms={tr['wall_ms']:.3f} device_busy_ms={tr['busy_ms']:.3f} "
          f"idle_share={1 - tr['busy_ms'] / tr['wall_ms']:.3f} "
          f"nvfp4_matmul_tp_ms={tr['k4_ms']:.3f} ({5 * cfg.n_layers} launches) "
          f"collective_ms={tr['collective_ms']:.3f} ({tr['collectives']} "
          f"collectives, host-staged); device ops: {tr['n_port']:.0f} of the "
          f"port's kernels ({tr['n_qdq']:.0f} QDQ for {tr['qdq_calls']} QDQ "
          f"calls; trace {tr['attempt']}), {tr['n_other']:.0f} others",
          flush=True)
    if tr["n_qdq"] != tr["qdq_calls"]:
        fail(f"engine TP decode step: {tr['n_qdq']} QDQ kernels for "
             f"{tr['qdq_calls']} QDQ calls")
    for kname, ms in tr["top"]:
        print(f"[trace]   {ms:8.3f} ms  {kname[:110]}")
    tp_launches = [r["launches"] for r in ranks]
    engine_tp = dict(st=stt, wall=r0["wall"], trace=tr, rel=tp_rel,
                     agree=tp_agree)
    n5_launches = phase_5n_spec_shadow(ranks, cfg, shadow_single)
    n5_launches.update(phase_5n_moe(ranks, k_launches["tp_oracle"]))
    o5_launches = phase_5o(ranks, slab_oracles)
    del ranks, r0, slab_oracles

    elapsed("7")
    # ---- 7. timings, after the serving paths (the profiler's hooks stay out
    # of the host-bound decode loop) and before the training paths, which
    # then run without phase 3's tensors resident --------------------------
    # the floor of this timing: one tiny kernel between two events
    floor_ms = timed(lambda: flush_buf[:16].add_(1), 20)
    print(f"[kernel] timing floor (one tiny kernel between the events): "
          f"{floor_ms:.4f} ms", flush=True)
    # K1 as one layer of the engine calls it: its five sites back to back,
    # the op taking its own amax, and the op given q_act's former torch amax
    k1_layer = {}
    for ph in ("decode", "prefill"):
        rs = [r for r in rows["nvfp4_qdq"] if r["phase"] == ph]
        fs = [r["fns"][0] for r in rs]
        olds = [r["old"] for r in rs]
        k1_layer[ph] = dict(ms=timed(lambda fs=fs: [f() for f in fs], 20),
                            old_ms=timed(lambda fs=olds: [f() for f in fs], 20))
        print(f"[kernel] nvfp4_qdq one {ph} layer ({len(fs)} sites back to "
              f"back): {k1_layer[ph]['ms']:.4f} ms; with the torch amax of "
              f"q_act before: {k1_layer[ph]['old_ms']:.4f} ms", flush=True)
    for kname, rs in rows.items():
        for r in rs:
            kern, plain, lib = r.pop("fns")
            if "lib_make" in r:
                lib = r.pop("lib_make")()
            r["ms"] = timed(kern, 20)
            if "old" in r:
                r["old_ms"] = timed(r.pop("old"), 20)
            r["plain_ms"] = timed(plain, 5)
            r["library_ms"] = timed(lib, 20) if lib is not None else None
            if "shape" in r:
                shape = r["shape"]
            elif kname.startswith("kl"):
                shape = f"T={r['m']:4d} V={r['k']:6d}"
            else:
                shape = (f"M={r['m']:4d} K={r['k']:5d}"
                         + (f" N={r['n']:5d}" if "n" in r else ""))
            lib_s = ("" if lib is None else f" library_ms={r['library_ms']:.4f}")
            if "old_ms" in r:
                lib_s += f" old_call_ms={r['old_ms']:.4f}"
            del kern, plain, lib
            print(f"[kernel] {kname:12s} {shape} ({r['site']}) "
                  f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f}{lib_s}", flush=True)
    # the timed calls held phase 3's tensors: they go before the training
    del fs, olds, rs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[chip_smoke] resident before the training paths: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

    elapsed("6")
    # ---- 6. the training path: full-size olmo-1b QAD, remat "full" --------
    tcfg = configs.get_config(TRAIN["arch"])
    n_params = tcfg.n_params()
    tokens = TRAIN["batch"] * TRAIN["seq"]
    # 2 N T each for the teacher's forward, the student's forward and its
    # recompute under remat, 4 N T for the student's backward
    step_bound_ms = 10 * n_params * tokens / BF16_FLOPS * 1e3
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, hist = train.train(TRAIN["arch"], smoke=False, steps=TRAIN["steps"],
                              lr=TRAIN["lr"], method="qad",
                              batch=TRAIN["batch"], seq=TRAIN["seq"],
                              eval_every=1, seed=SEED, device=dev,
                              log=lambda msg: print(msg, flush=True))
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    train_launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # phase 6h's oracle: this run's history, and its final student in a
    # host file the mesh's ranks map (each reads its own shards)
    p6_hist = list(hist)
    mesh_work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    p6_file = os.path.join(mesh_work, "phase6_student.pt")
    torch.save({"student": to_host(state.student)}, p6_file)
    n_evals = 2 * TRAIN["steps"]              # two eval batches per step
    per_forward = 10 * tcfg.n_layers          # 5 activations + 5 weights
    # under remat the backward reruns each layer's forward: every QDQ of
    # the student twice per train step (an eval runs no backward)
    fwd_per_step = 1 if tcfg.remat == "none" else 2
    expect = {"nvfp4_qdq": per_forward * (fwd_per_step * TRAIN["steps"] + n_evals),
              "kl_loss": TRAIN["steps"] + n_evals,
              "kl_loss_bwd": TRAIN["steps"], "nvfp4_matmul": 0}
    step_s = [h["step_s"] for h in hist]
    # the steady step: after the first (the allocator's warm-up), or the
    # remat "full" step timed below when the run takes one
    steady = step_s[1:]
    print(f"[train] {tcfg.name} full size ({n_params / 1e9:.3f} B params, "
          f"{tcfg.n_layers} layers, remat={tcfg.remat}), {TRAIN['steps']} steps "
          f"of {TRAIN['batch']} x {TRAIN['seq']} tokens in {t_train:.1f}s; step_ms "
          + " ".join(f"{x * 1e3:.1f}" for x in step_s)
          + (f"; after the first: {sum(steady) / len(steady) * 1e3:.1f} ms/step, "
             f"{tokens * len(steady) / sum(steady):.0f} tokens/s" if steady
             else " (the first, with its warm-up; the steady step is remat "
             "full's below)")
          + f"; bound "
          f"{step_bound_ms:.1f} ms (10 N T operations: teacher and student "
          f"forward, the student's recompute, its backward); "
          f"peak_mem_gb={peak_gb:.2f} ({resident_gb:.2f} resident before the "
          "run)", flush=True)
    print("[train] per-step eval KL " + " ".join(f"{h['kl']:.6g}" for h in hist)
          + " | CE " + " ".join(f"{h['ce']:.5g}" for h in hist)
          + " | train loss " + " ".join(f"{h['loss']:.6g}" for h in hist),
          flush=True)
    print(f"[train] launches {train_launches} (expected {expect})", flush=True)
    for k, n in expect.items():
        if train_launches[k] != n:
            fail(f"the training path launched {k} {train_launches[k]} times, "
                 f"expected {n}")
    for h in hist:
        if not all(math.isfinite(h[k]) for k in ("kl", "ce", "loss")):
            fail(f"non-finite training metrics {h}")
    changed = sum(int((a != b).sum()) for a, b in zip(
        common.tree_leaves(state.student), common.tree_leaves(state.teacher)))
    print(f"[train] student elements changed from the initial weights: "
          f"{changed} of {n_params}", flush=True)
    if changed == 0:
        fail("the student's parameters did not change")

    # one traced step: where the time goes
    dcfg = DataConfig(tcfg.vocab_size, TRAIN["seq"], TRAIN["batch"], seed=SEED)
    step_fn = qad.make_train_step(
        get_model(tcfg), tcfg, specs.recipe_qconfig(tcfg),
        AdamW(lr=warmup_cosine(TRAIN["lr"], 0, TRAIN["steps"]), clip_norm=1.0))
    tb = make_batch(dcfg, TRAIN["steps"], device=dev)
    box = {"state": state}

    def one_step(fn=step_fn, b=tb):
        box["state"], m = fn(box["state"], b)
        return float(m["grad_norm"])

    trace_step("training step", one_step)
    state = box.pop("state")

    # remat "none", "dots" and "full": the same step twice each from a
    # copy of the state on the card (the second timed); the updated
    # student and moments bitwise equal to remat none's (kept on the card),
    # the peak memory of each step net of what is resident before it (phase
    # 3's tensors, kept for phase 7's timing; the state and none's result)
    # (on the card: the host copies and host compares took about 20 s)
    base = state
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    rb = make_batch(dcfg, TRAIN["steps"] + 1, device=dev)
    remat = {}
    first = None
    ops.reset_launches()
    for mode in ("none", "dots", "full"):
        mcfg = dataclasses.replace(tcfg, remat=mode)
        fn = qad.make_train_step(
            get_model(mcfg), mcfg, specs.recipe_qconfig(mcfg),
            AdamW(lr=warmup_cosine(TRAIN["lr"], 0, TRAIN["steps"]),
                  clip_norm=1.0))
        resident = torch.cuda.memory_allocated()
        st = clone_tree(base)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn(st, rb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, mm = fn(st, rb)
        torch.cuda.synchronize()
        remat[mode] = dict(ms=(time.perf_counter() - t0) * 1e3,
                           peak_gb=(torch.cuda.max_memory_allocated()
                                    - resident) / 1e9,
                           resident_gb=resident / 1e9,
                           loss=float(mm["loss"]))
        del st, mm
        out = {"student": new.student, "m": new.opt_state.m,
               "v": new.opt_state.v}
        if first is None:
            first = out
        else:
            for part in out:
                for a, b in zip(common.tree_leaves(out[part]),
                                common.tree_leaves(first[part])):
                    if not torch.equal(a, b):
                        fail(f"remat {mode}: the updated {part} differs from "
                             "remat none's")
        del new, out
        gc.collect()
        torch.cuda.empty_cache()
    remat_launches = dict(ops.launches)
    del first, base
    print("[train] remat, the same step from a copy of the state on the card "
          "(the second of two timed; peak of the step, its state included, "
          f"net of the {remat['none']['resident_gb']:.2f} GB resident before "
          "it): "
          + "; ".join(f"{k}: {v['ms']:.1f} ms, peak {v['peak_gb']:.2f} GB"
                      for k, v in remat.items())
          + f"; student and moments bitwise equal; full/none peak "
          f"{remat['full']['peak_gb'] / remat['none']['peak_gb']:.3f}",
          flush=True)
    if remat["full"]["peak_gb"] > 0.75 * remat["none"]["peak_gb"]:
        fail(f"remat full peaks at {remat['full']['peak_gb']:.2f} GB, more "
             f"than 75% of remat none's {remat['none']['peak_gb']:.2f} GB")
    # two steps a mode: none's QDQ once a step, dots' and full's twice
    want_q = 2 * per_forward * (1 + 2 + 2)
    if remat_launches["nvfp4_qdq"] != want_q or remat_launches["kl_loss"] != 6:
        fail(f"the remat steps launched {remat_launches}, expected "
             f"{want_q} QDQ and 6 KL")

    elapsed("6h")
    # ---- 6h. the training mesh: QAD on a (2, 2) data x model mesh of four
    # gloo ranks sharing the card, under the reference's four rules ------
    try:
        phase_6h(dev, tcfg, p6_hist, p6_file, mesh_work)
    finally:
        shutil.rmtree(mesh_work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    elapsed("6b")
    # ---- 6b. MoE QAD: qwen2-moe-a2.7b at full width, 4 of its 24 layers ---
    # through train.train with the config cut in depth here (the package
    # keeps its configs): the training state of all 24 layers (14.3 B
    # parameters at 14 B each) does not fit one card
    mfull = configs.get_config(MOE_ARCH)
    mcut = dataclasses.replace(mfull, n_layers=MOE_TRAIN["layers"])
    get_config = configs.get_config
    configs.get_config = lambda name: mcut if name == MOE_ARCH else get_config(name)
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        state, hist = train.train(MOE_ARCH, smoke=False,
                                  steps=MOE_TRAIN["steps"], lr=TRAIN["lr"],
                                  method="qad", batch=MOE_TRAIN["batch"],
                                  seq=MOE_TRAIN["seq"], eval_every=1,
                                  seed=SEED, device=dev,
                                  log=lambda msg: print(msg, flush=True))
    finally:
        configs.get_config = get_config
    torch.cuda.synchronize()
    t_moe = time.perf_counter() - t0
    moe_launches = dict(ops.launches)
    moe_peak = torch.cuda.max_memory_allocated() / 1e9
    # QDQ sites of one MoE layer (models/decoder.py::_block, layers.py):
    # attention's two GEMMs (activation + weight each), the routed
    # experts' input and hidden activations and three expert stacks, the
    # shared expert's three GEMMs (activation + weight each); the routers
    # stay BF16
    moe_per_forward = (2 * 2 + 2 + 3 + 3 * 2) * mcut.n_layers
    m_evals = 2 * MOE_TRAIN["steps"]
    m_expect = {"nvfp4_qdq": moe_per_forward * (2 * MOE_TRAIN["steps"] + m_evals),
                "kl_loss": MOE_TRAIN["steps"] + m_evals,
                "kl_loss_bwd": MOE_TRAIN["steps"], "nvfp4_matmul": 0,
                "nvfp4_matmul_grouped": 0, "paged_attention": 0}
    m_tokens = MOE_TRAIN["batch"] * MOE_TRAIN["seq"]
    d_m, n_e, k_e = mcut.d_model, mcut.n_experts, mcut.experts_per_tok
    cap = int(max(1, (MOE_TRAIN["seq"] * k_e * mcut.capacity_factor) // n_e))
    pad = n_e * cap / (MOE_TRAIN["seq"] * k_e)   # expert rows per routed choice
    routed = 3 * d_m * mcut.moe_d_ff               # one expert, one token
    # active parameters, the input embedding (a lookup) left out, the
    # routed experts' share counted at the rows capacity dispatch computes
    n_act = mcut.n_params(active_only=True) - mcut.vocab_size * d_m
    n_eff = n_act + mcut.n_layers * k_e * routed * (pad - 1)
    m_bound_ms = 10 * n_eff * m_tokens / BF16_FLOPS * 1e3
    m_steps = [h["step_s"] * 1e3 for h in hist]
    print(f"[train-moe] {MOE_ARCH} at full width, {mcut.n_layers} of "
          f"{mfull.n_layers} layers ({mcut.n_params() / 1e9:.3f} B params, "
          f"{mcut.n_params(active_only=True) / 1e9:.3f} B active), remat="
          f"{mcut.remat}, moe_dispatch={mcut.moe_dispatch}, "
          f"{MOE_TRAIN['steps']} steps of {MOE_TRAIN['batch']} x "
          f"{MOE_TRAIN['seq']} in {t_moe:.1f}s; step_ms "
          + " ".join(f"{x:.1f}" for x in m_steps)
          + f"; bound {m_bound_ms:.1f} ms (10 N_eff T, N_eff {n_eff / 1e9:.3f} B: "
          f"active parameters less the input embedding, the routed experts "
          f"at capacity {cap} of {n_e} experts a row, x{pad:.3f} padding); "
          f"peak_mem_gb={moe_peak:.2f} ({resident_gb:.2f} resident before the "
          "run)", flush=True)
    print("[train-moe] per-step eval KL " + " ".join(f"{h['kl']:.6g}" for h in hist)
          + " | CE " + " ".join(f"{h['ce']:.5g}" for h in hist)
          + " | train loss " + " ".join(f"{h['loss']:.6g}" for h in hist),
          flush=True)
    print(f"[train-moe] launches {moe_launches} (expected {m_expect})", flush=True)
    for k, n in m_expect.items():
        if moe_launches[k] != n:
            fail(f"MoE QAD launched {k} {moe_launches[k]} times, expected {n}")
    for h in hist:
        if not all(math.isfinite(h[k]) for k in ("kl", "ce", "loss")):
            fail(f"non-finite MoE QAD metrics {h}")
    changed = sum(int((a != b).sum()) for a, b in zip(
        common.tree_leaves(state.student), common.tree_leaves(state.teacher)))
    print(f"[train-moe] student elements changed: {changed} of "
          f"{mcut.n_params()}", flush=True)
    if changed == 0:
        fail("MoE QAD: the student's parameters did not change")
    mstep = qad.make_train_step(
        get_model(mcut), mcut, specs.recipe_qconfig(mcut),
        AdamW(lr=warmup_cosine(TRAIN["lr"], 0, MOE_TRAIN["steps"]),
              clip_norm=1.0))
    mb = make_batch(DataConfig(mcut.vocab_size, MOE_TRAIN["seq"],
                               MOE_TRAIN["batch"], seed=SEED),
                    MOE_TRAIN["steps"], device=dev)
    box["state"] = state
    del state
    # its QDQ kernels are counted, not gated: in this process the profile
    # of this step has held one QDQ kernel record fewer than its launches
    # (never more), while phase 6's step and phase 3's one-call profiles
    # at these shapes hold one kernel per launch; the launch count above
    # is exact
    trace_step("MoE training step", lambda: one_step(fn=mstep, b=mb),
               qdq_gate=False)
    del box["state"], mstep, mb, hist
    gc.collect()
    torch.cuda.empty_cache()

    elapsed("6c")
    # ---- 6c. data-free QAD: olmo-1b from the teacher's own tokens --------
    from repro_torch.data import generated
    tmodel = get_model(tcfg)
    topt = AdamW(lr=warmup_cosine(TRAIN["lr"], 0, DATA_FREE["steps"]),
                 clip_norm=1.0)
    with torch.no_grad():
        state = qad.init_state(tmodel, tcfg,
                               torch.Generator(device=dev).manual_seed(SEED),
                               topt, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    toks = generated.generate_tokens(
        tmodel, tcfg, state.teacher,
        generated.bos_prompts(DATA_FREE["batch"], device=dev),
        DATA_FREE["n_new"], seed=SEED, temperature=1.0, top_p=1.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    want_shape = (DATA_FREE["batch"], 1 + DATA_FREE["n_new"])
    if tuple(toks.shape) != want_shape:
        fail(f"generated tokens {tuple(toks.shape)}, expected {want_shape}")
    if not bool(((toks >= 0) & (toks < tcfg.vocab_size)).all()):
        fail("generated tokens outside the vocabulary")
    if not bool((toks[:, 0] == 1).all()):
        fail("generated sequences do not start with the BOS id")
    gen_launches = dict(ops.launches)
    fb = generated.batch_from_generated(toks, DATA_FREE["n_new"])
    fstep = qad.make_train_step(tmodel, tcfg, specs.recipe_qconfig(tcfg), topt)
    df_ms, df_kl = [], []
    for _ in range(DATA_FREE["steps"]):
        t0 = time.perf_counter()
        state, m = fstep(state, fb)
        torch.cuda.synchronize()
        df_ms.append((time.perf_counter() - t0) * 1e3)
        df_kl.append(float(m["kl"]))
    df_launches = dict(ops.launches)
    distinct = len(set(toks[:, 1:].reshape(-1).tolist()))
    print(f"[train-free] {tcfg.name}: generated {want_shape[0]} x "
          f"{DATA_FREE['n_new']} tokens from BOS (temperature 1.0, top_p 1.0) "
          f"in {gen_s:.2f}s, {want_shape[0] * DATA_FREE['n_new'] / gen_s:.0f} "
          f"tok/s, {distinct} distinct token ids; {DATA_FREE['steps']} QAD "
          f"steps of {want_shape[0]} x {DATA_FREE['n_new']} on them: step_ms "
          + " ".join(f"{x:.1f}" for x in df_ms) + "; train KL "
          + " ".join(f"{x:.6g}" for x in df_kl), flush=True)
    if any(v for k, v in gen_launches.items()):
        fail(f"the BF16 teacher's generation launched kernels: {gen_launches}")
    df_expect = {"nvfp4_qdq": per_forward * 2 * DATA_FREE["steps"],
                 "kl_loss": DATA_FREE["steps"],
                 "kl_loss_bwd": DATA_FREE["steps"]}
    for k, n in df_expect.items():
        if df_launches[k] != n:
            fail(f"data-free QAD launched {k} {df_launches[k]} times, "
                 f"expected {n}")
    if not all(math.isfinite(x) for x in df_kl):
        fail(f"data-free QAD: non-finite KL {df_kl}")
    if not any(bool((a != b).any()) for a, b in zip(
            common.tree_leaves(state.student), common.tree_leaves(state.teacher))):
        fail("data-free QAD: the student's parameters did not change")
    del state, m, fstep, fb, toks
    gc.collect()
    torch.cuda.empty_cache()

    elapsed("6d")
    # ---- 6d. the numerics plane and calibration: olmo-1b ----------------
    from repro_torch.core import ptq
    from repro_torch.core.qconfig import BF16
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import numerics as obs_numerics
    from repro_torch.obs import validate as obs_validate

    def numerics_run(**kw):
        ops.reset_launches()
        t0 = time.perf_counter()
        st, hs = train.train(TRAIN["arch"], smoke=False,
                             steps=NUMERICS["steps"], lr=TRAIN["lr"],
                             method="qad", batch=TRAIN["batch"],
                             seq=TRAIN["seq"], eval_every=1, seed=SEED,
                             device=dev, log=lambda msg: None, **kw)
        torch.cuda.synchronize()
        # kept on the card and compared there (host copies and host
        # compares of three 11.8 GB results took about 15 s)
        out = {"student": st.student, "m": st.opt_state.m,
               "v": st.opt_state.v}
        run = dict(s=time.perf_counter() - t0, launches=dict(ops.launches),
                   step_ms=[h["step_s"] * 1e3 for h in hs])
        del st
        gc.collect()
        torch.cuda.empty_cache()
        return out, run

    def same(a, b):
        return all(torch.equal(x, y) for part in a for x, y in zip(
            common.tree_leaves(a[part]), common.tree_leaves(b[part])))

    snap_dir = tempfile.mkdtemp(prefix="chip_smoke_numerics_")
    snap_path = os.path.join(snap_dir, "metrics.json")
    on, run_on = numerics_run(numerics=True, metrics_out=snap_path)
    off, run_off = numerics_run()
    off2, run_off2 = numerics_run()
    control = same(off, off2)
    bitwise = same(on, off)
    del off2
    num_expect = per_forward * (2 * NUMERICS["steps"] + 2 * NUMERICS["steps"])
    print(f"[numerics] {tcfg.name}: {NUMERICS['steps']} steps with probes "
          f"(step_ms " + " ".join(f"{x:.1f}" for x in run_on["step_ms"])
          + f", {run_on['s']:.1f}s the run) and without (step_ms "
          + " ".join(f"{x:.1f}" for x in run_off["step_ms"])
          + f", {run_off['s']:.1f}s): student and moments bitwise equal: "
          f"{bitwise}; control, the probe-free run twice: bitwise equal: "
          f"{control}", flush=True)
    if not control:
        fail("the probe-free training run is not run-to-run deterministic "
             "on this card (the control)")
    if not bitwise:
        fail("numerics probes changed the training state")
    for r in (run_on, run_off):
        if r["launches"]["nvfp4_qdq"] != num_expect:
            fail(f"numerics runs launched {r['launches']}, expected "
                 f"{num_expect} QDQ")
    with open(snap_path) as f:
        snap = json.load(f)
    with open(obs_export.prom_path(snap_path)) as f:
        prom = f.read()
    problems = obs_validate.check_metrics(snap) + obs_validate.check_prometheus(prom)
    if problems:
        fail(f"the numerics snapshot is not valid: {problems[:5]}")
    per = snap["numerics"]["per_layer"]
    sq_by_layer, cos_by_layer, mse_by_layer = [], [], []
    for i in range(tcfg.n_layers):
        sq = [v["sqnr_db"] for s, v in per.items()
              if s.endswith(f".{i:03d}") and "sqnr_db" in v]
        sq_by_layer.append((min(sq), sum(sq) / len(sq)))
        hid = per[f"layers.hidden.{i:03d}"]
        cos_by_layer.append(hid["hidden_cos"])
        mse_by_layer.append(hid["hidden_mse"])
    print(f"[numerics] snapshot {len(snap['metrics'])} instruments, "
          f"{len(per)} per-layer sites, prom {len(prom.splitlines())} lines: "
          f"valid (0 problems); SQNR dB min/mean by layer "
          + " ".join(f"{a:.2f}/{b:.2f}" for a, b in sq_by_layer), flush=True)
    print("[numerics] hidden cosine by layer " + " ".join(
        f"{x:.6f}" for x in cos_by_layer) + " | hidden MSE by layer "
        + " ".join(f"{x:.3g}" for x in mse_by_layer), flush=True)
    del on, off, snap, prom

    # calibration: the teacher's 16 hidden taps over CALIB["batches"] of 2 x 512
    cparams = tmodel.init_params(tcfg, torch.Generator(device=dev)
                                 .manual_seed(SEED), dev)
    tap_qc = dataclasses.replace(BF16, numerics=True)
    sites = [f"layers.hidden.{i:03d}" for i in range(tcfg.n_layers)]

    def taps(batch):
        tape = obs_numerics.Tape()
        with torch.no_grad(), obs_numerics.collecting(tape):
            tmodel.apply(tcfg, cparams, batch, tap_qc, output="hidden")
        h = tape.drain()["layers.hidden"]["h"]
        return dict(zip(sites, h))

    cbatches = [make_batch(DataConfig(tcfg.vocab_size, CALIB["seq"],
                                      CALIB["batch"], seed=SEED), i, device=dev)
                for i in range(CALIB["batches"])]
    ops.reset_launches()
    calib = {}
    for method in ("max", "percentile", "mse"):
        t0 = time.perf_counter()
        m_sites = sites[::CALIB["mse_every"]] if method == "mse" else sites
        amax = ptq.calibrate_activations(taps, cbatches, m_sites, method)
        calib[method] = dict(s=time.perf_counter() - t0,
                             amax=[amax[s] for s in m_sites])
        if not all(math.isfinite(a) and a > 0 for a in amax.values()):
            fail(f"calibration ({method}) gave {amax}")
        print(f"[calib] {method}: {calib[method]['s']:.2f}s; amax by layer "
              + " ".join(f"{a:.4g}" for a in calib[method]["amax"]), flush=True)
    if sum(ops.launches.values()):
        fail(f"calibration launched kernels: {dict(ops.launches)}")
    if not all(p <= mx for p, mx in zip(calib["percentile"]["amax"],
                                         calib["max"]["amax"])):
        fail("a percentile amax above the running max")
    del cparams, cbatches
    gc.collect()
    torch.cuda.empty_cache()
    elapsed("6e")
    # ---- 6e. QAD on nemotron-nano-9b-sim: full width, one super-block ----
    # through train.train with the config cut in depth here: 56 layers'
    # training state (18.4 B parameters) does not fit one card
    nfull = configs.get_config(NEMO_ARCH)
    ncut = dataclasses.replace(nfull, n_layers=NEMO_TRAIN["layers"],
                               attn_period=NEMO_TRAIN["layers"])
    get_config = configs.get_config
    configs.get_config = lambda name: ncut if name == NEMO_ARCH else get_config(name)
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        state, hist = train.train(NEMO_ARCH, smoke=False,
                                  steps=NEMO_TRAIN["steps"], lr=TRAIN["lr"],
                                  method="qad", batch=NEMO_TRAIN["batch"],
                                  seq=NEMO_TRAIN["seq"], eval_every=1,
                                  seed=SEED, device=dev,
                                  log=lambda msg: print(msg, flush=True))
    finally:
        configs.get_config = get_config
    torch.cuda.synchronize()
    t_nemo = time.perf_counter() - t0
    nemo_launches = dict(ops.launches)
    nemo_peak = torch.cuda.max_memory_allocated() / 1e9
    n_specs = rglru.param_specs(ncut)
    n_all = sum(math.prod(sp.shape) for sp in common.tree_leaves(n_specs))
    # the bound counts every parameter but the input embedding (a lookup)
    n_eff = n_all - math.prod(n_specs["embed"].shape)
    n_tokens = NEMO_TRAIN["batch"] * NEMO_TRAIN["seq"]
    n_bound_ms = 10 * n_eff * n_tokens / BF16_FLOPS * 1e3
    per_rec, per_attn, n_rec_l, n_attn_l = rec_sites(ncut,
                                                     specs.recipe_qconfig(ncut))
    # a training forward fake-quantizes each site's activation and weight;
    # under remat "full" the student's forward runs twice a step
    n_per_fwd = 2 * (per_rec * n_rec_l + per_attn * n_attn_l)
    nemo_evals = 2 * NEMO_TRAIN["steps"]
    n_expect = {"nvfp4_qdq": n_per_fwd * ((1 if ncut.remat == "none" else 2)
                                          * NEMO_TRAIN["steps"] + nemo_evals),
                "kl_loss": NEMO_TRAIN["steps"] + nemo_evals,
                "kl_loss_bwd": NEMO_TRAIN["steps"], "nvfp4_matmul": 0,
                "paged_attention": 0}
    n_steps_ms = [h["step_s"] * 1e3 for h in hist]
    print(f"[train-nemo] {NEMO_ARCH} at full width (d_model {ncut.d_model}, "
          f"d_ff {ncut.d_ff}, vocab {ncut.vocab_size}), cut to n_layers="
          f"{ncut.n_layers}, attn_period={ncut.attn_period}: {n_rec_l} RG-LRU "
          f"layers and {n_attn_l} attention layer of its {nfull.n_layers} "
          f"({n_all / 1e9:.3f} B params), remat={ncut.remat}, "
          f"{NEMO_TRAIN['steps']} steps of {NEMO_TRAIN['batch']} x "
          f"{NEMO_TRAIN['seq']} in {t_nemo:.1f}s; step_ms "
          + " ".join(f"{x:.1f}" for x in n_steps_ms)
          + f"; bound {n_bound_ms:.1f} ms (10 N T, N {n_eff / 1e9:.3f} B: the "
          f"parameters less the input embedding); peak_mem_gb={nemo_peak:.2f} "
          f"({resident_gb:.2f} resident before the run)", flush=True)
    print("[train-nemo] per-step eval KL " + " ".join(f"{h['kl']:.6g}" for h in hist)
          + " | CE " + " ".join(f"{h['ce']:.5g}" for h in hist)
          + " | train loss " + " ".join(f"{h['loss']:.6g}" for h in hist),
          flush=True)
    print(f"[train-nemo] launches {nemo_launches} (expected {n_expect})",
          flush=True)
    for k, n_want in n_expect.items():
        if nemo_launches[k] != n_want:
            fail(f"nemotron QAD launched {k} {nemo_launches[k]} times, "
                 f"expected {n_want}")
    for h in hist:
        if not all(math.isfinite(h[k]) for k in ("kl", "ce", "loss")):
            fail(f"non-finite nemotron QAD metrics {h}")
    changed = sum(int((a != b).sum()) for a, b in zip(
        common.tree_leaves(state.student), common.tree_leaves(state.teacher)))
    print(f"[train-nemo] student elements changed: {changed} of {n_all}",
          flush=True)
    if changed == 0:
        fail("nemotron QAD: the student's parameters did not change")
    del state, hist
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6f, 6g. QAD on rwkv6-3b (16 of 32 layers) and qwen2-vl-2b ---------
    rwkv_train_launches = phase_6f(dev)
    gc.collect()
    torch.cuda.empty_cache()
    vl_train_launches = phase_6g(dev)
    gc.collect()
    torch.cuda.empty_cache()

    # every training path's launches, for the kernels line
    train_paths = {"qad_olmo": train_launches, "remat_steps": remat_launches,
                   "qad_moe": moe_launches, "data_free": df_launches,
                   "numerics_on": run_on["launches"],
                   "numerics_off": run_off["launches"],
                   "numerics_control": run_off2["launches"],
                   "qad_nemotron": nemo_launches,
                   "qad_rwkv6": rwkv_train_launches,
                   "qad_qwen2vl": vl_train_launches}
    train_total = {k: sum(p.get(k, 0) for p in train_paths.values())
                   for k in ops.launches}

    elapsed("8")
    # ---- 8. the kernels line, the card, the result ------------------------
    def spec_paths(name):
        """A kernel's launches on the paths of phases 5k, 5l and 5m."""
        return {"engine_k_fp8": k_launches["fp8"][name],
                "engine_k_spec": k_launches["spec"][name],
                "engine_h_spec": h_spec_launches[name],
                **{f"engine_l_spec_{d}": n[name] for d, n in l_launches.items()},
                **{f"engine_5m_{p}": n.get(name, 0)
                   for p, n in m5_launches.items()}}

    def serve_entry(name, source, replaces):
        dec = [r for r in rows[name] if r["m"] == BATCH]
        lib = [r["library_ms"] for r in dec]
        by = ("bytes" if all(r["bound_by"] == "bytes" for r in dec)
              else "operations")
        by_path = {"serve": serve_launches[name], "train": train_total[name],
                   "engine_a": a_launches[name], "engine_b": b_launches[name],
                   "engine_m": m_launches[name], "engine_mb": mb_launches[name],
                   "engine_tp_rank0": tp_launches[0][name],
                   "engine_g_chunked": g_launches[name],
                   "engine_e_nemotron": e_launches[name],
                   "engine_f_rgemma": f_launches[name],
                   "engine_h_rwkv6": h_launches[name],
                   "engine_i_whisper": i_launches[name],
                   "static_j_qwen2vl": j_launches[name],
                   **spec_paths(name),
                   **{f"engine_5o_{p}_rank0": n[name]
                      for p, n in o5_launches.items()}}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "max_abs_err": err[name],
                "ms": sum(r["ms"] for r in dec),
                "plain_ms": sum(r["plain_ms"] for r in dec),
                "bound_ms": sum(r["bound_ms"] for r in dec),
                "bound_by": by,
                "library_ms": None if None in lib else sum(lib),
                "per": f"one decode layer: {len(dec)} launches at M={BATCH}",
                "prefill_layer_ms": sum(r["ms"] for r in rows[name]
                                        if r["m"] == BATCH * PROMPT),
                "chunk_layer_ms": (sum(r["ms"] for r in rows[name]
                                       if r["m"] == CHUNK) or None),
                "max_err_over_bound": err_bound.get(name),
                "launches_by_path": by_path}

    def qdq_entry():
        rs = rows["nvfp4_qdq"]
        dec = [r for r in rs if r["phase"] == "decode"]
        by_path = {"serve": serve_launches["nvfp4_qdq"],
                   "train": train_total["nvfp4_qdq"],
                   "engine_a": a_launches["nvfp4_qdq"],
                   "engine_b": b_launches["nvfp4_qdq"],
                   "engine_m": m_launches["nvfp4_qdq"],
                   "engine_mb": mb_launches["nvfp4_qdq"],
                   "engine_tp_rank0": tp_launches[0]["nvfp4_qdq"],
                   "engine_g_chunked": g_launches["nvfp4_qdq"],
                   "engine_e_nemotron": e_launches["nvfp4_qdq"],
                   "engine_f_rgemma": f_launches["nvfp4_qdq"],
                   "engine_h_rwkv6": h_launches["nvfp4_qdq"],
                   "engine_i_whisper": i_launches["nvfp4_qdq"],
                   "static_j_qwen2vl": j_launches["nvfp4_qdq"],
                   **spec_paths("nvfp4_qdq"),
                   **{f"engine_5n_{p}_rank0": n["nvfp4_qdq"]
                      for p, n in n5_launches.items()},
                   **{f"engine_5o_{p}_rank0": n["nvfp4_qdq"]
                      for p, n in o5_launches.items()}}
        return {"name": "nvfp4_qdq", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/nvfp4_qdq.cu",
                "replaces": "src/repro/kernels/nvfp4_qdq.py:44",
                "launches": sum(by_path.values()), "max_abs_err": err["nvfp4_qdq"],
                "ms": sum(r["ms"] for r in dec),
                "plain_ms": sum(r["plain_ms"] for r in dec),
                "bound_ms": sum(r["bound_ms"] for r in dec), "bound_by": "bytes",
                "library_ms": None,
                "per": (f"one decode layer as the engine calls it: {len(dec)} "
                        f"row-scope launches at [{ENGINE['n_slots']}, 1, K], "
                        "each timed alone"),
                "old_call_ms": sum(r["old_ms"] for r in dec),
                "layer_ms": k1_layer["decode"]["ms"],
                "layer_old_call_ms": k1_layer["decode"]["old_ms"],
                "prefill_layer_ms": k1_layer["prefill"]["ms"],
                "prefill_layer_old_call_ms": k1_layer["prefill"]["old_ms"],
                "timing_floor_ms": floor_ms,
                "old_call_device_ops": k1_old_ops,
                "train_launches_by_part": {p: n["nvfp4_qdq"] for p, n in
                                           train_paths.items()},
                "per_shape": [{k: r[k] for k in ("phase", "site", "shape", "ms",
                                                 "old_ms", "plain_ms", "bound_ms")}
                              for r in rs],
                "launches_by_path": by_path}

    def kl_entry(name, source, replaces):
        at = {r["site"]: r for r in rows[name]}
        tr = at["train"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": train_total[name],
                "max_abs_err": err[name], "ms": tr["ms"],
                "plain_ms": tr["plain_ms"], "bound_ms": tr["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "per": f"one launch at T={tr['m']} V={tr['k']} bf16",
                **{site: {k: at[site][k] for k in
                          ("m", "k", "ms", "plain_ms", "bound_ms")}
                   for site in ("acereason_row", "moe_train", "data_free",
                                "nemo_train")},
                "launches_by_path": {"serve": 0, "train": train_total[name],
                                     "train_parts": {p: n[name] for p, n in
                                                     train_paths.items()}}}

    def k7_entry():
        at = {r["site"]: r for r in rows["paged_attention"]}
        dec = at["decode"]
        by_path = {"engine_a": a_launches["paged_attention"],
                   "engine_b": b_launches["paged_attention"],
                   "engine_g_chunked": g_launches["paged_attention"],
                   "engine_m": m_launches["paged_attention"],
                   "engine_mb": mb_launches["paged_attention"],
                   **spec_paths("paged_attention")}
        return {"name": "paged_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:93",
                "launches": sum(by_path.values()),
                "max_abs_err": err["paged_attention"], "ms": dec["ms"],
                "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
                "bound_by": dec["bound_by"], "library_ms": None,
                "per": f"one decode launch: {dec['shape']}",
                "paged_prefill": {k: at["paged_prefill"][k] for k in
                                  ("shape", "ms", "plain_ms", "bound_ms")},
                "decode_4k": {k: at["decode_4k"][k] for k in
                              ("shape", "ms", "plain_ms", "bound_ms")},
                **{site: {k: at[site][k] for k in
                          ("shape", "ms", "plain_ms", "bound_ms")}
                   for site in ("verify", "decode_fp8")},
                "traced_decode_step_ms": {"engine_a": engine_a_trace["k7_ms"],
                                          "engine_m": engine_m["k7_ms"]},
                "launches_by_path": by_path}

    def k3_entry():
        rs = rows["nvfp4_matmul_grouped"]
        dec = [r for r in rs if r["phase"] == "decode"]
        per_layer = {"wg/wu": 2, "wd": 1}          # wg and wu share a shape

        def layer_sum(key, sel):
            return sum(per_layer[r["site"]] * r[key] for r in sel)
        by_path = {"engine_m": m_launches["nvfp4_matmul_grouped"],
                   "engine_mb": mb_launches["nvfp4_matmul_grouped"],
                   **spec_paths("nvfp4_matmul_grouped")}
        return {"name": "nvfp4_matmul_grouped", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/nvfp4_matmul_grouped.cu",
                "replaces": "src/repro/kernels/nvfp4_matmul.py:233",
                "launches": sum(by_path.values()),
                "max_abs_err": err["nvfp4_matmul_grouped"],
                "max_err_over_bound": err_bound["nvfp4_matmul_grouped"],
                "ms": layer_sum("ms", dec), "plain_ms": layer_sum("plain_ms", dec),
                "bound_ms": layer_sum("bound_ms", dec),
                "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in dec)
                             else "operations"),
                "library_ms": layer_sum("library_ms", dec),
                "per": f"one MoE decode layer: wg, wu, wd at G={n_exp}, M=8",
                "per_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                                 "bound_ms", "library_ms")}
                              for r in rs],
                "launches_by_path": by_path}

    def k4_entry():
        rs = rows["nvfp4_matmul_tp"]
        dec = [r for r in rs if r["m"] == ENGINE["n_slots"] and r["rank"] == 0]
        return {"name": "nvfp4_matmul_tp", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/nvfp4_matmul.cu",
                "wrapper": "src/repro_torch/kernels/nvfp4_matmul.py",
                "replaces": "src/repro/kernels/nvfp4_matmul.py:318",
                "launches": tp_launches[0]["nvfp4_matmul_tp"]
                + sum(n["nvfp4_matmul_tp"] for n in n5_launches.values())
                + sum(n["nvfp4_matmul_tp"] for n in o5_launches.values()),
                "launches_by_path": {
                    "engine_tp_rank0": tp_launches[0]["nvfp4_matmul_tp"],
                    **{f"engine_5n_{p}_rank0": n["nvfp4_matmul_tp"]
                       for p, n in n5_launches.items()},
                    **{f"engine_5o_{p}_rank0": n["nvfp4_matmul_tp"]
                       for p, n in o5_launches.items()}},
                "max_abs_err": err["nvfp4_matmul_tp"],
                "max_err_over_bound": err_bound["nvfp4_matmul_tp"],
                "ms": sum(r["ms"] for r in dec),
                "plain_ms": sum(r["plain_ms"] for r in dec),
                "bound_ms": sum(r["bound_ms"] for r in dec),
                "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in dec)
                             else "operations"),
                "library_ms": sum(r["library_ms"] for r in dec),
                "per": (f"one decode layer on rank 0 of {TP_SIZE}: K2 on the "
                        f"tiles of wqkv, wo, wg, wu, wd at M={ENGINE['n_slots']} "
                        "(the row all-reduce is host-staged, timed in the "
                        "traced step)"),
                "per_tile": [{k: r[k] for k in ("site", "m", "k", "n", "ms",
                                                "plain_ms", "bound_ms",
                                                "library_ms")} for r in rs],
                "collective_ms_per_decode_step": engine_tp["trace"]["collective_ms"],
                "launches_by_rank": [ln["nvfp4_matmul_tp"] for ln in tp_launches]}

    kernels = [qdq_entry(),
               serve_entry("nvfp4_matmul",
                           "src/repro_torch/kernels/csrc/nvfp4_matmul.cu",
                           "src/repro/kernels/nvfp4_matmul.py:130"),
               kl_entry("kl_loss", "src/repro_torch/kernels/csrc/kl_loss.cu",
                        "src/repro/kernels/kl_loss.py:87"),
               kl_entry("kl_loss_bwd", "src/repro_torch/kernels/csrc/kl_loss.cu",
                        "src/repro/kernels/kl_loss.py:123"),
               k7_entry(), k3_entry(), k4_entry()]
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
