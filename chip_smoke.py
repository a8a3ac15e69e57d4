#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. The card's name and power limit, torch / CUDA versions, and the build of
   the CUDA kernels (one ``nvcc`` per source, all at once).
2. Each hand-written kernel against its plain PyTorch version on the card,
   at the serving path's shapes, in bf16, with the tolerance stated beside
   it: the kernel's time (L2 flushed before every launch), the plain
   version's, the least time the card could take for the same work
   (``bound_ms``), and one PyTorch library call of the same function where
   one exists (``library_ms``, a yardstick the port never calls).  The
   profiler's device time a call of the kernel's own launches and of its
   yardstick is queued here and read at the end, after phase 7, so that
   its sessions and flushes run after the timed windows of phases 3-7
   (``Timer.later``).  Flash attention also at head dims 32
   and 128 and with query rows that see no key; the codec also at the
   streaming engine's 4 and 32 rows; paged attention (dense and int8
   pools) also at the streaming engine's 4-slot group over 32-page rings at
   C = 1 and 16 (``PA_CASES``, SDPA beside it); the expert FFN also at the
   streaming cloud tier's n = 4 and the pipeline's n = 1024 (an uneven
   top-1 split over the 8 experts; bf16 and f32), PyTorch's per-expert
   products and ``torch._grouped_mm`` beside it (``ffn_yardsticks``), and
   at llama4-scout's width (d_model 5120) on both of its paths
   (``WIDE_FFN_CASES``).  The group gate at ``GATE_ROWS`` (4 to 1024
   tokens) and at llama4-scout's width (d_model 5120, 16 experts in 4
   groups), x in bf16 and f32, with no mask, a partial mask and a mask that
   kills a group, ``torch.matmul`` against its weight columns beside it.
   The codec, paged attention, the expert FFNs and the gate are launched
   twice at each shape for equal bits.  The MoE dispatch codec's fused
   roundtrip (``run_roundtrip``: X̂ = T(T(X·E)·D) and its error in one
   launch) at ``ROUNDTRIP_ROWS`` x ``ROUNDTRIP_RANKS``, bf16 and f32, 100
   relaunches at 4 rows for equal bits, timed at 8, 1000 and 1024 rows
   beside its plain version and two ``torch.matmul`` calls.
3. Full-width switch-base (12 layers, d_model 768, 8 experts) with random
   weights from a seeded generator, serving 8 requests (prompts of 16-200
   tokens, 32 new tokens each) through ``ServingEngine`` on the card.  The
   kernels' launch counters are zeroed just before and read just after;
   every kernel must have launched, every request must finish and the KV
   page pool must be empty again.  Step times, tokens/s and peak memory;
   then 8 more requests of the same prompt lengths, and a profiled decode
   step with their 8 slots decoding.  ``python3 chip_smoke.py --serve``
   runs the build and this phase alone.
4. The first prefill chunk and one decode step of a short prompt on the card
   against the same model on the CPU (plain versions, same bf16 weights).
5. The one-shot two-tier ``EndCloudPipeline`` on the same full-width
   switch-base weights: a jetson-orin end tier and an a100 cloud tier (the
   planner's modeled profiles), an eq. 8 codec of rank 384, tokens [4, 256]
   from a seeded generator.  The plan must be the reference planner's
   (split 1 of 6, codec on, 3 of 8 experts on the end tier); the counters,
   zeroed just before one ``run_batch``, must read 12 flash-attention, 1
   encode, 1 decode, 6 gate, 6 expert-FFN and 0 paged-attention launches;
   the boundary payload is 4*256*384 bf16 values.  Median per-tier times
   over 10 warm runs, tokens/s and peak memory.  Then the same pipeline on
   the CPU (plain versions, same weights and codec) as the reference: in f32
   the whole batch; in bf16 every layer fed the CPU's input for it (routes
   equal but for near ties, each layer's output close), and free-running
   batches of four token seeds (see ``pipeline_vs_cpu``).
   Then the MoE dispatch codec (``DISPATCH_CODEC``, the benchmarks' ec2moe
   system: rank 384 on the expert dispatch) on a second full-width
   switch-base: phase 3's traffic through ``ServingEngine`` (the roundtrip
   launched twice a gate launch, the boundary codec never; a profiled
   decode step), phase 4's card-vs-CPU check in f32 (in bf16 the codec's
   extra roundings flip near-tied routes between the two), and one
   ``run_batch`` of phase 5's pipeline (12 roundtrips at 1024 rows,
   profiled).
6. The streaming two-tier ``EndCloudServingEngine`` on full-width switch-base
   with its weights as stored (f32, so the end tier's expert slab store is
   f32) and bf16 activations, the eq. 8 codec at rank 384, 8 slots in two
   micro-batch groups.  The resident expert FFN kernel against its plain
   version at the end tier's shapes first.  Then (``stream_pool_run``) the
   end tier's expert pool through a memory shrink and regrow on a
   jetson-orin end sized to hold the 3 target slabs, split pinned at 1,
   stage times measured: 16 requests finish, the pools drain, and the
   counters are the reference engine's (2 evictions, 2 prefetches of
   18874368-byte slabs, 140 end-stage steps, 74 prefill chunks, 1986816
   bytes up), every kernel launched as often as the schedule implies.  Tick
   times, stage times, tokens/s, peak memory and a profiled decode tick.
   Then (``stream_replan_runs``) a hard bandwidth change moves the planned
   split from 1 to 0 at a safe point: pooled against dense-mask end tiers
   in bf16 on the card (equal tokens), and a shortened run in f32 on the
   card against the same on the CPU (equal tokens).  Then the pool run and
   the f32 card-vs-CPU replan run again on a switch-base with the dispatch
   codec, both tiers carrying it (``dispatch_stream``: the same counters,
   the roundtrip twice a gate launch on ``moe_resident`` and
   ``moe_sorted``).
7. The streaming engine with its three int8 byte streams on (``quantize_kv``,
   ``quantize_experts``, ``quantize_boundary``).  The row and column
   quantizer (slab columns at ``SLAB_OUTER`` slabs), the dequantizer, the
   int8 boundary folded into the codec (``run_codec_quant``: encode +
   quantize and dequantize + decode at ``CODEC_QUANT_ROWS`` x
   ``CODEC_QUANT_RANKS``, bf16 and f32, bit-equal to the composed kernels),
   the KV pools' quantize-and-write (``KV_WRITE_CASES``: ring
   writes past a wrap, chunks with padding rows), paged attention over int8
   pools and the resident expert FFN over an int8 slab store against their
   plain versions at the engine's shapes (codes and scales and the
   dequantizer's values bit for bit; the KV write's outside the garbage
   row).  Then phase 6's pool run with the flags on (same end
   memory): 16 requests finish, the pools drain, the counters are the
   reference's quantized engine's (``QUANT_POOL_COUNTERS``, read by
   ``tools/ref_stream_counters.py``), every kernel launched as the schedule
   implies (the boundary through the fused forms: one launch a stage call
   each side, no standalone dequantize; the quantizer on slab writes only),
   and the boundary bytes, KV and slab capacity ratios reported
   beside phase 6's; the share of phase 6's bf16 tokens it reproduces
   (reported, not held to a bound); a profiled tick.  Then the shortened
   f32 replan run, card against CPU: with each int8 stream alone the tokens
   are equal; with all three, the tokens are equal or the first top-1 route
   that differs is a near tie (``f32_all_streams_card_vs_cpu``).
8. Speculative decode and preemption on the streaming engine
   (``spec_and_preempt``), ``stream_engine``'s settings at split 1 with a
   jetson-orin end and modeled stage times, ``SPEC`` (``spec_k=4`` and a
   50 ms round trip an upload, which plans k = 4).  In f32 on the card, 8
   requests of 32 tokens, with the rank-384 boundary codec and without it
   (the draft never runs the codec, so with it on random weights nearly
   every round rejects): the speculative run's tokens equal the plain
   run's, or the first token that differs is a near tie
   (``equal_or_tie``: a top-2 gap below ``TIE`` of some layer's gate
   probabilities or of the LM head's logits, through the engine's tiers);
   without the codec, at ``SPEC_CPU_LAYERS`` layers, a card run's tokens,
   counters and host syncs (``SPEC_COUNTERS``) equal the CPU run's;
   rounds roll back, and without the codec drafts are also accepted.  In
   bf16 with the expert pool and the three int8 streams: it completes, the
   pools drain, the path's kernels launch and no other (``SPEC_PATH``;
   flash attention from the draft installs, paged attention at C = k, a
   histogram of its calls by rows a slot), and one round's draft scan, end
   chunk and cloud verify are profiled beside a plain round's end and
   cloud steps.  Then preemption in f32: 8 low-priority requests decoding
   in every slot, then 2 interactive ones: 2 spills and 2 restores, the
   tokens equal a run without preemption (tie rule), the pools drain, and
   at ``SPEC_CPU_LAYERS`` layers the counters, spill bytes and tokens equal
   the CPU run's; over dense and int8 KV pools,
   with the host time of each spill and restore.  Phase 2 also checks
   paged attention at the speculative chunks' C = 2 and 4 (B = 4, 16-page
   rings) and flash attention at the draft prefill's [1, 256, 12, 64].
9. The fleet (``fleet_phase``): ``FleetServingEngine`` with three lanes
   (jetson-orin, jetson-orin, phone-soc ends, ``stream_engine``'s
   settings a lane, splits forced to 1, 2, 1 where the planner gives 1
   everywhere), an a100 cloud of two servers shared by every lane's cloud
   stages (one page pool, one multi-server timeline resource), modeled
   stage times, priority admission with preemption, the fleet expert
   registry with a 1 Gbps modeled end<->end LAN.  ``FLEET_N`` seeded
   requests of the interactive and batch classes at ``FLEET_RATE``
   (Poisson) driven by ``loadgen.drive`` on a ``VirtualClock``; lane 0,
   then lane 1, turns hot on expert group 2 (``FLEET_SKEW_TICKS``), so
   lane 1's new slabs come from lane 0 over the LAN.  In f32 on the card
   (phase 10 holds the same engine against its CPU run): every request
   finishes and is stamped, peer fetches and preemptions both > 0, the
   splits interior, the pools drain, the path's kernels launch.  In bf16 with the three int8 streams: completes and drains,
   ``summarize()`` a class (modeled clock, not the card's speed), only the
   path's kernels launch (``FLEET_BF16_PATH``), and one profiled fleet
   tick (``chiprun_out/fleet_profile.txt``) beside phases 6-7's ticks.
10. Chaos on that fleet (``chaos_phase``): ``CHAOS_N`` of the seeded
   requests under a declared schedule after ``benchmarks/serve_chaos.py``
   with every kind of event (``chaos_faults``: a peer-fetch fault armed at
   once, flaky uploads on lane 0, lane 1's crash while it decodes and its
   cold recovery, the loss of one of the two cloud servers, a blackout
   window on lane 0), each event on a tick of its own (``CHAOS_TIMES``,
   placed by ``chaos_calibrate``; ``--chaos-timeline`` runs the phase alone
   and times them anew).  In f32 with the exact boundary: a clean and a
   chaos run on the card (card = CPU in fire log, placements, replans,
   counters, stamps and tokens is held by the card test
   ``test_fleet_chaos_on_card_matches_cpu`` at smoke size); every request
   finishes once, each fault met live traffic (migrations with spilled
   bytes, lane 0 at split 0 with degraded ticks, retries, one server lost,
   a peer fetch fell back), the pools and the migration park drain; the
   requests no fault moved keep the clean run's tokens (or differ first at
   a near tie); the interactive class's modeled p99 TTFT beside the fault
   window.  In bf16 with the int8 streams and the rank-384 codec: the same
   checks but the CPU's, the migrated bytes a page below 0.7 of the f32
   run's, only ``CHAOS_BF16_PATH``'s kernels, device memory after the
   blackout's ``reserve(0)``, and one profiled tick with lane 1 down
   (``chiprun_out/chaos_profile.txt``) beside phase 9's.
11. qwen2-vl-2b (``vlm_phase``): M-RoPE and patch embeddings at full width
   and depth (28 layers, d_model 1536, 12 heads on 2 kv heads of 128,
   vocab 151936), random weights from seed 0 (f32 as stored, bf16
   activations).  (a) ``Model.prefill`` of 2 rows of 256 patch embeddings
   on a 16 x 16 grid and 64 text tokens, then 16 greedy decode steps: one
   flash-attention launch a layer; the grid's logits against uniform
   positions' (M-RoPE moved them); f32 card against CPU (tokens equal or a
   near tie) and bf16 layer by layer (each card layer fed the CPU's input),
   the CPU side at ``VLM_CPU_LAYERS`` layers.  (b) Phase 3's traffic
   through ``ServingEngine`` (paged attention only), a profiled decode step
   (``chiprun_out/vlm_decode_profile.txt``) and phase 4's check in f32 at
   full depth.  (c) ``EndCloudPipeline`` (jetson-orin end, a100 cloud, rank
   384, tokens [4, 256]; the planner's split 1 of 28): 28 flash, 1 encode,
   1 decode launches a ``run_batch``, per-tier times, f32 card against CPU.
   (d) ``EndCloudServingEngine`` (``spec_engine``'s settings): f32 card
   against CPU; bf16 with the three int8 streams (only ``VLM_INT8_PATH``'s
   kernels, a profiled tick, ``chiprun_out/vlm_stream_profile.txt``); bf16
   with ``spec_k = 4`` (its k-row verify chunks on the tensor-core body).
   Every kernel of ``VLM_KERNELS`` launched over (a)-(d).  Then each of
   them against its plain version at qwen2-vl's shapes, timed beside its
   bound and library call (``vlm_kernels``).  ``python3 chip_smoke.py
   --vlm`` runs the build and this phase alone and prints no result line.

12. mamba2-130m (``ssm_phase``): the Mamba-2 SSM layer at full width and
   depth (24 layers, d_model 768, 24 heads of 64, d_state 128, chunk 256,
   tied vocab 50280), random weights from seed 0 (f32 as stored, bf16
   activations).  (a) ``Model.prefill`` of 2 x 256 and 1 x 1024 tokens (4
   chunks) then 16 greedy steps: no kernel launches in bf16; f32 card
   against CPU at full depth (tokens equal, logits within 1e-4 of max).
   (b) Phase 3's traffic through the dense-ring ``ServingEngine`` (every
   request finishes), a profiled 8-slot decode step
   (``chiprun_out/ssm_decode_profile.txt``) and the SSD update's and conv
   step's share of it (``ssm_step_shares``), f32 card tokens = CPU's (16 a
   request).  (c) ``EndCloudPipeline`` (jetson-orin end, a100 cloud, rank
   384, tokens [4, 256]; split 1 of 24): one encode and one decode launch
   and nothing else, f32 card logits = CPU's (two rows).  (d) jamba-1.5-large's hybrid at smoke
   width in ``HYBRID_LAYERS`` layers (SSM x7, attention at position 4,
   top-2 MoE over 4 groups at the odd positions): the model, the dense
   engine (1- and 2-token prompts among ``HYBRID_SERVE_LENS``) and the
   pipeline (rank 64, split 1 of 2) in bf16 (gate, expert FFN, flash
   attention and, in the pipeline, the codec launch; nothing else) and f32
   card against CPU.  Then each of its kernels against its plain version
   at the hybrid's shapes (``ssm_kernels``).  ``python3 chip_smoke.py
   --ssm`` runs the build and this phase alone and prints no result line.
13. h2o-danube-3-4b (``danube_phase``), the attention kernels at head_dim
   120 (32 heads on 8 kv heads; computed at a width of 128 over rows of
   stride 120), at full width and depth (24 layers, d_model 3840, window
   4096), random weights from seed 0 (f32 as stored, bf16 activations).
   First its kernels against their plain versions at its shapes
   (``danube_kernels``: paged attention at decode over f32, bf16 and int8
   pools and a 32-row chunk, the tensor-core body in bf16; flash attention
   [2, 256] causal with and without a window; the int8 KV write at a line
   of 960), timed beside bound and SDPA.  Then phase 11's (b)-(d) on it:
   phase 3's traffic through ``ServingEngine``, the pipeline (split 1 of
   24, rank 384: 24 flash, 1 encode, 1 decode launches) and the streaming
   engine with the int8 streams (8 requests of 16 tokens); its f32
   card-vs-CPU checks run the first ``VLM_CPU_LAYERS`` layers at full
   width (the whole f32 model is 15.8 GB).  ``python3 chip_smoke.py
   --danube`` runs the build and this phase alone.
14. whisper-base (``encdec_phase``), the encoder-decoder at full width and
   depth (6 decoder layers of self- and cross-attention over a 6-layer
   bidirectional encoder of 1500 frames, d_model 512, 8 heads of 64),
   random weights from seed 0, frame embeddings from a seeded generator:
   ``Model.prefill`` of 4 rows of 64 tokens (rings of 448, whisper's text
   context) then 32 greedy ``decode_step`` s in bf16: exactly 18 flash
   launches a prefill (6 encoder, 6 causal self, 6 cross, non-causal with
   Sq != Skv) and none in a decode step (dense rings and the cross cache,
   plain PyTorch); the cross cache's bytes a slot; a profiled decode step
   (``chiprun_out/encdec_decode_profile.txt``) and cross-attention's share
   of it; f32 card against CPU at full depth (tokens equal, logits within
   ``SSM_F32_REL`` of max); then flash attention at the encoder's [4, 1500,
   8, 64] and the cross-attention's 64 queries on 1500 frames, not causal,
   bf16 and f32, beside bound and SDPA (``encdec_kernels``).  ``python3
   chip_smoke.py --encdec`` runs the build and this phase alone.
15. Training on switch-base at full width (``train_phase``; ``python3
   chip_smoke.py --train`` runs the build and this phase alone): (a) the
   flash backward kernel against its plain version (the reference's
   ``_bwd``) at ``BWD_CASES`` (switch-base [4, 256, 12, 64] causal in bf16
   and f32, GQA [2, 256, 40/8, 128], h2o-danube's hd 120 with a window of
   64, whisper's non-causal encoder [4, 1500, 8, 64] and 64 queries on
   1500 frames): dq, dk, dv within 1e-4 (f32) or 2e-2 (bf16) of each
   one's largest |value|, the forward's log-sum-exp within 1e-5; flushed
   ms and profiler device µs, the bound (five products), the plain
   version's ms and SDPA's backward through autograd as a yardstick.
   (b) The gate's and expert FFN's autograd Functions card vs CPU in f32
   at 1024 tokens.  (c) The train step at full width and 2 blocks in f32,
   card vs CPU: gradients, then 2 AdamW steps (routes, losses, grad norm,
   routing statistics, params).  (d) ``Trainer`` at full width and depth
   in bf16 (f32 master params, AdamW lr 3e-4 after 5 warmup steps) for
   ``TRAIN_STEPS`` steps of batch 4 x 256 on the ``lm`` task, a
   synchronous checkpoint every ``TRAIN_CKPT_EVERY`` steps: the loss
   falls, ``TRAIN_PER_STEP`` launches a step and no other kernel, the
   median step time, tokens/s, peak memory and one profiled step
   (``chiprun_out/train_step_profile.txt``).  (e) In f32 at 2 blocks: a
   run resumed from its step-3 checkpoint reproduces steps 4-6 within
   1e-5, and a ``FailureInjector`` at step 4 makes exactly one restore.
16. Training, second half (``train2_phase``; ``python3 chip_smoke.py
   --train2`` runs the build and this phase alone): (a) the dispatch
   codec's autograd Function (``RoundtripLossFn``: the roundtrip kernel's
   forward, the encode and decode kernels' above rank 512) against
   autograd of its plain version at ``CODEC_FN_CASES`` (the fused plan at
   [1024, 768] and 8 rows, rank 384; the composed plan at d 4096, rank
   1024, 256 rows; bf16 and f32): X̂, dX, dE, dD within 1e-5 (f32) or
   2^-6 (bf16) of each one's largest |value|, the counters risen by the
   plan's kernels.  (b) One f32 train step card vs CPU at full width and
   reduced depth (the codec model, switch-base with ``DISPATCH_CODEC``, at
   4 layers; mamba2-130m at 4; whisper-base at 2 decoder and 2 encoder
   layers on 1500 frames; jamba's smoke hybrid): routes, loss,
   ``recon_loss``, grad norm, every gradient leaf and every param after
   the update.  (c) bf16 at full width and depth: ``Trainer`` on the codec
   model and on mamba2-130m, ``make_train_step`` on whisper-base with
   seeded frames [4, 1500, 512], ``TRAIN2_STEPS`` steps of 4 x 256 each:
   losses finite, the codec's ``recon_loss`` falls, ``TRAIN2_PER_STEP``
   launches a step and no other kernel, the median step time, tokens/s,
   peak memory and a profiled step
   (``chiprun_out/train2_{codec,mamba2,whisper}_profile.txt``).
17. Expert parallelism (``ep_phase``; ``python3 chip_smoke.py --ep`` runs
   the build and this phase alone): qwen3-moe-235b-a22b at full width
   (d_model 4096, 64 heads on 4 kv heads of 128, 128 experts in 16 groups,
   top-8, d_ff 1536, vocab 151936) cut to ``EP_LAYERS`` layers, over
   ``EP_MESH`` = (1, 4) ranks (``serve_tp``: 32 experts a rank) that
   ``launch.mesh.spawn_ranks`` starts on the one card (gloo over CUDA
   tensors), every rank drawing the non-expert weights from one seed and
   only its own experts, each from a generator seeded by (seed, layer,
   expert).  First the path's kernels against their plain versions at its
   shapes (``ep_kernels``: paged attention at 64/4 heads of 128, decode and
   a 32-token chunk, bf16 and f32; the gate's wide form at d 4096 with 128
   experts in 16 groups; the expert FFN over 32 local experts at ``ep·C`` =
   32 and 64 rows, and in f32 also at (a)'s 16 and 256; the codec at 4096
   -> 1024), then one-process runs on the card
   (never beside the ranks: about 25 GB against 4 x 10): (a)'s sorted
   serving, (b)'s plain composition.  In the ranks: (a) f32, no codec,
   dropless (``eval_capacity_factor`` = ep): 4 requests (prompts 16-200, 16
   new tokens) through 4 slots (the a2a body) and through 2 (decode's 2
   tokens fall back to the tp body); every rank's tokens equal the
   one-process run's.  (b) One MoE layer with the config's rank-1024
   dispatch codec, f32: each body's gathered output against the plain
   composition (a2a: decode(encode(FFN_e(decode(encode(x))))) times w,
   summed; tp: the codec around the summed partials), within ``EP_REL`` of
   max |y|.  (c) bf16 with the codec, 8 requests through 4 slots: every
   request finishes, every pool drains, the ranks' tokens are equal,
   ``EP_PATH``'s kernels launch and no other; the step times, each rank's
   peak memory, the collectives' calls and bytes a decode step (the a2a
   payload at rank 1024 a quarter of the uncompressed one, shape-only)
   and a profiled decode step's busy share on rank 0
   (``chiprun_out/ep_decode_profile.txt``).
18. Training on a mesh (``train_mesh_phase``; ``python3 chip_smoke.py
   --train-mesh`` runs the build and this phase alone): full-width,
   full-depth switch-base over a (2, 2) mesh of 4 ranks
   (``elastic_topology(4, model_axis_size=2)``: ZeRO-3 blocks over the
   data axis, experts over the model axis, the a2a body) that
   ``spawn_ranks`` starts on the one card (gloo over CUDA tensors).  First
   the path's kernels at a rank's shapes (``tm_kernels``).  (a) f32 at
   capacity 8 with the load-balance weight 0 (``tm_configs``): 2 steps of
   ``Trainer`` on the mesh against 3 of the one-process ``Trainer`` on the
   card from the same seed-0 params and batches: every step's loss within
   1e-5 relative, grad norm within 1e-4, the mesh checkpoint's params
   after step 2 (whole arrays) against the one process's.  (b) That
   checkpoint resumed in one process and on
   ``elastic_topology(2, model_axis_size=2)``, a (1, 2) mesh of 2 ranks:
   step 3's loss within 1e-5 of the uninterrupted run's.  (c) bf16 at the
   config's capacity 1.25, 5 steps: losses finite, rank 0's step median,
   a profiled step's busy share (``chiprun_out/train_mesh_step_profile.txt``),
   each rank's peak memory, the collectives' calls and bytes a step
   (forward with the recomputation, and backward), ``TM_PER_STEP``
   launches a step and no other kernel, ``dropped_frac``.  (d) The same
   with the rank-384 dispatch codec, 3 steps: the a2a payload exactly
   rank / d of (c)'s, the expert ids' bytes unchanged, the encode and
   decode launches in ``TM_CODEC_PER_STEP``.

The last lines are the kernels' JSON record (``spec_launches``: each
wrapper's launches in phase 8's bf16 speculative run; ``fleet_launches``:
in phase 9's bf16 fleet run; ``chaos_launches``: in phase 10's bf16 chaos
run; ``vlm_launches``: over phase 11's runs; ``ssm_launches``: over phase
12's bf16 runs; ``danube_launches``: over phase 13's runs;
``encdec_launches``: in phase 14's bf16 run; ``train_launches``: in
phase 15's bf16 training run, whose count is also ``flash_attention_bwd``'s
``launches``; ``train2_launches``: over phase 16's bf16 runs;
``ep_launches``: rank 0's in phase 17's bf16 run;
``train_mesh_launches``: rank 0's in phase 18's bf16 runs), the
``nvidia-smi``
name and power limit, and ``{"ok": true, "device": {...}}``.  The profiled
decode step, ``run_batch`` and stream ticks log the mean time in path, a
wrapper call, of paged attention (its sweep and merge), the expert FFNs
(streaming kernel and reduction, or the two tensor-core GEMMs), the gate,
flash attention, the codec (and its fused int8 boundary forms, and the
dispatch codec's roundtrip) and the
int8 streams' KV write and quantizers (``kernels_in_path``), and the int8
tick's count of copy and cast kernels.  ``torch.profiler``
tables of one decode step and of one ``run_batch`` go to
``chiprun_out/decode_profile.txt`` and ``chiprun_out/pipeline_profile.txt``,
one of a streaming-engine tick to ``chiprun_out/stream_profile.txt`` (and
with the int8 streams to ``chiprun_out/stream_quant_profile.txt``; the
dispatch codec's runs to ``*_dispatch_profile.txt``), and the
compiler's register / spill report to
``chiprun_out/nvcc_build.log``.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (dense rates below too)
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of a callable over ``iters`` launches, each after an
    L2 flush (the serving step reaches every layer's weights and pages cold:
    the weights alone are 660 MB against a 50 MB L2).  ``__call__`` reads a
    CUDA event pair around each call, which also times the wrapper's Python;
    :meth:`device_us` reads the profiler's device time of the call's own
    kernels.  Phase 2 queues its profiler readings with :meth:`later`;
    :meth:`read_later` takes them after the timed serving, pipeline and
    stream runs, so that their profiler sessions, yardstick calls and
    flushes run after those windows, not before them."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        self.queued = []

    def later(self, label: str, fn, yardsticks=None):
        """Queue the device time a call of ``fn`` (and the line that
        ``yardsticks()`` returns, the yardsticks' device times) under
        ``label``."""
        self.queued.append((label, fn, yardsticks))

    def read_later(self):
        """Log every queued reading, in the order queued, and drop them."""
        for label, fn, yardsticks in self.queued:
            dev_us, keys = self.device_us(fn)
            yard = f", {yardsticks()}" if yardsticks is not None else ""
            log(f"  {label}: kernel {dev_us:.3f} [{short_names(keys)}]{yard}")
        self.queued.clear()

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    def device_us(self, fn, iters: int = 20):
        """(mean device time in us of every kernel one call of ``fn``
        launches, each call after an L2 flush; {kernel name: its mean us}),
        read by ``torch.profiler`` over the flushes and calls, the flush's
        own fill kernel left out; nan where it recorded no other kernel."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush_buf.zero_()
                fn()
            torch.cuda.synchronize()
        per = {e.key: e.self_device_time_total / iters for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and "FillFunctor" not in e.key
               and "Memset" not in e.key}
        if not per:
            return float("nan"), {}
        return sum(per.values()), per


def short_name(key: str) -> str:
    """A kernel's name without its namespace, template and argument lists."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0][:48]


def short_names(per: dict) -> str:
    """``{kernel name: mean us}`` (``Timer.device_us``) for a log line."""
    return ",".join(sorted(f"{short_name(k)} {us:.3f}" for k, us in per.items()))


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, rtol: float, atol: float, quiet: bool = False) -> float:
    """Elementwise ``|out - ref| <= atol + rtol * |ref|``; returns max |out - ref|
    (``quiet``: logged only if it fails)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * ref.abs()).all())
    if not (quiet and ok):
        log(f"  {name}: max_abs_err={err:.3e} rtol={rtol:.3e} atol={atol:.3e} "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"beyond rtol={rtol} atol={atol} (max |diff| {err})")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


# (name, B, pps, C, ring anchors): the serving engine's decode step and
# prefill chunk (8 slots, 16-page rings; a 1-token slot and one slot past a
# ring wrap), and the streaming engine's micro-batch group of 4 slots with
# its default 512-token ring (32 pages), decode and a 16-token chunk
PA_CASES = (
    ("B=8 pps=16 C=1", 8, 16, 1, (0, 15, 16, 47, 100, 199, 231, 300)),
    ("B=8 pps=16 C=32", 8, 16, 32, (0, 15, 16, 47, 100, 199, 231, 300)),
    ("B=4 pps=32 C=1", 4, 32, 1, (37, 118, 199, 231)),
    ("B=4 pps=32 C=16", 4, 32, 16, (37, 118, 199, 231)),
    # speculative decode's end and verify chunks (phase 8: max_len 256)
    ("B=4 pps=16 C=2", 4, 16, 2, (37, 118, 199, 231)),
    ("B=4 pps=16 C=4", 4, 16, 4, (37, 118, 199, 231)),
)


def paged_attention_inputs(torch, C: int, seed: int, B: int = 8, pps: int = 16,
                           lengths=PA_CASES[0][4], heads=(12, 12, 64), dtype=None):
    """B slots, ``heads`` = (query heads, kv heads, head dim), 16-token
    pages, a pps-page ring; slot b holds positions up to ``lengths[b]`` (its
    ring anchor), unmapped table entries are garbage, and the C query rows
    end at the anchor; q and the pools in ``dtype`` (bf16 by default)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    (H, KV, hd), ps = heads, 16
    lengths = torch.tensor(lengths, dtype=torch.int32)
    P = B * pps
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(seed)).view(B, pps)
    table = torch.full((B, pps), P, dtype=torch.int32)
    for b in range(B):
        mapped = min(pps, int(lengths[b]) // ps + 1)
        table[b, :mapped] = perm[b, :mapped].int()
    q_pos = lengths[:, None] - (C - 1) + torch.arange(C, dtype=torch.int32)[None, :]
    q_pos = q_pos.clamp_min(0).int()
    dev = dict(device="cuda")
    dtype = dtype or torch.bfloat16
    q = torch.randn(B, C, H, hd, generator=g, **dev).to(dtype)
    pool_k = torch.randn(P + 1, ps, KV, hd, generator=g, **dev).to(dtype)
    pool_v = torch.randn(P + 1, ps, KV, hd, generator=g, **dev).to(dtype)
    return q, pool_k, pool_v, table.cuda(), q_pos.cuda(), lengths.cuda()


def run_paged_attention(torch, timer, quant: bool = False, cases=PA_CASES, heads=(12, 12, 64),
                        dtype=None):
    """Paged attention (``quant``: over int8 pools, codes and f16 scales per
    token from the quantizer) against its plain version at ``cases`` (query
    heads, kv heads and head dim ``heads``; q and dense pools in ``dtype``,
    bf16 by default): within tolerance, the same bits from a second launch,
    the bound, and beside the kernel's time SDPA's on the pre-gathered (and
    dequantized) dense ring, kv heads repeated for GQA, each as an event
    pair and as the profiler's device time a call.  Returns the first
    case's record, with the largest error."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (
        paged_attention,
        paged_attention_plain,
        paged_attention_quant,
    )
    from repro_torch.models.kvcache import (
        dequantize_kv_pool,
        paged_gather,
        quantize_kv_tokens,
        ring_key_positions,
    )

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    isz = 4 if f32 else 2
    what = ("paged_attention_quant" if quant else "paged_attention") + (" f32" if f32 else "")
    rec = {}
    for i, (name, B, pps, C, anchors) in enumerate(cases):
        seed = (10 if quant else 0) + C + (100 if i >= 2 else 0)
        q, pool_k, pool_v, table, q_pos, lengths = paged_attention_inputs(
            torch, C, seed, B=B, pps=pps, lengths=anchors, heads=heads, dtype=dtype)
        H, hd = q.shape[2], q.shape[3]
        ps, KV = pool_k.shape[1], pool_k.shape[2]
        if quant:
            kq, ks = quantize_kv_tokens(pool_k)
            vq, vs = quantize_kv_tokens(pool_v)
            args = (q, kq, vq, ks, vs, table, q_pos, lengths)
            fn = paged_attention_quant
            plain_args = (q, kq, vq, table, q_pos, lengths)
            plain_kw = dict(k_scale=ks, v_scale=vs)
            ring_k = dequantize_kv_pool(kq, ks, dtype)
            ring_v = dequantize_kv_pool(vq, vs, dtype)
            page_bytes = 2 * ps * KV * hd + 2 * ps * 2  # int8 K and V, f16 scales
        else:
            args = (q, pool_k, pool_v, table, q_pos, lengths)
            fn = paged_attention
            plain_args, plain_kw = args, {}
            ring_k, ring_v = pool_k, pool_v
            page_bytes = 2 * ps * KV * hd * isz  # K and V of one page
        out = fn(*args)
        ref = paged_attention_plain(*plain_args, **plain_kw)
        # Both sides accumulate in f32 (int8 pools: dequantized exactly, p
        # kept in f32) and round once to bf16, in another order: one to two
        # bf16 ulps of each element (rtol 2^-7), and four ulps at the median
        # |output| (atol) for elements near zero.  In f32 the sums alone
        # differ: 2^-16 of each element, 2^-14 of the median.
        rtol, arel = (2 ** -16, 2 ** -14) if f32 else (2 ** -7, 2 ** -6)
        atol = arel * ref.float().abs().median().item()
        err = check_close(f"{what} {name}", out, ref, rtol=rtol, atol=atol)
        if not torch.equal(fn(*args), out):
            raise AssertionError(f"{what} {name}: two launches on the same inputs differ")

        W = ps * pps
        kp = ring_key_positions(lengths, W)  # [B, W]
        vis = (kp[:, None, :] <= q_pos[:, :, None].long()) & (kp[:, None, :] >= 0)
        mapped = table != pool_k.shape[0] - 1
        live = vis.view(B, C, pps, ps).any(dim=(1, 3)) & mapped
        nbytes = (2 * q.numel() * isz + int(live.sum()) * page_bytes
                  + (table.numel() + q_pos.numel() + lengths.numel()) * 4)
        b_ms, b_by = bound(nbytes, 4 * hd * H * int(vis.sum()), "f32" if f32 else "bf16")
        # yardstick: SDPA over the pre-gathered dense ring with a boolean mask
        kd = paged_gather(ring_k, table).repeat_interleave(H // KV, dim=2).transpose(1, 2)
        vd = paged_gather(ring_v, table).repeat_interleave(H // KV, dim=2).transpose(1, 2)
        # kd, vd: [B, H, W, hd]
        qd, mask = q.transpose(1, 2), vis[:, None]  # mask [B, 1, C, W]

        sdpa = functools.partial(F.scaled_dot_product_attention, qd, kd, vd, attn_mask=mask)
        call = functools.partial(fn, *args)
        lib_ms = timer(sdpa)
        ms = timer(call)
        plain_ms = timer(lambda: paged_attention_plain(*plain_args, **plain_kw), iters=5)
        timer.later(f"{what} {name}", call,
                    lambda sdpa=sdpa: f"sdpa {timer.device_us(sdpa)[0]:.3f}")
        log(f"  {what} {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
            f"({b_by}) library_ms(sdpa)={lib_ms:.4f}; rows C*G={C * H // KV}, table entries "
            f"{B * pps}, mapped {int(mapped.sum())}, live {int(live.sum())}; deterministic")
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms)
    main = dict(rec[cases[0][0]])
    main["max_abs_err"] = max(r["max_abs_err"] for r in rec.values())
    return main


# the gate's rows: serving and stream decode (4, 8), a prefill chunk (256),
# the one-shot pipeline's [4, 256] batch (1024); llama4-scout's width
GATE_ROWS = (4, 8, 256, 1024)
GATE_WIDE_ROWS = (8, 1024)


def gate_yardstick(torch, timer, x, p) -> str:
    """Device time a call of ``torch.matmul`` of ``x`` against the gate's
    E + K weight columns, concatenated (and cast to x's type) once outside
    the timed window: an informative floor of the product alone, never
    called by the port."""
    K, d, Mk = p["w_local"].shape
    w = torch.cat([p["w_local"].permute(1, 0, 2).reshape(d, K * Mk), p["w_global"]], dim=1)
    w = w.to(x.dtype).contiguous()
    return f"matmul [{d}, {K * Mk + K}] {timer.device_us(lambda: torch.matmul(x, w))[0]:.3f}"


def run_group_gate(torch, timer):
    """The group gate at ``GATE_ROWS`` on switch-base's width and at
    ``GATE_WIDE_ROWS`` on llama4-scout's (d 5120, 16 experts in 4 groups),
    x in bf16 and f32, with no mask, a partial mask and a mask that kills a
    group: within tolerance of the plain version, the same bits from a
    second launch, one launch counted a call; bf16 rows without a mask
    timed beside the bound and (queued) ``gate_yardstick``."""
    from repro_torch.configs import get_config
    from repro_torch.core.gating import init_group_gate
    from repro_torch.kernels.group_gate import group_gate, group_gate_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    rec = {}
    for model, rows in (("switch-base", GATE_ROWS), ("llama4-scout-17b-16e", GATE_WIDE_ROWS)):
        cfg = get_config(model)
        p = init_group_gate(gen, cfg.d_model, cfg.moe)
        # a nonzero bias makes the bias path count
        p["b_local"].normal_(generator=gen)
        p["b_global"].normal_(generator=gen)
        E, K, d = cfg.moe.num_experts, cfg.moe.num_groups, cfg.d_model
        Mk = E // K
        e = torch.arange(E, device="cuda")
        masks = {"no mask": None, "partial mask": e % 3 != 1,
                 "dead group": (e // Mk != 1) & (e % Mk != 0)}  # group 1 all masked
        for T in rows:
            x32 = torch.randn(T, d, generator=gen, device="cuda")
            for dt in (torch.bfloat16, torch.float32):
                x = x32.to(dt)
                for mname, mask in masks.items():
                    args = (x, p["w_local"], p["b_local"], p["w_global"], p["b_global"], mask)
                    before = group_gate.launches
                    probs, pg = group_gate(*args)
                    if group_gate.launches != before + 1:
                        raise AssertionError("group_gate: a call did not count one launch")
                    rprobs, rpg = group_gate_plain(*args)
                    # f32 throughout; the logits (|l| ~ 15) are summed in another order
                    tag = f"{model} T={T} x {str(dt)[6:]} {mname}"
                    err = max(check_close(f"group_gate probs {tag}", probs, rprobs, rtol=0,
                                          atol=1e-4),
                              check_close(f"group_gate p_group {tag}", pg, rpg, rtol=0,
                                          atol=1e-4))
                    again = group_gate(*args)
                    if not (torch.equal(again[0], probs) and torch.equal(again[1], pg)):
                        raise AssertionError(f"group_gate {tag}: two launches differ")
                    key = (model, T)
                    if dt != torch.bfloat16 or mask is not None:
                        rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"], err)
                        continue
                    nbytes = T * d * 2 + d * (E + K) * 4 + (E + K) * 4 + T * (E + K) * 4
                    b_ms, b_by = bound(nbytes, 2 * T * d * (E + K), "f32")
                    call = functools.partial(group_gate, *args)
                    ms = timer(call)
                    plain_ms = timer(lambda: group_gate_plain(*args))
                    timer.later(f"group_gate {model} T={T}", call,
                                functools.partial(gate_yardstick, torch, timer, x, p))
                    log(f"  group_gate {model} T={T}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                        f"bound_ms={b_ms:.6f} ({b_by}) library_ms=null; deterministic")
                    rec[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)
    main = dict(rec[("switch-base", 8)])
    main["max_abs_err"] = max(r["max_abs_err"] for r in rec.values())
    return main


def ffn_yardsticks(torch, timer, xs, sizes, wi, wg, wo, act) -> str:
    """Device time a call (profiler, L2 flushed) of the expert FFN written
    with PyTorch's own products, each more than one call and never called by
    the port: a ``torch.matmul`` per product of every routed expert (group
    sizes known on the host) with the activation between, and, where this
    PyTorch has it, two ``torch._grouped_mm`` calls with the activation
    between (weights in the rows' type)."""
    from repro_torch.models.layers import ACTIVATIONS

    a = ACTIVATIONS[act]
    runs, start = [], 0
    for e, c in enumerate(sizes):
        if c:
            runs.append((e, start, start + c))
        start += c

    def matmuls():
        outs = []
        for e, r0, r1 in runs:
            x = xs[r0:r1]
            h = a(x @ wi[e]) * (x @ wg[e]) if wg is not None else a(x @ wi[e])
            outs.append(h @ wo[e])
        return outs

    mm_us, _ = timer.device_us(matmuls)
    out = f"per-expert matmuls ({len(runs)} experts, {len(runs) * (3 if wg is not None else 2)} " \
          f"products) {mm_us:.3f}"
    gmm = getattr(torch, "_grouped_mm", None)
    if gmm is None or xs.dtype != torch.bfloat16:
        return out + ", torch._grouped_mm not available"
    offs = torch.tensor(sizes, dtype=torch.int32, device=xs.device).cumsum(0).int()

    def grouped():
        h = a(gmm(xs, wi, offs=offs))
        if wg is not None:
            h = h * gmm(xs, wg, offs=offs)
        return gmm(h, wo, offs=offs)

    try:
        grouped()
    except (RuntimeError, TypeError, ValueError) as exc:  # a yardstick only
        return out + f", torch._grouped_mm refused these operands ({str(exc)[:80]})"
    gmm_us, _ = timer.device_us(grouped)
    return out + f", torch._grouped_mm x{3 if wg is not None else 2} {gmm_us:.3f}"


# (name, group sizes over switch-base's 8 experts, activation, gated, rows'
# type): the serving decode (n = 8), a prefill chunk (n = 32), the
# streaming engine's cloud tier (n = 4), the one-shot pipeline's [4, 256]
# batch (an uneven top-1 split), and that batch in f32 as the card-vs-CPU
# pipeline check runs it; gated SiLU checked, not timed
FFN_CASES = (
    ("decode n=8", (3, 0, 2, 0, 1, 1, 0, 1), "gelu", False, "bf16"),
    ("prefill n=32", (12, 0, 9, 3, 0, 5, 1, 2), "gelu", False, "bf16"),
    ("gated silu n=8", (0, 2, 2, 0, 0, 3, 1, 0), "silu", True, "bf16"),
    ("stream cloud n=4", (1, 0, 1, 0, 0, 1, 0, 1), "gelu", False, "bf16"),
    ("run_batch n=1024", (201, 87, 160, 45, 133, 178, 96, 124), "gelu", False, "bf16"),
    ("f32 rows n=1024", (201, 87, 160, 45, 133, 178, 96, 124), "gelu", False, "f32"),
)
# llama4-scout's expert at full width (d_model 5120, d_ff 8192, gated SiLU),
# 4 experts: the streaming path (n = 8) and the tensor cores (n = 72)
WIDE_FFN_CASES = (("llama4-scout n=8", (3, 0, 4, 1)), ("llama4-scout n=72", (30, 0, 41, 1)))
# the end tier's resident FFN over switch-base's slab store (18 slabs and the
# zero garbage slab): (name, rows' type, slot sizes, slab ids; the last slot
# is the garbage slot)
RESIDENT_SLABS = 18
RESIDENT_CASES = (
    ("decode n=4", "bf16", (2, 0, 1, 1), (7, 2, 13, RESIDENT_SLABS)),
    ("prefill n=32", "bf16", (14, 9, 5, 4), (11, 0, 5, RESIDENT_SLABS)),
    ("f32 rows n=32", "f32", (14, 0, 12, 6), (16, 3, 9, RESIDENT_SLABS)),
)
RESIDENT_QUANT_CASES = RESIDENT_CASES[:2]  # bf16 rows, as the int8 engine runs them


def switch_base_moe(gen):
    """Full-width switch-base's expert weights ``{wi, wo}`` (f32, the model's
    own shapes and init scales) drawn from ``gen``, and its config."""
    from repro_torch.configs import get_config
    from repro_torch.core.moe import init_moe

    cfg = get_config("switch-base")
    return init_moe(gen, cfg), cfg


def resident_store(torch, p, quant: bool = False):
    """The slab store of ``RESIDENT_CASES`` from switch-base's experts ``p``:
    the 8 experts, flipped, the first 2 again and the zero garbage slab; f32,
    or (``quant``) int8 codes with their column scales ``{k}_scale``."""
    from repro_torch.core.expertpool import quantize_slab

    store = {}
    for k in ("wi", "wo"):
        w = torch.cat([p[k], p[k].flip(0), p[k][:2], torch.zeros_like(p[k][:1])])
        if quant:
            store[k], store[f"{k}_scale"] = quantize_slab(w)
        else:
            store[k] = w
    return store


def wide_ffn_weights(torch, gen):
    """Four experts of llama4-scout's full width in bf16 (``wi``, ``wg`` [4,
    5120, 8192], ``wo`` [4, 8192, 5120]), scaled as its init does."""
    from repro_torch.configs import get_config

    cfg = get_config("llama4-scout-17b-16e")
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    return {k: (torch.randn(4, *shape, generator=gen, device="cuda") / shape[0] ** 0.5).bfloat16()
            for k, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}


def run_expert_mlp(torch, timer):
    """The grouped expert FFN at ``FFN_CASES``, and at llama4-scout's width
    on both paths (``WIDE_FFN_CASES``): within tolerance, the same bits from
    a second launch, the bound, and (queued) the device time a call beside
    the yardsticks of ``ffn_yardsticks``."""
    from repro_torch.kernels.expert_mlp import ffn_plan, grouped_mlp, grouped_mlp_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    p, cfg = switch_base_moe(gen)
    E, d, f = p["wi"].shape
    weights = {"bf16": (p["wi"].bfloat16(), p["wo"].bfloat16()), "f32": (p["wi"], p["wo"])}
    wg = (torch.randn(E, d, f, generator=gen, device="cuda") / E ** 0.5).bfloat16()
    wide = wide_ffn_weights(torch, gen)
    cases = [(name, sizes, act, wg if gated else None, dt, *weights[dt])
             for name, sizes, act, gated, dt in FFN_CASES]
    cases += [(name, sizes, "silu", wide["wg"], "bf16", wide["wi"], wide["wo"])
              for name, sizes in WIDE_FFN_CASES]
    rec = {}
    for name, sizes, act, wg_, dt, wi, wo in cases:
        n, dtype = sum(sizes), (torch.bfloat16 if dt == "bf16" else torch.float32)
        d_, f_ = wi.shape[1], wi.shape[2]
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        xs = torch.randn(n, d_, generator=gen, device="cuda").to(dtype)
        args = (xs, gs, wi, wg_, wo, act)
        y = grouped_mlp(*args)
        ref = grouped_mlp_plain(*args)
        # bf16: the weight-streaming path keeps the hidden activation in f32
        # where the plain version (as ragged_dot) rounds it to bf16, the
        # tensor-core path rounds it as the plain version does: within a
        # few bf16 ulps of |y| either way; f32: sums in another order
        tol = (2e-2 if dt == "bf16" else 1e-4) * ref.float().abs().max().item()
        err = check_close(f"expert_mlp {name}", y, ref, rtol=0, atol=tol)
        if not torch.equal(grouped_mlp(*args), y):
            raise AssertionError(f"expert_mlp {name}: two launches on the same inputs differ")
        if wg_ is not None:
            log(f"    path={ffn_plan(n, d_, f_, dtype)}; deterministic")
            continue
        routed = sum(1 for s in sizes if s)
        isz = xs.element_size()
        nbytes = 2 * n * d * isz + routed * 2 * d * f * wi.element_size() + E * 4
        b_ms, b_by = bound(nbytes, 2 * 2 * n * d * f, dt)
        call = functools.partial(grouped_mlp, *args)
        ms = timer(call)
        plain_ms = timer(lambda: grouped_mlp_plain(*args))
        timer.later(f"expert_mlp {name}", call, functools.partial(
            ffn_yardsticks, torch, timer, xs, sizes, wi, None, wo, act))
        log(f"  expert_mlp {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) library_ms=null routed_experts={routed} "
            f"path={ffn_plan(n, d, f, dtype)}; deterministic")
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    main = dict(rec["decode n=8"])
    main["max_abs_err"] = max(r["max_abs_err"] for r in rec.values())
    return main


def run_expert_mlp_resident(torch, timer):
    """The end tier's resident expert FFN at ``RESIDENT_CASES``: slot-sorted
    rows against the f32 slab store of full-width switch-base, permuted slab
    ids, an empty slot, and rows on the garbage slot, which must come back
    exactly 0."""
    from repro_torch.kernels.expert_mlp import grouped_mlp_resident, grouped_mlp_resident_plain

    gen = torch.Generator(device="cuda").manual_seed(5)
    p, cfg = switch_base_moe(gen)
    store = resident_store(torch, p)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    rec = {}
    for name, dt, sizes, ids in RESIDENT_CASES:
        dt = torch.bfloat16 if dt == "bf16" else torch.float32
        n = sum(sizes)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        idt = torch.tensor(ids, dtype=torch.int32, device="cuda")
        xs = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        args = (xs, gs, store["wi"], None, store["wo"], idt, cfg.act)
        y = grouped_mlp_resident(*args)
        ref = grouped_mlp_resident_plain(*args)
        # bf16 rows: the kernel keeps the hidden activation in f32 where the
        # plain version (as ragged_dot) rounds it to bf16, a few bf16 ulps of
        # |y|; f32: sums in another order
        tol = (2e-2 if dt == torch.bfloat16 else 1e-4) * ref.float().abs().max().item()
        err = check_close(f"expert_mlp_resident {name}", y, ref, rtol=0, atol=tol)
        if not bool((y[n - sizes[-1]:] == 0).all()):
            raise AssertionError(f"expert_mlp_resident {name}: garbage-slot rows are not 0")
        if not torch.equal(grouped_mlp_resident(*args), y):
            raise AssertionError(f"expert_mlp_resident {name}: two launches differ")
        # the slabs of slots with rows, read once in the store's f32, plus
        # the rows in and out; the garbage slot reads nothing
        routed = sum(1 for s in sizes[:-1] if s)
        isz = xs.element_size()
        nbytes = 2 * n * d * isz + routed * 2 * d * f * 4 + 2 * len(sizes) * 4
        b_ms, b_by = bound(nbytes, 2 * 2 * (n - sizes[-1]) * d * f,
                           "bf16" if dt == torch.bfloat16 else "f32")
        call = functools.partial(grouped_mlp_resident, *args)
        ms = timer(call)
        plain_ms = timer(lambda: grouped_mlp_resident_plain(*args))
        # yardstick: the products over the slots' slabs gathered and cast
        # to the rows' type beforehand (half the bytes of the f32 store)
        idx = idt.long()
        timer.later(f"expert_mlp_resident {name}", call, functools.partial(
            ffn_yardsticks, torch, timer, xs, list(sizes[:-1]) + [0],
            store["wi"][idx].to(dt), None, store["wo"][idx].to(dt), cfg.act))
        log(f"  expert_mlp_resident {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) library_ms=null routed_slots={routed}; "
            f"deterministic")
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    main = rec["decode n=4"]
    main["max_abs_err"] = max(r["max_abs_err"] for r in rec.values())
    return main


def flash_case(torch, timer, gen, name, B, S, H, KV, hd=64, window=None, later=False,
               causal=True, Skv=None, dtype=None):
    """Flash attention over [B, S, H, hd] queries and [B, Skv (S), KV, hd]
    keys and values in ``dtype`` (bf16 by default), causal or not (and a
    window), against its plain version; the kernel's time, the plain
    version's, the bound and SDPA's (kv heads repeated for GQA), and with
    ``later`` their device times queued (``Timer.later``); returns the
    record."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import block_mask

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    Skv = Skv or S
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window)
    out = flash_attention_fwd(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    # the same tiles and rounding points, f32 sums in another order: one
    # bf16 ulp of each element, and four at the median |output| (atol); in
    # f32 2^-16 of each element and 2^-14 of the median
    rtol, arel = (2 ** -16, 2 ** -14) if f32 else (2 ** -7, 2 ** -6)
    atol = arel * ref.float().abs().median().item()
    err = check_close(f"flash_attention {name}", out, ref, rtol=rtol, atol=atol)

    vis = block_mask(torch.arange(S, device="cuda"), torch.arange(Skv, device="cuda"), causal,
                     window)  # [S, Skv]
    isz = 4 if f32 else 2
    nbytes = 2 * q.numel() * isz + 2 * k.numel() * isz
    b_ms, b_by = bound(nbytes, 4 * hd * B * H * int(vis.sum()), "f32" if f32 else "bf16")
    # yardstick: SDPA on [B, H, S, hd] copies, KV heads repeated for GQA
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    if window is None:
        sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt, vt, is_causal=causal)
    else:
        sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt, vt, attn_mask=vis)
    call = functools.partial(flash_attention_fwd, q, k, v, **kw)
    lib_ms = timer(sdpa)
    ms = timer(call)
    plain_ms = timer(lambda: flash_attention_plain(q, k, v, **kw), iters=5)
    if later:
        timer.later(f"flash_attention {name}", call,
                    lambda: f"sdpa {timer.device_us(sdpa)[0]:.3f}")
    log(f"  flash_attention {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}) library_ms(sdpa)={lib_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def run_flash_attention(torch, timer):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import block_mask

    gen = torch.Generator(device="cuda").manual_seed(3)
    rec = {}
    cases = [
        # the pipeline's shape: B=4, S=256, 12 heads of 64, causal
        ("pipeline B=4 S=256 H=12", 4, 256, 12, 12, None),
        # ragged S, GQA G=4 and a 64-key window (tail tile, window tile skip)
        ("ragged S=200 H=8 KV=2 window=64", 2, 200, 8, 2, 64),
        # speculative decode's draft-cache prefill (phase 8): [1, max_len]
        ("draft prefill B=1 S=256 H=12", 1, 256, 12, 12, None),
    ]
    for name, B, S, H, KV, window in cases:
        rec[name] = flash_case(torch, timer, gen, name, B, S, H, KV, window=window)
    # head dims 32 and 128 at the pipeline's batch and length, and query
    # rows that see no key (a window past every key; a negative offset
    # under causality), which the kernel and its plain version leave at 0
    for name, B, Sq, Skv, H, KV, hd, window, q_offset in (
            ("hd=32 B=4 S=256 H=12", 4, 256, 256, 12, 12, 32, None, 0),
            ("hd=128 B=4 S=256 H=12", 4, 256, 256, 12, 12, 128, None, 0),
            ("rows without a key: window past the keys", 1, 64, 128, 4, 2, 64, 32, 100),
            ("rows without a key: negative offset", 1, 64, 64, 4, 2, 64, None, -3)):
        q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").bfloat16()
        kw = dict(causal=True, window=window, q_offset=q_offset)
        out = flash_attention_fwd(q, k, v, **kw)
        ref = flash_attention_plain(q, k, v, **kw)
        atol = 2 ** -6 * ref.float().abs().median().item()  # as above
        err = check_close(f"flash_attention {name}", out, ref, rtol=2 ** -7, atol=atol)
        rec[name] = dict(max_abs_err=err)
        vis = block_mask(q_offset + torch.arange(Sq, device="cuda"),
                         torch.arange(Skv, device="cuda"), True, window)
        blind = ~vis.any(dim=1)
        if name.startswith("rows without"):
            if not (blind.any() and bool((out[:, blind] == 0).all())
                    and bool((ref[:, blind] == 0).all())):
                raise AssertionError(f"flash_attention {name}: rows without a key are not 0")
            continue
        b_ms, b_by = bound(2 * q.numel() * 2 + 2 * k.numel() * 2,
                           4 * hd * B * H * int(vis.sum()), "bf16")
        ms = timer(lambda: flash_attention_fwd(q, k, v, **kw))
        qt = q.transpose(1, 2).contiguous()
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_ms = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        log(f"  flash_attention {name}: ms={ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
            f"library_ms(sdpa)={lib_ms:.4f}")
    main = rec[cases[0][0]]
    main["max_abs_err"] = max(r["max_abs_err"] for r in rec.values())
    return main


def codec_cases(torch, timer, gen, codec, rows, later=False):
    """``lowrank_encode`` and ``lowrank_decode`` of bf16 rows through the
    bf16 copy of ``codec`` at ``rows`` rows each, against their plain
    versions, each shape launched twice for the same bits; the kernel's
    time, the plain version's, the bound and ``torch.matmul``'s (with
    ``later`` their device times queued); returns the records at
    ``rows[0]``."""
    from repro_torch.kernels.lowrank import lowrank_decode, lowrank_encode, lowrank_project_plain

    enc, dec = codec["enc"].bfloat16(), codec["dec"].bfloat16()
    d, r = enc.shape
    rec = {}
    for T in rows:
        x = torch.randn(T, d, generator=gen, device="cuda").bfloat16()
        z = lowrank_encode(x, enc)
        for name, fn, a, w in (("lowrank_encode", lowrank_encode, x, enc),
                               ("lowrank_decode", lowrank_decode, z, dec)):
            out = fn(a, w)
            ref = lowrank_project_plain(a, w)
            # f32 sums in another order, rounded once to bf16: one ulp (rtol),
            # and four ulps of the median |output| for elements near zero
            atol = 2 ** -6 * ref.float().abs().median().item()
            err = check_close(f"{name} T={T} d={d} r={r}", out, ref, rtol=2 ** -7, atol=atol)
            if not torch.equal(fn(a, w), out):
                raise AssertionError(f"{name} T={T}: two launches on the same inputs differ")
            nt, k = a.shape
            n = w.shape[1]
            b_ms, b_by = bound((nt * k + k * n + nt * n) * 2, 2 * nt * k * n, "bf16")
            call = functools.partial(fn, a, w)
            lib = functools.partial(torch.matmul, a, w)
            ms = timer(call)
            plain_ms = timer(lambda: lowrank_project_plain(a, w))
            lib_ms = timer(lib)
            if later:
                timer.later(f"{name} T={T} d={d} r={r}", call, functools.partial(
                    lambda lib: f"torch.matmul {timer.device_us(lib)[0]:.3f}", lib))
            log(f"  {name} T={T} d={d}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
                f"({b_by}) library_ms(matmul)={lib_ms:.4f} deterministic")
            if T == rows[0]:
                rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms)
    return rec


def run_lowrank(torch, timer):
    from repro_torch.core.compression import init_lowrank_1d
    from repro_torch.kernels.lowrank import lowrank_roundtrip, lowrank_roundtrip_plain

    gen = torch.Generator(device="cuda").manual_seed(4)
    d, r = 768, 384
    codec = init_lowrank_1d(torch.Generator().manual_seed(7), d, r, device="cuda")

    # encode and decode at the one-shot pipeline's boundary (T = 1024), bf16
    # operands (the consumer casts the codec to the activation type),
    # and at the streaming engine's decode group step (4 rows) and prefill
    # chunk (32 rows)
    rec = codec_cases(torch, timer, gen, codec, (1024, 4, 32))
    # the roundtrip's contract form (Z in f32, the error from the unrounded
    # X^: the roundtrip kernel's f32 form on f32 copies) at a ragged T, in
    # f32 and in bf16, error sum included (timed in run_roundtrip)
    T = 1000
    x32 = torch.randn(T, d, generator=gen, device="cuda")
    for dt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        xx, e, dd = x32.to(dt), codec["enc"].to(dt), codec["dec"].to(dt)
        x_hat, err_sum = lowrank_roundtrip(xx, e, dd)
        ref_hat, ref_err = lowrank_roundtrip_plain(xx, e, dd)
        if dt == torch.float32:  # f32 sums in another order
            check_close(f"lowrank_roundtrip {kind} x_hat", x_hat, ref_hat, rtol=1e-5,
                        atol=1e-5 * ref_hat.abs().max().item())
        else:  # one bf16 ulp, as above
            check_close(f"lowrank_roundtrip {kind} x_hat", x_hat, ref_hat, rtol=2 ** -7,
                        atol=2 ** -6 * ref_hat.float().abs().median().item())
        # a sum of T*d f32 squares in another (fixed) order
        check_close(f"lowrank_roundtrip {kind} error sum", err_sum, ref_err, rtol=1e-5, atol=0)
        again_hat, again_err = lowrank_roundtrip(xx, e, dd)
        if not (torch.equal(again_hat, x_hat) and torch.equal(again_err, err_sum)):
            raise AssertionError("lowrank_roundtrip: two runs on the same inputs differ")
    return rec


# the MoE dispatch codec's roundtrip: the rows it carries (one token, the
# streaming decode group, the serving decode step, a prefill chunk, a
# ragged batch, the pipeline's [4, 256]) and the ranks (6 and 8 column
# tiles a cluster; 100 takes the scalar loads)
ROUNDTRIP_ROWS = (1, 4, 8, 32, 1000, 1024)
ROUNDTRIP_RANKS = (384, 512, 100)


def roundtrip_bound(T: int, d: int, r: int, kind: str):
    """X read and X̂ written once, E and D read once, the two sums written;
    two products of 2·T·d·r flops (the error's 3·T·d beside them)."""
    item = 2 if kind == "bf16" else 4
    return bound((2 * T * d + 2 * d * r) * item + 8, 4 * T * d * r + 3 * T * d, kind)


def run_roundtrip(torch, timer):
    """The MoE dispatch codec's fused roundtrip (``lowrank_roundtrip_loss``:
    X̂ = T(T(X·E)·D), Σ(X − X̂)² and its mean, the consumer's roundings) at
    ``ROUNDTRIP_ROWS`` x ``ROUNDTRIP_RANKS`` (d = 768), bf16 and f32,
    against its plain version: X̂ within one rounding (f32 1e-5; bf16 2^-7
    plus 2^-7 max|X̂|); the error sum against the plain sum over the
    kernel's own X̂ at rtol 1e-5 (the reduction) and against the plain
    version's at rtol 1e-5 in f32 and 1e-3 in bf16 (a few X̂ values one
    ulp apart move it); the mean the sum over T·d.  100 launches at T = 4
    give the same bits.  Timed at rank 384 in bf16 at the serving decode
    step (8 rows), a ragged 1000 and the pipeline's 1024, beside the plain
    version and the two-``torch.matmul`` yardstick (``library_ms`` stays
    null: no single call returns X̂ and the error); the contract form
    (``lowrank_roundtrip``: Z in f32, its error from the unrounded X̂) at
    1000 rows beside them.  Returns the record at 8 rows."""
    from repro_torch.core.compression import init_lowrank_1d
    from repro_torch.kernels.lowrank import (
        lowrank_roundtrip,
        lowrank_roundtrip_loss,
        lowrank_roundtrip_loss_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    d = 768
    rec, worst = {}, {}
    for r in ROUNDTRIP_RANKS:
        codec = init_lowrank_1d(torch.Generator().manual_seed(7), d, r, device="cuda")
        for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            enc, dec = codec["enc"].to(dt), codec["dec"].to(dt)
            errs = []
            for T in ROUNDTRIP_ROWS:
                x = torch.randn(T, d, generator=gen, device="cuda").to(dt)
                xh, sq, mean = lowrank_roundtrip_loss(x, enc, dec)
                ph, psq, _ = lowrank_roundtrip_loss_plain(x, enc, dec)
                what = f"lowrank_roundtrip_loss {kind} T={T} r={r}"
                if kind == "f32":
                    errs.append(check_close(f"{what} x_hat", xh, ph, rtol=1e-5, atol=1e-5,
                                            quiet=True))
                else:
                    errs.append(check_close(f"{what} x_hat", xh, ph, rtol=2 ** -7,
                                            atol=2 ** -7 * ph.float().abs().max().item(),
                                            quiet=True))
                own = (x.float() - xh.float()).square().sum()
                check_close(f"{what} error sum (its own x_hat)", sq, own, rtol=1e-5, atol=0,
                            quiet=True)
                check_close(f"{what} error sum (the plain version's)", sq, psq,
                            rtol=1e-5 if kind == "f32" else 1e-3, atol=0, quiet=True)
                check_close(f"{what} mean", mean, sq / (T * d), rtol=1e-6, atol=0, quiet=True)
                if T == 4:  # the streaming decode group, relaunched
                    for _ in range(100):
                        again = lowrank_roundtrip_loss(x, enc, dec)
                        if not all(torch.equal(a, b) for a, b in zip(again, (xh, sq, mean))):
                            raise AssertionError(f"{what}: a relaunch differs")
            worst[(kind, r)] = max(errs)
            log(f"  lowrank_roundtrip_loss {kind} r={r}: T in {ROUNDTRIP_ROWS} ok, max_abs_err "
                f"of x_hat {max(errs):.3e}; the error sums and means within their tolerances; "
                f"100 launches at T=4 equal")
    enc, dec = (init_lowrank_1d(torch.Generator().manual_seed(7), d, 384, device="cuda")[k]
                .bfloat16() for k in ("enc", "dec"))
    for T in (8, 1000, 1024):
        x = torch.randn(T, d, generator=gen, device="cuda").bfloat16()
        call = functools.partial(lowrank_roundtrip_loss, x, enc, dec)
        plain = functools.partial(lowrank_roundtrip_loss_plain, x, enc, dec)
        pair = lambda x=x: torch.matmul(torch.matmul(x, enc), dec)  # noqa: E731
        b_ms, b_by = roundtrip_bound(T, d, 384, "bf16")
        ms, plain_ms, pair_ms = timer(call), timer(plain), timer(pair)
        extra = ""
        if T == 1000:
            contract = functools.partial(lowrank_roundtrip, x, enc, dec)
            extra = f" contract_form_ms(lowrank_roundtrip)={timer(contract):.4f}"
        log(f"  lowrank_roundtrip_loss bf16 T={T} r=384: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.6f} ({b_by}) matmul_pair_ms={pair_ms:.4f} library_ms=null (no "
            f"single call returns X^ and the error){extra}")
        timer.later(f"lowrank_roundtrip_loss T={T} r=384", call, functools.partial(
            lambda pair: f"torch.matmul pair {timer.device_us(pair)[0]:.3f}", pair))
        if T == 8:
            rec["lowrank_roundtrip_loss"] = dict(
                max_abs_err=worst[("bf16", 384)], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
    return rec


# the slab store's batches of column quantizations: one slab (a prefetch)
# and the int8 pool run's initial fill (its 3 target slabs)
SLAB_OUTER = (1, 3)


def run_quant(torch, timer):
    """The row quantizer at the int8 streams' row shapes: KV tokens (4 and
    32 rows of 768, bf16, f16 scales) and a raw boundary (4 and 32 rows of
    384); the column quantizer on one expert slab's wi [768, 3072] and wo
    [3072, 768] (f32, f32 scales) and on the pool's initial fill of
    ``SLAB_OUTER`` slabs, its cluster plan logged.  Codes and scales equal
    the plain version's bit for bit (the tokens downstream depend on them),
    an all-zero line and a row so small that its f16 scale underflows to 0
    included.  Then the dequantizer on the boundary's codes and on a ragged
    width, bit for bit.  No single PyTorch call computes either function
    (the scale of each line, rounded to its type, then the codes;
    ``torch.quantize_per_channel`` takes the scales as given), so
    ``library_ms`` is null.  Returns the records of the slab ``wo`` column
    quantization (what the int8 pool run launches) and of the boundary
    dequantization."""
    from repro_torch.kernels.quant import (
        cols_plan,
        dequantize_rows,
        dequantize_rows_plain,
        quantize_rows,
        quantize_rows_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(6)
    f16, bf16, f32 = torch.float16, torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [  # (name, shape, input type, scale type, axis)
        ("kv decode 4x768", (4, 768), bf16, f16, -1),
        ("kv chunk 32x768", (32, 768), bf16, f16, -1),
        ("boundary decode 4x384", (4, 384), bf16, f16, -1),
        ("boundary chunk 32x384", (32, 384), bf16, f16, -1),
        ("boundary ragged 4x100", (4, 100), bf16, f16, -1),
        *((f"slab {m} {'x'.join(map(str, shape))} columns outer={o}", (o, *shape), f32, f32, -2)
          for o in SLAB_OUTER for m, shape in (("wi", (768, 3072)), ("wo", (3072, 768)))),
    ]
    rec, codes = {}, {}
    for name, shape, dt, sdt, axis in cases:
        scale = 0.02 if axis == -2 else 3.0
        x = (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dt)
        if axis == -1:
            x[0] = 0
            x[1] = (torch.randn(shape[1], generator=gen, device="cuda") * 1e-7).to(dt)
        else:
            x[0, :, 3] = 0
        kw = dict(scale_dtype=sdt, axis=axis)
        q, sc = quantize_rows(x, **kw)
        rq, rsc = quantize_rows_plain(x, **kw)
        same = torch.equal(q, rq) and torch.equal(sc, rsc)
        again = quantize_rows(x, **kw)
        same_again = torch.equal(again[0], q) and torch.equal(again[1], sc)
        under = int((sc == 0).sum())
        plan = (f"; cluster, staged = {cols_plan(shape[0], shape[1], shape[2], 4, sms)}"
                if axis == -2 else "")
        log(f"  quantize_rows {name}: codes and scales equal the plain version's: {same}, "
            f"a second launch's: {same_again} ({under} scales underflowed to 0){plan}")
        if not (same and same_again):
            raise AssertionError(f"quantize_rows {name}: codes or scales differ")
        if axis == -1 and under != 2:  # the floor 1e-8 is 0 in f16
            raise AssertionError(f"quantize_rows {name}: the zero and tiny rows' f16 "
                                 "scales are not 0")
        codes[name] = (q, sc)
        n = x.numel()
        b_ms, b_by = bound(n * x.element_size() + n + sc.numel() * sc.element_size(),
                           3 * n, "f32")
        call = functools.partial(quantize_rows, x, **kw)
        ms = timer(call)
        plain_ms = timer(lambda: quantize_rows_plain(x, **kw))
        timer.later(f"quantize_rows {name}", call)
        log(f"  quantize_rows {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.6f} ({b_by}) library_ms=null")
        rec[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    out = {"quantize_rows": rec["slab wo 3072x768 columns outer=1"]}
    for name in ("boundary decode 4x384", "boundary chunk 32x384", "boundary ragged 4x100"):
        q, sc = codes[name]
        y = dequantize_rows(q, sc, dtype=bf16)
        same = torch.equal(y, dequantize_rows_plain(q, sc, dtype=bf16))
        log(f"  dequantize_rows {name}: equal to the plain version: {same}")
        if not same:
            raise AssertionError(f"dequantize_rows {name}: values differ")
        n = q.numel()
        b_ms, b_by = bound(n + sc.numel() * 2 + n * 2, n, "f32")
        call = functools.partial(dequantize_rows, q, sc, dtype=bf16)
        ms = timer(call)
        plain_ms = timer(lambda: dequantize_rows_plain(q, sc, dtype=bf16))
        timer.later(f"dequantize_rows {name}", call)
        log(f"  dequantize_rows {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.6f} ({b_by}) library_ms=null")
        out.setdefault("dequantize_rows", dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                               bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return out


# the fused boundary forms: token rows (a decode step of 1 slot and of the
# stream's 4-slot group, a 32-token chunk, 4 slots of a 32-token chunk,
# the pipeline's batch) and ranks (the stream's 384; 512, a cluster of 8;
# 100, the scalar path: k or n not a multiple of 8)
CODEC_QUANT_ROWS = (1, 4, 32, 128, 1024)
CODEC_QUANT_RANKS = (384, 512, 100)


def run_codec_quant(torch, timer, d=768, ranks=CODEC_QUANT_RANKS, rows=CODEC_QUANT_ROWS,
                    timed=(4, 32, 128)):
    """The int8 boundary folded into the codec: ``lowrank_encode_quant``
    and ``lowrank_decode_quant`` at ``rows`` x ``ranks`` (d_model ``d``;
    ``CODEC_QUANT_ROWS`` x ``CODEC_QUANT_RANKS`` at 768), bf16 and f32, an all-zero row and one
    whose f16 scale underflows to 0 included: codes, scales and x^
    bit-equal to the composed kernels (``lowrank_encode`` then
    ``quantize_rows``, ``dequantize_rows`` then ``lowrank_decode``), a
    second launch equal; the codes within one step (plus the codec's one
    ulp) of the plain Z and x^ within the codec's tolerance of the plain
    composition on the same codes.  Timed at rank 384 in bf16 and ``timed``
    rows, beside the plain composition and the composed kernels; the
    library yardstick is ``torch.matmul`` on the product alone (no single
    call also quantizes).  Returns the records at the stream's decode
    group (4 rows)."""
    from repro_torch.core.compression import init_lowrank_1d
    from repro_torch.kernels.lowrank import (
        lowrank_decode,
        lowrank_decode_quant,
        lowrank_decode_quant_plain,
        lowrank_encode,
        lowrank_encode_quant,
        lowrank_encode_quant_plain,
        lowrank_project_plain,
    )
    from repro_torch.kernels.quant import dequantize_rows, quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(9)
    f16 = torch.float16
    rec = {}
    for r in ranks:
        codec = init_lowrank_1d(torch.Generator().manual_seed(7), d, r, device="cuda")
        for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            enc, dec = codec["enc"].to(dt), codec["dec"].to(dt)
            for T in rows:
                x = torch.randn(T, d, generator=gen, device="cuda") * 3
                x[0] = 0
                if T > 1:
                    x[1] *= 1e-7
                x = x.to(dt)
                q, s = lowrank_encode_quant(x, enc)
                xh = lowrank_decode_quant(q, s, dec)
                cq, cs = quantize_rows(lowrank_encode(x, enc), scale_dtype=f16)
                cxh = lowrank_decode(dequantize_rows(q, s, dtype=dt), dec)
                again = (*lowrank_encode_quant(x, enc), lowrank_decode_quant(q, s, dec))
                equal = torch.equal(q, cq) and torch.equal(s, cs) and torch.equal(xh, cxh)
                same = all(torch.equal(a, b) for a, b in zip(again, (q, s, xh)))
                under = int((s == 0).sum())
                # the plain composition: Z from f32 sums in another order
                # (one ulp in bf16: a code may sit one step off), x^ of the
                # same codes within the codec's tolerance
                z = lowrank_project_plain(x, enc).float()
                step = s.float()
                near = (q.float() * step - z).abs() <= 1.5 * step + 2 ** -7 * z.abs()
                codes_ok = bool(near[s[:, 0] > 0].all())
                what = f"codec quant {kind} T={T} d={d} r={r}"
                log(f"  {what}: codes, scales and x^ equal the composed kernels': {equal}; "
                    f"a second launch's: {same}; codes within a step of the plain Z: "
                    f"{codes_ok} ({under} scales underflowed to 0)")
                if not (equal and same and codes_ok) or under != min(T, 2):
                    raise AssertionError(f"{what}: the fused forms disagree")
                pq, ps = lowrank_encode_quant_plain(x, enc)
                enc_err = (q.float() * s.float() - pq.float() * ps.float()).abs().max().item()
                log(f"  {what} dequantized codes against the plain version's: max_abs_err="
                    f"{enc_err:.3e} (a step where Z moved an ulp)")
                ref = lowrank_decode_quant_plain(q, s, dec)
                if dt == torch.float32:
                    err = check_close(f"{what} x^", xh, ref, rtol=1e-5,
                                      atol=1e-5 * ref.abs().max().item())
                else:
                    err = check_close(f"{what} x^", xh, ref, rtol=2 ** -7,
                                      atol=2 ** -6 * ref.float().abs().median().item())
                if r != 384 or kind != "bf16" or T not in timed:
                    continue
                for name, call, plain, composed, lib, nbytes in (
                        ("lowrank_encode_quant", functools.partial(lowrank_encode_quant, x, enc),
                         functools.partial(lowrank_encode_quant_plain, x, enc),
                         lambda x=x, enc=enc: quantize_rows(lowrank_encode(x, enc),
                                                            scale_dtype=f16),
                         functools.partial(torch.matmul, x, enc),
                         T * d * 2 + d * r * 2 + T * r + T * 2),
                        ("lowrank_decode_quant", functools.partial(lowrank_decode_quant, q, s, dec),
                         functools.partial(lowrank_decode_quant_plain, q, s, dec),
                         lambda q=q, s=s, dec=dec, dt=dt: lowrank_decode(
                             dequantize_rows(q, s, dtype=dt), dec),
                         functools.partial(torch.matmul, cq.to(dt), dec),
                         T * r + T * 2 + r * d * 2 + T * d * 2)):
                    b_ms, b_by = bound(nbytes, 2 * T * d * r, "bf16")
                    ms = timer(call)
                    plain_ms = timer(plain)
                    comp_ms = timer(composed)
                    lib_ms = timer(lib)
                    timer.later(f"{name} T={T} d={d} r={r}", call, functools.partial(
                        lambda composed, lib: (
                            f"the composed kernels {timer.device_us(composed)[0]:.3f}, "
                            f"torch.matmul (the product alone) {timer.device_us(lib)[0]:.3f}"),
                        composed, lib))
                    log(f"  {name} T={T} d={d} r={r}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                        f"composed_ms={comp_ms:.4f} bound_ms={b_ms:.6f} ({b_by}) "
                        f"library_ms(matmul, the product alone)={lib_ms:.4f}")
                    if T == 4:
                        rec[name] = dict(max_abs_err=err if name == "lowrank_decode_quant"
                                         else enc_err, ms=ms, plain_ms=plain_ms,
                                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return rec


# the int8 KV pools' layer writes at the streaming engine's shapes (12 kv
# heads of 64, 16-token pages, 16-page rings, 128 pages): (name, B, C,
# valid rows per slot or None for a ring write, positions of row 0); a
# decode group with one slot past a ring wrap, prefill chunks with padding
KV_WRITE_CASES = (
    ("decode B=4 C=1", 4, 1, None, (37, 118, 199, 300)),
    ("chunk B=2 C=16", 2, 16, (16, 9), (0, 240)),
    ("chunk B=1 C=32", 1, 32, (25,), (96,)),
)


def run_kv_write(torch, timer, heads=(12, 64)):
    """The int8 KV pools' quantize-and-write (``paged_write_quant``) against
    its plain version (the writers' old body: two token quantizations, the
    slot arithmetic, four scatters) at ``KV_WRITE_CASES`` with ``heads`` =
    (kv heads, head dim), into pools that
    are views of a block-stacked leaf holding random codes: codes and scales
    bit-equal outside the garbage row (padding rows all land there, in
    either order), also from a second launch, one launch counted a call; an
    all-zero token and one whose f16 scale underflows to 0 included."""
    from repro_torch.kernels.quant import paged_write_quant
    from repro_torch.models.kvcache import paged_write_quant_plain

    gen = torch.Generator(device="cuda").manual_seed(8)
    (KV, hd), P, ps, pps, R = heads, 128, 16, 16, 6
    n = KV * hd
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(8)).int()
    rec = {}
    for name, B, C, n_valid, starts in KV_WRITE_CASES:
        leaf = torch.randint(-127, 128, (2, R, P + 1, ps, KV, hd), generator=gen,
                             device="cuda", dtype=torch.int8)
        sleaf = torch.rand(2, R, P + 1, ps, generator=gen, device="cuda").half()
        table = perm[:B * pps].view(B, pps).cuda()
        k, v = (torch.randn(B, C, KV, hd, generator=gen, device="cuda").bfloat16() * 3
                for _ in range(2))
        k[0, 0] = 0
        v[-1, 0 if n_valid is None else n_valid[-1] - 1] *= 1e-7
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        if n_valid is None:
            args, valid = (k, v, table, start, ps), None
        else:
            pos = (start[:, None] + torch.arange(C, device="cuda")[None]).int()
            rows = torch.tensor(n_valid, device="cuda")[:, None]
            valid = torch.arange(C, device="cuda")[None] < rows
            args = (k, v, table, pos, ps, valid)

        def fresh():
            """A copy of the leaves, and the pools as views of their block 2."""
            lc, sc = leaf.clone(), sleaf.clone()
            return lc, sc, (lc[0, 2], lc[1, 2], sc[0, 2], sc[1, 2])

        want_l, want_s, pools = fresh()
        paged_write_quant_plain(*pools, *args)
        runs = []
        for _ in range(2):
            lc, sc, pools = fresh()
            before = paged_write_quant.launches
            paged_write_quant(*pools, *args)
            if paged_write_quant.launches != before + 1:
                raise AssertionError("paged_write_quant: a call did not count one launch")
            # the garbage row of the written block takes one of several writes
            lc[:, 2, P], sc[:, 2, P] = want_l[:, 2, P], want_s[:, 2, P]
            runs.append((lc, sc))
        same = torch.equal(runs[0][0], want_l) and torch.equal(runs[0][1], want_s)
        again = torch.equal(runs[1][0], runs[0][0]) and torch.equal(runs[1][1], runs[0][1])
        # the zero k token (row 0) and the tiny v token (the last valid row)
        # store f16 scale 0
        pos2 = start[:, None] if n_valid is None else pos
        phys = table.long().gather(1, (pos2.long() // ps) % pps)
        last = 0 if n_valid is None else n_valid[-1] - 1
        under = (want_s[0, 2][phys[0, 0], pos2[0, 0] % ps].item(),
                 want_s[1, 2][phys[-1, last], pos2[-1, last] % ps].item())
        what = f"paged_write_quant {name} KV={KV} hd={hd}"
        log(f"  {what}: codes and scales equal the plain version's outside the garbage row: "
            f"{same}; second launch equal: {again}; the zero and tiny tokens' scales {under}")
        if not (same and again):
            raise AssertionError(f"{what}: codes or scales differ")
        if under != (0.0, 0.0):
            raise AssertionError(f"{what}: the zero and tiny tokens' f16 scales are not 0")
        tokens = B * C
        # k and v read, codes and f16 scales written, each token's position
        # (and valid flag) read, and the distinct page-table entries that
        # the valid tokens land on
        entry = torch.arange(B, device="cuda")[:, None] * pps + (pos2.long() // ps) % pps
        entries = torch.unique(entry if valid is None else entry[valid]).numel()
        nbytes = (2 * tokens * n * 2 + 2 * tokens * n + 2 * tokens * 2 + entries * 4
                  + tokens * 4 + (tokens if valid is not None else 0))
        b_ms, b_by = bound(nbytes, 3 * 2 * tokens * n, "f32")
        dst = (leaf[0, 2], leaf[1, 2], sleaf[0, 2], sleaf[1, 2])
        call = functools.partial(paged_write_quant, *dst, *args)
        ms = timer(call)
        plain_ms = timer(lambda: paged_write_quant_plain(*dst, *args))
        timer.later(what, call)
        log(f"  {what}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.6f} ({b_by}) library_ms=null")
        rec[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    return rec[KV_WRITE_CASES[0][0]]


def run_expert_mlp_resident_quant(torch, timer):
    """The end tier's resident expert FFN over the int8 slab store of
    full-width switch-base (the f32 store of phase 6's check, quantized per
    output column), bf16 rows at ``RESIDENT_QUANT_CASES``; garbage-slot rows
    exactly 0."""
    from repro_torch.kernels.expert_mlp import (
        grouped_mlp_resident_quant,
        grouped_mlp_resident_quant_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    p, cfg = switch_base_moe(gen)
    store = resident_store(torch, p, quant=True)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    scales = dict(wi_scale=store["wi_scale"], wg_scale=None, wo_scale=store["wo_scale"])
    rec = {}
    for name, _, sizes, ids in RESIDENT_QUANT_CASES:
        n = sum(sizes)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        idt = torch.tensor(ids, dtype=torch.int32, device="cuda")
        xs = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
        args = (xs, gs, store["wi"], None, store["wo"], idt, cfg.act)
        y = grouped_mlp_resident_quant(*args, **scales)
        ref = grouped_mlp_resident_quant_plain(*args, **scales)
        # the kernel keeps the hidden activation in f32 where the plain
        # version (as ragged_dot) rounds it to bf16: a few bf16 ulps of |y|
        tol = 2e-2 * ref.float().abs().max().item()
        err = check_close(f"expert_mlp_resident_quant {name}", y, ref, rtol=0, atol=tol)
        if not bool((y[n - sizes[-1]:] == 0).all()):
            raise AssertionError(f"expert_mlp_resident_quant {name}: garbage-slot rows are not 0")
        if not torch.equal(grouped_mlp_resident_quant(*args, **scales), y):
            raise AssertionError(f"expert_mlp_resident_quant {name}: two launches differ")
        routed = sum(1 for s in sizes[:-1] if s)
        nbytes = (2 * n * d * 2 + routed * (2 * d * f + (f + d) * 4)
                  + 2 * len(sizes) * 4)
        b_ms, b_by = bound(nbytes, 2 * 2 * (n - sizes[-1]) * d * f, "bf16")
        call = functools.partial(grouped_mlp_resident_quant, *args, **scales)
        ms = timer(call)
        plain_ms = timer(lambda: grouped_mlp_resident_quant_plain(*args, **scales))
        timer.later(f"expert_mlp_resident_quant {name}", call)
        log(f"  expert_mlp_resident_quant {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) library_ms=null routed_slots={routed}; "
            f"deterministic")
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    main = rec["decode n=4"]
    main["max_abs_err"] = max(r["max_abs_err"] for r in rec.values())
    return main


# ---------------------------------------------------------------------------
# Phase 3-4: serve full-width switch-base, and hold it against the CPU
# ---------------------------------------------------------------------------


def serve(torch, counters, cfg=None, profile_name="decode_profile.txt"):
    """Phase 3 on full-width switch-base (``cfg``: its config with a
    dispatch codec, for the codec's serving run); returns the run's launch
    counts and the engine."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, leaves
    from repro_torch.serving import Request, ServingEngine

    cfg = cfg or get_config("switch-base")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(model, params, max_batch=8, max_len=256, page_size=16,
                        prefill_chunk=32)
    del params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(eng.params))
    log(f"switch-base: {n_params / 1e6:.1f} M params, built in "
        f"{time.perf_counter() - t0:.2f} s; {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts in {cfg.moe.num_groups} groups")

    rng = np.random.default_rng(0)
    prompt_lens = [16, 40, 77, 100, 128, 150, 181, 200]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=32) for i, n in enumerate(prompt_lens)]

    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    for r in reqs:
        eng.submit(r)
    step_s = []
    t_run = time.perf_counter()
    while eng.busy():
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    run_s = time.perf_counter() - t_run
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    log(f"serving launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was never launched on the serving path")
    bad = [r.request_id for r in reqs if not r.done or len(r.generated) != 32]
    if bad:
        raise AssertionError(f"requests {bad} did not finish with 32 tokens")
    if eng.pool.pages_in_use != 0:
        raise AssertionError(f"{eng.pool.pages_in_use} KV pages still mapped after the run")
    n_tok = sum(len(r.generated) for r in reqs)
    decode_steps = sorted(step_s[1:])
    log(f"first step (8 chunked prefills + 1 decode): {step_s[0] * 1e3:.3f} ms")
    log(f"decode step: median {decode_steps[len(decode_steps) // 2] * 1e3:.3f} ms, "
        f"min {decode_steps[0] * 1e3:.3f} ms, max {decode_steps[-1] * 1e3:.3f} ms "
        f"over {len(decode_steps)} steps (host clock, synchronized)")
    log(f"tokens/s: {n_tok / run_s:.1f} ({n_tok} tokens in {run_s:.3f} s, 8 requests)")
    log(f"peak device memory: {peak / 2**20:.1f} MiB")

    # per-step launches and the prefill-chunk time, on a fresh slot
    for c in counters:
        c.launches = 0
    eng.pool.reserve(0, 2)
    eng.pool.map_range(0, 0, 32)
    table = eng.pool.device_rows([0], device="cuda")
    chunk = torch.randint(0, cfg.vocab_size, (1, 32), device="cuda", dtype=torch.int32)
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    n_valid = torch.full((1,), 32, dtype=torch.int32, device="cuda")

    def prefill():
        return model.prefill_chunk_step(eng.params, chunk, eng.pages, table, start,
                                        n_valid, page_size=16)

    prefill()
    per_chunk = {c.__name__: c.launches for c in counters}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        prefill()
    ev[1].record()
    torch.cuda.synchronize()
    log(f"prefill chunk (C=32, B=1): {ev[0].elapsed_time(ev[1]) / 10:.3f} ms (device events); "
        f"launches per chunk {per_chunk}")
    eng.pool.free(0)

    # decode-step launches, and a profile of one decode step with 8 live
    # slots (the run's prompt lengths again)
    for c in counters:
        c.launches = 0
    for i, n in enumerate(prompt_lens):
        eng.submit(Request(90 + i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                           max_new_tokens=8))
    eng.step()  # admission + decode
    for c in counters:
        c.launches = 0
    eng.step()
    log(f"launches per decode step: {({c.__name__: c.launches for c in counters})}")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    avgs = prof.key_averages()
    dev = [e for e in avgs if e.device_type != DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in dev)
    (OUT_DIR / profile_name).write_text(
        avgs.table(sort_by="cuda_time_total", row_limit=40))
    in_path = kernels_in_path(dev, (*PAGED_KERNELS, *ffn_kernels("expert FFN", "__nv_bfloat16"),
                                    *GATE_KERNELS, *ROUNDTRIP_KERNELS))
    log(f"decode profile (1 step, 8 slots decoding): device time "
        f"{dev_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall; kernels in path, a launch: "
        f"{in_path}; written to chiprun_out/{profile_name}")
    eng.run()
    return launches, eng


def reference_check(torch, eng, cfg=None, params=None, rel_tol=0.1, cos_tol=0.99):
    """Prefill chunk + one decode step of a 16-token prompt, on the card
    (kernels) and on the CPU (plain versions), same weights: the engine's
    (bf16 activations through 12 layers, summed in other orders: max|diff|
    within ``rel_tol`` of max|cpu|, cosine at least ``cos_tol``), or
    ``cfg`` and ``params`` with tolerances of their own."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import Model, to_device

    cfg = cfg or eng.model.cfg
    params = eng.params if params is None else params
    prompt = torch.arange(100, 116, dtype=torch.int32)
    chunk = torch.zeros(1, 32, dtype=torch.int32)
    chunk[0, :16] = prompt
    out = {}
    for dev, params in (("cuda", params), ("cpu", to_device(params, "cpu"))):
        model = Model(cfg, device=dev)
        pool = kvcache.PagePool(4, 16, 4, n_slots=1)
        pool.reserve(0, 4)
        pool.map_range(0, 0, 17)
        pages = kvcache.init_paged_blocks(cfg, cfg.block_repeat, 4, 16, cfg.torch_dtype, dev)
        table = pool.device_rows([0], device=dev)
        ints = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        lg1, pages = model.prefill_chunk_step(params, chunk.to(dev), pages, table,
                                              ints([0]), ints([16]), page_size=16)
        tok = lg1.argmax(-1).int()[:, None]
        lg2, _ = model.decode_step_paged(params, tok, pages, table, ints([16]), page_size=16)
        V = cfg.vocab_size  # the padded tail is -1e30 on both sides
        out[dev] = (lg1[:, :V].float().cpu(), lg2[:, :V].float().cpu(), tok.cpu())
    for i, name in enumerate(("prefill-chunk logits", "decode logits")):
        g, c = out["cuda"][i], out["cpu"][i]
        rel = ((g - c).abs().max() / c.abs().max()).item()
        cos = torch.nn.functional.cosine_similarity(g, c, dim=-1).min().item()
        same = bool((g.argmax(-1) == c.argmax(-1)).all())
        log(f"  {name}: card vs CPU max|diff|/max|cpu|={rel:.3e} cos={cos:.6f} "
            f"argmax equal={same} finite={bool(torch.isfinite(g).all())}")
        if not (torch.isfinite(g).all() and rel <= rel_tol and cos >= cos_tol):
            raise AssertionError(f"{name}: the card disagrees with the CPU reference")
    if not torch.equal(out["cuda"][2], out["cpu"][2]):
        log("  note: first generated token differs between card and CPU")


# ---------------------------------------------------------------------------
# Phase 5: the one-shot two-tier pipeline, and hold it against the CPU
# ---------------------------------------------------------------------------


def traced_run(torch, pipe, tokens, feed=None):
    """``run_batch`` with every layer's input and output and every MoE
    layer's gate recorded on the host: (logits, metrics, {"in", "out":
    [layers, B, S, d]; "idx": [MoE layers, tokens, top_k]; "margin":
    [MoE layers, tokens], the gap between the two most probable experts}).
    With ``feed`` (the layer inputs of another run) each layer takes that
    run's input in place of its predecessor's output, so every layer is
    held alone on the same input."""
    from repro_torch.core import gating
    from repro_torch.models import transformer

    gate, layer = gating.gate, transformer.apply_layer_full
    rec = {"in": [], "out": [], "idx": [], "margin": []}

    def gate_rec(*args, **kw):
        out = gate(*args, **kw)
        top2 = out.probs.float().topk(2, dim=-1).values
        rec["idx"].append(out.topk_idx.cpu())
        rec["margin"].append((top2[:, 0] - top2[:, 1]).cpu())
        return out

    def layer_rec(p, x, *args, **kw):
        if feed is not None:
            x = feed[len(rec["in"])].to(x.device)
        rec["in"].append(x.cpu())
        y, aux, entry = layer(p, x, *args, **kw)
        rec["out"].append(y.float().cpu())
        return y, aux, entry

    gating.gate, transformer.apply_layer_full = gate_rec, layer_rec
    try:
        logits, metrics = pipe.run_batch(tokens)
    finally:
        gating.gate, transformer.apply_layer_full = gate, layer
    return logits, metrics, {k: torch.stack(v) for k, v in rec.items()}


# In-path readers: (what, kernel-name substrings of the kernels launched
# once a wrapper call, substrings of the other kernels of that call).
CODEC_KERNELS = (("codec projection", ("project_wgmma_kernel",), ()),)
# the int8 boundary folded into the codec (bf16 and f32 forms)
CODEC_QUANT_KERNELS = (("encode + quantize", ("encode_quant_wgmma_kernel",
                                              "encode_quant_f32_kernel"), ()),
                       ("dequantize + decode", ("decode_quant_wgmma_kernel",
                                                "decode_quant_f32_kernel"), ()))
# paged attention: the CUDA-core or the tensor-core sweep, then (S > 1)
# the merge of the splits
PAGED_KERNELS = (("paged attention", ("paged_attention_kernel<", "paged_attention_mma_kernel<"),
                  ("paged_attention_merge_kernel<",)),)
GATE_KERNELS = (("group gate", ("group_gate_kernel<", "group_gate_wide_kernel<"), ()),)
# the MoE dispatch codec's fused roundtrip (bf16 and f32 forms)
ROUNDTRIP_KERNELS = (("dispatch codec roundtrip", ("roundtrip_wgmma_kernel",
                                                   "roundtrip_f32_kernel"), ()),)


def ffn_kernels(what: str, weights: str):
    """The expert FFN's reader for weights stored as ``weights`` (a CUDA
    type name): the streaming kernel and its reduction, or the two
    tensor-core GEMMs (bf16 rows)."""
    return ((what, (f"expert_ffn_stream_kernel<__nv_bfloat16, {weights},",
                    f"expert_ffn_gemm1_kernel<{weights},"),
             (f"expert_ffn_reduce_kernel<__nv_bfloat16, {weights}>",
              f"expert_ffn_gemm2_kernel<{weights}>")),)


def kernels_in_path(dev, names) -> str:
    """``what ms x n`` for each ``(what, call keys, other keys)`` of
    ``names`` that ran in a profile's kernel rows ``dev``: the device time
    of every kernel matching a key, over the launches of the kernels
    matching a call key (one a wrapper call), so a call's merge or second
    GEMM counts with it."""
    out = []
    for what, calls, others in names:
        n = sum(e.count for e in dev if any(k in e.key for k in calls))
        if n:
            us = sum(e.self_device_time_total for e in dev
                     if any(k in e.key for k in calls + others))
            out.append(f"{what} {us / n / 1e3:.4f} ms x {n}")
    return "; ".join(out)


def logit_gap(torch, g, c, V):
    """(max|g-c| / max|c|, per-token cosine [B, S]) over the real vocabulary
    (the padded tail is -1e30 on both sides)."""
    g, c = g[..., :V].float().cpu(), c[..., :V].float().cpu()
    rel = ((g - c).abs().max() / c.abs().max()).item()
    return rel, torch.nn.functional.cosine_similarity(g, c, dim=-1)


def pipeline(torch, eng, counters):
    from repro_torch.core.hardware import PROFILES
    from repro_torch.serving import EndCloudPipeline

    cfg = eng.model.cfg
    prof = dict(end_profile=PROFILES["jetson-orin"], cloud_profile=PROFILES["a100"])
    pipe = EndCloudPipeline(eng.model, eng.params, compression_rank=384, **prof)
    n_end = int(pipe.end_mask.sum())
    log(f"plan (modeled profiles jetson-orin end, a100 cloud): split {pipe.split} of "
        f"{cfg.block_repeat}, codec {'on' if pipe.tiers.compress else 'off'}, "
        f"{n_end} of {cfg.moe.num_experts} experts on the end tier")
    if (pipe.split, pipe.tiers.compress, n_end) != (1, True, 3):
        raise AssertionError("the plan differs from the reference planner's "
                             "(split 1, codec on, 3 end experts)")
    B, S = 4, 256
    tok = pipeline_tokens(torch, cfg.vocab_size, B, S, 0).cuda()
    pipe.run_batch(tok)  # warm-up

    for c in counters:
        c.launches = 0
    logits, m = pipe.run_batch(tok)
    launches = {c.__name__: c.launches for c in counters}
    log(f"pipeline launches per run_batch: {launches}; metrics {m}")
    want = {"flash_attention_fwd": 12, "lowrank_encode": 1, "lowrank_decode": 1,
            "group_gate": 6, "grouped_mlp": 6, "paged_attention": 0,
            "lowrank_roundtrip": 0, "lowrank_roundtrip_loss": 0}
    if launches != want:
        raise AssertionError(f"pipeline launches {launches}, want {want}")
    if m["boundary_bytes"] != B * S * 384 * 2 or not (m["split"] == 1 and m["compressed"]):
        raise AssertionError(f"pipeline metrics {m}")
    if logits.shape != (B, S, cfg.padded_vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("pipeline logits are not finite or have the wrong shape")

    torch.cuda.reset_peak_memory_stats()
    runs = [pipe.run_batch(tok)[1] for _ in range(10)]
    peak = torch.cuda.max_memory_allocated()
    t_end = sorted(r["t_end_s"] for r in runs)[5]
    t_cloud = sorted(r["t_cloud_s"] for r in runs)[5]
    log(f"pipeline run_batch [{B}, {S}]: median t_end {t_end * 1e3:.3f} ms, median t_cloud "
        f"{t_cloud * 1e3:.3f} ms over 10 warm runs (host clock, device synchronized); "
        f"t_comm {m['t_comm_s'] * 1e3:.3f} ms modeled at the end profile's link rate")
    log(f"pipeline tokens/s: {B * S / (t_end + t_cloud):.1f} ({B * S} tokens over "
        f"t_end + t_cloud); peak device memory {peak / 2**20:.1f} MiB")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_run:
        t0 = time.perf_counter()
        pipe.run_batch(tok)
        wall = time.perf_counter() - t0
    avgs = prof_run.key_averages()
    # kernel rows only: an operator row's device time repeats its kernels'
    dev = [e for e in avgs if e.device_type != DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in dev)
    (OUT_DIR / "pipeline_profile.txt").write_text(
        avgs.table(sort_by="cuda_time_total", row_limit=40))
    in_path = kernels_in_path(dev, (("flash attention", ("flash_fwd_mma_kernel",), ()),
                                    *CODEC_KERNELS, *ffn_kernels("expert FFN", "__nv_bfloat16"),
                                    *GATE_KERNELS, *PAGED_KERNELS))
    log(f"pipeline profile (1 run_batch): device time {dev_us / 1e3:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall; kernels in path, a launch: {in_path}; written to "
        f"chiprun_out/pipeline_profile.txt")

    pipeline_vs_cpu(torch, eng, pipe.codec, prof, B, S)
    return launches


# ---------------------------------------------------------------------------
# The MoE dispatch codec (eq. 8 on the expert dispatch) on every path
# ---------------------------------------------------------------------------

# the benchmarks' ec2moe system (benchmarks/common.py): rank d_model // 2 on
# the expert dispatch, its reconstruction term weighted 0.05
DISPATCH_CODEC = dict(rank=384, boundaries=("dispatch",), recon_weight=0.05)


def dispatch_config():
    """Full-width switch-base with the ec2moe dispatch codec."""
    from repro_torch.configs import CompressionConfig, get_config

    return get_config("switch-base").replace(compression=CompressionConfig(**DISPATCH_CODEC))


def dispatch_compressed(cfg) -> bool:
    c = cfg.compression
    return c is not None and c.rank > 0 and "dispatch" in c.boundaries


def dispatch_serving(torch, counters, silent):
    """Phase 3's traffic through ``ServingEngine`` on the codec model: the
    roundtrip launches twice a gate launch (the dispatched rows and the
    expert outputs of every MoE layer call), the boundary codec's
    ``silent`` kernels never; then the card-vs-CPU check of phase 4 on it.
    Returns (the run's launch counts, the engine)."""
    for c in silent:
        c.launches = 0
    launches, eng = serve(torch, counters, cfg=dispatch_config(),
                          profile_name="decode_dispatch_profile.txt")
    rt, gate = launches["lowrank_roundtrip_loss"], launches["group_gate"]
    quiet = {c.__name__: c.launches for c in silent}
    log(f"dispatch codec serving: {rt} roundtrip launches for {gate} gate launches; {quiet}")
    if rt == 0 or rt != 2 * gate or any(quiet.values()):
        raise AssertionError(f"dispatch codec serving: roundtrip {rt}, gate {gate}, {quiet}")
    # In bf16 the codec's two extra roundings a layer make a near-tied top-1
    # route flip between card and CPU likely (the kernel agrees with its
    # plain version on every call, within an ulp), and a flipped route
    # moves the logits wholesale (pipeline_vs_cpu's finding); so the codec
    # model is held in f32, where sums in other orders move logits by
    # ~1e-6 and flip no route: max|diff| within 1e-3 of max|cpu|, cosine
    # at least 0.9999.
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    log("dispatch codec serving against the CPU reference (f32):")
    cfg32 = eng.model.cfg.replace(dtype="float32")
    params32 = Model(cfg32, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    reference_check(torch, None, cfg32, transformer.compute_params(params32, cfg32),
                    rel_tol=1e-3, cos_tol=0.9999)
    return launches, eng


def dispatch_pipeline(torch, eng, counters):
    """One ``EndCloudPipeline.run_batch`` on [4, 256] tokens of the codec
    model (phase 5's profiles and boundary codec): 12 roundtrip launches at
    n = 1024 rows (6 MoE layers, two each), finite logits, and the
    roundtrip's device time in path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.hardware import PROFILES
    from repro_torch.serving import EndCloudPipeline

    cfg = eng.model.cfg
    pipe = EndCloudPipeline(eng.model, eng.params, compression_rank=384,
                            end_profile=PROFILES["jetson-orin"], cloud_profile=PROFILES["a100"])
    B, S = 4, 256
    tok = pipeline_tokens(torch, cfg.vocab_size, B, S, 0).cuda()
    pipe.run_batch(tok)  # warm-up
    for c in counters:
        c.launches = 0
    logits, m = pipe.run_batch(tok)
    launches = {c.__name__: c.launches for c in counters}
    log(f"dispatch codec pipeline (split {pipe.split}, boundary codec "
        f"{'on' if pipe.tiers.compress else 'off'}): launches per run_batch {launches}")
    if launches["lowrank_roundtrip_loss"] != 12 or launches["group_gate"] != 6:
        raise AssertionError(f"dispatch codec pipeline launches {launches}, want 12 "
                             "roundtrips for 6 gates")
    if logits.shape != (B, S, cfg.padded_vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("dispatch codec pipeline logits are not finite or misshapen")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_run:
        t0 = time.perf_counter()
        pipe.run_batch(tok)
        wall = time.perf_counter() - t0
    avgs = prof_run.key_averages()
    dev = [e for e in avgs if e.device_type != DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in dev)
    (OUT_DIR / "pipeline_dispatch_profile.txt").write_text(
        avgs.table(sort_by="cuda_time_total", row_limit=40))
    in_path = kernels_in_path(dev, (*ROUNDTRIP_KERNELS, *GATE_KERNELS,
                                    *ffn_kernels("expert FFN", "__nv_bfloat16")))
    log(f"dispatch codec pipeline profile (1 run_batch): device time {dev_us / 1e3:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall; kernels in path, a launch (n = {B * S} rows): {in_path}; "
        f"written to chiprun_out/pipeline_dispatch_profile.txt")
    return launches


def dispatch_stream(torch, counters):
    """Phase 6's pool run on the codec model, both tiers carrying the codec
    (counters the reference's, the roundtrip twice a gate launch on
    ``moe_resident`` and ``moe_sorted``), then the f32 replan run on the
    card against the CPU.  Returns the pool run's launch counts."""
    from repro_torch.models.model import Model

    model = Model(dispatch_config(), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    launches, _, _ = stream_pool_run(torch, model, params, counters, tag="dispatch pool run",
                                     profile_name="stream_dispatch_profile.txt")
    f32_card_vs_cpu(model, params, "dispatch replan run")
    return launches


def pipeline_tokens(torch, vocab: int, B: int, S: int, seed: int):
    return torch.randint(0, vocab, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def pipeline_vs_cpu(torch, eng, codec, prof, B: int, S: int):
    """The pipeline on the card against the same pipeline on the CPU (plain
    versions, same weights and codec).

    With these random weights the expert outputs (~200) dwarf the rest of
    the residual stream, so a token whose top-1 route flips between the two
    sides (bf16 noise moving a near-tied gate) gets unrelated logits from
    there on, and through attention so may the tokens after it.  Hence:

    - f32, tokens of seed 0: every token routed alike at every MoE layer,
      and the whole batch's logits within rel / cos of the CPU's;
    - bf16, seed 0, layer by layer: every layer fed the CPU's input for it.
      Routes must be equal except on near ties (the CPU's gap between the
      two most probable experts below ``TIE``), every layer's output within
      ``LAYER_REL`` of the CPU's (the tokens that tie-flipped in that layer
      aside), and the logits within rel / cos.  This holds each kernel at
      the path's T = 1024 with no token left out for disagreeing;
    - bf16, free running, tokens of seeds ``SEEDS``: the share of tokens
      routed alike at every MoE layer at least ``SHARE``, and their logits
      within rel / cos."""
    from repro_torch.models.model import Model, to_device
    from repro_torch.serving import EndCloudPipeline

    F32_REL, F32_COS = 1e-4, 0.9999
    TIE, LAYER_REL, TF_REL, TF_COS = 1e-3, 2**-6, 0.02, 0.9999
    SEEDS, SHARE, REL, COS = (0, 1, 2, 3), 0.9, 0.1, 0.99

    cfg = eng.model.cfg
    V, T, d = cfg.vocab_size, B * S, cfg.d_model
    moe_layer = [spec.moe for _ in range(cfg.block_repeat) for spec in cfg.layer_pattern]
    fails = []

    def check(ok: bool, what: str):
        if not ok:
            fails.append(what)

    def pipes(dtype):
        cfg_d = cfg.replace(dtype=dtype)
        card = EndCloudPipeline(Model(cfg_d, device="cuda"), eng.params,
                                codec_params=codec, **prof)
        host = EndCloudPipeline(Model(cfg_d, device="cpu"), to_device(eng.params, "cpu"),
                                codec_params=to_device(codec, "cpu"), **prof)
        return card, host

    def free_pair(card, host, tokens, host_run=None):
        lc, mc, rc = host_run or traced_run(torch, host, tokens)
        lg, mg, rg = traced_run(torch, card, tokens.cuda())
        lg = lg.cpu()
        check((mc["boundary_bytes"], mc["split"]) == (mg["boundary_bytes"], mg["split"]),
              f"card metrics {mg} and CPU metrics {mc} disagree")
        check(bool(torch.isfinite(lg).all()), "card logits are not finite")
        alike_l = (rg["idx"] == rc["idx"]).all(dim=-1)  # [MoE layers, T]
        return lg, lc, rc, alike_l

    t0 = time.perf_counter()
    tokens = pipeline_tokens(torch, cfg.vocab_size, B, S, 0)
    card, host = pipes("float32")
    lg, lc, _, alike_l = free_pair(card, host, tokens)
    rel, cos = logit_gap(torch, lg, lc, V)
    share = alike_l.all(dim=0).float().mean().item()
    log(f"  float32, seed 0: tokens routed alike {share:.4f}; logits max|diff|/max|cpu|="
        f"{rel:.3e} (<= {F32_REL:g}) cos={cos.min().item():.7f} (>= {F32_COS:g})")
    check(share == 1.0 and rel <= F32_REL and cos.min().item() >= F32_COS, "float32 logits")

    card, host = pipes("bfloat16")
    host_run = traced_run(torch, host, tokens)
    lc, _, rc = host_run
    lf, _, rf = traced_run(torch, card, tokens.cuda(), feed=rc["in"])
    lf = lf.cpu()
    flip = (rf["idx"] != rc["idx"]).any(dim=-1)  # [MoE layers, T]
    tie_max = rc["margin"][flip].max().item() if bool(flip.any()) else 0.0
    layer_rel, m = [], 0
    for j, is_moe in enumerate(moe_layer):
        keep = ~flip[m] if is_moe else torch.ones(T, dtype=torch.bool)
        m += is_moe
        o_card, o_cpu = rf["out"][j].view(T, d)[keep], rc["out"][j].view(T, d)[keep]
        layer_rel.append(((o_card - o_cpu).abs().max() / o_cpu.abs().max()).item())
    keep = (~flip[-1]).view(B, S) if moe_layer[-1] else torch.ones(B, S, dtype=torch.bool)
    rel, cos = logit_gap(torch, lf, lc, V)
    rel = logit_gap(torch, lf[keep], lc[keep], V)[0]
    log(f"  bfloat16, seed 0, each layer fed the CPU's input: route flips per MoE layer "
        f"{flip.sum(dim=1).tolist()} (CPU top-2 gap of the flipped <= {tie_max:.3e}, "
        f"tie < {TIE:g}; median gap of all {rc['margin'].median().item():.3e}); "
        f"layer max|diff|/max|cpu| {[f'{x:.2e}' for x in layer_rel]} (<= {LAYER_REL:g}); "
        f"logits max|diff|/max|cpu|={rel:.3e} (<= {TF_REL:g}) cos={cos[keep].min().item():.6f} "
        f"(>= {TF_COS:g})")
    check(tie_max < TIE, "bfloat16: a gate fed the CPU's input flipped a route that is no tie")
    check(max(layer_rel) <= LAYER_REL, "bfloat16: a layer fed the CPU's input disagrees")
    check(rel <= TF_REL and cos[keep].min().item() >= TF_COS,
          "bfloat16: the logits of the layer-by-layer run disagree")

    for seed in SEEDS:
        tokens = pipeline_tokens(torch, cfg.vocab_size, B, S, seed)
        lg, lc, rc, alike_l = free_pair(card, host, tokens, host_run if seed == 0 else None)
        alike = alike_l.all(dim=0)
        share = alike.float().mean().item()
        rel = logit_gap(torch, lg[alike.view(B, S)], lc[alike.view(B, S)], V)[0]
        cos = logit_gap(torch, lg, lc, V)[1][alike.view(B, S)]
        # the CPU's top-2 gap where each disagreeing token first flipped
        first = (~alike_l).int().argmax(dim=0)[~alike]
        gaps = rc["margin"][first, (~alike).nonzero().squeeze(1)]
        gap = f"{gaps.median().item():.3e}" if gaps.numel() else "-"
        log(f"  bfloat16, seed {seed}, free running: tokens routed alike {share:.4f} "
            f"(>= {SHARE:g}); CPU top-2 gap at the first flip, median {gap} (all tokens "
            f"{rc['margin'].median().item():.3e}); over the alike: logits max|diff|/max|cpu|="
            f"{rel:.3e} (<= {REL:g}) cos={cos.min().item():.6f} (>= {COS:g})")
        check(share >= SHARE and rel <= REL and cos.min().item() >= COS,
              f"bfloat16, seed {seed}: the card disagrees with the CPU reference")
    log(f"  (card vs CPU checks took {time.perf_counter() - t0:.1f} s)")
    if fails:
        raise AssertionError("pipeline card vs CPU: " + "; ".join(fails))


# ---------------------------------------------------------------------------
# Phase 6: the streaming two-tier engine, its expert pool and replanning
# ---------------------------------------------------------------------------

# the reference engine's counters in the pool run (same scenario, on the CPU)
POOL_COUNTERS = {"n_expert_evictions": 2, "n_expert_prefetches": 2,
                 "expert_bytes_down": 37748736, "n_stage_steps": 140,
                 "n_prefill_chunks": 74, "bytes_up": 1986816, "kv_capacity_ratio": 1.0,
                 "expert_slab_bytes": 18874368, "expert_capacity_ratio": 1.0}
# and in the replan run (jetson-orin end planning split 1, then 10 Gbps)
REPLAN_COUNTERS = {"n_expert_evictions": 3, "n_stage_steps": 37, "n_prefill_chunks": 40}
QUANT = dict(quantize_kv=True, quantize_experts=True, quantize_boundary=True)
# the reference's quantized engine in the pool run (tools/ref_stream_counters.py,
# full width; its unquantized run reproduces POOL_COUNTERS): the end memory of
# phase 6 holds ~4x as many int8 slabs, so the shrink evicts nothing
QUANT_POOL_COUNTERS = {"n_expert_evictions": 0, "n_expert_prefetches": 0,
                       "expert_bytes_down": 0, "n_stage_steps": 140, "n_prefill_chunks": 74,
                       "bytes_up": 998582, "kv_capacity_ratio": 1.9948051948051948,
                       "expert_slab_bytes": 4733952,
                       "expert_capacity_ratio": 3.9870214146658016}


def stream_requests(vocab, n, seed, new, hi=200, base=0):
    """``n`` requests: prompt lengths in [16, hi), token ids below ``vocab``
    (``numpy.random.default_rng(seed)``, the length drawn before each
    prompt), ``new`` tokens each, ids from ``base``, never stopping early
    (``eos_id=-1``), so every counter is independent of the tokens."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(base + i, rng.integers(0, vocab, size=int(rng.integers(16, hi)))
                    .astype(np.int32), max_new_tokens=new) for i in range(n)]


def stream_engine(model, params, end, rank=384, **kw):
    from repro_torch.core.hardware import PROFILES
    from repro_torch.serving import EndCloudServingEngine

    return EndCloudServingEngine(
        model, params, end_profile=end, cloud_profile=PROFILES["a100"],
        compression_rank=rank, max_batch=8, n_groups=2, page_size=16, prefill_chunk=32,
        max_len=256, **kw)


def stream_pool_run(torch, model, params, counters, *, flags=None, want_counters=POOL_COUNTERS,
                    tag="pool run", profile_name="stream_profile.txt", profiles=None):
    """The expert pool through a memory shrink and regrow, stage times
    measured, with the int8 streams of ``flags``; returns the launch counts
    of the run, the requests' tokens and the engine's metrics, and records
    the profiled tick's (device ms, wall ms) in ``profiles[tag]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.expertpool import expert_slab_bytes
    from repro_torch.core.hardware import PROFILES, DeviceProfile, DeviceState

    cfg = model.cfg
    jet = PROFILES["jetson-orin"]
    slab = expert_slab_bytes(cfg)
    # memory for two copies of the 3 target slabs of the one end MoE layer:
    # the slab budget (half of it) holds exactly the target set, and a
    # mem_free=0.5 state halves it (benchmarks/decode_pipeline.py's rule)
    end = DeviceProfile("jetson-orin-slabs", peak_gflops=jet.peak_gflops,
                        mem_gb=2 * 1 * 3 * slab / 1e9, mem_bw_gbs=jet.mem_bw_gbs,
                        net_gbps=jet.net_gbps)
    gc.collect()  # earlier engines hold reference cycles (stage functions)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    eng = stream_engine(model, params, end, force_split=1, timing="measured", **(flags or {}))
    torch.cuda.synchronize()
    log(f"{tag}: engine built in {time.perf_counter() - t0:.2f} s: split {eng.split}, "
        f"codec {'on' if eng.tiers.compress else 'off'}, {int(eng.tiers.end_mask.sum())} "
        f"target experts, {eng.expert_pool.num_slabs} slabs of {eng._slab_bytes} bytes, "
        f"{eng.expert_pool.slabs_in_use} resident, int8 streams {sorted(flags or {})}")
    reqs = stream_requests(cfg.vocab_size, 8, 0, 32)
    for r in reqs:
        eng.submit(r)
    tick_s, decode_only, prof_tick = [], [], None
    tick = prefetch_ticks = 0
    t_run = time.perf_counter()
    while eng.busy() or tick < 12:
        if tick == 6:
            eng.update_device_state(DeviceState(mem_free=0.5))
        if tick == 12:
            eng.update_device_state(DeviceState(mem_free=1.0))
            more = stream_requests(cfg.vocab_size, 8, 1, 32, base=100)
            for r in more:
                eng.submit(r)
            reqs += more
        chunks, steps, fetched = eng.n_prefill_chunks, eng.n_stage_steps, eng.n_expert_prefetches
        all_decoding = not eng._jobs and not eng.waiting and int(eng._active.sum()) == 8
        if prof_tick is None and tick > 12 and all_decoding:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            prof_tick = (tick, prof.key_averages(), wall)
        else:
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t)
            if eng.n_prefill_chunks == chunks and eng.n_stage_steps > steps:
                decode_only.append(tick_s[-1])
        prefetch_ticks += eng.n_expert_prefetches > fetched
        tick += 1
        if tick > 2000:
            raise AssertionError("the stream engine did not drain in 2000 ticks")
    run_s = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated()
    launches = {c.__name__: c.launches for c in counters}

    m = eng.metrics()
    got = {"n_expert_evictions": eng.n_expert_evictions,
           "n_expert_prefetches": eng.n_expert_prefetches,
           "expert_bytes_down": eng.expert_bytes_down, "n_stage_steps": eng.n_stage_steps,
           "n_prefill_chunks": eng.n_prefill_chunks, "bytes_up": eng.link.bytes_up}
    for k in ("kv_capacity_ratio", "expert_slab_bytes", "expert_capacity_ratio"):
        got[k] = m[k]
    log(f"{tag}: {tick} ticks, counters {got}, replan events {eng.replan_events}, "
        f"expert hit rate {m['expert_hit_rate']}, launches {launches}")
    bad = [r.request_id for r in reqs if not r.done or len(r.generated) != 32]
    if len(reqs) != 16 or bad:
        raise AssertionError(f"{tag}: requests {bad} did not finish with 32 tokens")
    if eng.end_pool.pages_in_use or eng.cloud_pool.pages_in_use:
        raise AssertionError(f"{tag}: KV pages still mapped after the run")
    if got != want_counters or eng.replan_events or m["expert_hit_rate"] != 1.0:
        raise AssertionError(f"{tag}: counters {got}, want the reference's {want_counters}")
    # every stage call (decode steps, prefill chunks, and one warmup of each
    # per build of the stage functions) runs each tier's layers once; with
    # int8 KV pools each layer writes its k and v in one quantize-and-write
    # launch, with an int8 boundary each end call encodes and quantizes it
    # in one launch and each cloud call dequantizes and decodes it in one
    # (the rank-384 codec is always on here), and with an int8 slab store
    # each batch of slab writes (the initial fill, each tick that
    # prefetched) quantizes every weight matrix
    if not eng.tiers.compress:
        raise AssertionError(f"{tag}: the codec is off")
    calls = eng.n_stage_steps + eng.n_prefill_chunks + 2 * eng._build_gen
    n_layers = cfg.block_repeat * len(cfg.layer_pattern)
    end_moe = eng.split * len(eng._moe_pos)
    kvq, exq, bq = eng.quantize_kv, eng.quantize_experts, eng.quantize_boundary
    mats = len(eng._moe_pos) * (3 if cfg.ffn_gated else 2)
    want = {"grouped_mlp_resident": 0 if exq else calls * end_moe,
            "grouped_mlp_resident_quant": calls * end_moe if exq else 0,
            "grouped_mlp": calls * (cfg.block_repeat * len(eng._moe_pos) - end_moe),
            "group_gate": calls * cfg.block_repeat * len(eng._moe_pos),
            "lowrank_encode": 0 if bq else calls, "lowrank_decode": 0 if bq else calls,
            "lowrank_encode_quant": calls * bq, "lowrank_decode_quant": calls * bq,
            "paged_attention": 0 if kvq else calls * n_layers,
            "paged_attention_quant": calls * n_layers if kvq else 0,
            "paged_write_quant": calls * n_layers * kvq,
            "quantize_rows": (1 + prefetch_ticks) * mats * exq,
            "dequantize_rows": 0,
            "flash_attention_fwd": 0, "lowrank_roundtrip": 0,
            # a dispatch codec: one roundtrip each way a MoE layer call, on
            # the end tier's moe_resident and the cloud tier's moe_sorted
            "lowrank_roundtrip_loss": 2 * calls * cfg.block_repeat * len(eng._moe_pos)
            if dispatch_compressed(cfg) else 0}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want}")

    dec = sorted(decode_only)
    n_tok = sum(len(r.generated) for r in reqs)
    log(f"stream tick (decode-only, host clock, synchronized): median "
        f"{dec[len(dec) // 2] * 1e3:.3f} ms, max {dec[-1] * 1e3:.3f} ms over {len(dec)} ticks")
    log(f"stream stage times (measured, per call): t_end {m['mean_t_end_s'] * 1e3:.3f} ms, "
        f"t_cloud {m['mean_t_cloud_s'] * 1e3:.3f} ms; t_comm {m['mean_t_comm_s'] * 1e3:.3f} "
        f"ms modeled; pipelined_step_s {m['pipelined_step_s'] * 1e3:.3f} ms, serial_step_s "
        f"{m['serial_step_s'] * 1e3:.3f} ms")
    log(f"{tag} tokens/s: {n_tok / run_s:.1f} ({n_tok} tokens in {run_s:.3f} s, 16 requests); "
        f"peak device memory {peak / 2**20:.1f} MiB")
    ptick, avgs, wall = prof_tick
    dev = [e for e in avgs if e.device_type != DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in dev)
    (OUT_DIR / profile_name).write_text(avgs.table(sort_by="cuda_time_total", row_limit=40))
    store = "signed char" if exq else "float"
    in_path = kernels_in_path(dev, (
        *ffn_kernels("resident FFN", store),
        *ffn_kernels("cloud expert FFN", "__nv_bfloat16"),
        *PAGED_KERNELS, *GATE_KERNELS,
        ("KV write", ("paged_write_quant_kernel<",), ()),
        ("quantize", ("quantize_rows_kernel", "quantize_rows_vec_kernel",
                      "quantize_cols_kernel"), ()),
        ("dequantize", ("dequantize_rows_kernel",), ()),
        *CODEC_KERNELS, *CODEC_QUANT_KERNELS, *ROUNDTRIP_KERNELS))
    casts = sum(e.count for e in dev if "direct_copy_kernel" in e.key)
    if profiles is not None:
        profiles[tag] = (dev_us / 1e3, wall * 1e3)
    log(f"{tag} profile (tick {ptick}, 8 slots decoding): device time {dev_us / 1e3:.3f} ms "
        f"of {wall * 1e3:.3f} ms wall ({dev_us / 1e3 / (wall * 1e3):.1%} busy); kernels in "
        f"path, a launch: {in_path}; copy and cast kernels (direct_copy): {casts}; written "
        f"to chiprun_out/{profile_name}")
    return launches, [r.generated for r in reqs], m


def replan_run(m, p, n, new, hi, at, **kw):
    """``n`` requests on a jetson-orin end whose planned split 1 moves to 0
    when a 10 Gbps link is declared at tick ``at``; returns (tokens, engine)."""
    from repro_torch.core.hardware import PROFILES

    eng = stream_engine(m, p, PROFILES["jetson-orin"], timing="measured", **kw)
    reqs = stream_requests(m.cfg.vocab_size, n, 0, new, hi=hi)
    for r in reqs:
        eng.submit(r)
    tick = 0
    while eng.busy():
        if tick == at:
            eng.observe_bandwidth(10.0, hard=True)
        eng.step()
        tick += 1
    moves = [(ev["old_split"], ev["new_split"]) for ev in eng.replan_events]
    if moves != [(1, 0)] or not all(r.done and len(r.generated) == new for r in reqs):
        raise AssertionError(f"replan run ({m.device}, {m.cfg.dtype}, {kw}): events "
                             f"{eng.replan_events}, not every request finished")
    if eng.end_pool.pages_in_use or eng.cloud_pool.pages_in_use:
        raise AssertionError("replan run: KV pages still mapped after the run")
    return [r.generated for r in reqs], eng


def f32_card_vs_cpu(model, params, tag, **kw):
    """A shortened replan run (2 requests, 8 tokens) in f32 on the card and
    on the CPU (plain versions, same weights): the tokens must be equal."""
    from repro_torch.models.model import Model, to_device

    t0 = time.perf_counter()
    cfg32 = model.cfg.replace(dtype="float32")
    card, _ = replan_run(Model(cfg32, device="cuda"), params, 2, 8, 64, 3, **kw)
    t1 = time.perf_counter()
    host, _ = replan_run(Model(cfg32, device="cpu"), to_device(params, "cpu"), 2, 8, 64, 3,
                         **kw)
    same = card == host
    log(f"{tag} (f32, 2 requests, 8 tokens): card tokens equal the CPU's: {same} "
        f"(card {t1 - t0:.1f} s, CPU {time.perf_counter() - t1:.1f} s)")
    if not same:
        raise AssertionError(f"{tag}: f32 card tokens differ from the CPU's")


def stream_replan_runs(torch, model, params):
    """A hard bandwidth change moves the planned split from 1 to 0: pooled
    against dense-mask end tiers in bf16 on the card, and a shortened run in
    f32 on the card against the CPU."""
    run = replan_run
    t0 = time.perf_counter()
    pooled, eng = run(model, params, 8, 16, 200, 6)
    dense, deng = run(model, params, 8, 16, 200, 6, expert_pool=False)
    got = {"n_expert_evictions": eng.n_expert_evictions, "n_stage_steps": eng.n_stage_steps,
           "n_prefill_chunks": eng.n_prefill_chunks}
    same = pooled == dense
    log(f"replan run (bf16, card): split 1 -> 0 at a safe point, counters {got}; pooled "
        f"tokens equal the dense-mask engine's: {same} ({time.perf_counter() - t0:.1f} s)")
    if got != REPLAN_COUNTERS or not same or (deng.n_stage_steps, deng.n_prefill_chunks) != (
            eng.n_stage_steps, eng.n_prefill_chunks):
        raise AssertionError(f"replan run: counters {got} (want {REPLAN_COUNTERS}), "
                             f"pooled == dense-mask tokens: {same}")
    f32_card_vs_cpu(model, params, "replan run")


def stream_quant(torch, model, params, counters, base, profiles):
    """Phase 7: the pool run with every int8 stream on, held to the
    reference's quantized engine, beside phase 6's run ``base`` = (tokens,
    metrics); then the f32 card-vs-CPU replan run with the streams on.
    Returns the pool run's launch counts."""
    launches, tokens, m = stream_pool_run(
        torch, model, params, counters, flags=QUANT, want_counters=QUANT_POOL_COUNTERS,
        tag="quant pool run", profile_name="stream_quant_profile.txt", profiles=profiles)
    base_tokens, mb = base
    pairs = [(a, b) for ta, tb in zip(tokens, base_tokens) for a, b in zip(ta, tb)]
    match = sum(a == b for a, b in pairs) / len(pairs)
    log(f"quant pool run against phase 6's: bytes_up {m['bytes_up']} / {mb['bytes_up']} = "
        f"{m['bytes_up'] / mb['bytes_up']:.6f} (expected (r+2)/(2r) = 386/768 = "
        f"{386 / 768:.6f}); kv_capacity_ratio {m['kv_capacity_ratio']:.6f} (phase 6: "
        f"{mb['kv_capacity_ratio']}); expert_slab_bytes {m['expert_slab_bytes']} against "
        f"{mb['expert_slab_bytes']} (capacity ratio {m['expert_capacity_ratio']:.6f}); "
        f"bf16 tokens equal to phase 6's at {match:.4f} of {len(pairs)} positions "
        f"(reported, no bound)")
    for flag in QUANT:
        f32_card_vs_cpu(model, params, f"quant replan run, {flag} alone", **{flag: True})
    f32_all_streams_card_vs_cpu(torch, model, params)
    return launches


def f32_all_streams_card_vs_cpu(torch, model, params):
    """The shortened f32 replan run with all three int8 streams, on the card
    and on the CPU, every MoE layer's gate recorded on both sides.

    Each int8 stream alone gives the CPU's tokens (above).  Together, f32
    sums taken in another order on the card move a few codes by one step
    (the quantizers agree bit for bit on equal inputs), and a boundary code
    one step off moves every value the cloud tier derives from that token by
    ~1/254 of the row's range: enough to flip a near-tied top-1 route, after
    which that token's expert output (~200 in magnitude with these random
    weights) and everything downstream differ.  So: the tokens are equal, or
    the first route that differs (gate calls paired in order, the schedule
    being the same on both sides) is a near tie, the CPU's gap between its
    two most probable experts below ``TIE`` (median gap ~0.1)."""
    from repro_torch.core import gating
    from repro_torch.models.model import Model, to_device

    TIE = 1e-2
    cfg32 = model.cfg.replace(dtype="float32")
    rec = {"cuda": [], "cpu": []}
    gate = gating.gate

    def gate_rec(*args, **kw):
        out = gate(*args, **kw)
        top2 = out.probs.float().topk(2, dim=-1).values
        rec[out.topk_idx.device.type].append(
            (out.topk_idx.cpu(), (top2[:, 0] - top2[:, 1]).cpu()))
        return out

    gating.gate = gate_rec
    try:
        card, _ = replan_run(Model(cfg32, device="cuda"), params, 4, 8, 64, 3, **QUANT)
        host, _ = replan_run(Model(cfg32, device="cpu"), to_device(params, "cpu"), 4, 8, 64,
                             3, **QUANT)
    finally:
        gating.gate = gate
    equal = sum(a == b for ta, tb in zip(card, host) for a, b in zip(ta, tb))
    if len(rec["cuda"]) != len(rec["cpu"]):
        raise AssertionError("all int8 streams, f32: the card and the CPU ran different schedules")
    first = next(((i, ic != ih) for i, ((ic, _), (ih, _)) in enumerate(zip(rec["cuda"], rec["cpu"]))
                  if bool((ic != ih).any())), None)
    if first is None:
        log(f"quant replan run, all streams (f32): tokens equal {equal} of 32, every route "
            f"equal over {len(rec['cpu'])} gate calls")
        if equal != 32:
            raise AssertionError("all int8 streams, f32: card tokens differ with every route equal")
        return
    i, flip = first
    gaps = rec["cpu"][i][1][flip.any(dim=-1)]
    median = torch.cat([g for _, g in rec["cpu"]]).median().item()
    log(f"quant replan run, all streams (f32): tokens equal {equal} of 32; first route that "
        f"differs at gate call {i} of {len(rec['cpu'])} ({int(flip.any(dim=-1).sum())} "
        f"tokens), CPU top-2 gap there {gaps.max().item():.3e} (tie < {TIE:g}; median gap "
        f"of all {median:.3e})")
    if gaps.max().item() >= TIE:
        raise AssertionError("all int8 streams, f32: the card flipped a route that is no tie")


# ---------------------------------------------------------------------------
# Phase 8: speculative decode and preemption on the streaming engine
# ---------------------------------------------------------------------------

# a per-upload round trip at which the planner drafts k = 4 for the
# jetson-orin / a100 pair at split 1 (any acceptance above 0 plans 4 there)
SPEC = dict(spec_k=4, link_rtt_s=0.05)
SPEC_HI = 64  # prompt lengths of the f32 runs (the CPU runs them too)
# the depth at which phase 8's f32 runs hold the card against the CPU (the
# CPU half at full depth took 99 s of speculation and ~45 s of preemption)
SPEC_CPU_LAYERS = 4
TIE = 1e-2  # a top-2 gap below this is a near tie (f32_all_streams_card_vs_cpu)
# the kernels the bf16 speculative run (expert pool, all three int8
# streams, the rank-384 boundary codec) launches; every other wrapper: 0
SPEC_PATH = ("paged_attention_quant", "paged_write_quant", "group_gate", "grouped_mlp",
             "grouped_mlp_resident_quant", "flash_attention_fwd", "lowrank_encode_quant",
             "lowrank_decode_quant", "quantize_rows")
SPEC_COUNTERS = ("spec_plan_k", "spec_k_eff", "spec_rounds", "spec_drafted", "spec_accepted",
                 "spec_rollbacks", "n_host_syncs", "n_stage_steps", "prefill_chunks",
                 "bytes_up")


def spec_engine(model, params, **kw):
    """``stream_engine``'s settings at split 1, jetson-orin end, modeled
    stage times."""
    from repro_torch.core.hardware import PROFILES

    return stream_engine(model, params, PROFILES["jetson-orin"], force_split=1,
                         timing="modeled", **kw)


def only_path(tag, launches, path):
    """Every wrapper of ``path`` launched and no other."""
    zero = [k for k in path if launches[k] == 0]
    off = {k: v for k, v in launches.items() if k not in path and v}
    if zero or off:
        raise AssertionError(f"{tag}: path kernels not launched {zero}, kernels off the path "
                             f"launched {off}")


def drive(eng, reqs, hook=None, limit=3000):
    """Submit ``reqs`` and tick until the engine drains (``hook(engine,
    tick)`` before each tick); returns the requests' tokens."""
    for r in reqs:
        eng.submit(r)
    tick = 0
    while eng.busy():
        if hook is not None:
            hook(eng, tick)
        eng.step()
        tick += 1
        if tick > limit:
            raise AssertionError(f"the engine did not drain in {limit} ticks")
    return [list(r.generated) for r in reqs]


def near_tie(torch, eng, stream) -> float:
    """The smallest top-2 gap at the last position of ``stream``: of the
    gate's probabilities in every MoE layer, and of the LM head's logits,
    through the engine's own tiers (the end tier's blocks under its expert
    mask, the boundary codec, the cloud's blocks; the full-sequence forward
    on the card)."""
    from repro_torch.core import compression as comp
    from repro_torch.core import gating
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    from repro_torch.serving.endcloud import split_block_params

    import numpy as np

    cfg = eng.cfg
    gaps = []
    gate = gating.gate

    def gate_rec(*args, **kw):
        out = gate(*args, **kw)
        top2 = out.probs.float()[-1].topk(2).values
        gaps.append((top2[0] - top2[1]).item())
        return out

    end_p, cloud_p = split_block_params(eng._cparams, eng.split)
    tokens = torch.tensor(np.asarray(stream, np.int32)[None], device=eng.device)
    pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=eng.device)[None]
    angles = attn.model_angles(cfg, pos)
    gating.gate = gate_rec
    try:
        with torch.no_grad():
            x = transformer.embed_inputs(end_p, cfg, tokens)
            x = transformer.apply_stack_full(end_p, x, cfg, angles,
                                             expert_mask=eng.tiers.end_mask)[0]
            if eng.tiers.compress:
                x = comp.decode_1d(eng.tiers.codec, comp.encode_1d(eng.tiers.codec, x))
            x = transformer.apply_stack_full(cloud_p, x.to(cfg.torch_dtype), cfg, angles)[0]
            top2 = transformer.lm_logits(cloud_p, cfg, x[:, -1:]).float()[0, 0].topk(2).values
    finally:
        gating.gate = gate
    return min(gaps + [(top2[0] - top2[1]).item()])


def equal_or_tie(torch, eng, reqs, got, want, tag):
    """``got == want``, or the first position where they differ is a near
    tie (``near_tie`` of the common prefix below ``TIE``, through ``eng``,
    or ``eng(r)`` for request ``r`` when it is a function); logs the count
    of equal tokens."""
    pairs = [(a, b) for ta, tb in zip(got, want) for a, b in zip(ta, tb)]
    equal = sum(a == b for a, b in pairs)
    if got == want:
        log(f"{tag}: tokens equal ({equal} of {len(pairs)})")
        return
    r, i = next((r, i) for r, (ta, tb) in enumerate(zip(got, want))
                for i, (a, b) in enumerate(zip(ta, tb)) if a != b)
    stream = list(reqs[r].prompt) + list(want[r][:i])
    gap = near_tie(torch, eng(r) if callable(eng) else eng, stream)
    log(f"{tag}: tokens equal {equal} of {len(pairs)}; the first that differs (request "
        f"{r}, token {i}) is at a top-2 gap of {gap:.3e} (tie < {TIE:g})")
    if gap >= TIE:
        raise AssertionError(f"{tag}: tokens differ where the model has no near tie")


class RoundProfiler:
    """Wraps stage functions so that, once ``armed``, the first call of
    each runs under its own ``torch.profiler`` context: (device us of its
    kernels, synchronized wall ms) a stage."""

    def __init__(self, torch):
        self.torch = torch
        self.armed = False
        self.out = {}

    def wrap(self, name, fn):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch

        def call(*args):
            if not self.armed or name in self.out:
                return fn(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                res = fn(*args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            dev = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
            self.out[name] = (sum(e.self_device_time_total for e in dev), wall * 1e3)
            return res
        return call


def all_decoding(eng) -> bool:
    return not eng._jobs and not eng.waiting and int(eng._active.sum()) == 8


def spec_f32(torch, model, params):
    """Speculative decode in f32 on the card: tokens against the same
    engine's plain run and the CPU's under the tie rule, counters (host
    syncs included) equal to the CPU's.  Twice: with the rank-384 boundary
    codec, which the draft (the full stack under the end mask) never runs:
    on random weights the codec moves nearly every token, so rounds reject;
    and without it, where the draft differs from the model by the end mask
    alone (3 of 8 experts) and rounds both accept and reject.  The CPU runs
    the second only (its speculative path is the first's less the codec,
    which the stream phases hold card against CPU), at ``SPEC_CPU_LAYERS``
    layers beside a card run of that depth."""
    from repro_torch.models.model import Model, to_device

    cfg = model.cfg.replace(dtype="float32")
    small = cfg.replace(num_layers=SPEC_CPU_LAYERS)
    sparams = first_layers(params, SPEC_CPU_LAYERS // len(cfg.layer_pattern))
    runs_of = {"spec": (cfg, "cuda", SPEC, params),
               "plain": (cfg, "cuda", {"link_rtt_s": 0.05}, params),
               "card": (small, "cuda", SPEC, sparams),
               "cpu": (small, "cpu", SPEC, to_device(sparams, "cpu"))}
    for name, rank in (("codec rank 384", 384), ("no codec", 0)):
        runs = {}
        for tag in ("spec", "plain") if rank else ("spec", "plain", "card", "cpu"):
            c, dev, kw, p = runs_of[tag]
            t0 = time.perf_counter()
            eng = spec_engine(Model(c, device=dev), p, rank=rank, **kw)
            reqs = stream_requests(cfg.vocab_size, 8, 0, 32, hi=SPEC_HI)
            tokens = drive(eng, reqs)
            met = eng.metrics()
            runs[tag] = (tokens, met, eng, reqs)
            log(f"spec run f32, {name} ({tag}, {dev}, {c.num_layers} layers): "
                f"{time.perf_counter() - t0:.1f} s, "
                f"{int(eng.tiers.end_mask.sum())} mask experts, "
                f"{ {k: met[k] for k in SPEC_COUNTERS} }")
            if met["kv_pages_in_use"] or not all(len(t) == 32 for t in tokens):
                raise AssertionError(f"spec run f32 ({tag}): pages left mapped or a request "
                                     "short")
        spec, plain, card, host = (runs["spec"], runs["plain"], runs.get("card"),
                                   runs.get("cpu"))
        m = spec[1]
        if not (m["spec_plan_k"] > 1 and m["spec_rounds"] > 0):
            raise AssertionError(f"spec run f32, {name}: no speculative round ran: {m}")
        if m["spec_rollbacks"] == 0 or (rank == 0 and m["spec_accepted"] == 0):
            raise AssertionError(f"spec run f32, {name}: the accept and reject paths did not "
                                 f"both run: {m}")
        if plain[1]["spec_rounds"] != 0:
            raise AssertionError("spec run f32: the plain run speculated")
        equal_or_tie(torch, spec[2], spec[3], spec[0], plain[0],
                     f"spec run f32, {name}, spec vs plain")
        if host is None:
            continue
        got = {k: card[1][k] for k in SPEC_COUNTERS}
        want = {k: host[1][k] for k in SPEC_COUNTERS}
        if got != want:
            raise AssertionError(f"spec run f32, {name}: card counters {got}, CPU {want}")
        log(f"spec run f32, {name}: at {SPEC_CPU_LAYERS} layers the card's counters equal "
            f"the CPU's; acceptance at full depth {m['spec_accepted']} of "
            f"{m['spec_drafted']} drafts")
        equal_or_tie(torch, card[2], card[3], card[0], host[0],
                     f"spec run f32, {name}, card vs CPU at {SPEC_CPU_LAYERS} layers")


def spec_bf16(torch, model, params, counters):
    """Speculative decode in bf16 with the expert pool and the three int8
    streams: it completes, the pools drain, the path's kernels launch (a
    histogram of paged attention's rows a slot), and one profiled round's
    stages beside a plain round's.  Returns the run's launch counts."""
    from repro_torch.models import attention as attn

    rows = {}
    chunk_attn = attn.paged_chunk_attention

    def count_rows(q, *args, **kw):
        rows[q.shape[1]] = rows.get(q.shape[1], 0) + 1
        return chunk_attn(q, *args, **kw)

    prof = RoundProfiler(torch)
    for c in counters:
        c.launches = 0
    attn.paged_chunk_attention = count_rows
    try:
        t0 = time.perf_counter()
        eng = spec_engine(model, params, **SPEC, **QUANT)
        make = eng._spec_fns_for_k

        def wrapped(k):
            fns = make(k)
            return tuple(prof.wrap(f"{n} (k={k})", f) for n, f in
                         zip(("draft scan", "end chunk", "cloud verify"), fns))

        eng._spec_fns_for_k = wrapped

        def arm(e, tick):
            prof.armed = all_decoding(e)

        reqs = stream_requests(model.cfg.vocab_size, 8, 0, 32)
        tokens = drive(eng, reqs, hook=arm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attn.paged_chunk_attention = chunk_attn
    launches = {c.__name__: c.launches for c in counters}
    m = eng.metrics()
    log(f"spec run bf16 (expert pool, int8 streams): {wall:.1f} s, "
        f"{ {k: m[k] for k in SPEC_COUNTERS} }; launches {launches}; paged attention calls "
        f"by rows a slot {dict(sorted(rows.items()))}")
    if m["kv_pages_in_use"] or not all(len(t) == 32 for t in tokens):
        raise AssertionError("spec run bf16: pages left mapped or a request short")
    if m["spec_rounds"] == 0 or not any(c > 1 and c < eng.prefill_chunk for c in rows):
        raise AssertionError("spec run bf16: no speculative round ran")
    only_path("spec run bf16", launches, SPEC_PATH)
    if launches["flash_attention_fwd"] % (model.cfg.block_repeat * len(model.cfg.layer_pattern)):
        raise AssertionError("spec run bf16: flash attention launches are not whole prefills")

    # a plain round at the same settings, profiled once 8 slots decode
    plain = RoundProfiler(torch)
    peng = spec_engine(model, params, link_rtt_s=SPEC["link_rtt_s"], **QUANT)
    peng._end_step = plain.wrap("end step", peng._end_step)
    peng._cloud_step = plain.wrap("cloud step", peng._cloud_step)
    for r in stream_requests(model.cfg.vocab_size, 8, 0, 32):
        peng.submit(r)
    for _ in range(400):
        plain.armed = all_decoding(peng)
        peng.step()
        if len(plain.out) == 2:
            break
    del peng
    spec_us = sum(us for us, _ in prof.out.values())
    plain_us = sum(us for us, _ in plain.out.values())
    log("spec round profile (bf16, int8 streams, 8 slots decoding; device us, wall ms a "
        "stage call): " + "; ".join(f"{n} {us:.1f} us, {ms:.3f} ms" for n, (us, ms)
                                    in {**prof.out, **plain.out}.items())
        + f"; a speculative round {spec_us:.1f} us of device time against a plain round's "
        f"{plain_us:.1f}")
    if len(prof.out) != 3 or len(plain.out) != 2:
        raise AssertionError(f"spec round profile: stages read {sorted(prof.out)}, "
                             f"{sorted(plain.out)}")
    return launches


def preempt_run(model, params, **kw):
    """8 low-priority requests decoding in every slot, then 2 interactive
    ones; returns (tokens, engine, host seconds of each spill and restore)."""
    eng = spec_engine(model, params, **kw)
    low = stream_requests(model.cfg.vocab_size, 8, 2, 16, hi=SPEC_HI)
    high = stream_requests(model.cfg.vocab_size, 2, 3, 8, hi=SPEC_HI, base=100)
    for r in low:
        r.priority = 2
        eng.submit(r)
    for r in high:
        r.priority = 0
    times = {"spill": [], "restore": []}
    for name, attr in (("spill", "_spill_slot_state"), ("restore", "_restore_into_slot")):
        fn = getattr(eng, attr)

        def timed(*args, fn=fn, name=name):
            eng._sync()
            t = time.perf_counter()
            out = fn(*args)
            eng._sync()
            times[name].append(time.perf_counter() - t)
            return out
        setattr(eng, attr, timed)
    while not (all_decoding(eng) and all(len(r.generated) >= 2 for r in low)):
        eng.step()
    tokens = drive(eng, high)
    return [list(r.generated) for r in low] + tokens, eng, times


def preemption(torch, model, params):
    """Phase 8's preemption, in f32, dense and int8 KV pools: 2 spills and
    2 restores; tokens equal a run without preemption under the tie rule;
    the pools drain; at ``SPEC_CPU_LAYERS`` layers the card's counters,
    spill bytes and tokens equal the CPU run's."""
    from repro_torch.models.model import Model, to_device

    cfg32 = model.cfg.replace(dtype="float32")
    small = cfg32.replace(num_layers=SPEC_CPU_LAYERS)
    sparams = first_layers(params, SPEC_CPU_LAYERS // len(cfg32.layer_pattern))
    card, scard, host = (Model(cfg32, device="cuda"), Model(small, device="cuda"),
                         Model(small, device="cpu"))
    hparams = to_device(sparams, "cpu")
    for kw in ({}, {"quantize_kv": True}):
        t0 = time.perf_counter()
        tokens, eng, times = preempt_run(card, params, **kw)
        ref, _, _ = preempt_run(card, params, preemption=False, **kw)
        stok, seng, _ = preempt_run(scard, sparams, **kw)
        htok, heng, _ = preempt_run(host, hparams, **kw)
        m, sm, hm = eng.metrics(), seng.metrics(), heng.metrics()
        counts = [(x["preemptions"], x["preempt_restores"], x["preempt_spill_bytes"])
                  for x in (m, sm, hm)]
        log(f"preemption (f32, {kw or 'dense pools'}): {time.perf_counter() - t0:.1f} s; "
            f"preemptions, restores, spill bytes {counts[0]} ({SPEC_CPU_LAYERS} layers: card "
            f"{counts[1]}, CPU {counts[2]}); host ms a spill "
            f"{[round(t * 1e3, 3) for t in times['spill']]}, a restore "
            f"{[round(t * 1e3, 3) for t in times['restore']]}")
        if counts[0][:2] != (2, 2) or counts[1] != counts[2] or counts[1][:2] != (2, 2):
            raise AssertionError(f"preemption {kw}: counters {counts}")
        if m["kv_pages_in_use"] or sm["kv_pages_in_use"] or hm["kv_pages_in_use"]:
            raise AssertionError(f"preemption {kw}: pages left mapped")
        reqs = (stream_requests(cfg32.vocab_size, 8, 2, 16, hi=SPEC_HI)
                + stream_requests(cfg32.vocab_size, 2, 3, 8, hi=SPEC_HI, base=100))
        equal_or_tie(torch, eng, reqs, tokens, ref, f"preemption {kw}, against no preemption")
        equal_or_tie(torch, seng, reqs, stok, htok,
                     f"preemption {kw}, card vs CPU at {SPEC_CPU_LAYERS} layers")


def spec_and_preempt(torch, model, params, counters):
    """Phase 8; returns the bf16 speculative run's launch counts."""
    t0 = time.perf_counter()
    spec_f32(torch, model, params)
    log(f"spec f32 runs took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = spec_bf16(torch, model, params, counters)
    log(f"spec bf16 runs took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    preemption(torch, model, params)
    log(f"preemption runs took {time.perf_counter() - t0:.1f} s")
    return launches

# -- phase 9: the fleet -----------------------------------------------------

FLEET_ENDS = ("jetson-orin", "jetson-orin", "phone-soc")
# the planner gives split 1 on every lane (each plans against 2/3 of the
# a100); lane 1 is pinned at 2, so two interior splits share the cloud
FLEET_SPLITS = (1, 2, 1)
FLEET_PEER_GBPS = 1.0  # modeled end<->end LAN (each lane's uplink: 0.1 or 0.05)
FLEET_N, FLEET_RATE = 48, 4000.0  # Poisson requests/s on the modeled clock
FLEET_SKEW_TICKS = (2, 6)  # lane 0, then lane 1, turns hot on expert group 2
FLEET_F32_PATH = ("paged_attention", "group_gate", "grouped_mlp", "grouped_mlp_resident",
                  "lowrank_encode", "lowrank_decode")
FLEET_BF16_PATH = ("paged_attention_quant", "paged_write_quant", "group_gate", "grouped_mlp",
                   "grouped_mlp_resident_quant", "lowrank_encode_quant", "lowrank_decode_quant",
                   "quantize_rows")
FLEET_COUNTERS = ("splits", "replan_events", "preemptions", "preempt_restores",
                  "preempt_spill_bytes", "expert_prefetches", "expert_peer_fetches",
                  "expert_bytes_peer", "expert_bytes_down", "expert_unique_residents",
                  "n_host_syncs", "n_placed", "tokens", "kv_pages_in_use")


def fleet_schedule(vocab, n=FLEET_N):
    """``n`` requests at ``FLEET_RATE`` (Poisson, seed 9), the interactive
    and batch classes of ``benchmarks/serve_load.py`` (seed 10)."""
    from repro_torch.serving import loadgen

    arr = loadgen.poisson_arrivals(n, FLEET_RATE, seed=9)
    return loadgen.build_schedule(arr, (loadgen.INTERACTIVE, loadgen.BATCH), seed=10, vocab=vocab)


def fleet_run(torch, model, params, *, profile_tick=None, n=FLEET_N, faults=(), watch=None,
              **kw):
    """The seeded schedule of ``n`` requests through a fresh three-lane
    fleet, driven by ``loadgen.drive`` on a ``VirtualClock``:
    ``stream_engine``'s settings on each lane (8 slots in 2 groups, 16-token
    pages, prefill chunk 32, max_len 256, the rank-384 codec unless
    ``compression_rank`` says otherwise), an a100 cloud of two servers,
    modeled stage times, priority admission with preemption, the expert
    pools under the fleet registry.  Before tick ``FLEET_SKEW_TICKS[i]``
    lane i's measured routing turns hot on group 2 and its mask is
    re-derived, so lane 1's new slabs come from lane 0 over the LAN.
    ``faults`` (``(t_s, kind, kwargs)`` events) fire through a bound
    ``ChaosInjector``, the layouts ``fail_cloud_server`` returns are kept
    in ``fleet.lost_server_shards`` and the pages of the slots a crash
    parks are counted in ``fleet.migrated_pages``; ``watch(fleet, tick)``
    runs after each tick.  ``profile_tick(fleet)`` (a predicate) profiles the first
    tick that starts where it holds, and the first such tick with no
    request waiting either, which runs decode steps only and replaces it.
    Returns (requests, fleet, ticks, (tick, slots decoding, (end steps,
    cloud steps, prefill chunks), decode only, profiler averages, wall s) or
    None)."""
    import numpy as np

    from repro_torch.core.hardware import PROFILES
    from repro_torch.serving import FleetServingEngine, VirtualClock, loadgen
    from repro_torch.serving.faults import ChaosInjector, FaultEvent, FaultSchedule

    cfg = model.cfg
    kw.setdefault("compression_rank", 384)
    fleet = FleetServingEngine(
        model, params, end_profiles=[PROFILES[n] for n in FLEET_ENDS],
        cloud_profile=PROFILES["a100"], cloud_servers=2, max_batch=8,
        n_groups=2, page_size=16, prefill_chunk=32, max_len=256, timing="modeled",
        clock=VirtualClock(), force_splits=FLEET_SPLITS, expert_peer_gbps=FLEET_PEER_GBPS, **kw)
    fleet.lost_server_shards = []
    fleet.migrated_pages = 0
    if faults:
        ChaosInjector(FaultSchedule([FaultEvent(t, k, **a) for t, k, a in faults]), fleet)
        fail_server = fleet.fail_cloud_server

        def failed_server():
            fleet.lost_server_shards.append(fail_server())
            return fleet.lost_server_shards[-1]

        fleet.fail_cloud_server = failed_server
        fail_lane = fleet.fail_lane

        def failed_lane(device):
            before = set(fleet._migrating)
            fail_lane(device)
            fleet.migrated_pages += sum(len(fleet._migrating[r].entries)
                                        for r in set(fleet._migrating) - before)

        fleet.fail_lane = failed_lane
    E, K = cfg.moe.num_experts, cfg.moe.num_groups
    gf, ef = np.zeros(K), np.zeros(E)
    gf[2] = 1.0
    ef[2 * (E // K):3 * (E // K)] = K / E
    step, state = fleet.step, {"tick": 0, "prof": None}

    fleet.tick_log = []

    def stepped():
        t = state["tick"]
        state["tick"] += 1
        for i, at in enumerate(FLEET_SKEW_TICKS):
            if t == at:
                lane = fleet.lanes[i]
                lane._group_freq, lane._route_freq = gf.copy(), ef.copy()
                fleet.update_device_state(i, type(lane.end_state)())
        # the clock the injector reads at this tick, and the lanes then
        fleet.tick_log.append({"t": fleet.clock(),
                               "active": [int(l._active.sum()) for l in fleet.lanes],
                               "fallbacks": fleet.expert_registry.peer_fault_fallbacks})
        only = not fleet.waiting and not any(l.waiting for l in fleet.lanes)
        if (profile_tick is not None and (state["prof"] is None or (only and not state["prof"][3]))
                and profile_tick(fleet)):
            from torch.profiler import ProfilerActivity, profile

            live = [l for i, l in enumerate(fleet.lanes) if fleet.lane_alive[i]]
            slots = sum(int(l._active.sum()) for l in live)
            # the groups with a boundary in flight drain on the cloud this tick
            clouds = sum(p == "boundary" for l in live for p in l._phase)
            before = [sum(getattr(l, k) for l in fleet.lanes)
                      for k in ("n_stage_steps", "n_prefill_chunks")]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ends, chunks = (sum(getattr(l, k) for l in fleet.lanes) - b for k, b in
                            zip(("n_stage_steps", "n_prefill_chunks"), before))
            state["prof"] = (t, slots, (ends, clouds, chunks), only, prof.key_averages(), wall)
        else:
            out = step()
        if watch is not None:
            watch(fleet, t)
        return out

    fleet.step = stepped
    reqs = loadgen.drive(fleet, fleet_schedule(cfg.vocab_size, n))
    return reqs, fleet, state["tick"], state["prof"]


def fleet_decoding(fleet) -> bool:
    """Every lane has decoding slots and no lane a prefill in flight."""
    return all(l._active.any() and not l._jobs for l in fleet.lanes)


def fleet_record(fleet, reqs):
    """What the card's f32 run must share with the CPU's: the counters, the
    placement log and every request's stamps."""
    m = fleet.metrics()
    return {
        "counters": {k: m[k] for k in FLEET_COUNTERS},
        "replans": fleet.replan_events,
        "placed": [(p["request_id"], p["device"], p["priority"]) for p in fleet.placed],
        "stamps": [(r.submit_time, r.first_token_time, r.finish_time) for r in reqs],
    }


def fleet_f32(torch, model, params, counters):
    """Phase 9 in f32 on the card (chaos_f32 holds the same engine, card
    against CPU, under faults)."""
    from repro_torch.core.hardware import PROFILES, DeviceState, capability
    from repro_torch.core.pipeline import plan_fleet_splits
    from repro_torch.models.model import Model

    cfg32 = model.cfg.replace(dtype="float32")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    treqs, tfleet, ticks, _ = fleet_run(torch, Model(cfg32, device="cuda"), params)
    wall = time.perf_counter() - t0
    trec = fleet_record(tfleet, treqs)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    log(f"fleet f32 (cuda): {wall:.1f} s, {ticks} ticks, {trec['counters']}; peak device memory "
        f"{peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} MiB above the "
        f"{held / 2**20:.1f} MiB held before the fleet was built (one cloud storage of "
        f"{tfleet.cloud_pool.num_pages} pages behind the three lanes); launches {launches}")
    zero = [k for k in FLEET_F32_PATH if launches[k] == 0]
    if zero:
        raise AssertionError(f"fleet f32: path kernels not launched: {zero}")
    lanes = tfleet.lanes
    planned = plan_fleet_splits(
        lanes[0].tiers.layer_gflops, lanes[0].tiers.boundary_bytes,
        [l.tiers.end_cap for l in lanes], capability(PROFILES["a100"], DeviceState()),
        cloud_servers=2, compression_ratio=lanes[0].tiers.compression_ratio, edge_boundary=True)
    log(f"fleet splits: planned {[p.split_layer for p in planned]} (plan_fleet_splits), "
        f"forced {list(FLEET_SPLITS)}, run {trec['counters']['splits']}; cloud slot bases "
        f"{[l._cloud_base for l in lanes]}; placements by device "
        f"{[sum(p[1] == d for p in trec['placed']) for d in range(len(lanes))]}")
    c = trec["counters"]
    if not (c["expert_peer_fetches"] > 0 and c["preemptions"] > 0):
        raise AssertionError(f"fleet f32: the peer and preemption paths did not both run: {c}")
    if c["kv_pages_in_use"] or len(set(trec["counters"]["splits"])) < 2 or not all(
            0 < s < model.cfg.block_repeat for s in c["splits"]):
        raise AssertionError(f"fleet f32: pages left mapped or splits not interior: {c}")
    if any(not r.done or len(r.generated) != r.max_new_tokens for r in treqs):
        raise AssertionError("fleet f32: a request did not finish with its tokens")
    if any(any(x is None for x in st) for st in trec["stamps"]):
        raise AssertionError("fleet f32: a request lacks a stamp")
    log(f"fleet f32: {len(trec['placed'])} placements, {len(trec['replans'])} replan events, "
        f"all {len(treqs)} requests finished and stamped")


def fleet_bf16(torch, model, params, counters, tick_profiles):
    """Phase 9 in bf16 with the three int8 streams: completes, drains,
    summarizes the classes on the modeled clock, launches the path's
    kernels and no other, and one profiled fleet tick beside phases 6-7's
    single-engine ticks (``tick_profiles``, which gains it).  Returns the
    run's launch counts."""
    from repro_torch.serving import loadgen

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    reqs, fleet, ticks, prof = fleet_run(torch, model, params, profile_tick=fleet_decoding,
                                         **QUANT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    m = fleet.metrics()
    log(f"fleet bf16 (int8 streams): {wall:.1f} s, {ticks} ticks, "
        f"{ {k: m[k] for k in FLEET_COUNTERS} }; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
        f"{(torch.cuda.max_memory_allocated() - held) / 2**20:.1f} MiB above the "
        f"{held / 2**20:.1f} MiB held before the fleet was built; launches {launches}")
    if m["kv_pages_in_use"] or any(not r.done or len(r.generated) != r.max_new_tokens
                                   for r in reqs):
        raise AssertionError("fleet bf16: pages left mapped or a request short")
    only_path("fleet bf16", launches, FLEET_BF16_PATH)
    for name, prio in (("interactive", 0), ("batch", 2), ("all", None)):
        s = loadgen.summarize(reqs, priority=prio)
        log(f"fleet bf16 summarize, {name} (modeled clock, not the card's speed): n {s['n']}, "
            f"TTFT p50/p90/p99 {s['ttft_p50'] * 1e3:.3f}/{s['ttft_p90'] * 1e3:.3f}/"
            f"{s['ttft_p99'] * 1e3:.3f} ms, TPOT p50/p90/p99 {s['tpot_p50'] * 1e3:.3f}/"
            f"{s['tpot_p90'] * 1e3:.3f}/{s['tpot_p99'] * 1e3:.3f} ms, sustained "
            f"{s['sustained_tok_s']:.1f} tokens/s, preemptions {s['preemptions']}")
    if prof is None:
        raise AssertionError("fleet bf16: no tick had every lane decoding and no prefill")
    tick_profiles["fleet (phase 9, three lanes)"] = log_fleet_tick(
        prof, "fleet bf16", "every lane decoding", "fleet_profile.txt", tick_profiles)
    return launches


def log_fleet_tick(prof, tag, when, name, tick_profiles):
    """Log a profiled fleet tick (``fleet_run``'s record) beside the ticks
    of ``tick_profiles`` and write its table to ``chiprun_out/name``;
    returns (device ms, wall ms)."""
    from torch.autograd import DeviceType

    ptick, slots, calls, only, avgs, pwall = prof
    dev = [e for e in avgs if e.device_type != DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in dev)
    (OUT_DIR / name).write_text(avgs.table(sort_by="cuda_time_total", row_limit=40))
    base = ", ".join(f"{t} {d:.3f} ms of {w:.3f} ms" for t, (d, w) in tick_profiles.items())
    in_path = kernels_in_path(dev, (
        *ffn_kernels("resident FFN", "signed char"),
        *ffn_kernels("cloud expert FFN", "__nv_bfloat16"),
        *PAGED_KERNELS, *GATE_KERNELS, ("KV write", ("paged_write_quant_kernel<",), ()),
        *CODEC_QUANT_KERNELS))
    what = ("decode steps only" if only
            else "decode steps and the prefill chunks of requests admitted in the tick")
    ends, clouds, chunks = calls
    n_calls = ends + clouds + 2 * chunks  # a prefill chunk: one end and one cloud call
    log(f"{tag} profile (tick {ptick}, {when}, {slots} slots, {ends} end "
        f"steps, {clouds} cloud steps, {chunks} prefill chunks: {what}): device time "
        f"{dev_us / 1e3:.3f} ms of {pwall * 1e3:.3f} ms wall "
        f"({dev_us / 1e3 / (pwall * 1e3):.1%} busy; {dev_us / 1e3 / max(n_calls, 1):.3f} ms of "
        f"device time a stage call); kernels in path, a launch: {in_path}; beside the "
        f"profiled ticks of earlier phases (the single engine's in phases 6-7: 8 slots, 2 end "
        f"and 2 cloud steps): {base}; written to chiprun_out/{name}")
    return dev_us / 1e3, pwall * 1e3


def fleet_phase(torch, model, params, counters, tick_profiles):
    """Phase 9; returns the bf16 fleet run's launch counts."""
    t0 = time.perf_counter()
    fleet_f32(torch, model, params, counters)
    log(f"fleet f32 runs took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = fleet_bf16(torch, model, params, counters, tick_profiles)
    log(f"fleet bf16 run took {time.perf_counter() - t0:.1f} s")
    return launches



# -- phase 10: chaos on the fleet ---------------------------------------------

CHAOS_N = 32  # phase 9's schedule with fewer requests (the phase's seconds)
# the declared schedule, after benchmarks/serve_chaos.py::_fault_schedule
# and extended to every kind of event: the peer fault is armed at once and
# meets the first peer fetch; flaky uploads on lane 0; lane 1 (split 2)
# dies while it decodes, its slots migrate onto the split-1 lanes, and it
# recovers cold three ticks or more later; one of the two cloud servers is
# lost; lane 0's link blacks out (split 0) and recovers.  An event fires at the first tick whose modeled
# clock (the driver moves it to the timeline's makespan after each tick)
# has passed it; slab transfers book seconds of a jetson-orin uplink ahead
# of the decode, so the clock leaps and then stands still for ticks.  The
# times, in modeled seconds, are each run's own (f32 slabs and the exact
# boundary, or int8 slabs and the rank-384 codec), placed on its own
# timeline by ``chaos_calibrate`` so that each fault lands on a tick of its
# own (``python3 chip_smoke.py --chaos-timeline`` prints them)
CHAOS_TIMES = {
    "f32": {"transfer_flaky": 0.004929733406140636, "lane_crash": 0.07195924730043123,
            "lane_recover": 3.163465653972841, "cloud_server_loss": 4.679420052286961,
            "link_blackout": 7.02484168428696, "link_recover": 14.964688219244909},
    "bf16": {"transfer_flaky": 0.0014916534061406366, "lane_crash": 0.039782727788909865,
             "lane_recover": 0.8376547676685682, "cloud_server_loss": 1.2215641996784141,
             "link_blackout": 1.8135742476784142, "link_recover": 2.818139118636363},
}
# the bf16 chaos run's kernels: phase 9's, and the blacked-out lane's split
# 0, whose plan has no codec, takes the int8 boundary through the
# standalone quantizer and dequantizer
CHAOS_BF16_PATH = FLEET_BF16_PATH + ("dequantize_rows",)
CHAOS_KEYS = ("lane_failures", "lane_recoveries", "migrations", "migration_restores",
              "migration_spill_bytes", "transfer_retries", "degraded_ticks", "link_blackout_s",
              "cloud_server_failures")


def chaos_faults(times):
    """The declared events at ``times`` (a ``CHAOS_TIMES`` entry, or part of
    one) as ``fleet_run``'s ``faults``; the peer fault is armed at 0."""
    from repro_torch.core.hardware import PROFILES

    args = {"transfer_flaky": dict(device=0, count=3), "cloud_server_loss": {},
            "link_blackout": dict(device=0),
            "link_recover": dict(device=0, gbps=PROFILES[FLEET_ENDS[0]].net_gbps),
            "lane_crash": dict(device=1), "lane_recover": dict(device=1)}
    return ((0.0, "peer_fetch_fail", dict(count=1)),
            *((t, kind, args[kind]) for kind, t in times.items()))


# the order the events are placed in by ``chaos_calibrate``, each with the
# condition its tick must meet (on ``fleet.tick_log``'s entry).  The clock
# moves only while some lane's uplink is booked past it, at first lane 0's
# (its slab refill), later lane 1's: lane 1 goes down and comes back early,
# while lane 0's backlog still moves the clock, and its cold refill moves
# it again for the events after
CHAOS_PLAN = (
    ("transfer_flaky", lambda e: True),
    ("lane_crash", lambda e: e["active"][1] > 0),  # while lane 1 decodes
    ("lane_recover", lambda e: True),
    # once the armed peer fault met a peer fetch (lane 1's cold refill from
    # lane 0): a blackout's split 0 drops lane 0's slabs
    ("cloud_server_loss", lambda e: e["fallbacks"] >= 1),
    ("link_blackout", lambda e: True),
    ("link_recover", lambda e: True),
)


def chaos_calibrate(torch, model, params, kind, **kw):
    """Time the declared events on one run's own timeline: each in turn
    (``CHAOS_PLAN``), run the fleet with the events placed so far and put
    the next one halfway between the starts of the first qualifying tick
    after the previous event's and of the tick before it, where the clock
    moved (the events before it leave the timeline up to that tick as it
    was, so it fires there); lane 1 stays down for three ticks at least.
    Returns ``{event: modeled s}`` for ``CHAOS_TIMES[kind]``."""
    times, prev = {}, 0
    for name, ok in CHAOS_PLAN:
        _, fleet, _, _ = fleet_run(torch, model, params, n=CHAOS_N,
                                   faults=chaos_faults(times), **kw)
        log_ = fleet.tick_log
        first = prev + (3 if name == "lane_recover" else 1)
        k = next((k for k in range(max(first, 1), len(log_))
                  if ok(log_[k]) and log_[k]["t"] > log_[k - 1]["t"]), None)
        if k is None:
            raise AssertionError(f"chaos calibration ({kind}): no tick for {name} after "
                                 f"tick {prev}")
        times[name] = (log_[k - 1]["t"] + log_[k]["t"]) / 2
        log(f"chaos calibration ({kind}): {name} at {times[name]!r} (tick {k}, starts "
            f"{log_[k - 1]['t']!r} / {log_[k]['t']!r})")
        prev = k
    return times


def chaos_watch(torch, state, timeline=False):
    """``fleet_run``'s ``watch`` for phase 10: device memory right after the
    shared storage grew to split 0, the pages of the slots a crash parked,
    and with ``timeline`` one line a tick (the modeled clock and each
    lane's state)."""

    def watch(fleet, tick):
        kv = fleet.cloud_kv
        if "reserve0" not in state and kv.base == 0 and str(kv.device).startswith("cuda"):
            torch.cuda.synchronize()
            state["reserve0"] = (tick, torch.cuda.memory_allocated(),
                                 torch.cuda.max_memory_allocated())
        if timeline:
            lanes = " | ".join(
                f"{'up' if fleet.lane_alive[i] else 'DOWN'} s{l.split} act {int(l._active.sum())} "
                f"jobs {len(l._jobs)} wait {len(l.waiting)} peer {l.n_expert_peer_fetches} "
                f"q {len(l._prefetch_queue)} up {l.link.transfers}"
                for i, l in enumerate(fleet.lanes))
            log(f"  tick {tick} t {fleet.clock():.6f} next {fleet.timeline.makespan_s:.6f} "
                f"front {len(fleet.waiting)} "
                f"park {len(fleet._migrating)} fired {len(fleet.chaos.fired) if fleet.chaos else 0}"
                f" :: {lanes}")
    return watch


def chaos_record(fleet, reqs):
    """What the card's f32 chaos run must share with the CPU's."""
    m = fleet.metrics()
    return {
        "fired": fleet.chaos.fire_log() if fleet.chaos else [],
        "placed": [(p["request_id"], p["device"], p["priority"]) for p in fleet.placed],
        "replans": fleet.replan_events,
        "faults": {k: m[k] for k in CHAOS_KEYS},
        "peer_fault_fallbacks": fleet.expert_registry.peer_fault_fallbacks,
        "counters": {k: m[k] for k in FLEET_COUNTERS},
        "shards": fleet.lost_server_shards,
        "stamps": [(r.submit_time, r.first_token_time, r.finish_time) for r in reqs],
    }


def chaos_checks(tag, fleet, reqs):
    """Exactly once, drained, every declared fault met live traffic."""
    m = fleet.metrics()
    ids = [r.request_id for r in fleet.finished]
    if sorted(ids) != sorted(r.request_id for r in reqs) or len(ids) != len(set(ids)):
        raise AssertionError(f"{tag}: a request finished twice or never")
    if any(not r.done or len(r.generated) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{tag}: a request finished short")
    if m["kv_pages_in_use"] or fleet._migrating or fleet.chaos.pending:
        raise AssertionError(f"{tag}: pages left mapped ({m['kv_pages_in_use']}), migrations "
                             f"parked ({len(fleet._migrating)}) or faults not fired "
                             f"({fleet.chaos.pending})")
    blacked = any(ev["device"] == 0 and ev["new_split"] == 0 for ev in fleet.replan_events)
    hit = {
        "migration": m["migrations"] >= 1 and m["migration_spill_bytes"] > 0,
        "restores": m["migration_restores"] == m["migrations"],
        "crash and recovery": m["lane_failures"] == m["lane_recoveries"] == 1,
        "blackout to split 0": blacked and m["degraded_ticks"] > 0,
        "transfer retries": m["transfer_retries"] >= 1,
        "cloud server loss": m["cloud_server_failures"] == 1 and fleet.cloud_servers == 1,
        "peer fault": fleet.expert_registry.peer_fault_fallbacks >= 1,
    }
    missed = [k for k, ok in hit.items() if not ok]
    if missed:
        raise AssertionError(f"{tag}: faults that did not meet live traffic: {missed}; "
                             f"{ {k: m[k] for k in CHAOS_KEYS} }")


def placements(fleet):
    out = {}
    for p in fleet.placed:
        out.setdefault(p["request_id"], []).append(p["device"])
    return out


def chaos_f32(torch, model, params, counters, timeline=False):
    """Phase 10 in f32 with the exact boundary: a clean and a chaos run on
    the card (the card-vs-CPU comparison of the chaos run, 60 s of CPU at
    full width, is ``tests/test_torch_cuda.py``'s
    ``test_fleet_chaos_on_card_matches_cpu`` at smoke size).  Returns the
    card chaos run's migrated bytes a spilled page."""
    from repro_torch.models.model import Model
    from repro_torch.serving import loadgen

    cfg32 = model.cfg.replace(dtype="float32")
    runs = {}
    for tag in ("clean", "chaos"):
        gc.collect()
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        state = {}
        t0 = time.perf_counter()
        reqs, fleet, ticks, _ = fleet_run(
            torch, Model(cfg32, device="cuda"), params,
            n=CHAOS_N, faults=chaos_faults(CHAOS_TIMES["f32"]) if tag == "chaos" else (),
            compression_rank=0, watch=chaos_watch(torch, state, timeline))
        wall = time.perf_counter() - t0
        rec = chaos_record(fleet, reqs)
        runs[tag] = (reqs, fleet, rec)
        got = {c.__name__: c.launches for c in counters}
        zero = [k for k in FLEET_F32_PATH if k not in ("lowrank_encode", "lowrank_decode")
                and got[k] == 0]
        if zero:
            raise AssertionError(f"chaos f32 {tag}: path kernels not launched: {zero}")
        log(f"chaos f32 {tag} (cuda): {wall:.1f} s, {ticks} ticks, modeled end "
            f"{fleet.clock():.4f} s, faults {rec['faults']}, peer fault fallbacks "
            f"{rec['peer_fault_fallbacks']}, {rec['counters']}; launches {got}")
        if tag == "chaos":
            log(f"chaos f32 (cuda) fire log (modeled s): "
                f"{[(d['kind'], d['device'], d['t_s'], round(d['t_fired_s'], 6)) for d in rec['fired']]}"
                f"; replans {[(ev['device'], ev['old_split'], ev['new_split']) for ev in rec['replans']]}"
                f"; server-loss shards {rec['shards']}")
    (creqs, cfleet, crec), (kreqs, kfleet, _) = runs["chaos"], runs["clean"]
    chaos_checks("chaos f32 (card)", cfleet, creqs)
    chaos_vs_clean(torch, cfleet, creqs, kfleet, kreqs)
    window = [d["t_fired_s"] for d in crec["fired"] if d["kind"] in ("lane_crash", "lane_recover")]
    window = window[1] - window[0] + crec["faults"]["link_blackout_s"]
    p99 = [loadgen.summarize(r, priority=0)["ttft_p99"] for r in (kreqs, creqs)]
    log(f"chaos f32: interactive TTFT p99 on the modeled clock (not the card's speed): clean "
        f"{p99[0] * 1e3:.3f} ms, chaos {p99[1] * 1e3:.3f} ms, fault window (crash outage + "
        f"blackout) {window * 1e3:.3f} ms; serve_chaos's bound clean + window + 50 ms "
        f"{'holds' if p99[1] <= p99[0] + window + 0.05 else 'does not hold'}")
    return crec["faults"]["migration_spill_bytes"] / max(cfleet.migrated_pages, 1)


def chaos_vs_clean(torch, cfleet, creqs, kfleet, kreqs):
    """Chaos against clean on the card: every request once, and the tokens
    of every request the faults did not move equal, or differ first at a
    near tie.  A fault moves a request's tokens where it changes the tiers
    that compute them: the end tier runs its lane's expert mask, so a
    request migrated or placed on another lane, or decoding on a lane whose
    split a fault moved, meets other experts (``serve_chaos``'s affected
    set, read off the placement log and the replan events)."""
    if [r.request_id for r in creqs] != [r.request_id for r in kreqs]:
        raise AssertionError("chaos f32: the schedules differ")
    cp, kp = placements(cfleet), placements(kfleet)

    def moves(fleet):
        return [[(ev["old_split"], ev["new_split"], ev["mask_changed"])
                 for ev in fleet.replan_events if ev["device"] == d]
                for d in range(fleet.n_devices)]

    replanned = {d for d, (a, b) in enumerate(zip(moves(cfleet), moves(kfleet))) if a != b}
    affected = {r.request_id for r in creqs
                if cp.get(r.request_id) != kp.get(r.request_id)
                or len(cp.get(r.request_id, [])) > 1
                or replanned & set(cp.get(r.request_id, []))}
    keep = [i for i, r in enumerate(creqs) if r.request_id not in affected]
    moved = [i for i, r in enumerate(creqs) if r.request_id in affected]
    same = sum(creqs[i].generated == kreqs[i].generated for i in moved)
    log(f"chaos f32 vs clean (card): {len(creqs)} requests each finished once; lanes whose "
        f"split or mask a fault moved: {sorted(replanned)}; {len(moved)} requests moved by a "
        f"fault ({same} of them with the clean tokens all the same), {len(keep)} not moved")
    if keep:
        last = {rid: devs[-1] for rid, devs in kp.items()}
        equal_or_tie(torch, lambda r: kfleet.lanes[last[kreqs[keep[r]].request_id]],
                     [kreqs[i] for i in keep], [list(creqs[i].generated) for i in keep],
                     [list(kreqs[i].generated) for i in keep],
                     "chaos f32 vs clean (card), requests no fault moved")


def lane1_down_decoding(fleet) -> bool:
    """Lane 1 is down and the live lanes decode."""
    return not fleet.lane_alive[1] and all(
        l._active.any() for i, l in enumerate(fleet.lanes) if fleet.lane_alive[i])


def chaos_bf16(torch, model, params, counters, tick_profiles, f32_page_bytes, timeline=False):
    """Phase 10 in bf16 with the three int8 streams and the rank-384 codec
    under the same schedule: exactly once, drained, sane counters, the
    migrated spill at the int8 stored size, only ``CHAOS_BF16_PATH``'s
    kernels, device memory after the blackout's ``reserve(0)``, and one
    profiled tick with lane 1 down beside phase 9's.  Returns the run's
    launch counts."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counters:
        c.launches = 0
    state = {}
    t0 = time.perf_counter()
    reqs, fleet, ticks, prof = fleet_run(
        torch, model, params, n=CHAOS_N, faults=chaos_faults(CHAOS_TIMES["bf16"]),
        profile_tick=lane1_down_decoding,
        watch=chaos_watch(torch, state, timeline), **QUANT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    m = fleet.metrics()
    page_bytes = m["migration_spill_bytes"] / max(fleet.migrated_pages, 1)
    log(f"chaos bf16 (int8 streams, rank-384 codec): {wall:.1f} s, {ticks} ticks, modeled end "
        f"{fleet.clock():.4f} s, faults { {k: m[k] for k in CHAOS_KEYS} }, peer fault fallbacks "
        f"{fleet.expert_registry.peer_fault_fallbacks}, { {k: m[k] for k in FLEET_COUNTERS} }; "
        f"migrated {fleet.migrated_pages} pages at {page_bytes:.1f} bytes a page ("
        f"{page_bytes / (f32_page_bytes or page_bytes or 1):.4f} of the f32 run's "
        f"{f32_page_bytes}); launches "
        f"{launches}")
    log(f"chaos bf16 fire log (modeled s): "
        f"{[(d['kind'], d['device'], round(d['t_fired_s'], 6)) for d in fleet.chaos.fired]}; "
        f"replans {[(ev['device'], ev['old_split'], ev['new_split']) for ev in fleet.replan_events]}")
    chaos_checks("chaos bf16", fleet, reqs)
    if f32_page_bytes is not None and not 0 < page_bytes < 0.7 * f32_page_bytes:
        raise AssertionError(f"chaos bf16: migrated {page_bytes} bytes a page, not below 0.7 of "
                             f"the f32 run's {f32_page_bytes}")
    only_path("chaos bf16", launches, CHAOS_BF16_PATH)
    if "reserve0" not in state:
        raise AssertionError("chaos bf16: the shared storage never grew to split 0")
    rtick, now_b, peak_b = state["reserve0"]
    log(f"chaos bf16 device memory: {now_b / 2**20:.1f} MiB allocated after the tick (tick "
        f"{rtick}) in which the blackout's reserve(0) grew the shared cloud storage to every "
        f"block, peak {peak_b / 2**20:.1f} MiB so far and "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB over the run "
        f"({held / 2**20:.1f} MiB held before the fleet was built)")
    if prof is None:
        raise AssertionError("chaos bf16: no tick had lane 1 down and the live lanes decoding")
    log_fleet_tick(prof, "chaos bf16", "lane 1 down, lanes 0 and 2 decoding",
                   "chaos_profile.txt", tick_profiles)
    return launches


def chaos_phase(torch, model, params, counters, tick_profiles, timeline=False):
    """Phase 10; returns the bf16 chaos run's launch counts."""
    t0 = time.perf_counter()
    page_bytes = chaos_f32(torch, model, params, counters, timeline)
    log(f"chaos f32 runs took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = chaos_bf16(torch, model, params, counters, tick_profiles, page_bytes, timeline)
    log(f"chaos bf16 run took {time.perf_counter() - t0:.1f} s")
    return launches


def stream(torch, counters, profiles):
    """Phase 6 on a fresh full-width switch-base with its weights as stored
    (f32) and bf16 activations; returns the model, its params, the pool
    run's launch counts and its (tokens, metrics)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    model = Model(get_config("switch-base"), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    launches, tokens, m = stream_pool_run(torch, model, params, counters, profiles=profiles)
    stream_replan_runs(torch, model, params)
    return model, params, launches, (tokens, m)


def chaos_timeline(torch) -> int:
    """``--chaos-timeline``: phase 10 alone on a fresh full-width switch-base:
    times the events anew on each run's timeline (``chaos_calibrate``),
    prints the ``CHAOS_TIMES`` it found, and runs the phase with them,
    logging each tick of its card runs (the modeled clock and every lane's
    state); prints no result line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.expert_mlp import grouped_mlp, grouped_mlp_resident
    from repro_torch.kernels.expert_mlp import grouped_mlp_resident_quant
    from repro_torch.kernels.group_gate import group_gate
    from repro_torch.kernels.lowrank import (
        lowrank_decode,
        lowrank_decode_quant,
        lowrank_encode,
        lowrank_encode_quant,
    )
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_quant
    from repro_torch.kernels.quant import dequantize_rows, paged_write_quant, quantize_rows
    from repro_torch.models.model import Model

    log(f"card: {nvidia_smi()}")
    build.build()
    OUT_DIR.mkdir(exist_ok=True)
    counters = [grouped_mlp_resident, grouped_mlp_resident_quant, grouped_mlp, group_gate,
                lowrank_encode, lowrank_decode, paged_attention, paged_attention_quant,
                quantize_rows, dequantize_rows, paged_write_quant, lowrank_encode_quant,
                lowrank_decode_quant]
    model = Model(get_config("switch-base"), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    t0 = time.perf_counter()
    from repro_torch.models.model import Model as M

    f32 = M(model.cfg.replace(dtype="float32"), device="cuda")
    CHAOS_TIMES["f32"] = chaos_calibrate(torch, f32, params, "f32", compression_rank=0)
    CHAOS_TIMES["bf16"] = chaos_calibrate(torch, model, params, "bf16", **QUANT)
    log(f"CHAOS_TIMES = {CHAOS_TIMES!r}")
    failed = 0
    for run in (lambda: chaos_f32(torch, model, params, counters, timeline=True),
                lambda: chaos_bf16(torch, model, params, counters, {}, None, timeline=True)):
        try:
            run()
        except AssertionError as e:  # a timing probe: log the miss and go on
            log(f"chaos timeline: {e}")
            failed += 1
    log(f"chaos phase took {time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# Phase 11: qwen2-vl-2b (M-RoPE and patch embeddings) through the model and
# every engine, at full width and depth
# ---------------------------------------------------------------------------

VLM = "qwen2-vl-2b"
VLM_TEXT = 64  # text tokens after the 256 patches (part a)
VLM_DECODE = 16  # greedy decode steps after the prefill (part a)
VLM_CPU_LAYERS = 4  # depth of the CPU side of the full-sequence f32 and bf16 checks
VLM_F32_REL, VLM_F32_COS = 1e-4, 0.9999  # f32 logits card vs CPU (as phase 5's)
VLM_LAYER_REL, VLM_BF16_REL, VLM_BF16_COS = 2**-6, 0.02, 0.9999  # bf16, layer by layer
# the wrappers that phase 11's runs must launch, summed over them
VLM_KERNELS = ("paged_attention", "paged_attention_quant", "flash_attention_fwd",
               "lowrank_encode", "lowrank_decode", "lowrank_encode_quant",
               "lowrank_decode_quant", "paged_write_quant")
# the bf16 int8-stream run's wrappers (a dense model: no gate, no expert FFN,
# no slab to quantize; the int8 boundary through the fused codec)
VLM_INT8_PATH = ("paged_attention_quant", "paged_write_quant", "lowrank_encode_quant",
                 "lowrank_decode_quant")
# the bf16 speculative run's: flash attention for the draft installs
VLM_SPEC_PATH = ("paged_attention", "flash_attention_fwd", "lowrank_encode", "lowrank_decode")
# paged attention at qwen2-vl's serving shapes (12 query heads on 2 kv heads
# of 128): decode (C*G = 6 rows), a verify chunk (30) and a prompt chunk (192)
VLM_ANCHORS = PA_CASES[0][4]  # 8 slots, one past a ring wrap
VLM_PA_CASES = (
    ("qwen2-vl B=8 pps=16 C=1", 8, 16, 1, VLM_ANCHORS),
    ("qwen2-vl B=8 pps=16 C=5", 8, 16, 5, VLM_ANCHORS),
    ("qwen2-vl B=8 pps=16 C=32", 8, 16, 32, VLM_ANCHORS),
)


def first_layers(params, n: int):
    """``params`` cut to their first ``n`` blocks (views)."""
    from repro_torch.serving.endcloud import split_block_params

    return {**params, "blocks": split_block_params(params, n)[0]["blocks"]}


def vlm_batch(torch, cfg, B: int, T: int, seed: int, grid: bool = True):
    """CPU tensors: B rows of ``cfg.vision_patches`` patch embeddings (std 1,
    as the token table's rows) and T text tokens from a seeded generator;
    with ``grid`` Qwen2-VL's positions: the patches on a 1 x side x side
    grid (t = 0, h = i // side, w = i % side), the text continuing from
    ``side`` on all three axes (else 0..S-1 on every axis, the default)."""
    g = torch.Generator().manual_seed(seed)
    P = cfg.vision_patches
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=g, dtype=torch.int32),
             "patch_embeds": torch.randn(B, P, cfg.d_model, generator=g)}
    if grid:
        side = round(P ** 0.5)
        i = torch.arange(P)
        img = torch.stack([torch.zeros_like(i), i // side, i % side])
        txt = (side + torch.arange(T))[None].expand(3, T)
        batch["positions"] = torch.cat([img, txt], 1)[None].expand(B, 3, P + T).int().contiguous()
    return batch


def vlm_generate(torch, model, params, batch, steps: int):
    """``Model.prefill`` of ``batch`` then ``steps`` greedy ``decode_step`` s
    on the model's device: (logits over the real vocabulary [steps + 1, B,
    V], f32 on the host; their argmax)."""
    b = {k: v.to(model.device) for k, v in batch.items()}
    S = b["tokens"].shape[1] + b["patch_embeds"].shape[1]
    out = []
    with torch.no_grad():
        logits, cache = model.prefill(params, b, max_len=S + steps)
        for i in range(steps + 1):
            out.append(logits.float().cpu())
            if i < steps:
                logits, cache = model.decode_step(params, logits.argmax(-1).int()[:, None],
                                                  cache)
    lg = torch.stack(out)[..., :model.cfg.vocab_size]
    return lg, lg.argmax(-1)


def vlm_equal_or_tie(torch, tag, card, host):
    """Greedy runs (``vlm_generate``'s) on the card and on the CPU: the
    tokens equal, or the first step where a row differs is a near tie of the
    CPU's logits (top-2 gap below ``TIE``); the logits of every step up to
    that one within ``VLM_F32_REL`` of max|cpu| and cosine ``VLM_F32_COS``."""
    (lg, tok), (lc, tc) = card, host
    same = (tok == tc).all(dim=1)
    n = int(same.int().cumprod(0).sum())  # leading steps with every row equal
    upto = min(n + 1, len(tok))
    rel, cos = logit_gap(torch, lg[:upto], lc[:upto], lc.shape[-1])
    log(f"{tag}: tokens equal at {n} of {len(tok)} steps; logits over steps 0-{upto - 1}: "
        f"max|diff|/max|cpu|={rel:.3e} (<= {VLM_F32_REL:g}) cos={cos.min().item():.7f} "
        f"(>= {VLM_F32_COS:g})")
    if not (rel <= VLM_F32_REL and cos.min().item() >= VLM_F32_COS):
        raise AssertionError(f"{tag}: the card's logits disagree with the CPU's")
    if n < len(tok):
        rows = (tok[n] != tc[n]).nonzero().squeeze(1)
        top2 = lc[n, rows].topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).max().item()
        log(f"{tag}: step {n} differs in rows {rows.tolist()} at a CPU top-2 gap of "
            f"{gap:.3e} (tie < {TIE:g})")
        if gap >= TIE:
            raise AssertionError(f"{tag}: tokens differ where the model has no near tie")


def vlm_layers(torch, model, params, batch, feed=None):
    """``Model.prefill`` with every layer's input and output recorded on the
    host: (last-position logits f32 on the host, {"in", "out": [layers]});
    with ``feed`` each layer takes that run's input for it."""
    from repro_torch.models import transformer

    layer = transformer.apply_layer_full
    rec = {"in": [], "out": []}

    def layer_rec(p, x, *args, **kw):
        if feed is not None:
            x = feed[len(rec["in"])].to(x.device)
        rec["in"].append(x.cpu())
        y, aux, entry = layer(p, x, *args, **kw)
        rec["out"].append(y.float().cpu())
        return y, aux, entry

    transformer.apply_layer_full = layer_rec
    try:
        with torch.no_grad():
            logits, _ = model.prefill(params, {k: v.to(model.device) for k, v in batch.items()})
    finally:
        transformer.apply_layer_full = layer
    return logits.float().cpu(), rec


def profiled(torch, fn, name: str, names):
    """One call of ``fn`` under ``torch.profiler``, its table written to
    ``chiprun_out/name``: (device ms, synchronized wall ms, the in-path
    reader's line over ``names``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    avgs = prof.key_averages()
    dev = [e for e in avgs if e.device_type != DeviceType.CPU]
    (OUT_DIR / name).write_text(avgs.table(sort_by="cuda_time_total", row_limit=40))
    return (sum(e.self_device_time_total for e in dev) / 1e3, wall * 1e3,
            kernels_in_path(dev, names))


def counted_run(counters, fn):
    """(``fn()``, each wrapper's launches in that call), counts zeroed first."""
    for c in counters:
        c.launches = 0
    out = fn()
    return out, {c.__name__: c.launches for c in counters}


def vlm_model(torch, cfg, cparams, host32, counters):
    """(a) ``Model.prefill`` of 256 patches on a 16 x 16 grid and 64 text
    tokens, then 16 greedy decode steps, full depth in bf16 on the card;
    the grid's logits against uniform positions'; f32 card against CPU and
    bf16 layer by layer, at ``VLM_CPU_LAYERS`` layers.  Returns the
    full-depth run's launches."""
    from repro_torch.models.model import Model, to_device

    L = cfg.num_layers
    model = Model(cfg, device="cuda")
    batch = vlm_batch(torch, cfg, 2, VLM_TEXT, seed=0)
    t0 = time.perf_counter()
    (lg, tok), launches = counted_run(
        counters, lambda: vlm_generate(torch, model, cparams, batch, VLM_DECODE))
    log(f"vlm prefill [2, {cfg.vision_patches} patches + {VLM_TEXT} tokens] and "
        f"{VLM_DECODE} decode steps (bf16, {L} layers): {time.perf_counter() - t0:.2f} s; "
        f"launches {launches}")
    if launches["flash_attention_fwd"] != L or any(
            v for k, v in launches.items() if k != "flash_attention_fwd"):
        raise AssertionError(f"vlm prefill: launches {launches}, want {L} flash attention "
                             "(one a layer) and nothing else (decode over dense rings)")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("vlm prefill: logits are not finite")
    flat = vlm_batch(torch, cfg, 2, VLM_TEXT, seed=0, grid=False)
    lu, _ = vlm_generate(torch, model, cparams, flat, 0)
    moved = ((lg[0] - lu[0]).abs().max() / lu[0].abs().max()).item()
    log(f"M-RoPE: the grid's prefill logits against uniform positions': max|diff|/max|.|="
        f"{moved:.3e} (> 0.1), argmax equal {(lg[0].argmax(-1) == lu[0].argmax(-1)).tolist()}")
    if moved <= 0.1:
        raise AssertionError("M-RoPE: the grid positions did not move the logits")
    del lu

    cfg32 = cfg.replace(dtype="float32", num_layers=VLM_CPU_LAYERS)
    t0 = time.perf_counter()
    card = vlm_generate(torch, Model(cfg32, device="cuda"), to_device(host32, "cuda"), batch,
                        VLM_DECODE)
    t1 = time.perf_counter()
    host = vlm_generate(torch, Model(cfg32, device="cpu"), host32, batch, VLM_DECODE)
    vlm_equal_or_tie(torch, f"vlm f32 prefill + {VLM_DECODE} decode steps, card vs CPU "
                     f"({VLM_CPU_LAYERS} layers; card {t1 - t0:.1f} s, CPU "
                     f"{time.perf_counter() - t1:.1f} s)", card, host)

    # bf16, row 0, each card layer fed the CPU's input for it
    cfg4 = cfg.replace(num_layers=VLM_CPU_LAYERS)
    cp4 = first_layers(cparams, VLM_CPU_LAYERS)
    row = {k: v[:1] for k, v in batch.items()}
    t0 = time.perf_counter()
    lc, rc = vlm_layers(torch, Model(cfg4, device="cpu"), to_device(cp4, "cpu"), row)
    lf, rf = vlm_layers(torch, Model(cfg4, device="cuda"), cp4, row, feed=rc["in"])
    layer_rel = [((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(rf["out"], rc["out"])]
    rel, cos = logit_gap(torch, lf, lc, cfg.vocab_size)
    log(f"vlm bf16 prefill, each layer fed the CPU's input ({VLM_CPU_LAYERS} layers, "
        f"{time.perf_counter() - t0:.1f} s): layer max|diff|/max|cpu| "
        f"{[f'{x:.2e}' for x in layer_rel]} (<= {VLM_LAYER_REL:g}); logits max|diff|/max|cpu|="
        f"{rel:.3e} (<= {VLM_BF16_REL:g}) cos={cos.min().item():.6f} (>= {VLM_BF16_COS:g})")
    if max(layer_rel) > VLM_LAYER_REL or rel > VLM_BF16_REL or cos.min().item() < VLM_BF16_COS:
        raise AssertionError("vlm bf16: a layer fed the CPU's input disagrees")
    return launches


def vlm_serve(torch, cfg, params, cparams, counters, tag="vlm", check_layers=None):
    """(b) Phase 3's traffic through ``ServingEngine`` at full depth in bf16,
    a profiled decode step with 8 slots decoding
    (``chiprun_out/{tag}_decode_profile.txt``), then phase 4's card against
    CPU check in f32 at full depth, or at the first ``check_layers`` layers.
    Returns the run's launches."""
    import numpy as np

    from repro_torch.models.model import Model
    from repro_torch.serving import Request, ServingEngine

    model = Model(cfg, device="cuda")
    eng = ServingEngine(model, cparams, max_batch=8, max_len=256, page_size=16,
                        prefill_chunk=32)
    rng = np.random.default_rng(0)
    prompt_lens = [16, 40, 77, 100, 128, 150, 181, 200]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=32) for i, n in enumerate(prompt_lens)]
    step_s = []

    def run():
        for r in reqs:
            eng.submit(r)
        while eng.busy():
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, launches = counted_run(counters, run)
    run_s = time.perf_counter() - t0
    log(f"{tag} serving launches: {launches}")
    only_path(f"{tag} serving", launches, ("paged_attention",))
    if not all(r.done and len(r.generated) == 32 for r in reqs) or eng.pool.pages_in_use:
        raise AssertionError(f"{tag} serving: a request did not finish, or pages stay mapped")
    decode = sorted(step_s[1:])
    log(f"{tag} serving: first step {step_s[0] * 1e3:.3f} ms; decode step median "
        f"{decode[len(decode) // 2] * 1e3:.3f} ms over {len(decode)} steps (host clock, "
        f"synchronized); {8 * 32 / run_s:.1f} tokens/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for i, n in enumerate(prompt_lens):
        eng.submit(Request(90 + i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                           max_new_tokens=8))
    eng.step()  # admission + decode
    eng.step()
    dev_ms, wall_ms, in_path = profiled(torch, eng.step, f"{tag}_decode_profile.txt",
                                        PAGED_KERNELS)
    log(f"{tag} decode profile (1 step, 8 slots decoding): device time {dev_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall; kernels in path, a launch: {in_path}; written to "
        f"chiprun_out/{tag}_decode_profile.txt")
    eng.run()
    L = check_layers or cfg.num_layers
    log(f"{tag} card vs CPU (f32, {L} of {cfg.num_layers} layers, a 16-token prompt chunk and "
        "a decode step):")
    reference_check(torch, eng, cfg=cfg.replace(dtype="float32", num_layers=L),
                    params=first_layers(params, L), rel_tol=1e-3, cos_tol=0.99999)
    return launches


def vlm_pipeline(torch, cfg, cparams, host32, counters, tag="vlm"):
    """(c) ``EndCloudPipeline``: jetson-orin end, a100 cloud, rank 384,
    tokens [4, 256] at full depth in bf16 (the planner's split 1 of 28);
    f32 card against CPU at ``VLM_CPU_LAYERS`` layers (``host32`` holds
    them).  Returns one ``run_batch``'s launches."""
    from repro_torch.core.hardware import PROFILES
    from repro_torch.models.model import Model, to_device
    from repro_torch.serving import EndCloudPipeline

    prof = dict(end_profile=PROFILES["jetson-orin"], cloud_profile=PROFILES["a100"])
    pipe = EndCloudPipeline(Model(cfg, device="cuda"), cparams, compression_rank=384, **prof)
    L = cfg.num_layers
    log(f"{tag} pipeline plan (jetson-orin end, a100 cloud): split {pipe.split} of {L}, codec "
        f"{'on' if pipe.tiers.compress else 'off'}")
    if not (0 < pipe.split < L and pipe.tiers.compress):
        raise AssertionError(f"{tag} pipeline: the plan is not an interior split with the codec")
    B, S = 4, 256
    tok = pipeline_tokens(torch, cfg.vocab_size, B, S, 0).cuda()
    pipe.run_batch(tok)  # warm-up
    (logits, m), launches = counted_run(counters, lambda: pipe.run_batch(tok))
    want = {c.__name__: 0 for c in counters}
    want.update(flash_attention_fwd=L, lowrank_encode=1, lowrank_decode=1)
    log(f"{tag} pipeline launches per run_batch: {launches}")
    if launches != want:
        raise AssertionError(f"{tag} pipeline launches {launches}, want {want}")
    if m["boundary_bytes"] != B * S * 384 * 2 or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} pipeline: metrics {m}, or logits not finite")
    del logits
    runs = [pipe.run_batch(tok)[1] for _ in range(5)]
    log(f"{tag} pipeline run_batch [{B}, {S}]: median t_end "
        f"{sorted(r['t_end_s'] for r in runs)[2] * 1e3:.3f} ms, median t_cloud "
        f"{sorted(r['t_cloud_s'] for r in runs)[2] * 1e3:.3f} ms over 5 warm runs (host "
        f"clock, device synchronized)")
    dev_ms, wall_ms, in_path = profiled(
        torch, lambda: pipe.run_batch(tok), f"{tag}_pipeline_profile.txt",
        (("flash attention", ("flash_fwd_mma_kernel",), ()), *CODEC_KERNELS))
    log(f"{tag} pipeline profile (1 run_batch): device time {dev_ms:.3f} ms of {wall_ms:.3f} ms "
        f"wall; kernels in path, a launch: {in_path}; written to "
        f"chiprun_out/{tag}_pipeline_profile.txt")

    cfg32 = cfg.replace(dtype="float32", num_layers=VLM_CPU_LAYERS)
    codec = pipe.codec
    card = EndCloudPipeline(Model(cfg32, device="cuda"), to_device(host32, "cuda"),
                            codec_params=codec, **prof)
    host = EndCloudPipeline(Model(cfg32, device="cpu"), host32,
                            codec_params=to_device(codec, "cpu"), **prof)
    t0 = time.perf_counter()
    lg, mg = card.run_batch(tok)
    lc, mc = host.run_batch(tok.cpu())
    rel, cos = logit_gap(torch, lg, lc, cfg.vocab_size)
    log(f"{tag} pipeline f32 card vs CPU ({VLM_CPU_LAYERS} layers, split {card.split}, "
        f"{time.perf_counter() - t0:.1f} s): logits max|diff|/max|cpu|={rel:.3e} "
        f"(<= {VLM_F32_REL:g}) cos={cos.min().item():.7f} (>= {VLM_F32_COS:g})")
    if (mg["split"], mg["boundary_bytes"]) != (mc["split"], mc["boundary_bytes"]) or not (
            rel <= VLM_F32_REL and cos.min().item() >= VLM_F32_COS):
        raise AssertionError(f"{tag} pipeline: the card disagrees with the CPU")
    return launches


def vlm_stream_f32(torch, cfg, host32, tag):
    """f32 dense pools through ``spec_engine`` on the card and on the CPU at
    ``VLM_CPU_LAYERS`` layers (4 requests, 16 tokens): counters equal,
    tokens equal or the first difference a near tie."""
    from repro_torch.models.model import Model, to_device

    cfg32 = cfg.replace(dtype="float32", num_layers=VLM_CPU_LAYERS)
    runs = {}
    t0 = time.perf_counter()
    for dev, p in (("cuda", to_device(host32, "cuda")), ("cpu", host32)):
        eng = spec_engine(Model(cfg32, device=dev), p)
        reqs = stream_requests(cfg.vocab_size, 4, 0, 16, hi=SPEC_HI)
        runs[dev] = (eng, reqs, drive(eng, reqs))
    (ceng, creqs, card), (heng, _, host) = runs["cuda"], runs["cpu"]
    keys = ("n_stage_steps", "n_prefill_chunks")
    log(f"{tag} stream f32 ({VLM_CPU_LAYERS} layers, 4 requests, 16 tokens, "
        f"{time.perf_counter() - t0:.1f} s): counters card {[getattr(ceng, k) for k in keys]} "
        f"CPU {[getattr(heng, k) for k in keys]}, bytes up {ceng.link.bytes_up} / "
        f"{heng.link.bytes_up}")
    if [getattr(ceng, k) for k in keys] != [getattr(heng, k) for k in keys]:
        raise AssertionError(f"{tag} stream f32: the card's counters differ from the CPU's")
    equal_or_tie(torch, ceng, creqs, card, host, f"{tag} stream f32 card vs CPU")


def vlm_stream(torch, cfg, cparams, host32, counters, tag="vlm", f32=True, spec=True,
               new=32, hi=200):
    """(d) ``EndCloudServingEngine`` (``spec_engine``: 8 slots in two
    groups, rank 384, split 1, jetson-orin end, modeled stage times): with
    ``f32``, f32 dense pools card against CPU at ``VLM_CPU_LAYERS`` layers;
    bf16 with the three int8 streams (8 requests of ``new`` tokens on
    prompts of 16 to ``hi`` tokens, a
    profiled tick, ``chiprun_out/{tag}_stream_profile.txt``) and with
    ``spec``, bf16 dense pools with ``spec_k = 4``, both at full depth.
    Returns the bf16 runs' summed launches."""
    from repro_torch.kernels.paged_attention.ops import uses_tensor_cores
    from repro_torch.models import attention as attn
    from repro_torch.models.model import Model

    if f32:
        vlm_stream_f32(torch, cfg, host32, tag)

    model = Model(cfg, device="cuda")
    tick = {}

    def profile_tick(e, t):
        if not tick and all_decoding(e):
            tick["at"] = t
            tick["prof"] = profiled(torch, e.step, f"{tag}_stream_profile.txt", (
                *PAGED_KERNELS, ("KV write", ("paged_write_quant_kernel<",), ()),
                *CODEC_QUANT_KERNELS))

    eng = spec_engine(model, cparams, **QUANT)
    reqs = stream_requests(cfg.vocab_size, 8, 0, new, hi=hi)
    t0 = time.perf_counter()
    tokens, quant = counted_run(counters, lambda: drive(eng, reqs, hook=profile_tick))
    m = eng.metrics()
    log(f"{tag} stream bf16 + int8 streams ({cfg.num_layers} layers, 8 requests, {new} tokens): "
        f"{time.perf_counter() - t0:.1f} s, {eng.n_stage_steps} end-stage steps, "
        f"{eng.n_prefill_chunks} prefill chunks, {eng.link.bytes_up} bytes up, KV capacity "
        f"ratio {m['kv_capacity_ratio']:.4f}; launches {quant}")
    if m["kv_pages_in_use"] or not all(len(t) == new for t in tokens):
        raise AssertionError(f"{tag} stream bf16 int8: pages left mapped or a request short")
    only_path(f"{tag} stream bf16 int8", quant, VLM_INT8_PATH)
    if not tick:
        raise AssertionError(f"{tag} stream bf16 int8: no tick had 8 slots decoding")
    dev_ms, wall_ms, in_path = tick["prof"]
    log(f"{tag} stream tick profile (int8 streams, tick {tick['at']}, 8 slots decoding): device "
        f"time {dev_ms:.3f} ms of {wall_ms:.3f} ms wall ({dev_ms / wall_ms:.1%} busy); kernels "
        f"in path, a launch: {in_path}; written to chiprun_out/{tag}_stream_profile.txt")
    del eng
    if not spec:
        return quant

    rows = {}
    chunk_attn = attn.paged_chunk_attention

    def count_rows(q, *args, **kw):
        rows[q.shape[1]] = rows.get(q.shape[1], 0) + 1
        return chunk_attn(q, *args, **kw)

    attn.paged_chunk_attention = count_rows
    try:
        eng = spec_engine(model, cparams, **SPEC)
        reqs = stream_requests(cfg.vocab_size, 8, 0, 32, hi=SPEC_HI)
        t0 = time.perf_counter()
        tokens, spec = counted_run(counters, lambda: drive(eng, reqs))
    finally:
        attn.paged_chunk_attention = chunk_attn
    m = eng.metrics()
    G = cfg.num_heads // cfg.num_kv_heads
    mma = {c: uses_tensor_cores(torch.bfloat16, False, c * G, eng.page_size) for c in rows}
    log(f"vlm stream bf16 spec_k=4 ({time.perf_counter() - t0:.1f} s): "
        f"{ {k: m[k] for k in SPEC_COUNTERS} }; launches {spec}; paged attention calls by "
        f"rows a slot {dict(sorted(rows.items()))}, tensor-core body {mma}")
    if m["kv_pages_in_use"] or not all(len(t) == 32 for t in tokens) or not m["spec_rounds"]:
        raise AssertionError("vlm stream bf16 spec: pages left mapped, a request short, or no "
                             "speculative round")
    only_path("vlm stream bf16 spec", spec, VLM_SPEC_PATH)
    if spec["flash_attention_fwd"] % cfg.num_layers:
        raise AssertionError("vlm stream bf16 spec: flash attention launches are not whole "
                             "prefills")
    if not any(v for c, v in mma.items() if 1 < c < eng.prefill_chunk):
        raise AssertionError("vlm stream bf16 spec: no speculative chunk took the tensor cores")
    return {k: quant[k] + spec[k] for k in quant}


def vlm_kernels(torch, timer):
    """The kernels of phase 11's path against their plain versions at
    qwen2-vl's shapes, timed beside their bound and library call: paged
    attention over bf16 and int8 pools (``VLM_PA_CASES``), flash attention
    at the prefill's [2, 320] and a ragged [2, 301] (12 heads on 2 of 128),
    the codec and its fused int8 forms at d 1536 and rank 384, and the
    int8 KV write at 2 kv heads of 128; the profiler's device times read
    at the end."""
    from repro_torch.core.compression import init_lowrank_1d

    heads = (12, 2, 128)
    run_paged_attention(torch, timer, cases=VLM_PA_CASES, heads=heads)
    run_paged_attention(torch, timer, quant=True, cases=VLM_PA_CASES, heads=heads)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, S in (("qwen2-vl prefill B=2 S=320 H=12 KV=2 hd=128", 320),
                    ("qwen2-vl ragged B=2 S=301 H=12 KV=2 hd=128", 301)):
        flash_case(torch, timer, gen, name, 2, S, 12, 2, hd=128, later=True)
    codec = init_lowrank_1d(torch.Generator().manual_seed(7), 1536, 384, device="cuda")
    codec_cases(torch, timer, gen, codec, (1024, 4, 32), later=True)
    run_codec_quant(torch, timer, d=1536, ranks=(384,), rows=(1, 4, 32, 1024), timed=(4, 32))
    run_kv_write(torch, timer, heads=(2, 128))
    timer.read_later()


def vlm_phase(torch, timer, counters):
    """Phase 11 on full-width, full-depth qwen2-vl-2b with random weights
    from seed 0 (f32 as stored, bf16 activations): (a) the model with patch
    embeddings, (b) ``ServingEngine``, (c) ``EndCloudPipeline``, (d)
    ``EndCloudServingEngine``, then the kernels at its shapes.  Returns
    each wrapper's launches summed over the runs of (a)-(d)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, leaves, to_device
    from repro_torch.models.transformer import compute_params

    cfg = get_config(VLM)
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cparams = compute_params(params, cfg)  # the bf16 copy every engine reads
    host32 = to_device(first_layers(params, VLM_CPU_LAYERS), "cpu")
    torch.cuda.synchronize()
    log(f"{VLM}: {sum(t.numel() for t in leaves(params)) / 1e9:.3f} B params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads on "
        f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, M-RoPE sections "
        f"{cfg.mrope_sections}, {cfg.vision_patches} patches; built in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    parts = []
    for tag, part in (
            ("(a) model with patches", lambda: vlm_model(torch, cfg, cparams, host32, counters)),
            ("(b) ServingEngine", lambda: vlm_serve(torch, cfg, params, cparams, counters)),
            ("(c) EndCloudPipeline",
             lambda: vlm_pipeline(torch, cfg, cparams, host32, counters)),
            ("(d) EndCloudServingEngine",
             lambda: vlm_stream(torch, cfg, cparams, host32, counters))):
        t0 = time.perf_counter()
        log(f"vlm {tag}:")
        parts.append(part())
        log(f"vlm {tag} took {time.perf_counter() - t0:.1f} s")
    launches = {k: sum(p[k] for p in parts) for k in parts[0]}
    log(f"vlm launches over (a)-(d): {launches}")
    missing = [k for k in VLM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"vlm: path kernels never launched: {missing}")
    del params, cparams, host32
    t0 = time.perf_counter()
    log("vlm kernels against their plain versions at qwen2-vl's shapes (bf16, card):")
    vlm_kernels(torch, timer)
    log(f"vlm kernel checks took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the Mamba-2 SSM layer and the dense-ring ServingEngine:
# mamba2-130m at full width and depth, jamba-1.5-large's hybrid at smoke size
# ---------------------------------------------------------------------------

SSM = "mamba2-130m"
HYBRID = "jamba-1.5-large-398b"
HYBRID_LAYERS = 16  # two smoke blocks of 8, so the pipeline has an interior split
SSM_DECODE = 16  # greedy decode steps after each prefill
# (rows, tokens): one 256-token chunk, and four (the recurrence over chunk states)
SSM_PROMPTS = ((2, 256), (1, 1024))
# prompts of the hybrid's dense engine: 1 and 2 tokens (conv tails padded at
# install), past one 32-token smoke chunk only whole chunks
HYBRID_SERVE_LENS = (2, 16, 32, 64, 96, 128, 1, 24)
SSM_F32_REL, SSM_F32_COS = 1e-4, 0.9999  # f32 logits card vs CPU (as phase 11's)
# the wrappers phase 12's bf16 runs launch, summed over them (mamba2 runs no
# kernel but the pipeline's codec); every other wrapper makes 0 launches
SSM_PATH = ("group_gate", "grouped_mlp", "flash_attention_fwd", "lowrank_encode",
            "lowrank_decode")
HYBRID_MODEL_PATH = ("group_gate", "grouped_mlp", "flash_attention_fwd")
SSM_PIPELINE_PATH = ("lowrank_encode", "lowrank_decode")


def ssm_generate(torch, model, params, tokens, steps: int, max_len: int = 0):
    """``Model.prefill`` of ``tokens`` [B, S] then ``steps`` greedy
    ``decode_step`` s on the model's device: (logits over the real
    vocabulary [steps + 1, B, V], f32 on the host; their argmax)."""
    out = []
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens.to(model.device)},
                                      max_len=max_len or tokens.shape[1] + steps)
        for i in range(steps + 1):
            out.append(logits.float().cpu())
            if i < steps:
                logits, cache = model.decode_step(params, logits.argmax(-1).int()[:, None],
                                                  cache)
    lg = torch.stack(out)[..., :model.cfg.vocab_size]
    return lg, lg.argmax(-1)


def card_equals_cpu(torch, tag, card, host):
    """f32 runs of the same work on the card and the CPU: (logits, tokens)
    each; the tokens equal, the logits within ``SSM_F32_REL`` of max|cpu|
    and at cosine ``SSM_F32_COS`` or above."""
    (lg, tok), (lc, tc) = card, host
    rel, cos = logit_gap(torch, lg, lc, lc.shape[-1])
    same = bool(torch.equal(tok, tc))
    log(f"{tag}: tokens equal {same} ({tok.numel()}); logits max|diff|/max|cpu|={rel:.3e} "
        f"(<= {SSM_F32_REL:g}) cos={cos.min().item():.7f} (>= {SSM_F32_COS:g})")
    if not (same and rel <= SSM_F32_REL and cos.min().item() >= SSM_F32_COS):
        raise AssertionError(f"{tag}: the card disagrees with the CPU")


def ssm_requests(vocab: int, lens, new: int, base: int = 0):
    """One request a prompt length, ids from a seeded generator."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    return [Request(base + i, rng.integers(0, vocab, size=n).astype(np.int32),
                    max_new_tokens=new) for i, n in enumerate(lens)]


def dense_serve(torch, model, params, lens, new: int, max_len: int, step_s=None):
    """``lens``' requests through the dense-ring ``ServingEngine`` (8
    slots), with each step's synchronized host time appended to
    ``step_s``: (engine, each request's tokens)."""
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(model, params, max_batch=8, max_len=max_len)
    reqs = ssm_requests(model.cfg.vocab_size, lens, new)
    for r in reqs:
        eng.submit(r)
    while eng.busy():
        t = time.perf_counter()
        eng.step()
        if step_s is not None:
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
    if eng.paged or not all(r.done and len(r.generated) == new for r in reqs):
        raise AssertionError(f"{model.cfg.name} dense engine: a request did not finish")
    return eng, [list(r.generated) for r in reqs]


def ssm_step_shares(torch, step):
    """``step_shares`` of the SSM's decode update (``ssd_decode_step``)
    and conv step (``conv1d_decode_step``)."""
    from repro_torch.models import ssm

    return step_shares(torch, step, ssm, ("ssd_decode_step", "conv1d_decode_step"))


def step_shares(torch, step, module, names):
    """One call of ``step`` under ``torch.profiler``, each function of
    ``module`` named in ``names`` wrapped in a ``record_function`` range:
    (device ms of every kernel, {range: device ms of the kernels launched
    inside it})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = {n: getattr(module, n) for n in names}

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    for n in names:
        setattr(module, n, ranged(n, saved[n]))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)
    avgs = prof.key_averages()
    total = sum(e.self_device_time_total for e in avgs
                if e.device_type != DeviceType.CPU and e.key not in names) / 1e3
    part = {n: sum(e.device_time_total for e in avgs
                   if e.key == n and e.device_type == DeviceType.CPU) / 1e3 for n in names}
    return total, part


def ssm_model(torch, cfg, params, cparams, host32, counters):
    """(a) ``Model.prefill`` then ``SSM_DECODE`` greedy steps at
    ``SSM_PROMPTS``: bf16 on the card at full depth (no kernel launches:
    the SSD and conv are plain PyTorch, as ``jnp`` in the reference), then
    f32 card against CPU at full depth.  Returns the bf16 runs' launches."""
    from repro_torch.models.model import Model

    model = Model(cfg, device="cuda")
    cfg32 = cfg.replace(dtype="float32")
    runs = []
    for B, S in SSM_PROMPTS:
        tokens = pipeline_tokens(torch, cfg.vocab_size, B, S, seed=S)
        t0 = time.perf_counter()
        (lg, _), launches = counted_run(
            counters, lambda: ssm_generate(torch, model, cparams, tokens, SSM_DECODE))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs.append(launches)
        only_path(f"ssm bf16 prefill [{B}, {S}]", launches, ())
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"ssm bf16 prefill [{B}, {S}]: logits are not finite")
        card = ssm_generate(torch, Model(cfg32, device="cuda"), params, tokens, SSM_DECODE)
        t2 = time.perf_counter()
        host = ssm_generate(torch, Model(cfg32, device="cpu"), host32, tokens, SSM_DECODE)
        t3 = time.perf_counter()
        rel, cos = logit_gap(torch, lg[0], card[0][0], cfg.vocab_size)
        log(f"ssm bf16 prefill [{B}, {S}] + {SSM_DECODE} steps ({cfg.num_layers} layers): "
            f"{t1 - t0:.2f} s; its prefill logits against the card's f32: max|diff|/max|f32|="
            f"{rel:.3e} cos={cos.min().item():.5f} (reported); f32 card {t2 - t1:.1f} s, "
            f"CPU {t3 - t2:.1f} s")
        card_equals_cpu(torch, f"ssm f32 prefill [{B}, {S}] + {SSM_DECODE} steps, card vs CPU",
                        card, host)
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def ssm_serve(torch, cfg, params, cparams, host32, counters):
    """(b) Phase 3's traffic through the dense-ring ``ServingEngine`` at
    full depth in bf16 (no kernel launches), a profiled decode step with 8
    slots decoding and the SSD update's and conv's share of it, then the
    same prompts in f32 (16 new tokens each), card against CPU.  Returns
    the bf16 run's launches."""
    from repro_torch.models.model import Model

    lens = (16, 40, 77, 100, 128, 150, 181, 200)
    model = Model(cfg, device="cuda")
    step_s = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (eng, _), launches = counted_run(
        counters, lambda: dense_serve(torch, model, cparams, lens, 32, 256, step_s))
    run_s = time.perf_counter() - t0
    only_path("ssm serving", launches, ())
    decode = sorted(step_s[1:])
    log(f"ssm serving (dense ring, 8 slots, {len(lens)} requests x 32 tokens): first step "
        f"{step_s[0] * 1e3:.3f} ms; decode step median {decode[len(decode) // 2] * 1e3:.3f} "
        f"ms over {len(decode)} steps (host clock, synchronized); "
        f"{len(lens) * 32 / run_s:.1f} tokens/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for r in ssm_requests(cfg.vocab_size, lens, 8, base=90):
        eng.submit(r)
    eng.step()  # admission (8 whole-prompt prefills) + decode
    eng.step()
    dev_ms, wall_ms, _ = profiled(torch, eng.step, "ssm_decode_profile.txt", ())
    total, part = ssm_step_shares(torch, eng.step)
    calls = {"ssd_decode_step": cfg.num_layers, "conv1d_decode_step": 2 * cfg.num_layers}
    log(f"ssm decode profile (1 step, 8 slots decoding): device time {dev_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall ({dev_ms / wall_ms:.1%} busy); written to "
        f"chiprun_out/ssm_decode_profile.txt. Annotated step: {total:.3f} ms of kernels, "
        + ", ".join(f"{n} {ms:.3f} ms ({ms / max(total, 1e-9):.1%}, {calls[n]} calls)"
                    for n, ms in part.items()))
    eng.run()
    # f32 over 16 new tokens a request (the CPU side's seconds)
    cfg32 = cfg.replace(dtype="float32")
    t0 = time.perf_counter()
    _, card = dense_serve(torch, Model(cfg32, device="cuda"), params, lens, 16, 256)
    t1 = time.perf_counter()
    _, host = dense_serve(torch, Model(cfg32, device="cpu"), host32, lens, 16, 256)
    same = card == host
    log(f"ssm serving f32 card vs CPU ({cfg.num_layers} layers; card {t1 - t0:.1f} s, CPU "
        f"{time.perf_counter() - t1:.1f} s): tokens equal {same} "
        f"({sum(a == b for x, y in zip(card, host) for a, b in zip(x, y))} of "
        f"{sum(len(x) for x in host)})")
    if not same:
        raise AssertionError("ssm serving f32: the card's tokens differ from the CPU's")
    return launches


def ssm_pipeline_runs(torch, tag, cfg, params, cparams, host32, counters, rank, path):
    """``EndCloudPipeline`` (jetson-orin end, a100 cloud, a rank-``rank``
    codec, tokens [4, 256]) at the planner's interior split: one bf16
    ``run_batch`` launches ``path``'s wrappers and no other, the codec's
    encode and decode once each;
    per-tier times and a profiled ``run_batch``; then f32 card against CPU
    on the same codec, over the first two rows.  Returns the bf16 run's
    launches."""
    from repro_torch.core.hardware import PROFILES
    from repro_torch.models.model import Model, to_device
    from repro_torch.serving import EndCloudPipeline

    prof = dict(end_profile=PROFILES["jetson-orin"], cloud_profile=PROFILES["a100"])
    pipe = EndCloudPipeline(Model(cfg, device="cuda"), cparams, compression_rank=rank, **prof)
    R = cfg.block_repeat
    log(f"{tag} pipeline plan (jetson-orin end, a100 cloud, rank {rank}): split {pipe.split} "
        f"of {R} blocks, codec {'on' if pipe.tiers.compress else 'off'}")
    if not (0 < pipe.split < R and pipe.tiers.compress):
        raise AssertionError(f"{tag} pipeline: the plan is not an interior split with the codec")
    B, S = 4, 256
    tok = pipeline_tokens(torch, cfg.vocab_size, B, S, 0).cuda()
    pipe.run_batch(tok)  # warm-up
    (logits, m), launches = counted_run(counters, lambda: pipe.run_batch(tok))
    log(f"{tag} pipeline launches per run_batch: { {k: v for k, v in launches.items() if v} }")
    only_path(f"{tag} pipeline", launches, path)
    if launches["lowrank_encode"] != 1 or launches["lowrank_decode"] != 1:
        raise AssertionError(f"{tag} pipeline: the codec launched {launches}, want once a side")
    if m["boundary_bytes"] != B * S * rank * 2 or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} pipeline: metrics {m}, or logits not finite")
    del logits
    runs = [pipe.run_batch(tok)[1] for _ in range(5)]
    dev_ms, wall_ms, in_path = profiled(
        torch, lambda: pipe.run_batch(tok), f"{tag}_pipeline_profile.txt", CODEC_KERNELS)
    log(f"{tag} pipeline run_batch [{B}, {S}]: median t_end "
        f"{sorted(r['t_end_s'] for r in runs)[2] * 1e3:.3f} ms, median t_cloud "
        f"{sorted(r['t_cloud_s'] for r in runs)[2] * 1e3:.3f} ms over 5 warm runs (host "
        f"clock, device synchronized); profiled: device time {dev_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall; kernels in path, a launch: {in_path}")
    cfg32 = cfg.replace(dtype="float32")
    codec = pipe.codec
    card = EndCloudPipeline(Model(cfg32, device="cuda"), params, codec_params=codec, **prof)
    host = EndCloudPipeline(Model(cfg32, device="cpu"), host32,
                            codec_params=to_device(codec, "cpu"), **prof)
    t0 = time.perf_counter()
    lg, mg = card.run_batch(tok[:2])
    lc, mc = host.run_batch(tok[:2].cpu())
    rel, cos = logit_gap(torch, lg, lc, cfg.vocab_size)
    log(f"{tag} pipeline f32 card vs CPU (split {card.split}, {time.perf_counter() - t0:.1f} "
        f"s): logits max|diff|/max|cpu|={rel:.3e} (<= {SSM_F32_REL:g}) "
        f"cos={cos.min().item():.7f} (>= {SSM_F32_COS:g})")
    if (mg["split"], mg["boundary_bytes"]) != (mc["split"], mc["boundary_bytes"]) or not (
            rel <= SSM_F32_REL and cos.min().item() >= SSM_F32_COS):
        raise AssertionError(f"{tag} pipeline: the card disagrees with the CPU")
    return launches


def hybrid_runs(torch, counters):
    """(d) jamba-1.5-large's pattern at smoke width, ``HYBRID_LAYERS``
    layers (SSM x7, attention at position 4, top-2 group-gated MoE at the
    odd positions, a block), random weights from seed 0: ``Model.prefill``
    of [2, 64] and 8 greedy steps, the dense ``ServingEngine`` at
    ``HYBRID_SERVE_LENS`` and the pipeline (rank 64), each in bf16 on the
    card (launches counted) and in f32 card against CPU.  Returns the bf16
    runs' launches summed."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.model import Model, to_device
    from repro_torch.models.transformer import compute_params

    cfg = smoke_config(get_config(HYBRID)).replace(num_layers=HYBRID_LAYERS)
    params = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cparams = compute_params(params, cfg)
    host32 = to_device(params, "cpu")
    cfg32 = cfg.replace(dtype="float32")
    log(f"{HYBRID} smoke: {cfg.num_layers} layers of "
        f"{''.join('A' if s.kind == 'attn' else 'S' for s in cfg.layer_pattern)} "
        f"(MoE at {[i for i, s in enumerate(cfg.layer_pattern) if s.moe]}), d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts in {cfg.moe.num_groups} groups, top-"
        f"{cfg.moe.top_k}, SSM d_state {cfg.ssm.d_state}, head_dim {cfg.ssm.head_dim}, chunk "
        f"{cfg.ssm.chunk_size}")
    tokens = pipeline_tokens(torch, cfg.vocab_size, 2, 64, seed=1)
    model = Model(cfg, device="cuda")
    (lg, _), gen_l = counted_run(counters, lambda: ssm_generate(torch, model, cparams,
                                                                 tokens, 8))
    log(f"hybrid bf16 prefill [2, 64] + 8 steps: launches "
        f"{ {k: v for k, v in gen_l.items() if v} }")
    only_path("hybrid bf16 model", gen_l, HYBRID_MODEL_PATH)
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("hybrid bf16: logits are not finite")
    card_equals_cpu(torch, "hybrid f32 prefill [2, 64] + 8 steps, card vs CPU",
                    ssm_generate(torch, Model(cfg32, device="cuda"), params, tokens, 8),
                    ssm_generate(torch, Model(cfg32, device="cpu"), host32, tokens, 8))
    (_, _), serve_l = counted_run(
        counters, lambda: dense_serve(torch, model, cparams, HYBRID_SERVE_LENS, 16, 160))
    log(f"hybrid bf16 serving ({len(HYBRID_SERVE_LENS)} requests, prompts "
        f"{HYBRID_SERVE_LENS}, 16 tokens): launches { {k: v for k, v in serve_l.items() if v} }")
    only_path("hybrid bf16 serving", serve_l, HYBRID_MODEL_PATH)
    _, card = dense_serve(torch, Model(cfg32, device="cuda"), params, HYBRID_SERVE_LENS, 16,
                          160)
    _, host = dense_serve(torch, Model(cfg32, device="cpu"), host32, HYBRID_SERVE_LENS, 16,
                          160)
    log(f"hybrid serving f32 card vs CPU: tokens equal {card == host}")
    if card != host:
        raise AssertionError("hybrid serving f32: the card's tokens differ from the CPU's")
    pipe_l = ssm_pipeline_runs(
        torch, "hybrid", cfg, params, cparams, host32, counters, 64,
        (*HYBRID_MODEL_PATH, *SSM_PIPELINE_PATH))
    return {k: gen_l[k] + serve_l[k] + pipe_l[k] for k in gen_l}


def ssm_kernels(torch, timer):
    """The kernels of phase 12's path at the hybrid's smoke shapes against
    their plain versions, timed beside their bound (and library call where
    one exists): the group gate (8 experts in 4 groups at d 128; decode's 8
    rows, the prefill's 128 and the pipeline's 1024, x in bf16 and f32),
    the expert FFN (d 128, f 128, gated silu, bf16 rows: top-2 of those
    rows), flash attention ([2, 64] and [4, 256], 4 heads on 2 of 32) and
    the codec (d 128, rank 64; mamba2's d 768, rank 384 is phase 2's);
    the profiler's device times read at the end."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.compression import init_lowrank_1d
    from repro_torch.core.gating import init_group_gate
    from repro_torch.kernels.expert_mlp import ffn_plan, grouped_mlp, grouped_mlp_plain
    from repro_torch.kernels.group_gate import group_gate, group_gate_plain

    cfg = smoke_config(get_config(HYBRID))
    E, K, d, f = cfg.moe.num_experts, cfg.moe.num_groups, cfg.d_model, cfg.moe.d_ff_expert
    gen = torch.Generator(device="cuda").manual_seed(12)
    p = init_group_gate(gen, d, cfg.moe)
    for T in (8, 128, 1024):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(T, d, generator=gen, device="cuda").to(dt)
            args = (x, p["w_local"], p["b_local"], p["w_global"], p["b_global"], None)
            probs, pg = group_gate(*args)
            rprobs, rpg = group_gate_plain(*args)
            tag = f"hybrid T={T} x {str(dt)[6:]}"
            check_close(f"group_gate probs {tag}", probs, rprobs, rtol=0, atol=1e-4)
            check_close(f"group_gate p_group {tag}", pg, rpg, rtol=0, atol=1e-4)
            if dt == torch.bfloat16:
                nbytes = T * d * 2 + d * (E + K) * 4 + (E + K) * 4 + T * (E + K) * 4
                b_ms, b_by = bound(nbytes, 2 * T * d * (E + K), "f32")
                call = functools.partial(group_gate, *args)
                ms, plain_ms = timer(call), timer(lambda: group_gate_plain(*args))
                timer.later(f"group_gate {tag}", call)
                log(f"  group_gate {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
                    f"{b_ms:.6f} ({b_by}) library_ms=null")
    wi, wg, wo = (torch.randn(E, a, b, generator=gen, device="cuda").div(a ** 0.5).bfloat16()
                  for a, b in ((d, f), (d, f), (f, d)))
    for T in (8, 128, 1024):
        n = 2 * T  # top-2
        cut = torch.sort(torch.randint(0, n + 1, (E - 1,), generator=gen, device="cuda")).values
        sizes = torch.diff(torch.cat([cut.new_zeros(1), cut, cut.new_full((1,), n)]))
        gs = sizes.int()
        xs = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
        args = (xs, gs, wi, wg, wo, "silu")
        y, ref = grouped_mlp(*args), grouped_mlp_plain(*args)
        check_close(f"expert_mlp hybrid n={n}", y, ref, rtol=0,
                    atol=2e-2 * ref.float().abs().max().item())
        routed = int((sizes > 0).sum())
        nbytes = 2 * n * d * 2 + routed * 3 * d * f * 2 + E * 4
        b_ms, b_by = bound(nbytes, 3 * 2 * n * d * f, "bf16")
        call = functools.partial(grouped_mlp, *args)
        ms, plain_ms = timer(call), timer(lambda: grouped_mlp_plain(*args))
        timer.later(f"expert_mlp hybrid n={n}", call)
        log(f"  expert_mlp hybrid n={n}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
            f"{b_ms:.6f} ({b_by}) library_ms=null path={ffn_plan(n, d, f, torch.bfloat16)}")
    for B, S in ((2, 64), (4, 256)):
        flash_case(torch, timer, gen, f"hybrid B={B} S={S} H=4 KV=2 hd=32", B, S, 4, 2, hd=32,
                   later=True)
    codec = init_lowrank_1d(torch.Generator().manual_seed(7), d, 64, device="cuda")
    codec_cases(torch, timer, gen, codec, (1024, 8), later=True)
    timer.read_later()


def ssm_phase(torch, timer, counters):
    """Phase 12: mamba2-130m at full width and depth (24 SSM layers, d_model
    768, 24 heads of 64, d_state 128, chunk 256, tied vocab 50280), random
    weights from seed 0 (f32 as stored, bf16 activations): (a) the model,
    (b) the dense-ring ``ServingEngine``, (c) ``EndCloudPipeline``; then
    (d) jamba's hybrid at smoke size through the same three, and the
    kernels at its shapes.  Returns each wrapper's launches summed over the
    bf16 runs of (a)-(d)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, leaves, to_device
    from repro_torch.models.transformer import compute_params

    cfg = get_config(SSM)
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cparams = compute_params(params, cfg)  # the bf16 copy every bf16 run reads
    host32 = to_device(params, "cpu")
    torch.cuda.synchronize()
    s = cfg.ssm
    log(f"{SSM}: {sum(t.numel() for t in leaves(params)) / 1e6:.3f} M params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, d_inner {s.expand * cfg.d_model} in "
        f"{s.expand * cfg.d_model // s.head_dim} heads of {s.head_dim}, d_state {s.d_state}, "
        f"chunk {s.chunk_size}, vocab {cfg.vocab_size} (tied); built in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    parts = []
    for tag, part in (
            ("(a) model", lambda: ssm_model(torch, cfg, params, cparams, host32, counters)),
            ("(b) dense-ring ServingEngine",
             lambda: ssm_serve(torch, cfg, params, cparams, host32, counters)),
            ("(c) EndCloudPipeline", lambda: ssm_pipeline_runs(
                torch, "ssm", cfg, params, cparams, host32, counters, 384,
                SSM_PIPELINE_PATH)),
            ("(d) jamba hybrid at smoke size", lambda: hybrid_runs(torch, counters))):
        t0 = time.perf_counter()
        log(f"ssm {tag}:")
        parts.append(part())
        log(f"ssm {tag} took {time.perf_counter() - t0:.1f} s")
    launches = {k: sum(p[k] for p in parts) for k in parts[0]}
    log(f"ssm launches over the bf16 runs of (a)-(d): "
        f"{ {k: v for k, v in launches.items() if v} }")
    only_path("ssm phase", launches, SSM_PATH)
    del params, cparams, host32
    t0 = time.perf_counter()
    log("ssm kernels against their plain versions at the hybrid's shapes (card):")
    ssm_kernels(torch, timer)
    log(f"ssm kernel checks took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: h2o-danube-3-4b (head_dim 120) at full width and depth
# ---------------------------------------------------------------------------

DANUBE = "h2o-danube-3-4b"
# paged attention at h2o-danube's serving shapes (32 query heads on 8 kv
# heads of 120): decode (C*G = 4 rows) and a prompt chunk (128 rows)
DANUBE_PA_CASES = (
    ("h2o-danube B=8 pps=16 C=1", 8, 16, 1, VLM_ANCHORS),
    ("h2o-danube B=8 pps=16 C=32", 8, 16, 32, VLM_ANCHORS),
)


def danube_kernels(torch, timer):
    """The head_dim-120 kernels against their plain versions at h2o-danube's
    shapes, timed beside their bound and SDPA: paged attention at decode
    over f32, bf16 and int8 pools and a 32-row chunk (the tensor-core body
    in bf16), flash attention [2, 256, 32/8, 120] causal with and without a
    64-key window, and the int8 KV write at a line of 8 x 120; the
    profiler's device times read at the end."""
    heads = (32, 8, 120)
    run_paged_attention(torch, timer, cases=DANUBE_PA_CASES[:1], heads=heads,
                        dtype=torch.float32)
    run_paged_attention(torch, timer, cases=DANUBE_PA_CASES, heads=heads)
    run_paged_attention(torch, timer, quant=True, cases=DANUBE_PA_CASES, heads=heads)
    gen = torch.Generator(device="cuda").manual_seed(13)
    for window in (None, 64):
        flash_case(torch, timer, gen, "h2o-danube B=2 S=256 H=32 KV=8 hd=120"
                   + (f" window={window}" if window else ""), 2, 256, 32, 8, hd=120,
                   window=window, later=True)
    run_kv_write(torch, timer, heads=(8, 120))
    timer.read_later()


def danube_phase(torch, timer, counters):
    """Phase 13 on h2o-danube-3-4b as the reference configures it (24
    layers, d_model 3840, 32 heads on 8 kv heads of 120, window 4096),
    random weights from seed 0 (f32 as stored, bf16 activations): the
    head_dim-120 kernels against their plain versions, then (b)
    ``ServingEngine``, (c) ``EndCloudPipeline``, (d) ``EndCloudServingEngine``
    with the int8 streams.  The f32 card-vs-CPU checks run the first
    ``VLM_CPU_LAYERS`` layers at full width: a CPU copy of the whole f32
    model is 15.8 GB.  Returns each wrapper's launches summed over
    (b)-(d)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, leaves, to_device
    from repro_torch.models.transformer import compute_params

    cfg = get_config(DANUBE)
    t0 = time.perf_counter()
    log("danube kernels against their plain versions at head_dim 120 (card):")
    danube_kernels(torch, timer)
    log(f"danube kernel checks took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cparams = compute_params(params, cfg)  # the bf16 copy every engine reads
    host32 = to_device(first_layers(params, VLM_CPU_LAYERS), "cpu")
    torch.cuda.synchronize()
    log(f"{DANUBE}: {sum(t.numel() for t in leaves(params)) / 1e9:.3f} B params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads on "
        f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, window {cfg.sliding_window}, vocab "
        f"{cfg.vocab_size}; built in {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    parts = []
    for tag, part in (
            ("(b) ServingEngine", lambda: vlm_serve(torch, cfg, params, cparams, counters,
                                                    tag="danube", check_layers=VLM_CPU_LAYERS)),
            ("(c) EndCloudPipeline",
             lambda: vlm_pipeline(torch, cfg, cparams, host32, counters, tag="danube")),
            ("(d) EndCloudServingEngine, int8 streams",
             lambda: vlm_stream(torch, cfg, cparams, host32, counters, tag="danube", f32=False,
                                spec=False, new=16, hi=SPEC_HI))):
        t0 = time.perf_counter()
        log(f"danube {tag}:")
        parts.append(part())
        log(f"danube {tag} took {time.perf_counter() - t0:.1f} s")
    launches = {k: sum(p[k] for p in parts) for k in parts[0]}
    log(f"danube launches over (b)-(d): { {k: v for k, v in launches.items() if v} }")
    missing = [k for k in VLM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"danube: path kernels never launched: {missing}")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: whisper-base's encoder-decoder through Model at full width and depth
# ---------------------------------------------------------------------------

ENCDEC = "whisper-base"
ENCDEC_B, ENCDEC_T = 4, 64  # decoder prompts on the 1500 encoder frames
ENCDEC_STEPS = 32  # greedy decode steps after the prefill
ENCDEC_MAX_LEN = 448  # whisper's text context


def encdec_batch(torch, cfg, B: int, T: int, seed: int):
    """CPU tensors: T tokens and ``encoder_seq_len`` frame embeddings (std
    1, f32) a row, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=g, dtype=torch.int32),
            "frame_embeds": torch.randn(B, cfg.encoder_seq_len, cfg.d_model, generator=g)}


def encdec_generate(torch, model, params, batch, steps: int, counters=(), step_s=None):
    """``Model.prefill`` of ``batch`` (the frames in the model's activation
    type, rings of ``ENCDEC_MAX_LEN``) then ``steps`` greedy ``decode_step``
    s: (logits over the real vocabulary [steps + 1, B, V], f32 on the host;
    their argmax; the cache; the prefill's launches; the decode steps'
    launches), each step's synchronized host time appended to ``step_s``."""
    cfg = model.cfg
    b = {"tokens": batch["tokens"].to(model.device),
         "frame_embeds": batch["frame_embeds"].to(model.device, cfg.torch_dtype)}
    out = []
    with torch.no_grad():
        (logits, cache), pre = counted_run(
            counters, lambda: model.prefill(params, b, max_len=ENCDEC_MAX_LEN))

        def decode():
            nonlocal logits, cache
            for i in range(steps + 1):
                out.append(logits.float().cpu())
                if i < steps:
                    t = time.perf_counter()
                    logits, cache = model.decode_step(
                        params, logits.argmax(-1).int()[:, None], cache)
                    if step_s is not None:
                        torch.cuda.synchronize()
                        step_s.append(time.perf_counter() - t)

        _, dec = counted_run(counters, decode)
    lg = torch.stack(out)[..., :cfg.vocab_size]
    return lg, lg.argmax(-1), cache, pre, dec


def encdec_model(torch, cfg, params, cparams, host32, counters):
    """(a) ``Model.prefill`` of ``ENCDEC_B`` rows of 1500 frames and
    ``ENCDEC_T`` tokens, then ``ENCDEC_STEPS`` greedy decode steps, full
    depth in bf16: 18 flash launches a prefill (6 encoder, 6 self, 6 cross,
    the encoder's 6 counted alone too), none in a decode step, no other
    wrapper.  (d) A profiled decode step: the cross-attention's share, the
    cross cache's bytes a slot, device memory.  (b) f32 card against CPU at
    full depth: tokens equal, logits within ``SSM_F32_REL`` of max.  Returns
    the bf16 run's launches."""
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    L, E = cfg.num_layers, cfg.encoder_layers
    model = Model(cfg, device="cuda")
    batch = encdec_batch(torch, cfg, ENCDEC_B, ENCDEC_T, seed=0)
    frames = batch["frame_embeds"].to("cuda", cfg.torch_dtype)
    with torch.no_grad():
        _, enc = counted_run(counters,
                             lambda: transformer.apply_encoder(cparams, frames, cfg))
    log(f"encdec encoder alone [{ENCDEC_B}, {cfg.encoder_seq_len}, {cfg.d_model}]: launches "
        f"{ {k: v for k, v in enc.items() if v} }")
    if enc["flash_attention_fwd"] != E or any(
            v for k, v in enc.items() if k != "flash_attention_fwd"):
        raise AssertionError(f"encdec encoder: launches {enc}, want {E} flash attention")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    t0 = time.perf_counter()
    lg, tok, cache, pre, dec = encdec_generate(torch, model, cparams, batch, ENCDEC_STEPS,
                                               counters, step_s)
    run_s = time.perf_counter() - t0
    want = {c.__name__: 0 for c in counters}
    want["flash_attention_fwd"] = E + 2 * L
    log(f"encdec prefill [{ENCDEC_B}, {ENCDEC_T} tokens on {cfg.encoder_seq_len} frames] and "
        f"{ENCDEC_STEPS} decode steps (bf16, {L} decoder and {E} encoder layers): {run_s:.2f} s; "
        f"decode step median {sorted(step_s)[len(step_s) // 2] * 1e3:.3f} ms (host clock, "
        f"synchronized); prefill launches { {k: v for k, v in pre.items() if v} }, decode "
        f"launches { {k: v for k, v in dec.items() if v} }; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if pre != want or any(dec.values()):
        raise AssertionError(f"encdec: prefill launches {pre}, want {want}; decode launches "
                             f"{dec}, want none (dense rings and the cross cache)")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("encdec: logits are not finite")
    cross = sum(leaf.numel() * leaf.element_size() for n, leaf in cache["blocks"]["pos0"].items()
                if n in ("xk", "xv"))
    ring = sum(leaf.numel() * leaf.element_size() for n, leaf in cache["blocks"]["pos0"].items()
               if n in ("k", "v"))
    log(f"encdec cache a slot: cross (xk, xv) {cross // ENCDEC_B} B, self rings of "
        f"{ENCDEC_MAX_LEN} {ring // ENCDEC_B} B; device memory "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")

    tokens = tok[-1].int().cuda()[:, None]
    with torch.no_grad():
        dev_ms, wall_ms, _ = profiled(
            torch, lambda: model.decode_step(cparams, tokens, cache), "encdec_decode_profile.txt",
            ())
        total, part = step_shares(torch, lambda: model.decode_step(cparams, tokens, cache),
                                  transformer, ("_cross_attention_decode",))
    ms = part["_cross_attention_decode"]
    log(f"encdec decode profile (1 step, {ENCDEC_B} rows): device time {dev_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall ({dev_ms / wall_ms:.1%} busy); written to "
        f"chiprun_out/encdec_decode_profile.txt. Annotated step: {total:.3f} ms of kernels, "
        f"cross-attention {ms:.3f} ms ({ms / max(total, 1e-9):.1%}, {L} calls)")

    cfg32 = cfg.replace(dtype="float32")
    t0 = time.perf_counter()
    card = encdec_generate(torch, Model(cfg32, device="cuda"), params, batch, ENCDEC_STEPS)
    t1 = time.perf_counter()
    host = encdec_generate(torch, Model(cfg32, device="cpu"), host32, batch, ENCDEC_STEPS)
    rel, cos = logit_gap(torch, lg[0], card[0][0], cfg.vocab_size)
    log(f"encdec bf16 prefill logits against the card's f32: max|diff|/max|f32|={rel:.3e} "
        f"cos={cos.min().item():.5f} (reported)")
    card_equals_cpu(torch, f"encdec f32 prefill + {ENCDEC_STEPS} steps, card vs CPU ({L} + {E} "
                    f"layers; card {t1 - t0:.1f} s, CPU {time.perf_counter() - t1:.1f} s)",
                    card[:2], host[:2])
    return {k: pre[k] + dec[k] for k in pre}


def encdec_kernels(torch, timer):
    """Flash attention against its plain version at whisper's shapes, not
    causal: the encoder's [4, 1500, 8, 64] and the cross-attention's 64
    queries a row on 1500 frames, in bf16 and f32, timed beside the bound
    and SDPA (``is_causal=False``); the profiler's device times read at the
    end."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        flash_case(torch, timer, gen, f"whisper encoder B=4 S=1500 H=8 hd=64 {name}", 4, 1500,
                   8, 8, hd=64, causal=False, dtype=dt, later=True)
        flash_case(torch, timer, gen, f"whisper cross B=4 Sq=64 Skv=1500 H=8 hd=64 {name}", 4,
                   64, 8, 8, hd=64, causal=False, Skv=1500, dtype=dt, later=True)
    timer.read_later()


def encdec_phase(torch, timer, counters):
    """Phase 14: whisper-base as the reference configures it (6 decoder
    layers of self- and cross-attention over a 6-layer bidirectional
    encoder of 1500 frames, d_model 512, 8 heads of 64, vocab 51865),
    random weights from seed 0 (f32 as stored, bf16 activations), frame
    embeddings from a seeded generator: ``encdec_model``, then flash
    attention at its shapes.  Returns the bf16 run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, leaves, to_device
    from repro_torch.models.transformer import compute_params

    cfg = get_config(ENCDEC)
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cparams = compute_params(params, cfg)
    host32 = to_device(params, "cpu")
    torch.cuda.synchronize()
    log(f"{ENCDEC}: {sum(t.numel() for t in leaves(params)) / 1e6:.3f} M params, "
        f"{cfg.num_layers} decoder layers (self + cross), {cfg.encoder_layers} encoder layers "
        f"over {cfg.encoder_seq_len} frames, d_model {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}; built in {time.perf_counter() - t0:.1f} s")
    launches = encdec_model(torch, cfg, params, cparams, host32, counters)
    del params, cparams, host32
    t0 = time.perf_counter()
    log("encdec flash attention against its plain version at whisper's shapes (card):")
    encdec_kernels(torch, timer)
    log(f"encdec kernel checks took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: training (switch-base at full width)
# ---------------------------------------------------------------------------

TRAIN = "switch-base"
TRAIN_B, TRAIN_S = 4, 256  # the paper's setting: batch 4 x seq 256
TRAIN_STEPS = 20
TRAIN_CKPT_EVERY = 10
TRAIN_SMALL_LAYERS = 2  # (c) and (e): 1 block at full width, f32
# lr 3e-4, the reference's default: at 1e-3 the reference's own train step
# does not learn at full width (f32, 4 layers, these 30 batches on the CPU:
# the mean loss of the last 5 steps 11.45 against the first 5's 11.22, with
# spikes to 14.2; at 3e-4 10.84 against 11.06), since AdamW moves every
# weight by about lr a step and a 768-wide layer's output by about 768 lr
TRAIN_OPT = dict(lr=3e-4, warmup_steps=5)
# launches a train step of full-depth switch-base (12 layers, 6 of them MoE,
# each block recomputed once in the backward)
TRAIN_PER_STEP = {"flash_attention_fwd": 24, "flash_attention_bwd": 12, "group_gate": 12,
                  "grouped_mlp": 12}
# (name, B, Sq, Skv, H, KV, hd, causal, window, bf16)
BWD_CASES = (
    ("switch-base [4,256,12,64] causal bf16", 4, 256, 256, 12, 12, 64, True, None, True),
    ("switch-base [4,256,12,64] causal f32", 4, 256, 256, 12, 12, 64, True, None, False),
    ("gqa [2,256,40/8,128] causal bf16", 2, 256, 256, 40, 8, 128, True, None, True),
    ("h2o-danube [2,256,32/8,120] window 64 bf16", 2, 256, 256, 32, 8, 120, True, 64, True),
    ("whisper encoder [4,1500,8,64] bf16", 4, 1500, 1500, 8, 8, 64, False, None, True),
    ("cross [4, 64 on 1500, 8, 64] bf16", 4, 64, 1500, 8, 8, 64, False, None, True),
)


def bwd_case(torch, timer, gen, name, B, Sq, Skv, H, KV, hd, causal, window, bf16):
    """The flash backward kernel against its plain version (the reference's
    ``_bwd``) on the card at one shape: dq, dk and dv within 1e-4 (f32) or
    2e-2 (bf16) of each one's largest |value|, and the forward kernel's
    log-sum-exp within 1e-5 relative of the plain forward's; the kernel's
    time (flushed), the plain version's, the bound (each input and output
    moved once; the five products over the visible pairs) and, as a
    yardstick the port never calls, SDPA's backward through autograd on
    [B, H, S, hd] copies (kv heads repeated; its forward run once before),
    and its forward and backward together; the device times queued.
    Returns the record."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import block_mask

    dtype = torch.bfloat16 if bf16 else torch.float32
    q, dout = (torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype) for _ in "qo")
    k, v = (torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype) for _ in "kv")
    kw = dict(causal=causal, window=window, q_offset=0)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    _, lse_plain = flash_attention_plain(q, k, v, return_lse=True, **kw)
    lse_err = ((lse - lse_plain).abs() / lse_plain.abs().clamp_min(1.0)).max().item()
    if not lse_err <= 1e-5:
        raise AssertionError(f"flash_attention {name}: lse disagrees ({lse_err:.3e})")
    got = flash_attention_bwd(dout, q, k, v, out, lse, **kw)
    want = flash_attention_bwd_plain(dout, q, k, v, out, lse, **kw)
    rel = 2e-2 if bf16 else 1e-4
    errs = []
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        errs.append(err)
        if not err <= rel * scale:
            raise AssertionError(f"flash_attention_bwd {name}: {what} max|diff| {err:.3e} > "
                                 f"{rel} x {scale:.3e}")
    vis = block_mask(torch.arange(Sq, device="cuda"), torch.arange(Skv, device="cuda"), causal,
                     window)
    isz = 2 if bf16 else 4
    nbytes = (4 * q.numel() + 4 * k.numel()) * isz + lse.numel() * 4
    b_ms, b_by = bound(nbytes, 5 * 2 * hd * B * H * int(vis.sum()), "bf16" if bf16 else "f32")
    call = functools.partial(flash_attention_bwd, dout, q, k, v, out, lse, **kw)
    ms = timer(call)
    plain_ms = timer(lambda: flash_attention_bwd_plain(dout, q, k, v, out, lse, **kw),
                     iters=3, warmup=1)
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
              for t in (k, v))
    dot = dout.transpose(1, 2).contiguous()
    sdpa_kw = dict(is_causal=causal) if window is None else dict(attn_mask=vis)
    o_t = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

    def sdpa_bwd():
        torch.autograd.grad(o_t, (qt, kt, vt), dot, retain_graph=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw), (qt, kt, vt),
                            dot)

    lib_ms = timer(sdpa_bwd)
    lib_fb_ms = timer(sdpa_fwd_bwd)
    timer.later(f"flash_attention_bwd {name}", call,
                lambda: f"sdpa bwd {timer.device_us(sdpa_bwd)[0]:.3f}")
    log(f"  flash_attention_bwd {name}: max_abs_err dq/dk/dv="
        f"{'/'.join(f'{e:.2e}' for e in errs)} (<= {rel} x max) lse {lse_err:.1e}; "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
        f"library_ms(sdpa bwd)={lib_ms:.4f} sdpa fwd+bwd {lib_fb_ms:.4f}")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def train_kernels(torch, timer):
    """(a) ``BWD_CASES``; the profiler's device times read at the end.
    Returns switch-base's bf16 record (the shape phase 15's training runs)
    with the largest error over every case."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    recs = [bwd_case(torch, timer, gen, *case) for case in BWD_CASES]
    timer.read_later()
    main = dict(recs[0])
    main["max_abs_err"] = max(r["max_abs_err"] for r in recs)
    return main


def grads_close(tag, card, host) -> float:
    """Gradient leaves of the card (``card``) against the CPU's (``host``):
    each within 1e-4 of its largest |value| on the CPU, and no leaf all 0
    on the card where the CPU's is not (a gradient the card lost).
    Returns the worst leaf's gap over its largest |value|."""
    worst = 0.0
    for i, (g, c) in enumerate(zip(card, host)):
        g = g.cpu()
        scale = c.abs().max().item()
        err = (g - c).abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        if not err <= 1e-4 * scale or (g.abs().max().item() == 0 and scale > 0):
            raise AssertionError(f"{tag}: gradient leaf {i} card vs CPU max|diff| {err:.3e} of "
                                 f"{scale:.3e}, or all 0 on the card only")
    return worst


def grads_card_vs_cpu(torch, tag, fn, leaves):
    """``fn(*leaves)`` -> a scalar, on the card and on the CPU from the same
    f32 leaves: :func:`grads_close` of the two runs' gradients."""
    grads = {}
    for dev in ("cpu", "cuda"):
        xs = [t.to(dev, copy=True).requires_grad_(t.is_floating_point()) for t in leaves]
        grads[dev] = torch.autograd.grad(fn(*xs), [x for x in xs if x.requires_grad])
    return grads_close(tag, grads["cuda"], grads["cpu"])


def train_functions(torch):
    """(b) The gate's and the expert FFN's autograd Functions at switch-base's
    width on the card (their forward kernels; the backward in PyTorch ops)
    against the same Functions on the CPU, in f32: the gate on 1024 tokens
    without a mask and with a dead group, the FFN on 1024 sorted rows over 8
    experts (one group empty)."""
    from repro_torch.configs import get_config
    from repro_torch.core.gating import init_group_gate
    from repro_torch.kernels.expert_mlp import grouped_mlp
    from repro_torch.kernels.group_gate import group_gate

    cfg = get_config(TRAIN)
    m = cfg.moe
    T, d, f, E, K = TRAIN_B * TRAIN_S, cfg.d_model, m.d_ff_expert, m.num_experts, m.num_groups
    gen = torch.Generator().manual_seed(15)
    gp = init_group_gate(gen, d, m)
    x = torch.randn(T, d, generator=gen)
    r1, r2 = torch.randn(T, E, generator=gen), torch.randn(T, K, generator=gen)
    names = ("w_local", "b_local", "w_global", "b_global")
    for mask in (None, torch.tensor([1, 1, 0, 0, 1, 0, 1, 1], dtype=torch.bool)):
        before = group_gate.launches

        def gate_loss(xx, *ps):
            mm = None if mask is None else mask.to(xx.device)
            probs, pg = group_gate(xx, *ps, mm)
            return (probs * r1.to(xx.device)).sum() + (pg * r2.to(xx.device)).sum()

        worst = grads_card_vs_cpu(torch, "gate", gate_loss, [x] + [gp[k] for k in names])
        assert group_gate.launches == before + 1
        log(f"  gate Function, T={T} {'dead group' if mask is not None else 'no mask'}: "
            f"card = CPU (worst leaf {worst:.2e} of its max)")
    sizes = torch.tensor([200, 0, 150, 300, 100, 74, 150, 50], dtype=torch.int32)
    xs = torch.randn(T, d, generator=gen)
    wi = torch.randn(E, d, f, generator=gen) / d ** 0.5
    wo = torch.randn(E, f, d, generator=gen) / f ** 0.5
    dy = torch.randn(T, d, generator=gen)
    before = grouped_mlp.launches
    worst = grads_card_vs_cpu(
        torch, "expert FFN",
        lambda a, s, w1, w2: (grouped_mlp(a, s, w1, None, w2, cfg.act) * dy.to(a.device)).sum(),
        [xs, sizes, wi, wo])
    assert grouped_mlp.launches == before + 1
    log(f"  expert FFN Function, n={T} over {E} experts (one empty): card = CPU (worst leaf "
        f"{worst:.2e} of its max)")


def route_log(torch):
    """A context that records every ``select_topk``'s expert ids (on the
    host) into the list it yields."""
    import contextlib

    from repro_torch.core import gating

    @contextlib.contextmanager
    def recording():
        routes, saved = [], gating.select_topk

        def select(probs, top_k, renormalize=True):
            idx, w = saved(probs, top_k, renormalize)
            routes.append(idx.cpu())
            return idx, w

        gating.select_topk = select
        try:
            yield routes
        finally:
            gating.select_topk = saved

    return recording()


def train_batches(cfg, n: int, seed: int):
    """``n`` batches of ``data.pipeline``'s ``lm`` task at the model's
    vocabulary, [TRAIN_B, TRAIN_S]."""
    from repro_torch.data.pipeline import DataConfig, batches

    return list(batches(DataConfig(task="lm", vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                   seed=seed), TRAIN_B, n))


def params_after_steps_close(torch, tag, got, want, lr_steps):
    """Params of two runs after Adam steps: every element within ``lr``
    a step (Adam's first update turns a gradient element near eps, most
    of whose bits are rounding, into any update up to lr), all but 1% of
    a leaf's within 1e-5 + 1e-5 |p|."""
    from repro_torch.training.optimizer import tree_leaves

    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        diff = (a.cpu().float() - b.float()).abs()
        if not (diff.max().item() <= lr_steps
                and (diff > 1e-5 + 1e-5 * b.abs()).float().mean().item() <= 0.01):
            raise AssertionError(f"{tag}: params after the steps differ (max {diff.max():.3e})")


def train_step_card_vs_cpu(torch):
    """(c) The train step at full width and 2 blocks, f32, card against CPU
    from the same params: the loss's gradients (every leaf within 1e-4 of
    its largest |value|, no leaf all 0 on the card only), then 2 AdamW steps of
    ``make_train_step``: routes (every ``select_topk``'s ids, the
    recomputations included) equal, loss and ``grad_norm`` within 1e-5
    relative, the routing statistics equal, and the params after."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.training import optimizer as opt_mod

    cfg = get_config(TRAIN).replace(num_layers=TRAIN_SMALL_LAYERS, dtype="float32")
    params = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    host = opt_mod.tree_map(lambda t: t.to("cpu", copy=True), params)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in train_batches(cfg, 2, 0)]
    ocfg = opt_mod.OptimizerConfig(**TRAIN_OPT)
    runs = {}
    for dev, p in (("cuda", params), ("cpu", host)):
        model = Model(cfg, device=dev)
        t0 = time.perf_counter()
        with route_log(torch) as routes:
            _, metrics, grads = steps.loss_and_grads(
                steps.make_loss_fn(model), p, {k: v.to(dev) for k, v in batches[0].items()})
        grads = opt_mod.tree_map(lambda t: t.cpu(), grads)
        state, step, seen = opt_mod.init_optimizer("adamw", p), steps.make_train_step(model, ocfg), []
        for b in batches:
            with route_log(torch) as step_routes:
                p, state, m = step(p, state, {k: v.to(dev) for k, v in b.items()})
            seen.append(({k: v.cpu() for k, v in m.items() if isinstance(v, torch.Tensor)},
                         step_routes))
        runs[dev] = (metrics, routes, grads, seen, p)
        log(f"  train step {dev}: {time.perf_counter() - t0:.1f} s (gradients + 2 steps)")
    (mg, rg, gg, sg, pg), (mc, rc, gc, sc, pc) = runs["cuda"], runs["cpu"]
    if len(rg) != len(rc) or not all(torch.equal(a, b) for a, b in zip(rg, rc)):
        raise AssertionError("train step: routes differ card vs CPU")
    worst = grads_close("train step", opt_mod.tree_leaves(gg), opt_mod.tree_leaves(gc))
    for i, ((m1, r1), (m2, r2)) in enumerate(zip(sg, sc)):
        rel = {k: abs(m1[k].item() - m2[k].item()) / abs(m2[k].item())
               for k in ("loss", "grad_norm")}
        same = (all(torch.equal(a, b) for a, b in zip(r1, r2)) and len(r1) == len(r2)
                and all(torch.equal(m1[k], m2[k]) for k in ("expert_frac", "group_frac")))
        log(f"  step {i + 1}: loss {m1['loss'].item():.6f} vs CPU {m2['loss'].item():.6f}, "
            f"relative gaps loss {rel['loss']:.2e} grad_norm {rel['grad_norm']:.2e}, routes "
            f"and routing statistics equal {same}")
        if not (same and max(rel.values()) <= 1e-5):
            raise AssertionError(f"train step {i + 1}: card disagrees with the CPU")
    params_after_steps_close(torch, "train step", pg, pc, ocfg.lr * 2)
    log(f"  gradients at the first step: card = CPU (worst leaf {worst:.2e} of its max, "
        f"{len(opt_mod.tree_leaves(gc))} leaves, none all 0 on the card only); "
        f"{len(rc)} routes equal")


def profile_train_step(torch, step, params, state, batch, name="train_step_profile.txt"):
    """One train step under ``torch.profiler``: (device ms, synchronized
    wall ms, the top device ops by time); the table goes to
    ``chiprun_out/<name>``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    avgs = prof.key_averages()
    (OUT_DIR / name).write_text(
        avgs.table(sort_by="cuda_time_total", row_limit=50))
    dev = sorted((e for e in avgs if e.device_type != DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in dev) / 1e3
    top = "; ".join(f"{short_name(e.key)} {e.self_device_time_total / 1e3:.3f} ms x {e.count}"
                    for e in dev[:8])
    return total, wall, top


def train_bf16_run(torch, counters):
    """(d) ``Trainer`` on full-width, full-depth switch-base: f32 master
    params from seed 0, bf16 compute, AdamW (``TRAIN_OPT``),
    ``TRAIN_STEPS`` steps on the ``lm`` task, a synchronous checkpoint
    every ``TRAIN_CKPT_EVERY`` steps into a temporary directory (the last
    one kept).  Every loss finite, the mean of the last 5 below the first
    5's; exactly ``TRAIN_PER_STEP`` launches a step and no other kernel;
    the median step time, tokens/s, peak device memory, and one profiled
    step.  Returns the run's launches."""
    import statistics
    import tempfile

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.training.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN)
    data = train_batches(cfg, TRAIN_STEPS + 1, 0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tr = Trainer(cfg, iter(data[:-1]), trainer_cfg=TrainerConfig(
            total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY, checkpoint_dir=tmp,
            keep_checkpoints=1, async_checkpoint=False, log_every=1),
            opt_cfg=OptimizerConfig(**TRAIN_OPT), device="cuda", seed=0).initialize()
        torch.cuda.synchronize()
        n = sum(t.numel() for t in tree_leaves(tr.params))
        log(f"{TRAIN}: {n / 1e6:.1f} M params (f32 master; AdamW state {8 * n / 2**30:.2f} "
            f"GiB), {cfg.num_layers} layers, built in {time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches = counted_run(counters, tr.run)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ckpts = Checkpointer(tmp).all_steps()
        losses = [m["loss"] for m in out["log"]]
        times = [m["step_time_s"] for m in out["log"]]
        log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
        ok = (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses)
              and statistics.mean(losses[-5:]) < statistics.mean(losses[:5]))
        per_step = {k: launches[k] / TRAIN_STEPS for k in TRAIN_PER_STEP}
        log(f"  {TRAIN_STEPS} steps in {run_s:.1f} s ({TRAIN_STEPS // TRAIN_CKPT_EVERY + 1} "
            f"checkpoint writes of the state included); "
            f"mean loss of the first 5 {statistics.mean(losses[:5]):.4f}, of the last 5 "
            f"{statistics.mean(losses[-5:]):.4f}; launches a step {per_step}; checkpoints "
            f"kept {ckpts}; restores {out['restores']}")
        med = statistics.median(times[1:])
        log(f"  step time median {med * 1e3:.1f} ms (host clock at the synchronizing "
            f"float(loss); first step {times[0] * 1e3:.1f} ms), "
            f"{TRAIN_B * TRAIN_S / med:.0f} tokens/s, peak device memory {peak / 2**30:.2f} GiB")
        if not ok or out["restores"] or ckpts != [TRAIN_STEPS]:
            raise AssertionError("train: the losses did not fall, were not finite, or a step "
                                 "was restored")
        if per_step != {k: float(n) for k, n in TRAIN_PER_STEP.items()}:
            raise AssertionError(f"train: launches a step {per_step}, want {TRAIN_PER_STEP}")
        only_path("train", launches, TRAIN_PER_STEP)
        batch = {k: torch.from_numpy(v).cuda() for k, v in data[-1].items()}
        step = steps.make_train_step(tr.model, tr.opt_cfg)
        dev_ms, wall_ms, top = profile_train_step(torch, step, tr.params, tr.opt_state, batch)
        log(f"  profiled step: device {dev_ms:.3f} ms in {wall_ms:.1f} ms wall "
            f"({100 * dev_ms / wall_ms:.1f}% busy); top device ops: {top}")
        del tr
    return launches


def train_resume_and_guard(torch):
    """(e) f32 at 2 blocks: a run of 6 steps (asynchronous checkpoints every
    3), then a trainer that resumes from its step-3 checkpoint, fed the same
    batches from step 4 on: its losses of steps 4-6 within 1e-5 relative
    of the first run's; then a run whose ``FailureInjector`` fails step 4
    makes exactly one restore and finishes."""
    import itertools
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN).replace(num_layers=TRAIN_SMALL_LAYERS, dtype="float32")
    data = train_batches(cfg, 6, 1)

    def trainer(where, it, injector=None):
        return Trainer(cfg, it, trainer_cfg=TrainerConfig(
            total_steps=6, checkpoint_every=3, checkpoint_dir=where, keep_checkpoints=3,
            async_checkpoint=True, log_every=1), opt_cfg=OptimizerConfig(**TRAIN_OPT),
            failure_injector=injector, device="cuda", seed=0).initialize()

    with tempfile.TemporaryDirectory() as tmp:
        full = trainer(f"{tmp}/full", iter(data)).run()
        os.makedirs(f"{tmp}/resumed")
        shutil.copytree(f"{tmp}/full/step_00000003", f"{tmp}/resumed/step_00000003")
        tr = trainer(f"{tmp}/resumed", iter(data[3:]))
        if tr.step != 3:
            raise AssertionError(f"resume: started at step {tr.step}, want 3")
        again = tr.run()
        want = [m["loss"] for m in full["log"][3:]]
        got = [m["loss"] for m in again["log"]]
        gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        log(f"  resumed from step 3: losses of steps 4-6 {' '.join(f'{x:.6f}' for x in got)} "
            f"against {' '.join(f'{x:.6f}' for x in want)} (largest relative gap {gap:.1e})")
        if len(got) != 3 or not gap <= 1e-5:
            raise AssertionError("resume: the resumed run's losses differ")
        guard = trainer(f"{tmp}/guard", itertools.cycle(data), FailureInjector(fail_steps=(4,)))
        out = guard.run()
        log(f"  FailureInjector at step 4: restores {out['restores']}, final step "
            f"{out['final_step']}")
        if out["restores"] != 1 or out["final_step"] != 6:
            raise AssertionError("guard: want exactly one restore and 6 steps")


def train_phase(torch, timer, counters):
    """Phase 15: training (``--train`` runs it alone): (a) the flash
    backward kernel at ``BWD_CASES``, (b) the gate's and FFN's Functions
    card vs CPU, (c) the train step card vs CPU at 2 blocks, (d) bf16
    ``Trainer`` at full width and depth, (e) resume and guard.  Returns
    (the backward kernel's record, (d)'s launches over ``counters`` and
    the backward kernel's)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    counters = list(counters) + [flash_attention_bwd]
    t0 = time.perf_counter()
    log("(a) flash attention backward against its plain version (card):")
    rec = train_kernels(torch, timer)
    log(f"(a) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    log("(b) the gate's and the expert FFN's autograd Functions, card vs CPU (f32):")
    train_functions(torch)
    log(f"(b) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    log(f"(c) the train step at full width, {TRAIN_SMALL_LAYERS} layers, f32, card vs CPU:")
    train_step_card_vs_cpu(torch)
    log(f"(c) took {time.perf_counter() - t1:.1f} s")
    gc.collect()
    t1 = time.perf_counter()
    log(f"(d) bf16 training at full width and depth ({TRAIN_STEPS} steps, Trainer):")
    launches = train_bf16_run(torch, counters)
    log(f"(d) took {time.perf_counter() - t1:.1f} s")
    gc.collect()
    t1 = time.perf_counter()
    log(f"(e) resume and guard ({TRAIN_SMALL_LAYERS} layers, f32):")
    train_resume_and_guard(torch)
    log(f"(e) took {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 16: training, second half (the dispatch codec's joint eq. 8 loss, SSM
# and encoder-decoder training)
# ---------------------------------------------------------------------------

TRAIN2_STEPS = 3
# (rows, d, rank, bf16): the fused plan at phase 16(c)'s codec shape and at
# 8 rows, the composed plan (rank 1024 > 512) at qwen3-moe's width
CODEC_FN_CASES = ((1024, 768, 384, True), (1024, 768, 384, False), (8, 768, 384, True),
                  (8, 768, 384, False), (256, 4096, 1024, True), (256, 4096, 1024, False))
# launches a train step at full depth, each block recomputed once in the
# backward: the codec model's 6 MoE layers run 2 roundtrips each, twice;
# mamba2's SSM is plain PyTorch; whisper's 6 encoder layers run outside the
# recomputation (6 forward, 6 backward) and its 6 decoder layers' self and
# cross attention inside it (24 forward, 12 backward)
TRAIN2_PER_STEP = {
    "codec": {"lowrank_roundtrip_loss": 24, "flash_attention_fwd": 24,
              "flash_attention_bwd": 12, "group_gate": 12, "grouped_mlp": 12},
    "mamba2": {},
    "whisper": {"flash_attention_fwd": 30, "flash_attention_bwd": 18},
}


def codec_function_case(torch, timer, gen, T, d, r, bf16):
    """(a) ``RoundtripLossFn`` on the card against autograd of the plain
    version on the same inputs (E, D f32 masters cast to the rows' type,
    as the MoE layer casts them): X̂, dX, dE, dD within 1e-5 (f32) or
    2^-6 (bf16) of each one's largest |value|; the launch counters rise by
    the plan's kernels; one forward and backward's time, the Function's
    and the plain version's (flushed).  Returns the largest error over
    each one's largest |value|."""
    from repro_torch.kernels.lowrank import (
        lowrank_decode,
        lowrank_encode,
        lowrank_roundtrip_loss,
        lowrank_roundtrip_loss_plain,
        roundtrip_loss,
        roundtrip_plan,
    )

    dtype = torch.bfloat16 if bf16 else torch.float32
    x = torch.randn(T, d, generator=gen, device="cuda")
    e = torch.linalg.qr(torch.randn(d, r, generator=gen, device="cuda"))[0].contiguous()
    dec = e.T.contiguous() + 0.01 * torch.randn(r, d, generator=gen, device="cuda")
    up = torch.randn(T, d, generator=gen, device="cuda").to(dtype)

    def run(fn):
        xs = x.to(dtype).requires_grad_(True)
        es, ds = e.clone().requires_grad_(True), dec.clone().requires_grad_(True)
        x_hat, _, mean = fn(xs, es.to(dtype), ds.to(dtype))
        ((x_hat * up).float().sum() + 0.05 * mean).backward()
        return x_hat, (xs.grad, es.grad, ds.grad)

    counters = (lowrank_roundtrip_loss, lowrank_encode, lowrank_decode)
    before = [c.launches for c in counters]
    got_hat, got = run(roundtrip_loss)
    plan = roundtrip_plan(r)
    rose = [c.launches - b for c, b in zip(counters, before)]
    if rose != ([1, 0, 0] if plan == "fused" else [0, 1, 1]):
        raise AssertionError(f"codec Function {plan} [{T}, {d}] r {r}: launches {rose}")
    if type(got_hat.grad_fn).__name__ != "RoundtripLossFnBackward":
        raise AssertionError("codec Function: X̂ has no RoundtripLossFn graph")
    want_hat, want = run(lowrank_roundtrip_loss_plain)
    rel = 2 ** -6 if bf16 else 1e-5
    worst = 0.0
    for what, g, w in zip(("x_hat", "dx", "denc", "ddec"), (got_hat, *got), (want_hat, *want)):
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        worst = max(worst, err / scale)
        if not err <= rel * scale:
            raise AssertionError(f"codec Function {plan} [{T}, {d}] r {r} {dtype}: {what} "
                                 f"max|diff| {err:.3e} > {rel} x {scale:.3e}")
    ms = timer(lambda: run(roundtrip_loss), iters=10, warmup=2)
    plain_ms = timer(lambda: run(lowrank_roundtrip_loss_plain), iters=10, warmup=2)
    dev = ""
    if T == 1024 and bf16:  # the codec model's shape: device time too (host-bound above)
        us, per = timer.device_us(lambda: run(roundtrip_loss), iters=10)
        plain_us, _ = timer.device_us(lambda: run(lowrank_roundtrip_loss_plain), iters=10)
        dev = (f"; device {us:.1f} us [{short_names(per)}], the plain version's "
               f"{plain_us:.1f} us")
    log(f"  codec Function {plan} [{T}, {d}] rank {r} {'bf16' if bf16 else 'f32'}: "
        f"X̂, dX, dE, dD within {worst:.2e} of max (<= {rel:.2e}); forward + backward "
        f"{ms:.4f} ms, plain version through autograd {plain_ms:.4f} ms (flushed, the "
        f"host's autograd included){dev}")
    return worst


def train2_frames(torch, cfg, dtype, seed):
    """Seeded stand-ins for whisper's audio frames, [TRAIN_B, 1500, d]."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(TRAIN_B, cfg.encoder_seq_len, cfg.d_model, generator=g).to(dtype)


def train2_card_vs_cpu(torch, tag, cfg, batch):
    """(b) One f32 train step, card against CPU from the same params and
    batch: the gradients at the params (every leaf within 1e-4 of its
    largest |value|, none all 0 on the card only), then one
    ``make_train_step`` (cfg's optimizer, ``TRAIN_OPT``): routes (every
    ``select_topk``'s ids) equal, loss, ``recon_loss`` and grad norm
    within 1e-5 relative, routing statistics equal, the params after."""
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.training import optimizer as opt_mod

    params = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    host = opt_mod.tree_map(lambda t: t.to("cpu", copy=True), params)
    ocfg = opt_mod.OptimizerConfig(name=cfg.optimizer, **TRAIN_OPT)
    runs, secs = {}, {}
    for dev, p in (("cuda", params), ("cpu", host)):
        model = Model(cfg, device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        with route_log(torch) as routes:
            _, metrics, grads = steps.loss_and_grads(steps.make_loss_fn(model), p, b)
            grads = opt_mod.tree_map(lambda t: t.cpu(), grads)
            state = opt_mod.init_optimizer(cfg.optimizer, p)
            p, state, m = steps.make_train_step(model, ocfg)(p, state, b)
        secs[dev] = time.perf_counter() - t0
        runs[dev] = ({k: v.cpu() for k, v in metrics.items()},
                     {k: v.cpu() for k, v in m.items() if isinstance(v, torch.Tensor)},
                     routes, grads, p)
    (mg, sg, rg, gg, pg), (mc, sc, rc, gc, pc) = runs["cuda"], runs["cpu"]
    if len(rg) != len(rc) or not all(torch.equal(a, b) for a, b in zip(rg, rc)):
        raise AssertionError(f"{tag}: routes differ card vs CPU")
    worst = grads_close(tag, opt_mod.tree_leaves(gg), opt_mod.tree_leaves(gc))
    keys = [k for k in ("loss", "ce_loss", "recon_loss", "aux_loss") if k in mc]
    rel = {k: abs(mg[k].item() - mc[k].item()) / abs(mc[k].item()) for k in keys}
    rel["grad_norm"] = abs(sg["grad_norm"].item() - sc["grad_norm"].item()) / sc["grad_norm"].item()
    stats = all(torch.equal(sg[k], sc[k]) for k in ("expert_frac", "group_frac") if k in sc)
    log(f"  {tag}: loss {mg['loss'].item():.6f} vs CPU {mc['loss'].item():.6f}; relative gaps "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f"; {len(rc)} routes and the routing statistics equal {stats}; gradients: worst leaf "
        f"{worst:.2e} of its max ({len(opt_mod.tree_leaves(gc))} leaves); card "
        f"{secs['cuda']:.1f} s, CPU {secs['cpu']:.1f} s")
    if not (stats and max(rel.values()) <= 1e-5):
        raise AssertionError(f"{tag}: the card's step disagrees with the CPU's")
    params_after_steps_close(torch, tag, pg, pc, ocfg.lr)


def train2_trainer(torch, counters, tag, cfg):
    """(c) ``Trainer`` for ``TRAIN2_STEPS`` steps of the ``lm`` task in bf16
    (f32 masters) from seed 0, checkpoints only at the end, every step's
    metrics recorded: (the losses, the recon losses or None, the median
    step time at the synchronizing ``float(loss)``, peak memory, the
    run's launches, the trainer)."""
    import statistics
    import tempfile

    from repro_torch.launch import steps
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    data = train_batches(cfg, TRAIN2_STEPS, 0)
    seen = []
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, iter(data), trainer_cfg=TrainerConfig(
            total_steps=TRAIN2_STEPS, checkpoint_every=TRAIN2_STEPS, checkpoint_dir=tmp,
            keep_checkpoints=1, async_checkpoint=False, log_every=1),
            opt_cfg=OptimizerConfig(name=cfg.optimizer, **TRAIN_OPT), device="cuda",
            seed=0).initialize()
        inner = steps.make_train_step(tr.model, tr.opt_cfg)

        def recording(params, state, batch, *, accept=None):
            params, state, m = inner(params, state, batch, accept=accept)
            seen.append(float(m["recon_loss"]) if "recon_loss" in m else None)
            return params, state, m

        tr._step_fn = recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches = counted_run(counters, tr.run)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in out["log"]]
    med = statistics.median(m["step_time_s"] for m in out["log"][1:])
    log(f"  {tag}: {TRAIN2_STEPS} steps in {run_s:.1f} s (the final checkpoint included); "
        f"losses {' '.join(f'{x:.4f}' for x in losses)}")
    if len(losses) != TRAIN2_STEPS or not all(math.isfinite(x) for x in losses) or out["restores"]:
        raise AssertionError(f"{tag}: a loss was not finite, or a step was restored")
    return losses, seen, med, peak, launches, tr


def check_per_step(tag, launches, per_step):
    """Exactly ``per_step`` launches a step of each kernel named, and no
    other kernel (``only_path``)."""
    got = {k: launches[k] / TRAIN2_STEPS for k in per_step}
    log(f"  {tag}: launches a step {got}")
    if got != {k: float(n) for k, n in per_step.items()}:
        raise AssertionError(f"{tag}: launches a step {got}, want {per_step}")
    only_path(tag, launches, per_step)


def train2_bf16_runs(torch, counters):
    """(c) bf16 at full width and depth: ``Trainer`` on the codec model
    (its ``recon_loss`` at the last step below the first step's: the codec
    learns) and on mamba2-130m, then ``make_train_step`` on whisper-base
    with seeded frames [4, 1500, 512]; every loss finite, the launches a
    step exact (``TRAIN2_PER_STEP``), the median step time, tokens/s, peak
    memory and one profiled step of each.  Returns the three runs'
    launches summed."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.training import optimizer as opt_mod

    total = {c.__name__: 0 for c in counters}
    tokens = TRAIN_B * TRAIN_S

    def report(tag, med, peak, step, params, state, batch, name):
        dev_ms, wall_ms, top = profile_train_step(torch, step, params, state, batch, name)
        log(f"  {tag}: step time median {med * 1e3:.1f} ms, {tokens / med:.0f} tokens/s, peak "
            f"device memory {peak / 2**30:.2f} GiB; profiled step: device {dev_ms:.3f} ms in "
            f"{wall_ms:.1f} ms wall ({100 * dev_ms / wall_ms:.1f}% busy); top device ops: {top}")

    for tag, cfg in (("codec", dispatch_config()), ("mamba2", get_config(SSM))):
        losses, recon, med, peak, launches, tr = train2_trainer(torch, counters, tag, cfg)
        if tag == "codec":
            log(f"  codec: recon_loss a step {' '.join(f'{x:.4f}' for x in recon)}")
            if not recon[-1] < recon[0]:
                raise AssertionError("codec: recon_loss did not fall (the codec did not learn)")
        check_per_step(tag, launches, TRAIN2_PER_STEP[tag])
        batch = {k: torch.from_numpy(v).cuda() for k, v in train_batches(cfg, 1, 5)[0].items()}
        report(tag, med, peak, steps.make_train_step(tr.model, tr.opt_cfg), tr.params,
               tr.opt_state, batch, f"train2_{tag}_profile.txt")
        for k, n in launches.items():
            total[k] += n
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    cfg = get_config(ENCDEC)
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    state = opt_mod.init_optimizer(cfg.optimizer, params)
    step = steps.make_train_step(model, opt_mod.OptimizerConfig(name=cfg.optimizer, **TRAIN_OPT))
    batches = [{**{k: torch.from_numpy(v).cuda() for k, v in b.items()},
                "frame_embeds": train2_frames(torch, cfg, cfg.torch_dtype, i).cuda()}
               for i, b in enumerate(train_batches(cfg, TRAIN2_STEPS + 1, 0))]
    losses, times = [], []

    def run():
        nonlocal params, state
        for b in batches[:-1]:
            t = time.perf_counter()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, launches = counted_run(counters, run)
    peak = torch.cuda.max_memory_allocated()
    log(f"  whisper: losses {' '.join(f'{x:.4f}' for x in losses)}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("whisper: a loss was not finite")
    check_per_step("whisper", launches, TRAIN2_PER_STEP["whisper"])
    report("whisper (step time to the synchronized end of the step)",
           statistics.median(times[1:]), peak, step, params, state, batches[-1],
           "train2_whisper_profile.txt")
    for k, n in launches.items():
        total[k] += n
    return total


def train2_phase(torch, timer, counters):
    """Phase 16: training, second half (``--train2`` runs it alone): (a)
    the dispatch codec's autograd Function against autograd of its plain
    version at ``CODEC_FN_CASES``, (b) one f32 train step card vs CPU of
    the codec model, mamba2-130m, whisper-base and jamba's smoke hybrid,
    (c) bf16 at full width and depth.  Returns (c)'s launches over
    ``counters`` and the backward kernel's."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    counters = list(counters) + [flash_attention_bwd]
    t0 = time.perf_counter()
    log("(a) the dispatch codec's autograd Function against its plain version (card):")
    gen = torch.Generator(device="cuda").manual_seed(16)
    for case in CODEC_FN_CASES:
        codec_function_case(torch, timer, gen, *case)
    log(f"(a) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    log("(b) one f32 train step, card vs CPU, at full width and reduced depth:")
    small = (("codec model, 2 layers", dispatch_config().replace(num_layers=2, dtype="float32")),
             ("mamba2-130m, 2 layers", get_config(SSM).replace(num_layers=2, dtype="float32")),
             ("whisper-base, 2 + 2 layers", get_config(ENCDEC).replace(
                 num_layers=2, encoder_layers=2, dtype="float32")),
             ("jamba-1.5-large smoke, 8 layers", smoke_config(get_config(HYBRID)).replace(
                 dtype="float32")))
    for tag, cfg in small:
        batch = {k: torch.from_numpy(v) for k, v in train_batches(cfg, 1, 3)[0].items()}
        if cfg.encoder_decoder:
            batch["frame_embeds"] = train2_frames(torch, cfg, torch.float32, 3)
        train2_card_vs_cpu(torch, tag, cfg, batch)
        gc.collect()
    log(f"(b) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    log(f"(c) bf16 at full width and depth ({TRAIN2_STEPS} steps each; card "
        f"{nvidia_smi()}):")
    launches = train2_bf16_runs(torch, counters)
    log(f"(c) took {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 17: expert parallelism (the a2a and tp bodies on torch.distributed)
# ---------------------------------------------------------------------------


EP = "qwen3-moe-235b-a22b"
EP_LAYERS = 2  # full width, depth cut to 2 of 94 layers
EP_MESH = (1, 4)  # serve_tp: dp 1, ep 4 (32 of 128 experts a rank)
EP_SEED = 0  # non-expert params' generator; experts by (seed, layer, expert)
EP_LENS = (16, 77, 150, 200)  # (a): 4 requests
EP_BF16_LENS = (16, 40, 77, 100, 128, 150, 181, 200)  # (c): 8 requests through 4 slots
EP_NEW = 16
EP_LAYER_TOKENS = 64  # (b): 16 tokens a rank in a2a; tp takes the first 2 (a 2-slot decode)
EP_TIE = 1e-6  # (b): a token whose 8th and 9th gate probabilities are closer is left out
EP_REL = 1e-4  # (b): the bodies against the plain composition, of max |y| (f32)
EP_PATH = ("paged_attention", "group_gate", "grouped_mlp", "lowrank_encode", "lowrank_decode")
EP_TIMEOUT_S = 180  # the process group's and the ranks' deadline


def ep_configs():
    """(the f32 model of (a) without a codec and dropless at serving, the
    one MoE layer of (b) with the config's rank-1024 dispatch codec, the
    bf16 model of (c) with the codec and the config's eval capacity)."""
    import dataclasses

    from repro_torch.configs import get_config

    base = get_config(EP).replace(num_layers=EP_LAYERS)
    # eval_capacity_factor = ep: a bucket holds every assignment, so (a) is
    # dropless and must give a one-device sorted run's tokens
    dropless = dataclasses.replace(base.moe, eval_capacity_factor=float(EP_MESH[1]),
                                   capacity_factor=8.0)
    f32 = base.replace(dtype="float32", compression=None, moe=dropless)
    layer = base.replace(dtype="float32", moe=dropless)
    bf16 = base.replace(param_dtype="bfloat16")
    return f32, layer, bf16


def ep_requests(vocab, lens, new, base=0):
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(17)
    return [Request(base + i, rng.integers(0, vocab, size=n).astype(np.int32),
                    max_new_tokens=new) for i, n in enumerate(lens)]


def ep_serve(torch, model, params, slots, lens, new, step_s=None):
    """``ServingEngine`` (``slots`` slots, pages of 16, chunks of 32) over
    ``ep_requests``; ``step_s`` collects (all slots decoding before the
    step, synchronized seconds) a step.  Returns (tokens, engine)."""
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(model, params, max_batch=slots, max_len=256, page_size=16,
                        prefill_chunk=32)
    reqs = ep_requests(model.cfg.vocab_size, lens, new)
    for r in reqs:
        eng.submit(r)
    while eng.busy():
        full = all(s is not None for s in eng.slots)
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if step_s is not None:
            step_s.append((full, time.perf_counter() - t))
    eng.run()  # drained: on a mesh, the ranks' tokens are gathered and compared
    if eng.pool.pages_in_use or not all(len(r.generated) == new for r in reqs):
        raise AssertionError("ep serving: pages left mapped or a request short")
    return [list(r.generated) for r in reqs], eng


def ep_layer(torch, cfg, topo, device):
    """(b)'s MoE layer params (gate and codec from ``EP_SEED``'s generator,
    this rank's experts, or all of them without ``topo``) and its input."""
    from repro_torch.core.moe import init_expert_slices, init_moe

    gen = torch.Generator(device=device).manual_seed(EP_SEED + 1)
    p = init_moe(gen, cfg, draw_experts=False)
    p.update({k: v[0] for k, v in init_expert_slices(cfg, EP_SEED, [0], topo, device).items()})
    x = torch.randn(EP_LAYER_TOKENS, cfg.d_model, generator=gen, device=device)
    return p, x


def ep_plain_layer(torch, p, x, cfg, impl):
    """The plain composition of the bodies' semantics on one device, f32,
    dropless: the plain gate; for a2a decode(encode(FFN_e(decode(encode(x)))))
    times w, summed over each token's k experts; for tp each rank's partial
    sum over its experts, encoded, summed over the ranks and decoded.
    Returns (y, the tokens whose 8th and 9th gate probabilities are within
    ``EP_TIE``)."""
    from repro_torch.core.gating import select_topk
    from repro_torch.kernels.expert_mlp import grouped_mlp_plain
    from repro_torch.kernels.group_gate import group_gate_plain
    from repro_torch.kernels.lowrank import lowrank_project_plain

    m = cfg.moe
    E, k, ep = m.num_experts, m.top_k, EP_MESH[1]
    T, d = x.shape
    g = p["gate"]
    probs, _ = group_gate_plain(x, g["w_local"], g["b_local"], g["w_global"], g["b_global"], None)
    top = torch.sort(probs, dim=-1, descending=True).values
    ties = (top[:, k - 1] - top[:, k]) < EP_TIE
    idx, w = select_topk(probs, k)
    enc = functools.partial(lowrank_project_plain, w=p["codec"]["enc"])
    dec = functools.partial(lowrank_project_plain, w=p["codec"]["dec"])
    eid = idx.reshape(-1)
    rows = x.repeat_interleave(k, dim=0)
    if impl == "a2a":
        rows = dec(enc(rows))
    order = torch.argsort(eid, stable=True)
    gs = torch.bincount(eid, minlength=E).int()
    y_sorted = grouped_mlp_plain(rows[order], gs, p["wi"], p.get("wg"), p["wo"], cfg.act)
    y_rows = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    if impl == "a2a":
        y_rows = dec(enc(y_rows))
        return (y_rows * w.reshape(-1, 1)).reshape(T, k, d).sum(1), ties
    contrib = (y_rows * w.reshape(-1, 1)).reshape(T, k, d)
    owner = (idx // (E // ep))  # [T, k] the rank of each assignment's expert
    z = sum(enc((contrib * (owner == r)[..., None]).sum(1)) for r in range(ep))
    return dec(z), ties


def ep_rank(topo, device, plain, only_seqp=False):
    """One rank of phase 17 (every rank the same host code): (a) the f32
    model served with 4 slots (a2a) and 2 slots (tp), tokens against the
    one-process run's (``plain["tokens"]``); phase 19 (a) on the same
    weights (:func:`seqp_serve_rank`); (b) the MoE layer's a2a and tp
    bodies with the codec; (c) the bf16 model with the codec, 8 requests
    through 4 slots, its launches, step times, memory, collectives and a
    profiled decode step (rank 0).  ``only_seqp``: phase 19 (a) alone.
    Returns what the parent checks and logs."""
    import gc

    import torch

    from repro_torch.core import moe
    from repro_torch.distributed import collectives as coll
    from repro_torch.models.model import Model

    out = {"rank": topo.rank}
    f32, layer_cfg, bf16 = ep_configs()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(f32, device, topo)
    params = model.init(torch.Generator(device=device).manual_seed(EP_SEED),
                        expert_seed=EP_SEED)
    out["init_s"] = time.perf_counter() - t0
    out["seqp"] = seqp_serve_rank(torch, device, params, plain)
    if only_seqp:
        return out
    plain_tokens = plain["tokens"]
    for slots, body in ((4, "a2a"), (2, "tp")):
        before = (moe._moe_a2a_body.calls, moe._moe_tp_body.calls)
        t0 = time.perf_counter()
        tokens = ep_serve(torch, model, params, slots, EP_LENS, EP_NEW)[0]  # engine dropped
        out[f"a_{body}"] = dict(
            tokens=tokens, seconds=time.perf_counter() - t0,
            bodies=(moe._moe_a2a_body.calls - before[0], moe._moe_tp_body.calls - before[1]))
        if tokens != plain_tokens[slots]:
            raise AssertionError(f"ep (a) rank {topo.rank}, {slots} slots: tokens differ from "
                                 f"the one-process sorted run: {tokens} vs {plain_tokens[slots]}")
    out["a_peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, model
    gc.collect()
    torch.cuda.empty_cache()

    p, x = ep_layer(torch, layer_cfg, topo, device)
    for impl, T in (("a2a", EP_LAYER_TOKENS), ("tp", 2)):
        with torch.no_grad():
            y, aux = moe.apply_moe(p, x[:T], layer_cfg.replace(moe_impl=impl), topo, train=True)
        out[f"b_{impl}"] = (y.cpu().numpy(), float(aux["dropped_frac"]))
    del p, x
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = Model(bf16, device, topo)
    params = model.init(torch.Generator(device=device).manual_seed(EP_SEED),
                        expert_seed=EP_SEED)
    counters = wrappers()
    for c in counters:
        c.launches = 0
    before = (moe._moe_a2a_body.calls, moe._moe_tp_body.calls)
    step_s = []
    t0 = time.perf_counter()
    tokens, eng = ep_serve(torch, model, params, 4, EP_BF16_LENS, EP_NEW, step_s)
    out["c_seconds"] = time.perf_counter() - t0
    out["c_launches"] = {c.__name__: c.launches for c in counters}
    out["c_bodies"] = (moe._moe_a2a_body.calls - before[0], moe._moe_tp_body.calls - before[1])
    out["c_tokens"] = tokens
    out["c_steps"] = step_s
    # one decode step with every slot decoding: its collectives, profiled on rank 0
    for r in ep_requests(bf16.vocab_size, EP_LENS, EP_NEW, base=100):
        eng.submit(r)
    while not all(s is not None for s in eng.slots) or eng.waiting:
        eng.step()
    coll.reset_counts()
    if topo.rank == 0:
        names = (PAGED_KERNELS + GATE_KERNELS + ffn_kernels("expert FFN", "__nv_bfloat16")
                 + CODEC_KERNELS)
        dev_ms, wall_ms, path = profiled(torch, eng.step, "ep_decode_profile.txt", names)
        out["c_profile"] = (dev_ms, wall_ms, path)
    else:
        eng.step()
    out["c_collectives"] = coll.counts()
    eng.run()
    out["c_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["c_pages_left"] = eng.pool.pages_in_use
    return out


# phase 17's paged attention: 4 slots (and 2) of 16-page rings, decode and
# a 32-token prefill chunk, at qwen3-moe's 64 query heads on 4 kv heads of
# 128 (G = 16: the mma rows of one position at C = 1)
EP_PA_CASES = (
    ("qwen3-moe B=4 pps=16 C=1", 4, 16, 1, (37, 118, 199, 231)),
    ("qwen3-moe B=4 pps=16 C=32", 4, 16, 32, (37, 118, 199, 231)),
)
EP_HEADS = (64, 4, 128)


def ep_kernels(torch, timer):
    """The kernels of phase 17's path against their plain versions at its
    shapes: paged attention at 64/4 heads of 128 (``EP_PA_CASES``), bf16
    and f32; the group gate at d 4096 with 128 experts in 16 groups (top-8)
    at a rank's 1, 8 and 16 tokens; the expert FFN over 32 local experts
    (d 4096, f 1536, gated silu) at ``ep·C`` received rows (32: the decode's
    C of 8; 64: a 32-token chunk's C of 16), bf16 and f32, and in f32 at the
    rows of (a)'s dropless runs too (16: the tp decode; 256: a 32-token
    chunk's C of 64); the codec at 4096 -> 1024 at the payload's 8, 32 and
    64 rows."""
    from repro_torch.core.compression import init_lowrank_1d
    from repro_torch.core.gating import init_group_gate
    from repro_torch.kernels.expert_mlp import ffn_plan, grouped_mlp, grouped_mlp_plain
    from repro_torch.kernels.group_gate import group_gate, group_gate_plain

    _, cfg, _ = ep_configs()
    m = cfg.moe
    E, K, d, f = m.num_experts, m.num_groups, cfg.d_model, m.d_ff_expert
    E_loc = E // EP_MESH[1]
    for dt in (torch.bfloat16, torch.float32):
        run_paged_attention(torch, timer, cases=EP_PA_CASES, heads=EP_HEADS, dtype=dt)
    gen = torch.Generator(device="cuda").manual_seed(17)
    p = init_group_gate(gen, d, m)
    for T in (1, 8, 16):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(T, d, generator=gen, device="cuda").to(dt)
            args = (x, p["w_local"], p["b_local"], p["w_global"], p["b_global"], None)
            probs, pg = group_gate(*args)
            rprobs, rpg = group_gate_plain(*args)
            tag = f"qwen3-moe T={T} x {str(dt)[6:]}"
            check_close(f"group_gate probs {tag}", probs, rprobs, rtol=0, atol=1e-4)
            check_close(f"group_gate p_group {tag}", pg, rpg, rtol=0, atol=1e-4)
            nbytes = T * d * x.element_size() + d * (E + K) * 4 + (E + K) * 4 + T * (E + K) * 4
            b_ms, b_by = bound(nbytes, 2 * T * d * (E + K), "f32")
            call = functools.partial(group_gate, *args)
            ms, plain_ms = timer(call), timer(lambda: group_gate_plain(*args))
            log(f"  group_gate {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
                f"{b_ms:.6f} ({b_by}) library_ms=null")
    for dt in (torch.bfloat16, torch.float32):
        wi, wg, wo = (torch.randn(E_loc, a, b, generator=gen, device="cuda").div(a ** 0.5).to(dt)
                      for a, b in ((d, f), (d, f), (f, d)))
        for n in (32, 64) if dt == torch.bfloat16 else (16, 32, 64, 256):
            cut = torch.sort(torch.randint(0, n + 1, (E_loc - 1,), generator=gen,
                                           device="cuda")).values
            sizes = torch.diff(torch.cat([cut.new_zeros(1), cut, cut.new_full((1,), n)]))
            gs = sizes.int()
            xs = torch.randn(n, d, generator=gen, device="cuda").to(dt)
            args = (xs, gs, wi, wg, wo, "silu")
            y, ref = grouped_mlp(*args), grouped_mlp_plain(*args)
            rel = 2e-2 if dt == torch.bfloat16 else 1e-5
            tag = f"qwen3-moe ep n={n} {str(dt)[6:]}"
            check_close(f"expert_mlp {tag}", y, ref, rtol=0,
                        atol=rel * ref.float().abs().max().item())
            routed = int((sizes > 0).sum())
            es = xs.element_size()
            nbytes = 2 * n * d * es + routed * 3 * d * f * es + E_loc * 4
            b_ms, b_by = bound(nbytes, 3 * 2 * n * d * f,
                               "bf16" if dt == torch.bfloat16 else "f32")
            call = functools.partial(grouped_mlp, *args)
            ms, plain_ms = timer(call), timer(lambda: grouped_mlp_plain(*args))
            log(f"  expert_mlp {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
                f"{b_ms:.6f} ({b_by}) library_ms=null path={ffn_plan(n, d, f, dt)}")
        del wi, wg, wo
    codec = init_lowrank_1d(torch.Generator().manual_seed(7), d, cfg.compression.rank,
                            device="cuda")
    codec_cases(torch, timer, gen, codec, (8, 32, 64))


def ep_phase(torch, timer, counters=None, only_seqp=False):
    """Phase 17: qwen3-moe-235b-a22b at full width (``EP_LAYERS`` layers)
    over ``EP_MESH`` ranks sharing the card (gloo over CUDA tensors), every
    rank spawned by ``launch.mesh.spawn_ranks``; the one-process runs first
    (the card holds them or the ranks, never both).  Phase 19 (a) runs in
    the same ranks (``only_seqp``: it alone).  Returns each wrapper's
    launches in (c), rank 0's."""
    import gc

    import numpy as np

    from repro_torch.core.moe import _capacity
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    if not only_seqp:
        ep_kernels(torch, timer)
    f32, layer_cfg, bf16 = ep_configs()
    # (a)'s reference: one process, moe_impl "sorted", the same weights;
    # phase 19 (a)'s: the same model's prefill of SEQP_PROMPT
    t0 = time.perf_counter()
    model = Model(f32, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(EP_SEED), expert_seed=EP_SEED)
    plain_tokens = {slots: ep_serve(torch, model, params, slots, EP_LENS, EP_NEW)[0]
                    for slots in ((2,) if only_seqp else (4, 2))}
    prompt = np.random.default_rng(19).integers(0, f32.vocab_size, SEQP_PROMPT).astype(np.int32)
    with torch.no_grad():
        logits = model.prefill(params, {"tokens": torch.from_numpy(prompt).cuda()})[0]
    one = dict(tokens=plain_tokens, prompt=prompt, logits=logits.cpu().numpy())
    one_peak = torch.cuda.max_memory_allocated()
    del model, params, logits
    log(f"ep (a) one-process sorted runs (f32, {list(plain_tokens)} slots) and phase 19 (a)'s "
        f"prefill: {time.perf_counter() - t0:.1f} s")
    if only_seqp:
        gc.collect()
        torch.cuda.empty_cache()
        ranks = spawn_ranks(EP_MESH, ep_rank, one, True, device="cuda", policy="serve_tp",
                            timeout_s=EP_TIMEOUT_S)
        seqp_serve_checks(ranks, one)
        log(f"ep phase (phase 19 (a) alone) took {time.perf_counter() - t_phase:.1f} s")
        return {}
    # (b)'s plain composition, one process, all 128 experts
    p, x = ep_layer(torch, layer_cfg, None, "cuda")
    plain = {impl: ep_plain_layer(torch, p, x[:T], layer_cfg, impl)
             for impl, T in (("a2a", EP_LAYER_TOKENS), ("tp", 2))}
    plain = {k: (y.cpu().numpy(), ties.cpu().numpy()) for k, (y, ties) in plain.items()}
    del p, x
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    world = EP_MESH[0] * EP_MESH[1]
    backend = backend_for(world, "cuda")[0]
    log(f"ep ranks: mesh {EP_MESH} (serve_tp), {backend} over CUDA tensors, "
        f"{torch.cuda.device_count()} card(s); parent holds "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    # a rank that fails stops them all at once; one that hangs, within
    # EP_TIMEOUT_S (the ranks take ~45 s)
    ranks = spawn_ranks(EP_MESH, ep_rank, one, device="cuda", policy="serve_tp",
                        timeout_s=EP_TIMEOUT_S)
    log(f"ep ranks took {time.perf_counter() - t0:.1f} s (spawn, init, (a)-(c), phase 19 (a))")
    seqp_serve_checks(ranks, one)
    r0 = ranks[0]
    for body in ("a2a", "tp"):
        a = r0[f"a_{body}"]
        want = (a["bodies"][0] > 0, a["bodies"][1] > 0)
        if want != ((True, body == "tp")):
            raise AssertionError(f"ep (a) {body}: body calls {a['bodies']}")
        log(f"ep (a) f32 {4 if body == 'a2a' else 2} slots ({body} decode): tokens of every "
            f"rank equal the one-process sorted run's ({len(EP_LENS)} x {EP_NEW}); "
            f"a2a/tp body calls {a['bodies']}; {a['seconds']:.1f} s")
    log(f"ep (a) peak memory a rank (f32, 2 layers, 32 experts a layer): "
        + ", ".join(f"{r['a_peak_bytes'] / 2**30:.2f}" for r in ranks)
        + f" GiB (sum {sum(r['a_peak_bytes'] for r in ranks) / 2**30:.2f}); one process "
        f"{one_peak / 2**30:.2f} GiB; init {r0['init_s']:.1f} s")
    for impl in ("a2a", "tp"):
        ys = [r[f"b_{impl}"][0] for r in ranks]
        if any(not (y == ys[0]).all() for y in ys):
            raise AssertionError(f"ep (b) {impl}: the ranks' outputs differ")
        dropped = [r[f"b_{impl}"][1] for r in ranks]
        want, ties = plain[impl]
        keep = ~ties
        err = float(abs(ys[0] - want)[keep].max())
        scale = float(abs(want).max())
        log(f"ep (b) {impl} body (rank-{layer_cfg.compression.rank} codec, f32, {want.shape[0]} "
            f"tokens): max |y - "
            f"plain| {err:.3e} of max |y| {scale:.3e} (limit {EP_REL:g} of it), "
            f"{int(ties.sum())} near-tied tokens left out; dropped_frac {dropped}")
        if err > EP_REL * scale or any(dropped):
            raise AssertionError(f"ep (b) {impl}: the body disagrees with the plain "
                                 "composition, or dropped")
        if ties.sum() > 2:
            raise AssertionError(f"ep (b) {impl}: {int(ties.sum())} near ties")
    toks = [r["c_tokens"] for r in ranks]
    if any(t != toks[0] for t in toks) or any(r["c_pages_left"] for r in ranks):
        raise AssertionError("ep (c): the ranks' tokens differ or a pool did not drain")
    launches = r0["c_launches"]
    for r in ranks:
        only_path(f"ep (c) rank {r['rank']}", r["c_launches"], EP_PATH)
    decode = sorted(s for full, s in r0["c_steps"] if full)
    cfg = bf16
    m = cfg.moe
    C = _capacity(m.top_k, EP_MESH[1], m.eval_capacity_factor)  # a decode: 1 token a rank
    r, d = cfg.compression.rank, cfg.d_model
    coll_c = r0["c_collectives"]
    payload = 2 * cfg.num_layers * EP_MESH[1] * C * r * 2  # there and back, bf16
    meta = cfg.num_layers * EP_MESH[1] * C * 4
    log(f"ep (c) bf16, codec rank {r}, 8 requests x {EP_NEW} through 4 slots: "
        f"{r0['c_seconds']:.1f} s; decode step median {decode[len(decode) // 2] * 1e3:.3f} ms "
        f"over {len(decode)} steps (rank 0, host clock, synchronized; first step "
        f"{r0['c_steps'][0][1] * 1e3:.1f} ms); a2a/tp body calls {r0['c_bodies']}; launches "
        f"{launches}")
    log(f"ep (c) peak memory a rank: "
        + ", ".join(f"{x['c_peak_bytes'] / 2**30:.2f}" for x in ranks)
        + f" GiB (sum {sum(x['c_peak_bytes'] for x in ranks) / 2**30:.2f})")
    log(f"ep (c) collectives a decode step (rank 0, calls / bytes handed in): {coll_c}; "
        f"the a2a payload {payload} B at rank {r} against {payload * d // r} B "
        f"uncompressed (ratio {r / d:.3f}, shape-only) plus {meta} B of expert ids")
    if coll_c["all_to_all"]["bytes"] != payload + meta:
        raise AssertionError(f"ep (c): all_to_all bytes {coll_c['all_to_all']} vs "
                             f"{payload} + {meta}")
    dev_ms, wall_ms, path = r0["c_profile"]
    log(f"ep (c) decode profile (rank 0, 4 slots decoding, the other ranks stepping beside "
        f"it): device time {dev_ms:.3f} ms of {wall_ms:.3f} ms wall ({dev_ms / wall_ms:.1%} "
        f"busy); kernels in path {path}; written to chiprun_out/ep_decode_profile.txt")
    if r0["c_bodies"][0] == 0:
        raise AssertionError("ep (c): the a2a body never ran")
    log(f"ep phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 18: training on a mesh (full-width switch-base over 4 ranks)
# ---------------------------------------------------------------------------

TM_MESH = (2, 2)  # elastic_topology(4, model_axis_size=2): ZeRO-3 over 2, experts over 2
TM_RESUME = 2  # (b): elastic_topology(2, model_axis_size=2), a (1, 2) mesh
TM_STEPS_A, TM_STEPS_C, TM_STEPS_D = 2, 3, 2
TM_TIMEOUT_S = 420  # the process group's and each spawn's deadline
# launches a step of full-depth switch-base on a rank (12 layers, 6 MoE,
# each block recomputed once in the backward): the one-device step's; with
# the dispatch codec the a2a body encodes and decodes the payload there and
# back (2 + 2 a MoE layer's forward, recomputed once)
TM_PER_STEP = dict(TRAIN_PER_STEP)
TM_CODEC_PER_STEP = {**TRAIN_PER_STEP, "lowrank_encode": 24, "lowrank_decode": 24}


def tm_configs():
    """(f32 for (a)-(b), bf16 for (c), bf16 with the dispatch codec for
    (d)): full-width, full-depth switch-base, AdamW, the a2a body on the
    mesh.  (a)-(b) set the capacity factor to 8 (nothing drops) and the
    load-balance weight to 0: on a mesh that term is the mean over the
    ranks of each one's product of two token means (the reference's
    ``pmean`` of the gate's aux), which no one-process run computes, while
    every other term is a mean the shards add up to.  (c)-(d) keep the
    config's (capacity 1.25, the router's weights)."""
    import dataclasses

    from repro_torch.configs import CompressionConfig, get_config

    base = get_config(TRAIN)
    f32 = base.replace(dtype="float32", moe=dataclasses.replace(
        base.moe, capacity_factor=8.0, router_aux_weight=0.0))
    codec = base.replace(compression=CompressionConfig(**DISPATCH_CODEC))
    return f32, base, codec


def tm_trainer(cfg, topo, device, ckpt, total, skip=0):
    """A ``Trainer`` of ``cfg`` (seed 0, ``TRAIN_OPT``) on ``topo`` (None:
    one process) over ``train_batches``' first batches (the first ``skip``
    left out), checkpoints only at the end, into ``ckpt``."""
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    data = train_batches(cfg, total, 0)[skip:]
    if ckpt is None:  # a state only: an empty directory of its own
        import tempfile

        ckpt = tempfile.mkdtemp(prefix="tm_state_")
    return Trainer(cfg, iter(data), topo=topo, device=device, seed=0,
                   opt_cfg=OptimizerConfig(name=cfg.optimizer, **TRAIN_OPT),
                   trainer_cfg=TrainerConfig(total_steps=total, checkpoint_every=10**6,
                                             checkpoint_dir=ckpt, keep_checkpoints=2,
                                             async_checkpoint=False, log_every=1)).initialize()


def tm_bf16_run(torch, cfg, topo, device, n, counters, profile_name=None):
    """(c) / (d) on one rank: the state of a ``Trainer`` (its blocks), then
    ``n`` bf16 steps of its step function, each timed on the host clock to
    the synchronizing ``float(loss)`` (no checkpoint: the run measures the
    step), then one more with the collectives' counters zeroed (rank 0
    under the profiler when ``profile_name`` is given).  Returns what the
    parent logs."""
    import shutil
    import statistics

    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import steps

    torch.cuda.reset_peak_memory_stats()
    tr = tm_trainer(cfg, topo, device, None, n)
    step_fn = steps.make_train_step(tr.model, tr.opt_cfg, tr.specs[0])
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in train_batches(cfg, n + 1, 0)]
    losses, times, seen = [], [], {}

    def run():
        for b in batches[:n]:
            t = time.perf_counter()
            tr.params, tr.opt_state, m = step_fn(tr.params, tr.opt_state, b)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t)

    _, launches = counted_run(counters, run)

    def step():
        _, _, m = step_fn(tr.params, tr.opt_state, batches[n])
        seen.update(loss=float(m["loss"]), dropped=float(m.get("dropped_frac", 0.0)))

    coll.reset_counts()
    prof = None
    if profile_name is not None and topo.rank == 0:
        prof = profiled(torch, step, profile_name, GATE_KERNELS + ffn_kernels(
            "expert FFN", "__nv_bfloat16") + CODEC_KERNELS)
    else:
        step()
    counts = coll.counts()
    res = dict(losses=losses, step_s=statistics.median(times[1:]),
               launches={k: v / n for k, v in launches.items()}, counts=counts, profile=prof,
               peak=torch.cuda.max_memory_allocated(), extra=seen)
    shutil.rmtree(tr.tc.checkpoint_dir, ignore_errors=True)
    del tr, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tm_rank(topo, device, ckpt, seqp_paths, only_seqp=False):
    """One rank of phase 18's (2, 2) mesh (every rank the same host code):
    phase 19 (b) and (c) (:func:`seqp_train_rank`, :func:`ssm_tp_rank`);
    (a) f32 ``Trainer`` for ``TM_STEPS_A`` steps, checkpointed (whole
    arrays) into ``ckpt``; (c) bf16, (d) bf16 with the dispatch codec.
    ``only_seqp``: phase 19's parts alone."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bwd

    f32, bf16, codec = tm_configs()
    counters = wrappers() + [flash_attention_bwd]
    out = {"rank": topo.rank}
    out["seqp"] = seqp_train_rank(torch, device, seqp_paths["one"], counters)
    out["ssm"] = ssm_tp_rank(torch, topo, device, seqp_paths["mamba"], counters)
    if only_seqp:
        return out
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = tm_trainer(f32, topo, device, ckpt, TM_STEPS_A)
    log_a = tr.run()["log"]
    out.update({"a_log": log_a, "a_seconds": time.perf_counter() - t0,
                "a_peak": torch.cuda.max_memory_allocated()})
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["c"] = tm_bf16_run(torch, bf16, topo, device, TM_STEPS_C, counters,
                           "train_mesh_step_profile.txt")
    out["c"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["d"] = tm_bf16_run(torch, codec, topo, device, TM_STEPS_D, counters)
    out["d"]["seconds"] = time.perf_counter() - t0
    return out


def tm_resume_rank(topo, device, ckpt):
    """(b) On ``elastic_topology(TM_RESUME, model_axis_size=2)``: the f32
    ``Trainer`` resumes ``ckpt``'s step ``TM_STEPS_A`` and takes one more
    step.  Returns (the mesh, the step it resumed at, the log)."""
    from repro_torch.distributed.fault import elastic_topology

    f32, _, _ = tm_configs()
    t = elastic_topology(TM_RESUME, model_axis_size=2)
    tr = tm_trainer(f32, t, device, ckpt, TM_STEPS_A + 1, skip=TM_STEPS_A)
    resumed = tr.step
    return t.mesh_shape, resumed, tr.run()["log"]


def tm_kernels(torch, timer):
    """The kernels of phase 18's path against their plain versions at its
    shapes on a rank of (2, 2): flash attention forward and backward on the
    rank's batch shard [2, 256, 12, 64], bf16 and f32; the gate on the a2a
    body's token chunk (T = 256: 512 tokens a data rank over ep 2) at d 768,
    8 experts in 4 groups; the expert FFN over the rank's 4 experts at
    ``ep·C`` rows (320 at capacity 1.25, bf16; 2048 at capacity 8, f32); the
    codec at 768 -> 384 on the payload's 256 and the received 320 rows."""
    from repro_torch.core.compression import init_lowrank_1d
    from repro_torch.core.gating import init_group_gate
    from repro_torch.kernels.expert_mlp import ffn_plan, grouped_mlp, grouped_mlp_plain
    from repro_torch.kernels.group_gate import group_gate, group_gate_plain

    _, cfg, _ = tm_configs()
    m = cfg.moe
    E, K, d, f = m.num_experts, m.num_groups, cfg.d_model, m.d_ff_expert
    E_loc = E // TM_MESH[1]
    gen = torch.Generator(device="cuda").manual_seed(18)
    for bf16 in (True, False):
        bwd_case(torch, timer, gen, f"switch-base rank [2,256,12,64] causal "
                 f"{'bf16' if bf16 else 'f32'}", 2, 256, 256, 12, 12, 64, True, None, bf16)
    timer.read_later()
    p = init_group_gate(gen, d, m)
    T = TRAIN_B * TRAIN_S // (TM_MESH[0] * TM_MESH[1])
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(T, d, generator=gen, device="cuda").to(dt)
        args = (x, p["w_local"], p["b_local"], p["w_global"], p["b_global"], None)
        probs, pg = group_gate(*args)
        rprobs, rpg = group_gate_plain(*args)
        tag = f"switch-base T={T} x {str(dt)[6:]}"
        check_close(f"group_gate probs {tag}", probs, rprobs, rtol=0, atol=1e-4)
        check_close(f"group_gate p_group {tag}", pg, rpg, rtol=0, atol=1e-4)
        nbytes = T * d * x.element_size() + d * (E + K) * 4 + (E + K) * 4 + T * (E + K) * 4
        b_ms, b_by = bound(nbytes, 2 * T * d * (E + K), "f32")
        ms, plain_ms = timer(functools.partial(group_gate, *args)), timer(
            lambda: group_gate_plain(*args))
        log(f"  group_gate {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.6f} "
            f"({b_by}) library_ms=null")
    for dt, n in ((torch.bfloat16, 320), (torch.float32, 2048)):
        wi, wo = (torch.randn(E_loc, a, b, generator=gen, device="cuda").div(a ** 0.5).to(dt)
                  for a, b in ((d, f), (f, d)))
        cut = torch.sort(torch.randint(0, n + 1, (E_loc - 1,), generator=gen,
                                       device="cuda")).values
        sizes = torch.diff(torch.cat([cut.new_zeros(1), cut, cut.new_full((1,), n)]))
        xs = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        args = (xs, sizes.int(), wi, None, wo, cfg.act)
        y, ref = grouped_mlp(*args), grouped_mlp_plain(*args)
        rel = 2e-2 if dt == torch.bfloat16 else 1e-5
        tag = f"switch-base rank n={n} over {E_loc} experts {str(dt)[6:]}"
        check_close(f"expert_mlp {tag}", y, ref, rtol=0, atol=rel * ref.float().abs().max().item())
        es = xs.element_size()
        routed = int((sizes > 0).sum())
        b_ms, b_by = bound(2 * n * d * es + routed * 2 * d * f * es + E_loc * 4, 2 * 2 * n * d * f,
                           "bf16" if dt == torch.bfloat16 else "f32")
        ms, plain_ms = timer(functools.partial(grouped_mlp, *args)), timer(
            lambda: grouped_mlp_plain(*args))
        log(f"  expert_mlp {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.6f} "
            f"({b_by}) library_ms=null path={ffn_plan(n, d, f, dt)}")
        del wi, wo
    codec = init_lowrank_1d(torch.Generator().manual_seed(7), d, DISPATCH_CODEC["rank"],
                            device="cuda")
    codec_cases(torch, timer, gen, codec, (256, 320))


def tm_a2a_bytes(cfg, counts):
    """(payload bytes, expert-id bytes) of the all_to_all calls of one step
    on a rank of ``TM_MESH``: the ids go once a MoE layer's forward (and
    its recomputation), int32 [ep, C]; the rest is payload."""
    from repro_torch.core.moe import _capacity

    m = cfg.moe
    ep = TM_MESH[1]
    ts = TRAIN_B * TRAIN_S // (TM_MESH[0] * ep)
    C = _capacity(ts * m.top_k, ep, m.capacity_factor)
    moe_layers = sum(1 for s in cfg.layer_pattern if s.moe) * cfg.block_repeat
    ids = 2 * moe_layers * ep * C * 4
    total = counts["all_to_all"]["bytes"] + counts["all_to_all"]["bwd_bytes"]
    return total - ids, ids


def train_mesh_phase(torch, timer, counters=None, only_seqp=False):
    """Phase 18: full-width, full-depth switch-base trained on a (2, 2) mesh
    of 4 ranks sharing the card (gloo over CUDA tensors, the a2a body),
    each rank spawned by ``launch.mesh.spawn_ranks``; the one-process runs
    never beside the ranks.  Phase 19 (b) and (c) run in the same ranks
    (``only_seqp``: they alone).  Returns rank 0's launches in (c) and
    (d), and in phase 19 (b)'s bf16 run."""
    import shutil
    import tempfile

    from repro_torch.distributed.fault import elastic_shape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import backend_for, spawn_ranks

    t_phase = time.perf_counter()
    if not only_seqp:
        tm_kernels(torch, timer)
    f32, bf16, codec = tm_configs()
    tmp = tempfile.mkdtemp(prefix="train_mesh_")
    seqp_paths = {"one": os.path.join(tmp, "one.npz"), "mamba": os.path.join(tmp, "mamba.npz")}
    try:
        # (a)'s reference: one process, the sorted body, 3 steps uninterrupted
        # (phase 19 (b) reads its first 2); its params after step 2 copied to
        # the host on the way
        t0 = time.perf_counter()
        one = tm_trainer(f32, None, "cuda", os.path.join(tmp, "one"), TM_STEPS_A + 1)
        inner, taken = steps.make_train_step(one.model, one.opt_cfg), {}

        def snapshot(params, state, batch, *, accept=None):
            params, state, m = inner(params, state, batch, accept=accept)
            if int(state["step"]) == TM_STEPS_A:
                taken.update(_tm_flat(params))
            return params, state, m

        one._step_fn = snapshot
        one_log = one.run()["log"]
        one_params = dict(taken)
        del one, inner, taken
        shutil.rmtree(os.path.join(tmp, "one"))
        gc.collect()
        torch.cuda.empty_cache()
        log(f"train mesh (a) one process (f32, sorted, {TM_STEPS_A + 1} steps): "
            f"{time.perf_counter() - t0:.1f} s; losses "
            + " ".join(f"{m['loss']:.6f}" for m in one_log))

        t0 = time.perf_counter()
        import numpy as np

        np.savez(seqp_paths["one"], **{k: v.numpy() for k, v in one_params.items()})
        mamba_loss = seqp_mamba_reference(torch, seqp_paths["mamba"])
        log(f"phase 19 (c) one process (mamba2-130m f32 loss and gradients): "
            f"{time.perf_counter() - t0:.1f} s; loss {mamba_loss:.6f}")
        world = TM_MESH[0] * TM_MESH[1]
        log(f"train mesh ranks: mesh {TM_MESH} (tp: ZeRO-3 over data, experts over model), "
            f"{backend_for(world, 'cuda')[0]} over CUDA tensors, {torch.cuda.device_count()} "
            f"card(s)")
        ckpt = os.path.join(tmp, "mesh")
        t0 = time.perf_counter()
        ranks = spawn_ranks(TM_MESH, tm_rank, ckpt, seqp_paths, only_seqp, device="cuda",
                            policy="tp", timeout_s=TM_TIMEOUT_S)
        log(f"train mesh ranks took {time.perf_counter() - t0:.1f} s (spawn, phase 19 (b) and "
            f"(c){'' if only_seqp else ', (a), (c), (d)'})")
        seqp_launches = seqp_train_checks(ranks, one_log, mamba_loss)
        if only_seqp:
            return {"seqp": seqp_launches}
        r0 = ranks[0]
        for i, m in enumerate(r0["a_log"]):
            want = one_log[i]
            rl = abs(m["loss"] - want["loss"]) / abs(want["loss"])
            rg = abs(m["grad_norm"] - want["grad_norm"]) / abs(want["grad_norm"])
            log(f"train mesh (a) step {i + 1}: loss {m['loss']:.6f} vs one process "
                f"{want['loss']:.6f} (rel {rl:.2e}), grad norm {m['grad_norm']:.5f} vs "
                f"{want['grad_norm']:.5f} (rel {rg:.2e})")
            if not (rl <= 1e-5 and rg <= 1e-4) or any(
                    r["a_log"][i]["loss"] != m["loss"] for r in ranks):
                raise AssertionError(f"train mesh (a) step {i + 1}: the mesh disagrees with "
                                     "the one-process run, or the ranks differ")
        import numpy as np

        with np.load(os.path.join(ckpt, f"step_{TM_STEPS_A:08d}", "arrays.npz")) as z:
            got = {k: torch.from_numpy(z[f"0/{k}"]) for k in one_params}
        params_after_steps_close(torch, "train mesh (a)", got, one_params,
                                 TRAIN_OPT["lr"] * TM_STEPS_A)
        log(f"train mesh (a): the (2, 2) checkpoint's params after step {TM_STEPS_A} equal the "
            f"one process's ({len(one_params)} leaves); peak a rank "
            + ", ".join(f"{r['a_peak'] / 2**30:.2f}" for r in ranks) + " GiB; "
            f"{r0['a_seconds']:.1f} s on rank 0")
        del got, one_params
        gc.collect()

        # (b): resumed in one process, then on (1, 2)
        t0 = time.perf_counter()
        res = tm_trainer(f32, None, "cuda", ckpt, TM_STEPS_A + 1, skip=TM_STEPS_A)
        resumed_one = res.step
        one_b = res.run()["log"]
        del res
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(ckpt, f"step_{TM_STEPS_A + 1:08d}"), ignore_errors=True)
        log(f"train mesh (b) one-process resume: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        el = spawn_ranks(elastic_shape(TM_RESUME, 2), tm_resume_rank, ckpt, device="cuda",
                         policy="tp", timeout_s=TM_TIMEOUT_S)
        log(f"train mesh (b) elastic resume ranks took {time.perf_counter() - t0:.1f} s")
        want = one_log[TM_STEPS_A]["loss"]
        for tag, resumed, log_b in (("one process", resumed_one, one_b),
                                    *((f"{mesh} rank {i}", r, lg)
                                      for i, (mesh, r, lg) in enumerate(el))):
            got = log_b[-1]["loss"]
            rl = abs(got - want) / abs(want)
            log(f"train mesh (b) resumed at step {resumed} ({tag}): step {TM_STEPS_A + 1} loss "
                f"{got:.6f} vs the uninterrupted run's {want:.6f} (rel {rl:.2e})")
            if resumed != TM_STEPS_A or rl > 1e-5:
                raise AssertionError(f"train mesh (b) {tag}: the resumed step disagrees")
        if any(mesh != (1, 2) for mesh, _, _ in el):
            raise AssertionError(f"train mesh (b): elastic meshes {[e[0] for e in el]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    tokens = TRAIN_B * TRAIN_S
    for tag, key, cfg, per_step in (("(c) bf16", "c", bf16, TM_PER_STEP),
                                    ("(d) bf16 + codec rank 384", "d", codec, TM_CODEC_PER_STEP)):
        rc = r0[key]
        log(f"train mesh {tag}: losses " + " ".join(f"{x:.4f}" for x in rc["losses"])
            + f"; step median {rc['step_s'] * 1e3:.1f} ms (rank 0, host clock after float(loss)),"
            f" {tokens / rc['step_s']:.0f} tokens/s; {rc['seconds']:.1f} s; dropped_frac "
            f"{rc['extra']['dropped']:.4f}")
        log(f"train mesh {tag}: peak memory a rank "
            + ", ".join(f"{r[key]['peak'] / 2**30:.2f}" for r in ranks)
            + f" GiB (sum {sum(r[key]['peak'] for r in ranks) / 2**30:.2f})")
        log(f"train mesh {tag}: collectives a step (rank 0; calls / bytes handed in, forward "
            f"with the recomputation, and backward): {rc['counts']}")
        got = {k: rc["launches"][k] for k in per_step}
        log(f"train mesh {tag}: launches a step (rank 0) {got}")
        if got != {k: float(v) for k, v in per_step.items()}:
            raise AssertionError(f"train mesh {tag}: launches a step {got}, want {per_step}")
        only_path(f"train mesh {tag}", {k: v for k, v in rc["launches"].items()}, per_step)
        if not all(math.isfinite(x) for r in ranks for x in r[key]["losses"]):
            raise AssertionError(f"train mesh {tag}: a loss is not finite")
        if rc["profile"] is not None:
            dev_ms, wall_ms, path = rc["profile"]
            log(f"train mesh {tag}: profiled step (rank 0, the other ranks stepping beside it): "
                f"device {dev_ms:.3f} ms of {wall_ms:.1f} ms wall ({dev_ms / wall_ms:.1%} busy);"
                f" kernels in path {path}; chiprun_out/train_mesh_step_profile.txt")
    pay_c, ids_c = tm_a2a_bytes(bf16, r0["c"]["counts"])
    pay_d, ids_d = tm_a2a_bytes(codec, r0["d"]["counts"])
    ratio = DISPATCH_CODEC["rank"] / bf16.d_model
    log(f"train mesh (d): all_to_all payload a step {pay_d} B against (c)'s {pay_c} B "
        f"(ratio {pay_d / pay_c:.4f}, want {ratio:.4f}); expert ids {ids_d} B and {ids_c} B; "
        "recon_loss: none on the mesh, as in the reference's a2a and tp bodies (the eq. 8 "
        "term is moe_sorted's)")
    if pay_d * bf16.d_model != pay_c * DISPATCH_CODEC["rank"] or ids_d != ids_c:
        raise AssertionError("train mesh (d): the codec's payload is not rank / d of (c)'s")
    log(f"train mesh phase took {time.perf_counter() - t_phase:.1f} s")
    return {k: round(r0["c"]["launches"].get(k, 0) * TM_STEPS_C
                     + r0["d"]["launches"].get(k, 0) * TM_STEPS_D)
            for k in r0["c"]["launches"]} | {"seqp": seqp_launches}


def _tm_flat(tree, prefix=""):
    """{'/'-joined path: a host copy of the leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tm_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().to("cpu", copy=True)
    return out


# ---------------------------------------------------------------------------
# Phase 19: sequence parallelism and the head-sharded SSM, inside the ranks
# of phases 17 and 18 (no rank start-up or weight load paid twice)
# ---------------------------------------------------------------------------

SEQP_SECONDS = {}  # phase 19's parts: seconds each, summed into its log line
SEQP_PROMPT = (2, 128)  # (a): Model.prefill at S % 4 == 0: 32 queries a rank over 128 keys
SEQP_REL = 1e-4  # (a): the prefill's logits against one process's, of max |logit| (f32)
SEQP_STEPS = 2  # (b): bf16 steps under seqp on (2, 2)
SEQP_SSM = "mamba2-130m"  # (c): full width and depth, 24 heads, 12 a rank under tp on (2, 2)
SEQP_SSM_SEED = 0
SEQP_SSM_HEAD_BLOCK = 4
SEQP_SSM_STEPS = 2  # (c): bf16 steps
SEQP_GRAD_REL = 1e-4  # (c): each gradient leaf against one process's, of its max |value|
# the flash kernels at a rank's shapes under seqp: (name, B, S, ep, H, KV, hd)
# -- phase 19 (b)'s switch-base train tile (2 rows a data rank, 256 / ep 2
# queries a rank) and (a)'s qwen3-moe prefill (128 / ep 4 queries a rank)
SEQP_FLASH_CASES = (
    ("switch-base seqp (2,2)", 2, 256, 2, 12, 12, 64),
    ("qwen3-moe serve_seqp (1,4)", 2, 128, 4, 64, 4, 128),
)


def seqp_serve_rank(torch, device, params, plain):
    """Phase 19 (a) on one rank of phase 17's (1, 4) mesh, on (a)'s f32
    weights (dropless at serving) under a ``serve_seqp`` topology:
    ``ServingEngine`` with 2 slots (the prompts' chunks through the a2a
    body on pre-sharded tokens, the 2-token decode through tp), tokens
    against the one-process sorted run's; ``Model.prefill`` of
    ``SEQP_PROMPT``: each layer's flash launch at this rank's offset, the
    logits against the one-process prefill's."""
    import numpy as np

    from repro_torch.core import moe
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.mesh import make_topology
    from repro_torch.models import attention
    from repro_torch.models.model import Model

    f32 = ep_configs()[0]
    model = Model(f32, device, make_topology(EP_MESH, policy="serve_seqp"))
    out = {}
    before = (moe._moe_a2a_body.calls, moe._moe_tp_body.calls)
    t0 = time.perf_counter()
    tokens = ep_serve(torch, model, params, 2, EP_LENS, EP_NEW)[0]
    out["serve_s"] = time.perf_counter() - t0
    out["bodies"] = (moe._moe_a2a_body.calls - before[0], moe._moe_tp_body.calls - before[1])
    if tokens != plain["tokens"][2]:
        raise AssertionError(f"phase 19 (a): serve_seqp tokens differ from the one-process "
                             f"sorted run's: {tokens} vs {plain['tokens'][2]}")
    offsets, inner = [], attention.flash_attention

    def spy(q, k, v, **kw):
        offsets.append((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
        return inner(q, k, v, **kw)

    attention.flash_attention = spy
    flash_attention_fwd.launches = 0
    coll.reset_counts()
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = model.prefill(params, {"tokens": torch.from_numpy(plain["prompt"]).to(
                device)})[0]
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
    finally:
        attention.flash_attention = inner
    out.update(prefill_launches=flash_attention_fwd.launches, offsets=offsets,
               prefill_collectives=coll.counts())
    V = f32.vocab_size  # the padded columns hold -1e30 on both sides
    got, want = logits.cpu().numpy()[:, :V], plain["logits"][:, :V]
    out["prefill_err"] = float(np.abs(got - want).max() / np.abs(want).max())
    return out


def seqp_serve_checks(ranks, plain):
    """Phase 19 (a)'s checks and log lines: every rank's tokens equal the
    one-process run's (checked in the rank), both bodies ran, each layer's
    flash launch ran at the rank's offset, the prefill's logits within
    ``SEQP_REL``."""
    B, S = SEQP_PROMPT
    ep = EP_MESH[1]
    for r in ranks:
        q = r["seqp"]
        want = [(S // ep, S, (r["rank"] % ep) * S // ep)] * EP_LAYERS
        if q["offsets"] != want or q["prefill_launches"] != EP_LAYERS:
            raise AssertionError(f"phase 19 (a) rank {r['rank']}: flash calls {q['offsets']}, "
                                 f"launches {q['prefill_launches']}, want {want}")
        if not q["prefill_err"] <= SEQP_REL or not all(q["bodies"]):
            raise AssertionError(f"phase 19 (a) rank {r['rank']}: prefill logits off by "
                                 f"{q['prefill_err']:.3e} of max, or a body never ran "
                                 f"{q['bodies']}")
    q = ranks[0]["seqp"]
    SEQP_SECONDS["(a)"] = q["serve_s"] + q["prefill_s"]
    log(f"phase 19 (a) serve_seqp f32, 2 slots: tokens of every rank equal the one-process "
        f"sorted run's ({len(EP_LENS)} x {EP_NEW}); a2a/tp body calls {q['bodies']}; "
        f"{q['serve_s']:.1f} s")
    log(f"phase 19 (a) Model.prefill [{B}, {S}] under serve_seqp: flash launches a rank "
        f"{q['prefill_launches']} at offsets "
        + ", ".join(str(r["seqp"]["offsets"][0][2]) for r in ranks)
        + f" ({S // ep} queries over {S} keys); logits within "
        + ", ".join(f"{r['seqp']['prefill_err']:.2e}" for r in ranks)
        + f" of max |logit| of one process's (limit {SEQP_REL:g}); {q['prefill_s']:.2f} s; "
        f"collectives (rank 0) {q['prefill_collectives']}")


def seqp_train_rank(torch, device, one_path, counters):
    """Phase 19 (b) on one rank of phase 18's (2, 2) mesh under ``seqp``:
    phase 18 (a)'s f32 run (a ``Trainer``'s state, its step function on its
    batches) for ``TM_STEPS_A`` steps, its params gathered and held on rank
    0 against the one process's (``one_path``), then ``SEQP_STEPS`` bf16
    steps (:func:`tm_bf16_run`, rank 0 profiled)."""
    import shutil

    import numpy as np

    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_topology

    f32, bf16, _ = tm_configs()
    topo = make_topology(TM_MESH, policy="seqp")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = tm_trainer(f32, topo, device, None, TM_STEPS_A)
    step_fn = steps.make_train_step(tr.model, tr.opt_cfg, tr.specs[0])
    f32_log = []
    for b in train_batches(f32, TM_STEPS_A, 0):
        batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        tr.params, tr.opt_state, m = step_fn(tr.params, tr.opt_state, batch)
        f32_log.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    got = sharding.gather_tree(tr.params, tr.specs[0], topo)
    n_leaves = 0
    if topo.rank == 0:  # params_after_steps_close's rule, on the card
        lr_steps = TRAIN_OPT["lr"] * TM_STEPS_A
        with np.load(one_path) as z:
            for path, a in _flat_tree(got).items():
                b = torch.from_numpy(z[path]).to(device)
                diff = (a.float() - b.float()).abs()
                if not (diff.max().item() <= lr_steps and (
                        diff > 1e-5 + 1e-5 * b.abs()).float().mean().item() <= 0.01):
                    raise AssertionError(f"phase 19 (b): params {path} after the steps differ "
                                         f"from the one process's (max {diff.max():.3e})")
                n_leaves += 1
    out = {"f32_log": f32_log, "f32_s": time.perf_counter() - t0, "leaves": n_leaves,
           "f32_peak": torch.cuda.max_memory_allocated()}
    shutil.rmtree(tr.tc.checkpoint_dir, ignore_errors=True)
    del tr, step_fn, got
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["bf16"] = tm_bf16_run(torch, bf16, topo, device, SEQP_STEPS, counters,
                              "train_seqp_step_profile.txt")
    out["bf16"]["seconds"] = time.perf_counter() - t0
    return out


def seqp_mamba_configs():
    """(f32, bf16) full-width, full-depth mamba2-130m, AdamW, its SSD heads
    in blocks of ``SEQP_SSM_HEAD_BLOCK`` (the config's 8 does not divide a
    rank's 12 heads: the reference's ``ssd_chunked`` asserts there and the
    port's raises; a block bounds memory, not the math)."""
    import dataclasses

    from repro_torch.configs import get_config

    base = get_config(SEQP_SSM)
    base = base.replace(ssm=dataclasses.replace(base.ssm, head_block=SEQP_SSM_HEAD_BLOCK))
    return base.replace(dtype="float32"), base


def _flat_tree(tree, prefix=""):
    """{'/'-joined path: leaf} of a nested dict (the leaves as they are)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def seqp_mamba_reference(torch, path):
    """Phase 19 (c)'s one-process side: mamba2-130m's f32 loss and every
    gradient leaf on ``train_batches``' first batch, written to ``path``
    (the loss under ``__loss``).  Returns the loss."""
    import numpy as np

    from repro_torch.launch import steps
    from repro_torch.models.model import Model

    f32, _ = seqp_mamba_configs()
    model = Model(f32, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEQP_SSM_SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batches(f32, 1, 0)[0].items()}
    loss, _, grads = steps.loss_and_grads(steps.make_loss_fn(model), params, batch)
    np.savez(path, __loss=np.asarray(float(loss)),
             **{k: v.numpy() for k, v in _tm_flat(grads).items()})
    del model, params, grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    return float(loss)


def ssm_tp_rank(torch, topo, device, ref_path, counters):
    """Phase 19 (c) on one rank of phase 18's (2, 2) ``tp`` mesh: full-width
    mamba2-130m's f32 loss and this rank's blocks of every gradient leaf
    (the train step's ``grads``: ZeRO-3 blocks, the SSM head-sharded, 12 of
    24 heads a rank) against the one process's; then ``SEQP_SSM_STEPS``
    bf16 steps (:func:`tm_bf16_run`)."""
    import numpy as np

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import OptimizerConfig

    f32, bf16 = seqp_mamba_configs()
    model = Model(f32, device, topo)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = model.init(torch.Generator(device=device).manual_seed(SEQP_SSM_SEED))
    pspecs, _ = sharding.train_specs(full, f32.optimizer, topo)
    blocks = sharding.shard_tree(full, pspecs, topo)
    del full
    step = steps.make_train_step(model, OptimizerConfig(name=f32.optimizer, **TRAIN_OPT), pspecs)
    batch = {k: torch.from_numpy(v).to(device) for k, v in train_batches(f32, 1, 0)[0].items()}
    coll.reset_counts()
    metrics, grads = step.grads(blocks, batch)
    out = {"counts": coll.counts(), "loss": float(metrics["loss"])}
    specs = _flat_tree(pspecs)
    errs = {}
    with np.load(ref_path) as z:
        out["loss_want"] = float(z["__loss"])
        for path, g in _tm_flat(grads).items():
            whole = torch.from_numpy(z[path])
            want = sharding.local_block(whole, specs[path], topo)
            errs[path] = float((g - want).abs().max() / whole.abs().max().clamp_min(1e-30))
    out["worst"] = max(errs.items(), key=lambda kv: kv[1])
    out["leaves"] = len(errs)
    out["f32_s"] = time.perf_counter() - t0
    out["f32_peak"] = torch.cuda.max_memory_allocated()
    del blocks, grads, step, model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["bf16"] = tm_bf16_run(torch, bf16, topo, device, SEQP_SSM_STEPS, counters)
    out["bf16"]["seconds"] = time.perf_counter() - t0
    return out


def seqp_train_checks(ranks, one_log, mamba_loss):
    """Phase 19 (b) and (c)'s checks and log lines (rank 0 held (b)'s
    params).  Returns rank 0's launches in (b)'s bf16 run."""
    r0 = ranks[0]
    for i, m in enumerate(r0["seqp"]["f32_log"]):
        want = one_log[i]
        rl = abs(m["loss"] - want["loss"]) / abs(want["loss"])
        rg = abs(m["grad_norm"] - want["grad_norm"]) / abs(want["grad_norm"])
        log(f"phase 19 (b) seqp f32 step {i + 1}: loss {m['loss']:.6f} vs one process "
            f"{want['loss']:.6f} (rel {rl:.2e}), grad norm {m['grad_norm']:.5f} vs "
            f"{want['grad_norm']:.5f} (rel {rg:.2e})")
        if not (rl <= 1e-5 and rg <= 1e-4) or any(
                r["seqp"]["f32_log"][i]["loss"] != m["loss"] for r in ranks):
            raise AssertionError(f"phase 19 (b) step {i + 1}: the seqp mesh disagrees with the "
                                 "one-process run, or the ranks differ")
    log(f"phase 19 (b): the seqp params after step {TM_STEPS_A} (gathered on rank 0) equal "
        f"the one process's ({r0['seqp']['leaves']} leaves); peak a rank "
        + ", ".join(f"{r['seqp']['f32_peak'] / 2**30:.2f}" for r in ranks)
        + f" GiB; {r0['seqp']['f32_s']:.1f} s on rank 0")
    rc = r0["seqp"]["bf16"]
    c = r0["ssm"]
    SEQP_SECONDS["(b)"] = r0["seqp"]["f32_s"] + rc["seconds"]
    SEQP_SECONDS["(c)"] = c["f32_s"] + c["bf16"]["seconds"]
    tokens = TRAIN_B * TRAIN_S
    log(f"phase 19 (b) seqp bf16: losses " + " ".join(f"{x:.4f}" for x in rc["losses"])
        + f"; step median {rc['step_s'] * 1e3:.1f} ms (rank 0, host clock after float(loss)), "
        f"{tokens / rc['step_s']:.0f} tokens/s; {rc['seconds']:.1f} s; dropped_frac "
        f"{rc['extra']['dropped']:.4f}; peak a rank "
        + ", ".join(f"{r['seqp']['bf16']['peak'] / 2**30:.2f}" for r in ranks) + " GiB")
    log(f"phase 19 (b) seqp bf16: collectives a step (rank 0; calls / bytes handed in, forward "
        f"with the recomputation, and backward): {rc['counts']}")
    got = {k: rc["launches"][k] for k in TM_PER_STEP}
    log(f"phase 19 (b) seqp bf16: launches a step (rank 0) {got}")
    if got != {k: float(v) for k, v in TM_PER_STEP.items()}:
        raise AssertionError(f"phase 19 (b): launches a step {got}, want {TM_PER_STEP}")
    only_path("phase 19 (b)", rc["launches"], TM_PER_STEP)
    kv = rc["counts"]["all_gather_rs"]
    if not (kv["calls"] and kv["bwd_calls"]):
        raise AssertionError(f"phase 19 (b): no K/V gather or reduce-scatter {kv}")
    if not all(math.isfinite(x) for r in ranks for x in r["seqp"]["bf16"]["losses"]):
        raise AssertionError("phase 19 (b): a bf16 loss is not finite")
    if rc["profile"] is not None:
        dev_ms, wall_ms, path = rc["profile"]
        log(f"phase 19 (b) seqp bf16 profiled step (rank 0, the other ranks stepping beside it): "
            f"device {dev_ms:.3f} ms of {wall_ms:.1f} ms wall ({dev_ms / wall_ms:.1%} busy); "
            f"kernels in path {path}; chiprun_out/train_seqp_step_profile.txt")
    for r in ranks:
        c = r["ssm"]
        rl = abs(c["loss"] - mamba_loss) / abs(mamba_loss)
        if not (rl <= 1e-5 and c["worst"][1] <= SEQP_GRAD_REL):
            raise AssertionError(f"phase 19 (c) rank {r['rank']}: loss rel {rl:.2e}, worst "
                                 f"gradient leaf {c['worst']}")
    c = r0["ssm"]
    log(f"phase 19 (c) mamba2-130m f32 under tp (12 of 24 heads a rank): loss {c['loss']:.6f} vs "
        f"one process {mamba_loss:.6f}; every rank's blocks of all {c['leaves']} gradient "
        f"leaves within " + ", ".join(f"{r['ssm']['worst'][1]:.2e}" for r in ranks)
        + f" of each leaf's max (limit {SEQP_GRAD_REL:g}; rank 0's worst {c['worst'][0]}); "
        f"{c['f32_s']:.1f} s; collectives {c['counts']}")
    b = c["bf16"]
    log(f"phase 19 (c) mamba2-130m bf16 under tp: losses " + " ".join(
        f"{x:.4f}" for x in b["losses"]) + f"; step median {b['step_s'] * 1e3:.1f} ms (rank 0, "
        f"host clock), {tokens / b['step_s']:.0f} tokens/s; peak a rank "
        + ", ".join(f"{r['ssm']['bf16']['peak'] / 2**30:.2f}" for r in ranks)
        + f" GiB; collectives a step {b['counts']}; {b['seconds']:.1f} s")
    if not all(math.isfinite(x) for x in b["losses"]):
        raise AssertionError("phase 19 (c): a bf16 loss is not finite")
    return {k: round(v * SEQP_STEPS) for k, v in rc["launches"].items()}


def seqp_flash_case(torch, timer, gen, name, B, S, ep, H, KV, hd, bf16):
    """The flash forward and backward kernels at sequence-parallel shapes:
    each rank r's ``S/ep`` queries at ``q_offset = r·S/ep`` over all ``S``
    keys, causal, against their plain versions (the forward as phase 2,
    the backward as :func:`bwd_case`, each rank's offset); the last
    rank's (the most visible pairs) time, plain time, bound and SDPA's
    forward and backward with the offset's mask as the library.  Returns
    the record."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import block_mask

    dtype = torch.bfloat16 if bf16 else torch.float32
    tag = f"{name} [{B},{S // ep} of {S}] {'bf16' if bf16 else 'f32'}"
    Sq = S // ep
    k, v = (torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dtype) for _ in "kv")
    errs = []
    for r in range(ep):
        q, dout = (torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype)
                   for _ in "qo")
        kw = dict(causal=True, window=None, q_offset=r * Sq)
        out, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
        ref, lse_plain = flash_attention_plain(q, k, v, return_lse=True, **kw)
        rtol, arel = (2 ** -16, 2 ** -14) if not bf16 else (2 ** -7, 2 ** -6)
        errs.append(check_close(f"flash_attention {tag} offset {r * Sq}", out, ref, rtol=rtol,
                                atol=arel * ref.float().abs().median().item(), quiet=True))
        lse_err = ((lse - lse_plain).abs() / lse_plain.abs().clamp_min(1.0)).max().item()
        got = flash_attention_bwd(dout, q, k, v, out, lse, **kw)
        want = flash_attention_bwd_plain(dout, q, k, v, out, lse, **kw)
        rel = 2e-2 if bf16 else 1e-4
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w.float()).abs().max().item()
            if not (err <= rel * w.float().abs().max().item() and lse_err <= 1e-5):
                raise AssertionError(f"flash_attention_bwd {tag} offset {r * Sq}: {what} "
                                     f"max|diff| {err:.3e}, lse {lse_err:.1e}")
            errs.append(err)
    vis = block_mask(kw["q_offset"] + torch.arange(Sq, device="cuda"),
                     torch.arange(S, device="cuda"), True, None)  # the last rank's
    isz = 2 if bf16 else 4
    kind = "bf16" if bf16 else "f32"
    pairs = int(vis.sum())
    f_ms, f_by = bound((2 * q.numel() + 2 * k.numel()) * isz, 4 * hd * B * H * pairs, kind)
    b_ms, b_by = bound((4 * q.numel() + 4 * k.numel()) * isz + lse.numel() * 4,
                       5 * 2 * hd * B * H * pairs, kind)
    fwd = functools.partial(flash_attention_fwd, q, k, v, **kw)
    bwd = functools.partial(flash_attention_bwd, dout, q, k, v, out, lse, **kw)
    ms, bms = timer(fwd), timer(bwd)
    plain_ms = timer(lambda: flash_attention_plain(q, k, v, **kw), iters=3, warmup=1)
    plain_bms = timer(lambda: flash_attention_bwd_plain(dout, q, k, v, out, lse, **kw), iters=3,
                      warmup=1)
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
              for t in (k, v))
    o_t = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis)
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis))
    lib_bms = timer(lambda: torch.autograd.grad(o_t, (qt, kt, vt), dout.transpose(1, 2),
                                                retain_graph=True))
    log(f"  flash_attention {tag}: offsets 0..{(ep - 1) * Sq} max_abs_err {max(errs):.2e}; last "
        f"rank fwd ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={f_ms:.5f} ({f_by}) "
        f"library_ms(sdpa, offset mask)={lib_ms:.4f}; bwd ms={bms:.4f} plain_ms={plain_bms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}) library_ms(sdpa bwd)={lib_bms:.4f}")
    return dict(max_abs_err=max(errs), ms=ms, bwd_ms=bms)


def seqp_kernels(torch, timer):
    """Phase 19's kernels at its shapes (``SEQP_FLASH_CASES``, bf16 and f32:
    the flash forward and backward at every rank's offset); the gate and
    the expert FFN on pre-sharded tokens take phase 18's shapes (a rank's
    256 rows of switch-base: the a2a chunk's) and phase 17's (qwen3-moe's
    wide gate at 1-16 rows, the FFN at ``ep·C`` rows), held there."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    t0 = time.perf_counter()
    for case in SEQP_FLASH_CASES:
        for bf16 in (True, False):
            seqp_flash_case(torch, timer, gen, *case, bf16)
    SEQP_SECONDS["kernels"] = time.perf_counter() - t0
    log(f"phase 19 kernel checks took {SEQP_SECONDS['kernels']:.1f} s")


def seqp_phase(torch, timer, counters):
    """Phase 19 alone (``--seqp``): its kernels, then (a) in phase 17's ranks
    and (b)-(c) in phase 18's, each with its one-process references only."""
    seqp_kernels(torch, timer)
    ep_phase(torch, timer, only_seqp=True)
    train_mesh_phase(torch, timer, only_seqp=True)


def wrappers():
    """Every kernel wrapper of the port, each counting its launches."""
    from repro_torch.kernels.expert_mlp import (
        grouped_mlp,
        grouped_mlp_resident,
        grouped_mlp_resident_quant,
    )
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.group_gate import group_gate
    from repro_torch.kernels.lowrank import (
        lowrank_decode,
        lowrank_decode_quant,
        lowrank_encode,
        lowrank_encode_quant,
        lowrank_roundtrip,
        lowrank_roundtrip_loss,
    )
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_quant
    from repro_torch.kernels.quant import dequantize_rows, paged_write_quant, quantize_rows

    return [grouped_mlp_resident, grouped_mlp_resident_quant, grouped_mlp, group_gate,
            lowrank_encode, lowrank_decode, paged_attention, paged_attention_quant,
            quantize_rows, dequantize_rows, paged_write_quant, flash_attention_fwd,
            lowrank_roundtrip, lowrank_roundtrip_loss, lowrank_encode_quant, lowrank_decode_quant]


def serve_phase(torch, timer, counters):
    """Phase 3 alone: full-width switch-base's ServingEngine (its decode
    step times), through the path's three kernels."""
    path = [c for c in counters if c.__name__ in ("paged_attention", "group_gate", "grouped_mlp")]
    serve(torch, path)


# the phases that ``--flag`` runs alone, after the build; no result line
ALONE = {"--serve": ("serve", lambda: serve_phase), "--vlm": ("vlm", lambda: vlm_phase),
         "--ssm": ("ssm", lambda: ssm_phase), "--danube": ("danube", lambda: danube_phase),
         "--encdec": ("encdec", lambda: encdec_phase), "--train": ("train", lambda: train_phase),
         "--train2": ("train2", lambda: train2_phase), "--ep": ("ep", lambda: ep_phase),
         "--train-mesh": ("train mesh", lambda: train_mesh_phase),
         "--seqp": ("seqp", lambda: seqp_phase)}


def alone(torch, flag: str) -> int:
    """The build and the phase of ``flag`` (``ALONE``) alone."""
    from repro_torch.kernels import build

    tag, phase = ALONE[flag]
    log(f"card: {nvidia_smi()}")
    t0 = time.perf_counter()
    build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    OUT_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    phase()(torch, Timer(torch), wrappers())
    log(f"{tag} phase took {time.perf_counter() - t0:.1f} s")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if "--chaos-timeline" in sys.argv[1:]:
        return chaos_timeline(torch)
    for flag in ALONE:
        if flag in sys.argv[1:]:
            return alone(torch, flag)
    from repro_torch.kernels import build
    from repro_torch.kernels.expert_mlp import grouped_mlp
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.group_gate import group_gate
    from repro_torch.kernels.lowrank import (
        lowrank_decode,
        lowrank_encode,
        lowrank_roundtrip,
        lowrank_roundtrip_loss,
    )
    from repro_torch.kernels.paged_attention import paged_attention

    t_script = time.perf_counter()
    log(f"card: {nvidia_smi()}")
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = build.build()
    log(f"kernel build (nvcc, {len(build.SOURCES)} sources in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "nvcc_build.log").write_text("".join(
        f"== {name}\n{path.with_suffix('.log').read_text()}"
        for name, path in libs.items()
    ))

    timer = Timer(torch)
    log("kernels against their plain versions (bf16, card):")
    t0 = time.perf_counter()
    recs = {
        "paged_attention": run_paged_attention(torch, timer),
        "group_gate": run_group_gate(torch, timer),
        "expert_mlp": run_expert_mlp(torch, timer),
        "grouped_mlp_resident": run_expert_mlp_resident(torch, timer),
        "flash_attention": run_flash_attention(torch, timer),
        **run_lowrank(torch, timer),
        **run_roundtrip(torch, timer),
    }
    log(f"kernel checks took {time.perf_counter() - t0:.2f} s")

    serve_launches, eng = serve(torch, [paged_attention, group_gate, grouped_mlp])
    log("end-to-end against the CPU reference:")
    reference_check(torch, eng)
    log("one-shot end-cloud pipeline:")
    pipe_counters = [flash_attention_fwd, lowrank_encode, lowrank_decode, lowrank_roundtrip,
                     lowrank_roundtrip_loss, group_gate, grouped_mlp, paged_attention]
    pipe_launches = pipeline(torch, eng, pipe_counters)
    log("MoE dispatch codec (full-width switch-base, rank 384 on the expert dispatch):")
    t0 = time.perf_counter()
    dispatch_launches, deng = dispatch_serving(
        torch, [paged_attention, group_gate, grouped_mlp, lowrank_roundtrip_loss],
        [lowrank_encode, lowrank_decode, lowrank_roundtrip])
    dispatch_pipeline(torch, deng, pipe_counters)
    del deng
    log(f"dispatch codec serving and pipeline took {time.perf_counter() - t0:.1f} s")
    log("streaming end-cloud engine:")
    t0 = time.perf_counter()
    stream_counters = wrappers()
    tick_profiles = {}  # phases 6-7's profiled ticks, read beside phase 9's
    model, params, stream_launches, base = stream(torch, stream_counters, tick_profiles)
    log(f"stream phase took {time.perf_counter() - t0:.1f} s")
    log("streaming end-cloud engine with the MoE dispatch codec:")
    t0 = time.perf_counter()
    dispatch_stream(torch, stream_counters)
    log(f"dispatch codec stream phase took {time.perf_counter() - t0:.1f} s")
    log("int8 byte streams, kernels against their plain versions (card):")
    t0 = time.perf_counter()
    recs.update(run_quant(torch, timer))
    recs.update(run_codec_quant(torch, timer))
    recs["paged_write_quant"] = run_kv_write(torch, timer)
    recs["paged_attention_quant"] = run_paged_attention(torch, timer, quant=True)
    recs["grouped_mlp_resident_quant"] = run_expert_mlp_resident_quant(torch, timer)
    log(f"int8 kernel checks took {time.perf_counter() - t0:.2f} s")
    log("streaming end-cloud engine with the int8 streams:")
    t0 = time.perf_counter()
    quant_launches = stream_quant(torch, model, params, stream_counters, base, tick_profiles)
    log(f"int8 stream phase took {time.perf_counter() - t0:.1f} s")
    log("streaming end-cloud engine: speculative decode and preemption:")
    t0 = time.perf_counter()
    spec_launches = spec_and_preempt(torch, model, params, stream_counters)
    log(f"speculative decode and preemption phase took {time.perf_counter() - t0:.1f} s")
    log("fleet engine: three lanes over one shared cloud, driven by the load generator:")
    t0 = time.perf_counter()
    fleet_launches = fleet_phase(torch, model, params, stream_counters, tick_profiles)
    log(f"fleet phase took {time.perf_counter() - t0:.1f} s")
    log("fleet engine under a declared fault schedule (chaos):")
    t0 = time.perf_counter()
    chaos_launches = chaos_phase(torch, model, params, stream_counters, tick_profiles)
    log(f"chaos phase took {time.perf_counter() - t0:.1f} s")
    log("profiler device time a call, us (L2 flushed; phase 2's kernels and yardsticks, "
        "read after the timed runs):")
    t0 = time.perf_counter()
    timer.read_later()
    log(f"profiler readings took {time.perf_counter() - t0:.1f} s")
    log("qwen2-vl-2b (M-RoPE, patch embeddings) through the model and every engine:")
    t0 = time.perf_counter()
    vlm_launches = vlm_phase(torch, timer, stream_counters)
    log(f"vlm phase took {time.perf_counter() - t0:.1f} s")
    log("mamba2-130m (SSM) and jamba's hybrid through the model, the dense-ring "
        "ServingEngine and the pipeline:")
    t0 = time.perf_counter()
    ssm_launches = ssm_phase(torch, timer, stream_counters)
    log(f"ssm phase took {time.perf_counter() - t0:.1f} s")
    log("h2o-danube-3-4b (head_dim 120) through the kernels, ServingEngine, the pipeline and "
        "the streaming engine:")
    t0 = time.perf_counter()
    danube_launches = danube_phase(torch, timer, stream_counters)
    log(f"danube phase took {time.perf_counter() - t0:.1f} s")
    log("whisper-base (encoder-decoder) through the model:")
    t0 = time.perf_counter()
    encdec_launches = encdec_phase(torch, timer, stream_counters)
    log(f"encdec phase took {time.perf_counter() - t0:.1f} s")
    log("training on switch-base at full width (the flash backward kernel, the Functions, "
        "the train step, Trainer):")
    t0 = time.perf_counter()
    recs["flash_attention_bwd"], train_launches = train_phase(torch, timer, stream_counters)
    log(f"train phase took {time.perf_counter() - t0:.1f} s")
    log("training, second half: the dispatch codec's joint eq. 8 loss, SSM and "
        "encoder-decoder training:")
    t0 = time.perf_counter()
    train2_launches = train2_phase(torch, timer, stream_counters)
    log(f"train2 phase took {time.perf_counter() - t0:.1f} s")
    log("sequence parallelism (phase 19): the flash kernels at every rank's offset:")
    seqp_kernels(torch, timer)
    log("expert parallelism: qwen3-moe at full width over 4 ranks on the card (the a2a and "
        "tp bodies through Model and ServingEngine), and phase 19 (a) in the same ranks:")
    ep_launches = ep_phase(torch, timer)
    log("training on a mesh: full-width switch-base over 4 ranks on the card (the sharded "
        "train step and Trainer, the bodies' backward, the elastic resume), and phase 19's "
        "(b) and (c) in the same ranks:")
    train_mesh_launches = train_mesh_phase(torch, timer)
    seqp_launches = train_mesh_launches.pop("seqp")
    log(f"phase 19 took {sum(SEQP_SECONDS.values()):.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in SEQP_SECONDS.items())
        + "; (a)-(c) on rank 0 inside the ranks of phases 17 and 18)")
    log(f"chip_smoke.py took {time.perf_counter() - t_script:.1f} s (from the build on)")
    # each kernel reports the launches of the path it was ported for: the
    # serving run for the first three, the pipeline run for the codec and
    # flash attention, the serving run with the dispatch codec for its
    # roundtrip, the streaming engine's pool run for the resident expert
    # FFN, and its run with the int8 streams for theirs (the standalone
    # dequantizer: 0, the boundary takes the fused decode; the quantizer:
    # the slab writes)
    launches = {**pipe_launches, **serve_launches,
                "lowrank_roundtrip_loss": dispatch_launches["lowrank_roundtrip_loss"],
                "grouped_mlp_resident": stream_launches["grouped_mlp_resident"],
                **{k: quant_launches[k] for k in (
                    "quantize_rows", "dequantize_rows", "paged_write_quant",
                    "paged_attention_quant", "grouped_mlp_resident_quant",
                    "lowrank_encode_quant", "lowrank_decode_quant")},
                "flash_attention_bwd": train_launches["flash_attention_bwd"]}

    meta = {
        "paged_attention": ("cuda", "src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:196", "paged_attention"),
        "group_gate": ("cuda", "src/repro_torch/csrc/group_gate.cu",
                       "src/repro/kernels/group_gate/kernel.py:85", "group_gate"),
        "expert_mlp": ("cuda", "src/repro_torch/csrc/expert_mlp.cu",
                       "src/repro/kernels/expert_mlp/kernel.py:108", "grouped_mlp"),
        "grouped_mlp_resident": ("cuda", "src/repro_torch/csrc/expert_mlp.cu",
                                "src/repro/kernels/expert_mlp/kernel.py:214",
                                "grouped_mlp_resident"),
        "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:122",
                            "flash_attention_fwd"),
        "lowrank_encode": ("cuda", "src/repro_torch/csrc/lowrank.cu",
                           "src/repro/kernels/lowrank/kernel.py:59", "lowrank_encode"),
        "lowrank_decode": ("cuda", "src/repro_torch/csrc/lowrank.cu",
                           "src/repro/kernels/lowrank/kernel.py:77", "lowrank_decode"),
        "lowrank_roundtrip_loss": ("cuda", "src/repro_torch/csrc/lowrank.cu",
                                   "src/repro/kernels/lowrank/kernel.py:96",
                                   "lowrank_roundtrip_loss"),
        "quantize_rows": ("cuda", "src/repro_torch/csrc/quant.cu",
                          "src/repro/kernels/quant/kernel.py:56", "quantize_rows"),
        "dequantize_rows": ("cuda", "src/repro_torch/csrc/quant.cu",
                            "src/repro/kernels/quant/kernel.py:83", "dequantize_rows"),
        "lowrank_encode_quant": ("cuda", "src/repro_torch/csrc/lowrank.cu",
                                 "src/repro/kernels/quant/kernel.py:56", "lowrank_encode_quant"),
        "lowrank_decode_quant": ("cuda", "src/repro_torch/csrc/lowrank.cu",
                                 "src/repro/kernels/quant/kernel.py:83", "lowrank_decode_quant"),
        "paged_write_quant": ("cuda", "src/repro_torch/csrc/quant.cu",
                              "src/repro/kernels/quant/kernel.py:56", "paged_write_quant"),
        "paged_attention_quant": ("cuda", "src/repro_torch/csrc/paged_attention.cu",
                                  "src/repro/kernels/paged_attention/kernel.py:139",
                                  "paged_attention_quant"),
        "grouped_mlp_resident_quant": ("cuda", "src/repro_torch/csrc/expert_mlp.cu",
                                       "src/repro/kernels/expert_mlp/kernel.py:132",
                                       "grouped_mlp_resident_quant"),
        "flash_attention_bwd": ("cuda", "src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/models/attention.py:182", "flash_attention_bwd"),
    }
    kernels = []
    for name, (route, source, replaces, counter) in meta.items():
        r = recs[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[counter], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # launches in phase 8's bf16 speculative run (expert pool, int8 streams)
            "spec_launches": spec_launches.get(counter, 0),
            # launches in phase 9's bf16 fleet run (three lanes, int8 streams)
            "fleet_launches": fleet_launches.get(counter, 0),
            # launches in phase 10's bf16 chaos run (the same fleet under faults)
            "chaos_launches": chaos_launches.get(counter, 0),
            # launches in phase 11's runs of qwen2-vl-2b, (a)-(d) summed
            "vlm_launches": vlm_launches.get(counter, 0),
            # launches in phase 12's bf16 runs (mamba2-130m, jamba's hybrid)
            "ssm_launches": ssm_launches.get(counter, 0),
            # launches in phase 13's runs of h2o-danube-3-4b, (b)-(d) summed
            "danube_launches": danube_launches.get(counter, 0),
            # launches in phase 14's bf16 run of whisper-base (prefill + decode)
            "encdec_launches": encdec_launches.get(counter, 0),
            # launches in phase 15's bf16 training run (30 steps of switch-base)
            "train_launches": train_launches.get(counter, 0),
            # launches in phase 16's bf16 runs (the codec model's and
            # mamba2's Trainer, whisper's train steps), summed
            "train2_launches": train2_launches.get(counter, 0),
            # launches in phase 17's bf16 run on rank 0 of 4 (qwen3-moe,
            # the a2a body through the codec)
            "ep_launches": ep_launches.get(counter, 0),
            # launches in phase 18's bf16 training runs on rank 0 of 4
            # ((c) and (d): switch-base, the a2a body, with and without the
            # dispatch codec), forward, recomputation and backward
            "train_mesh_launches": train_mesh_launches.get(counter, 0),
            # launches in phase 19 (b)'s bf16 training run on rank 0 of 4
            # (switch-base under seqp: sequence-parallel attention, the a2a
            # body on pre-sharded tokens)
            "seqp_launches": seqp_launches.get(counter, 0),
        })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
