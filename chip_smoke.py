"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                # full size: 8192 events, ~8.5 GB
    python3 chip_smoke.py --n-events 512 # a short first check

Phases, each printing one JSON line:

1. device  — torch's device name, nvidia-smi's name and power limit;
2. build   — nvcc builds the seven CUDA sources, one nvcc each, started
   together; ptxas's registers and spills for every kernel instance (an
   instance of flash_attention, mlstm, rglru_scan, adamw or a backward
   that spills fails the run);
3. kernels — each kernel against its plain PyTorch version on the card.
   event_filter at the query path's chunk shape (64, 4096, 63) with S = 64
   and a ragged (37, 1000, 63), K in {1, 4, 17}, calib_iters in {0, 4},
   with and without a sum(pt) cap, the batched kernel at each block size
   the launch-shape sweep may pick (128, 256, 512 threads).  Masks must be
   equal at calib 0 without a cap; otherwise they may differ only on band
   events (a count-driving pt or the sum within rtol 1e-5 of its
   threshold), which are counted.
   flash_attention at qwen3-14b's decode (B 2, Sq 1, Sk in {1, 9, 24,
   256}, 48 q heads over 8 kv heads of 128, bf16) and prefill (B 1,
   Sq = Sk = 2048, causal, bf16) shapes, at recurrentgemma-9b's decode
   (Sk in {1, 24, 256}, 16 q heads over 1 kv head of 256) and prefill (B
   1, Sq = Sk = 4096, window 2048) shapes, the tensor-core kernels off
   those shapes (Sq 300, 64 <= Sq < Sk, head dim 64, window with softcap,
   non-causal, decode over 2048- and 4096-slot rings, which takes the
   split-K path and its merge), whisper-medium's non-causal shapes at
   head dim 64 and full MHA (the 1500-frame encoder, cross-attention of 1
   query over 1500 keys on 4 splits with a ragged last tile, and of 448
   queries over 1500 keys; each must take its planned kernel and splits),
   and small cases (Sq < Sk, a window, a
   softcap, ragged tiles, f32, head dim 16), within |kernel - plain| <=
   atol + rtol |plain|: 2e-2 in bf16, 2e-4 in f32 with TF32 off (FA_TOL);
   bf16 cases also against the plain version in f32 on the same values.
   Each row names the device kernel the wrapper's plan chose.
   flash_attention's backward (flash_attention_bwd.cu) on the output and
   the lse of one forward launch (with_lse) and a seeded incoming
   gradient: causal and not, Sq < Sk, a window, a softcap, ragged tiles,
   GQA 16:1, 5:1 and 6:1, head dims 64 / 128 / 256 in bf16 and f32 (f32
   also at 16 and 32), rows whose window masks every key (their dq must
   be 0), starcoder2-3b's training shape (2, 2048, 2048, 32 q heads over
   2 kv heads of 128, causal, bf16), recurrentgemma-9b's (1, 2048,
   2048, 16 q heads over 1 kv head of 256, window 2048, bf16) and
   grok-1's (1, 2048, 2048, 48 q heads over 8 kv heads of 128, causal,
   softcap 30, bf16, q scaled by 8 so the scores reach the cap; every
   capped row must move the plain dq and dk by more than BWD_TOL when
   the cap is left out); bf16 at
   head dim 64, 128 and 256 must take the tensor-core variant
   (flash_bwd_wgmma.cuh), the rest the CUDA-core one; dq, dk and dv each
   within BWD_TOL (2e-2 bf16, 2e-4 f32)
   of the largest value of the plain backward (flash_attention_bwd_ref,
   which computes its own lse) in f32 on the same values, the forward's
   lse within LSE_TOL of the plain lse (+inf exactly where a row sees no
   key), autograd of the plain version in bf16 reported beside it, and
   two launches giving the same bits.  rglru_scan at recurrentgemma-9b's
   (1, 4096, 4096) with and without h0, a ragged (3, 100, 48), S under
   one chunk (2, 8, 4096), W no multiple of 4 (2, 77, 50, the cp.async
   load path) and 141 chunks (1, 9000, 128),
   within 1e-5 (SCAN_TOL) of the plain version and equal bit for bit to
   the chunked kernel's order of operations in plain PyTorch
   (rglru_scan_chunked_ref at the plan's chunk), each row with its plan
   (chunk, tile, blocks, load path);
   mlstm at xlstm-350m's (1, 2048, 4, 512) in bf16 (the tensor-core
   kernel) and f32, small f32 cases whose S is no multiple of the tile,
   and the tensor-core kernel off the model's shape (S 300 and 37, two
   batch rows, q, k, v as views of one fused tensor, gates under which
   exp(-m) wins the normaliser), against the plain version evaluated in
   f32 on the same values (the kernel's arithmetic): 2e-2 for a bf16
   output, 5e-4 in f32 (MLSTM_TOL); the distance from the plain version in
   bf16 is reported, and each row names the device kernel the wrapper's
   plan chose.  Then the B4 and B5 backward kernels (SCAN_BWD_CASES,
   MLSTM_BWD_CASES): rglru_scan's backward at recurrentgemma-9b's
   training microbatch (1, 2048, 4096) without and with h0 and dh_last, a
   ragged S, S under one chunk, the cp.async path and 141 chunks, equal
   bit for bit to rglru_scan_bwd_chunked_ref and within BWD_TOL of the
   plain backward; the mLSTM forward's row stats (L = m + log n, sg)
   against the plain ones in f32 (mlstm_stats_check), and its backward at
   xlstm-350m's training microbatch (2, 2048, 4, 512) bf16, with the
   model's forget gates (F ~ -600 at 2048), off that shape (S 300 and 37,
   sg = 0 rows, q, k, v as views of one fused tensor), and at small and
   f32 cases, dq, dk, dv, d log_i and d log_f each within BWD_TOL of the
   largest value of the plain backward (mlstm_bwd_ref) in f32 on the same
   values and stats; bf16 at head dim 512 must take the tensor-core
   variant (mlstm_bwd_wgmma.cuh) and lie within TWIN_TOL of its
   arithmetic in plain PyTorch (mlstm_bwd_split_ref), the rest the
   CUDA-core one.  Two launches of every case must give the same bits;
4. serve   — the paper's event workload (64 scalars, 4096 tracks x 63
   vars, 256 events per brick, replication 2) on 4 nodes, resident on the
   card; the serve workload (64 queries, 4 tenants, window 16, streamed)
   through QueryService on the spmd backend with the kernel, checked
   against a second service on the plain path; then spmd_query_step and
   spmd_query_batch_step with and without the kernel over one brick.
   Launch counts are zeroed just before each path (the serve run, each
   lockstep step) and read just after it, so every path has its own.
   One more run of the workload under torch.profiler gives the device
   time by kernel and the card's summed kernel time;
   autotune — the same workload through QueryService on spmd with the
   kernel and autotune=True: each shape class of its windows sweeps the
   kernel's block sizes on a sample chunk (one warm-up and tune.REPEATS
   timed launches a candidate) and every kernel chunk launches with the
   winner; the sweep's launches are counted apart and the chunks' must
   equal the kernel chunks; every final must be identical to the
   plain-path service's; each verdict (the candidates' ms, the winner,
   the default, the speedup) is printed;
   fleet   — on the same resident store, a Fleet of 4 front-ends on the
   spmd backend with the kernel, the observability plane and
   single-flight leases on, runs the launcher's fleet workload (64
   streamed queries round-robin, 4 tenants, a step every 16, a dataset
   bump at half way, a drain): building it must allocate less than one
   brick on the card; event_filter_batch must launch once per chunk of
   the windows with kernel targets (counts zeroed just before the run,
   read just after), kernel_events must equal events_scanned, every
   final must be identical to the same fleet's on the plain path, and
   the fleet's trace must validate; then one more dataset bump must
   reach every front-end within the gossip bound;
   failover — Fleets of 4 on the sim backend on the card, with the
   failure policy, gossip repair and a bus that drops 5 % of its
   messages (seed 0); node 1 leaves after a third of the queries.  The
   run as the launcher makes it is recorded by the flight recorder:
   every ticket SERVED over every event, and its log replayed through
   replay_run on the same resident bricks must be identical.  The same
   run on fixed packets must give finals identical to a run with no node
   leaving (adaptive packets follow the nodes' virtual times, so their
   float sums differ in the last bits there, in the JAX package too);
5. lm      — the query store freed, nine LMs at full width, one on the
   card at a time, each held by ``LanguageModel`` with parameters drawn
   from a seeded generator: qwen3-14b (40 layers, d_model 5120, 48 (40
   real) q heads x 128 over 8 kv heads, d_ff 17408, 30.4 GB bf16),
   recurrentgemma-9b (38 layers = 12 x (rec, rec, attn) + (rec, rec),
   d_model 4096, lru_width 4096, 16 q heads x 256 over 1 kv head, window
   2048, 17.2 GB), xlstm-350m (24 layers = 3 x (7 mLSTM + 1 sLSTM),
   d_model 1024, 4 heads, 0.66 GB), pixtral-12b (40 layers, d_model 5120,
   32 q heads x 128 over 8, the stub patch projection, 24.5 GB),
   phi3.5-moe (16 of its 32 layers, LM_LAYERS: d_model 4096, 32 q heads
   over 8, 16 experts top-2 of d_ff 6400, ~42 GB; 32 layers are 83.7 GB)
   whisper-medium (24 encoder + 24 decoder layers, d_model 1024, 16
   heads of 64, full MHA, 1500 stub frames, 1.6 GB), then (LM_MORE)
   chatglm3-6b (28 layers, d_model 4096, 32 q heads over 2 kv heads of
   128: G = 16 fills the decode kernel's 16 rows; rotary on half the head
   dim; 12.5 GB), qwen3-32b whole (64 layers, d_model 5120, 64 q heads
   over 8, d_ff 25600, qk-norm, 65.5 GB: the largest model that fits,
   built with nothing else resident) and grok-1 at 4 of its 64 layers
   (LM_LAYERS: d_model 6144, 48 q heads over 8, attention softcap 30,
   sandwich norms, 8 experts top-2 of d_ff 32768, 42.6 GB).  Each serves
   generate() for a batch of 2 prompts of 8 tokens and 16 new tokens: 24
   decode steps, each attention call the flash kernel, so flash_attention
   must launch 40 x 24 = 960 times for qwen3-14b and pixtral-12b, 12 x 24
   = 288 for recurrentgemma-9b, 16 x 24 = 384 for phi3.5-moe, 24 x (24 +
   24) = 1,152 for whisper-medium (self- and cross-attention) after its
   24-layer encoder fills the cross cache (24 on ``flash_attention.wgmma``),
   28 x 24 = 672 for chatglm3-6b, 64 x 24 = 1,536 for qwen3-32b, 4 x 24 =
   96 for grok-1, and 0 for xlstm-350m, whose decode runs no kernel
   (counts of every LM kernel zeroed just before, read just after), every
   decode-step flash call on the GQA-packed decode kernel
   (``flash_attention.decode``).  The same tokens are
   replayed teacher-forced through the kernels (their argmax must give
   generate()'s tokens) and through the plain versions
   (``plain_kernels()``, in the working dtype and in f32); for qwen3-14b
   and qwen3-32b (E2E_GATED), and for pixtral-12b, phi3.5-moe,
   whisper-medium, chatglm3-6b and grok-1 where the path's own two plain
   runs agree within LM_REL_TOL and LM_TOP1_MIN (E2E_IF_STABLE), each
   step's max |logit difference| over the plain logits' spread must stay
   within LM_REL_TOL, and the top-1 agreement at or above LM_TOP1_MIN.
   The peak memory of the served path and of the phase is printed.  One
   more generate() under torch.profiler gives the device time by kernel
   and their sum;
   brick   — qwen3-14b on the same weights decoding through the
   grid-brick KV cache (core/brick_attention.py): a cache of 8192 slots
   on a (1, 4) ("data", "model") mesh emulated on the card, so its 4
   bricks of 2048 slots each compute a partial softmax that an exact
   log-sum-exp combine merges (brick_active holds).  A prompt of 8189
   tokens fills the ring from one batched forward (fill_ring), so every
   brick holds live tokens; from copies of that cache, 6 teacher-forced
   decode steps on each mesh write the last 3 slots of brick 3 and then
   wrap into brick 0.  The (1, 1) decode attends over the ring's filled
   prefix through B3's decode kernel (40 x 6 = 240 launches, the brick
   path 0).  Each step's logits must agree within LM_REL_TOL with top-1
   agreement at least LM_TOP1_MIN, and the first layer's k/v and kpos
   end bit-equal; ms a step and device launches (profiler, one more
   step) for both;
6. prefill — one forward() for each LM: qwen3-14b over 1 x 2048 tokens
   (40 flash launches), recurrentgemma-9b over 1 x 4096 (26 rglru_scan
   and 12 flash launches; the window bites), every flash call on the
   tensor-core prefill kernel (``flash_attention.wgmma``), xlstm-350m
   over 1 x 2048 (21 mlstm launches, all on the tensor-core kernel,
   ``mlstm.wgmma``), pixtral-12b over 1 x 2048 with 256 stub patch
   embeddings (40 flash launches), phi3.5-moe over 1 x 2048 (16),
   whisper-medium over 1500 stub frames and 448 tokens (72: 24 encoder,
   24 decoder self- and 24 cross-attention), chatglm3-6b (28), qwen3-32b
   (64) and grok-1 (4, softcapped) over 1 x 2048, every flash call of
   these on ``flash_attention.wgmma``, each compared with the same forward on
   the plain versions in the same way; then xlstm-350m's forward logits
   over 1024 tokens against a teacher-forced decode of the same tokens (the
   recurrent form), which ties the mLSTM kernel to the recurrence.  Every
   kernel call of these paths is also held against its plain version in
   f32 on the same inputs (``shadow_kernels()``); a flash_attention call
   on which that plain version is itself outside FA_TOL of the exact
   (f64) value (recurrentgemma-9b's forward, C-ref5) is held instead,
   element by element, within FA_TOL of the exact value plus the
   element's sensitivity to f32 score rounding (SENS_KAPPA), with its
   largest and mean error no more than ERR_RATIO times the plain
   version's, and its counts against both yardsticks are reported.  End
   to end, the recurrent models' logits are reported beside the distance
   between two plain runs that differ only in rounding, not gated
   (E2E_GATED);
7. train   — the LM stores freed, ten models trained at full width
   through make_train_step, one after the other (TRAIN_ARCHS), bf16
   params, the moments and the sum over the microbatches in the
   config's dtypes (f32, grok-1's bf16), global
   batches of 2048-token rows (whisper's 448) from the brick pipeline,
   with stub patch embeddings and frames where the family takes them:
   starcoder2-3b
   whole (30 layers, d_model 3072, 32 (24 real) q heads x 128 over 2 kv
   heads, d_ff 12288, vocab 49152; 6.74 GB of bf16 params; 4
   microbatches, remat "full", 8 x 2048, 3 steps), recurrentgemma-9b at 5
   of its 12 (rec, rec, attn) units (15 of 38 layers, 4.02 B params;
   remat "full" of each super-block; 8 microbatches of 1 x 2048, 3 steps)
   and xlstm-350m at one of its three super-blocks (8 of 24 layers: 7
   mLSTM + 1 sLSTM; remat "full" of the super-block and the sLSTM loop
   in chunks of 256 steps; global batch cut to 2 x 2048, one microbatch,
   1 step: ms a step is its wall less its backward checks),
   then 2 steps each of whisper-medium whole (8 x 448 tokens over 1500
   stub frames, 2 microbatches, no remat: B3's backward at head dim 64,
   non-causal over 1500 keys), pixtral-12b at 8 of 40 layers (8
   microbatches of 1 x 2048, the first 256 positions stub patch
   embeddings through the patch projection) and phi3.5-moe at 2 of 32
   layers (8 microbatches of 1 x 2048: the one-hot dispatch's backward
   and the load-balancing loss), then the two configurations with
   two-level remat, 2 steps each of microbatches of 1 x 2048: grok-1
   at 1 of 64 layers (16 x 2048 in its 16 microbatches, bf16 moments and
   a bf16 gradient sum, softcap 30 in B3's backward, sandwich norms,
   embed_scale, top-2 of 8 experts; its 8 remat segments cut to 0) and
   qwen3-32b at 4 of 64 layers in 2 remat segments (8 x 2048 in 8
   microbatches; qk-norm, GQA 64/8), then the last two dense
   configurations, 2 steps each with remat "full" in no segment:
   qwen3-14b at 8 of 40 layers (8 microbatches of 1 x 2048; its 40 q
   heads padded to 48, GQA 48/8, qk-norm) and chatglm3-6b at 18 of 28
   (4 microbatches of 2 x 2048; GQA 32/2, rotary on half the head dim).
   Every cell but xlstm-350m's is dry-run on meta before its steps;
   qwen3-14b's and chatglm3-6b's measured peak after step 1 must lie
   within PEAK_RATIO (0.93-1.05) of that prediction and their peak over
   all steps at most PEAK_MAX_GB (72 GB); the padded q heads' elements
   of wq, wo and both moments (starcoder2-3b's 8 of 32, qwen3-14b's 8 of
   48) must be exactly zero after every step (padded_nonzero).
   Launch counts by kernel and variant
   (train_launches; zeroed just before, read just after): starcoder2-3b's
   flash forward 30 x 4 x 3 x 2 = 720 (the remat recompute doubles it) on
   ``flash_attention.wgmma`` and its backward 360 on
   ``flash_attention_bwd.wgmma``; recurrentgemma-9b's 5 x 8 x 3 x 2 = 240
   flash forwards (wgmma) and 120 backwards (``flash_attention_bwd.wgmma``
   at head dim 256, none on ``.simt``), 10 x 8 x 3 x 2 = 480 RG-LRU scans
   and 240 backwards; xlstm-350m's 7 x 1 x 2 = 14 mLSTM forwards
   (``mlstm.wgmma``) and 7 backwards; whisper-medium's (24 + 2 x 24) x 2
   x 2 = 288 flash forwards and 288 backwards, pixtral-12b's 8 x 8 x 2 x 2
   = 256 and 128, phi3.5-moe's 2 x 8 x 2 x 2 = 64 and 32, grok-1's 1 x
   16 x 2 x 2 = 64 and 32, qwen3-32b's (3 x 4 - 2) x 8 x 2 = 160 (two-level
   remat: train_launches) and 64, qwen3-14b's 8 x 8 x 2 x 2 = 256 and
   128, chatglm3-6b's 18 x 4 x 2 x 2 = 288 and 144, all on the tensor
   cores; AdamW's passes (kernels/adamw) two a non-empty leaf and one
   final sum a step.  Every
   backward call of step 1
   (B3, B4, B5) is held against its plain backward in f32 (against its f64 value where that
   plain backward is off; the RG-LRU backward also bit-equal to its
   chunked order; the mLSTM's on its forward's row stats, held against
   the plain ones: shadow_backward); loss and grad norm finite at every
   step; step 1's loss and grad norm against the same step on the plain
   versions (bf16, and f32 on the same values; whisper's one row a
   microbatch, whose plain attention under autograd would take 97 GB at
   its 4), each metric gated within
   TRAIN_REL_TOL on its own where the two plain runs agree on it
   (E2E_IF_STABLE's rule), always for qwen3-14b and qwen3-32b
   (E2E_GATED); ms a step, tokens/s, the peak memory
   (reckoned in phase_train) and, for one more step, the device time
   under torch.profiler, with each family's kernels listed by name
   (TRAIN_BREAKDOWN);
   remat_check — one super-block of each recurrent family at full width
   (recurrentgemma-9b's (rec, rec, attn), xlstm-350m's 7 mLSTM + 1
   sLSTM; REMAT_CHECK), qwen3-32b at 4 layers, "full" in 2 segments,
   and qwen3-14b at 2 layers with "full" and the reference's "dots" (the
   products without batch dims kept, the rest recomputed), one
   microbatch of its training shape: step 1's gradients with each
   policy and with "none" on the same weights and batch must be equal
   bit for bit (every kernel on the path is deterministic), or, where a
   leaf differs, within TRAIN_REL_TOL of its largest gradient, the
   leaves named; "full" and "dots" launch every forward kernel twice
   (qwen3-32b's 10 times for 4);
   dryrun  — the dry run (launch/dryrun.py) of a cell's step on the meta
   device at full width, held against the card: starcoder2-3b's and
   recurrentgemma-9b's train steps (each at the end of its train phase,
   the step traced once more on the card, untimed, its batch in the dry
   run's int32 tokens) and qwen3-14b's decode step at the lm phase's
   shape (LM_BATCH rows, a ring of LM_PROMPT + LM_NEW slots, the step
   that writes the last: 40 B3 decode launches; after the brick phase,
   on the same weights).  The same OpTrace records both runs: outside
   the kernel wrappers and AdamW's stand-ins (meta's plain passes, the
   card's wrapper) the op lists (names, shapes, dtypes, in order), the
   kernel entries (kernel, variant, shape, count, flops, bytes) and the
   stand-ins' planned calls must be equal, and each kernel's calls must
   equal the profiler's launches of one step (PROFILED_CALL: the train
   phase's profiled step; one more decode step under the profiler).
   xlstm-350m's train step is dry-run on meta alone, at 512 of its 2048
   steps (DRYRUN_XL_SEQ): its B5
   calls equal the profiler's launches of the train phase's step.  Printed, with nvidia-smi's name
   and power limit, not gated: MODEL_FLOPS over (ms a step x 989
   TFLOP/s), the roofline time over the measured and its dominant term
   (analysis/roofline.py), and the predicted peak memory (arguments and
   temps) against max_memory_allocated over the traced step.  The train
   cells of whisper-medium, pixtral-12b, phi3.5-moe, grok-1, qwen3-32b,
   qwen3-14b and chatglm3-6b are dry-run on meta alone, before their
   steps (``dryrun_predict``): their predicted
   peak against the measured peak of the steps, their calls against the
   profiler's launches, and the same readings;
   trainer — Trainer with starcoder2-3b at full width and 1 of its 30
   layers (TRAINER_LAYERS), bf16, checkpoints into a temporary directory
   (removed afterwards): a calm run of 4 steps; a run of 2 steps resumed
   from its step-2 checkpoint to 4, which must end with the calm run's
   params and moments bit for bit (bf16 leaves restored, C-ref9's path);
   and a run with data node 1 killed at step 2 whose losses must equal
   the calm run's; four checkpoints in all;
8. timing  — each kernel at the shape the main path gave it, beside its
   plain version and its bound: device time (CUDA graph replay) and time
   per call (CUDA events around calls from the host); flash_attention at
   the decode shape with Sk = 24 and at the 2048 prefill (qwen3-14b), at
   recurrentgemma-9b's decode and its 4096 prefill under the window, at
   whisper-medium's encoder (2, 1500, 1500) and cross-attention at decode
   (2, 1 over 1500) and in the forward (1, 448 over 1500), all three
   non-causal (their bound counts every key), with
   scaled_dot_product_attention (enable_gqa; an explicit mask under the
   window) as the library call; rglru_scan and mlstm with no library call
   (no PyTorch call computes either function); AdamW's two passes
   (kernels/adamw) at chatglm3-6b's largest leaf (layers/mlp/w_gate at
   18 layers, 1.01 B elements) and over its train cell's whole tree (4.20
   B parameters: bf16 p, f32 g, m and v, 58.8 GB), a step's norm, scalars
   and update timed by CUDA events beside the plain version (the eager
   slices and the f64 norm), the leaf's step bit for bit the plain one's
   (bound: 28 bytes a parameter at 3.35 TB/s; no library call: torch's
   fused AdamW decays before the step and takes no clip); every row with
   its share of
   the bound, the event filter's also with the sector bound of the store's
   strided pt, beside the launch floor (a one-element fill); and the
   backward at the training shape (bound: 10 flops a valid (query, key,
   head, head-dim), ~0.174 ms) beside its plain version, SDPA's backward
   (the library call, timed only) and the forward at the same shape; the
   backward at recurrentgemma-9b's training microbatch (1, 2048^2, 16/1
   heads of 256, bf16, its 2048 window; bound ~0.0869 ms) on the tensor
   cores beside the same yardsticks, and the CUDA-core variant on f32
   operands of that shape (bound at 67 TFLOP/s); the backward at
   grok-1's training microbatch (1, 2048^2, 48/8 heads of 128, softcap
   30, q scaled by 8) on the tensor cores beside its plain backward and
   the library call, the backward of torch.compile(flex_attention) with
   a tanh score_mod, a causal block mask and enable_gqa (timed and held
   against the plain backward, only), and the same call at qwen3-14b's
   training microbatch (the same shape and q scaling) without the cap,
   SDPA's backward its library call; the B4 backward at
   (1, 2048, 4096) f32 (bound: 20 bytes an element at 3.35 TB/s) and the
   B5 backward at (2, 2048, 4, 512) bf16 (bound: 10 flops a valid (query,
   key, head, head-dim) at 989 TFLOP/s, ~0.087 ms), each beside its plain
   backward, with no library call (no PyTorch call computes either); and
   the mLSTM forward writing its row stats, beside the row without;
9. the kernels line (flash_attention's, rglru_scan's and mlstm's
   launches summed over every LM path, the brick phase's (1, 1) decode
   and the train phase; the
   backwards' from the train phase, flash's variants listed under
   ``variants``: the tensor-core one at head dim 128 and at 256, each
   with its train launches at that head dim and its instances' registers
   and spills, the one at head dim 128 with grok-1's softcap and its
   launches, the same without the cap at qwen3-14b's shape and its
   launches, and the CUDA-core one; its launches also by trained model
   and, on the tensor cores, by head dim without a cap, whisper-medium's
   at 64 included), nvidia-smi's line, and the result line.

Any failed check raises, so the script exits non-zero and prints no
result line.  It needs one CUDA card and the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# the H100's rates and the LM kernels' work counts (their bound column)
from repro_torch.analysis import roofline  # noqa: E402

HBM_BYTES_PER_S = roofline.HBM_BW          # H100 SXM memory rate
FP32_FLOPS_PER_S = roofline.PEAK_FLOPS_FP32  # fp32 outside the tensor cores
BF16_FLOPS_PER_S = roofline.PEAK_FLOPS      # bf16 tensor cores, dense
BAND_RTOL = 1e-5
CHUNK_SHAPE = (64, 4096, 63)   # the query path's chunk: chunk_events x T x V
RAGGED_SHAPE = (37, 1000, 63)
BRICK_SHAPE = (256, 4096, 63)  # one brick: what the lockstep steps are given
DEVICE = torch.device("cuda")
N_SCALARS = 64
TIMING_ROTATION = 16           # distinct inputs cycled so L2 stays cold
TIMING_ITERS = 48

# flash attention: (rtol, atol) of |kernel - plain| <= atol + rtol |plain|
FA_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-4, 2e-4)}
# RG-LRU scan: |kernel - plain| <= atol + rtol |plain| (f32; the kernel
# runs the recurrence in order, the plain version as a doubling scan)
SCAN_TOL = (1e-5, 1e-5)
# mLSTM: against the plain version evaluated in f32 on the same values (the
# kernel's and the Pallas kernel's arithmetic), as FA_TOL for a bf16
# output and as tests/test_kernels.py (5e-4) in f32
MLSTM_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (5e-4, 5e-4)}
LM_ARCH = "qwen3-14b"
RG_ARCH = "recurrentgemma-9b"
XL_ARCH = "xlstm-350m"
PX_ARCH = "pixtral-12b"
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
WH_ARCH = "whisper-medium"
GLM_ARCH = "chatglm3-6b"
Q32_ARCH = "qwen3-32b"
GROK_ARCH = "grok-1-314b"
# layers on the card where the published depth does not fit: phi3.5-moe's
# 32 layers are 83.7 GB in bf16, 16 at full width ~42 GB; one grok-1 layer
# holds 8 x 3 x 6144 x 32768 bf16 = 9.7 GB of expert weights, 4 of its 64
# layers with the 1.6 B-parameter embedding and unembedding ~42 GB
LM_LAYERS = {MOE_ARCH: 16, GROK_ARCH: 4}
LM_BATCH, LM_PROMPT, LM_NEW = 2, 8, 16
PREFILL_LEN = 2048
# forward lengths: recurrentgemma's 4096 passes its 2048 attention window;
# whisper's decoder reads 448 tokens beside its 1500 encoder frames
FORWARD_LEN = {LM_ARCH: PREFILL_LEN, RG_ARCH: 4096, XL_ARCH: 2048,
               PX_ARCH: PREFILL_LEN, MOE_ARCH: PREFILL_LEN, WH_ARCH: 448,
               GLM_ARCH: PREFILL_LEN, Q32_ARCH: PREFILL_LEN,
               GROK_ARCH: PREFILL_LEN}
# the served models after the first six, one on the card at a time:
# chatglm3-6b whole (G = 16 at head dim 128, the "half" rope), qwen3-32b
# whole (65.5 GB, the largest that fits), grok-1 at LM_LAYERS (softcap 30,
# sandwich norms, 8 experts of d_ff 32768)
LM_MORE = (GLM_ARCH, Q32_ARCH, GROK_ARCH)
# xlstm-350m's forward against its own decode: the decode runs token by
# token (40-65 ms a step, host-bound), so 512 tokens keep it near 30 s
TIE_LEN = 512
# models whose logits through the kernels are held end to end against the
# plain versions (LM_REL_TOL, LM_TOP1_MIN).  Not the recurrent models: with
# the reference's initialisation their full-width paths are chaotic, so
# two plain runs that differ only in rounding (bf16 against f32 plain
# versions) already disagree far beyond those limits.  recurrentgemma-9b
# is MQA and draws its key projection at 1/sqrt(1) (C-ref5): attention
# scores spread over ~1e3, every softmax is an argmax, and a flipped
# near-tie is carried on by the next layers and the recurrence.
# xlstm-350m draws the sLSTM's recurrent weights at 1/sqrt(hd), not 0.01
# (C-ref6), over 2048 steps.  For them every kernel call on the path is
# held against its plain version in f32 on the same inputs
# (shadow_kernels), and the end-to-end numbers are reported beside that
# baseline.
E2E_GATED = (LM_ARCH, Q32_ARCH)
# models gated end to end when their own two plain runs (bf16 and f32
# plain versions) agree within LM_REL_TOL and LM_TOP1_MIN on the path;
# otherwise reported beside that baseline, as the recurrent models are
# (those without qk-norm, whose scores C-ref5 spreads)
E2E_IF_STABLE = (PX_ARCH, MOE_ARCH, WH_ARCH, GLM_ARCH, GROK_ARCH)
LM_REL_TOL = 5e-2     # max |logit difference| / spread of the plain logits
LM_TOP1_MIN = 0.8     # share of positions whose argmax agrees
# flash backward: max |kernel - plain| <= BWD_TOL * max |plain| for each of
# dq, dk, dv, the plain backward (flash_attention_bwd_ref) in f32 on the
# same values; where that plain backward is itself outside BWD_TOL of its
# f64 evaluation (an ill-conditioned call), against the f64 value instead
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# the mLSTM's tensor-core backward against its arithmetic in plain
# PyTorch (mlstm_bwd_split_ref) on the same values and stats: max |kernel
# - twin| <= TWIN_TOL * max |twin| for dq, dk, dv (bf16 outputs: one unit
# in the last place of the largest is up to 2^-7 = 7.8e-3 of it; the f32
# sums' other order can move a rounding that far), d log i, d log f (f32
# sums in another order, on F and its exp2 terms rounded at |F| ~ 600).
# Readings on an H100 80GB HBM3 at 700 W: dq, dk 2.0e-3, dv 3.4e-3, d log i
# 4.4e-5, d log f 6.8e-5
TWIN_TOL = (8e-3, 8e-3, 8e-3, 2e-4, 2e-4)
BWD_ROWS = 256        # query rows a pass of the plain backward (memory)
# the lse the forward writes for the backward against the plain lse in f32
# on the same values (rtol, atol): the scores' sums in another order
LSE_TOL = (1e-5, 1e-4)
# training: starcoder2-3b whole at full width, its 4 microbatches
TRAIN_ARCH = "starcoder2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 3
GROK_CAP = 30.0       # grok-1's attn_logit_softcap
# the capped backward at grok-1's shape takes q scaled by 8 (exact in
# bf16): q . k / sqrt(128) then has a spread of 8 and reaches ~45 over a
# call, where tanh(s / 30) bends (1 - tanh^2 down to ~0.2); at a spread
# of 1 the cap moves no gradient by BWD_TOL, and a backward without it
# would pass
GROK_Q_GAIN = 8.0
TRAIN_LR = 3e-4
# the models trained at full width, each with its cuts: recurrentgemma-9b
# at 5 of its 12 (rec, rec, attn) units (15 of 38 layers: 4.02 B params,
# 64.3 GB of training state at 16 bytes a param; with remat "full" each
# super-block keeps its input, so the logits' f32 copies (~2.1 GB each)
# and one super-block's recompute come on top: ~70-74 GB) over its 8
# microbatches of 1 x 2048; xlstm-350m at one of its three super-blocks
# (8 of 24 layers; whole until chip_smoke's run passed 1,000 s with the
# last two dense cells), its global batch cut from 8 to 2 rows (one
# microbatch of 2 x 2048, the shape its 4 microbatches of 8 give) and 1
# step: the sLSTM's Python loop over 2048 steps under autograd takes
# seconds a microbatch, and remat runs it three times.
# The moe, vlm and audio families, 2 steps each at a global batch of 8 in
# their own microbatches: whisper-medium whole (0.76 B params; 8 rows of
# 448 tokens over 1500 stub frames, 2 microbatches; no remat, as the
# reference's encoder-decoder), pixtral-12b at 8 of its 40 layers (3.55 B
# params, 56.8 GB of state; 2048 tokens a row, the first 256 the stub
# patch embeddings, 8 microbatches) and phi3.5-moe at 2 of its 32 layers
# (2.87 B params, 45.9 GB; 2048 tokens, 8 microbatches).  whisper's step
# 1 on the plain versions runs one row a microbatch ("plain_microbatches":
# the same mean over rows, summed in another order): the plain attention
# under autograd keeps f32 scores of (rows, 1500, 16, 1024) a key chunk in
# each of 24 encoder layers, 97 GB at the kernel path's 4 rows (the dry
# run on meta with the plain versions swapped in)
# The two configurations that train with two-level remat
# (``remat_segments``), 2 steps each in microbatches of 1 x 2048: grok-1
# at 1 of its 64 layers (6.53 B params: 4.83 B of experts, 1.61 B of
# embedding and untied head; bf16 moments and a bf16 gradient sum as its
# config gives them, 10 bytes a param, 65.3 GB of state; softcap 30 in
# B3's forward and backward), a global batch of 16 x 2048 in its own 16
# microbatches (the state and a microbatch's activations do not depend
# on their number), its 8 remat segments cut to 0 (one layer does not
# split into 8); 8 x 2048 in 8 microbatches for qwen3-32b at 4 of its 64
# layers (3.51 B params, f32 moments, 56.1 GB of state) in 2 segments of
# 2 layers, its 8 cut as the registry's reduced config cuts them
# (min(8, 2)): each layer's forward runs three times but the last of a
# segment's, twice (train_launches).  The last two dense configurations,
# 2 steps each at a global batch of 8 x 2048 in their own microbatches,
# remat "full" in no segment (their configs' 0), f32 moments and sum,
# cut to the deepest that keeps grok-1's headroom by the dry run on meta
# (a layer more predicts 72.8 and 74.0 GB): qwen3-14b at 8 of its 40
# layers (4.28 B params, 68.5 GB of state at 16 bytes a param, the dry
# run's peak 67.57 GB: a microbatch's bf16 gradients live a layer at a
# time; 8 microbatches of 1 x 2048; its 40 q heads padded to 48, whose
# zero weights and moments must stay zero, ``padded_nonzero``) and
# chatglm3-6b at 18 of its 28 (4.20 B params, 67.3 GB, the dry run's
# 67.36 GB; 4 microbatches of 2 x 2048; rotary on half the head dim)
TRAIN_ARCHS = {TRAIN_ARCH: {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS},
               RG_ARCH: {"batch": 8, "steps": 3, "layers": 15},
               XL_ARCH: {"batch": 2, "steps": 1, "microbatches": 1,
                         "layers": 8},
               WH_ARCH: {"batch": 8, "steps": 2,
                         "seq": FORWARD_LEN[WH_ARCH],
                         "plain_microbatches": 8},
               PX_ARCH: {"batch": 8, "steps": 2, "layers": 8},
               MOE_ARCH: {"batch": 8, "steps": 2, "layers": 2},
               GROK_ARCH: {"batch": 16, "steps": 2, "layers": 1,
                           "remat_segments": 0},
               Q32_ARCH: {"batch": 8, "steps": 2, "layers": 4,
                          "remat_segments": 2},
               LM_ARCH: {"batch": 8, "steps": 2, "layers": 8},
               GLM_ARCH: {"batch": 8, "steps": 2, "layers": 18}}
# the train cells whose peak is held against the dry run's prediction:
# after step 1 within PEAK_RATIO of it, over all steps at most PEAK_MAX_GB
PEAK_GATED = (LM_ARCH, GLM_ARCH)
PEAK_RATIO, PEAK_MAX_GB = (0.93, 1.05), 72.0
# the train cells the dryrun phase also traces once more on the card (a
# step under the recorder, ~10-15 s a cell); every cell but xlstm-350m's
# is dry-run on meta before its steps, its predicted peak beside the
# measured one
DRYRUN_CARD = (TRAIN_ARCH, RG_ARCH)
# the remat check: one super-block of each recurrent family at full width
# (recurrentgemma-9b's (rec, rec, attn), xlstm-350m's 7 mLSTM + 1 sLSTM),
# one microbatch of its training shape, step 1's gradients with remat
# "full" against "none" on the same weights and batch; qwen3-32b at its
# train cell's 4 layers with two-level remat ("full" in 2 segments)
# against "none" in no segment; qwen3-14b at 2 layers with "full" and the
# reference's "dots" (the products without batch dims kept, the rest,
# B3's forward among it, recomputed) against "none"
REMAT_CHECK = {RG_ARCH: {"layers": 3, "batch": 1},
               XL_ARCH: {"layers": 8, "batch": 2},
               Q32_ARCH: {"layers": 4, "batch": 1, "remat_segments": 2},
               LM_ARCH: {"layers": 2, "batch": 1,
                         "policies": ("full", "dots")}}
# the brick phase: qwen3-14b decoding through the grid-brick KV cache on a
# mesh of (1, 4) emulated on the card (tensor_size 4 cuts a cache of 8192
# slots, unwindowed, into 4 bricks: brick_active holds), against the same
# decode on the (1, 1) mesh (the ring's filled prefix through B3's decode
# kernel), gated as LM_ARCH is: LM_REL_TOL and LM_TOP1_MIN.  BRICK_FILL
# prompt tokens fill the ring (every brick live), and the BRICK_STEPS
# decode steps write the last slots of brick 3, then wrap into brick 0
BRICK_MESH, BRICK_CACHE = (1, 4), 8192
BRICK_STEPS = 6
BRICK_FILL = BRICK_CACHE - BRICK_STEPS // 2
# the trainer's restart and failure scenarios at full width, 1 of 30
# layers; only the restart run checkpoints before its last step
TRAINER_LAYERS, TRAINER_STEPS = 1, 4
# step-1 loss and grad norm of the kernel path against the plain path in
# f32, gated where the two plain runs (bf16, f32) agree within it
TRAIN_REL_TOL = 2e-2
# the dryrun phase: the device kernel whose launches count one call of a
# dry-run kernel entry ("kernel.variant", else "kernel") in a profile
PROFILED_CALL = {"flash_attention.wgmma": "flash_wgmma_kernel",
                 "flash_attention.decode": "flash_decode_kernel",
                 "flash_attention_bwd": "fa_bwd_delta_kernel",
                 "rglru_scan": "rglru_chunked_kernel<0>",
                 "rglru_scan_bwd": "rglru_chunked_kernel<1>",
                 "mlstm.wgmma": "mlstm_gates_kernel",
                 "mlstm_bwd": "mlstm_bwd_cumsum_kernel"}
# xlstm-350m's train step is dry-run on meta alone, cut to 512 of its
# 2048 steps at the train phase's rows and depth: the sLSTM loops over
# every step in Python, and an op on meta costs ~0.13 ms of host time on
# the H100's host (one super-block: 228k ops, 30 s at 512 steps; ~1 M
# ops, ~130 s at 2048).  The B5 calls do not depend on the steps: 14
# and 7, the step's
DRYRUN_XL_SEQ = 512


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# kernel inputs, band rule, timing
# --------------------------------------------------------------------- #
def make_operands(gen, n, t, v, k, *, cap: bool):
    """Event operands shaped like the store's (exponential pt, ragged
    n_tracks) plus K thresholds; caps near the typical sum(pt)."""
    dev = DEVICE
    scalars = torch.abs(torch.randn((n, N_SCALARS), generator=gen,
                                    device=dev) * 50.0)
    tracks = torch.randn((n, t, v), generator=gen, device=dev)
    pt = torch.empty((n, t), device=dev).exponential_(generator=gen) * 10.0
    tracks[:, :, 0] = pt
    n_tracks = torch.randint(1, t + 1, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    u = torch.rand((4, k), generator=gen, device=dev)
    thresholds = torch.stack([
        20.0 + 40.0 * u[0],                        # scalar threshold A
        5.0 + 20.0 * u[1],                         # pt threshold B
        torch.floor(1.0 + 4.0 * u[2]),             # min count C
        (10.0 * t / 2) * (0.5 + u[3]) if cap       # sum cap D (~median)
        else torch.full((k,), -1.0, device=dev),
    ]).contiguous()
    var_idx = torch.randint(0, 8, (k,), generator=gen, device=dev,
                            dtype=torch.int32)
    return scalars, tracks, n_tracks, thresholds, var_idx


def band_events(tracks, n_tracks, thresholds, calib_iters):
    """Events whose outcome rides on rounding: a valid calibrated pt or
    the sum(pt) within BAND_RTOL of one of its thresholds."""
    from repro_torch.kernels.event_filter.ref import calibrate_tracks
    pt = calibrate_tracks(tracks, calib_iters)[..., 0]
    t = torch.arange(pt.shape[1], device=pt.device)
    valid = t[None, :] < n_tracks[:, None]
    b = thresholds[1]
    near = (pt[..., None] - b).abs() <= BAND_RTOL * b.abs()
    band = (near & valid[..., None]).any(dim=1).any(dim=1)
    d = thresholds[3]
    ssum = torch.sum(torch.where(valid, pt, 0.0), dim=-1)
    near_sum = ((ssum[:, None] - d).abs() <= BAND_RTOL * d.abs()) & (d > 0)
    return band | near_sum.any(dim=1)


def compare(mask, var, mask_p, var_p, tracks, n_tracks, thresholds, calib,
            cap, name):
    """Hold one kernel output against its plain version; returns (band
    events allowed, max |difference|)."""
    torch.cuda.synchronize()
    if not torch.equal(var, var_p):
        raise AssertionError(f"{name}: var differs from the plain version")
    diff = (mask != mask_p)
    if diff.dim() == 1:
        diff = diff[:, None]
    bad_rows = diff.any(dim=1)
    n_band = 0
    if calib == 0 and not cap:
        if bool(bad_rows.any()):
            raise AssertionError(
                f"{name}: masks differ at calib 0 without a cap "
                f"({int(bad_rows.sum())} events)")
    else:
        thr = thresholds if thresholds.dim() == 2 else thresholds[:, None]
        band = band_events(tracks, n_tracks, thr, calib)
        if bool((bad_rows & ~band).any()):
            raise AssertionError(
                f"{name}: {int((bad_rows & ~band).sum())} events differ "
                f"outside the rtol {BAND_RTOL} band")
        n_band = int(band.sum())
    err = float((mask - mask_p).abs().max())
    return n_band, err


def call_time_ms(calls, iters=TIMING_ITERS) -> float:
    """Mean ms per call as a caller sees it, host work between launches
    included: ``iters`` calls cycling through ``calls`` (closures over
    distinct inputs, so each finds its inputs cold in L2), timed with CUDA
    events."""
    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_time_ms(calls, iters=TIMING_ITERS) -> float:
    """Mean device ms per call: the same ``iters`` calls captured into one
    CUDA graph and replayed, so no host time sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls[:2]:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_pair(kern, plain, iters=TIMING_ITERS):
    """Device ms (graph replay) and ms per call of a kernel and its plain
    version, each the mean of two runs taken plain, kernel, kernel,
    plain, of ``iters`` calls each."""
    out = {}
    for key, timer in (("ms", device_time_ms), ("call_ms", call_time_ms)):
        p1, k1, k2, p2 = (timer(plain, iters), timer(kern, iters),
                          timer(kern, iters), timer(plain, iters))
        out[key] = (k1 + k2) / 2
        out["plain_" + key] = (p1 + p2) / 2
    return out


def with_share(row):
    """A timing row with the share of its bound that the kernel reaches
    (bound over device time)."""
    return {**row, "share_of_bound": row["bound_ms"] / row["ms"]}


def launch_floor_ms() -> float:
    """Device ms of the least kernel, a one-element fill, timed as the
    kernels are (graph replay): what a launch costs before any work."""
    one = torch.zeros(1, device=DEVICE)
    return device_time_ms([one.zero_])


def sector_bound_ms(n_tracks, t) -> float:
    """Least time to read the valid tracks' pt from the store's (N, T, V)
    layout, where each 4-byte pt costs a 32-byte sector, at the HBM rate."""
    valid = int(torch.clamp(n_tracks.long(), 0, t).sum())
    return 32 * valid / HBM_BYTES_PER_S * 1e3


def bound_ms(scalars, n_tracks, thresholds, var_idx, calib_iters, t):
    """Least time for the function's work on these inputs: the bytes it
    must move (valid tracks' pt, n_tracks, scalars, thresholds, var_idx
    in; mask and var out, each once) at the HBM rate, against its flops
    (per valid track: K compares, one add, ~10 per calibration round) at
    the fp32 rate; the larger of the two, and which one it is."""
    n = scalars.shape[0]
    k = thresholds.numel() // 4
    valid = int(torch.clamp(n_tracks.long(), 0, t).sum())
    nbytes = 4 * (valid + n + scalars.numel() + 4 * k + k + n * k + n)
    flops = valid * (k + 1 + 10 * calib_iters)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / FP32_FLOPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def phase_kernels(gen):
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    from repro_torch.kernels.event_filter.ref import (event_filter_batch_ref,
                                                      event_filter_ref)

    def plain_single(scalars, tracks, n_tracks, thr, var_idx, calib):
        a, b, c, d = thr.tolist()
        return event_filter_ref(scalars, tracks, n_tracks,
                                var_idx=int(var_idx[0]), scalar_thresh=a,
                                pt_thresh=b, min_count=c, sum_cap=d,
                                calib_iters=calib)

    rows = []
    for shape in (CHUNK_SHAPE, RAGGED_SHAPE):
        for k in (1, 4, 17):
            for calib in (0, 4):
                for cap in (False, True):
                    ops = make_operands(gen, *shape, k, cap=cap)
                    scalars, tracks, n_tracks, thr, var_idx = ops
                    mask_p, var_p = event_filter_batch_ref(
                        scalars, tracks, n_tracks, thr, var_idx=var_idx,
                        calib_iters=calib)
                    # every block size the launch-shape sweep may pick
                    for threads in ef_kernel.LAUNCH_THREADS:
                        mask, var = ef_kernel.event_filter_batch_cuda(
                            *ops, calib_iters=calib, threads=threads)
                        torch.cuda.synchronize()
                        name = f"event_filter_batch ({threads} threads)"
                        nb, err = compare(mask, var, mask_p, var_p, tracks,
                                          n_tracks, thr, calib, cap, name)
                        row = {"kernel": "event_filter_batch",
                               "shape": list(shape), "k": k,
                               "calib": calib, "cap": cap,
                               "threads": threads, "band_events": nb,
                               "max_abs_err": err}
                        rows.append(row)
                    if k == 1:
                        t1 = thr[:, 0].contiguous()
                        m1, v1 = ef_kernel.event_filter_cuda(
                            scalars, tracks, n_tracks, t1, var_idx,
                            calib_iters=calib)
                        torch.cuda.synchronize()
                        m1p, v1p = plain_single(scalars, tracks, n_tracks,
                                                t1, var_idx, calib)
                        nb1, err1 = compare(m1, v1, m1p, v1p, tracks,
                                            n_tracks, t1, calib, cap,
                                            "event_filter")
                        rows.append({**row, "kernel": "event_filter",
                                     "threads": ef_kernel.DEFAULT_THREADS,
                                     "band_events": nb1,
                                     "max_abs_err": err1})
    return rows


def time_kernel(name, gen, shape, k, calib_iters):
    """Times of one kernel and its plain version at one main-path shape,
    over TIMING_ROTATION distinct operand sets: device ms from graph
    replay (``ms``, ``plain_ms``) and ms per call with host work
    (``call_ms``, ``plain_call_ms``), each the mean of two runs taken
    plain, kernel, kernel, plain; with the bound and the largest
    difference from the plain version."""
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    from repro_torch.kernels.event_filter.ref import (event_filter_batch_ref,
                                                      event_filter_ref)
    sets = [make_operands(gen, *shape, k, cap=False)
            for _ in range(TIMING_ROTATION)]
    kern, plain = [], []
    for s, tr, nt, th, vi in sets:
        if name == "event_filter":
            t1 = th[:, 0].contiguous()
            a, b, c, d = t1.tolist()
            kern.append(functools.partial(
                ef_kernel.event_filter_cuda, s, tr, nt, t1, vi,
                calib_iters=calib_iters))
            plain.append(functools.partial(
                event_filter_ref, s, tr, nt, var_idx=int(vi[0]),
                scalar_thresh=a, pt_thresh=b, min_count=c, sum_cap=d,
                calib_iters=calib_iters))
        else:
            kern.append(functools.partial(
                ef_kernel.event_filter_batch_cuda, s, tr, nt, th, vi,
                calib_iters=calib_iters))
            plain.append(functools.partial(
                event_filter_batch_ref, s, tr, nt, th, var_idx=vi,
                calib_iters=calib_iters))
    err = 0.0
    for kc, pc in zip(kern[:4], plain[:4]):
        (m, v), (mp, vp) = kc(), pc()
        torch.cuda.synchronize()
        err = max(err, float((m - mp).abs().max()),
                  float((v - vp).abs().max()))
    bms = [bound_ms(s, nt, th, vi, calib_iters, shape[1])
           for s, tr, nt, th, vi in sets]
    sectors = [sector_bound_ms(nt, shape[1]) for _, _, nt, _, _ in sets]
    return with_share({**time_pair(kern, plain),
                       "bound_ms": float(np.mean([x for x, _ in bms])),
                       "bound_by": bms[0][1],
                       "sector_bound_ms": float(np.mean(sectors)),
                       "max_abs_err": err})


# --------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------- #
# whisper-medium's new shapes, with the device kernel and the number of
# key splits the plan must give each on an H100
WHISPER_FA_CASES = [
    ("whisper encoder", 2, 1500, 1500, 16, 16, 64, torch.bfloat16,
     {"causal": False}),
    ("whisper cross decode", 2, 1, 1500, 16, 16, 64, torch.bfloat16,
     {"causal": False}),
    ("whisper cross forward", 1, 448, 1500, 16, 16, 64, torch.bfloat16,
     {"causal": False}),
]
WHISPER_FA_PLANS = {"whisper encoder": ("wgmma", 1),
                    "whisper cross decode": ("decode", 4),
                    "whisper cross forward": ("wgmma", 1)}

# (case, B, Sq, Sk, H, K, D, dtype, flags): qwen3-14b's and
# recurrentgemma-9b's decode steps and prefill at full width, then the
# small cases
FA_CASES = [
    *[("decode", 2, 1, sk, 48, 8, 128, torch.bfloat16, {})
      for sk in (1, 9, 24, 256)],
    ("prefill", 1, PREFILL_LEN, PREFILL_LEN, 48, 8, 128, torch.bfloat16, {}),
    # recurrentgemma-9b: MQA, 16 q heads over 1 kv head of 256, window 2048
    *[("rg decode", 2, 1, sk, 16, 1, 256, torch.bfloat16, {})
      for sk in (1, 24, 256)],
    ("rg prefill", 1, 4096, 4096, 16, 1, 256, torch.bfloat16,
     {"window": 2048}),
    # the tensor-core kernels off the models' own shapes: a prefill whose
    # Sq is no multiple of 64, 64 <= Sq < Sk, head dim 64, window with
    # softcap, non-causal, and decode over long rings (split K and merge)
    ("tc ragged", 1, 300, 300, 48, 8, 128, torch.bfloat16, {}),
    ("tc sq<sk", 2, 100, 300, 8, 2, 128, torch.bfloat16, {}),
    ("tc d64", 1, 200, 200, 8, 2, 64, torch.bfloat16, {}),
    ("tc window+cap", 1, 260, 260, 8, 4, 64, torch.bfloat16,
     {"window": 70, "logit_cap": 30.0}),
    ("tc not causal", 1, 150, 150, 4, 1, 128, torch.bfloat16,
     {"causal": False, "window": 33}),
    ("rg long ring", 2, 1, 2048, 16, 1, 256, torch.bfloat16,
     {"window": 2048}),
    ("long ring", 2, 1, 4096, 48, 8, 128, torch.bfloat16, {}),
    # whisper-medium (16 heads of 64, full MHA): the non-causal 1500-frame
    # encoder, cross-attention at decode (1 query over 1500 keys: 24 key
    # tiles, the last ragged, in 4 splits) and in the decoder's forward
    # (448 queries over 1500 keys)
    *WHISPER_FA_CASES,
    ("decode 2 rows", 1, 2, 300, 12, 2, 64, torch.bfloat16,
     {"logit_cap": 20.0}),
    ("d256 ragged", 1, 300, 300, 4, 2, 256, torch.float32, {"window": 200}),
    ("sq<sk", 2, 37, 100, 4, 2, 16, torch.bfloat16, {}),
    ("sq<sk", 2, 37, 100, 4, 2, 16, torch.float32, {}),
    ("window", 1, 96, 96, 8, 2, 64, torch.bfloat16, {"window": 40}),
    ("window", 1, 96, 96, 8, 2, 64, torch.float32, {"window": 40}),
    ("softcap", 2, 64, 64, 4, 4, 32, torch.float32, {"logit_cap": 30.0}),
    ("ragged", 1, 300, 300, 48, 8, 128, torch.float32, {}),
    ("reduced", 2, 24, 24, 16, 2, 16, torch.float32, {}),
    ("not causal", 1, 50, 50, 4, 1, 16, torch.float32,
     {"causal": False, "window": 9}),
]


def fa_operands(gen, b, sq, sk, h, kh, d, dtype):
    return tuple(torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                 for shape in ((b, sq, h, d), (b, sk, kh, d),
                               (b, sk, kh, d)))


def fa_check(out, want, dtype, name) -> float:
    """Max |kernel - plain|; raises when an element lies outside
    atol + rtol |plain| (FA_TOL) or is not finite."""
    rtol, atol = FA_TOL[dtype]
    o, w = out.float(), want.float()
    if o.shape != w.shape or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"flash_attention {name}: shape {o.shape} or "
                             "non-finite output")
    err = (o - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"flash_attention {name} ({dtype}): {int(bad.sum())} elements "
            f"outside rtol {rtol} atol {atol}, max err {float(err.max())}")
    return float(err.max())


def phase_flash_kernels(gen):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rows = []
    for name, b, sq, sk, h, kh, d, dtype, kw in FA_CASES:
        q, k, v = fa_operands(gen, b, sq, sk, h, kh, d, dtype)
        pl = fa_kernel.plan(b, sq, sk, h, kh, d, dtype,
                            kw.get("causal", True), kw.get("window"))
        out = fa_kernel.flash_attention_cuda(q, k, v, **kw)
        again = fa_kernel.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"flash_attention {name}: two runs differ")
        err = fa_check(out, flash_attention_ref(q, k, v, **kw), dtype, name)
        row = {"case": name, "shape": [b, sq, sk, h, kh, d],
               "dtype": str(dtype).split(".")[-1], "flags": kw,
               "variant": pl.variant, "splits": len(pl.splits),
               "max_abs_err": err}
        if name in WHISPER_FA_PLANS and \
                (pl.variant, len(pl.splits)) != WHISPER_FA_PLANS[name]:
            raise AssertionError(f"flash_attention {name}: plan "
                                 f"{pl.variant} with {len(pl.splits)} "
                                 f"splits, expected {WHISPER_FA_PLANS[name]}")
        if dtype != torch.float32:
            # and against the plain version in f32 on the same values (the
            # kernels' arithmetic: q * scale never rounded), as the LM
            # paths' per-call check holds them
            row["max_abs_err_vs_f32"] = fa_check(
                out, flash_attention_ref(q.float(), k.float(), v.float(),
                                         **kw), dtype, name + " vs f32")
        rows.append(row)
    return rows


def time_flash(gen, b, sq, sk, h, kh, d, window=None, causal=True):
    """flash_attention at one main-path shape (bf16) over TIMING_ROTATION
    operand sets: kernel and plain version as in ``time_kernel``, and the
    library call, ``scaled_dot_product_attention(enable_gqa=True)``
    (causal at prefill, or an explicit boolean mask under a window; at
    decode, and in a call that is not causal, every key is valid, and
    SDPA would align a causal mask top-left), timed only."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sets = [fa_operands(gen, b, sq, sk, h, kh, d, torch.bfloat16)
            for _ in range(TIMING_ROTATION)]
    kern = [functools.partial(fa_kernel.flash_attention_cuda, *qkv,
                              window=window, causal=causal) for qkv in sets]
    plain = [functools.partial(flash_attention_ref, *qkv, window=window,
                               causal=causal) for qkv in sets]
    lib_kw = {"is_causal": causal and sq > 1}
    if window is not None:
        q_pos = torch.arange(sq, device=DEVICE)[:, None] + sk - sq
        k_pos = torch.arange(sk, device=DEVICE)[None, :]
        lib_kw = {"attn_mask": (k_pos <= q_pos) & (k_pos > q_pos - window)}
    lib = [functools.partial(sdpa, *(x.transpose(1, 2) for x in qkv),
                             enable_gqa=True, **lib_kw) for qkv in sets]
    err = lib_err = 0.0
    for kc, pc, lc in zip(kern[:4], plain[:4], lib[:4]):
        out, want, lo = kc(), pc(), lc().transpose(1, 2)
        err = max(err, fa_check(out, want, torch.bfloat16, "timing"))
        lib_err = max(lib_err, float((lo.float() - want.float()).abs()
                                     .max()))
    bound, by = roofline.bound_ms(roofline.flash_attention_work(
        b, sq, sk, h, kh, d, "bfloat16", window, causal))
    pl = fa_kernel.plan(b, sq, sk, h, kh, d, torch.bfloat16, causal, window)
    return {"variant": pl.variant, "splits": len(pl.splits),
            **time_pair(kern, plain), "library_ms": device_time_ms(lib),
            "library_max_abs_err": lib_err, "bound_ms": bound,
            "bound_by": by, "max_abs_err": err}


# --------------------------------------------------------------------- #
# flash attention backward
# --------------------------------------------------------------------- #
# (case, B, Sq, Sk, H, K, D, flags), each in bf16 and f32: causal and not,
# Sq < Sk, a window, a softcap, ragged tiles, GQA 16:1 (starcoder2-3b's
# 32 padded q heads over 2), 5:1 and 6:1, head dims 64 / 128 / 256, and
# rows whose window masks every key; then f32 at head dim 16 and 32.  The
# bf16 cases take the tensor-core variant, the f32 ones the CUDA-core one
# (backward.plan; each row names its variant)
BWD_SMALL = [
    ("causal", 2, 96, 96, 4, 2, 64, {}),
    ("not causal", 1, 70, 70, 4, 2, 128, {"causal": False}),
    ("sq<sk", 2, 37, 100, 4, 2, 128, {}),
    ("window", 1, 130, 130, 4, 1, 128, {"window": 40}),
    ("softcap", 1, 64, 64, 2, 2, 64, {"logit_cap": 5.0}),
    ("ragged", 1, 300, 300, 8, 2, 128, {}),
    ("gqa 16:1", 1, 200, 200, 32, 2, 128, {}),
    ("gqa 5:1", 1, 130, 200, 10, 2, 128, {"window": 90}),
    ("gqa 6:1 d256", 1, 100, 100, 6, 1, 256, {"window": 33}),
    ("masked rows", 1, 5, 3, 2, 1, 64, {"causal": False, "window": 1}),
]
BWD_CASES = [
    *[(name, *shape, dt, kw) for name, *shape, kw in BWD_SMALL
      for dt in (torch.bfloat16, torch.float32)],
    ("d16", 2, 40, 40, 4, 2, 16, torch.float32, {}),
    ("d32 softcap", 1, 45, 45, 2, 1, 32, torch.float32, {"logit_cap": 3.0}),
    # starcoder2-3b's training shape: a microbatch of 2 x 2048, 32 (24
    # real) q heads over 2 kv heads of 128, causal, its 4096 window
    ("starcoder2 train", 2, TRAIN_SEQ, TRAIN_SEQ, 32, 2, 128,
     torch.bfloat16, {"window": 4096}),
    # recurrentgemma-9b's: a microbatch of 1 x 2048, 16 q heads over 1 kv
    # head of 256, causal, its 2048 window
    ("recurrentgemma train", 1, TRAIN_SEQ, TRAIN_SEQ, 16, 1, 256,
     torch.bfloat16, {"window": 2048}),
    # grok-1's: a microbatch of 1 x 2048, 48 q heads over 8 kv heads of
    # 128, causal, its softcap 30, q scaled so the scores reach the cap
    ("grok-1 train", 1, TRAIN_SEQ, TRAIN_SEQ, 48, 8, 128, torch.bfloat16,
     {"logit_cap": GROK_CAP, "q_gain": GROK_Q_GAIN}),
]


def bwd_operands(gen, b, sq, sk, h, kh, d, dtype, kw, q_gain=1.0):
    """q (scaled by ``q_gain``), k, v, the forward kernel's output on
    them, a seeded incoming gradient and the lse of the same forward
    launch: the inputs of one backward call, in its argument order."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    q, k, v = fa_operands(gen, b, sq, sk, h, kh, d, dtype)
    q = q * q_gain
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    dout = torch.randn(out.shape, generator=gen, device=DEVICE).to(dtype)
    return q, k, v, out, dout, lse


def lse_check(lse, q, k, name, **kw) -> float:
    """Max |lse - plain| over the finite entries, the plain lse
    (flash_attention_lse_ref) in f32 on the same values; raises unless
    +inf stands exactly where a row sees no key and the rest lies within
    LSE_TOL."""
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_lse_ref
    want = flash_attention_lse_ref(q.float(), k.float(), rows=BWD_ROWS, **kw)
    inf = torch.isinf(want)
    rtol, atol = LSE_TOL
    err = (lse - want)[~inf].abs()
    if not torch.equal(torch.isinf(lse), inf) or bool(
            (err > atol + rtol * want[~inf].abs()).any()):
        raise AssertionError(f"flash_attention {name}: the forward's lse is "
                             f"off the plain one (max err "
                             f"{float(err.max()) if err.numel() else 0.0})")
    return float(err.max()) if err.numel() else 0.0


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (inf if got is not finite)."""
    g, w = got.double(), want.double()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    scale = float(w.abs().max())
    err = float((g - w).abs().max())
    return err / scale if scale > 0 else err


def bwd_check(got, want, dtype, name) -> list:
    """dq, dk, dv each within BWD_TOL of the largest plain value; returns
    the three relative errors, raises otherwise."""
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    if max(errs) > BWD_TOL[dtype]:
        raise AssertionError(f"flash_attention backward {name} ({dtype}): "
                             f"max |kernel - plain| / max |plain| for dq, "
                             f"dk, dv = {errs} (BWD_TOL {BWD_TOL[dtype]})")
    return errs


def plain_grads(q, k, v, dout, **kw):
    """autograd of the plain version in the operands' dtype (in bf16 it
    rounds q * scale and P): the yardstick reported beside the kernel."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        out = flash_attention_ref(*xs, **kw)
        return torch.autograd.grad(out, xs, dout)


def cap_check(q, k, v, dout, want, dtype, name, **kw) -> list:
    """How far the plain backward in f32 moves when the cap is left out
    (max |no cap - cap| / max |cap| for dq, dk, dv); raises unless dq and
    dk, which pass through the cap's 1 - tanh^2, move by more than
    BWD_TOL: else a backward that left the cap out would pass the row.
    dv sees the cap only through P, and is reported."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    kw = {key: x for key, x in kw.items() if key != "logit_cap"}
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    out = flash_attention_ref(qf, kf, vf, **kw)
    moved = [rel_err(g, w) for g, w in zip(flash_attention_bwd_ref(
        qf, kf, vf, out, df, rows=BWD_ROWS, **kw), want)]
    if min(moved[:2]) <= BWD_TOL[dtype]:
        raise AssertionError(f"flash_attention backward {name}: the cap "
                             f"moves the plain dq, dk, dv by {moved}, not "
                             f"beyond BWD_TOL {BWD_TOL[dtype]}")
    return moved


def phase_flash_backward(gen):
    from repro_torch.kernels.flash_attention import backward as fa_backward
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    rows = []
    for name, b, sq, sk, h, kh, d, dtype, kw in BWD_CASES:
        kw = dict(kw)
        q_gain = kw.pop("q_gain", 1.0)
        q, k, v, out, dout, lse = bwd_operands(gen, b, sq, sk, h, kh, d,
                                               dtype, kw, q_gain)
        pl = fa_backward.plan(b, sq, sk, h, kh, d, dtype)
        want_variant = "wgmma" if dtype == torch.bfloat16 and \
            d in fa_backward.TC_HEAD_DIMS else "simt"
        if pl.variant != want_variant:
            raise AssertionError(f"flash_attention backward {name}: plan "
                                 f"{pl}, expected {want_variant}")
        calls = fa_backward.VARIANT_CALLS[pl.variant]
        got = fa_backward.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                   **kw)
        again = fa_backward.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                     **kw)
        torch.cuda.synchronize()
        if fa_backward.VARIANT_CALLS[pl.variant] != calls + 2:
            raise AssertionError(f"flash_attention backward {name}: the "
                                 f"calls did not take {pl.variant}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"flash_attention backward {name}: two runs "
                                 "differ")
        # the plain backward computes its own lse: the forward's is held
        # against the plain one apart
        want = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out,
                                                            dout)),
                                       rows=BWD_ROWS, **kw)
        row = {"case": name, "shape": [b, sq, sk, h, kh, d],
               "dtype": str(dtype).split(".")[-1], "flags": kw,
               "q_gain": q_gain, "variant": pl.variant, "splits": pl.splits,
               "lse_max_abs_err": lse_check(lse, q, k, name, **kw),
               "rel_err_dq_dk_dv": bwd_check(got, want, dtype, name)}
        if "logit_cap" in kw:
            row["no_cap_plain_rel_dq_dk_dv"] = cap_check(
                q, k, v, dout, want, dtype, name, **kw)
        if name == "masked rows" and \
                float(got[0][:, 3:].float().abs().max()) != 0.0:
            raise AssertionError("flash_attention backward: a query that "
                                 "sees no key has a non-zero dq")
        if dtype == torch.bfloat16:
            row["plain_bf16_rel_err_dq_dk_dv"] = [
                rel_err(x, w) for x, w in zip(plain_grads(q, k, v, dout,
                                                          **kw), want)]
        rows.append(row)
        del q, k, v, out, dout, lse, got, again, want
    return rows


def softcap_library(cap, sq, sk, device=DEVICE):
    """The one PyTorch call that computes B3's capped causal GQA
    attention: ``flex_attention`` under ``torch.compile`` (its Triton
    kernels, cached under ``build/`` unless the environment names the
    caches), a ``score_mod`` of cap * tanh(s / cap) on the scaled scores,
    a causal block mask aligned to the last key and ``enable_gqa=True``;
    autograd gives its backward.  Takes and returns (B, H, S, D), as
    SDPA.  Timed beside the kernel only: the port never calls it."""
    import os
    from torch.nn.attention import flex_attention as fx
    cache = Path(__file__).resolve().parent / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def causal(b, h, q_idx, kv_idx):
        return q_idx + (sk - sq) >= kv_idx

    mask = fx.create_block_mask(causal, None, None, sq, sk, device=device)
    flex = torch.compile(fx.flex_attention, dynamic=False)
    return functools.partial(flex, score_mod=score_mod, block_mask=mask,
                             enable_gqa=True)


def time_flash_bwd(gen, b, sq, sk, h, kh, d, window=None,
                   dtype=torch.bfloat16, iters=TIMING_ITERS, logit_cap=None,
                   q_gain=1.0):
    """The backward at one main-path shape (causal; bf16 takes the
    tensor-core variant, f32 the CUDA-core one) over TIMING_ROTATION / 2
    input sets (q scaled by ``q_gain``): the kernels and their plain
    version (flash_attention_bwd_ref, given the forward's lse) as in
    ``time_pair``, and the library call, the backward of
    ``scaled_dot_product_attention(enable_gqa=True, is_causal=True)``,
    or with a ``logit_cap`` of ``softcap_library``'s flex_attention
    (autograd.grad over a kept forward graph; CUDA events around the
    calls, as ``call_time_ms``), timed and held against the plain
    backward (reported, not gated).  The cap's tanh adds no matmul flop
    to the bound."""
    from repro_torch.kernels.flash_attention import backward as fa_backward
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    lib = functools.partial(torch.nn.functional.scaled_dot_product_attention,
                            is_causal=True, enable_gqa=True)
    kw = {"window": window}
    lib_s = 0.0
    if logit_cap is not None:
        kw["logit_cap"] = logit_cap
        lib = softcap_library(logit_cap, sq, sk)
    sets = [bwd_operands(gen, b, sq, sk, h, kh, d, dtype, kw, q_gain)
            for _ in range(TIMING_ROTATION // 2)]
    kern = [functools.partial(fa_backward.flash_attention_bwd_cuda, *x, **kw)
            for x in sets]
    plain = [functools.partial(flash_attention_bwd_ref, *x, **kw)
             for x in sets]
    def lib_bwd(q, k, v, out, dout, lse):
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        with torch.enable_grad():
            o = lib(*leaves)
        g = dout.transpose(1, 2)
        return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)

    err, lib_err = 0.0, [0.0] * 3
    for i, (x, kc) in enumerate(zip(sets[:2], kern[:2])):
        got = kc()
        want = flash_attention_bwd_ref(*(t.float() for t in x[:5]),
                                       rows=BWD_ROWS, **kw)
        bwd_check(got, want, dtype, "timing")
        err = max([err] + [float((g.float() - w).abs().max())
                           for g, w in zip(got, want)])
        t0 = time.perf_counter()
        lib_got = lib_bwd(*x)()      # the first call compiles flex's
        torch.cuda.synchronize()
        if i == 0:
            lib_s = time.perf_counter() - t0
        lib_err = [max(e, rel_err(g.transpose(1, 2), w))
                   for e, g, w in zip(lib_err, lib_got, want)]
        del got, want, lib_got

    pl = fa_backward.plan(b, sq, sk, h, kh, d, dtype)
    f32 = dtype == torch.float32
    bound, by = roofline.bound_ms(roofline.flash_attention_bwd_work(
        b, sq, sk, h, kh, d, "float32" if f32 else "bfloat16", window))
    timed = time_pair(kern, plain, iters)
    library_ms = call_time_ms([lib_bwd(*x) for x in sets], iters)
    return {"variant": pl.variant, "splits": pl.splits,
            "dtype": str(dtype).split(".")[-1], "logit_cap": logit_cap,
            "q_gain": q_gain, **timed, "library_ms": library_ms,
            "library_rel_err_dq_dk_dv": lib_err,
            "library_first_call_s": lib_s, "bound_ms": bound,
            "bound_by": by, "max_abs_err": err}


# --------------------------------------------------------------------- #
# RG-LRU scan and mLSTM
# --------------------------------------------------------------------- #
# (B, S, W, with h0): recurrentgemma-9b's forward shape with and without
# a carried state, a ragged case, S under one chunk, W no multiple of 4
# (the kernel's cp.async load path), and more than 16 groups of chunks
# (the carry reads group aggregates in two batches)
SCAN_CASES = [(1, 4096, 4096, False), (1, 4096, 4096, True),
              (3, 100, 48, True), (2, 8, 4096, True), (2, 77, 50, True),
              (1, 9000, 128, True)]
# (B, S, H, D, dtype, flags): xlstm-350m's forward shape, then small cases
# whose S is no multiple of the 32-row tile, then the tensor-core kernel
# (bf16, D 512) off the model's shape: a ragged S, S under one 64-row
# tile, two batch rows, q, k and v as strided views of one fused
# projection, and input gates low enough (log i ~ N(-3, 1)) that exp(-m)
# wins the normaliser on most rows
MLSTM_CASES = [(1, 2048, 4, 512, torch.bfloat16, {}),
               (1, 2048, 4, 512, torch.float32, {}),
               (1, 64, 2, 16, torch.float32, {}),
               (2, 100, 2, 16, torch.float32, {}),
               (2, 96, 4, 32, torch.float32, {}),
               (1, 100, 1, 64, torch.float32, {}),
               (2, 70, 2, 512, torch.float32, {}),
               (2, 37, 4, 64, torch.bfloat16, {}),
               (1, 300, 4, 512, torch.bfloat16, {}),
               (1, 37, 4, 512, torch.bfloat16, {}),
               (2, 512, 4, 512, torch.bfloat16, {}),
               (2, 200, 4, 512, torch.bfloat16, {"fused": True}),
               (1, 300, 4, 512, torch.bfloat16, {"i_shift": -3.0})]


def scan_operands(gen, b, s, w, with_h0):
    """a in [0.7, 1) as the RG-LRU's decays, b ~ N(0, 1), h0 ~ N(0, 1)."""
    a = torch.rand((b, s, w), generator=gen, device=DEVICE) * 0.3 + 0.7
    x = torch.randn((b, s, w), generator=gen, device=DEVICE)
    h0 = torch.randn((b, w), generator=gen, device=DEVICE) \
        if with_h0 else None
    return a, x, h0


def mlstm_operands(gen, b, s, h, d, dtype, fused=False, i_shift=0.0,
                   f_bias=None):
    """q, k, v ~ N(0, 1) in ``dtype``, log_i ~ N(i_shift, 1), log_f =
    -|N(0, 1)| / 2 (f32), as the reference's kernel tests draw them; with
    ``fused`` q, k and v are views of one (B, S, 3, H, D) tensor; with
    ``f_bias`` log_f = logsigmoid(f_bias + 2.6 N(0, 1)), the model's form
    (xlstm's forget-gate bias is 3: F ~ -600 at S = 2048)."""
    if fused:
        qkv = torch.randn((b, s, 3, h, d), generator=gen,
                          device=DEVICE).to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=DEVICE)
                   .to(dtype) for _ in range(3))
    log_i = torch.randn((b, s, h), generator=gen, device=DEVICE) + i_shift
    log_f = torch.randn((b, s, h), generator=gen, device=DEVICE)
    log_f = -log_f.abs() * 0.5 if f_bias is None else \
        torch.nn.functional.logsigmoid(f_bias + 2.6 * log_f)
    return q, k, v, log_i, log_f


def normaliser_share(q, k, log_i, log_f):
    """Share of rows whose normaliser max(|den|, exp(-m)) is exp(-m), from
    the plain function in f32 (m the gate part's row max)."""
    b, s, h, d = q.shape
    fcum = torch.cumsum(log_f, dim=1)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logw = fcum[:, :, None] - fcum[:, None, :] + log_i[:, None, :]
    logw = torch.where(causal[None, :, :, None], logw, -1e30)
    m = logw.amax(dim=2)
    sc = torch.einsum("bthd,bshd->btsh", q.float(), k.float()) * d ** -0.5
    den = (torch.exp(logw - m[:, :, None]) * sc).sum(dim=2)
    return float((torch.exp(-m) > den.abs()).float().mean())


def close_check(out, want, rtol, atol, name) -> float:
    """Max |kernel - plain|; raises when an element lies outside
    atol + rtol |plain| or is not finite."""
    o, w = out.float(), want.float()
    if o.shape != w.shape or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{name}: shape {o.shape} or non-finite output")
    err = (o - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol {rtol} atol "
            f"{atol}, max err {float(err.max())}")
    return float(err.max())


def mlstm_plain_f32(q, k, v, log_i, log_f):
    """The plain version evaluated in f32 on the same values: what the
    kernel (and the Pallas kernel, which upcasts q, k, v) computes."""
    from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
    return mlstm_ref(q.float(), k.float(), v.float(), log_i, log_f)


def phase_scan_kernels(gen):
    """rglru_scan and mlstm against their plain versions; two launches of
    each case must give the same bits, and rglru_scan must equal its
    order of operations in plain PyTorch (rglru_scan_chunked_ref) bit for
    bit."""
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_chunked_ref,
                                                    rglru_scan_ref)
    rows = []
    for b, s, w, with_h0 in SCAN_CASES:
        a, x, h0 = scan_operands(gen, b, s, w, with_h0)
        pl = rg_kernel.plan(b, s, w)
        out, last = rg_kernel.rglru_scan_cuda(a, x, h0)
        again, _ = rg_kernel.rglru_scan_cuda(a, x, h0)
        torch.cuda.synchronize()
        name = f"rglru_scan {(b, s, w)}"
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two runs differ")
        emul, emul_last = rglru_scan_chunked_ref(a, x, h0, pl.chunk)
        if not (torch.equal(out, emul) and torch.equal(last, emul_last)):
            raise AssertionError(
                f"{name}: not bit-equal to rglru_scan_chunked_ref at chunk "
                f"{pl.chunk}: {int((out != emul).sum())} elements differ, "
                f"max {float((out - emul).abs().max())}")
        want, want_last = rglru_scan_ref(a, x, h0)
        err = close_check(out, want, *SCAN_TOL, name)
        close_check(last, want_last, *SCAN_TOL, "rglru_scan h_last")
        rows.append({"kernel": "rglru_scan", "shape": [b, s, w],
                     "h0": with_h0, "chunk": pl.chunk,
                     "tile": rg_kernel.TILE, "blocks": pl.blocks,
                     "load": pl.load, "bit_equal_chunked_ref": True,
                     "max_abs_err": err})
    for b, s, h, d, dtype, kw in MLSTM_CASES:
        ops = mlstm_operands(gen, b, s, h, d, dtype, **kw)
        pl = ml_kernel.plan(b, s, h, d, dtype)
        out = ml_kernel.mlstm_cuda(*ops)
        again = ml_kernel.mlstm_cuda(*ops)
        torch.cuda.synchronize()
        name = f"mlstm {(b, s, h, d)} {dtype} {kw}"
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two runs differ")
        err = close_check(out, mlstm_plain_f32(*ops), *MLSTM_TOL[dtype], name)
        row = {"kernel": "mlstm", "shape": [b, s, h, d],
               "dtype": str(dtype).split(".")[-1], "flags": kw,
               "variant": pl.variant, "blocks": len(pl.items) * b * h,
               "split_tiles": pl.split_tiles, "max_abs_err": err}
        if "i_shift" in kw:
            row["exp_neg_m_share"] = normaliser_share(ops[0], ops[1],
                                                      ops[3], ops[4])
        if dtype != torch.float32:
            # the plain version in the working dtype rounds a to bf16
            # before a.v, as the reference's mlstm_parallel: reported, and
            # held end to end by the xlstm forward's logit check
            plain = mlstm_ref(*ops).float()
            diff = (out.float() - plain).abs()
            row["vs_plain_in_dtype"] = {
                "max_abs_err": float(diff.max()),
                "share_outside_tol": float(
                    (diff > 2e-2 + 2e-2 * plain.abs()).float().mean())}
        rows.append(row)
    return rows


# (B, S, W, with h0, with dh_last): the B4 backward at recurrentgemma-9b's
# training microbatch without and with h0 and dh_last, a ragged S, S under
# one chunk, W no multiple of 4 (the cp.async path) and 141 chunks
SCAN_BWD_CASES = [(1, TRAIN_SEQ, 4096, False, False),
                  (1, TRAIN_SEQ, 4096, True, True),
                  (3, 100, 48, True, False), (2, 8, 4096, False, True),
                  (2, 77, 50, True, True), (1, 9000, 128, True, True)]
# (B, S, H, D, dtype, flags): the B5 backward at xlstm-350m's training
# microbatch and with the model's forget gates (F ~ -600 at 2048), then
# the tensor-core variant off it (S no multiple of 64, S under one block,
# a ragged S under low input gates (sg = 0 rows), q, k, v as views of one
# fused projection), then the CUDA-core variant at small head dims and in
# f32
MLSTM_BWD_CASES = [(2, TRAIN_SEQ, 4, 512, torch.bfloat16, {}),
                   (1, TRAIN_SEQ, 4, 512, torch.bfloat16, {"f_bias": 3.0}),
                   (1, 300, 4, 512, torch.bfloat16, {}),
                   (1, 37, 2, 512, torch.bfloat16, {}),
                   (1, 300, 4, 512, torch.bfloat16, {"i_shift": -3.0}),
                   (2, 200, 4, 512, torch.bfloat16, {"fused": True}),
                   (2, 100, 2, 16, torch.float32, {}),
                   (2, 96, 4, 32, torch.float32, {}),
                   (1, 100, 1, 64, torch.float32, {}),
                   (2, 37, 4, 64, torch.bfloat16, {}),
                   (2, 70, 2, 512, torch.float32, {"i_shift": -3.0})]


def mlstm_stats_check(q, k, v, log_i, log_f, lse, sg, name):
    """The forward launch's row stats against the plain version's in f32
    on the same values: L = m + log n within 1e-4 (1 + cond_t), cond_t =
    sum_s |a_ts| / n_t (n sums signed terms: where they cancel, log n is
    as ill-conditioned), and sg equal on every row whose |den| and
    exp(-m) lie further apart than that band.  Returns the largest
    |L - plain| over its band and the rows inside the band; raises
    otherwise."""
    from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
    b, s, h, d = q.shape
    _, want_lse, want_sg = mlstm_ref(q.float(), k.float(), v.float(),
                                     log_i, log_f, with_stats=True)
    fcum = torch.cumsum(log_f, dim=1)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logw = torch.where(causal[None, :, :, None], fcum[:, :, None] -
                       fcum[:, None] + log_i[:, None], -1e30)
    m = logw.amax(dim=2)
    a = torch.exp(logw - m[:, :, None]) * torch.einsum(
        "bthd,bshd->btsh", q.float(), k.float()) * d ** -0.5
    den, mass = a.sum(dim=2), a.abs().sum(dim=2)
    del logw, a
    norm = torch.maximum(den.abs(), torch.exp(-m))
    band = 1e-4 * (norm + mass)
    ratio = float(((lse - want_lse).abs() / (band / norm)).max())
    tie = (den.abs() - torch.exp(-m)).abs() <= band
    if ratio > 1 or not torch.equal(sg[~tie], want_sg[~tie]):
        raise AssertionError(f"{name}: row stats off the plain ones: "
                             f"|L - plain| / band {ratio}, sg differing "
                             f"on {int((sg != want_sg)[~tie].sum())} rows")
    return ratio, int(tie.sum())


def phase_scan_backward(gen):
    """The B4 and B5 backward kernels against their plain versions: the
    RG-LRU backward bit-equal to its order of operations in plain PyTorch
    (rglru_scan_bwd_chunked_ref) and within BWD_TOL (f32) of the plain
    backward (rglru_scan_bwd_ref); the mLSTM forward's row stats against
    the plain ones (mlstm_stats_check) and its backward's dq, dk, dv, d
    log_i, d log_f each within BWD_TOL of the largest value of the plain
    backward (mlstm_bwd_ref) in f32 on the same values and stats, and the
    tensor-core variant's also within TWIN_TOL of its arithmetic in plain
    PyTorch (mlstm_bwd_split_ref); two launches of every case give the
    same bits."""
    from repro_torch.kernels.mlstm_scan import backward as ml_backward
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.mlstm_scan.ref import (mlstm_bwd_ref,
                                                    mlstm_bwd_split_ref)
    from repro_torch.kernels.rglru_scan import backward as rg_backward
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan.ref import (
        rglru_scan_bwd_chunked_ref, rglru_scan_bwd_ref)
    rows = []
    for b, s, w, with_h0, with_dl in SCAN_BWD_CASES:
        a, x, h0 = scan_operands(gen, b, s, w, with_h0)
        dy = torch.randn((b, s, w), generator=gen, device=DEVICE)
        dl = torch.randn((b, w), generator=gen, device=DEVICE) \
            if with_dl else None
        h, _ = rg_kernel.rglru_scan_cuda(a, x, h0)
        got = rg_backward.rglru_scan_bwd_cuda(a, h, dy, dl, h0)
        again = rg_backward.rglru_scan_bwd_cuda(a, h, dy, dl, h0)
        torch.cuda.synchronize()
        name = f"rglru_scan backward {(b, s, w)} h0 {with_h0} dh_last " \
            f"{with_dl}"
        pl = rg_kernel.plan(b, s, w)
        emul = rglru_scan_bwd_chunked_ref(a, h, dy, dl, h0, chunk=pl.chunk)
        for g, g2, e in zip(got, again, emul):
            if g is None and e is None:
                continue
            if not torch.equal(g, g2):
                raise AssertionError(f"{name}: two runs differ")
            if not torch.equal(g, e):
                raise AssertionError(
                    f"{name}: not bit-equal to rglru_scan_bwd_chunked_ref "
                    f"at chunk {pl.chunk}: {int((g != e).sum())} elements")
        want = rglru_scan_bwd_ref(a, h, dy, dl, h0)
        errs = [rel_err(g, w) for g, w in zip(got, want) if w is not None]
        if max(errs) > BWD_TOL[torch.float32]:
            raise AssertionError(f"{name}: off the plain backward: {errs}")
        rows.append({"kernel": "rglru_scan_bwd", "shape": [b, s, w],
                     "h0": with_h0, "dh_last": with_dl, "chunk": pl.chunk,
                     "load": pl.load, "bit_equal_chunked_ref": True,
                     "rel_err_da_db_dh0": errs})
    for b, s, h, d, dtype, kw in MLSTM_BWD_CASES:
        ops = mlstm_operands(gen, b, s, h, d, dtype, **kw)
        out, lse, sg = ml_kernel.mlstm_cuda(*ops, with_stats=True)
        dout = torch.randn(out.shape, generator=gen,
                           device=DEVICE).to(dtype)
        got = ml_backward.mlstm_bwd_cuda(*ops, out, dout, lse, sg)
        again = ml_backward.mlstm_bwd_cuda(*ops, out, dout, lse, sg)
        torch.cuda.synchronize()
        name = f"mlstm backward {(b, s, h, d)} {dtype} {kw}"
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name}: two runs differ")
        q, k, v, log_i, log_f = ops
        ratio, ties = mlstm_stats_check(q, k, v, log_i, log_f, lse, sg,
                                        name)
        want = mlstm_bwd_ref(q.float(), k.float(), v.float(), log_i, log_f,
                             out.float(), dout.float(), (lse, sg),
                             rows=BWD_ROWS)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        del want
        if max(errs) > BWD_TOL[dtype]:
            raise AssertionError(f"{name}: max |kernel - plain| / max "
                                 f"|plain| for dq, dk, dv, d log_i, d log_f "
                                 f"= {errs} (BWD_TOL {BWD_TOL[dtype]})")
        variant = ml_backward.plan(b, s, h, d, dtype)
        twin = None
        if variant == "wgmma":
            emul = mlstm_bwd_split_ref(q, k, v, log_i, log_f, out, dout,
                                       (lse, sg))
            twin = [rel_err(g, e) for g, e in zip(got, emul)]
            del emul
            if any(e > tol for e, tol in zip(twin, TWIN_TOL)):
                raise AssertionError(f"{name}: off mlstm_bwd_split_ref: "
                                     f"{twin} (TWIN_TOL {TWIN_TOL})")
        rows.append({"kernel": "mlstm_bwd", "shape": [b, s, h, d],
                     "dtype": str(dtype).split(".")[-1], "flags": kw,
                     "variant": variant, "rel_err_split_ref": twin,
                     "forward_variant": ml_kernel.plan(b, s, h, d,
                                                       dtype).variant,
                     "sg_zero_share": float((sg == 0).float().mean()),
                     "stats_err_over_band": ratio, "stats_tie_rows": ties,
                     "rel_err_dq_dk_dv_dli_dlf": errs})
        del ops, out, lse, sg, dout, got, again
    return rows


def time_scan(gen, b, s, w):
    """rglru_scan at recurrentgemma-9b's forward shape (no h0, as the
    forward calls it) over TIMING_ROTATION operand sets.  No library
    call: no single PyTorch call computes a first-order linear
    recurrence."""
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    sets = [scan_operands(gen, b, s, w, False)[:2]
            for _ in range(TIMING_ROTATION // 4)]
    kern = [functools.partial(rg_kernel.rglru_scan_cuda, *ab) for ab in sets]
    plain = [functools.partial(rglru_scan_ref, *ab) for ab in sets]
    err = 0.0
    for kc, pc in zip(kern[:2], plain[:2]):
        err = max(err, close_check(kc()[0], pc()[0], *SCAN_TOL, "timing"))
    bound, by = roofline.bound_ms(roofline.rglru_scan_work(b, s, w))
    pl = rg_kernel.plan(b, s, w)
    return with_share({"chunk": pl.chunk, "blocks": pl.blocks,
                       "load": pl.load, **time_pair(kern, plain),
                       "library_ms": None, "bound_ms": bound,
                       "bound_by": by, "max_abs_err": err})


def time_mlstm(gen, b, s, h, d, with_stats=False):
    """mlstm at xlstm-350m's forward shape (bf16) over TIMING_ROTATION
    operand sets; the plain version in bf16, as the model's plain path.
    No library call: scaled_dot_product_attention cannot apply the gate
    decay or the max(|den|, exp(-m)) normaliser.  ``with_stats``: the
    kernel writing its row stats, as training calls it (device and call
    ms only)."""
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
    sets = [mlstm_operands(gen, b, s, h, d, torch.bfloat16)
            for _ in range(TIMING_ROTATION)]
    if with_stats:
        kern = [functools.partial(ml_kernel.mlstm_cuda, *ops,
                                  with_stats=True) for ops in sets]
        return {"ms": (device_time_ms(kern) + device_time_ms(kern)) / 2,
                "call_ms": call_time_ms(kern)}
    kern = [functools.partial(ml_kernel.mlstm_cuda, *ops) for ops in sets]
    plain = [functools.partial(mlstm_ref, *ops) for ops in sets]
    err = 0.0
    for kc, ops in zip(kern[:4], sets[:4]):
        err = max(err, close_check(kc(), mlstm_plain_f32(*ops),
                                   *MLSTM_TOL[torch.bfloat16], "timing"))
    bound, by = roofline.bound_ms(roofline.mlstm_work(b, s, h, d))
    pl = ml_kernel.plan(b, s, h, d, torch.bfloat16)
    return with_share({"variant": pl.variant,
                       "blocks": len(pl.items) * b * h,
                       **time_pair(kern, plain), "library_ms": None,
                       "bound_ms": bound, "bound_by": by,
                       "max_abs_err": err})


def time_scan_bwd(gen, b, s, w):
    """The RG-LRU backward at recurrentgemma-9b's training microbatch (no
    h0, no dh_last, as the model calls it) over TIMING_ROTATION / 4
    operand sets, beside its plain version (rglru_scan_bwd_ref, a doubling
    scan); each checked first against the plain backward and its chunked
    order.  No library call: no PyTorch call computes a linear
    recurrence's gradient."""
    from repro_torch.kernels.rglru_scan import backward as rg_backward
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan.ref import (
        rglru_scan_bwd_chunked_ref, rglru_scan_bwd_ref)
    sets = []
    for _ in range(TIMING_ROTATION // 4):
        a, x, _ = scan_operands(gen, b, s, w, False)
        h, _ = rg_kernel.rglru_scan_cuda(a, x)
        sets.append((a, h, torch.randn((b, s, w), generator=gen,
                                       device=DEVICE)))
    kern = [functools.partial(rg_backward.rglru_scan_bwd_cuda, *x)
            for x in sets]
    plain = [functools.partial(rglru_scan_bwd_ref, *x) for x in sets]
    err = 0.0
    for x, kc, pc in zip(sets[:2], kern[:2], plain[:2]):
        got, want = kc(), pc()
        emul = rglru_scan_bwd_chunked_ref(*x, chunk=rg_kernel.plan(
            b, s, w).chunk)
        if not all(torch.equal(g, e) for g, e in zip(got[:2], emul[:2])):
            raise AssertionError("rglru_scan backward timing: not "
                                 "bit-equal to its chunked order")
        if max(rel_err(g, w) for g, w in zip(got[:2], want[:2])) > \
                BWD_TOL[torch.float32]:
            raise AssertionError("rglru_scan backward timing: off the "
                                 "plain backward")
        err = max([err] + [float((g - w).abs().max())
                           for g, w in zip(got[:2], want[:2])])
    bound, by = roofline.bound_ms(roofline.rglru_scan_bwd_work(b, s, w))
    pl = rg_kernel.plan(b, s, w)
    return with_share({"chunk": pl.chunk, "blocks": pl.blocks,
                       "load": pl.load, **time_pair(kern, plain),
                       "library_ms": None, "bound_ms": bound,
                       "bound_by": by, "max_abs_err": err})


#: a parameter's bytes through AdamW's two passes: the update reads p
#: (bf16), g, m and v (f32) and writes p, m and v (24 bytes); the norm
#: reads g once more (4)
ADAMW_BYTES = 2 + 4 + 4 + 4 + 2 + 4 + 4 + 4


def time_adamw(gen, iters=3):
    """AdamW's two passes at chatglm3-6b's train cell (TRAIN_ARCHS: 18
    layers): its largest leaf, then its whole tree of 12 leaves (bf16 p,
    f32 g, m, v), each beside the plain version (``global_norm_plain``,
    the eager clip, ``_update_slice`` over flat slices).  A step is the
    norm with the clip factor, the bias corrections and the update; ms a
    step by CUDA events over ``iters`` steps, plain, kernel, kernel,
    plain.  The leaf's step is held bit for bit against the plain step
    from the same state, with the kernel's norm (the plain norm may
    differ by an ulp, and the clip factor with it)."""
    from repro_torch.kernels.adamw import kernel as adamw_kernel
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    opt = adamw.AdamW()
    cfg = train_config(GLM_ARCH)
    shapes = {path: d.shape
              for path, d in model_zoo.build_model(cfg).table.defs.items()}
    largest = max(shapes, key=lambda k: math.prod(shapes[k]))

    def state(shape):
        return (torch.randn(shape, generator=gen, device=DEVICE,
                            dtype=torch.bfloat16),
                torch.randn(shape, generator=gen, device=DEVICE) * 1e-4,
                torch.randn(shape, generator=gen, device=DEVICE) * 1e-4,
                torch.rand(shape, generator=gen, device=DEVICE) * 1e-8)

    def scalars():
        count = torch.ones((), dtype=torch.int32, device=DEVICE)
        cf = count.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(opt.b1, dtype=torch.float32,
                                          device=DEVICE), cf)
        c2 = 1.0 - torch.pow(torch.tensor(opt.b2, dtype=torch.float32,
                                          device=DEVICE), cf)
        return c1, c2, torch.as_tensor(TRAIN_LR, dtype=torch.float32,
                                       device=DEVICE)

    def kernel_step(leaves):
        _, clip = adamw_kernel.norm_and_clip([x[1] for x in leaves],
                                             opt.grad_clip)
        adamw_kernel.update(leaves, clip, *scalars(), opt)

    def plain_update(leaves, clip):
        c1, c2, lr = scalars()
        for leaf in leaves:
            for p, g, m, v in zip(*map(adamw._flat_slices, leaf)):
                adamw._update_slice(p, g, m, v, clip=clip, c1=c1, c2=c2,
                                    lr=lr, opt=opt)

    def plain_step(leaves):
        gnorm = adamw.global_norm_plain(
            {str(i): leaf[1] for i, leaf in enumerate(leaves)})
        plain_update(leaves, torch.clamp(
            opt.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0))

    def ms(step, leaves):
        step(leaves)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step(leaves)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def pair(leaves):
        p1, k1, k2, p2 = (ms(plain_step, leaves), ms(kernel_step, leaves),
                          ms(kernel_step, leaves), ms(plain_step, leaves))
        return (k1 + k2) / 2, (p1 + p2) / 2

    # the largest leaf: bit for bit, then timed
    leaf = state(shapes[largest])
    other = tuple(x.clone() for x in leaf)
    gnorm, clip = adamw_kernel.norm_and_clip([leaf[1]], opt.grad_clip)
    plain_norm = adamw.global_norm_plain({"g": leaf[1]})
    adamw_kernel.update([leaf], clip, *scalars(), opt)
    plain_update([other], clip)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(leaf, other)):
        raise AssertionError(f"adamw at {largest}: the kernel's step is not "
                             f"the plain step's bits")
    ulps = abs(int(gnorm.reshape(1).view(torch.int32)) -
               int(plain_norm.reshape(1).view(torch.int32)))
    if ulps > 1:
        raise AssertionError(f"adamw at {largest}: norm {float(gnorm)} "
                             f"against the plain {float(plain_norm)}")
    del other
    n_leaf = math.prod(shapes[largest])
    leaf_ms, leaf_plain = pair([leaf])
    del leaf
    release()
    tree = [state(shape) for shape in shapes.values()]
    n = sum(math.prod(shape) for shape in shapes.values())
    tree_ms, tree_plain = pair(tree)
    del tree
    release()
    bound = n * ADAMW_BYTES / HBM_BYTES_PER_S * 1e3
    return with_share({
        "arch": cfg.name, "layers": cfg.num_layers, "params": n,
        "leaves": len(shapes), "leaf": largest, "leaf_shape":
        list(shapes[largest]), "leaf_ms": leaf_ms,
        "leaf_plain_ms": leaf_plain,
        "leaf_bound_ms": n_leaf * ADAMW_BYTES / HBM_BYTES_PER_S * 1e3,
        "ms": tree_ms, "plain_ms": tree_plain, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None, "max_abs_err": 0.0,
        "norm_ulps": ulps, "launches_a_step": 2 * len(shapes) + 1})


def kernel_ms(calls, iters, counts=None):
    """Device ms a launch of each device kernel by name, torch.profiler
    over ``iters`` calls cycling through ``calls``, each kernel launching
    once a call (a few kernels a call: key_averages() is quick here).  A
    launch's time is the kernel's total over the launches the profiler
    recorded of it, which ``counts`` (a dict) receives by name: divided
    by ``iters``, the totals of 16 calls in this script's timing phase
    came to about half the call's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
    if counts is not None:
        counts.update({e.key[:90]: e.count for e in events})
    return {e.key[:90]: e.self_device_time_total / 1e3 / e.count
            for e in events}


#: the mLSTM backward's device kernels by their names' distinct parts
MLSTM_BWD_KERNELS = {"cumsum": "mlstm_bwd_cumsum",
                     "planes": "mlstm_bwd_planes", "delta": "mlstm_bwd_prep",
                     "dkdv": "mlstm_bwd_dkdv", "dq": "mlstm_bwd_dq",
                     "finish": "mlstm_bwd_finish"}


def time_mlstm_bwd(gen, b, s, h, d, iters=16):
    """The mLSTM backward at xlstm-350m's training microbatch (bf16, the
    stats and output of one tensor-core forward launch a set) over
    TIMING_ROTATION / 4 operand sets, beside its plain version
    (mlstm_bwd_ref in f32 on the same values, given the kernel's stats,
    as the checks evaluate it); each checked first against the plain
    backward; each of its device kernels apart (``kernels_ms``, the
    profiler).  No library call: no PyTorch call computes the mLSTM or its
    gradient."""
    from repro_torch.kernels.mlstm_scan import backward as ml_backward
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.mlstm_scan.ref import mlstm_bwd_ref
    sets = []
    for _ in range(TIMING_ROTATION // 4):
        ops = mlstm_operands(gen, b, s, h, d, torch.bfloat16)
        out, lse, sg = ml_kernel.mlstm_cuda(*ops, with_stats=True)
        dout = torch.randn(out.shape, generator=gen,
                           device=DEVICE).to(torch.bfloat16)
        sets.append((*ops, out, dout, lse, sg))
    kern = [functools.partial(ml_backward.mlstm_bwd_cuda, *x) for x in sets]
    f32 = [tuple(t.float() for t in x[:7]) + ((x[7], x[8]),) for x in sets]
    plain = [functools.partial(mlstm_bwd_ref, *x, rows=BWD_ROWS)
             for x in f32]
    err = 0.0
    for kc, pc in zip(kern[:2], plain[:2]):
        got, want = kc(), pc()
        if max(rel_err(g, w) for g, w in zip(got, want)) > \
                BWD_TOL[torch.bfloat16]:
            raise AssertionError("mlstm backward timing: off the plain "
                                 "backward")
        err = max([err] + [float((g.float() - w).abs().max())
                           for g, w in zip(got, want)])
    bound, by = roofline.bound_ms(roofline.mlstm_bwd_work(b, s, h, d))
    counts = {}
    by_name = kernel_ms(kern, iters, counts)
    split = {key: sum(ms for name, ms in by_name.items() if sub in name)
             for key, sub in MLSTM_BWD_KERNELS.items()}
    recorded = {key: sum(n for name, n in counts.items() if sub in name)
                for key, sub in MLSTM_BWD_KERNELS.items()}
    return with_share({"variant": ml_backward.plan(b, s, h, d,
                                                   torch.bfloat16),
                       **time_pair(kern, plain, iters),
                       "kernels_ms": {k: v for k, v in split.items() if v},
                       # launches the profiler recorded of each, over
                       # kernels_calls calls
                       "kernels_recorded": {k: n for k, n in
                                            recorded.items() if n},
                       "kernels_calls": iters,
                       "library_ms": None, "bound_ms": bound,
                       "bound_by": by, "max_abs_err": err})


# --------------------------------------------------------------------- #
# serve
# --------------------------------------------------------------------- #
HOT_QUERIES = ["e_total > 40 && count(pt > 15) >= 2",
               "e_t_miss > 30", "pt_lead > 60 || n_tracks >= 8"]


def serve_workload(svc, n_queries=64, tenants=4, window=16):
    """The serve launcher's multi-tenant workload (streamed)."""
    tids = []
    for i in range(n_queries):
        if i % 3 != 2:
            expr = HOT_QUERIES[i % len(HOT_QUERIES)]
        else:
            expr = (f"e_total > {20 + (i % 7) * 10} && "
                    f"count(pt > 15) >= {1 + i % 4}")
        tids.append(svc.submit(expr, tenant=f"tenant{i % tenants}",
                               stream=True))
        if (i + 1) % window == 0:
            svc.step()
    svc.drain()
    return tids


def profile_run(phase, run, breakdown=(), host_ops=True, **extra):
    """Device time by kernel over one ``run()``, from torch.profiler; the
    profiler's own cost is in ``wall_s``.  Every kernel whose name holds
    one of the ``breakdown`` strings is also listed on its own, whatever
    its rank.  ``host_ops=False`` records the device activity alone (for a
    run of hundreds of thousands of launches, whose host ops add millions
    of events to collect).  ``extra`` goes into the line, with the seconds
    the events took to sum (``analysis_s``); the line is returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side activities only (kernels, copies): a host op's device
    # time is its children's, so counting both would count it twice.  The
    # profiler's raw events, summed by name: key_averages() gives the
    # same sums but takes ~0.5 ms a host op to build them
    t0 = time.perf_counter()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU or e.duration_ns() <= 0:
            continue
        row = by_name.setdefault(e.name(), [0.0, 0])
        row[0] += e.duration_ns() / 1e3
        row[1] += 1
    rows = sorted(((us, key, n) for key, (us, n) in by_name.items()),
                  reverse=True)
    extra["analysis_s"] = time.perf_counter() - t0
    busy_s = sum(us for us, _, _ in rows) / 1e6
    line = {"phase": phase, **extra, "wall_s": wall, "device_busy_s": busy_s,
            "device_launches": sum(n for _, _, n in rows),
            "top": [{"name": key[:80], "device_ms": us / 1e3, "count": n}
                    for us, key, n in rows[:12]],
            "breakdown": [{"name": key[:100], "device_ms": us / 1e3,
                           "count": n} for us, key, n in rows
                          if any(b in key for b in breakdown)]}
    emit(line)
    return line


def profile_serve(make_service):
    """One more run of the serve workload on a fresh service (the same
    scans) under the profiler."""
    svc = make_service()
    profile_run("profile", lambda: serve_workload(svc))
    svc.close()


def build_store(n_events):
    """The paper's event workload resident on the card: 64 scalars, 4096
    tracks x 63 vars, 256 events a brick, replication 2, on 4 nodes."""
    from repro_torch.configs.geps_events import EventWorkloadConfig
    from repro_torch.core import events as ev
    from repro_torch.core.brick import create_store
    cfg = EventWorkloadConfig()
    t0 = time.perf_counter()
    store = create_store(ev.EventSchema.from_config(cfg), n_events=n_events,
                         n_nodes=4, events_per_brick=cfg.events_per_brick,
                         replication=cfg.replication_factor, seed=0,
                         device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "store", "n_events": store.n_events,
          "bricks": len(store.bricks),
          "resident_gb": torch.cuda.memory_allocated() / 1e9,
          "build_s": time.perf_counter() - t0})
    return store


def counted(run):
    """Run one path with the event filter's launch counts zeroed just
    before it and read just after it: (its output, its launches)."""
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    for key in ef_kernel.LAUNCHES:
        ef_kernel.LAUNCHES[key] = 0
    out = run()
    torch.cuda.synchronize()
    return out, dict(ef_kernel.LAUNCHES)


def record_windows(backend):
    """Make a spmd backend keep each window's JobStats
    (``backend.window_stats``) and the kernel sub-batch width K it ran
    with (``backend.kernel_widths``)."""
    backend.window_stats, backend.kernel_widths = [], []
    split_plan, run_batch = backend._split_plan, backend.run_batch

    def _split_plan(plan):
        split = split_plan(plan)
        backend.kernel_widths.append(len(split.kernel_cols))
        return split

    def _run_batch(*a, **kw):
        merged, stats = run_batch(*a, **kw)
        backend.window_stats.append(stats)
        return merged, stats

    backend._split_plan, backend.run_batch = _split_plan, _run_batch
    return backend


def kernel_chunks(backends):
    """(events scanned, kernel events, chunks of windows with kernel
    targets) over the windows the recording backends ran."""
    scanned = kernel_events = chunks = 0
    for b in backends:
        for stats, k in zip(b.window_stats, b.kernel_widths):
            scanned += stats.events_scanned
            kernel_events += stats.kernel_events
            chunks += stats.packets if k else 0
    return scanned, kernel_events, chunks


def phase_serve(store):
    from repro_torch.core import merge as merge_lib
    from repro_torch.core.backend import SpmdBackend
    from repro_torch.core.catalog import MetadataCatalog
    from repro_torch.core.jse import spmd_query_batch_step, spmd_query_step
    from repro_torch.service import QueryScheduler, QueryService

    schema = store.schema
    # ---- the serve path ----
    backend = record_windows(SpmdBackend(MetadataCatalog(store.n_nodes),
                                         store, use_pallas=True,
                                         device="cuda"))
    svc = QueryService(store, backend=backend,
                       scheduler=QueryScheduler(max_batch=16),
                       device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tids, launches = counted(lambda: serve_workload(svc))
    wall = time.perf_counter() - t0

    scanned, kernel_events, n_chunks = kernel_chunks([backend])
    if launches["event_filter_batch"] <= 0 \
            or launches["event_filter_batch"] != n_chunks:
        raise AssertionError(
            f"the serve run launched event_filter_batch "
            f"{launches['event_filter_batch']} times for {n_chunks} "
            f"chunks of windows with kernel targets")
    if launches["event_filter"] != 0:
        raise AssertionError("the serve run launched the single-query "
                             "event_filter")
    if kernel_events != scanned or scanned == 0:
        raise AssertionError(f"kernel_events {kernel_events} != "
                             f"events_scanned {scanned}")

    # ---- the lockstep entry points, each over one brick ----
    brick0 = store.bricks[0]
    lock_expr = "e_total > 40 && count(pt > 15) >= 2"
    lock_exprs = [lock_expr, "e_t_miss > 30 && count(pt > 20) >= 1",
                  "pt_lead > 60 && count(pt > 10) >= 3"]
    step_k, step_launches = counted(lambda: spmd_query_step(
        lock_expr, schema, use_pallas=True, device="cuda")(brick0))
    bstep_k, bstep_launches = counted(lambda: spmd_query_batch_step(
        lock_exprs, schema, use_pallas=True, device="cuda")(brick0))
    for name, got, want in (
            ("spmd_query_step", step_launches,
             {"event_filter": 1, "event_filter_batch": 0}),
            ("spmd_query_batch_step", bstep_launches,
             {"event_filter": 0, "event_filter_batch": 1})):
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")

    def service(use_pallas):
        return QueryService(store, backend="spmd",
                            backend_kwargs={"use_pallas": use_pallas},
                            scheduler=QueryScheduler(max_batch=16),
                            device="cuda")

    plain = service(False)
    tids_p = serve_workload(plain)
    for a, b in zip(tids, tids_p):
        ra, rb = svc.result(a), plain.result(b)
        if ra.status != "SERVED" or rb.status != "SERVED":
            raise AssertionError(f"ticket {a}: {ra.status}/{rb.status}")
        if not merge_lib.results_identical(ra.result, rb.result):
            raise AssertionError(f"ticket {a} ({ra.expr}): kernel final "
                                 "differs from the plain path")
        if ra.result.n_processed != store.n_events:
            raise AssertionError(f"ticket {a} processed "
                                 f"{ra.result.n_processed} events")
        if not merge_lib.results_identical(svc.stream(a).latest().result,
                                           ra.result):
            raise AssertionError(f"ticket {a}: stream final != result")

    step_p = spmd_query_step(lock_expr, schema, use_pallas=False,
                             device="cuda")(brick0)
    bstep_p = spmd_query_batch_step(lock_exprs, schema, use_pallas=False,
                                    device="cuda")(brick0)
    for name, got, want in (("spmd_query_step", step_k, step_p),
                            ("spmd_query_batch_step", bstep_k, bstep_p)):
        for key in want:
            g, w = got[key], want[key]
            if g.shape != w.shape or not torch.isfinite(g).all() \
                    or not torch.equal(g, w):
                raise AssertionError(f"{name}[{key}]: kernel {g.tolist()} "
                                     f"!= plain {w.tolist()}")
    svc.close()
    plain.close()
    profile_serve(lambda: service(True))
    t, v = schema.max_tracks, schema.track_vars
    emit({"phase": "serve", "tickets": len(tids),
          "windows": len(backend.window_stats),
          "kernel_widths": backend.kernel_widths,
          "events_scanned": scanned, "kernel_events": kernel_events,
          "kernel_chunks": n_chunks, "launches": launches,
          "wall_s": wall, "events_per_s": scanned / wall,
          "track_gb_per_s": scanned * t * v * 4 / wall / 1e9,
          "results_identical_to_plain": True})
    emit({"phase": "lockstep", "events": int(brick0["scalars"].shape[0]),
          "spmd_query_step_launches": step_launches,
          "spmd_query_batch_step_launches": bstep_launches,
          "identical_to_plain": True})
    # each kernel's count from its own path: the batched kernel from the
    # serve run, the single-query kernel from spmd_query_step
    return ({"event_filter_batch": launches["event_filter_batch"],
             "event_filter": step_launches["event_filter"]},
            backend.kernel_widths)


def phase_autotune(store):
    """The serve workload through QueryService on spmd with the kernel and
    ``autotune=True``: each shape class of the windows (chunk x K x calib)
    sweeps the kernel's block sizes on a sample chunk, once, and every
    kernel chunk launches with the winner.  The sweep's launches (one
    warm-up and ``tune.REPEATS`` timed a candidate) are counted apart: the
    chunks' launches must equal the kernel chunks, as in the serve phase.
    Every final must be identical to the plain-path service's."""
    from repro_torch.core.backend import SpmdBackend
    from repro_torch.core.catalog import MetadataCatalog
    from repro_torch.kernels.event_filter import tune
    from repro_torch.service import QueryScheduler, QueryService

    tune.clear_cache()
    backend = record_windows(SpmdBackend(MetadataCatalog(store.n_nodes),
                                         store, use_pallas=True,
                                         autotune=True, device="cuda"))
    svc = QueryService(store, backend=backend,
                       scheduler=QueryScheduler(max_batch=16),
                       device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tids, launches = counted(lambda: serve_workload(svc))
    wall = time.perf_counter() - t0
    sweeps = tune.cached_shapes()
    sweep_launches = sum(len(ts.measurements) for ts in sweeps.values()) \
        * (1 + tune.REPEATS)
    scanned, kernel_events, n_chunks = kernel_chunks([backend])
    chunk_launches = launches["event_filter_batch"] - sweep_launches
    if not sweeps or chunk_launches != n_chunks or n_chunks <= 0:
        raise AssertionError(
            f"the autotuned serve run launched event_filter_batch "
            f"{launches['event_filter_batch']} times: {sweep_launches} for "
            f"{len(sweeps)} sweeps and {chunk_launches} for {n_chunks} "
            f"kernel chunks")
    if launches["event_filter"] != 0 or kernel_events != scanned:
        raise AssertionError(f"autotune: {launches}, kernel_events "
                             f"{kernel_events} != events_scanned {scanned}")
    for ts in sweeps.values():
        timed = dict(ts.measurements)
        if sorted(timed) != list(tune.CANDIDATES) or \
                ts.default_ms != timed[tune.DEFAULT_SHAPE] or \
                ts.best_ms != min(timed.values()) or \
                ts.speedup_vs_default < 1.0:
            raise AssertionError(f"autotune verdict malformed: {ts}")
    plain = QueryService(store, backend="spmd",
                         backend_kwargs={"use_pallas": False},
                         scheduler=QueryScheduler(max_batch=16),
                         device="cuda")
    tids_p = serve_workload(plain)
    check_finals("autotune", svc, tids, plain, tids_p, store.n_events)
    svc.close()
    plain.close()
    emit({"phase": "autotune", "tickets": len(tids),
          "windows": len(backend.window_stats),
          "sweeps": [{"key": list(key), **dataclasses.asdict(ts),
                      "speedup_vs_default": ts.speedup_vs_default}
                     for key, ts in sweeps.items()],
          "last_winner": backend.last_autotune.threads,
          "launches": launches, "sweep_launches": sweep_launches,
          "chunk_launches": chunk_launches, "kernel_chunks": n_chunks,
          "wall_s": wall, "events_per_s": scanned / wall,
          "results_identical_to_plain": True})
    tune.clear_cache()


# --------------------------------------------------------------------- #
# fleet and failover
# --------------------------------------------------------------------- #
FLEET_WIDTH = 4
FLEET_QUERIES = 64
FAILOVER_DROP_RATE = 0.05
FAILOVER_NODE = 1


def store_view(store):
    """The same resident bricks under a fresh copy of their placement: a
    node leaving rewrites the specs of the store it runs on, so each fleet
    run starts from the placement as built.  No brick is copied."""
    return dataclasses.replace(store, specs={
        bid: dataclasses.replace(sp) for bid, sp in store.specs.items()})


def fleet_workload(fleet, n_queries=FLEET_QUERIES, tenants=4, window=16,
                   kill_node=None):
    """The serve launcher's fleet workload: the three hot queries plus
    the long tail, streamed, round-robin over the fleet, a step every
    window, a node leaving after a third (``kill_node``), a dataset bump
    at half way, and a drain; returns the global ticket ids."""
    gtids = []
    for i in range(n_queries):
        if i % 3 != 2:
            expr = HOT_QUERIES[(i // 3) % len(HOT_QUERIES)]
        else:
            expr = (f"e_total > {20 + (i % 7) * 10} && "
                    f"count(pt > 15) >= {1 + i % 4}")
        gtids.append(fleet.submit(expr, tenant=f"tenant{i % tenants}",
                                  stream=True))
        if (i + 1) % window == 0:
            fleet.step()
        if kill_node is not None and i == n_queries // 3:
            fleet.node_leave(kill_node)
        if i == n_queries // 2:
            fleet.bump_dataset_version(0)
    fleet.drain()
    return gtids


def check_finals(name, fleet, gtids, other, other_gtids, n_events):
    """Every ticket SERVED over every event, its stream's final equal to
    its result, and its final identical to the other run's."""
    from repro_torch.core import merge as merge_lib
    if len(gtids) != len(other_gtids):
        raise AssertionError(f"{name}: {len(gtids)} tickets against "
                             f"{len(other_gtids)}")
    for a, b in zip(gtids, other_gtids):
        ta, tb = fleet.result(a), other.result(b)
        if ta.status != "SERVED" or tb.status != "SERVED":
            raise AssertionError(f"{name} ticket {a}: {ta.status}/"
                                 f"{tb.status}")
        if ta.result.n_processed != n_events:
            raise AssertionError(f"{name} ticket {a} processed "
                                 f"{ta.result.n_processed} events")
        if not merge_lib.results_identical(ta.result, tb.result):
            raise AssertionError(f"{name} ticket {a} ({ta.expr}): final "
                                 "differs from the comparison run")
        if not merge_lib.results_identical(
                fleet.stream(a).latest().result, ta.result):
            raise AssertionError(f"{name} ticket {a}: stream final != "
                                 "result")


def phase_fleet(store):
    """A fleet of front-ends on the spmd backend with the kernel, obs and
    single-flight on, over the one resident store, against the same fleet
    on the plain path."""
    t_phase = time.perf_counter()
    from repro_torch.fabric import Fleet, FragmentRegistry
    from repro_torch.obs.trace import validate_records

    def build(use_pallas):
        return Fleet(store, FLEET_WIDTH, registry=FragmentRegistry(),
                     backend="spmd",
                     backend_kwargs={"use_pallas": use_pallas}, obs=True,
                     single_flight=True, device="cuda")

    brick_bytes = sum(t.numel() * t.element_size()
                      for t in store.bricks[0].values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fleet = build(True)
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated() - before
    if added >= brick_bytes:
        raise AssertionError(f"building the fleet allocated {added} bytes, "
                             f"one brick is {brick_bytes}")
    backends = [record_windows(fe.service.backend)
                for fe in fleet.frontends]
    t0 = time.perf_counter()
    gtids, launches = counted(lambda: fleet_workload(fleet))
    wall = time.perf_counter() - t0
    scanned, kernel_events, n_chunks = kernel_chunks(backends)
    if launches["event_filter_batch"] <= 0 \
            or launches["event_filter_batch"] != n_chunks:
        raise AssertionError(
            f"the fleet launched event_filter_batch "
            f"{launches['event_filter_batch']} times for {n_chunks} chunks "
            f"of windows with kernel targets")
    if launches["event_filter"] != 0:
        raise AssertionError("the fleet launched the single-query "
                             "event_filter")
    if kernel_events != scanned or scanned == 0:
        raise AssertionError(f"fleet kernel_events {kernel_events} != "
                             f"events_scanned {scanned}")
    stats = fleet.fleet_stats()
    if stats["events_scanned"] != scanned:
        raise AssertionError(f"fleet_stats events_scanned "
                             f"{stats['events_scanned']} != {scanned}")
    records = fleet.trace_records()
    problems = validate_records(records)
    if problems:
        raise AssertionError(f"fleet trace: {problems[:3]}")
    plain = build(False)
    plain_gtids = fleet_workload(plain)
    check_finals("fleet", fleet, gtids, plain, plain_gtids, store.n_events)
    # one more dataset bump on a quiet fleet: the rounds until every
    # catalogue holds its epoch, against the documented bound
    bus_rounds = fleet.bus.round
    fleet.bump_dataset_version(0)
    gossip_rounds = 0
    while len({fe.catalog.dataset_epoch for fe in fleet.frontends}) > 1 \
            and gossip_rounds <= fleet.rounds_bound:
        fleet.pump()
        gossip_rounds += 1
    if gossip_rounds > fleet.rounds_bound:
        raise AssertionError(f"a dataset bump took more than "
                             f"{fleet.rounds_bound} gossip rounds")
    emit({"phase": "fleet", "phase_s": time.perf_counter() - t_phase,
          "frontends": FLEET_WIDTH,
          "tickets": len(gtids), "memory_added_bytes": added,
          "brick_bytes": brick_bytes, "launches": launches,
          "kernel_chunks": n_chunks, "events_scanned": scanned,
          "kernel_events": kernel_events, "wall_s": wall,
          "events_per_s": scanned / wall,
          "cache_hits": stats["cache_hits"], "l1_hits":
              stats["cache_hits"] - stats["l2_hits"],
          "l2_hits": stats["l2_hits"], "adopted": stats["adopted"],
          "lease_fallbacks": stats["lease_fallbacks"],
          "bus_rounds": bus_rounds, "gossip_rounds": gossip_rounds,
          "rounds_bound": fleet.rounds_bound,
          "trace_records": len(records),
          "results_identical_to_plain": True})
    fleet.close()
    plain.close()


def phase_failover(store):
    """Fleets of front-ends on the sim backend on the card, with the
    failure policy, gossip repair and a lossy seeded bus; a node leaves
    after a third of the queries.  The run as the launcher makes it
    (adaptive packets) is recorded and its log replayed; the same run on
    fixed packets is held against a run with no node leaving.  Only fixed
    packets partition the sweep the same way whichever nodes are alive,
    so only they give float merges equal to the last bit (adaptive
    packets follow the nodes' virtual times, and a float sum over other
    packets differs in its last bits, in the JAX package as here)."""
    t_phase = time.perf_counter()
    from repro_torch.fabric import Fleet, FragmentRegistry, MessageBus
    from repro_torch.obs.replay import replay_run

    def build(fixed_packets=False, flight=False):
        return Fleet(store_view(store), FLEET_WIDTH,
                     bus=MessageBus(drop_rate=FAILOVER_DROP_RATE, seed=0),
                     registry=FragmentRegistry(), backend="sim",
                     backend_kwargs=({"adaptive_packets": False}
                                     if fixed_packets else None),
                     obs=True, policy=True, gossip_repair=True,
                     flight=flight, device="cuda")

    fleet = build(flight=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gtids = fleet_workload(fleet, kill_node=FAILOVER_NODE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for g in gtids:
        t = fleet.result(g)
        if t.status != "SERVED" or t.result.n_processed != store.n_events:
            raise AssertionError(f"failover ticket {g}: {t.status}, "
                                 f"{t.result and t.result.n_processed} "
                                 "events")
    fleet._flight_finalize()
    records = list(fleet.flight.records)
    t0 = time.perf_counter()
    report = replay_run(records, store=store_view(store), device="cuda")
    replay_s = time.perf_counter() - t0
    if not report.identical:
        raise AssertionError(f"replay diverged: {report.mismatches[:3]} "
                             f"{report.bus_divergences[:3]}")
    fixed = build(fixed_packets=True)
    fixed_gtids = fleet_workload(fixed, kill_node=FAILOVER_NODE)
    calm = build(fixed_packets=True)
    calm_gtids = fleet_workload(calm)
    check_finals("failover", fixed, fixed_gtids, calm, calm_gtids,
                 store.n_events)
    states = fleet.policy_states()
    emit({"phase": "failover", "phase_s": time.perf_counter() - t_phase,
          "frontends": FLEET_WIDTH,
          "tickets": len(gtids), "node_left": FAILOVER_NODE,
          "drop_rate": FAILOVER_DROP_RATE, "bus_seed": 0,
          "policy_states": {fe: {str(n): s for n, s in st.items()}
                            for fe, st in states.items()},
          "rereplications": sum(1 for r in records
                                if r["kind"] == "rereplicate"),
          "served": len(gtids),
          "events_scanned": fleet.fleet_stats()["events_scanned"],
          "wall_s": wall, "replay_s": replay_s,
          "flight_records": len(records),
          "replay_finals": report.n_finals,
          "replay_snapshots": report.n_snapshots, "replay_identical": True,
          "fixed_packets_identical_to_calm_run": True})
    for f in (fleet, fixed, calm):
        f.close()


# --------------------------------------------------------------------- #
# LM serve and prefill
# --------------------------------------------------------------------- #
LM_KERNELS = ("flash_attention", "rglru_scan", "mlstm")
F32_UNIT = 2.0 ** -24         # f32's unit roundoff
SENS_KEYS = 64                # keys a row for flash_exact's sensitivity
# on ill-conditioned flash calls (shadow_kernels): each score may be off by
# SENS_KAPPA u |s|, twice the largest error of the plain version's f32
# scores (3.4 u |s| in cuBLAS's order, 4.5 u |s| with the head dim
# reversed; scripts/flash_conditioning.py on recurrentgemma-9b's forward),
# and the kernel's largest and mean errors against the exact value may be
# ERR_RATIO times the plain version's in the kernel's output dtype
SENS_KAPPA = 8.0
ERR_RATIO = 1.1


@contextlib.contextmanager
def plain_kernels(f32=False):
    """Inside the block every LM-path kernel call on a CUDA tensor takes
    the plain version: attention in the dense and hybrid models (both
    reach it through ``transformer.flash_attention``), the RG-LRU
    recurrence and the chunkwise mLSTM.  With ``f32`` the plain versions
    run on the same values upcast to f32 (the kernels' arithmetic) and
    cast their output back.  The comparison runs only, never the served
    path, whose calls launch the kernels."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import rglru, transformer, xlstm

    def flash_f32(q, k, v, **kw):
        return flash_attention_ref(q.float(), k.float(), v.float(),
                                   **kw).to(q.dtype)

    def mlstm_f32(q, k, v, log_i, log_f):
        return mlstm_plain_f32(q, k, v, log_i, log_f).to(q.dtype)

    swaps = ((transformer, "flash_attention",
              flash_f32 if f32 else flash_attention_ref),
             (rglru, "linear_scan", rglru_scan_ref),
             (xlstm, "mlstm_scan", mlstm_f32 if f32 else mlstm_ref))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def flash_exact(q, k, v, *, causal=True, window=None, scale=None,
                logit_cap=None, rows=256, sensitivity=False):
    """flash_attention's function evaluated in float64 (to ~1e-15), query
    rows in chunks: the exact value both the kernel and the plain version
    in f32 approximate.

    With ``sensitivity`` also returns, for each output element, how far it
    moves when every score s_j moves by u |s_j| (u = 2^-24, f32's unit
    roundoff), to first order: sum_j p_j u |s_j| |v_j - out|, over the
    SENS_KEYS keys of largest p_j |s_j| of the row, plus the rest's weight
    times max |v| + |out| as a bound.  A score held in f32 is off by at
    least its own rounding, u |s_j|, so an element whose sensitivity is
    comparable to FA_TOL is decided by rounding, not by the arithmetic."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kk = k.double().repeat_interleave(h // kh, dim=2)
    vv = v.double().repeat_interleave(h // kh, dim=2)
    v_max = float(vv.abs().max())
    k_pos = torch.arange(sk, device=q.device)[None, :]
    out = torch.empty((b, sq, h, d), dtype=torch.float64, device=q.device)
    sens = torch.empty_like(out) if sensitivity else None
    for i0 in range(0, sq, rows):
        qs = q[:, i0:i0 + rows].double()
        raw = torch.einsum("bqhd,bkhd->bhqk", qs, kk) * scale
        s = raw if logit_cap is None else \
            logit_cap * torch.tanh(raw / logit_cap)
        q_pos = torch.arange(i0, i0 + qs.shape[1], device=q.device)[:, None] \
            + (sk - sq if causal else 0)
        valid = torch.ones_like(s[0, 0], dtype=torch.bool)
        if causal:
            valid &= k_pos <= q_pos
        if window is not None:
            valid &= k_pos > q_pos - window
        s = s.masked_fill(~valid, float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, dim=-1))   # rows of no key: 0
        o = torch.einsum("bhqk,bkhd->bqhd", p, vv)
        out[:, i0:i0 + rows] = o
        if sensitivity:
            # a capped score moves no more than the raw one (tanh' <= 1)
            w = p * raw.abs() * F32_UNIT                  # (B, H, R, Sk)
            top, idx = w.topk(min(SENS_KEYS, sk), dim=-1)
            rest = (w.sum(-1) - top.sum(-1)).clamp(min=0)
            vsel = torch.gather(
                vv.permute(0, 2, 1, 3)[:, :, None].expand(
                    -1, -1, qs.shape[1], -1, -1), 3,
                idx[..., None].expand(-1, -1, -1, -1, d))   # (B,H,R,T,D)
            ob = o.permute(0, 2, 1, 3)                    # (B, H, R, D)
            dev = (vsel - ob[:, :, :, None]).abs()
            e = (top[..., None] * dev).sum(-2) + \
                rest[..., None] * (v_max + ob.abs())
            sens[:, i0:i0 + rows] = e.permute(0, 2, 1, 3)
    return (out, sens) if sensitivity else out


def well_conditioned_outside(out, want, exact, rtol, atol):
    """The elements of a flash call's kernel output ``out`` counted
    outside the tolerance on a well-conditioned call (the plain version in
    f32, ``want``, within FA_TOL of the exact value ``exact`` everywhere):
    those outside FA_TOL of ``want``, unless the kernel is nearer the exact
    value than ``want`` there, and so within FA_TOL of it too.  Returns
    (counted, the elements let through by that rule).  C-ref5's scores
    reach ~1e3 on models without qk-norm, where the plain version in f32
    moves by up to 8 times an element's score-rounding sensitivity: on an
    H100 80GB HBM3 at 700 W, chatglm3-6b's forward put it 0.019 from the exact
    value at 0.19, inside FA_TOL, with the kernel 0.008 from it on the
    other side, outside FA_TOL of the plain version."""
    o, w, e = out.double(), want.double(), exact
    off_plain = ~((o - w).abs() <= atol + rtol * w.abs())
    if not bool(off_plain.any()):
        return 0, 0
    nearer = (o - e).abs() < (w - e).abs()
    return int((off_plain & ~nearer).sum()), int((off_plain & nearer).sum())


@contextlib.contextmanager
def shadow_kernels():
    """Inside the block every LM-path kernel call still launches its
    kernel, whose output the path goes on with, and is then held against
    its plain version evaluated in f32 on the same inputs (FA_TOL,
    SCAN_TOL, MLSTM_TOL, elementwise): the per-call check of each kernel
    at the shapes and on the activations the path gives it; for
    flash_attention, where the kernel is outside FA_TOL of that plain
    version, it must be nearer the exact value than the plain version
    (``well_conditioned_outside``).  Yields the per-kernel tally (calls,
    elements outside the tolerance, max |difference|; for flash_attention
    on the well-conditioned calls also the elements let through and the
    kernel's largest error against the exact value, absolute and as a
    share of FA_TOL there).

    flash_attention is also evaluated exactly (``flash_exact``, f64).  A
    call whose plain version in f32 is itself outside FA_TOL of the exact
    value somewhere is ill-conditioned: its scores spread so wide (C-ref5:
    recurrentgemma-9b's forward, |s| to ~5e3) that the rounding of each
    score to f32 decides near-ties, so an evaluation without error fails
    the comparison with the plain version in f32 there.  On such a call
    each element of the kernel is held against the exact value instead,
    within FA_TOL plus SENS_KAPPA times the element's sensitivity to f32
    score rounding (``flash_exact``), and the kernel's largest and mean
    error against the exact value may be no more than ERR_RATIO times
    those of the plain version in f32 rounded to the kernel's output
    dtype.  Every other call is held against the plain version in f32 as
    before.  The tally keeps, for the ill-conditioned calls, the elements
    outside FA_TOL of the exact value (kernel, plain version), those where
    the kernel is outside it and the plain version inside, the elements
    of the kernel outside FA_TOL of the plain version in f32, and those of
    the exact value rounded to the output dtype."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import rglru, transformer, xlstm
    tally = {name: {"calls": 0, "outside": 0, "elements": 0,
                    "max_abs_err": 0.0} for name in LM_KERNELS}
    tally["flash_attention"].update(
        ill_conditioned_calls=0, ill_kernel_outside_exact=0,
        ill_plain_f32_outside_exact=0, ill_kernel_off_where_plain_on=0,
        ill_kernel_outside_plain_f32=0, ill_exact_outside_plain_f32=0,
        ill_max_err_ratio=0.0, ill_mean_err_ratio=0.0,
        kernel_off_plain_nearer_exact=0, well_max_err_exact=0.0,
        well_max_err_exact_over_tol=0.0)

    def off(out, want, rtol, atol):
        o, w = out.to(want.dtype), want
        return ~((o - w).abs() <= atol + rtol * w.abs())

    def outside(out, want, rtol, atol):
        return int(off(out, want, rtol, atol).sum())

    def record(name, out, want, rtol, atol, counted=None):
        o, w = out.float(), want.float()
        err = (o - w).abs()
        t = tally[name]
        t["calls"] += 1
        t["elements"] += err.numel()
        t["outside"] += outside(o, w, rtol, atol) if counted is None \
            else counted
        t["max_abs_err"] = max(t["max_abs_err"], float(err.max()))

    kern_fa, kern_scan, kern_mlstm = (transformer.flash_attention,
                                      rglru.linear_scan, xlstm.mlstm_scan)

    def flash(q, k, v, **kw):
        out = kern_fa(q, k, v, **kw)
        rtol, atol = FA_TOL[q.dtype]
        want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        exact = flash_exact(q, k, v, **kw)
        plain_off = off(want, exact, rtol, atol)
        if not bool(plain_off.any()):
            counted, nearer = well_conditioned_outside(out, want, exact,
                                                       rtol, atol)
            err = (out.double() - exact).abs()
            t = tally["flash_attention"]
            t["kernel_off_plain_nearer_exact"] += nearer
            t["well_max_err_exact"] = max(t["well_max_err_exact"],
                                          float(err.max()))
            t["well_max_err_exact_over_tol"] = max(
                t["well_max_err_exact_over_tol"],
                float((err / (atol + rtol * exact.abs())).max()))
            del err
        else:
            exact, sens = flash_exact(q, k, v, sensitivity=True, **kw)
            o = out.double()
            err = (o - exact).abs()
            counted = int((err > atol + rtol * exact.abs() +
                           SENS_KAPPA * sens).sum())
            kern_off = off(o, exact, rtol, atol)
            err_p = (want.to(out.dtype).double() - exact).abs()
            t = tally["flash_attention"]
            t["ill_conditioned_calls"] += 1
            t["ill_kernel_outside_exact"] += int(kern_off.sum())
            t["ill_plain_f32_outside_exact"] += int(plain_off.sum())
            t["ill_kernel_off_where_plain_on"] += int(
                (kern_off & ~plain_off).sum())
            t["ill_kernel_outside_plain_f32"] += outside(out, want, rtol,
                                                         atol)
            t["ill_exact_outside_plain_f32"] += outside(
                exact.to(out.dtype), want, rtol, atol)
            t["ill_max_err_ratio"] = max(t["ill_max_err_ratio"], float(
                err.max() / err_p.max()))
            t["ill_mean_err_ratio"] = max(t["ill_mean_err_ratio"], float(
                err.mean() / err_p.mean()))
            del sens, err, err_p
        del exact
        record("flash_attention", out, want, rtol, atol, counted=counted)
        return out

    def scan(a, b, h0=None):
        out = kern_scan(a, b, h0)
        record("rglru_scan", out[0], rglru_scan_ref(a, b, h0)[0], *SCAN_TOL)
        return out

    def mlstm(q, k, v, log_i, log_f):
        out = kern_mlstm(q, k, v, log_i, log_f)
        record("mlstm", out, mlstm_plain_f32(q, k, v, log_i, log_f),
               *MLSTM_TOL[q.dtype])
        return out

    swaps = ((transformer, "flash_attention", flash),
             (rglru, "linear_scan", scan), (xlstm, "mlstm_scan", mlstm))
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield tally
    finally:
        transformer.flash_attention = kern_fa
        rglru.linear_scan = kern_scan
        xlstm.mlstm_scan = kern_mlstm


def check_calls(name, tally):
    for kernel, t in tally.items():
        if t["outside"]:
            raise AssertionError(
                f"{name}: {t['outside']} of {t['elements']} elements of "
                f"{t['calls']} {kernel} calls outside the tolerance against "
                f"the plain version in f32 (on ill-conditioned flash calls: "
                f"against the exact value, FA_TOL plus the score-rounding "
                f"band), max err {t['max_abs_err']}; {t}")
    t = tally["flash_attention"]
    if max(t["ill_max_err_ratio"], t["ill_mean_err_ratio"]) > ERR_RATIO:
        raise AssertionError(
            f"{name}: on ill-conditioned calls the flash kernel's error "
            f"against the exact value exceeds {ERR_RATIO} times the plain "
            f"version's in the same dtype: {t}")


def compare_runs(cfg, kern, run, rows):
    """``kern``, the kernels' logits of a path, against ``run()`` (the
    same path) on the plain versions in the working dtype and in f32; the
    two plain runs against each other, which differ only in rounding (the
    path's own sensitivity); each as (max relative logit difference, top-1
    agreement) over ``rows(logits)``.  And the per-call check of the
    path's kernels."""
    def cmp(a, b):
        rel, top1 = compare_logits(rows(a), rows(b), cfg.vocab_size)
        return {"max_rel_logit_diff": max(rel), "top1_agreement": top1,
                "rel_logit_diff": rel}

    with plain_kernels():
        plain = run()
    with plain_kernels(f32=True):
        plain_f32 = run()
    out = {"plain": cmp(kern, plain), "plain_f32": cmp(kern, plain_f32),
           "plain_vs_plain_f32": cmp(plain, plain_f32)}
    del plain, plain_f32
    with shadow_kernels() as tally:
        run()
    out["per_call"] = tally
    return out


def summary(cmp):
    """The comparison without its per-row lists, for the phase line."""
    return {key: {k: v for k, v in val.items() if k != "rel_logit_diff"}
            for key, val in cmp.items() if key.startswith("plain")}


def e2e_gated(cfg, cmp) -> bool:
    """Whether a path's end-to-end logits are held against the plain
    versions: always for E2E_GATED; for E2E_IF_STABLE when the path's own
    two plain runs (bf16 and f32 plain versions) agree within LM_REL_TOL
    and LM_TOP1_MIN, so that a difference there is the kernels'."""
    if cfg.name in E2E_GATED:
        return True
    base = cmp["plain_vs_plain_f32"]
    return cfg.name in E2E_IF_STABLE and \
        base["max_rel_logit_diff"] <= LM_REL_TOL and \
        base["top1_agreement"] >= LM_TOP1_MIN


def check_runs(name, cfg, cmp):
    """The per-call check always; the end-to-end logits against the plain
    versions where the model is not chaotic (``e2e_gated``)."""
    check_calls(name, cmp["per_call"])
    if e2e_gated(cfg, cmp):
        check_logits(name, [cmp["plain"]["max_rel_logit_diff"]],
                     cmp["plain"]["top1_agreement"])


def lm_counted(run):
    """Run one LM path with the LM kernels' launch counts zeroed just
    before it and read just after it: (its output, its launches), with
    the flash_attention and mlstm calls also counted by the device kernel
    each took (``flash_attention.<variant>``, ``mlstm.<variant>``)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    counters = (fa_kernel.LAUNCHES, rg_kernel.LAUNCHES, ml_kernel.LAUNCHES)
    for c in (*counters, fa_kernel.VARIANT_CALLS, ml_kernel.VARIANT_CALLS):
        for key in c:
            c[key] = 0
    out = run()
    torch.cuda.synchronize()
    launches = {}
    for c in counters:
        launches.update(c)
    launches.update({f"flash_attention.{key}": n
                     for key, n in fa_kernel.VARIANT_CALLS.items()})
    launches.update({f"mlstm.{key}": n
                     for key, n in ml_kernel.VARIANT_CALLS.items()})
    return out, launches


def check_launches(name, got, want):
    if got != want:
        raise AssertionError(f"{name} launched {got}, expected {want}")


def lm_launches(rglru_scan=0, mlstm=0, **flash):
    """The launch counts of one LM path: flash_attention calls by the
    device kernel each takes (``decode=``, ``wgmma=``), and ``mlstm``
    calls, all on the tensor-core kernel."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    out = {"flash_attention": sum(flash.values()),
           "rglru_scan": rglru_scan, "mlstm": mlstm}
    out.update({f"flash_attention.{key}": flash.get(key, 0)
                for key in fa_kernel.VARIANTS})
    out.update({f"mlstm.{key}": mlstm if key == "wgmma" else 0
                for key in ml_kernel.VARIANTS})
    return out


def path_launches(cfg):
    """What each path of ``cfg``'s model must launch, counted from its
    pattern: ``generate`` (every decode step's attention layers, each on
    the GQA-packed decode kernel; whisper's cross-cache fill first, its
    encoder on the tensor-core kernel) and one ``forward`` (each
    attention, RG-LRU and mLSTM layer once, the attention and the mLSTM
    on their tensor-core kernels)."""
    from repro_torch.models import hybrid, xlstm
    steps = LM_PROMPT + LM_NEW
    if cfg.family == "hybrid":
        unit, n_super, tail = hybrid._pattern(cfg)
        n_attn = n_super * unit.count("attn")
        n_rec = n_super * unit.count("rec") + tail.count("rec")
        return (lm_launches(decode=n_attn * steps),
                lm_launches(wgmma=n_attn, rglru_scan=n_rec))
    if cfg.family == "ssm":
        unit, n_super = xlstm._pattern(cfg)
        return (lm_launches(),
                lm_launches(mlstm=n_super * unit.count("mlstm")))
    if cfg.family == "audio":
        # the encoder's self-attention; the decoder's self- and
        # cross-attention in every layer
        enc, dec = cfg.num_encoder_layers, 2 * cfg.num_layers
        return (lm_launches(wgmma=enc, decode=dec * steps),
                lm_launches(wgmma=enc + dec))
    return (lm_launches(decode=cfg.num_layers * steps),
            lm_launches(wgmma=cfg.num_layers))


def compare_logits(kern, plain, vocab):
    """Per leading index (a decode step, a prefill position): max |logit
    difference| over the plain logits' spread (max - min over the real
    vocab), and the share of rows whose argmax agrees."""
    k = kern[..., :vocab].float().flatten(1, -2)   # (N, rows, V)
    p = plain[..., :vocab].float().flatten(1, -2)
    if not bool(torch.isfinite(k).all()) or not bool(torch.isfinite(p).all()):
        raise AssertionError("non-finite logits")
    diff = (k - p).abs().amax(dim=(1, 2))
    spread = p.amax(dim=(1, 2)) - p.amin(dim=(1, 2))
    rel = (diff / spread).tolist()
    top1 = float((k.argmax(-1) == p.argmax(-1)).float().mean())
    return rel, top1


def check_logits(name, rel, top1):
    if max(rel) > LM_REL_TOL or top1 < LM_TOP1_MIN:
        raise AssertionError(
            f"{name}: kernels vs plain versions max rel logit difference "
            f"{max(rel)} (limit {LM_REL_TOL}), top-1 agreement {top1} "
            f"(at least {LM_TOP1_MIN})")


def build_lm(arch):
    """``arch`` at full width on the card (at ``LM_LAYERS`` depth where the
    published one does not fit), weights from a seeded generator, held by
    ``LanguageModel``: (cfg, model facade, parameter tree)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_zoo
    cfg = get_config(arch)
    if arch in LM_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=LM_LAYERS[arch])
    model = model_zoo.build_model(cfg)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = model_zoo.LanguageModel(model, model.table.init(gen, DEVICE))
    torch.cuda.synchronize()
    emit({"phase": "model", "arch": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers,
          "published_layers": get_config(arch).num_layers,
          "encoder_layers": cfg.num_encoder_layers,
          "encoder_seq_len": cfg.encoder_seq_len
          if cfg.is_encoder_decoder else 0,
          "experts": [cfg.num_experts, cfg.num_experts_per_tok],
          "patches": cfg.num_patches, "d_model": cfg.d_model,
          "q_heads": [cfg.num_heads, cfg.num_heads_padded],
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "lru_width": cfg.lru_width,
          "attention_window": cfg.attention_window,
          "xlstm_pattern": list(cfg.xlstm_pattern),
          "vocab_padded": cfg.vocab_padded,
          "dtype": cfg.param_dtype, "params": model.table.num_params(),
          "param_gb": model.table.bytes() / 1e9,
          "resident_gb": torch.cuda.memory_allocated() / 1e9,
          "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "init_s": time.perf_counter() - t0})
    return cfg, model, lm.tree()


def lm_start(cfg, model, params):
    """A function giving the decode state a generate or a replay starts
    from: None (the model's own empty cache), or for an encoder-decoder
    a fresh cache whose cross-attention K/V the encoder filled from the
    same seeded stub frames each time (so the encoder runs on whatever
    kernels the caller's block swapped in)."""
    from repro_torch.launch.serve import encoder_cache
    if not cfg.is_encoder_decoder:
        return lambda: None

    def start():
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(5)
        return encoder_cache(cfg, model, params, LM_BATCH, gen)[0]
    return start


def stub_inputs(cfg, batch, gen) -> dict:
    """The family's stub inputs for ``batch`` rows, standard normal from
    ``gen`` in ``cfg.dtype``: pixtral's 256 patch embeddings, whisper's
    1500 encoder frames (none for the other families)."""
    from repro_torch.models.params import torch_dtype
    rows = {"patch_embeds": cfg.num_patches,
            "frames": cfg.encoder_seq_len if cfg.is_encoder_decoder else 0}
    return {key: torch.randn((batch, n, cfg.d_model), generator=gen,
                             device=DEVICE).to(torch_dtype(cfg.dtype))
            for key, n in rows.items() if n}


def forward_inputs(cfg, length):
    """One forward's batch over ``length`` tokens and the family's stub
    inputs (``stub_inputs``), from a seeded generator."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, length),
                                     generator=gen, device=DEVICE)}
    batch.update(stub_inputs(cfg, 1, gen))
    return batch


def replay(cfg, model, params, seq, cache=None):
    """Teacher-forced decode of ``seq`` (B, S) from ``cache`` (None: an
    empty one): the logits of every step, (S, B, Vp) f32."""
    if cache is None:
        cache = model.init_cache(seq.shape[0], 256, DEVICE)
    steps = []
    for s in range(seq.shape[1]):
        logits, cache = model.decode_step(params, cache, seq[:, s:s + 1])
        steps.append(logits[:, -1].float())
    return torch.stack(steps)


@torch.inference_mode()
def phase_lm(cfg, model, params):
    """generate() through the kernels, its launch counts, tok/s, and the
    teacher-forced comparison with the plain versions."""
    from repro_torch.launch.serve import generate
    start = lm_start(cfg, model, params)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=DEVICE)
    generate(cfg, model, params, prompt, max_new_tokens=2,
             cache=start())   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens, launches = lm_counted(lambda: generate(
        cfg, model, params, prompt, max_new_tokens=LM_NEW, cache=start()))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check_launches(f"{cfg.name} generate", launches, path_launches(cfg)[0])
    if tuple(tokens.shape) != (LM_BATCH, LM_NEW) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(tokens.shape)} or "
                             "ids outside the vocab")

    seq = torch.cat([prompt, tokens], dim=1)   # what the 24 steps were fed
    kern = replay(cfg, model, params, seq, start())
    pred = kern[..., :cfg.vocab_size].argmax(-1)       # (steps, B)
    if not torch.equal(pred[LM_PROMPT - 1:LM_PROMPT - 1 + LM_NEW].T, tokens):
        raise AssertionError("the kernels' teacher-forced replay does not "
                             "give generate()'s tokens")
    cmp = compare_runs(cfg, kern,
                       lambda: replay(cfg, model, params, seq, start()),
                       lambda logits: logits)
    check_runs(f"{cfg.name} serve", cfg, cmp)
    profile_run("lm_profile", lambda: generate(
        cfg, model, params, prompt, max_new_tokens=LM_NEW, cache=start()),
        arch=cfg.name)
    emit({"phase": "lm", "arch": cfg.name, "batch": LM_BATCH,
          "prompt": LM_PROMPT, "new_tokens": LM_NEW,
          "decode_steps": LM_PROMPT + LM_NEW,
          "flash_attention_launches": launches["flash_attention"],
          "launches": launches, "wall_s": wall,
          "tok_per_s": LM_BATCH * LM_NEW / wall,
          "ms_per_decode_step": wall / (LM_PROMPT + LM_NEW) * 1e3,
          "peak_memory_gb": peak / 1e9,
          "phase_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "rel_logit_diff_per_step": cmp["plain"]["rel_logit_diff"],
          "top1_agreement": cmp["plain"]["top1_agreement"],
          "end_to_end_gated": e2e_gated(cfg, cmp), **summary(cmp),
          "per_call": cmp["per_call"], "sample": tokens[0].tolist()})
    return launches


@torch.inference_mode()
def phase_prefill(cfg, model, params):
    """One forward() over 1 x FORWARD_LEN tokens through the kernels
    (each attention, RG-LRU and mLSTM layer launches once), compared with
    the same forward on the plain versions."""
    length = FORWARD_LEN[cfg.name]
    batch = forward_inputs(cfg, length)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (logits, aux), launches = lm_counted(
        lambda: model.forward(params, batch))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check_launches(f"{cfg.name} forward", launches, path_launches(cfg)[1])
    if not bool(torch.isfinite(aux)):
        raise AssertionError(f"{cfg.name} forward: aux loss {aux}")
    # each position is one row of the comparison
    cmp = compare_runs(cfg, logits,
                       lambda: model.forward(params, batch)[0],
                       lambda x: x[0][:, None])
    del logits
    check_runs(f"{cfg.name} forward", cfg, cmp)
    emit({"phase": "prefill", "arch": cfg.name, "tokens": length,
          "inputs": {k: list(v.shape) for k, v in batch.items()},
          "aux_loss": float(aux),
          "flash_attention_launches": launches["flash_attention"],
          "launches": launches, "wall_s": wall, "tok_per_s": length / wall,
          "peak_memory_gb": peak / 1e9,
          "phase_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "max_rel_logit_diff": cmp["plain"]["max_rel_logit_diff"],
          "top1_agreement": cmp["plain"]["top1_agreement"],
          "end_to_end_gated": e2e_gated(cfg, cmp), **summary(cmp),
          "per_call": cmp["per_call"]})
    return launches


@torch.inference_mode()
def phase_recurrent_tie(cfg, model, params):
    """The forward's logits through the mLSTM kernel against a
    teacher-forced decode of the same tokens (the recurrent form, no
    kernel launch): each position is one row of the comparison.  Beside
    it the same tie with the plain mLSTM in f32, the path's own
    sensitivity; reported, not gated (E2E_GATED).  The decode must launch
    no kernel."""
    length = min(TIE_LEN, FORWARD_LEN[cfg.name])
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, length), generator=gen,
                         device=DEVICE)
    t0 = time.perf_counter()
    steps, launches = lm_counted(lambda: replay(cfg, model, params, toks))
    wall = time.perf_counter() - t0
    check_launches(f"{cfg.name} decode", launches, lm_launches())
    ties = {}
    for key, ctx in (("kernel", contextlib.nullcontext()),
                     ("plain_f32", plain_kernels(f32=True))):
        with ctx:
            logits, _ = model.forward(params, {"tokens": toks})
        rel, top1 = compare_logits(logits[0][:, None], steps,
                                   cfg.vocab_size)
        first = next((i for i, r in enumerate(rel) if r > LM_REL_TOL), None)
        ties[key] = {"max_rel_logit_diff": max(rel), "top1_agreement": top1,
                     "first_position_over_tol": first,
                     "rel_at": {p: rel[p] for p in (0, 15, 63, 255, 1023,
                                                    length - 1)
                                if p < length}}
        del logits
    emit({"phase": "recurrent_tie", "arch": cfg.name, "tokens": length,
          "decode_wall_s": wall, "decode_launches": launches, **ties})


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def shadow_backward():
    """Inside the block every backward kernel call of B3, B4 and B5 still
    launches its kernel, whose gradients the step goes on with, and is
    then held against its plain backward in f32 on the same inputs: max
    |kernel - plain| <= BWD_TOL * max |plain| for each gradient
    (``flash_attention_bwd_ref``: dq, dk, dv; ``rglru_scan_bwd_ref``: da,
    db, dh0, the kernel also bit-equal to ``rglru_scan_bwd_chunked_ref``;
    ``mlstm_bwd_ref``: dq, dk, dv, d log_i, d log_f, evaluated on the
    forward launch's row stats, which are held against the plain ones
    first, ``mlstm_stats_check``: where |den| and exp(-m) tie the two sides
    of max(|den|, exp(-m)) give different gradients, and the backward
    follows the side its forward took).  A call on which that plain
    backward is itself outside BWD_TOL of the f64 evaluation is
    ill-conditioned and is held against the f64 value instead.  Yields
    the tally, one entry a kernel."""
    from repro_torch.kernels.flash_attention import backward as fa_backward
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    from repro_torch.kernels.mlstm_scan import backward as ml_backward
    from repro_torch.kernels.mlstm_scan.ref import mlstm_bwd_ref
    from repro_torch.kernels.rglru_scan import backward as rg_backward
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan.ref import (
        rglru_scan_bwd_chunked_ref, rglru_scan_bwd_ref)
    tally = {name: {"calls": 0, "outside": 0, "ill_conditioned_calls": 0,
                    "max_rel_err": 0.0, "max_rel_err_plain_f32_vs_f64": 0.0,
                    "check_s": 0.0}
             for name in ("flash_attention_bwd", "rglru_scan_bwd",
                          "mlstm_bwd")}
    tally["rglru_scan_bwd"]["not_bit_equal_chunked_ref"] = 0
    tally["mlstm_bwd"].update(stats_err_over_band=0.0, stats_tie_rows=0)

    @contextlib.contextmanager
    def checking(name):
        """The seconds of a call's checks, after its kernel has finished,
        into the tally's ``check_s``."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        tally[name]["check_s"] += time.perf_counter() - t0

    def record(name, got, plain, dtype):
        """plain(cast) evaluates the plain backward on the call's inputs
        cast to f32 or f64; the kernel's gradients against it."""
        with torch.no_grad():
            want = plain(lambda x: None if x is None else x.float())
            exact = plain(lambda x: None if x is None else x.double())
            tol = BWD_TOL[dtype]
            pairs = [(w, e) for w, e in zip(want, exact) if w is not None]
            plain_off = [rel_err(w, e) for w, e in pairs]
            ill = max(plain_off) > tol
            errs = [rel_err(g, r) for g, r in zip(
                [g for g in got if g is not None],
                [e if ill else w for w, e in pairs])]
        t = tally[name]
        t["calls"] += 1
        t["ill_conditioned_calls"] += int(ill)
        t["outside"] += sum(e > tol for e in errs)
        t["max_rel_err"] = max(t["max_rel_err"], *errs)
        t["max_rel_err_plain_f32_vs_f64"] = max(
            t["max_rel_err_plain_f32_vs_f64"], *plain_off)

    kern_fa = fa_backward.flash_attention_bwd_cuda
    kern_rg = rg_backward.rglru_scan_bwd_cuda
    kern_ml = ml_backward.mlstm_bwd_cuda

    def fa_bwd(q, k, v, out, dout, lse, **kw):
        got = kern_fa(q, k, v, out, dout, lse, **kw)
        with checking("flash_attention_bwd"):
            record("flash_attention_bwd", got,
                   lambda c: flash_attention_bwd_ref(
                       *(c(x) for x in (q, k, v, out, dout)), rows=BWD_ROWS,
                       **kw), q.dtype)
        return got

    def rg_bwd(a, h, dy, dh_last=None, h0=None):
        got = kern_rg(a, h, dy, dh_last, h0)
        with checking("rglru_scan_bwd"):
            record("rglru_scan_bwd", got, lambda c: rglru_scan_bwd_ref(
                *(c(x) for x in (a, h, dy, dh_last, h0))), torch.float32)
            emul = rglru_scan_bwd_chunked_ref(
                a, h, dy, dh_last, h0, chunk=rg_kernel.plan(*a.shape).chunk)
            tally["rglru_scan_bwd"]["not_bit_equal_chunked_ref"] += sum(
                not torch.equal(g, e) for g, e in zip(got, emul)
                if g is not None)
        return got

    def ml_bwd(q, k, v, log_i, log_f, out, dout, lse, sg):
        got = kern_ml(q, k, v, log_i, log_f, out, dout, lse, sg)
        with checking("mlstm_bwd"):
            ratio, ties = mlstm_stats_check(q, k, v, log_i, log_f, lse, sg,
                                            "mlstm train call")
            t = tally["mlstm_bwd"]
            t["stats_err_over_band"] = max(t["stats_err_over_band"], ratio)
            t["stats_tie_rows"] += ties
            record("mlstm_bwd", got, lambda c: mlstm_bwd_ref(
                *(c(x) for x in (q, k, v, log_i, log_f, out, dout)),
                (c(lse), c(sg)), rows=BWD_ROWS), q.dtype)
        return got

    swaps = ((fa_backward, "flash_attention_bwd_cuda", fa_bwd),
             (rg_backward, "rglru_scan_bwd_cuda", rg_bwd),
             (ml_backward, "mlstm_bwd_cuda", ml_bwd))
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield tally
    finally:
        fa_backward.flash_attention_bwd_cuda = kern_fa
        rg_backward.rglru_scan_bwd_cuda = kern_rg
        ml_backward.mlstm_bwd_cuda = kern_ml


def train_config(arch):
    """The config ``arch`` trains at in the train phase (TRAIN_ARCHS): full
    width, its depth and microbatches as cut there."""
    from repro_torch.configs.registry import get_config
    spec = TRAIN_ARCHS[arch]
    cfg = get_config(arch)
    if "layers" in spec:
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    for field in ("microbatches", "remat_segments"):
        if field in spec:
            cfg = dataclasses.replace(cfg, **{field: spec[field]})
    return cfg


def train_state_bytes(cfg) -> int:
    """Bytes a parameter of ``cfg``'s training state holds: the param and
    one microbatch's gradient in ``param_dtype``, the two moments in
    ``opt_moment_dtype`` and the gradient sum in ``grad_accum_dtype``,
    f32 with one microbatch (``steps.accum_dtype``)."""
    from repro_torch.models.params import torch_dtype
    from repro_torch.train.steps import accum_dtype
    return 2 * torch_dtype(cfg.param_dtype).itemsize + \
        2 * torch_dtype(cfg.opt_moment_dtype).itemsize + \
        accum_dtype(cfg).itemsize


def padded_nonzero(table, trees) -> dict:
    """Elements of the zero-padded slots of ``table``'s leaves
    (``ParamDef.zero_pad``: the padded q heads' columns of wq and rows of
    wo) that are not exactly zero (a NaN counts, -0 does not), by tree
    name and path, in each of ``trees`` (name -> a tree of the table's
    paths: the params, the moments)."""
    from repro_torch.models.params import _flatten
    out = {}
    for name, tree in trees.items():
        flat = _flatten(tree)
        for path, d in table.defs.items():
            if d.zero_pad is not None:
                axis, real = d.zero_pad
                x = flat[path]
                out[f"{name}/{path}"] = int(torch.count_nonzero(
                    x.narrow(axis, real, x.shape[axis] - real)))
    return out


def train_launches(cfg, steps):
    """What ``steps`` train steps of ``cfg`` must launch, each kernel and
    each variant.  Per microbatch each attention layer runs the flash
    forward (tensor cores, lse) and backward (the tensor-core variant),
    each recurrent layer the RG-LRU scan and its backward, each mLSTM
    layer the mLSTM (tensor cores, stats) and its backward (the
    tensor-core variant at head dim 512), the backwards once.  Under remat
    (``cfg.remat_policy`` not "none") every checkpointed layer's forward
    runs twice: the step's forward and the recompute in the backward.
    The dense, moe and vlm families checkpoint each layer, the hybrid and
    ssm families each super-block; the hybrid family's tail is not
    checkpointed, and the audio family (the encoder-decoder) checkpoints
    nothing, as the reference: its encoder's self-attention and each
    decoder layer's self- and cross-attention run once.

    Two-level remat (``cfg.remat_segments`` = G > 1, the dense, moe and
    vlm families' ``transformer.run_layers``) checkpoints G segments of
    L / G layers around the layers' own checkpoints.  The backward of a
    segment first recomputes it from its input, and PyTorch stops that
    recompute once the last tensor the segment saved is back: the input
    its last layer's checkpoint saved, before that layer runs.  So the
    segment's recompute runs L / G - 1 layers, and each layer's own
    checkpoint recomputes it once more: 3 L - G forwards a microbatch
    (2 L with remat "none", whose segment recompute runs every layer)."""
    from repro_torch.models import hybrid, xlstm
    calls = max(1, cfg.microbatches) * steps
    again = 1 if cfg.remat_policy == "none" else 2
    bwd = {"flash_attention_bwd.wgmma": 0, "flash_attention_bwd.simt": 0,
           "rglru_scan_bwd": 0, "mlstm_bwd": 0, "mlstm_bwd.wgmma": 0,
           "mlstm_bwd.simt": 0}
    if cfg.family == "hybrid":
        unit, n_super, tail = hybrid._pattern(cfg)
        attn = n_super * unit.count("attn") * calls
        rec_super = n_super * unit.count("rec") * calls
        rec = rec_super + tail.count("rec") * calls
        return {**lm_launches(rglru_scan=rec + (again - 1) * rec_super,
                              wgmma=again * attn), **bwd,
                "flash_attention_bwd": attn,
                "flash_attention_bwd.wgmma": attn, "rglru_scan_bwd": rec}
    if cfg.family == "ssm":
        unit, n_super = xlstm._pattern(cfg)
        ml = n_super * unit.count("mlstm") * calls
        return {**lm_launches(mlstm=again * ml), **bwd,
                "flash_attention_bwd": 0, "mlstm_bwd": ml,
                "mlstm_bwd.wgmma": ml}
    if cfg.family == "audio":
        calls *= cfg.num_encoder_layers + 2 * cfg.num_layers
        fwd = calls
    else:
        n, g = cfg.num_layers, cfg.remat_segments
        if g <= 1:          # one level: the forward, and again under remat
            fwd = again * n
        elif again == 1:    # segments alone: each recompute runs every layer
            fwd = 2 * n
        else:               # two levels: a segment's recompute stops early
            fwd = 3 * n - g
        fwd *= calls
        calls *= n
    return {**lm_launches(wgmma=fwd), **bwd,
            "flash_attention_bwd": calls,
            "flash_attention_bwd.wgmma": calls}


def train_counted(run):
    """``run()`` with the LM kernels' launch counts (forwards and
    backwards, flash_attention's and the mLSTM backward's also by variant)
    zeroed just before it and read just after."""
    from repro_torch.kernels.flash_attention import backward as fa_backward
    from repro_torch.kernels.mlstm_scan import backward as ml_backward
    from repro_torch.kernels.rglru_scan import backward as rg_backward
    counters = (fa_backward.LAUNCHES, fa_backward.VARIANT_CALLS,
                rg_backward.LAUNCHES, ml_backward.LAUNCHES,
                ml_backward.VARIANT_CALLS)
    for c in counters:
        for key in c:
            c[key] = 0
    out, launches = lm_counted(run)              # zeroes the others
    launches["flash_attention_bwd"] = \
        fa_backward.LAUNCHES["flash_attention_bwd"]
    launches.update({f"flash_attention_bwd.{key}": n
                     for key, n in fa_backward.VARIANT_CALLS.items()})
    launches.update(rg_backward.LAUNCHES)
    launches.update(ml_backward.LAUNCHES)
    launches.update({f"mlstm_bwd.{key}": n
                     for key, n in ml_backward.VARIANT_CALLS.items()})
    return out, launches


def train_pipeline(cfg, batch, seq=TRAIN_SEQ):
    """The trainer's brick pipeline: 4 data nodes, 8 bricks of a whole
    global batch each, ``batch`` x ``seq`` tokens a batch."""
    from repro_torch.core.catalog import MetadataCatalog
    from repro_torch.data.pipeline import BrickDataPipeline, TokenBrickStore
    store = TokenBrickStore(vocab_size=cfg.vocab_size, seq_len=seq,
                            n_bricks=8, seqs_per_brick=batch, n_nodes=4)
    return BrickDataPipeline(store, MetadataCatalog(4),
                             global_batch=batch, device=DEVICE)


def train_batches(cfg, batch, seq, n):
    """``n`` global batches from the brick pipeline, each with the
    family's stub inputs (``stub_inputs``) from one seeded generator."""
    pipe = train_pipeline(cfg, batch, seq)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(6)
    return [{**pipe.next_device_batch(), **stub_inputs(cfg, batch, gen)}
            for _ in range(n)]


#: kernels listed on their own in each family's profiled step
_ATTN_BREAKDOWN = ("fa_bwd_", "flash_wgmma_kernel")
TRAIN_BREAKDOWN = {"dense": _ATTN_BREAKDOWN, "moe": _ATTN_BREAKDOWN,
                   "vlm": _ATTN_BREAKDOWN, "audio": _ATTN_BREAKDOWN,
                   "hybrid": _ATTN_BREAKDOWN + ("rglru_chunked_kernel",),
                   "ssm": ("mlstm_bwd_", "mlstm_wgmma_kernel",
                           "mlstm_gates_kernel")}


def phase_train(arch):
    """``arch`` trained at full width (TRAIN_ARCHS: its depth, global batch,
    steps and remat segments as cut there) through make_train_step: bf16
    params, the moments in the config's ``opt_moment_dtype`` and the sum
    over its microbatches in its ``grad_accum_dtype`` (f32 but grok-1's
    bf16; f32 with one microbatch), global batches of TRAIN_SEQ tokens a
    row from the brick pipeline.  Launch counts by
    kernel and variant (train_launches); every backward kernel call of
    step 1 held against its plain backward (shadow_backward); loss and
    grad norm finite every step; step 1's loss and grad norm against the
    same step on the plain versions (bf16, and f32 on the same values),
    each gated within TRAIN_REL_TOL where the two plain runs agree on it
    (always for E2E_GATED's qk-norm models); a config with padded q
    heads leaves their weights and moments exactly zero after every step
    (``padded_nonzero``); for PEAK_GATED the peak after step 1 within
    PEAK_RATIO of the dry run's prediction, and at most PEAK_MAX_GB.
    The state is ``train_state_bytes`` a param (``train_state_gb``):
    for starcoder2-3b 6.74 GB bf16 params + 26.96 GB f32 moments + 13.48
    GB f32 gradient sum + 6.74 GB bf16 microbatch grads = 53.9 GB, plus
    the logits' f32 copies (~0.8 GB each, a few) and one layer's
    recompute: ~59 GB; for recurrentgemma-9b at 15 layers (remat "full")
    64.3 GB of state, the logits (~2.1 GB an f32 copy at 2048 x 256,000)
    and one super-block's recompute: ~70-74 GB; for grok-1 at 1 layer
    10 bytes a param (bf16 moments and sum), 65.3 GB; measured and
    reported beside the card's memory.  The cells but
    xlstm-350m's are dry-run on meta before their steps: the predicted
    peak (arguments and temps) beside the measured one.  With one step
    (xlstm-350m), ms a step is step 1's wall less the seconds of its
    backward checks."""
    from repro_torch.launch import dryrun
    from repro_torch.models import model_zoo
    from repro_torch.optim.adamw import AdamW, global_norm, init_opt_state
    from repro_torch.train import steps as steps_lib
    spec = TRAIN_ARCHS[arch]
    batch, steps = spec["batch"], spec["steps"]
    seq = spec.get("seq", TRAIN_SEQ)
    cfg = train_config(arch)
    lowered = None
    if cfg.family != "ssm":
        # the dry run's prediction, before the steps
        lowered = dryrun.predict(cfg, dryrun.cell("train", seq, batch))
        emit({"phase": "dryrun_predict", "arch": cfg.name,
              "cell": lowered[0]["shape"], "meta_s": lowered[0]["lower_s"],
              "predicted_peak_gb": lowered[0]["predicted_peak_bytes"] / 1e9,
              "memory": lowered[0]["memory"]})
    model = model_zoo.build_model(cfg)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = model.table.init(gen, DEVICE)
    n = model.table.num_params()
    from repro_torch.configs.registry import get_config
    emit({"phase": "model", "arch": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers,
          "published_layers": get_config(arch).num_layers,
          "d_model": cfg.d_model,
          "q_heads": [cfg.num_heads, cfg.num_heads_padded],
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "vocab_padded": cfg.vocab_padded,
          "encoder_layers": cfg.num_encoder_layers,
          "experts": [cfg.num_experts, cfg.num_experts_per_tok],
          "patches": cfg.num_patches, "seq_len": seq,
          "microbatches": cfg.microbatches, "remat": cfg.remat_policy,
          "remat_segments": cfg.remat_segments,
          "published_remat_segments": get_config(arch).remat_segments,
          "published_microbatches": get_config(arch).microbatches,
          "opt_moment_dtype": cfg.opt_moment_dtype,
          "grad_accum_dtype": cfg.grad_accum_dtype,
          "logit_cap": cfg.attn_logit_softcap,
          "params": n, "param_gb": model.table.bytes() / 1e9,
          "train_state_gb": n * train_state_bytes(cfg) / 1e9})
    batches = train_batches(cfg, batch, seq, steps + 1)

    # step 1's loss and grad norm on the plain path, from the same params
    # and batch: bf16 and f32 plain versions (the path's own sensitivity)
    grads_fn = steps_lib.make_grads_fn(dataclasses.replace(
        cfg, microbatches=spec.get("plain_microbatches", cfg.microbatches)),
        model)
    plain = {}
    for key, f32 in (("plain", False), ("plain_f32", True)):
        with plain_kernels(f32=f32):
            grads, _, met = grads_fn(params, batches[0])
            plain[key] = {"loss": float(met["loss"]),
                          "grad_norm": float(global_norm(grads))}
        del grads
        release()

    opt = AdamW(moment_dtype=cfg.opt_moment_dtype)
    opt_state = init_opt_state(params, opt)
    step_fn = steps_lib.make_train_step(cfg, model, opt, lr=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, walls, shadow, peaks = [], [], {}, []
    # the zero-padded q heads' elements of wq, wo and both moments that
    # are not exactly zero after each step (starcoder2-3b's 8 of 32,
    # qwen3-14b's 8 of 48)
    padded = any(d.zero_pad for d in model.table.defs.values())
    pad_nz = []

    def run():
        nonlocal params, opt_state
        for i in range(steps):
            ctx = shadow_backward() if i == 0 else contextlib.nullcontext()
            torch.cuda.synchronize()
            if i == 1:
                # step 1's peak holds its backward checks' plain versions
                peaks.append(torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with ctx as tally:
                params, opt_state, m = step_fn(params, opt_state, batches[i])
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if tally is not None:
                shadow.update(tally)
            metrics.append({k: float(v) for k, v in m.items()})
            if padded:
                pad_nz.append(padded_nonzero(model.table, {
                    "params": params, "m": opt_state["m"],
                    "v": opt_state["v"]}))

    from repro_torch.kernels.adamw import kernel as adamw_kernel
    fused = adamw_kernel.launches()
    _, launches = train_counted(run)
    fused = adamw_kernel.launches() - fused
    # the steps' peak, and that of the steps after step 1 (None with one)
    peak_after = torch.cuda.max_memory_allocated() if peaks else None
    peak = max(peaks + [torch.cuda.max_memory_allocated()])
    check_launches(f"{cfg.name} train", launches, train_launches(cfg, steps))
    # AdamW's passes: a norm and an update a non-empty leaf, a final sum
    leaves = sum(1 for d in model.table.defs.values()
                 if math.prod(d.shape))
    check_launches(f"{cfg.name} train adamw", {"adamw": fused},
                   {"adamw": steps * (2 * leaves + 1)})
    for i, m in enumerate(metrics):
        if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"{cfg.name} train step {i + 1}: {m}")
    if any(sum(nz.values()) for nz in pad_nz):
        raise AssertionError(f"{cfg.name} train: padded-head elements not "
                             f"exactly zero after each step: {pad_nz}")
    predicted = None
    if lowered is not None:
        mem = lowered[0]["memory"]
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    if arch in PEAK_GATED:
        lo, hi = PEAK_RATIO
        if not (peak_after is not None and
                lo <= peak_after / predicted <= hi and
                peak <= PEAK_MAX_GB * 1e9):
            raise AssertionError(
                f"{cfg.name} train: peak after step 1 {peak_after} B, over "
                f"all steps {peak} B, against the dry run's {predicted} B "
                f"(within {PEAK_RATIO} of it, at most {PEAK_MAX_GB} GB)")
    if any(t["outside"] for t in shadow.values()) or \
            shadow["rglru_scan_bwd"]["not_bit_equal_chunked_ref"]:
        raise AssertionError(f"{cfg.name} train: backward calls outside "
                             f"BWD_TOL: {shadow}")
    first = metrics[0]
    ref = plain["plain_f32"]

    def rel(a, b):
        return abs(a - b) / abs(b)

    e2e = {key: {"kernel": first[key], "plain": plain["plain"][key],
                 "plain_f32": ref[key],
                 "kernel_vs_plain_f32": rel(first[key], ref[key]),
                 "plain_vs_plain_f32": rel(plain["plain"][key], ref[key])}
           for key in ("loss", "grad_norm")}
    gated = {k: arch in E2E_GATED or
             v["plain_vs_plain_f32"] <= TRAIN_REL_TOL
             for k, v in e2e.items()}
    off = {k: v for k, v in e2e.items()
           if gated[k] and v["kernel_vs_plain_f32"] > TRAIN_REL_TOL}
    if off:
        raise AssertionError(f"{cfg.name} train step 1: kernel path off "
                             f"the plain path in f32 by more than "
                             f"{TRAIN_REL_TOL}: {off}")
    # the kernels by name: the flash forward and the backward's kernels,
    # the RG-LRU scan's two instances, the mLSTM's forward and backward
    # xlstm-350m's step launches ~630,000 kernels (the sLSTM's loop): its
    # profile records the device activity alone
    host_ops = cfg.family != "ssm"
    prof = profile_run("train_profile", lambda: step_fn(params, opt_state,
                                                        batches[-1]),
                       breakdown=TRAIN_BREAKDOWN[cfg.family],
                       host_ops=host_ops, arch=cfg.name,
                       host_ops_recorded=host_ops)
    # step 1 runs under shadow_backward: with one step, its wall less the
    # seconds of its checks (each after its kernel has finished)
    step_s = sum(walls[1:]) / len(walls[1:]) if steps > 1 else \
        walls[0] - sum(t["check_s"] for t in shadow.values())
    total = torch.cuda.get_device_properties(0).total_memory
    emit({"phase": "train", "arch": cfg.name, "steps": steps,
          "global_batch": batch, "seq_len": seq,
          "microbatches": cfg.microbatches, "lr": TRAIN_LR,
          "remat": cfg.remat_policy, "remat_segments": cfg.remat_segments,
          "launches": launches, "adamw_launches": fused,
          "metrics": metrics, "step_wall_s": walls,
          "ms_per_step": step_s * 1e3,
          "ms_per_step_from": "steps 2 on" if steps > 1 else
          "step 1 less its backward checks",
          "tokens_per_s": batch * seq / step_s,
          "profiled_step_wall_ms": prof["wall_s"] * 1e3,
          "peak_memory_gb": peak / 1e9,
          "peak_after_step1_gb": None if peak_after is None
          else peak_after / 1e9,
          "predicted_peak_gb": None if predicted is None
          else predicted / 1e9, "peak_gated": arch in PEAK_GATED,
          "padded_nonzero_after_step": [sum(nz.values()) for nz in pad_nz]
          if padded else None,
          "card_memory_gb": total / 1e9,
          "free_at_peak_gb": (total - peak) / 1e9, "step1_vs_plain": e2e,
          "plain_microbatches": spec.get("plain_microbatches",
                                         cfg.microbatches),
          "end_to_end_gated": gated, "backward_per_call": shadow})
    # the dryrun phase: the meta run from before the steps, held against
    # one more step traced on the card (its batch in the dry run's int32
    # tokens) for DRYRUN_CARD, else its peak against the measured peak of
    # the steps after step 1, which run no backward checks; xlstm-350m's
    # on meta alone at a cut sequence
    if cfg.family == "ssm":
        dryrun_cell(cfg, dryrun.cell("train", DRYRUN_XL_SEQ, batch), prof)
    else:
        card = None
        if arch in DRYRUN_CARD:
            int_batch = {key: x.to(torch.int32)
                         if key in ("tokens", "labels") else x
                         for key, x in batches[-1].items()}
            card = (step_fn, (params, opt_state, int_batch))
        dryrun_cell(cfg, dryrun.cell("train", seq, batch), prof, card=card,
                    ms_per_step=step_s * 1e3, lowered=lowered,
                    measured_peak=None if card else peak_after)
    del params, opt_state, batches
    return {**launches, "adamw": fused}


def profiled_calls(line) -> dict:
    """Launches of each dry-run kernel key in a ``profile_run`` line's
    breakdown (PROFILED_CALL's device kernel)."""
    return {key: sum(r["count"] for r in line["breakdown"]
                     if name in r["name"])
            for key, name in PROFILED_CALL.items()}


def dryrun_cell(cfg, shape, profile, *, card=None, ms_per_step=None,
                lowered=None, measured_peak=None):
    """The dryrun phase for one cell: ``dryrun.lower`` traces the step on
    ``meta`` at the cell's width.  ``card = (step, args)``: the same step
    traced once on the card by the same recorder, untimed; outside the
    kernel wrappers its op list (names, shapes, dtypes, in order) and its
    kernel entries (kernel, variant, shape, count, flops, bytes) must
    equal the meta trace's.  ``profile``: a ``profile_run`` line over one
    step of the cell; each kernel's calls in the dry run must equal the
    profiler's launches of that kernel (PROFILED_CALL), and the profiler
    may launch no LM kernel the dry run lacks.  Printed, not gated, with
    the card's name and power limit: MODEL_FLOPS over (ms a step x 989
    TFLOP/s), ``mfu``; the roofline time over the measured; the dominant term; the
    predicted peak (arguments and temps) against the card's
    ``max_memory_allocated`` over the traced step, or, with no ``card``,
    against ``measured_peak`` (the peak of the train steps after step 1,
    which runs the backward checks).  ``lowered``: ``dryrun.lower``'s (record,
    trace) of this cell, made before."""
    from repro_torch.launch import dryrun
    record, meta = lowered or dryrun.lower(cfg, shape)
    line = {"phase": "dryrun", "arch": cfg.name, "cell": shape.name,
            "kind": shape.kind, "layers": cfg.num_layers,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "meta_s": record["lower_s"], "ops": record["ops"],
            "kernel_launches": record["kernel_launches"],
            "memory": record["memory"], "smi": nvidia_smi_line()}
    if card is not None:
        step, args = card
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        traced = dryrun.trace_step(step, args)
        torch.cuda.synchronize()
        line["card_s"] = time.perf_counter() - t0
        bad = dryrun.trace_mismatch(meta.as_dict(), traced.as_dict())
        if bad:
            raise AssertionError(f"{cfg.name} {shape.name}: the meta trace "
                                 f"is not the card's: {bad}")
        line["card_ops"] = len(traced.ops)
        measured_peak = torch.cuda.max_memory_allocated()
    if measured_peak is not None:
        mem = record["memory"]
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        line["peak_memory"] = {
            "predicted_gb": predicted / 1e9,
            "measured_gb": measured_peak / 1e9,
            "predicted_over_measured": predicted / measured_peak,
            "measured_over": "the traced step" if card is not None else
            "the train steps after step 1"}
    got = profiled_calls(profile)
    want = {}
    for key, n in record["kernel_launches"].items():
        name = key if key in PROFILED_CALL else key.split(".")[0]
        if name not in PROFILED_CALL:
            raise AssertionError(f"{key}: no device kernel counts its calls")
        want[name] = want.get(name, 0) + n
    line["profiled_calls"] = {key: n for key, n in got.items() if n}
    if line["profiled_calls"] != want:
        raise AssertionError(f"{cfg.name} {shape.name}: dry-run kernel calls "
                             f"{want} against the profiler's "
                             f"{line['profiled_calls']}")
    if ms_per_step is not None:
        rl = roofline.analyze_cell(cfg.name, shape.name, record=record,
                                   trace=meta.as_dict(), cfg=cfg)
        t_roof = max(rl.t_compute, rl.t_memory, rl.t_collective) * 1e3
        line["readings"] = {
            "ms_per_step": ms_per_step,
            "model_flops": rl.model_flops_total,
            "step_flops": rl.flops_per_chip,
            "step_bytes": rl.bytes_per_chip,
            "useful_ratio": rl.useful_ratio,
            "mfu": rl.model_flops_total / (ms_per_step / 1e3 *
                                           roofline.PEAK_FLOPS),
            "t_compute_ms": rl.t_compute * 1e3,
            "t_memory_ms": rl.t_memory * 1e3,
            "roofline_ms": t_roof, "roofline_share": t_roof / ms_per_step,
            "dominant": rl.dominant}
    emit(line)
    return line


def phase_dryrun_decode(cfg, model, params):
    """The dryrun phase's decode cell: qwen3-14b's decode step at the lm
    phase's shape (LM_BATCH rows, a ring of LM_PROMPT + LM_NEW slots, the
    step that writes its last slot: 40 B3 decode launches), on ``meta``
    and traced once on the card from a zero cache; ms a step over 5 steps
    after one, and one more step under the profiler."""
    from repro_torch.launch import dryrun
    from repro_torch.models.params import _flatten
    shape = dryrun.cell("decode", LM_PROMPT + LM_NEW, LM_BATCH)
    step, meta_args = dryrun.step_inputs(cfg, shape, dryrun.one_card_mesh())
    # the weights in the table's order, as the dry run's: the layer loop
    # selects each leaf in the tree's order (``LanguageModel.tree`` gives
    # them sorted by path)
    flat = _flatten(params)
    params = model.table._nested(lambda path, d: flat[path])
    cache = model.init_cache(LM_BATCH, shape.seq_len, DEVICE)
    cache["t"] = meta_args[1]["t"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, 1), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    args = (params, cache, {"tokens": tokens})
    step(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    prof = profile_run("dryrun_profile", lambda: step(*args),
                       breakdown=("flash_decode_kernel",), arch=cfg.name)
    return dryrun_cell(cfg, shape, prof, card=(step, args), ms_per_step=ms)


def remat_check_config(arch, policy):
    """``arch`` as the remat check runs it with ``policy``: its
    REMAT_CHECK depth, one microbatch, and "full" in the row's
    ``remat_segments`` (0 if it names none), "none" and "dots" in no
    segment."""
    from repro_torch.configs.registry import get_config
    spec = REMAT_CHECK[arch]
    return dataclasses.replace(
        get_config(arch), num_layers=spec["layers"], microbatches=1,
        remat_policy=policy,
        remat_segments=spec.get("remat_segments", 0) if policy == "full"
        else 0)


def phase_remat_check():
    """One super-block of each recurrent family at full width
    (REMAT_CHECK), bf16, one microbatch of its training shape from the
    brick pipeline: step 1's gradients (``make_grads_fn``) with remat
    "none", then with each of the row's policies ("full" unless it names
    others) on the same weights and batch; qwen3-32b's 4 layers with
    "full" in two-level remat (its ``remat_segments``) against "none" in
    no segment; qwen3-14b's 2 layers with "full" and "dots".  Every
    kernel on these paths is deterministic, so the gradients must be
    equal bit for bit; where they are not, the leaves that differ are
    named with the largest difference relative to the largest gradient
    of the leaf, which must stay within TRAIN_REL_TOL.  The launches of
    each run are counted (train_launches): "full" and "dots" run every
    forward kernel twice (B3's forward is no product that "dots" keeps),
    three times under two-level remat but the last layer's of each
    segment."""
    from repro_torch.models import model_zoo
    from repro_torch.models.params import _flatten
    from repro_torch.train import steps as steps_lib
    out = {}
    for arch, spec in REMAT_CHECK.items():
        base = remat_check_config(arch, "none")
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(0)
        params = model_zoo.build_model(base).table.init(gen, DEVICE)
        data = train_pipeline(base, spec["batch"]).next_device_batch()
        row = {"layers": base.num_layers, "batch": [spec["batch"], TRAIN_SEQ],
               "full_remat_segments": spec.get("remat_segments", 0)}
        want = None
        for policy in ("none",) + spec.get("policies", ("full",)):
            cfg = remat_check_config(arch, policy)
            grads_fn = steps_lib.make_grads_fn(cfg,
                                               model_zoo.build_model(cfg))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (grads, total, _), launches = train_counted(
                lambda: grads_fn(params, data))
            row[policy] = {"s": time.perf_counter() - t0,
                           "peak_memory_gb":
                               torch.cuda.max_memory_allocated() / 1e9,
                           "loss": float(total), "launches": launches}
            check_launches(f"{arch} remat {policy}", launches,
                           train_launches(cfg, 1))
            got = _flatten(grads)
            del grads
            if want is None:
                want = got
                continue
            differ, worst = {}, 0.0
            for path, g in got.items():
                h = want[path]
                if not torch.equal(g, h):
                    differ[path] = float((g.float() - h.float()).abs().max()
                                         / h.float().abs().max())
                    worst = max(worst, differ[path])
            row[policy].update(leaves=len(got), leaves_not_bit_equal=differ,
                               max_rel_diff=worst)
            del got
            if worst > TRAIN_REL_TOL or row[policy]["loss"] != \
                    row["none"]["loss"]:
                raise AssertionError(f"{arch} remat check {policy}: {row}")
        del want, params
        release()
        out[arch] = row
    emit({"phase": "remat_check", "rel_tol": TRAIN_REL_TOL, **out})


def fill_ring(cfg, params, tokens, cache):
    """A decoder LM's empty ring ``cache`` as decoding ``tokens`` (B, S)
    one at a time would leave it, up to rounding, from one batched forward
    run layer by layer: each layer's k/v of positions [0, S) in slots
    [0, S), ``kpos[:S] = arange(S)`` and ``t = S``.  S must not pass the
    cache's W (no wrap)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tr
    s = tokens.shape[1]
    if cache["t"] or s > cache["k"].shape[2]:
        raise ValueError(f"fill_ring takes an empty cache of at least {s} "
                         "slots")
    pos = torch.arange(s, dtype=torch.int64, device=tokens.device)
    x = tr.embed_tokens(cfg, params, tokens)
    for i in range(cfg.num_layers):
        p = tr.layer_params(params["layers"], i)
        h = L.norm(cfg, x, p["ln1"]["scale"], p["ln1"].get("bias"))
        _, k, v = tr.attn_qkv(cfg, p["attn"], h, pos)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        x, _ = tr._layer(cfg, p, x, pos)
    cache["kpos"][:s] = pos.to(cache["kpos"].dtype)
    return {**cache, "t": s}


@torch.inference_mode()
def phase_brick(cfg, model, params):
    """qwen3-14b decoding through the grid-brick KV cache: a cache of
    BRICK_CACHE slots on an emulated BRICK_MESH mesh (``brick_active``),
    against the same decode on the (1, 1) mesh.  BRICK_FILL prompt tokens
    fill slots [0, BRICK_FILL) from one batched forward (``fill_ring``), so
    every brick holds live tokens and the merge adds every brick's
    partial; from copies of that cache, BRICK_STEPS teacher-forced decode
    steps on each mesh write the last slots of the last brick, then wrap
    into brick 0 (overwriting its oldest positions).  Each step's logits
    are compared (LM_REL_TOL, LM_TOP1_MIN: the gate of LM_ARCH's
    end-to-end agreement), and the first layer's k/v and kpos must end
    bit-equal (the same projections written into the same slots).  The
    brick path runs no flash kernel (the bricks' attention is plain
    einsums, as the reference's brick path has no Pallas kernel); the (1,
    1) decode launches B3's decode kernel once a layer and step.  ms a
    step (steps after the first) for both, and device launches a step
    from one more step of each under torch.profiler.  Returns the (1, 1)
    decode's launches."""
    from repro_torch.core.brick_attention import brick_active
    from repro_torch.launch.mesh import make_mesh_of
    from repro_torch.parallel.sharding import Sharder
    shards = {
        "brick": Sharder(cfg, make_mesh_of(BRICK_MESH, ("data", "model"),
                                           device=DEVICE, emulate=True)),
        "one": Sharder(cfg, make_mesh_of((1, 1), ("data", "model"),
                                         device=DEVICE))}
    if not brick_active(cfg, shards["brick"], BRICK_CACHE) or \
            brick_active(cfg, shards["one"], BRICK_CACHE):
        raise AssertionError("brick_active does not pick the brick mesh")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size,
                         (LM_BATCH, BRICK_FILL + BRICK_STEPS + 1),
                         generator=gen, device=DEVICE)
    t0 = time.perf_counter()
    filled = fill_ring(cfg, params, toks[:, :BRICK_FILL],
                       model.init_cache(LM_BATCH, BRICK_CACHE, DEVICE))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    n_bricks = shards["brick"].tensor_size
    live = (filled["kpos"].view(n_bricks, -1) >= 0).sum(1).tolist()
    if min(live) == 0:
        raise AssertionError(f"a brick holds no live slot: {live}")
    slots = [(BRICK_FILL + s) % BRICK_CACHE for s in range(BRICK_STEPS)]
    row, logits, caches = {}, {}, {}
    for name, shd in shards.items():
        # the brick run decodes from a copy; the (1, 1) run, last, from
        # the filled cache itself
        cache = {**filled, **{key: filled[key].clone()
                              for key in ("k", "v", "kpos")}} \
            if name == "brick" else filled

        def run():
            c, out, ms = cache, [], []
            for s in range(BRICK_STEPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                lg, c = model.decode_step(
                    params, c, toks[:, BRICK_FILL + s:BRICK_FILL + s + 1],
                    shd)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
                out.append(lg[:, -1].float())
            return torch.stack(out), c, ms

        (logits[name], caches[name], ms), launches = lm_counted(run)
        want = lm_launches() if name == "brick" else \
            lm_launches(decode=cfg.num_layers * BRICK_STEPS)
        check_launches(f"{cfg.name} {name} decode", launches, want)
        row[name] = {"mesh": list(shd.mesh.devices.shape),
                     "emulated": shd.mesh.emulated, "ms_per_step": ms,
                     "ms_per_decode_step": sum(ms[1:]) / (len(ms) - 1),
                     "launches": launches}
    rel, top1 = compare_logits(logits["brick"], logits["one"],
                               cfg.vocab_size)
    check_logits(f"{cfg.name} brick decode vs (1, 1)", rel, top1)
    same = {key: bool(torch.equal(caches["brick"][key][0],
                                  caches["one"][key][0]))
            for key in ("k", "v")}
    same["kpos"] = bool(torch.equal(caches["brick"]["kpos"],
                                    caches["one"]["kpos"]))
    if not all(same.values()):
        raise AssertionError(f"brick and ring caches differ: {same}")
    for name, shd in shards.items():
        c = caches[name]
        prof = profile_run(
            "brick_profile", lambda: model.decode_step(
                params, c, toks[:, -1:], shd), mesh=name)
        row[name].update(device_launches_per_step=prof["device_launches"])
    emit({"phase": "brick", "arch": cfg.name, "layers": cfg.num_layers,
          "batch": LM_BATCH, "cache_slots": BRICK_CACHE,
          "bricks": n_bricks, "fill_tokens": BRICK_FILL, "fill_s": fill_s,
          "live_slots_per_brick": live, "decode_steps": BRICK_STEPS,
          "step_slots": slots,
          "step_bricks": [sl // (BRICK_CACHE // n_bricks) for sl in slots],
          "rel_logit_diff_per_step": rel, "max_rel_logit_diff": max(rel),
          "top1_agreement": top1, "rel_tol": LM_REL_TOL,
          "top1_min": LM_TOP1_MIN, "first_layer_cache_bit_equal": same,
          **row})
    return row["one"]["launches"]


def phase_trainer():
    """The Trainer with starcoder2-3b at full width and TRAINER_LAYERS of
    its 30 layers, bf16, checkpointing into a temporary directory (removed
    afterwards): a calm run of TRAINER_STEPS steps; a run of 2 steps, then
    a new trainer resuming from its step-2 checkpoint to TRAINER_STEPS,
    which must end with the calm run's params and moments bit for bit
    (C-ref9's path: bf16 leaves restored); and a run with data node 1
    killed at step 2, whose losses must equal the calm run's (the bricks'
    replicas are byte-identical).  The calm and failure runs save only
    their last step: four checkpoints in all."""
    import shutil
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import _leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAINER_LAYERS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        free_gb = shutil.disk_usage(tmp).free / 1e9

        def trainer(name, steps, hook=None, every=TRAINER_STEPS):
            return Trainer(cfg, TrainerConfig(
                total_steps=steps, ckpt_every=every,
                ckpt_dir=f"{tmp}/{name}",
                global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=1),
                device=DEVICE, failure_hook=hook)

        calm = trainer("calm", TRAINER_STEPS)
        calm.train()
        shutil.rmtree(f"{tmp}/calm")
        trainer("restart", 2, every=2).train()
        resumed = trainer("restart", TRAINER_STEPS, every=2)
        out = resumed.train()
        if out["steps"] != TRAINER_STEPS - 2:
            raise AssertionError(f"the restart ran {out['steps']} steps")
        pairs = list(zip(_leaves({"p": calm.state[0], "s": calm.state[1]}),
                         _leaves({"p": resumed.state[0],
                                  "s": resumed.state[1]})))
        differ = sum(not torch.equal(a, b) for a, b in pairs)
        dtypes = sorted({str(b.dtype) for _, b in pairs})
        del resumed
        shutil.rmtree(f"{tmp}/restart")
        kills = {2: 1}
        failed = trainer("failure", TRAINER_STEPS,
                         hook=lambda step: kills.pop(step, None))
        failed.train()
        calm_losses = [h["loss"] for h in calm.history]
        failed_losses = [h["loss"] for h in failed.history]
    if differ:
        raise AssertionError(f"restart: {differ} of {len(pairs)} state "
                             "leaves differ from the uninterrupted run")
    if failed_losses != calm_losses or 1 not in failed.catalog.dead_nodes():
        raise AssertionError(f"data node failure: losses {failed_losses}, "
                             f"calm {calm_losses}")
    emit({"phase": "trainer", "arch": cfg.name, "layers": cfg.num_layers,
          "published_layers": get_config(TRAIN_ARCH).num_layers,
          "steps": TRAINER_STEPS, "global_batch": TRAIN_BATCH,
          "seq_len": TRAIN_SEQ, "checkpoints": 4, "tmp_free_gb": free_gb,
          "restart_state_leaves_identical": len(pairs),
          "restored_dtypes": dtypes, "losses": calm_losses,
          "failure_losses_identical": True, "wall_s":
          time.perf_counter() - t0})


# --------------------------------------------------------------------- #
def kernel_name(mangled) -> str:
    """A kernel's readable name from its mangled one: the name and its
    template arguments (a type as bf16 or f32, an int as itself)."""
    import re
    m = re.search(r"\d+([a-z_]+_kernel)(I(.*?)EEv)?", mangled)
    if m is None:
        return mangled
    args, text, i = [], m.group(3) or "", 0
    while i < len(text):
        if text.startswith("Li", i):
            j = text.index("E", i)
            args.append(text[i + 2:j])
            i = j + 1
        elif text.startswith("13__nv_bfloat16", i):
            args.append("bf16")
            i += len("13__nv_bfloat16")
        elif text[i] == "f":
            args.append("f32")
            i += 1
        else:
            i += 1
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(source) -> list:
    """Registers and spill bytes of each kernel instance in ``source``,
    from the ptxas report its build kept."""
    import re
    from repro_torch import kernels
    rows = []
    for line in kernels.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append({"kernel": kernel_name(m.group(1))})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and rows:
            rows[-1]["spill_stores"] = int(m.group(1))
            rows[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def build_all():
    """One nvcc per source, all started together; returns ptxas's report
    by source."""
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    from repro_torch.kernels.flash_attention import backward as fa_backward
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import backward as ml_backward
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    # rglru_scan's backward is an instance of the forward's source
    from repro_torch.kernels.adamw import kernel as adamw_kernel
    modules = (ef_kernel, fa_kernel, fa_backward, rg_kernel, ml_kernel,
               ml_backward, adamw_kernel)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        futures = [pool.submit(m.build) for m in modules]
        for f in futures:
            f.result()
    ptxas = {m.SOURCE.name: ptxas_report(m.SOURCE) for m in modules}
    emit({"phase": "build", "sources": [m.SOURCE.name for m in modules],
          "build_s": time.perf_counter() - t0, "ptxas": ptxas})
    # the tensor-core kernels hold their state in registers by design, and
    # the chunked scan holds a few floats a thread: a spill is a fault of
    # the build, not a slowdown to report
    spilled = [row for m in (fa_kernel, fa_backward, ml_kernel, rg_kernel,
                             ml_backward, adamw_kernel)
               for row in ptxas[m.SOURCE.name]
               if row.get("spill_stores") or row.get("spill_loads")]
    if spilled:
        raise AssertionError(f"kernel instances spill: {spilled}")
    for m, name in ((ml_kernel, "mlstm_wgmma_kernel"),
                    (rg_kernel, "rglru_chunked_kernel<0>"),
                    (rg_kernel, "rglru_chunked_kernel<1>"),
                    (ml_backward, "mlstm_bwd_cumsum_kernel"),
                    (ml_backward, "mlstm_bwd_prep_kernel"),
                    (ml_backward, "mlstm_bwd_dkdv_kernel"),
                    (ml_backward, "mlstm_bwd_dq_kernel"),
                    (ml_backward, "mlstm_bwd_finish_kernel"),
                    (ml_backward, "mlstm_bwd_planes_kernel"),
                    (ml_backward, "mlstm_bwd_dkdv_wgmma_kernel"),
                    (ml_backward, "mlstm_bwd_dq_wgmma_kernel"),
                    (fa_backward, "fa_bwd_delta_kernel"),
                    (fa_backward, "fa_bwd_dkdv_wgmma_kernel"),
                    (fa_backward, "fa_bwd_sum_kernel"),
                    (fa_backward, "fa_bwd_dq_wgmma_kernel"),
                    (fa_backward, "fa_bwd_dkdv_roles_kernel"),
                    (fa_backward, "fa_bwd_dq_roles_kernel"),
                    (fa_backward, "fa_bwd_dkdv_kernel"),
                    (fa_backward, "fa_bwd_dq_kernel"),
                    (adamw_kernel, "adamw_sumsq_kernel"),
                    (adamw_kernel, "adamw_norm_final_kernel"),
                    (adamw_kernel, "adamw_update_kernel")):
        if not any(row["kernel"].startswith(name)
                   for row in ptxas[m.SOURCE.name]):
            raise AssertionError(f"no {name} in the ptxas report")
    return ptxas


def release():
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-events", type=int, default=8192,
                    help="events in the served store (default: 8192)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2

    # seconds each group of phases took, emitted before the kernels line
    seconds, last = {}, [time.perf_counter()]

    def took(name):
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch_device": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    ptxas = build_all()
    fa_bwd_lib = "flash_attention_bwd.cu"
    took("build")

    # 3. kernels against their plain versions (f32 plain path without
    # TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    rows = phase_kernels(gen)
    emit({"phase": "kernels", "cases": len(rows),
          "band_events": sum(r["band_events"] for r in rows),
          "max_abs_err": max(r["max_abs_err"] for r in rows),
          "rows": rows})
    fa_rows = phase_flash_kernels(gen)
    emit({"phase": "flash_kernels", "cases": len(fa_rows),
          "tolerance": {str(k).split(".")[-1]: v for k, v in FA_TOL.items()},
          "rows": fa_rows})
    bwd_rows = phase_flash_backward(gen)
    emit({"phase": "flash_backward_kernels", "cases": len(bwd_rows),
          "tolerance": {str(k).split(".")[-1]: v
                        for k, v in BWD_TOL.items()},
          "rows": bwd_rows})
    scan_rows = phase_scan_kernels(gen) + phase_scan_backward(gen)
    emit({"phase": "scan_kernels", "cases": len(scan_rows),
          "tolerance": {"rglru_scan": SCAN_TOL,
                        "mlstm": {str(k).split(".")[-1]: v
                                  for k, v in MLSTM_TOL.items()},
                        "backward": {str(k).split(".")[-1]: v
                                     for k, v in BWD_TOL.items()}},
          "rows": scan_rows})
    took("kernels")

    # 4. serve and lockstep (the query paths; launch counts read around
    # each), then the fleet and failover paths on the same resident store
    store = build_store(args.n_events)
    launches, widths = phase_serve(store)
    phase_autotune(store)
    phase_fleet(store)
    phase_failover(store)
    del store
    release()
    took("query_paths")

    # 5, 6. each LM at full width: serve and one forward (launch counts
    # read around each path), one model on the card at a time
    # flash_attention launches of every LM path, per model and path
    flash = {}
    lm = build_lm(LM_ARCH)
    flash[LM_ARCH] = (phase_lm(*lm)["flash_attention"],
                      phase_prefill(*lm)["flash_attention"])
    took(f"lm {LM_ARCH}")
    # the grid-brick KV cache on the same weights, and its (1, 1) decode
    brick_one = phase_brick(*lm)
    took("brick")
    # the dryrun phase's decode cell on the same weights
    phase_dryrun_decode(*lm)
    del lm
    release()
    took("dryrun decode")
    lm = build_lm(RG_ARCH)
    rg_serve = phase_lm(*lm)
    rg_forward = phase_prefill(*lm)
    flash[RG_ARCH] = (rg_serve["flash_attention"],
                      rg_forward["flash_attention"])
    launches["rglru_scan"] = rg_forward["rglru_scan"]
    del lm
    release()
    took(f"lm {RG_ARCH}")
    lm = build_lm(XL_ARCH)
    phase_lm(*lm)
    launches["mlstm"] = phase_prefill(*lm)["mlstm"]
    phase_recurrent_tie(*lm)
    del lm
    release()
    took(f"lm {XL_ARCH}")
    # the vlm, moe and audio families: pixtral-12b, phi3.5-moe at 16 of
    # its 32 layers, whisper-medium
    # then chatglm3-6b, qwen3-32b and grok-1 at 4 of its 64 layers
    # (LM_MORE), each built after the one before is freed: nothing else
    # is resident beside qwen3-32b's 65.5 GB
    for arch in (PX_ARCH, MOE_ARCH, WH_ARCH) + LM_MORE:
        lm = build_lm(arch)
        flash[arch] = (phase_lm(*lm)["flash_attention"],
                       phase_prefill(*lm)["flash_attention"])
        del lm
        release()
        took(f"lm {arch}")
    # the training stack: starcoder2-3b whole, recurrentgemma-9b at 15
    # layers, xlstm-350m at 8, whisper-medium whole, pixtral-12b at 8
    # layers, phi3.5-moe at 2, grok-1 at 1, qwen3-32b at 4, qwen3-14b at
    # 8, chatglm3-6b at 18, the remat check, then the trainer's restart
    # and failure scenarios
    train = {}
    for arch in TRAIN_ARCHS:
        train[arch] = phase_train(arch)
        release()
        took(f"train {arch}")
    phase_remat_check()
    release()
    took("remat_check")
    phase_trainer()
    release()
    took("trainer")
    launches["flash_attention"] = sum(sum(n) for n in flash.values()) + \
        sum(t["flash_attention"] for t in train.values()) + \
        brick_one["flash_attention"]
    for key in ("rglru_scan", "mlstm"):
        launches[key] += sum(t[key] for t in train.values())
    for key in ("flash_attention_bwd", "flash_attention_bwd.wgmma",
                "flash_attention_bwd.simt", "rglru_scan_bwd", "mlstm_bwd",
                "mlstm_bwd.wgmma", "mlstm_bwd.simt"):
        launches[key] = sum(t[key] for t in train.values())
    launches["adamw"] = sum(t["adamw"] for t in train.values())

    # 7. timing at the shapes the main path gave each kernel
    main_k = max(set(w for w in widths if w), key=widths.count)
    gen.manual_seed(1)
    timed = {
        "event_filter_batch": time_kernel("event_filter_batch", gen,
                                          CHUNK_SHAPE, main_k, 0),
        "event_filter": time_kernel("event_filter", gen,
                                    BRICK_SHAPE, 1, 0),
        "flash_attention": time_flash(gen, LM_BATCH, 1,
                                      LM_PROMPT + LM_NEW, 48, 8, 128),
        "rglru_scan": time_scan(gen, 1, FORWARD_LEN[RG_ARCH], 4096),
        "mlstm": time_mlstm(gen, 1, FORWARD_LEN[XL_ARCH], 4, 512),
    }
    prefill = time_flash(gen, 1, PREFILL_LEN, PREFILL_LEN, 48, 8, 128)
    rg_len = FORWARD_LEN[RG_ARCH]
    rg_decode = time_flash(gen, LM_BATCH, 1, LM_PROMPT + LM_NEW, 16, 1, 256)
    rg_prefill = time_flash(gen, 1, rg_len, rg_len, 16, 1, 256, window=2048)
    # whisper-medium: the encoder of generate's cross-cache fill, and the
    # cross-attention of a decode step
    wh_enc = time_flash(gen, LM_BATCH, 1500, 1500, 16, 16, 64, causal=False)
    wh_cross = time_flash(gen, LM_BATCH, 1, 1500, 16, 16, 64, causal=False)
    wh_cross_fwd = time_flash(gen, 1, FORWARD_LEN[WH_ARCH], 1500, 16, 16, 64,
                              causal=False)
    # the backward at starcoder2-3b's training shape (a microbatch), and
    # the forward beside it
    from repro_torch.configs.registry import get_config
    tr_cfg = get_config(TRAIN_ARCH)
    tr_shape = (TRAIN_BATCH // tr_cfg.microbatches, TRAIN_SEQ, TRAIN_SEQ,
                tr_cfg.num_heads_padded, tr_cfg.num_kv_heads,
                tr_cfg.head_dim)
    timed["flash_attention_bwd"] = time_flash_bwd(
        gen, *tr_shape, window=tr_cfg.sliding_window)
    # recurrentgemma-9b's training microbatch (1, 2048^2, 16/1 heads of
    # 256, its 2048 window masking nothing there): the tensor-core variant
    # in bf16, and the CUDA-core one on f32 operands (fewer calls: ~25 ms
    # each)
    rg_cfg = train_config(RG_ARCH)
    rg_train_shape = (1, TRAIN_SEQ, TRAIN_SEQ, rg_cfg.num_heads_padded,
                      rg_cfg.num_kv_heads, rg_cfg.head_dim)
    bwd_256 = time_flash_bwd(gen, *rg_train_shape,
                             window=rg_cfg.attention_window)
    release()
    bwd_simt = time_flash_bwd(gen, *rg_train_shape,
                              window=rg_cfg.attention_window,
                              dtype=torch.float32, iters=8)
    release()
    # grok-1's training microbatch (1, 2048^2, 48/8 heads of 128) with its
    # softcap: the tensor-core variant at head dim 128 with the cap
    grok_cfg = train_config(GROK_ARCH)
    grok_shape = (TRAIN_ARCHS[GROK_ARCH]["batch"] // grok_cfg.microbatches,
                  TRAIN_SEQ, TRAIN_SEQ, grok_cfg.num_heads_padded,
                  grok_cfg.num_kv_heads, grok_cfg.head_dim)
    bwd_cap = time_flash_bwd(gen, *grok_shape,
                             logit_cap=grok_cfg.attn_logit_softcap,
                             q_gain=GROK_Q_GAIN)
    release()
    # the same call at qwen3-14b's training microbatch (1, 2048^2, 48/8
    # heads of 128: grok-1's shape) without the cap, q scaled as the
    # capped row's: the two times differ only by the cap.  chatglm3-6b's
    # backward shape (2, 2048^2, 32/2, 128) is starcoder2-3b's row (its
    # 4096 window does not cut at 2048)
    q14_cfg = train_config(LM_ARCH)
    q14_shape = (TRAIN_ARCHS[LM_ARCH]["batch"] // q14_cfg.microbatches,
                 TRAIN_SEQ, TRAIN_SEQ, q14_cfg.num_heads_padded,
                 q14_cfg.num_kv_heads, q14_cfg.head_dim)
    bwd_uncapped = time_flash_bwd(gen, *q14_shape, q_gain=GROK_Q_GAIN)
    release()
    tr_forward = time_flash(gen, *tr_shape, window=tr_cfg.sliding_window)
    # the B4 and B5 backward kernels at their training microbatches
    xl_train_shape = (TRAIN_ARCHS[XL_ARCH]["batch"] //
                      train_config(XL_ARCH).microbatches, TRAIN_SEQ, 4, 512)
    timed["rglru_scan_bwd"] = time_scan_bwd(gen, 1, TRAIN_SEQ, 4096)
    timed["mlstm_bwd"] = time_mlstm_bwd(gen, *xl_train_shape)
    mlstm_stats = time_mlstm(gen, 1, FORWARD_LEN[XL_ARCH], 4, 512,
                             with_stats=True)
    release()
    # AdamW over chatglm3-6b's train cell: 58.8 GB with nothing else held
    timed["adamw"] = time_adamw(gen)
    emit({"phase": "timing", "smi": smi,
          "launch_floor_ms": launch_floor_ms(),
          "event_filter_batch": {"shape": list(CHUNK_SHAPE), "k": main_k,
                                 **timed["event_filter_batch"]},
          "event_filter": {"shape": list(BRICK_SHAPE), "k": 1,
                           **timed["event_filter"]},
          "flash_attention_decode": {
              "shape": [LM_BATCH, 1, LM_PROMPT + LM_NEW, 48, 8, 128],
              "launches_serve": flash[LM_ARCH][0],
              **timed["flash_attention"]},
          "flash_attention_prefill": {
              "shape": [1, PREFILL_LEN, PREFILL_LEN, 48, 8, 128],
              "launches_prefill": flash[LM_ARCH][1], **prefill},
          "flash_attention_rg_decode": {
              "shape": [LM_BATCH, 1, LM_PROMPT + LM_NEW, 16, 1, 256],
              "launches_serve": rg_serve["flash_attention"], **rg_decode},
          "flash_attention_rg_prefill": {
              "shape": [1, rg_len, rg_len, 16, 1, 256], "window": 2048,
              "launches_forward": rg_forward["flash_attention"],
              **rg_prefill},
          "flash_attention_whisper_encoder": {
              "shape": [LM_BATCH, 1500, 1500, 16, 16, 64], "causal": False,
              **wh_enc},
          "flash_attention_whisper_cross_decode": {
              "shape": [LM_BATCH, 1, 1500, 16, 16, 64], "causal": False,
              **wh_cross},
          "flash_attention_whisper_cross_forward": {
              "shape": [1, FORWARD_LEN[WH_ARCH], 1500, 16, 16, 64],
              "causal": False, **wh_cross_fwd},
          "flash_attention_bwd": {
              "shape": list(tr_shape), "window": tr_cfg.sliding_window,
              "launches_train":
                  train[TRAIN_ARCH]["flash_attention_bwd.wgmma"],
              "library": "scaled_dot_product_attention backward "
                         "(enable_gqa, is_causal), CUDA events",
              **with_share(timed["flash_attention_bwd"])},
          "flash_attention_bwd_256": {
              "shape": list(rg_train_shape),
              "window": rg_cfg.attention_window,
              "launches_train": train[RG_ARCH]["flash_attention_bwd.wgmma"],
              "library": "scaled_dot_product_attention backward "
                         "(enable_gqa, is_causal), CUDA events",
              **with_share(bwd_256)},
          "flash_attention_bwd_simt": {
              "shape": list(rg_train_shape),
              "window": rg_cfg.attention_window,
              "launches_train": launches["flash_attention_bwd.simt"],
              "library": "scaled_dot_product_attention backward "
                         "(enable_gqa, is_causal), CUDA events",
              **with_share(bwd_simt)},
          "flash_attention_bwd_softcap": {
              "shape": list(grok_shape),
              "logit_cap": grok_cfg.attn_logit_softcap,
              "launches_train": train[GROK_ARCH]["flash_attention_bwd.wgmma"],
              "library": "torch.compile(flex_attention) backward (tanh "
                         "score_mod, causal block mask, enable_gqa), CUDA "
                         "events",
              **with_share(bwd_cap)},
          "flash_attention_bwd_uncapped": {
              "shape": list(q14_shape), "logit_cap": None,
              "launches_train": train[LM_ARCH]["flash_attention_bwd.wgmma"],
              "library": "scaled_dot_product_attention backward "
                         "(enable_gqa, is_causal), CUDA events",
              **with_share(bwd_uncapped)},
          "flash_attention_train_forward": {
              "shape": list(tr_shape), "window": tr_cfg.sliding_window,
              "launches_train": train[TRAIN_ARCH]["flash_attention"],
              **tr_forward},
          "flash_attention_launches_by_model": {
              arch: {"serve": n[0], "forward": n[1]}
              for arch, n in flash.items()},
          "rglru_scan": {"shape": [1, rg_len, 4096],
                         "launches_forward": launches["rglru_scan"],
                         **timed["rglru_scan"]},
          "mlstm": {"shape": [1, FORWARD_LEN[XL_ARCH], 4, 512],
                    "dtype": "bfloat16",
                    "launches_forward_and_train": launches["mlstm"],
                    **timed["mlstm"]},
          "mlstm_with_stats": {"shape": [1, FORWARD_LEN[XL_ARCH], 4, 512],
                               "dtype": "bfloat16", **mlstm_stats},
          "rglru_scan_bwd": {"shape": [1, TRAIN_SEQ, 4096],
                             "launches_train": launches["rglru_scan_bwd"],
                             **timed["rglru_scan_bwd"]},
          "mlstm_bwd": {"shape": list(xl_train_shape), "dtype": "bfloat16",
                        "launches_train": launches["mlstm_bwd"],
                        **timed["mlstm_bwd"]},
          "adamw": {"launches_train": launches["adamw"],
                    **timed["adamw"]}})

    # 8. kernels line, nvidia-smi line, result line
    ef_src = "src/repro_torch/kernels/event_filter/csrc/event_filter.cu"
    sources = {
        "event_filter_batch": (ef_src, "src/repro/kernels/event_filter/"
                                       "kernel.py:178"),
        "event_filter": (ef_src, "src/repro/kernels/event_filter/"
                                 "kernel.py:225"),
        "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention/"
                            "kernel.py:81"),
        # no Pallas backward exists: the JAX package differentiates its
        # plain attention; this is the gradient of the kernel replacing B3
        "flash_attention_bwd": ("src/repro_torch/kernels/flash_attention/"
                                "csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention/"
                                "kernel.py:81"),
        "rglru_scan": ("src/repro_torch/kernels/rglru_scan/csrc/"
                       "rglru_scan.cu",
                       "src/repro/kernels/rglru_scan/kernel.py:42"),
        "mlstm": ("src/repro_torch/kernels/mlstm_scan/csrc/mlstm_scan.cu",
                  "src/repro/kernels/mlstm_scan/kernel.py:70"),
        # no Pallas backward either: the gradients of the kernels replacing
        # B4 (the same source, its reversed instance) and B5
        "rglru_scan_bwd": ("src/repro_torch/kernels/rglru_scan/csrc/"
                           "rglru_scan.cu",
                           "src/repro/kernels/rglru_scan/kernel.py:42"),
        "mlstm_bwd": ("src/repro_torch/kernels/mlstm_scan/csrc/"
                      "mlstm_scan_bwd.cu",
                      "src/repro/kernels/mlstm_scan/kernel.py:70"),
        # no Pallas kernel: the JAX package's AdamW is plain jnp
        "adamw": ("src/repro_torch/kernels/adamw/csrc/adamw.cu",
                  "none (src/repro/optim/adamw.py: plain jnp)"),
    }
    def entry(name, src, replaces, row, n):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")}

    kernels = [entry(name, src, replaces, timed[name], launches[name])
               for name, (src, replaces) in sources.items()]
    # the backward's variants, each with its own source, launches on the
    # train path (all on the tensor cores, counted by head dim: 64 for
    # whisper-medium, 128 for starcoder2-3b, pixtral-12b, phi3.5-moe,
    # qwen3-32b, qwen3-14b and chatglm3-6b, 256 for recurrentgemma-9b;
    # grok-1's capped apart) and timing at a training shape
    # (starcoder2-3b's, grok-1's with and without the cap,
    # recurrentgemma-9b's; the CUDA-core one on f32
    # operands), the tensor-core instances with ptxas's registers and
    # spills; the launches of each trained model beside them
    bwd_src, bwd_replaces = sources["flash_attention_bwd"]
    tc_src = bwd_src.replace("flash_attention_bwd.cu", "flash_bwd_wgmma.cuh")
    tc_by_dim, tc_capped = {}, 0
    for arch, t in train.items():
        cfg = train_config(arch)
        if cfg.attn_logit_softcap:
            tc_capped += t["flash_attention_bwd.wgmma"]
            continue
        d = cfg.head_dim
        tc_by_dim[d] = tc_by_dim.get(d, 0) + t["flash_attention_bwd.wgmma"]

    def instances(*names, lib=fa_bwd_lib):
        return [row for row in ptxas[lib] if row["kernel"] in names]

    for kern in kernels:
        if kern["name"] == "flash_attention_bwd":
            kern["launches_by_model"] = {
                arch: t["flash_attention_bwd"] for arch, t in train.items()
                if t["flash_attention_bwd"]}
            kern["wgmma_launches_by_head_dim"] = tc_by_dim
            kern["wgmma_launches_softcap"] = tc_capped
            kern["variants"] = [
                {"variant": "wgmma", "dtype": "bfloat16", "head_dim": 128,
                 **entry("flash_attention_bwd", tc_src, bwd_replaces,
                         timed["flash_attention_bwd"], tc_by_dim.get(128, 0)),
                 "ptxas": instances("fa_bwd_dkdv_wgmma_kernel<128>",
                                    "fa_bwd_dq_wgmma_kernel<128>")},
                {"variant": "wgmma", "dtype": "bfloat16", "head_dim": 128,
                 "logit_cap": grok_cfg.attn_logit_softcap,
                 **entry("flash_attention_bwd", tc_src, bwd_replaces,
                         bwd_cap, tc_capped)},
                {"variant": "wgmma", "dtype": "bfloat16", "head_dim": 128,
                 "logit_cap": None, "shape": list(q14_shape),
                 **entry("flash_attention_bwd", tc_src, bwd_replaces,
                         bwd_uncapped,
                         train[LM_ARCH]["flash_attention_bwd.wgmma"])},
                {"variant": "wgmma", "dtype": "bfloat16", "head_dim": 256,
                 **entry("flash_attention_bwd", tc_src, bwd_replaces,
                         bwd_256, tc_by_dim.get(256, 0)),
                 "ptxas": instances("fa_bwd_dkdv_roles_kernel",
                                    "fa_bwd_dq_roles_kernel",
                                    "fa_bwd_delta_kernel<bf16,256>")},
                {"variant": "simt", "dtype": "float32", "head_dim": 256,
                 **entry("flash_attention_bwd", bwd_src, bwd_replaces,
                         bwd_simt, launches["flash_attention_bwd.simt"])}]
        if kern["name"] == "mlstm_bwd":
            # the tensor-core variant at xlstm-350m's training microbatch,
            # each of its device kernels apart, with ptxas's registers and
            # spills
            ml_src, ml_replaces = sources["mlstm_bwd"]
            kern["variants"] = [
                {"variant": "wgmma", "dtype": "bfloat16", "head_dim": 512,
                 **entry("mlstm_bwd", ml_src.replace(
                     "mlstm_scan_bwd.cu", "mlstm_bwd_wgmma.cuh"),
                     ml_replaces, timed["mlstm_bwd"],
                     launches["mlstm_bwd.wgmma"]),
                 "kernels_ms": timed["mlstm_bwd"]["kernels_ms"],
                 "ptxas": instances("mlstm_bwd_dkdv_wgmma_kernel",
                                    "mlstm_bwd_dq_wgmma_kernel",
                                    "mlstm_bwd_planes_kernel",
                                    lib="mlstm_scan_bwd.cu")}]
    took("timing")
    emit({"phase": "durations", "seconds": seconds,
          "total_s": sum(seconds.values())})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
