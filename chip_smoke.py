#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

The run uses one card: it makes only the first visible card visible to
itself, so the device line's ``count`` is the one card that did the work.

Phases, in order (any failure ends the run with a non-zero exit), except
that 7 and 8, which launch none of the port's kernels, run on the card
while 2's compilers run:

1. the card's name and power limit (``nvidia-smi``); TF32 off;
2. build every CUDA kernel of the serving and training paths from
   ``src/`` (one ``nvcc`` per source, all started together); no bf16 flash
   instance and no paged-attention instance may spill (ptxas ``-v``),
   and the registers of the instances the new families serve are printed;
3. each kernel against its plain PyTorch version on the card:
   ``paged_attention`` at the served shapes, the smoke shapes, 8
   sequences of up to 4,096 positions (16 splits merged by the combine
   kernel), phase 10's tables (133 and 71 pages: 9 and 5 splits),
   phase 11's heads (40/8 at hd 128 over 66 pages: 5 splits; 14/2 at hd
   64), phase 12's zamba2 decode tick (32/32 at hd 80 over 260 pages: 17
   splits) and the smoke configs' hd 8 (7/1) and hd 12 (6/6), fp32 (atol
   1e-4) and bf16 (atol 2e-2 against the plain version in fp32);
   ``mrd_combine`` at n = 256 and 768, at the kernel's block of 2,048
   elements +- 256, at a last block with one live warp, at the smoke
   config's reduce-scatter rows, at a [3, 512 k] stacked shape and at the
   largest full-width gradient bucket's [3, len] rows, fp32 and bf16,
   equal bit for bit; ``flash_attention`` at the gemma3-12b shape (4096
   and 1755 tokens, 16 heads, 8 KV heads, hd 256, causal, no window and
   window 1024), the llama3.2-1b shape (2048 and 37 tokens; phase 10's
   8 x 512, 1088 and 4 x 64), phase 11's (qwen2.5-32b's 1024 tokens at
   40/8 heads, hd 128; internvl2-1b's 512 at 14/2, hd 64; mixtral-8x7b's
   5000 at 32/8, hd 128, window 4096), phase 12's (zamba2-2.7b's shared
   block: 4096 and 1755 tokens at 32/32, hd 80), the smoke
   shapes (hd 8 and 12 among them) and the edges of the bf16 kernel's
   tiling at every hd x rep instance, rep 5 and 7 and hd 80 included
   (partial q and key tiles, windows that cut a key tile, q_offset,
   bidirectional, queries that see no key and must write 0),
   fp32 (atol 1e-4) and bf16 (atol 2e-2 against the plain version in
   fp32), and every (token, head) row within a relative error of 1e-4
   (fp32) or 1e-2 (bf16) of the plain row; ``rmsnorm`` at the rows and
   widths of the served models and the smoke configs ([32768, 3840],
   [4, 3840], [8, 2048], [64, 2048], [40, 64], [32768, 4096], [8, 4096],
   phase 10's [4096, 2048] and [1088, 2048], phase 11's widths
   [1024, 5120], [1024, 896] and [1024, 2304], and phase 12's [T, 2560]
   and [T, 5120] at T = 4096 and 8),
   fp32 (1e-5) and bf16 (2e-2); ``selective_scan`` in its materialized
   form at the reference kernel test's shapes and [1, 2048, 8192, 16], fp32
   and bf16 inputs, and in its fused form (the model's) at [1, 4096, 8192,
   16] and [1, 4097, 8192, 16] (the chunked instance, the second with a
   ragged last chunk) from a nonzero h0 and at the decode shapes [8, 1,
   8192, 16] and [1, 1, 8192, 16] (the step instance), writing the state
   over h0 as a decode tick does: y and h_final within 1e-5 + 1e-4 |plain|
   (both sides compute in fp32), and the batches whose write_ok is False
   keep their state bit for bit;
4. the serving path at full width: ``repro_torch.launch.serve`` serves 16
   requests of llama3.2-1b (bf16, random weights from the seed) with
   block-paged decode through the kernel and MRD-agreed retirement across
   3 simulated replicas; every request must retire, ``paged_attention``
   must have launched once per layer per decode tick, ``flash_attention``
   once per layer per admission and ``rmsnorm`` 33 times a forward
   (admissions and decode ticks); then a profile of steady decode ticks
   with every slot busy (wall and device-busy time per tick, the costliest
   kernels);
4c. the training path at full width: ``repro_torch.launch.train`` trains
   llama3.2-1b (bf16, random weights from the seed) for 4 steps of 6 x
   1024 tokens at dp 3 with the ``compressed`` gradient sync, after a
   1-step warm-up; every loss must be finite and ``mrd_combine`` must have
   launched once per reducing stage per bucket per step, and no serving
   kernel (autograd takes the plain versions); then a profile
   of one step (device busy time, idle share, the costliest kernels);
4e. gemma3-12b at full width (bf16, random weights from the seed, 48
   layers: 40 local with a 1024-token window, 8 global): the contiguous
   ``llm_decode`` workload serves 8 requests of 1024-8192-token prompts
   at dp 3 with 4 slots; every request must retire, ``flash_attention``
   must have launched 48 times an admission and ``rmsnorm`` 97 times a
   forward (prefills and decode ticks); then a profile of steady decode
   ticks with every slot busy;
4f. the whole-prompt ``make_prefill_step`` of gemma3-12b at 32,768 tokens,
   batch 1 (the reference's ``prefill_32k`` length; its global batch of 32
   cut to 1 for one card): wall time, tokens/s, peak memory and a profile
   (device busy time; attention, GEMM and rmsnorm shares);
4g. falcon-mamba-7b at full width (bf16, random weights from the seed, 64
   mamba1 layers, d 4096, d_inner 8192, state 16): the contiguous
   ``llm_decode`` workload serves 16 requests of 1024-8192-token prompts
   and budgets up to 64 at dp 3 with 8 slots; every request must retire,
   ``selective_scan`` must have launched 64 times a forward (admissions
   and decode ticks), ``rmsnorm`` 65 times a forward, and no other kernel;
   then a profile of steady decode ticks with every slot busy;
4h. its whole-prompt ``make_prefill_step`` at 32,768 tokens, batch 1 (the
   reference's ``prefill_32k``, cut to batch 1 as for gemma3): 64
   ``selective_scan`` and 65 ``rmsnorm`` launches; wall time, tokens/s,
   peak memory and device time by class;
5. correctness: one fp32 full-width paged decode step through the kernel
   against the gather path (logits atol 1e-3), and the smoke config served
   on the card and on the CPU, from the same weights, with identical
   tokens and ticks; the smoke config trained with ``compressed`` at dp 3
   for 3 steps on the card and on the CPU, from the same weights and
   batches (losses atol 1e-4, grad norms rtol 5e-4); the full-width
   reduce-scatter plan on fixed fp32 buckets through the kernel on the
   card and through the plain version on the CPU, equal bit for bit; one
   full-width gemma3 prefill of 8192 tokens through the flash kernel
   against ``flash_scan`` (plain torch on the card): in bf16 the same
   argmax, and the kernel's last logits no further from either plain
   version (``flash_scan``, materialized ``full``) than twice the two plain
   versions' spread, in fp32 logits within 5e-2 and the same argmax; the
   gemma3 and falcon-mamba smoke configs served on the card and on the CPU
   from the same weights, identical tokens and ticks;
6. timings with CUDA events after warm-up, L2 flushed before each launch:
   each kernel and its plain version, beside a PyTorch call that computes
   the same function where there is one (a yardstick only; the port never
   calls it): ``scaled_dot_product_attention`` on gathered views beside
   ``paged_attention``, causal or under a boolean window mask beside
   ``flash_attention``, ``rms_norm`` with weight ``1 + w`` beside
   ``rmsnorm``, ``addcmul`` on [n / 256, 256] views with the scales as a
   column beside ``mrd_combine`` (with ``out.copy_(x)`` of the same fp32
   n: the card's streaming rate; and alone in bf16 at the same n); no
   single PyTorch call computes ``selective_scan``; and the least time
   the card could take (bytes at 3.35 TB/s, operations at the bf16 or
   fp32 peak, exponentials at the
   special function units' 16 a clock an SM at the card's largest SM
   clock); ``paged_attention`` also at 8 sequences x 4,096 positions
   beside SDPA on gathered views, and ``selective_scan``'s step instance
   at a decode tick's [8, 1, 8192, 16] beside its bound, and the scan's
   chunk-parallel form across blocks (2, 4 and 8 pieces of the 32k
   sequence, built from the chunked instance and held to it) beside it;
   the widened instances: ``flash_attention`` at [1, 4096] with 40/8
   heads, hd 128 (rep 5) and with 14/2 heads, hd 64 (rep 7), causal,
   beside SDPA with ``enable_gqa``, and ``paged_attention`` at qwen2.5-32b's
   decode shape (8 sequences, 40/8 heads, hd 128, 66 pages of 16) beside
   SDPA on gathered views; zamba2-2.7b's hd 80: ``flash_attention`` at
   [1, 32768], 32/32 heads, causal, beside SDPA and ``flash_scan``, and
   ``paged_attention`` at its decode tick (8 sequences, 32/32 heads, 260
   pages of 16) beside SDPA on gathered views;
7. the paper's asynchronous-iteration engine (``repro_torch.asynchrony``),
   which launches none of the kernels above (every launch count stays 0):
   7a. ``async-card-vs-cpu``: ``sweep`` on poisson1d n = 120, p = 5, 8
   seeds, the counter-based ``bernoulli`` draws, each of the five
   protocols, on the card and on the CPU: every integer equal, floats
   within 1e-5; 7b. ``async-paper-sweep``: ``bench_async``'s grid (every
   delay model x oracle, sync, inexact, exact, interval, 64 seeds a sweep)
   at the paper's configuration (``paper_poisson1d``: n = 10,000, rhs in
   +-10, shift 0.5, eps 1e-5, max_delay 1, activity 0.95) at p = 5 and
   16: every lane detected, ``exact``'s true residual below eps on every
   lane, detection delay >= 0 against the oracle (``check_rows``), and
   ``sync``'s collective messages = ticks x ``paper_message_count(p)``;
   each sweep's lanes, ticks, ms a tick, lane-ticks/s and wall; 7c. one
   ``exact`` sweep over activity 0.3 / 0.6 / 0.95 x 64 seeds (192 lanes)
   at p = 5 and 16, and a profile of its first 32 ticks (device busy and
   idle share, launches and the costliest kernels a tick); 7d.
   ``bench_detection``'s paper-size row (n = 10,000, shift 0, ``oracle``,
   p = 16, 300 ticks);
8. fixed-point serving (``fixedpoint_solve`` through ``make_workload``,
   ``ServeEngine`` and the CLI's ``serve``), which launches none of the
   kernels above (every launch count stays 0): 8a. the paper's
   configuration (poisson1d n = 10,000, shift 0.5, eps 1e-5), 16 slots, 32
   requests arriving two a tick, each with its own rhs in +-10, at dp = 5
   and 16 under ``residual_interval`` and ``residual_inexact``: every
   request converged, every solution's true residual under its own payload
   below eps, and the same runs on the CPU with equal admission and
   retirement ticks, iterations and ``converged`` and solutions within
   1e-5; ticks, ms a tick, solves/s, and (``residual_interval``) the wall
   and device time, idle share and launches of 32 steady ticks; 8b.
   ``d_iteration`` at n = 32,760 (a dense fp32 P of 4.29 GB) through the
   CLI: 64 personalization vectors of the reference CLI's stream queued at
   tick 0, dp 5, ``residual_interval``, eps 1e-10: every request converged
   with its true residual below eps, peak device memory, 32 steady ticks
   profiled, and the tick's [16, n] @ P^T GEMM timed alone against its
   byte bound;
9. the collectives layer (``repro_torch.collectives``), counted from 0:
   9a. ``device_fused``'s combine in a one-rank NCCL world on rank-local
   vectors: 256, 12,288 and the largest full-width bucket's 268,435,456
   elements reach ``mrd_combine`` (one launch each); 300 elements in
   60-blocks, 128-blocks and a 2-D payload take the unfused combine (no
   launch); every result equal to the plain version bit for bit, fp32 and
   bf16; the route timed at the largest bucket beside ``addcmul`` and its
   bound; 9b. ``tree_allreduce`` of llama3.2-1b's fp32 gradient tree at
   full width (the port's ``init_params`` shapes, N(0, 1) from a seed)
   stacked over p = 3 on the sim executor, 32 MiB buckets, under ``mrd``
   and ``rabenseifner`` x ``identity`` and ``int8``: every rank's result
   equal bit for bit, identity within 1e-5 of the float64 sum, int8
   within its grid's bound, ``mrd_combine`` launched once a reducing stage
   a bucket under int8 (never under identity), the int8 buckets of at most
   2^24 elements a rank equal to the same plan on the CPU bit for bit;
   wall and device time and ``mrd_combine``'s share; 9c. the same at p =
   5 (p0 = 4) on the tree cut to the embedding and 8 layers; 9d.
   ``BucketPipeline`` of the int8 rabenseifner plan on 9c's buckets, with
   admissions interleaved with ``advance()``, equal to ``run_buffers`` bit
   for bit; 9e. ``bench_mrd --quick`` on the card
   (``chiprun_out/bench_mrd.json``);
10. the rest of serving at llama3.2-1b's full width (random bf16 weights
   from the seed), each run counted from 0: 10a. the static path
   (``static_serve``: one ``make_cached_prefill_step`` of 8 x 512 tokens,
   then 64 greedy ``make_serve_step`` calls) with a bf16 and an int8 cache:
   16 ``flash_attention`` and 33 ``rmsnorm`` launches a forward, the int8
   cache exactly (hd + 4) / (2 hd) of the bf16 one's bytes, and the int8
   logits, teacher-forced with the bf16 run's tokens, within 0.06 of the
   largest bf16 logit at every step (the reference's bar); prefill tok/s,
   ms a decode step and its device time; 10b. 32 requests of two tenants
   (``chat`` with an 8-tick SLA, ``batch`` at a quota of 4 slots) arriving
   ``bursty:0.2,2.0`` through the CLI on ``llm_decode_paged --attn
   kernel``, ``sla_edf``, after a warm-up on the same stream, at
   ``--steps-per-dispatch`` 16 and 1: every
   request done, the quota held at every tick, equal tokens and ticks in
   both runs, ``paged_attention`` 16 a decode tick, ``flash_attention`` 16
   an admission; 10c. 16 requests sharing a 1024-token system prompt on the
   paged kernel path with ``share_prefixes`` on and off (equal tokens;
   blocks saved and the peak in use), then on int8 pages through the gather
   path (every request done, no ``paged_attention`` launch); 10d.
   ``bench_serve``'s rows on a cut grid (static baseline, a burst and a
   Poisson row, the sysprefix pair, the two kill/join rows (4 -> 3 -> 5 ->
   4), the fixed-point row at ``d_iteration`` n = 32,760, dp 5) under its
   ``--check`` gates
   (``chiprun_out/bench_serve_full_width.json``);
11. the remaining decoder families through the CLI's ``serve()``, random
   bf16 weights drawn on the card from seed 0, every run counted from 0:
   every request retires, ``paged_attention`` launches once a layer a
   decode tick on the paged pool, ``flash_attention`` once a layer an
   admission and ``rmsnorm`` 2 x layers + 1 a forward, no other kernel.
   11a. qwen2.5-32b at full width (64 layers, 65.5 GB): 16 requests,
   prompts 128-1024, budgets 16-32, 8 slots, blocks of 16, 66 pages a
   slot, dp 5, ``llm_decode_paged``; a profile of steady decode ticks;
   then the config cut to 4 layers (random qkv biases), its prefill logits
   for two prompts and 16 teacher-forced paged decode steps through the
   kernels against the same model on the plain path (``attn_impl="full"``,
   ``paged_attention_ref``, ``rmsnorm_ref``): every row's max |logit
   difference| under the bar, twice the spread between the two plain
   versions (``full`` and ``flash_scan``) relative to the row's largest
   plain logit (at least 0.01), and every top-1 token equal up to ties
   within the bar; 11b. internvl2-1b at full width, the same serving run,
   then a no-grad ``make_prefill_step`` of 256 stub patches + 512 tokens
   (two sequences), kernel path against plain path (the same bar); 11c.
   minicpm-2b at full width, 8 requests on the paged pool; 11d. mixtral-8x7b cut to
   16 of its 32 layers (the rest at published widths, 46.96 GB): 8
   requests of 4096-6144-token prompts (every one crosses the 4096-token
   window) on the contiguous pool, 4 slots, budgets 16-32, dp 3; the
   drops of a ``make_prefill_step`` over one 4096-token prompt are logged
   and an admission's forward over the longest served prompt drops
   nothing; 11e. llama4-scout cut to 8 of its 48 layers (37.4 GB, top-1 of
   16 experts, the 202,048-wide untied head): 8 requests on the paged
   pool;
12. zamba2-2.7b (the hybrid family) at full width through the CLI's
   ``serve()``: 54 mamba2 layers in 9 groups of 6, one weight-shared
   attention + MLP block (32/32 heads at hd 80) after each group with a KV
   cache of its own, random bf16 weights drawn on the card from seed 0,
   every run counted from 0, each model freed before the next loads:
   every request retires, ``paged_attention`` 9 calls a decode tick,
   ``flash_attention`` 9 launches an admission, ``rmsnorm`` 127 a forward
   (ln and the gated norm of each mamba2 layer, ln1/ln2 of each shared
   application, the final norm), ``selective_scan`` and ``mrd_combine``
   none.  12a. ``llm_decode_paged``: 16 requests, prompts 1024-4096,
   budgets 32-64, 8 slots, blocks of 16, 260 pages a slot, dp 3; the page
   pools' and the per-slot mamba2 state's bytes; a profile of steady
   decode ticks (wall and busy time a tick, idle share, launches, the
   costliest kernels); 12d. its whole-prompt ``make_prefill_step`` at
   32,768 tokens, batch 1 (the reference's prefill_32k cut to batch 1):
   wall time, tokens/s, peak memory and a profile by class and by the
   launching function (the SSD scans, the mamba2 layers); 12b.
   ``llm_decode``: 8 requests, prompts 1024-2048, 4 slots, dp 3; 12c. the
   config cut to 12 layers (2 groups), its prefill logits for two prompts
   and 16 teacher-forced paged decode steps through the kernels against
   the plain path, under 11a's bar; 12e. the smoke configs of minicpm-2b
   (hd 12) and internvl2-1b (hd 8) served on the paged pool through the
   kernels (6 requests, dp 3);
13. training every family on one card, random bf16 weights drawn on the
   card from seed 0: 13a. each family through the train CLI's
   ``main()`` at published widths, 2 x 1024 tokens a rank, ``--remat
   full``, a warm-up step and 2 counted ones, each run counted from 0:
   internvl2-1b whole, hubert-xlarge cut to 12 of its 48 layers,
   minicpm-2b to 18, falcon-mamba-7b to 4, zamba2-2.7b to 24 (4 groups) under
   ``compressed`` at dp 3; gemma3-12b cut to one group (5 local + 1
   global) under ``mrd_zero1`` at dp 2 and mixtral-8x7b to 1 layer under
   ``compressed`` at dp 2 (``TRAIN_FAMILIES`` says why): every loss and
   grad norm finite, ``mrd_combine`` launched once a reducing stage a
   bucket a step under ``compressed`` (never under ``mrd_zero1``), no other
   kernel (autograd takes the plain versions), the moe run's aux loss; ms a
   step, tokens/s and the peak; 13b. the smoke configs of gemma3,
   falcon-mamba, mixtral, llama4-scout, internvl2, zamba2 and hubert trained
   3 steps under ``compressed`` at dp 3 on the CPU, each step run on the
   card too from a copy of the CPU's state before it, on the same batches:
   losses atol 1e-4, grad norms rtol 5e-4, the monitor certifying at step
   3 on both, and the card's state after each step (params, masters,
   moments, EF residuals, monitor rows) against the CPU's under the
   family tests' int8 tie rule; the moe configs also run free, for the
   record of the tokens their drift reroutes; 13c. ``mrd_leaf`` and
   ``local_sgd`` at llama3.2-1b's full width, dp 3, 4 steps with
   ``local_sync_every`` 2: ms a step, the average's share of a sync step,
   and every replica's params equal bit for bit after each average; 13d.
   the checkpoint round trip (llama3.2-1b at full width cut to 1 layer,
   ``compressed``, dp 2): 5 steps, ``save(block=False)`` after steps 2
   and 3 (the second into the first's pinned buffers); then a fresh train
   step restored from step 3 through the CLI's resume path runs the same
   2 batches: its losses and final params equal bit for bit; each save's
   hold on the loop, the writer's time, the bytes, the step time with a
   write in flight; 13e. hubert-xlarge cut to 6 layers at remat
   ``none``, ``full`` and ``dots``: ms a step and the peak, the losses
   within 1e-4 relative;
   13f. hubert-xlarge's (remat ``full`` and ``dots``) and the falcon-mamba
   cut's train step profiled (wall, busy, idle share, the costliest
   kernels, device time by class and by launching function);
14. the multi-process trainer and the optimizers at llama3.2-1b's full
   width: 14a. the train CLI as a one-rank NCCL world
   (``torch.distributed.run --nproc-per-node 1`` in a subprocess, the
   ``device`` executor over a ``("data",)`` mesh) under ``compressed``,
   ``mrd_zero1`` and ``mrd_leaf``, 3 steps of 2 x 1024 tokens at
   ``--dp 1``, against the stacked-rows trainer at dp 1 in this process
   on the same card: losses, grad norms and the digest of the final
   params and optimizer state equal bit for bit; 14b. Lion and SGD in the
   stacked-rows trainer at dp 3 under ``compressed`` and ``mrd_leaf``, 3
   steps, counted from 0: every loss and grad norm finite,
   ``mrd_combine`` launched 2 reducing stages x buckets a step under
   ``compressed`` and never under ``mrd_leaf``, no other kernel; and the
   smoke config under ``compressed`` at dp 3 with each optimizer, each
   card step from the CPU's state held to the CPU's as in 13b;
15. the sharded entry points as one-rank NCCL worlds (14a's
   ``torch.distributed.run`` subprocess, :data:`WORLD_RUNNER`): the train
   CLI under its default ``gspmd`` (a ``("data",)`` mesh of 1, the
   params, optimizer trees and the step placed by ``sharding``), 3 steps
   of 2 x 1024 tokens of llama3.2-1b at full width, against the
   stacked-rows ``gspmd`` step at dp 1 in this process: losses, grad norms
   and the digest of the final state equal bit for bit; then the serving
   CLI's world entry (``launch.serve.run`` under the world's mesh) serving
   8 requests of llama3.2-1b on the paged kernel path against the plain
   CLI in this process: tokens, admission and retirement ticks equal;
   ``mrd_combine`` launched 0 times in the ``gspmd`` runs, and
   ``flash_attention``, ``paged_attention`` and ``rmsnorm`` more than 0
   times in both serving runs;
16. the ready-bucket overlap through the train CLI: llama3.2-1b at full
   width on stacked rows at dp 3 under ``compressed``, 3 steps of 2 x
   1024 tokens a rank with ``--no-overlap`` and 3 with ``--overlap`` (the
   backward in head, stack and embed segments, each gradient bucket
   entering the reduce-scatter as its segment completes): losses, grad
   norms and the digest of the final state equal bit for bit,
   ``mrd_combine`` launched once a reducing stage a bucket a step in both
   (the sim route), no other kernel; both runs' step times;
17. elastic serving through the serving CLI's ``main()`` under the
   reference CLI's script from dp 4 (kill 6:2, a 10x stall of replica 1 at
   tick 10, join 16:(4, 5), unstall 22:1, kill 26:0; ``grow_on_join``, 4
   ticks a dispatch): 17a. llama3.2-1b at full width on the paged kernel
   path, 24 Poisson requests on 8 slots, first uninterrupted at dp 4, then
   under the script, each counted from 0: the trajectory 4 -> 3 -> 5 -> 4,
   every request retired and prefilled once, its tokens those of the
   uninterrupted run, the allocator empty, ``flash_attention`` 16 an
   admission, ``paged_attention`` 16 a decode tick (and launched after the
   grow, on the pages and tables the joiner received), ``rmsnorm`` 33 a
   forward, the grow's params equal the source's leaf by leaf, its peak
   within the resident bytes + 5 x the largest leaf + 1 GiB; each resize's
   wall time and TTFT/TPOT p50 around it; 17b. ``d_iteration`` at n =
   32,760 under the same script: the same trajectory, every request
   certified with its true residual below eps 1e-10, no kernel launched;
18. the elastic trainer on stacked rows (``runtime.ElasticTrainer`` over
   replica ids 0-3, ``grow_on_join``): llama3.2-1b at full width cut to 4
   layers (random bf16 weights from seed 0) under ``compressed`` with the
   reference chaos suite's settings (remat none, the interval monitor at
   1e-6), 60 x 64 tokens a step, 10 steps of its headline script (kill 2
   at step 2, join 2 and 4 at 4, kill 1 at 7: 4 -> 3 -> 5 -> 4), counted
   from 0; then the oracle replay of the recorded resizes (the plain train
   step at each extent, joined by ``gradsync.migrate_state``) with the
   plain combine in the kernel's place.  Gates: the trajectory and its
   steps, no checkpoint restore, the losses and the digests of the params,
   master/moment rows, EF rows and monitor rows equal to the replay's, the
   joiners' params after the grow equal to the source's, ``mrd_combine``
   once a reducing stage a bucket a step at each step's extent (reckoned
   from the plans), no other kernel, the grow's peak within its bound;
   ms a step at each extent, each resize's migrate and broadcast times,
   tokens/s and the peak; 18b. ``gspmd.reshard_blocks`` at llama3.2-1b's
   full width: every leaf of the params and AdamW trees cut into its 4
   FSDP blocks, re-sharded to dp 3, then to dp 5, each set equal bit for
   bit to the global leaf cut directly at that extent, its time and peak,
   no kernel launched; 18c. in 14a's one-rank world subprocess, an
   elastic ``gspmd`` world of one rank with a checkpointer (llama3.2-1b at
   full width cut to 2 layers): 2 steps and a save, a fresh trainer's
   ``recover`` and 2 more steps, the losses equal to the uninterrupted
   4 steps' bit for bit, the save's and restore's bytes and times,
   ``mrd_combine`` at 0;
19. the kernels line, then the device line as the last line of stdout.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import importlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# one card: the first of those visible (set before torch initializes CUDA)
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
# the full-width train step frees and allocates multi-GB buffers of many
# sizes; growable segments keep the caching allocator from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: covers a call's host launch time
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
SERVE_ARGV = [
    "--arch", "llama3.2-1b", "--continuous", "--workload", "llm_decode_paged",
    "--attn", "kernel", "--dp", "3", "--slots", "8", "--requests", "16",
    "--prompt-len", "64", "--gen", "32", "--block-size", "16",
]
TRAIN_ARGV = [
    "--arch", "llama3.2-1b", "--steps", "4", "--batch", "6", "--seq", "1024", "--dp", "3",
    "--grad-sync", "compressed", "--device", "cuda",
]
# rows of the largest full-width gradient bucket (w1, w2, w3: 16 x 2048 x 8192)
BIG_BUCKET = 16 * 2048 * 8192
# mrd_combine element counts: one and three 256-blocks; the kernel's CUDA
# block (8 warps, a 256-block each: 2,048 elements) +- 256 and a last block
# with one live warp; the smoke config's [3, len] reduce-scatter rows
# (compressed, dp 3); a [3, 512 k] stacked shape; the largest bucket's
# [3, len] rows flattened
COMBINE_CASES = [256, 768, 1792, 2048, 2304, 5 * 2048 + 256, 6912, 12288, 13824, 24576, 49152,
                 3 * 512 * 7, 3 * BIG_BUCKET]
GEMMA_SERVE_ARGV = [
    "--arch", "gemma3-12b", "--continuous", "--workload", "llm_decode", "--dp", "3",
    "--slots", "4", "--requests", "8", "--min-prompt-len", "1024", "--prompt-len", "8192",
    "--gen", "32", "--device", "cuda",
]
PREFILL_LEN = 32768  # the reference's prefill_32k sequence length
FALCON_SERVE_ARGV = [
    "--arch", "falcon-mamba-7b", "--continuous", "--workload", "llm_decode", "--dp", "3",
    "--slots", "8", "--requests", "16", "--min-prompt-len", "1024", "--prompt-len", "8192",
    "--gen", "64", "--max-len", "8320", "--device", "cuda",
]
# selective_scan, materialized form (B, S, D, N): the reference kernel test's
# shapes, then falcon-mamba-7b's channels and state over 2048 steps
SCAN_CASES = [(1, 64, 16, 8), (2, 128, 32, 16), (1, 96, 64, 4), (1, 2048, 8192, 16)]
# fused form (the model's): a 4096-token prompt of falcon-mamba-7b from a
# nonzero state, and an 8-slot decode tick (one step from the state)
FUSED_SCAN_CASES = [(1, 4096, 8192, 16), (8, 1, 8192, 16), (1, 4097, 8192, 16),
                    (1, 1, 8192, 16)]
MUFU_EXP_PER_CLOCK = 16  # exponentials a clock an SM (sm_90 special function units)
H100_SMS = 132
# (B, Sq, Skv, H, KV, hd, causal, window, q_offset): gemma3-12b global and
# local layers (4096 tokens, then a served prompt's length that ends in a
# partial tile), llama3.2-1b (2048 tokens, then a served prompt's length),
# the gemma3 smoke config's local and global layers; then the edges of the
# bf16 kernel's tiling at every other hd x rep instance: q tiles (128 rows
# / rep) and key tiles (64 keys at hd 256, else 128) that end partway,
# windows that cut through a key tile, q_offset with a window, bidirectional
# attention, and query blocks whose rows see no key (they must write 0)
FLASH_CASES = [(1, 4096, 4096, 16, 8, 256, True, None, 0),
               (1, 4096, 4096, 16, 8, 256, True, 1024, 0),
               (1, 1755, 1755, 16, 8, 256, True, None, 0),
               (1, 1755, 1755, 16, 8, 256, True, 1024, 0),
               (1, 2048, 2048, 32, 8, 64, True, None, 0), (1, 37, 37, 32, 8, 64, True, None, 0),
               (1, 40, 40, 4, 2, 16, True, 16, 0), (1, 40, 40, 4, 2, 16, True, None, 0),
               (1, 150, 150, 2, 2, 16, True, 40, 0), (2, 70, 90, 8, 2, 16, False, 33, 0),
               (1, 260, 200, 4, 4, 64, True, None, 60), (2, 129, 129, 8, 4, 64, True, 100, 0),
               (1, 200, 100, 4, 2, 64, True, 64, 90), (2, 77, 130, 4, 4, 128, False, None, 0),
               (1, 333, 333, 8, 4, 128, True, 200, 0), (1, 100, 257, 8, 2, 128, True, 150, 157),
               (1, 517, 517, 4, 4, 256, True, 300, 0), (1, 90, 200, 16, 4, 256, False, None, 0),
               (1, 40, 70, 4, 1, 256, True, 16, 300),
               # phase 10's llama3.2-1b shapes: 10a's static prefill, 10c's
               # 1088-token system-prompt admissions, 10d's static waves
               (8, 512, 512, 32, 8, 64, True, None, 0), (1, 1088, 1088, 32, 8, 64, True, None, 0),
               (4, 64, 64, 32, 8, 64, True, None, 0),
               # phase 11's: qwen2.5-32b (rep 5, hd 128), internvl2-1b (rep 7),
               # mixtral-8x7b past its 4096-token window; then the rep 5 and 7
               # tiles' edges (24 / 18 positions a bf16 block, 6 / 4 in fp32)
               (1, 1024, 1024, 40, 8, 128, True, None, 0),
               (1, 512, 512, 14, 2, 64, True, None, 0),
               (1, 5000, 5000, 32, 8, 128, True, 4096, 0),
               (1, 100, 100, 5, 1, 16, True, None, 0), (2, 37, 60, 10, 2, 64, False, None, 0),
               (1, 50, 150, 5, 1, 128, True, 40, 100), (1, 61, 61, 10, 2, 256, True, 20, 0),
               (1, 77, 77, 7, 1, 16, True, 30, 0), (2, 19, 19, 14, 2, 64, True, None, 0),
               (1, 130, 90, 7, 1, 128, False, 33, 0), (1, 40, 70, 7, 1, 256, True, 16, 300),
               (1, 30, 200, 14, 2, 64, True, 8, 150), (1, 25, 50, 5, 1, 64, True, 4, 100),
               # phase 12's zamba2-2.7b shared block (32/32 heads, hd 80: bf16 in
               # five 16-column boxes) at 4096 tokens and a served prompt's
               # length; hd 80's tiling edges at every rep (partial q and key
               # tiles, q_offset, a window cutting a key tile, bidirectional,
               # queries that see no key); the smoke configs' hd 8 (internvl2-1b,
               # rep 7) and hd 12 (minicpm-2b, rep 1; and rep 2)
               (1, 4096, 4096, 32, 32, 80, True, None, 0),
               (1, 1755, 1755, 32, 32, 80, True, None, 0),
               (2, 129, 200, 4, 4, 80, True, 100, 71), (1, 77, 130, 4, 2, 80, False, None, 0),
               (1, 100, 257, 8, 2, 80, True, 150, 157), (1, 50, 150, 5, 1, 80, True, 40, 100),
               (1, 40, 70, 7, 1, 80, True, 16, 300), (1, 333, 333, 8, 8, 80, True, 200, 0),
               (2, 40, 40, 7, 1, 8, True, None, 0), (1, 60, 60, 14, 2, 8, True, 16, 0),
               (2, 40, 40, 6, 6, 12, True, None, 0), (1, 45, 90, 12, 6, 12, False, 20, 0)]
ZAMBA_FLASH = FLASH_CASES[-12]
# flash_attention per-row tolerance: the largest |out - ref| / |ref| over
# the hd-vectors of one (token, head); an atol alone passes late causal rows
# (outputs ~0.03 at 4096 keys) with any error below the atol
FLASH_ROW_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
# [T, d]: gemma3-12b (a 32k prefill's rows, a 4-slot decode tick), llama3.2-1b
# (an 8-slot decode tick, a 64-token prompt), the smoke configs, falcon-mamba-7b
# (a 32k prefill's rows, an 8-slot decode tick), then phase 10's llama3.2-1b
# rows (10a's 8 x 512-token static prefill, 10c's 1088-token admissions);
# fp32 and bf16 rows of these widths cover every template instance the paths
# launch
RMSNORM_CASES = [(32768, 3840), (4, 3840), (8, 2048), (64, 2048), (40, 64), (32768, 4096),
                 (8, 4096), (4096, 2048), (1088, 2048), (1024, 5120), (1024, 896), (1024, 2304),
                 # phase 12's zamba2-2.7b: the layer norms [T, 2560] and mamba2's
                 # gated norm over d_inner [T, 5120], an admission's and a tick's rows
                 (4096, 2560), (8, 2560), (4096, 5120), (8, 5120)]
# (S, H, KV, hd, nb, bs): the served full-width shape first, then the smoke
# shape, then rep 1 with 16-token blocks (every template family once), then
# llama3.2-1b's heads at long context (4,096 positions: 16 splits), then the
# tables phase 10 serves: 10b's 133 pages (2,128 positions: 9 splits, the
# last one ragged) and 10c's 71 (1,136 positions: 5 splits); then phase 11's
# heads over its 66-page tables (5 splits): qwen2.5-32b's and llama4-scout's
# (40/8, hd 128), internvl2-1b's (14/2, hd 64)
KERNEL_CASES = [(8, 32, 8, 64, 7, 16), (8, 4, 2, 16, 3, 8), (4, 4, 4, 16, 3, 16),
                (8, 32, 8, 64, 256, 16), (8, 32, 8, 64, 133, 16), (8, 32, 8, 64, 71, 16),
                (8, 40, 8, 128, 66, 16), (8, 14, 2, 64, 66, 16),
                # phase 12's zamba2-2.7b decode tick: 8 sequences of up to 4,160
                # positions (260 pages: 17 splits), 32/32 heads at hd 80; then
                # the smoke configs' heads: internvl2-1b's (7/1, hd 8) and
                # minicpm-2b's (6/6, hd 12)
                (8, 32, 32, 80, 260, 16), (3, 7, 1, 8, 5, 16), (3, 6, 6, 12, 5, 16)]
QWEN_PAGED = KERNEL_CASES[6]
ZAMBA_PAGED = KERNEL_CASES[8]
# (H, KV, hd) of the widened flash instances phase 6 times at 4096 tokens
FLASH_NEW_TIMED = [(40, 8, 128), (14, 2, 64)]


def ptxas_report(text: str) -> dict:
    """``nvcc -Xptxas=-v`` output -> {mangled entry: {"regs", "spill_stores",
    "spill_loads"}} (bytes of spill)."""
    out, entry = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            out[entry] = {"regs": 0, "spill_stores": 0, "spill_loads": 0}
        elif entry and "bytes spill stores" in line:
            words = line.replace(",", "").split()
            out[entry]["spill_stores"] = int(words[words.index("spill") - 2])
            out[entry]["spill_loads"] = int(words[-4])
        elif entry and "Used" in line and "registers" in line:
            words = line.split()
            out[entry]["regs"] = int(words[words.index("Used") + 1])
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float) -> float:
    t = time.perf_counter()
    log(f"# phase {name}: {t - t0:.1f} s")
    return t


def paged_inputs(seed, S, H, KV, hd, nb, bs, dtype, device="cuda"):
    """Random q + pools, a disjoint table over permuted physical blocks, and
    ragged lengths including a full row and a length-1 row."""
    rng = np.random.default_rng(seed)
    N = S * nb + 1
    q = torch.from_numpy(rng.standard_normal((S, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((N, bs, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((N, bs, KV, hd)).astype(np.float32))
    tables = rng.permutation(np.arange(1, N))[: S * nb].reshape(S, nb).astype(np.int32)
    lengths = rng.integers(1, nb * bs + 1, size=S).astype(np.int32)
    lengths[0], lengths[-1] = nb * bs, 1
    return ([t.to(device=device, dtype=dtype) for t in (q, k, v)]
            + [torch.from_numpy(a).to(device) for a in (tables, lengths)])


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` with the 50 MB L2 flushed before each call
    (the decode path finds its K/V cold: a tick streams all the weights).
    The flush reads a 64 MB buffer: a write would leave dirty lines whose
    write-back the timed call would pay for.

    A spin on the stream (~1 ms) precedes each call, so the host has queued
    the flush and the whole call before the device reaches them: the events
    time the device's work, not the host's launch latency."""
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):  # also writes back the lines zeros() left dirty
        flush.max()
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.max()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def device_profile(fn, reps: int, targets: dict | None = None):
    """Run ``fn`` ``reps`` times under ``torch.profiler`` (CUPTI kernel
    records): (device-busy ms per rep, {kernel name: (ms per rep, launches
    per rep)}, {label: device ms per rep}).  Each target function
    (``{label: (module, attribute)}``) is wrapped in a ``record_function``
    range of its label for the run, and the last dict holds the device time
    of the kernels launched inside each range on its thread: kernels of the
    generic elementwise and copy families carry no model name, so this
    attributes them to the function that launched them.  One profiled run
    gives both.

    The profiler's raw records are read directly (a kernel's
    ``linked_correlation_id`` names the host op that launched it), not
    through ``prof.events()``, whose event tree costs ~60 us of host time a
    record (tens of seconds for a 32k-token prefill).  The spans the
    profiler draws on the device timeline for ``record_function`` ranges
    (the plans' ``collective_plan``, the targets' labels) are not kernels
    and are not counted in the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    targets = targets or {}

    def wrap(label, f):
        def annotated(*a, **kw):
            with record_function(label):
                return f(*a, **kw)
        return annotated

    with contextlib.ExitStack() as stack:
        for label, (mod, attr) in targets.items():
            stack.enter_context(mock.patch.object(mod, attr, wrap(label, getattr(mod, attr))))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    by_name: dict = {}
    host_ops: dict = {}  # a host op's correlation id -> (start ns, thread)
    ranges: dict = {}  # (label, thread) -> [(start ns, end ns)]
    launched = []  # (kernel ms, the correlation id of the op that launched it)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            ms = e.duration_ns() / 1e6
            t_ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (t_ms + ms, n + 1)
            launched.append((ms, e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0:
            host_ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
            if e.name() in targets:
                ranges.setdefault((e.name(), e.start_thread_id()), []).append(
                    (e.start_ns(), e.end_ns()))
    if not by_name:
        raise SystemExit("the profiler recorded no device time")
    parts = dict.fromkeys(targets, 0.0)
    starts = {}
    for key, spans in ranges.items():  # a label's ranges on a thread do not overlap
        spans.sort()
        starts[key] = [a for a, _ in spans]
    for ms, corr in launched:
        if corr not in host_ops:
            continue
        t0, thread = host_ops[corr]
        for label in targets:
            spans = ranges.get((label, thread))
            i = bisect.bisect_right(starts[(label, thread)], t0) - 1 if spans else -1
            if i >= 0 and t0 <= spans[i][1]:
                parts[label] += ms
    busy_ms = sum(ms for ms, _ in by_name.values()) / reps
    return (busy_ms, {k: (ms / reps, n / reps) for k, (ms, n) in by_name.items()},
            {k: v / reps for k, v in parts.items()})


def top_kernels(per_rep: dict, top: int = 8):
    return sorted(per_rep.items(), key=lambda kv: -kv[1][0])[:top]


def profile_decode(wl, reqs, ticks: int = 4, targets: dict | None = None):
    """Admit ``reqs`` into every slot of ``wl`` and run steady decode ticks:
    (host wall ms per tick, device-busy ms per tick, every kernel's entry
    by name, device ms per tick of each of ``targets`` as
    :func:`device_profile` gives them).  The wall time is taken without the
    profiler; the device time with it."""
    wl.reset()
    for slot, req in enumerate(reqs[: wl.slots]):
        wl.admit(req, slot, 0)
    active = np.ones(wl.slots, bool)
    for _ in range(2):
        wl.step(active)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(ticks):
        wl.step(active)  # ends in a device-to-host copy of the tokens
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / ticks
    return (wall_ms, *device_profile(lambda: wl.step(active), ticks, targets))


def to_device(tree, device):
    """A deep copy of a state tree (dicts of tensors and host scalars) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True) if isinstance(tree, torch.Tensor) else tree


def combine_inputs(n: int, dtype, seed: int):
    """x ~ N(0, 1), q uniform in [-127, 127], positive scales: drawn on the
    card (the largest case is 805 M elements)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=gen, device="cuda").to(dtype)
    q = torch.randint(-127, 128, (n,), generator=gen, device="cuda", dtype=torch.int8)
    s = torch.rand(n // 256, generator=gen, device="cuda") * 0.1 + 1e-4
    return x, q, s


def flash_inputs(B, Sq, Skv, H, KV, hd, dtype, seed):
    """q, k, v ~ N(0, 1) drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(sh, generator=gen, device="cuda").to(dtype)
            for sh in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


def scan_inputs(B, S, D, N, dtype, seed):
    """The materialized scan's inputs, drawn on the card: decay in (0, 1) (a
    well-conditioned recurrence, like exp(dt A)), bx ~ 0.1 N(0, 1), cs ~
    N(0, 1), all in ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    decay = torch.sigmoid(torch.randn(B, S, D, N, generator=gen, device="cuda")).to(dtype)
    bx = (torch.randn(B, S, D, N, generator=gen, device="cuda") * 0.1).to(dtype)
    return decay, bx, torch.randn(B, S, N, generator=gen, device="cuda").to(dtype)


def fused_scan_inputs(B, S, D, N, dtype, seed):
    """The mamba1 block's scan inputs at its scales, drawn on the card: dt =
    softplus(N(-4, 1)) fp32, x, Bs, Cs ~ N(0, 1) in ``dtype``, A = -(1..N)
    for every channel (``-exp(A_log)`` at init), h0 ~ 0.5 N(0, 1) fp32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(B, S, D, generator=gen, device="cuda") - 4)
    x = torch.randn(B, S, D, generator=gen, device="cuda").to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda").expand(D, N).contiguous()
    Bs, Cs = (torch.randn(B, S, N, generator=gen, device="cuda").to(dtype) for _ in range(2))
    return dt, x, A, Bs, Cs, torch.randn(B, D, N, generator=gen, device="cuda") * 0.5


def scan_err(out, ref) -> tuple:
    """(max abs error, elements outside |out - ref| <= 1e-5 + 1e-4 |ref|):
    kernel and plain version both compute in fp32 from the same inputs."""
    delta = (out - ref).abs()
    return delta.max().item(), int((delta > 1e-5 + 1e-4 * ref.abs()).sum())


def sdpa_ms(q, k, v, mask, iters: int):
    """Time of ``scaled_dot_product_attention`` (a yardstick: the port never
    calls it) on q [B,S,H,hd], k/v [B,S,KV,hd]: causal, or under a boolean
    ``mask``.  Fused backends only (the math backend would materialize the
    scores); GQA through ``enable_gqa`` where a fused backend takes it, else
    on K/V repeated to every head.  Returns (ms, how); (nan, the error) when
    no fused backend takes the call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(attn_mask=mask, is_causal=mask is None)
    what = "causal" if mask is None else "boolean window mask"
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    with sdpa_kernel(fused):
        try:
            sdpa(qt, kt, vt, enable_gqa=True, **kw)
            how, gqa = "enable_gqa", {"enable_gqa": True}
        except RuntimeError:
            rep = q.shape[2] // k.shape[2]
            kt, vt = kt.repeat_interleave(rep, dim=1), vt.repeat_interleave(rep, dim=1)
            how, gqa = "K/V repeated to every head", {}
            try:
                sdpa(qt, kt, vt, **kw)
            except RuntimeError as e:
                return float("nan"), f"{what}: no fused backend takes it ({str(e)[:300]})"
        ms = time_ms(lambda: sdpa(qt, kt, vt, **gqa, **kw), iters=iters, warmup=2)
    return ms, f"{what}, {how}"


def paged_timing(case, seed: int = 3) -> dict:
    """``paged_attention`` at (S, H, KV, hd, nb, bs) in bf16: the kernel,
    its plain version and ``scaled_dot_product_attention`` on K/V gathered
    through the table and repeated to every head (a yardstick: the port
    never calls it), and the least time the card could take: K and V of
    the live positions, q, the output, the table and the lengths moved
    once, at 3.35 TB/s."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    S, H, KV, hd, nb, bs = case
    q, k, v, tables, lens = paged_inputs(seed, *case, torch.bfloat16)
    ms = time_ms(lambda: ops.paged_attention(q, k, v, tables, lens))
    plain_ms = time_ms(lambda: paged_attention_ref(q, k, v, tables, lens))
    W = nb * bs
    kg = k[tables.long()].reshape(S, W, KV, hd).transpose(1, 2).repeat_interleave(H // KV, 1)
    vg = v[tables.long()].reshape(S, W, KV, hd).transpose(1, 2).repeat_interleave(H // KV, 1)
    mask = (torch.arange(W, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qg = q[:, :, None, :]
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mask))
    tot = int(lens.sum())
    n_bytes = (2 * q.numel() * q.element_size()  # q in, out written
               + 2 * tot * KV * hd * k.element_size()  # K and V of live positions
               + tables.numel() * 4 + lens.numel() * 4)
    n_ops = 4 * tot * H * hd  # q.k and p.v, a multiply-add each
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"timings paged_attention at S,H,KV,hd,nb,bs={case} bf16, sum(lengths)={tot}, "
        f"splits {ops.split_plan(nb, bs)[1]}: kernel {ms * 1e3:.2f} us | plain "
        f"{plain_ms * 1e3:.2f} us | sdpa on gathered views {library_ms * 1e3:.2f} us | bound "
        f"{bound_ms * 1e3:.3f} us ({n_bytes} bytes at 3.35 TB/s; ops bound "
        f"{ops_ms * 1e3:.4f} us) | kernel / sdpa {ms / library_ms:.3f}, bound / kernel "
        f"{bound_ms / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def kernel_classes(per_rep: dict, busy_ms: float) -> dict:
    """Device time per rep by class: the port's kernels, GEMMs, the rest."""
    kernels = {"flash_attention": ("flash_wgmma_kernel", "flash_f32_kernel"),
               "rmsnorm": ("rmsnorm_kernel",), "mrd_combine": ("mrd_combine_kernel",),
               "selective_scan": ("selective_scan_kernel", "selective_scan_step_kernel"),
               "paged_attention": ("paged_attention_kernel", "paged_attention_combine_kernel"),
               "GEMM": ("nvjet", "gemm", "cutlass", "sm90_")}
    classes = dict.fromkeys([*kernels, "other"], 0.0)
    for name, (ms, _) in per_rep.items():
        key = next((k for k, marks in kernels.items()
                    if any(m in name.lower() for m in marks)), "other")
        classes[key] += ms
    log("  device time by class: " + ", ".join(
        f"{k} {v:.3f} ms ({v / busy_ms:.3f})" for k, v in classes.items()))
    return classes


ASYNC_PROTOCOLS = ("oracle", "sync", "inexact", "exact", "interval")
ASYNC_SEEDS = 64  # lanes a sweep of the paper's configuration
ACTIVITY_GRID = (0.3, 0.6, 0.95)  # the exact sweep's grid over bernoulli's activity
PROFILE_TICKS = 32  # ticks of that sweep under the profiler


def async_phases(all_ops, t: float) -> dict:
    """7. The paper's asynchronous-iteration engine on the card: the card
    against the CPU, the paper's n = 10,000 sweeps and a profile of one.
    The engine launches none of the port's kernels, so every launch count
    stays 0 through these phases."""
    from repro_torch import asynchrony
    from repro_torch.benchmarks import bench_async, bench_detection
    from repro_torch.collectives import schedules
    from repro_torch.configs.paper_poisson1d import CONFIG as PAPER

    for op in all_ops:
        op.launches = 0
    stats: dict = {"card_vs_cpu": {}, "sweeps": [], "exact_activity_grid": {}}

    # 7a. the same sweeps on the card and on the CPU: the counter-based
    # draws are the same on both, so the integers must be equal
    fp = asynchrony.make_solver("poisson1d", n=120, shift=0.5, seed=0)
    for det in ASYNC_PROTOCOLS:
        cfg = asynchrony.AsyncConfig(p=5, detection=det, delay_model="bernoulli", eps=1e-5,
                                     max_ticks=50000, max_delay=2, activity=0.7)
        card = asynchrony.sweep(fp, cfg, range(8), device="cuda")
        cpu = asynchrony.sweep(fp, cfg, range(8), device="cpu")
        for f in ("detected", "ticks", "kiter", "messages_p2p", "messages_coll"):
            if not np.array_equal(getattr(card, f), getattr(cpu, f)):
                raise SystemExit(f"async {det}: {f} differs between the card and the CPU")
        diff = max(float(np.abs(getattr(card, f) - getattr(cpu, f)).max())
                   for f in ("x", "res_glb", "true_res"))
        if diff > 1e-5 or not card.detected.all():
            raise SystemExit(f"async {det}: card against CPU {diff:.3e} (atol 1e-5), "
                             f"detected {card.detected.tolist()}")
        log(f"async card vs CPU (poisson1d n 120, p 5, 8 seeds, bernoulli), {det}: integers "
            f"equal, mean ticks {card.ticks.mean():.1f}, largest float difference {diff:.3e}")
        stats["card_vs_cpu"][det] = diff
    t = phase("async-card-vs-cpu", t)

    # 7b. bench_async's grid at the paper's configuration (n 10,000, shift
    # 0.5, eps 1e-5, max_delay 1, activity 0.95), 64 seeds a sweep
    def on_sweep(p):
        def check(row, r):
            lanes, slowest, wall = row["lanes"], row["slowest_ticks"], row["wall_s"]
            log(f"  p {p:2d} {row['model']:>13} {row['protocol']:>8}: {lanes} lanes, mean ticks "
                f"{r.ticks.mean():7.1f}, slowest {slowest:4d}, {wall / slowest * 1e3:.3f} ms a "
                f"tick, {lanes * slowest / wall:10.0f} lane-ticks/s, wall {wall:.3f} s")
            if not r.detected.all():
                raise SystemExit(f"async {row['name']}: a lane was not detected")
            if row["protocol"] == "exact" and not (r.true_res < PAPER.eps).all():
                raise SystemExit(f"async {row['name']}: exact certified true_res "
                                 f"{r.true_res.max():.3e} >= eps")
            if row["protocol"] == "sync" and not (
                    r.messages_coll == r.ticks * schedules.paper_message_count(p)).all():
                raise SystemExit(f"async {row['name']}: messages_coll != ticks x "
                                 f"paper_message_count({p})")
            stats["sweeps"].append({k: row[k] for k in (
                "name", "lanes", "slowest_ticks", "wall_s", "mean_ticks")})
        return check

    for p in (5, 16):
        rows = bench_async.run_sweeps(PAPER.n, p, range(ASYNC_SEEDS),
                                      sorted(asynchrony.DELAY_MODELS), PAPER.eps, device="cuda",
                                      on_sweep=on_sweep(p))
        log(f"async p {p}: detection delay >= the oracle's on {bench_async.check_rows(rows)} rows")
    t = phase("async-paper-sweep", t)

    # 7c. one exact sweep over bernoulli's activity x 64 seeds (192 lanes),
    # then its first PROFILE_TICKS ticks (every lane running) without and
    # with the profiler: wall and device time a tick, kernels by name
    fp = asynchrony.make_solver("poisson1d", n=PAPER.n, shift=PAPER.shift, seed=0)
    grid = {"activity": torch.tensor(ACTIVITY_GRID)}
    for p in (5, 16):
        def one(max_ticks):
            cfg = asynchrony.AsyncConfig(p=p, detection="exact", eps=PAPER.eps,
                                         max_ticks=max_ticks, max_delay=PAPER.max_delay,
                                         activity=PAPER.activity)
            return asynchrony.sweep(fp, cfg, range(ASYNC_SEEDS), delay_params=grid,
                                    device="cuda")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        r = one(60000)
        wall_ms = (time.perf_counter() - t1) * 1e3
        if not (r.detected.all() and (r.true_res < PAPER.eps).all()):
            raise SystemExit(f"async exact activity grid p {p}: a lane undetected or unsound")
        slowest = int(r.ticks.max())
        log(f"async exact, p {p}, activity {list(ACTIVITY_GRID)} x {ASYNC_SEEDS} seeds "
            f"({r.ticks.size} lanes): mean ticks by activity "
            f"{[round(float(v), 1) for v in r.ticks.mean(axis=1)]}, slowest {slowest}, wall "
            f"{wall_ms:.1f} ms, {wall_ms / slowest:.3f} ms a tick, "
            f"{r.ticks.size * slowest / wall_ms * 1e3:.0f} lane-ticks/s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one(PROFILE_TICKS + 1)
        part_ms = (time.perf_counter() - t1) * 1e3
        busy_ms, per_rep, _ = device_profile(lambda: one(PROFILE_TICKS + 1), 1)
        launches = sum(n for _, n in per_rep.values()) / PROFILE_TICKS
        log(f"  its first {PROFILE_TICKS} ticks: wall {part_ms / PROFILE_TICKS:.3f} ms a tick, "
            f"device busy {busy_ms / PROFILE_TICKS:.3f} ms a tick, idle share "
            f"{1 - busy_ms / part_ms:.3f}, {launches:.1f} launches a tick")
        for name, (ms_r, n_r) in top_kernels(per_rep, 8):
            log(f"  {ms_r / PROFILE_TICKS:9.4f} ms {n_r / PROFILE_TICKS:6.1f} launches a tick  "
                f"{name[:100]}")
        stats["exact_activity_grid"][str(p)] = {
            "lanes": int(r.ticks.size), "slowest_ticks": slowest, "wall_ms": wall_ms,
            "ms_per_tick": wall_ms / slowest, "profiled_ms_per_tick": part_ms / PROFILE_TICKS,
            "busy_ms_per_tick": busy_ms / PROFILE_TICKS, "idle_share": 1 - busy_ms / part_ms,
            "launches_per_tick": launches}

    # 7d. bench_detection's paper-size row: n 10,000, shift 0, oracle, p 16,
    # 300 ticks
    res, us = bench_detection.paper_scale_row("cuda")
    log(f"async paper_n10000_res_after_300_ticks: residual {res.res_glb:.4e} after {res.ticks} "
        f"ticks, wall {us / 1e3:.1f} ms ({us / 1e3 / res.ticks:.3f} ms a tick, one lane)")
    if not np.isfinite(res.res_glb) or res.detected:
        raise SystemExit(f"paper-size row: {res.res_glb} detected {res.detected}")
    stats["paper_n10000_res_after_300_ticks"] = res.res_glb
    if any(op.launches for op in all_ops):
        raise SystemExit("the asynchronous engine launched a kernel: "
                         f"{[op.launches for op in all_ops]}")
    t = phase("async-profile", t)
    return stats


FP_SLOTS = 16  # pool slots of both fixed-point phases
FP_PAPER_REQUESTS = 32  # 8a: two arrive a tick, each with its own rhs
FP_PAPER_RUNS = ((5, "residual_interval"), (5, "residual_inexact"), (16, "residual_interval"),
                 (16, "residual_inexact"))
FP_DITER_N = 32760  # 8b: divisible by 3, 5, 7 and 8; the dense fp32 P is 4.29 GB
FP_DITER_ARGV = ["--continuous", "--workload", "fixedpoint_solve", "--solver", "d_iteration",
                 "--n", str(FP_DITER_N), "--dp", "5", "--slots", str(FP_SLOTS), "--requests",
                 "64", "--eps", "1e-10", "--gen", "1000", "--termination",
                 "residual_interval"]
FP_BUDGET = 1000  # iteration budget of every fixed-point request
GEMM_MARKS = ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "splitk")


def fixedpoint_true_residuals(wl, res, payloads) -> np.ndarray:
    """``||f(x) - x||_inf`` of every result's solution under its own
    payload, on the pool's device (one batched map)."""
    ids = sorted(res)
    dev = wl.device
    x = torch.from_numpy(np.stack([res[i].output for i in ids])).to(dev)
    v = torch.from_numpy(np.stack([payloads[i] for i in ids])).to(dev)
    return (wl.pool.param_map(x, v) - x).abs().amax(dim=-1).cpu().numpy()


def fixedpoint_steady(wl, dp: int, termination: str, payloads) -> dict:
    """PROFILE_TICKS engine steps with every slot busy on requests that
    cannot certify (eps 0) after 4 warm-up steps: wall and device time a
    tick (the profiler's second pass over the same window length), idle
    share, launches and kernels by name."""
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    wl.reset()
    eng = ServeEngine(wl, ServeConfig(termination=termination, dp=dp, eps=0.0))
    for i in range(wl.slots):
        eng.submit(Request(id=i, payload=payloads[i % len(payloads)], max_new=10**6))

    def ticks():
        for _ in range(PROFILE_TICKS):
            eng.step()

    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ticks()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3 / PROFILE_TICKS
    busy_ms, per_rep, _ = device_profile(ticks, 1)
    if eng.results:
        raise SystemExit(f"fixed-point steady window: {len(eng.results)} requests retired")
    busy_ms /= PROFILE_TICKS
    gemm_ms = sum(ms for name, (ms, _) in per_rep.items()
                  if any(m in name.lower() for m in GEMM_MARKS)) / PROFILE_TICKS
    launches = sum(n for _, n in per_rep.values()) / PROFILE_TICKS
    log(f"  {PROFILE_TICKS} steady ticks, {wl.slots} slots busy: wall {wall_ms:.3f} ms a tick, "
        f"device busy {busy_ms:.4f} ms a tick, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{launches:.1f} launches a tick, GEMM {gemm_ms:.4f} ms a tick")
    for name, (ms_r, n_r) in top_kernels(per_rep, 6):
        log(f"  {ms_r / PROFILE_TICKS:9.4f} ms {n_r / PROFILE_TICKS:5.1f} launches a tick  "
            f"{name[:100]}")
    return {"wall_ms_per_tick": wall_ms, "busy_ms_per_tick": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "launches_per_tick": launches,
            "gemm_ms_per_tick": gemm_ms}


def fixedpoint_run_stats(eng, res) -> dict:
    """Ticks, wall, ms a tick, solves/s, slot-iterations/s and request
    latency (arrival to retirement: ticks, and the wall seconds of TTFT +
    the iterations)."""
    s = eng.summary()
    rs = list(res.values())
    lat_ticks = np.asarray([r.retire_tick - r.arrival + 1 for r in rs], np.float64)
    lat_s = np.asarray([r.ttft_s + r.tpot_s * (r.n_tokens - 1) for r in rs], np.float64)
    return {"requests": len(rs), "ticks": s["ticks"], "wall_s": s["wall_s"],
            "ms_per_tick": s["wall_s"] / s["decode_ticks"] * 1e3,
            "solves_per_s": len(rs) / s["wall_s"],
            "slot_iterations_per_s": s["tokens_out"] / s["wall_s"],
            "mean_iterations": float(np.mean([r.n_tokens for r in rs])),
            "latency_p50_ticks": float(np.percentile(lat_ticks, 50)),
            "latency_p50_s": float(np.percentile(lat_s, 50)),
            "occupancy": s["occupancy"]}


def fixedpoint_phases(all_ops, t: float) -> dict:
    """8. Fixed-point serving on the card through the normal entry points
    (``make_workload``, ``ServeEngine``, the CLI's ``serve``): the paper's
    poisson1d configuration against the CPU, then the device-bound
    d_iteration at n = 32,760.  No kernel lies on this path, so every
    launch count stays 0 through these phases."""
    from repro_torch.configs.paper_poisson1d import CONFIG as PAPER
    from repro_torch.launch import serve
    from repro_torch.serving import Request, ServeConfig, ServeEngine, make_workload

    for op in all_ops:
        op.launches = 0
    stats: dict = {"paper_poisson1d": {}, "d_iteration": {}}

    # 8a. the paper's configuration (poisson1d n 10,000, shift 0.5, eps
    # 1e-5): 32 requests, two a tick, each with its own rhs in +-10
    rng = np.random.default_rng(0)
    rhs = [rng.uniform(PAPER.rhs_low, PAPER.rhs_high, PAPER.n).astype(np.float32)
           for _ in range(FP_PAPER_REQUESTS)]

    def paper_run(dp, termination, device):
        wl = make_workload("fixedpoint_solve", solver="poisson1d", n=PAPER.n, shift=PAPER.shift,
                           slots=FP_SLOTS, dp=dp, device=device)
        eng = ServeEngine(wl, ServeConfig(termination=termination, dp=dp, eps=PAPER.eps))
        res = eng.run([Request(id=i, arrival=i // 2, payload=rhs[i], max_new=FP_BUDGET)
                       for i in range(FP_PAPER_REQUESTS)])
        return wl, eng, res

    for dp, term in FP_PAPER_RUNS:
        name = f"dp{dp}_{term}"
        wl, eng, res = paper_run(dp, term, "cuda")
        cpu_wl, _, cpu_res = paper_run(dp, term, "cpu")
        true_res = fixedpoint_true_residuals(wl, res, rhs)
        st = fixedpoint_run_stats(eng, res)
        diff = max(float(np.abs(res[i].output - cpu_res[i].output).max()) for i in res)
        same = all((res[i].admit_tick, res[i].retire_tick, res[i].n_tokens, res[i].converged)
                   == (cpu_res[i].admit_tick, cpu_res[i].retire_tick, cpu_res[i].n_tokens,
                       cpu_res[i].converged) for i in res)
        log(f"fixed-point poisson1d n {PAPER.n}, {name}: {st['requests']} requests in "
            f"{st['ticks']} ticks, wall {st['wall_s']:.3f} s, {st['ms_per_tick']:.3f} ms a tick, "
            f"{st['solves_per_s']:.1f} solves/s, {st['slot_iterations_per_s']:.0f} "
            f"slot-iterations/s, mean iterations {st['mean_iterations']:.1f}, latency p50 "
            f"{st['latency_p50_ticks']:.0f} ticks / {st['latency_p50_s'] * 1e3:.1f} ms; converged "
            f"{sum(r.converged for r in res.values())}/{len(res)}, largest true residual "
            f"{true_res.max():.3e} (eps {PAPER.eps}); against the CPU: integers "
            f"{'equal' if same else 'DIFFER'}, largest solution difference {diff:.3e}")
        if len(res) != FP_PAPER_REQUESTS or not all(r.converged for r in res.values()):
            raise SystemExit(f"fixed-point {name}: a request did not converge")
        if not (true_res < PAPER.eps).all():
            raise SystemExit(f"fixed-point {name}: true residual {true_res.max():.3e} >= eps")
        if not same or diff > 1e-5:
            raise SystemExit(f"fixed-point {name}: card against CPU, integers equal {same}, "
                             f"solutions {diff:.3e} (atol 1e-5)")
        if term == "residual_interval":
            st["steady"] = fixedpoint_steady(wl, dp, term, rhs)
        stats["paper_poisson1d"][name] = {**st, "max_true_residual": float(true_res.max()),
                                          "cpu_max_solution_diff": diff}
        del wl, cpu_wl
    t = phase("fixedpoint-paper-poisson1d", t)

    # 8b. d_iteration at n 32,760 through the CLI's serve(): 64 requests of
    # the reference CLI's personalization vectors, queued at tick 0, dp 5,
    # eps 1e-10; a tick is one [16, n] @ P^T fp32 GEMM (TF32 off) and a few
    # elementwise passes
    args = serve.build_parser().parse_args(FP_DITER_ARGV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    eng, wl, res = serve.serve(args)
    total_s = time.perf_counter() - t1
    eps = args.eps
    payloads = {r.id: r.payload for r in serve.make_fixedpoint_requests(
        args.requests, args.n, args.gen, args.seed)}
    true_res = fixedpoint_true_residuals(wl, res, payloads)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    st = fixedpoint_run_stats(eng, res)
    certified = np.asarray([res[i].certified for i in sorted(res)])
    n = args.n
    p_bytes = n * n * 4
    gemm_bytes = p_bytes + 2 * FP_SLOTS * n * 4  # P, x read once; the product written once
    gemm_bytes_ms = gemm_bytes / HBM_BYTES_PER_S * 1e3
    gemm_ops_ms = 2 * FP_SLOTS * n * n / FP32_FLOPS * 1e3
    gemm_bound_ms = max(gemm_bytes_ms, gemm_ops_ms)
    log(f"fixed-point d_iteration n {n} (P {p_bytes} B), dp 5, residual_interval, eps {eps}: "
        f"{st['requests']} requests in {st['ticks']} ticks, wall {st['wall_s']:.3f} s "
        f"(serve() {total_s:.3f} s with the operator's build), {st['ms_per_tick']:.3f} ms a tick, "
        f"{st['solves_per_s']:.2f} solves/s, {st['slot_iterations_per_s']:.0f} "
        f"slot-iterations/s, mean iterations {st['mean_iterations']:.1f}, latency p50 "
        f"{st['latency_p50_ticks']:.0f} ticks / {st['latency_p50_s'] * 1e3:.1f} ms; converged "
        f"{sum(r.converged for r in res.values())}/{len(res)}, certified up to "
        f"{certified.max():.3e}, true residual up to {true_res.max():.3e}; peak device memory "
        f"{peak_gib:.3f} GiB")
    if len(res) != args.requests or not all(r.converged for r in res.values()):
        raise SystemExit("fixed-point d_iteration: a request did not converge")
    if not (true_res < eps).all():
        raise SystemExit(f"fixed-point d_iteration: true residual {true_res.max():.3e} >= eps")
    steady = fixedpoint_steady(wl, args.dp, args.termination, list(payloads.values()))
    x = torch.rand((FP_SLOTS, n), device="cuda")
    P = wl.base.data["P"]
    gemm_ms = time_ms(lambda: torch.matmul(x, P.t()), iters=20)
    log(f"  the tick's GEMM [{FP_SLOTS}, {n}] @ P^T alone: {gemm_ms:.4f} ms against its bound "
        f"{gemm_bound_ms:.4f} ms ({gemm_bytes} bytes at 3.35 TB/s; fp32 flop "
        f"{gemm_ops_ms:.4f} ms at 67 TFLOP/s): bound / GEMM {gemm_bound_ms / gemm_ms:.3f}")
    stats["d_iteration"] = {**st, "n": n, "p_bytes": p_bytes, "eps": eps,
                            "max_true_residual": float(true_res.max()),
                            "max_certified": float(certified.max()), "peak_gib": peak_gib,
                            "steady": steady, "gemm_ms": gemm_ms, "gemm_bound_ms": gemm_bound_ms}
    del x, P, eng, wl
    torch.cuda.empty_cache()
    if any(op.launches for op in all_ops):
        raise SystemExit("fixed-point serving launched a kernel: "
                         f"{[op.launches for op in all_ops]}")
    t = phase("fixedpoint-d-iteration", t)
    return stats


COLL_BUCKET_BYTES = 32 * 2**20  # the gradient sync's bucket cap
COLL_CPU_ELEMS = 2**24  # 9b: buckets of at most this many elements a rank rerun on the CPU
COLL_CUT_LAYERS = 8  # 9c: llama3.2-1b cut to the embedding + 8 layers at p = 5
# 9a: (case, rank-local shape, int8 block, routed to the kernel)
ROUTE_CASES = [("256 elements", (256,), 256, True), ("12,288 elements", (12288,), 256, True),
               ("the largest bucket", (BIG_BUCKET,), 256, True),
               ("300 elements, block 60", (300,), 60, False),
               ("12,288 elements, block 128", (12288,), 128, False),
               ("2-D [48, 256]", (48, 256), 256, False)]


def grad_tree(cfg, p: int, seed: int, device):
    """An fp32 gradient-shaped tree of ``cfg`` (the shapes of the port's
    ``init_params``) stacked over ``p`` ranks, N(0, 1) drawn on ``device``
    from ``seed``."""
    from repro_torch.collectives import buckets
    from repro_torch.models import transformer

    params = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    leaves, treedef = buckets.tree_flatten(params)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    del params, leaves
    gen = torch.Generator(device=device).manual_seed(seed)
    return buckets.tree_unflatten(treedef, [torch.randn((p,) + s, generator=gen, device=device)
                                            for s in shapes])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def fused_route(device) -> dict:
    """9a. ``FusedDeviceBackend.combine_quantized`` on rank-local vectors, in
    a one-rank world (NCCL on the card): 256-blocks of a 1-D vector go to
    the kernel (one launch each), any other payload to the plain combine
    (none); every result equals the plain version bit for bit, fp32 and
    bf16.  Then the route's time at the largest bucket (those launches
    are not counted)."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.collectives.executors import FusedDeviceBackend
    from repro_torch.collectives.transforms import quantize
    from repro_torch.kernels.mrd_combine import mrd_combine
    from repro_torch.kernels.mrd_combine.ref import mrd_combine_ref

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cuda = device.type == "cuda"
    kw = {}
    if cuda:  # the rank's card, set before the group and the mesh
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, **kw)
    try:
        mesh = init_device_mesh(device.type, (1,), mesh_dim_names=("data",))
        be = FusedDeviceBackend("data", mesh)
        rows = []
        for case, shape, block, kernel in ROUTE_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device=device).manual_seed(len(rows))
                x = torch.randn(shape, generator=gen, device=device).to(dtype)
                q, s = quantize(torch.randn(shape, generator=gen, device=device) * 3, block)
                n0 = mrd_combine.launches
                out = be.combine_quantized(x, q, s, block)
                launched = mrd_combine.launches - n0
                want = mrd_combine_ref(x.reshape(-1), q.reshape(-1), s.reshape(-1),
                                       block).reshape(shape)
                _sync(device)
                same = out.dtype == dtype and torch.equal(out, want)
                err = (out.float() - want.float()).abs().max().item()
                log(f"  device_fused combine, {case} {str(dtype)[6:]}: "
                    f"{'kernel' if launched else 'unfused'} ({launched} mrd_combine launch), "
                    f"equal to the plain version bit for bit: {same}")
                if not same or launched != int(kernel):
                    raise SystemExit(f"device_fused routing of {case} {dtype}: {launched} "
                                     f"launches, bit for bit {same}")
                rows.append({"case": case, "dtype": str(dtype)[6:], "launches": launched,
                             "max_abs_err": err})
                del x, q, s, out, want
        timing = None
        if cuda:  # the route at the largest bucket, fp32, beside its bound
            x, q, sc = combine_inputs(BIG_BUCKET, torch.float32, seed=23)
            n0 = mrd_combine.launches
            ms = time_ms(lambda: be.combine_quantized(x, q, sc, 256), iters=20)
            plain_ms = time_ms(lambda: mrd_combine_ref(x, q, sc), iters=10)
            lib_ms = time_ms(lambda: torch.addcmul(x.view(-1, 256), q.view(-1, 256),
                                                   sc.view(-1, 1)), iters=20)
            mrd_combine.launches = n0  # timing launches are not the path's
            n = BIG_BUCKET
            b_ms = (n * (4 + 1 + 4) + (n // 256) * 4) / HBM_BYTES_PER_S * 1e3
            o_ms = 2 * n / FP32_FLOPS * 1e3
            timing = {"n": n, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms
                      else "operations"}
            log(f"timings device_fused combine n={n} fp32 (a rank's largest bucket): kernel "
                f"{ms:.4f} ms ({max(b_ms, o_ms) / ms:.3f} of the bound) | plain "
                f"{plain_ms:.4f} ms | addcmul {lib_ms:.4f} ms | bound {max(b_ms, o_ms):.4f} ms")
            del x, q, sc
    finally:
        dist.destroy_process_group()
    return {"cases": rows, "timing": timing}


def _reducing(plan) -> int:
    return sum(st.kind in ("bshift", "butterfly", "rs") for st, *_ in plan.bound_stage_table())


def allreduce_run(tree, p: int, schedule: str, transform: str, device, busy, *,
                  cpu_elems: int = 0) -> dict:
    """One ``tree_allreduce`` of ``tree`` on the sim executor, timed and
    gated: every rank's result equal bit for bit, identity within 1e-5 of
    the float64 sum (N(0, 1) values: sums of p below ~4 p in magnitude,
    two roundings), int8 within its grid's bound (each reducing stage
    rounds both operands to a block's amax / 254, amax at most p times the
    largest input), ``mrd_combine`` launched once a reducing stage a bucket
    under int8 and never under identity; then the run again under the
    profiler (device busy time, ``mrd_combine``'s share), and with
    ``cpu_elems`` the buckets of at most that many elements a rank run on
    the CPU, equal to the card's bit for bit."""
    from repro_torch.collectives import buckets, plans
    from repro_torch.kernels.mrd_combine import mrd_combine

    plan = plans.allreduce_plan(schedule=schedule, transform=transform, p=p)
    layout = buckets.build_layout(tree, bucket_bytes=COLL_BUCKET_BYTES,
                                  quantum=plan.pad_quantum(), stacked=p)
    reducing, n_buckets = _reducing(plan), len(layout.buckets)
    expect = reducing * n_buckets if transform == "int8" else 0

    def once():
        return plans.tree_allreduce(tree, schedule=schedule, transform=transform, p=p,
                                    bucket_bytes=COLL_BUCKET_BYTES)

    _sync(device)
    n0 = mrd_combine.launches
    t1 = time.perf_counter()
    out = once()
    _sync(device)
    wall_ms = (time.perf_counter() - t1) * 1e3
    launched = mrd_combine.launches - n0
    ins, _ = buckets.tree_flatten(tree)
    outs, _ = buckets.tree_flatten(out)
    equal = all(torch.equal(o[r], o[0]) for o in outs for r in range(1, p))
    err = max((o[0].double() - x.sum(0, dtype=torch.float64)).abs().max().item()
              for o, x in zip(outs, ins))
    amax = max(x.abs().amax().item() for x in ins)
    bound = 1e-5 if transform == "identity" else 2 * reducing * p * amax / 254
    cpu_buckets = []
    if cpu_elems:
        picked = [i for i, b in enumerate(layout.buckets) if b.length <= cpu_elems]
        dense = [None] * len(ins)
        for i in picked:
            for s in layout.buckets[i].slots:
                dense[s.index] = ins[s.index].cpu()
        red = plan.run_buffers([buckets.pack_bucket(dense, layout, i) for i in picked])
        for i, r in zip(picked, red):
            for s in layout.buckets[i].slots:
                want = r[:, s.offset: s.offset + s.size].reshape((p,) + s.shape)
                if not torch.equal(outs[s.index].cpu(), want):
                    raise SystemExit(f"{schedule} {transform} p={p}: bucket {i} on the card "
                                     "differs from the CPU's")
            cpu_buckets.append(layout.buckets[i].length)
        del dense, red
    del out, outs, ins
    n1 = mrd_combine.launches
    busy_ms, per_rep = busy(once)
    if mrd_combine.launches - n1 != launched:
        raise SystemExit("the profiled run launched mrd_combine another number of times")
    mrd_ms = sum(ms for name, (ms, _) in per_rep.items() if "mrd_combine_kernel" in name)
    row = {"p": p, "schedule": schedule, "transform": transform, "buckets": n_buckets,
           "reducing_stages": reducing, "launches": launched, "wall_ms": wall_ms,
           "busy_ms": busy_ms, "mrd_combine_ms": mrd_ms,
           "mrd_combine_share": mrd_ms / busy_ms if busy_ms else 0.0,
           "max_abs_err": err, "err_bound": bound, "cpu_equal_buckets": cpu_buckets}
    log(f"  tree_allreduce {schedule} x {transform} p={p}: {n_buckets} buckets, wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, mrd_combine {launched} launches "
        f"(= {reducing} reducing stages x {n_buckets} buckets: {expect}) {mrd_ms:.2f} ms "
        f"({row['mrd_combine_share']:.3f} of busy); ranks equal {equal}; max abs err against "
        f"float64 {err:.3e} (bound {bound:.3e})"
        + (f"; buckets of {cpu_buckets} elements a rank equal to the CPU's bit for bit"
           if cpu_elems else ""))
    if not equal or not err <= bound or launched != expect:
        raise SystemExit(f"tree_allreduce {schedule} {transform} p={p} failed its gates: {row}")
    return row


def pipeline_run(plan, bufs: list, device, busy) -> dict:
    """9d. ``BucketPipeline`` of ``plan``: the buckets ``bufs`` admitted one
    by one with an ``advance()`` after every other admission, then
    drained, equal bit for bit to ``run_buffers`` on the same buckets; wall
    and device time of the pipelined run."""
    from repro_torch.kernels.mrd_combine import mrd_combine

    p = plan.p
    expect = _reducing(plan) * len(bufs)

    def piped():
        pipe = plan.pipeline()
        for k, b in enumerate(bufs):
            pipe.admit(k, b)
            if k % 2:
                pipe.advance()
        return pipe.drain()

    n0 = mrd_combine.launches
    want = plan.run_buffers(list(bufs))
    _sync(device)
    n1 = mrd_combine.launches
    t1 = time.perf_counter()
    done = piped()
    _sync(device)
    wall_ms = (time.perf_counter() - t1) * 1e3
    n2 = mrd_combine.launches
    equal = sorted(done) == list(range(len(bufs))) and all(
        torch.equal(done[k], w) for k, w in enumerate(want))
    del done, want
    busy_ms, per_rep = busy(piped)
    mrd_ms = sum(ms for name, (ms, _) in per_rep.items() if "mrd_combine_kernel" in name)
    launched = (n1 - n0, n2 - n1, mrd_combine.launches - n2)
    row = {"p": p, "buckets": len(bufs), "launches": launched, "wall_ms": wall_ms,
           "busy_ms": busy_ms, "mrd_combine_ms": mrd_ms,
           "mrd_combine_share": mrd_ms / busy_ms if busy_ms else 0.0}
    log(f"  BucketPipeline {plan.schedule} x {plan.transform} p={p}: {len(bufs)} buckets "
        f"admitted with an advance() after every other one, equal to run_buffers bit for bit: {equal}; wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, mrd_combine launches {launched} "
        f"(run_buffers, pipeline, profiled pipeline; {expect} each) {mrd_ms:.2f} ms "
        f"({row['mrd_combine_share']:.3f} of busy)")
    if not equal or launched != (expect,) * 3:
        raise SystemExit(f"BucketPipeline failed its gates: {row}")
    return row


def collectives_phases(all_ops, t: float, *, cfg, cut_cfg, device, busy) -> dict:
    """9a-9d. The collectives layer on ``device``: ``device_fused``'s
    routing, ``tree_allreduce`` of ``cfg``'s full-width gradient tree at p
    = 3 under mrd and rabenseifner x identity and int8, of ``cut_cfg``'s
    tree at p = 5, and ``BucketPipeline``.  Only ``mrd_combine`` may
    launch, exactly where each gate says."""
    from repro_torch.collectives import buckets, plans

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for op in all_ops:
        op.launches = 0
    stats: dict = {"route": fused_route(device)}
    t = phase("collectives-device-fused-route", t)
    tree = grad_tree(cfg, 3, seed=29, device=device)
    gib = sum(x.numel() for x in buckets.tree_flatten(tree)[0]) * 4 / 2**30
    log(f"9b: the {cfg.name} gradient tree, fp32, stacked over p = 3: {gib:.2f} GiB")
    # warm-up: the caching allocator grows its segments for trees of this size
    # (identity: no kernel launch)
    plans.tree_allreduce(tree, p=3, bucket_bytes=COLL_BUCKET_BYTES)
    stats["full_width_p3"] = [allreduce_run(tree, 3, sched, tf, device, busy,
                                            cpu_elems=COLL_CPU_ELEMS if tf == "int8" else 0)
                              for sched in ("mrd", "rabenseifner")
                              for tf in ("identity", "int8")]
    del tree
    t = phase("collectives-full-width-p3", t)
    tree = grad_tree(cut_cfg, 5, seed=31, device=device)
    stats["cut_p5"] = [allreduce_run(tree, 5, sched, tf, device, busy)
                       for sched in ("mrd", "rabenseifner") for tf in ("identity", "int8")]
    t = phase("collectives-cut-p5", t)
    plan = plans.allreduce_plan(schedule="rabenseifner", transform="int8", p=5)
    bufs = buckets.pack(tree, buckets.build_layout(tree, bucket_bytes=COLL_BUCKET_BYTES,
                                                   quantum=plan.pad_quantum(), stacked=5))
    del tree  # the buckets, their results and the pipeline's in-flight set fit beside
    stats["pipeline_p5"] = pipeline_run(plan, bufs, device, busy)
    del bufs
    t = phase("collectives-bucket-pipeline", t)
    if cuda:
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"collectives phases: peak device memory {stats['peak_gib']:.3f} GiB")
    counts = {op.__name__: op.launches for op in all_ops}
    # every tree_allreduce ran twice (timed, then profiled)
    expect = (sum(r["launches"] for r in stats["route"]["cases"])
              + 2 * sum(r["launches"] for r in stats["full_width_p3"] + stats["cut_p5"])
              + sum(stats["pipeline_p5"]["launches"]))
    stats["launches"] = counts["mrd_combine"]
    log(f"collectives phases: mrd_combine launches {counts['mrd_combine']} (= {expect} counted "
        f"by the gates above), every other kernel's {sum(counts.values()) - counts['mrd_combine']}")
    if counts["mrd_combine"] != expect or sum(counts.values()) != expect:
        raise SystemExit(f"the collectives phases launched kernels elsewhere: {counts}")
    return stats


# 10. the rest of serving at llama3.2-1b's full width
STATIC_BATCH, STATIC_PROMPT, STATIC_GEN = 8, 512, 64  # 10a: the static path
INT8_REL_BAR = 0.06  # the reference's int8 bar: max |l8 - l16| / max |l16| a step
TENANT_SPEC = "chat:3:sla=8:prio=2:prompt=512:gen=32,batch:1:quota=4:prompt=2048:gen=64"
TENANT_ARGV = ["--arch", "llama3.2-1b", "--continuous", "--workload", "llm_decode_paged",
               "--attn", "kernel", "--slots", "8", "--block-size", "16", "--requests", "32",
               "--prompt-len", "2048", "--gen", "64", "--scheduler", "sla_edf",
               "--arrival", "bursty:0.2,2.0", "--tenants", TENANT_SPEC, "--device", "cuda"]
TENANT_QUOTA = 4  # the batch tenant's
SYS_PREFIX, SYS_SUFFIX, SYS_REQUESTS = 1024, 64, 16  # 10c: a shared system prompt
SYS_MAX_LEN = 1136  # prefix + suffix + the largest budget (32) + 4, in whole 16-token blocks
# 10d: bench_serve's rows at full width, on a grid cut to fit the run: one
# burst and one Poisson row, the static baseline, the sysprefix pair, the
# two kill/join rows, and the fixed-point row at phase 8's d_iteration n
# and dp.  Fewer than 12
# requests shrink the continuous-vs-static margin (8 gave 0.86-0.89x
# against the 0.7x gate; 12 gave 1.14-1.17x).  The kill/join rows take 24
# requests, not the reference's 3 x 12: the LLM row runs its traffic
# five times, and 24 still leave 132 of 161 ticks after the last resize
# (36: 192 of 221).  Each timed row is the best of 2 runs, not the
# reference's 3 (the kill/join rows: 2 pairs in turns)
BENCH_GRID = {"slots": 4, "n_req": 12, "prompt_len": 64, "gen_max": 32,
              "schedulers": ("fcfs",), "arrivals": ("burst", "1.0"),
              "sysprefix": {"sys_len": 256, "user_len": 16, "gen_lo": 8, "gen_hi": 16,
                            "block_size": 16},
              "fixedpoint": {"n": FP_DITER_N, "dp": 5, "eps": 1e-10},
              "fp_slots": FP_SLOTS, "fp_requests": 32, "elastic_requests": 24, "repeats": 2}


def counts(all_ops) -> dict:
    return {op.__name__: op.launches for op in all_ops}


def zero(all_ops) -> None:
    for op in all_ops:
        op.launches = 0


def expect_launches(got: dict, want: dict, what: str, device) -> None:
    """Every kernel's launches in ``got`` equal ``want``'s (0 if absent; all
    0 on the CPU, where the wrappers take the plain versions)."""
    cuda = device.type == "cuda"
    bad = {k: (v, want.get(k, 0) * cuda) for k, v in got.items() if v != want.get(k, 0) * cuda}
    log(f"  launches ({what}): {got}")
    if bad:
        raise SystemExit(f"{what}: kernel launches (got, expected) {bad}")


def static_phase(all_ops, cfg, params, p10: dict, device) -> dict:
    """10a. The static path at batch 8, prompt 512, 64 greedy steps, with a
    bf16 and an int8 cache; the int8 cache's bytes; the int8 logits
    teacher-forced with the bf16 run's tokens against the bf16 cache's."""
    from repro_torch.distributed import step as step_lib
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.layers import dtype_of

    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    L, fwd = cfg.n_layers, 1 + STATIC_GEN
    stats: dict = {}
    runs = {}
    for name, c in (("bf16", cfg), ("int8", cfg8)):
        zero(all_ops)
        r = serve.static_serve(c, batch=STATIC_BATCH, prompt_len=STATIC_PROMPT, gen=STATIC_GEN,
                               device=device, params=params)
        got = counts(all_ops)
        expect_launches(got, {"flash_attention": L, "rmsnorm": (2 * L + 1) * fwd},
                        f"static {name}", device)
        for k, v in got.items():
            p10[k] += v
        pre_tok = STATIC_BATCH * STATIC_PROMPT
        st = {"cache_bytes": r["cache_bytes"], "prefill_ms": r["prefill_s"] * 1e3,
              "prefill_tok_s": pre_tok / r["prefill_s"],
              "decode_ms_per_step": r["decode_s"] / STATIC_GEN * 1e3,
              "decode_tok_s": STATIC_BATCH * STATIC_GEN / r["decode_s"]}
        if not ((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab)).all():
            raise SystemExit(f"static {name}: tokens out of the vocabulary")
        # one decode step's device time, from a cache the prefill filled
        cache = transformer.init_cache(c, STATIC_BATCH, STATIC_PROMPT + STATIC_GEN, device)
        logits, cache = step_lib.make_cached_prefill_step(c)(params, r["prompt"], cache)
        step = step_lib.make_serve_step(c)
        toks, pos = torch.argmax(logits, -1), torch.tensor(STATIC_PROMPT, device=device)
        step(params, toks, cache, pos)
        st["decode_busy_ms"], per = (device_profile(lambda: step(params, toks, cache, pos), 4)[:2]
                                     if device.type == "cuda" else (float("nan"), {}))
        log(f"10a static {name}: cache {r['cache_bytes']} B | prefill {pre_tok} tokens in "
            f"{st['prefill_ms']:.2f} ms ({st['prefill_tok_s']:.0f} tok/s) | decode "
            f"{st['decode_ms_per_step']:.3f} ms a step ({st['decode_tok_s']:.0f} tok/s), device "
            f"busy {st['decode_busy_ms']:.3f} ms a step")
        for kname, (ms, n) in top_kernels(per, 4):
            log(f"  {ms * 1e3:9.2f} us/step {n:5.1f} launches/step  {kname[:100]}")
        stats[name], runs[name] = st, r
        del cache, logits
    # int8 rows and an fp32 scale a head vector against rows of the compute
    # type (2 bytes in bf16): (hd + 4) / (2 hd)
    ratio = runs["int8"]["cache_bytes"] / runs["bf16"]["cache_bytes"]
    hd, esize = cfg.head_dim, torch.empty((), dtype=dtype_of(cfg.compute_dtype)).element_size()
    log(f"10a int8 / bf16 cache bytes {ratio:.6f} (= (hd + 4) / ({esize} hd) = "
        f"{(hd + 4) / (esize * hd)})")
    if runs["int8"]["cache_bytes"] * esize * hd != runs["bf16"]["cache_bytes"] * (hd + 4):
        raise SystemExit(f"int8 cache bytes {runs['int8']['cache_bytes']} are not "
                         f"(hd + 4) / ({esize} hd) of {runs['bf16']['cache_bytes']}")
    # teacher forcing: both caches fed the bf16 run's prompt and tokens
    prompt = runs["bf16"]["prompt"]
    forced = torch.from_numpy(runs["bf16"]["tokens"]).to(device)
    caches = [transformer.init_cache(c, STATIC_BATCH, STATIC_PROMPT + STATIC_GEN, device)
              for c in (cfg, cfg8)]
    l16, _ = step_lib.make_cached_prefill_step(cfg)(params, prompt, caches[0])
    l8, _ = step_lib.make_cached_prefill_step(cfg8)(params, prompt, caches[1])
    steps = (step_lib.make_serve_step(cfg), step_lib.make_serve_step(cfg8))
    positions = torch.arange(STATIC_PROMPT, STATIC_PROMPT + STATIC_GEN, device=device)
    rel = [float((l8 - l16).abs().max() / l16.abs().max())]
    for i in range(STATIC_GEN - 1):
        l16, _ = steps[0](params, forced[:, i], caches[0], positions[i])
        l8, _ = steps[1](params, forced[:, i], caches[1], positions[i])
        rel.append(float((l8 - l16).abs().max() / l16.abs().max()))
    agree = float((runs["int8"]["tokens"] == runs["bf16"]["tokens"]).mean())
    diverge = [int(np.argmax(row)) if row.any() else None
               for row in runs["int8"]["tokens"] != runs["bf16"]["tokens"]]
    log(f"10a int8 teacher-forced logits error, max |l8 - l16| / max |l16| over "
        f"{len(rel)} steps: max {max(rel):.4f}, mean {np.mean(rel):.4f} (bar {INT8_REL_BAR}); "
        f"free-running greedy agreement {agree:.3f}, first divergence a sequence {diverge}")
    if not max(rel) < INT8_REL_BAR:
        raise SystemExit(f"int8 teacher-forced logits error {max(rel)} >= {INT8_REL_BAR}")
    stats.update(int8_over_bf16_bytes=ratio, int8_rel_err_max=max(rel),
                 int8_rel_err_mean=float(np.mean(rel)), greedy_agreement=agree,
                 first_divergence=diverge)
    del caches
    return stats


def tenant_phase(all_ops, cfg, p10: dict, argv=TENANT_ARGV) -> dict:
    """10b. Tenant traffic through the CLI on the paged kernel path at
    steps_per_dispatch 16 and 1: every request done, the batch tenant's
    quota held, equal results in both runs, launches as counted."""
    from repro_torch.kernels.paged_attention.ops import split_plan
    from repro_torch.launch import serve

    # warm-up on the whole stream: the split kernels' first calls and the
    # batch tenant's 2,048-token prefills, so neither timed run pays for them
    serve.main(argv)
    L, runs, stats = cfg.n_layers, {}, {}
    for spd in (16, 1):
        zero(all_ops)
        eng = serve.main(argv + ["--steps-per-dispatch", str(spd)])
        got, s, wl = counts(all_ops), eng.summary(), eng.workload
        _, splits = split_plan(wl.pool.blocks_per_slot, wl.pool.block_size)
        expect_launches(got, {"paged_attention": L * s["decode_ticks"],
                              "flash_attention": L * wl.prefills,
                              "rmsnorm": (2 * L + 1) * (wl.prefills + s["decode_ticks"])},
                        f"tenants, steps_per_dispatch {spd}", wl.device)
        for k, v in got.items():
            p10[k] += v
        res = eng.results
        batch = [r for r in res.values() if r.tenant == "batch"]
        peak = max(sum(r.admit_tick <= t <= r.retire_tick for r in batch)
                   for t in range(s["ticks"]))
        log(f"10b steps_per_dispatch {spd}: {s['completed']}/32 done in {s['ticks']} ticks "
            f"({s['decode_ticks']} decode), wall {s['wall_s']:.3f} s, {s['throughput_tok_s']:.1f} "
            f"tok/s, TTFT p50 {s['ttft_p50_ms']:.1f} ms, TPOT p50 {s['tpot_p50_ms']:.2f} ms; "
            f"batch tenant's most slots in flight {peak} (quota {TENANT_QUOTA}); "
            f"paged_attention kernels a call {1 + (splits > 1)} ({splits} splits)")
        if s["completed"] != 32 or s["forced_at_capacity"] or peak > TENANT_QUOTA:
            raise SystemExit(f"tenant run at steps_per_dispatch {spd}: {s}, batch peak {peak}")
        runs[spd] = res
        stats[f"spd{spd}"] = {k: s[k] for k in (
            "ticks", "decode_ticks", "wall_s", "throughput_tok_s", "ttft_p50_ms", "tpot_p50_ms",
            "sla_total", "sla_met", "goodput_ok", "goodput_per_ktick", "replica_ticks")}
        stats[f"spd{spd}"].update(batch_peak_slots=peak, splits=splits,
                                  tenants={n: {k: t[k] for k in ("completed", "sla_met",
                                                                 "sla_total", "ttft_p99_ticks")}
                                           for n, t in s["tenants"].items()})
        del eng, wl
    for i, r in runs[16].items():
        o = runs[1][i]
        if not (np.array_equal(r.output, o.output)
                and (r.admit_tick, r.retire_tick) == (o.admit_tick, o.retire_tick)):
            raise SystemExit(f"request {i} differs between steps_per_dispatch 16 and 1")
    log("10b steps_per_dispatch 16 and 1: equal tokens, admission and retirement ticks")
    return stats


def prefix_phase(all_ops, cfg, params, p10: dict, device) -> dict:
    """10c. 16 requests sharing a 1024-token system prompt on the paged
    kernel path with share_prefixes on and off (equal tokens), then on
    int8 pages through the gather path (no paged_attention launch)."""
    from repro_torch.serving import Request, ServeConfig, ServeEngine, make_workload

    rng = np.random.default_rng(23)
    sys_prompt = rng.integers(0, cfg.vocab, size=SYS_PREFIX)
    reqs = [(np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, size=SYS_SUFFIX)]),
             int(rng.integers(16, 33))) for _ in range(SYS_REQUESTS)]
    L, stats, outs = cfg.n_layers, {}, {}
    for name, c, kw in (("shared", cfg, {"share_prefixes": True}),
                        ("private", cfg, {"share_prefixes": False}),
                        ("int8_gather", dataclasses.replace(cfg, kv_cache_dtype="int8"),
                         {"attn": "gather"})):
        wl = make_workload("llm_decode_paged", cfg=c, slots=8, max_len=SYS_MAX_LEN,
                           max_prompt_len=SYS_PREFIX + SYS_SUFFIX, block_size=16,
                           params=params, device=device, **kw)
        eng = ServeEngine(wl, ServeConfig(dp=3))
        for i, (p, b) in enumerate(reqs):
            eng.submit(Request(id=i, prompt=p, max_new=b))
        zero(all_ops)
        peak = 0
        while eng.queue or eng.pending or any(r is not None for r in eng.slot_req):
            eng.step()
            peak = max(peak, wl.pool.allocator.used_blocks)
        got, s = counts(all_ops), eng.summary()
        paged_calls = 0 if name == "int8_gather" else L * s["decode_ticks"]
        expect_launches(got, {"paged_attention": paged_calls, "flash_attention": L * wl.prefills,
                              "rmsnorm": (2 * L + 1) * (wl.prefills + s["decode_ticks"])},
                        f"system prompt, {name}", device)
        for k, v in got.items():
            p10[k] += v
        stats[name] = {"prefix_saved_blocks": wl.prefix_saved_blocks, "peak_blocks": peak,
                       "num_blocks": wl.pool.num_blocks, "cache_bytes": wl.cache_bytes,
                       "tok_s": s["throughput_tok_s"], "ticks": s["ticks"],
                       "wall_s": s["wall_s"], "completed": s["completed"]}
        log(f"10c {name}: {s['completed']}/{SYS_REQUESTS} done in {s['ticks']} ticks, "
            f"{s['throughput_tok_s']:.1f} tok/s | prefix blocks saved "
            f"{wl.prefix_saved_blocks} | peak blocks in use {peak} of {wl.pool.num_blocks - 1} "
            f"| cache {wl.cache_bytes} B")
        if s["completed"] != SYS_REQUESTS or s["forced_at_capacity"]:
            raise SystemExit(f"system-prompt run {name}: {s}")
        outs[name] = eng.results
        del eng, wl
    for i, r in outs["shared"].items():
        if not np.array_equal(r.output, outs["private"][i].output):
            raise SystemExit(f"request {i}: share_prefixes on and off give different tokens")
    agree = float(np.mean([np.mean(r.output == outs["shared"][i].output)
                           for i, r in outs["int8_gather"].items()]))
    stats["int8_token_agreement"] = agree
    log(f"10c share_prefixes on and off: equal tokens; int8 pages agree with the bf16 run on "
        f"{agree:.3f} of their tokens (not gated)")
    return stats


def serving_rest_phases(all_ops, t: float, *, cfg, device, tenant_argv=TENANT_ARGV,
                        grid=BENCH_GRID) -> dict:
    """10. The rest of serving at ``cfg`` (llama3.2-1b's full width on the
    card): 10a the static path with bf16 and int8 caches, 10b tenant
    traffic, 10c prefix sharing and int8 pages, 10d bench_serve's rows.
    Returns the stats and ``launches``, each kernel's launches on 10a-10c's
    counted runs."""
    from repro_torch.benchmarks import bench_serve
    from repro_torch.models import transformer

    params = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    p10 = {op.__name__: 0 for op in all_ops}
    stats = {"static": static_phase(all_ops, cfg, params, p10, device)}
    t = phase("serving-static", t)
    stats["tenants"] = tenant_phase(all_ops, cfg, p10, tenant_argv)
    t = phase("serving-tenants", t)
    stats["prefix"] = prefix_phase(all_ops, cfg, params, p10, device)
    t = phase("serving-prefix", t)
    rows = bench_serve.run_grid(cfg, grid, device, params=params)
    out = ROOT / "chiprun_out" / "bench_serve_full_width.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"meta": {"arch": cfg.name, "device": str(device),
                                        **{k: v for k, v in grid.items()}},
                               "sweep": rows}, indent=2, default=list))
    for r in rows:
        log(f"10d {json.dumps(r)}")
    bench_serve.check_rows(rows)  # the reference's gates; a failure ends the run
    stats["bench_serve"] = rows
    t = phase("serving-bench-serve", t)
    stats["launches"] = p10
    log(f"serving phases 10a-10c: launches {p10}")
    return stats


KERNEL_SOURCES = ("paged_attention", "mrd_combine", "flash_attention", "rmsnorm",
                  "selective_scan")


def start_build():
    """2. Start building every kernel: one ``nvcc`` per source, all started
    together, each in a thread of its own -> (pool, {source name: future of
    (the ``.so`` path, seconds)}).  :func:`finish_build` waits for them."""
    from repro_torch.kernels import build

    def timed(src, name):
        t = time.perf_counter()
        return build.build_shared_library(src, name), time.perf_counter() - t

    pool = ThreadPoolExecutor(len(KERNEL_SOURCES))
    return pool, {name: pool.submit(
        timed, importlib.import_module(f"repro_torch.kernels.{name}.ops").SOURCE, name)
        for name in KERNEL_SOURCES}


def finish_build(pool, futs: dict, t: float) -> dict:
    """2. Wait for :func:`start_build`'s compilers, load every library,
    print the ptxas figures of the instances the paths serve, and gate the
    spills.  Returns {source name: ptxas_report}."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mrd_combine import ops as mc_ops
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.selective_scan import ops as ss_ops

    # the instances whose -Xptxas=-v figures are printed (any of the mark
    # tuples, every mark of it in the mangled name): flash_attention's bf16
    # hd 256 (gemma3's), hd 128 at rep 5 (qwen2.5-32b's, llama4-scout's) and
    # 4 (mixtral's), hd 64 at rep 7 (internvl2-1b's) and hd 80 at rep 1
    # (zamba2-2.7b's); selective_scan's
    # fused chunked and step instances at N = 16 (falcon-mamba's);
    # paged_attention's bf16 16-token-block instances at hd 64 rep 4
    # (llama3.2-1b's), hd 128 rep 5 and 4, hd 64 rep 7 and 1 (minicpm-2b's),
    # hd 128 rep 7, hd 80 rep 1 (zamba2-2.7b's), and its combine kernel; the
    # hd 80, 12 and 8 fp32 instances of both attention kernels (zamba2's and
    # the smoke configs' on the card); every other kernel's all
    shown = {"flash_attention": [(f"flash_wgmma_kernelILi{m}E",) for m in (
                 "256", "128ELi5", "128ELi4", "64ELi7", "80ELi1")]
             + [(f"flash_f32_kernelILi{m}E",) for m in ("80ELi1", "12ELi1", "8ELi7")],
             "selective_scan": [("selective_scan_kernelILb1E", "Li16E"),
                                ("selective_scan_step_kernel", "Li16E")],
             "paged_attention": [(f"paged_attention_kernelI13__nv_bfloat16Li{hd}ELi{r}ELi16E",)
                                 for hd, r in ((64, 4), (128, 5), (128, 4), (64, 7), (64, 1),
                                               (128, 7), (80, 1))]
             + [(f"paged_attention_kernelIfLi{hd}ELi{r}ELi16E",)
                for hd, r in ((80, 1), (8, 7), (12, 1))]
             + [("paged_attention_combine_kernel",)]}
    with pool:
        built = {name: f.result() for name, f in futs.items()}
    log("nvcc a source: " + ", ".join(f"{name} {s:.1f} s" for name, (_, s) in built.items()))
    built = {name: so for name, (so, _) in built.items()}
    for lib_ops in (ops, mc_ops, fa_ops, rn_ops, ss_ops):
        lib_ops.library()
    ptxas = {}
    for name, so in built.items():
        log(f"built {so.relative_to(ROOT)}")
        ptxas[name] = ptxas_report(so.with_suffix(".log").read_text())
        for entry, r in ptxas[name].items():
            if name not in shown or any(all(m in entry for m in marks)
                                        for marks in shown[name]):
                kernel = re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "", entry)  # past the namespace
                log(f"  ptxas ({name}) {kernel[:72]}: {r['regs']} registers, spill stores "
                    f"{r['spill_stores']} B, loads {r['spill_loads']} B")
    # no paged-attention instance and no bf16 flash instance may spill (the
    # flash consumer warpgroups run at 240 registers a thread after setmaxnreg)
    spills = {e: r for name, marks in (("paged_attention", "paged_attention"),
                                       ("flash_attention", "flash_wgmma_kernel"))
              for e, r in ptxas[name].items()
              if marks in e and (r["spill_stores"] or r["spill_loads"])}
    n_paged = sum("paged_attention_kernel" in e for e in ptxas["paged_attention"])
    n_wgmma = sum("flash_wgmma_kernel" in e for e in ptxas["flash_attention"])
    log(f"ptxas: {n_paged} paged_attention and {n_wgmma} bf16 flash instances, spilling: "
        f"{len(spills)}")
    if spills or not n_paged or not n_wgmma:
        raise SystemExit(f"kernel instances spill: {spills}")
    log(f"build of {len(built)} kernels: {time.perf_counter() - t:.1f} s after phases 7-8")
    return ptxas


def check_paged(cases, errs: dict) -> None:
    """``paged_attention`` against its plain version at each (S, H, KV, hd,
    nb, bs), fp32 (atol 1e-4) and bf16 (atol 2e-2 against the plain version
    in fp32); the errors go into ``errs``."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    for case in cases:
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = paged_inputs(0, *case, dtype)
            out = ops.paged_attention(*args)
            ref = paged_attention_ref(*[a.float() if a.is_floating_point() else a for a in args])
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != ref.shape:
                raise SystemExit(f"kernel output {out.dtype} {tuple(out.shape)} is wrong")
            err = (out.float() - ref).abs().max().item()
            errs[(case, dtype)] = err
            log(f"  kernel vs plain S,H,KV,hd,nb,bs={case} {str(dtype)[6:]}: "
                f"max abs err {err:.3e} (atol {atol:g})")
            if not err <= atol:
                raise SystemExit(f"paged_attention kernel disagrees with its plain version: {err}")


def check_flash(cases, errs: dict) -> None:
    """``flash_attention`` against its plain version at each (B, Sq, Skv, H,
    KV, hd, causal, window, q_offset): fp32 atol 1e-4 and bf16 2e-2, every
    (token, head) row within FLASH_ROW_RTOL of the plain row, and queries
    that see no key written as 0."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref, visible_mask

    for case in cases:
        B, Sq, Skv, H, KV, hd, causal, window, q_offset = case
        masks = dict(causal=causal, window=window, q_offset=q_offset)
        # a query that sees no key writes 0 (the plain softmax would average v)
        seen = visible_mask(Sq, Skv, causal, window, q_offset, device="cuda").any(-1)
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = flash_inputs(B, Sq, Skv, H, KV, hd, dtype, seed=Sq + hd)
            out = fa_ops.flash_attention(q, k, v, **masks)
            ref = flash_attention_ref(q.float(), k.float(), v.float(), **masks)
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != ref.shape:
                raise SystemExit(f"flash_attention output {out.dtype} {tuple(out.shape)} is wrong")
            unseen_zero = bool((out[:, ~seen] == 0).all())
            delta = out[:, seen].float() - ref[:, seen]
            err = delta.abs().max().item() if seen.any() else 0.0
            row_err = ((delta.norm(dim=-1) / ref[:, seen].norm(dim=-1)).max().item()
                       if seen.any() else 0.0)
            rtol = FLASH_ROW_RTOL[str(dtype)[6:]]
            errs[(case, dtype)] = err
            log(f"  flash_attention vs plain B,Sq,Skv,H,KV,hd,causal,window,q_offset={case} "
                f"{str(dtype)[6:]}: max abs err {err:.3e} (atol {atol:g}), largest row error "
                f"relative to the row {row_err:.3e} (at most {rtol:g}); "
                f"{int((~seen).sum())} queries see no key, all 0: {unseen_zero}")
            if not (err <= atol and row_err <= rtol and unseen_zero):
                raise SystemExit(f"flash_attention kernel disagrees with its plain version: "
                                 f"{err}, rows {row_err}, unseen rows 0: {unseen_zero}")
            del q, k, v, out, ref, delta


def check_rmsnorm(cases, errs: dict) -> None:
    """``rmsnorm`` against its plain version on [T, d] rows, fp32 (1e-5) and
    bf16 (2e-2)."""
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    for T, d in cases:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            gen = torch.Generator(device="cuda").manual_seed(T)
            x = (torch.randn(T, d, generator=gen, device="cuda") * 3).to(dtype)
            w = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dtype)
            out = rn_ops.rmsnorm(x, w, 1e-6)
            ref = rmsnorm_ref(x.float(), w.float(), 1e-6)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            errs[((T, d), dtype)] = err
            ok = out.dtype == dtype and torch.allclose(out.float(), ref, atol=tol, rtol=tol)
            log(f"  rmsnorm vs plain [{T}, {d}] {str(dtype)[6:]}: max abs err {err:.3e} "
                f"(atol = rtol = {tol:g}): {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"rmsnorm kernel disagrees with its plain version: {err}")
            del x, w, out, ref


def flash_widened_timings() -> dict:
    """6. The widened flash instances timed (see FLASH_NEW_TIMED)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    # the widened instances at [1, 4096], causal, bf16: qwen2.5-32b's and
    # llama4-scout's heads (40/8, hd 128: rep 5) and internvl2-1b's (14/2, hd
    # 64: rep 7); the plain version is flash_attention_ref (fp32 scores,
    # materialized: [1, KV, rep, 4096, 4096])
    fa_new = {}
    for H, KV, hd in FLASH_NEW_TIMED:
        S = 4096
        q, k, v = flash_inputs(1, S, S, H, KV, hd, torch.bfloat16, seed=21)
        ms_k = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True), iters=20, warmup=2)
        ms_p = time_ms(lambda: flash_attention_ref(q, k, v, causal=True), iters=3, warmup=1)
        ms_l, how = sdpa_ms(q, k, v, None, iters=20)
        pairs = fa_ops.visible_pairs(S, S, True)
        n_ops = 4 * H * hd * pairs
        n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v in; out
        b_ms, o_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOPS * 1e3
        fa_new[(H, KV, hd)] = dict(shape=[1, S, H, KV, hd], ms=ms_k, plain_ms=ms_p,
                                   library_ms=ms_l, bound_ms=max(b_ms, o_ms),
                                   bound_by="bytes" if b_ms >= o_ms else "operations")
        log(f"timings flash_attention S={S} H={H} KV={KV} (rep {H // KV}) hd={hd} causal bf16: "
            f"kernel {ms_k:.4f} ms | plain {ms_p:.4f} ms | sdpa ({how}) {ms_l:.4f} ms | bound "
            f"{max(b_ms, o_ms):.4f} ms ({pairs} visible pairs, {n_ops:.4e} flop at 989 TFLOP/s = "
            f"{o_ms:.4f} ms; {n_bytes} bytes at 3.35 TB/s = {b_ms:.4f} ms) | "
            f"{n_ops / (ms_k * 1e-3) / 1e12:.1f} TFLOP/s | kernel / sdpa {ms_k / ms_l:.3f}")
        del q, k, v
        torch.cuda.empty_cache()
    return fa_new


def zamba_flash_timing() -> dict:
    """6. flash_attention at zamba2-2.7b's shared block over a 32k prompt
    ([1, 32768], 32/32 heads, hd 80, causal, bf16) beside
    scaled_dot_product_attention in the same run; the plain version is
    flash_scan (the materialized scores do not fit)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.attention import attention

    S, H, KV, hd = PREFILL_LEN, 32, 32, 80
    q, k, v = flash_inputs(1, S, S, H, KV, hd, torch.bfloat16, seed=23)
    ms_k = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True), iters=5, warmup=2)
    ms_p = time_ms(lambda: attention(q, k, v, causal=True, impl="flash_scan", chunk=1024),
                   iters=2, warmup=1)
    ms_l, how = sdpa_ms(q, k, v, None, iters=5)
    pairs = fa_ops.visible_pairs(S, S, True)
    n_ops = 4 * H * hd * pairs
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v in; out
    b_ms, o_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOPS * 1e3
    log(f"timings flash_attention S={S} H={H} KV={KV} hd={hd} (zamba2-2.7b's shared block) "
        f"causal bf16: kernel {ms_k:.4f} ms | plain (flash_scan) {ms_p:.4f} ms | sdpa ({how}) "
        f"{ms_l:.4f} ms | bound {max(b_ms, o_ms):.4f} ms ({pairs} visible pairs, {n_ops:.4e} "
        f"flop at 989 TFLOP/s = {o_ms:.4f} ms; {n_bytes} bytes at 3.35 TB/s = {b_ms:.4f} ms) | "
        f"{n_ops / (ms_k * 1e-3) / 1e12:.1f} TFLOP/s | kernel / sdpa {ms_k / ms_l:.3f}")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(shape=[1, S, H, KV, hd], ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations")


# 11. the remaining decoder families, through the CLI's serve(): prompts
# 128-1024 and budgets 16-32 on 66 pages of 16 a slot (the longest prompt
# plus the largest budget), 8 slots, dp 5 (the paper's non-power-of-two
# case); mixtral's prompts of 4096-6144 tokens cross its 4096-token window
# on the contiguous pool
PAGED_FAMILY_ARGV = ["--continuous", "--workload", "llm_decode_paged", "--attn", "kernel",
                     "--dp", "5", "--slots", "8", "--requests", "16", "--min-prompt-len", "128",
                     "--prompt-len", "1024", "--gen", "32", "--max-len", "1056",
                     "--block-size", "16", "--device", "cuda"]
QWEN_ARGV = ["--arch", "qwen2.5-32b"] + PAGED_FAMILY_ARGV
INTERNVL_ARGV = ["--arch", "internvl2-1b"] + PAGED_FAMILY_ARGV
MINICPM_ARGV = ["--arch", "minicpm-2b"] + PAGED_FAMILY_ARGV + [
    "--requests", "8", "--prompt-len", "512", "--max-len", "544"]
LLAMA4_ARGV = ["--arch", "llama4-scout-17b-a16e"] + PAGED_FAMILY_ARGV + ["--requests", "8"]
MIXTRAL_PROMPTS = (4096, 6144)
MIXTRAL_ARGV = ["--arch", "mixtral-8x7b", "--continuous", "--workload", "llm_decode", "--dp", "3",
                "--slots", "4", "--requests", "8", "--min-prompt-len", str(MIXTRAL_PROMPTS[0]),
                "--prompt-len", str(MIXTRAL_PROMPTS[1]), "--gen", "32", "--device", "cuda"]
# depth cuts (one card): mixtral-8x7b's 32 layers to 16 (46.96 GB), llama4-scout's
# 48 to 8 (37.4 GB); qwen2.5-32b's kernel-vs-plain check at 4 of its 64
DEPTH_CUTS = {"mixtral-8x7b": 16, "llama4-scout-17b-a16e": 8}
CHECK_LAYERS, CHECK_PROMPTS, CHECK_STEPS = 4, (1000, 333), 16
VLM_PATCHES, VLM_TOKENS = 256, 512
# kernel path against plain path in bf16: each row's max |l_kernel - l_plain|
# relative to its largest plain logit under the bar, the larger of
# LOGIT_REL_FLOOR and twice the largest such spread between the two plain
# versions (attention materialized, "full", and chunked, "flash_scan": each
# rounds to bf16 at other places, as the kernel does); and the kernel's top-1
# token the plain path's top-1 or within the bar of it (a tie the bar cannot
# tell apart).  The strict top-1 agreement is reported.
LOGIT_REL_FLOOR = 0.01
PHASE11_HEADROOM_GIB = 4.0  # allocated before phase 11 at most (qwen2.5-32b peaks at ~64 GiB)


def live_cuda_tensors(top: int = 5) -> list:
    """(shape, dtype, GB) of the largest CUDA storages Python still holds."""
    seen = {}
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                st = obj.untyped_storage()
                seen[st.data_ptr()] = (tuple(obj.shape), str(obj.dtype)[6:],
                                       round(st.nbytes() / 1e9, 3))
        except Exception:  # objects that fail isinstance/attribute probes are not ours
            continue
    return sorted(seen.values(), key=lambda v: -v[2])[:top]


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_path():
    """The serving path with every kernel's plain version: the paged decode
    reads K/V through ``paged_attention_ref`` and norms take ``rmsnorm_ref``
    (the flash kernel is left by ``attn_impl="full"`` in the config)."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import layers, transformer

    with mock.patch.object(transformer, "paged_attention", paged_attention_ref), \
            mock.patch.object(layers, "rmsnorm_kernel", rmsnorm_ref):
        yield


def gate_rows(what: str, kernel, plain, other) -> dict:
    """Logit rows [R, V] of the kernel path against the plain path's
    (``other``: the second plain version, which sets the bar): the largest
    |difference| relative to each row's largest plain logit, and top-1
    agreement, strict and up to ties within the bar; a failure ends the
    run."""
    kernel, plain, other = kernel.float(), plain.float(), other.float()
    scale = plain.abs().amax(-1)
    rel = (kernel - plain).abs().amax(-1) / scale
    spread = float(((other - plain).abs().amax(-1) / scale).max())
    bar = max(LOGIT_REL_FLOOR, 2 * spread)
    top_k, top_p = kernel.argmax(-1), plain.argmax(-1)
    gap = (plain.gather(-1, top_p[:, None]) - plain.gather(-1, top_k[:, None]))[:, 0] / scale
    r = {"rows": int(rel.numel()), "max_rel_err": float(rel.max()), "plain_spread": spread,
         "bar": bar, "top1": float((top_k == top_p).float().mean()),
         "top1_up_to_ties": float((gap <= bar).float().mean()),
         "max_abs_logit": float(scale.max())}
    log(f"{what}: {r['rows']} rows, max |kernel - plain| / max |plain| {r['max_rel_err']:.4f} "
        f"(bar {bar:.4f}: the two plain versions differ by {spread:.4f}), top-1 agreement "
        f"{r['top1']:.3f}, up to ties within the bar {r['top1_up_to_ties']:.3f}; largest "
        f"|logit| {r['max_abs_logit']:.3f}")
    if not (r["max_rel_err"] < bar and r["top1_up_to_ties"] == 1.0):
        raise SystemExit(f"{what}: the kernel path disagrees with the plain path: {r}")
    return r


def family_serve(all_ops, argv, what: str):
    """Serve ``argv`` through the CLI (an arch in DEPTH_CUTS at its cut
    depth) counted from 0: every request retired naturally, outputs in the
    vocabulary, each kernel's launches as the path makes them.  Returns
    (engine, stats, launches)."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve

    arch = argv[argv.index("--arch") + 1]
    cut = ({arch: registry.override(registry.get_config(arch), n_layers=DEPTH_CUTS[arch])}
           if arch in DEPTH_CUTS else {})
    n_req = int(argv[len(argv) - 1 - argv[::-1].index("--requests") + 1])
    zero(all_ops)
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.dict(registry._FULL, cut):
        eng = serve.main(argv)
    got, s, wl = counts(all_ops), eng.summary(), eng.workload
    L, fwd = wl.cfg.n_layers, wl.prefills + s["decode_ticks"]
    attn, norms = per_forward(wl.cfg)
    want = {"flash_attention": attn * wl.prefills, "rmsnorm": norms * fwd}
    if "llm_decode_paged" in argv:
        want["paged_attention"] = attn * s["decode_ticks"]
    expect_launches(got, want, what, wl.device)
    params_gb = sum(t.numel() * t.element_size() for t in _leaves(wl.params)) / 1e9
    stats = {k: s[k] for k in ("completed", "decode_ticks", "tokens_out", "throughput_tok_s",
                               "ttft_p50_ms", "tpot_p50_ms", "wall_s")}
    stats.update(layers=L, params=wl.cfg.n_params(), weights_gb=params_gb,
                 admissions=wl.prefills, cache_gb=wl.cache_bytes / 1e9,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=got)
    log(f"{what}: {s['completed']}/{n_req} requests, {wl.prefills} admissions, "
        f"{s['decode_ticks']} decode ticks, {L} layers, {params_gb:.2f} GB of weights, cache "
        f"{wl.cache_bytes / 1e9:.3f} GB | {s['throughput_tok_s']:.1f} tok/s | TTFT p50 "
        f"{s['ttft_p50_ms']:.1f} ms | TPOT p50 {s['tpot_p50_ms']:.2f} ms | wall "
        f"{s['wall_s']:.2f} s | peak {stats['peak_gib']:.2f} GiB")
    if s["completed"] != n_req or s["forced_at_capacity"]:
        raise SystemExit(f"{what}: not every request retired naturally: {s}")
    for r in eng.results.values():
        if not (1 <= r.n_tokens and ((r.output >= 0) & (r.output < wl.cfg.vocab)).all()):
            raise SystemExit(f"{what}: request {r.id}: bad output {r.output}")
    return eng, stats, got


def per_forward(cfg) -> tuple:
    """(attention layers, rmsnorm launches) of one forward: the hybrid stack
    attends once a group (its shared block) and norms twice a mamba2 layer
    (ln and the gated norm over d_inner) and twice a group; the others
    attend every layer and norm twice a layer; and the final norm."""
    if cfg.family == "hybrid":
        return cfg.n_groups, 2 * cfg.n_layers + 2 * cfg.n_groups + 1
    return cfg.n_layers, 2 * cfg.n_layers + 1


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def pages_from_prefill(caches, nb: int, bs: int, names=("k", "v")):
    """One-sequence prefill caches (``names`` [L, 1, plen, KV, hd]) laid
    into a pool of ``nb`` blocks of ``bs`` a sequence: (pages, tables
    [S, nb] int32, lengths [S] int32); block 0 is the trash block."""
    S, device = len(caches), caches[0][names[0]].device
    tables = torch.arange(1, S * nb + 1, dtype=torch.int32, device=device).reshape(S, nb)
    pages = {}
    for n in names:
        L, _, _, KV, hd = caches[0][n].shape
        pool = caches[0][n].new_zeros((L, S * nb + 1, bs, KV, hd))
        for b, c in enumerate(caches):
            rows = c[n][:, 0]
            full = rows.new_zeros((L, nb * bs, KV, hd))
            full[:, :rows.shape[1]] = rows
            pool[:, tables[b].long()] = full.reshape(L, nb, bs, KV, hd)
        pages[n] = pool
    lengths = torch.tensor([c[names[0]].shape[2] for c in caches], dtype=torch.int32,
                           device=device)
    return pages, tables, lengths


def qwen_kernel_check(all_ops, cfg) -> dict:
    """11a': qwen2.5-32b at full width cut to CHECK_LAYERS layers (random
    weights and qkv biases from seed 0): the prefill logits of two prompts,
    then CHECK_STEPS paged decode steps fed the kernel path's greedy
    tokens, through the kernels and through the two plain paths."""
    from repro_torch.models import transformer

    bs, device = 16, torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    params = transformer.init_params(cfg, gen, device)
    for n in ("bq", "bk", "bv"):
        params["layers"][n].normal_(0.0, 0.5, generator=gen)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen, device=device)
               for n in CHECK_PROMPTS]
    nb = -(-(max(CHECK_PROMPTS) + CHECK_STEPS) // bs)

    paths = {"kernel": cfg, "full": dataclasses.replace(cfg, attn_impl="full"),
             "flash_scan": dataclasses.replace(cfg, attn_impl="flash_scan")}
    zero(all_ops)
    rows, state = {}, {}
    with torch.no_grad():
        for name, c in paths.items():
            with plain_path() if name != "kernel" else contextlib.nullcontext():
                out = [transformer.forward_prefill(params, p[None], c) for p in prompts]
            rows[name] = [torch.cat([o[0] for o in out])]
            state[name] = pages_from_prefill([o[1] for o in out], nb, bs)
            del out
        tok = rows["kernel"][0].argmax(-1)
        for i in range(CHECK_STEPS):  # every path fed the kernel path's greedy tokens
            for name, c in paths.items():
                pages, tables, lengths = state[name]
                with plain_path() if name != "kernel" else contextlib.nullcontext():
                    logits, _, _ = transformer.forward_decode_paged(
                        params, tok, pages, tables, lengths + i, c, block_size=bs)
                rows[name].append(logits)
            tok = rows["kernel"][-1].argmax(-1)
    L = cfg.n_layers
    # the kernel path's launches only: the plain paths launched none
    expect_launches(counts(all_ops), {"flash_attention": L * len(prompts),
                                      "rmsnorm": (2 * L + 1) * (len(prompts) + CHECK_STEPS),
                                      "paged_attention": L * CHECK_STEPS},
                    "11a qwen kernel check", device)
    return gate_rows(f"11a qwen2.5-32b ({L} layers) prefill of {CHECK_PROMPTS} tokens + "
                     f"{CHECK_STEPS} teacher-forced paged decode steps, kernel vs plain",
                     *(torch.cat(rows[n]) for n in paths))


def vlm_kernel_check(all_ops, cfg, params) -> dict:
    """11b': internvl2-1b's full-sequence forward (make_prefill_step) of
    VLM_PATCHES stub patches + VLM_TOKENS tokens, two sequences, through the
    kernels and through the plain path."""
    from repro_torch.distributed import serve as dserve
    from repro_torch.models import frontends

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(3)
    batch = {"patches": frontends.vision_patches(gen, 2, VLM_PATCHES),
             "tokens": torch.randint(0, cfg.vocab, (2, VLM_TOKENS), generator=gen,
                                     device=device)}
    zero(all_ops)
    out = {}
    with torch.no_grad():
        out["kernel"] = dserve.make_prefill_step(cfg, device)(params, batch)
        with plain_path():
            for impl in ("full", "flash_scan"):
                out[impl] = dserve.make_prefill_step(dataclasses.replace(cfg, attn_impl=impl),
                                                     device)(params, batch)
    # the kernel path's launches only: the plain paths launched none
    expect_launches(counts(all_ops), {"flash_attention": cfg.n_layers,
                                      "rmsnorm": 2 * cfg.n_layers + 1},
                    "11b internvl2 patch forward", device)
    return gate_rows(f"11b internvl2-1b forward of {VLM_PATCHES} patches + {VLM_TOKENS} tokens "
                     "(x2), kernel vs plain", out["kernel"], out["full"], out["flash_scan"])


def families_phases(all_ops, t: float) -> dict:
    """11. qwen2.5-32b, internvl2-1b and minicpm-2b at full width, mixtral-8x7b
    and llama4-scout at cut depth, each model freed before the next loads."""
    from repro_torch.configs import registry
    from repro_torch.distributed import serve as dserve
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    device = torch.device("cuda")
    stats: dict = {}
    launches = {op.__name__: 0 for op in all_ops}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    # qwen2.5-32b peaks at ~64 GiB of the card's 79: earlier phases may leave
    # a few GiB behind, and the largest tensors still alive are named
    left = torch.cuda.memory_allocated() / 2**30
    log(f"device memory allocated before phase 11: {left:.3f} GiB; the largest live tensors: "
        f"{live_cuda_tensors()}")
    if left > PHASE11_HEADROOM_GIB:
        raise SystemExit(f"{left:.3f} GiB still allocated before phase 11")
    # 11a. qwen2.5-32b at full width, then a profile of steady decode ticks
    eng, stats["qwen"], got = family_serve(all_ops, QWEN_ARGV, "11a qwen2.5-32b serving")
    add(got)
    t = phase("qwen-serve-full-width", t)
    wl = eng.workload
    wall_ms, busy_ms, per_tick, _ = profile_decode(
        wl, serve.make_requests(wl.cfg, 8, 1024, 32, seed=1, min_prompt_len=128))
    log(f"11a qwen2.5-32b steady decode tick, 8 slots: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (ms_tick, n_tick) in top_kernels(per_tick):
        log(f"  {ms_tick * 1e3:9.2f} us/tick {n_tick:6.1f} launches/tick  {name[:110]}")
    classes = kernel_classes(per_tick, busy_ms)
    stats["qwen"].update(tick_wall_ms=wall_ms, tick_busy_ms=busy_ms, tick_classes_ms=classes)
    del eng, wl
    free_device()
    t = phase("qwen-profile-decode", t)
    stats["qwen_check"] = qwen_kernel_check(
        all_ops, registry.override(registry.get_config("qwen2.5-32b"), n_layers=CHECK_LAYERS))
    free_device()
    t = phase("qwen-kernel-check", t)
    # 11b. internvl2-1b at full width (rep 7), then its patch forward
    eng, stats["internvl2"], got = family_serve(all_ops, INTERNVL_ARGV, "11b internvl2-1b serving")
    add(got)
    stats["internvl2_check"] = vlm_kernel_check(all_ops, eng.workload.cfg, eng.workload.params)
    del eng
    free_device()
    t = phase("internvl2-full-width", t)
    # 11c. minicpm-2b at full width
    eng, stats["minicpm"], got = family_serve(all_ops, MINICPM_ARGV, "11c minicpm-2b serving")
    add(got)
    del eng
    free_device()
    t = phase("minicpm-full-width", t)
    # 11d. mixtral-8x7b cut to 16 layers through the contiguous pool
    eng, stats["mixtral"], got = family_serve(all_ops, MIXTRAL_ARGV,
                                              "11d mixtral-8x7b (16 layers) serving")
    add(got)
    wl = eng.workload
    lo, hi = MIXTRAL_PROMPTS
    longest = max((r.prompt for r in serve.make_requests(wl.cfg, 8, hi, 32, 0, lo)), key=len)
    routed, full_seq = {}, {}
    with torch.no_grad():
        transformer.forward_prefill(wl.params, torch.as_tensor(longest, device=device)[None],
                                    wl.cfg, stats=routed)
        tokens = torch.randint(0, wl.cfg.vocab, (1, lo), device=device,
                               generator=torch.Generator(device=device).manual_seed(5))
        dserve.make_prefill_step(wl.cfg, device)(wl.params, {"tokens": tokens}, stats=full_seq)
    dropped, served_dropped = int(full_seq["dropped"]), int(routed["dropped"])
    log(f"11d mixtral-8x7b: make_prefill_step over a {lo}-token prompt (one group, capacity "
        f"{int(wl.cfg.capacity_factor * lo * wl.cfg.top_k / wl.cfg.n_experts)} an expert) "
        f"dropped {dropped} of {full_seq['routed']} (token, expert) assignments "
        f"({dropped / full_seq['routed']:.4f}); the admission forward over the longest served "
        f"prompt ({len(longest)} tokens, a token a group) dropped {served_dropped} of "
        f"{routed['routed']}")
    if served_dropped or routed["routed"] != len(longest) * wl.cfg.top_k * wl.cfg.n_layers:
        raise SystemExit(f"mixtral serving routed {routed}: it must drop nothing")
    stats["mixtral"].update(full_seq_dropped=dropped, full_seq_routed=full_seq["routed"],
                            served_dropped=served_dropped)
    del eng, wl
    free_device()
    t = phase("mixtral-16-layers", t)
    # 11e. llama4-scout cut to 8 layers on the paged pool
    eng, stats["llama4"], got = family_serve(all_ops, LLAMA4_ARGV,
                                             "11e llama4-scout (8 layers) serving")
    add(got)
    del eng
    free_device()
    t = phase("llama4-8-layers", t)
    stats["launches"] = launches
    log(f"phase 11 launches {launches}")
    return stats


# 12. zamba2-2.7b at full width (54 mamba2 layers in 9 groups of 6, one
# weight-shared attention + MLP block after each group with a KV cache of
# its own, 32/32 heads at hd 80; random bf16 weights from seed 0) through
# the CLI's serve(): 12a the paged pool (prompts 1024-4096, budgets 32-64,
# 8 slots on 260 pages of 16 each, dp 3, the paper's non-power-of-two
# case), 12b the contiguous pool (prompts 1024-2048, 4 slots, dp 3)
ZAMBA_PAGED_ARGV = ["--arch", "zamba2-2.7b", "--continuous", "--workload", "llm_decode_paged",
                    "--attn", "kernel", "--dp", "3", "--slots", "8", "--requests", "16",
                    "--min-prompt-len", "1024", "--prompt-len", "4096", "--gen", "64",
                    "--max-len", "4160", "--block-size", "16", "--device", "cuda"]
ZAMBA_POOL_ARGV = ["--arch", "zamba2-2.7b", "--continuous", "--workload", "llm_decode",
                   "--dp", "3", "--slots", "4", "--requests", "8", "--min-prompt-len", "1024",
                   "--prompt-len", "2048", "--gen", "64", "--device", "cuda"]
ZAMBA_CHECK_LAYERS = 12  # 12c: 2 groups of 6 at published widths
# 12e: the smoke configs whose heads (minicpm-2b hd 12, internvl2-1b hd 8)
# the kernels took on the CPU only before
SMOKE_ON_CARD_ARGV = ["--smoke", "--continuous", "--workload", "llm_decode_paged", "--attn",
                      "kernel", "--dp", "3", "--slots", "3", "--requests", "6",
                      "--block-size", "16", "--device", "cuda"]


def zamba_kernel_check(all_ops, cfg) -> dict:
    """12c: zamba2-2.7b at published widths cut to ZAMBA_CHECK_LAYERS layers
    (random weights from seed 0): the prefill logits of two prompts, then
    CHECK_STEPS paged decode steps fed the kernel path's greedy tokens,
    through the kernels and through the two plain paths (each path carries
    its own mamba2 state and pages)."""
    from repro_torch.models import transformer

    bs, device = 16, torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    params = transformer.init_params(cfg, gen, device)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen, device=device)
               for n in CHECK_PROMPTS]
    nb = -(-(max(CHECK_PROMPTS) + CHECK_STEPS) // bs)
    paths = {"kernel": cfg, "full": dataclasses.replace(cfg, attn_impl="full"),
             "flash_scan": dataclasses.replace(cfg, attn_impl="flash_scan")}
    zero(all_ops)
    rows, state = {}, {}
    with torch.no_grad():
        for name, c in paths.items():
            with plain_path() if name != "kernel" else contextlib.nullcontext():
                out = [transformer.forward_prefill(params, p[None], c) for p in prompts]
            rows[name] = [torch.cat([o[0] for o in out])]
            caches = [o[1] for o in out]
            slot = {n: torch.cat([c[n] for c in caches], dim=2) for n in ("m_h", "m_conv")}
            state[name] = (*pages_from_prefill(caches, nb, bs, ("attn_k", "attn_v")), slot)
            del out, caches
        tok = rows["kernel"][0].argmax(-1)
        for i in range(CHECK_STEPS):  # every path fed the kernel path's greedy tokens
            for name, c in paths.items():
                pages, tables, lengths, slot = state[name]
                with plain_path() if name != "kernel" else contextlib.nullcontext():
                    logits, _, _ = transformer.forward_decode_paged(
                        params, tok, pages, tables, lengths + i, c, block_size=bs,
                        slot_state=slot)
                rows[name].append(logits)
            tok = rows["kernel"][-1].argmax(-1)
    attn, norms = per_forward(cfg)
    # the kernel path's launches only: the plain paths launched none
    expect_launches(counts(all_ops), {"flash_attention": attn * len(prompts),
                                      "rmsnorm": norms * (len(prompts) + CHECK_STEPS),
                                      "paged_attention": attn * CHECK_STEPS},
                    "12c zamba2 kernel check", device)
    return gate_rows(f"12c zamba2-2.7b ({cfg.n_layers} layers) prefill of {CHECK_PROMPTS} tokens "
                     f"+ {CHECK_STEPS} teacher-forced paged decode steps, kernel vs plain",
                     *(torch.cat(rows[n]) for n in paths))


def zamba_prefill_32k(all_ops, cfg, params) -> dict:
    """12d: the whole-prompt ``make_prefill_step`` at 32,768 tokens, batch 1
    (the reference's prefill_32k, zamba2 among its long-context archs; its
    batch of 32 cut to 1 for one card): wall time, tokens/s, peak memory,
    and a profile by class and by the function that launched each kernel
    (the SSD scans, the mamba2 layers)."""
    from repro_torch.distributed import serve as dserve
    from repro_torch.models import ssm

    prefill = dserve.make_prefill_step(cfg)
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_LEN), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(7))
    prefill(params, {"tokens": tokens[:, :2048]})  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero(all_ops)
    t1 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2**30
    attn, norms = per_forward(cfg)
    expect_launches(counts(all_ops), {"flash_attention": attn, "rmsnorm": norms},
                    "12d zamba2 32k prefill", torch.device("cuda"))
    if not (logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all()):
        raise SystemExit(f"zamba2 32k prefill logits {tuple(logits.shape)} are not finite")
    busy, per_pf, parts = device_profile(lambda: prefill(params, {"tokens": tokens}), 1, {
        "ssd_scan": (ssm, "_ssd_scan"), "mamba2_apply": (ssm, "mamba2_apply")})
    log(f"12d zamba2-2.7b prefill of {PREFILL_LEN} tokens, batch 1 (reference prefill_32k: batch "
        f"32, cut to 1 for one card): {wall * 1e3:.1f} ms wall, {PREFILL_LEN / wall:.1f} tokens/s, "
        f"peak device memory {peak:.3f} GiB; profiled device busy {busy:.1f} ms")
    for name, (ms_p, n_p) in top_kernels(per_pf, 12):
        log(f"  {ms_p:10.3f} ms {n_p:6.0f} launches  {name[:110]}")
    classes = kernel_classes(per_pf, busy)
    log("  device time by the function that launched it: " + ", ".join(
        f"{k} {v:.1f} ms ({v / busy:.3f})" for k, v in parts.items())
        + " (mamba2_apply holds the SSD scan, its projections, conv and gated norm)")
    del logits, tokens, prefill
    return {"tokens": PREFILL_LEN, "wall_ms": wall * 1e3, "tokens_per_s": PREFILL_LEN / wall,
            "peak_gib": peak, "busy_ms": busy, "busy_ms_by_class": classes,
            "busy_ms_by_function": parts}


def hybrid_phases(all_ops, t: float) -> dict:
    """12. zamba2-2.7b at full width on both pools, the kernel path against
    the plain path, the 32k prefill, and the smoke configs of minicpm-2b and
    internvl2-1b served through the kernels; each model freed before the
    next loads."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import ssm, transformer

    stats: dict = {}
    launches = {op.__name__: 0 for op in all_ops}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    left = torch.cuda.memory_allocated() / 2**30
    log(f"device memory allocated before phase 12: {left:.3f} GiB")
    if left > PHASE11_HEADROOM_GIB:
        raise SystemExit(f"{left:.3f} GiB still allocated before phase 12")
    # 12a. the paged pool, then a profile of steady decode ticks
    eng, stats["paged"], got = family_serve(all_ops, ZAMBA_PAGED_ARGV, "12a zamba2-2.7b paged")
    add(got)
    wl = eng.workload
    state_gb = sum(x.numel() * x.element_size() for x in wl.pool.slot_state.values()) / 1e9
    pages_gb = sum(x.numel() * x.element_size() for x in wl.pool.pages.values()) / 1e9
    log(f"12a zamba2-2.7b: {wl.cfg.n_params()} parameters (the reference's count), page pools "
        f"{pages_gb:.3f} GB, mamba2 state {state_gb:.3f} GB ({len(wl.pool.slot_state)} leaves)")
    stats["paged"].update(pages_gb=pages_gb, state_gb=state_gb)
    t = phase("zamba2-paged-full-width", t)
    wall_ms, busy_ms, per_tick, parts = profile_decode(
        wl, serve.make_requests(wl.cfg, 8, 4096, 64, seed=1, min_prompt_len=1024), targets={
            "mamba2_decode": (ssm, "mamba2_decode"),
            "shared attention layer": (transformer, "_paged_attn_layer")})
    log(f"12a zamba2-2.7b steady decode tick, 8 slots: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (ms_tick, n_tick) in top_kernels(per_tick, 12):
        log(f"  {ms_tick * 1e3:9.2f} us/tick {n_tick:6.1f} launches/tick  {name[:110]}")
    launches_tick = sum(n for _, n in per_tick.values())
    log(f"  {launches_tick:.0f} kernel launches a tick")
    classes = kernel_classes(per_tick, busy_ms)
    log("  device time a tick by the function that launched it: " + ", ".join(
        f"{k} {v:.3f} ms ({v / busy_ms:.3f})" for k, v in parts.items()))
    stats["paged"].update(tick_wall_ms=wall_ms, tick_busy_ms=busy_ms,
                          tick_idle_share=1 - busy_ms / wall_ms, tick_launches=launches_tick,
                          tick_classes_ms=classes, tick_by_function_ms=parts)
    cfg, params = wl.cfg, wl.params
    del eng, wl
    free_device()
    t = phase("zamba2-profile-decode", t)
    # 12d. the 32k whole-prompt prefill, on the same weights
    stats["prefill_32k"] = zamba_prefill_32k(all_ops, cfg, params)
    del params
    free_device()
    t = phase("zamba2-prefill-32k", t)
    # 12b. the contiguous pool
    eng, stats["pool"], got = family_serve(all_ops, ZAMBA_POOL_ARGV, "12b zamba2-2.7b contiguous")
    add(got)
    del eng
    free_device()
    t = phase("zamba2-contiguous-full-width", t)
    # 12c. the kernel path against the plain path at 12 layers
    stats["check"] = zamba_kernel_check(
        all_ops, registry.override(registry.get_config("zamba2-2.7b"),
                                   n_layers=ZAMBA_CHECK_LAYERS))
    free_device()
    t = phase("zamba2-kernel-check", t)
    # 12e. the smoke configs whose heads the kernels took only on the CPU before
    for arch in ("minicpm-2b", "internvl2-1b"):
        eng, stats[f"{arch}_smoke"], got = family_serve(
            all_ops, ["--arch", arch] + SMOKE_ON_CARD_ARGV,
            f"12e {arch} smoke config (hd {registry.get_smoke_config(arch).head_dim}) on the card")
        add(got)
        del eng
    free_device()
    t = phase("smoke-configs-on-card", t)
    stats["launches"] = launches
    log(f"phase 12 launches {launches}")
    return stats


# ---------------------------------------------------------------------------
# 13. training every family on one card
# ---------------------------------------------------------------------------

# 13a: arch -> (layers kept, or None for the whole model; dp; grad sync).
# Published widths; a depth cut keeps the peak under ~72 GiB (llama3.2-1b
# at dp 3 under compressed peaks at ~47 B a parameter): minicpm-2b's 40
# layers to 18 (1.38 B parameters), zamba2-2.7b's 54 to 24 (4 groups of 6
# and the shared block, 1.23 B), gemma3-12b's 48 to one group of 5 local + 1
# global (2.35 B, 1.0 B of it the embedding: dp 2 under mrd_zero1, which
# holds no EF rows), mixtral-8x7b's 32 to 1 (1.71 B, 1.41 B of it experts:
# dp 2).  hubert-xlarge's 48 layers to 12 (0.24 B) and falcon-mamba-7b's 64
# to 4 (0.69 B), like 13d's and 13e's depths, keep the whole script inside
# its time limit with phase 16 on a slow host (PERF.md)
TRAIN_FAMILIES = {
    "hubert-xlarge": (12, 3, "compressed"),
    "internvl2-1b": (None, 3, "compressed"),
    "minicpm-2b": (18, 3, "compressed"),
    "falcon-mamba-7b": (4, 3, "compressed"),
    "zamba2-2.7b": (24, 3, "compressed"),
    "gemma3-12b": (6, 2, "mrd_zero1"),
    "mixtral-8x7b": (1, 2, "compressed"),
}
TRAIN_SEQ, TRAIN_PER_RANK = 1024, 2  # 2 x 1024 tokens a rank
TRAIN_STEPS = 3  # one warm-up step, then the counted ones (ms/step, tokens/s)
# 13b: the smoke configs trained on the card and on the CPU
TRAIN_SMOKE = ("gemma3-12b", "falcon-mamba-7b", "mixtral-8x7b", "llama4-scout-17b-a16e",
               "internvl2-1b", "zamba2-2.7b", "hubert-xlarge")
MODE_STEPS, MODE_SYNC_EVERY = 4, 2  # 13c
# 13d: llama3.2-1b at full width, cut to 1 of 16 layers, at dp 2 (a 7.1 GB
# save: the EF rows make a parameter's state ~10 B larger at dp 3 than at 2)
CKPT_LAYERS, CKPT_DP = 1, 2
REMAT_LAYERS = 6  # 13e: hubert-xlarge cut to 6 of 48 layers


def train_argv(arch: str, dp: int, mode: str, steps: int, remat: str = "full") -> list:
    return ["--arch", arch, "--steps", str(steps), "--batch", str(TRAIN_PER_RANK * dp),
            "--seq", str(TRAIN_SEQ), "--dp", str(dp), "--grad-sync", mode, "--remat", remat,
            "--device", "cuda"]


@contextlib.contextmanager
def depth_cut(arch: str, layers):
    """The registry's full config of ``arch`` cut to ``layers`` (None: whole)."""
    from repro_torch.configs import registry

    cut = ({} if layers is None else
           {arch: registry.override(registry.get_config(arch), n_layers=layers)})
    with mock.patch.dict(registry._FULL, cut):
        yield registry.get_config(arch)


def combine_launches_expected(params, dp: int, mode: str, steps: int) -> int:
    """``mrd_combine`` launches of ``steps`` steps: one a reducing stage a
    bucket under the int8 transform, none under identity."""
    from repro_torch.collectives import plans
    from repro_torch.distributed import step as step_lib

    if mode != "compressed":
        return 0
    layout, _ = step_lib.zero1_layout(params, dp)
    stages = [st for st, *_ in plans.reduce_scatter_plan(p=dp).bound_stage_table()
              if st.kind in ("bshift", "rs")]
    return steps * len(stages) * len(layout.buckets)


def train_family(all_ops, arch: str, layers, dp: int, mode: str, *, steps=TRAIN_STEPS,
                 remat="full") -> dict:
    """One family through the CLI's ``main()`` at published widths, counted
    from 0: finite losses and grad norms, ``mrd_combine`` launched once a
    reducing stage a bucket a step, no other kernel (autograd takes the
    plain versions); ms a step and tokens/s over the steps after the
    first, the peak device memory."""
    from repro_torch.launch import train

    free_device()
    zero(all_ops)
    torch.cuda.reset_peak_memory_stats()
    with depth_cut(arch, layers) as cfg:
        rec = train.main(train_argv(arch, dp, mode, steps, remat))
    got = counts(all_ops)
    want = combine_launches_expected(rec["state"]["params"], dp, mode, steps)
    expect_launches(got, {"mrd_combine": want}, f"13a {arch} train", torch.device("cuda"))
    if mode == "compressed" and not want:
        raise SystemExit(f"{arch}: the compressed sync launched no mrd_combine")
    vals = rec["losses"] + rec["grad_norms"] + rec.get("aux_losses", [])
    if len(rec["losses"]) != steps or not all(np.isfinite(vals)):
        raise SystemExit(f"{arch}: training did not finish every step with finite values: "
                         f"{rec['losses']} {rec['grad_norms']}")
    if cfg.family == "moe" and len(rec.get("aux_losses", [])) != steps:
        raise SystemExit(f"{arch}: the moe run reported no aux loss")
    steady = rec["ms_per_step"][1:]
    stats = {"layers": cfg.n_layers, "params": cfg.n_params(), "dp": dp, "grad_sync": mode,
             "remat": remat, "tokens_a_step": TRAIN_PER_RANK * dp * TRAIN_SEQ,
             "losses": rec["losses"], "grad_norms": rec["grad_norms"],
             "ms_per_step": rec["ms_per_step"], "ms_per_step_mean": sum(steady) / len(steady),
             "tokens_per_s": rec["tokens_per_s"], "peak_gib": rec["peak_bytes"] / 2**30,
             "mrd_combine": got["mrd_combine"]}
    if "aux_losses" in rec:
        stats["aux_losses"] = rec["aux_losses"]
    log(f"13a {arch}: {cfg.n_layers} layers ({cfg.n_params() / 1e9:.3f} B parameters), dp {dp}, "
        f"{mode}, remat {remat}: losses {rec['losses']}, grad norms {rec['grad_norms']}"
        + (f", aux {rec['aux_losses']}" if "aux_losses" in rec else "")
        + f"; ms/step {[round(m, 1) for m in rec['ms_per_step']]} (steps 2-{steps}: "
        f"{stats['ms_per_step_mean']:.1f}), tokens/s {rec['tokens_per_s']:.1f}, peak device "
        f"memory {stats['peak_gib']:.3f} GiB, mrd_combine launches {got['mrd_combine']}")
    stats["state"] = rec["state"]
    return stats


SMOKE_LR = 1e-2  # 13b's learning rate: a flipped int8 tie moves a coordinate by up to 2 x lr


def state_gap(card, cpu) -> dict:
    """The card's train state after a step against the CPU's after the
    same step from the same state, under the family tests' rule for the
    int8 sync (``tests/test_torch_train_families.py``): at most 2% of a
    leaf's elements beyond 1e-4, and none beyond 2 x lr (params, masters),
    1e-2 (moments) or 2.5 x the CPU's largest residual of the leaf (EF);
    the monitor rows' counters and flags equal, their values within phase
    5c's loss bar.  Returns the elements beyond 1e-4 (the footprint of
    the flipped ties) and what broke the rule (None)."""
    from repro_torch.collectives import buckets

    beyond, bad = 0, []
    for part in ("params", "opt"):
        ours, names = buckets.tree_flatten(card[part])
        theirs, rnames = buckets.tree_flatten(cpu[part])
        if names != rnames:
            return {"beyond_1e-4": None, "bad": [f"{part}: leaves {names} != {rnames}"]}
        for name, a, b in zip(names, ours, theirs):
            d = (a.detach().cpu().float() - b.float()).abs()
            over = int((d > 1e-4).sum())
            beyond += over
            bound = 2 * SMOKE_LR
            if part == "opt" and name[0] in ("mu", "nu"):
                bound = 1e-2
            elif part == "opt" and name[0] == "ef":
                bound = 2.5 * float(b.abs().max())
            if float(d.max()) > bound or over > 0.02 * d.numel():
                bad.append(f"{part}/{'/'.join(map(str, name))}: max {float(d.max()):.3e} (bound "
                           f"{bound:.3e}), {over} of {d.numel()} beyond 1e-4")
    ma, mb = card["monitor"], cpu["monitor"]
    if any(ma["nb"][k] != mb["nb"][k] for k in ("stage", "flag", "cycles")) or not torch.equal(
            ma["done"].cpu(), mb["done"]) or sorted(ma["m"]) != sorted(mb["m"]) or not all(
            torch.allclose(x.cpu().float(), y.float(), rtol=0, atol=1e-4) for x, y in
            [(ma["nb"]["buf"], mb["nb"]["buf"]), (ma["nb"]["result"], mb["nb"]["result"]),
             (ma["value"], mb["value"])] + [(ma["m"][k], mb["m"][k]) for k in mb["m"]]):
        bad.append(f"monitor rows: card {ma} != cpu {mb}")
    return {"beyond_1e-4": beyond, "bad": bad or None}


def moe_routes(params, batch, cfg, device) -> torch.Tensor:
    """The experts that keep each token of ``batch`` in each moe layer
    under ``params`` (its routing after the capacity drops), through the
    training forward (autograd on, so the plain versions, as in a train
    step) on ``device``: [layers x tokens, experts] of 0/1."""
    from repro_torch.models import moe, transformer

    def leaves(tree):
        if isinstance(tree, dict):
            return {k: leaves(v) for k, v in tree.items()}
        return tree.detach().to(device).requires_grad_(tree.is_floating_point())

    got, capacity_keep = [], moe.capacity_keep

    def record(idx, c):
        out = capacity_keep(idx, c)
        flat_e, _, keep = out
        kept = torch.nn.functional.one_hot(flat_e, c.n_experts) * keep[..., None]
        got.append(kept.reshape(-1, c.top_k, c.n_experts).sum(1).detach().cpu())
        return out

    with torch.enable_grad(), mock.patch.object(moe, "capacity_keep", record):
        transformer.forward_train(leaves(params), to_device(batch, device), cfg)
    return torch.cat(got)


def free_running_drift(steps, state, batches, cfg) -> list:
    """For the record (no gate): a moe smoke config's free-running card run
    against the CPU's from the same state.  A step: the tokens (of every
    moe layer) whose experts differ from the CPU's routing of the CPU's
    state (:func:`moe_routes`), when the CPU routes the card's state
    (``reroutes_by_state``) and when the card routes the CPU's
    (``reroutes_by_device``); after it, the state's elements beyond 1e-4
    and the loss and grad-norm gaps."""
    card, cpu = to_device(state, "cuda"), to_device(state, "cpu")
    out = []
    for i, b in enumerate(batches):
        ref = moe_routes(cpu["params"], b, cfg, "cpu")
        by_state = int((moe_routes(card["params"], b, cfg, "cpu") != ref).any(-1).sum())
        by_device = int((moe_routes(cpu["params"], b, cfg, "cuda") != ref).any(-1).sum())
        card, mg = steps["cuda"](card, to_device(b, "cuda"))
        cpu, mc = steps["cpu"](cpu, b)
        out.append({"step": i + 1, "tokens": ref.shape[0], "reroutes_by_state": by_state,
                    "reroutes_by_device": by_device,
                    "beyond_1e-4": state_gap(card, cpu)["beyond_1e-4"],
                    "loss_gap": float(mg["loss"]) - float(mc["loss"]),
                    "grad_norm_rel_gap": float(mg["grad_norm"]) / float(mc["grad_norm"]) - 1})
    return out


def smoke_card_vs_cpu(all_ops, arch: str, optimizer: str = "adamw") -> dict:
    """13b. ``arch``'s smoke config trained 3 steps under ``compressed`` at dp
    3 on the CPU, each step run on the card too from a copy of the CPU's
    state before it (weights drawn once on the CPU), on the same batches:
    phase 5c's tolerances (losses atol 1e-4, grad norms rtol 5e-4, the
    monitor's flags equal and certifying at step 3), and the card's state
    after each step against the CPU's (:func:`state_gap`).  Each card step
    starts from the CPU's state because a gradient on an int8 rounding tie
    rounds one way on each device, AdamW's first updates move that
    coordinate by about 2 x lr whatever its size, and under top-1 routing
    with capacity drops (llama4-scout) such a coordinate can reroute a
    token: a free-running card run leaves 5c's bounds by step 2 (3e-4 in
    the loss at step 2, 2% in the grad norm at step 3).  The moe configs
    also run free (:func:`free_running_drift`), to count the reroutes."""
    from repro_torch.collectives import buckets
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import step as step_lib
    from repro_torch.kernels.mrd_combine import ops as mc_ops
    from repro_torch.optim.optimizer import OptimizerConfig

    smoke = registry.get_smoke_config(arch)
    tcfg = step_lib.TrainConfig(
        remat="full", grad_sync="compressed", monitor=True, monitor_threshold=100.0,
        bucket_bytes=1 << 15, optimizer=OptimizerConfig(name=optimizer, lr=SMOKE_LR,
                                                        schedule="const", warmup_steps=0))
    steps = {dev: step_lib.make_train_step(smoke, tcfg, dp=3, device=dev)
             for dev in ("cpu", "cuda")}
    state = steps["cpu"].init_state(torch.Generator().manual_seed(0))
    pipe = SyntheticPipeline(smoke, DataConfig(batch=6, seq_len=16, seed=0), "cpu")
    batches = [pipe.next_batch() for _ in range(3)]
    state0 = to_device(state, "cpu")
    hist, beyond = {"cuda": [], "cpu": []}, []
    n0 = mc_ops.mrd_combine.launches
    for i, b in enumerate(batches):
        card, m = steps["cuda"](to_device(state, "cuda"), to_device(b, "cuda"))
        hist["cuda"].append((float(m["loss"]), float(m["grad_norm"]), bool(m["converged"])))
        state, m = steps["cpu"](state, b)
        hist["cpu"].append((float(m["loss"]), float(m["grad_norm"]), bool(m["converged"])))
        gap = state_gap(card, state)
        if gap["bad"]:
            raise SystemExit(f"13b {arch} smoke training, the state after step {i + 1}: "
                             + "; ".join(gap["bad"]))
        beyond.append(gap["beyond_1e-4"])
        del card
    launched = mc_ops.mrd_combine.launches - n0
    for (lg, gg, cg), (lc, gc, cc) in zip(hist["cuda"], hist["cpu"]):
        if not (abs(lg - lc) <= 1e-4 and abs(gg - gc) <= 5e-4 * abs(gc) and cg == cc):
            raise SystemExit(f"13b {arch} smoke training: card {hist['cuda']} != cpu "
                             f"{hist['cpu']}")
    if [c for *_, c in hist["cuda"]] != [False, False, True] or not launched:
        raise SystemExit(f"13b {arch}: the monitor did not certify at step 3, or no "
                         f"mrd_combine launch: {hist['cuda']}, {launched} launches")
    n_state = sum(t.numel() for part in ("params", "opt")
                  for t in buckets.tree_flatten(state[part])[0])
    log(f"13b {arch} smoke, compressed dp 3, {optimizer}, 3 steps, each from the CPU's state: card "
        f"({launched} mrd_combine launches) {hist['cuda']} vs cpu {hist['cpu']}; the state "
        f"after each step within the int8 tie rule, elements beyond 1e-4 {beyond} of {n_state}")
    out = {"card": hist["cuda"], "cpu": hist["cpu"], "mrd_combine": launched,
           "state_beyond_1e-4": beyond, "state_elements": n_state}
    if smoke.family == "moe":
        out["free_running"] = free_running_drift(steps, state0, batches, smoke)
        log(f"13b {arch} free-running, for the record: " + "; ".join(
            f"step {d['step']}: reroutes {d['reroutes_by_state']} by state, "
            f"{d['reroutes_by_device']} by device of {d['tokens']} token-layers, "
            f"{d['beyond_1e-4']} state elements beyond 1e-4, loss gap {d['loss_gap']:.3e}, "
            f"grad norm {d['grad_norm_rel_gap']:+.3e} relative" for d in out["free_running"]))
    return out


def train_modes_phase() -> dict:
    """13c. ``mrd_leaf`` and ``local_sgd`` at llama3.2-1b's full width, dp 3,
    4 steps with ``local_sync_every`` 2 (two averages): ms a step each, and
    for ``local_sgd`` the average's share of a sync step; after each
    average every replica's params equal bit for bit."""
    from repro_torch.collectives import buckets
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import step as step_lib
    from repro_torch.optim.optimizer import OptimizerConfig

    cfg = registry.get_config("llama3.2-1b")
    out = {}
    for mode in ("mrd_leaf", "local_sgd"):
        free_device()
        torch.cuda.reset_peak_memory_stats()
        tcfg = step_lib.TrainConfig(remat="full", grad_sync=mode, monitor=mode != "local_sgd",
                                    monitor_threshold=1e-3, local_sync_every=MODE_SYNC_EVERY,
                                    optimizer=OptimizerConfig(lr=3e-3, warmup_steps=0,
                                                              total_steps=MODE_STEPS))
        step = step_lib.make_train_step(cfg, tcfg, dp=3, device="cuda")
        state = step.init_state(torch.Generator(device="cuda").manual_seed(0))
        pipe = SyntheticPipeline(cfg, DataConfig(batch=6, seq_len=TRAIN_SEQ), "cuda")
        avg_ms = []
        if mode == "local_sgd":
            average = step.average_

            def timed(params):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                average(params)
                torch.cuda.synchronize()
                avg_ms.append((time.perf_counter() - t1) * 1e3)

            step.average_ = timed
        ms, losses, equal = [], [], []
        for i in range(MODE_STEPS):
            batch = pipe.next_batch()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t1) * 1e3)
            if mode == "local_sgd" and (i + 1) % MODE_SYNC_EVERY == 0:
                equal.append(all(torch.equal(leaf[0], leaf[r]) for leaf in
                                 buckets.tree_flatten(state["params"])[0] for r in range(1, 3)))
        if not all(np.isfinite(losses)) or (mode == "local_sgd" and not (
                len(equal) == 2 and all(equal) and len(avg_ms) == 2)):
            raise SystemExit(f"13c {mode}: losses {losses}, replicas equal after the averages "
                             f"{equal}")
        out[mode] = {"losses": losses, "ms_per_step": ms,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        line = (f"13c {mode} llama3.2-1b dp 3, {MODE_STEPS} steps: losses {losses}, ms/step "
                f"{[round(x, 1) for x in ms]}, peak device memory {out[mode]['peak_gib']:.3f} GiB")
        if mode == "local_sgd":
            sync_ms = [ms[i] for i in range(MODE_STEPS) if (i + 1) % MODE_SYNC_EVERY == 0]
            out[mode].update(average_ms=avg_ms, average_share=[a / s for a, s in
                                                                zip(avg_ms, sync_ms)])
            line += (f"; the average {[round(x, 1) for x in avg_ms]} ms, "
                     f"{[round(x, 3) for x in out[mode]['average_share']]} of its sync step; "
                     f"every replica's params equal bit for bit after each average")
        log(line)
        del step, state, pipe
    return out


def checkpoint_phase() -> dict:
    """13d. The checkpoint round trip at full width (llama3.2-1b cut to
    CKPT_LAYERS layers, compressed, dp CKPT_DP) with the CLI's pieces: run A
    trains 5 steps and snapshots with ``save(block=False)`` after step 2
    (the first save, which allocates the pinned host buffers) and after
    step 3 (which joins step 2's writer, then stages into the same
    buffers), so steps 4-5 run with step 3's write in flight; run B is a
    fresh train step and pipeline restored from step 3 through the CLI's
    resume path, then trains the same 2 batches.  B's losses and final
    params must equal A's."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.collectives import buckets
    from repro_torch.launch import train
    from repro_torch.models import convert

    argv = train_argv("llama3.2-1b", CKPT_DP, "compressed", 5) + ["--schedule", "const"]
    args = train.build_parser().parse_args(argv)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with depth_cut("llama3.2-1b", CKPT_LAYERS):
            free_device()
            device, cfg, train_step, pipe = train.make(args)
            state = train_step.init_state(torch.Generator(device=device).manual_seed(0))
            ck = Checkpointer(os.path.join(root, "a"))
            ms, losses_a = [], []
            for i in range(5):
                batch = pipe.next_batch()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, m = train_step(state, batch)
                losses_a.append(float(m["loss"]))
                ms.append((time.perf_counter() - t1) * 1e3)
                if i in (1, 2):
                    ck.save(state["step"], convert.train_state_to_reference(state),
                            extra={"data": pipe.state_dict(), "dp": args.dp,
                                   "grad_sync": args.grad_sync}, block=False)
                if i == 3:  # the writer records its time when it is done
                    in_flight = "write_s" not in ck.saves[1]
            ck.wait()
            first, save = ck.saves
            final_a = {k: v.cpu() for k, v in zip(
                *reversed(buckets.tree_flatten(state["params"])))}
            del state, train_step, pipe, ck  # ck holds the pinned buffers
            free_device()
            device, cfg, train_step, pipe = train.make(args)
            state = train_step.init_state(torch.Generator(device=device).manual_seed(1))
            t1 = time.perf_counter()
            state, step0 = train.resume(Checkpointer(os.path.join(root, "a")), state, cfg, pipe,
                                        args.dp, device, args.grad_sync)
            restore_s = time.perf_counter() - t1
            losses_b = []
            for _ in range(2):
                state, m = train_step(state, pipe.next_batch())
                losses_b.append(float(m["loss"]))
            final_b = dict(zip(*reversed(buckets.tree_flatten(state["params"]))))
            same = all(torch.equal(final_a[k], final_b[k].cpu()) for k in final_a)
            del state, train_step, pipe
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stats = {"layers": CKPT_LAYERS, "dp": CKPT_DP, "bytes": save["bytes"], "hold_ms": save["hold_s"] * 1e3,
             "first_hold_ms": first["hold_s"] * 1e3, "first_write_s": first["write_s"],
             "wait_ms": save["wait_s"] * 1e3,
             "write_s": save["write_s"], "restore_s": restore_s, "ms_per_step": ms,
             "ms_without_save": ms[1], "ms_with_save_in_flight": ms[2:],
             "write_in_flight_through_step_4": in_flight, "losses_a": losses_a,
             "losses_b": losses_b, "resumed_from": step0, "bitwise": same}
    log(f"13d checkpoint round trip, llama3.2-1b full width cut to {CKPT_LAYERS} layers, "
        f"compressed dp {CKPT_DP}: {save['bytes'] / 2**30:.3f} GiB a save; the first "
        f"save(block=False), "
        f"after step 2, held the loop {stats['first_hold_ms']:.1f} ms (the pinned buffers "
        f"allocated), its writer took {first['write_s']:.2f} s; the second, after step 3, joined "
        f"that writer for {stats['wait_ms']:.1f} ms, then held the loop {stats['hold_ms']:.1f} ms "
        f"(the buffers reused), its writer took {save['write_s']:.2f} s (still "
        f"writing when step 4 ended: {in_flight}); step 2 {ms[1]:.1f} ms without a save, steps "
        f"3-5 {[round(x, 1) for x in ms[2:]]} ms with one in flight; restore through the CLI's "
        f"resume path {restore_s:.2f} s; run A losses 4-5 {losses_a[3:]}, run B {losses_b}; "
        f"final params equal bit for bit: {same}")
    if step0 != 3 or losses_b != losses_a[3:] or not same:
        raise SystemExit(f"13d: the resumed run differs from the uninterrupted one: {stats}")
    return stats


def train_profile(arch: str, layers, dp: int, mode: str, state, remat: str = "full") -> dict:
    """13f. Where one train step's time goes: wall without the profiler,
    device busy, idle share, the costliest kernels, device time by class
    and by the function that launched it (attention, the MLP, the chunked
    scan, the gradient sync's plans, the optimizer; each function's forward
    and recompute, not the backward's kernels, which carry no range)."""
    from repro_torch.collectives import plans
    from repro_torch.launch import train
    from repro_torch.models import ssm, transformer
    from repro_torch.optim import optimizer as opt_lib

    with depth_cut(arch, layers):
        args = train.build_parser().parse_args(train_argv(arch, dp, mode, 1, remat))
        _, cfg, train_step, pipe = train.make(args)
        box = {"s": state}
        batch = pipe.next_batch()

        def one_step():
            box["s"], m = train_step(box["s"], batch)
            return m

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        float(one_step()["loss"])
        wall = (time.perf_counter() - t1) * 1e3
        targets = {"attention": (transformer, "attention"), "mlp": (transformer, "mlp_apply"),
                   "chunk_scan": (ssm, "chunk_scan"),
                   "grad_sync": (plans.CollectivePlan, "run_buffers"),
                   "adamw": (opt_lib, "apply_update_vector")}
        names = (("chunk_scan", "grad_sync", "adamw") if cfg.family == "ssm"
                 else ("attention", "mlp", "grad_sync", "adamw"))
        busy, per_step, parts = device_profile(one_step, 1, {k: targets[k] for k in names})
    log(f"13f {arch} train step ({TRAIN_PER_RANK * dp} x {TRAIN_SEQ} tokens, dp {dp}, {mode}, "
        f"remat {remat}): wall {wall:.1f} ms, device busy {busy:.1f} ms, device idle share "
        f"{1 - busy / wall:.3f}")
    for name, (ms_s, n_s) in top_kernels(per_step, 10):
        log(f"  {ms_s:10.3f} ms/step {n_s:6.0f} launches/step  {name[:110]}")
    classes = kernel_classes(per_step, busy)
    log("  device time by the function that launched it: " + ", ".join(
        f"{k} {v:.1f} ms ({v / busy:.3f})" for k, v in parts.items()))
    box.clear()
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "busy_ms_by_class": classes, "busy_ms_by_function": parts}


def training_phases(all_ops, t: float) -> dict:
    """13. Training every family on one card: 13a each family through the
    CLI at published widths (counted launches), 13b the smoke configs card
    against CPU, 13c ``mrd_leaf`` and ``local_sgd``, 13d the checkpoint
    round trip, 13e remat on hubert-xlarge, 13f three profiled steps."""
    stats: dict = {"families": {}, "profiles": {}}
    launches = 0
    for arch, (layers, dp, mode) in TRAIN_FAMILIES.items():
        fam = train_family(all_ops, arch, layers, dp, mode)
        launches += fam["mrd_combine"]
        state = fam.pop("state")
        if arch in ("hubert-xlarge", "falcon-mamba-7b"):  # 13f
            stats["profiles"][arch] = train_profile(arch, layers, dp, mode, state)
        del state
        stats["families"][arch] = fam
        t = phase(f"train-{arch}", t)
    stats["launches"] = {"mrd_combine": launches}
    stats["smoke_card_vs_cpu"] = {a: smoke_card_vs_cpu(all_ops, a) for a in TRAIN_SMOKE}
    t = phase("train-smoke-card-vs-cpu", t)
    stats["modes"] = train_modes_phase()
    t = phase("train-mrd-leaf-local-sgd", t)
    stats["checkpoint"] = checkpoint_phase()
    t = phase("train-checkpoint", t)
    remat = {}
    for r in ("none", "full", "dots"):  # 13e
        fam = train_family(all_ops, "hubert-xlarge", REMAT_LAYERS, 3, "compressed", remat=r)
        state = fam.pop("state")
        if r == "dots":  # 13f: where dots' step goes, beside 13a's remat full profile
            stats["profiles"]["hubert-xlarge dots"] = train_profile(
                "hubert-xlarge", REMAT_LAYERS, 3, "compressed", state, remat="dots")
        del state
        remat[r] = {k: fam[k] for k in ("losses", "ms_per_step_mean", "peak_gib")}
    base = remat["none"]["losses"]
    for r, v in remat.items():
        if any(abs(a - b) > 1e-4 * abs(b) for a, b in zip(v["losses"], base)):
            raise SystemExit(f"13e remat {r}: losses {v['losses']} != none's {base}")
    log("13e hubert-xlarge remat: " + "; ".join(
        f"{r} {v['ms_per_step_mean']:.1f} ms/step, peak {v['peak_gib']:.3f} GiB"
        for r, v in remat.items()) + " (losses within 1e-4 relative of remat none's)")
    stats["remat"] = remat
    t = phase("train-remat", t)
    free_device()
    return stats


# ---------------------------------------------------------------------------
# 14. the multi-process trainer (a one-rank NCCL world), Lion and SGD
# ---------------------------------------------------------------------------

WORLD_MODES = ("compressed", "mrd_zero1", "mrd_leaf")  # 14a
WORLD_STEPS = 3
OPTIMIZER_RUNS = tuple((name, mode) for name in ("lion", "sgd")
                       for mode in ("compressed", "mrd_leaf"))  # 14b, at dp 3


# 14a's, 15's and 18c's one-rank world, in one subprocess and one process
# group (one process start and one cold card): the train CLI's world entry
# (``main()``'s ``init_world``, ``train``, ``destroy_process_group``) for
# every argument list of 14a's, each writing its record; then 15's
# ``gspmd`` train run and the serving CLI's world entry on the same
# ``("data",)`` mesh of 1, each counted from 0, their records in one JSON;
# then 18c's elastic gspmd world with a checkpointer (llama3.2-1b at full
# width cut to ELASTIC_CK_LAYERS layers: its checkpoint is 14 bytes a
# parameter, written to a temporary directory and removed)
WORLD_RUNNER = """
import json, shutil, sys, tempfile, time
import torch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mrd_combine import ops as mc
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.selective_scan import ops as ss
from repro_torch.launch import serve, train

ops = (pa.paged_attention, mc.mrd_combine, fa.flash_attention, rn.rmsnorm, ss.selective_scan)
job = json.loads(sys.argv[1])
runs = [train.build_parser().parse_args(argv) for argv in job["modes"]]
device, mesh = train.init_world(runs[0], train.world_env())
out = {}
try:
    for args in runs:
        torch.cuda.reset_peak_memory_stats(device)
        train.train(args, device, mesh)
        torch.cuda.empty_cache()
    targs = train.build_parser().parse_args(job["train"])
    torch.cuda.reset_peak_memory_stats(device)
    for op in ops:
        op.launches = 0
    rec = train.train(targs, device, mesh)
    out["train"] = {"losses": rec["losses"], "grad_norms": rec["grad_norms"],
                    "ms_per_step": rec["ms_per_step"], "peak_bytes": rec["peak_bytes"],
                    "digest": train.state_digest(rec["state"]),
                    "launches": {op.__name__: op.launches for op in ops}}
    del rec
    torch.cuda.empty_cache()
    sargs = serve.build_parser().parse_args(job["serve"])
    sargs.device = str(device)
    for op in ops:
        op.launches = 0
    eng = serve.run(sargs, mesh)
    out["serve"] = {"results": {str(i): [r.output.tolist(), r.admit_tick, r.retire_tick]
                                for i, r in eng.results.items()},
                    "summary": {k: eng.summary()[k] for k in (
                        "completed", "ticks", "throughput_tok_s", "ttft_p50_ms",
                        "tpot_p50_ms")},
                    "launches": {op.__name__: op.launches for op in ops}}
    del eng
    torch.cuda.empty_cache()
    # 18c: an elastic gspmd world of this one rank with a checkpointer:
    # save_at steps and a save, the rest of the uninterrupted run; then the
    # checkpoint recovered into a fresh trainer and the rest run again
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.runtime import ElasticConfig, ElasticTrainer
    ej = job["elastic"]
    eargs = train.build_parser().parse_args(ej["argv"])
    cfg, tcfg = train.configs(eargs)
    cfg = registry.override(cfg, n_layers=ej["layers"])
    dcfg = DataConfig(batch=eargs.batch, seq_len=eargs.seq, seed=eargs.seed)

    def trainer(ck=None):
        return ElasticTrainer(mesh, (cfg, tcfg),
                              lambda m: SyntheticPipeline(cfg, dcfg, device, rank=0, dp=1),
                              checkpointer=ck, device=device,
                              cfg=ElasticConfig(policy="grow_on_join", ckpt_every=1 << 30))

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    for op in ops:
        op.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    n, k = eargs.steps, ej["save_at"]
    d = tempfile.mkdtemp(prefix="chip_smoke_elastic_ck_")
    try:
        ck = Checkpointer(d, world=(0, 1))
        tr = trainer(ck)
        st, first = tr.run(tr.init_or_restore(gen(eargs.seed)), k)  # its end: a blocking save
        tr.ck = None  # the uninterrupted run goes on, unsaved
        st, rest0 = tr.run(st, n - k)
        full = first + rest0
        del st, tr
        torch.cuda.empty_cache()
        ck2 = Checkpointer(d, world=(0, 1))
        tr = trainer(ck2)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        st = tr.init_or_restore(gen(eargs.seed + 1))
        torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t
        resumed_at, tr.ck = tr.step, None  # no save at the end of the rest
        st, rest = tr.run(st, n - k)
        del st, tr
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out["elastic"] = {"full": full, "first": first, "rest": rest, "resumed_at": resumed_at,
                      "save": ck.saves[-1], "restore_s": restore_s,
                      "restore_bytes": ck2.restores[-1]["bytes"],
                      "peak_bytes": torch.cuda.max_memory_allocated(device),
                      "launches": {op.__name__: op.launches for op in ops}}
finally:
    train.end_world()
with open(job["out"], "w") as f:
    json.dump(out, f)
"""
ELASTIC_CK_LAYERS, ELASTIC_CK_STEPS, ELASTIC_CK_SAVE_AT = 2, 4, 2  # 18c
TP_SERVE_ARGV = [
    "--arch", "llama3.2-1b", "--continuous", "--workload", "llm_decode_paged",
    "--attn", "kernel", "--dp", "3", "--slots", "8", "--requests", "8",
    "--prompt-len", "64", "--gen", "16", "--block-size", "16",
]


def one_rank_world() -> dict:
    """14a's and 15's one-rank NCCL world: :data:`WORLD_RUNNER` under
    ``torch.distributed.run --nproc-per-node 1`` in a subprocess ->
    {"wall_s", "modes": {mode: 14a's record}, "tp": 15's records}."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    summary = {mode: out / f"p14_world_{mode}.json" for mode in WORLD_MODES}
    job = {"modes": [train_argv("llama3.2-1b", 1, mode, WORLD_STEPS)
                     + ["--summary-json", str(summary[mode])] for mode in WORLD_MODES],
           "train": train_argv("llama3.2-1b", 1, "gspmd", WORLD_STEPS),
           "serve": TP_SERVE_ARGV + ["--device", "cuda"], "out": str(out / "p15_tp_world.json"),
           "elastic": {"argv": train_argv("llama3.2-1b", 1, "gspmd", ELASTIC_CK_STEPS)
                       + ["--schedule", "const"],
                       "layers": ELASTIC_CK_LAYERS, "save_at": ELASTIC_CK_SAVE_AT}}
    free_device()
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "--no-python", sys.executable, "-c", WORLD_RUNNER, json.dumps(job)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    wall_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise SystemExit(f"14a/15: the one-rank world failed ({proc.returncode}):\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
    log(f"14a/15 the one-rank NCCL world ran {', '.join(WORLD_MODES)}, then gspmd and the "
        f"serving entry, in {wall_s:.1f} s with its start")
    return {"wall_s": wall_s, "tp": json.loads(Path(job["out"]).read_text()),
            "modes": {mode: json.loads(summary[mode].read_text()) for mode in WORLD_MODES}}


def world_vs_sim(all_ops, worlds: dict) -> dict:
    """14a. llama3.2-1b at full width, 3 steps at dp 1 under each of
    ``WORLD_MODES``: the train CLI as a one-rank NCCL world
    (:func:`one_rank_world`'s records, each with the digest of its final
    state) against the stacked-rows trainer in this process, on the same
    card: the losses, grad norms and digests equal bit for bit, and no
    kernel launched (at dp 1 no plan has a stage)."""
    from repro_torch.launch import train

    stats = {"world_wall_s": worlds["wall_s"]}
    for mode in WORLD_MODES:
        world = worlds["modes"][mode]
        free_device()
        zero(all_ops)
        torch.cuda.reset_peak_memory_stats()
        rec = train.main(train_argv("llama3.2-1b", 1, mode, WORLD_STEPS))
        expect_launches(counts(all_ops), {}, f"14a {mode} stacked rows at dp 1",
                        torch.device("cuda"))
        digest = train.state_digest(rec.pop("state"))
        free_device()
        same = (world["losses"] == rec["losses"] and world["grad_norms"] == rec["grad_norms"]
                and world["state_digest"] == digest)
        stats[mode] = {"world": {k: world[k] for k in (
                           "losses", "grad_norms", "ms_per_step", "tokens_per_s", "peak_bytes",
                           "mrd_combine_launches", "rank", "world_size", "state_digest")},
                       "sim": {k: rec[k] for k in ("losses", "grad_norms", "ms_per_step",
                                                   "tokens_per_s", "peak_bytes",
                                                   "mrd_combine_launches")},
                       "sim_digest": digest, "bit_for_bit": same}
        log(f"14a {mode} llama3.2-1b dp 1, {WORLD_STEPS} steps: one-rank NCCL world losses "
            f"{world['losses']}, grad norms {world['grad_norms']}, ms/step "
            f"{[round(m, 1) for m in world['ms_per_step']]}, peak "
            f"{world['peak_bytes'] / 2**30:.3f} GiB; stacked rows ms/step "
            f"{[round(m, 1) for m in rec['ms_per_step']]}, peak "
            f"{rec['peak_bytes'] / 2**30:.3f} GiB; digests {world['state_digest'][:16]} / "
            f"{digest[:16]}; bit for bit {same}")
        if (not same or world["mrd_combine_launches"]
                or (world["rank"], world["world_size"]) != (0, 1)):
            raise SystemExit(f"14a {mode}: the one-rank world differs from the stacked-rows "
                             f"trainer: {stats[mode]}")
    return stats


def optimizer_run(all_ops, name: str, mode: str) -> dict:
    """14b. ``name`` (Lion or SGD) in the stacked-rows trainer at
    llama3.2-1b's full width, dp 3 under ``mode``, counted from 0."""
    from repro_torch.launch import train

    free_device()
    zero(all_ops)
    torch.cuda.reset_peak_memory_stats()
    rec = train.main(train_argv("llama3.2-1b", 3, mode, WORLD_STEPS) + ["--optimizer", name])
    got = counts(all_ops)
    want = combine_launches_expected(rec.pop("state")["params"], 3, mode, WORLD_STEPS)
    free_device()
    expect_launches(got, {"mrd_combine": want}, f"14b {name} {mode}", torch.device("cuda"))
    if mode == "compressed" and not want:
        raise SystemExit(f"14b {name}: the compressed sync launched no mrd_combine")
    if not all(np.isfinite(rec["losses"] + rec["grad_norms"])):
        raise SystemExit(f"14b {name} {mode}: non-finite values {rec['losses']} "
                         f"{rec['grad_norms']}")
    steady = rec["ms_per_step"][1:]
    stats = {"losses": rec["losses"], "grad_norms": rec["grad_norms"],
             "ms_per_step": rec["ms_per_step"], "ms_per_step_mean": sum(steady) / len(steady),
             "peak_gib": rec["peak_bytes"] / 2**30, "mrd_combine": got["mrd_combine"]}
    log(f"14b {name} {mode} llama3.2-1b dp 3: losses {rec['losses']}, grad norms "
        f"{rec['grad_norms']}, ms/step {[round(m, 1) for m in rec['ms_per_step']]}, peak "
        f"{stats['peak_gib']:.3f} GiB, mrd_combine launches {got['mrd_combine']}")
    return stats


def world_phases(all_ops, t: float, worlds: dict) -> dict:
    """14. 14a the one-rank NCCL world against the stacked rows, 14b Lion
    and SGD at full width and on the smoke config card against CPU."""
    stats: dict = {"world": {}, "optimizers": {}, "smoke_card_vs_cpu": {}}
    stats["world"] = world_vs_sim(all_ops, worlds)
    t = phase("world-vs-sim", t)
    launches = 0
    for name, mode in OPTIMIZER_RUNS:
        run = optimizer_run(all_ops, name, mode)
        launches += run["mrd_combine"]
        stats["optimizers"][f"{name} {mode}"] = run
    for name in ("lion", "sgd"):
        smoke = smoke_card_vs_cpu(all_ops, "llama3.2-1b", optimizer=name)
        launches += smoke["mrd_combine"]
        stats["smoke_card_vs_cpu"][name] = smoke
    stats["launches"] = {"mrd_combine": launches}
    t = phase("lion-sgd", t)
    free_device()
    return stats


def tp_world_phase(all_ops, t: float, worlds: dict) -> dict:
    """15. The train CLI's ``gspmd`` world and the serving CLI's world
    entry as one-rank NCCL worlds (:func:`one_rank_world`'s records)
    against the stacked-rows ``gspmd`` trainer and the plain serving CLI in
    this process, on the same card; this process's runs counted from 0."""
    from repro_torch.launch import serve, train

    targv = train_argv("llama3.2-1b", 1, "gspmd", WORLD_STEPS)
    world, world_s = worlds["tp"], worlds["wall_s"]
    free_device()
    zero(all_ops)
    torch.cuda.reset_peak_memory_stats()
    rec = train.main(targv)
    digest = train.state_digest(rec.pop("state"))
    free_device()
    trained = counts(all_ops)
    expect_launches(trained, {}, "15 stacked gspmd at dp 1", torch.device("cuda"))
    eng = serve.main(TP_SERVE_ARGV + ["--device", "cuda"])
    served = {k: v - trained[k] for k, v in counts(all_ops).items()}
    plain = {str(i): [r.output.tolist(), r.admit_tick, r.retire_tick]
             for i, r in eng.results.items()}
    del eng
    free_device()
    wt, ws = world["train"], world["serve"]
    same_train = (wt["losses"] == rec["losses"] and wt["grad_norms"] == rec["grad_norms"]
                  and wt["digest"] == digest)
    same_serve = ws["results"] == plain
    stats = {"world_wall_s": world_s, "train_bit_for_bit": same_train,
             "serve_equal": same_serve,
             "world_train": {k: wt[k] for k in ("losses", "grad_norms", "ms_per_step",
                                                "peak_bytes", "launches")},
             "stacked_train": {k: rec[k] for k in ("losses", "grad_norms", "ms_per_step",
                                                   "peak_bytes")},
             "world_serve": {k: ws[k] for k in ("summary", "launches")},
             "plain_serve_launches": served,
             "launches": {k: trained[k] + served[k] for k in trained}}
    log(f"15 gspmd llama3.2-1b dp 1, {WORLD_STEPS} steps: one-rank NCCL world losses "
        f"{wt['losses']}, grad norms {wt['grad_norms']}, ms/step "
        f"{[round(m, 1) for m in wt['ms_per_step']]}, peak {wt['peak_bytes'] / 2**30:.3f} GiB; "
        f"stacked ms/step {[round(m, 1) for m in rec['ms_per_step']]}; digests "
        f"{wt['digest'][:16]} / {digest[:16]}; bit for bit {same_train}")
    log(f"15 serving world entry: {ws['summary']}, launches {ws['launches']}; plain CLI "
        f"launches {served}; tokens and ticks equal {same_serve}")
    if not same_train or not same_serve:
        raise SystemExit(f"15: a one-rank world differs from the plain entry: {stats}")
    for name, got in (("world train", wt["launches"]), ("stacked train", trained),
                      ("world serve", ws["launches"]), ("plain serve", served)):
        if got["mrd_combine"]:
            raise SystemExit(f"15 {name}: gspmd launched mrd_combine {got['mrd_combine']} times")
        if "serve" in name and not all(got[k] > 0 for k in (
                "flash_attention", "paged_attention", "rmsnorm")):
            raise SystemExit(f"15 {name}: a serving kernel never launched: {got}")
    t = phase("tp-world-vs-plain", t)
    return stats


OVERLAP_DP, OVERLAP_STEPS = 3, 3


def overlap_phase(all_ops, t: float) -> dict:
    """16. The ready-bucket overlap through the train CLI's ``main()``:
    llama3.2-1b at full width on stacked rows at dp 3 under ``compressed``,
    ``--no-overlap`` then ``--overlap`` from the same seed, each counted
    from 0.  Gates: the same losses and grad norms and the same state
    digest bit for bit, ``mrd_combine`` launched once a reducing stage a
    bucket a step in both runs (the sim route), no other kernel."""
    from repro_torch.launch import train

    runs = {}
    for flag in ("--no-overlap", "--overlap"):
        free_device()
        zero(all_ops)
        torch.cuda.reset_peak_memory_stats()
        rec = train.main(train_argv("llama3.2-1b", OVERLAP_DP, "compressed", OVERLAP_STEPS)
                         + [flag])
        got = counts(all_ops)
        want = combine_launches_expected(rec["state"]["params"], OVERLAP_DP, "compressed",
                                         OVERLAP_STEPS)
        expect_launches(got, {"mrd_combine": want}, f"16 {flag}", torch.device("cuda"))
        runs[flag] = {"losses": rec["losses"], "grad_norms": rec["grad_norms"],
                      "ms_per_step": rec["ms_per_step"], "tokens_per_s": rec["tokens_per_s"],
                      "peak_gib": rec["peak_bytes"] / 2**30,
                      "digest": train.state_digest(rec.pop("state")),
                      "launches": got}
        del rec
        log(f"16 llama3.2-1b dp {OVERLAP_DP} compressed {flag}: losses "
            f"{runs[flag]['losses']}, grad norms {runs[flag]['grad_norms']}, ms/step "
            f"{[round(m, 1) for m in runs[flag]['ms_per_step']]}, tokens/s "
            f"{runs[flag]['tokens_per_s']:.1f}, peak {runs[flag]['peak_gib']:.3f} GiB, "
            f"mrd_combine {got['mrd_combine']} (expected {want}), digest "
            f"{runs[flag]['digest'][:16]}")
    free_device()
    off, on = runs["--no-overlap"], runs["--overlap"]
    same = all(off[k] == on[k] for k in ("losses", "grad_norms", "digest", "launches"))
    if not same or not off["launches"]["mrd_combine"]:
        raise SystemExit(f"16: --overlap differs from --no-overlap: {runs}")
    phase("overlap", t)
    return {"dp": OVERLAP_DP, "steps": OVERLAP_STEPS, "bit_for_bit": same,
            "no_overlap": off, "overlap": on,
            "launches": {k: off["launches"][k] + on["launches"][k] for k in off["launches"]}}


# 17. elastic serving: the reference CLI's script from dp 4 (kill 6:2, a
# 10x stall of replica 1 at 10, join 16:(4, 5), unstall 22:1, kill 26:0)
ELASTIC_SCRIPT = ["--elastic-policy", "grow_on_join", "--steps-per-dispatch", "4",
                  "--kill", "6:2", "--stall", "10:1:10", "--join", "16:4,5",
                  "--unstall", "22:1", "--kill", "26:0"]
ELASTIC_TRAJECTORY = [("shrink", 4, 3), ("grow", 3, 5), ("shrink", 5, 4)]
ELASTIC_REQUESTS = 24
ELASTIC_LLM_ARGV = [
    "--arch", "llama3.2-1b", "--continuous", "--workload", "llm_decode_paged",
    "--attn", "kernel", "--dp", "4", "--slots", "8", "--requests", str(ELASTIC_REQUESTS),
    "--prompt-len", "64", "--gen", "32", "--block-size", "16", "--arrival", "poisson:0.5",
    "--device", "cuda",
]
ELASTIC_FP_ARGV = [
    "--continuous", "--workload", "fixedpoint_solve", "--solver", "d_iteration",
    "--n", str(FP_DITER_N), "--dp", "4", "--slots", str(FP_SLOTS),
    "--requests", str(ELASTIC_REQUESTS), "--termination", "residual_interval", "--eps", "1e-10",
    "--arrival", "poisson:0.5", "--device", "cuda",
]


def _p50_ms(xs) -> float:
    xs = [x for x in xs if np.isfinite(x)]
    return float(np.percentile(xs, 50) * 1e3) if xs else float("nan")


@contextlib.contextmanager
def timed_resizes(records: list, watch=()):
    """Wrap ``ServeEngine.resize``: each resize's wall time (synchronized),
    and around a grow the allocated bytes before it, its peak, the largest
    leaf it broadcasts, each ``watch`` kernel's launches so far, and the
    params after it against a host copy taken before it (``torch.equal``,
    leaf by leaf)."""
    from repro_torch.serving import ServeEngine

    real = ServeEngine.resize

    def resize(self, new_dp, keep, *, reason=""):
        grow = any(k is None for k in keep)
        rec = {"tick": self.tick, "old_dp": self.dp, "new_dp": new_dp, "grow": grow,
               "check_ms": 0.0}
        params = list(_leaves(getattr(self.workload, "params", {})))
        if grow:
            t0 = time.perf_counter()
            host = [leaf.cpu() for leaf in params]
            rec["largest_leaf"] = max((t.numel() * t.element_size() for t in
                                       params + list(_leaves(self.workload.wstate))
                                       if isinstance(t, torch.Tensor)), default=0)
            rec["launches"] = {op.__name__: op.launches for op in watch}
            torch.cuda.synchronize()
            rec["resident"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rec["check_ms"] += (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        ev = real(self, new_dp, keep, reason=reason)
        torch.cuda.synchronize()
        rec["wall_ms"] = (time.perf_counter() - t1) * 1e3
        if grow:
            t0 = time.perf_counter()
            rec["peak"] = torch.cuda.max_memory_allocated()
            after = list(_leaves(getattr(self.workload, "params", {})))
            rec["params_equal"] = len(after) == len(host) and all(
                torch.equal(a, h.to(a.device)) for a, h in zip(after, host))
            del host
            rec["check_ms"] += (time.perf_counter() - t0) * 1e3
        records.append(rec)
        return ev

    with mock.patch.object(ServeEngine, "resize", resize):
        yield


def elastic_around(eng, records) -> list:
    """TTFT and TPOT p50 (ms) of the requests retired before each resize
    and of those admitted at or after it."""
    res = list(eng.results.values())
    out = []
    for rec in records:
        before = [r for r in res if r.retire_tick < rec["tick"]]
        after = [r for r in res if r.admit_tick >= rec["tick"]]
        out.append({"ttft_p50_ms_before": _p50_ms([r.ttft_s for r in before]),
                    "tpot_p50_ms_before": _p50_ms([r.tpot_s for r in before]),
                    "ttft_p50_ms_after": _p50_ms([r.ttft_s for r in after]),
                    "tpot_p50_ms_after": _p50_ms([r.tpot_s for r in after])})
    return out


def elastic_phase(all_ops, t: float, smi: str) -> dict:
    """17. Elastic serving through the serving CLI's ``main()``, the
    reference CLI's script from dp 4 (4 -> 3 -> 5 -> 4 at live traffic).
    17a. llama3.2-1b at full width (bf16, seed 0's weights, phase 4's) on
    the paged kernel path: 24 Poisson requests, 8 slots, blocks of 16,
    ``grow_on_join``, 4 ticks a dispatch; first uninterrupted at dp 4, then
    under the script, each counted from 0.  Gates: the trajectory, every
    request retired and prefilled once, every request's tokens those of
    the uninterrupted run, the allocator empty and consistent,
    ``flash_attention`` 16 an admission, ``paged_attention`` 16 a decode
    tick and launched after the grow, ``rmsnorm`` 33 a forward, the grow's
    params equal the source's, and its peak within the resident bytes +
    5 x the largest leaf + 1 GiB.  17b. ``d_iteration`` at n = 32,760, 16
    slots, ``residual_interval`` at eps 1e-10, the same script: the
    trajectory, every request certified with its true residual below eps,
    no kernel launched."""
    from repro_torch.launch import serve

    pa, fa, rn = (next(op for op in all_ops if op.__name__ == n)
                  for n in ("paged_attention", "flash_attention", "rmsnorm"))
    n_layers = 16
    stats: dict = {"gpu": smi}

    # 17a. the uninterrupted run, then the script
    free_device()
    zero(all_ops)
    steady = serve.main(ELASTIC_LLM_ARGV + ["--steps-per-dispatch", "4"])
    steady_counts, ss = counts(all_ops), steady.summary()
    steady_out = {i: r.output for i, r in steady.results.items()}
    del steady
    free_device()
    records: list = []
    zero(all_ops)
    with timed_resizes(records, watch=(pa,)):
        eng = serve.main(ELASTIC_LLM_ARGV + ELASTIC_SCRIPT)
    got = counts(all_ops)
    s, wl = eng.summary(), eng.workload
    traj = [(e.kind, e.old_dp, e.new_dp) for e in eng.resizes]
    same = sorted(eng.results) == sorted(steady_out) and all(
        np.array_equal(r.output, steady_out[i]) for i, r in eng.results.items())
    grow = next(r for r in records if r["grow"])
    bound = grow["resident"] + 5 * grow["largest_leaf"] + 2**30
    after_grow = got["paged_attention"] - grow["launches"]["paged_attention"]
    around = elastic_around(eng, records)
    for rec, ar in zip(records, around):
        rec.update(ar)
        log(f"17a resize {rec['old_dp']} -> {rec['new_dp']} @tick {rec['tick']}: "
            f"{rec['wall_ms']:.3f} ms wall; TTFT p50 {ar['ttft_p50_ms_before']:.2f} -> "
            f"{ar['ttft_p50_ms_after']:.2f} ms, TPOT p50 {ar['tpot_p50_ms_before']:.3f} -> "
            f"{ar['tpot_p50_ms_after']:.3f} ms (retired before / admitted after) [{smi}]")
    log(f"17a grow: params equal the source's {grow['params_equal']}; peak "
        f"{(grow['peak'] - grow['resident']) / 2**30:.3f} GiB above the resident "
        f"{grow['resident'] / 2**30:.3f} GiB (bound {(bound - grow['resident']) / 2**30:.3f} GiB: "
        f"5 x the largest leaf {grow['largest_leaf']} B + 1 GiB)")
    check_s = sum(r["check_ms"] for r in records) / 1e3
    tok_s = s["tokens_out"] / (s["wall_s"] - check_s)
    log(f"17a llama3.2-1b elastic: trajectory {traj}, {s['completed']}/{ELASTIC_REQUESTS} "
        f"retired, {wl.prefills} prefills, {s['decode_ticks']} decode ticks, tokens equal the "
        f"uninterrupted run's {same}; tok/s {tok_s:.1f} without the grow check's "
        f"{check_s:.3f} s of host copies ({s['throughput_tok_s']:.1f} with them) against "
        f"{ss['throughput_tok_s']:.1f} uninterrupted; TTFT p50 {s['ttft_p50_ms']:.2f} / "
        f"{ss['ttft_p50_ms']:.2f} ms, TPOT p50 {s['tpot_p50_ms']:.3f} / {ss['tpot_p50_ms']:.3f} "
        f"ms; paged_attention after the grow {after_grow} [{smi}]")
    expect_launches(got, {"paged_attention": n_layers * s["decode_ticks"],
                          "flash_attention": n_layers * ELASTIC_REQUESTS,
                          "rmsnorm": (2 * n_layers + 1) * (ELASTIC_REQUESTS + s["decode_ticks"])},
                    "17a elastic", torch.device("cuda"))
    if traj != ELASTIC_TRAJECTORY or s["completed"] != ELASTIC_REQUESTS:
        raise SystemExit(f"17a: trajectory {traj}, {s['completed']} retired")
    if wl.prefills != ELASTIC_REQUESTS or not same:
        raise SystemExit(f"17a: {wl.prefills} prefills, tokens equal {same}")
    wl.pool.allocator.check()
    if wl.pool.allocator.used_blocks or not after_grow:
        raise SystemExit(f"17a: {wl.pool.allocator.used_blocks} blocks left in use, "
                         f"{after_grow} paged_attention launches after the grow")
    if not grow["params_equal"] or grow["peak"] > bound:
        raise SystemExit(f"17a: the grow's params equal {grow['params_equal']}, peak "
                         f"{grow['peak']} > {bound}")
    stats["llm"] = {"trajectory": traj, "resizes": records, "launches": got,
                    "steady_launches": steady_counts, "check_s": check_s,
                    "tok_s_without_check": tok_s,
                    **{k: s[k] for k in ("completed", "decode_ticks", "ticks", "tokens_out",
                                         "throughput_tok_s", "ttft_p50_ms", "tpot_p50_ms",
                                         "wall_s")},
                    "steady": {k: ss[k] for k in ("decode_ticks", "ticks", "throughput_tok_s",
                                                  "ttft_p50_ms", "tpot_p50_ms", "wall_s")}}
    del eng, wl
    free_device()
    t = phase("elastic-llm", t)

    # 17b. fixed-point solves under the same script
    records = []
    zero(all_ops)
    args = serve.build_parser().parse_args(ELASTIC_FP_ARGV + ELASTIC_SCRIPT)
    with timed_resizes(records):
        eng, wl, res = serve.serve(args)
    got = counts(all_ops)
    payloads = {r.id: r.payload for r in serve.make_fixedpoint_requests(
        args.requests, args.n, args.gen, args.seed)}
    true_res = fixedpoint_true_residuals(wl, res, payloads)
    traj = [(e.kind, e.old_dp, e.new_dp) for e in eng.resizes]
    st = fixedpoint_run_stats(eng, res)
    log(f"17b d_iteration n {args.n} elastic: trajectory {traj}, {len(res)} requests, converged "
        f"{sum(r.converged for r in res.values())}, true residual up to {true_res.max():.3e} "
        f"(eps {args.eps}), {st['ticks']} ticks, {st['ms_per_tick']:.3f} ms a tick, "
        f"{st['solves_per_s']:.2f} solves/s; resizes "
        + ", ".join(f"{r['old_dp']} -> {r['new_dp']} {r['wall_ms']:.3f} ms" for r in records)
        + f" [{smi}]")
    expect_launches(got, {}, "17b elastic fixed point", torch.device("cuda"))
    if traj != ELASTIC_TRAJECTORY or len(res) != args.requests:
        raise SystemExit(f"17b: trajectory {traj}, {len(res)} retired")
    if not all(r.converged for r in res.values()) or not (true_res < args.eps).all():
        raise SystemExit(f"17b: a request is not certified (true residual {true_res.max():.3e})")
    stats["fixedpoint"] = {"trajectory": traj, "resizes": records, **st,
                           "max_true_residual": float(true_res.max())}
    del eng, wl, res
    free_device()
    phase("elastic-fixedpoint", t)
    stats["launches"] = stats["llm"]["launches"]
    return stats


# 18. the elastic trainer on stacked rows: llama3.2-1b at full width cut to
# 4 layers (one fp32 vector of its params is 2.0 GB: at dp 5 the EF rows take
# 10.1 GB, the ZeRO-1 rows 7.6 GB, the stacked gradient 10.1 GB; all 16
# layers would need ~70 GB before activations), compressed, the reference
# chaos suite's make_tcfg (remat none, the interval monitor at 1e-6, AdamW at
# 5e-3 const), 60 x 64 tokens a step (60 splits over 3, 4 and 5), and its
# headline script from replicas 0-3 (runtime.chaos.kill_join_script): kill 2
# at step 2, join 2 and 4 at 4, kill 1 at 7 (4 -> 3 -> 5 -> 4)
ELASTIC_TRAIN_LAYERS = 4
ELASTIC_TRAIN_STEPS = 10
ELASTIC_TRAIN_BATCH, ELASTIC_TRAIN_SEQ = 60, 64
ELASTIC_TRAIN_TRAJECTORY = [("shrink", 4, 3, 2), ("grow", 3, 5, 4), ("shrink", 5, 4, 7)]


def elastic_train_configs():
    from repro_torch.configs import registry
    from repro_torch.distributed import step as step_lib
    from repro_torch.optim.optimizer import OptimizerConfig

    cfg = registry.override(registry.get_config("llama3.2-1b"), n_layers=ELASTIC_TRAIN_LAYERS)
    tcfg = step_lib.TrainConfig(
        microbatches=1, remat="none", grad_sync="compressed", monitor=True,
        monitor_mode="interval", monitor_threshold=1e-6,
        optimizer=OptimizerConfig(lr=5e-3, schedule="const", warmup_steps=0))
    return cfg, tcfg


def part_digests(state) -> dict:
    """A digest (``train.state_digest``'s sums) of each part of a stacked
    train state: the params, each optimizer row set (master, mu, nu, EF)
    and the monitor's rows."""
    from repro_torch.launch import train

    out = {"params": train.state_digest({"params": state["params"], "opt": {}})}
    for k, v in state["opt"].items():
        out[k] = train.state_digest({"params": {}, "opt": {k: v}})
    mon = state["monitor"]
    out["monitor"] = train.state_digest({"params": {}, "opt": {
        "value": mon["value"], "done": mon["done"], **mon["m"]}})
    return out


def elastic_train_phase(all_ops, t: float, smi: str) -> dict:
    """18. The elastic trainer on stacked rows (``runtime.ElasticTrainer``
    over replica ids 0-3, the ``grow_on_join`` policy), llama3.2-1b at full
    width cut to 4 layers under ``compressed``, the headline script, 10
    steps, counted from 0; then the oracle replay of the recorded resizes
    with the plain combine patched in (phase 3 held the kernel to it bit
    for bit, so the equality holds the kernel on this path too).  Gates:
    the trajectory and its steps, no checkpoint restore, the losses and
    the digests of the params, master/moment rows, EF rows and monitor
    rows equal to the replay's, the joiners' params after the grow equal
    to the source's, ``mrd_combine`` launched once a reducing stage a
    bucket a step at each step's extent (reckoned from the plans) and no
    other kernel, and the grow's peak within the resident bytes + the new
    extent's optimizer rows + 4 x the largest bucket + the broadcast's two
    stacked pieces + 1 GiB."""
    from repro_torch.collectives import executors
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import serve as dserve
    from repro_torch.distributed import step as step_lib
    from repro_torch.kernels.mrd_combine.ref import mrd_combine_ref
    from repro_torch.runtime import ElasticConfig, ElasticTrainer
    from repro_torch.runtime.chaos import kill_join_script, oracle_replay

    free_device()
    dev = torch.device("cuda")
    cfg, tcfg = elastic_train_configs()
    dcfg = DataConfig(batch=ELASTIC_TRAIN_BATCH, seq_len=ELASTIC_TRAIN_SEQ, seed=0)
    tr = ElasticTrainer(tuple(range(4)), (cfg, tcfg), lambda m: SyntheticPipeline(cfg, dcfg, dev),
                        cfg=ElasticConfig(policy="grow_on_join"), device=dev)
    state = tr.init_or_restore(torch.Generator(device=dev).manual_seed(0))
    grows: list = []
    real_resize = ElasticTrainer.resize

    def resize(self, st, decision):
        if decision.action != "grow":
            return real_resize(self, st, decision)
        src = [leaf.clone() for leaf in _leaves(st["params"])]  # rank 0's, the source's
        new_dp = self.dp() + len(decision.admit)
        layout, p0 = step_lib.zero1_layout(st["params"], new_dp,
                                           bucket_bytes=tcfg.bucket_bytes)
        rows = 3 * new_dp * (layout.total_padded // p0) + new_dp * layout.total_padded
        largest = max(layout.bucket_lengths)
        torch.cuda.synchronize()
        rec = {"resident": torch.cuda.memory_allocated(), "new_rows_bytes": 4 * rows,
               "largest_bucket_bytes": 4 * largest}
        rec["bound"] = (rec["resident"] + rec["new_rows_bytes"] + 4 * rec["largest_bucket_bytes"]
                        + 2 * new_dp * dserve.BROADCAST_CHUNK * 2 + 2**30)
        torch.cuda.reset_peak_memory_stats()
        out = real_resize(self, st, decision)
        torch.cuda.synchronize()
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["params_equal"] = all(torch.equal(a, b) for a, b in zip(src, _leaves(out["params"])))
        del src
        grows.append(rec)
        return out

    script, losses, ms, dps = kill_join_script(), [], [], []
    zero(all_ops)
    with mock.patch.object(ElasticTrainer, "resize", resize):
        for _ in range(ELASTIC_TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, got = tr.run(state, 1, events=script)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses += got
            dps.append(tr.dp())
    got = counts(all_ops)
    traj = [(e.kind, e.old_dp, e.new_dp, e.step) for e in tr.resizes]
    want = sum(combine_launches_expected(state["params"], dp, "compressed", 1) for dp in dps)
    digests = part_digests(state)
    resize_steps = {e.step for e in tr.resizes}
    by_dp: dict = {}
    for i, (dp, m) in enumerate(zip(dps, ms)):
        if i and i not in resize_steps:  # the first step's and a resize step's time aside
            by_dp.setdefault(dp, []).append(m)
    steady = [m for v in by_dp.values() for m in v]
    tok_s = ELASTIC_TRAIN_BATCH * ELASTIC_TRAIN_SEQ / (sum(steady) / len(steady)) * 1e3
    grow = grows[0]
    log(f"18 elastic trainer, llama3.2-1b at {ELASTIC_TRAIN_LAYERS} layers, compressed: "
        f"trajectory {traj}, restores {tr.restores}, losses {losses} [{smi}]")
    log(f"18 ms a step at dp {dps}: {[round(m, 1) for m in ms]}; steady ms a step by extent "
        + ", ".join(f"dp {dp}: {[round(m, 1) for m in v]}" for dp, v in sorted(by_dp.items()))
        + f"; tokens/s {tok_s:.1f}")
    for r in tr.resize_times:
        log(f"18 resize {r['kind']} {r['old_dp']} -> {r['new_dp']} at step {r['step']}: "
            f"migrate {r['migrate_s'] * 1e3:.1f} ms, broadcast {r['broadcast_s'] * 1e3:.1f} ms, "
            f"wall {r['wall_s'] * 1e3:.1f} ms")
    log(f"18 grow: params equal the source's {grow['params_equal']}; peak "
        f"{(grow['peak'] - grow['resident']) / 2**30:.3f} GiB above the resident "
        f"{grow['resident'] / 2**30:.3f} GiB (bound {(grow['bound'] - grow['resident']) / 2**30:.3f}"
        f" GiB: the new rows {grow['new_rows_bytes'] / 2**30:.3f} GiB + 4 x the largest bucket "
        f"{grow['largest_bucket_bytes']} B + the broadcast's pieces + 1 GiB)")
    log(f"18 mrd_combine {got['mrd_combine']} (reckoned from the plans: {want}); launches {got}")
    expect_launches(got, {"mrd_combine": want}, "18 elastic trainer", dev)
    if traj != ELASTIC_TRAIN_TRAJECTORY or tr.restores or len(losses) != ELASTIC_TRAIN_STEPS:
        raise SystemExit(f"18: trajectory {traj}, restores {tr.restores}, {len(losses)} losses")
    if not grow["params_equal"] or grow["peak"] > grow["bound"] or not want:
        raise SystemExit(f"18: the grow's params equal {grow['params_equal']}, peak "
                         f"{grow['peak']} > {grow['bound']}, {want} launches reckoned")
    resizes, resize_times = list(tr.resizes), list(tr.resize_times)
    del state, tr
    free_device()
    t = phase("elastic-train", t)

    # the oracle replay, the plain combine in the kernel's place
    def plain(x, q, s):
        return mrd_combine_ref(x, q, s)

    zero(all_ops)
    with mock.patch.object(executors, "mrd_combine", plain):
        r_state, r_losses = oracle_replay(cfg, tcfg, dcfg, range(4), resizes,
                                          ELASTIC_TRAIN_STEPS, device=dev)
    r_digests = part_digests(r_state)
    del r_state
    free_device()
    same = {k: digests[k] == r_digests.get(k) for k in digests}
    log(f"18 oracle replay (rule: the plain combine, phase 3 held the kernel to it bit for bit): "
        f"losses equal {r_losses == losses}, digests equal {same}; its launches {counts(all_ops)}")
    if r_losses != losses or not all(same.values()) or any(counts(all_ops).values()):
        raise SystemExit(f"18: the replay differs: losses {r_losses} against {losses}, {same}")
    phase("elastic-train-replay", t)
    return {"trajectory": traj, "restores": 0, "losses": losses, "ms_per_step": ms, "dps": dps,
            "steady_ms_by_dp": {str(k): v for k, v in by_dp.items()}, "tokens_per_s": tok_s,
            "resize_times": resize_times, "grow": grow,
            "digests_equal": same, "combine_reckoned": want, "launches": got, "gpu": smi}


def reshard_phase(all_ops, t: float, smi: str) -> dict:
    """18b. ``gspmd.reshard_blocks`` at llama3.2-1b's full width on the card:
    every leaf of the params and of the AdamW trees (fp32 masters of the
    params, random first and second moments) cut into its 4 FSDP blocks
    (``sharding.local_shard`` under the specs at dp 4), re-sharded to dp 3,
    then from those to dp 5, each set of new blocks equal bit for bit to
    the global leaf cut directly at that extent.  A leaf at a time (its
    four trees), so the phase holds one leaf's copies beside the params;
    the re-shards are timed on the card's clock (synchronized), the peak
    read over the phase; no kernel may launch (counted from 0)."""
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.gradsync import gspmd
    from repro_torch.models import transformer

    free_device()
    zero(all_ops)
    dev = torch.device("cuda")
    cfg = registry.get_config("llama3.2-1b")
    shapes = transformer.param_shapes(cfg)
    specs = {dp: shd.param_specs(cfg, shd.make_rules(cfg, {shd.DATA: dp}), shapes)
             for dp in (4, 3, 5)}
    gen = torch.Generator(device=dev).manual_seed(11)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = transformer.init_params(cfg, gen, dev)
    keys = [k for k, _ in _flat_items(params)]
    times = {"4->3": 0.0, "3->5": 0.0}
    moved = {"4->3": 0, "3->5": 0}
    sharded = {dp: 0 for dp in specs}
    bad = []
    for key in keys:
        leaf = _at(params, key)
        trees = {"params": leaf, "master": leaf.float(),
                 "mu": torch.randn(leaf.shape, generator=gen, device=dev),
                 "nu": torch.rand(leaf.shape, generator=gen, device=dev)}
        sp = {dp: _at(specs[dp], key) for dp in specs}
        for dp in specs:
            sharded[dp] += gspmd.data_sharded(sp[dp])
        for name, whole in trees.items():
            blocks = [shd.local_shard(whole, sp[4], {shd.DATA: d}, {shd.DATA: 4}).clone()
                      for d in range(4)]
            for (a, b), label in (((4, 3), "4->3"), ((3, 5), "3->5")):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                blocks = gspmd.reshard_blocks(blocks, (sp[a], sp[b]), b)
                torch.cuda.synchronize()
                times[label] += time.perf_counter() - t1
                moved[label] += sum(x.numel() * x.element_size() for x in blocks)
                want = [shd.local_shard(whole, sp[b], {shd.DATA: d}, {shd.DATA: b})
                        for d in range(b)]
                if not all(torch.equal(x, y) for x, y in zip(blocks, want)):
                    bad.append((key, name, label))
            del blocks
        del trees
    peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(x.numel() for _, x in _flat_items(params))
    del params
    free_device()
    stats = {"leaves": len(keys), "params": n_params, "data_sharded_leaves": sharded,
             "reshard_s": times, "bytes_written": moved, "peak_bytes": peak,
             "equal": not bad, "gpu": smi}
    log(f"18b reshard_blocks, llama3.2-1b full width ({n_params} params, {len(keys)} leaves x "
        f"params + master/mu/nu): 4 -> 3 in {times['4->3'] * 1e3:.1f} ms "
        f"({moved['4->3'] / 2**30:.3f} GiB of new blocks), 3 -> 5 in "
        f"{times['3->5'] * 1e3:.1f} ms ({moved['3->5'] / 2**30:.3f} GiB); leaves sharded over "
        f"data at dp 4/3/5: {sharded[4]}/{sharded[3]}/{sharded[5]}; peak "
        f"{peak / 2**30:.3f} GiB above the start; equal to the direct cut {not bad} [{smi}]")
    if bad:
        raise SystemExit(f"18b: re-sharded blocks differ from the direct cut: {bad[:8]}")
    expect_launches(counts(all_ops), {}, "18b reshard_blocks", dev)
    phase("reshard-blocks", t)
    return stats


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _at(tree, key: str):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def elastic_world_phase(t: float, worlds: dict, smi: str) -> dict:
    """18c. The one-rank world's elastic ``gspmd`` trainer with a
    checkpointer (:data:`WORLD_RUNNER`): ``ELASTIC_CK_SAVE_AT`` steps and a
    save, a fresh trainer's ``recover`` and the rest of the steps, against
    the uninterrupted run.  Gates: the losses equal bit for bit, the
    resumed trainer at the saved step, no ``mrd_combine`` launch (gspmd
    runs no MRD plan)."""
    el = worlds["tp"]["elastic"]
    got = el["first"] + el["rest"]
    same = got == el["full"] and el["resumed_at"] == ELASTIC_CK_SAVE_AT
    save = el["save"]
    log(f"18c elastic gspmd one-rank world, llama3.2-1b at {ELASTIC_CK_LAYERS} layers: "
        f"uninterrupted losses {el['full']}, saved at step {ELASTIC_CK_SAVE_AT} and recovered "
        f"{el['first']} + {el['rest']}: equal {same}; save {save['bytes'] / 2**30:.3f} GiB in "
        f"{save['write_s']:.2f} s (largest leaf held {save['peak_bytes'] / 2**20:.1f} MiB), "
        f"restore {el['restore_bytes'] / 2**30:.3f} GiB in {el['restore_s']:.2f} s, peak "
        f"{el['peak_bytes'] / 2**30:.3f} GiB, launches {el['launches']} [{smi}]")
    if not same or el["launches"]["mrd_combine"]:
        raise SystemExit(f"18c: the recovered run differs or mrd_combine ran: {el}")
    phase("elastic-gspmd-world-checkpoint", t)
    return el


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} cards visible, needs one", file=sys.stderr)
        return 2
    from repro_torch.collectives import plans
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import serve as dserve
    from repro_torch.distributed import step as step_lib
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref, visible_mask
    from repro_torch.kernels.mrd_combine import ops as mc_ops
    from repro_torch.kernels.mrd_combine.ref import mrd_combine_ref
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_fused_ref,
        selective_scan_ref,
    )
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.models.attention import attention
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.serving import PagedDecodePool, ServeConfig, ServeEngine, make_workload

    t0 = time.perf_counter()
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    log(f"largest SM clock {max_sm_mhz:.0f} MHz")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = phase("device", t0)
    all_ops = (ops.paged_attention, mc_ops.mrd_combine, fa_ops.flash_attention, rn_ops.rmsnorm,
               ss_ops.selective_scan)

    # 2. build: one nvcc per source, all started together; phases 7 and 8,
    # which launch none of the port's kernels, run on the card meanwhile
    building = start_build()
    async_stats = async_phases(all_ops, t)
    fixedpoint_stats = fixedpoint_phases(all_ops, time.perf_counter())
    t = time.perf_counter()
    finish_build(*building, t)
    t = phase("build", t)

    # 3. kernel vs plain on the card
    errs = {}
    check_paged(KERNEL_CASES, errs)
    for n in COMBINE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, q, sc = combine_inputs(n, dtype, seed=n % 1000)
            out = mc_ops.mrd_combine(x, q, sc)
            ref = mrd_combine_ref(x, q, sc)
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != ref.shape:
                raise SystemExit(f"mrd_combine output {out.dtype} {tuple(out.shape)} is wrong")
            err = (out.float() - ref.float()).abs().max().item()
            errs[(n, dtype)] = err
            log(f"  mrd_combine vs plain n={n} {str(dtype)[6:]}: max abs err {err:.3e}, "
                f"bit for bit {torch.equal(out, ref)}")
            if not torch.equal(out, ref):
                raise SystemExit(f"mrd_combine kernel differs from its plain version: {err}")
            del x, q, sc, out, ref
    check_flash(FLASH_CASES, errs)
    check_rmsnorm(RMSNORM_CASES, errs)
    for form, cases in (("materialized", SCAN_CASES), ("fused", FUSED_SCAN_CASES)):
        for case in cases:
            for dtype in (torch.float32, torch.bfloat16):
                kept = True
                if form == "fused":  # from a nonzero state, in place, as a decode tick calls
                    # it: odd batches have write_ok False and must keep their state
                    args = fused_scan_inputs(*case, dtype, seed=case[1] + 1)
                    h0, ok = args[5], torch.arange(case[0], device="cuda") % 2 == 0
                    state = h0.clone()
                    y, h = ss_ops.selective_scan_fused(*args[:5], h0=state, h_final=state,
                                                       write_ok=ok)
                    ry, rh = selective_scan_fused_ref(*args[:5], h0=h0)
                    torch.cuda.synchronize()
                    kept = h is state and torch.equal(state[~ok], h0[~ok])
                    h, rh = h[ok], rh[ok]
                else:
                    args = scan_inputs(*case, dtype, seed=case[1])
                    (y, h), (ry, rh) = (fn(*args) for fn in (
                        ss_ops.selective_scan, selective_scan_ref))
                torch.cuda.synchronize()
                (ey, oy), (eh, oh) = scan_err(y, ry), scan_err(h, rh)
                errs[(form, case, dtype)] = max(ey, eh)
                log(f"  selective_scan ({form}) vs plain B,S,D,N={case} {str(dtype)[6:]} "
                    f"inputs: y max abs err {ey:.3e}, h_final {eh:.3e}; elements outside "
                    f"1e-5 + 1e-4 |plain|: {oy} and {oh}; write_ok-False rows kept: {kept}")
                if oy or oh or not kept or y.shape != ry.shape or h.shape != rh.shape:
                    raise SystemExit(f"selective_scan kernel disagrees with its plain version "
                                     f"({form}, {case}, {dtype})")
                del args, y, h, ry, rh
    torch.cuda.empty_cache()
    t = phase("kernel-vs-plain", t)

    # 4. the serving path at full width, counted (after a short warm-up run
    # that initializes the GEMM libraries, so the figures are steady state)
    serve.main(SERVE_ARGV + ["--requests", "2", "--gen", "4", "--device", "cuda"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for op in all_ops:
        op.launches = 0
    eng = serve.main(SERVE_ARGV + ["--device", "cuda"])
    launches = ops.paged_attention.launches
    llama_fa, llama_rn = fa_ops.flash_attention.launches, rn_ops.rmsnorm.launches
    if mc_ops.mrd_combine.launches or ss_ops.selective_scan.launches:
        raise SystemExit("the llama serving path launched mrd_combine or selective_scan")
    s = eng.summary()
    n_layers = registry.get_config("llama3.2-1b").n_layers
    admissions = eng.workload.prefills
    log(f"served {s['completed']}/16 requests, {s['decode_ticks']} decode ticks, "
        f"kernel launches {launches} (= {s['decode_ticks']} x {n_layers} layers expected)")
    log(f"  flash_attention launches {llama_fa} (= {n_layers} layers x {admissions} admissions "
        f"expected) | rmsnorm launches {llama_rn} (= {2 * n_layers + 1} x "
        f"{admissions + s['decode_ticks']} forwards expected)")
    log(f"  tok/s {s['throughput_tok_s']:.1f} | TTFT p50 {s['ttft_p50_ms']:.2f} ms | "
        f"TPOT p50 {s['tpot_p50_ms']:.3f} ms | peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if s["completed"] != 16 or s["forced_at_capacity"]:
        raise SystemExit(f"not every request retired naturally: {s}")
    if launches != s["decode_ticks"] * n_layers or launches == 0:
        raise SystemExit(f"kernel launches {launches} != decode ticks x layers")
    if llama_fa != n_layers * admissions or not llama_fa:
        raise SystemExit(f"flash_attention launches {llama_fa} != layers x admissions")
    if llama_rn != (2 * n_layers + 1) * (admissions + s["decode_ticks"]):
        raise SystemExit(f"rmsnorm launches {llama_rn} != 33 x forwards")
    vocab = registry.get_config("llama3.2-1b").vocab
    for r in eng.results.values():
        if not (1 <= r.n_tokens and ((r.output >= 0) & (r.output < vocab)).all()):
            raise SystemExit(f"request {r.id}: bad output {r.output}")
    serve_stats = dict(s)
    t = phase("serve-full-width", t)

    # 4b. where a steady decode tick's time goes (8 busy slots, bf16)
    wall_ms, busy_ms, per_tick, _ = profile_decode(
        eng.workload, serve.make_requests(eng.workload.cfg, 8, 64, 32, seed=1))
    log(f"steady decode tick, 8 slots: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (ms_tick, n_tick) in top_kernels(per_tick):
        log(f"  {ms_tick * 1e3:9.2f} us/tick {n_tick:6.1f} launches/tick  {name[:110]}")
    pa = [v for k, v in per_tick.items() if "paged_attention_kernel" in k]
    if not pa:
        raise SystemExit("the profiled decode ticks launched no paged_attention kernel")
    log(f"  paged_attention in steady decode: {pa[0][0] / pa[0][1] * 1e3:.2f} us a launch, "
        f"{pa[0][1]:.0f} launches/tick, {pa[0][0] / busy_ms:.3f} of device busy time")
    del eng
    torch.cuda.empty_cache()
    t = phase("profile-decode", t)

    # 4c. the training path at full width, counted (after a 1-step warm-up
    # run that initializes the GEMM libraries)
    train.main(TRAIN_ARGV + ["--steps", "1"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for op in all_ops:
        op.launches = 0
    rec = train.main(TRAIN_ARGV)
    train_launches = mc_ops.mrd_combine.launches
    # under autograd the forward takes the plain attention and rmsnorm
    # (neither kernel has a backward)
    if (ops.paged_attention.launches or fa_ops.flash_attention.launches
            or rn_ops.rmsnorm.launches or ss_ops.selective_scan.launches):
        raise SystemExit("the training path launched a serving kernel")
    targs = train.build_parser().parse_args(TRAIN_ARGV)
    layout, _ = step_lib.zero1_layout(rec["state"]["params"], targs.dp)
    stages = [st for st, *_ in plans.reduce_scatter_plan(p=targs.dp).bound_stage_table()
              if st.kind in ("bshift", "rs")]
    expect = len(rec["losses"]) * len(stages) * len(layout.buckets)
    log(f"trained {len(rec['losses'])} steps, losses {rec['losses']}, grad norms "
        f"{rec['grad_norms']}")
    log(f"  mrd_combine launches {train_launches} (= {len(rec['losses'])} steps x "
        f"{len(stages)} reducing stages x {len(layout.buckets)} buckets = {expect} expected)")
    log(f"  ms/step {[round(m, 3) for m in rec['ms_per_step']]} | tokens/s (steps 2-4) "
        f"{rec['tokens_per_s']:.1f} | peak device memory {rec['peak_bytes'] / 2**30:.3f} GiB")
    if len(rec["losses"]) != targs.steps or not all(np.isfinite(rec["losses"] + rec["grad_norms"])):
        raise SystemExit(f"training did not finish every step with finite values: {rec}")
    if train_launches != expect or train_launches == 0:
        raise SystemExit(f"mrd_combine launches {train_launches} != {expect}")
    train_stats = {k: rec[k] for k in ("losses", "grad_norms", "ms_per_step", "tokens_per_s")}
    train_stats["peak_gib"] = rec["peak_bytes"] / 2**30
    t = phase("train-full-width", t)

    # 4d. where a train step's time goes (one step after the counted run)
    _, _, train_step, pipe = train.make(targs)
    state = {"s": rec.pop("state")}
    batch = pipe.next_batch()

    def one_step():
        state["s"], m = train_step(state["s"], batch)
        return m

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    float(one_step()["loss"])
    step_wall_ms = (time.perf_counter() - t1) * 1e3
    step_busy_ms, per_step, _ = device_profile(one_step, 1)
    log(f"train step (6 x 1024 tokens, dp 3, compressed): wall {step_wall_ms:.1f} ms, device "
        f"busy {step_busy_ms:.1f} ms, device idle share {1 - step_busy_ms / step_wall_ms:.3f}")
    for name, (ms_s, n_s) in top_kernels(per_step, 12):
        log(f"  {ms_s:10.3f} ms/step {n_s:6.0f} launches/step  {name[:110]}")
    classes = kernel_classes(per_step, step_busy_ms)
    mc = [v for k, v in per_step.items() if "mrd_combine_kernel" in k]
    if not mc:
        raise SystemExit("the profiled train step launched no mrd_combine kernel")
    log(f"  mrd_combine in a train step: {mc[0][0]:.3f} ms over {mc[0][1]:.0f} launches, "
        f"{mc[0][0] / step_busy_ms:.4f} of device busy time")
    train_stats.update(step_wall_ms=step_wall_ms, step_busy_ms=step_busy_ms,
                       idle_share=1 - step_busy_ms / step_wall_ms, busy_ms_by_class=classes)
    del state, train_step, pipe, batch, rec, layout
    torch.cuda.empty_cache()
    t = phase("profile-train", t)

    # 4e. gemma3-12b served at full width through the contiguous pool (after
    # a short warm-up run that initializes the GEMM libraries)
    left = torch.cuda.memory_allocated() / 2**30
    log(f"device memory allocated before gemma3: {left:.3f} GiB")
    if left > 1.0:
        raise SystemExit(f"{left:.3f} GiB still allocated after the llama paths")
    serve.main(GEMMA_SERVE_ARGV + ["--requests", "2", "--min-prompt-len", "16",
                                   "--prompt-len", "64", "--gen", "4"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for op in all_ops:
        op.launches = 0
    geng = serve.main(GEMMA_SERVE_ARGV)
    fa_launches, rn_launches = fa_ops.flash_attention.launches, rn_ops.rmsnorm.launches
    if ops.paged_attention.launches or mc_ops.mrd_combine.launches or ss_ops.selective_scan.launches:
        raise SystemExit("gemma3 serving launched paged_attention, mrd_combine or selective_scan")
    gs, gwl = geng.summary(), geng.workload
    gcfg = gwl.cfg
    n_fwd = gwl.prefills + gs["decode_ticks"]
    log(f"gemma3-12b served {gs['completed']}/8 requests ({gwl.prefills} admissions, prompts "
        f"{sorted(len(r.prompt) for r in serve.make_requests(gcfg, 8, 8192, 32, 0, 1024))}), "
        f"{gs['decode_ticks']} decode ticks")
    log(f"  flash_attention launches {fa_launches} (= {gcfg.n_layers} layers x "
        f"{gwl.prefills} admissions expected) | rmsnorm launches {rn_launches} (= "
        f"{2 * gcfg.n_layers + 1} x {n_fwd} forwards expected)")
    log(f"  tok/s {gs['throughput_tok_s']:.1f} | TTFT p50 {gs['ttft_p50_ms']:.2f} ms | "
        f"TPOT p50 {gs['tpot_p50_ms']:.3f} ms | cache {gwl.cache_bytes / 2**30:.3f} GiB | "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if gs["completed"] != 8 or gs["forced_at_capacity"]:
        raise SystemExit(f"not every gemma3 request retired naturally: {gs}")
    if fa_launches != gcfg.n_layers * gwl.prefills or not fa_launches:
        raise SystemExit(f"flash_attention launches {fa_launches} != layers x admissions")
    if rn_launches != (2 * gcfg.n_layers + 1) * n_fwd:
        raise SystemExit(f"rmsnorm launches {rn_launches} != 97 x forwards")
    for r in geng.results.values():
        if not (1 <= r.n_tokens and ((r.output >= 0) & (r.output < gcfg.vocab)).all()):
            raise SystemExit(f"gemma3 request {r.id}: bad output {r.output}")
    gemma_stats = {k: gs[k] for k in ("completed", "decode_ticks", "tokens_out",
                                      "throughput_tok_s", "ttft_p50_ms", "tpot_p50_ms", "wall_s")}
    gemma_stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t = phase("gemma3-serve-full-width", t)

    wall_ms, busy_ms, per_tick, _ = profile_decode(
        gwl, serve.make_requests(gcfg, 4, 8192, 32, seed=1, min_prompt_len=1024))
    log(f"gemma3 steady decode tick, 4 slots: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (ms_tick, n_tick) in top_kernels(per_tick):
        log(f"  {ms_tick * 1e3:9.2f} us/tick {n_tick:6.1f} launches/tick  {name[:110]}")
    kernel_classes(per_tick, busy_ms)
    gemma_stats.update(tick_wall_ms=wall_ms, tick_busy_ms=busy_ms)
    t = phase("gemma3-profile-decode", t)

    # 4f. the whole-prompt prefill at 32k tokens, batch 1 (the reference's
    # prefill_32k cell has a global batch of 32: cut to 1 for one card)
    params = gwl.params
    prefill = dserve.make_prefill_step(gcfg)
    tokens = torch.randint(0, gcfg.vocab, (1, PREFILL_LEN), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(7))
    prefill(params, {"tokens": tokens[:, :2048]})  # warm-up
    del geng, gwl
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = rn_ops.rmsnorm.launches = 0
    t1 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    pf_wall = time.perf_counter() - t1
    pf_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"prefill of {PREFILL_LEN} tokens, batch 1 (reference prefill_32k: batch 32, cut to 1 "
        f"for one card): {pf_wall * 1e3:.1f} ms wall, {PREFILL_LEN / pf_wall:.1f} tokens/s, peak "
        f"device memory {pf_peak:.3f} GiB; flash_attention launches "
        f"{fa_ops.flash_attention.launches}, rmsnorm launches {rn_ops.rmsnorm.launches}")
    if not (logits.shape == (1, gcfg.vocab) and torch.isfinite(logits).all()):
        raise SystemExit(f"32k prefill logits {tuple(logits.shape)} are not finite")
    if (fa_ops.flash_attention.launches, rn_ops.rmsnorm.launches) != (
            gcfg.n_layers, 2 * gcfg.n_layers + 1):
        raise SystemExit("the 32k prefill did not run every layer through both kernels")
    pf_busy, per_pf, _ = device_profile(lambda: prefill(params, {"tokens": tokens}), 1)
    log(f"  profiled prefill: device busy {pf_busy:.1f} ms ({pf_busy / (pf_wall * 1e3):.3f} of "
        f"the unprofiled wall time)")
    for name, (ms_p, n_p) in top_kernels(per_pf, 10):
        log(f"  {ms_p:10.3f} ms {n_p:6.0f} launches  {name[:110]}")
    pf_classes = kernel_classes(per_pf, pf_busy)
    prefill_stats = {"tokens": PREFILL_LEN, "wall_ms": pf_wall * 1e3,
                     "tokens_per_s": PREFILL_LEN / pf_wall, "peak_gib": pf_peak,
                     "busy_ms": pf_busy, "busy_ms_by_class": pf_classes}
    t = phase("gemma3-prefill-32k", t)

    # 5-gemma. one full-width prefill of 8192 tokens through the flash
    # kernel against flash_scan (plain torch on the card).  In bf16, the
    # served type, the argmax must agree, and the last logits of every pair
    # of implementations (materialized "full" as a third) are printed: each
    # rounds to bf16 at other places, and 48 layers carry the rounding into
    # the logits.  In fp32 (the same draw of weights, not rounded) the two
    # must agree within 5e-2.
    tok8 = {"tokens": tokens[:, :8192]}
    out = {impl: dserve.make_prefill_step(registry.override(gcfg, attn_impl=impl))(params, tok8)
           for impl in ("kernel", "flash_scan", "full")}
    pairs = [("kernel", "flash_scan"), ("kernel", "full"), ("flash_scan", "full")]
    spread = {f"{a} vs {b}": (out[a] - out[b]).abs().max().item() for a, b in pairs}
    same = bool((out["kernel"].argmax(-1) == out["flash_scan"].argmax(-1)).all())
    # the kernel may differ from each plain version by at most twice what
    # the two plain versions differ by from each other
    near = max(spread["kernel vs flash_scan"], spread["kernel vs full"]) <= (
        2 * spread["flash_scan vs full"])
    log(f"gemma3-12b prefill of 8192 tokens, bf16: last logits max abs diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in spread.items())
        + f" (kernel's at most 2 x flash_scan vs full: {near}); kernel and flash_scan argmax "
        f"equal {same}; logits max abs {out['flash_scan'].abs().max().item():.3f}")
    if not (same and near):
        raise SystemExit("gemma3 bf16 prefill: the flash kernel strays from the plain versions")
    del params, prefill, logits, out
    torch.cuda.empty_cache()
    cfg32 = registry.override(gcfg, param_dtype="float32", compute_dtype="float32")
    p32 = transformer.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    out = {impl: dserve.make_prefill_step(registry.override(cfg32, attn_impl=impl))(p32, tok8)
           for impl in ("kernel", "flash_scan")}
    diff = (out["kernel"] - out["flash_scan"]).abs().max().item()
    same = bool((out["kernel"].argmax(-1) == out["flash_scan"].argmax(-1)).all())
    log(f"gemma3-12b prefill of 8192 tokens, fp32: flash kernel vs flash_scan last logits max "
        f"abs diff {diff:.3e} (atol 5e-2), argmax equal {same}")
    if not (diff <= 5e-2 and same):
        raise SystemExit("gemma3 fp32 prefill through the flash kernel disagrees with flash_scan")
    gemma_stats["prefill_8192_bf16_spread"] = spread
    gemma_stats["prefill_8192_fp32_diff"] = diff
    del p32, out, tokens, tok8
    torch.cuda.empty_cache()
    log(f"device memory allocated after gemma3: {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    t = phase("gemma3-prefill-vs-flash-scan", t)

    # 4g. falcon-mamba-7b served at full width through the contiguous pool
    # (after a short warm-up run that initializes the GEMM libraries)
    left = torch.cuda.memory_allocated() / 2**30
    if left > 1.0:
        raise SystemExit(f"{left:.3f} GiB still allocated before falcon-mamba")
    serve.main(FALCON_SERVE_ARGV + ["--requests", "2", "--min-prompt-len", "16",
                                    "--prompt-len", "64", "--gen", "4"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for op in all_ops:
        op.launches = 0
    feng = serve.main(FALCON_SERVE_ARGV)
    ss_launches, f_rn_launches = ss_ops.selective_scan.launches, rn_ops.rmsnorm.launches
    stray = {op.__name__: op.launches for op in (ops.paged_attention, fa_ops.flash_attention,
                                                  mc_ops.mrd_combine) if op.launches}
    fs, fwl = feng.summary(), feng.workload
    fcfg = fwl.cfg
    n_fwd = fwl.prefills + fs["decode_ticks"]
    log(f"falcon-mamba-7b served {fs['completed']}/16 requests ({fwl.prefills} admissions, "
        f"prompts {sorted(len(r.prompt) for r in serve.make_requests(fcfg, 16, 8192, 64, 0, 1024))}"
        f"), {fs['decode_ticks']} decode ticks")
    log(f"  selective_scan launches {ss_launches} (= {fcfg.n_layers} layers x {n_fwd} forwards "
        f"expected) | rmsnorm launches {f_rn_launches} (= {fcfg.n_layers + 1} x {n_fwd} "
        f"expected) | other kernels {stray or 'none'}")
    log(f"  tok/s {fs['throughput_tok_s']:.1f} | TTFT p50 {fs['ttft_p50_ms']:.2f} ms | "
        f"TPOT p50 {fs['tpot_p50_ms']:.3f} ms | state {fwl.cache_bytes / 2**30:.3f} GiB | "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if fs["completed"] != 16 or fs["forced_at_capacity"]:
        raise SystemExit(f"not every falcon-mamba request retired naturally: {fs}")
    if ss_launches != fcfg.n_layers * n_fwd or not ss_launches:
        raise SystemExit(f"selective_scan launches {ss_launches} != layers x forwards")
    if f_rn_launches != (fcfg.n_layers + 1) * n_fwd:
        raise SystemExit(f"rmsnorm launches {f_rn_launches} != 65 x forwards")
    if stray:
        raise SystemExit(f"falcon-mamba serving launched {stray}")
    for r in feng.results.values():
        if not (1 <= r.n_tokens and ((r.output >= 0) & (r.output < fcfg.vocab)).all()):
            raise SystemExit(f"falcon-mamba request {r.id}: bad output {r.output}")
    falcon_stats = {k: fs[k] for k in ("completed", "decode_ticks", "tokens_out",
                                       "throughput_tok_s", "ttft_p50_ms", "tpot_p50_ms",
                                       "wall_s")}
    falcon_stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t = phase("falcon-serve-full-width", t)

    wall_ms, busy_ms, per_tick, _ = profile_decode(
        fwl, serve.make_requests(fcfg, 8, 8192, 64, seed=1, min_prompt_len=1024))
    log(f"falcon-mamba steady decode tick, 8 slots: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (ms_tick, n_tick) in top_kernels(per_tick):
        log(f"  {ms_tick * 1e3:9.2f} us/tick {n_tick:6.1f} launches/tick  {name[:110]}")
    tick_classes = kernel_classes(per_tick, busy_ms)
    falcon_stats.update(tick_wall_ms=wall_ms, tick_busy_ms=busy_ms,
                        tick_idle_share=1 - busy_ms / wall_ms, tick_busy_ms_by_class=tick_classes)
    t = phase("falcon-profile-decode", t)

    # 4h. its whole-prompt prefill at 32k tokens, batch 1 (the reference's
    # prefill_32k, falcon-mamba among its long-context archs; batch 32 cut
    # to 1 for one card, as for gemma3)
    params = fwl.params
    prefill = dserve.make_prefill_step(fcfg)
    tokens = torch.randint(0, fcfg.vocab, (1, PREFILL_LEN), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(7))
    prefill(params, {"tokens": tokens[:, :2048]})  # warm-up
    del feng, fwl
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for op in all_ops:
        op.launches = 0
    t1 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    pf_wall = time.perf_counter() - t1
    pf_peak = torch.cuda.max_memory_allocated() / 2**30
    counts = tuple(op.launches for op in all_ops)
    log(f"falcon-mamba prefill of {PREFILL_LEN} tokens, batch 1: {pf_wall * 1e3:.1f} ms wall, "
        f"{PREFILL_LEN / pf_wall:.1f} tokens/s, peak device memory {pf_peak:.3f} GiB; "
        f"selective_scan launches {ss_ops.selective_scan.launches}, rmsnorm launches "
        f"{rn_ops.rmsnorm.launches}")
    if not (logits.shape == (1, fcfg.vocab) and torch.isfinite(logits).all()):
        raise SystemExit(f"falcon-mamba 32k prefill logits {tuple(logits.shape)} are not finite")
    if counts != (0, 0, 0, fcfg.n_layers + 1, fcfg.n_layers):
        raise SystemExit(f"the falcon-mamba 32k prefill's launches {counts} != 65 rmsnorm and "
                         "64 selective_scan")
    pf_busy, per_pf, _ = device_profile(lambda: prefill(params, {"tokens": tokens}), 1)
    log(f"  profiled prefill: device busy {pf_busy:.1f} ms ({pf_busy / (pf_wall * 1e3):.3f} of "
        f"the unprofiled wall time)")
    for name, (ms_p, n_p) in top_kernels(per_pf, 10):
        log(f"  {ms_p:10.3f} ms {n_p:6.0f} launches  {name[:110]}")
    falcon_prefill_stats = {"tokens": PREFILL_LEN, "wall_ms": pf_wall * 1e3,
                            "tokens_per_s": PREFILL_LEN / pf_wall, "peak_gib": pf_peak,
                            "busy_ms": pf_busy,
                            "busy_ms_by_class": kernel_classes(per_pf, pf_busy)}
    del params, prefill, logits, tokens
    torch.cuda.empty_cache()
    log(f"device memory allocated after falcon-mamba: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    t = phase("falcon-prefill-32k", t)

    # 5a. fp32 full width: kernel path vs gather path on the same state
    cfg32 = registry.override(registry.get_config("llama3.2-1b"),
                              param_dtype="float32", compute_dtype="float32")
    params = transformer.init_params(cfg32, torch.Generator(device="cuda").manual_seed(1), "cuda")
    pool = PagedDecodePool(cfg32, slots=8, max_len=112, max_prompt_len=64, block_size=16,
                           attn="kernel", device="cuda")
    rng = np.random.default_rng(2)
    for slot in range(8):
        plen = int(rng.integers(1, 65))
        pool.admit(params, rng.integers(0, cfg32.vocab, size=plen), slot, max_new=32)
    lengths = torch.from_numpy(pool.lengths).cuda()
    active = torch.ones(8, dtype=torch.bool, device="cuda")
    logits = {}
    for attn in ("kernel", "gather"):
        pages = {n: p.clone() for n, p in pool.pages.items()}
        step = dserve.make_paged_pool_decode_step(cfg32, 16, attn=attn)
        logits[attn] = step(params, pool.tokens, pages, pool.tables, lengths, active)
    diff = (logits["kernel"] - logits["gather"]).abs().max().item()
    same = int((logits["kernel"].argmax(-1) == logits["gather"].argmax(-1)).sum())
    log(f"fp32 full width, one paged decode step: kernel vs gather logits max abs diff "
        f"{diff:.3e} (atol 1e-3), argmax equal {same}/8, finite "
        f"{bool(torch.isfinite(logits['kernel']).all())}")
    if not (diff <= 1e-3 and torch.isfinite(logits["kernel"]).all()):
        raise SystemExit("full-width kernel path disagrees with the gather path")
    del params, pool, logits
    torch.cuda.empty_cache()

    # 5b. smoke config served on the card (kernel) and on the CPU (plain
    # version) with the same weights: a torch.Generator draws other numbers
    # on each device, so the weights are drawn once on the CPU and copied
    smoke = registry.get_smoke_config("llama3.2-1b")
    cpu_params = transformer.init_params(smoke, torch.Generator().manual_seed(0), "cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        params = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev))
                  for k, v in cpu_params.items()}
        wl = make_workload("llm_decode_paged", cfg=smoke, slots=3, max_len=24,
                           max_prompt_len=12, params=params, device=dev, block_size=8,
                           attn="kernel")
        reqs = serve.make_requests(smoke, 6, 12, 9, seed=0)
        res[dev] = ServeEngine(wl, ServeConfig(dp=3)).run(reqs)
    for i, r in res["cpu"].items():
        g = res["cuda"][i]
        if not (np.array_equal(g.output, r.output)
                and (g.admit_tick, g.retire_tick) == (r.admit_tick, r.retire_tick)):
            raise SystemExit(f"smoke request {i}: card {g} != cpu {r}")
    log(f"smoke serve at dp 3: {len(res['cpu'])} requests, card (kernel) == cpu (plain) "
        f"token for token and tick for tick")

    # 5b'. gemma3 smoke config through the contiguous pool, card (the flash
    # and rmsnorm kernels, fp32) against CPU (plain versions), same weights
    gsmoke = registry.get_smoke_config("gemma3-12b")
    cpu_params = transformer.init_params(gsmoke, torch.Generator().manual_seed(0), "cpu")
    res = {}
    n0 = fa_ops.flash_attention.launches
    for dev in ("cuda", "cpu"):
        wl = make_workload("llm_decode", cfg=gsmoke, slots=3, max_len=48, max_prompt_len=24,
                           params=to_device(cpu_params, dev), device=dev)
        reqs = serve.make_requests(gsmoke, 6, 24, 20, seed=0, min_prompt_len=6)
        res[dev] = ServeEngine(wl, ServeConfig(dp=3)).run(reqs)
    for i, r in res["cpu"].items():
        g = res["cuda"][i]
        if not (np.array_equal(g.output, r.output)
                and (g.admit_tick, g.retire_tick) == (r.admit_tick, r.retire_tick)):
            raise SystemExit(f"gemma3 smoke request {i}: card {g} != cpu {r}")
    if fa_ops.flash_attention.launches == n0:
        raise SystemExit("the gemma3 smoke serve on the card launched no flash_attention kernel")
    log(f"gemma3 smoke serve (llm_decode) at dp 3: {len(res['cpu'])} requests, card (kernels) "
        f"== cpu (plain) token for token and tick for tick")

    # 5b''. falcon-mamba smoke config through the contiguous pool, card (the
    # selective-scan and rmsnorm kernels, fp32) against CPU (plain versions),
    # same weights
    fsmoke = registry.get_smoke_config("falcon-mamba-7b")
    cpu_params = transformer.init_params(fsmoke, torch.Generator().manual_seed(0), "cpu")
    res = {}
    n0 = ss_ops.selective_scan.launches
    for dev in ("cuda", "cpu"):
        wl = make_workload("llm_decode", cfg=fsmoke, slots=3, max_len=48, max_prompt_len=24,
                           params=to_device(cpu_params, dev), device=dev)
        reqs = serve.make_requests(fsmoke, 6, 24, 20, seed=0)
        res[dev] = ServeEngine(wl, ServeConfig(dp=3)).run(reqs)
    for i, r in res["cpu"].items():
        g = res["cuda"][i]
        if not (np.array_equal(g.output, r.output)
                and (g.admit_tick, g.retire_tick) == (r.admit_tick, r.retire_tick)):
            raise SystemExit(f"falcon-mamba smoke request {i}: card {g} != cpu {r}")
    if ss_ops.selective_scan.launches == n0:
        raise SystemExit("the falcon-mamba smoke serve on the card launched no selective_scan")
    log(f"falcon-mamba smoke serve (llm_decode) at dp 3: {len(res['cpu'])} requests, card "
        f"({ss_ops.selective_scan.launches - n0} selective_scan launches) == cpu (plain) token "
        f"for token and tick for tick")

    # 5c. smoke config trained with the compressed sync on the card (kernel)
    # and on the CPU (plain version): same weights (drawn once on the CPU)
    # and batches.  Tolerances: fp32 GEMMs sum in another order on the card
    # (TF32 off), and a gradient on an int8 rounding tie may round the other
    # way (one quantization step in one coordinate).
    tcfg = step_lib.TrainConfig(
        remat="none", grad_sync="compressed", monitor=True, monitor_threshold=100.0,
        bucket_bytes=1 << 15,
        optimizer=OptimizerConfig(lr=1e-2, schedule="const", warmup_steps=0))
    steps = {dev: step_lib.make_train_step(smoke, tcfg, dp=3, device=dev) for dev in ("cpu", "cuda")}
    st_cpu = steps["cpu"].init_state(torch.Generator().manual_seed(0))
    sts = {"cuda": to_device(st_cpu, "cuda"), "cpu": st_cpu}
    pipe = SyntheticPipeline(smoke, DataConfig(batch=6, seq_len=16, seed=0), "cpu")
    batches = [pipe.next_batch() for _ in range(3)]
    hist = {dev: [] for dev in sts}
    n0 = mc_ops.mrd_combine.launches
    for dev in sts:
        for b in batches:
            sts[dev], m = steps[dev](sts[dev], to_device(b, dev))
            hist[dev].append((float(m["loss"]), float(m["grad_norm"]), bool(m["converged"])))
    for (lg, gg, cg), (lc, gc, cc) in zip(hist["cuda"], hist["cpu"]):
        if not (abs(lg - lc) <= 1e-4 and abs(gg - gc) <= 5e-4 * abs(gc) and cg == cc):
            raise SystemExit(f"smoke training: card {hist['cuda']} != cpu {hist['cpu']}")
    log(f"smoke train compressed dp 3, 3 steps: card (kernel, {mc_ops.mrd_combine.launches - n0} "
        f"launches) {hist['cuda']} vs cpu (plain) {hist['cpu']}: losses atol 1e-4, grad norms "
        f"rtol 5e-4, monitor flags equal")
    if mc_ops.mrd_combine.launches == n0:
        raise SystemExit("the smoke training on the card launched no mrd_combine kernel")

    # 5d. the full-width reduce-scatter plan (dp 3, int8) on fixed fp32
    # buckets of the full-width layout's lengths: final_norm, the two norm
    # stacks, wk and w1.  Card through the kernel == CPU through the plain
    # version, bit for bit.
    rs_lens = [2048, 2 * 16 * 2048, 16 * 2048 * 512, BIG_BUCKET]
    gen = torch.Generator().manual_seed(5)
    fixed = [torch.randn((3, n), generator=gen) for n in rs_lens]
    rs = plans.reduce_scatter_plan(p=3, transform="int8")
    n0 = mc_ops.mrd_combine.launches
    red_gpu = rs.run_buffers([b.cuda() for b in fixed])
    torch.cuda.synchronize()
    rs_launches = mc_ops.mrd_combine.launches - n0
    red_cpu = rs.run_buffers(fixed)
    for g, c in zip(red_gpu, red_cpu):
        if not torch.equal(g.cpu(), c):
            raise SystemExit(f"full-width reduce-scatter: card != cpu, max abs diff "
                             f"{(g.cpu() - c).abs().max().item()}")
    log(f"full-width reduce-scatter (int8, dp 3) on buckets of {rs_lens} elements: card "
        f"({rs_launches} kernel launches) == cpu (plain version) bit for bit")
    del red_gpu, red_cpu, fixed
    torch.cuda.empty_cache()
    t = phase("correctness", t)

    # 6. paged_attention at the served decode shape and at long context
    # (bf16), each beside SDPA on gathered views in this run
    pa_t = {case: paged_timing(case) for case in (KERNEL_CASES[0], KERNEL_CASES[3], QWEN_PAGED,
                                                   ZAMBA_PAGED)}
    torch.cuda.empty_cache()

    # mrd_combine at the largest bucket's stacked rows, fp32 (as the
    # compressed reduce-scatter calls it), beside addcmul on [n / 256, 256]
    # views (one PyTorch call of the same function, a yardstick the port
    # never calls) and out.copy_(x) (8 B an element: the card's streaming rate)
    x, q, sc = combine_inputs(COMBINE_CASES[-1], torch.float32, seed=3)
    copy_out = torch.empty_like(x)
    mc_ms = time_ms(lambda: mc_ops.mrd_combine(x, q, sc), iters=20)
    mc_lib_ms = time_ms(lambda: torch.addcmul(x.view(-1, 256), q.view(-1, 256), sc.view(-1, 1)),
                        iters=20)
    mc_copy_ms = time_ms(lambda: copy_out.copy_(x), iters=20)
    mc_plain_ms = time_ms(lambda: mrd_combine_ref(x, q, sc), iters=10)
    n = x.numel()
    mc_bytes = n * (4 + 1 + 4) + (n // 256) * 4  # x, q in; out; scales
    mc_bytes_ms, mc_ops_ms = mc_bytes / HBM_BYTES_PER_S * 1e3, 2 * n / FP32_FLOPS * 1e3
    mc_bound_ms = max(mc_bytes_ms, mc_ops_ms)
    log(f"timings mrd_combine n={n} fp32 ([3, {n // 3}] rows): kernel {mc_ms:.4f} ms "
        f"({mc_bytes / mc_ms / 1e9:.3f} TB/s, {mc_bound_ms / mc_ms:.3f} of the bound) | plain "
        f"{mc_plain_ms:.4f} ms | addcmul {mc_lib_ms:.4f} ms | kernel / addcmul "
        f"{mc_ms / mc_lib_ms:.3f} | bound {mc_bound_ms:.4f} ms ({mc_bytes} bytes at 3.35 TB/s; "
        f"ops bound {mc_ops_ms:.4f} ms) | copy_ of the fp32 x {mc_copy_ms:.4f} ms "
        f"({8 * n / mc_copy_ms / 1e9:.3f} TB/s)")
    del x, q, sc, copy_out
    # the same n with bf16 x and out (5 B an element)
    x, q, sc = combine_inputs(COMBINE_CASES[-1], torch.bfloat16, seed=3)
    mc_bf16_ms = time_ms(lambda: mc_ops.mrd_combine(x, q, sc), iters=20)
    mc_bf16_bytes = n * (2 + 1 + 2) + (n // 256) * 4
    mc_bf16_bound_ms = mc_bf16_bytes / HBM_BYTES_PER_S * 1e3
    log(f"timings mrd_combine n={n} bf16: kernel {mc_bf16_ms:.4f} ms "
        f"({mc_bf16_bytes / mc_bf16_ms / 1e9:.3f} TB/s, {mc_bf16_bound_ms / mc_bf16_ms:.3f} of the "
        f"bound) | bound {mc_bf16_bound_ms:.4f} ms ({mc_bf16_bytes} bytes at 3.35 TB/s)")
    del x, q, sc

    # flash_attention at 32k tokens, gemma3-12b's heads (bf16): a global
    # layer (causal, no window) and a local layer (window 1024), both timed
    # against the library call in this run; the plain version is flash_scan
    # (the materialized scores do not fit); the library yardstick is
    # scaled_dot_product_attention (causal, GQA; under an S x S boolean window
    # mask for a local layer, 1.07 GB at 32k tokens)
    B, H, KV, hd = 1, gcfg.n_heads, gcfg.n_kv_heads, gcfg.head_dim
    fa_t = {}
    for S, window in ((PREFILL_LEN, None), (PREFILL_LEN, gcfg.local_window),
                      (8192, gcfg.local_window)):
        q, k, v = flash_inputs(B, S, S, H, KV, hd, torch.bfloat16, seed=11)
        long_run = window is None
        ms_k = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True, window=window),
                       iters=5 if long_run else 20, warmup=2)
        ms_p = float("nan")
        if S == PREFILL_LEN:
            ms_p = time_ms(lambda: attention(q, k, v, causal=True, window=window,
                                             impl="flash_scan", chunk=1024),
                           iters=2 if long_run else 5, warmup=1)
        mask = None if window is None else visible_mask(S, S, True, window, device="cuda")
        ms_l, how = sdpa_ms(q, k, v, mask, iters=5 if long_run or S == PREFILL_LEN else 20)
        pairs = fa_ops.visible_pairs(S, S, True, window)
        n_ops = 4 * H * hd * pairs * B
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # q, k, v in; out
        b_ms, o_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOPS * 1e3
        fa_t[(S, window)] = dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                                 bound_ms=max(b_ms, o_ms),
                                 bound_by="bytes" if b_ms >= o_ms else "operations")
        log(f"timings flash_attention S={S} H={H} KV={KV} hd={hd} window={window} bf16: kernel "
            f"{ms_k:.4f} ms | plain (flash_scan) {ms_p:.4f} ms | sdpa ({how}) "
            f"{ms_l:.4f} ms | bound {max(b_ms, o_ms):.4f} ms ({pairs} visible pairs, {n_ops:.4e} "
            f"flop at 989 TFLOP/s = {o_ms:.4f} ms; {n_bytes} bytes at 3.35 TB/s = {b_ms:.4f} ms) | "
            f"{n_ops / (ms_k * 1e-3) / 1e12:.1f} TFLOP/s")
        del q, k, v, mask
        torch.cuda.empty_cache()

    fa_new = flash_widened_timings()
    fa_zamba = zamba_flash_timing()

    # rmsnorm at the 32k prefill's rows, gemma3's width (bf16)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(PREFILL_LEN, gcfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(gcfg.d_model, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    w1 = (1.0 + w.float()).to(torch.bfloat16)
    rn_ms = time_ms(lambda: rn_ops.rmsnorm(x, w, gcfg.norm_eps))
    rn_plain_ms = time_ms(lambda: rmsnorm_ref(x, w, gcfg.norm_eps))
    rn_lib_ms = time_ms(lambda: torch.nn.functional.rms_norm(x, (gcfg.d_model,), weight=w1,
                                                             eps=gcfg.norm_eps))
    rn_bytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    rn_b_ms, rn_o_ms = rn_bytes / HBM_BYTES_PER_S * 1e3, 4 * x.numel() / FP32_FLOPS * 1e3
    rn_bound_ms = max(rn_b_ms, rn_o_ms)
    log(f"timings rmsnorm [{PREFILL_LEN}, {gcfg.d_model}] bf16: kernel {rn_ms:.4f} ms | plain "
        f"{rn_plain_ms:.4f} ms | F.rms_norm(weight=1+w) {rn_lib_ms:.4f} ms | bound "
        f"{rn_bound_ms:.4f} ms ({rn_bytes} bytes at 3.35 TB/s; ops bound {rn_o_ms:.4f} ms)")
    del x, w, w1
    torch.cuda.empty_cache()

    # selective_scan, fused (the model's form), at the 32k prefill's shape of
    # falcon-mamba-7b, bf16 activations (the served type), no h0; the plain
    # version materializes decay and bx (2 x 17.2 GB) and loops over S
    B, S, D, N = 1, PREFILL_LEN, fcfg.d_inner, fcfg.ssm_state
    dt, x, A, Bs, Cs, _ = fused_scan_inputs(B, S, D, N, torch.bfloat16, seed=17)
    ss_ms = time_ms(lambda: ss_ops.selective_scan_fused(dt, x, A, Bs, Cs), iters=10, warmup=2)
    ss_plain_ms = time_ms(lambda: selective_scan_fused_ref(dt, x, A, Bs, Cs), iters=2, warmup=1)
    # dt, x, Bs, Cs and A read once; y and h_final written once
    ss_bytes = (B * S * D * (4 + 2) + 2 * B * S * N * 2 + D * N * 4
                + B * S * D * 4 + B * D * N * 4)
    ss_bytes_ms = ss_bytes / HBM_BYTES_PER_S * 1e3
    # one exponential a (step, channel, state) on the special function units;
    # fp32 arithmetic: dt * A, (dt x) * B and two multiply-adds a state, dt * x
    # a channel
    ss_exp_ms = B * S * D * N / (MUFU_EXP_PER_CLOCK * H100_SMS * max_sm_mhz * 1e6) * 1e3
    ss_flop_ms = (6 * B * S * D * N + B * S * D) / FP32_FLOPS * 1e3
    ss_ops_ms = max(ss_exp_ms, ss_flop_ms)
    ss_bound_ms = max(ss_bytes_ms, ss_ops_ms)
    log(f"timings selective_scan (fused) B,S,D,N=({B}, {S}, {D}, {N}) bf16 x/B/C: kernel "
        f"{ss_ms:.4f} ms | plain (materialized, a loop over S) {ss_plain_ms:.4f} ms | bound "
        f"{ss_bound_ms:.4f} ms ({B * S * D * N:.4e} exponentials at {MUFU_EXP_PER_CLOCK} a clock "
        f"x {H100_SMS} SMs x {max_sm_mhz:.0f} MHz = {ss_exp_ms:.4f} ms; fp32 flop at 67 TFLOP/s "
        f"{ss_flop_ms:.4f} ms; {ss_bytes} bytes at 3.35 TB/s = {ss_bytes_ms:.4f} ms) | no single "
        f"PyTorch call computes it")
    # the chunk-parallel form across blocks, for comparison (the port does
    # not run it): the sequence cut into `parts` pieces run side by side as
    # a batch from zero for each piece's end state, a carry across the
    # pieces (h_in[k] = exp(A * the sum of piece k - 1's dt) h_in[k - 1] +
    # h_end[k - 1]), then the pieces again from their carried states for y
    # and the final state: two launches of the chunked instance, each
    # exponential twice
    def chunk_parallel(parts):
        def piece(t):
            return t.reshape(parts, S // parts, *t.shape[2:])
        pdt, px, pB, pC = piece(dt), piece(x), piece(Bs), piece(Cs)
        _, h_end = ss_ops.selective_scan_fused(pdt, px, A, pB, pC)
        decay = torch.exp(pdt.sum(1)[..., None] * A)
        h_in = torch.zeros_like(h_end)
        for k in range(1, parts):
            h_in[k] = decay[k - 1] * h_in[k - 1] + h_end[k - 1]
        y, h_last = ss_ops.selective_scan_fused(pdt, px, A, pB, pC, h0=h_in)
        return y.reshape(B, S, D), h_last[-1:]

    ss_y, ss_h = ss_ops.selective_scan_fused(dt, x, A, Bs, Cs)
    cp_ms = {}
    for parts in (2, 4, 8):
        cp_y, cp_h = chunk_parallel(parts)
        cp_err = max(scan_err(cp_y, ss_y), scan_err(cp_h, ss_h))
        if cp_err[1]:
            raise SystemExit(f"the chunk-parallel form in {parts} pieces is not the kernel's "
                             f"scan: {cp_err[1]} elements off, max {cp_err[0]:.3e}")
        cp_ms[parts] = time_ms(lambda: chunk_parallel(parts), iters=10, warmup=2)
        log(f"timings selective_scan chunk-parallel across blocks, {parts} pieces (two launches "
            f"of the chunked instance and a carry; not used by the port): {cp_ms[parts]:.4f} ms "
            f"against the kernel's {ss_ms:.4f} ms | max abs err against the kernel "
            f"{cp_err[0]:.3e}")
        del cp_y, cp_h
    del dt, x, A, Bs, Cs, ss_y, ss_h

    # selective_scan's step instance at a decode tick of 8 slots (bf16
    # x/B/C), writing the state over itself as the tick does
    B, S = 8, 1
    dt, x, A, Bs, Cs, h = fused_scan_inputs(B, S, D, N, torch.bfloat16, seed=19)
    ok = torch.ones(B, dtype=torch.bool, device="cuda")
    st_ms = time_ms(lambda: ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=h, h_final=h,
                                                        write_ok=ok))
    st_plain_ms = time_ms(lambda: selective_scan_fused_ref(dt, x, A, Bs, Cs, h0=h, h_final=h,
                                                           write_ok=ok), iters=20)
    # the state read and written, A, dt, x, Bs, Cs, write_ok read, y written
    st_bytes = (2 * B * D * N * 4 + D * N * 4 + B * D * (4 + 2) + 2 * B * N * 2 + B
                + B * D * 4)
    st_bytes_ms = st_bytes / HBM_BYTES_PER_S * 1e3
    st_exp_ms = B * D * N / (MUFU_EXP_PER_CLOCK * H100_SMS * max_sm_mhz * 1e6) * 1e3
    st_flop_ms = (6 * B * D * N + B * D) / FP32_FLOPS * 1e3
    st_ops_ms = max(st_exp_ms, st_flop_ms)
    st_bound_ms = max(st_bytes_ms, st_ops_ms)
    log(f"timings selective_scan (fused, step instance) B,S,D,N=({B}, {S}, {D}, {N}) bf16 "
        f"x/B/C, state in place: kernel {st_ms * 1e3:.2f} us | plain {st_plain_ms * 1e3:.2f} us "
        f"| bound {st_bound_ms * 1e3:.3f} us ({st_bytes} bytes at 3.35 TB/s = "
        f"{st_bytes_ms * 1e3:.3f} us; exponentials {st_exp_ms * 1e3:.4f} us) | bound / kernel "
        f"{st_bound_ms / st_ms:.3f}")
    del dt, x, A, Bs, Cs, h
    torch.cuda.empty_cache()
    t = phase("timings", t)

    # 9. the collectives layer (device_fused's routing, tree_allreduce at full
    # width, BucketPipeline), counted from 0 through 9a-9d
    torch.cuda.empty_cache()
    llama = registry.get_config("llama3.2-1b")
    coll_stats = collectives_phases(
        all_ops, time.perf_counter(), cfg=llama,
        cut_cfg=registry.override(llama, n_layers=COLL_CUT_LAYERS), device=torch.device("cuda"),
        busy=lambda fn: device_profile(fn, 1)[:2])
    coll_launches = coll_stats["launches"]
    t = time.perf_counter()
    # 9e. bench_mrd --quick on the card (its rows in chiprun_out/bench_mrd.json)
    from repro_torch.benchmarks import bench_mrd

    bench = bench_mrd.main(["--quick", "--device", "cuda", "--json",
                            str(ROOT / "chiprun_out" / "bench_mrd.json")])
    coll_stats["bench_mrd"] = {r["name"]: r["us_per_call"] for r in bench["measured"]}
    if bench["device"] != torch.cuda.get_device_name(0) or not bench["measured"]:
        raise SystemExit(f"bench_mrd did not run on the card: {bench['device']}")
    t = phase("collectives-bench-mrd", t)

    # 10. the rest of serving at full width (the static path, tenants,
    # prefix sharing, int8 pages, bench_serve's rows)
    torch.cuda.empty_cache()
    rest_stats = serving_rest_phases(all_ops, t, cfg=registry.get_config("llama3.2-1b"),
                                     device=torch.device("cuda"))
    p10 = rest_stats["launches"]

    # 11. the remaining decoder families (qwen2.5-32b, internvl2-1b and
    # minicpm-2b at full width; mixtral-8x7b and llama4-scout at cut depth)
    free_device()
    fam_stats = families_phases(all_ops, time.perf_counter())
    p11 = fam_stats["launches"]

    # 12. zamba2-2.7b (the hybrid family) at full width, and the smoke
    # configs' head dims on the card
    free_device()
    hyb_stats = hybrid_phases(all_ops, time.perf_counter())
    p12 = hyb_stats["launches"]

    # 13. training every family on one card (13a's runs counted from 0)
    free_device()
    train13 = training_phases(all_ops, time.perf_counter())
    p13 = train13["launches"]["mrd_combine"]

    # 14. the multi-process trainer as a one-rank NCCL world (the world of
    # 14a and 15, one subprocess); Lion and SGD
    free_device()
    t = time.perf_counter()
    worlds = one_rank_world()
    t = phase("one-rank-world-subprocess", t)
    train14 = world_phases(all_ops, t, worlds)
    p14 = train14["launches"]["mrd_combine"]

    # 15. the sharded entry points (gspmd trainer, TP serving CLI) as
    # one-rank NCCL worlds
    free_device()
    tp15 = tp_world_phase(all_ops, time.perf_counter(), worlds)
    p15 = tp15["launches"]

    # 16. the ready-bucket overlap (--overlap against --no-overlap) on
    # stacked rows
    free_device()
    ov16 = overlap_phase(all_ops, time.perf_counter())
    p16 = ov16["launches"]

    # 17. elastic serving (4 -> 3 -> 5 -> 4 under live traffic)
    free_device()
    el17 = elastic_phase(all_ops, time.perf_counter(), smi)
    p17 = el17["launches"]

    # 18. the elastic trainer on stacked rows (4 -> 3 -> 5 -> 4) and its
    # oracle replay
    free_device()
    el18 = elastic_train_phase(all_ops, time.perf_counter(), smi)
    p18 = el18["launches"]

    # 18b. reshard_blocks at full width; 18c. the one-rank world's elastic
    # gspmd trainer with a checkpointer (run in 14a's subprocess)
    el18b = reshard_phase(all_ops, time.perf_counter(), smi)
    el18c = elastic_world_phase(time.perf_counter(), worlds, smi)

    # 19. results
    log(json.dumps({"serve": {k: serve_stats[k] for k in (
        "completed", "decode_ticks", "tokens_out", "throughput_tok_s", "ttft_p50_ms",
        "tpot_p50_ms", "wall_s")}}))
    log(json.dumps({"train": train_stats}))
    log(json.dumps({"gemma3_serve": gemma_stats}))
    log(json.dumps({"gemma3_prefill_32k": prefill_stats}))
    log(json.dumps({"falcon_serve": falcon_stats}))
    log(json.dumps({"falcon_prefill_32k": falcon_prefill_stats}))
    log(json.dumps({"async": async_stats}))
    log(json.dumps({"fixedpoint_serve": fixedpoint_stats}))
    log(json.dumps({"collectives": coll_stats}))
    log(json.dumps({"serving_rest": {k: v for k, v in rest_stats.items()
                                     if k != "bench_serve"}}))
    log(json.dumps({"families": fam_stats}))
    log(json.dumps({"hybrid": hyb_stats}))
    log(json.dumps({"training": train13}))
    log(json.dumps({"world_training": train14}))
    log(json.dumps({"tp_world": tp15}))
    log(json.dumps({"overlap": ov16}))
    log(json.dumps({"elastic": el17}))
    log(json.dumps({"elastic_train": el18}))
    log(json.dumps({"reshard_blocks": el18b}))
    log(json.dumps({"elastic_gspmd_world": el18c}))
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/paged_kernel.py:78",
        "launches": (launches + p10["paged_attention"] + p11["paged_attention"]
                     + p12["paged_attention"] + p15["paged_attention"]
                     + p17["paged_attention"]),
        "launches_by_path": {"llama_serve": launches, "serving_rest": p10["paged_attention"],
                             "families": p11["paged_attention"],
                             "hybrid": p12["paged_attention"],
                             "tp_world": p15["paged_attention"],
                             "elastic_serve": p17["paged_attention"]},
        "max_abs_err": errs[(KERNEL_CASES[0], torch.bfloat16)],
        **pa_t[KERNEL_CASES[0]],
        "long_context": {"shape": list(KERNEL_CASES[3]),
                         "max_abs_err": errs[(KERNEL_CASES[3], torch.bfloat16)],
                         **pa_t[KERNEL_CASES[3]]},
        "qwen2.5_decode": {"shape": list(QWEN_PAGED),
                           "max_abs_err": errs[(QWEN_PAGED, torch.bfloat16)],
                           "launches": fam_stats["qwen"]["launches"]["paged_attention"],
                           **pa_t[QWEN_PAGED]},
        "zamba2_decode": {"shape": list(ZAMBA_PAGED),
                          "max_abs_err": errs[(ZAMBA_PAGED, torch.bfloat16)],
                          "launches": hyb_stats["paged"]["launches"]["paged_attention"],
                          **pa_t[ZAMBA_PAGED]},
    }, {
        "name": "mrd_combine",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mrd_combine/csrc/mrd_combine.cu",
        "replaces": "src/repro/kernels/mrd_combine/kernel.py:31",
        "launches": (train_launches + coll_launches + p13 + p14 + p15["mrd_combine"]
                     + p16["mrd_combine"] + p18["mrd_combine"]
                     + el18c["launches"]["mrd_combine"]),
        "launches_by_path": {"train": train_launches, "collectives": coll_launches,
                             "training_families": p13, "world_and_optimizers": p14,
                             "tp_world_gspmd": p15["mrd_combine"],
                             "overlap": p16["mrd_combine"],
                             "elastic_train": p18["mrd_combine"],
                             "elastic_gspmd_world": el18c["launches"]["mrd_combine"]},
        "max_abs_err": errs[(COMBINE_CASES[-1], torch.float32)],
        "ms": mc_ms,
        "plain_ms": mc_plain_ms,
        "bound_ms": mc_bound_ms,
        "bound_by": "bytes" if mc_bytes_ms >= mc_ops_ms else "operations",
        "library_ms": mc_lib_ms,
        "copy_ms": mc_copy_ms,
        "bf16": {"ms": mc_bf16_ms, "bound_ms": mc_bf16_bound_ms, "bound_by": "bytes"},
        "device_fused": {**coll_stats["route"]["timing"], "max_abs_err": max(
            r["max_abs_err"] for r in coll_stats["route"]["cases"] if r["launches"])},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
        "launches": (fa_launches + p10["flash_attention"] + p11["flash_attention"]
                     + p12["flash_attention"] + p15["flash_attention"]
                     + p17["flash_attention"]),
        "launches_by_path": {"gemma3_serve": fa_launches, "serving_rest": p10["flash_attention"],
                             "families": p11["flash_attention"],
                             "hybrid": p12["flash_attention"],
                             "tp_world": p15["flash_attention"],
                             "elastic_serve": p17["flash_attention"]},
        "max_abs_err": errs[(FLASH_CASES[0], torch.bfloat16)],
        **fa_t[(PREFILL_LEN, None)],
        "widened": [{**v, "max_abs_err": max(  # over phase 3's bf16 cases of these heads
            e for k, e in errs.items() if len(k) == 2 and k[1] == torch.bfloat16
            and k[0] in FLASH_CASES and k[0][3:6] == h)} for h, v in fa_new.items()],
        "zamba2_32k": {**fa_zamba, "max_abs_err": errs[(ZAMBA_FLASH, torch.bfloat16)],
                       "launches": p12["flash_attention"]},
    }, {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:24",
        "launches": (rn_launches + p10["rmsnorm"] + p11["rmsnorm"] + p12["rmsnorm"]
                     + p15["rmsnorm"] + p17["rmsnorm"]),
        "launches_by_path": {"gemma3_serve": rn_launches, "serving_rest": p10["rmsnorm"],
                             "families": p11["rmsnorm"], "hybrid": p12["rmsnorm"],
                             "tp_world": p15["rmsnorm"], "elastic_serve": p17["rmsnorm"]},
        "max_abs_err": errs[(RMSNORM_CASES[0], torch.bfloat16)],
        "ms": rn_ms,
        "plain_ms": rn_plain_ms,
        "bound_ms": rn_bound_ms,
        "bound_by": "bytes" if rn_b_ms >= rn_o_ms else "operations",
        "library_ms": rn_lib_ms,
    }, {
        "name": "selective_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan/kernel.py:43",
        "launches": ss_launches,
        "max_abs_err": errs[("fused", FUSED_SCAN_CASES[0], torch.bfloat16)],
        "ms": ss_ms,
        "plain_ms": ss_plain_ms,
        "bound_ms": ss_bound_ms,
        "bound_by": "bytes" if ss_bytes_ms >= ss_ops_ms else "operations",
        "library_ms": None,
        "chunk_parallel_ms": {str(k): v for k, v in cp_ms.items()},
        "decode_step": {"shape": [8, 1, D, N],
                        "max_abs_err": errs[("fused", FUSED_SCAN_CASES[1], torch.bfloat16)],
                        "ms": st_ms, "plain_ms": st_plain_ms, "bound_ms": st_bound_ms,
                        "bound_by": "bytes" if st_bytes_ms >= st_ops_ms else "operations",
                        "library_ms": None},
    }]}))
    log(f"gpu: {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
