#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 1-3,16  # some of them

``--phases`` takes numbers and ranges; phase 1 always runs, and a phase
that reads another's results brings it along (4 and 5 run together; 7
needs 2, 4, 5 and 6).  Each phase not selected is logged as skipped, the
seconds of every phase are printed as one ``{"phase_s": ...}`` line, and
the ``kernels`` line, which reads every phase, is printed only when all
of them ran.

Phases (any failure exits non-zero; no result line is printed then):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; requires ``torch.cuda.is_available()``.
2. build: compiles the six kernel sources of ``src/repro_torch/csrc`` (one
   nvcc each, all started together) and prints the build times and the
   compiler's register reports; then checks the design in the SASS
   (``cuobjdump -sass``): the flash library must hold HGMMA (wgmma) and
   UTMALDG (TMA loads), in its bf16 kernel at each head width (64, 128,
   256), the decode library UBLKCP (bulk copies), the mLSTM
   library HGMMA (its 3xTF32 products), the RG-LRU library UTMALDG (its
   copy ring) and both quant kernels UBLKCP (their copy ring), and no
   kernel of ``NO_SPILL`` may spill; it counts the
   integer and f64 instructions of the event library's draw code
   (``event_draws_kernel``), which the sampled kernel's bound reads.
3. parity: the event kernel against its plain PyTorch version on the
   card, bitwise, under both precision policies, on a dyadic schedule, a
   ragged shape (B=37, N=333, F=200) and the exhaustion/truncation case,
   on the (B, N, F) layout and its (B, F, N)-strided copy; the sampled
   event kernel (gaps drawn inside it) for Exponential, Weibull(0.7),
   LogNormal(1) and TraceReplay, both policies, at a ragged N, a capacity
   that runs dry and a step budget that truncates: its draws (the
   draw-only entry) against ``sample_gaps`` on the card (Exponential and
   TraceReplay bitwise; Weibull and LogNormal bitwise or their largest ulp
   difference printed, and within 1e-12 relative), and the sweep bitwise
   against the explicit kernel and the plain version on those draws;
   the int8 quantize and dequantize kernels against theirs, bitwise (int8
   payloads, scale bits, output bits; a NaN compares as NaN), on
   ``quant_cases()``, one leaf a launch and then all of them in one launch
   (in order and reversed; each leaf also equal to its one-leaf result);
   the four model-zoo kernels against theirs (and
   against the oracles of ``kernels/ref.py``) at small ragged and edge
   shapes: RG-LRU bitwise (f32 and bf16; the ring route with W not a
   multiple of its 32 lanes and S not of its 64-step stages, (3, 300, 200)
   and (2, 1000, 4104), and the direct route, W = 333), flash
   attention in all four modes (Dh 64, 128 and 256, f32 and bf16, S =
   333; bf16 also at S = 1000 with windows 100 and 700 and chunks of 64,
   and at S = 77),
   decode (Dh 64, 128 and 256, f32 and bf16: S = 768, length 0, 1, 333,
   768; S = 1000, length 999 and 1000; BH = 1), mLSTM (chunks 64/128/256
   at Dh 128/256/384, and bf16), within ``ZOO_TOL``; and phase 14's
   shapes: RG-LRU at (2, 1, 4096) and (2, 4096, 4096), flash bf16 at S
   8192 under a window of 4096 (Dh 128), decode bf16 at BH 192, S 4096,
   Dh 128 (lengths 1, 2048, 4096) and BH 32, S 2048, Dh 256; phase 15's
   at Dh 64 in f32 and bf16: flash bidir at 1500 x 1500 and at 64 queries
   against 1500 keys (whisper's encoder and cross-attention, BH 96 in
   bf16), causal at S 2048 (internvl, BH 224), decode at BH 96 x 1500 and
   BH 224 x 2080 (lengths 1, the middle, all); and ``ops.decode_attention``
   in the model layout on ``expand_kv``'s cache (starcoder2-3b's 8 x 24
   heads over 2 at 4096 slots, recurrentgemma-9b's 2 x 16 over 1 at 2048,
   whisper-tiny's 16 x 6 over 6 at its 1500-slot cross cache,
   internvl2-1b's 16 x 14 over 2 at 2080) against the plain version on
   heads repeated by ``repeat_interleave``.
4. model sweep: ``evaluate_grid`` on the 1,000,000-point
   ``mu_rho_grid(linspace(30,600,1000), linspace(1,10,1000))`` under both
   policies; the compensated periods, re-evaluated in f64, must be within
   ``objective_tol`` (1e-6) of the f64 objectives and ``argmin_rtol``
   (1e-2) of the f64 periods.
5. Monte-Carlo: ``simulate_trajectories`` on
   ``mu_rho_grid(geomspace(120,1200,32), linspace(2,10,32))`` at the AlgoT
   and AlgoE periods, T_base = 4000, 4096 trials, Exponential and
   Weibull(0.7), both policies, each drawing its gaps inside the sampled
   kernel.  Gates: no truncated or exhausted lane; the sampled kernel
   launched, the explicit kernel, the draw-only entry, every plain version
   and ``draw_gaps`` (``sample_gaps``) never; at least 64 lanes per f64
   run replayed through the scalar oracle ``simulate_once(gaps=...)``
   (floats <= 1e-12 relative, equal failure counts, checkpoint counts
   within one); compensated per-point means within 1e-5 of f64.  The
   MC-to-model gaps are reported, not gated.  Then the dispatch check:
   on Weibull at the AlgoE periods, every lane's auto-sampled gaps and
   every ``simulate_trajectories`` output are bitwise equal under
   ``DispatchConfig()``, ``chunk=7`` and ``memory_mb=64``.  Then an
   explicit schedule (the caller's, drawn on the card from a seeded
   generator, 512 trials) through ``simulate_trajectories(gaps=...)``:
   the explicit kernel launched and nothing else; lanes against the
   scalar oracle at 1e-12.
6. checkpoint runtime at full width: xLSTM-125M's params and AdamW
   moments (519,271,056 f32, drawn on the card from a seeded generator)
   plus an int32 step, through ``CheckpointManager`` (buddy, the policy's
   m) over ``ShardedStore(compress=True)`` under
   ``CheckpointPolicy("algo_e_ml")``: a deep checkpoint, a buddy-only one,
   a dropped buddy, a restore from the store.  Gates: every dequantized
   leaf bitwise equal to the plain version's dequantization of its
   payload and within half its group's scale (+1e-6 of the group's
   max|x|) of the original; uncompressed leaves bitwise equal; payload
   <= 0.27 of the f32 bytes; one quantize launch for the 57 leaves of
   the deep checkpoint and one dequantize launch for the restore, no
   one-leaf launch and no plain-version call; every deep flush recorded
   "ok"; the policy's (T, m) solved on the card within 1e-8 of the CPU's
   on the same observations.  Prints the save and restore splits and
   their peak device memory.
7. times: CUDA-event medians of 5 samples (3 for a call of 100 ms or
   more: the plain versions and the two-step path) of each kernel and of its
   plain version (a sample: calls back to back over 20 ms or more, see
   ``_events_ms``) at the main-path shapes (compared again): per MC call
   the sampled kernel and its bound (operations), the explicit kernel on
   the same lanes' drawn schedule in both layouts with its byte bound,
   the transpose between them, the two-step path (the ``sample_gaps``
   draws, then the explicit kernel on them), the warps' efficiency (lane
   steps over 32 times the longest lane's), and ``simulate_trajectories``
   end to end with its host parts; the quant kernels over one
   checkpoint's 57 leaves in one launch, in 57 one-leaf launches (the
   parent's pattern) and on the largest leaf alone, each through its
   wrapper (host work included) and, for the grouped launches, also on a
   leaf table uploaded once, each beside the byte bound.
8. the model-zoo kernel layer at full width, through ``kernels.ops``
   (decode through its raw wrapper): RecurrentGemma-9B's RG-LRU scan
   (2, 4096, 4096) f32 with zero and seeded h0, its local attention
   (B 2, S 4096, 16 heads of 256 over one expanded KV head, window 2048,
   bf16) and its decode (2,048 rows against a 2,048-slot cache, length
   2048 and 1000, bf16); xLSTM-125M's mLSTM (8, 4, 4096, 384), chunk
   256, f32.  Gates: every zoo kernel launched and no plain version
   called during the run; the outputs against the plain versions on the
   same inputs (RG-LRU bitwise, through its ring route, the others within
   ``ZOO_TOL``; the attention readings logged beside their gates).  Then
   ``repro_torch.benchmarks.bench_kernels.main`` on the card (five rows,
   its five kernels launched, no plain call), and each zoo kernel's time
   beside its plain version's, its bound, and for attention the time of
   ``scaled_dot_product_attention`` with the same mask; the mLSTM's bound
   is 3xTF32 on the tensor cores (three products each), with the FP32-core
   bound and each pass's time (gates, state, output) beside it.

9. the paper's figures and tables (between phases 5 and 6): first the
   candidate check: ``simulate_candidates`` on one point (the MC
   surrogate's schedule, 17 candidates) must make one launch, the
   schedule read through a point stride of 0, bitwise equal to one
   ``simulate_trajectories`` launch per candidate; and the step scan
   (``engine_kind="step"``) on the card bitwise equal to the event kernel
   on a dyadic schedule and to the CPU's step scan.  Then fig1-3,
   ``table_baselines``, ``table_simulation``
   (``default_rng(0)``), fig5 at full size (``default_rng(0)`` and
   ``default_rng(1)``) and one ``MCSurrogate(fig12_checkpoint(300),
   rho 5.5, Weibull(0.7)).argmin("energy")`` through
   ``repro_torch.benchmarks``.  Gates: the explicit kernel launched and
   nothing else; the same run on the CPU, and the card's numbers within
   1e-12 relative of it (the MSK period, a golden-section argmin, 1e-8),
   fig5 with the same candidate picks; fig1's headline (>20% energy
   gain, 5-15% time loss at mu 300, rho 5.5) and fig5's (the energy
   penalty at k 0.5, mu 120 within half a point of 8.1% and the grid's
   largest; the optima within fig5's 2% validation gate).  Times: each
   part on the host clock, and the explicit kernel on fig5's and the
   argmin's own launches (replayed back to back through the wrapper and
   on arguments made ready once, compared bitwise with the plain
   version) beside its bound: the gaps the lanes read (a point stride of
   0 shares them), outputs and parameters, or the update's f64
   operations.

10. the multilevel (buddy + PFS) path (after phase 9), each part with
   the counts set to 0 just before it and read just after, every line
   with the card's name and power limit.  ml-sweep-262k:
   ``evaluate_multilevel_grid`` on ``buddy_ratio_grid(geomspace(0.01, 1,
   512), geomspace(0.001, 0.5, 512), mu_min=300)`` at m 1..12, f64 and
   compensated f32 (host clock, chunks, peak device memory); the f64
   result equal to the port's CPU run on every 64th point within 1e-12
   (the same m picks, valid and NaN positions), compensated f32 by the
   reference's multilevel gate (m flips of one notch at most, the f32
   pick's f64 energy within 10 objective_tol, the periods compared
   directly within argmin_rtol where the m picks agree; where they flip,
   the direct reading printed and the period held against the f64 one of
   its own cadence).  ml-mc-1024x4096:
   ``simulate_trajectories_ml`` at the AlgoT and AlgoE (T, m) of
   ``buddy_ratio_grid(geomspace(0.02, 1, 32), geomspace(0.01, 0.4, 32),
   mu_min=600)``, 4096 trials, T_base 4000, f64, each schedule drawn by
   ``presample_failures`` from ``default_rng(0)`` and moved to the card
   once (host clock split into presampling, the copy, the scan and the
   energy integral; steps against the budget; peak device memory); no
   truncated or exhausted lane, 72 points x 64 trials equal to the CPU's
   run (bitwise, else named and gated at 1e-12), the MC means within 2%
   (AlgoT) and 2.5% (AlgoE, where the first-order forms miss the
   reference's own MC by up to 2.05%) of the closed forms wherever
   m T < mu, the points beyond 2% printed.  The sweep and the scan are
   plain PyTorch: no kernel launch and no plain-version call.  figs-fig4:
   fig4, ``sweep_buddy_ratio`` on fig4's axes and ``energy_study``
   (``default_rng(0)``) on the card (the explicit and the sampled event
   kernels launched, no plain call), within 1e-12 of the CPU's run (the
   study's lines equal), fig4's headline (40.56% at ratio 0.02, q 0.01,
   m* 12).  The m = 1 reduction: the lift of a single-level grid (q 0.3)
   through ``simulate_trajectories_ml(T, 1)`` bitwise equal, on a dyadic
   schedule, to the step kind and to the explicit event kernel (launched
   and counted), on a raw schedule to the step kind (the energy integral,
   which prices each level's I/O at its own power, within 1e-15), and to
   the CPU's scan.

11. the checkpoint advisor (after phase 10), every line with the card's
   name and power limit, the six kernel wrappers' launches and the plain
   versions' calls counted over the whole phase and required to be zero
   (the service runs no kernel: its sweeps and certificate are eager
   PyTorch).  The smoke leg (``repro_torch.launch.serve advisor --smoke
   --device cuda``: 48 mixed requests from ``default_rng(7)`` batched
   bitwise equal to solo, the open loop at 2000 Hz with rps > 0, a cache
   hit rate > 0); the burst (``bench_advisor.time_advisor_rps``, 512
   single-level requests from ``default_rng(42)``, repeat 2: one
   dispatched solve, bitwise the naive one-solve-per-request loop,
   ``speedup_warm`` >= 20); the four open-loop regimes
   (``time_advisor_regimes``); the burst and a mixed 512 (two-tier share
   0.5, ``default_rng(11)``) served in f64 on the card and by the port on
   the CPU (periods and predictions within 1e-12 relative, the same
   picks, stores and flags); the default policy (compensated f32) on the
   mixed 512, every served objective within cert_bound + objective_tol
   of an exact f64 solve on the card; the split of one cold window of the
   mixed 512 and of a 16,384-request mixed burst (``default_rng(12)``)
   into fingerprinting, grids and copy up, the two solves, the
   certificate, the read-back and ``Advice``, with the CUDA kernels a
   window launches (``torch.profiler``) and their busy share, the 16,384
   burst's wall on the port's CPU, and the certificate timed on the card
   and on the host; then ``cache_stats()`` after a repeat workload and
   ``backend_info("cuda")``.

12. xLSTM-125M trains (after phase 11), every line with the card's name
   and power limit, each part's counts set to 0 just before it and read
   just after.  At full width (d 768, 4 heads, mLSTM Dh 384, chunk 256,
   vocab 50,304 padded to 50,432) cut to 2 of its 12 layers (one mLSTM,
   one sLSTM: a depth cut that makes room for phase 16): ``Model.init`` on
   a seeded ``torch.Generator`` (93,402,632 params in 22 leaves); three
   ``make_train_step`` steps (AdamW, lr 1e-3, warmup 1, 100 steps) on one
   ``SyntheticLM`` batch (seed 0, B 8, S 1024, bf16 compute,
   ``remat="full"``), each on the host clock: every loss and grad norm
   finite, the last loss below the first, ``mlstm_scan`` launched twice
   a step (a forward and its remat recompute) and no plain version
   called; one more step under ``torch.profiler`` (its CUDA kernels,
   their busy time, the mLSTM kernels' share) and each recurrent layer
   timed alone at the step's shapes (the mLSTM forward and backward, the
   sLSTM forward and backward) for the step's split; ``Model.loss`` under
   no grad at B 8, S 4096 (1 launch); layer 0's mLSTM h through the
   kernel against ``mlstm_scan_plain`` within ``ZOO_TOL`` and
   ``MLSTMScan``'s gradients against autograd through the
   ``_mlstm_chunk`` scan within ``TRAIN_BWD_TOL`` (relative Frobenius);
   the card's loss against the port's CPU loss from the same params (B 2,
   S 512) within 3e-2; ``compress_grads`` on the step's gradients (one
   quantize and one dequantize launch over the 19 leaves of >= 1024
   elements, every leaf bitwise the one-leaf round trip, wire ratio <
   0.3), then three steps with the compression between the gradients and
   ``apply_updates`` (S 256) whose loss falls; and
   ``table_arch_periods`` on the card within 1e-12 of the CPU.

13. the fault-tolerant runtime (after phase 12), every line with the
   card's name and power limit, each part's counts set to 0 just before
   it and read just after.  (a) the ft-xlstm-125m cell: ``ft.run.build``
   and ``run`` (``execute``'s two halves, the train-step calls counted) of
   ``FT_RUN``: xLSTM-125M at full width, B 8, S 256, measured time,
   ``algo_e_ml`` with a buddy level, q = 1, the compressed store, mu
   25 s, seed 18, 6 steps.  Gates: all steps done; at least one failure,
   every rollback a deep restore; losses finite; ``mlstm_scan`` launched
   12 times for each train step run (replays and interrupted steps
   included), no plain version; one quantize launch for each deep
   checkpoint written and one dequantize launch for each deep restore;
   layer 0's mLSTM on the run's input at its shape within ``ZOO_TOL`` of
   the plain version.  Prints the step times, C2 with its split, C1, the
   restore times, the policy's solved and realized T, m and k, the
   energy report and the run's wall.  (b) ``launch.train``'s ``--smoke``
   on the card (its gates: 120 steps, measured/predicted wall and
   energy within [0.7, 1.3], a non-degenerate operating point; reduced
   xLSTM-125M, one mLSTM head of 128), then the same spec on the CPU from
   the same params: wall and energy equal, the counts and checkpoints
   equal, the operating point and predictions within 1e-12, losses within
   3e-2, the mLSTM launched once a train step run; the kernel at the
   smoke's shape (chunk 16) within ``ZOO_TOL``.  (c) the rollback
   identity: ``FT_IDENTITY``, xLSTM-125M's widths at 2 layers, B 8, S
   256, 10 steps in scaled time, a failure-free run and one with failures
   (at least 2, one hard) from the same params: the final params and
   AdamW state bitwise equal, in-process with PyTorch's default
   algorithms (no order-dependent atomics on the path).

14. serving (after phase 13), every line with the card's name and power
   limit, each part's counts set to 0 just before it and read just after,
   each run through ``repro_torch.launch.serve.model_main`` with its decode
   loop under ``torch.cuda.set_sync_debug_mode("error")``.  (a)
   starcoder2-3b at full width, B 8, prompt 8192 (past its window of
   4096: the sliding mask, the ring wraps), 32 new tokens, 2 waves; then
   the int8 KV cache at prompt 2048, 16 new tokens.  (b) recurrentgemma-9b
   at full width, B 2, prompt 4096, 16 new tokens.  Gates: the last logits
   finite; flash launched once per attention layer a wave, decode once
   per attention layer a step, the RG-LRU scan once per RG-LRU layer a
   wave and a step (26 + 26 a step), no other kernel, no plain version.
   Prints the prefill and per-step times, the peak device memory and, for
   (a) and (b), one more decode step under ``torch.profiler`` (its CUDA
   kernels, busy share, the ten kernels that take the most device time)
   and that step's ``expand_kv`` copies timed alone (their share).  (c)
   the card against the CPU from the same params (starcoder2-3b's widths
   at 2 layers, recurrentgemma-9b's at one super-block with its vocab cut
   to 4096; B 4, prompt 512, window 128, 4 teacher-forced steps), each
   logits row (a sequence at a step) in relative Frobenius: in f32
   compute every row within 1e-4; in bf16 compute the median row within
   the reference's bf16 tolerance (5e-2 for these sliding archs).  (d)
   xLSTM-125M at full width, B 2, prompt 1024 (6 mLSTM launches), 8
   decode steps.

15. the other four archs served (after phase 14), as phase 14: every
   line with the card's name and power limit, each part's counts set to
   0 just before it and read just after, each run through
   ``model_main`` with its decode loop under sync-debug "error", each
   model freed before the next.  (a) llama4-scout-17b-a16e at full width
   cut to one super-block (4 of 48 layers: three chunked MoE layers and a
   global NoPE one; ``model_main``'s ``cut``), B 1, prompt 16384 (two
   8192-token chunks: the chunked mask bites, the chunk ring holds the
   second, decode starts a third), 16 new tokens; then ``moe_impl =
   "capacity"`` at prompt 8192 (C 640, the top-1 inverse gather).  (b)
   dbrx-132b at full width cut to 2 of 40 layers, B 1, prompt 8192, 16
   new tokens; then capacity (C 2560: the scan over 512-slot chunks and
   the top-4 scatter-add).  (c) whisper-tiny whole, B 16, 1500 stub frames,
   prompt 64, 64 new tokens.  (d) internvl2-1b whole, B 16, 256 stub
   prefix embeddings + prompt 1792, 32 new tokens.  Gates as phase 14's:
   flash once per attention layer a wave (whisper: 4 encoder, 4 self, 4
   cross), decode once per attention layer a step (whisper: 4 self, 4
   cross), no plain call, logits finite.  Each run prints its prefill and
   per-step times, peak memory and one profiled step (kernels, busy
   share, the expand copies and, for the MoE, the expert-weight casts
   timed alone).  (e) card against CPU from the same params in f32 and
   bf16 (``SERVE15_VS_CPU``: whisper and internvl whole at B 2, prompt
   32; the MoE archs at heads of 128 with d 1024 and vocab 4096, every
   expert kept, both ``moe_impl``s): phase 14 (c)'s gates, with the
   routing flips between the devices counted and printed (a row after a
   flip at a top-k gap under 1e-5 may leave the every-row f32 gate).

16. training through attention and the RG-LRU (run last, after every
   other model is freed), every line with the card's name and power
   limit, each part's counts set to 0 just before it and read just after.
   (a) starcoder2-3b at full width (d 3072, 24 heads of 128 over 2)
   cut to 4 of 30 layers, B 4 x S 4096, bf16 compute, ``remat="full"``,
   three ``make_train_step`` steps (AdamW); (b) recurrentgemma-9b at full
   width cut to one super-block (rglru, rglru, sliding; the 256,000
   vocab), B 1 x S 4096, the same.  Gates: losses and grad norms finite;
   the parameter counts; flash launched twice an attention layer a step
   (the forward and its remat recompute; the backward is PyTorch), the
   RG-LRU scan three times an RG-LRU layer a step (the forward, the
   recompute and the reverse scan of its backward), no other kernel, no
   plain version.  Each prints its step times, peak memory and one
   profiled step (CUDA kernels, busy share, flash and RG-LRU kernels).
   (c) ``launch.train.main`` in-process (reduced starcoder2-3b, heads of
   64, scaled time, failures), then the same command on the CPU: every
   step done, the report's keys equal (and to phase 13's smoke's), wall
   and energy equal, flash launched once an attention layer for each
   train step run.  (d) the card against the CPU from the same params
   (``TRAIN16_VS_CPU``: starcoder2-3b, recurrentgemma-9b, whisper-tiny,
   llama4-scout at d 128 and heads of 64, S 256): the loss and every
   gradient leaf in f32 (median leaf 1e-4, every leaf 1e-2, relative
   Frobenius) and the loss in bf16 (``TRAIN_CPU_TOL``).  (e)
   ``FlashAttention``'s dq, dk, dv at one full-width layer of (a) (96 x
   4096 x 128, causal) and of (b) (16 x 4096 x 256, sliding 2048), f32
   and bf16, against autograd through ``flash_attention_plain`` in f32
   (``ZOO_TOL``; the bf16 gate), with the backward's and the forward
   kernel's device ms; the reverse scan bitwise ``rglru_scan_plain`` on
   the same flipped inputs and ``RGLRUScan``'s da, db, dh0 within 1e-5 of
   autograd through the plain scan at (1, 512, 4096); ``remat_group`` 2
   against 1 on a 4-super-block reduced recurrentgemma-9b (f32), each
   with its launches as designed (``_train16_launches``).

17. devices and meshes (run last), every line with the card's name and
   power limit, each part's counts set to 0 just before it and read just
   after.  (a) the card's facts: ``torch.cuda.device_count()`` and
   ``sim.dispatch.effective_devices()`` (equal), and the card's
   ``total_memory`` equal to ``launch.mesh.H100["hbm_bytes"]``.  (b) the
   grid split: a one-card machine shows one device, so the sweep mesh is
   patched to ``(cuda:0, cuda:0)`` (``SPLIT_DEVICES``), as the CPU tests
   patch it to copies of the CPU; under it the mc-1024x4096 cell
   (``simulate_trajectories`` at the AlgoE periods, Weibull(0.7), f64,
   in-kernel draws), ``evaluate_grid`` on the 1e6-point grid and
   ``evaluate_multilevel_grid`` on ml-sweep-262k (f64 and compensated
   f32 each) are bitwise the unsplit calls, the MC making one
   sampled-kernel launch a capacity bucket unsplit and one a (bucket,
   device piece) split; both forms on the host clock.  (c) the elastic
   restore-and-continue: a world-1 NCCL group on a ``HashStore`` and
   ``make_test_mesh(1)`` on ``cuda``; xLSTM-125M at phase 12's cut (2
   layers at full width, ``ELASTIC``), B 8, S 256, trains k = 2 steps,
   takes a raw and an int8-compressed checkpoint (``ShardedStore``),
   then ``plan_reshard(mesh, 0)``, ``build_mesh``, a restore of each,
   ``reshard_tree`` (DTensors; their local tensors train on) and k more
   steps.  Gates: from the raw checkpoint the losses, params and AdamW
   state bitwise those of the uninterrupted run; from the int8 one
   bitwise those of the uninterrupted run whose state at step k went
   through the same int8 round trip in memory (``ops.quantize_arrays`` /
   ``dequantize_arrays``; the checkpoint is lossy, so it is this run that
   the restore must reproduce), and its distance from the uninterrupted
   run printed; ``mlstm_scan`` launched 5 k times a step's count (the
   uninterrupted run, the round-trip run and the two restores), two
   quantize and two dequantize launches, no plain call.  The group is
   destroyed at the end.
18. the tooling, every line with the card's name and power limit, its
   counts set to 0 just before it and read just after (the event kernels
   and flash attention must launch).  (a) ``benchmarks/roofline.py``'s
   section 2 on the card: ``_evaluate_core``, the step scan, the explicit
   and the sampled event kernel at 64 points x 64 trials, capacity 32,
   each costed by ``launch/cost.py`` and timed with CUDA events beside its
   bound; a kernel row may not beat its ``kernels/cost.py`` bound.  (b)
   ``repro_torch.sanitize``'s four workloads on the card: every count
   within its committed budget (``sanitize_budget.json``) and printed
   beside the count committed from the CPU, the CUDA kernels (profiler)
   and the sync debug mode's syncs, the leak check by
   ``memory_allocated``.  (c) the dry run's estimate of a reduced cell
   (``TOOL_CELL``: starcoder2-3b, 2 layers, train B 2 x 2048, its
   tensor-parallel step traced on meta DTensors over a one-rank mesh of a
   ``fake`` group) against the same DTensor step run for real on a
   world-1 NCCL group on a ``HashStore`` (every mesh dim replicates, so no
   collective runs): ``max_memory_allocated``, less what earlier phases
   left allocated, within ``TOOL_PEAK_BAND`` of ``peak_bytes_est``.  (d) ``bench_sweep
   --quick``.  At section 2's 64 x 64 lanes the kernels run hundreds of
   times above their bounds, so (a)'s rule checks only the plumbing; a
   run of every phase also holds each kernel's work model where it binds:
   no row of the kernels line (phases 7-9's timed shapes, each part) runs
   faster than its bound (``_hold_bounds``).
19. the train step and decode sharded (run last), every line with the
   card's name and power limit, each run's counts set to 0 just before it
   and read just after.  A world-1 NCCL group on a ``HashStore`` and
   ``make_test_mesh(1)`` on ``cuda``; (a) starcoder2-3b at full width
   (d 3072, 24 heads of 128 over 2, d_ff 12288, window 4096, vocab
   49,152) cut to 2 of 30 layers, B 4 x S 4096; (b) recurrentgemma-9b at
   full width cut to one super-block with its vocab cut to 4096, B 1 x S
   4096; bf16 compute, ``remat="full"``, AdamW (lr 1e-3, warm-up 1), 2
   steps (``SHARD``).  Each runs twice from the same seeded params and
   batch, one run freed before the next: on DTensors placed by
   ``sharding.place_tree`` under ``use_mesh`` (flash and the RG-LRU on
   each rank's local shard, ``sharding.on_local_shards``), then on plain
   tensors.  Gates: every loss within 2e-2 (relative) and every parameter
   leaf within 5e-2 (max-abs) of the plain run's (the reference test's
   bounds; every leaf's difference and whether the runs were bitwise are
   printed), losses and grad norms finite, every leaf of the DTensor run
   a DTensor, flash launched twice an attention layer a step and the
   RG-LRU scan three times an RG-LRU layer a step in each run, no other
   kernel and no plain version.  Each run prints its step seconds and
   peak memory.  (e) xlstm-125m at full width (d 768, 4 heads, mLSTM Dh
   384, chunk 256) cut to 2 layers, B 8 x S 256 (``ELASTIC``'s cut), the
   same way: the mLSTM on each rank's (batch, heads) shard, the sLSTM's
   loop on each rank's rows, mLSTM launches a forward per mLSTM layer a
   step and its recompute.  (c) decode: starcoder2-3b and
   recurrentgemma-9b at (a)'s and (b)'s cuts prefill ``S`` seeded tokens
   and take 8 decode steps (``SHARD_DECODE_STEPS``) fed seeded tokens, on
   DTensors (the KV cache laid out by ``kv_seq_mp``: whole on one rank,
   so the decode kernel runs on all of it and no merge runs) and on plain
   tensors, each run's counts set to 0 just before it: every step's
   logits and the cache's leaves bitwise (else within decode's bf16
   tolerance, the reason printed), flash once per attention layer, decode
   once per attention layer a step, the RG-LRU once per RG-LRU layer for
   the prefill and a step, nothing else; each run's prefill seconds and
   each decode step's ms (synchronised) are printed.  (d) the decode kernel with its
   log-sum-exp on M in (2, 4, 8) slot slices of a cache
   (``SHARD_MERGE``: zoo-rg9b's decode at lengths 2048 and 1000,
   internvl2-1b's Dh 64, a Dh 128 cache in f32 and bf16), merged by
   ``merge_partials``, against the whole-cache kernel and the plain
   version within ``ZOO_TOL``, and every log-sum-exp within 1e-5
   (relative) of the plain version's; then phase 8's decode row timed
   with the log-sum-exp off and on.  The group is destroyed at the end.

Near the end it prints one JSON line ``{"gates": {...}}`` with every
gate's numbers, then one ``{"kernels": [...]}`` line, then the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: The peaks of each H100 variant and every kernel's work and bound come
#: from ``repro_torch/kernels/cost.py`` (``PEAKS``, ``*_work``,
#: ``bound_ms``); this script passes in what it measures (the draw's
#: instructions per gap, ``_draw_ops``; the gaps a run's lanes read).

#: the reference's CPU figures for the largest MC-vs-model gaps on the MC
#: grid (512 trials): AlgoT time/energy, AlgoE time/energy.
_REF_GAPS = {"algo_t": (0.047, 0.033), "algo_e": (0.127, 0.111)}

SOURCES = ("event_sweep.cu", "quant_blockwise.cu", "rglru_scan.cu",
           "flash_attention.cu", "decode_attention.cu", "mlstm_scan.cu")
#: the files a kernel is built from, where its source includes a header.
KERNEL_FILES = {"flash_attention": ("flash_attention.cu", "hopper.cuh"),
                "quant_blockwise": ("quant_blockwise.cu", "hopper.cuh"),
                "decode_attention": ("decode_attention.cu", "hopper.cuh"),
                "rglru_scan": ("rglru_scan.cu", "hopper.cuh"),
                "mlstm_scan": ("mlstm_scan.cu", "hopper.cuh")}

N_TRIALS = 4096
T_BASE = 4000.0
#: (mu, rho) points of the model sweep and of the MC grid.
SWEEP_SHAPE = (1000, 1000)
MC_SHAPE = (32, 32)


#: xLSTM-125M's 22 parameter leaves (path, shape), all f32, in the
#: reference's flatten order: the runtime's default arch,
#: src/repro/configs/xlstm_125m.py at full width (173,090,352 parameters;
#: tests/test_torch_ckpt.py holds this table against the reference's
#: jax.eval_shape).  The checkpointed state is these, AdamW's m and v of
#: the same shapes, and an int32 step.
XLSTM_125M_LEAVES = (
    (("embed",), (50432, 768)),
    (("final_norm", "bias"), (768,)),
    (("final_norm", "scale"), (768,)),
    (("lm_head",), (768, 50432)),
    (("stages", 0, "ln1", "bias"), (6, 768)),
    (("stages", 0, "ln1", "scale"), (6, 768)),
    (("stages", 0, "mlstm", "b_if"), (6, 8)),
    (("stages", 0, "mlstm", "down"), (6, 1536, 768)),
    (("stages", 0, "mlstm", "up"), (6, 768, 1536)),
    (("stages", 0, "mlstm", "w_if"), (6, 768, 8)),
    (("stages", 0, "mlstm", "w_o"), (6, 768, 1536)),
    (("stages", 0, "mlstm", "wk"), (6, 1536, 1536)),
    (("stages", 0, "mlstm", "wq"), (6, 1536, 1536)),
    (("stages", 0, "mlstm", "wv"), (6, 1536, 1536)),
    (("stages", 1, "ln1", "bias"), (6, 768)),
    (("stages", 1, "ln1", "scale"), (6, 768)),
    (("stages", 1, "slstm", "b"), (6, 3072)),
    (("stages", 1, "slstm", "ffn_d"), (6, 1024, 768)),
    (("stages", 1, "slstm", "ffn_g"), (6, 768, 1024)),
    (("stages", 1, "slstm", "ffn_u"), (6, 768, 1024)),
    (("stages", 1, "slstm", "r"), (6, 4, 192, 768)),
    (("stages", 1, "slstm", "w"), (6, 768, 3072)),
)


def xlstm_state(make):
    """The checkpointed state ``(params, AdamWState(step, m, v, None))``
    with the structure of the reference's trainer state (dicts, the
    ``stages`` tuple, the empty ``tail``), each f32 leaf ``make(kind,
    shape)`` for kind in params/m/v and the step ``make("step", ())``."""
    import collections
    state_t = collections.namedtuple("AdamWState", "step m v master")

    def tree(kind):
        root: dict = {}
        for path, shape in XLSTM_125M_LEAVES:
            node = root
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = make(kind, shape)

        def fix(node):
            if not isinstance(node, dict):
                return node
            if all(isinstance(k, int) for k in node):
                return tuple(fix(node[i]) for i in range(len(node)))
            return {k: fix(v) for k, v in node.items()}
        out = fix(root)
        out["tail"] = ()
        return out
    return (tree("params"), state_t(step=make("step", ()), m=tree("m"),
                                    v=tree("v"), master=None))


def quant_cases():
    """(name, f32 numpy array) cases of the quantize parity check, from
    numpy seed 12: lognormal magnitudes with random signs at 4,096, 5,000
    (padded by 120) and 2^20 + 17 elements, one array of 128-lane groups
    with a NaN, a +inf, a -inf, all zeros, halfway ties at scale 1,
    subnormals, and the +-127 clip edge; and, drawn after them and listed
    before the special groups, leaves of 4,097 (a 1-element tail, padded
    by 511) and 300 elements (under 512, so rows of 128, padded by 84) and
    the special groups' first three (384 elements)."""
    import numpy as np
    rng = np.random.default_rng(12)

    def lognormal(n):
        sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        return (rng.lognormal(0.0, 1.0, n) * sign).astype(np.float32)
    groups = [lognormal(128) for _ in range(8)]
    groups[0][5] = np.nan
    groups[1][77] = np.inf
    groups[2][100] = -np.inf
    groups[3][:] = 0.0
    ties = groups[4]                   # max|x| = 127 -> scale exactly 1
    ties[:] = np.round(ties)
    ties[:8] = [127.0, 0.5, 1.5, -2.5, 126.5, -0.5, 2.5, -126.5]
    groups[5][:] = (rng.standard_normal(128) * 1e-39).astype(np.float32)
    groups[6][:64] = (rng.standard_normal(64) * 1e-40).astype(np.float32)
    groups[6][64] = 3e-38              # smallest normals beside subnormals
    clip = groups[7]
    clip[:4] = [127.00001, -127.00001, 126.99999, -126.99999]
    cases = [("lognormal_4096", lognormal(4096)),
             ("lognormal_5000_pad120", lognormal(5000)),
             ("lognormal_1048593", lognormal(2**20 + 17)),
             ("special_values", np.concatenate(groups))]
    return cases[:3] + [("lognormal_4097_pad511", lognormal(4097)),
                        ("lognormal_300_pad84", lognormal(300)),
                        ("special_values_384", np.concatenate(groups[:3])),
                        cases[3]]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=False)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi unavailable (rc {smi.returncode})"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    from repro_torch.kernels import cost
    return card, cost.PEAKS[cost.variant(torch.cuda.get_device_name(0))]


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> tuple:
    """Build every kernel source in parallel; returns seconds per source
    and the draw code's instructions per gap (``check_design``)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    def one(src):
        t0 = time.perf_counter()
        _build.build(src)
        return time.perf_counter() - t0
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        secs = dict(zip(SOURCES, ex.map(one, SOURCES)))
    for mod in _kernel_modules():
        mod.load_library()
    for src in SOURCES:
        log(f"build: {src} in {secs[src]:.3f} s")
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    return secs, check_design()


def _sass(src: str) -> str:
    import os
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", str(_build.library_path(src))],
                          capture_output=True, text=True, timeout=300,
                          check=False)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed on {src}: {proc.stderr[-500:]}")
    return proc.stdout


def _sass_function(sass: str, fragment: str) -> tuple:
    """(name, SASS) of the one function whose mangled name holds
    ``fragment``; fails unless exactly one does."""
    parts = [(p.split("\n", 1) + [""])[:2]
             for p in sass.split("Function : ")[1:]]
    found = [(head.strip(), body) for head, body in parts if fragment in head]
    if len(found) != 1:
        fail(f"{len(found)} functions of the SASS match {fragment!r}: "
             f"{[name for name, _ in found]}")
    return found[0]


#: SASS opcodes (before the first dot) by the unit that runs them: the f64
#: pipe, with its reciprocal seeds and the conversions that read or write
#: an f64, and the INT32 pipe.  Uniform-datapath (U...), memory and
#: control instructions count in neither.
_F64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
_F64_CONVERSIONS = ("F2F", "I2F", "F2I", "FRND")
_INT_OPS = ("IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
            "ISETP", "LEA", "IABS", "IMNMX", "SEL", "PRMT", "IMUL", "POPC",
            "FLO", "BREV", "SGXT", "BMSK", "I2I")


def _unit(op: str) -> str:
    """"f64", "int" or "" for a SASS opcode."""
    base = op.split(".")[0]
    if base in _F64_OPS or op.startswith(("MUFU.RCP64H", "MUFU.RSQ64H")) \
            or (base in _F64_CONVERSIONS and "F64" in op):
        return "f64"
    return "int" if base in _INT_OPS else ""


#: the processes the main path samples (``Kind`` in event_sweep.cu), whose
#: draw code ``_draw_ops`` counts.
MAIN_KINDS = {0: "exponential", 1: "weibull"}


def _branch_target(text: str):
    """The address a SASS branch (``@P0 BRA P1, 0x1440``) jumps to, or
    None."""
    import re
    m = re.match(r"(?:@!?U?P\w+\s+)?BRA\b.*?(0x[0-9a-f]+)$", text)
    return int(m.group(1), 16) if m else None


def _draw_ops(sass: str) -> dict:
    """{kind: (INT32, f64) instructions per gap} of the draw, executed on
    the common path, counted in the SASS of ``event_draws_kernel<kind>``
    for the ``MAIN_KINDS``.  Its inner loop (from the head to the
    back-branch, the shortest backward branch) draws a pair of gaps per
    trip, one Philox call and two transforms, so its count is halved.  Not
    counted: the prologue and the first trip, which the compiler peels;
    subroutines (the f64 divide's slow path); register moves (IMAD.MOV);
    predicated instructions (the special-case fixups of log and of the
    subnormal scaling); and every block that a forward branch inside the
    loop skips when the block itself (its nested blocks apart) calls a
    subroutine or has an unpredicated infinity or NaN operand: the
    divide's slow-path call and exp's out-of-range fixup.  The stores'
    addresses and the loop's test stay in, a few per pair.  Where a
    process's draw has an if/else of two common arms (ndtri's central and
    tail ranges), this rule would count both, so only the main path's
    kinds are counted."""
    import re
    funcs, kind = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"event_draws_kernelILi(\d)E", m.group(1))
            kind = int(k.group(1)) if k else None
            if kind in MAIN_KINDS:
                funcs[kind] = []
            continue
        a = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if kind in MAIN_KINDS and a:
            funcs[kind].append((int(a.group(1), 16), a.group(2)))
    out = {}
    for kind, code in funcs.items():
        back = [(a, t) for a, text in code
                for t in [_branch_target(text)] if t is not None and t < a]
        if not back:
            continue
        end, head = min(back, key=lambda x: x[0] - x[1])
        body = [(a, text) for a, text in code if head <= a < end]
        # blocks a forward branch skips: (first address, branch target)
        arms = [(a + 16, t) for a, text in body
                for t in [_branch_target(text)]
                if text.startswith("@") and t is not None and a < t <= end]

        def nested(arm, a):
            return any(o != arm and arm[0] <= o[0] and o[1] <= arm[1]
                       and o[0] <= a < o[1] for o in arms)
        cold = [arm for arm in arms if any(
            text.startswith("CALL") or (not text.startswith("@") and
                                        re.search(r"INF|QNAN", text))
            for a, text in body
            if arm[0] <= a < arm[1] and not nested(arm, a))]
        units = [_unit(text.split()[0]) for a, text in body
                 if not text.startswith(("@", "IMAD.MOV"))
                 and not any(s <= a < e for s, e in cold)]
        out[kind] = (units.count("int") / 2.0, units.count("f64") / 2.0)
    return out


#: SASS instructions that show a kernel's design: HGMMA (wgmma), UTMALDG
#: (TMA tile loads), UBLKCP (1-D bulk copies); each source must hold the
#: ones listed.
DESIGN_SASS = {"flash_attention.cu": ("HGMMA", "UTMALDG"),
               "decode_attention.cu": ("UBLKCP",),
               "mlstm_scan.cu": ("HGMMA",),
               "rglru_scan.cu": ("UTMALDG",),
               "quant_blockwise.cu": ("UBLKCP",)}
#: kernels that must each hold their source's design instructions
#: themselves: both quant kernels, and the bf16 flash kernel at each head
#: width.  The fragments carry the mangled name's length prefix, so that
#: one kernel's name cannot match inside the other's.
DESIGN_KERNELS = {"quant_blockwise.cu": ("22quantize_leaves_kernel",
                                         "24dequantize_leaves_kernel"),
                  "flash_attention.cu": ("18flash_wgmma_kernelILi64E",
                                         "18flash_wgmma_kernelILi128E",
                                         "18flash_wgmma_kernelILi256E")}
#: kernels that must compile without spilling registers (the Dh 64
#: instantiations of flash's f32 route and of decode by their mangled
#: template arguments).
NO_SPILL = ("flash_wgmma_kernel", "event_sweep_kernel", "event_draws_kernel",
            "rglru_ring_kernel", "gates_kernel", "state_kernel",
            "scores_kernel", "output_kernel", "quantize_leaves_kernel",
            "dequantize_leaves_kernel", "12flash_kernelILi64E",
            "13decode_kernelILi64E")


def _spills(log_text: str) -> dict:
    """{kernel symbol: spill-store bytes} from a ptxas -v report."""
    import re
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            out[fn] = int(m.group(1))
    return out


def check_design() -> dict:
    """Count the design's instructions in the SASS of the libraries in
    ``DESIGN_SASS`` (cuobjdump), and the spills of the kernels in
    ``NO_SPILL``; fail when one is missing or one spills.  Returns the event library's
    draw instructions per gap (``_draw_ops``)."""
    from repro_torch.kernels import _build
    for src, wanted in DESIGN_SASS.items():
        sass = _sass(src)
        counts = {op: sum(1 for line in sass.splitlines() if op in line)
                  for op in ("HGMMA", "UTMALDG", "UBLKCP")}
        log(f"sass {src}: {counts}")
        missing = [op for op in wanted if counts[op] == 0]
        if missing:
            fail(f"{src} has no {missing} in its SASS")
        for kernel in DESIGN_KERNELS.get(src, ()):
            name, body = _sass_function(sass, kernel)
            have = {op: body.count(op) for op in wanted}
            log(f"sass {src} {kernel} (matched {name}): {have}")
            if not all(have.values()):
                fail(f"{kernel} lacks its design instructions {wanted}")
    for src in SOURCES:
        spills = {fn: n for fn, n in _spills(_build.build_log(src)).items()
                  if any(k in fn for k in NO_SPILL)}
        log(f"spill stores {src}: {len(spills)} kernels checked, "
            f"{sum(1 for n in spills.values() if n)} spill")
        if any(spills.values()):
            fail(f"{src}: a kernel that must not spill does {spills}")
    draw = _draw_ops(_sass("event_sweep.cu"))
    log("sass event_sweep.cu draw code, instructions per gap on its common "
        "path (INT32, f64): " + ", ".join(
            f"{MAIN_KINDS[k]} {v}" for k, v in sorted(draw.items())))
    if sorted(draw) != sorted(MAIN_KINDS) or min(
            min(v) for v in draw.values()) <= 0:
        fail(f"event_draws_kernel's loop not found in the SASS: {draw}")
    return draw


# ---------------------------------------------------------------------------
# 3. kernel vs plain version on the card
# ---------------------------------------------------------------------------

def _compare(a: dict, b: dict) -> tuple:
    """(bitwise equal, max abs float difference) over the 8 outputs."""
    import torch
    equal, err = True, 0.0
    for k in a:
        x, y = a[k], b[k]
        if not torch.equal(x, y):
            equal = False
        if x.dtype == torch.float64:
            finite = torch.isfinite(x) & torch.isfinite(y)
            if bool(finite.any()):
                err = max(err, float((x - y)[finite].abs().max()))
    return equal, err


def _parity_cases(dev):
    import numpy as np
    import torch
    from repro_torch.sim import get_scenario, grid_from_scenarios
    rng = np.random.default_rng(2024)
    scens = [get_scenario("fig12", mu_min=120.0),
             get_scenario("exascale_rho7", mu_min=300.0),
             get_scenario("fig12", mu_min=600.0),
             get_scenario("fig3", n_nodes=1e6)]
    grid = grid_from_scenarios(scens, device=dev)
    mu = grid.mu.cpu().numpy()
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64),
                                  device=dev)
    cases = []
    # (a) dyadic schedule: every quantity exactly representable
    g = rng.exponential(1.0, size=(4, 256, 256)) * mu[:, None, None]
    g = np.maximum(np.round(g * 2.0**16) / 2.0**16, 2.0**-16)
    cases.append(("dyadic", grid, t([40.0, 60.0, 80.0, 14.0]), 500.0,
                  t(g), 257))
    # (b) ragged shape, ordinary exponential schedule
    pick = np.arange(37) % 4
    sub = grid.take(torch.as_tensor(pick, device=dev))
    g = rng.exponential(1.0, size=(37, 333, 200)) * mu[pick][:, None, None]
    T = np.array([40.0, 60.0, 80.0, 14.0])[pick] * (1 + 0.01 * np.arange(37))
    cases.append(("ragged", sub, t(T), 3000.0, t(g), 257))
    # (c) exhaustion (two short gaps) and truncation (two steps only)
    one = grid.take(torch.as_tensor([2], device=dev))
    cases.append(("exhaustion", one, t([60.0]), 4000.0,
                  t(np.array([[[50.0, 70.0]]])), 3))
    g = rng.exponential(1.0, size=(1, 4, 64)) * mu[2]
    cases.append(("truncation", one, t([60.0]), 50000.0, t(g), 2))
    return cases


def phase_parity(dev) -> float:
    import torch
    from repro_torch.kernels.event_sweep import event_sweep, event_sweep_plain
    from repro_torch.sim import COMPENSATED_F32, F64
    max_err = 0.0
    before = event_sweep.launches
    for name, grid, T, T_base, gaps, n_steps in _parity_cases(dev):
        for pol in (F64, COMPENSATED_F32):
            c = pol.cast
            args = (c(T), c(grid.C), c(grid.R), c(grid.D), c(grid.omega),
                    c(torch.full_like(T, T_base)), c(gaps))
            kw = dict(n_steps=n_steps, compensated=pol.compensated)
            ker = event_sweep(*args, **kw)
            ref = event_sweep_plain(*args, **kw)
            bfn = event_sweep(*args[:6], trial_major(gaps, pol.torch_dtype),
                              **kw)
            torch.cuda.synchronize()
            equal, err = _compare(ker, ref)
            layouts, _ = _compare(bfn, ker)
            max_err = max(max_err, err)
            flags = (f"exhausted={int(ker['gaps_exhausted'].sum())} "
                     f"truncated={int(ker['truncated'].sum())}")
            log(f"parity {name:10s} {pol.name:15s} shape "
                f"{tuple(gaps.shape)}: bitwise={equal} max_abs_err={err} "
                f"(B, F, N) layout bitwise={layouts} {flags}")
            if not (equal and layouts):
                fail(f"kernel != plain version on {name}/{pol.name}")
            if name == "exhaustion" and not bool(ker["gaps_exhausted"].all()):
                fail("exhaustion case did not flag gaps_exhausted")
            if name == "truncation" and not bool(ker["truncated"].any()):
                fail("truncation case did not flag truncated")
    if event_sweep.launches <= before:
        fail("the launch counter did not increase")
    return max_err


def _sampled_processes():
    from repro_torch.core import Exponential, LogNormal, TraceReplay, Weibull
    return (Exponential(), Weibull(shape=0.7), LogNormal(sigma=1.0),
            TraceReplay(gaps=(40.0, 500.0, 120.0, 90.0, 800.0, 33.0)))


def _ulps(a, b):
    """(largest ulp difference, differing elements) of two f64 tensors of
    positive finite values."""
    import torch
    d = (a.contiguous().view(torch.int64)
         - b.contiguous().view(torch.int64)).abs()
    return int(d.max()) if d.numel() else 0, int((d != 0).sum())


def phase_sampled_parity(dev) -> dict:
    """The sampled event kernel (gaps drawn inside it) on the small cases:
    its draws against ``sample_gaps``, the sweep against the explicit
    kernel and the plain version on those draws, both policies.  Returns
    the draw differences per process and the largest float difference."""
    import numpy as np
    import torch
    from repro_torch.core.philox import CounterKey
    from repro_torch.kernels import event_sweep as es
    from repro_torch.sim import COMPENSATED_F32, F64
    _, grid, *_ = _parity_cases(dev)[0]
    pick = torch.as_tensor(np.arange(37) % 4, device=dev)
    rows = grid.take(pick)
    one = grid.take(torch.as_tensor([2], device=dev))
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)
    T37 = t(np.array([40.0, 60.0, 80.0, 14.0])[pick.cpu().numpy()]
            * (1 + 0.01 * np.arange(37)))
    # (name, rows, T, T_base, global points, trial0, N, capacity, n_steps,
    # seed): points and trials past 2^16, a point past 2^32 (its high word
    # is a counter word), a seed past 2^32
    cases = [("ragged", rows, T37, 3000.0,
              70_000 + 1_000 * torch.arange(37, device=dev), 65_530, 333,
              256, 257, 7),
             ("exhaustion", one, t([60.0]), 40000.0,
              torch.tensor([2**32 + 5], device=dev), 0, 64, 2, 3,
              2**33 + 5),
             ("truncation", one, t([60.0]), 50000.0,
              torch.tensor([2**31 - 3], device=dev), 9, 4, 64, 2, 11)]
    report, max_err = {}, 0.0
    before = (es.event_sweep_sampled.launches, es.event_draws.launches)
    for proc in _sampled_processes():
        worst, n_diff, n_all = 0, 0, 0
        for (name, g, T, T_base, points, trial0, N, F, n_steps,
             seed) in cases:
            mean = torch.as_tensor(proc.resolve_mean(g.mu.cpu().numpy()),
                                   dtype=torch.float64, device=dev)
            spec = proc.gap_spec(mean, len(points), dev)
            kw = dict(seed=seed, points=points, trial0=trial0, n_trials=N,
                      spec=spec, capacity=F)
            draws = es.event_draws(**kw)
            key = CounterKey(seed, points, torch.arange(
                trial0, trial0 + N, device=dev))
            want = proc.sample_gaps(key, (len(points), N, F),
                                    mean=mean, device=dev)
            torch.cuda.synchronize()
            ulps = _ulps(draws, want)
            rel = float(((draws - want).abs() / want).max())
            worst, n_diff, n_all = (max(worst, ulps[0]), n_diff + ulps[1],
                                    n_all + want.numel())
            log(f"parity draws {proc.name:11s} {name:10s} "
                f"{(len(points), N, F)}: largest ulp difference {ulps[0]}, "
                f"differing gaps {ulps[1]} of {want.numel()}, max rel {rel}")
            exact = proc.name in ("exponential", "trace")
            if (exact and ulps[1]) or not rel <= 1e-12:
                fail(f"in-kernel draws off sample_gaps for {proc.name}")
            for pol in (F64, COMPENSATED_F32):
                c = pol.cast
                args = (c(T), c(g.C), c(g.R), c(g.D), c(g.omega),
                        c(torch.full_like(T, T_base)))
                sk = dict(n_steps=n_steps, compensated=pol.compensated)
                fused = es.event_sweep_sampled(*args, **kw, **sk)
                gaps = draws.to(pol.torch_dtype)      # the (B, F, N) layout
                expl = es.event_sweep(*args, gaps, **sk)
                bnf = es.event_sweep(*args, gaps.contiguous(), **sk)
                plain = es.event_sweep_plain(*args, gaps, **sk)
                torch.cuda.synchronize()
                eq = [_compare(fused, x)[0] for x in (expl, bnf, plain)]
                err = max(_compare(fused, x)[1] for x in (expl, plain))
                max_err = max(max_err, err)
                flags = (f"exhausted={int(fused['gaps_exhausted'].sum())} "
                         f"truncated={int(fused['truncated'].sum())}")
                log(f"parity sampled {proc.name:11s} {name:10s} "
                    f"{pol.name:15s}: bitwise vs explicit (B, F, N)="
                    f"{eq[0]}, (B, N, F)={eq[1]}, plain={eq[2]} {flags}")
                if not all(eq):
                    fail(f"sampled kernel != explicit kernel / plain version "
                         f"on {proc.name}/{name}/{pol.name}")
                if name == "exhaustion" and not bool(
                        fused["gaps_exhausted"].all()):
                    fail("sampled exhaustion case did not run dry")
                if name == "truncation" and not bool(
                        fused["truncated"].any()):
                    fail("sampled truncation case did not truncate")
        report[proc.name] = {"max_ulps": worst, "gaps_differing": n_diff,
                             "gaps": n_all}
    if (es.event_sweep_sampled.launches, es.event_draws.launches) <= before:
        fail("the sampled kernel's launch counters did not increase")
    report["max_abs_err"] = max_err
    return report


def trial_major(gaps, dtype):
    """A ``(B, N, F)`` schedule in ``dtype`` as a view of a ``(B, F,
    N)``-contiguous copy (one copy, cast included): the layout in which a
    warp's reads of the explicit kernel coalesce."""
    import torch
    B, N, F = gaps.shape
    out = torch.empty((B, F, N), dtype=dtype, device=gaps.device)
    out.copy_(gaps.transpose(1, 2))
    return out.transpose(1, 2)


def _bits_equal(a, b) -> bool:
    """Bitwise equality of two tensors; NaNs compare as NaN (the card's
    NaN payload is its own)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(torch.where(nan, 0.0, a).view(torch.int32),
                            torch.where(nan, 0.0, b).view(torch.int32)))


def _max_abs(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b)[ok].abs().max()) if bool(ok.any()) else 0.0


def phase_quant_parity(dev) -> tuple:
    """Quantize/dequantize kernels against their plain versions on the card,
    bitwise, on every ``quant_cases()`` array: one leaf a launch (the
    one-entry wrappers), then all of them in one launch, in the cases'
    order and reversed, and each alone through the grouped wrappers (a
    one-row table, passed by value, on the unpadded leaf), each leaf also
    equal to its one-entry result; returns the largest absolute
    differences (quantize, dequantize)."""
    import torch
    from repro_torch.kernels import ops, quant_blockwise as qb
    err_q = err_d = 0.0
    before = (qb.quantize.launches, qb.dequantize.launches)
    cases = quant_cases()
    single = []
    for name, x in cases:
        t = torch.from_numpy(x).to(dev)
        q, s, pad = ops.quantize_array(t)
        x2 = torch.cat([t, t.new_zeros(pad)]).reshape(q.shape)
        pq, ps = qb.quantize_plain(x2)
        d, pd = qb.dequantize(q, s), qb.dequantize_plain(q, s)
        torch.cuda.synchronize()
        ok = (_bits_equal(q, pq), _bits_equal(s, ps), _bits_equal(d, pd))
        err_q = max(err_q, _max_abs(q, pq), _max_abs(s, ps))
        err_d = max(err_d, _max_abs(d, pd))
        log(f"parity quant {name:22s} {tuple(q.shape)} pad {pad}: q "
            f"bitwise={ok[0]} scales bitwise={ok[1]} dequant "
            f"bitwise={ok[2]} nan scales {int(torch.isnan(s).sum())} "
            f"inf scales {int(torch.isinf(s).sum())}")
        if not all(ok):
            fail(f"quant kernels != plain versions on {name}")
        single.append((t, q, s, pad, d.reshape(-1)[:x.size].reshape(x.shape)))
    if (qb.quantize.launches, qb.dequantize.launches) <= before:
        fail("the quant launch counters did not increase")

    before = (qb.quantize_leaves.launches, qb.dequantize_leaves.launches)
    n = len(cases)
    for label, order in (("in order", range(n)),
                         ("reversed", range(n - 1, -1, -1))):
        xs = [single[i][0] for i in order]
        q, s, leaves = qb.quantize_leaves(xs)
        pq, ps, _ = qb.quantize_leaves_plain(xs)
        args = ([v[0] for v in leaves], [v[1] for v in leaves],
                [x.shape for x in xs], [v[2] for v in leaves])
        d = qb.dequantize_leaves(*args)
        pd = qb.dequantize_leaves_plain(*args)
        torch.cuda.synchronize()
        ok = (_bits_equal(q, pq), _bits_equal(s, ps),
              all(_bits_equal(a, b) for a, b in zip(d, pd)),
              all(_bits_equal(lq, one[1]) and _bits_equal(ls, one[2])
                  and lp == one[3] and _bits_equal(a, one[4])
                  for one, (lq, ls, lp), a in zip(
                      (single[i] for i in order), leaves, d)))
        err_q = max(err_q, _max_abs(q, pq), _max_abs(s, ps))
        err_d = max([err_d] + [_max_abs(a, b) for a, b in zip(d, pd)])
        log(f"parity quant, {n} leaves in one launch ({label}): "
            f"{s.numel()} groups; q bitwise={ok[0]} scales bitwise={ok[1]} "
            f"dequant bitwise={ok[2]}; every leaf equal to its one-entry "
            f"result={ok[3]}")
        if not all(ok):
            fail(f"grouped quant kernels != plain versions ({label})")
    for (name, _), (t, q1, s1, pad1, d1) in zip(cases, single):
        (lq, ls, lp), = qb.quantize_leaves([t])[2]
        a, = qb.dequantize_leaves([lq], [ls], [t.shape], [lp])
        torch.cuda.synchronize()
        if not (_bits_equal(lq, q1) and _bits_equal(ls, s1) and lp == pad1
                and _bits_equal(a, d1)):
            fail(f"a one-row grouped launch != the one-entry result on "
                 f"{name}")
    log(f"parity quant, each of the {n} leaves alone through the grouped "
        f"wrappers (one row by value): equal to its one-entry result")
    if (qb.quantize_leaves.launches, qb.dequantize_leaves.launches) != (
            before[0] + 2 + n, before[1] + 2 + n):
        fail("the grouped quant kernels did not launch once a call")
    return err_q, err_d


# ---------------------------------------------------------------------------
# 4 + 5. the main path
# ---------------------------------------------------------------------------

def _sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_main_path(dev):
    """Drive the main path once; returns everything the gates and the
    timing phase need.  Counters are read by the caller around it."""
    import numpy as np
    from repro_torch.core import Exponential, Weibull
    from repro_torch.sim import (COMPENSATED_F32, F64, evaluate_grid,
                                 mu_rho_grid, simulate_trajectories)
    big = mu_rho_grid(np.linspace(30, 600, SWEEP_SHAPE[0]),
                      np.linspace(1, 10, SWEEP_SHAPE[1]), device=dev)
    sweeps = {}
    for pol in (F64, COMPENSATED_F32):
        sweeps[pol.name], secs = _sync_time(
            lambda: evaluate_grid(big, precision=pol, device=dev))
        log(f"evaluate_grid 1e6 points [{pol.name}]: {secs:.4f} s (cold)")

    mc_grid = mu_rho_grid(np.geomspace(120, 1200, MC_SHAPE[0]),
                          np.linspace(2, 10, MC_SHAPE[1]), device=dev)
    model = evaluate_grid(mc_grid, T_base=T_BASE, precision=F64, device=dev)
    runs = {}
    for proc in (Exponential(), Weibull(shape=0.7)):
        for pol in (F64, COMPENSATED_F32):
            for algo, T in (("algo_t", model.T_time),
                            ("algo_e", model.T_energy)):
                key = (proc.name, pol.name, algo)
                runs[key], secs = _sync_time(lambda: simulate_trajectories(
                    T, mc_grid, T_base=T_BASE, n_trials=N_TRIALS, seed=7,
                    process=proc, precision=pol, device=dev))
                log(f"simulate_trajectories {key}: {secs:.4f} s (cold)")
    return big, sweeps, mc_grid, model, runs


def gate_sweep(big, sweeps) -> None:
    import torch
    from repro_torch.sim import COMPENSATED_F32
    from repro_torch.sim.sweep import energy_final_batched, time_final_batched
    r64, r32 = sweeps["f64"], sweeps["compensated_f32"]
    if not torch.equal(r64.valid, r32.valid):
        fail("evaluate_grid: valid masks differ between policies")
    valid = r64.valid.reshape(-1)
    p = {k: v.reshape(-1)[valid] for k, v in big.fields().items()}
    pol = COMPENSATED_F32
    for name, objective in (("T_time", time_final_batched),
                            ("T_energy", energy_final_batched)):
        T64 = getattr(r64, name).reshape(-1)[valid]
        T32 = getattr(r32, name).reshape(-1)[valid]
        arg = float(((T32 - T64).abs() / T64.abs()).max())
        f32 = objective(T32, p, 1.0)
        f64 = objective(T64, p, 1.0)
        obj = float(((f32 - f64).abs() / f64.abs()).max())
        log(f"sweep gate {name}: valid points {int(valid.sum())}, max "
            f"argmin rel {arg:.3e} (<= {pol.argmin_rtol}), max objective "
            f"rel {obj:.3e} (<= {pol.objective_tol})")
        if not (arg <= pol.argmin_rtol and obj <= pol.objective_tol):
            fail(f"compensated evaluate_grid outside its gates on {name}")


def _oracle_lanes(mc_grid, T, n_lanes: int = 72, n_trials: int = N_TRIALS):
    """(point, trial) lanes for the oracle: the smallest-mu and the
    largest-T points first, then a spread over the grid."""
    import numpy as np
    mu = mc_grid.mu.reshape(-1).cpu().numpy()
    Tn = T.reshape(-1).cpu().numpy()
    pts = [int(np.argmin(mu)), int(np.argmax(Tn)),
           int(np.argmax(mu)), int(np.argmin(Tn))]
    pts += [int(i) for i in np.linspace(0, mu.size - 1, 5).astype(int)]
    pts = list(dict.fromkeys(pts))
    per = -(-n_lanes // len(pts))
    trials = np.linspace(0, n_trials - 1, per).astype(int)
    return [(p, int(t)) for p in pts for t in trials]


def _oracle_check(mc_grid, T, tb, rows: dict, label) -> tuple:
    """Replay each lane's gap row through the scalar oracle
    ``simulate_once(gaps=...)`` and hold the batch's outputs to it: floats
    within 1e-12 relative, equal failure counts, checkpoint counts within
    one.  Returns (largest float difference, checkpoint-count ties)."""
    from repro_torch.core import simulate_once
    flat = mc_grid.ravel()
    Tn = T.reshape(-1).cpu().numpy()
    n = tb.wall_time.shape[-1]
    out = {f: getattr(tb, f).reshape(flat.size, n)
           for f in ("wall_time", "energy", "work_executed", "io_time",
                     "down_time", "n_failures", "n_checkpoints")}
    worst, ckpt_ties = 0.0, 0
    for (p, t), row in rows.items():
        ref = simulate_once(float(Tn[p]), flat.ckpt_at(p), flat.power_at(p),
                            T_BASE, gaps=row)
        for f in ("wall_time", "energy", "work_executed", "io_time",
                  "down_time"):
            got = float(out[f][p, t])
            want_v = getattr(ref, f)
            rel = abs(got - want_v) / max(abs(want_v), 1e-300)
            worst = max(worst, rel)
        if int(out["n_failures"][p, t]) != ref.n_failures:
            fail(f"oracle: n_failures differ at {label + (p, t)}")
        dc = abs(int(out["n_checkpoints"][p, t]) - ref.n_checkpoints)
        if dc > 1:
            fail(f"oracle: n_checkpoints differ by {dc} at "
                 f"{label + (p, t)}")
        ckpt_ties += dc
    return worst, ckpt_ties


def gate_mc(mc_grid, model, runs, dev) -> dict:
    import torch
    from repro_torch.core import Exponential, Weibull
    from repro_torch.sim import sampled_schedules
    report = {}
    for key, tb in runs.items():
        bad = int(tb.truncated.sum()) + int(tb.gaps_exhausted.sum())
        if bad:
            fail(f"{key}: {bad} truncated or exhausted lanes")
    procs = {"exponential": Exponential(), "weibull": Weibull(shape=0.7)}
    for (pname, polname, algo), tb in runs.items():
        if polname != "f64":
            continue
        T = model.T_time if algo == "algo_t" else model.T_energy
        lanes = _oracle_lanes(mc_grid, T)
        want = {}
        for p, t in lanes:
            want.setdefault(p, []).append(t)
        rows = {}
        for blk in sampled_schedules(T, mc_grid, T_BASE, N_TRIALS, seed=7,
                                     process=procs[pname], device=dev):
            pts = blk.points.cpu().numpy()
            for i, p in enumerate(pts):
                for t in want.get(int(p), ()):
                    if t in blk.trials:
                        rows[(int(p), t)] = blk.gaps[
                            i, t - blk.trials.start].cpu().numpy()
        worst, ckpt_ties = _oracle_check(mc_grid, T, tb, rows,
                                         (pname, algo))
        log(f"oracle {pname}/{algo}: {len(rows)} lanes, max float rel "
            f"{worst:.3e} (<= 1e-12), n_checkpoints ties {ckpt_ties}")
        if len(rows) < 64 or worst > 1e-12:
            fail(f"oracle check failed for {(pname, algo)}")
        report[f"oracle/{pname}/{algo}"] = {"lanes": len(rows),
                                           "max_rel": worst,
                                           "ckpt_ties": ckpt_ties}

    # The compensated runs read the same f64 draws cast to f32.  Rounding a
    # gap or a period to f32 moves a failure by ~1 f32 ulp; one that lands
    # that close to a completion or checkpoint boundary falls on the other
    # side (a checkpoint commits in one run and not in the other, and the
    # lane's wall time jumps by about a period).  Such "flipped" lanes are
    # counted and bounded (<= 1e-3 of lanes); every other lane agrees to
    # 1e-5 relative, and so do the per-point means over those lanes.  The
    # unfiltered per-point means are held to a tenth of the MC standard
    # error.
    fields = ("wall_time", "energy", "work_executed", "io_time")
    for pname in procs:
        for algo in ("algo_t", "algo_e"):
            a = runs[(pname, "f64", algo)]
            b = runs[(pname, "compensated_f32", algo)]
            lane_rel = torch.stack([
                (getattr(b, f) - getattr(a, f)).abs() / getattr(a, f).abs()
                for f in fields]).amax(0)
            same = lane_rel <= 1e-5
            flipped = int((~same).sum())
            n_same = same.sum(-1)
            rels, raw, se_ratio = [], [], []
            for f in fields:
                x, y = getattr(a, f), getattr(b, f)
                ma = torch.where(same, x, 0.0).sum(-1) / n_same
                mb = torch.where(same, y, 0.0).sum(-1) / n_same
                rels.append(float(((mb - ma).abs() / ma.abs()).max()))
                d = (y.mean(-1) - x.mean(-1)).abs()
                raw.append(float((d / x.mean(-1).abs()).max()))
                se = x.std(-1) / math.sqrt(x.shape[-1])
                se_ratio.append(float((d / se).max()))
            lanes = a.n_failures.numel()
            log(f"compensated vs f64 {pname}/{algo}: {flipped} of {lanes} "
                f"lanes flipped (<= 1e-3 of lanes); max per-point mean rel "
                f"{max(rels):.3e} over the others (<= 1e-5); unfiltered "
                f"{max(raw):.3e} = {max(se_ratio):.3e} standard errors "
                f"(<= 0.1)")
            if (flipped > 1e-3 * lanes or max(rels) > 1e-5
                    or max(se_ratio) > 0.1):
                fail(f"compensated MC off f64 for {(pname, algo)}")
            report[f"compensated/{pname}/{algo}"] = {
                "lanes_flipped": flipped, "max_mean_rel": max(rels),
                "max_mean_rel_unfiltered": max(raw),
                "max_mean_diff_in_se": max(se_ratio)}

    for pname in procs:
        for algo, Tf, E in (("algo_t", model.Tf_time, model.E_time),
                            ("algo_e", model.Tf_energy, model.E_energy)):
            tb = runs[(pname, "f64", algo)]
            gt = float(((tb.wall_time.mean(-1) - Tf).abs() / Tf).max())
            ge = float(((tb.energy.mean(-1) - E).abs() / E).max())
            rt, re_ = _REF_GAPS[algo]
            log(f"MC-vs-model gap {pname}/{algo}: time {gt:.4f}, energy "
                f"{ge:.4f} (reference CPU, exponential, 512 trials: "
                f"{rt}, {re_}) — reported, not gated")
            report[f"model_gap/{pname}/{algo}"] = {"time": gt, "energy": ge}
    torch.cuda.synchronize()
    return report


def _gap_fingerprint(gaps):
    """Per-lane exact fingerprint of a (P, N, F) f64 schedule: the sums
    over j of (j + 1) times each 16-bit chunk of gap j's bits (integer
    sums, so the summation order cannot change them)."""
    import torch
    bits = gaps.contiguous().view(torch.int64)
    w = torch.arange(1, bits.shape[-1] + 1, dtype=torch.int64,
                     device=bits.device)
    return torch.stack([(((bits >> (16 * c)) & 0xFFFF) * w).sum(-1)
                        for c in range(4)], dim=-1)


def phase_dispatch_invariance(mc_grid, model, dev) -> dict:
    """Auto-sampled gaps and results under three DispatchConfigs, on
    Weibull(0.7) at the AlgoE periods: every lane's schedule and every
    output must be bitwise equal."""
    import torch
    from repro_torch.core import Weibull
    from repro_torch.sim import (F64, DispatchConfig, sampled_schedules,
                                 simulate_trajectories)
    kw = dict(T_base=T_BASE, n_trials=N_TRIALS, seed=7,
              process=Weibull(shape=0.7), device=dev)
    T = model.T_energy
    fps, outs, blocks = [], [], []
    cfgs = (DispatchConfig(), DispatchConfig(chunk=7),
            DispatchConfig(memory_mb=64))
    for cfg in cfgs:
        fp = torch.full((mc_grid.size, N_TRIALS, 4), -1, dtype=torch.int64,
                        device=dev)
        n = 0
        for blk in sampled_schedules(T, mc_grid, dispatch=cfg, **kw):
            fp[blk.points[:, None], torch.arange(
                blk.trials.start, blk.trials.stop, device=dev)] = \
                _gap_fingerprint(blk.gaps)
            n += 1
        fps.append(fp)
        blocks.append(n)
        outs.append(simulate_trajectories(T, mc_grid, dispatch=cfg,
                                          precision=F64, **kw))
    if bool((fps[0] < 0).any()):
        fail("dispatch check: some lane was never sampled")
    gaps_equal = all(torch.equal(fps[0], f) for f in fps[1:])
    fields = ("wall_time", "energy", "work_executed", "io_time",
              "down_time", "n_failures", "n_checkpoints", "truncated",
              "gaps_exhausted")
    outs_equal = all(torch.equal(getattr(outs[0], f), getattr(o, f))
                     for o in outs[1:] for f in fields)
    log(f"dispatch check weibull/f64/algo_e: blocks {blocks} for "
        f"DispatchConfig(), chunk=7, memory_mb=64; lane gaps bitwise equal "
        f"{gaps_equal}; simulate_trajectories outputs bitwise equal "
        f"{outs_equal}")
    if not (gaps_equal and outs_equal):
        fail("auto-sampled MC depends on the DispatchConfig")
    return {"blocks": blocks, "gaps_equal": gaps_equal,
            "outputs_equal": outs_equal}


#: the explicit-schedule MC call: its trials and the seed of the caller's
#: schedule (a torch.Generator on the card).
EXPLICIT_TRIALS = 512
EXPLICIT_SEED = 2028


def explicit_schedule(mc_grid, model, dev):
    """(T, gaps): the AlgoE periods and a caller's (1024, 512, F) f64
    Exponential schedule at the worst point's capacity F, drawn on the
    card from ``EXPLICIT_SEED``."""
    import torch
    from repro_torch.sim import default_fail_capacity
    T = model.T_energy
    F = default_fail_capacity(T.reshape(-1), mc_grid.ravel(), T_BASE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(EXPLICIT_SEED)
    gaps = torch.empty((mc_grid.size, EXPLICIT_TRIALS, F),
                       dtype=torch.float64, device=dev)
    gaps.exponential_(generator=gen)
    gaps *= mc_grid.mu.reshape(-1, 1, 1)
    return T, gaps


def run_explicit_path(mc_grid, T, gaps, dev):
    """The caller's schedule through ``simulate_trajectories(gaps=...)``
    (f64): the explicit kernel on its (B, F, N) copies."""
    from repro_torch.sim import F64, simulate_trajectories
    tb, secs = _sync_time(lambda: simulate_trajectories(
        T, mc_grid, T_base=T_BASE, gaps=gaps, precision=F64, device=dev))
    log(f"simulate_trajectories explicit schedule {tuple(gaps.shape)}: "
        f"{secs:.4f} s (cold)")
    return tb


def gate_explicit(mc_grid, T, gaps, tb) -> dict:
    """No truncated or exhausted lane; the oracle lanes at 1e-12."""
    bad = int(tb.truncated.sum()) + int(tb.gaps_exhausted.sum())
    if bad:
        fail(f"explicit schedule: {bad} truncated or exhausted lanes")
    lanes = _oracle_lanes(mc_grid, T, n_trials=gaps.shape[1])
    rows = {(p, t): gaps[p, t].cpu().numpy() for p, t in lanes}
    worst, ties = _oracle_check(mc_grid, T, tb, rows, ("explicit",))
    log(f"oracle explicit schedule: {len(rows)} lanes, max float rel "
        f"{worst:.3e} (<= 1e-12), n_checkpoints ties {ties}")
    if len(rows) < 64 or worst > 1e-12:
        fail("oracle check failed for the explicit schedule")
    return {"lanes": len(rows), "max_rel": worst, "ckpt_ties": ties}


def explicit_launches(mc_grid, T, gaps, dev) -> list:
    """The ``event_sweep`` calls that ``run_explicit_path`` makes, block
    by block as the engine cuts them: ``(params, gaps, kwargs)``."""
    from repro_torch.sim import F64
    from repro_torch.sim import engine as te
    flat, T_arr, Tb_arr = te._flat_inputs(T, mc_grid, T_BASE, dev)
    g = te._normalize_gaps(gaps, flat.size, dev)
    steps = te._scan_len(g.shape[-1]) + 1
    return [(te._point_params(flat, T_arr, Tb_arr, b.points, F64),
             F64.cast(b.gaps), dict(n_steps=b.n_steps, compensated=False))
            for b in te._explicit_schedules(g, flat.size, steps, None)]


def phase_explicit_times(mc_grid, T, gaps, tb, launches: int, peaks,
                         dev) -> dict:
    """The explicit kernel on the explicit path's own launches (their
    count must be the path's): its time, its plain version's (both held
    bitwise first) and its bound, from the gaps this run's lanes read."""
    import torch
    from repro_torch.kernels import cost, event_sweep as es
    calls = explicit_launches(mc_grid, T, gaps, dev)
    if len(calls) != launches:
        fail(f"the explicit path made {launches} launches, its blocks are "
             f"{len(calls)}")
    run_k = lambda: [es.event_sweep(*a, g, **k) for a, g, k in calls]
    run_p = lambda: [es.event_sweep_plain(*a, g, **k) for a, g, k in calls]
    equal, err = True, 0.0
    for x, y in zip(run_k(), run_p()):
        e, d = _compare(x, y)
        equal, err = equal and e, max(err, d)
    if not equal:
        fail("explicit kernel != plain version on the explicit path")
    F = gaps.shape[-1]
    n_gaps = int(torch.clamp_max(tb.n_failures.to(torch.int64) + 1, F).sum())
    lanes = tb.n_failures.numel()
    b = cost.bound_ms(cost.event_sweep_work(mc_grid.size, lanes, n_gaps),
                      peaks)
    out = {"launches": len(calls), "lanes": lanes, "gaps": n_gaps,
           "ms": _events_ms(run_k), "plain_ms": _events_ms(run_p),
           "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "bitwise": equal, "max_abs_err": err}
    log(f"time explicit path {tuple(gaps.shape)} f64: explicit kernel "
        f"{out['ms']:.4f} ms over {len(calls)} launches, plain "
        f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}); gaps {n_gaps}")
    return out


# ---------------------------------------------------------------------------
# 6. the checkpoint runtime at full width
# ---------------------------------------------------------------------------

#: the checkpointed state's draws (params N(0, 0.02), m N(0, 1e-3), v the
#: square of N(0, 1e-3)) come from a torch.Generator on the card with this
#: seed.
CKPT_SEED = 2026
#: the policy: the paper's two-level Exascale powers, a one-day platform
#: MTBF, priors for the buddy level (a RAM-to-RAM copy) and the deep
#: level; the measured costs replace them as checkpoints complete.
POLICY_CFG = dict(strategy="algo_e_ml", C_s=60.0, R_s=60.0, D_s=60.0,
                  C1_s=0.5, R1_s=0.5, q=0.1, mu_s=24 * 3600.0, omega=0.5)


def _ckpt_sizes() -> tuple:
    """(compressed leaves, f32 bytes) of the checkpointed params and
    moments: 57 and 2,077,084,224 at xLSTM-125M's widths."""
    import numpy as np
    sizes = [int(np.prod(s)) for _, s in XLSTM_125M_LEAVES]
    return 3 * sum(n >= 4096 for n in sizes), 3 * 4 * sum(sizes)


def _xlstm_on_card(dev):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(CKPT_SEED)

    def make(kind, shape):
        if kind == "step":
            return torch.tensor(1000, dtype=torch.int32, device=dev)
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        x.normal_(0.0, 0.02 if kind == "params" else 1e-3, generator=gen)
        return x.square_() if kind == "v" else x
    return xlstm_state(make)


def run_ckpt_path(dev, root: Path) -> dict:
    """Drive the checkpoint runtime once through its entry points; returns
    what the gates and the report need.  Counters are read by the caller
    around it."""
    import torch
    from repro_torch.ckpt import (CheckpointManager, ManagerConfig,
                                  ShardedStore, StoreConfig)
    from repro_torch.core import CheckpointPolicy, PolicyConfig
    from repro_torch.energy import (PAPER_EXASCALE_ML_PROFILE, EnergyMeter,
                                    Phase)
    prof = PAPER_EXASCALE_ML_PROFILE
    state = _xlstm_on_card(dev)
    torch.cuda.synchronize()
    pol = CheckpointPolicy(PolicyConfig(**POLICY_CFG), prof.power_params(),
                           ml_power=prof.ml_power_params(), device=dev)
    store = ShardedStore(StoreConfig(root=str(root), compress=True,
                                     device=dev))
    mgr = CheckpointManager(store, pol, ManagerConfig(pfs_every=None))
    meter = EnergyMeter(prof)

    def peak_from_here():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    mem = {"save_before": peak_from_here()}
    t0 = time.perf_counter()
    first = mgr.maybe_checkpoint(1, state)
    mgr.wait()
    t_deep = time.perf_counter() - t0
    mem["save_peak"] = torch.cuda.max_memory_allocated()
    save_split = dict(store.last_save)
    not_due = mgr.maybe_checkpoint(2, state)
    step2 = 1 + pol.period_steps()
    t0 = time.perf_counter()
    second = mgr.maybe_checkpoint(step2, state)
    t_buddy = time.perf_counter() - t0
    m_policy = pol.deep_every()
    mgr.drop_buddy()                        # hard failure: buddy lost too
    mem["restore_before"] = peak_from_here()
    t0 = time.perf_counter()
    restored, r_step, source = mgr.restore(state)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    mem["restore_peak"] = torch.cuda.max_memory_allocated()
    for st in mgr.stats:
        meter.add(Phase.CHECKPOINT_IO if st["level"] >= 2
                  else Phase.CHECKPOINT_IO_BUDDY, st["C_s"])
    meter.add(Phase.RECOVERY_IO, t_restore)
    return {"state": state, "restored": restored, "store": store,
            "manager": mgr, "policy": pol, "levels": (first, not_due, second),
            "step2": step2, "m_policy": m_policy, "restore_step": r_step,
            "source": source, "t_deep_s": t_deep, "t_buddy_s": t_buddy,
            "t_restore_s": t_restore, "save_split": save_split,
            "device_memory": mem,
            "restore_split": dict(store.last_restore),
            "meter": meter.report()}


def gate_ckpt(run: dict, dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.core import CheckpointPolicy, PolicyConfig
    from repro_torch.energy import PAPER_EXASCALE_ML_PROFILE
    from repro_torch.kernels import quant_blockwise as qb
    mgr, store = run["manager"], run["store"]
    first, not_due, second = run["levels"]
    log(f"ckpt: maybe_checkpoint -> level {first} at step 1, {not_due} at "
        f"step 2, {second} at step {run['step2']} (policy m "
        f"{run['m_policy']}); restore after a dropped buddy from "
        f"{run['source']} at step {run['restore_step']}")
    if (first, not_due, second) != (2, 0, 1):
        fail(f"ckpt: expected a deep, a skipped and a buddy-only "
             f"checkpoint, got levels {(first, not_due, second)}")
    if (run["source"], run["restore_step"]) != ("store", 1):
        fail("ckpt: the restore did not come from the deep store")
    deep = [st for st in mgr.stats if st["level"] == 2]
    if mgr.flush_errors or len(deep) != 1:
        fail(f"ckpt: deep flush outcomes not all ok ({mgr.flush_errors}, "
             f"{len(deep)} recorded of 1)")

    gen = store.latest()
    man = json.loads((gen / "manifest.json").read_text())
    with np.load(gen / man["shards"]["0"]["file"]) as data:
        payload = {k: data[k] for k in data.files}
    orig, back = tree_leaves(run["state"]), tree_leaves(run["restored"])
    n_comp = n_plain_equal = 0
    worst = 0.0
    for entry, x, y in zip(man["leaves"], orig, back):
        i = entry["index"]
        if not entry["compressed"]:
            if not torch.equal(x, y):
                fail(f"ckpt: uncompressed leaf {i} not restored bitwise")
            continue
        n_comp += 1
        q = torch.from_numpy(payload[f"leaf_{i}_q"]).to(dev)
        s = torch.from_numpy(payload[f"leaf_{i}_s"]).to(dev)
        want = qb.dequantize_plain(q, s).reshape(-1)
        want = want[:want.numel() - entry["pad"]].reshape(x.shape)
        if not _bits_equal(y, want):
            fail(f"ckpt: leaf {i} != plain dequantization of its payload")
        n_plain_equal += 1
        g = lambda t: torch.cat([t.reshape(-1), t.new_zeros(
            entry["pad"])]).reshape(-1, 128).double()
        xg, yg = g(x), g(y)
        bound = 0.5 * s.reshape(-1, 1).double() \
            + 1e-6 * xg.abs().amax(-1, keepdim=True)
        err = (xg - yg).abs()
        worst = max(worst, float((err / bound).max()))
    n_want, f32_bytes = _ckpt_sizes()
    n_bytes = deep[0]["bytes"]
    ratio = n_bytes / f32_bytes
    log(f"ckpt gates: {n_comp} compressed leaves, all bitwise equal to the "
        f"plain dequantization; max error / (scale/2 + 1e-6 max|x|) "
        f"{worst:.6f} (<= 1); payload {n_bytes} bytes = {ratio:.6f} of the "
        f"f32 bytes (<= 0.27)")
    if n_comp != n_want or worst > 1.0 or ratio > 0.27:
        fail("ckpt: compressed leaves outside their gates")

    # the policy, solved on the card and on the CPU from the same
    # observations (the manager's records, in order)
    prof = PAPER_EXASCALE_ML_PROFILE
    sols = {}
    for where in (dev, "cpu"):
        pol = CheckpointPolicy(PolicyConfig(**POLICY_CFG),
                               prof.power_params(),
                               ml_power=prof.ml_power_params(), device=where)
        for st in mgr.stats:
            pol.observe_checkpoint(
                duration_s=st["C_s"], level=st["level"],
                slowdown_work_fraction=(st["write_s"] / st["measured_s"]
                                        if st["measured_s"] > 0 else 0.0))
        sols[str(where)] = (pol.period_seconds(), pol.deep_every())
    (Tg, mg), (Tc, mc) = sols[str(dev)], sols["cpu"]
    rel = abs(Tg - Tc) / abs(Tc)
    log(f"ckpt policy algo_e_ml from the measured C: card (T={Tg!r} s, "
        f"m={mg}), cpu (T={Tc!r} s, m={mc}), rel {rel:.3e} (<= 1e-8)")
    if mg != mc or rel > 1e-8:
        fail("ckpt: the policy's (T, m) differs between card and CPU")
    return {"compressed_leaves": n_comp, "max_err_over_bound": worst,
            "payload_bytes": n_bytes, "payload_ratio": ratio,
            "policy_T_card": Tg, "policy_T_cpu": Tc, "policy_m": mg,
            "policy_rel": rel, "flush_errors": len(mgr.flush_errors)}


def report_ckpt(run: dict) -> dict:
    mgr = run["manager"]
    deep = next(st for st in mgr.stats if st["level"] == 2)
    buddy = next(st for st in mgr.stats if st["level"] == 1)
    save = {"snapshot_d2h": deep["snapshot_s"], **run["save_split"],
            "flush_total": deep["write_s"]}
    restore = {**run["restore_split"], "total": run["t_restore_s"]}
    log("ckpt save (s): " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in save.items()))
    log(f"ckpt buddy-only checkpoint (s): snapshot_d2h "
        f"{buddy['snapshot_s']:.4f}, push {buddy['write_s']:.4f}")
    log("ckpt restore (s): " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in restore.items()))
    mem = run["device_memory"]
    for op in ("save", "restore"):
        log(f"ckpt {op} device memory: peak {mem[op + '_peak']} bytes, "
            f"{mem[op + '_peak'] - mem[op + '_before']} above the "
            f"{mem[op + '_before']} allocated before it")
    log(f"ckpt energy meter (paper two-level profile, normalized powers): "
        f"{json.dumps(run['meter'])}")
    return {"save_s": save, "buddy_s": {"snapshot_d2h": buddy["snapshot_s"],
                                        "push": buddy["write_s"]},
            "restore_s": restore, "C2_s": deep["C_s"], "C1_s": buddy["C_s"],
            "device_memory_bytes": mem}


# ---------------------------------------------------------------------------
# 7. times
# ---------------------------------------------------------------------------

#: the least span of one timing sample, ms.
SAMPLE_MS = 20.0
#: a call that alone spans ``SLOW_MS`` or more (the plain versions, the
#: two-step path: 0.3-1.2 s a call at the MC shapes) is sampled
#: ``SLOW_REPS`` times, not five: the timing of such yardsticks took most
#: of phase 7's 106 s.
SLOW_MS, SLOW_REPS = 100.0, 3


def _events_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` samples of ``fn``'s time on the device, by CUDA
    events.  A sample times ``n`` calls back to back and divides by ``n``,
    with ``n`` sized by a warm call so that a sample spans ``SAMPLE_MS`` or
    more: the host's cost of each call then overlaps the device's work
    instead of opening an idle gap inside the timed span.  A call of
    ``SLOW_MS`` or more takes ``SLOW_REPS`` samples."""
    import torch

    def sample(n: int) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n
    first = sample(1)
    n = max(1, math.ceil(SAMPLE_MS / first))
    if first >= SLOW_MS:
        reps = min(reps, SLOW_REPS)
    return statistics.median(sample(n) for _ in range(reps))


def _host_s(fn, reps: int = 5) -> float:
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _fused_bound(n_gaps: int, lanes: int, points: int, pol, kind: int,
                 draw_ops: dict, peaks) -> dict:
    """The sampled kernel's bound (``cost.event_sweep_sampled_work``):
    outputs and parameters over the memory rate; the draw's INT32 and f64
    instructions per gap (``_draw_ops``, from the SASS) and the update's
    operations, each over its unit's rate.  An f64 instruction takes one
    slot of the FP64 units, whose rate is their FLOP peak over 2 (the peak
    counts a fused multiply-add as two); the update's operations are
    FLOPs.  The units run side by side, so the least time is the largest
    of the four."""
    from repro_torch.kernels import cost
    w = cost.event_sweep_sampled_work(points, lanes, n_gaps,
                                      compensated=pol.compensated,
                                      draw_ops=draw_ops[kind])
    b = cost.bound_ms(w, peaks)
    parts = b["parts_ms"]
    ms = {"bytes": parts["bytes"], "int32": parts.get("int32", 0.0),
          "f64": parts.get("fp64", 0.0), "f32": parts.get("fp32", 0.0)}
    top = max(ms, key=ms.get)
    return {"bound_ms": ms[top], "bound_by": b["bound_by"],
            "bound_unit": top, "bound_parts_ms": ms, "bytes": w.bytes,
            "int32_instructions": w.ops["int32"],
            "f64_instructions": w.ops["f64_instr"],
            "update_ops": w.ops["f32" if pol.compensated else "f64"]}


def phase_times(big, mc_grid, model, runs, peaks, draw_ops, dev) -> list:
    """Per MC call of the main path: the sampled kernel over the engine's
    launches with its bound; the explicit kernel on the same lanes' drawn
    schedule in the (B, F, N) and (B, N, F) layouts with its byte bound,
    the transpose between them and the plain versions; the two-step
    path's draws; ``simulate_trajectories`` end to end and its host parts.
    The kernels are held bitwise against each other again at these
    shapes, and the sampled kernel's draws and outputs against its plain
    version's (``draw_gaps``, ``event_sweep_sampled_plain``) lane for
    lane."""
    import torch
    from repro_torch.core import Exponential, Weibull
    from repro_torch.core.failures import draw_gaps
    from repro_torch.kernels import cost, event_sweep as es
    from repro_torch.sim import (COMPENSATED_F32, F64, evaluate_grid,
                                 fail_capacity_points, sampled_schedules,
                                 simulate_trajectories)
    from repro_torch.sim import engine as te
    for pol in (F64, COMPENSATED_F32):
        s = _host_s(lambda: evaluate_grid(big, precision=pol, device=dev))
        log(f"time evaluate_grid 1e6 [{pol.name}]: {s:.4f} s (median of 5)")
    procs = {"exponential": Exponential(), "weibull": Weibull(shape=0.7)}
    kinds = {name: k for k, name in MAIN_KINDS.items()}
    flat = mc_grid.ravel()
    variants = []
    for (pname, polname, algo), tb in runs.items():
        pol = F64 if polname == "f64" else COMPENSATED_F32
        dt = pol.torch_dtype
        T = (model.T_time if algo == "algo_t" else model.T_energy).reshape(-1)
        Tb = torch.full_like(T, T_BASE)
        proc = procs[pname]
        kw = dict(T_base=T_BASE, n_trials=N_TRIALS, seed=7, process=proc,
                  device=dev)
        plan = lambda: list(te.sampled_launches(
            flat, T, Tb, N_TRIALS, 7, proc, None, None, pol))
        launches = plan()
        sk = lambda k: dict(n_steps=k["n_steps"],
                            compensated=k["compensated"])
        draw = lambda k: {x: k[x] for x in ("spec", "seed", "points",
                                            "trial0", "n_trials",
                                            "capacity")}
        # the lanes' drawn schedule: f64 (B, N, F), and in the compute
        # dtype in both layouts
        f64_bnf = [es.event_draws(**draw(k)).contiguous()
                   for _, _, _, k in launches]
        bfn = [trial_major(g, dt) for g in f64_bnf]
        bnf = [g.to(dt) for g in f64_bnf]
        run_f = lambda: [es.event_sweep_sampled(*a, **k)
                         for _, _, a, k in launches]
        run_e = lambda gs: [es.event_sweep(*a, g, **sk(k))
                            for (_, _, a, k), g in zip(launches, gs)]
        run_p = lambda: [es.event_sweep_plain(*a, g, **sk(k))
                         for (_, _, a, k), g in zip(launches, bfn)]
        run_2 = lambda: [es.event_sweep_sampled_plain(*a, **k)
                         for _, _, a, k in launches]
        fused, e_bfn, e_bnf, plain = run_f(), run_e(bfn), run_e(bnf), run_p()
        two_step = run_2()
        torch.cuda.synchronize()
        equal, err = True, 0.0
        for outs in zip(fused, e_bfn, e_bnf, plain):
            for other in outs[1:]:
                e, x = _compare(outs[0], other)
                equal, err = equal and e, max(err, x)
        if not equal:
            fail(f"sampled kernel, explicit kernel (both layouts) and plain "
                 f"version disagree at main-path shapes "
                 f"{(pname, polname, algo)}")
        # the in-kernel draws against the plain draws (sample_gaps's), and
        # the sampled kernel against its plain version, lane for lane
        draws = {"max_ulps": 0, "gaps_differing": 0, "lanes_differing": 0}
        for (_, _, _, k), got, f_out, p_out in zip(launches, f64_bnf,
                                                   fused, two_step):
            want = draw_gaps(k["spec"], es._key(k["seed"], k["points"],
                                                k["trial0"], k["n_trials"]),
                             k["capacity"])
            ulps, n_diff = _ulps(got, want)
            rel = float(((got - want).abs() / want).max())
            del want
            same, _ = _compare(f_out, p_out)
            draws["max_ulps"] = max(draws["max_ulps"], ulps)
            draws["gaps_differing"] += n_diff
            if not same:
                diff = sum((f_out[x] != p_out[x]).int() for x in f_out)
                draws["lanes_differing"] += int((diff > 0).sum())
            if (pname == "exponential" and n_diff) or not rel <= 1e-12:
                fail(f"in-kernel draws off sample_gaps at main-path shapes "
                     f"{(pname, polname, algo)}: {ulps} ulps, {n_diff} gaps")
            if n_diff == 0 and not same:
                fail(f"sampled kernel != its plain version on equal draws "
                     f"at main-path shapes {(pname, polname, algo)}")
        log(f"parity {pname}/{polname}/{algo} at main-path shapes: sampled "
            f"kernel = explicit kernel (both layouts) = plain version on "
            f"its draws, bitwise; its draws vs sample_gaps's: largest ulp "
            f"difference {draws['max_ulps']}, differing gaps "
            f"{draws['gaps_differing']}; vs its plain version "
            f"(event_sweep_sampled_plain): differing lanes "
            f"{draws['lanes_differing']}")
        del fused, e_bfn, e_bnf, plain, two_step
        fused_ms = _events_ms(run_f)
        fused_plain_ms = _events_ms(run_2)
        bfn_ms = _events_ms(lambda: run_e(bfn))
        bnf_ms = _events_ms(lambda: run_e(bnf))
        transpose_ms = _events_ms(lambda: [trial_major(g, dt)
                                           for g in f64_bnf])
        plain_ms = _events_ms(run_p)
        sample_ms = _events_ms(lambda: [b.gaps for b in sampled_schedules(
            T, flat, **kw)])
        del f64_bnf, bfn, bnf
        torch.cuda.empty_cache()
        e2e = _host_s(lambda: simulate_trajectories(
            T, flat, precision=pol, **kw))
        plan_s = _host_s(plan)
        run_s = _host_s(lambda: te._run_sampled(
            flat, T, Tb, N_TRIALS, 7, proc, None, None, pol))
        acc = te._run_sampled(flat, T, Tb, N_TRIALS, 7, proc, None, None,
                              pol)
        assemble_s = _host_s(lambda: te._assemble_batch(acc, flat, N_TRIALS))
        del acc
        host = {"simulate_trajectories_s": e2e, "plan_s": plan_s,
                "kernels_s": fused_ms / 1e3,
                "scatter_and_launch_s": run_s - plan_s - fused_ms / 1e3,
                "energy_integral_s": assemble_s,
                "other_s": e2e - run_s - assemble_s}

        lanes = tb.n_failures.numel()
        F_of = torch.as_tensor(fail_capacity_points(
            T, flat, T_BASE, process=proc), device=dev)
        reads = torch.minimum(
            tb.n_failures.reshape(flat.size, -1).to(torch.int64) + 1,
            F_of[:, None])
        n_gaps = int(reads.sum())
        # a warp (32 trials of one point) runs as long as its longest lane
        steps = tb.n_failures.reshape(flat.size, -1, 32).to(torch.int64) + 1
        warp_eff = float(steps.sum()) / float(32 * steps.amax(-1).sum())
        eb = cost.bound_ms(cost.event_sweep_work(
            flat.size, lanes, n_gaps, compensated=pol.compensated), peaks)
        fb = _fused_bound(n_gaps, lanes, flat.size, pol, kinds[pname],
                          draw_ops, peaks)
        v = {"process": pname, "policy": polname, "period": algo,
             "launches": len(launches), "lanes": lanes, "gaps": n_gaps,
             "fused_ms": fused_ms, "fused_plain_ms": fused_plain_ms,
             "fused": fb,
             "explicit_bfn_ms": bfn_ms, "explicit_bnf_ms": bnf_ms,
             "transpose_ms": transpose_ms, "plain_ms": plain_ms,
             "explicit_bound_ms": eb["bound_ms"],
             "explicit_bound_by": eb["bound_by"],
             "sampling_ms": sample_ms,
             "two_step_ms": sample_ms + bnf_ms,
             "host": host, "warp_efficiency": warp_eff, "bitwise": equal,
             "draws_vs_plain": draws, "max_abs_err": err}
        log(f"time {pname}/{polname}/{algo}: sampled kernel {fused_ms:.4f} "
            f"ms over {len(launches)} launches, bound {fb['bound_ms']:.4f} "
            f"ms ({fb['bound_unit']}; "
            + ", ".join(f"{k} {x:.4f}" for k, x in
                        fb["bound_parts_ms"].items())
            + f"), its plain version {fused_plain_ms:.4f} ms; explicit "
            f"kernel (B, F, N) {bfn_ms:.4f} ms, (B, N, F) {bnf_ms:.4f} ms, "
            f"bound {v['explicit_bound_ms']:.4f} ms "
            f"({v['explicit_bound_by']}), transpose {transpose_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; two-step path {v['two_step_ms']:.4f} "
            f"ms (sampling {sample_ms:.4f} ms); simulate_trajectories "
            f"{e2e:.4f} s (plan {plan_s:.4f}, kernels "
            f"{host['kernels_s']:.4f}, scatter and launch "
            f"{host['scatter_and_launch_s']:.4f}, energy integral "
            f"{assemble_s:.4f}, other {host['other_s']:.4f}); gaps {n_gaps}, "
            f"warp efficiency {warp_eff:.4f}")
        variants.append(v)
        torch.cuda.empty_cache()
    return variants


def _leaf_launch(entry: str, rows: list, n_groups: int, dev):
    """A call that launches the quant library's ``entry`` over the leaf
    table ``rows`` made ready once (uploaded, or for one row packed as the
    wrappers pass it), so that it times the kernel without the wrappers'
    host work."""
    from repro_torch.kernels import _build, quant_blockwise as qb
    table, row, keep = qb.table_args(rows, dev)
    fn = getattr(qb.load_library(), entry)

    def call():
        _build.launch(fn, table, row, len(rows), n_groups, device=dev,
                      name=entry)
        return keep
    return call


def phase_quant_times(run: dict, peaks, dev) -> dict:
    """CUDA-event times of the quantize and dequantize kernels and of their
    plain versions over the 57 compressed leaves of the checkpoint (one
    checkpoint's worth, at the path's shapes), checked bitwise again, with
    the byte bound, in rows: ``checkpoint``, one launch over the leaves as
    they lie (the store's path); ``per_leaf``, one launch a leaf on padded
    (rows, D) copies through the one-leaf wrappers (how the store called
    them before); ``largest``, the largest leaf alone.  ``kernel_ms`` times
    the wrapper calls back to back, host work included; ``table_kernel_ms``
    the same launches on leaf tables made ready once, without the
    wrappers' host work."""
    import torch
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.kernels import cost, quant_blockwise as qb
    leaves = [x for x in tree_leaves(run["state"])
              if x.dtype == torch.float32 and x.numel() >= 4096]
    padded = []
    for x in leaves:
        pad, D = qb.pad_of(x.numel())
        padded.append(torch.cat([x.reshape(-1), x.new_zeros(pad)]).reshape(
            -1, D))
    q, s, views = qb.quantize_leaves(leaves)
    pq, ps, _ = qb.quantize_leaves_plain(leaves)
    args = ([v[0] for v in views], [v[1] for v in views],
            [x.shape for x in leaves], [v[2] for v in views])
    if not (_bits_equal(q, pq) and _bits_equal(s, ps) and all(
            _bits_equal(a, b) for a, b in zip(qb.dequantize_leaves(*args),
                                              qb.dequantize_leaves_plain(
                                                  *args)))):
        fail("quant kernels != plain versions at the path's shapes")
    big = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    one = lambda i: ([args[0][i]], [args[1][i]], [args[2][i]], [args[3][i]])
    # the kernels alone, on tables made ready once (the arenas kept alive)
    arenas = qb._quantize_table([x.reshape(-1) for x in leaves], dev)
    outs = qb._dequantize_table(*args)
    q_rows, d_rows, n_groups = arenas[2], outs[3], outs[4]
    g_big = args[1][big].numel()
    kern = {(name, label): _leaf_launch(f"repro_{name}_leaves", rows, g, dev)
            for name, table in (("quantize", q_rows), ("dequantize", d_rows))
            for label, rows, g in (("checkpoint", table, n_groups),
                                   ("largest", [table[big][:5] + [0]],
                                    g_big))}
    # the 57 one-leaf launches alone, on the padded leaves
    one_q = [(torch.empty(x.shape, dtype=torch.int8, device=dev),
              torch.empty((x.shape[0], x.shape[1] // qb.LANE_GROUP),
                          device=dev)) for x in padded]
    one_d = [torch.empty(x.shape, device=dev) for x in padded]
    one_leaf = {
        "quantize": [_leaf_launch(
            "repro_quantize_leaves", [[x.data_ptr(), a.data_ptr(),
                                       b.data_ptr(), x.numel(), x.shape[1],
                                       0]], b.numel(), dev)
            for x, (a, b) in zip(padded, one_q)],
        "dequantize": [_leaf_launch(
            "repro_dequantize_leaves", [[o.data_ptr(), a.data_ptr(),
                                         b.data_ptr(), a.numel(), a.shape[1],
                                         0]], b.numel(), dev)
            for o, a, b in zip(one_d, args[0], args[1])]}
    for name, calls in one_leaf.items():
        kern[(name, "per_leaf")] = lambda calls=calls: [f() for f in calls]
    # label: (wrapper calls, the kernel on a ready table, plain version)
    rows = {
        "quantize": {
            "checkpoint": (lambda: qb.quantize_leaves(leaves),
                           kern[("quantize", "checkpoint")],
                           lambda: qb.quantize_leaves_plain(leaves)),
            "per_leaf": (lambda: [qb.quantize(x) for x in padded],
                         kern[("quantize", "per_leaf")],
                         lambda: [qb.quantize_plain(x) for x in padded]),
            "largest": (lambda: qb.quantize_leaves([leaves[big]]),
                        kern[("quantize", "largest")],
                        lambda: qb.quantize_leaves_plain([leaves[big]]))},
        "dequantize": {
            "checkpoint": (lambda: qb.dequantize_leaves(*args),
                           kern[("dequantize", "checkpoint")],
                           lambda: qb.dequantize_leaves_plain(*args)),
            "per_leaf": (lambda: [qb.dequantize(a, b) for a, b
                                  in zip(args[0], args[1])],
                         kern[("dequantize", "per_leaf")],
                         lambda: [qb.dequantize_plain(a, b) for a, b
                                  in zip(args[0], args[1])]),
            "largest": (lambda: qb.dequantize_leaves(*one(big)),
                        kern[("dequantize", "largest")],
                        lambda: qb.dequantize_leaves_plain(*one(big)))}}
    out = {}
    for name, table in rows.items():
        res = {}
        for label, (wrapper, ker, plain) in table.items():
            sel = [big] if label == "largest" else range(len(leaves))
            n = sum(leaves[i].numel() for i in sel)
            g = sum(args[1][i].numel() for i in sel)
            w = cost.quant_work(name, n, g)   # f32 <-> padded int8 + scales
            b = cost.bound_ms(w, peaks)
            res[label] = {
                "leaves": len(sel), "elements": n, "bytes": w.bytes,
                "kernel_ms": _events_ms(wrapper),
                "table_kernel_ms": _events_ms(ker),
                "plain_ms": _events_ms(plain),
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
            r = res[label]
            log(f"time {name} [{label}: {r['leaves']} leaves, {n} "
                f"elements]: kernel {r['kernel_ms']:.4f} ms (wrapper calls, "
                f"host work included), on tables made ready once "
                f"{r['table_kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{r['bound_ms'] / r['kernel_ms']:.3f} of the bound's rate")
        out[name] = res
    del leaves, padded, q, s, pq, ps, views, args, arenas, outs, kern
    del one_q, one_d, one_leaf, rows
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 8. the model-zoo kernel layer
# ---------------------------------------------------------------------------

#: (atol, rtol) of the tolerance-held kernels against their plain versions:
#: the reference's kernel-vs-oracle tolerances in f32
#: (tests/test_kernels.py:39, 142, 156, 226).  In bf16 (compared in f32)
#: 4e-3 + 1e-2 |y|: a bf16 output one rounding apart differs by at most
#: 2**-7 |y|, and the smallest typical outputs (attention averaging ~2048
#: values, about 0.04) leave no room for a missing key tile.  The RG-LRU
#: kernel is held bitwise.
ZOO_TOL = {"flash_attention": (2e-5, 2e-5), "decode_attention": (1e-4, 0.0),
           "mlstm_scan": (1e-4, 1e-3), "bf16": (4e-3, 1e-2)}
#: bf16 outputs are also held to ||x - y|| / ||y|| <= 4e-3 (Frobenius):
#: one rounding to bf16 moves each value by at most 2**-8 of it.
ZOO_BF16_FROB = 4e-3
#: seeds of the zoo's inputs (torch.Generator on the card).
ZOO_PARITY_SEED = 13
ZOO_SEED = 2027
#: the full-width shapes.  RecurrentGemma-9B (src/repro/configs/
#: recurrentgemma_9b.py): lru_width 4096, 16 heads of 256 with one KV head,
#: local window 2048, 2 rows per device, the train_4k sequence of 4096;
#: its decode: 128 sequences x 16 heads against the 2048-slot local cache.
#: xLSTM-125M (src/repro/configs/xlstm_125m.py): mLSTM inner width 1536 in
#: 4 heads of 384, chunk 256, microbatch 8, f32.
RG_SHAPE = (2, 4096, 4096)
LOCAL_ATTN = dict(B=2, S=4096, H=16, Dh=256, window=2048)
DECODE = dict(BH=128 * 16, S=2048, Dh=256, lengths=(2048, 1000))
MLSTM = dict(B=8, H=4, S=4096, Dh=384, chunk=256)


def _close(x, y, tol) -> tuple:
    """(ok, max |x - y|, ||x - y|| / ||y||), in f64: ok when x is finite,
    |x - y| <= atol + rtol |y| everywhere and, for a bf16 ``x``, the
    relative Frobenius error is at most ``ZOO_BF16_FROB``."""
    import torch
    atol, rtol = tol
    bf16 = x.dtype == torch.bfloat16
    x, y = x.double(), y.double()
    d = (x - y).abs()
    ok = bool(torch.isfinite(x).all()) and bool((d <= atol + rtol * y.abs())
                                                .all())
    dn, yn = float(torch.linalg.vector_norm(d)), float(
        torch.linalg.vector_norm(y))
    frob = dn / yn if yn else (0.0 if dn == 0 else float("inf"))
    ok = ok and not (bf16 and frob > ZOO_BF16_FROB)
    return ok, float(d.max()) if d.numel() else 0.0, frob


def _tol(name: str, dtype):
    import torch
    return ZOO_TOL["bf16"] if dtype == torch.bfloat16 else ZOO_TOL[name]


def _bits(x):
    """``x`` as integers of its width (bitwise comparison)."""
    import torch
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


def _randn(gen, dev):
    import torch
    return lambda *shape: torch.randn(shape, generator=gen, device=dev)


def phase_zoo_parity(dev) -> dict:
    """The four zoo kernels against their plain versions (and the oracles of
    ``kernels/ref.py``) at small ragged and edge shapes; returns the largest
    absolute difference per kernel."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    gen = torch.Generator(device=dev)
    gen.manual_seed(ZOO_PARITY_SEED)
    randn = _randn(gen, dev)
    errs = dict.fromkeys(("rglru_scan", "flash_attention", "decode_attention",
                          "mlstm_scan"), 0.0)
    before = _counts()
    bf16, f32 = torch.bfloat16, torch.float32

    # W = 200 and 4104: the ring route with a ragged last lane tile; S = 300,
    # 77 and 1000 end on a ragged stage; W = 333 takes the direct route;
    # (2, 1, 4096) and (2, 4096, 4096) are recurrentgemma-9b's decode step
    # and prefill (phase 14)
    for (B, S, W) in ((3, 300, 200), (5, 77, 333), (2, 1000, 4104),
                      (2, 1, 4096), (2, 4096, 4096)):
        for dt in (f32, bf16):
            a = torch.sigmoid(randn(B, S, W) - 1.0).to(dt)
            b = randn(B, S, W).to(dt)
            h0 = randn(B, W)
            out = rg.rglru_scan(a, b, h0)
            plain = rg.rglru_scan_plain(a, b, h0)
            oracle = ref.rglru_ref(a, b, h0)
            torch.cuda.synchronize()
            same = torch.equal(_bits(out), _bits(plain))
            err = _max_abs(out, plain)
            ok_ref, err_ref, frob_ref = _close(
                out, oracle, (1e-5, 1e-5) if dt == f32 else ZOO_TOL["bf16"])
            errs["rglru_scan"] = max(errs["rglru_scan"], err)
            route = rg.launch_plan(B, S, W, dt)["route"]
            log(f"zoo parity rglru_scan {(B, S, W)} {dt} ({route}): "
                f"bitwise={same} max_abs_err={err}; vs rglru_ref "
                f"{err_ref:.3e} (rel "
                f"Frobenius {frob_ref:.3e})")
            if not (same and ok_ref):
                fail(f"rglru_scan off its plain version or oracle at "
                     f"{(B, S, W)} {dt}")

    # S = 333 in both dtypes; in bf16, the wgmma kernel's dtype, S = 1000 (a
    # multiple of neither 64 nor 128, band edges off the tiles, chunks of 64
    # under 128-row q tiles) and S = 77 (shorter than a q tile)
    flash_cases = [(3, 333, dt, (("causal", 0, 0), ("sliding", 100, 0),
                                 ("chunked", 0, 64), ("bidir", 0, 0)))
                   for dt in (f32, bf16)]
    flash_cases.append((2, 1000, bf16, (
        ("causal", 0, 0), ("sliding", 100, 0), ("sliding", 700, 0),
        ("chunked", 0, 64), ("bidir", 0, 0))))
    flash_cases.append((2, 77, bf16, (("causal", 0, 0), ("bidir", 0, 0))))
    # starcoder2-3b's prefill (phase 14): S 8192 under its window of 4096;
    # phase 15's heads of 64 in both dtypes: whisper's encoder (1500
    # frames, bidir), its cross-attention (64 queries against 1500 keys)
    # and internvl's prefill (S 2048, causal), at their BH in bf16
    model_flash = [(128, (4, 8192, bf16, (("sliding", 4096, 0),)))]
    model_flash += [(64, (BH if dt == bf16 else 8, S, dt, modes))
                    for dt in (f32, bf16)
                    for BH, S, modes in (
                        (96, (1500, 1500), (("bidir", 0, 0),)),
                        (96, (64, 1500), (("bidir", 0, 0),)),
                        (224, 2048, (("causal", 0, 0),)))]
    for Dh, (BH, S, dt, modes) in [(Dh, case) for Dh in fa.HEAD_DIMS
                                   for case in flash_cases] + model_flash:
        Sq, Skv = S if isinstance(S, tuple) else (S, S)
        q = randn(BH, Sq, Dh).to(dt)
        k, v = (randn(BH, Skv, Dh).to(dt) for _ in range(2))
        for mode, w, c in modes:
            out = fa.flash_attention(q, k, v, mode=mode, window=w,
                                     chunk=c)
            plain = fa.flash_attention_plain(q, k, v, mode=mode,
                                             window=w, chunk=c)
            oracle = ref.attention_ref(
                q[None], k[None], v[None], causal=mode != "bidir",
                window=w, chunk=c)[0]
            torch.cuda.synchronize()
            tol = _tol("flash_attention", dt)
            ok, err, frob = _close(out, plain, tol)
            ok_ref, err_ref, frob_ref = _close(out, oracle, tol)
            errs["flash_attention"] = max(errs["flash_attention"], err)
            log(f"zoo parity flash_attention {mode:8s} {w or c:4d} Dh "
                f"{Dh} {dt} {(BH, Sq, Skv, Dh)}: max_abs_err={err} (rel "
                f"Frobenius {frob:.3e}); vs attention_ref "
                f"{err_ref:.3e} ({frob_ref:.3e})")
            if not (ok and ok_ref):
                fail(f"flash_attention off at {mode} {w or c} Dh {Dh} "
                     f"{dt} Sq {Sq} Skv {Skv}")

    # lengths 999 and 1000 of S = 1000 end on a ragged ring stage; BH = 1
    # leaves all SMs but one idle; then phase 14's shapes in bf16:
    # starcoder2-3b's 8 x 24 heads against its 4096-slot ring and
    # recurrentgemma-9b's 2 x 16 heads against its 2048-slot one
    decode_cases = ((4, 768, (0, 1, 333, 768)), (4, 1000, (999, 1000)),
                    (1, 1000, (0, 500, 1000)))
    model_decode = [(128, bf16, (192, 4096, (1, 2048, 4096))),
                    (256, bf16, (32, 2048, (1, 1000, 2048)))]
    # phase 15's heads of 64: whisper's 16 x 6 heads against its 1500-slot
    # cross cache, internvl's 16 x 14 against its 2080-slot ring
    model_decode += [(64, dt, case) for dt in (f32, bf16) for case in (
        (96, 1500, (1, 750, 1500)), (224, 2080, (1, 1040, 2080)))]
    for Dh, dt, (BH, S, lengths) in list(itertools.product(
            da.HEAD_DIMS, (f32, bf16), decode_cases)) + model_decode:
        q1 = randn(BH, 1, Dh).to(dt)
        k, v = (randn(BH, S, Dh).to(dt) for _ in range(2))
        for length in lengths:
            out = da.decode_attention(q1, k, v, length)
            plain = da.decode_attention_plain(q1, k, v, length)
            torch.cuda.synchronize()
            tol = _tol("decode_attention", dt)
            ok, err, frob = _close(out, plain, tol)
            ok_ref, err_ref, frob_ref = True, 0.0, 0.0
            if length:
                oracle = ref.decode_ref(q1[:, 0][None], k[None],
                                        v[None], length=length)[0]
                ok_ref, err_ref, frob_ref = _close(out[:, 0], oracle, tol)
            else:
                ok_ref = bool((out == 0).all())
            errs["decode_attention"] = max(errs["decode_attention"], err)
            log(f"zoo parity decode_attention Dh {Dh} {dt} BH {BH} S "
                f"{S} length {length}: max_abs_err={err} (rel Frobenius "
                f"{frob:.3e}); vs decode_ref {err_ref:.3e} "
                f"({frob_ref:.3e})")
            if not (ok and ok_ref):
                fail(f"decode_attention off at Dh {Dh} {dt} BH {BH} S "
                     f"{S} length {length}")

    # phase 14's layout: ``ops.decode_attention`` on a query (B, 1, H, Dh)
    # against the ring (B, Sc, Hkv, Dh) expanded by ``expand_kv`` (folded
    # without a copy), held against the plain version on the KV heads
    # repeated by ``repeat_interleave`` and folded by hand
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.attention import expand_kv
    for arch, B, Sc, lengths in (("starcoder2-3b", 8, 4096, (1, 2048, 4096)),
                                 ("recurrentgemma-9b", 2, 2048, (1, 2048)),
                                 ("whisper-tiny", 16, 1500, (1500,)),
                                 ("internvl2-1b", 16, 2080, (1, 2080))):
        cfg = get_config(arch)
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q1 = randn(B, 1, H, Dh).to(bf16)
        ck, cv = (randn(B, Sc, Hkv, Dh).to(bf16) for _ in range(2))
        ke, ve = expand_kv(cfg, ck), expand_kv(cfg, cv)
        fold = lambda t: t.permute(0, 2, 1, 3).reshape(B * H, t.shape[1], Dh)
        rk, rv = (fold(t.repeat_interleave(H // Hkv, dim=2))
                  for t in (ck, cv))
        for length in lengths:
            out = ops.decode_attention(q1, ke, ve, length)
            plain = da.decode_attention_plain(fold(q1), rk, rv, length)
            plain = plain.reshape(B, H, 1, Dh).permute(0, 2, 1, 3)
            torch.cuda.synchronize()
            ok, err, frob = _close(out, plain, _tol("decode_attention", bf16))
            errs["decode_attention"] = max(errs["decode_attention"], err)
            log(f"zoo parity decode_attention model layout {arch} B {B} "
                f"{H} heads over {Hkv}, Dh {Dh}, Sc {Sc} length {length}: "
                f"max_abs_err={err} (rel Frobenius {frob:.3e})")
            if not (ok and out.shape == (B, 1, H, Dh)):
                fail(f"ops.decode_attention off in the model layout at "
                     f"{arch} length {length}")

    BH, S = 4, 512
    for Dh, chunk, dt in ((128, 64, f32), (256, 128, f32), (384, 256, f32),
                          (128, 64, bf16)):
        q = (randn(BH, S, Dh) * Dh ** -0.5).to(dt)
        k = (randn(BH, S, Dh) * Dh ** -0.5).to(dt)
        v = randn(BH, S, Dh).to(dt)
        li = (randn(BH, S) * 0.5).to(dt)
        lf = Fn.logsigmoid(randn(BH, S) + 2.0).to(dt)
        out = ml.mlstm_scan(q, k, v, li, lf, chunk=chunk)
        plain = ml.mlstm_scan_plain(q, k, v, li, lf, chunk=chunk)
        oracle = ref.mlstm_ref(*(x[None] for x in (q, k, v, li, lf)))[0]
        torch.cuda.synchronize()
        ok, err, frob = _close(out, plain, _tol("mlstm_scan", dt))
        ok_ref, err_ref, frob_ref = _close(out, oracle, _tol("mlstm_scan",
                                                             dt))
        errs["mlstm_scan"] = max(errs["mlstm_scan"], err)
        log(f"zoo parity mlstm_scan Dh {Dh} chunk {chunk} {dt} "
            f"{(BH, S, Dh)}: max_abs_err={err} (rel Frobenius {frob:.3e}); "
            f"vs mlstm_ref {err_ref:.3e} ({frob_ref:.3e})")
        if not (ok and ok_ref):
            fail(f"mlstm_scan off at Dh {Dh} chunk {chunk} {dt}")

    after = _counts()
    for name in errs:
        if after[name] <= before[name]:
            fail(f"the {name} launch counter did not increase")
    return errs


def zoo_inputs(dev) -> dict:
    """The full-width inputs, drawn on the card from ``ZOO_SEED``."""
    import torch
    import torch.nn.functional as Fn
    gen = torch.Generator(device=dev)
    gen.manual_seed(ZOO_SEED)
    randn = _randn(gen, dev)
    bf16 = torch.bfloat16
    B, S, W = RG_SHAPE
    inp = {"rg_a": torch.sigmoid(randn(B, S, W) - 1.0), "rg_b": randn(B, S, W),
           "rg_h0": randn(B, W)}
    la = LOCAL_ATTN
    inp["fa_q"] = randn(la["B"], la["S"], la["H"], la["Dh"]).to(bf16)
    for name in ("fa_k", "fa_v"):   # one KV head, expanded as the model does
        inp[name] = randn(la["B"], la["S"], 1, la["Dh"]).to(bf16).expand(
            -1, -1, la["H"], -1)
    d = DECODE
    inp["dec_q"] = randn(d["BH"], 1, d["Dh"]).to(bf16)
    inp["dec_k"] = randn(d["BH"], d["S"], d["Dh"]).to(bf16)
    inp["dec_v"] = randn(d["BH"], d["S"], d["Dh"]).to(bf16)
    m = MLSTM
    shape = (m["B"], m["H"], m["S"], m["Dh"])
    inp["ml_q"] = randn(*shape) * m["Dh"] ** -0.5
    inp["ml_k"] = randn(*shape) * m["Dh"] ** -0.5
    inp["ml_v"] = randn(*shape)
    inp["ml_li"] = randn(*shape[:3]) * 0.5
    inp["ml_lf"] = Fn.logsigmoid(randn(*shape[:3]) + 2.0)
    torch.cuda.synchronize()
    return inp


def run_zoo_path(inp: dict) -> dict:
    """Drive the zoo layer once at full width through its public wrappers
    (``kernels.ops``; decode through its raw wrapper).  Counters are read
    by the caller around it."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention
    out = {
        "rglru_zero_h0": ops.rglru_scan(inp["rg_a"], inp["rg_b"],
                                        torch.zeros_like(inp["rg_h0"])),
        "rglru_seeded_h0": ops.rglru_scan(inp["rg_a"], inp["rg_b"],
                                          inp["rg_h0"]),
        "local_attention": ops.flash_attention(
            inp["fa_q"], inp["fa_k"], inp["fa_v"], mode="sliding",
            window=LOCAL_ATTN["window"]),
        "mlstm": ops.mlstm_scan(inp["ml_q"], inp["ml_k"], inp["ml_v"],
                                inp["ml_li"], inp["ml_lf"],
                                chunk=MLSTM["chunk"])}
    for length in DECODE["lengths"]:
        out[f"decode_{length}"] = decode_attention(
            inp["dec_q"], inp["dec_k"], inp["dec_v"], length)
    return out


def _fold(t):
    """(B, S, H, Dh) -> contiguous (B*H, S, Dh)."""
    B, S, H, Dh = t.shape
    return t.transpose(1, 2).reshape(B * H, S, Dh)


def gate_zoo(inp: dict, out: dict) -> dict:
    """Hold every full-width output against the plain version on the same
    inputs: RG-LRU bitwise, the others within ``ZOO_TOL``; all finite and
    of the expected shape."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import rglru_scan as rg
    report = {}
    for key, h0 in (("rglru_zero_h0", torch.zeros_like(inp["rg_h0"])),
                    ("rglru_seeded_h0", inp["rg_h0"])):
        plain = rg.rglru_scan_plain(inp["rg_a"], inp["rg_b"], h0)
        same = torch.equal(_bits(out[key]), _bits(plain))
        report[key] = {"bitwise": same, "max_abs_err": _max_abs(out[key],
                                                                plain)}
        if not (same and out[key].shape == RG_SHAPE):
            fail(f"full width: {key} not bitwise equal to its plain version")
    if rg.launch_plan(*RG_SHAPE, inp["rg_a"].dtype)["route"] != "ring":
        fail("full width: RG-LRU did not take the ring route")
    la = LOCAL_ATTN
    got = _fold(out["local_attention"])
    plain = fa.flash_attention_plain(_fold(inp["fa_q"]), _fold(inp["fa_k"]),
                                     _fold(inp["fa_v"]), mode="sliding",
                                     window=la["window"])
    ok, err, frob = _close(got, plain, _tol("flash_attention", got.dtype))
    report["local_attention"] = {"max_abs_err": err, "rel_frobenius": frob}
    log(f"gate local_attention: max_abs_err {err} (<= 4e-3 + 1e-2 |y|), "
        f"rel Frobenius {frob:.4e} (<= {ZOO_BF16_FROB})")
    if not ok or out["local_attention"].shape != inp["fa_q"].shape:
        fail(f"full width: local attention off its plain version ({err})")
    del plain
    for length in DECODE["lengths"]:
        key = f"decode_{length}"
        plain = da.decode_attention_plain(inp["dec_q"], inp["dec_k"],
                                          inp["dec_v"], length)
        ok, err, frob = _close(out[key], plain, _tol("decode_attention",
                                                     plain.dtype))
        report[key] = {"max_abs_err": err, "rel_frobenius": frob}
        log(f"gate {key}: max_abs_err {err} (<= 4e-3 + 1e-2 |y|), rel "
            f"Frobenius {frob:.4e} (<= {ZOO_BF16_FROB})")
        if not ok or out[key].shape != inp["dec_q"].shape:
            fail(f"full width: {key} off its plain version ({err})")
    m = MLSTM
    BH = m["B"] * m["H"]
    fold = lambda t: t.reshape(BH, *t.shape[2:])
    plain = ml.mlstm_scan_plain(*(fold(inp[k]) for k in (
        "ml_q", "ml_k", "ml_v", "ml_li", "ml_lf")), chunk=m["chunk"])
    ok, err, frob = _close(fold(out["mlstm"]), plain, _tol("mlstm_scan",
                                                           plain.dtype))
    report["mlstm"] = {"max_abs_err": err, "rel_frobenius": frob}
    if not ok or out["mlstm"].shape != inp["ml_q"].shape:
        fail(f"full width: mLSTM off its plain version ({err})")
    torch.cuda.empty_cache()
    log("zoo full width vs plain versions: " + json.dumps(report))
    return report


def phase_bench_kernels(dev) -> list:
    """``repro_torch.benchmarks.bench_kernels.main`` on the card; its five
    kernels must launch, and no plain version may run."""
    from repro_torch.benchmarks import bench_kernels
    _reset_counts()
    rows = bench_kernels.main(device=dev)
    import torch
    torch.cuda.synchronize()
    counts = _counts()
    names = ("flash_attention", "rglru_scan", "mlstm_scan", "quantize",
             "event_sweep")
    log(f"bench_kernels: {len(rows)} rows; launches "
        f"{ {n: counts[n] for n in names} }, plain calls {counts['plain']}")
    if len(rows) != 5 or any(counts[n] <= 0 for n in names) \
            or counts["plain"]:
        fail("bench_kernels did not run its five kernels on the card")
    return rows


def _sdpa_ms(name: str, call, want) -> tuple:
    """(ms, backend) of ``call`` -- one ``scaled_dot_product_attention`` on
    4-D tensors -- under the fastest backend that takes it.  Each backend
    is tried alone; one that refuses the inputs raises and is skipped.
    The times and each backend's max |out - want| are logged."""
    import warnings
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel([backend]), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                got = call()
                torch.cuda.synchronize()
            except RuntimeError:
                log(f"sdpa {name}: {backend.name} does not take it")
                continue
            times[backend.name] = _events_ms(call)
        log(f"sdpa {name}: {backend.name} {times[backend.name]:.4f} ms, "
            f"max |out - plain| {_max_abs(got.reshape(want.shape), want)}")
        del got
    best = min(times, key=times.get)
    return times[best], best


def phase_zoo_times(inp: dict, peaks, dev) -> dict:
    """CUDA-event medians of 5 samples (``_events_ms``) of each zoo kernel,
    its plain version and (for attention) the one PyTorch call that
    computes the same function, at the full-width shapes, with each
    kernel's bound."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import cost
    from repro_torch.kernels import rglru_scan as rg

    def bound(work):
        b = cost.bound_ms(work, peaks)
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "bytes": work.bytes, "flops": sum(work.ops.values())}

    def timed(name, ker, plain, library=None, **b):
        r = {"kernel_ms": _events_ms(ker), "plain_ms": _events_ms(plain),
             "library_ms": None, **b}
        if library:
            r["library_ms"], r["library"] = _sdpa_ms(name, library, plain())
        lib = (f"{r['library_ms']:.4f} ms (SDPA {r['library']})" if library
               else "none (no single PyTorch call)")
        log(f"time {name}: kernel {r['kernel_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['kernel_ms']:.3f} of the bound's rate")
        return r

    res = {"rglru_scan": []}
    a, b = inp["rg_a"], inp["rg_b"]
    n = a.numel()
    for label, h0 in (("zero", torch.zeros_like(inp["rg_h0"])),
                      ("seeded", inp["rg_h0"])):
        res["rglru_scan"].append(timed(
            f"rglru_scan {tuple(a.shape)} f32 {label} h0",
            lambda: rg.rglru_scan(a, b, h0),
            lambda: rg.rglru_scan_plain(a, b, h0),
            **bound(cost.rglru_work(*a.shape, a.dtype))))

    la = LOCAL_ATTN
    q, k, v = (_fold(inp[x]) for x in ("fa_q", "fa_k", "fa_v"))
    S, Dh, BH = la["S"], la["Dh"], q.shape[0]
    mask = fa.allowed("sliding", S, S, la["window"], 0, dev)
    res["flash_attention"] = timed(
        f"flash_attention sliding {la['window']} {tuple(q.shape)} bf16",
        lambda: fa.flash_attention(q, k, v, mode="sliding",
                                   window=la["window"]),
        lambda: fa.flash_attention_plain(q, k, v, mode="sliding",
                                         window=la["window"]),
        lambda: Fn.scaled_dot_product_attention(q[None], k[None], v[None],
                                                attn_mask=mask),
        **bound(cost.flash_work(BH, S, S, Dh, q.dtype, "sliding",
                                la["window"])))
    del q, k, v
    torch.cuda.empty_cache()

    d = DECODE
    q1, kc, vc = inp["dec_q"], inp["dec_k"], inp["dec_v"]
    parts = []
    for length in d["lengths"]:   # slots past length take no part: no mask
        parts.append(timed(
            f"decode_attention {tuple(kc.shape)} bf16 length {length}",
            lambda: da.decode_attention(q1, kc, vc, length),
            lambda: da.decode_attention_plain(q1, kc, vc, length),
            lambda: Fn.scaled_dot_product_attention(
                q1[None], kc[None, :, :length], vc[None, :, :length]),
            **bound(cost.decode_work(d["BH"], length, d["Dh"], kc.dtype))))
    res["decode_attention"] = parts

    # phase 15's heads of 64 (bf16): whisper's encoder self-attention and
    # internvl's prefill on the flash kernel, internvl's decode
    gen = torch.Generator(device=dev)
    gen.manual_seed(ZOO_SEED + 1)
    randn = _randn(gen, dev)
    res["flash_attention_dh64"], res["decode_attention_dh64"] = [], []
    for label, BH, S, mode in (("whisper-tiny encoder", 96, 1500, "bidir"),
                               ("internvl2-1b prefill", 224, 2048,
                                "causal")):
        q, k, v = (randn(BH, S, 64).to(torch.bfloat16) for _ in range(3))
        res["flash_attention_dh64"].append(timed(
            f"flash_attention {mode} {label} {tuple(q.shape)} bf16",
            lambda: fa.flash_attention(q, k, v, mode=mode),
            lambda: fa.flash_attention_plain(q, k, v, mode=mode),
            lambda: Fn.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=mode == "causal"),
            **bound(cost.flash_work(BH, S, S, 64, q.dtype, mode))))
    del q, k, v
    BH, S = 224, 2080
    q1 = randn(BH, 1, 64).to(torch.bfloat16)
    kc, vc = (randn(BH, S, 64).to(torch.bfloat16) for _ in range(2))
    res["decode_attention_dh64"].append(timed(
        f"decode_attention internvl2-1b {tuple(kc.shape)} bf16 length {S}",
        lambda: da.decode_attention(q1, kc, vc, S),
        lambda: da.decode_attention_plain(q1, kc, vc, S),
        lambda: Fn.scaled_dot_product_attention(q1[None], kc[None],
                                                vc[None]),
        **bound(cost.decode_work(BH, S, 64, kc.dtype))))
    del q1, kc, vc
    torch.cuda.empty_cache()

    m = MLSTM
    BH, S, Dh, L = m["B"] * m["H"], m["S"], m["Dh"], m["chunk"]
    fold = lambda t: t.reshape(BH, *t.shape[2:])
    args = tuple(fold(inp[x]) for x in ("ml_q", "ml_k", "ml_v", "ml_li",
                                        "ml_lf"))
    # 3xTF32: three TF32 products on the tensor cores per f32 product
    res["mlstm_scan"] = timed(
        f"mlstm_scan {(BH, S, Dh)} chunk {L} f32",
        lambda: ml.mlstm_scan(*args, chunk=L),
        lambda: ml.mlstm_scan_plain(*args, chunk=L),
        **bound(cost.mlstm_work(BH, S, Dh, L)))
    fp32 = bound(cost.mlstm_work(BH, S, Dh, L, route="fp32"))
    res["mlstm_scan"]["fp32_cores_bound_ms"] = fp32["bound_ms"]
    _, scratch = ml.launch_passes(*args, L, ml.ALL_PASSES)
    passes = {name: _events_ms(lambda: ml.launch_passes(
                  *args, L, mask, scratch))
              for name, mask in (("gates", ml.GATES), ("state", ml.STATE),
                                 ("output", ml.OUTPUT))}
    res["mlstm_scan"]["passes_ms"] = passes
    log(f"time mlstm_scan bounds: 3xTF32 tensor cores "
        f"{res['mlstm_scan']['bound_ms']:.4f} ms, FP32 cores "
        f"{fp32['bound_ms']:.4f} ms; passes (ms): " + ", ".join(
            f"{k} {v:.4f}" for k, v in passes.items()))
    del scratch
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 9. the paper's figures and tables
# ---------------------------------------------------------------------------

#: the generators' seeds of the figures (the reference's: fig5's sweep and
#: table_simulation 0, fig5's validation 1) and of the MC surrogate.
FIG_SEED, FIG_VALIDATE_SEED, SURROGATE_SEED = 0, 1, 0
#: the surrogate: fig12_checkpoint(300) under Weibull(0.7), rho = 5.5.
SURROGATE_MU, SURROGATE_SHAPE = 300.0, 0.7
#: fig5's headline (the reference's own fig5 on the CPU): the energy
#: penalty at k = 0.5, mu = 120, and the band it is held to.
FIG5_HEADLINE, FIG5_BAND = 0.081, 0.005


class _LaunchLog:
    """Records the engine's explicit-kernel calls while active, under the
    part named by ``part``: ``(args, kwargs, n_failures)`` each.  The
    wrapper it wraps still counts every launch."""

    def __init__(self):
        self.calls: dict = {}
        self.part = None

    def __enter__(self):
        from repro_torch.sim import engine as te
        self._real = real = te.event_sweep

        def record(*args, **kw):
            out = real(*args, **kw)
            self.calls.setdefault(self.part, []).append(
                (args, kw, out["n_failures"]))
            return out
        te.event_sweep = record
        return self

    def __exit__(self, *exc):
        from repro_torch.sim import engine as te
        te.event_sweep = self._real


def _surrogate(dev):
    import numpy as np
    from repro_torch.core import (EXASCALE_POWER_RHO55, MCSurrogate, Weibull,
                                  fig12_checkpoint)
    return MCSurrogate(fig12_checkpoint(SURROGATE_MU), EXASCALE_POWER_RHO55,
                       Weibull(shape=SURROGATE_SHAPE),
                       rng=np.random.default_rng(SURROGATE_SEED), device=dev)


def run_figures_path(dev, launch_log=None) -> dict:
    """fig1-3 and both tables (all in f64, as the scripts run), fig5 at
    full size and one ``MCSurrogate.argmin("energy")``, on ``dev``; each
    part's result and host seconds.  ``launch_log`` (a :class:`_LaunchLog`)
    is told which part runs."""
    import numpy as np
    from repro_torch.benchmarks import (fig1_rho_sweep, fig2_mu_rho,
                                        fig3_scalability, fig5_robustness,
                                        table_baselines, table_simulation)
    rng = np.random.default_rng
    parts = {
        "fig1": lambda: fig1_rho_sweep.run(dev),
        "fig2": lambda: fig2_mu_rho.run(dev),
        "fig3": lambda: fig3_scalability.run(dev),
        "table_baselines": lambda: table_baselines.run(dev),
        "table_simulation": lambda: table_simulation.run(rng(FIG_SEED),
                                                         dev),
        "fig5": lambda: fig5_robustness.run(rng(FIG_SEED),
                                            rng(FIG_VALIDATE_SEED), dev),
        "argmin": lambda: _surrogate(dev).argmin("energy")}
    out, secs = {}, {}
    for name, fn in parts.items():
        if launch_log is not None:
            launch_log.part = name
        out[name], secs[name] = _sync_time(fn)
        log(f"figures {name} on {dev}: {secs[name]:.4f} s")
    out["secs"] = secs
    return out


def _max_rel(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        fail(f"figures: shapes differ, {a.shape} and {b.shape}")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                        initial=0.0))


def gate_figures(card: dict, cpu: dict) -> dict:
    """The card's figures against the port's CPU run: periods and values
    within 1e-12 relative (the MSK period, a golden-section argmin, within
    1e-8), fig5's and the surrogate's argmins the same; fig1's headline
    (>20% energy gain at ~10% time loss, mu 300, rho 5.5); fig5's (the
    energy penalty at k 0.5, mu 120 within ``FIG5_BAND`` of 8.1%, the
    grid's largest, the optima within the 2% validation gate)."""
    rel = {}
    for name in ("fig1", "fig2", "fig3"):
        rel[name] = _max_rel(card[name][2], cpu[name][2])
    rows = lambda r, msk: [x[2:] for x in r[2] if (x[1] == "msk_energy")
                           == msk]
    rel["table_baselines"] = _max_rel(rows(card["table_baselines"], False),
                                      rows(cpu["table_baselines"], False))
    rel["table_baselines_msk"] = _max_rel(
        rows(card["table_baselines"], True),
        rows(cpu["table_baselines"], True))
    rel["table_simulation"] = _max_rel(
        [x[1:] for x in card["table_simulation"][2]],
        [x[1:] for x in cpu["table_simulation"][2]])
    res_c, res_h = card["fig5"][0], cpu["fig5"][0]
    rel["fig5"] = max(_max_rel(getattr(res_c, f), getattr(res_h, f))
                      for f in ("eval_periods", "time_penalty_exp",
                                "energy_penalty_exp", "time_penalty_young",
                                "time_penalty_daly", "energy_penalty_young",
                                "energy_penalty_daly", "wall_mc",
                                "energy_mc"))
    rel["argmin"] = _max_rel(card["argmin"], cpu["argmin"])
    log("figures, card against CPU (max relative difference): "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    bad = [k for k, v in rel.items()
           if v > (1e-8 if k == "table_baselines_msk" else 1e-12)]
    if bad:
        fail(f"figures: the card's results differ from the CPU's: {bad}")
    same_picks = bool((res_c.eval_periods[:2] == res_h.eval_periods[:2])
                      .all())
    _, (mu, rho, e_ratio, t_ratio), _ = card["fig1"]
    ep = res_c.energy_penalty_exp
    worst, drift = card["fig5"][2], card["fig5"][3]
    head = {"fig1": {"mu": mu, "rho": rho, "energy_gain": e_ratio - 1.0,
                     "time_loss": t_ratio - 1.0},
            "fig5": {"energy_penalty_k05_mu120": float(ep[0, 0] - 1.0),
                     "largest": bool(ep[0, 0] == ep.max()),
                     "validation_worst": worst, "penalty_drift": drift},
            "argmin_energy": card["argmin"],
            "fig5_same_candidate_picks": same_picks,
            "max_rel_card_vs_cpu": rel}
    log(f"fig1 headline at mu {mu:g}, rho {rho:g}: energy gain "
        f"{(e_ratio - 1) * 100:.2f}%, time loss {(t_ratio - 1) * 100:.2f}%; "
        f"fig5 energy penalty at k 0.5, mu 120: "
        f"{(ep[0, 0] - 1) * 100:.3f}% (largest {head['fig5']['largest']}), "
        f"validation within {worst * 100:.3f}% (gate 2%), penalty drift "
        f"{drift * 100:.3f}%; surrogate energy argmin {card['argmin']:.6f}")
    if not (mu == 300.0 and abs(rho - 5.5) < 0.26 and e_ratio - 1.0 > 0.20
            and 0.05 < t_ratio - 1.0 < 0.15):
        fail("fig1's headline (>20% energy for ~10% time) does not hold")
    if not (abs(ep[0, 0] - 1.0 - FIG5_HEADLINE) <= FIG5_BAND
            and head["fig5"]["largest"] and worst <= 0.02):
        fail("fig5's headline (~8.1% at k 0.5, mu 120, validated) does not "
             "hold")
    if not same_picks:
        fail("fig5: the card picked other candidates than the CPU")
    return head


def phase_candidates(dev) -> dict:
    """The stride-0 launch (one point, the surrogate's schedule, its 17
    first candidates in one launch) against one launch per candidate
    (``simulate_trajectories``), bitwise; and the step scan on the card:
    against the event kernel on a dyadic schedule and against the CPU's
    step scan, bitwise."""
    import numpy as np
    import torch
    from repro_torch.kernels import event_sweep as es
    from repro_torch.sim import (mu_rho_grid, simulate_candidates,
                                 simulate_trajectories)
    sur = _surrogate(dev)
    xs = np.geomspace(sur.lo, sur.hi, 17)
    before = es.event_sweep.launches
    cand = simulate_candidates(xs, sur._grid1, sur.T_base, gaps=sur._gaps,
                               device=dev)
    one_launch = es.event_sweep.launches - before == 1
    fields = ("wall_time", "energy", "work_executed", "io_time",
              "down_time", "n_failures", "n_checkpoints", "truncated",
              "gaps_exhausted")
    stride0_equal = one_launch
    for m, T in enumerate(xs):
        tb = simulate_trajectories(T, sur._grid1, sur.T_base, gaps=sur._gaps,
                                   device=dev)
        stride0_equal &= all(torch.equal(getattr(cand, f)[m],
                                         getattr(tb, f)) for f in fields)
    rng = np.random.default_rng(2029)
    gaps = np.maximum(np.round(rng.exponential(
        1.0, size=(4, 64, 96)) * np.array([120.0, 120.0, 300.0, 300.0])[
        :, None, None] * 2**16) / 2**16, 2.0**-16)
    T = np.array([[32.25, 34.5], [56.75, 60.0]])
    step, event, step_cpu = (
        simulate_trajectories(T, mu_rho_grid([120.0, 300.0], [2.0, 5.5],
                                             device=d), T_base=1500.0,
                              gaps=gaps, engine_kind=k, device=d)
        for k, d in (("step", dev), ("event", dev), ("step", "cpu")))
    step_event = all(torch.equal(getattr(step, f), getattr(event, f))
                     for f in fields)
    step_cpu_equal = all(torch.equal(getattr(step, f).cpu(),
                                     getattr(step_cpu, f)) for f in fields)
    done = not bool(step.truncated.any())
    log(f"candidates: stride-0 launch of 17 candidates (one launch "
        f"{one_launch}) bitwise equal to 17 launches: {stride0_equal}; step "
        f"scan on the card bitwise equal to the event kernel (dyadic): "
        f"{step_event}, to the CPU's step scan: {step_cpu_equal}, all "
        f"lanes done: {done}")
    if not (stride0_equal and step_event and step_cpu_equal and done):
        fail("candidates or step-scan check failed on the card")
    return {"stride0_equal": stride0_equal, "step_equals_event": step_event,
            "step_equals_cpu": step_cpu_equal}


def _launch_bound(calls, peaks) -> dict:
    """The explicit kernel's bound over recorded launches, one launch at a
    time: the gaps its lanes read (each lane its first min(n_failures + 1,
    F); a point stride of 0 shares one schedule row among the launch's
    rows, read once), its outputs and parameters over the memory rate,
    and the update's f64 operations over the FP64 rate; beside it the
    whole schedule read once a launch."""
    import torch
    from repro_torch.kernels import cost
    tot = {"bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0, "gaps": 0,
           "schedule_bytes": 0}
    for args, kw, nf in calls:
        g = args[6]
        rows, N, F = g.shape
        used = torch.clamp_max(nf.to(torch.int64) + 1, F)
        read = used.max(dim=0).values.sum() if g.stride(0) == 0 \
            else used.sum()
        bd = cost.bound_ms(cost.event_sweep_work(
            rows, rows * N, int(read), int(used.sum())), peaks)
        tot["bytes_ms"] += bd["parts_ms"]["bytes"]
        tot["ops_ms"] += bd["parts_ms"]["fp64"]
        tot["bound_ms"] += bd["bound_ms"]
        tot["gaps"] += int(used.sum())
        tot["schedule_bytes"] += (1 if g.stride(0) == 0 else rows) * N * F * 8
    tot["schedule_bytes_ms"] = tot["schedule_bytes"] / peaks.hbm_bw * 1e3
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                       else "operations")
    return tot


def _prepared_launches(calls):
    """A call that launches the explicit kernel over the recorded calls'
    arguments made ready once (contiguous parameters, outputs allocated),
    so that it times the kernel without the wrapper's host work."""
    import torch
    from repro_torch.kernels import _build, event_sweep as es
    fn = es.load_library().repro_event_sweep
    ready = []
    for args, kw, _ in calls:
        params = [x.contiguous() for x in args[:6]]
        g = args[6]
        B, N, F = g.shape
        outs = es._outputs(B, N, g.device)
        ready.append((params, g, outs, [
            int(g.dtype == torch.float64), int(bool(kw["compensated"])),
            *[x.data_ptr() for x in params], g.data_ptr(), *g.stride(), B,
            N, F, int(kw["n_steps"]), *[o.data_ptr() for o in outs]]))

    def call():
        for params, g, outs, a in ready:
            _build.launch(fn, *a, device=g.device, name="event_sweep")
        return ready
    return call


def phase_figure_times(launch_log, peaks) -> dict:
    """The explicit kernel on the figures path's own launches, per part
    (fig5, the surrogate's argmin): the recorded calls replayed back to
    back through the kernel's wrapper (``ms``, host work included) and on
    arguments made ready once (``kernel_ms``), and through its plain
    version (on the card; compared bitwise), each part's times beside its
    bound."""
    from repro_torch.kernels import event_sweep as es
    out = {}
    for part in ("fig5", "argmin"):
        calls = launch_log.calls.get(part, [])
        if not calls:
            fail(f"figures: {part} made no explicit-kernel launch")
        run_k = lambda: [es.event_sweep(*a, **k) for a, k, _ in calls]
        run_p = lambda: [es.event_sweep_plain(*a, **k) for a, k, _ in calls]
        equal, err = True, 0.0
        for x, y in zip(run_k(), run_p()):
            e, d = _compare(x, y)
            equal, err = equal and e, max(err, d)
        if not equal:
            fail(f"figures: explicit kernel != plain version on {part}")
        t = dict(_launch_bound(calls, peaks), launches=len(calls),
                 rows=sum(a[6].shape[0] for a, _, _ in calls),
                 ms=_events_ms(run_k),
                 kernel_ms=_events_ms(_prepared_launches(calls)),
                 plain_ms=_events_ms(run_p, reps=1),
                 bitwise=equal, max_abs_err=err)
        log(f"time figures {part}: explicit kernel {t['ms']:.4f} ms over "
            f"{t['launches']} launches ({t['rows']} rows) through the "
            f"wrapper, {t['kernel_ms']:.4f} ms on arguments made ready "
            f"once, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; bytes {t['bytes_ms']:.4f}, operations "
            f"{t['ops_ms']:.4f}); the whole schedule once a launch "
            f"{t['schedule_bytes_ms']:.4f} ms")
        out[part] = t
    return out


# ---------------------------------------------------------------------------
# 10. the multilevel (buddy + PFS) path
# ---------------------------------------------------------------------------

#: ml-sweep-262k: fig4's scenario family, buddy ratio x q geomspaced,
#: 512 x 512, mu 300, fig4's cadences; every ML_SWEEP_STRIDE-th point is
#: solved again on the CPU.
ML_SWEEP_AXES = ((0.01, 1.0, 512), (0.001, 0.5, 512))
ML_SWEEP_MU = 300.0
ML_M_VALUES = tuple(range(1, 13))
ML_SWEEP_STRIDE = 64
#: ml-mc-1024x4096: the reference's two-level MC sizing case, at its
#: jointly optimal (T, m), schedules from default_rng(ML_MC_SEED); lanes of
#: ML_CPU_POINTS points x ML_CPU_TRIALS trials are run again on the CPU.
ML_MC_AXES = ((0.02, 1.0, 32), (0.01, 0.4, 32))
ML_MC_MU = 600.0
ML_MC_SEED = 0
ML_CPU_POINTS, ML_CPU_TRIALS = 72, 64
#: the MC means' largest gap to the first-order closed forms where
#: m T < mu: the reference's 2% at AlgoT; at AlgoE the forms sit up to
#: 2.09% above this run's MC (q 0.36-0.40), and the reference's own
#: simulate_grid_ml (seed 0, 4096 trials) reads 1.67% and 2.05% (standard
#: error 0.13%) at the two points beyond 2%
#: (tests/test_torch_multilevel.py, TestFirstOrderGap): 2.5% is the card's
#: reading plus three standard errors.
ML_MODEL_GAP = {"algo_t": 0.02, "algo_e": 0.025}
#: fig4's headline (the reference's own fig4 on the CPU): energy below
#: PFS-only, buddy ratio, q, m*.
FIG4_HEADLINE = (0.4056, 0.02, 0.01, 12)
#: the m = 1 reduction's schedule (a seeded numpy generator).
ML_M1_SEED = 2030


def _geom_grid(axes, mu, dev):
    import numpy as np
    from repro_torch.sim import buddy_ratio_grid
    (r0, r1, nr), (q0, q1, nq) = axes
    return buddy_ratio_grid(np.geomspace(r0, r1, nr), np.geomspace(q0, q1, nq),
                            mu_min=mu, device=dev)


def _peak_time(fn):
    """``(result, host-clock s, peak device bytes above what was allocated
    before)`` of ``fn``."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, secs = _sync_time(fn)
    return out, secs, torch.cuda.max_memory_allocated() - base


def run_ml_sweep(dev, mlog) -> tuple:
    """ml-sweep-262k: ``evaluate_multilevel_grid`` under f64 and
    compensated f32; (grid, {policy: result}, {policy: numbers})."""
    from repro_torch.sim import (COMPENSATED_F32, F64, chunk_plan,
                                 evaluate_multilevel_grid)
    from repro_torch.sim.sweep import _ML_BYTES_PER_POINT_M
    grid = _geom_grid(ML_SWEEP_AXES, ML_SWEEP_MU, dev)
    chunks = len(chunk_plan(grid.size,
                            _ML_BYTES_PER_POINT_M * len(ML_M_VALUES)))
    res, nums = {}, {}
    for pol in (F64, COMPENSATED_F32):
        res[pol.name], secs, peak = _peak_time(
            lambda: evaluate_multilevel_grid(grid, m_values=ML_M_VALUES,
                                             precision=pol, device=dev))
        nums[pol.name] = {"host_s": secs, "chunks": chunks,
                          "peak_bytes": peak}
        mlog(f"ml-sweep-262k evaluate_multilevel_grid {grid.size} points x "
             f"{len(ML_M_VALUES)} cadences [{pol.name}]: {secs:.4f} s host "
             f"clock (cold), {chunks} chunks, peak device memory {peak} B")
    return grid, res, nums


def gate_ml_sweep(grid, res, mlog) -> dict:
    """The card's f64 result against the port's CPU run on every
    ``ML_SWEEP_STRIDE``-th point (within 1e-12 relative, the same m picks,
    valid and NaN positions); compensated f32 against f64 by the
    reference's multilevel gate (tests/test_pallas_engine.py,
    ``test_multilevel_family``): m flips of at most one notch, the f32
    pick's f64 energy within 10 ``objective_tol`` of the f64 optimum, and
    the periods compared directly, ``|T32 - T64| / T64`` within
    ``argmin_rtol``, at every point where the m picks agree.  Where they
    differ by a notch (a near-tie between two cadences), the two periods
    are optima of different cadences and the direct reading is printed,
    not gated: there the f32 period is held within ``argmin_rtol`` of the
    f64 period of its own cadence."""
    import torch
    from repro_torch.sim import COMPENSATED_F32, evaluate_multilevel_grid
    from repro_torch.sim.sweep import _ML_BY_M_ORDER, _ML_OUT_ORDER
    r64, r32 = res["f64"], res["compensated_f32"]
    idx = torch.arange(0, grid.size, ML_SWEEP_STRIDE, device=grid.device)
    sub = grid.take(idx)
    cpu = evaluate_multilevel_grid(sub.to("cpu"), m_values=ML_M_VALUES,
                                   precision="f64", device="cpu")
    worst, same = 0.0, True
    for f in _ML_OUT_ORDER + _ML_BY_M_ORDER:
        x = getattr(r64, f)
        x = x.reshape(-1)[idx] if x.dim() == len(grid.shape) else \
            x.reshape(x.shape[0], -1)[:, idx]
        y = getattr(cpu, f)
        x = x.cpu()
        if x.dtype in (torch.bool, torch.int64):
            same &= torch.equal(x, y)
            continue
        same &= torch.equal(torch.isnan(x), torch.isnan(y))
        ok = ~torch.isnan(y)
        if bool(ok.any()):
            worst = max(worst, float(((x - y).abs()[ok]
                                      / y.abs()[ok].clamp_min(1e-300)).max()))
    mlog(f"ml-sweep-262k card f64 against the CPU on {idx.numel()} points: "
         f"max rel {worst:.3e} (<= 1e-12), same m picks, valid and NaN "
         f"positions: {same}")
    if worst > 1e-12 or not same:
        fail("ml-sweep-262k: the card's f64 result differs from the CPU's")

    pol = COMPENSATED_F32
    v = r64.valid
    if not torch.equal(v, r32.valid):
        fail("ml-sweep-262k: valid masks differ between policies")
    out = {"cpu_points": idx.numel(), "cpu_max_rel": worst}
    for T, m, Tm in (("T_time", "m_time", "T_time_by_m"),
                     ("T_energy", "m_energy", "T_energy_by_m")):
        m64, m32 = getattr(r64, m), getattr(r32, m)
        T64, T32 = getattr(r64, T), getattr(r32, T)
        direct = (T32 - T64).abs() / T64
        same_m, flip = v & (m64 == m32), v & (m64 != m32)
        at_pick = torch.gather(getattr(r64, Tm), 0,
                               (m32 - ML_M_VALUES[0])[None])[0]
        own = ((T32 - at_pick).abs() / at_pick)[flip]
        arg = float(direct[same_m].max())
        flips = int(flip.sum())
        notch = int((m64 - m32)[v].abs().max())
        flip_direct = [float(direct[flip].min()), float(direct[flip].max())] \
            if flips else None
        flip_own = float(own.max()) if flips else 0.0
        out[T] = {"argmin_rel": arg, "m_flips": flips, "max_notch": notch,
                  "flipped_direct_rel": flip_direct,
                  "flipped_own_cadence_rel": flip_own}
        mlog(f"ml-sweep-262k compensated {T}: {int(v.sum())} valid points; "
             f"|T32 - T64| / T64 at the {int(same_m.sum())} points with the "
             f"same m: max {arg:.3e} (<= {pol.argmin_rtol}); m flips "
             f"{flips}, largest {notch} notch (<= 1)"
             + (f"; at the flipped points |T32 - T64| / T64 "
                f"{flip_direct[0]:.3e} to {flip_direct[1]:.3e} (not gated: "
                f"optima of different cadences), T32 against the f64 period "
                f"of its own cadence max {flip_own:.3e} (<= "
                f"{pol.argmin_rtol})" if flips else ""))
        if arg > pol.argmin_rtol or flip_own > pol.argmin_rtol or notch > 1:
            fail(f"ml-sweep-262k: compensated {T} outside its gate")
    E64 = r64.E_by_m
    at64 = torch.gather(E64, 0, (r64.m_energy - ML_M_VALUES[0])[None])[0]
    at32 = torch.gather(E64, 0, (r32.m_energy - ML_M_VALUES[0])[None])[0]
    obj = float(((at32 - at64).abs() / at64.abs())[v].max())
    out["energy_objective_rel"] = obj
    mlog(f"ml-sweep-262k compensated AlgoE pick's f64 energy: max rel "
         f"{obj:.3e} (<= {10 * pol.objective_tol:g})")
    if obj > 10 * pol.objective_tol:
        fail("ml-sweep-262k: the compensated pick's energy is off")
    return out


def run_ml_mc(dev, mlog) -> tuple:
    """ml-mc-1024x4096 at the AlgoT and the AlgoE (T, m), f64: each
    schedule drawn by ``presample_failures`` from ``default_rng(0)`` on the
    host, moved to the card once, and swept by ``simulate_trajectories_ml``;
    (grid, solved result, {algo: run})."""
    import numpy as np
    import torch
    from repro_torch.sim import (F64, default_fail_capacity_ml,
                                 evaluate_multilevel_grid, presample_failures,
                                 simulate_trajectories_ml)
    from repro_torch.sim.engine import _ml_energy
    grid = _geom_grid(ML_MC_AXES, ML_MC_MU, dev)
    sol = evaluate_multilevel_grid(grid, m_values=ML_M_VALUES, precision=F64,
                                   device=dev)
    runs = {}
    for algo, T, m in (("algo_t", sol.T_time, sol.m_time),
                       ("algo_e", sol.T_energy, sol.m_energy)):
        cap = default_fail_capacity_ml(T.reshape(-1), m.reshape(-1),
                                       grid.ravel(), T_BASE)
        t0 = time.perf_counter()
        gaps, hard = presample_failures(grid, N_TRIALS, cap,
                                        np.random.default_rng(ML_MC_SEED))
        pre_s = time.perf_counter() - t0
        (g, h), h2d_s = _sync_time(lambda: (
            torch.as_tensor(gaps, device=dev),
            torch.as_tensor(hard, device=dev)))
        tb, call_s, peak = _peak_time(lambda: simulate_trajectories_ml(
            T, m, grid, T_BASE, gaps=g, hard=h, device=dev))
        fields = {k: getattr(tb, k).reshape(grid.size, -1) for k in (
            "wall_time", "work_executed", "io1_time", "io2_time",
            "down_time")}
        _, energy_s = _sync_time(lambda: _ml_energy(fields, grid, N_TRIALS))
        scan_s = call_s - energy_s
        nums = {"capacity": cap, "n_steps": tb.n_steps, "steps": tb.steps,
                "presample_s": pre_s, "h2d_s": h2d_s, "call_s": call_s,
                "scan_s": scan_s, "energy_s": energy_s,
                "ms_per_step": scan_s / max(tb.steps, 1) * 1e3,
                "schedule_bytes": gaps.nbytes + hard.nbytes,
                "peak_bytes": peak,
                "m_range": [int(m.min()), int(m.max())],
                "T_range": [float(T.min()), float(T.max())]}
        mlog(f"ml-mc-1024x4096 {algo}: m {nums['m_range']}, T "
             f"{nums['T_range'][0]:.2f}-{nums['T_range'][1]:.2f} min, "
             f"capacity {cap}, schedule {nums['schedule_bytes']} B; host "
             f"clock: numpy presampling {pre_s:.4f} s, H2D copy {h2d_s:.4f} "
             f"s, simulate_trajectories_ml {call_s:.4f} s (scan {scan_s:.4f} "
             f"s, energy integral {energy_s:.4f} s); {tb.steps} steps of "
             f"the {tb.n_steps} budget, {nums['ms_per_step']:.4f} ms a step; "
             f"peak device memory {peak} B above the schedule")
        runs[algo] = (T, m, gaps, hard, tb, nums)
        del g, h
    return grid, sol, runs


def gate_ml_mc(grid, runs, mlog) -> dict:
    """No truncated or exhausted lane; ``ML_CPU_POINTS`` (point, trial
    block) lanes run again on the CPU, bitwise equal (gated at 1e-12 if
    not, with the differing fields named); the per-point means against
    ``ml_time_final`` / ``ml_energy_final`` within ``ML_MODEL_GAP`` at
    every point with m T < mu (2% at AlgoT, 2.5% at AlgoE), the points
    beyond 2% printed, the gap everywhere reported."""
    import numpy as np
    import torch
    from repro_torch.sim import simulate_trajectories_ml
    from repro_torch.sim.sweep import (ml_energy_final_batched,
                                       ml_time_final_batched)
    report = {}
    for algo, (T, m, gaps, hard, tb, nums) in runs.items():
        bad = int(tb.truncated.sum()) + int(tb.gaps_exhausted.sum())
        if bad:
            fail(f"ml-mc-1024x4096 {algo}: {bad} truncated or exhausted "
                 f"lanes")
        flat_T, flat_m = T.reshape(-1), m.reshape(-1)
        pts = np.linspace(0, grid.size - 1, ML_CPU_POINTS).astype(np.int64)
        t0 = (np.arange(ML_CPU_POINTS) * 57) % (N_TRIALS - ML_CPU_TRIALS)
        rows = pts[:, None]
        cols = t0[:, None] + np.arange(ML_CPU_TRIALS)[None, :]
        sub = grid.take(torch.as_tensor(pts, device=grid.device)).to("cpu")
        cpu = simulate_trajectories_ml(
            flat_T[pts].cpu(), flat_m[pts].cpu(), sub, T_BASE,
            gaps=gaps[rows, cols], hard=hard[rows, cols],
            n_steps=tb.n_steps, device="cpu")
        differ, worst = [], 0.0
        for f in ("wall_time", "energy", "work_executed", "io1_time",
                  "io2_time", "down_time", "n_failures", "n_hard_failures",
                  "n_ckpt1", "n_ckpt2", "truncated", "gaps_exhausted"):
            x = getattr(tb, f).reshape(grid.size, -1).cpu()[rows, cols]
            y = getattr(cpu, f)
            if not torch.equal(x, y):
                differ.append(f)
                if x.is_floating_point():
                    worst = max(worst, float(((x - y).abs()
                                              / y.abs()).max()))
                else:
                    worst = math.inf
        mlog(f"ml-mc-1024x4096 {algo}: {ML_CPU_POINTS} points x "
             f"{ML_CPU_TRIALS} trials on the CPU: bitwise "
             f"{not differ}" + (f" (differ: {differ}, max rel {worst:.3e}, "
                                f"<= 1e-12)" if differ else ""))
        if worst > 1e-12:
            fail(f"ml-mc-1024x4096 {algo}: the card differs from the CPU")
        p = grid.ravel().fields()
        mf = flat_m.to(torch.float64)
        tf = ml_time_final_batched(flat_T, mf, p, T_BASE)
        e = ml_energy_final_batched(flat_T, mf, p, T_BASE)
        first = flat_m * flat_T < p["mu"]
        gt = tb.wall_time.reshape(grid.size, -1).mean(-1) / tf - 1
        ge = tb.energy.reshape(grid.size, -1).mean(-1) / e - 1
        gaps_rep = {}
        for where, sel in (("m_T_below_mu", first),
                           ("all", torch.ones_like(first))):
            gaps_rep[where] = {
                "points": int(sel.sum()),
                "time": [float(gt[sel].min()), float(gt[sel].max())],
                "energy": [float(ge[sel].min()), float(ge[sel].max())],
                "beyond_2pct": int(((gt.abs() > 0.02) | (ge.abs() > 0.02))
                                   [sel].sum())}
        f = gaps_rep["m_T_below_mu"]
        bound = ML_MODEL_GAP[algo]
        worst = max(abs(x) for x in f["time"] + f["energy"])
        (r0, r1, nr), (q0, q1, nq) = ML_MC_AXES
        ratios, qs = np.geomspace(r0, r1, nr), np.geomspace(q0, q1, nq)
        beyond = [{"point": k, "ratio": float(ratios[k // nq]),
                   "q": float(qs[k % nq]), "T": float(flat_T[k]),
                   "m": int(flat_m[k]), "time": float(gt[k]),
                   "energy": float(ge[k])}
                  for k in torch.nonzero(first & ((gt.abs() > 0.02)
                                                  | (ge.abs() > 0.02)))
                  .reshape(-1).tolist()]
        gaps_rep["beyond_2pct_points"] = beyond
        mlog(f"ml-mc-1024x4096 {algo}: MC means against the closed forms "
             f"(MC / model - 1) at the {f['points']} of {grid.size} points "
             f"with m T < mu: time {f['time'][0]:+.4f} to "
             f"{f['time'][1]:+.4f}, energy {f['energy'][0]:+.4f} to "
             f"{f['energy'][1]:+.4f}, largest {worst:.4f} (<= {bound}), "
             f"{f['beyond_2pct']} points beyond 2%"
             + "".join(f"; point {b['point']} (ratio {b['ratio']:.6g}, q "
                       f"{b['q']:.6g}, T {b['T']:.4f}, m {b['m']}): time "
                       f"{b['time']:+.5f}, energy {b['energy']:+.5f}"
                       for b in beyond)
             + f"; all points: energy {gaps_rep['all']['energy'][0]:+.4f} "
             f"to {gaps_rep['all']['energy'][1]:+.4f} (not gated)")
        if worst > bound:
            fail(f"ml-mc-1024x4096 {algo}: the MC means are {worst:.4f} "
                 f"from the closed forms where m T < mu (> {bound})")
        report[algo] = dict(nums, cpu_bitwise=not differ,
                            cpu_differ=differ, cpu_max_rel=worst,
                            model_gap=gaps_rep)
    return report


#: the reference's MC acceptance case (tests/test_multilevel.py,
#: TestMonteCarloValidation): its 2 x 2 grid, cadences 1..4, 400 trials
#: drawn from seed 5, T_base 4000.
ML_REF_CASE = dict(ratios=[0.1, 0.25], qs=[0.1, 0.3], mu=600.0,
                   m_values=(1, 2, 3, 4), n_trials=400, seed=5)


def gate_ml_reference_case(dev, mlog) -> dict:
    """The reference's own acceptance gate on the card: at both joint
    optima of its 2 x 2 case, ``simulate_grid_ml``'s means within 2% of
    ``ml_time_final`` / ``ml_energy_final`` at every point, and the
    AlgoT choice's simulated makespan below the PFS-only optimum's."""
    import numpy as np
    import torch
    from repro_torch.sim import (F64, buddy_ratio_grid,
                                 evaluate_multilevel_grid, simulate_grid_ml)
    from repro_torch.sim.sweep import (ml_energy_final_batched,
                                       ml_time_final_batched)
    c = ML_REF_CASE
    grid = buddy_ratio_grid(c["ratios"], c["qs"], mu_min=c["mu"], device=dev)
    res = evaluate_multilevel_grid(grid, m_values=c["m_values"],
                                   precision=F64, device=dev)
    p = grid.fields()
    out = {}
    for algo in ("time", "energy"):
        T, m = getattr(res, f"T_{algo}"), getattr(res, f"m_{algo}")
        sim = simulate_grid_ml(T, m, grid, T_BASE, n_trials=c["n_trials"],
                               rng=np.random.default_rng(c["seed"]),
                               device=dev)
        mf = m.to(torch.float64)
        gt = float((sim["T_final"] / ml_time_final_batched(
            T, mf, p, T_BASE) - 1).abs().max())
        ge = float((sim["E_final"] / ml_energy_final_batched(
            T, mf, p, T_BASE) - 1).abs().max())
        out[algo] = {"time": gt, "energy": ge}
    one = evaluate_multilevel_grid(grid, m_values=(1,), precision=F64,
                                   device=dev)
    wins = all(bool(x) for x in (simulate_grid_ml(
        res.T_time, res.m_time, grid, T_BASE, n_trials=300,
        rng=np.random.default_rng(9), device=dev)["T_final"]
        < simulate_grid_ml(one.T_time, one.m_time, grid, T_BASE,
                           n_trials=300, rng=np.random.default_rng(9),
                           device=dev)["T_final"]).reshape(-1))
    out["beats_pfs_only"] = wins
    mlog(f"the reference's MC acceptance case on the card (2 x 2, m 1..4, "
         f"400 trials): largest gap to the closed forms at AlgoT time "
         f"{out['time']['time']:.4f}, energy {out['time']['energy']:.4f}; "
         f"at AlgoE time {out['energy']['time']:.4f}, energy "
         f"{out['energy']['energy']:.4f} (<= 0.02); the joint (T, m) beats "
         f"PFS-only in the simulator: {wins}")
    if max(max(v.values()) for v in (out["time"], out["energy"])) > 0.02 \
            or not wins:
        fail("the reference's MC acceptance case fails on the card")
    return out


def run_ml_figs(dev) -> dict:
    """fig4 at the reference's size, ``sweep_buddy_ratio`` on fig4's axes
    (batched, f64 through ``$REPRO_PRECISION``) and ``energy_study``
    (``default_rng(0)``) on ``dev``; each part's result and host
    seconds."""
    import os
    from unittest import mock

    import numpy as np
    from repro_torch.benchmarks import energy_study, fig4_multilevel as f4
    from repro_torch.core import sweep_buddy_ratio

    def _f64_sweep():
        with mock.patch.dict(os.environ, {"REPRO_PRECISION": "f64"}):
            return sweep_buddy_ratio(f4.RATIOS, f4.QS, f4.MU_MIN, device=dev)

    parts = {
        "fig4": lambda: f4.run(dev),
        "sweep_buddy_ratio": _f64_sweep,
        "energy_study": lambda: energy_study.run(np.random.default_rng(0),
                                                 dev)}
    out, secs = {}, {}
    for name, fn in parts.items():
        out[name], secs[name] = _sync_time(fn)
    out["secs"] = secs
    return out


def gate_ml_figs(card: dict, cpu: dict, mlog) -> dict:
    """The card within 1e-12 of the port's CPU run (fig4's and the sweep's
    numbers, the same cadences; energy_study's printed lines equal), and
    fig4's headline (40.56% below PFS-only at ratio 0.02, q 0.01,
    m* = 12)."""
    rel = {}
    keys = ("T_time", "T_energy", "time_ratio", "energy_ratio",
            "time_vs_single", "energy_vs_single")
    rows = lambda r: [[row[k] for k in row] for row in r[3]]
    rel["fig4"] = _max_rel(rows(card["fig4"]), rows(cpu["fig4"]))
    pts = lambda s: [[getattr(p, k) for k in keys + ("m_time", "m_energy")]
                     for row in s for p in row]
    rel["sweep_buddy_ratio"] = _max_rel(pts(card["sweep_buddy_ratio"]),
                                        pts(cpu["sweep_buddy_ratio"]))
    lines_equal = card["energy_study"] == cpu["energy_study"]
    head = card["fig4"][2]
    mlog("figs-fig4, card against CPU (max relative difference): "
         + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
         + f"; energy_study lines equal: {lines_equal}; fig4 headline "
         f"{head[0] * 100:.4f}% below PFS-only at ratio {head[1]:g}, q "
         f"{head[2]:g}, m* {head[3]}; host clock s: card {card['secs']}, "
         f"CPU {cpu['secs']}")
    if max(rel.values()) > 1e-12 or not lines_equal:
        fail("figs-fig4: the card's results differ from the CPU's")
    if not (abs(head[0] - FIG4_HEADLINE[0]) < 5e-5
            and tuple(head[1:]) == FIG4_HEADLINE[1:]):
        fail("figs-fig4: fig4's headline (40.56% at ratio 0.02, q 0.01, "
             "m* 12) does not hold")
    return {"max_rel_card_vs_cpu": rel, "energy_study_lines_equal":
            lines_equal, "fig4_headline": list(head),
            "host_s": {"card": card["secs"], "cpu": cpu["secs"]}}


def _ml_m1_case(dev, dyadic: bool, kinds: bool = True):
    """The m = 1 reduction on ``dev``: the lift of a 2 x 2 single-level
    grid (q = 0.3) through ``simulate_trajectories_ml(T, 1)`` and, with
    ``kinds``, beside it the single-level step kind and, on a dyadic
    schedule, the event kind (the explicit kernel on the card)."""
    import numpy as np
    from repro_torch.sim import (MultilevelParamGrid, mu_rho_grid,
                                 simulate_trajectories,
                                 simulate_trajectories_ml)
    rng = np.random.default_rng(ML_M1_SEED)
    gaps = rng.exponential(1.0, size=(4, 256, 128)) * np.array(
        [120.0, 120.0, 300.0, 300.0])[:, None, None]
    if dyadic:
        gaps = np.maximum(np.round(gaps * 2**16) / 2**16, 2.0**-16)
    hard = rng.random(gaps.shape) < 0.3
    T = np.array([[32.25, 34.5], [56.75, 60.0]])
    sl = mu_rho_grid([120.0, 300.0], [2.0, 5.5], device=dev)
    ml = simulate_trajectories_ml(
        T, 1, MultilevelParamGrid.from_single_level(sl, q=0.3), 1500.0,
        gaps=gaps, hard=hard, device=dev)
    names = ("step", "event") if dyadic else ("step",)
    return ml, {k: simulate_trajectories(T, sl, T_base=1500.0, gaps=gaps,
                                         engine_kind=k, device=dev)
                for k in (names if kinds else ())}


def _ml_m1_equal(ml, one) -> tuple:
    """(every trajectory output bitwise equal, energy bitwise equal, max
    energy rel) of the lift's scan against a single-level batch."""
    import torch
    pairs = ((one.wall_time, ml.wall_time),
             (one.work_executed, ml.work_executed),
             (one.io_time, ml.io1_time + ml.io2_time),
             (one.down_time, ml.down_time),
             (one.n_failures, ml.n_failures),
             (one.n_checkpoints, ml.n_ckpt1 + ml.n_ckpt2),
             (one.truncated, ml.truncated),
             (one.gaps_exhausted, ml.gaps_exhausted))
    traj = all(torch.equal(a, b) for a, b in pairs)
    e_rel = float(((ml.energy - one.energy).abs() / one.energy.abs()).max())
    return traj, torch.equal(ml.energy, one.energy), e_rel


def phase_ml_m1(dev, mlog) -> dict:
    """On the card: the lift's m = 1 scan bitwise equal to the step kind
    and the explicit event kernel on a dyadic schedule, and to the step
    kind on a raw one (every trajectory output; the energy integral prices
    each level's I/O at its own power, so on the raw schedule it is held
    at 1e-15); the card's scan bitwise equal to the CPU's."""
    import torch
    out = {}
    for dyadic in (True, False):
        ml, kinds = _ml_m1_case(dev, dyadic)
        ml_cpu, _ = _ml_m1_case("cpu", dyadic, kinds=False)
        cpu_equal = all(torch.equal(getattr(ml, f).cpu(), getattr(ml_cpu, f))
                        for f in ("wall_time", "energy", "work_executed",
                                  "io1_time", "io2_time", "down_time",
                                  "n_failures", "n_hard_failures",
                                  "n_ckpt1", "n_ckpt2"))
        label = "dyadic" if dyadic else "raw"
        res = {"card_equals_cpu": cpu_equal,
               "hard_failures": int(ml.n_hard_failures.sum())}
        for kind, one in kinds.items():
            traj, energy, e_rel = _ml_m1_equal(ml, one)
            res[kind] = {"trajectories_bitwise": traj,
                         "energy_bitwise": energy, "energy_max_rel": e_rel}
            mlog(f"m = 1 reduction ({label} schedule) against the {kind} "
                 f"kind on the card: trajectories bitwise {traj}, energy "
                 f"bitwise {energy} (max rel {e_rel:.3e}); the card's scan "
                 f"bitwise the CPU's: {cpu_equal}")
            if not (traj and (energy if dyadic else e_rel <= 1e-15)):
                fail(f"m = 1 reduction ({label}) differs from the {kind} "
                     f"kind")
        if not cpu_equal or bool(ml.truncated.any()):
            fail(f"m = 1 reduction ({label}): card != CPU or truncated")
        out[label] = res
    return out


def phase_multilevel(dev, card: str) -> dict:
    """Phase 10: ml-sweep-262k, ml-mc-1024x4096, figs-fig4 and the m = 1
    reduction, each driven with the counts set to 0 just before it and
    read just after: the sweep and the two-level scan launch no kernel
    (plain PyTorch) and call no plain version; the figures launch the
    explicit event kernel (energy_study's robustness rows) and the sampled
    one (its single-level MC point); the m = 1 check launches the explicit
    kernel.  Every line carries the card's name and power limit."""
    import torch
    mlog = lambda msg: log(f"{msg} [{card}]")
    report, counts = {}, {}
    t_phase = time.perf_counter()

    _reset_counts()
    grid, sweeps, nums = run_ml_sweep(dev, mlog)
    torch.cuda.synchronize()
    counts["sweep"] = _counts()
    report["ml_sweep"] = dict(gate_ml_sweep(grid, sweeps, mlog), runs=nums)
    del grid, sweeps
    torch.cuda.empty_cache()

    _reset_counts()
    grid, _, runs = run_ml_mc(dev, mlog)
    report["ml_mc_reference_case"] = gate_ml_reference_case(dev, mlog)
    torch.cuda.synchronize()
    counts["mc"] = _counts()
    report["ml_mc"] = gate_ml_mc(grid, runs, mlog)
    del grid, runs
    torch.cuda.empty_cache()
    for part in ("sweep", "mc"):
        c = counts[part]
        if any(v for k, v in c.items()):
            fail(f"the multilevel {part} launched a kernel or called a "
                 f"plain version: {c}")

    _reset_counts()
    figs = run_ml_figs(dev)
    torch.cuda.synchronize()
    counts["figs"] = c = _counts()
    if (c["event_sweep"] <= 0 or c["event_sweep_sampled"] <= 0
            or c["plain"]):
        fail(f"figs-fig4 did not run through the event kernels alone: {c}")
    from repro_torch.benchmarks import _util as fig_util
    card_results = fig_util.RESULTS
    fig_util.RESULTS = card_results / "cpu"
    figs_cpu = run_ml_figs(torch.device("cpu"))
    fig_util.RESULTS = card_results
    report["figs_fig4"] = gate_ml_figs(figs, figs_cpu, mlog)

    _reset_counts()
    report["m1"] = phase_ml_m1(dev, mlog)
    torch.cuda.synchronize()
    counts["m1"] = c = _counts()
    if c["event_sweep"] <= 0 or c["plain"]:
        fail(f"the m = 1 reduction did not run the explicit event kernel "
             f"alone: {c}")
    mlog("multilevel path launches: " + "; ".join(
        f"{part} event_sweep {c['event_sweep']}, event_sweep_sampled "
        f"{c['event_sweep_sampled']}, plain-version calls {c['plain']}"
        for part, c in counts.items()))
    report["launches"] = {part: {k: c[k] for k in (
        "event_sweep", "event_sweep_sampled", "plain")}
        for part, c in counts.items()}
    report["phase_s"] = time.perf_counter() - t_phase
    mlog(f"multilevel phase: {report['phase_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# 11. the checkpoint advisor
# ---------------------------------------------------------------------------

#: (requests, generator seed) of the phase's workloads: the reference's
#: burst (bench_advisor: 512 single-level, seed 42), a mixed 512 (two-tier
#: share 0.5, seed 11) and the 16,384-request mixed burst of the split.
ADV_BURST_SEED = 42
ADV_MIXED = (512, 11)
ADV_BIG = (16384, 12)
#: card against the port's CPU run, both in f64.
ADV_CROSS_RTOL = 1e-12
ADV_SPEEDUP_FLOOR = 20.0
ADV_SPLIT = ("fingerprint", "grids", "solve_single", "solve_ml",
             "certificate", "readback", "advice")


def _adv_requests(n: int, seed: int, two_tier_frac: float = 0.5):
    import numpy as np
    from repro_torch.serve import synthetic_requests
    return synthetic_requests(n, np.random.default_rng(seed),
                              two_tier_frac=two_tier_frac)


def _adv_compare(card, cpu, what: str, alog) -> dict:
    """Card against CPU advice, both f64: floats within ADV_CROSS_RTOL,
    picks and flags equal; returns the largest relative differences."""
    import math
    from repro_torch.serve import Quantization
    tol = Quantization().tol
    floats = ("period", "predicted_wall", "predicted_energy", "T_time",
              "T_energy", "vs_single")
    exact = ("deep_every", "m_time", "m_energy", "store", "valid", "exact",
             "cache_hit")
    worst = dict.fromkeys(floats + ("cert_bound",), 0.0)
    for i, (a, b) in enumerate(zip(card, cpu)):
        for k in exact:
            if getattr(a, k) != getattr(b, k):
                fail(f"advisor {what}: request {i} {k} {getattr(a, k)!r} on "
                     f"the card, {getattr(b, k)!r} on the CPU")
        if (a.cert_bound <= tol) != (b.cert_bound <= tol):
            fail(f"advisor {what}: request {i} certified on one side only")
        for k in worst:
            x, y = getattr(a, k), getattr(b, k)
            if math.isnan(x) and math.isnan(y):
                continue
            worst[k] = max(worst[k], abs(x - y) / max(abs(y), 1e-300))
    alog(f"advisor {what}: card against CPU (f64), {len(card)} requests, "
         "largest relative differences " + ", ".join(
             f"{k} {v:.3e}" for k, v in worst.items()))
    bad = {k: v for k, v in worst.items()
           if k != "cert_bound" and not v <= ADV_CROSS_RTOL}
    if bad:
        fail(f"advisor {what}: card and CPU differ beyond "
             f"{ADV_CROSS_RTOL}: {bad}")
    return worst


def _adv_objectives(reqs, T, m):
    """(time, energy) objectives of each request at (T, m) in f64 on the
    host, from the port's closed forms (T_base scaled)."""
    import torch
    from repro_torch.sim import sweep
    f64 = lambda xs: torch.tensor(xs, dtype=torch.float64)
    out = [None] * len(reqs)
    for ml in (False, True):
        idx = [i for i, r in enumerate(reqs) if r.is_multilevel == ml]
        if not idx:
            continue
        if ml:
            ps = [reqs[i].multilevel_params() for i in idx]
            p = {k: f64([getattr(ck, k) for ck, _ in ps])
                 for k in ("C1", "R1", "D1", "C2", "R2", "D2", "mu", "q",
                           "omega")}
            p["omega1"] = f64([ck.w1 for ck, _ in ps])
            p["omega2"] = f64([ck.w2 for ck, _ in ps])
            p.update({k: f64([getattr(pw, k) for _, pw in ps])
                      for k in ("P_static", "P_cal", "P_io1", "P_io2",
                                "P_down")})
            tt, mm = f64([T[i] for i in idx]), f64([float(m[i]) for i in idx])
            tb = f64([reqs[i].T_base for i in idx])
            vt = sweep.ml_time_final_batched(tt, mm, p, tb)
            ve = sweep.ml_energy_final_batched(tt, mm, p, tb)
        else:
            ps = [reqs[i].single_params() for i in idx]
            p = {k: f64([getattr(ck, k) for ck, _ in ps])
                 for k in ("C", "R", "D", "mu", "omega")}
            p.update({k: f64([getattr(pw, k) for _, pw in ps])
                      for k in ("P_static", "P_cal", "P_io", "P_down")})
            tt = f64([T[i] for i in idx])
            tb = f64([reqs[i].T_base for i in idx])
            vt = sweep.time_final_batched(tt, p, tb)
            ve = sweep.energy_final_batched(tt, p, tb)
        for j, i in enumerate(idx):
            out[i] = (float(vt[j]), float(ve[j]))
    return out


def _adv_window(reqs, dev, precision=None, profile: bool = False) -> dict:
    """One cold window of ``reqs`` through a service on ``dev`` under
    ``precision`` (None: the device's default): host seconds split by part
    (synchronised), wall; with ``profile`` a second cold window under
    ``torch.profiler`` for its CUDA kernels and their busy time."""
    import torch
    from repro_torch.serve import AdvisorService
    svc = AdvisorService(cache_name=None, precision=precision, device=dev)
    svc.timings = {}
    t0 = time.perf_counter()
    svc.advise_many(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = {"wall_s": time.perf_counter() - t0, "policy": svc.precision.name,
           "split_s": {k: svc.timings.get(k, 0.0) for k in ADV_SPLIT},
           "lanes": svc.metrics()["solved_lanes"]}
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        svc = AdvisorService(cache_name=None, precision=precision,
                             device=dev)
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.advise_many(reqs)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        kinds = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kinds["kernels"] = kinds.get("kernels", 0) + 1
                kinds["busy_us"] = (kinds.get("busy_us", 0.0)
                                    + e.time_range.elapsed_us())
            elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cudaLaunchKernelExC"):
                kinds["launch_calls"] = kinds.get("launch_calls", 0) + 1
        out["profiled"] = {"wall_s": wall,
                           "kernels": kinds.get("kernels", 0),
                           "launch_calls": kinds.get("launch_calls", 0),
                           "busy_s": kinds.get("busy_us", 0.0) * 1e-6}
        out["profiled"]["busy_share"] = out["profiled"]["busy_s"] / wall
    return out


def _adv_cert_placement(reqs, dev) -> dict:
    """The certificate of one window's solve timed on the solve's device
    and on f64 CPU tensors (the same fields and periods), and whether the
    two agree bit for bit."""
    import numpy as np
    import torch
    from repro_torch.serve import batcher
    from repro_torch.serve.fingerprint import (Quantization,
                                               certified_bound_multilevel,
                                               certified_bound_single,
                                               quantize_request,
                                               quantized_key)
    from repro_torch.sim import evaluate_grid, evaluate_multilevel_grid
    q = Quantization()
    plan = batcher.plan_batch([(quantized_key(qr), qr) for qr in (
        quantize_request(r, q) for r in reqs)])
    pg, mg, m_values, m_max = plan.grids(dev)
    rs = evaluate_grid(pg, device=dev)
    rm = evaluate_multilevel_grid(mg, m_values=m_values, m_max=m_max,
                                  device=dev)
    cases = {"single": (certified_bound_single, pg.fields(),
                        (rs.T_time, rs.T_energy)),
             "ml": (certified_bound_multilevel, mg.fields(),
                    (rm.T_time, rm.m_time, rm.T_energy, rm.m_energy))}
    out = {}
    for name, (fn, fields, args) in cases.items():
        host_f = {k: v.cpu() for k, v in fields.items()}
        host_a = [a.cpu() for a in args]
        fn(fields, *args, q)                         # warm both
        fn(host_f, *host_a, q)
        on_dev, dev_s = _sync_time(lambda: fn(fields, *args, q))
        on_host, host_s = _sync_time(lambda: fn(host_f, *host_a, q))
        out[name] = {"lanes": len(on_dev), "device_s": dev_s,
                     "host_s": host_s,
                     "bitwise": bool(np.array_equal(on_dev, on_host)),
                     "max_rel": _max_rel(np.where(np.isfinite(on_dev),
                                                  on_dev, 0.0),
                                         np.where(np.isfinite(on_host),
                                                  on_host, 0.0))}
    torch.cuda.synchronize(dev)
    return out


def phase_advisor(dev, card: str) -> dict:
    """Phase 11: the checkpoint-advisor service on the card (see the
    module docstring), every line with the card's name and power limit;
    the six kernel wrappers' launches and the plain versions' calls over
    the whole phase must stay zero."""
    import contextlib
    import io
    import numpy as np
    import torch
    from repro_torch.benchmarks import bench_advisor
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import AdvisorService, Quantization
    from repro_torch.sim import backend_info, cache_stats
    alog = lambda msg: log(f"{msg} [{card}]")
    cpu = torch.device("cpu")
    report = {}
    t_phase = time.perf_counter()
    _reset_counts()

    # 1. the smoke leg through the launcher
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rep = launch_serve.main(["advisor", "--smoke", "--device",
                                 dev.type])
    for line in buf.getvalue().splitlines():
        alog(f"advisor smoke: {line}")
    if not (rep.rps > 0.0 and rep.hit_rate > 0.0):
        fail(f"advisor smoke: rps {rep.rps}, hit rate {rep.hit_rate}")
    report["smoke"] = dict(rep.summary(), secs=time.perf_counter() - t0)

    # 2. the burst (the reference's bench_advisor definition)
    t0 = time.perf_counter()
    burst = bench_advisor.time_advisor_rps(
        np.random.default_rng(ADV_BURST_SEED), repeat=2, device=dev)
    burst["secs"] = time.perf_counter() - t0
    alog("advisor burst: " + ", ".join(
        f"{k} {burst[k]:.6g}" for k in (
            "naive_s", "batched_cold_s", "batched_warm_s", "rps",
            "open_loop_rps", "p50_ms", "p99_ms", "speedup_warm", "secs")))
    if not burst["speedup_warm"] >= ADV_SPEEDUP_FLOOR:
        fail(f"advisor burst: speedup_warm {burst['speedup_warm']:.2f} "
             f"under the floor {ADV_SPEEDUP_FLOOR}")
    report["burst"] = burst

    # 3. the open-loop regimes
    t0 = time.perf_counter()
    regimes = bench_advisor.time_advisor_regimes(
        np.random.default_rng(11), np.random.default_rng(12), device=dev)
    regimes["secs"] = time.perf_counter() - t0
    for key, r in regimes.items():
        if isinstance(r, dict):
            alog(f"advisor regime {key}: rps {r['rps']:.6g}, p50 "
                 f"{r['p50_ms']:.6g} ms, p99 {r['p99_ms']:.6g} ms, hit rate "
                 f"{r['hit_rate']:.4f}, mean window {r['mean_window']:.4g}")
    report["regimes"] = regimes

    # 4. card against the port's CPU run, both f64
    burst_reqs = _adv_requests(512, ADV_BURST_SEED, two_tier_frac=0.0)
    mixed = _adv_requests(*ADV_MIXED)
    cross = {}
    for what, reqs in (("burst-512", burst_reqs), ("mixed-512", mixed)):
        on_card, on_cpu = (AdvisorService(cache_name=None, precision="f64",
                                          device=d).advise_many(reqs)
                           for d in (dev, cpu))
        cross[what] = _adv_compare(on_card, on_cpu, what, alog)
    report["card_vs_cpu"] = cross

    # 5. the default policy (compensated f32 on CUDA) against exact f64
    svc = AdvisorService(cache_name=None, device=dev)
    tol = svc.precision.objective_tol
    served = svc.advise_many(mixed)
    truth = AdvisorService(quantization=Quantization(rel=0.0, absolute=0.0),
                           precision="f64", cache_name=None,
                           device=dev).advise_many(mixed)
    ok = [i for i, (a, t) in enumerate(zip(served, truth))
          if a.valid and t.valid]
    sub = [mixed[i] for i in ok]
    sv_t = _adv_objectives(sub, [served[i].T_time for i in ok],
                           [served[i].m_time for i in ok])
    sv_e = _adv_objectives(sub, [served[i].T_energy for i in ok],
                           [served[i].m_energy for i in ok])
    op_t = _adv_objectives(sub, [truth[i].T_time for i in ok],
                           [truth[i].m_time for i in ok])
    op_e = _adv_objectives(sub, [truth[i].T_energy for i in ok],
                           [truth[i].m_energy for i in ok])
    worst = 0.0
    for j, i in enumerate(ok):
        slack = served[i].cert_bound + tol
        for sv, op in ((sv_t[j][0], op_t[j][0]), (sv_e[j][1], op_e[j][1])):
            excess = sv / op - 1.0
            worst = max(worst, excess / slack)
            if not sv <= op * (1.0 + slack):
                fail(f"advisor default policy: request {i} serves {sv!r} "
                     f"against the exact {op!r}, beyond cert_bound + "
                     f"objective_tol {slack:.3e}")
    alog(f"advisor default policy ({svc.precision.name}): {len(ok)} of "
         f"{len(mixed)} requests valid; served objectives within cert_bound "
         f"+ objective_tol of an exact f64 solve on the card, the largest "
         f"excess {worst:.4f} of its slack")
    report["default_policy"] = {"policy": svc.precision.name,
                                "checked": len(ok), "excess_of_slack": worst}

    # 6. where a window's time goes: the mixed 512 and a 16,384 burst
    big = _adv_requests(*ADV_BIG)
    split = {}
    for (what, reqs), pol in itertools.product(
            (("mixed-512", mixed), ("mixed-16k", big)),
            (None, "f64")):
        w = _adv_window(reqs, dev, pol, profile=True)
        what = f"{what}-{w['policy']}"
        w["certificate_share"] = w["split_s"]["certificate"] / w["wall_s"]
        alog(f"advisor window {what} ({w['lanes']} lanes): "
             f"wall {w['wall_s']:.6f} s, certificate share "
             f"{w['certificate_share']:.4f}; " + ", ".join(
                 f"{k} {v:.6f}" for k, v in w["split_s"].items())
             + f"; profiled: {w['profiled']['kernels']} CUDA kernels, "
             f"{w['profiled']['launch_calls']} launch calls, busy "
             f"{w['profiled']['busy_s']:.6f} s of {w['profiled']['wall_s']:.6f}"
             f" s ({w['profiled']['busy_share']:.4f})")
        split[what] = w
    w = _adv_window(big, cpu)
    alog(f"advisor window mixed-16k on the port's CPU ({w['policy']}): wall "
         f"{w['wall_s']:.6f} s; " + ", ".join(
             f"{k} {v:.6f}" for k, v in w["split_s"].items()))
    split["mixed-16k-cpu"] = w
    cert = _adv_cert_placement(big, dev)
    for k, c in cert.items():
        alog(f"advisor certificate {k} ({c['lanes']} lanes): on the card "
             f"{c['device_s']:.6f} s, on the host {c['host_s']:.6f} s, "
             f"bitwise {c['bitwise']}, max rel {c['max_rel']:.3e}")
    split["certificate_placement"] = cert
    report["split"] = split
    del big

    # 7. the registry after a repeat workload
    svc = AdvisorService(device=dev)
    svc.advise_many(mixed)
    svc.advise_many(mixed)
    fp = cache_stats()["serve.fingerprints"]
    if not (fp["lookups"] == fp["hits"] + fp["misses"] and fp["hits"] > 0):
        fail(f"advisor registry: serve.fingerprints {fp}")
    info = backend_info("cuda")
    alog(f"advisor registry: serve.fingerprints {fp}; backend_info {info}")
    report["registry"] = {"serve.fingerprints": fp,
                          "backend_info": repr(info)}

    torch.cuda.synchronize()
    c = _counts()
    if any(c.values()):
        fail(f"the advisor path launched a kernel or called a plain "
             f"version: {c}")
    report["launches"] = c
    report["phase_s"] = time.perf_counter() - t_phase
    alog(f"advisor path: kernel launches and plain-version calls all zero "
         f"({c}); advisor phase {report['phase_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# 12. train: xLSTM-125M at full width
# ---------------------------------------------------------------------------

#: the train-xlstm-125m cell: src/repro/configs/xlstm_125m.py at full width
#: cut to ``layers`` of 12 (one super-block: an mLSTM and an sLSTM layer;
#: the depth cut that makes room for phase 16), SyntheticLM seed 0, B = microbatch_rows_per_device (8), S = 1024 for the
#: steps and 4096 (train_4k's length) for the no-grad loss; the card
#: against the CPU at B 2, S 512; the steps with gradient compression at
#: S 256 (one chunk: the sLSTM's host-bound loop sets a step's time, and
#: the compression's gates read the step's own gradients at S 1024).
TRAIN = dict(arch="xlstm-125m", seed=0, layers=2, S=1024, S_loss=4096,
             steps=3, cpu_B=2, cpu_S=512, compress_S=256)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
#: xLSTM-125M's parameter tree cut to ``TRAIN["layers"]`` (one mLSTM, one
#: sLSTM layer; whole: 173,090,352 in the same 22 leaves,
#: tests/test_torch_configs.py holds the tree against the reference's).
TRAIN_PARAMS, TRAIN_LEAVES = 93_402_632, 22
#: MLSTMScan's gradients against autograd through the ``_mlstm_chunk``
#: scan on the card, relative Frobenius error per input.  The backward
#: replays each chunk in f32 from the forward's starting states, which the
#: kernel's state pass sums in 3xTF32: each product keeps hi.hi + hi.lo +
#: lo.hi, dropping lo.lo and the lo split's rounding, ~2^-21 relative, and
#: the states sum up to 1024 keys of them, ~1e-6..1e-5 relative; the
#: gradients are linear in those states.  1e-4 leaves a tenfold margin over
#: that and sits far below a wrong state (an error of order 1).
TRAIN_BWD_TOL = 1e-4
#: the card's loss against the port's CPU loss from the same params: the
#: reference's bf16 tolerance (tests/test_models.py).
TRAIN_CPU_TOL = 3e-2
#: device kernels of the mLSTM's passes, by name (csrc/mlstm_scan.cu).
MLSTM_KERNELS = ("gates_kernel", "state_kernel", "scores_kernel",
                 "output_kernel")


def _dev_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_s(fn, dev, reps: int = 1) -> float:
    """Host-clock seconds of one call of ``fn`` (synchronised), the least
    of ``reps`` after one warm call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        _dev_sync(dev)
        t0 = time.perf_counter()
        fn()
        _dev_sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _value_and_grad(m, params, batch):
    """(loss, the gradient tree) of ``m.loss`` at ``params``: what
    ``make_train_step`` takes before AdamW."""
    import torch
    from repro_torch.ckpt.tree import tree_flatten, tree_unflatten
    leaves, td = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss = m.loss(tree_unflatten(td, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(td, list(grads))


def _frob(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def run_train_path(dev, cfg, B: int, S: int) -> dict:
    """The train path: ``Model.init`` on a seeded ``torch.Generator``,
    then ``TRAIN["steps"]`` ``make_train_step`` steps on one
    ``SyntheticLM`` batch, each on the host clock (synchronised)."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.models import build
    from repro_torch.optim import adamw
    m = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(TRAIN["seed"])
    t0 = time.perf_counter()
    params = m.init(gen, device=dev)
    _dev_sync(dev)
    init_s = time.perf_counter() - t0
    batch = synthetic.for_arch(cfg, batch=B, seq_len=S, seed=TRAIN["seed"],
                               device=dev).peek(0)
    step = m.make_train_step(adamw.AdamWConfig(**TRAIN_OPT))
    opt = adamw.init_state(params, device=dev)
    p = params
    out = {"model": m, "params0": params, "batch": batch, "step": step,
           "init_s": init_s, "losses": [], "grad_norms": [], "step_s": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(TRAIN["steps"]):
        t0 = time.perf_counter()
        p, opt, met = step(p, opt, batch)
        loss = float(met["loss"])
        _dev_sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        out["grad_norms"].append(float(met["grad_norm"]))
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["params"], out["opt"] = p, opt
    return out


def _profile_train_step(run: dict, dev) -> dict:
    """One more step (its result dropped) under ``torch.profiler``: the
    CUDA kernels it launches, their busy time, and the mLSTM kernels'
    share of it.  The trace's raw events are read directly: building the
    profiler's Python event list takes ~60 us an event, minutes for a
    step's ~600,000 kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run["step"](run["params"], run["opt"], run["batch"])
        _dev_sync(dev)
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    n = busy = ml_n = ml_ns = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        ns = e.duration_ns()
        n, busy = n + 1, busy + ns
        if any(k in e.name() for k in MLSTM_KERNELS):
            ml_n, ml_ns = ml_n + 1, ml_ns + ns
    return {"profiled_wall_s": wall, "kernels": n, "busy_s": busy * 1e-9,
            "mlstm_kernels": ml_n, "mlstm_kernel_s": ml_ns * 1e-9}


def _step_without_remat(run: dict, cfg, dev) -> float:
    """Host-clock seconds of the same step with ``remat="none"`` (its
    result dropped): the checkpoint's cost is the difference."""
    import dataclasses
    from repro_torch.models import build
    from repro_torch.optim import adamw
    m = build(dataclasses.replace(cfg, remat="none"))
    step = m.make_train_step(adamw.AdamWConfig(**TRAIN_OPT))
    _dev_sync(dev)
    t0 = time.perf_counter()
    step(run["params"], run["opt"], run["batch"])
    _dev_sync(dev)
    return time.perf_counter() - t0


def _train_split(run: dict, cfg, dev) -> dict:
    """Each recurrent layer's share of a step, timed alone at the step's
    shapes on the host clock (synchronised): the mLSTM forward (the
    kernel), its backward (the chunk replay), and the sLSTM layer's
    forward and forward + backward; per step, with ``remat="full"``
    (each layer's forward runs again before its backward), 2 forwards and
    a backward of each mLSTM and sLSTM layer."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import recurrent as rec
    from repro_torch.models.spec import torch_dtype
    cd = torch_dtype(cfg.compute_dtype)
    B, S = run["batch"]["tokens"].shape
    gen = torch.Generator(device=dev).manual_seed(TRAIN["seed"] + 1)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(cd)
    p_m = {k: v[0] for k, v in run["params"]["stages"][0]["mlstm"].items()}
    p_s = {k: v[0].detach().requires_grad_()
           for k, v in run["params"]["stages"][1]["slstm"].items()}
    with torch.no_grad():
        q, k, v, li, lf, L = rec.mlstm_inputs(cfg, p_m, x, cd)
    ins = [t.detach().requires_grad_() for t in (q, k, v, li, lf)]
    dh = torch.randn(q.shape, generator=gen, device=dev)

    def m_fwd():
        return ops.mlstm_scan_trainable(*ins, chunk=L)[0]

    def m_both():
        torch.autograd.grad(m_fwd(), ins, dh)

    xs = x.detach().requires_grad_()

    def s_fwd():
        return rec.slstm_block(cfg, p_s, xs, cd)[0]

    def s_both():
        y = s_fwd()
        torch.autograd.grad(y, [xs, *p_s.values()], torch.ones_like(y))

    f_m, fb_m = _wall_s(m_fwd, dev, 3), _wall_s(m_both, dev, 3)
    f_s, fb_s = _wall_s(s_fwd, dev), _wall_s(s_both, dev)
    kinds = cfg.layer_kinds()
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    out = {"mlstm_fwd_s": f_m, "mlstm_bwd_s": fb_m - f_m,
           "slstm_fwd_s": f_s, "slstm_bwd_s": fb_s - f_s,
           "step_mlstm_fwd_s": 2 * n_m * f_m,
           "step_mlstm_bwd_s": n_m * (fb_m - f_m),
           "step_slstm_s": n_s * (f_s + fb_s)}
    step = statistics.median(run["step_s"][1:] or run["step_s"])
    out["step_rest_s"] = step - (out["step_mlstm_fwd_s"]
                                 + out["step_mlstm_bwd_s"]
                                 + out["step_slstm_s"])
    out["step_s"] = step
    return out


def _train_kernel_checks(run: dict, cfg, dev) -> dict:
    """Layer 0's mLSTM at the step's shapes, on its real input (the
    trained params' embedding of the batch through ln1): h through the
    kernel against ``mlstm_scan_plain`` at ``ZOO_TOL``, the block's output
    both ways, and ``MLSTMScan``'s gradients against autograd through the
    ``_mlstm_chunk`` scan at ``TRAIN_BWD_TOL``."""
    import torch
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import recurrent as rec
    from repro_torch.models.spec import torch_dtype
    cd = torch_dtype(cfg.compute_dtype)
    params = run["params"]
    p0 = {k: v[0] for k, v in params["stages"][0]["ln1"].items()}
    pm = {k: v[0] for k, v in params["stages"][0]["mlstm"].items()}
    out = {}
    with torch.no_grad():
        x = layers.embed_lookup(params["embed"], run["batch"]["tokens"], cd)
        h_in = layers.apply_norm(p0, x, cfg.norm)
        q, k, v, li, lf, L = rec.mlstm_inputs(cfg, pm, h_in, cd)
        Bq, H, S, Dh = q.shape
        fold = lambda t: t.reshape(Bq * H, *t.shape[2:])
        h_k = ops.mlstm_scan_trainable(q, k, v, li, lf, chunk=L)[0]
        h_p = ml.mlstm_scan_plain(fold(q), fold(k), fold(v), fold(li),
                                  fold(lf), chunk=L).reshape(h_k.shape)
        ok, err, frob = _close(h_k, h_p, ZOO_TOL["mlstm_scan"])
        out["h"] = {"ok": ok, "max_abs_err": err, "frob": frob}
        y_k = rec.mlstm_block(cfg, pm, h_in, cd)[0]
        real = ops.mlstm_scan_trainable

        def plain(q_, k_, v_, li_, lf_, chunk):
            h, st = ml.mlstm_scan_plain(fold(q_), fold(k_), fold(v_),
                                        fold(li_), fold(lf_), chunk=chunk,
                                        states=True)
            last = tuple(t[:, -1].reshape(Bq, H, *t.shape[2:]) for t in st)
            return h.reshape(q_.shape), last
        ops.mlstm_scan_trainable = plain
        try:
            y_p = rec.mlstm_block(cfg, pm, h_in, cd)[0]
        finally:
            ops.mlstm_scan_trainable = real
        out["block_y_frob"] = _frob(y_k.float(), y_p.float())
    gen = torch.Generator(device=dev).manual_seed(TRAIN["seed"] + 2)
    ins = [t.detach().requires_grad_() for t in (q, k, v, li, lf)]
    dh = torch.randn(q.shape, generator=gen, device=dev)
    got = torch.autograd.grad(ops.mlstm_scan_trainable(*ins, chunk=L)[0],
                              ins, dh)
    zero = rec.mlstm_zero_state(cfg, Bq, dev)
    want = torch.autograd.grad(rec._mlstm_chunks(*ins, zero, L)[0], ins, dh)
    out["bwd_frob"] = {n: _frob(g, w) for n, g, w in
                       zip(("q", "k", "v", "li", "lf"), got, want)}
    return out


def _train_compress(run: dict, dev) -> dict:
    """Gradient compression on the step's gradients: one ``compress_grads``
    call (its launches read around it), each leaf bitwise the one-leaf
    ``quantize_array``/``dequantize_array`` round trip, its ``stats``;
    then ``TRAIN["steps"]`` steps with the compression between the
    gradients and ``apply_updates``, from the initial params, on a batch
    of ``TRAIN["compress_S"]`` tokens a row."""
    import torch
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw, grad_compress
    m, batch = run["model"], run["batch"]
    _, grads = _value_and_grad(m, run["params0"], batch)
    cst = grad_compress.init_state(grads, device=dev)
    _dev_sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    back, cst, stats = grad_compress.compress_grads(grads, cst)
    _dev_sync(dev)
    out = {"compress_s": time.perf_counter() - t0, "counts": _counts(),
           "stats": stats}
    n_big = bits = 0
    for g, b in zip(tree_leaves(grads), tree_leaves(back)):
        if g.numel() < grad_compress.MIN_COMPRESSED:
            bits += int(torch.equal(g.float(), b))
            continue
        n_big += 1
        q, s, pad = ops.quantize_array(g.float())
        ref = ops.dequantize_array(q, s, shape=g.shape, dtype="float32",
                                   pad=pad)
        bits += int(torch.equal(ref.view(torch.int32), b.view(torch.int32)))
    out["leaves"], out["compressed_leaves"] = len(tree_leaves(grads)), n_big
    out["bitwise_leaves"] = bits
    cfg_opt = adamw.AdamWConfig(**TRAIN_OPT)
    p, opt = run["params0"], adamw.init_state(run["params0"], device=dev)
    cst = grad_compress.init_state(grads, device=dev)
    del grads, back
    B, S = batch["tokens"].shape
    batch = synthetic.for_arch(m.cfg, batch=B, seq_len=min(
        S, TRAIN["compress_S"]), seed=TRAIN["seed"], device=dev).peek(0)
    losses, ratios = [], []
    _reset_counts()
    for _ in range(TRAIN["steps"]):
        loss, g = _value_and_grad(m, p, batch)
        g, cst, st = grad_compress.compress_grads(g, cst)
        p, opt, _ = adamw.apply_updates(cfg_opt, p, g, opt)
        losses.append(float(loss))
        ratios.append(st["ratio"])
    _dev_sync(dev)
    out["steps_counts"] = _counts()
    out["losses"], out["ratios"] = losses, ratios
    return out


def phase_train(dev, card: str, peaks=None, cfg=None, B=None, S=None,
                S_loss=None) -> dict:
    """Phase 12: xLSTM-125M trains on the card (see the module docstring),
    every line with the card's name and power limit; ``peaks`` (phase 1's)
    give the mLSTM launch's bound at the step's shape.  ``cfg`` and the
    sizes default to the train-xlstm-125m cell; smaller ones rehearse the
    phase on the CPU (``dev`` cpu), where no kernel launches."""
    import torch
    from repro_torch.benchmarks import table_arch_periods
    from repro_torch.ckpt.tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models.spec import tree_size
    tlog = lambda msg: log(f"{msg} [{card}]")
    full = cfg is None
    cfg = cfg or dataclasses.replace(get_config(TRAIN["arch"]),
                                     n_layers=TRAIN["layers"])
    B = B or cfg.microbatch_rows_per_device
    S, S_loss = S or TRAIN["S"], S_loss or TRAIN["S_loss"]
    on_card = dev.type == "cuda"
    n_mlstm = cfg.layer_kinds().count("mlstm")
    report = {"arch": cfg.name, "B": B, "S": S, "S_loss": S_loss}
    t_phase = time.perf_counter()

    # 1. the main path: init, then the steps, the counts read around it
    _reset_counts()
    run = run_train_path(dev, cfg, B, S)
    _dev_sync(dev)
    c = _counts()
    leaves = tree_leaves(run["params0"])
    n_params = sum(x.numel() for x in leaves)
    tlog(f"train: {cfg.name} params {n_params} in {len(leaves)} leaves "
         f"(init {run['init_s']:.3f} s); B {B}, S {S}: losses "
         f"{run['losses']}, grad_norms {run['grad_norms']}, step s "
         f"{run['step_s']}, peak {run.get('peak_gb', 0.0):.2f} GB; "
         f"launches mlstm_scan {c['mlstm_scan']}, plain calls {c['plain']}")
    if n_params != tree_size(run["model"].param_spec()) or (
            full and (n_params, len(leaves)) != (TRAIN_PARAMS,
                                                 TRAIN_LEAVES)):
        fail(f"train: the tree holds {n_params} params in {len(leaves)} "
             f"leaves")
    losses = run["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and all(math.isfinite(x) for x in run["grad_norms"])):
        fail(f"train: the loss did not fall or is not finite: {losses}")
    want = 2 * n_mlstm * TRAIN["steps"] if on_card else 0
    if c["mlstm_scan"] != want or (on_card and c["plain"]):
        fail(f"train: mlstm_scan launched {c['mlstm_scan']} times (want "
             f"{want}: a forward and the remat recompute of {n_mlstm} "
             f"layers a step) with {c['plain']} plain-version calls")
    report.update({k: run[k] for k in ("losses", "grad_norms", "step_s",
                                       "init_s")})
    report["peak_gb"] = run.get("peak_gb")
    report["launches"] = c

    # 2. the step's kernels and busy share; the split of a step
    t_part = time.perf_counter()
    if on_card:
        prof = _profile_train_step(run, dev)
        prof["busy_share"] = prof["busy_s"] / statistics.median(
            run["step_s"][1:])
        if peaks is not None and prof["mlstm_kernels"]:
            # one forward launch (4 kernels) at the step's shape, beside
            # its bound: 3xTF32 on the tensor cores, as phase 8's
            BH, Dh = B * cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
            L = min(cfg.mlstm_chunk, S)
            per = 4 * prof["mlstm_kernel_s"] / prof["mlstm_kernels"] * 1e3
            from repro_torch.kernels import cost
            b = cost.bound_ms(cost.mlstm_work(BH, S, Dh, L), peaks)
            prof.update(mlstm_launch_ms=per, mlstm_bound_ms=b["bound_ms"],
                        mlstm_bound_by=b["bound_by"])
        report["profile"] = prof
        tlog("train step profile: " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in prof.items()))
    split = _train_split(run, cfg, dev)
    split["step_no_remat_s"] = _step_without_remat(run, cfg, dev)
    split["part_s"] = time.perf_counter() - t_part
    report["split"] = split
    tlog("train step split (each layer timed alone): " + ", ".join(
        f"{k} {v:.6g}" for k, v in split.items()))

    # 3. the loss at train_4k's length, no grad
    data = synthetic.for_arch(cfg, batch=B, seq_len=S_loss,
                              seed=TRAIN["seed"], device=dev)
    b4 = data.peek(0)
    _reset_counts()
    with torch.no_grad():
        _dev_sync(dev)
        t0 = time.perf_counter()
        loss4 = float(run["model"].loss(run["params"], b4))
        _dev_sync(dev)
        loss4_s = time.perf_counter() - t0
    c4 = _counts()
    del b4
    tlog(f"train: loss at B {B}, S {S_loss} (no grad) {loss4:.6f} in "
         f"{loss4_s:.3f} s; launches mlstm_scan {c4['mlstm_scan']}, plain "
         f"calls {c4['plain']}")
    if not math.isfinite(loss4) or c4["mlstm_scan"] != (
            n_mlstm if on_card else 0) or (on_card and c4["plain"]):
        fail(f"train: the S {S_loss} loss ({loss4}) or its launches "
             f"({c4}) are wrong")
    report["loss_long"] = {"loss": loss4, "s": loss4_s, "launches": c4}

    # 4. the kernel against its plain version; the backward against
    #    autograd
    t_part = time.perf_counter()
    chk = _train_kernel_checks(run, cfg, dev)
    chk["part_s"] = time.perf_counter() - t_part
    report["kernel_checks"] = chk
    tlog(f"train: layer 0 mLSTM h, kernel vs plain: max abs "
         f"{chk['h']['max_abs_err']:.3e}, frob {chk['h']['frob']:.3e} "
         f"(gate {ZOO_TOL['mlstm_scan']}); the block's y frob "
         f"{chk['block_y_frob']:.3e}; MLSTMScan gradients vs autograd "
         f"through the chunk scan (frob): " + ", ".join(
             f"{k} {v:.3e}" for k, v in chk["bwd_frob"].items())
         + f" (gate {TRAIN_BWD_TOL:g}); {chk['part_s']:.1f} s")
    if not chk["h"]["ok"]:
        fail("train: layer 0's mLSTM h through the kernel disagrees with "
             "the plain version")
    if max(chk["bwd_frob"].values()) > TRAIN_BWD_TOL:
        fail("train: MLSTMScan's gradients disagree with autograd through "
             "the chunk scan")

    # 5. the card's loss against the port's CPU loss, same params
    cpu = torch.device("cpu")
    small = lambda d: synthetic.for_arch(
        cfg, batch=TRAIN["cpu_B"], seq_len=TRAIN["cpu_S"],
        seed=TRAIN["seed"], device=d).peek(0)
    with torch.no_grad():
        l_card = float(run["model"].loss(run["params0"], small(dev)))
        p_cpu = tree_map(lambda x: x.to(cpu), run["params0"])
        t0 = time.perf_counter()
        l_cpu = float(run["model"].loss(p_cpu, small(cpu)))
        cpu_s = time.perf_counter() - t0
    del p_cpu
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    report["card_vs_cpu"] = {"card": l_card, "cpu": l_cpu, "rel": rel,
                             "cpu_s": cpu_s}
    tlog(f"train: loss at B {TRAIN['cpu_B']}, S {TRAIN['cpu_S']}: card "
         f"{l_card:.6f}, CPU {l_cpu:.6f} ({cpu_s:.2f} s), rel {rel:.3e} "
         f"(gate {TRAIN_CPU_TOL:g})")
    if not rel <= TRAIN_CPU_TOL:
        fail("train: the card's loss differs from the CPU's")

    # 6. gradient compression on the step's gradients, then steps with it
    t_part = time.perf_counter()
    comp = _train_compress(run, dev)
    comp["part_s"] = time.perf_counter() - t_part
    report["compress"] = comp
    qc, sc = comp["counts"], comp["steps_counts"]
    tlog(f"train: compress_grads {comp['compress_s']:.4f} s, stats "
         f"{comp['stats']}, launches quantize_leaves "
         f"{qc['quantize_leaves']}, dequantize_leaves "
         f"{qc['dequantize_leaves']}, one-leaf {qc['quantize']} / "
         f"{qc['dequantize']}, plain {qc['plain']}; {comp['bitwise_leaves']}"
         f" of {comp['leaves']} leaves bitwise the one-leaf round trip "
         f"({comp['compressed_leaves']} compressed); compressed steps at S "
         f"{min(S, TRAIN['compress_S'])}: "
         f"losses {comp['losses']}, ratios {comp['ratios']}, launches "
         f"{sc['quantize_leaves']} / {sc['dequantize_leaves']}; "
         f"{comp['part_s']:.1f} s")
    keys = ("quantize_leaves", "dequantize_leaves", "quantize",
            "dequantize", "plain")
    if on_card and tuple(qc[k] for k in keys) != (1, 1, 0, 0, 0):
        fail(f"train: compress_grads did not make one quantize and one "
             f"dequantize launch over its leaves: {qc}")
    if comp["bitwise_leaves"] != comp["leaves"]:
        fail("train: compressed gradients differ from the one-leaf round "
             "trip")
    if not comp["stats"]["ratio"] < 0.3:
        fail(f"train: wire ratio {comp['stats']['ratio']}")
    cl = comp["losses"]
    if not (all(math.isfinite(x) for x in cl) and cl[-1] < cl[0]):
        fail(f"train: the loss did not fall with compression: {cl}")
    if on_card and (sc["quantize_leaves"], sc["dequantize_leaves"]) != (
            TRAIN["steps"], TRAIN["steps"]):
        fail(f"train: the compressed steps' launches {sc}")

    # 7. the architecture table (the arch scenarios' one sweep)
    t0 = time.perf_counter()
    _, big, rows = table_arch_periods.run(dev)
    tap_s = time.perf_counter() - t0
    _, _, rows_cpu = table_arch_periods.run(cpu)
    worst = max(abs(a - b) / max(abs(b), 1e-300) for r, rc in
                zip(rows, rows_cpu) for a, b in zip(r[1:], rc[1:]))
    report["table_arch_periods"] = {"s": tap_s, "max_rel_vs_cpu": worst,
                                    "largest_C": big[:4]}
    tlog(f"train: table_arch_periods on {dev.type} {tap_s:.4f} s, within "
         f"{worst:.3e} of the CPU; largest C {big[0]} {big[3]:.3f} s")
    if worst > 1e-12:
        fail("train: table_arch_periods on the card differs from the CPU")

    report["phase_s"] = time.perf_counter() - t_phase
    tlog(f"train phase {report['phase_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# 13. ft: the fault-tolerant training runtime on xLSTM-125M
# ---------------------------------------------------------------------------

#: part (a), the ft-xlstm-125m cell: a ``RunSpec`` of xLSTM-125M at full
#: width (B 8; S 256, one mLSTM chunk, as phase 12's compressed steps: the
#: sLSTM's host-bound loop sets a step's time) in measured time (the step,
#: C and R on the host clock feed the policy), the joint energy solver
#: with a buddy level, q = 1 (every failure drops the buddy and restores
#: deep), the compressed store.  mu 25 s at seed 18: numpy's exponential
#: stream draws 15.94, 13.74 and 14.61 s, so the first failure lands near
#: step 4 on the run's clock (3.5-6 s a step), after the first deep
#: checkpoint.  6 steps, cut from 10 to make room for phase 19: at 10 the
#: failures every ~14 s made the run replay to 16-17 steps (112.6 s on
#: the host clock; a cut to 6 of the 12 layers shortened a step by a
#: quarter but not the run).  The priors C, R, D (s) stand until the first measurements
#: replace them.
FT_RUN = dict(arch="xlstm-125m", reduce=False, batch=8, seq=256,
              step_s=None, strategy="algo_e_ml", use_buddy=True, q=1.0,
              compress=True, profile="paper_ml", mu_s=25.0, seed=18,
              total_steps=6, C_s=3.0, R_s=2.5, D_s=1.0, C1_s=1.0,
              R1_s=1.0)
#: part (a) rehearsed on the CPU: the same spec at the smoke's widths,
#: whose steps take ~20 ms there, so more of them at a shorter mu.
FT_RUN_SMALL = dict(reduce=True, layers=2, d_model=64, n_heads=1, batch=2,
                    seq=16, total_steps=60, mu_s=3.0, C_s=0.6, R_s=0.5,
                    D_s=0.2, C1_s=0.2, R1_s=0.2)
#: part (c): xLSTM-125M's widths cut to 2 layers (one mLSTM, one sLSTM),
#: B 8, S 256, 10 steps in scaled time (1 s a step; C1 = C2 = R1 = R2 =
#: 0.5 s, D 0.1 s, omega 0.5, so each write stays in flight for half its
#: cost), the deep level every 2nd checkpoint, q = 0.5, mu 6 s.  In scaled
#: time the schedule does not depend on the model: at seed 0 a CPU
#: rehearsal at reduced width gives 5 failures (2 hard), one flush
#: aborted and restores from both levels, in 16 steps run.
FT_IDENTITY = dict(layers=2, B=8, S=256, steps=10, mu_s=6.0, seed=0,
                   q=0.5, pfs_every=2, cost_s=0.5, D_s=0.1, omega=0.5)
#: the card's smoke against the port's CPU run of it from the same
#: params: losses as |a - b| / |b| (the reference's bf16 tolerance); the
#: operating point's floats (each device solves in f64) relative.
FT_LOSS_TOL = 3e-2
FT_OP_RTOL = 1e-12


def _ft_cfg(spec):
    """The ``ArchConfig`` that ``ft.run.build`` builds for ``spec``."""
    from repro_torch.configs import get_config, reduced
    cfg = get_config(spec.arch)
    return reduced(cfg, n_layers=spec.layers, d_model=spec.d_model,
                   n_heads=spec.n_heads) if spec.reduce else cfg


def _mlstm_per_step(cfg) -> int:
    """mLSTM launches a training step: a forward per mLSTM layer, and its
    recompute under ``remat="full"``."""
    return cfg.layer_kinds().count("mlstm") * (2 if cfg.remat == "full"
                                               else 1)


def _ft_mlstm_check(params, cfg, batch) -> dict:
    """Layer 0's mLSTM on a run's own input (its params' embedding of
    ``batch`` through ln1): h through the kernel against
    ``mlstm_scan_plain`` within ``ZOO_TOL``, at the path's shape."""
    import torch
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import recurrent as rec
    from repro_torch.models.spec import torch_dtype
    cd = torch_dtype(cfg.compute_dtype)
    p0 = {k: v[0] for k, v in params["stages"][0]["ln1"].items()}
    pm = {k: v[0] for k, v in params["stages"][0]["mlstm"].items()}
    with torch.no_grad():
        x = layers.embed_lookup(params["embed"], batch["tokens"], cd)
        q, k, v, li, lf, L = rec.mlstm_inputs(
            cfg, pm, layers.apply_norm(p0, x, cfg.norm), cd)
        Bq, H, S, Dh = q.shape
        fold = lambda t: t.reshape(Bq * H, *t.shape[2:])
        h_k = ops.mlstm_scan_trainable(q, k, v, li, lf, chunk=L)[0]
        h_p = ml.mlstm_scan_plain(fold(q), fold(k), fold(v), fold(li),
                                  fold(lf), chunk=L).reshape(h_k.shape)
    ok, err, frob = _close(h_k, h_p, ZOO_TOL["mlstm_scan"])
    return {"shape": [Bq * H, S, Dh], "chunk": L, "ok": ok,
            "max_abs_err": err, "frob": frob}


def _count_steps(trainer) -> list:
    """Wrap ``trainer.train_step`` to count its calls (replays and the
    steps a failure interrupts included); returns the counter."""
    calls = [0]
    step = trainer.train_step

    def counted(*args):
        calls[0] += 1
        return step(*args)
    trainer.train_step = counted
    return calls


def run_ft_path(dev, root: Path, spec_kw: dict) -> dict:
    """Part (a)'s main path: ``ft.run.build`` and ``run`` of a
    ``RunSpec`` (``execute`` is the two and ``predictions``) with a
    ``MemoryTracker``, the train-step calls counted, on the host clock."""
    from repro_torch.ft import MemoryTracker
    from repro_torch.ft import run as ft_run
    spec = ft_run.RunSpec(ckpt_dir=str(root), **spec_kw)
    mem = MemoryTracker()
    t0 = time.perf_counter()
    trainer = ft_run.build(spec, tracker=mem, device=dev)
    _dev_sync(dev)
    build_s = time.perf_counter() - t0
    calls = _count_steps(trainer)
    t0 = time.perf_counter()
    rep = trainer.run()
    _dev_sync(dev)
    run_s = time.perf_counter() - t0
    rep["predicted"] = ft_run.predictions(spec, rep, device=dev)
    return {"spec": spec, "report": rep, "tracker": mem,
            "trainer": trainer, "steps_run": calls[0], "build_s": build_s,
            "run_s": run_s}


def _ft_part_run(dev, root: Path, tlog, rehearse: bool) -> dict:
    """Part (a): xLSTM-125M at full width through failures, measured."""
    on_card = dev.type == "cuda"
    spec_kw = dict(FT_RUN, **(FT_RUN_SMALL if rehearse else {}))
    _reset_counts()
    run = run_ft_path(dev, root, spec_kw)
    c = _counts()
    rep, mem, tr = run["report"], run["tracker"], run["trainer"]
    cfg = _ft_cfg(run["spec"])
    steps = [r["step_s"] for r in mem.of_kind("step")]
    deep = [s for s in rep["checkpoints"] if s["level"] == 2]
    buddy = [s for s in rep["checkpoints"] if s["level"] == 1]
    fails = mem.of_kind("failure")
    store_restores = sum(1 for e in tr.log if e["source"] == "store")
    op, e = rep["operating_point"], rep["energy"]
    out = {
        "spec": dict(spec_kw),
        "final_step": rep["final_step"], "steps_run": run["steps_run"],
        "n_failures": rep["n_failures"],
        "n_hard_failures": rep["n_hard_failures"],
        "n_rollbacks": rep["n_rollbacks"], "losses": rep["losses"],
        "step_s": steps,
        "C2_s": [s["C_s"] for s in deep],
        "C2_split": [{k: s[k] for k in ("snapshot_s", "write_s", "bytes")}
                     for s in deep],
        "C1_s": [s["C_s"] for s in buddy],
        "restore_s": [r["recovery_s"] for r in fails],
        "failure_t": list(tr.failures.failure_times),
        "downtime_s": [r["downtime_s"] for r in fails],
        "rollbacks": [(r["to_step"], r["source"]) for r in fails],
        "store_save_split": tr.manager.store.last_save,
        "store_restore_split": tr.manager.store.last_restore,
        "operating_point": op, "policy": rep["policy"],
        "energy": e, "wall_s": rep["wall_s"], "predicted": rep["predicted"],
        "build_s": run["build_s"], "run_s": run["run_s"], "launches": c}
    tlog(f"ft run: {cfg.name} B {spec_kw['batch']} S {spec_kw['seq']}, "
         f"{spec_kw['total_steps']} steps, measured time, "
         f"{spec_kw['strategy']}, q {spec_kw['q']}, compressed store, mu "
         f"{spec_kw['mu_s']} s, seed {spec_kw['seed']}: final step "
         f"{rep['final_step']}, {run['steps_run']} train steps run, "
         f"failures {rep['n_failures']} (hard {rep['n_hard_failures']}) at "
         f"t {out['failure_t']}, rollbacks {out['rollbacks']}; losses "
         f"{rep['losses']}")
    tlog(f"ft run: step s {steps}; C2 s {out['C2_s']} (splits "
         f"{out['C2_split']}); C1 s {out['C1_s']}; restore s "
         f"{out['restore_s']}; last save {out['store_save_split']}, last "
         f"restore {out['store_restore_split']}")
    tlog(f"ft run: policy T solved {op['period_solved_s']:.6g} s, realized "
         f"{op['period_realized_s']:.6g} s, m {op['deep_every']}, k "
         f"{op['period_steps']} steps (step {op['step_s']:.6g} s); energy "
         f"E_total {e['E_total_j']:.6g} J over T_wall {e['T_wall_s']:.6g} s "
         f"({', '.join(f'{k} {v:.6g}' for k, v in e.items())}); run wall "
         f"{rep['wall_s']:.6g} s on its clock, build {run['build_s']:.3f} "
         f"s, run {run['run_s']:.3f} s on the host clock; launches "
         f"mlstm_scan {c['mlstm_scan']}, quantize_leaves "
         f"{c['quantize_leaves']}, dequantize_leaves "
         f"{c['dequantize_leaves']}, one-leaf {c['quantize']} / "
         f"{c['dequantize']}, plain calls {c['plain']}")
    if rep["final_step"] != spec_kw["total_steps"]:
        fail(f"ft run: stopped at step {rep['final_step']}")
    if not (rep["n_failures"] >= 1
            and rep["n_rollbacks"] == rep["n_failures"]
            and store_restores == rep["n_rollbacks"]):
        fail(f"ft run: {rep['n_failures']} failures, "
             f"{rep['n_rollbacks']} rollbacks, {store_restores} from the "
             f"store (want at least one failure, each restored deep)")
    if not all(math.isfinite(x) for x in rep["losses"]):
        fail(f"ft run: a loss is not finite: {rep['losses']}")
    want_ml = _mlstm_per_step(cfg) * run["steps_run"] if on_card else 0
    want_q = (len(deep), store_restores) if on_card else (0, 0)
    if c["mlstm_scan"] != want_ml or (on_card and c["plain"]):
        fail(f"ft run: mlstm_scan launched {c['mlstm_scan']} times (want "
             f"{want_ml}: {_mlstm_per_step(cfg)} for each of "
             f"{run['steps_run']} steps run) with {c['plain']} plain calls")
    if (c["quantize_leaves"], c["dequantize_leaves"]) != want_q or (
            c["quantize"] or c["dequantize"]):
        fail(f"ft run: quant launches {c} against {len(deep)} deep "
             f"checkpoints and {store_restores} deep restores")
    t0 = time.perf_counter()
    out["mlstm_check"] = _ft_mlstm_check(tr.state[0], cfg, tr.data.peek(0))
    tlog(f"ft run: layer 0 mLSTM h at {out['mlstm_check']['shape']} chunk "
         f"{out['mlstm_check']['chunk']}, kernel vs plain: max abs "
         f"{out['mlstm_check']['max_abs_err']:.3e} (gate "
         f"{ZOO_TOL['mlstm_scan']}) in {time.perf_counter() - t0:.2f} s")
    if not out["mlstm_check"]["ok"]:
        fail("ft run: the mLSTM kernel disagrees with its plain version at "
             "the ft path's shape")
    return out


def _ft_part_smoke(dev, root: Path, tlog) -> dict:
    """Part (b): ``repro_torch.launch.train``'s smoke on ``dev`` (its
    gates), then the same spec on the CPU from the same params, equal."""
    import torch
    from repro_torch.ckpt.tree import tree_map
    from repro_torch.ft import run as ft_run
    from repro_torch.launch import train as ft_train
    spec = ft_run.RunSpec(**ft_train.SMOKE_SPEC)
    cfg = _ft_cfg(spec)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        card = ft_train._smoke(str(dev), str(root / "card"))
    except SystemExit as e:
        fail(f"ft smoke on {dev}: {e}")
    _dev_sync(dev)
    card_s = time.perf_counter() - t0
    c = _counts()

    # the CPU run of the spec from the card's initial state (the same
    # seeded generator draws it again), one intra-op thread
    init_tr = ft_run.build(dataclasses.replace(spec,
                                               ckpt_dir=str(root / "i")),
                           device=dev)
    init = init_tr.state
    cpu_tr = ft_run.build(dataclasses.replace(spec,
                                              ckpt_dir=str(root / "cpu")),
                          device="cpu")
    cpu_tr.state = tree_map(lambda x: x.to("cpu"), init)
    calls = _count_steps(cpu_tr)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        cpu = cpu_tr.run()
    finally:
        torch.set_num_threads(threads)
    cpu_s = time.perf_counter() - t0
    cpu["predicted"] = ft_run.predictions(spec, cpu, device="cpu")
    op_c, op_h = card["operating_point"], cpu["operating_point"]
    op_rel = max((abs(op_c[k] - op_h[k]) / abs(op_h[k])
                  for k in op_h if isinstance(op_h[k], float) and op_h[k]),
                 default=0.0)
    pred_rel = max(abs(card["predicted"][k] - cpu["predicted"][k])
                   / abs(cpu["predicted"][k]) for k in cpu["predicted"]
                   if cpu["predicted"][k])
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    ck = lambda rep: sorted((s["step"], s["level"])
                            for s in rep["checkpoints"])
    counts = ("final_step", "n_failures", "n_hard_failures", "n_rollbacks",
              "flush_aborts")
    want_ml = _mlstm_per_step(cfg) * calls[0] if dev.type == "cuda" else 0
    out = {"card_s": card_s, "cpu_s": cpu_s, "launches": c,
           "steps_run": calls[0], "wall_s": card["wall_s"],
           "report_keys": sorted(card),
           "energy_j": card["energy"]["E_total_j"],
           "predicted": card["predicted"], "operating_point": op_c,
           "counts": {k: card[k] for k in counts},
           "checkpoints": len(card["checkpoints"]),
           "wall_equal": card["wall_s"] == cpu["wall_s"],
           "energy_equal": card["energy"] == cpu["energy"],
           "op_max_rel": op_rel, "predicted_max_rel": pred_rel,
           "loss_max_rel": loss_rel}
    tlog(f"ft smoke: {cfg.name} (layers 2, d 64, one mLSTM head of 128), "
         f"{spec.total_steps} steps of {spec.strategy} at mu {spec.mu_s} s, "
         f"seed {spec.seed}: on {dev} {card_s:.2f} s, on the CPU "
         f"{cpu_s:.2f} s ({calls[0]} train steps run); failures "
         f"{card['n_failures']}, rollbacks {card['n_rollbacks']}, "
         f"checkpoints {len(card['checkpoints'])}; wall {card['wall_s']!r} "
         f"s, energy {card['energy']['E_total_j']!r} J, measured/predicted "
         f"wall {card['predicted']['wall_ratio']:.6f}, energy "
         f"{card['predicted']['energy_ratio']:.6f}; T {op_c['period_solved_s']!r}"
         f" s, m {op_c['deep_every']}, k {op_c['period_steps']}; card vs "
         f"CPU: wall equal {out['wall_equal']}, energy equal "
         f"{out['energy_equal']}, operating point {op_rel:.3e}, predicted "
         f"{pred_rel:.3e}, losses {loss_rel:.3e} (gate {FT_LOSS_TOL:g}); "
         f"launches mlstm_scan {c['mlstm_scan']} (want {want_ml}), plain "
         f"calls {c['plain']}")
    if not (out["wall_equal"] and out["energy_equal"]
            and all(card[k] == cpu[k] for k in counts)
            and ck(card) == ck(cpu)
            and all(op_c[k] == op_h[k] for k in op_h
                    if not isinstance(op_h[k], float))
            and op_rel <= FT_OP_RTOL and pred_rel <= FT_OP_RTOL):
        fail("ft smoke: the card's report differs from the CPU's")
    if not loss_rel <= FT_LOSS_TOL:
        fail(f"ft smoke: the card's losses differ from the CPU's by "
             f"{loss_rel:.3e}")
    if c["mlstm_scan"] != want_ml or (dev.type == "cuda" and c["plain"]):
        fail(f"ft smoke: launches {c}")
    out["mlstm_check"] = _ft_mlstm_check(init[0], cfg, init_tr.data.peek(0))
    tlog(f"ft smoke: layer 0 mLSTM h at {out['mlstm_check']['shape']} "
         f"chunk {out['mlstm_check']['chunk']}, kernel vs plain: max abs "
         f"{out['mlstm_check']['max_abs_err']:.3e} (gate "
         f"{ZOO_TOL['mlstm_scan']})")
    if not out["mlstm_check"]["ok"]:
        fail("ft smoke: the mLSTM kernel disagrees with its plain version "
             "at the smoke's shape")
    return out


def _ft_identity_trainer(cfg, params, dev, root: Path, mu_s: float):
    """Part (c)'s trainer: the port's classes, scaled time, every cost
    virtual (``FT_IDENTITY``), on ``params``."""
    from repro_torch.ckpt import (CheckpointManager, ManagerConfig,
                                  ShardedStore, StoreConfig)
    from repro_torch.core.policy import CheckpointPolicy, PolicyConfig
    from repro_torch.data import synthetic
    from repro_torch.energy import EnergyMeter, PAPER_EXASCALE_PROFILE
    from repro_torch.ft import (FailureInjector, FailureModel,
                                FaultTolerantTrainer, TrainerConfig)
    from repro_torch.models import build
    from repro_torch.optim import adamw
    I = FT_IDENTITY
    c, D = I["cost_s"], I["D_s"]
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    pol = CheckpointPolicy(
        PolicyConfig(strategy="algo_t", C_s=c, R_s=c, D_s=D, mu_s=mu_s,
                     omega=I["omega"], mu_from_observations=False),
        PAPER_EXASCALE_PROFILE.power_params(), device=dev)
    mgr = CheckpointManager(
        ShardedStore(StoreConfig(root=str(root), device=dev)), pol,
        ManagerConfig(pfs_every=I["pfs_every"], virtual_C1_s=c,
                      virtual_C2_s=c))
    inj = FailureInjector(FailureModel(
        mu_s=mu_s, downtime_s=D, seed=I["seed"], buddy_loss_prob=I["q"],
        recovery_buddy_s=c, recovery_deep_s=c))
    return FaultTolerantTrainer(
        train_step=build(cfg).make_train_step(ocfg),
        state=(params, adamw.init_state(params, ocfg, device=dev)),
        data=synthetic.for_arch(cfg, batch=I["B"], seq_len=I["S"], seed=0,
                                device=dev),
        policy=pol, manager=mgr, meter=EnergyMeter(PAPER_EXASCALE_PROFILE),
        failures=inj,
        config=TrainerConfig(total_steps=I["steps"],
                             sim_seconds_per_step=1.0))


def run_ft_identity(dev, root: Path, rehearse: bool = False) -> dict:
    """Part (c): a failure-free run and one with failures from the same
    params; whether their final params and AdamW state are bitwise equal,
    leaf by leaf."""
    import torch
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    I = FT_IDENTITY
    cfg = get_config("xlstm-125m")
    cfg = (reduced(cfg, n_layers=I["layers"], d_model=64, n_heads=1)
           if rehearse else dataclasses.replace(cfg, n_layers=I["layers"]))
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    out = {"cfg": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model}
    _reset_counts()
    runs = {}
    for name, mu in (("clean", float("inf")), ("fail", I["mu_s"])):
        tr = _ft_identity_trainer(cfg, params, dev, root / name, mu)
        calls = _count_steps(tr)
        t0 = time.perf_counter()
        rep = tr.run()
        _dev_sync(dev)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_steps_run"] = calls[0]
        runs[name] = (tr, rep)
    out["launches"] = _counts()
    (tc, rc), (tf, rf) = runs["clean"], runs["fail"]
    leaves_c, leaves_f = tree_leaves(tc.state), tree_leaves(tf.state)
    differ = [i for i, (a, b) in enumerate(zip(leaves_c, leaves_f))
              if not torch.equal(a, b)]
    out.update(leaves=len(leaves_c), differ=differ,
               equal=not differ and len(leaves_c) == len(leaves_f),
               final_steps=[rc["final_step"], rf["final_step"]],
               n_failures=rf["n_failures"],
               n_hard_failures=rf["n_hard_failures"],
               flush_aborts=rf["flush_aborts"],
               sources=[e["source"] for e in tf.log],
               levels=sorted({s["level"] for s in rf["checkpoints"]}),
               per_step=_mlstm_per_step(cfg))
    return out


def _ft_part_identity(dev, root: Path, tlog, rehearse: bool) -> dict:
    """Part (c): the rollback identity on ``dev``, bitwise."""
    out = run_ft_identity(dev, root, rehearse)
    c = out["launches"]
    on_card = dev.type == "cuda"
    want = (out["per_step"] * (out["clean_steps_run"] + out["fail_steps_run"])
            if on_card else 0)
    tlog(f"ft identity: {out['cfg']} at {out['layers']} layers, d "
         f"{out['d_model']}, B {FT_IDENTITY['B']}, S {FT_IDENTITY['S']}, "
         f"{FT_IDENTITY['steps']} steps: clean {out['clean_s']:.2f} s "
         f"({out['clean_steps_run']} steps run), with failures "
         f"{out['fail_s']:.2f} s ({out['fail_steps_run']} steps run, "
         f"{out['n_failures']} failures, {out['n_hard_failures']} hard, "
         f"{out['flush_aborts']} flushes aborted, restores from "
         f"{out['sources']}, levels {out['levels']}); final params and "
         f"AdamW state bitwise equal: {out['equal']} ({len(out['differ'])} "
         f"of {out['leaves']} leaves differ); launches mlstm_scan "
         f"{c['mlstm_scan']} (want {want}), plain calls {c['plain']}")
    if out["final_steps"] != [FT_IDENTITY["steps"]] * 2:
        fail(f"ft identity: final steps {out['final_steps']}")
    if out["n_failures"] < 2 or out["n_hard_failures"] < 1:
        fail(f"ft identity: {out['n_failures']} failures "
             f"({out['n_hard_failures']} hard); want 2, one hard")
    if c["mlstm_scan"] != want or (on_card and c["plain"]):
        fail(f"ft identity: launches {c}")
    if not out["equal"]:
        fail(f"ft identity: the final states differ (leaves "
             f"{out['differ']})")
    return out


def phase_ft(dev, card: str, rehearse: bool = False) -> dict:
    """Phase 13: the fault-tolerant runtime (see the module docstring),
    every line with the card's name and power limit, each part's counts
    set to 0 just before it and read just after.  ``rehearse`` runs it on
    the CPU at reduced widths, where no kernel launches."""
    import shutil
    tlog = lambda msg: log(f"{msg} [{card}]")
    root = ROOT / "build" / "chip_smoke_ft"
    shutil.rmtree(root, ignore_errors=True)
    report = {}
    t_phase = time.perf_counter()
    try:
        for key, part in (("run", lambda r: _ft_part_run(dev, r, tlog,
                                                         rehearse)),
                          ("smoke", lambda r: _ft_part_smoke(dev, r, tlog)),
                          ("identity", lambda r: _ft_part_identity(
                              dev, r, tlog, rehearse))):
            t0 = time.perf_counter()
            report[key] = part(root / key)
            report[key]["part_s"] = time.perf_counter() - t0
            shutil.rmtree(root / key, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    tlog(f"ft phase {report['phase_s']:.1f} s (run "
         f"{report['run']['part_s']:.1f}, smoke "
         f"{report['smoke']['part_s']:.1f}, identity "
         f"{report['identity']['part_s']:.1f})")
    return report


# ---------------------------------------------------------------------------
# 14. serving: prefill and greedy decode through launch.serve
# ---------------------------------------------------------------------------

#: part (a): starcoder2-3b at full width (30 layers, d 3072, 24 heads of 128
#: over 2 KV heads, window 4096, vocab 49,152), a prompt longer than the
#: window (the prefill runs the sliding mask and the ring wraps) in two
#: waves; then the int8 KV cache.  Part (b): recurrentgemma-9b at full
#: width (26 RG-LRU and 12 local-attention layers).  Part (d): xLSTM-125M
#: (its prefill through the mLSTM kernel, 8 decode steps).
SERVE_RUNS = {
    "starcoder2-3b": ["--arch", "starcoder2-3b", "--no-reduce", "--batch",
                      "8", "--prompt-len", "8192", "--new-tokens", "32",
                      "--waves", "2", "--seed", "0"],
    "starcoder2-3b-int8": ["--arch", "starcoder2-3b", "--no-reduce",
                           "--batch", "8", "--prompt-len", "2048",
                           "--new-tokens", "16", "--waves", "2",
                           "--kv-cache", "int8", "--seed", "0"],
    "recurrentgemma-9b": ["--arch", "recurrentgemma-9b", "--no-reduce",
                          "--batch", "2", "--prompt-len", "4096",
                          "--new-tokens", "16", "--seed", "0"],
    "xlstm-125m": ["--arch", "xlstm-125m", "--no-reduce", "--batch", "2",
                   "--prompt-len", "1024", "--new-tokens", "9", "--seed",
                   "0"]}
#: phase 15: the other four archs.  (a) llama4-scout at full width cut to
#: one super-block (3 chunked MoE layers, 1 global NoPE), B 1, a prompt of
#: two 8192-token chunks; then the capacity MoE (C 640: the top-1 inverse
#: gather) at 8192.  (b) dbrx at full width cut to 2 layers, B 1, prompt
#: 8192; then the capacity MoE (C 2560: the scan over 512-slot chunks and
#: the top-4 scatter-add).  (c) whisper-tiny whole, B 16
#: (``microbatch_rows_per_device``), 1500 stub frames, prompt 64, 64 new
#: tokens.  (d) internvl2-1b whole, B 16, 256 stub prefix embeddings + a
#: prompt of 1792, 32 new tokens.
SERVE_RUNS.update({
    "llama4-scout": ["--arch", "llama4-scout-17b-a16e", "--no-reduce",
                     "--batch", "1", "--prompt-len", "16384",
                     "--new-tokens", "16", "--seed", "0"],
    "llama4-scout-capacity": ["--arch", "llama4-scout-17b-a16e",
                              "--no-reduce", "--batch", "1", "--prompt-len",
                              "8192", "--new-tokens", "16", "--seed", "0"],
    "dbrx": ["--arch", "dbrx-132b", "--no-reduce", "--batch", "1",
             "--prompt-len", "8192", "--new-tokens", "16", "--seed", "0"],
    "dbrx-capacity": ["--arch", "dbrx-132b", "--no-reduce", "--batch", "1",
                      "--prompt-len", "8192", "--new-tokens", "16", "--seed",
                      "0"],
    "whisper-tiny": ["--arch", "whisper-tiny", "--no-reduce", "--batch",
                     "16", "--prompt-len", "64", "--new-tokens", "64",
                     "--seed", "0"],
    "internvl2-1b": ["--arch", "internvl2-1b", "--no-reduce", "--batch", "16",
                     "--prompt-len", "1792", "--new-tokens", "32", "--seed",
                     "0"]})
#: the config fields a run changes after its flags (``model_main``'s
#: ``cut``): the MoE archs' depth (the cut) and ``moe_impl``.
SERVE_CUTS = {"llama4-scout": dict(n_layers=4),
              "llama4-scout-capacity": dict(n_layers=4, moe_impl="capacity"),
              "dbrx": dict(n_layers=2),
              "dbrx-capacity": dict(n_layers=2, moe_impl="capacity")}
#: the same runs rehearsed on the CPU (``--reduce``, short prompts).
SERVE_REHEARSAL = {"--prompt-len": "64", "--new-tokens": "5"}
#: part (c): the card against the CPU from the same params, B 4, a prompt
#: of 512 with the window cut to 128 (the ring wraps), 4 teacher-forced
#: decode steps; starcoder2-3b's widths at 2 layers, recurrentgemma-9b's at
#: one super-block (rglru, rglru, sliding) with its vocab cut to 4096 (the
#: CPU's copy of the params stays near 2.4 GB).  In f32 compute the median
#: logits row is held within ``f32_median_tol`` and every row within
#: ``f32_row_tol`` (relative Frobenius; see ``_serve_vs_cpu``).
SERVE_VS_CPU = dict(B=4, S=512, window=128, steps=4, seed=0,
                    f32_median_tol=1e-4, f32_row_tol=1e-2,
                    cuts={"starcoder2-3b": dict(n_layers=2),
                          "recurrentgemma-9b": dict(n_layers=3,
                                                    vocab_size=4096)})


def _serve_expected(cfg, args) -> dict:
    """Launches a model-path run makes: flash once per attention layer a
    prefill wave (whisper: once more per decoder layer for the cross
    attention and once per encoder layer), decode once per attention layer
    a step (whisper: twice, self and cross), the RG-LRU scan once per
    RG-LRU layer a wave and a step, the mLSTM once per mLSTM layer a wave
    (its decode runs the state form)."""
    from repro_torch.models.transformer import RECURRENT_KINDS, super_block
    pat, n, tail = super_block(cfg)
    kinds = list(pat) * n + list(tail)
    waves = args.waves if args.waves > 1 and args.batch % args.waves == 0 \
        else 1
    steps = args.new_tokens - 1
    n_attn = sum(k not in RECURRENT_KINDS for k in kinds)
    n_cross = kinds.count("xattn")
    n_enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    return {"flash_attention": (n_attn + n_cross + n_enc) * waves,
            "decode_attention": (n_attn + n_cross) * steps,
            "rglru_scan": kinds.count("rglru") * (waves + steps),
            "mlstm_scan": kinds.count("mlstm") * waves}


def _profile_decode_step(run, dev) -> dict:
    """One more decode step (after the run's last) under ``torch.profiler``:
    its CUDA kernels, their busy time against the step's host clock, and
    the ten kernels that take the most device time.  Then the
    ``expand_kv`` copies of the step timed alone with CUDA events (the K
    and V of every attention layer expanded to the q heads, and whisper's
    cross K/V, back to back, median of 5) and their share of the step's
    busy time; for an MoE arch likewise the casts of its MoE weights to
    the compute dtype (a step casts each layer's once, whole)."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import _kv_dequant
    tok = run.tokens[:, -1:]
    with torch.no_grad(), prof_ctx(activities=[ProfilerActivity.CUDA]) as \
            prof:
        _dev_sync(dev)
        t0 = time.perf_counter()
        run.model.decode_step(run.params, run.cache, tok)
        _dev_sync(dev)
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    n = busy = 0
    by_name = collections.defaultdict(lambda: [0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        ns = e.duration_ns()
        n, busy = n + 1, busy + ns
        by_name[e.name()][0] += 1
        by_name[e.name()][1] += ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    cfg = run.cfg
    cd = getattr(torch, cfg.compute_dtype)
    entries = []
    for e in run.cache["layers"]["stages"]:
        if isinstance(e, dict):                    # stacked: leading (n,)
            entries += [{k: v[i] for k, v in e.items()}
                        for i in range(e["k"].shape[0])]
    entries += [e for e in run.cache["layers"]["tail"]
                if isinstance(e, dict)]

    def kv(e, key):                        # what decode_attention expands
        if cfg.kv_cache_dtype == "int8":
            return _kv_dequant(e[key], e[key + "_scale"], cd)
        return e[key]
    with torch.no_grad():
        layers = [(kv(e, "k"), kv(e, "v")) for e in entries]
        layers += [(e["xk"], e["xv"]) for e in entries if "xk" in e]

    def expand_all():
        for k, v in layers:
            attn.expand_kv(cfg, k)
            attn.expand_kv(cfg, v)
    with torch.no_grad():
        expand_ms = _events_ms(expand_all)
    out = {"step_s": wall, "kernels": n, "busy_s": busy * 1e-9,
           "busy_share": busy * 1e-9 / wall if wall else 0.0,
           "top": [{"name": k[:96], "count": c, "ms": ns * 1e-6}
                   for k, (c, ns) in top],
           "expand_layers": len(layers), "expand_ms": expand_ms,
           "expand_share": expand_ms * 1e-3 / (busy * 1e-9) if busy
           else 0.0}
    if cfg.n_experts:        # the MoE's per-use casts of its weights
        moes = [st["moe"] for st in run.params["stages"] if "moe" in st]
        mats = [w for m in moes for w in tree_leaves(m)]
        mats += [w for t in run.params["tail"] if "moe" in t
                 for w in tree_leaves(t["moe"])]

        def casts():
            for w in mats:
                w.to(cd)
        with torch.no_grad():
            out["casts_ms"] = _events_ms(casts)
        out["casts_bytes"] = sum(w.numel() * (w.element_size() + 2)
                                 for w in mats)
        out["casts_share"] = (out["casts_ms"] * 1e-3 / (busy * 1e-9)
                              if busy else 0.0)
        out["casts_leaves"] = len(mats)
    return out


def _serve_part(name, dev, tlog, rehearse: bool) -> dict:
    """One ``launch.serve.model_main`` run of ``SERVE_RUNS[name]`` with its
    counts set to 0 just before it and read just after; its decode loop
    under ``torch.cuda.set_sync_debug_mode("error")`` on the card.  Gates:
    the last logits finite, every kernel of the path launched as
    ``_serve_expected`` says, no other kernel, no plain version."""
    import torch
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.launch import serve
    argv = list(SERVE_RUNS[name])
    if rehearse:
        argv[argv.index("--no-reduce")] = "--reduce"
        for k, v in SERVE_REHEARSAL.items():
            argv[argv.index(k) + 1] = v
    args = serve.build_parser().parse_args(argv + ["--device", dev.type])
    cut = SERVE_CUTS.get(name)
    on_card = dev.type == "cuda"
    base = 0
    if on_card:            # the run's own peak: earlier phases hold tensors
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    _reset_counts()
    t0 = time.perf_counter()
    run = serve.model_main(args, sync_debug="error" if on_card else None,
                           cut=cut)
    _dev_sync(dev)
    host_s = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated(dev) - base if on_card else 0
    expected = _serve_expected(run.cfg, args)
    got = {k: counts[k] for k in expected}
    finite = bool(torch.isfinite(run.logits.float()).all())
    steps = args.new_tokens - 1
    tlog(f"serve {name}: {run.cfg.name} (cut {cut}), B {args.batch}, "
         f"prompt {args.prompt_len}, {args.new_tokens} new tokens, waves "
         f"{args.waves}, kv {args.kv_cache}: prefill {run.prefill_s:.4f} "
         f"s, decode {run.decode_s:.4f} s "
         f"({run.decode_s / max(steps, 1) * 1e3:.3f} ms a step), run "
         f"{host_s:.2f} s with the init; peak device memory "
         f"{peak / 2**30:.2f} GiB over the {base / 2**30:.2f} GiB held "
         f"before it; launches {got} (expected {expected}), "
         f"plain-version calls {counts['plain']}")
    others = {k: v for k, v in counts.items()
              if k not in expected and k != "plain" and v}
    if not finite:
        fail(f"serve {name}: the logits are not finite")
    plain = counts["plain"]
    if not on_card:            # the plain versions stand in, call for call
        ok = plain == sum(expected.values()) and not others
    else:
        ok = got == expected and not others and not plain
    if not ok:
        fail(f"serve {name}: launches {got} (others {others}, plain "
             f"{plain}) where the path makes {expected}")
    out = {"argv": argv, "cut": cut, "prefill_s": run.prefill_s,
           "decode_s": run.decode_s,
           "decode_ms_per_step": run.decode_s / max(steps, 1) * 1e3,
           "host_s": host_s, "peak_bytes": peak, "launches": got,
           "params": sum(x.numel() for x in tree_leaves(run.params))}
    if on_card and name != "xlstm-125m":
        out["profile"] = prof = _profile_decode_step(run, dev)
        tlog(f"serve {name}: one decode step {prof['step_s'] * 1e3:.3f} ms "
             f"on the host clock, {prof['kernels']} CUDA kernels busy "
             f"{prof['busy_s'] * 1e3:.3f} ms ({prof['busy_share']:.1%}); "
             f"the expand_kv copies of its {prof['expand_layers']} "
             f"attention layers {prof['expand_ms']:.3f} ms alone, "
             f"{prof['expand_share']:.1%} of the busy time; by device time: "
             + "; ".join(f"{t['name']} x{t['count']} {t['ms']:.3f} ms"
                         for t in prof["top"]))
        if "casts_ms" in prof:
            tlog(f"serve {name}: the step's MoE weight casts "
                 f"({prof['casts_leaves']} leaves, "
                 f"{prof['casts_bytes'] / 1e9:.2f} GB read and written) "
                 f"{prof['casts_ms']:.3f} ms alone, "
                 f"{prof['casts_share']:.1%} of the busy time")
    del run
    return out


def _row_errs(a, b) -> list:
    """Relative Frobenius error of each logits row of ``a`` (B, 1, V)
    against ``b``, in f64."""
    import torch
    a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
    return (torch.linalg.vector_norm(a - b, dim=-1)
            / torch.linalg.vector_norm(b, dim=-1)).tolist()


def _serve_vs_cpu(dev, tlog, rehearse: bool) -> dict:
    """Part (c): one model built on the card, its params copied to the CPU;
    prefill and teacher-forced decode on both, in f32 and in bf16 compute;
    each logits row (a sequence at a step) of the card against the CPU's,
    in relative Frobenius.

    The reference's fan-in rule for q/k/v (the head axis) makes these
    random models' attention near one-hot (scores of std ~Dh after
    the scale), so where two keys nearly tie a rounding difference moves
    a row far: in bf16 whole, in f32 by orders more than the typical
    row.  So each dtype holds the median row tightly and every row
    loosely: f32 the median within ``f32_median_tol`` and every row
    within ``f32_row_tol``; bf16 the median within the reference's bf16
    tolerance (5e-2 for sliding archs, else 3e-2).  A wrong head fold,
    mask or ring slot moves most rows by O(1).  Every row is printed."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.ckpt.tree import tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    c = SERVE_VS_CPU
    S, steps = (64, 2) if rehearse else (c["S"], c["steps"])
    window = 16 if rehearse else c["window"]
    out = {}
    for name, cut in c["cuts"].items():
        cfg = get_config(name)
        if rehearse:
            cfg = reduced(cfg, d_model=128, n_heads=1)
        cfg = dataclasses.replace(cfg, window=window, **cut)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        params = build(cfg).init(
            torch.Generator(device=dev).manual_seed(c["seed"]), device=dev)
        host = tree_map(lambda t: t.cpu(), params)
        toks = torch.randint(0, cfg.vocab_size, (c["B"], S + steps),
                             generator=torch.Generator().manual_seed(
                                 c["seed"]))

        def run(device, p, cfg_):
            return _teacher_forced(build(cfg_), p, {}, toks, S, steps, device)

        card32, card32_s = run(dev, params, cfg32)
        card, card_s = run(dev, params, cfg)
        del params
        cpu32, cpu32_s = run(torch.device("cpu"), host, cfg32)
        cpu, cpu_s = run(torch.device("cpu"), host, cfg)
        tol = 5e-2 if cfg.attention == "sliding" else 3e-2
        f32_rows, bf16_rows = _row_errs(card32, cpu32), _row_errs(card, cpu)
        own = _row_errs(cpu, cpu32)         # the CPU's bf16 against its f32
        f32_median = statistics.median(f32_rows)
        bf16_median = statistics.median(bf16_rows)
        finite = bool(torch.isfinite(card).all() and
                      torch.isfinite(card32).all())
        r = {"rows": len(f32_rows), "f32_median": f32_median,
             "f32_max": max(f32_rows), "bf16_median": bf16_median,
             "bf16_max": max(bf16_rows),
             "bf16_over": sum(e > tol for e in bf16_rows), "tol": tol,
             "cpu_bf16_vs_f32_median": statistics.median(own),
             "f32_rows": f32_rows, "bf16_rows": bf16_rows,
             "card_s": card_s, "card32_s": card32_s, "cpu_s": cpu_s,
             "cpu32_s": cpu32_s, "finite": finite}
        rows = lambda es: " ".join(f"{e:.1e}" for e in es)
        tlog(f"serve card vs cpu {name} ({cfg.n_layers} layers, d "
             f"{cfg.d_model}, vocab {cfg.vocab_size}, window {window}, B "
             f"{c['B']}, S {S}, {steps} steps; {r['rows']} logits rows, "
             f"relative Frobenius): f32 median {f32_median:.3e} (tol "
             f"{c['f32_median_tol']}), max {r['f32_max']:.3e} (tol "
             f"{c['f32_row_tol']}); bf16 median {bf16_median:.3e} (tol "
             f"{tol}), max {r['bf16_max']:.3e}, {r['bf16_over']} rows over "
             f"tol; the CPU's bf16 against its f32, median "
             f"{r['cpu_bf16_vs_f32_median']:.3e}; card f32 {card32_s:.2f} "
             f"s, bf16 {card_s:.2f} s, CPU f32 {cpu32_s:.2f} s, bf16 "
             f"{cpu_s:.2f} s; f32 rows (sequence-major) {rows(f32_rows)}; "
             f"bf16 rows {rows(bf16_rows)}")
        if not (finite and f32_median <= c["f32_median_tol"]
                and r["f32_max"] <= c["f32_row_tol"]
                and bf16_median <= tol):
            fail(f"serve card vs cpu {name}: {r}")
        out[name] = r
        del host
    return out


def phase_serve(dev, card: str, rehearse: bool = False) -> dict:
    """Phase 14: the serving path (see the module docstring), every line
    with the card's name and power limit, each part's counts set to 0 just
    before it and read just after.  ``rehearse`` runs it on the CPU at
    reduced widths, where no kernel launches."""
    import torch
    tlog = lambda msg: log(f"{msg} [{card}]")
    report = {}
    t_phase = time.perf_counter()
    for name in ("starcoder2-3b", "starcoder2-3b-int8", "recurrentgemma-9b"):
        t0 = time.perf_counter()
        report[name] = _serve_part(name, dev, tlog, rehearse)
        report[name]["part_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["vs_cpu"] = _serve_vs_cpu(dev, tlog, rehearse)
    report["vs_cpu"]["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["xlstm-125m"] = _serve_part("xlstm-125m", dev, tlog, rehearse)
    report["xlstm-125m"]["part_s"] = time.perf_counter() - t0
    report["phase_s"] = time.perf_counter() - t_phase
    report["launches"] = {k: sum(report[r]["launches"].get(k, 0) for r in (
        "starcoder2-3b", "starcoder2-3b-int8", "recurrentgemma-9b",
        "xlstm-125m")) for k in ("flash_attention", "decode_attention",
                                 "rglru_scan", "mlstm_scan")}
    tlog(f"serve phase {report['phase_s']:.1f} s ("
         + ", ".join(f"{k} {report[k]['part_s']:.1f}" for k in (
             "starcoder2-3b", "starcoder2-3b-int8", "recurrentgemma-9b",
             "vs_cpu", "xlstm-125m")) + f"); launches {report['launches']}")
    return report


#: part (e): the card against the CPU from the same params, in f32 and
#: bf16 compute, B 2, prefill then 4 teacher-forced steps.  whisper-tiny
#: and internvl2-1b at their whole widths (1500 frames; 256 prefix
#: embeddings before a prompt of 32) cut in depth, as phase 14 (c) cuts
#: its archs: whisper to one encoder and one decoder layer, internvl to 2
#: layers.  Whole, their random models are chaotic: a 1e-6 relative
#: change of the frames or the prefix moves the CPU's own f32 logits by
#: percents (whisper) or by O(1) (internvl), which ``_sensitivity``
#: prints, so no device comparison of the whole models can read the
#: implementation.  The MoE archs at heads of 128 with their widths cut
#: (d 1024, 8 heads over 2 KV heads, d_ff 2048, vocab 4096), every expert
#: and top-k kept (llama4's shared expert too), llama4 one super-block
#: with a chunk of 128 at S 512, dbrx 2 layers, each under both
#: ``moe_impl``s.  Gates: phase 14 (c)'s (llama4's: ``LLAMA4_TOL``), and
#: each config's own f32 sensitivity printed beside them.  A routing flip
#: (a token whose top-k set differs between the devices) moves its
#: sequence's later rows by O(1); a row after a flip whose top-k gap (on
#: the CPU, in f64) is under ``flip_gap`` may leave the every-row f32
#: gate, and is printed.
MOE_CUT = dict(d_model=1024, n_heads=8, n_kv_heads=2, head_dim=0,
               d_ff=2048, vocab_size=4096)
#: llama4's cut model is itself ill-conditioned: one f32 ulp of its
#: embedding table moves its prefill's logits rows by 2e-5 to 3e-4 on a
#: CPU alone (``_sensitivity``, printed), and the devices' rounding
#: differences, at every op, move them by 5e-5 to 2.4e-3, so its f32
#: median is held at 3e-3; in bf16 its top-1 router flips about 5% of its
#: decisions between the devices (a token then takes another expert
#: whole, and under capacity moves the drops), so its bf16 median is held
#: at 3e-1.  A wrong mask, slot or combine moves rows by O(1).
LLAMA4_TOL = dict(f32_median_tol=3e-3, bf16_median_tol=3e-1)
SERVE15_VS_CPU = dict(
    B=2, steps=4, seed=0, f32_median_tol=1e-4, f32_row_tol=1e-2,
    bf16_median_tol=5e-2, flip_gap=1e-5,
    runs={"whisper-tiny": dict(S=32, cut=dict(n_layers=1,
                                              n_encoder_layers=1)),
          "internvl2-1b": dict(S=32, cut=dict(n_layers=2)),
          "llama4-scout-17b-a16e": dict(S=512, cut=dict(
              MOE_CUT, n_layers=4, chunk=128), **LLAMA4_TOL),
          "llama4-scout-17b-a16e-capacity": dict(S=512, cut=dict(
              MOE_CUT, n_layers=4, chunk=128, moe_impl="capacity"),
              **LLAMA4_TOL),
          "dbrx-132b": dict(S=512, cut=dict(MOE_CUT, n_layers=2)),
          "dbrx-132b-capacity": dict(S=512, cut=dict(
              MOE_CUT, n_layers=2, moe_impl="capacity"))})


class _RouterLog:
    """While active, records every ``models.moe._router`` call: the step it
    belongs to (``step``, set by the caller: 0 the prefill, i + 1 decode
    step i), the top-k mask of each token (B, S, E) and, on the host, the
    router's input and weights (for the top-k gap)."""

    def __init__(self):
        self.calls, self.step = [], 0

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = orig = moe._router

        def rec(cfg, p, x):
            combine = orig(cfg, p, x)
            self.calls.append((self.step, (combine > 0).cpu(),
                               x.detach().double().cpu(),
                               p["router"].to(x.dtype).double().cpu(),
                               cfg.top_k))
            return combine
        moe._router = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._router = self._orig


def _routing_flips(card_log, cpu_log) -> list:
    """Tokens whose top-k sets differ between the devices, call by call:
    (call, step, sequence, token, top-k gap on the CPU's input in f64)."""
    import torch
    flips = []
    for i, (a, b) in enumerate(zip(card_log.calls, cpu_log.calls)):
        step, mask_card, _, _, k = a
        _, mask_cpu, x, w, _ = b
        diff = (mask_card != mask_cpu).any(-1)
        for bi, t in diff.nonzero().tolist():
            probs = torch.softmax(x[bi, t] @ w, dim=-1).sort(
                descending=True).values
            gap = float(probs[k - 1] - probs[k]) if k < len(probs) else 0.0
            flips.append({"call": i, "step": step, "seq": bi, "token": t,
                          "gap": gap})
    return flips


def _stub_inputs(cfg, B: int, gen) -> dict:
    """whisper's frames or internvl's prefix, 0.02 times a normal draw
    from ``gen`` (on the host), as the launcher makes them."""
    import torch
    batch = {}
    if cfg.is_encoder_decoder:
        batch["frames"] = 0.02 * torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen)
    if cfg.n_prefix_tokens:
        batch["prefix"] = 0.02 * torch.randn(
            (B, cfg.n_prefix_tokens, cfg.d_model), generator=gen)
    return batch


def _sensitivity(cfg, S: int, what: str) -> list:
    """A model's own f32 sensitivity on the CPU (B 2, prompt ``S``, the
    port's random init from seed 0): each last-position logits row's
    relative Frobenius change when ``what`` is ``"embed"`` (the embedding
    table times 1 + 1e-7, an f32 ulp) or ``"stub"`` (the frames or prefix
    times 1 + 1e-6).  Printed, not gated: rounding differences between the
    devices cannot read below it."""
    import torch
    from repro_torch.models import build
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    m = build(cfg)
    gen = torch.Generator().manual_seed(0)
    params = m.init(gen, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
    batch = _stub_inputs(cfg, 2, gen)
    if what == "embed":
        moved = dict(params, embed=params["embed"] * (1 + 1e-7))
        other = batch
    else:
        moved = params
        other = {k: v * (1 + 1e-6) for k, v in batch.items()}
    with torch.no_grad():
        a = m.prefill(params, dict(batch, tokens=toks))[0]
        b = m.prefill(moved, dict(other, tokens=toks))[0]
    return _row_errs(b, a)


def _teacher_forced(model, params, batch, toks, S, steps, device,
                    router_log=None):
    """Prefill ``toks[:, :S]`` (with ``batch``'s frames or prefix), then
    ``steps`` teacher-forced decode steps; returns the logits (B, steps +
    1, V) as f32 on the host and the host seconds."""
    import torch
    t0 = time.perf_counter()
    P = batch["prefix"].shape[1] if "prefix" in batch else 0
    with torch.no_grad():
        lg, cache = model.prefill(
            params, dict({k: v.to(device) for k, v in batch.items()},
                         tokens=toks[:, :S].to(device)),
            max_cache_seq=S + P + steps)
        outs = [lg]
        for i in range(steps):
            if router_log is not None:
                router_log.step = i + 1
            lg, cache = model.decode_step(
                params, cache, toks[:, S + i:S + i + 1].to(device))
            outs.append(lg)
    lg = torch.cat([o.float().cpu() for o in outs], dim=1)
    return lg, time.perf_counter() - t0


def _serve15_vs_cpu(dev, tlog, rehearse: bool) -> dict:
    """Part (e): ``SERVE15_VS_CPU``; each logits row (a sequence at a step)
    of the card against the CPU's, in relative Frobenius, with the routing
    flips between them."""
    import statistics
    import torch
    from repro_torch.ckpt.tree import tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    c = SERVE15_VS_CPU
    out = {}
    for name, run in c["runs"].items():
        arch = name.removesuffix("-capacity")
        cut, S, steps = dict(run["cut"]), run["S"], c["steps"]
        tol = {k: run.get(k, c[k]) for k in ("f32_median_tol",
                                              "bf16_median_tol")}
        cfg = get_config(arch)
        if rehearse:
            cfg = reduced(cfg, d_model=128, n_heads=1)
            cut = {k: v for k, v in cut.items()
                   if k in ("n_layers", "n_encoder_layers", "moe_impl")}
            S = 64 if cfg.n_experts else 16
        cfg = dataclasses.replace(cfg, **cut)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        params = build(cfg).init(
            torch.Generator(device=dev).manual_seed(c["seed"]), device=dev)
        host = tree_map(lambda t: t.cpu(), params)
        gen = torch.Generator().manual_seed(c["seed"])
        toks = torch.randint(0, cfg.vocab_size, (c["B"], S + steps),
                             generator=gen)
        batch = _stub_inputs(cfg, c["B"], gen)
        res, logs = {}, {}
        for key, device, p, cf in (("card32", dev, params, cfg32),
                                   ("card", dev, params, cfg),
                                   ("cpu32", torch.device("cpu"), host,
                                    cfg32),
                                   ("cpu", torch.device("cpu"), host, cfg)):
            with _RouterLog() as rlog:
                res[key] = _teacher_forced(build(cf), p, batch, toks, S,
                                           steps, device, rlog)
            logs[key] = rlog
        del params
        rows = {dt: _row_errs(res["card" + sfx][0], res["cpu" + sfx][0])
                for dt, sfx in (("f32", "32"), ("bf16", ""))}
        flips = {dt: _routing_flips(logs["card" + sfx], logs["cpu" + sfx])
                 for dt, sfx in (("f32", "32"), ("bf16", ""))}
        per_seq = steps + 1
        exempt = sorted({f["seq"] * per_seq + s for f in flips["f32"]
                         if f["gap"] < c["flip_gap"]
                         for s in range(f["step"], per_seq)})
        held = [e for i, e in enumerate(rows["f32"]) if i not in exempt]
        r = {"rows": len(rows["f32"]),
             "f32_median": statistics.median(rows["f32"]),
             "f32_max": max(rows["f32"]),
             "f32_max_held": max(held) if held else 0.0,
             "bf16_median": statistics.median(rows["bf16"]),
             "bf16_max": max(rows["bf16"]),
             "f32_rows": rows["f32"], "bf16_rows": rows["bf16"],
             "flips": {dt: len(f) for dt, f in flips.items()},
             "flip_list": flips, "exempt_rows": exempt,
             "secs": {k: v[1] for k, v in res.items()},
             "finite": all(bool(torch.isfinite(res[k][0]).all())
                           for k in ("card", "card32"))}
        fmt = lambda es: " ".join(f"{e:.1e}" for e in es)
        moe_impl = cfg.moe_impl if cfg.n_experts else None
        tlog(f"serve15 card vs cpu {name} ({cfg.n_layers} layers, d "
             f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, "
             f"vocab {cfg.vocab_size}, moe {moe_impl}, B {c['B']}, S {S}, "
             f"{steps} steps; {r['rows']} "
             f"rows, relative Frobenius): f32 median {r['f32_median']:.3e} "
             f"(tol {tol['f32_median_tol']}), max {r['f32_max']:.3e}, max "
             f"held {r['f32_max_held']:.3e} (tol {c['f32_row_tol']}); bf16 "
             f"median {r['bf16_median']:.3e} (tol {tol['bf16_median_tol']}), "
             f"max {r['bf16_max']:.3e}; routing flips f32 "
             f"{r['flips']['f32']}, bf16 {r['flips']['bf16']}; rows exempt "
             f"after a flip under gap {c['flip_gap']}: {exempt}; secs "
             + ", ".join(f"{k} {v:.2f}" for k, v in r["secs"].items())
             + f"; f32 rows {fmt(rows['f32'])}; bf16 rows "
             f"{fmt(rows['bf16'])}")
        for f in flips["f32"]:
            tlog(f"serve15 card vs cpu {name}: f32 routing flip {f}")
        if not (r["finite"] and r["f32_median"] <= tol["f32_median_tol"]
                and r["f32_max_held"] <= c["f32_row_tol"]
                and r["bf16_median"] <= tol["bf16_median_tol"]):
            fail(f"serve15 card vs cpu {name}: "
                 f"{ {k: v for k, v in r.items() if k != 'flip_list'} }")
        r["ulp_sensitivity"] = _sensitivity(cfg, S, "embed")
        tlog(f"serve15 sensitivity {name} ({cfg.n_layers} layers, S {S}), "
             f"the CPU in f32: the embedding table x (1 + 1e-7) moves the "
             f"prefill's logits rows by "
             f"{' '.join(f'{e:.2e}' for e in r['ulp_sensitivity'])}")
        if batch:
            whole = get_config(arch)
            if rehearse:
                whole = reduced(whole, d_model=128, n_heads=1)
            r["whole_sensitivity"] = _sensitivity(whole, 32, "stub")
            tlog(f"serve15 sensitivity {arch} whole ({whole.n_layers} "
                 f"layers), the CPU in f32: the stub inputs x (1 + 1e-6) "
                 f"move the prefill's logits rows by "
                 f"{' '.join(f'{e:.2e}' for e in r['whole_sensitivity'])}")
        out[name] = r
        del host
    return out


#: phase 15's model-path runs, in order.
SERVE15_PARTS = ("llama4-scout", "llama4-scout-capacity", "dbrx",
                 "dbrx-capacity", "whisper-tiny", "internvl2-1b")


def phase_serve15(dev, card: str, rehearse: bool = False) -> dict:
    """Phase 15: the other four archs served (see the module docstring),
    every line with the card's name and power limit, each part's counts
    set to 0 just before it and read just after, each model freed before
    the next is built.  ``rehearse`` runs it on the CPU at reduced widths,
    where no kernel launches."""
    import torch
    tlog = lambda msg: log(f"{msg} [{card}]")
    report = {}
    t_phase = time.perf_counter()
    for name in SERVE15_PARTS:
        t0 = time.perf_counter()
        report[name] = _serve_part(name, dev, tlog, rehearse)
        report[name]["part_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["vs_cpu"] = _serve15_vs_cpu(dev, tlog, rehearse)
    report["vs_cpu"]["part_s"] = time.perf_counter() - t0
    report["phase_s"] = time.perf_counter() - t_phase
    report["launches"] = {k: sum(report[r]["launches"].get(k, 0)
                                 for r in SERVE15_PARTS)
                          for k in ("flash_attention", "decode_attention")}
    tlog(f"serve15 phase {report['phase_s']:.1f} s ("
         + ", ".join(f"{k} {report[k]['part_s']:.1f}"
                     for k in SERVE15_PARTS + ("vs_cpu",))
         + f"); launches {report['launches']}")
    return report


# ---------------------------------------------------------------------------
# 16. train through attention and the RG-LRU
# ---------------------------------------------------------------------------

#: parts (a) and (b), the train-starcoder2-3b and train-rg9b cells: the
#: configs at full width cut in depth, bf16 compute, ``remat="full"``,
#: AdamW (``TRAIN_OPT``), ``TRAIN16_STEPS`` steps of ``make_train_step`` on
#: one ``SyntheticLM`` batch (seed 0).  starcoder2-3b: 4 of 30 layers, B 4
#: (``microbatch_rows_per_device``) x S 4096 (``train_4k``), where S equals
#: the window and the dispatch takes the causal route.  recurrentgemma-9b:
#: one super-block (rglru, rglru, sliding), B 1 x S 4096, the whole
#: 256,000 vocab.  ``analytic`` is ``ArchConfig.param_count()``, ``tree``
#: the parameter tree's size (norm scales and biases included).
TRAIN16 = {
    "starcoder2-3b": dict(n_layers=4, B=4, S=4096, analytic=685_796_352,
                          tree=685_824_000),
    "recurrentgemma-9b": dict(n_layers=3, B=1, S=4096,
                              analytic=2_690_723_840, tree=2_690_740_224)}
TRAIN16_STEPS = 3
#: part (c): ``launch.train``'s CLI on reduced starcoder2-3b with heads of
#: 64 (the card's flash takes 64, 128 or 256), scaled time, failures at a
#: mu of 15 virtual seconds; the same command on the CPU beside it.
TRAIN16_CLI = ["--arch", "starcoder2-3b", "--layers", "2", "--d-model",
               "128", "--n-heads", "2", "--steps", "24", "--mtbf", "15",
               "--strategy", "algo_t", "--seed", "3", "--quiet"]
#: part (d): the card against the CPU from the same params (drawn on the
#: host), loss and every gradient leaf, B 2, S 256, at reduced widths the
#: kernels take (d 128, 2 heads of 64), ``remat="full"``: starcoder2-3b
#: at 2 layers (its window 32: sliding), recurrentgemma-9b at one
#: super-block, whisper-tiny at one encoder and one decoder layer (bidir
#: over its 32 stub frames, causal, and cross attention with Sq 256 !=
#: Skv 32), llama4-scout at one super-block (three chunked MoE layers,
#: chunk 32, and a global causal NoPE one; 4 experts, top-1, the shared
#: expert).  Gates: in f32 the median leaf's relative Frobenius error
#: within 1e-4 and every leaf within 1e-2 (phase 14 (c)'s: random
#: attention is near one-hot, so near ties move single leaves); a leaf
#: that is zero by math (the top-1 router's, whose weights are 1 whatever
#: its logits) reads rounding noise on both devices and is held to 1e-6
#: of the largest leaf's norm instead; in bf16 the loss within
#: ``TRAIN_CPU_TOL`` (relative) of the CPU's.  The port's init (the
#: reference's fan-in rule) makes random attention near one-hot: one f32
#: ulp of the embedding table moves these models' gradient leaves on a
#: CPU alone by a median of 5.8e-6 (whisper) to 8.9e-5 (recurrentgemma)
#: and 1.2e-3 (llama4, whose top-1 routing also flips), near or above the
#: gate, so no device comparison could read the implementation through
#: them.  The q and k projections are therefore scaled by ``qk_scale``
#: after the init (the scores by its square): the same ulp then moves the
#: medians by 2.4e-7 to 3.8e-6.  That sensitivity is printed beside each
#: reading.  A wrong mask,
#: fold or backward moves leaves by O(1) at either scale.
TRAIN16_VS_CPU = dict(B=2, S=256, seed=0, f32_median_tol=1e-4,
                      f32_leaf_tol=1e-2, zero_leaf_tol=1e-6, qk_scale=0.25,
                      runs={"starcoder2-3b": dict(n_layers=2),
                            "recurrentgemma-9b": dict(n_layers=3),
                            "whisper-tiny": dict(n_layers=1,
                                                 n_encoder_layers=1),
                            "llama4-scout-17b-a16e": dict(n_layers=4)})
#: part (e): the remat check's config (recurrentgemma-9b reduced as in
#: (d), 4 super-blocks) and its gate: ``remat_group`` 2 against 1, loss
#: and gradients in f32, relative Frobenius.
TRAIN16_REMAT = dict(arch="recurrentgemma-9b", n_layers=12, B=2, S=256,
                     tol=1e-6)
#: part (e): the RG-LRU's backward at (1, 512, 4096) against autograd
#: through ``rglru_scan_plain``: max |a - b| / max |b| per gradient.
TRAIN16_RG_SHAPE, TRAIN16_RG_TOL = (1, 512, 4096), 1e-5
#: part (e): the reference autograd of ``flash_attention_plain`` runs over
#: this many (batch, head) rows at a time.
TRAIN16_REF_ROWS = 8


def _train16_cfg(name: str, **cut):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), compute_dtype="bfloat16",
                               remat="full", **cut)


def _train16_reduced(name: str, cd: str, **cut):
    """``name`` reduced to d 128 with 2 heads of 64, cut by ``cut``,
    ``remat="full"``, compute dtype ``cd``."""
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(
        reduced(get_config(name), d_model=128, n_heads=2), remat="full",
        compute_dtype=cd, **cut)


def _train16_launches(cfg, grad: bool = True) -> dict:
    """Flash and RG-LRU launches of one ``Model.loss`` with its backward
    (``grad``) or without.  Every attention call launches flash once (an
    ``xattn`` layer twice: self and cross; each encoder layer once), every
    RG-LRU layer its scan once.  With a gradient under ``remat="full"``
    each stage layer and each encoder layer runs its forward again before
    its backward; with ``remat_group = g > 1`` the group's recompute runs
    a third forward of each of its layers but the last (the checkpoint's
    recompute stops once it has rebuilt what the group saved, and the
    last layer's input is the last of that).  An RG-LRU layer's backward
    makes one more launch, the reverse scan."""
    from repro_torch.models.transformer import RECURRENT_KINDS, super_block
    pat, n, tail = super_block(cfg)
    remat = grad and cfg.remat == "full"
    g = max(1, cfg.remat_group)
    g = g if remat and g > 1 and n % g == 0 else 1
    stage = [k for _ in range(n) for k in pat]
    runs = [1 + remat + (g > 1 and (i + 1) % (g * len(pat)) != 0)
            for i in range(len(stage))] + [1] * len(tail)
    flash = rg = 0
    for kind, r in zip(stage + list(tail), runs):
        if kind == "rglru":
            rg += r + grad
        elif kind not in RECURRENT_KINDS:
            flash += r * (2 if kind == "xattn" else 1)
    if cfg.is_encoder_decoder:
        flash += cfg.n_encoder_layers * (1 + remat)
    return {"flash_attention": flash, "rglru_scan": rg}


def _train16_want(cfg, dev) -> dict:
    """``_train16_launches(cfg)`` on the card; none on the CPU."""
    want = _train16_launches(cfg)
    return want if dev.type == "cuda" else {k: 0 for k in want}


def _profile_train16(step, params, opt, batch, dev) -> dict:
    """One more step (its result dropped) under ``torch.profiler``: its
    CUDA kernels, their busy time and share of the step, and the flash and
    RG-LRU kernels' counts and time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        _dev_sync(dev)
        t0 = time.perf_counter()
        step(params, opt, batch)
        _dev_sync(dev)
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    out = {"profiled_wall_s": wall, "kernels": 0, "busy_s": 0.0,
           "flash_kernels": 0, "flash_s": 0.0, "rglru_kernels": 0,
           "rglru_s": 0.0}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        s = e.duration_ns() * 1e-9
        out["kernels"] += 1
        out["busy_s"] += s
        for key, frag in (("flash", "flash_"), ("rglru", "rglru_")):
            if frag in e.name() and "kernel" in e.name():
                out[f"{key}_kernels"] += 1
                out[f"{key}_s"] += s
    out["busy_share"] = out["busy_s"] / wall
    return out


def _free(dev) -> None:
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _train16_part(name: str, dev, tlog) -> dict:
    """Part (a) or (b): the steps, their launches, the peak memory, one
    profiled step; the model is freed before returning."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.models import build
    from repro_torch.models.spec import tree_size
    from repro_torch.optim import adamw
    run = TRAIN16[name]
    on_card = dev.type == "cuda"
    cfg = _train16_cfg(name, n_layers=run["n_layers"])
    m = build(cfg)
    _free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(TRAIN["seed"])
    params = m.init(gen, device=dev)
    n_tree = tree_size(m.param_spec())
    batch = synthetic.for_arch(cfg, batch=run["B"], seq_len=run["S"],
                               seed=TRAIN["seed"], device=dev).peek(0)
    step = m.make_train_step(adamw.AdamWConfig(**TRAIN_OPT))
    opt = adamw.init_state(params, device=dev)
    want = _train16_want(cfg, dev)
    out = {"cfg": {"n_layers": cfg.n_layers, "B": run["B"], "S": run["S"],
                   "params_tree": n_tree, "params_analytic":
                   cfg.param_count()},
           "losses": [], "grad_norms": [], "step_s": []}
    _dev_sync(dev)
    _reset_counts()
    for _ in range(TRAIN16_STEPS):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
        _dev_sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
    c = _counts()
    out["launches"] = c
    out["want_per_step"] = want
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["profile"] = _profile_train16(step, params, opt, batch, dev)
    tlog(f"train16 {name}: {cfg.n_layers} layers, B {run['B']} x S "
         f"{run['S']}, params {n_tree} (analytic {cfg.param_count()}); "
         f"losses {out['losses']}, grad norms {out['grad_norms']}, step s "
         f"{out['step_s']}, peak {out['peak_gib']:.2f} GiB; launches flash "
         f"{c['flash_attention']}, rglru {c['rglru_scan']} (want "
         f"{want['flash_attention']} and {want['rglru_scan']} a step), plain "
         f"calls {c['plain']}; profiled step: " + ", ".join(
             f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
             for k, v in out["profile"].items()))
    if (n_tree, cfg.param_count()) != (run["tree"], run["analytic"]):
        fail(f"train16 {name}: {n_tree} params in the tree, "
             f"{cfg.param_count()} analytic")
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        fail(f"train16 {name}: a loss or grad norm is not finite")
    others = {k: v for k, v in c.items() if v and k not in (
        "flash_attention", "rglru_scan") and (k != "plain" or on_card)}
    if (c["flash_attention"] != want["flash_attention"] * TRAIN16_STEPS
            or c["rglru_scan"] != want["rglru_scan"] * TRAIN16_STEPS
            or others):
        fail(f"train16 {name}: launches {c}, want {want} a step and "
             f"nothing else")
    del params, opt, batch, step, m, met
    _free(dev)
    return out


def _flash16_inputs(name: str, dtype, dev):
    """One full-width layer's attention inputs of part (a) or (b) (q, k,
    v, dO folded to (B*H, S, Dh), seeded normal draws) and its mask."""
    import torch
    cfg = _train16_cfg(name)
    run = TRAIN16[name]
    BH = run["B"] * cfg.n_heads
    Dh = cfg.resolved_head_dim
    S = run["S"]
    mode = "causal" if cfg.window >= S else "sliding"
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED + 16)
    draw = lambda: torch.randn((BH, S, Dh), generator=gen,
                               device=dev).to(dtype)
    return (draw(), draw(), draw(), draw(),
            dict(mode=mode, window=cfg.window if mode == "sliding" else 0))


def _flash16_check(name: str, dtype, dev) -> dict:
    """``FlashAttention``'s dq, dk and dv at one full-width layer of part
    (a) or (b) against autograd through ``flash_attention_plain`` on the
    inputs in f32, ``TRAIN16_REF_ROWS`` (batch, head) rows at a time: f32
    within ``ZOO_TOL``, bf16 inputs at the bf16 gate; the backward's
    device time."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do, kw = _flash16_inputs(name, dtype, dev)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.FlashAttention.apply(*leaves, kw["mode"], kw["window"], 0)
    got = torch.autograd.grad(out, leaves, do)
    del out, leaves
    res = {"shape": list(q.shape), "dtype": str(dtype).split(".")[-1],
           **kw}
    tol = ZOO_TOL["flash_attention"] if dtype == torch.float32 else \
        ZOO_TOL["bf16"]
    n = TRAIN16_REF_ROWS
    oks, errs, frobs = [], [0.0] * 3, [0.0] * 3
    for i in range(0, q.shape[0], n):
        ins = [t[i:i + n].float().requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention_plain(*ins, **kw)
        want = torch.autograd.grad(o, ins, do[i:i + n].float())
        for j, (g, w) in enumerate(zip(got, want)):
            ok, err, frob = _close(g[i:i + n], w, tol)
            oks.append(ok)
            errs[j] = max(errs[j], err)
            frobs[j] = max(frobs[j], frob)
        del ins, o, want
    res.update(ok=all(oks), max_abs_err=dict(zip("qkv", errs)),
               frob=dict(zip("qkv", frobs)))
    res["bwd_ms"] = _events_ms(lambda: fa.flash_backward(q, k, v, do, **kw),
                               reps=3)
    res["fwd_ms"] = _events_ms(lambda: fa.flash_attention(q, k, v, **kw),
                               reps=3)
    del q, k, v, do, got
    return res


def _rglru16_check(dev) -> dict:
    """The reverse scan against ``rglru_scan_plain`` on the same flipped
    inputs (bitwise), and ``RGLRUScan``'s da, db and dh0 against autograd
    through the plain version, at ``TRAIN16_RG_SHAPE``."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    B, S, W = TRAIN16_RG_SHAPE
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED + 17)
    a = torch.rand((B, S, W), generator=gen, device=dev)
    b = torch.randn((B, S, W), generator=gen, device=dev)
    h0 = torch.randn((B, W), generator=gen, device=dev)
    g = torch.randn((B, S, W), generator=gen, device=dev)
    shifted = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    zero = torch.zeros_like(h0)
    rev = rg.reverse_scan(a, g)
    want = rg.rglru_scan_plain(shifted.flip(1), g.flip(1), zero).flip(1)
    bitwise = bool(torch.equal(_bits(rev), _bits(want)))
    ins = [t.detach().requires_grad_() for t in (a, b, h0)]
    got = torch.autograd.grad(rg.RGLRUScan.apply(*ins), ins, g)
    ref = [t.detach().requires_grad_() for t in (a, b, h0)]
    want = torch.autograd.grad(rg.rglru_scan_plain(*ref), ref, g)
    rel = {n: float((x - y).abs().max() / y.abs().max())
           for n, x, y in zip(("da", "db", "dh0"), got, want)}
    return {"shape": [B, S, W], "reverse_bitwise": bitwise, "rel": rel,
            "ok": bitwise and max(rel.values()) <= TRAIN16_RG_TOL}


def _loss_and_grads(m, params, batch):
    """(loss as a float, [gradient leaves]) of ``m.loss``."""
    from repro_torch.ckpt.tree import tree_leaves
    loss, grads = _value_and_grad(m, params, batch)
    return float(loss), tree_leaves(grads)


def _train16_batch(cfg, B: int, S: int, seed: int) -> dict:
    """``SyntheticLM``'s first batch (tokens, labels, whisper's stub
    frames) on the host."""
    from repro_torch.data import synthetic
    return synthetic.for_arch(cfg, batch=B, seq_len=S, seed=seed,
                              device="cpu").peek(0)


def _scale_qk(tree, f: float):
    """``tree`` with every leaf named ``wq`` or ``wk`` times ``f``."""
    if isinstance(tree, dict):
        return {k: (v * f if k in ("wq", "wk") else _scale_qk(v, f))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_scale_qk(v, f) for v in tree)
    return tree


def _leaf_errs(got, want, zero_tol: float) -> tuple:
    """Relative Frobenius errors of ``got``'s gradient leaves against
    ``want``'s (on the host, f64), and the absolute ones, over the largest
    leaf's norm, of the leaves whose norm is within ``zero_tol`` of it."""
    import torch
    norms = [float(torch.linalg.vector_norm(w.double())) for w in want]
    top = max(norms)
    errs, zero = [], []
    for g, w, nrm in zip(got, want, norms):
        d = float(torch.linalg.vector_norm(g.double().cpu() - w.double()))
        if nrm <= zero_tol * top:
            zero.append(d / top)
        else:
            errs.append(d / nrm)
    return errs, zero


def _train16_vs_cpu(dev, tlog) -> dict:
    """Part (d): ``TRAIN16_VS_CPU``; the card's launches read around the
    card's runs alone; each f32 model's own sensitivity (the embedding
    table times 1 + 1e-7, on the CPU) printed beside its reading."""
    import torch
    from repro_torch.ckpt.tree import tree_map
    from repro_torch.models import build
    v = TRAIN16_VS_CPU
    cpu = torch.device("cpu")
    out, launches = {}, {}
    for name, cut in v["runs"].items():
        res = {}
        for cd in ("float32", "bfloat16"):
            cfg = _train16_reduced(name, cd, **cut)
            m = build(cfg)
            params = _scale_qk(m.init(
                torch.Generator().manual_seed(v["seed"]), device="cpu"),
                v["qk_scale"])
            batch = _train16_batch(cfg, v["B"], v["S"], v["seed"])
            on = lambda d: (tree_map(lambda x: x.to(d), params),
                            {k: x.to(d) for k, x in batch.items()})
            _reset_counts()
            l_card, g_card = _loss_and_grads(m, *on(dev))
            _dev_sync(dev)
            c = _counts()
            want = _train16_want(cfg, dev)
            if c["flash_attention"] != want["flash_attention"] or (
                    c["rglru_scan"] != want["rglru_scan"]) or (
                    dev.type == "cuda" and c["plain"]):
                fail(f"train16 vs CPU {name} {cd}: launches {c}, want "
                     f"{want}")
            for k in ("flash_attention", "rglru_scan"):
                launches[k] = launches.get(k, 0) + c[k]
            l_cpu, g_cpu = _loss_and_grads(m, *on(cpu))
            rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
            if cd == "bfloat16":
                res["bf16"] = {"card": l_card, "cpu": l_cpu,
                               "rel": rel_loss}
                ok = rel_loss <= TRAIN_CPU_TOL
            else:
                errs, zero = _leaf_errs(g_card, g_cpu, v["zero_leaf_tol"])
                moved = dict(params, embed=params["embed"] * (1 + 1e-7))
                sens = _leaf_errs(_loss_and_grads(m, moved, batch)[1],
                                  g_cpu, v["zero_leaf_tol"])[0]
                med = statistics.median(errs)
                res["f32"] = {"card": l_card, "cpu": l_cpu,
                              "loss_rel": rel_loss, "median_leaf": med,
                              "max_leaf": max(errs), "leaves": len(errs),
                              "zero_leaves": zero,
                              "sensitivity_median": statistics.median(sens),
                              "sensitivity_max": max(sens)}
                ok = (med <= v["f32_median_tol"]
                      and max(errs) <= v["f32_leaf_tol"]
                      and all(z <= v["zero_leaf_tol"] for z in zero))
            tlog(f"train16 vs CPU {name} ({cd}): " + ", ".join(
                f"{k} {x:.6g}" if isinstance(x, float) else f"{k} {x}"
                for k, x in res["bf16" if cd == "bfloat16" else "f32"]
                .items()) + f"; launches {c['flash_attention']} flash, "
                f"{c['rglru_scan']} RG-LRU")
            if not ok:
                fail(f"train16 vs CPU {name} {cd}: the card's loss or "
                     f"gradients differ from the CPU's")
            del m, params, batch, g_card, g_cpu
        out[name] = res
    _free(dev)
    out["launches"] = launches
    return out


def _train16_remat(dev, tlog) -> dict:
    """Part (e): ``remat_group`` 2 against 1 on ``TRAIN16_REMAT``'s config
    (4 super-blocks), f32, on the card: the loss and every gradient leaf,
    relative Frobenius; the launches of each, as designed."""
    import torch
    from repro_torch.ckpt.tree import tree_map
    from repro_torch.models import build
    r = TRAIN16_REMAT
    base = _train16_reduced(r["arch"], "float32", n_layers=r["n_layers"])
    params = tree_map(lambda x: x.to(dev), build(base).init(
        torch.Generator().manual_seed(0), device="cpu"))
    batch = {k: x.to(dev) for k, x in
             _train16_batch(base, r["B"], r["S"], 0).items()}
    runs = {}
    for g in (1, 2):
        cfg = dataclasses.replace(base, remat_group=g)
        _reset_counts()
        loss, grads = _loss_and_grads(build(cfg), params, batch)
        _dev_sync(dev)
        c = _counts()
        want = _train16_want(cfg, dev)
        if (c["flash_attention"], c["rglru_scan"]) != (
                want["flash_attention"], want["rglru_scan"]) or (
                dev.type == "cuda" and c["plain"]):
            fail(f"train16 remat_group {g}: launches {c}, want {want}")
        runs[g] = (loss, grads, c)
    (l1, g1, c1), (l2, g2, c2) = runs[1], runs[2]
    errs = [_frob(a, b) for a, b in zip(g2, g1)]
    res = {"loss": [l1, l2], "loss_rel": abs(l2 - l1) / abs(l1),
           "max_leaf": max(errs), "bitwise": all(
               torch.equal(a, b) for a, b in zip(g2, g1)),
           "launches": {g: {k: runs[g][2][k] for k in (
               "flash_attention", "rglru_scan")} for g in (1, 2)}}
    tlog(f"train16 remat: {base.n_layers} layers (4 super-blocks), "
         f"remat_group 2 vs 1: losses {l2!r} / {l1!r}, max leaf "
         f"{res['max_leaf']:.3e}, bitwise {res['bitwise']}, launches "
         f"{res['launches']} (gate {r['tol']:g})")
    if not (res["loss_rel"] <= r["tol"] and res["max_leaf"] <= r["tol"]):
        fail("train16: remat_group 2 disagrees with remat_group 1")
    del params, batch, runs, g1, g2
    _free(dev)
    return res


def _train16_cli(dev, tlog, smoke_keys=None) -> dict:
    """Part (c): ``launch.train.main`` in-process with ``TRAIN16_CLI`` on
    the card, then on the CPU; the train steps run counted (a wrapper of
    ``Model.make_train_step``'s step), the launches read around the
    card's run.  Gates: every step done; the report's keys equal on both
    devices (and to phase 13's smoke's, where it ran); wall and energy
    equal (scaled time); flash launched as designed for each train step
    run, no plain call on the card."""
    import contextlib
    import io
    import shutil
    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as ft_train
    root = ROOT / "build" / "chip_smoke_train16"
    shutil.rmtree(root, ignore_errors=True)
    real = models.Model.make_train_step
    calls = [0]

    def counted(self, *a, **kw):
        step = real(self, *a, **kw)

        def run(*args):
            calls[0] += 1
            return step(*args)
        return run
    reps, counts, steps, host_s = {}, None, {}, {}
    try:
        models.Model.make_train_step = counted
        for i, d in enumerate((str(dev), "cpu")):
            calls[0] = 0
            argv = TRAIN16_CLI + ["--device", d, "--ckpt-dir",
                                  str(root / f"{i}_{d}")]
            _reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                reps[d] = ft_train.main(argv)
            _dev_sync(dev)
            host_s[d] = time.perf_counter() - t0
            steps[d] = calls[0]
            counts = counts or _counts()
    finally:
        models.Model.make_train_step = real
        shutil.rmtree(root, ignore_errors=True)
    card, host = reps[str(dev)], reps["cpu"]
    args = ft_train.build_parser().parse_args(TRAIN16_CLI)
    cfg = reduced(get_config(args.arch), n_layers=args.layers,
                  d_model=args.d_model, n_heads=args.n_heads)
    want = _train16_want(cfg, dev)["flash_attention"] * steps[str(dev)]
    keys = sorted(card)
    res = {"host_s": host_s[str(dev)], "cpu_s": host_s["cpu"],
           "steps_run": steps, "final_step": card["final_step"],
           "n_failures": card["n_failures"], "wall_s": card["wall_s"],
           "energy_j": card["energy"]["E_total_j"], "launches": counts,
           "want_flash": want, "keys_equal": keys == sorted(host) and (
               smoke_keys is None or keys == smoke_keys)}
    tlog(f"train16 cli: {' '.join(TRAIN16_CLI)} on {dev} "
         f"{res['host_s']:.2f} s, on the CPU {res['cpu_s']:.2f} s; steps "
         f"{card['final_step']} ({steps} train steps run), failures "
         f"{card['n_failures']}, wall {card['wall_s']!r} s (CPU "
         f"{host['wall_s']!r}), energy {res['energy_j']!r} J; report keys "
         f"equal {res['keys_equal']}; launches flash "
         f"{counts['flash_attention']} (want {want}), plain {counts['plain']}")
    if card["final_step"] != args.steps or not res["keys_equal"] or (
            card["wall_s"] != host["wall_s"]
            or card["energy"] != host["energy"]):
        fail("train16 cli: the run did not end, or its report differs from "
             "the CPU's")
    if counts["flash_attention"] != want or (dev.type == "cuda"
                                             and counts["plain"]):
        fail(f"train16 cli: launches {counts}")
    return res


def phase_train16(dev, card: str, smoke_keys=None) -> dict:
    """Phase 16: training through attention and the RG-LRU (see the module
    docstring), every line with the card's name and power limit, each
    part's counts set to 0 just before it and read just after, every
    earlier model freed first."""
    import torch
    tlog = lambda msg: log(f"{msg} [{card}]")
    report, t_phase = {}, time.perf_counter()
    parts = [(name, lambda n=name: _train16_part(n, dev, tlog))
             for name in TRAIN16]
    parts += [("cli", lambda: _train16_cli(dev, tlog, smoke_keys)),
              ("vs_cpu", lambda: _train16_vs_cpu(dev, tlog)),
              ("remat", lambda: _train16_remat(dev, tlog))]
    for key, part in parts:
        t0 = time.perf_counter()
        report[key] = part()
        report[key]["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks = {}
    for name in TRAIN16:
        for dtype in (torch.float32, torch.bfloat16):
            r = _flash16_check(name, dtype, dev)
            checks[f"flash_{name}_{r['dtype']}"] = r
            tlog(f"train16 flash backward at {name}'s layer {r['shape']} "
                 f"{r['dtype']} {r['mode']}: dq/dk/dv max abs "
                 f"{r['max_abs_err']}, frob {r['frob']}; backward "
                 f"{r['bwd_ms']:.4f} ms, forward kernel {r['fwd_ms']:.4f} ms")
            if not r["ok"]:
                fail(f"train16: FlashAttention's gradients at {name}'s "
                     f"layer ({r['dtype']}) disagree with the plain version")
            _free(dev)
    checks["rglru"] = _rglru16_check(dev)
    tlog(f"train16 RG-LRU backward at {checks['rglru']['shape']}: reverse "
         f"scan bitwise {checks['rglru']['reverse_bitwise']}, RGLRUScan vs "
         f"autograd through the plain scan {checks['rglru']['rel']} (gate "
         f"{TRAIN16_RG_TOL:g})")
    if not checks["rglru"]["ok"]:
        fail("train16: the RG-LRU backward disagrees with its plain version")
    report["checks"] = checks
    report["checks"]["part_s"] = time.perf_counter() - t0
    _free(dev)
    report["phase_s"] = time.perf_counter() - t_phase
    report["launches"] = {k: sum(report[p]["launches"][k] for p in TRAIN16)
                          + report["vs_cpu"]["launches"][k]
                          + report["cli"]["launches"][k]
                          for k in ("flash_attention", "rglru_scan")}
    tlog(f"train16 phase {report['phase_s']:.1f} s (" + ", ".join(
        f"{k} {report[k]['part_s']:.1f}" for k in list(TRAIN16)
        + ["cli", "vs_cpu", "remat", "checks"]) + ")")
    return report


# ---------------------------------------------------------------------------
# 17. devices and meshes
# ---------------------------------------------------------------------------

#: the split's sweep mesh repeats the card this many times (a one-card
#: machine shows one device; every piece runs what a device of a real
#: split runs).
SPLIT_DEVICES = 2
#: part (c): xLSTM-125M at phase 12's cut (2 layers at full width), B 8,
#: S 256, k steps before the checkpoint and k after it.
ELASTIC = dict(arch="xlstm-125m", layers=2, B=8, S=256, k=2, seed=0)
#: its rehearsal on the CPU: reduced widths (one mLSTM head of 64).
ELASTIC_SMALL = dict(d_model=64, n_heads=1, B=2, S=32)


def _split_over(devices):
    """A context in which every grid call splits over ``devices`` (the
    sweep mesh and its size patched, as the tests do on the CPU)."""
    import contextlib
    from repro_torch.sim import dispatch

    @contextlib.contextmanager
    def patched():
        saved = dispatch.effective_devices, dispatch.sweep_mesh
        dispatch.effective_devices = \
            lambda config=None, device="cuda": len(devices)
        dispatch.sweep_mesh = lambda n: tuple(devices[:n])
        try:
            yield
        finally:
            dispatch.effective_devices, dispatch.sweep_mesh = saved
    return patched()


def _fields_equal(a, b) -> list:
    """The tensor fields of two results that differ bitwise (NaN equal to
    NaN at the same place)."""
    import torch
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not isinstance(x, torch.Tensor):
            continue
        same = x.shape == y.shape and (torch.equal(x, y) or (
            x.is_floating_point() and torch.equal(x.isnan(), y.isnan())
            and torch.equal(x[~x.isnan()], y[~y.isnan()])))
        if not same:
            bad.append(f.name)
    return bad


def _mesh_split(dev, tlog, rehearse: bool) -> dict:
    """Part (b): the grid split over ``SPLIT_DEVICES`` copies of ``dev``,
    bitwise against the unsplit calls, with the sampled kernel's launches
    counted a piece and both forms timed."""
    import numpy as np
    from repro_torch.core import Weibull
    from repro_torch.sim import (COMPENSATED_F32, F64, evaluate_grid,
                                 evaluate_multilevel_grid, mu_rho_grid,
                                 simulate_trajectories)
    from repro_torch.sim import engine as te
    n = SPLIT_DEVICES
    devices = (dev,) * n
    big_shape = (40, 25) if rehearse else SWEEP_SHAPE
    mc_shape, trials = ((8, 4), 64) if rehearse else (MC_SHAPE, N_TRIALS)
    ml_axes = tuple((a, b, 16) for a, b, _ in ML_SWEEP_AXES) if rehearse \
        else ML_SWEEP_AXES
    time_s = (lambda fn: _wall_s(fn, dev)) if rehearse else \
        (lambda fn: _host_s(fn, reps=3))
    out = {"devices": [str(d) for d in devices]}

    def hold(name, call, fields=None):
        want = call()
        with _split_over(devices):
            got = call()
        bad = _fields_equal(got, want)
        t_one = time_s(call)
        with _split_over(devices):
            t_split = time_s(call)
        out[name] = {"bitwise": not bad, "differ": bad, "s": t_one,
                     "split_s": t_split}
        tlog(f"mesh split {name}: split over {n} x {dev} bitwise the "
             f"unsplit call: {not bad} (fields differing: {bad}); host "
             f"clock unsplit {t_one:.4f} s, split {t_split:.4f} s")
        if bad:
            fail(f"mesh split: {name} split over {n} devices differs from "
                 f"the unsplit call in {bad}")
        return want

    # the MC cell with in-kernel draws: one process, one policy
    mc_grid = mu_rho_grid(np.geomspace(120, 1200, mc_shape[0]),
                          np.linspace(2, 10, mc_shape[1]), device=dev)
    model = evaluate_grid(mc_grid, T_base=T_BASE, precision=F64, device=dev)
    proc = Weibull(shape=0.7)
    mc = lambda: simulate_trajectories(
        model.T_energy, mc_grid, T_base=T_BASE, n_trials=trials, seed=7,
        process=proc, precision=F64, device=dev)
    flat, T_arr, Tb_arr = te._flat_inputs(model.T_energy, mc_grid, T_BASE,
                                          dev)
    buckets = [len(idx) for _, _, idx in te._buckets(T_arr, flat, Tb_arr,
                                                      proc, None)]
    counts = {}
    for form, ctx in (("unsplit", ()), ("split", devices)):
        _reset_counts()
        if ctx:
            with _split_over(ctx):
                mc()
        else:
            mc()
        _dev_sync(dev)
        counts[form] = _counts()["event_sweep_sampled"]
    want = {"unsplit": len(buckets),
            "split": sum(min(n, b) for b in buckets)}
    tlog(f"mesh split mc-{mc_grid.size}x{trials} (Weibull(0.7), f64, "
         f"in-kernel draws): {len(buckets)} capacity buckets of "
         f"{buckets} points; sampled-kernel launches unsplit "
         f"{counts['unsplit']} (want {want['unsplit']}), split "
         f"{counts['split']} (want {want['split']}: one a device piece)"
         + ("; on the CPU the two-step path runs, no launch" if rehearse
            else ""))
    if not rehearse and counts != want:
        fail(f"mesh split: sampled-kernel launches {counts}, want {want}")
    hold("mc", mc)
    out["mc"].update(launches=counts, want=want, buckets=buckets)

    big = mu_rho_grid(np.linspace(30, 600, big_shape[0]),
                      np.linspace(1, 10, big_shape[1]), device=dev)
    for pol in (F64, COMPENSATED_F32):
        hold(f"sweep_{pol.name}", lambda: evaluate_grid(
            big, precision=pol, device=dev))
    del big
    ml = _geom_grid(ml_axes, ML_SWEEP_MU, dev)
    for pol in (F64, COMPENSATED_F32):
        hold(f"ml_sweep_{pol.name}", lambda: evaluate_multilevel_grid(
            ml, m_values=ML_M_VALUES, precision=pol, device=dev))
    out["sizes"] = {"mc": [mc_grid.size, trials], "sweep": big_shape[0]
                    * big_shape[1], "ml_sweep": ml.size}
    _free(dev)
    return out


def _elastic_cfg(rehearse: bool):
    from repro_torch.configs import get_config, reduced
    E = ELASTIC
    cfg = get_config(E["arch"])
    if rehearse:
        return reduced(cfg, n_layers=E["layers"],
                       d_model=ELASTIC_SMALL["d_model"],
                       n_heads=ELASTIC_SMALL["n_heads"])
    return dataclasses.replace(cfg, n_layers=E["layers"])


def run_elastic(dev, root: Path, rehearse: bool = False) -> dict:
    """Part (c): train k steps on a one-rank mesh, checkpoint (raw and
    int8-compressed), ``plan_reshard(mesh, 0)``, ``build_mesh``, restore,
    ``reshard_tree`` and train k more steps; against the run that never
    stopped (raw) and the run that never stopped but whose state at step k
    went through the checkpoint's int8 round trip in memory (compressed).
    A world-1 process group on a ``HashStore`` (NCCL on the card, gloo on
    the CPU) is made for it and destroyed after it."""
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import ShardedStore, StoreConfig
    from repro_torch.ckpt.tree import tree_flatten, tree_map, tree_unflatten
    from repro_torch.data import synthetic
    from repro_torch.ft import build_mesh, plan_reshard, reshard_tree
    from repro_torch.kernels import ops
    from repro_torch.launch import make_test_mesh
    from repro_torch.models import build
    from repro_torch.optim import adamw
    E = ELASTIC
    k = E["k"]
    B, S = ((ELASTIC_SMALL["B"], ELASTIC_SMALL["S"]) if rehearse
            else (E["B"], E["S"]))
    cfg = _elastic_cfg(rehearse)
    model = build(cfg)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    pspec = model.param_spec()
    spec = (pspec, adamw.state_spec(pspec, ocfg))
    data = synthetic.for_arch(cfg, batch=B, seq_len=S, seed=E["seed"],
                              device=dev)
    step = model.make_train_step(ocfg)
    out = {"cfg": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "B": B, "S": S, "k": k,
           "mlstm_per_step": _mlstm_per_step(cfg)}

    def train(state, first: int, n_steps: int):
        losses = []
        for i in range(first, first + n_steps):
            p, o, m = step(*state, data.peek(i))
            state = (p, o)
            losses.append(m["loss"])
        return state, torch.stack(losses)

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        t0 = time.perf_counter()
        mesh = make_test_mesh(1, device=dev.type)
        params = model.init(torch.Generator(device=dev).manual_seed(
            E["seed"]), device=dev)
        state0 = (params, adamw.init_state(params, ocfg, device=dev))
        _reset_counts()
        mid, loss_a = train(state0, 0, k)
        stores = {name: ShardedStore(StoreConfig(
            root=str(root / name), compress=name == "compressed",
            device=dev)) for name in ("raw", "compressed")}
        for st in stores.values():
            st.save(k, mid)
        # the compressed checkpoint's round trip, in memory: the store's
        # rule (f32 leaves of >= 4096 elements), one launch each way
        leaves, td = tree_flatten(mid)
        comp = [i for i, x in enumerate(leaves)
                if x.dtype == torch.float32 and x.numel() >= 4096]
        q_arena, s_arena, views = ops.quantize_arrays([leaves[i]
                                                       for i in comp])
        deq = ops.dequantize_arrays(
            [q for q, _, _ in views], [s for _, s, _ in views],
            shapes=[tuple(leaves[i].shape) for i in comp],
            dtypes=[torch.float32] * len(comp),
            pads=[pad for _, _, pad in views])
        rt = dict(zip(comp, deq))
        rt = [rt[i] if i in rt else x.clone() for i, x in enumerate(leaves)]
        rt_state = tree_unflatten(td, rt)
        del q_arena, s_arena, views, deq, rt
        u_state, loss_u = train(mid, k, k)
        q_state, loss_q = train(rt_state, k, k)
        out["setup_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        plan = plan_reshard(mesh, 0)
        new_mesh = build_mesh(plan, device=dev.type)
        out["plan"] = {"old": plan.old_shape, "new": plan.new_shape,
                       "note": plan.note}
        runs = {}
        for name, st in stores.items():
            restored, at = st.restore(mid)
            dt = reshard_tree(restored, spec, new_mesh)
            local = tree_map(lambda x: x.to_local(), dt)
            out[f"{name}_placements"] = sorted({str(tuple(x.placements))
                                                for x in tree_flatten(dt)[0]})
            del restored, dt
            runs[name] = (at, train(local, k, k))
        _dev_sync(dev)
        out["elastic_s"] = time.perf_counter() - t0
        out["launches"] = _counts()
    finally:
        dist.destroy_process_group()

    def same(a, b) -> tuple:
        la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
        differ = [i for i, (x, y) in enumerate(zip(la, lb))
                  if not torch.equal(x, y)]
        return not differ and len(la) == len(lb), differ
    (at_r, (r_state, loss_r)), (at_c, (c_state, loss_c)) = \
        runs["raw"], runs["compressed"]
    out["restored_at"] = [at_r, at_c]
    out["raw_equal"], out["raw_differ"] = same(r_state, u_state)
    out["raw_losses_equal"] = torch.equal(loss_r, loss_u)
    out["compressed_equal"], out["compressed_differ"] = same(c_state,
                                                             q_state)
    out["compressed_losses_equal"] = torch.equal(loss_c, loss_q)
    out["losses"] = {"before": loss_a.tolist(), "uninterrupted":
                     loss_u.tolist(), "raw": loss_r.tolist(),
                     "compressed": loss_c.tolist(),
                     "round_trip": loss_q.tolist()}
    pairs = list(zip(tree_flatten(c_state[0])[0],
                     tree_flatten(u_state[0])[0]))
    num = sum(float((x.double() - y.double()).square().sum())
              for x, y in pairs)
    den = sum(float(y.double().square().sum()) for _, y in pairs)
    out["compressed_vs_uninterrupted_params_frob"] = math.sqrt(num / den)
    out["n_compressed_leaves"] = len(comp)
    out["leaves"] = len(leaves)
    return out


def _mesh_elastic(dev, root: Path, tlog, rehearse: bool) -> dict:
    """Part (c) with its gates."""
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    try:
        out = run_elastic(dev, root, rehearse)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    c = out["launches"]
    k = out["k"]
    want = {"mlstm_scan": 5 * k * out["mlstm_per_step"],
            "quantize_leaves": 2, "dequantize_leaves": 2}
    tlog(f"mesh elastic: {out['cfg']} at {out['layers']} layers, d "
         f"{out['d_model']}, B {out['B']}, S {out['S']}, {k} steps, "
         f"checkpoint, plan {out['plan']}, build_mesh, restore (at steps "
         f"{out['restored_at']}), reshard_tree (placements "
         f"{out['raw_placements']}), {k} more steps: raw checkpoint vs the "
         f"uninterrupted run bitwise: params and AdamW state "
         f"{out['raw_equal']}, losses {out['raw_losses_equal']}; int8 "
         f"checkpoint ({out['n_compressed_leaves']} of {out['leaves']} "
         f"leaves) vs the uninterrupted run through the same round trip "
         f"bitwise: state {out['compressed_equal']}, losses "
         f"{out['compressed_losses_equal']}; vs the uninterrupted run: "
         f"params {out['compressed_vs_uninterrupted_params_frob']:.3e} "
         f"relative Frobenius apart (the int8 checkpoint's error, carried "
         f"{k} steps); setup {out['setup_s']:.2f} s, elastic "
         f"{out['elastic_s']:.2f} s; launches mlstm_scan "
         f"{c['mlstm_scan']}, quantize {c['quantize_leaves']}, dequantize "
         f"{c['dequantize_leaves']} (want {want}), plain calls "
         f"{c['plain']}")
    if out["restored_at"] != [k, k]:
        fail(f"mesh elastic: restored at steps {out['restored_at']}")
    if out["plan"]["new"] != {"data": 1, "model": 1}:
        fail(f"mesh elastic: plan {out['plan']}")
    if not (out["raw_equal"] and out["raw_losses_equal"]):
        fail(f"mesh elastic: the raw restore-and-continue differs from the "
             f"uninterrupted run (leaves {out['raw_differ']})")
    if not (out["compressed_equal"] and out["compressed_losses_equal"]):
        fail(f"mesh elastic: the int8 restore-and-continue differs from "
             f"the run through its round trip (leaves "
             f"{out['compressed_differ']})")
    if dev.type == "cuda" and ({n: c[n] for n in want} != want
                               or c["plain"]):
        fail(f"mesh elastic: launches {c}, want {want} and no plain call")
    return out


def phase_mesh(dev, card: str, rehearse: bool = False,
               root: Path = ROOT / "build" / "chip_smoke_elastic") -> dict:
    """Phase 17: devices and meshes (see the module docstring), every line
    with the card's name and power limit; ``rehearse`` runs it on the CPU
    at reduced sizes (part (c) on a gloo group), its store in ``root``."""
    import torch
    from repro_torch.launch import H100
    from repro_torch.sim import dispatch
    tlog = lambda msg: log(f"{msg} [{card}]")
    report, t_phase = {}, time.perf_counter()
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        facts = {"device_count": torch.cuda.device_count(),
                 "effective_devices": dispatch.effective_devices(),
                 "effective_devices_shard_off": dispatch.effective_devices(
                     dispatch.DispatchConfig(shard=False)),
                 "total_memory": total, "H100": dict(H100)}
        tlog(f"mesh facts: torch.cuda.device_count() "
             f"{facts['device_count']}, effective_devices() "
             f"{facts['effective_devices']} (shard=False: "
             f"{facts['effective_devices_shard_off']}), total_memory "
             f"{total} B against H100['hbm_bytes'] {H100['hbm_bytes']} B "
             f"({H100['name']}, {H100['power_limit_w']} W)")
        if total != H100["hbm_bytes"]:
            fail(f"mesh: the card's total_memory {total} is not "
                 f"H100['hbm_bytes'] {H100['hbm_bytes']}")
        if facts["effective_devices"] != facts["device_count"]:
            fail(f"mesh: effective_devices() {facts['effective_devices']} "
                 f"against {facts['device_count']} CUDA devices")
        report["facts"] = facts
    parts = (("split", lambda: _mesh_split(dev, tlog, rehearse)),
             ("elastic", lambda: _mesh_elastic(dev, root, tlog,
                                               rehearse)))
    for key, part in parts:
        t0 = time.perf_counter()
        report[key] = part()
        report[key]["part_s"] = time.perf_counter() - t0
    report["phase_s"] = time.perf_counter() - t_phase
    report["launches"] = {
        "event_sweep_sampled": report["split"]["mc"]["launches"]["unsplit"]
        + report["split"]["mc"]["launches"]["split"],
        **{n: report["elastic"]["launches"][n] for n in (
            "mlstm_scan", "quantize_leaves", "dequantize_leaves")}}
    tlog(f"mesh phase {report['phase_s']:.1f} s (split "
         f"{report['split']['part_s']:.1f}, elastic "
         f"{report['elastic']['part_s']:.1f})")
    return report


# ---------------------------------------------------------------------------
# 18. the tooling: roofline, sanitize, the dry run's estimate, bench_sweep
# ---------------------------------------------------------------------------

#: part (c)'s reduced dry-run cell: starcoder2-3b at its production
#: numerics (``launch.dryrun.cell_config``: bf16 params, heads padded to
#: 32, remat), cut to 2 layers, a train step of B 2 x 2048 on a one-rank
#: mesh, params from seed 0.
TOOL_CELL = dict(arch="starcoder2-3b", layers=2, B=2, S=2048, seed=0)
#: the band of the card's measured peak over the dry run's
#: ``peak_bytes_est``.  The estimate counts every storage the meta trace
#: makes at its exact bytes and frees it with its last tensor, as the
#: caching allocator's ``max_memory_allocated`` does; the card adds what
#: the trace cannot see (allocations rounded up to 512 B, cuBLAS's
#: workspace, the kernels' aligned copies) and nothing it leaves out
#: should be larger than a fifth of the step.
TOOL_PEAK_BAND = (0.8, 1.25)


def _tool_roofline(dev, tlog, draw_ops) -> list:
    """(a): roofline section 2 on ``dev``; on the card each kernel row's
    time must not beat its bound."""
    from repro_torch.benchmarks import roofline
    from repro_torch.kernels import cost
    info, hpeaks = roofline.host_peaks(dev)
    dev_peaks = (cost.PEAKS[cost.variant(info.device_kind)]
                 if dev.type == "cuda" else cost.PEAKS["SXM"])
    rows = roofline.analyze_sweep_programs(
        hpeaks, dev, dev_peaks, draw_ops=(draw_ops or {}).get(0))
    for r in rows:
        ms = "not timed" if r["ms"] is None else f"{r['ms']:.4f} ms"
        tlog(f"tooling (a) roofline {r['program']} [{r['shape']}]: "
             f"{r['kernel_calls']} kernel calls, {r['dot_flops']:.4g} dot "
             f"FLOPs, {r['hbm_bytes']:.4g} B, bound {r['bound_ms']:.6f} ms "
             f"({r['bound_by']}), {ms}")
        if r["ms"] is not None and r["bound_by"] != "model" \
                and r["ms"] < r["bound_ms"]:
            fail(f"tooling: {r['program']} ran in {r['ms']} ms, under its "
                 f"bound {r['bound_ms']} ms: the kernel's model is wrong")
    return rows


def _tool_sanitize(dev, tlog) -> dict:
    """(b): the four canonical workloads' counts within their committed
    budgets, and the leak check; on the card also the CUDA kernels and the
    syncs of the sync debug mode."""
    from repro_torch import sanitize
    budgets = sanitize.load_budgets()
    if not budgets:
        fail(f"tooling: no budgets in {sanitize.BUDGET_PATH}")
    out = {}
    for name, fn in sanitize.CANONICAL_WORKLOADS.items():
        counts = sanitize.measure_workload(fn, dev)
        try:
            sanitize.launch_gate(name, counts, budgets)
        except sanitize.LaunchBudgetError as e:
            fail(f"tooling: {e}")
        committed = {k: budgets[name][k]["measured"] for k in counts}
        card = sanitize.card_report(fn, dev) if dev.type == "cuda" else {}
        try:
            sanitize.run_leak_checked(fn, dev)
        except sanitize.LeakError as e:
            fail(f"tooling: {name}: {e}")
        out[name] = {"counts": counts, "committed": committed,
                     "equal_to_committed": counts == committed, **card}
        tlog(f"tooling (b) sanitize {name}: " + ", ".join(
            f"{k} {v} (budget {budgets[name][k]['budget']}, committed "
            f"{committed[k]})" for k, v in counts.items())
            + "".join(f", {k} {v}" for k, v in card.items())
            + ", no leak")
    return out


def _tool_dryrun(dev, tlog) -> dict:
    """(c): the dry run of the reduced cell (``TOOL_CELL``) on a one-rank
    mesh of a ``fake`` group (the tensor-parallel step traced on meta
    DTensors), then the same DTensor step for real on a world-1 group
    (NCCL on the card) from the seed; on the card the measured peak must
    lie within ``TOOL_PEAK_BAND`` of the estimate."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, make_test_mesh
    from repro_torch.models import batch_spec, build
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    c = TOOL_CELL
    shape = ShapeConfig("train_2k", "train", c["S"], c["B"])
    if dist.is_initialized():
        fail("tooling: a process group is already initialised")
    dryrun.init_fake_group(1)
    try:
        mesh = make_test_mesh(1, device=dev.type)
        rec = dryrun.run_cell(c["arch"], shape.name, shape=shape,
                              n_layers=c["layers"], mesh=mesh, save=False,
                              device=dev.type)
    finally:
        dist.destroy_process_group()
    mem = rec["memory"]
    out = {"record": {k: rec[k] for k in ("mesh", "n_chips",
                                           "flops_per_device", "fits_hbm",
                                           "timings_s")},
           "memory": mem, "band": TOOL_PEAK_BAND}
    tlog(f"tooling (c) dry run {c['arch']} {c['layers']} layers, train "
         f"B {c['B']} x {c['S']} on {rec['mesh']}, traced on meta DTensors: "
         f"arguments {mem['argument_bytes']} B sharded, outputs "
         f"{mem['output_bytes']} B, temps {mem['temp_bytes']} B, peak "
         f"estimate {mem['peak_bytes_est']} B, "
         f"{rec['flops_per_device']:.4g} FLOPs, trace "
         f"{rec['timings_s']['trace']} s")
    if dev.type != "cuda":
        return out
    cfg = dataclasses.replace(dryrun.cell_config(c["arch"], shape),
                              n_layers=c["layers"])
    model = build(cfg)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(1, device=dev.type)
        gen = torch.Generator(device=dev)
        gen.manual_seed(c["seed"])
        opt_cfg = dryrun.opt_config(cfg)
        # what earlier phases left allocated is no part of the step
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        params = shd.place_tree(model.init(gen, device=dev),
                                model.param_spec(), mesh)
        opt = adamw.init_state(params, opt_cfg, device=dev)
        batch = shd.place_tree(
            {k: torch.randint(0, cfg.vocab_size, (c["B"], c["S"]),
                              generator=gen, device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}, batch_spec(cfg, shape), mesh)
        step = dryrun.train_step(cfg, dryrun.microbatches(cfg, shape, mesh))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) - base
        with shd.use_mesh(mesh):
            new_p, new_o, metrics = step(params, opt, batch)
        loss = float(shd.local(metrics["loss"]))
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        del new_p, new_o, metrics, params, opt, batch
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    ratio = peak / mem["peak_bytes_est"]
    out.update(measured_peak_bytes=peak, held_before_bytes=held,
               earlier_phases_bytes=base, ratio=ratio, loss=loss)
    tlog(f"tooling (c) the DTensor step on the card: loss {loss:.4f}, "
         f"arguments held {held} B (estimated {mem['argument_bytes']} B "
         f"sharded), max_memory_allocated {peak} B above the {base} B "
         f"earlier phases left, {ratio:.4f} of the estimate (band "
         f"{TOOL_PEAK_BAND})")
    if not math.isfinite(loss):
        fail(f"tooling: the reduced cell's loss is {loss}")
    if not TOOL_PEAK_BAND[0] <= ratio <= TOOL_PEAK_BAND[1]:
        fail(f"tooling: the measured peak is {ratio:.4f} of the dry run's "
             f"estimate, outside {TOOL_PEAK_BAND}")
    return out


def phase_tooling(dev, card: str, draw_ops=None) -> dict:
    """Phase 18: the tooling against the kernels and steps it models (see
    the module docstring), every line with the card's name and power
    limit; on the CPU (``dev`` cpu) it rehearses: no times, no measured
    peak."""
    from repro_torch.benchmarks import bench_sweep
    tlog = lambda msg: log(f"{msg} [{card}]")
    report, t_phase = {}, time.perf_counter()
    _reset_counts()
    for key, part in (("roofline", lambda: _tool_roofline(dev, tlog,
                                                          draw_ops)),
                      ("sanitize", lambda: _tool_sanitize(dev, tlog)),
                      ("dryrun", lambda: _tool_dryrun(dev, tlog)),
                      ("bench_sweep", lambda: bench_sweep.run(dev,
                                                              quick=True))):
        t0 = time.perf_counter()
        report[key] = part()
        report.setdefault("part_s", {})[key] = time.perf_counter() - t0
    _dev_sync(dev)
    report["launches"] = c = _counts()
    b = report["bench_sweep"]
    tlog("tooling (d) bench_sweep --quick: " + ", ".join(
        f"{k} {v['speedup_warm']:.2f}x ({b['entry_s'].get(k, 0.0):.1f} s)"
        for k, v in b.items()
        if isinstance(v, dict) and "speedup_warm" in v))
    report["phase_s"] = time.perf_counter() - t_phase
    tlog(f"tooling phase {report['phase_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in report["part_s"].items())
        + f"); launches event_sweep {c['event_sweep']}, event_sweep_sampled "
        f"{c['event_sweep_sampled']}, flash_attention "
        f"{c['flash_attention']}, plain-version calls {c['plain']}")
    if dev.type == "cuda" and not (c["event_sweep_sampled"]
                                   and c["event_sweep"]
                                   and c["flash_attention"]):
        fail(f"tooling: the phase did not launch the event kernels and "
             f"flash attention: {c}")
    return report


# ---------------------------------------------------------------------------
# 19. the train step sharded on a world-1 NCCL mesh
# ---------------------------------------------------------------------------

#: phase 19's runs at full width: starcoder2-3b (d 3072, 24 heads of 128
#: over 2, d_ff 12288, window 4096, vocab 49,152) cut to 2 of 30 layers,
#: B 4 x S 4096; recurrentgemma-9b cut to one super-block (rglru, rglru,
#: sliding) with its vocab cut to 4096 (phase 14 (c)'s cut), B 1 x S 4096;
#: bf16 compute, ``remat="full"``, AdamW (``TRAIN_OPT``), ``SHARD_STEPS``
#: steps.  The CPU rehearsal takes the same archs at phase 16 (d)'s reduced
#: widths (d 128, 2 heads of 64) and ``SHARD_SMALL``'s batch.
SHARD = {"starcoder2-3b": dict(cut=dict(n_layers=2), B=4, S=4096),
         "recurrentgemma-9b": dict(cut=dict(n_layers=3, vocab_size=4096),
                                   B=1, S=4096)}
SHARD_STEPS = 2
SHARD_SMALL = dict(B=2, S=64)
#: the reference test's bounds (``tests/test_sharded_execution.py``): the
#: loss relative, every parameter leaf max-abs.
SHARD_LOSS_RTOL, SHARD_LEAF_ATOL = 2e-2, 5e-2


#: part (c): a prefill of ``S`` (``SHARD``'s) tokens, then
#: ``SHARD_DECODE_STEPS`` decode steps fed seeded tokens.
SHARD_DECODE_STEPS = 8
#: part (d): the decode kernel with its log-sum-exp on M slot slices of a
#: cache, merged: zoo-rg9b's decode (phase 8's ``DECODE``; length 1000
#: leaves the last slices empty), internvl2-1b's Dh 64 decode and a Dh 128
#: cache (starcoder2-3b's 24 heads x B 4 over 4096 slots) in f32 and bf16.
SHARD_MERGE = {"zoo-rg9b": dict(BH=2048, S=2048, Dh=256, dtype="bfloat16",
                                lengths=(2048, 1000)),
               "internvl2-1b": dict(BH=224, S=2080, Dh=64, dtype="bfloat16",
                                    lengths=(2080, 1000)),
               "dh128 f32": dict(BH=96, S=4096, Dh=128, dtype="float32",
                                 lengths=(4096, 1537)),
               "dh128 bf16": dict(BH=96, S=4096, Dh=128, dtype="bfloat16",
                                  lengths=(4096, 1537))}
SHARD_MERGE_SMALL = dict(BH=4, S=64, Dh=64, lengths=(64, 21))
SHARD_SLICES = (2, 4, 8)
#: the kernel's log-sum-exp against the plain version's, relative.
SHARD_LSE_RTOL = 1e-5
#: phase 8's decode row (``DECODE``, both lengths) as PERF.md's kernel
#: table last read it before the log-sum-exp output existed, in ms: the
#: kernel with and without its log-sum-exp is read against it.
SHARD_DECODE_ROW_MS = 2.0426


def _shard_cfg(name: str, rehearse: bool):
    if name == ELASTIC["arch"]:      # part (e): ELASTIC's cut
        return _elastic_cfg(rehearse)
    cut = SHARD[name]["cut"]
    if rehearse:
        return _train16_reduced(name, "bfloat16", **cut)
    return _train16_cfg(name, **cut)


def _shard_shape(name: str, rehearse: bool) -> tuple:
    if name == ELASTIC["arch"]:
        E = ELASTIC_SMALL if rehearse else ELASTIC
        return E["B"], E["S"]
    if rehearse:
        return SHARD_SMALL["B"], SHARD_SMALL["S"]
    return SHARD[name]["B"], SHARD[name]["S"]


def _shard_want(cfg, dev) -> dict:
    """Launches of one train step: flash and the RG-LRU as phase 16
    counts them, the mLSTM a forward per mLSTM layer (and its recompute
    under ``remat="full"``); none on the CPU."""
    want = dict(_train16_launches(cfg), mlstm_scan=_mlstm_per_step(cfg))
    return want if dev.type == "cuda" else {k: 0 for k in want}


def _shard_run(name: str, dev, mesh, rehearse: bool) -> dict:
    """``SHARD_STEPS`` train steps from the seeded params and batch: on
    DTensors placed on ``mesh`` under ``use_mesh`` (``mesh`` given), or on
    plain tensors.  The final params come back on the host; everything
    else is freed before returning."""
    import contextlib
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.data import synthetic
    from repro_torch.models import build
    from repro_torch.models.spec import ParamSpec
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    cfg = _shard_cfg(name, rehearse)
    B, S = _shard_shape(name, rehearse)
    model = build(cfg)
    on_card = dev.type == "cuda"
    _free(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(
        TRAIN["seed"]), device=dev)
    batch = synthetic.for_arch(cfg, batch=B, seq_len=S, seed=TRAIN["seed"],
                               device=dev).peek(0)
    ocfg = adamw.AdamWConfig(**TRAIN_OPT)
    step = model.make_train_step(ocfg)
    out = {"sharded": mesh is not None, "losses": [], "grad_norms": [],
           "step_s": []}
    with (shd.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        if mesh is not None:
            params = shd.place_tree(params, model.param_spec(), mesh)
            batch = shd.place_tree(batch, {
                k: ParamSpec(tuple(v.shape), ("batch", "seq"), "int32")
                for k, v in batch.items()}, mesh)
        opt = adamw.init_state(params, ocfg, device=dev)
        _dev_sync(dev)
        out["setup_s"] = time.perf_counter() - t0
        _reset_counts()
        for _ in range(SHARD_STEPS):
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            out["losses"].append(float(met["loss"]))
            out["grad_norms"].append(float(met["grad_norm"]))
            _dev_sync(dev)
            out["step_s"].append(time.perf_counter() - t0)
        out["launches"] = _counts()
        leaves = tree_leaves(params)
        out["dtensors"] = sum(isinstance(x, DTensor) for x in leaves)
        out["params"] = [(x.full_tensor() if mesh is not None else x)
                         .detach().to("cpu") for x in leaves]
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if on_card else float("nan"))
    out["cfg"] = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                  "n_heads": cfg.n_heads, "vocab": cfg.vocab_size, "B": B,
                  "S": S}
    out["want_per_step"] = _shard_want(cfg, dev)
    del params, opt, batch, step, model, met, leaves
    _free(dev)
    return out


def _shard_part(name: str, dev, mesh, tlog, rehearse: bool) -> dict:
    """One arch: the DTensor run, then the plain run, held together."""
    runs = {"dtensor": _shard_run(name, dev, mesh, rehearse),
            "plain": _shard_run(name, dev, None, rehearse)}
    d, p = runs["dtensor"], runs["plain"]
    leaf_diff = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(d.pop("params"), p.pop("params"))]
    bitwise = all(x == 0.0 for x in leaf_diff) and d["losses"] == p["losses"]
    loss_rel = [abs(a / b - 1.0) for a, b in zip(d["losses"], p["losses"])]
    out = {"runs": runs, "leaf_max_abs": leaf_diff, "loss_rel": loss_rel,
           "bitwise": bitwise}
    kernels = tuple(runs["plain"]["want_per_step"])
    for key, r in runs.items():
        tlog(f"shard {name} {key}: {r['cfg']}, {SHARD_STEPS} steps, losses "
             f"{r['losses']}, grad norms {r['grad_norms']}, step s "
             f"{r['step_s']}, setup {r['setup_s']:.2f} s, peak "
             f"{r['peak_gib']:.2f} GiB, DTensor leaves {r['dtensors']}; "
             f"launches " + ", ".join(f"{k} {r['launches'][k]}"
                                      for k in kernels)
             + f" (want {r['want_per_step']} a step), plain calls "
             f"{r['launches']['plain']}")
    tlog(f"shard {name}: DTensor vs plain: bitwise {bitwise}; loss rel "
         f"{loss_rel}; every leaf's max |diff| {leaf_diff}")
    if not leaf_diff:
        fail(f"shard {name}: no parameter leaves compared")
    if max(loss_rel) > SHARD_LOSS_RTOL or not max(leaf_diff) \
            < SHARD_LEAF_ATOL:
        fail(f"shard {name}: the DTensor step left the plain one: loss rel "
             f"{loss_rel}, leaf max-abs {max(leaf_diff)}")
    if not all(math.isfinite(x) for r in runs.values()
               for x in r["losses"] + r["grad_norms"]):
        fail(f"shard {name}: a loss or grad norm is not finite")
    if d["dtensors"] != len(leaf_diff) or p["dtensors"]:
        fail(f"shard {name}: the DTensor run kept {d['dtensors']} of "
             f"{len(leaf_diff)} leaves as DTensors, the plain run "
             f"{p['dtensors']}")
    for key, r in runs.items():
        c, want = r["launches"], r["want_per_step"]
        others = {k: v for k, v in c.items() if v and k not in kernels
                  and (k != "plain" or dev.type == "cuda")}
        if any(c[k] != want[k] * SHARD_STEPS for k in kernels) or others:
            fail(f"shard {name} {key}: launches {c}, want {want} a step "
                 f"and nothing else")
    return out


def _shard_decode_run(name: str, dev, mesh, rehearse: bool) -> dict:
    """Part (c), one run: prefill ``S`` seeded tokens, then
    ``SHARD_DECODE_STEPS`` decode steps fed seeded tokens, on DTensors
    placed on ``mesh`` (given) or on plain tensors, its counts set to 0
    just before and read just after.  Each step's logits and the final
    cache's leaves come back on the host."""
    import contextlib
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.models import build
    from repro_torch.models.spec import ParamSpec
    from repro_torch.parallel import sharding as shd
    cfg = _shard_cfg(name, rehearse)
    B, S = _shard_shape(name, rehearse)
    steps = SHARD_DECODE_STEPS
    model = build(cfg)
    _free(dev)
    gen = torch.Generator(device=dev).manual_seed(TRAIN["seed"])
    params = model.init(gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                         device=dev, dtype=torch.int32)
    prompt = {"tokens": toks[:, :S]}
    place = lambda t: t
    host = lambda x: (x.full_tensor() if isinstance(x, DTensor) else x) \
        .detach().to("cpu")
    out = {"logits": []}
    with (shd.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()), torch.no_grad():
        if mesh is not None:
            params = shd.place_tree(params, model.param_spec(), mesh)
            prompt = shd.place_tree(prompt, {"tokens": ParamSpec(
                (B, S), ("batch", "seq"), "int32")}, mesh)
            place = lambda t: shd.place_tree(
                t, ParamSpec((B, 1), ("batch", None), "int32"), mesh)
        _dev_sync(dev)
        _reset_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, max_cache_seq=S + steps)
        out["logits"].append(host(logits))
        out["prefill_s"] = time.perf_counter() - t0
        out["step_ms"] = []
        for i in range(S, S + steps):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache,
                                              place(toks[:, i:i + 1]))
            _dev_sync(dev)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["logits"].append(host(logits))
        out["launches"] = _counts()
        leaves = tree_leaves(cache["layers"])
        out["dtensors"] = sum(isinstance(x, DTensor) for x in leaves)
        out["cache"] = [host(x) for x in leaves]
    want = _serve_expected(cfg, types.SimpleNamespace(
        waves=1, batch=B, new_tokens=steps + 1))
    out["want"] = want if dev.type == "cuda" else {k: 0 for k in want}
    out["cfg"] = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                  "vocab": cfg.vocab_size, "B": B, "S": S, "steps": steps}
    del params, cache, logits, leaves, toks, prompt
    _free(dev)
    return out


def _shard_decode_part(name: str, dev, mesh, tlog, rehearse: bool) -> dict:
    """Part (c), one arch: the DTensor run against the plain run, bitwise
    expected (one slice on a world-1 mesh: no merge, the kernel's output
    the same with its log-sum-exp), else held at decode's bf16 tolerance
    with the reason printed."""
    runs = {"dtensor": _shard_decode_run(name, dev, mesh, rehearse),
            "plain": _shard_decode_run(name, dev, None, rehearse)}
    d, p = runs["dtensor"], runs["plain"]
    pairs = (list(zip(d.pop("logits"), p.pop("logits")))
             + list(zip(d.pop("cache"), p.pop("cache"))))
    bitwise = all(_bitwise(a, b) for a, b in pairs)
    out = {"runs": runs, "bitwise": bitwise, "compared": len(pairs)}
    for key, r in runs.items():
        tlog(f"shard decode {name} {key}: {r['cfg']}, prefill "
             f"{r['prefill_s']:.3f} s, decode step ms: the first "
             f"{r['step_ms'][0]:.3f}, the others' median "
             f"{statistics.median(r['step_ms'][1:]):.3f} "
             f"({', '.join(f'{x:.3f}' for x in r['step_ms'])}), cache "
             f"DTensor leaves {r['dtensors']}; launches "
             + ", ".join(f"{k} {r['launches'][k]}" for k in r["want"])
             + f" (want {r['want']}), plain calls {r['launches']['plain']}")
    if not bitwise:
        errs = [_close(a.float(), b.float(), ZOO_TOL["bf16"])
                for a, b in pairs]
        out["max_abs_err"] = max(e[1] for e in errs)
        tlog(f"shard decode {name}: DTensor vs plain not bitwise (the merge "
             f"is skipped on one rank, so a difference comes from the "
             f"prefill's DTensor ops); max |diff| {out['max_abs_err']:.3e}")
        if not all(e[0] for e in errs):
            fail(f"shard decode {name}: the DTensor decode left the plain "
                 f"one beyond decode's bf16 tolerance")
    tlog(f"shard decode {name}: DTensor vs plain bitwise {bitwise} over "
         f"{len(pairs)} logits and cache leaves")
    if (not pairs or p["dtensors"]
            or d["dtensors"] != len(pairs) - SHARD_DECODE_STEPS - 1):
        fail(f"shard decode {name}: {len(pairs)} logits and leaves "
             f"compared; cache DTensor leaves {d['dtensors']} (DTensor "
             f"run), {p['dtensors']} (plain run)")
    for key, r in runs.items():
        c, want = r["launches"], r["want"]
        others = {k: v for k, v in c.items() if v and k not in want
                  and (k != "plain" or dev.type == "cuda")}
        if any(c[k] != want[k] for k in want) or others:
            fail(f"shard decode {name} {key}: launches {c}, want {want} "
                 f"and nothing else")
    return out


def _bitwise(a, b) -> bool:
    """Same shape, dtype and bits."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a, b))


def _shard_merge(dev, tlog, peaks, rehearse: bool) -> dict:
    """Part (d): the decode kernel with ``return_lse`` on each of M slot
    slices of a cache (each slice's valid slots a prefix), then
    ``merge_partials``, against the whole-cache kernel and the plain
    version at the kernel's tolerances (``ZOO_TOL``), and the kernel's
    log-sum-exp against the plain version's (``SHARD_LSE_RTOL``).  Then
    phase 8's decode row timed with the log-sum-exp off and on.  These are
    checks, not the main path: their launches count nowhere."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev)
    gen.manual_seed(ZOO_SEED + 19)
    randn = _randn(gen, dev)
    shapes = ({f"small {d}": dict(SHARD_MERGE_SMALL, dtype=d)
               for d in ("float32", "bfloat16")} if rehearse
              else SHARD_MERGE)
    report = {"cases": [], "max_abs_err": 0.0, "lse_max_rel": 0.0}
    for label, c in shapes.items():
        dt = getattr(torch, c["dtype"])
        BH, S, Dh = c["BH"], c["S"], c["Dh"]
        q1 = randn(BH, 1, Dh).to(dt)
        k, v = (randn(BH, S, Dh).to(dt) for _ in range(2))
        tol = _tol("decode_attention", dt)
        for length in c["lengths"]:
            whole, lse = da.decode_attention(q1, k, v, length,
                                             return_lse=True)
            plain, plain_lse = da.decode_attention_plain(q1, k, v, length,
                                                         return_lse=True)
            same = _bitwise(whole, da.decode_attention(q1, k, v, length))
            lse_rel = float(((lse - plain_lse).abs()
                             / plain_lse.abs().clamp_min(1e-30)).max())
            row = {"shape": label, "length": length, "lse_max_rel": lse_rel,
                   "out_same_without_lse": same, "slices": {}}
            ok = same and lse_rel <= SHARD_LSE_RTOL
            for M in SHARD_SLICES:
                n = S // M
                pieces = [da.decode_attention(
                    q1, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n],
                    min(max(length - r * n, 0), n), return_lse=True)
                    for r in range(M)]
                merged, L = da.merge_partials([x for x, _ in pieces],
                                              [y for _, y in pieces])
                ok_p, err_p, frob_p = _close(merged, plain, tol)
                ok_k, err_k, frob_k = _close(merged, whole, tol)
                L_rel = float(((L - plain_lse).abs()
                               / plain_lse.abs().clamp_min(1e-30)).max())
                empty = sum(min(max(length - r * n, 0), n) == 0
                            for r in range(M))
                row["slices"][M] = {"vs_plain": err_p, "frob_plain": frob_p,
                                    "vs_kernel": err_k,
                                    "frob_kernel": frob_k, "lse_rel": L_rel,
                                    "empty_slices": empty}
                ok = ok and ok_p and ok_k and L_rel <= SHARD_LSE_RTOL
                report["max_abs_err"] = max(report["max_abs_err"], err_p)
                report["lse_max_rel"] = max(report["lse_max_rel"], L_rel)
                del pieces, merged, L
            report["lse_max_rel"] = max(report["lse_max_rel"], lse_rel)
            tlog(f"shard merge {label} BH {BH} S {S} Dh {Dh} "
                 f"{c['dtype']} length {length}: lse vs plain max rel "
                 f"{lse_rel:.3e}, out unchanged by lse {same}; "
                 + "; ".join(f"M {M}: vs plain {x['vs_plain']:.3e} "
                             f"(frob {x['frob_plain']:.2e}), vs kernel "
                             f"{x['vs_kernel']:.3e}, merged lse rel "
                             f"{x['lse_rel']:.2e}, {x['empty_slices']} "
                             f"empty" for M, x in row["slices"].items()))
            report["cases"].append(row)
            if not ok:
                fail(f"shard merge {label} length {length}: the sliced "
                     f"kernel and merge, or its lse, left the whole cache "
                     f"({row})")
            del whole, lse, plain, plain_lse
        del q1, k, v
        _free(dev)
    if rehearse:
        return report
    # phase 8's decode row (both lengths), the log-sum-exp off and on
    d = DECODE
    q1 = randn(d["BH"], 1, d["Dh"]).to(torch.bfloat16)
    k, v = (randn(d["BH"], d["S"], d["Dh"]).to(torch.bfloat16)
            for _ in range(2))
    times = {}
    for on in (False, True):
        ms = [_events_ms(lambda: da.decode_attention(q1, k, v, n,
                                                     return_lse=on))
              for n in d["lengths"]]
        bound = sum(cost.bound_ms(cost.decode_work(
            d["BH"], n, d["Dh"], k.dtype, lse=on), peaks)["bound_ms"]
            for n in d["lengths"])
        times["lse_on" if on else "lse_off"] = {
            "ms": sum(ms), "ms_by_length": ms, "bound_ms": bound}
    for key, t in times.items():
        tlog(f"time decode_attention {tuple(k.shape)} bf16 lengths "
             f"{d['lengths']} {key}: {t['ms']:.4f} ms "
             f"({t['ms'] / SHARD_DECODE_ROW_MS:.3f} of phase 8's "
             f"{SHARD_DECODE_ROW_MS} ms), bound {t['bound_ms']:.4f} ms")
    report["times"] = times
    del q1, k, v
    _free(dev)
    return report


def phase_shard(dev, card: str, rehearse: bool = False, peaks=None) -> dict:
    """Phase 19: the train step (parts (a), (b), (e)) and prefill and
    decode (part (c)) on DTensors on a world-1 mesh against the same runs
    on plain tensors, and the decode kernel's slot slices merged (part
    (d)); see the module docstring.  Every line carries the card's name
    and power limit; ``rehearse`` runs it on the CPU at reduced widths on a
    gloo group.  The group is made on a ``HashStore`` and destroyed at the
    end."""
    import torch.distributed as dist
    from repro_torch.launch import make_test_mesh
    tlog = lambda msg: log(f"{msg} [{card}]")
    report = {"parts": {}, "decode": {}}
    t_phase = time.perf_counter()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(1, device=dev.type)
        report["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        for name in tuple(SHARD) + (ELASTIC["arch"],):
            t0 = time.perf_counter()
            report["parts"][name] = _shard_part(name, dev, mesh, tlog,
                                                rehearse)
            report["parts"][name]["part_s"] = time.perf_counter() - t0
        for name in SHARD:
            t0 = time.perf_counter()
            report["decode"][name] = _shard_decode_part(name, dev, mesh,
                                                        tlog, rehearse)
            report["decode"][name]["part_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    if peaks is None and not rehearse:
        import torch
        from repro_torch.kernels import cost
        peaks = cost.PEAKS[cost.variant(torch.cuda.get_device_name(dev))]
    report["merge"] = _shard_merge(dev, tlog, peaks, rehearse)
    report["merge"]["part_s"] = time.perf_counter() - t0
    runs = [r for part in (*report["parts"].values(),
                           *report["decode"].values())
            for r in part["runs"].values()]
    report["launches"] = {k: sum(r["launches"][k] for r in runs) for k in (
        "flash_attention", "rglru_scan", "decode_attention", "mlstm_scan")}
    report["phase_s"] = time.perf_counter() - t_phase
    tlog(f"shard phase {report['phase_s']:.1f} s on a {backend} mesh "
         f"{report['mesh']} (" + ", ".join(
             f"{k} {v['part_s']:.1f}" for k, v in report["parts"].items())
         + ", decode " + ", ".join(
             f"{k} {v['part_s']:.1f}" for k, v in report["decode"].items())
         + f", merge {report['merge']['part_s']:.1f}); bitwise " + ", ".join(
             f"{k} {v['bitwise']}" for k, v in report["parts"].items())
         + ", decode " + ", ".join(
             f"{k} {v['bitwise']}" for k, v in report["decode"].items())
         + f"; launches {report['launches']}")
    return report


def _hold_bounds(kernels: list) -> list:
    """Each timed row of the kernels line (a kernel's total and each part
    with its own time and bound) as (name, ms, bound ms); fails if a row
    ran faster than its bound: its ``kernels/cost.py`` model or the
    card's peaks would then be wrong."""
    rows = []
    for k in kernels:
        rows.append((k["name"], k["ms"], k["bound_ms"]))
        cs = k.get("caller_schedule")
        if cs:
            rows.append((f"{k['name']} caller schedule", cs["ms"],
                         cs["bound_ms"]))
        parts = k.get("variants")
        for i, v in enumerate(parts if isinstance(parts, list) else []):
            if "kernel_ms" in v and "bound_ms" in v:
                rows.append((f"{k['name']} part {i}", v["kernel_ms"],
                             v["bound_ms"]))
    beaten = [r for r in rows if not r[1] >= r[2]]
    if not beaten:
        tight = max(rows, key=lambda r: r[2] / r[1])
        log(f"bounds: {len(rows)} kernel rows, the tightest {tight[0]} at "
            f"{tight[2] / tight[1]:.3f} of its bound's rate")
    if beaten:
        fail(f"bounds: rows faster than their bound (the work model is "
             f"wrong): {beaten}")
    return rows


def _kernel_modules():
    from repro_torch.kernels import (decode_attention, event_sweep,
                                     flash_attention, mlstm_scan,
                                     quant_blockwise, rglru_scan)
    return (event_sweep, quant_blockwise, rglru_scan, flash_attention,
            decode_attention, mlstm_scan)


def _wrappers():
    """{name: (kernel wrapper, its plain version)} of all eight kernels
    (the quant kernels through their one-leaf and their grouped wrappers)
    and the draw-only entry (whose plain version, ``draw_gaps``, is what
    ``sample_gaps`` calls)."""
    from repro_torch.core.failures import draw_gaps
    es, qb, rg, fa, da, ml = _kernel_modules()
    return {"event_sweep": (es.event_sweep, es.event_sweep_plain),
            "event_sweep_sampled": (es.event_sweep_sampled,
                                    es.event_sweep_sampled_plain),
            "event_draws": (es.event_draws, draw_gaps),
            "quantize": (qb.quantize, qb.quantize_plain),
            "dequantize": (qb.dequantize, qb.dequantize_plain),
            "quantize_leaves": (qb.quantize_leaves, qb.quantize_plain),
            "dequantize_leaves": (qb.dequantize_leaves, qb.dequantize_plain),
            "rglru_scan": (rg.rglru_scan, rg.rglru_scan_plain),
            "flash_attention": (fa.flash_attention,
                                fa.flash_attention_plain),
            "decode_attention": (da.decode_attention,
                                 da.decode_attention_plain),
            "mlstm_scan": (ml.mlstm_scan, ml.mlstm_scan_plain)}


def _counts() -> dict:
    """Launches of every kernel, and the plain versions' calls in all."""
    w = _wrappers()
    out = {name: ker.launches for name, (ker, _) in w.items()}
    out["plain"] = sum(plain.calls for plain in {p for _, p in w.values()})
    return out


def _reset_counts() -> None:
    for ker, plain in _wrappers().values():
        ker.launches = 0
        plain.calls = 0


#: the phases by number (module docstring), and those a phase reads the
#: results of: 4 and 5 are one run (the sweep, then the MC on its grid);
#: the times (7) read the main path's runs, the checkpoint path's and the
#: draw code's instruction counts (2).
PHASES = {1: "device", 2: "build", 3: "parity", 4: "sweep", 5: "mc",
          6: "ckpt", 7: "times", 8: "zoo", 9: "figures", 10: "multilevel",
          11: "advisor", 12: "train", 13: "ft", 14: "serve", 15: "serve15",
          16: "train16", 17: "mesh", 18: "tooling", 19: "shard"}
NEEDS = {4: {5}, 5: {4}, 7: {2, 4, 5, 6}}


def parse_phases(argv) -> set:
    """The phases ``--phases`` selects (``1-3,16``; all by default), with
    phase 1 and every phase a selected one needs added."""
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port's main paths "
                                 "on one CUDA card (module docstring).")
    ap.add_argument("--phases", default="",
                    help="phases to run, e.g. 1-3,16 (default: all)")
    spec = ap.parse_args(argv).phases.strip()
    if not spec:
        return set(PHASES)
    sel = set()
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        try:
            sel |= set(range(int(lo), int(hi or lo) + 1))
        except ValueError:
            fail(f"--phases: {part!r} is not a number or a range")
    if not sel <= set(PHASES):
        fail(f"--phases: no phase {sorted(sel - set(PHASES))}")
    sel.add(1)
    while True:
        more = set().union(*(NEEDS.get(n, set()) for n in sel)) - sel
        if not more:
            return sel
        sel |= more


class _PhaseClock:
    """Which phases run, and each one's seconds (a phase may run in more
    than one span of ``main``: they add up)."""

    def __init__(self, selected: set):
        self.selected, self.secs = selected, {}

    def on(self, n: int) -> bool:
        return n in self.selected

    def span(self, n: int):
        import contextlib

        @contextlib.contextmanager
        def timed():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.secs[n] = self.secs.get(n, 0.0) + dt
                log(f"phase {n} ({PHASES[n]}): {dt:.1f} s (phase_s "
                    f"{self.secs[n]:.1f} s)")
        return timed()

    def report(self) -> dict:
        return {str(n): (round(self.secs[n], 3) if n in self.secs
                         else "skipped") for n in PHASES}


def main(argv=None) -> None:
    t_start = time.perf_counter()
    ph = _PhaseClock(parse_phases(sys.argv[1:] if argv is None else argv))
    with ph.span(1):
        card, peaks = phase_device()
    for n, name in PHASES.items():
        if not ph.on(n):
            log(f"phase {n} ({name}): skipped (not selected)")
    import shutil
    import torch
    # the plain versions' f32 products run in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    report, draw_ops = {}, None
    if ph.on(2):
        with ph.span(2):
            build_s, draw_ops = phase_build()
    if ph.on(3):
        with ph.span(3):
            parity_err = phase_parity(dev)
            sampled_parity = phase_sampled_parity(dev)
            quant_err, dequant_err = phase_quant_parity(dev)
            zoo_err = phase_zoo_parity(dev)
            report["sampled_parity"] = sampled_parity

    if ph.on(4):
        with ph.span(4):
            # the Monte-Carlo main path (sweep, then MC), its counts read
            # around it
            from repro_torch.core.failures import draw_gaps
            _reset_counts()
            big, sweeps, mc_grid, model, runs = run_main_path(dev)
            torch.cuda.synchronize()
            mc_counts = _counts()
            log(f"main path (sweep + MC): event_sweep_sampled launches "
                f"{mc_counts['event_sweep_sampled']}, event_sweep launches "
                f"{mc_counts['event_sweep']}, event_draws launches "
                f"{mc_counts['event_draws']}, plain-version calls "
                f"{mc_counts['plain']} (draw_gaps, which sample_gaps calls: "
                f"{draw_gaps.calls})")
            if mc_counts["event_sweep_sampled"] <= 0:
                fail("the main path never launched the sampled event kernel")
            if mc_counts["event_sweep"] or mc_counts["event_draws"]:
                fail("the main path launched the explicit kernel or the "
                     "draw-only entry")
            if mc_counts["plain"] != 0:
                fail("the main path called a plain version or drew a "
                     "schedule")
            gate_sweep(big, sweeps)
    if ph.on(5):
        with ph.span(5):
            report.update(gate_mc(mc_grid, model, runs, dev))
            report["dispatch"] = phase_dispatch_invariance(mc_grid, model,
                                                           dev)

            # a caller's schedule through the explicit kernel, its counts
            # read around it
            T_ex, gaps_ex = explicit_schedule(mc_grid, model, dev)
            _reset_counts()
            tb_ex = run_explicit_path(mc_grid, T_ex, gaps_ex, dev)
            torch.cuda.synchronize()
            ex_counts = _counts()
            log(f"explicit-schedule path: event_sweep launches "
                f"{ex_counts['event_sweep']}, event_sweep_sampled launches "
                f"{ex_counts['event_sweep_sampled']}, plain-version calls "
                f"{ex_counts['plain']}")
            if (ex_counts["event_sweep"] <= 0
                    or ex_counts["event_sweep_sampled"] or ex_counts["plain"]):
                fail("the explicit-schedule path did not run through the "
                     "explicit kernel alone")
            report["explicit"] = gate_explicit(mc_grid, T_ex, gaps_ex, tb_ex)
            ex_times = phase_explicit_times(mc_grid, T_ex, gaps_ex, tb_ex,
                                            ex_counts["event_sweep"], peaks,
                                            dev)
            del gaps_ex, tb_ex
            torch.cuda.empty_cache()

    if ph.on(9):
        with ph.span(9):
            # the paper's figures and tables (fig5 and the MC surrogate
            # through the explicit kernel, in f64), their counts read
            # around them
            report["candidates"] = phase_candidates(dev)
            with _LaunchLog() as launch_log:
                _reset_counts()
                figs = run_figures_path(dev, launch_log)
                torch.cuda.synchronize()
                fig_counts = _counts()
            log(f"figures path: event_sweep launches "
                f"{fig_counts['event_sweep']} (fig5 "
                f"{len(launch_log.calls.get('fig5', []))}, argmin "
                f"{len(launch_log.calls.get('argmin', []))}), "
                f"event_sweep_sampled launches "
                f"{fig_counts['event_sweep_sampled']}, plain-version calls "
                f"{fig_counts['plain']}")
            if (fig_counts["event_sweep"] <= 0
                    or fig_counts["event_sweep_sampled"]
                    or fig_counts["event_draws"] or fig_counts["plain"]):
                fail("the figures path did not run through the explicit "
                     "kernel alone")
            from repro_torch.benchmarks import _util as fig_util
            card_results = fig_util.RESULTS
            fig_util.RESULTS = card_results / "cpu"
            figs_cpu = run_figures_path(torch.device("cpu"))
            fig_util.RESULTS = card_results
            report["figures"] = gate_figures(figs, figs_cpu)
            report["figures"]["host_s"] = {"card": figs["secs"],
                                           "cpu": figs_cpu["secs"]}
            fig_times = phase_figure_times(launch_log, peaks)
            del launch_log, figs, figs_cpu
            torch.cuda.empty_cache()

    # the multilevel path (phase 10), each part's counts read around it
    if ph.on(10):
        with ph.span(10):
            report["multilevel"] = phase_multilevel(dev, card)
            torch.cuda.empty_cache()

    # the checkpoint advisor (phase 11), its counts read around it
    if ph.on(11):
        with ph.span(11):
            report["advisor"] = phase_advisor(dev, card)
            torch.cuda.empty_cache()

    # xLSTM-125M trains (phase 12), each part's counts read around it
    if ph.on(12):
        with ph.span(12):
            report["train"] = phase_train(dev, card, peaks)
            torch.cuda.empty_cache()
            train_ml = report["train"]["launches"]["mlstm_scan"]
            train_q = {k: (report["train"]["compress"]["counts"][k]
                           + report["train"]["compress"]["steps_counts"][k])
                       for k in ("quantize_leaves", "dequantize_leaves")}

    # the fault-tolerant runtime (phase 13), each part's counts read around
    # it
    if ph.on(13):
        with ph.span(13):
            report["ft"] = phase_ft(dev, card)
            torch.cuda.empty_cache()
            ft_parts = [report["ft"][k]["launches"] for k in (
                "run", "smoke", "identity")]
            ft_ml = sum(c["mlstm_scan"] for c in ft_parts)
            ft_q = {k: report["ft"]["run"]["launches"][k]
                    for k in ("quantize_leaves", "dequantize_leaves")}

    # serving (phase 14), each part's counts read around it
    if ph.on(14):
        with ph.span(14):
            report["serve"] = phase_serve(dev, card)
            torch.cuda.empty_cache()
    # the other four archs served (phase 15), each part's counts read
    # around it
    if ph.on(15):
        with ph.span(15):
            report["serve15"] = phase_serve15(dev, card)
            torch.cuda.empty_cache()
    if ph.on(14) and ph.on(15):
        serve15_n = report["serve15"]["launches"]
        serve_n = {k: v + serve15_n.get(k, 0)
                   for k, v in report["serve"]["launches"].items()}

    # the checkpoint runtime path, its counts read around it
    if ph.on(6):
        root = ROOT / "build" / "chip_smoke_ckpt"
        shutil.rmtree(root, ignore_errors=True)
        try:
            with ph.span(6):
                _reset_counts()
                ck = run_ckpt_path(dev, root)
                torch.cuda.synchronize()
                ck_counts = _counts()
                quant_names = ("quantize_leaves", "dequantize_leaves",
                               "quantize", "dequantize", "plain")
                log("checkpoint path: " + ", ".join(
                    f"{k} {ck_counts[k]}" for k in quant_names[:4])
                    + f" launches, plain-version calls {ck_counts['plain']}")
                if tuple(ck_counts[k] for k in quant_names) != (1, 1, 0, 0,
                                                                0):
                    fail(f"the checkpoint path did not quantize and "
                         f"dequantize its {_ckpt_sizes()[0]} leaves in one "
                         f"launch each")
                report["ckpt"] = gate_ckpt(ck, dev)
                report["ckpt_times"] = report_ckpt(ck)
            if ph.on(7):
                with ph.span(7):
                    qtimes = phase_quant_times(ck, peaks, dev)
            del ck
        finally:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()

    # the model-zoo kernel layer at full width, its counts read around it
    if ph.on(8):
        with ph.span(8):
            inp = zoo_inputs(dev)
            _reset_counts()
            zoo_out = run_zoo_path(inp)
            torch.cuda.synchronize()
            zoo_counts = _counts()
            zoo_names = ("rglru_scan", "flash_attention", "decode_attention",
                         "mlstm_scan")
            log("zoo path: launches " + ", ".join(
                f"{n} {zoo_counts[n]}" for n in zoo_names)
                + f", plain-version calls {zoo_counts['plain']}")
            if any(zoo_counts[n] <= 0 for n in zoo_names):
                fail("the zoo path did not launch all four kernels")
            if zoo_counts["plain"] != 0:
                fail("the zoo path called a plain version")
            report["zoo"] = gate_zoo(inp, zoo_out)
            del zoo_out
            torch.cuda.empty_cache()
            report["bench_kernels"] = phase_bench_kernels(dev)

    if ph.on(7):
        with ph.span(7):
            variants = phase_times(big, mc_grid, model, runs, peaks,
                                   draw_ops, dev)
    if ph.on(8):
        with ph.span(8):
            ztimes = phase_zoo_times(inp, peaks, dev)
            del inp
            torch.cuda.empty_cache()

    # training through attention and the RG-LRU (phase 16), each part's
    # counts read around it, after every other model is freed
    if ph.on(16):
        with ph.span(16):
            smoke = report.get("ft", {}).get("smoke", {})
            report["train16"] = phase_train16(dev, card,
                                              smoke.get("report_keys"))

    # devices and meshes (phase 17): the grid split and the elastic
    # restore-and-continue, each part's counts read around it
    if ph.on(17):
        with ph.span(17):
            report["mesh"] = phase_mesh(dev, card)
            torch.cuda.empty_cache()

    # the tooling (phase 18): roofline's section 2, sanitize, the dry run's
    # estimate against a measured step, bench_sweep --quick; its counts
    # read around it
    if ph.on(18):
        with ph.span(18):
            report["tooling"] = phase_tooling(dev, card, draw_ops)
            torch.cuda.empty_cache()

    # the train step sharded (phase 19): DTensors on a world-1 NCCL mesh
    # against the plain step, each run's counts read around it
    if ph.on(19):
        with ph.span(19):
            report["shard"] = phase_shard(dev, card, peaks=peaks)
            torch.cuda.empty_cache()

    if ph.selected != set(PHASES):
        log(json.dumps({"phase_s": ph.report()}))
        log("kernels: the kernels line needs every phase; not printed")
        log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    train16_n = report["train16"]["launches"]
    shard_n = report["shard"]["launches"]
    mesh_n = report["mesh"]["launches"]
    tool_n = report["tooling"]["launches"]

    # the explicit kernel: launches, times and bound of the figures path
    # (fig5 and the surrogate's argmin); beside them the caller's schedule
    # and, on the 8 MC calls' drawn schedules, both layouts
    max_err = max([parity_err, sampled_parity["max_abs_err"],
                   ex_times["max_abs_err"]]
                  + [v["max_abs_err"] for v in variants]
                  + [v["max_abs_err"] for v in fig_times.values()])
    on_figs = lambda key: sum(v[key] for v in fig_times.values())
    on_mc = lambda key: sum(v[key] for v in variants)
    kernels = [{
        "name": "event_sweep", "route": "cuda",
        "source": "src/repro_torch/csrc/event_sweep.cu",
        "replaces": "src/repro/kernels/event_sweep.py:65",
        "launches": fig_counts["event_sweep"] + tool_n["event_sweep"],
        "launches_by_path": {"figures": fig_counts["event_sweep"],
                             "tooling": tool_n["event_sweep"]},
        "max_abs_err": max_err, "parity": "bitwise",
        "ms": on_figs("kernel_ms"), "wrapper_ms": on_figs("ms"),
        "plain_ms": on_figs("plain_ms"),
        "bound_ms": on_figs("bound_ms"),
        "bound_by": ("bytes" if on_figs("bytes_ms") >= on_figs("ops_ms")
                     else "operations"),
        "library_ms": None,
        "build_s": build_s["event_sweep.cu"],
        "figures": fig_times,
        "multilevel": report["multilevel"]["launches"],
        "caller_schedule": {
            "launches": ex_counts["event_sweep"], "ms": ex_times["ms"],
            "plain_ms": ex_times["plain_ms"],
            "bound_ms": ex_times["bound_ms"],
            "bound_by": ex_times["bound_by"]},
        "on_mc_schedules": {
            "bnf_ms": on_mc("explicit_bnf_ms"),
            "bfn_ms": on_mc("explicit_bfn_ms"),
            "transpose_ms": on_mc("transpose_ms"),
            "plain_ms": on_mc("plain_ms"),
            "bound_ms": on_mc("explicit_bound_ms"),
            "launches": on_mc("launches")},
    }, {
        "name": "event_sweep_sampled", "route": "cuda",
        "source": "src/repro_torch/csrc/event_sweep.cu",
        "replaces": "src/repro/kernels/event_sweep.py:65",
        "launches": mc_counts["event_sweep_sampled"]
        + mesh_n["event_sweep_sampled"] + tool_n["event_sweep_sampled"],
        "launches_by_path": {"mc": mc_counts["event_sweep_sampled"],
                             "mesh": mesh_n["event_sweep_sampled"],
                             "tooling": tool_n["event_sweep_sampled"]},
        "max_abs_err": max_err, "parity": "bitwise",
        "ms": sum(v["fused_ms"] for v in variants),
        "plain_ms": sum(v["fused_plain_ms"] for v in variants),
        "two_step_ms": sum(v["two_step_ms"] for v in variants),
        "bound_ms": sum(v["fused"]["bound_ms"] for v in variants),
        "bound_by": ("bytes" if all(v["fused"]["bound_by"] == "bytes"
                                    for v in variants) else "operations"),
        "library_ms": None,
        "build_s": build_s["event_sweep.cu"],
        "draw_instructions_per_gap": {str(k): v for k, v in draw_ops.items()},
        "variants": variants,
    }]
    for name, line, err in (("quantize", 23, quant_err),
                            ("dequantize", 34, dequant_err)):
        t = qtimes[name]["checkpoint"]
        kernels.append({
            "name": f"{name}_blockwise", "route": "cuda",
            "source": "src/repro_torch/csrc/quant_blockwise.cu",
            "sources": [f"src/repro_torch/csrc/{f}"
                        for f in KERNEL_FILES["quant_blockwise"]],
            "replaces": f"src/repro/kernels/quant_blockwise.py:{line}",
            "launches": ck_counts[f"{name}_leaves"]
            + train_q[f"{name}_leaves"] + ft_q[f"{name}_leaves"]
            + mesh_n[f"{name}_leaves"],
            "launches_by_path": {"checkpoint": ck_counts[f"{name}_leaves"],
                                 "train": train_q[f"{name}_leaves"],
                                 "ft": ft_q[f"{name}_leaves"],
                                 "mesh": mesh_n[f"{name}_leaves"]},
            "max_abs_err": err,
            "parity": "bitwise", "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "build_s": build_s["quant_blockwise.cu"],
            "variants": qtimes[name]})
    full_width_keys = {
        "rglru_scan": ("rglru_zero_h0", "rglru_seeded_h0"),
        "flash_attention": ("local_attention",),
        "decode_attention": tuple(f"decode_{n}" for n in DECODE["lengths"]),
        "mlstm_scan": ("mlstm",)}
    for name, line, parity in (("rglru_scan", 21, "bitwise"),
                               ("flash_attention", 39, "tolerance"),
                               ("decode_attention", 25, "tolerance"),
                               ("mlstm_scan", 22, "tolerance")):
        t = ztimes[name]
        parts = t if isinstance(t, list) else [t]
        full = [report["zoo"][k]["max_abs_err"]
                for k in full_width_keys[name]]
        if name == "mlstm_scan":
            full.append(report["train"]["kernel_checks"]["h"]["max_abs_err"])
            full += [report["ft"][k]["mlstm_check"]["max_abs_err"]
                     for k in ("run", "smoke")]
        if name == "decode_attention":
            full.append(report["shard"]["merge"]["max_abs_err"])
        lib = [v["library_ms"] for v in parts]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "sources": [f"src/repro_torch/csrc/{f}"
                        for f in KERNEL_FILES.get(name, (f"{name}.cu",))],
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": zoo_counts[name] + serve_n[name] + (
                train_ml + ft_ml + mesh_n[name] if name == "mlstm_scan"
                else 0)
            + train16_n.get(name, 0) + shard_n.get(name, 0) + tool_n[name],
            "launches_by_path": ({"zoo": zoo_counts[name],
                                  "train": train_ml, "ft": ft_ml,
                                  "serve": serve_n[name],
                                  "mesh": mesh_n[name],
                                  "shard": shard_n.get(name, 0),
                                  "tooling": tool_n[name]}
                                 if name == "mlstm_scan" else
                                 {"zoo": zoo_counts[name],
                                  "serve": serve_n[name],
                                  "serve_phase15": serve15_n.get(name, 0),
                                  "train16": train16_n.get(name, 0),
                                  "shard": shard_n.get(name, 0),
                                  "tooling": tool_n[name]}),
            **({"on_train16": {
                k: {f: v[f] for f in ("shape", "dtype", "mode", "bwd_ms",
                                      "fwd_ms", "max_abs_err")}
                for k, v in report["train16"]["checks"].items()
                if k.startswith("flash_")}} if name == "flash_attention"
               else {}),
            **({"dh64": ztimes[name + "_dh64"]}
               if name + "_dh64" in ztimes else {}),
            **({"with_lse": report["shard"]["merge"]["times"],
                "lse_max_rel": report["shard"]["merge"]["lse_max_rel"]}
               if name == "decode_attention" else {}),
            **({"on_train_step": {
                k: report["train"]["profile"].get(k) for k in (
                    "mlstm_launch_ms", "mlstm_bound_ms", "mlstm_bound_by",
                    "mlstm_kernels")}} if name == "mlstm_scan" else {}),
            "max_abs_err": max([zoo_err[name]] + full),
            "parity": parity,
            "ms": sum(v["kernel_ms"] for v in parts),
            "plain_ms": sum(v["plain_ms"] for v in parts),
            "bound_ms": sum(v["bound_ms"] for v in parts),
            "bound_by": ("bytes" if all(v["bound_by"] == "bytes"
                                        for v in parts) else "operations"),
            "library_ms": None if None in lib else sum(lib),
            "build_s": build_s[f"{name}.cu"],
            "variants": parts})
    report["tooling"]["bound_rows"] = _hold_bounds(kernels)
    print(json.dumps({"gates": report}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    log(json.dumps({"phase_s": ph.report()}))
    log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
