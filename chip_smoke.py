#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases (any failure exits non-zero, and no result line is printed):

1. Device and build: requires CUDA, prints the card's name and power limit
   (``nvidia-smi``), builds the hand-written kernels from ``src/`` (one
   ``nvcc`` per source, all started together) and prints the build time.
2. Kernels against their plain versions on the card (run on float64
   copies of the same values):
   Float32 is held elementwise to 1e-5 (plus 1e-5 of the value);
   bfloat16, which the kernels round once on output, to 1e-2 of the
   compared values' max|want| and 5e-3 in relative L2.
   - bind and unbind in float32 and bfloat16, through the kernel that
     ``circconv.route(D)`` picks (the one-pass FFT-form kernels for every D
     = 2^a 3^b 5^c with a >= 2 in [4, 16384], mixed radix where D is not a
     power of two; the four-step ones for such a D past it up to 2^22; the
     direct ones for every other D; each call's route is checked on
     ``ROUTE_LAUNCHES``): the reference's test shapes, the main-path shapes,
     ragged D, and the FFT kernels' edges (R 1, 5, 8, 9, 16; G 1, 2, 128; D
     4 to 32, the route's upper limit 16384, and 28672 = 2^12 7, which goes
     direct), every (G, R) the control plane's (R_fwd, R_bwd) programs
     launch (phase 5) at D 2048 and 4096, phase 13's cut at D 2048 (2, 4,
     2048) and (128, 4, 2048), phase 14's at D 1024 and 256 (G 2 and 128),
     the mixed-radix one-pass kernels
     at the serving widths 5120 and 12288 (G 2 a decode step, 128 a prefill
     chunk) and their edges (D 12, 160, 960, 15360, 16200), the four-step
     kernels at (1, 1, 32768), (2, 4, 65536), (1, 2, 20480), (2, 4, 61440)
     and (3, 5, 40960), at their edges (1, 9, 262144) (more keys than a
     pass B chunk holds) and (2, 3, 18000) (a divisor split, 4-column
     tiles), and at the LM training shapes (4, 4, D) for D = 128 d_model =
     524288, 655360 and 1572864 (deepseek-7b, qwen2.5-32b,
     mistral-large-123b); at the edges, the LM shapes and (128, 4, 12288)
     against a float64 torch.fft oracle made in the phase (the O(D^2)
     plain version would gather terabytes), with the adjoint identity
     <bind(Z), S> = <Z, unbind(S)> to float32 rounding; the direct kernels
     called explicitly at the main-path shapes; two runs of each FFT and
     four-step kernel bitwise equal; the autograd Functions' gradients
     against autograd of the plain version (1e-4); zero key gradient;
   - the two paged-attention decode kernels in float32, bfloat16 and over
     int8 pools (in float32 and in bfloat16 compute): the geometry of
     tests/test_paged_kernel.py (shuffled
     tables, spare pages, staggered positions, a dead slot, lengths 16, 17
     and 23 at page size 8), the serving run's shape (B 8, T 512, page
     size 16, 32 kv heads, head dim 128), phase 13's and phase 14's
     pixtral-12b's (32 heads over 8 kv heads) and phase 14's reduced
     jamba's (4 heads over 2 kv heads of 64), GQA groups 4 and 16, the
     ring mask with wrapped positions, and the split-K edges (one admitted
     row, a prefix of one chunk of the plan and of one chunk + 1, slots
     whose later chunks are empty, T 4096, chunks over which the tile ring
     wraps, a batch that the plan gives one split, the ring at T 256, one
     live slot at position 511, rows of 512 whose float32 tile ring is cut
     to fit the shared memory), each with the plan's split count checked;
     two calls bitwise equal at the serving shape and at one edge.
3. The training path, with TF32 off for matmuls and cuDNN convolutions:
   the paper's VGG-16/CIFAR-10 split train step at B=64 through
   ``c3sl:R=4,backend=pallas`` with Adam at 1e-4 on the synthetic images.
   Step 0's loss and gradients must match ``backend=direct`` on the same
   weights; then 20 steps with a finite loss and exactly 2 bind and 2
   unbind launches per step, every one on the FFT route; then 3 steps
   through ``|int8`` and 3 steps of ResNet-50/CIFAR-100 (D=4096), counted
   the same way.
4. The serving path: ``deepseek-7b`` at full width and depth (30 layers,
   d_model 4096, 32 heads of 128; random float32 weights from the seed)
   behind ``BatchedEngine(kv_layout="paged", kv_read="kernel")`` with the
   codec ``c3sl:R=4,backend=pallas`` at the superblock midpoint: 8 slots,
   max_len 512, page size 16, chunk 64, windows of 8, greedy; 16 requests
   of 128 prompt tokens and 32 new ones.
   - Teacher-forced parity: three decode steps through the kernel read
     against the gather read on copies of one prefilled cache; logits
     within 1e-3 of max|logit|.
   - The engine run: every request completes, every logit is finite, the
     execution mode is ``cuda-kernel``, the paged kernel launches exactly
     30 times per decode step, and bind and unbind each launch once per
     decode step and once per prefill chunk, on the FFT route.
   - A gather-read run of the same requests: the share of generated tokens
     on which the two agree (not gated: an argmax may flip within the
     tolerance).
   - Then bfloat16 weights with an int8 KV cache (8 requests, 16 new
     tokens), which drives ``paged_attention_quant``, checked the same way.
5. The codec control plane, at full width, through the circconv kernels:
   - step-0 parity of one asymmetric pair (R_fwd 4, R_bwd 2) on the VGG-16
     step through the kernels against ``backend=fft`` on the card (loss,
     every gradient leaf, the gradient at the cut, both SNRs);
   - the Adaptive-R link ``CP_LINK`` (``adaptive:c3sl:R=16,min_R=2 >>
     bwd:adaptive:c3sl:R=4,min_R=1``, both ``backend=pallas``) on the
     VGG-16 step (B 64, Adam 1e-4), clamped to the batch: one train step
     per (R_fwd, R_bwd) pair made by ``build_link_program_table`` (4 x 3 =
     12, ``make`` counted), every pair once pinned, then 12 free steps fed
     the cut SNR and the probe's gradient SNR (one host transfer a step),
     then 8 steps with a 10% packet drop on both directions and erasure
     recovery (masks from ``next_erasure``), plus one burst a direction
     that drops a whole payload: the forward one is retransmitted, the
     backward one (no resend allowed) raises ChannelErasure, at the steps
     the schedule predicts and as often as a host replay.  Every step: a
     finite loss, wire bytes equal to ``split_comm_bytes`` of the served
     pair; over the phase: 3 bind and 3 unbind launches a step, all on the
     FFT route, counted by (G, R) as the served pairs imply, ``make`` never
     called again;
   - the masked decode at an all-ones mask bitwise the decode, through the
     kernels, at every bucket;
   - Table 2 on the card at both paper cuts (B 64): ``bnpp:R=4`` against
     ``c3sl:R=4,backend=pallas``, the codec's parameter bytes on the card
     and its device time for encode + decode and their backward, beside
     the analytic param_count and flops ratios; 3 ResNet-50 steps through
     ``bnpp:R=4`` with finite losses and nonzero codec gradients.
6. Times (CUDA events around runs of back-to-back calls, the median of at
   least 20 runs after warm-up).  Every kernel, plain version and library
   call is enqueued behind a sleep kernel, so its time is the device's
   alone (each kernel's host-inclusive time is kept beside it): bind and
   unbind at the training shapes (16, 4, 2048) and (16, 4, 4096), the
   serving shapes (2, 4, 4096) and (128, 4, 4096) (deepseek-7b's and
   phi3.5-moe-42b-a6.6b's) and (2, 4, 2048) and (128, 4, 2048)
   (deepseek-v2-lite-16b's), the mixed-radix serving
   shapes (2, 4, 5120), (128, 4, 5120), (2, 4, 12288) and (128, 4, 12288)
   and the ``BENCH_roofline.json`` circconv shapes (B 64, R 4, D 256 and
   1024), each through the FFT kernel, the direct kernel, its plain version
   (fewer runs where one call takes milliseconds) and the torch.fft route
   of the same function (the library yardstick); each paged
   kernel at the serving shape with positions 128-160 and with one live
   slot at position 511, and at phi3.5-moe-42b-a6.6b's geometry (KV 8)
   with positions 128-160 (with the wrapper's split plan, the share of the
   bound and the host-included time), its plain version and, for the
   float kernel, gather_pages followed by
   ``scaled_dot_product_attention``.  The four-step kernels at the LM
   training shapes (4, 4, D), D = 524288, 655360 and 1572864: the kernel,
   the torch.fft route, the bound, the build of the keys' spectra (once per
   key tensor), and the direct kernel, which took every D but the first
   before, one call a side; their plain version at (2, 4, 65536) (three
   single calls, host included).  Host
   included: the VGG-16 train step
   with the kernel and the fft backend in turns, and a ``torch.profiler``
   breakdown of it; the serving engine's decode-step time, tokens/s and
   mean TTFT, and a profile of one decode window.
7. The LM training path, after the rest and ``free_cuda()``: ``deepseek-7b``
   at full width (d_model 4096, 32 heads of 128, d_ff 11008, vocab
   102400), its depth cut to 8 layers (2.458 B parameters; float32 params,
   gradients and two AdamW moments take 39.3 GB, 110.6 GB at the full 30),
   float32 with TF32 off, B 16, S 128, ``c3sl:R=4,backend=pallas`` at the
   superblock midpoint (after layer 4; D = 524288, G = 4), AdamW at 1e-3
   with the global-norm clip at 1.0: ``launch.train.run_standard`` on a
   config of ``dataclasses.replace(get_config("deepseek-7b"),
   num_layers=8)``, from the CLI's own parser.
   - Step-0 parity: the loss (1e-6 relative) and every gradient leaf
     (1e-4 of its max) through the kernels against ``backend=fft`` on the
     same weights and batch; the cut SNR.
   - 3 steps: finite losses, exactly 2 bind and 2 unbind launches a step,
     all on the four-step route and all at (4, 4, 524288); the wire bytes
     a direction a step exactly 4 * 524288 * 4 = 8,388,608.
   - The checkpoint ``--ckpt-dir`` wrote under ``chiprun_out/`` restored
     bitwise, then deleted (9.8 GB).
   - The step time (CUDA events around single steps, the median of 3,
     host included) and a ``torch.profiler`` breakdown of 2 steps: device
     time, idle share, the codec's share.
8. The LM training path at a width that is not a power of two, after
   ``free_cuda()``: ``qwen2.5-32b`` at full width (d_model 5120, 40 heads
   and 8 KV heads of 128, d_ff 27648, vocab 152064, QKV bias), its depth
   cut to 4 layers (3.51 B parameters; float32 params, gradients and two
   AdamW moments take 56.1 GB, 16 bytes a parameter, 263 GB at the full
   64), otherwise as phase 7: the codec after layer 2 at D = 128 * 5120 =
   655360, G = 4, on the mixed-radix four-step kernels (1280 x 512).
   Step-0 parity against ``backend=fft`` at phase 7's tolerances; 3 steps
   with finite losses, exactly 2 + 2 launches a step, all on ``"fft4"`` at
   (4, 4, 655360) and none direct; 4 * 655360 * 4 = 10,485,760 wire bytes a
   direction a step; the step time and profile.  No checkpoint (phase 7
   covers it).
9-12. The LM training path of the other model families, after
   ``free_cuda()``, each through ``launch.train.run_standard`` as phases 7
   and 8 (B 16, S 128, ``c3sl:R=4,backend=pallas`` at the superblock
   midpoint, float32 with TF32 off, random weights from the seed): step-0
   parity against ``backend=fft`` at phase 7's tolerances (loss, every
   gradient leaf, the cut SNR), every gradient finite, and both measured
   against the codec computed in float64 (``ExactCodec``); where the model
   amplifies float32 rounding so much that ``backend=fft`` itself sits
   past 1e-4 / 4 of a leaf's max from it (rwkv6-1.6b), the kernels may
   differ from ``backend=fft`` by 4 times that distance.  3 steps through
   run_standard (the warm-up), launches counted by route and shape,
   exactly 2 + 2 a step, all ``"fft4"``; the wire bytes a direction
   exactly; then the step time (CUDA events, the median of 5 single
   steps, host included), the idle share (``torch.profiler`` over 2 steps)
   and the peak memory; for an arch with experts, the MoE aux loss and
   the share of token copies dropped at step 0 (the kernel run's
   forward).  No checkpoint.
   9. ``deepseek-v2-lite-16b`` at full width (d_model 2048, 16 heads of
      MLA with kv_lora 512, nope 128, rope 64, v 128; 64 routed experts of
      1408 and 2 shared, top-6, capacity 240; d_ff 10944 in the first
      dense layer; vocab 102400), its depth cut from 27 layers to the dense
      layer and 4 MoE superblocks (2.84 B parameters), the codec after
      superblock 2: D = 262144, G = 4, 4,194,304 wire bytes a direction.
   10. ``rwkv6-1.6b`` at full width and depth (24 layers, d_model 2048, 32
      heads of 64, the chunked time-mix): D = 262144, 4,194,304 bytes.
   11. ``seamless-m4t-large-v2`` at full width and depth: a 24-layer
      encoder over 1024 frames of 1024, random from the seed (behind the
      reference driver's zero frames every encoder row is the same, each
      LayerNorm divides by sqrt(eps) in the backward, and past about 8
      layers the gradients overflow float32, in both packages), and a
      24-layer decoder with cross-attention (d_model 1024,
      LayerNorm, a non-gated MLP of 8192, vocab 256206): D = 131072,
      2,097,152 bytes.
   12. ``jamba-1.5-large-398b`` at ``reduced()`` size, labelled so (one
      full-width superblock holds about 39 B parameters of experts, past
      one card): the Mamba scan and the hybrid pattern on the card, D =
      128 * 256 = 32768, 524,288 bytes.
   ``pixtral-12b`` is not run: its cut at S 128 is D = (1024 + 128) * 5120
   = 5,898,240, past the four-step route's 2^22 (ROADMAP.md B14).
13. Serving the attention-cache families, after ``free_cuda()``, through
   ``BatchedEngine`` at phase 4's settings (float32, TF32 off, 8 slots,
   max_len 512, page size 16, chunk 64, ``sync_every`` 8, greedy, paged,
   ``c3sl:R=4,backend=pallas`` at the stack midpoint, random weights from
   the seed, 16 requests of 128 + 32 tokens).  For each arch: the served
   logits (``prefill_chunk`` over staggered prompts, then 3 teacher-forced
   ``decode_step`` calls, no codec) against ``lm_forward`` at
   ``capacity_factor = num_experts`` within LOGIT_TOL of max|logit|; every
   engine run with bind and unbind once per decode step at (2, 4, D) and
   once per prefill chunk at (128, 4, D), all on the FFT route, none
   direct; the wire bytes exactly those payloads; every MoE call keeping
   every token copy (``moe.ROUTING_LOG``); ``cache_bytes`` equal to the
   count from the config; the decode-step time at 8 live slots, tokens/s,
   mean TTFT, the idle share of one profiled decode window, the peak
   memory and the arch's seconds.
   a. ``deepseek-v2-lite-16b`` (as phase 9: the dense layer and 4 MLA +
      MoE superblocks, 2.84 B parameters, 11.4 GB), D = 2048:
      kv_read="kernel" raises ``ValueError`` (no attn layer), and the paged
      gather run's greedy tokens equal the contiguous run's; the cache is
      (512 + 64) float32 values a position a layer.
   b. ``phi3.5-moe-42b-a6.6b`` at full width (d_model 4096, 32 heads over
      8 KV heads of 128, 16 experts of 6400, top-2, vocab 32064), its depth
      cut to 8 of 32 layers (10.66 B parameters, 42.6 GB; all 32 take 168
      GB), D = 4096: phase 4's kernel-against-gather checks (teacher-forced
      logits, token agreement) and 8 float paged launches a decode step;
      then bfloat16 weights over an int8 KV cache, 8 requests of 128 + 16,
      8 int8 launches a decode step.

14. Serving the stateful and memory families, after ``free_cuda()``, at
   phase 4's settings (float32, TF32 off, 8 slots, max_len 512, page size
   16, chunk 64, ``sync_every`` 8, greedy, ``c3sl:R=4,backend=pallas`` at
   the stack midpoint, D = d_model, random weights and frames from the
   seed, 16 requests of 128 + 32 tokens; only depth and request counts are
   cut).  For each arch: the served logits (``prefill_chunk`` over
   staggered prompts, then 3 teacher-forced ``decode_step`` calls, no
   codec) against ``lm_forward`` within 2e-3 of max|logit| (a VLM against
   its text-only forward, as it is served text-only); one sublayer's
   decode and 64-token prefill times for each recurrent kind and
   ``cross``; the cache bytes equal to the count from the config (the
   recurrent state and the memory included); every engine run held as in
   phase 13 (bind and unbind once per decode step at (2, 4, D) and once
   per prefill chunk at (128, 4, D), on the FFT route; the exact wire
   bytes; the paged kernel once per attn layer a decode step under the
   kernel read) and by its pages drawn; the decode-step time and profile
   of an 8-step window; tokens/s, mean TTFT, the profiled prefill chunk's
   device kernels, the peak memory.
   a. ``rwkv6-1.6b`` at full width and depth (1.58 B parameters), D 2048:
      paged and contiguous, greedy tokens equal, no page drawn.
   b. ``seamless-m4t-large-v2`` at full width and depth (24 + 24 layers),
      D 1024: the engine refuses it (``ValueError``); the lockstep loop
      through ``launch/serve.py`` (its own weights and frames, 8 rows, 32
      steps; bind and unbind once a step at (2, 4, 1024), the CLI's wire
      bytes exact); the lockstep decode step's time and profile, the
      encoder at cache init.
   c. ``jamba-1.5-large-398b`` at ``reduced()`` size (as phase 12), D 256:
      phase 4's kernel-against-gather checks, kernel and gather reads paged
      and the gather read contiguous, greedy tokens paged == contiguous,
      each request's 10 pages drawn.
   d. ``pixtral-12b`` at full width, 8 of 40 layers (3.5 B parameters),
      served text-only, D 5120 on the mixed-radix one-pass kernels (their
      only main-path launches: the record's count must equal these runs'
      steps and chunks): phase 4's kernel-against-gather checks.

15. Serving II on ``deepseek-7b`` at full width and depth, at phase 4's
   settings (float32, TF32 off, 8 slots, max_len 512, page 16, chunk 64,
   paged, the kernel read, 16 requests of 128 + 32), after
   ``free_cuda()``, through phase 13's ``serve_family`` (its model checks
   at full depth, then a plan of six runs, each held by
   ``check_family_run``: bind and unbind by shape as its vanilla steps,
   prefill chunks and verify/commit rounds imply, the forward wire bytes
   of its vanilla steps and chunks alone, the draft wire bytes of its
   rounds, the paged kernel once per attn layer a vanilla step).  A
   yardstick run records the vanilla logits' top-2 gap at every decoded
   position, so a token that differs from it passes only at a near-tie:
   at the request's first differing position the gap is under 1e-4 of
   max|logit|, or a partner in its codec group flipped so at an earlier
   step; the flips are counted and printed.
   - A vanilla run, held to phase 4's kernel run (same weights and
     prompts).
   a. Speculative decoding, tied head, k 4 pinned, over the link
      ``c3sl:R=4,backend=pallas >> draft:c3sl:R=8,backend=pallas``: tokens
      against the vanilla run; spec rounds, accepted, rejected, rollbacks;
      (128, 4, 4096) a prefill chunk, (8, 4, 4096) a verify and a commit,
      (1, 8, 4096) the feedback through the draft channel; no paged-kernel
      launch (verify and commit read through the gather); after draining,
      the cache against the vanilla engine's: integer leaves exactly, float
      leaves within 1e-4 of each leaf's max|value| (on the pages of codec
      groups whose tokens all agree, where some differ).  Then its decode
      windows timed and profiled: ms a round, device time a round, idle
      share.
   b. The copy head, ``adaptive=True``: tokens; the k schedule
      (``k_served``).
   c. Preemption, no codec (rows independent, so outputs are a function
      of the prompt; yardstick a vanilla run without the codec): a 60-page
      pool (six requests' reservations), twelve priority-0 requests, then
      four priority-1 ones after the first ``tick()``; one running request
      withdrawn and resubmitted; evictions > 0, the pool whole after every
      tick, the stream events joined per uid equal to each output with no
      gap, each admission's pages drawn.
   d. The legacy ``prefill_mode="decode"``, 4 requests with the codec:
      tokens against the vanilla run's for them (the same codec group).

16. The networked front door (``repro_torch.frontdoor``) on ``deepseek-7b``
   at full width and depth, at phase 4's settings (float32, TF32 off, 8
   slots, max_len 512, paged, page 16, chunk 64, ``sync_every`` 8, greedy,
   the kernel read, ``c3sl:R=4,backend=pallas``), after ``free_cuda()``: the
   port's server and clients on one event loop over ``127.0.0.1``, port 0.
   Every engine run is a ``serve_run`` driven through the door and held by
   ``check_family_run`` (bind and unbind by shape, the paged kernel 30 times
   a vanilla step, the wire bytes exact); each records every ``tick()``'s
   wall time, and its books at the end (STATS before the server stops): no
   admission unit held, the pool whole, no tick error, no session detached
   and the longest tick under the server's heartbeat deadline (5 s x 3)
   but in c.
   a. Two tenants stage 16 requests of 128 + 32 with ``auto_tick=False``,
      then ``drain()``: each RESULT equals the engine's output and phase
      4's kernel run by the near-tie rule (flips counted); the TOKENS
      bursts joined equal each RESULT; STATS carries the engine's counters.
   b. ``auto_tick=True`` with the server's default heartbeats: a probe of
      4 requests one at a time (the client's TTFT to its first TOKENS frame
      against the engine's, the STATS round trip, a RESULT frame's encode
      and decode on the host), then 3 tenants of 8 concurrent ``generate``
      calls of 64 + 16 against ``TenantPolicy(max_inflight=2)`` and
      ``max_queue_depth=4``: every request completes through BUSY retries
      (BUSY > 0), no tenant disconnected; per-tenant TTFT p50/p99,
      tokens/s and bytes from STATS; the longest tick.
   c. The selfcheck's sequential run (3 tenants x 2 requests of 64 + 16),
      fault-free and then under its seeded ``chaos_plan()`` (drops and
      corruption both ways, one forced disconnect per direction): tokens
      bit-identical, recovery events > 0.
   d. Speculation through the door: phase 15a's link and tied head at k
      4, one tenant pinning ``draft`` in HELLO, 8 requests of 128 + 32
      staged and drained: tokens against a's by the near-tie rule, the
      RESULTs' spec counters summing to the engine's, draft bytes exact; a
      client pinning another draft spec refused at the handshake.
   e. The CLI: ``python -m repro_torch.launch.serve --arch deepseek-7b
      --reduced --frontdoor --port 0 --codec "c3sl:R=4|int8"`` as a
      subprocess on the card: its address line, 3 requests and STATS
      through a port client, SIGINT, its closing line and exit code 0.
17. The 2-stage pod pipeline (``launch.train.run_pipeline`` over
   ``transport.make_pod_pipeline_loss_fn``), after ``free_cuda()``: phase
   7's ``deepseek-7b`` (full width, 8 of 30 layers, the stages 4 + 4
   superblocks), B 16 in 4 microbatches of 4, S 128,
   ``c3sl:R=4,backend=pallas`` on the stage channel: one group a
   microbatch, payload (1, 524288), the four-step kernels at (1, 4,
   524288) (held against the float64 oracle and timed in phases 2 and 6).
   a. Step 0 at depth 1: the loss (1e-6 relative) and every gradient leaf
      (1e-4 of its max) against the per-microbatch composition (embed ->
      stage 0 -> encode/decode -> stage 1 -> head, meaned) and against the
      single-program ``lm_loss`` on the whole batch with the same keys;
      8 + 8 launches, all at (1, 4, 524288).
   b. Step 0 at depth 2: the loss and every gradient leaf bitwise depth
      1's.
   c-e. ``run_pipeline`` at depths 1 and 2, 3 steps each: finite losses,
      equal across depths within 1e-6 relative; 8 bind and 8 unbind
      launches a step, all ``"fft4"`` at (1, 4, 524288); the codec's
      wire bytes (analytic, ``split_comm_bytes``) 2,097,152 a microbatch
      and 8,388,608 a step each way (phase 7's); the call record, as the
      loop saw it: 4 payloads of 2,097,152 B over 4 + depth steps, wire
      mode ``same-device``; the step time (CUDA events, the median of 3, host
      included), a ``torch.profiler`` breakdown of 2 steps and the peak
      memory, beside phase 7's single-program step.
18. The runtime sanitizer tier (``repro_torch.analysis``), after
   ``free_cuda()``.  a, b and d on phase 4's model and settings (float32,
   all 30 layers, 8 slots, page 16, the kernel read,
   ``c3sl:R=4,backend=pallas``); c on phase 7's.
   a. 12 requests of 128 tokens with budgets 8 + 4i, driven by ``tick()``
      until idle, unarmed and then with an ``EngineSanitizer`` attached:
      greedy tokens equal, the pool, slot-state and cut-zeroing counts all
      > 0, the pool whole after the drain; both runs held by
      ``check_family_run`` (the cut probe runs the front half only,
      through the gather: it launches no kernel); each tick's wall time.
   b. 2 of the 8 slots two ticks into decoding: 3 real probes, timed,
      the 4 GB cache and the slot state bitwise unchanged after them; a
      probe built with ``live=None`` reports a nonzero dead-row |cut| sum
      and trips "live-slot zeroing" (writing nothing either) while a
      fresh real probe passes; after the drain, a dirty empty slot trips
      "not inert" and a leaky allocator "accounting".
   c. Phase 7's model (8 of 30 layers, B 16, S 128, D 524288):
      ``run_standard`` and ``run_pipeline`` (4 microbatches, depth 1), 2
      steps each unarmed and under ``--sanitize``: the losses bitwise
      equal, every step checked, anomaly mode off after each run, 2 + 2
      (standard) and 8 + 8 (pipeline) four-step launches a step; 2 more
      steps of each run's step timed (armed: also without anomaly mode);
      then a ``--sanitize`` step with one element of a parameter NaN
      raises ``SanitizerError`` naming step 0 and the leaf, and
      ``finite_outputs`` trips on a NaN and an inf in a tensor on the
      card.
   d. The selfcheck's sequential run through the door under
      ``--sanitize`` (``sync_every`` 2) at 16c's settings: its report
      (ticks, counts, event-loop stalls), the cut-zeroing check > 0,
      tokens equal to 16c's fault-free run (one live slot at a time),
      ``check_family_run``.
   The armed tick and train step print beside the unarmed ones.

19. The dry run's analytic half (``repro_torch.launch.dryrun``), after
   ``free_cuda()``.
   a. ``dryrun_one`` on ``meta`` at full width, bf16 params, for every
      registered arch at decode_32k and for deepseek-7b and
      deepseek-v2-lite-16b at train_4k, cut short past 40 s of host time
      (the rest listed as left out; the CPU tests hold every arch's
      analytic numbers to the reference's): params, counted FLOPs, ``model_flops``, the
      useful ratio, argument bytes against 80 GB, the three roofline
      terms at the H100's peaks and the dominant one, the seconds each;
      ``torch.cuda.memory_allocated()`` the same before and after.
   b. Phase 7's step (deepseek-7b, 8 of 30 layers, B 16, S 128, float32,
      TF32 off, ``c3sl:R=4`` at the midpoint) dry-run on meta, then
      ``dryrun.build_train_step`` on the card from the seed's weights
      with ``c3sl:R=4,backend=pallas``: its first step under
      ``FlopCounterMode``, the FLOPs by op equal to the meta count, the
      argument bytes equal to the real tensors', 2 + 2 four-step
      launches at (4, 4, 524288); 3 steps timed (CUDA events, host
      included) against the roofline's ``compute_s`` at the float32 peak;
      the peak memory against the argument bytes; then M = 2 from the same
      weights: B1/B2 2 + 2 a microbatch at (2, 4, 524288), its groups;
      the loss within 1e-5 relative of M = 1's; its activations (the
      peak less the arguments and the gradient trees held: one at M = 1,
      the sum and a microbatch's at M = 2) at most 0.75 of M = 1's.
   c. ``pipeline_dryrun`` at phase 17's settings (B 16, M 4, depths 1 and
      2, ``c3sl:R=4``): payloads, their bytes and the schedule's steps
      equal to each phase 17 run's ``loss.last_call`` record.
20. The host-sync audit: the port's lint rule R3 held against the card.
   Under ``torch.cuda.set_sync_debug_mode("warn")``, every
   synchronizing-operation warning is recorded with the port's frames on
   the stack (``SyncRecorder``): a. one decode window of the chunked
   engine at phase 4's settings and model (deepseek-7b at full width and
   depth), 8 live slots, ``sync_every`` steps; b. one speculative window
   of one round at k 4 (phase 15a's link, tied head); c. one legacy-mode
   ``step()``; each twice (the first after set-up, then the steady one),
   the prefill chunks before them recorded too; d. ``run_standard`` on
   phase 7's model (deepseek-7b x 8), two steps, each with its log line
   (the records inside the loop counted a step).  Each site (the innermost
   port frame) is printed with its count a step or round, and must be in
   the port's R3 report (``lint_paths(src/repro_torch, rules={"R3"})``) as
   a finding or a suppressed finding, or in
   ``src/repro_torch/README.md``'s table of sync sites no static rule
   sees; no record may pass through ``masked_write``, ``decode_step`` or
   ``prefill_chunk`` (C9 stays fixed).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
F32_PEAK_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

SEED = 0
MAIN_STEPS = 20
SHORT_STEPS = 3
# the reference's kernel test shapes (tests/test_kernels.py), the main-path
# shapes (G = B/R = 16, R = 4, D = 2048 VGG-16 / 4096 ResNet-50), ragged D
KERNEL_SHAPES = [(1, 1, 64), (2, 2, 128), (4, 4, 128), (8, 2, 256), (3, 5, 96),
                 (16, 16, 128), (2, 8, 512), (16, 4, 2048), (16, 4, 4096),
                 (4, 3, 127), (2, 2, 4097)]
# the FFT kernels' edges: R 1, 5, 8, 9, 16 (bind's cluster is min(R, 8)
# blocks, block 0 then takes two keys); G 1, 2 (decode), 128 (prefill
# chunk); D from 4, the route's upper limit 16384, and a D past it that is
# not a power of two (direct)
FFT_EDGE_SHAPES = [(2, 1, 2048), (2, 5, 2048), (2, 8, 2048), (2, 9, 2048),
                   (2, 16, 4096), (1, 4, 4096), (2, 4, 4096), (128, 4, 4096),
                   (3, 2, 4), (2, 3, 8), (2, 2, 16), (3, 2, 32), (1, 3, 16384),
                   (1, 1, 28672)]
# the mixed-radix one-pass kernels (D = 2^a 3^b 5^c, not a power of two):
# the serving widths of qwen2.5-32b / pixtral-12b (5120 = 2^10 5) and
# mistral-large-123b (12288 = 2^12 3) at a decode step (G 2) and a 64-token
# prefill chunk at 8 slots (G 128), and edges: D 12 and 160 (D/4 not a
# multiple of 32), two odd radices (960, 15360), the largest odd part
# (16200 = 8 3^4 5^2) and R 9
MIXED_SERVE_SHAPES = [(2, 4, 5120), (128, 4, 5120), (2, 4, 12288), (128, 4, 12288)]
MIXED_SHAPES = MIXED_SERVE_SHAPES + [(2, 3, 12), (3, 2, 160), (2, 9, 960),
                                     (1, 3, 15360), (1, 2, 16200)]
# the four-step kernels (D past 16384): against the plain version (its
# gather in chunks there) at five shapes, three of them mixed radix, and at
# the LM training paths' shapes (G = B/R = 4, R 4, D = S * d_model at S 128:
# deepseek-7b, qwen2.5-32b, mistral-large-123b, and the other families'; G
# 1 in phase 17's pipeline), where the O(D^2) plain
# version would gather terabytes, against a float64 torch.fft oracle
# computed in the phase (never on the path), as at (128, 4, 12288)
FFT4_SHAPES = [(1, 1, 32768), (2, 4, 65536), (1, 2, 20480), (2, 4, 61440),
               (3, 5, 40960)]
# the four-step kernels' other branches, against the oracle: R 9 past the
# 8 keys a pass B chunk holds at 262144 = 512 x 512, and 18000 = 180 x 100,
# a divisor split with 4-column tiles
FFT4_EDGE_SHAPES = [(1, 9, 262144), (2, 3, 18000)]
# phase 17's pipeline: deepseek-7b's cut, one group a microbatch of 4 (G 1)
PIPE_SHAPE = (1, 4, 524288)
LM_SHAPES = [(4, 4, 524288), (4, 4, 655360), (4, 4, 1572864),
             (4, 4, 262144), (4, 4, 131072), (4, 4, 32768), PIPE_SHAPE]
LM_SHAPE = LM_SHAPES[0]
ORACLE_SHAPES = LM_SHAPES + FFT4_EDGE_SHAPES + [(128, 4, 12288)]
# the direct kernels, called explicitly at the main-path shapes
DIRECT_SHAPES = [(16, 4, 2048), (16, 4, 4096)]
# phase 13's cut at deepseek-v2-lite-16b's width (D = d_model = 2048): a
# decode step (G = 8 slots / R 4 = 2) and a 64-token prefill chunk (G 128);
# phi3.5-moe-42b-a6.6b's, at D 4096, are FFT_EDGE_SHAPES' (2, 4, 4096) and
# (128, 4, 4096)
FAMILY_SERVE_SHAPES = [(2, 4, 2048), (128, 4, 2048)]
# phase 14's new cuts: a decode step (G 2) and a 64-token prefill chunk (G
# 128) at seamless-m4t-large-v2's D 1024 and reduced jamba's 256
# (rwkv6-1.6b's 2048 are FAMILY_SERVE_SHAPES', pixtral-12b's 5120
# MIXED_SERVE_SHAPES')
STATE_SERVE_SHAPES = [(2, 4, 1024), (128, 4, 1024), (2, 4, 256), (128, 4, 256)]
# phase 15's new B1/B2 shapes at D 4096: a verify or commit chunk at k 4 (G
# = 4 positions x 8 slots / R 4 = 8) and k 2 (G 4), the tied head's
# feedback through the draft channel at R 8 (G 1); k 8's (16, 4, 4096) is
# the ResNet-50 step's shape
SPEC_SERVE_SHAPES = [(8, 4, 4096), (4, 4, 4096), (1, 8, 4096)]
# phase 6: training, serving (decode, prefill chunk) and BENCH_roofline.json
# circconv shapes (B 64 = G 16 x R 4; its D = 4096 is the training one)
TIME_SHAPES = ([(16, 4, 2048), (16, 4, 4096), (2, 4, 4096), (128, 4, 4096),
                (16, 4, 256), (16, 4, 1024)] + MIXED_SERVE_SHAPES
               + FAMILY_SERVE_SHAPES + STATE_SERVE_SHAPES + SPEC_SERVE_SHAPES)
TOL = {"float32": 1e-5}
# bfloat16 outputs are rounded once, by half an ulp (at most 2^-8 of the
# element, 2^-8/sqrt(3) in RMS), so their limits scale with the compared
# values: max|err| over max|want|, and the relative L2 error
BF16_REL_MAX, BF16_REL_L2 = 1e-2, 5e-3

# the serving path: deepseek-7b at full width, its decode read (B 8 slots,
# T 512, page size 16, KV = H = 32, head dim 128) and the engine settings
SERVE_ARCH = "deepseek-7b"
SERVE_CODEC = "c3sl:R=4,backend=pallas"
SERVE_ENGINE = dict(num_slots=8, max_len=512, page_size=16, chunk_size=64,
                    sync_every=8, greedy=True, kv_layout="paged")
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 16, 128, 32
QUANT_REQUESTS, QUANT_NEW = 8, 16
MAIN_PAGED = dict(B=8, ps=16, H=32, KV=32, hd=128, length=512)
# phase 13's GQA decode read: phi3.5-moe-42b-a6.6b's 32 heads over 8 KV heads
# (phase 14's pixtral-12b reads the same geometry); phase 14's reduced
# jamba: 4 heads over 2 KV heads of 64
KV8_PAGED = dict(MAIN_PAGED, KV=8)
JAMBA_PAGED = dict(MAIN_PAGED, H=4, KV=2, hd=64)
LOGIT_TOL = 1e-3            # teacher-forced kernel vs gather, of max|logit|
SLEEP_CYCLES = 10_000_000   # about 5 ms: the host enqueues the timed calls

# phase 5, the codec control plane: the Adaptive-R asymmetric link on the
# VGG-16 step (B 64, D 2048).  Targets: the forward controller aims at a
# cut SNR of -6 dB and the backward one at a gradient SNR of -5 dB (each
# with the 1 dB deadband and an EMA of 0.5), between the levels the buckets
# give at step 0 (cut: R 2, 4, 8, 16 at about -2, -5, -8, -19 dB;
# gradient: R 1, 2, 4 at about -2, -4, -7 dB), so both walk their ladders.
CP_LINK = ("adaptive:c3sl:R=16,min_R=2,target_snr=-6.0,ema=0.5,backend=pallas"
           " >> bwd:adaptive:c3sl:R=4,min_R=1,target_snr=-5.0,ema=0.5,"
           "backend=pallas")
CP_FREE_STEPS = 12
CP_FAULT_STEPS = 8
CP_FAULT_RATES = {"drop": 0.1}
# on top of the rate, one scheduled burst per direction drops the whole
# first transmission of that step's payload; the forward channel may resend
# once (so its burst is retransmitted), the backward one not at all (so its
# burst exceeds the budget and raises ChannelErasure)
CP_FAULT_BURSTS = {"fwd": 2, "bwd": 5}
CP_FAULT_BUDGET = {"fwd": 1, "bwd": 0}
CP_PARITY_PAIR = (4, 2)          # (R_fwd, R_bwd) of the step-0 parity
CP_BNPP_STEPS = 3

# phase 7, the LM training path: deepseek-7b at full width, depth cut so
# that float32 params, gradients and two AdamW moments (39.3 GB at 8
# layers, 110.6 GB at the full 30) fit the card; the codec at the
# superblock midpoint (after layer 4), D = S * d_model = 524288, G = 4
LM_ARCH = "deepseek-7b"
LM_LAYERS = 8
LM_BATCH, LM_SEQ = 16, 128
LM_CODEC = "c3sl:R=4,backend=pallas"
LM_STEPS = 3
LM_TIMED_STEPS = 3
LM_PROFILED_STEPS = 2

# phase 8, the LM training path at a width that is not a power of two:
# qwen2.5-32b at full width, depth cut so that float32 params, gradients
# and two AdamW moments (56.1 GB at 4 layers, 263 GB at the full 64) fit
# the card; the codec after layer 2, D = 128 * 5120 = 655360, G = 4, on the
# mixed-radix four-step kernels
# phase 17, the 2-stage pod pipeline: phase 7's model, batch and codec, the
# stages 4 + 4 superblocks, B 16 in 4 microbatches of 4 (R 4: one group a
# microbatch, PIPE_SHAPE), at async depths 1 and 2
PIPE_MICROBATCHES = 4
PIPE_DEPTHS = (1, 2)

QWEN_ARCH = "qwen2.5-32b"
QWEN_LAYERS = 4
QWEN_SHAPE = (4, 4, 655360)

# phases 9-12, the other families' LM training path: (phase, arch, the
# depth it runs at (None: the arch's own), reduced(), the cut's shape (G =
# B/R, R, D = S * d_model)); the wire bytes a direction a step are G * D * 4
FAMILY_RUNS = [(9, "deepseek-v2-lite-16b", 5, False, (4, 4, 262144)),
               (10, "rwkv6-1.6b", None, False, (4, 4, 262144)),
               (11, "seamless-m4t-large-v2", None, False, (4, 4, 131072)),
               (12, "jamba-1.5-large-398b", None, True, (4, 4, 32768))]
FAMILY_TIMED_STEPS = 5

# phase 13, serving the attention-cache families through the engine at full
# width, with phase 4's settings: (arch, the depth it runs at).
# deepseek-v2-lite-16b (MLA + MoE, 64 experts top-6 + 2 shared, a dense
# first layer): that layer and 4 superblocks, as phase 9 (2.84 B params,
# 11.4 GB in float32; 15.7 B at the full 27 layers), the codec after stacked
# superblock 2 at D 2048.  phi3.5-moe-42b-a6.6b (GQA 32 over 8 heads, 16
# experts top-2): 8 of its 32 layers (10.66 B params, 42.6 GB; all 32 would
# take 168 GB, past one card), the codec after layer 4 at D 4096.
FAMILY_SERVE = [("deepseek-v2-lite-16b", 5), ("phi3.5-moe-42b-a6.6b", 8)]
# phase 14, serving the stateful and memory families at phase 4's settings:
# (run, arch, the depth it runs at (None: the arch's own), reduced()).
# a. rwkv6-1.6b at full width and depth (1.58 B params, 6.3 GB), through the
# engine; b. seamless-m4t-large-v2 at full width and depth, through the
# lockstep loop (launch/serve.py without --engine: the engine refuses an
# encoder-decoder model, as the reference's fails on one); c.
# jamba-1.5-large-398b REDUCED, as phase 12 (one full-width superblock holds
# over 40 B params, past one card); d. pixtral-12b at full width, 8 of its
# 40 layers (3.5 B params, 14 GB; all 40 take about 50 GB), served text-only
# as the reference serves a VLM
STATE_SERVE = [("a", "rwkv6-1.6b", None, False),
               ("b", "seamless-m4t-large-v2", None, False),
               ("c", "jamba-1.5-large-398b", None, True),
               ("d", "pixtral-12b", 8, False)]
# served logits against lm_forward for a model with a recurrent sublayer
# (the recurrent step against the chunked training scans, over 24 layers at
# full width): of max|logit|, the reference's own 2e-3
# (tests/test_arch_smoke.py); any other model is held to LOGIT_TOL
STATE_LOGIT_TOL = 2e-3
LOCKSTEP_STEPS = 32         # run b's decode steps through the serve CLI
# phase 15, serving II on deepseek-7b at phase 4's settings: speculative
# decoding over the draft channel (the tied head's feedback at R 8), slot
# preemption with withdraw and stream events, the legacy prefill mode
SPEC_LINK = SERVE_CODEC + " >> draft:c3sl:R=8,backend=pallas"
SPEC_K = 4
PREEMPT_PAGES = 60          # six requests' reservations of 10 pages
PREEMPT_LOW, PREEMPT_HIGH = 12, 4
LEGACY_REQUESTS = 4
NEAR_TIE = 1e-4             # a flip's vanilla top-2 gap, of max|logit|
CACHE_TOL = 1e-4            # spec cache vs vanilla, of each leaf's max|value|
# phase 16, the front door over loopback at phase 4's settings: b's three
# tenants of 8 requests against a cap of 2 in flight each and a backlog of
# 4, after 4 probe requests one at a time; c's selfcheck run of 3 tenants x
# 2 requests; d's speculative run, its clients pinning the draft channel
DOOR_TENANTS, DOOR_REQUESTS, DOOR_PROBES = 3, 8, 4
DOOR_PROMPT, DOOR_NEW = 64, 16
DOOR_INFLIGHT, DOOR_QUEUE = 2, 4
DOOR_CHAOS_REQUESTS = 2
DOOR_SPEC_REQUESTS = 8
SPEC_DRAFT_PIN = "c3sl:R=8,backend=pallas"
WRONG_DRAFT = "c3sl:R=4,backend=pallas"
DOOR_STATS_CALLS = 20
DOOR_FRAME_CALLS = 2000
DOOR_CLI_REQUESTS = 3
DOOR_CLI_TIMEOUT_S = 300


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, warmup=5, calls=10, reps=21, hide_host=True) -> float:
    """Time of one call of ``fn``: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``reps`` such runs after
    ``warmup`` calls.  With ``hide_host`` (every kernel, plain version and
    library call) a sleep kernel is enqueued first, so the calls are queued
    while the device waits and the events time the device's work alone, not
    the wrappers' host time (checks, ctypes); a run whose sleep ended before
    the calls were all queued is dropped and the sleep doubled.  Without it
    (the whole train step) the time is what a caller sees, host included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, cycles = [], SLEEP_CYCLES
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        if hide_host and start.query():
            end.synchronize()
            cycles *= 2
            check(cycles <= 64 * SLEEP_CYCLES,
                  "cuda_ms: the host could not queue the calls within the sleep")
            continue
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cuda_ms_scaled(fn, hide_host=True) -> float:
    """``cuda_ms`` for a call that may take milliseconds (a plain version or
    a direct kernel at a large shape): one call is timed first, host
    included, and a call over 2 ms is timed as the median of 3 single calls
    after one warm-up, host included (no sleep could hide the host there,
    and its share is small)."""
    if cuda_ms(fn, warmup=1, calls=1, reps=1, hide_host=False) > 2.0:
        return cuda_ms(fn, warmup=0, calls=1, reps=3, hide_host=False)
    return cuda_ms(fn, hide_host=hide_host)


def close(got, want, tol) -> tuple[bool, float]:
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all())
    return ok, float(err.max())


BF16_READINGS: dict = {}   # kernel -> worst (max|err|/max|want|, rel L2)
ADJOINT_GAPS: dict = {}    # "GxRxD" -> |<bind(Z), S> - <Z, unbind(S)>| / norms


def close_as(got, want, dtype_name, kernel) -> tuple[bool, float]:
    """float32 elementwise within TOL; bfloat16 within BF16_REL_MAX of
    max|want| and BF16_REL_L2 in relative L2, whose readings are kept in
    BF16_READINGS.  Returns (ok, max|err|)."""
    if dtype_name != "bfloat16":
        return close(got, want, TOL[dtype_name])
    got, want = got.double(), want.double()
    err = (got - want).abs()
    rel_max = float(err.max() / want.abs().max())
    rel_l2 = float(err.norm() / want.norm())
    old = BF16_READINGS.get(kernel, (0.0, 0.0))
    BF16_READINGS[kernel] = (max(old[0], rel_max), max(old[1], rel_l2))
    return rel_max <= BF16_REL_MAX and rel_l2 <= BF16_REL_L2, float(err.max())


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def fft_oracle(name, x, kext):
    """bind or unbind in float64 through torch.fft: the check of the
    four-step kernels where the O(D^2) plain version is out of reach."""
    import torch
    X = torch.fft.fft(x.double(), dim=-1)
    Kf = torch.fft.fft(kext[:, :x.shape[-1]].double(), dim=-1)
    if name == "bind_superpose":
        return torch.fft.ifft((X * Kf).sum(-2), dim=-1).real
    return torch.fft.ifft(X[:, None, :] * Kf.conj(), dim=-1).real


def circconv_pair(name, kernel_route, x, kext, oracle=False):
    """(kernel output, float64 plain output, or the float64 torch.fft
    oracle's with ``oracle``) of bind or unbind through the named route's
    kernel, checking that exactly that kernel launched."""
    import torch
    from repro_torch.kernels import circconv
    on, plain = {"bind_superpose": (circconv._bind_superpose_on,
                                    circconv.bind_superpose_plain),
                 "unbind": (circconv._unbind_on, circconv.unbind_plain)}[name]
    before = dict(circconv.ROUTE_LAUNCHES)
    got = on(kernel_route, x, kext)
    want = (fft_oracle(name, x, kext) if oracle
            else plain(x.double(), kext.double()))
    torch.cuda.synchronize()
    after = dict(circconv.ROUTE_LAUNCHES)
    check(all(after[k] - before[k] == (k == (name, kernel_route)) for k in after),
          f"{name} {tuple(x.shape)} via {kernel_route}: launches {before} -> {after}")
    return got, want


def _record_suffix(kernel_route: str, D: int) -> str:
    """The record's kernel of a route at D: "" the power-of-two one-pass
    kernels, "_mixed" the mixed-radix ones (circconv_fft.cu both),
    "_fft4", "_direct"."""
    if kernel_route == "fft":
        return "_mixed" if D & (D - 1) else ""
    return "_" + kernel_route


def kernel_checks(dev) -> dict:
    """Each kernel against its plain version on the same values.  The plain
    version runs on float64 copies, so the difference is the kernel's own
    rounding (float32 sums over up to R*D = 16384 terms at D = 4096)."""
    import torch
    from repro_torch.core import hrr
    from repro_torch.kernels import circconv, ops

    gen = torch.Generator().manual_seed(SEED)
    errs = {k + sfx: {} for sfx in ("", "_mixed", "_fft4", "_direct")
            for k in ("bind_superpose", "unbind")}
    routed = list(dict.fromkeys(KERNEL_SHAPES + FFT_EDGE_SHAPES + cp_kernel_shapes()
                                + FAMILY_SERVE_SHAPES + STATE_SERVE_SHAPES
                                + SPEC_SERVE_SHAPES + MIXED_SHAPES + FFT4_SHAPES
                                + FFT4_EDGE_SHAPES + LM_SHAPES))
    # errors kept by kernel: the power-of-two one-pass kernels', the
    # mixed-radix ones', the four-step ones' and the direct ones' apart
    cases = ([(s, r, _record_suffix(r, s[-1]))
              for s in routed for r in [circconv.route(s[-1])]]
             + [(s, "direct", "_direct") for s in DIRECT_SHAPES])
    for (G, R, D), kernel_route, suffix in cases:
        K = hrr.generate_keys(gen, R, D, device=dev)
        kext = ops._kext(K)
        Z32 = torch.randn((G, R, D), generator=gen).to(dev)
        oracle = (G, R, D) in ORACLE_SHAPES
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            Z = Z32.to(dt)
            got, want = circconv_pair("bind_superpose", kernel_route, Z, kext,
                                      oracle)
            check(got.dtype == dt and got.shape == (G, D), f"bind {G,R,D} {name}: "
                  f"{got.dtype} {tuple(got.shape)}")
            ok, e = close_as(got, want, name, "bind_superpose" + suffix)
            check(ok, f"bind {kernel_route} kernel != plain at {(G, R, D)} {name}: "
                  f"max err {e}")
            errs["bind_superpose" + suffix][f"{G}x{R}x{D}/{name}"] = e
            S = want.to(dt)
            got_u, want = circconv_pair("unbind", kernel_route, S, kext, oracle)
            check(got_u.dtype == dt and got_u.shape == (G, R, D),
                  f"unbind {G,R,D} {name}")
            ok, e = close_as(got_u, want, name, "unbind" + suffix)
            check(ok, f"unbind {kernel_route} kernel != plain at {(G, R, D)} {name}: "
                  f"max err {e}")
            errs["unbind" + suffix][f"{G}x{R}x{D}/{name}"] = e
            if kernel_route in ("fft", "fft4") and name == "float32":
                again = (circconv.bind_superpose_kernel(Z, kext),
                         circconv.unbind_kernel(S, kext))
                torch.cuda.synchronize()
                check(torch.equal(again[0], got) and torch.equal(again[1], got_u),
                      f"{kernel_route} kernels not bitwise repeatable at {(G, R, D)}")
            if oracle and name == "float32":
                # the adjoint identity <bind(Z), S> = <Z, unbind(S)>, to
                # float32 rounding: each kernel's backward is the other
                lhs = (got.double() * S.double()).sum()
                rhs = (Z.double() * got_u.double()).sum()
                gap = float((lhs - rhs).abs() / (got.double().norm()
                                                 * S.double().norm()))
                check(gap <= 1e-5, f"{kernel_route} adjoint identity off by {gap} "
                      f"at {(G, R, D)}")
                ADJOINT_GAPS[f"{G}x{R}x{D}"] = gap
        del K, kext, Z32, Z, S, got, got_u, want
        free_cuda()

    # gradients: each autograd Function's backward is the other kernel,
    # against autograd of the plain version (float64)
    for G, R, D in ((16, 4, 2048), (16, 4, 4096), (3, 5, 96)):
        K = hrr.generate_keys(gen, R, D, device=dev).requires_grad_()
        k64 = ops._kext(K).double()
        Z = torch.randn((G, R, D), generator=gen).to(dev).requires_grad_()
        dS = torch.randn((G, D), generator=gen).to(dev)
        gz, gk = torch.autograd.grad((ops.bind_superpose_pallas(Z, K) * dS).sum(),
                                     [Z, K], allow_unused=True,
                                     materialize_grads=True)
        z64 = Z.detach().double().requires_grad_()
        (gz_ref,) = torch.autograd.grad(
            (circconv.bind_superpose_plain(z64, k64) * dS).sum(), [z64])
        torch.cuda.synchronize()
        ok, e = close(gz, gz_ref, 1e-4)
        check(ok, f"bind grad != autograd of plain at {(G, R, D)}: {e}")
        check(bool((gk == 0).all()), "bind: keys got a gradient")
        errs["bind_superpose"][f"grad {G}x{R}x{D}"] = e
        S = torch.randn((G, D), generator=gen).to(dev).requires_grad_()
        dZ = torch.randn((G, R, D), generator=gen).to(dev)
        gs, gk = torch.autograd.grad((ops.unbind_pallas(S, K) * dZ).sum(), [S, K],
                                     allow_unused=True, materialize_grads=True)
        s64 = S.detach().double().requires_grad_()
        (gs_ref,) = torch.autograd.grad(
            (circconv.unbind_plain(s64, k64) * dZ).sum(), [s64])
        torch.cuda.synchronize()
        ok, e = close(gs, gs_ref, 1e-4)
        check(ok, f"unbind grad != autograd of plain at {(G, R, D)}: {e}")
        check(bool((gk == 0).all()), "unbind: keys got a gradient")
        errs["unbind"][f"grad {G}x{R}x{D}"] = e
    return errs


def paged_case(rng, dev, *, B, ps, H, KV, hd, length, quant=False, pos=None,
               sets=1) -> dict:
    """One paged decode read with the geometry of tests/test_paged_kernel.py:
    pools with two spare pages, shuffled tables, and (unless ``pos`` is
    given) staggered positions on both sides of the last page boundary and,
    from B = 3, a dead slot (table row 0, pos 0).  ``sets`` > 1 makes that
    many tables over disjoint pages of one pool: a timing run cycles through
    them, so each call finds its rows cold in the L2 cache, as each of the
    30 layers' reads does on the serving path."""
    import torch
    P = -(-length // ps)
    npages = sets * B * P + 2
    tables = rng.permutation(npages)[:sets * B * P].astype(np.int32)
    tables = tables.reshape(sets, B, P)
    if pos is None:
        pos = rng.randint(0, length, B)
        pos[0] = length - 1
        if B > 1:
            pos[1] = max(length - ps - 1, 0)
        if B > 2:
            tables[:, 2] = 0
            pos[2] = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    case = {"q": t(rng.randn(B, 1, H, hd).astype(np.float32)),
            "tables": [t(tb) for tb in tables],
            "pos": t(np.asarray(pos, np.int32)), "length": length}
    shape = (npages, ps, KV, hd)
    for n in "kv":
        if quant:
            case[n] = t(rng.randint(-127, 128, shape).astype(np.int8))
            case[n + "s"] = t((rng.rand(npages, ps, KV, 1) * 0.02 + 1e-3)
                              .astype(np.float32))
        else:
            case[n] = t(rng.randn(*shape).astype(np.float32))
    return case


def paged_pair(case, dtype, *, quant, window=None):
    """(kernel output, float64 plain output) on the same values.  int8
    pools take q in ``dtype`` and compute in it."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    q = case["q"].to(dtype)
    tab, pos = case["tables"][0], case["pos"]
    kw = dict(length=case["length"], sliding_window=window)
    if quant:
        got = pa.paged_attention_quant(q, case["k"], case["ks"], case["v"],
                                       case["vs"], tab, pos,
                                       compute_dtype=dtype, **kw)
        want = pa.paged_attention_quant_plain(
            q.double(), case["k"], case["ks"].double(), case["v"],
            case["vs"].double(), tab, pos, compute_dtype=torch.float64, **kw)
        return got, want
    k, v = case["k"].to(dtype), case["v"].to(dtype)
    got = pa.paged_attention(q, k, v, tab, pos, **kw)
    want = pa.paged_attention_plain(q.double(), k.double(), v.double(), tab,
                                    pos, **kw)
    return got, want


def split_edge_shapes() -> list:
    """The split-K edges of ``csrc/paged_attention.cu``, as
    (label, geometry with positions, window): one admitted row (pos 0); a
    prefix of exactly one chunk of the plan and one chunk + 1; slots whose
    later chunks are all empty; a long T (4096) with many splits; chunks of
    many tiles, so the three-tile ring wraps; a B*KV past the plan's block
    target (one split: pass 1 writes the output); the ring with wrapped
    positions; one live slot of the serving geometry at position 511;
    rows of 512 in chunks of four tiles, whose float32 ring the set-up cuts
    to one tile to fit the shared memory."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    base = dict(B=2, ps=16, H=4, KV=2, hd=128, length=512)
    _, chunk = pa.split_plan(2, 2, 2, 128, 512, 16,
                             pa.sm_count(torch.cuda.current_device()))
    return [
        ("split/n1", dict(base, pos=[0, 0]), None),
        ("split/one_chunk", dict(base, pos=[chunk - 1, chunk - 2]), None),
        ("split/chunk+1", dict(base, pos=[chunk, chunk - 1]), None),
        ("split/later_empty", dict(base, B=4, pos=[511, 3, 40, 0]), None),
        ("split/long_T", dict(B=2, ps=16, H=8, KV=4, hd=128, length=4096,
                              pos=[4095, 1000]), None),
        ("split/deep_ring", dict(MAIN_PAGED, length=2048,
                                 pos=[2047, 1500, 700, 255, 256, 257, 95, 96]),
         None),
        ("split/S1", dict(B=72, ps=16, H=32, KV=32, hd=64, length=64), None),
        ("split/ring", dict(B=4, ps=16, H=8, KV=2, hd=64, length=256,
                            pos=[255, 300, 700, 10]), 256),
        ("split/one_slot", dict(MAIN_PAGED, B=1, pos=[511]), None),
        ("split/wide_rows", dict(B=4, ps=16, H=2, KV=2, hd=512, length=4096,
                                 pos=[4095, 2000, 130, 0]), None)]


def paged_kernel_checks(dev) -> dict:
    """Both paged kernels against their plain versions (float64 copies):
    float32 and bfloat16 pools through ``paged_attention``, int8 pools in
    float32 and bfloat16 compute through ``paged_attention_quant``, at the
    reference's geometry, the serving shape, GQA groups, the ring and the
    split-K edges; at the serving shape and one split edge, two calls
    bitwise equal."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.RandomState(SEED + 4)
    shapes = [(f"ps8/T{n}", dict(B=3, ps=8, H=4, KV=2, hd=16, length=n), None)
              for n in (16, 17, 23)]
    shapes.append(("main", MAIN_PAGED, None))
    shapes.append(("kv8", KV8_PAGED, None))
    shapes.append(("jamba", JAMBA_PAGED, None))
    shapes += [(f"groups{g}", dict(B=4, ps=16, H=2 * g, KV=2, hd=128,
                                   length=100), None) for g in (4, 16)]
    # the ring: T = the window, positions past T have wrapped
    shapes.append(("ring", dict(B=4, ps=16, H=8, KV=4, hd=64, length=48,
                                pos=[47, 53, 146, 10]), 48))
    errs = {"paged_attention": {}, "paged_attention_quant": {}}
    repeat = ("main", "split/later_empty")
    for name, quant in (("paged_attention", False),
                        ("paged_attention_quant", True)):
        for label, geo, window in shapes + split_edge_shapes():
            B, H, hd = geo["B"], geo["H"], geo["hd"]
            case = paged_case(rng, dev, quant=quant, **geo)
            for dt_name, dt in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16)):
                got, want = paged_pair(case, dt, quant=quant, window=window)
                torch.cuda.synchronize()
                check(got.dtype == dt and tuple(got.shape) == (B, 1, H * hd),
                      f"{name} {label} {dt_name}: {got.dtype} {tuple(got.shape)}")
                ok, e = close_as(got, want, dt_name, name)
                check(ok, f"{name} kernel != plain at {label} {dt_name}: "
                      f"max err {e}")
                errs[name][f"{label}/{dt_name}"] = e
                if label in repeat:
                    again, _ = paged_pair(case, dt, quant=quant, window=window)
                    torch.cuda.synchronize()
                    check(torch.equal(again, got), f"{name} not bitwise "
                          f"repeatable at {label} {dt_name}")
            if label.startswith("split/"):
                S, _ = pa.split_plan(B, geo["KV"], H // geo["KV"], hd,
                                     geo["length"], geo["ps"],
                                     pa.sm_count(torch.cuda.current_device()))
                # S1 and deep_ring (8 x 32 blocks) fill the card in one split
                check((S == 1) == (label in ("split/S1", "split/deep_ring")),
                      f"{name} {label}: the plan gave {S} splits")
            del case
            free_cuda()
    return errs


# --------------------------------------------------------------------------
# phase 3: the training path
# --------------------------------------------------------------------------

def make_setup(model: str, spec: str, dev, net=None):
    import torch
    import torch.nn.functional as F
    from repro_torch import codecs
    from repro_torch.configs.paper import RESNET50_CIFAR100, VGG16_CIFAR10
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.models import convnets
    from repro_torch.transport.split import make_split_loss_fn

    cfg = VGG16_CIFAR10 if model == "vgg16" else RESNET50_CIFAR100
    front, back, init = {
        "vgg16": (convnets.vgg16_front, convnets.vgg16_back, convnets.init_vgg16),
        "resnet50": (convnets.resnet50_front, convnets.resnet50_back,
                     convnets.init_resnet50)}[model]
    if net is None:
        net = init(torch.Generator().manual_seed(SEED), n_classes=cfg.n_classes,
                   device=dev)
    C, H, W = cfg.cut_shape
    codec = codecs.build(spec, D=cfg.D, C=C, H=H, W=W)
    params = {"net": net, "codec": codec.init(device=dev)}
    loss = make_split_loss_fn(front, back, codec, F.cross_entropy)
    data = SyntheticImageDataset(n_classes=cfg.n_classes, seed=SEED)
    return cfg, codec, params, loss, data


def leaf_rel_err(a, b) -> float:
    """Largest over leaves of max|a - b| / max|b|; inf where a leaf of
    either holds a NaN or an inf."""
    from repro_torch.interop import tree_leaves
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        scale = float(y.abs().max())
        e = float((x - y).abs().max()) / max(scale, 1e-30)
        worst = max(worst, e if math.isfinite(e) else math.inf)
    return worst


def step0_parity(model: str, spec: str, dev) -> dict:
    """Loss and grads through the kernel backend vs ``backend=direct`` on
    the same weights, keys and batch.  Tolerances: the two differ only in
    the codec's float32 summation order (kernel tiles vs a cuBLAS GEMM), so
    loss rtol 1e-4 and every gradient leaf within 1e-3 of its max."""
    import torch
    from repro_torch.transport.split import split_value_and_grad
    cfg, codec, params, loss_k, data = make_setup(model, spec, dev)
    _, _, params_d, loss_d, _ = make_setup(
        model, spec.replace("backend=pallas", "backend=direct"), dev,
        net=params["net"])
    params_d["codec"] = params["codec"]
    batch = data.batch(cfg.batch_size, 0, device=dev)
    lk, gk, _ = split_value_and_grad(loss_k, params, batch)
    ld, gd, _ = split_value_and_grad(loss_d, params_d, batch)
    torch.cuda.synchronize()
    lk, ld = float(lk), float(ld)
    rel = abs(lk - ld) / abs(ld)
    check(rel <= 1e-4, f"{model} step-0 loss kernel {lk} vs direct {ld}")
    gerr = leaf_rel_err(gk, gd)
    check(gerr <= 1e-3, f"{model} step-0 grads kernel vs direct: {gerr}")
    return {"loss_kernel": lk, "loss_direct": ld, "loss_rel_err": rel,
            "grad_leaf_rel_err": gerr}


def route_counts() -> dict:
    """``circconv.ROUTE_LAUNCHES`` with string keys ("bind_superpose/fft")."""
    from repro_torch.kernels import circconv
    return {f"{k}/{r}": n for (k, r), n in circconv.ROUTE_LAUNCHES.items()}


def record_launches() -> dict:
    """The circconv launches since the last reset, by the record's kernel
    (``_record_suffix``: the power-of-two and the mixed-radix one-pass
    kernels apart), from ``SHAPE_LAUNCHES`` and the route each D takes (a
    main-path run launches through ``route(D)``)."""
    from collections import Counter
    from repro_torch.kernels import circconv
    out = Counter()
    for (name, G, R, D), n in circconv.SHAPE_LAUNCHES.items():
        out[name + _record_suffix(circconv.route(D), D)] += n
    return dict(out)


def check_fft_route(routes: dict, per_kernel: int, what: str, route="fft"):
    """Every circconv launch went to ``route``'s kernels: ``per_kernel``
    each."""
    from repro_torch.kernels import circconv
    want = {f"{k}/{r}": per_kernel if r == route else 0
            for k in ("bind_superpose", "unbind") for r in circconv.ROUTES}
    check(routes == want, f"{what}: circconv routes {routes}, want {want}")


def run_steps(model: str, spec: str, steps: int, dev) -> dict:
    """``steps`` train steps from fresh weights, launch counts reset just
    before and read just after."""
    import torch
    from repro_torch.kernels import circconv
    from repro_torch.optim import adam
    from repro_torch.transport.split import (make_split_train_step,
                                             trainable_params)
    cfg, codec, params, loss, data = make_setup(model, spec, dev)
    opt = adam(cfg.lr)
    opt_state = opt.init(trainable_params(loss, params))
    step = make_split_train_step(loss, opt)
    batches = [data.batch(cfg.batch_size, s, device=dev) for s in range(steps)]
    torch.cuda.synchronize()
    circconv.reset_launch_counts()
    losses = []
    for b in batches:
        params, opt_state, l, _ = step(params, opt_state, b)
        losses.append(l)
    torch.cuda.synchronize()
    counts = dict(circconv.LAUNCHES)
    routes, by_kernel = route_counts(), record_launches()
    losses = torch.stack(losses).tolist()
    check(all(map(math.isfinite, losses)), f"{model} {spec}: non-finite loss {losses}")
    want = {"bind_superpose": 2 * steps, "unbind": 2 * steps}
    check(counts == want, f"{model} {spec}: launches {counts}, want {want}")
    check_fft_route(routes, 2 * steps, f"{model} {spec}")
    mode = getattr(codec, "transform", codec).execution_mode(dev)
    check(mode == "cuda-kernel", f"{spec} ran as {mode}, not the CUDA kernel")
    return {"model": model, "spec": codec.spec(), "steps": steps,
            "batch": cfg.batch_size, "losses": losses, "launches": counts,
            "route_launches": routes, "record_launches": by_kernel}


# --------------------------------------------------------------------------
# phase 4: the serving path
# --------------------------------------------------------------------------

def serve_model(dtype, dev, quant=False, arch=SERVE_ARCH, layers=None,
                small=False):
    """``arch`` at full width, its depth cut to ``layers`` (None: the arch's
    own), or at ``reduced()`` size with ``small``; random weights from the
    seed."""
    from repro_torch.models import lm as lm_lib
    cfg = lm_config(arch, layers, small)
    if quant:
        cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    return cfg, lm_lib.init_lm_params(SEED, cfg, dtype=dtype, device=dev)


def free_cuda():
    import torch
    from repro_torch.kernels import ops
    ops.clear_key_caches()
    gc.collect()
    torch.cuda.empty_cache()


def n_attn_layers(cfg) -> int:
    return cfg.num_superblocks * sum(k == "attn" for layer in cfg.block_pattern
                                     for k in layer)


def serve_prompts(n: int, vocab: int, length: int = SERVE_PROMPT) -> list:
    rng = np.random.RandomState(SEED + 1)
    return rng.randint(0, vocab, (n, length)).tolist()


@contextlib.contextmanager
def finite_logits():
    """Within the block, every ``decode_step``, ``prefill_chunk`` and
    ``verify_chunk`` the engine calls ANDs "all logits finite" into a flag
    on the device (no host sync); yields a one-element list that holds the
    flag's value on exit."""
    import torch
    from repro_torch.models import lm as lm_lib
    flag = None
    orig = {n: getattr(lm_lib, n) for n in ("decode_step", "prefill_chunk",
                                           "verify_chunk")}

    def wrap(fn):
        def probed(*a, **kw):
            nonlocal flag
            out = fn(*a, **kw)
            ok = torch.isfinite(out[0]).all()
            flag = ok if flag is None else flag & ok
            return out
        return probed

    result = [None]
    for n, fn in orig.items():
        setattr(lm_lib, n, wrap(fn))
    try:
        yield result
    finally:
        for n, fn in orig.items():
            setattr(lm_lib, n, fn)
        result[0] = flag is not None and bool(flag)


def make_engine(params, cfg, kv_read: str, **over):
    """The engine at phase 4's settings; ``over`` overrides them (the codec
    included)."""
    from repro_torch.serving.engine import BatchedEngine
    return BatchedEngine(params, cfg, seed=SEED, kv_read=kv_read,
                         **{**SERVE_ENGINE, "codec": SERVE_CODEC, **over})


def serve_run(params, cfg, kv_read: str, n_req: int, max_new: int,
              drive=None, gaps=False, prompt_len=SERVE_PROMPT, **over):
    """One engine run of ``n_req`` requests of ``prompt_len`` tokens and
    ``max_new`` new ones (an int, or a list of one budget a request;
    ``over`` overrides SERVE_ENGINE's settings), launch counts and, with
    experts, the MoE
    routing log reset just before and read just after.  ``drive(eng,
    prompts)`` replaces "submit every prompt, then ``run()``" and returns
    (the finished requests, a dict merged into the record).  With ``gaps``
    the vanilla logits' top-2 gaps are recorded (``vanilla_gaps``).  The
    record keeps each admission's pages (``page_owners``: uid, pages, in
    order).  Returns (engine, record)."""
    import torch
    from repro_torch.kernels import circconv
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import moe
    from repro_torch.serving.engine import Request
    eng = make_engine(params, cfg, kv_read, **over)
    owners = []
    alloc = eng._alloc_slot_pages

    def owned_alloc(i, req):
        got = alloc(i, req)
        if got and eng.slots[i].pages:
            owners.append((req.uid, list(eng.slots[i].pages)))
        return got
    eng._alloc_slot_pages = owned_alloc
    prompts = serve_prompts(n_req, cfg.vocab_size, prompt_len)
    budgets = max_new if isinstance(max_new, list) else [max_new] * n_req
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    circconv.reset_launch_counts()
    moe.ROUTING_LOG = [] if cfg.num_experts else None
    try:
        with finite_logits() as finite, (vanilla_gaps(eng) if gaps else
                                         contextlib.nullcontext({})) as probe:
            t0 = time.perf_counter()
            if drive is None:
                for u, p in enumerate(prompts):
                    eng.submit(Request(uid=u, prompt=p,
                                       max_new_tokens=budgets[u]))
                done, info = eng.run(), {}
            else:
                done, info = drive(eng, prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log = moe.ROUTING_LOG
    finally:
        moe.ROUTING_LOG = None
    counts = {**pa.LAUNCHES, **circconv.LAUNCHES}
    routes, by_kernel = route_counts(), record_launches()
    shapes = {"{}/{}x{}x{}".format(*k): n
              for k, n in sorted(circconv.SHAPE_LAUNCHES.items())}
    outs = {r.uid: r.out for r in done}
    gen = sum(len(o) for o in outs.values())
    st = eng.stats
    spec = eng.spec_cfg
    rec = {"kv_read": kv_read, "kv_layout": eng.kv_layout, "requests": n_req,
           "prompt_len": prompt_len, "max_new": max_new, "completed": len(done),
           "generated": gen, "wall_s": wall, "tokens_per_s": gen / wall,
           "total_tokens_per_s": (gen + n_req * prompt_len) / wall,
           "mean_ttft_ms": statistics.mean(r.t_first - r.t_submit
                                           for r in done) * 1e3,
           "finite_logits": finite[0], "launches": counts,
           "route_launches": routes, "record_launches": by_kernel,
           "shape_launches": shapes, "outs": outs, "page_owners": owners,
           "pages_drawn": sum(len(p) for _, p in owners),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "codec_R": getattr(eng.codec, "R", None),
           # the draft channel's feedback codec's R (none for the copy head)
           "draft_R": (getattr(eng.draft_codec, "R", None)
                       if spec is not None and spec.needs_feedback else None),
           "k_served": dict(eng.k_served), **probe, **info,
           **{k: st[k] for k in ("decode_steps", "prefill_chunks", "dispatches",
                                 "wire_bytes_fwd", "wire_bytes_draft",
                                 "spec_rounds", "spec_accepted", "spec_rejected",
                                 "spec_rollbacks", "evictions", "withdrawn",
                                 "kv_read_execution_mode",
                                 "codec_execution_mode")}}
    check(len(done) == n_req and all(len(o) == budgets[u]
                                     for u, o in outs.items()),
          f"serve {kv_read}: {len(done)} of {n_req} requests, lengths "
          f"{sorted({len(o) for o in outs.values()})}")
    check(rec["finite_logits"], f"serve {kv_read}: non-finite logits")
    if log is not None:
        kept = torch.stack([k for k, _, _ in log]).tolist()
        rec["moe_calls"] = len(log)
        rec["moe_dropped"] = sum(n - k for k, (_, n, _) in zip(kept, log))
    return eng, rec


def check_serve_launches(rec, cfg, quant: bool):
    """The kernel run went through the kernels: the paged kernel (float or
    int8) once per attention layer per decode step, the other one never;
    bind and unbind once per decode step (8 slots / R 4 = 2 groups, one
    launch) and once per prefill chunk (64 positions x 2 groups, one
    launch), all on the FFT route (D = 4096)."""
    name, other = (("paged_attention_quant", "paged_attention") if quant
                   else ("paged_attention", "paged_attention_quant"))
    steps, chunks = rec["decode_steps"], rec["prefill_chunks"]
    got = rec["launches"]
    want = {name: n_attn_layers(cfg) * steps, other: 0,
            "bind_superpose": steps + chunks, "unbind": steps + chunks}
    check(got == want, f"serve launches {got}, want {want} "
          f"({steps} decode steps, {chunks} prefill chunks)")
    check_fft_route(rec["route_launches"], steps + chunks, "serve")
    check(rec["kv_read_execution_mode"] == "cuda-kernel",
          f"kv read ran as {rec['kv_read_execution_mode']}")
    check(rec["codec_execution_mode"] == "cuda-kernel",
          f"codec ran as {rec['codec_execution_mode']}")


def teacher_forced_parity(params, cfg, dev, steps=3) -> dict:
    """Prefill 8 slots (staggered prompt lengths 128 down to 72, a shuffled
    page table) once, copy the cache, then ``steps`` decode steps through
    the kernel read on one copy and the gather read on the other, both fed
    the gather run's greedy tokens.  The logits must agree within
    LOGIT_TOL of max|logit|: the two differ only in the order of the
    attention sums."""
    import torch
    from repro_torch import codecs
    from repro_torch.interop import tree_map
    from repro_torch.models import lm as lm_lib
    from repro_torch.models.paging import PagedLayout
    B, T, ps, C = (SERVE_ENGINE[k] for k in ("num_slots", "max_len",
                                              "page_size", "chunk_size"))
    rng = np.random.RandomState(SEED + 3)
    layout = PagedLayout(ps, T, B * T // ps)
    codec = codecs.build(SERVE_CODEC, D=cfg.d_model)
    cp = codec.init(torch.Generator().manual_seed(SEED), device=dev)
    cache = lm_lib.init_decode_cache(params, cfg, B, T, paged=layout)
    cache["pages"] = torch.from_numpy(
        rng.permutation(B * T // ps).astype(np.int32).reshape(B, -1)).to(dev)
    lens = torch.tensor([max(SERVE_PROMPT - 8 * b, 1) for b in range(B)],
                        device=dev)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, SERVE_PROMPT))).to(dev)
    pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    for c0 in range(0, SERVE_PROMPT, C):
        valid = (c0 + torch.arange(C, device=dev))[None, :] < lens[:, None]
        logits, _ = lm_lib.prefill_chunk(params, cache, toks[:, c0:c0 + C], pos,
                                         cfg, codec=codec, codec_params=cp,
                                         valid=valid, paged=layout)
        pos = pos + valid.sum(-1).to(torch.int32)
    nxt = logits.argmax(-1)[:, None]
    cache_g = tree_map(lambda t: t.clone(), cache)
    live = torch.ones((B,), dtype=torch.bool, device=dev)
    gaps = []
    for _ in range(steps):
        lk, _ = lm_lib.decode_step(params, cache, nxt, pos, cfg, codec=codec,
                                   codec_params=cp, paged=layout, live=live,
                                   kv_read="kernel")
        lg, _ = lm_lib.decode_step(params, cache_g, nxt, pos, cfg, codec=codec,
                                   codec_params=cp, paged=layout, live=live,
                                   kv_read="gather")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lk).all() and torch.isfinite(lg).all()),
              "teacher-forced decode: non-finite logits")
        gaps.append(float((lk - lg).abs().max() / lg.abs().max()))
        nxt = lg[:, -1].argmax(-1)[:, None]
        pos = pos + 1
    del cache, cache_g
    free_cuda()
    check(max(gaps) <= LOGIT_TOL, f"teacher-forced kernel vs gather logits: "
          f"gaps {gaps} of max|logit| > {LOGIT_TOL}")
    return {"steps": steps, "gap_of_max_logit": gaps,
            "prompt_lens": lens.tolist()}


def token_agreement(outs_a: dict, outs_b: dict) -> dict:
    """Share of generated tokens on which two runs agree, position by
    position, and the first decode position where any request differs."""
    same = total = 0
    first = None
    for uid, a in outs_a.items():
        b = outs_b[uid]
        total += len(a)
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        same += len(a) - len(diff)
        if diff:
            first = diff[0] if first is None else min(first, diff[0])
    return {"share_equal": same / total, "first_differing_position": first}


def decode_window_times(eng, windows=3) -> dict:
    """The engine's decode time at a full batch: 8 fresh requests, one
    ``tick()`` to admit and prefill them and warm up, then ``windows`` ticks
    of one decode window each (with their admit/retire boundaries) timed on
    the host clock, each ending in a synchronise; then one tick under
    ``torch.profiler``: the paged kernel's share of device time and the
    device's idle share.  The unit is a decode step, or a verify/commit
    round where the engine speculates.  The engine is drained at the
    end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request
    n = SERVE_ENGINE["sync_every"]
    for u, p in enumerate(serve_prompts(eng.num_slots, eng.cfg.vocab_size)):
        eng.submit(Request(uid=1000 + u, prompt=p,
                           max_new_tokens=(windows + 3) * n))

    def timed_tick():
        s0, r0 = eng.stats["decode_steps"], eng.stats["spec_rounds"]
        t0 = time.perf_counter()
        eng.tick()
        torch.cuda.synchronize()
        steps = eng.stats["decode_steps"] - s0
        rounds = eng.stats["spec_rounds"] - r0
        # a speculative window's decode_steps count the tokens it emitted
        return (time.perf_counter() - t0, rounds or steps,
                steps if rounds else steps * eng.num_slots)

    eng.tick()
    torch.cuda.synchronize()
    per_unit, tokens_per_s = [], []
    for _ in range(windows):
        dt, units, emitted = timed_tick()
        per_unit.append(dt * 1e3 / units)
        tokens_per_s.append(emitted / dt)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dt, executed, _ = timed_tick()
        wall_ms = dt * 1e3
    eng.run()
    unit_ms = statistics.median(per_unit)
    rows, launches, host = {}, 0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            rows[e.key] = rows.get(e.key, 0.0) + e.self_device_time_total / 1e3
            launches += e.count
        elif e.device_type == DeviceType.CPU and e.self_cpu_time_total:
            host.append((e.key, e.self_cpu_time_total / 1e3 / executed,
                         e.count / executed))
    busy = sum(rows.values()) / executed
    out = {"unit": "round" if eng.stats["spec_rounds"] else "decode step",
           "unit_ms": unit_ms, "per_window_unit_ms": per_unit,
           "tokens_per_s_full_batch": statistics.median(tokens_per_s)}
    if not busy:
        out["profile"] = None
        return out
    # the two passes of a paged read: pass 2 is a programmatic dependent of
    # pass 1 and its blocks wait on the card while pass 1 drains, so their
    # kernel times overlap; the read's time is the union of their spans
    paged_names = ("paged_attention_split_kernel", "paged_attention_combine_kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and any(n in e.name for n in paged_names))
    paged, end = 0.0, -math.inf
    for a, b in spans:
        paged += max(0.0, b - max(a, end))
        end = max(end, b)
    paged = paged / 1e3 / executed
    pass_ms = {n: sum(t for k, t in rows.items() if n in k) / executed
               for n in paged_names}
    circ = sum(t for k, t in rows.items() if "bind_superpose_kernel" in k
               or "unbind_kernel" in k) / executed
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:12]
    out["profile"] = {
        "device_ms_per_unit": busy, "wall_ms_per_unit": wall_ms / executed,
        "idle_share_profiled": 1 - busy / (wall_ms / executed),
        "idle_share_vs_unprofiled_unit": 1 - busy / unit_ms,
        "paged_kernel_ms_per_unit": paged, "paged_kernel_share": paged / busy,
        "paged_pass_ms_per_unit": pass_ms,
        "circconv_ms_per_unit": circ, "device_ops_per_unit": launches / executed,
        "top": [{"name": k[:90], "ms_per_unit": t / executed} for k, t in top],
        # host self time by op (profiled, so inflated by the profiler)
        "host_top": [{"name": k[:60], "ms_per_unit": t, "calls_per_unit": c}
                     for k, t, c in sorted(host, key=lambda r: -r[1])[:10]]}
    return out


def print_window(card, what: str, w: dict, top=12):
    """``decode_window_times``' lines for ``what``."""
    u = w["unit"]
    print(f"time [{card}] serve {what} {u} (8 live slots, float32): "
          f"{w['unit_ms']:.3f} ms ({w['tokens_per_s_full_batch']:.1f} tok/s)",
          flush=True)
    if w["profile"] is None:
        print(f"profile [{card}] {what} decode window: the profiler saw no "
              "device time (not measured)")
        return
    wp = w["profile"]
    passes = ", ".join(f"{k} {v:.4f}" for k, v in wp["paged_pass_ms_per_unit"].items())
    print(f"profile [{card}] {what} decode window: device "
          f"{wp['device_ms_per_unit']:.3f} ms/{u}, idle "
          f"{wp['idle_share_vs_unprofiled_unit']:.3f} of the unprofiled {u} "
          f"({wp['idle_share_profiled']:.3f} profiled); paged kernel "
          f"{wp['paged_kernel_ms_per_unit']:.4f} ms/{u} "
          f"({wp['paged_kernel_share']:.4f} of device time; passes {passes} "
          f"overlapping); circconv {wp['circconv_ms_per_unit']:.4f} ms/{u} "
          f"({wp['circconv_ms_per_unit'] / wp['device_ms_per_unit']:.5f} of "
          f"device time); {wp['device_ops_per_unit']:.0f} device ops/{u}",
          flush=True)
    for r in wp["top"][:top]:
        print(f"  {r['ms_per_unit']:.4f} ms/{u}  {r['name']}")
    for r in wp["host_top"][:top]:
        print(f"  host {r['ms_per_unit']:.3f} ms/{u} x{r['calls_per_unit']:.0f}"
              f"  {r['name']}")


def serving_path(dev) -> dict:
    """Phase 4: the float32 run (parity, kernel run, window times and
    profile, gather run), then the bfloat16 / int8-KV run."""
    import torch
    from repro_torch.interop import tree_leaves
    cfg, params = serve_model(torch.float32, dev)
    res = {"arch": SERVE_ARCH, "codec": SERVE_CODEC, "engine": SERVE_ENGINE,
           "n_attn_layers": n_attn_layers(cfg),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params))}
    res["teacher_forced"] = teacher_forced_parity(params, cfg, dev)
    eng, run_k = serve_run(params, cfg, "kernel", SERVE_REQUESTS, SERVE_NEW)
    check_serve_launches(run_k, cfg, quant=False)
    res["cache_bytes"] = eng.cache_bytes
    res["kernel_run"] = run_k
    res["window"] = decode_window_times(eng)
    del eng
    free_cuda()
    eng, run_g = serve_run(params, cfg, "gather", SERVE_REQUESTS, SERVE_NEW)
    check(run_g["kv_read_execution_mode"] == "gather", "gather run mode")
    res["gather_run"] = run_g
    res["agreement"] = token_agreement(run_k["outs"], run_g["outs"])
    del eng, params
    free_cuda()

    cfg_q, params_q = serve_model(torch.bfloat16, dev, quant=True)
    eng, run_q = serve_run(params_q, cfg_q, "kernel", QUANT_REQUESTS, QUANT_NEW)
    check_serve_launches(run_q, cfg_q, quant=True)
    res["quant_run"] = run_q
    del eng, params_q
    free_cuda()
    return res


# --------------------------------------------------------------------------
# phase 13: serving the attention-cache families
# --------------------------------------------------------------------------

def moe_layers(cfg) -> int:
    """The routed MoE sublayers one serving call runs (the first-dense
    superblock's moe sublayers are dense MLPs)."""
    return cfg.num_superblocks * sum(k == "moe" for layer in cfg.block_pattern
                                     for k in layer)


def analytic_cache_bytes(cfg, kv_layout: str) -> int:
    """The float32 cache bytes the engine (or the lockstep loop) must hold,
    from the config alone: per cached position and layer, (kv_lora + rope)
    values for an mla sublayer and K and V (KV heads x head dim) for an attn
    one, the first-dense superblock included, over num_slots x max_len
    positions (contiguous) or the fully provisioned pool's pages x page
    size, plus its int32 page table (paged); per slot and layer, the
    recurrent state on either layout (Mamba's h, d_inner x d_state, and its
    d_conv - 1 conv inputs; RWKV's H x hd x hd wkv and d_model token shift
    a sublayer); and an encoder-decoder model's memory, frontend_seq x
    d_model a slot."""
    B, T, ps = (SERVE_ENGINE[k] for k in ("num_slots", "max_len", "page_size"))
    per = {"mla": (cfg.kv_lora_rank + cfg.qk_rope_dim) * 4,
           "attn": 2 * cfg.num_kv_heads * cfg.head_dim_ * 4}
    hd = cfg.d_model // cfg.num_heads
    state = {"mamba": (cfg.d_state + cfg.d_conv - 1) * cfg.d_inner * 4,
             "rwkv_tm": (cfg.num_heads * hd * hd + cfg.d_model) * 4,
             "rwkv_cm": cfg.d_model * 4}
    kinds = [k for layer in cfg.block_pattern for k in layer]
    layers = cfg.num_superblocks + (1 if cfg.first_dense_layers else 0)
    per_pos = layers * sum(per.get(k, 0) for k in kinds)
    fixed = B * layers * sum(state.get(k, 0) for k in kinds)
    if cfg.is_encdec:
        fixed += B * cfg.frontend_seq * cfg.d_model * 4
    if kv_layout == "contiguous":
        return B * T * per_pos + fixed
    pps = -(-T // ps)
    return B * pps * ps * per_pos + B * pps * 4 + fixed


def check_family_run(rec, cfg):
    """What a phase 13, 14 or 15 engine run must show.  With the forward
    codec at R (G = num_slots / R): bind and unbind once per vanilla decode
    step at (G, R, d_model), once per prefill chunk at (chunk x G, R,
    d_model), twice per speculative round at k (k x G, R, d_model: the
    verify and the commit), and, with a tied draft head, once per round at
    (num_slots / R', R', d_model) for the feedback through the draft
    channel at R'; every one on the FFT route (none direct); none without
    a codec.  The forward wire bytes exactly the vanilla steps' and chunks'
    payloads (float32, G x D a step, chunk x G x D a chunk; nothing in a
    verify round); the draft wire bytes exactly each round's feedback
    payload plus its k - 1 draft ids a slot.  Every routed MoE sublayer
    called once per step, chunk, verify and commit, with no token copy
    dropped; the paged kernel of the cache's dtype once per attn layer per
    vanilla decode step under the kernel read (verify and commit read
    through the gather), the other one never; the codec on the CUDA
    kernels."""
    steps, chunks, rounds = (rec[k] for k in ("decode_steps", "prefill_chunks",
                                              "spec_rounds"))
    vanilla = steps - rec["spec_accepted"]
    C, B = SERVE_ENGINE["chunk_size"], SERVE_ENGINE["num_slots"]
    D, R, Rd = cfg.d_model, rec["codec_R"], rec["draft_R"]
    want = {}

    def add(G, R_, n):
        for name in ("bind_superpose", "unbind"):
            key = f"{name}/{G}x{R_}x{D}"
            want[key] = want.get(key, 0) + n
    wire = 0
    if R is not None:
        G = B // R
        add(C * G, R, chunks)
        add(G, R, vanilla)
        for k, n in rec["k_served"].items():
            add(k * G, R, 2 * n)
        wire = (vanilla * G + chunks * C * G) * D * 4
    if Rd is not None:
        add(B // Rd, Rd, rounds)
    want = dict(sorted((k, n) for k, n in want.items() if n))
    what = f"serve {cfg.name} {rec['kv_read']}"
    check(rec["shape_launches"] == want,
          f"{what}: circconv launches {rec['shape_launches']}, want {want}")
    check_fft_route(rec["route_launches"], sum(want.values()) // 2, what)
    check(rec["wire_bytes_fwd"] == wire,
          f"{what}: wire bytes {rec['wire_bytes_fwd']}, want {wire}")
    tok = 1 if cfg.vocab_size <= 256 else 2 if cfg.vocab_size <= 65536 else 4
    feedback = B // Rd * D * 4 if Rd is not None else 0
    draft = sum(n * (B * (k - 1) * tok + feedback)
                for k, n in rec["k_served"].items())
    check(rec["wire_bytes_draft"] == draft, f"{what}: draft wire bytes "
          f"{rec['wire_bytes_draft']}, want {draft}")
    if cfg.num_experts:
        calls = vanilla + chunks + 2 * rounds
        check(rec["moe_calls"] == moe_layers(cfg) * calls
              and rec["moe_dropped"] == 0,
              f"{what}: {rec['moe_calls']} MoE calls ({moe_layers(cfg)} layers "
              f"x {calls} calls), {rec['moe_dropped']} copies dropped")
    name, other = (("paged_attention_quant", "paged_attention")
                   if cfg.kv_cache_quant else
                   ("paged_attention", "paged_attention_quant"))
    n = n_attn_layers(cfg) * vanilla if rec["kv_read"] == "kernel" else 0
    got = {k: rec["launches"][k] for k in (name, other)}
    check(got == {name: n, other: 0}, f"{what}: paged launches {got}, want "
          f"{ {name: n, other: 0} }")
    if R is not None:
        check(rec["codec_execution_mode"] == "cuda-kernel",
              f"{what}: codec ran as {rec['codec_execution_mode']}")


def profiled_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (device activity only, so
    a call of 100,000 launches is cheap to read back): its device time, the
    device kernels it launched and its wall time (profiled, so inflated by
    the profiler), synchronised."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            busy += e.self_device_time_total / 1e3
            launches += e.count
    return out, {"device_ms": busy, "device_launches": launches,
                 "wall_ms_profiled": wall}


def lm_forward_parity(params, cfg, dev, steps=3, frontend=None,
                      tol=LOGIT_TOL) -> dict:
    """Teacher-forced serving against the training forward on the same
    tokens: 8 rows of staggered prompt lengths (128 down to 72) through
    ``prefill_chunk`` (paged, a shuffled page table), then ``steps``
    ``decode_step`` calls, each fed the next token of each row; every
    call's logits against ``lm_forward``'s at the same positions, within
    ``tol`` of max|logit|.  No codec on either side: the training cut
    groups whole sequences (D = S x d_model), the serving cut slots at one
    position.  An encoder-decoder model's cache and forward read the same
    ``frontend`` frames; a VLM is served text-only, so it is held against
    the text-only forward (no patch embeddings in front).  With experts,
    ``lm_forward`` runs at capacity_factor = num_experts, the serving
    capacity (at the training 1.25 it drops copies and cannot match), and
    each MoE call's routing is kept, so the record counts the (layer, row,
    position) decisions where serving picked other experts than
    ``lm_forward`` (a near-tie in the router that float32 rounding flips),
    the rows they fall in, and the largest gap of the rows with none.
    Times the first prefill chunk (host clock, synchronised) and profiles
    the second: its device time and device kernel count."""
    import torch
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import moe
    from repro_torch.models.paging import PagedLayout
    B, T, ps, C = (SERVE_ENGINE[k] for k in ("num_slots", "max_len",
                                              "page_size", "chunk_size"))
    L, k = moe_layers(cfg), cfg.experts_per_token
    S = SERVE_PROMPT + steps
    rng = np.random.RandomState(SEED + 6)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).to(dev)
    routes, real_route = [], moe.route

    def spy(p, xf, **kw):
        r = real_route(p, xf, **kw)
        routes.append(r["expert_idx"].sort(-1).values)
        return r

    def taken(shape):
        if not L:
            routes.clear()
            return torch.zeros((0, *shape, k), dtype=torch.long, device=dev)
        out = torch.stack(routes).reshape(L, *shape, k)
        routes.clear()
        return out

    fwd_cfg = cfg
    if cfg.num_experts:
        fwd_cfg = dataclasses.replace(fwd_cfg,
                                      capacity_factor=float(cfg.num_experts))
    batch = {"tokens": toks}
    if cfg.is_encdec:
        batch["frontend"] = frontend
    elif cfg.frontend:
        fwd_cfg = dataclasses.replace(fwd_cfg, frontend=None)
    moe.route = spy
    try:
        with torch.no_grad():
            want, _ = lm_lib.lm_forward(params, batch, fwd_cfg, remat=False)
        ref = taken((B, S))
        layout = PagedLayout(ps, T, B * T // ps)
        cache = lm_lib.init_decode_cache(params, cfg, B, T, paged=layout,
                                         frontend_emb=frontend)
        cache["pages"] = torch.from_numpy(
            rng.permutation(B * T // ps).astype(np.int32).reshape(B, -1)).to(dev)
        lens = torch.tensor([max(SERVE_PROMPT - 8 * b, 1) for b in range(B)],
                            device=dev)
        rows = torch.arange(B, device=dev)
        pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        flips = torch.zeros((L, B), dtype=torch.long, device=dev)
        row_gaps, chunk_ms, chunk_prof = [], [], None

        def row_gap(got, want_):
            return (got - want_).abs().amax(-1) / want_.abs().max()

        for c0 in range(0, SERVE_PROMPT, C):
            valid = (c0 + torch.arange(C, device=dev))[None, :] < lens[:, None]

            def chunk():
                return lm_lib.prefill_chunk(params, cache, toks[:, c0:c0 + C],
                                            pos, cfg, valid=valid, paged=layout)
            if c0 == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = chunk()
                torch.cuda.synchronize()
                chunk_ms.append((time.perf_counter() - t0) * 1e3)
            else:
                (logits, _), chunk_prof = profiled_call(chunk)
            flips += ((taken((B, C)) != ref[:, :, c0:c0 + C]).any(-1)
                      & valid).sum(-1)
            pos = pos + valid.sum(-1).to(torch.int32)
        row_gaps.append(row_gap(logits, want[rows, lens - 1]))
        for _ in range(steps):
            lg, _ = lm_lib.decode_step(params, cache, toks[rows, pos][:, None],
                                       pos, cfg, paged=layout)
            flips += (taken((B,)) != ref[:, rows, pos.long()]).any(-1)
            row_gaps.append(row_gap(lg[:, 0], want[rows, pos.long()]))
            pos = pos + 1
    finally:
        moe.route = real_route
    row_gaps = torch.stack(row_gaps)                       # (calls, B)
    flipped = flips.sum(0) > 0
    gaps = row_gaps.amax(-1).tolist()
    clean = row_gaps[:, ~flipped]
    del cache, want
    free_cuda()
    check(max(gaps) <= tol, f"{cfg.name}: served logits vs lm_forward: "
          f"gaps {gaps} of max|logit| > {tol}")
    return {"steps": steps, "gap_of_max_logit": gaps, "tol": tol,
            "routing_flips": int(flips.sum()),
            "rows_with_flips": flipped.nonzero()[:, 0].tolist(),
            "gap_rows_without_flips": (float(clean.max()) if clean.numel()
                                       else None),
            "prefill_chunk_ms": chunk_ms, "prefill_chunk_profile": chunk_prof,
            "prompt_lens": lens.tolist()}


# --------------------------------------------------------------------------
# phase 14: serving the stateful and memory families (and phase 13's
# attention-cache families, through the same serve_family)
# --------------------------------------------------------------------------

def state_frames(cfg, dev, batch=None):
    """Random frames for a modality frontend, from the seed on the card
    (the serve CLI's draw); None without a frontend."""
    import torch
    if not cfg.frontend:
        return None
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return torch.randn((batch or SERVE_ENGINE["num_slots"], cfg.frontend_seq,
                        cfg.frontend_dim), generator=gen, device=dev)


def layer_times(params, cfg, dev, frontend=None) -> dict:
    """One sublayer's serving call at 8 slots on superblock 0's weights and
    a copy of a fresh cache: each recurrent kind's decode step and
    ``cross`` over the memory (its K and V recomputed every call, as in the
    reference), device time and host included; their prefill over a
    64-token chunk (the recurrent kinds' position loop) and an
    encoder-decoder model's encoder at cache init, host included (no sleep
    can hide the host there: thousands of launches, or allocations that
    synchronise).  Empty for a model with none of them."""
    import torch
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import stack as stack_lib
    timed = stack_lib.RECURRENT_KINDS + ("cross",)
    if not any(k in timed for layer in cfg.block_pattern for k in layer):
        return {}
    B, T, C = (SERVE_ENGINE[k] for k in ("num_slots", "max_len", "chunk_size"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {}
    if cfg.is_encdec:
        enc = lambda: lm_lib._run_encoder(params, cfg, frontend,  # noqa: E731
                                          remat=False)
        out["encoder_at_cache_init"] = {
            "ms_host_included": cuda_ms(enc, warmup=1, calls=1, reps=3,
                                        hide_host=False),
            "frames": list(frontend.shape)}
        memory = enc()
    else:
        memory = None
    cache = lm_lib.init_decode_cache(params, cfg, B, T, frontend_emb=frontend)
    pos = torch.full((B,), SERVE_PROMPT, dtype=torch.int32, device=dev)
    live = torch.ones((B,), dtype=torch.bool, device=dev)
    valid = torch.ones((B, C), dtype=torch.bool, device=dev)
    done = set()
    for key, p in stack_lib._index(params["stack"], 0).items():
        kind = key.split("_", 2)[2]
        if kind in done or kind not in timed:
            continue
        done.add(kind)
        c = {n: t.clone() for n, t in stack_lib._index(cache["stack"], 0)[key].items()}
        h1 = torch.randn((B, 1, cfg.d_model), generator=gen, device=dev)
        hC = torch.randn((B, C, cfg.d_model), generator=gen, device=dev)

        def dec(kind=kind, p=p, c=c):
            return stack_lib.apply_sublayer_decode(kind, p, c, cfg, h1, pos,
                                                   memory=memory, live=live)

        def pre(kind=kind, p=p, c=c):
            return stack_lib.apply_sublayer_prefill(kind, p, c, cfg, hC, pos,
                                                    valid, memory=memory)
        out[kind] = {"decode_ms": cuda_ms(dec),
                     "decode_ms_host_included": cuda_ms(dec, hide_host=False),
                     "prefill_chunk_ms_host_included": cuda_ms(
                         pre, warmup=1, calls=1, reps=3, hide_host=False)}
    del cache, memory
    free_cuda()
    return out


def lockstep_run(cfg, dev) -> dict:
    """Run b: ``launch/serve.py`` without ``--engine`` (its own full-width
    weights and frames from the seed, 8 rows, the codec at the stack
    midpoint), counts reset just before and read just after; the CLI's
    lines are kept."""
    import io
    import torch
    from repro_torch.kernels import circconv
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve
    B, T = SERVE_ENGINE["num_slots"], SERVE_ENGINE["max_len"]
    argv = ["--arch", cfg.name, "--device", "cuda", "--batch", str(B),
            "--steps", str(LOCKSTEP_STEPS), "--cache-len", str(T), "--codec",
            SERVE_CODEC, "--greedy", "--seed", str(SEED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    circconv.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    m = re.search(r"decoded (\d+) tokens/seq in ([\d.]+)s \(([\d.]+) tok/s", text)
    wire = re.search(r"cut-layer wire bytes: (\d+)", text)
    rec = {"argv": argv, "cli_lines": text.splitlines(), "wall_s_with_init": wall,
           "decode_steps": LOCKSTEP_STEPS, "prefill_chunks": 0,
           "kv_read": "none (contiguous lockstep)",
           "launches": {**pa.LAUNCHES, **circconv.LAUNCHES},
           "route_launches": route_counts(), "record_launches": record_launches(),
           "shape_launches": {"{}/{}x{}x{}".format(*k): n for k, n in
                              sorted(circconv.SHAPE_LAUNCHES.items())},
           "cli_decode_s": float(m[2]) if m else None,
           "cli_tokens_per_s": float(m[3]) if m else None,
           "wire_bytes_fwd": int(wire[1]) if wire else None,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    G, D = B // 4, cfg.d_model
    want = {f"{n}/{G}x4x{D}": LOCKSTEP_STEPS for n in ("bind_superpose", "unbind")}
    check(m is not None and int(m[1]) == LOCKSTEP_STEPS,
          f"lockstep {cfg.name}: CLI output {text[-300:]!r}")
    check(rec["shape_launches"] == want, f"lockstep {cfg.name}: circconv "
          f"launches {rec['shape_launches']}, want {want}")
    check_fft_route(rec["route_launches"], LOCKSTEP_STEPS, f"lockstep {cfg.name}")
    check(rec["wire_bytes_fwd"] == LOCKSTEP_STEPS * G * D * 4,
          f"lockstep {cfg.name}: wire bytes {rec['wire_bytes_fwd']}")
    check(rec["launches"]["paged_attention"] == 0
          and rec["launches"]["paged_attention_quant"] == 0,
          f"lockstep {cfg.name}: paged launches {rec['launches']}")
    free_cuda()
    return rec


def lockstep_times(params, cfg, dev, frontend, steps=8) -> dict:
    """The lockstep loop's decode step at 8 rows (contiguous cache of 512,
    the codec at the midpoint, position 128 on): the cache with its memory
    (timed: the encoder runs there), 2 warm-up steps, ``steps`` steps on
    the host clock, then one step under ``torch.profiler``: device time,
    idle share, device kernels, top ops; the cache bytes."""
    import torch
    from repro_torch import codecs
    from repro_torch.interop import tree_leaves
    from repro_torch.models import lm as lm_lib
    B, T = SERVE_ENGINE["num_slots"], SERVE_ENGINE["max_len"]
    codec = codecs.build(SERVE_CODEC, D=cfg.d_model)
    cp = codec.init(torch.Generator().manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = lm_lib.init_decode_cache(params, cfg, B, T, frontend_emb=frontend)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)

    def step(t):
        lg, _ = lm_lib.decode_step(params, cache, tok, t, cfg, codec=codec,
                                   codec_params=cp)
        return lg

    for t in range(2):
        step(SERVE_PROMPT + t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        lg = step(SERVE_PROMPT + 2 + t)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    check(bool(torch.isfinite(lg).all()), f"lockstep {cfg.name}: non-finite logits")
    _, prof = profiled_call(lambda: step(SERVE_PROMPT + 2 + steps))
    del cache
    free_cuda()
    return {"cache_init_ms": init_ms, "cache_bytes": cache_bytes,
            "decode_step_ms": step_ms, "tokens_per_s": B / step_ms * 1e3,
            "profile": {**prof, "idle_share_vs_unprofiled_step":
                        1 - prof["device_ms"] / step_ms}}


@dataclasses.dataclass
class ServeRun:
    """One engine run of ``serve_family``'s plan, at phase 4's settings but
    for ``over``; ``drive`` as ``serve_run``'s.  ``against`` names an
    earlier run of the plan (or one passed in ``refs``) whose greedy tokens
    this run's must equal but for near-ties (``near_tie_flips``); with
    ``cache`` the two engines' caches are held together after draining
    (``cache_gaps``).  ``timed``: the engine's decode windows are then
    timed and profiled (``decode_window_times``).  ``expect(rec)`` holds
    the run to what its settings imply beyond ``check_family_run``."""
    key: str
    kv_read: str = "kernel"
    n_req: int = SERVE_REQUESTS
    over: dict = dataclasses.field(default_factory=dict)
    drive: object = None
    against: str | None = None
    cache: bool = False
    timed: bool = False
    expect: object = None


def serve_family(dev, label: str, arch: str, layers, small=False,
                 quant=False, plan=None, refs=None) -> dict:
    """Phases 13, 14 and 15 for one arch at phase 4's settings: full width,
    its depth cut to ``layers`` (None: its own), or at ``reduced()`` size
    with ``small``.  Every model: served logits against ``lm_forward``
    (within STATE_LOGIT_TOL with a recurrent sublayer, LOGIT_TOL without),
    its recurrent and cross sublayers' times, its cache bytes against
    ``analytic_cache_bytes``.  An encoder-decoder model: the engine's
    refusal, then the lockstep loop through the serve CLI and its times.
    Any other, through the engine: with an attn sublayer, phase 4's
    teacher-forced kernel-against-gather logits; without one,
    kv_read="kernel" refused.  Then the ``plan`` of ``ServeRun``s (by
    default with an attn sublayer the kernel and gather reads, paged, and
    with ``small`` the gather read on the contiguous layout; without one
    the gather read on both layouts; the first run timed), then with
    ``quant`` bfloat16 weights over int8 KV through the int8 kernel.  Each
    run held by ``check_family_run``, by the pages it drew (each
    admission's reservation where an attn or mla cache is paged, else
    none) and by its ``against`` and ``expect``; paged and contiguous
    greedy tokens equal."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.models.stack import RECURRENT_KINDS
    t0 = time.perf_counter()
    cfg, params = serve_model(torch.float32, dev, arch=arch, layers=layers,
                              small=small)
    kinds = {k for layer in cfg.block_pattern for k in layer}
    fe = state_frames(cfg, dev)
    res = {"label": label, "arch": arch, "reduced": small,
           "layers": [cfg.num_layers, get_config(arch).num_layers],
           "d_model": cfg.d_model, "n_attn_layers": n_attn_layers(cfg),
           "moe_layers": moe_layers(cfg),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params))}
    tol = STATE_LOGIT_TOL if kinds & set(RECURRENT_KINDS) else LOGIT_TOL
    res["lm_forward"] = lm_forward_parity(params, cfg, dev, frontend=fe, tol=tol)
    res["layer_times"] = layer_times(params, cfg, dev, frontend=fe)
    runs = res["runs"] = {}
    if cfg.is_encdec:
        try:
            make_engine(params, cfg, "gather")
        except ValueError as e:
            res["engine_refused"] = str(e)
        check("engine_refused" in res, f"{arch}: the engine served an "
              "encoder-decoder model")
        res["lockstep_times"] = lockstep_times(params, cfg, dev, fe)
        want = analytic_cache_bytes(cfg, "contiguous")
        check(res["lockstep_times"]["cache_bytes"] == want, f"{arch}: cache "
              f"bytes {res['lockstep_times']['cache_bytes']}, want {want}")
        del params, fe
        free_cuda()
        runs["lockstep"] = lockstep_run(cfg, dev)
        res["seconds"] = time.perf_counter() - t0
        return res
    del fe
    contiguous = dict(kv_layout="contiguous")
    if n_attn_layers(cfg):
        res["teacher_forced"] = teacher_forced_parity(params, cfg, dev)
        default = [ServeRun("kernel_paged", timed=True),
                   ServeRun("gather_paged", "gather")]
        if small:
            default.append(ServeRun("gather_contiguous", "gather", over=contiguous))
    else:
        try:
            make_engine(params, cfg, "kernel")
        except ValueError as e:
            res["kernel_read_refused"] = str(e)
        check("kernel_read_refused" in res,
              f"{arch}: kv_read='kernel' without an attn sublayer did not raise")
        default = [ServeRun("gather_paged", "gather", timed=True),
                   ServeRun("gather_contiguous", "gather", over=contiguous)]
    plan = plan or default
    yardsticks = {p.against for p in plan}
    keep = {p.against for p in plan if p.cache}
    known, kept, run_cfg = dict(refs or {}), {}, {}
    for p in plan:
        eng, rec = serve_run(params, cfg, p.kv_read, p.n_req, SERVE_NEW,
                             drive=p.drive, gaps=p.key in yardsticks, **p.over)
        runs[p.key] = known[p.key] = rec
        run_cfg[p.key] = cfg
        res.setdefault(f"cache_bytes_{eng.kv_layout}", eng.cache_bytes)
        if p.against is not None:
            ref = known[p.against]
            rec["flips"] = near_tie_flips(f"{label} {p.key}", rec, ref,
                                          ref if "gaps" in ref else rec)
            if p.cache:
                rec["cache"] = cache_gaps(kept.pop(p.against), eng, ref, rec)
        if p.expect is not None:
            p.expect(rec)
        if p.timed:
            res["window"] = decode_window_times(eng)
        if p.key in keep:
            kept[p.key] = eng
        del eng
        free_cuda()
    for layout in ("paged", "contiguous"):
        if f"cache_bytes_{layout}" in res:
            got, want = (res[f"cache_bytes_{layout}"],
                         analytic_cache_bytes(cfg, layout))
            check(got == want, f"{arch} {layout}: cache bytes {got}, want {want}")
    if "kernel_paged" in runs:
        res["agreement"] = token_agreement(runs["kernel_paged"]["outs"],
                                           runs["gather_paged"]["outs"])
    if "gather_contiguous" in runs:
        check(runs["gather_paged"]["outs"] == runs["gather_contiguous"]["outs"],
              f"{arch}: greedy tokens differ between paged and contiguous")
    del params, kept
    free_cuda()
    if quant and n_attn_layers(cfg):
        cfg_q, params = serve_model(torch.bfloat16, dev, quant=True, arch=arch,
                                    layers=layers, small=small)
        eng, runs["quant_paged"] = serve_run(params, cfg_q, "kernel",
                                             QUANT_REQUESTS, QUANT_NEW)
        run_cfg["quant_paged"] = cfg_q
        del eng, params
        free_cuda()
    ps = SERVE_ENGINE["page_size"]
    for key, rec in runs.items():
        check_family_run(rec, run_cfg[key])
        admissions = rec["requests"] + rec["evictions"] + rec["withdrawn"]
        want = (admissions * -(-(SERVE_PROMPT + rec["max_new"]) // ps)
                if rec["kv_layout"] == "paged" and kinds & {"attn", "mla"}
                else 0)
        check(rec["pages_drawn"] == want, f"{arch} {key}: "
              f"{rec['pages_drawn']} pages drawn, want {want}")
    res["seconds"] = time.perf_counter() - t0
    return res


def print_serve_family(card, res):
    arch, runs, lf = res["arch"], res["runs"], res["lm_forward"]
    size = ("REDUCED (reduced())" if res["reduced"] else
            f"full width, {res['layers'][0]} of {res['layers'][1]} layers")
    pc = lf["prefill_chunk_profile"] or {}
    print(f"{res['label']}: serving {arch} {size}, float32, {SERVE_CODEC}: "
          f"params {res['param_bytes'] / 1e9:.2f} GB, {res['n_attn_layers']} attn "
          f"and {res['moe_layers']} MoE layers; teacher-forced served logits vs "
          f"lm_forward gap {max(lf['gap_of_max_logit']):.3g} of max|logit| "
          f"(limit {lf['tol']}); {lf['routing_flips']} routing decisions "
          f"flipped, in rows {lf['rows_with_flips']}; gap of the other rows "
          f"{lf['gap_rows_without_flips']}", flush=True)
    for key, what in (("engine_refused", "engine"),
                      ("kernel_read_refused", "kv_read='kernel'")):
        if key in res:
            print(f"  {what} refused: {res[key][:100]}")
    if "teacher_forced" in res:
        print(f"  teacher-forced kernel vs gather logit gap "
              f"{max(res['teacher_forced']['gap_of_max_logit']):.3g} of "
              "max|logit|")
    if "agreement" in res:
        ag = res["agreement"]
        print(f"  greedy tokens kernel vs gather {ag['share_equal']:.4f} equal, "
              f"first difference at {ag['first_differing_position']}")
    if "gather_contiguous" in runs:
        print("  greedy tokens paged == contiguous: True")
    for k in ("cache_bytes_paged", "cache_bytes_contiguous"):
        if k in res:
            print(f"  {k} {res[k]} (analytic)")
    for key, r in runs.items():
        moe = (f"MoE calls {r['moe_calls']}, dropped {r['moe_dropped']}; "
               if "moe_calls" in r else "")
        print(f"  serve {key}: {r.get('completed', '8 lockstep')} requests, "
              f"{r['decode_steps']} decode steps, {r['prefill_chunks']} prefill "
              f"chunks; circconv {r['shape_launches']}; paged "
              f"{ {k: r['launches'][k] for k in ('paged_attention', 'paged_attention_quant')} }; "
              f"{moe}pages drawn {r.get('pages_drawn', 0)}; wire "
              f"{r['wire_bytes_fwd']:,d} B (exact)", flush=True)
        if r.get("spec_rounds"):
            tried = r["spec_accepted"] + r["spec_rejected"]
            print(f"    spec rounds {r['spec_rounds']} accepted "
                  f"{r['spec_accepted']} rejected {r['spec_rejected']} rollbacks "
                  f"{r['spec_rollbacks']} (acceptance "
                  f"{r['spec_accepted'] / max(tried, 1):.3f}), k served "
                  f"{r['k_served']}, draft wire {r['wire_bytes_draft']:,d} B "
                  "(exact)", flush=True)
        if r.get("evictions") or r.get("withdrawn"):
            print(f"    evictions {r['evictions']} ({r['evicted_requests']} "
                  f"requests), withdrawn {r['withdrawn_request']}, {r['ticks']} "
                  f"ticks, pool whole after each; {r['stream_bursts']} stream "
                  "bursts joined into every output", flush=True)
        if "flips" in r:
            f = r["flips"]
            print(f"    tokens vs the yardstick: {f['differing']} requests "
                  f"differ, {len(f['flips'])} near-tie flips {f['flips']}, "
                  f"{len(f['cascades'])} group cascades", flush=True)
        if "cache" in r:
            print(f"    cache vs the yardstick's: {r['cache']}", flush=True)
    for key, r in runs.items():
        if key == "lockstep":
            print(f"time [{card}] serve {arch} lockstep CLI 8 rows x "
                  f"{r['decode_steps']} steps: {r['cli_decode_s']:.3f} s "
                  f"({r['cli_tokens_per_s']:.1f} tok/s), peak "
                  f"{r['peak_gb']:.1f} GB", flush=True)
            continue
        print(f"time [{card}] serve {arch} {key} {r['requests']}x({SERVE_PROMPT}+"
              f"{r['max_new']}): {r['wall_s']:.3f} s, {r['tokens_per_s']:.1f} "
              f"generated tok/s, mean TTFT {r['mean_ttft_ms']:.1f} ms, peak "
              f"{r['peak_gb']:.1f} GB", flush=True)
    print(f"time [{card}] serve {arch} prefill chunk (8 x 64, no codec) "
          f"{', '.join(f'{t:.1f}' for t in lf['prefill_chunk_ms'])} ms; "
          f"profiled chunk: device {pc.get('device_ms', math.nan):.3f} ms, "
          f"{pc.get('device_launches', 0)} device kernels, wall "
          f"{pc.get('wall_ms_profiled', math.nan):.1f} ms (profiled)", flush=True)
    if "lockstep_times" in res:
        lt = res["lockstep_times"]
        print(f"time [{card}] serve {arch} lockstep decode step (8 rows, "
              f"float32): {lt['decode_step_ms']:.3f} ms "
              f"({lt['tokens_per_s']:.1f} tok/s); cache with memory "
              f"{lt['cache_init_ms']:.1f} ms, {lt['cache_bytes']} B (analytic); "
              f"profiled step device {lt['profile']['device_ms']:.3f} ms, idle "
              f"{lt['profile']['idle_share_vs_unprofiled_step']:.3f}, "
              f"{lt['profile']['device_launches']} device kernels", flush=True)
    if "window" in res:
        print_window(card, arch, res["window"], top=8)
    for kind, t in res["layer_times"].items():
        if kind == "encoder_at_cache_init":
            print(f"time [{card}] {arch} encoder over {t['frames']} frames at "
                  f"cache init: {t['ms_host_included']:.3f} ms host included",
                  flush=True)
            continue
        print(f"time [{card}] {arch} {kind} one sublayer at 8 slots: decode "
              f"{t['decode_ms']:.4f} ms ({t['decode_ms_host_included']:.4f} host "
              f"included); prefill chunk of 64 "
              f"{t['prefill_chunk_ms_host_included']:.3f} ms host included",
              flush=True)
    print(f"serving {arch}: phase seconds {res['seconds']:.1f}", flush=True)


# --------------------------------------------------------------------------
# phase 15: serving II (speculative decoding, preemption, the legacy mode)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def vanilla_gaps(eng):
    """Within the block, every ``decode_step`` the engine calls records, on
    the device, each row's top-2 logit gap over max|logit| with the uid its
    slot holds and its position.  Yields a dict that holds, on exit,
    ``gaps`` {uid: {output index: gap}} (the first live record of each
    decoded token; index = position - prompt length + 1), ``gap_steps``
    {uid: {output index: the decode step, counted over the run, that
    produced it}} and ``groups`` {uid: the uids of its codec group (slots
    i // R alike)}."""
    from repro_torch.models import lm as lm_lib
    import torch
    orig, recs = lm_lib.decode_step, []
    R = getattr(eng.codec, "R", 1)

    def probed(*a, **kw):
        out = orig(*a, **kw)
        top = out[0][:, -1].float().topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]) / out[0][:, -1].abs().amax(-1)
        recs.append(([s.req.uid if s.req else None for s in eng.slots],
                     [len(s.req.prompt) if s.req else 0 for s in eng.slots],
                     torch.stack([a[3].to(torch.float32), gap])))
        return out

    res = {"gaps": {}, "gap_steps": {}, "groups": {}}
    lm_lib.decode_step = probed
    try:
        yield res
    finally:
        lm_lib.decode_step = orig
        if recs:
            host = torch.stack([r[2] for r in recs]).cpu().numpy()
            for step, ((uids, plens, _), (pos, gap)) in enumerate(zip(recs, host)):
                for i, u in enumerate(uids):
                    if u is None:
                        continue
                    t = int(pos[i]) - plens[i] + 1
                    if t not in res["gaps"].setdefault(u, {}):
                        res["gaps"][u][t] = float(gap[i])
                        res["gap_steps"].setdefault(u, {})[t] = step
                    res["groups"].setdefault(u, sorted(
                        {uids[j] for j in range(len(uids)) if j // R == i // R}
                        - {u, None}))


def near_tie_flips(what: str, rec: dict, ref: dict, gapped: dict) -> dict:
    """``rec``'s greedy tokens against the yardstick ``ref``'s, uid by uid,
    with the vanilla gaps of ``gapped`` (a run recorded by
    ``vanilla_gaps``).  A request that differs passes only if, at its first
    differing output index, the vanilla top-2 gap is under NEAR_TIE (a
    flip), or a partner in its codec group flipped at an earlier decode
    step (the group's superposition changed from that step on)."""
    outs, want = rec["outs"], ref["outs"]
    gaps, steps = gapped["gaps"], gapped["gap_steps"]
    firsts = {}
    for uid, o in outs.items():
        w = want[uid]
        check(len(o) == len(w), f"{what}: uid {uid} has {len(o)} tokens, "
              f"want {len(w)}")
        d = next((i for i, (a, b) in enumerate(zip(o, w)) if a != b), None)
        if d is not None:
            firsts[uid] = d
    tie = {u: gaps.get(u, {}).get(d, math.inf) < NEAR_TIE
           for u, d in firsts.items()}
    flips, cascades = [], []
    for uid, d in sorted(firsts.items()):
        g = gaps.get(uid, {}).get(d)
        if tie[uid]:
            flips.append({"uid": uid, "index": d, "gap": g})
            continue
        at = steps.get(uid, {}).get(d, -1)
        partner = [p for p in gapped["groups"].get(uid, ())
                   if tie.get(p) and steps[p][firsts[p]] < at]
        check(partner, f"{what}: uid {uid} differs from the yardstick at output "
              f"index {d} where the vanilla top-2 gap is {g} of max|logit| "
              f"(limit {NEAR_TIE}), and no codec-group partner flipped at an "
              "earlier step")
        cascades.append({"uid": uid, "index": d, "after": partner})
    return {"differing": len(firsts), "flips": flips, "cascades": cascades}


def cache_gaps(a, b, rec_a: dict, rec_b: dict) -> dict:
    """Engine ``b``'s cache against engine ``a``'s after both drained
    (``rec_a`` recorded by ``vanilla_gaps``): integer leaves equal, float
    leaves within CACHE_TOL of each leaf's max|value|.  Where the runs'
    tokens differ, the float leaves are held on the pages whose last
    admission (the same in both runs) belongs to a codec group in which no
    request's tokens differ."""
    import torch
    from repro_torch.interop import tree_leaves
    last_a = {pg: u for u, pages in rec_a["page_owners"] for pg in pages}
    last_b = {pg: u for u, pages in rec_b["page_owners"] for pg in pages}
    check(last_a == last_b, "spec cache: the runs admitted requests into "
          "different pages")
    dirty = {u for u, o in rec_b["outs"].items() if o != rec_a["outs"][u]}
    dirty |= {p for u in dirty for p in rec_a["groups"].get(u, ())}
    n_pages = a.pool_accounting()["total"]
    clean = [pg for pg in range(n_pages) if last_a.get(pg) not in dirty]
    idx = torch.tensor(clean, device=a.device)
    worst, exact = 0.0, 0
    for x, y in zip(tree_leaves(a.cache), tree_leaves(b.cache)):
        if not x.dtype.is_floating_point:
            check(torch.equal(x, y), "spec cache: an integer leaf differs")
            exact += 1
            continue
        if dirty:
            axis = list(x.shape).index(n_pages)
            x, y = x.index_select(axis, idx), y.index_select(axis, idx)
        scale = float(x.abs().max()) or 1.0
        worst = max(worst, float((x - y).abs().max()) / scale)
    check(worst <= CACHE_TOL, f"spec cache: {worst} of max|value| from the "
          f"vanilla cache (limit {CACHE_TOL})")
    return {"float_gap_of_max": worst, "integer_leaves_equal": exact,
            "pages_compared": len(clean), "pages": n_pages}


def preemption_drive(eng, prompts):
    """Twelve priority-0 requests, then, after the first ``tick()``, four
    priority-1 ones; after the third tick one running priority-0 request is
    withdrawn and resubmitted.  The pool is whole after every tick; the
    stream events, joined per uid, equal each output with no gap."""
    from repro_torch.serving.engine import Request
    for u in range(PREEMPT_LOW):
        eng.submit(Request(uid=u, prompt=prompts[u], max_new_tokens=SERVE_NEW))
    events, ticks, withdrawn = [], 0, None
    while eng.tick():
        ticks += 1
        acct = eng.pool_accounting()
        check(acct["free"] + acct["in_use"] == acct["total"]
              and sum(len(s.pages) for s in eng.slots) == acct["in_use"],
              f"preemption: pool not whole after tick {ticks}: {acct}")
        events += eng.pop_stream_events()
        if ticks == 1:
            for u in range(PREEMPT_LOW, PREEMPT_LOW + PREEMPT_HIGH):
                eng.submit(Request(uid=u, prompt=prompts[u],
                                   max_new_tokens=SERVE_NEW, priority=1))
        if ticks == 3:
            victim = next(s.req.uid for s in eng.slots
                          if s.req is not None and s.req.priority == 0)
            req = eng.withdraw(victim)
            withdrawn = {"uid": victim, "emitted": len(req.out)}
            eng.submit(req)
        check(ticks < 2000, "preemption: the engine did not drain")
    events += eng.pop_stream_events()
    check(eng.pool_accounting()["free"] == PREEMPT_PAGES, "preemption: pages "
          f"leaked: {eng.pool_accounting()}")
    done = eng.finished
    for r in done:
        joined = []
        for u, start, toks in events:
            if u == r.uid:
                check(start == len(joined), f"preemption: uid {r.uid} stream "
                      f"gap at {len(joined)} (burst starts at {start})")
                joined += toks
        check(joined == r.out, f"preemption: uid {r.uid} streamed {len(joined)} "
              f"tokens that differ from its output")
    return done, {"ticks": ticks, "stream_bursts": len(events),
                  "withdrawn_request": withdrawn,
                  "evicted_requests": sum(r.evictions > 0 for r in done)}


def serving_ii_plan() -> list:
    """Phase 15's runs (see the module docstring)."""
    from repro_torch.serving.spec import SpecConfig
    spec = dict(codec=SPEC_LINK, spec_decode=SpecConfig(k=SPEC_K,
                                                        draft_head="tied"))
    copy = dict(codec=SPEC_LINK, spec_decode=SpecConfig(
        k=SPEC_K, draft_head="copy", adaptive=True))

    def pinned(rec):
        check(rec["spec_rounds"] > 0
              and rec["k_served"] == {SPEC_K: rec["spec_rounds"]},
              f"phase 15a: rounds {rec['spec_rounds']}, k {rec['k_served']}")

    def speculated(rec):
        check(rec["spec_rounds"] > 0, "phase 15b: no speculative round")

    def preempted(rec):
        check(rec["evictions"] > 0 and rec["withdrawn"] == 1,
              f"phase 15c: evictions {rec['evictions']}, withdrawn "
              f"{rec['withdrawn']}")

    def legacy(rec):
        check(rec["prefill_chunks"] == 0 and rec["decode_steps"]
              == SERVE_PROMPT + SERVE_NEW - 1, f"phase 15d: "
              f"{rec['decode_steps']} legacy steps, {rec['prefill_chunks']} "
              "chunks")
    return [ServeRun("vanilla", against="phase4"),
            ServeRun("spec_tied", over=spec, against="vanilla", cache=True,
                     timed=True, expect=pinned),
            ServeRun("spec_copy_adaptive", over=copy, against="vanilla",
                     expect=speculated),
            # preemption without the codec: rows independent, so outputs are
            # a function of the prompt alone
            ServeRun("vanilla_no_codec", over=dict(codec="none")),
            ServeRun("preemption", over=dict(codec="none", num_pages=PREEMPT_PAGES,
                                             preemption=True),
                     drive=preemption_drive, against="vanilla_no_codec",
                     expect=preempted),
            ServeRun("legacy", n_req=LEGACY_REQUESTS,
                     over=dict(prefill_mode="decode"), against="vanilla",
                     expect=legacy)]


# --------------------------------------------------------------------------
# phase 16: the networked front door (repro_torch.frontdoor) over loopback
# --------------------------------------------------------------------------

def door_hooks(eng):
    """Record each Request the door submits to ``eng`` (by uid; a resumed
    request is the same object) and each ``tick()``'s wall seconds (a tick
    ends in a host read, so its wall time is its own)."""
    reqs, ticks = {}, []
    submit, tick = eng.submit, eng.tick

    def submitted(req):
        submit(req)
        reqs[req.uid] = req

    def timed():
        t0 = time.perf_counter()
        try:
            return tick()
        finally:
            ticks.append(time.perf_counter() - t0)
    eng.submit, eng.tick = submitted, timed
    return reqs, ticks


def door_books(what: str, st: dict, server, ticks, strict=True) -> dict:
    """What a door run must leave in ``st`` (STATS at its end, before the
    server stops): no admission unit held, the pool whole, no tick error;
    with ``strict`` no session detached and the longest tick under the
    server's heartbeat deadline (heartbeat_s x max_misses)."""
    acct = st["engine"]["pool"]
    check(server.tick_error is None, f"{what}: the tick loop died: "
          f"{server.tick_error!r}")
    check(st["admission"]["inflight_total"] == 0,
          f"{what}: admission holds {st['admission']}")
    check(acct["free"] == acct["total"] and acct["in_use"] == 0,
          f"{what}: pool not whole: {acct}")
    check(not strict or st["sessions"]["detached"] == 0,
          f"{what}: sessions {st['sessions']}")
    limit = server.heartbeat_s * server.max_misses
    check(not strict or max(ticks) < limit, f"{what}: longest tick "
          f"{max(ticks):.3f} s, past the heartbeat deadline {limit} s")
    return {"ticks": len(ticks), "longest_tick_s": max(ticks),
            "heartbeat_deadline_s": limit, "sessions": st["sessions"]}


def door_staged_drive(tenants: int, draft=None):
    """16a and 16d: ``tenants`` clients stage every prompt in order (tenant
    t the t-th share) with ``auto_tick=False``, so the engine's queue is a
    direct run's, then the server drains.  Every RESULT equals the engine's
    output for its uid, the TOKENS bursts joined equal it with no gap, and
    STATS carries the engine's counters.  With ``draft`` the clients pin
    it, a client pinning WRONG_DRAFT is refused at the handshake, and the
    RESULTs' spec counters sum to the engine's."""
    from repro_torch.frontdoor import (FrontDoorClient, FrontDoorError,
                                       FrontDoorServer)

    def drive(eng, prompts):
        reqs, ticks = door_hooks(eng)

        async def go():
            server = FrontDoorServer(eng, auto_tick=False)
            host, port = await server.start()
            clients = [await FrontDoorClient.open(
                host, port, tenant=f"tenant-{t}", codec=SERVE_CODEC, draft=draft)
                for t in range(tenants)]
            share = -(-len(prompts) // tenants)
            rids = []
            for i, p in enumerate(prompts):
                c = clients[i // share]
                rids.append((c, await c.submit(p, max_new=SERVE_NEW)))
            refused = None
            if draft is not None:
                try:
                    await FrontDoorClient.open(host, port, tenant="wrong-draft",
                                               codec=SERVE_CODEC, draft=WRONG_DRAFT)
                except FrontDoorError as e:
                    refused = str(e)
            await server.drain()
            results = [await c.result(r) for c, r in rids]
            stats = await clients[0].stats()
            for c in clients:
                await c.close()
            end = server.stats()
            await server.stop(drain=False)
            return server, results, stats, end, refused

        server, results, stats, end, refused = asyncio.run(go())
        what = f"door staged ({tenants} tenants)"
        books = door_books(what, end, server, ticks)
        check(sorted(reqs) == list(range(len(prompts))), f"{what}: uids "
              f"{sorted(reqs)}")
        for uid, res in enumerate(results):
            check(res["tokens"] == reqs[uid].out, f"{what}: uid {uid} RESULT "
                  "differs from the engine's output")
            check(res["streamed"] == res["tokens"], f"{what}: uid {uid} "
                  f"streamed {len(res['streamed'])} tokens, not its output")
        est = stats["engine"]
        for k in ("wire_bytes_fwd", "wire_bytes_draft", "decode_steps",
                  "prefill_chunks", "spec_rounds"):
            check(est[k] == eng.stats[k], f"{what}: STATS {k} {est[k]}, the "
                  f"engine's {eng.stats[k]}")
        spec = {k: sum(r[k] for r in results)
                for k in ("accepted", "rejected", "rollbacks")}
        check([spec[k] for k in ("accepted", "rejected", "rollbacks")]
              == [eng.stats[f"spec_{k}"] for k in ("accepted", "rejected",
                                                   "rollbacks")],
              f"{what}: RESULT spec counters {spec}, the engine's "
              f"{ {k: eng.stats[k] for k in eng.stats if k.startswith('spec_')} }")
        if draft is not None:
            check(refused is not None and "draft-channel mismatch" in refused,
                  f"{what}: a client pinning {WRONG_DRAFT!r} was not refused "
                  f"({refused!r})")
        door = {**books, "tenants": tenants, "result_spec": spec,
                "stats_wire_bytes_fwd": est["wire_bytes_fwd"],
                "refused": refused, "hello_draft": draft}
        return [reqs[u] for u in sorted(reqs)], {"door": door}
    return drive


async def door_probe(host, port, prompts) -> dict:
    """One request at a time on an otherwise idle engine: the client's
    TTFT (``submit`` to its first TOKENS frame) against the engine's
    (RESULT's ``ttft_s``: engine submit to first token), the STATS round
    trip, and the host time to encode and decode one RESULT frame."""
    from repro_torch.frontdoor import FrontDoorClient, protocol
    first = {}
    c = await FrontDoorClient.open(
        host, port, tenant="probe", codec=SERVE_CODEC,
        on_tokens=lambda rid, toks: first.setdefault(rid, time.perf_counter()))
    client, engine = [], []
    for p in prompts:
        t0 = time.perf_counter()
        rid = await c.submit(p, max_new=DOOR_NEW)
        out = await c.result(rid)
        client.append(first[rid] - t0)
        engine.append(out["ttft_s"])
    rtt = []
    for _ in range(DOOR_STATS_CALLS):
        t0 = time.perf_counter()
        await c.stats()
        rtt.append(time.perf_counter() - t0)
    await c.close()
    hdr, payload = protocol.pack_array(np.arange(SERVE_NEW, dtype=np.int32))
    header = {"rid": 0, "ttft_s": 0.5, "ttlt_s": 1.5, "evictions": 0,
              "accepted": 0, "rejected": 0, "rollbacks": 0, **hdr}
    t0 = time.perf_counter()
    for _ in range(DOOR_FRAME_CALLS):
        protocol.decode_frame(protocol.encode_frame(
            protocol.MsgType.RESULT, header, payload, seq=1)[4:])
    frame_us = (time.perf_counter() - t0) / DOOR_FRAME_CALLS * 1e6
    added = [a - b for a, b in zip(client, engine)]
    return {"client_ttft_ms": [t * 1e3 for t in client],
            "engine_ttft_ms": [t * 1e3 for t in engine],
            "added_ttft_ms": [t * 1e3 for t in added],
            "stats_rtt_ms_median": statistics.median(rtt) * 1e3,
            "result_frame_codec_us": frame_us}


def door_tenants_drive(eng, prompts):
    """16b: the probe, then DOOR_TENANTS tenants of DOOR_REQUESTS
    concurrent ``generate`` calls each against ``TenantPolicy(max_inflight
    = DOOR_INFLIGHT)`` and ``max_queue_depth = DOOR_QUEUE``, with
    ``auto_tick=True`` and the server's default heartbeats: every request
    completes through BUSY retries."""
    from repro_torch.frontdoor import (AdmissionController, FrontDoorClient,
                                       FrontDoorServer, TenantPolicy)
    reqs, ticks = door_hooks(eng)

    async def tenant(host, port, name, ps):
        c = await FrontDoorClient.open(host, port, tenant=name, codec=SERVE_CODEC)
        outs = await asyncio.gather(*(c.generate(p, max_new=DOOR_NEW)
                                      for p in ps))
        await c.close()
        return outs

    async def go():
        server = FrontDoorServer(eng, admission=AdmissionController(
            max_queue_depth=DOOR_QUEUE,
            default_policy=TenantPolicy(max_inflight=DOOR_INFLIGHT)))
        host, port = await server.start()
        probe = await door_probe(host, port, prompts[:DOOR_PROBES])
        rest = prompts[DOOR_PROBES:]
        t0 = time.perf_counter()
        outs = await asyncio.gather(*(
            tenant(host, port, f"tenant-{t}",
                   rest[t * DOOR_REQUESTS:(t + 1) * DOOR_REQUESTS])
            for t in range(DOOR_TENANTS)))
        wall = time.perf_counter() - t0
        st = server.stats()
        await server.stop()
        return server, outs, probe, wall, st

    server, outs, probe, wall, st = asyncio.run(go())
    what = "phase 16b"
    books = door_books(what, st, server, ticks)
    check(all(len(o["tokens"]) == DOOR_NEW and o["streamed"] == o["tokens"]
              for t in outs for o in t), f"{what}: an output is short or its "
          "TOKENS differ from it")
    busy = sum(t["busy_rejections"] for t in st["tenants"].values())
    check(busy > 0, f"{what}: no SUBMIT was shed with BUSY")
    check(all(t["disconnects"] == 0 for t in st["tenants"].values()),
          f"{what}: a tenant was disconnected: {st['tenants']}")
    tenants = {name: {"requests": t["requests"], "busy": t["busy_rejections"],
                      "ttft_p50_ms": t["ttft_s"]["p50"] * 1e3,
                      "ttft_p99_ms": t["ttft_s"]["p99"] * 1e3,
                      "tokens_per_s_p50": t["tokens_per_s"]["p50"],
                      "bytes_in": t["bytes_in"], "bytes_out": t["bytes_out"]}
               for name, t in st["tenants"].items()}
    door = {**books, "busy": busy, "tenants": tenants, "probe": probe,
            "tenants_wall_s": wall,
            "tenants_tokens_per_s": DOOR_TENANTS * DOOR_REQUESTS * DOOR_NEW / wall}
    return [reqs[u] for u in sorted(reqs)], {"door": door}


def door_chaos_drive(faults, sanitize=False):
    """16c: the selfcheck's sequential run (3 tenants, one request in
    flight at a time) with ``faults``, the door's engine at phase 4's
    settings, DOOR_CHAOS_REQUESTS requests a tenant of DOOR_PROMPT +
    DOOR_NEW; 18d: the same with the selfcheck's ``--sanitize`` tier
    armed (its report under "sanitize")."""
    from repro_torch.frontdoor import selfcheck

    def drive(eng, prompts):
        reqs, ticks = door_hooks(eng)
        got, server = asyncio.run(selfcheck._sequential_run(
            eng, DOOR_CHAOS_REQUESTS, faults, codec=SERVE_CODEC,
            prompt_len=DOOR_PROMPT, max_new=DOOR_NEW, sanitize=sanitize))
        st = got.pop("_stats")
        report = got.pop("_sanitize", None)
        tokens = {name: got[name] for name, _ in selfcheck.CHAOS_TENANTS}
        # the last tenant's STATS, taken with its requests delivered; this
        # run's heartbeats are the selfcheck's (0.2 s x 10), and a tick past
        # them, or a BYE lost to the faults, only costs a detach and resume
        books = door_books("phase 16c", st, server, ticks, strict=False)
        recovered = {k: sum(t[k] for t in st["tenants"].values())
                     for k in ("retransmits", "nacks", "resumes", "disconnects")}
        door = {**books, "tokens": tokens, "recovered": recovered,
                "streamed": got["_streamed"],
                "injected": None if faults is None else repr(faults)}
        info = {"door": door}
        if report is not None:
            info["sanitize"] = report
        return [reqs[u] for u in sorted(reqs)], info
    return drive


def door_cli() -> dict:
    """16e: ``python -m repro_torch.launch.serve --arch deepseek-7b
    --reduced --frontdoor --port 0 --codec "c3sl:R=4|int8"`` on the card:
    its address line, CLI_REQUESTS requests and a STATS through a port
    client, then SIGINT: its closing line and exit code 0.  A timer kills
    it past DOOR_CLI_TIMEOUT_S."""
    import signal
    import threading
    from repro_torch.frontdoor import FrontDoorClient
    spec = "c3sl:R=4|int8"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           SERVE_ARCH, "--reduced", "--frontdoor", "--port", "0", "--codec", spec]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT),
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    killer = threading.Timer(DOOR_CLI_TIMEOUT_S, proc.kill)
    killer.start()
    try:
        line = proc.stdout.readline()
        up = time.perf_counter() - t0
        found = re.search(r"front door on ([\d.]+):(\d+) ", line)
        check(found is not None, f"phase 16e: no address line: {line!r} "
              f"{proc.stderr.read()[-2000:] if proc.poll() is not None else ''}")

        async def go():
            c = await FrontDoorClient.open(found[1], int(found[2]),
                                           tenant="cli", codec=spec)
            outs = [await c.generate([1, 2, 3, 4 + i], max_new=8)
                    for i in range(DOOR_CLI_REQUESTS)]
            stats = await c.stats()
            await c.close()
            return outs, stats

        outs, stats = asyncio.run(asyncio.wait_for(go(), DOOR_CLI_TIMEOUT_S))
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    closing = re.search(r"\[serve\] front door stopped; engine stats: "
                        r"dispatches=(\d+) .*", out)
    check(proc.returncode == 0 and closing is not None,
          f"phase 16e: exit {proc.returncode}, closing line "
          f"{closing[0] if closing else None!r}; stderr {err[-2000:]}")
    check([len(o["tokens"]) for o in outs] == [8] * DOOR_CLI_REQUESTS
          and stats["tenants"]["cli"]["requests"] == DOOR_CLI_REQUESTS
          and int(closing[1]) == stats["engine"]["dispatches"] > 0,
          f"phase 16e: outputs {[len(o['tokens']) for o in outs]}, STATS "
          f"{stats['tenants'].get('cli')}, closing {closing[0]!r}")
    return {"address_line": line.strip(), "closing_line": closing[0],
            "returncode": proc.returncode, "seconds_to_address": up,
            "seconds": time.perf_counter() - t0,
            "codec": stats["engine"]["codec"],
            "codec_execution_mode": stats["engine"]["codec_execution_mode"]}


def frontdoor_phase(dev, rk) -> dict:
    """Phase 16 (see the module docstring): deepseek-7b at full width and
    depth through the door at phase 4's settings.  Each engine run is a
    ``serve_run`` driven through the door, held by ``check_family_run``."""
    import torch
    from repro_torch.frontdoor import selfcheck
    from repro_torch.serving.spec import SpecConfig
    t0 = time.perf_counter()
    cfg, params = serve_model(torch.float32, dev)
    runs = {}
    _, runs["a_staged"] = serve_run(params, cfg, "kernel", SERVE_REQUESTS,
                                    SERVE_NEW, drive=door_staged_drive(2),
                                    gaps=True)
    a = runs["a_staged"]
    a["flips"] = near_tie_flips("phase 16a", a, rk, a)
    free_cuda()
    _, runs["b_tenants"] = serve_run(
        params, cfg, "kernel", DOOR_PROBES + DOOR_TENANTS * DOOR_REQUESTS,
        DOOR_NEW, drive=door_tenants_drive, prompt_len=DOOR_PROMPT)
    free_cuda()
    for key, faults in (("c_fault_free", None), ("c_chaos", selfcheck.chaos_plan())):
        _, runs[key] = serve_run(
            params, cfg, "kernel", len(selfcheck.CHAOS_TENANTS) * DOOR_CHAOS_REQUESTS,
            DOOR_NEW, drive=door_chaos_drive(faults), prompt_len=DOOR_PROMPT)
        free_cuda()
    free, chaos = runs["c_fault_free"]["door"], runs["c_chaos"]["door"]
    check(chaos["tokens"] == free["tokens"], "phase 16c: chaos tokens differ "
          f"from the fault-free run's: {chaos['tokens']} vs {free['tokens']}")
    recovered = sum(chaos["recovered"][k] for k in ("retransmits", "nacks",
                                                    "resumes"))
    check(recovered > 0, f"phase 16c: nothing recovered: {chaos['recovered']}")
    spec = dict(codec=SPEC_LINK, spec_decode=SpecConfig(k=SPEC_K, draft_head="tied"))
    _, runs["d_spec"] = serve_run(params, cfg, "kernel", DOOR_SPEC_REQUESTS,
                                  SERVE_NEW, drive=door_staged_drive(
                                      1, draft=SPEC_DRAFT_PIN), **spec)
    d = runs["d_spec"]
    d["flips"] = near_tie_flips("phase 16d", d, a, a)
    check(d["spec_rounds"] > 0 and d["k_served"] == {SPEC_K: d["spec_rounds"]},
          f"phase 16d: rounds {d['spec_rounds']}, k {d['k_served']}")
    del params
    free_cuda()
    for rec in runs.values():
        check_family_run(rec, cfg)
    cli = door_cli()
    return {"runs": runs, "cli": cli, "seconds": time.perf_counter() - t0}


def print_frontdoor(card, res):
    runs = res["runs"]
    print(f"phase 16: the front door, {SERVE_ARCH} full width, "
          f"{SERVE_CODEC}, kernel read, loopback", flush=True)
    for key, r in runs.items():
        d = r["door"]
        print(f"  door {key}: {r['completed']} requests of {r['prompt_len']}+"
              f"{r['max_new']}, {r['decode_steps']} decode steps, "
              f"{r['prefill_chunks']} prefill chunks; circconv "
              f"{r['shape_launches']}; paged "
              f"{ {k: r['launches'][k] for k in ('paged_attention', 'paged_attention_quant')} }; "
              f"wire {r['wire_bytes_fwd']:,d} B fwd + {r['wire_bytes_draft']:,d} B "
              f"draft (exact); {d['ticks']} ticks, longest "
              f"{d['longest_tick_s']:.3f} s", flush=True)
        if "flips" in r:
            f = r["flips"]
            print(f"    tokens vs the direct run: {f['differing']} requests "
                  f"differ, {len(f['flips'])} near-tie flips {f['flips']}, "
                  f"{len(f['cascades'])} group cascades", flush=True)
        if key == "d_spec":
            print(f"    spec rounds {r['spec_rounds']}, RESULT counters "
                  f"{d['result_spec']} = the engine's; a client pinning "
                  f"{WRONG_DRAFT!r} refused: {d['refused'][:90]}", flush=True)
        if "recovered" in d:
            print(f"    recovery {d['recovered']}, {d['streamed']} tokens "
                  "streamed", flush=True)
    b = runs["b_tenants"]["door"]
    print(f"  door b_tenants: BUSY {b['busy']}, longest tick "
          f"{b['longest_tick_s']:.3f} s (deadline {b['heartbeat_deadline_s']} "
          f"s), sessions {b['sessions']}", flush=True)
    for name, t in b["tenants"].items():
        print(f"time [{card}] door tenant {name}: {t['requests']} requests, "
              f"BUSY {t['busy']}, TTFT p50 {t['ttft_p50_ms']:.1f} ms p99 "
              f"{t['ttft_p99_ms']:.1f} ms (engine side), decode "
              f"{t['tokens_per_s_p50']:.1f} tok/s p50 a request, bytes in "
              f"{t['bytes_in']:,d} out {t['bytes_out']:,d}", flush=True)
    p = b["probe"]
    print(f"time [{card}] door probe, one request at a time ({DOOR_PROMPT}+"
          f"{DOOR_NEW}): client TTFT "
          f"{', '.join(f'{t:.1f}' for t in p['client_ttft_ms'])} ms, engine "
          f"TTFT {', '.join(f'{t:.1f}' for t in p['engine_ttft_ms'])} ms, the "
          f"door's added {', '.join(f'{t:.2f}' for t in p['added_ttft_ms'])} "
          f"ms; STATS round trip {p['stats_rtt_ms_median']:.3f} ms (median); "
          f"a RESULT frame encoded and decoded {p['result_frame_codec_us']:.1f} "
          "us (host)", flush=True)
    print(f"time [{card}] door b_tenants {DOOR_TENANTS}x{DOOR_REQUESTS}x("
          f"{DOOR_PROMPT}+{DOOR_NEW}): {b['tenants_wall_s']:.3f} s, "
          f"{b['tenants_tokens_per_s']:.1f} generated tok/s", flush=True)
    for key, r in runs.items():
        print(f"time [{card}] door {key}: {r['wall_s']:.3f} s, "
              f"{r['tokens_per_s']:.1f} generated tok/s, mean TTFT "
              f"{r['mean_ttft_ms']:.1f} ms (engine side), longest tick "
              f"{r['door']['longest_tick_s']:.3f} s", flush=True)
    c = res["cli"]
    print(f"  door CLI: {c['address_line']!r} after "
          f"{c['seconds_to_address']:.1f} s; {DOOR_CLI_REQUESTS} requests and "
          f"STATS served ({c['codec']}, {c['codec_execution_mode']}); "
          f"{c['closing_line']!r}, exit {c['returncode']}", flush=True)
    print(f"front door: phase seconds {res['seconds']:.1f}", flush=True)


# --------------------------------------------------------------------------
# phase 5: the codec control plane
# --------------------------------------------------------------------------

def cp_link(spec: str, B: int):
    from repro_torch import transport
    return transport.build_link(spec, D=2048).with_max_R(B)


def cp_payload_shapes(rf: int, rb: int, B: int) -> tuple:
    """(G, R) of the forward payload and of the gradient payload of the
    (R_fwd, R_bwd) program at batch B: the bwd codec regroups the gradient
    payload's B/R_fwd rows."""
    return (B // rf, rf), (B // rf // rb, rb)


def cp_kernel_shapes() -> list:
    """(G, R, D) of every bind/unbind that CP_LINK's (R_fwd, R_bwd)
    programs launch at the paper's batch, at both paper cuts' D (phase 2
    checks each against the plain versions)."""
    from repro_torch.configs.paper import VGG16_CIFAR10 as cfg
    link = cp_link(CP_LINK, cfg.batch_size)
    return sorted({(G, R, D) for D in (2048, 4096)
                   for rf in link.fwd.codec.ladder for rb in link.bwd.codec.ladder
                   for G, R in cp_payload_shapes(rf, rb, cfg.batch_size)})


def cp_step_table(link, link_params, loss_fn, opt, made: list):
    """One train step per (R_fwd, R_bwd) pair, through
    ``build_link_program_table``; ``made`` counts the calls of ``make``."""
    from repro_torch.models import convnets
    from repro_torch.transport import (build_link_program_table,
                                       make_split_loss_fn,
                                       make_split_train_step)

    def make(static, static_params):
        made.append(static.spec())
        loss = make_split_loss_fn(convnets.vgg16_front, convnets.vgg16_back,
                                  static, loss_fn, with_metrics=True)
        step = make_split_train_step(loss, opt)

        def run(net, opt_state, batch, erasure=None):
            p, opt_state, l, m = step({"net": net, "codec": static_params},
                                      opt_state, batch, bwd_probe=True,
                                      erasure=erasure)
            return p["net"], opt_state, l, m
        return {"static": static, "run": run}
    return build_link_program_table(link, link_params, make)


def cp_parity(dev) -> dict:
    """Step 0 of one asymmetric pair through the kernels against the same
    step through ``backend=fft`` on the card (same weights, keys and
    batch): loss rtol 1e-4, every gradient leaf and the gradient at the cut
    within 1e-3 of its max (phase 3's step-0 tolerances), the two SNRs
    within 1e-3 dB."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.paper import VGG16_CIFAR10 as cfg
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.models import convnets
    from repro_torch.transport import (build_link, make_split_loss_fn,
                                       split_value_and_grad)
    rf, rb = CP_PARITY_PAIR
    net = convnets.init_vgg16(torch.Generator().manual_seed(SEED),
                              n_classes=cfg.n_classes, device=dev)
    batch = SyntheticImageDataset(n_classes=cfg.n_classes, seed=SEED).batch(
        cfg.batch_size, 0, device=dev)
    res = {}
    for backend in ("pallas", "fft"):
        link = build_link(f"c3sl:R={rf},backend={backend} >> "
                          f"bwd:c3sl:R={rb},backend={backend}", D=cfg.D)
        cut = []

        def front(p, x):
            z = convnets.vgg16_front(p, x)
            z.register_hook(cut.append)
            return z
        loss = make_split_loss_fn(front, convnets.vgg16_back, link,
                                  F.cross_entropy, with_metrics=True)
        params = {"net": net, "codec": link.init(
            torch.Generator().manual_seed(SEED), device=dev)}
        res[backend] = (*split_value_and_grad(loss, params, batch,
                                              bwd_probe=True), cut[0])
    torch.cuda.synchronize()
    (lk, gk, mk, ck), (lf, gf, mf, cf) = res["pallas"], res["fft"]
    out = {"pair": [rf, rb], "loss_kernel": float(lk), "loss_fft": float(lf),
           "loss_rel_err": abs(float(lk) - float(lf)) / abs(float(lf)),
           "grad_leaf_rel_err": leaf_rel_err(gk, gf),
           "cut_grad_rel_err": float((ck - cf).abs().max() / cf.abs().max()),
           "cut_snr": [float(mk["cut_snr"]), float(mf["cut_snr"])],
           "bwd_snr": [float(mk["bwd_snr"]), float(mf["bwd_snr"])]}
    check(out["loss_rel_err"] <= 1e-4, f"control plane step-0 loss {out}")
    check(out["grad_leaf_rel_err"] <= 1e-3 and out["cut_grad_rel_err"] <= 1e-3,
          f"control plane step-0 grads {out}")
    check(abs(out["cut_snr"][0] - out["cut_snr"][1]) <= 1e-3
          and abs(out["bwd_snr"][0] - out["bwd_snr"][1]) <= 1e-3,
          f"control plane step-0 SNRs {out}")
    return out


def cp_launch_shapes(served: dict, B: int) -> dict:
    """Launches by (G, R) that the served (R_fwd, R_bwd) pairs imply, for
    bind and for unbind alike: per step, each at the forward payload twice
    (encode and decode, and each one's backward) and at the gradient
    payload once."""
    from collections import Counter
    shapes = Counter()
    for (rf, rb), n in served.items():
        fwd, grad = cp_payload_shapes(rf, rb, B)
        shapes[fwd] += 2 * n
        shapes[grad] += n
    return {f"{g}x{r}": n for (g, r), n in sorted(shapes.items())}


def cp_counted_shapes() -> dict:
    """The launches counted by (G, R, D) since the last reset, by kernel:
    {name: {"GxR" or "GxRxD": count}} (D only where it is not 2048)."""
    from repro_torch.kernels import circconv
    out = {name: {} for name in circconv.LAUNCHES}
    for (name, G, R, D), n in sorted(circconv.SHAPE_LAUNCHES.items()):
        out[name][f"{G}x{R}" + ("" if D == 2048 else f"x{D}")] = n
    return out


def control_plane(dev) -> dict:
    """Phase 5 (a) and (b): the Adaptive-R asymmetric link ``CP_LINK`` on
    the VGG-16 train step (B 64, Adam 1e-4), clamped to the batch.  Every
    (R_fwd, R_bwd) pair runs one step pinned, then the controllers run
    free, fed the cut SNR and the probe's gradient SNR (read with the loss
    in one transfer a step, the only sync); then the same link under a
    ``drop`` FaultPlan with erasure recovery on both directions.  Launch
    counts are reset just before the steps and read just after."""
    import torch
    import torch.nn.functional as F
    from collections import Counter
    from repro_torch import faults
    from repro_torch.configs.paper import VGG16_CIFAR10 as cfg
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.kernels import circconv
    from repro_torch.models import convnets
    from repro_torch.optim import adam
    from repro_torch.transport import link_program_key, split_comm_bytes

    B = cfg.batch_size
    link = cp_link(CP_LINK, B)
    made = []
    opt = adam(cfg.lr)
    link_params = link.init(torch.Generator().manual_seed(SEED), device=dev)
    table = cp_step_table(link, link_params, F.cross_entropy, opt, made)
    n_pairs = len(link.fwd.codec.ladder) * len(link.bwd.codec.ladder)
    check(len(made) == len(table) == n_pairs == 12,
          f"control plane: make ran {len(made)} times for {len(table)} entries")
    net = convnets.init_vgg16(torch.Generator().manual_seed(SEED),
                              n_classes=cfg.n_classes, device=dev)
    opt_state = opt.init({"net": net})
    data = SyntheticImageDataset(n_classes=cfg.n_classes, seed=SEED)
    n_steps = n_pairs + CP_FREE_STEPS + CP_FAULT_STEPS
    batches = [data.batch(B, s, device=dev) for s in range(n_steps)]
    served, steps, wire_checked = Counter(), [], 0
    torch.cuda.synchronize()
    circconv.reset_launch_counts()

    def one(batch, erasure=None, phase="free"):
        nonlocal net, opt_state, wire_checked
        key = link_program_key(link)
        entry = table[key]
        net, opt_state, loss, m = entry["run"](net, opt_state, batch, erasure)
        # the one host transfer of the step
        l, cut, bwd = torch.stack([loss, m["cut_snr"], m["bwd_snr"]]).tolist()
        wire = link.wire_bytes_fwd(B) + link.wire_bytes_bwd(B)
        check(wire == split_comm_bytes(entry["static"], B),
              f"control plane wire bytes {wire} for {key}")
        wire_checked += 1
        served[key] += 1
        steps.append({"phase": phase, "R": list(key), "loss": l,
                      "cut_snr": cut, "bwd_snr": bwd, "wire_bytes": wire})
        check(math.isfinite(l), f"control plane {phase} step loss {l} at {key}")
        return cut, bwd

    it = iter(batches)
    for rf, rb in table:                             # (a) every pair, pinned
        link.fwd.codec.pin(rf)
        link.bwd.codec.pin(rb)
        check(link_program_key(link) == (rf, rb), "pin")
        one(next(it), phase="pinned")
    for ctl in (link.fwd.codec, link.bwd.codec):     # back to the start
        ctl.pin(ctl.min_R).unpin()
    observed = []
    for _ in range(CP_FREE_STEPS):                   # (a) free
        observed.append(one(next(it)))
        link.observe(*observed[-1])

    # (b) faults: both directions drop packets, the decode renormalises
    plan = faults.FaultPlan(seed=SEED, rates=CP_FAULT_RATES, schedule={
        d: {s: faults.FaultEvent("drop", 1.0)} for d, s in CP_FAULT_BURSTS.items()})

    def install(lnk):
        for ch in (lnk.fwd, lnk.bwd):
            ch.install_faults(plan, faults.RecoveryPolicy(
                mode="erasure", retry_budget=CP_FAULT_BUDGET[ch.direction]))
    install(link)
    erased_at, retransmitted_at, erased_packets = [], [], 0
    for s in range(CP_FAULT_STEPS):
        batch = next(it)
        try:
            masks, info = link.next_erasure(B)
        except faults.ChannelErasure:
            erased_at.append(s)
            observed.append(None)
            continue
        if any(i["attempts"] > 1 for i in info.values() if i):
            retransmitted_at.append(s)
        erased_packets += sum(i["erased_packets"] for i in info.values() if i)
        erasure = {k: torch.from_numpy(v).to(dev) for k, v in masks.items()}
        observed.append(one(batch, erasure, phase="faults"))
        link.observe(*observed[-1])
    torch.cuda.synchronize()
    counts = dict(circconv.LAUNCHES)
    routes, by_kernel = route_counts(), record_launches()
    by_shape = cp_counted_shapes()
    check(len(made) == 12, f"control plane: make ran again ({len(made)})")

    # the host's replay of the plan: a fresh link fed the same observations
    replay = cp_link(CP_LINK, B)
    for obs in observed[:CP_FREE_STEPS]:
        replay.observe(*obs)
    install(replay)
    replayed = 0
    for obs in observed[CP_FREE_STEPS:]:
        try:
            replay.next_erasure(B)
        except faults.ChannelErasure:
            replayed += 1
            continue
        if obs is not None:
            replay.observe(*obs)
    check(len(erased_at) == replayed,
          f"ChannelErasure {erased_at} on the card vs {replayed} replayed")
    # what the schedule alone predicts: a burst loses every packet of its
    # first transmission, more than erasure recovery accepts; a direction
    # with no resend left raises at its burst, one with a resend retransmits
    # (the 10% rate alone stays under the accepted half)
    want_erased = sorted(s for d, s in CP_FAULT_BURSTS.items()
                         if CP_FAULT_BUDGET[d] == 0)
    want_resent = sorted(s for d, s in CP_FAULT_BURSTS.items()
                         if CP_FAULT_BUDGET[d] > 0)
    check(erased_at == want_erased and want_erased,
          f"ChannelErasure at fault steps {erased_at}, predicted {want_erased}")
    check(set(want_resent) <= set(retransmitted_at) and want_resent,
          f"retransmitted at fault steps {retransmitted_at}, predicted "
          f"at least {want_resent}")
    executed = sum(served.values())
    check_fft_route(routes, 3 * executed, "control plane")
    check(set(served) == set(table), f"pairs served {sorted(served)}")
    implied = cp_launch_shapes(served, B)
    check(all(by_shape[name] == implied for name in by_shape),
          f"control plane launches by shape {by_shape}, implied {implied}")
    return {"link": link.spec(), "pairs": [list(k) for k in table],
            "make_calls": len(made), "steps": steps, "executed": executed,
            "served": {f"{rf},{rb}": n for (rf, rb), n in sorted(served.items())},
            "wire_checked": wire_checked, "launches": counts,
            "route_launches": routes, "record_launches": by_kernel,
            "launches_by_shape": by_shape,
            "faults": {"rates": CP_FAULT_RATES, "bursts": CP_FAULT_BURSTS,
                       "retry_budget": CP_FAULT_BUDGET,
                       "erased_at": erased_at, "replayed_erasures": replayed,
                       "retransmitted_at": retransmitted_at,
                       "erased_packets": erased_packets}}


def cp_masked_decode_bitwise(dev) -> dict:
    """(b) The masked decode through the kernels at an all-ones mask is
    bitwise the decode, at every forward bucket and every backward one."""
    import torch
    from repro_torch import codecs
    out = {}
    gen = torch.Generator().manual_seed(SEED + 3)
    for R, rows in ((2, 64), (4, 64), (8, 64), (16, 64), (1, 4), (2, 4), (4, 4)):
        c = codecs.build(f"c3sl:R={R},D=2048,backend=pallas")
        p = c.init(device=dev)
        payload = c.encode(p, torch.randn((rows, 2048), generator=gen).to(dev))
        a = c.decode(p, payload)
        b = c.decode_masked(p, payload, torch.ones_like(payload))
        out[f"R{R}/rows{rows}"] = bool(torch.equal(a, b))
    check(all(out.values()), f"masked decode at all ones not bitwise: {out}")
    return out


@contextlib.contextmanager
def cudnn_defaults():
    """PyTorch's own cuDNN settings (TF32 convolutions, nondeterministic
    algorithms allowed) instead of the comparison settings of this run."""
    import torch
    b = torch.backends.cudnn
    saved = (b.allow_tf32, b.deterministic)
    b.allow_tf32, b.deterministic = True, False
    try:
        yield
    finally:
        b.allow_tf32, b.deterministic = saved


def device_top(fn, n=6) -> list:
    """``torch.profiler``'s self device time of ``fn``'s kernels, by name
    (the largest ``n``), ms a call over 10 calls; [] where the profiler
    sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return [{"name": k[:80], "ms": t, "calls": c}
            for k, t, c in device_rows(prof, 10)[:n]]


def device_rows(prof, n_calls: int) -> list:
    """(kernel name, self device ms a call, launches a call) of a
    ``torch.profiler`` run over ``n_calls`` calls, largest first: device-side
    events only (an op's own event repeats its kernels' time)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3 / n_calls, e.count // n_calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return sorted(rows, key=lambda r: -r[1])


def cp_table2(dev) -> dict:
    """(c) Table 2 on the card at both paper cuts, B 64: BottleNet++
    against C3-SL (the kernels), R 4 each.  The codec's parameter bytes
    resident on the card, and its device time per train step (encode +
    decode forward, and their backward: the input's gradient, and the
    params' for BottleNet++) in this run's comparison settings (float32,
    deterministic cuDNN) and in PyTorch's defaults (TF32 convolutions),
    beside the analytic param_count / flops ratios; and where
    BottleNet++'s device time goes."""
    import torch
    from repro_torch import codecs
    from repro_torch.configs.paper import RESNET50_CIFAR100, VGG16_CIFAR10
    from repro_torch.interop import tree_leaves
    out = {}
    for cfg in (VGG16_CIFAR10, RESNET50_CIFAR100):
        C, H, W = cfg.cut_shape
        B = cfg.batch_size
        row = {}
        for name, spec in (("bnpp", "bnpp:R=4"),
                           ("c3sl", "c3sl:R=4,backend=pallas")):
            c = codecs.build(spec, D=cfg.D, C=C, H=H, W=W)
            p = c.init(torch.Generator().manual_seed(SEED), device=dev)
            shape = (B, C, H, W) if c.feature_layout == "nchw" else (B, cfg.D)
            gen = torch.Generator().manual_seed(SEED + 4)
            Z = torch.randn(shape, generator=gen).to(dev).requires_grad_()
            G = torch.randn(shape, generator=gen).to(dev)
            trains = [t.requires_grad_() for t in tree_leaves(p)
                      if getattr(c, "trainable", False)]

            def fwd_bwd(c=c, p=p, Z=Z, G=G, trains=trains):
                zhat = c.decode(p, c.encode(p, Z))
                return torch.autograd.grad(zhat, [Z, *trains], G)
            row[name] = {
                "spec": c.spec(),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in tree_leaves(p)),
                "param_count": c.param_count(), "flops": c.flops(B),
                "ms": cuda_ms(fwd_bwd)}
            with cudnn_defaults():
                row[name]["ms_tf32"] = cuda_ms(fwd_bwd)
            row[name]["top"] = device_top(fwd_bwd)
        b, h = row["bnpp"], row["c3sl"]
        row["ratios"] = {
            "param_bytes": b["param_bytes"] / h["param_bytes"],
            "param_count": b["param_count"] / h["param_count"],
            "ms": b["ms"] / h["ms"], "ms_tf32": b["ms_tf32"] / h["ms_tf32"],
            "flops": b["flops"] / h["flops"]}
        out[cfg.name] = row
    return out


def cp_bnpp_resnet(dev) -> dict:
    """(c) BottleNet++ trains: ResNet-50/CIFAR-100 through ``bnpp:R=4`` for
    CP_BNPP_STEPS steps (finite losses), and the codec's gradients at step
    0 are nonzero on every weight and BatchNorm leaf (the conv biases in
    front of a BatchNorm have an exact gradient of 0)."""
    import torch
    from repro_torch.optim import adam
    from repro_torch.transport import (make_split_train_step,
                                       split_value_and_grad, trainable_params)
    cfg, codec, params, loss, data = make_setup("resnet50", "bnpp:R=4", dev)
    batches = [data.batch(cfg.batch_size, s, device=dev)
               for s in range(CP_BNPP_STEPS)]
    _, g0, _ = split_value_and_grad(loss, params, batches[0])
    gmax = {k: float(v.abs().max()) for k, v in g0["codec"].items()}
    check(all(v > 0 for k, v in gmax.items() if k not in ("b_enc", "b_dec")),
          f"bnpp codec grads {gmax}")
    opt = adam(cfg.lr)
    state = opt.init(trainable_params(loss, params))
    step = make_split_train_step(loss, opt)
    losses = []
    for b in batches:
        params, state, l, _ = step(params, state, b)
        losses.append(l)
    losses = torch.stack(losses).tolist()
    check(all(map(math.isfinite, losses)), f"resnet50 bnpp losses {losses}")
    return {"spec": codec.spec(), "losses": losses, "codec_grad_max": gmax}


# --------------------------------------------------------------------------
# phase 6: times
# --------------------------------------------------------------------------

def circconv_operands(G, R, D, dev, seed=SEED + 1):
    """Keys, their spectrum, Kext, the four-step kernels' key spectra (None
    off that route), Z (G, R, D) and S (G, D), float32."""
    import torch
    from repro_torch.core import hrr
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(seed)
    K = hrr.generate_keys(gen, R, D, device=dev)
    Z = torch.randn((G, R, D), generator=gen).to(dev)
    S = torch.randn((G, D), generator=gen).to(dev)
    return (K, hrr.key_spectrum(K), *ops._keys(K), Z, S)


def circconv_bound(name, G, R, D) -> dict:
    """The least work of bind or unbind at (G, R, D) in float32, whatever
    the algorithm: Z or S, the keys K (R, D) and the output each cross HBM
    once, and the operations are the FFT form's (rfft of every data row and
    key, one complex multiply-add per frequency and binding, an irfft per
    output row; a real transform of length D at 2.5 D log2 D).  The direct
    O(D^2) form (2 G R D^2 FLOPs) is kept beside it as a design figure."""
    flops = (G * R + G + R) * 2.5 * D * math.log2(D) + G * R * (D // 2 + 1) * 8
    x, out = (G * R * D, G * D) if name == "bind_superpose" else (G * D, G * R * D)
    nbytes = (x + R * D + out) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    direct_flops = 2 * G * R * D * D
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "direct_flops": direct_flops,
            "direct_flops_ms": direct_flops / F32_PEAK_FLOPS * 1e3}


def circconv_calls(G, R, D, dev):
    """name -> (data, route entry point, plain version, torch.fft route) of
    bind and unbind at (G, R, D), and the Kext the plain versions take.  The
    entry point ``on(route)`` runs the named route's kernel on the data, the
    four-step one with the keys' spectra made beforehand (as ``ops`` keeps
    them)."""
    from repro_torch.core import hrr
    from repro_torch.kernels import circconv
    K, KF, kext, spectra, Z, S = circconv_operands(G, R, D, dev)

    def entry(fn, x):
        return lambda r: fn(r, x, kext, spectra if r == "fft4" else None)

    return {"bind_superpose": (Z, entry(circconv._bind_superpose_on, Z),
                               circconv.bind_superpose_plain,
                               lambda: hrr._bind_impl(Z, K, KF, "fft")),
            "unbind": (S, entry(circconv._unbind_on, S), circconv.unbind_plain,
                       lambda: hrr._unbind_impl(S, K, KF, "fft"))}, kext


def kernel_times(dev, G, R, D) -> dict:
    """bind and unbind at (G, R, D): the kernel ``route(D)`` picks (``ms``,
    also host included), the FFT kernel where D is a power of two it takes,
    the direct kernel, the plain version and the torch.fft route."""
    from repro_torch.kernels import circconv
    calls, kext = circconv_calls(G, R, D, dev)
    kernel_route = circconv.route(D)
    out = {}
    for name, (x, on, plain, fft) in calls.items():
        by_route = {r: cuda_ms_scaled(lambda r=r: on(r))
                    for r in dict.fromkeys((kernel_route, "direct"))}
        out[name] = {
            "shape": [G, R, D], "route": kernel_route,
            "ms": by_route[kernel_route],
            "ms_host_included": cuda_ms(lambda: on(kernel_route), hide_host=False),
            "fft_ms": by_route.get("fft"), "direct_ms": by_route["direct"],
            "plain_ms": cuda_ms_scaled(lambda: plain(x, kext)),
            "library_ms": cuda_ms(fft),
            **circconv_bound(name, G, R, D),
        }
    del calls, kext
    free_cuda()
    return out


def fft4_times(dev) -> dict:
    """bind and unbind on the four-step route at the LM training shapes
    LM_SHAPES: the kernel (device time, and host included), the torch.fft
    route of the same function (the library yardstick, with the keys'
    spectrum made beforehand, as the kernels' is), the bound, one build of
    the keys' spectra (made once per key tensor, not per call), and the
    direct kernel, one call a side.  The plain version's O(D^2) gather is
    out of reach there (terabytes), so it is timed at the largest shape
    phase 2 holds it at, (2, 4, 65536), in fewer runs, host included; each
    shape's record carries that figure."""
    from repro_torch.kernels import circconv
    out = {}
    for G, R, D in LM_SHAPES:
        calls, kext = circconv_calls(G, R, D, dev)
        p = circconv.plan(D)

        spectra_ms = cuda_ms(lambda: circconv.key_spectra(kext, p), warmup=2,
                             calls=1, reps=5)
        for name, (x, on, _, fft) in calls.items():
            passes = device_top(lambda: on("fft4"), n=4)
            out[f"{name}/{G}x{R}x{D}"] = {
                "passes": [{"name": (re.search(r"\w+_kernel", t["name"])
                                     or [t["name"][:40]])[0], "ms": t["ms"]}
                           for t in passes],
                "shape": [G, R, D], "route": "fft4", "sides": list(p.sides),
                "ms": cuda_ms(lambda: on("fft4")),
                "ms_host_included": cuda_ms(lambda: on("fft4"), hide_host=False),
                "library_ms": cuda_ms(fft),
                "key_spectra_ms": spectra_ms,
                "direct_one_call_ms": cuda_ms(lambda: on("direct"), warmup=0,
                                              calls=1, reps=1, hide_host=False),
                **circconv_bound(name, G, R, D)}
        del calls, kext
        free_cuda()
    G, R, D = (2, 4, 65536)
    calls, kext = circconv_calls(G, R, D, dev)
    for name, (x, _, plain, _) in calls.items():
        # host included: its chunked gather is a Python loop of hundreds
        # of launches, which outlasts the sleep that hides the host
        plain_ms = cuda_ms(lambda: plain(x, kext), warmup=1, calls=1, reps=3,
                           hide_host=False)
        for key, t in out.items():
            if key.startswith(name + "/"):
                t["plain_shape"], t["plain_ms"] = [G, R, D], plain_ms
    return out


# phase 6's paged shapes: the serving run's decode read (8 slots, positions
# spread over 128-160) and one live slot with the whole cache admitted, at
# deepseek-7b's geometry (KV = H = 32), and the serving read at
# phi3.5-moe-42b-a6.6b's and pixtral-12b's (32 heads over KV 8) and at
# reduced jamba's (4 heads over KV 2 of 64)
_SERVING_POS = np.linspace(128, 160, 8).round().astype(np.int32)
PAGED_TIME_SHAPES = {"serving": (MAIN_PAGED, _SERVING_POS),
                     "one_slot": (MAIN_PAGED, np.array([511], np.int32)),
                     "serving_kv8": (KV8_PAGED, _SERVING_POS),
                     "serving_jamba": (JAMBA_PAGED, _SERVING_POS)}


def paged_bound(rows, B, H, KV, hd, *, kv_bytes, q_bytes, quant) -> dict:
    """The least time of one decode read over ``rows`` admitted positions
    (summed over the slots): the bytes it must move (the admitted K/V rows
    of ``kv_bytes``-byte elements and, over int8 pools, their float32
    scales; q and the output, of ``q_bytes``) each crossing HBM once,
    against its operations (4 per admitted row, head and dimension) at the
    float32 peak; the larger of the two bounds it."""
    nbytes = (rows * KV * 2 * (hd * kv_bytes + (4 if quant else 0))
              + 2 * B * H * hd * q_bytes)
    flops = 4 * rows * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "flops": flops}


def paged_times(dev, sets=4) -> dict:
    """Each paged kernel at the serving geometries (T 512, page size 16, KV
    = H = 32 or KV 8, head dim 128) at the shapes of ``PAGED_TIME_SHAPES``: the float
    kernel on float32 pools, the int8 kernel with bfloat16 q and compute,
    as the two serving runs call them.  Calls cycle through ``sets`` tables
    over disjoint pages, so the rows they read are cold in the 50 MB L2
    cache, as each of the 30 layers' reads is on the serving path.  The
    bound is ``paged_bound``'s, set by the bytes at these shapes.  The library yardstick of the float kernel is
    gather_pages followed by ``scaled_dot_product_attention``; the int8
    kernel has no single PyTorch call that computes it (SDPA takes no int8
    K/V with per-row scales).  ``splits`` and ``chunk`` are the wrapper's
    plan for the shape.  Returns {kernel: {shape: record}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import decode_mask
    from repro_torch.models.paging import gather_pages
    rng = np.random.RandomState(SEED + 5)
    out = {"paged_attention": {}, "paged_attention_quant": {}}
    for shape, (geo, pos) in PAGED_TIME_SHAPES.items():
        g = dict(geo, B=len(pos))
        B, T, H, KV, hd = (g[k] for k in ("B", "length", "H", "KV", "hd"))
        rows = int(sum(min(int(p), T - 1) + 1 for p in pos))
        for name, quant, dtype in (("paged_attention", False, torch.float32),
                                   ("paged_attention_quant", True, torch.bfloat16)):
            case = paged_case(rng, dev, quant=quant, pos=pos, sets=sets, **g)
            q, tabs, p = case["q"].to(dtype), case["tables"], case["pos"]
            nxt = itertools.cycle(range(sets)).__next__
            k, v = case["k"], case["v"]
            if quant:
                ks, vs = case["ks"], case["vs"]
                kern = lambda: pa.paged_attention_quant(  # noqa: E731
                    q, k, ks, v, vs, tabs[nxt()], p, length=T)
                plain = lambda: pa.paged_attention_quant_plain(  # noqa: E731
                    q, k, ks, v, vs, tabs[nxt()], p, length=T)
                library = None
            else:
                kern = lambda: pa.paged_attention(  # noqa: E731
                    q, k, v, tabs[nxt()], p, length=T)
                plain = lambda: pa.paged_attention_plain(  # noqa: E731
                    q, k, v, tabs[nxt()], p, length=T)

                def library():
                    tab = tabs[nxt()]
                    kk = gather_pages(k, tab, T).transpose(1, 2)   # (B, KV, T, hd)
                    vv = gather_pages(v, tab, T).transpose(1, 2)
                    mask = decode_mask(p, T, None)[:, None, None, :]
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), kk, vv, attn_mask=mask,
                        enable_gqa=H != KV)
            bound = paged_bound(rows, B, H, KV, hd, kv_bytes=k.element_size(),
                                q_bytes=q.element_size(), quant=quant)
            splits, chunk = pa.split_plan(B, KV, H // KV, hd, T, g["ps"],
                                          pa.sm_count(torch.cuda.current_device()))
            ms = cuda_ms(kern)
            out[name][shape] = {
                "shape": dict(g, pos=pos.tolist()), "dtype": str(dtype),
                "splits": splits, "chunk": chunk, "ms": ms,
                "ms_host_included": cuda_ms(kern, hide_host=False),
                "plain_ms": cuda_ms(plain),
                "library_ms": None if library is None else cuda_ms(library),
                **bound, "share_of_bound": bound["bound_ms"] / ms,
                "admitted_rows": rows}
            del case, kern, plain, library
            free_cuda()
    return out


def vgg_stepper(spec: str, dev):
    """A closure that runs one VGG-16 train step (B=64, R=4) in place."""
    from repro_torch.optim import adam
    from repro_torch.transport.split import (make_split_train_step,
                                             trainable_params)

    cfg, codec, params, loss, data = make_setup("vgg16", spec, dev)
    opt = adam(cfg.lr)
    state = {"p": params, "o": opt.init(trainable_params(loss, params))}
    step = make_split_train_step(loss, opt)
    batch = data.batch(cfg.batch_size, 0, device=dev)

    def one():
        state["p"], state["o"], _, _ = step(state["p"], state["o"], batch)
    return one


def step_times(dev) -> dict:
    """Time of one VGG-16 train step as a caller sees it (host included),
    kernel backend vs fft backend, in turns: kernel, fft, fft, kernel."""
    k = vgg_stepper("c3sl:R=4,backend=pallas", dev)
    f = vgg_stepper("c3sl:R=4,backend=fft", dev)
    runs = {"kernel": [], "fft": []}
    for name, fn in (("kernel", k), ("fft", f), ("fft", f), ("kernel", k)):
        runs[name].append(cuda_ms(fn, warmup=3, calls=4, reps=20,
                                  hide_host=False))
    return {"vgg16_step_ms_kernel": statistics.mean(runs["kernel"]),
            "vgg16_step_ms_fft": statistics.mean(runs["fft"]),
            "runs": runs}


def step_profile(dev, steps=5) -> dict:
    """Where a VGG-16 train step's device time goes (kernel backend):
    ``torch.profiler`` over ``steps`` steps, self device time by kernel,
    the circconv kernels' share, and the sum of kernel times over wall time
    (the profiler's own overhead lengthens the wall time, so that busy
    share is a lower bound).  Device times come back None where the
    profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    one = vgg_stepper("c3sl:R=4,backend=pallas", dev)
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof, steps)
    busy = sum(r[1] for r in rows)
    if not busy:
        return {"device_ms_per_step": None, "wall_ms_per_step": wall_ms / steps}
    circ = sum(r[1] for r in rows if "bind_superpose_kernel" in r[0]
               or "unbind_kernel" in r[0])
    return {"device_ms_per_step": busy, "wall_ms_per_step": wall_ms / steps,
            "busy_share": busy / (wall_ms / steps),
            "circconv_ms_per_step": circ, "circconv_share": circ / busy,
            "top": [{"name": n[:90], "ms_per_step": t, "calls_per_step": c}
                    for n, t, c in rows[:12]]}


# --------------------------------------------------------------------------
# phase 7: the LM training path
# --------------------------------------------------------------------------

def lm_config(arch=LM_ARCH, layers=LM_LAYERS, small=False):
    """``arch`` at full width (deepseek-7b: d_model 4096, 32 heads of 128,
    d_ff 11008, vocab 102400), its depth cut to ``layers`` (None: the
    arch's own); ``small`` takes ``reduced()`` instead."""
    from repro_torch.configs.base import get_config, reduced
    cfg = get_config(arch)
    if small:
        return reduced(cfg)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def lm_args(ckpt_dir, arch=LM_ARCH, extra=()):
    """``launch/train.py``'s flags for the run: the CLI's own parser;
    ``ckpt_dir`` None writes no checkpoint; ``extra``, more flags."""
    from repro_torch.launch import train
    return train.build_parser().parse_args([
        "--arch", arch, "--steps", str(LM_STEPS), "--batch", str(LM_BATCH),
        "--seq", str(LM_SEQ), "--codec", LM_CODEC, "--seed", str(SEED),
        "--log-every", "1", "--device", "cuda", *extra]
        + ([] if ckpt_dir is None else ["--ckpt-dir", str(ckpt_dir)]))


def lm_frontend(cfg, args, dev):
    """The frontend batch of a run: random frames from the seed (the
    reference driver's zero stub makes every encoder row identical, and the
    gradients of a 24-layer encoder overflow float32 behind it, in both
    packages); None without a frontend."""
    import torch
    if not cfg.frontend:
        return None
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    return torch.randn((args.batch, cfg.frontend_seq, cfg.frontend_dim),
                       generator=gen, device=dev)


def lm_batch(cfg, args, step, dev, frontend=None) -> dict:
    """Step ``step``'s token batch, with ``frontend`` under "frontend"."""
    from repro_torch.data.pipeline import SyntheticTokenDataset
    data = SyntheticTokenDataset(cfg.vocab_size, args.seq, seed=args.seed)
    batch = data.batch(args.batch, step, device=dev)
    if frontend is not None:
        batch["frontend"] = frontend
    return batch


class ExactCodec:
    """The C3-SL codec's function computed in float64 with torch.fft on
    float64 copies of the same keys, its decode rounded once to float32:
    the oracle that the kernels' and ``backend=fft``'s float32 roundings
    are measured against (autograd runs its backward in float64 too)."""

    def __init__(self, codec, params):
        import torch
        self.R, self.D = codec.R, codec.D
        self.kf = torch.fft.rfft(params["keys"].double(), dim=-1)

    def encode(self, params, Z):
        import torch
        z = torch.fft.rfft(Z.double().reshape(-1, self.R, self.D), dim=-1)
        return torch.fft.irfft((self.kf * z).sum(dim=-2), n=self.D, dim=-1)

    def decode(self, params, payload):
        import torch
        prod = self.kf.conj() * torch.fft.rfft(payload, dim=-1)[:, None, :]
        return torch.fft.irfft(prod, n=self.D, dim=-1).reshape(-1, self.D).float()


def leaf_errs(a, b, names) -> list:
    """(max|a - b| / max|b|, name) per leaf, largest first (inf where a
    leaf is not finite)."""
    from repro_torch.interop import tree_leaves
    out = [(leaf_rel_err([x], [y]), n)
           for x, y, n in zip(tree_leaves(a), tree_leaves(b), names)]
    return sorted(out, reverse=True)


def leaf_names(tree, prefix="") -> list:
    """Key paths of a params tree in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def lm_parity(params, cfg, args, dev, frontend=None) -> dict:
    """Step 0's loss and gradients through the kernels against
    ``backend=fft`` (torch.fft on the card) on the same weights, keys and
    batch: the loss within 1e-6 relative, every gradient finite, every
    gradient leaf within 1e-4 of its max (the control plane's step-0
    tolerance) and the cut SNR of both.  Both are also measured against
    the codec computed exactly (``ExactCodec``): where the model amplifies
    float32 rounding so far that ``backend=fft``'s own gradients sit more
    than 1e-4 / 4 from the exact codec's (rwkv6-1.6b), the kernels' may
    differ from ``backend=fft``'s by up to 4 times that distance.  For an
    arch with experts, the kernel run's forward also gives the MoE aux
    loss (summed over the layers, as the loss adds it) and the share of
    token copies past their expert's capacity."""
    import torch
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.launch import train
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import moe as moe_lib
    batch = lm_batch(cfg, args, 0, dev, frontend)
    res = {}
    routing = []
    for backend in ("pallas", "fft", "exact"):
        codec, cp = train.make_codec(
            LM_CODEC.replace("pallas", "fft" if backend == "exact" else backend),
            args.seq * cfg.d_model, max_R=args.batch, device=dev)
        if backend == "exact":
            codec = ExactCodec(codec, cp)
        tp = tree_map(lambda t: t.detach().requires_grad_(), params)
        # the forward's routing only: the backward's recomputation is not logged
        moe_lib.ROUTING_LOG = routing if backend == "pallas" else None
        try:
            loss, metrics = lm_lib.lm_loss(tp, batch, cfg, codec=codec,
                                           codec_params=cp, with_metrics=True)
        finally:
            moe_lib.ROUTING_LOG = None
        grads = torch.autograd.grad(loss, tree_leaves(tp))
        res[backend] = (float(loss.detach()), float(metrics["cut_snr"].detach()),
                        grads)
        del tp, loss, metrics
    (lk, sk, gk), (lf, sf, gf), (lx, sx, gx) = res["pallas"], res["fft"], res["exact"]
    names = leaf_names(params)
    rel = abs(lk - lf) / abs(lf)
    gerr = leaf_rel_err(gk, gf)
    k_x, f_x = leaf_errs(gk, gx, names), leaf_errs(gf, gx, names)
    grad_tol = max(1e-4, 4 * f_x[0][0])
    out = {"loss_kernel": lk, "loss_fft": lf, "loss_exact": lx, "loss_rel_err": rel,
           "grad_leaf_rel_err": gerr, "grad_tol": grad_tol,
           "kernel_vs_exact": k_x[0][0], "fft_vs_exact": f_x[0][0],
           "worst_leaves": {"kernel_vs_fft": leaf_errs(gk, gf, names)[:3],
                            "kernel_vs_exact": k_x[:3], "fft_vs_exact": f_x[:3]},
           "cut_snr_kernel": sk, "cut_snr_fft": sf, "cut_snr_exact": sx}
    check(rel <= 1e-6, f"lm step-0 loss kernels {lk} vs fft {lf}")
    check(all(bool(torch.isfinite(g).all()) for g in (*gk, *gf, *gx)),
          f"lm step-0 gradients not finite: {out['worst_leaves']}")
    check(gerr <= grad_tol, f"lm step-0 grads kernels vs fft: {gerr} "
          f"(limit {grad_tol}; {out['worst_leaves']})")
    if cfg.num_experts:
        check(len(routing) == cfg.num_superblocks * sum(
            k == "moe" for layer in cfg.block_pattern for k in layer),
            f"lm step-0 routing logged {len(routing)} MoE layers")
        kept = sum(int(k) for k, _, _ in routing)
        copies = sum(n for _, n, _ in routing)
        out.update(moe_layers=len(routing),
                   moe_aux=sum(float(a) for _, _, a in routing),
                   moe_dropped_share=1 - kept / copies)
    return out


def train_step_times(one, timed_steps) -> tuple:
    """(the step time: CUDA events around single calls of ``one``, the
    median of ``timed_steps``, host included; a ``torch.profiler``
    breakdown over LM_PROFILED_STEPS calls: device time, idle share, the
    circconv kernels' share, the top kernels; None where the profiler sees
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step_ms = cuda_ms(one, warmup=0, calls=1, reps=timed_steps, hide_host=False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILED_STEPS):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / LM_PROFILED_STEPS
    rows = device_rows(prof, LM_PROFILED_STEPS)
    busy = sum(r[1] for r in rows)
    circ = sum(r[1] for r in rows if "columns_kernel" in r[0] or "rows_kernel" in r[0])
    return step_ms, None if not busy else {
        "device_ms_per_step": busy, "wall_ms_per_step": wall_ms,
        "idle_share_profiled": 1 - busy / wall_ms,
        "idle_share_vs_unprofiled_step": 1 - busy / step_ms,
        "device_ops_per_step": sum(r[2] for r in rows),
        "circconv_ms_per_step": circ, "circconv_share": circ / busy,
        "top": [{"name": n[:90], "ms_per_step": t, "calls_per_step": c}
                for n, t, c in rows[:10]]}


def lm_training(dev, cfg, shape, *, ckpt=False, timed_steps=LM_TIMED_STEPS,
                label="full width") -> dict:
    """``cfg`` (``label`` says its size): (a) step-0 parity; (b)
    ``launch.train.run_standard`` for LM_STEPS steps from the same weights,
    launch counts reset just before and read just after: finite losses,
    2 + 2 circconv launches a step, all on the four-step route at
    ``shape`` (G, R, D), none direct, G * D * 4 wire bytes a direction a
    step; (c) with ``ckpt``, the checkpoint it wrote (``--ckpt-dir``)
    restored bitwise, then deleted; (d) the step time (CUDA events around
    single steps, the median of ``timed_steps``, host included) and a
    ``torch.profiler`` breakdown over LM_PROFILED_STEPS steps: device time,
    idle share, the codec's share."""
    import shutil

    import torch

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.interop import tree_leaves
    from repro_torch.kernels import circconv
    from repro_torch.launch import train
    from repro_torch.models import lm as lm_lib
    from repro_torch.transport import split_comm_bytes

    arch = cfg.name
    G, R, D = shape
    wire_bytes = G * D * 4
    ckpt_dir = OUT_DIR / "lm_ckpt" if ckpt else None
    if ckpt:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = lm_args(ckpt_dir, arch)
    # run_standard's own init (the seed's generator on the card), made here
    # so that the parity runs on the weights the run starts from
    params = lm_lib.init_lm_params(args.seed, cfg, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    frontend = lm_frontend(cfg, args, dev)
    parity = lm_parity(params, cfg, args, dev, frontend)
    free_cuda()

    out = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    circconv.reset_launch_counts()
    t0 = time.perf_counter()
    losses = train.run_standard(args, cfg, params=params, out=out,
                                frontend=frontend)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, routes, by_kernel = (dict(circconv.LAUNCHES), route_counts(),
                                 record_launches())
    shapes = {f"{k[0]}/{k[1]}x{k[2]}x{k[3]}": n
              for k, n in circconv.SHAPE_LAUNCHES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(losses) == LM_STEPS and all(map(math.isfinite, losses)),
          f"lm training {arch} losses {losses}")
    want = {"bind_superpose": 2 * LM_STEPS, "unbind": 2 * LM_STEPS}
    check(counts == want, f"lm training {arch} launches {counts}, want {want}")
    check_fft_route(routes, 2 * LM_STEPS, f"lm training {arch}", route="fft4")
    want_shapes = {f"{k}/{G}x{R}x{D}": 2 * LM_STEPS
                   for k in ("bind_superpose", "unbind")}
    check(shapes == want_shapes, f"lm training shapes {shapes}, want {want_shapes}")
    codec = out["codec"]
    mode = getattr(codec, "transform", codec).execution_mode(dev)
    check(mode == "cuda-kernel", f"{LM_CODEC} ran as {mode}, not the CUDA kernels")
    wire_fwd = split_comm_bytes(codec, args.batch, directions=1)
    wire_bwd = split_comm_bytes(codec, args.batch) - wire_fwd
    check(wire_fwd == wire_bwd == wire_bytes,
          f"lm wire bytes {wire_fwd} + {wire_bwd}, want {wire_bytes} each")

    ckpt_bytes = restore_s = None
    if ckpt:
        t0 = time.perf_counter()
        template = {"params": out["params"]}
        restored = restore_checkpoint(str(ckpt_dir), LM_STEPS, template)
        restore_s = time.perf_counter() - t0
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(restored), tree_leaves(template)))
        check(bitwise, "lm checkpoint did not restore bitwise")
        ckpt_bytes = sum(p.stat().st_size for p in ckpt_dir.rglob("*")
                         if p.is_file())
        del restored
        shutil.rmtree(ckpt_dir)   # 9.8 GB: the output directory keeps the record only
        free_cuda()

    step = out["step_fns"][None]          # the static codec's one callable
    batch = lm_batch(cfg, args, LM_STEPS, dev, frontend)
    probe = torch.zeros((), dtype=torch.float32, device=dev)

    def one():
        step(out["params"], out["opt_state"], batch, probe)

    step_ms, prof_out = train_step_times(one, timed_steps)
    del out, step, batch, frontend
    free_cuda()
    return {"arch": arch, "label": label, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers, "cut_after": cfg.num_superblocks // 2,
            "params": n_params, "shape": list(shape),
            "batch": LM_BATCH, "seq": LM_SEQ, "codec": LM_CODEC,
            "parity": parity, "losses": losses, "launches": counts,
            "route_launches": routes, "record_launches": by_kernel,
            "shape_launches": shapes,
            "wire_bytes": [wire_fwd, wire_bwd], "run_s": run_s,
            "peak_gb": peak_gb, "ckpt_bytes": ckpt_bytes,
            "restore_s": restore_s, "step_ms": step_ms,
            "timed_steps": timed_steps, "profile": prof_out}


def print_lm(card, lm):
    """Phase 7's to 12's lines."""
    par, lp = lm["parity"], lm["profile"]
    depth = f"{lm['layers']} layers" + (
        f" + a {lm['encoder_layers']}-layer encoder" if lm["encoder_layers"] else "")
    print(f"lm training {lm['arch']} {lm['label']}, {depth} (cut after "
          f"superblock {lm['cut_after']}), {lm['params'] / 1e9:.3f} B params, "
          f"B {LM_BATCH} S {LM_SEQ}, {LM_CODEC} (D {lm['shape'][2]}): step-0 "
          f"kernels vs backend=fft loss {par['loss_kernel']:.6f} vs "
          f"{par['loss_fft']:.6f} (rel err {par['loss_rel_err']:.3g}), grad leaf "
          f"rel err {par['grad_leaf_rel_err']:.3g}, cut SNR "
          f"{par['cut_snr_kernel']:.4f} dB (fft {par['cut_snr_fft']:.4f})",
          flush=True)
    if "moe_aux" in par:
        print(f"lm training {lm['arch']} step 0 MoE: aux loss {par['moe_aux']:.6f} "
              f"over {par['moe_layers']} layers, {par['moe_dropped_share']:.4%} of "
              f"token copies dropped past capacity", flush=True)
    print(f"lm training run_standard: {LM_STEPS} steps, losses "
          f"{[round(v, 4) for v in lm['losses']]}, launches {lm['launches']}, "
          f"routes {lm['route_launches']}, by shape {lm['shape_launches']}, wire "
          f"fwd {lm['wire_bytes'][0]:,d} B + bwd {lm['wire_bytes'][1]:,d} B a "
          f"step, peak {lm['peak_gb']:.1f} GB; " + (
              "no checkpoint" if lm["ckpt_bytes"] is None else
              f"checkpoint {lm['ckpt_bytes']:,d} B restored bitwise in "
              f"{lm['restore_s']:.1f} s"), flush=True)
    print(f"time [{card}] lm train step ({lm['arch']} {lm['label']} x{depth}, B "
          f"{LM_BATCH} S {LM_SEQ}, {LM_CODEC}): {lm['step_ms']:.1f} ms (median "
          f"of {lm['timed_steps']}, host included), peak {lm['peak_gb']:.1f} GB",
          flush=True)
    if lp is None:
        print(f"profile [{card}] lm train step: the profiler saw no device time "
              "(not measured)")
    else:
        print(f"profile [{card}] lm train step ({lm['arch']}): device "
              f"{lp['device_ms_per_step']:.1f} "
              f"ms of {lp['wall_ms_per_step']:.1f} ms wall (idle "
              f"{lp['idle_share_profiled']:.3f} profiled, "
              f"{lp['idle_share_vs_unprofiled_step']:.3f} of the unprofiled step); "
              f"circconv kernels {lp['circconv_ms_per_step']:.4f} ms "
              f"({lp['circconv_share']:.5f})", flush=True)
        for r in lp["top"]:
            print(f"  {r['ms_per_step']:.3f} ms x{r['calls_per_step']}  {r['name']}")


# --------------------------------------------------------------------------
# phase 17: the 2-stage pod pipeline
# --------------------------------------------------------------------------

def pipeline_args(depth: int):
    """``launch/train.py``'s flags for a pipeline run at ``depth``: phase
    7's, with ``--pipeline``, PIPE_MICROBATCHES microbatches and
    ``--async-depth``."""
    return lm_args(None, extra=("--pipeline", "--microbatches",
                                str(PIPE_MICROBATCHES), "--async-depth", str(depth)))


def as_lm_tree(tree):
    """A pipeline tree's leaves in the LM's tree (the stage axis merged)."""
    from repro_torch.interop import tree_map
    return {"embed": tree["embed"]["embed"],
            "stack": tree_map(lambda a: a.reshape(-1, *a.shape[2:]), tree["blocks"]),
            "final_norm": tree["head"]["final_norm"], "head": tree["head"]["head"]}


def pipeline_parity(cfg, dev) -> dict:
    """Step 0's loss and gradients through the pipeline at depth 1 (the
    launches counted), against (i) the per-microbatch composition (embed ->
    stage 0 -> encode/decode -> stage 1 -> head, each microbatch with its
    own labels, meaned), (ii) the single-program ``lm_loss`` on the whole
    batch with the same keys (cut after superblock num_superblocks // 2,
    the R-groups the same rows), each at phase 7's tolerances (loss 1e-6
    relative, every gradient leaf 1e-4 of its max); (iii) the pipeline at
    depth 2: the loss and every gradient leaf bitwise."""
    import torch
    from repro_torch.interop import tree_leaves, tree_map, tree_unflatten
    from repro_torch.kernels import circconv
    from repro_torch.launch import train
    from repro_torch.models import lm as lm_lib
    from repro_torch.transport import make_pod_pipeline_loss_fn

    args = pipeline_args(1)
    M, mb = PIPE_MICROBATCHES, LM_BATCH // PIPE_MICROBATCHES
    full = lm_lib.init_lm_params(args.seed, cfg, device=dev)
    codec, cp = train.make_codec(LM_CODEC, args.seq * cfg.d_model, max_R=mb,
                                 device=dev)
    params = train.pipeline_params(full, cp)
    b = lm_batch(cfg, args, 0, dev)
    batch = {"x": b["tokens"], "y": b["labels"]}
    embed_fn, stage_fn, head_loss_fn = fns = lm_lib.make_pipeline_fns(cfg)

    def value_and_grad(fn, tree):
        tp = tree_map(lambda t: t.detach().requires_grad_(), tree)
        loss = fn(tp)
        got = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True,
                                  materialize_grads=True)
        return float(loss.detach()), tree_unflatten(tree, list(got))

    def pipeline(depth):
        lf = make_pod_pipeline_loss_fn(*fns, codec, num_microbatches=M,
                                       async_depth=depth)
        return lf, lambda tp: lf(tp, batch)

    def composed(tp):
        tot = 0.0
        for m in range(M):
            sl = slice(m * mb, (m + 1) * mb)
            h = stage_fn(tree_map(lambda a: a[0], tp["blocks"]),
                         embed_fn(tp["embed"], batch["x"][sl]))
            Zf = codec.decode(tp["codec"], codec.encode(tp["codec"],
                                                        h.reshape(mb, -1)))
            h = stage_fn(tree_map(lambda a: a[1], tp["blocks"]), Zf.reshape(h.shape))
            tot = tot + head_loss_fn(tp["head"], h, batch["y"][sl])
        return tot / M

    names = leaf_names(as_lm_tree(params))
    lf1, fn1 = pipeline(1)
    circconv.reset_launch_counts()
    l1, g1 = value_and_grad(fn1, params)
    torch.cuda.synchronize()
    shapes = {f"{k[0]}/{k[1]}x{k[2]}x{k[3]}": n
              for k, n in circconv.SHAPE_LAUNCHES.items()}
    want_shapes = {"{}/{}x{}x{}".format(k, *PIPE_SHAPE): 2 * M
                   for k in ("bind_superpose", "unbind")}
    check(shapes == want_shapes, f"pipeline step 0 shapes {shapes}, want {want_shapes}")
    check(all(bool(torch.isfinite(g).all()) for g in tree_leaves(g1)),
          "pipeline step-0 gradients not finite")
    out = {"loss": l1, "launches": shapes, "call": dataclasses.asdict(lf1.last_call)}
    g1_lm = as_lm_tree(g1)
    for what, fn, tree in (
            ("composition", composed, params),
            ("lm_loss", lambda tp: lm_lib.lm_loss(tp, b, cfg, codec=codec,
                                                  codec_params=cp), full)):
        loss, g = value_and_grad(fn, tree)
        rel = abs(loss - l1) / abs(loss)
        errs = leaf_errs(g1_lm, as_lm_tree(g) if what == "composition" else g, names)
        out[what] = {"loss": loss, "loss_rel_err": rel, "grad_leaf_rel_err": errs[0][0],
                     "worst_leaves": errs[:3]}
        check(rel <= 1e-6, f"pipeline step-0 loss {l1} vs {what} {loss}")
        check(errs[0][0] <= 1e-4, f"pipeline step-0 grads vs {what}: {errs[:3]}")
        del g
        free_cuda()
    codec_grads = tree_leaves(g1["codec"])
    lf2, fn2 = pipeline(2)
    l2, g2 = value_and_grad(fn2, params)
    differ = [n for n, a, c in zip(leaf_names(g1), tree_leaves(g1), tree_leaves(g2))
              if not torch.equal(a, c)]
    out["depth2"] = {"loss": l2, "leaves_not_bitwise": differ,
                     "call": dataclasses.asdict(lf2.last_call)}
    check(l2 == l1, f"pipeline step-0 loss depth 2 {l2} != depth 1 {l1}")
    check(not differ, f"pipeline step-0 grads depth 2 vs 1 not bitwise: {differ}")
    out["codec_grad_max"] = max(float(g.abs().max()) for g in codec_grads)
    del full, params, g1, g2, codec_grads, g1_lm
    free_cuda()
    return out


def pipeline_training(dev, cfg, depth: int) -> dict:
    """``launch.train.run_pipeline`` at ``depth`` for LM_STEPS steps from
    the seed's weights (the parity's), launch counts reset just before and
    read just after: finite losses, 8 + 8 circconv launches a step, all on
    the four-step route at PIPE_SHAPE, none at another shape; the wire
    bytes a microbatch and a step a direction exactly; the call record (M
    payloads over M + depth steps, same-device); then the step time and
    profile (``train_step_times``) and the peak memory."""
    import torch
    from repro_torch.kernels import circconv
    from repro_torch.launch import train
    from repro_torch.transport import split_comm_bytes

    args = pipeline_args(depth)
    M, mb = PIPE_MICROBATCHES, LM_BATCH // PIPE_MICROBATCHES
    G, R, D = PIPE_SHAPE
    out = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    circconv.reset_launch_counts()
    t0 = time.perf_counter()
    losses = train.run_pipeline(args, cfg, out=out)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, routes, by_kernel = (dict(circconv.LAUNCHES), route_counts(),
                                 record_launches())
    shapes = {f"{k[0]}/{k[1]}x{k[2]}x{k[3]}": n
              for k, n in circconv.SHAPE_LAUNCHES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    what = f"pipeline training depth {depth}"
    check(len(losses) == LM_STEPS and all(map(math.isfinite, losses)),
          f"{what} losses {losses}")
    per_step = 2 * M
    want = {"bind_superpose": per_step * LM_STEPS, "unbind": per_step * LM_STEPS}
    check(counts == want, f"{what} launches {counts}, want {want}")
    check_fft_route(routes, per_step * LM_STEPS, what, route="fft4")
    want_shapes = {f"{k}/{G}x{R}x{D}": per_step * LM_STEPS
                   for k in ("bind_superpose", "unbind")}
    check(shapes == want_shapes, f"{what} shapes {shapes}, want {want_shapes}")
    codec = out["codec"]
    mode = getattr(codec, "transform", codec).execution_mode(dev)
    check(mode == "cuda-kernel", f"{LM_CODEC} ran as {mode}, not the CUDA kernels")
    wf = split_comm_bytes(codec, mb, directions=1)
    wb = split_comm_bytes(codec, mb) - wf
    check(wf == wb == G * D * 4, f"{what} wire a microbatch {wf} + {wb}, want "
          f"{G * D * 4} each")
    # the record is what the loop saw: the payload tensors that crossed
    # the boundary hold the analytic G*D*4 bytes of a microbatch each
    rec = dataclasses.asdict(out["loss_fn"].last_call)
    want_rec = {"steps": M + depth, "payloads": M, "payload_bytes": M * G * D * 4,
                "max_held": depth, "wire": "same-device"}
    check(rec == want_rec, f"{what} call record {rec}, want {want_rec}")
    check(M * wf == LM_BATCH // R * D * 4, f"{what} wire a step {M * wf}, want "
          f"phase 7's {LM_BATCH // R * D * 4}")

    step = out["step"]
    b = lm_batch(cfg, args, LM_STEPS, dev)
    batch = {"x": b["tokens"], "y": b["labels"]}

    def one():
        step(out["params"], out["opt_state"], batch)

    step_ms, prof = train_step_times(one, LM_TIMED_STEPS)
    del out, step, batch, b
    free_cuda()
    return {"depth": depth, "losses": losses, "launches": counts,
            "route_launches": routes, "record_launches": by_kernel,
            "shape_launches": shapes, "wire_microbatch": [wf, wb],
            "wire_step": [M * wf, M * wb], "call": rec, "run_s": run_s,
            "peak_gb": peak_gb, "step_ms": step_ms,
            "timed_steps": LM_TIMED_STEPS, "profile": prof}


def pipeline_phase(dev, cfg) -> dict:
    """Phase 17: the parity at step 0, then the training runs at each of
    PIPE_DEPTHS; their losses equal across depths within 1e-6 relative."""
    t0 = time.perf_counter()
    parity = pipeline_parity(cfg, dev)
    runs = {d: pipeline_training(dev, cfg, d) for d in PIPE_DEPTHS}
    base = runs[PIPE_DEPTHS[0]]["losses"]
    for d, r in runs.items():
        gap = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], base))
        check(gap <= 1e-6, f"pipeline losses depth {d} {r['losses']} vs {base}")
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "stages": [cfg.num_superblocks // 2] * 2, "batch": LM_BATCH,
            "seq": LM_SEQ, "microbatches": PIPE_MICROBATCHES,
            "codec": LM_CODEC, "shape": list(PIPE_SHAPE), "parity": parity,
            "runs": runs, "seconds": time.perf_counter() - t0}


def print_pipeline(card, res, lm=None):
    """Phase 17's lines; ``lm``, phase 7's record, puts the single-program
    step beside the pipeline's."""
    par = res["parity"]
    print(f"phase 17: the 2-stage pod pipeline, {res['arch']} full width, "
          f"{res['layers']} layers as {res['stages'][0]} + {res['stages'][1]} "
          f"superblocks, B {res['batch']} S {res['seq']} in "
          f"{res['microbatches']} microbatches, {res['codec']} on the stage "
          f"channel (payload {res['shape'][0]} x {res['shape'][2]})", flush=True)
    print(f"pipeline step 0 depth 1: loss {par['loss']:.6f}; vs the "
          f"per-microbatch composition loss rel err "
          f"{par['composition']['loss_rel_err']:.3g}, grad leaf rel err "
          f"{par['composition']['grad_leaf_rel_err']:.3g}; vs single-program "
          f"lm_loss {par['lm_loss']['loss']:.6f} rel err "
          f"{par['lm_loss']['loss_rel_err']:.3g}, grad leaf rel err "
          f"{par['lm_loss']['grad_leaf_rel_err']:.3g}; depth 2 bitwise (loss "
          f"{par['depth2']['loss']:.6f}, leaves not bitwise "
          f"{par['depth2']['leaves_not_bitwise']}); launches {par['launches']}",
          flush=True)
    for d, r in res["runs"].items():
        c = r["call"]
        print(f"pipeline training depth {d}: {LM_STEPS} steps, losses "
              f"{[round(v, 6) for v in r['losses']]}, launches {r['launches']}, "
              f"by shape {r['shape_launches']}, wire fwd "
              f"{r['wire_microbatch'][0]:,d} B + bwd {r['wire_microbatch'][1]:,d} "
              f"B a microbatch, {r['wire_step'][0]:,d} B + {r['wire_step'][1]:,d} "
              f"B a step; call: {c['payloads']} payloads ({c['payload_bytes']:,d} "
              f"B) over {c['steps']} steps, at most {c['max_held']} held, "
              f"{c['wire']}", flush=True)
        beside = "" if lm is None else (
            f"; phase 7's single-program step {lm['step_ms']:.1f} ms, peak "
            f"{lm['peak_gb']:.1f} GB")
        print(f"time [{card}] pipeline train step depth {d} ({res['arch']} x"
              f"{res['layers']}, B {res['batch']} S {res['seq']}, M "
              f"{res['microbatches']}, {res['codec']}): {r['step_ms']:.1f} ms "
              f"(median of {r['timed_steps']}, host included), peak "
              f"{r['peak_gb']:.1f} GB{beside}", flush=True)
        lp = r["profile"]
        if lp is None:
            print(f"profile [{card}] pipeline train step depth {d}: the "
                  "profiler saw no device time (not measured)", flush=True)
            continue
        lp7 = "" if lm is None or lm["profile"] is None else (
            f"; phase 7: device {lm['profile']['device_ms_per_step']:.1f} ms, "
            f"idle {lm['profile']['idle_share_vs_unprofiled_step']:.3f}")
        print(f"profile [{card}] pipeline train step depth {d}: device "
              f"{lp['device_ms_per_step']:.1f} ms of {lp['wall_ms_per_step']:.1f} "
              f"ms wall (idle {lp['idle_share_profiled']:.3f} profiled, "
              f"{lp['idle_share_vs_unprofiled_step']:.3f} of the unprofiled "
              f"step), {lp['device_ops_per_step']} device ops; circconv kernels "
              f"{lp['circconv_ms_per_step']:.4f} ms ({lp['circconv_share']:.5f})"
              f"{lp7}", flush=True)
        for t in lp["top"][:6]:
            print(f"  {t['ms_per_step']:.3f} ms x{t['calls_per_step']}  {t['name']}")
    print(f"pipeline: phase seconds {res['seconds']:.1f}", flush=True)


# --------------------------------------------------------------------------
# phase 18: the runtime sanitizer tier
# --------------------------------------------------------------------------

SAN_REQUESTS = 12
# staggered budgets: slots finish at different ticks, so ticks see a
# dead/live mix and the cut probe runs
SAN_BUDGETS = [8 + 4 * i for i in range(SAN_REQUESTS)]
SAN_STEPS = 2
SAN_PROBES = 3


def sanitize_drive(armed: bool):
    """18a: request u gets SAN_BUDGETS[u] new tokens; ``tick()`` until
    idle, each working tick's wall time kept (synchronised after it); with
    ``armed`` an ``EngineSanitizer`` attached first, its ticks and counts
    under "sanitize"."""
    import torch
    from repro_torch.analysis import EngineSanitizer
    from repro_torch.serving.engine import Request

    def drive(eng, prompts):
        san = None
        if armed:
            san = EngineSanitizer(eng)
            eng.attach_sanitizer(san)
        for u, p in enumerate(prompts):
            eng.submit(Request(uid=u, prompt=p, max_new_tokens=SAN_BUDGETS[u]))
        ticks = []
        while True:
            t0 = time.perf_counter()
            worked = eng.tick()
            torch.cuda.synchronize()
            if not worked:
                break
            ticks.append(time.perf_counter() - t0)
        info = {"tick_s": ticks, "pool": eng.pool_accounting()}
        if san is not None:
            san.check_pool(eng)            # the drained pool, exact
            info["sanitize"] = {"ticks": san.ticks, "counts": dict(san.counts)}
        return eng.finished, info
    return drive


def _same_bytes(before, now) -> bool:
    import torch
    return len(before) == len(now) and all(
        torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
        for a, b in zip(before, now))


def sanitize_faults(params, cfg) -> dict:
    """18b on phase 4's engine (kernel read), 2 of its 8 slots two ticks
    into decoding: SAN_PROBES real probes, timed (each ends in a host
    read), the cache's and the state's bytes unchanged after them; a probe
    built with ``live=None`` (the encode without the live-slot mask)
    reports a nonzero dead-row |cut| sum and trips "live-slot zeroing",
    writing nothing either, while a fresh real probe passes on the same
    state; after the drain, a dirty empty slot trips "not inert" and a
    leaky allocator "accounting"."""
    import torch
    from repro_torch.analysis import EngineSanitizer, SanitizerError
    from repro_torch.interop import tree_leaves
    from repro_torch.models import lm as lm_lib
    from repro_torch.serving.engine import Request

    eng = make_engine(params, cfg, "kernel")
    for u, p in enumerate(serve_prompts(2, cfg.vocab_size)):
        eng.submit(Request(uid=u, prompt=p, max_new_tokens=SERVE_NEW))
    eng.tick()
    eng.tick()
    n_live = int((eng.state["active"] & ~eng.state["done"]).sum())
    check(n_live == 2, f"phase 18b: {n_live} live slots, want 2")

    def leaves():
        return tree_leaves(eng.cache) + list(eng.state.values())

    before = [t.clone() for t in leaves()]
    san = EngineSanitizer(eng)
    probe_ms = []
    for _ in range(SAN_PROBES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        san.check_cut_zeroing(eng)
        probe_ms.append((time.perf_counter() - t0) * 1e3)
    check(san.counts["cut_zeroing"] == SAN_PROBES and _same_bytes(before, leaves()),
          f"phase 18b: the probe wrote into the cache or state, or did not "
          f"run ({san.counts})")

    def unmasked(params_, cache, state):
        liv = state["active"] & ~state["done"]
        cut = lm_lib.decode_cut(params_, cache, state["last_tok"][:, None],
                                state["pos"], cfg, paged=eng.paged, live=None)
        dead = (~liv).to(cut.dtype)[:, None]
        return torch.sum(torch.abs(cut) * dead), liv.sum()

    dead_mag = float(unmasked(eng.params, eng.cache, eng.state)[0])
    bad = EngineSanitizer(eng)
    bad._probe = unmasked
    trips = {}

    def trip(what, fn):
        try:
            fn()
        except SanitizerError as e:
            trips[what] = str(e)

    trip("unmasked_probe", lambda: bad.check_cut_zeroing(eng))
    fixed = EngineSanitizer(eng)
    fixed.check_cut_zeroing(eng)
    check(dead_mag > 0 and math.isfinite(dead_mag)
          and "live-slot zeroing" in trips.get("unmasked_probe", "")
          and fixed.counts["cut_zeroing"] == 1 and _same_bytes(before, leaves()),
          f"phase 18b: unmasked probe dead-row sum {dead_mag}, trip "
          f"{trips.get('unmasked_probe')!r}, real probe {fixed.counts}")
    del before
    eng.run()
    san.check_slot_state(eng)
    san.check_pool(eng)
    eng.state["active"][5] = True                  # a broken retire
    trip("dirty_slot", lambda: san.check_slot_state(eng))
    eng.state["active"][5] = False
    allocator = eng.allocator

    class LeakyAllocator:
        free_pages = 1               # pages vanished: free + in_use < total

    eng.allocator = LeakyAllocator()
    trip("leaky_allocator", lambda: san.check_pool(eng))
    eng.allocator = allocator
    check("not inert" in trips.get("dirty_slot", "")
          and "accounting" in trips.get("leaky_allocator", ""),
          f"phase 18b: planted faults {trips}")
    return {"probe_ms": probe_ms, "dead_row_cut_sum": dead_mag, "trips": trips,
            "cache_gb": sum(t.numel() * t.element_size()
                            for t in tree_leaves(eng.cache)) / 1e9}


def sanitize_training(dev) -> dict:
    """18c at phase 7's model (deepseek-7b x 8 at full width, B 16, S 128,
    D 524288 on the four-step kernels): ``run_standard`` and
    ``run_pipeline`` at depth 1, SAN_STEPS steps each, unarmed then armed
    (``--sanitize``) from the seed, launch counts reset just before and
    read just after each run: the armed losses bitwise the unarmed ones,
    every step checked, anomaly mode off after the run, the launches a
    step phase 7's and 17's; then SAN_STEPS more steps of the run's own
    step, timed (CUDA events around single steps, host included; armed:
    in its sanitizer scope with the per-step check).  Then a
    ``--sanitize`` step with one parameter element NaN raises
    ``SanitizerError`` naming step 0 and the leaf, and ``finite_outputs``
    trips on a NaN and on an inf in a tensor on the card."""
    import torch
    from repro_torch.analysis import SanitizerError, finite_outputs
    from repro_torch.kernels import circconv
    from repro_torch.launch import train
    from repro_torch.models import lm as lm_lib

    cfg = lm_config()
    runs = {}
    for loop in ("standard", "pipeline"):
        pipe = loop == "pipeline"
        for armed in (False, True):
            extra = ["--steps", str(SAN_STEPS)] + (["--sanitize"] if armed else [])
            if pipe:
                extra += ["--pipeline", "--microbatches", str(PIPE_MICROBATCHES),
                          "--async-depth", "1"]
            args = lm_args(None, extra=extra)
            what = f"phase 18c {loop} {'armed' if armed else 'unarmed'}"
            out = {}
            torch.cuda.synchronize()
            circconv.reset_launch_counts()
            t0 = time.perf_counter()
            losses = (train.run_pipeline if pipe else train.run_standard)(
                args, cfg, out=out)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts, routes = dict(circconv.LAUNCHES), route_counts()
            by_kernel = record_launches()
            san = out["train_sanitizer"]
            per_step = 2 * PIPE_MICROBATCHES if pipe else 2
            want = {"bind_superpose": per_step * SAN_STEPS,
                    "unbind": per_step * SAN_STEPS}
            check(counts == want, f"{what} launches {counts}, want {want}")
            check_fft_route(routes, per_step * SAN_STEPS, what, route="fft4")
            check(len(losses) == SAN_STEPS and all(map(math.isfinite, losses))
                  and not torch.is_anomaly_enabled()
                  and (san is not None) == armed
                  and (not armed or san.steps_checked == SAN_STEPS),
                  f"{what}: losses {losses}, anomaly mode "
                  f"{torch.is_anomaly_enabled()}, sanitizer {san}")
            b = lm_batch(cfg, args, SAN_STEPS, dev)
            if pipe:
                step, batch = out["step"], {"x": b["tokens"], "y": b["labels"]}
                call = lambda: step(out["params"], out["opt_state"], batch)  # noqa: E731
            else:
                step, batch = out["step_fns"][None], b
                probe0 = torch.zeros((), dtype=torch.float32, device=dev)
                call = lambda: step(out["params"], out["opt_state"], batch, probe0)  # noqa: E731
            n = [SAN_STEPS]

            def one(anomaly=True):
                if san is None:
                    return call()
                with (san.step_scope(n[0]) if anomaly else contextlib.nullcontext()):
                    res = call()
                san.check_step(n[0], loss=res[2], gnorm=res[3])
                n[0] += 1

            step_ms = cuda_ms(one, warmup=0, calls=1, reps=SAN_STEPS, hide_host=False)
            # the armed step without anomaly mode: the output check and the
            # per-step check alone, to split the armed step's cost
            checks_ms = None if san is None else cuda_ms(
                lambda: one(anomaly=False), warmup=0, calls=1, reps=SAN_STEPS,
                hide_host=False)
            runs[f"{loop}_{'armed' if armed else 'unarmed'}"] = {
                "losses": losses, "run_s": run_s, "step_ms": step_ms,
                "checks_only_step_ms": checks_ms,
                "launches": counts, "route_launches": routes,
                "record_launches": by_kernel,
                "steps_checked": None if san is None else san.steps_checked}
            del out, step, batch, b, call, one
            free_cuda()
        a, u = runs[f"{loop}_armed"], runs[f"{loop}_unarmed"]
        check(a["losses"] == u["losses"], f"phase 18c {loop}: armed losses "
              f"{a['losses']} differ from unarmed {u['losses']}")
    params = lm_lib.init_lm_params(SEED, cfg, device=dev)
    params["stack"]["l0_0_attn"]["w_q"][0, 0, 0] = float("nan")
    nan_msg = None
    try:
        train.run_standard(lm_args(None, extra=["--steps", "1", "--sanitize"]),
                           cfg, params=params)
    except SanitizerError as e:
        nan_msg = str(e)
    del params
    free_cuda()
    check(nan_msg is not None and re.match(
        r"\[sanitize\] step 0: step\(\) input params\['stack'\]\['l0_0_attn'\]"
        r"\['w_q'\] is not finite", nan_msg) and not torch.is_anomaly_enabled(),
        f"phase 18c: the NaN step raised {nan_msg!r}")
    x = torch.randn(1 << 22, device=dev)
    outputs = finite_outputs(lambda t: {"x": t})
    check(outputs(x)["x"] is x, "phase 18c: finite_outputs changed a finite output")
    wrapper_trips = {}
    for name, val in (("nan", math.nan), ("inf", math.inf)):
        y = x.clone()
        y[(1 << 21) + 17] = val
        try:
            outputs(y)
        except SanitizerError as e:
            wrapper_trips[name] = str(e)
    check(len(wrapper_trips) == 2 and all("output['x'] holds NaN or inf" in m
                                          for m in wrapper_trips.values()),
          f"phase 18c: finite_outputs on the card: {wrapper_trips}")
    return {"arch": cfg.name, "layers": cfg.num_layers, "runs": runs,
            "nan_step": nan_msg, "wrapper_trips": wrapper_trips}


def sanitize_serving(dev, door_tokens) -> tuple:
    """18a, b and d on phase 4's model: a. phase 4's engine armed and
    unarmed, SAN_REQUESTS requests of SERVE_PROMPT tokens with staggered
    budgets, driven by ``tick()``; b. the probe alone and the planted
    faults (``sanitize_faults``); d. the selfcheck's sequential run
    through the door under ``--sanitize`` at phase 16c's settings
    (sync_every 2), its tokens held to 16c's fault-free run's
    (``door_tokens``: one live slot at a time, so the schedule cannot move
    them).  Returns (the run records, the faults' record); the model and
    the engines are gone when it returns."""
    import torch
    from repro_torch.frontdoor import selfcheck
    cfg, params = serve_model(torch.float32, dev)
    serve = {}
    for armed in (False, True):
        key = "a_armed" if armed else "a_unarmed"
        _, serve[key] = serve_run(params, cfg, "kernel", SAN_REQUESTS,
                                  list(SAN_BUDGETS), drive=sanitize_drive(armed))
        free_cuda()
    a, u = serve["a_armed"], serve["a_unarmed"]
    rep = a["sanitize"]
    check(a["outs"] == u["outs"], "phase 18a: armed tokens differ from unarmed")
    check(rep["ticks"] == len(a["tick_s"]) and min(rep["counts"].values()) > 0,
          f"phase 18a: {rep} over {len(a['tick_s'])} ticks")
    for r in (a, u):
        check(r["pool"]["free"] == r["pool"]["total"] and r["pool"]["in_use"] == 0,
              f"phase 18a: pool after the drain {r['pool']}")
    check_family_run(u, cfg)
    check_family_run(a, cfg)
    faults = sanitize_faults(params, cfg)
    free_cuda()
    _, serve["d_selfcheck"] = serve_run(
        params, cfg, "kernel", len(selfcheck.CHAOS_TENANTS) * DOOR_CHAOS_REQUESTS,
        DOOR_NEW, drive=door_chaos_drive(None, sanitize=True),
        prompt_len=DOOR_PROMPT, sync_every=2)
    d = serve["d_selfcheck"]
    check(d["door"]["tokens"] == door_tokens, "phase 18d: tokens differ from "
          f"phase 16c's fault-free run: {d['door']['tokens']} vs {door_tokens}")
    check(d["sanitize"]["counts"]["cut_zeroing"] > 0,
          f"phase 18d: {d['sanitize']}")
    check_family_run(d, cfg)
    return serve, faults


def sanitize_phase(dev, door_tokens) -> dict:
    """Phase 18 (see the module docstring): ``sanitize_serving`` (18a, b,
    d), then 18c, the train loops (``sanitize_training``)."""
    t0 = time.perf_counter()
    serve, faults = sanitize_serving(dev, door_tokens)
    free_cuda()
    train_res = sanitize_training(dev)
    return {"serve": serve, "faults": faults, "train": train_res,
            "seconds": time.perf_counter() - t0}


def print_sanitize(card, res):
    a, u, d = (res["serve"][k] for k in ("a_armed", "a_unarmed", "d_selfcheck"))
    f, tr = res["faults"], res["train"]
    print(f"phase 18: the runtime sanitizer tier, {SERVE_ARCH} full width, "
          f"{SERVE_CODEC}, kernel read", flush=True)
    for key, r in (("a_unarmed", u), ("a_armed", a), ("d_selfcheck", d)):
        new = r["max_new"]
        new = f"({min(new)}..{max(new)})" if isinstance(new, list) else new
        print(f"  sanitize {key}: {r['completed']} requests of {r['prompt_len']}+"
              f"{new}, {r['decode_steps']} decode steps, {r['prefill_chunks']} prefill "
              f"chunks; circconv {r['shape_launches']}; paged "
              f"{r['launches']['paged_attention']}; checks "
              f"{r.get('sanitize', {}).get('counts', 'off')}", flush=True)
    print(f"  sanitize a: armed tokens equal unarmed; pool after the drain "
          f"{a['pool']}", flush=True)
    print(f"  sanitize d: [selfcheck] sanitize: {d['sanitize']['ticks']} ticks; "
          f"{d['sanitize']['report']}; tokens equal phase 16c's fault-free run",
          flush=True)
    print(f"  sanitize b: {SAN_PROBES} probes wrote nothing ({f['cache_gb']:.2f} "
          f"GB of cache and the state bitwise); unmasked probe dead-row |cut| "
          f"sum {f['dead_row_cut_sum']!r}; trips: " + "; ".join(
              f"{k}: {v[:70]!r}" for k, v in f["trips"].items()), flush=True)
    print(f"  sanitize c: {tr['arch']} x {tr['layers']}, armed losses equal "
          "unarmed: " + "; ".join(f"{k} {r['losses']}" for k, r in tr["runs"].items()
                                  if k.endswith("_armed"))
          + f"; NaN step: {tr['nan_step'][:110]!r}; finite_outputs on the card: "
          + ", ".join(tr["wrapper_trips"]), flush=True)
    med = lambda r: statistics.median(r["tick_s"]) * 1e3  # noqa: E731
    mean = lambda r: statistics.mean(r["tick_s"]) * 1e3  # noqa: E731
    print(f"time [{card}] sanitize tick armed {med(a):.1f} ms median, "
          f"{mean(a):.1f} mean over {len(a['tick_s'])} ticks vs unarmed "
          f"{med(u):.1f} / {mean(u):.1f} over {len(u['tick_s'])}; run "
          f"{a['wall_s']:.3f} s vs {u['wall_s']:.3f} s; the probe alone "
          f"{statistics.median(f['probe_ms']):.1f} ms (median of "
          f"{SAN_PROBES}, host read included)", flush=True)
    runs = tr["runs"]
    print(f"time [{card}] sanitize train step " + "; ".join(
        f"{loop} armed {runs[loop + '_armed']['step_ms']:.1f} ms vs unarmed "
        f"{runs[loop + '_unarmed']['step_ms']:.1f} ms (armed without anomaly "
        f"mode {runs[loop + '_armed']['checks_only_step_ms']:.1f} ms)"
        for loop in ("standard", "pipeline"))
        + f" (median of {SAN_STEPS}, host included)", flush=True)
    print(f"sanitize: phase seconds {res['seconds']:.1f}", flush=True)


# --------------------------------------------------------------------------
# phase 19: the dry run's analytic half on meta, against a real step
# --------------------------------------------------------------------------

# phase 7's batch as a dry-run shape (in SHAPES while 19b and 19c run)
DRY_SHAPE = "lm_16x128"
# 19a: decode_32k for every arch, train_4k for a dense and an MLA + MoE
# arch (about 25 s of host time on the card's machine; the CPU tests hold
# every arch's analytic numbers to the reference's), the sweep cut short
# past DRY_SWEEP_BUDGET_S
DRY_SWEEP_TRAIN = ("deepseek-7b", "deepseek-v2-lite-16b")
DRY_SWEEP_BUDGET_S = 40.0
# M = 2 against M = 1 from the same weights: the same rows in each C3-SL
# group, the sums in another order (the matmuls over 8 rows, not 16)
DRY_M2_LOSS_TOL = 1e-5
# M = 2's activations (the peak less what was allocated before, the
# arguments and the gradient trees held: one at M = 1, the sum and a
# microbatch's at M = 2) at most this share of M = 1's: half the rows a
# microbatch, with room for what does not halve
DRY_M2_ACT_SHARE = 0.75


@contextlib.contextmanager
def dry_shape():
    """DRY_SHAPE in ``SHAPES`` for the scope's length."""
    from repro_torch.data.pipeline import SHAPES
    SHAPES[DRY_SHAPE] = dict(seq_len=LM_SEQ, global_batch=LM_BATCH, kind="train")
    try:
        yield
    finally:
        del SHAPES[DRY_SHAPE]


def dryrun_sweep() -> dict:
    """19a: ``dryrun_one`` at full width for every registered arch at
    decode_32k, then for DRY_SWEEP_TRAIN at train_4k, until
    DRY_SWEEP_BUDGET_S of host time is spent; ``memory_allocated`` the
    same before and after."""
    import torch
    from repro_torch.configs.archs import ALL_ARCHS
    from repro_torch.launch import dryrun

    combos = [(a, s) for s in ("decode_32k", "train_4k") for a in ALL_ARCHS]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    runs, left_out = [], []
    for arch, shape in combos:
        if ((shape == "train_4k" and arch not in DRY_SWEEP_TRAIN)
                or time.perf_counter() - t0 > DRY_SWEEP_BUDGET_S):
            left_out.append(f"{arch} {shape}")
            continue
        t1 = time.perf_counter()
        r = dryrun.dryrun_one(arch, shape, save=False)
        check(r["status"] == "ok", f"phase 19a: {arch} {shape} {r['status']}")
        runs.append({"arch": arch, "shape": shape,
                     "seconds": time.perf_counter() - t1,
                     **{k: r[k] for k in (
                         "params_global", "params_active", "hlo_flops_per_device",
                         "model_flops_global", "useful_flops_ratio",
                         "fits_one_card", "roofline", "dominant")},
                     "argument_bytes": r["per_device"]["argument_bytes"]})
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    check(mem1 == mem0, f"phase 19a: memory_allocated {mem0} -> {mem1}")
    check(runs, "phase 19a: no combination ran")
    return {"runs": runs, "left_out": left_out, "memory_allocated": [mem0, mem1],
            "seconds": time.perf_counter() - t0}


def dryrun_step(dev) -> dict:
    """19b: phase 7's step (deepseek-7b, 8 of 30 layers, B 16, S 128,
    float32, TF32 off, ``c3sl:R=4`` at the midpoint) dry-run on meta, then
    ``dryrun.build_train_step`` on the card from the seed's weights with
    LM_CODEC: the counted FLOPs by op equal to the meta count, the argument
    bytes to the real tensors'; 2 + 2 four-step launches a step at (4, 4,
    524288); LM_TIMED_STEPS steps timed (CUDA events, host included); the
    peak memory; then M = 2 from the same weights: B1/B2 at G 2, the
    microbatch's groups, 2 + 2 a microbatch; the loss within
    DRY_M2_LOSS_TOL of M = 1's; the activations at most DRY_M2_ACT_SHARE
    of M = 1's.  Launches counted from the first step to the last, read
    after it.  Runs inside ``dry_shape()``."""
    from collections import Counter

    import torch
    from repro_torch.interop import tree_leaves
    from repro_torch.kernels import circconv
    from repro_torch.launch import dryrun, train
    from repro_torch.models import lm as lm_lib

    cfg = lm_config()
    G, R, D = LM_SHAPE
    t0 = time.perf_counter()
    dry = dryrun.dryrun_one(LM_ARCH, DRY_SHAPE, codec_kind="c3sl:R=4",
                            save=False, cfg_override=cfg,
                            param_dtype=torch.float32)
    dry_s = time.perf_counter() - t0
    args = lm_args(None)

    def fresh(M):
        params = lm_lib.init_lm_params(args.seed, cfg, device=dev)
        codec, cp = train.make_codec(LM_CODEC, LM_SEQ * cfg.d_model,
                                     max_R=LM_BATCH, device=dev)
        opt, step = dryrun.build_train_step(cfg, codec, cp, num_microbatches=M)
        return (params, opt.init(params), lm_batch(cfg, args, 0, dev)), step

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    real, step = fresh(1)
    arg_bytes = dryrun.tree_bytes(real)
    tree_bytes = sum(4 * t.numel() for t in tree_leaves(real[0]))
    check(arg_bytes == dry["per_device"]["argument_bytes"],
          f"phase 19b: argument bytes {arg_bytes} on the card, "
          f"{dry['per_device']['argument_bytes']} on meta")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    circconv.reset_launch_counts()
    out, flops, by_op = dryrun.count_flops(step, *real)
    torch.cuda.synchronize()
    peak1 = torch.cuda.max_memory_allocated()
    loss1 = float(out[2])
    del out                    # the step returns the params and state it was given
    shapes = {f"{k[0]}/{k[1]}x{k[2]}x{k[3]}": n
              for k, n in circconv.SHAPE_LAUNCHES.items()}
    want_shapes = {f"{k}/{G}x{R}x{D}": 2 for k in ("bind_superpose", "unbind")}
    check(shapes == want_shapes, f"phase 19b: shapes {shapes}, want {want_shapes}")
    check_fft_route(route_counts(), 2, "phase 19b", route="fft4")
    ops = set(by_op) | set(dry["flops_by_op"])
    differ = {op: [by_op.get(op, 0), dry["flops_by_op"].get(op, 0)] for op in ops
              if by_op.get(op, 0) != dry["flops_by_op"].get(op, 0)}
    check(flops == dry["hlo_flops_per_device"] and not differ,
          f"phase 19b: counted FLOPs {flops} on the card, "
          f"{dry['hlo_flops_per_device']} on meta; by op (card, meta) {differ}")
    check(math.isfinite(loss1), f"phase 19b: loss {loss1}")

    def one():
        step(*real)

    step_ms = cuda_ms(one, warmup=0, calls=1, reps=LM_TIMED_STEPS,
                      hide_host=False)
    del real, step, one
    free_cuda()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base   # the twiddle tables kept per D

    real, step = fresh(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = Counter(circconv.SHAPE_LAUNCHES)
    loss2 = float(step(*real)[2])
    torch.cuda.synchronize()
    peak2 = torch.cuda.max_memory_allocated()
    shapes2 = {f"{k[0]}/{k[1]}x{k[2]}x{k[3]}": n
               for k, n in (circconv.SHAPE_LAUNCHES - before).items()}
    # 2 + 2 a microbatch (forward and backward), at half the groups
    want2 = {f"{k}/{G // 2}x{R}x{D}": 2 * 2 for k in ("bind_superpose", "unbind")}
    check(shapes2 == want2, f"phase 19b: M = 2 shapes {shapes2}, want {want2}")
    counts, by_kernel = dict(circconv.LAUNCHES), record_launches()
    n = 2 * (1 + LM_TIMED_STEPS) + 2 * 2
    check(counts == {"bind_superpose": n, "unbind": n},
          f"phase 19b: launches {counts}, want {n} each")
    del real, step
    free_cuda()
    gap = abs(loss2 - loss1) / abs(loss1)
    check(gap <= DRY_M2_LOSS_TOL, f"phase 19b: M = 2 loss {loss2} vs M = 1 {loss1}")
    act1 = peak1 - base - arg_bytes - tree_bytes
    act2 = peak2 - base - left - arg_bytes - 2 * tree_bytes
    check(act2 <= DRY_M2_ACT_SHARE * act1,
          f"phase 19b: M = 2 activations {act2} B over {DRY_M2_ACT_SHARE} of "
          f"M = 1's {act1} (peaks {peak2}, {peak1}; trees of {tree_bytes})")
    compute_s = dry["roofline"]["compute_s"]
    return {"arch": LM_ARCH, "layers": cfg.num_layers, "batch": LM_BATCH,
            "seq": LM_SEQ, "codec": LM_CODEC, "dry": dry, "dry_s": dry_s,
            "flops_card": flops, "flops_by_op_card": by_op,
            "argument_bytes_card": arg_bytes, "shape_launches": shapes,
            "shape_launches_m2": shapes2,
            "launches": counts, "record_launches": by_kernel,
            "loss_m1": loss1, "loss_m2": loss2, "loss_gap": gap,
            "peak_m1": peak1, "peak_m2": peak2, "left_after_m1": left,
            "base_bytes": base, "tree_bytes": tree_bytes,
            "activations_m1": act1, "activations_m2": act2,
            "step_ms": step_ms,
            "timed_steps": LM_TIMED_STEPS,
            "share_of_compute_bound": compute_s / (step_ms / 1e3)}


def dryrun_pipeline(pipe) -> dict:
    """19c: ``pipeline_dryrun`` at phase 17's settings against each of its
    runs' ``loss.last_call`` record: payloads, their bytes and the
    schedule's steps exactly."""
    from repro_torch.launch import dryrun
    out = {}
    for depth, run in pipe["runs"].items():
        p = dryrun.pipeline_dryrun(LM_ARCH, R=4, num_microbatches=PIPE_MICROBATCHES,
                                   shape_name=DRY_SHAPE, save=False,
                                   codec_kind="c3sl:R=4", async_depth=depth)
        got = {"payloads": p["payloads_per_step"],
               "payload_bytes": p["payload_bytes_per_step"],
               "steps": p["schedule_steps"]}
        want = {k: run["call"][k] for k in got}
        check(got == want, f"phase 19c depth {depth}: dry run {got}, "
              f"phase 17's record {want}")
        out[depth] = {"dry": p, "record": run["call"]}
    return out


def dryrun_phase(dev, pipe) -> dict:
    """Phase 19: 19a, then 19b, then 19c."""
    t0 = time.perf_counter()
    sweep = dryrun_sweep()
    with dry_shape():
        step = dryrun_step(dev)
        pipeline = dryrun_pipeline(pipe)
    return {"sweep": sweep, "step": step, "pipeline": pipeline,
            "seconds": time.perf_counter() - t0}


def print_dryrun(card, res):
    sw, st = res["sweep"], res["step"]
    print(f"phase 19: the dry run on meta (repro_torch.launch.dryrun), "
          f"{len(sw['runs'])} combinations at full width in "
          f"{sw['seconds']:.1f} s of host time, memory_allocated "
          f"{sw['memory_allocated'][0]} -> {sw['memory_allocated'][1]} B; left "
          f"out {sw['left_out'] or 'none'}", flush=True)
    for r in sw["runs"]:
        t = r["roofline"]
        print(f"  dryrun {r['arch']} {r['shape']} bf16: params "
              f"{r['params_global']:.4g} (active {r['params_active']:.4g}), "
              f"counted FLOPs {r['hlo_flops_per_device']:.4g}, model_flops "
              f"{r['model_flops_global']:.4g}, useful {r['useful_flops_ratio']:.4f}, "
              f"args {r['argument_bytes'] / 1e9:.2f} GB vs 80 GB (fits "
              f"{r['fits_one_card']}); roofline compute {t['compute_s']:.4g} s, "
              f"memory {t['memory_s']:.4g} s, collective {t['collective_s']:.4g} s, "
              f"dominant {r['dominant']}; {r['seconds']:.1f} s", flush=True)
    d = st["dry"]
    t = d["roofline"]
    print(f"dryrun vs step {st['arch']} x{st['layers']} B {st['batch']} S "
          f"{st['seq']} float32 (meta {st['dry_s']:.1f} s): counted FLOPs meta "
          f"{d['hlo_flops_per_device']:,d} card {st['flops_card']:,d} (by op "
          f"{d['flops_by_op']}); model_flops {d['model_flops_global']:.4g}, "
          f"useful {d['useful_flops_ratio']:.4f}; argument bytes meta "
          f"{d['per_device']['argument_bytes']:,d} card "
          f"{st['argument_bytes_card']:,d}; launches {st['launches']} by shape "
          f"(first step) {st['shape_launches']}", flush=True)
    print(f"time [{card}] dryrun train step ({st['codec']}, M 1): "
          f"{st['step_ms']:.1f} ms (median of {st['timed_steps']}, host "
          f"included) against roofline compute_s {t['compute_s'] * 1e3:.1f} ms "
          f"at the float32 peak ({st['share_of_compute_bound']:.1%} of the "
          f"bound), memory_s {t['memory_s'] * 1e3:.2f} ms; peak "
          f"{st['peak_m1'] / 1e9:.2f} GB against argument bytes "
          f"{d['per_device']['argument_bytes'] / 1e9:.2f} GB; M 2: loss "
          f"{st['loss_m2']:.6f} vs {st['loss_m1']:.6f} (rel {st['loss_gap']:.3g}, "
          f"limit {DRY_M2_LOSS_TOL}), peak {st['peak_m2'] / 1e9:.2f} GB "
          f"(two gradient trees of {st['tree_bytes'] / 1e9:.2f} GB), "
          f"activations {st['activations_m2'] / 1e9:.2f} GB vs M 1's "
          f"{st['activations_m1'] / 1e9:.2f} (limit {DRY_M2_ACT_SHARE} of "
          f"them), B1/B2 {st['shape_launches_m2']}; {st['left_after_m1']} B "
          "left from M 1's run",
          flush=True)
    for depth, p in res["pipeline"].items():
        print(f"dryrun pipeline depth {depth}: {p['dry']['payloads_per_step']} "
              f"payloads of {p['dry']['payload_shape']} "
              f"({p['dry']['payload_bytes_per_step']:,d} B) over "
              f"{p['dry']['schedule_steps']} steps, equal to phase 17's record "
              f"{p['record']}", flush=True)
    print(f"dryrun: phase seconds {res['seconds']:.1f}", flush=True)


# --------------------------------------------------------------------------
# phase 20: the host-sync audit (the port's lint rule R3 against the card)
# --------------------------------------------------------------------------

PORT_SRC = ROOT / "src" / "repro_torch"
# each request's budget: no slot finishes inside the audited windows, rounds
# or steps, so all 8 slots stay live
AUDIT_NEW = 48
# run_standard's steps under the recorder; its loop's sites are counted a step
AUDIT_LM_STEPS = 2
# the step path's functions that must never sync (C9 stays fixed)
NO_SYNC_FUNCS = ("masked_write", "decode_step", "prefill_chunk")
# the README section whose table lists the sync sites no static rule sees
ACCEPTED_HEADING = "Sync sites no static rule sees"


class SyncRecorder:
    """Within the block, ``torch.cuda.set_sync_debug_mode("warn")``; each
    "synchronizing CUDA operation" warning is kept with the port's frames on
    the stack when it was raised (innermost first: (path from the repo root,
    line, function)) and ``tag(frames)``'s value, ``frames`` the raw frame
    objects innermost first.  Other warnings pass through."""

    def __init__(self, tag=None):
        self.tag = tag
        self.records = []
        self._rel = {}

    def _port_path(self, filename):
        if filename not in self._rel:
            try:
                rel = Path(filename).resolve().relative_to(ROOT)
            except ValueError:
                rel = None
            self._rel[filename] = (str(rel) if rel is not None
                                   and rel.parts[:2] == ("src", "repro_torch")
                                   else None)
        return self._rel[filename]

    def _hook(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return self._show(message, category, filename, lineno, file, line)
        raw, f = [], sys._getframe(1)
        while f is not None:
            raw.append(f)
            f = f.f_back
        frames = [(p, fr.f_lineno, fr.f_code.co_name) for fr in raw
                  if (p := self._port_path(fr.f_code.co_filename)) is not None]
        self.records.append({"frames": frames,
                             "tag": None if self.tag is None else self.tag(raw)})
        del raw

    def __enter__(self):
        import warnings
        import torch
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._hook
        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(self._mode)
        self._catch.__exit__(*exc)
        return False


def sync_sites(records, keep=lambda tag: True) -> dict:
    """{"path:line": {"count", "func", "via"}} over the records whose tag
    ``keep`` accepts and that have a port frame: a site is the innermost
    port frame; ``via``, the port functions outward from it."""
    sites = {}
    for r in records:
        if not r["frames"] or not keep(r["tag"]):
            continue
        path, line, func = r["frames"][0]
        s = sites.setdefault(f"{path}:{line}", {
            "count": 0, "func": func,
            "via": [f"{fn} ({p.rsplit('/', 1)[-1]}:{ln})"
                    for p, ln, fn in r["frames"][1:4]]})
        s["count"] += 1
    return sites


def through_no_sync(records) -> list:
    """The records raised inside one of ``NO_SYNC_FUNCS`` (any port frame)."""
    return [r for r in records
            if any(fn in NO_SYNC_FUNCS for _, _, fn in r["frames"])]


def r3_spans(report, read) -> dict:
    """{path: [(first line, last line, "finding" | "suppressed")]} of the
    port's R3 report; a finding covers its construct's lines (a call split
    over lines raises from the line of its method name).  ``read(path)``
    gives a file's source."""
    import ast
    trees, spans = {}, {}
    for kind, found in (("finding", report.findings),
                        ("suppressed", report.suppressed)):
        for f in found:
            if f.rule != "R3":
                continue
            if f.path not in trees:
                trees[f.path] = ast.parse(read(f.path))
            end = max((n.end_lineno for n in ast.walk(trees[f.path])
                       if getattr(n, "lineno", None) == f.line
                       and getattr(n, "col_offset", None) == f.col), default=f.line)
            spans.setdefault(f.path, []).append((f.line, end, kind))
    return spans


def accepted_sync_sites(readme: str) -> set:
    """{(path, stripped source line)} from the README's table under
    ``ACCEPTED_HEADING``: its first two columns, each in backquotes."""
    out, inside = set(), False
    for line in readme.splitlines():
        if line.startswith("#"):
            inside = ACCEPTED_HEADING in line
            continue
        m = re.match(r"\|\s*`([^`]+)`\s*\|\s*`(.+?)`\s*\|", line) if inside else None
        if m:
            out.add((m[1], m[2].replace("\\|", "|").strip()))
    return out


def sync_verdicts(sites, spans, accepted, read) -> dict:
    """{"path:line": "R3 finding" | "R3 suppressed" | "README table" | None}."""
    out = {}
    for key in sites:
        path, line = key.rsplit(":", 1)
        line = int(line)
        hit = [k for lo, hi, k in spans.get(path, ()) if lo <= line <= hi]
        if hit:
            out[key] = "R3 " + ("finding" if "finding" in hit else "suppressed")
        else:
            src = read(path).splitlines()
            code = src[line - 1].strip() if 0 < line <= len(src) else ""
            out[key] = "README table" if (path, code) in accepted else None
    return out


def _settled(eng):
    """Admit every queued request and run their prefill chunks (the
    engine's boundary and ``_prefill_one_chunk``, as ``tick()`` runs
    them), so every slot decodes next."""
    eng._boundary()
    while eng._pending_prefill():
        eng._prefill_one_chunk()
    eng._boundary()


def audit_serving(dev) -> dict:
    """20a-c on phase 4's model: the chunked engine's decode window (8 live
    slots, ``sync_every`` steps), a speculative window of one round at k
    ``SPEC_K`` (tied head, phase 15a's link), and a legacy-mode ``step()``,
    each twice (the first after the engine's set-up, the second the
    steady one), under ``SyncRecorder``; the prefill chunks before them
    are recorded too, for the no-sync check."""
    import torch
    from repro_torch.serving.engine import Request
    from repro_torch.serving.spec import SpecConfig
    cfg, params = serve_model(torch.float32, dev)
    prompts = serve_prompts(SERVE_ENGINE["num_slots"], cfg.vocab_size)
    runs = {}
    plans = (("a_window", "step", {}, SERVE_ENGINE["sync_every"]),
             ("b_spec_round", "round", dict(codec=SPEC_LINK, spec_decode=SpecConfig(
                 k=SPEC_K, draft_head="tied")), SPEC_K),
             ("c_legacy_step", "step", dict(prefill_mode="decode"), None))
    for key, unit, over, n in plans:
        eng = make_engine(params, cfg, "kernel", **over)
        for u, p in enumerate(prompts):
            eng.submit(Request(uid=u, prompt=p, max_new_tokens=AUDIT_NEW))
        rec = {"prefill": SyncRecorder()}
        if n is not None:
            with rec["prefill"]:
                _settled(eng)
        units = []
        for rnd in ("first", "steady"):
            torch.cuda.synchronize()
            rounds0 = eng.stats["spec_rounds"]
            with SyncRecorder() as r:
                if n is None:
                    eng.step()
                    done = 1
                else:
                    done = eng._decode_window(n)
                torch.cuda.synchronize()
            if unit == "round":
                done = eng.stats["spec_rounds"] - rounds0
            live = (eng.active if n is None else
                    int((eng.state["active"] & ~eng.state["done"]).sum()))
            rec[rnd] = r
            units.append(done)
            check(live == SERVE_ENGINE["num_slots"] and done >= 1,
                  f"phase 20 {key} {rnd}: {live} live slots, {done} {unit}s")
        runs[key] = {"units": units, "unit": unit,
                     "records": {k: v.records for k, v in rec.items()}}
        del eng
        free_cuda()
    del params
    free_cuda()
    return runs


def audit_training(dev) -> dict:
    """20d: ``run_standard`` on phase 7's model for ``AUDIT_LM_STEPS`` steps,
    each with its log line, under ``SyncRecorder``; a record is tagged
    with the loop's step index when the loop's frame is inside the loop,
    else None (the set-up before the loop and the losses' deferred
    conversion after it)."""
    import ast
    from repro_torch.launch import train
    tree = ast.parse(Path(train.__file__).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_standard")
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For))
    lo, hi = loop.lineno, loop.end_lineno
    train_file = str(Path(train.__file__).resolve())

    def tag(raw):
        for f in raw:
            if f.f_code.co_name == "run_standard" and \
                    str(Path(f.f_code.co_filename).resolve()) == train_file:
                return f.f_locals.get("step") if lo <= f.f_lineno <= hi else None
        return None

    args = lm_args(None, extra=["--steps", str(AUDIT_LM_STEPS)])
    with SyncRecorder(tag) as r:
        losses = train.run_standard(args, lm_config())
    check(len(losses) == AUDIT_LM_STEPS and all(map(math.isfinite, losses)),
          f"phase 20d: losses {losses}")
    free_cuda()
    return {"units": [1] * AUDIT_LM_STEPS, "unit": "step", "loop_lines": [lo, hi],
            "losses": losses, "records": {"run": r.records}}


def sync_audit_phase(dev) -> dict:
    """Phase 20 (see the module docstring): record (``audit_serving``,
    ``audit_training``), then hold every recorded site to the port's R3
    report or the README's table, and the step path's functions to no
    sync at all."""
    from repro_torch.analysis.lint import lint_paths
    t0 = time.perf_counter()
    runs = audit_serving(dev)
    runs["d_lm_step"] = audit_training(dev)
    report = lint_paths([PORT_SRC], rules={"R3"}, root=ROOT)

    def read(path):
        return (ROOT / path).read_text(encoding="utf-8")

    spans = r3_spans(report, read)
    accepted = accepted_sync_sites(read("src/repro_torch/README.md"))
    out = {}
    for key, run in runs.items():
        recs = run["records"]
        if key == "d_lm_step":
            parts = {f"step {i}": sync_sites(recs["run"], lambda t, i=i: t == i)
                     for i in range(AUDIT_LM_STEPS)}
            everything = recs["run"]
            in_loop = [r for r in everything if r["tag"] is not None]
        else:
            parts = {k: sync_sites(recs[k]) for k in ("first", "steady")}
            everything = [r for k in ("prefill", "first", "steady") for r in recs[k]]
            in_loop = [r for k in ("first", "steady") for r in recs[k]]
        sites = sync_sites(in_loop)
        verdicts = sync_verdicts(sites, spans, accepted, read)
        bad = through_no_sync(everything)
        out[key] = {"unit": run["unit"], "units": run["units"], "parts": parts,
                    "sites": sites, "verdicts": verdicts,
                    "no_sync_violations": [r["frames"][:4] for r in bad],
                    "outside_loop": len(everything) - len(in_loop),
                    **{k: run[k] for k in ("losses", "loop_lines") if k in run}}
    res = {"runs": out, "r3": {"findings": len(report.findings),
                               "suppressed": len(report.suppressed)},
           "accepted": sorted(f"{p}: {c}" for p, c in accepted),
           "seconds": time.perf_counter() - t0}
    for key, r in out.items():
        unseen = [s for s, v in r["verdicts"].items() if v is None]
        check(not unseen, f"phase 20 {key}: sync sites neither in the port's R3 "
              f"report nor in the README's table: {unseen}")
        check(not r["no_sync_violations"], f"phase 20 {key}: a sync inside "
              f"{NO_SYNC_FUNCS}: {r['no_sync_violations'][:3]}")
    return res


def print_sync_audit(card, res):
    print(f"phase 20: the host-sync audit, torch.cuda.set_sync_debug_mode"
          f"(\"warn\"): a-c {SERVE_ARCH} full width and depth ({SERVE_CODEC}, "
          f"kernel read, 8 live slots), d phase 7's model ({LM_ARCH} x "
          f"{LM_LAYERS} of 30 layers, B {LM_BATCH}, S {LM_SEQ}); port R3: "
          f"{res['r3']['findings']} findings, {res['r3']['suppressed']} "
          f"suppressed; README table: {len(res['accepted'])} sites", flush=True)
    for key, r in res["runs"].items():
        names = list(r["parts"])
        print(f"  sync {key}: {r['units']} {r['unit']}s in {names}; "
              f"{len(r['sites'])} sites, {sum(s['count'] for s in r['sites'].values())} "
              f"syncs; {r['outside_loop']} more in the prefill, set-up or "
              f"after the loop (held only to none inside "
              f"{', '.join(NO_SYNC_FUNCS)}: none)", flush=True)
        for site, s in sorted(r["sites"].items(), key=lambda kv: -kv[1]["count"]):
            counts = [r["parts"][p].get(site, {}).get("count", 0) for p in names]
            per = ", ".join(f"{c / u:g}" for c, u in zip(counts, r["units"]))
            print(f"  sync [{card}] {key} {site} {s['func']}: {counts} in "
                  f"{names} ({per} a {r['unit']}); {r['verdicts'][site]}; via "
                  f"{' < '.join(s['via']) or '-'}", flush=True)
    print(f"sync audit: phase seconds {res['seconds']:.1f}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = "cuda"
    # the port is compared on the card in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    elapsed = {}
    t_start = t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        elapsed[name] = now - t0
        t0 = now

    # one nvcc per source, all started together
    sources = list(build.SIGNATURES)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load, sources))
    lap("build")
    build_s = elapsed["build"]
    print(f"build: {build_s:.2f} s for {', '.join(f'csrc/{n}.cu' for n in sources)}",
          flush=True)
    for name in sources:
        for line in build.build_logs[name].splitlines():
            entry = re.search(r"\d+([a-z][a-z_]*_kernel)I(\w+?)E", line)
            if "Compiling entry" in line and entry:
                print(f"  ptxas {name}: {entry[1]}<{entry[2].lstrip('0123456789')}>")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}:   {line.strip()}")

    errs = kernel_checks(dev)
    print("kernels: " + "; ".join(
        f"{k} vs plain max_abs_err f32 "
        f"{max(e for s, e in v.items() if s.endswith('float32')):.3g} "
        f"bf16 {max(e for s, e in v.items() if s.endswith('bfloat16')):.3g} "
        f"grad {max((e for s, e in v.items() if s.startswith('grad')), default=math.nan):.3g}"
        for k, v in errs.items()), flush=True)
    errs.update(paged_kernel_checks(dev))
    summary = {k: max(v.values()) for k, v in errs.items()}
    print("paged kernels vs plain max_abs_err: " + "; ".join(
        f"{k} f32 {max(e for s, e in errs[k].items() if s.endswith('float32')):.3g} "
        f"bf16 {max(e for s, e in errs[k].items() if s.endswith('bfloat16')):.3g}"
        for k in ("paged_attention", "paged_attention_quant")), flush=True)
    print("bf16 worst readings (max|err|/max|want| limit "
          f"{BF16_REL_MAX}, rel L2 limit {BF16_REL_L2}): " + "; ".join(
              f"{k} {m:.3g} / {l2:.3g}" for k, (m, l2) in BF16_READINGS.items()),
          flush=True)
    lap("kernel_checks")

    parity = {m: step0_parity(m, "c3sl:R=4,backend=pallas", dev)
              for m in ("vgg16", "resnet50")}
    print(f"step-0 parity vs backend=direct: {json.dumps(parity)}", flush=True)

    main_run = run_steps("vgg16", "c3sl:R=4,backend=pallas", MAIN_STEPS, dev)
    print(f"main path vgg16 c3sl:R=4,backend=pallas: {MAIN_STEPS} steps, "
          f"launches {main_run['launches']}, loss {main_run['losses'][0]:.4f} -> "
          f"{main_run['losses'][-1]:.4f}", flush=True)
    other_runs = [run_steps("vgg16", "c3sl:R=4,backend=pallas|int8", SHORT_STEPS, dev),
                  run_steps("resnet50", "c3sl:R=4,backend=pallas", SHORT_STEPS, dev)]
    for r in other_runs:
        print(f"path {r['model']} {r['spec']}: {r['steps']} steps, launches "
              f"{r['launches']}, losses {[round(v, 4) for v in r['losses']]}",
              flush=True)
    free_cuda()
    lap("train_path")

    serve = serving_path(dev)
    tf, rk, rg, rq = (serve[k] for k in ("teacher_forced", "kernel_run",
                                         "gather_run", "quant_run"))
    print(f"serving {SERVE_ARCH} full width, {SERVE_CODEC}: teacher-forced "
          f"kernel vs gather logit gap {max(tf['gap_of_max_logit']):.3g} of "
          f"max|logit| (limit {LOGIT_TOL})", flush=True)
    for r in (rk, rg, rq):
        print(f"serve kv_read={r['kv_read']} ({r['kv_read_execution_mode']}): "
              f"{r['completed']} requests, {r['generated']} tokens, "
              f"{r['decode_steps']} decode steps, {r['prefill_chunks']} prefill "
              f"chunks, launches {r['launches']}", flush=True)
    print(f"serve kernel vs gather greedy tokens: "
          f"{serve['agreement']['share_equal']:.4f} equal, first difference "
          f"at position {serve['agreement']['first_differing_position']}",
          flush=True)
    lap("serving_path")

    cp_par = cp_parity(dev)
    cp = control_plane(dev)
    cp_bits = cp_masked_decode_bitwise(dev)
    cp_t2 = cp_table2(dev)
    cp_bn = cp_bnpp_resnet(dev)
    free_cuda()
    lap("control_plane")
    print(f"control plane step-0 parity (R_fwd, R_bwd) = {cp_par['pair']}, "
          f"kernels vs backend=fft: loss rel err {cp_par['loss_rel_err']:.3g}, "
          f"grad leaf rel err {cp_par['grad_leaf_rel_err']:.3g}, cut grad rel "
          f"err {cp_par['cut_grad_rel_err']:.3g}, cut SNR {cp_par['cut_snr']}, "
          f"grad SNR {cp_par['bwd_snr']}", flush=True)
    print(f"control plane {cp['link']}: make ran {cp['make_calls']} times for "
          f"{len(cp['pairs'])} (R_fwd, R_bwd) pairs; {cp['executed']} VGG-16 "
          f"steps (B 64), served {cp['served']}, wire bytes checked on "
          f"{cp['wire_checked']} steps; launches {cp['launches']}, routes "
          f"{cp['route_launches']}; by (G, R) {cp['launches_by_shape']}",
          flush=True)
    for i, st in enumerate(cp["steps"]):
        print(f"  cp step {i:2d} {st['phase']:6s} R_fwd {st['R'][0]:2d} R_bwd "
              f"{st['R'][1]} cut SNR {st['cut_snr']:7.3f} dB grad SNR "
              f"{st['bwd_snr']:7.3f} dB loss {st['loss']:.4f} wire "
              f"{st['wire_bytes']} B")
    fl = cp["faults"]
    print(f"control plane faults {fl['rates']} + bursts at {fl['bursts']}, "
          f"retry budget {fl['retry_budget']} (erasure recovery): "
          f"ChannelErasure at fault steps {fl['erased_at']} (host replay "
          f"{fl['replayed_erasures']}), retransmitted at {fl['retransmitted_at']}, "
          f"{fl['erased_packets']} packets erased and renormalised; masked "
          f"decode at all ones bitwise the decode: {cp_bits}", flush=True)
    for name, row in cp_t2.items():
        b, h, r = row["bnpp"], row["c3sl"], row["ratios"]
        print(f"time [{card}] table2 {name} B=64 {b['spec']} vs {h['spec']}: "
              f"codec params on the card {b['param_bytes']} vs "
              f"{h['param_bytes']} B ({r['param_bytes']:.2f}x; param_count "
              f"{r['param_count']:.2f}x), codec fwd+bwd device time "
              f"{b['ms']:.4f} vs {h['ms']:.4f} ms ({r['ms']:.2f}x; flops "
              f"{r['flops']:.3f}x); with TF32 convolutions {b['ms_tf32']:.4f} "
              f"vs {h['ms_tf32']:.4f} ms ({r['ms_tf32']:.2f}x)", flush=True)
        for k in (b, h):
            for t in k["top"]:
                print(f"  {k['spec'].split(':')[0]} {t['ms']:.4f} ms x{t['calls']}"
                      f"  {t['name']}")
    print(f"resnet50 {cp_bn['spec']}: {CP_BNPP_STEPS} steps, losses "
          f"{[round(v, 4) for v in cp_bn['losses']]}, codec grad max "
          f"{ {k: f'{v:.3g}' for k, v in cp_bn['codec_grad_max'].items()} }",
          flush=True)

    times = {f"{G}x{R}x{D}": kernel_times(dev, G, R, D) for G, R, D in TIME_SHAPES}
    free_cuda()
    fft4t = fft4_times(dev)
    free_cuda()
    ptimes = paged_times(dev)
    steps = step_times(dev)
    prof = step_profile(dev)
    lap("times")
    for shape, per in times.items():
        for name, t in per.items():
            fft_ms = "-" if t["fft_ms"] is None else f"{t['fft_ms']:.4f} ms"
            print(f"time [{card}] {name} G,R,D={t['shape']} route {t['route']}: "
                  f"fft kernel {fft_ms}, direct kernel {t['direct_ms']:.4f} ms, "
                  f"routed kernel host included {t['ms_host_included']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, torch.fft {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}), direct-form "
                  f"FLOPs at the f32 peak {t['direct_flops_ms']:.4f} ms", flush=True)
    for key, t in fft4t.items():
        print(f"time [{card}] {key.split('/')[0]} G,R,D={t['shape']} route fft4 "
              f"{t['sides'][0]} x {t['sides'][1]}: kernel "
              f"{t['ms']:.4f} ms, host included {t['ms_host_included']:.4f} ms, "
              f"torch.fft {t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}, {t['bytes'] / 1e6:.1f} MB), keys' spectra "
              f"{t['key_spectra_ms']:.4f} ms once, direct kernel one "
              f"call {t['direct_one_call_ms']:.1f} ms; plain at "
              f"G,R,D={t['plain_shape']} {t['plain_ms']:.2f} ms; passes (profiler) "
              + ", ".join(f"{q['name']} {q['ms']:.4f}" for q in t["passes"]),
              flush=True)
    for name, per in ptimes.items():
        for shape, t in per.items():
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ms")
            where = (f"B{t['shape']['B']} pos {min(t['shape']['pos'])}-"
                     f"{max(t['shape']['pos'])}")
            g = t["shape"]
            print(f"time [{card}] {name} {shape} ({where}) T{g['length']} "
                  f"ps{g['ps']} H{g['H']} KV{g['KV']} hd{g['hd']} "
                  f"{t['dtype']}: kernel {t['ms']:.4f} ms "
                  f"({t['ms_host_included']:.4f} host included), splits "
                  f"{t['splits']} x chunk {t['chunk']}, plain "
                  f"{t['plain_ms']:.4f} ms, gather+sdpa {lib}, bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']}, "
                  f"{t['bytes'] / 1e6:.1f} MB; {t['share_of_bound']:.1%} of it)",
                  flush=True)
    print(f"time [{card}] vgg16 train step B=64 R=4: kernel backend "
          f"{steps['vgg16_step_ms_kernel']:.3f} ms, fft backend "
          f"{steps['vgg16_step_ms_fft']:.3f} ms", flush=True)
    if prof["device_ms_per_step"] is None:
        print(f"profile [{card}]: the profiler saw no device time (not measured)")
    else:
        print(f"profile [{card}] vgg16 step (kernel backend): device "
              f"{prof['device_ms_per_step']:.3f} ms of {prof['wall_ms_per_step']:.3f} ms "
              f"wall (busy {prof['busy_share']:.2f}); circconv kernels "
              f"{prof['circconv_ms_per_step']:.4f} ms ({prof['circconv_share']:.4f})",
              flush=True)
        for r in prof["top"]:
            print(f"  {r['ms_per_step']:.4f} ms x{r['calls_per_step']}  {r['name']}")
    for r in (rk, rg, rq):
        print(f"time [{card}] serve {SERVE_ARCH} kv_read={r['kv_read']} "
              f"{r['requests']}x({SERVE_PROMPT}+{r['max_new']}): "
              f"{r['wall_s']:.3f} s, {r['tokens_per_s']:.1f} generated tok/s, "
              f"mean TTFT {r['mean_ttft_ms']:.1f} ms", flush=True)
    print_window(card, SERVE_ARCH + " kernel read", serve["window"])

    free_cuda()
    lm = lm_training(dev, lm_config(), LM_SHAPE, ckpt=True)
    lap("lm_training")
    print_lm(card, lm)
    free_cuda()
    qwen = lm_training(dev, lm_config(QWEN_ARCH, QWEN_LAYERS), QWEN_SHAPE)
    lap("lm_training_qwen")
    print_lm(card, qwen)
    families = {}
    for phase, arch, layers, small, shape in FAMILY_RUNS:
        free_cuda()
        families[arch] = lm_training(
            dev, lm_config(arch, layers, small), shape,
            timed_steps=FAMILY_TIMED_STEPS,
            label="REDUCED (reduced())" if small else "full width")
        lap(f"lm_training_{arch}")
        print(f"phase {phase}:", flush=True)
        print_lm(card, families[arch])

    print("phase 13: serving the attention-cache families", flush=True)
    serve_families = {}
    for arch, layers in FAMILY_SERVE:
        free_cuda()
        serve_families[arch] = serve_family(dev, "phase 13", arch, layers,
                                            quant=True)
        lap(f"serving_{arch}")
        print_serve_family(card, serve_families[arch])

    print("phase 14: serving the stateful and memory families", flush=True)
    serve_states = {}
    for run, arch, layers, small in STATE_SERVE:
        free_cuda()
        serve_states[arch] = serve_family(dev, f"phase 14{run}", arch, layers,
                                          small=small)
        lap(f"serving_{arch}")
        print_serve_family(card, serve_states[arch])

    print("phase 15: serving II (speculative decoding, preemption, the "
          "legacy prefill mode)", flush=True)
    free_cuda()
    serve_ii = serve_family(dev, "phase 15", SERVE_ARCH, None,
                            plan=serving_ii_plan(), refs={"phase4": rk})
    lap("serving_ii")
    print_serve_family(card, serve_ii)

    print("phase 16: the networked front door over loopback", flush=True)
    free_cuda()
    door = frontdoor_phase(dev, rk)
    lap("frontdoor")
    print_frontdoor(card, door)

    free_cuda()
    pipe = pipeline_phase(dev, lm_config())
    lap("pipeline")
    print_pipeline(card, pipe, lm)

    print("phase 18: the runtime sanitizer tier", flush=True)
    free_cuda()
    san = sanitize_phase(dev, door["runs"]["c_fault_free"]["door"]["tokens"])
    lap("sanitize")
    print_sanitize(card, san)

    print("phase 19: the dry run's analytic half, against a real step", flush=True)
    free_cuda()
    dry = dryrun_phase(dev, pipe)
    lap("dryrun")
    print_dryrun(card, dry)

    print("phase 20: the host-sync audit", flush=True)
    free_cuda()
    audit = sync_audit_phase(dev)
    lap("sync_audit")
    print_sync_audit(card, audit)

    replaces = {"bind_superpose": "src/repro/kernels/circconv.py:134",
                "unbind": "src/repro/kernels/circconv.py:157",
                "paged_attention": "src/repro/kernels/paged_attention.py:142",
                "paged_attention_quant": "src/repro/kernels/paged_attention.py:173"}
    csrc = "src/repro_torch/kernels/csrc/"
    # every kernel entry point: (record name, wrapper, circconv route, source)
    entries = [("bind_superpose", "bind_superpose", "fft", "circconv_fft.cu"),
               ("unbind", "unbind", "fft", "circconv_fft.cu"),
               ("bind_superpose_direct", "bind_superpose", "direct", "circconv.cu"),
               ("unbind_direct", "unbind", "direct", "circconv.cu"),
               ("bind_superpose_mixed", "bind_superpose", "fft", "circconv_fft.cu"),
               ("unbind_mixed", "unbind", "fft", "circconv_fft.cu"),
               ("bind_superpose_fft4", "bind_superpose", "fft4", "circconv_fft4.cu"),
               ("unbind_fft4", "unbind", "fft4", "circconv_fft4.cu"),
               ("paged_attention", "paged_attention", None, "paged_attention.cu"),
               ("paged_attention_quant", "paged_attention_quant", None,
                "paged_attention.cu")]
    # at the shapes the record's launches ran: the FFT kernels' from the
    # routed float32 calls at the VGG-16 train step's shape and every
    # control-plane shape and phase 13's serving shapes, and from the
    # gradients; the paged kernels' at both serving geometries (KV 32, KV 8);
    # the direct kernels' from
    # their explicit calls at the train step's shape; the mixed-radix
    # one-pass kernels' at the four serving shapes; the four-step kernels'
    # at the LM training shapes and the pipeline's, against the float64
    # oracle
    serve_keys = ["{}x{}x{}/float32".format(*sh) for sh in MIXED_SERVE_SHAPES]
    lm_keys = ["{}x{}x{}/float32".format(*sh) for sh in LM_SHAPES]
    cp_keys = (["16x4x2048/float32"]
               + [f"{G}x{R}x{D}/float32" for G, R, D in cp_kernel_shapes() if D == 2048]
               + ["{}x{}x{}/float32".format(*sh) for sh in
                  FAMILY_SERVE_SHAPES + STATE_SERVE_SHAPES + SPEC_SERVE_SHAPES
                  + [(2, 4, 4096), (128, 4, 4096), (16, 4, 4096)]])
    main_errs = {"bind_superpose": max([errs["bind_superpose"][k] for k in cp_keys]
                                       + [errs["bind_superpose"]["grad 16x4x2048"]]),
                 "unbind": max([errs["unbind"][k] for k in cp_keys]
                               + [errs["unbind"]["grad 16x4x2048"]]),
                 "bind_superpose_direct":
                     errs["bind_superpose_direct"]["16x4x2048/float32"],
                 "unbind_direct": errs["unbind_direct"]["16x4x2048/float32"],
                 "bind_superpose_mixed": max(errs["bind_superpose_mixed"][k]
                                             for k in serve_keys),
                 "unbind_mixed": max(errs["unbind_mixed"][k] for k in serve_keys),
                 "bind_superpose_fft4": max(errs["bind_superpose_fft4"][k]
                                            for k in lm_keys),
                 "unbind_fft4": max(errs["unbind_fft4"][k] for k in lm_keys),
                 # the serving shape, in the dtype each serving run calls
                 "paged_attention": max(errs["paged_attention"][f"{g}/float32"]
                                        for g in ("main", "kv8", "jamba")),
                 "paged_attention_quant": max(
                     errs["paged_attention_quant"][f"{g}/bfloat16"]
                     for g in ("main", "kv8"))}
    # the circconv kernels' launches in each main-path run, counted by the
    # run and read just after it (record_launches): the one-pass kernels'
    # in the VGG-16 main run, the control plane's and the serving runs of
    # phases 13-16 and 18 (its probes' among them), the direct ones' in the
    # main run, the four-step ones' in the six LM training runs (phases
    # 7-12), the two pipeline runs (phase 17), phase 18's four armed and
    # unarmed train runs and phase 19b's steps, the mixed-radix
    # one-pass ones' over every run; of these only phase 14's pixtral-12b
    # (D 5120) takes a mixed-radix width, so that sum must be its decode
    # steps and prefill chunks
    def counted(name, runs):
        return sum(r["record_launches"].get(name, 0) for r in runs)

    lm_runs = [lm, qwen, *families.values(), *pipe["runs"].values(),
               *san["train"]["runs"].values(), dry["step"]]
    serve_runs = [r for f in (*serve_families.values(), *serve_states.values(),
                              serve_ii, door) for r in f["runs"].values()]
    serve_runs += list(san["serve"].values())
    path_runs = [main_run, *other_runs, rk, rg, rq, cp, *lm_runs, *serve_runs]
    one_pass_runs = [main_run, cp, *serve_runs]
    launches = {name: counted(name, runs) for name, runs in (
        ("bind_superpose", one_pass_runs), ("unbind", one_pass_runs),
        ("bind_superpose_direct", [main_run]), ("unbind_direct", [main_run]),
        ("bind_superpose_mixed", path_runs), ("unbind_mixed", path_runs),
        ("bind_superpose_fft4", lm_runs), ("unbind_fft4", lm_runs))}
    mixed = sum(r["decode_steps"] + r["prefill_chunks"]
                for r in serve_states["pixtral-12b"]["runs"].values())
    check(mixed > 0 and launches["bind_superpose_mixed"]
          == launches["unbind_mixed"] == mixed,
          f"mixed-radix one-pass launches on the main path: {launches}, want "
          f"{mixed} (pixtral-12b's)")
    launches.update({name: sum(r["launches"][name] for r in (rk, rg, rq,
                                                             *serve_runs))
                     for name in ("paged_attention", "paged_attention_quant")})
    vgg = times["16x4x2048"]

    def timing(name, wrapper, kernel_route):
        if kernel_route is None:
            t = ptimes[wrapper]["serving"]
            return {**{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "splits", "share_of_bound",
                                         "ms_host_included")},
                    **{shape: {k: ptimes[wrapper][shape][k] for k in (
                        "ms", "plain_ms", "bound_ms", "library_ms", "splits",
                        "share_of_bound", "ms_host_included")}
                       for shape in ("one_slot", "serving_kv8", "serving_jamba")}}
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                "direct_one_call_ms", "key_spectra_ms", "sides")
        if kernel_route == "fft4":
            # this slice's path's shape, the qwen2.5-32b LM step's, and the
            # others beside it
            t = fft4t["{}/{}x{}x{}".format(wrapper, *QWEN_SHAPE)]
            return {**{k: t[k] for k in keys + ("plain_shape",)},
                    "by_shape": {k.split("/")[1]: {k2: v[k2] for k2 in keys}
                                 for k, v in fft4t.items()
                                 if k.startswith(wrapper + "/")}}
        if name.endswith("_mixed"):
            # the prefill chunk at mistral-large-123b's width, and the other
            # serving shapes beside it
            by = {f"{G}x{R}x{D}": times[f"{G}x{R}x{D}"][wrapper]
                  for G, R, D in MIXED_SERVE_SHAPES}
            t = by["128x4x12288"]
            return {**{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "shape", "direct_ms")},
                    "by_shape": {k: {k2: v[k2] for k2 in (
                        "ms", "plain_ms", "bound_ms", "library_ms", "direct_ms")}
                        for k, v in by.items()}}
        t = vgg[wrapper]
        return {"ms": t[f"{kernel_route}_ms"],
                **{k: t[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": csrc + source,
         "replaces": replaces[wrapper],
         **({"circconv_route": kernel_route} if kernel_route else {}),
         "launches": launches[name], "max_abs_err": main_errs[name],
         **timing(name, wrapper, kernel_route)}
        for name, wrapper, kernel_route, source in entries]}
    elapsed["total"] = time.perf_counter() - t_start
    print(f"elapsed s: {json.dumps({k: round(v, 1) for k, v in elapsed.items()})}",
          flush=True)

    for r in (rk, rg, rq):
        r["outs"] = {str(k): v for k, v in r["outs"].items()}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "build_s": build_s, "elapsed_s": elapsed, "kernel_errors": errs,
        "max_errors": summary, "bf16_readings": BF16_READINGS,
        "step0_parity": parity, "main_run": main_run,
        "other_runs": other_runs, "serving": serve,
        "control_plane": {"parity": cp_par, "run": cp,
                          "masked_decode_bitwise": cp_bits, "table2": cp_t2,
                          "bnpp_resnet50": cp_bn},
        "kernel_times": times, "fft4_times": fft4t, "lm_training": lm,
        "lm_training_qwen": qwen, "lm_training_families": families,
        "serving_families": serve_families, "serving_states": serve_states,
        "serving_ii": serve_ii, "frontdoor": door, "pipeline": pipe,
        "sanitize": san, "dryrun": dry, "sync_audit": audit,
        "adjoint_gaps": ADJOINT_GAPS,
        "paged_kernel_times": ptimes, "step_times": steps,
        "step_profile": prof, "record": record},
        indent=1))
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
