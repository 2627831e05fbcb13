#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). It imports nothing of JAX or of ``paddle_tpu``.

1. Prints the card's name and power limit, builds the kernels from
   ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel) and
   prints the build seconds.
2. Kernel phases: holds each hand-written kernel against its plain PyTorch
   version on the card in bf16 at the main path's shapes (Llama-2-7B:
   32 heads of 128, hidden 4096, KV blocks of 16, vocab 32000, training
   batches of 4 x 2048 tokens), GQA shapes included, and times kernel,
   plain version, the one PyTorch call that computes the same function
   (where there is one; for a backward kernel, the backward of that call)
   and the least time the card could take (bytes / 3.35 TB/s or flops over
   the peak of their type, whichever is larger). Times are device times:
   the card sleeps while the host queues the timed calls (``time_ms``), so
   a kernel shorter than its Python wrapper is not timed at the host's
   rate; the LayerNorm phase also prints the host's time to queue one
   call of the wrapper and of ``F.layer_norm``. Tolerances, as
   |kernel - plain| <= atol + rtol * |plain|: both versions accumulate in
   f32, so bf16 output rounding sets the limit — one bf16 step is 2^-7
   relative, hence rtol 1e-2 on every bf16 output, with atol 2e-2 on flash
   outputs (the tensor-core flash kernel also rounds the probabilities to
   bf16 before P.V, as FlashAttention does), 2e-3 on paged outputs (f32
   probabilities, as in the plain version; the paged phase times its
   GQA shape and a 32-slot batched decode of ~400 MB of K/V as sub-rows,
   and two calls of each shape must give the same bits) and 1e-3 on
   RMSNorm outputs;
   the f32 lse and rstd get atol 1e-3. A gradient is a sum over many rows,
   so its rounding error scales with its largest summand: bf16 gradients
   get atol 1e-2 * max|plain| (f32 ones 1e-4 * max|plain|) with the same
   rtol; the softmax-CE loss and lse, f32 sums of the same bf16 logits in
   another order, get atol 1e-4, rtol 1e-5. The ERNIE slice's kernels: LayerNorm at
   [8192, 768] f32 (the ERNIE path's shape under O1) and bf16 and at
   [1024, 4096] bf16 and the Conformer's [6400, 144] f32, f32 outputs within
   LN_F32_ATOL (summation order),
   bf16 ones within one bf16 step of the output's scale, mean and rstd
   within LN_F32_ATOL; the flash kernels' dropout at ERNIE's
   [16, 512, 12, 64] bf16, p 0.1, and with GQA and ragged S (777) at
   head_dim 128, causal and not: the CUDA mask function's bits equal the
   plain version's exactly, probes (q = k = 0, v = I) read each kernel's
   applied mask out of out, dQ and dV and must equal those bits, and
   outputs and gradients match the plain versions with the same seed under
   the dense tolerances. The library column of the dropout kernels is
   ``F.scaled_dot_product_attention(dropout_p=0.1)`` and its backward.
3. Serving phase: Llama-2-7B at full width (32 layers) in bf16 with random
   weights from a seeded generator, served through ``LLMEngine``
   (4 slots, max_model_len 1024, block size 16) for 7 requests (6 greedy,
   one seeded top-p; two share a 256-token prefix so the tail prefill
   runs; more requests than slots, so some queue). Every greedy token is
   checked by teacher forcing through the no-cache forward (flash +
   RMSNorm kernels): at each generated position the engine's token's logit
   must lie within TF_TOL of that row's maximum, and at least TF_MIN_EXACT
   of the served tokens must be that row's argmax. The launch counters are
   zeroed just before each of the two paths (``LLMEngine.run``: paged
   attention and RMSNorm; the no-cache forward: flash attention and
   RMSNorm) and read just after it; a kernel of a path that was never
   launched fails the run. ``[serving telemetry]`` then reads the run
   back from the telemetry layer: the Prometheus text's
   ``serving_*{engine=...}`` series equal ``stats()`` (7 finished, 112
   tokens, the preemptions), the Chrome export holds one ``request`` root
   per request with ``queued`` / ``prefill`` / ``decode`` children, the
   flight ring holds the run's ``kv.alloc`` / ``kv.free`` events,
   ``stats()["slo"]`` has TTFT and TPOT percentiles, the decode step's
   roofline estimate (counted shape-only on the CPU's route, under
   ``FakeTensorMode``, when ``stats()`` reads it) equals a decode step
   counted on the card with its kernels launched, and
   ``serving_roofline_frac`` lies in (0, 1.05]. ``[serving tenancy]`` then
   serves the port's workload engine's three-tenant mix (TENANCY_SPEC,
   dispatched at its Poisson arrival times from one thread between engine
   steps) on the same model through an engine with tenancy (weights 3 / 2
   / 1, a cached-block quota on bronze), a 64-block pool, a 48-block host
   spill tier and the KV high watermark at 0.85, with two deadlines meant
   to be missed (TENANCY_DEADLINES): every other request finishes its 16
   tokens, the two end CANCELLED with ``DeadlineExceeded`` (the queued one
   never prefilled), the cache spilled and promoted, bronze's quota
   evicted, the pressure latch set and cleared, the per-tenant flops sum
   to the engine's step total, the served tokens pass the teacher-forcing
   limits, paged attention and RMSNorm launched. The same workload on an
   engine with spill, quotas and tenancy off and a pool that holds
   everything, and the first engine rerun under
   ``serving.kv.promote:corrupt@1x*`` (no promotion lands), serve the
   streams printed against the first engine's. Prints TTFT per tenant,
   decode tokens/s, spill and promote counts with their host ms, and the
   phase's seconds.
4. Profiles one decode step of 4 running slots: the wall time of
   unprofiled steps against the device busy time (the union of the
   profiled step's kernel intervals), and the kernels that took it; times
   10 more steps with telemetry on and off, interleaved, and prints the
   difference; ``[profiler]`` wraps 3 steps in
   ``paddle_tpu_torch.profiler.Profiler`` (CPU and GPU targets,
   ``export_chrome_tracing``) and requires the paged-attention kernel's
   device events and the ``engine.decode`` host annotations in the trace;
   ``[faults]`` serves 3 requests under ``serving.prefill:error@2``:
   request 2 FAILED with its ``FaultError``, the others the tokens of an
   unfaulted run, a flight dump naming the fault. ``[serving fleet]``
   then serves the same model as two replicas behind the port's HTTP
   gateway (``serving_fleet_phase``): one in this process, one a child
   process that builds the same seeded 7B model; a KV-fabric directory in
   the port's TCPStore, a prefix migrated between the replicas, the child
   SIGKILLed mid-stream and restarted, an idempotent replay; every stream
   equals a fleet-free engine's (or parts at a bf16 near-tie), and the
   in-process replica's paged-attention and RMSNorm launches equal its
   engine's steps times the model's structure.
5. Whole-step check: one ``LlamaPipelineTrainer`` forward and backward
   on a narrow model with the 7B head (hidden 512, 4 heads of 128,
   2 layers, vocab 32000, batch 2 x 512) in bf16 on the card, against the
   same f32 masters in f32 on the CPU through the plain versions: the loss
   within STEP_LOSS_TOL, each parameter's gradient within STEP_GRAD_REL_L2
   relative L2 error. This holds the autograd wiring of every kernel.
6. Training phase: the serving model freed, the bench's configuration
   (``init_parallel_env()`` over NCCL at a world of one,
   ``build_mesh(degrees={"dp": 1})``, ``LlamaPipelineTrainer(cfg, mesh,
   AdamW, n_micro=1, zero_stage=1)``) on Llama-2-7B's widths at
   TRAIN_LAYERS layers (f32 masters, bf16 compute, remat "dots", AdamW lr
   1e-4 as ``bench.py`` trains) takes 1 warm-up
   step and 5 timed steps on one seeded batch of 4 x 2048 tokens: every
   loss finite, the last below the first. Prints step wall time, tokens/s,
   MFU (``matmul_flops_per_token(2048)`` against 989 TFLOP/s), peak device
   memory, and a profile of one more step. The counters are zeroed just
   before the 5 steps and read just after; a training kernel never
   launched there fails the run, and so does a launch count a step other
   than the one-device trainer's, or an NCCL kernel in the profiled step.
7. Whole ERNIE step: ``ErnieForMaskedLM`` at hidden 256 (4 heads of 64,
   2 layers, vocab 40000, attention dropout 0.1, hidden dropout 0), batch
   2 x 512, one forward, backward and AdamW step (LinearWarmup, global-norm
   clip) under ``amp.auto_cast(O1, bf16)`` on the card against the same
   f32 weights in f32 on the CPU through the plain versions, with the same
   dropout seeds: both losses (before and after the step) within
   STEP_LOSS_TOL, every gradient within STEP_GRAD_REL_L2 relative L2 but
   the key projections' biases, whose exact gradient is 0 (the softmax
   cancels them): on each side their norm must stay below 1e-2 of the key
   weight gradient's.
8. ERNIE phase: ERNIE-3.0-Base at its published width and depth (12
   layers, hidden 768, 12 heads, inter 3072, vocab 40000, hidden and
   attention dropout 0.1), batch 16 x 512 with 15 % of the positions
   masked and labelled, f32 parameters under ``auto_cast(O1, bf16)``,
   AdamW (lr 1e-4, weight decay 0.01) over LinearWarmup with
   ClipGradByGlobalNorm(1.0): a warm-up step, then ERNIE_STEPS timed steps
   on the one batch; every loss finite and the last below the first;
   tokens/s, MFU (``ernie_flops_per_token``), peak memory; the launches
   per step must be exactly ERNIE_PER_STEP; then one profiled step, and
   one more split by synchronising into forward, backward, and clipping
   with the AdamW update.
9. Conformer slice's kernel phases (run with the other kernel phases):
   the CTC alpha and beta kernels at ``log_probs [400, 16, 128]`` f32 with
   labels [16, 48] (and L 100, S 201; S 127 and 129 across the one-warp
   route's edge, 129 with whole rows of an odd C; C 5001; S 8191 with
   whole rows and with gathered states; T 1): ragged input lengths and
   label lengths (300-400 and 24-48 at the slice), repeated adjacent
   labels, an empty label and an infeasible row; the lattices' -1e30
   entries equal the plain versions', the live ones within CTC_ATOL /
   CTC_RTOL, the loss and the gradient (kernel path vs ``ctc_grad`` of
   the plain lattices) too, the infeasible row's gradient 0, two calls
   bit for bit equal, each case's route (the wrappers' route counts) the
   launch plan's ("warp" at the slice's S 97); times at the slice (the
   row) and at L 100 (a sub-row), each with its chain bound (alpha: T
   dependent steps, beta: max(in_len); times the probe's CTC step, the
   kernels' own: two shuffles and the two-expf lse3); library column
   ``F.ctc_loss`` and its backward, timed only (its log_probs gradient
   assumes a log-softmax input, so it is not the JAX package's). Flash at
   head_dim 36
   ``[16, 400, 4, 36]`` bf16, p 0.1 and 0, forward and backward against
   the plain versions under the dropout phase's tolerances, the mask read
   back exactly by the probes.
10. Whole Conformer step: ``ConformerForCTC`` at hidden 144 (4 heads of
    36, 2 layers, conv kernel 15, vocab 128), 4 utterances of 400 frames,
    attention dropout 0.1 (hidden dropout 0), one O1 forward, CTC loss
    (per frame) and backward on the card against f32 on the CPU: the loss
    within STEP_LOSS_TOL, every gradient within STEP_GRAD_REL_L2 but the
    key projections' and depthwise convolutions' biases (0 in exact
    arithmetic; below 1e-2 of their weight gradient's norm on each side),
    the batch norms' running buffers within BN_REL_L2.
11. Conformer phase: ``ConformerConfig()`` (input 80 mels, hidden 144, 4
    layers, 4 heads, ff_mult 4, conv kernel 15, vocab 128, dropout 0.1),
    16 utterances of 1600 frames, labels of 24-48 from 1..127, input
    lengths 300-400 of T' = 400; f32 parameters under auto_cast(O1, bf16),
    AdamW lr 1e-3, weight decay 0.01: a warm-up step, then CONFORMER_STEPS
    timed steps; every loss finite and the last below the first;
    utterances/s, step wall, MFU (``conformer_flops_per_utterance``), peak
    memory; launches per step exactly CONFORMER_PER_STEP (every other
    kernel 0); a profiled step, and one split into forward, backward and
    the AdamW update.
12. RNN-T slice's kernel phase (run with the other kernel phases): the
    RNN-T alpha and beta-gradient kernels on blank / emit lattices built
    as ``rnnt_loss`` builds them from seeded joint logits over vocab 128,
    at the slice's ``[16, 400, 49]`` (t_len 300-400, u_len 24-48), a
    long-label ``[8, 200, 513]``, ``[5, 37, 65]`` (just past one warp, odd
    T x (U + 1)) and the edges (u_len 0, t_len 1, both; U + 1 = 1024):
    -1e30 cells equal the plain versions', live alphas and betas within
    CTC_ATOL / CTC_RTOL, the log-likelihood within 1e-4 + 1e-5 relative,
    the posteriors within RNNT_POST_ATOL, ``bhat[0, 0]`` against the
    alphas' log-likelihood, two calls bit for bit equal, and each case's
    route (the wrappers' route counts) the launch plan's: "warp" at the
    slice's U + 1 = 49. Times at the slice's shape (the row) and the
    long-label shape (a sub-row) with the dependent-step count
    ``max(t_len + u_len)`` and the chain bound: those steps x the latency
    of one step, timed by a probe (one warp, 100000 dependent steps in
    registers); no library column (no PyTorch call computes the RNN-T
    loss).
13. Whole RNN-T step: ``ConformerForRNNT`` (predictor LSTM 144) under the
    whole Conformer step's settings and limits (phase 10), the per-frame
    loss being each utterance's RNN-T loss over its input length, then the
    batch mean; every gradient, the LSTM's and the embedding's included.
14. RNN-T phase: ``ConformerForRNNT(ConformerConfig())`` trained as in
    phase 11 on the same kind of batch (labels of 24-48, so U + 1 = 49);
    launches per step exactly RNNT_PER_STEP (no CTC kernel); MFU from
    ``conformer_flops_per_utterance`` with the RNN-T head.

15. Flash slice's kernel phases (run with the other kernel phases):
    ``[flash mask]``, the flash kernels with a bool mask, first at the
    inputs phase 17 gives them (``[16, 512, 12, 64]`` bf16, dropout 0.1,
    not causal, phase 17's own key-padding mask ``[16, 1, 1, 512]``: the
    kernel row's main shape), then at tools/attn_bench.py
    bench_masked(2048)'s ``[4, 2048, 8, 128]`` bf16 with a key-padding
    mask ``[4, 1, 1, 2048]`` (lengths 1024-2047; a sub-row), then every
    mask mode (one, batch, head, B*H; row dim 1 or Sq; key dim 1) and a
    per-query mask with a fully masked row, causal with dropout, and not
    causal with and without dropout, bf16 and f32; library column SDPA
    with the same bool mask and dropout rate; bound over the unmasked
    (query, key) pairs. ``[flash varlen]``, packed sequences at
    bench_varlen(8192, 16)'s cuts with Llama-2-7B's 32 heads of 128,
    causal, bf16 (plain versions a head at a time), a non-causal case with
    cu_q != cu_k, an empty key part, tails past cu[-1] and GQA; library
    column SDPA over jagged nested tensors with ``is_causal`` where the
    card's torch takes it (else none, with the reason printed); bound
    ``4 D H sum L_i^2 / 2`` flops forward (2.5x backward); then the main
    path, ``F.flash_attn_unpadded`` forward and backward with its launches
    counted. ``[flash head_dim]``: every multiple of 8 from 8 to 256 and
    the widths 6, 7, 33 and 34, f32 and bf16, forward and backward; then
    phase 18's kernel at its inputs (f32 ``[4, 128, 4, 16]``, dropout 0.1:
    the row's main shape) and the bf16 kernels at ``[16, 512, 768 / D,
    D]`` for D 16, 96 and 256 (sub-rows), each checked and timed.
    Tolerances as the dense phases' (f32: atol 1e-4 + rtol 1e-4,
    summation order only); every timed input is checked first.
16. Whole encoder step: ``nn.TransformerEncoder`` (hidden 256, 4 heads of
    64, 2 post-norm layers, ffn 1024, attention dropout 0.1, hidden
    dropout 0 since its masks come from each device's own generator) with
    a linear head to 40000 and ``cross_entropy``, batch 2 x 512 with a
    bool key-padding mask, one O1 step on the card against f32 on the CPU
    under phase 7's limits; launches exactly 2 + 2 masked flash, 4
    LayerNorm, 1 + 1 softmax-CE.
17. Encoder phase: the same encoder at ERNIE-3.0-Base's published widths
    (12 layers, hidden 768, 12 heads, ffn 3072, dropout 0.1) with the
    head, batch 16 x 512 with a key-padding mask of lengths 256-512, O1,
    AdamW lr 1e-4: a warm-up step and ENCODER_STEPS timed steps on one
    batch; losses finite and falling; step wall, tokens/s over the real
    (unpadded) tokens, MFU (``encoder_flops_per_token``), peak memory,
    a profiled step's busy and idle share; launches per step exactly
    ENCODER_PER_STEP.
18. ``ernie_tiny()`` (head_dim 16) attending on the card: one f32 MLM
    forward and backward against the CPU's plain versions.
19. Whisper slice's kernel shapes (run with the other kernel phases):
    ``[flash whisper]``, the flash kernels at Whisper-base's encoder
    self-attention ``[8, 1500, 8, 64]`` bf16 (forward and backward) and a
    decode step's cross-attention, q ``[8, 1, 8, 64]`` against k / v
    ``[8, 1500, 8, 64]`` (forward), against the plain versions under the
    dense tolerances and timed against SDPA (sub-rows ``whisper_encoder``
    and ``whisper_decode`` of the flash rows); softmax-CE at the training
    step's ``[16 x 224, 51865]`` bf16 logits and LayerNorm at the
    encoder's ``[8 x 1500, 512]`` bf16 (sub-rows ``whisper``).
20. ``[whisper]``: Whisper-base (``WhisperConfig()``: openai/whisper
    ``base``'s 80 mels, d_model 512, 6 + 6 layers, 8 heads of 64, ffn
    2048, vocab 51865, 1500 / 448 positions; nothing cut) in bf16 with
    random weights from a seeded generator, ``generate`` over 8 x 30 s of
    seeded synthetic log-mel ``[8, 80, 3000]`` for WHISPER_NEW_TOKENS
    greedy tokens; every generated token (up to its row's end of text)
    checked by teacher forcing through ``forward`` as ``[serving]``
    checks (TF_TOL, TF_MIN_EXACT); the launches of ``generate`` must be
    exactly the structure's (the encoder's 6 flash forwards and 13
    LayerNorms, then 12 flash forwards and 19 LayerNorms a step, every
    flash launch on sm90, no other kernel), and those of the
    teacher-forced forward too (12 flash, 32 LayerNorm); prints the
    encoder's device time, a decode step's wall and decode tokens/s, one
    profiled decode step (busy, idle, kernels) and peak memory.
21. ``[whole step whisper]``: a narrow Whisper (d_model 256, 4 heads of 64,
    2 + 2 layers, ffn 1024, vocab 51865, batch 2 x 400 mel frames, 64
    tokens), one O1 teacher-forced step on the card against f32 on the CPU
    under phase 7's limits (the key projections' biases as there),
    launches exactly the structure's.
22. ``[whisper train]``: Whisper-base, f32 parameters under
    auto_cast(O1, bf16), AdamW lr 1e-4, one repeated batch of 16 x 30 s
    with 224-token targets: a warm-up step and WHISPER_STEPS timed steps;
    losses finite and falling; launches per step exactly the structure's
    (12 + 12 flash on sm90, 32 LayerNorm, 1 + 1 softmax-CE); utterances/s,
    MFU (``whisper_flops_per_utterance``), step wall, a profiled step's
    busy and idle share, peak memory.
23. Vision slice's kernel shape (run with the other kernel phases):
    softmax-CE at ResNet-50's head, ``[64, 1000]`` bf16 (sub-row
    ``resnet``).
24. ``[resnet]``: ResNet-50 at its published widths (25.56 M parameters,
    1000 classes) at the PaddleClas recipe (``ResNet50.yaml``: 64 images
    of 224 x 224 a card, Momentum 0.9, L2 1e-4, piecewise lr 0.1 / 0.01 /
    0.001 / 0.0001, the boundaries put at steps 1 / 12 / 23 so that the
    warm-up step runs at 0.1 and the timed ones at 0.01), f32 parameters
    under auto_cast(O1, bf16), one repeated seeded batch: a warm-up step
    and RESNET_STEPS timed steps; losses finite and falling, one lr
    boundary crossed, launches exactly one softmax-CE forward and backward
    a step; step wall (median), images/s, MFU (``resnet_flops_per_image``:
    4.09 G multiply-adds an image forward, training 3x), peak memory, a
    step split into forward, backward and the Momentum update, and a
    profiled step's busy and idle share with its kernels by group
    (``vision_share``) and by name.
25. ``[resnet infer]``: the trained model in eval under O1 at batch 64 and
    1 (ms a batch, images/s), and its O1 logits against its f32 forward
    (TF32 off) under ``o1_eval_check``'s calibrated limit. ``[whole step
    resnet]``: one ResNet-50 step (8 x 224, Momentum at lr 0.1) from the
    same weights on the card and on the CPU, in f32 and under O1: the f32
    pair held to phase 7's limits (every gradient, every parameter after
    the update, the batch-norm buffers); the O1 pairs printed (see
    ``whole_step_resnet``: bf16 does not determine this step's gradients
    at initialisation).
26. ``[vision zoo]``: LeNet, AlexNet, VGG-16, MobileNetV1 / V2 /
    V3-Large, SqueezeNet 1.1, GoogLeNet and InceptionV3 (at 299) at their
    published widths, batch 8: one O1 step each (finite loss, one
    softmax-CE forward and backward a head: GoogLeNet's loss is its main
    head's plus 0.3 x each auxiliary head's, 3 / 3), then
    ``o1_eval_check`` on the main logits.
27. High-level API slice's kernel shapes (run with the other kernel
    phases): softmax-CE at the f32 logits ``Model.fit`` hands it, LeNet's
    ``[256, 10]`` and ResNet-50's ``[64, 1000]`` (sub-rows ``hapi_lenet``
    and ``hapi_resnet``; f32 gradients within GRAD_FRAC_F32).
28. ``[hapi lenet]``: BASELINE #1 as the verify recipe runs it
    (``paddle_tpu_torch.seed(7)``, ``Model(LeNet())`` on the card, Adam
    1e-3, ``CrossEntropyLoss``, ``Accuracy``, ``fit(MNIST(mode="train"),
    batch_size=256, epochs=3)``, TF32 off, then
    ``evaluate(MNIST(mode="test"))``): accuracy rising epoch over epoch,
    eval accuracy >= LENET_MIN_EVAL_ACC, every batch served by the native
    batcher, exactly one softmax-CE forward and backward a step and one
    forward an eval batch, and the first epoch's losses within
    LENET_LOSS_ATOL of the port's CPU ``fit`` from the same weights and
    order.
29. ``[hapi resnet]``: ResNet-50 at its published widths through
    ``Model.fit`` in f32 (hapi's O1 cannot train a conv net in either
    package, ROADMAP R9), Momentum 0.9 / L2 1e-4 over PiecewiseDecay,
    ``Accuracy(topk=(1, 5))``, one epoch over 768 seeded uint8 256 x 256
    images with class templates through ToTensor / RandomCrop(224) /
    RandomHorizontalFlip / Normalize in 4 worker processes, batch 64:
    losses finite and falling, one softmax-CE forward and backward a step;
    ``evaluate`` on 4 batches (one forward each) and ``predict`` on one;
    the step wall and the loader wait (a timing callback), images/s
    through fit, host-to-device ms (the loader's batches arrive pinned;
    pageable and pinning for comparison), the metric's
    host cost, a bare f32 loop's step on a batch already on the card and
    the share hapi and the loader add, peak memory, a profiled
    ``train_batch``'s busy and idle share. ``[hapi workers]``: the
    loader's worker processes forked with CUDA live here give the inline
    loader's order and content, pass a worker's exception up, and
    initialise CUDA in no worker.
30. ``[densenet]``: DenseNet-121 at its published widths (7.98 M
    parameters, growth 32, blocks 6 / 12 / 24 / 16) at PaddleClas's
    recipe for it (``DenseNet121.yaml``: 64 images a card at 224, Momentum
    0.9, L2 1e-4, piecewise lr; the boundaries as ``[resnet]``'s), f32
    parameters under ``auto_cast(O1, bf16)``, one repeated seeded batch,
    written only through the port's eager API as a Paddle user writes a
    dygraph loop (``paddle.to_tensor``, ``loss.backward()``,
    ``opt.step()``): a warm-up step and DENSENET_STEPS timed ones (losses
    finite and falling, one softmax-CE forward and backward launch a
    step, the logits and the loss the port's ``Tensor``), step wall,
    images/s, MFU (``densenet_flops_per_image``), peak memory, the Tensor
    shell's cost (the same step fed plain tensors, in turns), a profiled
    step, a step with ``model.features`` frozen by ``stop_gradient``, an
    eval under ``paddle.no_grad()`` with ``paddle.metric.accuracy``.
31. ``[whole step densenet]``: the card's f64 DenseNet-121 step (batch 8)
    held against the CPU's f64 step from the same weights at the
    whole-step limits; the card's f32 step (TF32 off) against the CPU's
    f32 and f64 ones printed (ROADMAP C3).
32. ``[eager ops]``: every op of the port's op library on the card
    against the CPU (``eager_ops_phase``), then ``op_coverage()``.
33. ``[eager autograd]``: double and triple backward, the gradient
    penalty, hooks, ``PyLayer`` and ``no_grad_vars`` on the card against
    the CPU.
34. The static-graph and deployment path (``static_deploy_phases``):
    ERNIE-3.0-Base sequence classification (2 classes, eval, seeded
    weights) in f32 (TF32 off; the model cut to STATIC_F32_LAYERS layers,
    which saves ~40 s of inductor compile) and bf16 (all 12 layers),
    unmasked token ids ``[32, 128]``,
    ``[1, 128]`` and ``[8, 64]``. ``[to_static ernie]``: ``jit.to_static``
    compiled with inductor (compile seconds printed); ``[jit ernie]``:
    ``jit.save`` with a ``[None, None]`` int64 spec, ``jit.load`` serving
    all three shapes, and the bf16 artifact in a fresh ``python -c``
    child that imports only ``paddle_tpu_torch``; ``[predictor ernie]``:
    the predictor compiled (IR optimisation) over the f32 artifact and as
    exported over the bf16 one, the handle workflow
    (``share_external_data`` without a copy, ``copy_from_cpu`` /
    ``copy_to_cpu``) and a ``clone()`` on a second stream; ``[static ernie]``: the model on ``static.data("input_ids",
    [None, 128])`` through ``Executor.run`` (one compile, f32 at
    STATIC_F32_LAYERS layers), then
    ``save_inference_model`` and a predictor over it. Each run is held in
    f32 to STATIC_F32_REL_L2 of the eager f32 forward, in bf16 to
    STATIC_BF16_RATIO x the eager bf16 forward's own error, and to
    exactly L flash launches (sm90 in bf16, mma in f32) and 2 L + 1
    LayerNorm launches a forward at depth L. ``[static timing]`` prints, unheld, ms a batch at
    batch 1 and sequences/s at batch 32 for eager, ``to_static`` and the
    predictor, with device busy against host wall. ``[static nn]``:
    ``static.nn``'s builders, ``cond``, ``while_loop`` and ``gradients`` on
    the card against the same program on the CPU. The compilers' caches
    and the artifacts stay under ``paddle_tpu_torch/csrc/build/``.
35. ``[shufflenet]`` (after ``[vision zoo]``): ShuffleNetV2 x1.0 at its
    published widths (2.28 M parameters, 1000 classes) at the PaddleClas
    recipe (``ShuffleNetV2_x1_0.yaml``: Momentum 0.9, L2 4e-5, cosine lr
    0.5 at 256 images a card) cut to SHUFFLE_BATCH images a card (the lr
    scaled to SHUFFLE_LR, the cosine's period to the run), f32 parameters
    under ``auto_cast(O1, bf16)``, one repeated seeded batch of 224 x 224:
    a warm-up step and SHUFFLE_STEPS timed ones (losses finite and
    falling, exactly one softmax-CE forward and backward launch a step),
    step wall (median), images/s, MFU (``shufflenet_flops_per_image``),
    peak memory, a profiled step's busy and idle share.
36. ``[whole step shufflenet]``: one f64 ShuffleNetV2 x1.0 step at batch
    SHUFFLE_WHOLE_BATCH on the card against the CPU's from the same
    weights, held to the whole-step limits (every gradient, every
    parameter after the update, the batch-norm buffers); the depthwise
    blocks' batch-norm biases (exact gradient 0) and the running means
    after them (exact 0) held apart.
37. ``[nn surface]`` (after ``[eager autograd]``): every case of
    ``tools/nn_surface_cases.py`` (the last nn slice's 36 functionals and
    44 layers; GRU and SimpleRNN as 2-layer bidirectional layers with
    ``sequence_length``) on the card against the CPU, forward and
    backward, f32, TF32 off, within EAGER_F32. The three phases' seconds
    are printed (``[nn slice phases]``).
38. ``[compiled kernels]`` (after the static phases): every registered op
    of ``kernels/library.py`` inside a small ``jit.to_static(backend=
    "aot_eager")`` program on the card, forward and backward
    (``torch.func.grad`` inside the program), against the eager launches
    of the same inputs, bit for bit, with exactly one launch of each
    kernel counted inside the ops: flash causal, with a bool mask and with
    dropout at an explicit seed (which the program hands the kernels as a
    device tensor), varlen, paged attention, RMSNorm, softmax-CE, CTC and
    RNN-T; flash dropout without a seed drops different masks in two calls
    of one program.
39. ``[to_static llama]``: Llama-2 at ``llama_7b()`` widths cut to
    LLAMA_DEPLOY_LAYERS layers, bf16, eval, through ``jit.to_static``
    (inductor) at LLAMA_DEPLOY_SHAPES and ``jit.save`` / ``jit.load`` with
    a ``[None, None]`` int64 spec serving both shapes from one artifact:
    each within STATIC_BF16_RATIO x the eager bf16 forward's error against
    the eager f32 one, exactly 2 L + 1 RMSNorm and L flash (sm90) launches
    a forward; ``[llama deploy timing]`` ms a forward of eager,
    ``to_static`` and ``jit.load``.
40. ``[static llama grad]``: a static Program over the same model with
    ``static.gradients`` of the next-token softmax-CE with respect to
    every parameter, one compiled ``Executor.run``: every gradient within
    STATIC_GRAD_REL_L2 of eager autograd's, the RMSNorm, flash and
    softmax-CE forward and backward kernels launched as ops.
41. ``[ernie lamb]``: ERNIE-3.0-Base MLM, 16 x 512, O1, Lamb over
    OneCycleLR with global-norm clipping, LAMB_STEPS steps on one
    repeated batch: losses finite and falling, ERNIE_PER_STEP launches a
    step, step wall, the Lamb update's wall, peak memory.
42. ``[optimizers]``: Adagrad, RMSProp (and centered), Adadelta, Adamax,
    Lamb, AdamW with ``lr_ratio`` / ``apply_decay_param_fun`` and LBFGS
    with and without its line search, 5 steps each on the card against
    the CPU, f32, TF32 off, within OPTIMIZERS_F32.
43. ``[eager ops]`` also runs the registry's other 184 ops
    (``ops.parity``, ``ops.detection``, fft's three, the activations,
    ``rnn``, the aliases; ``tools/eager_op_cases.py`` REGISTRY_CASES) on
    the card against the CPU and requires ``op_coverage()`` 412 of 460.
44. ``[op aliases]``: the six aliases that reach kernels (``flash_attn``,
    ``flash_attn_unpadded``, ``layer_norm``, ``cross_entropy_with_softmax``,
    ``warpctc``, ``warprnnt``) through ``OPS[name].fn`` at Llama's, row
    1b's, ERNIE's and the Conformer's shapes: each kernel launched once,
    output and gradients bitwise the direct call's.
45. ``[detection ppyolo]``: PP-YOLO R50vd-DCN post-processing at 608 x 608,
    batch 8 (DCNv2 forward and backward, ``yolo_box``, ``matrix_nms``),
    each stage card against CPU, ms, host syncs, peak memory.
46. ``[detection faster rcnn]``: Faster R-CNN R50-FPN proposals and RoI
    features at 800 x 1344, batch 2 (``generate_proposals``, top 1000,
    ``distribute_fpn_proposals``, ``roi_align``, ``box_coder``,
    ``multiclass_nms3``), held and printed as 45.
47. ``[fft]``: ``frame`` + ``rfft`` at Whisper-base's STFT over 8 x 30 s,
    card against CPU. ``[containers]``: a TensorArray round trip on the
    card. ``[nan inf]``: ``FLAGS_check_nan_inf`` raises on ``log(-1)``
    with the op's name; off, no hook (``[densenet]`` ran so).
48. ``[distributed]`` (after ``[training]``): two ranks started by the
    port's ``spawn`` share the one card over gloo with CUDA tensors (the
    machine has one card, and NCCL refuses two ranks on one device), at
    Llama-2-7B's widths cut to DIST_LAYERS layers, ``[2, DIST_SEQ]``
    tokens a rank: dp=2, mp=2 and pp=2 (1F1B, 4 micro-batches) each held
    to a world-1 run of the same weights and batch (the loss within
    STEP_LOSS_TOL relative, every gradient within STEP_GRAD_REL_L2
    relative L2), a checkpoint saved at mp=2 and loaded bitwise at a
    world of one, sep=2 ring attention at ``[1, 2 DIST_SEQ, 32, 128]``
    bf16 causal against one-card flash over the whole sequence, and NCCL
    tried on the two ranks. A case that gloo refuses (it cannot send a
    CUDA tensor point to point) prints gloo's own error; a case that
    fails otherwise, or disagrees, fails the run. Step times there are
    host-staged gloo, not NVLink.

Flash design: bf16 at every head width whose rows TMA reads (16-byte head
rows, or the Conformer's 8-byte rows of 36 inside 16-byte token rows)
takes the wgmma / TMA kernels (``csrc/flash_attention{,_bwd}_sm90.cuh``,
one source a class group, counted under ``flash_attention{,_bwd}_sm90``),
f32 and narrower bf16 rows the mma.sync and CUDA-core ones (``_mma``).
Each flash row records the design its timed launches ran and must be
``sm90``, but for the f32 ``ernie_tiny`` entry of the ``_d16`` rows
(``mma``); ``[flash head_dim]`` asserts each width's design from the rule
(``sweep_design``); the Llama, ERNIE, encoder, Whisper and Conformer
steps must launch every flash kernel on ``sm90``. The ``_d36`` rows and
the bf16 sub-rows of the ``_d16`` rows also time the mma kernels the sm90
ones replaced at those widths, on the same inputs (``mma_ms``), and give
a third bound, the exponentials (one a score) over the card's exp2 rate
as ``[exp2 probe]`` measures it, naming which of bytes, operations or
exponentials sets ``bound_ms`` (``bound_set_by``; exponentials count
under "operations" in ``bound_by``).

The ``launches`` of the JSON line sum the main path's runs: the engine,
the no-cache forward, the 5 Llama training steps, ``[distributed]``'s
mesh runs on both ranks, the ERNIE steps, the
Conformer-CTC and the RNN-T steps, the encoder steps, the
``F.flash_attn_unpadded`` call, the ``[op aliases]`` calls, the Whisper
``generate`` and its
teacher-forced forward, the Whisper training steps, the ResNet-50
training steps, the zoo's steps, the ShuffleNetV2 steps, the Llama
deploy forwards and the static gradient program, the Lamb steps, the two
``Model.fit`` phases (fits and
evaluations), the DenseNet-121 steps and the static-graph path's held
forwards (the ``_d36`` rows: the Conformer steps'
launches of the dropout flash kernels, all at head_dim 36; the ``_d16``
rows: the ``ernie_tiny()`` step's). The last two lines are one JSON object
with every kernel's numbers and one with the device. Any failure raises and exits non-zero; without a CUDA
device, or without the package beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
ATTN_ATOL, NORM_ATOL, F32_ATOL, BF16_RTOL = 2e-2, 1e-3, 1e-3, 1e-2
# the paged kernel keeps P in f32 (CUDA-core products), so it shares the
# plain version's arithmetic up to summation order and one bf16 rounding
PAGED_ATOL = 2e-3
# teacher forcing: a bf16 logit is 8 significant bits, and the engine's
# cached path (plain prefill attention + paged kernel) and the no-cache path
# (flash kernel) round at different points through 32 layers. The gap limit
# is about the spacing of the top two random-weight logits, so it alone
# would pass a second-best token; most served tokens must also be exactly
# the teacher-forced argmax. That share is not 1: the two paths' logits
# differ by ~0.1 (bf16), and that flips the argmax on the rows whose top
# two logits lie closer (82 of 96 matched on an H100); an engine fault that
# serves the wrong row's or position's token matches almost never.
TF_TOL = 0.25
TF_MIN_EXACT = 0.75
# [serving tenancy]: a three-tenant mix modelled on the workload engine's
# "tenant-mix" preset (Poisson at 10 qps, tenants 3 / 2 / 1, half of each
# prompt from one of 3 shared prefixes), at 7B prompt lengths, served on
# the [serving] model by an engine whose device pool must evict cached
# prefixes: 64 usable blocks of 8 MiB (32 layers x K/V x 32 heads x 16
# tokens x 128 x bf16; the least that holds one 1024-token request, so
# that four running requests reach the watermark), a host spill tier of
# 48 blocks, the KV high watermark at 0.85 and a cached-block quota on the
# bronze tenant
TENANCY_SPEC = dict(
    name="tenant-mix-7b", seed=0, requests=24, vocab=32000,
    arrival={"kind": "poisson", "rate_qps": 10.0},
    prompt_len={"kind": "lognormal", "median": 192, "sigma": 0.6,
                "min": 32, "max": 640},
    output_len={"kind": "fixed", "value": 16},
    tenants=[{"name": "gold", "weight": 3.0},
             {"name": "silver", "weight": 2.0},
             {"name": "bronze", "weight": 1.0}],
    prefix={"share": 0.5, "groups": 3})
TENANCY = {"tenants": [{"name": "gold", "weight": 3.0},
                       {"name": "silver", "weight": 2.0},
                       {"name": "bronze", "weight": 1.0, "block_quota": 8}]}
TENANCY_ENGINE = dict(max_slots=4, max_model_len=1024, block_size=16,
                      num_blocks=65, kv_spill_blocks=48,
                      kv_high_watermark=0.85, tenancy=TENANCY)
# two deadlines meant to be missed, by request index: (deadline_s,
# max_new_tokens). The first request asks for 256 tokens within 1 s
# (no host serves 256 decode steps in 1 s, and its prefill into an idle
# engine takes far less), so it expires mid-decode; a later one arrives
# with its deadline already passed (relayed late), so it expires queued
TENANCY_DEADLINES = {0: (1.0, 256), 20: (0.0, 16)}
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
# training slice: gradients (see the docstring), the softmax-CE loss/lse,
# and the whole-step check. A bf16 step through 2 layers rounds every
# activation and weight to 8 significant bits, so the loss moves by ~1e-3
# of its ~10.4 and the gradients by a few per cent in L2.
GRAD_FRAC_BF16, GRAD_FRAC_F32 = 1e-2, 1e-4
CE_ATOL, CE_RTOL = 1e-4, 1e-5
STEP_LOSS_TOL = 2e-2
STEP_GRAD_REL_L2 = 5e-2
TRAIN_LAYERS = 8               # 7B widths; depth cut to fit one 80 GB card
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "rmsnorm_bwd", "softmax_ce", "softmax_ce_bwd")


def train_per_step(layers):
    """Launches a Llama training step makes at remat "dots": each layer's
    flash forward twice (forward, recompute) and backward once; two
    RMSNorms a layer twice plus the final one, their backwards once; the
    head's softmax-CE forward and backward (PERF.md section 6)."""
    return {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "rmsnorm": 4 * layers + 1, "rmsnorm_bwd": 2 * layers + 1,
            "softmax_ce": 1, "softmax_ce_bwd": 1}


# [distributed]: two ranks share the one card over gloo at Llama-2-7B's
# widths cut to DIST_LAYERS layers, [2, 2048] tokens a rank; a collective
# that gloo leaves hanging raises after DIST_TIMEOUT_S
DIST_LAYERS = 2
DIST_SEQ = 2048
DIST_TIMEOUT_S = 90.0
DIST_JOIN_S = 300
# in this order: the collectives first, then the point-to-point sends
# (gloo may abort a rank on those), then NCCL's two ranks on one card
DIST_CASES = ("dp", "mp", "mp_f32", "checkpoint", "pp", "sep",
              "nccl_two_ranks_one_card")
# mp_f32: mp=2 in f32 against a world-1 f32 run, to the tier-1 tests' f32
# limits: with no bf16 rounding the gap is the reduction order's alone
DIST_F32_LOSS_TOL, DIST_F32_GRAD_REL_L2 = 1e-5, 1e-4
# the only refusals a case may end in: gloo's abort at the writev of a
# CUDA pointer (pp's and the ring's sends), or its error that a device
# type is unsupported; the other rank then sees its connection closed.
# Any other error, inside torch.distributed or not, fails the phase.
GLOO_REFUSAL = re.compile(r"pair\.cc:\d+\] writev \S+: Bad address"
                          r"|unsupported device type")
GLOO_PEER_CLOSED = re.compile(r"pair\.cc:\d+\] Connection closed by peer")
# ERNIE slice. LayerNorm: f32 outputs differ from the plain version's by
# summation order only (atol 1e-5 at |out| ~ 5); bf16 ones by one rounding
# of the same f32 value, so by at most one bf16 step of the output's scale.
LN_F32_ATOL = 1e-5
ERNIE_STEPS = 10
ERNIE_DROPOUT = 0.1            # ERNIE-3.0-Base's attention dropout
# launches per ERNIE-3.0-Base MLM step: the embeddings' LayerNorm, two per
# layer and the head's; one flash forward and backward (dropout) per layer;
# one softmax-CE forward and backward for the loss
ERNIE_PER_STEP = {"layernorm": 26, "flash_attention_dropout": 12,
                  "flash_attention_bwd_dropout": 12, "softmax_ce": 1,
                  "softmax_ce_bwd": 1, "flash_attention": 0,
                  "flash_attention_bwd": 0, "flash_attention_sm90": 12,
                  "flash_attention_bwd_sm90": 12, "flash_attention_mma": 0,
                  "flash_attention_bwd_mma": 0}
# Conformer slice. The CTC kernels repeat the plain versions' f32
# arithmetic step for step: -1e30 ("dead") lattice entries must be equal,
# the live ones (sums over up to 400 steps of magnitude ~5, |alpha| up to
# ~3000) within CTC_ATOL + CTC_RTOL * |plain| (expf / logf may differ by an
# ulp), the log-likelihood within 1e-4 + 1e-5 relative.
CTC_ATOL, CTC_RTOL = 1e-3, 1e-5
CONFORMER_STEPS = 10
CONFORMER_DROPOUT = 0.1        # ConformerConfig's published dropout
# launches per ConformerForCTC step (4 blocks): five LayerNorms a block;
# one flash forward and backward (dropout) a block; the CTC alpha kernel
# in the forward, the beta kernel in the backward; no other kernel
CONFORMER_PER_STEP = {"layernorm": 20, "flash_attention_dropout": 4,
                      "flash_attention_bwd_dropout": 4,
                      "flash_attention_sm90": 4,
                      "flash_attention_bwd_sm90": 4,
                      "ctc_alpha": 1, "ctc_beta": 1}
# batch-norm running statistics after one O1 step vs the f32 CPU step
BN_REL_L2 = 1e-2
# RNN-T slice. The lattice kernels repeat the plain versions' f32
# arithmetic cell for cell: alphas and betas are held as CTC's lattices
# (dead cells equal, live ones within CTC_ATOL + CTC_RTOL * |plain|), the
# log-likelihood within 1e-4 + 1e-5 relative, and the posteriors gb / ge,
# probabilities in [0, 1], within RNNT_POST_ATOL.
RNNT_POST_ATOL = 1e-5
# launches per ConformerForRNNT step (4 blocks): the encoder's as the CTC
# model's, the RNN-T alpha kernel in the forward, the beta-gradient kernel
# in the backward, no CTC kernel
RNNT_PER_STEP = {"layernorm": 20, "flash_attention_dropout": 4,
                 "flash_attention_bwd_dropout": 4, "flash_attention_sm90": 4,
                 "flash_attention_bwd_sm90": 4, "rnnt_alpha": 1,
                 "rnnt_beta_grad": 1}
# Flash slice: the flash kernels' bool mask, varlen and head widths. The
# mask phase's main shape is tools/attn_bench.py bench_masked(2048)'s, the
# varlen phase's its bench_varlen(8192, 16) at Llama-2-7B's 32 heads of
# 128. Small f32 cases hold the kernels as the card tests do (atol 1e-4 +
# rtol 1e-4: summation order only); the head_dim-16 model step runs f32 on
# both sides, so its gradients differ by summation order through two layers.
MASK_SHAPE = (4, 2048, 8, 128)
VARLEN_SHAPE = (8192, 16, 32, 128)
F32_SMALL_ATOL = 1e-4
D16_GRAD_REL_L2 = 1e-3
# the head_dim-16 model step's attention: ernie_tiny() at batch 4 x 128
D16_ATTN = (4, 128, 4, 16)
# the exp2 probe (the flash rows' third bound): blocks of 256 threads (8 a
# streaming multiprocessor), exponentials per chain, 8 chains a thread
EXP2_PROBE = (132 * 8, 4096)
ENCODER_STEPS = 10
# [encoder mask]: batch, length, heads and head width of its attention
ENCODER_ATTN = (16, 512, 12, 64)
# launches per step of the ERNIE-3.0-Base-wide encoder (12 post-norm
# layers): one masked flash forward and backward a layer, two LayerNorms a
# layer, one softmax-CE forward and backward for the head's loss
ENCODER_PER_STEP = {"flash_attention_mask": 12, "flash_attention_bwd_mask": 12,
                    "flash_attention_sm90": 12,
                    "flash_attention_bwd_sm90": 12,
                    "layernorm": 24, "softmax_ce": 1, "softmax_ce_bwd": 1}
# Whisper slice: Whisper-base (WhisperConfig(), openai/whisper "base") served
# over 8 x 30 s of log-mel for 64 greedy tokens, and trained teacher-forced
# on 16 x 30 s with 224-token targets; its attention [8, 1500, 8, 64]
WHISPER_SERVE_BATCH = 8
WHISPER_NEW_TOKENS = 64
WHISPER_TRAIN_BATCH = 16
WHISPER_TRAIN_TOKENS = 224
WHISPER_STEPS = 10
WHISPER_ATTN = (8, 1500, 8, 64)
# Vision slice: ResNet-50 at the PaddleClas recipe (ppcls/configs/ImageNet/
# ResNet/ResNet50.yaml: 224 x 224 crops, 1000 classes, 64 images a card,
# Momentum 0.9, L2 1e-4, piecewise lr 0.1 / 0.01 / 0.001 / 0.0001 at epochs
# 30 / 60 / 90). The smoke's boundaries put the warm-up step at 0.1 and the
# timed steps at 0.01 (one boundary crossed; the later two lie past the
# run's end).
RESNET_BATCH = 64
RESNET_STEPS = 10
RESNET_LRS = [0.1, 0.01, 0.001, 0.0001]
RESNET_BOUNDARIES = [1, 1 + RESNET_STEPS + 1, 1 + 2 * (RESNET_STEPS + 1)]
RESNET_WHOLE_BATCH = 8
ZOO_BATCH = 8
# High-level API slice: BASELINE #1 (LeNet on MNIST through Model.fit, as
# the verify recipe runs it) and ResNet-50 through Model.fit in f32 (hapi's
# O1 cannot train a conv net: ROADMAP R9) on a seeded ImageNet-shaped set
LENET_BATCH = 256
LENET_EPOCHS = 3
LENET_MIN_EVAL_ACC = 0.9
# the card's LeNet losses (TF32 off) against the CPU's over the first epoch
# from the same weights and order: f32 summation order only, carried
# through 8 Adam steps (the CPU port matches the JAX package at 2.4e-6)
LENET_LOSS_ATOL = 1e-4
HAPI_RESNET_IMAGES = 768
HAPI_RESNET_WORKERS = 4
HAPI_EVAL_BATCHES = 4
IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]
# Eager API slice: DenseNet-121 at PaddleClas's recipe for it (ppcls/
# configs/ImageNet/DenseNet/DenseNet121.yaml: 224 x 224 crops, 1000
# classes, 64 images a card, Momentum 0.9, L2 1e-4, piecewise lr 0.1 over
# epochs 30 / 60 / 90; the smoke's boundaries as ResNet-50's) in the
# dygraph idiom; the shell's cost in SHELL_TURNS rounds of plain / Tensor /
# Tensor / plain, SHELL_STEPS steps each
DENSENET_BATCH = 64
DENSENET_STEPS = 10
DENSENET_WHOLE_BATCH = 8
SHELL_TURNS = 2
SHELL_STEPS = 3
# Last nn slice: ShuffleNetV2 x1.0 at the PaddleClas recipe (ppcls/configs/
# ImageNet/ShuffleNet/ShuffleNetV2_x1_0.yaml: 224 x 224 crops, 1000
# classes, Momentum 0.9, L2 4e-5, cosine lr 0.5 at 256 images a card). Cut:
# 64 images a card, the lr scaled with the batch (0.5 x 64 / 256) and the
# cosine's period cut to the run's steps (warm-up, timed, profiled).
SHUFFLE_BATCH = 64
SHUFFLE_STEPS = 10
SHUFFLE_LR = 0.5 * SHUFFLE_BATCH / 256
SHUFFLE_WHOLE_BATCH = 8
# [eager ops] / [eager autograd]: the card's f32 against the CPU's f32
# (TF32 off): the same arithmetic in another order (rtol 1e-4, atol 1e-5;
# the decompositions' and special functions' library routines 1e-3, 1e-4)
EAGER_F32 = dict(rtol=1e-4, atol=1e-5)
EAGER_F32_LOOSE = dict(rtol=1e-3, atol=1e-4)
# O1 (bf16) eval logits against the f32 forward of the same weights (cuDNN
# and cuBLAS TF32 off). A random-weight network amplifies the 2^-9 rounding
# of each convolution's operands through depth by an amount that depends
# on the model and its state (from 0.3 % to 15 % in relative L2 across the
# zoo), so the limit is calibrated on the model itself: the O1 error may
# be at most VISION_O1_ROUNDING_RATIO times the error that rounding only
# the weights and the input to bf16 gives in f32 (O1 also rounds each
# convolution's input; ``o1_eval_check`` prints the ratio, 0.9-2.1 on an
# H100), and below VISION_O1_REL_L2_MAX (a wiring fault gives O(1):
# uncorrelated logits are ~1.4 apart)
VISION_O1_ROUNDING_RATIO = 3.0
VISION_O1_REL_L2_MAX = 0.5
# Static-graph and deployment slice: ERNIE-3.0-Base sequence classification
# (2 classes, eval, seeded random weights) served unmasked (a padding mask
# becomes a float bias, which routes attention to sdpa_ref, not the kernel)
# through to_static, jit.save / jit.load, the predictor and a static
# Program. f32 outputs (TF32 off) within STATIC_F32_REL_L2 of the eager f32
# forward (the same kernels; the compiler's matmuls and fusions sum in
# another order); bf16 ones within STATIC_BF16_RATIO x the eager bf16
# forward's own error against f32 (o1_eval_check's calibration)
STATIC_BATCHES = ((32, 128), (1, 128))
STATIC_EXTRA = (8, 64)
STATIC_F32_REL_L2 = 1e-4
STATIC_BF16_RATIO = 3.0
# the f32 deploy pairs run ERNIE cut to STATIC_F32_LAYERS layers (their
# inductor compile took 51 s at 12), bf16 the full 12
STATIC_F32_LAYERS = 2
STATIC_PER_FORWARD = {
    n: {"flash_attention": n, "layernorm": 2 * n + 1}
    for n in (STATIC_F32_LAYERS, 12)}
STATIC_TIMED = {1: 50, 32: 20}     # calls per median, by batch
STATIC_NN_F32 = dict(rtol=1e-4, atol=1e-5)
# Llama-2 at 7B widths deployed as one compiled / exported program and
# differentiated as one static program; depth cut to fit the smoke's time
LLAMA_DEPLOY_LAYERS = 1            # the compiles' time grows with depth
LLAMA_DEPLOY_SHAPES = ((1, 512), (4, 512))
LLAMA_DEPLOY_PER_FORWARD = {"rmsnorm": 2 * LLAMA_DEPLOY_LAYERS + 1,
                            "flash_attention": LLAMA_DEPLOY_LAYERS}
LLAMA_DEPLOY_TIMED = 20            # calls per median
STATIC_GRAD_REL_L2 = 5e-2          # the [whole step] gradient limit
STATIC_GRAD_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                       "flash_attention_bwd", "softmax_ce", "softmax_ce_bwd")
# the rest of the optimizer surface: ERNIE-3.0-Base pretraining with Lamb
# over OneCycleLR; the new optimizers card vs CPU (elementwise f32 updates;
# Lamb's norms and LBFGS's dots sum in another order on the card)
LAMB_STEPS = 10
LAMB_MAX_LR = 2e-3
OPTIMIZERS_F32 = dict(rtol=1e-5, atol=1e-6)
# The rest of the op library: two PaddleDetection models' post-processing
# at their published sizes, card against CPU on the same inputs. PP-YOLO
# R50vd-DCN (configs/ppyolo/_base_/ppyolo_r50vd_dcn.yml): 608 x 608, 80
# classes, its anchors and masks; head logits drawn so that each class
# hands matrix NMS a few hundred candidates above 0.01, as a trained
# detector's do (objectness ~ N(-5, 2), class ~ N(-5, 1.5): random logits
# would pass nearly all 22743 boxes)
PPYOLO_BATCH = 8
PPYOLO_SIZE = 608
PPYOLO_CLASSES = 80
PPYOLO_ANCHORS = [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                  [59, 119], [116, 90], [156, 198], [373, 326]]
PPYOLO_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
PPYOLO_OBJ = (-5.0, 2.0)
PPYOLO_CLS = (-5.0, 1.5)
# matrix_nms at ~5000 candidates a class (uniform scores below this, 22 %
# of 22743 above 0.01), held under a peak of PPYOLO_MANY_PEAK GiB
PPYOLO_MANY_SCALE = 0.0128
PPYOLO_MANY_PEAK = 4.0
# the DCN block in f32, TF32 off: sums of 4608 products in another order;
# its backward's scatter-adds are atomics on the card
DCN_REL_L2 = 1e-5
DCN_GRAD_REL_L2 = 1e-4
# Faster R-CNN R50-FPN (configs/faster_rcnn/_base_/faster_rcnn_r50_fpn.yml):
# batch 2 padded to 800 x 1344 (the images 800 x 1333 and 750 x 1344);
# class logits over 81 classes ~ N(0, 1.5) with the background's mean 3
RCNN_BATCH = 2
RCNN_SHAPE = (800, 1344)
RCNN_IM_SHAPES = ((800.0, 1333.0), (750.0, 1344.0))
RCNN_CLS = (3.0, 1.5)
# kept detections: equal rows (within DET_RTOL / DET_ATOL), or rows matched
# by label and box rounded to DET_KEY, each pair within DET_RTOL /
# DET_ATOL, and a row kept on one side only whose score or IoU lies within
# DET_NEAR of a threshold
DET_RTOL = 1e-5
DET_ATOL = 1e-4
DET_NEAR = 1e-5
DET_KEY = 1e-2
# roi_align: the card and the CPU take the same quotients (the bins are
# divided by a tensor: a Python divisor would be a product with its
# reciprocal on the card, one f32 step off, which moved samples at 336
# feature pixels by up to 8e-5), so only the sum of each bin's samples
# may round apart
ROI_ATOL = 1e-5
# The flash rows in bf16 run the wgmma / TMA kernels (the sm90 design; the
# head_dim-16 rows' bf16 sub-rows name their class group's source); the
# head_dim-16 rows' main entry, f32, the CUDA-core ones (the mma design)
SOURCES = {
    "flash_attention": ("paddle_tpu_torch/csrc/flash_attention_sm90.cu",
                        "paddle_tpu/kernels/flash_attention.py:108"),
    "flash_attention_bwd": (
        "paddle_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
        "paddle_tpu/kernels/flash_attention.py:173"),
    "paged_attention": ("paddle_tpu_torch/csrc/paged_attention.cu",
                        "paddle_tpu/kernels/paged_attention.py:89"),
    "rmsnorm": ("paddle_tpu_torch/csrc/rmsnorm.cu",
                "paddle_tpu/kernels/rmsnorm.py:42"),
    "rmsnorm_bwd": ("paddle_tpu_torch/csrc/rmsnorm.cu",
                    "paddle_tpu/kernels/rmsnorm.py:56"),
    "softmax_ce": ("paddle_tpu_torch/csrc/softmax_ce.cu",
                   "paddle_tpu/kernels/softmax_ce.py:39"),
    "softmax_ce_bwd": ("paddle_tpu_torch/csrc/softmax_ce.cu",
                       "paddle_tpu/kernels/softmax_ce.py:50"),
    "layernorm": ("paddle_tpu_torch/csrc/layernorm.cu",
                  "paddle_tpu/kernels/layernorm.py:38"),
    # the dropout instantiations of the flash kernels (`_drop_mask` applied
    # at flash_attention.py:158 in `_fwd_kernel`, :222 and :277 in the
    # backward kernels)
    "flash_attention_dropout": (
        "paddle_tpu_torch/csrc/flash_attention_sm90.cu",
        "paddle_tpu/kernels/flash_attention.py:108"),
    "flash_attention_bwd_dropout": (
        "paddle_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
        "paddle_tpu/kernels/flash_attention.py:173"),
    # the same kernels' head_dim-36 instantiations (the Conformer's: class
    # 48 through the flattened maps)
    "flash_attention_dropout_d36": (
        "paddle_tpu_torch/csrc/flash_attention_sm90_narrow.cu",
        "paddle_tpu/kernels/flash_attention.py:108"),
    "flash_attention_bwd_dropout_d36": (
        "paddle_tpu_torch/csrc/flash_attention_bwd_sm90_narrow.cu",
        "paddle_tpu/kernels/flash_attention.py:173"),
    "ctc_alpha": ("paddle_tpu_torch/csrc/ctc.cu",
                  "paddle_tpu/kernels/ctc.py:61"),
    "ctc_beta": ("paddle_tpu_torch/csrc/ctc.cu",
                 "paddle_tpu/kernels/ctc.py:92"),
    "rnnt_alpha": ("paddle_tpu_torch/csrc/rnnt.cu",
                   "paddle_tpu/kernels/rnnt.py:100"),
    "rnnt_beta_grad": ("paddle_tpu_torch/csrc/rnnt.cu",
                       "paddle_tpu/kernels/rnnt.py:122"),
    # the flash kernels with a bool mask (`_tile_mask` at :73, applied in
    # all three kernels), on packed sequences (segment ids and the [lo, hi)
    # tables, `flash_attn_varlen_pallas` :860) and at head_dim 16
    "flash_attention_mask": ("paddle_tpu_torch/csrc/flash_attention_sm90.cu",
                             "paddle_tpu/kernels/flash_attention.py:108"),
    "flash_attention_bwd_mask": (
        "paddle_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
        "paddle_tpu/kernels/flash_attention.py:173"),
    "flash_attention_varlen": (
        "paddle_tpu_torch/csrc/flash_attention_sm90.cu",
        "paddle_tpu/kernels/flash_attention.py:108"),
    "flash_attention_bwd_varlen": (
        "paddle_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
        "paddle_tpu/kernels/flash_attention.py:173"),
    "flash_attention_d16": ("paddle_tpu_torch/csrc/flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:108"),
    "flash_attention_bwd_d16": (
        "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/kernels/flash_attention.py:173"),
}


def sm90_build_report(libs):
    """One line a class and kernel of the sm90 flash libraries: ptxas's
    registers (the launch share; setmaxnreg then moves 24 a thread to the
    producer and the rest to the consumers) and spill stores / loads of the
    four variants (dropout, mask: 00 01 10 11), from the build's
    ``-Xptxas=-v`` log, and the dynamic shared memory a block takes (the
    library's own constants)."""
    import ctypes
    import re

    from paddle_tpu_torch.kernels import _build

    entry = re.compile(r"Compiling entry function '_ZN(\d+)")
    kernel = re.compile(r"\d+flash_(\w+?)_sm90_kernelILi(\d+)ELb([01])ELb([01])")

    def kernel_of(line):   # the name after its namespace's, by its length
        m = entry.search(line)
        if not m:
            return None
        k = kernel.match(line, m.end() + int(m.group(1)))
        return k and (k.group(1), int(k.group(2)), k.group(3) + k.group(4))

    kernels = {}
    for name in sorted(libs):
        if "_sm90" not in name:
            continue
        log = libs[name].with_suffix(".log")
        if not log.exists():
            print(f"  {name}: no build log (built earlier)")
            continue
        cur = spill = None
        for line in log.read_text().splitlines():
            k = kernel_of(line)
            if k:
                cur = k
            elif cur and "spill stores" in line:
                spill = "/".join(re.findall(r"(\d+) bytes spill", line))
            elif cur and "Used" in line:
                regs = int(re.search(r"Used (\d+) registers", line).group(1))
                kernels.setdefault((name, cur[0], cur[1]), []).append(
                    (cur[2], regs, spill))
                cur = None
    print("[flash sm90 build] ptxas per class and kernel: registers, spill "
          "stores/loads bytes by (dropout, mask), dynamic shared memory")
    for (name, kind, DP), rows in sorted(kernels.items(),
                                         key=lambda r: (r[0][1], r[0][2])):
        if kind == "fwd":
            fn = _build.function(name, "flash_attention_sm90_fwd_smem",
                                 [ctypes.c_int])
            smem = fn(DP)
        else:
            fn = _build.function(name, "flash_attention_sm90_bwd_smem",
                                 [ctypes.c_int, ctypes.c_int])
            smem = fn(DP, int(kind == "bwd_dkv"))
        regs = sorted({r for _, r, _ in rows})
        spills = ", ".join(f"{v} {sp}" for v, _, sp in sorted(rows))
        print(f"  {kind} class {DP} ({name}.cu): {regs} registers; spills "
              f"{spills}; {smem} bytes shared")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3, host=None) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. The
    card first sleeps for longer than the host takes to queue all of them,
    so the events time the kernels alone and not the Python around each
    launch (a kernel shorter than its wrapper's host time would otherwise
    be timed at the host's rate). Where the host took longer to queue
    than the card slept, the card may have waited for it: the run is
    repeated with a longer sleep (up to 3 runs). ``host``, a list, gets
    the host's time to queue one call, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0          # host and device, one call
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_s = 2e-3 + 1.5 * iters * one
    for _ in range(3):
        # cycles at 2 GHz, above the H100's clock: the sleep lasts at least
        # sleep_s
        torch.cuda._sleep(int(2e9 * sleep_s))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued < sleep_s:
            break
        sleep_s = 2e-3 + 2 * queued
    if host is not None:
        host.append(queued * 1e3 / iters)
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, peak=BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_EXP2_RATE = []


def exp2_rate(torch):
    """The card's exp2 rate in exponentials a second, probed once
    (``kernels/flash_attention.py`` ``exp2_probe_cuda``: EXP2_PROBE's
    blocks of 256 threads, each 8 independent chains of the flash
    kernels' ``ex2.approx``), rather than the published 16 a clock an
    SM."""
    if not _EXP2_RATE:
        from paddle_tpu_torch.kernels import flash_attention as F
        blocks, iters = EXP2_PROBE
        run = lambda: F.exp2_probe_cuda(blocks, iters)
        if not bool(torch.isfinite(run()).all()):
            raise AssertionError("exp2 probe: non-finite")
        ms = time_ms(torch, run, iters=5, warmup=1)
        _EXP2_RATE.append(blocks * 256 * 8 * iters / (ms * 1e-3))
        print(f"[exp2 probe] {_EXP2_RATE[0] / 1e12:.4f} T exp2/s "
              f"({blocks} blocks x 256 threads x 8 chains x {iters} in "
              f"{ms:.4f} ms)")
    return _EXP2_RATE[0]


def flash_bound(torch, nbytes, flops, exps, peak=BF16_FLOPS):
    """:func:`bound_ms` with the flash kernels' third bound, ``exps``
    exponentials (one a score) over the probed exp2 rate, which sets the
    bound at small head widths; the special-function units' exponentials
    count under "operations". Returns (ms, "bytes" | "operations", the
    exponentials' ms, "bytes" | "operations" | "exponentials": which
    set it)."""
    t, by = bound_ms(nbytes, flops, peak)
    t_exp = exps / exp2_rate(torch) * 1e3
    if t_exp > t:
        return t_exp, "operations", t_exp, "exponentials"
    return t, by, t_exp, by


def _mma_times(torch, F, q, k, v, do, lse, dg, p=0.0, seed=11):
    """Device ms of the mma kernels (the design the sm90 kernels replaced
    at these widths), forward and backward, non-causal, at the inputs the
    timed row's sm90 kernels take, launched directly
    (``_launch_fwd`` / ``_launch_bwd`` with ``design="mma"``): the old
    design beside the new on one card, a call of this script alone. The
    first launch of each is held against the plain version."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    drop, scale = F._drop_args(p, seed), 1.0 / math.sqrt(D)
    out, lse_o = torch.empty_like(q), torch.empty(B, H, S, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fwd = lambda: F._launch_fwd(q, k, v, out, lse_o, B, S, Sk, False, scale,
                                drop, None, design="mma")
    bwd = lambda: F._launch_bwd(q, k, v, do, lse, dg, dq, dk, dv, B, S, Sk,
                                False, scale, drop, None, design="mma")
    fwd()
    bwd()
    p_out, _ = F.flash_attention_plain(q, k, v, False, None, p, seed)
    want = F.flash_attention_bwd_plain(q, k, v, do, lse, dg, False, None, p,
                                       seed)
    torch.cuda.synchronize()
    check(torch, f"mma [{B}, {S}, {H}, {D}] p {p} out", out, p_out,
          ATTN_ATOL, BF16_RTOL)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        check_grad(torch, f"mma [{B}, {S}, {H}, {D}] p {p} {name}", a, b,
                   GRAD_FRAC_BF16)
    return time_ms(torch, fwd), time_ms(torch, bwd)


def check(torch, name, got, want, atol, rtol=0.0) -> float:
    """Hold ``got`` (kernel) against ``want`` (plain version) within
    atol + rtol * |want|; returns the max absolute error."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    denom = atol + rtol * want.float().abs()
    ratio = torch.where(diff == 0, 0.0, diff / denom).max().item()
    print(f"  {name}: max_abs_err={err:.3e}, worst |err| / (atol {atol:g} "
          f"+ rtol {rtol:g} * |plain|) = {ratio:.3f}")
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (ratio {ratio} > 1)")
    return err


def rmsnorm_phase(torch, g):
    from paddle_tpu_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain

    print("[kernel] rmsnorm  x [rows, 4096] bf16, eps 1e-5")
    row = None
    worst = 0.0
    for rows, residual in ((4, False), (1024, False), (1024, True)):
        x = torch.randn(rows, 4096, device="cuda", generator=g).bfloat16()
        w = (1 + 0.1 * torch.randn(4096, device="cuda", generator=g)).bfloat16()
        r = (torch.randn(rows, 4096, device="cuda", generator=g).bfloat16()
             if residual else None)
        a, ha, sa = rmsnorm_cuda(x, w, 1e-5, r)
        b, hb, sb = rmsnorm_plain(x, w, 1e-5, r)
        torch.cuda.synchronize()
        err = check(torch, f"rows={rows} residual={residual} out", a, b, NORM_ATOL,
                    BF16_RTOL)
        check(torch, f"rows={rows} residual={residual} rstd", sa, sb, F32_ATOL)
        if residual:   # the same f32 sum rounded once: exactly equal
            check(torch, "sum x + r", ha, hb, 0.0)
        worst = max(worst, err)
        if rows == 1024 and not residual:   # prefill-sized, no residual
            ms = time_ms(torch, lambda: rmsnorm_cuda(x, w, 1e-5))
            plain = time_ms(torch, lambda: rmsnorm_plain(x, w, 1e-5))
            lib = time_ms(torch, lambda: torch.nn.functional.rms_norm(
                x, (4096,), w, 1e-5))
            nbytes = 2 * x.numel() * 2 + w.numel() * 2 + rows * 4
            bound, by = bound_ms(nbytes, 4 * x.numel())
            row = dict(shape=f"[{rows}, 4096] bf16", ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=bound, bound_by=by)
    row["max_abs_err"] = worst
    return row


def paged_bound(q, ctx_list, Hkv, D, bs):
    """Least time for one paged-attention call (bytes): q and out, the live
    K/V rows, the live table entries and the context lengths."""
    live = sum(ctx_list)
    nbytes = (2 * q.numel() * q.element_size()
              + live * 2 * Hkv * D * q.element_size()
              + sum(-(-c // bs) for c in ctx_list) * 4 + len(ctx_list) * 4)
    return bound_ms(nbytes, 4 * live * q.shape[1] * D)


def paged_phase(torch, g):
    """The paged kernel at the engine's layout (bs 16, 128-wide heads, table
    width 64 = max_model_len 1024), bf16: Llama-2-7B's 4 slots (the main
    row, whose launches the engine counts), GQA 32 / 8 heads on the same
    4 slots, and 32 slots of 512-1024 tokens (a batched decode's bytes:
    ~400 MB a layer). Each checked against the plain version, run twice for
    bit-identical outputs, and timed over a pool of several layers, so that
    consecutive launches read other layers' K/V from device memory, not
    L2."""
    from paddle_tpu_torch.kernels import paged_attention as P

    print("[kernel] paged_attention  7B layout, bs 16, bf16")
    N_SLOTS, bs, D, M = 4, 16, 128, 64
    big = torch.Generator().manual_seed(5)
    cases = (  # name, slots, Hq, Hkv, contexts, layers of pool
        ("main", N_SLOTS, 32, 32, [1, 17, 1000, 513], 32),
        ("gqa", N_SLOTS, 32, 8, [1, 17, 999, 577], 32),
        ("bandwidth", 32, 32, 32,
         torch.randint(512, 1025, (32,), generator=big).tolist(), 2))
    row, worst = None, 0.0
    for name, S, Hq, Hkv, ctx_list, L in cases:
        N = S * M + 1          # every slot's own pages; block 0 is scratch
        pool = torch.randn(L, N, 2, Hkv, bs, D, device="cuda",
                           generator=g).bfloat16()
        q = torch.randn(S, Hq, D, device="cuda", generator=g).bfloat16()
        perm = torch.randperm(N - 1, device="cuda", generator=g) + 1
        bt = perm[:S * M].reshape(S, M).to(torch.int32)
        ctx = torch.tensor(ctx_list, device="cuda", dtype=torch.int32)
        a = P.paged_attention_cuda(q, pool[0], bt, ctx)
        b = P.paged_attention_plain(q, pool[0], bt, ctx)
        torch.cuda.synchronize()
        shape = (f"q [{S}, {Hq}, {D}], ctx {ctx_list}" if S <= 4 else
                 f"q [{S}, {Hq}, {D}], ctx {S} seeded in 512-1024 "
                 f"(sum {sum(ctx_list)})")
        err = check(torch, f"{name}: {shape} out", a, b, PAGED_ATOL,
                    BF16_RTOL)
        if not torch.equal(a, P.paged_attention_cuda(q, pool[0], bt, ctx)):
            raise AssertionError(f"paged {name}: two calls differ")
        worst = max(worst, err)
        it = iter(range(10 ** 9))
        ms = time_ms(torch, lambda: P.paged_attention_cuda(
            q, pool[next(it) % L], bt, ctx), iters=max(L, 20))
        plain = time_ms(torch, lambda: P.paged_attention_plain(
            q, pool[next(it) % L], bt, ctx), iters=min(L, 5), warmup=1)
        bound, by = paged_bound(q, ctx_list, Hkv, D, bs)
        # (tools/paged_attention_bench.py also runs this phase against
        # checkouts whose kernel predates the launch plan)
        plan = (P.launch_plan(S, Hq, Hkv, bs, D, M, 2)._asdict()
                if hasattr(P, "launch_plan") else None)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound:.4f} ms ({by}, {100 * bound / ms:.1f} % of it); "
              f"plan {plan}")
        sub = dict(shape=shape, ms=ms, plain_ms=plain, library_ms=None,
                   bound_ms=bound, bound_by=by, max_abs_err=err, plan=plan)
        if row is None:
            row = sub
            row["design"] = ("split over the context, bulk-copy mbarrier "
                             "ring, last-block merge in split order")
        else:
            row[name] = sub
        del pool
    row["max_abs_err"] = worst
    return row


def flash_phase(torch, g):
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)

    print("[kernel] flash_attention  [1, S, 32, 128] causal, bf16")
    row = None
    worst = 0.0
    for S, Hkv in ((1000, 32), (2048, 32), (1000, 8)):
        q = torch.randn(1, S, 32, 128, device="cuda", generator=g).bfloat16()
        k = torch.randn(1, S, Hkv, 128, device="cuda", generator=g).bfloat16()
        v = torch.randn(1, S, Hkv, 128, device="cuda", generator=g).bfloat16()
        (a, la) = flash_attention_cuda(q, k, v, causal=True)
        (b, lb) = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = check(torch, f"S={S} Hkv={Hkv} out", a, b, ATTN_ATOL, BF16_RTOL)
        check(torch, f"S={S} Hkv={Hkv} lse", la, lb, F32_ATOL)
        worst = max(worst, err)
        if S == 2048:
            before = K.launch_counts()
            ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, True))
            design = ran_design(K, before)
            plain = time_ms(torch, lambda: flash_attention_plain(
                q, k, v, True), iters=5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = time_ms(torch, lambda: torch.nn.functional
                          .scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=True))
            pairs = S * (S + 1) // 2          # causal (query, key) pairs
            nbytes = 4 * q.numel() * 2 + 32 * S * 4
            bound, by = bound_ms(nbytes, 4 * pairs * 32 * 128)
            row = dict(shape=f"[1, {S}, 32, 128] causal", ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bound,
                       bound_by=by, design=design)
    row["max_abs_err"] = worst
    return row


def check_grad(torch, name, got, want, frac) -> float:
    """Hold a gradient within atol = frac * max|plain|, rtol = frac; also
    prints its relative L2 error."""
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    print(f"  {name}: relative L2 error {rel:.3e}")
    return check(torch, name, got, want,
                 frac * want.float().abs().max().item(), frac)


def ran_design(K, before, base="flash_attention"):
    """The flash design (``sm90``: the wgmma / TMA kernels, ``mma``: the
    mma.sync / CUDA-core ones) whose launch counter under ``base`` moved since
    the counts ``before``; raises unless exactly one did."""
    moved = [d for d in ("sm90", "mma")
             if K.LAUNCHES[f"{base}_{d}"] != before[f"{base}_{d}"]]
    if len(moved) != 1:
        raise AssertionError(f"{base}: designs launched {moved}, want one")
    return moved[0]


def want_design(rows, design):
    """Every row of ``rows`` (and its sub-rows) ran ``design``."""
    for r in rows:
        got = [r["design"]] + [x["design"] for x in r.values()
                               if isinstance(x, dict) and "design" in x]
        if any(d != design for d in got):
            raise AssertionError(f"{r['shape']}: ran {got}, want {design}")


def all_sm90(what, counts):
    """Every flash launch among ``counts`` went through the sm90 kernels."""
    for base in ("flash_attention", "flash_attention_bwd"):
        total = counts[f"{base}_sm90"] + counts[f"{base}_mma"]
        if not total or counts[f"{base}_mma"]:
            raise AssertionError(f"{what}: {base} launches {total}, of them "
                                 f"{counts[f'{base}_mma']} on the mma.sync "
                                 f"kernels; want all on sm90")
    print(f"  {what}: every flash launch ran the sm90 kernels "
          f"({counts['flash_attention_sm90']} forward, "
          f"{counts['flash_attention_bwd_sm90']} backward)")


def flash_bwd_phase(torch, g):
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels.flash_attention import (
        delta_minus_glse, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_plain)

    print("[kernel] flash_attention_bwd  [1, S, 32, 128] causal, bf16, "
          "with an lse cotangent")
    row = None
    worst = 0.0
    for S, Hkv in ((2048, 32), (2048, 8), (1000, 32)):
        q = torch.randn(1, S, 32, 128, device="cuda", generator=g).bfloat16()
        k = torch.randn(1, S, Hkv, 128, device="cuda", generator=g).bfloat16()
        v = torch.randn(1, S, Hkv, 128, device="cuda", generator=g).bfloat16()
        do = torch.randn(1, S, 32, 128, device="cuda", generator=g).bfloat16()
        glse = 0.1 * torch.randn(1, 32, S, device="cuda", generator=g)
        out, lse = flash_attention_plain(q, k, v, causal=True)
        dg = delta_minus_glse(out, do, glse)
        got = flash_attention_bwd_cuda(q, k, v, do, lse, dg, True)
        want = flash_attention_bwd_plain(q, k, v, do, lse, dg, True)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            worst = max(worst, check_grad(torch, f"S={S} Hkv={Hkv} {name}",
                                          a, b, GRAD_FRAC_BF16))
        del got, want
        if S == 2048 and Hkv == 32:
            before = K.launch_counts()
            ms = time_ms(torch, lambda: flash_attention_bwd_cuda(
                q, k, v, do, lse, dg, True))
            design = ran_design(K, before, "flash_attention_bwd")
            plain = time_ms(torch, lambda: flash_attention_bwd_plain(
                q, k, v, do, lse, dg, True), iters=3, warmup=1)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            ot = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
            gt = do.transpose(1, 2)
            lib = time_ms(torch, lambda: torch.autograd.grad(
                ot, (qt, kt, vt), gt, retain_graph=True))
            del ot
            pairs = S * (S + 1) // 2          # causal (query, key) pairs
            # read q, k, v, dO, lse, dg; write dq, dk, dv
            nbytes = 7 * q.numel() * 2 + 2 * 32 * S * 4
            # five products of 2 * pairs * 128 flops per head
            bound, by = bound_ms(nbytes, 10 * pairs * 32 * 128)
            row = dict(shape=f"[1, {S}, 32, 128] causal", ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bound,
                       bound_by=by, design=design)
    row["max_abs_err"] = worst
    return row


def rmsnorm_bwd_phase(torch, g):
    from paddle_tpu_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,
                                                  rmsnorm_bwd_plain,
                                                  rmsnorm_plain)

    print("[kernel] rmsnorm_bwd  [8192, 4096], eps 1e-5")
    row = None
    worst = 0.0
    for dtype, residual in ((torch.bfloat16, False), (torch.bfloat16, True),
                            (torch.float32, False)):
        rows = 8192
        x = torch.randn(rows, 4096, device="cuda", generator=g).to(dtype)
        w = (1 + 0.1 * torch.randn(4096, device="cuda", generator=g)).to(dtype)
        r = (torch.randn(rows, 4096, device="cuda", generator=g).to(dtype)
             if residual else None)
        gy = torch.randn(rows, 4096, device="cuda", generator=g).to(dtype)
        _, _, rstd = rmsnorm_plain(x, w, 1e-5, r)
        dx, dw = rmsnorm_bwd_cuda(x, w, rstd, gy, r)
        p_dx, p_dw = rmsnorm_bwd_plain(x, w, rstd, gy, r)
        torch.cuda.synchronize()
        frac = GRAD_FRAC_BF16 if dtype == torch.bfloat16 else GRAD_FRAC_F32
        tag = f"{str(dtype)[6:]} residual={residual}"
        err = check_grad(torch, f"{tag} dx", dx, p_dx, frac)
        err = max(err, check_grad(torch, f"{tag} dw", dw, p_dw, frac))
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        if dtype == torch.bfloat16 and not residual:
            ms = time_ms(torch, lambda: rmsnorm_bwd_cuda(x, w, rstd, gy))
            plain = time_ms(torch, lambda: rmsnorm_bwd_plain(x, w, rstd, gy))
            xt, wt = x.detach().requires_grad_(), w.detach().requires_grad_()
            yt = torch.nn.functional.rms_norm(xt, (4096,), wt, 1e-5)
            lib = time_ms(torch, lambda: torch.autograd.grad(
                yt, (xt, wt), gy, retain_graph=True))
            # read x, g, w, rstd; write dx, dw
            nbytes = 3 * x.numel() * 2 + 2 * w.numel() * 2 + rows * 4
            bound, by = bound_ms(nbytes, 8 * x.numel(), F32_FLOPS)
            row = dict(shape=f"[{rows}, 4096] bf16", ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=bound, bound_by=by)
    row["max_abs_err"] = worst
    return row


def softmax_ce_phases(torch, g):
    """Both softmax-CE kernels at Llama's logits (every 10th row ignored,
    the row in the kernels line), at ERNIE's MLM logits (labels made as
    ernie_batch makes them: about 85 % of rows at ignore_index), at the
    Whisper training step's [16 x 224, 51865] (a sub-row: the odd
    vocabulary starts every other bf16 row off 16-byte alignment, so the
    kernels' scalar head and tail run), at ResNet-50's head, [64,
    1000] in the bf16 its O1 step hands the kernels (a sub-row), and at
    the f32 logits of the ``Model.fit`` phases: LeNet's [256, 10] and
    ResNet-50's [64, 1000] (sub-rows ``hapi_lenet`` and ``hapi_resnet``;
    f32 gradients within GRAD_FRAC_F32)."""
    from paddle_tpu_torch.kernels.softmax_ce import (
        softmax_ce_bwd_cuda, softmax_ce_bwd_plain, softmax_ce_cuda,
        softmax_ce_plain)

    rows = None
    N_W = WHISPER_TRAIN_BATCH * WHISPER_TRAIN_TOKENS
    bf16, f32 = torch.bfloat16, torch.float32
    for N, V, what, dt, sub in (
            (8192, 32000, "every 10th row:", bf16, None),
            (8192, 40000, "ERNIE's MLM labels:", bf16, None),
            (N_W, 51865, "Whisper's targets:", bf16, "whisper"),
            (RESNET_BATCH, 1000, "ResNet-50's head:", bf16, "resnet"),
            (LENET_BATCH, 10, "LeNet's head through Model.fit:", f32,
             "hapi_lenet"),
            (RESNET_BATCH, 1000, "ResNet-50's head through Model.fit:", f32,
             "hapi_resnet")):
        x = (2 * torch.randn(N, V, device="cuda", generator=g)).to(dt)
        if V in (10, 1000):
            lab = resnet_batch(torch, N, 8, V, 1, "cuda")[1].reshape(-1)
        elif V == 32000:
            lab = torch.randint(0, V, (N,), device="cuda", generator=g)
            lab[::10] = -100
        elif V == 40000:
            lab = ernie_batch(torch, 16, 512, V, 1, "cuda")[1].reshape(-1)
        else:
            lab = whisper_targets(torch, WHISPER_TRAIN_BATCH,
                                  WHISPER_TRAIN_TOKENS, V, 1, 3,
                                  "cuda")[1].reshape(-1)
        valid = lab != -100
        n_valid = int(valid.sum().item())
        name = "bf16" if dt == bf16 else "f32"
        print(f"[kernel] softmax_ce, softmax_ce_bwd  logits [{N}, {V}] "
              f"{name}, {what} {N - n_valid} of {N} rows at ignore_index")
        # what cross_entropy hands the kernels: label 0 on ignored rows, and
        # the mean's gradient 1 / (valid rows) on the others
        safe = torch.where(valid, lab, 0)
        gl = valid.float() / n_valid
        loss, lse = softmax_ce_cuda(x, safe)
        p_loss, p_lse = softmax_ce_plain(x, safe)
        dx = softmax_ce_bwd_cuda(x, safe, lse, gl)
        p_dx = softmax_ce_bwd_plain(x, safe, p_lse, gl)
        torch.cuda.synchronize()
        err_f = max(check(torch, "loss (valid rows)", loss[valid],
                          p_loss[valid], CE_ATOL, CE_RTOL),
                    check(torch, "lse", lse, p_lse, CE_ATOL, CE_RTOL))
        err_b = check_grad(torch, "dx", dx, p_dx,
                           GRAD_FRAC_BF16 if dt == bf16 else GRAD_FRAC_F32)
        if (~valid).any() and dx[~valid].abs().max().item() != 0:
            raise AssertionError("softmax_ce_bwd: an ignored row got a "
                                 "gradient")
        del p_dx, dx
        fwd_ms = time_ms(torch, lambda: softmax_ce_cuda(x, safe))
        fwd_plain = time_ms(torch, lambda: softmax_ce_plain(x, safe), iters=5)
        fwd_lib = time_ms(torch, lambda: torch.nn.functional.cross_entropy(
            x, lab, reduction="none"))
        bwd_ms = time_ms(torch, lambda: softmax_ce_bwd_cuda(x, safe, lse, gl))
        bwd_plain = time_ms(torch, lambda: softmax_ce_bwd_plain(
            x, safe, p_lse, gl), iters=5)
        xt = x.detach().requires_grad_()
        lt = torch.nn.functional.cross_entropy(xt, lab, reduction="none")
        bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
            lt, xt, gl, retain_graph=True))
        del lt, xt
        shape = f"[{N}, {V}] {name}"
        # forward: read the logits and labels, write loss and lse; about five
        # f32 operations per logit (max, subtract, exp, add, compare)
        nb = x.element_size()
        bound_f, by_f = bound_ms(x.numel() * nb + N * 8 + N * 8,
                                 5 * x.numel(), F32_FLOPS)
        # backward: read the logits, labels, lse and g, write dx (every row,
        # the ignored ones as zeros)
        bound_b, by_b = bound_ms(2 * x.numel() * nb + N * 16, 5 * x.numel(),
                                 F32_FLOPS)
        pair = (dict(shape=shape, ms=fwd_ms, plain_ms=fwd_plain,
                     library_ms=fwd_lib, bound_ms=bound_f, bound_by=by_f,
                     max_abs_err=err_f),
                dict(shape=shape, ms=bwd_ms, plain_ms=bwd_plain,
                     library_ms=bwd_lib, bound_ms=bound_b, bound_by=by_b,
                     max_abs_err=err_b))
        if rows is None:
            rows = pair
        else:
            for name, r in zip(("softmax_ce", "softmax_ce_bwd"), pair):
                print(f"  {name} at {shape} ({what[:-1]}): kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                      f"library {r['library_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs "
                      f"err {r['max_abs_err']:.3e}")
        if sub is not None:
            _sub_rows(rows, sub, pair)
        del x, lab, safe, gl, loss, lse, p_loss, p_lse
    return rows


def layernorm_phase(torch, g):
    from paddle_tpu_torch.kernels.layernorm import (layer_norm_cuda,
                                                    layer_norm_plain)

    print("[kernel] layernorm  x [rows, F], w and b [F], eps 1e-5")
    row = None
    worst = 0.0
    for rows, cols, dt in ((8192, 768, torch.float32),
                           (8192, 768, torch.bfloat16),
                           (1024, 4096, torch.bfloat16),
                           (6400, 144, torch.float32),    # the Conformer's
                           (12000, 512, torch.bfloat16)):  # Whisper-base's
        x = (2 * torch.randn(rows, cols, device="cuda", generator=g)
             + 0.5).to(dt)
        w = (1 + 0.1 * torch.randn(cols, device="cuda", generator=g)).to(dt)
        b = (0.1 * torch.randn(cols, device="cuda", generator=g)).to(dt)
        out, mean, rstd = layer_norm_cuda(x, w, b, 1e-5)
        p_out, p_mean, p_rstd = layer_norm_plain(x, w, b, 1e-5)
        torch.cuda.synchronize()
        tag = f"[{rows}, {cols}] {str(dt)[6:]}"
        if dt == torch.float32:
            atol, rtol = LN_F32_ATOL, LN_F32_ATOL
        else:   # one bf16 step at the scale of the largest output
            top = p_out.float().abs().max().item()
            atol, rtol = 2.0 ** (math.floor(math.log2(top)) - 7), 0.0
        err = check(torch, f"{tag} out", out, p_out, atol, rtol)
        check(torch, f"{tag} mean", mean, p_mean, LN_F32_ATOL, LN_F32_ATOL)
        check(torch, f"{tag} rstd", rstd, p_rstd, LN_F32_ATOL, LN_F32_ATOL)
        worst = max(worst, err)
        host = []
        ms = time_ms(torch, lambda: layer_norm_cuda(x, w, b, 1e-5),
                     host=host)
        plain = time_ms(torch, lambda: layer_norm_plain(x, w, b, 1e-5))
        lib = time_ms(torch, lambda: torch.nn.functional.layer_norm(
            x, (cols,), w, b, 1e-5), host=host)
        size = x.element_size()
        vec = cols % (16 // size) == 0 and not any(
            t.data_ptr() % 16 for t in (x, w, b, out))
        # read x, w, b; write out, mean, rstd; ~8 f32 operations an element
        nbytes = 2 * x.numel() * size + 2 * cols * size + 2 * rows * 4
        bound, by = bound_ms(nbytes, 8 * x.numel(), F32_FLOPS)
        print(f"  {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"F.layer_norm {lib:.4f} ms, bound {bound:.4f} ms ({by}); "
              f"{'16-byte' if vec else 'scalar'} path; "
              f"host time to queue one call: wrapper {host[0]:.4f} ms, "
              f"F.layer_norm {host[1]:.4f} ms")
        if row is None:     # the ERNIE path's shape: f32 under O1
            row = dict(shape=tag, ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=bound, bound_by=by)
        elif cols == 512:   # [whisper]'s encoder, 8 x 1500 frames
            row["whisper"] = dict(shape=tag, ms=ms, plain_ms=plain,
                                  library_ms=lib, bound_ms=bound, bound_by=by)
    row["max_abs_err"] = worst
    return row


def mask_probes(torch, d, p, seed):
    """Read each flash kernel's applied dropout mask back at head_dim d:
    S_k = d keys and q = k = 0 make every probability 1 / d, so with v = I
    out holds z / (d (1 - p)), dQ (k = v = I, dO = 1) scale times that,
    and dV (dO = I, S_q = d) its transpose; each must equal the plain
    version's keep bits exactly."""
    from paddle_tpu_torch.kernels.flash_attention import (
        dropout_keep_plain, flash_attention_bwd_cuda, flash_attention_cuda)

    Sq, Hp = 300, 4
    zeros = torch.zeros(2, Sq, Hp, d, device="cuda", dtype=torch.bfloat16)
    kzero = torch.zeros(2, d, Hp, d, device="cuda", dtype=torch.bfloat16)
    eye = torch.eye(d, device="cuda", dtype=torch.bfloat16)[
        None, :, None, :].expand(2, d, Hp, d).contiguous()
    keep = dropout_keep_plain(seed, 2, Hp, Sq, d, p, "cuda").float()
    out, _ = flash_attention_cuda(zeros, kzero, eye, False, None, p, seed)
    lse = torch.full((2, Hp, Sq), math.log(d), device="cuda")
    dg = torch.zeros(2, Hp, Sq, device="cuda")
    dq, _, _ = flash_attention_bwd_cuda(zeros, eye, eye,
                                        torch.ones_like(zeros), lse, dg,
                                        False, None, p, seed)
    _, _, dv = flash_attention_bwd_cuda(
        kzero, kzero, eye, eye, lse[:, :, :d].contiguous(),
        dg[:, :, :d].contiguous(), False, None, p, seed)
    torch.cuda.synchronize()
    reads = {
        "forward": (out.float() * d * (1 - p)).round().permute(0, 2, 1, 3),
        "dQ": (dq.float() * d * (1 - p) * math.sqrt(d)).round()
        .permute(0, 2, 1, 3),
        "dK/dV": (dv.float() * d * (1 - p)).round().permute(0, 2, 3, 1)}
    for name, z in reads.items():
        ref = keep if name != "dK/dV" else keep[:, :, :d]
        if not torch.equal(z, ref):
            raise AssertionError(f"the {name} kernel applied another "
                                 f"mask than the plain bits (d={d})")
    print(f"  probes, head_dim {d}: the forward, dQ and dK/dV kernels "
          f"each applied exactly the plain version's mask")


def flash_dropout_phases(torch, g):
    """The flash kernels' dropout: the mask function against its plain
    version bit for bit, each kernel's applied mask read out by probes,
    then outputs and gradients against the plain versions."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels.flash_attention import (
        delta_minus_glse, dropout_bits_cuda, dropout_bits_plain,
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_plain)

    p, seed = ERNIE_DROPOUT, 20240
    B, S, H, D = 16, 512, 12, 64
    print(f"[kernel] flash_attention_dropout, flash_attention_bwd_dropout  "
          f"[{B}, {S}, {H}, {D}] bf16, p {p}")
    bits = dropout_bits_cuda(seed, B * H, S, S, "cuda")
    want = dropout_bits_plain(seed, B * H, S, S, "cuda")
    torch.cuda.synchronize()
    same = bool(torch.equal(bits, want))
    print(f"  mask function: {bits.numel()} bits of the CUDA dump equal to "
          f"the plain version's: {same}")
    if not same:
        raise AssertionError("dropout bits differ from the plain version")
    del bits, want
    for d in (64, 128):
        mask_probes(torch, d, p, seed)
    worst_f = worst_b = 0.0
    rows = None
    for (b_, s_, h_, hkv, d, causal) in ((B, S, H, H, D, False),
                                         (2, 777, 16, 4, 128, False),
                                         (2, 777, 16, 4, 128, True)):
        q = torch.randn(b_, s_, h_, d, device="cuda", generator=g).bfloat16()
        k = torch.randn(b_, s_, hkv, d, device="cuda", generator=g).bfloat16()
        v = torch.randn(b_, s_, hkv, d, device="cuda", generator=g).bfloat16()
        do = torch.randn(b_, s_, h_, d, device="cuda", generator=g).bfloat16()
        tag = f"[{b_}, {s_}, {h_}, {d}] Hkv={hkv} causal={causal}"
        out, lse = flash_attention_cuda(q, k, v, causal, None, p, seed)
        p_out, p_lse = flash_attention_plain(q, k, v, causal, None, p, seed)
        torch.cuda.synchronize()
        worst_f = max(worst_f, check(torch, f"{tag} out", out, p_out,
                                     ATTN_ATOL, BF16_RTOL))
        check(torch, f"{tag} lse", lse, p_lse, F32_ATOL)
        dg = delta_minus_glse(p_out, do)
        got = flash_attention_bwd_cuda(q, k, v, do, p_lse, dg, causal, None,
                                       p, seed)
        want = flash_attention_bwd_plain(q, k, v, do, p_lse, dg, causal,
                                         None, p, seed)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            worst_b = max(worst_b, check_grad(torch, f"{tag} {name}", a, b,
                                              GRAD_FRAC_BF16))
        del got, want, p_out
        if rows is not None:
            continue
        # the ERNIE shape: kernel, plain, library, and the dense kernel
        before = K.launch_counts()
        fwd = time_ms(torch, lambda: flash_attention_cuda(q, k, v, False,
                                                          None, p, seed))
        design_f = ran_design(K, before)
        dense = time_ms(torch, lambda: flash_attention_cuda(q, k, v))
        fwd_plain = time_ms(torch, lambda: flash_attention_plain(
            q, k, v, False, None, p, seed), iters=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fwd_lib = time_ms(torch, lambda: sdpa(qt, kt, vt, dropout_p=p))
        before = K.launch_counts()
        bwd = time_ms(torch, lambda: flash_attention_bwd_cuda(
            q, k, v, do, lse, dg, False, None, p, seed))
        design_b = ran_design(K, before, "flash_attention_bwd")
        bwd_dense = time_ms(torch, lambda: flash_attention_bwd_cuda(
            q, k, v, do, lse, dg))
        bwd_plain = time_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, do, lse, dg, False, None, p, seed), iters=3, warmup=1)
        qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        og = sdpa(qg, kg, vg, dropout_p=p)
        bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
            og, (qg, kg, vg), do.transpose(1, 2), retain_graph=True))
        del og
        pairs = s_ * s_
        # forward: read q, k, v, write out and lse; two products of
        # 2 * pairs * D flops per head
        nb_f = 4 * q.numel() * 2 + b_ * h_ * s_ * 4
        bound_f, by_f = bound_ms(nb_f, 4 * pairs * d * b_ * h_)
        # backward: read q, k, v, dO, lse, dg, write dq, dk, dv; five
        # products
        nb_b = 7 * q.numel() * 2 + 2 * b_ * h_ * s_ * 4
        bound_b, by_b = bound_ms(nb_b, 10 * pairs * d * b_ * h_)
        print(f"  {tag}: forward kernel {fwd:.4f} ms (dense kernel "
              f"{dense:.4f}), plain {fwd_plain:.4f}, SDPA(dropout) "
              f"{fwd_lib:.4f}, bound {bound_f:.4f} ({by_f}); backward kernel "
              f"{bwd:.4f} ms (dense {bwd_dense:.4f}), plain {bwd_plain:.4f}, "
              f"SDPA backward {bwd_lib:.4f}, bound {bound_b:.4f} ({by_b})")
        shape = f"{tag} bf16 p={p}"
        rows = (dict(shape=shape, ms=fwd, plain_ms=fwd_plain,
                     library_ms=fwd_lib, bound_ms=bound_f, bound_by=by_f,
                     dense_ms=dense, design=design_f),
                dict(shape=shape, ms=bwd, plain_ms=bwd_plain,
                     library_ms=bwd_lib, bound_ms=bound_b, bound_by=by_b,
                     dense_ms=bwd_dense, design=design_b))
    rows[0]["max_abs_err"], rows[1]["max_abs_err"] = worst_f, worst_b
    return rows

def ctc_batch(torch, T, B, C, L, seed, device):
    """Seeded CTC inputs: log-softmax of logits [T, B, C], labels from
    1..C-1, input lengths over 3T/4..T and label lengths over L/2..L, with
    repeated adjacent labels (row 1), an empty label (row 2) and an
    infeasible row (row 3: L equal labels need 2L - 1 frames; it gets
    L + 2)."""
    gen = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(2 * torch.randn(T, B, C, generator=gen), -1)
    labels = torch.randint(1, C, (B, L), generator=gen)
    in_len = torch.randint(3 * T // 4, T + 1, (B,), generator=gen)
    lbl_len = torch.randint(L // 2, L + 1, (B,), generator=gen)
    labels[1, 1:5] = labels[1, 0]
    lbl_len[2] = 0
    labels[3], lbl_len[3], in_len[3] = 5, L, L + 2
    return [t.to(device) for t in (lp, labels, in_len, lbl_len)]


def check_lattice(torch, name, got, want) -> float:
    """The -1e30 entries equal, the live ones within CTC_ATOL / CTC_RTOL."""
    dead = want <= -5e29
    if not (torch.equal(dead, got <= -5e29)
            and torch.equal(got[dead], want[dead])):
        raise AssertionError(f"{name}: the kernel's -1e30 entries differ "
                             f"from the plain version's")
    return check(torch, f"{name} (live entries)", got[~dead], want[~dead],
                 CTC_ATOL, CTC_RTOL)


def lattice_routes(M):
    """A lattice kernel module's launches per route so far ({} where the
    checkout predates the routes)."""
    return dict(getattr(M, "ROUTES", {}))


def ctc_phase(torch, g):
    """The CTC alpha and beta kernels, the loss and its gradient against
    the plain versions on the card: the Conformer's shape (L 48, S 97), a
    long-label S 201, both sides of the warp boundary (S 127 / 129, whole
    rows of an odd C), a vocabulary of 5001, the widest lattice (S 8191)
    with whole rows and with gathered states, and T = 1. The route each
    case took is read from the wrappers' route counts and must be the
    launch plan's (the Conformer's S 97 takes "warp"); two calls give the
    same bits. Times at the Conformer's shape (the row) and at S 201 (a
    sub-row), each with its chain bound (dependent steps x the probe's
    step) beside the byte bound."""
    from paddle_tpu_torch.kernels import ctc as M

    cases = [("slice L 48 (S 97)", (400, 16, 128, 48), "warp"),
             ("long labels L 100 (S 201)", (400, 16, 128, 100), "block"),
             ("S 127", (70, 4, 200, 63), "warp"),
             ("S 129, C 41", (70, 4, 41, 64), "block"),
             ("C 5001", (60, 4, 5001, 20), "warp"),
             ("L 4095 (S 8191), C 33", (24, 4, 33, 4095), "block"),
             ("L 4095 (S 8191), C 9000", (12, 4, 9000, 4095), "block"),
             ("T 1", (1, 4, 6, 3), "warp")]
    timed = ("slice L 48 (S 97)", "long labels L 100 (S 201)")
    print("[kernel] ctc_alpha, ctc_beta  log_probs [T, B, C] f32, labels "
          "[B, L]: ragged lengths, repeats, an empty label, an infeasible "
          "row")
    step = chain_step_us(torch, "ctc")
    if step is not None:
        print(f"  chain probe: one CTC step (two shuffles, fmaxf, two expf, "
              f"logf, adds) {step:.5f} us, in {CHAIN_PROBE_STEPS} dependent "
              f"steps on one warp")
    rows = None
    worst = [0.0, 0.0]
    for i, (tag, (T, B, C, L), route) in enumerate(cases):
        lp, labels, in_len, lbl_len = ctc_batch(torch, T, B, C, L, L + i,
                                                "cuda")
        S = 2 * L + 1
        before = lattice_routes(M)
        alphas, ll = M.ctc_alpha_cuda(lp, labels, in_len, lbl_len)
        betas = M.ctc_beta_cuda(lp, labels, in_len, lbl_len)
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in lattice_routes(M).items()
               if v != before[k]}
        if before and ran != {f"ctc_alpha_{route}": 1,
                              f"ctc_beta_{route}": 1}:
            raise AssertionError(f"{tag}: expected route {route}, ran {ran}")
        p_alphas, p_ll = M.ctc_alpha_plain(lp, labels, in_len, lbl_len)
        p_betas = M.ctc_beta_plain(lp, labels, in_len, lbl_len)
        torch.cuda.synchronize()
        worst[0] = max(worst[0], check_lattice(torch, f"{tag} alphas",
                                               alphas, p_alphas),
                       check(torch, f"{tag} loss", -ll, -p_ll, 1e-4,
                             CTC_RTOL))
        worst[1] = max(worst[1], check_lattice(torch, f"{tag} betas", betas,
                                               p_betas))
        x = lp.clone().requires_grad_()
        M.ctc_lattice(x, labels, in_len, lbl_len).sum().backward()
        want = M.ctc_grad(p_alphas, p_betas, p_ll, labels,
                          torch.ones(B, device="cuda"), C)
        torch.cuda.synchronize()
        worst[1] = max(worst[1], check_grad(torch, f"{tag} d log_probs",
                                            x.grad, want, GRAD_FRAC_F32))
        if x.grad[:, 3].any():
            raise AssertionError(f"{tag}: the infeasible row got a gradient")
        again = M.ctc_alpha_cuda(lp, labels, in_len, lbl_len)
        if not (torch.equal(again[0], alphas) and torch.equal(again[1], ll)
                and torch.equal(M.ctc_beta_cuda(lp, labels, in_len,
                                                lbl_len), betas)):
            raise AssertionError(f"{tag}: two calls gave different bits")
        print(f"  {tag}: route {route if before else 'single'}; the "
              f"infeasible row's loss {-ll[3].item():.3g} and gradient 0; "
              f"two calls give the same bits")
        if tag not in timed:
            continue
        a_ms = time_ms(torch, lambda: M.ctc_alpha_cuda(lp, labels, in_len,
                                                       lbl_len))
        b_ms = time_ms(torch, lambda: M.ctc_beta_cuda(lp, labels, in_len,
                                                      lbl_len))
        a_plain = time_ms(torch, lambda: M.ctc_alpha_plain(
            lp, labels, in_len, lbl_len), iters=3, warmup=1)
        b_plain = time_ms(torch, lambda: M.ctc_beta_plain(
            lp, labels, in_len, lbl_len), iters=3, warmup=1)
        ctc = torch.nn.functional.ctc_loss
        lib_f = time_ms(torch, lambda: ctc(lp, labels, in_len, lbl_len,
                                           reduction="none"))
        xl = lp.clone().requires_grad_()
        lib_loss = ctc(xl, labels, in_len, lbl_len, reduction="none",
                       zero_infinity=True).sum()
        lib_b = time_ms(torch, lambda: torch.autograd.grad(
            lib_loss, xl, retain_graph=True))
        # the dependent steps: alpha carries every row (T); beta's chain
        # runs from its terminal row in_len - 1 down (none where in_len is
        # outside [1, T]), so max(in_len) steps
        chain_b = torch.where((in_len >= 1) & (in_len <= T), in_len, 0)
        steps_a, steps_b = T, int(chain_b.max())
        # alpha: read log_probs and labels, write alphas and ll; beta: the
        # same inputs, write betas. ~12 f32 operations a state and step
        # (fmaxf, the subtractions, two expf, a logf, the adds, selects)
        nb_in = lp.numel() * 4 + labels.numel() * 8 + 2 * B * 8
        nb_out = T * B * S * 4
        bound_a, by_a = bound_ms(nb_in + nb_out + B * 4, 12 * T * B * S,
                                 F32_FLOPS)
        bound_b, by_b = bound_ms(nb_in + nb_out,
                                 12 * int(chain_b.sum()) * S, F32_FLOPS)
        chains = [{"dependent_steps": n, "step_us": step,
                   "chain_bound_ms": None if step is None
                   else n * step / 1e3} for n in (steps_a, steps_b)]
        chain_s = "" if step is None else (
            f"; chain bounds {chains[0]['chain_bound_ms']:.4f} / "
            f"{chains[1]['chain_bound_ms']:.4f} ms ({steps_a} / {steps_b} "
            f"steps x {step:.5f} us)")
        print(f"  {tag}: alpha kernel {a_ms:.4f} ms, plain {a_plain:.4f}, "
              f"F.ctc_loss {lib_f:.4f}, bound {bound_a:.4f} ({by_a}; "
              f"{1e3 * a_ms / steps_a:.3f} us a step); beta kernel "
              f"{b_ms:.4f} ms, plain {b_plain:.4f}, F.ctc_loss backward "
              f"{lib_b:.4f}, bound {bound_b:.4f} ({by_b}; "
              f"{1e3 * b_ms / max(steps_b, 1):.3f} us a step){chain_s}")
        shape = f"log_probs [{T}, {B}, {C}] f32, L {L}"
        plan = (M.launch_plan(S, C)._asdict()
                if hasattr(M, "launch_plan") else None)
        sub = (dict(shape=shape, ms=a_ms, plain_ms=a_plain, library_ms=lib_f,
                    bound_ms=bound_a, bound_by=by_a, route=route, plan=plan,
                    chain=chains[0]),
               dict(shape=shape, ms=b_ms, plain_ms=b_plain, library_ms=lib_b,
                    bound_ms=bound_b, bound_by=by_b, route=route, plan=plan,
                    chain=chains[1]))
        if rows is None:
            rows = sub
        else:
            for r, m in zip(rows, sub):
                r["long_labels"] = m
        del xl, lib_loss
    rows[0]["max_abs_err"], rows[1]["max_abs_err"] = worst
    return rows


def rnnt_lattices(torch, B, T, U1, tl_range, ul_range, seed, edges=False,
                  V=128):
    """The blank and emit lattices ``[B, T, U1]`` f32 as ``rnnt_loss``
    builds them from seeded joint logits ``[B, T, U1, V]``: log-softmax,
    the blank column, the labels' log-probs, emits past u_len and at column
    U1 - 1 at -1e30. t_len and u_len are drawn from the inclusive ranges;
    with ``edges`` row 0 has u_len 0, row 1 t_len 1 and row 2 both."""
    from paddle_tpu_torch.kernels.rnnt import NEG

    gen = torch.Generator(device="cuda").manual_seed(seed)
    lp = torch.log_softmax(torch.randn(B, T, U1, V, device="cuda",
                                       generator=gen), -1)
    labels = torch.randint(1, V, (B, U1 - 1), device="cuda", generator=gen)
    tl = torch.randint(tl_range[0], tl_range[1] + 1, (B,), device="cuda",
                       generator=gen)
    ul = torch.randint(ul_range[0], ul_range[1] + 1, (B,), device="cuda",
                       generator=gen)
    if edges:
        ul[0], tl[1], tl[2], ul[2] = 0, 1, 1, 0
    blank = lp[..., 0].contiguous()
    emit = lp[:, :, :U1 - 1].gather(
        3, labels[:, None, :, None].expand(B, T, U1 - 1, 1)).squeeze(3)
    emit = torch.where(torch.arange(U1 - 1, device="cuda") < ul[:, None, None],
                       emit, NEG)
    emit = torch.nn.functional.pad(emit, (0, 1), value=NEG)
    return blank, emit, tl, ul


CHAIN_PROBE_STEPS = 100000


def chain_step_us(torch, kind):
    """The latency of one dependent step of a lattice recursion on the
    card, in us: one warp runs CHAIN_PROBE_STEPS steps in registers (kind
    "rnnt": ``kernels/rnnt.py`` ``chain_probe_cuda``, a shuffle + lse2 with
    the reference's two expf; "ctc": ``kernels/ctc.py``
    ``chain_probe_cuda``, the CTC kernels' step: two shuffles + lse3 with
    two expf). None where the checkout has no such probe (an older --root
    of tools/rnnt_bench.py or tools/ctc_kernel_bench.py)."""
    if kind == "rnnt":
        from paddle_tpu_torch.kernels import rnnt as M
        # log(1/2) keeps the chain's values bounded
        w = torch.tensor([math.log(0.5)] * 3, device="cuda")
        run = lambda: M.chain_probe_cuda(CHAIN_PROBE_STEPS, 2, w)
    else:
        from paddle_tpu_torch.kernels import ctc as M
        # log(2/5) with the skip term's log(1/2): bounded values
        w = torch.tensor([math.log(0.4), math.log(0.5), math.log(0.5)],
                         device="cuda")
        run = lambda: M.chain_probe_cuda(CHAIN_PROBE_STEPS, w)
    if not hasattr(M, "chain_probe_cuda"):
        return None
    if not bool(torch.isfinite(run()).all()):
        raise AssertionError(f"chain probe ({kind}): non-finite")
    ms = time_ms(torch, run, iters=5, warmup=1)
    return 1e3 * ms / CHAIN_PROBE_STEPS


def rnnt_phase(torch, g):
    """The RNN-T alpha and beta-gradient kernels against their plain
    versions on the card at the slice's shape, a long-label shape, both
    sides of the warp boundary with odd T x (U + 1) and the edges; times
    at the slice's shape (the row) and the long-label shape (a sub-row),
    each with its chain bound (dependent steps x the probe's step
    latency) beside the byte bound. The route each case took is read
    from the wrappers' route counts and must be the launch plan's: the
    slice's U + 1 = 49 takes "warp"."""
    import importlib.util

    from paddle_tpu_torch.kernels import rnnt as R

    cases = [("slice [16, 400, 49]", (16, 400, 49, (300, 400), (24, 48)),
              "warp"),
             ("long labels [8, 200, 513]", (8, 200, 513, (150, 200),
                                            (256, 512)), "block"),
             ("boundary [5, 37, 65]", (5, 37, 65, (20, 37), (32, 64)),
              "block"),
             ("edges [4, 50, 1024]", (4, 50, 1024, (40, 50), (900, 1023)),
              "block"),
             ("edges [3, 9, 7]", (3, 9, 7, (1, 9), (0, 6)), "warp")]
    timed = ("slice [16, 400, 49]", "long labels [8, 200, 513]")
    print("[rnnt] rnnt_alpha, rnnt_beta_grad  blank/emit [B, T, U + 1] f32 "
          "from joint logits over vocab 128; edges: u_len 0, t_len 1, both, "
          "U + 1 = 1024")
    step2 = chain_step_us(torch, "rnnt")
    if step2 is not None:
        print(f"  chain probe: one RNN-T step (shuffle, adds, fmaxf, two "
              f"expf, logf) {step2:.5f} us, in {CHAIN_PROBE_STEPS} "
              f"dependent steps on one warp")
    rows = None
    worst = [0.0, 0.0]
    for i, (tag, (B, T, U1, tlr, ulr), route) in enumerate(cases):
        args = rnnt_lattices(torch, B, T, U1, tlr, ulr, 5 + i,
                             edges=tag.startswith("edges"))
        before = lattice_routes(R)
        alphas, ll = R.rnnt_alpha_cuda(*args)
        p_alphas, p_ll = R.rnnt_alpha_plain(*args)
        gb, ge, betas = R.rnnt_beta_grad_cuda(*args[:2], p_alphas, *args[2:],
                                              p_ll, with_betas=True)
        p_gb, p_ge, p_betas = R.rnnt_beta_grad_plain(
            *args[:2], p_alphas, *args[2:], p_ll, with_betas=True)
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in lattice_routes(R).items()
               if v != before[k]}
        if before and ran != {f"rnnt_alpha_{route}": 1,
                              f"rnnt_beta_grad_{route}": 1}:
            raise AssertionError(f"{tag}: expected route {route}, ran {ran}")
        worst[0] = max(worst[0], check_lattice(torch, f"{tag} alphas",
                                               alphas, p_alphas),
                       check(torch, f"{tag} loss", -ll, -p_ll, 1e-4,
                             CTC_RTOL))
        worst[1] = max(worst[1], check_lattice(torch, f"{tag} betas", betas,
                                               p_betas),
                       check(torch, f"{tag} gb", gb, p_gb, RNNT_POST_ATOL),
                       check(torch, f"{tag} ge", ge, p_ge, RNNT_POST_ATOL))
        check(torch, f"{tag} bhat[0, 0] vs ll from the alphas",
              betas[:, 0, 0], ll, 1e-4, CTC_RTOL)
        twice = [R.rnnt_beta_grad_cuda(*args[:2], alphas, *args[2:], ll)
                 for _ in range(2)]
        if not (torch.equal(R.rnnt_alpha_cuda(*args)[0], alphas)
                and all(torch.equal(x, y)
                        for x, y in zip(twice[0][:2], twice[1][:2]))):
            raise AssertionError(f"{tag}: two calls gave different bits")
        print(f"  {tag}: route {route if before else 'single'}; two calls "
              f"give the same bits")
        if tag not in timed:
            continue
        tl, ul = args[2], args[3]
        steps = int((tl + ul).max())
        live = int((tl * (ul + 1)).sum())
        a_ms = time_ms(torch, lambda: R.rnnt_alpha_cuda(*args))
        b_ms = time_ms(torch, lambda: R.rnnt_beta_grad_cuda(
            *args[:2], alphas, *args[2:], ll))
        a_plain = time_ms(torch, lambda: R.rnnt_alpha_plain(*args), iters=3,
                          warmup=1)
        b_plain = time_ms(torch, lambda: R.rnnt_beta_grad_plain(
            *args[:2], alphas, *args[2:], ll), iters=3, warmup=1)
        # the live cells' inputs read once (the dead ones are never read),
        # the whole outputs written once; ~10 f32 operations a live cell
        # forward (the adds, max, two exp, a log), ~22 backward (the
        # recursion and the two posteriors)
        lat = B * T * U1 * 4
        lens = 2 * B * 4 + B * 4
        bound_a, by_a = bound_ms(2 * live * 4 + lat + lens, 10 * live,
                                 F32_FLOPS)
        bound_b, by_b = bound_ms(3 * live * 4 + 2 * lat + lens, 22 * live,
                                 F32_FLOPS)
        chain = None if step2 is None else steps * step2 / 1e3
        audio = "" if importlib.util.find_spec("torchaudio") else "not "
        chain_s = ("" if chain is None else
                   f"; chain bound {chain:.4f} ms, {steps} x {step2:.5f} us")
        print(f"  {tag}: alpha kernel {a_ms:.4f} ms, plain {a_plain:.4f}, "
              f"bound {bound_a:.4f} ({by_a}; and {steps} dependent steps, "
              f"max(t_len + u_len): {1e3 * a_ms / steps:.3f} us a step); "
              f"beta-gradient kernel {b_ms:.4f} ms, plain {b_plain:.4f}, "
              f"bound {bound_b:.4f} ({by_b}; {1e3 * b_ms / steps:.3f} us a "
              f"step){chain_s}; library: none (no PyTorch call computes "
              f"the RNN-T loss; torchaudio, a separate package with one, is "
              f"{audio}installed)")
        shape = f"blank/emit [{B}, {T}, {U1}] f32, {steps} dependent steps"
        plan = ({"alpha": R.launch_plan(U1)._asdict(),
                 "beta_grad": R.launch_plan(U1, beta=True)._asdict()}
                if hasattr(R, "launch_plan") else None)
        chain_d = {"dependent_steps": steps, "step_us": step2,
                   "chain_bound_ms": chain}
        sub = (dict(shape=shape, ms=a_ms, plain_ms=a_plain, library_ms=None,
                    bound_ms=bound_a, bound_by=by_a, route=route, plan=plan,
                    chain=chain_d),
               dict(shape=shape, ms=b_ms, plain_ms=b_plain, library_ms=None,
                    bound_ms=bound_b, bound_by=by_b, route=route, plan=plan,
                    chain=chain_d))
        if rows is None:
            rows = sub
        else:
            for r, m in zip(rows, sub):
                r["long_labels"] = m
    rows[0]["max_abs_err"], rows[1]["max_abs_err"] = worst
    return rows


def flash_d36_phase(torch, g):
    """The flash kernels at head_dim 36 (the Conformer's 144 / 4), forward
    and backward, dropout p 0.1 and 0, against the plain versions; the
    applied mask read back by the probes; times at the Conformer's
    [16, 400, 4, 36] bf16."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels.flash_attention import (
        delta_minus_glse, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_plain)

    p, seed = CONFORMER_DROPOUT, 36036
    B, S, H, D = 16, 400, 4, 36
    print(f"[kernel] flash_attention_dropout, flash_attention_bwd_dropout at "
          f"head_dim 36  [{B}, {S}, {H}, {D}] bf16, p {p} and 0")
    mask_probes(torch, D, p, seed)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .bfloat16() for _ in range(4))
    worst_f = worst_b = 0.0
    for drop in (p, 0.0):
        out, lse = flash_attention_cuda(q, k, v, False, None, drop, seed)
        p_out, p_lse = flash_attention_plain(q, k, v, False, None, drop, seed)
        torch.cuda.synchronize()
        worst_f = max(worst_f, check(torch, f"p {drop} out", out, p_out,
                                     ATTN_ATOL, BF16_RTOL))
        check(torch, f"p {drop} lse", lse, p_lse, F32_ATOL)
        dg = delta_minus_glse(p_out, do)
        got = flash_attention_bwd_cuda(q, k, v, do, p_lse, dg, False, None,
                                       drop, seed)
        want = flash_attention_bwd_plain(q, k, v, do, p_lse, dg, False, None,
                                         drop, seed)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            worst_b = max(worst_b, check_grad(torch, f"p {drop} {name}", a, b,
                                              GRAD_FRAC_BF16))
    out, lse = flash_attention_cuda(q, k, v, False, None, p, seed)
    dg = delta_minus_glse(out, do)
    before = K.launch_counts()
    fwd = time_ms(torch, lambda: flash_attention_cuda(q, k, v, False, None, p,
                                                      seed))
    design_f = ran_design(K, before)
    dense = time_ms(torch, lambda: flash_attention_cuda(q, k, v))
    fwd_plain = time_ms(torch, lambda: flash_attention_plain(
        q, k, v, False, None, p, seed), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_lib = time_ms(torch, lambda: sdpa(qt, kt, vt, dropout_p=p))
    before = K.launch_counts()
    bwd = time_ms(torch, lambda: flash_attention_bwd_cuda(
        q, k, v, do, lse, dg, False, None, p, seed))
    design_b = ran_design(K, before, "flash_attention_bwd")
    bwd_dense = time_ms(torch, lambda: flash_attention_bwd_cuda(
        q, k, v, do, lse, dg))
    bwd_plain = time_ms(torch, lambda: flash_attention_bwd_plain(
        q, k, v, do, lse, dg, False, None, p, seed), iters=3, warmup=1)
    qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    og = sdpa(qg, kg, vg, dropout_p=p)
    bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
        og, (qg, kg, vg), do.transpose(1, 2), retain_graph=True))
    del og
    # the mma kernels these widths ran before, at the same inputs
    from paddle_tpu_torch.kernels import flash_attention as F
    mma = _mma_times(torch, F, q, k, v, do, lse, dg, p, seed)
    mma_dense = _mma_times(torch, F, q, k, v, do, lse, dg)
    pairs = S * S
    # as the dropout phase counts them, at the real width 36; one
    # exponential a score, forward and backward
    bound_f = flash_bound(torch, 4 * q.numel() * 2 + B * H * S * 4,
                          4 * pairs * D * B * H, pairs * B * H)
    bound_b = flash_bound(torch, 7 * q.numel() * 2 + 2 * B * H * S * 4,
                          10 * pairs * D * B * H, pairs * B * H)
    print(f"  [{B}, {S}, {H}, {D}]: forward kernel {fwd:.4f} ms (dense "
          f"{dense:.4f}), mma kernel {mma[0]:.4f} (dense {mma_dense[0]:.4f}),"
          f" plain {fwd_plain:.4f}, SDPA(dropout) {fwd_lib:.4f}, bound "
          f"{bound_f[0]:.4f} (set by {bound_f[3]}; exponentials "
          f"{bound_f[2]:.4f}); backward kernel {bwd:.4f} ms (dense "
          f"{bwd_dense:.4f}), mma kernel {mma[1]:.4f} (dense "
          f"{mma_dense[1]:.4f}), plain {bwd_plain:.4f}, SDPA backward "
          f"{bwd_lib:.4f}, bound {bound_b[0]:.4f} (set by {bound_b[3]}; "
          f"exponentials {bound_b[2]:.4f})")
    shape = f"[{B}, {S}, {H}, {D}] bf16 p={p}"
    return (dict(shape=shape, ms=fwd, plain_ms=fwd_plain, library_ms=fwd_lib,
                 bound_ms=bound_f[0], bound_by=bound_f[1],
                 bound_exp_ms=bound_f[2], bound_set_by=bound_f[3],
                 dense_ms=dense, mma_ms=mma[0], mma_dense_ms=mma_dense[0],
                 max_abs_err=worst_f, design=design_f),
            dict(shape=shape, ms=bwd, plain_ms=bwd_plain, library_ms=bwd_lib,
                 bound_ms=bound_b[0], bound_by=bound_b[1],
                 bound_exp_ms=bound_b[2], bound_set_by=bound_b[3],
                 dense_ms=bwd_dense, mma_ms=mma[1],
                 mma_dense_ms=mma_dense[1], max_abs_err=worst_b,
                 design=design_b))


# ---------------------------------------------------------------------------
# flash slice: the flash kernels' bool mask, varlen and head widths
# ---------------------------------------------------------------------------

def _check_pair(torch, F, tag, q, k, v, do, causal=False, p=0.0, seed=11,
                mask=None, glse=None):
    """Forward and backward of the flash kernels against the plain versions
    on the given inputs (an lse cotangent ``glse`` folded in where given);
    returns the worst forward and backward errors and the lse and dg the
    timed backward takes."""
    out, lse = F.flash_attention_cuda(q, k, v, causal, None, p, seed, mask)
    p_out, p_lse = F.flash_attention_plain(q, k, v, causal, None, p, seed,
                                           mask)
    torch.cuda.synchronize()
    f32 = q.dtype == torch.float32
    ef = check(torch, f"{tag} out", out, p_out, F32_SMALL_ATOL if f32
               else ATTN_ATOL, F32_SMALL_ATOL if f32 else BF16_RTOL)
    check(torch, f"{tag} lse", lse, p_lse, F32_SMALL_ATOL if f32
          else F32_ATOL)
    dg = F.delta_minus_glse(p_out, do, glse)
    got = F.flash_attention_bwd_cuda(q, k, v, do, p_lse, dg, causal, None, p,
                                     seed, mask)
    want = F.flash_attention_bwd_plain(q, k, v, do, p_lse, dg, causal, None,
                                       p, seed, mask)
    torch.cuda.synchronize()
    eb = max(check_grad(torch, f"{tag} {n}", a, b,
                        GRAD_FRAC_F32 if f32 else GRAD_FRAC_BF16)
             for n, a, b in zip(("dq", "dk", "dv"), got, want))
    return ef, eb, lse, dg


def _flash_case(torch, g, F, tag, B, Sq, Sk, H, Hkv, D, dt, causal, p=0.0,
                mask=None, seed=11):
    """Forward and backward of the flash kernels against the plain versions
    on one small case (an lse cotangent included); returns the worst
    forward and backward errors."""
    q = torch.randn(B, Sq, H, D, device="cuda", generator=g).to(dt)
    k, v = (torch.randn(B, Sk, Hkv, D, device="cuda", generator=g).to(dt)
            for _ in range(2))
    do = torch.randn(B, Sq, H, D, device="cuda", generator=g).to(dt)
    glse = 0.1 * torch.randn(B, H, Sq, device="cuda", generator=g)
    return _check_pair(torch, F, tag, q, k, v, do, causal, p, seed, mask,
                       glse)[:2]


def _timed_pair(torch, fwd, bwd, fwd_plain, bwd_plain, fwd_lib, bwd_lib,
                plain_iters=3):
    """Device ms of kernel, plain version and library call, forward and
    backward (the library's backward is its autograd backward), then the
    flash design each kernel ran."""
    from paddle_tpu_torch import kernels as K

    before = K.launch_counts()
    t = [time_ms(torch, fwd), time_ms(torch, bwd)]
    designs = [ran_design(K, before), ran_design(K, before,
                                                 "flash_attention_bwd")]
    t += [time_ms(torch, fwd_plain, iters=plain_iters, warmup=1),
          time_ms(torch, bwd_plain, iters=plain_iters, warmup=1)]
    if fwd_lib is None:
        return t + [None, None] + designs
    return t + [time_ms(torch, fwd_lib), time_ms(torch, bwd_lib)] + designs


def _sdpa_lib(torch, q, k, v, do, **kw):
    """The one PyTorch call computing the same attention (SDPA, in its
    [B, H, S, D] layout) and its autograd backward, for timing."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    og = sdpa(qg, kg, vg, **kw)
    gt = do.transpose(1, 2)
    return (lambda: sdpa(qt, kt, vt, **kw),
            lambda: torch.autograd.grad(og, (qg, kg, vg), gt,
                                        retain_graph=True))


def _flash_timed(torch, F, tag, q, k, v, do, lse, dg, p=0.0, seed=11,
                 mask=None, pairs=None, peak=BF16_FLOPS):
    """Kernel, plain version, SDPA (the same bool mask and dropout rate)
    and bound, forward and backward, non-causal; ``pairs`` counts the
    (query, key) pairs the data needs a head (unmasked keys), all by
    default. Returns (times, bounds) as :func:`_rows` takes them."""
    B, S, H, D = q.shape
    lib_f, lib_b = _sdpa_lib(torch, q, k, v, do, attn_mask=mask,
                             dropout_p=p)
    times = _timed_pair(
        torch, lambda: F.flash_attention_cuda(q, k, v, False, None, p, seed,
                                              mask),
        lambda: F.flash_attention_bwd_cuda(q, k, v, do, lse, dg, False, None,
                                           p, seed, mask),
        lambda: F.flash_attention_plain(q, k, v, False, None, p, seed, mask),
        lambda: F.flash_attention_bwd_plain(q, k, v, do, lse, dg, False, None,
                                            p, seed, mask),
        lib_f, lib_b)
    pairs = B * S * S if pairs is None else pairs
    nb = q.numel() * q.element_size()
    mb = 0 if mask is None else B * S       # a key-padding mask's bytes
    # one exponential a score, forward and backward (the backward's P)
    bounds = (flash_bound(torch, 4 * nb + B * H * S * 4 + mb,
                          4 * pairs * H * D, pairs * H, peak),
              flash_bound(torch, 7 * nb + 2 * B * H * S * 4 + mb,
                          10 * pairs * H * D, pairs * H, peak))
    print(f"  {tag}: forward kernel {times[0]:.4f} ms, plain {times[2]:.4f}, "
          f"SDPA {times[4]:.4f}, bound {bounds[0][0]:.4f} (set by "
          f"{bounds[0][3]}; exponentials {bounds[0][2]:.4f}); backward "
          f"kernel {times[1]:.4f} ms, plain {times[3]:.4f}, SDPA backward "
          f"{times[5]:.4f}, bound {bounds[1][0]:.4f} (set by {bounds[1][3]}; "
          f"exponentials {bounds[1][2]:.4f})")
    return times, bounds


def _rows(shape, times, bounds, errs, **extra):
    """The forward and backward rows of a timed shape; bounds from
    :func:`flash_bound` add the exponentials' bound and what set it."""
    fwd, bwd = ({"shape": shape, "ms": times[i], "plain_ms": times[2 + i],
                 "library_ms": times[4 + i], "bound_ms": bounds[i][0],
                 "bound_by": bounds[i][1], "max_abs_err": errs[i],
                 "design": times[6 + i], **extra,
                 **({"bound_exp_ms": bounds[i][2],
                     "bound_set_by": bounds[i][3]} if len(bounds[i]) == 4
                    else {})}
                for i in (0, 1))
    return fwd, bwd


def _sub_rows(rows, key, more):
    """Put the forward and backward rows of ``more`` under ``key`` of
    ``rows``' (their errors fold into the main rows')."""
    for r, m in zip(rows, more):
        r[key] = {n: m[n] for n in ("shape", "ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "bound_exp_ms",
                                    "bound_set_by", "mma_ms", "source",
                                    "design")
                  if n in m}
        r["max_abs_err"] = max(r["max_abs_err"], m["max_abs_err"])


def flash_mask_phase(torch, g):
    """The flash kernels with a bool mask. First at the inputs the
    [encoder mask] path gives them: [16, 512, 12, 64] bf16, attention
    dropout 0.1, not causal, that path's own key-padding mask [16, 1, 1,
    512] (its batch's seed); then tools/attn_bench.py's bench_masked(2048)
    shape with its key-padding mask; each forward and backward against the
    plain versions and timed against SDPA with the same bool mask (and
    dropout rate). Then one small case for each mask mode and a per-query
    mask with a fully masked row, causal with dropout and not, with and
    without dropout, bf16 and f32."""
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as F

    B, S, H, D = ENCODER_ATTN
    _, mask, _, lens = encoder_main_batch(torch, "cuda")
    p, seed = ERNIE_DROPOUT, 20241
    print(f"[flash mask] flash_attention_mask, flash_attention_bwd_mask  "
          f"[{B}, {S}, {H}, {D}] bf16, p {p}, not causal, the encoder "
          f"path's key-padding mask [{B}, 1, 1, {S}], lengths "
          f"{lens.tolist()}")
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .bfloat16() for _ in range(4))
    ef, eb, lse, dg = _check_pair(torch, F, "encoder", q, k, v, do, False, p,
                                  seed, mask)
    times, bounds = _flash_timed(torch, F, f"[{B}, {S}, {H}, {D}] masked, "
                                 f"p {p}", q, k, v, do, lse, dg, p, seed,
                                 mask, S * int(lens.sum()))
    rows = _rows(f"[{B}, {S}, {H}, {D}] bf16 p={p}, key-padding mask "
                 f"[{B}, 1, 1, {S}] (the encoder path's)", times, bounds,
                 (ef, eb))
    del q, k, v, do, lse, dg, mask

    B, S, H, D = MASK_SHAPE
    lens = np.random.RandomState(0).randint(S // 2, S, size=B)
    print(f"  bench_masked(2048): [{B}, {S}, {H}, {D}] bf16, key-padding "
          f"bool mask [{B}, 1, 1, {S}], lengths {lens.tolist()}")
    mask = (torch.arange(S, device="cuda")[None, :]
            < torch.tensor(lens, device="cuda")[:, None])[:, None, None, :]
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .bfloat16() for _ in range(4))
    ef, eb, lse, dg = _check_pair(torch, F, "bench_masked", q, k, v, do,
                                  mask=mask)
    times, bounds = _flash_timed(torch, F, f"[{B}, {S}, {H}, {D}] masked", q,
                                 k, v, do, lse, dg, mask=mask,
                                 pairs=S * int(lens.sum()))
    _sub_rows(rows, "bench_masked", _rows(
        f"[{B}, {S}, {H}, {D}] bf16, key-padding mask", times, bounds,
        (ef, eb)))
    del q, k, v, do, lse, dg, mask
    b_, s_, h_ = 2, 130, 4
    for dt in (torch.bfloat16, torch.float32):
        for shape in ((1, 1, 1, s_), (b_, 1, 1, s_), (1, h_, s_, s_),
                      (b_, h_, s_, s_), (b_, 1, s_, s_)):
            for causal, p in ((False, 0.0), (False, 0.1), (True, 0.1)):
                m = torch.rand(*shape, device="cuda", generator=g) > 0.3
                if shape == (b_, 1, s_, s_):
                    m[0, 0, 5] = False       # a row with every key masked
                ef, eb = _flash_case(
                    torch, g, F, f"{dt} mask {list(shape)} causal={causal} "
                    f"p={p}", b_, s_, s_, h_, 2, 64, dt, causal, p, m)
                if dt == torch.bfloat16:
                    for r, e in zip(rows, (ef, eb)):
                        r["max_abs_err"] = max(r["max_abs_err"], e)
    return rows


def varlen_cu(T, nseq, seed=0):
    """tools/attn_bench.py bench_varlen's cuts: nseq documents packed into
    T tokens, the cuts drawn from a seeded numpy generator."""
    import numpy as np

    rng = np.random.RandomState(seed)
    cuts = np.sort(rng.choice(np.arange(1, T), nseq - 1, replace=False))
    return np.concatenate([[0], cuts, [T]]).astype(np.int32)


def _varlen_lib(torch, q, k, v, do, cu, want):
    """The one PyTorch call computing causal attention over packed
    sequences: SDPA over jagged nested tensors (offsets ``cu``), and its
    autograd backward, for timing. Returns the two calls and a note, or
    None, None and the reason where this torch does not take them; its
    output is held against the plain version's ``want`` (a wrong function
    is not a library time)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    offs = cu.long()

    def nest(t):
        return torch.nested.nested_tensor_from_jagged(
            t, offs).transpose(1, 2)

    try:
        qn, kn, vn = (nest(t) for t in (q, k, v))
        out = sdpa(qn, kn, vn, is_causal=True).transpose(1, 2).values()
        torch.cuda.synchronize()
    except (RuntimeError, ValueError, NotImplementedError) as e:
        reason = f"none: SDPA over jagged nested tensors refused ({e})"
        return None, None, reason.splitlines()[0][:200]
    err = (out.float() - want.float()).abs().max().item()
    if not err <= ATTN_ATOL + BF16_RTOL * want.float().abs().max().item():
        return None, None, (f"none: SDPA over jagged nested tensors "
                            f"computes another function (max |diff| "
                            f"{err:.3e} from the plain version)")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    og = sdpa(*(nest(t) for t in leaves),
              is_causal=True).transpose(1, 2).values()
    return (lambda: sdpa(qn, kn, vn, is_causal=True),
            lambda: torch.autograd.grad(og, leaves, do, retain_graph=True),
            f"SDPA over jagged nested tensors, is_causal (max |diff| "
            f"{err:.3e} from the plain version)")


def flash_varlen_phase(torch, g, K):
    """The flash kernels on packed sequences: bench_varlen(8192, 16) at
    Llama-2-7B's attention width (32 heads of 128), causal, bf16, forward
    and backward against the plain versions (computed a head at a time);
    a small non-causal case with cu_q != cu_k, GQA, dropout and a tail
    past cu[-1]; times against SDPA over jagged nested tensors (where the
    card's torch takes them); then the main path: F.flash_attn_unpadded forward
    and backward through autograd, its launches counted."""
    from paddle_tpu_torch.kernels import flash_attention as F
    from paddle_tpu_torch.nn import functional as NF

    T, NSEQ, H, D = VARLEN_SHAPE
    cu_np = varlen_cu(T, NSEQ)
    lens = (cu_np[1:] - cu_np[:-1]).tolist()
    print(f"[flash varlen] flash_attention_varlen, flash_attention_bwd_varlen"
          f"  T {T} packed from {NSEQ} documents (lengths {lens}), "
          f"H = Hkv = {H}, D {D}, bf16, causal")
    cu = torch.tensor(cu_np, device="cuda")
    hosts = (cu_np.tolist(), cu_np.tolist())
    q, k, v, do = (torch.randn(T, H, D, device="cuda", generator=g)
                   .bfloat16() for _ in range(4))
    out, lse = F.flash_attn_varlen_cuda(q, k, v, cu, cu, True,
                                        cu_host=hosts)
    p_out, p_lse = F.flash_attn_varlen_plain(q, k, v, cu, cu, True,
                                             cu_host=hosts)
    torch.cuda.synchronize()
    worst_f = check(torch, "main out", out, p_out, ATTN_ATOL, BF16_RTOL)
    check(torch, "main lse", lse, p_lse, F32_ATOL)
    dg = F.delta_minus_glse(p_out, do)
    got = F.flash_attn_varlen_bwd_cuda(q, k, v, do, p_lse, dg, cu, cu, True,
                                       cu_host=hosts)
    want = F.flash_attn_varlen_bwd_plain(q, k, v, do, p_lse, dg, cu, cu,
                                         True, cu_host=hosts)
    torch.cuda.synchronize()
    worst_b = max(check_grad(torch, f"main {n}", a, b, GRAD_FRAC_BF16)
                  for n, a, b in zip(("dq", "dk", "dv"), got, want))
    del got, want
    # cu_q != cu_k (non-causal), an empty key part, tails past cu[-1], GQA
    cq = torch.tensor([0, 50, 61, 130, 200], device="cuda", dtype=torch.int32)
    ck = torch.tensor([0, 7, 90, 90, 150], device="cuda", dtype=torch.int32)
    for dt in (torch.bfloat16, torch.float32):
        for p in (0.0, 0.1):
            qs = torch.randn(210, 8, 64, device="cuda", generator=g).to(dt)
            ks, vs = (torch.randn(160, 2, 64, device="cuda", generator=g)
                      .to(dt) for _ in range(2))
            dos = torch.randn(210, 8, 64, device="cuda", generator=g).to(dt)
            f32 = dt == torch.float32
            tag = f"{dt} cu_q != cu_k, tails, GQA 8/2, p {p}"
            o, l_ = F.flash_attn_varlen_cuda(qs, ks, vs, cq, ck, False, None,
                                             p, 5)
            po, pl = F.flash_attn_varlen_plain(qs, ks, vs, cq, ck, False,
                                               None, p, 5)
            torch.cuda.synchronize()
            ef = check(torch, f"{tag} out", o, po, F32_SMALL_ATOL if f32
                       else ATTN_ATOL, F32_SMALL_ATOL if f32 else BF16_RTOL)
            check(torch, f"{tag} lse", l_, pl, F32_SMALL_ATOL if f32
                  else F32_ATOL)
            gs = F.flash_attn_varlen_bwd_cuda(
                qs, ks, vs, dos, pl, F.delta_minus_glse(po, dos), cq, ck,
                False, None, p, 5)
            ws = F.flash_attn_varlen_bwd_plain(
                qs, ks, vs, dos, pl, F.delta_minus_glse(po, dos), cq, ck,
                False, None, p, 5)
            torch.cuda.synchronize()
            eb = max(check_grad(torch, f"{tag} {n}", a, b,
                                GRAD_FRAC_F32 if f32 else GRAD_FRAC_BF16)
                     for n, a, b in zip(("dq", "dk", "dv"), gs, ws))
            if not f32:
                worst_f, worst_b = max(worst_f, ef), max(worst_b, eb)
    lib_f, lib_b, lib_note = _varlen_lib(torch, q, k, v, do, cu, p_out)
    del p_out
    times = _timed_pair(
        torch, lambda: F.flash_attn_varlen_cuda(q, k, v, cu, cu, True,
                                                cu_host=hosts),
        lambda: F.flash_attn_varlen_bwd_cuda(q, k, v, do, lse, dg, cu, cu,
                                             True, cu_host=hosts),
        lambda: F.flash_attn_varlen_plain(q, k, v, cu, cu, True,
                                          cu_host=hosts),
        lambda: F.flash_attn_varlen_bwd_plain(q, k, v, do, lse, dg, cu, cu,
                                              True, cu_host=hosts),
        lib_f, lib_b, plain_iters=2)
    del lib_f, lib_b
    half = sum(n * n for n in lens) / 2   # causal (query, key) pairs
    nb = q.numel() * 2
    bounds = (bound_ms(4 * nb + H * T * 4, 4 * D * H * half),
              bound_ms(7 * nb + 2 * H * T * 4, 10 * D * H * half))
    lib = [("none" if t is None else f"{t:.4f}") for t in times[4:6]]
    print(f"  T {T}, {NSEQ} documents: forward kernel {times[0]:.4f} ms, "
          f"plain {times[2]:.4f}, library {lib[0]}, bound "
          f"{bounds[0][0]:.4f} ({bounds[0][1]}); backward kernel "
          f"{times[1]:.4f} ms, plain {times[3]:.4f}, library backward "
          f"{lib[1]}, bound {bounds[1][0]:.4f} ({bounds[1][1]}); library: "
          f"{lib_note}")
    # the main path: the public entry, forward and backward, counted
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    K.reset_launch_counts()
    o, none = NF.flash_attn_unpadded(*leaves, cu, cu, causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    launched = K.launch_counts()
    if none is not None or not all(
            torch.isfinite(t.grad.float()).all() for t in leaves):
        raise AssertionError("F.flash_attn_unpadded: bad output or gradient")
    print(f"  F.flash_attn_unpadded forward + backward: launches "
          f"{ {n: c for n, c in launched.items() if c} }")
    rows = _rows(f"T {T}, {NSEQ} documents, H {H}, D {D} bf16 causal",
                 times, bounds, (worst_f, worst_b), library=lib_note)
    return rows, launched


def sweep_design(bf16, d, H, Hkv):
    """The design the routing rule gives a launch on fresh (16-byte based)
    tensors: sm90 for bf16 whose head rows are 16-byte (d % 8 == 0) or
    8-byte inside 16-byte token rows of one KV head a query head (d % 8 ==
    4 up to 44, H d a multiple of 8, H == Hkv), else mma."""
    rows = d % 8 == 0 or (d % 8 == 4 and d <= 44 and H * d % 8 == 0
                          and H == Hkv)
    return "sm90" if bf16 and rows else "mma"


def flash_head_dim_phase(torch, g):
    """Every head width class: each multiple of 8 from 8 to 256, the odd
    widths 7 and 33, the 4-byte-chunk widths 6 and 34 and the 8-byte rows
    of 36 (4 KV heads: sm90) and 44 (GQA: mma), f32 and bf16, forward and
    backward against the plain versions (causal on alternate widths, dropout on the odd ones), each
    launch on the design the routing rule gives (sweep_design). Then the
    kernel the head_dim-16 model step launches, at that step's inputs (f32
    [4, 128, 4, 16], dropout 0.1), and the bf16 kernels at [16, 512, H, D],
    H = 768 / D rounded, for D 16, 96 and 256: each against the plain
    versions, timed against SDPA and against the mma kernels they
    replaced."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import flash_attention as F

    widths = [6, 7, 33, 34, 36, 44] + list(range(8, 257, 8))
    print(f"[flash head_dim] the flash kernels at head_dim {widths}, f32 and "
          f"bf16, [2, 70, 4 (Hkv 2; 4 at D 36), D]")
    worst = [0.0, 0.0]
    ran = {"sm90": [], "mma": []}
    for dt in (torch.bfloat16, torch.float32):
        for d in widths:
            before = K.launch_counts()
            hkv = 4 if d == 36 else 2    # the Conformer's 4 heads of 36
            ef, eb = _flash_case(torch, g, F, f"{dt} D={d}", 2, 70, 70, 4,
                                 hkv, d, dt, d % 16 == 8,
                                 0.1 if d % 2 else 0.0)
            want = sweep_design(dt == torch.bfloat16, d, 4, hkv)
            got = (ran_design(K, before),
                   ran_design(K, before, "flash_attention_bwd"))
            if got != (want, want):
                raise AssertionError(f"{dt} head_dim {d}: ran {got}, the "
                                     f"rule gives {want}")
            ran[want].append(f"{'bf16' if dt == torch.bfloat16 else 'f32'}"
                             f" {d}")
            worst = [max(worst[0], ef), max(worst[1], eb)]
    print(f"  designs as the rule gives: sm90 at {ran['sm90']}; mma at "
          f"{ran['mma']}")
    B, S, H, d = D16_ATTN
    p, seed = ERNIE_DROPOUT, 20242
    q, k, v, do = (torch.randn(B, S, H, d, device="cuda", generator=g)
                   for _ in range(4))
    ef, eb, lse, dg = _check_pair(torch, F, f"ernie_tiny [{B}, {S}, {H}, "
                                  f"{d}] f32 p {p}", q, k, v, do, p=p,
                                  seed=seed)
    times, bounds = _flash_timed(torch, F, f"[{B}, {S}, {H}, {d}] f32 p {p}",
                                 q, k, v, do, lse, dg, p, seed,
                                 peak=F32_FLOPS)
    rows = _rows(f"[{B}, {S}, {H}, {d}] f32 p={p} (ernie_tiny's attention)",
                 times, bounds, (max(ef, worst[0]), max(eb, worst[1])))
    for d in (16, 96, 256):
        B, S, H = 16, 512, round(768 / d)
        q, k, v, do = (torch.randn(B, S, H, d, device="cuda", generator=g)
                       .bfloat16() for _ in range(4))
        ef, eb, lse, dg = _check_pair(torch, F, f"[{B}, {S}, {H}, {d}] bf16",
                                      q, k, v, do)
        times, bounds = _flash_timed(torch, F, f"[{B}, {S}, {H}, {d}] bf16",
                                     q, k, v, do, lse, dg)
        mma = _mma_times(torch, F, q, k, v, do, lse, dg)
        print(f"  [{B}, {S}, {H}, {d}] bf16: the mma kernels forward "
              f"{mma[0]:.4f} ms, backward {mma[1]:.4f} (sm90 {times[0]:.4f}"
              f" / {times[1]:.4f})")
        sub = _rows(f"[{B}, {S}, {H}, {d}] bf16", times, bounds, (ef, eb))
        for r, t, lib in zip(sub, mma, ("", "_bwd")):
            r["mma_ms"] = t
            r["source"] = (f"paddle_tpu_torch/csrc/"
                           f"{F._sm90_lib(d, bool(lib))}.cu")
        _sub_rows(rows, f"bf16_d{d}", sub)
        del q, k, v, do, lse, dg
    return rows


def head_dim16_model_step(torch, K):
    """The repo's ernie_tiny() (hidden 64, 4 heads of 16) attending on the
    card: one f32 MLM forward and backward with attention dropout 0.1 (the
    same host-drawn seeds on both sides) against the same weights on the
    CPU through the plain versions; returns the card's launches."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import ErnieForMaskedLM, ernie_tiny
    from paddle_tpu_torch.nn import functional as NF

    cfg = ernie_tiny()
    cfg.attention_probs_dropout_prob = 0.1
    V = cfg.vocab_size
    print(f"[head_dim 16 model] ErnieForMaskedLM(ernie_tiny()) (hidden 64, 4 "
          f"heads of 16, vocab {V}), f32, attention dropout 0.1, batch "
          f"4 x 128: the card against the CPU")
    card = ErnieForMaskedLM(cfg, seed=2)
    cpu = ErnieForMaskedLM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    B, S = D16_ATTN[:2]
    x, y = ernie_batch(torch, B, S, V, 4, "cpu")
    losses, grads, launched = [], [], None
    for model in (card, cpu):
        dev = model.ernie.device
        framework.seed(9)
        K.reset_launch_counts()
        loss = mlm_loss(NF, model, x.to(dev), y.to(dev))
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launched = K.launch_counts()
        losses.append(loss.item())
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
    # the key biases' exact gradient is 0 (see whole_step_ernie): skipped
    rel = max(((grads[0][n] - gr).norm() / gr.norm()).item()
              for n, gr in grads[1].items()
              if not n.endswith("self_attn.k_proj.bias") and gr.norm() > 0)
    print(f"  loss {losses[0]:.6f} on the card, {losses[1]:.6f} on the CPU; "
          f"worst gradient relative L2 {rel:.2e}; launches "
          f"{ {k: v for k, v in launched.items() if v} }")
    if not abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]) + 1e-5:
        raise AssertionError(f"head_dim-16 step: loss {losses}")
    if not rel <= D16_GRAD_REL_L2:
        raise AssertionError(f"head_dim-16 step: gradient off by {rel}")
    if not (launched["flash_attention_dropout"]
            and launched["flash_attention_bwd_dropout"]):
        raise AssertionError("head_dim-16 step: flash kernels not launched")
    return launched


def encoder_model(torch, d_model, nhead, layers, vocab, device, dropout,
                  attn_dropout, seed):
    """``nn.TransformerEncoder`` of post-norm layers with a linear head to
    ``vocab``, weights from a seeded generator."""
    from paddle_tpu_torch.nn import TransformerEncoder, TransformerEncoderLayer

    torch.manual_seed(seed)
    enc = TransformerEncoder(TransformerEncoderLayer(
        d_model, nhead, 4 * d_model, dropout=dropout,
        attn_dropout=attn_dropout, device=device), layers)
    head = torch.nn.Linear(d_model, vocab, device=device)
    return torch.nn.ModuleDict({"encoder": enc, "head": head})


def encoder_batch(torch, B, S, d_model, vocab, lo, seed, device):
    """Seeded inputs [B, S, d_model], a bool key-padding mask [B, 1, 1, S]
    of lengths lo..S, and token targets with -100 on the padding."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(lo, S + 1, (B,), generator=g)
    keep = torch.arange(S)[None, :] < lens[:, None]
    x = torch.randn(B, S, d_model, generator=g)
    y = torch.where(keep, torch.randint(0, vocab, (B, S), generator=g), -100)
    return x.to(device), keep[:, None, None, :].to(device), y.to(device), lens


def encoder_main_batch(torch, device):
    """[encoder mask]'s batch: ERNIE-3.0-Base's hidden 768 and vocab 40000,
    lengths 256-512, seed 1."""
    B, S, H, D = ENCODER_ATTN
    return encoder_batch(torch, B, S, H * D, 40000, 256, 1, device)


def encoder_loss(torch, F, model, x, mask, y):
    logits = model["head"](model["encoder"](x, mask))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))


def whole_step_encoder_mask(torch, K):
    """One training step of nn.TransformerEncoder with a bool key-padding
    mask under O1 on the card against f32 on the CPU through the plain
    versions, same weights and attention-dropout seeds (hidden dropout 0:
    its masks come from each device's own generator)."""
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.nn import functional as F

    print("[whole step encoder mask] TransformerEncoder hidden 256, 4 heads "
          "of 64, 2 layers, ffn 1024, attention dropout 0.1, vocab 40000, "
          "batch 2 x 512 with a key-padding mask: O1 bf16 on the card vs f32 "
          "on the CPU")
    card = encoder_model(torch, 256, 4, 2, 40000, "cuda", 0.0, ERNIE_DROPOUT,
                         7)
    cpu = encoder_model(torch, 256, 4, 2, 40000, "cpu", 0.0, ERNIE_DROPOUT, 7)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x, mask, y, lens = encoder_batch(torch, 2, 512, 256, 40000, 256, 3, "cpu")
    print(f"  lengths {lens.tolist()}")
    losses, grads, launched = [], [], None
    for model in (card, cpu):
        dev = next(model.parameters()).device
        framework.seed(5)
        K.reset_launch_counts()
        with amp.auto_cast(enable=dev.type == "cuda", level="O1"):
            loss = encoder_loss(torch, F, model, x.to(dev), mask.to(dev),
                                y.to(dev))
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launched = K.launch_counts()
        losses.append(loss.item())
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
    want = {"flash_attention_mask": 2, "flash_attention_bwd_mask": 2,
            "flash_attention_sm90": 2, "flash_attention_bwd_sm90": 2,
            "layernorm": 4, "softmax_ce": 1, "softmax_ce_bwd": 1}
    if {k: v for k, v in launched.items() if v} != want:
        raise AssertionError(f"whole encoder step launched {launched}, "
                             f"expected {want}")
    # the key bias cancels in the softmax (see whole_step_ernie)
    for n in [n for n in grads[1] if n.endswith("self_attn.k_proj.bias")]:
        w = n.replace("bias", "weight")
        ratio = [gr.pop(n).norm().item() / gr[w].norm().item()
                 for gr in grads]
        if not max(ratio) <= 1e-2:
            raise AssertionError(f"whole encoder step: {n}'s gradient, 0 "
                                 f"in exact arithmetic, is {ratio} of the "
                                 f"key weight gradient's norm")
    rel = {n: ((grads[0][n] - gr).norm() / gr.norm()).item()
           for n, gr in grads[1].items()}
    worst = sorted(rel.items(), key=lambda r: -r[1])[:3]
    print(f"  loss {losses[0]:.5f} on the card, {losses[1]:.5f} on the CPU "
          f"(|diff| {abs(losses[0] - losses[1]):.2e}, limit "
          f"{STEP_LOSS_TOL}); worst gradient relative L2 errors "
          + ", ".join(f"{n} {e:.2e}" for n, e in worst)
          + f" (limit {STEP_GRAD_REL_L2}, {len(rel)} parameters); launches "
          f"{want}")
    if not abs(losses[0] - losses[1]) <= STEP_LOSS_TOL:
        raise AssertionError(f"whole encoder step: loss {losses}")
    if not worst[0][1] <= STEP_GRAD_REL_L2:
        raise AssertionError(f"whole encoder step: gradient of "
                             f"{worst[0][0]} off by {worst[0][1]}")


def encoder_flops_per_token(L, h, ffn, vocab, S):
    """Training flops a token: 6 x the token-wise matmuls' parameters (four
    attention projections and two FFN matrices a layer, the head) + 12 S h
    per layer for the score and P.V products, forward and backward."""
    return 6 * (L * (4 * h * h + 2 * h * ffn) + h * vocab) + 12 * S * h * L


def encoder_mask_phase(torch, K):
    """The slice's full-width training path: nn.TransformerEncoder at
    ERNIE-3.0-Base's published widths with a bool key-padding mask."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    (B, S, nh, hd), L, V = ENCODER_ATTN, 12, 40000
    h = nh * hd
    print(f"[encoder mask] TransformerEncoder at ERNIE-3.0-Base widths ({L} "
          f"layers, hidden {h}, {nh} heads of {h // nh}, ffn {4 * h}, dropout "
          f"0.1), linear head to {V} with cross_entropy, batch {B} x {S} "
          f"with a bool key-padding mask [{B}, 1, 1, {S}], lengths 256-512, "
          f"f32 params under auto_cast(O1, bf16), AdamW lr 1e-4")
    framework.seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = encoder_model(torch, h, nh, L, V, "cuda", 0.1, 0.1, 0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    x, mask, y, lens = encoder_main_batch(torch, "cuda")
    real = int(lens.sum())
    print(f"  {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"parameters; {real} real tokens of {B * S}")

    def step():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = encoder_loss(torch, F, model, x, mask, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    t0 = time.monotonic()
    losses = [step().item()]
    print(f"  warm-up step {time.monotonic() - t0:.2f}s, loss "
          f"{losses[0]:.4f}")
    K.reset_launch_counts()
    walls = []
    for _ in range(ENCODER_STEPS):
        t0 = time.monotonic()
        losses.append(step().item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {[round(v, 4) for v in losses]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite encoder loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the encoder loss did not fall: {losses}")
    per_step = {k: c / ENCODER_STEPS for k, c in counts.items() if c}
    print(f"  launches per step: {per_step} (expected {ENCODER_PER_STEP})")
    if per_step != {k: float(v) for k, v in ENCODER_PER_STEP.items()}:
        raise AssertionError("the encoder steps launched other kernels than "
                             "the model's structure gives")
    all_sm90("the encoder steps", counts)
    mean = sum(walls) / len(walls)
    tok_s = real / mean
    flops = encoder_flops_per_token(L, h, 4 * h, V, S)
    print(f"  step wall {mean * 1e3:.1f} ms (mean of {ENCODER_STEPS}, min "
          f"{min(walls) * 1e3:.1f}); {tok_s:.0f} real tokens/s; MFU "
          f"{100 * tok_s * flops / BF16_FLOPS:.1f}% ({flops / 1e9:.3f} "
          f"GFLOP a real token against {BF16_FLOPS / 1e12:.0f} TFLOP/s); "
          f"peak memory {peak / 2 ** 30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiled encoder step traced no kernel")
    busy = busy_ms(kernels)
    print(f"[profile] one encoder step: device busy {busy:.2f} ms in "
          f"{len(kernels)} kernels, wall {prof_wall:.2f} ms under the "
          f"profiler (unprofiled mean {mean * 1e3:.2f} ms), idle "
          f"{100 * (1 - busy / prof_wall):.1f}% of the profiled wall, "
          f"{100 * (1 - busy / (mean * 1e3)):.1f}% of the unprofiled mean")
    for group, ms in kernel_share(kernels).items():
        print(f"  {ms:9.3f} ms  {group}")
    del model, opt
    return counts


def serving_phase(torch, K):
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams

    print("[serving] Llama-2-7B (32 layers, hidden 4096), bf16, random "
          "weights from seed 0")
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LlamaForCausalLM(llama_7b(), dtype=torch.bfloat16, generator=gen)
    model.eval()
    torch.cuda.synchronize()
    print(f"  model built in {time.monotonic() - t0:.1f}s, "
          f"{model.num_params() / 1e9:.2f}B params, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB")
    eng = LLMEngine(model, max_slots=4, max_model_len=1024, block_size=16)
    print(f"  pool {tuple(eng.cache.pool.shape)}, "
          f"{eng.cache.pool.numel() * 2 / 2 ** 30:.2f} GiB")
    rng = torch.Generator().manual_seed(1)

    def toks(n):
        return torch.randint(0, 32000, (n,), generator=rng).tolist()

    shared = toks(256)
    prompts = [shared + toks(40), toks(700), toks(17), toks(64),
               shared + toks(100), toks(500)]
    greedy = SamplingParams(max_new_tokens=16)
    sampled = SamplingParams(max_new_tokens=16, temperature=0.8, top_p=0.9,
                             seed=7)
    reqs = [eng.add_request(p, greedy) for p in prompts]
    reqs.append(eng.add_request(toks(123), sampled))
    telemetry.flight().clear()
    telemetry.tracer().clear()
    K.reset_launch_counts()
    t0 = time.monotonic()
    eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    engine_launches = K.launch_counts()
    t0 = time.monotonic()
    st = eng.stats()           # counts the roofline's pending signatures
    serving_telemetry_checks(torch, K, eng, reqs, st,
                             time.monotonic() - t0)
    for r in reqs:
        if r.state.value != "finished" or len(r.output_tokens) != 16:
            raise AssertionError(f"request {r.rid}: {r.state} {r.error!r}")
    if st["prefix_cache"]["hits"] < 1:
        raise AssertionError("the shared prefix never hit the prefix cache")

    # teacher forcing through the no-cache forward (the greedy requests)
    K.reset_launch_counts()
    worst, exact, total = teacher_forced(
        torch, model, dict(enumerate(reqs[:len(prompts)])),
        dict(enumerate(prompts)))
    torch.cuda.synchronize()
    forward_launches = K.launch_counts()
    ttft = [r.ttft for r in reqs]
    print(f"  7 requests x 16 tokens in {wall:.2f}s; "
          f"preemptions {st['num_preemptions']}; prefix cache "
          f"hits {st['prefix_cache']['hits']} "
          f"tokens saved {st['prefix_cache']['tokens_saved']}")
    print(f"  TTFT mean {sum(ttft) / len(ttft) * 1e3:.1f} ms "
          f"(max {max(ttft) * 1e3:.1f} ms, queueing included); decode "
          f"{eng.decode_tokens / eng.decode_s:.1f} tokens/s over "
          f"{eng.decode_tokens} tokens; overall "
          f"{st['tokens_per_sec']:.1f} tokens/s")
    print(f"  teacher forcing: worst gap to the row max {worst:.4f} "
          f"(limit {TF_TOL}); {exact} of {total} served greedy tokens "
          f"are the argmax (need {TF_MIN_EXACT:.0%})")
    # each path must have gone through every kernel it calls
    for path, counts, needed in (
            ("LLMEngine.run", engine_launches, ("paged_attention", "rmsnorm")),
            ("no-cache forward", forward_launches,
             ("flash_attention", "rmsnorm"))):
        print(f"  launches on {path}: {counts}")
        missing = [k for k in needed if counts[k] == 0]
        if missing:
            raise AssertionError(f"{path} never launched {missing}")
    launches = {k: engine_launches[k] + forward_launches[k]
                for k in engine_launches}
    return model, launches


def drive_workload(torch, eng, wl, deadlines=None):
    """Serve the workload ``wl`` on ``eng`` from one thread: each request
    is added once the host clock passes its arrival time (between engine
    steps); ``deadlines`` maps request indices to (``deadline_s``,
    ``max_new_tokens``). Returns the request handles by index."""
    from paddle_tpu_torch.serving import SamplingParams

    deadlines = deadlines or {}
    reqs, todo = {}, sorted(wl, key=lambda w: w.at_s)
    t0 = time.monotonic()
    while todo or eng.scheduler.has_work():
        now = time.monotonic() - t0
        while todo and todo[0].at_s <= now:
            w = todo.pop(0)
            deadline, n = deadlines.get(w.index, (None, w.max_new_tokens))
            reqs[w.index] = eng.add_request(
                list(w.prompt), SamplingParams(max_new_tokens=n),
                tenant=w.tenant, deadline_s=deadline)
        if eng.scheduler.has_work():
            eng.step()
        elif todo:
            time.sleep(max(0.0, todo[0].at_s - (time.monotonic() - t0)))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return reqs


def teacher_forced(torch, model, reqs, prompts):
    """Each request's served greedy tokens against the no-cache forward
    (flash attention) over prompt + tokens: the worst gap of a served
    token's logit to its row's max, and how many are that row's argmax.
    Raises past TF_TOL / below TF_MIN_EXACT."""
    worst, exact, total = 0.0, 0, 0
    with torch.inference_mode():
        for i, r in reqs.items():
            p = prompts[i]
            ids = torch.tensor([p + r.output_tokens], device=model.device)
            logits = model(ids)[0].float()
            if not torch.isfinite(logits).all():
                raise AssertionError(f"request {i}: non-finite logits")
            rows = logits[len(p) - 1:len(p) - 1 + len(r.output_tokens)]
            served = torch.tensor(r.output_tokens, device=model.device)
            chosen = rows.gather(1, served[:, None])[:, 0]
            gap = (rows.max(1).values - chosen).max().item()
            worst = max(worst, gap)
            exact += (rows.argmax(1) == served).sum().item()
            total += len(r.output_tokens)
            if gap > TF_TOL:
                raise AssertionError(
                    f"request {i}: a generated token's logit is {gap} below "
                    f"its row's max (limit {TF_TOL})")
    if exact < TF_MIN_EXACT * total:
        raise AssertionError(f"only {exact} of {total} served greedy tokens "
                             f"are the teacher-forced argmax (need "
                             f"{TF_MIN_EXACT:.0%})")
    return worst, exact, total


def first_divergence(torch, model, prompt, a, b):
    """Where the greedy streams ``a`` and ``b`` of ``prompt`` part: the
    index, and each side's token's logit gap to the row max of the no-cache
    forward over prompt + their common tokens (both within TF_TOL: a bf16
    near-tie of that row, which the two engines' different prefill splits
    may break either way)."""
    d = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    with torch.inference_mode():
        ids = torch.tensor([prompt + a[:d]], device=model.device)
        row = model(ids)[0, -1].float()
    top = row.max()
    return d, (top - row[a[d]]).item(), (top - row[b[d]]).item()


def spill_copy_probe(torch, eng, n=10):
    """Host ms of one block's spill copy (the device pool's block to a
    contiguous host array, as ``PagedKVCache._spill_block`` does) and of
    one CRC32 pass over it: medians of ``n``."""
    import zlib

    pool = eng.cache.pool
    copy_ms, crc_ms = [], []
    for i in range(n):
        if pool.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv = pool[:, 1 + i % (pool.shape[1] - 1)].view(torch.int16).to(
            "cpu", copy=True, memory_format=torch.contiguous_format).numpy()
        t1 = time.perf_counter()
        zlib.crc32(kv)
        t2 = time.perf_counter()
        copy_ms.append((t1 - t0) * 1e3)
        crc_ms.append((t2 - t1) * 1e3)
    return sorted(copy_ms)[n // 2], sorted(crc_ms)[n // 2], kv.nbytes


def serving_tenancy_phase(torch, K, model):
    """[serving tenancy]: the TENANCY_SPEC workload (the port's
    ``serving.workload.generate``) on the [serving] model through an engine
    with tenancy, the host spill tier, the KV watermarks and two missed
    deadlines (TENANCY_ENGINE, TENANCY_DEADLINES). Every other request
    finishes its 16 tokens; the deadline requests end CANCELLED with
    ``DeadlineExceeded`` (the queued one never prefilled); the cache
    spilled and promoted, the bronze quota evicted, the pressure latch set
    and cleared; per-tenant flops sum to the engine's own step total; the
    served tokens pass [serving]'s teacher-forcing limits; paged attention
    and RMSNorm launched. Then the same workload on an engine with spill,
    quotas and tenancy off and a pool that holds everything, and a rerun
    of the first engine under ``serving.kv.promote:corrupt@1x*``: their
    streams against the first engine's, equal or parting first at a bf16
    near-tie of the teacher-forced row (both tokens within TF_TOL of its
    max: another prefix hit length is another prefill split, whose bf16
    rounding may break such a tie the other way). Returns the launches of
    the first engine's run and of its teacher-forced check."""
    from paddle_tpu_torch.serving import DeadlineExceeded, LLMEngine
    from paddle_tpu_torch.serving.workload import WorkloadSpec, generate
    from paddle_tpu_torch.utils import faults

    t_phase = time.monotonic()
    wl = generate(WorkloadSpec(**TENANCY_SPEC), max_model_len=1024)
    prompts = {w.index: list(w.prompt) for w in wl}
    lens = sorted(len(p) for p in prompts.values())
    print(f"[serving tenancy] {len(wl)} requests of the workload engine's "
          f"tenant-mix shape (Poisson {TENANCY_SPEC['arrival']['rate_qps']} "
          f"qps over {wl.duration_s:.2f} s, tenants "
          f"{[r.tenant for r in wl].count('gold')} gold / "
          f"{[r.tenant for r in wl].count('silver')} silver / "
          f"{[r.tenant for r in wl].count('bronze')} bronze, prompts "
          f"{lens[0]}-{lens[-1]} tokens (median {lens[len(lens) // 2]}), "
          f"half from 3 shared prefixes, 16 greedy tokens each; workload "
          f"{wl.fingerprint()[:12]}) on the [serving] model; pool "
          f"{TENANCY_ENGINE['num_blocks'] - 1} blocks, spill "
          f"{TENANCY_ENGINE['kv_spill_blocks']}, watermark "
          f"{TENANCY_ENGINE['kv_high_watermark']}, bronze quota "
          f"{TENANCY['tenants'][2]['block_quota']} blocks; deadlines "
          f"(s, tokens) {TENANCY_DEADLINES}; {card_line()}")
    eng = LLMEngine(model, **TENANCY_ENGINE)
    K.reset_launch_counts()
    t0 = time.monotonic()
    reqs = drive_workload(torch, eng, wl, TENANCY_DEADLINES)
    wall = time.monotonic() - t0
    engine_launches = K.launch_counts()
    st = eng.stats()
    spill = st["prefix_cache"]["spill"]
    cache = eng.cache
    missed = set(TENANCY_DEADLINES)
    for i, r in reqs.items():
        if i in missed:
            continue
        if r.state.value != "finished" or len(r.output_tokens) != 16:
            raise AssertionError(f"request {i}: {r.state} "
                                 f"{len(r.output_tokens)} tokens {r.error!r}")
    decoding, queued = (reqs[i] for i in sorted(missed))
    for what, r in (("mid-decode", decoding), ("queued", queued)):
        if (r.state.value, r.finish_reason) != ("cancelled", "deadline") \
                or not isinstance(r.error, DeadlineExceeded):
            raise AssertionError(f"the {what} deadline request: {r.state} "
                                 f"{r.finish_reason} {r.error!r}")
    if queued.admit_time is not None or queued.output_tokens:
        raise AssertionError("the queued deadline request was prefilled")
    if not 1 <= len(decoding.output_tokens) < TENANCY_DEADLINES[
            min(missed)][1]:
        raise AssertionError(f"the mid-decode deadline request served "
                             f"{len(decoding.output_tokens)} tokens")
    if not (spill["spills"] > 0 and spill["promotes"] > 0):
        raise AssertionError(f"spill tier unused: {spill}")
    sched = eng.scheduler
    if sched.num_pressure_events < 1 or sched.mem_pressure:
        raise AssertionError(f"pressure latch: {sched.num_pressure_events} "
                             f"latches, latched at the end "
                             f"{sched.mem_pressure}")
    if not cache.quota_evictions.get("bronze"):
        raise AssertionError(f"quota evictions {cache.quota_evictions}")
    ten = st["tenancy"]["tenants"]
    flops = sum(t["cost"]["flops"] for t in ten.values())
    total = sum(n * eng._trace_costs[k]["flops"]
                for k, n in eng.steps_run.items())
    if not abs(flops - total) <= 1e-9 * total:
        raise AssertionError(f"tenant flops {flops} != the engine's {total}")
    K.reset_launch_counts()
    served = {i: r for i, r in reqs.items() if i not in missed}
    worst, exact, ntok = teacher_forced(torch, model, served, prompts)
    forward_launches = K.launch_counts()
    for path, counts, needed in (
            ("the tenancy engine", engine_launches,
             ("paged_attention", "rmsnorm")),
            ("its teacher-forced check", forward_launches,
             ("flash_attention", "rmsnorm"))):
        missing = [k for k in needed if counts[k] == 0]
        if missing:
            raise AssertionError(f"{path} never launched {missing}")

    # the same workload with spill, quotas and tenancy off and a pool that
    # holds everything; then the first engine's settings under corrupt
    # promotions
    plain = drive_workload(torch, LLMEngine(
        model, max_slots=4, max_model_len=1024, block_size=16),
        [w for w in wl if w.index not in missed])
    with faults.FaultPlan.parse("serving.kv.promote:corrupt@1x*"):
        eng3 = LLMEngine(model, **TENANCY_ENGINE)
        corrupt = drive_workload(torch, eng3, wl, TENANCY_DEADLINES)
    spill3 = eng3.stats()["prefix_cache"]["spill"]
    if spill3["promotes"] != 0 or spill3["promote_corrupt_drops"] < 1:
        raise AssertionError(f"corrupt rerun: {spill3}")
    parted = {}
    for name, other in (("no-spill engine", plain),
                        ("corrupt-promotion rerun", corrupt)):
        parted[name] = []
        for i, r in served.items():
            a, b = r.output_tokens, other[i].output_tokens
            if a == b:
                continue
            d, ga, gb = first_divergence(torch, model, prompts[i], a, b)
            hits = (r.cached_tokens_total, other[i].cached_tokens_total)
            parted[name].append((i, d, round(ga, 4), round(gb, 4), hits))
            if max(ga, gb) > TF_TOL:
                raise AssertionError(
                    f"request {i}: the {name}'s stream parts from the first "
                    f"engine's at token {d} where the two tokens' logits "
                    f"lie {ga} / {gb} below the teacher-forced row max "
                    f"(limit {TF_TOL}); prefix hits {hits}")
    copy_ms, crc_ms, nbytes = spill_copy_probe(torch, eng)

    by_tenant = {}
    for i, r in served.items():
        by_tenant.setdefault(r.tenant, []).append(r.ttft)
    ttft = {t: (1e3 * sum(v) / len(v), 1e3 * max(v))
            for t, v in sorted(by_tenant.items())}
    print(f"  {len(served)} requests x 16 tokens in {wall:.2f} s; TTFT ms "
          f"mean / max (queueing included) "
          + ", ".join(f"{t} {m:.1f} / {x:.1f}" for t, (m, x) in ttft.items())
          + f"; decode {eng.decode_tokens / eng.decode_s:.1f} tokens/s over "
          f"{eng.decode_tokens} tokens; preemptions {st['num_preemptions']}")
    print(f"  spill tier: {spill['spills']} spills ({1e3 * cache.spill_s:.1f} "
          f"ms host, {1e3 * cache.spill_s / max(spill['spills'], 1):.2f} ms "
          f"a block), {spill['promotes']} promotes "
          f"({1e3 * cache.promote_s:.1f} ms host, "
          f"{1e3 * cache.promote_s / max(spill['promotes'], 1):.2f} ms a "
          f"block), {spill['spill_drops']} dropped for capacity, "
          f"{spill['promote_errors']} promotions refused by a dry pool; "
          f"prefix hits {st['prefix_cache']['hits']} (tokens saved "
          f"{st['prefix_cache']['tokens_saved']}); quota evictions "
          f"{dict(cache.quota_evictions)}; pressure latches "
          f"{sched.num_pressure_events}; high water "
          f"{st['block_high_water']} blocks")
    print(f"  deadlines: request {sorted(missed)[0]} cancelled after "
          f"{len(decoding.output_tokens)} tokens, request "
          f"{sorted(missed)[1]} while queued (never prefilled); tenant flops "
          + ", ".join(f"{t} {v['cost']['flops']:.4g}"
                      for t, v in sorted(ten.items()))
          + f" = the engine's {total:.6g}")
    print(f"  teacher forcing: worst gap {worst:.4f} (limit {TF_TOL}); "
          f"{exact} of {ntok} served greedy tokens are the argmax (need "
          f"{TF_MIN_EXACT:.0%}); corrupt rerun: "
          f"{spill3['promote_corrupt_drops']} promotions refused, promotes "
          f"{spill3['promotes']}")
    for name, rows in parted.items():
        print(f"  streams of the {name}: {len(served) - len(rows)} of "
              f"{len(served)} equal; parted (request, token, gaps of the two "
              f"tokens to the row max, prefix-hit tokens first engine / "
              f"this one): {rows}")
    print(f"  spill copy probe: {copy_ms:.2f} ms to copy a {nbytes / 2 ** 20:.0f}"
          f" MiB block to the host, {crc_ms:.2f} ms for its CRC32 (medians "
          f"of 10)")
    nonzero = lambda c: {k: v for k, v in c.items() if v}  # noqa: E731
    print(f"  launches: engine {nonzero(engine_launches)}; teacher forcing "
          f"{nonzero(forward_launches)}; phase "
          f"{time.monotonic() - t_phase:.1f} s ({card_line()})")
    return {k: engine_launches[k] + forward_launches[k]
            for k in engine_launches}


def card_decode_count(torch, eng):
    """One decode step of ``eng`` counted on the card under the cost
    counter (every slot idle: each writes its token into the scratch
    block): the paged-attention and RMSNorm kernels launch, and each
    launch is counted by its plain version run beside it."""
    from paddle_tpu_torch import telemetry

    S, dev = eng.max_slots, eng.device
    with torch.inference_mode():
        est, _ = telemetry.cost.measure(
            eng._decode_step, torch.zeros(S, dtype=torch.int32, device=dev),
            torch.zeros(S, eng.max_blocks, dtype=torch.int32, device=dev),
            torch.ones(S, dtype=torch.int32, device=dev),
            ([0.0] * S, [0] * S, [1.0] * S, [0] * S, [0] * S),
            inputs=eng._cost_inputs + [eng.cache.pool],
            outputs=[eng.cache.pool])
    torch.cuda.synchronize()
    return est


def serving_telemetry_checks(torch, K, eng, reqs, st, est_s):
    """[serving telemetry]: what the run left in the telemetry layer. The
    Prometheus text's ``serving_*{engine=...}`` series equal ``stats()``;
    the Chrome export holds one ``request`` root per request with its
    ``queued`` / ``prefill`` / ``decode`` children; the flight ring holds
    the run's ``kv.alloc`` / ``kv.free`` events; ``stats()["slo"]`` has
    TTFT and TPOT percentiles; the decode step's roofline estimate (counted
    shape-only on the CPU's route when ``stats()`` read it) equals a
    decode step counted on the card, kernels launched, and
    ``serving_roofline_frac`` lies in (0, 1.05]."""
    import tempfile

    from paddle_tpu_torch import telemetry

    lab = eng.engine_label
    lines = set(telemetry.prometheus_text().splitlines())
    series = {"serving_requests_finished_total": st["num_finished"],
              "serving_generated_tokens_total": st["total_generated_tokens"],
              "serving_preemptions_total": st["num_preemptions"],
              "serving_requests_failed_total": st["num_failed"]}
    for fam, v in series.items():
        if f'{fam}{{engine="{lab}"}} {v}' not in lines:
            raise AssertionError(f"{fam}{{engine={lab}}} is not {v} in the "
                                 f"Prometheus text")
    if (st["num_finished"], st["total_generated_tokens"]) != (
            len(reqs), 16 * len(reqs)):
        raise AssertionError(f"stats() {st['num_finished']} finished, "
                             f"{st['total_generated_tokens']} tokens")
    with tempfile.TemporaryDirectory() as d:
        path = telemetry.tracer().export_chrome(os.path.join(d, "t.json"))
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    roots = {e["args"]["rid"]: e for e in evs if e["name"] == "request"
             and e["args"].get("engine") == lab}
    if sorted(roots) != sorted(r.rid for r in reqs):
        raise AssertionError(f"request roots {sorted(roots)}")
    for rid, root in roots.items():
        kids = sorted(e["name"] for e in evs if e.get("args", {}).get(
            "parent_id") == root["args"]["span_id"])
        if kids != ["decode", "prefill", "queued"]:
            raise AssertionError(f"request {rid}'s spans: {kids}")
    # a request whose every block the prefix index holds parks them in
    # the LRU at its end (no kv.free), as in the reference
    fl = telemetry.flight()
    granted = sum(e["n"] for e in fl.events("kv.alloc") if e["granted"])
    n_alloc = len(fl.events("kv.alloc"))
    n_free = len(fl.events("kv.free"))
    if not n_alloc or not n_free or granted < len(reqs):
        raise AssertionError(f"flight ring: {n_alloc} kv.alloc ({granted} "
                             f"blocks granted), {n_free} kv.free events for "
                             f"{len(reqs)} requests")
    slo = st["slo"]
    for k in ("ttft", "tpot"):
        if any(slo[k][q] is None for q in ("p50", "p95", "p99")):
            raise AssertionError(f"stats()['slo'][{k!r}] = {slo[k]}")
    roof = st["perf"]["roofline"]
    dec = roof["decode"]["buckets"]["decode"]
    est = telemetry.cost.lookup("engine.decode", "decode", eng._cost_fp)
    t0 = time.monotonic()
    launched = K.launch_counts()["paged_attention"]
    card = card_decode_count(torch, eng)
    count_s = time.monotonic() - t0
    layers = eng.model.config.num_hidden_layers
    if (dec["flops"], dec["bytes"], dec["matmul_flops"]) != (
            card["flops"], card["bytes"], card["matmul_flops"]) \
            or est["kernels"] != card["kernels"] \
            or card["kernels"].get("paged_attention") != layers \
            or K.launch_counts()["paged_attention"] != launched + layers:
        raise AssertionError(f"decode roofline {est} != the step counted on "
                             f"the card {card}")
    frac = roof["serving_roofline_frac"]
    if frac is None or not 0 < frac <= 1.05:
        raise AssertionError(f"serving_roofline_frac {frac}")
    peaks = roof["peaks"]
    print(f"[serving telemetry] Prometheus serving_*{{engine={lab}}}: "
          + ", ".join(f"{k.replace('serving_', '')} {v}"
                      for k, v in series.items())
          + f" (= stats()); {len(roots)} request roots with queued / "
          f"prefill / decode; flight ring {n_alloc} kv.alloc ({granted} "
          f"blocks), {n_free} kv.free; SLO TTFT p50/p99 {slo['ttft']['p50'] * 1e3:.1f} / "
          f"{slo['ttft']['p99'] * 1e3:.1f} ms, TPOT p50/p99 "
          f"{slo['tpot']['p50'] * 1e3:.2f} / {slo['tpot']['p99'] * 1e3:.2f}"
          f" ms")
    print(f"  decode roofline: {dec['flops']} flops ({dec['matmul_flops']} "
          f"in products), {dec['bytes']} bytes, AI "
          f"{dec['arithmetic_intensity']} (counted shape-only in stats(), "
          f"{est_s:.2f} s); a step counted on the card equal ({count_s:.2f}"
          f" s); kernels {card['kernels']}; peaks {peaks['platform']} "
          f"{peaks['flops_per_s']:.4g} FLOP/s, {peaks['bytes_per_s']:.4g} "
          f"B/s; roofline time "
          f"{telemetry.cost.roofline_time_s(card, peaks) * 1e3:.3f} ms; "
          f"serving_roofline_frac {frac:.4f} over "
          f"{roof['decode']['samples']} decode steps ({card_line()})")


def telemetry_overhead(torch, eng):
    """[profile] one decode step (4 running slots) with telemetry on and
    off (``telemetry.disable()``): 5 steps of each, interleaved on off off
    on on off off on on off, each step's wall synchronised."""
    from paddle_tpu_torch import telemetry

    walls = {True: [], False: []}
    try:
        for on in (True, False, False, True, True, False, False, True, True,
                   False):
            (telemetry.enable if on else telemetry.disable)()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            eng.step()
            torch.cuda.synchronize()
            walls[on].append((time.monotonic() - t0) * 1e3)
    finally:
        telemetry.enable()
    on, off = (sum(walls[k]) / len(walls[k]) for k in (True, False))
    print(f"[profile] telemetry's cost a decode step: on {on:.3f} ms, off "
          f"{off:.3f} ms (means of 5 interleaved steps each; on "
          f"{[round(w, 3) for w in walls[True]]}, off "
          f"{[round(w, 3) for w in walls[False]]}): {on - off:+.3f} ms, "
          f"{100 * (on - off) / off:+.2f}% ({card_line()})")


def profiler_phase(torch, eng, K):
    """[profiler]: 3 decode steps inside ``paddle_tpu_torch.profiler.
    Profiler`` with CPU and GPU targets and ``export_chrome_tracing``: the
    exported trace must hold the paged-attention kernel's device events
    (one a layer a step) and the engine's ``engine.decode`` spans as host
    annotations; prints ``summary()``'s top rows."""
    import shutil
    import tempfile

    from paddle_tpu_torch import profiler

    d = tempfile.mkdtemp(prefix="profiler_phase_")
    try:
        p = profiler.Profiler(
            targets=[profiler.ProfilerTarget.CPU,
                     profiler.ProfilerTarget.GPU],
            on_trace_ready=profiler.export_chrome_tracing(d, "serving"))
        before = K.launch_counts()["paged_attention"]
        p.start()
        for _ in range(3):
            eng.step()
            p.step(num_samples=len(eng.scheduler.running))
        p.stop()
        launched = K.launch_counts()["paged_attention"] - before
        with open(p.last_trace_path) as f:
            evs = json.load(f)["traceEvents"]
        kern = [e for e in evs if e.get("cat") == "kernel"
                and "paged" in e["name"]]
        spans = [e for e in evs if e.get("cat") == "user_annotation"
                 and e["name"] == "engine.decode"]
        layers = eng.model.config.num_hidden_layers
        if launched != 3 * layers or len(kern) < launched or len(spans) != 3:
            raise AssertionError(
                f"profiler trace: {len(kern)} paged-attention kernel events "
                f"for {launched} launches, {len(spans)} engine.decode spans")
        rep = p.summary(max_rows=6, print_table=False)
        print(f"[profiler] 3 decode steps: {len(kern)} paged-attention "
              f"kernel events ({launched} launches), {len(spans)} "
              f"engine.decode host annotations, "
              f"{os.path.getsize(p.last_trace_path) / 2 ** 20:.1f} MiB "
              f"trace; batch_cost {rep['batch_cost'] * 1e3:.2f} ms "
              f"({card_line()})")
        for title, rows in (("device", rep["op_summary"]),
                            ("host", rep["host_summary"])):
            for r in rows:
                print(f"  {title:6s} {r['total_us']:10.1f} us "
                      f"x{r['calls']:<5d} {r['pct']:6.2f}%  "
                      f"{r['name'][:70]}")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def faults_phase(torch, model):
    """[faults]: 3 greedy requests of 8 tokens on the [serving] model
    under ``FaultPlan.parse("serving.prefill:error@2")``: request 2 ends
    FAILED with its ``FaultError``, the other two finish with the tokens of
    an unfaulted run, and a flight dump names the fault."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.utils import faults

    rng = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 32000, (n,), generator=rng).tolist()
               for n in (21, 40, 33)]

    def serve():
        eng = LLMEngine(model, max_slots=4, max_model_len=128,
                        block_size=16)
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=8))
                for p in prompts]
        eng.run()
        eng.close()
        return reqs

    clean = serve()
    with faults.FaultPlan.parse("serving.prefill:error@2") as plan:
        reqs = serve()
    path = telemetry.dump(reason="faults phase")
    with open(path) as f:
        doc = json.load(f)
    os.remove(path)
    fired = [e for e in doc["events"] if e["kind"] == "fault.injected"
             and e["site"] == "serving.prefill"]
    bad = reqs[1]
    if (bad.state.value != "failed"
            or not isinstance(bad.error, faults.FaultError)
            or bad.error.site != "serving.prefill"):
        raise AssertionError(f"request 2: {bad.state} {bad.error!r}")
    for i in (0, 2):
        if reqs[i].state.value != "finished" or \
                reqs[i].output_tokens != clean[i].output_tokens:
            raise AssertionError(f"request {i + 1}: {reqs[i].state} "
                                 f"{reqs[i].output_tokens} vs the "
                                 f"unfaulted {clean[i].output_tokens}")
    if [f.hit for f in plan.fired] != [2] or len(fired) != 1 \
            or fired[0]["hit"] != 2:
        raise AssertionError(f"plan fired {plan.summary()}, dump {fired}")
    print(f"[faults] serving.prefill:error@2 over 3 requests x 8 tokens: "
          f"request 2 FAILED ({bad.error}), requests 1 and 3 finished with "
          f"the unfaulted run's tokens; the flight dump ({doc['num_events']} "
          f"events) names fault.injected at serving.prefill hit "
          f"{fired[0]['hit']}")


FLEET_ENGINE = dict(block_size=16, max_slots=4, max_model_len=1024)
FLEET_NEW = 16            # tokens each [serving fleet] request asks for
FLEET_FETCH_FRAMES = 4    # 7B blocks one migration moves (8 MiB each)


def _sse_request(port, body, headers, timeout=300):
    """POST one streamed completion; returns the status, the raw body
    lines, the tokens, each token event's host time and the finish
    reason."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.monotonic()
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json", **headers})
    resp = conn.getresponse()
    out = {"status": resp.status, "t0": t0, "lines": [], "tokens": [],
           "times": [], "finish": None, "error": None}
    try:
        while True:
            line = resp.readline()
            if not line:
                break
            out["lines"].append(line)
            text = line.decode().strip()
            if text == "data: [DONE]":
                break
            if not text.startswith("data: "):
                continue
            doc = json.loads(text[6:])
            ch = doc["choices"][0]
            got = ch.get("token_ids") or []
            out["tokens"] += got
            out["times"] += [time.monotonic()] * len(got)
            out["finish"] = ch.get("finish_reason") or out["finish"]
            if doc.get("error"):
                out["error"] = doc["error"]["message"]
    finally:
        conn.close()
    return out


def _parting_gaps(torch, model, prompt, a, b, sp):
    """Where the streams ``a`` and ``b`` of ``prompt`` part, and each
    side's gap to the best score of the no-cache forward's row there:
    for greedy sampling the logit gap to the row max; for seeded sampling
    the Gumbel-perturbed score's gap (the draw the engines make,
    ``nn.decode.sample_logits``), times the temperature so that both are
    in logit units (both within TF_TOL: a bf16 near-tie)."""
    from paddle_tpu_torch.nn.decode import _uniform

    d = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    with torch.inference_mode():
        ids = torch.tensor([prompt + a[:d]], device=model.device)
        row = model(ids)[0, -1].float()
    if sp["temperature"] > 0:
        u = _uniform(row.shape[0], sp["seed"], d, row.device)
        row = row - sp["temperature"] * torch.log(-torch.log(u))
    top = row.max()
    return d, (top - row[a[d]]).item(), (top - row[b[d]]).item()


def serving_fleet_phase(torch, K, model):
    """[serving fleet]: the port's serving front door on the card. Two
    Llama-2-7B replicas (FLEET_ENGINE: bf16, block 16, 4 slots, 1024
    tokens): ``r0`` a ``LocalReplica`` whose engine runs over the [serving]
    phase's model in this process (its kernel launches are counted here),
    ``r1`` a ``ProcReplica`` whose child (``python -m
    paddle_tpu_torch.serving.replica_worker``) builds the same seeded
    model on the card. Both publish their prefixes to the KV fabric's
    directory in the port's TCPStore; a ``FleetRouter(kv_fabric=...)``
    places and migrates; the port's ``Gateway`` (journaled) serves them
    on 127.0.0.1. Twelve streamed HTTP requests of FLEET_NEW tokens (half
    share a 256-token prefix; greedy and seeded): one shared-prefix
    request first; then three requests whose prefix affinity names the
    prefix's holder, so that the next shared-prefix request is placed on
    the other replica and pulls FLEET_FETCH_FRAMES blocks of the prefix
    over the fabric; ``r1`` is SIGKILLed once one of its requests has
    streamed 3 tokens, the request fails over to ``r0`` (replay and
    suppress), ``r1`` restarts, and the other requests follow; one
    ``Idempotency-Key`` request is sent again and must replay byte for
    byte. Every request ends with FLEET_NEW tokens equal to a fleet-free
    ``LLMEngine``'s on the same model, or parts from them only where both
    tokens lie within TF_TOL of the row's best score (a bf16 near-tie;
    a ``replay_mismatch`` there is accepted too). The router counted a
    failover, at least 3 suppressed tokens and migrated blocks with no
    corrupt frame; r0's paged-attention and RMSNorm launches equal 32 a
    decode step and 65 a forward of the steps its engine ran. Prints
    TTFT, decode tokens/s through the gateway, the failover latency, the
    host ms a migrated block costs, r1's start and restart seconds and
    the phase's seconds; returns r0's launches."""
    import shutil

    from paddle_tpu_torch.distributed import TCPStore
    from paddle_tpu_torch.serving import (FleetRouter, Gateway, LLMEngine,
                                          LocalReplica, ProcReplica,
                                          ReplicaState, SamplingParams)
    from paddle_tpu_torch.serving import kv_fabric

    t_phase = time.monotonic()
    L = model.config.num_hidden_layers
    rng = torch.Generator().manual_seed(22)

    def toks(n):
        return torch.randint(0, 32000, (n,), generator=rng).tolist()

    shared = toks(256)
    greedy = {"temperature": 0.0}
    # a mix of greedy and seeded top-p requests; the even ones share the
    # prefix
    plan = []
    for i, n in enumerate((40, 120, 17, 300, 60, 33, 90, 500, 25, 64, 150,
                           8)):
        prompt = shared + toks(n) if i % 2 == 0 else toks(n + 100)
        sp = (dict(greedy) if i % 3 else
              {"temperature": 0.8, "top_p": 0.9, "seed": 100 + i})
        plan.append((prompt, sp))

    # the fleet-free reference streams, on this thread, before the fleet
    ref_eng = LLMEngine(model, **FLEET_ENGINE)
    ref_reqs = [ref_eng.add_request(p, SamplingParams(
        max_new_tokens=FLEET_NEW, **sp)) for p, sp in plan]
    ref_eng.run()
    ref = [r.output_tokens for r in ref_reqs]
    ref_eng.close()
    del ref_eng, ref_reqs
    gc.collect()
    torch.cuda.empty_cache()

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "paddle_tpu_torch", "csrc", "build", "fleet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    store = TCPStore(is_master=True)
    endpoint = f"127.0.0.1:{store.port}"
    fabric = {"store": endpoint, "lease_s": 30.0}
    engines = []

    def factory():
        eng = LLMEngine(model, **FLEET_ENGINE)
        engines.append(eng)
        return eng

    warmup = toks(20)
    r0 = LocalReplica("r0", factory, stats_interval_s=0.05, warmup=warmup,
                      fabric=fabric)
    spec = {"seed": 0, "llama_7b": {"layers": L, "dtype": "bfloat16"},
            "engine": FLEET_ENGINE, "stats_interval_s": 0.05,
            "warmup": warmup, "fabric": dict(fabric)}
    r1 = ProcReplica("r1", spec, log_path=os.path.join(work, "r1.log"))
    router = FleetRouter(
        [r0, r1], probe_interval_s=0.1, probe_timeout_s=120.0,
        affinity_block_size=FLEET_ENGINE["block_size"], max_retries=1,
        kv_fabric={"store": endpoint, "lease_s": 30.0,
                   "fetch_timeout_s": 120.0,
                   "max_fetch_frames": FLEET_FETCH_FRAMES,
                   "max_fetch_bytes": 64 << 20, "cache_ttl_s": 0.0})
    # the migrations' host seconds (donor export, frames through the
    # pipe, the ingest command handed on) and the receivers' ingest
    # replies, seen where the router takes them
    mig_s, ingested = [], []
    migrate, on_event = router._migrate, router._on_event

    def timed_migrate(*a):
        t = time.monotonic()
        try:
            return migrate(*a)
        finally:
            mig_s.append(time.monotonic() - t)

    def watched(rep, ev):
        if ev.get("ev") == "kv_ingested":
            ingested.append((rep.rid, dict(ev)))
        return on_event(rep, ev)

    router._migrate, router._on_event = timed_migrate, watched
    gw = None
    try:
        t0 = time.monotonic()
        router.start()

        def wait_healthy(rep, what, limit=300.0):
            deadline = time.monotonic() + limit
            while rep.state is not ReplicaState.HEALTHY:
                if time.monotonic() > deadline or \
                        rep.state is ReplicaState.UNHEALTHY:
                    log = open(os.path.join(work, "r1.log")).read()[-3000:]
                    raise AssertionError(f"{what}: {rep.rid} is "
                                         f"{rep.state.value}; r1 log: {log}")
                time.sleep(0.02)
            return time.monotonic()

        t_r0 = wait_healthy(r0, "start") - t0
        t_r1 = wait_healthy(r1, "start") - t0
        gw = Gateway(router, journal_dir=os.path.join(work, "journal"),
                     journal_watermark_every=4).start()
        [eng0] = engines
        d0 = eng0.steps_run.get(("decode", "decode"), 0)
        p0 = eng0.prefill_calls
        K.reset_launch_counts()
        t_traffic = time.monotonic()
        results = {}

        def send(i, headers=None):
            prompt, sp = plan[i]
            body = {"prompt": prompt, "max_tokens": FLEET_NEW,
                    "stream": True, **sp}

            def run():
                try:
                    results[i] = _sse_request(gw.port, body, headers or {})
                except Exception as e:  # lint: allow-silent(the error is the request's result, checked below)
                    results[i] = {"status": None, "tokens": [],
                                  "error": f"{type(e).__name__}: {e}"}
            th = threading.Thread(target=run, name=f"fleet-client-{i}",
                                  daemon=True)
            th.start()
            return th

        def rr_of(i):
            for gid in range(64):
                rr = router.find_request(gid)
                if rr is not None and rr.prompt == plan[i][0]:
                    return rr
            return None

        def wait_dispatched(i, limit=120.0):
            deadline = time.monotonic() + limit
            while time.monotonic() < deadline:
                rr = rr_of(i)
                if rr is not None and rr.replica is not None:
                    return rr
                time.sleep(0.005)
            raise AssertionError(f"request {i} was never dispatched")

        # 1. the prefix lands on one replica and in the directory
        threads = {0: send(0)}
        threads[0].join(300)
        holder = rr_of(0).replica
        hashes = kv_fabric.chain_hashes(plan[2][0],
                                        FLEET_ENGINE["block_size"])
        deadline = time.monotonic() + 60
        while router._fabric.dir.lookup(hashes).get(holder, 0) < 16:
            if time.monotonic() > deadline:
                raise AssertionError(f"the directory never showed {holder} "
                                     f"holding the prefix")
            time.sleep(0.02)
        other = "r1" if holder == "r0" else "r0"
        # 2. load the holder through prefix affinity, then a shared-prefix
        #    request lands on the other replica and migrates the prefix
        picks = [i for i in (1, 3, 5, 7, 9, 11)
                 if router._order[router._affinity_key(plan[i][0])
                                  % 2] == holder][:3]
        if len(picks) < 3:
            raise AssertionError(f"only {picks} of the unshared prompts "
                                 f"prefer {holder}")
        for i in picks:
            threads[i] = send(i)
            wait_dispatched(i)
        threads[2] = send(2, {"Idempotency-Key": "fleet-idem-2"})
        rr2 = wait_dispatched(2)
        st = router.stats()
        if rr2.replica != other or st["migrations"] < 1:
            raise AssertionError(f"the second shared-prefix request went "
                                 f"to {rr2.replica} with "
                                 f"{st['migrations']} migrations")
        # 3. SIGKILL r1 once one of its requests streamed 3 tokens
        deadline = time.monotonic() + 120
        victim = None
        while victim is None:
            for i in list(threads):
                rr = rr_of(i)
                if rr is not None and rr.replica == "r1" and \
                        not rr.terminal and len(rr.tokens) >= 3:
                    victim = (i, rr, len(rr.tokens))
                    break
            if time.monotonic() > deadline:
                raise AssertionError("no r1 request streamed 3 tokens")
            time.sleep(0.002)
        t_kill = time.monotonic()
        r1.kill()
        pid1 = r1.pid
        deadline = time.monotonic() + 60
        while r1.state is not ReplicaState.UNHEALTHY:
            if time.monotonic() > deadline:
                raise AssertionError("the router never saw r1 die")
            time.sleep(0.005)
        # the tokens r1 had streamed when the router took it for dead:
        # the next one comes from the failover
        victim = (victim[0], victim[1], len(victim[1].tokens))
        t_re = time.monotonic()
        router.restart("r1")
        t_restart = wait_healthy(r1, "restart") - t_re
        if r1.pid == pid1:
            raise AssertionError("r1 restarted in the same process")
        # 4. the rest of the traffic
        for i in range(len(plan)):
            if i not in threads:
                threads[i] = send(i)
        for th in threads.values():
            th.join(300)
        wall = time.monotonic() - t_traffic
        launches = K.launch_counts()
        d_steps = eng0.steps_run.get(("decode", "decode"), 0) - d0
        p_steps = eng0.prefill_calls - p0
        # 5. the idempotent retry replays byte for byte
        again = _sse_request(gw.port, {"prompt": plan[2][0],
                                       "max_tokens": FLEET_NEW,
                                       "stream": True, **plan[2][1]},
                             {"Idempotency-Key": "fleet-idem-2"})
        if again["lines"] != results[2]["lines"]:
            raise AssertionError("the Idempotency-Key retry did not replay "
                                 "the stream byte for byte")
        st = router.stats()
        fab0 = eng0.cache.prefix_stats()["fabric"]
        promote_ms = eng0.cache.promote_s * 1e3
    finally:
        if gw is not None:
            gw.stop()
        router.close()
        if r1.proc is not None and r1.alive:
            r1.proc.kill()
            r1.proc.wait(30)
        store.close()

    # the streams against the fleet-free engine's
    parted = []
    for i, (prompt, sp) in enumerate(plan):
        res = results.get(i) or {}
        rr = rr_of(i)
        if res.get("status") != 200:
            raise AssertionError(f"request {i}: HTTP {res.get('status')} "
                                 f"{res.get('error')}")
        got = res["tokens"]
        mismatch = rr is not None and rr.finish_reason == "replay_mismatch"
        if got == ref[i] and not mismatch:
            if res["finish"] != "length" or len(got) != FLEET_NEW:
                raise AssertionError(f"request {i}: {len(got)} tokens, "
                                     f"finish {res['finish']}")
            continue
        if got == ref[i][:len(got)] and mismatch:
            # the replay parted from the streamed tokens: where?
            a, b = rr.tokens, ref[i]
        else:
            a, b = got, ref[i]
        if a == b[:len(a)]:
            raise AssertionError(f"request {i}: {len(got)} tokens, finish "
                                 f"{res['finish']} ({res.get('error')})")
        d, ga, gb = _parting_gaps(torch, model, prompt, a, b, sp)
        parted.append((i, d, ga, gb, res["finish"]))
        if max(ga, gb) > TF_TOL:
            raise AssertionError(
                f"request {i} parts from the fleet-free stream at token {d} "
                f"with gaps {ga:.4f} / {gb:.4f} (limit {TF_TOL}): not a "
                f"bf16 near-tie")
        if not mismatch and (res["finish"] != "length"
                             or len(got) != FLEET_NEW):
            raise AssertionError(f"request {i}: {len(got)} tokens, finish "
                                 f"{res['finish']}")
    if st["failovers"] < 1 or st["replay_suppressed"] < 3:
        raise AssertionError(f"failovers {st['failovers']}, suppressed "
                             f"{st['replay_suppressed']}")
    landed = sum(ev.get("ingested") or 0 for _, ev in ingested)
    spoiled = sum((ev.get("corrupt") or 0) + (ev.get("errors") or 0)
                  for _, ev in ingested)
    if st["migrated_blocks"] < 1 or landed < 1 or spoiled:
        raise AssertionError(f"migrated blocks {st['migrated_blocks']}, "
                             f"ingest replies {ingested}")
    want = {"paged_attention": L * d_steps,
            "rmsnorm": (2 * L + 1) * (d_steps + p_steps)}
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"r0 ran {d_steps} decode steps and "
                                 f"{p_steps} prefills: {k} launched "
                                 f"{launches[k]} times, want {n}")
    ttft = [results[i]["times"][0] - results[i]["t0"] for i in results
            if results[i]["times"]]
    # decode rates from the router's stamps (the clients read their
    # sockets in bursts): a stream's tokens after its first over its
    # first-to-last span, and the fleet's over the union of those spans
    spans = [(rr.first_token_time, rr.finish_time, len(rr.tokens))
             for rr in (rr_of(i) for i in range(len(plan)))
             if rr is not None and rr.first_token_time is not None
             and rr.finish_time is not None]
    rates = [(n - 1) / (t1 - t0) for t0, t1, n in spans if t1 > t0]
    busy, reach = 0.0, -math.inf
    for t0, t1, _ in sorted(spans):
        busy += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    decoded = sum(n - 1 for _, _, n in spans)
    vi, vrr, vn = victim
    after = [t for t in results[vi]["times"][vn:]]
    fo_ms = (after[0] - t_kill) * 1e3 if after else float("nan")
    print(f"[serving fleet] 2 Llama-2-7B replicas ({L} layers, bf16): r0 "
          f"in this process over the [serving] model, r1 a child process; "
          f"r0 healthy {t_r0:.1f} s, r1 {t_r1:.1f} s after start; "
          f"{len(plan)} streamed requests x {FLEET_NEW} tokens through the "
          f"gateway in {wall:.2f} s")
    print(f"  TTFT mean {sum(ttft) / len(ttft) * 1e3:.1f} ms (max "
          f"{max(ttft) * 1e3:.1f} ms) at the clients; decode "
          f"{sum(rates) / len(rates):.1f} tokens/s a stream (mean; "
          f"{min(rates):.1f}-{max(rates):.1f}), {decoded / busy:.1f} tokens/s "
          f"over the fleet while streams ran ({busy:.2f} s of the "
          f"{wall:.2f} s)")
    print(f"  SIGKILL r1 (pid {pid1}) with request {vi} at {vn} tokens: "
          f"failover latency {fo_ms:.1f} ms to its next client token; r1 "
          f"restarted in {t_restart:.1f} s")
    blocks = st["migrated_blocks"]
    print(f"  fabric: {st['migrations']} migrations ({st['migration_failures']}"
          f" failed), {blocks} blocks of "
          f"{eng0.cache._block_nbytes >> 20} "
          f"MiB, {landed} ingested, none corrupt; host "
          f"{sum(mig_s) * 1e3 / max(blocks, 1):.1f} ms a migrated block "
          f"(donor copy, frames through the pipe, ingest handed on; "
          f"{len(mig_s)} migrations took {[round(x * 1e3, 1) for x in mig_s]}"
          f" ms); r0's promotions {promote_ms:.1f} ms in all; directory "
          f"hits {st['directory_hits']}, placements "
          f"{st['directory_placements']}; r0 fabric {fab0}")
    print(f"  router: failovers {st['failovers']}, replay suppressed "
          f"{st['replay_suppressed']}, mismatches "
          f"{st['replay_mismatches']}, deaths {st['replica_deaths']}, "
          f"restarts {st['replica_restarts']}; idempotent retry replayed "
          f"{len(again['lines'])} lines byte for byte")
    for i, d, ga, gb, fin in parted:
        print(f"  request {i} parts from the fleet-free stream at token {d} "
              f"(gaps {ga:.4f} / {gb:.4f}, a bf16 near-tie; finish {fin})")
    print(f"  launches on r0 ({d_steps} decode steps, {p_steps} prefills): "
          f"{ {k: launches[k] for k in want} }")
    print(f"[serving fleet] {time.monotonic() - t_phase:.1f} s")
    return launches


def busy_ms(kernels):
    """Device busy ms: the union of the kernels' intervals (a CPU op's row
    in ``key_averages()`` repeats its kernels' time, so rows are not
    summed)."""
    busy_us, reach = 0.0, -math.inf
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy_us += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    return busy_us / 1e3


def profile_decode_step(torch, model, K):
    """Where one decode step's time goes (4 running slots, contexts
    ~300-700): the wall time of unprofiled steps against the device busy
    time of one profiled step, taken as the union of its kernel intervals;
    then telemetry's cost a step (:func:`telemetry_overhead`) and the
    ``[profiler]`` phase on the same engine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import LLMEngine, SamplingParams

    eng = LLMEngine(model, max_slots=4, max_model_len=1024, block_size=16)
    rng = torch.Generator().manual_seed(2)
    for n in (300, 400, 500, 700):
        eng.add_request(torch.randint(0, 32000, (n,), generator=rng).tolist(),
                        SamplingParams(max_new_tokens=32))
    for _ in range(3):                   # admit + prefill, then warm decode
        eng.step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):                   # the profiler inflates host time
        t0 = time.monotonic()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    wall = sum(walls) / len(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.step()
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) * 1e3
    # only the device-side events: a CPU op's row in key_averages() carries
    # the device time of the kernels it launched, so summing every row
    # would count each kernel twice
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiled decode step traced no kernel")
    busy = busy_ms(kernels)
    per_name: dict[str, list] = {}
    for k in kernels:
        acc = per_name.setdefault(k.name, [0.0, 0])
        acc[0] += (k.time_range.end - k.time_range.start) / 1e3
        acc[1] += 1
    print(f"[profile] one decode step (4 slots): wall {wall:.2f} ms "
          f"(mean of {len(walls)} unprofiled steps, min {min(walls):.2f}; "
          f"{prof_wall:.2f} ms under the profiler); device busy "
          f"{busy:.2f} ms in {len(kernels)} kernels, idle "
          f"{100 * (1 - busy / wall):.1f}% of the unprofiled wall")
    for name, (ms, n) in sorted(per_name.items(), key=lambda r: -r[1][0])[:8]:
        print(f"  {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    telemetry_overhead(torch, eng)
    profiler_phase(torch, eng, K)
    eng.run()


def train_config(layers, hidden, heads, inter, seq):
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=hidden,
                       intermediate_size=inter, num_hidden_layers=layers,
                       num_attention_heads=heads, num_key_value_heads=heads,
                       max_position_embeddings=seq)


def whole_step_check(torch, K):
    """One trainer forward + backward in bf16 on the card against the same
    f32 masters in f32 on the CPU (the plain versions)."""
    from paddle_tpu_torch.models import LlamaPipelineTrainer
    from paddle_tpu_torch.optimizer import AdamW

    cfg = train_config(2, 512, 4, 1376, 512)
    print("[whole step] hidden 512, 4 heads of 128, 2 layers, vocab 32000, "
          "batch 2 x 512: bf16 on the card vs f32 on the CPU")
    card = LlamaPipelineTrainer(cfg, None, AdamW(learning_rate=1e-4),
                                n_micro=1, generator=torch.Generator(
                                    device="cuda").manual_seed(1))
    cpu = LlamaPipelineTrainer(cfg, None, AdamW(learning_rate=1e-4),
                               n_micro=1, device="cpu")
    cpu.model.load_state_dict(
        {k: v.cpu() for k, v in card.model.state_dict().items()})
    rng = torch.Generator().manual_seed(3)
    x = torch.randint(0, 32000, (2, 512), generator=rng)
    y = torch.randint(0, 32000, (2, 512), generator=rng)
    K.reset_launch_counts()
    loss = card.loss_and_grads(x, y).item()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"the card's trainer step never launched "
                             f"{missing}")
    ref = cpu.loss_and_grads(x, y).item()
    rel = {}
    for (name, a), b in zip(card.model.named_parameters(),
                            cpu.model.parameters()):
        ga, gb = a.grad.float().cpu(), b.grad
        rel[name] = ((ga - gb).norm() / gb.norm()).item()
    worst = sorted(rel.items(), key=lambda r: -r[1])[:3]
    print(f"  loss {loss:.5f} on the card, {ref:.5f} on the CPU (|diff| "
          f"{abs(loss - ref):.2e}, limit {STEP_LOSS_TOL}); worst gradient "
          f"relative L2 errors "
          + ", ".join(f"{n} {e:.2e}" for n, e in worst)
          + f" (limit {STEP_GRAD_REL_L2}, {len(rel)} parameters)")
    if not abs(loss - ref) <= STEP_LOSS_TOL:
        raise AssertionError(f"whole step: loss {loss} vs {ref}")
    if not worst[0][1] <= STEP_GRAD_REL_L2:
        raise AssertionError(f"whole step: gradient of {worst[0][0]} off by "
                             f"{worst[0][1]} in relative L2")


def kernel_share(kernels):
    """Device ms by group of the profiled kernels: ours, GEMMs, the rest."""
    ours = ("flash_fwd", "flash_bwd", "rmsnorm", "softmax_ce", "paged_",
            "layernorm", "ctc_", "rnnt_")
    gemm = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
    share = {"port kernels": 0.0, "GEMMs (cuBLAS)": 0.0, "other": 0.0}
    for k in kernels:
        ms = (k.time_range.end - k.time_range.start) / 1e3
        name = k.name.lower()
        key = ("port kernels" if any(o in name for o in ours) else
               "GEMMs (cuBLAS)" if any(o in name for o in gemm) else "other")
        share[key] += ms
    return share


def training_phase(torch, K):
    """The bench's configuration: ``init_parallel_env()`` (NCCL, a world
    of one), ``build_mesh(degrees={"dp": 1})`` and the mesh trainer at
    Llama-2-7B's widths, TRAIN_LAYERS deep."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.models import LlamaPipelineTrainer
    from paddle_tpu_torch.optimizer import AdamW

    B, S = 4, 2048
    cfg = train_config(TRAIN_LAYERS, 4096, 32, 11008, S)
    env = dist.init_parallel_env()
    backend = torch.distributed.get_backend()
    mesh = dist.build_mesh(degrees={"dp": 1})
    print(f"[training] Llama-2-7B widths, {TRAIN_LAYERS} layers, batch "
          f"{B} x {S}, f32 masters, bf16 compute, remat dots, AdamW lr 1e-4;"
          f" init_parallel_env: {backend}, world {env.world_size}; "
          f"build_mesh(dp=1) {dict(zip(mesh.mesh_dim_names, mesh.shape))}; "
          f"n_micro 1, zero_stage 1")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = LlamaPipelineTrainer(cfg, mesh, AdamW(learning_rate=1e-4),
                              n_micro=1, zero_stage=1, remat="dots",
                              generator=torch.Generator(
                                  device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"  trainer built in {time.monotonic() - t0:.1f}s, "
          f"{tr.num_params() / 1e9:.3f}B params")
    data = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(0, 32000, (B, S), device="cuda", generator=data)
    y = torch.randint(0, 32000, (B, S), device="cuda", generator=data)
    t0 = time.monotonic()
    losses = [tr.step(x, y).item()]              # warm-up
    print(f"  warm-up step {time.monotonic() - t0:.2f}s, loss {losses[0]:.4f}")
    K.reset_launch_counts()
    walls = []
    for _ in range(5):
        t0 = time.monotonic()
        losses.append(tr.step(x, y).item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {[round(v, 4) for v in losses]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    print(f"  launches in the 5 steps: {counts}")
    if missing:
        raise AssertionError(f"the training steps never launched {missing}")
    all_sm90("the training steps", counts)
    per_step = train_per_step(TRAIN_LAYERS)
    wrong = {k: counts[k] for k, n in per_step.items() if counts[k] != 5 * n}
    if wrong:
        raise AssertionError(f"launches in 5 steps {wrong}, want 5 x "
                             f"{per_step}")
    print(f"  launches a step equal the one-device counts: {per_step}")
    step = sum(walls) / len(walls)
    tok_s = B * S / step
    flops = tr.matmul_flops_per_token(S)
    mfu = tok_s * flops / BF16_FLOPS
    print(f"  step wall {step * 1e3:.1f} ms (mean of 5, min "
          f"{min(walls) * 1e3:.1f}); {tok_s:.0f} tokens/s; MFU "
          f"{100 * mfu:.1f}% ({flops / 1e9:.2f} GFLOP/token against "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s); peak memory "
          f"{peak / 2 ** 30:.1f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        tr.step(x, y)
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiled training step traced no kernel")
    nccl = [k.name for k in kernels if "nccl" in k.name.lower()]
    print(f"  NCCL kernels in the profiled step: {len(nccl)}")
    if nccl:
        raise AssertionError(f"a world of one ran NCCL kernels: {nccl[:3]}")
    busy = busy_ms(kernels)
    # the step is device-bound (the host runs ahead), so its own wall under
    # the profiler, not the mean of other steps, is the base of the share
    print(f"[profile] one training step: device busy {busy:.1f} ms in "
          f"{len(kernels)} kernels, wall {prof_wall:.1f} ms under the "
          f"profiler, idle {100 * (1 - busy / prof_wall):.1f}%")
    for group, ms in kernel_share(kernels).items():
        print(f"  {ms:9.2f} ms  {group}")
    per_name: dict[str, list] = {}
    for k in kernels:
        acc = per_name.setdefault(k.name, [0.0, 0])
        acc[0] += (k.time_range.end - k.time_range.start) / 1e3
        acc[1] += 1
    for name, (ms, n) in sorted(per_name.items(), key=lambda r: -r[1][0])[:12]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    # one more step, split: forward + backward, then the optimizer
    t0 = time.monotonic()
    tr.loss_and_grads(x, y)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    tr.optimizer.step()
    tr.optimizer.clear_grad()
    torch.cuda.synchronize()
    t2 = time.monotonic()
    print(f"  one step split: forward + backward {(t1 - t0) * 1e3:.1f} ms, "
          f"AdamW update {(t2 - t1) * 1e3:.1f} ms")
    del tr
    dist.set_hybrid_communicate_group(None)
    torch.distributed.destroy_process_group()
    return counts


def _rel_l2(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def _gloo_case(name, fn):
    """Run one [distributed] case on this rank: its result, or the error
    that stopped it and where, and its seconds."""
    import traceback

    t0 = time.monotonic()
    try:
        res = {"ok": True, **fn()}
    except Exception as e:  # lint: allow-silent(reported to the parent, which fails the phase unless gloo refused)
        tb = traceback.extract_tb(e.__traceback__)
        res = {"ok": False, "error": f"{type(e).__name__}: {e}"[:500],
               "where": [f"{os.path.basename(f.filename)}:{f.lineno} "
                         f"{f.name}" for f in tb[-6:]]}
    res["seconds"] = round(time.monotonic() - t0, 2)
    return res


def _dist_file(root, rank, name):
    return os.path.join(root, f"rank{rank}.{name}.json")


def _dist_write(root, rank, name, obj):
    path = _dist_file(root, rank, name)
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _dist_read(root, rank, name):
    try:
        with open(_dist_file(root, rank, name)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def distributed_rank(root, names, layers, hidden, heads, inter, seq):
    """One rank of ``[distributed]`` (started by the port's ``spawn``):
    gloo with CUDA tensors, both ranks on the one card; a config of
    ``layers`` x ``hidden`` (``heads`` heads, MLP ``inter``, vocab 32000)
    and ``[2, seq]`` tokens a rank (``[1, 2 seq]`` for ring attention).

    Runs the cases ``names`` in order and writes each one's result to
    ``root`` as it ends: gloo aborts the process on a transfer it cannot
    make (a CUDA pointer handed to ``writev``), so the parent reads what
    the earlier cases left and quotes the abort from this rank's stderr,
    which goes to ``root/rank<r>.err``."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.models import LlamaPipelineTrainer
    from paddle_tpu_torch.optimizer import AdamW

    r = int(os.environ["PADDLE_TRAINER_ID"])
    sys.stderr.flush()
    os.dup2(os.open(os.path.join(root, f"rank{r}.err"),
                    os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644), 2)
    t0 = time.monotonic()
    dist.init_parallel_env(backend="gloo")
    set_flags({"FLAGS_collective_timeout_s": DIST_TIMEOUT_S})
    dev = dist.parallel.env_device()
    _dist_write(root, r, "init", {
        "init_s": round(time.monotonic() - t0, 2), "device": str(dev),
        "backend": torch.distributed.get_backend()})
    cfg = train_config(layers, hidden, heads, inter, seq)
    data = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, 32000, (4, seq), device=dev, generator=data)
    y = torch.randint(0, 32000, (4, seq), device=dev, generator=data)
    cfg_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    mesh_launches: dict = {}

    @contextlib.contextmanager
    def tally():
        """Count the launches of the mesh runs (not of their world-1
        references)."""
        before = K.launch_counts()
        try:
            yield
        finally:
            for k, n in K.launch_counts().items():
                mesh_launches[k] = mesh_launches.get(k, 0) + n - before[k]

    refs: dict = {}

    def reference(rows, dtype):
        """The world-1 run (no mesh) of the same weights and the first
        ``rows`` rows of the batch, computing in ``dtype``."""
        if (rows, dtype) not in refs:
            refs.clear()
            free()
            tr = LlamaPipelineTrainer(cfg, None, AdamW(learning_rate=1e-4),
                                      n_micro=1, compute_dtype=dtype,
                                      generator=gen())
            loss = tr.loss_and_grads(x[:rows], y[:rows]).item()
            refs[rows, dtype] = loss, {n: p.grad
                                       for n, p in tr.named_parameters()}
        return refs[rows, dtype]

    def held(degrees, rows, n_micro=1, dtype=cfg_dtype, **kw):
        def run():
            ref = reference(rows, dtype)
            mesh = dist.build_mesh(degrees=degrees)
            tr = LlamaPipelineTrainer(cfg, mesh, AdamW(learning_rate=1e-4),
                                      n_micro=n_micro, zero_stage=1,
                                      compute_dtype=dtype, generator=gen(),
                                      **kw)
            sync()
            t = time.monotonic()
            with tally():
                loss = tr.loss_and_grads(x[:rows], y[:rows]).item()
            sync()
            step_s = time.monotonic() - t
            worst, worst_name = 0.0, None
            for n, p in tr.named_parameters():
                e = _rel_l2(p.grad, tr.shard_of(n, ref[1][n]))
                if e > worst:
                    worst, worst_name = e, n
            return {"loss": loss, "ref_loss": ref[0],
                    "loss_rel": abs(loss - ref[0]) / abs(ref[0]),
                    "grad_rel_l2": worst, "worst": worst_name,
                    "step_s": round(step_s, 3)}
        return run

    def sep():
        from paddle_tpu_torch.distributed.mesh import (
            HybridCommunicateGroup, set_hybrid_communicate_group)

        refs.clear()
        free()
        set_hybrid_communicate_group(HybridCommunicateGroup(
            None, dist.build_mesh(degrees={"sep": 2})))
        g = torch.Generator(device=dev).manual_seed(2)
        q, k, v, do = (torch.randn(1, 2 * seq, heads, hidden // heads,
                                   device=dev, generator=g,
                                   dtype=cfg_dtype)
                       for _ in range(4))
        blk = slice(r * seq, (r + 1) * seq)
        want = [t.detach().requires_grad_() for t in (q, k, v)]
        o_full, _ = flash_attention_fwd(*want, causal=True)
        (o_full.float() * do.float()).sum().backward()
        mine = [t[:, blk].detach().clone().requires_grad_() for t in (q, k, v)]
        sync()
        t = time.monotonic()
        with tally():
            o = dist.ring_attention(*mine, causal=True)
            (o.float() * do[:, blk].float()).sum().backward()
        sync()
        res = {"step_s": round(time.monotonic() - t, 3),
               "out_rel_l2": _rel_l2(o, o_full[:, blk])}
        for name, a, b in zip(("dq", "dk", "dv"), mine, want):
            res[f"{name}_rel_l2"] = _rel_l2(a.grad, b.grad[:, blk])
        return res

    def checkpoint():
        refs.clear()
        free()
        mesh = dist.build_mesh(degrees={"mp": 2})
        tr = LlamaPipelineTrainer(cfg, mesh, AdamW(learning_rate=1e-4),
                                  n_micro=1, zero_stage=1, generator=gen())
        with tally():
            tr.step(x[:2], y[:2])
        path = os.path.join(root, "ckpt_mp2")
        t = time.monotonic()
        tr.save_checkpoint(path)
        save_s = time.monotonic() - t
        one = LlamaPipelineTrainer(cfg, None, AdamW(learning_rate=1e-4),
                                   n_micro=1, generator=gen())
        t = time.monotonic()
        _, extra = one.load_checkpoint(path)
        load_s = time.monotonic() - t
        worst = 0.0
        loaded = dict(one.named_parameters())
        for n, p in tr.named_parameters():
            want = tr.shard_of(n, loaded[n].detach())
            worst = max(worst, float((p.detach() - want).abs().max()))
        return {"max_abs_diff": worst, "step_count": extra["step_count"],
                "save_s": round(save_s, 2), "load_s": round(load_s, 2)}

    def nccl():
        set_flags({"FLAGS_collective_timeout_s": 30.0})
        os.environ["NCCL_DEBUG"] = "WARN"   # its error then names the reason
        pg = torch.distributed.new_group(backend="nccl")
        t = torch.ones(1, device=dev)
        C.all_reduce(t, group=C.Group(pg))
        sync()
        return {"sum": float(t.item())}

    cases = {"dp": held({"dp": 2}, 4), "mp": held({"mp": 2}, 2),
             "mp_f32": held({"mp": 2}, 2, dtype=torch.float32),
             "checkpoint": checkpoint,
             "pp": held({"pp": 2}, 4, n_micro=4, pp_schedule="1f1b"),
             "sep": sep, "nccl_two_ranks_one_card": nccl}
    for name in names:
        print(f"[distributed] rank {r}: {name}", file=sys.stderr, flush=True)
        mesh_launches.clear()
        res = _gloo_case(name, cases[name])
        res["launches"] = {k: n for k, n in mesh_launches.items() if n}
        _dist_write(root, r, name, res)
        free()


def _dist_abort(root, rank, name):
    """What this rank's stderr says after it began ``name``: the lines
    naming the abort (C++ ``terminate``, an error), else its last lines."""
    try:
        with open(os.path.join(root, f"rank{rank}.err")) as f:
            text = f.read()
    except FileNotFoundError:
        return ""
    text = text.split(f"[distributed] rank {rank}: {name}\n")[-1]
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    picked = [ln for ln in lines if "terminate called" in ln
              or "what():" in ln or "Error" in ln or "error" in ln]
    return " | ".join((picked or lines)[-3:])[:600]


def distributed_phase(torch, K, cpu=False, dims=None):
    """[distributed]: two ranks on the one card (the port's ``spawn``,
    ``backend="gloo"``, CUDA tensors), each case held to a world-1 run of
    the same weights and batch, or reported with gloo's own refusal.

    A case that gloo refuses by aborting the rank ends that pair of
    ranks; a new pair runs the cases after it. ``cpu=True`` with small
    ``dims`` (layers, hidden, heads, inter, seq) rehearses the phase on
    the CPU."""
    import shutil

    from paddle_tpu_torch.distributed import spawn

    dims = dims or (DIST_LAYERS, 4096, 32, 11008, DIST_SEQ)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "paddle_tpu_torch", "csrc", "build",
                        "dist_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    print(f"[distributed] 2 ranks on the one card over gloo (CUDA tensors "
          f"staged through host memory by gloo, not NVLink): Llama-2-7B "
          f"widths cut to {dims[0]} layers, [2, {dims[4]}] tokens a "
          f"rank; dp=2, mp=2, pp=2 (1F1B, 4 micro-batches) against a "
          f"world-1 run of the same weights and batch (loss within "
          f"{STEP_LOSS_TOL}, every gradient within {STEP_GRAD_REL_L2} "
          f"relative L2), mp=2 in f32 against an f32 world-1 run (loss "
          f"within {DIST_F32_LOSS_TOL}, gradients within "
          f"{DIST_F32_GRAD_REL_L2}), a checkpoint saved at mp=2 loaded at "
          f"world size 1, sep=2 ring attention [1, {2 * dims[4]}, {dims[2]}, "
          f"{dims[1] // dims[2]}] causal against one-card flash")
    where = {"device": "cpu"} if cpu else {"backend": "gloo"}
    t0 = time.monotonic()
    deadline = t0 + DIST_JOIN_S       # for every pair together
    remaining = list(DIST_CASES)
    per_case: dict = {}
    pairs = 0
    try:
        while remaining:
            pairs += 1
            ctx = spawn(distributed_rank, args=(root, tuple(remaining), *dims),
                        nprocs=2, join=False,
                        init_method=f"file://{root}/rdzv{pairs}",
                        env={"OMP_NUM_THREADS": "4"}, **where)
            ended = None
            try:
                # until both ranks exit, one dies, or every case is in (a
                # rank's NCCL probe may hang its exit: it is stopped below)
                while ended is None:
                    try:
                        if ctx.join(timeout=1.0):
                            ended = "both ranks exited 0"
                    except RuntimeError as e:
                        ended = str(e).splitlines()[0]
                    if ended is None and all(
                            _dist_read(root, rk, n) is not None
                            for n in remaining for rk in range(2)):
                        ended = "every case in"
                    if ended is None and time.monotonic() > deadline:
                        ended = f"still running {DIST_JOIN_S} s after the "\
                                f"first pair started"
            finally:
                ctx.terminate()
            init = [_dist_read(root, rk, "init") for rk in range(2)]
            if any(i is None for i in init):
                raise AssertionError(f"[distributed] pair {pairs}: a rank did "
                                     f"not join ({ended}): "
                                     f"{[_dist_abort(root, rk, '') for rk in range(2)]}")
            print(f"  pair {pairs} for {remaining}: backend "
                  f"{init[0]['backend']}, devices {init[0]['device']} and "
                  f"{init[1]['device']}, joined in {init[0]['init_s']} / "
                  f"{init[1]['init_s']} s; ended: {ended}")
            for rk in range(2):
                os.remove(_dist_file(root, rk, "init"))
            for name in list(remaining):
                per = [_dist_read(root, rk, name) for rk in range(2)]
                remaining.remove(name)
                if all(p is not None for p in per):
                    per_case[name] = per
                    continue
                # this case ended the pair: quote each rank's abort
                for rk in range(2):
                    if per[rk] is None:
                        said = _dist_abort(root, rk, name) or ended
                        per[rk] = {"ok": False, "error": said,
                                   "where": ["the rank ended: " + ended],
                                   "seconds": None}
                per_case[name] = per
                break
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.monotonic() - t0
    carried, refused = [], []
    launches: dict = {}
    partial: dict = {}
    for name in DIST_CASES:
        per = per_case[name]
        secs = max((c["seconds"] or 0.0) for c in per)
        if all(c["ok"] for c in per):
            print(f"  {name}: carried in {secs} s: "
                  f"{json.dumps([{k: v for k, v in c.items() if k not in ('ok', 'launches')} for c in per])}")
            carried.append(name)
            if name == "nccl_two_ranks_one_card":
                continue
            for c in per:
                for k, n in c.get("launches", {}).items():
                    launches[k] = launches.get(k, 0) + n
                loss_tol, grad_tol = (
                    (DIST_F32_LOSS_TOL, DIST_F32_GRAD_REL_L2)
                    if name == "mp_f32" else
                    (STEP_LOSS_TOL, STEP_GRAD_REL_L2))
                if name in ("dp", "pp", "mp", "mp_f32") and (
                        c["loss_rel"] > loss_tol
                        or c["grad_rel_l2"] > grad_tol):
                    raise AssertionError(f"[distributed] {name} disagrees "
                                         f"with the world-1 run: {c}")
                if name == "sep" and (
                        c["out_rel_l2"] > STEP_LOSS_TOL or
                        max(c[f"{g}_rel_l2"] for g in ("dq", "dk", "dv"))
                        > STEP_GRAD_REL_L2):
                    raise AssertionError(f"[distributed] ring attention "
                                         f"disagrees with flash: {c}")
                if name == "checkpoint" and c["max_abs_diff"] != 0.0:
                    raise AssertionError(f"[distributed] the checkpoint did "
                                         f"not load back exactly: {c}")
            continue
        errors = [c.get("error") or "" for c in per if not c["ok"]]
        print(f"  {name}: refused after {secs} s: " + " | ".join(errors))
        print(f"    where: {[c.get('where') for c in per]}")
        refused.append(name)
        if name == "nccl_two_ranks_one_card":
            continue
        for c in per:
            for k, n in c.get("launches", {}).items():
                partial[k] = partial.get(k, 0) + n
        # gloo's own refusal on one rank at least, the peer's closed
        # connection at most on the other: anything else is a fault
        if not any(GLOO_REFUSAL.search(e) for e in errors) or not all(
                GLOO_REFUSAL.search(e) or GLOO_PEER_CLOSED.search(e)
                for e in errors):
            raise AssertionError(f"[distributed] {name} failed, and not by "
                                 f"gloo's refusal of a CUDA tensor: "
                                 f"{errors}")
    print(f"[distributed] gloo carried {carried}; refused {refused}; "
          f"{pairs} pairs of ranks; {wall:.1f} s")
    print(f"  launches of the carried cases' mesh runs on both ranks: "
          f"{launches}")
    print(f"  launches of the refused cases before gloo refused them (not "
          f"counted): {partial}")
    return launches


def ernie_batch(torch, B, S, vocab, seed, device):
    """Seeded MLM batch: token ids, 15 % of positions carry their token as
    the label (the rest -100) and show the [MASK] id 3 in the input."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(5, vocab, (B, S), device=device, generator=gen)
    masked = torch.rand(B, S, device=device, generator=gen) < 0.15
    labels = torch.where(masked, ids, -100)
    return torch.where(masked, 3, ids), labels


def mlm_loss(F, model, x, y):
    logits = model(x)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))


def whole_step_ernie(torch, K):
    """One ERNIE MLM step (forward, backward, AdamW over LinearWarmup with
    global-norm clipping) under auto_cast(O1, bf16) on the card, against
    the same f32 weights in f32 on the CPU through the plain versions,
    with the same attention-dropout seeds (drawn on the host after
    framework.seed)."""
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.models import ErnieConfig, ErnieForMaskedLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW, LinearWarmup

    cfg = ErnieConfig(vocab_size=40000, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=1024,
                      max_position_embeddings=512, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=ERNIE_DROPOUT)
    print("[whole step ernie] hidden 256, 4 heads of 64, 2 layers, vocab "
          "40000, batch 2 x 512, attention dropout 0.1: O1 bf16 on the card "
          "vs f32 on the CPU")
    card = ErnieForMaskedLM(cfg, seed=1)
    cpu = ErnieForMaskedLM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x, y = ernie_batch(torch, 2, 512, 40000, 3, "cpu")
    losses, grads, launched = [], [], None
    for model in (card, cpu):
        dev = model.ernie.device
        opt = AdamW(learning_rate=LinearWarmup(1e-4, 2, 1e-5, 1e-4),
                    parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        framework.seed(5)
        K.reset_launch_counts()
        with amp.auto_cast(enable=dev.type == "cuda", level="O1"):
            loss = mlm_loss(F, model, x.to(dev), y.to(dev))
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launched = K.launch_counts()
        losses.append(loss.item())
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
        opt.step()
        opt.clear_grad()
        framework.seed(6)
        with amp.auto_cast(enable=dev.type == "cuda", level="O1"), \
                torch.no_grad():
            losses.append(mlm_loss(F, model, x.to(dev), y.to(dev)).item())
    needed = {k: v for k, v in ERNIE_PER_STEP.items() if v}
    missing = [k for k in needed if launched[k] == 0]
    if missing:
        raise AssertionError(f"the card's ERNIE step never launched "
                             f"{missing}")
    if set(grads[0]) != set(grads[1]):
        raise AssertionError("the card and the CPU gave gradients to "
                             "different parameters")
    # the key projection's bias adds q . b_k to every score of a row, which
    # the softmax cancels (with dropout too: each row of dS sums to 0), so
    # its exact gradient is 0 and each side holds only its rounding noise,
    # a sum over tokens of the rounding of dK. Against its own side's key
    # weight gradient, a sum of the same dK times activations, that noise
    # is ~1e-4 in bf16 (bf16 step 2^-9 over sqrt(hidden)); rows of dS that
    # do not sum to 0 (a mask that differs between P and dP) would give
    # ~1/sqrt(hidden) = 6e-2. Held below 1e-2.
    key_noise = {}
    for n in [n for n in grads[1] if n.endswith("self_attn.k_proj.bias")]:
        w = n.replace("bias", "weight")
        ratio = [g.pop(n).norm().item() / g[w].norm().item() for g in grads]
        key_noise[n] = ratio
        if not max(ratio) <= 1e-2:
            raise AssertionError(f"whole ERNIE step: {n}'s gradient, 0 in "
                                 f"exact arithmetic, has {ratio} of the key "
                                 f"weight gradient's norm (card, CPU)")
    print("  key-bias gradients (0 in exact arithmetic), norm over the key "
          "weight gradient's, card / CPU: "
          + ", ".join(f"layer {n.split('.')[3]} {a:.2e} / {b:.2e}"
                      for n, (a, b) in key_noise.items()))
    rel = {n: ((grads[0][n] - g).norm() / g.norm()).item()
           for n, g in grads[1].items()}
    worst = sorted(rel.items(), key=lambda r: -r[1])[:3]
    print(f"  loss {losses[0]:.5f} on the card, {losses[2]:.5f} on the CPU "
          f"(|diff| {abs(losses[0] - losses[2]):.2e}, limit "
          f"{STEP_LOSS_TOL}); after the AdamW step {losses[1]:.5f} / "
          f"{losses[3]:.5f}; worst gradient relative L2 errors "
          + ", ".join(f"{n} {e:.2e}" for n, e in worst)
          + f" (limit {STEP_GRAD_REL_L2}, {len(rel)} parameters); launches "
          f"{ {k: v for k, v in launched.items() if v} }")
    for a, b in ((losses[0], losses[2]), (losses[1], losses[3])):
        if not abs(a - b) <= STEP_LOSS_TOL:
            raise AssertionError(f"whole ERNIE step: loss {a} vs {b}")
    if not worst[0][1] <= STEP_GRAD_REL_L2:
        raise AssertionError(f"whole ERNIE step: gradient of {worst[0][0]} "
                             f"off by {worst[0][1]} in relative L2")


def ernie_flops_per_token(cfg, S):
    """Training flops a token: 6 x the parameters of the token-wise matmuls
    (per layer the four attention projections and the two MLP matrices,
    then the MLM transform and decoder) + 12 S hidden per layer for the
    score and P.V products (forward and backward)."""
    h, L = cfg.hidden_size, cfg.num_hidden_layers
    params = L * (4 * h * h + 2 * h * cfg.intermediate_size) \
        + h * h + h * cfg.vocab_size
    return 6 * params + 12 * S * h * L


def ernie_training_phase(torch, K):
    """ERNIE-3.0-Base MLM pretraining at its published width and depth."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.models import ErnieForMaskedLM, ernie_base
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW, LinearWarmup

    B, S = 16, 512
    cfg = ernie_base()
    print(f"[ernie] ERNIE-3.0-Base (12 layers, hidden 768, 12 heads, inter "
          f"3072, vocab 40000, dropout 0.1 / 0.1), batch {B} x {S}, f32 "
          f"params under auto_cast(O1, bf16), AdamW lr 1e-4 over "
          f"LinearWarmup, ClipGradByGlobalNorm(1.0)")
    framework.seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = ErnieForMaskedLM(cfg, seed=0)
    sched = LinearWarmup(1e-4, warmup_steps=4, start_lr=1e-5, end_lr=1e-4)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    x, y = ernie_batch(torch, B, S, cfg.vocab_size, 1, "cuda")
    print(f"  {model.num_params() / 1e6:.1f} M parameters, "
          f"{int((y != -100).sum())} labelled positions")

    def step():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = mlm_loss(F, model, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss

    t0 = time.monotonic()
    losses = [step().item()]                      # warm-up
    print(f"  warm-up step {time.monotonic() - t0:.2f}s, loss "
          f"{losses[0]:.4f}")
    K.reset_launch_counts()
    walls = []
    for _ in range(ERNIE_STEPS):
        t0 = time.monotonic()
        losses.append(step().item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {[round(v, 4) for v in losses]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite ERNIE loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the ERNIE loss did not fall: {losses}")
    per_step = {k: counts[k] / ERNIE_STEPS for k in ERNIE_PER_STEP}
    print(f"  launches per step: {per_step} (expected {ERNIE_PER_STEP})")
    all_sm90("the ERNIE steps", counts)
    if per_step != {k: float(v) for k, v in ERNIE_PER_STEP.items()}:
        raise AssertionError("the ERNIE steps launched other kernels than "
                             "the model's structure gives")
    mean = sum(walls) / len(walls)
    tok_s = B * S / mean
    flops = ernie_flops_per_token(cfg, S)
    print(f"  step wall {mean * 1e3:.1f} ms (mean of {ERNIE_STEPS}, min "
          f"{min(walls) * 1e3:.1f}); {tok_s:.0f} tokens/s; MFU "
          f"{100 * tok_s * flops / BF16_FLOPS:.1f}% ({flops / 1e9:.3f} "
          f"GFLOP/token against {BF16_FLOPS / 1e12:.0f} TFLOP/s); peak "
          f"memory {peak / 2 ** 30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiled ERNIE step traced no kernel")
    busy = busy_ms(kernels)
    print(f"[profile] one ERNIE step: device busy {busy:.2f} ms in "
          f"{len(kernels)} kernels, wall {prof_wall:.2f} ms under the "
          f"profiler (unprofiled mean {mean * 1e3:.2f} ms), idle "
          f"{100 * (1 - busy / prof_wall):.1f}% of the profiled wall, "
          f"{100 * (1 - busy / (mean * 1e3)):.1f}% of the unprofiled mean")
    for group, ms in kernel_share(kernels).items():
        print(f"  {ms:9.3f} ms  {group}")
    per_name: dict[str, list] = {}
    for k in kernels:
        acc = per_name.setdefault(k.name, [0.0, 0])
        acc[0] += (k.time_range.end - k.time_range.start) / 1e3
        acc[1] += 1
    for name, (ms, n) in sorted(per_name.items(), key=lambda r: -r[1][0])[:12]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    # one more step, split: forward, backward, then clipping and AdamW
    marks = [time.monotonic()]
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = mlm_loss(F, model, x, y)
    for part in (loss.backward, opt.step):
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        part()
    torch.cuda.synchronize()
    marks.append(time.monotonic())
    opt.clear_grad()
    fwd, bwd, upd = (1e3 * (b - a) for a, b in zip(marks, marks[1:]))
    print(f"  one step split: forward {fwd:.1f} ms, backward {bwd:.1f} ms, "
          f"clip + AdamW update {upd:.1f} ms")
    del model, opt
    return counts


def conformer_batch(torch, B, T, cfg, L, seed, device):
    """Seeded features [B, T, input_dim], labels from 1..vocab-1 [B, L],
    label lengths over L/2..L and input lengths over 3/4..1 of the
    subsampled T' = T / 4."""
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn(B, T, cfg.input_dim, generator=gen)
    labels = torch.randint(1, cfg.vocab_size, (B, L), generator=gen)
    t2 = (T + 3) // 4
    in_len = torch.randint(3 * t2 // 4, t2 + 1, (B,), generator=gen)
    lbl_len = torch.randint(L // 2, L + 1, (B,), generator=gen)
    return [t.to(device) for t in (feats, labels, in_len, lbl_len)]


def conformer_head(head):
    """``(model class, loss of (model, feats, labels, in_len, lbl_len,
    per_frame), expected launches per step of the 4-layer model)`` of the
    Conformer's CTC or RNN-T head."""
    from paddle_tpu_torch.models import ConformerForCTC, ConformerForRNNT
    from paddle_tpu_torch.nn.functional import ctc_loss, rnnt_loss

    if head == "ctc":
        def loss(model, feats, labels, in_len, lbl_len, per_frame=False):
            return ctc_loss(model(feats), labels, in_len, lbl_len,
                            norm_by_times=per_frame)
        return ConformerForCTC, loss, CONFORMER_PER_STEP

    def loss(model, feats, labels, in_len, lbl_len, per_frame=False):
        out = rnnt_loss(model(feats, labels), labels, in_len, lbl_len,
                        reduction="none" if per_frame else "mean")
        return (out / in_len.to(out.device)).mean() if per_frame else out
    return ConformerForRNNT, loss, RNNT_PER_STEP


def whole_step_conformer(torch, K, head="ctc"):
    """One Conformer step (forward, loss, backward) with the CTC or the
    RNN-T head under auto_cast(O1, bf16) on the card against the same f32
    weights in f32 on the CPU through the plain versions, with the same
    attention-dropout seeds. Hidden dropout is 0 on both sides (its masks
    come from each device's generator); the attention keeps p 0.1. The
    loss is per frame (CTC: ``norm_by_times``; RNN-T: each utterance's
    loss over its input length, then the batch mean), so it is of the size
    of the ERNIE check's and STEP_LOSS_TOL means the same there."""
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.models import ConformerConfig
    from paddle_tpu_torch.nn import Dropout

    Model, loss_fn, per_layers = conformer_head(head)
    tag = "conformer" if head == "ctc" else "rnnt"
    cfg = ConformerConfig(hidden=144, num_layers=2, num_heads=4,
                          conv_kernel=15, vocab_size=128,
                          dropout=CONFORMER_DROPOUT)
    print(f"[whole step {tag}] {Model.__name__} at hidden 144, 4 heads of "
          f"36, 2 layers, conv kernel 15, vocab 128, 4 utterances of 400 "
          f"frames, labels of 10-20, attention dropout 0.1: O1 bf16 on the "
          f"card vs f32 on the CPU")
    card = Model(cfg, seed=1)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    feats, labels, in_len, lbl_len = conformer_batch(torch, 4, 400, cfg, 20,
                                                     3, "cpu")
    losses, grads, bufs, launched = [], [], [], None
    for model in (card, cpu):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        dev = model.device
        framework.seed(5)
        K.reset_launch_counts()
        with amp.auto_cast(enable=dev.type == "cuda", level="O1"):
            loss = loss_fn(model, feats.to(dev), labels.to(dev), in_len,
                           lbl_len, per_frame=True)
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launched = K.launch_counts()
        losses.append(loss.item())
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()})
        bufs.append({n: b.float().cpu() for n, b in model.named_buffers()})
    per_step = {k: v for k, v in launched.items() if v}
    # 2 of the 4 layers: half the per-layer kernels, one loss's pair
    want = {k: v // 2 if k in ("layernorm", "flash_attention_dropout",
                               "flash_attention_bwd_dropout",
                               "flash_attention_sm90",
                               "flash_attention_bwd_sm90") else v
            for k, v in per_layers.items()}
    if per_step != want:
        raise AssertionError(f"the card's {tag} step launched {per_step}, "
                             f"expected {want}")
    # exactly 0 in exact arithmetic, so each side holds rounding noise:
    # the key projections' biases (the softmax cancels a per-row constant,
    # with dropout too) and the depthwise convolutions' biases (training
    # batch norm cancels a per-channel constant). Held below 1e-2 of their
    # side's weight gradient's norm, as the ERNIE check holds its key biases.
    noise = {}
    for n in [n for n in grads[1] if n.endswith(("attn.k_proj.bias",
                                                  "conv.dw.bias"))]:
        w = n.replace("bias", "weight")
        ratio = [gr.pop(n).norm().item() / gr[w].norm().item()
                 for gr in grads]
        noise[n] = ratio
        if not max(ratio) <= 1e-2:
            raise AssertionError(f"whole {tag} step: {n}'s gradient, 0 in "
                                 f"exact arithmetic, has {ratio} of its "
                                 f"weight gradient's norm (card, CPU)")
    print("  biases with a gradient of 0 in exact arithmetic, norm over "
          "their weight gradient's, card / CPU: "
          + ", ".join(f"{n.split('.', 2)[2]} {a:.2e} / {b:.2e}"
                      for n, (a, b) in noise.items()))
    rel = {n: ((grads[0][n] - gr).norm() / gr.norm()).item()
           for n, gr in grads[1].items()}
    worst = sorted(rel.items(), key=lambda r: -r[1])[:3]
    bn = {n: ((bufs[0][n] - b).norm() / b.norm()).item()
          for n, b in bufs[1].items()}
    worst_bn = max(bn.items(), key=lambda r: r[1])
    if head == "rnnt":
        print("  predictor and embedding gradients, relative L2: "
              + ", ".join(f"{n} {e:.2e}" for n, e in rel.items()
                          if n.startswith(("predictor", "embed"))))
    print(f"  per-frame loss {losses[0]:.5f} on the card, {losses[1]:.5f} on "
          f"the CPU (|diff| {abs(losses[0] - losses[1]):.2e}, limit "
          f"{STEP_LOSS_TOL}); worst gradient relative L2 errors "
          + ", ".join(f"{n} {e:.2e}" for n, e in worst)
          + f" (limit {STEP_GRAD_REL_L2}, {len(rel)} parameters); batch-norm "
          f"buffers after the step: worst relative L2 {worst_bn[1]:.2e} "
          f"({worst_bn[0]}, limit {BN_REL_L2}, {len(bn)} buffers); launches "
          f"{per_step}")
    if not abs(losses[0] - losses[1]) <= STEP_LOSS_TOL:
        raise AssertionError(f"whole {tag} step: loss {losses}")
    if not worst[0][1] <= STEP_GRAD_REL_L2:
        raise AssertionError(f"whole {tag} step: gradient of {worst[0][0]} "
                             f"off by {worst[0][1]}")
    if not worst_bn[1] <= BN_REL_L2:
        raise AssertionError(f"whole {tag} step: buffer {worst_bn[0]} off "
                             f"by {worst_bn[1]}")


def conformer_flops_per_utterance(cfg, T, U1=None):
    """Training flops an utterance of T frames (3x the forward's): the two
    subsampling convolutions and the projection; per block the four
    feed-forward matrices, the four attention projections, the score and
    P.V products, the two pointwise and the depthwise convolutions; then
    the CTC head, or, with ``U1`` label positions (U + 1), the RNN-T head:
    the encoder projection, the LSTM predictor (input and recurrent
    products) and the joint ``2 T' U1 h V``."""
    h, k, V = cfg.hidden, cfg.conv_kernel, cfg.vocab_size
    t1, f1 = (T + 1) // 2, (cfg.input_dim + 1) // 2
    t2, f2 = (t1 + 1) // 2, (f1 + 1) // 2
    front = 2 * 9 * h * t1 * f1 + 2 * 9 * h * h * t2 * f2 \
        + 2 * t2 * (h * f2) * h
    block = (2 * 2 * 2 * t2 * h * cfg.ff_mult * h      # two feed-forwards
             + 4 * 2 * t2 * h * h                       # q, k, v, out
             + 2 * 2 * t2 * t2 * h                      # scores and P.V
             + 2 * t2 * h * 2 * h + 2 * t2 * h * k      # pw1, depthwise
             + 2 * t2 * h * h)                          # pw2
    if U1 is None:
        head = 2 * t2 * h * V
    else:   # predictor width = hidden (the default)
        head = (2 * t2 * h * h + U1 * 2 * (2 * h * 4 * h)
                + 2 * t2 * U1 * h * V)
    return 3 * (front + cfg.num_layers * block + head)


def conformer_training_phase(torch, K, head="ctc"):
    """The Conformer with the CTC or the RNN-T head at the repo's
    configuration (tools/model_bench.py's ConformerConfig()), published
    dropout kept, 16 utterances of 1600 frames."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.models import ConformerConfig
    from paddle_tpu_torch.optimizer import AdamW

    Model, loss_fn, per_layers = conformer_head(head)
    tag = "conformer" if head == "ctc" else "conformer rnnt"
    B, T, L = 16, 1600, 48
    cfg = ConformerConfig()
    print(f"[{tag}] {Model.__name__}(ConformerConfig()) (input 80 mels, "
          f"hidden 144, 4 layers, 4 heads of 36, ff_mult 4, conv kernel 15, "
          f"vocab 128 with blank 0, subsample 4, dropout {cfg.dropout}"
          + (", predictor LSTM 144" if head == "rnnt" else "")
          + f"), {B} utterances of {T} frames, f32 params under "
          f"auto_cast(O1, bf16), AdamW lr 1e-3, weight decay 0.01")
    framework.seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    feats, labels, in_len, lbl_len = conformer_batch(torch, B, T, cfg, L, 1,
                                                     "cuda")
    print(f"  {model.num_params() / 1e6:.2f} M parameters; input lengths "
          f"{in_len.min().item()}-{in_len.max().item()} of "
          f"{(T + 3) // 4}, label lengths "
          f"{lbl_len.min().item()}-{lbl_len.max().item()}")

    def forward():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return loss_fn(model, feats, labels, in_len, lbl_len)

    def step():
        loss = forward()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    t0 = time.monotonic()
    losses = [step().item()]                      # warm-up
    print(f"  warm-up step {time.monotonic() - t0:.2f}s, loss "
          f"{losses[0]:.4f}")
    K.reset_launch_counts()
    walls = []
    for _ in range(CONFORMER_STEPS):
        t0 = time.monotonic()
        losses.append(step().item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {[round(v, 3) for v in losses]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite {tag} loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the {tag} loss did not fall: {losses}")
    per_step = {k: v / CONFORMER_STEPS for k, v in counts.items()}
    want = {k: float(per_layers.get(k, 0)) for k in counts}
    print(f"  launches per step: "
          f"{ {k: v for k, v in per_step.items() if v} } (expected "
          f"{per_layers}, every other kernel 0)")
    if per_step != want:
        raise AssertionError(f"the {tag} steps launched other kernels than "
                             f"the model's structure gives")
    all_sm90(f"the {tag} steps", counts)
    mean = sum(walls) / len(walls)
    flops = conformer_flops_per_utterance(
        cfg, T, None if head == "ctc" else L + 1)
    print(f"  step wall {mean * 1e3:.1f} ms (mean of {CONFORMER_STEPS}, min "
          f"{min(walls) * 1e3:.1f}); {B / mean:.1f} utterances/s; MFU "
          f"{100 * B / mean * flops / BF16_FLOPS:.2f}% "
          f"({flops / 1e9:.2f} GFLOP an utterance against "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s); peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError(f"the profiled {tag} step traced no kernel")
    busy = busy_ms(kernels)
    print(f"[profile] one {tag} step: device busy {busy:.2f} ms in "
          f"{len(kernels)} kernels, wall {prof_wall:.2f} ms under the "
          f"profiler (unprofiled mean {mean * 1e3:.2f} ms), idle "
          f"{100 * (1 - busy / prof_wall):.1f}% of the profiled wall, "
          f"{100 * (1 - busy / (mean * 1e3)):.1f}% of the unprofiled mean")
    print(f"  {'the host' if busy < 0.5 * mean * 1e3 else 'the device'} sets "
          f"the step wall: the device is busy {busy:.2f} of its "
          f"{mean * 1e3:.2f} ms")
    for group, ms in kernel_share(kernels).items():
        print(f"  {ms:9.3f} ms  {group}")
    per_name: dict[str, list] = {}
    for k in kernels:
        acc = per_name.setdefault(k.name, [0.0, 0])
        acc[0] += (k.time_range.end - k.time_range.start) / 1e3
        acc[1] += 1
    for name, (ms, n) in sorted(per_name.items(), key=lambda r: -r[1][0])[:12]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    # one more step, split: forward, backward, then the AdamW update
    marks = [time.monotonic()]
    loss = forward()
    for part in (loss.backward, opt.step):
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        part()
    torch.cuda.synchronize()
    marks.append(time.monotonic())
    opt.clear_grad()
    fwd, bwd, upd = (1e3 * (b - a) for a, b in zip(marks, marks[1:]))
    print(f"  one step split: forward {fwd:.1f} ms, backward {bwd:.1f} ms, "
          f"AdamW update {upd:.1f} ms")
    del model, opt
    return counts


# ---------------------------------------------------------------------------
# Whisper slice: Whisper-base served and trained, the seq2seq decoder
# ---------------------------------------------------------------------------

def whisper_mel(torch, B, T, n_mels, seed, device):
    """Seeded synthetic log-mel ``[B, n_mels, T]`` in Whisper's own scaling
    (log10 of the power, floored 8 below the maximum, then (x + 4) / 4)."""
    gen = torch.Generator().manual_seed(seed)
    power = torch.rand(B, n_mels, T, generator=gen) ** 4 + 1e-10
    log_spec = power.log10()
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).to(device)


def whisper_targets(torch, B, T, vocab, sot, seed, device):
    """Seeded token sequences of T + 1 tokens starting at ``sot``: the
    decoder's input ``[B, T]`` and its next-token targets ``[B, T]``."""
    gen = torch.Generator().manual_seed(seed)
    seq = torch.randint(3, vocab, (B, T + 1), generator=gen)
    seq[:, 0] = sot
    return seq[:, :-1].to(device), seq[:, 1:].to(device)


def whisper_loss(F, model, mel, tokens, targets):
    logits = model(mel, tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def whisper_per_generate(cfg, steps):
    """The launches of one ``generate`` that ran ``steps`` decode steps:
    the encoder's self-attention (one flash forward a layer) and its
    LayerNorms (two a layer and a final one); each step the decoder's
    self- and cross-attention (two flash forwards a layer: one query, no
    mask) and its LayerNorms (three a layer and a final one)."""
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    flash = Le + 2 * Ld * steps
    return {"flash_attention": flash, "flash_attention_sm90": flash,
            "layernorm": 2 * Le + 1 + (3 * Ld + 1) * steps}


def whisper_per_step(cfg):
    """Launches of one teacher-forced training step: a flash forward and
    backward for each encoder self-attention and each cross-attention (the
    decoder's self-attention takes the causal float mask: the einsum
    composition), every LayerNorm, one softmax-CE forward and backward."""
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    n = Le + Ld
    return {"flash_attention": n, "flash_attention_sm90": n,
            "flash_attention_bwd": n, "flash_attention_bwd_sm90": n,
            "layernorm": 2 * Le + 1 + 3 * Ld + 1, "softmax_ce": 1,
            "softmax_ce_bwd": 1}


def whisper_flops_per_utterance(cfg, T_mel, T_tok):
    """Training flops an utterance (3x the forward's 2 x multiply-adds):
    the two convolutions; per encoder layer the four projections, the FFN
    and the score and P.V products over the T_mel / 2 frames; per decoder
    layer, per token, the self-attention's four projections, the
    cross-attention's query and output projections, the FFN, the score
    and P.V products against the tokens and against the frames, and per
    frame the cross-attention's key and value projections; the vocabulary
    projection."""
    h, f, V = cfg.d_model, cfg.ffn_dim, cfg.vocab_size
    S = T_mel // 2
    enc = (T_mel * cfg.n_mels * 3 * h + S * 3 * h * h
           + cfg.encoder_layers * (S * (4 * h * h + 2 * h * f)
                                   + 2 * S * S * h))
    dec = (cfg.decoder_layers * (T_tok * (6 * h * h + 2 * h * f)
                                 + S * 2 * h * h
                                 + 2 * T_tok * T_tok * h + 2 * T_tok * S * h)
           + T_tok * h * V)
    return 6 * (enc + dec)


def profile_step(torch, fn, what, share=None, top=8):
    """One profiled call of ``fn``: its wall under the profiler, the device
    busy time (the union of the kernels' intervals), the kernels' device ms
    by group (``share``, default ``kernel_share``) and the ``top`` kernels
    by name; returns the busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError(f"the profiled {what} traced no kernel")
    busy = busy_ms(kernels)
    per_name: dict[str, list] = {}
    for k in kernels:
        acc = per_name.setdefault(k.name, [0.0, 0])
        acc[0] += (k.time_range.end - k.time_range.start) / 1e3
        acc[1] += 1
    print(f"[profile] one {what}: device busy {busy:.3f} ms in "
          f"{len(kernels)} kernels, wall {prof_wall:.2f} ms under the "
          f"profiler")
    for group, ms in (share or kernel_share)(kernels).items():
        print(f"  {ms:9.3f} ms  {group}")
    for name, (ms, n) in sorted(per_name.items(),
                                key=lambda r: -r[1][0])[:top]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    return busy


def whisper_serving_phase(torch, K):
    """Whisper-base (``WhisperConfig()``, nothing cut) in bf16 with random
    weights: greedy ``generate`` over 8 x 30 s of synthetic log-mel,
    WHISPER_NEW_TOKENS tokens; every token checked by teacher forcing;
    launches against the structure; the encoder's time, a decode step's
    time and tokens/s, one profiled decode step, peak memory. Returns the
    launches of ``generate`` and of the teacher-forced forward."""
    from paddle_tpu_torch.models import (WhisperConfig,
                                         WhisperForConditionalGeneration)

    cfg = WhisperConfig()
    B, T = WHISPER_SERVE_BATCH, 2 * cfg.max_source_positions
    print(f"[whisper] Whisper-base (n_mels {cfg.n_mels}, d_model "
          f"{cfg.d_model}, {cfg.encoder_layers} + {cfg.decoder_layers} "
          f"layers, {cfg.num_heads} heads of {cfg.d_model // cfg.num_heads}, "
          f"ffn {cfg.ffn_dim}, vocab {cfg.vocab_size}), bf16, random weights "
          f"from seed 0; {B} x 30 s of synthetic log-mel [{B}, {cfg.n_mels}, "
          f"{T}], generate(max_new_tokens={WHISPER_NEW_TOKENS})")
    torch.cuda.reset_peak_memory_stats()
    model = WhisperForConditionalGeneration(
        cfg, dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    mel = whisper_mel(torch, B, T, cfg.n_mels, 1, "cuda").bfloat16()
    print(f"  {model.num_params() / 1e6:.1f} M parameters")
    with torch.inference_mode():
        model.generate(mel, max_new_tokens=2)              # warm-up
        torch.cuda.synchronize()
        enc_ms = time_ms(torch, lambda: model.encoder(mel), iters=5,
                         warmup=1)
        K.reset_launch_counts()
        t0 = time.monotonic()
        out = model.generate(mel, max_new_tokens=WHISPER_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
        gen_launches = K.launch_counts()
    steps = out.shape[1] - 1
    want = whisper_per_generate(cfg, steps)
    got = {k: v for k, v in gen_launches.items() if v}
    print(f"  {steps} decode steps; launches {got} (expected {want})")
    if got != want:
        raise AssertionError("generate launched other kernels than the "
                             "model's structure gives")
    decode_ms = (wall - enc_ms) / steps
    print(f"  generate wall {wall:.1f} ms: encoder {enc_ms:.3f} ms (device "
          f"time, [{B}, {T // 2}, {cfg.d_model}] out), decode "
          f"{decode_ms:.3f} ms a token step (host clock), "
          f"{B * steps / ((wall - enc_ms) / 1e3):.1f} decode tokens/s")
    # teacher forcing: each generated token against the uncached forward
    eot = cfg.eot_token
    K.reset_launch_counts()
    with torch.inference_mode():
        logits = model(mel, out[:, :-1]).float()
    torch.cuda.synchronize()
    tf_launches = K.launch_counts()
    if not torch.isfinite(logits).all():
        raise AssertionError("whisper: non-finite teacher-forced logits")
    served = out[:, 1:]
    # a row's tokens after its first end-of-text are padding, not argmaxes
    ended = (served == eot).int().cumsum(1)
    live = (ended == 0) | ((ended == 1) & (served == eot))
    chosen = logits.gather(2, served[:, :, None])[:, :, 0]
    gap = (logits.max(2).values - chosen)[live]
    exact = int((logits.argmax(2) == served)[live].sum())
    total = int(live.sum())
    worst = gap.max().item()
    print(f"  teacher forcing: worst gap to the row max {worst:.4f} (limit "
          f"{TF_TOL}); {exact} of {total} generated tokens are the argmax "
          f"(need {TF_MIN_EXACT:.0%}); logits' row max mean "
          f"{logits.max(2).values.mean().item():.3f}")
    if worst > TF_TOL:
        raise AssertionError(f"whisper: a generated token's logit is {worst} "
                             f"below its row's max (limit {TF_TOL})")
    if exact < TF_MIN_EXACT * total:
        raise AssertionError(f"whisper: only {exact} of {total} generated "
                             f"tokens are the teacher-forced argmax")
    tf_want = whisper_per_step(cfg)
    tf_want = {k: tf_want[k] for k in ("flash_attention",
                                       "flash_attention_sm90", "layernorm")}
    tf_got = {k: v for k, v in tf_launches.items() if v}
    print(f"  launches on the teacher-forced forward: {tf_got}")
    if tf_got != tf_want:
        raise AssertionError(f"the teacher-forced forward launched {tf_got}, "
                             f"expected {tf_want}")
    # one decode step as generate runs it, unprofiled walls then profiled
    with torch.inference_mode():
        memory = model.encoder(mel)
        cache = model.decoder.layers.gen_cache(memory)
        cur = out[:, :1]
        state = {"cache": cache, "cur": cur, "step": 0}

        def decode_step():
            h, state["cache"] = model.decoder(state["cur"], memory,
                                              cache=state["cache"],
                                              pos_offset=state["step"])
            nxt = model.proj(h[:, -1]).argmax(-1).cpu()
            state["cur"] = nxt[:, None].to(memory.device)
            state["step"] += 1

        for _ in range(3):
            decode_step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.monotonic()
            decode_step()
            walls.append((time.monotonic() - t0) * 1e3)
        step_wall = sum(walls) / len(walls)
        busy = profile_step(torch, decode_step,
                            f"whisper decode step ({B} rows, context "
                            f"{state['step'] + 1})")
    print(f"  decode step wall {step_wall:.3f} ms (mean of 5 unprofiled, "
          f"min {min(walls):.3f}), device busy {busy:.3f} ms, idle "
          f"{100 * (1 - busy / step_wall):.1f}% of the unprofiled wall; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del model, memory, cache, state, logits
    return {k: gen_launches[k] + tf_launches[k] for k in gen_launches}


def whisper_training_phase(torch, K):
    """Teacher-forced training of Whisper-base (``WhisperConfig()``), f32
    parameters under auto_cast(O1, bf16), AdamW lr 1e-4, one repeated batch
    of 16 x 30 s with 224-token targets: a warm-up step and WHISPER_STEPS
    timed steps; losses finite and falling; launches per step against the
    structure; utterances/s, MFU, step wall, a profiled step, peak
    memory."""
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.models import (WhisperConfig,
                                         WhisperForConditionalGeneration)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    cfg = WhisperConfig()
    B, T, Tt = WHISPER_TRAIN_BATCH, 2 * cfg.max_source_positions, \
        WHISPER_TRAIN_TOKENS
    print(f"[whisper train] Whisper-base, batch {B} x 30 s ([{B}, "
          f"{cfg.n_mels}, {T}] log-mel), {Tt}-token targets, f32 params "
          f"under auto_cast(O1, bf16), AdamW lr 1e-4")
    framework.seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = WhisperForConditionalGeneration(cfg, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    mel = whisper_mel(torch, B, T, cfg.n_mels, 2, "cuda")
    tokens, targets = whisper_targets(torch, B, Tt, cfg.vocab_size,
                                      cfg.sot_token, 3, "cuda")

    def step():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = whisper_loss(F, model, mel, tokens, targets)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    t0 = time.monotonic()
    losses = [step().item()]
    print(f"  warm-up step {time.monotonic() - t0:.2f}s, loss "
          f"{losses[0]:.4f}")
    K.reset_launch_counts()
    walls = []
    for _ in range(WHISPER_STEPS):
        t0 = time.monotonic()
        losses.append(step().item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {[round(v, 4) for v in losses]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite Whisper loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the Whisper loss did not fall: {losses}")
    want = whisper_per_step(cfg)
    per_step = {k: c / WHISPER_STEPS for k, c in counts.items() if c}
    print(f"  launches per step: {per_step} (expected {want})")
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError("the Whisper steps launched other kernels than "
                             "the model's structure gives")
    all_sm90("the Whisper steps", counts)
    mean = sum(walls) / len(walls)
    utt_s = B / mean
    flops = whisper_flops_per_utterance(cfg, T, Tt)
    print(f"  step wall {mean * 1e3:.1f} ms (mean of {WHISPER_STEPS}, min "
          f"{min(walls) * 1e3:.1f}); {utt_s:.1f} utterances/s; MFU "
          f"{100 * utt_s * flops / BF16_FLOPS:.1f}% ({flops / 1e12:.3f} "
          f"TFLOP an utterance against {BF16_FLOPS / 1e12:.0f} TFLOP/s); "
          f"peak memory {peak / 2 ** 30:.2f} GiB")
    busy = profile_step(torch, step, "Whisper training step")
    print(f"  idle {100 * (1 - busy / (mean * 1e3)):.1f}% of the unprofiled "
          f"mean step wall")
    del model, opt
    return counts


def whole_step_whisper(torch, K):
    """One teacher-forced step of a narrow Whisper (d_model 256, 4 heads of
    64, 2 + 2 layers, ffn 1024, vocab 51865, 400 mel frames) under O1 on
    the card against f32 on the CPU through the plain versions, the same
    weights: the loss before and after an AdamW step within STEP_LOSS_TOL,
    every gradient within STEP_GRAD_REL_L2 relative L2 but the key
    projections' biases (0 in exact arithmetic: below 1e-2 of their
    weight gradient's norm on each side)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import (WhisperConfig,
                                         WhisperForConditionalGeneration)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    cfg = WhisperConfig(d_model=256, encoder_layers=2, decoder_layers=2,
                        num_heads=4, ffn_dim=1024)
    B, T, Tt = 2, 400, 64
    print(f"[whole step whisper] d_model 256, 4 heads of 64, 2 + 2 layers, "
          f"ffn 1024, vocab {cfg.vocab_size}, batch {B} x {T} mel frames, "
          f"{Tt} tokens: O1 bf16 on the card vs f32 on the CPU")
    card = WhisperForConditionalGeneration(cfg, seed=4)
    cpu = WhisperForConditionalGeneration(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    mel = whisper_mel(torch, B, T, cfg.n_mels, 5, "cpu")
    tokens, targets = whisper_targets(torch, B, Tt, cfg.vocab_size,
                                      cfg.sot_token, 6, "cpu")
    losses, grads, launched = [], [], None
    for model in (card, cpu):
        dev = model.device
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    weight_decay=0.01)
        K.reset_launch_counts()
        with amp.auto_cast(enable=dev.type == "cuda", level="O1"):
            loss = whisper_loss(F, model, mel.to(dev), tokens.to(dev),
                                targets.to(dev))
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launched = K.launch_counts()
        losses.append(loss.item())
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
        opt.step()
        opt.clear_grad()
        with amp.auto_cast(enable=dev.type == "cuda", level="O1"), \
                torch.no_grad():
            losses.append(whisper_loss(F, model, mel.to(dev), tokens.to(dev),
                                       targets.to(dev)).item())
    want = whisper_per_step(cfg)
    got = {k: v for k, v in launched.items() if v}
    if got != want:
        raise AssertionError(f"whole Whisper step launched {got}, expected "
                             f"{want}")
    if set(grads[0]) != set(grads[1]):
        raise AssertionError("the card and the CPU gave gradients to "
                             "different parameters")
    # the key projections' biases cancel in the softmax (whole_step_ernie)
    for n in [n for n in grads[1] if n.endswith("k_proj.bias")]:
        w = n.replace("bias", "weight")
        ratio = [g.pop(n).norm().item() / g[w].norm().item() for g in grads]
        if not max(ratio) <= 1e-2:
            raise AssertionError(f"whole Whisper step: {n}'s gradient, 0 in "
                                 f"exact arithmetic, is {ratio} of the key "
                                 f"weight gradient's norm (card, CPU)")
    rel = {n: ((grads[0][n] - g).norm() / g.norm()).item()
           for n, g in grads[1].items()}
    worst = sorted(rel.items(), key=lambda r: -r[1])[:3]
    print(f"  loss {losses[0]:.5f} on the card, {losses[2]:.5f} on the CPU "
          f"(|diff| {abs(losses[0] - losses[2]):.2e}, limit "
          f"{STEP_LOSS_TOL}); after the AdamW step {losses[1]:.5f} / "
          f"{losses[3]:.5f}; worst gradient relative L2 errors "
          + ", ".join(f"{n} {e:.2e}" for n, e in worst)
          + f" (limit {STEP_GRAD_REL_L2}, {len(rel)} parameters); launches "
          f"{got}")
    for a, b in ((losses[0], losses[2]), (losses[1], losses[3])):
        if not abs(a - b) <= STEP_LOSS_TOL:
            raise AssertionError(f"whole Whisper step: loss {a} vs {b}")
    if not worst[0][1] <= STEP_GRAD_REL_L2:
        raise AssertionError(f"whole Whisper step: gradient of {worst[0][0]} "
                             f"off by {worst[0][1]} in relative L2")


def flash_whisper_phase(torch, g):
    """The flash kernels at Whisper-base's shapes, against the plain
    versions and timed against SDPA: the encoder's self-attention [8, 1500,
    8, 64] bf16, not causal, forward and backward; a decode step's
    cross-attention, q [8, 1, 8, 64] against k / v [8, 1500, 8, 64],
    forward only (a decode step has no backward). Returns the forward and
    backward rows' sub-rows."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import flash_attention as F

    B, S, H, D = WHISPER_ATTN
    print(f"[flash whisper] flash_attention, flash_attention_bwd  encoder "
          f"[{B}, {S}, {H}, {D}] bf16 not causal; decode q [{B}, 1, {H}, {D}] "
          f"against k / v [{B}, {S}, {H}, {D}]")
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .bfloat16() for _ in range(4))
    ef, eb, lse, dg = _check_pair(torch, F, "encoder", q, k, v, do)
    times, bounds = _flash_timed(torch, F, f"[{B}, {S}, {H}, {D}]", q, k, v,
                                 do, lse, dg)
    enc = _rows(f"[{B}, {S}, {H}, {D}] bf16 (the Whisper-base encoder's)",
                times, bounds, (ef, eb))
    del do, lse, dg
    q1 = torch.randn(B, 1, H, D, device="cuda", generator=g).bfloat16()
    out, lse1 = F.flash_attention_cuda(q1, k, v)
    p_out, p_lse = F.flash_attention_plain(q1, k, v)
    torch.cuda.synchronize()
    e1 = check(torch, "decode out", out, p_out, ATTN_ATOL, BF16_RTOL)
    check(torch, "decode lse", lse1, p_lse, F32_ATOL)
    before = K.launch_counts()
    ms = time_ms(torch, lambda: F.flash_attention_cuda(q1, k, v))
    design = ran_design(K, before)
    plain = time_ms(torch, lambda: F.flash_attention_plain(q1, k, v),
                    iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q1, k, v))
    lib = time_ms(torch, lambda: torch.nn.functional
                  .scaled_dot_product_attention(qt, kt, vt))
    # read q, k, v; write out and lse; 4 flops a (query, key) pair and dim
    nbytes = (2 * q1.numel() + 2 * k.numel()) * 2 + B * H * 4
    bound, by = bound_ms(nbytes, 4 * B * S * H * D)
    print(f"  decode: kernel {ms:.4f} ms, plain {plain:.4f}, SDPA {lib:.4f}, "
          f"bound {bound:.4f} ({by})")
    dec = dict(shape=f"q [{B}, 1, {H}, {D}], k / v [{B}, {S}, {H}, {D}] bf16 "
               f"(a Whisper-base decode step's cross-attention)", ms=ms,
               plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
               design=design, max_abs_err=e1)
    return enc, dec


def resnet_batch(torch, B, size, classes, seed, device):
    """Seeded images ``[B, 3, size, size]`` (unit normal, what a normalised
    ImageNet crop looks like in distribution) and labels ``[B, 1]`` from
    ``[0, classes)``, Paddle's classification label layout."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, 3, size, size, generator=g)
    y = torch.randint(0, classes, (B, 1), generator=g)
    return x.to(device), y.to(device)


def vision_share(kernels):
    """Device ms by group of a vision step's profiled kernels."""
    groups = (("port kernels (softmax-CE)", ("softmax_ce",)),
              ("batch norm", ("bn_", "batch_norm", "batchnorm", "welford")),
              ("convolutions and GEMMs", ("conv", "fprop", "dgrad", "wgrad",
                                          "implicit", "xmma", "cutlass",
                                          "gemm", "nvjet", "sm90_", "cudnn")),
              ("pooling", ("pool",)))
    share = {name: 0.0 for name, _ in groups}
    share["elementwise (casts, ReLU, adds, Momentum)"] = 0.0
    for k in kernels:
        ms = (k.time_range.end - k.time_range.start) / 1e3
        name = k.name.lower()
        key = next((g for g, keys in groups if any(o in name for o in keys)),
                   "elementwise (casts, ReLU, adds, Momentum)")
        share[key] += ms
    return share


@contextlib.contextmanager
def tf32_off(torch):
    """cuDNN's and cuBLAS's TF32 off inside the block."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def o1_eval_check(torch, what, model, x):
    """``model``'s eval logits on ``x`` (a tuple's first, the main head)
    under O1 against its f32 forward
    (TF32 off), held to VISION_O1_ROUNDING_RATIO x the error of an f32
    forward with the weights and the input rounded to bf16, and to
    VISION_O1_REL_L2_MAX; returns both errors."""
    from paddle_tpu_torch import amp

    def logits(inp):        # GoogLeNet's main head of (out, aux1, aux2)
        out = model(inp)
        return out[0] if isinstance(out, tuple) else out

    model.eval()
    with tf32_off(torch), torch.no_grad():
        with amp.auto_cast(level="O1"):
            low = logits(x)
        want = logits(x)
        saved = [p.detach().clone() for p in model.parameters()]
        for p in model.parameters():
            p.copy_(p.bfloat16())
        rounded = logits(x.bfloat16().float())
        for p, keep in zip(model.parameters(), saved):
            p.copy_(keep)
    err, ref = rel_l2(low, want), rel_l2(rounded, want)
    print(f"  {what}: eval logits O1 vs f32 relative L2 {err:.3e}; f32 with "
          f"bf16-rounded weights and input {ref:.3e} (ratio "
          f"{err / ref:.2f}, limit {VISION_O1_ROUNDING_RATIO}); logits max "
          f"|{want.abs().max().item():.3f}|")
    if not (torch.isfinite(low).all()
            and err <= VISION_O1_ROUNDING_RATIO * ref
            and err <= VISION_O1_REL_L2_MAX):
        raise AssertionError(f"{what}: O1 eval logits off by {err} (bf16 "
                             f"rounding of the weights alone: {ref})")
    return err, ref


def resnet_training_phase(torch, K):
    """ResNet-50 at its published widths trained at the PaddleClas recipe:
    f32 parameters under auto_cast(O1, bf16), Momentum 0.9 with L2 1e-4
    over PiecewiseDecay, one repeated seeded batch of 64 x 224 x 224 with
    labels in [0, 1000): a warm-up step, then RESNET_STEPS timed steps;
    losses finite and falling; exactly one softmax-CE forward and backward
    launch a step; step wall (median), images/s, MFU
    (``resnet_flops_per_image``, training 3x the forward), peak memory, a
    step split into forward, backward and the update, and a profiled step.
    Returns the launches and the trained model."""
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum, PiecewiseDecay
    from paddle_tpu_torch.vision.models import (resnet50,
                                                resnet_flops_per_image)

    B = RESNET_BATCH
    print(f"[resnet] ResNet-50 (PaddleClas ResNet50.yaml widths), batch {B} "
          f"x 3 x 224 x 224, f32 params under auto_cast(O1, bf16), Momentum "
          f"0.9, L2 1e-4, PiecewiseDecay({RESNET_BOUNDARIES}, {RESNET_LRS})")
    framework.seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = resnet50(seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    flops = 3 * resnet_flops_per_image(model)
    sched = PiecewiseDecay(RESNET_BOUNDARIES, RESNET_LRS)
    opt = Momentum(learning_rate=sched, momentum=0.9,
                   parameters=model.parameters(), weight_decay=1e-4)
    x, y = resnet_batch(torch, B, 224, 1000, 2, "cuda")
    lrs = []

    def step():
        lrs.append(opt.get_lr())
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss

    t0 = time.monotonic()
    losses = [step().item()]
    print(f"  {n_params / 1e6:.2f} M parameters; warm-up step "
          f"{time.monotonic() - t0:.2f}s, loss {losses[0]:.4f}")
    K.reset_launch_counts()
    walls = []
    for _ in range(RESNET_STEPS):
        t0 = time.monotonic()
        losses.append(step().item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {[round(v, 4) for v in losses]}; lr {lrs}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite ResNet-50 loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the ResNet-50 loss did not fall: {losses}")
    if len(set(lrs)) != 2:
        raise AssertionError(f"the run crossed no lr boundary: {lrs}")
    per_step = {k: c / RESNET_STEPS for k, c in counts.items() if c}
    print(f"  launches per step: {per_step}")
    if per_step != {"softmax_ce": 1.0, "softmax_ce_bwd": 1.0}:
        raise AssertionError("the ResNet-50 steps launched other kernels "
                             "than one softmax-CE forward and backward each")
    med = sorted(walls)[len(walls) // 2]
    img_s = B / med
    print(f"  step wall {med * 1e3:.2f} ms (median of {RESNET_STEPS}, min "
          f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}); "
          f"{img_s:.1f} images/s; MFU {100 * img_s * flops / BF16_FLOPS:.2f}% "
          f"({flops / 1e9:.2f} GFLOP an image, 3x the forward's "
          f"{flops / 6e9:.3f} G multiply-adds, against "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s); peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    # one step split by synchronising: forward, backward, the update
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = F.cross_entropy(model(x), y)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.monotonic()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    t3 = time.monotonic()
    print(f"  one step split: forward {(t1 - t0) * 1e3:.2f} ms, backward "
          f"{(t2 - t1) * 1e3:.2f} ms, Momentum over "
          f"{len(list(model.parameters()))} tensors {(t3 - t2) * 1e3:.2f} ms")
    busy = profile_step(torch, step, "ResNet-50 training step",
                        share=vision_share, top=12)
    print(f"  idle {100 * (1 - busy / (med * 1e3)):.1f}% of the unprofiled "
          f"median step wall")
    return counts, model


def resnet_infer_phase(torch, model):
    """The trained ResNet-50 in eval mode under O1: ms a batch and images/s
    at batch 64 and at batch 1 (host clock around synchronised runs), then
    its O1 logits at batch 64 against its f32 forward (``o1_eval_check``)."""
    from paddle_tpu_torch import amp

    model.eval()
    print("[resnet infer] ResNet-50 eval under auto_cast(O1, bf16)")
    for B, iters in ((RESNET_BATCH, 20), (1, 50)):
        x = resnet_batch(torch, B, 224, 1000, 7, "cuda")[0]
        with torch.no_grad(), amp.auto_cast(level="O1"):
            for _ in range(3):
                model(x)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3 / iters
        print(f"  batch {B}: {ms:.3f} ms a batch, {B * 1e3 / ms:.1f} "
              f"images/s (mean of {iters})")
    x = resnet_batch(torch, RESNET_BATCH, 224, 1000, 8, "cuda")[0]
    o1_eval_check(torch, f"batch {RESNET_BATCH}", model, x)


def _vision_step(torch, model, x, y, o1, lr=0.1, loss_fn=None):
    """One forward, cross-entropy (the port's, or ``loss_fn``), backward
    and Momentum step (0.9, L2 1e-4) of ``model`` on (x, y), under O1 or
    not: the loss, the gradients, and the batch-norm buffers and
    parameters after the step, on the CPU (f64 kept, else f32)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(learning_rate=lr, momentum=0.9,
                   parameters=model.parameters(), weight_decay=1e-4)
    with amp.auto_cast(enable=o1, level="O1"):
        loss = (loss_fn or F.cross_entropy)(model(x), y)
    loss.backward()

    def copy(t):
        keep = torch.float64 if t.dtype == torch.float64 else torch.float32
        return t.detach().to("cpu", keep, copy=True)

    grads = {n: copy(p.grad) for n, p in model.named_parameters()}
    opt.step()
    opt.clear_grad()
    return (loss.item(), grads,
            {n: copy(b) for n, b in model.named_buffers()},
            {n: copy(p) for n, p in model.named_parameters()})


def _step_errors(a, b, skip=frozenset()):
    """Loss difference and the worst relative L2 errors of gradients,
    buffers and updated parameters of step ``a`` against step ``b`` (the
    parameters named in ``skip`` left out)."""
    out = {"loss": abs(a[0] - b[0])}
    for i, key in ((1, "gradient"), (2, "buffer"), (3, "parameter")):
        rel = {n: rel_l2(a[i][n], t) for n, t in b[i].items()
               if n not in skip}
        out[key] = max(rel.items(), key=lambda r: r[1])
    return out


def whole_step_resnet(torch, K):
    """ResNet-50, batch 8 x 224: one step (forward, cross-entropy, backward,
    Momentum 0.9 / L2 1e-4 at lr 0.1) from the same weights on the card
    and on the CPU through the plain versions, each in f32 (TF32 off) and
    under O1 (bf16). The f32 pair is held to the whole-step limits: the
    loss within STEP_LOSS_TOL, every gradient and every parameter after
    the update within STEP_GRAD_REL_L2, the batch-norm buffers within
    BN_REL_L2. The O1 step must launch exactly one softmax-CE forward and
    backward and give a finite loss; its numbers against both CPU steps are
    printed, not held, beside the CPU's f32 step against its f64 one: at
    initialisation this step amplifies rounding so much (53 training-mode
    batch norms) that f32 gradients are a few per cent off f64, and bf16
    leaves them undetermined (on the CPU's own bf16 autocast too)."""
    from paddle_tpu_torch.vision.models import resnet50

    B = RESNET_WHOLE_BATCH
    print(f"[whole step resnet] ResNet-50, batch {B} x 3 x 224 x 224: one "
          f"Momentum step on the card and on the CPU, in f32 (TF32 off) "
          f"and under O1")
    card = resnet50(seed=4)
    state = {k: v.clone() for k, v in card.state_dict().items()}
    cpu = resnet50(device="cpu")
    x, y = resnet_batch(torch, B, 224, 1000, 5, "cpu")
    runs = {}
    for name, model, o1 in (("card f32", card, False), ("card O1", card, True),
                            ("CPU f32", cpu, False), ("CPU O1", cpu, True)):
        model.load_state_dict(state)
        dev = model.conv1.weight.device
        K.reset_launch_counts()
        with tf32_off(torch):
            runs[name] = _vision_step(torch, model, x.to(dev), y.to(dev), o1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launched = {k: v for k, v in K.launch_counts().items() if v}
            if launched != {"softmax_ce": 1, "softmax_ce_bwd": 1}:
                raise AssertionError(f"the card's {name} ResNet-50 step "
                                     f"launched {launched}")
    cpu.load_state_dict(state)          # how far f32 itself resolves it
    cpu.double()
    runs["CPU f64"] = _vision_step(torch, cpu, x.double(), y, False)
    print("  losses: " + ", ".join(f"{n} {r[0]:.5f}" for n, r in runs.items())
          + "; each card step launched one softmax-CE forward and backward")
    errs = {}
    for a, b in (("card f32", "CPU f32"), ("CPU f32", "CPU f64"),
                 ("card O1", "CPU O1"), ("card O1", "CPU f32"),
                 ("CPU O1", "CPU f32")):
        e = errs[a, b] = _step_errors(runs[a], runs[b])
        print(f"  {a} vs {b}{' (held)' if a == 'card f32' else ''}: loss "
              f"|diff| {e['loss']:.2e}; worst relative L2: gradient "
              f"{e['gradient'][1]:.2e} ({e['gradient'][0]}), buffer "
              f"{e['buffer'][1]:.2e} ({e['buffer'][0]}), parameter after "
              f"the step {e['parameter'][1]:.2e} ({e['parameter'][0]})")
    e = errs["card f32", "CPU f32"]
    if not (e["loss"] <= STEP_LOSS_TOL
            and e["gradient"][1] <= STEP_GRAD_REL_L2
            and e["parameter"][1] <= STEP_GRAD_REL_L2
            and e["buffer"][1] <= BN_REL_L2):
        raise AssertionError(f"whole ResNet-50 step (f32, card vs CPU): {e}")
    if not math.isfinite(runs["card O1"][0]):
        raise AssertionError(f"the card's O1 ResNet-50 loss is "
                             f"{runs['card O1'][0]}")
    return errs


# (name, constructor in vision.models, input channels, image size)
ZOO = (("LeNet", "LeNet", 1, 28), ("AlexNet", "alexnet", 3, 224),
       ("VGG-16", "vgg16", 3, 224), ("MobileNetV1", "mobilenet_v1", 3, 224),
       ("MobileNetV2", "mobilenet_v2", 3, 224),
       ("MobileNetV3-Large", "mobilenet_v3_large", 3, 224),
       ("SqueezeNet 1.1", "squeezenet1_1", 3, 224),
       ("GoogLeNet", "googlenet", 3, 224),
       ("InceptionV3", "inception_v3", 3, 299))


def googlenet_loss(out, y):
    """GoogLeNet's training loss: the main head's cross-entropy plus 0.3 x
    each auxiliary head's (one softmax-CE forward and backward a head)."""
    from paddle_tpu_torch.nn import functional as F

    main, aux1, aux2 = out
    return F.cross_entropy(main, y) + 0.3 * (F.cross_entropy(aux1, y)
                                             + F.cross_entropy(aux2, y))


def vision_zoo_phase(torch, K):
    """LeNet (10 classes, 1 x 28 x 28), AlexNet, VGG-16, MobileNetV1 / V2 /
    V3-Large, SqueezeNet 1.1 and GoogLeNet (1000 classes, 3 x 224 x 224)
    and InceptionV3 (3 x 299 x 299) at their published widths, batch
    ZOO_BATCH: one O1 training step each (Momentum 0.9, L2 1e-4, lr 0.01)
    with a finite loss and one softmax-CE forward and backward launch a
    head (GoogLeNet: ``googlenet_loss``, 3 / 3); then its main eval logits
    under O1 against its f32 forward (``o1_eval_check``). Returns the
    steps' launches."""
    from paddle_tpu_torch.vision import models

    print(f"[vision zoo] batch {ZOO_BATCH}: one O1 step each, then eval "
          f"logits O1 vs f32")
    total = {}
    for what, make, ch, size in ZOO:
        classes = 10 if what == "LeNet" else 1000
        model = getattr(models, make)(seed=6)
        n_params = sum(p.numel() for p in model.parameters())
        x, y = resnet_batch(torch, ZOO_BATCH, size, classes, 9, "cuda")
        x = x[:, :ch].contiguous()
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        heads = 3 if what == "GoogLeNet" else 1
        loss = _vision_step(torch, model, x, y, True, lr=0.01,
                            loss_fn=googlenet_loss if heads == 3 else None)[0]
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
        counts = K.launch_counts()
        launched = {k: v for k, v in counts.items() if v}
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        print(f"  {what}: {n_params / 1e6:.2f} M parameters, O1 step loss "
              f"{loss:.4f} ({wall:.1f} ms, first call), launches {launched}")
        if not math.isfinite(loss):
            raise AssertionError(f"{what}: non-finite loss {loss}")
        if launched != {"softmax_ce": heads, "softmax_ce_bwd": heads}:
            raise AssertionError(f"{what}: the step launched {launched}")
        o1_eval_check(torch, what, model, x)
        del model
    return total


def _loss_recorder(cbks):
    """A hapi callback that keeps each batch's loss and host-clock times:
    the step (train_batch: moving the batch, the step, the loss's host
    sync, the metric) and the wait for the loader before it."""
    class Record(cbks.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.steps, self.waits = [], [], []
            self._end = None

        def on_train_batch_begin(self, step, logs=None):
            self._begin = time.monotonic()
            if self._end is not None and step > 0:
                self.waits.append(self._begin - self._end)

        def on_train_batch_end(self, step, logs=None):
            self._end = time.monotonic()
            self.steps.append(self._end - self._begin)
            self.losses.append(float(logs["loss"][0]))

        def on_epoch_begin(self, epoch, logs=None):
            self._end = None

    return Record()


def _launched(K):
    return {k: v for k, v in K.launch_counts().items() if v}


def hapi_lenet_phase(torch, K):
    """BASELINE #1 as the verify recipe runs it: ``paddle_tpu_torch.seed(7)``,
    ``LeNet()`` on the card, Adam 1e-3, ``CrossEntropyLoss``,
    ``Accuracy``, ``Model.fit(MNIST(mode="train"), batch_size=256,
    epochs=3)`` (2048 synthetic images through the native batcher), then
    ``evaluate(MNIST(mode="test"))``. Holds: the accuracy rises epoch over
    epoch, the eval accuracy is at least LENET_MIN_EVAL_ACC, the native
    batcher served every batch, exactly one softmax-CE forward and backward
    a step and one forward an eval batch, and the first epoch's losses
    within LENET_LOSS_ATOL of the port's CPU ``fit`` from the same weights
    and order (TF32 off on the card). Returns the launches."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi import callbacks as cbks
    from paddle_tpu_torch.io import native_batcher
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    print(f"[hapi lenet] BASELINE #1: Model(LeNet()).fit(MNIST(mode="
          f"'train'), batch_size={LENET_BATCH}, epochs={LENET_EPOCHS}), Adam "
          f"1e-3, CrossEntropyLoss, Accuracy; evaluate(MNIST(mode='test'))")

    def run(device, epochs, init=None):
        paddle.seed(7)
        net = LeNet(device=device)
        if init is not None:
            net.load_state_dict(init)
        init = {k: v.detach().cpu().clone()
                for k, v in net.state_dict().items()}
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.Adam(parameters=net.parameters(),
                                            learning_rate=1e-3),
                      paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        rec = _loss_recorder(cbks)
        np.random.seed(0)
        t0 = time.monotonic()
        hist = model.fit(MNIST(mode="train"), batch_size=LENET_BATCH,
                         epochs=epochs, verbose=0, callbacks=[rec])
        if device is None:
            torch.cuda.synchronize()
        return model, hist, rec, time.monotonic() - t0, init

    K.reset_launch_counts()
    native_batcher.reset_batch_count()
    with tf32_off(torch):
        model, hist, rec, wall, init = run(None, LENET_EPOCHS)
    fit_counts = K.launch_counts()
    served = native_batcher.batch_count()
    steps = len(rec.losses)
    accs = [float(a) for a in hist.history["acc"]]
    print(f"  fit: {wall:.2f}s for {steps} steps, median step "
          f"{1e3 * sorted(rec.steps)[steps // 2]:.2f} ms; epoch accuracy "
          f"{[round(a, 4) for a in accs]}; losses "
          f"{[round(float(v[0]), 4) for v in hist.history['loss']]}; native "
          f"batcher served {served} of {steps} batches; launches "
          f"{ {k: v for k, v in fit_counts.items() if v} }")
    if not all(b > a for a, b in zip(accs, accs[1:])):
        raise AssertionError(f"LeNet's accuracy did not rise: {accs}")
    if served != steps or steps != LENET_EPOCHS * 2048 // LENET_BATCH:
        raise AssertionError(f"the native batcher served {served} of "
                             f"{steps} batches")
    want = {"softmax_ce": steps, "softmax_ce_bwd": steps}
    if {k: v for k, v in fit_counts.items() if v} != want:
        raise AssertionError(f"the LeNet fit launched "
                             f"{_launched(K)}, not {want}")
    K.reset_launch_counts()
    logs = model.evaluate(MNIST(mode="test"), batch_size=LENET_BATCH,
                          verbose=0)
    eval_counts = K.launch_counts()
    acc = float(logs["acc"])
    print(f"  eval: accuracy {acc:.4f}, loss {float(logs['loss'][0]):.4f}; "
          f"launches {_launched(K)}")
    if not acc >= LENET_MIN_EVAL_ACC:
        raise AssertionError(f"LeNet's eval accuracy {acc} < "
                             f"{LENET_MIN_EVAL_ACC}")
    if _launched(K) != {"softmax_ce": 512 // LENET_BATCH}:
        raise AssertionError(f"the LeNet eval launched {_launched(K)}")
    # the first epoch again on the CPU from the same initial weights
    _, _, cpu_rec, cpu_wall, _ = run("cpu", 1, init)
    card = rec.losses[:len(cpu_rec.losses)]
    err = max(abs(a - b) for a, b in zip(card, cpu_rec.losses))
    print(f"  card vs CPU, first epoch ({len(card)} losses): max |diff| "
          f"{err:.2e} (limit {LENET_LOSS_ATOL}); CPU epoch {cpu_wall:.2f}s")
    if not err <= LENET_LOSS_ATOL:
        raise AssertionError(f"LeNet card losses {card} vs CPU "
                             f"{cpu_rec.losses}")
    return {k: fit_counts[k] + eval_counts[k] for k in fit_counts}


def imagenet_like(n, size, classes, seed):
    """``n`` seeded uint8 HWC images ``[size, size, 3]`` and labels in
    ``[0, classes)``: each image is its class's template (8 x 8 colour
    blocks, upsampled) plus uniform noise, so that the classes can be
    told apart."""
    import numpy as np

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n).astype(np.int64)
    cells = size // 8
    templates = rng.randint(0, 160, (classes, cells, cells, 3)).astype(
        np.uint8)
    images = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        t = templates[labels[i]].repeat(8, 0).repeat(8, 1)
        images[i] = t + rng.randint(0, 96, (size, size, 3), dtype=np.uint8)
    return images, labels


def hapi_resnet_phase(torch, K):
    """ResNet-50 at its published widths (1000 classes) through
    ``Model.fit`` in f32 (hapi's O1 cannot train a conv net, ROADMAP R9;
    cuDNN's default TF32 convolutions), Momentum 0.9 with L2 1e-4 over
    PiecewiseDecay as ``[resnet]`` (stepped by fit's LRScheduler callback),
    ``CrossEntropyLoss``, ``Accuracy(topk=(1, 5))``, on an ``io.Dataset`` of
    HAPI_RESNET_IMAGES seeded uint8 HWC 256 x 256 images with class
    templates through the PaddleClas train transforms (ToTensor,
    RandomCrop(224), RandomHorizontalFlip, Normalize), batch 64, shuffle,
    drop_last, HAPI_RESNET_WORKERS worker processes: one epoch, then
    ``evaluate`` on HAPI_EVAL_BATCHES batches and ``predict`` on one.
    Prints the step wall, images/s, the loader wait, host-to-device ms,
    the step of a bare f32 loop on a batch already on the card and the
    share that hapi and the loader add, the metric's host cost, peak
    memory, the launches and a profiled fit step. Returns the launches."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io
    from paddle_tpu_torch.hapi import callbacks as cbks
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum, PiecewiseDecay
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import resnet50

    B, n = RESNET_BATCH, HAPI_RESNET_IMAGES
    t0 = time.monotonic()
    images, labels = imagenet_like(n, 256, 1000, 11)
    print(f"[hapi resnet] ResNet-50 through Model.fit, f32: {n} uint8 images "
          f"256 x 256 x 3 ({images.nbytes / 1e6:.0f} MB, made in "
          f"{time.monotonic() - t0:.1f}s), batch {B}, {HAPI_RESNET_WORKERS} "
          f"workers, ToTensor / RandomCrop(224) / RandomHorizontalFlip / "
          f"Normalize, Momentum 0.9, L2 1e-4, PiecewiseDecay("
          f"{RESNET_BOUNDARIES}, {RESNET_LRS})")

    class Images(io.Dataset):
        def __init__(self, transform, count):
            self.transform, self.count = transform, count

        def __len__(self):
            return self.count

        def __getitem__(self, i):
            return self.transform(images[i]), labels[i]

    train_tf = T.Compose([T.ToTensor(), T.RandomCrop(224),
                          T.RandomHorizontalFlip(),
                          T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    eval_tf = T.Compose([T.ToTensor(), T.CenterCrop(224),
                         T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    paddle.seed(0)
    torch.cuda.reset_peak_memory_stats()
    net = resnet50(seed=0)
    model = paddle.Model(net)
    sched = PiecewiseDecay(RESNET_BOUNDARIES, RESNET_LRS)
    opt = Momentum(learning_rate=sched, momentum=0.9,
                   parameters=net.parameters(), weight_decay=1e-4)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                  paddle.metric.Accuracy(topk=(1, 5)))
    rec = _loss_recorder(cbks)
    np.random.seed(0)
    K.reset_launch_counts()
    t0 = time.monotonic()
    hist = model.fit(Images(train_tf, n), batch_size=B, epochs=1,
                     shuffle=True, drop_last=True,
                     num_workers=HAPI_RESNET_WORKERS, verbose=0,
                     callbacks=[rec])
    torch.cuda.synchronize()
    fit_wall = time.monotonic() - t0
    fit_counts = K.launch_counts()
    steps = len(rec.losses)
    losses = rec.losses
    steady = slice(2, None)         # the first steps tune cuDNN
    med = sorted(rec.steps[steady])[len(rec.steps[steady]) // 2]
    wait = sorted(rec.waits[1:])[len(rec.waits[1:]) // 2]
    peak = torch.cuda.max_memory_allocated()
    print(f"  fit: {steps} steps in {fit_wall:.2f}s ({n - n % B} images, "
          f"{(n - n % B) / fit_wall:.1f} images/s with the workers' start "
          f"and cuDNN's tuning); losses {[round(v, 4) for v in losses]}; "
          f"history {hist.history}")
    print(f"  steady steps: step wall {med * 1e3:.2f} ms (median of steps "
          f"3-{steps}; min {min(rec.steps[steady]) * 1e3:.2f}, max "
          f"{max(rec.steps[steady]) * 1e3:.2f}), loader wait "
          f"{wait * 1e3:.2f} ms a step (median; max "
          f"{max(rec.waits[1:]) * 1e3:.2f}), {B / (med + wait):.1f} "
          f"images/s through fit; peak memory {peak / 2 ** 30:.2f} GiB")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite hapi ResNet-50 loss: {losses}")
    if not sum(losses[-4:]) < sum(losses[:4]):
        raise AssertionError(f"the hapi ResNet-50 loss did not fall: "
                             f"{losses}")
    want = {"softmax_ce": steps, "softmax_ce_bwd": steps}
    if {k: v for k, v in fit_counts.items() if v} != want:
        raise AssertionError(f"the hapi ResNet-50 fit launched "
                             f"{_launched(K)}, not {want}")
    K.reset_launch_counts()
    logs = model.evaluate(io.Subset(Images(eval_tf, n),
                                    range(HAPI_EVAL_BATCHES * B)),
                          batch_size=B, num_workers=HAPI_RESNET_WORKERS,
                          verbose=0)
    eval_counts = K.launch_counts()
    out = model.predict(io.Subset(Images(eval_tf, n), range(B)),
                        batch_size=B, stack_outputs=True)
    print(f"  evaluate ({HAPI_EVAL_BATCHES} batches): {logs}; predict: "
          f"{[o.shape for o in out]}; eval launches "
          f"{ {k: v for k, v in eval_counts.items() if v} }")
    if eval_counts["softmax_ce"] != HAPI_EVAL_BATCHES or \
            sum(eval_counts.values()) != HAPI_EVAL_BATCHES:
        raise AssertionError(f"the hapi ResNet-50 eval launched "
                             f"{eval_counts}")
    if out[0].shape != (B, 1000) or not np.isfinite(out[0]).all():
        raise AssertionError("predict gave no finite [64, 1000] logits")

    # one batch off the loader, as fit gets it; then the costs around it
    loader = io.DataLoader(Images(train_tf, n), batch_size=B, shuffle=True,
                           drop_last=True, num_workers=HAPI_RESNET_WORKERS,
                           places="cpu")    # the host's batch, as it arrives
    x, y = next(iter(loader))

    def timed(fn, reps=5):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.monotonic()
            fn()
            torch.cuda.synchronize()
            out.append((time.monotonic() - t) * 1e3)
        return sorted(out)[reps // 2]

    # the workers' batches arrive pinned here (this process uses CUDA); a
    # pageable copy shows what a plain copy and pinning it would cost
    arrived_pinned = x.is_pinned()
    plain = x.clone()
    h2d = timed(lambda: plain.to("cuda"))
    pin = timed(lambda: plain.pin_memory())
    h2d_pinned = timed(lambda: x.to("cuda", non_blocking=True))
    xc, yc = x.cuda(), y.cuda()
    metric = paddle.metric.Accuracy(topk=(1, 5))
    with torch.no_grad():
        logits = net(xc)
    acc_ms = timed(lambda: metric.update(metric.compute(logits.cpu(),
                                                        yc.cpu())))
    print(f"  host to device of one batch ({x.numel() * 4 / 1e6:.1f} MB f32, "
          f"median of 5): the loader's batch arrives pinned "
          f"({arrived_pinned}) and copies in {h2d_pinned:.2f} ms; from "
          f"pageable memory {h2d:.2f} ms, or {pin:.2f} ms to pin it first; "
          f"Accuracy(top-1/5) on the host (the logits' copy, argsort of "
          f"[{B}, 1000]) {acc_ms:.2f} ms a step")
    if not arrived_pinned:
        raise AssertionError("the loader's batch did not arrive pinned")

    def bare():
        loss = F.cross_entropy(net(xc), yc)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    net.train()
    for _ in range(2):
        bare()
    bare_ms = timed(bare)
    print(f"  bare f32 loop (batch on the card, forward, loss, backward, "
          f"Momentum): {bare_ms:.2f} ms a step; hapi and the loader add "
          f"{100 * (1 - bare_ms / ((med + wait) * 1e3)):.1f}% "
          f"({(med + wait) * 1e3 - bare_ms:.2f} ms a step)")
    busy = profile_step(torch, lambda: model.train_batch([x], [y]),
                        "Model.train_batch (ResNet-50, f32, batch from the "
                        "host)", share=vision_share, top=8)
    print(f"  idle {100 * (1 - busy / (med * 1e3)):.1f}% of the median "
          f"fit step wall ({100 * (1 - busy / ((med + wait) * 1e3)):.1f}% "
          f"with the loader wait)")
    return {k: fit_counts[k] + eval_counts[k] for k in fit_counts}


class _CudaFlags:
    """Samples that record whether their worker process has CUDA
    initialised, and its pid."""

    def __init__(self, torch, fail_at=None):
        self.torch, self.fail_at = torch, fail_at

    def __len__(self):
        return 24

    def __getitem__(self, i):
        import numpy as np

        if i == self.fail_at:
            raise ValueError(f"poisoned sample {i}")
        return (np.arange(6, dtype=np.float32) * i, np.int64(i),
                np.int64(self.torch.cuda.is_initialized()),
                np.int64(os.getpid()))


def hapi_workers_phase(torch):
    """The multi-process loader forked from this process, whose CUDA
    context is live: order and content equal ``num_workers=0``'s, a
    worker's exception reaches the parent, and no worker has CUDA
    initialised (a worker that touched it would raise: CUDA cannot start
    in a forked child)."""
    import numpy as np

    from paddle_tpu_torch import io

    if not torch.cuda.is_initialized():
        raise AssertionError("[hapi workers] needs a live CUDA context")
    print("[hapi workers] DataLoader worker processes forked with CUDA live "
          "in the parent")
    ds = type("Flags", (_CudaFlags, io.Dataset), {})(torch)
    np.random.seed(1)
    want = list(io.DataLoader(ds, batch_size=5, shuffle=True))
    np.random.seed(1)
    got = list(io.DataLoader(ds, batch_size=5, shuffle=True, num_workers=3))
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} batches from the workers, "
                             f"{len(want)} inline")
    for w, g in zip(want, got):
        for a, b in zip(w[:2], g[:2]):
            if not torch.equal(a, b):
                raise AssertionError("worker batches differ from inline")
    pids = {int(p) for b in got for p in b[3]}
    flags = {int(f) for b in got for f in b[2]}
    if os.getpid() in pids or len(pids) != 3 or flags != {0}:
        raise AssertionError(f"workers: pids {pids}, CUDA flags {flags}")
    bad = type("Bad", (_CudaFlags, io.Dataset), {})(torch, fail_at=13)
    try:
        list(io.DataLoader(bad, batch_size=5, num_workers=2))
    except RuntimeError as e:
        if "poisoned sample 13" not in str(e):
            raise
        print("  a worker's ValueError reached the parent as RuntimeError")
    else:
        raise AssertionError("a worker's exception did not reach the parent")
    print(f"  {len(got)} batches from 3 worker processes equal the inline "
          f"ones; CUDA initialised in no worker")


def densenet_phase(torch, K):
    """DenseNet-121 at its published widths trained at PaddleClas's recipe
    for it, written only through the port's public eager API, as a Paddle
    user writes a dygraph loop: ``paddle.to_tensor`` batches,
    ``paddle.amp.auto_cast(O1, bf16)``, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``. A warm-up step, then
    DENSENET_STEPS timed steps: losses finite and falling, exactly one
    softmax-CE forward and backward launch a step, the loss and the logits
    the port's Tensor; step wall (median), images/s, MFU
    (``densenet_flops_per_image``, training 3x the forward), peak memory;
    what the Tensor shell costs (the same step fed plain ``torch.Tensor``s,
    in turns: step wall and the host's time to queue it); a profiled step;
    a step with ``model.features`` frozen by ``stop_gradient`` (those
    parameters get no gradient and do not move, the classifier does); an
    eval under ``paddle.no_grad()`` with ``paddle.metric.accuracy``.
    Returns the timed steps' launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import densenet_flops_per_image

    B = DENSENET_BATCH
    print(f"[densenet] DenseNet-121 (PaddleClas DenseNet121.yaml widths: "
          f"growth 32, blocks 6/12/24/16), batch {B} x 3 x 224 x 224, f32 "
          f"params under auto_cast(O1, bf16), Momentum 0.9, L2 1e-4, "
          f"PiecewiseDecay({RESNET_BOUNDARIES}, {RESNET_LRS}); the "
          f"dygraph idiom through paddle_tpu_torch's eager API")
    paddle.seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = paddle.vision.models.densenet121()
    n_params = sum(int(p.numel()) for p in model.parameters())
    flops = 3 * densenet_flops_per_image(model)
    sched = paddle.optimizer.PiecewiseDecay(RESNET_BOUNDARIES, RESNET_LRS)
    opt = paddle.optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                    parameters=model.parameters(),
                                    weight_decay=1e-4)
    images, labels = resnet_batch(torch, B, 224, 1000, 3, "cuda")
    feeds = {"Tensor": (paddle.to_tensor(images), paddle.to_tensor(labels)),
             "plain": (images, labels)}
    x, y = feeds["Tensor"]
    lrs, kinds = [], []

    def step(xx, yy):
        lrs.append(opt.get_lr())
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(xx)
            loss = paddle.nn.functional.cross_entropy(logits, yy)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        kinds.append((type(logits), type(loss)))
        return loss

    t0 = time.monotonic()
    losses = [step(x, y).item()]
    print(f"  {n_params / 1e6:.2f} M parameters; warm-up step "
          f"{time.monotonic() - t0:.2f}s, loss {losses[0]:.4f}; "
          f"type(model(x)) {kinds[0][0].__name__}, type(loss) "
          f"{kinds[0][1].__name__} ({kinds[0][1].__module__})")
    if kinds[0] != (paddle.Tensor, paddle.Tensor):
        raise AssertionError(f"the dygraph step's logits and loss are "
                             f"{kinds[0]}, not the port's Tensor")
    K.reset_launch_counts()
    walls = []
    for _ in range(DENSENET_STEPS):
        t0 = time.monotonic()
        losses.append(step(x, y).item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {[round(v, 4) for v in losses]}; lr {sorted(set(lrs))}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite DenseNet-121 loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the DenseNet-121 loss did not fall: {losses}")
    per_step = {k: c / DENSENET_STEPS for k, c in counts.items() if c}
    print(f"  launches per step: {per_step}")
    if per_step != {"softmax_ce": 1.0, "softmax_ce_bwd": 1.0}:
        raise AssertionError("the DenseNet-121 steps launched other kernels "
                             "than one softmax-CE forward and backward each")
    med = sorted(walls)[len(walls) // 2]
    img_s = B / med
    print(f"  step wall {med * 1e3:.2f} ms (median of {DENSENET_STEPS}, min "
          f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}); "
          f"{img_s:.1f} images/s; MFU {100 * img_s * flops / BF16_FLOPS:.2f}% "
          f"({flops / 1e9:.2f} GFLOP an image, 3x the forward's "
          f"{flops / 6e9:.3f} G multiply-adds, against "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s); peak memory "
          f"{peak / 2 ** 30:.2f} GiB")

    # what the Tensor shell costs: the same step fed plain tensors, in
    # turns; the host's time to queue a step (it returns before the card
    # is done) and the step's wall (synchronised)
    queued = {"plain": [], "Tensor": []}
    wall = {"plain": [], "Tensor": []}
    for kind in ("plain", "Tensor", "Tensor", "plain") * SHELL_TURNS:
        for _ in range(SHELL_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            step(*feeds[kind])
            t1 = time.monotonic()
            torch.cuda.synchronize()
            queued[kind].append((t1 - t0) * 1e3)
            wall[kind].append((time.monotonic() - t0) * 1e3)
    if kinds[-SHELL_STEPS:][-1] != (torch.Tensor, torch.Tensor):
        raise AssertionError(f"plain tensors in gave {kinds[-1]} out")

    def med_of(v):
        return sorted(v)[len(v) // 2]

    dq = med_of(queued["Tensor"]) - med_of(queued["plain"])
    dw = med_of(wall["Tensor"]) - med_of(wall["plain"])
    print(f"  the Tensor shell's cost a step ({len(wall['Tensor'])} steps "
          f"each, in turns plain / Tensor / Tensor / plain): host time to "
          f"queue {med_of(queued['Tensor']):.2f} ms with Tensors vs "
          f"{med_of(queued['plain']):.2f} ms with plain tensors "
          f"({dq:+.2f} ms); step wall {med_of(wall['Tensor']):.2f} vs "
          f"{med_of(wall['plain']):.2f} ms ({dw:+.2f} ms)")
    busy = profile_step(torch, lambda: step(x, y),
                        "DenseNet-121 training step", share=vision_share,
                        top=12)
    print(f"  idle {100 * (1 - busy / (med * 1e3)):.1f}% of the unprofiled "
          f"median step wall")

    # freeze the features as a Paddle user does; the classifier trains
    feats = model.features.parameters()
    for p in feats:
        p.stop_gradient = True
    before = [p.detach().clone() for p in feats]
    head = model.classifier.weight.detach().clone()
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = paddle.nn.functional.cross_entropy(model(x), y)
    loss.backward()
    no_grads = sum(p.grad is None for p in feats)
    has_head = model.classifier.weight.grad is not None
    opt.step()
    opt.clear_grad()
    moved = sum(not torch.equal(a, p) for a, p in zip(before, feats))
    print(f"  frozen features ({len(feats)} parameters, stop_gradient=True): "
          f"{no_grads} got no gradient, {moved} moved; the classifier "
          f"{'moved' if not torch.equal(head, model.classifier.weight) else 'did not move'}")
    if no_grads != len(feats) or moved or not has_head or torch.equal(
            head, model.classifier.weight):
        raise AssertionError("stop_gradient did not freeze model.features")
    for p in feats:
        p.stop_gradient = False

    model.eval()
    ex, ey = resnet_batch(torch, B, 224, 1000, 4, "cuda")
    with paddle.no_grad(), paddle.amp.auto_cast(level="O1",
                                                dtype="bfloat16"):
        logits = model(paddle.to_tensor(ex))
        acc = paddle.metric.accuracy(logits, paddle.to_tensor(ey), k=5)
    print(f"  eval under paddle.no_grad(): logits {type(logits).__name__} "
          f"{list(logits.shape)}, stop_gradient {logits.stop_gradient}, "
          f"top-5 accuracy on seeded labels {float(acc):.4f}")
    if not (logits.stop_gradient and torch.isfinite(logits).all()):
        raise AssertionError("the eval logits are not finite or carry a "
                             "graph")
    return counts


def whole_step_densenet(torch, K):
    """DenseNet-121, batch DENSENET_WHOLE_BATCH x 224: one step (forward,
    cross-entropy, backward, Momentum 0.9 / L2 1e-4 at lr 0.1) from the
    same weights (the card's Paddle state dict into the CPU model) on the
    card and on the CPU through the plain versions. Held: the card's f64
    step against the CPU's f64 step (cuDNN's f64 convolutions and batch
    norm; torch's cross-entropy on both, as the softmax-CE kernel takes f32
    and bf16), to ``[whole step resnet]``'s limits: the loss within
    STEP_LOSS_TOL, the batch-norm buffers within BN_REL_L2, every gradient
    and every parameter after the update within STEP_GRAD_REL_L2. The card's
    f32 step (TF32 off, through the softmax-CE kernels) against the CPU's
    f32 and f64 steps is printed, not held: DenseNet's stem batch norm
    feeds every layer of the first block through the concatenations, and
    its weight's gradient sums tens of thousands of cancelling terms a
    channel, so f32 gets it to 3-16 % on either device (ROADMAP C3). The
    card's f32 and O1 steps each launch one softmax-CE forward and backward;
    the O1 loss is finite (its distance from the CPU's f32 step printed,
    ROADMAP C2)."""
    from paddle_tpu_torch.vision.models import densenet121

    B = DENSENET_WHOLE_BATCH
    print(f"[whole step densenet] DenseNet-121, batch {B} x 3 x 224 x 224: "
          f"one Momentum step on the card and on the CPU in f64 (held) and "
          f"f32 (TF32 off), and on the card under O1")
    card = densenet121(seed=4)
    state = {k: v.clone() for k, v in card.state_dict().items()}
    cpu = densenet121(device="cpu")
    x, y = resnet_batch(torch, B, 224, 1000, 5, "cpu")

    def torch_ce(logits, labels):
        return torch.nn.functional.cross_entropy(logits, labels.reshape(-1))

    runs = {}
    for name, model, o1 in (("card f32", card, False), ("card O1", card, True),
                            ("CPU f32", cpu, False)):
        model.set_state_dict(state)
        dev = model.features[0].weight.device
        K.reset_launch_counts()
        with tf32_off(torch):
            runs[name] = _vision_step(torch, model, x.to(dev), y.to(dev), o1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launched = {k: v for k, v in K.launch_counts().items() if v}
            if launched != {"softmax_ce": 1, "softmax_ce_bwd": 1}:
                raise AssertionError(f"the card's {name} DenseNet-121 step "
                                     f"launched {launched}")
    for name, model in (("card f64", card), ("CPU f64", cpu)):
        model.set_state_dict(state)
        model.double()
        dev = model.features[0].weight.device
        runs[name] = _vision_step(torch, model, x.double().to(dev),
                                  y.to(dev), False, loss_fn=torch_ce)
    print("  losses: " + ", ".join(f"{n} {r[0]:.7f}" for n, r in runs.items())
          + "; the card's f32 and O1 steps each launched one softmax-CE "
          "forward and backward")
    errs = {}
    for a, b in (("card f64", "CPU f64"), ("card f32", "CPU f32"),
                 ("card f32", "CPU f64"), ("CPU f32", "CPU f64"),
                 ("card O1", "CPU f32")):
        e = errs[a, b] = _step_errors(runs[a], runs[b])
        print(f"  {a} vs {b}{' (held)' if a == 'card f64' else ''}: loss "
              f"|diff| {e['loss']:.2e}; worst relative L2: gradient "
              f"{e['gradient'][1]:.2e} ({e['gradient'][0]}), buffer "
              f"{e['buffer'][1]:.2e} ({e['buffer'][0]}), parameter after "
              f"the step {e['parameter'][1]:.2e} ({e['parameter'][0]})")
    held = errs["card f64", "CPU f64"]
    if not (held["loss"] <= STEP_LOSS_TOL
            and held["gradient"][1] <= STEP_GRAD_REL_L2
            and held["parameter"][1] <= STEP_GRAD_REL_L2
            and held["buffer"][1] <= BN_REL_L2):
        raise AssertionError(f"whole DenseNet-121 step (f64, card vs CPU): "
                             f"{held}")
    if not math.isfinite(runs["card O1"][0]):
        raise AssertionError(f"the card's O1 DenseNet-121 loss is "
                             f"{runs['card O1'][0]}")
    return held


def shufflenet_training_phase(torch, K):
    """ShuffleNetV2 x1.0 at its published widths (2.28 M parameters, 1000
    classes) trained at the PaddleClas recipe cut to one card's batch of
    SHUFFLE_BATCH (Momentum 0.9, L2 4e-5, CosineAnnealingDecay from
    SHUFFLE_LR over the run's steps), f32 parameters under auto_cast(O1,
    bf16), one repeated seeded batch of 224 x 224: a warm-up step, then
    SHUFFLE_STEPS timed steps; losses finite and falling; exactly one
    softmax-CE forward and backward launch a step; step wall (median),
    images/s, MFU (``shufflenet_flops_per_image``, training 3x the
    forward), peak memory, a profiled step's busy and idle share. Returns
    the timed steps' launches."""
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import CosineAnnealingDecay, Momentum
    from paddle_tpu_torch.vision.models import (shufflenet_flops_per_image,
                                                shufflenet_v2_x1_0)

    B = SHUFFLE_BATCH
    print(f"[shufflenet] ShuffleNetV2 x1.0 (PaddleClas ShuffleNetV2_x1_0.yaml "
          f"widths), batch {B} x 3 x 224 x 224 (cut from 256 a card), f32 "
          f"params under auto_cast(O1, bf16), Momentum 0.9, L2 4e-5, "
          f"CosineAnnealingDecay({SHUFFLE_LR}, T_max={SHUFFLE_STEPS + 2})")
    framework.seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = shufflenet_v2_x1_0(seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    flops = 3 * shufflenet_flops_per_image(model)
    sched = CosineAnnealingDecay(SHUFFLE_LR, T_max=SHUFFLE_STEPS + 2)
    opt = Momentum(learning_rate=sched, momentum=0.9,
                   parameters=model.parameters(), weight_decay=4e-5)
    x, y = resnet_batch(torch, B, 224, 1000, 2, "cuda")

    def step():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss

    t0 = time.monotonic()
    losses = [step().item()]
    print(f"  {n_params / 1e6:.2f} M parameters; warm-up step "
          f"{time.monotonic() - t0:.2f}s, loss {losses[0]:.4f}")
    K.reset_launch_counts()
    walls = []
    for _ in range(SHUFFLE_STEPS):
        t0 = time.monotonic()
        losses.append(step().item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {[round(v, 4) for v in losses]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite ShuffleNetV2 loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the ShuffleNetV2 loss did not fall: {losses}")
    per_step = {k: c / SHUFFLE_STEPS for k, c in counts.items() if c}
    print(f"  launches per step: {per_step}")
    if per_step != {"softmax_ce": 1.0, "softmax_ce_bwd": 1.0}:
        raise AssertionError("the ShuffleNetV2 steps launched other kernels "
                             "than one softmax-CE forward and backward each")
    med = sorted(walls)[len(walls) // 2]
    img_s = B / med
    print(f"  step wall {med * 1e3:.2f} ms (median of {SHUFFLE_STEPS}, min "
          f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}); "
          f"{img_s:.1f} images/s; MFU {100 * img_s * flops / BF16_FLOPS:.3f}% "
          f"({flops / 1e9:.3f} GFLOP an image, 3x the forward's "
          f"{flops / 6e9:.4f} G multiply-adds, against "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s); peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    busy = profile_step(torch, step, "ShuffleNetV2 training step",
                        share=vision_share, top=12)
    print(f"  busy {100 * busy / (med * 1e3):.1f}%, idle "
          f"{100 * (1 - busy / (med * 1e3)):.1f}% of the unprofiled median "
          f"step wall")
    return counts


def shufflenet_exact_zeros(model):
    """What a ShuffleNetV2 step at initialisation makes exactly 0: the
    batch-norm biases of the depthwise blocks (no activation follows them,
    then a 1x1 convolution and a training-mode batch norm, which subtracts
    any per-channel shift, so their gradient is 0 and they stay 0), and
    the running means of the batch norms after those 1x1 convolutions
    (their input has zero mean on every channel while the biases are 0).
    Returns (biases, running means)."""
    biases, means = set(), set()
    for i, unit in enumerate(model.stages):
        pairs = ((("left.0", "left.1"), ("right.1", "right.2"))
                 if hasattr(unit, "left") else (("branch.1", "branch.2"),))
        for dw, pw in pairs:
            biases.add(f"stages.{i}.{dw}.1.bias")
            means.add(f"stages.{i}.{pw}.1._mean")
    return biases, means


def whole_step_shufflenet(torch, K):
    """ShuffleNetV2 x1.0, batch SHUFFLE_WHOLE_BATCH x 224: one f64 step
    (forward, torch's cross-entropy, backward, ``_vision_step``'s Momentum
    0.9 / L2 1e-4 at lr SHUFFLE_LR) from the same weights on the card (cuDNN's f64
    depthwise convolutions and batch norm) and on the CPU, held to the
    whole-step limits: the loss within STEP_LOSS_TOL, every gradient and
    every parameter after the update within STEP_GRAD_REL_L2 relative L2,
    the batch-norm buffers within BN_REL_L2. In f64 because depthwise
    convolutions and training-mode batch norm leave an f32 step at
    initialisation determined to a few per cent only (ROADMAP C2 / C3).
    What is exactly 0 in this step (``shufflenet_exact_zeros``: the
    depthwise blocks' batch-norm biases and the running means after them)
    is held apart: on each side those biases' gradients below 1e-9 of the
    largest gradient's norm, and the biases and running means after the
    step within 1e-12 of each other (rounding noise on both sides)."""
    from paddle_tpu_torch.vision.models import shufflenet_v2_x1_0

    B = SHUFFLE_WHOLE_BATCH
    print(f"[whole step shufflenet] ShuffleNetV2 x1.0, batch {B} x 3 x 224 "
          f"x 224: one f64 Momentum step on the card and on the CPU")
    card = shufflenet_v2_x1_0(seed=4)
    state = {k: v.clone() for k, v in card.state_dict().items()}
    cpu = shufflenet_v2_x1_0(device="cpu")
    x, y = resnet_batch(torch, B, 224, 1000, 5, "cpu")

    def torch_ce(logits, labels):
        return torch.nn.functional.cross_entropy(logits, labels.reshape(-1))

    runs = {}
    for name, model in (("card f64", card), ("CPU f64", cpu)):
        model.set_state_dict(state)
        model.double()
        dev = next(model.parameters()).device
        runs[name] = _vision_step(torch, model, x.double().to(dev),
                                  y.to(dev), False, lr=SHUFFLE_LR,
                                  loss_fn=torch_ce)
    zero, means = shufflenet_exact_zeros(cpu)
    e = _step_errors(runs["card f64"], runs["CPU f64"], skip=zero | means)
    print(f"  losses: card {runs['card f64'][0]:.10f}, CPU "
          f"{runs['CPU f64'][0]:.10f}; loss |diff| {e['loss']:.2e}; worst "
          f"relative L2: gradient {e['gradient'][1]:.2e} "
          f"({e['gradient'][0]}), buffer {e['buffer'][1]:.2e} "
          f"({e['buffer'][0]}), parameter after the step "
          f"{e['parameter'][1]:.2e} ({e['parameter'][0]})")
    held = {}
    for name, run in runs.items():
        scale = max(g.norm().item() for g in run[1].values())
        held[name] = max(run[1][n].norm().item() for n in zero) / scale
    moved = max([(runs["card f64"][3][n] - runs["CPU f64"][3][n]).abs()
                 .max().item() for n in zero]
                + [(runs["card f64"][2][n] - runs["CPU f64"][2][n]).abs()
                   .max().item() for n in means])
    print(f"  the {len(zero)} depthwise blocks' batch-norm biases (exact "
          f"gradient 0): gradient norm / largest gradient norm "
          + ", ".join(f"{n} {v:.1e}" for n, v in held.items())
          + f"; they and the {len(means)} running means after them (exact "
          f"0) after the step: max |card - CPU| {moved:.1e}")
    if not (e["loss"] <= STEP_LOSS_TOL
            and e["gradient"][1] <= STEP_GRAD_REL_L2
            and e["parameter"][1] <= STEP_GRAD_REL_L2
            and e["buffer"][1] <= BN_REL_L2
            and max(held.values()) < 1e-9 and moved < 1e-12):
        raise AssertionError(f"whole ShuffleNetV2 step (f64, card vs CPU): "
                             f"{e}, zero-gradient biases {held}, {moved}")
    return e


def nn_surface_phase(torch):
    """Every case of ``tools/nn_surface_cases.py``, the 36 functionals and
    44 layers of the last nn slice (the recurrent layers as 2-layer
    bidirectional GRU and SimpleRNN with ``sequence_length``), on the card
    against the CPU: outputs, input gradients and parameter gradients
    within EAGER_F32, TF32 off; ``SpectralNorm`` raises on both, and the
    cells derive from ``RNNCellBase``."""
    import numpy as np

    from paddle_tpu_torch import nn
    from tools.nn_surface_cases import FUNCTIONALS, LAYERS, cases, run

    todo = cases()
    print(f"[nn surface] {len(todo)} cases of {len(FUNCTIONALS)} functionals "
          f"and {len(LAYERS)} layers on the card against the CPU, f32 "
          f"forward and backward (TF32 off)")
    worst = (0.0, None)
    with tf32_off(torch):
        for case in todo:
            got, want = run(torch, case, "cuda"), run(torch, case, "cpu")
            if len(got) != len(want):
                raise AssertionError(f"[nn surface] {case[1]}: {len(got)} "
                                     f"arrays on the card, {len(want)}")
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, err_msg=case[1],
                                           **EAGER_F32)
                if b.size and np.abs(a - b).max() > worst[0]:
                    worst = (float(np.abs(a - b).max()), case[1])
    try:
        nn.SpectralNorm([4, 3])
    except NotImplementedError:
        pass
    else:
        raise AssertionError("SpectralNorm did not raise")
    if not all(issubclass(c, nn.RNNCellBase) for c in
               (nn.SimpleRNNCell, nn.GRUCell, nn.LSTMCell)):
        raise AssertionError("a cell does not derive from RNNCellBase")
    print(f"  {len(todo)} cases matched the CPU (largest |card - CPU| "
          f"{worst[0]:.2e} in {worst[1]}); SpectralNorm raises; the cells "
          f"derive from RNNCellBase")
    return len(todo)


def _sign_free(name, arrs):
    """The factors of a decomposition whose columns are defined up to a
    sign, as quantities that are not: svd the singular values and U S V^T,
    qr Q R, eigh the eigenvalues and V W V^T; eig's eigenvalues sorted."""
    import numpy as np

    if name == "svd":
        u, s, v = arrs
        return [s, (u * s[..., None, :]) @ np.swapaxes(v, -1, -2)]
    if name == "qr":
        return [arrs[0] @ arrs[1]]
    if name == "eigh":
        w, v = arrs
        return [w, (v * w[..., None, :]) @ np.swapaxes(v, -1, -2)]
    if name in ("eig", "eigvals"):
        return [np.sort_complex(arrs[0])]
    return arrs


def eager_ops_phase(torch):
    """Every op of the port's op library (creation, math, manipulation,
    linalg, logic, search, stat, fused: the JAX package's 224 registered
    names and the module functions it leaves out of its registry; then
    the registry's other ops: ``ops.parity``, ``ops.detection``, fft's
    three, the activations, ``rnn`` and the aliases) on CUDA tensors
    against the same op on CPU tensors, f32 inputs from the seeded cases
    of ``tools/eager_op_cases.py`` (``tests/test_torch_ops.py``'s and
    ``tests/test_torch_parity_ops.py``'s, cast from f64): integer and bool
    results equal, floating ones within EAGER_F32 (EAGER_F32_LOOSE for
    the decompositions and special functions, ``LOOSE`` /
    ``REGISTRY_LOOSE``; sign-free quantities for svd, qr and eigh), TF32
    off. The random ops run on the card for their shapes, dtypes and
    finiteness only (they agree in distribution, which the CPU tests
    hold). Prints the counts, the ops left out with the reason, and
    ``op_coverage()``, which must be 412 of 460."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import device as pdevice
    from paddle_tpu_torch.ops.registry import OPS
    from tools.eager_op_cases import (LOOSE, REGISTRY_LOOSE, REGISTRY_RAISES,
                                      REGISTRY_RANDOM, cases,
                                      registry_cases)

    modules = ("creation", "math", "manipulation", "linalg", "logic",
               "search", "stat", "fused")
    random = set(ops.random.__all__) | {"log_normal"}
    left_out = {"to_tensor": "a constructor: every phase's inputs",
                "create_parameter": "a constructor: nn.Layer makes them",
                "is_tensor": "a type check, no tensor out"}
    left_out.update(REGISTRY_RAISES)
    names = sorted(set().union(*(getattr(ops, m).__all__ for m in modules))
                   - random - set(left_out))
    core = modules + ("random",)
    registry = sorted(n for n, d in OPS.items()
                      if d.fn.__module__.split(".")[-1] not in core
                      and n not in REGISTRY_RANDOM and n not in left_out)
    print(f"[eager ops] {len(names)} ops of the op modules and "
          f"{len(registry)} more of the registry on the card against the "
          f"CPU, f32 (TF32 off); {len(random) + len(REGISTRY_RANDOM)} "
          f"random ops for shape and dtype")

    def convert(args, dev):
        def one(a):
            if not isinstance(a, np.ndarray):
                return a
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            elif a.dtype == np.complex128:
                a = a.astype(np.complex64)
            return paddle.to_tensor(a, place=dev)

        return [type(a)(one(e) for e in a) if isinstance(a, (list, tuple))
                and any(isinstance(e, np.ndarray) for e in a) else one(a)
                for a in args]

    def run(fn, args, kwargs, dev):
        paddle.set_device(dev)
        kw = {k: convert([v], dev)[0] if isinstance(v, np.ndarray) else v
              for k, v in kwargs.items()}
        return _flat_arrays(fn(*convert(args, dev), **kw))

    todo = [(n, getattr(ops, n), cases, LOOSE) for n in names] + [
        (n, OPS[n].fn, registry_cases, REGISTRY_LOOSE) for n in registry]
    ran, worst = 0, (0.0, None)
    try:
        with tf32_off(torch):
            for name, fn, inputs, loose in todo:
                def probe(args, kwargs, fn=fn):
                    try:
                        return bool(run(fn, args, kwargs, "cpu"))
                    except Exception:
                        return False

                tol = EAGER_F32_LOOSE if name in loose else EAGER_F32
                for args, kwargs in inputs(name, probe):
                    want = _sign_free(name, run(fn, args, kwargs, "cpu"))
                    got = _sign_free(name, run(fn, args, kwargs, "gpu"))
                    if len(got) != len(want):
                        raise AssertionError(f"[eager ops] {name}: "
                                             f"{len(got)} outputs on the "
                                             f"card, {len(want)} on the CPU")
                    for a, b in zip(got, want):
                        if a.shape != b.shape:
                            raise AssertionError(f"{name}: shape {a.shape} "
                                                 f"on the card, {b.shape}")
                        if b.dtype == bool or np.issubdtype(b.dtype,
                                                            np.integer):
                            np.testing.assert_array_equal(a, b, err_msg=name)
                            continue
                        np.testing.assert_allclose(a, b, err_msg=name, **tol)
                        if b.size:
                            err = float(np.abs(a - b).max())
                            if err > worst[0]:
                                worst = (err, name)
                ran += 1
            paddle.set_device("gpu")
            paddle.seed(1)
            x = paddle.full([64, 8], 0.5)
            draws = {"rand": ([64, 8],), "randn": ([64, 8],),
                     "standard_normal": ([64, 8],),
                     "normal": (0.0, 1.0, [64, 8]),
                     "log_normal": (0.0, 0.5, [64, 8]),
                     "uniform": ([64, 8],), "randint": (0, 10, [64, 8]),
                     "randint_like": (x, 0, 10), "randperm": (64,),
                     "multinomial": (x, 4), "rand_like": (x,),
                     "randn_like": (x,), "bernoulli": (x,),
                     "poisson": (x,), "gumbel_softmax": (x,),
                     "exponential_": (x.clone(),),
                     "uniform_": (x.clone(),), "normal_": (x.clone(),)}
            registry_draws = {"gaussian": ([64, 8],),
                              "truncated_gaussian_random": ([64, 8],),
                              "dirichlet": (paddle.full([64, 3], 0.7),),
                              "uniform_inplace": (x.clone(),)}
            if set(draws) != random or set(registry_draws) != \
                    REGISTRY_RANDOM:
                raise AssertionError(f"[eager ops] random ops: "
                                     f"{sorted(random ^ set(draws))}")
            for name, args in list(draws.items()) + list(
                    registry_draws.items()):
                fn = getattr(ops, name) if name in draws else OPS[name].fn
                out = fn(*args)
                if out.device.type != "cuda" or \
                        not torch.isfinite(out.float()).all():
                    raise AssertionError(f"[eager ops] random {name}: "
                                         f"{out.device}, not finite")
    finally:
        pdevice._state["device"] = None
    cov = paddle.op_coverage()
    missing = [n for n in cov["missing"] if not n.startswith("sparse.")]
    print(f"  {ran} ops matched the CPU (largest |card - CPU| {worst[0]:.2e} "
          f"in {worst[1]}); the random ops drew on the card; left out: "
          + "; ".join(f"{k} ({v})" for k, v in left_out.items()))
    print(f"  op_coverage(): {cov['covered']} of {cov['total']} reference "
          f"ops ({100 * cov['pct']:.1f}%), {cov['registered']} registered; "
          f"missing: {len(cov['missing']) - len(missing)} sparse.* (no "
          f"sparse tensors yet), others {missing}")
    if cov["covered"] != 412 or missing:
        raise AssertionError(f"op_coverage(): {cov['covered']}, want 412; "
                             f"missing beside sparse.*: {missing}")
    return ran


def _autograd_cases(paddle, dev):
    """The autograd cases of ``tests/test_torch_autograd.py`` on ``dev``:
    each returns the arrays it computed."""
    import numpy as np

    def t(v, grad=True):
        return paddle.to_tensor(np.asarray(v, np.float32), place=dev,
                                stop_gradient=not grad)

    def double():
        x = t([0.7, -1.3, 2.1])
        y = (paddle.sin(x) * x * x + paddle.exp(0.3 * x)).sum()
        (g,) = paddle.grad(y, x, create_graph=True)
        (g2,) = paddle.grad(g.sum(), x)
        return [g.numpy(), g2.numpy()]

    def penalty():
        w = t([[1.2, 0.1], [-0.4, 0.9]])
        x = t([[0.5, -1.0], [2.0, 0.3]])
        (gx,) = paddle.grad(paddle.tanh(x @ w).sum(), x, create_graph=True)
        (gw,) = paddle.grad(((gx * gx).sum() - 1.0) ** 2, w)
        return [gx.numpy(), gw.numpy()]

    def triple():
        x = t([1.5])
        (g1,) = paddle.grad((x ** 4).sum(), x, create_graph=True)
        (g2,) = paddle.grad(g1.sum(), x, create_graph=True)
        (g3,) = paddle.grad(g2.sum(), x)
        return [g1.numpy(), g2.numpy(), g3.numpy()]

    def hooks():
        x = t([1.0, 2.0])
        h = x.register_hook(lambda g: g * 2)
        (x * 3).sum().backward()
        first = x.grad.numpy()
        h.remove()
        x.clear_grad()
        y = x * 2
        y.retain_grads()
        (y * 3).sum().backward()
        return [first, x.grad.numpy(), y.grad.numpy()]

    def pylayer():
        class Cube(paddle.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x * x

            @staticmethod
            def backward(ctx, grad):
                (x,) = ctx.saved_tensor()
                return grad * 3 * x * x

        x = t([1.0, -2.0])
        y = Cube.apply(x)
        y.sum().backward()
        try:
            paddle.grad(Cube.apply(x).sum(), x, create_graph=True)
        except NotImplementedError:
            raised = 1.0
        else:
            raised = 0.0
        return [y.numpy(), x.grad.numpy(), np.asarray(raised)]

    def cut():
        x = t([2.0])
        y = x * 3
        (gx,) = paddle.grad(y * x, x, no_grad_vars=[y])
        z = x * 5
        before = z * z
        z.stop_gradient = True
        (before + z * 7).sum().backward()
        return [gx.numpy(), x.grad.numpy()]

    def cut_uses():
        x = t([2.0, 3.0])
        z = x * 5
        total = (z * z).sum()
        z.stop_gradient = True
        uses = [z[0] * 7, z[1:].sum() * 2, z.reshape([2, 1]).sum() * 3,
                z.astype("float64").astype("float32").sum(),
                z.to("float32").sum() * 4, z.clone().sum() * 5,
                z.transpose([0]).sum(), paddle.concat([z, z]).sum()]
        for u in uses:
            total = total + u
        total.backward()
        moved = [z.cpu(), z.cuda() if dev == "gpu" else z.cpu()]
        return [x.grad.numpy(), np.asarray(
            [u.stop_gradient for u in uses + moved], np.float32)]

    return {"double backward": double, "gradient penalty": penalty,
            "triple backward": triple, "hooks and retain_grads": hooks,
            "PyLayer (and create_graph through it raising)": pylayer,
            "no_grad_vars and a non-leaf's stop_gradient": cut,
            "a cut non-leaf indexed, reshaped, cast, cloned and moved":
            cut_uses}


def eager_autograd_phase(torch):
    """The autograd cases of ``tests/test_torch_autograd.py`` on the card
    against the CPU, f32 within EAGER_F32: double and triple backward, the
    gradient penalty through a matmul, hooks, ``retain_grads``, a
    ``PyLayer`` (its ``create_graph`` pass raising
    ``NotImplementedError``), ``no_grad_vars`` and ``stop_gradient`` set
    on a non-leaf (every later use: operators, indexing, reshaping, casts,
    ``clone``, ``to`` / ``cpu`` / ``cuda``, ops)."""
    import numpy as np

    import paddle_tpu_torch as paddle

    print("[eager autograd] paddle.grad / backward / hooks / PyLayer on the "
          "card against the CPU")
    card = _autograd_cases(paddle, "gpu")
    cpu = _autograd_cases(paddle, "cpu")
    with tf32_off(torch):
        for name, fn in card.items():
            got, want = fn(), cpu[name]()
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, err_msg=name, **EAGER_F32)
            print(f"  {name}: card equals CPU ({len(got)} results)")
        if not card["PyLayer (and create_graph through it raising)"]()[2]:
            raise AssertionError("create_graph through a PyLayer did not "
                                 "raise NotImplementedError")


def _static_held(torch, K, what, fn, x, want, ref16, dtype, totals):
    """``fn(x)`` once with the launch counters zeroed: its output against
    the eager f32 forward ``want`` (f32: STATIC_F32_REL_L2; bf16:
    STATIC_BF16_RATIO x ``ref16``, the eager bf16 forward's error), and
    exactly the STATIC_PER_FORWARD launches of its depth (f32:
    STATIC_F32_LAYERS layers, bf16: 12), every flash one of the design of
    ``dtype`` (bf16: sm90, f32: mma). Adds the counts to ``totals``;
    returns the output and the call's wall seconds (a first call compiles)."""
    design = "sm90" if dtype == torch.bfloat16 else "mma"
    per_forward = STATIC_PER_FORWARD[
        12 if dtype == torch.bfloat16 else STATIC_F32_LAYERS]
    K.reset_launch_counts()
    t0 = time.monotonic()
    with torch.no_grad(), tf32_off(torch):
        out = fn(x)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = K.launch_counts()
    for k, v in counts.items():
        totals[k] += v
    err = rel_l2(out.float(), want)
    limit = (STATIC_F32_REL_L2 if dtype == torch.float32
             else STATIC_BF16_RATIO * ref16)
    launched = {k: counts[k] for k in per_forward}
    print(f"  {what} {tuple(x.shape)}: relative L2 {err:.3e} vs eager f32 "
          f"(limit {limit:.3e}), launches {launched}, "
          f"flash_attention_{design} {counts[f'flash_attention_{design}']}, "
          f"{wall:.2f} s")
    if not (torch.isfinite(out).all() and out.shape == (x.shape[0], 2)
            and err <= limit):
        raise AssertionError(f"{what}: output off by {err} (limit {limit})")
    if launched != per_forward or \
            counts[f"flash_attention_{design}"] != \
            per_forward["flash_attention"]:
        raise AssertionError(f"{what}: launches {counts}, want "
                             f"{per_forward} of the {design} design")
    return out, wall


def _serve_timing(torch, what, fn, xs):
    """ms per batch at batch 1 (median of STATIC_TIMED[1]), sequences/s at
    batch 32 (median of STATIC_TIMED[32]), and device busy against host
    wall over 5 profiled batch-1 calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    row = {}
    with torch.no_grad():
        for b, n in STATIC_TIMED.items():
            x = xs[b]
            fn(x)
            torch.cuda.synchronize()
            ts = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            row[b] = sorted(ts)[n // 2]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                fn(xs[1])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 5
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_ms(kernels) / 5
    print(f"  {what}: batch 1 {row[1]:.3f} ms (median of {STATIC_TIMED[1]}),"
          f" batch 32 {32e3 / row[32]:.1f} sequences/s ({row[32]:.3f} ms, "
          f"median of {STATIC_TIMED[32]}); batch 1 under the profiler: "
          f"device busy {busy:.3f} ms of {wall:.3f} ms host wall "
          f"({100 * busy / wall:.1f} %)")
    return row


def static_deploy_phases(torch, K):
    """The static-graph and deployment path: ERNIE-3.0-Base sequence
    classification (``ernie_base()``, 2 classes, eval, seeded random
    weights) in f32 and bf16 through ``jit.to_static`` ([to_static
    ernie]), ``jit.save`` / ``jit.load`` with a ``[None, None]`` int64 spec
    serving three shapes from one artifact, also in a fresh child process
    ([jit ernie]), the predictor's handle workflow and a clone on a second
    stream ([predictor ernie]), and a ``static`` Program over
    ``static.data("input_ids", [None, 128])`` through ``Executor.run``,
    ``save_inference_model`` and a predictor over it ([static ernie]);
    then ``static.nn``'s builders, ``cond``, ``while_loop`` and
    ``gradients`` on the card against the same program on the CPU ([static
    nn]). Returns the launches of the held runs."""
    import shutil

    from paddle_tpu_torch import inference, jit, static
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         ernie_base)

    here = os.path.dirname(os.path.abspath(__file__))
    art = os.path.join(here, "paddle_tpu_torch", "csrc", "build",
                       "artifacts")
    shutil.rmtree(art, ignore_errors=True)
    os.makedirs(art)
    cfg = ernie_base()
    f32, bf16 = torch.float32, torch.bfloat16
    full32 = ErnieForSequenceClassification(cfg, device="cuda",
                                            seed=0).eval()
    models = {f32: ErnieForSequenceClassification(
        dataclasses.replace(cfg, num_hidden_layers=STATIC_F32_LAYERS),
        device="cuda", seed=0).eval()}
    models[bf16] = ErnieForSequenceClassification(
        cfg, device="cuda", dtype=bf16, seed=0).eval()
    models[bf16].set_state_dict(full32.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(15)
    shapes = (*STATIC_BATCHES, STATIC_EXTRA)
    ids = {s: torch.randint(5, cfg.vocab_size, s, device="cuda",
                            generator=gen) for s in shapes}
    with torch.no_grad(), tf32_off(torch):
        # each dtype against its own depth's eager f32 forward
        want = {(dt, s): m(x).float() for dt, m in ((f32, models[f32]),
                                                    (bf16, full32))
                for s, x in ids.items()}
        ref16 = {s: rel_l2(models[bf16](x).float(), want[bf16, s])
                 for s, x in ids.items()}
    del full32
    print(f"[to_static ernie] ERNIE-3.0-Base classification, "
          f"{sum(p.numel() for p in models[bf16].parameters()) / 1e6:.1f} M "
          f"parameters (bf16; the f32 pairs cut to {STATIC_F32_LAYERS} "
          f"layers), unmasked batches {list(shapes)}; eager bf16 vs f32 "
          f"relative L2 "
          + ", ".join(f"{s}: {e:.3e}" for s, e in ref16.items())
          + f"; {card_line()}")
    totals = {k: 0 for k in K.LAUNCHES}

    def held(what, fn, s, dt):
        return _static_held(torch, K, what, fn, ids[s], want[dt, s],
                            ref16[s], dt, totals)

    big, one = STATIC_BATCHES
    xs = {1: ids[one], 32: ids[big]}
    sfs = {dt: jit.StaticFunction(m) for dt, m in models.items()}
    held("to_static f32", sfs[f32], big, f32)
    for s in STATIC_BATCHES:
        _, wall = held("to_static bf16", sfs[bf16], s, bf16)
        print(f"  compile + first call of to_static bf16 {s}: {wall:.1f} s")
    timing = {"eager": _serve_timing(torch, "eager bf16", models[bf16], xs),
              "to_static": _serve_timing(torch, "to_static bf16", sfs[bf16],
                                         xs)}

    print(f"[jit ernie] jit.save, input spec [None, None] int64; "
          f"{card_line()}")
    prefix = {dt: os.path.join(art, f"ernie_{str(dt)[6:]}")
              for dt in models}
    for dt, m in models.items():
        t0 = time.monotonic()
        jit.save(m, prefix[dt], input_spec=[([None, None], "int64")])
        print(f"  jit.save {dt}: {time.monotonic() - t0:.1f} s, .pdmodel "
              f"{os.path.getsize(prefix[dt] + '.pdmodel') / 1e6:.2f} MB, "
              f".pdiparams "
              f"{os.path.getsize(prefix[dt] + '.pdiparams') / 1e6:.1f} MB")
    loaded = {dt: jit.load(prefix[dt]) for dt in models}
    held("jit.load f32", loaded[f32], big, f32)
    for s in shapes:
        held("jit.load bf16", loaded[bf16], s, bf16)
    ids_path = os.path.join(art, "ids.npy")
    out_path = os.path.join(art, "out.npy")
    import numpy as np
    np.save(ids_path, ids[STATIC_EXTRA].cpu().numpy())
    child = (
        "import sys, numpy as np, torch\n"
        "import paddle_tpu_torch as paddle\n"
        f"layer = paddle.jit.load({prefix[bf16]!r})\n"
        f"x = torch.as_tensor(np.load({ids_path!r})).cuda()\n"
        "out = layer(x).float().cpu().numpy()\n"
        f"np.save({out_path!r}, out)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'paddle_tpu.'))"
        " or m == 'paddle_tpu' for m in sys.modules)\n")
    t0 = time.monotonic()
    subprocess.run([sys.executable, "-c", child], check=True, timeout=600,
                   cwd=here)
    got = torch.as_tensor(np.load(out_path), device="cuda")
    err = rel_l2(got, want[bf16, STATIC_EXTRA])
    limit = STATIC_BF16_RATIO * ref16[STATIC_EXTRA]
    print(f"  fresh process (imports paddle_tpu_torch only) "
          f"{STATIC_EXTRA}: relative L2 {err:.3e} vs eager f32 (limit "
          f"{limit:.3e}), {time.monotonic() - t0:.1f} s")
    if not err <= limit:
        raise AssertionError(f"fresh-process load off by {err}")

    print(f"[predictor ernie] create_predictor over the jit.save artifact "
          f"(f32 at {STATIC_F32_LAYERS} layers with IR optimisation: "
          f"torch.compile, {jit.DEFAULT_BACKEND}; bf16 at 12 layers the "
          f"exported program as it is); {card_line()}")
    preds = {}
    for dt in models:
        config = inference.Config(prefix[dt] + ".pdmodel",
                                  prefix[dt] + ".pdiparams")
        # the predictor's compile is held at the f32 depth: each 12-layer
        # bf16 compile cost 24-40 s, and to_static holds that program
        config.switch_ir_optim(dt == f32)
        preds[dt] = inference.create_predictor(config)

    def handles(p):
        def run(x):
            h = p.get_input_handle("input_0")
            h.share_external_data(x)
            if h._value.data_ptr() != x.data_ptr():
                raise AssertionError("share_external_data copied")
            p.run()
            return p.get_output_handle("output_0")._value
        return run

    _, wall = held("predictor f32", handles(preds[f32]), big, f32)
    print(f"  compile + first call of predictor f32 {big}: {wall:.1f} s")
    for s in STATIC_BATCHES:
        held("predictor bf16", handles(preds[bf16]), s, bf16)
    p0 = preds[bf16]
    p0.get_input_handle("input_0").copy_from_cpu(ids[big].cpu().numpy())
    p0.run()
    host = p0.get_output_handle("output_0").copy_to_cpu()
    err = rel_l2(torch.as_tensor(host, device="cuda"), want[bf16, big])
    clone, side = p0.clone(), torch.cuda.Stream()
    with torch.cuda.stream(side):
        held("predictor clone bf16 (second stream)", handles(clone), one,
             bf16)
    print(f"  copy_from_cpu / copy_to_cpu {big}: relative L2 {err:.3e}; "
          f"the clone shares the program: {clone._served is p0._served}")
    if not (err <= STATIC_BF16_RATIO * ref16[big]
            and clone._served is p0._served):
        raise AssertionError("predictor handle workflow disagrees")
    timing["predictor"] = _serve_timing(
        torch, "predictor bf16 (the exported program)", handles(p0), xs)

    print(f"[static ernie] static.data('input_ids', [None, 128]), "
          f"Executor.run (compiled, f32 at {STATIC_F32_LAYERS} layers), "
          f"save_inference_model and a "
          f"predictor over it (the exported graph, f32 and bf16); "
          f"{card_line()}")
    for dt, m in models.items():
        main_prog = static.Program()
        with static.program_guard(main_prog):
            x = static.data("input_ids", [None, 128], "int64")
            logits = m(x)
        exe = static.Executor()
        name = str(dt)[6:]
        if dt == f32:
            # the compiled route is held once, in f32 at STATIC_F32_LAYERS
            # layers (to_static holds the compiled 12-layer bf16 forward,
            # whose every compile costs 25-47 s)
            def run(v, exe=exe, prog=main_prog, logits=logits):
                return exe.run(prog, feed={"input_ids": v},
                               fetch_list=[logits], return_numpy=False)[0]

            held(f"Executor.run {name}", run, big, dt)
            if exe._trace_count != 1:
                raise AssertionError(f"Executor compiled "
                                     f"{exe._trace_count} times for one "
                                     f"signature")
        sprefix = os.path.join(art, f"static_{name}")
        static.save_inference_model(sprefix, [x], [logits], exe,
                                    program=main_prog)
        config = inference.Config(sprefix + ".pdmodel",
                                  sprefix + ".pdiparams")
        config.switch_ir_optim(False)
        sp = inference.create_predictor(config)
        held(f"predictor over save_inference_model {name}", handles(sp),
             big, dt)
    static_nn_phase(torch)
    shutil.rmtree(art, ignore_errors=True)
    print("[static timing] " + json.dumps(
        {k: {"batch1_ms": v[1], "batch32_seq_per_s": 32e3 / v[32]}
         for k, v in timing.items()}) + f"; {card_line()}")
    return totals


def static_nn_phase(torch):
    """``static.nn``'s builders, ``cond``, ``while_loop`` and ``gradients``
    in one program on the card against the same program (the card's
    parameter values) on the CPU, f32 with TF32 off."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.core import device as tdevice

    def build():
        x = static.data("x", [None, 6], "float32")
        ids = static.data("ids", [None, 5], "int64")
        img = static.data("img", [None, 3, 8, 8], "float32")
        h = static.nn.fc(x, 8, activation="relu", name="fc1")
        out = static.nn.fc(h, 2, name="fc2")
        loss = paddle.mean(out * out)
        main = static.default_main_program()
        (gw,) = static.gradients([loss], [main._params["fc1.w"]])
        emb = static.nn.embedding(ids, (30, 8), name="emb")
        c = static.nn.conv2d(img, 4, 3, padding=1, act="relu", name="c")
        flag = static.nn.cond(paddle.sum(x) > 0, lambda: out * 2,
                              lambda: out - 1)
        _, halved = static.nn.while_loop(
            lambda i, v: paddle.max(paddle.abs(v)) > 1.0,
            lambda i, v: [i + 1, v / 2], [paddle.zeros([]), x * 8])
        return [loss, gw, emb, c, static.nn.batch_norm(c, name="bn"),
                static.nn.layer_norm(emb, begin_norm_axis=2),
                static.nn.group_norm(c, groups=2, name="gn"),
                static.nn.instance_norm(c, name="in"),
                static.nn.prelu(c, mode="channel", name="pr"), flag, halved]

    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(4, 6).astype(np.float32) - 0.3,
            "ids": rng.randint(0, 30, (4, 5)),
            "img": rng.rand(4, 3, 8, 8).astype(np.float32)}
    runs = {}
    prev = tdevice._state["device"]
    for dev in ("cuda", "cpu"):
        paddle.set_device(dev)
        scope = static.Scope()
        with static.scope_guard(scope):
            main = static.Program()
            with static.program_guard(main):
                fetches = build()
            if dev == "cpu":
                # the card's values, parameter by parameter in creation
                # order (default names count on)
                for name, value in zip(main._params,
                                       runs["cuda"][1].values()):
                    scope.var(name).set(value)
            exe = static.Executor()
            # the card's program compiles with inductor; the CPU reference
            # with aot_eager (inductor's CPU code needs a C++ toolchain)
            backend = jit.DEFAULT_BACKEND
            jit.DEFAULT_BACKEND = backend if dev == "cuda" else "aot_eager"
            try:
                with tf32_off(torch):
                    outs = exe.run(main, feed=feed, fetch_list=fetches)
            finally:
                jit.DEFAULT_BACKEND = backend
            runs[dev] = (outs, {n: scope.find_var(n).get_tensor().cpu()
                                for n in main._params}, exe)
    tdevice._state["device"] = prev
    worst = 0.0
    for got, want in zip(runs["cuda"][0], runs["cpu"][0]):
        np.testing.assert_allclose(got, want, **STATIC_NN_F32)
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"[static nn] fc / embedding / conv2d / batch_norm / layer_norm / "
          f"group_norm / instance_norm / prelu, cond, while_loop, gradients: "
          f"card vs CPU max |diff| {worst:.3e} (rtol "
          f"{STATIC_NN_F32['rtol']:g}, atol {STATIC_NN_F32['atol']:g}); "
          f"compiles {runs['cuda'][2]._trace_count}")


def llama_deploy_model(torch, cfg, dtype, state=None):
    """``LlamaForCausalLM`` at ``cfg``, eval, on the card: seeded random
    weights, or ``state`` (a Paddle state dict) cast to ``dtype``."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    gen = torch.Generator(device="cuda").manual_seed(18)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=dtype, generator=gen)
    if state is not None:
        model.set_state_dict(state)
    return model.eval()


def _median_ms(torch, fn, x, n):
    with torch.no_grad():
        fn(x)
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[n // 2]


def llama_deploy_phase(torch, K):
    """``[to_static llama]``: Llama-2 at 7B widths (``llama_7b()``, depth
    cut to LLAMA_DEPLOY_LAYERS), bf16, eval, seeded weights, through
    ``jit.to_static`` (inductor) at each of LLAMA_DEPLOY_SHAPES, then
    ``jit.save`` with a ``[None, None]`` int64 spec and ``jit.load``
    serving both shapes from the one artifact. Each forward within
    STATIC_BF16_RATIO x the eager bf16 forward's own error against the
    eager f32 one (TF32 off), with exactly LLAMA_DEPLOY_PER_FORWARD
    launches (sm90 flash). Prints eager / to_static / jit.load ms a
    forward (median of LLAMA_DEPLOY_TIMED). Returns the held runs'
    launches, the bf16 model and its ids."""
    import shutil

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import llama_7b

    here = os.path.dirname(os.path.abspath(__file__))
    art = os.path.join(here, "paddle_tpu_torch", "csrc", "build",
                       "artifacts_llama")
    shutil.rmtree(art, ignore_errors=True)
    os.makedirs(art)
    cfg = llama_7b()
    cfg.num_hidden_layers = LLAMA_DEPLOY_LAYERS
    m32 = llama_deploy_model(torch, cfg, torch.float32)
    m16 = llama_deploy_model(torch, cfg, torch.bfloat16, m32.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(19)
    ids = {s: torch.randint(0, cfg.vocab_size, s, device="cuda",
                            generator=gen) for s in LLAMA_DEPLOY_SHAPES}
    with torch.no_grad(), tf32_off(torch):
        want = {s: m32(x).float() for s, x in ids.items()}
        ref16 = {s: rel_l2(m16(x).float(), want[s]) for s, x in ids.items()}
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[to_static llama] LlamaForCausalLM at llama_7b() widths (hidden "
          f"4096, 32 heads of 128, FFN 11008, vocab 32000), depth cut to "
          f"{LLAMA_DEPLOY_LAYERS} layers (of 32) to fit the smoke's time, "
          f"bf16, eval, seeded weights, "
          f"{m16.num_params() / 1e6:.1f} M parameters; ids "
          f"{list(LLAMA_DEPLOY_SHAPES)}; eager bf16 vs f32 relative L2 "
          + ", ".join(f"{s}: {e:.3e}" for s, e in ref16.items())
          + f"; {card_line()}")
    totals = {k: 0 for k in K.LAUNCHES}

    def held(what, fn, s):
        K.reset_launch_counts()
        t0 = time.monotonic()
        with torch.no_grad():
            out = fn(ids[s])
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = K.launch_counts()
        for k, v in counts.items():
            totals[k] += v
        err = rel_l2(out.float(), want[s])
        limit = STATIC_BF16_RATIO * ref16[s]
        launched = {k: counts[k] for k in LLAMA_DEPLOY_PER_FORWARD}
        print(f"  {what} {s}: relative L2 {err:.3e} vs eager f32 (limit "
              f"{limit:.3e}), launches {launched}, flash_attention_sm90 "
              f"{counts['flash_attention_sm90']}, {wall:.2f} s")
        if not (torch.isfinite(out).all() and err <= limit
                and tuple(out.shape) == (*s, cfg.vocab_size)):
            raise AssertionError(f"{what} {s}: off by {err} (limit {limit})")
        if launched != LLAMA_DEPLOY_PER_FORWARD or \
                counts["flash_attention_sm90"] != LLAMA_DEPLOY_LAYERS:
            raise AssertionError(f"{what} {s}: launches {counts}, want "
                                 f"{LLAMA_DEPLOY_PER_FORWARD} (sm90)")

    sf = jit.StaticFunction(m16)
    for s in LLAMA_DEPLOY_SHAPES:
        held("to_static bf16 (compile + first call)", sf, s)
    prefix = os.path.join(art, "llama")
    t0 = time.monotonic()
    jit.save(m16, prefix, input_spec=[([None, None], "int64")])
    print(f"  jit.save: {time.monotonic() - t0:.1f} s, .pdmodel "
          f"{os.path.getsize(prefix + '.pdmodel') / 1e6:.2f} MB, .pdiparams "
          f"{os.path.getsize(prefix + '.pdiparams') / 1e6:.1f} MB")
    loaded = jit.load(prefix)
    for s in LLAMA_DEPLOY_SHAPES:
        held("jit.load bf16 (one artifact)", loaded, s)
    timing = {name: {f"{s[0]}x{s[1]}": _median_ms(torch, fn, ids[s],
                                                  LLAMA_DEPLOY_TIMED)
                     for s in LLAMA_DEPLOY_SHAPES}
              for name, fn in (("eager", m16), ("to_static", sf),
                               ("jit.load", loaded))}
    print("[llama deploy timing] ms a forward (median of "
          f"{LLAMA_DEPLOY_TIMED}): " + json.dumps(timing)
          + f"; {card_line()}")
    shutil.rmtree(art, ignore_errors=True)
    return totals, m16, ids


def llama_static_grad_phase(torch, K, model, ids):
    """``[static llama grad]``: a ``static`` Program over the bf16 model of
    ``[to_static llama]`` on ``static.data("ids", [None, S])``, the mean
    softmax-CE of the next token (labels the ids shifted by one) and
    ``static.gradients`` of it with respect to every parameter, fetched
    through ``Executor.run`` (one compiled program, inductor). Every
    gradient within STATIC_GRAD_REL_L2 of eager autograd's on the card;
    the kernels of STATIC_GRAD_KERNELS each launched inside the program.
    Returns the compiled run's launches."""
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.nn import functional as F

    x = ids[LLAMA_DEPLOY_SHAPES[-1]]
    V = model.config.vocab_size

    def loss_of(logits, tok):
        return F.cross_entropy(logits[:, :-1].reshape([-1, V]),
                               tok[:, 1:].reshape([-1]))

    params = list(model.parameters())
    for p in params:
        p.grad = None
    loss = loss_of(model(x), x)
    loss.backward()
    want = [torch.Tensor.detach(p.grad).clone() for p in params]
    want_loss = loss.item()
    for p in params:
        p.grad = None
    main = static.Program()
    t0 = time.monotonic()
    with static.program_guard(main):
        tok = static.data("ids", [None, x.shape[1]], "int64")
        target = loss_of(model(tok), tok)
        grads = static.gradients([target], params)
    build = time.monotonic() - t0
    exe = static.Executor()
    K.reset_launch_counts()
    t0 = time.monotonic()
    outs = exe.run(main, feed={"ids": x}, fetch_list=[target, *grads],
                   return_numpy=False)
    torch.cuda.synchronize()
    first = time.monotonic() - t0
    counts = K.launch_counts()
    t0 = time.monotonic()
    exe.run(main, feed={"ids": x}, fetch_list=[target, *grads],
            return_numpy=False)
    torch.cuda.synchronize()
    again = (time.monotonic() - t0) * 1e3
    errs = [rel_l2(g.float(), w.float()) for g, w in zip(outs[1:], want)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    names = [n for n, _ in model.named_parameters()]
    launched = {k: counts[k] for k in STATIC_GRAD_KERNELS}
    print(f"[static llama grad] static.data('ids', [None, {x.shape[1]}]), "
          f"mean softmax-CE of the next token, static.gradients w.r.t. all "
          f"{len(params)} parameters, Executor.run ({jit.DEFAULT_BACKEND}) at "
          f"{tuple(x.shape)}; the model of [to_static llama]; "
          f"{card_line()}")
    print(f"  loss {outs[0].item():.6f} (eager {want_loss:.6f}); gradients "
          f"vs eager autograd: worst relative L2 {errs[worst]:.3e} "
          f"({names[worst]}; limit {STATIC_GRAD_REL_L2:g}), median "
          f"{sorted(errs)[len(errs) // 2]:.3e}; launches {launched}; "
          f"build {build:.1f} s, compile + first run {first:.1f} s, a "
          f"second run {again:.1f} ms; compiles {exe._trace_count}")
    if not errs[worst] <= STATIC_GRAD_REL_L2 or \
            not abs(outs[0].item() - want_loss) <= 1e-2 * abs(want_loss):
        raise AssertionError(f"static gradients off: {errs[worst]} at "
                             f"{names[worst]}")
    if not all(launched.values()) or exe._trace_count != 1:
        raise AssertionError(f"static llama grad: launches {launched}, "
                             f"compiles {exe._trace_count}")
    del outs, want
    return counts


def _compiled_case(torch, K, jit, name, fn, args, eager_fn, want_counts,
                   exact=True, tol=None):
    """``fn(*args)`` through ``jit.to_static(backend="aot_eager")`` against
    ``eager_fn(*args)`` (the eager launches, direct): each output bitwise
    equal (``exact``) or within ``tol`` (atol, rtol), and the program's
    launches exactly ``want_counts``. Returns the largest difference."""
    prog = jit.to_static(fn, backend="aot_eager")
    K.reset_launch_counts()
    got = prog(*args)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    want = eager_fn(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for a, b in zip(got, want):
        a, b = torch.Tensor.detach(a), torch.Tensor.detach(b)
        if exact and not torch.equal(a, b):
            raise AssertionError(f"[compiled kernels] {name}: the compiled "
                                 f"program's bits differ from eager's")
        d = (a.float() - b.float()).abs().max().item() if a.numel() else 0.0
        if not exact and not d <= tol[0] + tol[1] * b.float().abs().max():
            raise AssertionError(f"[compiled kernels] {name}: off by {d}")
        worst = max(worst, d)
    moved = {k: counts[k] for k in want_counts}
    print(f"  {name}: {'bitwise equal' if exact else f'max |diff| {worst:.3e}'}"
          f" to eager; launches in the program {moved}")
    if moved != want_counts:
        raise AssertionError(f"[compiled kernels] {name}: launches {counts}, "
                             f"want {want_counts}")
    return worst


def compiled_kernels_phase(torch, K):
    """``[compiled kernels]``: every registered op in a small
    ``jit.to_static(backend="aot_eager")`` program on the card, held
    against the eager launches of the same inputs, bitwise (every kernel
    here is deterministic: no atomics, fixed-order sums), the counters
    moving inside the ops: flash forward and backward (rows 1, 2; causal
    and a bool mask, rows 1a / 2a; dropout with an explicit seed, which
    the program reads as a device tensor), varlen (1b / 2b), paged
    attention (3), RMSNorm (4 / 5), softmax-CE (6 / 7), CTC (9 / 10),
    RNN-T (11 / 12); then dropout without a seed: two calls of one
    program drop different masks. Backward rows run as
    ``torch.func.grad`` inside the program, against ``backward()``."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.kernels import ctc as C
    from paddle_tpu_torch.kernels import flash_attention as F
    from paddle_tpu_torch.kernels import paged_attention as P
    from paddle_tpu_torch.kernels import rnnt as R
    from paddle_tpu_torch.kernels.rmsnorm import rmsnorm
    from paddle_tpu_torch.kernels.softmax_ce import softmax_ce

    t0 = time.monotonic()
    print(f"[compiled kernels] every registered op in a to_static "
          f"(aot_eager) program vs its eager launch; {card_line()}")
    g = torch.Generator(device="cuda").manual_seed(20)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def with_grads(f, n):
        """``f``'s outputs and the gradients of ``sum(out0 * cot)`` w.r.t.
        its first ``n`` arguments, through ``torch.func.grad`` (the
        program: one forward, its outputs as the aux) and ``backward()``
        (eager)."""
        def program(*a):
            *xs, cot = a

            def loss(*d):
                # an alias of each grad input: see static._GradNode
                outs = f(*(t.view_as(t) for t in d), *xs[n:])
                return (outs[0].float() * cot).sum(), outs

            grads, outs = torch.func.grad(loss, argnums=tuple(range(n)),
                                          has_aux=True)(*xs[:n])
            return (*outs, *grads)

        def eager(*a):
            *xs, cot = a
            leaves = [x.detach().requires_grad_() for x in xs[:n]]
            outs = f(*leaves, *xs[n:])
            (outs[0].float() * cot).sum().backward()
            return (*(o.detach() for o in outs),
                    *(x.grad for x in leaves))
        return program, eager

    # flash, dense: causal, bool mask, dropout with an explicit seed
    q, k, v = rnd(2, 256, 8, 128), rnd(2, 256, 8, 128), rnd(2, 256, 8, 128)
    mask = torch.rand(2, 1, 256, 256, device="cuda", generator=g) > 0.2
    cot = rnd(2, 256, 8, 128, dtype=torch.float32)
    for name, kw, counts in (
            ("flash causal (rows 1 / 2)", dict(causal=True),
             {"flash_attention": 1, "flash_attention_bwd": 1}),
            ("flash bool mask (rows 1a / 2a)", dict(mask=mask),
             {"flash_attention_mask": 1, "flash_attention_bwd_mask": 1}),
            ("flash dropout 0.1, seed 1234", dict(dropout_p=0.1, seed=1234),
             {"flash_attention_dropout": 1,
              "flash_attention_bwd_dropout": 1})):
        prog, eager = with_grads(
            lambda q_, k_, v_, kw=kw: F.flash_attention_fwd(q_, k_, v_,
                                                            **kw), 3)
        _compiled_case(torch, K, jit, name, prog, (q, k, v, cot), eager,
                       counts)
    drop = jit.to_static(
        lambda q_: F.flash_attention_fwd(q_, q_, q_, dropout_p=0.1)[0],
        backend="aot_eager")
    a, b = drop(q), drop(q)
    if torch.equal(a, b):
        raise AssertionError("[compiled kernels] compiled dropout drew the "
                             "same mask twice")
    print(f"  flash dropout without a seed: two calls of one program differ "
          f"in {(a != b).float().mean().item() * 100:.1f} % of outputs")
    # varlen: 4 documents in 1024 tokens, causal, max_seqlen given
    cu = torch.tensor([0, 300, 317, 800, 1024], device="cuda",
                      dtype=torch.int32)
    vq, vk, vv = (rnd(1024, 8, 128) for _ in range(3))
    vcot = rnd(1024, 8, 128, dtype=torch.float32)
    prog, eager = with_grads(
        lambda q_, k_, v_, c: F.flash_attn_varlen(
            q_, k_, v_, c, c, causal=True, max_seqlen_q=483,
            max_seqlen_k=483), 3)
    _compiled_case(torch, K, jit, "flash varlen (rows 1b / 2b)", prog,
                   (vq, vk, vv, cu, vcot), eager,
                   {"flash_attention_varlen": 1,
                    "flash_attention_bwd_varlen": 1})
    # paged attention: 4 slots, bs 16, 32 heads of 128
    pool = rnd(4 * 64 + 1, 2, 32, 16, 128)
    pq = rnd(4, 32, 128)
    bt = (torch.randperm(256, device="cuda", generator=g) + 1).reshape(
        4, 64).to(torch.int32)
    ctx = torch.tensor([1, 17, 1000, 513], device="cuda", dtype=torch.int32)
    paged = lambda *a: (P.paged_attention(*a),)
    _compiled_case(torch, K, jit, "paged attention (row 3)", paged,
                   (pq, pool, bt, ctx), paged, {"paged_attention": 1})
    # RMSNorm and softmax-CE, forward and backward
    x, w = rnd(512, 4096), 1 + 0.1 * rnd(4096)
    prog, eager = with_grads(lambda x_, w_: (rmsnorm(x_, w_, 1e-5),), 2)
    _compiled_case(torch, K, jit, "rmsnorm (rows 4 / 5)", prog,
                   (x, w, rnd(512, 4096, dtype=torch.float32)), eager,
                   {"rmsnorm": 1, "rmsnorm_bwd": 1})
    logits = rnd(512, 32000)
    labels = torch.randint(0, 32000, (512,), device="cuda", generator=g)
    prog, eager = with_grads(lambda l_, y: (softmax_ce(l_, y),), 1)
    _compiled_case(torch, K, jit, "softmax-CE (rows 6 / 7)", prog,
                   (logits, labels, rnd(512, dtype=torch.float32)), eager,
                   {"softmax_ce": 1, "softmax_ce_bwd": 1})
    # CTC and RNN-T lattices
    lp, lbl, il, ll = ctc_batch(torch, 200, 4, 64, 20, 21, "cuda")
    prog, eager = with_grads(
        lambda lp_, *r: (C.ctc_lattice(lp_, *r, 0),), 1)
    _compiled_case(torch, K, jit, "CTC (rows 9 / 10)", prog,
                   (lp, lbl, il, ll, rnd(4, dtype=torch.float32)), eager,
                   {"ctc_alpha": 1, "ctc_beta": 1})
    blank, emit, tl, ul = rnnt_lattices(torch, 4, 100, 17, (60, 100),
                                        (8, 16), 22)
    prog, eager = with_grads(
        lambda b_, e_, *r: (R.rnnt_lattice(b_, e_, *r),), 2)
    _compiled_case(torch, K, jit, "RNN-T (rows 11 / 12)", prog,
                   (blank, emit, tl, ul, rnd(4, dtype=torch.float32)), eager,
                   {"rnnt_alpha": 1, "rnnt_beta_grad": 1})
    print(f"  [compiled kernels] {time.monotonic() - t0:.1f} s")


def ernie_lamb_phase(torch, K):
    """``[ernie lamb]``: ERNIE-3.0-Base MLM at its published width and depth,
    16 x 512, f32 parameters under ``auto_cast(O1, bf16)``, ``Lamb``
    (lamb_weight_decay 0.01, biases and norms excluded) over
    ``OneCycleLR`` with ``ClipGradByGlobalNorm(1.0)``, the large-batch
    pretraining optimizer of BERT / ERNIE (You et al. 2019), a warm-up step
    and LAMB_STEPS timed ones on one repeated seeded batch: losses finite
    and falling, ERNIE_PER_STEP launches a step; step wall (mean), the
    Lamb update's wall (one more step, split), peak memory. Returns the
    timed steps' launches."""
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.models import ErnieForMaskedLM, ernie_base
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Lamb, OneCycleLR

    B, S = 16, 512
    cfg = ernie_base()
    print(f"[ernie lamb] ERNIE-3.0-Base MLM (12 layers, hidden 768, vocab "
          f"40000, dropout 0.1 / 0.1), batch {B} x {S}, f32 params under "
          f"auto_cast(O1, bf16), Lamb (lamb_weight_decay 0.01, 1-D "
          f"parameters excluded) over OneCycleLR(max {LAMB_MAX_LR:g}, "
          f"{LAMB_STEPS + 2} steps), ClipGradByGlobalNorm(1.0); "
          f"{card_line()}")
    framework.seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = ErnieForMaskedLM(cfg, seed=0)
    sched = OneCycleLR(max_learning_rate=LAMB_MAX_LR,
                       total_steps=LAMB_STEPS + 2)
    opt = Lamb(learning_rate=sched, lamb_weight_decay=0.01,
               parameters=model.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0),
               exclude_from_weight_decay_fn=lambda p: p.dim() == 1)
    x, y = ernie_batch(torch, B, S, cfg.vocab_size, 1, "cuda")

    def forward_backward():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = mlm_loss(F, model, x, y)
        loss.backward()
        return loss

    def step():
        loss = forward_backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss

    t0 = time.monotonic()
    losses = [step().item()]                      # warm-up
    print(f"  warm-up step {time.monotonic() - t0:.2f} s, loss "
          f"{losses[0]:.4f}")
    K.reset_launch_counts()
    walls = []
    for _ in range(LAMB_STEPS):
        t0 = time.monotonic()
        losses.append(step().item())
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # one more step, split: forward + backward, then clipping and Lamb
    forward_backward()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    opt.step()
    torch.cuda.synchronize()
    update_ms = (time.monotonic() - t0) * 1e3
    opt.clear_grad()
    print(f"  losses {[round(v, 4) for v in losses]}")
    per_step = {k: counts[k] / LAMB_STEPS for k in ERNIE_PER_STEP}
    mean = sum(walls) / len(walls)
    print(f"  step wall {mean * 1e3:.1f} ms (mean of {LAMB_STEPS}, min "
          f"{min(walls) * 1e3:.1f}), {B * S / mean:.0f} tokens/s; clip + "
          f"Lamb update {update_ms:.1f} ms (one step, host clock around "
          f"synchronised calls); peak memory {peak / 2 ** 30:.2f} GiB; "
          f"launches per step {per_step}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite Lamb loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the Lamb loss did not fall: {losses}")
    if per_step != {k: float(v) for k, v in ERNIE_PER_STEP.items()}:
        raise AssertionError("the Lamb steps launched other kernels than "
                             "the model's structure gives")
    del model, opt
    return counts


def _optimizer_runs(torch, device):
    """Each optimizer the last optimizer slice added, 5 steps on seeded f32
    parameters and gradients on ``device``; LBFGS 5 steps of at most 4
    iterations on a seeded quadratic of f32 parameters, with and without
    its line search.
    Returns {name: [parameter arrays]}."""
    import numpy as np

    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.core.tensor import Parameter

    shapes = ((64, 48), (48,), ())

    def params(seed=0):
        rng = np.random.RandomState(seed)
        return [Parameter(torch.as_tensor(
            np.asarray(rng.randn(*s), dtype=np.float32), device=device),
            name=n) for n, s in zip(("weight", "bias", "scale"), shapes)]

    makes = {
        "Adagrad": lambda ps: O.Adagrad(0.1, parameters=ps,
                                        initial_accumulator_value=0.1),
        "RMSProp": lambda ps: O.RMSProp(0.01, rho=0.9, momentum=0.5,
                                        parameters=ps),
        "RMSProp centered": lambda ps: O.RMSProp(
            0.01, rho=0.9, momentum=0.5, centered=True, epsilon=1e-4,
            parameters=ps),
        "Adadelta": lambda ps: O.Adadelta(1.0, rho=0.9, parameters=ps),
        "Adamax": lambda ps: O.Adamax(0.02, parameters=ps),
        "Lamb": lambda ps: O.Lamb(0.05, parameters=ps),
        "AdamW lr_ratio, apply_decay_param_fun": lambda ps: O.AdamW(
            0.05, weight_decay=0.1, parameters=ps,
            lr_ratio=lambda p: 0.5 if p.dim() == 2 else 1.0,
            apply_decay_param_fun=lambda n: n != "bias"),
    }
    out = {}
    for name, make in makes.items():
        ps = params()
        opt = make(ps)
        for s in range(5):
            rng = np.random.RandomState(100 + s)
            for p, shp in zip(ps, shapes):
                p.grad = torch.as_tensor(
                    np.asarray(rng.randn(*shp), dtype=np.float32),
                    device=device)
            opt.step()
            opt.clear_grad()
        out[name] = [p.detach().cpu().numpy() for p in ps]
    # the quadratic's loss in f64 (x stays f32): near the minimiser the
    # line search compares losses a few f32 ulps apart, and f32 sums on the
    # card and the CPU round apart by an ulp, which flips its decisions
    rng = np.random.RandomState(3)
    a = rng.randn(32, 32)
    A = torch.as_tensor((a @ a.T + 32 * np.eye(32)) / 32, device=device)
    b = torch.as_tensor(rng.randn(32), device=device)
    for search in (None, "strong_wolfe"):
        x = Parameter(torch.zeros(32, device=device), name="x")
        opt = O.LBFGS(1.0, max_iter=4, line_search_fn=search, parameters=[x])

        def closure():
            opt.clear_grad()
            xd = x.double()
            loss = 0.5 * (xd * (A @ xd)).sum() - (b * xd).sum()
            loss.backward()
            return loss

        for _ in range(5):
            opt.step(closure)
        out[f"LBFGS {search}"] = [x.detach().cpu().numpy()]
    return out


def optimizers_phase(torch):
    """``[optimizers]``: every optimizer the last optimizer slice added
    (``_optimizer_runs``) on the card against the CPU, f32, TF32 off,
    within OPTIMIZERS_F32 (elementwise updates; Lamb's norms and LBFGS's
    dot products sum in another order on the card)."""
    import numpy as np

    t0 = time.monotonic()
    with tf32_off(torch):
        card = _optimizer_runs(torch, "cuda")
        cpu = _optimizer_runs(torch, "cpu")
    worst = {}
    for name, arrays in card.items():
        for got, want in zip(arrays, cpu[name]):
            np.testing.assert_allclose(got, want, err_msg=name,
                                       **OPTIMIZERS_F32)
        worst[name] = max(float(np.abs(g - w).max())
                          for g, w in zip(arrays, cpu[name]))
    print(f"[optimizers] 5 steps on the card vs the CPU, f32, TF32 off "
          f"(rtol {OPTIMIZERS_F32['rtol']:g}, atol "
          f"{OPTIMIZERS_F32['atol']:g}): max |diff| "
          + ", ".join(f"{n} {w:.2e}" for n, w in worst.items())
          + f"; {time.monotonic() - t0:.1f} s; {card_line()}")


# -- the rest of the op library ---------------------------------------------


def _flat_arrays(out):
    """numpy arrays of an op's Tensor leaves (tuples of tuples included)."""
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat_arrays(o)]
    return [out.numpy()] if hasattr(out, "numpy") else []


def op_aliases_phase(torch, K):
    """Each registry alias that reaches a hand-written kernel, called
    through ``OPS[name].fn`` at a shape of a model the port runs, forward
    and (where the kernel has one) backward: each of its kernels launched
    exactly once (the launch counters, zeroed just before and read just
    after), and the output and the gradients bit for bit the direct
    functional call's. Returns the aliases' launches."""
    import numpy as np

    from paddle_tpu_torch.nn import functional as NF
    from paddle_tpu_torch.ops.registry import OPS

    g = torch.Generator(device="cuda").manual_seed(23)
    bf16 = torch.bfloat16

    def rand(*shape, dt=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda", generator=g)
                ).to(dt)

    T, NSEQ, H, D = VARLEN_SHAPE
    cu = torch.tensor(varlen_cu(T, NSEQ), device="cuda")
    lp, labels, in_len, lbl_len = ctc_batch(torch, 400, 16, 128, 48, 5,
                                            "cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    r_labels = torch.randint(1, 128, (16, 48), device="cuda", generator=gen)
    r_tl = torch.randint(300, 401, (16,), device="cuda", generator=gen)
    r_ul = torch.randint(24, 49, (16,), device="cuda", generator=gen)
    ce_label = torch.randint(0, 32000, (8192, 1), device="cuda", generator=g)
    ln_w, ln_b = rand(768), rand(768, scale=0.1)
    # (alias, the direct functional, call(fn, *inputs) -> output, inputs,
    #  whether to differentiate, the kernels it must launch once each)
    cases = [
        ("flash_attn", NF.flash_attention,
         lambda fn, q, k, v: fn(q, k, v, causal=True)[0],
         [rand(1, 2048, 32, 128, dt=bf16) for _ in range(3)], True,
         {"flash_attention", "flash_attention_bwd"}),
        ("flash_attn_unpadded", NF.flash_attn_unpadded,
         lambda fn, q, k, v: fn(q, k, v, cu, cu, None, None,
                                1.0 / math.sqrt(D), causal=True)[0],
         [rand(T, H, D, dt=bf16) for _ in range(3)], True,
         {"flash_attention_varlen", "flash_attention_bwd_varlen"}),
        ("layer_norm", NF.layer_norm,
         lambda fn, x: fn(x, [768], ln_w, ln_b, 1e-5),
         [2 * rand(8192, 768) + 0.5], False, {"layernorm"}),
        ("cross_entropy_with_softmax", NF.softmax_with_cross_entropy,
         lambda fn, x: fn(x, ce_label),
         [rand(8192, 32000, dt=bf16, scale=2.0)], True,
         {"softmax_ce", "softmax_ce_bwd"}),
        ("warpctc", NF.ctc_loss,
         lambda fn, x: fn(x, labels, in_len, lbl_len),
         [lp], True, {"ctc_alpha", "ctc_beta"}),
        ("warprnnt", NF.rnnt_loss,
         lambda fn, x: fn(x, r_labels, r_tl, r_ul),
         [rand(16, 400, 49, 128)], True, {"rnnt_alpha", "rnnt_beta_grad"}),
    ]
    print("[op aliases] each alias that reaches a kernel, through "
          "OPS[name].fn, forward and backward: flash_attn [1, 2048, 32, "
          "128] bf16 causal, flash_attn_unpadded T 8192 of 16 documents x "
          "32 x 128 bf16 causal, layer_norm [8192, 768] f32, "
          "cross_entropy_with_softmax [8192, 32000] bf16, warpctc [400, 16, "
          "128] f32 L 48, warprnnt [16, 400, 49, 128] f32")
    total = {k: 0 for k in K.launch_counts()}
    design = ("_sm90", "_mma")

    def go(fn, call, inputs, grad, cot=None):
        ins = [t.detach().clone().requires_grad_(grad) for t in inputs]
        out = call(fn, *ins)
        if grad:
            if cot is None:
                cot = torch.randn(out.shape, device="cuda", generator=g,
                                  dtype=torch.float32).to(out.dtype) \
                    if out.dim() else torch.ones_like(out)
            out.backward(cot)
        torch.cuda.synchronize()
        return out, [t.grad for t in ins] if grad else [], cot

    for name, direct, call, inputs, grad, want in cases:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out, grads, cot = go(OPS[name].fn, call, inputs, grad)
        ms = (time.perf_counter() - t0) * 1e3
        counts = K.launch_counts()
        kernels = {k: v for k, v in counts.items()
                   if v and not k.endswith(design)}
        for k, v in counts.items():
            total[k] += v
        d_out, d_grads, _ = go(direct, call, inputs, grad, cot)
        same = torch.equal(out, d_out) and all(
            torch.equal(a, b) for a, b in zip(grads, d_grads))
        print(f"  {name} -> {getattr(direct, '__name__', direct)}: "
              f"launches {kernels} (designs "
              f"{ {k: v for k, v in counts.items() if v and k.endswith(design)} }), "
              f"bitwise equal to the direct call {same}; the alias's call "
              f"(forward and backward, the shape's first) {ms:.1f} ms")
        if set(kernels) != want or set(kernels.values()) != {1}:
            raise AssertionError(f"[op aliases] {name}: launched {kernels}, "
                                 f"want each of {sorted(want)} once")
        if not same:
            raise AssertionError(f"[op aliases] {name}: differs from the "
                                 f"direct call")
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"[op aliases] {name}: not finite")
    del cases, inputs
    return total


@contextlib.contextmanager
def host_syncs(torch, counter):
    """Count the card-to-host synchronisations made inside the block, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (reads of a
    value: ``.item()``, ``.cpu()``, ``nonzero``, ``torch.equal``, ...);
    the count is appended to ``counter``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counter.append(sum("synchroniz" in str(w.message) for w in caught))


def _det_stage(torch, what, fn, stats):
    """Run ``fn`` on the card (one warm-up, then one timed call with its
    host syncs counted), and record its ms, syncs and peak memory under
    ``what``."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs = []
    t0 = time.perf_counter()
    with host_syncs(torch, syncs):
        out = fn()
    torch.cuda.synchronize()
    stats[what] = {"ms": round((time.perf_counter() - t0) * 1e3, 3),
                   "host_syncs": syncs[0],
                   "peak_GiB": round(torch.cuda.max_memory_allocated()
                                     / 2 ** 30, 3)}
    return out


def _cpu_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, round((time.perf_counter() - t0) * 1e3, 1)


def _box_iou(a, b):
    import numpy as np

    x0 = np.maximum(a[:, None, 0], b[None, :, 0])
    y0 = np.maximum(a[:, None, 1], b[None, :, 1])
    x1 = np.minimum(a[:, None, 2], b[None, :, 2])
    y1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    area = lambda c: (c[:, 2] - c[:, 0]) * (c[:, 3] - c[:, 1])
    return inter / (area(a)[:, None] + area(b)[None] - inter + 1e-10)


def rows_agree(what, got, want, score_cuts=(), iou_cut=None):
    """Kept detection rows of the card (``got``) against the CPU's
    (``want``), ``[K, 6]`` (label, score, box) or ``[K, 4]`` boxes with
    ``[K]`` scores given as ``(boxes, scores)``: equal within DET_RTOL /
    DET_ATOL row for row, or else matched by label and box rounded to
    DET_KEY, every matched pair equal within DET_RTOL / DET_ATOL (score and
    box) and every row kept on one side only within DET_NEAR of a
    threshold: its score of a ``score_cuts`` entry (or of the other side's
    last kept score), or its IoU with a box of its label of ``iou_cut``.
    Returns ``[rows kept on one side only, matched rows out of place]``
    (both 0: equal row for row)."""
    import numpy as np

    def rows(x):
        if isinstance(x, tuple):
            b, s = x
            return np.concatenate([np.zeros((len(s), 1)), s[:, None], b], 1)
        return np.asarray(x, np.float64)

    a, b = rows(got), rows(want)
    if a.shape == b.shape and np.allclose(a, b, rtol=DET_RTOL,
                                          atol=DET_ATOL):
        return np.zeros(2, int)
    cuts = list(score_cuts) + [r[-1, 1] for r in (a, b) if len(r)]

    def key(r):
        return (int(r[0]),) + tuple(np.round(r[2:] / DET_KEY, 0).astype(int))

    free = {}
    for j, r in enumerate(b):
        free.setdefault(key(r), []).append(j)
    only, moved = [], 0
    for i, r in enumerate(a):
        js = free.get(key(r))
        if not js:
            only.append(r)
            continue
        j = js.pop(0)
        np.testing.assert_allclose(
            r, b[j], rtol=DET_RTOL, atol=DET_ATOL,
            err_msg=f"{what}: a row the card and the CPU both keep differs")
        moved += i != j
    only += [b[j] for js in free.values() for j in js]
    both = np.concatenate([a, b])
    for r in only:
        near = any(abs(r[1] - c) <= DET_NEAR for c in cuts)
        if not near and iou_cut is not None:
            same = both[both[:, 0] == r[0]]
            iou = _box_iou(r[None, 2:], same[:, 2:])[0]
            near = bool(np.any(np.abs(iou - iou_cut) <= DET_NEAR))
        if not near:
            raise AssertionError(f"{what}: the card and the CPU keep "
                                 f"different rows ({len(a)} vs {len(b)}), "
                                 f"{r} not within {DET_NEAR} of a threshold")
    return np.array([len(only), moved])


def agreement(counts):
    """``rows_agree``'s summed counts in words."""
    if not counts.any():
        return "identical"
    return (f"{counts[0]} rows kept on one side only, each within "
            f"{DET_NEAR} of a threshold; {counts[1]} rows kept by both "
            f"within {DET_RTOL} / {DET_ATOL} but out of place")


def ppyolo_phase(torch):
    """PP-YOLO R50vd-DCN post-processing at its published sizes
    (PaddleDetection configs/ppyolo/_base_/ppyolo_r50vd_dcn.yml: 608 x
    608, 80 classes, the anchors and masks below, MatrixNMS), batch 8,
    seeded weights and head maps, f32 (TF32 off): the stage-5 DCNv2 block
    (``DeformConv2D`` 3 x 3, 512 -> 512 at 19 x 19, offsets and mask from a
    plain 3 x 3 conv, the mask its sigmoid) forward and backward, then
    ``yolo_box`` on the three heads (22743 boxes an image) and
    ``matrix_nms`` a image. Every stage is held against the same port
    function on the CPU fed the card's inputs: values within DET_F32 (the
    DCN output within DCN_REL_L2, its gradients within DCN_GRAD_REL_L2
    relative L2), kept rows equal or each difference within DET_NEAR of a
    threshold. Prints each stage's ms, host syncs and peak memory, and how
    many candidates each class hands to NMS."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.registry import OPS

    B, S, C = PPYOLO_BATCH, PPYOLO_SIZE, PPYOLO_CLASSES
    print(f"[detection ppyolo] PP-YOLO R50vd-DCN post-processing, batch {B} "
          f"x {S} x {S}, {C} classes, f32 (TF32 off)")
    paddle.seed(19)
    g = torch.Generator(device="cuda").manual_seed(19)
    stats = {}
    with tf32_off(torch):
        offset_conv = paddle.nn.Conv2D(512, 27, 3, padding=1)
        dcn = paddle.vision.ops.DeformConv2D(512, 512, 3, padding=1)
        feat = torch.randn(B, 512, 19, 19, device="cuda", generator=g)
        cot = torch.randn(B, 512, 19, 19, device="cuda", generator=g)

        def dcn_step(x, oc, layer):
            x = x.detach().requires_grad_(True)
            om = oc(x)
            y = layer(x, om[:, :18], torch.sigmoid(om[:, 18:]))
            y.backward(cot.to(x.device))
            return y.detach(), [x.grad, oc.weight.grad, layer.weight.grad,
                                layer.bias.grad]

        def card_dcn():
            for m in (offset_conv, dcn):
                m.clear_gradients()
            return dcn_step(feat, offset_conv, dcn)

        y, grads = _det_stage(torch, "deform_conv2d fwd+bwd", card_dcn,
                              stats)
        oc_cpu = paddle.nn.Conv2D(512, 27, 3, padding=1, device="cpu")
        oc_cpu.set_state_dict(offset_conv.state_dict())
        dcn_cpu = paddle.vision.ops.DeformConv2D(512, 512, 3, padding=1,
                                                 device="cpu")
        dcn_cpu.set_state_dict(dcn.state_dict())
        (y_c, grads_c), cpu_ms = _cpu_ms(
            lambda: dcn_step(feat.cpu(), oc_cpu, dcn_cpu))
        stats["deform_conv2d fwd+bwd"]["cpu_ms"] = cpu_ms
        err = rel_l2(y.cpu(), y_c)
        gerr = [rel_l2(a.cpu(), b) for a, b in zip(grads, grads_c)]
        print(f"  DeformConv2D v2 3 x 3 512 -> 512 at [{B}, 512, 19, 19]: "
              f"out rel L2 {err:.2e}; gradients (x, offset conv, weight, "
              f"bias) rel L2 {[f'{e:.2e}' for e in gerr]}")
        if not (err <= DCN_REL_L2 and max(gerr) <= DCN_GRAD_REL_L2):
            raise AssertionError("[detection ppyolo] DeformConv2D: the card "
                                 "disagrees with the CPU")

        heads = []
        for mask, ds in zip(PPYOLO_MASKS, (32, 16, 8)):
            hw = S // ds
            x = torch.randn(B, 3, 5 + C, hw, hw, device="cuda", generator=g)
            x[:, :, 2:4] *= 0.5
            x[:, :, 4] = x[:, :, 4] * PPYOLO_OBJ[1] + PPYOLO_OBJ[0]
            x[:, :, 5:] = x[:, :, 5:] * PPYOLO_CLS[1] + PPYOLO_CLS[0]
            anchors = [v for m in mask for v in PPYOLO_ANCHORS[m]]
            heads.append((x.reshape(B, -1, hw, hw), anchors, ds))
        img = torch.full((B, 2), S, dtype=torch.int32, device="cuda")

        def boxes_of(dev):
            outs = [OPS["yolo_box"].fn(x.to(dev), img.to(dev), anchors, C,
                                       conf_thresh=0.01, downsample_ratio=ds,
                                       clip_bbox=True, scale_x_y=1.05)
                    for x, anchors, ds in heads]
            return (torch.cat([o[0] for o in outs], 1),
                    torch.cat([o[1] for o in outs], 1))

        boxes, scores = _det_stage(torch, "yolo_box", lambda: boxes_of(
            "cuda"), stats)
        (boxes_c, scores_c), cpu_ms = _cpu_ms(lambda: boxes_of("cpu"))
        stats["yolo_box"]["cpu_ms"] = cpu_ms
        check(torch, "yolo_box boxes", boxes.cpu(), boxes_c, 1e-3, 1e-5)
        check(torch, "yolo_box scores", scores.cpu(), scores_c, 1e-6, 1e-5)
        per_class = (scores > 0.01).sum(1)            # [B, C]
        print(f"  yolo_box: {boxes.shape[1]} boxes an image; candidates a "
              f"class above 0.01: mean {per_class.float().mean():.1f}, min "
              f"{int(per_class.min())}, max {int(per_class.max())}")
        if boxes.shape[1] != 22743:
            raise AssertionError(f"yolo_box: {boxes.shape[1]} boxes")
        sc_t = scores.transpose(1, 2).contiguous()        # [B, C, N]
        kw = dict(score_threshold=0.01, post_threshold=0.01, nms_top_k=-1,
                  keep_top_k=100, background_label=-1)

        def nms_all(b, s):
            return [OPS["matrix_nms"].fn(b[i], s[i], **kw) for i in range(B)]

        kept = _det_stage(torch, "matrix_nms", lambda: nms_all(boxes, sc_t),
                          stats)
        kept_c, cpu_ms = _cpu_ms(lambda: nms_all(boxes.cpu(), sc_t.cpu()))
        stats["matrix_nms"]["cpu_ms"] = cpu_ms
        near = sum(rows_agree(f"matrix_nms image {i}", a[0].cpu().numpy(),
                              b[0].numpy(), score_cuts=(0.01,))
                   for i, (a, b) in enumerate(zip(kept, kept_c)))
        counts = [int(k[1][0]) for k in kept]
        print(f"  matrix_nms: kept {counts} an image; card vs CPU: "
              f"{agreement(near)}")
        if not all(0 < c <= 100 for c in counts):
            raise AssertionError(f"matrix_nms kept {counts}")

        # a detector early in training: ~5000 candidates a class; the
        # classes run in chunks, so the peak stays near one class's n^2
        many = torch.rand(C, boxes.shape[1], device="cuda", generator=g) \
            * PPYOLO_MANY_SCALE
        big = dict(kw, keep_top_k=-1)
        _det_stage(torch, "matrix_nms, ~5000 a class", lambda: OPS[
            "matrix_nms"].fn(boxes[0], many, **big), stats)
        n_many = int((many > 0.01).sum(1).float().mean())
        peak = stats["matrix_nms, ~5000 a class"]["peak_GiB"]
        one = C * n_many ** 2 * 4 / 2 ** 30
        print(f"  matrix_nms of one image at {n_many} candidates a class "
              f"(uniform scores below {PPYOLO_MANY_SCALE}), {C} classes: "
              f"peak {peak} GiB, where one [classes, n, n] f32 matrix of "
              f"all classes at once takes {one:.1f} GiB")
        if not peak < min(PPYOLO_MANY_PEAK, one):
            raise AssertionError(f"matrix_nms at {n_many} a class: peak "
                                 f"{peak} GiB")
        for dt in (torch.float32, torch.bfloat16):
            got = OPS["matrix_nms"].fn(boxes[0], many[:4].to(dt), **big)
            want = OPS["matrix_nms"].fn(boxes[0].cpu(), many[:4].to(
                dt).cpu(), **big)
            near = rows_agree(f"matrix_nms {dt} at {n_many} a class",
                              got[0].cpu().numpy(), want[0].numpy(),
                              score_cuts=(0.01,))
            print(f"  matrix_nms {dt} scores, 4 classes at {n_many} a "
                  f"class: kept {int(got[1][0])}; card vs CPU: "
                  f"{agreement(near)}")
    print(f"  stages: {json.dumps(stats)}")
    return stats


def _rcnn_anchors(torch, h, w, size, stride):
    """PaddleDetection's AnchorGenerator at one level: ``size`` at
    aspect ratios 0.5 / 1 / 2 (w = size / sqrt(r), h = size * sqrt(r)),
    offset 0: ``[h, w, 3, 4]``."""
    r = torch.tensor([0.5, 1.0, 2.0], device="cuda")
    half_w, half_h = size / r.sqrt() / 2, size * r.sqrt() / 2
    cy, cx = torch.meshgrid(torch.arange(h, device="cuda") * float(stride),
                            torch.arange(w, device="cuda") * float(stride),
                            indexing="ij")
    return torch.stack([cx[..., None] - half_w, cy[..., None] - half_h,
                        cx[..., None] + half_w, cy[..., None] + half_h], -1)


def faster_rcnn_phase(torch):
    """Faster R-CNN R50-FPN test-time proposals and RoI features at its
    published sizes (PaddleDetection
    configs/faster_rcnn/_base_/faster_rcnn_r50_fpn.yml): batch 2 padded to
    800 x 1344, five RPN levels at strides 4-64 (anchor sizes 32-512,
    aspect ratios 0.5 / 1 / 2: P2 200 x 336 x 3 anchors), seeded
    objectness and deltas; ``generate_proposals`` a image and level
    (pre / post NMS top 1000, NMS 0.7, min size 0), the top 1000 a image
    collected, ``distribute_fpn_proposals`` (levels 2-5, refer level 4 at
    scale 224), ``roi_align`` 7 x 7 (sampling ratio 0, aligned) on
    256-channel maps, ``box_coder`` decode (variances 0.1 / 0.2) and
    ``multiclass_nms3`` (score 0.05, NMS 0.5, keep 100) over seeded class
    scores. Each stage against the same port function on the CPU fed the
    card's inputs, as ``ppyolo_phase`` holds its stages."""
    import numpy as np

    from paddle_tpu_torch.ops.registry import OPS

    B, (H, W) = RCNN_BATCH, RCNN_SHAPE
    print(f"[detection faster rcnn] Faster R-CNN R50-FPN test-time "
          f"proposals and RoI features, batch {B} padded to {H} x {W}, f32 "
          f"(TF32 off)")
    g = torch.Generator(device="cuda").manual_seed(29)
    stats = {}
    strides = (4, 8, 16, 32, 64)
    with tf32_off(torch):
        levels = []
        for lvl, s in enumerate(strides):
            h, w = H // s, W // s
            anchors = _rcnn_anchors(torch, h, w, 32.0 * 2 ** lvl, s)
            scores = torch.sigmoid(torch.randn(B, 3, h, w, device="cuda",
                                               generator=g) * 2 - 2)
            deltas = 0.2 * torch.randn(B, 12, h, w, device="cuda",
                                       generator=g)
            levels.append((scores, deltas, anchors, torch.ones_like(anchors)))
        ims = torch.tensor(RCNN_IM_SHAPES, device="cuda")
        kw = dict(pre_nms_top_n=1000, post_nms_top_n=1000, nms_thresh=0.7,
                  min_size=0.0)

        def proposals(dev):
            return [[OPS["generate_proposals"].fn(
                sc[b].to(dev), d[b].to(dev), ims[b].to(dev), a.to(dev),
                v.to(dev), **kw) for sc, d, a, v in levels]
                for b in range(B)]

        props = _det_stage(torch, "generate_proposals", lambda: proposals(
            "cuda"), stats)
        props_c, stats["generate_proposals"]["cpu_ms"] = _cpu_ms(
            lambda: proposals("cpu"))
        near = np.zeros(2, int)
        for b in range(B):
            for lvl in range(len(strides)):
                (pb, ps, _), (cb, cs, _) = props[b][lvl], props_c[b][lvl]
                near += rows_agree(f"generate_proposals image {b} P{lvl + 2}",
                                   (pb.cpu().numpy(), ps.cpu().numpy()),
                                   (cb.numpy(), cs.numpy()), iou_cut=0.7)
        print(f"  generate_proposals: "
              f"{[[int(p[2][0]) for p in img] for img in props]} proposals "
              f"a level; card vs CPU: {agreement(near)}")
        rois = []
        for b in range(B):
            boxes = torch.cat([p[0] for p in props[b]])
            sc = torch.cat([p[1] for p in props[b]])
            rois.append(boxes[torch.argsort(-sc, stable=True)[:1000]])
        dist = _det_stage(torch, "distribute_fpn_proposals", lambda: [
            OPS["distribute_fpn_proposals"].fn(r, 2, 5, 4, 224)
            for r in rois], stats)
        dist_c, stats["distribute_fpn_proposals"]["cpu_ms"] = _cpu_ms(
            lambda: [OPS["distribute_fpn_proposals"].fn(r.cpu(), 2, 5, 4, 224)
                     for r in rois])
        for a, b in zip(dist, dist_c):
            for x, y in zip(a, b):
                if not torch.equal(x.cpu(), y):
                    raise AssertionError("distribute_fpn_proposals: the card "
                                         "and the CPU assign differently")
        per_level = [[int(d[i].shape[0]) for i in range(4)] for d in dist]
        print(f"  distribute_fpn_proposals: rois a level (P2-P5) "
              f"{per_level}")
        feats = [torch.randn(B, 256, H // s, W // s, device="cuda",
                             generator=g) for s in strides[:4]]

        def align(dev):
            out = []
            for i, (f, s) in enumerate(zip(feats, strides)):
                r = torch.cat([d[i] for d in dist]).to(dev)
                num = torch.tensor([d[i].shape[0] for d in dist])
                out.append(OPS["roi_align"].fn(
                    f.to(dev), r, num, pooled_height=7, pooled_width=7,
                    spatial_scale=1.0 / s, sampling_ratio=0, aligned=True))
            return out

        pooled = _det_stage(torch, "roi_align", lambda: align("cuda"),
                            stats)
        pooled_c, stats["roi_align"]["cpu_ms"] = _cpu_ms(lambda: align(
            "cpu"))
        for i, (a, b) in enumerate(zip(pooled, pooled_c)):
            check(torch, f"roi_align P{i + 2} {list(a.shape)}", a.cpu(), b,
                  ROI_ATOL, 1e-5)
        # the quotient roi_align's bins avoid: a bin height over 7 by a
        # Python number and by a tensor, on the card and on the CPU
        from paddle_tpu_torch.ops.parity import quot
        r = torch.cat([d[i] for d in dist for i in range(4)])
        rh = torch.clamp(r[:, 3] - r[:, 1], min=1e-6)
        by_number, by_tensor = rh / 7, quot(rh, 7)
        print(f"  roi_align bin heights of {rh.numel()} rois: x / 7 on the "
              f"card differs from the CPU's in "
              f"{int((by_number.cpu() != rh.cpu() / 7).sum())}, divided "
              f"by a tensor 7 in "
              f"{int((by_tensor.cpu() != quot(rh.cpu(), 7)).sum())}")
        R = sum(p.shape[0] for p in pooled)
        var = torch.tensor([[0.1, 0.1, 0.2, 0.2]], device="cuda")
        deltas = [torch.randn(r.shape[0], 4, device="cuda", generator=g)
                  for r in rois]
        logits = [torch.randn(r.shape[0], 81, device="cuda", generator=g)
                  * RCNN_CLS[1] for r in rois]
        for lg in logits:
            lg[:, 0] += RCNN_CLS[0]                # the background class
        cls = [torch.softmax(lg, -1)[:, 1:].T.contiguous() for lg in logits]

        def decode(dev):
            return [OPS["box_coder"].fn(r.to(dev), var.expand(
                r.shape[0], 4).to(dev), d.to(dev),
                code_type="decode_center_size", box_normalized=False)
                for r, d in zip(rois, deltas)]

        dec = _det_stage(torch, "box_coder", lambda: decode("cuda"), stats)
        dec_c, stats["box_coder"]["cpu_ms"] = _cpu_ms(lambda: decode("cpu"))
        for a, b in zip(dec, dec_c):
            check(torch, "box_coder decode", a.cpu(), b, 1e-3, 1e-5)
        nkw = dict(score_threshold=0.05, nms_threshold=0.5, keep_top_k=100)

        def nms(dev, boxes):
            return [OPS["multiclass_nms3"].fn(b.to(dev), c.to(dev), **nkw)
                    for b, c in zip(boxes, cls)]

        kept = _det_stage(torch, "multiclass_nms3", lambda: nms("cuda", dec),
                          stats)
        kept_c, stats["multiclass_nms3"]["cpu_ms"] = _cpu_ms(
            lambda: nms("cpu", dec))
        near = sum(rows_agree(f"multiclass_nms3 image {i}",
                              a[0].cpu().numpy(), b[0].numpy(),
                              score_cuts=(0.05,), iou_cut=0.5)
                   for i, (a, b) in enumerate(zip(kept, kept_c)))
        cand = [int((c > 0.05).sum()) for c in cls]
        print(f"  multiclass_nms3: {cand} candidates above 0.05 an image, "
              f"kept {[int(k[2][0]) for k in kept]}; card vs CPU: "
              f"{agreement(near)}")
        print(f"  roi_align: {R} rois x 256 x 7 x 7")
    print(f"  stages: {json.dumps(stats)}")
    return stats


def fft_phase(torch):
    """``paddle.fft`` at Whisper-base's STFT shapes: ``frame`` of 400
    samples every 160 over 8 x 30 s at 16 kHz, then ``rfft`` along the
    frame (cuFFT on the card) against the same on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.registry import OPS

    g = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(8, 480000, device="cuda", generator=g)

    def stft(v):
        frames = OPS["frame"].fn(v, 400, 160)            # [8, 400, 2998]
        return paddle.fft.rfft(frames, axis=1)

    stats = {}
    spec = _det_stage(torch, "frame + rfft", lambda: stft(x), stats)
    want, stats["frame + rfft"]["cpu_ms"] = _cpu_ms(lambda: stft(x.cpu()))
    err = check(torch, f"rfft of frames {list(spec.shape)} (real and "
                       f"imaginary parts)", torch.view_as_real(spec).cpu(),
                torch.view_as_real(want), 1e-3, 1e-4)
    print(f"[fft] frame(400, 160) then rfft over 8 x 30 s at 16 kHz: "
          f"{list(spec.shape)} {spec.dtype}, max |card - CPU| {err:.2e}; "
          f"{json.dumps(stats)}")
    if spec.shape != (8, 201, 2998):
        raise AssertionError(f"[fft] spectrum shape {spec.shape}")


def containers_phase(torch):
    """A ``TensorArray`` round trip on the card: ``array_write`` at the
    append position, ``array_read``, ``array_length``, ``stack`` /
    ``concat``, an out-of-range write refused, ``pop``."""
    import paddle_tpu_torch as paddle

    arr = paddle.create_array("float32")
    for i in range(4):
        arr = paddle.array_write(paddle.full([2, 3], float(i)),
                                 paddle.to_tensor(i), arr)
    try:
        arr.write(9, paddle.zeros([2, 3]))
        raise AssertionError("[containers] a write past the end was taken")
    except IndexError:
        pass
    stacked, cat = arr.stack(axis=0), arr.concat(axis=1)
    ok = (int(paddle.array_length(arr)) == 4
          and float(paddle.array_read(arr, 2).sum()) == 12.0
          and list(stacked.shape) == [4, 2, 3]
          and list(cat.shape) == [2, 12] and stacked.device.type == "cuda"
          and float(stacked[3, 1, 2]) == 3.0 and float(arr.pop().sum()) == 18
          and len(arr) == 3)
    print(f"[containers] TensorArray on {stacked.device}: 4 writes, read, "
          f"length, stack {list(stacked.shape)}, concat {list(cat.shape)}, "
          f"pop: {'ok' if ok else 'WRONG'}")
    if not ok:
        raise AssertionError("[containers] the TensorArray round trip")


def nan_inf_phase(torch, densenet):
    """``FLAGS_check_nan_inf`` on the card: ``paddle.log`` of a negative
    raises naming the op and the counts, a finite op passes; both flags
    off leave ``core.dispatch.DEBUG_HOOKS`` False (one bool read an op),
    as it was through ``[densenet]``, whose launches a step are printed
    beside it."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import dispatch

    if dispatch.DEBUG_HOOKS:
        raise AssertionError("[nan inf] the hooks were on")
    x = paddle.to_tensor([-1.0, 0.0, 2.0])
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        paddle.exp(x)
        try:
            paddle.log(x)
            raise AssertionError("[nan inf] log(-1) did not raise")
        except RuntimeError as e:
            msg = str(e)
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})
    if "'log'" not in msg or "1 NaN / 1 Inf" not in msg:
        raise AssertionError(f"[nan inf] message: {msg}")
    per_step = {k: c / DENSENET_STEPS for k, c in densenet.items() if c}
    print(f"[nan inf] FLAGS_check_nan_inf on: {msg!r}; off again: "
          f"DEBUG_HOOKS {dispatch.DEBUG_HOOKS}; [densenet] ran with the "
          f"hooks off at {per_step} launches a step")
    if dispatch.DEBUG_HOOKS or per_step != {"softmax_ce": 1.0,
                                            "softmax_ce_bwd": 1.0}:
        raise AssertionError("[nan inf] the hooks stayed on")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: paddle_tpu_torch/ is not beside this script; run "
              "it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    # the compilers' caches stay in the checkout's git-ignored build dir
    build = os.path.join(here, "paddle_tpu_torch", "csrc", "build")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(build, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import _build

    print(card_line())     # name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = t0 = time.monotonic()
    libs = _build.build_all()
    print(f"kernels built in {time.monotonic() - t0:.1f}s: "
          f"{sorted(libs)}")
    sm90_build_report(libs)

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {"rmsnorm": rmsnorm_phase(torch, g),
            "paged_attention": paged_phase(torch, g),
            "flash_attention": flash_phase(torch, g)}
    torch.cuda.empty_cache()
    rows["flash_attention_bwd"] = flash_bwd_phase(torch, g)
    rows["rmsnorm_bwd"] = rmsnorm_bwd_phase(torch, g)
    rows["softmax_ce"], rows["softmax_ce_bwd"] = softmax_ce_phases(torch, g)
    rows["layernorm"] = layernorm_phase(torch, g)
    torch.cuda.empty_cache()
    (rows["flash_attention_dropout"],
     rows["flash_attention_bwd_dropout"]) = flash_dropout_phases(torch, g)
    (rows["flash_attention_dropout_d36"],
     rows["flash_attention_bwd_dropout_d36"]) = flash_d36_phase(torch, g)
    rows["ctc_alpha"], rows["ctc_beta"] = ctc_phase(torch, g)
    rows["rnnt_alpha"], rows["rnnt_beta_grad"] = rnnt_phase(torch, g)
    torch.cuda.empty_cache()
    (rows["flash_attention_mask"],
     rows["flash_attention_bwd_mask"]) = flash_mask_phase(torch, g)
    torch.cuda.empty_cache()
    ((rows["flash_attention_varlen"], rows["flash_attention_bwd_varlen"]),
     varlen) = flash_varlen_phase(torch, g, K)
    torch.cuda.empty_cache()
    (rows["flash_attention_d16"],
     rows["flash_attention_bwd_d16"]) = flash_head_dim_phase(torch, g)
    torch.cuda.empty_cache()
    enc, dec = flash_whisper_phase(torch, g)
    fwd_bwd = (rows["flash_attention"], rows["flash_attention_bwd"])
    _sub_rows(fwd_bwd, "whisper_encoder", enc)
    _sub_rows(fwd_bwd[:1], "whisper_decode", (dec,))
    # bf16 at every timed head width (16, 36, 64, 96, 128, 256): the wgmma
    # / TMA kernels; ernie_tiny()'s f32 row (the _d16 rows' main entry):
    # the mma.sync / CUDA-core ones
    for name, r in rows.items():
        if name.endswith("_d16"):
            subs = [x["design"] for x in r.values()
                    if isinstance(x, dict) and "design" in x]
            if r["design"] != "mma" or set(subs) != {"sm90"}:
                raise AssertionError(f"{name}: ran {r['design']} and {subs}, "
                                     f"want mma and sm90 (the bf16 sub-rows)")
        elif name.startswith("flash_attention"):
            want_design([r], "sm90")
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {name} ({r.get('design', 'cuda')}) at {r['shape']}: kernel "
              f"{r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()

    model, launches = serving_phase(torch, K)
    tenancy = serving_tenancy_phase(torch, K, model)
    launches = {k: launches[k] + tenancy[k] for k in launches}
    gc.collect()
    torch.cuda.empty_cache()
    t_new = time.monotonic()
    profile_decode_step(torch, model, K)
    faults_phase(torch, model)
    print(f"[serving phases] profile, telemetry cost, profiler and faults "
          f"{time.monotonic() - t_new:.1f} s")
    fleet = serving_fleet_phase(torch, K, model)
    launches = {k: launches[k] + fleet[k] for k in launches}
    del model
    gc.collect()
    torch.cuda.empty_cache()

    whole_step_check(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    trained = training_phase(torch, K)
    launches = {k: launches.get(k, 0) + trained[k] for k in trained}
    gc.collect()
    torch.cuda.empty_cache()
    spread = distributed_phase(torch, K)
    launches = {k: launches.get(k, 0) + spread.get(k, 0) for k in launches}
    gc.collect()
    torch.cuda.empty_cache()

    whole_step_ernie(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    ernie = ernie_training_phase(torch, K)
    launches = {k: launches[k] + ernie[k] for k in launches}
    gc.collect()
    torch.cuda.empty_cache()

    whole_step_conformer(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    conformer = conformer_training_phase(torch, K)
    gc.collect()
    torch.cuda.empty_cache()

    whole_step_conformer(torch, K, "rnnt")
    gc.collect()
    torch.cuda.empty_cache()
    rnnt = conformer_training_phase(torch, K, "rnnt")
    gc.collect()
    torch.cuda.empty_cache()

    whole_step_encoder_mask(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    encoder = encoder_mask_phase(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    d16 = head_dim16_model_step(torch, K)
    gc.collect()
    torch.cuda.empty_cache()

    whisper = whisper_serving_phase(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    whole_step_whisper(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    whisper_train = whisper_training_phase(torch, K)
    gc.collect()
    torch.cuda.empty_cache()

    resnet, model = resnet_training_phase(torch, K)
    resnet_infer_phase(torch, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    whole_step_resnet(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    t_slice = time.monotonic()
    zoo = vision_zoo_phase(torch, K)
    t_zoo = time.monotonic() - t_slice
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    shufflenet = shufflenet_training_phase(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    whole_step_shufflenet(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    t_slice = time.monotonic() - t0

    lenet = hapi_lenet_phase(torch, K)
    hapi_resnet = hapi_resnet_phase(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    hapi_workers_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()

    densenet = densenet_phase(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    whole_step_densenet(torch, K)
    gc.collect()
    torch.cuda.empty_cache()
    t_eager = time.monotonic()
    eager_ops_phase(torch)
    t_eager = time.monotonic() - t_eager
    eager_autograd_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    nn_surface_phase(torch)
    t_slice += time.monotonic() - t0
    print(f"[nn slice phases] {t_slice:.1f} s ([shufflenet], [whole step "
          f"shufflenet], [nn surface]); [vision zoo] with its three new "
          f"models {t_zoo:.1f} s")
    t_deploy = time.monotonic()
    deploy = static_deploy_phases(torch, K)
    print(f"[static phases] {time.monotonic() - t_deploy:.1f} s "
          f"(to_static, jit, predictor, static ernie, static nn)")
    gc.collect()
    torch.cuda.empty_cache()
    seconds = {}

    def timed(name, fn):
        t = time.monotonic()
        out = fn()
        gc.collect()
        torch.cuda.empty_cache()
        seconds[name] = round(time.monotonic() - t, 1)
        return out

    timed("compiled kernels", lambda: compiled_kernels_phase(torch, K))
    llama_deploy, model, llama_ids = timed(
        "to_static llama", lambda: llama_deploy_phase(torch, K))
    static_grad = timed("static llama grad", lambda: llama_static_grad_phase(
        torch, K, model, llama_ids))
    del model
    lamb = timed("ernie lamb", lambda: ernie_lamb_phase(torch, K))
    timed("optimizers", lambda: optimizers_phase(torch))
    print(f"[compiled and optimizer phases] seconds {json.dumps(seconds)}, "
          f"{sum(seconds.values()):.1f} s in all")
    seconds = {}
    before = time.monotonic() - t_start
    print(f"[op library phases] the script at {before:.1f} s before them")
    aliases = timed("op aliases", lambda: op_aliases_phase(torch, K))
    timed("detection ppyolo", lambda: ppyolo_phase(torch))
    timed("detection faster rcnn", lambda: faster_rcnn_phase(torch))
    timed("fft", lambda: fft_phase(torch))
    timed("containers", lambda: containers_phase(torch))
    timed("nan inf", lambda: nan_inf_phase(torch, densenet))
    print(f"[op library phases] seconds {json.dumps(seconds)}, "
          f"{sum(seconds.values()):.1f} s in all ([eager ops] with the "
          f"registry's ops: {t_eager:.1f} s); the script at "
          f"{before:.1f} s before them, {time.monotonic() - t_start:.1f} s "
          f"after")
    launches = {k: launches[k] + conformer[k] + rnnt[k] + encoder[k]
                + varlen[k] + whisper[k] + whisper_train[k] + resnet[k]
                + zoo[k] + shufflenet[k] + lenet[k] + hapi_resnet[k]
                + densenet[k] + deploy[k] + llama_deploy[k] + static_grad[k]
                + lamb[k] + aliases[k] for k in conformer}
    # the head_dim-36 rows: the Conformer steps' launches of those kernels;
    # the head_dim-16 rows: the tiny ERNIE step's
    for name in ("flash_attention_dropout", "flash_attention_bwd_dropout"):
        launches[f"{name}_d36"] = conformer[name] + rnnt[name]
        launches[name.replace("_dropout", "_d16")] = d16[name]

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            # sub-rows (other shapes of the same kernel), notes, and the
            # flash rows' third bound and the mma kernels' times
            **{n: x for n, x in r.items() if isinstance(x, (dict, str))
               or n in ("bound_exp_ms", "mma_ms", "mma_dense_ms",
                        "dense_ms")}})
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} is {k[key]}")
    print(f"chip_smoke: {time.monotonic() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
