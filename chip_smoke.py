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
   launched fails the run.
4. Profiles one decode step of 4 running slots: the wall time of
   unprofiled steps against the device busy time (the union of the
   profiled step's kernel intervals), and the kernels that took it.
5. Whole-step check: one ``LlamaPipelineTrainer`` forward and backward
   on a narrow model with the 7B head (hidden 512, 4 heads of 128,
   2 layers, vocab 32000, batch 2 x 512) in bf16 on the card, against the
   same f32 masters in f32 on the CPU through the plain versions: the loss
   within STEP_LOSS_TOL, each parameter's gradient within STEP_GRAD_REL_L2
   relative L2 error. This holds the autograd wiring of every kernel.
6. Training phase: the serving model freed, ``LlamaPipelineTrainer`` on
   Llama-2-7B's widths at TRAIN_LAYERS layers (f32 masters, bf16 compute,
   remat "dots", AdamW lr 1e-4 as ``bench.py`` trains) takes 1 warm-up
   step and 5 timed steps on one seeded batch of 4 x 2048 tokens: every
   loss finite, the last below the first. Prints step wall time, tokens/s,
   MFU (``matmul_flops_per_token(2048)`` against 989 TFLOP/s), peak device
   memory, and a profile of one more step. The counters are zeroed just
   before the 5 steps and read just after; a training kernel never
   launched there fails the run.
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
26. ``[vision zoo]``: LeNet, AlexNet, VGG-16 and MobileNetV1 / V2 /
    V3-Large at their published widths, batch 8: one O1 step each (finite
    loss, one softmax-CE forward and backward), then ``o1_eval_check``.
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

Flash design: bf16 at head_dim 64 and 128 with 16-byte rows takes the
wgmma / TMA kernels (``csrc/flash_attention{,_bwd}_sm90.cu``, counted
under ``flash_attention{,_bwd}_sm90``), every other input the mma.sync
and CUDA-core ones (``_mma``). Each flash row records the design its timed launches ran and
must be ``sm90`` (rows 1, 1a, 1b, 2, 2a, 2b and their dropout rows) or
``mma`` (the ``_d36`` and ``_d16`` rows, and their sub-rows); the Llama,
ERNIE and encoder steps must launch every flash kernel on ``sm90``.

The ``launches`` of the JSON line sum the main path's runs: the engine,
the no-cache forward, the 5 Llama training steps, the ERNIE steps, the
Conformer-CTC and the RNN-T steps, the encoder steps, the
``F.flash_attn_unpadded`` call, the Whisper ``generate`` and its
teacher-forced forward, the Whisper training steps, the ResNet-50
training steps, the zoo's steps, the two ``Model.fit`` phases (fits and
evaluations) and the DenseNet-121 steps (the ``_d36`` rows: the Conformer steps'
launches of the dropout flash kernels, all at head_dim 36; the ``_d16``
rows: the ``ernie_tiny()`` step's). The last two lines are one JSON object
with every kernel's numbers and one with the device. Any failure raises and exits non-zero; without a CUDA
device, or without the package beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
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
                      "flash_attention_mma": 4, "flash_attention_bwd_mma": 4,
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
                 "flash_attention_bwd_dropout": 4, "flash_attention_mma": 4,
                 "flash_attention_bwd_mma": 4, "rnnt_alpha": 1,
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
# The flash rows at bf16 head_dim 64 / 128 run the wgmma / TMA kernels
# (the sm90 design); the head_dim-36 and -16 rows the mma.sync and
# CUDA-core ones (the mma design)
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
    # the same kernels' head_dim-36 instantiations (the Conformer's)
    "flash_attention_dropout_d36": (
        "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/kernels/flash_attention.py:108"),
    "flash_attention_bwd_dropout_d36": (
        "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
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
    pairs = S * S
    # as the dropout phase counts them, at the real width 36
    bound_f, by_f = bound_ms(4 * q.numel() * 2 + B * H * S * 4,
                             4 * pairs * D * B * H)
    bound_b, by_b = bound_ms(7 * q.numel() * 2 + 2 * B * H * S * 4,
                             10 * pairs * D * B * H)
    print(f"  [{B}, {S}, {H}, {D}]: forward kernel {fwd:.4f} ms (dense "
          f"{dense:.4f}), plain {fwd_plain:.4f}, SDPA(dropout) {fwd_lib:.4f}, "
          f"bound {bound_f:.4f} ({by_f}); backward kernel {bwd:.4f} ms "
          f"(dense {bwd_dense:.4f}), plain {bwd_plain:.4f}, SDPA backward "
          f"{bwd_lib:.4f}, bound {bound_b:.4f} ({by_b})")
    shape = f"[{B}, {S}, {H}, {D}] bf16 p={p}"
    return (dict(shape=shape, ms=fwd, plain_ms=fwd_plain, library_ms=fwd_lib,
                 bound_ms=bound_f, bound_by=by_f, dense_ms=dense,
                 max_abs_err=worst_f, design=design_f),
            dict(shape=shape, ms=bwd, plain_ms=bwd_plain, library_ms=bwd_lib,
                 bound_ms=bound_b, bound_by=by_b, dense_ms=bwd_dense,
                 max_abs_err=worst_b, design=design_b))


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
    bounds = (bound_ms(4 * nb + B * H * S * 4 + mb, 4 * pairs * H * D, peak),
              bound_ms(7 * nb + 2 * B * H * S * 4 + mb, 10 * pairs * H * D,
                       peak))
    print(f"  {tag}: forward kernel {times[0]:.4f} ms, plain {times[2]:.4f}, "
          f"SDPA {times[4]:.4f}, bound {bounds[0][0]:.4f} ({bounds[0][1]}); "
          f"backward kernel {times[1]:.4f} ms, plain {times[3]:.4f}, SDPA "
          f"backward {times[5]:.4f}, bound {bounds[1][0]:.4f} "
          f"({bounds[1][1]})")
    return times, bounds


def _rows(shape, times, bounds, errs, **extra):
    fwd, bwd = ({"shape": shape, "ms": times[i], "plain_ms": times[2 + i],
                 "library_ms": times[4 + i], "bound_ms": bounds[i][0],
                 "bound_by": bounds[i][1], "max_abs_err": errs[i],
                 "design": times[6 + i], **extra}
                for i in (0, 1))
    return fwd, bwd


def _sub_rows(rows, key, more):
    """Put the forward and backward rows of ``more`` under ``key`` of
    ``rows``' (their errors fold into the main rows')."""
    for r, m in zip(rows, more):
        r[key] = {n: m[n] for n in ("shape", "ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "design")
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


def flash_head_dim_phase(torch, g):
    """Every head width class: each multiple of 8 from 8 to 256, the odd
    widths 7 and 33 and the 4-byte-chunk widths 6 and 34, f32 and bf16,
    forward and backward against the plain versions (causal on alternate
    widths, dropout on the odd ones). Then the kernel the head_dim-16 model
    step launches, at that step's inputs (f32 [4, 128, 4, 16], dropout 0.1),
    and the bf16 tensor-core kernels at [16, 512, H, D], H = 768 / D
    rounded, for D 16, 96 and 256: each against the plain versions and
    timed against SDPA."""
    from paddle_tpu_torch.kernels import flash_attention as F

    widths = [6, 7, 33, 34] + list(range(8, 257, 8))
    print(f"[flash head_dim] the flash kernels at head_dim {widths}, f32 and "
          f"bf16, [2, 70, 4 (Hkv 2), D]")
    worst = [0.0, 0.0]
    for dt in (torch.bfloat16, torch.float32):
        for d in widths:
            ef, eb = _flash_case(torch, g, F, f"{dt} D={d}", 2, 70, 70, 4, 2,
                                 d, dt, d % 16 == 8, 0.1 if d % 2 else 0.0)
            worst = [max(worst[0], ef), max(worst[1], eb)]
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
        _sub_rows(rows, f"bf16_d{d}", _rows(f"[{B}, {S}, {H}, {d}] bf16",
                                            times, bounds, (ef, eb)))
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
    K.reset_launch_counts()
    t0 = time.monotonic()
    eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    engine_launches = K.launch_counts()
    st = eng.stats()
    for r in reqs:
        if r.state.value != "finished" or len(r.output_tokens) != 16:
            raise AssertionError(f"request {r.rid}: {r.state} {r.error!r}")
    if st["prefix_cache"]["hits"] < 1:
        raise AssertionError("the shared prefix never hit the prefix cache")

    # teacher forcing through the no-cache forward
    worst = 0.0
    exact = total = 0
    K.reset_launch_counts()
    with torch.inference_mode():
        for r, p in zip(reqs, prompts):     # the greedy requests only
            ids = torch.tensor([p + r.output_tokens], device="cuda")
            logits = model(ids)[0].float()
            if not torch.isfinite(logits).all():
                raise AssertionError(f"request {r.rid}: non-finite logits")
            rows = logits[len(p) - 1:len(p) - 1 + len(r.output_tokens)]
            served = torch.tensor(r.output_tokens, device="cuda")
            chosen = rows.gather(1, served[:, None])[:, 0]
            gap = (rows.max(1).values - chosen).max().item()
            worst = max(worst, gap)
            exact += (rows.argmax(1) == served).sum().item()
            total += len(r.output_tokens)
            if gap > TF_TOL:
                raise AssertionError(
                    f"request {r.rid}: a generated token's logit is {gap} "
                    f"below its row's max (limit {TF_TOL})")
    torch.cuda.synchronize()
    forward_launches = K.launch_counts()
    if exact < TF_MIN_EXACT * total:
        raise AssertionError(
            f"only {exact} of {total} served greedy tokens are the "
            f"teacher-forced argmax (need {TF_MIN_EXACT:.0%})")
    ttft = [r.ttft for r in reqs]
    print(f"  7 requests x 16 tokens in {wall:.2f}s; "
          f"preemptions {st['num_preemptions']}; prefix cache "
          f"hits {st['prefix_cache']['hits']} "
          f"tokens saved {st['prefix_cache']['tokens_saved']}")
    print(f"  TTFT mean {sum(ttft) / len(ttft) * 1e3:.1f} ms "
          f"(max {max(ttft) * 1e3:.1f} ms, queueing included); decode "
          f"{st['decode_tokens_per_sec']:.1f} tokens/s over "
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


def profile_decode_step(torch, model):
    """Where one decode step's time goes (4 running slots, contexts
    ~300-700): the wall time of unprofiled steps against the device busy
    time of one profiled step, taken as the union of its kernel intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import LLMEngine, SamplingParams

    eng = LLMEngine(model, max_slots=4, max_model_len=1024, block_size=16)
    rng = torch.Generator().manual_seed(2)
    for n in (300, 400, 500, 700):
        eng.add_request(torch.randint(0, 32000, (n,), generator=rng).tolist(),
                        SamplingParams(max_new_tokens=16))
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
    card = LlamaPipelineTrainer(cfg, AdamW(learning_rate=1e-4),
                                generator=torch.Generator(
                                    device="cuda").manual_seed(1))
    cpu = LlamaPipelineTrainer(cfg, AdamW(learning_rate=1e-4), device="cpu")
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
    """LlamaPipelineTrainer at Llama-2-7B's widths, TRAIN_LAYERS deep."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import LlamaPipelineTrainer
    from paddle_tpu_torch.optimizer import AdamW

    B, S = 4, 2048
    cfg = train_config(TRAIN_LAYERS, 4096, 32, 11008, S)
    print(f"[training] Llama-2-7B widths, {TRAIN_LAYERS} layers, batch "
          f"{B} x {S}, f32 masters, bf16 compute, remat dots, AdamW lr 1e-4")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = LlamaPipelineTrainer(cfg, AdamW(learning_rate=1e-4), remat="dots",
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
    return counts


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
                               "flash_attention_mma",
                               "flash_attention_bwd_mma") else v
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
    """``model``'s eval logits on ``x`` under O1 against its f32 forward
    (TF32 off), held to VISION_O1_ROUNDING_RATIO x the error of an f32
    forward with the weights and the input rounded to bf16, and to
    VISION_O1_REL_L2_MAX; returns both errors."""
    from paddle_tpu_torch import amp

    model.eval()
    with tf32_off(torch), torch.no_grad():
        with amp.auto_cast(level="O1"):
            low = model(x)
        want = model(x)
        saved = [p.detach().clone() for p in model.parameters()]
        for p in model.parameters():
            p.copy_(p.bfloat16())
        rounded = model(x.bfloat16().float())
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


def _step_errors(a, b):
    """Loss difference and the worst relative L2 errors of gradients,
    buffers and updated parameters of step ``a`` against step ``b``."""
    out = {"loss": abs(a[0] - b[0])}
    for i, key in ((1, "gradient"), (2, "buffer"), (3, "parameter")):
        rel = {n: rel_l2(a[i][n], t) for n, t in b[i].items()}
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
       ("MobileNetV3-Large", "mobilenet_v3_large", 3, 224))


def vision_zoo_phase(torch, K):
    """LeNet (10 classes, 1 x 28 x 28), AlexNet, VGG-16 and MobileNetV1 /
    V2 / V3-Large (1000 classes, 3 x 224 x 224) at their published widths,
    batch ZOO_BATCH: one O1 training step each (Momentum 0.9, L2 1e-4, lr
    0.01) with a finite loss and one softmax-CE forward and backward
    launch; then its eval logits under O1 against its f32 forward
    (``o1_eval_check``). Returns the steps' launches."""
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
        loss = _vision_step(torch, model, x, y, True, lr=0.01)[0]
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
        counts = K.launch_counts()
        launched = {k: v for k, v in counts.items() if v}
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        print(f"  {what}: {n_params / 1e6:.2f} M parameters, O1 step loss "
              f"{loss:.4f} ({wall:.1f} ms, first call), launches {launched}")
        if not math.isfinite(loss):
            raise AssertionError(f"{what}: non-finite loss {loss}")
        if launched != {"softmax_ce": 1, "softmax_ce_bwd": 1}:
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
    names and the module functions it leaves out of its registry) on CUDA
    tensors against the same op on CPU tensors, f32 inputs from the seeded
    cases of ``tools/eager_op_cases.py`` (``tests/test_torch_ops.py``'s,
    cast from f64): integer and bool results equal, floating ones within
    EAGER_F32 (EAGER_F32_LOOSE for the decompositions and special
    functions, ``tools.eager_op_cases.LOOSE``; sign-free quantities for
    svd, qr and eigh), TF32 off. The random ops run on the card for their
    shapes, dtypes and finiteness only (they agree in distribution, which
    ``tests/test_torch_ops.py`` holds). Prints the count, the ops left out
    with the reason, and ``op_coverage()``."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import device as pdevice
    from tools.eager_op_cases import LOOSE, cases

    modules = ("creation", "math", "manipulation", "linalg", "logic",
               "search", "stat", "fused")
    random = set(ops.random.__all__) | {"log_normal"}
    left_out = {"to_tensor": "a constructor: every phase's inputs",
                "create_parameter": "a constructor: nn.Layer makes them",
                "is_tensor": "a type check, no tensor out"}
    names = sorted(set().union(*(getattr(ops, m).__all__ for m in modules))
                   - random - set(left_out))
    print(f"[eager ops] {len(names)} ops on the card against the CPU, f32 "
          f"(TF32 off); {len(random)} random ops for shape and dtype")

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
        out = fn(*convert(args, dev), **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.numpy() for o in outs if hasattr(o, "numpy")]

    ran, worst = 0, (0.0, None)
    try:
        with tf32_off(torch):
            for name in names:
                fn = getattr(ops, name)

                def probe(args, kwargs, fn=fn):
                    try:
                        return bool(run(fn, args, kwargs, "cpu"))
                    except Exception:
                        return False

                tol = EAGER_F32_LOOSE if name in LOOSE else EAGER_F32
                for args, kwargs in cases(name, probe):
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
            if set(draws) != random:
                raise AssertionError(f"[eager ops] random ops: "
                                     f"{sorted(random ^ set(draws))}")
            for name, args in draws.items():
                out = getattr(ops, name)(*args)
                if out.device.type != "cuda" or \
                        not torch.isfinite(out.float()).all():
                    raise AssertionError(f"[eager ops] random {name}: "
                                         f"{out.device}, not finite")
    finally:
        pdevice._state["device"] = None
    cov = paddle.op_coverage()
    print(f"  {ran} ops matched the CPU (largest |card - CPU| {worst[0]:.2e} "
          f"in {worst[1]}); {len(random)} random ops drew on the card; left "
          f"out: " + "; ".join(f"{k} ({v})" for k, v in left_out.items()))
    print(f"  op_coverage(): {cov['covered']} of {cov['total']} reference "
          f"ops ({100 * cov['pct']:.1f}%), {cov['registered']} registered")
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
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import _build

    print(card_line())     # name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    libs = _build.build_all()
    print(f"kernels built in {time.monotonic() - t0:.1f}s: "
          f"{sorted(libs)}")

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
    # bf16 at head_dim 64 / 128: the wgmma / TMA kernels; head_dim 36, the
    # f32 kernel and the other widths: the mma.sync / CUDA-core ones
    for name, r in rows.items():
        if name.startswith("flash_attention"):
            want_design([r], "mma" if name.endswith(("_d36", "_d16"))
                        else "sm90")
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {name} ({r.get('design', 'cuda')}) at {r['shape']}: kernel "
              f"{r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()

    model, launches = serving_phase(torch, K)
    profile_decode_step(torch, model)
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
    zoo = vision_zoo_phase(torch, K)
    gc.collect()
    torch.cuda.empty_cache()

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
    eager_ops_phase(torch)
    eager_autograd_phase(torch)
    launches = {k: launches[k] + conformer[k] + rnnt[k] + encoder[k]
                + varlen[k] + whisper[k] + whisper_train[k] + resnet[k]
                + zoo[k] + lenet[k] + hapi_resnet[k] + densenet[k]
                for k in conformer}
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
            # sub-rows (other shapes of the same kernel), notes
            **{n: x for n, x in r.items() if isinstance(x, (dict, str))}})
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} is {k[key]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
