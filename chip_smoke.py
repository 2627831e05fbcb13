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
   32 heads of 128, hidden 4096, KV blocks of 16), GQA shapes included,
   and times kernel, plain version, the one PyTorch call that computes the
   same function (where there is one) and the least time the card could
   take (bytes / 3.35 TB/s or bf16 flops / 989 TFLOP/s, whichever is
   larger). Tolerances, as |kernel - plain| <= atol + rtol * |plain|: both
   versions accumulate in f32, so bf16 output rounding sets the limit —
   one bf16 step is 2^-7 relative, hence rtol 1e-2 on every bf16 output,
   with atol 2e-2 on flash outputs (the tensor-core flash kernel also
   rounds the probabilities to bf16 before P.V, as FlashAttention does),
   2e-3 on paged outputs (f32 probabilities, as in the plain version) and
   1e-3 on RMSNorm outputs; the f32 lse and rstd get atol 1e-3.
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
   launched fails the run. The ``launches`` of the JSON line are the sum
   of both paths.
4. Profiles one decode step of 4 running slots: the wall time of
   unprofiled steps against the device busy time (the union of the
   profiled step's kernel intervals), and the kernels that took it.

The last two lines are one JSON object with every kernel's numbers and one
with the device. Any failure raises and exits non-zero; without a CUDA
device, or without the package beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

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
SOURCES = {
    "flash_attention": ("paddle_tpu_torch/csrc/flash_attention.cu",
                        "paddle_tpu/kernels/flash_attention.py:108"),
    "paged_attention": ("paddle_tpu_torch/csrc/paged_attention.cu",
                        "paddle_tpu/kernels/paged_attention.py:89"),
    "rmsnorm": ("paddle_tpu_torch/csrc/rmsnorm.cu",
                "paddle_tpu/kernels/rmsnorm.py:42"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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


def paged_phase(torch, g):
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_plain)

    print("[kernel] paged_attention  7B layout, bs 16, slots 4, bf16")
    L, N, bs, D, M = 32, 257, 16, 128, 64
    row = None
    worst = 0.0
    # ctx 999 and 577 end in a partial 64-token step past the 512 mark
    for Hq, Hkv, ctx_list in ((32, 32, [1, 17, 1000, 513]),
                              (32, 8, [1, 17, 999, 577])):
        # a pool as large as the engine's (32 layers): each timed launch
        # reads another layer, so K/V come from device memory, not L2
        pool = torch.randn(L, N, 2, Hkv, bs, D, device="cuda",
                           generator=g).bfloat16()
        q = torch.randn(4, Hq, D, device="cuda", generator=g).bfloat16()
        perm = torch.randperm(N - 1, device="cuda", generator=g) + 1
        bt = perm[:4 * M].reshape(4, M).to(torch.int32)
        ctx = torch.tensor(ctx_list, device="cuda", dtype=torch.int32)
        a = paged_attention_cuda(q, pool[0], bt, ctx)
        b = paged_attention_plain(q, pool[0], bt, ctx)
        torch.cuda.synchronize()
        err = check(torch, f"Hq={Hq} Hkv={Hkv} ctx={ctx_list} out", a, b,
                    PAGED_ATOL, BF16_RTOL)
        worst = max(worst, err)
        if Hq == Hkv:
            it = iter(range(10 ** 9))
            ms = time_ms(torch, lambda: paged_attention_cuda(
                q, pool[next(it) % L], bt, ctx), iters=L)
            plain = time_ms(torch, lambda: paged_attention_plain(
                q, pool[next(it) % L], bt, ctx), iters=L)
            live = sum(ctx_list)
            nbytes = (2 * q.numel() * 2 + live * 2 * Hkv * D * 2
                      + sum(-(-c // bs) for c in ctx_list) * 4 + 4 * 4)
            bound, by = bound_ms(nbytes, 4 * live * Hq * D)
            row = dict(shape=f"q [4, {Hq}, {D}], ctx {ctx_list}", ms=ms,
                       plain_ms=plain, library_ms=None, bound_ms=bound,
                       bound_by=by)
        del pool
    row["max_abs_err"] = worst
    return row


def flash_phase(torch, g):
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
            ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, True))
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
                       bound_by=by)
    row["max_abs_err"] = worst
    return row


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
    busy_us, reach = 0.0, -math.inf
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy_us += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    busy = busy_us / 1e3
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
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {name} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()

    model, launches = serving_phase(torch, K)
    profile_decode_step(torch, model)
    del model

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
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
