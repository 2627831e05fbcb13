#!/usr/bin/env python3
"""What the eager API's shell costs the port's existing paths, on one CUDA
card: a checkout against another, in turns.

    python tools/eager_shell_bench.py --root A --root B [--root B --root A]
        [--decode-only]

For every root, in the order given, a subprocess of its own imports that
root's ``paddle_tpu_torch`` and times, on plain ``torch.Tensor`` inputs as
the existing phases feed them: ResNet-50 training steps at
``chip_smoke.py``'s ``[resnet]`` recipe (64 x 224, O1, Momentum over
PiecewiseDecay; step wall and the host's time to queue a step, median of
STEPS after a warm-up), and ResNet-50 eval at batch 1 under O1 (ms a
forward, median of EVALS: the host sets it), and Llama-2-7B's decode step
(32 layers, bf16, random weights, ``LLMEngine`` with 4 running slots at
contexts 300-700: ``chip_smoke.py``'s ``[profile]`` decode step; wall of a
synchronised step, median of DECODES). Beside the walls, the host thread's
CPU time to queue a training step and an eval forward (``thread_time``,
no synchronisation inside, so time the process spent descheduled on a
shared host does not count; summed over all the steps or forwards and
divided, as a sandbox's thread clock may tick in 10 ms). Both trees' code
paths are
the ones the smoke runs, so parent, change, change, parent in one call
shows what wrapping parameters and results costs where no user Tensor is
involved. Prints the card's name and power limit, then one JSON line a
run. ``--decode-only`` times the decode step alone (more pairs in one
call). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

STEPS = 20
EVALS = 100
DECODES = 20


def worker(root, decode_only=False):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    res = {"root": root} if decode_only else resnet_times(torch)
    res.update(root=root, llama7b_decode_step_ms=decode_time(torch),
               decodes=DECODES)
    print(json.dumps(res))


def _med(v):
    return sorted(v)[len(v) // 2]


def resnet_times(torch):
    """The ResNet-50 O1 step's and batch-1 eval's times."""
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum, PiecewiseDecay
    from paddle_tpu_torch.vision.models import resnet50

    framework.seed(0)
    model = resnet50(seed=0)
    sched = PiecewiseDecay([1, 1000], [0.1, 0.01, 0.001])
    opt = Momentum(learning_rate=sched, momentum=0.9,
                   parameters=model.parameters(), weight_decay=1e-4)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(64, 3, 224, 224, generator=g).cuda()
    y = torch.randint(0, 1000, (64, 1), generator=g).cuda()

    def step():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()

    for _ in range(3):
        step()
    queued, walls, step_cpu = [], [], 0.0
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0, c0 = time.monotonic(), time.thread_time()
        step()
        t1, c1 = time.monotonic(), time.thread_time()
        torch.cuda.synchronize()
        queued.append((t1 - t0) * 1e3)
        step_cpu += c1 - c0
        walls.append((time.monotonic() - t0) * 1e3)
    model.eval()
    x1 = x[:1].contiguous()
    evals, eval_cpu = [], 0.0
    with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
        for _ in range(5):
            model(x1)
        for _ in range(EVALS):
            torch.cuda.synchronize()
            t0, c0 = time.monotonic(), time.thread_time()
            model(x1)
            eval_cpu += time.thread_time() - c0
            torch.cuda.synchronize()
            evals.append((time.monotonic() - t0) * 1e3)

    del model, opt, x, y, x1
    torch.cuda.empty_cache()
    return {"resnet50_step_wall_ms": _med(walls),
            "resnet50_step_queued_ms": _med(queued),
            "resnet50_step_queue_cpu_ms": step_cpu / STEPS * 1e3,
            "resnet50_eval_b1_ms": _med(evals),
            "resnet50_eval_b1_queue_cpu_ms": eval_cpu / EVALS * 1e3,
            "steps": STEPS, "evals": EVALS}


def decode_time(torch):
    """Llama-2-7B's decode step, ms (median of DECODES)."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams

    llama = LlamaForCausalLM(llama_7b(), dtype=torch.bfloat16)
    eng = LLMEngine(llama, max_slots=4, max_model_len=1024, block_size=16)
    rng = torch.Generator().manual_seed(2)
    for n in (300, 400, 500, 700):
        eng.add_request(torch.randint(0, 32000, (n,), generator=rng).tolist(),
                        SamplingParams(max_new_tokens=DECODES + 8))
    for _ in range(3):                  # admit and prefill, then decode
        eng.step()
    decodes = []
    for _ in range(DECODES):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng.step()
        torch.cuda.synchronize()
        decodes.append((time.monotonic() - t0) * 1e3)
    return _med(decodes)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--decode-only", action="store_true")
    args = ap.parse_args()
    roots = args.root or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    if args.worker:
        return worker(roots[0], args.decode_only)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(out.strip().splitlines()[0])
    for root in roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", "--root", root]
                             + ["--decode-only"] * args.decode_only,
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
