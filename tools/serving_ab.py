"""Phases of one checkout's ``chip_smoke.py``, on the card.

    python tools/serving_ab.py CHECKOUT [PHASE ...]

Builds the checkout's kernels, then runs the named phases of its
``chip_smoke`` (default ``serving``) and prints each one's seconds:

- ``serving``: ``serving_phase`` — Llama-2-7B (bf16, random weights from
  seed 0) serving 7 requests of 16 tokens through that checkout's
  ``LLMEngine``, which prints the run's wall, its mean TTFT and its decode
  tokens/s;
- ``tenancy``: ``serving_tenancy_phase`` on that model (checkouts that
  have it);
- ``static``: ``static_deploy_phases`` (ERNIE-3.0-Base through
  ``to_static``, ``jit``, the predictor and a static Program);
- ``llama``: ``llama_deploy_phase`` and ``llama_static_grad_phase``.

The compilers' caches go to the checkout's own build directory, so one
checkout's compiles never warm another's. To compare two checkouts, run
this on each in turns in one call (A B B A): host-bound walls spread
between calls."""
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
phases = sys.argv[2:] or ["serving"]
sys.path.insert(0, root)
build = os.path.join(root, "paddle_tpu_torch", "csrc", "build")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor")
os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch import kernels as K  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402

print(f"PHASES {root} {phases}: {chip_smoke.card_line()}", flush=True)
_build.build_all()
model = None
for phase in phases:
    t0 = time.monotonic()
    if phase == "serving":
        model, _ = chip_smoke.serving_phase(torch, K)
    elif phase == "tenancy":
        if not hasattr(chip_smoke, "serving_tenancy_phase"):
            print(f"PHASE {root} tenancy: not in this checkout", flush=True)
            continue
        chip_smoke.serving_tenancy_phase(torch, K, model)
    elif phase == "static":
        chip_smoke.static_deploy_phases(torch, K)
    elif phase == "llama":
        _, m16, ids = chip_smoke.llama_deploy_phase(torch, K)
        t1 = time.monotonic()
        print(f"PHASE {root} to_static llama: {t1 - t0:.1f} s", flush=True)
        chip_smoke.llama_static_grad_phase(torch, K, m16, ids)
        print(f"PHASE {root} static llama grad: {time.monotonic() - t1:.1f}"
              f" s", flush=True)
        del m16
    else:
        raise SystemExit(f"unknown phase {phase!r}")
    print(f"PHASE {root} {phase}: {time.monotonic() - t0:.1f} s", flush=True)
print(f"PHASES {root}: done", flush=True)
