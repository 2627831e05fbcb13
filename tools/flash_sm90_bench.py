#!/usr/bin/env python3
"""Time the port's flash kernels alone at a few shapes, on one CUDA card.

    python tools/flash_sm90_bench.py [--root DIR ...]

For every ``--root`` in the order given (default: this checkout), in a
subprocess of its own, builds that checkout's kernels and times the
forward and the backward kernel (``flash_attention_cuda`` /
``flash_attention_bwd_cuda``, ``chip_smoke.time_ms``: device time, the
card asleep while the host queues) at: the bench_masked key-padding mask
``[4, 2048, 8, 128]``, the encoder path's masked ``[16, 512, 12, 64]`` p
0.1, causal ``[1, 2048, 32, 128]``, ERNIE's dropout ``[16, 512, 12, 64]``
(the classes 64 and 128), the Conformer's ``[16, 400, 4, 36]`` p 0.1,
``[16, 512, 8, 96]`` and ``[16, 512, 3, 256]``. A root is a checkout or a
``git archive`` unpacked; two versions compare in one call on one card, in
turns (change, parent, change, parent). Prints the card's name and power
limit, each root's build seconds and one line a shape, then one JSON line
a run: ``{"root": ..., "<shape>": [fwd ms, bwd ms], ...}``. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(root):
    import torch

    root = os.path.abspath(root)
    sys.path[:0] = [root, HERE]
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as F

    import chip_smoke as C

    if not F.__file__.startswith(root):
        raise RuntimeError(f"imported {F.__file__}, not {root}'s")
    t0 = time.monotonic()
    _build.build_all()
    print(f"{root}: built in {time.monotonic() - t0:.1f}s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root}

    def shape(tag, B, S, H, D, p=0.0, causal=False, mask=None):
        q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                       .bfloat16() for _ in range(4))
        o, lse = F.flash_attention_cuda(q, k, v, causal, None, p, 5, mask)
        dg = F.delta_minus_glse(o, do)
        f = C.time_ms(torch, lambda: F.flash_attention_cuda(
            q, k, v, causal, None, p, 5, mask))
        b = C.time_ms(torch, lambda: F.flash_attention_bwd_cuda(
            q, k, v, do, lse, dg, causal, None, p, 5, mask))
        out[tag] = [f, b]
        print(f"  {tag}: forward {f:.4f} ms, backward {b:.4f} ms",
              flush=True)

    def padding(B, S, lo, seed):
        lens = torch.randint(lo, S + 1, (B,),
                             generator=torch.Generator().manual_seed(seed))
        keep = torch.arange(S)[None] < lens[:, None]
        return keep[:, None, None, :].cuda()

    shape("masked [4, 2048, 8, 128]", 4, 2048, 8, 128,
          mask=padding(4, 2048, 1024, 1))
    shape("masked [16, 512, 12, 64] p 0.1", 16, 512, 12, 64, 0.1,
          mask=padding(16, 512, 256, 2))
    shape("causal [1, 2048, 32, 128]", 1, 2048, 32, 128, causal=True)
    shape("dropout [16, 512, 12, 64] p 0.1", 16, 512, 12, 64, 0.1)
    shape("[16, 400, 4, 36] p 0.1", 16, 400, 4, 36, 0.1)
    shape("[16, 512, 8, 96]", 16, 512, 8, 96)
    shape("[16, 512, 3, 256]", 16, 512, 3, 256)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a checkout to time (repeatable; default: this)")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        one(args.one)
        return 0
    sys.path.insert(0, HERE)
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    rc = 0
    for root in args.root or [HERE]:
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__),
                               "--one", root])
    return rc


if __name__ == "__main__":
    sys.exit(main())
