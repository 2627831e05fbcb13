#!/usr/bin/env python3
"""Time the port's paged-attention kernel alone, on one CUDA card.

    python tools/paged_attention_bench.py [--root DIR ...] [--waves W ...]

Runs ``chip_smoke.py``'s ``paged_phase`` (each shape checked against the
plain version, then the main row, the GQA and the bandwidth sub-rows
timed) once for every (root, waves) pair, in the order given, each in a
subprocess of its own. ``--root`` is a checkout (or a ``git archive``
unpacked) whose ``paddle_tpu_torch`` is imported (default: this one), so
two versions of the kernel compare in one call on one card, in turns
(parent, change, change, parent). ``--waves`` overrides the split plan's
``WAVES`` (a probe of the split count; roots whose kernel has no split
plan ignore it). Only ``csrc/paged_attention.cu`` is built. Prints the
card's name and power limit, then one JSON line per run:
``{"root": ..., "waves": ..., "row": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(root, waves):
    import torch

    sys.path[:0] = [os.path.abspath(root), HERE]
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as P

    import chip_smoke

    if os.path.dirname(P.__file__) != os.path.join(
            os.path.abspath(root), "paddle_tpu_torch", "kernels"):
        raise RuntimeError(f"imported {P.__file__}, not {root}'s")
    _build.sources = lambda: [_build.CSRC / "paged_attention.cu"]
    _build.build_all()
    if waves is not None and hasattr(P, "WAVES"):
        P.WAVES = waves
    g = torch.Generator(device="cuda").manual_seed(0)
    row = chip_smoke.paged_phase(torch, g)
    print(json.dumps({"root": root, "waves": waves, "row": row}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append")
    ap.add_argument("--waves", action="append", type=int)
    ap.add_argument("--one", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        root, waves = args.one
        return one(root, None if waves == "-" else int(waves))
    import torch

    if not torch.cuda.is_available():
        print("paged_attention_bench: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke

    print(chip_smoke.card_line())
    for root in args.root or [HERE]:
        for waves in args.waves or [None]:
            rc = subprocess.call([sys.executable, __file__, "--one", root,
                                  "-" if waves is None else str(waves)])
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
