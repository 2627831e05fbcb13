#!/usr/bin/env python3
"""Time the port's RNN-T lattice kernels alone, on one CUDA card.

    python tools/rnnt_bench.py [--root DIR ...]

Runs ``chip_smoke.py``'s ``rnnt_phase`` (every case checked against the
plain versions, then the slice's ``[16, 400, 49]`` and the long-label
``[8, 200, 513]`` timed, with the chain bound where the checkout has the
probe) once for every root, in the order given, each in a subprocess of
its own. ``--root`` is a checkout (or a ``git archive`` unpacked) whose
``paddle_tpu_torch`` is imported (default: this one; the phase is always
this checkout's), so two versions of the kernels compare in one call on
one card, in turns (parent, change, change, parent). Only ``csrc/rnnt.cu``
is built. Prints the card's name and power limit, then one JSON line per
run: ``{"root": ..., "rows": [alpha row, beta-gradient row]}``. Imports
nothing of JAX. ``tools/ctc_kernel_bench.py`` runs the same for the CTC
kernels (``main("ctc")``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py (never a --root's: an older root's
    lattice phases check and time other cases)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root, kind):
    """``chip_smoke.py``'s ``<kind>_phase`` against ``root``'s kernels
    ``paddle_tpu_torch/kernels/<kind>.py``, building ``csrc/<kind>.cu``
    alone."""
    import importlib

    import torch

    sys.path.insert(0, os.path.abspath(root))
    from paddle_tpu_torch.kernels import _build

    mod = importlib.import_module(f"paddle_tpu_torch.kernels.{kind}")
    chip_smoke = _chip_smoke()

    if os.path.dirname(mod.__file__) != os.path.join(
            os.path.abspath(root), "paddle_tpu_torch", "kernels"):
        raise RuntimeError(f"imported {mod.__file__}, not {root}'s")
    _build.sources = lambda: [_build.CSRC / f"{kind}.cu"]
    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = getattr(chip_smoke, f"{kind}_phase")(torch, g)
    print(json.dumps({"root": root, "rows": rows}))


def main(kind="rnnt"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(args.one, kind)
    import torch

    if not torch.cuda.is_available():
        print(f"{os.path.basename(sys.argv[0])}: needs a CUDA device",
              file=sys.stderr)
        return 2
    print(_chip_smoke().card_line())
    for root in args.root or [HERE]:
        rc = subprocess.call([sys.executable, sys.argv[0], "--one", root])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
