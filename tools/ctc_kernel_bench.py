#!/usr/bin/env python3
"""Time the port's CTC lattice kernels alone, on one CUDA card.

    python tools/ctc_kernel_bench.py [--root DIR ...]

Runs ``chip_smoke.py``'s ``ctc_phase`` (every case checked against the
plain versions, then the Conformer's ``log_probs [400, 16, 128]`` at L 48
and the long-label L 100 timed, with the chain bounds where the checkout
has the CTC probe) once for every root, in the order given, each in a
subprocess of its own, as ``tools/rnnt_bench.py`` does for the RNN-T
kernels: ``--root`` is a checkout (or a ``git archive`` unpacked) whose
``paddle_tpu_torch`` is imported (default: this one; the phase is always
this checkout's), so two versions of the kernels compare in one call on
one card, in turns (parent, change, change, parent). Only ``csrc/ctc.cu``
is built. Prints the card's name and power limit, then one JSON line per
run: ``{"root": ..., "rows": [alpha row, beta row]}``. Imports nothing of
JAX. (``tools/ctc_bench.py`` is the JAX package's own Pallas benchmark.)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import rnnt_bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(rnnt_bench.main("ctc"))
