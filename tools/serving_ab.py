"""The ``[serving]`` phase of one checkout's ``chip_smoke.py``, on the card.

    python tools/serving_ab.py CHECKOUT

Builds the checkout's kernels, then runs its ``chip_smoke.serving_phase``:
Llama-2-7B (bf16, random weights from seed 0) serving 7 requests of 16
tokens through that checkout's ``LLMEngine``, which prints the run's wall,
its mean TTFT and its decode tokens/s. To compare two checkouts, run it on
each in turns in one call (A B B A): host-bound walls spread between
calls."""
import os
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch import kernels as K  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402

print(f"SERVING {root}: {chip_smoke.card_line()}", flush=True)
_build.build_all()
chip_smoke.serving_phase(torch, K)
print(f"SERVING {root}: done", flush=True)
