"""Decode-step wall of one checkout of the port, on the card.

    python tools/decode_step_ab.py CHECKOUT

Serves Llama-2-7B (bf16, random weights from seed 0) through the
checkout's ``LLMEngine`` with 4 running slots (prompts of 300-700
tokens), takes 3 warm steps, then times 12 decode steps, each ended by
``torch.cuda.synchronize()``, and prints their median, min and max in ms.
To compare two checkouts, run it on each in turns in one call (A B B A
...): host-bound walls spread between calls."""
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import torch  # noqa: E402

from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b  # noqa: E402
from paddle_tpu_torch.serving import LLMEngine, SamplingParams  # noqa: E402

_build.build_all()
gen = torch.Generator(device="cuda").manual_seed(0)
model = LlamaForCausalLM(llama_7b(), dtype=torch.bfloat16, generator=gen)
model.eval()
eng = LLMEngine(model, max_slots=4, max_model_len=1024, block_size=16)
rng = torch.Generator().manual_seed(2)
for n in (300, 400, 500, 700):
    eng.add_request(torch.randint(0, 32000, (n,), generator=rng).tolist(),
                    SamplingParams(max_new_tokens=32))
for _ in range(3):
    eng.step()
torch.cuda.synchronize()
walls = []
for _ in range(12):
    t0 = time.monotonic()
    eng.step()
    torch.cuda.synchronize()
    walls.append((time.monotonic() - t0) * 1e3)
walls.sort()
print(f"DECODE {os.path.basename(root) or root}: median "
      f"{walls[len(walls) // 2]:.3f} ms, min {walls[0]:.3f}, max "
      f"{walls[-1]:.3f}", flush=True)
