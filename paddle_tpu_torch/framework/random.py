"""Global random state (counterpart of ``paddle_tpu/framework/random.py``).

The reference keeps one JAX PRNG key that eager ops split; here, as in
Paddle itself, there is one explicit ``torch.Generator`` per device, all
seeded by :func:`seed`. ``nn.functional.dropout`` draws its keep masks
from the generator of its tensor's device, so they stay on the card; the
flash kernels' per-call dropout seed comes from the CPU generator
(:func:`next_seed`), so drawing it never waits for the card (the TPU
passes its seed to the kernel in SMEM; here it is a kernel argument).
One ``seed(n)`` makes a run reproducible. The bits differ from JAX's from
the same seed: the tests hand both packages the same numpy noise where
they compare bits.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "get_generator", "weights_generator", "next_seed"]

_state = {"seed": 0}
_generators: dict[torch.device, torch.Generator] = {}


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(n: int) -> None:
    """``paddle.seed``: reseed every device's generator with ``n``."""
    _state["seed"] = int(n)
    for g in _generators.values():
        g.manual_seed(int(n))


def get_generator(device="cpu") -> torch.Generator:
    """The generator of ``device`` (created at first use from the current
    seed)."""
    dev = _key(device)
    g = _generators.get(dev)
    if g is None:
        g = _generators[dev] = torch.Generator(device=dev)
        g.manual_seed(_state["seed"])
    return g


def weights_generator(device, generator=None, seed=None) -> torch.Generator:
    """The generator a model draws its weights from: ``generator`` when
    given, else a fresh one on ``device`` seeded with ``seed``, else
    ``device``'s generator."""
    if generator is not None:
        return generator
    if seed is not None:
        return torch.Generator(device=device).manual_seed(int(seed))
    return get_generator(device)


def next_seed() -> int:
    """A fresh 31-bit seed for a kernel's counter-based generator, drawn on
    the host from the CPU generator."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=get_generator("cpu")).item())
