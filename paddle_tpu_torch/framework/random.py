"""Global random state (counterpart of ``paddle_tpu/framework/random.py``).

The reference keeps one JAX PRNG key that eager ops split; here, as in
Paddle itself, there is one explicit ``torch.Generator`` per device, all
seeded by :func:`seed`. ``nn.functional.dropout`` draws its keep masks
from the generator of its tensor's device, so they stay on the card; the
flash kernels' per-call dropout seed comes from the CPU generator
(:func:`next_seed`), so drawing it never waits for the card (the TPU
passes its seed to the kernel in SMEM; here it is a kernel argument).
One ``seed(n)`` makes a run reproducible. Inside :func:`rng_scope`
(``distributed.fleet_random``'s tracker) draws come from the scope's
generator instead, and :func:`rand` draws the scope's full logical shape
and hands back this rank's slice of it, so a tensor-parallel dropout mask
is the single-device one, cut. The bits differ from JAX's from the same
seed: the tests hand both packages the same numpy noise where they
compare bits.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["seed", "get_generator", "weights_generator", "next_seed",
           "rng_scope", "rand", "generator_states", "set_generator_states"]

_state = {"seed": 0, "scope": None}
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
    seed); inside :func:`rng_scope`, the scope's generator for it."""
    dev = _key(device)
    scope = _state["scope"]
    if scope is not None:
        return scope.generator(dev)
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


@contextlib.contextmanager
def rng_scope(scope):
    """Draw from ``scope`` inside: ``scope.generator(device)`` answers
    :func:`get_generator`, and ``scope.shard`` (``None`` or ``(dim, rank,
    n)``) makes :func:`rand` draw the logical shape (``n`` times the dim)
    and return slice ``rank`` of it."""
    prev = _state["scope"]
    _state["scope"] = scope
    try:
        yield scope
    finally:
        _state["scope"] = prev


def rand(shape, device, generator=None) -> torch.Tensor:
    """Uniform ``[0, 1)`` of ``shape`` on ``device`` from ``generator``
    (default :func:`get_generator`); under a sharded :func:`rng_scope`,
    this rank's slice of the draw of the logical shape."""
    g = generator if generator is not None else get_generator(device)
    scope = _state["scope"]
    shard = getattr(scope, "shard", None) if generator is None else None
    if shard is None:
        return torch.rand(shape, device=device, generator=g)
    dim, rank, n = shard
    shape = list(shape)
    dim %= len(shape)
    full = list(shape)
    full[dim] *= n
    u = torch.rand(full, device=device, generator=g)
    return u.narrow(dim, rank * shape[dim], shape[dim])


def generator_states() -> dict:
    """A snapshot of every generator's state (the devices', the active
    :func:`rng_scope`'s, and the seed) for :func:`set_generator_states`
    (``distributed.recompute`` replays a forward's draws with it)."""
    scope = _state["scope"]
    return {"seed": _state["seed"],
            "gens": {d: g.get_state() for d, g in _generators.items()},
            "scope": scope,
            "scope_gens": ({} if scope is None else
                           {d: g.get_state()
                            for d, g in scope.generators().items()})}


def set_generator_states(snap: dict) -> None:
    _state["seed"] = snap["seed"]
    for d, st in snap["gens"].items():
        g = _generators.get(d)
        if g is None:
            g = _generators[d] = torch.Generator(device=d)
        g.set_state(st)
    scope = snap["scope"]
    if scope is not None:
        for d, st in snap["scope_gens"].items():
            scope.generator(d).set_state(st)
