"""Activation recompute (counterpart of ``paddle_tpu/distributed/
recompute.py``; Paddle's ``fleet.recompute`` ``RecomputeFunction``).

``torch.utils.checkpoint`` drops the activations of ``function`` and
replays its forward in backward. With ``preserve_rng_state=True`` the
replay draws what the forward drew: torch's checkpoint restores torch's
own CPU and CUDA generators, and this module restores the port's too
(``framework.random``: every device generator, the host generator that
``next_seed`` draws flash-dropout seeds from, and an active tracker
stream of ``fleet_random``), so a dropout mask recomputed in backward is
the forward's mask and the gradients are those of the same layer run
without recompute (ROADMAP Queue 3, L1).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..framework import random as frandom

__all__ = ["recompute", "recompute_sequential"]


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              **kwargs):
    """Checkpoint ``function(*args, **kwargs)``. Without autograd (no
    grad mode) it calls straight through. ``use_reentrant`` is taken for
    Paddle's signature; the checkpoint is torch's non-reentrant one, which
    also differentiates parameters that the inputs do not reach."""
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    snap = frandom.generator_states() if preserve_rng_state else None
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1 or snap is None:
            return function(*a, **kwargs)
        # the replay in backward: the forward's generator states, then
        # back to where the rest of the program left them
        now = frandom.generator_states()
        frandom.set_generator_states(snap)
        try:
            with frandom.rng_scope(snap["scope"]):
                return function(*a, **kwargs)
        finally:
            frandom.set_generator_states(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Paddle's recompute_sequential: checkpoint each of ``ctx["segments"]``
    segments of a Sequential."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    per = max(1, len(layers) // segments)
    out = args[0] if len(args) == 1 else args
    for i in range(0, len(layers), per):
        seg = layers[i: i + per]

        def seg_fn(x, seg=seg):
            for layer in seg:
                x = layer(x)
            return x

        out = recompute(seg_fn, out, **kwargs)
    return out
