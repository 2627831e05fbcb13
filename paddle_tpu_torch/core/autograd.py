"""Eager autograd (counterpart of ``paddle_tpu/core/autograd.py``).

The JAX package records a tape of ``jax.vjp`` closures; here torch's
autograd records and runs the graph, and this module gives it Paddle's
names and rules: ``backward`` seeds a non-scalar output with ones and
skips outputs outside any graph; :func:`grad` is ``paddle.grad`` over
``torch.autograd.grad`` (an input that gets no gradient raises unless
``allow_unused``; ``no_grad_vars`` cut the graph: no gradient flows back
through them, which the JAX package's ``grad`` does not do: ROADMAP R12).
``no_grad``, ``enable_grad`` and ``set_grad_enabled`` are torch's, which
work as context managers and decorators as Paddle's do.
"""
from __future__ import annotations

import torch

from .tensor import Tensor, wrap

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "backward", "grad"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    if x is None:
        return None
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _seeds(outputs, grad_outputs):
    """The outputs inside a graph and their seeds (ones where none is
    given, whatever the output's shape)."""
    grad_outputs = _as_list(grad_outputs) or [None] * len(outputs)
    outs, seeds = [], []
    for t, g in zip(outputs, grad_outputs):
        if not t.requires_grad:
            continue
        outs.append(t)
        seeds.append(torch.ones_like(t) if g is None else g)
    return outs, seeds


def backward(tensors, grad_tensors=None, retain_graph=None, **kwargs):
    """``paddle.autograd.backward``: accumulate into the leaves' ``.grad``."""
    outs, seeds = _seeds(_as_list(tensors), grad_tensors)
    if outs:
        torch.autograd.backward(outs, seeds, retain_graph=retain_graph,
                                **kwargs)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False, no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, without touching ``.grad``. Returns a list of Tensors
    (None for an unused input when ``allow_unused``)."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    outs, seeds = _seeds(outputs, grad_outputs)
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    res = [None] * len(inputs)
    if outs and live:
        cut = [v.register_hook(torch.zeros_like)
               for v in _as_list(no_grad_vars) or ()
               if v.requires_grad and not any(v is t for t in inputs)]
        try:
            got = torch.autograd.grad(
                outs, [inputs[i] for i in live], seeds,
                retain_graph=retain_graph, create_graph=create_graph,
                allow_unused=True)
        finally:
            for h in cut:
                h.remove()
        for i, g in zip(live, got):
            res[i] = g
    if not allow_unused and any(g is None for g in res):
        raise RuntimeError(
            "an input tensor received no gradient; pass allow_unused=True "
            "to return None for unused inputs")
    return [None if g is None else g if isinstance(g, Tensor)
            else wrap(g) for g in res]
