"""``paddle.autograd`` (counterpart of ``paddle_tpu/autograd.py``):
``backward``, ``grad``, the grad-mode switches and ``PyLayer``.

A :class:`PyLayer` subclass runs as a ``torch.autograd.Function`` made for
it once: ``forward(ctx, *args, **kwargs)`` under no grad, ``backward(ctx,
*grads)`` returning one gradient per tensor argument of ``forward``. As in
the JAX package, a ``create_graph`` pass through a PyLayer's backward
raises ``NotImplementedError`` (its backward is not taped), though torch
could run it.
"""
from __future__ import annotations

import torch

from .core.autograd import (backward, enable_grad, grad, is_grad_enabled,
                            no_grad, set_grad_enabled)
from .core.tensor import Tensor, is_tensor_arg, wrap

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "PyLayer", "PyLayerContext"]


class PyLayerContext:
    """What ``forward`` and ``backward`` share: ``save_for_backward`` /
    ``saved_tensor()`` (Paddle's name) and any attribute set on it."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved


def _function_of(cls):
    fn = cls.__dict__.get("_autograd_fn")
    if fn is not None:
        return fn

    def forward(ctx, kwargs, *args):
        ctx.paddle = PyLayerContext()
        ctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
        return cls.forward(ctx.paddle, *args, **kwargs)

    def backward_(ctx, *grads):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                f"paddle.grad(create_graph=True) through the PyLayer "
                f"{cls.__name__}: its backward is not taped")
        grads = [None if g is None else g.as_subclass(Tensor)
                 for g in grads]
        got = cls.backward(ctx.paddle, *grads)
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        it = iter(got)
        return (None, *[next(it, None) if is_t else None
                        for is_t in ctx.tensor_args])

    fn = type(f"{cls.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward_)})
    cls._autograd_fn = fn
    return fn


class PyLayer:
    """Subclass with static ``forward(ctx, *args)`` and
    ``backward(ctx, *grads)``; call ``YourLayer.apply(*args)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        out = _function_of(cls).apply(kwargs, *args)
        return wrap(out) if any(is_tensor_arg(a) for a in args) else out
