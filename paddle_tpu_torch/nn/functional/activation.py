"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``; ports ``gelu``, ``relu``,
``tanh``, ``swish``, ``glu`` and ``log_softmax``). Only ``log_softmax`` is
on amp's black list (under ``auto_cast`` it computes in f32); the others
run in their input's dtype."""
from __future__ import annotations

import torch

from ...amp import cast_for

__all__ = ["gelu", "relu", "tanh", "swish", "glu", "log_softmax"]


def gelu(x, approximate=False, name=None):
    """GELU, exact (erf) by default, the tanh approximation with
    ``approximate=True``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)


def relu(x, name=None):
    """The transformer layers' default activation."""
    return torch.relu(x)


def swish(x, name=None):
    """``x * sigmoid(x)`` (SiLU), the Conformer's activation."""
    return torch.nn.functional.silu(x)


def glu(x, axis=-1, name=None):
    """Gated linear unit: ``a * sigmoid(b)`` with ``a, b`` the two halves of
    ``x`` along ``axis``."""
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """``log(softmax(x))`` along ``axis``; ``dtype`` (a torch dtype or its
    Paddle name) casts ``x`` first."""
    (x,) = cast_for("log_softmax", x)
    if dtype is not None:
        x = x.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    return torch.log_softmax(x, dim=axis)
