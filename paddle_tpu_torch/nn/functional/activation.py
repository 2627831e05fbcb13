"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``; this slice ports ``gelu``,
``relu`` and ``tanh``). None is on amp's lists: each runs in its input's dtype."""
from __future__ import annotations

import torch

__all__ = ["gelu", "relu", "tanh"]


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
