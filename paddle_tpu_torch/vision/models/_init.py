"""Weights of the zoo's models: Paddle's initialisers, drawn in module
order from one generator."""
from __future__ import annotations

import torch

from ...core import resolve_device
from ...framework.random import weights_generator
from ...nn.layers.common import Linear
from ...nn.layers.conv import _ConvNd

__all__ = ["layer_kw", "init_weights"]


def layer_kw(device, dtype):
    """The ``device`` / ``dtype`` keywords every layer of a model gets."""
    return dict(device=resolve_device(device), dtype=dtype)


@torch.no_grad()
def init_weights(model, generator=None, seed=None):
    """Redraw every convolution (Kaiming-uniform, uniform bias) and linear
    layer (Xavier-uniform, zero bias) of ``model`` from ``generator`` (or a
    fresh one seeded with ``seed``; default ``framework.random``'s generator
    of the device); norms keep their 1 and 0, PReLU its constant."""
    dev = next(model.parameters()).device
    g = weights_generator(dev, generator, seed)
    for m in model.modules():
        if isinstance(m, (_ConvNd, Linear)):
            m.reset_parameters(g)
