"""Common layers (counterpart of ``paddle_tpu/nn/layers/common.py``; ports
``Linear``, ``Dropout``, ``Flatten`` and ``Identity``, and ``Sequential``
and ``LayerList`` of ``paddle_tpu/nn/layer.py``). ``Embedding`` is
``torch.nn``'s.

``Linear`` is a ``torch.nn.Linear``: it stores its weight ``[out, in]``
where Paddle stores ``[in, out]``, so ``models/convert.py`` transposes
exactly the weights of ``nn.Linear`` modules (the models' older layers are
plain ``nn.Linear``s, initialised the same way by their models)."""
from __future__ import annotations

import torch
from torch import nn

from ...core import resolve_device
from ...framework.random import get_generator
from ..functional.common import dropout

__all__ = ["Linear", "Dropout", "Flatten", "Identity", "Sequential",
           "LayerList"]


class Linear(nn.Linear):
    """``y = x W^T + b`` with Paddle's initialisers: a Xavier-uniform weight
    and a zero bias (none with ``bias_attr=False``), drawn from
    ``generator`` (default: ``framework.random``'s generator of the
    device). Builds on ``cuda`` unless ``device="cpu"``. Under
    ``auto_cast`` it computes in the amp dtype (white list)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False,
                         device=resolve_device(device), dtype=dtype)
        if generator is not None:   # nn.Linear's init drew from the default
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        g = generator if generator is not None else get_generator(
            self.weight.device)
        nn.init.xavier_uniform_(self.weight, generator=g)
        if self.bias is not None:
            self.bias.zero_()


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return dropout(x, p=self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Flatten(nn.Module):
    """Merge the dims ``start_axis..stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Sequential(nn.Sequential):
    """Paddle's ``Sequential``: layers named ``"0"``, ``"1"``, ... in order,
    or given names, as ``(name, layer)`` pairs or one list of them."""

    def __init__(self, *layers):
        nn.Module.__init__(self)
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class LayerList(nn.ModuleList):
    """Paddle's ``LayerList``: ``torch.nn.ModuleList`` under its name
    (sub-layers named ``"0"``, ``"1"``, ... as in the reference)."""
