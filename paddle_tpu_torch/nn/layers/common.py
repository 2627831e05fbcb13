"""Common layers (counterpart of ``paddle_tpu/nn/layers/common.py``; ports
``Linear``, ``Dropout``, ``Flatten`` and ``Identity``, and ``Sequential``
and ``LayerList`` of ``paddle_tpu/nn/layer.py``). ``Embedding`` is
``torch.nn``'s.

``Linear`` stores its weight ``[in_features, out_features]``, as Paddle
does, so ``paddle.matmul(x, fc.weight) + fc.bias == fc(x)`` and its state
dict needs no transpose. The older models' projections are plain
``torch.nn.Linear``\\ s (``[out, in]``); ``Layer.state_dict`` maps them to
Paddle's layout."""
from __future__ import annotations

import torch
from torch import nn

from ...core import resolve_device
from ...framework.random import get_generator
from ..functional.common import dropout
from ..layer import Layer

__all__ = ["Linear", "Dropout", "Flatten", "Identity", "Sequential",
           "LayerList"]


class Linear(Layer):
    """``y = x W + b``, ``W`` of ``[in_features, out_features]``, with
    Paddle's initialisers: a Xavier-uniform weight and a zero bias (none
    with ``bias_attr=False``), drawn from ``generator`` (default:
    ``framework.random``'s generator of the device). Builds on ``cuda``
    unless ``device="cpu"``. Under ``auto_cast`` it computes in the amp
    dtype (white list)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty(out_features, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Xavier-uniform drawn in ``[out, in]`` order (the values the
        port's earlier ``[out, in]`` layer drew from the same generator),
        stored transposed."""
        g = generator if generator is not None else get_generator(
            self.weight.device)
        w = torch.empty(self.out_features, self.in_features,
                        device=self.weight.device, dtype=self.weight.dtype)
        nn.init.xavier_uniform_(w, generator=g)
        torch.Tensor.copy_(self.weight, w.t())
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return torch.nn.functional.linear(x, torch.Tensor.t(self.weight),
                                          self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return dropout(x, p=self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Flatten(Layer):
    """Merge the dims ``start_axis..stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Sequential(Layer, nn.Sequential):
    """Paddle's ``Sequential``: layers named ``"0"``, ``"1"``, ... in order,
    or given names, as ``(name, layer)`` pairs or one list of them."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class LayerList(Layer, nn.ModuleList):
    """Paddle's ``LayerList``: ``torch.nn.ModuleList`` under its name
    (sub-layers named ``"0"``, ``"1"``, ... as in the reference)."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)
