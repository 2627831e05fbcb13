"""Convolution layers (counterpart of ``paddle_tpu/nn/layers/conv.py``;
ports ``Conv1D`` and ``Conv2D``). Weights are Paddle's ``[out, in / groups,
*k]`` (the same as ``torch.nn.Conv*d``'s, so they convert as they are),
initialised as Paddle does: ``KaimingUniform`` over ``fan_in = in / groups
* prod(k)`` (bound ``sqrt(6 / fan_in)``) and a ``Uniform(+-1 /
sqrt(fan_in))`` bias, drawn from ``generator`` (default:
``framework.random``'s generator of the device). Each builds on ``cuda``
unless ``device="cpu"`` (``core.resolve_device``)."""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core import resolve_device
from ...framework.random import get_generator
from ..functional.conv import conv1d, conv2d
from ..layer import Layer

__all__ = ["Conv1D", "Conv2D"]


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        k = tuple(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * n
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"Conv{n}D: channels {in_channels} -> "
                             f"{out_channels} are not divisible by groups "
                             f"{groups}")
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *k, **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty(out_channels, **kw))
        self._fan_in = in_channels // groups * math.prod(k)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        g = generator if generator is not None else get_generator(
            self.weight.device)
        bound = math.sqrt(6.0 / self._fan_in)
        self.weight.uniform_(-bound, bound, generator=g)
        if self.bias is not None:
            b = 1.0 / math.sqrt(self._fan_in)
            self.bias.uniform_(-b, b, generator=g)

    def extra_repr(self):
        return (f"{tuple(self.weight.shape)}, stride={self._stride}, "
                f"padding={self._padding}, groups={self._groups}, "
                f"data_format={self._data_format}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, bias_attr, data_format,
                         **kw)

    def forward(self, x):
        return conv1d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, bias_attr, data_format,
                         **kw)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)
