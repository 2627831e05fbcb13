"""Activation layers (counterpart of ``paddle_tpu/nn/layers/activation.py``;
all of its classes). The simple ones hold their keyword arguments and call
the functional of the same name; ``PReLU`` holds a weight and builds on
``cuda`` unless ``device="cpu"`` (``core.resolve_device``)."""
from __future__ import annotations

import torch
from torch import nn

from ...core import resolve_device
from .. import functional as F
from ..layer import Layer

__all__ = [
    "ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid", "LogSigmoid",
    "Tanh", "Softmax", "LogSoftmax", "LeakyReLU", "PReLU", "RReLU", "Silu",
    "Swish", "Mish", "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink",
    "Softshrink", "Tanhshrink", "ThresholdedReLU", "Softplus", "Softsign",
    "Maxout", "GLU",
]


def _simple(name, fn_name, **defaults):
    """A parameter-free layer calling ``F.<fn_name>`` with ``defaults``
    updated by the constructor's keyword arguments (``name`` dropped)."""

    def __init__(self, **kwargs):
        Layer.__init__(self)
        kwargs.pop("name", None)
        self._kwargs = {**defaults, **kwargs}

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kwargs)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())

    return type(name, (Layer,), {"__init__": __init__,
                                     "forward": forward,
                                     "extra_repr": extra_repr,
                                     "__module__": __name__})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Tanh = _simple("Tanh", "tanh")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Softsign = _simple("Softsign", "softsign")
ELU = _simple("ELU", "elu", alpha=1.0)
SELU = _simple("SELU", "selu")
CELU = _simple("CELU", "celu", alpha=1.0)
GELU = _simple("GELU", "gelu", approximate=False)
Softmax = _simple("Softmax", "softmax", axis=-1)
LogSoftmax = _simple("LogSoftmax", "log_softmax", axis=-1)
LeakyReLU = _simple("LeakyReLU", "leaky_relu", negative_slope=0.01)
Hardtanh = _simple("Hardtanh", "hardtanh", min=-1.0, max=1.0)
Hardshrink = _simple("Hardshrink", "hardshrink", threshold=0.5)
Softshrink = _simple("Softshrink", "softshrink", threshold=0.5)
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu",
                          threshold=1.0)
Softplus = _simple("Softplus", "softplus", beta=1.0, threshold=20.0)
GLU = _simple("GLU", "glu", axis=-1)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class PReLU(Layer):
    """``prelu`` with a learned weight of ``num_parameters`` slopes (one, or
    one per channel), initialised to ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._data_format = data_format
        self.weight = nn.Parameter(torch.full(
            (num_parameters,), float(init), device=resolve_device(device),
            dtype=dtype))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)
