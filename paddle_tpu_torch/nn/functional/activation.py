"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``; every function of its
``__all__``), with the reference's formulas: ``hardsigmoid`` is
``clip(slope * x + offset, 0, 1)`` (slope 1/6, offset 0.5), ``rrelu`` takes
the mean slope ``(lower + upper) / 2`` in training too, ``leaky_relu`` and
``prelu`` pass ``x >= 0``. ``softmax`` and ``log_softmax`` are on amp's
black list (under ``auto_cast`` they compute in f32); the others run in
their input's dtype. ``gumbel_softmax`` draws its noise from
``framework.random``'s generator of x's device, so it agrees with the
reference in distribution, not in bits."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp import cast_for
from ...framework.random import get_generator

__all__ = [
    "relu", "relu6", "relu_", "elu", "selu", "celu", "gelu", "sigmoid",
    "log_sigmoid", "tanh", "softmax", "log_softmax", "leaky_relu", "prelu",
    "rrelu", "silu", "swish", "mish", "hardswish", "hardsigmoid", "hardtanh",
    "hardshrink", "softshrink", "tanhshrink", "thresholded_relu", "softplus",
    "softsign", "maxout", "glu", "gumbel_softmax", "one_hot",
]


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def gelu(x, approximate=False, name=None):
    """GELU, exact (erf) by default, the tanh approximation with
    ``approximate=True``."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)


def relu(x, name=None):
    return torch.relu(x)


def relu_(x, name=None):
    """``relu`` in place; returns x."""
    return torch.relu_(x)


def relu6(x, name=None):
    return TF.relu6(x)


def elu(x, alpha=1.0, name=None):
    return TF.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return TF.celu(x, alpha)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


def silu(x, name=None):
    return TF.silu(x)


def swish(x, name=None):
    """``x * sigmoid(x)`` (SiLU), the Conformer's activation."""
    return TF.silu(x)


def mish(x, name=None):
    return TF.mish(x)


def softsign(x, name=None):
    return TF.softsign(x)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    """``softmax`` along ``axis``; ``dtype`` (a torch dtype or its Paddle
    name) casts ``x`` first."""
    (x,) = cast_for("softmax", x)
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """``log(softmax(x))`` along ``axis``; ``dtype`` (a torch dtype or its
    Paddle name) casts ``x`` first."""
    (x,) = cast_for("log_softmax", x)
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where ``x >= 0``, else ``weight * x``: one weight, or one per
    channel (axis 1 for ``"NC..."`` formats, else the last)."""
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    shape = [1] * x.ndim
    shape[1 if data_format[1] == "C" else x.ndim - 1] = weight.numel()
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """The reference's: the mean slope whatever ``training`` says."""
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def hardswish(x, name=None):
    """``x * clip(x + 3, 0, 6) / 6``."""
    return TF.hardswish(x)


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return TF.hardtanh(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, 0.0)


def softshrink(x, threshold=0.5, name=None):
    return TF.softshrink(x, threshold)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, value)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``softplus(beta x) / beta``, and ``x`` where ``beta x > threshold``."""
    return TF.softplus(x, beta, threshold)


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` channels along ``axis``."""
    ax = axis % x.ndim
    shape = list(x.shape)
    shape[ax:ax + 1] = [shape[ax] // groups, groups]
    return x.reshape(shape).amax(ax + 1)


def glu(x, axis=-1, name=None):
    """Gated linear unit: ``a * sigmoid(b)`` with ``a, b`` the two halves of
    ``x`` along ``axis``."""
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g``; ``hard``
    gives the one-hot of the maximum with the soft gradient (straight
    through)."""
    g = -torch.empty_like(x).exponential_(
        generator=get_generator(x.device)).log()
    y = torch.softmax((x + g) / temperature, dim=axis)
    if not hard:
        return y
    one = (y == y.amax(axis, keepdim=True)).to(y.dtype)
    return one + y - y.detach()


def one_hot(x, num_classes, name=None):
    """f32 one-hot rows of the integer ``x``."""
    return TF.one_hot(x.long(), int(num_classes)).float()
