"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

Fans follow the reference's ``_compute_fans``: ``fan_in = shape[1] *
receptive field``, ``fan_out = shape[0] * receptive field`` (what Paddle
applies to Linear's ``[in, out]`` and Conv's ``[out, in, *k]`` alike).
Each draw comes from an explicit ``torch.Generator``: the one given to
the initializer, else ``framework.random``'s generator of the target's
device, so one ``paddle.seed(n)`` repeats it. They agree with the JAX
package's in distribution, not in bits.

An initializer called with a shape returns a new Tensor
(``init(shape, dtype, device=None)``); called with a tensor it fills it
in place and returns it (Paddle's ``init(param)``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.tensor import wrap
from ..framework.random import get_generator

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac",
           "calculate_gain"]


def _compute_fans(shape):
    if len(shape) < 2:
        f = shape[0] if shape else 1
        return f, f
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(
                 2.0 / (1 + (param if param is not None else 0.01) ** 2)),
             "selu": 3.0 / 4.0}
    return gains[nonlinearity]


class Initializer:
    def __init__(self, generator=None):
        self.generator = generator

    def _fill(self, t: torch.Tensor, g: torch.Generator) -> None:
        raise NotImplementedError

    def __call__(self, shape_or_tensor, dtype=None, device=None):
        if isinstance(shape_or_tensor, torch.Tensor):
            t = shape_or_tensor
        else:
            t = torch.empty(tuple(int(s) for s in shape_or_tensor),
                            dtype=convert_dtype(dtype or "float32"),
                            device=resolve_device(device))
        g = self.generator or get_generator(t.device)
        with torch.no_grad():
            self._fill(t, g)
        return t if isinstance(shape_or_tensor, torch.Tensor) else wrap(t)


class Constant(Initializer):
    def __init__(self, value=0.0, generator=None):
        super().__init__(generator)
        self.value = value

    def _fill(self, t, g):
        t.fill_(self.value)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, generator=None):
        super().__init__(generator)
        self.low, self.high = low, high

    def _fill(self, t, g):
        t.uniform_(self.low, self.high, generator=g)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, generator=None):
        super().__init__(generator)
        self.mean, self.std = mean, std

    def _fill(self, t, g):
        t.normal_(self.mean, self.std, generator=g)


class TruncatedNormal(Initializer):
    """``mean + std * z``, ``z`` a standard normal truncated to [a, b]."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
        super().__init__(generator)
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _fill(self, t, g):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, self.a, self.b, generator=g)
        t.mul_(self.std).add_(self.mean)


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, generator=None):
        super().__init__(generator)
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, t):
        fi, fo = _compute_fans(tuple(t.shape))
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)


class XavierUniform(_Xavier):
    def _fill(self, t, g):
        fi, fo = self._fans(t)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        t.uniform_(-limit, limit, generator=g)


class XavierNormal(_Xavier):
    def _fill(self, t, g):
        fi, fo = self._fans(t)
        t.normal_(0.0, self.gain * math.sqrt(2.0 / (fi + fo)), generator=g)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu", generator=None):
        super().__init__(generator)
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _scale(self, t):
        fi = self.fan_in if self.fan_in is not None else \
            _compute_fans(tuple(t.shape))[0]
        return calculate_gain(self.nonlinearity, self.negative_slope), fi


class KaimingUniform(_Kaiming):
    def _fill(self, t, g):
        gain, fi = self._scale(t)
        limit = gain * math.sqrt(3.0 / fi)
        t.uniform_(-limit, limit, generator=g)


class KaimingNormal(_Kaiming):
    def _fill(self, t, g):
        gain, fi = self._scale(t)
        t.normal_(0.0, gain / math.sqrt(fi), generator=g)


class Assign(Initializer):
    def __init__(self, value, generator=None):
        super().__init__(generator)
        self.value = value

    def _fill(self, t, g):
        v = self.value
        v = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        t.copy_(v.reshape(t.shape))


class Orthogonal(Initializer):
    """Rows (or columns) of a QR factor of a normal draw, signs fixed by
    R's diagonal, times ``gain``."""

    def __init__(self, gain=1.0, generator=None):
        super().__init__(generator)
        self.gain = gain

    def _fill(self, t, g):
        rows = t.shape[0]
        cols = int(np.prod(t.shape[1:]))
        flat = torch.randn(max(rows, cols), min(rows, cols), generator=g,
                           device=t.device, dtype=torch.float32)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        t.copy_((self.gain * q[:rows, :cols]).reshape(t.shape))


class Dirac(Initializer):
    """Identity convolution kernels: 1 at each kernel's centre for channel
    ``i`` of group ``g``'s ``i``-th output."""

    def __init__(self, groups=1, generator=None):
        super().__init__(generator)
        self.groups = groups

    def _fill(self, t, g):
        t.zero_()
        out_c, in_c = t.shape[0], t.shape[1]
        per = out_c // self.groups
        centers = tuple(s // 2 for s in t.shape[2:])
        for gi in range(self.groups):
            for i in range(min(per, in_c)):
                t[(gi * per + i, i) + centers] = 1.0
