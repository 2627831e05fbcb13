"""Normalisation layers (counterpart of ``paddle_tpu/nn/layers/norm.py``;
ports ``LayerNorm``, ``RMSNorm`` and ``BatchNorm1D``). Each builds on
``cuda`` unless ``device="cpu"`` (``core.resolve_device``: with no card
and no device named, construction raises)."""
from __future__ import annotations

import torch
from torch import nn

from ...amp import cast_for
from ...core import resolve_device
from ..functional.norm import (batch_norm, batch_norm_stats, layer_norm,
                               rms_norm)

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm1D"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims, with a weight
    (initialised to 1) and a bias (0) unless ``weight_attr`` /
    ``bias_attr`` is False."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, **kw)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, **kw)))

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)

    def extra_repr(self):
        return f"{self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(nn.Module):
    """RMSNorm over the last dim with a learned scale (initialised to 1)."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))
        self.epsilon = epsilon

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class BatchNorm1D(nn.Module):
    """Paddle's batch norm over ``[N, C]`` or ``[N, C, L]`` (``"NCL"``: the
    channel axis 1; ``"NLC"``: the last), with Paddle's conventions, not
    ``torch.nn.BatchNorm1d``'s:

    - ``momentum`` (0.9) is the weight of the OLD running value:
      ``running = momentum * running + (1 - momentum) * batch``;
    - the running variance takes the biased batch variance;
    - the buffers are ``_mean`` (0) and ``_variance`` (1), the weight
      starts at 1 and the bias at 0.

    In training the batch statistics normalise and the gradients flow
    through them, as in the reference; in eval (or with
    ``use_global_stats``) the running ones do. On amp's black list: under
    ``auto_cast`` a bf16 input is cast to f32 first."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **kw)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **kw)))
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        (x,) = cast_for("batch_norm", x)
        if not (self.training and not self._use_global_stats):
            return batch_norm(x, self._mean, self._variance, self.weight,
                              self.bias, epsilon=self._epsilon,
                              data_format=self._data_format)
        ch_axis = 1 if self._data_format.startswith("NC") else x.ndim - 1
        mean, var = batch_norm_stats(x, ch_axis)
        out = batch_norm(x, mean, var, self.weight, self.bias,
                         epsilon=self._epsilon, data_format=self._data_format)
        m = self._momentum
        with torch.no_grad():
            self._mean.copy_(m * self._mean + (1 - m) * mean)
            self._variance.copy_(m * self._variance + (1 - m) * var)
        return out

    def extra_repr(self):
        return (f"{self._mean.shape[0]}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}, data_format={self._data_format}")
