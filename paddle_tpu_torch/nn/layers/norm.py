"""Normalisation layers (counterpart of ``paddle_tpu/nn/layers/norm.py``;
ports ``LayerNorm``, ``RMSNorm``, ``BatchNorm``, ``BatchNorm1D``,
``BatchNorm2D`` and ``BatchNorm3D``). Each builds on
``cuda`` unless ``device="cpu"`` (``core.resolve_device``: with no card
and no device named, construction raises)."""
from __future__ import annotations

import torch
from torch import nn

from ...amp import cast_for
from ...core import resolve_device
from ..functional.norm import batch_norm, layer_norm, rms_norm

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


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


class _BatchNormBase(nn.Module):
    """Paddle's batch norm over the channel axis (1 for ``"NC..."`` formats,
    else the last), with Paddle's conventions, not ``torch.nn``'s:

    - ``momentum`` (0.9) is the weight of the OLD running value:
      ``running = momentum * running + (1 - momentum) * batch``;
    - the running variance takes the biased batch variance;
    - the buffers are ``_mean`` (0) and ``_variance`` (1), the weight
      starts at 1 and the bias at 0.

    In training the batch statistics normalise and the gradients flow
    through them, as in the reference; in eval (or with
    ``use_global_stats``) the running ones do. On amp's black list: under
    ``auto_cast`` a bf16 input is cast to f32 first, and the statistics are
    taken in f32 (ROADMAP Queue 3, R8).

    PyTorch's fused batch norm (``torch.batch_norm``) normalises. Given
    running buffers in training it would write the UNBIASED variance into
    them, so it writes into scratch ones at momentum 1 (the batch's mean
    and unbiased variance, read in the same pass), and the layer rescales
    the variance to the biased one and blends both into its own
    buffers."""

    _default_format = "NCHW"

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format=None,
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format or self._default_format
        self._use_global_stats = use_global_stats
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **kw)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **kw)))
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        if not self.training or self._use_global_stats:
            return batch_norm(x, self._mean, self._variance, self.weight,
                              self.bias, epsilon=self._epsilon,
                              data_format=self._data_format)
        x, weight, bias = cast_for("batch_norm", x, self.weight, self.bias)
        mean = torch.zeros_like(self._mean, dtype=x.dtype)
        var = torch.zeros_like(mean)
        channels_last = not self._data_format.startswith("NC")
        xc = x.movedim(-1, 1) if channels_last else x
        out = torch.batch_norm(xc, weight, bias, mean, var, True, 1.0,
                               self._epsilon, torch.backends.cudnn.enabled)
        n = xc.numel() // xc.shape[1]
        m = self._momentum
        with torch.no_grad():
            var = var * ((n - 1) / n) if n > 1 else torch.zeros_like(var)
            self._mean.copy_(m * self._mean + (1 - m) * mean)
            self._variance.copy_(m * self._variance + (1 - m) * var)
        return out.movedim(1, -1) if channels_last else out

    def extra_repr(self):
        return (f"{self._mean.shape[0]}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}, data_format={self._data_format}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    """Over ``[N, C]`` or ``[N, C, L]`` (``"NCL"``) or ``[N, L, C]``
    (``"NLC"``)."""

    _default_format = "NCL"


class BatchNorm2D(_BatchNormBase):
    """Over ``[N, C, H, W]`` (``"NCHW"``) or ``[N, H, W, C]`` (``"NHWC"``)."""


class BatchNorm3D(_BatchNormBase):
    _default_format = "NCDHW"
