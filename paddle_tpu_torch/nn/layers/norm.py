"""Normalisation layers (counterpart of ``paddle_tpu/nn/layers/norm.py``):
``LayerNorm``, ``RMSNorm``, the batch norms (``SyncBatchNorm`` is batch
norm on one process, as in the reference), ``GroupNorm``, the instance
norms and ``LocalResponseNorm``; ``SpectralNorm`` raises as the
reference's does. Each builds on
``cuda`` unless ``device="cpu"`` (``core.resolve_device``: with no card
and no device named, construction raises)."""
from __future__ import annotations

import torch
from torch import nn

from ...amp import cast_for
from ...core import resolve_device
from ..functional.norm import (batch_norm, group_norm, instance_norm,
                               layer_norm, local_response_norm, rms_norm)
from ..layer import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class LayerNorm(Layer):
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


class RMSNorm(Layer):
    """RMSNorm over the last dim with a learned scale (initialised to 1)."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))
        self.epsilon = epsilon

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class _BatchNormBase(Layer):
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


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics would span every process. On one
    process it is ``BatchNorm``; with ``torch.distributed`` initialised
    over more than one rank it raises, as the reference does in eager
    multi-process execution, rather than normalise with local statistics
    (cross-process statistics are not implemented)."""

    def forward(self, x):
        dist = torch.distributed
        if (self.training and dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise NotImplementedError(
                "SyncBatchNorm: multi-process execution would compute LOCAL "
                "batch statistics; cross-process statistics are not "
                "implemented")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every batch norm under ``layer`` made a ``SyncBatchNorm`` in
        place (its parameters, buffers and settings kept)."""
        for sub in layer.children():
            if isinstance(sub, _BatchNormBase):
                sub.__class__ = cls
            else:
                cls.convert_sync_batchnorm(sub)
        return layer


class GroupNorm(Layer):
    """``F.group_norm`` over NC... inputs with a per-channel ``weight`` (1)
    and ``bias`` (0), each dropped by ``weight_attr`` / ``bias_attr``
    False."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(num_channels, **kw)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(num_channels, **kw)))

    def forward(self, x):
        return group_norm(x, self._num_groups, self._epsilon, self.weight,
                          self.bias)

    def extra_repr(self):
        return f"num_groups={self._num_groups}, epsilon={self._epsilon}"


class _InstanceNormBase(Layer):
    """``F.instance_norm`` with the reference's parameter names: ``scale``
    (1) and ``bias`` (0)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.scale = (None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **kw)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **kw)))

    def forward(self, x):
        return instance_norm(x, weight=self.scale, bias=self.bias,
                             eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return local_response_norm(x, self.size, self.alpha, self.beta,
                                   self.k)


class SpectralNorm(Layer):
    """Not implemented, as in the reference: constructing one raises."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        raise NotImplementedError(
            "SpectralNorm layer: use nn.utils.spectral_norm")
