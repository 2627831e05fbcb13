"""Normalisation functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``; ports ``rms_norm`` and
``layer_norm``)."""
from __future__ import annotations

import torch

from ...amp import cast_for
from ...kernels.layernorm import layernorm
from ...kernels.rmsnorm import rmsnorm

__all__ = ["layer_norm", "rms_norm"]


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim: ``x * rsqrt(mean(x^2) + eps) * weight``,
    computed in f32 and cast to x's dtype; differentiable in x and weight.
    Runs the RMSNorm kernels (forward, and backward under autograd) for
    CUDA tensors (always: the reference's TPU opt-in does not carry over)
    and their plain versions for CPU tensors."""
    return rmsnorm(x, weight, epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Paddle's ``layer_norm`` over the trailing ``normalized_shape`` dims.

    On amp's black list: under ``amp.auto_cast`` bf16/f16 inputs are cast
    to f32 first. Over the last dim with both ``weight`` and ``bias`` (the
    transformer's case) it runs the LayerNorm kernel for CUDA tensors and
    its plain version for CPU tensors, on every device, where the
    reference picks its Pallas kernel on the TPU only; other cases are the
    reference's composition, in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(tuple(normalized_shape))
    x, weight, bias = cast_for("layer_norm", x, weight, bias)
    if n_axes == 1 and weight is not None and bias is not None:
        return layernorm(x, weight, bias, epsilon)
    axes = tuple(range(x.ndim - n_axes, x.ndim))
    mean = x.mean(axes, keepdim=True)
    var = (x - mean).square().mean(axes, keepdim=True)
    out = (x - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
