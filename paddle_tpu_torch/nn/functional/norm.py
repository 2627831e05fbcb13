"""Normalisation functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``; ports ``rms_norm``, ``layer_norm``,
``batch_norm``, ``group_norm``, ``instance_norm`` and
``local_response_norm``)."""
from __future__ import annotations

import torch

from ...amp import cast_for
from ...kernels.layernorm import layernorm
from ...kernels.rmsnorm import rmsnorm

__all__ = ["layer_norm", "rms_norm", "batch_norm", "group_norm",
           "instance_norm", "local_response_norm"]


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1, name=None):
    """RMSNorm, the reference's: ``x * rsqrt(mean(x^2) + eps)`` over
    ``axis``, computed in f32 and cast to x's dtype, times ``weight``;
    differentiable in x and weight. The output's dtype is the reference's,
    x's and weight's promoted (a bf16 x with an f32 weight gives f32).

    On amp's black list: under ``amp.auto_cast`` bf16/f16 inputs are cast
    to f32 first. With a weight over the last dim it runs the RMSNorm
    kernels (forward, and backward under autograd) for CUDA tensors
    (always: the reference's TPU opt-in does not carry over) and their
    plain versions for CPU tensors, which take x and weight in one dtype:
    a narrower weight is cast to x's here, and a wider one multiplies the
    kernel's output normalised with a unit weight, as the reference rounds.
    Without a weight, or over another axis, it is the reference's
    composition."""
    x, weight = cast_for("rms_norm", x, weight)
    if weight is not None and axis in (-1, x.ndim - 1):
        dt = torch.promote_types(x.dtype, weight.dtype)
        if x.dtype == dt:
            return rmsnorm(x, weight.to(dt), epsilon)
        # a wider weight: the reference rounds normalize(x) to x's dtype
        # before the product, so the kernel normalises with a unit weight
        return rmsnorm(x, torch.ones_like(weight, dtype=x.dtype),
                       epsilon) * weight
    xf = x.float()
    ms = xf.square().mean(axis, keepdim=True)
    out = (xf / torch.sqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


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


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Paddle's functional batch norm: ``(x - mean) / sqrt(var + eps)``,
    then the affine, over the channel axis (1 for ``"NC..."`` formats, else
    the last). In training (and without ``use_global_stats``) the batch
    statistics (mean and biased variance) are used and the running ones are
    left as they are: the layer updates its buffers. On amp's black list:
    under ``auto_cast`` bf16/f16 inputs are cast to f32 first.

    The reference composes it from jnp ops; the port calls PyTorch's fused
    batch norm (cuDNN on the card) with the same arithmetic and its own
    backward, which is the gradient of that composition."""
    x, weight, bias = cast_for("batch_norm", x, weight, bias)
    channels_last = not data_format.startswith("NC")
    xc = x.movedim(-1, 1) if channels_last else x
    if training and not use_global_stats:
        running_mean = running_var = None
    out = torch.batch_norm(xc, weight, bias, running_mean, running_var,
                           running_mean is None, 0.0, epsilon,
                           torch.backends.cudnn.enabled)
    return out.movedim(1, -1) if channels_last else out


def _affine(out, weight, bias):
    """``out * weight + bias`` with the per-channel parameters along dim 1."""
    shape = [1, -1] + [1] * (out.ndim - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channels normalised over their spatial dims (the
    biased variance), then the per-channel affine: the reference's
    composition."""
    axes = tuple(range(2, x.ndim))
    mean = x.mean(axes, keepdim=True)
    var = (x - mean).square().mean(axes, keepdim=True)
    return _affine((x - mean) / torch.sqrt(var + eps), weight, bias)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Channels split into ``num_groups`` groups, each sample's group
    normalised over its channels and spatial dims, then the per-channel
    affine: the reference's composition (``data_format`` NC...)."""
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape(n, int(num_groups), c // int(num_groups), *x.shape[2:])
    axes = tuple(range(2, xg.ndim))
    mean = xg.mean(axes, keepdim=True)
    var = (xg - mean).square().mean(axes, keepdim=True)
    out = ((xg - mean) / torch.sqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * S / size) ** beta``, ``S`` the sum of ``x^2`` over
    a window of ``size`` channels, padded ``(size // 2, size - size // 2 -
    1)`` on the channel axis (axis 1, whatever ``data_format`` says, as in
    the reference)."""
    half = size // 2
    sq = x.square().movedim(1, -1)
    padded = torch.nn.functional.pad(sq, (half, size - half - 1)).movedim(
        -1, 1)
    c = x.shape[1]
    acc = sum(padded[:, i:i + c] for i in range(size))
    return x / (k + alpha * acc / size) ** beta
