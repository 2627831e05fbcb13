"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``): ``linear``, the dropouts,
``embedding``, ``pad``, ``normalize``, ``cosine_similarity``,
``interpolate`` / ``upsample``, the pixel and channel shuffles,
``unfold`` / ``fold``, ``bilinear`` and ``label_smooth``.

None of them is a Pallas kernel in the reference, so each is the
reference's formula in PyTorch. ``interpolate`` is the reference's
``jax.image.resize`` (ROADMAP R17), computed here from the same per-axis
resampling matrices: half-pixel centres, the output sized ``round(s *
f)``, ``align_corners`` and ``align_mode`` ignored, ``"area"`` taken as
linear and ``"bicubic"`` as Keys' cubic (a = -0.5), a kernel widened by
the scale when it downsamples (antialiasing), nearest picking
``floor((i + 0.5) * in / out)``, and channels-last layouts refused. The
pixel and channel shuffles, like the reference's, read NCHW whatever
``data_format`` says."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework.random import get_generator
from ...ops.manipulation import pad  # noqa: F401  (re-exported)

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "pad", "normalize", "cosine_similarity",
           "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "unfold", "fold", "bilinear", "label_smooth"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Paddle's dropout: in training each element (or, with ``axis``, each
    slice along those axes) is kept with probability ``1 - p``;
    ``upscale_in_train`` scales the kept ones by ``1 / (1 - p)``,
    ``downscale_in_infer`` leaves them and scales by ``1 - p`` at
    inference. The keep mask is drawn on x's device from ``generator``
    (default: ``framework.random``'s generator of that device); its bits
    differ from JAX's, so it agrees with the reference in distribution."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [a % x.ndim for a in (axis if isinstance(axis, (list, tuple))
                                     else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    g = generator if generator is not None else get_generator(x.device)
    keep = torch.rand(shape, device=x.device, generator=g) < (1.0 - p)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Whole channels of ``[N, C, H, W]`` (or NHWC) dropped together."""
    ch = 1 if data_format == "NCHW" else 3
    return dropout(x, p=p, axis=[0, ch], training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    """Whole channels of ``[N, C, D, H, W]`` (or NDHWC) dropped together."""
    ch = 1 if data_format == "NCDHW" else 4
    return dropout(x, p=p, axis=[0, ch], training=training,
                   generator=generator)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU's dropout: dropped elements take ``-alpha * scale``, then the
    affine ``a x + b`` that keeps zero mean and unit variance. The mask is
    drawn as ``dropout``'s."""
    if not training or p == 0.0:
        return x
    g = generator if generator is not None else get_generator(x.device)
    keep = torch.rand(x.shape, device=x.device, generator=g) < (1.0 - p)
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, alpha_p) + b).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` ``[vocab, dim]`` at the integer ids ``x``; ids
    equal to ``padding_idx`` give zero rows (the reference's)."""
    out = TF.embedding(x.long(), weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    nrm = x.abs().pow(p).sum(axis, keepdim=True).pow(1.0 / p)
    return x / nrm.clamp_min(epsilon)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``sum(x1 x2) / max(sqrt(sum(x1^2) sum(x2^2)), eps)`` along
    ``axis``."""
    num = (x1 * x2).sum(axis)
    den = torch.sqrt((x1 * x1).sum(axis) * (x2 * x2).sum(axis))
    return num / den.clamp_min(eps)


# ``interpolate``'s modes and jax.image.resize's kernels
_RESIZE_METHOD = {"nearest": "nearest", "bilinear": "linear",
                  "trilinear": "linear", "linear": "linear",
                  "area": "linear", "bicubic": "cubic"}


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(n_in, n_out, method):
    """``[n_in, n_out]`` resampling weights of one axis, in float64, as
    ``jax.image.resize`` builds them (``compute_weight_mat`` with
    translation 0 and its default antialias): output sample ``j`` sits at
    ``(j + 0.5) * n_in / n_out - 0.5``; the kernel (``"linear"``:
    triangle, ``"cubic"``: Keys) is widened by ``n_in / n_out`` when that
    exceeds 1; each column is normalised to sum 1 (or zeroed when its sum
    is below ``1000 * eps32``) and zeroed where the sample lies outside
    the input."""
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    inv = 1.0 / (n_out / n_in) if n_out else 1.0
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = kernel(x / max(inv, 1.0))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def nearest_indices(n_in, n_out):
    """jax's nearest source index of each output position:
    ``floor((j + 0.5) * n_in / n_out)``, each step in float32 as jax
    computes it."""
    pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(n_in) / np.float32(n_out)
    return np.floor(pos).astype(np.int64)


def _out_size(spatial, size, scale_factor):
    if size is not None:
        out = [int(s) for s in (size if isinstance(size, (list, tuple))
                                else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(spatial)
        out = [int(round(s * f)) for s, f in zip(spatial, sf)]
    if len(out) != len(spatial):
        raise ValueError(f"interpolate: size {out} for {len(spatial)} "
                         f"spatial dims")
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims of a channels-first ``x`` (``"NCW"`` /
    ``"NCL"``, ``"NCHW"``, ``"NCDHW"``) to ``size``, or to ``round(s *
    f)`` by ``scale_factor``, as the reference's ``jax.image.resize``
    does (module docstring, ROADMAP R17). Each resized axis is one
    contraction with :func:`resize_weights` (``"nearest"``: a gather at
    :func:`nearest_indices`); differentiable in ``x``."""
    if data_format not in ("NCHW", "NCDHW", "NCL", "NCW"):
        raise NotImplementedError(f"interpolate data_format {data_format}")
    method = _RESIZE_METHOD[mode]
    out = x
    for i, n_out in enumerate(_out_size(x.shape[2:], size, scale_factor)):
        d, n_in = 2 + i, x.shape[2 + i]
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = torch.from_numpy(nearest_indices(n_in, n_out))
            out = out.index_select(d, idx.to(out.device))
            continue
        w = torch.from_numpy(resize_weights(n_in, n_out, method)).to(
            out.device, out.dtype)
        out = torch.tensordot(out, w, dims=([d], [0])).movedim(-1, d)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    """``interpolate`` under Paddle's other name."""
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """``[N, C r^2, H, W]`` -> ``[N, C, H r, W r]``."""
    r = int(upscale_factor)
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """``[N, C, H r, W r]`` -> ``[N, C r^2, H, W]``."""
    r = int(downscale_factor)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """The channels of ``[N, C, H, W]`` read as ``[groups, C / groups]``
    and transposed (ShuffleNet's shuffle)."""
    g = int(groups)
    n, c, h, w = x.shape
    return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)


def _pair(v):
    return [int(a) for a in v] if isinstance(v, (list, tuple)) \
        else [int(v)] * 2


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of ``[N, C, H, W]``: ``[N, C kh kw, L]``, channel-major, each
    spatial dim padded by ``paddings`` on both sides."""
    return TF.unfold(x, _pair(kernel_sizes), _pair(dilations),
                     _pair(paddings)[:2], _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of ``unfold``: the blocks of ``[N, C kh kw, L]``
    summed into ``[N, C, *output_sizes]``."""
    return TF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   _pair(dilations), _pair(paddings)[:2], _pair(strides))


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] + bias[o]``, weight
    ``[out, in1, in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) label + epsilon prior`` (the uniform ``1 / K`` without
    ``prior_dist``)."""
    if prior_dist is None:
        return (1.0 - epsilon) * label + epsilon / label.shape[-1]
    return (1.0 - epsilon) * label + epsilon * prior_dist

