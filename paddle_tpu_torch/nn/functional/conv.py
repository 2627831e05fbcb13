"""Convolution functionals (counterpart of
``paddle_tpu/nn/functional/conv.py``): ``conv1d``, ``conv2d``,
``conv3d`` and their transposes.

The reference computes convolutions with XLA's ``conv_general_dilated``,
in no Pallas kernel of its own, so the port's counterpart is PyTorch's
library convolution, as ``torch.matmul`` is for the projections. Paddle's
semantics are kept: weights ``[out, in / groups, *k]``; ``padding`` an int,
one int per spatial dim, a ``[before, after]`` pair per spatial dim (flat
or nested), Paddle's nested pair per dim of ``x`` (batch and channel pairs
zeros, placed by ``data_format``), or ``"SAME"`` / ``"VALID"``; ``data_format`` channels first
(``"NCL"``, ``"NCHW"``) or last (``"NLC"``, ``"NHWC"``). Convolutions are
on amp's white list: under ``auto_cast`` they compute in the amp dtype.

The transposes keep the reference's arithmetic, which is not Paddle's
(ROADMAP R16): ``lax.conv_general_dilated`` over the stride-dilated input
with the ``[in, out / groups, *k]`` weight NOT flipped, padded
``dilation * (k - 1) - padding`` before and that plus ``output_padding``
after (XLA's own pads for ``"SAME"`` / ``"VALID"``, which it takes at
stride 1 only), and ``output_size`` ignored. That is PyTorch's
``conv_transpose*d`` with the spatially flipped weight: the port runs it
unpadded and pads or crops the result to the reference's window, then
adds the bias. Under ``auto_cast`` they follow ``torch.autocast``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp import cast_for

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CHANNELS_LAST = ("NLC", "NWC", "NHWC", "NDHWC")


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _pad_pairs(padding, n, data_format):
    """``[(before, after)] * n`` from Paddle's int / per-dim / flat-pair
    forms, or from its nested form of one pair per dimension of ``x``:
    ``n + 2`` pairs, batch and channel included (``[[0, 0], [0, 0], [t, b],
    [l, r]]`` for NCHW, ``[[0, 0], [t, b], [l, r], [0, 0]]`` for NHWC),
    whose batch and channel pairs must be zeros, as Paddle requires; ``n``
    nested pairs are taken as the spatial ones."""
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    pairs = [tuple(int(q) for q in p) for p in padding]
    if len(pairs) == n + 2:
        if data_format in _CHANNELS_LAST:
            spatial, other = pairs[1:-1], (pairs[0], pairs[-1])
        else:
            spatial, other = pairs[2:], pairs[:2]
        if any(p != (0, 0) for p in other):
            raise ValueError(
                f"conv{n}d: the batch and channel pairs of padding "
                f"{padding} must be [0, 0] (data_format {data_format})")
        pairs = spatial
    if len(pairs) != n or any(len(p) != 2 for p in pairs):
        raise ValueError(f"conv{n}d: padding {padding} is not an int, {n} "
                         f"ints, {2 * n} ints or {n} or {n + 2} pairs")
    return pairs


def _same_pairs(x, weight, stride, dilation, n):
    """XLA's ``"SAME"``: output ``ceil(in / stride)``, the extra padding at
    the end."""
    pairs = []
    for i in range(n):
        size, k = x.shape[2 + i], weight.shape[2 + i]
        eff = (k - 1) * dilation[i] + 1
        out = -(-size // stride[i])
        total = max((out - 1) * stride[i] + eff - size, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    x, weight, bias = cast_for(f"conv{n}d", x, weight, bias)
    channels_last = data_format in _CHANNELS_LAST
    if channels_last:
        x = x.movedim(-1, 1)
    st, dl = _tuple(stride, n), _tuple(dilation, n)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pairs = [(0, 0)] * n
        elif padding.upper() == "SAME":
            pairs = _same_pairs(x, weight, st, dl, n)
        else:
            raise ValueError(f"conv{n}d: unknown padding {padding!r}")
    else:
        pairs = _pad_pairs(padding, n, data_format)
    if all(a == b for a, b in pairs):
        pad = tuple(a for a, _ in pairs)
    else:   # asymmetric: pad explicitly (F.pad takes the last dim first)
        x = TF.pad(x, [p for pair in reversed(pairs) for p in pair])
        pad = 0
    conv = (TF.conv1d, TF.conv2d, TF.conv3d)[n - 1]
    out = conv(x, weight, bias, st, pad, dl, groups)
    return out.movedim(1, -1) if channels_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution of ``x`` ``[N, C, L]`` (or ``[N, L, C]``) with
    ``weight`` ``[out, C / groups, k]``."""
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of ``x`` ``[N, C, H, W]`` (or ``[N, H, W, C]``) with
    ``weight`` ``[out, C / groups, kh, kw]``."""
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3-D convolution of ``x`` ``[N, C, D, H, W]`` (or ``[N, D, H, W,
    C]``) with ``weight`` ``[out, C / groups, kd, kh, kw]``."""
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format):
    channels_last = data_format in _CHANNELS_LAST
    if channels_last:
        x = x.movedim(-1, 1)
    st, dl = _tuple(stride, n), _tuple(dilation, n)
    op = _tuple(output_padding, n) if output_padding else (0,) * n
    full = [dl[i] * (weight.shape[2 + i] - 1) for i in range(n)]
    if isinstance(padding, str):        # XLA's pads of the undilated input
        if any(s != 1 for s in st):
            raise ValueError(f"conv{n}d_transpose: padding {padding!r} "
                             f"with stride {st}: the reference's XLA "
                             f"convolution takes string padding at stride "
                             f"1 only")
        if padding.upper() == "VALID":
            pads = [(0, 0)] * n
        elif padding.upper() == "SAME":
            pads = [(e // 2, e - e // 2) for e in full]
        else:
            raise ValueError(f"conv{n}d_transpose: unknown padding "
                             f"{padding!r}")
    else:
        pads = [(e - a, e - b + o) for e, (a, b), o in
                zip(full, _pad_pairs(padding, n, data_format), op)]
    conv_t = (TF.conv_transpose1d, TF.conv_transpose2d,
              TF.conv_transpose3d)[n - 1]
    out = conv_t(x, weight.flip(list(range(2, 2 + n))), None, st, 0, 0,
                 groups, dl)
    # the unpadded transpose pads full[i] a side; pad or crop to pads[i]
    out = TF.pad(out, [p - e for (lo, hi), e in zip(reversed(pads),
                                                    reversed(full))
                       for p in (lo, hi)])
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * n)
    return out.movedim(1, -1) if channels_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """The reference's 1-D transposed convolution of ``x`` ``[N, C, L]``
    with ``weight`` ``[C, out / groups, k]`` (module docstring: no flip,
    ``output_size`` ignored)."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """The reference's 2-D transposed convolution of ``x`` ``[N, C, H, W]``
    with ``weight`` ``[C, out / groups, kh, kw]`` (module docstring)."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """The reference's 3-D transposed convolution of ``x`` ``[N, C, D, H,
    W]`` with ``weight`` ``[C, out / groups, kd, kh, kw]`` (module
    docstring)."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format)
