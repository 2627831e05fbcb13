"""Pooling functionals (counterpart of ``paddle_tpu/nn/functional/pooling.py``;
all twelve of its public functions).

The reference computes pooling with XLA's ``reduce_window``, in no Pallas
kernel of its own, so the port's counterpart is PyTorch's library pooling.
The reference's semantics are kept, not torch's:

- the padding is explicit: an int or one int per spatial dim (both sides),
  or ``"SAME"`` / ``"VALID"`` (any case; ``"SAME"`` is XLA's: output
  ``ceil(in / stride)``, the odd pixel of padding at the end);
- ``ceil_mode`` (numeric padding only) grows the right padding by
  ``stride - rem`` where ``rem = (in + pads - kernel) % stride`` is not 0,
  so a window that starts in that padding is kept (max ``-inf``, average
  0 or NaN), where torch's ``ceil_mode`` drops it;
- max pooling pads with ``-inf``; average pooling sums zeros there and
  divides by ``prod(kernel)`` when the padding is a string or
  ``exclusive=False``, otherwise by the count of real elements in the
  window, which torch's ``count_include_pad`` does not give at ceil-mode
  edges; ``divisor_override`` is ignored, as in the reference;
- ``return_mask`` gives each window's argmax (the first, in row-major
  window order) as a flat index into the unpadded input plane, clipped
  into it, with the padding at ``finfo.min`` instead of ``-inf``;
- adaptive pooling splits a dim into even bins by a reshape and into
  uneven ones ``[floor(i s / o), ceil((i + 1) s / o))``, always over the
  dims after the first two: ``data_format`` is accepted and ignored, as
  in the reference (ROADMAP Queue 3, R7).

So the port pads explicitly and calls torch's pooling without padding or
``ceil_mode``. None of these ops is on amp's lists: they run in their
input's dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d",
]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _same_pairs(spatial, k, s):
    """XLA's ``"SAME"``: output ``ceil(in / stride)``, the extra padding at
    the end."""
    pairs = []
    for size, kk, ss in zip(spatial, k, s):
        total = max((-(-size // ss) - 1) * ss + kk - size, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def _pad_pairs(spatial, k, s, padding, ceil_mode):
    """``[(before, after)]`` per spatial dim, and whether the padding was a
    string (the reference's ``reduce_window`` then ignores ``ceil_mode``
    and average pooling divides by ``prod(k)``)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * len(k), True
        if mode == "SAME":
            return _same_pairs(spatial, k, s), True
        raise ValueError(f"unknown pooling padding {padding!r}")
    pairs = []
    for size, kk, ss, p in zip(spatial, k, s, _tuple(padding, len(k))):
        lo = hi = p
        if ceil_mode:
            rem = (size + lo + hi - kk) % ss
            if rem:
                hi += ss - rem
        pairs.append((lo, hi))
    return pairs, False


def _flat_pad(pairs):
    """``F.pad``'s argument: the last dim first."""
    return [p for pair in reversed(pairs) for p in pair]


def _channels_first(x, channels_last):
    return x.movedim(-1, 1) if channels_last else x


def _pool_sum(x, k, s):
    """Window sums (no padding): torch's average pooling with divisor 1
    (1-D through the 2-D op, which has ``divisor_override``)."""
    if len(k) == 1:
        return TF.avg_pool2d(x.unsqueeze(-2), (1, k[0]), (1, s[0]),
                             divisor_override=1).squeeze(-2)
    pool = TF.avg_pool2d if len(k) == 2 else TF.avg_pool3d
    return pool(x, k, s, divisor_override=1)


def _max_pool(x, kernel, stride, padding, n, ceil_mode, channels_last):
    v = _channels_first(x, channels_last)
    k = _tuple(kernel, n)
    s = _tuple(stride if stride is not None else kernel, n)
    pairs, _ = _pad_pairs(v.shape[2:], k, s, padding, ceil_mode)
    vp = TF.pad(v, _flat_pad(pairs), value=-math.inf)
    out = _MAX[n](vp, k, s)
    return out.movedim(1, -1) if channels_last else out


def _max_pool_with_index(x, kernel, stride, padding, n, ceil_mode,
                         channels_last):
    """Max pooling and each window's argmax as a flat index into the
    unpadded input plane (the reference's ``max_pool*d_with_index``
    contract): torch's own indices into the padded plane, unravelled,
    shifted by the leading padding, clipped into the input and ravelled
    again. The reference pads with ``finfo.min`` here. Its gradient splits
    between tied maxima where torch's goes to the first; random inputs do
    not tie."""
    v = _channels_first(x, channels_last)
    spatial = v.shape[2:]
    k = _tuple(kernel, n)
    s = _tuple(stride if stride is not None else kernel, n)
    if isinstance(padding, str) and padding.upper() != "VALID":
        pairs = _same_pairs(spatial, k, s)     # any other string is SAME
    else:
        pairs, _ = _pad_pairs(spatial, k, s, padding, ceil_mode)
    vp = TF.pad(v, _flat_pad(pairs), value=torch.finfo(v.dtype).min)
    out, pidx = _MAX[n](vp, k, s, return_indices=True)
    padded = vp.shape[2:]
    idx = torch.zeros_like(pidx)
    rest = pidx
    for i in reversed(range(n)):
        coord = (rest % padded[i] - pairs[i][0]).clamp(0, spatial[i] - 1)
        rest = rest // padded[i]
        idx = idx + coord * math.prod(spatial[i + 1:])
    if channels_last:
        out, idx = out.movedim(1, -1), idx.movedim(1, -1)
    return out, idx


def _avg_pool(x, kernel, stride, padding, n, ceil_mode, exclusive,
              channels_last):
    v = _channels_first(x, channels_last)
    k = _tuple(kernel, n)
    s = _tuple(stride if stride is not None else kernel, n)
    pairs, by_string = _pad_pairs(v.shape[2:], k, s, padding, ceil_mode)
    flat = _flat_pad(pairs)
    total = _pool_sum(TF.pad(v, flat), k, s)
    if by_string or not exclusive:
        out = total / float(math.prod(k))
    else:
        ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                          device=v.device)
        out = total / _pool_sum(TF.pad(ones, flat), k, s)
    return out.movedim(1, -1) if channels_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    if return_mask:
        return _max_pool_with_index(x, kernel_size, stride, padding, 1,
                                    ceil_mode, False)
    return _max_pool(x, kernel_size, stride, padding, 1, ceil_mode, False)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_index(x, kernel_size, stride, padding, 2,
                                    ceil_mode, data_format == "NHWC")
    return _max_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     data_format == "NHWC")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_index(x, kernel_size, stride, padding, 3,
                                    ceil_mode, data_format == "NDHWC")
    return _max_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     data_format == "NDHWC")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1, ceil_mode,
                     exclusive, False)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     exclusive, data_format == "NHWC")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     exclusive, data_format == "NDHWC")


def _adaptive(x, output_size, n, op):
    """Bins over the dims after the first two, one dim at a time: an even
    split by a reshape, an uneven one by slices (floor / ceil edges)."""
    out = x
    for d, o in enumerate(_tuple(output_size, n)):
        ax = 2 + d
        s = out.shape[ax]
        if s % o == 0:
            shape = out.shape[:ax] + (o, s // o) + out.shape[ax + 1:]
            out = op(out.reshape(shape), ax + 1, False)
        else:
            out = torch.cat([op(out.narrow(ax, i * s // o,
                                           -(-(i + 1) * s // o) - i * s // o),
                                ax, True) for i in range(o)], dim=ax)
    return out


def _mean(v, dim, keepdim):
    return v.mean(dim, keepdim=keepdim)


def _amax(v, dim, keepdim):
    # amax's gradient splits between tied maxima, as jnp.max's does
    return v.amax(dim, keepdim=keepdim)


def _no_mask(name, return_mask):
    if return_mask:
        raise NotImplementedError(
            f"{name}(return_mask=True): window indices for variable-size "
            f"adaptive windows are not implemented (as in the reference); "
            f"use the max_pool functions' return_mask")


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, _mean)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, _mean)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, _mean)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_mask("adaptive_max_pool1d", return_mask)
    return _adaptive(x, output_size, 1, _amax)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _no_mask("adaptive_max_pool2d", return_mask)
    return _adaptive(x, output_size, 2, _amax)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_mask("adaptive_max_pool3d", return_mask)
    return _adaptive(x, output_size, 3, _amax)
