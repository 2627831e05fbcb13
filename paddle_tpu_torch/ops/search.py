"""Search and sort ops (counterpart of ``paddle_tpu/ops/search.py``):
``sort`` returns the values only, ``median`` averages the two middle
values of an even count, ``nonzero(as_tuple=True)`` gives ``[N, 1]``
columns; ``unique``, ``unique_consecutive``, ``mode`` and ``histogram``
have data-dependent shapes and run on the host, as in the JAX package."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.dtype import convert_dtype
from ..core.tensor import wrap
from .registry import register

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "where", "nonzero",
    "index_sample", "searchsorted", "unique", "unique_consecutive", "mode",
    "kthvalue", "median", "quantile", "bucketize", "histogram",
]

_reg = register(category="search")


def _host(arr, like):
    return wrap(torch.as_tensor(np.ascontiguousarray(arr), device=like.device))


def _np(x):
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def _arg(fn, x, axis, keepdim, dtype, op_name):
    nd = convert_dtype(dtype)
    return apply(lambda v: (fn(v.reshape(-1)) if axis is None
                            else fn(v, int(axis), keepdim)).to(nd), x,
                 op_name=op_name)


@_reg
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype, "argmax")


@_reg
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype, "argmin")


@_reg
def argsort(x, axis=-1, descending=False, name=None):
    return apply(lambda v: torch.sort(v, dim=int(axis), descending=descending,
                                      stable=True).indices, x,
                 op_name="argsort")


@_reg
def sort(x, axis=-1, descending=False, name=None):
    return apply(lambda v: torch.sort(v, dim=int(axis), descending=descending,
                                      stable=True).values, x, op_name="sort")


@_reg
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    kk = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    return apply(lambda v: tuple(torch.topk(v, kk, int(axis), largest,
                                            sorted)), x, op_name="topk")


@_reg
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)

    def body(c, a, b):
        like = c if not isinstance(a, torch.Tensor) else a
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            a, device=like.device)
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(
            b, device=like.device)
        return torch.where(c.bool(), a, b)

    return apply(body, condition, x, y, op_name="where")


@_reg
def nonzero(x, as_tuple=False):
    nz = torch.nonzero(x)
    if as_tuple:
        return tuple(wrap(nz[:, i:i + 1]) for i in range(nz.shape[1]))
    return wrap(nz)


@_reg
def index_sample(x, index):
    return apply(lambda v, i: torch.take_along_dim(v, i.long(), 1), x, index,
                 op_name="index_sample")


@_reg
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply(lambda s, v: torch.searchsorted(s, v, out_int32=out_int32,
                                                 right=right),
                 sorted_sequence, values, op_name="searchsorted")


@_reg
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


@_reg
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    res = np.unique(_np(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _host(res, x)
    return tuple(_host(r, x) for r in res)


@_reg
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    arr = _np(x)
    if axis is None:
        arr = arr.reshape(-1)
    keep = np.ones(arr.shape[0], bool)
    keep[1:] = np.any(arr[1:] != arr[:-1], axis=tuple(range(1, arr.ndim))) \
        if arr.ndim > 1 else arr[1:] != arr[:-1]
    rets = [_host(arr[keep], x)]
    if return_inverse:
        rets.append(_host((np.cumsum(keep) - 1).astype(np.int64), x))
    if return_counts:
        idx = np.flatnonzero(keep)
        rets.append(_host(np.diff(np.append(idx, arr.shape[0]))
                          .astype(np.int64), x))
    return rets[0] if len(rets) == 1 else tuple(rets)


@_reg
def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the largest on a tie) and
    the last index where it occurs."""
    arr = _np(x)
    ax = int(axis) % arr.ndim
    moved = np.moveaxis(arr, ax, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(flat.shape[0], arr.dtype)
    idxs = np.empty(flat.shape[0], np.int64)
    for i, row in enumerate(flat):
        uniq, counts = np.unique(row, return_counts=True)
        v = uniq[np.argmax(counts)]
        vals[i] = v
        idxs[i] = np.where(row == v)[0][-1]
    vals, idxs = vals.reshape(moved.shape[:-1]), idxs.reshape(
        moved.shape[:-1])
    if keepdim:
        vals, idxs = np.expand_dims(vals, ax), np.expand_dims(idxs, ax)
    return _host(vals, x).to(x.dtype), _host(idxs, x)


@_reg
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return apply(lambda v: tuple(torch.kthvalue(v, int(k), int(axis),
                                                keepdim)), x,
                 op_name="kthvalue")


@_reg
def median(x, axis=None, keepdim=False, mode="avg", name=None):
    def body(v):
        if axis is None:
            out = torch.quantile(v.reshape(-1), 0.5)
            return out.reshape([1] * v.dim()) if keepdim else out
        return torch.quantile(v, 0.5, int(axis), keepdim)

    return apply(body, x, op_name="median")


@_reg
def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    def body(v):
        qq = torch.as_tensor(q, dtype=v.dtype, device=v.device)
        if axis is None:
            out = torch.quantile(v.reshape(-1), qq,
                                 interpolation=interpolation)
            return out.reshape(*qq.shape, *[1] * v.dim()) if keepdim else out
        return torch.quantile(v, qq, int(axis), keepdim,
                              interpolation=interpolation)

    return apply(body, x, op_name="quantile")


@_reg
def histogram(x, bins=100, min=0, max=0, name=None):
    arr = _np(x)
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = float(arr.min()), float(arr.max())
    hist, _ = np.histogram(arr, bins=int(bins), range=(lo, hi))
    return _host(hist.astype(np.int64), x)
