"""Statistics ops (counterpart of ``paddle_tpu/ops/stat.py``); ``numel``,
``shape`` and ``rank`` give int64 tensors."""
from __future__ import annotations

import torch

from ..core.dispatch import apply
from ..core.tensor import wrap
from .math import norm_axis
from .registry import register

__all__ = ["std", "var", "numel", "shape", "rank"]

_reg = register(category="stat")


@_reg
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(lambda v: torch.std(v, norm_axis(axis, v.dim()),
                                     correction=int(unbiased),
                                     keepdim=keepdim), x, op_name="std")


@_reg
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(lambda v: torch.var(v, norm_axis(axis, v.dim()),
                                     correction=int(unbiased),
                                     keepdim=keepdim), x, op_name="var")


def _int64(value, like):
    return wrap(torch.tensor(value, dtype=torch.int64, device=like.device))


@_reg
def numel(x, name=None):
    return _int64(torch.Tensor.numel(x), x)


@_reg
def shape(x):
    return _int64(list(torch.Tensor.size(x)), x)


@_reg
def rank(x):
    return _int64(torch.Tensor.dim(x), x)
