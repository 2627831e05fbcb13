"""Tensor creation ops (counterpart of ``paddle_tpu/ops/creation.py``).
Tensors made from no tensor input land where ``set_device`` says (default
the card) and take the default float dtype unless told otherwise; Python
ints make int64, as in the JAX package (which runs with x64 on)."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.device import resolve_device
from ..core.dispatch import apply
from ..core.tensor import Parameter, to_tensor, wrap
from .registry import register

__all__ = ["to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
           "full_like", "empty", "empty_like", "arange", "linspace",
           "logspace", "eye", "diag", "diagflat", "meshgrid", "tril", "triu",
           "assign", "clone", "create_parameter"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dt(dtype, default=None):
    return dtype_mod.convert_dtype(
        dtype if dtype is not None else default
        if default is not None else dtype_mod.get_default_dtype())


def _new(fn, *args, **kwargs):
    return wrap(fn(*args, device=resolve_device(None), **kwargs))


@register("zeros")
def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros, _shape(shape), dtype=_dt(dtype))


@register("ones")
def ones(shape, dtype=None, name=None):
    return _new(torch.ones, _shape(shape), dtype=_dt(dtype))


def _fill_dtype(fill_value, dtype):
    if dtype is not None:
        return _dt(dtype)
    if isinstance(fill_value, bool):
        return torch.bool
    if isinstance(fill_value, int):
        return torch.int64
    return _dt(None)


@register("full")
def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return _new(torch.full, _shape(shape), fill_value,
                dtype=_fill_dtype(fill_value, dtype))


@register("zeros_like")
def zeros_like(x, dtype=None, name=None):
    return wrap(torch.zeros_like(x, dtype=_dt(dtype, x.dtype)))


@register("ones_like")
def ones_like(x, dtype=None, name=None):
    return wrap(torch.ones_like(x, dtype=_dt(dtype, x.dtype)))


@register("full_like")
def full_like(x, fill_value, dtype=None, name=None):
    return wrap(torch.full_like(x, fill_value, dtype=_dt(dtype, x.dtype)))


@register("empty")
def empty(shape, dtype=None, name=None):
    """Zeros, as the JAX package's (whose arrays have no uninitialised
    state)."""
    return zeros(shape, dtype)


@register("empty_like")
def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@register("arange")
def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer))
                   for v in (start, end, step))
        dtype = "int64" if ints else dtype_mod.get_default_dtype()
    return _new(torch.arange, start, end, step, dtype=_dt(dtype))


@register("linspace")
def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace, float(_scalar(start)), float(_scalar(stop)),
                int(_scalar(num)), dtype=_dt(dtype))


@register("logspace")
def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace, float(_scalar(start)), float(_scalar(stop)),
                int(_scalar(num)), base=float(base), dtype=_dt(dtype))


@register("eye")
def eye(num_rows, num_columns=None, dtype=None, name=None):
    cols = int(num_rows) if num_columns is None else int(num_columns)
    return _new(torch.eye, int(num_rows), cols, dtype=_dt(dtype))


@register("diag")
def diag(x, offset=0, padding_value=0, name=None):
    def body(v):
        out = torch.diag(v, offset)
        if v.dim() == 1 and padding_value != 0:
            off = torch.diag(torch.ones_like(v, dtype=torch.bool), offset)
            out = torch.where(off, out, torch.full_like(out, padding_value))
        return out

    return apply(body, x, op_name="diag")


@register("diagflat")
def diagflat(x, offset=0, name=None):
    return apply(torch.diagflat, x, offset, op_name="diagflat")


@register("meshgrid")
def meshgrid(*args, **kwargs):
    kwargs.pop("name", None)
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(apply(lambda *v: torch.meshgrid(*v, indexing="ij"), *args,
                      op_name="meshgrid"))


@register("tril")
def tril(x, diagonal=0, name=None):
    return apply(torch.tril, x, diagonal, op_name="tril")


@register("triu")
def triu(x, diagonal=0, name=None):
    return apply(torch.triu, x, diagonal, op_name="triu")


@register("assign")
def assign(x, output=None):
    """A copy of ``x`` (kept in the graph), or ``x`` written into
    ``output``."""
    src = x if isinstance(x, torch.Tensor) else to_tensor(np.asarray(x))
    if output is None:
        return apply(torch.clone, src, op_name="assign")
    output.set_value(src)
    return output


@register("clone")
def clone(x, name=None):
    return apply(torch.clone, x, op_name="clone")


def create_parameter(shape, dtype=None, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A :class:`Parameter` of ``shape`` from ``default_initializer``
    (default: zeros for a bias, else ones, as the JAX package's)."""
    dt = _dt(dtype)
    shape = _shape(shape)
    if default_initializer is not None:
        data = default_initializer(shape, dt)
    else:
        data = (torch.zeros if is_bias else torch.ones)(
            shape, dtype=dt, device=resolve_device(None))
    return Parameter(data, dtype=dt, name=name)

