"""The op library (counterpart of ``paddle_tpu/ops/__init__.py``): creation,
math, manipulation, linalg, logic, search, stat, random and fused ops, and
Paddle's method table on :class:`Tensor`.

``Tensor``'s arithmetic and comparison operators are torch's, their
results wrapped when a user's Tensor is an operand (``/`` of integers and
``~`` follow the JAX package there: float64 true division, logical not);
on Parameters and plain tensors alone they are torch's, with plain
results (the port's own arithmetic on its parameters). A method whose name
torch's ``Tensor`` also has takes torch's form where its arguments can
only be torch's (``transpose(0, 1)``, ``gather(1, index)``,
``reshape(2, 3)``, ``sum(1, True)``, ``flatten(start_dim=1)``,
``max(dim=1)``, ...); any other call takes Paddle's form: the op of the
same name.
"""
from __future__ import annotations

import builtins as _builtins

import torch

from ..core.tensor import Tensor, has_user_tensor, uncut, uncut_args, wrap
from . import (creation, fused, linalg, logic, manipulation, math, random,
               search, stat)
from .creation import *  # noqa: F401,F403
from .fused import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .registry import OPS, op_coverage  # noqa: F401
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403

__all__ = (creation.__all__ + math.__all__ + manipulation.__all__
           + logic.__all__ + search.__all__ + linalg.__all__ + random.__all__
           + stat.__all__ + fused.__all__)

_T = torch.Tensor


def _first_int(args, kwargs):
    return bool(args) and isinstance(args[0], int) and not isinstance(
        args[0], bool)


def _kw(*names):
    return lambda args, kwargs: _builtins.any(k in kwargs for k in names)


# torch's forms that Paddle's arguments cannot take
_TORCH_FORMS = {
    "transpose": lambda a, k: len(a) == 2 or "dim0" in k,
    "reshape": lambda a, k: len(a) > 1 or (len(a) == 1 and isinstance(
        a[0], int)),
    "expand": lambda a, k: len(a) > 1 or (len(a) == 1 and isinstance(
        a[0], int)),
    "tile": lambda a, k: len(a) > 1 or "dims" in k,
    "flip": lambda a, k: len(a) > 1 or "dims" in k,
    "view": lambda a, k: len(a) > 1 or (len(a) == 1 and isinstance(
        a[0], (int, torch.dtype))),
    "gather": lambda a, k: _first_int(a, k) or "dim" in k,
    "scatter": lambda a, k: _first_int(a, k) or "dim" in k or "src" in k,
    "index_select": lambda a, k: _first_int(a, k) or "dim" in k,
    "sum": lambda a, k: (len(a) > 1 and isinstance(a[1], bool))
    or "dim" in k,
    "flatten": _kw("start_dim", "end_dim"),
    "squeeze": _kw("dim"), "unsqueeze": _kw("dim"),
    "mean": _kw("dim"), "prod": _kw("dim"), "all": _kw("dim"),
    "any": _kw("dim"), "amax": _kw("dim"), "amin": _kw("dim"),
    "logsumexp": _kw("dim"), "cumsum": _kw("dim"), "std": _kw(
        "dim", "correction"), "var": _kw("dim", "correction"),
    "norm": _kw("dim", "dtype"), "argmax": _kw("dim"), "argmin": _kw("dim"),
    "argsort": _kw("dim", "stable"), "topk": _kw("dim"),
    "kthvalue": _kw("dim"), "mode": _kw("dim"), "roll": _kw("dims"),
    "unbind": _kw("dim"), "chunk": _kw("dim"),
    "repeat_interleave": _kw("dim", "output_size"),
    "add": _kw("alpha"), "subtract": _kw("alpha"),
    "divide": _kw("rounding_mode"), "round": _kw("decimals"),
    "cross": _kw("dim"), "cumprod": _kw("dtype"),
    "max": lambda a, k: "dim" in k or (bool(a) and isinstance(
        a[0], torch.Tensor)),
    "min": lambda a, k: "dim" in k or (bool(a) and isinstance(
        a[0], torch.Tensor)),
    "sort": _kw("dim", "stable"), "split": _kw("dim", "split_size"),
    "median": _kw("dim"), "unique": _kw("sorted", "dim"),
    "uniform_": _kw("from", "to", "generator"),
    "normal_": _kw("generator"), "exponential_": _kw("generator"),
    "bernoulli": _kw("generator", "p"),
    "multinomial": _kw("generator"),
}


def _method(name, paddle_fn):
    torch_fn = getattr(_T, name, None)
    if torch_fn is None:
        return paddle_fn
    torch_form = _TORCH_FORMS.get(name)

    def method(self, *args, **kwargs):
        if torch_form is not None and torch_form(args, kwargs):
            out = torch_fn(uncut(self), *uncut_args(args), **kwargs)
            if type(self) is Tensor or has_user_tensor(args, kwargs):
                return wrap(out)
            return out
        return paddle_fn(uncut(self), *args, **kwargs)

    method.__name__ = name
    method.__doc__ = paddle_fn.__doc__
    return method


def _binary(torch_fn):
    def op(self, other):
        if type(self) is Tensor or type(other) is Tensor:
            return wrap(torch_fn(uncut(self), uncut(other)))
        return torch_fn(self, other)    # Parameters and plain tensors

    return op


def _patch_tensor_methods():
    m = math
    for dunder in ("add", "radd", "sub", "rsub", "mul", "rmul", "floordiv",
                   "rfloordiv", "mod", "rmod", "pow", "rpow", "matmul",
                   "rmatmul", "eq", "ne", "lt", "le", "gt", "ge", "and",
                   "or", "xor"):
        name = f"__{dunder}__"
        setattr(Tensor, name, _binary(getattr(_T, name)))

    def truediv(s, o):
        if type(s) is Tensor or type(o) is Tensor:
            return m.divide(s, o)
        return _T.__truediv__(s, o)

    def rtruediv(s, o):
        if type(s) is Tensor or type(o) is Tensor:
            return m.divide(o, s)
        return _T.__rtruediv__(s, o)

    Tensor.__truediv__, Tensor.__rtruediv__ = truediv, rtruediv
    Tensor.__neg__ = lambda s: wrap(_T.__neg__(uncut(s)))
    Tensor.__abs__ = lambda s: wrap(_T.__abs__(uncut(s)))
    Tensor.__invert__ = lambda s: logic.logical_not(s)
    Tensor.__hash__ = _T.__hash__

    mp, sr = manipulation, search
    methods = {
        "add": m.add, "subtract": m.subtract, "multiply": m.multiply,
        "divide": m.divide, "floor_divide": m.floor_divide,
        "remainder": m.remainder, "mod": m.remainder, "pow": m.pow,
        "maximum": m.maximum, "minimum": m.minimum, "exp": m.exp,
        "log": m.log, "log2": m.log2, "log10": m.log10, "log1p": m.log1p,
        "sqrt": m.sqrt, "rsqrt": m.rsqrt, "square": m.square, "abs": m.abs,
        "sign": m.sign, "sin": m.sin, "cos": m.cos, "tan": m.tan,
        "tanh": m.tanh, "asin": m.asin, "acos": m.acos, "atan": m.atan,
        "sinh": m.sinh, "cosh": m.cosh, "floor": m.floor, "ceil": m.ceil,
        "round": m.round, "trunc": m.trunc, "reciprocal": m.reciprocal,
        "erf": m.erf, "clip": m.clip, "lerp": m.lerp, "neg": m.neg,
        "isnan": m.isnan, "isinf": m.isinf, "isfinite": m.isfinite,
        "sum": m.sum, "mean": m.mean, "max": m.max, "min": m.min,
        "prod": m.prod, "all": m.all, "any": m.any, "amax": m.amax,
        "amin": m.amin, "logsumexp": m.logsumexp, "cumsum": m.cumsum,
        "cumprod": m.cumprod, "trace": m.trace, "kron": m.kron,
        "inner": m.inner, "outer": m.outer, "scale": m.scale,
        "nan_to_num": m.nan_to_num, "std": stat.std, "var": stat.var,
        "reshape": mp.reshape, "transpose": mp.transpose,
        "flatten": mp.flatten, "squeeze": mp.squeeze,
        "unsqueeze": mp.unsqueeze, "split": mp.split, "chunk": mp.chunk,
        "gather": mp.gather, "gather_nd": mp.gather_nd,
        "scatter": mp.scatter, "index_select": mp.index_select,
        "masked_select": mp.masked_select, "tile": mp.tile,
        "expand": mp.expand, "expand_as": mp.expand_as,
        "broadcast_to": mp.broadcast_to, "flip": mp.flip, "roll": mp.roll,
        "unbind": mp.unbind, "take_along_axis": mp.take_along_axis,
        "put_along_axis": mp.put_along_axis,
        "repeat_interleave": mp.repeat_interleave, "view": mp.view,
        "tril": creation.tril, "triu": creation.triu,
        "matmul": linalg.matmul, "dot": linalg.dot, "bmm": linalg.bmm,
        "mm": linalg.mm, "mv": linalg.mv, "t": linalg.t,
        "norm": linalg.norm, "dist": linalg.dist,
        "cholesky": linalg.cholesky, "inv": linalg.inv,
        "cross": linalg.cross, "equal": logic.equal,
        "not_equal": logic.not_equal, "greater_than": logic.greater_than,
        "greater_equal": logic.greater_equal, "less_than": logic.less_than,
        "less_equal": logic.less_equal, "logical_and": logic.logical_and,
        "logical_or": logic.logical_or, "logical_not": logic.logical_not,
        "logical_xor": logic.logical_xor, "isclose": logic.isclose,
        "allclose": logic.allclose, "equal_all": logic.equal_all,
        "argmax": sr.argmax, "argmin": sr.argmin, "argsort": sr.argsort,
        "sort": sr.sort, "topk": sr.topk, "where": sr.where,
        "nonzero": sr.nonzero, "unique": sr.unique, "median": sr.median,
        "kthvalue": sr.kthvalue, "mode": sr.mode,
        "uniform_": random.uniform_, "normal_": random.normal_,
        "exponential_": random.exponential_, "bernoulli": random.bernoulli,
        "multinomial": random.multinomial,
    }
    for name, fn in methods.items():
        setattr(Tensor, name, _method(name, fn))


_patch_tensor_methods()
