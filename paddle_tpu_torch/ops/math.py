"""Elementwise math, reductions and scans (counterpart of
``paddle_tpu/ops/math.py``), with the JAX package's semantics: integer
``floor_divide`` and ``remainder`` take Python's signs, ``divide`` of two
integer tensors is a float64 true division (x64), reductions take ``axis``
as an int, a list or None, ``max`` / ``min`` return the values only."""
from __future__ import annotations

import builtins

import torch

from ..core.dispatch import apply
from ..core.dtype import convert_dtype
from .registry import OPS, OpDef, defop

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "float_power", "maximum", "minimum", "fmax", "fmin",
    "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "square", "abs", "sign", "sin", "cos", "tan", "asin", "acos", "atan",
    "atan2", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    "floor", "ceil", "round", "trunc", "frac", "reciprocal", "neg",
    "negative", "erf", "erfinv", "lgamma", "digamma", "clip", "lerp",
    "logit", "sum", "mean", "max", "min", "amax", "amin", "prod", "all",
    "any", "logsumexp", "cumsum", "cumprod", "cummax", "cummin", "nansum",
    "nanmean", "isnan", "isinf", "isfinite", "nan_to_num",
    "add_n", "scale", "stanh", "multiplex", "inner", "outer",
    "heaviside", "rad2deg", "deg2rad", "gcd", "lcm", "diff", "angle",
    "count_nonzero", "kron", "trace", "log_normal",
]


def as_tensor_like(v, like):
    """A Python number (or array) as a tensor on ``like``'s device, for
    the torch functions that take no number in that position."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=like.device)


def _binary(name, fn):
    def body(x, y):
        if not isinstance(x, torch.Tensor):
            x = as_tensor_like(x, y)
        return fn(x, y)

    return defop(name)(body)


def _true_divide(x, y):
    if not isinstance(y, torch.Tensor):
        y = as_tensor_like(y, x)
    if not (x.is_floating_point() or x.is_complex()
            or y.is_floating_point() or y.is_complex()):
        x, y = x.double(), y.double()
    return torch.true_divide(x, y)


def _tensor_second(fn):
    def body(x, y):
        return fn(x, as_tensor_like(y, x).to(x.dtype)
                  if not isinstance(y, torch.Tensor) else y)

    return body


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", _true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
mod = remainder
pow = _binary("pow", torch.pow)
float_power = _binary("float_power", torch.float_power)
maximum = _binary("maximum", _tensor_second(torch.maximum))
minimum = _binary("minimum", _tensor_second(torch.minimum))
fmax = _binary("fmax", _tensor_second(torch.fmax))
fmin = _binary("fmin", _tensor_second(torch.fmin))
atan2 = _binary("atan2", _tensor_second(torch.atan2))
heaviside = _binary("heaviside", _tensor_second(
    lambda x, y: torch.where(x > 0, torch.ones_like(y),
                             torch.where(x == 0, y, torch.zeros_like(y)))))
gcd = _binary("gcd", _tensor_second(torch.gcd))
lcm = _binary("lcm", _tensor_second(torch.lcm))
kron = _binary("kron", torch.kron)
inner = _binary("inner", torch.inner)
outer = _binary("outer", lambda x, y: torch.outer(x.reshape(-1),
                                                  y.reshape(-1)))


def _unary(name, fn):
    return defop(name)(lambda x: fn(x))


exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
abs = _unary("abs", torch.abs)
sign = _unary("sign", torch.sign)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda x: x - torch.trunc(x))
reciprocal = _unary("reciprocal", torch.reciprocal)
neg = _unary("neg", torch.neg)
negative = neg
rad2deg = _unary("rad2deg", torch.rad2deg)
deg2rad = _unary("deg2rad", torch.deg2rad)
angle = _unary("angle", torch.angle)
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.digamma)


@defop("logit")
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


@defop("clip")
def clip(x, min=None, max=None):
    min = min.item() if isinstance(min, torch.Tensor) else min
    max = max.item() if isinstance(max, torch.Tensor) else max
    return torch.clamp(x, min, max)


@defop("lerp")
def lerp(x, y, weight):
    return x + weight * (y - x)


@defop("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@defop("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@defop("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    return x * scale + bias if bias_after_scale else (x + bias) * scale


# -- reductions ---------------------------------------------------------


def norm_axis(axis, ndim):
    """``axis`` (None, an int, a list, a 0-d or 1-d tensor) as a tuple of
    non-negative dims (all of them for None)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % builtins.max(ndim, 1) for a in axis)
    return (int(axis) % builtins.max(ndim, 1),)


def _over(fn, x, axis, keepdim):
    """``fn(v, dim)`` of a reduction taking one dim, over the dims of
    ``axis``: they move last and merge into one."""
    dims = norm_axis(axis, x.dim())
    if x.dim() == 0:
        return fn(x.reshape(1), 0).reshape(())
    rest = [d for d in range(x.dim()) if d not in dims]
    v = x.permute(*rest, *dims).reshape(*[x.shape[d] for d in rest], -1)
    out = fn(v, -1)
    if keepdim:
        out = out.reshape([1 if d in dims else x.shape[d]
                           for d in range(x.dim())])
    return out


def _reduction(name, fn, register=True, float_ints=False):
    def body(x, axis=None, keepdim=False, dtype=None):
        if float_ints and not (x.is_floating_point() or x.is_complex()):
            x = x.double()
        out = _over(fn, x, axis, keepdim)
        return out if dtype is None else out.to(convert_dtype(dtype))

    def op(x, axis=None, keepdim=False, dtype=None, name=None):
        return apply(body, x, axis, keepdim, dtype, op_name=op.__name__)

    op.__name__ = name
    if register:
        OPS[name] = OpDef(name, op)
    return op


sum = _reduction("sum", lambda v, d: torch.sum(v, d))
mean = _reduction("mean", lambda v, d: torch.mean(v, d), float_ints=True)
prod = _reduction("prod", lambda v, d: torch.prod(v, d))
amax = _reduction("amax", lambda v, d: torch.amax(v, d))
amin = _reduction("amin", lambda v, d: torch.amin(v, d))
nansum = _reduction("nansum", lambda v, d: torch.nansum(v, d))
nanmean = _reduction("nanmean", lambda v, d: torch.nanmean(v, d),
                     float_ints=True)
_max = _reduction("max", lambda v, d: torch.amax(v, d), register=False)
_min = _reduction("min", lambda v, d: torch.amin(v, d), register=False)
_all = _reduction("all", lambda v, d: torch.all(v, d), register=False)
_any = _reduction("any", lambda v, d: torch.any(v, d), register=False)
_count = _reduction("count_nonzero", lambda v, d: torch.count_nonzero(v, d),
                    register=False)
_lse = _reduction("logsumexp", lambda v, d: torch.logsumexp(v, d),
                  register=False)


def max(x, axis=None, keepdim=False, name=None):
    return _max(x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return _min(x, axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):
    return _all(x, axis, keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return _any(x, axis, keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _count(x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _lse(x, axis, keepdim)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda v: torch.diagonal(v, offset, axis1, axis2).sum(-1),
                 x, op_name="trace")


# -- scans ----------------------------------------------------------------


def cumsum(x, axis=None, dtype=None, name=None):
    return apply(lambda v: torch.cumsum(v.reshape(-1), 0) if axis is None
                 else torch.cumsum(v, int(axis)), x, op_name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    return apply(lambda v: torch.cumprod(v, int(dim)), x, op_name="cumprod")


def _cum_extreme(fn, x, axis, op_name):
    def body(v):
        if axis is None:
            v = v.reshape(-1)
        out = fn(v, 0 if axis is None else int(axis))
        return out.values, out.indices

    return apply(body, x, op_name=op_name)


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummax, x, axis, "cummax")


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummin, x, axis, "cummin")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return apply(lambda v, p, a: torch.diff(v, n, axis, p, a), x, prepend,
                 append, op_name="diff")


# -- misc -----------------------------------------------------------------


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]

    def body(*vs):
        out = vs[0]
        for v in vs[1:]:
            out = out + v
        return out

    return apply(body, *inputs, op_name="add_n")


def multiplex(inputs, index, name=None):
    def body(idx, *vs):
        stacked = torch.stack(vs, 0)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[idx.reshape(-1).long(), rows]

    return apply(body, index, *inputs, op_name="multiplex")


def log_normal(mean=1.0, std=2.0, shape=None, dtype=None, name=None):
    from .random import randn

    z = randn(shape, dtype)
    return apply(lambda v: torch.exp(mean + std * v), z,
                 op_name="log_normal")
