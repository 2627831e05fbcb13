"""Random sampling ops (counterpart of ``paddle_tpu/ops/random.py``). They
draw from ``framework.random``'s generator of their device, so one
``paddle.seed(n)`` makes a run repeat; they agree with the JAX package in
distribution, not in bits (ROADMAP's sampling contract)."""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core.device import resolve_device
from ..core.dispatch import apply
from ..core.tensor import wrap
from ..framework.random import get_generator
from .creation import _shape
from .registry import register

__all__ = ["rand", "randn", "standard_normal", "normal", "uniform",
           "randint", "randint_like", "randperm", "bernoulli", "multinomial",
           "poisson", "exponential_", "uniform_", "normal_", "rand_like",
           "randn_like", "gumbel_softmax"]

_reg = register(category="random")


def _dt(dtype):
    return dtype_mod.convert_dtype(dtype or dtype_mod.get_default_dtype())


def _draw(fn, *args, device=None, **kwargs):
    dev = resolve_device(device)
    return wrap(fn(*args, generator=get_generator(dev), device=dev,
                   **kwargs))


@_reg
def rand(shape, dtype=None, name=None):
    return _draw(torch.rand, _shape(shape), dtype=_dt(dtype))


@_reg
def randn(shape, dtype=None, name=None):
    return _draw(torch.randn, _shape(shape), dtype=_dt(dtype))


standard_normal = randn


@_reg
def normal(mean=0.0, std=1.0, shape=None, name=None):
    like = mean if isinstance(mean, torch.Tensor) else \
        std if isinstance(std, torch.Tensor) else None
    if shape is None:
        shp = torch.broadcast_shapes(
            tuple(getattr(mean, "shape", ())), tuple(getattr(std, "shape", ())))
    else:
        shp = _shape(shape)
    z = _draw(torch.randn, tuple(shp), dtype=_dt(None),
              device=None if like is None else like.device)
    return apply(lambda m, s, v: m + s * v, mean, std, z, op_name="normal")


@_reg
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    u = _draw(torch.rand, _shape(shape), dtype=_dt(dtype))
    return u.mul_(float(max) - float(min)).add_(float(min))


@_reg
def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return _draw(torch.randint, int(low), int(high), _shape(shape),
                 dtype=_dt(dtype))


@_reg
def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _draw(torch.randint, int(low), int(high), tuple(x.shape),
                 dtype=_dt(dtype or x.dtype), device=x.device)


@_reg
def randperm(n, dtype="int64", name=None):
    return _draw(torch.randperm, int(n), dtype=_dt(dtype))


@_reg
def bernoulli(x, name=None):
    return wrap(torch.bernoulli(x.detach(), generator=get_generator(
        x.device)))


@_reg
def multinomial(x, num_samples=1, replacement=False, name=None):
    return wrap(torch.multinomial(x.detach(), int(num_samples), replacement,
                                  generator=get_generator(x.device)))


@_reg
def poisson(x, name=None):
    return wrap(torch.poisson(x.detach(), generator=get_generator(x.device)))


@_reg
@torch.no_grad()
def exponential_(x, lam=1.0, name=None):
    return x.exponential_(lam, generator=get_generator(x.device))


@_reg
@torch.no_grad()
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    return torch.Tensor.uniform_(x, float(min), float(max),
                                 generator=get_generator(x.device))


@_reg
@torch.no_grad()
def normal_(x, mean=0.0, std=1.0, name=None):
    return torch.Tensor.normal_(x, mean, std,
                                generator=get_generator(x.device))


@_reg
def rand_like(x, dtype=None, name=None):
    return _draw(torch.rand, tuple(x.shape), dtype=_dt(dtype or x.dtype),
                 device=x.device)


@_reg
def randn_like(x, dtype=None, name=None):
    return _draw(torch.randn, tuple(x.shape), dtype=_dt(dtype or x.dtype),
                 device=x.device)


@_reg
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.rand(tuple(x.shape), generator=get_generator(x.device),
                   device=x.device, dtype=x.dtype)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(x.dtype).tiny)))

    def body(v):
        y = torch.softmax((v + g) / temperature, axis)
        if hard:
            one_hot = (y == y.amax(axis, keepdim=True)).to(y.dtype)
            return one_hot + y - y.detach()      # straight-through
        return y

    return apply(body, x, op_name="gumbel_softmax")
