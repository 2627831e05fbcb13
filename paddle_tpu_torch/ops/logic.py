"""Comparison and logical ops (counterpart of ``paddle_tpu/ops/logic.py``):
elementwise results as bool tensors; ``allclose`` and ``equal_all`` give a
0-d bool tensor."""
from __future__ import annotations

import torch

from .math import as_tensor_like
from .registry import defop

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "isclose", "allclose", "equal_all", "is_empty", "is_tensor",
]


def _binary(name, fn):
    def body(x, y):
        if not isinstance(x, torch.Tensor):
            x = as_tensor_like(x, y)
        return fn(x, y)

    return defop(name)(body)


equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
logical_not = defop("logical_not")(lambda x: torch.logical_not(x))
bitwise_not = defop("bitwise_not")(lambda x: torch.bitwise_not(x))


@defop("isclose")
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, as_tensor_like(y, x), rtol, atol, equal_nan)


@defop("allclose")
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, as_tensor_like(y, x), rtol, atol,
                         equal_nan).all()


@defop("equal_all")
def equal_all(x, y):
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y)),
                        device=x.device)


@defop("is_empty")
def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    from ..core.tensor import Tensor

    return isinstance(x, Tensor)
