"""Dtype names (counterpart of ``paddle_tpu/core/dtype.py``).

Paddle's spellings (``"float32"``, ``"bfloat16"``, ...) map onto
``torch.dtype``s. ``Tensor.dtype`` is a ``torch.dtype`` here, where the
JAX package's is a numpy dtype; ``paddle.float32`` is ``torch.float32``,
so ``t.dtype == paddle.float32`` holds in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "set_default_dtype", "get_default_dtype", "convert_dtype",
           "dtype_name", "is_floating", "is_integer", "is_complex"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}
# numpy's spellings of the same types (and Python's scalar types)
_NUMPY = {np.dtype(k): v for k, v in _NAME_TO_DTYPE.items()
          if k != "bfloat16"}
_PY = {bool: bool_, int: int64, float: float64, complex: complex128}

_state = {"default": "float32"}


def set_default_dtype(d) -> None:
    """The float dtype of tensors made from Python floats."""
    name = dtype_name(d)
    if name not in ("float16", "bfloat16", "float32", "float64"):
        raise ValueError(f"default dtype must be a float dtype, got {name}")
    _state["default"] = name


def get_default_dtype() -> str:
    return _state["default"]


def convert_dtype(d):
    """Any dtype spelling (a Paddle name, a ``torch.dtype``, a numpy dtype
    or type, a Python scalar type) as a ``torch.dtype``; None stays None."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        try:
            return _NAME_TO_DTYPE[d]
        except KeyError:
            raise ValueError(f"unknown dtype {d!r}") from None
    if d in _PY:
        return _PY[d]
    nd = np.dtype(d)
    if nd.name == "bfloat16":       # ml_dtypes' bfloat16
        return bfloat16
    try:
        return _NUMPY[nd]
    except KeyError:
        raise ValueError(f"unsupported dtype {d!r}") from None


def dtype_name(d) -> str:
    """Paddle's name of a dtype (``"float32"``)."""
    return _DTYPE_TO_NAME[convert_dtype(d)]


def is_floating(d) -> bool:
    d = convert_dtype(d)
    return d is not None and d.is_floating_point


def is_integer(d) -> bool:
    d = convert_dtype(d)
    return d is not None and not d.is_floating_point and not d.is_complex \
        and d is not bool_


def is_complex(d) -> bool:
    d = convert_dtype(d)
    return d is not None and d.is_complex
