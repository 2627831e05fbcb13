"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``), in the JAX package's wire format: the
``PDTPU1\\n`` magic, then a pickle of nested dicts, lists and tuples whose
tensor leaves are ``_TensorLeaf``s (a numpy array and ``stop_gradient``).
A file either package wrote loads in the other: the leaves are written
under the JAX package's class name (``paddle_tpu.framework.io._TensorLeaf``,
the same two slots), which a plain unpickler of that package resolves to
its own class, and nothing of it is imported here.

:func:`load` unpickles with a restricted ``find_class``: the leaf class
under either package's module name maps to this module's ``_TensorLeaf``
(nothing is imported), numpy's array and scalar constructors pass, any
other global raises ``pickle.UnpicklingError``. :func:`load_pickle`
reads the ``.pdparams`` / ``.pdiparams`` pickles of ``static`` and ``jit``
the same way, also passing torch's tensor rebuild for their bf16 leaves
(whose storage is read with ``torch.load(weights_only=True)``). It
gives CPU Tensors (``return_numpy=True``: the arrays); the caller moves
them. A bf16 tensor is saved as float32 (numpy has no bf16), which widens
it exactly.
"""
from __future__ import annotations

import collections
import io
import os
import pickle

import numpy as np
import torch

from ..core.tensor import wrap

__all__ = ["save", "load", "load_pickle"]

_MAGIC = b"PDTPU1\n"


class _TensorLeaf:
    __slots__ = ("array", "stop_gradient")

    def __init__(self, array, stop_gradient=True):
        self.array = array
        self.stop_gradient = stop_gradient


def _to_numpy_tree(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return _TensorLeaf(t.numpy().copy(), stop_gradient=not obj.requires_grad)
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(v) for v in obj)
    return obj


def _from_numpy_tree(obj, return_numpy=False):
    if isinstance(obj, _TensorLeaf):
        if return_numpy:
            return obj.array
        t = torch.from_numpy(np.array(obj.array))   # a copy it owns
        if t.is_floating_point() and not obj.stop_gradient:
            t.requires_grad_(True)
        return wrap(t)
    if isinstance(obj, dict):
        return {k: _from_numpy_tree(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_numpy_tree(v, return_numpy) for v in obj)
    return obj


_LEAF_MODULES = ("paddle_tpu.framework.io", __name__)
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "scalar"),
          ("numpy.core.numeric", "_frombuffer"),
          ("numpy._core.numeric", "_frombuffer")}


def _storage_from_bytes(b):
    # torch.storage._load_from_bytes, without its weights_only=False
    return torch.load(io.BytesIO(b), weights_only=True)


# a CPU tensor's pickle (bf16 leaves of the jit / static files)
_TORCH = {
    ("torch._utils", "_rebuild_tensor_v2"): torch._utils._rebuild_tensor_v2,
    ("torch.storage", "_load_from_bytes"): _storage_from_bytes,
    ("collections", "OrderedDict"): collections.OrderedDict}


class _Unpickler(pickle.Unpickler):
    allowed: dict = {}

    def find_class(self, module, name):
        if module in _LEAF_MODULES and name == "_TensorLeaf":
            return _TensorLeaf
        if (module, name) in _NUMPY:
            return super().find_class(module, name)
        if (module, name) in self.allowed:
            return self.allowed[(module, name)]
        raise pickle.UnpicklingError(
            f"paddle_tpu_torch: refusing to unpickle {module}.{name}")


class _ParamsUnpickler(_Unpickler):
    allowed = _TORCH


def load_pickle(f):
    """The object pickled in the open file ``f`` (a ``.pdparams`` /
    ``.pdiparams`` file: dicts, lists, numpy arrays, CPU tensors); any
    other global raises ``pickle.UnpicklingError``."""
    return _ParamsUnpickler(f).load()


_LEAF_NAME = ("paddle_tpu.framework.io", "_TensorLeaf")


class _Pickler(pickle._Pickler):
    """Writes ``_TensorLeaf`` under the JAX package's name, unchecked (the
    default pickler would import that module to verify it)."""

    def save_global(self, obj, name=None):
        if obj is not _TensorLeaf:
            return super().save_global(obj, name)
        module, qualname = _LEAF_NAME
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        _Pickler(f, protocol=protocol).dump(_to_numpy_tree(obj))


def load(path, return_numpy=False, **configs):
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            f.seek(0)
        obj = _Unpickler(f).load()
    return _from_numpy_tree(obj, return_numpy=return_numpy)
