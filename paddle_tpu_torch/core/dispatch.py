"""Eager op dispatch (counterpart of ``paddle_tpu/core/dispatch.py``).

There every op runs through ``apply``, which unwraps Tensors, records a
``jax.vjp`` node and wraps the results. torch records its own graph, so
what remains here is the boundary: Paddle's cosmetic ``name=`` is
dropped, the op's body is handed plain tensors over the same data and
graph (so it calls torch's forms of every method), results come back as
:class:`Tensor` when a Tensor went in (an input an op writes in place and
returns comes back as itself), and a failing op's exception carries the
op's name and its tensor arguments' shapes and dtypes.
"""
from __future__ import annotations

import torch

from .tensor import Tensor, is_tensor_arg, plain_args, wrap

__all__ = ["apply", "enrich_error"]


def apply(fn, *args, op_name="op", **kwargs):
    """``fn(*args, **kwargs)`` with Paddle's boundary around it."""
    kwargs.pop("name", None)
    if not _tensor_in(args, kwargs):
        return _call(fn, args, kwargs, op_name)
    inner, inner_kw = plain_args(args, kwargs)
    out = _call(fn, inner, inner_kw, op_name)
    if isinstance(out, torch.Tensor):
        for i, a in zip(inner, args):
            if out is i and isinstance(a, Tensor):
                return a
    return wrap(out)


def _tensor_in(args, kwargs) -> bool:
    for a in args:
        if is_tensor_arg(a):
            return True
    if kwargs:
        for a in kwargs.values():
            if is_tensor_arg(a):
                return True
    return False


def _call(fn, args, kwargs, op_name):
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        enrich_error(e, op_name, args, kwargs)
        raise


def _signatures(args, kwargs):
    sigs = []
    for a in list(args) + list(kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor):
                sigs.append(f"Tensor{tuple(t.shape)}:"
                            f"{str(t.dtype).replace('torch.', '')}")
    return sigs


def enrich_error(e, op_name, args, kwargs=None):
    """Add the op's name and its tensor inputs to ``e`` as a note (PEP 678),
    as the reference's enriched errors carry the op."""
    note = (f"[paddle_tpu_torch] in op '{op_name}' (tensor inputs: "
            f"{', '.join(_signatures(args, kwargs or {})) or 'none'})")
    e.add_note(note)
