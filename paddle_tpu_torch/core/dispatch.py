"""Eager op dispatch (counterpart of ``paddle_tpu/core/dispatch.py``).

There every op runs through ``apply``, which unwraps Tensors, records a
``jax.vjp`` node and wraps the results. torch records its own graph, so
what remains here is the boundary: Paddle's cosmetic ``name=`` is
dropped, the op's body is handed plain tensors over the same data and
graph (so it calls torch's forms of every method), results come back as
:class:`Tensor` when a Tensor went in (an input an op writes in place and
returns comes back as itself), and a failing op's exception carries the
op's name and its tensor arguments' shapes and dtypes. An op applied to a
value of a static Program being built is one replay node
(``core.capture.record_call``).

The debug hooks of the reference's dispatch run after every op while
``FLAGS_check_nan_inf`` or ``FLAGS_benchmark`` is on
(``framework.flags`` sets :data:`DEBUG_HOOKS`; with both off an op pays
that one bool read): the first raises on an op output holding a NaN or an
Inf, with the op's name and the counts; the second synchronises the
output's device after each op, so a per-op time is the op's own. Both
skip values being traced (``torch.compile``, ``torch.export``,
functorch), as the reference skips tracers.
"""
from __future__ import annotations

import torch

from .tensor import Tensor, is_tensor_arg, plain_args, static_in, wrap

__all__ = ["apply", "enrich_error", "DEBUG_HOOKS"]

# True while FLAGS_check_nan_inf or FLAGS_benchmark is on (set by
# framework.flags); the eager path reads it once an op
DEBUG_HOOKS = False


def apply(fn, *args, op_name="op", **kwargs):
    """``fn(*args, **kwargs)`` with Paddle's boundary around it."""
    kwargs.pop("name", None)
    if not _tensor_in(args, kwargs):
        return _call(fn, args, kwargs, op_name)
    if static_in(args, kwargs):
        from .capture import record_call

        return record_call(fn, args, kwargs,
                           run=lambda a, k: _call(fn, a, k, op_name))
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
        out = fn(*args, **kwargs)
    except Exception as e:
        enrich_error(e, op_name, args, kwargs)
        raise
    if DEBUG_HOOKS:
        debug_hooks(op_name, out)
    return out


def _traced(t) -> bool:
    return (torch.compiler.is_compiling()
            or isinstance(t, torch._subclasses.FakeTensor)
            or torch._C._functorch.is_functorch_wrapped_tensor(t))


def debug_hooks(op_name, out):
    """``FLAGS_benchmark``: synchronise each output's device;
    ``FLAGS_check_nan_inf``: raise ``RuntimeError`` naming the op and
    the counts where a floating output holds a NaN or an Inf."""
    from ..framework.flags import flag_value

    check = flag_value("FLAGS_check_nan_inf")
    bench = flag_value("FLAGS_benchmark")
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for o in outs:
        if not isinstance(o, torch.Tensor) or _traced(o):
            continue
        if bench and o.is_cuda:
            torch.cuda.synchronize(o.device)
        if check and (o.is_floating_point() or o.is_complex()):
            nan = int(torch.isnan(o).sum())
            inf = int(torch.isinf(o).sum())
            if nan or inf:
                raise RuntimeError(
                    f"[FLAGS_check_nan_inf] op '{op_name}' produced {nan} "
                    f"NaN / {inf} Inf values (shape {tuple(o.shape)}, "
                    f"dtype {str(o.dtype).replace('torch.', '')})")


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
