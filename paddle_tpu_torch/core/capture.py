"""Static capture: how the values of a static Program being built are
recorded (the JAX package's ``_maybe_attach_recompute`` /
``recompute_value`` in ``paddle_tpu/core/dispatch.py``).

``static.data`` and ``static.create_parameter`` give a
:class:`~paddle_tpu_torch.core.tensor.StaticTensor`: a Tensor holding a
build-time value whose ``_static`` says how it is computed again from fed
values: ``("feed", name)``, ``("param", name)``, ``("loop", uid, k)`` or
``(node, i)``, output ``i`` of a replay :class:`Node`. Every value computed
from a StaticTensor is one too, by two routes:

- the port's boundaries (``core.dispatch.apply``, ``core.tensor.boundary``
  around ``nn.functional`` and the kernels' entry points, the port's own
  ``Layer.__call__``) make one node of the whole call
  (:func:`record_call`): its body runs on plain tensors, as in eager, so
  a Layer call (ERNIE included) is one node that runs again at the fed
  shapes with its state handed in;
- everything else that touches a StaticTensor is a torch call (functions,
  methods, operators, properties, indexing, registered ops), which
  StaticTensor's ``__torch_function__`` records as one node each
  (:func:`torch_function`).

Program values do not alias, as in Paddle's static graph: an in-place
write (``x[0] = v``, ``add_``, ``copy_``, ``inplace=True``, a Paddle op
writing its input) is a node that computes the written value from a copy,
and the written StaticTensor is rebound to it; a view taken before keeps
the value it had. What the replay cannot see raises
:class:`StaticValueError` instead of baking the build-time value in:
reading a value on the host (``item``, ``tolist``, ``numpy``, ``bool``,
``int``, ``data_ptr``, ...), an ``out=`` argument, and writing a program
value into a tensor outside the program.
"""
from __future__ import annotations

import types

import torch

from .tensor import StaticTensor, Tensor, plain

__all__ = ["StaticValueError", "Ref", "Node", "next_uid", "freeze",
           "build_value", "tensor_leaves", "torch_function", "record_call",
           "key_of"]


class StaticValueError(RuntimeError):
    """A use of a static Program's value that its replay could not see."""


# reads of a value on the host: the build-time value would become a constant
_HOST_READS = frozenset((
    "item", "tolist", "numpy", "data_ptr", "__bool__", "__int__",
    "__float__", "__index__", "__complex__", "__contains__", "equal",
    "allclose", "is_nonzero", "untyped_storage", "storage",
    "_typed_storage", "__array__", "__dlpack__", "__reduce_ex__",
    "as_subclass", "__cuda_array_interface__"))
# in-place methods that change no value
_NO_VALUE = frozenset(("requires_grad_", "retain_grad", "share_memory_",
                       "detach_", "__set__"))
_INPLACE_DUNDERS = frozenset((
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__",
    "__ifloordiv__", "__imod__", "__ipow__", "__imatmul__", "__iand__",
    "__ior__", "__ixor__", "__ilshift__", "__irshift__"))

_UID = [0]


def next_uid() -> int:
    """A number no other replay node (or loop) of this process has."""
    _UID[0] += 1
    return _UID[0]


class Ref:
    """A node's argument that is a program value: its ``_static`` when the
    node was recorded (a later in-place write rebinds the StaticTensor,
    not what this node read)."""

    __slots__ = ("st",)

    def __init__(self, st):
        self.st = st


def key_of(st):
    """The replay key of a ``_static``: ``(kind, name...)`` for
    placeholders, parameters and loop variables, ``(node uid, output)``
    for a node's output."""
    return st if isinstance(st[0], str) else (st[0].uid, st[1])


class Node:
    """One recorded call: ``fn(*args, **kwargs)`` on plain tensors, whose
    program values are :class:`Ref` s and other tensors constants.
    ``layer`` is set where ``fn`` is a Layer, whose state the replay hands
    in; ``writes`` is the index of the argument ``fn`` writes in place,
    whose new value (computed from a copy) is then the node's one
    output."""

    def __init__(self, fn, args, kwargs, layer=None, writes=None):
        self.uid = next_uid()
        if not isinstance(fn, (types.FunctionType, torch.nn.Module)):
            fn = _function_of(fn)
        self.fn, self.layer, self.writes = fn, layer, writes
        self.args = freeze(tuple(args))
        self.kwargs = freeze(dict(kwargs or {}))

    def outputs(self, args, kwargs, run):
        """The node's outputs (a list of tensors) from its resolved
        ``args`` / ``kwargs``; ``run(fn, args, kwargs)`` calls ``fn``."""
        if self.writes is None:
            return tensor_leaves(run(self.fn, args, kwargs))
        args = list(args)
        args[self.writes] = args[self.writes].clone()
        run(self.fn, args, kwargs)
        return [args[self.writes]]


def _function_of(fn):
    """A Python function calling ``fn`` (a slot wrapper such as
    ``torch.Tensor.__mul__``, a property's getter): what
    ``torch.compile`` traces when the Executor replays the node."""
    if getattr(fn, "__name__", None) == "__get__":
        desc = fn.__self__
        attr = getattr(desc, "__name__", None) or desc.fget.__name__

        def get(t):
            return getattr(t, attr)
        return get

    def call(*args, **kwargs):
        return fn(*args, **kwargs)
    return call


def freeze(a):
    """What a node keeps of an argument: program values as :class:`Ref` s,
    other tensors as plain detached tensors over the same storage
    (constants of the program), containers element by element."""
    if isinstance(a, StaticTensor):
        return Ref(a._static)
    if isinstance(a, torch.Tensor):
        return torch.Tensor.detach(a)
    t = type(a)
    if t is list or t is tuple:
        return t(freeze(e) for e in a)
    if t is dict:
        return {k: freeze(v) for k, v in a.items()}
    return a


def build_value(t):
    """A StaticTensor's build-time value: a plain tensor over the same data
    and graph, recorded nowhere."""
    with torch._C.DisableTorchFunctionSubclass():
        return torch.Tensor.as_subclass(t, torch.Tensor)


def tensor_leaves(out) -> list:
    """The tensors of ``out`` (nested lists, tuples and dicts), in order: a
    node's outputs."""
    if isinstance(out, torch.Tensor):
        return [out]
    leaves = []
    if isinstance(out, (list, tuple)):
        for e in out:
            leaves.extend(tensor_leaves(e))
    elif isinstance(out, dict):
        for e in out.values():
            leaves.extend(tensor_leaves(e))
    return leaves


def _bind(node, out, keep=()):
    """Make the fresh tensors of ``out`` the node's outputs (StaticTensors,
    their class set in place); tensors in ``keep`` (what went in) stay as
    they are."""
    for i, o in enumerate(tensor_leaves(out)):
        if any(o is k for k in keep):
            continue
        t = type(o)
        if t is torch.Tensor or t is Tensor:
            o.__class__ = StaticTensor
        elif t is not StaticTensor:
            continue                    # a Parameter handed back
        o._static = (node, i)
    return out


def _written(target, what):
    if not isinstance(target, StaticTensor):
        raise StaticValueError(
            f"static capture: {what} writes a value of a static Program "
            f"into a tensor outside it, which the Executor's replay would "
            f"not see; compute a new value instead (paddle.where, "
            f"paddle.concat, ...)")


def torch_function(func, args, kwargs):
    """StaticTensor's ``__torch_function__``: run ``func`` on the build-time
    values and record it as one replay node (see the module's
    docstring)."""
    name = getattr(func, "__name__", "")
    if name == "__get__" and getattr(func.__self__, "__name__",
                                     "") in _HOST_READS:
        name = func.__self__.__name__
    if name in _HOST_READS:
        raise StaticValueError(
            f"static capture: '{name}' reads a value of a static Program on "
            f"the host while the program is built; that is the build-time "
            f"value (zeros of the declared shape), not what will be fed. "
            f"Fetch it with Executor.run, or use tensor ops (paddle.where, "
            f"static.nn.cond) instead of Python control flow")
    if kwargs.get("out") is not None:
        raise StaticValueError(
            f"static capture: '{name}' with out= writes into a tensor the "
            f"replay does not see; use the returned value")
    inplace = (name in _INPLACE_DUNDERS or kwargs.get("inplace") is True
               or (name.endswith("_") and not name.endswith("__")))
    if name in _NO_VALUE:
        inplace = False
    elif inplace:
        _written(args[0], f"'{name}'")
    with torch._C.DisableTorchFunctionSubclass():
        out = func(*args, **kwargs)
    if name in _NO_VALUE or not (isinstance(out, torch.Tensor) or inplace
                                 or tensor_leaves(out)):
        return out
    if inplace:
        # the node reads the target's binding before this write
        node = Node(func, args, kwargs, writes=0)
        args[0]._static = (node, 0)
        return out
    return _bind(Node(func, args, kwargs), out, keep=args)


def _inner(a):
    """What a boundary's body is handed for ``a``: build-time values for
    program values, :func:`~paddle_tpu_torch.core.tensor.plain` for
    Tensors."""
    if isinstance(a, StaticTensor):
        return build_value(a)
    if type(a) in (list, tuple):
        return type(a)(_inner(e) for e in a)
    return plain(a)


def record_call(fn, args, kwargs, layer=None, run=None):
    """A boundary's call on program values: ``fn`` runs on the build-time
    values (``run(args, kwargs)`` calls it, default ``fn`` itself) and its
    fresh tensor outputs become StaticTensors of one replay node. An
    argument handed back (an op that writes its input, an identity layer)
    is a write: the node computes it from a copy, the argument is
    rebound and comes back as itself."""
    inner = tuple(_inner(a) for a in args)
    inner_kw = {k: _inner(v) for k, v in (kwargs or {}).items()}
    out = (run or (lambda a, k: fn(*a, **k)))(inner, inner_kw)
    for k, i in enumerate(inner):
        if out is i:
            _written(args[k], f"'{getattr(fn, '__name__', fn)}'")
            node = Node(fn, args, kwargs, layer, writes=k)
            args[k]._static = (node, 0)
            return args[k]
    return _bind(Node(fn, args, kwargs, layer), out)
