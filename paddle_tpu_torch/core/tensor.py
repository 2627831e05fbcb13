"""``paddle.Tensor`` (counterpart of ``paddle_tpu/core/tensor.py``).

:class:`Tensor` is a ``torch.Tensor`` subclass that carries Paddle's
surface: ``stop_gradient``, ``place``, ``astype``, ``numpy``,
``gradient()``, ``clear_grad``, ``set_value``, ``backward`` seeding ones on
a non-scalar, and the op methods that ``ops/__init__.py`` adds. torch
itself is not patched.

``__torch_function__`` is disabled, so torch's own ops run at full speed on
a :class:`Tensor` and give plain ``torch.Tensor``s. The port's public
boundaries make the type instead: the ops hand back a :class:`Tensor`
when a :class:`Tensor` (a :class:`Parameter` too) came in
(``core.dispatch.apply``); ``Layer.__call__``, ``nn.functional`` and the
kernels' entry points when a user's Tensor (not a Parameter) came in
(:func:`has_user_tensor`); all of them give plain tensors when plain
tensors came in, so the port's inner code and callers that pass plain
tensors see no change. Inward, the boundaries hand the port's code plain
tensors over the same data and graph (:func:`plain`), so the port's and
torch's code never meets Paddle's forms of a method. The operators and
torch's own methods on a Parameter alone give plain tensors (the port's
arithmetic on its parameters stays plain); with a user's Tensor they give
Tensors. Wrapping a fresh result sets its class in place (:func:`wrap`);
nothing is copied. :class:`StaticTensor`, the values of a static Program
being built, is the one subclass whose ``__torch_function__`` is on
(``core.capture``).

Where Paddle's method and torch's share a name they are told apart by
their arguments alone (``transpose(perm)`` against ``transpose(d0, d1)``,
``gather(index, axis)`` against ``gather(dim, index)``, ``max(dim=1)``
against ``max(axis=1)``, ...). Where the arguments cannot tell them apart
(``split(2)``, ``sort()``, ``max(1)``, ``median()``, ``where(x, y)``,
``equal(y)``, ``allclose(y)``, ``uniform_()``) the call takes Paddle's
form; torch's is ``torch.split(x, 2)`` and the like, which is what the
port's own code calls on its parameters.
``size`` is Paddle's element count and also callable as torch's
``size()``; ``dim`` and ``numel()`` are ints that also read as Paddle's
(``.item()``); ``shape`` is a tuple that equals a list of the same dims.
``dtype`` is a ``torch.dtype`` (the JAX package's is a numpy dtype).
"""
from __future__ import annotations

import functools
import types

import numpy as np
import torch

from . import dtype as dtype_mod
from .device import Place, _torch_device, resolve_device

__all__ = ["Tensor", "Parameter", "to_tensor", "wrap", "is_tensor_arg",
           "Shape", "raw_grad", "boundary", "bound_public", "uncut",
           "uncut_args", "plain", "plain_args", "has_user_tensor",
           "StaticTensor", "static_in"]

_TorchTensor = torch.Tensor
_GRAD = getattr(torch._C, "TensorBase", None) or torch._C._TensorBase
_GRAD = _GRAD.grad     # the raw getset descriptor of .grad


class Shape(tuple):
    """``Tensor.shape``: a tuple of ints (what torch's code expects) that
    equals a list of the same ints (Paddle's ``x.shape == [2, 3]``)."""

    def __eq__(self, other):
        if isinstance(other, (list, tuple)):
            return tuple(self) == tuple(other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = tuple.__hash__

    def __add__(self, other):
        return Shape(tuple(self) + tuple(other))

    def __radd__(self, other):
        return type(other)(tuple(other) + tuple(self))

    def __getitem__(self, i):
        out = tuple.__getitem__(self, i)
        return Shape(out) if isinstance(i, slice) else out

    def numel(self):
        n = 1
        for s in self:
            n *= s
        return n


class _Int(int):
    """An int that also answers Paddle's ``.item()`` / ``.numpy()`` (what
    ``numel()`` gives: torch's int, Paddle's 0-d tensor)."""

    def item(self):
        return int(self)

    def numpy(self):
        return np.int64(self)


class _CallableInt(int):
    """An int that returns itself when called: ``x.dim`` (the JAX
    package's property) and ``x.dim()`` (torch's and Paddle's method)."""

    def __call__(self):
        return int(self)


class _Size(int):
    """Paddle's ``x.size`` (the element count) that is also torch's
    ``x.size()`` / ``x.size(d)``."""

    def __call__(self, dim=None):
        return self._shape if dim is None else self._shape[dim]


def wrap(o):
    """``o`` (a fresh result) as a :class:`Tensor`, its class set in place;
    tuples and lists of results element by element."""
    if type(o) is _TorchTensor:
        # a traced program (to_static, jit.save) sees plain tensors only
        if not torch.compiler.is_compiling():
            o.__class__ = Tensor
    elif isinstance(o, (tuple, list)):
        for e in o:
            wrap(e)
    return o


def has_user_tensor(args, kwargs) -> bool:
    """True when an argument (or an element of a list / tuple argument) is
    a Tensor that is not a Parameter: what the boundaries of
    ``nn.functional``, the kernels and ``Layer.__call__`` wrap for (the
    port's own calls hand them its parameters and plain activations)."""
    for a in args:
        t = type(a)
        if t is Tensor or ((t is list or t is tuple) and _user_in(a)):
            return True
    if kwargs:
        for a in kwargs.values():
            t = type(a)
            if t is Tensor or ((t is list or t is tuple) and _user_in(a)):
                return True
    return False


def _user_in(seq) -> bool:
    for e in seq:
        t = type(e)
        if t is Tensor or t is StaticTensor:
            return True
    return False


def static_in(args, kwargs=None) -> bool:
    """True when an argument (or an element of a list / tuple argument) is
    a :class:`StaticTensor`: a value of a static Program being built."""
    for a in (*args, *kwargs.values()) if kwargs else args:
        t = type(a)
        if t is StaticTensor or ((t is list or t is tuple) and any(
                type(e) is StaticTensor for e in a)):
            return True
    return False


def is_tensor_arg(a) -> bool:
    """True when ``a`` is a :class:`Tensor`, or a list / tuple holding one."""
    if isinstance(a, Tensor):
        return True
    if isinstance(a, (list, tuple)):
        for e in a:
            if isinstance(e, Tensor):
                return True
    return False


def _is_cut(a) -> bool:
    return isinstance(a, Tensor) and a._cut


def uncut(a):
    """``a``, or a detached alias of it where ``stop_gradient`` was set on
    it as a non-leaf (also inside a list or tuple)."""
    if _is_cut(a):
        return wrap(_TorchTensor.detach(a))
    if isinstance(a, (list, tuple)) and any(_is_cut(e) for e in a):
        return type(a)(uncut(e) for e in a)
    return a


def uncut_args(args):
    """``args`` with :func:`uncut` applied, the same tuple when nothing in
    it was cut (the common case, checked without building anything)."""
    for a in args:
        if _is_cut(a) or (type(a) in (list, tuple)
                          and any(_is_cut(e) for e in a)):
            return tuple(uncut(x) for x in args)
    return args


def plain(a):
    """``a`` where it is a Tensor (a Parameter too; also inside a list or
    tuple): a plain ``torch.Tensor`` over the same data, in the same graph
    (a view, so what is written into it in place reaches ``a``; detached
    where ``stop_gradient`` cut it).
    What the boundaries hand the port's code, which calls torch's forms."""
    if isinstance(a, Tensor):
        if a._cut:
            return _TorchTensor.detach(a)
        return _TorchTensor.view_as(a, a)
    if type(a) in (list, tuple) and is_tensor_arg(a):
        return type(a)(plain(e) for e in a)
    return a


def plain_args(args, kwargs):
    """``(args, kwargs)`` with :func:`plain` applied to each."""
    return (tuple(plain(a) for a in args),
            {k: plain(v) for k, v in kwargs.items()} if kwargs else kwargs)


def boundary(fn):
    """``fn`` handing back Tensors when a user's Tensor came in (a public
    entry point of ``nn.functional`` or of a kernel; see
    :func:`has_user_tensor`), and handed plain tensors (:func:`plain`). A
    call on a value of a static Program is one replay node
    (``core.capture.record_call``)."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        # has_user_tensor, inline: the hot path
        for a in (*args, *kwargs.values()) if kwargs else args:
            t = type(a)
            if t is Tensor or t is StaticTensor or (
                    (t is list or t is tuple) and _user_in(a)):
                break
        else:
            return fn(*args, **kwargs)
        if static_in(args, kwargs):
            from .capture import record_call

            return record_call(fn, args, kwargs)
        args, kwargs = plain_args(args, kwargs)
        return wrap(fn(*args, **kwargs))

    entry.__wrapped_plain__ = fn
    return entry


def bound_public(namespace: dict) -> None:
    """Put :func:`boundary` around every function a module lists in its
    ``__all__``."""
    for name in namespace.get("__all__", ()):
        fn = namespace.get(name)
        if isinstance(fn, types.FunctionType) and \
                not hasattr(fn, "__wrapped_plain__"):
            namespace[name] = boundary(fn)


def _as_torch(data, dtype=None, device=None) -> torch.Tensor:
    """``data`` (a tensor, an array, a scalar or nested lists) as a torch
    tensor of its own, with the JAX package's dtype rules: numpy arrays
    keep their dtype, Python floats (and float lists) take the default
    float dtype, ints int64, bools bool, complex numbers complex64."""
    dt = dtype_mod.convert_dtype(dtype)
    if isinstance(data, _TorchTensor):
        t = data.detach().to(device=device or data.device, dtype=dt)
        if t.data_ptr() == data.data_ptr() and t.numel():
            t = t.clone()
        return t
    dev = device if device is not None else resolve_device(None)
    if isinstance(data, (bool, int, float, complex, np.generic)) and \
            not isinstance(data, np.ndarray):
        if dt is None:
            if isinstance(data, (bool, np.bool_)):
                dt = torch.bool
            elif isinstance(data, (int, np.integer)):
                dt = torch.int64
            elif isinstance(data, complex):
                dt = torch.complex64
            elif isinstance(data, np.generic):
                dt = dtype_mod.convert_dtype(data.dtype)
            else:
                dt = dtype_mod.convert_dtype(dtype_mod.get_default_dtype())
        return torch.tensor(data, dtype=dt, device=dev)
    arr = data if isinstance(data, np.ndarray) else np.asarray(
        [d.detach().cpu().numpy() if isinstance(d, _TorchTensor) else d
         for d in data] if isinstance(data, (list, tuple)) and data and
        isinstance(data[0], _TorchTensor) else data)
    if dt is None and not isinstance(data, np.ndarray) and \
            arr.dtype == np.float64:
        dt = dtype_mod.convert_dtype(dtype_mod.get_default_dtype())
    if arr.dtype.name == "bfloat16":
        arr, dt = arr.astype(np.float32), dt or torch.bfloat16
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return t.to(device=dev, dtype=dt)


class Tensor(_TorchTensor):
    """Paddle's eager tensor over a ``torch.Tensor``."""

    __torch_function__ = torch._C._disabled_torch_function_impl
    persistable = False
    name = None
    _cut = False            # stop_gradient set on this non-leaf

    def __new__(cls, data=None, dtype=None, place=None, stop_gradient=True,
                name=None):
        if data is None:
            data = np.zeros((), np.float32)
        dev = None if place is None else _torch_device(place)
        t = _as_torch(data, dtype, dev)
        out = _TorchTensor._make_subclass(cls, t, not stop_gradient)
        if name is not None:
            out.name = name
        return out

    def __init__(self, *args, **kwargs):
        pass

    # -- metadata ---------------------------------------------------------
    @property
    def shape(self):
        return Shape(_TorchTensor.shape.__get__(self))

    @property
    def size(self):
        s = _Size(_TorchTensor.numel(self))
        s._shape = _TorchTensor.shape.__get__(self)
        return s

    @property
    def dim(self):
        return _CallableInt(_TorchTensor.dim(self))

    def numel(self):
        return _Int(_TorchTensor.numel(self))

    @property
    def place(self):
        return Place.of(self.device)

    @property
    def stop_gradient(self):
        return not self.requires_grad or self._cut

    @stop_gradient.setter
    def stop_gradient(self, value):
        if self.is_leaf:
            self.requires_grad_(not value)
        elif value:
            # as in the JAX package: the uses already recorded keep their
            # edge, later uses through the port's ops, operators, layers
            # and functionals see no graph (uncut() hands them a detached
            # alias; torch cannot detach in place a value a node saved)
            self._cut = True
        else:
            self._cut = False

    # -- autograd ---------------------------------------------------------
    @property
    def grad(self):
        g = _GRAD.__get__(self)
        return None if g is None else g.as_subclass(Tensor)

    @grad.setter
    def grad(self, value):
        _GRAD.__set__(self, value)

    def gradient(self):
        """The gradient as a numpy array (None when there is none)."""
        g = _GRAD.__get__(self)
        return None if g is None else _to_numpy(g)

    def backward(self, grad_tensor=None, retain_graph=False, **kw):
        """Paddle's backward: a non-scalar output without ``grad_tensor``
        is seeded with ones (torch raises there); a tensor outside any
        graph is a no-op."""
        from .autograd import backward

        backward([self], [grad_tensor], retain_graph, **kw)

    def clear_grad(self, set_to_zero=False):
        _GRAD.__set__(self, None)

    clear_gradient = clear_grad

    def retain_grads(self):
        self.retain_grad()

    def register_hook(self, hook):
        """``hook(grad)`` sees the gradient as a Tensor; what it returns
        replaces it. Returns a handle with ``remove()``."""
        def call(g):
            return hook(g.as_subclass(Tensor))

        return _TorchTensor.register_hook(self, call)

    def detach(self):
        return wrap(_TorchTensor.detach(self))

    def clone(self, *args, **kwargs):
        return wrap(_TorchTensor.clone(uncut(self), *args, **kwargs))

    # -- value access -----------------------------------------------------
    def numpy(self):
        """The values on the host (bf16 widened to f32: numpy has no
        bf16)."""
        return _to_numpy(self)

    def __array__(self, dtype=None, copy=None):
        arr = _to_numpy(self)
        return arr.astype(dtype) if dtype is not None else arr

    def set_value(self, value):
        """Overwrite the values in place (same shape; cast to this dtype)."""
        src = _as_torch(value, self.dtype, self.device)
        if tuple(src.shape) != tuple(_TorchTensor.shape.__get__(self)):
            raise ValueError(f"set_value shape mismatch: {tuple(src.shape)} "
                             f"vs {tuple(self.shape)}")
        with torch.no_grad():
            _TorchTensor.copy_(self, src)
        return self

    def copy_(self, other, blocking=None, non_blocking=False):
        """torch's ``copy_`` (Paddle's ``blocking`` accepted); a leaf that
        requires grad is written outside autograd, as Paddle does."""
        if not isinstance(other, _TorchTensor):
            other = _as_torch(other, self.dtype, self.device)
        if self.is_leaf and self.requires_grad:
            with torch.no_grad():
                return _TorchTensor.copy_(self, other, non_blocking)
        return _TorchTensor.copy_(self, other, non_blocking)

    def astype(self, dtype):
        from ..ops.manipulation import cast

        return cast(self, dtype)

    cast = astype

    def cpu(self, *args, **kwargs):
        out = _TorchTensor.cpu(uncut(self), *args, **kwargs)
        return self if out is self else wrap(out)

    def cuda(self, *args, **kwargs):
        out = _TorchTensor.cuda(uncut(self), *args, **kwargs)
        return self if out is self else wrap(out)

    def to(self, *args, **kwargs):
        """torch's ``to``, also with Paddle's names (``"float32"``,
        ``"gpu"``, a ``Place``)."""
        for a in (*args, *kwargs.values()):
            if isinstance(a, (str, Place)):
                args = tuple(_to_arg(a) for a in args)
                kwargs = {k: _to_arg(v) for k, v in kwargs.items()}
                break
        out = _TorchTensor.to(uncut(self), *args, **kwargs)
        return self if out is self else wrap(out)

    # -- indexing and iteration -------------------------------------------
    def __getitem__(self, idx):
        return wrap(_TorchTensor.__getitem__(uncut(self), _index(idx)))

    def __setitem__(self, idx, value):
        _TorchTensor.__setitem__(self, _index(idx), value)

    def __iter__(self):
        if self.dim() == 0:
            raise TypeError("iteration over a 0-d tensor")
        for i in range(len(self)):
            yield self[i]

    __hash__ = _TorchTensor.__hash__

    def __repr__(self):
        kind = "Parameter" if isinstance(self, Parameter) else "Tensor"
        data = _TorchTensor.__repr__(self.detach().as_subclass(_TorchTensor))
        return (f"{kind}(shape={list(self.shape)}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},"
                f"\n       {data})")


class StaticTensor(Tensor):
    """A value of a static Program being built: a ``static.data``
    placeholder, a ``static.create_parameter`` parameter, or anything
    computed from one. It holds its build-time value; ``_static`` says how
    the value is computed again from fed ones (``core.capture``). Unlike
    :class:`Tensor`'s, its ``__torch_function__`` is on: every torch call
    on it records a replay node and gives StaticTensors, so no value
    derived from a placeholder leaves the graph."""

    _static = None

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        from .capture import torch_function

        return torch_function(func, args, kwargs or {})

    # host reads: torch's, which the capture refuses
    def numpy(self):
        return _TorchTensor.numpy(self)

    def __array__(self, dtype=None, copy=None):
        return _TorchTensor.__array__(self, dtype)

    def __repr__(self):
        return (f"StaticTensor(name={self.name}, shape={list(self.shape)}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place})")


class Parameter(Tensor):
    """A trainable leaf (``paddle.create_parameter``; ``EagerParamBase`` in
    Paddle). ``isinstance(p, torch.nn.Parameter)`` holds (``_is_param``),
    so ``torch.nn.Module`` registers it as a parameter; ``nn.Layer``
    turns every parameter of its layers into one of these in place."""

    _is_param = True
    persistable = True
    # alone, a Parameter answers as torch's tensor, with plain results (the
    # port's own code on its parameters); it is a leaf, never cut
    __getitem__ = _TorchTensor.__getitem__
    __neg__ = _TorchTensor.__neg__
    __abs__ = _TorchTensor.__abs__
    __invert__ = _TorchTensor.__invert__
    to = _TorchTensor.to
    cpu = _TorchTensor.cpu
    cuda = _TorchTensor.cuda
    clone = _TorchTensor.clone
    detach = _TorchTensor.detach

    def __new__(cls, data=None, dtype=None, name=None, trainable=True,
                device=None):
        dev = None if device is None else torch.device(device)
        t = _as_torch(data, dtype, dev)
        out = _TorchTensor._make_subclass(cls, t, bool(trainable))
        if name is not None:
            out.name = name
        return out

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = _TorchTensor._make_subclass(
            type(self), self.data.clone(memory_format=torch.preserve_format),
            self.requires_grad)
        out.__dict__.update(
            {k: v for k, v in self.__dict__.items() if k != "_is_param"})
        memo[id(self)] = out
        return out


def raw_grad(t):
    """``t``'s gradient as torch stores it (no wrapping: the optimizer's
    and the clips' inner loops)."""
    return _GRAD.__get__(t)


def _to_numpy(t):
    t = _TorchTensor.detach(t)          # a plain tensor
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _to_arg(a):
    if isinstance(a, str):
        if a in dtype_mod._NAME_TO_DTYPE:
            return dtype_mod.convert_dtype(a)
        if a.startswith("gpu"):
            return "cuda" + a[3:]
    if isinstance(a, Place):
        return a.torch_device
    return a


def _index(idx):
    """Paddle indices as torch takes them: lists become index tensors."""
    if isinstance(idx, list):
        return torch.as_tensor(np.asarray(idx))
    if isinstance(idx, tuple):
        return tuple(_index(i) for i in idx)
    return idx


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new Tensor holding a copy of ``data``, on
    ``place``, else on the device of a tensor ``data``, else where
    ``set_device`` says (default the card; with no card and no
    ``set_device("cpu")`` this raises)."""
    return Tensor(data, dtype=dtype, place=place,
                  stop_gradient=stop_gradient)
