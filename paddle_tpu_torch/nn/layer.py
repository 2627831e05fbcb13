"""``nn.Layer`` (counterpart of ``paddle_tpu/nn/layer.py``): Paddle's module
base over ``torch.nn.Module``.

Every port layer and model derives from :class:`Layer` (as a mixin beside
``torch.nn.Sequential`` / ``ModuleList``). What it adds to torch's module:

- every parameter is the port's :class:`Parameter` (so
  ``p.stop_gradient = True`` freezes it): a ``torch.nn.Parameter`` set on
  a Layer, or living in a plain torch module set on one, becomes one in
  place (its object, storage and identity kept);
- ``__call__`` hands back :class:`Tensor`\\ s when a Tensor came in, and
  plain tensors when plain tensors came in. A ``forward`` of the port's or
  torch's code (written against torch's forms of the methods) is handed
  plain tensors over the same data and graph; a ``forward`` written
  elsewhere (a user's, against Paddle's forms) is handed Tensors;
- ``state_dict()``, ``set_state_dict()`` and ``load_state_dict()`` give
  and take the reference's names AND layouts: a plain ``torch.nn.Linear``
  inside an older model stores its weight ``[out, in]``, Paddle ``[in,
  out]``, so exactly those weights are transposed on the way out and back
  (the port's own ``nn.Linear`` stores ``[in, out]``); a file either
  package writes loads into the other, and ``load_state_dict`` takes what
  ``state_dict`` gives, however it was called. torch's layout is
  ``nn.Module.state_dict(layer)``; the calls torch makes on child modules
  (``prefix=``) keep it;
- Paddle's names: ``create_parameter``, ``add_parameter``,
  ``add_sublayer``, ``register_buffer(persistable=)``,
  ``register_forward_post_hook``, ``sublayers``, ``clear_gradients``,
  ``to(device, dtype)`` with Paddle's spellings, ``parameters()`` as a
  list.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.tensor import (Parameter, Tensor, _user_in, plain, plain_args,
                           uncut, wrap)

__all__ = ["Layer", "ParameterList", "paddle_state_dict",
           "set_paddle_state_dict", "adopt_parameters"]

_NNParameter = nn.Parameter


def adopt_parameters(module: nn.Module) -> nn.Module:
    """Turn every ``torch.nn.Parameter`` of ``module`` (and its submodules)
    into the port's :class:`Parameter` in place, and mark the weights of
    plain ``torch.nn.Linear``\\ s, whose Paddle layout is their transpose
    (the optimizer's state file transposes their moments too)."""
    for m in module.modules():
        for name, p in m._parameters.items():
            if p is None:
                continue
            if type(p) is _NNParameter:
                p.__class__ = Parameter
            if isinstance(m, nn.Linear) and name == "weight":
                p._paddle_t = True
    return module


def _paddle_t(module: nn.Module, name: str) -> bool:
    owner, _, leaf = name.rpartition(".")
    if leaf != "weight":
        return False
    try:
        return isinstance(module.get_submodule(owner), nn.Linear)
    except AttributeError:
        return False


def paddle_state_dict(module: nn.Module, structured_name_prefix=""):
    """``module``'s parameters and persistable buffers by Paddle's names in
    Paddle's layouts, as Tensors that share the module's storage."""
    out = OrderedDict()
    for name, t in nn.Module.state_dict(module, keep_vars=True).items():
        if not isinstance(t, torch.Tensor):
            continue
        v = t.detach()
        if _paddle_t(module, name):
            v = v.t()
        out[structured_name_prefix + name] = wrap(v)
    return out


def set_paddle_state_dict(module: nn.Module, state_dict):
    """Load a Paddle state dict (tensors or arrays, from either package)
    into ``module``: each value is transposed where :func:`paddle_state_dict`
    transposes, cast to the target's dtype and copied onto its device; a
    shape mismatch raises ``ValueError``. Returns ``(missing,
    unexpected)`` name lists."""
    unexpected = set(state_dict)
    missing = []
    own = nn.Module.state_dict(module, keep_vars=True)
    with torch.no_grad():
        for name, tgt in own.items():
            if not isinstance(tgt, torch.Tensor):
                continue
            if name not in state_dict:
                missing.append(name)
                continue
            unexpected.discard(name)
            src = state_dict[name]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src))
            src = torch.Tensor.detach(src)          # a plain tensor
            if _paddle_t(module, name):
                src = src.t()
            if tuple(src.shape) != tuple(tgt.shape):
                raise ValueError(
                    f"set_state_dict: {name} has shape {tuple(src.shape)}, "
                    f"the layer's is {tuple(tgt.shape)}")
            torch.Tensor.copy_(tgt, src.to(tgt.device, tgt.dtype))
    return missing, sorted(unexpected)


def _as_tensor(a):
    """What a user's ``forward`` or hook is handed for ``a``: a Tensor (a
    view of a plain tensor; detached where ``stop_gradient`` cut it)."""
    if type(a) is torch.Tensor:
        return wrap(torch.Tensor.view_as(a, a))
    if type(a) in (list, tuple):
        return type(a)(_as_tensor(e) for e in a)
    return uncut(a)


class _ParameterList(list):
    """What ``Layer.parameters()`` returns: Paddle's list that is also
    torch's iterator (``next(layer.parameters())``)."""

    def __next__(self):
        if "_it" not in self.__dict__:
            self._it = iter(self)
        return next(self._it)


class Layer(nn.Module):
    """Paddle's ``nn.Layer``: subclass it, set layers and parameters as
    attributes and write ``forward``."""

    # forward is the port's or torch's code (see __call__)
    _plain_inward = True

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        module = getattr(cls.forward, "__module__", None) or ""
        cls._plain_inward = module.partition(".")[0] in (
            "paddle_tpu_torch", "torch")

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- registration ------------------------------------------------------
    def __setattr__(self, name, value):
        if type(value) is _NNParameter:
            value.__class__ = Parameter
        elif isinstance(value, nn.Module) and not isinstance(value, Layer):
            adopt_parameters(value)
        super().__setattr__(name, value)

    def register_parameter(self, name, param):
        if type(param) is _NNParameter:
            param.__class__ = Parameter
        super().register_parameter(name, param)

    def add_module(self, name, module):
        if module is not None and not isinstance(module, Layer):
            adopt_parameters(module)
        super().add_module(name, module)

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        """A :class:`Parameter` drawn by ``default_initializer`` (default:
        ``Constant(0)`` for a bias, else ``XavierUniform``)."""
        from . import initializer as I

        dt = convert_dtype(dtype) if dtype is not None else self._dtype
        init = default_initializer or (I.Constant(0.0) if is_bias
                                       else I.XavierUniform())
        data = init(tuple(int(s) for s in shape), dt,
                    device=resolve_device(device))
        return Parameter(data)

    # -- traversal ---------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        return _ParameterList(super().parameters(
            include_sublayers if recurse is None else recurse))

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # -- state dict --------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=False):
        """Paddle's ``state_dict``: the reference's names and layouts, for
        any call a user makes (``keep_vars=`` too: the values share the
        layer's storage either way). torch's own recursion into a child
        (``prefix=``) gets torch's."""
        if prefix is not None:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        out = paddle_state_dict(self, structured_name_prefix)
        if destination is not None:
            destination.update(out)
            return destination
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        return set_paddle_state_dict(self, state_dict)

    load_dict = set_state_dict

    def load_state_dict(self, state_dict, strict=True, assign=False):
        """torch's name and return value over :meth:`set_state_dict`: a
        Paddle state dict; with ``strict``, a missing or unexpected name
        raises ``RuntimeError``."""
        missing, unexpected = set_paddle_state_dict(self, state_dict)
        if strict and (missing or unexpected):
            raise RuntimeError(f"{type(self).__name__}.load_state_dict: "
                               f"missing {missing}, unexpected {unexpected}")
        return nn.modules.module._IncompatibleKeys(missing, unexpected)

    # -- modes, dtype, device ----------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        if isinstance(device, str) and device.startswith("gpu"):
            device = "cuda" + device[3:]
        if isinstance(device, (str, torch.dtype)) and \
                str(device).replace("torch.", "") in (
                    "float16", "bfloat16", "float32", "float64"):
            device, dtype = None, device
        if dtype is not None:
            kwargs["dtype"] = convert_dtype(dtype)
        if device is not None:
            kwargs["device"] = device
        return super().to(**kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- hooks -------------------------------------------------------------
    def register_forward_pre_hook(self, hook, **kwargs):
        """``hook(layer, inputs)`` sees Tensors; what it returns replaces
        the inputs. Returns a handle with ``remove()``."""
        if self._plain_inward and not kwargs:
            user = hook

            def hook(layer, inputs):
                return plain(user(layer, _as_tensor(inputs)))

        return super().register_forward_pre_hook(hook, **kwargs)

    def register_forward_hook(self, hook, **kwargs):
        if self._plain_inward and not kwargs:
            user = hook

            def hook(layer, inputs, outputs):
                return plain(user(layer, _as_tensor(inputs),
                                  _as_tensor(outputs)))

        return super().register_forward_hook(hook, **kwargs)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` sees Tensors; what it returns
        replaces the outputs. Returns a handle with ``remove()``."""
        return self.register_forward_hook(hook)

    # -- call --------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        # torch's Module.__call__ without its own frame (the host-bound
        # paths call this ~200 times a forward)
        call = self._compiled_call_impl or self._call_impl
        if not self._plain_inward:
            args = tuple(_as_tensor(a) for a in args)
            kwargs = {k: _as_tensor(v) for k, v in kwargs.items()}
            return wrap(call(*args, **kwargs))
        # has_user_tensor, inline: the hot path
        for a in (*args, *kwargs.values()) if kwargs else args:
            t = type(a)
            if t is Tensor or ((t is list or t is tuple) and _user_in(a)):
                break
        else:
            return call(*args, **kwargs)
        args, kwargs = plain_args(args, kwargs)
        return wrap(call(*args, **kwargs))

    def full_name(self):
        return self._name_scope

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()


class ParameterList(Layer):
    """Parameters by position (named ``"0"``, ``"1"``, ...)."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

