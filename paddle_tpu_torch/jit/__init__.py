"""``paddle.jit``: ``to_static``, ``save``, ``load`` (counterpart of
``paddle_tpu/jit/__init__.py``).

Paddle compiles dygraph Python to a static program through an AST
transform and a program cache keyed per input signature
(``python/paddle/jit/api.py`` ``to_static``, ``program_translator.py``).
Here ``torch.compile`` is the tracer and compiler:

- :func:`to_static` wraps a Layer or a function in a
  :class:`StaticFunction`: one ``torch.compile(fullgraph=True,
  dynamic=False)`` per guard key (input shapes, dtypes and devices, and the
  training flag: the reference's key), over the layer's forward with its
  state handed in as plain tensors (``nn.layer.functional_call``). Each key
  compiles its own copy of the entry function, so Dynamo's recompile limit
  (counted per code object) never turns a new signature into an eager run.
  The backend is :data:`DEFAULT_BACKEND` (inductor) unless ``backend=``
  names one. Where Dynamo refuses data-dependent control flow, the function
  is rewritten by ``jit.dy2static`` (``torch.cond`` / ``while_loop``) and
  compiled again; if that fails too it raises, or, with ``fallback=True``
  or ``FLAGS_dy2static_eager_fallback``, warns and runs eagerly. Outputs
  carry no gradient (``stop_gradient=True``), as the reference's do
  (ROADMAP R14): the compiled path serves.
- :func:`save` writes ``<prefix>.pdmodel`` (a ``torch.export`` archive of
  the eval forward, taking the parameters as inputs in Paddle's layouts;
  ``None`` / ``-1`` dims of the input spec export as dynamic,
  ``torch.export.Dim.DYNAMIC``, within the bounds the model itself sets,
  such as Llama's position table),
  ``.pdmodel.txt`` (the program's text), ``.pdiparams`` (the reference's
  pickle ``{"params", "buffers", "in_shapes"}``: numpy arrays by Paddle's
  names and layouts, so either package's ``load(prefix, layer_cls=...)``
  takes the other's) and ``.pdversion``.
- :func:`load` returns a :class:`TranslatedLayer` that runs the exported
  program on the card (or where ``device=`` says) without the model's
  Python, or with ``layer_cls`` rebuilds the layer from ``.pdiparams``.

Every kernel launch is a registered op (``kernels/library.py``), so a
program traces through each kernel, forward and backward, as one node.
"""
from __future__ import annotations

import functools
import os
import pickle
import time
import types
import warnings

import numpy as np
import torch

from .. import telemetry
from ..core.device import resolve_device
from ..telemetry import perf as _perf
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, wrap
from ..framework.io import load_pickle
from ..nn.layer import Layer, functional_call, functional_state

__all__ = ["to_static", "StaticFunction", "save", "load", "TranslatedLayer",
           "not_to_static", "enable_to_static", "DEFAULT_BACKEND",
           "compile_fresh"]

# the torch.compile backend of to_static, the predictor and the static
# Executor when none is named (the CPU tests set "aot_eager")
DEFAULT_BACKEND = "inductor"

_to_static_enabled = True


def enable_to_static(flag: bool):
    global _to_static_enabled
    _to_static_enabled = bool(flag)


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def compile_fresh(fn, tag, backend=None):
    """``torch.compile(fullgraph=True, dynamic=False)`` of a copy of ``fn``
    with a code object of its own: Dynamo counts recompiles (against
    ``torch._dynamo.config.cache_size_limit``) per code object, so each
    caller key that compiles its own copy can never reach the limit and
    fall back to eager."""
    code = fn.__code__.replace(co_name=f"{fn.__code__.co_name}_{tag}")
    copy = types.FunctionType(code, fn.__globals__, code.co_name,
                              fn.__defaults__, fn.__closure__)
    return torch.compile(copy, backend=backend or DEFAULT_BACKEND,
                         fullgraph=True, dynamic=False)


def _plain(a):
    return torch.Tensor.detach(a) if isinstance(a, Tensor) else a


def _signature(a):
    """What a compiled program is specialised on: a tensor's shape, dtype
    and device, any other argument's value."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.dtype, a.device)
    return a


def _wrap_out(out):
    """Outputs as Tensors with ``stop_gradient=True`` (R14)."""
    if isinstance(out, torch.Tensor):
        return wrap(_plain(out))
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap_out(o) for o in out)
    return out


def _dynamo_failure(e):
    """``(kind, exception)`` for an exception raised while Dynamo traced:
    ``"user"`` for an exception the traced code raised (its own
    diagnostics), ``"refused"`` where Dynamo could not trace the code
    (data-dependent control flow and the like), else ``None``."""
    if not isinstance(e, torch._dynamo.exc.TorchDynamoException):
        return None, e
    c = e
    while c is not None:
        name = type(c).__name__
        if name.startswith("Observed") and name != "ObservedException":
            return "user", c
        c = c.__cause__ or c.__context__
    if isinstance(e, (torch._dynamo.exc.Unsupported,
                      torch._dynamo.exc.UserError)):
        return "refused", e
    return None, e


def _first_line(e):
    text = str(e).strip()
    return text.splitlines()[0] if text else type(e).__name__


class _Entry:
    __slots__ = ("compiled", "transform")

    def __init__(self, compiled, transform):
        self.compiled, self.transform = compiled, transform


class StaticFunction:
    """The reference's per-function program cache: one compiled program per
    guard key (input shapes / dtypes / devices and the training flag).

    Data-dependent Python control flow is rewritten by ``jit.dy2static``
    into ``torch.cond`` / ``while_loop`` so it still compiles to ONE graph;
    an eager run happens only behind an explicit opt-in (``fallback=True``
    or ``FLAGS_dy2static_eager_fallback``) and always warns."""

    def __init__(self, fn_or_layer, input_spec=None, build_strategy=None,
                 backend=None, fallback=False):
        self._target = fn_or_layer
        self._input_spec = input_spec
        self._backend = backend
        self._fallback = fallback
        self._cache: dict = {}
        self._transformed_fn = None
        self._needs_transform = False
        self._views = None
        if isinstance(fn_or_layer, torch.nn.Module):
            self._layer = fn_or_layer
        else:
            self._layer = getattr(fn_or_layer, "__self__", None)
        functools.update_wrapper(
            self, fn_or_layer.forward if isinstance(fn_or_layer,
                                                    torch.nn.Module)
            else fn_or_layer)

    # -- keys and inputs ---------------------------------------------------
    def _arrays(self, args):
        """The positional arguments as plain tensors (numbers and arrays as
        tensors on the first tensor argument's device; None as it is)."""
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        return [_plain(a) if isinstance(a, torch.Tensor) or a is None
                else torch.as_tensor(np.asarray(a), device=dev)
                for a in args]

    def _guard_key(self, arrays, kwargs):
        training = self._layer.training if self._layer is not None else False
        return (tuple(_signature(a) for a in arrays) + (training,)
                + tuple((k, _signature(v)) for k, v in sorted(kwargs.items())))

    def _allow_fallback(self):
        if self._fallback:
            return True
        from ..framework.flags import flag_value

        return bool(flag_value("FLAGS_dy2static_eager_fallback"))

    # -- call --------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if not _to_static_enabled:
            return self._eager_call(*args, **kwargs)
        if torch.compiler.is_compiling():
            # inside an enclosing trace (jit.save's export): the Python runs
            # inline as part of that program
            return self._python(self._needs_transform)(*args, **kwargs)
        arrays = self._arrays(args)
        kwargs = {k: _plain(v) for k, v in kwargs.items()}
        key = self._guard_key(arrays, kwargs)
        entry = self._cache.get(key)
        if entry == "eager":
            return self._eager_call(*args, **kwargs)
        if entry is not None:
            return _wrap_out(self._invoke(entry, arrays, kwargs))
        entry = self._build(self._needs_transform)
        t0 = time.monotonic()
        try:
            out = self._invoke(entry, arrays, kwargs)
            self._cache[key] = entry
            self._watch(arrays, t0)
            return _wrap_out(out)
        except Exception as e:       # noqa: BLE001 (classified below)
            kind, _ = _dynamo_failure(e)
            if kind != "refused" or entry.transform:
                raise
        # Dynamo refused the Python (data-dependent control flow): rewrite
        # it through dy2static and compile again
        from . import dy2static

        try:
            entry = self._build(True)
            out = self._invoke(entry, arrays, kwargs)
            self._cache[key] = entry
            self._needs_transform = True
            self._watch(arrays, t0)
            return _wrap_out(out)
        except dy2static.UnsupportedSyntax as e:
            reason = e
        except Exception as e:       # noqa: BLE001 (classified below)
            kind, exc = _dynamo_failure(e)
            if kind is None:
                raise
            reason = exc
        name = getattr(self._target, "__name__", type(self._target).__name__)
        if self._allow_fallback():
            warnings.warn(
                f"to_static: '{name}' uses control flow the dy2static "
                "transform could not compile; running eagerly for this input "
                "signature (every op pays its host dispatch). Reason: "
                f"{_first_line(reason)}", stacklevel=2)
            self._cache[key] = "eager"
            return self._eager_call(*args, **kwargs)
        raise RuntimeError(
            f"to_static: '{name}' uses data-dependent Python control flow "
            f"that could not be compiled ({_first_line(reason)}). Rewrite "
            "with tensor ops (paddle.where / supported if-while-for "
            "patterns), or explicitly opt into eager execution with "
            "to_static(..., fallback=True) or "
            "paddle.set_flags({'FLAGS_dy2static_eager_fallback': True})"
        ) from reason

    def _watch(self, arrays, t0):
        """A new input signature compiled: the compile watcher's
        ``jit.<function>`` entry, its wall the first call (which paid the
        compile)."""
        name = getattr(self._target, "__name__", type(self._target).__name__)
        telemetry.compile_watcher().record_call(
            f"jit.{name}",
            _perf.abstract_signature(
                [a for a in arrays if isinstance(a, torch.Tensor)]),
            wall_s=time.monotonic() - t0)

    def _invoke(self, entry, arrays, kwargs):
        with torch.no_grad():
            if self._layer is not None:
                params, buffers = self._state()
                return entry.compiled(params, buffers, *arrays, **kwargs)
            return entry.compiled(*arrays, **kwargs)

    def _state(self):
        """The layer's ``functional_state``, kept while every parameter and
        buffer is the same object (an in-place update shows through the
        views; a replaced tensor rebuilds them)."""
        if self._views is None or any(
                d.get(n) is not t for d, n, t in self._views[0]):
            owners = [(d, n, t) for m in self._layer.modules()
                      for d in (m._parameters, m._buffers)
                      for n, t in d.items()]
            self._views = (owners, functional_state(self._layer))
        return self._views[1]

    def _eager_call(self, *args, **kwargs):
        return self._python(False)(*args, **kwargs)

    def _python(self, transform):
        """The Python the program is traced from: the original forward /
        function, or its dy2static rewrite."""
        if transform:
            return self._transformed()
        if self._layer is not None:
            orig = getattr(self._layer, "_orig_forward", None)
            return self._layer.forward if orig is None else orig
        return self._target

    def _transformed(self):
        """The dy2static rewrite of the target (cached); a layer's forward
        is rewritten from its function and bound to the layer again."""
        if self._transformed_fn is None:
            from . import dy2static

            if self._layer is not None:
                base = self._python(False)
                self._transformed_fn = types.MethodType(
                    dy2static.transform_function(base), self._layer)
            else:
                self._transformed_fn = dy2static.transform_function(
                    self._target)
        return self._transformed_fn

    def _build(self, transform):
        fn = self._python(transform)
        tag = f"{len(self._cache)}_{int(transform)}_{id(self) & 0xffffff:x}"
        if self._layer is not None:
            layer = self._layer

            def program(params, buffers, *arrays, **kw):
                return functional_call(layer, params, buffers, *arrays,
                                       forward=fn, **kw)[0]
        else:
            def program(*arrays, **kw):
                return fn(*arrays, **kw)
        return _Entry(compile_fresh(program, tag, self._backend), transform)

    @property
    def concrete_programs(self):
        return list(self._cache)

    def rollback(self):
        return self._target


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, fallback=False, **kwargs):
    """``@paddle.jit.to_static`` decorator / wrapper. ``backend``: the
    ``torch.compile`` backend (default :data:`DEFAULT_BACKEND`, inductor).
    ``fallback=True`` is the explicit opt-in for eager execution where
    control flow cannot compile (always warns); the default raises."""

    def deco(fn):
        if isinstance(fn, torch.nn.Module):
            sf = StaticFunction(fn, input_spec, backend=backend,
                                fallback=fallback)
            fn.forward_static = sf
            fn._orig_forward = fn.forward
            # route __call__ through the static function
            fn.forward = lambda *a, **k: sf(*a, **k)
            return fn
        return StaticFunction(fn, input_spec, backend=backend,
                              fallback=fallback)

    if function is not None:
        return deco(function)
    return deco


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _paddle_t_names(layer):
    """The parameters whose Paddle layout is the transpose of torch's: the
    weights of plain ``torch.nn.Linear``s (see ``nn.layer``)."""
    return {name for name, m in layer.named_modules()
            if isinstance(m, torch.nn.Linear) and not isinstance(m, Layer)
            for name in [f"{name}.weight" if name else "weight"]}


def _to_paddle_layout(state, transposed):
    return {k: (v.t() if k in transposed else v) for k, v in state.items()}


class _Program(torch.nn.Module):
    """What ``jit.save`` exports: ``forward(params, buffers, *inputs)`` runs
    the layer's eval forward with the parameters handed in, in Paddle's
    layouts (transposed back inside the graph, a free view). The layer is
    held outside the module's registry, so the archive carries no
    weights."""

    def __init__(self, layer, forward, transposed):
        super().__init__()
        object.__setattr__(self, "_layer", layer)
        object.__setattr__(self, "_forward", forward)
        self._transposed = frozenset(transposed)

    def forward(self, params, buffers, *inputs):
        params = _to_paddle_layout(params, self._transposed)
        return functional_call(self._layer, params, buffers, *inputs,
                               forward=self._forward)[0]


def _spec_example(spec, i, device):
    """An input spec -> ``(example tensor, {dim: Dim} | None, shape
    strings, dtype name)``: ``None`` / ``-1`` dims become
    ``torch.export.Dim.DYNAMIC`` (export keeps the bounds the model sets,
    as a slice of a position table does), traced at size 2."""
    if isinstance(spec, torch.Tensor):
        t = _plain(spec)
        return t, None, tuple(str(s) for s in t.shape), str(t.dtype)
    if isinstance(spec, np.ndarray):
        t = torch.from_numpy(spec).to(device)
        return t, None, tuple(str(s) for s in t.shape), str(t.dtype)
    if isinstance(spec, (tuple, list)) and len(spec) == 2 and \
            isinstance(spec[0], (tuple, list)):
        shape, dtype = spec
    else:                                       # static.InputSpec
        shape, dtype = spec.shape, spec.dtype
    dims, concrete, names = {}, [], []
    for j, s in enumerate(shape):
        if s is None or s == -1:
            dims[j] = torch.export.Dim.DYNAMIC
            concrete.append(2)
            names.append(f"in{i}_d{j}")
        else:
            concrete.append(int(s))
            names.append(str(int(s)))
    dt = convert_dtype(dtype)
    t = torch.zeros(concrete, dtype=dt, device=device)
    return t, (dims or None), tuple(names), str(dt).replace("torch.", "")


def _host_array(t):
    """A tensor for the ``.pdiparams`` pickle: a numpy array (what the JAX
    package reads), or a CPU tensor where numpy has no such dtype
    (bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.clone()
    return t.numpy().copy()


def _as_torch(a, device):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device)


def _without_examples(ep):
    """``ep`` without its example inputs, which ``torch.export.save`` would
    write into the archive: they are the weights, which ``.pdiparams``
    holds."""
    ep.example_inputs = None
    return ep


def save(layer, path, input_spec=None, **configs):
    """``jit.save``: ``<path>.pdmodel`` (the ``torch.export`` archive of the
    eval forward, parameters as inputs), ``.pdmodel.txt``, ``.pdiparams``,
    ``.pdversion``. ``input_spec``: example Tensors / arrays, or ``(shape,
    dtype)`` / ``static.InputSpec`` entries whose ``None`` / ``-1`` dims
    export as dynamic. ``jit.load`` runs the result without the layer's
    Python."""
    from ..framework.op_version import write_version_file

    if input_spec is None:
        raise ValueError("jit.save requires input_spec (shape/dtype "
                         "examples)")
    sf = getattr(layer, "forward_static", None)
    forward = (sf._python(sf._needs_transform) if sf is not None
               else layer.forward)
    params, buffers = functional_state(layer)
    device = next(iter(params.values())).device if params else \
        resolve_device(None)
    specs = [_spec_example(s, i, device) for i, s in enumerate(input_spec)]
    transposed = _paddle_t_names(layer) & set(params)
    p_paddle = _to_paddle_layout(params, transposed)
    program = _Program(layer, forward, transposed)
    modes = [(m, m.training) for m in layer.modules()]
    for m, _ in modes:
        m.training = False
    try:
        with torch.no_grad():
            ep = torch.export.export(
                program, (p_paddle, buffers, *[s[0] for s in specs]),
                dynamic_shapes=({k: None for k in p_paddle},
                                {k: None for k in buffers},
                                tuple(s[1] for s in specs)),
                strict=False)
    finally:
        for m, mode in modes:
            m.training = mode
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(_without_examples(ep), f)
    with open(path + ".pdmodel.txt", "w") as f:
        f.write(str(ep))
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({
            "params": {k: _host_array(v) for k, v in p_paddle.items()},
            "buffers": {k: _host_array(v) for k, v in buffers.items()},
            "in_shapes": [(s[2], s[3]) for s in specs],
        }, f)
    write_version_file(path)


def _load_program(path, device):
    """The exported program of ``<path>.pdmodel`` on ``device``."""
    from torch.export.passes import move_to_device_pass

    from ..framework.op_version import check_compat, read_version_file

    check_compat(read_version_file(path), origin=path)
    with open(path + ".pdmodel", "rb") as f:
        ep = torch.export.load(f)
    return move_to_device_pass(ep, device)


class TranslatedLayer(Layer):
    """``jit.load``'s result: an eval layer over the exported program and
    the saved weights (Paddle's ``TranslatedLayer``); runs without the
    model's Python. Inputs go to the layer's device; outputs are Tensors
    with ``stop_gradient=True``."""

    def __init__(self, program, params, buffers, in_shapes, text, device):
        super().__init__()
        object.__setattr__(self, "_program", program)
        self._params = params
        self._buffers_in = buffers
        self.in_shapes = in_shapes
        self._text = text
        self.device = device
        self.eval()

    def program(self):
        """The exported program's text (Paddle's ``.program()``)."""
        return self._text

    def run_plain(self, *arrays):
        """The program on plain tensors already on the layer's device."""
        with torch.no_grad():
            return self._program(self._params, self._buffers_in, *arrays)

    def forward(self, *args):
        arrays = [_as_torch(_plain(a) if isinstance(a, torch.Tensor) else
                            np.asarray(a), self.device) for a in args]
        return _wrap_out(self.run_plain(*arrays))


def load(path, layer_cls=None, params_file=None, device=None, **configs):
    """``jit.load``: a :class:`TranslatedLayer` over ``<path>.pdmodel`` on
    ``device`` (default the card), or with ``layer_cls`` (a class or a
    ready layer) the layer with the ``.pdiparams`` weights set: this route
    reads either package's files. ``params_file`` overrides
    ``<path>.pdiparams`` (``inference.Config``'s two-file form)."""
    with open(params_file or (path + ".pdiparams"), "rb") as f:
        blob = load_pickle(f)
    if layer_cls is not None:
        layer = layer_cls() if isinstance(layer_cls, type) else layer_cls
        layer.set_state_dict({**blob["params"], **blob["buffers"]})
        layer.eval()
        return layer
    dev = resolve_device(device)
    program = _load_program(path, dev).module()
    text = open(path + ".pdmodel.txt").read() \
        if os.path.exists(path + ".pdmodel.txt") else ""
    params = {k: _as_torch(v, dev) for k, v in blob["params"].items()}
    buffers = {k: _as_torch(v, dev) for k, v in blob["buffers"].items()}
    return TranslatedLayer(program, params, buffers, blob.get("in_shapes"),
                           text, dev)
