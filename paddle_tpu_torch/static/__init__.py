"""``paddle.static``: Program, Executor, Scope and the inference-model files
(counterpart of ``paddle_tpu/static/__init__.py``).

Paddle's static mode builds a program under ``program_guard`` and compiles
it once per feed signature in ``Executor.run``
(``python/paddle/fluid/executor.py`` ``Executor.run`` / ``_ExecutorCache``).
Here:

- Graph capture (``core.capture``): ``static.data`` gives a
  ``StaticTensor``, and everything computed from one is one too, with a
  replay node: the port's ops, functionals and Layer calls one node each
  (a whole Layer call, ERNIE included, is one node), every other torch
  call on it one node each (its ``__torch_function__``). In-place writes
  rebind the written value; host reads of a program value raise.
  ``static.nn``'s control flow records ``cond`` / ``while_loop`` nodes,
  ``gradients`` a node that replays the targets through
  ``torch.func.grad``.
- ``Executor.run`` compiles the replay of the fetch targets ONCE per
  (program, fed names and signatures, fetch set) with
  ``jit.compile_fresh`` (``torch.compile(fullgraph=True, dynamic=False)``,
  a code object per entry) and runs the cached program afterwards;
  ``_trace_count`` counts the compiles. Placeholders, the Scope's
  parameters and the recorded Layers' state enter as inputs (plain
  tensors), so a Scope update takes effect without a recompile.
- ``save_inference_model`` exports the feed -> fetch slice with
  ``torch.export`` in ``jit.save``'s format (the parameters as inputs in
  Paddle's layouts; ``None`` / ``-1`` dims dynamic), which
  ``load_inference_model``, ``jit.load`` and ``inference.create_predictor``
  run without the builder's Python.

The Executor's telemetry hooks wait for the port's telemetry module
(ROADMAP).
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time
import weakref

import numpy as np
import torch

from .. import telemetry
from ..core.device import resolve_device
from ..core.capture import (Node, Ref, build_value, freeze, key_of,
                            next_uid)
from ..core.dtype import convert_dtype
from ..framework.io import load_pickle
from ..core.tensor import StaticTensor, wrap
from ..jit import (_host_array, _paddle_t_names, _to_paddle_layout,
                   _without_examples, compile_fresh)
from ..jit.dy2static import runtime as _jst
from ..nn.layer import functional_call, functional_state

__all__ = [
    "Program", "program_guard", "default_main_program",
    "default_startup_program", "data", "Executor", "InputSpec",
    "name_scope", "gradients", "save", "load", "save_inference_model",
    "load_inference_model", "cpu_places", "device_guard", "Scope",
    "Variable", "global_scope", "scope_guard", "create_parameter",
    "InferenceProgram",
]


class InputSpec:
    """A declared input: ``shape`` (``None`` / ``-1`` for a dynamic dim),
    ``dtype``, ``name``."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name

    @classmethod
    def from_tensor(cls, t, name=None):
        return cls(tuple(t.shape), t.dtype, name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


class Variable:
    """A named value slot of a Scope (Paddle's ``framework/variable.h``);
    the value is a tensor."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def get_tensor(self):
        return self._value

    def set(self, value, place=None):
        if isinstance(value, StaticTensor):
            self._value = build_value(value).detach()
        elif isinstance(value, torch.Tensor):
            self._value = torch.Tensor.detach(value)
        else:
            self._value = torch.as_tensor(np.asarray(value))


class Scope:
    """Name -> Variable tree with parent lookup (Paddle's ``scope.h``):
    ``var`` finds or creates locally, ``find_var`` walks to the root,
    ``new_scope`` opens a child whose lookups fall through."""

    def __init__(self, parent=None):
        self._vars: dict[str, Variable] = {}
        self._parent = parent
        self._kids: list[Scope] = []

    def var(self, name) -> Variable:
        v = self._vars.get(name)
        if v is None:
            v = Variable(name)
            self._vars[name] = v
        return v

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        return None

    def new_scope(self) -> "Scope":
        k = Scope(self)
        self._kids.append(k)
        return k

    def local_var_names(self):
        return list(self._vars)

    def drop_kids(self):
        self._kids.clear()


_state = {"scope": Scope(), "param_uid": 0}


def global_scope() -> Scope:
    return _state["scope"]


@contextlib.contextmanager
def scope_guard(scope):
    prev = _state["scope"]
    _state["scope"] = scope
    try:
        yield
    finally:
        _state["scope"] = prev


class Program:
    """The recorded computation: its named placeholders and parameters;
    the replay nodes recorded on what flows from them are its ops."""

    def __init__(self):
        self._inputs: dict[str, Tensor] = {}
        self._params: dict[str, Tensor] = {}
        self.random_seed = 0

    def global_block(self):
        return self

    def all_parameters(self):
        return list(self._params.values())

    def clone(self, for_test=False):
        return self

    def __repr__(self):
        return (f"Program(inputs={list(self._inputs)}, "
                f"params={list(self._params)})")


_programs = {"main": Program(), "startup": Program()}


def default_main_program():
    return _programs["main"]


def default_startup_program():
    return _programs["startup"]


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev = dict(_programs)
    _programs["main"] = main_program
    if startup_program is not None:
        _programs["startup"] = startup_program
    try:
        yield
    finally:
        _programs.update(prev)


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


@contextlib.contextmanager
def device_guard(device=None):
    yield


def cpu_places(device_count=None):
    from ..core.device import CPUPlace

    return [CPUPlace()]


# placeholders, parameters and loop variables by their key: their
# build-time values are what a build-time replay starts from
_BUILD: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _placeholder(value, key, name=None, declared=None):
    """``value`` (a fresh tensor) as the StaticTensor ``key``."""
    value.__class__ = StaticTensor
    value.name = name
    value._static = value._origin = key
    value._declared_shape = declared
    _BUILD[key] = value
    return value


def data(name, shape, dtype="float32", lod_level=0):
    """``static.data``: a named placeholder of the current Program. It holds
    zeros of the declared shape (``None`` / ``-1`` dims as 1) on the card
    (or where ``set_device`` says), so the ops applied to it run at build
    time while they record their replay; ``Executor.run`` replays them on
    the fed values. The declared shape drives ``save_inference_model``'s
    dynamic dims."""
    declared = tuple(shape)
    concrete = [1 if (s is None or s == -1) else int(s) for s in shape]
    v = _placeholder(torch.zeros(concrete, dtype=convert_dtype(dtype),
                                 device=resolve_device(None)),
                     ("feed", name), name, declared)
    _programs["main"]._inputs[name] = v
    return v


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """``static.create_parameter``: a trainable variable of the current
    Program, living in the global Scope. It enters compiled programs as an
    input, so a Scope update (``static.load``, ``scope.var(n).set``)
    changes what later runs compute without a recompile. Initialised by
    ``default_initializer(shape)``, else zeros for a bias or an integer
    dtype, else Xavier-uniform (the reference's)."""
    if name is None:
        # process-wide counter: default-named parameters of different
        # Programs share the global Scope and must not collide
        name = f"param_{_state['param_uid']}"
        _state["param_uid"] += 1
    shape = tuple(int(s) for s in shape)
    dt = convert_dtype(dtype)
    if default_initializer is not None:
        init = torch.as_tensor(np.asarray(default_initializer(shape)),
                               dtype=dt)
    elif is_bias or not dt.is_floating_point:
        init = torch.zeros(shape, dtype=dt)
    else:
        from ..framework.random import get_generator

        fan_in = shape[0] if shape else 1
        fan_out = shape[-1] if len(shape) > 1 else 1
        limit = float(np.sqrt(6.0 / max(fan_in + fan_out, 1)))
        init = (torch.rand(shape, generator=get_generator(
            torch.device("cpu"))) * 2 - 1) * limit
        init = init.to(dt)
    v = _placeholder(init.to(resolve_device(None)), ("param", name), name,
                     shape)
    v.stop_gradient = False
    _programs["main"]._params[name] = v
    global_scope().var(name).set(v)
    return v


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

class _Env:
    """Values of a replay: ``seeds`` (placeholders, parameters, loop
    variables by key), ``memo`` (the seeds and every node output computed
    so far), ``layers`` (node uid -> the recorded Layer's plain state).
    ``build`` resolves unseeded placeholders to their build-time values."""

    def __init__(self, seeds, layers=None, build=False):
        self.seeds = seeds
        self.memo = dict(seeds)
        self.layers = layers or {}
        self.build = build

    def child(self, extra=None):
        """An env that sees this one's values and adds ``extra`` seeds (a
        loop body's or a branch's own scope: what it computes stays
        there)."""
        env = _Env({**self.seeds, **(extra or {})}, self.layers, self.build)
        env.memo = {**self.memo, **(extra or {})}
        return env


def _ref(t):
    """What the replay resolves for ``t``: a :class:`Ref` for a program
    value (its binding now), else ``t`` (a constant)."""
    return Ref(t._static) if isinstance(t, StaticTensor) else t


def _value(r, env):
    """The value of ``r`` (a :class:`Ref`, or a constant as it is) in the
    replay ``env``."""
    if not isinstance(r, Ref):
        return r
    st = r.st
    key = key_of(st)
    if key in env.memo:
        return env.memo[key]
    if isinstance(st[0], str):
        t = _BUILD.get(st) if env.build else None
        if t is not None:
            return build_value(t)
        raise ValueError(f"static replay: {st[0]} {st[1]!r} has no value")
    return _run(st[0], env)[st[1]]


def _resolve(a, env):
    if isinstance(a, Ref):
        return _value(a, env)
    t = type(a)
    if t is list or t is tuple:
        return t(_resolve(e, env) for e in a)
    if t is dict:
        return {k: _resolve(v, env) for k, v in a.items()}
    return a


def _run(node, env):
    """Run one node in ``env``; its outputs go to the memo."""
    if isinstance(node, Node):
        def call(fn, args, kwargs):
            if node.layer is not None and node.uid in env.layers:
                params, buffers = env.layers[node.uid]
                return functional_call(node.layer, params, buffers, *args,
                                       **kwargs)[0]
            return fn(*args, **kwargs)

        outs = node.outputs(_resolve(node.args, env),
                            _resolve(node.kwargs, env), call)
    else:
        outs = list(node.run(env))
    for i, o in enumerate(outs):
        env.memo[(node.uid, i)] = o
    return outs


class _CondNode:
    """``static.nn.cond``: both branches recorded at build time; the replay
    lowers to ``torch.cond`` on a traced predicate."""

    def __init__(self, pred, true_outs, false_outs):
        self.uid = next_uid()
        self.pred = freeze(pred)
        self.true_outs, self.false_outs = freeze(true_outs), freeze(
            false_outs)

    def deps(self):
        return [self.pred, *self.true_outs, *self.false_outs]

    def run(self, env):
        def side(outs):
            return lambda: tuple(_value(o, env.child()) for o in outs)

        return _jst.convert_ifelse(_value(self.pred, env),
                                   side(self.true_outs),
                                   side(self.false_outs))


class _WhileNode:
    """``static.nn.while_loop``: the condition and the body recorded once at
    build time over loop-variable placeholders; the replay lowers to
    ``while_loop`` on a traced condition."""

    def __init__(self, init, keys, cond_out, body_outs):
        self.uid = next_uid()
        self.init, self.keys = freeze(init), keys
        self.cond_out, self.body_outs = freeze(cond_out), freeze(body_outs)

    def deps(self):
        return [*self.init, self.cond_out, *self.body_outs]

    def run(self, env):
        def bind(vs):
            return env.child(dict(zip(self.keys, vs)))

        def cond_fn(*vs):
            return _value(self.cond_out, bind(vs))

        def body_fn(*vs):
            e = bind(vs)
            return tuple(_value(o, e) for o in self.body_outs)

        init = tuple(_value(v, env) for v in self.init)
        return list(_jst.convert_while(cond_fn, body_fn, init))


class _GradNode:
    """``static.gradients``: the targets replayed from the seeds as a
    function of the inputs, differentiated with ``torch.func.grad`` (inside
    the compiled program). An input is a program value (a placeholder's or
    a program parameter's descendant) or a parameter of a Layer the program
    calls (Paddle's ``gradients(loss, model.parameters())``): that one is
    handed to the recorded Layer calls that hold it, in place of their
    state's entry."""

    def __init__(self, targets, inputs, target_gradients):
        self.uid = next_uid()
        self.targets, self.tgrads = freeze(targets), freeze(target_gradients)
        self.inputs = [freeze(i) if isinstance(i, StaticTensor) else i
                       for i in inputs]
        self.slots = self._slots()

    def deps(self):
        return [*self.targets, *self.inputs, *self.tgrads]

    def _slots(self):
        """``{index of a Layer-parameter input: [(layer node, name)]}``:
        where each such input sits in the recorded Layer calls the targets
        depend on."""
        wanted = {id(i): k for k, i in enumerate(self.inputs)
                  if not isinstance(i, Ref)}
        slots = {k: [] for k in wanted.values()}
        for node in (_walk(self.targets)[2] if wanted else ()):
            for name, p in torch.nn.Module.named_parameters(node.layer):
                if id(p) in wanted:
                    slots[wanted[id(p)]].append((node, name))
        for k, where in slots.items():
            if not where:
                raise ValueError(
                    f"static.gradients: input {k} is neither a program "
                    f"value nor a parameter of a Layer the targets call")
        return slots

    def run(self, env):
        slots = self.slots

        def state(node):
            return env.layers.get(node.uid) or functional_state(node.layer)

        ivals = [_value(i, env) if isinstance(i, Ref) else
                 state(slots[k][0][0])[0][slots[k][0][1]]
                 for k, i in enumerate(self.inputs)]
        gvals = [None if g is None else
                 _value(g, env) if isinstance(g, (Ref, torch.Tensor))
                 else torch.as_tensor(np.asarray(g)) for g in self.tgrads]
        keys = {k: key_of(i.st) for k, i in enumerate(self.inputs)
                if isinstance(i, Ref)}

        def f(*iv):
            # Dynamo (torch 2.11-2.13) drops an autograd.Function's backward
            # when a grad input reaches it unchanged, leaving the registered
            # op's forward without a derivative; an alias of each input
            # keeps it
            iv = [v.view_as(v) for v in iv]
            # from the seeds only: memoized intermediates were computed from
            # the inputs' own values and would make the targets constants
            layers = dict(env.layers)
            for k, where in slots.items():
                for node, name in where:
                    params, buffers = layers.get(node.uid) or state(node)
                    layers[node.uid] = ({**params, name: iv[k]}, buffers)
            e = _Env(dict(env.seeds), layers, env.build)
            e.memo.update((key, iv[k]) for k, key in keys.items())
            total = None
            for t, g in zip(self.targets, gvals):
                tv = _value(t, e)
                term = (tv * g).sum() if g is not None else tv.sum()
                total = term if total is None else total + term
            return total

        return list(torch.func.grad(f, argnums=tuple(range(len(ivals))))(
            *ivals))


def _walk(fetches):
    """``(feed names, {parameter name: its StaticTensor}, Layer nodes)``
    the fetches (:class:`Ref` s) depend on (Paddle prunes the program to
    its fetches' dependencies)."""
    feeds, params, layers, seen = [], {}, [], set()
    stack = list(fetches)
    while stack:
        t = stack.pop()
        if isinstance(t, (list, tuple)):
            stack.extend(t)
            continue
        if isinstance(t, dict):
            stack.extend(t.values())
            continue
        if not isinstance(t, Ref):
            continue
        st = t.st
        if isinstance(st[0], str):
            if st[0] == "feed" and st[1] not in feeds:
                feeds.append(st[1])
            elif st[0] == "param":
                params.setdefault(st[1], _BUILD[st])
            continue
        node = st[0]
        if node.uid in seen:
            continue
        seen.add(node.uid)
        if isinstance(node, Node):
            if node.layer is not None:
                layers.append(node)
            stack.extend(node.args)
            stack.append(node.kwargs)
        else:
            stack.extend(node.deps())
    return feeds, params, layers


def _record_outputs(node, build_outs):
    """Tensors for a control-flow / gradient node's outputs: build-time
    values with ``_static = (node, i)``."""
    outs = []
    for i, v in enumerate(build_outs):
        t = torch.Tensor.detach(torch.as_tensor(v)).clone()
        t.__class__ = StaticTensor
        t._static = (node, i)
        outs.append(t)
    return outs


def gradients(targets, inputs, target_gradients=None):
    """``static.gradients``: gradients of the sum of ``targets`` (each times
    its ``target_gradients`` entry) with respect to ``inputs`` (program
    values, or parameters of the Layers the program calls), recorded
    into the program: fetching them differentiates the compiled program at
    the fed values (Paddle's ``append_backward`` role)."""
    tlist = list(targets) if isinstance(targets, (list, tuple)) else [targets]
    ilist = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is None:
        glist = [None] * len(tlist)
    else:
        glist = (list(target_gradients)
                 if isinstance(target_gradients, (list, tuple))
                 else [target_gradients])
    for i in ilist:
        if not isinstance(i, torch.Tensor):
            raise ValueError("static.gradients: every input must flow from "
                             "a placeholder or a parameter of the program, "
                             "or be a parameter of a Layer it calls")
    node = _GradNode(tlist, ilist, glist)
    return _record_outputs(node, node.run(_Env({}, build=True)))


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class _FetchTarget:
    """An opaque fetch token of ``load_inference_model`` (Paddle's
    fetch_targets variables)."""

    def __init__(self, name, index):
        self.name = name
        self.index = index

    def __repr__(self):
        return f"FetchTarget({self.name})"


def _as_device(v, device):
    if isinstance(v, torch.Tensor):
        return torch.Tensor.detach(v).to(device)
    return torch.as_tensor(np.asarray(v)).to(device)


def _host(v, return_numpy):
    if return_numpy:
        v = torch.Tensor.detach(v)
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return wrap(torch.Tensor.detach(v))


def _param_value(name, param, scope):
    """A parameter's value: the Scope's, else its build-time value; on the
    parameter's device."""
    var = scope.find_var(name)
    if var is not None and var._value is not None:
        return var._value.to(param.device)
    return build_value(param).detach()


_EXEC_METRICS = None


def _exec_metrics():
    """Executor-cache counters (resolved at first use)."""
    global _EXEC_METRICS
    if _EXEC_METRICS is None:
        reg = telemetry.registry()
        _EXEC_METRICS = (
            reg.counter("static_executor_cache_hits_total",
                        "Executor.run served from the compiled-trace cache"),
            reg.counter("static_executor_cache_misses_total",
                        "Executor.run (re)compiles (cache miss or cache "
                        "bypassed)"),
        )
    return _EXEC_METRICS


class Executor:
    """``paddle.static.Executor``: compiles the replay of the fetch targets
    once per (program, fed names and signatures, fetch set) and caches it
    (Paddle's ``Executor.run`` -> ``_ExecutorCache``). ``_trace_count``
    counts compiles, so a test can prove a second run reuses the
    program."""

    def __init__(self, place=None):
        self.place = place
        self._cache: dict = {}
        self._trace_count = 0

    def close(self):
        self._cache.clear()

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        program = program or _programs["main"]
        feed = feed or {}
        fetch_list = list(fetch_list) if fetch_list is not None else []
        if isinstance(program, InferenceProgram):
            return program._run(feed, fetch_list, return_numpy)
        scope = scope or global_scope()
        unknown = sorted(set(feed) - set(program._inputs))
        if unknown:
            raise ValueError(
                f"Executor.run: feed name(s) {unknown} are not placeholders "
                f"of this program (has: {sorted(program._inputs)}); Paddle "
                "raises on unknown feed variables too")
        fetch_ts = [f for f in fetch_list if isinstance(f, torch.Tensor)]
        # what each fetch is now (an in-place write may have rebound it)
        targets = freeze(tuple(fetch_ts))
        feeds, params, layers = _walk(targets)
        missing = sorted(n for n in feeds if n not in feed)
        if missing:
            raise ValueError(
                f"Executor.run: fetch targets depend on placeholder(s) "
                f"{missing} which are not in the feed")
        feeds = sorted(feeds)
        fvals = {("feed", n): _as_device(feed[n], program._inputs[n].device)
                 for n in feeds}
        pvals = {("param", n): _param_value(n, params[n], scope)
                 for n in sorted(params)}
        lstate = {node.uid: functional_state(node.layer) for node in layers}
        key = (id(program), tuple(feeds),
               tuple((tuple(v.shape), v.dtype, v.device)
                     for v in fvals.values()),
               tuple(key_of(r.st) if isinstance(r, Ref) else id(f)
                     for r, f in zip(targets, fetch_ts)))
        compiled = self._cache.get(key) if use_program_cache else None
        new = compiled is None
        if new:
            _exec_metrics()[1].inc()
            self._trace_count += 1

            def program_fn(seeds, layer_state):
                env = _Env(seeds, layer_state)
                return tuple(_value(t, env) for t in targets)

            compiled = compile_fresh(
                program_fn, f"{self._trace_count}_{id(self) & 0xffffff:x}")
            if use_program_cache:
                self._cache[key] = compiled
        else:
            _exec_metrics()[0].inc()
        t0 = time.monotonic()
        with torch.no_grad():
            outs = compiled({**fvals, **pvals}, lstate)
        # the compile watcher sees one signature per (feed shapes/dtypes);
        # a new one's wall time is the first call, which pays the compile
        telemetry.compile_watcher().record_call(
            "static.Executor",
            tuple((n[1], tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for n, v in fvals.items()),
            wall_s=(time.monotonic() - t0) if new else None)
        by_id = {id(t): v for t, v in zip(fetch_ts, outs)}
        return [_host(by_id[id(f)], return_numpy)
                if isinstance(f, torch.Tensor) else f for f in fetch_list]


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def save(program, model_path, protocol=4):
    """``static.save``: the program's parameters from the Scope ->
    ``<path>.pdparams`` (numpy arrays by name)."""
    scope = global_scope()
    state = {n: _host_array(_param_value(n, p, scope))
             for n, p in program._params.items()}
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(state, f, protocol=protocol)


def load(program, model_path, executor=None, var_list=None):
    """``static.load``: parameters back into the Scope; compiled programs
    stay valid (parameters are inputs)."""
    with open(model_path + ".pdparams", "rb") as f:
        state = load_pickle(f)
    keep = None if var_list is None else {getattr(v, "name", v)
                                          for v in var_list}
    scope = global_scope()
    for n, v in state.items():
        if keep is None or n in keep:
            scope.var(n).set(v if isinstance(v, torch.Tensor)
                             else np.asarray(v))
    return state


class _StaticProgram(torch.nn.Module):
    """What ``save_inference_model`` exports:
    ``forward(params, buffers, *feeds)`` replays the fetch targets, the
    program's parameters and the recorded Layers' state handed in by name
    (``layer<k>.<name>``, Paddle's layouts)."""

    def __init__(self, feed_keys, fetches, param_names, layers):
        super().__init__()
        object.__setattr__(self, "_fetches", tuple(fetches))
        object.__setattr__(self, "_layers", layers)
        self._feed_keys = list(feed_keys)
        self._param_names = list(param_names)

    def forward(self, params, buffers, *feeds):
        seeds = dict(zip(self._feed_keys, feeds))
        seeds.update({("param", n): params[n] for n in self._param_names})
        state = {}
        for k, (node, transposed) in enumerate(self._layers):
            pre = f"layer{k}."
            p = {n[len(pre):]: v for n, v in params.items()
                 if n.startswith(pre)}
            b = {n[len(pre):]: v for n, v in buffers.items()
                 if n.startswith(pre)}
            state[node.uid] = (_to_paddle_layout(p, transposed), b)
        env = _Env(seeds, state)
        return tuple(_value(t, env) for t in self._fetches)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         program=None, **kwargs):
    """The feed -> fetch slice as ``jit.save``'s four files: a
    ``torch.export`` program (placeholders' ``None`` / ``-1`` dims
    dynamic), the parameters (the Scope's and the recorded Layers', in
    Paddle's layouts), its text and ``.pdversion``. ``load_inference_model``,
    ``jit.load`` and ``inference.create_predictor`` run it without the
    builder's Python."""
    from ..framework.op_version import write_version_file

    program = program or _programs["main"]
    feed_vars = list(feed_vars) if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = list(fetch_vars) if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    scope = global_scope()
    fetches = freeze(tuple(fetch_vars))
    _, pnames, layer_nodes = _walk(fetches)
    params = {n: _param_value(n, pnames[n], scope) for n in sorted(pnames)}
    buffers, layers = {}, []
    for k, node in enumerate(layer_nodes):
        p, b = functional_state(node.layer)
        transposed = _paddle_t_names(node.layer) & set(p)
        layers.append((node, transposed))
        params.update({f"layer{k}.{n}": v for n, v in
                       _to_paddle_layout(p, transposed).items()})
        buffers.update({f"layer{k}.{n}": v for n, v in b.items()})
    examples, dims, in_shapes = [], [], []
    for i, v in enumerate(feed_vars):
        declared = getattr(v, "_declared_shape", None) or tuple(v.shape)
        d, concrete, names = {}, [], []
        for j, s in enumerate(declared):
            if s is None or s == -1:
                d[j] = torch.export.Dim.DYNAMIC
                concrete.append(2)
                names.append(f"feed{i}_d{j}")
            else:
                concrete.append(int(s))
                names.append(str(int(s)))
        examples.append(torch.zeros(concrete, dtype=v.dtype,
                                    device=v.device))
        dims.append(d or None)
        in_shapes.append((tuple(names),
                          str(v.dtype).replace("torch.", "")))
    module = _StaticProgram(
        [key_of(getattr(v, "_origin", None) or v._static)
         for v in feed_vars], fetches, sorted(pnames), layers)
    with torch.no_grad():
        ep = torch.export.export(
            module, (params, buffers, *examples),
            dynamic_shapes=({k: None for k in params},
                            {k: None for k in buffers}, tuple(dims)),
            strict=False)
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    feed_names = [getattr(v, "name", None) or f"feed_{i}"
                  for i, v in enumerate(feed_vars)]
    with open(path_prefix + ".pdmodel", "wb") as f:
        torch.export.save(_without_examples(ep), f)
    with open(path_prefix + ".pdmodel.txt", "w") as f:
        f.write(str(ep))
    with open(path_prefix + ".pdiparams", "wb") as f:
        pickle.dump({
            "params": {k: _host_array(v) for k, v in params.items()},
            "buffers": {k: _host_array(v) for k, v in buffers.items()},
            "in_shapes": in_shapes, "feed_names": feed_names,
            "fetch_names": [f"fetch_{i}" for i in range(len(fetch_vars))],
        }, f)
    write_version_file(path_prefix)


class InferenceProgram:
    """A loaded feed -> fetch program (``load_inference_model``), run through
    ``Executor.run`` like a built Program."""

    def __init__(self, layer, feed_names, fetch_names):
        self._layer = layer
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)

    def program_text(self):
        return self._layer.program()

    def _run(self, feed, fetch_list, return_numpy):
        args = [_as_device(feed[n], self._layer.device)
                for n in self.feed_names]
        outs = self._layer.run_plain(*args)
        by_name = dict(zip(self.fetch_names, outs))
        sel = fetch_list or [_FetchTarget(n, i)
                             for i, n in enumerate(self.fetch_names)]
        return [_host(by_name[f.name if isinstance(f, _FetchTarget) else f],
                      return_numpy) for f in sel]


def load_inference_model(path_prefix, executor, device=None, **kwargs):
    """``[InferenceProgram, feed_names, fetch_targets]`` of a
    ``save_inference_model`` artifact, on ``device`` (default the card)."""
    from ..jit import load as jit_load

    with open(path_prefix + ".pdiparams", "rb") as f:
        blob = load_pickle(f)
    layer = jit_load(path_prefix, device=device)
    prog = InferenceProgram(layer, blob["feed_names"], blob["fetch_names"])
    fetch_targets = [_FetchTarget(n, i)
                     for i, n in enumerate(blob["fetch_names"])]
    return [prog, list(blob["feed_names"]), fetch_targets]


from . import nn  # noqa: E402,F401  (static.nn builders and control flow)
