"""Global flags (counterpart of ``paddle_tpu/framework/flags.py``; Paddle's
``paddle.set_flags`` / ``get_flags`` over its exported gflags).

One typed in-process registry, seeded from ``FLAGS_*`` environment
variables (Paddle's environment override), with unknown names raising, as
Paddle enforces. Only the flags the port acts on are registered:

- ``FLAGS_dy2static_eager_fallback``: let ``jit.to_static`` run a function
  eagerly, with a warning, where its control flow cannot be compiled;
- ``FLAGS_cudnn_deterministic``: wired to
  ``torch.backends.cudnn.deterministic`` (and cuDNN's benchmark mode off);
- ``FLAGS_check_nan_inf``: every eager op checks its outputs and raises
  on a NaN or an Inf with the op's name (``core.dispatch``);
- ``FLAGS_benchmark``: every eager op synchronises its outputs' device;
- ``FLAGS_fault_plan``: a fault plan (``utils.faults`` grammar,
  ``site:kind[=arg][@start][xcount][%prob]``, ``;``-separated) that every
  ``faults.inject`` site consults while no plan is activated in code;
- ``FLAGS_locksan``: arm LockSan (``analysis.locksan``): locks made after
  it is set record their acquisition order and report inversions and
  blocking calls under a lock (set it in the environment at process start
  so module-level locks are made armed);
- ``FLAGS_collective_timeout_s``: a collective of ``distributed.collective``
  that has not completed after this many seconds raises
  ``CollectiveTimeoutError`` naming the op, the group and the rank (0, the
  default: no guard).

The JAX package's other flags (the Pallas policy, the allocator
strategy) wait for the modules that would act on them (ROADMAP) and raise
as unknown until then.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

__all__ = ["set_flags", "get_flags", "register_flag", "flag_value"]


@dataclass
class _Flag:
    name: str
    default: object
    doc: str
    on_set: object = None
    value: object = None

    def __post_init__(self):
        self.value = self.default


_REGISTRY: dict[str, _Flag] = {}


def register_flag(name: str, default, doc: str = "", on_set=None):
    """Declare a flag; the environment variable of the same name overrides
    the default. ``on_set(value)`` runs whenever the value is set (the
    environment's value included)."""
    flag = _Flag(name, default, doc, on_set)
    env = os.environ.get(name)
    if env is not None:
        flag.value = _coerce(env, default)
    _REGISTRY[name] = flag
    if on_set is not None and env is not None:
        on_set(flag.value)
    return flag


def _coerce(text, like):
    if isinstance(like, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(text)
    if isinstance(like, float):
        return float(text)
    return text


def _known(name):
    if name not in _REGISTRY:
        raise ValueError(f"unknown flag {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def set_flags(flags: dict):
    """``paddle.set_flags({"FLAGS_dy2static_eager_fallback": True})``."""
    for name, value in flags.items():
        flag = _known(name)
        flag.value = (_coerce(value, flag.default) if isinstance(value, str)
                      else value)
        if flag.on_set is not None:
            flag.on_set(flag.value)


def get_flags(names):
    """``paddle.get_flags("FLAGS_...")`` or a list of names -> a dict."""
    if isinstance(names, str):
        names = [names]
    return {n: _known(n).value for n in names}


def flag_value(name: str):
    """Fast internal accessor (no dict copy)."""
    return _REGISTRY[name].value


def _cudnn_deterministic(value):
    torch.backends.cudnn.deterministic = bool(value)
    if value:
        torch.backends.cudnn.benchmark = False


register_flag("FLAGS_dy2static_eager_fallback", False,
              "explicit opt-in: let to_static fall back to eager execution "
              "(with a warning) when control flow can't be compiled; the "
              "default raises: a silent eager run would hide the host cost "
              "the compiled program exists to remove")
register_flag("FLAGS_cudnn_deterministic", False,
              "cuDNN picks deterministic algorithms "
              "(torch.backends.cudnn.deterministic, benchmark mode off)",
              on_set=_cudnn_deterministic)


def _debug_hooks(_value):
    from ..core import dispatch

    dispatch.DEBUG_HOOKS = any(
        _REGISTRY[n].value for n in ("FLAGS_check_nan_inf", "FLAGS_benchmark")
        if n in _REGISTRY)


register_flag("FLAGS_check_nan_inf", False,
              "raise when an eager op's output holds a NaN or an Inf, with "
              "the op's name and the counts", on_set=_debug_hooks)
register_flag("FLAGS_benchmark", False,
              "synchronise the device after every eager op, so a per-op "
              "time is the op's own", on_set=_debug_hooks)
register_flag("FLAGS_fault_plan", "",
              "chaos harness: ';'-separated fault specs "
              "(site:kind[=arg][@start][xcount][%prob]) armed at every "
              "paddle_tpu_torch.utils.faults.inject site")
register_flag("FLAGS_locksan", False,
              "arm the LockSan runtime lock-order sanitizer "
              "(paddle_tpu_torch.analysis.locksan): instrumented locks "
              "record acquisition order and blocking-calls-under-lock; set "
              "at process start so module-level locks are created armed")
register_flag("FLAGS_collective_timeout_s", 0.0,
              "seconds an eager collective may take before it raises "
              "CollectiveTimeoutError (op, group axis, size and rank in the "
              "message); 0 disables the guard")
