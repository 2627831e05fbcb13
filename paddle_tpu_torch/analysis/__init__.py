"""Concurrency sanitizer (counterpart of ``paddle_tpu/analysis/``).

- :mod:`paddle_tpu_torch.analysis.locksan` — **LockSan**, a runtime
  lock-order sanitizer: an instrumented lock factory adopted by every
  lock-holding module of the port (telemetry, the fault registry). Armed
  via ``FLAGS_locksan`` (environment or ``paddle.set_flags``) it records
  per-thread acquisition stacks, builds the global lock-order graph, and
  reports order-inversion cycles (potential deadlocks) and blocking calls
  made while holding a lock (socket / pipe / fsync / ``time.sleep``). Off
  (the default) it hands back raw ``threading`` locks: zero overhead.

- :mod:`paddle_tpu_torch.analysis.lint` — the AST lint framework: passes
  for silently swallowed exceptions, unnamed threads, wall-clock duration
  math, time and tracer leaks in compiled functions, host syncs in the
  engine's step functions and the kernel wrappers, and fault-site /
  metric doc drift. Findings are keyed and grandfathered in
  ``analysis/baseline.json``; ``python -m paddle_tpu_torch.analysis.lint
  --check`` is the gate (pure stdlib: not imported here).
"""
from . import locksan  # noqa: F401
from .locksan import Lock, RLock, allow_blocking  # noqa: F401

__all__ = ["locksan", "Lock", "RLock", "allow_blocking"]
