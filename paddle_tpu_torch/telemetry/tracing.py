"""Structured host-side span tracing (counterpart of
``paddle_tpu/telemetry/tracing.py``).

``span(name, **attrs)`` is a context manager producing an in-process event
log with trace/span/parent ids (thread-local nesting), exportable as a
Chrome ``trace.json`` (``chrome://tracing`` / Perfetto load it directly).
When a device trace is active — ``paddle_tpu_torch.profiler.Profiler``
flips :func:`set_device_trace_active` around its ``torch.profiler``
session — every span additionally enters
``torch.profiler.record_function(name)`` (where the reference enters a
``jax.profiler.TraceAnnotation``), so host-side request/engine spans land
in the torch profiler's trace beside the CUDA kernels they launched.

Spans that do not correspond to a live ``with`` block (e.g. a request's
queued -> prefill -> decode lifecycle, reconstructed at finish time from its
timestamps) are emitted directly with :meth:`Tracer.emit`, optionally onto a
virtual thread (``tid=``/``tid_name=``) so each request renders as its own
nested timeline row.

All timestamps are ``time.monotonic()`` seconds — the same clock the
serving scheduler stamps requests with — converted to microseconds relative
to a module-load epoch at export time.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

from .metrics import ENABLED
from ..analysis import locksan

__all__ = ["Span", "Tracer", "tracer", "span", "trace_id", "epoch_unix",
           "mono_to_unix", "set_device_trace_active", "device_trace_active"]

_EPOCH = time.monotonic()
_TRACE_ID = f"{os.getpid():x}-{os.urandom(4).hex()}"
_SPAN_IDS = itertools.count(1)
_DEVICE_TRACE = [False]
_TLS = threading.local()


def trace_id() -> str:
    """This process's trace id (stamped on every exported span)."""
    return _TRACE_ID


def epoch_unix() -> float:
    """Wall-clock time corresponding to exported trace ``ts=0`` (the
    module-load monotonic epoch). Cross-rank trace merge
    (:func:`telemetry.cluster.merge_traces`) uses this plus a per-rank
    clock offset to place every rank's events on one shared timeline."""
    # lint: allow-wallclock(this IS the wall<->mono offset computation)
    return time.time() - (time.monotonic() - _EPOCH)


def mono_to_unix(t_mono: float) -> float:
    """Wall-clock time of a ``time.monotonic()`` stamp on THIS process's
    clock — how request-scoped spans are serialized across the replica pipe
    (``telemetry.reqtrace``): the worker stamps spans in unix time so the
    router can place hops from different processes on one timeline."""
    return epoch_unix() + (float(t_mono) - _EPOCH)


def set_device_trace_active(active: bool):
    """Profiler hook: while True, spans enter
    ``torch.profiler.record_function`` so they land in the device trace
    too."""
    _DEVICE_TRACE[0] = bool(active)


def device_trace_active() -> bool:
    return _DEVICE_TRACE[0]


class Span:
    """One finished span. ``t0``/``t1`` are monotonic seconds."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs",
                 "tid", "tid_name")

    def __init__(self, name, span_id, parent_id, t0, t1, attrs,
                 tid=None, tid_name=None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}
        # thread identity is captured at record time (export would see the
        # exporter's thread); tid overrides place spans on virtual rows
        self.tid = (tid if tid is not None
                    else threading.get_ident() % 1_000_000)
        self.tid_name = tid_name

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, dur={self.duration * 1e3:.3f}ms)")


class Tracer:
    """Bounded in-process span log. Finished spans append under a lock;
    beyond ``capacity`` the oldest are evicted (``dropped`` counts them) —
    tracing a long serving run must never grow without bound."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._spans: list[Span] = []
        self._lock = locksan.Lock("tracing.ring")
        self.dropped = 0

    # -- recording -------------------------------------------------------
    def emit(self, name, t0, t1, attrs=None, parent_id=None,
             tid=None, tid_name=None) -> Span | None:
        """Record an already-timed span (monotonic seconds)."""
        if not ENABLED[0]:
            return None
        sp = Span(name, next(_SPAN_IDS), parent_id, float(t0), float(t1),
                  dict(attrs) if attrs else {}, tid=tid, tid_name=tid_name)
        with self._lock:
            self._spans.append(sp)
            if len(self._spans) > self.capacity:
                excess = len(self._spans) - self.capacity
                del self._spans[:excess]
                self.dropped += excess
        return sp

    # -- inspection ------------------------------------------------------
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def find(self, name: str) -> list[Span]:
        return [s for s in self.spans() if s.name == name]

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # -- export ----------------------------------------------------------
    def export_chrome(self, path: str) -> str:
        """Write the log as a Chrome trace-event JSON file. Spans map to
        complete ("X") events; named virtual threads get thread_name
        metadata so per-request rows are labeled in the viewer."""
        pid = os.getpid()
        events = []
        tid_names = {}
        for s in self.spans():
            tid = s.tid
            if s.tid_name:
                tid_names[tid] = s.tid_name
            args = {k: v for k, v in s.attrs.items()}
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            args["trace_id"] = _TRACE_ID
            events.append({
                "ph": "X", "name": s.name, "pid": pid, "tid": tid,
                "ts": round((s.t0 - _EPOCH) * 1e6, 3),
                "dur": round((s.t1 - s.t0) * 1e6, 3),
                "args": args,
            })
        for tid, name in sorted(tid_names.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms",
                       "otherData": {"trace_id": _TRACE_ID,
                                     "epoch_unix": epoch_unix()}},
                      f, default=str)
        return path


_DEFAULT = Tracer()


def tracer() -> Tracer:
    """The process-global tracer every built-in layer records into."""
    return _DEFAULT


def _stack():
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class _SpanCtx:
    """The live half of :func:`span`: tracks t0, the thread-local parent,
    and (while a device trace runs) a ``record_function`` annotation."""

    __slots__ = ("name", "attrs", "tracer", "span_id", "parent_id",
                 "t0", "_ann", "span")

    def __init__(self, name, attrs, tracer_):
        self.name = name
        self.attrs = attrs
        self.tracer = tracer_
        self.span_id = None
        self.parent_id = None
        self.t0 = None
        self._ann = None
        self.span = None

    def __enter__(self):
        if not ENABLED[0]:
            return self
        self.span_id = next(_SPAN_IDS)
        st = _stack()
        self.parent_id = st[-1] if st else None
        st.append(self.span_id)
        if _DEVICE_TRACE[0]:
            try:
                from torch.profiler import record_function

                self._ann = record_function(self.name)
                self._ann.__enter__()
            except Exception:  # lint: allow-silent(never let telemetry break the caller)
                self._ann = None
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.span_id is None:      # disabled at entry
            return False
        t1 = time.monotonic()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        st = _stack()
        if st and st[-1] == self.span_id:
            st.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        sp = Span(self.name, self.span_id, self.parent_id, self.t0, t1,
                  self.attrs)
        with self.tracer._lock:
            self.tracer._spans.append(sp)
            if len(self.tracer._spans) > self.tracer.capacity:
                excess = len(self.tracer._spans) - self.tracer.capacity
                del self.tracer._spans[:excess]
                self.tracer.dropped += excess
        self.span = sp
        return False


def span(name: str, **attrs) -> _SpanCtx:
    """``with span("engine.decode", batch=4): ...`` — records a nested span
    into the global tracer (and the device trace, when one is active)."""
    return _SpanCtx(name, attrs, _DEFAULT)
