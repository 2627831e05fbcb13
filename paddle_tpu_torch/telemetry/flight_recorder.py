"""Flight recorder: a bounded ring buffer of recent runtime events, dumped
to disk when something dies (counterpart of
``paddle_tpu/telemetry/flight_recorder.py``, kept as it is).

Production postmortems need the *last few thousand things that happened* —
which collectives launched with what sizes, which blocks the allocator
handed out, which requests were admitted or preempted, which faults the
chaos harness injected — at the moment a ``CollectiveTimeoutError``,
``StoreTimeout``, engine stall, or uncaught exception fires. Logging all of
that continuously is too expensive and mostly noise; a ring buffer keeps
the tail cheap (deque append under a lock) and :meth:`FlightRecorder.dump`
turns it into a JSON artifact on demand.

Dump triggers wired in by the built-in layers (each names its reason):

- ``serving.engine`` — when the no-progress stall detector fails a request
- ``analysis.locksan`` — on a new lock-order or blocking-call violation
- :func:`install_excepthook` — any uncaught (fatal) exception

Dumps land under ``$PADDLE_TPU_FLIGHT_DIR`` (default: the system temp dir)
as ``flightrec-<pid>-<n>.json``; ``last_dump_path`` remembers the newest so
harnesses can attach it to their reports. Dumping
never raises: a postmortem writer that crashes the process it is trying to
autopsy is worse than no dump.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import threading
import time
from collections import deque

from .metrics import ENABLED
from ..analysis import locksan

__all__ = ["FlightRecorder", "flight", "record_event", "dump",
           "install_excepthook", "register_context_provider",
           "unregister_context_provider"]

_DUMP_IDS = itertools.count(1)

# name -> zero-arg callable returning a JSON-able blob. Every dump calls
# each provider and attaches the results under doc["context"][name] — how
# the metrics history (telemetry/history.py) rides along on every
# postmortem without the recorder knowing it exists. A provider that
# raises contributes an error marker instead of killing the dump.
_CONTEXT_PROVIDERS: dict[str, object] = {}


def register_context_provider(name: str, fn):
    _CONTEXT_PROVIDERS[str(name)] = fn


def unregister_context_provider(name: str):
    _CONTEXT_PROVIDERS.pop(str(name), None)


def _gather_context() -> dict:
    out = {}
    for name, fn in sorted(_CONTEXT_PROVIDERS.items()):
        try:
            out[name] = fn()
        except Exception as e:  # lint: allow-silent(a broken provider must not kill the postmortem; marker says which one)
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


class FlightRecorder:
    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._buf: deque[dict] = deque(maxlen=self.capacity)
        self._lock = locksan.Lock("flight.ring")
        self._seq = 0
        self.num_dumps = 0
        self.last_dump_path: str | None = None

    # -- recording -------------------------------------------------------
    def record(self, kind: str, **fields):
        """Append one event: {seq, t (monotonic), wall, kind, **fields}.
        Oldest events fall off the ring beyond ``capacity``."""
        if not ENABLED[0]:
            return
        with self._lock:
            self._seq += 1
            self._buf.append({
                "seq": self._seq,
                "t": time.monotonic(),
                "wall": time.time(),
                "kind": kind,
                **fields,
            })

    # -- inspection ------------------------------------------------------
    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._buf)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def __len__(self):
        return len(self._buf)

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._seq = 0

    # -- the postmortem artifact -----------------------------------------
    def _default_dir(self) -> str:
        return os.environ.get("PADDLE_TPU_FLIGHT_DIR",
                              tempfile.gettempdir())

    def dump(self, path: str | None = None, reason: str = "",
             error: BaseException | None = None) -> str | None:
        """Write the ring to ``path`` (default: flightrec-<pid>-<n>.json
        under $PADDLE_TPU_FLIGHT_DIR or the temp dir). Returns the path, or
        None if the write failed — dumping never raises."""
        try:
            if path is None:
                d = self._default_dir()
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"flightrec-{os.getpid()}-{next(_DUMP_IDS)}.json")
            with self._lock:
                evs = list(self._buf)
            doc = {
                "reason": reason,
                "error": (f"{type(error).__name__}: {error}"
                          if error is not None else None),
                "pid": os.getpid(),
                "wall_time": time.time(),
                "num_events": len(evs),
                "events_dropped": max(0, self._seq - len(evs)),
                "events": evs,
            }
            if _CONTEXT_PROVIDERS:
                doc["context"] = _gather_context()
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, default=str)
            self.num_dumps += 1
            self.last_dump_path = path
            return path
        except Exception:  # lint: allow-silent(dump is best-effort; None tells the caller it failed)
            return None


_GLOBAL = FlightRecorder()


def flight() -> FlightRecorder:
    """The process-global recorder every built-in layer records into."""
    return _GLOBAL


def record_event(kind: str, **fields):
    _GLOBAL.record(kind, **fields)


def dump(reason: str = "", error: BaseException | None = None,
         path: str | None = None) -> str | None:
    return _GLOBAL.dump(path=path, reason=reason, error=error)


_HOOK_INSTALLED = [False]


def install_excepthook():
    """Chain onto ``sys.excepthook`` so any uncaught exception dumps the
    flight recorder before the process dies (idempotent). KeyboardInterrupt
    and SystemExit are deliberate, not crashes — no dump for those."""
    if _HOOK_INSTALLED[0]:
        return
    _HOOK_INSTALLED[0] = True
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
            _GLOBAL.record("fatal.exception", type=exc_type.__name__,
                           message=str(exc)[:500])
            _GLOBAL.dump(reason="uncaught exception", error=exc)
        prev(exc_type, exc, tb)

    sys.excepthook = hook
