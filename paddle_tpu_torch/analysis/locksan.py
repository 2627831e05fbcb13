"""LockSan: a runtime lock-order sanitizer for the package's threading
(counterpart of ``paddle_tpu/analysis/locksan.py``, kept as it is).

A serving process is concurrent — publisher / sampler threads, lock-per-
child metric families, the flight ring, the fault plan — and invariants
about their interaction ("never fsync while holding a lock", "no two locks
taken in both orders") are otherwise proven by hand. LockSan makes those
proofs mechanical.

Usage — the instrumented factory replaces ``threading.Lock()`` at every
lock-holding module in the package::

    from ..analysis import locksan
    self._lock = locksan.Lock("router.state")

**Off (the default), the factory returns a raw ``threading.Lock`` /
``RLock``** — zero per-acquire overhead, nothing tracked; the only cost is
one flag check at lock *creation*. Armed (``FLAGS_locksan=1`` in the
environment at process start, or :func:`arm` before the objects under test
are built) every factory-made lock becomes a :class:`_SanLock` that:

- records per-thread acquisition stacks;
- adds a ``held -> acquired`` edge to the global lock-order graph on every
  nested acquisition, and reports an **order-inversion cycle** (a
  potential deadlock: some thread took A then B while another takes B then
  A) the moment the edge that closes a cycle appears — naming both
  threads and both acquisition stacks;
- detects **blocking calls under a lock**: while armed, ``time.sleep``,
  ``os.fsync``, ``select.select`` and the blocking ``socket`` methods are
  wrapped; calling one while holding any sanitized lock is a violation
  (the exact bug class the router's "pending-fetch table outside the
  router lock" design dodged by hand). Regions that hold a lock across
  I/O *by design* (the TCPStore wire protocol, replica pipe writes, the
  journal's fsync-under-append durability barrier) annotate themselves::

      with locksan.allow_blocking("wire protocol: io lock serializes "
                                  "the socket by design"):
          self._sock.sendall(frame)

Violations land in three places: the in-process report
(:func:`violations` / :func:`report` — what the tests assert on), ``locksan_*`` metric families,
and the flight recorder (``lock.order_violation`` /
``lock.blocking_under_lock`` events plus one auto-dump per new violation,
bounded). Reporting never raises and never re-enters itself.

Lock-order nodes are lock *names*, not instances: every
``metrics.child`` lock is one node, so the graph stays readable and an
inversion between two *instances* of the same pair of roles is still
caught. Same-name nesting (two children of one family) is ignored —
sibling locks of one role never form a meaningful order.
"""
from __future__ import annotations

import os
import select
import socket
import sys
import threading
import time
import traceback

__all__ = [
    "Lock", "RLock", "arm", "disarm", "armed", "allow_blocking",
    "report", "violations", "reset", "Violation",
]

# -- arming ------------------------------------------------------------------

# None = not yet resolved from FLAGS_locksan / env; True/False afterwards.
_ARMED: list = [None]
_STACK_LIMIT = 12
_MAX_VIOLATIONS = 256
_MAX_DUMPS = 5


def _resolve_armed() -> bool:
    """First consult: FLAGS_locksan if the flags registry knows it (it is
    registered at framework import), else the raw env var — locksan must
    work before (and without) full package init."""
    try:
        from ..framework.flags import flag_value

        val = bool(flag_value("FLAGS_locksan"))
    except Exception:  # flags registry not imported yet; env fallback below
        val = os.environ.get("FLAGS_locksan", "").lower() in (
            "1", "true", "yes", "on")
    return val


def armed() -> bool:
    if _ARMED[0] is None:
        if _resolve_armed():
            arm()
        else:
            _ARMED[0] = False
    return _ARMED[0]


def arm():
    """Turn the sanitizer on: factory calls from here on return
    instrumented locks, and the blocking-call shims are installed. Arm
    *before* building the objects under test — locks created while
    disarmed stay raw."""
    if _ARMED[0] is True:
        return
    _ARMED[0] = True
    _patch_blocking()


def disarm():
    """Turn instrumentation off for newly created locks and remove the
    blocking-call shims. Already-created _SanLocks keep working (their
    per-acquire recording also checks the flag)."""
    _ARMED[0] = False
    _unpatch_blocking()


# -- global state ------------------------------------------------------------

_G = threading.Lock()          # guards the graph/violation structures (raw!)
_ADJ: dict[str, set] = {}      # lock-order graph: name -> {successor names}
_EDGES: dict[tuple, dict] = {} # (a, b) -> first-occurrence record
_VIOLATIONS: list = []
_SEEN_KEYS: set = set()
_ACQUIRES = [0]                # plain counter; exported via report()
_LOCK_NAMES: set = set()
_NUM_DUMPS = [0]

_TLS = threading.local()


class Violation(dict):
    """One finding; a dict subclass so reports JSON-serialize as-is."""


def _state():
    st = getattr(_TLS, "held", None)
    if st is None:
        st = _TLS.held = []
    return st


def _stack(skip: int = 2) -> list:
    try:
        frames = traceback.extract_stack(sys._getframe(skip),
                                         limit=_STACK_LIMIT)
        return [f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
                for f in frames]
    except Exception:  # stack capture is best-effort; a report without frames beats a crash
        return []


# -- reporting ---------------------------------------------------------------

_METRICS = [None]


def _metrics():
    """Lazy: locksan loads before telemetry in package init."""
    if _METRICS[0] is None:
        from ..telemetry import registry

        reg = registry()
        _METRICS[0] = (
            reg.counter("locksan_violations_total",
                        "lock-order / blocking-under-lock violations",
                        ("type",)),
            reg.gauge("locksan_edges",
                      "distinct edges in the observed lock-order graph"),
            reg.gauge("locksan_locks_tracked",
                      "distinct lock names under LockSan instrumentation"),
            reg.counter("locksan_allowed_blocking_total",
                        "blocking calls under a lock inside an "
                        "allow_blocking waiver region"),
        )
    return _METRICS[0]


def _emit(v: Violation):
    """Metric + flight event + bounded auto-dump. Never raises; never
    re-enters the acquire instrumentation (guard flag)."""
    _TLS.in_locksan = True
    try:
        from ..telemetry import flight, record_event

        vt, edges, locks, _ = _metrics()
        vt.labels(type=v["type"]).inc()
        edges.set(len(_EDGES))
        locks.set(len(_LOCK_NAMES))
        kind = ("lock.order_violation"
                if v["type"] == "lock_order_inversion"
                else "lock.blocking_under_lock")
        record_event(kind, **{k: vv for k, vv in v.items()
                              if isinstance(vv, (str, int, float, bool))})
        if _NUM_DUMPS[0] < _MAX_DUMPS:
            _NUM_DUMPS[0] += 1
            flight().dump(reason=kind)
    except Exception:  # the sanitizer must never alter the semantics of the code it watches
        pass
    finally:
        _TLS.in_locksan = False


def _record_violation(v: Violation, key):
    with _G:
        if key in _SEEN_KEYS:
            return
        _SEEN_KEYS.add(key)
        if len(_VIOLATIONS) < _MAX_VIOLATIONS:
            _VIOLATIONS.append(v)
    _emit(v)


# -- the instrumented lock ---------------------------------------------------

class _SanLock:
    """threading.Lock/RLock work-alike that feeds the sanitizer."""

    __slots__ = ("_lock", "name", "_reentrant")

    def __init__(self, name: str, reentrant: bool = False):
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self.name = name
        self._reentrant = reentrant
        with _G:
            _LOCK_NAMES.add(name)

    # threading.Lock API ----------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lock.acquire(blocking, timeout)
        if ok and _ARMED[0] and not getattr(_TLS, "in_locksan", False):
            self._note_acquired()
        return ok

    def release(self):
        if _ARMED[0] and not getattr(_TLS, "in_locksan", False):
            self._note_released()
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked() if not self._reentrant else None

    def __repr__(self):
        return f"<locksan.{'RLock' if self._reentrant else 'Lock'} " \
               f"{self.name!r}>"

    # sanitizer hooks -------------------------------------------------------
    def _note_acquired(self):
        st = _state()
        # re-entrant re-acquire of the same instance: bump depth, no edges
        for rec in st:
            if rec[0] is self:
                rec[2] += 1
                return
        stack = _stack(3)
        new_edges = []
        for held, held_stack, _depth in st:
            if held.name == self.name:
                continue  # sibling locks of one role carry no order
            with _G:
                edge = (held.name, self.name)
                if edge not in _EDGES:
                    _EDGES[edge] = {
                        "from": held.name, "to": self.name,
                        "thread": threading.current_thread().name,
                        "stack_held": list(held_stack),
                        "stack_acquire": list(stack),
                        "count": 1,
                    }
                    _ADJ.setdefault(held.name, set()).add(self.name)
                    new_edges.append(edge)
                else:
                    _EDGES[edge]["count"] += 1
        st.append([self, stack, 1])
        for edge in new_edges:
            self._check_cycle(edge)

    def _note_released(self):
        st = _state()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is self:
                st[i][2] -= 1
                if st[i][2] <= 0:
                    del st[i]
                return

    def _check_cycle(self, edge):
        """The new edge (a, b) closes a cycle iff b already reaches a."""
        a, b = edge
        with _G:
            path = self._find_path(b, a)
            if path is None:
                return
            cycle = [a] + path        # a -> b ... -> a
            chain = []
            for i in range(len(cycle) - 1):
                e = _EDGES.get((cycle[i], cycle[i + 1]))
                if e:
                    chain.append(dict(e))
        v = Violation(
            type="lock_order_inversion",
            cycle=" -> ".join(cycle),
            thread=threading.current_thread().name,
            edges=chain,
            summary=(f"lock-order inversion: this thread takes "
                     f"{a!r} then {b!r}, but the order "
                     f"{' -> '.join(cycle[1:])} was already observed "
                     f"(threads: "
                     f"{sorted({e['thread'] for e in chain})})"),
        )
        _record_violation(v, ("cycle",) + tuple(sorted(set(cycle))))

    @staticmethod
    def _find_path(src: str, dst: str):
        """DFS path src -> dst in _ADJ (caller holds _G); None if absent."""
        stack, seen = [(src, [src])], {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in _ADJ.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


def Lock(name: str | None = None):
    """``threading.Lock()`` when LockSan is off; an instrumented
    :class:`_SanLock` when armed. Name the lock after its role
    (``"router.state"``) — the name is the node in the order graph."""
    if not armed():
        return threading.Lock()
    return _SanLock(name or _caller_name())


def RLock(name: str | None = None):
    if not armed():
        return threading.RLock()
    return _SanLock(name or _caller_name(), reentrant=True)


def _caller_name() -> str:
    try:
        f = sys._getframe(2)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:  # naming fallback only; an anonymous node still participates in the graph
        return "anonymous"


# -- blocking-call detection -------------------------------------------------

class allow_blocking:
    """Mark a region where holding a lock across a blocking call is by
    design (documented reason required). Re-entrant; usable as decorator."""

    def __init__(self, reason: str):
        if not reason or not reason.strip():
            raise ValueError("allow_blocking requires a non-empty reason")
        self.reason = reason

    def __enter__(self):
        _TLS.allow_depth = getattr(_TLS, "allow_depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _TLS.allow_depth -= 1
        return False

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with self:
                return fn(*a, **kw)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


def _note_blocking(call: str):
    if not _ARMED[0] or getattr(_TLS, "in_locksan", False):
        return
    st = getattr(_TLS, "held", None)
    if not st:
        return
    if getattr(_TLS, "allow_depth", 0) > 0:
        try:
            _metrics()[3].inc()
        except Exception:  # metrics unavailable this early is fine; the waiver still waives
            pass
        return
    held = [rec[0].name for rec in st]
    call_stack = _stack(3)
    site = call_stack[-1] if call_stack else "?"
    v = Violation(
        type="blocking_call_under_lock",
        call=call,
        locks=list(held),
        thread=threading.current_thread().name,
        lock_stack=list(st[-1][1]),
        call_stack=call_stack,
        summary=(f"{call} called while holding "
                 f"{held!r} (thread "
                 f"{threading.current_thread().name!r} at {site}) — "
                 "move the call outside the lock or annotate the region "
                 "with locksan.allow_blocking(reason)"),
    )
    _record_violation(v, ("blocking", call, held[-1], site))


_ORIG: dict = {}


def _wrap_fn(mod, attr, label):
    orig = getattr(mod, attr)

    def wrapper(*a, **kw):
        _note_blocking(label)
        return orig(*a, **kw)

    wrapper.__name__ = getattr(orig, "__name__", attr)
    wrapper._locksan_orig = orig
    _ORIG[(mod, attr)] = orig
    setattr(mod, attr, wrapper)


def _wrap_method(cls, attr, label):
    orig = getattr(cls, attr)

    def wrapper(self, *a, **kw):
        _note_blocking(label)
        return orig(self, *a, **kw)

    wrapper.__name__ = attr
    wrapper._locksan_orig = orig
    _ORIG[(cls, attr)] = orig
    setattr(cls, attr, wrapper)


def _patch_blocking():
    """Shim the blocking primitives the package actually uses. Idempotent;
    undone by :func:`_unpatch_blocking`."""
    if _ORIG:
        return
    _wrap_fn(time, "sleep", "time.sleep")
    _wrap_fn(os, "fsync", "os.fsync")
    _wrap_fn(select, "select", "select.select")
    for m in ("connect", "accept", "recv", "recv_into", "send", "sendall"):
        if hasattr(socket.socket, m):
            _wrap_method(socket.socket, m, f"socket.{m}")


def _unpatch_blocking():
    for (owner, attr), orig in list(_ORIG.items()):
        setattr(owner, attr, orig)
    _ORIG.clear()


# -- inspection --------------------------------------------------------------

def violations() -> list:
    with _G:
        return list(_VIOLATIONS)


def report() -> dict:
    """JSON-able state dump: the graph, every violation, and counts."""
    with _G:
        return {
            "armed": bool(_ARMED[0]),
            "locks_tracked": sorted(_LOCK_NAMES),
            "num_edges": len(_EDGES),
            "edges": [
                {"from": a, "to": b, "count": e["count"],
                 "thread": e["thread"]}
                for (a, b), e in sorted(_EDGES.items())
            ],
            "violations": list(_VIOLATIONS),
        }


def reset():
    """Clear the graph and violations (tests); arming state unchanged."""
    with _G:
        _ADJ.clear()
        _EDGES.clear()
        _VIOLATIONS.clear()
        _SEEN_KEYS.clear()
        _LOCK_NAMES.clear()
        _NUM_DUMPS[0] = 0
