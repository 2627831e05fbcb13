"""Performance observability: why did it recompile, where did the memory
go, and which phase of the step got slower (counterpart of
``paddle_tpu/telemetry/perf.py``).

- :class:`CompileWatcher` — every compile point of the port reports each
  invocation's *abstract argument signature* here: each
  ``jit.to_static`` signature (``jit.<function>``), each
  ``static.Executor`` compile (``static.executor``), each trace of a
  hand-written kernel's registered op at its fake implementation
  (``kernel.<op>``: the counterpart of the reference's trace-time
  ``record_call`` in its Pallas wrappers), each ``nvcc`` library build
  (``nvcc.<library>``, its wall time through :meth:`record_compile`), and
  the serving engine's prefill/decode step signatures (``engine.*``). A
  signature never seen for that callable is a (re)trace: it is counted,
  timed, and recorded as a ``compile.trace`` flight event. Too many
  distinct signatures for one callable inside a sliding window is a
  **recompilation storm** — ``recompile_storms_total`` fires and
  :func:`explain_recompile` diffs the last two signatures, naming exactly
  which argument's shape/dtype churned. The reference's
  ``arm_jax_monitoring`` (a ``jax.monitoring`` listener timing XLA's
  backend compiles) has no counterpart: torch has no such listener, and
  the compiles the port pays for itself (``nvcc``, ``torch.compile``) are
  the watched points above. Nor has ``watch_dispatch``: torch's eager ops
  compile nothing per shape, so their signatures are no retrace.

- :class:`MemoryMonitor` — per-tag live/peak byte accounting (``params``,
  ``kv_pool``, ``activations_estimate``, anything a caller registers), a
  bounded timeline, a peak-attribution snapshot ("what was live at
  peak"), ``device_stats()`` — ``torch.cuda.memory_stats()`` of the device
  given to :meth:`MemoryMonitor.watch_device` (the serving engine's), None
  on the CPU — and a leak sentinel that flags monotonic steady-state
  watermark growth across steps/requests.

- :class:`StepTimeline` — segments train steps and decode steps into
  phases (``data``, ``h2d``, ``compute``, ``collective``, ``update``,
  ``other``) from explicit ``phase()`` contexts plus external attribution
  (:func:`note_phase`), reports per-phase percentiles over a rolling
  window, and names the culprit phase when step time regresses against
  its rolling baseline (``step.regression`` flight event).

One process-global instance of each (:func:`compile_watcher`,
:func:`memory_monitor`, :func:`step_timeline`), published through the
metrics registry (the family names are the reference's, so one dashboard
reads both packages). :func:`run_meta` stamps artifacts with the torch
and CUDA versions and the card's name.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from types import SimpleNamespace

from .flight_recorder import record_event
from .metrics import ENABLED, registry
from ..analysis import locksan

__all__ = [
    "CompileWatcher", "MemoryMonitor", "StepTimeline",
    "compile_watcher", "memory_monitor", "step_timeline",
    "abstract_signature", "explain_recompile", "note_phase",
    "run_meta", "reset",
]

# compile wall times: traces are 10ms..minutes, not sub-ms
_COMPILE_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

_PM = None


def _perf_metrics() -> SimpleNamespace:
    """Lazy family resolve (the module is imported by telemetry/__init__;
    registering at import time is fine, but lazy keeps reset() simple)."""
    global _PM
    if _PM is None:
        reg = registry()
        _PM = SimpleNamespace(
            compiles=reg.counter(
                "xla_compiles_total",
                "(re)traces observed per watched jit callable",
                ("callable",)),
            compile_s=reg.histogram(
                "xla_compile_seconds",
                "wall time of an observed (re)trace, incl. backend compile",
                ("callable",), buckets=_COMPILE_BUCKETS),
            storms=reg.counter(
                "recompile_storms_total",
                "recompilation storms (same callable, too many distinct "
                "signatures in a window)", ("callable",)),
            signatures=reg.gauge(
                "compile_signatures_live",
                "distinct argument signatures seen per watched callable",
                ("callable",)),
            mem_live=reg.gauge("memory_live_bytes",
                               "live bytes per accounting tag", ("tag",)),
            mem_peak=reg.gauge("memory_peak_bytes",
                               "peak bytes per accounting tag", ("tag",)),
            leaks=reg.counter(
                "memory_leak_flags_total",
                "leak-sentinel trips (monotonic watermark growth)",
                ("tag",)),
            step_s=reg.histogram("step_time_seconds",
                                 "wall time of one timeline step",
                                 ("timeline",)),
            phase_s=reg.histogram("step_phase_seconds",
                                  "wall time of one step phase",
                                  ("timeline", "phase")),
            regressions=reg.counter(
                "step_regressions_total",
                "steps slower than the rolling baseline, by culprit phase",
                ("timeline", "phase")),
        )
    return _PM


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def _leaf_sig(name, x):
    """One argument's abstract signature entry: (name, shape, dtype)."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        # "float32", not "torch.float32": the reference's spelling
        # a symbolic dim (torch.export's dynamic batch) stays symbolic:
        # int() on it would specialize the program being traced
        return (name, tuple(s if isinstance(s, int) else str(s)
                            for s in shape),
                str(dtype).replace("torch.", ""))
    # python scalars trace as weak-typed () arrays: dtype-per-type, not
    # value-per-value, so only the type matters for retraces
    return (name, (), f"py:{type(x).__name__}")


def abstract_signature(args, argnames=None) -> tuple:
    """Abstract (shape, dtype) signature of a positional argument list —
    the retrace key a compiled program effectively uses. ``argnames`` labels the entries
    so :func:`explain_recompile` can name the churning argument."""
    out = []
    for i, a in enumerate(args):
        name = argnames[i] if argnames and i < len(argnames) else f"arg{i}"
        out.append(_leaf_sig(name, a))
    return tuple(out)


def _diff_signatures(before: tuple, after: tuple) -> list[dict]:
    """Which argument changed between two signatures, field by field."""
    changes = []
    a_by = {e[0]: e for e in before}
    b_by = {e[0]: e for e in after}
    for name, (_, shp_b, dt_b) in b_by.items():
        if name not in a_by:
            changes.append({"arg": name, "field": "added",
                            "before": None, "after": (shp_b, dt_b)})
            continue
        _, shp_a, dt_a = a_by[name]
        if shp_a != shp_b:
            changes.append({"arg": name, "field": "shape",
                            "before": shp_a, "after": shp_b})
        if dt_a != dt_b:
            changes.append({"arg": name, "field": "dtype",
                            "before": dt_a, "after": dt_b})
    for name in a_by:
        if name not in b_by:
            changes.append({"arg": name, "field": "removed",
                            "before": a_by[name][1:], "after": None})
    return changes


# ---------------------------------------------------------------------------
# CompileWatcher
# ---------------------------------------------------------------------------

class CompileWatcher:
    """Counts and times (re)traces per jit callable, keyed by abstract
    argument signature, and detects recompilation storms.

    ``storm_threshold`` distinct signatures for one callable within
    ``storm_window_s`` is a storm (default 4 in 60s; ``$PADDLE_TPU_STORM_N``
    / ``$PADDLE_TPU_STORM_WINDOW_S`` override). A storm latches until the
    window drains so one churning argument doesn't fire per call.
    """

    def __init__(self, storm_threshold: int | None = None,
                 storm_window_s: float | None = None,
                 max_signatures: int = 256):
        self.storm_threshold = int(
            storm_threshold if storm_threshold is not None
            else os.environ.get("PADDLE_TPU_STORM_N", 4))
        self.storm_window_s = float(
            storm_window_s if storm_window_s is not None
            else os.environ.get("PADDLE_TPU_STORM_WINDOW_S", 60.0))
        self.max_signatures = int(max_signatures)
        self._lock = locksan.Lock("perf.compile_watcher")
        # name -> OrderedDict[signature -> hit count] (insertion-ordered:
        # the last two keys are the last two distinct signatures)
        self._sigs: dict[str, OrderedDict] = {}
        self._recent: dict[str, deque] = {}   # name -> deque[(t, sig)]
        self._storm: dict[str, dict] = {}     # latched storm per name
        self.compiles_total = 0

    # -- recording -------------------------------------------------------
    def record_call(self, name: str, signature: tuple,
                    wall_s: float | None = None,
                    cost: dict | None = None) -> bool:
        """One invocation of a watched callable. Returns True when the
        signature is new for ``name`` (i.e. this call (re)traced).
        ``cost`` is an optional roofline estimate (``telemetry.cost``)
        registered at trace time — it rides the ``compile.trace`` flight
        event so every recorded (re)trace names its modeled FLOPs/bytes."""
        if not ENABLED[0]:
            return False
        now = time.monotonic()
        with self._lock:
            sigs = self._sigs.setdefault(name, OrderedDict())
            if signature in sigs:
                sigs[signature] += 1
                return False
            if len(sigs) >= self.max_signatures:
                sigs.popitem(last=False)
            sigs[signature] = 1
            self.compiles_total += 1
            recent = self._recent.setdefault(
                name, deque(maxlen=4 * max(self.storm_threshold, 4)))
            recent.append((now, signature))
            distinct = self._distinct_in_window(name, now)
            storm = (distinct >= self.storm_threshold
                     and name not in self._storm)
            if storm:
                self._storm[name] = {
                    "callable": name, "distinct_signatures": distinct,
                    "window_s": self.storm_window_s, "t": now,
                }
            elif name in self._storm:
                self._storm[name]["distinct_signatures"] = distinct
            n_sigs = len(sigs)
        pm = _perf_metrics()
        pm.compiles.labels(callable=name).inc()
        pm.signatures.labels(callable=name).set(n_sigs)
        if wall_s is not None:
            pm.compile_s.labels(callable=name).observe(wall_s)
        extra = {}
        if cost:
            extra = {"flops": cost.get("flops"),
                     "bytes": cost.get("bytes"),
                     "arithmetic_intensity":
                         round(cost.get("arithmetic_intensity", 0.0), 3)}
        record_event("compile.trace", callable=name,
                     wall_s=wall_s, distinct=n_sigs,
                     args=[f"{n}:{s}:{d}" for n, s, d in signature][:8],
                     **extra)
        if storm:
            pm.storms.labels(callable=name).inc()
            diff = self.explain(name)
            record_event("compile.storm", callable=name, distinct=distinct,
                         window_s=self.storm_window_s,
                         explain=diff.get("text") if diff else None)
        return True

    def record_compile(self, name: str, signature: tuple, wall_s: float):
        """Direct form for call sites that *know* they compiled (the
        static Executor's cache-miss path)."""
        self.record_call(name, signature, wall_s=wall_s)

    def wrap(self, fn, name: str, argnames=None):
        """Wrap a (jitted) callable: each call reports its signature; a
        new signature's call is timed as the compile wall time (trace +
        backend compile + first run — the cost the caller actually paid)."""
        def wrapped(*args, **kwargs):
            sig = abstract_signature(args, argnames)
            with self._lock:
                new = sig not in self._sigs.get(name, ())
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            self.record_call(name, sig,
                             wall_s=time.monotonic() - t0 if new else None)
            return out
        wrapped.__name__ = f"watched[{name}]"
        return wrapped

    # -- inspection ------------------------------------------------------
    def _distinct_in_window(self, name, now) -> int:
        recent = self._recent.get(name)
        if not recent:
            return 0
        cutoff = now - self.storm_window_s
        while recent and recent[0][0] < cutoff:
            recent.popleft()
        if not recent and name in self._storm:
            del self._storm[name]    # window drained: un-latch
        return len({sig for _, sig in recent})

    def signatures(self, name: str) -> list[tuple]:
        with self._lock:
            return list(self._sigs.get(name, ()))

    def compiles(self, name: str | None = None) -> int:
        with self._lock:
            if name is None:
                return self.compiles_total
            return len(self._sigs.get(name, ()))

    def storms(self) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._storm.values()]

    def explain(self, name: str | None = None) -> dict | None:
        """Signature diff for ``name`` (default: the stormiest / most
        recently churning callable): which argument's shape or dtype
        changed between the last two distinct signatures."""
        with self._lock:
            if name is None:
                if self._storm:
                    name = max(self._storm,
                               key=lambda n: self._storm[n].get(
                                   "distinct_signatures", 0))
                elif self._sigs:
                    name = max(self._sigs, key=lambda n: len(self._sigs[n]))
                else:
                    return None
            sigs = list(self._sigs.get(name, ()))
        if len(sigs) < 2:
            return None
        before, after = sigs[-2], sigs[-1]
        changes = _diff_signatures(before, after)
        parts = []
        for c in changes:
            if c["field"] in ("shape", "dtype"):
                parts.append(
                    f"arg '{c['arg']}' {c['field']} "
                    f"{c['before']} -> {c['after']}")
            else:
                parts.append(f"arg '{c['arg']}' {c['field']}")
        text = (f"{name}: {len(sigs)} distinct signatures; last retrace "
                f"changed " + ("; ".join(parts) if parts
                               else "nothing visible (same signature?)"))
        return {"callable": name, "distinct_signatures": len(sigs),
                "changed_args": changes, "text": text}

    def summary(self, prefix: str | None = None) -> dict:
        with self._lock:
            names = [n for n in self._sigs
                     if prefix is None or n.startswith(prefix)]
            out = {
                "compiles_total": sum(len(self._sigs[n]) for n in names),
                "callables": {n: {"compiles": len(self._sigs[n]),
                                  "calls": sum(self._sigs[n].values())}
                              for n in names},
                "storms": [dict(self._storm[n]) for n in names
                           if n in self._storm],
            }
        return out

    def clear(self):
        with self._lock:
            self._sigs.clear()
            self._recent.clear()
            self._storm.clear()
            self.compiles_total = 0


# ---------------------------------------------------------------------------
# MemoryMonitor
# ---------------------------------------------------------------------------

class MemoryMonitor:
    """Per-tag live/peak byte accounting with a peak-attribution snapshot,
    a bounded timeline, and a monotonic-growth leak sentinel.

    Callers register what they allocate (``add``/``sub``) or assert an
    absolute level (``set``); :meth:`note_step` stamps an end-of-step
    watermark per tag — ``leak_window`` consecutive nondecreasing,
    net-growing watermarks flag the tag as leaking (once per streak).
    """

    def __init__(self, timeline_cap: int = 1024, leak_window: int = 8):
        self._lock = locksan.Lock("perf.memory_monitor")
        self._live: dict[str, float] = {}
        self._peak: dict[str, float] = {}
        self._total_peak = 0.0
        self._peak_snapshot: dict[str, float] = {}
        self._timeline: deque = deque(maxlen=int(timeline_cap))
        self.leak_window = int(leak_window)
        self._steps: dict[str, deque] = {}    # tag -> end-of-step watermarks
        self._leak_flagged: set[str] = set()
        # tags whose monotonic growth is expected by design (a
        # capacity-bounded pool filling up, e.g. the KV spill tier): the
        # sentinel only flags them past their declared cap (never, if the
        # cap is None)
        self._bounded: dict[str, float | None] = {}
        self.device = None      # what device_stats() reads

    # -- accounting ------------------------------------------------------
    def add(self, tag: str, nbytes: float):
        self._update(tag, nbytes, relative=True)

    def sub(self, tag: str, nbytes: float):
        self._update(tag, -nbytes, relative=True)

    def set(self, tag: str, nbytes: float):
        self._update(tag, nbytes, relative=False)

    def expect_bounded(self, tag: str, cap_bytes: float | None = None):
        """Declare ``tag``'s growth expected by design (a pool that fills
        to a capacity and stays there — spill tiers, arenas). The leak
        sentinel stops flagging monotonic growth of the tag while it is
        at or under ``cap_bytes``; with ``cap_bytes=None`` it is never
        flagged. Growth *past* the cap still flags: a bounded pool
        exceeding its bound is precisely a leak."""
        with self._lock:
            self._bounded[tag] = (None if cap_bytes is None
                                  else float(cap_bytes))

    def _update(self, tag, nbytes, relative):
        if not ENABLED[0]:
            return
        with self._lock:
            cur = self._live.get(tag, 0.0)
            new = max(0.0, cur + nbytes if relative else float(nbytes))
            self._live[tag] = new
            peak = max(new, self._peak.get(tag, 0.0))
            self._peak[tag] = peak
            total = sum(self._live.values())
            if total > self._total_peak:
                self._total_peak = total
                self._peak_snapshot = dict(self._live)
            self._timeline.append(
                {"t": time.monotonic(), "tag": tag, "live": new,
                 "total": total})
        pm = _perf_metrics()
        pm.mem_live.labels(tag=tag).set(new)
        pm.mem_peak.labels(tag=tag).set(peak)

    # -- inspection ------------------------------------------------------
    def live(self, tag: str | None = None) -> float:
        with self._lock:
            if tag is None:
                return sum(self._live.values())
            return self._live.get(tag, 0.0)

    def peak(self, tag: str | None = None) -> float:
        with self._lock:
            if tag is None:
                return self._total_peak
            return self._peak.get(tag, 0.0)

    def peak_attribution(self) -> dict:
        """What was live, per tag, at the moment the total peaked."""
        with self._lock:
            return {"total_peak_bytes": self._total_peak,
                    "live_at_peak": dict(self._peak_snapshot)}

    def timeline(self) -> list[dict]:
        with self._lock:
            return list(self._timeline)

    def watch_device(self, device):
        """The device :meth:`device_stats` reads (the serving engine passes
        its model's)."""
        self.device = device

    def device_stats(self) -> dict | None:
        """``torch.cuda.memory_stats()`` of the watched CUDA device
        (allocated / reserved / active bytes, current and peak, the
        allocator's counts); None when the watched device is the CPU or
        none was given."""
        dev = self.device
        if dev is None:
            return None
        import torch

        dev = torch.device(dev)
        if dev.type != "cuda":
            return None
        return dict(torch.cuda.memory_stats(dev))

    def snapshot(self) -> dict:
        with self._lock:
            tags = {t: {"live_bytes": self._live.get(t, 0.0),
                        "peak_bytes": self._peak.get(t, 0.0)}
                    for t in sorted(set(self._live) | set(self._peak))}
            out = {"tags": tags,
                   "total_live_bytes": sum(self._live.values()),
                   "total_peak_bytes": self._total_peak,
                   "live_at_peak": dict(self._peak_snapshot)}
        out["device"] = self.device_stats()
        out["leaks"] = self.leak_report()
        return out

    # -- leak sentinel ---------------------------------------------------
    def note_step(self):
        """Stamp the end-of-step watermark for every tracked tag (call at
        step/request boundaries — steady state should oscillate, not
        climb)."""
        if not ENABLED[0]:
            return
        flagged = []
        with self._lock:
            for tag, live in self._live.items():
                d = self._steps.setdefault(
                    tag, deque(maxlen=self.leak_window))
                d.append(live)
                if tag in self._bounded:
                    cap = self._bounded[tag]
                    if cap is None or live <= cap:
                        self._leak_flagged.discard(tag)
                        continue
                if self._is_leaking(d):
                    if tag not in self._leak_flagged:
                        self._leak_flagged.add(tag)
                        flagged.append((tag, d[-1] - d[0]))
                else:
                    self._leak_flagged.discard(tag)
        for tag, growth in flagged:
            _perf_metrics().leaks.labels(tag=tag).inc()
            record_event("memory.leak", tag=tag, growth_bytes=growth,
                         window_steps=self.leak_window)

    def _is_leaking(self, d: deque) -> bool:
        if len(d) < self.leak_window:
            return False
        vals = list(d)
        return (all(b >= a for a, b in zip(vals, vals[1:]))
                and vals[-1] > vals[0])

    def leak_report(self) -> dict:
        with self._lock:
            return {tag: {"growth_bytes": self._steps[tag][-1]
                          - self._steps[tag][0],
                          "window_steps": len(self._steps[tag])}
                    for tag in sorted(self._leak_flagged)}

    def clear(self):
        with self._lock:
            self._live.clear()
            self._peak.clear()
            self._total_peak = 0.0
            self._peak_snapshot = {}
            self._timeline.clear()
            self._steps.clear()
            self._leak_flagged.clear()
            self._bounded.clear()


# ---------------------------------------------------------------------------
# StepTimeline
# ---------------------------------------------------------------------------

PHASES = ("data", "h2d", "compute", "collective", "update", "other")

_TLS = threading.local()


def _step_stack() -> list:
    st = getattr(_TLS, "steps", None)
    if st is None:
        st = _TLS.steps = []
    return st


def note_phase(phase: str, seconds: float):
    """Attribute ``seconds`` to ``phase`` of the innermost active step on
    this thread (no-op otherwise) — how eager collectives land in the
    ``collective`` phase without the step loop knowing about them."""
    st = getattr(_TLS, "steps", None)
    if st:
        st[-1].note(phase, seconds)


class _StepCtx:
    __slots__ = ("timeline", "t0", "phases")

    def __init__(self, timeline):
        self.timeline = timeline
        self.t0 = None
        self.phases: dict[str, float] = {}

    def note(self, phase, seconds):
        self.phases[phase] = self.phases.get(phase, 0.0) + float(seconds)

    def __enter__(self):
        self.t0 = time.monotonic()
        _step_stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        st = _step_stack()
        if st and st[-1] is self:
            st.pop()
        if exc_type is None and ENABLED[0]:
            self.timeline.record_step(time.monotonic() - self.t0,
                                      self.phases)
        return False


class _PhaseCtx:
    __slots__ = ("step", "name", "t0")

    def __init__(self, step, name):
        self.step = step
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.step is not None:
            self.step.note(self.name, time.monotonic() - self.t0)
        return False


def _pct(sorted_vals: list, q: float):
    """Nearest-rank-with-interpolation percentile of an ascending list."""
    if not sorted_vals:
        return None
    k = q * (len(sorted_vals) - 1)
    lo = int(k)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = k - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class StepTimeline:
    """Rolling per-phase step-time accounting with regression attribution.

    ``with tl.step():`` opens a step; ``with tl.phase("data"):`` (or
    :func:`note_phase` from anywhere below) attributes wall time inside
    it. Un-attributed time lands in ``other``. After ``min_baseline``
    steps, a step slower than ``regress_factor`` x the rolling median is
    a regression: the culprit is the phase that grew most over its own
    median, recorded in ``step_regressions_total{timeline,phase}`` and a
    ``step.regression`` flight event.
    """

    def __init__(self, name: str, window: int = 128,
                 regress_factor: float = 1.5, min_baseline: int = 8):
        self.name = name
        self.window = int(window)
        self.regress_factor = float(regress_factor)
        self.min_baseline = int(min_baseline)
        self._lock = locksan.Lock("perf.step_timeline")
        self._totals: deque = deque(maxlen=self.window)
        self._phases: dict[str, deque] = {}
        self.steps = 0
        self.regressions = 0
        self.last_regression: dict | None = None

    def step(self) -> _StepCtx:
        return _StepCtx(self)

    def phase(self, name: str) -> _PhaseCtx:
        st = _step_stack()
        # attribute to this timeline's innermost step (or any active one)
        mine = next((s for s in reversed(st) if s.timeline is self),
                    st[-1] if st else None)
        return _PhaseCtx(mine, name)

    # -- the core record (step() feeds it; tests can too) ---------------
    def record_step(self, total_s: float, phases: dict):
        if not ENABLED[0]:
            return    # telemetry.disable(): one flag check, like every
        total_s = float(total_s)  # other write path
        attributed = sum(phases.values())
        phases = dict(phases)
        phases["other"] = max(0.0, total_s - attributed)
        with self._lock:
            baseline = _pct(sorted(self._totals), 0.5)
            n_prior = len(self._totals)
            self._totals.append(total_s)
            for ph, v in phases.items():
                self._phases.setdefault(
                    ph, deque(maxlen=self.window)).append(v)
            self.steps += 1
        pm = _perf_metrics()
        pm.step_s.labels(timeline=self.name).observe(total_s)
        for ph, v in phases.items():
            if v > 0:
                pm.phase_s.labels(timeline=self.name, phase=ph).observe(v)
        if (baseline is not None and n_prior >= self.min_baseline
                and total_s > self.regress_factor * baseline):
            self._flag_regression(total_s, baseline, phases)

    def _flag_regression(self, total_s, baseline, phases):
        culprit, growth = "other", float("-inf")
        with self._lock:
            for ph, v in phases.items():
                hist = list(self._phases.get(ph, ()))[:-1]
                ph_base = _pct(sorted(hist), 0.5) or 0.0
                if v - ph_base > growth:
                    culprit, growth = ph, v - ph_base
            self.regressions += 1
            self.last_regression = {
                "step_s": total_s, "baseline_s": baseline,
                "culprit": culprit, "culprit_growth_s": max(growth, 0.0),
            }
        _perf_metrics().regressions.labels(
            timeline=self.name, phase=culprit).inc()
        record_event("step.regression", timeline=self.name,
                     step_s=round(total_s, 6),
                     baseline_s=round(baseline, 6), culprit=culprit)

    # -- inspection ------------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            totals = sorted(self._totals)
            if not totals:
                return {"timeline": self.name, "steps": 0}
            total_sum = sum(totals)
            out = {
                "timeline": self.name,
                "steps": self.steps,
                "step_s": {"p50": _pct(totals, 0.5),
                           "p90": _pct(totals, 0.9),
                           "p99": _pct(totals, 0.99),
                           "mean": total_sum / len(totals)},
                "phases": {},
                "regressions": self.regressions,
                "last_regression": (dict(self.last_regression)
                                    if self.last_regression else None),
            }
            for ph, d in self._phases.items():
                vals = sorted(d)
                s = sum(vals)
                out["phases"][ph] = {
                    "p50": _pct(vals, 0.5), "p90": _pct(vals, 0.9),
                    "p99": _pct(vals, 0.99),
                    "mean": s / len(vals),
                    "frac": s / total_sum if total_sum else 0.0,
                }
        return out

    def clear(self):
        with self._lock:
            self._totals.clear()
            self._phases.clear()
            self.steps = 0
            self.regressions = 0
            self.last_regression = None


# ---------------------------------------------------------------------------
# process-global instances + hooks
# ---------------------------------------------------------------------------

_WATCHER = CompileWatcher()
_MEMORY = MemoryMonitor()
_TIMELINES: dict[str, StepTimeline] = {}
_TIMELINES_LOCK = locksan.Lock("perf.timelines")


def compile_watcher() -> CompileWatcher:
    """The process-global watcher every compile point reports into."""
    return _WATCHER


def memory_monitor() -> MemoryMonitor:
    return _MEMORY


def step_timeline(name: str) -> StepTimeline:
    """Get-or-create the named timeline ("train", "decode", ...)."""
    tl = _TIMELINES.get(name)
    if tl is None:
        with _TIMELINES_LOCK:
            tl = _TIMELINES.setdefault(name, StepTimeline(name))
    return tl


def explain_recompile(name: str | None = None) -> dict | None:
    """Module-level shorthand: the global watcher's signature diff."""
    return _WATCHER.explain(name)


def run_meta() -> dict:
    """The ``__meta__`` stamp artifacts carry so comparisons across
    platforms can be refused: git sha, the torch and CUDA versions, the
    platform and the card's name, host, wall time."""
    meta = {"wall_time": time.time(),
            "python": sys.version.split()[0],
            "host": socket.gethostname(),
            "pid": os.getpid()}
    import torch

    meta["torch_version"] = torch.__version__
    meta["cuda_version"] = torch.version.cuda
    if torch.cuda.is_available():
        meta["platform"] = "cuda"
        meta["device_name"] = torch.cuda.get_device_name(0)
    else:
        meta["platform"] = "cpu"
        meta["device_name"] = None
    try:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        meta["git_sha"] = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo, timeout=5,
            capture_output=True, text=True).stdout.strip() or None
    except Exception:  # lint: allow-silent(absence is recorded as None in the report)
        meta["git_sha"] = None
    return meta


def reset():
    """Clear every monitor's state (tests / chaos isolation). Metric
    families stay registered; their values persist (counters are
    cumulative by design)."""
    _WATCHER.clear()
    _MEMORY.clear()
    with _TIMELINES_LOCK:
        for tl in _TIMELINES.values():
            tl.clear()
