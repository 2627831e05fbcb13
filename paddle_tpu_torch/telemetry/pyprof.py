"""Continuous sampling profiler: where wall-clock time actually goes
(counterpart of ``paddle_tpu/telemetry/pyprof.py``, kept as it is).

A daemon thread (``telemetry-pyprof``) wakes at ``hz`` and snapshots
``sys._current_frames()`` — every live thread's Python stack — and
aggregates them into a bounded ``stack -> sample count`` table. Stacks
are keyed **root-first by thread name** (``serving-engine-0``,
``telemetry-history-sampler``, ...), so the profile reads as one
flamegraph per subsystem with zero symbol munging:

    serving-engine-0;engine.py:step;attention.py:paged_attn   412
    telemetry-history-sampler;history.py:sample_once           9

Two export formats, both dependency-free: folded flamegraph lines
(:meth:`SamplingProfiler.folded` — pipe into any flamegraph renderer)
and speedscope JSON (:meth:`SamplingProfiler.speedscope` — drag onto
https://speedscope.app). The sampler's own cost is self-measured and
exported (``pyprof_overhead_frac``: sampling busy-time over elapsed
time).

Fleet view: when a profiler is :func:`install`-ed, the cluster
``RankPublisher`` ships its folded top-N with every heartbeat and
``ClusterAggregator.merged_profile()`` sums identical stacks across
ranks — one flame view for the whole fleet.
"""
from __future__ import annotations

import os
import sys
import threading
import time

from .metrics import ENABLED, registry
from ..analysis import locksan

__all__ = ["SamplingProfiler", "install", "installed", "uninstall",
           "merge_folded", "parse_folded"]

_M = [None]


def _m():
    if _M[0] is None:
        reg = registry()
        class NS:
            samples = reg.counter(
                "pyprof_samples_total", "profiler sampling ticks")
            stacks_seen = reg.counter(
                "pyprof_stack_samples_total",
                "thread-stack observations aggregated")
            distinct = reg.gauge(
                "pyprof_distinct_stacks", "distinct stacks in the table")
            threads = reg.gauge(
                "pyprof_threads", "threads seen in the last sample")
            dropped = reg.counter(
                "pyprof_stacks_dropped_total",
                "stack observations rejected by the max_stacks cap")
            sample_s = reg.histogram(
                "pyprof_sample_seconds", "wall cost of one sampling tick",
                buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                         0.01, 0.025))
            overhead = reg.gauge(
                "pyprof_overhead_frac",
                "profiler busy-time fraction since start (self-measured)")
        _M[0] = NS
    return _M[0]


def _frame_name(frame) -> str:
    code = frame.f_code
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class SamplingProfiler:
    """Aggregating wall-clock sampler over ``sys._current_frames()``."""

    def __init__(self, hz: float = 29.0, *, max_stacks: int = 4096,
                 max_depth: int = 64, clock=time.monotonic):
        if hz <= 0:
            raise ValueError(f"hz must be positive, got {hz}")
        self.hz = float(hz)
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self.clock = clock
        self._counts: dict[str, int] = {}
        self._lock = locksan.Lock("pyprof.table")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._started_t: float | None = None
        self._busy_s = 0.0
        self.samples = 0
        self.stack_samples = 0

    # -- sampling ----------------------------------------------------------
    def sample_once(self) -> int:
        """Snapshot every thread's stack into the table once. Returns the
        number of thread-stacks recorded."""
        t0 = time.perf_counter()
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        recorded = 0
        rows = []
        for ident, frame in frames.items():
            if ident == me:
                continue  # the profiler profiling itself is pure noise
            parts = []
            f = frame
            while f is not None and len(parts) < self.max_depth:
                parts.append(_frame_name(f))
                f = f.f_back
            parts.append(names.get(ident, f"thread-{ident}"))
            parts.reverse()  # root (thread name) first, leaf last
            rows.append(";".join(parts))
        del frames  # drop frame refs promptly
        m = _m()
        with self._lock:
            for key in rows:
                if (key not in self._counts
                        and len(self._counts) >= self.max_stacks):
                    m.dropped.inc()
                    continue
                self._counts[key] = self._counts.get(key, 0) + 1
                recorded += 1
            self.samples += 1
            self.stack_samples += recorded
            n_distinct = len(self._counts)
        dt = time.perf_counter() - t0
        self._busy_s += dt
        m.samples.inc()
        m.stacks_seen.inc(recorded)
        m.sample_s.observe(dt)
        m.distinct.set(n_distinct)
        m.threads.set(len(rows))
        if self._started_t is not None:
            elapsed = max(self.clock() - self._started_t, 1e-9)
            m.overhead.set(min(self._busy_s / elapsed, 1.0))
        return recorded

    # -- the sampler thread ------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._started_t = self.clock()
        self._busy_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name="telemetry-pyprof", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            if not ENABLED[0]:
                continue
            try:
                self.sample_once()
            except Exception:  # lint: allow-silent(the profiler must outlive any one bad tick; next tick retries)
                pass

    def stop(self):
        self._stop.set()
        th = self._thread
        if th is not None:
            th.join(timeout=5.0)
        self._thread = None

    def reset(self):
        with self._lock:
            self._counts.clear()
            self.samples = 0
            self.stack_samples = 0
        self._busy_s = 0.0
        if self._started_t is not None:
            self._started_t = self.clock()

    # -- exports -----------------------------------------------------------
    def folded_dict(self, top_n: int | None = None) -> dict[str, int]:
        """``{stack-key: samples}``, optionally only the top-N heaviest
        (what the cluster publisher ships)."""
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        if top_n is not None:
            items = items[:top_n]
        return dict(items)

    def folded(self, top_n: int | None = None) -> str:
        """Folded flamegraph lines: ``root;frame;...;leaf count``."""
        return "\n".join(f"{k} {v}"
                         for k, v in self.folded_dict(top_n).items())

    def speedscope(self, name: str = "paddle_tpu_torch") -> dict:
        """Speedscope sampled-profile JSON, one profile per root thread."""
        return folded_to_speedscope(self.folded_dict(), name=name,
                                    hz=self.hz)

    def overhead_frac(self) -> float:
        if self._started_t is None:
            return 0.0
        elapsed = max(self.clock() - self._started_t, 1e-9)
        return min(self._busy_s / elapsed, 1.0)

    def stats(self) -> dict:
        with self._lock:
            distinct = len(self._counts)
        return {"hz": self.hz, "samples": self.samples,
                "stack_samples": self.stack_samples,
                "distinct_stacks": distinct,
                "overhead_frac": self.overhead_frac(),
                "running": bool(self._thread and self._thread.is_alive())}


# -- folded-profile algebra (fleet merge) ----------------------------------

def merge_folded(*folded_dicts) -> dict[str, int]:
    """Sum identical stacks across folded dicts — the fleet-wide flame
    view is just the pointwise sum of per-rank tables."""
    out: dict[str, int] = {}
    for d in folded_dicts:
        for k, v in (d or {}).items():
            out[k] = out.get(k, 0) + int(v)
    return dict(sorted(out.items(), key=lambda kv: (-kv[1], kv[0])))


def parse_folded(text: str) -> dict[str, int]:
    """Inverse of :meth:`SamplingProfiler.folded` (tools re-load dumps)."""
    out: dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, n = line.rpartition(" ")
        if stack and n.isdigit():
            out[stack] = out.get(stack, 0) + int(n)
    return out


def folded_to_speedscope(folded: dict[str, int], *, name: str = "profile",
                         hz: float | None = None) -> dict:
    """Speedscope 'sampled' document from a folded table, one profile per
    root frame (= thread name) so each subsystem gets its own view."""
    frames: list[dict] = []
    index: dict[str, int] = {}

    def fidx(fname: str) -> int:
        i = index.get(fname)
        if i is None:
            i = index[fname] = len(frames)
            frames.append({"name": fname})
        return i

    by_root: dict[str, list[tuple[list[int], int]]] = {}
    for stack, count in folded.items():
        parts = stack.split(";")
        by_root.setdefault(parts[0], []).append(
            ([fidx(p) for p in parts], int(count)))

    profiles = []
    for root in sorted(by_root):
        rows = by_root[root]
        total = sum(w for _, w in rows)
        profiles.append({
            "type": "sampled", "name": root, "unit": "none",
            "startValue": 0, "endValue": total,
            "samples": [s for s, _ in rows],
            "weights": [w for _, w in rows],
        })
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name,
        "exporter": "paddle_tpu_torch.telemetry.pyprof"
                    + (f" @{hz:g}Hz" if hz else ""),
        "shared": {"frames": frames},
        "profiles": profiles,
        "activeProfileIndex": 0,
    }


# -- process-global install ------------------------------------------------

_INSTALLED: list = [None]


def install(profiler: SamplingProfiler | None = None, *, start: bool = True,
            **kw) -> SamplingProfiler:
    """Install ``profiler`` (or a fresh one built with ``**kw``) as the
    process-global profiler; the cluster publisher ships whatever is
    installed here."""
    old = _INSTALLED[0]
    if old is not None and old is not profiler:
        old.stop()
    if profiler is None:
        profiler = SamplingProfiler(**kw)
    _INSTALLED[0] = profiler
    if start:
        profiler.start()
    return profiler


def installed() -> SamplingProfiler | None:
    return _INSTALLED[0]


def uninstall():
    p = _INSTALLED[0]
    _INSTALLED[0] = None
    if p is not None:
        p.stop()
