"""Metrics history: a bounded in-process time-series store over the registry
(counterpart of ``paddle_tpu/telemetry/history.py``, kept as it is).

The registry (:mod:`paddle_tpu_torch.telemetry.metrics`) is *instantaneous* — a
scrape sees the current counter value and nothing else. Operating a fleet
needs the other axis: "what was goodput doing for the last five minutes",
"did journal segments grow monotonically before the crash", "what did the
decode p99 look like while the breaker was open". :class:`TimeSeriesStore`
is that axis, kept deliberately small:

- A background sampler (``telemetry-history-sampler``) snapshots the
  registry every ``interval_s`` into per-series **downsampling rings**:
  a raw ring (one point per tick) plus 10s and 1m rollup rings, each
  bounded, so total memory is fixed regardless of uptime.
- **Counters are stored as rates** (delta / dt against the previous
  cumulative value — a restart shows as a rate dip, not a cliff of
  -1e9), gauges as values, and **histograms as quantile summaries**
  ({rate, mean, p50, p90, p99} derived from bucket deltas between
  consecutive snapshots).
- Rollups are pure functions of the sample sequence: the same snapshots
  fed at the same timestamps produce byte-identical rollup rings
  (clocks are injectable), which is what makes the ring math testable.
- :meth:`TimeSeriesStore.query` serves the alert engine; :meth:`TimeSeriesStore.last_window` is
  the compact slice attached to every flight-recorder dump and
  postmortem bundle, so an autopsy answers "what was happening the five
  minutes *before* it died" instead of only "what was true at death".
- :meth:`add_source` lets non-registry collectors (e.g. a chaos harness
  sampling rank publish sequence numbers off the TCPStore) inject extra
  families into the same rings; absence alerting keys off those.

Sampling overhead is self-measured and exported (``history_overhead_frac``:
sampler busy-time over elapsed time) so the cost of observing is itself
observable.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

from . import flight_recorder
from .metrics import ENABLED, registry
from ..analysis import locksan

__all__ = [
    "TimeSeriesStore", "install", "installed", "uninstall",
    "RESOLUTIONS", "HISTORY_FLIGHT_PROVIDER",
]

# Resolution tiers: name -> rollup period in seconds (None = raw ticks).
RESOLUTIONS = (("raw", None), ("10s", 10.0), ("1m", 60.0))
_PERIODS = dict(RESOLUTIONS)

# Histogram-summary fields aggregated by max in rollups (tail quantiles
# should not be averaged away); everything else numeric rolls up by mean.
_MAX_FIELDS = ("p50", "p90", "p99")

HISTORY_FLIGHT_PROVIDER = "history"

_M = [None]


def _m():
    """Self-metrics, registered lazily into the global registry."""
    if _M[0] is None:
        reg = registry()
        class NS:
            samples = reg.counter(
                "history_samples_total", "registry snapshots ingested")
            points = reg.counter(
                "history_points_total", "raw points appended across series")
            series = reg.gauge(
                "history_series", "live time series tracked")
            dropped = reg.counter(
                "history_series_dropped_total",
                "new series rejected by the max_series cap")
            sample_s = reg.histogram(
                "history_sample_seconds", "wall cost of one sample tick",
                buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                         0.1, 0.25))
            overhead = reg.gauge(
                "history_overhead_frac",
                "sampler busy-time fraction since start (self-measured)")
            source_errors = reg.counter(
                "history_source_errors_total",
                "external source callbacks that raised", labels=("source",))
        _M[0] = NS
    return _M[0]


def _quantile(edges, cums, count, q):
    """Linear-interpolated quantile from cumulative bucket counts (the
    ``metrics_dump`` convention). ``edges`` excludes +Inf; the overflow
    bucket clamps to the top finite edge."""
    if count <= 0:
        return None
    target = q * count
    prev_cum, prev_edge = 0, 0.0
    for edge, cum in zip(edges, cums):
        if cum >= target:
            span = cum - prev_cum
            frac = (target - prev_cum) / span if span else 1.0
            return prev_edge + (edge - prev_edge) * frac
        prev_cum, prev_edge = cum, edge
    return edges[-1] if edges else None


def _rollup(points):
    """Aggregate a list of point values into one rollup point. Scalars
    roll up to {n, mean, min, max, last}; dict points (histogram
    summaries) roll up field-wise — mean for rates/means, max for tail
    quantiles — skipping None fields. Pure function: same points in the
    same order -> same output."""
    if not points:
        return None
    if isinstance(points[0], dict):
        out = {"n": len(points)}
        fields = []
        for p in points:
            for f in p:
                if f not in fields:
                    fields.append(f)
        for f in fields:
            vals = [p[f] for p in points
                    if isinstance(p.get(f), (int, float))]
            if not vals:
                out[f] = None
            elif f in _MAX_FIELDS:
                out[f] = max(vals)
            else:
                out[f] = sum(vals) / len(vals)
        return out
    vals = [float(p) for p in points]
    return {"n": len(vals), "mean": sum(vals) / len(vals),
            "min": min(vals), "max": max(vals), "last": vals[-1]}


class _RollupRing:
    """One rollup tier: buckets of ``period`` seconds, finalized when a
    sample lands in a later bucket, kept in a bounded deque."""

    __slots__ = ("period", "ring", "cur_bucket", "cur_wall", "cur_points")

    def __init__(self, period: float, maxlen: int):
        self.period = float(period)
        self.ring: deque = deque(maxlen=maxlen)
        self.cur_bucket: float | None = None
        self.cur_wall = 0.0
        self.cur_points: list = []

    def add(self, t: float, wall: float, point):
        bucket = (t // self.period) * self.period
        if self.cur_bucket is None:
            self.cur_bucket = bucket
        elif bucket != self.cur_bucket:
            agg = _rollup(self.cur_points)
            if agg is not None:
                self.ring.append((self.cur_bucket, self.cur_wall, agg))
            self.cur_bucket, self.cur_points = bucket, []
        self.cur_wall = wall
        self.cur_points.append(point)

    def points(self):
        """Finalized buckets plus the live partial bucket (aggregated on
        the fly — still deterministic given the same sample sequence)."""
        out = list(self.ring)
        if self.cur_points:
            agg = _rollup(self.cur_points)
            if agg is not None:
                out.append((self.cur_bucket, self.cur_wall, agg))
        return out


class _Series:
    __slots__ = ("family", "kind", "labels", "raw", "rollups",
                 "prev_t", "prev_counter", "prev_hist")

    def __init__(self, family, kind, labels, raw_points, rollup_points):
        self.family = family
        self.kind = kind
        self.labels = dict(labels)
        self.raw: deque = deque(maxlen=raw_points)
        self.rollups = {name: _RollupRing(period, rollup_points)
                        for name, period in RESOLUTIONS if period}
        self.prev_t: float | None = None
        self.prev_counter: float | None = None
        # (count, sum, cumulative-bucket list) at the previous sample
        self.prev_hist: tuple | None = None

    def add(self, t: float, wall: float, point):
        self.raw.append((t, wall, point))
        for ring in self.rollups.values():
            ring.add(t, wall, point)

    def points(self, res: str):
        if res == "raw":
            return list(self.raw)
        return self.rollups[res].points()


class TimeSeriesStore:
    """Bounded metrics history over a :class:`MetricsRegistry`.

    ``clock`` must be monotonic (durations and bucket edges come from it);
    ``wall_clock`` only stamps points for display. Both are injectable so
    ring math is deterministic under test.
    """

    def __init__(self, reg=None, *, interval_s: float = 1.0,
                 raw_points: int = 600, rollup_points: int = 360,
                 max_series: int = 4096, flight_window_s: float = 300.0,
                 clock=time.monotonic, wall_clock=time.time):
        self.reg = reg if reg is not None else registry()
        self.interval_s = float(interval_s)
        self.raw_points = int(raw_points)
        self.rollup_points = int(rollup_points)
        self.max_series = int(max_series)
        self.flight_window_s = float(flight_window_s)
        self.clock = clock
        self.wall_clock = wall_clock
        self._series: dict[tuple, _Series] = {}
        self._sources: dict[str, object] = {}
        self._lock = locksan.Lock("history.store")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._started_t: float | None = None
        self._busy_s = 0.0
        self.samples = 0

    # -- sources ----------------------------------------------------------
    def add_source(self, name: str, fn):
        """Register an external collector: ``fn() -> {family: {"type":
        kind, "series": [{"labels": {...}, "value": v}, ...]}}`` merged
        into every sample tick (counters from sources get the same
        rate treatment as registry counters)."""
        with self._lock:
            self._sources[str(name)] = fn

    def remove_source(self, name: str):
        with self._lock:
            self._sources.pop(str(name), None)

    # -- ingestion --------------------------------------------------------
    def sample_once(self) -> int:
        """Snapshot the registry (+ sources) into the rings once.
        Returns the number of points appended. Never raises on source
        failures (counted per-source instead)."""
        t0 = time.perf_counter()
        t, wall = self.clock(), self.wall_clock()
        doc = self.reg.snapshot()
        with self._lock:
            sources = dict(self._sources)
        for name, fn in sources.items():
            try:
                extra = fn() or {}
                for fam, block in extra.items():
                    have = doc.get(fam)
                    if have is None:
                        doc[fam] = block
                    else:
                        # the local registry may already expose this
                        # family (e.g. cluster_publish_total is registered
                        # in every process) — source series carry their
                        # own label sets, so merge rather than discard
                        have = dict(have)
                        have["series"] = (list(have.get("series", ()))
                                          + list(block.get("series", ())))
                        doc[fam] = have
            except Exception:  # a broken source must not stop the sampler; counted per-source
                _m().source_errors.labels(source=name).inc()
        n = self._ingest(doc, t, wall)
        dt = time.perf_counter() - t0
        self._busy_s += dt
        m = _m()
        m.samples.inc()
        m.sample_s.observe(dt)
        if self._started_t is not None:
            elapsed = max(self.clock() - self._started_t, 1e-9)
            m.overhead.set(min(self._busy_s / elapsed, 1.0))
        return n

    def _ingest(self, doc: dict, t: float, wall: float) -> int:
        """Feed one snapshot dict at (t, wall). Split out from
        :meth:`sample_once` so replay/tests can feed recorded snapshot
        sequences and assert identical rollups."""
        added = 0
        with self._lock:
            for fam, block in doc.items():
                if fam.startswith("__") or not isinstance(block, dict):
                    continue
                kind = block.get("type")
                if kind not in ("counter", "gauge", "histogram"):
                    continue
                for s in block.get("series", ()):
                    labels = s.get("labels") or {}
                    key = (fam, tuple(sorted(labels.items())))
                    ser = self._series.get(key)
                    if ser is None:
                        if len(self._series) >= self.max_series:
                            _m().dropped.inc()
                            continue
                        ser = _Series(fam, kind, labels,
                                      self.raw_points, self.rollup_points)
                        self._series[key] = ser
                    point = self._to_point(ser, s, t)
                    if point is not None:
                        ser.add(t, wall, point)
                        added += 1
            _m().series.set(len(self._series))
        self.samples += 1
        if added:
            _m().points.inc(added)
        return added

    def _to_point(self, ser: _Series, s: dict, t: float):
        """Convert one snapshot series entry into a point: gauge value,
        counter rate, or histogram quantile summary. Returns None for the
        first counter/histogram sample (no interval to rate over yet)."""
        if ser.kind == "gauge":
            return float(s.get("value", 0.0))
        if ser.kind == "counter":
            v = float(s.get("value", 0.0))
            prev_t, prev_v = ser.prev_t, ser.prev_counter
            ser.prev_t, ser.prev_counter = t, v
            if prev_t is None or t <= prev_t:
                return None
            delta = v - prev_v if v >= prev_v else v  # reset -> restart
            return max(delta, 0.0) / (t - prev_t)
        # histogram
        buckets = s.get("buckets") or {}
        edges = sorted(float(e) for e in buckets)
        cums = [int(buckets[k]) for k in
                sorted(buckets, key=lambda k: float(k))]
        count = int(s.get("count", 0))
        total = float(s.get("sum", 0.0))
        prev = ser.prev_hist
        prev_t = ser.prev_t
        ser.prev_hist = (count, total, cums)
        ser.prev_t = t
        if prev is None or prev_t is None or t <= prev_t:
            return None
        pc, ps, pcums = prev
        if count < pc or len(pcums) != len(cums):  # reset/reshape
            pc, ps, pcums = 0, 0.0, [0] * len(cums)
        dc = count - pc
        dcums = [c - p for c, p in zip(cums, pcums)]
        point = {"rate": dc / (t - prev_t)}
        if dc > 0:
            point["mean"] = (total - ps) / dc
            for q, f in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                point[f] = _quantile(edges, dcums, dc, q)
        else:
            point.update(mean=None, p50=None, p90=None, p99=None)
        return point

    # -- the sampler thread -----------------------------------------------
    def start(self):
        """Start the background sampler (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._started_t = self.clock()
        self._busy_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name="telemetry-history-sampler", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            if not ENABLED[0]:
                continue
            try:
                self.sample_once()
            except Exception:  # the sampler must outlive any one bad snapshot; next tick retries
                pass

    def stop(self):
        self._stop.set()
        th = self._thread
        if th is not None:
            th.join(timeout=5.0)
        self._thread = None

    # -- queries ----------------------------------------------------------
    def families(self) -> list[dict]:
        with self._lock:
            fams: dict[str, dict] = {}
            for (fam, _), ser in sorted(self._series.items()):
                f = fams.setdefault(fam, {"family": fam, "type": ser.kind,
                                          "series": 0})
                f["series"] += 1
            return list(fams.values())

    def query(self, family: str, labels: dict | None = None,
              window_s: float | None = None, res: str = "raw") -> dict:
        """Points for one family: ``{"family", "type", "res", "series":
        [{"labels", "points": [{"t", "wall", "v"}, ...]}]}``. ``labels``
        is a subset filter; ``window_s`` trims to the trailing window of
        the (monotonic) sample clock."""
        if res not in _PERIODS:
            raise ValueError(f"unknown resolution {res!r}; "
                             f"one of {sorted(_PERIODS)}")
        now = self.clock()
        labels = labels or {}
        out = {"family": family, "type": None, "res": res, "series": []}
        with self._lock:
            for (fam, _), ser in sorted(self._series.items()):
                if fam != family:
                    continue
                if any(str(ser.labels.get(k)) != str(v)
                       for k, v in labels.items()):
                    continue
                out["type"] = ser.kind
                pts = ser.points(res)
                if window_s is not None:
                    cutoff = now - float(window_s)
                    pts = [p for p in pts if p[0] >= cutoff]
                out["series"].append({
                    "labels": dict(ser.labels),
                    "points": [{"t": p[0], "wall": p[1], "v": p[2]}
                               for p in pts],
                })
        return out

    def last_window(self, window_s: float | None = None,
                    max_points_per_series: int = 120) -> dict:
        """The compact slice a flight dump / postmortem bundle carries:
        every family, trailing ``window_s``, at the coarsest resolution
        that still covers the window, tail-capped per series."""
        window_s = self.flight_window_s if window_s is None else window_s
        res = "raw"
        if self.raw_points * self.interval_s < window_s:
            res = "10s" if self.rollup_points * 10.0 >= window_s else "1m"
        now = self.clock()
        cutoff = now - float(window_s)
        fams: dict[str, dict] = {}
        with self._lock:
            n_series = len(self._series)
            for (fam, _), ser in sorted(self._series.items()):
                pts = [p for p in ser.points(res) if p[0] >= cutoff]
                pts = pts[-max_points_per_series:]
                if not pts:
                    continue
                block = fams.setdefault(fam, {"type": ser.kind,
                                              "series": []})
                block["series"].append({
                    "labels": dict(ser.labels),
                    "points": [[round(p[0], 4), round(p[1], 3), p[2]]
                               for p in pts],
                })
        return {
            "window_s": window_s, "res": res,
            "captured_wall": self.wall_clock(), "captured_t": now,
            "interval_s": self.interval_s, "n_series": n_series,
            "samples": self.samples,
            "families": fams,
        }

    # -- export / import --------------------------------------------------
    def to_doc(self) -> dict:
        """Full JSON-able dump of every ring (raw + finalized rollups)."""
        with self._lock:
            series = []
            for (fam, _), ser in sorted(self._series.items()):
                series.append({
                    "family": fam, "type": ser.kind,
                    "labels": dict(ser.labels),
                    "raw": [list(p) for p in ser.raw],
                    "rollups": {name: [list(p) for p in ring.points()]
                                for name, ring in ser.rollups.items()},
                })
        return {
            "version": 1,
            "config": {"interval_s": self.interval_s,
                       "raw_points": self.raw_points,
                       "rollup_points": self.rollup_points},
            "samples": self.samples,
            "series": series,
        }

    def export_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, indent=1, default=str)
        return path

    @classmethod
    def from_doc(cls, doc: dict, **kw) -> "TimeSeriesStore":
        """Rebuild a (query-only) store from :meth:`to_doc` output —
        postmortem tooling loads a bundle's history back and queries it
        like a live one. Rate state is not restored; a revived store fed
        new samples treats the first tick as a fresh baseline."""
        cfg = doc.get("config", {})
        store = cls(reg=kw.pop("reg", None),
                    interval_s=cfg.get("interval_s", 1.0),
                    raw_points=cfg.get("raw_points", 600),
                    rollup_points=cfg.get("rollup_points", 360), **kw)
        store.samples = int(doc.get("samples", 0))
        for s in doc.get("series", ()):
            key = (s["family"], tuple(sorted((s.get("labels") or {}).items())))
            ser = _Series(s["family"], s.get("type", "gauge"),
                          s.get("labels") or {},
                          store.raw_points, store.rollup_points)
            for p in s.get("raw", ()):
                ser.raw.append((p[0], p[1], p[2]))
            for name, pts in (s.get("rollups") or {}).items():
                ring = ser.rollups.get(name)
                if ring is None:
                    continue
                for p in pts:
                    ring.ring.append((p[0], p[1], p[2]))
            store._series[key] = ser
        return store

    @classmethod
    def import_json(cls, path: str, **kw) -> "TimeSeriesStore":
        with open(path) as f:
            return cls.from_doc(json.load(f), **kw)

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            n = len(self._series)
        overhead = 0.0
        if self._started_t is not None:
            elapsed = max(self.clock() - self._started_t, 1e-9)
            overhead = min(self._busy_s / elapsed, 1.0)
        return {"series": n, "samples": self.samples,
                "interval_s": self.interval_s,
                "running": bool(self._thread and self._thread.is_alive()),
                "overhead_frac": overhead,
                "sources": sorted(self._sources)}


_INSTALLED: list = [None]


def install(store: TimeSeriesStore | None = None, *, start: bool = True,
            **kw) -> TimeSeriesStore:
    """Install ``store`` (or a fresh one built with ``**kw``) as the
    process-global history: starts its sampler and registers the
    flight-recorder context provider so every dump carries the last
    window. Idempotent-ish: installing over an existing store stops the
    old sampler first."""
    old = _INSTALLED[0]
    if old is not None and old is not store:
        old.stop()
    if store is None:
        store = TimeSeriesStore(**kw)
    _INSTALLED[0] = store
    flight_recorder.register_context_provider(
        HISTORY_FLIGHT_PROVIDER, lambda: store.last_window())
    if start:
        store.start()
    return store


def installed() -> TimeSeriesStore | None:
    return _INSTALLED[0]


def uninstall():
    store = _INSTALLED[0]
    _INSTALLED[0] = None
    flight_recorder.unregister_context_provider(HISTORY_FLIGHT_PROVIDER)
    if store is not None:
        store.stop()


# Re-exported for metrics_dump-style consumers that want the same
# interpolation on delta buckets.
quantile_from_buckets = _quantile
