"""Metrics registry: Counter / Gauge / Histogram with label sets
(counterpart of ``paddle_tpu/telemetry/metrics.py``, kept as it is: the
same families, Prometheus text and JSON snapshot).

The design target is the serving hot path — a decode step emits a handful of
observations per *batch*, an engine emits one TTFT observation per
*request* — so the cost model is: one shared-flag check, one dict hit for a
pre-resolved child, one lock'd float add. Callers that care hold on to the
child object (``registry().counter(...).labels(engine="0")``) once and call
``inc``/``set``/``observe`` on it forever after; the get-or-create path is
for setup code only.

Two export formats, both side-effect free snapshots of live state:

- :meth:`MetricsRegistry.prometheus_text` — the Prometheus text exposition
  format (``# HELP`` / ``# TYPE`` / ``name{label="v"} value``, histogram
  ``_bucket{le=...}`` / ``_sum`` / ``_count`` series), scrapeable as-is.
- :meth:`MetricsRegistry.snapshot` — a JSON-able dict.

``telemetry.disable()`` flips the shared :data:`ENABLED` flag: every write
method returns after one list-index check, which is what keeps a
registry-disabled serving run within noise of an instrumented one.
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
from ..analysis import locksan

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "DEFAULT_BUCKETS", "ENABLED",
]

# Shared kill switch (telemetry.disable()/enable() flip it). A mutable
# single-cell list so tracing / flight_recorder can import THE flag object,
# not a copy of its value.
ENABLED = [True]

# Latency-flavored default buckets (seconds): sub-ms decode steps through
# multi-second checkpoint writes all land on a meaningful edge.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _fmt_exemplar(ex) -> str:
    """OpenMetrics exemplar suffix for a _bucket line (empty when the
    bucket has none — the plain-Prometheus exposition is unchanged then):
    `` # {trace_id="abc"} 0.093 1690000000.0``."""
    if not ex:
        return ""
    labels, value, ts = ex
    ls = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels.items())
    return f" # {{{ls}}} {_fmt(value)} {ts:.3f}"


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    """Prometheus-friendly number: integers without a trailing .0 noise is
    fine either way, but NaN/inf must spell Prometheus's names."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


class _Child:
    """One labeled time series. Holds its own lock; reads are lock-free
    (float/int loads are atomic under the GIL, and consumers tolerate a
    snapshot that is one observation stale)."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = locksan.Lock("metrics.child")


class CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if not ENABLED[0]:
            return
        if amount < 0:
            raise ValueError(f"counter inc({amount}): counters only go up")
        with self._lock:
            self.value += amount


class GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
        self.value = 0.0

    def set(self, value: float):
        if not ENABLED[0]:
            return
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0):
        if not ENABLED[0]:
            return
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)


class HistogramChild(_Child):
    __slots__ = ("buckets", "counts", "sum", "count", "exemplars")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        super().__init__()
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        # bucket index -> (labels, value, unix ts): the last observation
        # that landed in the bucket with an exemplar attached — how a p99
        # TTFT bucket links to the exact request trace that caused it
        # (OpenMetrics exemplar semantics)
        self.exemplars: dict[int, tuple] = {}

    def observe(self, value: float, exemplar: dict | None = None):
        if not ENABLED[0]:
            return
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1
            if exemplar:
                self.exemplars[i] = (dict(exemplar), value, time.time())

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def cumulative(self) -> list[int]:
        """Per-bucket cumulative counts (the Prometheus ``le`` semantics),
        +Inf last."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


_CHILD_TYPES = {"counter": CounterChild, "gauge": GaugeChild,
                "histogram": HistogramChild}


class _Metric:
    """A named metric family: fixed label names, one child per label-value
    tuple. With no label names the family has exactly one (unlabeled) child
    and the write methods proxy to it, so ``registry().counter("x").inc()``
    works without a ``labels()`` hop."""

    kind: str = ""

    def __init__(self, name: str, help: str = "", label_names=(), **opts):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._opts = opts
        self._children: dict[tuple, _Child] = {}
        self._lock = locksan.Lock("metrics.family")
        if not self.label_names:
            self._default = self._make_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self):
        return _CHILD_TYPES[self.kind](**self._opts)

    def labels(self, **labelvalues) -> _Child:
        if set(labelvalues) != set(self.label_names):
            raise ValueError(
                f"metric '{self.name}' takes labels {self.label_names}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def series(self):
        """[(label_dict, child)] snapshot, label-sorted for stable output."""
        items = sorted(self._children.items())
        return [(dict(zip(self.label_names, key)), ch) for key, ch in items]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0):
        self._default.inc(amount)

    @property
    def value(self):
        return self._default.value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float):
        self._default.set(value)

    def inc(self, amount: float = 1.0):
        self._default.inc(amount)

    def dec(self, amount: float = 1.0):
        self._default.dec(amount)

    @property
    def value(self):
        return self._default.value


class Histogram(_Metric):
    kind = "histogram"

    def observe(self, value: float, exemplar: dict | None = None):
        self._default.observe(value, exemplar=exemplar)

    @property
    def sum(self):
        return self._default.sum

    @property
    def count(self):
        return self._default.count

    @property
    def mean(self):
        return self._default.mean


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name -> metric family. ``counter``/``gauge``/``histogram`` are
    get-or-create: the same (name) always returns the same family, and a
    kind or label-set mismatch on re-registration is a bug, not a merge."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = locksan.Lock("metrics.registry")

    def _get_or_create(self, kind, name, help, label_names, **opts):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        f"metric '{name}' already registered as {m.kind}, "
                        f"requested {kind}")
                if tuple(label_names) != m.label_names:
                    raise ValueError(
                        f"metric '{name}' already registered with labels "
                        f"{m.label_names}, requested {tuple(label_names)}")
                return m
            m = _METRIC_TYPES[kind](name, help, label_names, **opts)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get_or_create("gauge", name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create("histogram", name, help, labels,
                                   buckets=buckets)

    def get(self, name) -> _Metric | None:
        return self._metrics.get(name)

    def metrics(self) -> list[_Metric]:
        return [self._metrics[n] for n in sorted(self._metrics)]

    def reset(self):
        """Drop every registered family (tests; live child handles held by
        instrumented code keep working but detach from exposition)."""
        with self._lock:
            self._metrics.clear()

    # -- export ----------------------------------------------------------
    def prometheus_text(self) -> str:
        """The Prometheus text exposition format, one block per family."""
        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for labeldict, ch in m.series():
                base = ",".join(f'{k}="{_escape_label(v)}"'
                                for k, v in labeldict.items())
                if m.kind == "histogram":
                    cum = ch.cumulative()
                    exs = dict(ch.exemplars)
                    for i, (edge, c) in enumerate(zip(ch.buckets, cum)):
                        ls = (base + "," if base else "") + f'le="{_fmt(edge)}"'
                        lines.append(f"{m.name}_bucket{{{ls}}} {c}"
                                     + _fmt_exemplar(exs.get(i)))
                    ls = (base + "," if base else "") + 'le="+Inf"'
                    lines.append(f"{m.name}_bucket{{{ls}}} {cum[-1]}"
                                 + _fmt_exemplar(exs.get(len(ch.buckets))))
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{m.name}_sum{suffix} {_fmt(ch.sum)}")
                    lines.append(f"{m.name}_count{suffix} {ch.count}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{m.name}{suffix} {_fmt(ch.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-able registry dump: {name: {type, help, labels, series}},
        plus a ``__meta__`` entry stamping the capture time so two
        snapshots diff into rates.
        Consumers iterating families must skip keys starting with ``__``."""
        out = {"__meta__": {"wall_time": time.time(), "pid": os.getpid()}}
        for m in self.metrics():
            series = []
            for labeldict, ch in m.series():
                if m.kind == "histogram":
                    s = {
                        "labels": labeldict,
                        "buckets": {_fmt(e): c for e, c in
                                    zip(ch.buckets, ch.cumulative())},
                        "sum": ch.sum, "count": ch.count,
                        "mean": ch.mean,
                    }
                    if ch.exemplars:
                        edges = list(ch.buckets) + [float("inf")]
                        s["exemplars"] = {
                            _fmt(edges[i]): {"labels": labels,
                                             "value": value, "ts": ts}
                            for i, (labels, value, ts)
                            in sorted(ch.exemplars.items())}
                    series.append(s)
                else:
                    series.append({"labels": labeldict, "value": ch.value})
            out[m.name] = {"type": m.kind, "help": m.help,
                           "labels": list(m.label_names), "series": series}
        return out

    def snapshot_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, default=str)
        return path


_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every built-in layer registers into."""
    return _DEFAULT
