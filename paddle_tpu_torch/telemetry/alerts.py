"""SLO alerting: a declarative rule engine over the metrics history
(counterpart of ``paddle_tpu/telemetry/alerts.py``, kept as it is).

The :class:`~paddle_tpu_torch.telemetry.history.TimeSeriesStore` answers "what
was goodput doing"; this module answers "should someone be paged about
it". Three rule kinds, all evaluated against history windows (never raw
registry reads — a rule sees exactly what an operator would see on the
dashboard):

- :class:`ThresholdRule` — latest value vs a bound, one alert per
  matching label set (``router_breaker_state >= 2`` pages per replica).
- :class:`AbsenceRule` — a series stopped: missing entirely, rate pinned
  at zero (a counter that stopped advancing — the killed-publisher
  signature), or value flat after having varied. A series that has never
  shown signal cannot be "absent"; presence must be established first.
- :class:`BurnRateRule` — SRE-style multi-window multi-burn-rate SLO
  alerting: with an objective of ``0.99`` the error budget is 1%, the
  burn rate is (windowed error rate) / budget, and a (long, short,
  factor) window pair fires only when BOTH windows exceed the factor —
  the long window proves significance, the short window proves it is
  *still* happening (fast resolve). Defaults follow the SRE workbook:
  fast page at 14.4x over (1h, 5m), slow ticket at 6x over (6h, 30m).
  ``time_scale`` shrinks every window proportionally so chaos tests can
  prove the algebra in seconds instead of hours.

Alert lifecycle is ``pending -> firing -> resolved`` with for-duration
hysteresis on the way up (a condition must hold ``for_s`` before paging)
and ``resolve_s`` hysteresis on the way down (must stay clear before
resolving). Alerts are deduped by (rule, series-key): a firing alert
re-evaluating as active updates in place, it does not re-notify. Every
transition lands in the flight recorder (``alert.firing`` /
``alert.resolved``), moves the ``alerts_firing{rule,severity}`` gauge,
and calls the notifier hook; a firing alert carries an exemplar (e.g.
the trace id behind the window p99) when the rule has an
``exemplar_fn``.

Rules are also constructible from plain dicts (:func:`rule_from_dict` /
:func:`rules_from_json`) so a deployment can ship its rule pack as JSON;
:func:`default_rules` is the built-in pack covering SLO goodput burn,
breaker-open, journal growth, the leak sentinel, and publisher absence.
"""
from __future__ import annotations

import json
import threading
import time

from . import flight_recorder
from .metrics import registry
from ..analysis import locksan

__all__ = [
    "Rule", "ThresholdRule", "AbsenceRule", "BurnRateRule",
    "Alert", "AlertEngine", "default_rules", "rule_from_dict",
    "rules_from_json",
]

SEVERITIES = ("page", "ticket", "info")

_OPS = {
    ">": lambda v, t: v > t, ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t, "<=": lambda v, t: v <= t,
    "==": lambda v, t: v == t, "!=": lambda v, t: v != t,
}

_M = [None]


def _m():
    if _M[0] is None:
        reg = registry()
        class NS:
            firing = reg.gauge(
                "alerts_firing", "alerts currently firing",
                labels=("rule", "severity"))
            evals = reg.counter(
                "alerts_evaluations_total", "rule-evaluation passes")
            transitions = reg.counter(
                "alerts_transitions_total", "alert state transitions",
                labels=("to",))
            notify_errors = reg.counter(
                "alerts_notifier_errors_total",
                "notifier callbacks that raised")
        _M[0] = NS
    return _M[0]


def _scalar(v, field=None):
    """Extract a scalar from a history point value: raw gauges/rates are
    floats; rollups and histogram summaries are dicts ({'mean': ...} /
    {'p99': ...})."""
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, dict):
        for f in ((field,) if field else ()) + ("mean", "last", "rate"):
            x = v.get(f)
            if isinstance(x, (int, float)):
                return float(x)
    return None


def _pick_res(store, window_s: float) -> str:
    """Coarsest-necessary resolution: raw if the raw ring covers the
    window, else 10s, else 1m (mirrors ``TimeSeriesStore.last_window``)."""
    if store.raw_points * store.interval_s >= window_s:
        return "raw"
    return "10s" if store.rollup_points * 10.0 >= window_s else "1m"


def _window_values(store, family, labels, window_s, field=None):
    """[(t, scalar)] across ALL matching series, time-sorted — burn-rate
    rules alert on the fleet aggregate, not per-engine."""
    q = store.query(family, labels=labels, window_s=window_s,
                    res=_pick_res(store, window_s))
    out = []
    for s in q["series"]:
        for p in s["points"]:
            v = _scalar(p["v"], field)
            if v is not None:
                out.append((p["t"], v))
    out.sort(key=lambda tv: tv[0])
    return out


class Rule:
    """Base rule: identity, severity, hysteresis windows, and the
    evaluate contract. ``evaluate_all(store, now) -> [(key, severity,
    active, value, info)]`` — one tuple per alert-able series key."""

    type = "rule"

    def __init__(self, name: str, *, severity: str = "ticket",
                 for_s: float = 0.0, resolve_s: float = 0.0,
                 description: str = "", exemplar_fn=None):
        if severity not in SEVERITIES:
            raise ValueError(f"severity {severity!r} not in {SEVERITIES}")
        self.name = str(name)
        self.severity = severity
        self.for_s = float(for_s)
        self.resolve_s = float(resolve_s)
        self.description = description
        self.exemplar_fn = exemplar_fn

    def evaluate_all(self, store, now: float):
        raise NotImplementedError

    def describe(self) -> dict:
        return {"name": self.name, "type": self.type,
                "severity": self.severity, "for_s": self.for_s,
                "resolve_s": self.resolve_s,
                "description": self.description}


class ThresholdRule(Rule):
    """Latest value ``op`` threshold, one alert per matching label set."""

    type = "threshold"

    def __init__(self, name, family, op, threshold, *, labels=None,
                 field=None, **kw):
        super().__init__(name, **kw)
        if op not in _OPS:
            raise ValueError(f"op {op!r} not in {sorted(_OPS)}")
        self.family = family
        self.op = op
        self.threshold = float(threshold)
        self.labels = dict(labels or {})
        self.field = field

    def evaluate_all(self, store, now):
        q = store.query(self.family, labels=self.labels, res="raw")
        out = []
        for s in q["series"]:
            if not s["points"]:
                continue
            v = _scalar(s["points"][-1]["v"], self.field)
            if v is None:
                continue
            key = ",".join(f"{k}={x}" for k, x in sorted(s["labels"].items()))
            active = _OPS[self.op](v, self.threshold)
            out.append((key, self.severity, active, v,
                        {"threshold": self.threshold, "op": self.op}))
        return out

    def describe(self):
        d = super().describe()
        d.update(family=self.family, op=self.op, threshold=self.threshold,
                 labels=self.labels, field=self.field)
        return d


class AbsenceRule(Rule):
    """A series that was alive went quiet. ``mode``:

    - ``"zero"`` (default): signal = a nonzero scalar; absent when the
      last signal is older than ``absent_for_s`` (a counter-rate pinned
      at 0 — the publisher-stopped signature).
    - ``"flat"``: signal = the value *changing*; for monotone gauges
      like a publish sequence number.
    - ``"missing"``: signal = any fresh point at all; absent when the
      series stops appearing in samples.

    A series that never showed signal is not absent — presence first.
    """

    type = "absence"

    def __init__(self, name, family, *, absent_for_s, labels=None,
                 field=None, mode="zero", **kw):
        kw.setdefault("severity", "page")
        super().__init__(name, **kw)
        if mode not in ("zero", "flat", "missing"):
            raise ValueError(f"mode {mode!r} not in zero/flat/missing")
        self.family = family
        self.absent_for_s = float(absent_for_s)
        self.labels = dict(labels or {})
        self.field = field
        self.mode = mode
        # key -> {"last_signal_t", "last_value", "last_point_t"}
        self._state: dict[str, dict] = {}

    def _signal(self, st: dict, t: float, v: float) -> bool:
        if self.mode == "zero":
            return v != 0.0
        if self.mode == "flat":
            prev = st.get("last_value")
            st["last_value"] = v
            return prev is not None and v != prev
        # missing: any point newer than the last one we saw
        prev_t = st.get("last_point_t")
        st["last_point_t"] = t
        return prev_t is None or t > prev_t

    def evaluate_all(self, store, now):
        q = store.query(self.family, labels=self.labels, res="raw")
        out = []
        for s in q["series"]:
            if not s["points"]:
                continue
            key = ",".join(f"{k}={x}" for k, x in sorted(s["labels"].items()))
            st = self._state.setdefault(key, {})
            # scan every point since the last evaluation, not just the
            # newest: a rate series sampled faster than the evaluator
            # runs alternates signal/zero, and latest-point-only
            # evaluation can phase-lock onto the zeros — reading signal
            # as absence (or absence as signal) indefinitely
            seen = st.get("scanned_t")
            value = None
            for p in s["points"]:
                if seen is not None and p["t"] <= seen:
                    continue
                v = _scalar(p["v"], self.field)
                if v is None:
                    continue
                value = v
                if self._signal(st, p["t"], v):
                    st["last_signal_t"] = p["t"]
            st["scanned_t"] = s["points"][-1]["t"]
            if value is None:
                value = _scalar(s["points"][-1]["v"], self.field)
                if value is None:
                    continue
            last = st.get("last_signal_t")
            quiet = (now - last) if last is not None else None
            active = last is not None and quiet >= self.absent_for_s
            out.append((key, self.severity, active,
                        quiet if quiet is not None else 0.0,
                        {"absent_for_s": self.absent_for_s,
                         "mode": self.mode, "last_value": value}))
        return out

    def describe(self):
        d = super().describe()
        d.update(family=self.family, absent_for_s=self.absent_for_s,
                 labels=self.labels, mode=self.mode, field=self.field)
        return d


# (long_s, short_s, burn factor, severity, window name) — SRE workbook
# defaults: 14.4x over (1h, 5m) pages (2% of a 30d budget in 1h), 6x over
# (6h, 30m) tickets.
DEFAULT_BURN_WINDOWS = (
    (3600.0, 300.0, 14.4, "page", "fast"),
    (21600.0, 1800.0, 6.0, "ticket", "slow"),
)


class BurnRateRule(Rule):
    """Multi-window multi-burn-rate SLO rule over a good-ratio (or
    error-ratio) series. One alert key per window pair; each fires only
    when both its long and short windows burn above the factor."""

    type = "burn_rate"

    def __init__(self, name, family, *, objective=0.99, labels=None,
                 field=None, signal="good_ratio",
                 windows=DEFAULT_BURN_WINDOWS, time_scale=1.0,
                 min_points=2, **kw):
        super().__init__(name, **kw)
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective {objective} must be in (0, 1)")
        if signal not in ("good_ratio", "error_ratio"):
            raise ValueError("signal must be good_ratio or error_ratio")
        self.family = family
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.labels = dict(labels or {})
        self.field = field
        self.signal = signal
        self.time_scale = float(time_scale)
        self.min_points = int(min_points)
        self.windows = []
        for w in windows:
            long_s, short_s, factor, severity = w[0], w[1], w[2], w[3]
            wname = w[4] if len(w) > 4 else f"{factor:g}x"
            self.windows.append((float(long_s) * self.time_scale,
                                 float(short_s) * self.time_scale,
                                 float(factor), severity, wname))

    def _err(self, v: float) -> float:
        e = (1.0 - v) if self.signal == "good_ratio" else v
        return min(max(e, 0.0), 1.0)

    def _burn(self, store, window_s: float):
        vals = _window_values(store, self.family, self.labels, window_s,
                              self.field)
        if len(vals) < self.min_points:
            return None, len(vals)
        errs = [self._err(v) for _, v in vals]
        return (sum(errs) / len(errs)) / self.budget, len(vals)

    def evaluate_all(self, store, now):
        out = []
        for long_s, short_s, factor, severity, wname in self.windows:
            burn_long, n_long = self._burn(store, long_s)
            burn_short, n_short = self._burn(store, short_s)
            active = (burn_long is not None and burn_short is not None
                      and burn_long >= factor and burn_short >= factor)
            value = None
            if burn_long is not None and burn_short is not None:
                value = min(burn_long, burn_short)
            out.append((wname, severity, active, value,
                        {"burn_long": burn_long, "burn_short": burn_short,
                         "factor": factor, "long_s": long_s,
                         "short_s": short_s, "objective": self.objective,
                         "points": [n_long, n_short]}))
        return out

    def describe(self):
        d = super().describe()
        d.update(family=self.family, objective=self.objective,
                 signal=self.signal, labels=self.labels, field=self.field,
                 windows=[list(w) for w in self.windows])
        return d


class Alert:
    """One alert episode for (rule, series key)."""

    __slots__ = ("rule", "key", "severity", "state", "value", "info",
                 "description", "exemplar", "pending_t", "pending_wall",
                 "firing_t", "firing_wall", "clear_t", "resolved_wall",
                 "last_active_t")

    def __init__(self, rule: str, key: str, severity: str,
                 description: str = ""):
        self.rule = rule
        self.key = key
        self.severity = severity
        self.description = description
        self.state = "pending"
        self.value = None
        self.info: dict = {}
        self.exemplar = None
        self.pending_t = self.pending_wall = None
        self.firing_t = self.firing_wall = None
        self.clear_t = None
        self.resolved_wall = None
        self.last_active_t = None

    def doc(self) -> dict:
        return {
            "rule": self.rule, "key": self.key, "severity": self.severity,
            "state": self.state, "value": self.value, "info": self.info,
            "description": self.description, "exemplar": self.exemplar,
            "pending_wall": self.pending_wall,
            "firing_wall": self.firing_wall,
            "resolved_wall": self.resolved_wall,
        }


class AlertEngine:
    """Evaluates rules against a history store on its own thread
    (``telemetry-alerts``), owning the full alert lifecycle."""

    def __init__(self, history, rules=(), *, interval_s: float = 5.0,
                 clock=time.monotonic, wall_clock=time.time,
                 notifier=None, max_history: int = 128):
        self.history = history
        self.rules: list[Rule] = []
        self.interval_s = float(interval_s)
        self.clock = clock
        self.wall_clock = wall_clock
        self.notifier = notifier
        self._alerts: dict[tuple, Alert] = {}
        self._resolved: list[dict] = []
        self.max_history = int(max_history)
        self._gauge_keys: set[tuple] = set()
        self._lock = locksan.Lock("alerts.engine")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.evaluations = 0
        for r in rules:
            self.add_rule(r)

    def add_rule(self, rule: Rule):
        with self._lock:
            if any(r.name == rule.name for r in self.rules):
                raise ValueError(f"duplicate rule name {rule.name!r}")
            self.rules.append(rule)
        return self

    # -- lifecycle ---------------------------------------------------------
    def _notify(self, event: str, alert: Alert):
        flight_recorder.record_event(
            f"alert.{event}", rule=alert.rule, key=alert.key,
            severity=alert.severity, value=alert.value,
            exemplar=alert.exemplar)
        _m().transitions.labels(to=event).inc()
        if self.notifier is not None:
            try:
                self.notifier({"event": event, "alert": alert.doc()})
            except Exception as exc:  # a broken pager integration must not stop evaluation; counted
                _m().notify_errors.inc()
                flight_recorder.record_event(
                    "alert.notifier_error", rule=alert.rule, key=alert.key,
                    event=event, error=f"{type(exc).__name__}: {exc}")

    def _exemplar(self, rule: Rule):
        if rule.exemplar_fn is None:
            return None
        try:
            return rule.exemplar_fn()
        except Exception:  # exemplars are garnish; the page still goes out without one
            return None

    def evaluate_once(self) -> list[dict]:
        """One pass over every rule. Returns the transition events
        ([{event, alert}]) this pass produced."""
        now = self.clock()
        wall = self.wall_clock()
        events: list[tuple[str, Alert]] = []
        with self._lock:
            rules = list(self.rules)
        for rule in rules:
            try:
                results = rule.evaluate_all(self.history, now)
            except Exception:  # one bad rule must not stop the pager; next pass retries
                continue
            for key, severity, active, value, info in results:
                self._step(rule, key, severity, active, value, info,
                           now, wall, events)
        with self._lock:
            self.evaluations += 1
            self._sync_gauge()
        _m().evals.inc()
        for event, alert in events:
            self._notify(event, alert)
        return [{"event": e, "alert": a.doc()} for e, a in events]

    def _step(self, rule: Rule, key, severity, active, value, info,
              now, wall, events):
        akey = (rule.name, key)
        with self._lock:
            alert = self._alerts.get(akey)
            if active:
                if alert is None:
                    alert = Alert(rule.name, key, severity,
                                  rule.description)
                    alert.pending_t, alert.pending_wall = now, wall
                    self._alerts[akey] = alert
                    events.append(("pending", alert))
                alert.value, alert.info = value, dict(info)
                alert.last_active_t = now
                alert.clear_t = None
                if (alert.state == "pending"
                        and now - alert.pending_t >= rule.for_s):
                    alert.state = "firing"
                    alert.firing_t, alert.firing_wall = now, wall
                    alert.exemplar = self._exemplar(rule)
                    events.append(("firing", alert))
            elif alert is not None:
                if alert.state == "pending":
                    # never fired: cancel silently (dedupe — no page,
                    # no resolve noise)
                    del self._alerts[akey]
                elif alert.state == "firing":
                    if alert.clear_t is None:
                        alert.clear_t = now
                    if now - alert.clear_t >= rule.resolve_s:
                        alert.state = "resolved"
                        alert.resolved_wall = wall
                        del self._alerts[akey]
                        self._resolved.append(alert.doc())
                        del self._resolved[:-self.max_history]
                        events.append(("resolved", alert))

    def _sync_gauge(self):
        """alerts_firing{rule,severity}: recomputed each pass; label pairs
        that stopped firing are pinned back to 0 (callers hold the lock)."""
        g = _m().firing
        counts: dict[tuple, int] = {}
        for a in self._alerts.values():
            if a.state == "firing":
                counts[(a.rule, a.severity)] = (
                    counts.get((a.rule, a.severity), 0) + 1)
        self._gauge_keys |= set(counts)
        for rule, severity in self._gauge_keys:
            g.labels(rule=rule, severity=severity).set(
                counts.get((rule, severity), 0))

    # -- the evaluator thread ----------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-alerts", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:  # the evaluator must outlive any one bad pass; next tick retries
                pass

    def stop(self):
        self._stop.set()
        th = self._thread
        if th is not None:
            th.join(timeout=5.0)
        self._thread = None

    # -- inspection --------------------------------------------------------
    def active(self) -> list[dict]:
        with self._lock:
            return [a.doc() for a in self._alerts.values()]

    def firing(self) -> list[dict]:
        return [a for a in self.active() if a["state"] == "firing"]

    def state(self) -> dict:
        """The ``/v1/alerts`` document."""
        with self._lock:
            alerts = sorted((a.doc() for a in self._alerts.values()),
                            key=lambda d: (d["rule"], d["key"]))
            return {
                "alerts": alerts,
                "firing": sum(1 for a in alerts if a["state"] == "firing"),
                "pending": sum(1 for a in alerts
                               if a["state"] == "pending"),
                "resolved": list(self._resolved),
                "rules": [r.describe() for r in self.rules],
                "evaluations": self.evaluations,
                "interval_s": self.interval_s,
                "running": bool(self._thread and self._thread.is_alive()),
            }


# -- declarative construction ---------------------------------------------

_RULE_TYPES = {"threshold": ThresholdRule, "absence": AbsenceRule,
               "burn_rate": BurnRateRule}


def rule_from_dict(spec: dict) -> Rule:
    """Build a rule from a plain dict: ``{"type": "threshold", "name":
    ..., "family": ..., "op": ">", "threshold": 2, "severity": "page",
    "for_s": 10}`` — the JSON rule grammar."""
    spec = dict(spec)
    rtype = spec.pop("type", None)
    cls = _RULE_TYPES.get(rtype)
    if cls is None:
        raise ValueError(f"unknown rule type {rtype!r}; "
                         f"one of {sorted(_RULE_TYPES)}")
    name = spec.pop("name")
    family = spec.pop("family")
    if cls is ThresholdRule:
        return cls(name, family, spec.pop("op"), spec.pop("threshold"),
                   **spec)
    if cls is AbsenceRule:
        return cls(name, family, **spec)
    if "windows" in spec:
        spec["windows"] = [tuple(w) for w in spec["windows"]]
    return cls(name, family, **spec)


def rules_from_json(src) -> list[Rule]:
    """A list of rule dicts — given directly, as a JSON string, or as a
    path to a JSON file."""
    if isinstance(src, str):
        s = src.strip()
        if s.startswith("["):
            src = json.loads(s)
        else:
            with open(src) as f:
                src = json.load(f)
    return [rule_from_dict(d) for d in src]


def default_rules(*, objective: float = 0.99, time_scale: float = 1.0,
                  journal_segments_max: float = 64.0,
                  publisher_absent_s: float = 15.0,
                  exemplar_fn=None) -> list[Rule]:
    """The built-in rule pack. ``time_scale`` shrinks burn windows,
    for-durations, and absence windows together so a chaos harness can
    exercise real page timing in seconds."""
    ts = float(time_scale)
    return [
        BurnRateRule(
            "slo-goodput-burn", "slo_goodput_ratio", objective=objective,
            time_scale=ts, for_s=0.0, resolve_s=30.0 * ts,
            exemplar_fn=exemplar_fn,
            description="SLO goodput burning error budget too fast"),
        ThresholdRule(
            "breaker-open", "router_breaker_state", ">=", 2.0,
            severity="ticket", for_s=5.0 * ts, resolve_s=10.0 * ts,
            description="replica circuit breaker open"),
        ThresholdRule(
            "journal-growth", "journal_segments", ">",
            journal_segments_max, severity="ticket", for_s=30.0 * ts,
            resolve_s=30.0 * ts,
            description="journal segment count growing without compaction"),
        ThresholdRule(
            "leak-sentinel", "memory_leak_flags_total", ">", 0.0,
            severity="ticket", for_s=0.0, resolve_s=60.0 * ts,
            description="leak sentinel flagged monotonic growth"),
        AbsenceRule(
            "publisher-absence", "cluster_publish_total",
            absent_for_s=publisher_absent_s * ts, mode="zero",
            severity="page", resolve_s=5.0 * ts,
            description="rank telemetry publisher stopped publishing"),
    ]
