"""Trace-driven workload engine: seeded, replayable serving load
(counterpart of ``paddle_tpu/serving/workload.py``).

Every serving claim (spill ladder, tenancy fairness, deadlines) is only as
honest as the traffic it was proven under. This module generates
*realistic* load — bursty, diurnal, heavy-tailed — from a single
serialized spec + seed, so any run is replayable and a regression is a
diff against a known schedule.

Three layers:

- :class:`WorkloadSpec` — the declarative description: arrival process
  (Poisson / Markov-modulated bursty / diurnal envelope / uniform),
  prompt- and output-length distributions (fixed / uniform / lognormal /
  Zipf, truncated to engine limits), tenant weights, prefix-share
  groups, and the client shape (open vs closed loop). Round-trips
  through JSON (:meth:`WorkloadSpec.to_json` /
  :meth:`WorkloadSpec.from_json`).
- :func:`generate` — materializes the spec into a :class:`Workload`:
  a deterministic list of :class:`WorkloadRequest` (arrival offset,
  phase tag, tenant, prompt tokens, output budget) drawn from one
  ``numpy.random.RandomState(seed)`` in a fixed order — the reference's
  draws, so a spec gives the reference's schedule and
  :meth:`Workload.fingerprint` (sha256 over the canonical JSON form).
- :class:`OpenLoopRunner` / :class:`ClosedLoopRunner` — drive any
  ``submit`` adapter. The open-loop runner dispatches at the *scheduled*
  arrival times regardless of completions — the only client shape that
  exposes overload. The closed-loop runner models N users with think
  time, for latency-under-light-load measurements.

The ``submit`` adapter decouples this module from any serving surface:
``submit(wreq)`` returns a zero-arg ``finish()`` callable that blocks
until terminal and returns ``{"outcome": "ok"|"failed", "ttft":
float|None, "tokens": int, "error": str|None}``. If ``submit`` itself
raises, the runner records the request as shed (an admission-control
rejection, counted against goodput, never "lost").
"""
from __future__ import annotations

import hashlib
import json
import math
import threading
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np

from .. import telemetry
from ..analysis import locksan

__all__ = [
    "WorkloadError", "WorkloadSpec", "WorkloadRequest", "Workload",
    "generate", "OpenLoopRunner", "ClosedLoopRunner", "summarize",
    "PRESETS", "preset", "load_spec",
]

ARRIVAL_KINDS = ("poisson", "bursty", "diurnal", "uniform")
LENGTH_KINDS = ("fixed", "uniform", "lognormal", "zipf")
OUTCOMES = ("ok", "failed", "shed", "lost")


class WorkloadError(ValueError):
    """A spec that cannot be generated (unknown kind, bad parameter)."""


# ---------------------------------------------------------------------------
# metrics

_METRICS = None


def _workload_metrics() -> SimpleNamespace:
    reg = telemetry.registry()
    return SimpleNamespace(
        requests=reg.counter(
            "workload_requests_total",
            "workload-engine requests by terminal outcome "
            "(ok / failed / shed / lost)", ("outcome",)),
        sched_lag=reg.histogram(
            "workload_sched_lag_seconds",
            "open-loop dispatch lag: actual dispatch time minus the "
            "scheduled arrival time (a growing lag means the load "
            "generator itself fell behind)",
            buckets=(.001, .005, .01, .05, .1, .5, 1., 5.)),
        offered_qps=reg.gauge(
            "workload_offered_qps",
            "offered arrival rate of the workload being replayed"),
    )


def _metrics() -> SimpleNamespace:
    global _METRICS
    if _METRICS is None:
        _METRICS = _workload_metrics()
    return _METRICS


# ---------------------------------------------------------------------------
# spec

def _require(cond: bool, msg: str):
    if not cond:
        raise WorkloadError(msg)


@dataclass
class WorkloadSpec:
    """Declarative, JSON-serializable description of a workload.

    ``arrival`` (dict, keyed by ``kind``):

    - ``poisson``: ``rate_qps`` — homogeneous Poisson arrivals.
    - ``uniform``: ``rate_qps`` — fixed spacing (the hand-shaped load
      every pre-workload bench used; kept for baselines).
    - ``bursty``: 2-state Markov-modulated Poisson process —
      ``calm_qps`` / ``burst_qps`` with exponential sojourns of mean
      ``mean_calm_s`` / ``mean_burst_s``; each request is tagged with
      the phase (``calm``/``burst``) it arrived in.
    - ``diurnal``: non-homogeneous Poisson by thinning — rate(t) =
      ``mean_qps * (1 + depth*sin(2*pi*(t+phase_s)/period_s))``,
      ``0 <= depth <= 1``; requests tagged ``peak``/``trough``.

    ``prompt_len`` / ``output_len`` (dict, keyed by ``kind``):

    - ``fixed``: ``value``.
    - ``uniform``: ``min``..``max`` inclusive.
    - ``lognormal``: ``median``, ``sigma`` (log-space), clamped to
      ``min``..``max`` — the serving-paper heavy-tail default.
    - ``zipf``: ``alpha`` (> 1), offset to ``min``, clamped to ``max``
      — the heavier power-law tail.

    ``tenants``: list of ``{"name", "weight"}`` — each arrival draws a
    tenant proportional to weight. ``prefix``: ``{"share", "groups"}``
    — fraction of each prompt drawn from one of ``groups`` shared
    prefix pools (exercises the prefix cache / KV fabric the way real
    system-prompt traffic does). ``mode``: ``open`` or ``closed``
    (``closed`` adds ``{"concurrency", "think_time_s"}``).
    """

    name: str = "workload"
    seed: int = 0
    requests: int = 64
    arrival: dict = field(
        default_factory=lambda: {"kind": "poisson", "rate_qps": 8.0})
    prompt_len: dict = field(default_factory=lambda: {
        "kind": "lognormal", "median": 24, "sigma": 0.5,
        "min": 4, "max": 96})
    output_len: dict = field(default_factory=lambda: {
        "kind": "lognormal", "median": 12, "sigma": 0.4,
        "min": 2, "max": 48})
    tenants: list = field(
        default_factory=lambda: [{"name": "anonymous", "weight": 1.0}])
    prefix: dict = field(
        default_factory=lambda: {"share": 0.0, "groups": 1})
    vocab: int = 128
    mode: str = "open"
    closed: dict = field(
        default_factory=lambda: {"concurrency": 4, "think_time_s": 0.0})
    slo: dict | None = None      # {"ttft_s": ..., "tpot_s": ...}

    # -- validation -------------------------------------------------------
    def validate(self) -> "WorkloadSpec":
        _require(int(self.requests) > 0, "requests must be > 0")
        _require(int(self.vocab) > 1, "vocab must be > 1")
        _require(self.mode in ("open", "closed"),
                 f"mode must be open|closed, got {self.mode!r}")
        kind = self.arrival.get("kind")
        _require(kind in ARRIVAL_KINDS,
                 f"arrival.kind must be one of {ARRIVAL_KINDS}, "
                 f"got {kind!r}")
        if kind in ("poisson", "uniform"):
            _require(float(self.arrival.get("rate_qps", 0)) > 0,
                     f"{kind} arrival needs rate_qps > 0")
        elif kind == "bursty":
            for k in ("calm_qps", "burst_qps", "mean_calm_s",
                      "mean_burst_s"):
                _require(float(self.arrival.get(k, 0)) > 0,
                         f"bursty arrival needs {k} > 0")
        elif kind == "diurnal":
            _require(float(self.arrival.get("mean_qps", 0)) > 0,
                     "diurnal arrival needs mean_qps > 0")
            _require(0.0 <= float(self.arrival.get("depth", 0.5)) <= 1.0,
                     "diurnal depth must be in [0, 1]")
            _require(float(self.arrival.get("period_s", 0)) > 0,
                     "diurnal arrival needs period_s > 0")
        for label, dist in (("prompt_len", self.prompt_len),
                            ("output_len", self.output_len)):
            dk = dist.get("kind")
            _require(dk in LENGTH_KINDS,
                     f"{label}.kind must be one of {LENGTH_KINDS}, "
                     f"got {dk!r}")
            if dk == "zipf":
                _require(float(dist.get("alpha", 0)) > 1.0,
                         f"{label}: zipf alpha must be > 1")
        _require(bool(self.tenants), "tenants must be non-empty")
        _require(all(float(t.get("weight", 0)) > 0 for t in self.tenants),
                 "every tenant weight must be > 0")
        share = float(self.prefix.get("share", 0.0))
        _require(0.0 <= share <= 1.0, "prefix.share must be in [0, 1]")
        _require(int(self.prefix.get("groups", 1)) >= 1,
                 "prefix.groups must be >= 1")
        return self

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name, "seed": int(self.seed),
            "requests": int(self.requests),
            "arrival": dict(self.arrival),
            "prompt_len": dict(self.prompt_len),
            "output_len": dict(self.output_len),
            "tenants": [dict(t) for t in self.tenants],
            "prefix": dict(self.prefix), "vocab": int(self.vocab),
            "mode": self.mode, "closed": dict(self.closed),
            "slo": dict(self.slo) if self.slo else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        known = {f_ for f_ in cls.__dataclass_fields__}
        extra = set(d) - known
        _require(not extra, f"unknown WorkloadSpec fields: {sorted(extra)}")
        return cls(**d).validate()

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kw)

    @classmethod
    def from_json(cls, s: str) -> "WorkloadSpec":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# materialization

@dataclass(frozen=True)
class WorkloadRequest:
    """One materialized arrival of the schedule."""

    index: int
    at_s: float          # arrival offset from workload start
    phase: str           # steady | calm | burst | peak | trough
    tenant: str
    prompt: tuple        # token ids
    max_new_tokens: int
    group: int           # prefix-share group (-1 = no shared prefix)

    def to_dict(self) -> dict:
        return {"index": self.index, "at_s": round(self.at_s, 9),
                "phase": self.phase, "tenant": self.tenant,
                "prompt": list(self.prompt),
                "max_new_tokens": self.max_new_tokens,
                "group": self.group}


def _arrivals(spec: WorkloadSpec, rng) -> list:
    """(at_s, phase) pairs, one per request, in a fixed draw order."""
    a, n = spec.arrival, int(spec.requests)
    kind = a["kind"]
    out, t = [], 0.0
    if kind == "uniform":
        gap = 1.0 / float(a["rate_qps"])
        for i in range(n):
            out.append((i * gap, "steady"))
    elif kind == "poisson":
        rate = float(a["rate_qps"])
        for _ in range(n):
            t += float(rng.exponential(1.0 / rate))
            out.append((t, "steady"))
    elif kind == "bursty":
        rates = {"calm": float(a["calm_qps"]),
                 "burst": float(a["burst_qps"])}
        mean_sojourn = {"calm": float(a["mean_calm_s"]),
                        "burst": float(a["mean_burst_s"])}
        state = "calm"
        boundary = float(rng.exponential(mean_sojourn[state]))
        while len(out) < n:
            dt = float(rng.exponential(1.0 / rates[state]))
            if t + dt >= boundary:
                # phase flips before the next arrival: jump to the
                # boundary and redraw — the exponential is memoryless,
                # so discarding the partial gap keeps the process exact
                t = boundary
                state = "burst" if state == "calm" else "calm"
                boundary = t + float(rng.exponential(mean_sojourn[state]))
                continue
            t += dt
            out.append((t, state))
    elif kind == "diurnal":
        mean = float(a["mean_qps"])
        depth = float(a.get("depth", 0.5))
        period = float(a["period_s"])
        phase_s = float(a.get("phase_s", 0.0))
        rate_max = mean * (1.0 + depth)

        def rate(at):
            return mean * (1.0 + depth * math.sin(
                2.0 * math.pi * (at + phase_s) / period))

        while len(out) < n:     # Lewis–Shedler thinning
            t += float(rng.exponential(1.0 / rate_max))
            r = rate(t)
            if float(rng.uniform()) * rate_max <= r:
                out.append((t, "peak" if r >= mean else "trough"))
    else:   # pragma: no cover - validate() rejects earlier
        raise WorkloadError(f"unknown arrival kind {kind!r}")
    return out


def _draw_len(dist: dict, rng) -> int:
    kind = dist["kind"]
    lo = int(dist.get("min", 1))
    hi = int(dist.get("max", max(lo, 1 << 16)))
    if kind == "fixed":
        v = int(dist["value"])
    elif kind == "uniform":
        v = int(rng.randint(lo, hi + 1))
    elif kind == "lognormal":
        med = float(dist["median"])
        sigma = float(dist.get("sigma", 0.5))
        v = int(round(math.exp(float(
            rng.normal(math.log(med), sigma)))))
    elif kind == "zipf":
        v = lo + int(rng.zipf(float(dist["alpha"]))) - 1
    else:   # pragma: no cover - validate() rejects earlier
        raise WorkloadError(f"unknown length kind {kind!r}")
    return max(lo, min(hi, max(1, v)))


class Workload:
    """A materialized schedule: the spec plus its request list."""

    def __init__(self, spec: WorkloadSpec, requests: list):
        self.spec = spec
        self.requests = requests

    def __len__(self):
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].at_s if self.requests else 0.0

    @property
    def offered_qps(self) -> float:
        d = self.duration_s
        return len(self.requests) / d if d > 0 else float(len(self.requests))

    def to_jsonable(self) -> dict:
        return {"spec": self.spec.to_dict(),
                "requests": [r.to_dict() for r in self.requests]}

    def fingerprint(self) -> str:
        """sha256 over the canonical JSON schedule — two generations are
        byte-identical iff their fingerprints match."""
        blob = json.dumps(self.to_jsonable(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()


def generate(spec: WorkloadSpec, *,
             max_model_len: int | None = None) -> Workload:
    """Materialize ``spec`` into a deterministic :class:`Workload`.

    One ``RandomState(spec.seed)`` drives every draw in a fixed order
    (arrivals first, then per-request tenant/group/lengths/tokens), so
    the schedule is a pure function of the spec. ``max_model_len``
    truncates each request to the engine's context limit:
    ``len(prompt) + max_new_tokens <= max_model_len``, clamping the
    prompt first and then the output budget (both stay >= 1).
    """
    spec.validate()
    rng = np.random.RandomState(int(spec.seed))
    arrivals = _arrivals(spec, rng)

    names = [str(t["name"]) for t in spec.tenants]
    weights = np.asarray([float(t["weight"]) for t in spec.tenants])
    weights = weights / weights.sum()

    share = float(spec.prefix.get("share", 0.0))
    groups = int(spec.prefix.get("groups", 1))
    # group prefix pools drawn up-front (deterministic regardless of
    # which groups later requests land in)
    max_prompt = int(spec.prompt_len.get("max", 4096))
    if max_model_len is not None:
        max_prompt = min(max_prompt, int(max_model_len) - 1)
    pool = (rng.randint(1, int(spec.vocab),
                        size=(groups, max_prompt)).astype(int)
            if share > 0.0 else None)

    reqs = []
    for i, (at, phase) in enumerate(arrivals):
        tenant = names[int(rng.choice(len(names), p=weights))]
        plen = _draw_len(spec.prompt_len, rng)
        out = _draw_len(spec.output_len, rng)
        if max_model_len is not None:
            plen = max(1, min(plen, int(max_model_len) - 1))
            out = max(1, min(out, int(max_model_len) - plen))
        group = -1
        pre = 0
        if pool is not None and share > 0.0:
            group = int(rng.randint(0, groups))
            pre = min(int(round(share * plen)), plen, pool.shape[1])
        tail = rng.randint(1, int(spec.vocab), size=plen - pre).astype(int)
        prompt = (tuple(int(v) for v in pool[group, :pre]) +
                  tuple(int(v) for v in tail)
                  if pre else tuple(int(v) for v in tail))
        reqs.append(WorkloadRequest(
            index=i, at_s=float(at), phase=phase, tenant=tenant,
            prompt=prompt, max_new_tokens=int(out),
            group=group if pre else -1))
    return Workload(spec, reqs)


# ---------------------------------------------------------------------------
# presets

def _presets() -> dict:
    slo = {"ttft_s": 2.0, "tpot_s": 0.5}
    return {
        # steady Poisson at a comfortable rate: the baseline shape
        "steady": WorkloadSpec(
            name="steady", requests=48,
            arrival={"kind": "poisson", "rate_qps": 8.0}, slo=slo),
        # MMPP calm/burst alternation: p99-under-burst territory
        "burst": WorkloadSpec(
            name="burst", requests=64,
            arrival={"kind": "bursty", "calm_qps": 4.0, "burst_qps": 40.0,
                     "mean_calm_s": 2.0, "mean_burst_s": 1.0},
            slo=slo),
        # sustained over-capacity offered load: goodput-under-overload
        "overload": WorkloadSpec(
            name="overload", requests=96,
            arrival={"kind": "poisson", "rate_qps": 60.0},
            prompt_len={"kind": "zipf", "alpha": 1.4, "min": 8,
                        "max": 160},
            slo=slo),
        # slow sinusoidal envelope: diurnal rise/fall
        "diurnal": WorkloadSpec(
            name="diurnal", requests=64,
            arrival={"kind": "diurnal", "mean_qps": 10.0, "depth": 0.8,
                     "period_s": 8.0},
            slo=slo),
        # multi-tenant mix with shared prefixes: fairness + prefix cache
        "tenant-mix": WorkloadSpec(
            name="tenant-mix", requests=64,
            arrival={"kind": "poisson", "rate_qps": 10.0},
            tenants=[{"name": "gold", "weight": 3.0},
                     {"name": "silver", "weight": 2.0},
                     {"name": "bronze", "weight": 1.0}],
            prefix={"share": 0.5, "groups": 3}, slo=slo),
    }


PRESETS = tuple(sorted(_presets()))


def preset(name: str) -> WorkloadSpec:
    """A fresh copy of a named preset spec (mutate freely)."""
    table = _presets()
    if name not in table:
        raise WorkloadError(
            f"unknown workload preset {name!r}; one of {list(PRESETS)}")
    return table[name]


def load_spec(path_or_name: str) -> WorkloadSpec:
    """Resolve a CLI argument: a preset name or a JSON spec file path."""
    if path_or_name in PRESETS:
        return preset(path_or_name)
    try:
        with open(path_or_name, "r", encoding="utf-8") as f:
            return WorkloadSpec.from_json(f.read())
    except FileNotFoundError:
        raise WorkloadError(
            f"{path_or_name!r} is neither a workload preset "
            f"({list(PRESETS)}) nor a readable spec file") from None


# ---------------------------------------------------------------------------
# runners

@dataclass
class RequestResult:
    """Terminal record for one driven request."""

    index: int
    tenant: str
    phase: str
    at_s: float              # scheduled arrival offset
    submitted_at_s: float    # actual dispatch offset (run clock)
    sched_lag_s: float       # submitted_at - scheduled (open loop drift)
    outcome: str             # ok | failed | shed | lost
    ttft_s: float | None = None
    latency_s: float | None = None
    tokens: int = 0
    error: str | None = None


def _finish_one(wreq, finish, t_submit, clock) -> RequestResult:
    res = finish()
    return RequestResult(
        index=wreq.index, tenant=wreq.tenant, phase=wreq.phase,
        at_s=wreq.at_s, submitted_at_s=t_submit,
        sched_lag_s=0.0,
        outcome=str(res.get("outcome", "failed")),
        ttft_s=res.get("ttft"),
        latency_s=clock() - t_submit,
        tokens=int(res.get("tokens", 0)),
        error=res.get("error"))


class OpenLoopRunner:
    """Dispatch at the schedule's arrival times, never waiting on
    completions — offered load is fixed, so overload shows up as queue
    growth / shedding instead of silently slowing the generator.

    ``time_scale`` compresses the schedule (0.5 ⇒ twice as fast);
    ``max_wait_s`` bounds the post-dispatch drain. Each dispatch runs on
    its own thread because ``submit`` may block in admission control —
    the *arrival* must stay on time even when the fleet pushes back.
    """

    def __init__(self, workload: Workload, submit, *,
                 time_scale: float = 1.0, max_wait_s: float = 120.0):
        self.workload = workload
        self.submit = submit
        self.time_scale = float(time_scale)
        self.max_wait_s = float(max_wait_s)

    def run(self) -> list:
        m = _metrics()
        if telemetry.enabled():
            m.offered_qps.set(
                self.workload.offered_qps / max(self.time_scale, 1e-9))
        results: list = [None] * len(self.workload)
        lock = locksan.Lock("workload.results")
        threads = []
        t0 = time.monotonic()

        def drive(wreq):
            now = time.monotonic() - t0
            lag = max(0.0, now - wreq.at_s * self.time_scale)
            if telemetry.enabled():
                m.sched_lag.observe(lag)
            try:
                finish = self.submit(wreq)
            except Exception as e:  # lint: allow-silent(recorded as outcome=shed with the error string; summarize() surfaces it)
                rr = RequestResult(
                    index=wreq.index, tenant=wreq.tenant,
                    phase=wreq.phase, at_s=wreq.at_s,
                    submitted_at_s=now, sched_lag_s=lag,
                    outcome="shed", error=f"{type(e).__name__}: {e}")
            else:
                rr = _finish_one(wreq, finish, now,
                                 lambda: time.monotonic() - t0)
                rr.sched_lag_s = lag
            if telemetry.enabled():
                m.requests.labels(outcome=rr.outcome).inc()
            with lock:
                results[wreq.index] = rr

        for wreq in self.workload:
            target = t0 + wreq.at_s * self.time_scale
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(
                target=drive, args=(wreq,),
                name=f"workload-open-{wreq.index}", daemon=True)
            th.start()
            threads.append(th)
        deadline = time.monotonic() + self.max_wait_s
        for th in threads:
            th.join(max(0.0, deadline - time.monotonic()))
        with lock:
            out = list(results)
        for i, rr in enumerate(out):
            if rr is None:      # dispatch thread still stuck: lost
                wreq = self.workload.requests[i]
                out[i] = RequestResult(
                    index=i, tenant=wreq.tenant, phase=wreq.phase,
                    at_s=wreq.at_s, submitted_at_s=float("nan"),
                    sched_lag_s=0.0, outcome="lost",
                    error="no terminal state before max_wait_s")
                if telemetry.enabled():
                    m.requests.labels(outcome="lost").inc()
        return out


class ClosedLoopRunner:
    """N concurrent users, each submit→wait→think→repeat. Completion-
    paced: the schedule's arrival times are ignored (that is the point —
    closed loops measure latency at bounded concurrency, not overload).
    """

    def __init__(self, workload: Workload, submit, *,
                 concurrency: int | None = None,
                 think_time_s: float | None = None,
                 max_wait_s: float = 120.0):
        self.workload = workload
        self.submit = submit
        closed = workload.spec.closed or {}
        self.concurrency = int(concurrency
                               if concurrency is not None
                               else closed.get("concurrency", 4))
        self.think_time_s = float(think_time_s
                                  if think_time_s is not None
                                  else closed.get("think_time_s", 0.0))
        self.max_wait_s = float(max_wait_s)

    def run(self) -> list:
        m = _metrics()
        results: list = [None] * len(self.workload)
        lock = locksan.Lock("workload.closed.results")
        it = iter(self.workload.requests)
        t0 = time.monotonic()
        deadline = t0 + self.max_wait_s

        def worker():
            while time.monotonic() < deadline:
                with lock:
                    wreq = next(it, None)
                if wreq is None:
                    return
                now = time.monotonic() - t0
                try:
                    finish = self.submit(wreq)
                except Exception as e:  # lint: allow-silent(recorded as outcome=shed with the error string; summarize() surfaces it)
                    rr = RequestResult(
                        index=wreq.index, tenant=wreq.tenant,
                        phase=wreq.phase, at_s=wreq.at_s,
                        submitted_at_s=now, sched_lag_s=0.0,
                        outcome="shed",
                        error=f"{type(e).__name__}: {e}")
                else:
                    rr = _finish_one(wreq, finish, now,
                                     lambda: time.monotonic() - t0)
                if telemetry.enabled():
                    m.requests.labels(outcome=rr.outcome).inc()
                with lock:
                    results[wreq.index] = rr
                if self.think_time_s > 0:
                    time.sleep(self.think_time_s)

        threads = [threading.Thread(target=worker,
                                    name=f"workload-closed-{i}",
                                    daemon=True)
                   for i in range(self.concurrency)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(max(0.0, deadline - time.monotonic()))
        with lock:
            return [rr for rr in results if rr is not None]


# ---------------------------------------------------------------------------
# digestion

def _pct(vals: list, q: float) -> float | None:
    if not vals:
        return None
    vs = sorted(vals)
    idx = max(0, min(len(vs) - 1, int(round(q * (len(vs) - 1)))))
    return vs[idx]


def summarize(results: list, *, slo: dict | None = None) -> dict:
    """Digest runner results into the distribution-level numbers the
    perf gate consumes. ``slo`` (``{"ttft_s", "tpot_s"}``) scopes
    goodput: a request is *good* iff it finished ok within its SLO;
    shed/failed/lost all count against goodput (offered-load
    denominator — the open-loop framing)."""
    by_outcome: dict = {}
    for rr in results:
        by_outcome[rr.outcome] = by_outcome.get(rr.outcome, 0) + 1
    ok = [rr for rr in results if rr.outcome == "ok"]
    ttfts = [rr.ttft_s for rr in ok if rr.ttft_s is not None]
    ttft_slo = (slo or {}).get("ttft_s")
    tpot_slo = (slo or {}).get("tpot_s")

    def within(rr) -> bool:
        if rr.outcome != "ok":
            return False
        if ttft_slo is not None and (rr.ttft_s is None
                                     or rr.ttft_s > ttft_slo):
            return False
        if tpot_slo is not None and rr.tokens > 1 and rr.ttft_s is not None \
                and rr.latency_s is not None:
            tpot = (rr.latency_s - rr.ttft_s) / (rr.tokens - 1)
            if tpot > tpot_slo:
                return False
        return True

    good = sum(1 for rr in results if within(rr))
    offered = len(results)
    phases = sorted({rr.phase for rr in results})
    per_phase = {}
    for ph in phases:
        sub = [rr for rr in results if rr.phase == ph]
        sub_ttft = [rr.ttft_s for rr in sub
                    if rr.outcome == "ok" and rr.ttft_s is not None]
        per_phase[ph] = {
            "requests": len(sub),
            "ok": sum(1 for rr in sub if rr.outcome == "ok"),
            "ttft_p50": _pct(sub_ttft, 0.50),
            "ttft_p99": _pct(sub_ttft, 0.99),
        }
    tokens = sum(rr.tokens for rr in ok)
    lat = [rr.latency_s for rr in ok if rr.latency_s is not None]
    return {
        "offered": offered,
        "outcomes": by_outcome,
        "lost": by_outcome.get("lost", 0),
        "goodput_requests": good,
        "goodput_ratio": good / offered if offered else None,
        "tokens_ok": tokens,
        "ttft_p50": _pct(ttfts, 0.50),
        "ttft_p95": _pct(ttfts, 0.95),
        "ttft_p99": _pct(ttfts, 0.99),
        "latency_p99": _pct(lat, 0.99),
        "sched_lag_p99": _pct([rr.sched_lag_s for rr in results
                               if rr.outcome != "lost"], 0.99),
        "per_phase": per_phase,
    }
