"""Serving SLO tracker: rolling-window latency percentiles + goodput.

The engine's Prometheus histograms (`serving_ttft_seconds`, ...) are
cumulative-forever — right for a scraper computing windowed rates, wrong
for an in-process router/load-shedder that needs "p99 TTFT over the last
minute, now". :class:`SLOTracker` keeps the raw per-request observations
the engine already produces (the same values it feeds the histograms) in
a time-bounded window and derives:

- **percentiles** — p50/p95/p99 of TTFT, TPOT, and queue time over the
  window (nearest-rank on the sorted samples);
- **goodput** — the fraction of generated tokens attributable to requests
  that met their SLO (``ttft <= ttft_slo_s`` and ``tpot <= tpot_slo_s``;
  failed/cancelled requests always count against it), per the goodput
  framing of serving papers: tokens you'd have to re-serve don't count;
- **a shed/admit health signal** — ``healthy`` is False once the window
  p99s exceed the SLO (with at least ``min_samples`` requests observed),
  which is exactly what a fleet gateway polls before routing more load at
  a replica. Surfaced on ``LLMEngine.stats()["slo"]``.

Every :meth:`summary` also publishes ``slo_*`` gauges into the global
registry (labeled per engine), so the same numbers ride the per-rank
snapshots into the cluster aggregation plane (`telemetry.cluster`).

With no SLOs configured the tracker still reports percentiles and treats
every finished request as within SLO — goodput then measures only
failure/cancellation waste. Writes respect ``telemetry.disable()``.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from .metrics import ENABLED, registry
from ..analysis import locksan

__all__ = ["SLOTracker"]


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    """Nearest-rank percentile on an already-sorted sample list."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _pct_exemplar(sorted_pairs: list[tuple], q: float) -> str | None:
    """The trace id of the nearest-rank sample at quantile ``q`` (the
    request that *is* the window p99, not a neighbor)."""
    if not sorted_pairs:
        return None
    idx = max(0, min(len(sorted_pairs) - 1,
                     int(round(q * (len(sorted_pairs) - 1)))))
    return sorted_pairs[idx][1]


def _slo_metrics(engine_label: str):
    reg = registry()
    ls = ("engine",)

    def G(name, help):
        return reg.gauge(name, help, ls).labels(engine=engine_label)

    return {
        "ttft_p99": G("slo_ttft_p99_seconds",
                      "rolling-window p99 time-to-first-token"),
        "tpot_p99": G("slo_tpot_p99_seconds",
                      "rolling-window p99 per-output-token time"),
        "queue_p99": G("slo_queue_time_p99_seconds",
                       "rolling-window p99 queue time"),
        "goodput": G("slo_goodput_ratio",
                     "tokens within SLO / tokens generated (window)"),
        "req_goodput": G("slo_request_goodput_ratio",
                         "requests within SLO / requests finished (window)"),
        "healthy": G("slo_healthy",
                     "1 = window p99s within SLO (admit), 0 = shed"),
        "window_requests": G("slo_window_requests",
                             "requests in the rolling SLO window"),
    }


class SLOTracker:
    """Rolling window of per-request serving observations.

    ttft_slo_s / tpot_slo_s: the SLO (None = not enforced; the signal
    stays healthy and goodput only penalizes failures).
    window_s:    observation retention horizon.
    max_samples: hard bound on the window (oldest evicted) so a burst
                 cannot grow memory without bound.
    min_samples: don't declare a replica unhealthy off fewer requests.
    """

    def __init__(self, *, ttft_slo_s: float | None = None,
                 tpot_slo_s: float | None = None, window_s: float = 120.0,
                 max_samples: int = 8192, min_samples: int = 5,
                 engine_label: str = "0", clock=time.monotonic):
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        self.window_s = float(window_s)
        self.min_samples = int(min_samples)
        self._clock = clock
        # (t, ttft, tpot, queue_time, tokens, ok, trace_id) — ok=None marks
        # a failed/cancelled request (no latency sample, counts as
        # violation); trace_id is the request-trace exemplar the summary's
        # p99s link back to (telemetry.reqtrace)
        self._win: deque[tuple] = deque(maxlen=int(max_samples))
        self._lock = locksan.Lock("slo.tracker")
        # external pressure overlay (e.g. the scheduler's KV-pool
        # watermark latch): while set, the shed verdict is forced
        # regardless of latency percentiles or min_samples — a pool out
        # of blocks sheds even if the window looks healthy
        self._pressure = False
        self._pressure_reason: str | None = None
        self._m = _slo_metrics(engine_label)
        if ENABLED[0]:
            # vacuous-truth defaults: an idle engine admits (healthy=1),
            # it is not "shedding with goodput 0"
            self._m["healthy"].set(1.0)
            self._m["goodput"].set(1.0)
            self._m["req_goodput"].set(1.0)

    # -- recording -------------------------------------------------------
    def record_finished(self, *, ttft: float | None, tpot: float | None,
                        queue_time: float | None, tokens: int,
                        trace_id: str | None = None):
        if not ENABLED[0]:
            return
        ok = True
        if self.ttft_slo_s is not None and ttft is not None:
            ok = ok and ttft <= self.ttft_slo_s
        if self.tpot_slo_s is not None and tpot is not None:
            ok = ok and tpot <= self.tpot_slo_s
        with self._lock:
            self._win.append((self._clock(), ttft, tpot, queue_time,
                              int(tokens), ok, trace_id))

    def set_pressure(self, active: bool, reason: str | None = None):
        """Arm/clear the external pressure overlay. The caller that owns
        a non-latency shed signal (KV-pool watermarks, an operator
        switch) reports it here and the ``shed``/``healthy`` verdict the
        router polls reflects it immediately."""
        self._pressure = bool(active)
        self._pressure_reason = reason if active else None

    def record_failed(self, tokens: int = 0, trace_id: str | None = None):
        """A failed or cancelled request: its tokens (already streamed to
        a client that won't use them) count against goodput."""
        if not ENABLED[0]:
            return
        with self._lock:
            self._win.append((self._clock(), None, None, None,
                              int(tokens), None, trace_id))

    # -- reading ---------------------------------------------------------
    def _window(self):
        cutoff = self._clock() - self.window_s
        with self._lock:
            while self._win and self._win[0][0] < cutoff:
                self._win.popleft()
            return list(self._win)

    def summary(self) -> dict:
        """The window digested: percentiles, goodput, and the admit/shed
        verdict. Also refreshes the ``slo_*`` gauges."""
        win = self._window()
        # a window with zero observations carries no information: mark it
        # `empty` and report goodput as None rather than echoing a vacuous
        # 1.0 that reads like "the last populated window was healthy"
        empty = not win
        # key on the value alone: trace ids may be None and must not be
        # drawn into tie-break comparisons
        ttft_pairs = sorted(((v[1], v[6]) for v in win if v[1] is not None),
                            key=lambda p: p[0])
        tpot_pairs = sorted(((v[2], v[6]) for v in win if v[2] is not None),
                            key=lambda p: p[0])
        ttfts = [p[0] for p in ttft_pairs]
        tpots = [p[0] for p in tpot_pairs]
        queues = sorted(v[3] for v in win if v[3] is not None)
        total_tokens = sum(v[4] for v in win)
        good_tokens = sum(v[4] for v in win if v[5] is True)
        finished = [v for v in win if v[5] is not None]
        good_requests = sum(1 for v in finished if v[5])

        def pcts(vals):
            return {"p50": _percentile(vals, 0.50),
                    "p95": _percentile(vals, 0.95),
                    "p99": _percentile(vals, 0.99)}

        ttft_p, tpot_p, queue_p = pcts(ttfts), pcts(tpots), pcts(queues)
        healthy = True
        if len(win) >= self.min_samples:
            if (self.ttft_slo_s is not None and ttft_p["p99"] is not None
                    and ttft_p["p99"] > self.ttft_slo_s):
                healthy = False
            if (self.tpot_slo_s is not None and tpot_p["p99"] is not None
                    and tpot_p["p99"] > self.tpot_slo_s):
                healthy = False
        shed_reason = None if healthy else "latency"
        if self._pressure:       # authoritative: not gated on min_samples
            healthy = False
            shed_reason = self._pressure_reason or "pressure"
        out = {
            "window_s": self.window_s,
            "window_requests": len(win),
            "empty": empty,
            "ttft_slo_s": self.ttft_slo_s,
            "tpot_slo_s": self.tpot_slo_s,
            "ttft": ttft_p,
            "tpot": tpot_p,
            "queue_time": queue_p,
            "total_tokens": total_tokens,
            "goodput_tokens": good_tokens,
            "goodput_ratio": (None if empty else
                              (good_tokens / total_tokens
                               if total_tokens else 1.0)),
            "request_goodput_ratio": (None if empty
                                      else good_requests / len(win)),
            "healthy": healthy,
            "shed": not healthy,
            "shed_reason": shed_reason,
            # trace-id exemplars: the exact request behind each window p99
            # (GET /v1/traces/<id> on the gateway renders its timeline)
            "exemplars": {
                "ttft_p99": _pct_exemplar(ttft_pairs, 0.99),
                "tpot_p99": _pct_exemplar(tpot_pairs, 0.99),
            },
        }
        if ENABLED[0]:
            m = self._m
            m["ttft_p99"].set(ttft_p["p99"] or 0.0)
            m["tpot_p99"].set(tpot_p["p99"] or 0.0)
            m["queue_p99"].set(queue_p["p99"] or 0.0)
            # empty window: gauges fall back to the idle-engine defaults
            # (goodput 1.0 = nothing to re-serve) rather than None
            m["goodput"].set(1.0 if empty else out["goodput_ratio"])
            m["req_goodput"].set(
                1.0 if empty else out["request_goodput_ratio"])
            m["healthy"].set(1.0 if healthy else 0.0)
            m["window_requests"].set(len(win))
        return out

    def healthy(self) -> bool:
        """The boolean a router/load-shedder polls (admit=True)."""
        return self.summary()["healthy"]
