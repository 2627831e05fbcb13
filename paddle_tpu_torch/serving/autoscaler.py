"""Closed-loop elastic autoscaling over a :class:`FleetRouter` replica
pool (counterpart of ``paddle_tpu/serving/autoscaler.py``).

The :class:`Autoscaler` periodically reads the router's
:meth:`~paddle_tpu_torch.serving.router.FleetRouter.load_signal` — healthy /
parked replica sets, dispatched + replica-queued work, and the same
Little's-law wait estimate the 429 Retry-After already carries — and
closes the loop:

- **Scale up** when the estimated wait crosses ``scale_up_wait_s``
  *and* work is actually queued (the estimate is derived from rolling
  SLO windows, so it lags a drained burst; queue depth is the
  forward-looking half of the signal), or work is queued with zero
  healthy replicas: revive one parked
  (STOPPED) replica through ``router.restart``. Every scale-up passes
  the ``autoscaler.scale`` fault site and is **gated by the
  supervisor's restart budget** (when one is given) —
  ``budget.next_backoff()`` is consumed per revival, and an exhausted budget refuses the scale-up
  (recorded, surfaced, never retried into a crash loop). The budget's
  *backoff pacing* is for crash loops and does not delay a
  demand-driven revival. A revived replica's first requests hit via
  KV-fabric migration — the router's directory placement needs nothing
  new here.
- **Track time-to-healthy**: a pending scale-up is watched until the
  replica reports HEALTHY (``autoscaler_scale_up_seconds`` + a
  ``scale_up_healthy`` ledger event) or dies mid-warm (the router's
  failover machinery owns the in-flight work; the autoscaler just
  re-decides from demand on its next tick).
- **Scale down with hysteresis**: only after the fleet has been idle —
  ``inflight/healthy <= scale_down_util`` and nothing queued — for a
  full ``down_hold_s``, and never below ``min_replicas``, drain the
  least-loaded replica (``router.drain`` fails over any stragglers, so
  an in-flight stream is never lost to a scale-down). ``cooldown_s``
  separates *any* two actions, so a burst arriving mid-drain cannot
  flap the fleet.

Every decision lands in the supervisor's ledger (when one is wired), so
``scale_up -> scale_up_healthy -> scale_down`` is an auditable record,
and in the ``autoscaler_*`` metric families. The supervisor is
duck-typed (``budget.next_backoff()``, ``ledger.record(...)``, the
reference's ``resilience.ElasticSupervisor`` surface): the port has no
``resilience`` package yet, so callers pass their own or None.

Driving is either explicit ``tick()`` calls (deterministic tests inject
a fake clock) or the named background thread ``start()`` spawns.
"""
from __future__ import annotations

import threading
import time

from .. import telemetry
from ..analysis import locksan
from ..utils import faults
from .router import ActuationBusy

__all__ = ["Autoscaler"]

_AM = None


def _autoscaler_metrics():
    global _AM
    if _AM is None:
        from types import SimpleNamespace
        reg = telemetry.registry()
        _AM = SimpleNamespace(
            decisions=reg.counter(
                "autoscaler_decisions_total",
                "autoscaler decisions by action (up / down / "
                "budget_exhausted / fault)", ("action",)),
            target=reg.gauge(
                "autoscaler_target_replicas",
                "replicas the autoscaler currently wants serving"),
            healthy=reg.gauge(
                "autoscaler_healthy_replicas",
                "healthy replicas at the last autoscaler tick"),
            est_wait=reg.gauge(
                "autoscaler_est_wait_seconds",
                "Little's-law wait estimate driving scale decisions"),
            up_s=reg.histogram(
                "autoscaler_scale_up_seconds",
                "scale-up decision to new replica HEALTHY"),
        )
    return _AM


class Autoscaler:
    """Demand-driven replica scaling for one :class:`FleetRouter`.

    The router is built with the *maximum* pool (replica handles are
    cheap when STOPPED); the autoscaler revives and parks them. See the
    module docstring for the policy; knobs:

    min_replicas / max_replicas: serving-replica floor/ceiling (None =
        the router's whole pool).
    scale_up_wait_s: estimated-wait threshold that triggers a revival.
    scale_down_util: per-replica inflight ratio at or below which the
        fleet counts as idle.
    down_hold_s:  how long the fleet must stay idle before a
        scale-down (the hysteresis hold).
    cooldown_s:   minimum spacing between any two scale actions.
    interval_s:   background-thread tick cadence (``start()``).
    supervisor:   a supervisor (duck-typed: ``budget.next_backoff()`` /
        ``budget.remaining`` and ``ledger.record(...)``) whose restart
        budget gates scale-ups and whose ledger records every decision.
        None = ungated.
    clock:        injectable monotonic clock for deterministic tests.
    """

    def __init__(self, router, *, supervisor=None, min_replicas: int = 1,
                 max_replicas: int | None = None,
                 scale_up_wait_s: float = 5.0,
                 scale_down_util: float = 0.25,
                 down_hold_s: float = 10.0, cooldown_s: float = 5.0,
                 interval_s: float = 0.5, lease_wait_s: float = 1.0,
                 clock=time.monotonic):
        self.router = router
        self.supervisor = supervisor
        self.min_replicas = int(min_replicas)
        self.max_replicas = (int(max_replicas) if max_replicas is not None
                             else len(router.replicas))
        self.scale_up_wait_s = float(scale_up_wait_s)
        self.scale_down_util = float(scale_down_util)
        self.down_hold_s = float(down_hold_s)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        # bounded actuation-lease wait: a rollout/remediation holding the
        # lease beats a scale decision, which simply re-derives next tick
        self.lease_wait_s = float(lease_wait_s)
        self._clock = clock
        self._lock = locksan.Lock("autoscaler.state")
        self._pending: dict[str, float] = {}   # rid -> scale-up decision t
        self._last_action: float | None = None
        self._idle_since: float | None = None
        self._decisions: dict[str, int] = {}
        self._scale_ups: list[dict] = []       # completed, for stats()
        self._m = _autoscaler_metrics()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Autoscaler":
        """Run ``tick()`` on a named daemon thread every ``interval_s``."""
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # lint: allow-silent(scaling is advisory; the serving path must outlive a sick tick)
                telemetry.record_event(
                    "autoscaler.tick_error",
                    error=f"{type(e).__name__}: {e}")

    # -- bookkeeping -------------------------------------------------------
    def _count(self, action: str):
        self._decisions[action] = self._decisions.get(action, 0) + 1
        if telemetry.enabled():
            self._m.decisions.labels(action=action).inc()

    def _ledger(self, event: str, **fields):
        sup = self.supervisor
        if sup is not None and getattr(sup, "ledger", None) is not None:
            sup.ledger.record(event, **fields)

    def _settle_pending(self, sig: dict, now: float):
        """Resolve watched scale-ups: HEALTHY closes the loop (latency
        observed + ledgered); a replica that died mid-warm is dropped
        from the watch — demand re-decides next tick."""
        for rid, t0 in list(self._pending.items()):
            if rid in sig["healthy"]:
                dt = now - t0
                del self._pending[rid]
                # the fleet just changed shape: idle accumulated against
                # the smaller pool must not authorize an immediate
                # scale-down in this very tick — the hold restarts now
                self._idle_since = None
                self._scale_ups.append(
                    {"replica": rid, "time_to_healthy_s": dt})
                if telemetry.enabled():
                    self._m.up_s.observe(dt)
                self._ledger("scale_up_healthy", replica=rid,
                             time_to_healthy_s=round(dt, 3))
                telemetry.record_event("autoscaler.scale_up_healthy",
                                       replica=rid, time_to_healthy_s=dt)
            elif rid in sig["stopped"] or rid in sig["unhealthy"]:
                # died (or was abandoned) before its first heartbeat:
                # stop watching; the next tick sees the demand again
                del self._pending[rid]
                telemetry.record_event("autoscaler.scale_up_lost",
                                       replica=rid)

    # -- the control loop --------------------------------------------------
    def tick(self) -> dict:
        """One control decision. Returns ``{"action": ...}`` — "up",
        "down", "none", "budget_exhausted", or "fault" — with the signal
        that drove it (tests assert on this; the background thread
        ignores it)."""
        sig = self.router.load_signal()
        now = self._clock()
        with self._lock:
            decision = self._decide(sig, now)
        telemetry.record_event("autoscaler.tick", action=decision["action"],
                               healthy=len(sig["healthy"]),
                               est_wait_s=sig["est_wait_s"],
                               queued=sig["queued"],
                               inflight=sig["inflight"])
        return decision

    def _decide(self, sig: dict, now: float) -> dict:
        self._settle_pending(sig, now)
        healthy = sig["healthy"]
        serving = len(healthy) + len(sig["starting"])
        est_wait = sig["est_wait_s"]
        load = sig["inflight"] + sig["queued"]
        if telemetry.enabled():
            self._m.healthy.set(len(healthy))
            self._m.est_wait.set(0.0 if est_wait == float("inf")
                                 else est_wait)
            self._m.target.set(serving)
        out = {"action": "none", "est_wait_s": est_wait,
               "healthy": len(healthy), "serving": serving}
        in_cooldown = (self._last_action is not None
                       and now - self._last_action < self.cooldown_s)

        # -- up: demand says the queue outruns the fleet -------------------
        # est_wait alone is not demand: it is derived from the fleet's
        # rolling SLO windows, so right after a burst it stays elevated
        # while the queues are already empty — acting on it would flap
        # (scale-down on idle, scale-up on the stale estimate, repeat).
        # Queued work is the forward-looking half of the signal.
        pressed = ((est_wait > self.scale_up_wait_s and sig["queued"] > 0)
                   or (not healthy and load > 0))
        if pressed and serving < self.max_replicas and sig["stopped"] \
                and not in_cooldown:
            rid = sig["stopped"][0]
            try:
                faults.inject("autoscaler.scale", action="up", replica=rid)
            except faults.FaultError as e:
                # fail-static: a faulted actuator changes nothing; the
                # pool stays as it is and the next tick re-decides
                self._count("fault")
                telemetry.record_event("autoscaler.scale_fault",
                                       action="up", error=str(e))
                return {**out, "action": "fault"}
            if self.supervisor is not None:
                backoff = self.supervisor.budget.next_backoff()
                if backoff is None:
                    self._count("budget_exhausted")
                    self._ledger("scale_up_denied", replica=rid,
                                 reason="restart_budget_exhausted")
                    telemetry.record_event(
                        "autoscaler.budget_exhausted", replica=rid)
                    return {**out, "action": "budget_exhausted"}
            try:
                # through the router's actuation lease (bounded wait:
                # losing the lease to a rollout/remediation mid-flight is
                # a normal race — yield and re-decide next tick, never
                # queue a stale scale decision behind a long drain)
                with self.router.actuation("autoscaler", "scale_up", rid,
                                           wait_s=self.lease_wait_s):
                    self.router.restart(rid, owner="autoscaler")
            except ActuationBusy as e:
                self._count("lease_busy")
                telemetry.record_event("autoscaler.lease_busy",
                                       action="up", replica=rid,
                                       holder=str(e.holder))
                return {**out, "action": "lease_busy"}
            except (RuntimeError, KeyError) as e:
                # raced an operator / the router (state changed under
                # us): no harm, re-read the signal next tick
                telemetry.record_event("autoscaler.restart_raced",
                                       replica=rid, error=str(e))
                return out
            self._pending[rid] = now
            self._last_action = now
            self._idle_since = None
            self._count("up")
            self._ledger("scale_up", replica=rid,
                         est_wait_s=round(est_wait, 3),
                         queued=sig["queued"], inflight=sig["inflight"],
                         healthy=len(healthy))
            telemetry.record_event("autoscaler.scale_up", replica=rid,
                                   est_wait_s=est_wait)
            return {**out, "action": "up", "replica": rid}

        # -- down: sustained idle, with hysteresis -------------------------
        util = (sig["inflight"] / len(healthy)) if healthy else 0.0
        idle = (healthy and sig["queued"] == 0
                and util <= self.scale_down_util)
        if not idle:
            self._idle_since = None
            return out
        if self._idle_since is None:
            self._idle_since = now
        if (now - self._idle_since < self.down_hold_s or in_cooldown
                or self._pending or len(healthy) <= self.min_replicas):
            return out
        by_load = sorted(healthy,
                         key=lambda rid: sig["inflight_by_rid"].get(rid, 0))
        rid = by_load[0]
        try:
            faults.inject("autoscaler.scale", action="down", replica=rid)
        except faults.FaultError as e:
            self._count("fault")
            telemetry.record_event("autoscaler.scale_fault",
                                   action="down", error=str(e))
            return {**out, "action": "fault"}
        try:
            with self.router.actuation("autoscaler", "scale_down", rid,
                                       wait_s=self.lease_wait_s):
                report = self.router.drain(rid, stop_replica=True,
                                           owner="autoscaler")
        except ActuationBusy as e:
            self._count("lease_busy")
            telemetry.record_event("autoscaler.lease_busy",
                                   action="down", replica=rid,
                                   holder=str(e.holder))
            return {**out, "action": "lease_busy"}
        self._last_action = now
        self._idle_since = None
        self._count("down")
        self._ledger("scale_down", replica=rid,
                     drained=bool(report.get("drained")),
                     failed_over=report.get("failed_over", 0),
                     healthy=len(healthy) - 1)
        telemetry.record_event("autoscaler.scale_down", replica=rid,
                               drained=report.get("drained"))
        return {**out, "action": "down", "replica": rid,
                "drain": report}

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        """The gateway ``/stats`` autoscaler block."""
        with self._lock:
            return {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "scale_up_wait_s": self.scale_up_wait_s,
                "decisions": dict(self._decisions),
                "pending": sorted(self._pending),
                "scale_ups": list(self._scale_ups[-32:]),
                "budget_remaining": (
                    self.supervisor.budget.remaining
                    if self.supervisor is not None else None),
            }
