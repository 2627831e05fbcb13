"""Zero-downtime rolling upgrade with canary auto-rollback (counterpart of
``paddle_tpu/serving/rollout.py``).

The only way to change a replica spec used to be a flash-cut restart of
the whole fleet. :class:`RollingUpgrade` upgrades a live
:class:`~.router.FleetRouter` **one replica at a time** without dropping
an accepted request:

- **Drain→swap→restart.** Each step holds the router's actuation lease
  (owner ``"rollout"``), drains the replica (in-flight streams fail over
  with replay parity — the router's job), swaps its spec (+``extra_env``
  for :class:`~.router.ProcReplica`), restarts it, and waits for
  HEALTHY.
- **Canary bake.** The FIRST upgraded replica bakes for
  ``canary_bake_s`` against the pre-rollout fleet baseline before any
  other replica is touched: it must stay HEALTHY, its SLO window must
  not regress past ``regression_ratio`` × baseline tpot p95 (goodput
  below ``min_goodput`` likewise fails), and no page-severity alert may
  fire (when an alert engine is wired). A canary that regresses triggers
  **automatic rollback** — every upgraded replica is drained back onto
  the old spec, newest first.
- **Mixed-version fleets.** The replica hello carries ``proto_version``
  (:data:`~.router.PROTO_VERSION`); the router admits anything in
  ``PROTO_COMPAT`` and refuses the rest (a refused canary never reports
  HEALTHY, which reads as a canary failure here → rollback). Old and new
  replicas co-serve mid-rollout by construction.
- **Resumable.** Every transition is recorded in the supervisor's ledger
  (duck-typed: the reference's ``resilience.JobLedger`` surface, which
  the port has not ported yet; ``rollout_*`` events), so a supervisor SIGKILL mid-rollout loses
  nothing: :meth:`RollingUpgrade.resume` reconstructs the exact position
  — which replicas are upgraded, whether the canary passed — and
  :meth:`run` continues (or :meth:`rollback` unwinds) instead of leaving
  a half-upgraded fleet.

States: ``idle → rolling → done``, with ``rolling_back → rolled_back``
on canary regression / operator rollback, and ``failed`` when even
rollback could not restore a replica.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

from .. import telemetry
from ..analysis import locksan
from ..telemetry import flight_recorder
from ..utils import faults
from .router import ReplicaState

__all__ = ["RollingUpgrade", "RolloutError"]

_ROM = None


def _m():
    global _ROM
    if _ROM is None:
        reg = telemetry.registry()
        _ROM = SimpleNamespace(
            steps=reg.counter(
                "rollout_steps_total",
                "replica upgrade steps by outcome", ("outcome",)),
            rollbacks=reg.counter(
                "rollout_rollbacks_total",
                "rollouts rolled back (canary regression / operator)"),
            canary=reg.counter(
                "rollout_canary_bakes_total",
                "canary bakes by verdict", ("verdict",)),
            state=reg.gauge(
                "rollout_active",
                "1 while a rollout is in flight (rolling or rolling_back)"),
            resumes=reg.counter(
                "rollout_resumes_total",
                "rollouts resumed from the ledger after a supervisor "
                "death"),
        )
    return _ROM


class RolloutError(RuntimeError):
    """A rollout step failed in a way rollback could not repair."""


class RollingUpgrade:
    """One rolling spec upgrade over a router's replica fleet.

    router:          the :class:`~.router.FleetRouter`.
    new_spec:        the replica spec to roll onto (``ProcReplica.spec``;
                     for :class:`~.router.LocalReplica` fleets pass
                     ``factory_for_spec`` mapping spec→engine_factory).
    env:             extra env merged into each upgraded
                     ``ProcReplica.extra_env`` (how chaos ships a
                     deliberately slow ``FLAGS_fault_plan`` canary).
    ledger:          a ledger (duck-typed ``record`` / ``read``, the
                     reference's ``resilience.JobLedger``) for the
                     durable state record (None = not resumable).
    alerts:          optional :class:`~paddle_tpu_torch.telemetry.alerts.
                     AlertEngine` — a page-severity alert firing during
                     the canary bake fails it.
    canary_bake_s:   how long the first upgraded replica must hold its
                     SLO before the rest proceed.
    drain_budget_s:  per-replica drain budget.
    healthy_wait_s:  restart→HEALTHY deadline per replica.
    regression_ratio: canary tpot p95 above ``ratio × baseline`` fails
                     the bake (with at least ``min_samples`` window
                     requests observed).
    min_goodput:     canary goodput_ratio floor during the bake.
    dry_run:         plan + record, touch nothing.
    """

    _TERMINAL = ("done", "rolled_back", "failed")

    def __init__(self, router, new_spec: dict, *, env: dict | None = None,
                 ledger=None, alerts=None, factory_for_spec=None,
                 rollout_id: str | None = None,
                 canary_bake_s: float = 10.0, drain_budget_s: float = 15.0,
                 healthy_wait_s: float = 60.0, bake_poll_s: float = 0.2,
                 regression_ratio: float = 2.0, min_goodput: float = 0.5,
                 min_samples: int = 3, dry_run: bool = False,
                 clock=time.monotonic):
        self.router = router
        self.new_spec = dict(new_spec)
        self.env = dict(env or {})
        self.ledger = ledger
        self.alerts = alerts
        self.factory_for_spec = factory_for_spec
        self.rollout_id = rollout_id or f"rollout-{int(time.time())}"
        self.canary_bake_s = float(canary_bake_s)
        self.drain_budget_s = float(drain_budget_s)
        self.healthy_wait_s = float(healthy_wait_s)
        self.bake_poll_s = float(bake_poll_s)
        self.regression_ratio = float(regression_ratio)
        self.min_goodput = float(min_goodput)
        self.min_samples = int(min_samples)
        self.dry_run = bool(dry_run)
        self._clock = clock
        self._lock = locksan.Lock("rollout.state")
        self.state = "idle"
        self.plan: list[str] = list(router._order)
        self.upgraded: list[str] = []
        self.canary_passed = False
        self.baseline: dict | None = None
        self.reason: str | None = None
        # old spec/env per replica, captured before each swap (and
        # re-derivable from the ledger record on resume)
        self._saved: dict[str, dict] = {}
        self._m = _m()

    # -- ledger record -----------------------------------------------------
    def _record(self, event: str, **fields):
        if self.ledger is not None:
            self.ledger.record(event, rollout_id=self.rollout_id, **fields)

    def doc(self) -> dict:
        """State snapshot (gateway /stats + fleet_ctl + resume tests)."""
        with self._lock:
            return {
                "rollout_id": self.rollout_id,
                "state": self.state,
                "plan": list(self.plan),
                "upgraded": list(self.upgraded),
                "canary_passed": self.canary_passed,
                "dry_run": self.dry_run,
                "reason": self.reason,
                "new_spec": dict(self.new_spec),
                "env": dict(self.env),
            }

    # -- the fleet baseline ------------------------------------------------
    def _fleet_baseline(self) -> dict:
        """Pre-rollout SLO snapshot the canary is judged against: the
        fleet-median tpot p95 + goodput across healthy replicas."""
        stats = self.router.stats()
        tpots, goods = [], []
        for rep in stats.get("replicas", {}).values():
            if rep.get("state") != "healthy":
                continue
            slo = rep.get("slo") or {}
            t = (slo.get("tpot") or {}).get("p95")
            if t is not None:
                tpots.append(float(t))
            g = slo.get("goodput_ratio")
            if g is not None:
                goods.append(float(g))
        tpots.sort()
        goods.sort()
        return {
            "tpot_p95": tpots[len(tpots) // 2] if tpots else None,
            "goodput_ratio": goods[len(goods) // 2] if goods else None,
        }

    # -- spec swap ---------------------------------------------------------
    def _apply_spec(self, rep, spec: dict, env: dict):
        if rep.kind == "proc":
            rep.spec = dict(spec)
            rep.extra_env = dict(env)
        else:
            if self.factory_for_spec is None:
                raise RolloutError(
                    f"replica {rep.rid} is in-process and no "
                    f"factory_for_spec was given")
            rep.engine_factory = self.factory_for_spec(spec)
            hp = env.get("PADDLE_PROTO_VERSION")
            if hp is not None:
                rep.hello_proto = int(hp)

    def _save_current(self, rep) -> dict:
        if rep.kind == "proc":
            return {"spec": dict(rep.spec), "env": dict(rep.extra_env)}
        return {"factory": rep.engine_factory,
                "hello_proto": rep.hello_proto}

    def _restore(self, rep, saved: dict):
        if rep.kind == "proc":
            rep.spec = dict(saved["spec"])
            rep.extra_env = dict(saved["env"])
        else:
            rep.engine_factory = saved["factory"]
            rep.hello_proto = saved["hello_proto"]

    # -- the state machine -------------------------------------------------
    def start(self) -> "RollingUpgrade":
        """Record the rollout plan durably and enter ``rolling``."""
        with self._lock:
            if self.state != "idle":
                raise RolloutError(
                    f"rollout {self.rollout_id} already {self.state}")
            self.baseline = self._fleet_baseline()
            self.state = "rolling"
        self._m.state.set(1)
        self._record("rollout_started", plan=list(self.plan),
                     new_spec=self.new_spec, env=self.env,
                     baseline=self.baseline, dry_run=self.dry_run,
                     canary_bake_s=self.canary_bake_s)
        flight_recorder.record_event(
            "rollout.started", rollout_id=self.rollout_id,
            replicas=len(self.plan), dry_run=self.dry_run)
        return self

    def run(self) -> dict:
        """Drive the rollout to a terminal state; returns :meth:`doc`.
        Safe to call on a resumed instance — already-upgraded replicas
        are skipped, a pending canary bake re-bakes."""
        if self.state == "idle":
            self.start()
        if self.dry_run:
            with self._lock:
                self.state = "done"
                self.reason = "dry_run"
            self._m.state.set(0)
            self._record("rollout_done", dry_run=True)
            return self.doc()
        for rid in list(self.plan):
            if self.state != "rolling":
                break
            if rid in self.upgraded:
                continue
            if not self._upgrade_one(rid):
                return self.doc()       # rollback already ran
            if not self.canary_passed:
                if self._bake_canary(rid):
                    with self._lock:
                        self.canary_passed = True
                    self._m.canary.labels(verdict="ok").inc()
                    self._record("rollout_canary_ok", replica=rid)
                    flight_recorder.record_event(
                        "rollout.canary_ok", rollout_id=self.rollout_id,
                        replica=rid)
                else:
                    self._m.canary.labels(verdict="regressed").inc()
                    self.rollback(
                        reason=f"canary {rid} regressed: {self.reason}")
                    return self.doc()
        if self.state == "rolling":
            with self._lock:
                self.state = "done"
            self._m.state.set(0)
            self._record("rollout_done", upgraded=list(self.upgraded))
            flight_recorder.record_event(
                "rollout.done", rollout_id=self.rollout_id,
                upgraded=len(self.upgraded))
        return self.doc()

    def _upgrade_one(self, rid: str) -> bool:
        rep = self.router.replicas[rid]
        try:
            faults.inject("serving.rollout.step", replica=rid)
            with self.router.actuation("rollout", "upgrade", rid):
                saved = self._save_current(rep)
                self._saved[rid] = saved
                if rep.state is ReplicaState.HEALTHY:
                    report = self.router.drain(
                        rid, budget_s=self.drain_budget_s,
                        stop_replica=True, owner="rollout")
                    if not report.get("drained"):
                        raise RolloutError(
                            f"drain of {rid} refused: {report}")
                self._apply_spec(rep, self.new_spec, self.env)
                self.router.restart(rid, owner="rollout")
        except Exception as e:
            self._m.steps.labels(outcome="error").inc()
            self.reason = f"{type(e).__name__}: {e}"
            # the spec may already be half-swapped; put the restore point
            # back before unwinding (rid is not in `upgraded`, so
            # rollback() itself will not touch it)
            if rid in self._saved:
                self._restore(rep, self._saved[rid])
            self.rollback(reason=f"upgrade of {rid} failed: {self.reason}")
            return False
        if not self._wait_healthy(rid, self.healthy_wait_s):
            self._m.steps.labels(outcome="unhealthy").inc()
            # the replica is already on the new spec: rollback must
            # restore it too
            with self._lock:
                self.upgraded.append(rid)
            self.reason = (f"{rid} did not report HEALTHY within "
                           f"{self.healthy_wait_s}s (proto refusal or "
                           f"startup failure)")
            self.rollback(reason=self.reason)
            return False
        with self._lock:
            self.upgraded.append(rid)
        self._m.steps.labels(outcome="ok").inc()
        # proc replicas' restore point is JSON — record it so a resume
        # after supervisor death can still roll this replica back
        saved = self._saved.get(rid) or {}
        self._record("rollout_replica_done", replica=rid,
                     **({"old": saved} if "spec" in saved else {}))
        flight_recorder.record_event(
            "rollout.replica_done", rollout_id=self.rollout_id,
            replica=rid)
        return True

    def _wait_healthy(self, rid: str, timeout: float) -> bool:
        rep = self.router.replicas[rid]
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            if rep.state is ReplicaState.HEALTHY:
                return True
            if rep.state is ReplicaState.STOPPED:
                return False        # proto-refused: the router parked it
            time.sleep(0.02)
        return False

    # -- canary ------------------------------------------------------------
    def _canary_verdict(self, rid: str) -> str | None:
        """None = still fine; otherwise the failure reason."""
        rep = self.router.replicas[rid]
        if rep.state is not ReplicaState.HEALTHY:
            return f"canary left HEALTHY ({rep.state.value})"
        if self.alerts is not None:
            firing = [a for a in self.alerts.active()
                      if a.get("state") == "firing"
                      and a.get("severity") == "page"]
            if firing:
                return (f"page alert firing during bake: "
                        f"{firing[0].get('rule')}")
        slo = (rep.stats or {}).get("slo") or {}
        if int(slo.get("window_requests") or 0) < self.min_samples:
            return None             # not enough signal yet — keep baking
        base = self.baseline or {}
        tpot = (slo.get("tpot") or {}).get("p95")
        base_tpot = base.get("tpot_p95")
        if tpot is not None and base_tpot:
            if float(tpot) > self.regression_ratio * float(base_tpot):
                return (f"tpot p95 {float(tpot):.4f}s > "
                        f"{self.regression_ratio}x baseline "
                        f"{float(base_tpot):.4f}s")
        good = slo.get("goodput_ratio")
        if good is not None and float(good) < self.min_goodput:
            return (f"goodput {float(good):.3f} < floor "
                    f"{self.min_goodput}")
        return None

    def _bake_canary(self, rid: str) -> bool:
        deadline = self._clock() + self.canary_bake_s
        flight_recorder.record_event(
            "rollout.canary_bake", rollout_id=self.rollout_id,
            replica=rid, bake_s=self.canary_bake_s)
        while self._clock() < deadline:
            verdict = self._canary_verdict(rid)
            if verdict is not None:
                self.reason = verdict
                return False
            time.sleep(self.bake_poll_s)
        return True

    # -- rollback ----------------------------------------------------------
    def rollback(self, reason: str = "operator") -> dict:
        """Restore every upgraded replica to its saved spec, newest
        first. Terminal state ``rolled_back`` (or ``failed`` if a restore
        itself failed — the fleet needs a human)."""
        with self._lock:
            if self.state in self._TERMINAL:
                return self.doc()
            self.state = "rolling_back"
            self.reason = reason
            victims = list(reversed(self.upgraded))
        self._m.rollbacks.inc()
        self._record("rollout_rollback", reason=reason,
                     replicas=victims)
        flight_recorder.record_event(
            "rollout.rollback", rollout_id=self.rollout_id,
            reason=reason, replicas=len(victims))
        failed = []
        for rid in victims:
            rep = self.router.replicas[rid]
            saved = self._saved.get(rid)
            if saved is None:
                failed.append(rid)
                continue
            try:
                with self.router.actuation("rollout", "rollback", rid):
                    if rep.state is ReplicaState.HEALTHY:
                        self.router.drain(
                            rid, budget_s=self.drain_budget_s,
                            stop_replica=True, owner="rollout")
                    self._restore(rep, saved)
                    self.router.restart(rid, owner="rollout")
                if not self._wait_healthy(rid, self.healthy_wait_s):
                    failed.append(rid)
            except Exception as e:
                telemetry.record_event(
                    "rollout.rollback_error", replica=rid,
                    error=f"{type(e).__name__}: {e}")
                failed.append(rid)
        with self._lock:
            self.upgraded = [r for r in self.upgraded if r in failed]
            self.state = "failed" if failed else "rolled_back"
        self._m.state.set(0)
        self._record("rollout_rolled_back", failed=failed)
        flight_recorder.record_event(
            "rollout.rolled_back", rollout_id=self.rollout_id,
            failed=len(failed))
        return self.doc()

    # -- resume ------------------------------------------------------------
    @classmethod
    def resume(cls, router, ledger, **overrides) -> "RollingUpgrade | None":
        """Reconstruct the in-flight rollout from the ledger (None when
        the record shows no unfinished rollout). The supervisor calls
        this after its own restart; the returned instance's :meth:`doc`
        is bit-exact with the pre-kill instance's, and :meth:`run`
        continues from the recorded position. The restored fleet is
        re-baselined from the ledger record, and already-upgraded
        replicas get the new spec re-applied (process state died with
        the old supervisor; the ledger is the truth)."""
        events = ledger.read().get("events", [])
        started = None
        for ev in events:
            if ev.get("event") == "rollout_started":
                started = ev
            elif ev.get("event") in ("rollout_done",
                                     "rollout_rolled_back") and \
                    started is not None and \
                    ev.get("rollout_id") == started.get("rollout_id"):
                started = None
        if started is None:
            return None
        rid_ = started["rollout_id"]
        overrides.setdefault(
            "canary_bake_s", float(started.get("canary_bake_s", 10.0)))
        ru = cls(router, started.get("new_spec") or {},
                 env=started.get("env") or {}, ledger=ledger,
                 rollout_id=rid_, dry_run=bool(started.get("dry_run")),
                 **overrides)
        ru.plan = list(started.get("plan") or router._order)
        ru.baseline = started.get("baseline")
        rolling_back = False
        for ev in events:
            if ev.get("rollout_id") != rid_:
                continue
            kind = ev.get("event")
            if kind == "rollout_replica_done":
                ru.upgraded.append(ev["replica"])
                if ev.get("old"):
                    ru._saved[ev["replica"]] = dict(ev["old"])
            elif kind == "rollout_canary_ok":
                ru.canary_passed = True
            elif kind == "rollout_rollback":
                rolling_back = True
                ru.reason = ev.get("reason")
        ru.state = "rolling_back" if rolling_back else "rolling"
        # restore points not in the ledger (in-process replicas): the
        # best available truth is the replica's current configuration.
        # Upgraded proc replicas rebooted by the new supervisor came up on
        # the pre-rollout spec — re-apply the recorded new spec so the
        # fleet converges on the ledger's truth at their next start.
        for r in ru.upgraded:
            rep = router.replicas.get(r)
            if rep is None:
                continue
            if r not in ru._saved:
                ru._saved[r] = ru._save_current(rep)
            if rep.kind == "proc" and rep.spec != ru.new_spec:
                rep.spec = dict(ru.new_spec)
                rep.extra_env = dict(ru.env)
        _m().resumes.inc()
        ru._m.state.set(1)
        ru._record("rollout_resumed", upgraded=list(ru.upgraded),
                   canary_passed=ru.canary_passed)
        flight_recorder.record_event(
            "rollout.resumed", rollout_id=rid_,
            upgraded=len(ru.upgraded), state=ru.state)
        return ru
