"""Alert-driven remediation: the "act" half of detect→page→act
(counterpart of ``paddle_tpu/serving/remediation.py``).

The :class:`~paddle_tpu_torch.telemetry.alerts.AlertEngine` detects and
pages; this module closes the loop. A :class:`RemediationEngine`
subscribes to the alert engine's notifier hook and maps firing alerts to
declarative **playbooks** — "when this rule fires at this severity, take
this action against this target". The actions are the operator moves the
stack already has, now automated:

- ``restart_replica``   — drain + restart the target replica
- ``drain_replica``     — drain and park it (stop placement, fail over)
- ``scale_up``          — revive one parked replica (supervisor-budgeted)
- ``compact_journal``   — compact the gateway's write-ahead journal
- ``shed_tenant``       — suspend a tenant's admission (token starvation)
- ``collect_postmortem``— flight-recorder dump to disk, nothing actuated

An automated actuator is more dangerous than the outage it fixes unless
every action is wrapped in **safety interlocks**, checked in order and
each suppression audited:

1. *Quarantine* — a flapping target is never touched again until an
   operator clears it.
2. *Escalation hold* — a (rule, key) whose last action failed its bake is
   escalated to a human; re-firing does NOT retry the action.
3. *Per-action cooldown* — the same (action, target) pair cannot repeat
   within ``cooldown_s``.
4. *Global rate limit* — at most ``global_max_actions`` real actions per
   ``global_window_s``, across all playbooks.
5. *Blast-radius cap* — distinct replica targets actuated within the
   window may not exceed ``blast_radius`` × the currently-healthy fleet
   (floor 1): an alert storm can never take out the majority.
6. *Flap detection* — the same target triggering ``flap_n`` times within
   ``flap_window_s`` is quarantined + paged instead of actioned a third
   time. A sick replica becomes a human's problem, never a restart loop.
7. *Dry-run* — record the would-be action (audit + ledger) and do
   nothing.

A real action then runs under the router's **actuation lease**
(:meth:`FleetRouter.actuation`, owner ``"remediation"``) — single-actuator
arbitration with the autoscaler, rollouts, and operators: one controller
transitions replica lifecycle at a time, with owner attribution in
``/stats``.

Success is defined by the **post-condition bake**: an action only counts
as a fix if the triggering alert *resolves* within ``bake_timeout_s``.
A resolved event closes the bake as ok; a deadline pass **escalates**
(page + ledger + hold) instead of retrying — remediation that didn't work
the first time is evidence the playbook is wrong, not a reason to repeat
it faster.

Every decision — acted, suppressed (and why), baked ok, escalated,
quarantined — lands in a bounded audit ring, the flight recorder, the
``remediation_*`` metric families, and (for real actions and
escalations) the supervisor's ledger, so the job record tells the whole
story of what the machine did to itself. The supervisor is duck-typed
(the reference's ``resilience.ElasticSupervisor`` surface); the port has
no ``resilience`` package yet, so callers pass their own or None.
"""
from __future__ import annotations

import fnmatch
import os
import time
from types import SimpleNamespace

from .. import telemetry
from ..analysis import locksan
from ..telemetry import flight_recorder
from ..utils import faults
from .router import ActuationBusy

__all__ = ["Playbook", "RemediationEngine", "ACTIONS"]

ACTIONS = ("restart_replica", "drain_replica", "scale_up",
           "compact_journal", "shed_tenant", "collect_postmortem")

# target selectors a playbook may name (see Playbook.target)
_SELECTORS = ("alert_key", "worst_slo", "tenant", "fleet")

_RM = None


def _m():
    global _RM
    if _RM is None:
        reg = telemetry.registry()
        _RM = SimpleNamespace(
            actions=reg.counter(
                "remediation_actions_total",
                "playbook actions executed (post-interlock)", ("action",)),
            suppressed=reg.counter(
                "remediation_suppressed_total",
                "playbook actions suppressed by an interlock", ("reason",)),
            escalations=reg.counter(
                "remediation_escalations_total",
                "failed bakes escalated to a human (no retry)"),
            bakes=reg.counter(
                "remediation_bakes_total",
                "post-condition bakes by outcome", ("outcome",)),
            quarantined=reg.gauge(
                "remediation_quarantined_targets",
                "targets quarantined by flap detection"),
            dry_runs=reg.counter(
                "remediation_dry_runs_total",
                "actions recorded but not executed (dry-run mode)"),
            errors=reg.counter(
                "remediation_action_errors_total",
                "actions that raised while executing", ("action",)),
        )
    return _RM


class Playbook:
    """One declarative alert→action mapping.

    match:       alert *rule name* pattern (``fnmatch``: ``slo-*`` ok).
    action:      one of :data:`ACTIONS`.
    target:      how to pick the victim — ``"alert_key"`` (the alert key
                 is the replica id / tenant name), ``"worst_slo"`` (the
                 healthy replica with the worst SLO window), ``"tenant"``
                 (alert key names a tenant), ``"fleet"`` (fleet-scoped
                 actions: scale_up / compact_journal / collect_postmortem),
                 or ``"fixed:<rid>"``.
    severity:    only act at this severity (None = any).
    cooldown_s:  per-(action, target) repeat spacing (None = engine
                 default).
    bake_s:      post-condition bake deadline (None = engine default;
                 0 disables baking for fire-and-forget actions).
    """

    def __init__(self, match: str, action: str, *, target: str = "alert_key",
                 severity: str | None = None, cooldown_s: float | None = None,
                 bake_s: float | None = None):
        if action not in ACTIONS:
            raise ValueError(f"unknown action {action!r}; "
                             f"one of {ACTIONS}")
        if not (target in _SELECTORS or target.startswith("fixed:")):
            raise ValueError(f"unknown target selector {target!r}; one of "
                             f"{_SELECTORS} or 'fixed:<rid>'")
        self.match = str(match)
        self.action = action
        self.target = target
        self.severity = severity
        self.cooldown_s = cooldown_s
        self.bake_s = bake_s

    @classmethod
    def parse(cls, doc: dict) -> "Playbook":
        """From a JSON-ish dict (the fleet_ctl / config grammar)."""
        d = dict(doc)
        return cls(d.pop("match"), d.pop("action"), **d)

    def doc(self) -> dict:
        return {"match": self.match, "action": self.action,
                "target": self.target, "severity": self.severity,
                "cooldown_s": self.cooldown_s, "bake_s": self.bake_s}

    def matches(self, alert: dict) -> bool:
        if self.severity is not None and \
                alert.get("severity") != self.severity:
            return False
        return fnmatch.fnmatchcase(str(alert.get("rule") or ""), self.match)

    def __repr__(self):
        return (f"<Playbook {self.match!r} -> {self.action}"
                f"@{self.target}>")


def default_playbooks() -> list[Playbook]:
    """The conservative stock pack: page-severity burn alerts restart the
    worst replica; ticket-severity ones only collect evidence."""
    return [
        Playbook("slo-*burn*", "restart_replica", target="worst_slo",
                 severity="page"),
        Playbook("*", "collect_postmortem", target="fleet",
                 severity="ticket", bake_s=0.0),
    ]


class RemediationEngine:
    """Maps firing alerts to interlocked playbook actions over a fleet.

    router:      the :class:`~.router.FleetRouter` to actuate.
    playbooks:   list of :class:`Playbook` (default: stock pack).
    supervisor:  a supervisor (duck-typed, see the module docstring) —
                 its restart budget gates ``scale_up`` and its ledger gets
                 the audit record (falls back to ``ledger=``).
    journal / tenancy: targets for ``compact_journal`` / ``shed_tenant``.
    dry_run:     record everything, actuate nothing.
    notifier:    chained downstream notifier (a pager): called with every
                 alert event after remediation has seen it.

    Interlock knobs (cooldown_s, global_window_s, global_max_actions,
    blast_radius, flap_n, flap_window_s, bake_timeout_s) are documented in
    the module docstring; ``clock`` is injectable for deterministic tests.

    Wire it as the alert engine's notifier::

        remediation = RemediationEngine(router, supervisor=sup)
        alerts = AlertEngine(history, rules, notifier=remediation.notify)
    """

    def __init__(self, router, *, playbooks=None, supervisor=None,
                 ledger=None, journal=None, tenancy=None,
                 postmortem_dir: str | None = None,
                 cooldown_s: float = 60.0, global_window_s: float = 60.0,
                 global_max_actions: int = 4, blast_radius: float = 0.34,
                 flap_n: int = 3, flap_window_s: float = 600.0,
                 bake_timeout_s: float = 60.0, lease_wait_s: float = 5.0,
                 dry_run: bool = False, audit_len: int = 256,
                 clock=time.monotonic, notifier=None):
        self.router = router
        self.playbooks = list(playbooks if playbooks is not None
                              else default_playbooks())
        self.supervisor = supervisor
        self.ledger = ledger if ledger is not None else (
            supervisor.ledger if supervisor is not None else None)
        self.journal = journal
        self.tenancy = tenancy
        self.postmortem_dir = postmortem_dir
        self.cooldown_s = float(cooldown_s)
        self.global_window_s = float(global_window_s)
        self.global_max_actions = int(global_max_actions)
        self.blast_radius = float(blast_radius)
        self.flap_n = int(flap_n)
        self.flap_window_s = float(flap_window_s)
        self.bake_timeout_s = float(bake_timeout_s)
        self.lease_wait_s = float(lease_wait_s)
        self.dry_run = bool(dry_run)
        self.audit_len = int(audit_len)
        self._clock = clock
        self.next_notifier = notifier
        self._lock = locksan.Lock("remediation.state")
        self._last_action: dict[tuple, float] = {}   # (action, target) -> t
        self._global_log: list[float] = []           # real-action times
        self._radius_log: list[tuple] = []           # (t, replica target)
        self._flaps: dict[str, list] = {}            # target -> trigger ts
        self.quarantined: set[str] = set()
        self._bakes: dict[int, dict] = {}            # seq -> pending bake
        self._escalated: dict[tuple, int] = {}       # (rule, key) -> seq
        self._audit: list[dict] = []
        self._seq = 0
        self._c = {k: 0 for k in (
            "events_seen", "actions", "suppressed", "dry_runs",
            "bakes_ok", "escalations", "quarantines", "action_errors")}
        self._m = _m()

    # -- audit -------------------------------------------------------------
    def _audit_add(self, kind: str, **fields) -> dict:
        ent = {"t": round(self._clock(), 4), "kind": kind, **fields}
        with self._lock:
            self._audit.append(ent)
            del self._audit[:-self.audit_len]
        return ent

    def _ledger_record(self, event: str, **fields):
        if self.ledger is not None:
            self.ledger.record(event, **fields)

    # -- the alert-engine hook ---------------------------------------------
    def notify(self, event_doc: dict):
        """AlertEngine notifier entry: one alert transition. Firing alerts
        are considered for action; resolved alerts close pending bakes and
        clear escalation holds; every call also sweeps bake deadlines.
        Chains to ``next_notifier`` afterwards (exceptions there are the
        alert engine's notifier-hardening problem, not ours to swallow)."""
        event = event_doc.get("event")
        alert = dict(event_doc.get("alert") or {})
        with self._lock:
            self._c["events_seen"] += 1
        if event == "resolved":
            self._on_resolved(alert)
        elif event == "firing":
            self.consider(alert)
        self.check_bakes()
        if self.next_notifier is not None:
            self.next_notifier(event_doc)

    # alias so `notifier=engine.notify` and `notifier=engine` both work
    def __call__(self, event_doc: dict):
        self.notify(event_doc)

    # -- target resolution -------------------------------------------------
    def _resolve_target(self, pb: Playbook, alert: dict) -> str | None:
        """None = no actionable target (audited as suppressed)."""
        if pb.target.startswith("fixed:"):
            rid = pb.target.split(":", 1)[1]
            return rid if rid in self.router.replicas else None
        if pb.target == "fleet":
            return "fleet"
        if pb.target == "tenant":
            return str(alert.get("key")) if alert.get("key") else None
        if pb.target == "alert_key":
            key = str(alert.get("key") or "")
            return key if key in self.router.replicas else None
        # worst_slo: the healthy replica with the worst SLO window —
        # highest tpot p95, tie-broken by lowest goodput ratio
        stats = self.router.stats()
        worst, worst_score = None, None
        for rid, rep in stats.get("replicas", {}).items():
            if rep.get("state") != "healthy":
                continue
            slo = rep.get("slo") or {}
            tpot = ((slo.get("tpot") or {}).get("p95")) or 0.0
            good = slo.get("goodput_ratio")
            good = 1.0 if good is None else float(good)
            score = (float(tpot), -good)
            if worst_score is None or score > worst_score:
                worst, worst_score = rid, score
        return worst

    # -- interlocks --------------------------------------------------------
    def _suppress(self, reason: str, pb: Playbook, alert: dict,
                  target, **extra):
        with self._lock:
            self._c["suppressed"] += 1
        self._m.suppressed.labels(reason=reason).inc()
        self._audit_add("suppressed", reason=reason, action=pb.action,
                        target=target, rule=alert.get("rule"),
                        key=alert.get("key"), **extra)
        flight_recorder.record_event(
            "remediation.suppressed", reason=reason, action=pb.action,
            target=str(target), rule=alert.get("rule"))
        return None

    def _healthy_count(self) -> int:
        return sum(1 for r in self.router.replicas.values()
                   if getattr(r.state, "value", r.state) == "healthy")

    def _interlocks(self, pb: Playbook, alert: dict, target: str):
        """Return None to proceed; otherwise the suppression reason."""
        now = self._clock()
        rule_key = (alert.get("rule"), alert.get("key"))
        with self._lock:
            if target in self.quarantined:
                return "quarantined"
            if rule_key in self._escalated:
                return "escalation_hold"
            cd = pb.cooldown_s if pb.cooldown_s is not None \
                else self.cooldown_s
            last = self._last_action.get((pb.action, target))
            if last is not None and now - last < cd:
                return "cooldown"
            self._global_log = [t for t in self._global_log
                                if now - t < self.global_window_s]
            if len(self._global_log) >= self.global_max_actions:
                return "global_rate_limit"
            # blast radius: distinct REPLICA targets actuated this window
            # (fleet-scoped actions do not reduce serving capacity)
            if target in self.router.replicas:
                self._radius_log = [
                    (t, r) for t, r in self._radius_log
                    if now - t < self.global_window_s]
                touched = {r for _, r in self._radius_log}
                if target not in touched:
                    healthy = max(1, self._healthy_count())
                    cap = max(1, int(self.blast_radius * healthy))
                    if len(touched) + 1 > cap:
                        return "blast_radius"
            # flap detection: Nth trigger on the same target inside the
            # window quarantines instead of acting again
            log = self._flaps.setdefault(target, [])
            log[:] = [t for t in log if now - t < self.flap_window_s]
            log.append(now)
            if len(log) >= self.flap_n:
                self.quarantined.add(target)
                self._c["quarantines"] += 1
                self._m.quarantined.set(len(self.quarantined))
                return "flap_quarantine"
        return None

    # -- the decision ------------------------------------------------------
    def consider(self, alert: dict):
        """One firing alert: find a playbook, pass the interlocks, act."""
        pb = next((p for p in self.playbooks if p.matches(alert)), None)
        if pb is None:
            return None
        target = self._resolve_target(pb, alert)
        if target is None:
            return self._suppress("no_target", pb, alert, None)
        verdict = self._interlocks(pb, alert, target)
        if verdict == "flap_quarantine":
            # quarantine is a page, not a shrug: a target too sick for
            # automation is a human's problem now
            flight_recorder.record_event(
                "remediation.quarantined", target=target,
                rule=alert.get("rule"), severity="page",
                flap_n=self.flap_n, window_s=self.flap_window_s)
            self._ledger_record("remediation_quarantine", target=target,
                                rule=str(alert.get("rule")))
            return self._suppress(verdict, pb, alert, target)
        if verdict is not None:
            return self._suppress(verdict, pb, alert, target)
        if self.dry_run:
            with self._lock:
                self._c["dry_runs"] += 1
            self._m.dry_runs.inc()
            ent = self._audit_add(
                "dry_run", action=pb.action, target=target,
                rule=alert.get("rule"), key=alert.get("key"))
            self._ledger_record("remediation_dry_run", action=pb.action,
                                target=target, rule=str(alert.get("rule")))
            return ent
        return self._act(pb, alert, target)

    def _act(self, pb: Playbook, alert: dict, target: str):
        now = self._clock()
        try:
            faults.inject("serving.remediate.act", action=pb.action,
                          target=target)
            with self.router.actuation("remediation", pb.action, target,
                                       wait_s=self.lease_wait_s):
                detail = self._execute(pb.action, target, alert)
        except ActuationBusy as e:
            return self._suppress("lease_busy", pb, alert, target,
                                  holder=e.holder)
        except Exception as e:
            with self._lock:
                self._c["action_errors"] += 1
            self._m.errors.labels(action=pb.action).inc()
            self._audit_add("action_error", action=pb.action, target=target,
                            error=f"{type(e).__name__}: {e}")
            flight_recorder.record_event(
                "remediation.action_error", action=pb.action,
                target=target, error=f"{type(e).__name__}: {e}")
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._c["actions"] += 1
            self._last_action[(pb.action, target)] = now
            self._global_log.append(now)
            if target in self.router.replicas:
                self._radius_log.append((now, target))
        self._m.actions.labels(action=pb.action).inc()
        ent = self._audit_add("acted", seq=seq, action=pb.action,
                              target=target, rule=alert.get("rule"),
                              key=alert.get("key"), detail=detail)
        flight_recorder.record_event(
            "remediation.acted", seq=seq, action=pb.action, target=target,
            rule=alert.get("rule"), key=alert.get("key"))
        self._ledger_record("remediation_action", seq=seq, action=pb.action,
                            target=target, rule=str(alert.get("rule")),
                            key=str(alert.get("key")))
        bake_s = pb.bake_s if pb.bake_s is not None else self.bake_timeout_s
        if bake_s > 0:
            with self._lock:
                self._bakes[seq] = {
                    "seq": seq, "rule": alert.get("rule"),
                    "key": alert.get("key"), "action": pb.action,
                    "target": target, "deadline": now + bake_s}
        return ent

    # -- actions -----------------------------------------------------------
    def _execute(self, action: str, target: str, alert: dict):
        if action == "restart_replica":
            rep = self.router.replicas[target]
            state = getattr(rep.state, "value", rep.state)
            if state in ("stopped", "unhealthy"):
                self.router.restart(target, owner="remediation")
                return {"restarted": target, "was": state}
            return self.router.drain_and_restart(target,
                                                 owner="remediation")
        if action == "drain_replica":
            return self.router.drain(target, stop_replica=True,
                                     owner="remediation")
        if action == "scale_up":
            sig = self.router.load_signal()
            parked = sig.get("stopped") or []
            if not parked:
                return {"scaled": False, "reason": "no parked replica"}
            if self.supervisor is not None and \
                    self.supervisor.budget.next_backoff() is None:
                return {"scaled": False,
                        "reason": "restart_budget_exhausted"}
            self.router.restart(parked[0], owner="remediation")
            return {"scaled": True, "replica": parked[0]}
        if action == "compact_journal":
            if self.journal is None:
                return {"compacted": False, "reason": "no journal wired"}
            return {"compacted": True, **(self.journal.compact() or {})}
        if action == "shed_tenant":
            if self.tenancy is None:
                return {"shed": False, "reason": "no tenancy wired"}
            drained = self.tenancy.drain_bucket(target)
            return {"shed": drained, "tenant": target} if drained else \
                {"shed": False, "tenant": target,
                 "reason": "tenant has no token bucket"}
        if action == "collect_postmortem":
            path = None
            if self.postmortem_dir:
                os.makedirs(self.postmortem_dir, exist_ok=True)
                path = os.path.join(
                    self.postmortem_dir,
                    f"remediation-{int(self._clock() * 1000)}.json")
            out = flight_recorder.dump(
                reason=f"remediation: {alert.get('rule')} firing",
                path=path)
            return {"postmortem": out}
        raise ValueError(f"unknown action {action!r}")

    # -- bakes -------------------------------------------------------------
    def _on_resolved(self, alert: dict):
        rule_key = (alert.get("rule"), alert.get("key"))
        done = []
        with self._lock:
            self._escalated.pop(rule_key, None)
            for seq, b in list(self._bakes.items()):
                if (b["rule"], b["key"]) == rule_key:
                    done.append(self._bakes.pop(seq))
                    self._c["bakes_ok"] += 1
        for b in done:
            self._m.bakes.labels(outcome="ok").inc()
            self._audit_add("bake_ok", **{k: b[k] for k in
                                          ("seq", "action", "target",
                                           "rule", "key")})
            flight_recorder.record_event(
                "remediation.bake_ok", seq=b["seq"], action=b["action"],
                target=b["target"], rule=b["rule"])

    def check_bakes(self):
        """Sweep bake deadlines: a bake whose alert has not resolved in
        time **escalates** — page + ledger + hold, never a retry. Called
        from every notify(); call directly when driving with a fake
        clock."""
        now = self._clock()
        expired = []
        with self._lock:
            for seq, b in list(self._bakes.items()):
                if now >= b["deadline"]:
                    expired.append(self._bakes.pop(seq))
                    self._escalated[(b["rule"], b["key"])] = seq
                    self._c["escalations"] += 1
        for b in expired:
            self._m.bakes.labels(outcome="escalated").inc()
            self._m.escalations.inc()
            self._audit_add("escalated", **{k: b[k] for k in
                                            ("seq", "action", "target",
                                             "rule", "key")})
            flight_recorder.record_event(
                "remediation.escalated", severity="page", seq=b["seq"],
                action=b["action"], target=b["target"], rule=b["rule"],
                reason="post-condition bake expired: alert did not "
                       "resolve — human needed, no retry")
            self._ledger_record(
                "remediation_escalation", seq=b["seq"], action=b["action"],
                target=str(b["target"]), rule=str(b["rule"]))
        return len(expired)

    # -- operator surface --------------------------------------------------
    def unquarantine(self, target: str) -> bool:
        """Operator override: clear a flap quarantine (fleet_ctl)."""
        with self._lock:
            had = target in self.quarantined
            self.quarantined.discard(target)
            self._flaps.pop(target, None)
            self._m.quarantined.set(len(self.quarantined))
        if had:
            self._audit_add("unquarantined", target=target)
        return had

    def audit_tail(self, n: int = 32) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._audit[-n:]]

    def stats(self) -> dict:
        """The gateway ``/stats`` remediation block."""
        with self._lock:
            return {
                "dry_run": self.dry_run,
                "playbooks": [p.doc() for p in self.playbooks],
                "quarantined": sorted(self.quarantined),
                "pending_bakes": [
                    {k: b[k] for k in ("seq", "rule", "key", "action",
                                       "target")}
                    for b in self._bakes.values()],
                "escalated": [
                    {"rule": rk[0], "key": rk[1], "seq": seq}
                    for rk, seq in self._escalated.items()],
                "interlocks": {
                    "cooldown_s": self.cooldown_s,
                    "global_window_s": self.global_window_s,
                    "global_max_actions": self.global_max_actions,
                    "blast_radius": self.blast_radius,
                    "flap_n": self.flap_n,
                    "flap_window_s": self.flap_window_s,
                    "bake_timeout_s": self.bake_timeout_s,
                },
                **self._c,
                "audit_tail": [dict(e) for e in self._audit[-8:]],
            }
