"""The port's fleet control plane against the JAX package's: the same
signals through each package's ``Autoscaler``, ``RemediationEngine`` and
``RollingUpgrade`` over fake routers give the same decisions, audit trails
and ledger records; the interlocks hold under a seeded alert storm; one
soak ``degrade`` epoch (``serving/soak.py`` over the port's
``workload.py``) runs in-process on one ``LocalReplica`` behind the
journaled gateway and loses nothing.

The port has no ``resilience`` package yet: the supervisor, its restart
budget and its ledger are duck-typed fakes here, handed to both
packages alike.
"""
import contextlib
import random
import time
from types import SimpleNamespace

import pytest

from paddle_tpu.serving import autoscaler as j_autoscaler
from paddle_tpu.serving import remediation as j_remediation
from paddle_tpu.serving import rollout as j_rollout
from paddle_tpu.serving import router as j_router

from paddle_tpu_torch.serving import autoscaler, remediation, rollout, router
from paddle_tpu_torch.serving.soak import SoakConfig, run_soak
from paddle_tpu_torch.serving.workload import WorkloadSpec
from paddle_tpu_torch.utils import faults

PORT = SimpleNamespace(autoscaler=autoscaler, remediation=remediation,
                       rollout=rollout, router=router)
REF = SimpleNamespace(autoscaler=j_autoscaler, remediation=j_remediation,
                      rollout=j_rollout, router=j_router)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.deactivate()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


class FakeLedger:
    """The ledger surface the controllers use: ``record`` and ``read``."""

    def __init__(self):
        self.events = []

    def record(self, event, **fields):
        self.events.append({"event": event, **fields})

    def read(self):
        return {"events": [dict(e) for e in self.events]}


class FakeBudget:
    def __init__(self, n):
        self.max_restarts, self.used = n, 0

    def next_backoff(self):
        if self.used >= self.max_restarts:
            return None
        self.used += 1
        return 0.5 * 2 ** (self.used - 1)

    @property
    def remaining(self):
        return max(0, self.max_restarts - self.used)


def _supervisor(n=5):
    return SimpleNamespace(budget=FakeBudget(n), ledger=FakeLedger())


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------

class StubRouter:
    """A scripted router: the test sets the load signal, the autoscaler
    actuates against it."""

    def __init__(self):
        self.state = {"r0": "healthy", "r1": "stopped", "r2": "stopped"}
        self.replicas = {r: None for r in self.state}
        self.inflight_by_rid, self.queued, self.est_wait_s = {}, 0, 0.0
        self.restarts, self.drains = [], []

    def load_signal(self):
        by_state = {"healthy": [], "starting": [], "draining": [],
                    "unhealthy": [], "stopped": []}
        for rid in sorted(self.state):
            by_state[self.state[rid]].append(rid)
        inflight = {r: n for r, n in self.inflight_by_rid.items() if n}
        return {**by_state, "inflight": sum(inflight.values()),
                "inflight_by_rid": inflight, "queued": self.queued,
                "est_wait_s": (self.est_wait_s if by_state["healthy"]
                               else float("inf"))}

    @contextlib.contextmanager
    def actuation(self, owner, action="", target=None, wait_s=None):
        yield {"owner": owner, "action": action, "target": target}

    def restart(self, rid, owner="operator"):
        self.restarts.append(rid)
        self.state[rid] = "starting"

    def drain(self, rid, stop_replica=False, owner="operator"):
        self.drains.append(rid)
        self.state[rid] = "stopped"
        return {"drained": True, "failed_over": 0}


def _autoscale_trace(pkg):
    r, clk, sup = StubRouter(), FakeClock(0.0), _supervisor(2)
    a = pkg.autoscaler.Autoscaler(r, supervisor=sup, clock=clk,
                                  scale_up_wait_s=5.0, cooldown_s=5.0,
                                  down_hold_s=10.0)
    out = []
    script = [  # (dt, est_wait_s, queued, inflight, states to set)
        (0.0, 12.0, 8, {}, {}), (1.0, 12.0, 8, {}, {}),
        (2.0, 0.0, 0, {}, {"r1": "healthy"}), (6.0, 20.0, 4, {}, {}),
        (6.0, 20.0, 4, {}, {"r2": "healthy"}), (6.0, 20.0, 4, {}, {}),
        (1.0, 0.0, 0, {"r0": 1}, {}), (6.0, 0.0, 0, {}, {}),
        (11.0, 0.0, 0, {}, {}), (6.0, 0.0, 0, {}, {}),
        (11.0, 0.0, 0, {}, {}), (20.0, 30.0, 6, {}, {}),
    ]
    for dt, wait, queued, inflight, states in script:
        clk.tick(dt)
        r.est_wait_s, r.queued, r.inflight_by_rid = wait, queued, inflight
        r.state.update(states)
        out.append(a.tick())
    st = a.stats()
    return (out, r.restarts, r.drains, sup.ledger.read()["events"],
            {k: st[k] for k in ("decisions", "budget_remaining",
                                "scale_ups", "pending")})


def test_autoscaler_decisions_equal_the_reference():
    got, want = _autoscale_trace(PORT), _autoscale_trace(REF)
    assert got == want
    actions = [d["action"] for d in got[0]]
    assert "up" in actions and "down" in actions
    assert "budget_exhausted" in actions
    assert got[1] == ["r1", "r2"] and got[2]


# ---------------------------------------------------------------------------
# remediation
# ---------------------------------------------------------------------------

class FakeReplica:
    """Lifecycle only: start() jumps straight to HEALTHY, so drain and
    restart cycles complete under the router's real actuation lease."""

    kind = "proc"

    def __init__(self, rid, state_cls, stats_on_start=None):
        self.rid, self.state_cls = rid, state_cls
        self.spec, self.extra_env = {"model": "v1"}, {}
        self.state = state_cls.STOPPED
        self.stats, self.last_heartbeat = {}, 0.0
        self.pid = self.proto_version = None
        self.stats_on_start = stats_on_start
        self.starts = self.stops = 0

    def start(self, on_event):
        self.starts += 1
        self.state = self.state_cls.HEALTHY
        self.last_heartbeat = time.monotonic()
        if self.stats_on_start is not None:
            self.stats = dict(self.stats_on_start)

    def stop(self, graceful=True, timeout=10.0):
        self.stops += 1

    def kill(self):
        self.state = self.state_cls.STOPPED

    def send(self, obj):
        pass


def make_router(pkg, n=6, stats_on_start=None):
    S = pkg.router.ReplicaState
    reps = [FakeReplica(f"r{i}", S, stats_on_start) for i in range(n)]
    fr = pkg.router.FleetRouter(reps)
    for rep in reps:
        rep.state = S.HEALTHY
        rep.last_heartbeat = time.monotonic()
    return fr


STORM = dict(cooldown_s=10.0, global_window_s=60.0, global_max_actions=3,
             blast_radius=0.34, flap_n=3, flap_window_s=120.0,
             bake_timeout_s=30.0)


def _storm(pkg, seed):
    fr, clk = make_router(pkg), FakeClock()
    sup = _supervisor(3)
    eng = pkg.remediation.RemediationEngine(
        fr, supervisor=sup, playbooks=[
            pkg.remediation.Playbook("burn-*", "restart_replica",
                                     target="alert_key"),
            pkg.remediation.Playbook("cap-*", "scale_up", target="fleet")],
        clock=clk, audit_len=10 ** 5, lease_wait_s=1.0, **STORM)
    rng = random.Random(seed)
    for i in range(150):
        clk.tick(rng.choice([0.0, 1.0, 3.0, 7.0, 17.0]))
        if i == 75:
            fr.replicas["r5"].state = pkg.router.ReplicaState.STOPPED
        rule = rng.choice(["burn-ttft", "burn-tpot", "cap-queue"])
        key = "fleet" if rule.startswith("cap") else f"r{rng.randrange(6)}"
        state = "resolved" if rng.random() < 0.25 else "firing"
        eng.notify({"event": state, "alert": {
            "rule": rule, "key": key, "severity": "page", "state": state}})
    audit = [{k: v for k, v in e.items() if k != "seq"}
             for e in eng.audit_tail(10 ** 6)]
    st = eng.stats()
    return (audit, sorted(eng.quarantined),
            {rid: (r.state.value, r.starts) for rid, r in
             fr.replicas.items()},
            [e["event"] for e in sup.ledger.events],
            {k: st[k] for k in ("events_seen", "actions")})


@pytest.mark.parametrize("seed", [7, 2026])
def test_remediation_storm_equals_the_reference(seed):
    got, want = _storm(PORT, seed), _storm(REF, seed)
    assert got == want
    acts = [e for e in got[0] if e["kind"] == "acted"]
    assert acts and got[4]["actions"] == len(acts)
    # the interlocks, re-derived from the audit trail
    last = {}
    for e in acts:
        key = (e["action"], e["target"])
        if key in last:
            assert e["t"] - last[key] >= STORM["cooldown_s"]
        last[key] = e["t"]
        window = [x for x in acts
                  if e["t"] - STORM["global_window_s"] < x["t"] <= e["t"]]
        assert len(window) <= STORM["global_max_actions"]


def test_remediation_playbook_grammar():
    with pytest.raises(ValueError, match="unknown action"):
        remediation.Playbook("x-*", "reboot_the_universe")
    with pytest.raises(ValueError, match="target selector"):
        remediation.Playbook("x-*", "restart_replica", target="vibes")
    doc = {"match": "slo-*", "action": "drain_replica",
           "target": "worst_slo", "severity": "page", "cooldown_s": 5.0,
           "bake_s": 9.0}
    assert remediation.Playbook.parse(doc).doc() == doc
    assert [p.doc() for p in remediation.default_playbooks()] == \
        [p.doc() for p in j_remediation.default_playbooks()]


# ---------------------------------------------------------------------------
# rolling upgrade
# ---------------------------------------------------------------------------

GOOD = {"slo": {"tpot": {"p95": 0.05}, "goodput_ratio": 1.0,
                "window_requests": 10}}
SLOW = {"slo": {"tpot": {"p95": 0.50}, "goodput_ratio": 1.0,
                "window_requests": 10}}
KW = dict(canary_bake_s=0.05, bake_poll_s=0.01, drain_budget_s=1.0,
          healthy_wait_s=2.0)


def _rollouts(pkg):
    out = []
    fr = make_router(pkg, n=3)
    ledger = FakeLedger()
    doc = pkg.rollout.RollingUpgrade(
        fr, {"model": "v2"}, env={"ROLL": "1"}, ledger=ledger,
        rollout_id="ro-happy", **KW).run()
    out.append(({k: doc[k] for k in ("state", "upgraded", "canary_passed")},
                [e["event"] for e in ledger.events],
                [(r.spec, r.extra_env, r.starts)
                 for r in fr.replicas.values()]))
    fr = make_router(pkg, n=3, stats_on_start=SLOW)
    for rep in fr.replicas.values():
        rep.stats = dict(GOOD)
    ledger = FakeLedger()
    doc = pkg.rollout.RollingUpgrade(
        fr, {"model": "v2-slow"}, ledger=ledger, rollout_id="ro-slow",
        **dict(KW, canary_bake_s=1.0, regression_ratio=2.0,
               min_samples=3)).run()
    out.append((doc["state"], doc["reason"], doc["upgraded"],
                [e["event"] for e in ledger.events],
                [r.spec for r in fr.replicas.values()]))
    # a supervisor that dies after the first replica: resume from the
    # ledger on a fresh fleet
    ledger = FakeLedger()
    ru = pkg.rollout.RollingUpgrade(make_router(pkg, n=3), {"model": "v2"},
                                    ledger=ledger, rollout_id="ro-kill",
                                    **KW)
    ru.start()
    assert ru._upgrade_one("r0")
    fr2 = make_router(pkg, n=3)
    ru2 = pkg.rollout.RollingUpgrade.resume(fr2, ledger, **KW)
    doc = ru2.run()
    out.append((doc["state"], doc["upgraded"],
                [(r.spec, r.starts) for r in fr2.replicas.values()]))
    return out


def test_rollouts_equal_the_reference():
    got, want = _rollouts(PORT), _rollouts(REF)
    assert got == want
    assert got[0][0] == {"state": "done", "upgraded": ["r0", "r1", "r2"],
                         "canary_passed": True}
    assert got[1][0] == "rolled_back" and "canary r0 regressed" in got[1][1]
    assert got[2][0] == "done" and got[2][2][0] == ({"model": "v2"}, 0)


# ---------------------------------------------------------------------------
# soak: one degrade epoch in process
# ---------------------------------------------------------------------------

def test_soak_degrade_epoch_on_one_local_replica(tmp_path):
    spec = WorkloadSpec(
        name="smoke", seed=5, requests=12, vocab=64,
        arrival={"kind": "bursty", "calm_qps": 8.0, "burst_qps": 80.0,
                 "mean_calm_s": 0.6, "mean_burst_s": 0.25},
        prompt_len={"kind": "lognormal", "median": 8, "sigma": 0.4,
                    "min": 2, "max": 16},
        output_len={"kind": "lognormal", "median": 6, "sigma": 0.3,
                    "min": 2, "max": 8},
        slo={"ttft_s": 10.0, "tpot_s": 2.0})
    fleet_spec = {
        "seed": 0, "device": "cpu",
        "llama_tiny": {"vocab": 64, "hidden": 64, "layers": 1, "heads": 4,
                       "kv_heads": 2, "inter": 128, "seq": 48},
        "engine": {"block_size": 4, "max_slots": 3, "max_model_len": 24},
        "warmup": [4, 8, 16], "stats_interval_s": 0.05}
    cfg = SoakConfig(
        spec=spec, fleet_spec=fleet_spec, workdir=str(tmp_path), epochs=2,
        replicas=1, fleet="local", epoch_wait_s=60.0,
        chaos=[{"kind": "plan",
                "plan": "gateway.journal.append:delay=0.005%0.2"},
               {"kind": "compact"}],
        journal={"segment_max_records": 8, "compact_segments": 2,
                 "retain_terminal": 16},
        goodput_floor=0.3, kill_allowed=False)
    report = run_soak(cfg)
    assert report["passed"], report["violations"]
    assert all(row["lost"] == 0 for row in report["epochs"])
    assert all(not row.get("leaks") for row in report["epochs"])
    assert report["fingerprint"] and len(report["epochs"]) == 2
