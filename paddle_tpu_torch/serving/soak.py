"""Rolling-chaos soak harness: hours of realistic traffic, continuously
asserted invariants (counterpart of ``paddle_tpu/serving/soak.py``, over
the port's ``workload.py``).

A chaos *scenario* proves one failure mode in isolation; a *soak*
proves the system under sustained, realistic load while failure modes
rotate underneath it — the shape production actually has. This module
composes the pieces the repo already trusts:

- the workload engine (:mod:`.workload`) replays a seeded
  :class:`WorkloadSpec` open-loop against the gateway's real HTTP/SSE
  surface, epoch after epoch;
- a *rolling chaos plan* applies one action per epoch, cycling through
  fault-plan arming (``utils.faults`` grammar), replica SIGKILL /
  ``kill()``, drain/restart churn, autoscaler ticks, and explicit
  journal compaction;
- after every epoch the pass criteria are re-asserted — not once at
  the end, so a violation is attributed to the epoch (and chaos
  action) that caused it:

  1. **zero lost accepted requests** — every stream the gateway
     accepted (HTTP 200) reaches a terminal state; sheds (429/503)
     are counted but are not losses. The journal cross-check:
     ``non_terminal`` drains back to zero once the epoch's traffic
     completes.
  2. **leak sentinel quiet** — no replica's
     :class:`~paddle_tpu_torch.telemetry.perf.MemoryMonitor` flags a
     monotonically climbing high watermark (read straight off
     heartbeats for ProcReplicas, so it works across process
     boundaries).
  3. **journal bounds hold** — ``wal-*`` segment count stays within
     ``compact_segments`` (+ the open segment + rotation slack) and
     on-disk bytes stay under a static bound derived from
     ``segment_max_records`` × ``retain_terminal``; compaction must
     actually cycle (oldest segment seq advances).
  4. **per-tenant SLO goodput floor** — each tenant's within-SLO
     completion fraction (offered-load denominator: sheds and
     failures count against it) stays above ``goodput_floor``.

``tests/test_torch_fleet_control.py`` runs one ``degrade`` epoch
in-process on one ``LocalReplica``.
"""
from __future__ import annotations

import http.client
import json
import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

from .. import telemetry
from ..utils import faults
from .workload import OpenLoopRunner, WorkloadSpec, generate, summarize

__all__ = ["SoakConfig", "SoakHarness", "run_soak"]


# ---------------------------------------------------------------------------
# metrics

_METRICS = None


def _soak_metrics() -> SimpleNamespace:
    reg = telemetry.registry()
    return SimpleNamespace(
        epochs=reg.counter(
            "soak_epochs_total",
            "soak epochs completed (one workload replay + one chaos "
            "action + one criteria sweep each)"),
        actions=reg.counter(
            "soak_chaos_actions_total",
            "rolling-chaos actions applied, by kind", ("action",)),
        failures=reg.counter(
            "soak_criteria_failures_total",
            "soak pass-criteria violations, by criterion",
            ("criterion",)),
        lost=reg.counter(
            "soak_lost_requests_total",
            "accepted requests that never reached a terminal state "
            "(the invariant every soak asserts stays zero)"),
    )


def _metrics() -> SimpleNamespace:
    global _METRICS
    if _METRICS is None:
        _METRICS = _soak_metrics()
    return _METRICS


# ---------------------------------------------------------------------------
# config

@dataclass
class SoakConfig:
    """One soak run, declaratively.

    ``fleet_spec`` is the same replica spec dict ``ProcReplica`` /
    ``replica_worker.build_model`` consume (``llama_tiny`` or
    ``llama_7b`` + ``device`` + ``engine`` + ``warmup``). ``chaos`` is
    the rolling plan:
    a list of actions applied round-robin, one per epoch —

    - ``{"kind": "none"}`` — quiet epoch (the control);
    - ``{"kind": "plan", "plan": "<faults grammar>"}`` — arm an
      in-process :class:`~paddle_tpu_torch.utils.faults.FaultPlan` for the
      epoch (degradation: slow journal appends, flaky pipes, ...);
    - ``{"kind": "kill"}`` — SIGKILL / ``kill()`` one replica
      mid-epoch (round-robin rid) and let failover + the supervisor
      path prove zero-loss;
    - ``{"kind": "churn"}`` — drain one replica, then restart it
      (the autoscaler's scale-down/up motion, forced);
    - ``{"kind": "compact"}`` — explicit journal compaction mid-epoch
      on top of the organic rotation-driven cycles.
    """

    spec: WorkloadSpec
    fleet_spec: dict
    workdir: str
    epochs: int = 3
    replicas: int = 1
    fleet: str = "local"                 # local | proc
    time_scale: float = 1.0
    epoch_wait_s: float = 60.0
    chaos: list = field(default_factory=lambda: [{"kind": "none"}])
    journal: dict = field(default_factory=lambda: {
        "segment_max_records": 32, "compact_segments": 2,
        "retain_terminal": 64})
    goodput_floor: float | None = None
    min_tenant_requests: int = 4         # floor only judged above this
    kill_allowed: bool = True
    api_keys: dict = field(default_factory=dict)   # tenant -> Bearer key
    tenancy: dict | None = None          # Gateway tenancy registry dict
    autoscale: bool = False


# ---------------------------------------------------------------------------
# HTTP/SSE submit adapter

def _http_submit(gw_host, gw_port, api_keys):
    """A workload ``submit`` adapter over the gateway's streaming HTTP
    surface. Runs entirely inside ``finish()`` — the open-loop runner
    already gives each dispatch its own thread."""

    def submit(wreq):
        def finish():
            body = {"prompt": list(wreq.prompt),
                    "max_tokens": wreq.max_new_tokens,
                    "temperature": 0.0, "seed": 0, "stream": True}
            headers = {"Content-Type": "application/json"}
            key = api_keys.get(wreq.tenant)
            if key:
                headers["Authorization"] = f"Bearer {key}"
            t0 = time.monotonic()
            ttft = None
            tokens = 0
            finish_reason = None
            error = None
            try:
                conn = http.client.HTTPConnection(
                    gw_host, gw_port, timeout=600)
                conn.request("POST", "/v1/completions",
                             json.dumps(body), headers)
                resp = conn.getresponse()
                if resp.status != 200:
                    doc = json.loads(resp.read())
                    conn.close()
                    return {"outcome": "shed", "tokens": 0,
                            "error": doc.get("error", {}).get("message")}
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    line = line.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    payload = line[6:]
                    if payload == "[DONE]":
                        break
                    doc = json.loads(payload)
                    ch = doc["choices"][0]
                    ids = ch.get("token_ids") or []
                    if ids and ttft is None:
                        ttft = time.monotonic() - t0
                    tokens += len(ids)
                    if ch.get("finish_reason"):
                        finish_reason = ch["finish_reason"]
                    if doc.get("error"):
                        error = doc["error"]["message"]
                conn.close()
            except Exception as e:  # lint: allow-silent(returned as outcome=lost; the zero-lost criterion fails the epoch)
                return {"outcome": "lost", "ttft": ttft,
                        "tokens": tokens,
                        "error": f"{type(e).__name__}: {e}"}
            if finish_reason is not None and error is None:
                return {"outcome": "ok", "ttft": ttft, "tokens": tokens}
            if error is not None:
                # terminal error frame: surfaced, not lost
                return {"outcome": "failed", "ttft": ttft,
                        "tokens": tokens, "error": error}
            # accepted (200) but the stream ended without a terminal
            # frame — this is exactly the "lost accepted request" the
            # soak exists to catch
            return {"outcome": "lost", "ttft": ttft, "tokens": tokens,
                    "error": "stream ended without terminal frame"}
        return finish

    return submit


# ---------------------------------------------------------------------------
# harness

class SoakHarness:
    """Builds the fleet, replays epochs, applies the rolling chaos
    plan, and asserts the pass criteria after every epoch."""

    def __init__(self, cfg: SoakConfig):
        self.cfg = cfg
        self.router = None
        self.gateway = None
        self.replicas = []
        self.autoscaler = None
        self._kill_cursor = 0

    # -- fleet lifecycle --------------------------------------------------
    def start(self) -> "SoakHarness":
        from . import FleetRouter, Gateway, LocalReplica, ProcReplica
        cfg = self.cfg
        spec = cfg.fleet_spec
        os.makedirs(cfg.workdir, exist_ok=True)
        # the leak criterion is judged against the process-global
        # MemoryMonitor; start it from a clean slate so watermark
        # history from earlier engines in this process (a pytest run,
        # a prior soak) can't fake a monotonic-growth streak — engines
        # built below re-register their bounded tags at construction
        telemetry.memory_monitor().clear()
        if cfg.fleet == "proc":
            self.replicas = [
                ProcReplica(f"s{i}", spec,
                            log_path=os.path.join(
                                cfg.workdir, f"soak-s{i}.log"))
                for i in range(cfg.replicas)]
        else:
            from .replica_worker import build_model
            from .engine import LLMEngine

            def factory(spec=spec):
                return LLMEngine(build_model(spec), **spec["engine"])

            self.replicas = [
                LocalReplica(f"s{i}", factory,
                             warmup=spec.get("warmup"),
                             stats_interval_s=spec.get(
                                 "stats_interval_s", 0.05))
                for i in range(cfg.replicas)]
        # generous probe timeout: a shared-core fleet mid-compile can
        # legitimately go seconds between heartbeats, and a false
        # UNHEALTHY verdict turns the whole epoch into shed
        self.router = FleetRouter(
            self.replicas, probe_interval_s=0.1, probe_timeout_s=30.0,
            affinity_block_size=spec["engine"].get("block_size", 16),
        ).start(wait_healthy_s=600)
        self.gateway = Gateway(
            self.router,
            journal_dir=os.path.join(cfg.workdir, "soak-journal"),
            journal_kwargs=dict(cfg.journal),
            tenancy=cfg.tenancy,
        ).start()
        if cfg.autoscale:
            from .autoscaler import Autoscaler
            self.autoscaler = Autoscaler(self.router, min_replicas=1)
        return self

    def close(self):
        if self.autoscaler is not None:
            try:
                self.autoscaler.close()
            except Exception:   # lint: allow-silent(best-effort teardown)
                pass
        for obj in (self.gateway, self.router):
            if obj is not None:
                try:
                    obj.close() if hasattr(obj, "close") else obj.stop()
                except Exception:   # lint: allow-silent(best-effort teardown)
                    pass

    # -- chaos actions ----------------------------------------------------
    def _next_victim(self):
        rid = self._kill_cursor % len(self.replicas)
        self._kill_cursor += 1
        return self.replicas[rid]

    def _apply_chaos(self, action: dict, runner_fn):
        """Run one epoch's traffic with ``action`` applied. ``plan``
        wraps the replay in an armed FaultPlan; ``kill``/``churn``/
        ``compact`` fire mid-epoch from this thread after a short lead
        time so in-flight requests exist when the fault lands."""
        kind = action.get("kind", "none")
        if telemetry.enabled():
            _metrics().actions.labels(action=kind).inc()
        if kind == "plan":
            with faults.FaultPlan.parse(action["plan"]) as plan:
                results = runner_fn()
            return results, {"kind": kind, "plan": action["plan"],
                             "fired": plan.summary()}
        if kind == "none":
            return runner_fn(), {"kind": kind}

        import threading
        detail = {"kind": kind}

        def mid_epoch():
            time.sleep(action.get("lead_s", 0.3))
            try:
                if kind == "kill" and self.cfg.kill_allowed:
                    victim = self._next_victim()
                    detail["victim"] = victim.rid
                    victim.kill()
                    # rolling chaos is fault *and* recovery: failover
                    # absorbs the in-flight work, then the victim comes
                    # back so the next epoch faces a full fleet again
                    time.sleep(action.get("restart_delay_s", 1.0))
                    self.router.restart(victim.rid)
                    detail["restarted"] = True
                elif kind == "churn":
                    victim = self._next_victim()
                    detail["victim"] = victim.rid
                    self.router.drain(
                        victim.rid,
                        budget_s=action.get("drain_budget_s", 5.0))
                    time.sleep(action.get("drain_s", 0.5))
                    self.router.restart(victim.rid)
                elif kind == "compact":
                    if self.gateway.journal is not None:
                        self.gateway.journal.compact()
                        detail["compacted"] = True
                if self.autoscaler is not None:
                    self.autoscaler.tick()
            except Exception as e:  # lint: allow-silent(captured into the epoch's chaos detail row, visible in the report)
                detail["error"] = f"{type(e).__name__}: {e}"

        th = threading.Thread(target=mid_epoch,
                              name=f"soak-chaos-{kind}", daemon=True)
        th.start()
        results = runner_fn()
        th.join(timeout=30)
        return results, detail

    # -- criteria ---------------------------------------------------------
    def _journal_bounds(self) -> dict:
        j = self.gateway.journal
        cfg = dict(self.cfg.journal)
        seg_cap = int(cfg.get("compact_segments", 4)) + 2
        rec_cap = (int(cfg.get("retain_terminal", 1024)) +
                   int(cfg.get("segment_max_records", 4096)) * seg_cap)
        byte_cap = rec_cap * 2048          # generous per-record bound
        st = j.stats()
        files = sorted(f for f in os.listdir(st["root"])
                       if f.startswith("wal-"))
        disk = sum(os.path.getsize(os.path.join(st["root"], f))
                   for f in files)
        oldest_seq = int(files[0][4:-4]) if files else 0
        return {
            "segments": st["segments"], "segment_cap": seg_cap,
            "disk_bytes": disk, "byte_cap": byte_cap,
            "records": st["records"],
            "non_terminal": st["non_terminal"],
            "oldest_seq": oldest_seq,
            "ok": (st["segments"] <= seg_cap and disk <= byte_cap),
        }

    def _leak_flags(self) -> dict:
        flags = {}
        for rep in self.replicas:
            eng = getattr(rep, "engine", None)
            if eng is not None:             # LocalReplica: direct
                rep_flags = sorted(eng._mm.leak_report())
            else:                           # ProcReplica: heartbeat
                rep_flags = (rep.stats or {}).get("leaks", [])
            if rep_flags:
                flags[rep.rid] = rep_flags
        return flags

    def _tenant_goodput(self, results) -> dict:
        slo = self.cfg.spec.slo or {}
        ttft_slo = slo.get("ttft_s")
        out = {}
        for tenant in sorted({rr.tenant for rr in results}):
            sub = [rr for rr in results if rr.tenant == tenant]
            good = sum(
                1 for rr in sub
                if rr.outcome == "ok" and (
                    ttft_slo is None or (rr.ttft_s is not None
                                         and rr.ttft_s <= ttft_slo)))
            out[tenant] = {"offered": len(sub), "good": good,
                           "ratio": good / len(sub) if sub else None}
        return out

    def _check_epoch(self, results, epoch_row) -> list:
        """All criteria for one epoch; returns the violation list."""
        cfg, m = self.cfg, _metrics()
        violations = []
        lost = sum(1 for rr in results if rr.outcome == "lost")
        epoch_row["lost"] = lost
        if lost:
            violations.append(f"lost_accepted={lost}")
            if telemetry.enabled():
                m.lost.inc(lost)
                m.failures.labels(criterion="lost_accepted").inc()

        # journal has the interval-fsync grace before we read it
        time.sleep(0.2)
        jb = self._journal_bounds()
        epoch_row["journal"] = jb
        if not jb["ok"]:
            violations.append(
                f"journal_bounds segments={jb['segments']}/"
                f"{jb['segment_cap']} bytes={jb['disk_bytes']}/"
                f"{jb['byte_cap']}")
            if telemetry.enabled():
                m.failures.labels(criterion="journal_bounds").inc()
        if jb["non_terminal"] != 0:
            violations.append(
                f"journal_non_terminal={jb['non_terminal']}")
            if telemetry.enabled():
                m.failures.labels(criterion="journal_drain").inc()

        leaks = self._leak_flags()
        epoch_row["leaks"] = leaks
        if leaks:
            violations.append(f"leak_sentinel={leaks}")
            if telemetry.enabled():
                m.failures.labels(criterion="leak_sentinel").inc()

        tg = self._tenant_goodput(results)
        epoch_row["tenant_goodput"] = tg
        if cfg.goodput_floor is not None:
            for tenant, row in tg.items():
                if (row["offered"] >= cfg.min_tenant_requests
                        and row["ratio"] is not None
                        and row["ratio"] < cfg.goodput_floor):
                    violations.append(
                        f"goodput_floor tenant={tenant} "
                        f"{row['ratio']:.2f}<{cfg.goodput_floor}")
                    if telemetry.enabled():
                        m.failures.labels(
                            criterion="goodput_floor").inc()
        return violations

    # -- the run loop -----------------------------------------------------
    def run(self) -> dict:
        cfg = self.cfg
        workload = generate(
            cfg.spec,
            max_model_len=cfg.fleet_spec["engine"].get("max_model_len"))
        submit = _http_submit(self.gateway.host, self.gateway.port,
                              cfg.api_keys)
        epochs = []
        compaction_seqs = []
        all_violations = []
        t_start = time.monotonic()
        for epoch in range(cfg.epochs):
            action = cfg.chaos[epoch % len(cfg.chaos)] if cfg.chaos \
                else {"kind": "none"}

            def replay():
                return OpenLoopRunner(
                    workload, submit, time_scale=cfg.time_scale,
                    max_wait_s=cfg.epoch_wait_s).run()

            t0 = time.monotonic()
            results, chaos_detail = self._apply_chaos(action, replay)
            row = {
                "epoch": epoch,
                "chaos": chaos_detail,
                "wall_s": round(time.monotonic() - t0, 3),
                "workload": summarize(results, slo=cfg.spec.slo),
            }
            violations = self._check_epoch(results, row)
            row["violations"] = violations
            all_violations += [f"epoch{epoch}: {v}" for v in violations]
            compaction_seqs.append(row["journal"]["oldest_seq"])
            epochs.append(row)
            if telemetry.enabled():
                _metrics().epochs.inc()
        # compaction actually cycled: the oldest live wal segment seq
        # must advance across the soak (rewrites retire old segments)
        compaction_cycles = sum(
            1 for a, b in zip(compaction_seqs, compaction_seqs[1:])
            if b > a)
        report = {
            "spec": cfg.spec.to_dict(),
            "fingerprint": workload.fingerprint(),
            "fleet": cfg.fleet,
            "replicas": cfg.replicas,
            "epochs": epochs,
            "wall_s": round(time.monotonic() - t_start, 3),
            "compaction_seq_trail": compaction_seqs,
            "compaction_cycles_observed": compaction_cycles,
            "violations": all_violations,
            "passed": not all_violations,
        }
        return report


def run_soak(cfg: SoakConfig) -> dict:
    """Build the fleet, run the configured soak, tear down, report."""
    h = SoakHarness(cfg).start()
    try:
        return h.run()
    finally:
        h.close()
