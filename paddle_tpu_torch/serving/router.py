"""Engine fleet router: health-checked replicas, failover, shedding, drain
(counterpart of ``paddle_tpu/serving/router.py``).

A single :class:`~paddle_tpu_torch.serving.engine.LLMEngine` is a single point of
failure — one stuck decode, one dead process, and every in-flight stream
dies with it. :class:`FleetRouter` puts N engine replicas behind one
placement/health plane:

- **Replica lifecycle.** Each replica is either in-process
  (:class:`LocalReplica`: a driver thread stepping its own engine, every
  call into the engine — and so every CUDA call — on that thread) or a
  real child process (:class:`ProcReplica`: ``python -m
  paddle_tpu_torch.serving.replica_worker`` speaking line-JSON over its pipes —
  the thing a SIGKILL can take out mid-decode). A probe loop watches
  heartbeats: a replica is UNHEALTHY on process/thread death, a stale
  heartbeat (probe timeout — a decode wedged by a ``collective:delay``
  storm stops heartbeating), or an engine stall-detector trip.
- **Failover (replay-and-suppress).** When a replica goes UNHEALTHY, every
  request in flight on it is re-dispatched to a healthy replica with the
  *original* prompt and sampling params. Sampling is keyed by
  ``(seed, output index)``, so the new replica regenerates the exact same
  stream from index 0; the router suppresses the first ``k`` already-
  delivered tokens (verifying each equals what was streamed — a mismatch is
  a parity violation and fails the request rather than corrupting the
  stream) and the client stream continues token-for-token correct.
- **Placement.** The fleet KV directory first (when the fabric is armed,
  ``kv_fabric=``): place the request where its prefix chain *actually*
  lives — the deepest advertised chain among eligible replicas, with the
  same load slack as affinity. Then prefix affinity: the hash of the
  prompt's block-aligned prefix names a preferred replica, so
  shared-prefix traffic keeps hitting the same engine's prefix cache. If
  the preferred replica is unhealthy, shedding, or clearly overloaded,
  fall back to power-of-two-choices on in-flight load.
- **KV migration (serving/kv_fabric.py).** When placement cannot land on
  the prefix's host (overload, health), the router *pulls* the blocks to
  wherever the request is going: a ``kv_fetch`` verb to the donor returns
  CRC32-stamped serialized frames, a ``kv_ingest`` verb lands them on the
  target for CRC-verified promotion before the ``add`` dispatches — a hot
  prefix replicates instead of re-prefilling. Strictly advisory and
  budgeted (``max_fetches_per_window``): a stale directory entry, a dead
  donor mid-fetch, a corrupt frame, or a timeout all degrade to local
  prefill, never to wrong tokens.
- **Load shedding.** Layered on the signals the engines already export: a
  replica "sheds" when its rolling-window SLO tracker says so
  (``stats()["slo"]["shed"]``) or its router-side in-flight count hits
  ``max_inflight_per_replica`` (the bounded-admission analogue). A new
  request is rejected (:class:`RouterShed` → HTTP 429 + Retry-After at the
  gateway) only when *every* healthy replica sheds and the request's
  priority is below ``shed_bypass_priority`` — lowest priority sheds
  first, and an in-flight stream is **never** shed (failover dispatches
  bypass shedding entirely).
- **Drain / restart.** :meth:`drain` stops placement to a replica, waits
  for its in-flight work up to a budget, fails over the stragglers, and
  stops it; :meth:`restart` brings it back through the supervisor's
  restart budget and ledger (when one is given), so replica churn shows
  up in the same record as training restarts.
- **Circuit breakers + retry budget.** A replica can be *alive* (process
  up, heartbeating) yet failing every request it is handed — a poisoned
  compile cache, a bad device. Each replica carries a
  :class:`CircuitBreaker` over its rolling dispatch outcomes: past
  ``breaker_failure_rate`` over ``breaker_window_s`` (with at least
  ``breaker_min_samples`` outcomes) it trips OPEN and placement skips the
  replica; after ``breaker_cooldown_s`` one HALF_OPEN probe request is
  allowed through — success closes the breaker, failure re-opens it.
  Orthogonally, a global **retry budget** caps re-dispatch volume: re-
  dispatches (failovers + engine-failure retries) within
  ``retry_budget_window_s`` may not exceed ``retry_budget_min +
  retry_budget_ratio * first_dispatches`` — when the budget is spent the
  request fails fast (``retry_budget_exhausted``) instead of feeding a
  retry storm against a sick fleet.

Chaos sites: ``router.submit`` (per submission), ``router.dispatch`` (per
dispatch attempt; an injected error is treated as a failed dispatch and the
request tries another replica), ``router.probe`` (per health probe; an
injected error marks the replica unhealthy).

The ``supervisor`` is duck-typed (``decide(...)`` and a ``ledger`` with
``record(...)``, the reference's ``resilience.ElasticSupervisor``
surface); the port has no ``resilience`` package yet, so callers pass
their own or None.
"""
from __future__ import annotations

import contextlib
import enum
import hashlib
import itertools
import json
import os
import queue
import random
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

from .. import telemetry
from ..telemetry import reqtrace
from ..utils import faults
from .scheduler import SamplingParams
from ..analysis import locksan

__all__ = [
    "FleetRouter", "RouterRequest", "ReplicaState", "LocalReplica",
    "ProcReplica", "RouterShed", "NoHealthyReplica", "ReplayMismatch",
    "ActuationBusy", "CircuitBreaker", "sampling_to_dict",
    "sampling_from_dict", "PROTO_VERSION", "PROTO_COMPAT",
]

# Pipe-protocol version: carried by the replica ``hello`` so a rolling
# upgrade can run a mixed-version fleet — the router accepts any version
# in PROTO_COMPAT and refuses (stops, never restarts into a loop) anything
# else. 0 is the implicit version of pre-handshake workers; bump
# PROTO_VERSION on a wire-format change and keep the old version in
# PROTO_COMPAT for exactly one release so in-place upgrades stay possible.
PROTO_VERSION = 1
PROTO_COMPAT = frozenset({0, PROTO_VERSION})


class RouterShed(RuntimeError):
    """The router refused a new request (every healthy replica is shedding
    and the request's priority does not bypass). Carries ``retry_after_s``
    so the gateway can answer 429 + Retry-After. ``tenant`` names who was
    shed and by what: a fleet-wide shed leaves it None; a tenant shed by
    *its own token bucket* (serving/tenancy.py) carries its name, and its
    ``retry_after_s`` is the bucket refill time — not the fleet-wide
    Little's-law estimate, which would tell a rate-limited tenant to
    retry straight back into the same limit."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 tenant: str | None = None):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant


class ActuationBusy(RuntimeError):
    """The fleet actuation lease is held by another controller and the
    caller declined to wait. Carries the current holder's attribution so
    the refused controller can log *who* it lost to."""

    def __init__(self, message: str, holder: dict | None = None):
        super().__init__(message)
        self.holder = dict(holder) if holder else None


class NoHealthyReplica(RuntimeError):
    """No replica is in a placeable state (HTTP 503 at the gateway)."""


class ReplayMismatch(RuntimeError):
    """A failover replay produced a token different from one already
    streamed to the client — the determinism contract broke; the request
    fails rather than silently forking the stream."""


def sampling_to_dict(sp: SamplingParams | None) -> dict:
    sp = sp or SamplingParams()
    return {"max_new_tokens": sp.max_new_tokens,
            "temperature": sp.temperature, "top_k": sp.top_k,
            "top_p": sp.top_p, "seed": sp.seed}


def sampling_from_dict(d: dict | None) -> SamplingParams:
    return SamplingParams(**(d or {}))


class ReplicaState(enum.Enum):
    STARTING = "starting"      # launched, no heartbeat yet
    HEALTHY = "healthy"        # heartbeating; placement target
    DRAINING = "draining"      # no new placement; in-flight finishing
    UNHEALTHY = "unhealthy"    # probe failed / dead; in-flight failed over
    STOPPED = "stopped"        # intentionally down (post-drain / abort)


# errors that are deterministic properties of the request itself — a second
# replica would fail identically, so the router surfaces them instead of
# retrying (everything else, e.g. an injected compile error or an allocator
# faulted dry, is worth one try elsewhere)
_NON_RETRYABLE = ("ValueError",)


class CircuitBreaker:
    """Rolling failure-rate breaker over one replica's dispatch outcomes.

    States: CLOSED (normal placement) -> OPEN (failure rate over the
    window crossed ``failure_rate`` with >= ``min_samples`` outcomes;
    placement skips the replica) -> HALF_OPEN (cooldown elapsed; exactly
    one probe request may be placed) -> CLOSED on probe success / OPEN on
    probe failure. All transitions happen under the router lock.
    """

    def __init__(self, *, window_s: float = 30.0, min_samples: int = 4,
                 failure_rate: float = 0.5, cooldown_s: float = 2.0):
        self.window_s = float(window_s)
        self.min_samples = int(min_samples)
        self.failure_rate = float(failure_rate)
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"            # closed | open | half_open
        self.trips = 0
        self.probes = 0
        self._events: list[tuple[float, bool]] = []   # (t, ok)
        self._opened_at = 0.0
        self._probe_inflight = False

    def _prune(self, now: float):
        cutoff = now - self.window_s
        self._events = [e for e in self._events if e[0] >= cutoff]

    def _trip(self, now: float):
        self.state = "open"
        self.trips += 1
        self._opened_at = now
        self._probe_inflight = False
        self._events.clear()

    def record(self, ok: bool, now: float | None = None):
        """One dispatch outcome (request finished vs failed on the
        replica). A HALF_OPEN probe's outcome decides the next state."""
        now = time.monotonic() if now is None else now
        if self.state == "half_open":
            self._probe_inflight = False
            if ok:
                self.state = "closed"
                self._events.clear()
            else:
                self._trip(now)
            return
        if self.state == "open":
            return                        # stale outcome from before the trip
        self._events.append((now, ok))
        self._prune(now)
        fails = sum(1 for _, k in self._events if not k)
        total = len(self._events)
        if total >= self.min_samples and fails / total >= self.failure_rate:
            self._trip(now)

    def allow(self, now: float | None = None) -> bool:
        """May placement hand this replica a request right now? An OPEN
        breaker whose cooldown elapsed transitions to HALF_OPEN and admits
        exactly one probe."""
        now = time.monotonic() if now is None else now
        if self.state == "closed":
            return True
        if self.state == "open":
            if now - self._opened_at < self.cooldown_s:
                return False
            self.state = "half_open"
        if self._probe_inflight:
            return False
        return True

    def note_probe(self):
        """Placement chose this HALF_OPEN replica: the next outcome is the
        probe verdict."""
        if self.state == "half_open":
            self._probe_inflight = True
            self.probes += 1


class RouterRequest:
    """The router-side handle for one client stream.

    ``tokens`` is exactly what the client has been shown, no matter how many
    replicas served it; ``failovers``/``retries`` count re-dispatches after
    replica death / engine-reported failure. Terminal ``state`` is one of
    "finished" / "failed" / "cancelled" (string, not the engine enum — the
    engine request living in another process is not this object)."""

    def __init__(self, gid: int, prompt, sampling: dict, *, priority=0,
                 deadline: float | None = None, on_token=None,
                 on_finish=None, trace_id: str | None = None,
                 on_watermark=None, watermark_every: int = 8,
                 tenant: str = "anonymous"):
        self.gid = gid
        self.prompt = [int(t) for t in prompt]
        self.sampling = dict(sampling)
        self.priority = int(priority)
        self.tenant = str(tenant or "anonymous")
        self.deadline = deadline            # absolute time.monotonic()
        self.on_token = on_token            # callable(rr, token)
        self.on_finish = on_finish          # callable(rr)
        # durable-lifecycle watermark: called with (rr, n_tokens) every
        # ``watermark_every`` delivered tokens — the gateway's journal
        # cadence (suppressed replay tokens never re-fire it)
        self.on_watermark = on_watermark
        self.watermark_every = max(1, int(watermark_every))
        self.tokens: list[int] = []
        self.state = "queued"
        self.finish_reason: str | None = None
        self.error: str | None = None
        self.replica: str | None = None     # current owner's rid
        self.suppress = 0                   # replayed tokens to swallow
        self.failovers = 0
        self.retries = 0
        self.dispatches = 0
        self.cancel_requested = False
        self.arrival_time = time.monotonic()
        self.first_token_time: float | None = None
        self.finish_time: float | None = None
        self._done = threading.Event()
        # request-trace context (telemetry.reqtrace): the id every hop's
        # spans carry; remote_spans are the replica-side spans streamed
        # back in heartbeats (wire format, unix-stamped, +replica label);
        # hop_log records each dispatch's replica + wall window so a hop
        # whose spans died with its replica still gets a trace row
        self.trace_id = trace_id or reqtrace.new_trace_id()
        self.remote_spans: list[dict] = []
        self.hop_log: list[dict] = []
        self._failover_t0: float | None = None

    @property
    def terminal(self) -> bool:
        return self.state in ("finished", "failed", "cancelled")

    @property
    def ttft(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def wait(self, timeout: float | None = None) -> bool:
        """Block until terminal; True if it reached a terminal state."""
        return self._done.wait(timeout)

    def _finish(self, state: str, reason: str | None, error: str | None):
        self.state = state
        self.finish_reason = reason
        self.error = error
        self.finish_time = time.monotonic()
        self._done.set()
        if self.on_finish is not None:
            self.on_finish(self)


# ---------------------------------------------------------------------------
# replica handles
# ---------------------------------------------------------------------------

def replica_stats(engine) -> dict:
    """The light health snapshot a replica heartbeats (full ``stats()`` is
    a registry sweep + perf block — too heavy per beat). ``stalls`` feeds
    the router's stall-trip health check."""
    return {
        "queue_depth": engine.scheduler.queue_depth,
        "num_running": len(engine.scheduler.running),
        "num_finished": len(engine.finished),
        "num_failed": len(engine.failed),
        "num_cancelled": len(engine.cancelled),
        "stalls": sum(1 for r in engine.failed
                      if r.finish_reason == "stalled"),
        "watchdog_trips": engine.watchdog_trips,
        "blocks_used": engine.cache.allocator.num_used,
        "blocks_cached": engine.cache.allocator.num_cached,
        "blocks_usable": engine.cache.allocator.num_usable,
        "generated_tokens": engine._total_generated,
        "slo": engine.slo.summary(),
        "prefix_cache": engine.cache.prefix_stats(),
        # per-tenant counters + cost attribution + tenant SLO windows —
        # the fleet aggregation the gateway /stats and autoscaler read
        "tenancy": engine._tenancy_acct.summary(),
        # leak-sentinel flags only (the full perf/memory block is a
        # registry sweep — too heavy per beat): non-empty means the
        # MemoryMonitor saw its high watermark climb across every drained
        # step in the window. The soak harness asserts this stays empty.
        "leaks": sorted(engine._mm.leak_report()),
    }


# LocalReplica drivers build their engines under one lock: a factory that
# seeds a shared RNG and then draws weights from it would interleave its
# draws with a sibling's and end up with different weights — silently
# breaking failover replay parity (ProcReplica is immune: each child
# process owns its RNG; replica_worker.build_model draws from its own
# seeded torch.Generator).
_BUILD_LOCK = locksan.Lock("router.build")


class LocalReplica:
    """In-process replica: one engine, one driver thread, the same event
    protocol a :class:`ProcReplica` speaks. ``kill()`` simulates abrupt
    process death — the driver abandons the engine mid-flight and every
    event after the kill is dropped (a dead process cannot speak).

    ``engine_factory`` builds the engine on the driver thread, which then
    makes every call into it (so a CUDA engine's work stays on one
    thread). It should build a **private model instance** (seed → config
    → weights, exactly like ``replica_worker.build_model``): identical
    seeds give identical weights, which is what makes failover replay
    token-for-token exact. An eager model is stateless between calls, so
    a factory may also hand its engine a model the caller built, provided
    no other thread runs that model at the same time."""

    kind = "local"

    def __init__(self, rid: str, engine_factory, *,
                 stats_interval_s: float = 0.05, warmup=None, fabric=None):
        self.rid = str(rid)
        self.engine_factory = engine_factory
        self.stats_interval_s = float(stats_interval_s)
        # tokens served before the first heartbeat so the prefill bucket +
        # decode traces compile while the replica is still STARTING (the
        # router's liveness timeout only starts once it reports ready)
        self.warmup = list(warmup) if warmup else None
        # KV-fabric directory publishing (serving/kv_fabric.py): a dict
        # like {"store": <store obj | "host:port">, "lease_s": ...} arms
        # a DirectoryPublisher on the driver's heartbeat cadence
        self.fabric = dict(fabric) if fabric else None
        self.state = ReplicaState.STOPPED
        self.engine = None
        self.stats: dict = {}
        self.last_heartbeat = 0.0
        self.pid = os.getpid()
        self.proto_version: int | None = None
        # what this replica's hello claims — tests/chaos override it to
        # exercise the router's version refusal without a real old binary
        self.hello_proto = PROTO_VERSION
        self._gen = 0                     # incarnation counter
        self._on_event = None
        self._inbox: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._killed = False
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------
    def start(self, on_event):
        self._on_event = on_event
        self._gen += 1
        self._stopping = False
        self._inbox = queue.Queue()
        go = threading.Event()
        thread = threading.Thread(
            target=self._drive, args=(self._gen, self._inbox, go),
            name=f"replica-{self.rid}", daemon=True)
        thread.start()
        # the new driver is alive before the router can read STARTING, so
        # a probe between the two never finds a restarting replica dead
        # (the reference sets STARTING first: a restart can race its probe
        # into UNHEALTHY for good; ROADMAP R31)
        self._thread = thread
        self._killed = False
        self.state = ReplicaState.STARTING
        go.set()

    @property
    def alive(self) -> bool:
        return (not self._killed and self._thread is not None
                and self._thread.is_alive())

    def send(self, cmd: dict):
        if self._killed or self._inbox is None:
            raise BrokenPipeError(f"replica {self.rid} is dead")
        self._inbox.put(cmd)

    def stop(self, graceful: bool = True, timeout: float = 10.0):
        self._stopping = True
        if self._inbox is not None:
            self._inbox.put({"op": "close" if graceful else "abort"})
        if self._thread is not None:
            self._thread.join(timeout)

    def kill(self):
        """Abrupt death: the engine is abandoned wherever it is; any token
        its final step still produces never reaches the router."""
        self._killed = True

    # -- the driver thread -------------------------------------------------
    def _emit(self, gen: int, ev: dict):
        if self._killed or gen != self._gen:
            return                        # a dead incarnation cannot speak
        self._on_event(self, ev)

    def _drive(self, gen: int, inbox: queue.Queue, go: threading.Event):
        go.wait()
        try:
            with _BUILD_LOCK:
                engine = self.engine = self.engine_factory()
            if self.warmup:
                engine.generate([self.warmup], SamplingParams(
                    max_new_tokens=2, temperature=0.0))
        except Exception as e:
            self._emit(gen, {"ev": "dead",
                             "error": f"{type(e).__name__}: {e}"})
            return
        publisher = None
        if self.fabric:
            # fleet-wide prefix directory (advisory: a dead store
            # disables the fabric, never the replica)
            from . import kv_fabric

            try:
                cfg = kv_fabric.FabricConfig(**{
                    k: self.fabric[k]
                    for k in ("lease_s", "refresh_s", "max_hashes")
                    if k in self.fabric})
                publisher = kv_fabric.DirectoryPublisher(
                    kv_fabric.connect_store(self.fabric["store"]),
                    self.rid, engine.cache, cfg=cfg,
                    counters_fn=lambda: engine.cache.prefix_stats()[
                        "fabric"])
            except Exception as e:
                telemetry.record_event("kv.fabric.publish", rid=self.rid,
                                       ok=False, disabled=True,
                                       error=f"{type(e).__name__}: {e}")
        self._emit(gen, {"ev": "hello", "pid": self.pid,
                         "proto_version": self.hello_proto})
        tracked: dict[int, object] = {}    # gid -> engine Request
        last_pub = 0.0
        closing = False
        span_wm = 0                        # request-span drain watermark

        def heartbeat():
            nonlocal span_wm
            ev = {"ev": "stats", "stats": replica_stats(engine)}
            # stream request-scoped spans with the heartbeat (NOT only at
            # terminal) so the first hop of a failover survives this
            # replica's death; filtered to THIS engine's spans — two
            # LocalReplica drivers share one process tracer
            spans, span_wm = reqtrace.drain_request_spans(
                span_wm, engine_label=engine.engine_label)
            if spans:
                ev["spans"] = spans
            self._emit(gen, ev)
            if publisher is not None and not self._killed:
                try:
                    publisher.maybe_publish()
                except Exception:  # lint: allow-silent(advisory publish; never kill the beat)
                    pass

        def on_token(gid):
            def cb(req, tok):
                self._emit(gen, {"ev": "token", "gid": gid, "tok": int(tok),
                                 "i": len(req.output_tokens) - 1})
            return cb

        while not self._killed and gen == self._gen:
            # 1) commands (non-blocking while the engine has work; short
            #    block when idle so the thread doesn't spin)
            try:
                has_work = engine.scheduler.has_work()
                cmd = inbox.get(block=not has_work, timeout=0.02)
            except queue.Empty:
                cmd = None
            if cmd is not None:
                op = cmd.get("op")
                if op in ("close", "abort"):
                    closing = True
                elif op == "add":
                    gid = cmd["gid"]
                    try:
                        req = engine.add_request(
                            cmd["prompt"],
                            sampling_from_dict(cmd.get("sampling")),
                            on_token=on_token(gid),
                            deadline_s=cmd.get("deadline_s"),
                            trace_id=cmd.get("trace_id"),
                            tenant=cmd.get("tenant") or "anonymous",
                            priority=cmd.get("priority") or 0)
                        tracked[gid] = req
                    except Exception as e:
                        self._emit(gen, {
                            "ev": "done", "gid": gid, "state": "failed",
                            "reason": "add_failed",
                            "error": f"{type(e).__name__}: {e}", "n": 0})
                elif op == "cancel":
                    req = tracked.get(cmd["gid"])
                    if req is not None:
                        engine.cancel(req.rid)
                elif op == "kv_fetch":
                    fid = cmd.get("fid")
                    try:
                        frames = engine.export_kv_frames(
                            cmd.get("hashes") or [],
                            max_frames=cmd.get("max_frames"),
                            max_bytes=cmd.get("max_bytes"))
                        self._emit(gen, {"ev": "kv_blocks", "fid": fid,
                                         "frames": frames, "error": None})
                    except Exception as e:
                        self._emit(gen, {
                            "ev": "kv_blocks", "fid": fid, "frames": [],
                            "error": f"{type(e).__name__}: {e}"})
                elif op == "kv_ingest":
                    try:
                        rep = engine.ingest_kv_frames(
                            cmd.get("frames") or [])
                    except Exception as e:  # lint: allow-silent(error is captured into the kv_ingested reply)
                        rep = {"ingested": 0, "corrupt": 0, "errors": 1,
                               "error": f"{type(e).__name__}: {e}"}
                    self._emit(gen, {"ev": "kv_ingested", **rep})
            # 2) one engine iteration
            if closing:
                break
            if engine.scheduler.has_work():
                try:
                    engine.step()
                except Exception as e:     # engine itself died
                    self._emit(gen, {"ev": "dead",
                                     "error": f"{type(e).__name__}: {e}"})
                    return
            # 3) terminal sweeps + heartbeat
            self._sweep(gen, tracked)
            now = time.monotonic()
            if now - last_pub >= self.stats_interval_s:
                last_pub = now
                heartbeat()
        if self._killed or gen != self._gen:
            return                         # abandoned, simulating SIGKILL
        engine.close()                     # graceful: terminal-ize leftovers
        self._sweep(gen, tracked)
        heartbeat()
        if publisher is not None:
            publisher.close()              # graceful: lease-zero tombstone
        self._emit(gen, {"ev": "bye"})

    def _sweep(self, gen: int, tracked: dict):
        for gid, req in list(tracked.items()):
            if req.state.is_terminal:
                del tracked[gid]
                self._emit(gen, {
                    "ev": "done", "gid": gid, "state": req.state.value,
                    "reason": req.finish_reason,
                    "error": (f"{type(req.error).__name__}: {req.error}"
                              if req.error is not None else None),
                    "n": len(req.output_tokens)})


class ProcReplica:
    """Child-process replica: spawns ``python -m
    paddle_tpu_torch.serving.replica_worker`` with a model/engine spec in its
    environment and speaks newline-JSON over its stdin/stdout. This is the
    replica a chaos suite can really SIGKILL mid-decode; the router sees
    EOF/ESRCH and fails its streams over."""

    kind = "proc"

    def __init__(self, rid: str, spec: dict, *, env: dict | None = None,
                 log_path: str | None = None):
        self.rid = str(rid)
        self.spec = dict(spec)
        self.extra_env = dict(env or {})
        self.log_path = log_path
        self.state = ReplicaState.STOPPED
        self.stats: dict = {}
        self.last_heartbeat = 0.0
        self.pid: int | None = None
        self.proto_version: int | None = None
        self.proc: subprocess.Popen | None = None
        self._on_event = None
        self._gen = 0
        self._stopping = False
        self._wlock = locksan.Lock("replica.pipe_write")

    def start(self, on_event):
        self._on_event = on_event
        self._gen += 1
        self._stopping = False
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        pythonpath = os.pathsep.join(
            p for p in (repo_root, os.environ.get("PYTHONPATH")) if p)
        env = dict(os.environ,
                   PADDLE_REPLICA_SPEC=json.dumps(self.spec),
                   PADDLE_REPLICA_RID=self.rid,
                   PYTHONPATH=pythonpath)
        env.update(self.extra_env)
        # Popen forks and at once execs a fresh interpreter, so a parent
        # whose CUDA context is live hands the child none of it (a bare
        # fork after CUDA initialisation would)
        stderr = (open(self.log_path, "ab") if self.log_path
                  else subprocess.DEVNULL)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.replica_worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr,
            env=env, text=True, bufsize=1)
        self.pid = self.proc.pid
        # STARTING only once the new child exists (R31, as LocalReplica)
        self.state = ReplicaState.STARTING
        threading.Thread(target=self._read, args=(self._gen, self.proc),
                         name=f"replica-{self.rid}-reader",
                         daemon=True).start()

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def send(self, cmd: dict):
        if not self.alive:
            raise BrokenPipeError(f"replica {self.rid} process is dead")
        line = json.dumps(cmd)
        with self._wlock:
            try:
                self.proc.stdin.write(line + "\n")
                self.proc.stdin.flush()
            except (BrokenPipeError, OSError, ValueError) as e:
                raise BrokenPipeError(
                    f"replica {self.rid}: write failed: {e}") from e

    def stop(self, graceful: bool = True, timeout: float = 15.0):
        self._stopping = True
        if self.proc is None:
            return
        if graceful and self.alive:
            try:
                self.send({"op": "close"})
            except BrokenPipeError:
                pass
        elif self.alive:                  # a wedged worker won't cooperate
            self.proc.kill()
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(5)

    def kill(self):
        """The real thing: SIGKILL, no goodbye."""
        if self.proc is not None and self.alive:
            os.kill(self.proc.pid, signal.SIGKILL)

    def _read(self, gen: int, proc: subprocess.Popen):
        for line in proc.stdout:
            if gen != self._gen:
                return
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue                  # stray stdout noise, not protocol
            if isinstance(ev, dict) and "ev" in ev:
                self._on_event(self, ev)
        # EOF: the process is gone (SIGKILL, crash, or clean exit)
        if gen == self._gen and not self._stopping:
            self._on_event(self, {"ev": "dead",
                                  "error": f"pipe EOF (pid {self.pid})"})


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def _router_metrics() -> SimpleNamespace:
    reg = telemetry.registry()
    return SimpleNamespace(
        dispatches=reg.counter(
            "router_dispatches_total",
            "request dispatches to replicas", ("replica",)),
        failovers=reg.counter(
            "router_failovers_total",
            "in-flight requests re-dispatched after replica failure"),
        retries=reg.counter(
            "router_retries_total",
            "requests re-dispatched after an engine-reported failure"),
        shed=reg.counter(
            "router_shed_total",
            "new requests rejected by the load shedder (429)"),
        affinity_hits=reg.counter(
            "router_affinity_hits_total",
            "placements that landed on the prefix-affinity replica"),
        p2c=reg.counter(
            "router_p2c_placements_total",
            "placements decided by power-of-two-choices load fallback"),
        suppressed=reg.counter(
            "router_replay_suppressed_total",
            "replayed tokens suppressed during failover"),
        mismatches=reg.counter(
            "router_replay_mismatch_total",
            "failover replays that diverged from the streamed tokens"),
        drains=reg.counter(
            "router_drains_total", "replica drains executed"),
        restarts=reg.counter(
            "router_replica_restarts_total",
            "replica restarts executed (supervisor-budgeted)"),
        deaths=reg.counter(
            "router_replica_deaths_total",
            "replicas marked UNHEALTHY (death/probe/stall)"),
        inflight=reg.gauge(
            "router_inflight_requests", "requests currently dispatched"),
        healthy=reg.gauge(
            "router_replicas_healthy", "replicas in the HEALTHY state"),
        breaker_trips=reg.counter(
            "router_breaker_trips_total",
            "circuit-breaker OPEN transitions", ("replica",)),
        breaker_probes=reg.counter(
            "router_breaker_probes_total",
            "HALF_OPEN probe dispatches", ("replica",)),
        breaker_state=reg.gauge(
            "router_breaker_state",
            "per-replica breaker state (0 closed, 1 half-open, 2 open)",
            ("replica",)),
        budget_denied=reg.counter(
            "router_retry_budget_denied_total",
            "re-dispatches refused by the global retry budget"),
        dir_hits=reg.counter(
            "router_directory_hits_total",
            "submissions whose prefix the fleet directory located"),
        dir_misses=reg.counter(
            "router_directory_misses_total",
            "submissions the directory had nothing for"),
        dir_placements=reg.counter(
            "router_directory_placements_total",
            "placements that landed on a directory-named replica"),
        dir_stale=reg.counter(
            "router_directory_stale_total",
            "directory hits that turned out stale (donor dead, fetch "
            "empty/failed) — degraded to local prefill"),
        migrations=reg.counter(
            "router_directory_migrations_total",
            "cross-replica KV-block migrations executed (fetch+ingest)"),
        migration_failures=reg.counter(
            "router_directory_migration_failures_total",
            "migrations that failed on any step (request prefilled "
            "locally instead)"),
        migrated_blocks=reg.counter(
            "router_directory_migrated_blocks_total",
            "block frames moved between replicas"),
        fetch_skipped=reg.counter(
            "router_directory_fetch_skipped_total",
            "migrations skipped by the fetch budget (storm cap)"),
        proto_refusals=reg.counter(
            "router_proto_refusals_total",
            "replica hellos refused for an incompatible pipe-protocol "
            "version"),
        actuations=reg.counter(
            "router_actuations_total",
            "fleet actuation leases granted", ("owner",)),
    )


_BREAKER_STATE_NUM = {"closed": 0, "half_open": 1, "open": 2}


class FleetRouter:
    """Placement, health, failover, shedding, and drain over N replicas.

    replicas:       :class:`LocalReplica` / :class:`ProcReplica` handles
                    (anything with their duck-typed surface works).
    probe_interval_s / probe_timeout_s: health-probe cadence and the
                    heartbeat staleness past which a replica is UNHEALTHY.
    max_inflight_per_replica: router-side admission bound per replica
                    (the bounded-admission analogue; None = only the SLO
                    shed signal gates).
    shed_bypass_priority: priority at or above which a request is admitted
                    even when every healthy replica sheds ("sheds lowest
                    priority first").
    affinity_block_size: block alignment for the prefix-affinity hash —
                    match the engines' ``block_size`` so affinity keys are
                    exactly the shareable prefixes.
    max_retries:    re-dispatches after an engine-reported failure (replica
                    deaths are always failed over and not counted here).
    supervisor:     optional supervisor (duck-typed: ``decide(...)``,
                    ``ledger``) whose restart budget/ledger governs
                    replica restarts.
    auto_restart:   restart UNHEALTHY replicas automatically (through the
                    supervisor when one is set).
    retry_after_s:  floor (and no-signal fallback) for the *derived*
                    Retry-After hint a shed carries — the actual value is
                    estimated from the fleet's SLO windows
                    (:meth:`_derive_retry_after`).
    breaker_window_s / breaker_min_samples / breaker_failure_rate /
    breaker_cooldown_s: per-replica :class:`CircuitBreaker` tuning —
                    rolling outcome window, minimum outcomes before a
                    verdict, the OPEN-tripping failure rate, and how long
                    an OPEN breaker waits before its HALF_OPEN probe.
    retry_budget_ratio / retry_budget_min / retry_budget_window_s: the
                    global re-dispatch cap — re-dispatches (failovers +
                    retries) in the window may not exceed
                    ``min + ratio * first_dispatches``.
    kv_fabric:      arm the cluster KV fabric: a dict with ``store``
                    (a store object such as ``kv_fabric.MemStore`` or a
                    ``"host:port"`` TCPStore endpoint — the same store
                    the replicas' DirectoryPublishers write) plus any
                    :class:`~.kv_fabric.FabricConfig` field
                    (``fetch_timeout_s``, ``min_match_blocks``,
                    ``max_fetches_per_window``, ...) and ``migrate``
                    (False = directory-aware placement only, no block
                    movement). None = affinity/p2c placement only.
    """

    def __init__(self, replicas, *, probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 2.0,
                 max_inflight_per_replica: int | None = None,
                 shed_bypass_priority: int = 1,
                 retry_after_s: float = 1.0,
                 max_retries: int = 1,
                 affinity_block_size: int = 16,
                 supervisor=None, auto_restart: bool = False,
                 verify_replay: bool = True, rng_seed: int = 0,
                 retain_terminal: int = 4096,
                 breaker_window_s: float = 30.0,
                 breaker_min_samples: int = 4,
                 breaker_failure_rate: float = 0.5,
                 breaker_cooldown_s: float = 2.0,
                 retry_budget_ratio: float = 0.5,
                 retry_budget_min: int = 8,
                 retry_budget_window_s: float = 30.0,
                 kv_fabric: dict | None = None):
        self.replicas: dict[str, object] = {r.rid: r for r in replicas}
        self._order = [r.rid for r in replicas]
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.max_inflight = max_inflight_per_replica
        self.shed_bypass_priority = int(shed_bypass_priority)
        self.retry_after_s = float(retry_after_s)
        self.max_retries = int(max_retries)
        self.affinity_block_size = int(affinity_block_size)
        self.supervisor = supervisor
        self.auto_restart = bool(auto_restart)
        self.verify_replay = bool(verify_replay)
        self._rng = random.Random(rng_seed)
        self._lock = locksan.RLock("router.state")
        self._gids = itertools.count()
        self._requests: dict[int, RouterRequest] = {}
        # terminal handles are kept for introspection but bounded — a
        # long-lived gateway must not grow memory per served request
        self._retain_terminal = int(retain_terminal)
        self._inflight: dict[str, set[int]] = {r: set() for r in self._order}
        self._stall_seen: dict[str, int] = {r: 0 for r in self._order}
        self._restart_at: dict[str, float] = {}
        # per-replica circuit breakers over dispatch outcomes (an alive
        # replica that fails everything it touches must stop getting
        # traffic) + the global retry budget that bounds re-dispatches
        self.breakers: dict[str, CircuitBreaker] = {
            r: CircuitBreaker(window_s=breaker_window_s,
                              min_samples=breaker_min_samples,
                              failure_rate=breaker_failure_rate,
                              cooldown_s=breaker_cooldown_s)
            for r in self._order}
        self.retry_budget_ratio = float(retry_budget_ratio)
        self.retry_budget_min = int(retry_budget_min)
        self.retry_budget_window_s = float(retry_budget_window_s)
        self._dispatch_log: list[tuple[float, bool]] = []  # (t, redispatch)
        # KV fabric (serving/kv_fabric.py): fleet-wide prefix directory +
        # cross-replica block migration. ``kv_fabric`` is a dict like
        # {"store": <store obj | "host:port">, "fetch_timeout_s": ...,
        #  "migrate": True, ...} (FabricConfig field names). Strictly
        # advisory: an unreachable store disables the fabric and the
        # router places by affinity/p2c exactly as before.
        self._fabric = None
        self._fabric_migrate = True
        if kv_fabric is not None:
            from . import kv_fabric as kvf

            try:
                cfg = kvf.FabricConfig(**{
                    k: v for k, v in kv_fabric.items()
                    if k not in ("store", "migrate")})
                self._fabric = SimpleNamespace(
                    dir=kvf.KVDirectory(kvf.connect_store(
                        kv_fabric["store"]), cfg=cfg),
                    cfg=cfg)
                self._fabric_migrate = bool(kv_fabric.get("migrate", True))
            except Exception as e:
                telemetry.record_event(
                    "router.fabric_disabled",
                    error=f"{type(e).__name__}: {e}")
        self._fetch_lock = locksan.Lock("router.pending_fetch")
        self._fetch_ids = itertools.count()
        self._fetches: dict[int, dict] = {}     # fid -> pending fetch
        self._fetch_log: list[float] = []       # migration budget window
        self._m = _router_metrics()
        # per-router counts for stats(): the registry families above are
        # process-global (shared by every router in the process), so the
        # fleet view must not read totals back from them
        self._c = {k: 0 for k in (
            "dispatches", "failovers", "retries", "shed", "affinity_hits",
            "p2c_placements", "replay_suppressed", "replay_mismatches",
            "drains", "replica_restarts", "replica_deaths",
            "breaker_trips", "breaker_probes", "retry_budget_denied",
            "directory_hits", "directory_misses", "directory_placements",
            "directory_stale", "migrations", "migration_failures",
            "migrated_blocks", "fetch_skipped", "proto_refused",
            "actuations")}
        # single-actuator arbitration: every controller-initiated replica
        # lifecycle transition (operator drain/restart, autoscaler scale,
        # remediation playbook, rolling upgrade, supervisor auto-restart)
        # serializes on ONE lease with owner attribution — two controllers
        # can never actuate the fleet at once (no dueling restarts)
        self._act_lock = locksan.RLock("router.actuation")
        self._act_depth = 0
        self._act_owner: dict | None = None
        self._act_log: list[dict] = []      # bounded recent-lease history
        self._act_seq = itertools.count(1)
        self._by_trace: dict[str, RouterRequest] = {}
        self._probe_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.closed = False

    # -- lifecycle ---------------------------------------------------------
    def start(self, wait_healthy_s: float | None = None) -> "FleetRouter":
        """Start every replica and the probe loop; optionally block until
        all replicas report a first heartbeat (or the timeout passes)."""
        for rep in self.replicas.values():
            rep.start(self._on_event)
        self._stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="router-probe", daemon=True)
        self._probe_thread.start()
        if wait_healthy_s:
            deadline = time.monotonic() + wait_healthy_s
            while time.monotonic() < deadline:
                if all(r.state is ReplicaState.HEALTHY
                       for r in self.replicas.values()):
                    break
                time.sleep(0.01)
        return self

    def close(self):
        """Stop the probe loop, cancel what's still in flight, and stop
        every replica gracefully."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(5)
        with self._lock:
            live = [rr for rr in self._requests.values() if not rr.terminal]
        for rr in live:
            self.cancel(rr.gid)
        for rep in self.replicas.values():
            if rep.state is not ReplicaState.STOPPED:
                # an UNHEALTHY replica may be wedged mid-step (that is WHY
                # it is unhealthy); don't wait politely on it
                rep.stop(graceful=rep.state is not ReplicaState.UNHEALTHY)
                rep.state = ReplicaState.STOPPED
        with self._lock:
            for rr in self._requests.values():
                if not rr.terminal:
                    rr._finish("cancelled", "router_closed", None)

    # -- submission --------------------------------------------------------
    def submit(self, prompt, sampling: SamplingParams | dict | None = None,
               *, priority: int = 0, deadline_s: float | None = None,
               on_token=None, on_finish=None,
               trace_id: str | None = None,
               on_watermark=None, watermark_every: int = 8,
               replay_tokens=None,
               bypass_shed: bool = False,
               tenant: str = "anonymous") -> RouterRequest:
        """Place and dispatch one request; returns the live
        :class:`RouterRequest`. Raises :class:`RouterShed` (shed — retry
        later) or :class:`NoHealthyReplica` (no capacity at all).
        ``trace_id`` carries the gateway's request-trace context; without
        one the router mints its own, so every routed request has exactly
        one id its spans — local and replica-side — are merged under.

        ``replay_tokens`` is the gateway crash-recovery hook: the tokens a
        previous gateway incarnation already journaled/delivered. They
        pre-seed the handle and arm the same replay-and-suppress machinery
        failover uses — the replica regenerates the stream from index 0,
        the first ``len(replay_tokens)`` are verified against the journal
        and swallowed, and ``on_token`` fires only for genuinely new
        tokens. ``bypass_shed`` admits the request even when every healthy
        replica sheds (recovery re-submissions were *already* accepted —
        shedding them now would lose them)."""
        if self.closed:
            raise NoHealthyReplica("router is closed")
        faults.inject("router.submit", priority=priority)
        if not isinstance(sampling, dict):
            sampling = sampling_to_dict(sampling)
        deadline = (time.monotonic() + float(deadline_s)
                    if deadline_s is not None else None)
        rr = RouterRequest(next(self._gids), prompt, sampling,
                           priority=priority, deadline=deadline,
                           on_token=on_token, on_finish=on_finish,
                           trace_id=trace_id, on_watermark=on_watermark,
                           watermark_every=watermark_every, tenant=tenant)
        if replay_tokens:
            rr.tokens = [int(t) for t in replay_tokens]
            rr.suppress = len(rr.tokens)
            rr._failover_t0 = time.monotonic()
        t0 = time.monotonic()
        # fleet directory consult (store I/O — before the lock): who
        # already holds this prompt's prefix chain?
        hashes, donors = self._directory_lookup(rr.prompt)
        with self._lock:
            rep = self._place(rr.prompt, rr.priority,
                              bypass_shed=bypass_shed,
                              directory_hint=donors)
            self._prune_terminal()
            self._requests[rr.gid] = rr
            self._by_trace[rr.trace_id] = rr
            plan = self._plan_migration(rep, donors, hashes)
            if plan is None:
                self._dispatch(rr, rep)
        if plan is not None:
            # pull-based KV-block migration OUTSIDE the lock (tokens and
            # heartbeats keep flowing while the donor serializes); every
            # failure mode just means the target prefills locally
            self._migrate(rr, rep, *plan)
            with self._lock:
                if not rr.terminal:
                    if rep.state is not ReplicaState.HEALTHY:
                        # the chosen replica died during the fetch: this
                        # request was already accepted — place it
                        # anywhere healthy rather than shedding it
                        try:
                            rep = self._place(rr.prompt, rr.priority,
                                              bypass_shed=True)
                        except NoHealthyReplica as e:
                            rr._finish("failed", "no_healthy_replica",
                                       str(e))
                            rep = None
                    if rep is not None and not rr.terminal:
                        self._dispatch(rr, rep)
        telemetry.tracer().emit(
            "router.submit", t0, time.monotonic(),
            attrs={"trace_id": rr.trace_id, "gid": rr.gid,
                   "replica": rr.replica, "priority": rr.priority})
        return rr

    def _prune_terminal(self):
        """Bound the request map (under the lock): oldest terminal handles
        go first; live requests are never dropped."""
        if len(self._requests) < self._retain_terminal:
            return
        for gid in list(self._requests):
            rr = self._requests[gid]
            if rr.terminal:
                del self._requests[gid]
                self._by_trace.pop(rr.trace_id, None)
                if len(self._requests) < self._retain_terminal:
                    break

    def cancel(self, gid: int) -> bool:
        """Cancel a routed request wherever it currently runs. Idempotent —
        unknown/terminal gids return False."""
        with self._lock:
            rr = self._requests.get(gid)
            if rr is None or rr.terminal:
                return False
            rr.cancel_requested = True
            rep = self.replicas.get(rr.replica)
        if rep is not None:
            try:
                rep.send({"op": "cancel", "gid": gid})
                return True
            except BrokenPipeError:
                pass
        with self._lock:
            if not rr.terminal:
                self._untrack(rr)
                rr._finish("cancelled", "cancelled", None)
        return True

    # -- KV fabric: directory + migration ----------------------------------
    def _directory_lookup(self, prompt):
        """``(chain_hashes, {rid: depth})`` from the fleet directory for
        this prompt's shareable prefix — strictly advisory (any store
        trouble returns an empty hint), consulted before the lock so
        store latency never stalls token delivery."""
        if self._fabric is None:
            return None, {}
        from . import kv_fabric as kvf

        hashes = kvf.chain_hashes(prompt, self.affinity_block_size)
        if not hashes:
            return hashes, {}
        try:
            donors = self._fabric.dir.lookup(hashes, rids=self._order)
        except Exception as e:
            telemetry.record_event("router.directory_error",
                                   error=f"{type(e).__name__}: {e}")
            return hashes, {}
        donors = {r: d for r, d in donors.items()
                  if d >= self._fabric.cfg.min_match_blocks}
        with self._lock:
            if donors:
                self._m.dir_hits.inc()
                self._c["directory_hits"] += 1
            else:
                self._m.dir_misses.inc()
                self._c["directory_misses"] += 1
        return hashes, donors

    def _fetch_budget_ok(self, now: float | None = None) -> bool:
        """Is there migration budget left in the window (under the
        lock)? Past it, requests skip migration and prefill locally — a
        hot-prefix storm must not turn into a fetch storm."""
        cfg = self._fabric.cfg
        now = time.monotonic() if now is None else now
        cutoff = now - cfg.fetch_window_s
        self._fetch_log = [t for t in self._fetch_log if t >= cutoff]
        return len(self._fetch_log) < cfg.max_fetches_per_window

    def _plan_migration(self, rep, donors, hashes):
        """Should blocks move to ``rep`` before this dispatch (under the
        lock)? Returns ``(donor_replica, chain_hashes)`` when a healthy
        sibling holds meaningfully more of the prefix than the placement
        target and the fetch budget allows — else None (plain dispatch,
        local prefill)."""
        if self._fabric is None or not self._fabric_migrate \
                or not donors or not hashes:
            return None
        have = donors.get(rep.rid, 0)
        best_rid, best_depth = None, have
        for rid, depth in donors.items():
            if rid == rep.rid:
                continue
            d = self.replicas.get(rid)
            if d is None or d.state is not ReplicaState.HEALTHY \
                    or not d.alive:
                continue
            if depth > best_depth:
                best_rid, best_depth = rid, depth
        if best_rid is None or \
                best_depth - have < self._fabric.cfg.min_match_blocks:
            return None
        if not self._fetch_budget_ok():
            self._m.fetch_skipped.inc()
            self._c["fetch_skipped"] += 1
            telemetry.record_event("router.fetch_skipped",
                                   donor=best_rid, target=rep.rid)
            return None
        self._fetch_log.append(time.monotonic())   # reserve budget now
        return (self.replicas[best_rid], hashes[:best_depth])

    def _migrate(self, rr: RouterRequest, target, donor, hashes) -> bool:
        """One pull-based migration (NOT under the router lock): fetch
        serialized block frames from the donor through the pipe protocol,
        land them on the target for CRC-verified promotion. Timeout, dead
        donor, empty answer, or a failed ingest send all degrade to local
        prefill on the target — counted, never raised."""
        cfg = self._fabric.cfg
        t0 = time.monotonic()
        fid = next(self._fetch_ids)
        pend = {"ev": threading.Event(), "frames": None, "error": None,
                "rid": donor.rid}
        with self._fetch_lock:
            self._fetches[fid] = pend
        frames = None
        try:
            donor.send({"op": "kv_fetch", "fid": fid,
                        "hashes": list(hashes),
                        "max_frames": cfg.max_fetch_frames,
                        "max_bytes": cfg.max_fetch_bytes})
            if pend["ev"].wait(cfg.fetch_timeout_s) and not pend["error"]:
                frames = pend["frames"]
        except BrokenPipeError as e:
            pend["error"] = str(e)
        finally:
            with self._fetch_lock:
                self._fetches.pop(fid, None)
        ok = False
        if frames:
            try:
                target.send({"op": "kv_ingest", "frames": frames})
                ok = True
            except BrokenPipeError as e:
                pend["error"] = str(e)
        with self._lock:
            if ok:
                self._m.migrations.inc()
                self._c["migrations"] += 1
                self._m.migrated_blocks.inc(len(frames))
                self._c["migrated_blocks"] += len(frames)
            else:
                self._m.migration_failures.inc()
                self._c["migration_failures"] += 1
                if not frames:
                    # the directory promised, the donor declined (dead,
                    # evicted since publishing, faulted): a stale entry
                    self._m.dir_stale.inc()
                    self._c["directory_stale"] += 1
        telemetry.record_event(
            "router.migration", gid=rr.gid, donor=donor.rid,
            target=target.rid, ok=ok,
            frames=len(frames) if frames else 0, error=pend["error"])
        telemetry.tracer().emit(
            "router.kv_migration", t0, time.monotonic(),
            attrs={"trace_id": rr.trace_id, "gid": rr.gid,
                   "donor": donor.rid, "target": target.rid, "ok": ok,
                   "frames": len(frames) if frames else 0})
        return ok

    # -- placement ---------------------------------------------------------
    def _load(self, rid: str) -> int:
        return len(self._inflight.get(rid, ()))

    def _is_shedding(self, rep) -> bool:
        if self.max_inflight is not None and \
                self._load(rep.rid) >= self.max_inflight:
            return True
        slo = (rep.stats or {}).get("slo") or {}
        return bool(slo.get("shed"))

    def _derive_retry_after(self, healthy) -> float:
        """An honest Retry-After for the 429: Little's law over the SLO
        windows the healthy replicas heartbeat — work ahead (dispatched +
        replica-queued) divided by the fleet's observed completion rate —
        falling back to observed TPOT when the window has no completions
        yet, and to the configured ``retry_after_s`` floor when the fleet
        has no signal at all. Clamped to [retry_after_s, 60s]."""
        rate = 0.0
        queued = 0
        tpots = []
        for rep in healthy:
            slo = (rep.stats or {}).get("slo") or {}
            n = slo.get("window_requests") or 0
            w = slo.get("window_s") or 0.0
            if n and w:
                rate += n / float(w)
            tp = (slo.get("tpot") or {}).get("p50")
            if tp:
                tpots.append(float(tp))
            queued += int((rep.stats or {}).get("queue_depth") or 0)
        ahead = sum(len(s) for s in self._inflight.values()) + queued
        if rate > 0:
            est = (ahead + 1) / rate
        elif tpots:
            est = (ahead + 1) * (sum(tpots) / len(tpots))
        else:
            est = self.retry_after_s
        return float(min(max(est, self.retry_after_s), 60.0))

    # -- circuit breakers / retry budget -----------------------------------
    def _breaker_record(self, rid: str, ok: bool):
        """One dispatch outcome lands on the replica's breaker (under the
        lock); an OPEN transition is counted and the state gauge synced."""
        br = self.breakers.get(rid)
        if br is None:
            return
        trips_before = br.trips
        br.record(ok)
        if br.trips > trips_before:
            self._m.breaker_trips.labels(replica=rid).inc()
            self._c["breaker_trips"] += 1
            telemetry.record_event("router.breaker_open", replica=rid,
                                   trips=br.trips)
        self._m.breaker_state.labels(replica=rid).set(
            _BREAKER_STATE_NUM[br.state])

    def _budget_ok(self, now: float | None = None) -> bool:
        """Is there retry budget left (under the lock)? Re-dispatches in
        the window are capped at ``retry_budget_min + retry_budget_ratio *
        first_dispatches`` — a sick fleet fast-fails instead of feeding a
        retry storm."""
        now = time.monotonic() if now is None else now
        cutoff = now - self.retry_budget_window_s
        self._dispatch_log = [e for e in self._dispatch_log
                              if e[0] >= cutoff]
        first = sum(1 for _, re in self._dispatch_log if not re)
        redisp = sum(1 for _, re in self._dispatch_log if re)
        return redisp < self.retry_budget_min + \
            self.retry_budget_ratio * first

    def _budget_deny(self, rr: "RouterRequest", origin: str):
        """Finish a request the retry budget refused to re-dispatch."""
        self._m.budget_denied.inc()
        self._c["retry_budget_denied"] += 1
        telemetry.record_event("router.retry_budget_denied", gid=rr.gid,
                               origin=origin)
        rr._finish("failed", "retry_budget_exhausted",
                   f"retry budget exhausted (origin: {origin}; "
                   f"window {self.retry_budget_window_s:.0f}s)")

    def _affinity_key(self, prompt) -> int | None:
        bs = self.affinity_block_size
        nb = max(0, (len(prompt) - 1) // bs)   # full, shareable blocks only
        if nb == 0:
            return None
        h = hashlib.sha1(
            b"|".join(str(int(t)).encode() for t in prompt[:nb * bs]))
        return int.from_bytes(h.digest()[:8], "big")

    def _place(self, prompt, priority: int, exclude=(),
               bypass_shed: bool = False, directory_hint=None):
        """Pick a replica (under the lock); a HALF_OPEN pick is marked as
        that breaker's probe — its outcome decides the breaker's fate."""
        rep = self._pick(prompt, priority, exclude=exclude,
                         bypass_shed=bypass_shed,
                         directory_hint=directory_hint)
        br = self.breakers.get(rep.rid)
        if br is not None and br.state == "half_open":
            br.note_probe()
            self._m.breaker_probes.labels(replica=rep.rid).inc()
            self._c["breaker_probes"] += 1
            telemetry.record_event("router.breaker_probe", replica=rep.rid)
        return rep

    def _pick(self, prompt, priority: int, exclude=(),
              bypass_shed: bool = False, directory_hint=None):
        """The placement decision. Called under the lock."""
        alive = [self.replicas[r] for r in self._order
                 if self.replicas[r].state is ReplicaState.HEALTHY
                 and r not in exclude]
        if not alive:
            raise NoHealthyReplica(
                f"no healthy replica "
                f"({ {r: self.replicas[r].state.value for r in self._order} })")
        # circuit breakers: an alive replica that fails everything it is
        # handed is OPEN and skipped; a cooled-down one admits one
        # HALF_OPEN probe. All breakers open => fast-fail, not a storm.
        healthy = [r for r in alive if self.breakers[r.rid].allow()]
        if not healthy:
            states = {r.rid: self.breakers[r.rid].state for r in alive}
            raise NoHealthyReplica(
                f"all {len(alive)} alive replicas have open circuit "
                f"breakers ({states})")
        eligible = [r for r in healthy if not self._is_shedding(r)]
        if not eligible:
            if bypass_shed or priority >= self.shed_bypass_priority:
                eligible = healthy      # in-flight / high-priority: admit
            else:
                self._m.shed.inc()
                self._c["shed"] += 1
                telemetry.record_event("router.shed", priority=priority,
                                       healthy=len(healthy))
                retry_after = self._derive_retry_after(healthy)
                raise RouterShed(
                    f"all {len(healthy)} healthy replicas are shedding "
                    f"(priority {priority} < bypass "
                    f"{self.shed_bypass_priority}); retry after "
                    f"{retry_after:.1f}s",
                    retry_after_s=retry_after)
        # fleet directory first (advisory): place where the prefix
        # *actually* lives — deepest advertised chain wins, ties broken
        # by load, and the same +2 load slack as affinity so a hot
        # prefix overflows to siblings (who then migrate it) instead of
        # dogpiling its first host
        if directory_hint:
            cand = [r for r in eligible if r.rid in directory_hint]
            if cand:
                min_load = min(self._load(r.rid) for r in eligible)
                best = max(cand, key=lambda r: (directory_hint[r.rid],
                                                -self._load(r.rid)))
                if self._load(best.rid) <= min_load + 2:
                    self._m.dir_placements.inc()
                    self._c["directory_placements"] += 1
                    return best
        # prefix affinity: a stable hash over the block-aligned prefix
        # names the preferred replica so shared prefixes keep hitting the
        # same engine's prefix cache
        key = self._affinity_key(prompt)
        if key is not None:
            preferred = self.replicas[self._order[key % len(self._order)]]
            min_load = min(self._load(r.rid) for r in eligible)
            if preferred in eligible and \
                    self._load(preferred.rid) <= min_load + 2:
                self._m.affinity_hits.inc()
                self._c["affinity_hits"] += 1
                return preferred
        # power-of-two-choices on load ("why did this replica get the
        # request": every non-affinity placement counts as p2c, so the
        # gateway /stats affinity-vs-p2c split covers all placements)
        self._m.p2c.inc()
        self._c["p2c_placements"] += 1
        if len(eligible) == 1:
            return eligible[0]
        a, b = self._rng.sample(eligible, 2)
        return a if self._load(a.rid) <= self._load(b.rid) else b

    def _dispatch(self, rr: RouterRequest, rep, *, exclude=None):
        """Send the request to ``rep`` (under the lock). A failed send (or
        an injected ``router.dispatch`` fault) falls through to the next
        candidate; with none left the request fails."""
        exclude = set(exclude or ())
        t0 = time.monotonic()
        while True:
            try:
                faults.inject("router.dispatch", replica=rep.rid,
                              gid=rr.gid)
                deadline_s = (rr.deadline - time.monotonic()
                              if rr.deadline is not None else None)
                rep.send({"op": "add", "gid": rr.gid, "prompt": rr.prompt,
                          "sampling": rr.sampling, "deadline_s": deadline_s,
                          "trace_id": rr.trace_id, "tenant": rr.tenant,
                          "priority": rr.priority})
            except (BrokenPipeError, faults.FaultError) as e:
                self._breaker_record(rep.rid, ok=False)
                exclude.add(rep.rid)
                try:
                    rep2 = self._place(rr.prompt, rr.priority,
                                       exclude=exclude, bypass_shed=True)
                except NoHealthyReplica:
                    self._untrack(rr)
                    rr._finish("failed", "dispatch_failed",
                               f"{type(e).__name__}: {e}")
                    return
                rep = rep2
                continue
            break
        rr.replica = rep.rid
        rr.state = "running"
        rr.dispatches += 1
        self._dispatch_log.append((time.monotonic(), rr.dispatches > 1))
        self._close_hop(rr)
        rr.hop_log.append({"replica": rep.rid, "t0": time.monotonic(),
                           "t1": None, "suppress": rr.suppress})
        self._inflight.setdefault(rep.rid, set()).add(rr.gid)
        self._m.dispatches.labels(replica=rep.rid).inc()
        self._c["dispatches"] += 1
        self._m.inflight.set(sum(len(s) for s in self._inflight.values()))
        telemetry.record_event("router.dispatch", gid=rr.gid,
                               replica=rep.rid, attempt=rr.dispatches,
                               suppress=rr.suppress)
        telemetry.tracer().emit(
            "router.dispatch", t0, time.monotonic(),
            attrs={"trace_id": rr.trace_id, "gid": rr.gid,
                   "replica": rep.rid, "attempt": rr.dispatches,
                   "suppress": rr.suppress})

    def _close_hop(self, rr: RouterRequest):
        if rr.hop_log and rr.hop_log[-1]["t1"] is None:
            rr.hop_log[-1]["t1"] = time.monotonic()

    def _untrack(self, rr: RouterRequest):
        if rr.replica is not None:
            self._inflight.get(rr.replica, set()).discard(rr.gid)
        self._m.inflight.set(sum(len(s) for s in self._inflight.values()))

    # -- replica events ----------------------------------------------------
    def _on_event(self, rep, ev: dict):
        kind = ev.get("ev")
        if kind == "token":
            self._on_token(rep, ev["gid"], ev["tok"], ev["i"])
        elif kind == "done":
            self._on_done(rep, ev)
        elif kind == "stats":
            self._on_stats(rep, ev.get("stats") or {})
            if ev.get("spans"):
                self._absorb_spans(rep, ev["spans"])
        elif kind == "kv_blocks":
            # a pending migration fetch's answer (only the fetch-table
            # lock: a submit waiting on this may hold nothing, and token
            # events must never queue behind frame payloads)
            with self._fetch_lock:
                pend = self._fetches.get(ev.get("fid"))
            if pend is not None:
                pend["frames"] = ev.get("frames") or []
                pend["error"] = ev.get("error")
                pend["ev"].set()
        elif kind == "kv_ingested":
            telemetry.record_event(
                "router.kv_ingested", replica=rep.rid,
                ingested=ev.get("ingested"), corrupt=ev.get("corrupt"),
                errors=ev.get("errors"))
        elif kind == "hello":
            pv = int(ev.get("proto_version") or 0)
            rep.proto_version = pv
            if pv not in PROTO_COMPAT:
                self._refuse_proto(rep, pv)
                return
            rep.pid = ev.get("pid", rep.pid)
            rep.last_heartbeat = time.monotonic()
        elif kind == "dead":
            self._mark_unhealthy(rep, ev.get("error") or "process death")

    def _on_stats(self, rep, stats: dict):
        rep.stats = stats
        rep.last_heartbeat = time.monotonic()
        with self._lock:
            if rep.state is ReplicaState.STARTING:
                rep.state = ReplicaState.HEALTHY
                self._sync_health_gauge()
            # an engine stall-detector trip is a health event: the replica
            # is failing requests it cannot serve
            stalls = int(stats.get("stalls") or 0)
            if stalls > self._stall_seen.get(rep.rid, 0):
                self._stall_seen[rep.rid] = stalls
                if rep.state in (ReplicaState.HEALTHY, ReplicaState.DRAINING):
                    unhealthy = True
                else:
                    unhealthy = False
            else:
                unhealthy = False
        if unhealthy:
            self._mark_unhealthy(rep, "engine stall-detector trip")

    def _absorb_spans(self, rep, wire_spans):
        """Replica-side request spans (streamed in heartbeats) land on the
        owning RouterRequest, labeled with the replica they ran on. Spans
        are bounded per request — a runaway replica cannot grow router
        memory through its heartbeats."""
        with self._lock:
            for s in wire_spans:
                if not isinstance(s, dict):
                    continue
                for tid in reqtrace.wire_trace_ids(s):
                    rr = self._by_trace.get(tid)
                    if rr is None or len(rr.remote_spans) >= 1024:
                        continue
                    rr.remote_spans.append({**s, "replica": rep.rid})

    def _on_token(self, rep, gid: int, tok: int, i: int):
        cb = None
        with self._lock:
            rr = self._requests.get(gid)
            if rr is None or rr.terminal or rr.replica != rep.rid:
                return                      # stale incarnation / other owner
            if i < rr.suppress:
                # replay of an already-streamed token: verify + swallow
                self._m.suppressed.inc()
                self._c["replay_suppressed"] += 1
                if self.verify_replay and rr.tokens[i] != tok:
                    self._m.mismatches.inc()
                    self._c["replay_mismatches"] += 1
                    self._untrack(rr)
                    rr._finish(
                        "failed", "replay_mismatch",
                        f"ReplayMismatch: token {i} replayed as {tok}, "
                        f"client already saw {rr.tokens[i]}")
                    return
                if i == rr.suppress - 1 and rr._failover_t0 is not None:
                    # the whole replay verified: annotate the suppressed
                    # window on the request trace
                    telemetry.tracer().emit(
                        "router.replay_suppressed", rr._failover_t0,
                        time.monotonic(),
                        attrs={"trace_id": rr.trace_id, "gid": gid,
                               "replica": rep.rid, "tokens": rr.suppress})
                    rr._failover_t0 = None
                return
            if i != len(rr.tokens):
                return                      # duplicate/out-of-order: drop
            rr.tokens.append(int(tok))
            if rr.first_token_time is None:
                rr.first_token_time = time.monotonic()
            cb = rr.on_token
            wm_cb = None
            n = len(rr.tokens)
            if rr.on_watermark is not None and \
                    n % rr.watermark_every == 0:
                wm_cb = rr.on_watermark
        if cb is not None:
            cb(rr, int(tok))
        if wm_cb is not None:
            wm_cb(rr, n)

    def _on_done(self, rep, ev: dict):
        gid = ev["gid"]
        state, reason = ev.get("state"), ev.get("reason")
        error = ev.get("error")
        with self._lock:
            rr = self._requests.get(gid)
            if rr is None or rr.terminal or rr.replica != rep.rid:
                return
            self._untrack(rr)
            self._close_hop(rr)
            if state == "finished":
                self._breaker_record(rep.rid, ok=True)
                rr._finish("finished", reason or "stop", None)
                return
            if state == "cancelled":
                if rr.cancel_requested or reason == "deadline":
                    rr._finish("cancelled", reason, error)
                    return
                # engine-side cancel the client never asked for (replica
                # shutting down under us): treat as retryable failure
                state, error = "failed", error or "cancelled by replica"
            # state == "failed": retry on another replica unless the error
            # is a deterministic property of the request itself
            retryable = not (error or "").startswith(_NON_RETRYABLE)
            if retryable:
                # a request-shaped failure (bad params) says nothing about
                # the replica; everything else is a replica outcome
                self._breaker_record(rep.rid, ok=False)
            if retryable and rr.retries < self.max_retries:
                if not self._budget_ok():
                    self._budget_deny(rr, f"retry after: {error}")
                    return
                t0 = time.monotonic()
                rr.retries += 1
                self._m.retries.inc()
                self._c["retries"] += 1
                rr.suppress = len(rr.tokens)
                rr._failover_t0 = t0
                try:
                    rep2 = self._place(rr.prompt, rr.priority,
                                       exclude={rep.rid}, bypass_shed=True)
                except NoHealthyReplica:
                    rr._finish("failed", reason, error)
                    return
                telemetry.record_event("router.retry", gid=gid,
                                       from_replica=rep.rid,
                                       to_replica=rep2.rid, error=error)
                self._dispatch(rr, rep2, exclude={rep.rid})
                telemetry.tracer().emit(
                    "router.retry", t0, time.monotonic(),
                    attrs={"trace_id": rr.trace_id, "gid": gid,
                           "from_replica": rep.rid, "to_replica": rr.replica,
                           "error": error})
                return
            rr._finish("failed", reason, error)

    # -- health ------------------------------------------------------------
    def _refuse_proto(self, rep, pv: int):
        """An incompatible hello: the replica is refused — stopped, its
        scheduled restarts cancelled — rather than admitted into the fleet
        speaking a wire format the router cannot parse. Deliberately NOT a
        death: auto-restart would bring the same binary back in a loop."""
        with self._lock:
            self._c["proto_refused"] += 1
            self._m.proto_refusals.inc()
            self._restart_at.pop(rep.rid, None)
            rep.state = ReplicaState.STOPPED
            self._sync_health_gauge()
        telemetry.record_event(
            "router.proto_refused", replica=rep.rid, proto_version=pv,
            supported=sorted(PROTO_COMPAT))
        try:
            rep.stop(graceful=False, timeout=2.0)
        except RuntimeError:
            # a LocalReplica's hello arrives on its own driver thread,
            # which cannot join itself — abrupt kill instead
            rep.kill()

    def _sync_health_gauge(self):
        self._m.healthy.set(sum(
            1 for r in self.replicas.values()
            if r.state is ReplicaState.HEALTHY))

    def _mark_unhealthy(self, rep, reason: str):
        with self._lock:
            if rep.state in (ReplicaState.UNHEALTHY, ReplicaState.STOPPED):
                return
            rep.state = ReplicaState.UNHEALTHY
            self._m.deaths.inc()
            self._c["replica_deaths"] += 1
            self._sync_health_gauge()
            # fail pending KV fetches against this replica so a
            # migrating submit does not sit out its full timeout on a
            # donor that just died mid-fetch
            with self._fetch_lock:
                for pend in self._fetches.values():
                    if pend["rid"] == rep.rid and not pend["ev"].is_set():
                        pend["error"] = (f"donor {rep.rid} unhealthy: "
                                         f"{reason}")
                        pend["ev"].set()
            orphans = [rr for rr in
                       (self._requests.get(g) for g in
                        sorted(self._inflight.get(rep.rid, set())))
                       if rr is not None and not rr.terminal]
            self._inflight[rep.rid] = set()
            telemetry.record_event("router.replica_unhealthy",
                                   replica=rep.rid, reason=reason,
                                   orphans=len(orphans))
            for rr in orphans:
                self._failover(rr, exclude={rep.rid})
            if self.auto_restart:
                self._schedule_restart(rep, reason)

    def _failover(self, rr: RouterRequest, exclude):
        """Re-dispatch an orphaned in-flight request (under the lock):
        original prompt + sampling, already-streamed tokens replayed and
        suppressed. Never shed — this stream is already in flight."""
        t0 = time.monotonic()
        from_replica = rr.replica
        if not self._budget_ok():
            self._close_hop(rr)
            self._budget_deny(rr, f"failover from {from_replica}")
            return
        rr.failovers += 1
        rr.suppress = len(rr.tokens)
        rr._failover_t0 = t0
        self._close_hop(rr)
        self._m.failovers.inc()
        self._c["failovers"] += 1
        try:
            rep = self._place(rr.prompt, rr.priority, exclude=exclude,
                              bypass_shed=True)
        except NoHealthyReplica as e:
            rr._finish("failed", "no_healthy_replica", str(e))
            return
        telemetry.record_event("router.failover", gid=rr.gid,
                               to_replica=rep.rid, suppress=rr.suppress)
        self._dispatch(rr, rep, exclude=exclude)
        # the span that joins the two replica rows in the merged request
        # trace: dead hop -> new hop, replayed-token count annotated
        telemetry.tracer().emit(
            "router.failover", t0, time.monotonic(),
            attrs={"trace_id": rr.trace_id, "gid": rr.gid,
                   "from_replica": from_replica, "to_replica": rr.replica,
                   "replay_suppressed": rr.suppress,
                   "failover": rr.failovers})

    def _schedule_restart(self, rep, reason: str):
        """Supervisor-budgeted restart decision (called under the lock)."""
        backoff = 0.0
        if self.supervisor is not None:
            decision = self.supervisor.decide(
                rc=1, n_failed=1, interrupted=False,
                world_size=len(self.replicas), dead_ranks=[rep.rid])
            if decision["action"] != "restart":
                rep.state = ReplicaState.STOPPED
                telemetry.record_event("router.replica_abandoned",
                                       replica=rep.rid,
                                       reason=decision["reason"])
                return
            backoff = decision["backoff_s"]
        self._restart_at[rep.rid] = time.monotonic() + backoff

    def _probe_loop(self):
        while not self._stop.wait(self.probe_interval_s):
            now = time.monotonic()
            for rid in self._order:
                rep = self.replicas[rid]
                try:
                    faults.inject("router.probe", replica=rid)
                except faults.FaultError as e:
                    self._mark_unhealthy(rep, f"probe fault: {e}")
                    continue
                if rep.state in (ReplicaState.HEALTHY, ReplicaState.DRAINING,
                                 ReplicaState.STARTING):
                    if not rep.alive:
                        self._mark_unhealthy(rep, "process death")
                    elif (rep.state is not ReplicaState.STARTING
                          and rep.last_heartbeat
                          and now - rep.last_heartbeat
                          > self.probe_timeout_s):
                        # liveness, not readiness: a STARTING replica is
                        # allowed its compile warmup; timeouts only count
                        # once it has reported ready
                        self._mark_unhealthy(
                            rep, f"probe timeout "
                                 f"({now - rep.last_heartbeat:.2f}s since "
                                 f"last heartbeat)")
                # due restarts — through the actuation lease (bounded
                # wait: a busy lease means another controller is mid-
                # transition; the restart stays due and retries next tick
                # rather than stalling health probing behind a drain)
                due = self._restart_at.get(rid)
                if due is not None and now >= due and \
                        rep.state in (ReplicaState.UNHEALTHY,
                                      ReplicaState.STOPPED):
                    try:
                        with self.actuation("supervisor", "auto_restart",
                                            rid, wait_s=0.05):
                            if self._restart_at.pop(rid, None) is not None \
                                    and rep.state in (
                                        ReplicaState.UNHEALTHY,
                                        ReplicaState.STOPPED):
                                self._do_restart(rep)
                    except ActuationBusy:
                        pass

    def _do_restart(self, rep):
        try:
            rep.stop(graceful=False, timeout=2.0)
        except Exception:  # lint: allow-silent(force-restart; the old proc may already be dead)
            pass
        rep.stats = {}
        rep.last_heartbeat = 0.0
        with self._lock:
            self._stall_seen[rep.rid] = 0
            # a restart is a fresh start: the old incarnation's failure
            # history must not keep the new one fenced off
            br = self.breakers.get(rep.rid)
            if br is not None:
                br.state = "closed"
                br._events.clear()
                br._probe_inflight = False
                self._m.breaker_state.labels(replica=rep.rid).set(0)
        rep.start(self._on_event)
        self._m.restarts.inc()
        self._c["replica_restarts"] += 1
        telemetry.record_event("router.replica_restart", replica=rep.rid)

    # -- single-actuator arbitration ---------------------------------------
    @contextlib.contextmanager
    def actuation(self, owner: str, action: str = "",
                  target: str | None = None, wait_s: float | None = None):
        """The fleet actuation lease: ONE controller actuates replica
        lifecycle at a time. Re-entrant per thread (a controller holding
        the lease may call :meth:`drain`/:meth:`restart`, which re-acquire
        it); attribution (owner/action/target) is pinned by the outermost
        acquire and surfaced in :meth:`stats`. ``wait_s=None`` blocks;
        a bounded wait that expires raises :class:`ActuationBusy` with the
        current holder so the loser can log who it yielded to."""
        got = self._act_lock.acquire(
            timeout=(-1 if wait_s is None else float(wait_s)))
        if not got:
            holder = dict(self._act_owner or {})
            raise ActuationBusy(
                f"actuation lease held by "
                f"{holder.get('owner', '?')}:{holder.get('action', '?')}"
                f" (target {holder.get('target')})", holder)
        outermost = self._act_depth == 0
        self._act_depth += 1
        if outermost:
            self._act_owner = {
                "seq": next(self._act_seq), "owner": str(owner),
                "action": str(action), "target": target,
                "since": time.monotonic()}
            self._c["actuations"] += 1
            self._m.actuations.labels(owner=str(owner)).inc()
        # lifecycle transitions block by design while leased: a drain
        # waits out in-flight work, a restart waits on a child process
        blocker = locksan.allow_blocking(
            "actuation lease: replica lifecycle transitions (drain waits, "
            "process restarts) block by design while serialized")
        blocker.__enter__()
        try:
            yield dict(self._act_owner)
        finally:
            blocker.__exit__(None, None, None)
            self._act_depth -= 1
            if self._act_depth == 0:
                ent = self._act_owner or {}
                self._act_owner = None
                self._act_log.append({
                    k: ent.get(k) for k in
                    ("seq", "owner", "action", "target")} | {
                    "held_s": round(
                        time.monotonic() - ent.get("since", 0.0), 4)})
                del self._act_log[:-16]
            self._act_lock.release()

    def actuation_stats(self) -> dict:
        """Current lease holder + recent lease history (owner attribution
        for every controller-initiated lifecycle transition)."""
        cur = self._act_owner
        if cur is not None:
            cur = {k: cur.get(k) for k in
                   ("seq", "owner", "action", "target")} | {
                   "held_s": round(
                       time.monotonic() - cur.get("since", 0.0), 4)}
        return {"owner": cur, "recent": list(self._act_log)}

    # -- drain / restart (operator surface) --------------------------------
    def drain(self, rid: str, budget_s: float = 30.0,
              stop_replica: bool = True, owner: str = "operator") -> dict:
        """Stop placement to a replica, wait for its in-flight work up to
        ``budget_s``, fail over whatever is left, and (by default) stop it.
        An in-flight stream is never lost to a drain."""
        with self.actuation(owner, "drain", rid):
            return self._drain_leased(rid, budget_s, stop_replica)

    def _drain_leased(self, rid: str, budget_s: float,
                      stop_replica: bool) -> dict:
        rep = self.replicas[rid]
        with self._lock:
            if rep.state is not ReplicaState.HEALTHY:
                return {"replica": rid, "drained": False,
                        "state": rep.state.value,
                        "reason": "not in a drainable state"}
            rep.state = ReplicaState.DRAINING
        self._m.drains.inc()
        self._c["drains"] += 1
        telemetry.record_event("router.drain", replica=rid,
                               inflight=self._load(rid))
        deadline = time.monotonic() + float(budget_s)
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight.get(rid):
                    break
            time.sleep(0.01)
        with self._lock:
            leftovers = [rr for rr in
                         (self._requests.get(g) for g in
                          sorted(self._inflight.get(rid, set())))
                         if rr is not None and not rr.terminal]
            self._inflight[rid] = set()
            for rr in leftovers:
                self._failover(rr, exclude={rid})
            completed_in_budget = not leftovers
            if stop_replica:
                rep.state = ReplicaState.STOPPED
            else:
                rep.state = ReplicaState.HEALTHY
            self._sync_health_gauge()
        if stop_replica:
            rep.stop(graceful=True)
        if self.supervisor is not None and self.supervisor.ledger is not None:
            self.supervisor.ledger.record(
                "replica_drain", replica=rid,
                completed_in_budget=completed_in_budget,
                failed_over=len(leftovers))
        return {"replica": rid, "drained": True,
                "completed_in_budget": completed_in_budget,
                "failed_over": len(leftovers)}

    def restart(self, rid: str, owner: str = "operator") -> None:
        """Bring a STOPPED/UNHEALTHY replica back (clean restarts — e.g.
        after an operator drain — do not consume the supervisor's restart
        budget; failure-driven restarts go through ``auto_restart``)."""
        with self.actuation(owner, "restart", rid):
            rep = self.replicas[rid]
            if rep.state not in (ReplicaState.STOPPED,
                                 ReplicaState.UNHEALTHY):
                raise RuntimeError(
                    f"replica {rid} is {rep.state.value}; "
                    f"drain/stop it first")
            if self.supervisor is not None and \
                    self.supervisor.ledger is not None:
                self.supervisor.ledger.record("replica_restart", replica=rid)
            self._do_restart(rep)

    def drain_and_restart(self, rid: str, budget_s: float = 30.0,
                          owner: str = "operator") -> dict:
        """The rolling-restart primitive: drain, stop, start again —
        under ONE actuation lease, so no other controller can slip a
        transition between the stop and the start."""
        with self.actuation(owner, "drain_and_restart", rid):
            report = self._drain_leased(rid, budget_s, stop_replica=True)
            if report.get("drained"):
                self.restart(rid, owner=owner)
            return report

    # -- request tracing ---------------------------------------------------
    def find_request(self, key) -> RouterRequest | None:
        """Resolve a request by gid (int), trace id, or the gateway's
        completion id (``cmpl-<gid>`` / ``chatcmpl-<gid>``)."""
        with self._lock:
            if isinstance(key, str):
                rr = self._by_trace.get(key)
                if rr is not None:
                    return rr
                if key.startswith(("cmpl-", "chatcmpl-")):
                    key = key.rsplit("-", 1)[1]
                try:
                    key = int(key)
                except ValueError:
                    return None
            return self._requests.get(key)

    def request_trace(self, key, out_path: str | None = None) -> dict:
        """ONE merged Chrome trace for one request, spanning
        gateway/router -> every replica hop (failover included), with
        clock-corrected timestamps (``telemetry.reqtrace``). Rows: the
        router's own process (gateway + router spans) plus one per replica
        that served the request; a hop whose replica died before its spans
        could heartbeat out still gets a synthesized ``replica.hop`` span
        from the router's dispatch ledger. Raises ``KeyError`` for an
        unknown request (gateway: 404)."""
        rr = self.find_request(key)
        if rr is None:
            raise KeyError(f"no routed request {key!r}")
        with self._lock:
            remote = list(rr.remote_spans)
            hops = [dict(h) for h in rr.hop_log]
        # local spans: what this process (gateway + router) recorded
        local = [reqtrace.span_to_wire(s) for s in telemetry.tracer().spans()
                 if s.attrs.get("trace_id") == rr.trace_id
                 and not s.attrs.get("engine")]
        sources: dict[str, list] = {"gateway": local}
        for s in remote:
            sources.setdefault(s.get("replica", "?"), []).append(s)
        now_mono = time.monotonic()
        for h in hops:
            rid = h["replica"]
            if sources.get(rid):
                continue
            # replica died (or never heartbeat) before its spans shipped:
            # synthesize the hop window so the row still exists
            t1 = h["t1"] if h["t1"] is not None else now_mono
            sources[rid] = [{
                "name": "replica.hop",
                "t0_unix": telemetry.mono_to_unix(h["t0"]),
                "t1_unix": telemetry.mono_to_unix(t1),
                "span_id": None, "parent_id": None,
                "attrs": {"trace_id": rr.trace_id, "replica": rid,
                          "suppress": h.get("suppress", 0),
                          "synthesized": True},
            }]
        return reqtrace.merge_request_trace(
            rr.trace_id, sources, out_path=out_path,
            meta={"gid": rr.gid, "state": rr.state,
                  "finish_reason": rr.finish_reason,
                  "replicas": [h["replica"] for h in hops],
                  "failovers": rr.failovers, "retries": rr.retries,
                  "replay_suppressed": rr.suppress,
                  "tokens": len(rr.tokens)})

    # -- introspection -----------------------------------------------------
    def load_signal(self) -> dict:
        """The demand snapshot the :class:`~.autoscaler.Autoscaler` ticks
        on: replica rids by state, dispatched + replica-queued work, and
        the same Little's-law wait estimate the 429 Retry-After carries
        (``inf`` with no healthy replica — an unserved queue is an
        infinite wait)."""
        with self._lock:
            by_state: dict[str, list[str]] = {
                "healthy": [], "starting": [], "draining": [],
                "unhealthy": [], "stopped": []}
            queued = 0
            for rid in self._order:
                rep = self.replicas[rid]
                by_state[rep.state.value].append(rid)
                if rep.state is ReplicaState.HEALTHY:
                    queued += int((rep.stats or {}).get("queue_depth") or 0)
            healthy_reps = [self.replicas[r] for r in by_state["healthy"]]
            inflight_by_rid = {r: len(s)
                               for r, s in self._inflight.items() if s}
            est = (self._derive_retry_after(healthy_reps)
                   if healthy_reps else float("inf"))
            return {
                **by_state,
                "inflight": sum(inflight_by_rid.values()),
                "inflight_by_rid": inflight_by_rid,
                "queued": queued,
                "est_wait_s": est,
            }

    def stats(self) -> dict:
        """The fleet view a gateway /stats endpoint serves: per-replica
        state + heartbeat age + SLO block + in-flight, and router totals."""
        with self._lock:
            now = time.monotonic()
            reps = {}
            for rid in self._order:
                rep = self.replicas[rid]
                br = self.breakers.get(rid)
                reps[rid] = {
                    "kind": rep.kind,
                    "state": rep.state.value,
                    "pid": rep.pid,
                    "proto_version": getattr(rep, "proto_version", None),
                    "inflight": self._load(rid),
                    "heartbeat_age_s": (now - rep.last_heartbeat
                                        if rep.last_heartbeat else None),
                    "breaker": br.state if br is not None else None,
                    "breaker_trips": br.trips if br is not None else 0,
                    "slo": (rep.stats or {}).get("slo"),
                    # per-replica prefix-cache block straight off the
                    # heartbeat: the fleet-wide hit-rate / occupancy
                    # view serving_bench --fleet and cluster_status
                    # --kv aggregate
                    "prefix_cache": (rep.stats or {}).get("prefix_cache"),
                    "stats": {k: v for k, v in (rep.stats or {}).items()
                              if k not in ("slo", "prefix_cache")},
                }
            live = [rr for rr in self._requests.values() if not rr.terminal]
            return {
                "replicas": reps,
                "healthy": sum(1 for r in self.replicas.values()
                               if r.state is ReplicaState.HEALTHY),
                "inflight": len(live),
                "requests_total": len(self._requests),
                "proto_version": PROTO_VERSION,
                "actuation": self.actuation_stats(),
                **self._c,
            }
