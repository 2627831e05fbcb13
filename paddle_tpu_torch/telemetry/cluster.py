"""Cluster observability plane: cross-rank telemetry over the TCPStore
(counterpart of ``paddle_tpu/telemetry/cluster.py``). The ``store`` is
duck-typed; the port's ``TCPStore`` arrives with ``distributed`` (ROADMAP
Queue 1), so until then a caller passes its own store.

Single-process telemetry (metrics registry, span tracer, flight recorder)
answers "what is *this* process doing"; every multi-rank failure mode asks
the harder question — "which rank made the job slow or hung". This module
layers four capabilities over the rendezvous ``TCPStore`` that every
launched job already has:

1. **Aggregation** — each rank runs a :class:`RankPublisher` background
   thread that periodically publishes its metrics JSON snapshot and
   flight-recorder tail under ``telemetry/<rank>/...``; a
   :class:`ClusterAggregator` (rank 0, the launcher, or
   an operator tool attached externally) merges them into one
   fleet view with per-rank (``rank=`` label injected) and rolled-up
   Prometheus/JSON export.
2. **Straggler & hang diagnosis** — ``distributed/collective.py`` reports
   every eager collective through :func:`collective_enter` /
   :func:`collective_exit`; when a publisher is installed these become
   per-rank sequence heartbeats (op, seq#, entered/exited wall stamps) in
   the store. A :class:`ClusterMonitor` detects *desync* (ranks disagree
   on seq#), *stragglers* (a rank persistently the last entrant by more
   than a threshold), and *hangs* (ranks stuck entered while a peer never
   arrived) — and names the rank and collective seq#.
3. **Postmortem bundles** — on ``CollectiveTimeoutError`` (or any caller
   of :func:`trigger_postmortem` / :meth:`ClusterAggregator.collect_postmortem`)
   every rank's publisher answers with its full flight-recorder dump plus
   a Python stack snapshot of all threads (``sys._current_frames``); the
   collector writes them into one ``postmortem-<id>/`` bundle directory —
   the whole-job answer to "who hung", instead of one rank's
   ``flightrec-*.json``.
4. **Cross-rank trace merge** — per-rank Chrome traces carry their
   wall-clock epoch (``tracing.epoch_unix``); :func:`estimate_clock_offset`
   measures each rank's offset against the aggregator's clock with an
   NTP-style min-RTT exchange through the store, and :func:`merge_traces`
   rebases every rank onto one timeline with one process row per rank
   (``trace-merged.json``).

Store key layout (all under the ``telemetry/`` prefix; values are JSON):

    telemetry/<rank>/meta      rank, pid, host, wall, publish_seq,
                               clock_offset_s, trace_epoch_unix
    telemetry/<rank>/metrics   the rank's registry snapshot
    telemetry/<rank>/flight    tail of the rank's flight-recorder ring
    telemetry/<rank>/coll      latest collective heartbeat
                               {seq, op, state, t_enter, t_exit}
    telemetry/clock/req|resp/<rank>/<i>   clock-sync exchange
    telemetry/postmortem/request          {id, reason, from_rank}
    telemetry/postmortem/<id>/rank<r>     per-rank postmortem payload

The ``store`` argument everywhere is duck-typed (``set/get/add/wait``),
so tests can drive the plane with an in-memory fake. IMPORTANT for real
``TCPStore``: a publisher must get its *own* store connection — the wire
protocol is one-request-at-a-time per connection, and the main thread may
sit inside a long ``wait`` (barrier) exactly when the publisher needs to
answer a postmortem request.

Everything here degrades instead of dying: store hiccups during a publish
are counted (``cluster_publish_errors_total``) and retried next tick, and
no hook on the collective hot path costs more than one global load while
no publisher is installed.
"""
from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
import traceback
from dataclasses import dataclass

from . import tracing
from . import history as history_mod
from . import pyprof as pyprof_mod
from .flight_recorder import flight
from .metrics import ENABLED, registry

__all__ = [
    "RankPublisher", "CollectiveHeartbeat", "ClusterAggregator",
    "ClusterMonitor", "ClockResponder", "ClockEstimate",
    "estimate_clock_offset", "merge_traces", "stack_snapshot",
    "collective_enter", "collective_exit", "trigger_postmortem",
    "publisher", "start_from_env", "STORE_ENV",
]

# the launcher advertises the telemetry store endpoint to workers here
STORE_ENV = "PADDLE_TELEMETRY_STORE"

PREFIX = "telemetry"
PM_REQUEST_KEY = f"{PREFIX}/postmortem/request"


def _k(rank: int, leaf: str) -> str:
    return f"{PREFIX}/{rank}/{leaf}"


def _k_pm(pm_id: str, rank: int) -> str:
    return f"{PREFIX}/postmortem/{pm_id}/rank{rank}"


def _set_json(store, key: str, obj) -> None:
    store.set(key, json.dumps(obj, default=str).encode())


def _get_json(store, key: str):
    raw = store.get(key)
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return None


def _cluster_metrics():
    reg = registry()
    return (
        reg.counter("cluster_publish_total",
                    "per-rank telemetry snapshots published to the store"),
        reg.counter("cluster_publish_errors_total",
                    "publish ticks that hit a store error (retried)"),
        reg.gauge("cluster_seq_spread",
                  "max-min collective seq# across ranks (monitor view)"),
        reg.counter("cluster_straggle_events_total",
                    "collectives a rank entered last by > threshold",
                    ("rank",)),
    )


_M_PUBLISH, _M_PUB_ERRS, _M_SPREAD, _M_STRAGGLE = _cluster_metrics()


# ---------------------------------------------------------------------------
# stack snapshots (the postmortem payload's "where was everyone" half)
# ---------------------------------------------------------------------------

def stack_snapshot() -> dict:
    """Every live thread's Python stack, formatted (faulthandler's view,
    as JSON-able strings). Never raises — a postmortem helper that crashes
    the process it is autopsying is worse than no snapshot."""
    out = {}
    try:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            label = f"{names.get(ident, 'thread')}-{ident}"
            out[label] = [ln.rstrip("\n")
                          for ln in traceback.format_stack(frame)]
    except Exception:  # lint: allow-silent(stack snapshot never raises; partial dump beats none)
        pass
    return out


# ---------------------------------------------------------------------------
# clock sync (NTP-style, through the store)
# ---------------------------------------------------------------------------

@dataclass
class ClockEstimate:
    """offset_s: add to THIS rank's wall clock to get the responder's
    (master) clock. rtt_s: round-trip of the best (kept) probe."""

    offset_s: float
    rtt_s: float
    probes: int


def estimate_clock_offset(store, rank: int, probes: int = 5,
                          timeout_s: float = 10.0, poll_s: float = 0.002,
                          clock=time.time) -> ClockEstimate:
    """Measure this rank's wall-clock offset against the aggregator's
    :class:`ClockResponder` with ``probes`` request/response round trips
    through the store, keeping the minimum-RTT sample (the standard NTP
    argument: the shortest round trip bounds the asymmetry error).
    Polling ``get`` rather than ``wait`` keeps the store connection free
    for other threads between polls."""
    best = None
    deadline = time.monotonic() + timeout_s
    for i in range(probes):
        t0 = clock()
        _set_json(store, f"{PREFIX}/clock/req/{rank}/{i}", {"t0": t0})
        resp = None
        while resp is None:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"clock sync: no responder answered rank {rank} probe "
                    f"{i} within {timeout_s}s (is a ClockResponder running "
                    "on the aggregator?)")
            resp = _get_json(store, f"{PREFIX}/clock/resp/{rank}/{i}")
            if resp is None:
                time.sleep(poll_s)
        t1 = clock()
        rtt = t1 - t0
        offset = float(resp["t_server"]) - (t0 + t1) / 2.0
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    return ClockEstimate(offset_s=best[1], rtt_s=best[0], probes=probes)


class ClockResponder:
    """Aggregator-side half of the exchange: a thread that answers every
    rank's ``clock/req`` with the responder's wall time."""

    def __init__(self, store, world_size: int, poll_s: float = 0.002,
                 clock=time.time):
        self.store = store
        self.world_size = int(world_size)
        self.poll_s = poll_s
        self._clock = clock
        self._next = [0] * self.world_size   # per-rank next unanswered probe
        self._stop = threading.Event()
        self._thread = None
        self.answered = 0

    def serve_once(self) -> int:
        """Answer every currently-pending probe; returns how many."""
        n = 0
        for r in range(self.world_size):
            while True:
                i = self._next[r]
                req = _get_json(self.store, f"{PREFIX}/clock/req/{r}/{i}")
                if req is None:
                    break
                _set_json(self.store, f"{PREFIX}/clock/resp/{r}/{i}",
                          {"t_server": self._clock()})
                self._next[r] = i + 1
                n += 1
        self.answered += n
        return n

    def start(self):
        def run():
            while not self._stop.wait(self.poll_s):
                try:
                    self.serve_once()
                except Exception:  # lint: allow-silent(transient store error; retry next tick)
                    pass
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="cluster-clock-responder")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()


# ---------------------------------------------------------------------------
# collective heartbeats (the straggler/hang signal)
# ---------------------------------------------------------------------------

class CollectiveHeartbeat:
    """Per-rank collective sequence heartbeat: every instrumented
    collective bumps ``seq`` and publishes (op, seq, entered/exited wall
    stamps) to ``telemetry/<rank>/coll``. Store failures never propagate
    into the collective — they are counted and the heartbeat goes stale,
    which the monitor surfaces as publish age."""

    def __init__(self, store, rank: int, clock=time.time):
        self.store = store
        self.rank = int(rank)
        self.seq = 0
        self.errors = 0
        self._clock = clock
        self._cur = None

    def enter(self, op: str, **info):
        self.seq += 1
        self._cur = {"rank": self.rank, "seq": self.seq, "op": op,
                     "state": "entered", "t_enter": self._clock(),
                     "t_exit": None, **info}
        self._publish()

    def exit(self, op: str):
        if self._cur is None or self._cur["op"] != op:
            return
        self._cur["state"] = "exited"
        self._cur["t_exit"] = self._clock()
        self._publish()

    def _publish(self):
        try:
            _set_json(self.store, _k(self.rank, "coll"), self._cur)
        except Exception:
            self.errors += 1


# ---------------------------------------------------------------------------
# the per-rank publisher
# ---------------------------------------------------------------------------

class RankPublisher:
    """Background thread publishing this rank's telemetry to the store
    every ``interval_s``: metrics snapshot, flight-recorder tail, and a
    meta record (publish seq, clock offset, trace epoch). Between ticks it
    also watches ``telemetry/postmortem/request`` and answers with this
    rank's flight dump + stack snapshot — which is what lets a postmortem
    bundle contain *every* rank even while rank main threads are wedged
    inside a collective.

    Give it a dedicated store connection (see module docstring).
    ``clock=`` exists so tests (and the chaos straggler suite) can model
    host clock skew deterministically."""

    def __init__(self, store, rank: int, world_size: int, *,
                 interval_s: float = 1.0, flight_tail: int = 128,
                 clock=time.time, sync_clock: bool = True,
                 clock_probes: int = 5, profile_top_n: int = 200):
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.interval_s = float(interval_s)
        self.flight_tail = int(flight_tail)
        self.profile_top_n = int(profile_top_n)
        self._clock = clock
        self.sync_clock = sync_clock
        self.clock_probes = int(clock_probes)
        self.clock_estimate: ClockEstimate | None = None
        self.heartbeat = CollectiveHeartbeat(store, self.rank, clock=clock)
        self.publish_seq = 0
        self._answered_pm: set[str] = set()
        self._pm_ids = 0
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "RankPublisher":
        """Sync the clock (when a responder is up), publish once, install
        as the process publisher (collective hooks activate), and start
        the periodic thread."""
        if self.sync_clock:
            try:
                self.clock_estimate = estimate_clock_offset(
                    self.store, self.rank, probes=self.clock_probes,
                    clock=self._clock)
            except Exception:  # lint: allow-silent(no clock responder; offsets recorded as unknown)
                self.clock_estimate = None
        self.publish_once()
        install(self)

        def run():
            while not self._stop.wait(self.interval_s):
                self.publish_once()

        self._thread = threading.Thread(
            target=run, daemon=True, name=f"cluster-publisher-{self.rank}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        if publisher() is self:
            install(None)

    # -- publishing ------------------------------------------------------
    def publish_once(self):
        """One tick: meta + metrics snapshot + flight tail, then answer
        any outstanding postmortem request. Never raises."""
        try:
            self.publish_seq += 1
            off = self.clock_estimate
            _set_json(self.store, _k(self.rank, "meta"), {
                "rank": self.rank,
                "world_size": self.world_size,
                "pid": os.getpid(),
                "host": socket.gethostname(),
                "wall": self._clock(),
                "publish_seq": self.publish_seq,
                "interval_s": self.interval_s,
                "clock_offset_s": off.offset_s if off else None,
                "clock_rtt_s": off.rtt_s if off else None,
                "trace_epoch_unix": self.trace_epoch_unix(),
            })
            _set_json(self.store, _k(self.rank, "metrics"),
                      registry().snapshot())
            _set_json(self.store, _k(self.rank, "flight"),
                      flight().events()[-self.flight_tail:])
            prof = pyprof_mod.installed()
            if prof is not None:
                # folded top-N rides the heartbeat: the aggregator's
                # fleet-wide flame view is just a sum over these
                _set_json(self.store, _k(self.rank, "pyprof"), {
                    "rank": self.rank,
                    "hz": prof.hz,
                    "samples": prof.samples,
                    "overhead_frac": prof.overhead_frac(),
                    "folded": prof.folded_dict(self.profile_top_n),
                })
            _M_PUBLISH.inc()
        except Exception:
            _M_PUB_ERRS.inc()
        try:
            self._check_postmortem()
        except Exception:
            _M_PUB_ERRS.inc()

    def trace_epoch_unix(self) -> float:
        """Wall time (on THIS publisher's clock) of this process's trace
        ``ts=0`` — the per-rank base :func:`merge_traces` aligns on."""
        return self._clock() - (time.monotonic() - tracing._EPOCH)

    # -- postmortem ------------------------------------------------------
    def _check_postmortem(self):
        req = _get_json(self.store, PM_REQUEST_KEY)
        if not req or req.get("id") in self._answered_pm:
            return
        self._answered_pm.add(req["id"])
        self.answer_postmortem(req["id"], req.get("reason", ""))

    def answer_postmortem(self, pm_id: str, reason: str = ""):
        evs = flight().events()
        hist = history_mod.installed()
        prof = pyprof_mod.installed()
        _set_json(self.store, _k_pm(pm_id, self.rank), {
            "rank": self.rank,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "wall": self._clock(),
            "reason": reason,
            "stacks": stack_snapshot(),
            "flight": {"num_events": len(evs), "events": evs},
            "coll": {"seq": self.heartbeat.seq},
            # "what was happening the last N minutes before it died" —
            # the history last-window slice, when a store is installed
            "history": hist.last_window() if hist is not None else None,
            "pyprof": ({"hz": prof.hz, "samples": prof.samples,
                        "folded": prof.folded_dict(self.profile_top_n)}
                       if prof is not None else None),
        })

    def trigger_postmortem(self, reason: str) -> str:
        """Broadcast a postmortem request (every rank's publisher answers,
        including this one, immediately). Returns the request id; a
        collector (:meth:`ClusterAggregator.collect_postmortem` or the
        launcher) turns the answers into a bundle directory."""
        self._pm_ids += 1
        pm_id = f"{self.rank}-{self._pm_ids}-{int(self._clock() * 1000)}"
        _set_json(self.store, PM_REQUEST_KEY,
                  {"id": pm_id, "reason": reason, "from_rank": self.rank,
                   "wall": self._clock()})
        self._answered_pm.add(pm_id)
        try:
            self.answer_postmortem(pm_id, reason)
        except Exception:
            _M_PUB_ERRS.inc()
        return pm_id


# ---------------------------------------------------------------------------
# process-global publisher + the collective.py hooks
# ---------------------------------------------------------------------------

_PUBLISHER: RankPublisher | None = None


def publisher() -> RankPublisher | None:
    return _PUBLISHER


def install(pub: RankPublisher | None):
    """Make ``pub`` the process publisher (collective heartbeats activate;
    ``install(None)`` deactivates)."""
    global _PUBLISHER
    _PUBLISHER = pub


def collective_enter(op: str, **info):
    """Hot-path hook compiled into ``distributed/collective.py``: one
    global load when no publisher is installed."""
    p = _PUBLISHER
    if p is not None and ENABLED[0]:
        p.heartbeat.enter(op, **info)


def collective_exit(op: str):
    p = _PUBLISHER
    if p is not None and ENABLED[0]:
        p.heartbeat.exit(op)


def trigger_postmortem(reason: str) -> str | None:
    """Fleet-wide postmortem request, no-op without a publisher (the
    single-process flight-recorder dump still happens at the call site)."""
    p = _PUBLISHER
    if p is None:
        return None
    try:
        return p.trigger_postmortem(reason)
    except Exception:  # lint: allow-silent(best-effort postmortem; None = no publisher installed)
        return None


def start_from_env(store=None, **kwargs) -> RankPublisher | None:
    """Start a publisher from the launcher-provided environment
    (``$PADDLE_TELEMETRY_STORE`` plus the standard rank/world variables);
    None (and no side effects) when the env does not ask for one. Worker
    scripts call this once at startup."""
    endpoint = os.environ.get(STORE_ENV)
    if not endpoint:
        return None
    rank = int(os.environ.get("PADDLE_TPU_PROCESS_ID")
               or os.environ.get("PADDLE_TRAINER_ID") or 0)
    world = int(os.environ.get("PADDLE_TPU_NUM_PROCESSES")
                or os.environ.get("PADDLE_TRAINERS_NUM") or 1)
    if store is None:
        raise NotImplementedError(
            f"${STORE_ENV}={endpoint} asks for a telemetry publisher, but "
            f"the port has no TCPStore yet (it comes with distributed): "
            f"pass store= explicitly")
    return RankPublisher(store, rank, world, **kwargs).start()


# ---------------------------------------------------------------------------
# the monitor (straggler / desync / hang diagnosis)
# ---------------------------------------------------------------------------

class ClusterMonitor:
    """Reads every rank's collective heartbeat and meta records and turns
    them into a diagnosis:

    - **desync**: ranks disagree on the collective seq# by
      ``desync_threshold`` or more — someone skipped or double-counted a
      collective, the precursor to a deadlock.
    - **straggler**: for each seq# where every rank's enter stamp is
      known, the last entrant's lag over the fleet median (clock-offset
      corrected) exceeds ``straggler_threshold_s``; a rank scored on
      ``straggler_min_seqs`` distinct seq#s is *named*.
    - **hang**: some ranks have sat in state ``entered`` for longer than
      ``hang_threshold_s`` — the suspects are the ranks *behind* them
      (lower seq#, never arrived); if every rank entered, the interconnect
      itself is the suspect.

    Wall stamps are corrected with each rank's published
    ``clock_offset_s`` so cross-host skew does not fabricate stragglers.
    """

    def __init__(self, store, world_size: int, *,
                 straggler_threshold_s: float = 0.2,
                 straggler_min_seqs: int = 3,
                 desync_threshold: int = 2,
                 hang_threshold_s: float = 5.0,
                 clock=time.time):
        self.store = store
        self.world_size = int(world_size)
        self.straggler_threshold_s = float(straggler_threshold_s)
        self.straggler_min_seqs = int(straggler_min_seqs)
        self.desync_threshold = int(desync_threshold)
        self.hang_threshold_s = float(hang_threshold_s)
        self._clock = clock
        self._offsets: dict[int, float] = {}
        self._enters: dict[int, dict[int, float]] = {}   # seq -> rank -> t
        self._enter_ops: dict[int, str] = {}             # seq -> op
        self._scored: set[int] = set()
        self.straggles: dict[int, list[tuple[int, float]]] = {}

    # -- raw reads -------------------------------------------------------
    def _read(self, rank: int, leaf: str):
        try:
            return _get_json(self.store, _k(rank, leaf))
        except Exception:  # lint: allow-silent(unreachable rank reads as absent; staleness is surfaced upstream)
            return None

    def offset(self, rank: int) -> float:
        return self._offsets.get(rank, 0.0)

    # -- one diagnosis pass ----------------------------------------------
    def poll(self) -> dict:
        now = self._clock()
        ranks = {}
        seqs = {}
        for r in range(self.world_size):
            meta = self._read(r, "meta")
            if meta and meta.get("clock_offset_s") is not None:
                self._offsets[r] = float(meta["clock_offset_s"])
            coll = self._read(r, "coll")
            off = self.offset(r)
            seq = int(coll["seq"]) if coll else 0
            seqs[r] = seq
            t_enter = (float(coll["t_enter"]) + off
                       if coll and coll.get("t_enter") is not None else None)
            ranks[r] = {
                "seq": seq,
                "op": coll["op"] if coll else None,
                "state": coll["state"] if coll else "never-reported",
                "t_enter": t_enter,
                "in_state_s": (now - t_enter if t_enter is not None
                               and coll["state"] == "entered" else None),
                "publish_age_s": (now - (float(meta["wall"]) + off)
                                  if meta else None),
                "clock_offset_s": self._offsets.get(r),
            }
            if coll and coll.get("t_enter") is not None:
                self._enters.setdefault(seq, {})[r] = t_enter
                self._enter_ops.setdefault(seq, coll.get("op"))
        self._score()
        spread = (max(seqs.values()) - min(seqs.values())) if seqs else 0
        _M_SPREAD.set(spread)
        min_seq = min(seqs.values()) if seqs else 0
        max_seq = max(seqs.values()) if seqs else 0
        behind = sorted(r for r, s in seqs.items() if spread and s == min_seq)
        report = {
            "wall": now,
            "world_size": self.world_size,
            "ranks": ranks,
            "seq_spread": spread,
            "desync": spread >= self.desync_threshold,
            "behind_ranks": behind,
            "straggler": self._named_straggler(),
            "hang": self._diagnose_hang(ranks, behind, max_seq),
        }
        return report

    def _score(self):
        """Score every seq# whose full enter-time set is now known (enters
        accumulate across polls, so a fast poll loop never misses one)."""
        for seq, enters in self._enters.items():
            if seq in self._scored or len(enters) < self.world_size:
                continue
            self._scored.add(seq)
            ts = sorted(enters.values())
            median = ts[len(ts) // 2]
            worst_rank = max(enters, key=lambda r: enters[r])
            lag = enters[worst_rank] - median
            if lag > self.straggler_threshold_s:
                self.straggles.setdefault(worst_rank, []).append((seq, lag))
                _M_STRAGGLE.labels(rank=str(worst_rank)).inc()

    def _named_straggler(self):
        for rank, hits in sorted(self.straggles.items(),
                                 key=lambda kv: -len(kv[1])):
            if len(hits) >= self.straggler_min_seqs:
                lags = [lag for _, lag in hits]
                return {
                    "rank": rank,
                    "seqs": [s for s, _ in hits],
                    "ops": {s: self._enter_ops.get(s) for s, _ in hits},
                    "mean_lag_s": sum(lags) / len(lags),
                    "last_seq": hits[-1][0],
                }
        return None

    def _diagnose_hang(self, ranks: dict, behind: list, max_seq: int):
        waiting = sorted(
            r for r, v in ranks.items()
            if v["in_state_s"] is not None
            and v["in_state_s"] > self.hang_threshold_s)
        if not waiting:
            return {"hung": False, "suspect_ranks": [], "waiting_ranks": [],
                    "stuck_for_s": 0.0}
        suspects = [r for r in behind if r not in waiting] or behind
        if not suspects:
            # everyone arrived and nobody finished: blame the transport
            suspects = waiting
        return {
            "hung": True,
            "suspect_ranks": sorted(suspects),
            "waiting_ranks": waiting,
            "waiting_seq": max_seq,
            "waiting_op": next((ranks[r]["op"] for r in waiting), None),
            "stuck_for_s": max(ranks[r]["in_state_s"] for r in waiting),
        }


# ---------------------------------------------------------------------------
# the aggregator (fleet view, merged export, postmortem collection)
# ---------------------------------------------------------------------------

class ClusterAggregator:
    """Rank-0 / external-tool side: merge every rank's published telemetry
    into one fleet view and collect postmortem bundles."""

    def __init__(self, store, world_size: int, clock=time.time):
        self.store = store
        self.world_size = int(world_size)
        self._clock = clock
        self.responder: ClockResponder | None = None

    # -- clock -----------------------------------------------------------
    def start_clock_responder(self) -> ClockResponder:
        self.responder = ClockResponder(self.store, self.world_size,
                                        clock=self._clock).start()
        return self.responder

    def stop(self):
        if self.responder is not None:
            self.responder.stop()
            self.responder = None

    # -- fleet view ------------------------------------------------------
    def fleet_view(self) -> dict:
        """Everything every rank last published, raw."""
        ranks = {}
        for r in range(self.world_size):
            ranks[r] = {
                "meta": _get_json(self.store, _k(r, "meta")),
                "metrics": _get_json(self.store, _k(r, "metrics")),
                "flight": _get_json(self.store, _k(r, "flight")),
                "coll": _get_json(self.store, _k(r, "coll")),
                "pyprof": _get_json(self.store, _k(r, "pyprof")),
            }
        return {"collected_wall": self._clock(),
                "world_size": self.world_size, "ranks": ranks}

    def merged_snapshot(self) -> dict:
        """One registry-snapshot-shaped dict for the whole fleet: every
        per-rank series gains a ``rank`` label, and each family gets a
        ``rollup`` (counters/histograms summed; gauges sum/min/max) —
        the fleet-level view a dashboard wants next to the per-rank one."""
        out = {"__meta__": {"wall_time": self._clock(),
                            "world_size": self.world_size, "merged": True}}
        for r in range(self.world_size):
            snap = _get_json(self.store, _k(r, "metrics"))
            if not snap:
                continue
            for name, fam in snap.items():
                if name.startswith("__"):
                    continue
                dst = out.setdefault(name, {
                    "type": fam["type"], "help": fam.get("help", ""),
                    "labels": ["rank"] + list(fam.get("labels", [])),
                    "series": [], "rollup": None,
                })
                for s in fam["series"]:
                    s2 = dict(s)
                    s2["labels"] = {"rank": str(r), **s.get("labels", {})}
                    dst["series"].append(s2)
        for name, fam in out.items():
            if name.startswith("__"):
                continue
            fam["rollup"] = self._rollup(fam)
        return out

    @staticmethod
    def _rollup(fam: dict):
        kind, series = fam["type"], fam["series"]
        if not series:
            return None
        if kind == "histogram":
            buckets: dict[str, int] = {}
            total_sum, total_count = 0.0, 0
            for s in series:
                for edge, c in s.get("buckets", {}).items():
                    buckets[edge] = buckets.get(edge, 0) + int(c)
                total_sum += float(s.get("sum", 0.0))
                total_count += int(s.get("count", 0))
            return {"buckets": buckets, "sum": total_sum,
                    "count": total_count,
                    "mean": total_sum / total_count if total_count else None}
        vals = [float(s.get("value", 0.0)) for s in series]
        if kind == "counter":
            return {"value": sum(vals)}
        return {"sum": sum(vals), "min": min(vals), "max": max(vals)}

    def merged_profile(self) -> dict:
        """The fleet-wide flame view: every rank's published folded
        profile summed stack-wise (stacks are rooted at thread names, so
        identical subsystems across ranks merge into one frame tower).
        ``{"stacks": {stack: count}, "ranks": {r: {hz, samples,
        overhead_frac}}, "total_samples": N}``."""
        tables, ranks = [], {}
        for r in range(self.world_size):
            p = _get_json(self.store, _k(r, "pyprof"))
            if not p:
                continue
            tables.append(p.get("folded") or {})
            ranks[r] = {"hz": p.get("hz"), "samples": p.get("samples"),
                        "overhead_frac": p.get("overhead_frac")}
        stacks = pyprof_mod.merge_folded(*tables)
        return {"stacks": stacks, "ranks": ranks,
                "total_samples": sum(stacks.values()),
                "collected_wall": self._clock()}

    def merged_folded_text(self) -> str:
        """The merged view as folded flamegraph lines (pipe to a
        renderer, or reload with ``pyprof.parse_folded``)."""
        prof = self.merged_profile()
        return "\n".join(f"{k} {v}" for k, v in prof["stacks"].items())

    def prometheus_text(self) -> str:
        """Fleet exposition: every rank's series with the ``rank`` label
        injected (rollups are the scraper's `sum by`—only the raw series
        are emitted)."""
        merged = self.merged_snapshot()
        lines = []
        for name in sorted(k for k in merged if not k.startswith("__")):
            fam = merged[name]
            if fam.get("help"):
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["series"]:
                base = ",".join(f'{k}="{v}"'
                                for k, v in s["labels"].items())
                if fam["type"] == "histogram":
                    for edge, c in sorted(s.get("buckets", {}).items(),
                                          key=lambda kv: float(kv[0])):
                        lines.append(
                            f'{name}_bucket{{{base},le="{edge}"}} {c}')
                    lines.append(f'{name}_bucket{{{base},le="+Inf"}} '
                                 f'{s.get("count", 0)}')
                    lines.append(f'{name}_sum{{{base}}} {s.get("sum", 0)}')
                    lines.append(
                        f'{name}_count{{{base}}} {s.get("count", 0)}')
                else:
                    lines.append(f'{name}{{{base}}} {s.get("value", 0)}')
        return "\n".join(lines) + ("\n" if lines else "")

    # -- postmortem bundles ----------------------------------------------
    def collect_postmortem(self, reason: str, out_dir: str | None = None,
                           timeout_s: float = 10.0, poll_s: float = 0.05,
                           pm_id: str | None = None) -> str | None:
        """Broadcast a postmortem request (unless ``pm_id`` names one
        already triggered, e.g. by the rank whose collective timed out)
        and gather every rank's answer into a bundle directory::

            postmortem-<id>/
              manifest.json            reason, ranks collected/missing
              rank<r>-flight.json      that rank's flight-recorder dump
              rank<r>-stacks.txt       all of its threads' Python stacks
              rank<r>-history.json     metrics-history last-window slice
                                       (when that rank had a store)
              rank<r>-pyprof.folded    folded CPU profile (when that rank
                                       had a profiler)

        Ranks that never answer within ``timeout_s`` are listed in the
        manifest's ``missing`` — a dead process is itself a finding.
        Returns the bundle path (None only if even the bundle dir could
        not be written)."""
        if pm_id is None:
            pm_id = f"agg-{os.getpid()}-{int(self._clock() * 1000)}"
            _set_json(self.store, PM_REQUEST_KEY,
                      {"id": pm_id, "reason": reason, "from_rank": None,
                       "wall": self._clock()})
        payloads: dict[int, dict] = {}
        deadline = time.monotonic() + timeout_s
        while (len(payloads) < self.world_size
               and time.monotonic() < deadline):
            for r in range(self.world_size):
                if r in payloads:
                    continue
                p = _get_json(self.store, _k_pm(pm_id, r))
                if p is not None:
                    payloads[r] = p
            if len(payloads) < self.world_size:
                time.sleep(poll_s)
        try:
            root = out_dir or os.environ.get("PADDLE_TPU_FLIGHT_DIR") or \
                __import__("tempfile").gettempdir()
            bundle = os.path.join(root, f"postmortem-{pm_id}")
            os.makedirs(bundle, exist_ok=True)
            for r, p in payloads.items():
                with open(os.path.join(bundle, f"rank{r}-flight.json"),
                          "w") as f:
                    json.dump({k: v for k, v in p.items()
                               if k not in ("stacks", "history", "pyprof")},
                              f, indent=1, default=str)
                with open(os.path.join(bundle, f"rank{r}-stacks.txt"),
                          "w") as f:
                    for label, frames in p.get("stacks", {}).items():
                        f.write(f"== {label} ==\n")
                        f.write("\n".join(frames) + "\n\n")
                if p.get("history"):
                    with open(os.path.join(bundle,
                                           f"rank{r}-history.json"),
                              "w") as f:
                        json.dump(p["history"], f, indent=1, default=str)
                if p.get("pyprof"):
                    with open(os.path.join(bundle,
                                           f"rank{r}-pyprof.folded"),
                              "w") as f:
                        folded = p["pyprof"].get("folded") or {}
                        f.write("\n".join(f"{k} {v}"
                                          for k, v in folded.items()))
                        f.write("\n")
            with open(os.path.join(bundle, "manifest.json"), "w") as f:
                json.dump({
                    "id": pm_id,
                    "reason": reason,
                    "wall": self._clock(),
                    "world_size": self.world_size,
                    "ranks_collected": sorted(payloads),
                    "missing": [r for r in range(self.world_size)
                                if r not in payloads],
                    "ranks_with_history": sorted(
                        r for r, p in payloads.items() if p.get("history")),
                    "ranks_with_profile": sorted(
                        r for r, p in payloads.items() if p.get("pyprof")),
                }, f, indent=1)
            return bundle
        except Exception:  # lint: allow-silent(aggregation is best-effort; None = bundle unavailable)
            return None


# ---------------------------------------------------------------------------
# cross-rank trace merge
# ---------------------------------------------------------------------------

def merge_traces(traces: dict, out_path: str | None = None,
                 offsets_s: dict | None = None,
                 bases_unix: dict | None = None) -> dict:
    """Merge per-source Chrome traces onto one timeline, one process row
    per source.

    ``traces``: {source: path-or-trace-dict}. A source is a rank (int, or
    a numeric string — the original use) or any string label (a serving
    replica id in a per-request merge, ``telemetry.reqtrace``). Each
    source's events are shifted by ``(epoch_unix_s + offset_s) - min over
    sources`` so the earliest source's first microsecond is ts 0 and every
    other source lands at its true (clock-corrected) wall position.
    ``bases_unix`` overrides the per-trace ``otherData.epoch_unix`` (the
    publishers' meta records carry the authoritative value, measured on
    the same clock the offsets were estimated against). ``offsets_s[s]``
    is source s's :class:`ClockEstimate` ``offset_s``. Returns the merged
    trace dict (and writes it to ``out_path`` when given)."""
    offsets_s = offsets_s or {}
    bases_unix = bases_unix or {}
    loaded = {}
    for src, t in traces.items():
        if isinstance(t, str):
            with open(t) as f:
                t = json.load(f)
        try:
            key = int(src)
        except (TypeError, ValueError):
            key = str(src)
        loaded[key] = t

    def _get(d, key):
        if key in d:
            return d[key]
        return d.get(str(key))

    bases = {}
    for key, t in loaded.items():
        base = _get(bases_unix, key)
        if base is None:
            base = float(t.get("otherData", {}).get("epoch_unix", 0.0))
        bases[key] = base + float(_get(offsets_s, key) or 0.0)
    t_zero = min(bases.values()) if bases else 0.0
    # ranks keep their numeric pid and "rank N" label; string sources get
    # sequential pids after the ranks and their label verbatim
    int_keys = sorted(k for k in loaded if isinstance(k, int))
    str_keys = sorted((k for k in loaded if isinstance(k, str)), key=str)
    next_pid = (max(int_keys) + 1) if int_keys else 0
    order, pids, names = [], {}, {}
    for k in int_keys:
        order.append(k)
        pids[k] = k
        names[k] = f"rank {k}"
    for i, k in enumerate(str_keys):
        order.append(k)
        pids[k] = next_pid + i
        names[k] = k
    events = []
    for idx, key in enumerate(order):
        pid = pids[key]
        shift_us = (bases[key] - t_zero) * 1e6
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": names[key]}})
        events.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                       "args": {"sort_index": idx}})
        for e in loaded[key].get("traceEvents", []):
            e2 = dict(e)
            e2["pid"] = pid
            if "ts" in e2:
                e2["ts"] = round(float(e2["ts"]) + shift_us, 3)
            events.append(e2)
    events.sort(key=lambda e: (e.get("ts", -1), e.get("pid", 0)))
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged": True,
            "ranks": order,
            "sources": {str(k): names[k] for k in order},
            "t_zero_unix": t_zero,
            "clock_offsets_s": {str(k): _get(offsets_s, k) or 0.0
                                for k in loaded},
        },
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, default=str)
    return doc
