"""Continuous-batching request scheduler (counterpart of
``paddle_tpu/serving/scheduler.py``).

Requests wait in a weighted-fair :class:`~.tenancy.FairQueue` (deficit
round robin over tenants; with a single tenant it is exact arrival-order
FIFO); the scheduler admits them into a fixed set of decode *slots* while
the block pool can hold their prefill plus one block of decode headroom. Running requests join the batched decode step;
a finished request frees its slot and blocks at once and the next waiting
request takes over.

When the pool runs dry mid-decode, the latest-arrived *other* running
request is preempted: its blocks are freed and it re-queues at the front
with its generated tokens folded into its prompt, so its re-prefill resumes
where it left off. Sampling is keyed by (request seed, output index), so a
preemption cannot change a request's tokens.

A request leaves as FINISHED, FAILED (an error in its own prefill or
decode, attached as ``req.error``) or CANCELLED (:meth:`Scheduler.cancel`,
a missed deadline, engine shutdown); either way its slot and blocks return
to the pool and the rest of the batch is untouched. The bounded queue
(``max_queue``) raises :class:`QueueFull`, and a request preempted more
than ``max_preemptions_per_request`` times fails with
:class:`PreemptionStorm`. A queued request whose deadline has passed ends
CANCELLED (reason ``"deadline"``, :class:`DeadlineExceeded`) before any
prefill is spent on it.

KV watermarks: past ``high_watermark`` (the fraction of usable device
blocks referenced) admissions stop and ``mem_pressure`` latches; the latch
clears below ``low_watermark`` (default 0.75 x high; hysteresis), and the
engine forces it into ``stats()["slo"]["shed"]``.

Every decision lands in the flight recorder (``scheduler.admit`` /
``preempt`` / ``fail`` / ``reject`` / ``kv_pressure`` /
``deadline_queued``) and, through the owning engine's ``on_event``
callback, in its labelled metrics; ``serving.admit`` is the fault site of
each admission attempt.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field

from .. import telemetry
from ..utils import faults
from .kv_cache import PagedKVCache
from .tenancy import FairQueue

__all__ = ["SamplingParams", "Request", "RequestState", "Scheduler",
           "EngineClosed", "QueueFull", "DeadlineExceeded",
           "PreemptionStorm"]


class EngineClosed(RuntimeError):
    """add() after shutdown — the request would otherwise vanish silently."""


class QueueFull(RuntimeError):
    """Bounded admission queue rejected the request (backpressure)."""


class DeadlineExceeded(TimeoutError):
    """The request's per-request deadline passed before it finished."""


class PreemptionStorm(RuntimeError):
    """Requeued more than max_preemptions_per_request times; failing the
    request instead of livelocking the pool."""


@dataclass
class SamplingParams:
    """Per-request decode controls. ``temperature=0`` is greedy (argmax);
    ``top_k=0`` / ``top_p=1.0`` disable those filters."""

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"

    @property
    def is_terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.FAILED,
                        RequestState.CANCELLED)


@dataclass
class Request:
    rid: int
    prompt: list[int]
    sampling: SamplingParams
    on_token: object = None            # callable(req, token) per new token
    # coarse progress signal: on_watermark(req, n_tokens) whenever the
    # output length crosses a multiple of watermark_every
    on_watermark: object = None
    watermark_every: int = 8
    # tenancy: the tenant this request is accounted to (weighted-fair
    # admission, cache quota, cost attribution) and its priority within
    # that tenant only
    tenant: str = "anonymous"
    priority: int = 0
    state: RequestState = RequestState.WAITING
    output_tokens: list[int] = field(default_factory=list)
    cached_tokens: int = 0             # prefix-cache hit at last admission
    cached_tokens_total: int = 0       # summed across (re-)admissions
    arrival_time: float = field(default_factory=time.monotonic)
    admit_time: float | None = None    # first admission into a slot
    deadline: float | None = None      # absolute monotonic() cutoff
    first_token_time: float | None = None
    finish_time: float | None = None
    num_preemptions: int = 0
    finish_reason: str | None = None
    error: BaseException | None = None
    # request-trace context (telemetry.reqtrace): stamped on every span
    # this request produces; trace_parent is the submitter's span id
    trace_id: str | None = None
    trace_parent: int | None = None

    @property
    def prefill_tokens(self) -> list[int]:
        """What a (re-)prefill must process: the prompt plus anything already
        generated (non-empty only after preemption)."""
        return self.prompt + self.output_tokens

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output_tokens)

    @property
    def ttft(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def past_deadline(self, now: float | None = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)

    def emit(self, token: int):
        self.output_tokens.append(int(token))
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
        if self.on_token is not None:
            self.on_token(self, int(token))
        if self.on_watermark is not None and \
                len(self.output_tokens) % max(1, self.watermark_every) == 0:
            self.on_watermark(self, len(self.output_tokens))


class Scheduler:
    """Slots + a weighted-fair queue over a :class:`PagedKVCache`.

    ``tenancy`` is a :class:`~.tenancy.TenantRegistry` whose weights drive
    the queue (None: every request is the anonymous tenant and the queue
    is FIFO); ``high_watermark`` / ``low_watermark`` arm the KV pressure
    latch (None: off)."""

    def __init__(self, cache: PagedKVCache, max_slots: int,
                 max_model_len: int, max_queue: int | None = None,
                 max_preemptions_per_request: int = 16, on_event=None,
                 high_watermark: float | None = None,
                 low_watermark: float | None = None, tenancy=None):
        self.cache = cache
        self.tenancy = tenancy
        # telemetry hook: the owning engine passes a callback(kind, **ctx)
        # so scheduler decisions feed its labelled metrics; standalone
        # schedulers (tests) run without one
        self._on_event = on_event or (lambda kind, **ctx: None)
        self.max_slots = int(max_slots)
        self.max_model_len = int(max_model_len)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_preemptions = int(max_preemptions_per_request)
        self.high_watermark = (None if high_watermark is None
                               else float(high_watermark))
        self.low_watermark = None
        if self.high_watermark is not None:
            self.low_watermark = (0.75 * self.high_watermark
                                  if low_watermark is None
                                  else float(low_watermark))
            if not 0.0 < self.high_watermark <= 1.0:
                raise ValueError(
                    f"high_watermark must be in (0, 1], got "
                    f"{self.high_watermark}")
            if not 0.0 <= self.low_watermark < self.high_watermark:
                raise ValueError(
                    f"low_watermark ({self.low_watermark}) must be below "
                    f"high_watermark ({self.high_watermark})")
        self.mem_pressure = False
        self.num_pressure_events = 0
        self.waiting: FairQueue = FairQueue(
            weight_fn=tenancy.weight if tenancy is not None else None)
        self.running: dict[int, Request] = {}       # slot -> request
        self._free_slots = list(range(max_slots))
        self.num_preemptions = 0
        self.num_rejected = 0
        self.num_failed = 0
        self.num_cancelled = 0
        self.closed = False

    # -- intake -----------------------------------------------------------
    def add(self, req: Request):
        if self.closed:
            raise EngineClosed(
                f"request {req.rid} rejected: the engine has been shut down")
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            self.num_rejected += 1
            telemetry.record_event("scheduler.reject", rid=req.rid,
                                   waiting=len(self.waiting),
                                   running=len(self.running))
            self._on_event("reject", rid=req.rid)
            raise QueueFull(
                f"request {req.rid} rejected: admission queue is full "
                f"({len(self.waiting)}/{self.max_queue} waiting, "
                f"{len(self.running)} running) — back off and retry")
        worst = len(req.prompt) + req.sampling.max_new_tokens
        if worst > self.max_model_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.sampling.max_new_tokens}) exceeds "
                f"max_model_len ({self.max_model_len})")
        if self.cache.blocks_for(worst) > self.cache.allocator.num_usable:
            raise ValueError(
                f"request {req.rid} can never fit: needs "
                f"{self.cache.blocks_for(worst)} blocks, pool has "
                f"{self.cache.allocator.num_usable} usable")
        self.waiting.append(req)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- watermarks and queued deadlines ----------------------------------
    def _update_pressure(self) -> bool:
        """Refresh the watermark latch from the device pool's referenced
        fraction: latches at >= high_watermark, clears below
        low_watermark."""
        if self.high_watermark is None:
            return False
        a = self.cache.allocator
        used_frac = a.num_used / max(a.num_usable, 1)
        if not self.mem_pressure and used_frac >= self.high_watermark:
            self.mem_pressure = True
            self.num_pressure_events += 1
            telemetry.record_event(
                "scheduler.kv_pressure", state="high",
                used_frac=round(used_frac, 4),
                waiting=len(self.waiting), running=len(self.running))
            self._on_event("kv_pressure", rid=None)
        elif self.mem_pressure and used_frac < self.low_watermark:
            self.mem_pressure = False
            telemetry.record_event(
                "scheduler.kv_pressure", state="low",
                used_frac=round(used_frac, 4))
            self._on_event("kv_pressure_clear", rid=None)
        return self.mem_pressure

    def _expire_queued(self, req: Request):
        """A queue head whose deadline passed ends ``deadline`` before any
        prefill is spent on it."""
        self.waiting.popleft()
        self._end(req, RequestState.CANCELLED, "deadline", DeadlineExceeded(
            f"request {req.rid} missed its deadline while still queued "
            f"(never admitted to a prefill slot)"))
        self.num_cancelled += 1
        telemetry.record_event("scheduler.deadline_queued", rid=req.rid,
                               waiting=len(self.waiting))
        self._on_event("deadline_queued", rid=req.rid, req=req)

    # -- admission --------------------------------------------------------
    def admit(self) -> list[tuple[int, Request]]:
        """Move waiting requests into free slots while the pool can hold
        their prefill plus one block of decode headroom, counted against
        *effective* free blocks (free + evictable cached prefixes). Above
        the high watermark admissions stop; a queue head whose deadline
        passed ends ``deadline`` instead of being admitted."""
        admitted = []
        now = time.monotonic()
        self._update_pressure()      # latch/clear even with an empty queue
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            if req.past_deadline(now):
                self._expire_queued(req)
                continue
            if self._update_pressure():
                break
            faults.inject("serving.admit", rid=req.rid)
            need = self.cache.blocks_for(len(req.prefill_tokens)) + 1
            if self.cache.num_effective_free < need:
                break
            self.waiting.popleft()
            slot = self._free_slots.pop(0)
            if not self.cache.allocate(req.rid, len(req.prefill_tokens),
                                       tokens=req.prefill_tokens,
                                       tenant=req.tenant):
                # effective-free check passed but alloc failed (injected
                # exhaustion): put both back, retried next step
                self._free_slots.insert(0, slot)
                self.waiting.appendleft(req)
                break
            req.cached_tokens = self.cache.seq_cached_tokens.get(req.rid, 0)
            req.cached_tokens_total += req.cached_tokens
            req.state = RequestState.RUNNING
            if req.admit_time is None:
                req.admit_time = time.monotonic()
            self.running[slot] = req
            admitted.append((slot, req))
            telemetry.record_event(
                "scheduler.admit", rid=req.rid, slot=slot,
                blocks=len(self.cache.tables.get(req.rid, ())),
                cached_tokens=req.cached_tokens,
                queue_depth=len(self.waiting))
            self._on_event("admit", rid=req.rid, req=req)
        return admitted

    # -- decode-time capacity ---------------------------------------------
    def ensure_decode_capacity(self) -> list[Request]:
        """Before a decode step, every running sequence must own the block
        its next token writes into (privately: copy-on-write if shared). On
        exhaustion, preempt the latest-arrived other running request and
        retry; returns the preempted requests. A sequence that cannot get a
        block with no victim left is FAILED."""
        preempted = []
        for slot in sorted(self.running):
            req = self.running.get(slot)
            if req is None:  # preempted/failed earlier in this very loop
                continue
            while True:
                ok = self.cache.extend(req.rid, req.total_len)
                if ok:
                    ok = self.cache.ensure_writable(req.rid,
                                                    req.total_len - 1)
                if ok:
                    break
                victim = self._pick_victim(exclude=req)
                if victim is None:
                    self.fail(slot, RuntimeError(
                        f"request {req.rid} cannot obtain a KV block "
                        f"(extend or copy-on-write) with no victim left to "
                        f"preempt — pool exhausted "
                        f"(usable={self.cache.allocator.num_usable})"))
                    break
                preempted.append(victim)
                self._preempt(victim)
        return preempted

    def _pick_victim(self, exclude: Request):
        cands = [r for r in self.running.values() if r is not exclude]
        if not cands:
            return None
        return max(cands, key=lambda r: r.arrival_time)

    def _preempt(self, victim: Request):
        slot = next(s for s, r in self.running.items() if r is victim)
        if victim.num_preemptions >= self.max_preemptions:
            self.fail(slot, PreemptionStorm(
                f"request {victim.rid} preempted {victim.num_preemptions} "
                f"times (cap {self.max_preemptions}); failing instead of "
                f"requeueing — pool too small for the offered load"))
            return
        del self.running[slot]
        self._free_slots.append(slot)
        self._free_slots.sort()
        self.cache.free_seq(victim.rid)
        victim.state = RequestState.WAITING
        victim.num_preemptions += 1
        self.num_preemptions += 1
        self.waiting.appendleft(victim)   # front: keep its progress hot
        telemetry.record_event("scheduler.preempt", rid=victim.rid,
                               slot=slot, nth=victim.num_preemptions)
        self._on_event("preempt", rid=victim.rid)

    # -- completion / removal ---------------------------------------------
    def _release_slot(self, slot: int) -> Request:
        req = self.running.pop(slot)
        self._free_slots.append(slot)
        self._free_slots.sort()
        if req.rid in self.cache.tables:
            self.cache.free_seq(req.rid)
        return req

    def _end(self, req: Request, state: RequestState, reason: str,
             error: BaseException | None = None):
        req.state = state
        req.finish_time = time.monotonic()
        req.finish_reason = reason
        req.error = error

    def finish(self, slot: int, reason: str = "length"):
        req = self._release_slot(slot)
        self._end(req, RequestState.FINISHED, reason)
        self._on_event("finish", rid=req.rid)

    def fail(self, slot: int, error: BaseException):
        """Error isolation: tear down ONE slot, attach the error, keep the
        engine alive for every other request."""
        req = self._release_slot(slot)
        self._end(req, RequestState.FAILED, "error", error)
        self.num_failed += 1
        telemetry.record_event("scheduler.fail", rid=req.rid, slot=slot,
                               error=f"{type(error).__name__}: {error}")
        self._on_event("fail", rid=req.rid)

    def cancel(self, rid: int, reason: str = "cancelled",
               error: BaseException | None = None) -> bool:
        """Cancel a waiting or running request by id (``error`` attached).
        Returns False if the request is unknown or already terminal."""
        for req in list(self.waiting):
            if req.rid == rid:
                self.waiting.remove(req)
                self._end(req, RequestState.CANCELLED, reason, error)
                self.num_cancelled += 1
                self._on_event("cancel", rid=rid)
                return True
        for slot, req in list(self.running.items()):
            if req.rid == rid:
                self._release_slot(slot)
                self._end(req, RequestState.CANCELLED, reason, error)
                self.num_cancelled += 1
                self._on_event("cancel", rid=rid)
                return True
        return False

    def close(self) -> list[Request]:
        """Shut the intake down. Still-queued requests end FAILED with
        :class:`EngineClosed` attached; running ones end CANCELLED (reason
        "shutdown"). Returns every request transitioned."""
        self.closed = True
        dropped = []
        while self.waiting:
            req = self.waiting.popleft()
            self._end(req, RequestState.FAILED, "engine_closed", EngineClosed(
                f"request {req.rid} was still queued (never prefilled) "
                f"when the engine closed"))
            self.num_failed += 1
            telemetry.record_event(
                "scheduler.fail", rid=req.rid,
                error="EngineClosed: still queued at close()")
            self._on_event("fail", rid=req.rid)
            dropped.append(req)
        for req in list(self.running.values()):
            if self.cancel(req.rid, reason="shutdown"):
                dropped.append(req)
        return dropped
