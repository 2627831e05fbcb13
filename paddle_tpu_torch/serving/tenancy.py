"""Multi-tenant QoS: identity, rate limits, weighted-fair admission, and
per-tenant accounting (counterpart of ``paddle_tpu/serving/tenancy.py``;
docs/SERVING.md "Multi-tenancy & autoscaling").

Everything upstream of this module treats traffic as one anonymous
stream; this module makes *tenant* a first-class dimension:

- :class:`Tenant` — the policy record: fair-share ``weight``, token-bucket
  rate limit (``rate_tokens_per_s`` / ``burst_tokens``), prefix-cache
  ``block_quota``, API keys, and optional per-tenant SLO overrides.
- :class:`TenantRegistry` — API-key -> tenant resolution for a front door
  (missing/unknown key raises :class:`AuthError` once any tenant declares
  keys), plus the per-tenant token buckets. A shed tenant's
  ``Retry-After`` derives from *its own bucket refill*.
- :class:`FairQueue` — deficit-round-robin weighted-fair queuing over
  tenants, with the exact mutation surface of the ``deque`` it replaces
  inside :class:`~paddle_tpu_torch.serving.scheduler.Scheduler`. DRR
  charges each admission its worst-case token cost (prompt +
  max_new_tokens), so under saturation served-token shares converge to
  the configured weights; an idle tenant's unused share redistributes
  (its deficit is dropped, not banked); priority orders *within* a
  tenant; and with a single tenant the queue is exact FIFO — which is
  why the scheduler always runs it, no feature flag.
- :class:`TenantAccounting` — engine-side per-tenant SLO windows and
  roofline cost attribution: every prefill's FLOPs/bytes are charged to
  the admitted request's tenant, every batched decode step is split
  across the running slots, so the per-tenant sums reconcile with the
  engine's total roofline FLOPs.

Deviation from the reference: the reference prices roofline-model seconds
at a built-in chip-hour rate when ``$PADDLE_TPU_CHIP_DOLLARS_PER_H`` is
unset. The port carries no built-in price: :func:`dollars_for` returns
None, and the ``dollars`` entries of :meth:`TenantAccounting.summary`
stay None, until the environment variable (or :func:`dollars_for`'s
``rate_per_h`` argument) sets a rate (ROADMAP R30).

Requests without any configured tenancy are labelled ``"anonymous"``
everywhere — one label value, never a crashed label set.
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass

from .. import telemetry
from ..analysis import locksan

__all__ = ["ANONYMOUS", "AuthError", "Tenant", "TokenBucket",
           "TenantRegistry", "FairQueue", "TenantAccounting",
           "dollars_for"]

ANONYMOUS = "anonymous"

# $-proxy rate for roofline cost attribution (per card-hour); no default:
# unpriced until the deployment sets one
_DOLLARS_ENV = "PADDLE_TPU_CHIP_DOLLARS_PER_H"


class AuthError(PermissionError):
    """Missing or unknown API key while the registry requires auth — the
    gateway answers 401 with the documented JSON error shape."""


@dataclass(frozen=True)
class Tenant:
    """One tenant's QoS policy. ``weight`` is the fair-share ratio under
    saturation; ``rate_tokens_per_s``/``burst_tokens`` arm the gateway
    token bucket (None = unlimited); ``block_quota`` caps the tenant's
    *cached* prefix blocks (beyond it, its blocks evict first);
    ``api_keys`` authenticate it at the gateway (once any tenant has
    keys, keyless requests are refused 401)."""

    name: str
    weight: float = 1.0
    rate_tokens_per_s: float | None = None
    burst_tokens: float | None = None
    block_quota: int | None = None
    api_keys: tuple[str, ...] = ()
    ttft_slo_s: float | None = None
    tpot_slo_s: float | None = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got "
                f"{self.weight}")
        object.__setattr__(self, "api_keys", tuple(self.api_keys))

    def to_dict(self) -> dict:
        return {"name": self.name, "weight": self.weight,
                "rate_tokens_per_s": self.rate_tokens_per_s,
                "burst_tokens": self.burst_tokens,
                "block_quota": self.block_quota,
                "api_keys": list(self.api_keys),
                "ttft_slo_s": self.ttft_slo_s,
                "tpot_slo_s": self.tpot_slo_s}

    @classmethod
    def from_dict(cls, d: dict) -> "Tenant":
        return cls(name=d["name"], weight=d.get("weight", 1.0),
                   rate_tokens_per_s=d.get("rate_tokens_per_s"),
                   burst_tokens=d.get("burst_tokens"),
                   block_quota=d.get("block_quota"),
                   api_keys=tuple(d.get("api_keys") or ()),
                   ttft_slo_s=d.get("ttft_slo_s"),
                   tpot_slo_s=d.get("tpot_slo_s"))


class TokenBucket:
    """Token bucket in *token* units (prompt + max_new_tokens per request):
    ``rate`` tokens/s refill up to ``burst`` capacity. Costs above the
    burst are clamped to it (a request larger than the whole bucket
    would otherwise never admit — it pays a full-bucket drain instead).
    Not self-locking: the owning :class:`TenantRegistry` serializes."""

    def __init__(self, rate: float, burst: float | None = None,
                 clock=time.monotonic):
        if rate <= 0:
            raise ValueError(f"bucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self._clock = clock
        self._level = self.burst
        self._stamp = clock()

    def _refill(self):
        now = self._clock()
        self._level = min(self.burst,
                          self._level + (now - self._stamp) * self.rate)
        self._stamp = now

    @property
    def level(self) -> float:
        self._refill()
        return self._level

    def try_acquire(self, cost: float) -> bool:
        cost = min(float(cost), self.burst)
        self._refill()
        if self._level >= cost:
            self._level -= cost
            return True
        return False

    def retry_after(self, cost: float) -> float:
        """Seconds until ``cost`` tokens will have refilled — the
        per-tenant Retry-After a bucket-shed 429 carries."""
        cost = min(float(cost), self.burst)
        self._refill()
        return max(0.0, (cost - self._level) / self.rate)


class TenantRegistry:
    """The tenant table: identity resolution, rate limiting, and the knobs
    every other layer reads (weights for the scheduler's
    :class:`FairQueue`, block quotas for the prefix cache, SLO overrides
    for per-tenant tracking). JSON round-trips through
    :meth:`to_dict`/:meth:`from_dict` so a fleet replica spec can carry
    it over the replica pipe."""

    def __init__(self, tenants=(), *, clock=time.monotonic):
        self._clock = clock
        self._tenants: dict[str, Tenant] = {}
        self._by_key: dict[str, str] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = locksan.Lock("tenancy.registry")
        self.accepted: dict[str, int] = {}
        self.shed: dict[str, int] = {}
        for t in tenants:
            self._add(t if isinstance(t, Tenant) else Tenant.from_dict(t))
        if ANONYMOUS not in self._tenants:
            self._add(Tenant(name=ANONYMOUS))

    def _add(self, t: Tenant):
        if t.name in self._tenants:
            raise ValueError(f"duplicate tenant {t.name!r}")
        self._tenants[t.name] = t
        for k in t.api_keys:
            if k in self._by_key:
                raise ValueError(
                    f"API key of tenant {t.name!r} already belongs to "
                    f"tenant {self._by_key[k]!r}")
            self._by_key[k] = t.name
        if t.rate_tokens_per_s:
            self._buckets[t.name] = TokenBucket(
                t.rate_tokens_per_s, t.burst_tokens, clock=self._clock)

    # -- identity ---------------------------------------------------------
    @property
    def require_auth(self) -> bool:
        return bool(self._by_key)

    def names(self) -> list[str]:
        return list(self._tenants)

    def get(self, name: str | None) -> Tenant:
        """Policy for ``name``; unknown names fall back to the anonymous
        tenant's policy (label sets never crash on a stranger)."""
        return self._tenants.get(name or ANONYMOUS,
                                 self._tenants[ANONYMOUS])

    def drain_bucket(self, name: str) -> bool:
        """Empty a tenant's token bucket NOW (the remediation
        ``shed_tenant`` pressure valve): its next admissions shed with a
        refill-derived Retry-After until the bucket recovers on its own
        rate. Bounded and self-healing — a throttle, not a ban. Returns
        False when the tenant has no bucket (unlimited tenants cannot be
        shed this way)."""
        with self._lock:
            bucket = self._buckets.get(name)
            if bucket is None:
                return False
            bucket._refill()
            bucket._level = 0.0
            return True

    def weight(self, name: str) -> float:
        return self.get(name).weight

    def block_quotas(self) -> dict[str, int]:
        return {n: t.block_quota for n, t in self._tenants.items()
                if t.block_quota is not None}

    def resolve(self, authorization: str | None) -> str:
        """``Authorization`` header value -> tenant name. Accepts
        ``Bearer <key>`` or a bare key. With no API keys configured every
        request is ``anonymous``; with keys configured a missing or
        unknown key raises :class:`AuthError` (the gateway's 401)."""
        if not self.require_auth:
            return ANONYMOUS
        if not authorization:
            raise AuthError(
                "missing API key: pass 'Authorization: Bearer <key>'")
        key = authorization.strip()
        if key.lower().startswith("bearer "):
            key = key[7:].strip()
        name = self._by_key.get(key)
        if name is None:
            raise AuthError("unknown API key")
        return name

    # -- rate limiting ----------------------------------------------------
    def admit(self, name: str, cost: float) -> float | None:
        """Charge ``cost`` tokens against the tenant's bucket. Returns
        None when admitted (or the tenant is unlimited); otherwise the
        bucket-refill-derived Retry-After in seconds (and the per-tenant
        shed count is bumped)."""
        with self._lock:
            bucket = self._buckets.get(name)
            if bucket is None or bucket.try_acquire(cost):
                self.accepted[name] = self.accepted.get(name, 0) + 1
                return None
            self.shed[name] = self.shed.get(name, 0) + 1
            return bucket.retry_after(cost)

    # -- surfacing --------------------------------------------------------
    def snapshot(self) -> dict:
        """The gateway ``/stats`` tenancy block: per-tenant policy +
        accepted/shed counts + live bucket levels."""
        with self._lock:
            out = {}
            for name, t in self._tenants.items():
                b = self._buckets.get(name)
                out[name] = {
                    "weight": t.weight,
                    "rate_tokens_per_s": t.rate_tokens_per_s,
                    "burst_tokens": b.burst if b else None,
                    "bucket_level": round(b.level, 3) if b else None,
                    "block_quota": t.block_quota,
                    "accepted": self.accepted.get(name, 0),
                    "shed": self.shed.get(name, 0),
                }
            return {"require_auth": self.require_auth, "tenants": out}

    def to_dict(self, *, keys: bool = True) -> dict:
        docs = [t.to_dict() for t in self._tenants.values()]
        if not keys:
            for d in docs:
                d["api_keys"] = []
        return {"tenants": docs}

    @classmethod
    def from_dict(cls, d: dict, *, clock=time.monotonic) -> "TenantRegistry":
        return cls(d.get("tenants") or (), clock=clock)


def _default_cost(req) -> float:
    """DRR charge for one admission: the worst-case tokens this request
    occupies the engine for (prompt + full output budget)."""
    return float(max(1, len(req.prompt) + req.sampling.max_new_tokens))


class FairQueue:
    """Deficit-round-robin weighted-fair queue over tenants, presenting
    the ``deque`` surface the :class:`Scheduler` mutates: ``append``,
    ``appendleft``, ``popleft``, ``remove``, ``[0]`` peek, ``len``,
    iteration, truthiness.

    Mechanics: each tenant owns a sub-queue; a rotation visits tenants
    with work, crediting ``quantum * weight`` deficit per visit, and the
    head (``[0]``/``popleft``) is the first request its tenant can
    afford. The charge is :func:`_default_cost` at pop time. A tenant
    whose queue drains leaves the rotation and forfeits its deficit
    (unused share redistributes instead of banking). ``appendleft`` is
    the preemption-requeue path: a global resume stack served before any
    fair-share arbitration, preserving the scheduler's front-requeue
    semantics exactly (in-flight work is never preempted *by fairness*).
    Within a tenant, higher ``priority`` sorts first (stable FIFO per
    priority). With one tenant every operation reduces to the plain
    deque it replaced — tested byte-identical.

    Single-threaded by design, like the deque before it: the scheduler
    is driven by one engine loop."""

    def __init__(self, weight_fn=None, quantum: float = 64.0,
                 cost_fn=None):
        self._weight = weight_fn or (lambda name: 1.0)
        self._quantum = float(quantum)
        self._cost = cost_fn or _default_cost
        self._resume: deque = deque()            # preempt-requeue stack
        self._qs: dict[str, deque] = {}          # tenant -> sub-queue
        self._rr: deque[str] = deque()           # active-tenant rotation
        self._deficit: dict[str, float] = {}
        self.served_cost: dict[str, float] = {}  # popped charge per tenant
        self._head = None
        self._head_tenant: str | None = None
        self._len = 0

    @staticmethod
    def _tenant_of(req) -> str:
        return getattr(req, "tenant", None) or ANONYMOUS

    @staticmethod
    def _priority_of(req) -> int:
        return int(getattr(req, "priority", 0) or 0)

    # -- mutation ---------------------------------------------------------
    def append(self, req):
        t = self._tenant_of(req)
        q = self._qs.get(t)
        if q is None:
            q = self._qs[t] = deque()
            self._rr.append(t)
            self._deficit.setdefault(t, 0.0)
        pr = self._priority_of(req)
        if q and self._priority_of(q[-1]) < pr:
            # rare path: a priority request jumps its tenant's own line
            # (stable: equal priorities keep arrival order)
            idx = next((i for i, r in enumerate(q)
                        if self._priority_of(r) < pr), len(q))
            q.insert(idx, req)
        else:
            q.append(req)
        self._len += 1
        self._invalidate()

    def appendleft(self, req):
        self._resume.appendleft(req)
        self._len += 1
        self._invalidate()

    def popleft(self):
        head = self._select()
        if head is None:
            raise IndexError("pop from an empty FairQueue")
        t = self._head_tenant
        if t is None:
            self._resume.popleft()
        else:
            q = self._qs[t]
            q.popleft()
            charge = self._cost(head)
            self._deficit[t] -= charge
            self.served_cost[t] = self.served_cost.get(t, 0.0) + charge
            if not q:
                self._drop_tenant(t)
        self._len -= 1
        self._invalidate()
        return head

    def remove(self, req):
        # identity, not ==: Request is a dataclass and field equality is
        # neither needed nor cheap here
        for i, r in enumerate(self._resume):
            if r is req:
                del self._resume[i]
                break
        else:
            t = self._tenant_of(req)
            q = self._qs.get(t, ())
            for i, r in enumerate(q):
                if r is req:
                    del q[i]
                    break
            else:
                raise ValueError(f"request {req!r} not in FairQueue")
            if not q:
                self._drop_tenant(t)
        self._len -= 1
        self._invalidate()

    def _drop_tenant(self, t: str):
        # leaving the rotation forfeits banked deficit: an idle tenant's
        # share redistributes now, not after it cashes in stale credit
        del self._qs[t]
        self._rr.remove(t)
        self._deficit.pop(t, None)

    def _invalidate(self):
        self._head = None
        self._head_tenant = None

    # -- selection --------------------------------------------------------
    def _select(self):
        if self._head is not None:
            return self._head
        if self._resume:
            self._head = self._resume[0]
            self._head_tenant = None
            return self._head
        if not self._rr:
            return None
        while True:
            t = self._rr[0]
            head = self._qs[t][0]
            if self._deficit[t] >= self._cost(head):
                self._head = head
                self._head_tenant = t
                return head
            self._deficit[t] += self._quantum * self._weight(t)
            self._rr.rotate(-1)

    # -- deque surface ----------------------------------------------------
    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        yield from self._resume
        for t in list(self._rr):
            yield from self._qs[t]

    def __getitem__(self, idx):
        if idx == 0:
            head = self._select()
            if head is None:
                raise IndexError("FairQueue is empty")
            return head
        for i, req in enumerate(self):
            if i == idx:
                return req
        raise IndexError(idx)

    def depths(self) -> dict[str, int]:
        out = {t: len(q) for t, q in self._qs.items()}
        if self._resume:
            out["_resume"] = len(self._resume)
        return out


# ---------------------------------------------------------------------------
# engine-side accounting
# ---------------------------------------------------------------------------

def dollars_for(flops: float, bytes_: float,
                rate_per_h: float | None = None,
                peaks: dict | None = None) -> float | None:
    """Roofline-model seconds for (flops, bytes) on ``peaks`` (default:
    :func:`telemetry.cost.platform_peaks`) priced at the card-hour rate
    ``rate_per_h`` (default ``$PADDLE_TPU_CHIP_DOLLARS_PER_H``): the
    FLOP-grade $/request proxy of docs/OBSERVABILITY.md "Cost model".
    None when no rate is set or the peaks are unknown."""
    if rate_per_h is None:
        rate_per_h = os.environ.get(_DOLLARS_ENV)
        if not rate_per_h:
            return None
    secs = telemetry.cost.roofline_time_s(
        {"flops": float(flops), "bytes": float(bytes_)}, peaks)
    return None if secs is None else secs * float(rate_per_h) / 3600.0


_TM = None


def _tenant_metrics():
    global _TM
    if _TM is None:
        reg = telemetry.registry()
        ls = ("engine", "tenant")
        from types import SimpleNamespace
        _TM = SimpleNamespace(
            requests=reg.counter(
                "tenant_requests_total",
                "requests accepted into the engine, by tenant", ls),
            tokens=reg.counter(
                "tenant_generated_tokens_total",
                "tokens emitted, by tenant", ls),
            admitted=reg.counter(
                "tenant_admitted_tokens_total",
                "DRR-charged tokens admitted into decode slots "
                "(prompt + output budget), by tenant", ls),
            flops=reg.counter(
                "tenant_flops_total",
                "roofline-model FLOPs attributed, by tenant", ls),
            hbm=reg.counter(
                "tenant_hbm_bytes_total",
                "roofline-model HBM bytes attributed, by tenant", ls),
            dollars=reg.counter(
                "tenant_cost_dollars_total",
                "roofline-time $-proxy attributed, by tenant "
                "($PADDLE_TPU_CHIP_DOLLARS_PER_H; unpriced: never "
                "incremented)", ls),
            ttft_p99=reg.gauge(
                "tenant_ttft_p99_seconds",
                "per-tenant rolling-window p99 TTFT", ls),
            goodput=reg.gauge(
                "tenant_slo_goodput_ratio",
                "per-tenant tokens-within-SLO fraction (window)", ls),
        )
    return _TM


class TenantAccounting:
    """Per-tenant SLO windows + roofline cost attribution for one engine.

    The engine calls :meth:`note_request` at intake, :meth:`note_admitted`
    at slot admission, :meth:`note_tokens` per emitted token batch,
    :meth:`note_cost` with each attributed step cost (when ``stats()``
    resolves the roofline, off the request path), and
    :meth:`note_terminal` once per terminal request. All calls arrive on
    the single engine-driving thread (like the rest of the engine's
    counters), so no lock. The attributed cost is priced by
    :func:`dollars_for` on ``peaks`` (the engine's card); unpriced,
    ``dollars`` stays None."""

    def __init__(self, registry_: TenantRegistry, engine_label: str, *,
                 ttft_slo_s=None, tpot_slo_s=None, window_s: float = 120.0,
                 peaks=None):
        self.registry = registry_
        self.engine_label = engine_label
        self._peaks = peaks
        self._ttft_slo_s = ttft_slo_s
        self._tpot_slo_s = tpot_slo_s
        self._window_s = float(window_s)
        self._slo: dict[str, telemetry.SLOTracker] = {}
        # plain dicts mirror the metric families so stats() stays correct
        # with telemetry disabled
        self._c: dict[str, dict[str, float]] = {}
        self._m = _tenant_metrics()

    def _bump(self, tenant: str, key: str, v: float = 1.0):
        d = self._c.setdefault(tenant, {})
        d[key] = d.get(key, 0.0) + v

    def tracker(self, tenant: str) -> telemetry.SLOTracker:
        tr = self._slo.get(tenant)
        if tr is None:
            t = self.registry.get(tenant)
            tr = telemetry.SLOTracker(
                ttft_slo_s=(t.ttft_slo_s if t.ttft_slo_s is not None
                            else self._ttft_slo_s),
                tpot_slo_s=(t.tpot_slo_s if t.tpot_slo_s is not None
                            else self._tpot_slo_s),
                window_s=self._window_s,
                engine_label=f"{self.engine_label}/{tenant}")
            self._slo[tenant] = tr
        return tr

    # -- hooks ------------------------------------------------------------
    def note_request(self, tenant: str):
        self._bump(tenant, "requests")
        if telemetry.enabled():
            self._m.requests.labels(
                engine=self.engine_label, tenant=tenant).inc()

    def note_admitted(self, tenant: str, tokens: float):
        self._bump(tenant, "admitted_tokens", tokens)
        if telemetry.enabled():
            self._m.admitted.labels(
                engine=self.engine_label, tenant=tenant).inc(tokens)

    def note_tokens(self, tenant: str, n: int = 1):
        self._bump(tenant, "generated_tokens", n)
        if telemetry.enabled():
            self._m.tokens.labels(
                engine=self.engine_label, tenant=tenant).inc(n)

    def note_cost(self, tenant: str, flops: float, bytes_: float):
        if not flops and not bytes_:
            return
        usd = dollars_for(flops, bytes_, peaks=self._peaks)
        self._bump(tenant, "flops", flops)
        self._bump(tenant, "hbm_bytes", bytes_)
        if usd is not None:
            self._bump(tenant, "dollars", usd)
        if telemetry.enabled():
            lk = dict(engine=self.engine_label, tenant=tenant)
            self._m.flops.labels(**lk).inc(flops)
            self._m.hbm.labels(**lk).inc(bytes_)
            if usd is not None:
                self._m.dollars.labels(**lk).inc(usd)

    def note_terminal(self, req):
        """Mirror of the engine's ``_record_slo`` into the tenant's own
        rolling window (the engine passes the same derived latencies)."""
        tenant = getattr(req, "tenant", None) or ANONYMOUS
        from .scheduler import RequestState
        tr = self.tracker(tenant)
        if req.state is RequestState.FINISHED:
            n = len(req.output_tokens)
            tpot = ((req.finish_time - req.first_token_time) / (n - 1)
                    if n > 1 and req.first_token_time is not None else None)
            queue_time = (req.admit_time - req.arrival_time
                          if req.admit_time is not None else None)
            self._bump(tenant, "finished")
            tr.record_finished(ttft=req.ttft, tpot=tpot,
                               queue_time=queue_time,
                               tokens=n, trace_id=req.trace_id)
        else:
            self._bump(tenant, "failed")
            tr.record_failed(tokens=len(req.output_tokens),
                             trace_id=req.trace_id)

    # -- surfacing --------------------------------------------------------
    def summary(self) -> dict:
        """``stats()["tenancy"]``: per-tenant counters, cost attribution,
        and the tenant's own SLO window. ``totals`` reconciles: the sum
        of per-tenant FLOPs equals everything this engine attributed.
        ``dollars`` is None for a tenant (and the totals) never priced."""
        tenants = {}
        totals = {"flops": 0.0, "hbm_bytes": 0.0, "dollars": None,
                  "generated_tokens": 0.0}
        names = set(self._c) | set(self._slo)
        for name in sorted(names):
            c = self._c.get(name, {})
            slo_sum = None
            tr = self._slo.get(name)
            if tr is not None:
                slo_sum = tr.summary()
                if telemetry.enabled():
                    lk = dict(engine=self.engine_label, tenant=name)
                    self._m.ttft_p99.labels(**lk).set(
                        slo_sum["ttft"]["p99"] or 0.0)
                    if slo_sum["goodput_ratio"] is not None:
                        self._m.goodput.labels(**lk).set(
                            slo_sum["goodput_ratio"])
            entry = {
                "requests": int(c.get("requests", 0)),
                "finished": int(c.get("finished", 0)),
                "failed": int(c.get("failed", 0)),
                "generated_tokens": int(c.get("generated_tokens", 0)),
                "admitted_tokens": c.get("admitted_tokens", 0.0),
                "cost": {"flops": c.get("flops", 0.0),
                         "hbm_bytes": c.get("hbm_bytes", 0.0),
                         "dollars": c.get("dollars")},
                "slo": slo_sum,
            }
            tenants[name] = entry
            totals["flops"] += entry["cost"]["flops"]
            totals["hbm_bytes"] += entry["cost"]["hbm_bytes"]
            if entry["cost"]["dollars"] is not None:
                totals["dollars"] = ((totals["dollars"] or 0.0)
                                     + entry["cost"]["dollars"])
            totals["generated_tokens"] += entry["generated_tokens"]
        return {"tenants": tenants, "totals": totals}
