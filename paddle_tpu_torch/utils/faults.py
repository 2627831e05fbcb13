"""Deterministic, seeded fault-injection registry (chaos harness;
counterpart of ``paddle_tpu/utils/faults.py``: the same plan grammar and
the same ``(seed, site, call index)`` draw rule, so one plan fires at the
same calls in both packages).

Production serving and multi-host training die in ways unit tests never
exercise: a bad request mid-prefill, a collective that hangs, a host killed
between two shard writes. This module gives every such failure a *name* — a
fault **site** — and lets a test or operator arm a :class:`FaultPlan` that
fires exceptions, delays, or resource exhaustion at exact, reproducible
points in the run.

Sites are plain strings compiled into the code via :func:`inject`::

    act = faults.inject("serving.kv.alloc", n=need)
    if act == "exhaust":
        return None            # site opts in to simulated exhaustion

``inject`` is a no-op (single attribute load + None check) when no plan is
active, so call sites stay in hot paths.

Plans are deterministic: a spec fires on the *k-th call* to its site
(``@k``), optionally for ``xN`` consecutive calls, or stochastically with a
plan-seeded RNG (``%p``) whose draw sequence depends only on (seed, site,
call index) — the same plan against the same workload always fires the same
faults.

Activation paths:

- programmatic: ``with FaultPlan.parse("serving.prefill:error@2"): ...``
- environment / flags: set ``FLAGS_fault_plan`` (env var or
  ``paddle.set_flags``) and every ``inject`` call consults it — how a
  stock process is driven from the outside.

Grammar (``;``-separated specs)::

    site:kind[=arg][@start][xcount][%prob]

    site   exact site name; a TOP-LEVEL (dot-free) site matches its whole
           subtree: ``collective`` fires at every ``collective.<op>``,
           ``store`` at every TCPStore verb — this is how one
           ``collective:delay=0.3`` plan turns a whole rank into a
           straggler for the cluster monitor to name. Dotted sites stay
           exact (``serving.decode`` does not hit ``serving.decode.slot``)

    kind   error      raise FaultError(arg or a default message)
           delay      time.sleep(float(arg))  [default 0.05s]
           exhaust    inject() returns "exhaust"; the site simulates
                      running out of its resource
           nan_grads  inject() returns "nan_grads"; the guarded train
                      step poisons this step's gradients with NaN
                      (exercises the numerical-health guard)
           bad_batch  inject() returns "bad_batch"; the dataloader
                      replaces the batch's floats with NaN
           stale_hash inject() returns "stale_hash"; the prefix index
                      behaves as if it resolved a wrong-content block
                      (the cache drops the whole match: no-share fallback)
           corrupt    inject() returns "corrupt"; the site simulates data
                      corruption (at ``serving.kv.spill`` the host copy
                      bit-rots after its CRC stamp; at
                      ``serving.kv.promote`` the CRC check fails — either
                      way the entry is dropped, never served)
           torn_write inject() returns "torn_write"; the gateway journal
                      writes half a frame and raises JournalTornWrite —
                      simulated process death mid-append (recovery must
                      detect the torn record by CRC and skip it)
           stale      inject() returns "stale"; the site behaves as if
                      its advertised state aged out from under the
                      caller (at ``serving.kv.fetch`` the donor answers
                      a KV-block fetch with zero frames even though the
                      fleet directory still lists the prefix — the
                      admitting replica falls back to local prefill)
    @start 1-based call index at which the spec starts firing (default 1)
    xcount how many consecutive calls fire (default 1; ``x*`` = forever)
    %prob  instead of @/x determinism, fire each call with probability
           ``prob`` from the plan's seeded RNG

Sites the port has (the reference's fleet, journal, store, collective,
checkpoint, spill-tier and optimizer sites arrive with their modules):

    serving.prefill       per admitted request, before its prefill step
    serving.decode.slot   per running request, before each decode step
    serving.decode        once per batched decode step
    serving.kv.alloc      BlockAllocator.alloc (exhaust => pool dry)
    serving.kv.share      prefix-index match on admission
                          (stale_hash => drop to no-share, full prefill)
    serving.kv.cow        copy-on-write guard before a shared-block write
                          (exhaust => CoW alloc fails; caller preempts)
    serving.admit         per admission attempt
    serving.compile       once per NEW prefill/decode step signature
                          (error => that step fails; isolation boundary
                          fails the request / in-flight batch, engine
                          survives)
    dataloader.next       DataLoader, per emitted batch
                          (bad_batch => the batch's floats become NaN)
"""
from __future__ import annotations

import random
import re
import threading
import time
import zlib
from dataclasses import dataclass, field
from ..analysis import locksan

__all__ = ["FaultError", "FaultSpec", "FaultPlan", "inject", "activate",
           "deactivate", "active_plan", "site_matches"]


class FaultError(RuntimeError):
    """The exception an ``error`` fault raises. Carries the site so
    recovery layers can tell injected faults from organic ones."""

    def __init__(self, site: str, hit: int, message: str | None = None):
        self.site = site
        self.hit = hit
        super().__init__(
            message or f"injected fault at site '{site}' (hit #{hit})")


_SPEC_RE = re.compile(
    r"^(?P<site>[\w.\-]+):"
    r"(?P<kind>error|delay|exhaust|nan_grads|bad_batch|stale_hash"
    r"|torn_write|corrupt|stale)"
    r"(?:=(?P<arg>[^@x%;]+))?"
    r"(?:@(?P<start>\d+))?"
    r"(?:x(?P<count>\d+|\*))?"
    r"(?:%(?P<prob>[0-9.]+))?$")


def site_matches(spec_site: str, site: str) -> bool:
    """Exact match, or — for a *top-level* (dot-free) spec site — subtree
    match: ``collective`` fires at ``collective.all_reduce``, ``store`` at
    every verb. Dotted spec sites stay exact (``serving.decode`` must not
    also hit ``serving.decode.slot``), so every pre-existing plan keeps
    its meaning."""
    if spec_site == site:
        return True
    return "." not in spec_site and site.startswith(spec_site + ".")


@dataclass
class FaultSpec:
    """One armed fault: *what* fires, *where*, and *when*."""

    site: str
    kind: str                      # "error" | "delay" | "exhaust"
    arg: str | float | None = None
    start: int = 1                 # 1-based call index; first firing
    count: int = 1                 # consecutive firings; -1 = forever
    prob: float | None = None      # stochastic mode (overrides start/count)
    fired: int = 0

    # "token" kinds: inject() hands the kind string back to the call site,
    # which decides what the fault means there (exhaust => resource dry,
    # nan_grads => poisoned gradients, bad_batch => NaN batch,
    # stale_hash => prefix index resolved wrong content)
    TOKEN_KINDS = ("exhaust", "nan_grads", "bad_batch", "stale_hash",
                   "torn_write", "corrupt", "stale")

    def __post_init__(self):
        if self.kind not in ("error", "delay") + self.TOKEN_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "delay":
            self.arg = 0.05 if self.arg is None else float(self.arg)

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        m = _SPEC_RE.match(text.strip())
        if m is None:
            raise ValueError(
                f"bad fault spec {text!r}; expected "
                "site:kind[=arg][@start][xcount][%prob]")
        count = m.group("count")
        return cls(
            site=m.group("site"), kind=m.group("kind"), arg=m.group("arg"),
            start=int(m.group("start") or 1),
            count=-1 if count == "*" else int(count or 1),
            prob=float(m.group("prob")) if m.group("prob") else None)

    def should_fire(self, call_index: int, rng: random.Random) -> bool:
        if self.prob is not None:
            return rng.random() < self.prob
        if call_index < self.start:
            return False
        if self.count < 0:
            return True
        return call_index < self.start + self.count


@dataclass
class _Firing:
    """One entry in the plan's audit log."""

    site: str
    hit: int
    kind: str
    ctx: dict = field(default_factory=dict)


class FaultPlan:
    """A set of :class:`FaultSpec`\\ s plus per-site call counters and an
    audit log of everything that fired. Usable as a context manager::

        with FaultPlan.parse("serving.prefill:error@2") as plan:
            engine.run()
        assert plan.fired          # the audit log
    """

    def __init__(self, specs=(), seed: int = 0):
        self.specs: list[FaultSpec] = list(specs)
        self.seed = int(seed)
        self.calls: dict[str, int] = {}      # site -> total inject() calls
        self.fired: list[_Firing] = []
        self._lock = locksan.Lock("faults.plan")

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        specs = [FaultSpec.parse(p) for p in text.split(";") if p.strip()]
        return cls(specs, seed=seed)

    def add(self, site, kind, arg=None, start=1, count=1, prob=None):
        """Programmatic spec builder; chainable."""
        self.specs.append(FaultSpec(site=site, kind=kind, arg=arg,
                                    start=start, count=count, prob=prob))
        return self

    # -- bookkeeping -------------------------------------------------------
    def fired_at(self, site: str) -> int:
        return sum(1 for f in self.fired if f.site == site)

    def summary(self) -> dict:
        out: dict[str, int] = {}
        for f in self.fired:
            out[f"{f.site}:{f.kind}"] = out.get(f"{f.site}:{f.kind}", 0) + 1
        return out

    # -- the hot path ------------------------------------------------------
    def consult(self, site: str, ctx: dict) -> str | None:
        """Advance the site's counter; fire at most one matching spec.
        Returns the kind token for token kinds (exhaust/nan_grads/
        bad_batch), None otherwise; raises :class:`FaultError` / sleeps for
        error / delay faults."""
        with self._lock:
            idx = self.calls.get(site, 0) + 1
            self.calls[site] = idx
            spec = None
            for s in self.specs:
                if not site_matches(s.site, site):
                    continue
                # crc32 keying: stable across processes (unlike hash())
                rng = random.Random(
                    zlib.crc32(f"{self.seed}|{site}|{idx}".encode()))
                if s.should_fire(idx, rng):
                    spec = s
                    break
            if spec is None:
                return None
            spec.fired += 1
            self.fired.append(_Firing(site, idx, spec.kind, dict(ctx)))
            kind, arg = spec.kind, spec.arg
        _emit_telemetry(site, kind, idx, ctx)
        # act outside the lock: delays must not serialize other sites
        if kind == "delay":
            time.sleep(float(arg))
            return None
        if kind == "error":
            raise FaultError(site, idx, arg)
        return kind  # token kinds: the site interprets the string

    # -- activation --------------------------------------------------------
    def __enter__(self):
        activate(self)
        return self

    def __exit__(self, *exc):
        deactivate(self)
        return False


_FAULT_COUNTER = None


def _emit_telemetry(site: str, kind: str, hit: int, ctx: dict):
    """Every firing lands in the flight recorder + a labeled counter, so a
    postmortem dump shows the injected fault right before the failure it
    caused (telemetry import is lazy: faults loads very early in package
    init). The private audit list on the plan stays authoritative for
    tests."""
    global _FAULT_COUNTER
    try:
        from .. import telemetry

        if _FAULT_COUNTER is None:
            _FAULT_COUNTER = telemetry.registry().counter(
                "fault_injections_total", "chaos-harness faults fired",
                ("site", "kind"))
        _FAULT_COUNTER.labels(site=site, kind=kind).inc()
        safe_ctx = {k: v for k, v in ctx.items()
                    if k not in ("kind", "site", "hit")
                    and isinstance(v, (int, float, str, bool))}
        telemetry.record_event("fault.injected", site=site, fault=kind,
                               hit=hit, **safe_ctx)
    except Exception:
        pass  # lint: allow-silent(telemetry must never alter fault semantics)


_ACTIVE: FaultPlan | None = None
# FLAGS_fault_plan cache: (flag text) -> parsed plan, so the flag path costs
# one string compare per inject call instead of a re-parse
_FLAG_CACHE: tuple[str, FaultPlan] | None = None


def activate(plan: FaultPlan):
    global _ACTIVE
    if _ACTIVE is not None and _ACTIVE is not plan:
        raise RuntimeError("another FaultPlan is already active")
    _ACTIVE = plan


def deactivate(plan: FaultPlan | None = None):
    global _ACTIVE
    if plan is None or _ACTIVE is plan:
        _ACTIVE = None


def active_plan() -> FaultPlan | None:
    """The armed plan: an explicitly activated one, else one parsed from
    ``FLAGS_fault_plan`` (cached on the flag's string value)."""
    global _FLAG_CACHE
    if _ACTIVE is not None:
        return _ACTIVE
    try:
        from ..framework.flags import flag_value
        text = flag_value("FLAGS_fault_plan")
    except Exception:  # lint: allow-silent(flags registry not imported yet: no plan armed)
        return None
    if not text:
        return None
    if _FLAG_CACHE is None or _FLAG_CACHE[0] != text:
        _FLAG_CACHE = (text, FaultPlan.parse(text))
    return _FLAG_CACHE[1]


def inject(site: str, **ctx) -> str | None:
    """The call-site hook. No active plan: returns None at the cost of one
    global load. With a plan: may raise :class:`FaultError`, sleep, or
    return "exhaust" (the site decides what exhaustion means)."""
    plan = _ACTIVE
    if plan is None:
        plan = active_plan()
        if plan is None:
            return None
    return plan.consult(site, ctx)
