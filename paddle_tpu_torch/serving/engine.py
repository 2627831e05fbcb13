"""Continuous-batching LLM serving engine (counterpart of
``paddle_tpu/serving/engine.py``).

``LLMEngine`` drives a ``models.llama.LlamaForCausalLM`` over the paged KV
cache in two kinds of step:

- **prefill** (per admitted request, batch 1): the prompt, padded to a
  power-of-two number of KV blocks (the reference's bucketing, which keeps
  the set of prefill shapes logarithmic in the prompt length), runs densely
  causal, its K/V are written into the request's blocks, and the first new
  token is sampled from the last valid position's logits (TTFT). A
  prefix-cache hit prefills only the tail.
- **decode** (all running slots, one batched call): one token per slot with
  fixed shapes — ``[max_slots, max_blocks]`` block tables and per-slot
  context lengths; each layer's attention is the paged-attention kernel.

PyTorch runs eagerly: there is no ``jit`` and no CUDA graph yet. So
``stats()["decode_traces"]`` / ``["prefill_traces"]`` and the
``engine.prefill`` / ``engine.decode`` entries of the compile watcher count
the distinct step *signatures* the engine ran — the shapes a compiled
engine will trace — and ``serving.compile`` fires once at each new one.

Sampling is seeded per (request seed, output index), so batch composition,
preemption and re-prefill cannot change a request's tokens. Greedy streams
equal the JAX engine's on the same weights; seeded streams agree with it in
distribution only (``nn/decode.py``).

Failure containment: an exception in one request's prefill fails *that*
request (its error attached) and returns its slot and blocks; an exception
in the batched decode fails the requests of that batch; the engine keeps
serving the queue. Per-request deadlines (``add_request(deadline_s=)``)
cancel a request with :class:`DeadlineExceeded` wherever it is, each step;
a queued one never reaches a prefill. A watchdog counts decode steps
slower than ``watchdog_timeout_s``, and a stall detector fails the queue
head (with a flight-recorder dump) rather than spinning when no progress
is possible.

Memory pressure: ``kv_spill_blocks=N`` arms the cache's bounded host spill
tier (eviction demotes CRC32-stamped K/V to host RAM, a prefix hit
promotes it back; a corrupt or faulted promotion re-prefills, never serves
wrong K/V), tracked by the memory monitor's ``kv_spill_host`` tag under its
cap; ``kv_high_watermark`` / ``kv_low_watermark`` latch the scheduler's
backpressure, which is forced into ``stats()["slo"]["shed"]`` (reason
``kv_watermark``).

Tenancy (``tenancy=``, a :class:`~.tenancy.TenantRegistry` or its dict):
requests carry a tenant and a priority; the scheduler's fair queue admits
by the tenants' weights, the cache evicts an over-quota tenant's cached
blocks first, and ``stats()["tenancy"]`` holds per-tenant counters, SLO
windows and the roofline cost attributed to each tenant: a prefill to its
request's tenant, a decode step split evenly over its batch. The request
path only records (tenant, step signature, share); the flops and bytes are
resolved when ``stats()`` reads the roofline, so per-tenant flops sum to
the engine's.

Telemetry, wired where the reference wires it: the labelled
``serving_*{engine=...}`` families (``stats()`` reads its counters back
from them, and falls back to direct reads while ``telemetry.disable()``
holds), a rolling-window :class:`telemetry.SLOTracker`
(``stats()["slo"]``), the lifecycle spans of every terminal request
(``request`` with ``queued`` / ``prefill`` / ``decode`` children on the
request's own trace row) and the ``engine.prefill`` / ``engine.decode``
spans, the decode ``StepTimeline``, the ``MemoryMonitor`` (with
``torch.cuda.memory_stats()`` of the engine's device), and the roofline
cost model (``stats()["perf"]["roofline"]``: each new step signature's
FLOPs and bytes against the measured wall of the later steps). A new
signature's step is counted shape-only (twins of the model of 1 and 2
layers under ``FakeTensorMode`` on the CPU, extended to its depth; the
kernels' plain versions; sampling counted as greedy) when the roofline
is read, never on the request path;
``serving_roofline_frac`` is published from that read on. Fault sites:
``serving.prefill``, ``serving.decode``, ``serving.decode.slot``,
``serving.compile`` and ``serving.kv.fetch`` here, ``serving.admit`` in
the scheduler and the other ``serving.kv.*`` in the cache.

KV fabric: ``export_kv_frames`` / ``ingest_kv_frames`` are the donor and
receiver halves of a cross-replica block migration (``kv_fabric.py``),
which the fleet router drives through its replicas.

``naive_generate`` is the uncached baseline (the full forward over the
whole prefix at every step) that the engine must reproduce.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

from .. import telemetry
from ..nn.decode import sample_logits
from ..utils import faults
from .kv_cache import PagedCacheView, PagedKVCache
from .scheduler import (DeadlineExceeded, Request, RequestState,
                        SamplingParams, Scheduler)
from .tenancy import TenantAccounting, TenantRegistry

__all__ = ["LLMEngine", "naive_generate", "STATS_KEYS"]

# canonical stats() schema, the reference's
STATS_KEYS = frozenset({
    "queue_depth", "num_running", "num_finished", "num_failed",
    "num_cancelled", "num_rejected", "blocks_used", "blocks_free",
    "block_high_water", "cache_utilization", "num_preemptions",
    "decode_traces", "prefill_traces", "total_generated_tokens",
    "tokens_per_sec", "mean_ttft", "watchdog_trips", "last_decode_s",
    "slo", "prefix_cache", "perf", "tenancy",
})

# distinguishes concurrent engines' series in the process-global registry
_ENGINE_IDS = itertools.count()

# TTFT/queue-time land in the default latency buckets; TPOT and decode steps
# are per-token-scale, so give them sub-millisecond resolution too
_TOKEN_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def _engine_metrics(label: str) -> SimpleNamespace:
    """Resolve this engine's labelled children in the global registry once;
    the hot paths touch only the returned handles."""
    reg = telemetry.registry()
    ls = ("engine",)

    def C(name, help):
        return reg.counter(name, help, ls).labels(engine=label)

    def G(name, help):
        return reg.gauge(name, help, ls).labels(engine=label)

    def H(name, help, buckets=telemetry.DEFAULT_BUCKETS):
        return reg.histogram(name, help, ls, buckets=buckets).labels(
            engine=label)

    return SimpleNamespace(
        finished=C("serving_requests_finished_total",
                   "requests that reached FINISHED"),
        failed=C("serving_requests_failed_total",
                 "requests that reached FAILED"),
        cancelled=C("serving_requests_cancelled_total",
                    "requests that reached CANCELLED"),
        rejected=C("serving_requests_rejected_total",
                   "requests rejected by the bounded admission queue"),
        preemptions=C("serving_preemptions_total",
                      "running requests preempted for pool pressure"),
        tokens=C("serving_generated_tokens_total", "tokens emitted"),
        watchdog=C("serving_watchdog_trips_total",
                   "decode steps slower than watchdog_timeout_s"),
        stalls=C("serving_stall_failures_total",
                 "requests failed by the no-progress stall detector"),
        pressure_events=C("serving_kv_pressure_events_total",
                          "device-pool high-watermark latches"),
        pressure=G("serving_kv_pressure",
                   "1 while the device pool is above the high watermark "
                   "(admissions queue, the SLO shed signal is forced)"),
        queue_depth=G("serving_queue_depth", "requests waiting"),
        running=G("serving_running_requests", "requests in decode slots"),
        blocks_used=G("serving_kv_blocks_used", "live KV blocks"),
        blocks_free=G("serving_kv_blocks_free", "free KV blocks"),
        blocks_cached=G("serving_kv_blocks_cached",
                        "evictable cached prefix blocks (rc==0)"),
        high_water=G("serving_kv_block_high_water",
                     "peak live KV blocks this run"),
        utilization=G("serving_cache_utilization",
                      "live / usable KV block fraction"),
        roofline=reg.gauge(
            "serving_roofline_frac",
            "achieved fraction of the roofline-model step time "
            "(rolling mean per engine and step kind)",
            ("engine", "kind")),
        ttft=H("serving_ttft_seconds",
               "request arrival to first emitted token"),
        tpot=H("serving_tpot_seconds",
               "mean inter-token time per finished request",
               _TOKEN_BUCKETS),
        queue_time=H("serving_queue_time_seconds",
                     "request arrival to slot admission"),
        decode_step=H("serving_decode_step_seconds",
                      "wall time of one fused decode step", _TOKEN_BUCKETS),
    )


def _prefill_forward(model, pool, block_size, tokens, bt, pbt, prefix_len,
                     length, sampling, index):
    """The prefill of one request: the padded tokens through ``model`` (K/V
    written into its blocks of ``pool``), the token sampled from the last
    valid position with ``sampling`` at output ``index``; returns it as an
    int32 tensor."""
    P = tokens.shape[0]
    view = PagedCacheView(
        pool, bt[None], None, block_size,
        prefix_block_tables=None if pbt is None else pbt[None],
        prefix_len=prefix_len)
    positions = (prefix_len + torch.arange(P, device=tokens.device))[None]
    logits = model(tokens[None], cache=view, positions=positions)
    sp = sampling
    tok = sample_logits(logits[0, length - 1][None], [sp.temperature],
                        [sp.top_k], [sp.top_p], [sp.seed], [index])
    return tok[0].to(torch.int32)


def _decode_forward(model, pool, block_size, tokens, bt, ctx, sampling):
    """One batched decode step of ``model`` over ``pool``; returns the
    ``[slots]`` int32 tokens."""
    view = PagedCacheView(pool, bt, ctx, block_size)
    logits = model(tokens[:, None], cache=view, positions=ctx.long()[:, None])
    return sample_logits(logits[:, -1], *sampling).to(torch.int32)


class LLMEngine:
    """Continuous-batching serving engine over a paged KV cache.

    model:         a ``LlamaForCausalLM``; the engine runs on its device and
                   keeps the KV pool in its parameter dtype
    block_size:    tokens per KV block
    num_blocks:    pool size incl. the reserved scratch block; default sizes
                   the pool so every slot can reach ``max_model_len``
    max_slots:     decode batch width (concurrent running requests)
    max_model_len: hard cap on prompt + generated tokens per request
    eos_token_id:  optional early-stop token
    max_queue:     bound on the waiting queue (``QueueFull`` beyond it)
    max_preemptions_per_request: requeue cap before a thrashing request is
                   failed
    watchdog_timeout_s: decode steps slower than this are counted as
                   watchdog trips in ``stats()`` (None = off)
    stall_limit:   consecutive no-progress engine steps tolerated before
                   the queue head is failed instead of spinning forever
    slo_ttft_s / slo_tpot_s: latency SLOs of the rolling-window
                   :class:`telemetry.SLOTracker` (``stats()["slo"]``:
                   window p50/p95/p99, goodput, the admit/shed signal);
                   None = track percentiles, never shed
    slo_window_s:  SLO observation window
    prefix_cache:  content-addressed KV-block prefix caching (on by
                   default, as in the reference)
    kv_spill_blocks: bound (in blocks) on the host spill tier under the
                   prefix cache; None / 0 = eviction destroys
    kv_high_watermark / kv_low_watermark: device-pool backpressure
                   (fractions of usable blocks referenced): above high,
                   admissions queue and ``stats()["slo"]["shed"]`` is
                   forced; the latch clears below low (default 0.75 x
                   high). None = off
    tenancy:       a ``TenantRegistry`` (or its ``to_dict()``): weights for
                   the fair queue, cached-block quotas, SLO overrides;
                   None = every request is the "anonymous" tenant (FIFO)
    """

    def __init__(self, model, *, block_size=16, num_blocks=None, max_slots=4,
                 max_model_len=None, eos_token_id=None, max_queue=None,
                 max_preemptions_per_request=16, watchdog_timeout_s=None,
                 stall_limit=8, slo_ttft_s=None, slo_tpot_s=None,
                 slo_window_s=120.0, prefix_cache=True, kv_spill_blocks=None,
                 kv_high_watermark=None, kv_low_watermark=None,
                 tenancy=None):
        cfg = model.config
        self.model = model
        self.device = model.device
        self.block_size = int(block_size)
        self.max_model_len = int(max_model_len or cfg.max_position_embeddings)
        self.max_slots = int(max_slots)
        self.eos_token_id = eos_token_id
        self.max_blocks = -(-self.max_model_len // self.block_size)
        if num_blocks is None:
            num_blocks = self.max_slots * self.max_blocks + 1
        if num_blocks - 1 < self.max_blocks:
            raise ValueError(
                f"pool of {num_blocks} blocks (1 reserved) cannot hold one "
                f"max_model_len={self.max_model_len} sequence "
                f"({self.max_blocks} blocks); shrink max_model_len or grow "
                f"num_blocks")
        kv_dtype = model.lm_head.weight.dtype
        self.prefix_cache = bool(prefix_cache)
        self.cache = PagedKVCache(
            cfg.num_hidden_layers, num_blocks, cfg.num_key_value_heads,
            self.block_size, cfg.head_dim, dtype=kv_dtype,
            device=self.device, prefix_cache=self.prefix_cache,
            spill_blocks=kv_spill_blocks if self.prefix_cache else None)
        self.engine_label = str(next(_ENGINE_IDS))
        self._m = _engine_metrics(self.engine_label)
        self.slo = telemetry.SLOTracker(
            ttft_slo_s=slo_ttft_s, tpot_slo_s=slo_tpot_s,
            window_s=slo_window_s, engine_label=self.engine_label)
        if isinstance(tenancy, dict):
            tenancy = TenantRegistry.from_dict(tenancy)
        self.tenancy = tenancy if tenancy is not None else TenantRegistry()
        self.cache.set_tenant_quotas(self.tenancy.block_quotas())
        self._tenancy_acct = TenantAccounting(
            self.tenancy, self.engine_label, ttft_slo_s=slo_ttft_s,
            tpot_slo_s=slo_tpot_s, window_s=slo_window_s,
            peaks=telemetry.cost.platform_peaks(device=self.device))
        self.scheduler = Scheduler(
            self.cache, self.max_slots, self.max_model_len,
            max_queue=max_queue,
            max_preemptions_per_request=max_preemptions_per_request,
            on_event=self._on_sched_event,
            high_watermark=kv_high_watermark,
            low_watermark=kv_low_watermark, tenancy=self.tenancy)
        self._next_rid = 0

        # distinct step signatures run: (kind, P or (P, NPB) or "decode")
        self._step_sigs: set = set()
        self.decode_traces = 0
        self.prefill_traces: dict = {}

        # roofline cost model (telemetry.cost): a new step signature's
        # shapes wait in _pending_costs until the roofline is read, which
        # counts its step on a shape-only twin; the later steps' walls give
        # the achieved fraction. The fingerprint keys the process-global
        # cost registry, so identical engines share one estimate; it holds
        # the pool's size, which the reference's leaves out (R29: the
        # step's bytes read and write the whole pool)
        self._cost_fp = (
            cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads, self.block_size, self.max_slots,
            self.max_blocks, int(num_blocks), str(kv_dtype))
        self._cost_inputs = (list(model.parameters())
                             + list(model.buffers()))
        self._trace_costs: dict[tuple, dict] = {}   # (kind, bucket) -> est
        self._pending_costs: dict[tuple, tuple] = {}  # (kind, bucket) -> spec
        self._pending_walls: deque = deque(maxlen=512)  # before the estimate
        self._twins = None    # (FakeTensorMode, {layers: (model, pool)})
        self._roofline_fracs: dict[str, list] = {"prefill": [], "decode": []}
        # tenant cost attribution: (tenant, kind, bucket) -> summed share,
        # priced when stats() resolves the estimates; steps_run counts the
        # steps of each (kind, bucket), the engine's own total
        self._pending_charges: dict[tuple, float] = {}
        self.steps_run: dict[tuple, int] = {}

        # performance observability (telemetry.perf)
        self._watcher = telemetry.compile_watcher()
        self._mm = telemetry.memory_monitor()
        self._mm.watch_device(self.device)
        self._decode_tl = telemetry.step_timeline("decode")
        self._params_bytes = sum(t.nbytes for t in self._cost_inputs)
        self._pool_bytes = int(self.cache.pool.nbytes)
        self._block_bytes = self._pool_bytes // max(num_blocks, 1)
        self._mm.add("params", self._params_bytes)
        self._mm.add("kv_pool", self._pool_bytes)
        if self.cache.spill_blocks:
            # the host spill pool grows up to its capacity by design: the
            # leak sentinel flags it only past that bound
            self._mm.expect_bounded(
                "kv_spill_host",
                cap_bytes=self.cache.spill_blocks * self._block_bytes)

        self.finished: list[Request] = []
        self.failed: list[Request] = []
        self.cancelled: list[Request] = []
        self._failed_rids: set[int] = set()
        self._requests: dict[int, Request] = {}
        self._total_generated = 0
        self._serve_start: float | None = None
        self.watchdog_timeout_s = watchdog_timeout_s
        self.watchdog_trips = 0
        self.last_decode_s = 0.0
        self.decode_s = 0.0            # summed over decode steps
        self.decode_tokens = 0         # tokens emitted by decode steps
        self.prefill_calls = 0
        self.stall_limit = int(stall_limit)
        self._stall_steps = 0
        self._progressed = False
        self.closed = False

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def add_request(self, prompt, sampling: SamplingParams | None = None,
                    on_token=None, deadline_s: float | None = None,
                    trace_id: str | None = None,
                    trace_parent: int | None = None,
                    on_watermark=None, watermark_every: int = 8,
                    tenant: str = "anonymous", priority: int = 0) -> Request:
        """Queue a prompt (token ids); returns the live request handle
        (``output_tokens`` grows as the engine steps; ``on_token(req, tok)``
        streams each new token). Past ``deadline_s`` seconds the request
        is CANCELLED with :class:`DeadlineExceeded` attached. ``trace_id``
        is the request-trace context a caller minted
        (``telemetry.reqtrace``): every span this request produces carries
        it. ``on_watermark(req, n)`` fires whenever the output length
        crosses a multiple of ``watermark_every``. ``tenant`` attributes
        the request for fair admission, quotas and cost; ``priority``
        orders requests within that tenant only."""
        req = Request(rid=self._next_rid, prompt=[int(t) for t in prompt],
                      sampling=sampling or SamplingParams(),
                      on_token=on_token, trace_id=trace_id,
                      trace_parent=trace_parent, on_watermark=on_watermark,
                      watermark_every=watermark_every,
                      tenant=str(tenant or "anonymous"),
                      priority=int(priority))
        if deadline_s is not None:
            req.deadline = time.monotonic() + float(deadline_s)
        self._next_rid += 1
        self.scheduler.add(req)           # raises EngineClosed / QueueFull
        self._requests[req.rid] = req
        self._tenancy_acct.note_request(req.tenant)
        return req

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Cancel a waiting or running request; False when it is unknown or
        already terminal."""
        ok = self.scheduler.cancel(rid, reason=reason)
        if ok:
            req = self._requests[rid]
            self.cancelled.append(req)
            self._record_lifecycle(req)
        return ok

    def close(self):
        """Shut down: queued requests end FAILED (``EngineClosed``), running
        ones CANCELLED; later ``add_request`` calls raise."""
        if self.closed:
            return
        self.closed = True
        self._mm.sub("params", self._params_bytes)
        self._mm.sub("kv_pool", self._pool_bytes)
        if self.cache.spill_blocks:
            self._mm.set("kv_spill_host", 0)
        for req in self.scheduler.close():
            if req.state is RequestState.FAILED:
                self.failed.append(req)
                self._failed_rids.add(req.rid)
            else:
                self.cancelled.append(req)
            self._record_lifecycle(req)

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine iteration: sweep deadlines, admit + prefill new
        requests (each inside its own failure boundary), then one batched
        decode step over the running slots. Returns True while there is
        work left."""
        if self.closed:
            return False
        if self._serve_start is None and self.scheduler.has_work():
            self._serve_start = time.monotonic()
        had_work = self.scheduler.has_work()
        self._progressed = False
        self._sweep_deadlines()
        for slot, req in self.scheduler.admit():
            self._progressed = True
            try:
                faults.inject("serving.prefill", rid=req.rid)
                self._run_prefill(slot, req)
            except Exception as e:          # isolate: fail ONE request
                self._fail(slot, e)
        if self.scheduler.running:
            self.scheduler.ensure_decode_capacity()
            self._collect_scheduler_failures()
        if self.scheduler.running:
            self._run_decode()
        self._check_stall(had_work)
        self._sync_gauges()
        # steady-state watermark: stamped only when no request is
        # mid-decode, so blocks that never return show as monotonic growth
        if not self.scheduler.running:
            self._mm.note_step()
        return self.scheduler.has_work()

    def run(self):
        """Drive until every queued request is terminal."""
        while self.step():
            pass

    def generate(self, prompts, sampling=None):
        """Serve all ``prompts`` to completion; returns their output token
        lists in order. ``sampling`` is one SamplingParams or a list."""
        if isinstance(sampling, (SamplingParams, type(None))):
            sampling = [sampling] * len(prompts)
        reqs = [self.add_request(p, s) for p, s in zip(prompts, sampling)]
        self.run()
        return [r.output_tokens for r in reqs]

    def stream(self, prompt, sampling: SamplingParams | None = None):
        """Yield one request's tokens as the engine produces them (other
        queued requests keep batching along)."""
        req = self.add_request(prompt, sampling)
        emitted = 0
        while True:
            while emitted < len(req.output_tokens):
                yield req.output_tokens[emitted]
                emitted += 1
            if req.state.is_terminal:
                if req.state is RequestState.FAILED and req.error:
                    raise req.error
                return
            self.step()

    # ------------------------------------------------------------------
    # KV fabric (cross-replica block migration — serving/kv_fabric.py)
    # ------------------------------------------------------------------
    def export_kv_frames(self, hashes, *, max_frames: int | None = None,
                         max_bytes: int | None = None) -> list[dict]:
        """Donor half of a KV-block migration: serialize the longest
        consecutive run of ``hashes`` (prefix chain-hashes) this engine's
        cache holds, as CRC32-stamped wire frames. Fault site
        ``serving.kv.fetch``: ``error`` raises (the fetch fails at the
        router), ``delay`` sleeps (the router's fetch timeout fires),
        ``stale`` answers empty (the directory entry aged out from under
        the caller), ``corrupt`` bit-rots one frame after its stamp (the
        receiver's CRC check must refuse it). Every kind degrades the
        admitting side to local prefill — never wrong K/V. Call it on the
        thread that steps this engine (it reads the pool)."""
        from . import kv_fabric

        hashes = list(hashes)
        act = faults.inject("serving.kv.fetch", hashes=len(hashes),
                            engine=self.engine_label)
        if act == "stale":
            telemetry.record_event("kv.fabric.export", stale=True,
                                   engine=self.engine_label)
            return []
        frames = kv_fabric.export_frames(self.cache, hashes,
                                         max_frames=max_frames,
                                         max_bytes=max_bytes)
        if act == "corrupt" and frames:
            kv_fabric.corrupt_frame(frames[-1])
        return frames

    def ingest_kv_frames(self, frames) -> dict:
        """Receiver half: CRC-verify and promote migrated frames into the
        local prefix cache through the spill tier's promotion
        (``PagedKVCache._promote`` re-verifies every stamp); a frame of
        another dtype or block shape than this pool's is refused. Returns
        the ``{"ingested", "corrupt", "errors"}`` counts; whatever did not
        land verified simply prefills locally on admission."""
        from . import kv_fabric

        return kv_fabric.ingest_frames(self.cache, frames)

    def stats(self) -> dict:
        """Serving counters (:data:`STATS_KEYS`), read back from this
        engine's registry series (the same numbers are scrapeable as
        ``serving_*{engine=...}`` via ``telemetry.prometheus_text()``).
        With telemetry disabled the registry stops updating, so the values
        fall back to direct reads."""
        self._sync_gauges()
        elapsed = (time.monotonic() - self._serve_start
                   if self._serve_start else 0.0)
        m = self._m
        alloc = self.cache.allocator
        live = telemetry.enabled()
        return {
            "queue_depth": (int(m.queue_depth.value) if live
                            else self.scheduler.queue_depth),
            "num_running": (int(m.running.value) if live
                            else len(self.scheduler.running)),
            "num_finished": (int(m.finished.value) if live
                             else len(self.finished)),
            "num_failed": (int(m.failed.value) if live
                           else len(self.failed)),
            "num_cancelled": (int(m.cancelled.value) if live
                              else len(self.cancelled)),
            "num_rejected": (int(m.rejected.value) if live
                             else self.scheduler.num_rejected),
            "blocks_used": (int(m.blocks_used.value) if live
                            else alloc.num_used),
            "blocks_free": (int(m.blocks_free.value) if live
                            else alloc.num_free),
            "block_high_water": (int(m.high_water.value) if live
                                 else alloc.high_water),
            "cache_utilization": (m.utilization.value if live
                                  else self.cache.utilization()),
            "num_preemptions": (int(m.preemptions.value) if live
                                else self.scheduler.num_preemptions),
            "decode_traces": self.decode_traces,
            "prefill_traces": dict(self.prefill_traces),
            "total_generated_tokens": (int(m.tokens.value) if live
                                       else self._total_generated),
            "tokens_per_sec": (self._total_generated / elapsed
                               if elapsed > 0 else 0.0),
            "mean_ttft": m.ttft.mean if live else self._mean_ttft_direct(),
            "watchdog_trips": (int(m.watchdog.value) if live
                               else self.watchdog_trips),
            "last_decode_s": self.last_decode_s,
            # rolling-window SLO view; "healthy"/"shed" is the admit signal
            "slo": self.slo.summary(),
            "prefix_cache": self.cache.prefix_stats(),
            # compile (step-signature) counts, the decode step's phase
            # breakdown, memory accounting and the roofline block
            "perf": self._perf_block(),
            # per-tenant counters, SLO windows and attributed roofline cost
            "tenancy": self._tenancy_block(),
        }

    def _perf_block(self) -> dict:
        storms = [s for s in self._watcher.storms()
                  if s["callable"].startswith(("engine.", "kernel."))]
        return {
            "compiles": self._watcher.summary(prefix="engine."),
            "storms": storms,
            "explain_recompile": (
                self._watcher.explain(storms[0]["callable"])
                if storms else None),
            "decode_step": self._decode_tl.report(),
            "memory": self._mm.snapshot(),
            "roofline": self._roofline_block(),
        }

    # ------------------------------------------------------------------
    # roofline cost model (telemetry.cost)
    # ------------------------------------------------------------------
    def _note_signature(self, kind: str, bucket: str, spec: tuple):
        """A new step signature: its estimate from the cost registry, else
        None and its ``spec`` waits for :meth:`_resolve_costs`."""
        if not telemetry.enabled():
            return None
        est = telemetry.cost.lookup(f"engine.{kind}", bucket, self._cost_fp)
        if est is None:
            self._pending_costs[(kind, bucket)] = spec
        else:
            self._trace_costs[(kind, bucket)] = est
        return est

    def _resolve_costs(self):
        """Count each pending signature's step, shape-only (once per process
        and fingerprint: identical engines share the estimate), then turn
        the walls that waited for it into achieved fractions and charge
        the tenants' recorded shares."""
        for key, spec in list(self._pending_costs.items()):
            kind, bucket = key
            name = f"engine.{kind}"
            est = telemetry.cost.lookup(name, bucket, self._cost_fp)
            if est is None:
                est = telemetry.cost.register_trace(
                    name, bucket, self._count_step(kind, spec),
                    fingerprint=self._cost_fp, engine=self.engine_label)
            self._trace_costs[key] = est
            del self._pending_costs[key]
        walls = [self._pending_walls.popleft()
                 for _ in range(len(self._pending_walls))]
        for kind, bucket, wall_s in walls:
            self._note_roofline(kind, bucket, wall_s)
        charges, self._pending_charges = self._pending_charges, {}
        for (tenant, kind, bucket), share in charges.items():
            est = self._trace_costs.get((kind, bucket))
            if est is not None:
                self._tenancy_acct.note_cost(tenant, est["flops"] * share,
                                             est["bytes"] * share)

    def _charge_tenant(self, tenant: str, kind: str, bucket: str,
                       share: float = 1.0):
        """Record ``share`` of one executed step for ``tenant``: a prefill
        charges its request's tenant in full, a decode step each member of
        its batch 1 / batch. Priced by :meth:`_resolve_costs`; a step that
        ran with telemetry off has no estimate and is never priced, as in
        the reference."""
        key = (tenant, kind, bucket)
        self._pending_charges[key] = self._pending_charges.get(key, 0.0) \
            + share

    def _tenancy_block(self) -> dict:
        """stats()["tenancy"]: the accounting's summary, with every
        recorded step priced first."""
        self._resolve_costs()
        return self._tenancy_acct.summary()

    def _count_step(self, kind: str, spec: tuple) -> dict:
        """The estimate of one step of ``spec``'s shapes, counted shape-only
        on twins of the model and pool under ``FakeTensorMode`` on the CPU
        (shapes without storage: no memory, no arithmetic; the kernels'
        plain versions), greedy, under the cost counter. The decoder
        layers are identical, so a step's work is affine in the depth: the
        twins have 1 and 2 layers, and their difference extends the count
        to the model's depth, exactly (a 32-layer count costs ~10x more
        host time). ``bytes`` are the engine's own weights and pool."""
        L = self.model.config.num_hidden_layers
        c1, c2 = (self._count_twin(n, kind, spec) for n in (1, min(2, L)))
        est = dict(c1)
        for k in ("matmul_flops", "elementwise_flops"):
            est[k] = c1[k] + (L - 1) * (c2[k] - c1[k])
        est["kernels"] = {
            name: c1["kernels"].get(name, 0) + (L - 1) * (
                c2["kernels"].get(name, 0) - c1["kernels"].get(name, 0))
            for name in sorted(set(c1["kernels"]) | set(c2["kernels"]))}
        est["flops"] = est["matmul_flops"] + est["elementwise_flops"]
        est["arithmetic_intensity"] = (est["flops"] / est["bytes"]
                                       if est["bytes"] else 0.0)
        return est

    def _count_twin(self, layers: int, kind: str, spec: tuple) -> dict:
        from dataclasses import replace

        from torch._subclasses.fake_tensor import FakeTensorMode

        pool = self.cache.pool
        if self._twins is None:
            self._twins = (FakeTensorMode(allow_non_fake_inputs=True), {})
        mode, twins = self._twins
        if layers not in twins:
            with mode:
                twin = type(self.model)(
                    replace(self.model.config, num_hidden_layers=layers),
                    device="cpu", dtype=pool.dtype)
                twin.train(self.model.training)
                twins[layers] = (twin, torch.empty((layers, *pool.shape[1:]),
                                                   dtype=pool.dtype))
        twin, twin_pool = twins[layers]
        S, bs, i32 = self.max_slots, self.block_size, torch.int32
        with mode, torch.inference_mode():
            if kind == "decode":
                args = (torch.zeros(S, dtype=i32),
                        torch.zeros(S, self.max_blocks, dtype=i32),
                        torch.ones(S, dtype=i32))

                def step(*a):
                    return _decode_forward(
                        twin, twin_pool, bs, *a,
                        ([0.0] * S, [0] * S, [1.0] * S, [0] * S, [0] * S))
            else:
                P, NPB, prefix_len, length = spec
                args = (torch.zeros(P, dtype=i32),
                        torch.zeros(P // bs, dtype=i32),
                        None if NPB is None else torch.zeros(NPB, dtype=i32))

                def step(*a):
                    return _prefill_forward(twin, twin_pool, bs, *a,
                                            prefix_len, length,
                                            SamplingParams(), 0)
            est, _ = telemetry.cost.measure(
                step, *args, inputs=self._cost_inputs + [pool],
                outputs=[pool])
        return est

    def _note_roofline(self, kind: str, bucket: str, wall_s: float):
        """One steady-state step's achieved fraction of the roofline-model
        time (a signature's first step is excluded by the callers); a wall
        whose estimate is not counted yet waits for it."""
        if not wall_s or not telemetry.enabled():
            return
        est = self._trace_costs.get((kind, bucket))
        if est is None:
            self._pending_walls.append((kind, bucket, wall_s))
            return
        frac = telemetry.cost.achieved_fraction(
            est, wall_s, telemetry.cost.platform_peaks(device=self.device))
        if frac is None:
            return
        fracs = self._roofline_fracs[kind]
        fracs.append(frac)
        if len(fracs) > 256:
            del fracs[:len(fracs) - 256]
        self._m.roofline.labels(engine=self.engine_label, kind=kind).set(
            sum(fracs) / len(fracs))

    def _roofline_block(self) -> dict:
        """stats()["perf"]["roofline"]: per-kind modelled cost + achieved
        fraction — the serving analogue of the training MFU headline. The
        pending signatures are counted here."""
        self._resolve_costs()
        out = {"peaks": telemetry.cost.platform_peaks(device=self.device)}
        for kind in ("prefill", "decode"):
            buckets = {b: e for (k, b), e in self._trace_costs.items()
                       if k == kind}
            fracs = self._roofline_fracs[kind]
            out[kind] = {
                "buckets": {
                    b: {"flops": e["flops"], "bytes": e["bytes"],
                        "matmul_flops": e["matmul_flops"],
                        "arithmetic_intensity":
                            round(e["arithmetic_intensity"], 3)}
                    for b, e in sorted(buckets.items())},
                "achieved_frac_mean": (sum(fracs) / len(fracs)
                                       if fracs else None),
                "achieved_frac_last": fracs[-1] if fracs else None,
                "samples": len(fracs),
            }
        dec = self._trace_costs.get(("decode", "decode"))
        out["decode_ai"] = (round(dec["arithmetic_intensity"], 3)
                            if dec else None)
        out["serving_roofline_frac"] = out["decode"]["achieved_frac_mean"]
        return out

    def _mean_ttft_direct(self):
        ttfts = [r.ttft for r in self.finished if r.ttft is not None]
        return float(np.mean(ttfts)) if ttfts else None

    # ------------------------------------------------------------------
    # telemetry plumbing
    # ------------------------------------------------------------------
    def _on_sched_event(self, kind: str, rid=None, req=None):
        """Scheduler decisions feed this engine's labelled series (the
        flight-recorder events are recorded by the scheduler itself)."""
        m = self._m
        if kind == "finish":
            m.finished.inc()
        elif kind == "fail":
            m.failed.inc()
        elif kind == "cancel":
            m.cancelled.inc()
        elif kind == "reject":
            m.rejected.inc()
        elif kind == "preempt":
            m.preemptions.inc()
        elif kind == "admit" and req is not None:
            m.queue_time.observe(req.admit_time - req.arrival_time)
            # the worst-case tokens this admission holds the engine for,
            # the fair queue's charge
            self._tenancy_acct.note_admitted(
                req.tenant, len(req.prompt) + req.sampling.max_new_tokens)
        elif kind == "deadline_queued" and req is not None:
            # expired while queued, never prefilled: a cancel like any other
            m.cancelled.inc()
            self.cancelled.append(req)
            self._record_lifecycle(req)
        elif kind == "kv_pressure":
            m.pressure_events.inc()
            m.pressure.set(1)
        elif kind == "kv_pressure_clear":
            m.pressure.set(0)

    def _record_slo(self, req: Request):
        """One rolling-window observation per terminal request: finished
        requests contribute latency samples; failed/cancelled ones count
        their (wasted) tokens against goodput."""
        if req.state is RequestState.FINISHED:
            n = len(req.output_tokens)
            tpot = ((req.finish_time - req.first_token_time) / (n - 1)
                    if n > 1 and req.first_token_time is not None else None)
            queue_time = (req.admit_time - req.arrival_time
                          if req.admit_time is not None else None)
            self.slo.record_finished(ttft=req.ttft, tpot=tpot,
                                     queue_time=queue_time, tokens=n,
                                     trace_id=req.trace_id)
        else:
            self.slo.record_failed(tokens=len(req.output_tokens),
                                   trace_id=req.trace_id)

    def _sync_gauges(self):
        alloc = self.cache.allocator
        m = self._m
        m.queue_depth.set(self.scheduler.queue_depth)
        m.running.set(len(self.scheduler.running))
        m.blocks_used.set(alloc.num_used)
        m.blocks_free.set(alloc.num_free)
        m.blocks_cached.set(alloc.num_cached)
        m.high_water.set(alloc.high_water)
        m.utilization.set(self.cache.utilization())
        self._mm.set("kv_blocks", alloc.num_used * self._block_bytes)
        if self.cache.spill_blocks:
            self._mm.set("kv_spill_host", self.cache.spilled_bytes)
        # the watermark latch (admit() may not run again once the queue
        # drains) rides the SLO tracker's shed signal
        self.scheduler._update_pressure()
        self.slo.set_pressure(self.scheduler.mem_pressure,
                              reason="kv_watermark")

    def _record_lifecycle(self, req: Request):
        """Emit the request's queued -> prefill -> decode lifecycle as
        nested spans on its own virtual trace row, reconstructed from the
        timestamps the scheduler stamped. Called once per terminal
        request (at FINISHED / FAILED / CANCELLED)."""
        if req.finish_time is None or getattr(req, "_spans_recorded", False):
            return
        req._spans_recorded = True
        self._record_slo(req)
        self._tenancy_acct.note_terminal(req)
        tr = telemetry.tracer()
        tid = 100_000 + req.rid
        tid_name = f"request-{req.rid}"
        ctx = {"engine": self.engine_label}
        if req.trace_id:
            ctx["trace_id"] = req.trace_id
        root_attrs = {"rid": req.rid,
                      "state": req.state.value, "reason": req.finish_reason,
                      "prompt_tokens": len(req.prompt),
                      "output_tokens": len(req.output_tokens),
                      "preemptions": req.num_preemptions, **ctx}
        if req.trace_parent is not None:
            root_attrs["trace_parent"] = req.trace_parent
        root = tr.emit("request", req.arrival_time, req.finish_time,
                       attrs=root_attrs, tid=tid, tid_name=tid_name)
        if root is None:          # telemetry disabled
            return
        queued_end = req.admit_time or req.finish_time
        tr.emit("queued", req.arrival_time, queued_end,
                attrs={"rid": req.rid, **ctx}, parent_id=root.span_id,
                tid=tid)
        if req.admit_time is not None:
            prefill_end = req.first_token_time or req.finish_time
            tr.emit("prefill", req.admit_time, prefill_end,
                    attrs={"rid": req.rid, "tokens": len(req.prompt),
                           **ctx},
                    parent_id=root.span_id, tid=tid)
        if req.first_token_time is not None:
            tr.emit("decode", req.first_token_time, req.finish_time,
                    attrs={"rid": req.rid,
                           "tokens": len(req.output_tokens), **ctx},
                    parent_id=root.span_id, tid=tid)

    # ------------------------------------------------------------------
    # degradation machinery
    # ------------------------------------------------------------------
    def _fail(self, slot: int, error: BaseException):
        req = self.scheduler.running[slot]
        self.scheduler.fail(slot, error)
        self.failed.append(req)
        self._failed_rids.add(req.rid)
        self._record_lifecycle(req)

    def _collect_scheduler_failures(self):
        """Requests the scheduler failed on its own (pool exhaustion,
        preemption storm) still need to land in ``self.failed``."""
        for req in self._requests.values():
            if (req.state is RequestState.FAILED
                    and req.rid not in self._failed_rids):
                self.failed.append(req)
                self._failed_rids.add(req.rid)
                self._record_lifecycle(req)

    def _sweep_deadlines(self):
        """Cancel every waiting or running request past its deadline, with
        :class:`DeadlineExceeded` attached."""
        now = time.monotonic()
        for req in list(self.scheduler.waiting) + list(
                self.scheduler.running.values()):
            if req.past_deadline(now):
                err = DeadlineExceeded(
                    f"request {req.rid} missed its deadline "
                    f"({len(req.output_tokens)} of "
                    f"{req.sampling.max_new_tokens} tokens generated)")
                self.scheduler.cancel(req.rid, reason="deadline", error=err)
                self.cancelled.append(req)
                self._record_lifecycle(req)

    def _check_stall(self, had_work: bool):
        """A step that had work but admitted nothing and emitted nothing is
        a stall (e.g. injected allocator exhaustion keeps the queue head
        out forever). After ``stall_limit`` consecutive stalls, fail the
        head instead of spinning."""
        if not had_work or self._progressed or self.scheduler.running:
            self._stall_steps = 0
            return
        self._stall_steps += 1
        if self._stall_steps >= self.stall_limit and self.scheduler.waiting:
            req = self.scheduler.waiting.popleft()
            req.state = RequestState.FAILED
            req.finish_time = time.monotonic()
            req.finish_reason = "stalled"
            req.error = RuntimeError(
                f"request {req.rid} failed after {self._stall_steps} engine "
                f"steps with no progress (blocks free="
                f"{self.cache.allocator.num_free}) — pool exhausted or "
                f"allocator faulted")
            self.scheduler.num_failed += 1
            self.failed.append(req)
            self._failed_rids.add(req.rid)
            self._stall_steps = 0
            # postmortem: the stall's run-up (alloc attempts, admissions
            # that bounced, injected faults) is exactly what the ring holds
            self._m.failed.inc()
            self._m.stalls.inc()
            self._record_lifecycle(req)
            telemetry.record_event(
                "engine.stall", rid=req.rid, engine=self.engine_label,
                blocks_free=self.cache.allocator.num_free)
            telemetry.dump(reason="engine stall detector", error=req.error)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def _bucket(self, length: int) -> int:
        """Pad prompts to a power-of-two number of blocks (capped at the
        model max)."""
        nb = max(1, -(-length // self.block_size))
        nb = 1 << (nb - 1).bit_length()
        return min(nb, self.max_blocks) * self.block_size

    def _act_estimate(self, tokens: int) -> int:
        """Rough live-activation bytes for a forward over ``tokens`` tokens
        (residual stream + one layer's MLP working set, f32): an
        attribution aid; the allocator's truth is
        ``memory_monitor().device_stats()``."""
        cfg = self.model.config
        width = cfg.hidden_size + getattr(cfg, "intermediate_size",
                                          4 * cfg.hidden_size)
        return int(tokens) * width * 4

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _new_sig(self, kind: str, key, **ctx) -> bool:
        """First run of a step signature: the ``serving.compile`` fault site
        and the trace counters (what a compiled engine would trace)."""
        if (kind, key) in self._step_sigs:
            return False
        faults.inject("serving.compile", callable=f"engine.{kind}", **ctx)
        self._step_sigs.add((kind, key))
        if kind == "decode":
            self.decode_traces += 1
        else:
            self.prefill_traces[key] = self.prefill_traces.get(key, 0) + 1
        return True

    def _run_prefill(self, slot: int, req: Request):
        toks = req.prefill_tokens
        cached = req.cached_tokens if self.prefix_cache else 0
        bs = self.block_size
        npb = cached // bs                       # matched blocks (full)
        tail = toks[cached:]
        L = len(tail)
        P = self._bucket(L)
        table = self.cache.tables[req.rid]
        bt = np.zeros(P // bs, np.int32)
        tail_blocks = table[npb:npb + P // bs]
        bt[:len(tail_blocks)] = tail_blocks
        padded = np.zeros(P, np.int32)
        padded[:L] = tail
        sig = (("tokens", (P,), "int32"), ("block_table", (P // bs,), "int32"))
        pbt = None
        if npb:
            # prefix table padded to a power of two, as in the reference
            NPB = 1 << (npb - 1).bit_length()
            pbt = np.zeros(NPB, np.int32)
            pbt[:npb] = table[:npb]
            pbt = self._tensor(pbt)
            key, bucket = (P, NPB), f"P{P}-NPB{NPB}"
            sig += (("prefix_table", (NPB,), "int32"),)
            new = self._new_sig("prefill", key, P=P, NPB=NPB)
        else:
            key, bucket = P, f"P{P}"
            new = self._new_sig("prefill", key, P=P)
        self._mm.set("activations_estimate", self._act_estimate(P))
        span_kw = {"cached": cached} if cached else {}
        if req.trace_id:
            span_kw["trace_id"] = req.trace_id
        cost_est = None
        if new:
            cost_est = self._note_signature(
                "prefill", bucket, (P, NPB if npb else None, cached, L))
        t0 = time.monotonic()
        with telemetry.span("engine.prefill", rid=req.rid, tokens=L,
                            padded=P, engine=self.engine_label, **span_kw):
            # lint: allow-host-sync(the sampled token to the host: the scheduler and the stream need it)
            tok = _prefill_forward(
                self.model, self.cache.pool, self.block_size,
                self._tensor(padded), self._tensor(bt), pbt, cached, L,
                req.sampling, len(req.output_tokens)).item()
        wall = time.monotonic() - t0
        self._watcher.record_call("engine.prefill", sig,
                                  wall_s=wall if new else None,
                                  cost=cost_est)
        if not new:
            self._note_roofline("prefill", bucket, wall)
        self.prefill_calls += 1
        self.steps_run[("prefill", bucket)] = \
            self.steps_run.get(("prefill", bucket), 0) + 1
        self._charge_tenant(req.tenant, "prefill", bucket)
        self.cache.commit_prefix(req.rid, toks)
        self._emit(slot, req, tok)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _decode_step(self, tokens, bt, ctx, sampling):
        """One batched decode step over every slot (inactive ones write a
        garbage token into the scratch block and sample greedily); returns
        the ``[max_slots]`` int32 tokens."""
        return _decode_forward(self.model, self.cache.pool, self.block_size,
                               tokens, bt, ctx, sampling)

    def _run_decode(self):
        # per-slot chaos boundary: a fault targeted at one request drops
        # only that request from the batch (FAILED, error attached)
        for slot, req in sorted(self.scheduler.running.items()):
            try:
                faults.inject("serving.decode.slot", rid=req.rid)
            except Exception as e:
                self._fail(slot, e)
        running = dict(self.scheduler.running)  # slot -> req snapshot
        if not running:
            return
        S = self.max_slots
        # decode StepTimeline: host batch assembly is the "data" phase, the
        # batched call the "compute" phase (recorded in the finally below,
        # so failed steps are attributed too)
        t_step0 = time.monotonic()
        tokens = np.zeros(S, np.int32)
        ctx = np.ones(S, np.int32)       # inactive: 1 garbage scratch token
        temps, top_ks, top_ps = [0.0] * S, [0] * S, [1.0] * S
        seeds, steps = [0] * S, [0] * S
        sids = [None] * S
        for slot, req in running.items():
            sids[slot] = req.rid
            tokens[slot] = (req.output_tokens[-1] if req.output_tokens
                            else req.prompt[-1])
            ctx[slot] = req.total_len - 1
            sp = req.sampling
            temps[slot], top_ks[slot], top_ps[slot] = (
                sp.temperature, sp.top_k, sp.top_p)
            seeds[slot], steps[slot] = sp.seed, len(req.output_tokens)
        bt = self.cache.table_array(sids, self.max_blocks)
        data_s = time.monotonic() - t_step0

        self._mm.set("activations_estimate", self._act_estimate(S))
        # batch-level decode ticks carry every member request's trace
        # context so per-request merged traces can include them
        span_kw = {}
        tids = [r.trace_id for r in running.values() if r.trace_id]
        if tids:
            span_kw["trace_ids"] = tids
        new = False
        cost_est = None
        t0 = time.monotonic()
        try:
            with telemetry.span("engine.decode", batch=len(running),
                                engine=self.engine_label, **span_kw):
                faults.inject("serving.decode", batch=len(running))
                new = self._new_sig("decode", "decode")
                if new:
                    cost_est = self._note_signature("decode", "decode", ())
                # lint: allow-host-sync(the sampled tokens to the host, once a step: the scheduler and the streams need them)
                toks = self._decode_step(
                    self._tensor(tokens), self._tensor(bt), self._tensor(ctx),
                    (temps, top_ks, top_ps, seeds, steps)).tolist()
        except Exception as e:
            # the batched step died: its requests fail, the engine (and the
            # waiting queue) survives
            for slot in list(running):
                if slot in self.scheduler.running:
                    self._fail(slot, e)
            return
        finally:
            self.last_decode_s = time.monotonic() - t0
            self._decode_tl.record_step(
                time.monotonic() - t_step0,
                {"data": data_s, "compute": self.last_decode_s})
            self._watcher.record_call(
                "engine.decode",
                (("tokens", (S,), "int32"),
                 ("block_tables", (S, self.max_blocks), "int32")),
                wall_s=self.last_decode_s if new else None, cost=cost_est)
            self._m.decode_step.observe(self.last_decode_s)
            if (self.watchdog_timeout_s is not None
                    and self.last_decode_s > self.watchdog_timeout_s):
                self.watchdog_trips += 1
                self._m.watchdog.inc()
                telemetry.record_event(
                    "engine.watchdog_trip", engine=self.engine_label,
                    decode_s=self.last_decode_s,
                    limit_s=self.watchdog_timeout_s)
        if not new:
            self._note_roofline("decode", "decode", self.last_decode_s)
        self.decode_s += self.last_decode_s
        self.decode_tokens += len(running)
        self.steps_run[("decode", "decode")] = \
            self.steps_run.get(("decode", "decode"), 0) + 1
        share = 1.0 / len(running)
        for req in running.values():
            self._charge_tenant(req.tenant, "decode", "decode", share)
        if self.prefix_cache:
            # a decode write that just filled its block completes another
            # full token block: index it so later admissions can share it
            for slot, req in running.items():
                if (slot in self.scheduler.running
                        and req.total_len % self.block_size == 0):
                    self.cache.commit_prefix(req.rid, req.prefill_tokens)
        for slot, req in running.items():
            self._emit(slot, req, toks[slot])

    def _emit(self, slot: int, req: Request, token: int):
        req.emit(token)
        self._progressed = True
        self._total_generated += 1
        self._m.tokens.inc()
        self._tenancy_acct.note_tokens(req.tenant)
        if len(req.output_tokens) == 1:
            # the trace-id exemplar links a slow TTFT bucket straight to
            # the request trace that landed in it (OpenMetrics exemplars)
            self._m.ttft.observe(
                req.ttft,
                exemplar=({"trace_id": req.trace_id}
                          if req.trace_id else None))
        if self.eos_token_id is not None and token == self.eos_token_id:
            self._finish(slot, "stop")
        elif len(req.output_tokens) >= req.sampling.max_new_tokens:
            self._finish(slot, "length")

    def _finish(self, slot: int, reason: str):
        req = self.scheduler.running[slot]
        self.scheduler.finish(slot, reason)
        self.finished.append(req)
        n = len(req.output_tokens)
        if n > 1 and req.first_token_time is not None:
            self._m.tpot.observe(
                (req.finish_time - req.first_token_time) / (n - 1),
                exemplar=({"trace_id": req.trace_id}
                          if req.trace_id else None))
        self._record_lifecycle(req)


# ---------------------------------------------------------------------------
# uncached baseline
# ---------------------------------------------------------------------------

@torch.inference_mode()
def naive_generate(model, prompt, sampling: SamplingParams | None = None,
                   eos_token_id=None):
    """Reference decode loop with NO KV cache: every step re-runs the full
    forward over the whole prefix (through the flash-attention kernel on
    the card). Tokens are keyed like the engine's — (seed, output index) —
    so the engine must reproduce this stream token for token."""
    sp = sampling or SamplingParams()
    toks = [int(t) for t in prompt]
    out = []
    for i in range(sp.max_new_tokens):
        ids = torch.tensor([toks], dtype=torch.long, device=model.device)
        last = model(ids)[0, -1]
        tok = int(sample_logits(last[None], [sp.temperature], [sp.top_k],
                                [sp.top_p], [sp.seed], [i])[0])
        out.append(tok)
        toks.append(tok)
        if eos_token_id is not None and tok == eos_token_id:
            break
    return out
