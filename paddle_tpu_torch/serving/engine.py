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

PyTorch runs eagerly: there is no ``jit`` and no CUDA graph yet, so the
reference's trace counters have no counterpart here.

Sampling is seeded per (request seed, output index), so batch composition,
preemption and re-prefill cannot change a request's tokens. Greedy streams
equal the JAX engine's on the same weights; seeded streams agree with it in
distribution only (``nn/decode.py``).

Failure containment: an exception in one request's prefill fails *that*
request (its error attached) and returns its slot and blocks; an exception
in the batched decode fails the requests of that batch; the engine keeps
serving the queue. Telemetry, fault injection, the cost model, tenancy,
deadlines and the spill tier of the reference are later slices.

``naive_generate`` is the uncached baseline (the full forward over the
whole prefix at every step) that the engine must reproduce.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..nn.decode import sample_logits
from .kv_cache import PagedCacheView, PagedKVCache
from .scheduler import Request, RequestState, SamplingParams, Scheduler

__all__ = ["LLMEngine", "naive_generate"]


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
    prefix_cache:  content-addressed KV-block prefix caching (on by
                   default, as in the reference)
    """

    def __init__(self, model, *, block_size=16, num_blocks=None, max_slots=4,
                 max_model_len=None, eos_token_id=None, max_queue=None,
                 max_preemptions_per_request=16, prefix_cache=True):
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
        self.prefix_cache = bool(prefix_cache)
        self.cache = PagedKVCache(
            cfg.num_hidden_layers, num_blocks, cfg.num_key_value_heads,
            self.block_size, cfg.head_dim, dtype=model.lm_head.weight.dtype,
            device=self.device, prefix_cache=self.prefix_cache)
        self.scheduler = Scheduler(
            self.cache, self.max_slots, self.max_model_len,
            max_queue=max_queue,
            max_preemptions_per_request=max_preemptions_per_request)
        self._next_rid = 0
        self.finished: list[Request] = []
        self.failed: list[Request] = []
        self.cancelled: list[Request] = []
        self._requests: dict[int, Request] = {}
        self._total_generated = 0
        self._serve_start: float | None = None
        self.last_decode_s = 0.0
        self.decode_s = 0.0            # summed over decode steps
        self.decode_tokens = 0         # tokens emitted by decode steps
        self.prefill_calls = 0
        self.closed = False

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def add_request(self, prompt, sampling: SamplingParams | None = None,
                    on_token=None) -> Request:
        """Queue a prompt (token ids); returns the live request handle
        (``output_tokens`` grows as the engine steps; ``on_token(req, tok)``
        streams each new token)."""
        req = Request(rid=self._next_rid, prompt=[int(t) for t in prompt],
                      sampling=sampling or SamplingParams(),
                      on_token=on_token)
        self._next_rid += 1
        self.scheduler.add(req)           # raises EngineClosed / QueueFull
        self._requests[req.rid] = req
        return req

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Cancel a waiting or running request; False when it is unknown or
        already terminal."""
        ok = self.scheduler.cancel(rid, reason=reason)
        if ok:
            self.cancelled.append(self._requests[rid])
        return ok

    def close(self):
        """Shut down: queued requests end FAILED (``EngineClosed``), running
        ones CANCELLED; later ``add_request`` calls raise."""
        if self.closed:
            return
        self.closed = True
        for req in self.scheduler.close():
            (self.failed if req.state is RequestState.FAILED
             else self.cancelled).append(req)

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine iteration: admit + prefill new requests (each inside
        its own failure boundary), then one batched decode step over the
        running slots. Returns True while there is work left."""
        if self.closed:
            return False
        if self._serve_start is None and self.scheduler.has_work():
            self._serve_start = time.monotonic()
        for slot, req in self.scheduler.admit():
            try:
                self._run_prefill(slot, req)
            except Exception as e:          # isolate: fail ONE request
                self._fail(slot, e)
        if self.scheduler.running:
            self.scheduler.ensure_decode_capacity()
            self._collect_scheduler_failures()
        if self.scheduler.running:
            self._run_decode()
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

    def stats(self) -> dict:
        """Serving counters of this slice (a subset of the reference's
        ``stats()`` keys, with the same meanings)."""
        elapsed = (time.monotonic() - self._serve_start
                   if self._serve_start else 0.0)
        alloc = self.cache.allocator
        ttfts = [r.ttft for r in self.finished if r.ttft is not None]
        return {
            "queue_depth": self.scheduler.queue_depth,
            "num_running": len(self.scheduler.running),
            "num_finished": len(self.finished),
            "num_failed": len(self.failed),
            "num_cancelled": len(self.cancelled),
            "num_rejected": self.scheduler.num_rejected,
            "blocks_used": alloc.num_used,
            "blocks_free": alloc.num_free,
            "block_high_water": alloc.high_water,
            "cache_utilization": self.cache.utilization(),
            "num_preemptions": self.scheduler.num_preemptions,
            "total_generated_tokens": self._total_generated,
            "tokens_per_sec": (self._total_generated / elapsed
                               if elapsed > 0 else 0.0),
            "mean_ttft": float(np.mean(ttfts)) if ttfts else None,
            "last_decode_s": self.last_decode_s,
            "decode_tokens_per_sec": (self.decode_tokens / self.decode_s
                                      if self.decode_s > 0 else 0.0),
            "prefix_cache": self.cache.prefix_stats(),
        }

    # ------------------------------------------------------------------
    # failure bookkeeping
    # ------------------------------------------------------------------
    def _fail(self, slot: int, error: BaseException):
        req = self.scheduler.running[slot]
        self.scheduler.fail(slot, error)
        self.failed.append(req)

    def _collect_scheduler_failures(self):
        """Requests the scheduler failed on its own (pool exhaustion,
        preemption storm) still need to land in ``self.failed``."""
        for req in self._requests.values():
            if req.state is RequestState.FAILED and req not in self.failed:
                self.failed.append(req)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def _bucket(self, length: int) -> int:
        """Pad prompts to a power-of-two number of blocks (capped at the
        model max)."""
        nb = max(1, -(-length // self.block_size))
        nb = 1 << (nb - 1).bit_length()
        return min(nb, self.max_blocks) * self.block_size

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _sample_one(self, logits_row, req: Request) -> int:
        sp = req.sampling
        tok = sample_logits(logits_row[None], [sp.temperature], [sp.top_k],
                            [sp.top_p], [sp.seed], [len(req.output_tokens)])
        return int(tok[0])

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
        padded = np.zeros(P, np.int64)
        padded[:L] = tail
        pbt = None
        if npb:
            # prefix table padded to a power of two, as in the reference
            pbt = np.zeros(1 << (npb - 1).bit_length(), np.int32)
            pbt[:npb] = table[:npb]
            pbt = self._tensor(pbt)[None]
        view = PagedCacheView(self.cache.pool, self._tensor(bt)[None], None,
                              bs, prefix_block_tables=pbt, prefix_len=cached)
        positions = (cached + torch.arange(P, device=self.device))[None]
        logits = self.model(self._tensor(padded, torch.long)[None],
                            cache=view, positions=positions)
        tok = self._sample_one(logits[0, L - 1], req)
        self.prefill_calls += 1
        self.cache.commit_prefix(req.rid, toks)
        self._emit(slot, req, tok)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _run_decode(self):
        running = dict(self.scheduler.running)  # slot -> req snapshot
        S = self.max_slots
        tokens = np.zeros(S, np.int64)
        ctx = np.ones(S, np.int32)       # inactive: 1 garbage scratch token
        sids = [None] * S
        for slot, req in running.items():
            sids[slot] = req.rid
            tokens[slot] = (req.output_tokens[-1] if req.output_tokens
                            else req.prompt[-1])
            ctx[slot] = req.total_len - 1
        bt = self.cache.table_array(sids, self.max_blocks)
        t0 = time.monotonic()
        try:
            ctx_t = self._tensor(ctx)
            view = PagedCacheView(self.cache.pool, self._tensor(bt), ctx_t,
                                  self.block_size)
            logits = self.model(self._tensor(tokens, torch.long)[:, None],
                                cache=view, positions=ctx_t.long()[:, None])
            slots = sorted(running)
            sp = [running[s].sampling for s in slots]
            toks = sample_logits(
                logits[slots, -1], [p.temperature for p in sp],
                [p.top_k for p in sp], [p.top_p for p in sp],
                [p.seed for p in sp],
                [len(running[s].output_tokens) for s in slots]).tolist()
        except Exception as e:
            # the batched step died: its requests fail, the engine (and the
            # waiting queue) survives
            for slot in list(running):
                if slot in self.scheduler.running:
                    self._fail(slot, e)
            return
        finally:
            self.last_decode_s = time.monotonic() - t0
        self.decode_s += self.last_decode_s
        self.decode_tokens += len(toks)
        if self.prefix_cache:
            # a decode write that just filled its block completes another
            # full token block: index it so later admissions can share it
            for slot, req in running.items():
                if req.total_len % self.block_size == 0:
                    self.cache.commit_prefix(req.rid, req.prefill_tokens)
        for slot, tok in zip(slots, toks):
            self._emit(slot, running[slot], tok)

    def _emit(self, slot: int, req: Request, token: int):
        req.emit(token)
        self._total_generated += 1
        if self.eos_token_id is not None and token == self.eos_token_id:
            self._finish(slot, "stop")
        elif len(req.output_tokens) >= req.sampling.max_new_tokens:
            self._finish(slot, "length")

    def _finish(self, slot: int, reason: str):
        req = self.scheduler.running[slot]
        self.scheduler.finish(slot, reason)
        self.finished.append(req)


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
