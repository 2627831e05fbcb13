"""The port's engine with tenancy, deadlines, KV watermarks and the host
spill tier, against the JAX package's engine on the reference tests' tiny
Llama (2 layers, hidden 32, vocab 61, GQA 4 / 2) with converted weights
and greedy decoding:

- three tenants (weights 3 / 2 / 1, a cached-block quota on one) over a
  pool small enough to spill and promote, with watermarks: the same
  streams as the reference's and as a cache-off engine, the same spill /
  promote / quota counters, pressure latches and ``stats()["tenancy"]``
  counters; per-tenant flops sum to the engine's own step total;
- a queued deadline ends the request before any prefill; a mid-decode one
  (a ``serving.decode:delay`` fault plan stalls one step past it) cancels
  it with the reference's token count;
- a held pool forces the ``kv_watermark`` shed in ``stats()["slo"]``;
- corrupt promotions never change tokens;
- ``set(stats()) == STATS_KEYS == J_STATS_KEYS``; the watermark callback
  and priority within a tenant behave as the reference's.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import llama_tiny as j_llama_tiny
from paddle_tpu.nn.layer import functional_state
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.engine import STATS_KEYS as J_STATS_KEYS
from paddle_tpu.utils import faults as j_faults

import paddle_tpu_torch.telemetry as t_tel
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny, state_from_jax
from paddle_tpu_torch.serving import (STATS_KEYS, DeadlineExceeded, LLMEngine,
                                      RequestState, SamplingParams)
from paddle_tpu_torch.utils import faults as t_faults

torch.set_num_threads(1)
CFG = dict(vocab=61, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           seq=128)
TENANCY = {"tenants": [{"name": "gold", "weight": 3.0},
                       {"name": "silver", "weight": 2.0},
                       {"name": "bronze", "weight": 1.0, "block_quota": 1}]}
ENGINE = dict(block_size=8, max_slots=2, max_model_len=32)


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(0)
    jm = JLlama(j_llama_tiny(**CFG))
    params, _ = functional_state(jm)
    tm = LlamaForCausalLM(llama_tiny(**CFG), device="cpu")
    tm.load_state_dict(state_from_jax({k: np.asarray(v)
                                       for k, v in params.items()}))
    return jm, tm


def _waves(seed):
    """Seed two shared-prefix prompts, flood the pool with three unrelated
    ones (the cached prefix spills), then rematch the prefix (promotes)."""
    rng = np.random.RandomState(seed)
    shared = list(rng.randint(0, 61, 16))
    mk = lambda: shared + list(rng.randint(0, 61, 8))  # noqa: E731
    return [[mk() for _ in range(2)],
            [list(rng.randint(0, 61, 24)) for _ in range(3)],
            [mk() for _ in range(2)]]


TENANTS = ["gold", "bronze", "silver", "bronze", "gold", "bronze", "silver"]


def _serve(eng, sp_cls, waves, **add):
    reqs, i = [], 0
    for wave in waves:
        for p in wave:
            reqs.append(eng.add_request(p, sp_cls(max_new_tokens=8),
                                        tenant=TENANTS[i % len(TENANTS)],
                                        **add))
            i += 1
        eng.run()
    return reqs


SPILL = dict(num_blocks=11, kv_spill_blocks=16, kv_high_watermark=0.9,
             kv_low_watermark=0.6, tenancy=TENANCY)


def _tenant_counts(st):
    return {t: {k: v[k] for k in ("requests", "finished", "failed",
                                  "generated_tokens", "admitted_tokens")}
            for t, v in st["tenancy"]["tenants"].items()}


def test_streams_and_counters_under_tenancy_spill_and_watermarks(models):
    jm, tm = models
    je, te = JEngine(jm, **ENGINE, **SPILL), LLMEngine(tm, **ENGINE, **SPILL)
    jr = _serve(je, JSamplingParams, _waves(0))
    tr = _serve(te, SamplingParams, _waves(0))
    off = _serve(LLMEngine(tm, **ENGINE, prefix_cache=False), SamplingParams,
                 _waves(0))
    assert [r.output_tokens for r in tr] == [r.output_tokens for r in jr] \
        == [r.output_tokens for r in off]
    assert all(r.state is RequestState.FINISHED for r in tr)
    js, ts = je.stats(), te.stats()
    assert ts["prefix_cache"]["spill"] == js["prefix_cache"]["spill"]
    assert ts["prefix_cache"]["tenants"] == js["prefix_cache"]["tenants"]
    spill = ts["prefix_cache"]["spill"]
    assert spill["spills"] > 0 and spill["promotes"] > 0
    assert te.scheduler.num_pressure_events == \
        je.scheduler.num_pressure_events
    assert _tenant_counts(ts) == _tenant_counts(js)
    assert set(ts["tenancy"]["tenants"]) == {"gold", "silver", "bronze"}
    assert te._mm.peak("kv_spill_host") > 0
    # attribution: every tenant charged, the sum the engine's step total
    ten = ts["tenancy"]["tenants"]
    total = sum(n * te._trace_costs[k]["flops"]
                for k, n in te.steps_run.items())
    assert all(ten[t]["cost"]["flops"] > 0 for t in ten)
    assert sum(ten[t]["cost"]["flops"] for t in ten) == pytest.approx(
        total, rel=1e-9)
    assert ts["tenancy"]["totals"]["flops"] == pytest.approx(total, rel=1e-9)
    assert ts["tenancy"]["totals"]["dollars"] is None or \
        ts["tenancy"]["totals"]["dollars"] > 0


def test_queued_deadline_fails_before_prefill(models):
    out = []
    for eng, sp in ((JEngine(models[0], **ENGINE), JSamplingParams),
                    (LLMEngine(models[1], **ENGINE), SamplingParams)):
        req = eng.add_request(list(range(1, 9)), sp(max_new_tokens=4),
                              deadline_s=1e-4)
        time.sleep(0.005)
        admitted = eng.scheduler.admit()
        out.append((admitted, req.state.value, req.finish_reason,
                    type(req.error).__name__, req.admit_time,
                    req in eng.cancelled, eng.stats()["num_cancelled"]))
    assert out[1] == out[0] == ([], "cancelled", "deadline",
                                "DeadlineExceeded", None, True, 1)


def test_mid_decode_deadline(models):
    out = []
    for eng, sp, fp in ((JEngine(models[0], **ENGINE), JSamplingParams,
                         j_faults),
                        (LLMEngine(models[1], **ENGINE), SamplingParams,
                         t_faults)):
        eng.generate([list(range(1, 9))], sp(max_new_tokens=6))  # warm-up
        with fp.FaultPlan.parse("serving.decode:delay=1.0@3"):
            req = eng.add_request(list(range(2, 10)), sp(max_new_tokens=16),
                                  deadline_s=0.6)
            other = eng.add_request(list(range(3, 11)), sp(max_new_tokens=6))
            eng.run()
        out.append((req.state.value, req.finish_reason,
                    type(req.error).__name__, len(req.output_tokens),
                    other.state.value, other.output_tokens))
    assert out[1] == out[0]
    assert out[1][:4] == ("cancelled", "deadline", "DeadlineExceeded", 4)
    assert isinstance(req.error, DeadlineExceeded)


def test_kv_watermark_shed(models):
    out = []
    for M, eng_cls in zip(models, (JEngine, LLMEngine)):
        eng = eng_cls(M, **ENGINE, num_blocks=11, kv_high_watermark=0.7,
                      kv_low_watermark=0.4)
        assert eng.cache.allocate("hog", 8 * 8)      # 8 / 10 > 0.7
        held = eng.stats()["slo"]
        eng.cache.free_seq("hog")
        freed = eng.stats()["slo"]
        out.append([(s["shed"], s["healthy"], s["shed_reason"])
                    for s in (held, freed)])
    assert out[1] == out[0] == [(True, False, "kv_watermark"),
                                (False, True, None)]
    text = t_tel.prometheus_text()
    assert "serving_kv_pressure_events_total" in text


def test_corrupt_promotions_never_change_tokens(models):
    jm, tm = models
    kw = dict(**ENGINE, num_blocks=11, kv_spill_blocks=16)
    with j_faults.FaultPlan.parse("serving.kv.promote:corrupt@1x*"):
        je = JEngine(jm, **kw)
        jr = _serve(je, JSamplingParams, _waves(1))
    with t_faults.FaultPlan.parse("serving.kv.promote:corrupt@1x*"):
        te = LLMEngine(tm, **kw)
        tr = _serve(te, SamplingParams, _waves(1))
    off = _serve(LLMEngine(tm, **ENGINE, prefix_cache=False), SamplingParams,
                 _waves(1))
    assert [r.output_tokens for r in tr] == [r.output_tokens for r in jr] \
        == [r.output_tokens for r in off]
    spill = te.stats()["prefix_cache"]["spill"]
    assert spill == je.stats()["prefix_cache"]["spill"]
    assert spill["promote_corrupt_drops"] > 0 and spill["promotes"] == 0


def test_stats_keys_watermark_callback_and_priority(models):
    got = []
    for M, eng_cls, sp in ((models[0], JEngine, JSamplingParams),
                           (models[1], LLMEngine, SamplingParams)):
        eng = eng_cls(M, block_size=8, max_slots=1, max_model_len=32,
                      tenancy=TENANCY)
        marks = []
        reqs = [eng.add_request([5, 6, 7], sp(max_new_tokens=5),
                                tenant="gold", priority=p,
                                on_watermark=lambda r, n: marks.append(
                                    (r.rid, n)), watermark_every=2)
                for p in (0, 3, 1)]
        eng.run()
        order = sorted(reqs, key=lambda r: r.admit_time)
        st = eng.stats()
        got.append(([r.rid for r in order], marks, set(st),
                    set(st["tenancy"]), set(st["tenancy"]["tenants"]["gold"]),
                    set(st["tenancy"]["totals"])))
    assert got[1] == got[0]
    assert got[1][0] == [1, 2, 0]          # priority 3, 1, 0 in one tenant
    assert got[1][2] == STATS_KEYS == J_STATS_KEYS
    t_tel.disable()
    try:
        off = LLMEngine(models[1], **ENGINE, tenancy=TENANCY)
        off.generate([[1, 2, 3]], SamplingParams(max_new_tokens=2))
        st = off.stats()
    finally:
        t_tel.enable()
    assert set(st) == STATS_KEYS
    assert st["tenancy"]["tenants"]["anonymous"]["generated_tokens"] == 2
