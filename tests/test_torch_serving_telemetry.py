"""The port's serving engine with its telemetry and fault sites wired in,
against the JAX package's engine on a tiny Llama with converted weights
and greedy decoding:

- the labelled ``serving_*`` / ``kv_prefix_*`` / ``slo_*`` families (names
  and label sets), their counts, the lifecycle span trees and the
  scheduler and KV flight events in order are the reference's;
- fault plans (``serving.prefill:error@2``, ``serving.kv.alloc:exhaust``,
  allocator exhaustion into the stall detector, ``serving.decode.slot``,
  ``serving.compile``) leave the requests in the reference's states;
- ``stats()`` has the reference's ``STATS_KEYS`` and keeps its shape with
  telemetry disabled;
- the roofline cost model: serving counts nothing; the first ``stats()``
  counts each step signature shape-only, and the engine's prefill and
  decode ``matmul_flops`` equal the reference's ``jaxpr_cost`` exactly
  (paged attention counted over the padded block table, as the
  reference's CPU route computes it), ``bytes`` differ by exactly the
  sampling parameters the reference's jitted step takes as device inputs
  (the port samples from host lists), and the decode estimate equals a
  count of the engine's own decode step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.telemetry as j_tel
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import llama_tiny as j_llama_tiny
from paddle_tpu.nn.layer import functional_state
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.engine import STATS_KEYS as J_STATS_KEYS
from paddle_tpu.utils import faults as j_faults

import paddle_tpu_torch.telemetry as t_tel
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny, state_from_jax
from paddle_tpu_torch.serving import LLMEngine, RequestState, SamplingParams
from paddle_tpu_torch.serving.engine import STATS_KEYS
from paddle_tpu_torch.utils import faults as t_faults

torch.set_num_threads(1)
CFG = dict(vocab=61, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           seq=64)
FAMILIES = ("serving_", "kv_prefix_", "slo_")


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(0)
    jm = JLlama(j_llama_tiny(**CFG))
    params, _ = functional_state(jm)
    tm = LlamaForCausalLM(llama_tiny(**CFG), device="cpu")
    tm.load_state_dict(state_from_jax({k: np.asarray(v)
                                       for k, v in params.items()}))
    return jm, tm


def _prompts(seed=1):
    rng = np.random.RandomState(seed)
    shared = list(rng.randint(0, 61, 16))
    return [shared + list(rng.randint(0, 61, 5)), list(rng.randint(0, 61, 9)),
            shared + list(rng.randint(0, 61, 3)),
            list(rng.randint(0, 61, 30))]


def _engines(models, **kw):
    jm, tm = models
    kw = {"block_size": 8, "max_slots": 2, "max_model_len": 64,
          "num_blocks": 9, **kw}
    return JEngine(jm, **kw), LLMEngine(tm, **kw)


def _families(tel):
    return {m.name: (m.kind, m.label_names)
            for m in tel.registry().metrics()
            if m.name.startswith(FAMILIES)}


def _series(tel, label):
    out = {}
    for m in tel.registry().metrics():
        if not m.name.startswith("serving_"):
            continue
        for labels, ch in m.series():
            if labels.get("engine") != label:
                continue
            key = (m.name, tuple(sorted(labels.items())))
            out[key] = ch.count if m.kind == "histogram" else ch.value
    return out


def _lifecycle(tel, label):
    spans = [s for s in tel.tracer().spans()
             if s.attrs.get("engine") == label
             and s.name in ("request", "queued", "prefill", "decode")]
    by_id = {s.span_id: s for s in spans}
    return sorted((s.attrs["rid"], s.name, s.attrs.get("state"),
                   s.attrs.get("tokens"),
                   by_id[s.parent_id].name if s.parent_id in by_id else None)
                  for s in spans)


def _events(tel):
    return [{k: v for k, v in e.items() if k not in ("seq", "t", "wall")}
            for e in tel.flight().events()
            if e["kind"].startswith(("scheduler.", "kv."))]


def _serve(eng, sp_cls, prompts, max_new=8):
    reqs = [eng.add_request(p, sp_cls(max_new_tokens=max_new))
            for p in prompts]
    eng.run()
    return reqs


def _states(reqs):
    return [(r.state.value, r.finish_reason, len(r.output_tokens),
             type(r.error).__name__ if r.error else None,
             getattr(r.error, "site", None)) for r in reqs]


def test_families_counts_spans_and_events_are_the_reference_s(models):
    je, te = _engines(models)
    j_tel.flight().clear()
    t_tel.flight().clear()
    jr = _serve(je, JSamplingParams, _prompts())
    tr = _serve(te, SamplingParams, _prompts())
    assert [r.output_tokens for r in tr] == [r.output_tokens for r in jr]
    assert _families(t_tel) == _families(j_tel)
    # the port counts a step signature's roofline estimate when the
    # roofline is read (off the request path), and publishes
    # serving_roofline_frac from then on
    te.stats()
    jser = {(k[0], tuple(x for x in k[1] if x[0] != "engine")): v
            for k, v in _series(j_tel, je.engine_label).items()}
    tser = {(k[0], tuple(x for x in k[1] if x[0] != "engine")): v
            for k, v in _series(t_tel, te.engine_label).items()}
    assert set(tser) == set(jser)
    for k in jser:
        if k[0] in ("serving_roofline_frac",):
            continue
        assert tser[k] == pytest.approx(jser[k]), k
    assert tser[("serving_requests_finished_total", ())] == 4
    assert tser[("serving_preemptions_total", ())] >= 1
    assert _lifecycle(t_tel, te.engine_label) == \
        _lifecycle(j_tel, je.engine_label)
    assert _events(t_tel) == _events(j_tel)
    kinds = {e["kind"] for e in _events(t_tel)}
    assert {"scheduler.admit", "scheduler.preempt", "kv.alloc", "kv.free",
            "kv.share", "kv.evict"} <= kinds
    # the Prometheus text carries the engine's series equal to stats()
    st = te.stats()
    text = t_tel.prometheus_text()
    lab = te.engine_label
    assert (f'serving_generated_tokens_total{{engine="{lab}"}} '
            f'{st["total_generated_tokens"]}') in text
    assert st["num_finished"] == 4 and st["total_generated_tokens"] == 32


@pytest.mark.parametrize("plan", [
    "serving.prefill:error@2",
    "serving.kv.alloc:exhaust",
    "serving.kv.alloc:exhaust@2x3",
    "serving.decode.slot:error@3",
    "serving.decode:error@2",
    "serving.kv.share:stale_hash@3",
    "serving.kv.cow:exhaust%0.3",
    "serving.admit:error@4",
    "serving.compile:error@2",
])
def test_fault_plans_leave_the_reference_s_states(models, plan):
    je, te = _engines(models)
    with j_faults.FaultPlan.parse(plan, seed=3) as jp:
        try:
            jr = _serve(je, JSamplingParams, _prompts())
        except j_faults.FaultError as e:       # the admission site raises
            jr = e.site
    with t_faults.FaultPlan.parse(plan, seed=3) as tp:
        try:
            tr = _serve(te, SamplingParams, _prompts())
        except t_faults.FaultError as e:
            tr = e.site
    assert [(f.site, f.hit, f.kind) for f in tp.fired] == \
        [(f.site, f.hit, f.kind) for f in jp.fired]
    if isinstance(jr, str):
        assert tr == jr
        return
    assert _states(tr) == _states(jr)
    for a, b in zip(tr, jr):
        if a.state is RequestState.FINISHED:
            assert a.output_tokens == b.output_tokens
    assert te.stats()["blocks_used"] == 0


def test_prefill_fault_fails_only_request_2(models):
    _, te = _engines(models)
    clean = _serve(LLMEngine(models[1], block_size=8, max_slots=2,
                             max_model_len=64), SamplingParams, _prompts())
    t_tel.flight().clear()
    with t_faults.FaultPlan.parse("serving.prefill:error@2"):
        reqs = _serve(te, SamplingParams, _prompts())
    assert reqs[1].state is RequestState.FAILED
    assert isinstance(reqs[1].error, t_faults.FaultError)
    for i in (0, 2, 3):
        assert reqs[i].output_tokens == clean[i].output_tokens
    ev = t_tel.flight().events("fault.injected")
    assert [(e["site"], e["hit"]) for e in ev] == [("serving.prefill", 2)]


def test_stall_detector_dumps_the_flight_ring(models, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    je, te = _engines(models, stall_limit=3)
    with j_faults.FaultPlan.parse("serving.kv.alloc:exhaust@1x*"):
        jr = _serve(je, JSamplingParams, _prompts()[:2], max_new=4)
    with t_faults.FaultPlan.parse("serving.kv.alloc:exhaust@1x*"):
        tr = _serve(te, SamplingParams, _prompts()[:2], max_new=4)
    assert _states(tr) == _states(jr)
    assert all(r.finish_reason == "stalled" for r in tr)
    assert t_tel.flight().last_dump_path and \
        str(tmp_path) in t_tel.flight().last_dump_path
    assert te.stats()["num_failed"] == 2


def test_watchdog_and_stats_keys(models):
    je, te = _engines(models, watchdog_timeout_s=0.0)
    _serve(je, JSamplingParams, _prompts()[:2], max_new=4)
    _serve(te, SamplingParams, _prompts()[:2], max_new=4)
    st, jst = te.stats(), je.stats()
    assert STATS_KEYS == J_STATS_KEYS == set(st)
    assert st["watchdog_trips"] == jst["watchdog_trips"] > 0
    assert st["decode_traces"] == 1
    assert st["prefill_traces"] == jst["prefill_traces"]
    assert set(st["slo"]) == set(jst["slo"])
    assert st["slo"]["ttft"]["p99"] is not None
    perf = st["perf"]
    assert set(perf) == set(jst["perf"])
    # the watcher is process-global: other engines' signatures are there
    assert perf["compiles"]["callables"]["engine.decode"]["compiles"] >= 1
    assert (("tokens", (2,), "int32"), ("block_tables", (2, 8), "int32")) \
        in t_tel.compile_watcher().signatures("engine.decode")
    assert perf["memory"]["tags"]["kv_pool"]["live_bytes"] >= \
        te.cache.pool.nbytes           # the monitor is process-global
    assert perf["decode_step"]["steps"] >= 3
    t_tel.disable()
    try:
        off = te.stats()
    finally:
        t_tel.enable()
    assert set(off) == STATS_KEYS and off["num_finished"] == 2
    te.close()
    assert t_tel.memory_monitor().live("kv_pool") >= 0


def test_lifecycle_chrome_export(models, tmp_path):
    import json

    _, te = _engines(models)
    t_tel.tracer().clear()
    _serve(te, SamplingParams, _prompts(), max_new=4)
    path = t_tel.tracer().export_chrome(str(tmp_path / "t.json"))
    evs = json.load(open(path))["traceEvents"]
    roots = [e for e in evs if e["name"] == "request"
             and e["args"]["engine"] == te.engine_label]
    assert len(roots) == 4
    for root in roots:
        kids = {e["name"] for e in evs
                if e.get("args", {}).get("parent_id")
                == root["args"]["span_id"]}
        assert kids == {"queued", "prefill", "decode"}


# ---------------------------------------------------------------------------
# roofline cost model
# ---------------------------------------------------------------------------

def test_step_costs_equal_the_reference_s_jaxpr_cost(models):
    # fresh registries: the reference's fingerprint leaves the pool's size
    # out (R29), so an earlier engine of another pool would answer its
    # lookup with that pool's bytes
    j_tel.cost.clear()
    t_tel.cost.clear()
    je, te = _engines(models, num_blocks=None, max_model_len=64)
    prompts = [list(np.random.RandomState(2).randint(0, 61, n))
               for n in (5, 9, 20)]
    out = te.generate(prompts, SamplingParams(max_new_tokens=6))
    assert out == je.generate(prompts, JSamplingParams(max_new_tokens=6))
    # serving counted nothing: the estimates wait for the roofline's read
    assert not [e for e in t_tel.cost.traces()
                if e["fingerprint"] == te._cost_fp]
    roof = te.stats()["perf"]["roofline"]
    ref = {(e["callable"], e["bucket"]): e for e in j_tel.cost.traces()
           if e.get("engine") == je.engine_label
           or e["fingerprint"] == je._cost_fp}
    got = {(e["callable"], e["bucket"]): e for e in t_tel.cost.traces()
           if e["fingerprint"] == te._cost_fp}
    assert set(got) == set(ref) and ("engine.decode", "decode") in got
    S = te.max_slots
    for key, e in got.items():
        r = ref[key]
        assert e["matmul_flops"] == r["matmul_flops"] > 0, key
        # the reference's step also takes its sampling parameters as
        # device inputs: six int32/f32 scalars a prefill (length, temp,
        # top_k, top_p, seed, step; a tail prefill's prefix length too),
        # five [slots] arrays a decode
        extra = (5 * 4 * S if key[0] == "engine.decode"
                 else 7 * 4 if "NPB" in key[1] else 6 * 4)
        assert e["bytes"] + extra == r["bytes"], key
        assert e["output_bytes"] == r["output_bytes"], key
    dec = got[("engine.decode", "decode")]
    assert dec["kernels"] == {"rmsnorm_fwd": 2 * CFG["layers"] + 1,
                              "paged_attention": CFG["layers"]}
    # the shape-only count equals a count of the engine's own decode step
    S, M = te.max_slots, te.max_blocks
    with torch.inference_mode():
        live, _ = t_tel.cost.measure(
            te._decode_step, torch.zeros(S, dtype=torch.int32),
            torch.zeros(S, M, dtype=torch.int32),
            torch.ones(S, dtype=torch.int32),
            ([0.0] * S, [0] * S, [1.0] * S, [0] * S, [0] * S),
            inputs=te._cost_inputs + [te.cache.pool],
            outputs=[te.cache.pool])
    for k in ("flops", "matmul_flops", "bytes", "kernels"):
        assert live[k] == dec[k], k
    assert roof["decode"]["buckets"]["decode"]["bytes"] == dec["bytes"]
    assert roof["serving_roofline_frac"] is not None
    assert 0 < roof["serving_roofline_frac"]


@pytest.mark.parametrize("layers", [1, 3])
def test_shape_only_estimate_equals_a_live_count(layers):
    """The estimate counted on twins of 1 and 2 layers, extended to the
    model's depth, equals a count of the engine's own steps at that depth:
    a decode step and a tail prefill."""
    from paddle_tpu_torch.serving.engine import _prefill_forward

    cfg = llama_tiny(vocab=61, hidden=32, layers=layers, heads=4,
                     kv_heads=2, inter=64, seq=64)
    torch.manual_seed(0)
    te = LLMEngine(LlamaForCausalLM(cfg, device="cpu"), block_size=8,
                   max_slots=2, max_model_len=64)
    S, M, bs, i32 = te.max_slots, te.max_blocks, te.block_size, torch.int32
    kw = dict(inputs=te._cost_inputs + [te.cache.pool],
              outputs=[te.cache.pool])
    with torch.inference_mode():
        live = {
            "decode": t_tel.cost.measure(
                te._decode_step, torch.zeros(S, dtype=i32),
                torch.zeros(S, M, dtype=i32), torch.ones(S, dtype=i32),
                ([0.0] * S, [0] * S, [1.0] * S, [0] * S, [0] * S), **kw)[0],
            "prefill": t_tel.cost.measure(
                lambda *a: _prefill_forward(
                    te.model, te.cache.pool, bs, *a, 8, 11,
                    SamplingParams(), 0),
                torch.zeros(16, dtype=i32), torch.zeros(2, dtype=i32),
                torch.zeros(1, dtype=i32), **kw)[0]}
    est = {"decode": te._count_step("decode", ()),
           "prefill": te._count_step("prefill", (16, 1, 8, 11))}
    for kind in live:
        for k in ("flops", "matmul_flops", "elementwise_flops", "bytes",
                  "kernels"):
            assert est[kind][k] == live[kind][k], (kind, k)
    assert est["decode"]["kernels"] == {"rmsnorm_fwd": 2 * layers + 1,
                                        "paged_attention": layers}
