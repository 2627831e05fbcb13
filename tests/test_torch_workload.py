"""The port's workload engine (``paddle_tpu_torch/serving/workload.py``)
against the JAX package's: every preset and a custom spec generate the same
arrivals, phases, lengths, tenants, prompts and ``fingerprint()`` in both
packages (one ``numpy.random.RandomState`` draw order), the JSON round trip
and the validation errors match, and ``OpenLoopRunner`` /
``ClosedLoopRunner`` / ``summarize`` over a fake ``submit`` give the
reference's outcomes and summary (the host-clock fields aside)."""
import threading
import time

import pytest

from paddle_tpu.serving import workload as jw

from paddle_tpu_torch.serving import workload as tw


def _custom(mod, **kw):
    base = dict(
        name="custom", seed=11, requests=40, vocab=64,
        arrival={"kind": "bursty", "calm_qps": 4.0, "burst_qps": 40.0,
                 "mean_calm_s": 1.0, "mean_burst_s": 0.5},
        prompt_len={"kind": "zipf", "alpha": 1.5, "min": 2, "max": 48},
        output_len={"kind": "uniform", "min": 1, "max": 24},
        tenants=[{"name": "a", "weight": 1.0}, {"name": "b", "weight": 3.0}],
        prefix={"share": 0.4, "groups": 2})
    base.update(kw)
    return mod.WorkloadSpec(**base)


@pytest.mark.parametrize("name", sorted(jw.PRESETS) + ["custom", "diurnal64",
                                                       "truncated"])
def test_generate_matches_the_reference(name):
    if name == "custom":
        specs = (_custom(jw), _custom(tw))
        kw = {}
    elif name == "diurnal64":
        specs = tuple(_custom(m, arrival={"kind": "diurnal", "mean_qps": 6.0,
                                          "depth": 0.9, "period_s": 3.0},
                              prompt_len={"kind": "fixed", "value": 9})
                      for m in (jw, tw))
        kw = {}
    elif name == "truncated":
        specs = (jw.preset("tenant-mix"), tw.preset("tenant-mix"))
        kw = {"max_model_len": 40}
    else:
        specs = (jw.preset(name), tw.preset(name))
        kw = {}
    assert specs[1].to_json() == specs[0].to_json()
    jl, tl = jw.generate(specs[0], **kw), tw.generate(specs[1], **kw)
    assert tl.to_jsonable() == jl.to_jsonable()
    assert tl.fingerprint() == jl.fingerprint()
    assert (tl.duration_s, tl.offered_qps) == (jl.duration_s, jl.offered_qps)
    for r in tl:
        assert len(r.prompt) >= 1 and r.max_new_tokens >= 1
        if kw:
            assert len(r.prompt) + r.max_new_tokens <= kw["max_model_len"]
    again = tw.generate(tw.WorkloadSpec.from_json(specs[1].to_json()), **kw)
    assert again.fingerprint() == tl.fingerprint()


def test_tenant_mix_schedule_shape():
    wl = tw.generate(tw.preset("tenant-mix"))
    tenants = [r.tenant for r in wl]
    assert tenants.count("gold") > tenants.count("silver") > \
        tenants.count("bronze") > 0
    groups = {}
    for r in wl:
        if r.group >= 0:
            groups.setdefault(r.group, []).append(r.prompt)
    assert len(groups) == 3
    for prompts in groups.values():        # a group's prompts share a head
        assert len({p[0] for p in prompts}) == 1


@pytest.mark.parametrize("bad", [
    {"arrival": {"kind": "nope"}},
    {"prompt_len": {"kind": "nope"}},
    {"mode": "sideways"},
    {"requests": 0},
    {"tenants": [{"name": "a", "weight": 0}]},
    {"prefix": {"share": 1.5, "groups": 1}},
    {"prompt_len": {"kind": "zipf", "alpha": 0.9}},
])
def test_validation_matches(bad):
    msgs = []
    for mod in (jw, tw):
        with pytest.raises(mod.WorkloadError) as e:
            mod.generate(_custom(mod, **bad))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    with pytest.raises(tw.WorkloadError):
        tw.WorkloadSpec.from_dict({"name": "x", "unknown": 1})
    with pytest.raises(tw.WorkloadError):
        tw.load_spec("no-such-preset-or-file")


def _submit(wreq):
    if wreq.index % 4 == 0:
        raise RuntimeError("admission refused")
    if wreq.index % 4 == 1:
        return lambda: {"outcome": "failed", "ttft": None, "tokens": 0,
                        "error": "boom"}
    ttft = 0.01 if wreq.index % 4 == 2 else 9.0
    return lambda: {"outcome": "ok", "ttft": ttft,
                    "tokens": wreq.max_new_tokens}


_CLOCK_FIELDS = ("latency_p99", "sched_lag_p99")


def test_open_loop_runner_and_summary_match():
    outs = []
    for mod in (jw, tw):
        spec = _custom(mod, requests=16,
                       arrival={"kind": "uniform", "rate_qps": 400.0})
        res = mod.OpenLoopRunner(mod.generate(spec), _submit,
                                 max_wait_s=10).run()
        outs.append((res, mod.summarize(res, slo={"ttft_s": 1.0})))
    (jres, js), (tres, ts) = outs
    assert [(r.index, r.tenant, r.phase, r.outcome, r.ttft_s, r.tokens,
             r.error) for r in tres] == \
        [(r.index, r.tenant, r.phase, r.outcome, r.ttft_s, r.tokens,
          r.error) for r in jres]
    assert {k: v for k, v in ts.items() if k not in _CLOCK_FIELDS} == \
        {k: v for k, v in js.items() if k not in _CLOCK_FIELDS}
    assert ts["outcomes"] == {"shed": 4, "failed": 4, "ok": 8}
    assert ts["goodput_requests"] == 4


def test_summarize_matches_on_fixed_results():
    rows = [dict(index=i, tenant="a" if i % 2 else "b",
                 phase=("calm", "burst")[i % 3 == 0], at_s=0.1 * i,
                 submitted_at_s=0.1 * i + 0.001, sched_lag_s=0.001 * i,
                 outcome=("ok", "ok", "failed", "shed", "lost")[i % 5],
                 ttft_s=0.05 * i, latency_s=0.2 + 0.05 * i,
                 tokens=1 + i % 7) for i in range(23)]
    for slo in (None, {"ttft_s": 0.6}, {"ttft_s": 0.9, "tpot_s": 0.02}):
        js = jw.summarize([jw.RequestResult(**r) for r in rows], slo=slo)
        ts = tw.summarize([tw.RequestResult(**r) for r in rows], slo=slo)
        assert ts == js


def test_closed_loop_bounds_concurrency():
    spec = _custom(tw, requests=24, mode="closed",
                   closed={"concurrency": 3, "think_time_s": 0.0})
    lock = threading.Lock()
    state = {"cur": 0, "peak": 0}

    def submit(wreq):
        with lock:
            state["cur"] += 1
            state["peak"] = max(state["peak"], state["cur"])

        def finish():
            time.sleep(0.002)
            with lock:
                state["cur"] -= 1
            return {"outcome": "ok", "ttft": 0.001, "tokens": 1}
        return finish

    res = tw.ClosedLoopRunner(tw.generate(spec), submit, max_wait_s=30).run()
    assert len(res) == 24 and 1 <= state["peak"] <= 3
    assert tw.summarize(res)["outcomes"] == {"ok": 24}
