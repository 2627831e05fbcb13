"""The port's tenancy primitives (``paddle_tpu_torch/serving/tenancy.py``)
against the JAX package's on the same calls:

- ``FairQueue``: the same appends, ``appendleft``s, removals and pops give
  the same order and the same served charges for DRR shares, an idle
  tenant, a drained tenant, one tenant (where both are also exactly a
  ``deque``), priority within a tenant and the resume stack;
- ``TokenBucket`` on a fake clock, ``TenantRegistry`` resolution, rate
  limiting, snapshots and JSON round trips (keys redacted);
- ``dollars_for`` at an explicit rate, ``TenantAccounting``'s summary, and
  the port's one deviation (R30): no built-in card-hour price, so no
  dollars until a rate is set;
- the cache's tenant quotas: an over-quota tenant's cached blocks evict
  first, on both caches.
"""
import collections
import random

import numpy as np
import pytest

from paddle_tpu.serving import PagedKVCache as JCache
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving import tenancy as jt
from paddle_tpu.serving.scheduler import Request as JRequest

from paddle_tpu_torch.serving import PagedKVCache, SamplingParams
from paddle_tpu_torch.serving import tenancy as tt
from paddle_tpu_torch.serving.scheduler import Request


class _Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _pair(rid, tenant="anonymous", priority=0, prompt_len=10, new=6):
    """The same request in both packages."""
    return tuple(R(rid=rid, prompt=[0] * prompt_len,
                   sampling=S(max_new_tokens=new), tenant=tenant,
                   priority=priority)
                 for R, S in ((JRequest, JSamplingParams),
                              (Request, SamplingParams)))


def _script(case, rng):
    """(op, args) sequences of one fairness property."""
    if case == "drr":
        ops = [("append", (t, 0, 10, 6)) for t in "abc" for _ in range(60)]
        return ops + [("popleft", ())] * 100
    if case == "idle":
        ops = [("append", (t, 0, 10, 6)) for t in "ab" for _ in range(60)]
        return ops + [("popleft", ())] * 80
    if case == "drained":
        ops = [("append", ("a", 0, 10, 6))]
        ops += [("append", ("b", 0, 10, 6))] * 7
        ops += [("popleft", ())] * 4 + [("append", ("a", 0, 10, 6))]
        return ops + [("popleft", ())] * 5
    if case == "priority":
        ops = [("append", ("a", p, 10, 6)) for p in (0, 0, 5, 5, 2, 0)]
        ops += [("append", ("b", p, 10, 6)) for p in (1, 0, 3)]
        return ops + [("popleft", ())] * 9
    if case == "resume":
        ops = [("append", ("b", 0, 10, 6)), ("appendleft", ("a", 0, 10, 6)),
               ("append", ("a", 0, 12, 4)), ("appendleft", ("c", 0, 3, 2))]
        return ops + [("popleft", ())] * 4
    # "single": one tenant under a random mix of every operation
    ops = []
    for _ in range(600):
        r = rng.random()
        if r < 0.45:
            ops.append(("append", ("anonymous", 0, rng.randrange(1, 30),
                                   rng.randrange(1, 20))))
        elif r < 0.6:
            ops.append(("appendleft", ("anonymous", 0, rng.randrange(1, 30),
                                       rng.randrange(1, 20))))
        elif r < 0.85:
            ops.append(("popleft", ()))
        else:
            ops.append(("remove", (rng.random(),)))
    return ops


@pytest.mark.parametrize("case", ["drr", "idle", "drained", "single",
                                  "priority", "resume"])
def test_fair_queue_order_is_the_reference_s(case):
    weights = {"a": 1.0, "b": 2.0, "c": 4.0}
    jq = jt.FairQueue(weight_fn=lambda t: weights.get(t, 1.0))
    tq = tt.FairQueue(weight_fn=lambda t: weights.get(t, 1.0))
    dq = collections.deque()                 # the single-tenant FIFO
    live, rid = [], 0
    for op, args in _script(case, random.Random(7)):
        if op in ("append", "appendleft"):
            jr, tr = _pair(rid, *args)
            rid += 1
            getattr(jq, op)(jr), getattr(tq, op)(tr), getattr(dq, op)(tr)
            live.append((jr, tr))
        elif op == "popleft":
            if not live:
                continue
            assert tq[0].rid == jq[0].rid
            jr, tr = jq.popleft(), tq.popleft()
            assert tr.rid == jr.rid
            if case == "single":
                assert dq.popleft() is tr
            live = [p for p in live if p[1] is not tr]
        else:                                 # remove
            if not live:
                continue
            jr, tr = live.pop(int(args[0] * len(live)))
            jq.remove(jr), tq.remove(tr)
            if case == "single":
                dq.remove(tr)
        assert [r.rid for r in tq] == [r.rid for r in jq]
        assert len(tq) == len(jq) and bool(tq) == bool(jq)
        assert tq.depths() == jq.depths()
        assert tq.served_cost == jq.served_cost
        if case == "single":
            assert list(tq) == list(dq)
    if case == "drr":
        # saturated at 1:2:4, the served charges converge to those weights
        s = tq.served_cost
        assert s["b"] / s["a"] == pytest.approx(2.0, rel=0.2)
        assert s["c"] / s["a"] == pytest.approx(4.0, rel=0.2)
    if case == "drained":
        assert tq._deficit == jq._deficit


def test_fair_queue_errors_match():
    for mod, (jr, tr) in ((jt, _pair(0)), (tt, _pair(0))):
        q = mod.FairQueue()
        q.append(jr if mod is jt else tr)
        with pytest.raises(ValueError):
            q.remove(_pair(1)[0 if mod is jt else 1])
        with pytest.raises(IndexError):
            mod.FairQueue().popleft()


def test_token_bucket_matches_on_a_fake_clock():
    jc, tc = _Clock(), _Clock()
    jb = jt.TokenBucket(10.0, 25.0, clock=jc)
    tb = tt.TokenBucket(10.0, 25.0, clock=tc)
    rng = np.random.RandomState(0)
    for _ in range(200):
        dt, cost = float(rng.exponential(0.3)), float(rng.randint(1, 40))
        jc.t += dt
        tc.t += dt
        assert tb.try_acquire(cost) == jb.try_acquire(cost)
        assert tb.level == jb.level
        assert tb.retry_after(cost) == jb.retry_after(cost)
    for mod in (jt, tt):
        with pytest.raises(ValueError):
            mod.TokenBucket(0.0)


def _registry(mod, clock):
    return mod.TenantRegistry([
        mod.Tenant("gold", weight=3.0, api_keys=("k-gold",),
                   rate_tokens_per_s=100.0, burst_tokens=200.0),
        {"name": "bronze", "weight": 1.0, "block_quota": 4,
         "api_keys": ["k-bronze"], "ttft_slo_s": 0.5}], clock=clock)


def test_registry_round_trips_and_resolution_match():
    jc, tc = _Clock(), _Clock()
    jr, tr = _registry(jt, jc), _registry(tt, tc)
    assert tr.to_dict() == jr.to_dict()
    red = tr.to_dict(keys=False)
    assert red == jr.to_dict(keys=False)
    assert all(d["api_keys"] == [] for d in red["tenants"])
    again = tt.TenantRegistry.from_dict(tr.to_dict(), clock=tc)
    assert again.to_dict() == tr.to_dict()
    for auth in ("Bearer k-gold", "k-bronze", " bearer  k-gold "):
        assert tr.resolve(auth) == jr.resolve(auth)
    for auth in (None, "", "Bearer nope"):
        with pytest.raises(jt.AuthError):
            jr.resolve(auth)
        with pytest.raises(tt.AuthError):
            tr.resolve(auth)
    assert tt.TenantRegistry().resolve(None) == "anonymous"
    assert tr.block_quotas() == jr.block_quotas() == {"bronze": 4}
    assert tr.names() == jr.names()
    assert tr.weight("stranger") == jr.weight("stranger") == 1.0
    for cost in (150, 80, 60, 300):
        jc.t += 0.2
        tc.t += 0.2
        assert tr.admit("gold", cost) == jr.admit("gold", cost)
        assert tr.admit("bronze", cost) == jr.admit("bronze", cost)
    assert tr.drain_bucket("gold") == jr.drain_bucket("gold")
    assert tr.drain_bucket("bronze") == jr.drain_bucket("bronze") is False
    assert tr.snapshot() == jr.snapshot()
    for mod in (jt, tt):
        with pytest.raises(ValueError):
            mod.TenantRegistry([mod.Tenant("a"), mod.Tenant("a")])
        with pytest.raises(ValueError):
            mod.Tenant("a", weight=0)


def test_dollars_for_matches_at_an_explicit_rate():
    for flops, nbytes in ((1e12, 1e9), (3.5e9, 7e10), (0.0, 0.0)):
        for rate in (2.5, 8.4):
            assert tt.dollars_for(flops, nbytes, rate_per_h=rate,
                                  peaks=tt.telemetry.cost.platform_peaks(
                                      "cpu")) == pytest.approx(
                jt.dollars_for(flops, nbytes, rate_per_h=rate), rel=1e-12)


def test_regression_r30_no_builtin_price(monkeypatch):
    """The port carries no built-in card-hour price: unpriced, no dollars;
    the environment variable or an explicit rate prices it."""
    monkeypatch.delenv("PADDLE_TPU_CHIP_DOLLARS_PER_H", raising=False)
    assert tt.dollars_for(1e12, 1e9) is None
    assert jt.dollars_for(1e12, 1e9) > 0           # the reference's default
    acct = tt.TenantAccounting(tt.TenantRegistry(), "r30")
    acct.note_cost("a", 1e9, 2e6)
    s = acct.summary()
    assert s["tenants"]["a"]["cost"]["dollars"] is None
    assert s["totals"]["dollars"] is None
    assert s["totals"]["flops"] == 1e9
    monkeypatch.setenv("PADDLE_TPU_CHIP_DOLLARS_PER_H", "3.0")
    cpu = tt.telemetry.cost.platform_peaks("cpu")
    assert tt.dollars_for(1e12, 1e9, peaks=cpu) == pytest.approx(
        jt.dollars_for(1e12, 1e9))
    priced = tt.TenantAccounting(tt.TenantRegistry(), "r30", peaks=cpu)
    priced.note_cost("a", 1e9, 2e6)
    assert priced.summary()["totals"]["dollars"] == pytest.approx(
        jt.dollars_for(1e9, 2e6))


def test_accounting_summary_matches(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHIP_DOLLARS_PER_H", "3.0")
    cpu = tt.telemetry.cost.platform_peaks("cpu")
    accts = (jt.TenantAccounting(jt.TenantRegistry(), "jacct"),
             tt.TenantAccounting(tt.TenantRegistry(), "tacct", peaks=cpu))
    for a in accts:
        a.note_request("a"), a.note_request("b"), a.note_request("a")
        a.note_admitted("a", 16), a.note_tokens("a", 5), a.note_tokens("b", 3)
        a.note_cost("a", 1e9, 2e6)
        a.note_cost("b", 3e9, 4e6)
        a.note_cost("b", 0.0, 0.0)
    js, ts = (a.summary() for a in accts)
    assert ts["totals"] == pytest.approx(js["totals"])
    for name in ("a", "b"):
        j, t = js["tenants"][name], ts["tenants"][name]
        assert {k: v for k, v in t.items() if k not in ("cost", "slo")} == \
            {k: v for k, v in j.items() if k not in ("cost", "slo")}
        assert t["cost"] == pytest.approx(j["cost"])
    assert ts["totals"]["flops"] == 4e9


def _caches(num_blocks=17, block_size=4):
    kw = dict(num_layers=1, num_blocks=num_blocks, kv_heads=1,
              block_size=block_size, head_dim=4, prefix_cache=True)
    return JCache(**kw), PagedKVCache(device="cpu", **kw)


def _park(cache, seq_id, tokens, tenant):
    assert cache.allocate(seq_id, len(tokens), tokens=tokens, tenant=tenant)
    cache.commit_prefix(seq_id, tokens)
    cache.free_seq(seq_id)


@pytest.mark.parametrize("quota", [1, 4, 0])
def test_quota_eviction_order_matches(quota):
    caches = _caches(num_blocks=9 if quota == 0 else 17)
    out = []
    for c in caches:
        c.set_tenant_quotas({"hog": quota})
        if quota == 0:
            # a live, indexed sequence of an over-quota tenant: nothing of
            # it is evictable
            toks = [40 + i for i in range(8)]
            assert c.allocate("live", 8, tokens=toks, tenant="hog")
            c.commit_prefix("live", toks)
            ok = c.allocate("big", 7 * 4)
        else:
            _park(c, "bg", [7 + i for i in range(8)], "bg")    # older
            _park(c, "hog", [40 + i for i in range(8)], "hog")
            ok = c.allocate("big", 13 * 4)
        out.append((ok, dict(c.quota_evictions), c.prefix_stats()["tenants"],
                    {k: list(v) for k, v in c.tables.items()}))
    assert out[1] == out[0]
    ok, evictions, tenants, _ = out[1]
    if quota == 1:
        assert ok and evictions == {"hog": 1}
        assert tenants["bg"]["cached_blocks"] == 2
    elif quota == 4:
        assert ok and evictions == {}
        assert tenants["bg"]["cached_blocks"] == 1
    else:
        assert ok is False and evictions == {}
