"""The port's host spill tier, tenant quotas and KV watermarks
(``paddle_tpu_torch/serving/kv_cache.py``, ``scheduler.py``) against the
JAX package's:

- the reference's randomized storm (allocate / extend / copy-on-write /
  fork / free, tiny vocabulary so chains collide and promotions happen)
  replayed op for op on both caches, with and without injected spill,
  promote and allocator faults: every result, block table, refcount and
  spill / promote / eviction / quota counter equal after every step, and
  the port's partition invariant (every block free, referenced or cached;
  the spill pool bounded) holds throughout;
- a promoted block holds exactly the bytes that were spilled (bf16 too,
  whose host copy is its int16 view), and the failure paths (spill error,
  corrupt spill caught by the CRC, corrupt / failed promotion, a dry pool)
  leave both caches in the same state;
- the watermark latch's hysteresis, admission under pressure and the
  watermark validation, on both schedulers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import PagedKVCache as JCache
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.scheduler import Request as JRequest
from paddle_tpu.serving.scheduler import Scheduler as JScheduler
from paddle_tpu.utils import faults as j_faults

from paddle_tpu_torch.serving import PagedKVCache, SamplingParams
from paddle_tpu_torch.serving.scheduler import Request, Scheduler
from paddle_tpu_torch.utils import faults as t_faults


def _caches(num_blocks=13, block_size=4, spill_blocks=8, dtype=None):
    kw = dict(num_layers=2, num_blocks=num_blocks, kv_heads=1,
              block_size=block_size, head_dim=4, prefix_cache=True,
              spill_blocks=spill_blocks)
    return (JCache(**kw),
            PagedKVCache(device="cpu", dtype=dtype or torch.float32, **kw))


def _state(c):
    a = c.allocator
    st = c.prefix_stats()
    return ({k: list(v) for k, v in c.tables.items()},
            sorted(a._free), dict(a._rc), sorted(a._cached), list(c._lru),
            sorted(c._spill), dict(c.quota_evictions), st["spill"],
            st["tenants"], st["hits"], st["misses"], st["evictions"],
            st["cow_copies"], st["stale_drops"], dict(c.seq_cached_tokens))


def _check_invariants(c):
    a = c.allocator
    free, cached = set(a._free), set(a._cached)
    live = {b for b, rc in a._rc.items() if rc > 0}
    assert not (free & set(a._rc)) and not (live & cached)
    assert live | cached | free == set(range(1, a.num_blocks))
    assert len(a._free) == len(free)
    counts = {}
    for t in c.tables.values():
        for b in t:
            counts[b] = counts.get(b, 0) + 1
    assert counts == {b: rc for b, rc in a._rc.items() if rc > 0}
    assert set(c._lru) == cached
    assert len(c._spill) <= c.spill_blocks
    for key, e in c._spill.items():
        assert e.key == key and e.kv.shape[0] == c.pool.shape[0]
    assert c.spilled_bytes == len(c._spill) * c._block_nbytes


def _storm(caches, rng, n_ops, vocab=3, bs=4, ops=None):
    live = {}
    next_id = 0
    ops = ops or ["admit", "free", "extend", "write", "fork"]
    for _ in range(n_ops):
        op = rng.choice(ops)
        if op == "admit" or not live:
            n = int(rng.randint(1, 3 * bs + 2))
            toks = [int(t) for t in rng.randint(0, vocab, n)]
            sid = f"s{next_id}"
            next_id += 1
            oks = [c.allocate(sid, n, tokens=toks, tenant=f"t{n % 3}")
                   for c in caches]
            assert oks[1] == oks[0]
            if oks[0]:
                live[sid] = toks
                if rng.rand() < 0.8:
                    for c in caches:
                        c.commit_prefix(sid, toks)
        elif op == "free":
            sid = rng.choice(sorted(live))
            for c in caches:
                c.free_seq(sid)
            del live[sid]
        elif op == "extend":
            sid = rng.choice(sorted(live))
            grow = int(rng.randint(1, bs + 1))
            oks = [c.extend(sid, len(live[sid]) + grow) for c in caches]
            assert oks[1] == oks[0]
            if oks[0]:
                live[sid] += [int(t) for t in rng.randint(0, vocab, grow)]
                if rng.rand() < 0.5:
                    for c in caches:
                        c.commit_prefix(sid, live[sid])
        elif op == "write":
            sid = rng.choice(sorted(live))
            pos = int(rng.randint(0, len(live[sid])))
            oks = [c.ensure_writable(sid, pos) for c in caches]
            assert oks[1] == oks[0]
        else:
            sid = rng.choice(sorted(live))
            child = f"s{next_id}"
            next_id += 1
            for c in caches:
                c.fork(sid, child)
            live[child] = list(live[sid])
        assert _state(caches[1]) == _state(caches[0])
        _check_invariants(caches[1])
    for sid in sorted(live):
        for c in caches:
            c.free_seq(sid)
    assert _state(caches[1]) == _state(caches[0])
    _check_invariants(caches[1])
    assert caches[1].allocator.num_used == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_storm_matches_the_reference(seed):
    caches = _caches(num_blocks=11, spill_blocks=6)
    for c in caches:
        c.set_tenant_quotas({"t1": 1})
    _storm(caches, np.random.RandomState(seed), 200)
    port = caches[1]
    assert port.spills > 0
    if seed < 2:       # these two storms also promote and evict over quota
        assert port.promotes > 0 and sum(port.quota_evictions.values()) > 0


def test_storm_with_injected_faults_matches_the_reference():
    caches = _caches(num_blocks=9, spill_blocks=4)
    plan = ("serving.kv.spill:error%0.2;serving.kv.spill:corrupt%0.1;"
            "serving.kv.promote:error%0.2;serving.kv.alloc:exhaust%0.05")
    with j_faults.FaultPlan.parse(plan, seed=7) as jp, \
            t_faults.FaultPlan.parse(plan, seed=7) as tp:
        _storm(caches, np.random.RandomState(7), 150, vocab=2,
               ops=["admit", "admit", "free"])
    assert [(f.site, f.hit, f.kind) for f in tp.fired] == \
        [(f.site, f.hit, f.kind) for f in jp.fired]
    kinds = {(f.site, f.kind) for f in tp.fired}
    assert ("serving.kv.spill", "error") in kinds
    assert ("serving.kv.promote", "error") in kinds


def _seed_and_flood(c, toks, paint):
    assert c.allocate("seed", len(toks), tokens=toks)
    table = list(c.tables["seed"])
    if isinstance(c, JCache):
        pool = np.array(c.pool)
        for b in table:
            pool[:, b] = paint(b)
        c.pool = jnp.asarray(pool)
    else:
        for b in table:
            c.pool[:, b] = torch.as_tensor(paint(b), dtype=c.pool.dtype)
    c.commit_prefix("seed", toks)
    c.free_seq("seed")
    assert c.allocate("flood", 8 * 4)       # evicts both cached blocks
    c.free_seq("flood")
    return table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_promoted_block_equals_its_spilled_bytes(dtype):
    shape = (2, 2, 1, 4, 4)
    rng = np.random.RandomState(3)
    paints = {b: rng.randn(*shape).astype(np.float32) for b in range(9)}
    jc, tc = _caches(num_blocks=9, dtype=dtype)
    toks = list(range(11))
    for c in (jc, tc):
        table = _seed_and_flood(c, toks, lambda b: paints[b])
    assert tc.spills == jc.spills == 2
    spilled = {e.hash: e.kv.copy() for e in tc._spill.values()}
    assert all(v.dtype == (np.int16 if dtype == torch.bfloat16
                           else np.int32) for v in spilled.values())
    for c in (jc, tc):
        assert c.allocate("re", 11, tokens=toks)
    assert _state(tc) == _state(jc)
    assert tc.promotes == 2 and tc.seq_cached_tokens["re"] == 8
    width = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for i, b in enumerate(tc.tables["re"][:2]):
        got = tc.pool[:, b]
        want = torch.as_tensor(paints[table[i]]).to(dtype)
        assert torch.equal(got, want)
        assert np.array_equal(got.view(width).numpy(),
                              spilled[tc._block_hash[b]])
        if dtype == torch.float32:
            assert np.array_equal(np.asarray(jc.pool[:, b]), got.numpy())


@pytest.mark.parametrize("plan,at", [
    ("serving.kv.spill:error@1x2", "flood"),
    ("serving.kv.spill:corrupt@1", "flood"),
    ("serving.kv.promote:corrupt@1", "promote"),
    ("serving.kv.promote:error@1", "promote"),
])
def test_failure_paths_match(plan, at):
    jc, tc = _caches(num_blocks=9)
    toks = list(range(11))
    for c, fp in ((jc, j_faults), (tc, t_faults)):
        with fp.FaultPlan.parse(plan if at == "flood" else ""):
            _seed_and_flood(c, toks, lambda b: np.full((2, 2, 1, 4, 4),
                                                       float(b)))
        with fp.FaultPlan.parse(plan if at == "promote" else ""):
            assert c.allocate("re", 11, tokens=toks)
    assert _state(tc) == _state(jc)
    assert tc.seq_cached_tokens["re"] == 0      # prefilled, never junk
    assert tc.promotes == 0
    _check_invariants(tc)


def test_dry_pool_keeps_the_entry():
    jc, tc = _caches(num_blocks=4)
    for c in (jc, tc):
        toks = list(range(8))
        assert c.allocate("seed", 8, tokens=toks)
        c.commit_prefix("seed", toks)
        c.free_seq("seed")
        assert c.allocate("flood", 12)
        c.free_seq("flood")
        assert c.allocate("hold", 8)
        assert c.allocate("re", 9, tokens=toks + [9]) is False
    assert _state(tc) == _state(jc)
    assert tc.promotes == 1 and len(tc._spill) == 1
    _check_invariants(tc)


def _schedulers(high=0.5, low=0.25, num_blocks=9):
    out = []
    for cache in _caches(num_blocks=num_blocks, spill_blocks=0):
        S = JScheduler if isinstance(cache, JCache) else Scheduler
        out.append((S(cache, 4, 32, high_watermark=high,
                      low_watermark=low), cache))
    return out


def test_watermark_latch_matches():
    trace = []
    for s, cache in _schedulers():      # 8 usable: high at 4, low at 2
        seen = [s._update_pressure()]
        for sid, blocks, free in (("a", 4, None), ("b", 3, "a"),
                                  ("c", 1, "b"), ("d", 4, None)):
            if free:
                cache.free_seq(free)
            assert cache.allocate(sid, blocks * 4)
            seen.append(s._update_pressure())
        trace.append((seen, s.num_pressure_events, s.low_watermark))
    assert trace[1] == trace[0] == ([False, True, True, False, True], 2,
                                    0.25)


def test_admission_waits_under_pressure():
    got = []
    for (s, cache), (R, SP) in zip(_schedulers(),
                                   ((JRequest, JSamplingParams),
                                    (Request, SamplingParams))):
        assert cache.allocate("hog", 5 * 4)
        s.add(R(rid=0, prompt=[1, 2, 3], sampling=SP(max_new_tokens=2)))
        first = s.admit()
        cache.free_seq("hog")
        got.append((first, [r.rid for _, r in s.admit()], s.mem_pressure))
    assert got[1] == got[0] == ([], [0], False)


def test_watermark_validation_matches():
    for S, cache in ((JScheduler, _caches()[0]), (Scheduler, _caches()[1])):
        with pytest.raises(ValueError, match="high_watermark"):
            S(cache, 2, 32, high_watermark=1.5)
        with pytest.raises(ValueError, match="low_watermark"):
            S(cache, 2, 32, high_watermark=0.5, low_watermark=0.6)
        assert S(cache, 2, 32, high_watermark=0.8).low_watermark == \
            pytest.approx(0.6)
        assert S(cache, 2, 32).low_watermark is None
