"""The PyTorch port's serving core (paddle_tpu_torch.serving) against the JAX
package, and the port's package rules.

- host bookkeeping: the allocator and prefix-cache cases of
  ``tests/test_serving.py`` / ``tests/test_prefix_cache.py``, and a random
  operation storm applied to both packages' ``PagedKVCache`` in lock step;
- the engine: greedy streams equal the JAX ``LLMEngine``'s on the same
  converted weights (shared prefix, 2 slots, a pool small enough to force
  a preemption), equal the port's ``naive_generate``, and seeded sampling
  does not depend on batching. Seeded sampling matches the JAX package in
  distribution only (threefry bits are not reproduced), so it is checked
  against the softmax, not against JAX's tokens. No EOS parity with the
  reference engine (ROADMAP R2).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import llama_tiny as j_llama_tiny
from paddle_tpu.nn.layer import functional_state
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.serving import SamplingParams as JSamplingParams

from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny, state_from_jax
from paddle_tpu_torch.nn import sample_logits
from paddle_tpu_torch.serving import (BlockAllocator, EngineClosed, LLMEngine,
                                      PagedKVCache, PreemptionStorm, QueueFull,
                                      RequestState, SamplingParams,
                                      naive_generate)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab=61, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           seq=64)


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(0)
    jm = JLlama(j_llama_tiny(**CFG))
    params, _ = functional_state(jm)
    tm = LlamaForCausalLM(llama_tiny(**CFG), device="cpu")
    tm.load_state_dict(state_from_jax({k: np.asarray(v)
                                       for k, v in params.items()}))
    return jm, tm


def _prompts(seed):
    rng = np.random.RandomState(seed)
    shared = list(rng.randint(0, 61, 16))
    return [shared + list(rng.randint(0, 61, 5)), list(rng.randint(0, 61, 9)),
            shared + list(rng.randint(0, 61, 3)),
            list(rng.randint(0, 61, 30))]


# ---------------------------------------------------------------------------
# block allocator and prefix cache
# ---------------------------------------------------------------------------

class TestBlockAllocator:
    def test_alloc_free_reuse_roundtrip(self):
        a = BlockAllocator(num_blocks=8)  # block 0 reserved -> 7 usable
        assert a.num_usable == 7 and a.num_free == 7
        first = a.alloc(3)
        assert sorted(first) == [1, 2, 3] and 0 not in first
        assert a.num_used == 3 and a.high_water == 3
        a.free(first[:2])
        assert a.num_used == 1 and a.num_free == 6
        again = a.alloc(6)
        assert again is not None and set(first[:2]) <= set(again)
        assert a.high_water == 7 and a.num_free == 0

    def test_exhaustion_returns_none_not_partial(self):
        a = BlockAllocator(num_blocks=4)
        assert a.alloc(3) is not None
        before = a.num_used
        assert a.alloc(1) is None
        assert a.num_used == before

    def test_double_free_rejected(self):
        a = BlockAllocator(num_blocks=4)
        (b,) = a.alloc(1)
        a.free([b])
        with pytest.raises(ValueError):
            a.free([b])

    def test_release_parks_and_share_promotes(self):
        a = BlockAllocator(num_blocks=6)
        blocks = a.alloc(2)
        assert a.release(blocks) == blocks
        assert a.num_cached == 2 and a.num_used == 0
        assert a.num_effective_free == 5
        a.share(blocks[:1])
        assert a.num_cached == 1 and a.refcount(blocks[0]) == 1
        a.reclaim(blocks[1:])
        assert a.num_free == 4
        with pytest.raises(ValueError):
            a.reclaim(blocks[:1])        # referenced: never reclaimed

    def test_cache_tables_and_utilization(self):
        c = PagedKVCache(num_layers=1, num_blocks=9, kv_heads=1,
                         block_size=4, head_dim=8, device="cpu")
        assert c.allocate("a", 10)          # 3 blocks
        assert c.extend("a", 13)            # 4th block
        assert c.utilization() == pytest.approx(4 / 8)
        tbl = c.table_array(["a", None], max_blocks=6)
        assert tbl.shape == (2, 6)
        assert list(tbl[0][:4]) == c.tables["a"] and all(tbl[1] == 0)
        c.free_seq("a")
        assert c.allocator.num_used == 0


class TestPrefixCache:
    def _cache(self, num_blocks=17):
        return PagedKVCache(num_layers=1, num_blocks=num_blocks, kv_heads=1,
                            block_size=4, head_dim=4, prefix_cache=True,
                            device="cpu")

    def test_match_shares_blocks_and_allocates_tail(self):
        c = self._cache()
        toks = list(range(10))
        assert c.allocate("a", 10, tokens=toks)
        c.commit_prefix("a", toks)               # 2 full blocks indexed
        assert c.allocate("b", 11, tokens=toks + [99])
        assert c.seq_cached_tokens["b"] == 8
        assert c.tables["b"][:2] == c.tables["a"][:2]
        assert c.allocator.refcount(c.tables["a"][0]) == 2

    def test_match_capped_below_full_cover(self):
        c = self._cache()
        toks = list(range(8))
        c.allocate("a", 8, tokens=toks)
        c.commit_prefix("a", toks)
        c.allocate("b", 8, tokens=toks)
        assert c.seq_cached_tokens["b"] == 4     # the last token prefills

    def test_copy_on_write_copies_pool_content(self):
        c = self._cache()
        toks = list(range(8))
        c.allocate("a", 8, tokens=toks)
        c.commit_prefix("a", toks)
        shared = c.tables["a"][0]
        c.pool[:, shared] = 7.0
        c.allocate("b", 9, tokens=toks + [1])
        assert c.tables["b"][0] == shared
        assert c.ensure_writable("b", 2)        # write into the shared block
        new = c.tables["b"][0]
        assert new != shared and c.cow_copies == 1
        assert torch.equal(c.pool[:, new], c.pool[:, shared])
        assert c.allocator.refcount(shared) == 1

    def test_eviction_is_lru_and_spares_referenced(self):
        c = self._cache(num_blocks=5)            # 4 usable
        for name, base in (("a", 0), ("b", 100)):
            toks = list(range(base, base + 4))
            c.allocate(name, 4, tokens=toks)
            c.commit_prefix(name, toks)
        a_block = c.tables["a"][0]
        c.free_seq("a")                           # oldest cached
        c.free_seq("b")
        assert c.allocator.num_cached == 2
        c.allocate("c", 12)                       # 3 blocks: evicts one
        assert c.prefix_evictions == 1
        assert a_block not in c._block_key        # "a" went first

    def test_unknown_sequences_are_named(self):
        c = self._cache()
        with pytest.raises(ValueError, match="unknown sequence"):
            c.free_seq("nope")
        with pytest.raises(ValueError, match="unknown sequence"):
            c.extend("nope", 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_cache_storm_matches_reference(seed):
    """The same random operation sequence on both packages' PagedKVCache:
    tables, refcounts and hit accounting agree after every step."""
    rng = np.random.RandomState(seed)
    mk = dict(num_layers=1, num_blocks=13, kv_heads=1, block_size=4,
              head_dim=4, prefix_cache=True)
    j, t = JPagedKVCache(**mk), PagedKVCache(**mk, device="cpu")
    prefixes = [list(rng.randint(0, 5, 12)) for _ in range(3)]
    live: dict[int, list[int]] = {}
    for sid in range(60):
        op = rng.randint(4)
        if op == 0 or not live:
            toks = prefixes[rng.randint(3)][:rng.randint(1, 13)] + \
                list(rng.randint(0, 5, rng.randint(0, 5)))
            ok_j = j.allocate(sid, len(toks), tokens=toks)
            assert t.allocate(sid, len(toks), tokens=toks) == ok_j
            if ok_j:
                live[sid] = toks
                j.commit_prefix(sid, toks)
                t.commit_prefix(sid, toks)
        else:
            sid = list(live)[rng.randint(len(live))]
            if op == 1:
                j.free_seq(sid)
                t.free_seq(sid)
                del live[sid]
            elif op == 2:
                n = len(live[sid]) + 1
                ok = j.extend(sid, n)
                assert t.extend(sid, n) == ok
                if ok:
                    pos = len(live[sid])
                    ok = j.ensure_writable(sid, pos)
                    assert t.ensure_writable(sid, pos) == ok
                    if ok:
                        live[sid] = live[sid] + [int(rng.randint(5))]
                        j.commit_prefix(sid, live[sid])
                        t.commit_prefix(sid, live[sid])
            else:
                assert j.match_prefix(live[sid]) == t.match_prefix(live[sid])
        assert t.tables == j.tables
        assert t.allocator._rc == j.allocator._rc
        assert list(t._lru) == list(j._lru)
        for key in ("hits", "misses", "blocks_saved", "cow_copies",
                    "evictions"):
            assert t.prefix_stats()[key] == j.prefix_stats()[key], key


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

class TestSampleLogits:
    def test_greedy_is_argmax(self):
        lg = torch.from_numpy(np.random.RandomState(0).randn(5, 33)
                              .astype(np.float32))
        out = sample_logits(lg, [0.0] * 5, [0] * 5, [1.0] * 5, [1] * 5,
                            [0] * 5)
        assert torch.equal(out, lg.argmax(-1))

    def test_rows_independent_of_batch(self):
        lg = torch.from_numpy(np.random.RandomState(1).randn(3, 25)
                              .astype(np.float32))
        args = ([0.8] * 3, [5] * 3, [0.95] * 3, [5, 6, 7], [2, 0, 9])
        batched = sample_logits(lg, *args).tolist()
        for i in range(3):
            single = sample_logits(lg[i:i + 1], *([a[i]] for a in args))
            assert batched[i] == int(single[0])

    def test_top_k_and_top_p_restrict_support(self):
        lg = torch.from_numpy(np.random.RandomState(2).randn(1, 40)
                              .astype(np.float32))
        top3 = set(lg[0].argsort()[-3:].tolist())
        for s in range(20):
            assert int(sample_logits(lg, [1.5], [3], [1.0], [s], [0])[0]) \
                in top3
        dom = torch.tensor([[10.0] + [0.0] * 9])
        for s in range(10):
            assert int(sample_logits(dom, [1.0], [0], [0.5], [s], [0])[0]) \
                == 0

    def test_distribution_matches_softmax(self):
        """The distribution-level contract with the JAX sampler: Gumbel-max
        at temperature T draws from softmax(logits / T)."""
        lg = torch.tensor([[1.0, 0.5, -0.5, 0.0, 2.0]])
        n = 4000
        draws = torch.stack([sample_logits(lg, [0.7], [0], [1.0], [3], [i])
                             for i in range(n)])[:, 0]
        freq = torch.bincount(draws, minlength=5).double() / n
        p = torch.softmax(lg[0].double() / 0.7, -1)
        assert (freq - p).abs().max() < 0.03


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def test_greedy_streams_equal_jax_engine(models):
    jm, tm = models
    prompts = _prompts(1)
    je = JEngine(jm, block_size=8, max_slots=2, max_model_len=64,
                 num_blocks=9)
    ref = je.generate(prompts, JSamplingParams(max_new_tokens=8))
    te = LLMEngine(tm, block_size=8, max_slots=2, max_model_len=64,
                   num_blocks=9)
    out = te.generate(prompts, SamplingParams(max_new_tokens=8))
    assert out == ref
    st, jst = te.stats(), je.stats()
    assert st["num_preemptions"] == jst["num_preemptions"] >= 1
    assert st["prefix_cache"]["hits"] == jst["prefix_cache"]["hits"] >= 1
    assert st["blocks_used"] == 0 and st["num_finished"] == 4


def test_engine_equals_naive_generate(models):
    _, tm = models
    prompts = _prompts(2)
    sp = SamplingParams(max_new_tokens=6)
    eng = LLMEngine(tm, block_size=4, max_slots=3, max_model_len=64)
    assert eng.generate(prompts, sp) == [naive_generate(tm, p, sp)
                                         for p in prompts]
    assert eng.stats()["total_generated_tokens"] == 24


def test_seeded_sampling_independent_of_batching(models):
    _, tm = models
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(0, 61, n)) for n in (10, 9, 11)]
    sps = [SamplingParams(max_new_tokens=8, temperature=0.8, top_k=20,
                          top_p=0.9, seed=s) for s in (7, 8, 9)]
    eng = LLMEngine(tm, block_size=4, num_blocks=9, max_slots=3,
                    max_model_len=32)
    outs = eng.generate(prompts, sps)
    assert eng.stats()["num_preemptions"] > 0
    assert outs == [naive_generate(tm, p, sp) for p, sp in zip(prompts, sps)]


def test_eos_stops_like_naive_generate(models):
    """EOS is held against the port's own uncached loop (the reference
    engine's EOS path is not trusted, ROADMAP R2)."""
    _, tm = models
    prompts = _prompts(4)
    sp = SamplingParams(max_new_tokens=8)
    full = naive_generate(tm, prompts[1], sp)
    k = next(i for i in range(1, 8) if full[i] not in full[:i])
    eos = full[k]
    want = [naive_generate(tm, p, sp, eos_token_id=eos) for p in prompts]
    assert want[1] == full[:k + 1]
    eng = LLMEngine(tm, block_size=4, max_slots=2, max_model_len=64,
                    eos_token_id=eos)
    reqs = [eng.add_request(p, sp) for p in prompts]
    eng.run()
    assert [r.output_tokens for r in reqs] == want
    assert reqs[1].finish_reason == "stop"


def test_preemption_storm_fails_only_the_victim(models):
    _, tm = models
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(0, 61, n)) for n in (10, 9, 11)]
    eng = LLMEngine(tm, block_size=4, num_blocks=9, max_slots=3,
                    max_model_len=32, max_preemptions_per_request=0)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=8))
            for p in prompts]
    eng.run()
    failed = [r for r in reqs if r.state is RequestState.FAILED]
    assert failed and all(isinstance(r.error, PreemptionStorm)
                          for r in failed)
    assert all(r.state is RequestState.FINISHED and len(r.output_tokens) == 8
               for r in reqs if r not in failed)
    assert eng.stats()["num_failed"] == len(failed)
    assert eng.stats()["blocks_used"] == 0


def test_stream_cancel_close_and_failure_isolation(models, monkeypatch):
    _, tm = models
    eng = LLMEngine(tm, block_size=8, max_slots=2, max_model_len=64,
                    max_queue=3)
    sp = SamplingParams(max_new_tokens=3)
    seen = []
    others = [eng.add_request([1, 2, 3, 4], sp,
                              on_token=lambda r, t: seen.append((r.rid, t)))
              for _ in range(2)]
    assert len(list(eng.stream([5, 6, 7], sp))) == 3
    assert all(len(r.output_tokens) == 3 for r in others)
    assert sorted(seen) == sorted((r.rid, t) for r in others
                                  for t in r.output_tokens)

    real = eng._run_prefill

    def flaky(slot, req):
        if req.rid == 4:
            raise RuntimeError("boom")
        return real(slot, req)

    monkeypatch.setattr(eng, "_run_prefill", flaky)
    good, bad = eng.add_request([1, 2], sp), eng.add_request([3, 4], sp)
    waiting = eng.add_request([5, 6], sp)
    with pytest.raises(QueueFull):
        for _ in range(2):
            eng.add_request([7], sp)
    assert eng.cancel(waiting.rid) and not eng.cancel(waiting.rid)
    eng.run()
    assert good.state is RequestState.FINISHED and len(good.output_tokens) == 3
    assert bad.state is RequestState.FAILED and "boom" in str(bad.error)
    assert waiting.state is RequestState.CANCELLED
    assert eng.stats()["blocks_used"] == 0
    eng.close()
    with pytest.raises(EngineClosed):
        eng.add_request([1], sp)


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules\n"
        "                    if m.startswith('paddle_tpu_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def test_entry_points_refuse_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny(**CFG))
    m = LlamaForCausalLM(llama_tiny(**CFG), device="cpu")
    assert m.device.type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
