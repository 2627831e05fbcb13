"""The port's fleet router (paddle_tpu_torch.serving.router) against the
JAX package's.

- The reference's unit cases of ``tests/test_router.py`` on fake replicas
  (placement, shedding and the in-flight bound, replay-and-suppress and a
  replay mismatch, drain / restart, the fault sites, circuit breakers,
  the retry budget, the watermark cadence), run on the port's router; a
  scripted fake-fleet scenario gives both packages' routers the same
  decisions and the same ``stats()`` counts.
- The failover contract on a two-``LocalReplica`` fleet whose weights
  come from the reference's model through ``state_from_jax``: greedy
  streams equal the reference's uncached greedy decode on those weights
  (``naive_generate``'s loop under one jit, checked against
  ``naive_generate`` itself) with no fault and after a kill at k tokens; a seeded request equals the
  port's own uninterrupted stream.
- One ``ProcReplica`` (a CPU child, ``replica_worker``) SIGKILLed
  mid-stream; its request fails over to a ``LocalReplica`` built from
  the same spec and equals the port's ``naive_generate``.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import llama_tiny as j_llama_tiny
from paddle_tpu.nn.layer import functional_call, functional_state
from paddle_tpu.serving import FleetRouter as JFleetRouter
from paddle_tpu.serving import LocalReplica as JLocalReplica
from paddle_tpu.serving import ReplicaState as JReplicaState
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving import naive_generate as j_naive_generate

from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny, state_from_jax
from paddle_tpu_torch.serving import (
    FleetRouter, LLMEngine, LocalReplica, NoHealthyReplica, ProcReplica,
    ReplicaState, RouterShed, SamplingParams, naive_generate)
from paddle_tpu_torch.serving.replica_worker import build_model
from paddle_tpu_torch.serving.router import (sampling_from_dict,
                                             sampling_to_dict)
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.faults import FaultPlan

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.deactivate()


# ---------------------------------------------------------------------------
# fake replicas: the state machines without engines (the reference's cases)
# ---------------------------------------------------------------------------

class FakeReplica:
    kind = "fake"

    def __init__(self, rid, state=ReplicaState.HEALTHY, shed=False):
        self.rid = rid
        self.state = state
        self.stats = {"slo": {"shed": shed}}
        self.last_heartbeat = time.monotonic()
        self.pid = 0
        self.sent = []
        self.alive = True
        self._on_event = None

    def start(self, on_event):
        self._on_event = on_event
        self.state = ReplicaState.HEALTHY

    def send(self, cmd):
        if not self.alive:
            raise BrokenPipeError(self.rid)
        self.sent.append(cmd)

    def stop(self, graceful=True, timeout=0):
        pass

    def kill(self):
        self.alive = False

    # test helpers: emit protocol events as if the engine produced them
    def emit_tokens(self, gid, toks, start=0):
        for i, t in enumerate(toks, start=start):
            self._on_event(self, {"ev": "token", "gid": gid, "tok": t,
                                  "i": i})

    def emit_done(self, gid, state="finished", reason="length", error=None,
                  n=0):
        self._on_event(self, {"ev": "done", "gid": gid, "state": state,
                              "reason": reason, "error": error, "n": n})


def fake_router(n=3, **kw):
    reps = [FakeReplica(f"f{i}") for i in range(n)]
    router = FleetRouter(reps, affinity_block_size=4, **kw)
    for r in reps:
        r.start(router._on_event)       # no probe thread: tests drive events
    return router, reps


class TestPlacement:
    def test_affinity_is_stable_and_block_aligned(self):
        router, reps = fake_router(3)
        # 13 tokens, block 4: the shareable prefix is the first 3 FULL
        # blocks (capped at len-1, exactly like the prefix-cache match)
        prompt = list(range(13))
        picks = {router._place(prompt, 0).rid for _ in range(10)}
        assert len(picks) == 1          # same prefix -> same replica
        # a tail-divergent prompt with the same 3 full blocks hashes the
        # same and lands on the same replica
        same = router._place(list(range(12)) + [99, 98], 0).rid
        assert same in picks
        assert router.stats()["affinity_hits"] >= 11

    def test_short_prompt_skips_affinity(self):
        router, _ = fake_router(2)
        # < 1 full block: no affinity key, p2c picks something healthy
        assert router._place([1, 2], 0) is not None
        assert router.stats()["affinity_hits"] == 0

    def test_p2c_falls_back_when_preferred_overloaded(self):
        router, reps = fake_router(2)
        prompt = list(range(8))
        preferred = router._place(prompt, 0)
        # pile router-side load onto the preferred replica only
        for g in range(5):
            router._inflight[preferred.rid].add(1000 + g)
        other = [r for r in reps if r.rid != preferred.rid][0]
        assert router._place(prompt, 0).rid == other.rid

    def test_no_healthy_raises_503_shape(self):
        router, reps = fake_router(2)
        for r in reps:
            r.state = ReplicaState.UNHEALTHY
        with pytest.raises(NoHealthyReplica):
            router._place([1, 2, 3], 0)

    def test_unhealthy_and_draining_excluded_from_placement(self):
        router, reps = fake_router(3)
        reps[0].state = ReplicaState.UNHEALTHY
        reps[1].state = ReplicaState.DRAINING
        for _ in range(8):
            assert router._place(list(np.random.randint(0, 50, 10)), 0) \
                is reps[2]


class TestShedding:
    def test_sheds_lowest_priority_first(self):
        router, reps = fake_router(2, shed_bypass_priority=1)
        for r in reps:
            r.stats = {"slo": {"shed": True}}    # every replica sheds
        with pytest.raises(RouterShed) as ei:
            router._place([1, 2, 3, 4, 5], priority=0)
        assert ei.value.retry_after_s > 0
        # higher priority bypasses the total shed
        assert router._place([1, 2, 3, 4, 5], priority=1) is not None
        assert router.stats()["shed"] == 1

    def test_partial_shed_routes_around(self):
        router, reps = fake_router(2)
        reps[0].stats = {"slo": {"shed": True}}
        for _ in range(6):
            assert router._place(
                list(np.random.randint(0, 50, 9)), 0) is reps[1]

    def test_inflight_bound_is_a_shed_signal(self):
        router, reps = fake_router(2, max_inflight_per_replica=1)
        r0 = router.submit([1, 2, 3, 4, 5], SamplingParams())
        r1 = router.submit([9, 8, 7, 6, 5], SamplingParams())
        assert {r0.replica, r1.replica} == {"f0", "f1"}   # spread by bound
        with pytest.raises(RouterShed):
            router.submit([5, 5, 5, 5, 5], SamplingParams(), priority=0)

    def test_inflight_streams_never_shed_on_failover(self):
        """A dead replica's streams re-dispatch even when every survivor
        sheds — shedding only ever rejects NEW work."""
        router, reps = fake_router(2)
        rr = router.submit([1, 2, 3, 4, 5, 6, 7, 8], SamplingParams())
        victim = router.replicas[rr.replica]
        survivor = [r for r in reps if r.rid != victim.rid][0]
        victim.emit_tokens(rr.gid, [11, 12])
        survivor.stats = {"slo": {"shed": True}}          # survivor sheds
        router._mark_unhealthy(victim, "test death")
        assert rr.replica == survivor.rid                 # still placed
        assert rr.failovers == 1 and not rr.terminal
        add = [c for c in survivor.sent if c["op"] == "add"][-1]
        assert add["prompt"] == rr.prompt                 # original prompt


class TestFailoverStateMachine:
    def test_replay_suppress_then_continue(self):
        router, reps = fake_router(2)
        rr = router.submit([1, 2, 3, 4, 5], SamplingParams())
        a = router.replicas[rr.replica]
        b = [r for r in reps if r.rid != a.rid][0]
        seen = []
        rr.on_token = lambda r, t: seen.append(t)
        a.emit_tokens(rr.gid, [10, 11, 12])
        router._mark_unhealthy(a, "death")
        assert rr.suppress == 3 and rr.replica == b.rid
        b.emit_tokens(rr.gid, [10, 11, 12, 13, 14])       # replay + new
        b.emit_done(rr.gid, n=5)
        assert rr.tokens == [10, 11, 12, 13, 14]
        # the pre-kill tokens streamed once, the replay was swallowed, the
        # continuation streamed once: no duplicate, no gap
        assert seen == [10, 11, 12, 13, 14]
        assert rr.state == "finished"
        assert router.stats()["replay_suppressed"] == 3

    def test_replay_mismatch_fails_request(self):
        router, reps = fake_router(2)
        rr = router.submit([1, 2, 3, 4, 5], SamplingParams())
        a = router.replicas[rr.replica]
        b = [r for r in reps if r.rid != a.rid][0]
        a.emit_tokens(rr.gid, [10, 11])
        router._mark_unhealthy(a, "death")
        b.emit_tokens(rr.gid, [10, 99])   # diverged replay
        assert rr.state == "failed"
        assert "ReplayMismatch" in rr.error
        assert router.stats()["replay_mismatches"] == 1

    def test_stale_replica_events_dropped(self):
        router, reps = fake_router(2)
        rr = router.submit([1, 2, 3, 4, 5], SamplingParams())
        a = router.replicas[rr.replica]
        b = [r for r in reps if r.rid != a.rid][0]
        router._mark_unhealthy(a, "death")
        a.emit_tokens(rr.gid, [42])       # the dead replica babbles
        a.emit_done(rr.gid, state="failed", error="zombie")
        assert rr.tokens == [] and not rr.terminal
        b.emit_done(rr.gid, state="finished", reason="stop")
        assert rr.state == "finished"

    def test_engine_failure_retries_then_surfaces(self):
        router, reps = fake_router(2, max_retries=1)
        rr = router.submit([1, 2, 3, 4, 5], SamplingParams())
        first = router.replicas[rr.replica]
        first.emit_done(rr.gid, state="failed", reason="error",
                        error="FaultError: injected")
        second = router.replicas[rr.replica]
        assert second.rid != first.rid and rr.retries == 1
        second.emit_done(rr.gid, state="failed", reason="error",
                         error="FaultError: injected again")
        assert rr.state == "failed"       # retry budget spent
        assert "again" in rr.error

    def test_validation_errors_do_not_retry(self):
        router, reps = fake_router(2, max_retries=3)
        rr = router.submit([1, 2, 3, 4, 5], SamplingParams())
        router.replicas[rr.replica].emit_done(
            rr.gid, state="failed", reason="add_failed",
            error="ValueError: prompt exceeds max_model_len")
        assert rr.state == "failed" and rr.retries == 0

    def test_deadline_cancel_is_terminal(self):
        router, reps = fake_router(2)
        rr = router.submit([1, 2, 3, 4, 5], SamplingParams(), deadline_s=5)
        router.replicas[rr.replica].emit_done(
            rr.gid, state="cancelled", reason="deadline",
            error="DeadlineExceeded: ...")
        assert rr.state == "cancelled" and rr.finish_reason == "deadline"

    def test_failover_with_no_survivor_fails_not_hangs(self):
        router, reps = fake_router(2)
        rr = router.submit([1, 2, 3, 4, 5], SamplingParams())
        for r in reps:
            router._mark_unhealthy(r, "total outage")
        assert rr.state == "failed"
        assert rr.finish_reason == "no_healthy_replica"
        assert rr.wait(0.1)               # waiters released


class TestDrainStateMachine:
    def test_drain_stops_placement_waits_then_stops(self):
        router, reps = fake_router(2)
        report = router.drain(reps[0].rid, budget_s=0.2)
        assert report["drained"] and report["completed_in_budget"]
        assert reps[0].state is ReplicaState.STOPPED
        for _ in range(5):
            assert router._place(list(range(8)), 0) is reps[1]

    def test_drain_fails_over_stragglers_after_budget(self):
        router, reps = fake_router(2)
        rr = router.submit([1, 2, 3, 4, 5], SamplingParams())
        rep = router.replicas[rr.replica]
        other = [r for r in reps if r.rid != rep.rid][0]
        rep.emit_tokens(rr.gid, [7, 8])
        report = router.drain(rep.rid, budget_s=0.05)
        assert report["drained"] and not report["completed_in_budget"]
        assert report["failed_over"] == 1
        assert rr.replica == other.rid and rr.suppress == 2
        assert not rr.terminal            # the stream survived the drain

    def test_drain_only_from_healthy(self):
        router, reps = fake_router(2)
        reps[0].state = ReplicaState.UNHEALTHY
        report = router.drain(reps[0].rid, budget_s=0.01)
        assert not report["drained"]

    def test_restart_requires_stopped_or_unhealthy(self):
        router, reps = fake_router(2)
        with pytest.raises(RuntimeError, match="drain/stop it first"):
            router.restart(reps[0].rid)
        router.drain(reps[0].rid, budget_s=0.05)
        router.restart(reps[0].rid)       # FakeReplica.start -> HEALTHY
        assert reps[0].state is ReplicaState.HEALTHY
        assert router.stats()["replica_restarts"] >= 1


class TestRouterChaosSites:
    def test_dispatch_fault_falls_through_to_next_replica(self):
        router, reps = fake_router(2)
        with FaultPlan.parse("router.dispatch:error@1"):
            rr = router.submit([1, 2, 3, 4, 5], SamplingParams())
        assert rr.replica is not None and not rr.terminal
        assert rr.dispatches == 1         # second candidate took it

    def test_submit_fault_surfaces(self):
        router, _ = fake_router(2)
        with FaultPlan.parse("router.submit:error@1"):
            with pytest.raises(faults.FaultError):
                router.submit([1, 2, 3], SamplingParams())

    def test_sampling_roundtrip(self):
        sp = SamplingParams(max_new_tokens=9, temperature=0.7, top_k=5,
                            top_p=0.9, seed=41)
        assert sampling_from_dict(sampling_to_dict(sp)) == sp



def _scripted(router_cls, state_cls, sp):
    """One scripted fake-fleet run: placements, a failover with replay, an
    engine failure and retry, a drain, a shed, and a breaker trip. Returns
    what a client and an operator see."""
    class Fake(FakeReplica):
        def __init__(self, rid):
            super().__init__(rid, state=state_cls.HEALTHY)

        def start(self, on_event):
            self._on_event = on_event
            self.state = state_cls.HEALTHY

    reps = [Fake(f"f{i}") for i in range(3)]
    router = router_cls(reps, affinity_block_size=4, rng_seed=5,
                        breaker_min_samples=2, breaker_cooldown_s=60.0,
                        max_retries=1)
    for r in reps:
        r.start(router._on_event)
    out = []
    rng = np.random.RandomState(0)
    rrs = [router.submit([int(t) for t in rng.randint(0, 50, n)], sp(6))
           for n in (3, 9, 13, 13, 17, 5)]
    out.append([rr.replica for rr in rrs])
    a = router.replicas[rrs[1].replica]
    a.emit_tokens(rrs[1].gid, [10, 11, 12])
    router._mark_unhealthy(a, "death")
    b = router.replicas[rrs[1].replica]
    b.emit_tokens(rrs[1].gid, [10, 11, 12, 13])
    b.emit_done(rrs[1].gid, n=4)
    out.append((rrs[1].tokens, rrs[1].state, rrs[1].failovers))
    c = router.replicas[rrs[2].replica]
    c.emit_done(rrs[2].gid, state="failed", error="RuntimeError: boom")
    out.append((rrs[2].replica, rrs[2].retries))
    alive = [r for r in reps if r.state is state_cls.HEALTHY]
    out.append(router.drain(alive[0].rid, budget_s=0.01))
    for r in reps:
        r.stats = {"slo": {"shed": True}}
    try:
        router.submit([1, 2, 3, 4, 5], sp(2), priority=0)
        out.append("admitted")
    except Exception as e:                        # RouterShed / 503
        out.append(type(e).__name__)
    st = router.stats()
    out.append({k: v for k, v in st.items()
                if k not in ("replicas", "actuation")})
    out.append({rid: (r["state"], r["inflight"], r["breaker"])
                for rid, r in st["replicas"].items()})
    return out


def test_scripted_decisions_equal_the_reference_router():
    got = _scripted(FleetRouter, ReplicaState,
                    lambda n: SamplingParams(max_new_tokens=n))
    want = _scripted(JFleetRouter, JReplicaState,
                     lambda n: JSamplingParams(max_new_tokens=n))
    assert got == want
    assert got[1] == ([10, 11, 12, 13], "finished", 1)
    assert got[-2]["failovers"] >= 1 and got[-2]["replay_suppressed"] == 3


# ---------------------------------------------------------------------------
# live fleets: the failover token-parity contract
# ---------------------------------------------------------------------------

VOCAB = 61
CFG = dict(vocab=VOCAB, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           seq=64)


@pytest.fixture(scope="module")
def ref():
    """The reference's model and its parameters as the port's state."""
    paddle_tpu.seed(0)
    jm = JLlama(j_llama_tiny(**CFG))
    params, _ = functional_state(jm)
    return jm, state_from_jax({k: np.asarray(v) for k, v in params.items()})


def _ref_greedy(ref, prompt, n, _fns={}):
    """The reference's uncached greedy decode (``naive_generate``'s loop:
    the full forward over prompt + tokens, argmax of the last row) under
    one ``jax.jit`` at a padded length of 32: the rows before the padding
    do not see it (causal), and one compile serves every call."""
    jm = ref[0]
    if id(jm) not in _fns:
        params, buffers = functional_state(jm)
        _fns[id(jm)] = jax.jit(lambda ids: functional_call(
            jm, params, buffers, ids, training=False)[0])
    f, toks, out = _fns[id(jm)], [int(t) for t in prompt], []
    for _ in range(n):
        ids = np.zeros((1, 32), np.int32)
        ids[0, :len(toks)] = toks
        tok = int(jnp.argmax(f(jnp.asarray(ids))[0, len(toks) - 1]))
        out.append(tok)
        toks.append(tok)
    return out


def _port_model(state):
    m = LlamaForCausalLM(llama_tiny(**CFG), device="cpu")
    m.load_state_dict(state)
    return m.eval()


@pytest.fixture(scope="module")
def live_fleet(ref):
    """One 2-replica LocalReplica fleet over the reference's weights,
    shared by the live tests (a killed replica is restarted before the
    fleet is handed back)."""
    state = ref[1]

    def factory():
        return LLMEngine(_port_model(state), block_size=8, max_slots=2,
                         max_model_len=64)

    reps = [LocalReplica(f"r{i}", factory, stats_interval_s=0.02,
                         warmup=list(range(1, 11))) for i in range(2)]
    router = FleetRouter(reps, probe_interval_s=0.05, probe_timeout_s=10.0,
                         affinity_block_size=8,
                         max_retries=1).start(wait_healthy_s=60)
    try:
        assert all(r.state is ReplicaState.HEALTHY for r in reps), \
            {r.rid: r.state for r in reps}
        yield router, reps
    finally:
        router.close()


def heal(router, reps, timeout=60.0):
    for rep in reps:
        if rep.state is not ReplicaState.HEALTHY:
            router.restart(rep.rid)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(r.state is ReplicaState.HEALTHY for r in reps):
            return
        time.sleep(0.02)
    raise AssertionError({r.rid: (r.state, r.alive, r.last_heartbeat)
                          for r in reps})


def _kill_after(router, rr, seen, k=3):
    deadline = time.monotonic() + 30
    while len(seen) < k and time.monotonic() < deadline:
        time.sleep(0.002)
    assert len(seen) >= k, "stream never started"
    victim = rr.replica
    router.replicas[victim].kill()
    return victim


def test_fleet_equals_the_reference_naive_generate(live_fleet, ref):
    """No faults: greedy requests through the fleet equal the reference's
    uncached decode on the same weights, whichever replica served them."""
    router, _ = live_fleet
    rng = np.random.RandomState(1)
    # one prompt length for every reference call of this file: the
    # reference's uncached decode compiles once a sequence length
    prompts = [[int(t) for t in rng.randint(0, VOCAB, 10)]
               for _ in range(4)]
    refs = [_ref_greedy(ref, p, 6) for p in prompts]
    # the padded decode is the reference's naive_generate (two steps of it)
    assert j_naive_generate(ref[0], prompts[0],
                            JSamplingParams(max_new_tokens=2)) == refs[0][:2]
    rrs = [router.submit(p, SamplingParams(max_new_tokens=6))
           for p in prompts]
    for rr in rrs:
        assert rr.wait(60)
    assert [rr.tokens for rr in rrs] == refs
    assert all(rr.state == "finished" for rr in rrs)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "seeded"])
def test_kill_after_k_tokens_stream_unchanged(live_fleet, ref, greedy):
    """Death after k streamed tokens: the client stream equals the
    reference's uncached decode (greedy) or the port's own uninterrupted
    stream (seeded), token for token, no duplicate, no gap."""
    router, reps = live_fleet
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    if greedy:
        sp = SamplingParams(max_new_tokens=14)
        want = _ref_greedy(ref, prompt, 14)
    else:
        sp = SamplingParams(max_new_tokens=14, temperature=0.9, top_k=7,
                            top_p=0.9, seed=123)
        want = naive_generate(_port_model(ref[1]), prompt, sp)
    before = router.stats()["replay_suppressed"]
    seen = []
    # every decode step of either replica sleeps 30 ms, so the kill lands
    # mid-stream
    with FaultPlan.parse("serving.decode:delay=0.03x*"):
        rr = router.submit(prompt, sp, on_token=lambda r, t: seen.append(t))
        victim = _kill_after(router, rr, seen)
        assert rr.wait(60), "failover never completed"
    assert rr.state == "finished", (rr.state, rr.error)
    assert rr.failovers == 1 and rr.replica != victim
    assert rr.tokens == want and seen == want
    assert router.stats()["replay_suppressed"] >= before + 3
    heal(router, reps)


def test_engine_fault_retries_on_the_sibling(live_fleet, ref):
    router, _ = live_fleet
    prompt = [7, 7, 3, 2, 9, 1, 4, 4, 8, 6]
    want = _ref_greedy(ref, prompt, 8)
    with FaultPlan.parse("serving.prefill:error@1"):
        rr = router.submit(prompt, SamplingParams(max_new_tokens=8))
        assert rr.wait(60)
    assert rr.state == "finished", (rr.state, rr.error)
    assert rr.retries == 1 and rr.tokens == want


def test_cancel_and_drain_on_live_replicas(live_fleet, ref):
    router, reps = live_fleet
    rr = router.submit([5, 4, 3, 2, 1, 5, 4, 3, 2],
                       SamplingParams(max_new_tokens=30))
    assert router.cancel(rr.gid)
    assert rr.wait(30) and rr.state == "cancelled"
    assert not router.cancel(rr.gid) and not router.cancel(424242)
    prompt = [2, 4, 6, 8, 10, 12, 14, 16, 18, 20]
    want = _ref_greedy(ref, prompt, 10)
    rr = router.submit(prompt, SamplingParams(max_new_tokens=10))
    report = router.drain(rr.replica, budget_s=60.0)
    assert report["drained"] and report["completed_in_budget"]
    assert rr.wait(10) and rr.state == "finished" and rr.failovers == 0
    assert rr.tokens == want
    heal(router, reps)


def test_proc_replica_sigkill_fails_over(tmp_path):
    """A real child process (``python -m
    paddle_tpu_torch.serving.replica_worker`` on the CPU) SIGKILLed
    mid-stream: the router sees the pipe close and its request finishes
    on an in-process replica built from the same spec."""
    spec = {"seed": 4, "device": "cpu", "llama_tiny": CFG,
            "engine": {"block_size": 8, "max_slots": 2, "max_model_len": 64},
            "stats_interval_s": 0.02, "warmup": list(range(1, 11))}
    proc = ProcReplica("p0", spec, env={
        "FLAGS_fault_plan": "serving.decode:delay=0.04x*",
        "OMP_NUM_THREADS": "1"}, log_path=str(tmp_path / "p0.log"))
    local = LocalReplica("l0", lambda: LLMEngine(build_model(spec),
                                                 **spec["engine"]),
                         stats_interval_s=0.02)
    router = FleetRouter([proc, local], probe_interval_s=0.05,
                         probe_timeout_s=10.0, affinity_block_size=8)
    try:
        router.start(wait_healthy_s=60)
        assert proc.state is ReplicaState.HEALTHY, (
            proc.state, (tmp_path / "p0.log").read_text()[-2000:])
        assert local.state is ReplicaState.HEALTHY
        assert router.stats()["replicas"]["p0"]["proto_version"] == 1
        # a prompt whose affinity names the child (first in order)
        rng = np.random.RandomState(2)
        while True:
            prompt = [int(t) for t in rng.randint(0, VOCAB, 12)]
            if router._affinity_key(prompt) % 2 == 0:
                break
        sp = SamplingParams(max_new_tokens=16)
        want = naive_generate(build_model(spec), prompt, sp)
        seen = []
        rr = router.submit(prompt, sp, on_token=lambda r, t: seen.append(t))
        assert rr.replica == "p0"
        pid = proc.pid
        _kill_after(router, rr, seen)
        assert rr.wait(60), "failover never completed"
        assert rr.state == "finished", (rr.state, rr.error)
        assert rr.failovers == 1 and rr.replica == "l0"
        assert rr.tokens == want and seen == want
        assert proc.proc.wait(10) == -9 and not proc.alive
        st = router.stats()
        assert st["replicas"]["p0"]["state"] == "unhealthy"
        assert st["replica_deaths"] >= 1 and st["failovers"] == 1
        # restart brings a new child up
        router.restart("p0")
        deadline = time.monotonic() + 60
        while proc.state is not ReplicaState.HEALTHY and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert proc.state is ReplicaState.HEALTHY and proc.pid != pid
    finally:
        router.close()
        if proc.proc is not None and proc.alive:
            proc.proc.kill()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_regression_r31_a_starting_replica_is_alive(pkg):
    """R31: the reference's ``LocalReplica.start`` sets STARTING before its
    new driver thread runs, so a health probe in between reads a dead
    STARTING replica and marks it UNHEALTHY for good (a restart then never
    turns HEALTHY). The port's driver is alive first."""
    gate = threading.Event()
    seen = []
    base = LocalReplica if pkg == "port" else JLocalReplica

    class Watched(base):
        def __setattr__(self, k, v):
            object.__setattr__(self, k, v)
            if k == "state" and v.value == "starting":
                seen.append(self.alive)

    def factory():
        gate.wait(10)
        raise RuntimeError("no engine here")

    rep = Watched("w", factory)
    for _ in range(2):                  # a start, then a restart after a kill
        gate.clear()
        rep.start(lambda r, ev: None)
        rep.kill()
        gate.set()
        rep._thread.join(10)
    assert seen == ([True, True] if pkg == "port" else [False, False])
