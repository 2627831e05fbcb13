"""The port's HTTP gateway (paddle_tpu_torch.serving.gateway) against the
JAX package's.

- Over a live two-``LocalReplica`` fleet on the reference's converted
  weights: ``/v1/completions`` (plain and SSE) and
  ``/v1/chat/completions`` equal the reference's uncached greedy decode;
  a replica killed mid-SSE-stream is invisible to the client; an
  ``Idempotency-Key`` retry replays byte for byte; a ``Last-Event-ID``
  resume gets exactly the missing suffix; 401 (tenancy keys), 429 (a
  tenant's bucket) and the ops endpoints.
- Over scripted fake fleets (each package's own router): the same
  requests give response bodies with the same keys in both packages, and
  the same values where no id or clock enters; a fleet-wide shed is 429
  with Retry-After, no healthy replica 503.
"""
import http.client
import json
import socket
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
from paddle_tpu.serving import Gateway as JGateway
from paddle_tpu.serving import ReplicaState as JReplicaState
from paddle_tpu.serving.tenancy import TenantRegistry as JTenantRegistry

from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny, state_from_jax
from paddle_tpu_torch.serving import (FleetRouter, Gateway, LLMEngine,
                                      LocalReplica, ReplicaState, Tenant,
                                      TenantRegistry)
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.faults import FaultPlan

torch.set_num_threads(1)
VOCAB = 61
CFG = dict(vocab=VOCAB, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           seq=64)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.deactivate()


def request(gw, method, path, body=None, headers=None, timeout=60):
    conn = http.client.HTTPConnection(gw.host, gw.port, timeout=timeout)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json", **(headers or {})})
    return conn.getresponse(), conn


def post(gw, path, body, headers=None):
    resp, conn = request(gw, "POST", path, body, headers)
    raw = resp.read()
    conn.close()
    return resp, raw


def read_sse(resp, stop_after=None):
    """(tokens, finish_reason, event ids, raw lines) of an SSE body; with
    ``stop_after`` it returns after that many token events."""
    toks, finish, ids, lines = [], None, [], []
    while True:
        line = resp.readline()
        if not line:
            break
        lines.append(line)
        line = line.decode().strip()
        if line.startswith("id: "):
            ids.append(int(line[4:]))
        elif line == "data: [DONE]":
            break
        elif line.startswith("data: "):
            ch = json.loads(line[6:])["choices"][0]
            toks += ch.get("token_ids") or []
            finish = ch.get("finish_reason") or finish
            if stop_after is not None and len(toks) >= stop_after:
                break
    return toks, finish, ids, lines


# ---------------------------------------------------------------------------
# a live fleet on the reference's weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    paddle_tpu.seed(0)
    jm = JLlama(j_llama_tiny(**CFG))
    params, buffers = functional_state(jm)
    fwd = jax.jit(lambda ids: functional_call(jm, params, buffers, ids,
                                              training=False)[0])

    def greedy(prompt, n):
        """The reference's uncached greedy decode (``naive_generate``'s
        loop) under one jit at a padded length of 32 (causal rows before
        the padding do not see it)."""
        toks, out = [int(t) for t in prompt], []
        for _ in range(n):
            ids = np.zeros((1, 32), np.int32)
            ids[0, :len(toks)] = toks
            tok = int(jnp.argmax(fwd(jnp.asarray(ids))[0, len(toks) - 1]))
            out.append(tok)
            toks.append(tok)
        return out

    state = state_from_jax({k: np.asarray(v) for k, v in params.items()})
    return greedy, state


@pytest.fixture(scope="module")
def fleet(ref, tmp_path_factory):
    state = ref[1]

    def factory():
        m = LlamaForCausalLM(llama_tiny(**CFG), device="cpu")
        m.load_state_dict(state)
        return LLMEngine(m.eval(), block_size=8, max_slots=2,
                         max_model_len=64)

    reps = [LocalReplica(f"g{i}", factory, stats_interval_s=0.02,
                         warmup=list(range(1, 11))) for i in range(2)]
    router = FleetRouter(reps, probe_interval_s=0.05, probe_timeout_s=10.0,
                         affinity_block_size=8).start(wait_healthy_s=60)
    gw = Gateway(router, journal_dir=str(tmp_path_factory.mktemp("wal")),
                 journal_watermark_every=2).start()
    try:
        assert all(r.state is ReplicaState.HEALTHY for r in reps)
        yield gw, router, reps
    finally:
        gw.stop()
        router.close()


def test_completions_chat_and_sse_equal_the_reference(fleet, ref):
    gw, _, _ = fleet
    greedy = ref[0]
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    want = greedy(prompt, 6)
    resp, raw = post(gw, "/v1/completions", {"prompt": prompt,
                                             "max_tokens": 6})
    doc = json.loads(raw)
    assert resp.status == 200
    c = doc["choices"][0]
    assert c["token_ids"] == want and c["finish_reason"] == "length"
    assert c["text"] == " ".join(str(t) for t in want)
    assert doc["usage"] == {"prompt_tokens": 10, "completion_tokens": 6,
                            "total_tokens": 16}
    assert doc["paddle_tpu"]["replica"] in ("g0", "g1")
    resp, raw = post(gw, "/v1/chat/completions", {
        "messages": [{"role": "system", "content": prompt[:4]},
                     {"role": "user", "content": " ".join(
                         str(t) for t in prompt[4:])}], "max_tokens": 6})
    doc = json.loads(raw)
    assert doc["object"] == "chat.completion"
    assert doc["choices"][0]["token_ids"] == want
    assert doc["choices"][0]["message"]["role"] == "assistant"
    resp, conn = request(gw, "POST", "/v1/completions",
                         {"prompt": [9, 8, 7, 6, 5, 4, 3, 2, 1, 0],
                          "max_tokens": 8, "stream": True})
    assert resp.getheader("Content-Type") == "text/event-stream"
    toks, finish, ids, _ = read_sse(resp)
    conn.close()
    assert toks == greedy([9, 8, 7, 6, 5, 4, 3, 2, 1, 0], 8)
    assert finish == "length" and ids == list(range(1, 9))


def test_kill_mid_sse_stream_is_invisible(fleet, ref):
    gw, router, reps = fleet
    prompt = [8, 6, 7, 5, 3, 0, 9, 1, 2, 4]
    want = ref[0](prompt, 14)
    with FaultPlan.parse("serving.decode:delay=0.03x*"):
        resp, conn = request(gw, "POST", "/v1/completions",
                             {"prompt": prompt, "max_tokens": 14,
                              "stream": True})
        head, _, _, _ = read_sse(resp, stop_after=3)
        victim = [r for r in reps
                  if router.stats()["replicas"][r.rid]["inflight"]][0]
        victim.kill()
        rest, finish, _, _ = read_sse(resp)
        conn.close()
    assert head + rest == want and finish == "length"
    st = router.stats()
    assert st["failovers"] >= 1 and st["replay_suppressed"] >= 3
    router.restart(victim.rid)
    deadline = time.monotonic() + 60
    while victim.state is not ReplicaState.HEALTHY and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert victim.state is ReplicaState.HEALTHY


def test_idempotent_retry_replays_byte_identically(fleet, ref):
    gw, router, _ = fleet
    prompt = [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]
    body = {"prompt": prompt, "max_tokens": 5}
    hdr = {"Idempotency-Key": "idem-plain"}
    r1, raw1 = post(gw, "/v1/completions", body, hdr)
    before = router.stats()["dispatches"]
    r2, raw2 = post(gw, "/v1/completions", body, hdr)
    assert r1.status == r2.status == 200 and raw1 == raw2
    assert router.stats()["dispatches"] == before        # never re-run
    assert json.loads(raw1)["choices"][0]["token_ids"] == ref[0](prompt, 5)
    # a streamed one replays its whole event stream byte for byte
    sbody = dict(body, stream=True)
    shdr = {"Idempotency-Key": "idem-sse"}
    resp, conn = request(gw, "POST", "/v1/completions", sbody, shdr)
    first = read_sse(resp)
    conn.close()
    resp, conn = request(gw, "POST", "/v1/completions", sbody, shdr)
    again = read_sse(resp)
    conn.close()
    assert first[3] == again[3] and first[0] == ref[0](prompt, 5)


def test_last_event_id_resume_gets_the_missing_suffix(fleet, ref):
    gw, _, _ = fleet
    prompt = [1, 4, 1, 4, 2, 1, 3, 5, 6, 2]
    want = ref[0](prompt, 10)
    body = {"prompt": prompt, "max_tokens": 10, "stream": True}
    hdr = {"Idempotency-Key": "idem-resume"}
    with FaultPlan.parse("serving.decode:delay=0.03x*"):
        resp, conn = request(gw, "POST", "/v1/completions", body, hdr)
        head, _, ids, _ = read_sse(resp, stop_after=3)
        conn.close()                  # the client drops mid-stream
    resp, conn = request(gw, "POST", "/v1/completions", body,
                         dict(hdr, **{"Last-Event-ID": str(ids[-1])}))
    rest, finish, ids2, _ = read_sse(resp)
    conn.close()
    assert head == want[:len(head)] and head + rest == want
    assert ids2[0] == ids[-1] + 1 and finish == "length"
    # and by id on GET /v1/streams/<completion id>
    rid = None
    for st in list(gw._streams.values()):
        if st.idem == "idem-resume":
            rid = st.rid
    resp, conn = request(gw, "GET", f"/v1/streams/{rid}", None,
                         {"Last-Event-ID": "8"})
    tail, _, _, _ = read_sse(resp)
    conn.close()
    assert tail == want[8:]


def test_tenancy_401_and_429(fleet):
    _, router, _ = fleet
    reg = TenantRegistry([
        Tenant("acme", api_keys=("k-acme",)),
        Tenant("tiny", api_keys=("k-tiny",), rate_tokens_per_s=1.0,
               burst_tokens=20.0)])
    gw = Gateway(router, tenancy=reg).start()
    try:
        body = {"prompt": [1, 2, 3, 4, 5], "max_tokens": 4}
        resp, raw = post(gw, "/v1/completions", body)
        assert resp.status == 401
        assert resp.getheader("WWW-Authenticate") == "Bearer"
        assert json.loads(raw)["error"]["type"] == "authentication_error"
        resp, raw = post(gw, "/v1/completions", body,
                         {"Authorization": "Bearer nope"})
        assert resp.status == 401
        resp, raw = post(gw, "/v1/completions", body,
                         {"Authorization": "Bearer k-acme"})
        assert resp.status == 200
        resp, raw = post(gw, "/v1/completions", body,
                         {"Authorization": "k-tiny"})
        assert resp.status == 200                 # 9 of 20 burst tokens
        resp, raw = post(gw, "/v1/completions", body,
                         {"Authorization": "k-tiny"})
        resp, raw = post(gw, "/v1/completions", body,
                         {"Authorization": "k-tiny"})
        assert resp.status == 429
        err = json.loads(raw)["error"]
        assert err["tenant"] == "tiny" and err["type"] == "overloaded_error"
        assert int(resp.getheader("Retry-After")) >= 1
        with FaultPlan.parse("gateway.auth:error@1"):
            resp, raw = post(gw, "/v1/completions", body,
                             {"Authorization": "k-acme"})
        assert resp.status == 401                 # fails closed
    finally:
        gw.stop()


def test_ops_endpoints(fleet):
    gw, router, _ = fleet
    resp, conn = request(gw, "GET", "/healthz")
    doc = json.loads(resp.read())
    conn.close()
    assert resp.status == 200 and doc["status"] == "ok"
    resp, conn = request(gw, "GET", "/v1/models")
    assert json.loads(resp.read())["data"][0]["id"] == "paddle-tpu"
    conn.close()
    resp, conn = request(gw, "GET", "/stats")
    st = json.loads(resp.read())
    conn.close()
    assert set(st["replicas"]) == {"g0", "g1"}
    assert st["gateway"]["journal"]["non_terminal"] == 0
    resp, conn = request(gw, "GET", "/metrics")
    text = resp.read().decode()
    conn.close()
    assert "router_dispatches_total" in text and "gateway_" in text


# ---------------------------------------------------------------------------
# both packages' gateways over scripted fake fleets
# ---------------------------------------------------------------------------

class AutoReplica:
    """A fake replica that answers every ``add`` with tokens 1..n and a
    finish, from its own thread (as a real replica's events arrive)."""

    kind = "fake"

    def __init__(self, rid, state_cls):
        self.rid, self.state_cls = rid, state_cls
        self.state = state_cls.STOPPED
        self.stats = {"slo": {"shed": False}}
        self.last_heartbeat = time.monotonic()
        self.pid, self.alive = 0, True
        self._on_event = None

    def start(self, on_event):
        self._on_event = on_event
        self.state = self.state_cls.HEALTHY

    def send(self, cmd):
        if cmd["op"] != "add":
            return
        n = cmd["sampling"]["max_new_tokens"]

        def run():
            time.sleep(0.01)
            for i in range(n):
                self._on_event(self, {"ev": "token", "gid": cmd["gid"],
                                      "tok": 1 + i, "i": i})
            self._on_event(self, {"ev": "done", "gid": cmd["gid"],
                                  "state": "finished", "reason": "length",
                                  "error": None, "n": n})
        threading.Thread(target=run, daemon=True).start()

    def stop(self, graceful=True, timeout=0):
        pass

    def kill(self):
        self.alive = False


def _keys(x):
    """The key structure of a JSON document (values dropped)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(v) for v in x[:1]]
    return type(x).__name__ if x is not None else None


def _exchange(gw_cls, router_cls, state_cls, tenancy):
    reps = [AutoReplica(f"f{i}", state_cls) for i in range(2)]
    router = router_cls(reps, affinity_block_size=8, probe_interval_s=60)
    for r in reps:
        r.start(router._on_event)
    gw = gw_cls(router, tenancy=tenancy, gateway_id="gw-x").start()
    out = {}
    try:
        for name, path, body in (
                ("completion", "/v1/completions",
                 {"prompt": [1, 2, 3], "max_tokens": 3, "seed": 5}),
                ("chat", "/v1/chat/completions",
                 {"messages": [{"role": "user", "content": "1 2 3"}],
                  "max_tokens": 2}),
                ("bad", "/v1/completions", {"prompt": []})):
            resp, raw = post(gw, path, body)
            out[name] = (resp.status, json.loads(raw))
        resp, conn = request(gw, "POST", "/v1/completions",
                             {"prompt": [1, 2, 3], "max_tokens": 2,
                              "stream": True})
        out["sse"] = [ln for ln in read_sse(resp)[3]]
        conn.close()
        for name, path in (("healthz", "/healthz"), ("models", "/v1/models"),
                           ("stats", "/stats"), ("missing", "/nope")):
            resp, conn = request(gw, "GET", path)
            out[name] = (resp.status, json.loads(resp.read()))
            conn.close()
        for r in reps:
            r.stats = {"slo": {"shed": True}}
        resp, raw = post(gw, "/v1/completions", {"prompt": [1, 2, 3]})
        out["shed"] = (resp.status, json.loads(raw),
                       resp.getheader("Retry-After"))
        for r in reps:
            r.state = state_cls.UNHEALTHY
        resp, raw = post(gw, "/v1/completions", {"prompt": [1, 2, 3]})
        out["down"] = (resp.status, json.loads(raw))
        resp, conn = request(gw, "GET", "/healthz")
        out["healthz_down"] = (resp.status, json.loads(resp.read()))
        conn.close()
    finally:
        gw.stop()
        router.close()
    return out


def test_response_bodies_match_the_reference_gateway():
    mine = _exchange(Gateway, FleetRouter, ReplicaState, TenantRegistry())
    theirs = _exchange(JGateway, JFleetRouter, JReplicaState,
                       JTenantRegistry())
    assert set(mine) == set(theirs)
    for name in mine:
        a, b = mine[name], theirs[name]
        if name == "sse":
            ka = [_keys(json.loads(x[6:])) for x in a
                  if x.startswith(b"data: {")]
            kb = [_keys(json.loads(x[6:])) for x in b
                  if x.startswith(b"data: {")]
            assert ka == kb
            assert [x for x in a if not x.startswith(b"data: {")] == \
                [x for x in b if not x.startswith(b"data: {")]
            continue
        assert a[0] == b[0], name                  # the status code
        if name == "stats":
            assert set(a[1]) == set(b[1])
            assert set(a[1]["gateway"]) == set(b[1]["gateway"])
            continue
        assert _keys(a[1]) == _keys(b[1]), name
    for name in ("completion", "chat"):
        for d in (mine[name][1], theirs[name][1]):
            d.pop("id"), d.pop("created")
            d["paddle_tpu"].pop("trace_id")
        assert mine[name][1] == theirs[name][1]
    assert mine["completion"][1]["choices"][0]["token_ids"] == [1, 2, 3]
    assert mine["bad"] == theirs["bad"] and mine["bad"][0] == 400
    assert mine["missing"] == theirs["missing"]
    assert mine["shed"][0] == 429 and mine["shed"][2] == theirs["shed"][2]
    assert mine["down"][0] == 503 and mine["healthz_down"][0] == 503
    assert mine["models"] == theirs["models"]


def test_pipelined_request_after_a_400_is_served(fleet):
    gw, _, _ = fleet
    s = socket.create_connection((gw.host, gw.port), timeout=30)
    try:
        bad = b"{not json"
        good = json.dumps({"prompt": [1, 2, 3, 4, 5], "max_tokens": 2})
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\nContent-Length: "
                  + str(len(bad)).encode() + b"\r\n\r\n" + bad
                  + b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\nContent-Length: "
                  + str(len(good)).encode() + b"\r\n\r\n" + good.encode())
        buf = b""
        deadline = time.monotonic() + 30
        while buf.count(b"HTTP/1.1 ") < 2 and time.monotonic() < deadline:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        assert buf.startswith(b"HTTP/1.1 400")
        assert b"HTTP/1.1 200" in buf
    finally:
        s.close()
