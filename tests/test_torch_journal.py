"""The port's write-ahead journal (paddle_tpu_torch.serving.journal) against
the JAX package's: the same calls write the same bytes, either package
reads the other's files (rotation and compaction included), a torn tail
or garbage line is skipped by its CRC, the ``gateway.journal.*`` fault
sites, and one ``gateway_worker`` process SIGKILLed mid-stream and
restarted over its journal without losing an accepted request.
"""
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from paddle_tpu.serving import journal as jjournal

from paddle_tpu_torch.serving import journal
from paddle_tpu_torch.serving import naive_generate, SamplingParams
from paddle_tpu_torch.serving.journal import (Journal, JournalError,
                                              JournalTornWrite, scan_dir)
from paddle_tpu_torch.serving.replica_worker import build_model
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.faults import FaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.deactivate()


def segments(root):
    return sorted(p for p in os.listdir(root) if p.startswith("wal-"))


def _write(mod, root, monkeypatch):
    """One fixed sequence of journal calls (rotation and a compaction
    included) under a frozen wall clock; returns the files' bytes."""
    monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    j = mod.Journal(str(root), fsync="never", segment_max_records=5,
                    compact_segments=2, retain_terminal=2)
    j.accept("live", gateway_id="gw", prompt=[1, 2, 3],
             sampling={"seed": 7, "temperature": 0.5}, priority=2,
             idem="key-1", created=1700000000)
    j.bind("live", "cmpl-0")
    j.mark("live", 2, [10, 11])
    for i in range(8):
        j.accept(f"t{i}", gateway_id="gw", prompt=[i], sampling={},
                 created=1700000001)
        j.end(f"t{i}", state="finished", reason="length", rid=f"cmpl-{i}",
              tokens=[i, i + 1])
    j.mark("live", 4, [12, 13])
    j.close()
    return {p: open(os.path.join(root, p), "rb").read()
            for p in segments(str(root))}


def test_the_same_calls_write_the_same_bytes(tmp_path, monkeypatch):
    mine = _write(journal, tmp_path / "port", monkeypatch)
    theirs = _write(jjournal, tmp_path / "ref", monkeypatch)
    assert mine == theirs and len(mine) >= 2
    for mod, other in ((journal, "ref"), (jjournal, "port")):
        s = mod.scan_dir(str(tmp_path / other))
        assert s.torn_records == 0
        assert [e["jid"] for e in s.recoverable()] == ["live"]
        assert s.requests["live"]["tokens"] == [10, 11, 12, 13]
        assert s.by_idem()["key-1"]["jid"] == "live"
        assert "t7" in s.requests and s.requests["t7"]["tokens"] == [7, 8]


def test_each_package_recovers_the_other_s_journal(tmp_path):
    j = jjournal.Journal(str(tmp_path))
    j.accept("a", gateway_id="gw", prompt=[1], sampling={"seed": 1})
    j.mark("a", 2, [4, 5])
    j.accept("b", gateway_id="gw", prompt=[2], sampling={})
    j.end("b", state="finished", tokens=[6])
    j.close()
    mine = Journal(str(tmp_path))
    assert [e["jid"] for e in mine.recovered.recoverable()] == ["a"]
    assert mine.recovered.requests["a"]["tokens"] == [4, 5]
    mine.end("a", state="finished", reason="length", tokens=[4, 5, 9])
    mine.close()
    theirs = jjournal.scan_dir(str(tmp_path))
    assert theirs.recoverable() == []
    assert theirs.requests["a"]["tokens"] == [4, 5, 9]
    assert len(segments(str(tmp_path))) == 2


def test_torn_tail_and_garbage_are_skipped(tmp_path):
    j = Journal(str(tmp_path))
    j.accept("a", gateway_id="gw", prompt=[1], sampling={})
    j.accept("b", gateway_id="gw", prompt=[2], sampling={})
    j.close()
    path = os.path.join(str(tmp_path), segments(str(tmp_path))[-1])
    with open(path, "r+b") as f:
        f.seek(0, 2)
        f.truncate(f.tell() - 5)          # chop mid-frame: a torn tail
    for mod in (journal, jjournal):
        s = mod.scan_dir(str(tmp_path))
        assert s.torn_records == 1
        assert "a" in s.requests and "b" not in s.requests
    j = Journal(str(tmp_path / "g"))
    j.accept("c", gateway_id="gw", prompt=[3], sampling={})
    j.close()
    path = os.path.join(str(tmp_path / "g"), segments(str(tmp_path / "g"))[0])
    with open(path, "ab") as f:
        f.write(b"deadbeef not-json-at-all\n")
        f.write(b"total garbage without a crc\n")
    for mod in (journal, jjournal):
        s = mod.scan_dir(str(tmp_path / "g"))
        assert s.torn_records == 2 and "c" in s.requests


def test_rotation_and_compaction_bound_disk(tmp_path):
    j = Journal(str(tmp_path), segment_max_records=4, compact_segments=2,
                retain_terminal=3)
    j.accept("live", gateway_id="gw", prompt=[0], sampling={})
    j.mark("live", 2, [1, 2])
    for i in range(30):
        j.accept(f"t{i}", gateway_id="gw", prompt=[i], sampling={})
        j.end(f"t{i}", state="finished", tokens=[i])
    assert len(segments(str(tmp_path))) <= 4
    s = scan_dir(str(tmp_path))
    assert [e["jid"] for e in s.recoverable()] == ["live"]
    assert s.requests["live"]["tokens"] == [1, 2]
    assert len(s.terminal()) < 30 and "t29" in s.requests
    assert j.stats()["non_terminal"] == 1
    j.close()
    with pytest.raises(JournalError):
        j.accept("x", gateway_id="gw", prompt=[1], sampling={})
    with pytest.raises(ValueError):
        Journal(str(tmp_path), fsync="sometimes")


def test_fault_sites(tmp_path):
    j = Journal(str(tmp_path / "a"), fsync="always")
    with FaultPlan.parse("gateway.journal.append:error@2"):
        j.accept("a", gateway_id="gw", prompt=[1], sampling={})
        with pytest.raises(faults.FaultError):
            j.accept("b", gateway_id="gw", prompt=[2], sampling={})
    with FaultPlan.parse("gateway.journal.append:torn_write@2") as p:
        j.mark("a", 2, [5, 6])
        with pytest.raises(JournalTornWrite):
            j.mark("a", 4, [7, 8])          # dies mid-write
        j.mark("a", 4, [7, 8])              # framing resyncs after a tear
    assert p.fired_at("gateway.journal.append") == 1
    with FaultPlan.parse("gateway.journal.fsync:error@1"):
        with pytest.raises(faults.FaultError):
            j.end("a", state="finished", tokens=[5, 6, 7, 8])
    j.close()
    for mod in (journal, jjournal):
        s = mod.scan_dir(str(tmp_path / "a"))
        assert s.torn_records == 1 and "b" not in s.requests
        assert s.requests["a"]["tokens"] == [5, 6, 7, 8]


# ---------------------------------------------------------------------------
# the gateway process: SIGKILL mid-stream, recover from the journal
# ---------------------------------------------------------------------------

CFG = dict(vocab=61, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           seq=64)


def _spawn(gspec, log, plan=None):
    if os.path.exists(gspec["ready_file"]):
        os.remove(gspec["ready_file"])
    env = dict(os.environ, PADDLE_GATEWAY_SPEC=json.dumps(gspec),
               PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("FLAGS_fault_plan", None)
    if plan:
        env["FLAGS_fault_plan"] = plan
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.gateway_worker"],
        env=env, stdout=open(log, "w"), stderr=subprocess.STDOUT, cwd=REPO)


def _ready(gspec, proc, log, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"gateway worker exited {proc.returncode}:"
                                 f" {open(log).read()[-2000:]}")
        if os.path.exists(gspec["ready_file"]):
            with open(gspec["ready_file"]) as f:
                return json.load(f)
        time.sleep(0.05)
    raise AssertionError("gateway worker never became ready")


class _Client(threading.Thread):
    """An SSE client that records event ids, takes a dropped connection
    as a pause, and resumes with Idempotency-Key + Last-Event-ID."""

    def __init__(self, port, prompt, key, n):
        super().__init__(daemon=True)
        self.prompt, self.key, self.n = prompt, key, n
        self.tokens, self.last_id = [], 0
        self.finish = self.error = None
        self.interrupted = False
        self.port = port
        self.start()

    def _read(self, port, last_id):
        body = {"prompt": self.prompt, "max_tokens": self.n,
                "temperature": 0.0, "stream": True}
        headers = {"Content-Type": "application/json",
                   "Idempotency-Key": self.key}
        if last_id:
            headers["Last-Event-ID"] = str(last_id)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/completions", json.dumps(body), headers)
        resp = conn.getresponse()
        if resp.status != 200:
            self.error = f"HTTP {resp.status}"
            return
        while True:
            line = resp.readline()
            if not line:
                self.interrupted = True
                break
            line = line.decode().strip()
            if line.startswith("id: "):
                self.last_id = int(line[4:])
            elif line == "data: [DONE]":
                break
            elif line.startswith("data: "):
                ch = json.loads(line[6:])["choices"][0]
                self.tokens += ch.get("token_ids") or []
                self.finish = ch.get("finish_reason") or self.finish
        conn.close()

    def run(self):
        try:
            self._read(self.port, 0)
        except Exception:   # lint: allow-silent(a torn connection is the pause this client resumes from)
            self.interrupted = True

    def resume(self, port):
        self.interrupted = False
        self._read(port, self.last_id)


def test_gateway_sigkill_loses_no_accepted_request(tmp_path):
    spec = {"seed": 2, "device": "cpu", "llama_tiny": CFG,
            "engine": {"block_size": 8, "max_slots": 2, "max_model_len": 64},
            "warmup": list(range(1, 11)), "n_replicas": 2,
            "stats_interval_s": 0.05,
            "router": {"probe_interval_s": 0.1, "probe_timeout_s": 30.0,
                       "affinity_block_size": 8},
            "gateway": {"journal_dir": str(tmp_path / "journal"),
                        "journal_watermark_every": 2},
            "ready_file": str(tmp_path / "ready.json")}
    prompts = [[3 + i, 1, 4, 1, 5, 9, 2, 6, 5, 3] for i in range(3)]
    model = build_model(spec)
    refs = [naive_generate(model, p, SamplingParams(max_new_tokens=12))
            for p in prompts]
    # a decode delay keeps the streams in flight when the kill lands
    proc = _spawn(spec, str(tmp_path / "gw1.log"),
                  "serving.decode:delay=0.05x*")
    try:
        info = _ready(spec, proc, str(tmp_path / "gw1.log"))
        clients = [_Client(info["port"], p, f"dur-{i}", 12)
                   for i, p in enumerate(prompts)]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                sum(len(c.tokens) for c in clients) < 3:
            time.sleep(0.01)
        assert sum(len(c.tokens) for c in clients) >= 3
        os.kill(proc.pid, signal.SIGKILL)
        for c in clients:
            c.join(30)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(30)
    assert any(c.interrupted for c in clients)
    proc2 = _spawn(spec, str(tmp_path / "gw2.log"))
    try:
        info2 = _ready(spec, proc2, str(tmp_path / "gw2.log"))
        rec = info2["recovery"] or {}
        assert rec.get("recovered", 0) + rec.get("restored_terminal", 0) >= 1
        for c in clients:
            c.resume(info2["port"])
        assert [c.error for c in clients] == [None] * 3
        assert [c.finish for c in clients] == ["length"] * 3
        assert [c.tokens for c in clients] == refs
    finally:
        proc2.send_signal(signal.SIGTERM)
        try:
            proc2.wait(30)
        except subprocess.TimeoutExpired:
            proc2.kill()
            proc2.wait(10)
