"""The port's native TCPStore (paddle_tpu_torch.distributed.tcp_store over
csrc/tcp_store.cpp, built by paddle_tpu_torch.core.native) against the JAX
package's: either package's client on the other's server for every verb,
timeouts and their messages, retries under the ``store.*`` fault sites
(the same plan fires at the same calls in both), the build rule, and
``telemetry.cluster.start_from_env`` dialling the store from the
environment (the repaired deviation).
"""
import json
import threading
import time

import pytest

from paddle_tpu.distributed.tcp_store import TCPStore as JStore
from paddle_tpu.utils import faults as jfaults

from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core import native
from paddle_tpu_torch.distributed import (StoreCorruptValue, StoreTimeout,
                                          TCPStore)
from paddle_tpu_torch.telemetry import cluster
from paddle_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.deactivate()
    jfaults.deactivate()


def _verbs(server_cls, client_cls):
    """set / get / add / wait / delete / JSON through ``client_cls`` on a
    ``server_cls`` master; returns what each verb answered."""
    master = server_cls(is_master=True)
    client = client_cls(port=master.port, timeout=5.0)
    try:
        out = []
        client.set("k", b"v1")
        out.append(master.get("k"))
        master.set("k2", "text")
        out.append(client.get("k2"))
        out.append(client.get("absent"))
        out.append([client.add("ctr", 3), master.add("ctr", 4),
                    client.add("ctr", -2)])
        out.append(client.wait("k", timeout=1.0))
        t0 = time.monotonic()
        out.append(client.wait("never", timeout=0.2))
        out.append(0.15 < time.monotonic() - t0 < 5.0)
        client.set_json("doc", {"a": [1, 2], "b": None})
        out.append(master.get_json("doc"))
        out.append(client.delete_key("k"))
        out.append(client.delete_key("k"))
        out.append(master.get("k"))
        big = bytes(range(256)) * 10000          # 2.4 MiB: past one buffer
        client.set("big", big)
        out.append(master.get("big") == big)
        return out
    finally:
        client.close()
        master.close()


@pytest.mark.parametrize("server,client", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_every_verb_across_the_packages(server, client):
    cls = {"port": TCPStore, "ref": JStore}
    got = _verbs(cls[server], cls[client])
    want = _verbs(JStore, JStore)
    assert got == want
    assert got[0] == b"v1" and got[2] is None and got[3] == [3, 7, 5]
    assert got[4] is True and got[5] is False and got[6] is True
    assert got[7] == {"a": [1, 2], "b": None}
    assert got[8:11] == [True, False, None] and got[11] is True


def test_large_values_grow_the_read_buffer():
    master = TCPStore(is_master=True)
    try:
        blob = b"x" * (3 << 20)
        master.set("blob", blob)
        assert master.get("blob") == blob
    finally:
        master.close()


def test_barrier_across_threads():
    master = TCPStore(is_master=True)
    clients = [TCPStore(port=master.port) for _ in range(3)]
    done = []

    def arrive(c):
        c.barrier("b", 3, timeout=10.0)
        done.append(1)

    ts = [threading.Thread(target=arrive, args=(c,)) for c in clients]
    for t in ts:
        t.start()
    for t in ts:
        t.join(15)
    try:
        assert len(done) == 3
        with pytest.raises(StoreTimeout, match="barrier 'lonely'"):
            clients[0].barrier("lonely", 2, timeout=0.2)
    finally:
        for c in clients:
            c.close()
        master.close()


def test_connect_timeout_names_the_endpoint():
    probe = TCPStore(is_master=True)
    port = probe.port
    probe.close()                               # nothing listens there now
    t0 = time.monotonic()
    with pytest.raises(StoreTimeout) as ei:
        TCPStore("127.0.0.1", port, timeout=0.6, retries=3, backoff_s=0.01)
    assert time.monotonic() - t0 < 10
    msg = str(ei.value)
    assert f"127.0.0.1:{port}" in msg and "3 connect attempts" in msg


def test_corrupt_json_is_not_absence():
    master = TCPStore(is_master=True)
    try:
        master.set("bad", b"\xff{not json")
        with pytest.raises(StoreCorruptValue, match="'bad'"):
            master.get_json("bad")
        assert master.get_json("missing") is None
    finally:
        master.close()


@pytest.mark.parametrize("plan", ["store.get:error@1", "store.set:error@1x2",
                                  "store.add:error@2", "store.wait:error@1"])
def test_retries_under_faults_equal_the_reference(plan):
    """One transient fault plan, both packages: the same calls retry, the
    verbs still answer, and the retry counts agree."""
    def drive(cls, fmod):
        master = cls(is_master=True)
        c = cls(port=master.port, backoff_s=0.001)
        try:
            with fmod.FaultPlan.parse(plan, seed=3) as p:
                c.set("a", b"1")
                out = [c.get("a"), c.add("n", 1), c.add("n", 1),
                       c.wait("a", timeout=1.0)]
            return out, c.num_retries, p.summary()
        finally:
            c.close()
            master.close()

    before = telemetry.registry().counter(
        "store_retries_total", "", ("op",)).labels(
        op=plan.split(".")[1].split(":")[0]).value
    got = drive(TCPStore, faults)
    assert got == drive(JStore, jfaults)
    assert got[0] == [b"1", 1, 2, True] and got[1] >= 1
    after = telemetry.registry().counter(
        "store_retries_total", "", ("op",)).labels(
        op=plan.split(".")[1].split(":")[0]).value
    assert after - before == got[1]


def test_exhausted_retries_raise_naming_key_and_endpoint():
    master = TCPStore(is_master=True)
    c = TCPStore(port=master.port, retries=3, backoff_s=0.001)
    try:
        with faults.FaultPlan.parse("store.get:error@1x*"):
            with pytest.raises(StoreTimeout) as ei:
                c.get("hot")
        msg = str(ei.value)
        assert "get('hot')" in msg and f":{master.port}" in msg
        assert "3 attempts" in msg
    finally:
        c.close()
        master.close()


def test_connect_fault_raises_in_both_packages():
    master = TCPStore(is_master=True)
    try:
        with faults.FaultPlan.parse("store.connect:error@1") as p:
            # an injected connect error raises out of the attempt in both
            # packages (the fault is not a refused dial)
            with pytest.raises(faults.FaultError):
                TCPStore(port=master.port)
        assert p.summary() == {"store.connect:error": 1}
        with jfaults.FaultPlan.parse("store.connect:error@1"):
            with pytest.raises(jfaults.FaultError):
                JStore(port=master.port)
    finally:
        master.close()


def test_library_builds_into_the_port_build_dir():
    lib = native.load()
    assert lib is not None
    path = native._lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-3:] == ("paddle_tpu_torch", "csrc", "build")
    assert native.SOURCE.name == "tcp_store.cpp"
    assert native.SOURCE.parent.parent == native.BUILD_DIR.parents[2]


def test_failed_build_is_none_without_a_card_and_raises_with_one(
        monkeypatch, tmp_path):
    bad = tmp_path / "tcp_store.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "_cuda_present", lambda: False)
    assert native.load() is None and not native.available()
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        TCPStore(is_master=True)
    monkeypatch.setattr(native, "_cuda_present", lambda: True)
    with pytest.raises(RuntimeError, match="did not build"):
        native.load()


def test_regression_start_from_env_dials_the_store(monkeypatch):
    """``$PADDLE_TELEMETRY_STORE`` alone starts a publisher that writes
    this rank's documents into a live store (it raised before)."""
    master = TCPStore(is_master=True)
    monkeypatch.setenv(cluster.STORE_ENV, f"127.0.0.1:{master.port}")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    pub = cluster.start_from_env(interval_s=0.05, sync_clock=False)
    try:
        assert isinstance(pub, cluster.RankPublisher)
        assert isinstance(pub.store, TCPStore) and pub.rank == 1
        deadline = time.monotonic() + 10
        meta = None
        while time.monotonic() < deadline:
            meta = master.get_json("telemetry/1/meta")
            if meta and meta.get("publish_seq", 0) >= 2:
                break
            time.sleep(0.02)
        assert meta["rank"] == 1 and meta["publish_seq"] >= 2
        assert isinstance(master.get_json("telemetry/1/metrics"), dict)
        assert json.loads(master.get("telemetry/1/flight")) is not None
    finally:
        pub.stop()
        pub.store.close()
        master.close()
    monkeypatch.delenv(cluster.STORE_ENV)
    assert cluster.start_from_env() is None
