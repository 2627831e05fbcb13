"""The port's observability and chaos layer (``paddle_tpu_torch.telemetry``,
``utils.faults``, ``analysis.locksan``) against the JAX package's.

Each test drives the same sequence of calls through both packages (fresh
registries, tracers and recorders, fake clocks where the reference's tests
use them; nothing sleeps to wait) and compares what they write: the
Prometheus text and the JSON snapshot character for character (the
snapshot's capture stamp and the exemplars' wall stamps aside), span trees,
flight events, a fault plan's firing indices (``%p`` included), a LockSan
inversion report, the SLO, history, alert, sampling-profiler and cluster
planes (the latter in process, over a dict store).
"""
import json
import re
import threading
import time
from types import SimpleNamespace

import pytest

import paddle_tpu.analysis.locksan as j_locksan
import paddle_tpu.telemetry as j_tel
import paddle_tpu.utils.faults as j_faults
from paddle_tpu.telemetry import alerts as j_alerts
from paddle_tpu.telemetry import cluster as j_cluster
from paddle_tpu.telemetry import history as j_history
from paddle_tpu.telemetry import pyprof as j_pyprof
from paddle_tpu.telemetry import reqtrace as j_reqtrace

import paddle_tpu_torch.analysis.locksan as t_locksan
import paddle_tpu_torch.telemetry as t_tel
import paddle_tpu_torch.utils.faults as t_faults
from paddle_tpu_torch.telemetry import alerts as t_alerts
from paddle_tpu_torch.telemetry import cluster as t_cluster
from paddle_tpu_torch.telemetry import history as t_history
from paddle_tpu_torch.telemetry import pyprof as t_pyprof
from paddle_tpu_torch.telemetry import reqtrace as t_reqtrace

J = SimpleNamespace(tel=j_tel, faults=j_faults, locksan=j_locksan,
                    history=j_history, alerts=j_alerts, pyprof=j_pyprof,
                    cluster=j_cluster, reqtrace=j_reqtrace)
T = SimpleNamespace(tel=t_tel, faults=t_faults, locksan=t_locksan,
                    history=t_history, alerts=t_alerts, pyprof=t_pyprof,
                    cluster=t_cluster, reqtrace=t_reqtrace)


def both(fn):
    """fn(package) through both packages; their results must be equal."""
    ref, port = fn(J), fn(T)
    assert port == ref
    return port


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt
        return self.t


def _strip_snapshot(snap):
    snap = dict(snap)
    snap.pop("__meta__")
    for fam in snap.values():
        for s in fam["series"]:
            for ex in s.get("exemplars", {}).values():
                ex.pop("ts")
    return snap


def _fill(P):
    """One registry through the calls the serving path makes."""
    reg = P.tel.MetricsRegistry()
    c = reg.counter("reqs_total", "requests", ("engine", "code"))
    c.labels(engine="0", code="200").inc()
    c.labels(engine="0", code="200").inc(2.5)
    c.labels(engine="1", code="500").inc()
    reg.counter("bare_total").inc(3)
    g = reg.gauge("depth", 'queue "depth"\nnow', ("q",))
    g.labels(q='a"b\\c\nd').set(7)
    g.labels(q="z").inc(2)
    g.labels(q="z").dec(0.5)
    h = reg.histogram("lat_seconds", "latency", ("engine",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v, ex in ((0.0005, None), (0.005, {"trace_id": "t1"}), (0.05, None),
                  (0.5, {"trace_id": "t2"}), (5.0, None), (0.01, None)):
        h.labels(engine="0").observe(v, exemplar=ex)
    reg.histogram("plain_seconds").observe(0.2)
    return reg


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _no_exemplar_stamps(text):
    """The exemplars' wall-clock stamps (time.time() at observation)."""
    return re.sub(r"( # \{[^}]*\} \S+) \S+$", r"\1", text, flags=re.M)


def test_prometheus_text_is_the_reference_s():
    text = both(lambda P: _no_exemplar_stamps(_fill(P).prometheus_text()))
    assert 'reqs_total{engine="0",code="200"} 3.5' in text
    assert 'lat_seconds_bucket{engine="0",le="0.01"} 3 # {trace_id="t1"}' \
        in text
    assert 'depth{q="a\\"b\\\\c\\nd"} 7' in text


def test_snapshot_json_is_the_reference_s():
    snap = both(lambda P: json.dumps(_strip_snapshot(_fill(P).snapshot()),
                                     sort_keys=True))
    assert json.loads(snap)["lat_seconds"]["series"][0]["count"] == 6


@pytest.mark.parametrize("case", ["kind", "labels", "neg", "bad_labels"])
def test_registry_rejects_as_the_reference_does(case):
    def run(P):
        reg = P.tel.MetricsRegistry()
        reg.counter("x", "", ("a",))
        try:
            if case == "kind":
                reg.gauge("x")
            elif case == "labels":
                reg.counter("x", "", ("b",))
            elif case == "neg":
                reg.counter("x", "", ("a",)).labels(a=1).inc(-1)
            else:
                reg.counter("x", "", ("a",)).labels(b=1)
        except ValueError as e:
            return str(e)
    assert both(run)


def test_disable_freezes_every_write_path():
    def run(P):
        reg = P.tel.MetricsRegistry()
        c = reg.counter("c")
        tr = P.tel.Tracer()
        fr = P.tel.FlightRecorder()
        P.tel.disable()
        try:
            assert not P.tel.enabled()
            c.inc()
            tr.emit("s", 0.0, 1.0)
            fr.record("k")
            with P.tel.span("quiet") as sp:
                pass
        finally:
            P.tel.enable()
        c.inc()
        return c.value, len(tr.spans()), len(fr), sp.span
    assert both(run) == (1.0, 0, 0, None)


def test_counts_are_exact_under_threads():
    def run(P):
        reg = P.tel.MetricsRegistry()
        c = reg.counter("n", "", ("t",))
        ths = [threading.Thread(target=lambda i=i: [
            c.labels(t=i % 2).inc() for _ in range(500)]) for i in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        return reg.prometheus_text()
    assert 'n{t="0"} 1000' in both(run)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _span_tree(spans):
    """(name, attrs, parent's name) rows, ids and times left out."""
    by_id = {s.span_id: s for s in spans}
    return [(s.name, sorted(s.attrs.items()),
             by_id[s.parent_id].name if s.parent_id in by_id else None)
            for s in spans]


def test_span_trees_are_the_reference_s():
    def run(P):
        tr = P.tel.tracer()
        tr.clear()
        with P.tel.span("engine.step", step=1):
            with P.tel.span("engine.prefill", rid=0, tokens=5):
                pass
            try:
                with P.tel.span("engine.decode", batch=2):
                    raise KeyError("x")
            except KeyError:
                pass
        root = tr.emit("request", 1.0, 2.0, attrs={"rid": 7}, tid=100_007,
                       tid_name="request-7")
        tr.emit("queued", 1.0, 1.5, attrs={"rid": 7},
                parent_id=root.span_id, tid=100_007)
        out = _span_tree(tr.spans())
        tr.clear()
        return out
    tree = both(run)
    assert ("engine.decode", [("batch", 2), ("error", "KeyError")],
            "engine.step") in tree


def test_chrome_export_and_capacity(tmp_path):
    def run(P):
        tr = P.tel.Tracer(capacity=3)
        for i in range(5):
            tr.emit(f"s{i}", i, i + 0.5, attrs={"i": i}, tid=5,
                    tid_name="row")
        path = tr.export_chrome(str(tmp_path / f"{P is T}.json"))
        doc = json.load(open(path))
        evs = [(e["ph"], e["name"], e.get("args", {}).get("i"),
                e.get("dur")) for e in doc["traceEvents"]]
        return evs, tr.dropped
    evs, dropped = both(run)
    assert dropped == 2 and evs[-1] == ("M", "thread_name", None, None)


def test_device_trace_annotation_lands_in_torch_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    T.tel.set_device_trace_active(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with T.tel.span("engine.decode", batch=1):
                torch.ones(4).sum()
    finally:
        T.tel.set_device_trace_active(False)
    assert "engine.decode" in {e.name for e in prof.events()}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _events(fr, drop=("t", "wall")):
    return [{k: v for k, v in e.items() if k not in drop}
            for e in fr.events()]


def test_flight_ring_and_dump_are_the_reference_s(tmp_path):
    def run(P):
        fr = P.tel.FlightRecorder(capacity=4)
        for i in range(6):
            fr.record("kv.alloc" if i % 2 else "scheduler.admit", n=i)
        path = fr.dump(path=str(tmp_path / f"{P is T}.json"),
                       reason="engine stall detector",
                       error=RuntimeError("pool dry"))
        doc = json.load(open(path))
        doc = {k: v for k, v in doc.items() if k not in ("pid", "wall_time")}
        for e in doc["events"]:
            e.pop("t"), e.pop("wall")
        return (_events(fr), [e["n"] for e in fr.events("kv.alloc")], doc,
                fr.dump(path=str(tmp_path / "no" / "such" / "dir" / "x")))
    evs, kv, doc, failed = both(run)
    assert [e["seq"] for e in evs] == [3, 4, 5, 6] and kv == [3, 5]
    assert doc["events_dropped"] == 2 and failed is None


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

def _firings(P, text, calls, seed=0):
    plan = P.faults.FaultPlan.parse(text, seed=seed)
    out = []
    with plan:
        for i in range(calls):
            for site in ("serving.prefill", "serving.kv.alloc",
                         "collective.all_reduce", "serving.decode.slot"):
                try:
                    act = P.faults.inject(site, i=i)
                except P.faults.FaultError as e:
                    act = f"error:{e.site}:{e.hit}"
                if act is not None:
                    out.append((i, site, act))
    return out, [(f.site, f.hit, f.kind) for f in plan.fired], \
        plan.summary(), dict(plan.calls)


@pytest.mark.parametrize("text,seed", [
    ("serving.prefill:error@2", 0),
    ("serving.kv.alloc:exhaust@3x2;serving.prefill:error@5x*", 0),
    ("serving.kv.alloc:exhaust%0.3", 7),
    ("serving.decode.slot:error=boom%0.5;collective:exhaust@4", 3),
    ("collective:stale_hash@1x3;serving.decode:error@1", 11),
])
def test_fault_plans_fire_at_the_same_calls(text, seed):
    out, fired, summary, calls = both(lambda P: _firings(P, text, 12, seed))
    assert fired and calls["serving.prefill"] == 12


def test_fault_grammar_errors_and_single_active_plan():
    def run(P):
        errs = []
        for bad in ("nosite", "a:explode", "a:error@x"):
            try:
                P.faults.FaultPlan.parse(bad)
            except ValueError as e:
                errs.append(str(e))
        p1, p2 = P.faults.FaultPlan(), P.faults.FaultPlan()
        with p1:
            try:
                P.faults.activate(p2)
            except RuntimeError as e:
                errs.append(str(e))
        return errs, [P.faults.site_matches(a, b) for a, b in (
            ("store", "store.get"), ("serving.decode", "serving.decode.slot"),
            ("serving", "serving.kv.alloc"), ("a.b", "a.b"))]
    errs, matches = both(run)
    assert len(errs) == 4 and matches == [True, False, True, True]


def test_fault_plan_flag_and_flight_event(monkeypatch):
    import paddle_tpu_torch as paddle

    T.tel.flight().clear()
    paddle.set_flags({"FLAGS_fault_plan": "serving.admit:error@2"})
    try:
        assert T.faults.inject("serving.admit") is None
        with pytest.raises(T.faults.FaultError, match="hit #2"):
            T.faults.inject("serving.admit", rid=4)
    finally:
        paddle.set_flags({"FLAGS_fault_plan": ""})
    assert T.faults.active_plan() is None
    ev = T.tel.flight().events("fault.injected")[-1]
    assert (ev["site"], ev["fault"], ev["hit"], ev["rid"]) == \
        ("serving.admit", "error", 2, 4)
    assert 'fault_injections_total{site="serving.admit",kind="error"}' in \
        T.tel.prometheus_text()


# ---------------------------------------------------------------------------
# LockSan
# ---------------------------------------------------------------------------

def _locksan_run(P, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    ls = P.locksan
    ls.reset()
    ls.arm()
    try:
        a, b = ls.Lock("router.state"), ls.RLock("journal.append")

        def ab():
            with a:
                with b:
                    with b:         # re-entrant: no self edge
                        pass

        def ba():
            with b:
                with a:
                    pass

        for name, fn in (("t-ab", ab), ("t-ba", ba)):
            th = threading.Thread(target=fn, name=name)
            th.start()
            th.join()
        th = threading.Thread(target=lambda: a.acquire() and (
            time.sleep(0), a.release()), name="t-sleep")
        th.start()
        th.join()
        with ls.allow_blocking("by design"):
            with a:
                time.sleep(0)
        rep = ls.report()
    finally:
        ls.disarm()
        ls.reset()
    for v in rep["violations"]:
        for k in ("edges", "lock_stack", "call_stack", "summary"):
            v.pop(k, None)
    return rep


def test_locksan_inversion_report_is_the_reference_s(tmp_path, monkeypatch):
    rep = both(lambda P: _locksan_run(P, tmp_path / str(P is T),
                                      monkeypatch))
    types = [v["type"] for v in rep["violations"]]
    assert types == ["lock_order_inversion", "blocking_call_under_lock"]
    assert rep["violations"][0]["cycle"] == \
        "journal.append -> router.state -> journal.append"
    assert not t_locksan.armed()
    assert isinstance(t_locksan.Lock("x"), type(threading.Lock()))


def test_locksan_flag_arms_the_port():
    import subprocess
    import sys

    code = ("import paddle_tpu_torch.analysis.locksan as ls\n"
            "import paddle_tpu_torch.telemetry\n"
            "print(ls.armed(), type(ls.Lock('x')).__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**__import__("os").environ,
                                         "FLAGS_locksan": "1"}, timeout=120)
    assert out.stdout.split() == ["True", "_SanLock"], out.stderr


# ---------------------------------------------------------------------------
# SLO tracker
# ---------------------------------------------------------------------------

def _slo(P, label):
    clk = FakeClock()
    s = P.tel.SLOTracker(ttft_slo_s=0.5, tpot_slo_s=0.05, window_s=10.0,
                         min_samples=3, engine_label=label, clock=clk)
    for i in range(6):
        s.record_finished(ttft=0.1 * (i + 1), tpot=0.01 * (i + 1),
                          queue_time=0.01 * i, tokens=8,
                          trace_id=f"r{i}")
        clk.tick(1.0)
    s.record_failed(tokens=3, trace_id="dead")
    first = s.summary()
    clk.tick(8.0)
    return first, s.summary()


def test_slo_tracker_is_the_reference_s():
    first, later = both(lambda P: _slo(P, "slo-parity"))
    assert first["ttft"]["p99"] == pytest.approx(0.6)
    assert later["window_requests"] < first["window_requests"]


# ---------------------------------------------------------------------------
# request traces, history, alerts, sampling profiler, cluster
# ---------------------------------------------------------------------------

def test_request_trace_merge_is_the_reference_s():
    def run(P):
        tr = P.tel.Tracer()
        root = tr.emit("request", 10.0, 12.0, attrs={"trace_id": "g1"})
        tr.emit("prefill", 10.5, 11.0, attrs={"trace_id": "g1"},
                parent_id=root.span_id)
        tr.emit("engine.decode", 11.0, 11.2, attrs={"trace_ids": ["g1"]})
        tr.emit("other", 11.0, 11.2, attrs={"trace_id": "g2"})
        wire = [P.reqtrace.span_to_wire(s) for s in tr.spans()]
        got = P.reqtrace.wire_trace_ids(wire[2]), \
            [w["name"] for w in wire
             if "g1" in P.reqtrace.wire_trace_ids(w)]
        doc = P.reqtrace.merge_request_trace("g1", {"replica-0": wire})
        evs = sorted((e["name"], e["ph"]) for e in doc["traceEvents"])
        return got, evs
    got, evs = both(run)
    assert got[1] == ["request", "prefill", "engine.decode"]


def _history_run(P):
    clk = FakeClock()
    st = P.history.TimeSeriesStore(P.tel.MetricsRegistry(), interval_s=1.0,
                                   clock=clk, wall_clock=lambda: clk.t + 5e8)
    total = 0.0
    for i in range(75):
        total = 0.0 if i == 40 else total + i % 5
        doc = {"reqs_total": {"type": "counter", "help": "", "labels": [],
                              "series": [{"labels": {}, "value": total}]},
               "depth": {"type": "gauge", "help": "", "labels": ["q"],
                         "series": [{"labels": {"q": "a"}, "value": i}]},
               "lat_seconds": {"type": "histogram", "help": "",
                               "labels": [], "series": [{
                                   "labels": {},
                                   "buckets": {"0.01": i, "0.1": 2 * i,
                                               "+Inf": 3 * i},
                                   "sum": 0.05 * i, "count": 3 * i}]}}
        st._ingest(doc, clk.t, clk.t + 5e8)
        clk.tick(1.0)
    return ([st.query(f, res=r) for f in ("reqs_total", "depth",
                                           "lat_seconds")
             for r in ("raw", "10s", "1m")], st.to_doc()["series"],
            st.last_window(30.0))


def test_history_rings_are_the_reference_s():
    queries, series, window = both(_history_run)
    assert queries[0] and window


def _alerts_run(P):
    clk = FakeClock()
    st = P.history.TimeSeriesStore(P.tel.MetricsRegistry(), interval_s=1.0,
                                   clock=clk, wall_clock=lambda: clk.t + 5e8)
    rules = [P.alerts.ThresholdRule("deep", "depth", ">", 2.0,
                                    severity="page", for_s=3.0,
                                    resolve_s=2.0),
             P.alerts.rule_from_dict({"type": "absence", "name": "gone",
                                      "family": "beat_total",
                                      "mode": "zero", "absent_for_s": 3.0,
                                      "for_s": 0.0}),
             P.alerts.BurnRateRule("burn", "slo_goodput_ratio",
                                   objective=0.99, time_scale=1 / 600.0)]
    sent = []
    eng = P.alerts.AlertEngine(st, rules, interval_s=999.0, clock=clk,
                               wall_clock=lambda: clk.t + 5e8,
                               notifier=lambda n: sent.append(
                                   (n["event"], n["alert"]["rule"])))
    log = []
    beats = 0.0
    for i in range(40):
        beats += 1.0 if i < 20 else 0.0
        st._ingest({
            "depth": {"type": "gauge", "help": "", "labels": [],
                      "series": [{"labels": {}, "value":
                                  9.0 if 5 <= i < 15 else 0.0}]},
            "beat_total": {"type": "counter", "help": "", "labels": [],
                           "series": [{"labels": {}, "value": beats}]},
            "slo_goodput_ratio": {"type": "gauge", "help": "", "labels": [],
                                  "series": [{"labels": {}, "value":
                                              0.5 if i >= 25 else 1.0}]}},
            clk.t, clk.t + 5e8)
        log.append([(e["alert"]["rule"], e["event"])
                    for e in eng.evaluate_once()])
        clk.tick(1.0)
    return log, sent, [type(d).__name__ for d in P.alerts.default_rules()]


def test_alert_lifecycle_is_the_reference_s():
    log, sent, pack = both(_alerts_run)
    flat = [e for step in log for e in step]
    assert ("deep", "firing") in flat and ("deep", "resolved") in flat
    assert ("gone", "firing") in flat and sent


def test_folded_profiles_are_the_reference_s():
    def run(P):
        folded = ("main;a.py:f;b.py:g 5\nmain;a.py:f 3\nworker;c.py:h 2\n"
                  "bad line\n")
        d = P.pyprof.parse_folded(folded)
        merged = P.pyprof.merge_folded(d, {"main;a.py:f": 4})
        doc = P.pyprof.folded_to_speedscope(merged, name="x", hz=50)
        doc.pop("exporter")
        return d, merged, doc
    both(run)


def test_sampling_profiler_sees_a_named_thread():
    stop = threading.Event()

    def beacon_loop():
        while not stop.is_set():
            stop.wait(0.001)

    th = threading.Thread(target=beacon_loop, name="beacon-thread",
                          daemon=True)
    th.start()
    prof = t_pyprof.SamplingProfiler(hz=200)
    try:
        for _ in range(20):
            prof.sample_once()
    finally:
        stop.set()
        th.join()
    assert any(k.startswith("beacon-thread;") and "beacon_loop" in k
               for k in prof.folded_dict())
    assert prof.speedscope()["exporter"].startswith(
        "paddle_tpu_torch.telemetry.pyprof")


class _DictStore:
    """In-memory duck-typed store (set/get/add/wait/check/delete_key)."""

    def __init__(self):
        self.d = {}
        self.lock = threading.Lock()

    def set(self, k, v):
        with self.lock:
            self.d[k] = v if isinstance(v, bytes) else str(v).encode()

    def get(self, k):
        with self.lock:
            if k not in self.d:
                raise KeyError(k)
            return self.d[k]

    def check(self, keys):
        with self.lock:
            return all(k in self.d for k in keys)

    def add(self, k, n):
        with self.lock:
            v = int(self.d.get(k, b"0")) + n
            self.d[k] = str(v).encode()
            return v

    def wait(self, keys, timeout=None):
        if not self.check(keys):
            raise TimeoutError(keys)

    def delete_key(self, k):
        with self.lock:
            return self.d.pop(k, None) is not None


def _cluster_run(P):
    store = _DictStore()
    for rank, beats in ((0, [(1, 10.0), (2, 11.0)]),
                        (1, [(1, 10.4), (2, 11.5)])):
        for seq, t in beats:
            store.set(f"telemetry/{rank}/coll", json.dumps(
                {"seq": seq, "op": "all_reduce", "state": "exited",
                 "t_enter": t, "t_exit": t + 0.1, "nranks": 2}))
            store.set(f"telemetry/{rank}/meta", json.dumps(
                {"rank": rank, "pid": rank, "host": "h", "wall": t,
                 "publish_seq": seq, "clock_offset_s": 0.0,
                 "trace_epoch_unix": 0.0}))
    traces = [{"traceEvents": [{"ph": "X", "name": f"step{r}", "pid": r,
                                "tid": 1, "ts": 100.0 * r, "dur": 5.0}],
               "otherData": {"epoch_unix": 1000.0 + r}} for r in (0, 1)]
    merged = P.cluster.merge_traces(dict(enumerate(traces)),
                                    offsets_s={1: 0.25})
    rows = sorted((e["name"], e["pid"], round(e["ts"], 3))
                  for e in merged["traceEvents"] if e["ph"] == "X")
    return rows, sorted(store.d)


def test_cluster_trace_merge_is_the_reference_s():
    rows, keys = both(_cluster_run)
    assert [r[0] for r in rows] == ["step0", "step1"]


def test_cluster_publish_and_aggregate_in_process():
    def run(P):
        store = _DictStore()
        P.tel.registry().counter("cluster_parity_total").inc(2)
        pubs = [P.cluster.RankPublisher(store, r, 2, interval_s=999.0,
                                        sync_clock=False) for r in (0, 1)]
        for p in pubs:
            p.publish_once()
        merged = P.cluster.ClusterAggregator(store, 2).merged_snapshot()
        return merged["cluster_parity_total"]
    fam = both(run)
    assert [s["labels"]["rank"] for s in fam["series"]] == ["0", "1"]


def test_start_from_env_needs_an_explicit_store(monkeypatch):
    # no store passed: the endpoint in $PADDLE_TELEMETRY_STORE is dialled
    # as a TCPStore, as the reference does (a live store:
    # tests/test_torch_tcp_store.py); an unreachable one raises there
    from paddle_tpu_torch.distributed import tcp_store

    dialled = []

    class Unreachable:
        def __init__(self, host, port):
            dialled.append((host, port))
            raise tcp_store.StoreTimeout(f"could not reach {host}:{port}")

    monkeypatch.setattr(tcp_store, "TCPStore", Unreachable)
    monkeypatch.setenv("PADDLE_TELEMETRY_STORE", "127.0.0.1:1")
    with pytest.raises(tcp_store.StoreTimeout, match="127.0.0.1:1"):
        t_cluster.start_from_env()
    assert dialled == [("127.0.0.1", 1)]
    monkeypatch.delenv("PADDLE_TELEMETRY_STORE")
    assert t_cluster.start_from_env() is None
