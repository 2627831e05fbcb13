"""The port's performance observability (``paddle_tpu_torch.telemetry.perf``)
against the JAX package's: the CompileWatcher's counts, storms and
``explain_recompile()`` diffs, the MemoryMonitor's accounting and leak
sentinel, the StepTimeline's percentiles and regression culprit, all
driven by the same calls through both packages; then the port's own
compile points (``jit.to_static`` signatures, ``static.Executor``
compiles, a registered kernel op's trace, the ``nvcc`` builds) and
``run_meta``.
"""
import os
import stat
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu.telemetry as j_tel
from paddle_tpu.telemetry import perf as j_perf

import paddle_tpu_torch as paddle
import paddle_tpu_torch.telemetry as t_tel
from paddle_tpu_torch import static
from paddle_tpu_torch.telemetry import perf as t_perf

J = SimpleNamespace(tel=j_tel, perf=j_perf)
T = SimpleNamespace(tel=t_tel, perf=t_perf)


def both(fn):
    ref, port = fn(J), fn(T)
    assert port == ref
    return port


def _sig(shape, dtype="int32"):
    return (("tokens", tuple(shape), dtype),)


def _no_times(d):
    return {k: v for k, v in d.items() if k != "t"}


# ---------------------------------------------------------------------------
# CompileWatcher
# ---------------------------------------------------------------------------

def test_compile_counts_and_storm_latch_are_the_reference_s():
    def run(P):
        P.tel.flight().clear()
        w = P.perf.CompileWatcher(storm_threshold=3, storm_window_s=60.0)
        new = [w.record_call("decode", _sig((n,)), wall_s=0.01 * n)
               for n in (4, 4, 8, 16, 32, 64)]
        storms = [_no_times(s) for s in w.storms()]
        evs = [(e["kind"], e.get("callable"), e.get("distinct"))
               for e in P.tel.flight().events()]
        summary = w.summary()
        summary["storms"] = [_no_times(s) for s in summary["storms"]]
        return new, w.compiles("decode"), w.compiles(), storms, evs, summary
    new, n, total, storms, evs, summary = both(run)
    assert new == [True, False, True, True, True, True] and n == 5
    assert [e[0] for e in evs].count("compile.storm") == 1


@pytest.mark.parametrize("sigs", [
    [(("tokens", (8,), "int32"), ("table", (2,), "int32")),
     (("tokens", (16,), "int32"), ("table", (2,), "int32"))],
    [(("x", (4,), "float32"),), (("x", (4,), "bfloat16"),)],
    [(("a", (1,), "int32"),), (("a", (1,), "int32"), ("b", (2,), "int32"))],
    [(("a", (1,), "int32"), ("b", (2,), "int32")), (("b", (3,), "int64"),)],
])
def test_explain_recompile_diffs_are_the_reference_s(sigs):
    def run(P):
        w = P.perf.CompileWatcher(storm_threshold=2)
        for s in sigs:
            w.record_call("prefill", s)
        return w.explain("prefill"), w.explain()
    ex, default = both(run)
    assert ex["changed_args"] and ex == default


def test_abstract_signature_spells_dtypes_as_the_reference():
    t = paddle.to_tensor(np.zeros((2, 3), np.float32), place="cpu")
    sig = t_perf.abstract_signature([t, torch.zeros(4, dtype=torch.bfloat16),
                                     7], argnames=("a", "b", "c"))
    assert sig == (("a", (2, 3), "float32"), ("b", (4,), "bfloat16"),
                   ("c", (), "py:int"))
    j = j_perf.abstract_signature([np.zeros((2, 3), np.float32), 7],
                                  argnames=("a", "c"))
    assert j == (sig[0], sig[2])


def test_wrap_times_only_new_signatures():
    w = t_perf.CompileWatcher(storm_threshold=99)
    f = w.wrap(lambda x: x * 2, "double", argnames=("x",))
    for n in (3, 3, 5):
        f(torch.ones(n))
    assert w.compiles("double") == 2
    fam = t_tel.registry().get("xla_compile_seconds")
    assert fam.labels(callable="double").count == 2


# ---------------------------------------------------------------------------
# MemoryMonitor and StepTimeline
# ---------------------------------------------------------------------------

def _memory(P):
    P.tel.flight().clear()
    mm = P.perf.MemoryMonitor(leak_window=4, timeline_cap=5)
    mm.add("params", 100)
    mm.add("kv_pool", 50)
    mm.set("activations_estimate", 30)
    mm.sub("kv_pool", 80)                  # floors at zero
    mm.expect_bounded("spill", cap_bytes=25)
    for i in range(6):                     # a leak, then a bounded pool
        mm.set("kv_blocks", 10 * (i + 1))
        mm.set("spill", 6 * i)
        mm.note_step()
    snap = mm.snapshot()
    snap.pop("device")
    return (snap, mm.peak_attribution(), mm.leak_report(),
            [_no_times(e) for e in mm.timeline()],
            [e["tag"] for e in P.tel.flight().events("memory.leak")])


def test_memory_monitor_is_the_reference_s():
    snap, peak, leaks, timeline, flagged = both(_memory)
    assert sorted(leaks) == ["kv_blocks", "spill"] and len(timeline) == 5


def test_device_stats_follow_the_watched_device():
    mm = t_perf.MemoryMonitor()
    assert mm.device_stats() is None
    mm.watch_device("cpu")
    assert mm.device_stats() is None and mm.snapshot()["device"] is None


def _timeline(P):
    P.tel.flight().clear()
    tl = P.perf.StepTimeline("parity", window=16, regress_factor=1.5,
                             min_baseline=4)
    for i in range(8):
        tl.record_step(0.010 + 0.0001 * i, {"data": 0.002, "compute": 0.007})
    tl.record_step(0.030, {"data": 0.002, "compute": 0.026})
    return tl.report(), [(e["culprit"], e["timeline"]) for e in
                         P.tel.flight().events("step.regression")]


def test_step_timeline_is_the_reference_s():
    rep, regressions = both(_timeline)
    assert rep["last_regression"]["culprit"] == "compute"
    assert regressions == [("compute", "parity")]


def test_step_and_phase_contexts():
    tl = t_perf.StepTimeline("ctx-port")
    with tl.step():
        with tl.phase("data"):
            pass
        t_perf.note_phase("collective", 0.25)
    rep = tl.report()
    assert rep["steps"] == 1
    assert rep["phases"]["collective"]["mean"] == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# the port's compile points
# ---------------------------------------------------------------------------

def test_to_static_signatures_are_watched():
    from paddle_tpu_torch import jit

    w = t_tel.compile_watcher()

    def perf_twice(x):
        return x * 2

    f = jit.to_static(perf_twice, backend="eager")
    for n in (3, 3, 5):
        f(torch.ones(n))
    assert w.signatures("jit.perf_twice") == [
        (("arg0", (3,), "float32"),), (("arg0", (5,), "float32"),)]
    ex = t_tel.explain_recompile("jit.perf_twice")
    assert ex["changed_args"] == [{"arg": "arg0", "field": "shape",
                                   "before": (3,), "after": (5,)}]


def test_executor_cache_counters_and_watcher(monkeypatch):
    from paddle_tpu_torch import jit

    from paddle_tpu_torch.core import device

    monkeypatch.setattr(jit, "DEFAULT_BACKEND", "aot_eager")
    monkeypatch.setitem(device._state, "device", None)
    paddle.set_device("cpu")
    reg = t_tel.registry()
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("perf_port_x", [None, 3], "float32")
        y = x * 2.0
    exe = static.Executor()
    hits = reg.counter("static_executor_cache_hits_total").value
    miss = reg.counter("static_executor_cache_misses_total").value
    for n in (2, 2, 4):
        exe.run(prog, feed={"perf_port_x": np.ones((n, 3), np.float32)},
                fetch_list=[y])
    assert reg.counter("static_executor_cache_hits_total").value == hits + 1
    assert reg.counter("static_executor_cache_misses_total").value \
        == miss + 2
    sigs = t_tel.compile_watcher().signatures("static.Executor")
    assert (("perf_port_x", (2, 3), "float32"),) in sigs
    assert (("perf_port_x", (4, 3), "float32"),) in sigs


def test_a_kernel_op_trace_is_watched_at_its_fake():
    from torch._subclasses.fake_tensor import FakeTensorMode

    w = t_tel.compile_watcher()
    with FakeTensorMode():
        x = torch.empty(6, 40)
        out, h, rstd = torch.ops.paddle_tpu_torch.rmsnorm_fwd(
            x, torch.empty(40), None, 1e-6)
        q = torch.empty(1, 8, 2, 16)
        torch.ops.paddle_tpu_torch.flash_attention_fwd(
            q, q, q, None, True, None, 0.1, torch.empty(1, dtype=torch.int64))
    assert tuple(out.shape) == (6, 40)
    # each tensor slot of the schema by its name, an absent one as None
    assert (("x", (6, 40), "float32"), ("weight", (40,), "float32"),
            ("residual", (), "py:NoneType")) in \
        w.signatures("kernel.rmsnorm_fwd")
    qs = ((1, 8, 2, 16), "float32")
    assert (("q", *qs), ("k", *qs), ("v", *qs),
            ("mask", (), "py:NoneType"), ("seed", (1,), "int64")) in \
        w.signatures("kernel.flash_attention_fwd")


def test_nvcc_builds_are_recorded_with_their_wall(tmp_path, monkeypatch):
    from paddle_tpu_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    libs = _build.build_all()
    w = t_tel.compile_watcher()
    for name, lib in libs.items():
        assert (("library", (), lib.name),) in w.signatures(f"nvcc.{name}")
        assert os.path.exists(lib)
    hist = t_tel.registry().get("xla_compile_seconds")
    assert hist.labels(callable="nvcc.paged_attention").count >= 1


def test_run_meta_names_torch_and_the_device():
    meta = t_perf.run_meta()
    assert meta["torch_version"] == torch.__version__
    assert meta["cuda_version"] == torch.version.cuda
    assert meta["platform"] == ("cuda" if torch.cuda.is_available()
                                else "cpu")
    assert "jax_version" not in meta
