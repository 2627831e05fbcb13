"""``paddle_tpu_torch.profiler`` (over ``torch.profiler``) and the roofline
cost model (``telemetry.cost``).

Profiler: the Benchmark math and the scheduler windows against the JAX
package's on the same calls (a fake clock, nothing sleeps), a CPU trace
whose export holds the telemetry spans as host annotations, ``summary()``
tables, ``export`` and the skipped-file accounting.

Cost model: the dispatch count against ``torch.utils.flop_counter``; every
kernel wrapper's launch route (simulated here: its launch replaced by one
the counter cannot see, as a ctypes launch) counted as its CPU route,
its plain version's own count; the registered-op route; bytes; the trace
registry and the peaks (an NVIDIA H100 SXM's public numbers, no TPU
numbers).
"""
import json
import os

import pytest
import torch

from paddle_tpu import profiler as j_prof

from paddle_tpu_torch import profiler as t_prof
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.kernels import (ctc, flash_attention, layernorm,
                                      paged_attention, rmsnorm, rnnt,
                                      softmax_ce, work_counter)
from paddle_tpu_torch.kernels.library import OPS
from paddle_tpu_torch.telemetry import cost


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _bench(P, monkeypatch):
    clk = FakeClock()
    monkeypatch.setattr(P.time, "perf_counter", clk)
    b = P.Benchmark()
    b.begin()
    for i in range(3):
        b.before_reader()
        clk.t += 0.01
        b.after_reader()
        clk.t += 0.02 * (i + 1)
        b.step(num_samples=100)
    info = b.step_info("samples")
    rep = b.report()
    b.reset()
    b.step(num_samples=1)
    return rep, info, b.batch.count


def test_benchmark_math_is_the_reference_s(monkeypatch):
    got = _bench(t_prof, monkeypatch)
    assert got == _bench(j_prof, monkeypatch)
    assert got[0]["ips"] == pytest.approx(300 / 0.15)
    assert got[2] == 0


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2, repeat=1, skip_first=1),
    dict(closed=0, ready=0, record=3),
    dict(closed=2, ready=1, record=1, repeat=3),
])
def test_scheduler_windows_are_the_reference_s(kw):
    t = t_prof.make_scheduler(**kw)
    j = j_prof.make_scheduler(**kw)
    assert [t(i).name for i in range(16)] == [j(i).name for i in range(16)]


def test_cpu_trace_holds_the_engine_spans(tmp_path, capsys):
    d = str(tmp_path / "trace")
    p = t_prof.Profiler(targets=[t_prof.ProfilerTarget.CPU],
                        scheduler=(1, 3),
                        on_trace_ready=t_prof.export_chrome_tracing(d, "w0"))
    x = torch.ones(16, 16)
    p.start()
    for i in range(4):
        with telemetry.span("engine.decode", batch=i):
            with t_prof.RecordEvent("matmul_step"):
                (x @ x).sum()
        p.step(num_samples=4)
    p.stop()
    assert not telemetry.device_trace_active()
    assert p.export() == d and os.listdir(d) == [
        os.path.basename(p.last_trace_path)]
    evs = json.load(open(p.last_trace_path))["traceEvents"]
    names = [e["name"] for e in evs if e.get("cat") == "user_annotation"]
    assert names.count("engine.decode") == 2         # steps 1 and 2
    assert "matmul_step" in names
    rep = p.summary(max_rows=5)
    assert any(r["name"] == "engine.decode" for r in rep["host_summary"])
    assert rep["trace_files_seen"] == 1 and rep["ips"] > 0
    assert "Host summary" in capsys.readouterr().out
    dest = str(tmp_path / "copy.json")
    assert p.export(path=dest) == dest and os.path.exists(dest)
    with pytest.raises(ValueError):
        p.export(format="pb")


def test_export_without_a_window_raises():
    p = t_prof.Profiler(timer_only=True)
    p.start()
    p.stop()
    with pytest.raises(RuntimeError):
        p.export(path="nowhere")
    assert p.export() is None


def test_parse_reports_skipped_files(tmp_path):
    good = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "paged_attention_fwd",
         "dur": 20.0},
        {"ph": "X", "cat": "user_annotation", "name": "engine.decode",
         "dur": 50.0},
        {"ph": "X", "cat": "python_function", "name": "x.py(1): f",
         "dur": 50.0}]}
    (tmp_path / "a.trace.json").write_text(json.dumps(good))
    (tmp_path / "b.trace.json").write_text("{not json")
    dev, host = t_prof.parse_trace_op_times(str(tmp_path))
    assert [r["name"] for r in dev] == ["paged_attention_fwd"]
    assert [r["name"] for r in host] == ["engine.decode"]
    assert dev.meta["files_seen"] == 2 and dev.meta["files_skipped"] == 1
    table = t_prof.format_op_table(dev, host)
    assert "Device (CUDA) op summary" in table and "engine.decode" in table


def test_record_event_decorator_and_mfu():
    @t_prof.RecordEvent("fn")
    def f(a):
        return a + 1

    assert f(1) == 2
    assert t_prof.transformer_flops_per_token(100, 2, 4, 8) == \
        j_prof.transformer_flops_per_token(100, 2, 4, 8)
    assert t_prof.peak_flops("h100") == 989e12
    assert t_prof.mfu(1e9, 989e3, "h100") == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# roofline cost model
# ---------------------------------------------------------------------------

def _mixed(x, w):
    y = torch.nn.functional.linear(x, w)
    z = torch.einsum("bqd,bkd->bqk", y, y)
    return torch.softmax(z, -1).sum() + torch.bmm(z, y).mean()


@pytest.mark.parametrize("inference", [False, True])
def test_products_are_flop_counter_s(inference):
    from torch.utils.flop_counter import FlopCounterMode

    x, w = torch.randn(2, 8, 16), torch.randn(12, 16)
    ctx = torch.inference_mode if inference else torch.no_grad
    with ctx(), FlopCounterMode(display=False) as ref:
        _mixed(x, w)
    with ctx():
        est = cost.estimate_fn_cost(_mixed, x, w)
    assert est["matmul_flops"] == ref.get_total_flops() > 0
    assert est["elementwise_flops"] > 0
    assert est["bytes"] == x.nbytes + w.nbytes + 4
    assert est["input_bytes"] == x.nbytes + w.nbytes


def _paged_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 8, 16, generator=g)
    pool = torch.randn(12, 2, 2, 4, 16, generator=g)
    bt = torch.randint(1, 12, (3, 5), generator=g, dtype=torch.int32)
    ctx = torch.tensor([3, 9, 17], dtype=torch.int32)
    return q, pool, bt, ctx


def _rnd(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _grad_of(fn, *xs):
    """fn's forward and its backward (each output's sum) on leaves xs."""
    def run():
        leaves = [x.detach().requires_grad_() for x in xs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        sum(o.float().sum() for o in outs if o.requires_grad).backward()
    return run


def _ctc_case():
    T, B, C, L = 10, 2, 5, 3
    lp = _rnd(T, B, C).log_softmax(-1)
    labels = torch.tensor([[1, 2, 2], [3, 4, 0]])
    lens = torch.tensor([10, 8]), torch.tensor([3, 2])
    return _grad_of(lambda x: ctc.ctc_lattice(x, labels, *lens), lp)


def _rnnt_case():
    b, e = (torch.nn.functional.logsigmoid(_rnd(2, 6, 4, seed=s))
            for s in (1, 2))
    lens = torch.tensor([6, 5]), torch.tensor([3, 2])
    return _grad_of(lambda x, y: rnnt.rnnt_lattice(x, y, *lens), b, e)


def _varlen_case():
    cu = torch.tensor([0, 5, 12, 20], dtype=torch.int32)
    q, k = _rnd(20, 4, 16), _rnd(20, 2, 16, seed=1)
    return _grad_of(lambda a, b, c: flash_attention.flash_attn_varlen(
        a, b, c, cu, cu, causal=True), q, k, k)


# every eager kernel wrapper: (module, its launches, a forward + backward)
_WRAPPERS = {
    "paged_attention": (paged_attention, ["paged_attention_cuda"],
                        lambda: paged_attention.paged_attention(
                            *_paged_inputs())),
    "rmsnorm": (rmsnorm, ["rmsnorm_cuda", "rmsnorm_bwd_cuda"],
                _grad_of(lambda x, w: rmsnorm.rmsnorm(x, w),
                         _rnd(6, 32), _rnd(32, seed=1))),
    "rmsnorm_residual": (
        rmsnorm, ["rmsnorm_cuda", "rmsnorm_bwd_cuda"],
        _grad_of(lambda x, r, w: rmsnorm.rmsnorm_residual(x, r, w),
                 _rnd(6, 32), _rnd(6, 32, seed=2), _rnd(32, seed=1))),
    "layernorm": (layernorm, ["layer_norm_cuda"],
                  _grad_of(layernorm.layernorm, _rnd(6, 32),
                           _rnd(32, seed=1), _rnd(32, seed=2))),
    "softmax_ce": (softmax_ce, ["softmax_ce_cuda", "softmax_ce_bwd_cuda"],
                   _grad_of(lambda x: softmax_ce.softmax_ce(
                       x, torch.tensor([1, 5, 0, 31, 7, 2])), _rnd(6, 32))),
    "flash_attention": (
        flash_attention, ["flash_attention_cuda", "flash_attention_bwd_cuda"],
        _grad_of(lambda q, k, v: flash_attention.flash_attention_fwd(
            q, k, v, causal=True), _rnd(2, 8, 4, 16),
            _rnd(2, 8, 2, 16, seed=1), _rnd(2, 8, 2, 16, seed=2))),
    "flash_attn_varlen": (
        flash_attention,
        ["flash_attn_varlen_cuda", "flash_attn_varlen_bwd_cuda"],
        _varlen_case()),
    "ctc": (ctc, ["ctc_alpha_cuda", "ctc_beta_cuda"], _ctc_case()),
    "rnnt": (rnnt, ["rnnt_alpha_cuda", "rnnt_beta_grad_cuda"], _rnnt_case()),
}


def _count(run):
    with cost.CostCounter() as c:
        run()
    return c.matmul_flops, c.elementwise_flops, c.kernels


@pytest.mark.parametrize("case", sorted(_WRAPPERS))
def test_a_launch_counts_as_its_plain_version(case, monkeypatch):
    """The trap of an eager launch (ctypes: no aten op reaches the
    counter): with each launch of the wrapper replaced by one the counter
    cannot see, its count equals the CPU route's, its plain version's own
    dispatch, and the kernels are noted alike."""
    from torch.utils._python_dispatch import _disable_current_modes

    mod, launches, run = _WRAPPERS[case]
    cpu = _count(run)
    assert cpu[0] + cpu[1] > 0 and cpu[2]
    assert set(cpu[2]) <= set(OPS)

    launched = []

    def unseen(name, plain):
        def launch(*args, **kwargs):
            launched.append(name)
            with _disable_current_modes():
                return plain(*args, **kwargs)
        return launch

    monkeypatch.setattr(mod, "use_kernel", lambda *t: True)
    for name in launches:
        plain = getattr(mod, name.replace("_cuda", "_plain"))
        monkeypatch.setattr(mod, name, unseen(name, plain))
    assert _count(run) == cpu
    assert sorted(set(launched)) == sorted(launches)


def test_registered_op_counts_as_its_plain_version():
    q, pool, bt, ctx = _paged_inputs()
    with cost.CostCounter() as plain:
        paged_attention.paged_attention_plain(q, pool, bt, ctx)
    with cost.CostCounter() as c:
        out = torch.ops.paddle_tpu_torch.paged_attention(q, pool, bt, ctx,
                                                         None)
        rmsnorm.rmsnorm(torch.randn(4, 16), torch.ones(16))
    with cost.CostCounter() as norm:
        rmsnorm.rmsnorm_plain(torch.randn(4, 16), torch.ones(16), 1e-6)
    assert c.matmul_flops == plain.matmul_flops > 0
    assert c.elementwise_flops == (plain.elementwise_flops
                                   + norm.elementwise_flops)
    assert c.kernels == {"paged_attention": 1, "rmsnorm_fwd": 1}
    torch.testing.assert_close(
        out, paged_attention.paged_attention_plain(q, pool, bt, ctx))
    assert work_counter() is None


def test_trace_registry_and_fingerprints():
    est = cost.estimate_fn_cost(lambda a: a * 2, torch.ones(8))
    cost.register_trace("engine.test", "b1", est, fingerprint=("m", 1))
    assert cost.lookup("engine.test", "b1", ("m", 1))["flops"] == 8
    assert cost.lookup("engine.test", "b1", ("m", 2)) is None
    text = telemetry.prometheus_text()
    assert 'trace_flops{callable="engine.test",bucket="b1"} 8' in text


def test_peaks(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PEAK_BW", raising=False)
    h = cost.platform_peaks("h100")
    assert (h["flops_per_s"], h["bytes_per_s"]) == (989e12, 3.35e12)
    assert cost.platform_peaks(device="cpu")["platform"] == "cpu"
    unknown = cost.platform_peaks("NVIDIA A10")
    assert unknown["flops_per_s"] is None
    assert cost.achieved_fraction({"flops": 1, "bytes": 1}, 1.0,
                                  unknown) is None
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "2e12")
    monkeypatch.setenv("PADDLE_TPU_PEAK_BW", "1e9")
    p = cost.platform_peaks("NVIDIA A10")
    assert cost.roofline_time_s({"flops": 4e12, "bytes": 1e9}, p) == 2.0
    assert cost.achieved_fraction({"flops": 4e12, "bytes": 0}, 4.0,
                                  p) == 0.5
