"""paddle.profiler over ``torch.profiler`` (counterpart of
``paddle_tpu/profiler/__init__.py``).

Reference surface: the unified host+device Profiler (scheduler windows,
start/stop/step, export_chrome_tracing, summary tables) and the throughput
Benchmark instrument (reader_cost / batch_cost / ips).

Device tracing is ``torch.profiler`` (CUPTI for the CUDA kernels, the
host's ops and annotations beside them); ``ProfilerTarget.CPU`` / ``GPU``
pick its activities. While a recording window is open,
``telemetry.set_device_trace_active(True)`` makes every telemetry span
enter ``torch.profiler.record_function``, so the serving engine's spans
(``engine.decode``, ``engine.prefill``) sit in the trace as host
annotations over the kernels they launched. Each window is written as a
Chrome trace (``trace.json``) into the export directory when it closes.
:class:`RecordEvent` is ``record_function``. The Benchmark math
(TimeAverager, ips) is host-side, as in the reference, with its MFU helper
over the card's public peak.
"""
from __future__ import annotations

import os
import time
from enum import Enum

import torch

from .. import telemetry

__all__ = [
    "Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
    "make_scheduler", "export_chrome_tracing", "Benchmark", "benchmark",
    "TimeAverager", "transformer_flops_per_token", "peak_flops", "mfu",
    "parse_trace_op_times", "format_op_table",
]


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0):
    """Window scheduler: per-step state out of
    [skip_first][closed][ready][record...] cycles."""
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat > 0 and step // period >= repeat:
            return ProfilerState.CLOSED
        pos = step % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: str | None = None):
    """on_trace_ready factory: each closed recording window is written to
    ``dir_name`` as ``<worker>.<pid>.<n>.trace.json`` (Chrome trace-event
    JSON; ``chrome://tracing`` / Perfetto load it)."""

    def handle_fn(prof):
        prof._last_export_dir = dir_name

    handle_fn._dir_name = dir_name
    handle_fn._worker_name = worker_name
    return handle_fn


class RecordEvent:
    """Host-side named span (``torch.profiler.record_function``): it nests
    over the CUDA kernels it launches in the exported trace; also usable
    as a decorator."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._ann = None
        self.begin_ns = None
        self.end_ns = None

    def begin(self):
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        self.begin_ns = time.perf_counter_ns()

    def end(self):
        if self._ann is not None:
            self.end_ns = time.perf_counter_ns()
            self._ann.__exit__(None, None, None)
            self._ann = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with RecordEvent(self.name):
                return fn(*a, **k)

        return wrapped


def _activities(targets):
    from torch.profiler import ProfilerActivity

    if targets is None:
        targets = [ProfilerTarget.CPU]
        if torch.cuda.is_available():
            targets.append(ProfilerTarget.GPU)
    acts = []
    for t in targets:
        if t is ProfilerTarget.CPU:
            acts.append(ProfilerActivity.CPU)
        elif t is ProfilerTarget.GPU:
            acts.append(ProfilerActivity.CUDA)
        else:
            raise ValueError(f"unsupported profiler target {t!r}: the port "
                             f"traces the CPU and CUDA devices")
    return acts


class Profiler:
    """Scheduler-windowed tracing.

    ``start``/``stop`` bracket a ``torch.profiler`` session; ``step``
    advances the scheduler and forwards throughput accounting to the
    Benchmark. On RECORD→CLOSED transitions the session is stopped, its
    Chrome trace written, and on_trace_ready fires.
    """

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only: bool = False, record_shapes: bool = False,
                 profile_memory: bool = False, with_flops: bool = False):
        if callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            lo, hi = scheduler
            self._scheduler = make_scheduler(
                closed=max(lo, 0), ready=0, record=hi - lo, repeat=1)
        else:
            self._scheduler = _default_scheduler
        self._activities = _activities(targets)
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._opts = dict(record_shapes=record_shapes,
                          profile_memory=profile_memory,
                          with_flops=with_flops)
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._tracing = False
        self._prof = None
        self._windows = 0
        self._last_export_dir = None
        self.last_trace_path = None
        self._benchmark = Benchmark()

    # -- lifecycle -------------------------------------------------------
    def _trace_dir(self):
        if self._on_trace_ready is not None and \
                getattr(self._on_trace_ready, "_dir_name", None):
            return self._on_trace_ready._dir_name
        import tempfile

        return tempfile.mkdtemp(prefix="paddle_tpu_torch_trace_")

    def _start_trace(self):
        if not self._tracing and not self._timer_only:
            self._dir = self._trace_dir()
            self._prof = torch.profiler.profile(
                activities=self._activities, **self._opts)
            self._prof.__enter__()
            self._tracing = True
            # telemetry spans now enter record_function, so host
            # request/engine spans sit beside the kernels in this trace
            telemetry.set_device_trace_active(True)

    def _stop_trace(self):
        if self._tracing:
            telemetry.set_device_trace_active(False)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self._tracing = False
            os.makedirs(self._dir, exist_ok=True)
            worker = (getattr(self._on_trace_ready, "_worker_name", None)
                      or "host")
            self._windows += 1
            path = os.path.join(
                self._dir,
                f"{worker}.{os.getpid()}.{self._windows}.trace.json")
            self._prof.export_chrome_trace(path)
            self.last_trace_path = path
            self._last_export_dir = self._dir
            if self._on_trace_ready is not None:
                self._on_trace_ready(self)

    def start(self):
        self._benchmark.begin()
        self.current_state = self._scheduler(self.step_num)
        if self.current_state in (ProfilerState.READY, ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._start_trace()
        return self

    def stop(self):
        self._benchmark.end()
        self._stop_trace()
        self.current_state = ProfilerState.CLOSED

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def step(self, num_samples=None):
        self._benchmark.step(num_samples)
        self.step_num += 1
        new_state = self._scheduler(self.step_num)
        recording = self.current_state in (
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN,
            ProfilerState.READY)
        should_record = new_state in (
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN,
            ProfilerState.READY)
        if recording and not should_record:
            self._stop_trace()
        elif should_record and not recording:
            self._start_trace()
        self.current_state = new_state

    def step_info(self, unit="samples"):
        return self._benchmark.step_info(unit)

    def export(self, path=None, format="json"):
        """Traces are written when a window closes. With ``path``, copy the
        last trace there (a directory keeps the file's name) and return
        ``path``; without it, return the trace directory. Only Chrome-trace
        ``format="json"`` exists — anything else is an explicit error, not
        a silent ignore."""
        if format not in (None, "json"):
            raise ValueError(
                f"unsupported export format {format!r}: torch.profiler "
                f"writes chrome-trace json (pass format='json')")
        if path is None:
            return self._last_export_dir
        if self.last_trace_path is None:
            raise RuntimeError(
                "no trace to export: start()/stop() a recording window "
                "first (timer_only profilers never record traces)")
        import shutil

        if os.path.isdir(path):
            shutil.copy(self.last_trace_path, path)
        else:
            shutil.copyfile(self.last_trace_path, path)
        return path

    def summary(self, max_rows=10, print_table=True, **kwargs):
        """Throughput report + per-op time tables parsed from the exported
        traces. Returns the benchmark report dict extended with
        ``op_summary`` (device kernels and copies) and ``host_summary``
        (host ops and annotations) rows; prints the formatted table like
        the reference unless ``print_table=False``."""
        report = self._benchmark.report()
        if self._last_export_dir is not None:
            dev_rows, host_rows = parse_trace_op_times(self._last_export_dir)
            report["op_summary"] = dev_rows[:max_rows]
            report["host_summary"] = host_rows[:max_rows]
            report["trace_files_seen"] = dev_rows.meta["files_seen"]
            report["trace_files_skipped"] = dev_rows.meta["files_skipped"]
            if print_table and (dev_rows or host_rows):
                print(format_op_table(dev_rows[:max_rows],
                                      host_rows[:max_rows]))
            if print_table and dev_rows.meta["files_skipped"]:
                print(f"!! {dev_rows.meta['files_skipped']} of "
                      f"{dev_rows.meta['files_seen']} trace files could "
                      f"not be parsed (see parse_trace_op_times(...).meta)")
        return report


# ---------------------------------------------------------------------------
# Benchmark (ips instrument)
# ---------------------------------------------------------------------------

class TimeAverager:
    """Running averages with sample accounting."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total_time = 0.0
        self._count = 0
        self._total_samples = 0

    def record(self, usetime, num_samples=None):
        self._total_time += usetime
        self._count += 1
        if num_samples:
            self._total_samples += num_samples

    def get_average(self):
        return self._total_time / self._count if self._count else 0.0

    def get_ips_average(self):
        if not self._total_samples or self._total_time == 0.0:
            return 0.0
        return self._total_samples / self._total_time

    @property
    def count(self):
        return self._count


class Benchmark:
    """reader_cost / batch_cost / ips throughput instrument."""

    def __init__(self):
        self.reader = TimeAverager()
        self.batch = TimeAverager()
        self._reader_t0 = None
        self._batch_t0 = None
        self.num_samples = None
        self.speed_unit = "samples/s"

    def begin(self):
        now = time.perf_counter()
        self._batch_t0 = now
        self._reader_t0 = now

    def before_reader(self):
        self._reader_t0 = time.perf_counter()

    def after_reader(self):
        if self._reader_t0 is not None:
            self.reader.record(time.perf_counter() - self._reader_t0)

    def step(self, num_samples=None):
        """Close out one step."""
        now = time.perf_counter()
        if self._batch_t0 is not None:
            self.batch.record(now - self._batch_t0, num_samples)
        self._batch_t0 = now
        self.num_samples = num_samples

    after_step = step

    def end(self):
        self._batch_t0 = None

    # -- reporting -------------------------------------------------------
    def reader_average(self):
        return self.reader.get_average()

    def batch_average(self):
        return self.batch.get_average()

    def speed_average(self):
        return self.batch.get_ips_average()

    def step_info(self, unit="samples"):
        msg = ""
        if self.reader.count:
            msg += f" reader_cost: {self.reader_average():.5f} s"
        if self.batch.count:
            msg += f" batch_cost: {self.batch_average():.5f} s"
        ips = self.speed_average()
        if ips:
            msg += f" ips: {ips:.3f} {unit}/s"
        return msg

    def report(self):
        return {
            "reader_cost": self.reader_average(),
            "batch_cost": self.batch_average(),
            "ips": self.speed_average(),
        }

    def reset(self):
        self.reader.reset()
        self.batch.reset()
        # stale step anchors would make the first step() after a reset
        # record the whole inter-reset gap as one bogus batch interval
        self._reader_t0 = None
        self._batch_t0 = None
        self.num_samples = None


# ---------------------------------------------------------------------------
# Per-op summary tables from the exported traces
# ---------------------------------------------------------------------------

class _OpRows(list):
    """Row list with parse provenance attached: ``rows.meta`` counts the
    trace files seen vs skipped (unreadable/corrupt), so an empty summary
    is distinguishable from a summary whose inputs all failed to parse."""

    def __init__(self, rows=(), meta=None):
        super().__init__(rows)
        self.meta = meta or {"files_seen": 0, "files_skipped": 0,
                             "skipped": []}


# the torch Chrome trace's categories: what ran on the device, and the
# host's ops and annotations (python frames are left out, as in the
# reference)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def parse_trace_op_times(trace_dir):
    """Aggregate the Chrome traces exported under ``trace_dir``
    (``*.trace.json``) into (device_rows, host_rows): per-name {calls,
    total_us, avg_us, pct} sorted by total time desc. Device rows are the
    CUDA kernels, copies and memsets; host rows are the host's ops,
    annotations (``RecordEvent``, telemetry spans) and runtime calls. Both
    lists carry a ``.meta`` dict — {files_seen, files_skipped, skipped:
    [(path, error)]} — naming every trace file that could not be parsed
    instead of silently dropping it."""
    import collections
    import glob
    import json

    files = sorted(glob.glob(os.path.join(trace_dir, "*.trace.json")))
    meta = {"files_seen": len(files), "files_skipped": 0, "skipped": []}
    dev = collections.defaultdict(lambda: [0, 0.0])
    host = collections.defaultdict(lambda: [0, 0.0])
    for f in files:
        try:
            with open(f) as fh:
                events = json.load(fh).get("traceEvents", [])
        except Exception as e:
            meta["files_skipped"] += 1
            meta["skipped"].append((f, f"{type(e).__name__}: {e}"))
            continue
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in _DEVICE_CATS:
                bucket = dev
            elif cat in _HOST_CATS:
                bucket = host
            else:
                continue
            entry = bucket[e.get("name", "")]
            entry[0] += 1
            entry[1] += float(e.get("dur", 0.0))

    def rows(bucket):
        total = sum(v[1] for v in bucket.values()) or 1.0
        out = [{"name": n, "calls": c, "total_us": round(t, 1),
                "avg_us": round(t / c, 2) if c else 0.0,
                "pct": round(100.0 * t / total, 2)}
               for n, (c, t) in bucket.items()]
        out.sort(key=lambda r: -r["total_us"])
        return _OpRows(out, meta)

    return rows(dev), rows(host)


def format_op_table(dev_rows, host_rows):
    """Render rows like the reference's summary tables."""
    lines = []

    def table(title, rows):
        if not rows:
            return
        lines.append(f"---- {title} " + "-" * max(0, 66 - len(title)))
        lines.append(f"{'Name':<44} {'Calls':>6} {'Total(us)':>12} "
                     f"{'Avg(us)':>10} {'Ratio(%)':>9}")
        for r in rows:
            nm = r["name"] if len(r["name"]) <= 44 else r["name"][:41] + "..."
            lines.append(f"{nm:<44} {r['calls']:>6} {r['total_us']:>12.1f} "
                         f"{r['avg_us']:>10.2f} {r['pct']:>9.2f}")

    table("Device (CUDA) op summary", dev_rows)
    table("Host summary", host_rows)
    return "\n".join(lines)


_GLOBAL_BENCHMARK = Benchmark()


def benchmark() -> Benchmark:
    """Global instance (reference timer.py benchmark())."""
    return _GLOBAL_BENCHMARK


# ---------------------------------------------------------------------------
# MFU accounting
# ---------------------------------------------------------------------------

def peak_flops(platform: str | None = None) -> float:
    """Dense bf16 FLOP/s of the card (``telemetry.cost.platform_peaks``:
    an NVIDIA H100's public 989e12; the CPU's is a placeholder)."""
    return telemetry.cost.platform_peaks(platform)["flops_per_s"]


def transformer_flops_per_token(n_params: int, n_layers: int, hidden: int,
                                seq_len: int) -> float:
    """6N weight flops + 12·L·H·S attention flops per trained token (the
    standard PaLM-appendix accounting)."""
    return 6.0 * n_params + 12.0 * n_layers * hidden * seq_len


def mfu(tokens_per_sec: float, flops_per_token: float,
        platform: str | None = None) -> float:
    return tokens_per_sec * flops_per_token / peak_flops(platform)
