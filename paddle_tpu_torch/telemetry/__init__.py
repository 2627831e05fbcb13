"""paddle_tpu_torch.telemetry — metrics, tracing, and the flight recorder
(counterpart of ``paddle_tpu/telemetry/``: the same modules, exports and
``enable()`` / ``disable()`` / ``enabled()``).

Three observability primitives, one process-global instance of each, shared
by every built-in layer (serving engine, scheduler and KV cache, the
static Executor, the DataLoader's fault site, the fault-injection registry)
so a single serving process can produce a Prometheus exposition, a Chrome
trace, and a crash postmortem from the same run:

- :mod:`.metrics` — ``Counter`` / ``Gauge`` / ``Histogram`` families with
  label sets in a :func:`registry`; Prometheus text exposition and JSON
  snapshot export. Cheap enough for per-token hot paths.
- :mod:`.tracing` — ``span(name, **attrs)`` context manager; in-process
  span log with trace/span ids, Chrome ``trace.json`` export, and
  ``torch.profiler.record_function`` annotations while a device trace is
  active so host spans sit beside the CUDA kernels in the torch trace.
- :mod:`.flight_recorder` — bounded ring of recent runtime events
  (allocator traffic, scheduler decisions, fault injections, compiles),
  dumped to disk on engine stalls, LockSan violations and uncaught
  exceptions.

Cluster-scale layers on top:

- :mod:`.cluster` — the cross-rank plane: per-rank publishers over a
  duck-typed store, fleet aggregation, collective-heartbeat
  straggler/hang diagnosis, multi-rank postmortem bundles, and
  clock-corrected Chrome trace merging.
- :mod:`.slo` — rolling-window TTFT/TPOT/queue percentiles + goodput and
  the admit/shed health signal on ``LLMEngine.stats()["slo"]``.

The performance layer:

- :mod:`.perf` — why did it recompile (``CompileWatcher`` over every
  compile point of the port: ``jit.to_static`` signatures,
  ``static.Executor`` compiles, the registered kernel ops' traces and the
  ``nvcc`` builds; recompilation-storm detection, ``explain_recompile()``
  signature diffs), where did the memory go (``MemoryMonitor`` per-tag
  live/peak accounting, ``torch.cuda.memory_stats()``, the leak sentinel),
  and which phase got slower (``StepTimeline``).
- :mod:`.cost` — the roofline cost model: FLOPs (matmul / elementwise)
  counted over torch's dispatch plus each hand-written kernel's declared
  work, and HBM bytes of a step's top-level inputs and outputs.

The ops plane:

- :mod:`.history` — ``TimeSeriesStore``: a background sampler turns the
  instantaneous registry into bounded raw/10s/1m downsampling rings.
- :mod:`.alerts` — declarative threshold / absence / multi-window
  SLO-burn-rate rules with a pending→firing→resolved lifecycle.
- :mod:`.pyprof` — continuous sampling profiler over
  ``sys._current_frames()``; folded-flamegraph / speedscope exports.

:func:`disable` flips one shared flag that every write path checks first —
the escape hatch for measuring the instrumentation itself.
"""
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    DEFAULT_BUCKETS,
    registry,
)
from .metrics import ENABLED as _ENABLED
from .tracing import (  # noqa: F401
    Span,
    Tracer,
    device_trace_active,
    mono_to_unix,
    set_device_trace_active,
    span,
    trace_id,
    tracer,
)
from .flight_recorder import (  # noqa: F401
    FlightRecorder,
    dump,
    flight,
    install_excepthook,
    record_event,
)
from . import cluster  # noqa: F401  (cross-rank plane: publisher/monitor/
#                                    aggregator/trace merge — see cluster.py)
from .slo import SLOTracker  # noqa: F401
from . import perf  # noqa: F401  (performance observability: CompileWatcher /
#                                  MemoryMonitor / StepTimeline — see perf.py)
from .perf import (  # noqa: F401
    compile_watcher,
    explain_recompile,
    memory_monitor,
    step_timeline,
)
from . import cost  # noqa: F401  (roofline cost model: dispatch FLOPs /
#                                  bytes count + trace-cost registry)
from . import reqtrace  # noqa: F401  (request-scoped trace propagation +
#                                      per-request Chrome merge — reqtrace.py)
from . import history  # noqa: F401  (metrics history: TimeSeriesStore
#                                     downsampling rings — see history.py)
from .history import TimeSeriesStore  # noqa: F401
from . import alerts  # noqa: F401  (SLO burn-rate / threshold / absence
#                                    rule engine — see alerts.py)
from .alerts import AlertEngine, default_rules  # noqa: F401
from . import pyprof  # noqa: F401  (continuous sampling profiler: folded /
#                                    speedscope + fleet merge — pyprof.py)
from .pyprof import SamplingProfiler  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_BUCKETS", "registry", "Span", "Tracer", "span", "tracer",
    "trace_id", "mono_to_unix", "set_device_trace_active",
    "device_trace_active",
    "FlightRecorder", "flight", "record_event", "dump", "install_excepthook",
    "enable", "disable", "enabled", "prometheus_text", "snapshot",
    "cluster", "SLOTracker", "perf", "compile_watcher", "memory_monitor",
    "step_timeline", "explain_recompile", "cost", "reqtrace",
    "history", "TimeSeriesStore", "alerts", "AlertEngine", "default_rules",
    "pyprof", "SamplingProfiler",
]


def disable():
    """Turn every telemetry write path into a single flag check (metrics,
    spans, flight events all stop recording; reads keep working)."""
    _ENABLED[0] = False


def enable():
    _ENABLED[0] = True


def enabled() -> bool:
    return _ENABLED[0]


def prometheus_text() -> str:
    """Exposition of the global registry (shorthand)."""
    return registry().prometheus_text()


def snapshot() -> dict:
    """JSON snapshot of the global registry (shorthand)."""
    return registry().snapshot()
