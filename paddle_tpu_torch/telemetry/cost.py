"""Roofline cost model: FLOPs + HBM bytes per step signature (counterpart
of ``paddle_tpu/telemetry/cost.py``).

The reference walks a jaxpr; the port counts torch's dispatch:

- :class:`CostCounter` is a ``TorchDispatchMode``. Every aten op a step
  dispatches is counted as it runs: the products (``mm``, ``bmm``,
  ``addmm``, convolutions, SDPA: ``torch.utils.flop_counter``'s formulas)
  into ``matmul_flops``, reductions at one flop per *input* element and
  every other computing op at one flop per *output* element into
  ``elementwise_flops``; data movement (views, copies, casts, gathers,
  scatters, factories) counts zero — the reference's split.
- **The hand-written kernels.** An eager launch goes through ``ctypes``,
  so no aten op is dispatched for it, and a dispatch count alone would
  see zero flops for paged attention or flash on the card while the
  CPU's plain versions (aten einsums) count theirs. So every eager
  wrapper goes through ``kernels.route``: under a counter it notes the
  kernel by its registered op's name (``kernels`` of the estimate) and,
  where it launches, runs the kernel's plain version on the same inputs
  beside the launch, counted and its result dropped. A registered op
  dispatched under the counter (inside a program) is counted the same
  way, by its plain version (``kernels/library.py``'s ``OPS``). The
  card's count of a step is then the CPU's for the same inputs, by
  construction: one definition of each kernel's work, its plain version.
- ``bytes`` is the step's top-level inputs plus outputs — the weights,
  the KV pool and the tokens, as in the reference's ``jaxpr_cost``: the
  minimum traffic of a perfectly fused step, the roofline-relevant number
  of a memory-bound decode. Tensors written in place (the KV pool) are
  passed as ``outputs`` explicitly, where the reference's functional step
  returns them.
- :func:`measure` / :func:`estimate_fn_cost` run a callable under a
  counter. The serving engine counts each new step signature's step once,
  shape-only (``FakeTensorMode``, the kernels' plain versions on the CPU)
  and off the request path, when ``stats()`` reads the roofline.
- :func:`register_trace` records the estimate per ``(callable, bucket)``
  in a process-global registry (fingerprinted by model config so
  identical engines share one estimate) and publishes ``trace_flops`` /
  ``trace_bytes`` / ``trace_arithmetic_intensity`` gauges.
- :func:`platform_peaks` + :func:`roofline_time_s` turn an estimate into
  the roofline-model lower bound on step wall time,
  ``max(flops / peak_flops, bytes / peak_bw)``; the engine divides it by
  the measured step time into ``serving_roofline_frac``.

Peaks: an NVIDIA H100 (SXM) is its public 989e12 dense bf16 FLOP/s and
3.35e12 B/s; the CPU's numbers are placeholders for shape, not truth.
``$PADDLE_TPU_PEAK_FLOPS`` / ``$PADDLE_TPU_PEAK_BW`` override either.
"""
from __future__ import annotations

import math
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .metrics import registry
from ..analysis import locksan

__all__ = [
    "CostCounter", "measure", "estimate_fn_cost",
    "register_trace", "lookup", "traces", "clear",
    "platform_peaks", "roofline_time_s", "achieved_fraction",
]

# ops that move / reshape / create data but compute nothing (zero flops;
# their traffic is covered by the whole-step byte accounting)
_ZERO_FLOP = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "unsqueeze", "squeeze", "slice", "select", "as_strided", "alias",
    "detach", "lift_fresh", "lift_fresh_copy", "clone", "copy", "copy_",
    "_to_copy", "to", "contiguous", "_reshape_alias", "unfold", "split",
    "split_with_sizes", "unbind", "chunk", "narrow", "cat", "stack",
    "index", "index_select", "index_put", "index_put_", "_index_put_impl_",
    "gather", "scatter", "scatter_", "embedding", "repeat",
    "repeat_interleave", "flip", "roll", "pad", "constant_pad_nd",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "fill", "fill_", "zero_", "arange",
    "scalar_tensor", "_local_scalar_dense", "set_", "resize_",
    "_assert_async", "_assert_tensor_metadata", "item", "randint",
    "normal", "normal_", "uniform", "uniform_", "rand", "randn",
    "bernoulli", "bernoulli_", "random_", "exponential_",
})
# reductions: one flop per *input* element (the sum/max tree)
_REDUCE = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "cumsum", "cumprod", "logsumexp", "var", "std", "var_mean",
    "std_mean", "norm", "linalg_vector_norm", "all", "any", "_softmax",
    "_log_softmax", "softmax", "log_softmax",
})

def _numel(t) -> int:
    return math.prod(int(s) for s in t.shape)


def _nbytes(t) -> int:
    return _numel(t) * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs of everything dispatched while it is active (see
    the module docstring); ``kernels`` holds the hand-written kernels'
    calls by registered op name, each counted by its plain version."""

    def __init__(self):
        super().__init__()
        self.matmul_flops = 0
        self.elementwise_flops = 0
        self.kernels: dict[str, int] = {}

    def __enter__(self):
        from .. import kernels
        kernels.push_work_counter(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from .. import kernels
        kernels.pop_work_counter(self)
        return super().__exit__(*exc)

    def note_kernel(self, name: str):
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if ns == "paddle_tpu_torch":        # a kernel's registered op
            from ..kernels.library import OPS
            name = func._overloadpacket.__name__
            self.note_kernel(name)
            with self, torch.no_grad():
                OPS[name][2](*args, **kwargs)   # its plain version, counted
            return func(*args, **kwargs)
        if ns == "aten" and func._can_decompose():
            # under inference mode a composite op (linear, matmul, einsum)
            # arrives whole: decompose it, so its products are counted
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.matmul_flops += int(formula(*args, **kwargs, out_val=out))
            return
        name = packet.__name__
        if name in _ZERO_FLOP or getattr(func, "is_view", False):
            return
        if name in _REDUCE:
            self.elementwise_flops += sum(
                _numel(a) for a in args if isinstance(a, torch.Tensor))
            return
        self.elementwise_flops += sum(
            _numel(o) for o in tree_leaves(out) if isinstance(o, torch.Tensor))


def _tensor_bytes(tree, seen: set) -> int:
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def measure(fn, *args, inputs=(), outputs=(), **kwargs):
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`; returns
    ``(estimate, result)``. ``bytes`` counts every tensor of ``args`` /
    ``kwargs`` plus ``inputs`` (the weights a module holds) once, and every
    tensor of the result plus ``outputs`` (what ``fn`` writes in place)."""
    with CostCounter() as c:
        result = fn(*args, **kwargs)
    in_bytes = _tensor_bytes((args, kwargs, list(inputs)), set())
    out_bytes = _tensor_bytes((result, list(outputs)), set())
    flops = c.matmul_flops + c.elementwise_flops
    nbytes = in_bytes + out_bytes
    est = {
        "flops": flops,
        "matmul_flops": c.matmul_flops,
        "elementwise_flops": c.elementwise_flops,
        "bytes": nbytes,
        "input_bytes": in_bytes,
        "output_bytes": out_bytes,
        "arithmetic_intensity": flops / nbytes if nbytes else 0.0,
        "kernels": dict(c.kernels),
    }
    return est, result


def estimate_fn_cost(fn, *args, inputs=(), outputs=(), **kwargs) -> dict:
    """:func:`measure`'s estimate alone (``fn`` runs once)."""
    return measure(fn, *args, inputs=inputs, outputs=outputs, **kwargs)[0]


# ---------------------------------------------------------------------------
# trace-cost registry (per callable+bucket, fingerprinted)
# ---------------------------------------------------------------------------

_LOCK = locksan.Lock("cost.registry")
_TRACES: dict[tuple, dict] = {}     # (callable, bucket) -> entry
_CM = None


def _cost_metrics():
    global _CM
    if _CM is None:
        reg = registry()
        ls = ("callable", "bucket")
        _CM = (
            reg.gauge("trace_flops",
                      "modeled FLOPs of one compiled trace", ls),
            reg.gauge("trace_bytes",
                      "modeled HBM bytes (inputs+outputs) of one compiled "
                      "trace", ls),
            reg.gauge("trace_arithmetic_intensity",
                      "modeled flops/byte of one compiled trace", ls),
        )
    return _CM


def register_trace(name: str, bucket: str, cost: dict, *,
                   fingerprint=None, **meta) -> dict:
    """Record one trace's cost estimate (idempotent per (name, bucket));
    publishes the ``trace_*`` gauges. Returns the stored entry."""
    entry = {"callable": name, "bucket": str(bucket),
             "fingerprint": fingerprint, **cost, **meta}
    with _LOCK:
        _TRACES[(name, str(bucket))] = entry
    fl, by, ai = _cost_metrics()
    fl.labels(callable=name, bucket=str(bucket)).set(cost.get("flops", 0))
    by.labels(callable=name, bucket=str(bucket)).set(cost.get("bytes", 0))
    ai.labels(callable=name, bucket=str(bucket)).set(
        cost.get("arithmetic_intensity", 0.0))
    return entry


def lookup(name: str, bucket: str, fingerprint=None) -> dict | None:
    """A previously-registered estimate — only when the fingerprint (model
    config + engine geometry) matches, so two different models sharing a
    bucket label never share a cost."""
    with _LOCK:
        entry = _TRACES.get((name, str(bucket)))
    if entry is None:
        return None
    if fingerprint is not None and entry.get("fingerprint") != fingerprint:
        return None
    return dict(entry)


def traces() -> list[dict]:
    with _LOCK:
        return [dict(e) for e in _TRACES.values()]


def clear():
    with _LOCK:
        _TRACES.clear()


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

# peak dense flop/s and peak memory bandwidth bytes/s per device: the
# NVIDIA H100 SXM's public dense bf16 and HBM3 numbers; the CPU entry is a
# placeholder that gives the *shape* of the number on dev hosts, not truth
_PEAKS = {
    "h100": (989e12, 3.35e12),
    "cpu": (1e11, 2e10),
}


def _platform(device=None) -> str:
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return "cpu"
    elif not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(device)
    return "h100" if "H100" in name else name


def platform_peaks(platform: str | None = None, device=None) -> dict:
    """{platform, flops_per_s, bytes_per_s} of ``platform`` (``"h100"``,
    ``"cpu"``) or of ``device`` (default: the card when one is visible);
    ``$PADDLE_TPU_PEAK_FLOPS`` / ``$PADDLE_TPU_PEAK_BW`` override (bench
    hosts vary). A card without an entry gets None for what no override
    gives: its peaks are not guessed."""
    if platform is None:
        platform = _platform(device)
    flops, bw = _PEAKS.get(platform, (None, None))
    try:
        flops = float(os.environ.get("PADDLE_TPU_PEAK_FLOPS") or flops)
        bw = float(os.environ.get("PADDLE_TPU_PEAK_BW") or bw)
    except (TypeError, ValueError):
        pass
    return {"platform": platform, "flops_per_s": flops, "bytes_per_s": bw}


def roofline_time_s(cost: dict, peaks: dict | None = None) -> float | None:
    """The roofline lower bound on wall time: compute-bound or
    memory-bound, whichever dominates (None without both peaks)."""
    peaks = peaks or platform_peaks()
    if not peaks["flops_per_s"] or not peaks["bytes_per_s"]:
        return None
    return max(cost.get("flops", 0) / peaks["flops_per_s"],
               cost.get("bytes", 0) / peaks["bytes_per_s"])


def achieved_fraction(cost: dict, wall_s: float,
                      peaks: dict | None = None) -> float | None:
    """roofline_time / measured wall — 1.0 means the step ran as fast as
    the roofline model says the hardware allows."""
    if not wall_s or wall_s <= 0:
        return None
    t = roofline_time_s(cost, peaks)
    return None if t is None else t / float(wall_s)
