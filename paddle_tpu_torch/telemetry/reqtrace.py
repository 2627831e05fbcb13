"""Request-scoped trace propagation: one Chrome trace per served request
(counterpart of ``paddle_tpu/telemetry/reqtrace.py``, kept as it is; the
port's fleet, which carries the context across processes, is a later
slice).

A fleet keeps spans per process: the gateway/router record into their
tracer, every replica (possibly a separate ``ProcReplica`` child) into its
own, and a request that crosses a replica pipe — or fails over mid-stream —
leaves no single timeline anyone can read. This module is the glue:

- **Trace context** — the gateway/router mint a ``trace_id`` per request
  (:func:`new_trace_id`) and propagate it through ``FleetRouter.submit``
  into the replica pipe protocol (a ``trace_id`` field on the ``add``
  command). Replica-side engine spans carry it as a span attr
  (``trace_id=...``, or ``trace_ids=[...]`` for batch-level decode ticks
  shared by several requests).
- **Wire format** — :func:`drain_request_spans` scans the process-global
  tracer for spans newer than a watermark that carry trace context and
  serializes them with **unix** timestamps (``tracing.mono_to_unix``), so
  hops from different processes land on one wall-clock timeline; replicas
  attach the drained spans to their periodic heartbeat events, which is
  what lets the first hop of a failover survive its replica's SIGKILL.
- **Merge** — :func:`merge_request_trace` generalizes the cross-rank
  Chrome merge from ranks to replicas: each hop (gateway/router process,
  every replica that served the request) becomes one process row, rebased
  through ``cluster.merge_traces``'s clock-corrected machinery (same-host
  replicas share a clock, but the ``offsets_s`` hook accepts per-source
  NTP-style estimates exactly like rank merges do).

``FleetRouter.request_trace(gid)`` assembles the sources.
"""
from __future__ import annotations

import json
import os

from .tracing import mono_to_unix, tracer

__all__ = [
    "new_trace_id", "span_to_wire", "spans_to_wire", "drain_request_spans",
    "wire_trace_ids", "merge_request_trace",
]

TRACE_ATTR = "trace_id"
MULTI_ATTR = "trace_ids"


def new_trace_id(prefix: str = "req") -> str:
    return f"{prefix}-{os.urandom(6).hex()}"


def span_to_wire(span) -> dict:
    """One tracer Span as a process-independent dict: unix-stamped, attrs
    carried verbatim (the trace context rides in them)."""
    return {
        "name": span.name,
        "t0_unix": mono_to_unix(span.t0),
        "t1_unix": mono_to_unix(span.t1),
        "span_id": span.span_id,
        "parent_id": span.parent_id,
        "attrs": dict(span.attrs),
    }


def _carries_context(attrs: dict) -> bool:
    return bool(attrs.get(TRACE_ATTR) or attrs.get(MULTI_ATTR))


def spans_to_wire(spans) -> list[dict]:
    return [span_to_wire(s) for s in spans if _carries_context(s.attrs)]


def drain_request_spans(last_span_id: int, *,
                        engine_label=None) -> tuple[list[dict], int]:
    """New trace-context-carrying spans since ``last_span_id`` from the
    process-global tracer, serialized for the pipe. ``engine_label``
    filters to one engine's spans — two LocalReplica drivers share a
    process tracer, and each must heartbeat only its own engine's spans.
    Returns (wire spans, new watermark)."""
    out = []
    wm = int(last_span_id)
    for s in tracer().spans():
        if s.span_id <= last_span_id:
            continue
        wm = max(wm, s.span_id)
        a = s.attrs
        if not _carries_context(a):
            continue
        if engine_label is not None and \
                str(a.get("engine")) != str(engine_label):
            continue
        out.append(span_to_wire(s))
    return out, wm


def wire_trace_ids(wire_span: dict) -> tuple:
    """Every trace id a wire span belongs to (batch-level decode ticks
    carry several)."""
    a = wire_span.get("attrs") or {}
    tid = a.get(TRACE_ATTR)
    if tid:
        return (tid,)
    return tuple(a.get(MULTI_ATTR) or ())


# ---------------------------------------------------------------------------
# the merge: one process row per hop, via the cross-rank machinery
# ---------------------------------------------------------------------------

def _source_trace(wire_spans: list[dict]) -> tuple[dict, float]:
    """One hop's wire spans as a Chrome trace dict with a local epoch —
    exactly the shape ``cluster.merge_traces`` consumes per rank."""
    base = min(s["t0_unix"] for s in wire_spans)
    events = []
    for s in wire_spans:
        args = dict(s.get("attrs") or {})
        args["span_id"] = s.get("span_id")
        if s.get("parent_id") is not None:
            args["parent_id"] = s["parent_id"]
        events.append({
            "ph": "X", "name": s["name"], "pid": 0, "tid": 1,
            "ts": round((s["t0_unix"] - base) * 1e6, 3),
            "dur": round((s["t1_unix"] - s["t0_unix"]) * 1e6, 3),
            "args": args,
        })
    return ({"traceEvents": events, "otherData": {"epoch_unix": base}},
            base)


def merge_request_trace(trace_id: str, sources: dict, *,
                        out_path: str | None = None,
                        offsets_s: dict | None = None,
                        meta: dict | None = None) -> dict:
    """Merge one request's hops into a single Chrome trace.

    ``sources``: {row label: [wire spans]} — e.g. ``{"gateway": [...],
    "r0": [...], "r1": [...]}``; empty lists are dropped. Reuses
    :func:`cluster.merge_traces` (rank merge generalized to string row
    labels) so timestamps are rebased onto one clock-corrected timeline.
    ``meta`` lands in ``otherData`` (failover count, replica hop order,
    suppressed-token count...)."""
    from .cluster import merge_traces

    traces, bases = {}, {}
    for label, spans in sources.items():
        if not spans:
            continue
        traces[label], bases[label] = _source_trace(list(spans))
    if traces:
        doc = merge_traces(traces, offsets_s=offsets_s, bases_unix=bases)
    else:
        doc = {"traceEvents": [], "displayTimeUnit": "ms", "otherData": {}}
    doc["otherData"]["trace_id"] = trace_id
    doc["otherData"]["request_trace"] = True
    for k, v in (meta or {}).items():
        doc["otherData"][k] = v
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, default=str)
    return doc
