"""Engine replica child process (``python -m paddle_tpu_torch.serving.replica_worker``).

Counterpart of ``paddle_tpu/serving/replica_worker.py``, with the same
pipe protocol and ``PROTO_VERSION``. One
:class:`~paddle_tpu_torch.serving.engine.LLMEngine` behind a newline-JSON
pipe protocol, spawned and owned by a
:class:`~paddle_tpu_torch.serving.router.ProcReplica`. The model/engine spec
arrives in ``$PADDLE_REPLICA_SPEC`` (JSON) so every replica of a fleet
builds **bit-identical weights** (same seed, same config, same device) —
the property that makes failover replay token-for-token exact:

    {"seed": 0,
     "llama_tiny": {"vocab": 128, "hidden": 64, ...},   # model config
     "device": "cpu",                                   # default "cuda"
     "engine": {"block_size": 8, "max_slots": 3, ...},  # LLMEngine kwargs
     "stats_interval_s": 0.1}

or ``"llama_7b": {"layers": 32, "dtype": "bfloat16"}`` in place of
``"llama_tiny"`` for the Llama-2-7B widths (:func:`build_model`).

Protocol (one JSON object per line):

    stdin  <- {"op": "add", "gid": 7, "prompt": [...],
               "sampling": {...}, "deadline_s": 1.5 | null,
               "trace_id": "req-ab12cd" | null,
               "tenant": "acme" | null, "priority": 0}
              {"op": "cancel", "gid": 7}
              {"op": "kv_fetch", "fid": 3, "hashes": [...],
               "max_frames": 64, "max_bytes": 33554432}
              {"op": "kv_ingest", "frames": [...]}
              {"op": "close"}
    stdout -> {"ev": "hello", "pid": 1234}
              {"ev": "token", "gid": 7, "tok": 42, "i": 0}
              {"ev": "done", "gid": 7, "state": "finished",
               "reason": "length", "error": null, "n": 16}
              {"ev": "stats", "stats": {... replica_stats() ...},
               "spans": [... optional: request-scoped spans since the
                         last heartbeat, unix-stamped wire format —
                         telemetry.reqtrace ...]}
              {"ev": "kv_blocks", "fid": 3, "frames": [...],
               "error": null}
              {"ev": "kv_ingested", "ingested": 4, "corrupt": 0,
               "errors": 0}
              {"ev": "bye"}

``kv_fetch`` / ``kv_ingest`` are the KV-fabric migration verbs
(serving/kv_fabric.py): the router pulls CRC32-stamped block frames from
this replica (the donor half) or lands frames fetched from a sibling
(the receiver half, which re-verifies every stamp before promotion).
With ``"fabric": {"store": "host:port", ...}`` in the spec, the worker
additionally publishes its prefix-cache inventory to the fleet-wide
directory on every heartbeat (lease-fenced: a SIGKILL simply lets the
lease expire).

``trace_id`` is the router/gateway-minted request-trace context: the
engine stamps it on every span the request produces, and the heartbeat
streams those spans back so the router can merge one Chrome trace per
request across replica hops (``telemetry.reqtrace``).

Anything that is not protocol (import-time warnings, stray prints) fails
JSON parsing on the router side and is ignored; diagnostics belong on
stderr. Fault plans arm per replica through ``FLAGS_fault_plan`` in the
child environment — how one replica becomes a compile-error or
delay-storm victim while its siblings stay clean. A SIGKILL needs no
cooperation from this file at all; the router sees the pipe EOF.
"""
from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
from ..analysis import locksan


def build_model(spec: dict):
    """The deterministic model build both the worker and any in-process
    parity reference must share: the config, then the weights drawn from a
    ``torch.Generator`` seeded from ``spec["seed"]`` on the spec's device
    (``"cuda"`` unless the spec says ``"cpu"``; without a GPU and without
    ``"cpu"`` it raises). The config is ``llama_tiny`` with the spec's
    kwargs in float32, or with ``"llama_7b": {"layers": N, "dtype":
    "bfloat16"}`` the Llama-2-7B widths at N layers (default 32) in that
    dtype (default bfloat16)."""
    import torch

    from ..core import resolve_device
    from ..models import LlamaForCausalLM, llama_7b, llama_tiny

    device = resolve_device(spec.get("device") or "cuda")
    if "llama_7b" in spec:
        big = dict(spec.get("llama_7b") or {})
        cfg = llama_7b()
        cfg.num_hidden_layers = int(big.get("layers",
                                            cfg.num_hidden_layers))
        dtype = getattr(torch, big.get("dtype", "bfloat16"))
    else:
        cfg = llama_tiny(**(spec.get("llama_tiny") or {}))
        dtype = torch.float32
    gen = torch.Generator(device=device).manual_seed(int(spec.get("seed", 0)))
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype, generator=gen)
    model.eval()
    return model


def main() -> int:
    spec = json.loads(os.environ["PADDLE_REPLICA_SPEC"])
    from ..telemetry import reqtrace
    from . import kv_fabric
    from .engine import LLMEngine
    from .router import replica_stats, sampling_from_dict

    model = build_model(spec)
    engine = LLMEngine(model, **(spec.get("engine") or {}))
    stats_interval = float(spec.get("stats_interval_s", 0.1))
    publisher = None
    fab = spec.get("fabric")
    if fab:
        # fleet-wide prefix directory: own store connection (the wire
        # protocol is one-request-per-conn), publish piggybacks on the
        # heartbeat cadence. A dead store disables the fabric, never the
        # replica — the directory is advisory.
        try:
            rid = str(fab.get("rid") or os.environ.get(
                "PADDLE_REPLICA_RID") or f"pid{os.getpid()}")
            cfg = kv_fabric.FabricConfig(**{
                k: fab[k] for k in ("lease_s", "refresh_s", "max_hashes")
                if k in fab})
            publisher = kv_fabric.DirectoryPublisher(
                kv_fabric.connect_store(fab["store"]), rid, engine.cache,
                cfg=cfg,
                counters_fn=lambda: engine.cache.prefix_stats()["fabric"])
        except Exception as e:
            print(f"replica_worker: kv fabric disabled: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            publisher = None
    warmup = spec.get("warmup")
    if warmup:
        # run the first prefill and decode (kernel library loads, CUDA
        # context warm-up) before reporting ready: the router's liveness
        # timeout starts at the first heartbeat, and a slow first step
        # must not look like a hang
        from .scheduler import SamplingParams

        engine.generate([list(warmup)],
                        SamplingParams(max_new_tokens=2, temperature=0.0))

    out_lock = locksan.Lock("replica_worker.stdout")

    def emit(ev: dict):
        with out_lock:
            sys.stdout.write(json.dumps(ev) + "\n")
            sys.stdout.flush()

    cmds: queue.Queue = queue.Queue()

    def read_stdin():
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                cmds.put(json.loads(line))
            except json.JSONDecodeError:
                print(f"replica_worker: bad command line {line!r}",
                      file=sys.stderr)
        cmds.put({"op": "close"})          # router hung up

    threading.Thread(target=read_stdin, daemon=True,
                     name="replica-stdin-reader").start()
    # pipe-protocol handshake: the hello carries this worker's protocol
    # version so a rolling upgrade can mix versions behind one router
    # (PADDLE_PROTO_VERSION overrides it — how chaos exercises the
    # router's refusal path without shipping a genuinely old binary)
    from .router import PROTO_VERSION

    proto = int(os.environ.get("PADDLE_PROTO_VERSION", PROTO_VERSION))
    emit({"ev": "hello", "pid": os.getpid(), "proto_version": proto})

    tracked: dict[int, object] = {}        # gid -> engine Request

    def on_token(gid: int):
        def cb(req, tok):
            emit({"ev": "token", "gid": gid, "tok": int(tok),
                  "i": len(req.output_tokens) - 1})
        return cb

    def sweep():
        for gid, req in list(tracked.items()):
            if req.state.is_terminal:
                del tracked[gid]
                emit({"ev": "done", "gid": gid, "state": req.state.value,
                      "reason": req.finish_reason,
                      "error": (f"{type(req.error).__name__}: {req.error}"
                                if req.error is not None else None),
                      "n": len(req.output_tokens)})

    span_wm = 0                            # request-span drain watermark

    def heartbeat():
        nonlocal span_wm
        ev = {"ev": "stats", "stats": replica_stats(engine)}
        # request-scoped spans (trace-context-carrying) stream back with
        # every heartbeat, unix-stamped, so a SIGKILL mid-request still
        # leaves this hop's spans on the router for the merged trace
        spans, span_wm = reqtrace.drain_request_spans(
            span_wm, engine_label=engine.engine_label)
        if spans:
            ev["spans"] = spans
        emit(ev)
        if publisher is not None:
            try:
                publisher.maybe_publish()
            except Exception:  # lint: allow-silent(advisory publish; never kill the beat)
                pass

    last_pub = 0.0
    closing = False
    while not closing:
        try:
            has_work = engine.scheduler.has_work()
            cmd = cmds.get(block=not has_work, timeout=0.02)
        except queue.Empty:
            cmd = None
        if cmd is not None:
            op = cmd.get("op")
            if op == "close":
                closing = True
            elif op == "add":
                gid = cmd["gid"]
                try:
                    tracked[gid] = engine.add_request(
                        cmd["prompt"],
                        sampling_from_dict(cmd.get("sampling")),
                        on_token=on_token(gid),
                        deadline_s=cmd.get("deadline_s"),
                        trace_id=cmd.get("trace_id"),
                        tenant=cmd.get("tenant") or "anonymous",
                        priority=cmd.get("priority") or 0)
                except Exception as e:
                    emit({"ev": "done", "gid": gid, "state": "failed",
                          "reason": "add_failed",
                          "error": f"{type(e).__name__}: {e}", "n": 0})
            elif op == "cancel":
                req = tracked.get(cmd["gid"])
                if req is not None:
                    engine.cancel(req.rid)
            elif op == "kv_fetch":
                fid = cmd.get("fid")
                try:
                    frames = engine.export_kv_frames(
                        cmd.get("hashes") or [],
                        max_frames=cmd.get("max_frames"),
                        max_bytes=cmd.get("max_bytes"))
                    emit({"ev": "kv_blocks", "fid": fid, "frames": frames,
                          "error": None})
                except Exception as e:
                    emit({"ev": "kv_blocks", "fid": fid, "frames": [],
                          "error": f"{type(e).__name__}: {e}"})
            elif op == "kv_ingest":
                try:
                    rep = engine.ingest_kv_frames(cmd.get("frames") or [])
                except Exception as e:  # lint: allow-silent(error is captured into the kv_ingested reply)
                    rep = {"ingested": 0, "corrupt": 0, "errors": 1,
                           "error": f"{type(e).__name__}: {e}"}
                emit({"ev": "kv_ingested", **rep})
        if closing:
            break
        if engine.scheduler.has_work():
            engine.step()
        sweep()
        now = time.monotonic()
        if now - last_pub >= stats_interval:
            last_pub = now
            heartbeat()

    engine.close()
    sweep()
    heartbeat()
    if publisher is not None:
        publisher.close()                  # graceful: lease-zero tombstone
    emit({"ev": "bye"})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
