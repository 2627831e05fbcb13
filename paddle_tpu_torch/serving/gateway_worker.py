"""Gateway child process (``python -m paddle_tpu_torch.serving.gateway_worker``;
counterpart of ``paddle_tpu/serving/gateway_worker.py``).

A durability test needs a front door it can really SIGKILL mid-stream:
this module runs a complete serving stack — a :class:`LocalReplica`
fleet, a :class:`FleetRouter`, and a journaled :class:`Gateway` — in one
process, so killing the process
loses *all* gateway and router memory while the write-ahead journal
survives on disk. A relaunch with the same spec recovers every
accepted-non-terminal request.

The spec arrives in ``$PADDLE_GATEWAY_SPEC`` (JSON)::

    {"seed": 0,
     "llama_tiny": {...},               # model config (replica_worker's)
     "device": "cpu",                   # default "cuda"
     "engine": {...},                   # LLMEngine kwargs
     "warmup": [1, 2, ...],             # first prefill/decode before ready
     "n_replicas": 2,
     "stats_interval_s": 0.05,
     "router": {...},                   # FleetRouter kwargs
     "gateway": {...},                  # Gateway kwargs (journal_dir etc.)
     "ready_file": "/path/ready.json"}  # written once serving + recovered

Once the fleet is healthy and the gateway has finished recovery and is
listening, ``ready_file`` is written atomically with
``{"port", "pid", "gateway_id", "recovery"}`` — the parent polls for it.
The process then serves until SIGTERM (graceful stop) or SIGKILL (the
test). Fault plans arm through ``FLAGS_fault_plan`` in the environment,
exactly like ``replica_worker``.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading


def main() -> int:
    spec = json.loads(os.environ["PADDLE_GATEWAY_SPEC"])
    from .engine import LLMEngine
    from .gateway import Gateway
    from .replica_worker import build_model
    from .router import FleetRouter, LocalReplica

    def factory():
        return LLMEngine(build_model(spec), **(spec.get("engine") or {}))

    reps = [LocalReplica(f"p{i}", factory,
                         stats_interval_s=float(
                             spec.get("stats_interval_s", 0.05)),
                         warmup=spec.get("warmup"))
            for i in range(int(spec.get("n_replicas", 2)))]
    router = FleetRouter(reps, **(spec.get("router") or {}))
    router.start(wait_healthy_s=600)
    unhealthy = [r.rid for r in reps if r.state.value != "healthy"]
    if unhealthy:
        print(f"gateway_worker: fleet never became healthy: {unhealthy}",
              file=sys.stderr)
        return 1
    gateway = Gateway(router, **(spec.get("gateway") or {})).start()

    ready = spec.get("ready_file")
    if ready:
        tmp = ready + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"port": gateway.port, "pid": os.getpid(),
                       "gateway_id": gateway.gateway_id,
                       "recovery": gateway.recovery_report}, f)
        os.replace(tmp, ready)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    gateway.stop()
    router.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
