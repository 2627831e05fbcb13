"""TCPStore: rendezvous KV store over the native C++ server (counterpart of
``paddle_tpu/distributed/tcp_store.py``; Paddle's
``phi/core/distributed/store/tcp_store.h``): the master hosts the table,
workers set / get / add / wait to bootstrap and heartbeat. Both packages
bind the same ``csrc/tcp_store.cpp``, so either's client talks to the
other's server.

The port uses it for the cluster observability plane
(``telemetry.cluster.start_from_env``) and the serving fleet's KV-fabric
directory (``serving/kv_fabric.py``); ``torch.distributed`` keeps its own
store for process groups.

Robustness: rendezvous runs while the cluster is still assembling (the
master may not be up yet, and transient resets are normal during elastic
restarts). Connect and the request verbs therefore retry with
full-jitter exponential backoff (``retries`` / ``backoff_s``; the jitter
keeps a herd of simultaneously-failing ranks from re-converging on the
master in synchronized retry waves), and every terminal error names the
endpoint, the key, and how long was spent, so a timeout reads as "could
not reach 10.0.0.2:8765 after 4 attempts over 3.1s" instead of a bare
errno. Fault sites ``store.connect`` / ``store.get`` / ``store.set`` /
``store.add`` / ``store.wait`` let ``paddle_tpu_torch.utils.faults``
exercise the retry paths deterministically; ``store_*`` metric families
count verbs, retries, timeouts and seconds.
"""
from __future__ import annotations

import ctypes
import json
import random
import threading
import time

from .. import telemetry
from ..core import native
from ..utils import faults
from ..analysis import locksan

__all__ = ["TCPStore", "StoreTimeout", "StoreCorruptValue"]


def _store_metrics():
    reg = telemetry.registry()
    return (
        reg.counter("store_ops_total", "TCPStore verb calls", ("op",)),
        reg.counter("store_retries_total",
                    "extra attempts after transient failures", ("op",)),
        reg.counter("store_timeouts_total",
                    "operations that exhausted their retries", ("op",)),
        reg.histogram("store_op_seconds",
                      "TCPStore verb wall time incl. retries", ("op",)),
    )


_M_OPS, _M_RETRIES, _M_TIMEOUTS, _M_SECONDS = _store_metrics()

# full-jitter backoff RNG (per-process): during an elastic restart every
# rank hits the same failure at the same moment; bare exponential backoff
# re-synchronizes them into a thundering herd that re-overloads the master
# on every retry wave. Full jitter (sleep uniform in [0, cap]) decorrelates
# the waves while keeping the same expected growth.
_JITTER_RNG = random.Random()


def _full_jitter(cap: float) -> float:
    return _JITTER_RNG.uniform(0.0, max(0.0, cap))


class StoreTimeout(TimeoutError):
    """A store operation exhausted its retries; the message names the
    endpoint, operation, attempts, and elapsed time."""


class StoreCorruptValue(ValueError):
    """``get_json`` found a value that is not valid JSON (a half-written
    document, a raw-bytes key read as JSON, cross-writer corruption). The
    message names the key, the endpoint, and a prefix of the offending
    bytes. Callers for whom the value is *advisory* (e.g. the KV-fabric
    directory) catch this and treat the key as absent; callers for whom
    it is load-bearing let it propagate — it is never silently None,
    which would be indistinguishable from a missing key."""


class TCPStore:
    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 timeout=30.0, retries=4, backoff_s=0.05):
        lib = native.load()
        if lib is None:
            raise RuntimeError(
                "native runtime unavailable (no C++ toolchain?) — TCPStore "
                "needs csrc/tcp_store.cpp built")
        self._lib = lib
        self._server = None
        self.host = host
        self.retries = max(1, int(retries))
        self.backoff_s = float(backoff_s)
        self.num_retries = 0        # total extra attempts across all verbs
        if is_master:
            self._server = lib.ts_server_start(int(port))
            if not self._server:
                raise RuntimeError(f"TCPStore could not bind port {port}")
            self.port = lib.ts_server_port(self._server)
        else:
            self.port = int(port)
        self._fd = self._connect_with_retry(timeout)
        # ctypes releases the GIL: one in-flight request per connection, or
        # interleaved partial writes corrupt the wire protocol (heartbeat
        # threads share the store with the main thread)
        self._io_lock = locksan.Lock("tcp_store.io")

    # -- retry machinery ---------------------------------------------------
    def _connect_with_retry(self, timeout: float) -> int:
        """Dial the master, retrying with exponential backoff: during
        elastic bring-up the workers race the master's bind. The per-attempt
        budget splits ``timeout`` so total wall time stays bounded."""
        deadline = time.monotonic() + float(timeout)
        per_attempt_ms = max(1, int(timeout * 1000 / self.retries))
        t0 = time.monotonic()
        _M_OPS.labels(op="connect").inc()
        for attempt in range(self.retries):
            faults.inject("store.connect", host=self.host, port=self.port,
                          attempt=attempt)
            fd = self._lib.ts_connect(self.host.encode(), self.port,
                                      per_attempt_ms)
            if fd >= 0:
                _M_SECONDS.labels(op="connect").observe(
                    time.monotonic() - t0)
                return fd
            if attempt + 1 < self.retries:
                self.num_retries += 1
                _M_RETRIES.labels(op="connect").inc()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                time.sleep(min(_full_jitter(self.backoff_s * (2 ** attempt)),
                               remaining))
        _M_TIMEOUTS.labels(op="connect").inc()
        _M_SECONDS.labels(op="connect").observe(time.monotonic() - t0)
        err = StoreTimeout(
            f"TCPStore could not reach {self.host}:{self.port} after "
            f"{self.retries} connect attempts over "
            f"{time.monotonic() - t0:.1f}s")
        telemetry.record_event("store.timeout", op="connect",
                               endpoint=f"{self.host}:{self.port}",
                               attempts=self.retries)
        telemetry.dump(reason="TCPStore connect timeout", error=err)
        raise err

    def _retrying(self, op: str, attempt_fn, key: str | None = None):
        """Run ``attempt_fn()`` with retry + exponential backoff. The fn
        returns a value or raises; only RuntimeError/FaultError (transient
        wire failures) are retried — protocol-level negatives like a missing
        key are returned, not retried."""
        t0 = time.monotonic()
        last = None
        _M_OPS.labels(op=op).inc()
        try:
            for attempt in range(self.retries):
                try:
                    faults.inject(f"store.{op}", key=key, attempt=attempt)
                    return attempt_fn()
                except (RuntimeError, faults.FaultError) as e:
                    last = e
                    if attempt + 1 < self.retries:
                        self.num_retries += 1
                        _M_RETRIES.labels(op=op).inc()
                        time.sleep(_full_jitter(
                            self.backoff_s * (2 ** attempt)))
            _M_TIMEOUTS.labels(op=op).inc()
            err = StoreTimeout(
                f"TCPStore {op}({key!r}) against {self.host}:{self.port} "
                f"failed after {self.retries} attempts over "
                f"{time.monotonic() - t0:.1f}s: {last}")
            telemetry.record_event(
                "store.timeout", op=op, key=key,
                endpoint=f"{self.host}:{self.port}", attempts=self.retries)
            telemetry.dump(reason=f"TCPStore {op} timeout", error=err)
            raise err from last
        finally:
            _M_SECONDS.labels(op=op).observe(time.monotonic() - t0)

    # -- reference API -----------------------------------------------------
    def set(self, key: str, value):
        v = value if isinstance(value, bytes) else str(value).encode()
        k = key.encode()

        def attempt():
            with self._io_lock:
                r = self._lib.ts_set(self._fd, k, len(k), v, len(v))
            if r != 0:
                raise RuntimeError("wire error on set")

        return self._retrying("set", attempt, key)

    def get(self, key: str) -> bytes | None:
        k = key.encode()

        def attempt():
            cap = 1 << 20
            while True:
                buf = ctypes.create_string_buffer(cap)
                with self._io_lock:
                    n = self._lib.ts_get(self._fd, k, len(k), buf, cap)
                if n == -1:
                    return None          # key absent: a result, not an error
                if n <= -3:
                    cap = -n - 3  # buffer was too small; value drained — retry
                    continue
                if n < 0:
                    raise RuntimeError("wire error on get")
                return buf.raw[:n]

        return self._retrying("get", attempt, key)

    def set_json(self, key: str, obj) -> None:
        """``set`` with JSON encoding — the cluster observability plane
        (``telemetry.cluster``) publishes every document this way."""
        self.set(key, json.dumps(obj, default=str).encode())

    def get_json(self, key: str):
        """``get`` with JSON decoding; None when the key is absent.
        A present-but-undecodable value raises :class:`StoreCorruptValue`
        naming the key and endpoint (distinct from absence — a missing
        key is a result, a garbage value is a fault)."""
        raw = self.get(key)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            telemetry.record_event("store.corrupt_value", key=key,
                                   endpoint=f"{self.host}:{self.port}",
                                   nbytes=len(raw))
            raise StoreCorruptValue(
                f"TCPStore key {key!r} at {self.host}:{self.port} holds "
                f"{len(raw)} bytes that are not valid JSON "
                f"({raw[:64]!r}...): {e}") from e

    def add(self, key: str, amount: int = 1) -> int:
        k = key.encode()

        def attempt():
            with self._io_lock:
                out = self._lib.ts_add(self._fd, k, len(k), int(amount))
            if out == -(2 ** 63):
                raise RuntimeError("wire error on add")
            return int(out)

        return self._retrying("add", attempt, key)

    def wait(self, key: str, timeout=None) -> bool:
        k = key.encode()
        ms = -1 if timeout is None else int(timeout * 1000)

        def attempt():
            with self._io_lock:
                r = self._lib.ts_wait(self._fd, k, len(k), ms)
            if r < 0:
                raise RuntimeError("wire error on wait")
            return bool(r)

        return self._retrying("wait", attempt, key)

    def delete_key(self, key: str) -> bool:
        k = key.encode()
        with self._io_lock:
            r = self._lib.ts_delete(self._fd, k, len(k))
        return bool(r)

    def barrier(self, name: str, world_size: int, timeout=60.0):
        """All `world_size` callers block until everyone arrived. Reusable:
        arrival counts define generations, each with its own done key."""
        n = self.add(f"__barrier/{name}", 1)
        gen = (n - 1) // world_size
        if n == (gen + 1) * world_size:  # last arrival of this generation
            self.set(f"__barrier/{name}/done/{gen}", b"1")
        ok = self.wait(f"__barrier/{name}/done/{gen}", timeout)
        if not ok:
            raise StoreTimeout(
                f"barrier '{name}' timed out after {timeout}s at "
                f"{n}/{world_size} arrivals (endpoint "
                f"{self.host}:{self.port})")

    def close(self):
        if self._fd >= 0:
            self._lib.ts_close(self._fd)
            self._fd = -1
        if self._server:
            self._lib.ts_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # lint: allow-silent(interpreter-teardown close; nothing to report to)
            pass
