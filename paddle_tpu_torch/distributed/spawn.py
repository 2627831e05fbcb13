"""``paddle.distributed.spawn`` (counterpart of
``paddle_tpu/distributed/spawn.py``): start ``nprocs`` processes running
``func(*args)``, one rank each.

Each process gets the launch CLI's environment contract:
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` / ``PADDLE_LOCAL_RANK``,
the coordinator (``PADDLE_MASTER``, ``host:port``; or
``PADDLE_DIST_INIT_METHOD`` when ``init_method=`` names a
``torch.distributed`` URL such as ``file:///tmp/x``), the backend
(``PADDLE_DISTRI_BACKEND``) and, when ``device="cpu"``, ``PADDLE_DEVICE``.
``func`` then calls ``init_parallel_env()``, which joins the group.

A child that raises is reported with its traceback: :meth:`join` raises
``RuntimeError`` naming the rank and stops the others (which would hang
waiting for it). ``join(timeout)`` returns False while children run;
``spawn(..., join_timeout=s)`` instead kills every child after ``s``
seconds and raises ``TimeoutError``, so a hung group fails its caller
rather than hanging it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import socket
import sys
import time
import traceback

__all__ = ["spawn", "MultiprocessContext"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(func, rank, args, env, return_queue, error_queue):
    os.environ.update(env)
    try:
        ret = func(*args)
        # plain pickle bytes: a tensor put on the queue as it is would be
        # shared by a file descriptor that dies with this process
        return_queue.put((rank, pickle.dumps(ret)))
    except KeyboardInterrupt:
        pass
    except BaseException:  # lint: allow-silent(the traceback goes to the parent, which raises it)
        error_queue.put((rank, traceback.format_exc()))
        sys.exit(1)


class MultiprocessContext:
    """Handle over the spawned ranks (Paddle's MultiprocessContext)."""

    def __init__(self, processes, return_queue, error_queue):
        self.processes = processes
        self._return_queue = return_queue
        self._error_queue = error_queue
        self.returns: dict[int, object] = {}

    def _drain_returns(self):
        while True:
            try:
                rank, ret = self._return_queue.get_nowait()
            except queue.Empty:
                return
            self.returns[rank] = pickle.loads(ret)

    def terminate(self):
        """Stop every child still running (SIGTERM, then SIGKILL)."""
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for p in self.processes:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)

    def join(self, timeout=None, poll_s=0.05):
        """Wait for the children. Raises ``RuntimeError`` with the first
        failed child's traceback (or exit code), stopping the rest; returns
        False if children still run after ``timeout`` seconds, True once
        all exited 0."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._drain_returns()
            try:
                rank, tb = self._error_queue.get_nowait()
            except queue.Empty:
                rank = None
            if rank is not None:
                self.terminate()
                raise RuntimeError(f"spawned process {rank} failed:\n{tb}")
            dead = [p for p in self.processes
                    if not p.is_alive() and p.exitcode not in (0, None)]
            if dead:
                time.sleep(0.2)          # its traceback may be in flight
                try:
                    rank, tb = self._error_queue.get_nowait()
                    detail = f"spawned process {rank} failed:\n{tb}"
                except queue.Empty:
                    detail = (f"spawned process {dead[0].name} exited with "
                              f"{dead[0].exitcode}")
                self.terminate()
                raise RuntimeError(detail)
            if all(not p.is_alive() for p in self.processes):
                self._drain_returns()
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` processes running ``func(*args)``.

    options: ``start_method`` (``"spawn"``, the CUDA-safe default),
    ``backend`` (``"nccl"``, ``"gloo"``; default ``"auto"``: NCCL on the
    card, gloo on the CPU), ``device`` (``"cpu"`` to run the ranks on the
    CPU), ``init_method`` (a ``torch.distributed`` URL; default a free
    local TCP port), ``env`` (extra environment for the children) and
    ``join_timeout`` (seconds; kill the children and raise
    ``TimeoutError`` when they run longer). ``nprocs=-1``: one per
    visible card."""
    if nprocs == -1:
        import torch

        nprocs = (int(os.environ.get("PADDLE_NUM_DEVICES", "0"))
                  or torch.cuda.device_count())
        if nprocs < 1:
            raise RuntimeError("spawn(nprocs=-1) found no CUDA device; pass "
                               "nprocs and device='cpu' to run on the CPU")
    ctx = mp.get_context(options.get("start_method", "spawn"))
    return_queue = ctx.Queue()
    error_queue = ctx.Queue()
    base_env = {
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_TPU_NUM_PROCESSES": str(nprocs),
        "PADDLE_DISTRI_BACKEND": str(options.get("backend", "auto")),
    }
    if options.get("init_method"):
        base_env["PADDLE_DIST_INIT_METHOD"] = options["init_method"]
    else:
        master = options.get("coordinator", f"127.0.0.1:{_free_port()}")
        base_env["PADDLE_MASTER"] = master
        base_env["PADDLE_TPU_COORDINATOR"] = master
    if options.get("device"):
        base_env["PADDLE_DEVICE"] = str(options["device"])
    base_env.update(options.get("env", {}))

    processes = []
    for rank in range(nprocs):
        env = dict(base_env)
        env.update({"PADDLE_TRAINER_ID": str(rank),
                    "PADDLE_TPU_PROCESS_ID": str(rank),
                    "PADDLE_LOCAL_RANK": str(rank), "LOCAL_RANK": str(rank)})
        p = ctx.Process(
            target=_worker,
            args=(func, rank, tuple(args), env, return_queue, error_queue),
            daemon=daemon, name=f"paddle-spawn-{rank}")
        p.start()
        processes.append(p)

    context = MultiprocessContext(processes, return_queue, error_queue)
    if join:
        timeout = options.get("join_timeout")
        if not context.join(timeout):
            context.terminate()
            raise TimeoutError(
                f"spawned processes still running after {timeout}s; "
                f"killed them")
    return context
