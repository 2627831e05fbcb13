"""Launcher implementation: environment layout, worker start, watch,
restart.

Every worker gets the environment ``init_parallel_env`` reads:
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` / ``PADDLE_LOCAL_RANK`` /
``PADDLE_RANK_IN_NODE``, the coordinator ``PADDLE_MASTER`` (also as
``PADDLE_TPU_COORDINATOR``), ``PADDLE_RESTART_ATTEMPT`` (the incarnation,
so a script resumes from its checkpoint), ``PADDLE_DISTRI_BACKEND`` and,
for ``--backend cpu``, ``PADDLE_DEVICE=cpu`` (gloo on the CPU). The
watcher aborts the pod at the first failed worker (every failure of the
sweep is counted) and, within ``--max_restarts``, starts it again after an
exponential backoff on a fresh coordinator port.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from ..spawn import _free_port

__all__ = ["launch", "main"]


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch N training processes with the distributed "
                    "environment set (paddle.distributed.launch).")
    p.add_argument("--nnodes", type=int, default=1,
                   help="number of nodes (this CLI drives one)")
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes on this node")
    p.add_argument("--master", default=None,
                   help="coordinator host:port (default: local free port)")
    p.add_argument("--log_dir", default="log",
                   help="per-rank worker logs directory (workerlog.N)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="restart the whole pod up to K times when any "
                        "worker fails")
    p.add_argument("--restart_backoff", type=float, default=0.5,
                   help="initial delay before a pod relaunch; doubles per "
                        "attempt")
    p.add_argument("--restart_backoff_max", type=float, default=30.0,
                   help="backoff ceiling in seconds")
    p.add_argument("--devices", default=None,
                   help="comma list of cards, set as CUDA_VISIBLE_DEVICES")
    p.add_argument("--backend", choices=["auto", "nccl", "gloo", "cpu"],
                   default="auto",
                   help="auto: NCCL on the cards; gloo: gloo with CUDA "
                        "tensors; cpu: gloo on the CPU (the workers run "
                        "there)")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _worker_env(args, master, local_rank, attempt=0):
    world = args.nnodes * args.nproc_per_node
    rank = args.node_rank * args.nproc_per_node + local_rank
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TPU_PROCESS_ID": str(rank),
        "PADDLE_TPU_NUM_PROCESSES": str(world),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_RANK_IN_NODE": str(local_rank),
        "LOCAL_RANK": str(local_rank),
        "PADDLE_MASTER": master,
        "PADDLE_TPU_COORDINATOR": master,
        "PADDLE_RESTART_ATTEMPT": str(attempt),
        "PADDLE_DISTRI_BACKEND": ("gloo" if args.backend == "cpu"
                                  else args.backend),
    })
    if args.backend == "cpu":
        env["PADDLE_DEVICE"] = "cpu"
    if args.devices:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    return env


def _spawn(args, master, attempt):
    os.makedirs(args.log_dir, exist_ok=True)
    procs = []
    for lr in range(args.nproc_per_node):
        rank = args.node_rank * args.nproc_per_node + lr
        logf = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
        cmd = [sys.executable, args.training_script] + \
            args.training_script_args
        proc = subprocess.Popen(cmd, env=_worker_env(args, master, lr,
                                                     attempt),
                                stdout=logf, stderr=subprocess.STDOUT)
        procs.append((proc, logf, rank))
    return procs


def _stop(procs):
    for p, _, _ in procs:
        if p.poll() is None:
            p.terminate()
    for p, f, _ in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if not f.closed:
            f.close()


def _watch(procs, poll_s=0.2):
    """The watcher: the first failure aborts the pod. Returns (rc,
    failed ranks, interrupted); rc 0 only if every worker exits 0."""
    try:
        while procs:
            alive, failed = [], []
            for proc, logf, rank in procs:
                rc = proc.poll()
                if rc is None:
                    alive.append((proc, logf, rank))
                elif rc != 0:
                    failed.append((rank, rc))
                else:
                    logf.close()
            if failed:
                for rank, rc in failed:
                    sys.stderr.write(
                        f"[launch] rank {rank} failed with exit {rc}; "
                        f"aborting pod (see workerlog.{rank})\n")
                _stop(procs)
                return failed[0][1], [r for r, _ in failed], False
            procs = alive
            if procs:
                time.sleep(poll_s)
        return 0, [], False
    except KeyboardInterrupt:
        for proc, _, _ in procs:
            proc.send_signal(signal.SIGINT)
        _stop(procs)
        return 130, [], True


def launch(argv):
    args = _parse(argv)
    master = args.master or f"127.0.0.1:{_free_port()}"
    attempt = 0
    while True:
        rc, dead, interrupted = _watch(_spawn(args, master, attempt))
        if rc == 0 or interrupted:
            return rc
        if attempt >= args.max_restarts:
            sys.stderr.write(f"[launch] restart budget ({args.max_restarts})"
                             f" spent; giving up\n")
            return rc
        attempt += 1
        backoff = min(args.restart_backoff * 2 ** (attempt - 1),
                      args.restart_backoff_max)
        sys.stderr.write(
            f"[launch] restarting pod (attempt {attempt}/"
            f"{args.max_restarts}, ranks {dead} failed) after "
            f"{backoff:.1f}s backoff\n")
        time.sleep(backoff)
        if args.master is None:
            # a fresh port: the dead pod's store may still hold the old one
            master = f"127.0.0.1:{_free_port()}"


def main():
    return launch(sys.argv[1:])
