"""init_parallel_env, rank queries and DataParallel (counterpart of
``paddle_tpu/distributed/parallel.py``).

The reference runs ``jax.distributed.initialize`` and builds one mesh over
every device. Here each rank is a process: :func:`init_parallel_env`
reads the launch / spawn environment (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK`` and the coordinator,
``PADDLE_MASTER`` / ``PADDLE_TPU_COORDINATOR`` as ``host:port``, or
``PADDLE_DIST_INIT_METHOD`` as a ``torch.distributed`` init URL such as
``file:///path``), joins the default process group and builds the hybrid
mesh (``mesh.HybridCommunicateGroup``).

Backends: NCCL on ``cuda:{local_rank % device_count()}`` by default; gloo
on the CPU only when the caller asks for the CPU (``device="cpu"`` or
``set_device("cpu")`` first); gloo with CUDA tensors only when the caller
names ``backend="gloo"``. No GPU, or no NCCL, raises: nothing moves to
gloo or to the CPU quietly. A world of one joins a group of one through
an in-process store and issues no collective.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..core.device import resolve_device, set_device
from ..nn.layer import Layer
from .mesh import (HybridCommunicateGroup, build_mesh,
                   get_hybrid_communicate_group,
                   set_hybrid_communicate_group)
from .strategy import DistributedStrategy

__all__ = [
    "init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
    "DataParallel", "env_device",
]

_env = {"device": None, "backend": None}


def _env_int(*names, default=0):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _init_method():
    url = os.environ.get("PADDLE_DIST_INIT_METHOD")
    if url:
        return url
    master = (os.environ.get("PADDLE_MASTER")
              or os.environ.get("PADDLE_TPU_COORDINATOR"))
    return f"tcp://{master}" if master else None


def env_device() -> torch.device:
    """This rank's device: what :func:`init_parallel_env` chose, else the
    default device (``core.resolve_device``)."""
    return _env["device"] or resolve_device(None)


def init_parallel_env(strategy: DistributedStrategy | None = None,
                      backend: str | None = None, device=None,
                      timeout_s: float = 300.0):
    """Join the process group of the launch/spawn environment and install
    the hybrid mesh (pure data parallel over the world unless ``strategy``
    says otherwise). Idempotent: a second call only rebuilds a mesh that
    was torn down (``set_hybrid_communicate_group(None)``).

    backend: ``None`` (NCCL for ``cuda``, gloo for ``cpu``), or
    ``"nccl"`` / ``"gloo"`` by name (``PADDLE_DISTRI_BACKEND`` in the
    environment, ``"auto"`` meaning ``None``).
    device:  ``None`` (the card of this rank; raises without one) or
    ``"cpu"``."""
    if not dist.is_initialized():
        rank = _env_int("PADDLE_TRAINER_ID", "PADDLE_TPU_PROCESS_ID")
        world = _env_int("PADDLE_TRAINERS_NUM", "PADDLE_TPU_NUM_PROCESSES",
                         default=1)
        local = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=rank)
        # spawn(device="cpu") / launch --backend cpu: the caller's request
        dev = resolve_device(device or os.environ.get("PADDLE_DEVICE")
                             or None)
        if dev.type == "cuda":
            dev = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            torch.cuda.init()    # so the DeviceMesh keeps this device
        if backend is None:
            backend = os.environ.get("PADDLE_DISTRI_BACKEND") or "auto"
        if backend == "auto":
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl" and (dev.type != "cuda"
                                  or not dist.is_nccl_available()):
            raise RuntimeError(
                f"backend 'nccl' needs a CUDA device and a torch built with "
                f"NCCL (device {dev}, nccl available: "
                f"{dist.is_nccl_available()}); pass device='cpu' for gloo "
                f"on the CPU")
        timeout = datetime.timedelta(seconds=timeout_s)
        url = _init_method()
        if world == 1 and url is None:
            # a world of one: an in-process store, no port, no file
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout)
        else:
            if url is None:
                raise RuntimeError(
                    f"a world of {world} ranks needs a coordinator: set "
                    f"PADDLE_MASTER (host:port) or PADDLE_DIST_INIT_METHOD "
                    f"(spawn and launch set them)")
            dist.init_process_group(backend, init_method=url, rank=rank,
                                    world_size=world, timeout=timeout)
        _env["device"], _env["backend"] = dev, backend
        set_device(dev)
    if strategy is None:
        if get_hybrid_communicate_group() is not None:
            return ParallelEnv()
        strategy = DistributedStrategy()
        strategy.hybrid_configs.dp_degree = dist.get_world_size()
    set_hybrid_communicate_group(
        HybridCommunicateGroup(strategy, build_mesh(strategy)))
    return ParallelEnv()


def _pg(group):
    return getattr(group, "pg", group)


def get_rank(group=None):
    """This process's rank in ``group`` (default: the world); the launch
    environment's rank before the group is joined."""
    if not dist.is_initialized():
        return _env_int("PADDLE_TRAINER_ID", "PADDLE_TPU_PROCESS_ID")
    return dist.get_rank(_pg(group))


def get_world_size(group=None):
    if not dist.is_initialized():
        return _env_int("PADDLE_TRAINERS_NUM", "PADDLE_TPU_NUM_PROCESSES",
                        default=1)
    return dist.get_world_size(_pg(group))


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=get_rank())

    @property
    def device_id(self):
        dev = env_device()
        return (dev.index or 0) if dev.type == "cuda" else 0

    nranks = world_size
    dev_id = device_id


class DataParallel(Layer):
    """``paddle.DataParallel``: the wrapped layer's gradients are averaged
    over the data-parallel group. Each parameter's gradient is all-reduced
    (mean) as soon as backward has accumulated it (the reference's
    EagerReducer, without buckets); :meth:`no_sync` defers that, and
    :meth:`apply_collective_grads` averages whatever gradients there are.
    A group of one does nothing."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        from .collective import _resolve_group

        self._layers = layers
        hcg = get_hybrid_communicate_group()
        if group is None and hcg is not None:
            group = hcg.data_group()
        self._group = _resolve_group(group)
        self._sync = True
        self._hooks = []
        if self._group.nranks > 1:
            for p in layers.parameters():
                if p.requires_grad:
                    self._hooks.append(
                        p.register_post_accumulate_grad_hook(self._reduce))

    def _reduce(self, p):
        from . import collective

        if self._sync and p.grad is not None:
            collective.all_reduce(p.grad, op=collective.ReduceOp.AVG,
                                  group=self._group)

    def no_sync(self):
        """Context: gradients accumulate locally (no all-reduce) inside."""
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self._sync = False
            try:
                yield
            finally:
                self._sync = True

        return ctx()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)

    @property
    def parameters_layer(self):
        return self._layers

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        from . import collective

        for p in self._layers.parameters():
            if p.grad is not None:
                collective.all_reduce(p.grad, op=collective.ReduceOp.AVG,
                                      group=self._group)
