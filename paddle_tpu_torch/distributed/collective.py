"""Eager collectives over the mesh's groups (counterpart of
``paddle_tpu/distributed/collective.py``; Paddle's
``paddle.distributed.{all_reduce, all_gather, ...}``).

The reference is single-controller: a "distributed tensor" there is one
array sharded over a mesh axis, and each verb is a ``shard_map`` over that
axis. Here each rank holds its own shard and each verb is the
``torch.distributed`` collective over the axis's process group, with the
reference's semantics per rank: rank ``r`` of a group passes what the
reference's shard ``r`` holds and gets what shard ``r`` ends up holding.
``src`` / ``dst`` are ranks within the group, as the reference indexes
the axis.

Every verb runs through one guarded wrapper: the fault site
``collective.<op>``, the telemetry (``collective_*`` families, the
``collective.launch`` event, the cluster heartbeat
``telemetry.cluster.collective_enter`` / ``collective_exit``, the step
timeline's "collective" phase) and, when ``FLAGS_collective_timeout_s``
is above 0, a timeout that raises :class:`CollectiveTimeoutError` naming
the op, the group and the rank. A group of one rank issues no collective
(GSPMD emits none for an axis of size 1). The layer never copies a tensor
to the host to get round a backend: what the backend refuses raises.
"""
from __future__ import annotations

import threading
import time

import torch
import torch.distributed as dist

from .. import telemetry
from ..core.tensor import plain, wrap
from ..framework.flags import flag_value
from ..telemetry import cluster as _cluster
from ..telemetry import perf as _perf
from ..utils import faults

__all__ = [
    "ReduceOp", "all_reduce", "all_gather", "reduce_scatter", "broadcast",
    "all_to_all", "alltoall", "reduce", "scatter", "barrier", "send", "recv",
    "ppermute", "shard_to_group", "unshard", "new_group", "get_group",
    "Group", "OneRank", "CollectiveTimeoutError",
]


class CollectiveTimeoutError(TimeoutError):
    """A guarded collective did not complete within
    ``FLAGS_collective_timeout_s``; the message names the op, the group
    axis, its size and this process's rank."""


def _collective_metrics():
    reg = telemetry.registry()
    return (
        reg.counter("collective_calls_total",
                    "eager collective launches", ("op",)),
        reg.counter("collective_bytes_total",
                    "input bytes entering eager collectives", ("op",)),
        reg.counter("collective_timeouts_total",
                    "collectives killed by the timeout guard", ("op",)),
        reg.histogram("collective_seconds",
                      "wall time of one eager collective", ("op",)),
    )


_M_CALLS, _M_BYTES, _M_TIMEOUTS, _M_SECONDS = _collective_metrics()


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


# AVG is SUM then a division: gloo has no AVG
_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A process group with the mesh axis it spans (Paddle's ProcessGroup
    handle): ``nranks``, this process's ``rank`` in it and the global
    ``ranks``."""

    def __init__(self, pg=None, axis=None):
        self.pg = pg if pg is not None else dist.group.WORLD
        self.axis = axis

    @property
    def nranks(self):
        return dist.get_world_size(self.pg)

    world_size = nranks

    @property
    def rank(self):
        return dist.get_rank(self.pg)

    @property
    def ranks(self):
        return dist.get_process_group_ranks(self.pg)

    def global_rank(self, group_rank):
        return dist.get_global_rank(self.pg, group_rank)

    def __repr__(self):
        return f"Group(axis={self.axis}, nranks={self.nranks})"


class OneRank(Group):
    """A group of this process alone, with no process group behind it
    (a mesh-less trainer's axes): every verb over it returns at once."""

    def __init__(self, axis=None):
        self.pg, self.axis = None, axis

    nranks = world_size = 1
    rank = 0

    @property
    def ranks(self):
        return [0]


_custom_groups: dict[int, Group] = {}


def _resolve_group(group) -> Group:
    from .mesh import get_hybrid_communicate_group

    if isinstance(group, Group):
        return group
    if not dist.is_initialized():
        raise RuntimeError("call paddle_tpu_torch.distributed."
                           "init_parallel_env() or fleet.init() first")
    hcg = get_hybrid_communicate_group()
    if isinstance(group, str):
        if hcg is None:
            raise RuntimeError(f"group axis {group!r} needs a hybrid mesh "
                               f"(init_parallel_env / fleet.init)")
        return hcg.group(group)
    if group is None:
        if hcg is None:
            return Group(None, None)
        # the reference's default: the first axis of more than one rank
        for axis, n in hcg.topology().items():
            if n > 1:
                return hcg.group(axis)
        return hcg.group(hcg.mesh.mesh_dim_names[0])
    if isinstance(group, dist.ProcessGroup):
        return Group(group, None)
    raise TypeError(f"bad group {group!r}")


def new_group(ranks=None, axis=None, backend=None, timeout=None):
    """A group over ``ranks`` (global ranks; every rank must call it, as
    ``torch.distributed.new_group`` requires), or the group of mesh axis
    ``axis``. Registered under the next id for :func:`get_group`."""
    if axis is not None or ranks is None:
        g = _resolve_group(axis)
    else:
        kw = {} if timeout is None else {"timeout": timeout}
        g = Group(dist.new_group(list(ranks), backend=backend, **kw), None)
    _custom_groups[len(_custom_groups)] = g
    return g


def get_group(gid=0):
    return _custom_groups.get(gid)


def _rank_of(g: Group) -> int:
    try:
        return g.rank
    except Exception:  # lint: allow-silent(no group membership; the world rank names the process)
        return dist.get_rank()


def _guarded(g: Group, op: str, nbytes: int, invoke):
    """Run ``invoke`` as collective ``op`` over ``g``: fault site,
    telemetry, heartbeat and the timeout guard."""
    def run():
        faults.inject(f"collective.{op}", axis=g.axis)
        return invoke()

    telemetry.record_event("collective.launch", op=op, axis=g.axis,
                           nranks=g.nranks, bytes=nbytes)
    _M_CALLS.labels(op=op).inc()
    _M_BYTES.labels(op=op).inc(nbytes)
    timeout = float(flag_value("FLAGS_collective_timeout_s") or 0.0)
    t0 = time.monotonic()
    _cluster.collective_enter(op, axis=g.axis, nranks=g.nranks)
    try:
        if timeout <= 0:
            return run()
        return _guard_timeout(run, op, g, timeout)
    except CollectiveTimeoutError as e:
        _M_TIMEOUTS.labels(op=op).inc()
        telemetry.record_event("collective.timeout", op=op, axis=g.axis,
                               nranks=g.nranks, rank=_rank_of(g),
                               timeout_s=timeout)
        telemetry.dump(reason=f"collective timeout: {op}", error=e)
        _cluster.trigger_postmortem(f"collective timeout: {op} "
                                    f"(rank {_rank_of(g)})")
        raise
    finally:
        _cluster.collective_exit(op)
        dt = time.monotonic() - t0
        _M_SECONDS.labels(op=op).observe(dt)
        _perf.note_phase("collective", dt)


# the calls still running after their guard gave up, so a caller can
# join them before it issues the next collective (collectives must keep
# their order on every rank)
_STRAGGLERS: list = []


def _guard_timeout(invoke, op: str, g: Group, timeout: float):
    """Run the collective on a worker thread and bound the wait; a stuck
    peer becomes a :class:`CollectiveTimeoutError` instead of a silent
    hang. The call itself cannot be cancelled: it runs on (see
    :func:`join_stragglers`) or the process is torn down."""
    result: list = [None]
    error: list = [None]
    done = threading.Event()

    def target():
        try:
            result[0] = invoke()
        except BaseException as e:  # lint: allow-silent(error re-raised on the caller thread)
            error[0] = e
        finally:
            done.set()

    t = threading.Thread(target=target, daemon=True, name=f"collective-{op}")
    t.start()
    if not done.wait(timeout):
        _STRAGGLERS.append(t)
        raise CollectiveTimeoutError(
            f"collective '{op}' over group axis '{g.axis}' "
            f"(nranks={g.nranks}, rank={_rank_of(g)}) did not complete "
            f"within {timeout}s — a peer is stuck or the interconnect is "
            f"wedged; the in-flight call cannot be cancelled")
    if error[0] is not None:
        raise error[0]
    return result[0]


def join_stragglers(timeout=None):
    """Wait for the collectives whose guard timed out; True when none is
    left running."""
    for t in list(_STRAGGLERS):
        t.join(timeout)
        if not t.is_alive():
            _STRAGGLERS.remove(t)
    return not _STRAGGLERS


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place; returns it."""
    g = _resolve_group(group)
    if op not in _TORCH_OP:
        raise ValueError(f"unsupported reduce op: {op!r}")
    if g.nranks == 1:
        return tensor
    t = plain(tensor)

    def invoke():
        dist.all_reduce(t, op=_TORCH_OP[op], group=g.pg)
        if op == ReduceOp.AVG:
            t.div_(g.nranks)

    _guarded(g, "all_reduce", _nbytes(t), invoke)
    return tensor


def all_gather(tensor_list, tensor=None, group=None, sync_op=True, axis=0):
    """Two call shapes, as the reference's: ``all_gather(out_list, x)``
    extends ``out_list`` with every rank's ``x`` in rank order, and
    ``all_gather(x)`` returns them concatenated along ``axis``."""
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    g = _resolve_group(group)
    t = plain(tensor)
    if g.nranks == 1:
        parts = [t.clone()]
    else:
        parts = [torch.empty_like(t) for _ in range(g.nranks)]
        _guarded(g, "all_gather", _nbytes(t),
                 lambda: dist.all_gather(parts, t.contiguous(), group=g.pg))
    if tensor_list is not None:
        tensor_list.extend(wrap(p) for p in parts)
        return tensor_list
    return wrap(torch.cat(parts, dim=axis))


def reduce_scatter(tensor, tensor_or_op=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """``reduce_scatter(x)``: ``x`` is ``[n * k, ...]`` on every rank; rank
    ``r`` gets ``[k, ...]``, the reduction of every rank's ``r``-th block
    (returned). Paddle's ``reduce_scatter(out, in_list_or_tensor)``
    writes that into ``out``."""
    g = _resolve_group(group)
    out = None
    if isinstance(tensor_or_op, (torch.Tensor, list, tuple)):
        out, src = tensor, tensor_or_op
        if isinstance(src, (list, tuple)):
            src = torch.cat([plain(s) for s in src])
    else:
        if isinstance(tensor_or_op, str):
            op = tensor_or_op
        src = tensor
    x = plain(src).contiguous()
    n = g.nranks
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not "
                         f"split over {n} ranks")
    res = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if n == 1:
        res.copy_(x)
    else:
        def invoke():
            dist.reduce_scatter_tensor(res, x, op=_TORCH_OP[op], group=g.pg)
            if op == ReduceOp.AVG:
                res.div_(n)

        _guarded(g, "reduce_scatter", _nbytes(x), invoke)
    if out is not None:
        plain(out).copy_(res)
        return out
    return wrap(res)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Every rank's ``tensor`` becomes group rank ``src``'s (in place)."""
    g = _resolve_group(group)
    if g.nranks == 1:
        return tensor
    t = plain(tensor)
    _guarded(g, "broadcast", _nbytes(t),
             lambda: dist.broadcast(t, src=g.global_rank(src), group=g.pg))
    return tensor


def all_to_all(out_tensor_list, in_tensor_list=None, group=None,
               sync_op=True):
    """Two call shapes. ``all_to_all(x)``: ``x`` is ``[n * k, ...]``; block
    ``j`` goes to rank ``j``, and the result's block ``j`` came from rank
    ``j`` (MoE dispatch). ``all_to_all(out_list, in_list)``: rank ``i``
    sends ``in_list[j]`` to rank ``j``; ``out_list`` is filled with what
    each rank sent here, in rank order."""
    g = _resolve_group(group)
    n = g.nranks
    if in_tensor_list is None:
        x = plain(out_tensor_list).contiguous()
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) does not "
                             f"split over {n} ranks")
        out = torch.empty_like(x)
        if n == 1:
            out.copy_(x)
        else:
            _guarded(g, "all_to_all", _nbytes(x),
                     lambda: dist.all_to_all_single(out, x, group=g.pg))
        return wrap(out)
    if len(in_tensor_list) != n:
        raise ValueError(f"in_tensor_list must have {n} entries, got "
                         f"{len(in_tensor_list)}")
    ins = [plain(t).contiguous() for t in in_tensor_list]
    outs = [torch.empty_like(t) for t in ins]
    if n == 1:
        outs[0].copy_(ins[0])
    else:
        x = torch.cat([t.reshape(-1) for t in ins])
        y = torch.empty_like(x)
        _guarded(g, "all_to_all", _nbytes(x),
                 lambda: dist.all_to_all_single(y, x, group=g.pg))
        for o, part in zip(outs, y.split([t.numel() for t in ins])):
            o.copy_(part.view_as(o))
    out_tensor_list.clear()
    out_tensor_list.extend(wrap(o) for o in outs)
    return out_tensor_list


alltoall = all_to_all


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Group rank ``dst`` gets the reduction (in place); every other
    rank's ``tensor`` is left as it was, as in the reference."""
    g = _resolve_group(group)
    if op not in _TORCH_OP:
        raise ValueError(f"unsupported reduce op: {op!r}")
    if g.nranks == 1:
        return tensor
    t = plain(tensor)
    buf = t.clone()

    def invoke():
        dist.reduce(buf, dst=g.global_rank(dst), op=_TORCH_OP[op],
                    group=g.pg)

    _guarded(g, "reduce", _nbytes(t), invoke)
    if g.rank == dst:
        if op == ReduceOp.AVG:
            buf.div_(g.nranks)
        t.copy_(buf)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``r`` receives entry ``r`` of group rank ``src``'s
    ``tensor_list`` into ``tensor`` (the other ranks' lists are not
    read). With no list anywhere, ``tensor`` is returned as it is."""
    g = _resolve_group(group)
    n = g.nranks
    t = plain(tensor)
    if g.rank == src and tensor_list is not None and len(tensor_list) != n:
        raise ValueError(
            f"scatter needs one entry per rank ({n}), got {len(tensor_list)}")
    if n == 1:
        if tensor_list is not None:
            t.copy_(plain(tensor_list[0]))
        return tensor
    if tensor_list is None and g.rank == src:
        raise ValueError("scatter: the src rank must pass tensor_list")
    parts = ([plain(p).contiguous() for p in tensor_list]
             if g.rank == src else None)
    _guarded(g, "scatter", _nbytes(t),
             lambda: dist.scatter(t, parts, src=g.global_rank(src),
                                  group=g.pg))
    return tensor


def barrier(group=None):
    """Block until every rank of the group reaches the barrier; with no
    group, every process (the reference's barrier is global, not the
    default axis of the other verbs)."""
    if not dist.is_initialized():
        return None
    g = Group(None, "world") if group is None else _resolve_group(group)
    if g.nranks > 1:
        _guarded(g, "barrier", 0, lambda: dist.barrier(group=g.pg))
    return None


def ppermute(tensor, perm, group=None):
    """``jax.lax.ppermute`` over the group: ``perm`` is ``[(src, dst),
    ...]`` in group ranks; each rank returns what its source sent, or
    zeros where no pair names it as a destination."""
    g = _resolve_group(group)
    t = plain(tensor).contiguous()
    me = g.rank
    out = torch.zeros_like(t)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(t)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, t, g.global_rank(d), g.pg))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, g.global_rank(s), g.pg))
    if ops:
        def invoke():
            for w in dist.batch_isend_irecv(ops):
                w.wait()

        _guarded(g, "ppermute", _nbytes(t), invoke)
    return wrap(out)


def send(tensor, dst=0, group=None, sync_op=True, tag=0):
    """Point-to-point send to group rank ``dst``; ``sync_op=False``
    returns the pending work (``.wait()`` it before reusing ``tensor``)."""
    g = _resolve_group(group)
    t = plain(tensor).contiguous()
    if not sync_op:
        return _guarded(g, "send", _nbytes(t),
                        lambda: dist.isend(t, dst=g.global_rank(dst),
                                           group=g.pg, tag=tag))
    _guarded(g, "send", _nbytes(t),
             lambda: dist.send(t, dst=g.global_rank(dst), group=g.pg,
                               tag=tag))
    return None


def recv(tensor, src=0, group=None, sync_op=True, tag=0):
    """Receive into ``tensor`` from group rank ``src``; returns it."""
    g = _resolve_group(group)
    t = plain(tensor)
    _guarded(g, "recv", _nbytes(t),
             lambda: dist.recv(t, src=g.global_rank(src), group=g.pg,
                               tag=tag))
    return tensor


def shard_to_group(host_batches, group=None, shard_dim=0):
    """This rank's entry of a list of per-rank arrays, as a tensor on its
    device (the reference places the whole list sharded over the axis;
    each rank here holds its own shard)."""
    import numpy as np

    from .parallel import env_device

    g = _resolve_group(group)
    return wrap(torch.as_tensor(np.asarray(host_batches[g.rank]),
                                device=env_device()).clone())


def unshard(t):
    """This rank's shard as a host numpy array."""
    return plain(t).detach().cpu().numpy()
