"""DistributedEngine: one training step over the hybrid mesh from
(layer, loss, optimizer, strategy) (counterpart of
``paddle_tpu/distributed/engine.py``).

The reference jits one SPMD step and lets GSPMD place every collective.
Here each rank runs its part of the step eagerly:

- the batch splits over the data ranks (dp x sharding, dp outer, as the
  reference's ``("dp", "sharding")`` batch axes); each rank runs the
  layer (whose tensor-parallel layers hold their mp shards and call their
  own collectives) on its rows;
- gradients are averaged over the data ranks (the mean over the global
  batch, however it splits);
- ZeRO over the ``sharding`` axis, by the reference's policy
  (``_param_specs`` / ``_opt_specs`` / ``shard_params_for_zero``): each
  parameter's first local dim that the degree divides is split; stage 1
  keeps only this rank's slice of the optimizer moments and updates only
  that slice (all-gathered back into the parameter), stage 2 also
  reduce-scatters the gradients so only the slice is kept, stage 3 also
  keeps only the parameter's slice between steps (all-gathered for the
  forward and backward, then released);
- ``offload``: the moments and an f32 copy of the parameter slice live
  in (pinned) host memory and the update runs there; the new slice is
  copied back to the card.

Gradient accumulation (``gradient_merge_steps``: inputs with a leading
micro-batch dim), the guarded step, eval, predict and the sharded
checkpoint (``checkpoint.DistributedSaver``) follow the reference's
methods. Per-rank optimizer bytes are 1/degree of the whole under ZeRO
(:func:`state_bytes_by_device`).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.tensor import plain, raw_grad
from .checkpoint import Placement, restore_local
from .mesh import (HybridCommunicateGroup, build_mesh,
                   get_hybrid_communicate_group,
                   set_hybrid_communicate_group)
from .strategy import DistributedStrategy

__all__ = ["DistributedEngine", "ShardedUpdate", "shard_params_for_zero",
           "state_bytes_by_device", "zero_dim"]


def state_bytes_by_device(*trees) -> dict:
    """Bytes this rank holds per device for the given (nested) dicts of
    tensors."""
    per_dev: dict = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            key = str(t.device)
            per_dev[key] = per_dev.get(key, 0) + t.numel() * t.element_size()

    for tree in trees:
        walk(tree)
    return per_dev


def zero_dim(shape, degree):
    """The ZeRO dim of a local shape: the first that ``degree`` divides
    (and is at least ``degree``), else None (kept whole)."""
    for i, s in enumerate(shape):
        if s % degree == 0 and s >= degree:
            return i
    return None


def shard_params_for_zero(shapes, degree):
    """``{name: ZeRO dim or None}`` for local parameter shapes (the
    reference's ZeRO-3 spec extension)."""
    return {n: zero_dim(tuple(s), degree) for n, s in shapes.items()}


class _Entry:
    """One trainable parameter: its placement, ZeRO slice and state."""

    def __init__(self, name, param, placement):
        self.name, self.param, self.placement = name, param, placement
        self.zdim = None
        self.start = self.length = 0
        self.shard = None          # stage 3: the kept slice
        self.host = None           # offload: the f32 host master slice
        self.splacement = placement

    def view(self):
        """This rank's slice of the parameter (a view of it, or the kept
        slice under stage 3)."""
        if self.shard is not None:
            return self.shard
        p = plain(self.param).detach()
        if self.zdim is None:
            return p
        return p.narrow(self.zdim, self.start, self.length)


class ShardedUpdate:
    """The optimizer update of a rank's trainable parameters over the
    mesh: gradients averaged over the data ranks, ZeRO over the
    ``sharding`` axis (``stage`` 1-3, see the module docstring) and the
    host-offload tier. ``named``: ``[(name, Parameter)]``; ``placements``:
    ``{name: checkpoint.Placement}`` (default whole); ``hcg`` None: one
    rank with no process group."""

    def __init__(self, named, placements, optimizer, hcg, stage, offload):
        from .collective import OneRank

        self.optimizer = optimizer
        if hcg is None:
            self._data = self._dp = self._zgroup = OneRank()
        else:
            self._data = hcg.data_group()
            self._dp = hcg.group("dp")
            self._zgroup = hcg.group("sharding")
        zdeg = self._zgroup.nranks
        self.stage = stage if zdeg > 1 else 0
        self.offload = optimizer is not None and bool(offload)
        entries = []
        for name, p in named:
            e = _Entry(name, p, placements.get(name,
                                               Placement(tuple(p.shape))))
            if self.stage >= 1:
                e.zdim = zero_dim(tuple(p.shape), zdeg)
                if e.zdim is not None:
                    e.length = p.shape[e.zdim] // zdeg
                    e.start = self._zgroup.rank * e.length
                    e.splacement = e.placement.narrow(
                        e.zdim, e.start, e.length, "sharding")
            entries.append(e)
        self.entries = entries
        opt = optimizer
        if opt is not None:
            if opt._parameter_list is None:
                opt._parameter_list = [e.param for e in entries]
            for e in entries:
                v = e.view()
                if self.offload:
                    e.host = v.detach().to("cpu", torch.float32, copy=True)
                    if v.is_cuda:
                        e.host = e.host.pin_memory()
                    v = e.host
                opt._accumulators[id(e.param)] = opt.init_state(v)
        self.gathered = True
        if self.stage >= 3:
            for e in entries:
                if e.zdim is not None:
                    e.shard = e.view().clone()
            self.release()

    def gather(self):
        """Stage 3: every parameter whole again (all-gather the slices)."""
        if self.gathered:
            return
        from .collective import all_gather

        for e in self.entries:
            if e.shard is None:
                continue
            parts = all_gather([], e.shard.movedim(e.zdim, 0).contiguous(),
                               group=self._zgroup)
            full = torch.cat([plain(t) for t in parts]).movedim(0, e.zdim)
            e.param.data = full.contiguous()
        self.gathered = True

    def release(self):
        """Stage 3: keep only the slices (the parameters' storage is
        dropped until the next gather)."""
        for e in self.entries:
            if e.shard is not None:
                e.param.data = torch.empty(
                    0, dtype=e.shard.dtype, device=e.shard.device)
        self.gathered = False

    @contextlib.contextmanager
    def whole(self):
        """The parameters whole inside (stage 3 gathers, then releases)."""
        self.gather()
        try:
            yield
        finally:
            if self.stage >= 3:
                self.release()

    def reduce(self):
        """Each entry's gradient slice, averaged over the data ranks (the
        optimizer's clip applied to the whole gradients first); the
        parameters' ``.grad`` are dropped."""
        from .collective import ReduceOp, all_reduce, reduce_scatter

        opt = self.optimizer
        clip = opt._grad_clip if opt is not None else None
        n = self._data.nranks
        grads = []
        for e in self.entries:
            p = e.param
            g = raw_grad(p)
            if g is None:
                g = torch.zeros_like(plain(p))
            if self.stage >= 2 and e.zdim is not None and clip is None:
                rs = plain(reduce_scatter(g.movedim(e.zdim, 0).contiguous(),
                                          group=self._zgroup))
                all_reduce(rs, group=self._dp)
                grads.append(rs.div_(n).movedim(0, e.zdim))
            else:
                all_reduce(g, op=ReduceOp.AVG, group=self._data)
                grads.append(g)
            p.grad = None
        if clip is not None:
            pairs = clip([(plain(e.param), g) for e, g in
                          zip(self.entries, grads)])
            grads = [g for _, g in pairs]
        return [g.narrow(e.zdim, e.start, e.length)
                if e.zdim is not None and g.shape == e.param.shape else g
                for e, g in zip(self.entries, grads)]

    @torch.no_grad()
    def apply(self, grads):
        """The optimizer's rule on each slice, then the slices all-gathered
        back into the parameters (stages 1-2)."""
        from .collective import all_gather

        opt = self.optimizer
        opt._update_pairs(
            [(e.view() if e.host is None else e.host, g)
             for e, g in zip(self.entries, grads)],
            [opt._accumulators[id(e.param)] for e in self.entries])
        for e in self.entries:
            if e.host is not None:
                e.view().copy_(e.host, non_blocking=True)
            if e.zdim is not None and e.shard is None:
                parts = all_gather([], e.view().movedim(e.zdim, 0)
                                   .contiguous(), group=self._zgroup)
                full = torch.cat([plain(t) for t in parts])
                plain(e.param).detach().copy_(full.movedim(0, e.zdim))

    def params(self):
        return {e.name: (e.shard if e.shard is not None else
                         plain(e.param).detach()) for e in self.entries}

    def opt_state(self):
        opt = self.optimizer
        return {} if opt is None else {
            e.name: dict(opt._accumulators[id(e.param)])
            for e in self.entries}

    def ckpt_items(self, extra_axes=()):
        """``{"params/<name>" | "opt_state/<name>/<k>": (tensor,
        Placement)}``; ``extra_axes`` join every placement's axes (a
        pipeline stage's own parameters)."""
        def tag(pl):
            if extra_axes:
                pl = Placement(pl.global_shape, pl.boxes,
                               pl.axes | set(extra_axes), pl.spec)
            return pl

        items = {}
        opt = self.optimizer
        for e in self.entries:
            if e.shard is not None:
                items[f"params/{e.name}"] = (e.shard, tag(e.splacement))
            else:
                items[f"params/{e.name}"] = (plain(e.param).detach(),
                                             tag(e.placement))
            if opt is None:
                continue
            for k, v in opt._accumulators[id(e.param)].items():
                pl = Placement(()) if v.dim() == 0 else e.splacement
                items[f"opt_state/{e.name}/{k}"] = (v, tag(pl))
        return items

    def restore(self, flat):
        opt = self.optimizer
        for e in self.entries:
            if e.shard is not None:
                restore_local(e.shard, e.splacement, flat[f"params/{e.name}"])
            else:
                restore_local(plain(e.param).detach(), e.placement,
                              flat[f"params/{e.name}"])
            if opt is None:
                continue
            for k, v in opt._accumulators[id(e.param)].items():
                key = f"opt_state/{e.name}/{k}"
                if key in flat:
                    restore_local(v, Placement(()) if v.dim() == 0
                                  else e.splacement, flat[key])
            if e.host is not None:
                e.host.copy_(e.view())


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class DistributedEngine:
    def __init__(self, layer, loss_fn=None, optimizer=None,
                 strategy: DistributedStrategy | None = None, mesh=None,
                 input_specs=None, label_specs=None):
        from .mp_layers import _ParallelBase
        from .parallel import env_device

        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.strategy = strategy or DistributedStrategy()
        hcg = get_hybrid_communicate_group()
        if mesh is None and hcg is not None and \
                hcg.topology() == _degrees(self.strategy):
            mesh = hcg.mesh
        self.mesh = mesh if mesh is not None else build_mesh(self.strategy)
        if hcg is None or hcg.mesh is not self.mesh:
            hcg = HybridCommunicateGroup(self.strategy, self.mesh)
            set_hybrid_communicate_group(hcg)
        self.hcg = hcg
        mp = hcg.get_model_parallel_world_size()
        for m in layer.modules():
            if isinstance(m, _ParallelBase) and m.mp_degree != mp:
                raise ValueError(
                    f"{type(m).__name__} was built for {m.mp_degree} mp "
                    f"ranks and the mesh has {mp}: build the layer after "
                    f"fleet.init / init_parallel_env with this strategy")
        self._data = hcg.data_group()
        self.device = next((p.device for p in layer.parameters()),
                           env_device())
        self._sharded = None
        self._buffers = None
        self._pending = False      # update=False gradients in .grad
        self._step_count = 0

    # -- layout ----------------------------------------------------------
    def _init_state(self):
        from .checkpoint import layer_placements

        placed = layer_placements(self.layer)
        named = [(n, p) for n, p in self.layer.named_parameters()
                 if p.requires_grad]
        self._sharded = ShardedUpdate(
            named, placed, self.optimizer, self.hcg,
            self.strategy.sharding.stage, self.strategy.sharding.offload)
        self._buffers = dict(self.layer.named_buffers())

    # -- batches ---------------------------------------------------------
    def _rows(self, n):
        """This rank's rows ``[lo, hi)`` of a batch of ``n``."""
        k, r = self._data.nranks, self.hcg.get_data_rank()
        bounds = [round(i * n / k) for i in range(k + 1)]
        return bounds[r], bounds[r + 1]

    def _local(self, x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(x)))
        t = plain(t).to(self.device)
        lo, hi = self._rows(t.shape[0])
        return t[lo:hi]

    def _autocast(self):
        amp = self.strategy.amp
        if amp.enable and amp.dtype == "bfloat16":
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def _forward_loss(self, inputs, labels, compute_loss=True):
        from ..hapi.model import _loss_of

        with self._autocast():
            outs = _as_list(self.layer(*inputs))
        outs = [o.float() if o.is_floating_point() else o for o in outs]
        if self.loss_fn is None or not compute_loss or not labels:
            return torch.zeros((), device=self.device), outs
        return _loss_of(self.loss_fn, outs, labels).mean(), outs

    def _global_mean(self, local_loss, n_local, n_total):
        """The loss of the whole batch from each rank's mean."""
        from .collective import all_reduce

        t = (local_loss.detach().float() * n_local).reshape(1).clone()
        all_reduce(t, group=self._data)
        return t[0] / n_total

    def _gather_rows(self, outs):
        """Every rank's rows of each output, in batch order."""
        from .collective import all_gather

        if self._data.nranks == 1:
            return outs
        res = []
        for o in outs:
            n = torch.tensor([o.shape[0]], device=o.device)
            sizes = [int(s) for s in all_gather(n, group=self._data)]
            pad = torch.zeros((max(sizes),) + tuple(o.shape[1:]),
                              dtype=o.dtype, device=o.device)
            pad[:o.shape[0]] = o.detach()
            parts = all_gather([], pad, group=self._data)
            res.append(torch.cat([plain(p)[:s] for p, s in
                                  zip(parts, sizes)]))
        return res

    # -- the step ----------------------------------------------------------
    def _backward(self, inputs, labels):
        """Forward and backward of this rank's rows (with accumulation
        over a leading micro-batch dim); returns (global loss, local
        outputs of the last micro-batch)."""
        k = max(1, int(self.strategy.gradient_merge_steps))
        ins, lbs = _as_list(inputs), _as_list(labels)
        total = torch.zeros((), device=self.device)
        outs = []
        for i in range(k):
            mi = [x[i] for x in ins] if k > 1 else ins
            ml = [y[i] for y in lbs] if k > 1 else lbs
            n_total = np.shape(mi[0])[0]
            li = [self._local(x) for x in mi]
            ll = [self._local(y) for y in ml]
            n_local = li[0].shape[0]
            loss, outs = self._forward_loss(li, ll)
            # each rank's share of the global mean: averaging the
            # gradients over the data ranks then gives the global one
            w = n_local * self._data.nranks / n_total / k
            (loss * w).backward()
            total = total + self._global_mean(loss, n_local, n_total) / k
        return total, outs

    def _prep(self):
        if self._sharded is None:
            self._init_state()
        self.layer.train()

    def step(self, inputs, labels):
        """One training step; returns the global batch's loss."""
        loss, _ = self._train(inputs, labels, update=True)
        return loss

    def _train(self, inputs, labels, update=True, guard=False,
               poison=False):
        self._prep()
        sh = self._sharded
        ok = True
        with sh.whole():
            loss, outs = self._backward(inputs, labels)
            if update:
                grads = sh.reduce()
                if guard:
                    from .collective import Group, ReduceOp, all_reduce

                    if poison:
                        grads = [torch.full_like(g, float("nan"))
                                 for g in grads]
                        loss = torch.full_like(loss, float("nan"))
                    finite = bool(torch.isfinite(loss)) and all(
                        bool(torch.isfinite(g).all()) for g in grads)
                    flags = torch.tensor([float(finite)], device=self.device)
                    # the whole world decides (mp ranks hold other grads)
                    all_reduce(flags, op=ReduceOp.MIN, group=Group())
                    ok = bool(flags[0] > 0)
                if ok:
                    sh.apply(grads)
            self._pending = not update
        self._step_count += 1
        return loss.detach().cpu(), (outs, ok)

    def train_step_outs(self, inputs, labels, update=True):
        """One step returning (loss, the global batch's outputs);
        ``update=False`` accumulates the gradients for a later update
        (:meth:`flush_accum_grads` or the next ``update=True`` step)."""
        loss, (outs, _) = self._train(inputs, labels, update=update)
        return loss, self._gather_rows(outs)

    def train_step_guarded(self, inputs, labels, poison_nan=False):
        """A step whose update is skipped on every rank when the loss or
        any gradient is not finite; returns (loss, ok)."""
        loss, (_, ok) = self._train(inputs, labels, guard=True,
                                    poison=poison_nan)
        return loss, ok

    def flush_accum_grads(self):
        if not self._pending:
            return
        with self._sharded.whole():
            self._sharded.apply(self._sharded.reduce())
        self._pending = False

    @torch.no_grad()
    def eval_step(self, inputs, labels):
        self._prep()
        self.layer.eval()
        with self._sharded.whole():
            li = [self._local(x) for x in _as_list(inputs)]
            ll = [self._local(y) for y in _as_list(labels)]
            n_total = np.shape(_as_list(inputs)[0])[0]
            loss, outs = self._forward_loss(li, ll)
            loss = self._global_mean(loss, li[0].shape[0], n_total)
        return loss.cpu(), self._gather_rows(outs)

    @torch.no_grad()
    def predict_step(self, inputs):
        self._prep()
        self.layer.eval()
        with self._sharded.whole():
            li = [self._local(x) for x in _as_list(inputs)]
            _, outs = self._forward_loss(li, [], compute_loss=False)
        return self._gather_rows(outs)

    def reset_state(self):
        """Re-read the layer's parameters at the next step (after
        ``set_state_dict``)."""
        if self._sharded is not None:
            self._sharded.gather()
        self._sharded = None
        self._pending = False

    def sync_to_layer(self):
        """Make the layer hold the whole trained parameters (stage 3 keeps
        them gathered until the next step)."""
        if self._sharded is not None:
            self._sharded.gather()

    @property
    def state(self):
        """``(params, buffers, opt_state)`` as this rank holds them (ZeRO
        slices where sharded)."""
        self._prep()
        buffers = {n: plain(b) for n, b in self._buffers.items()
                   if b is not None}
        return self._sharded.params(), buffers, self._sharded.opt_state()

    # -- checkpoints ---------------------------------------------------
    def _ckpt_items(self):
        self._prep()
        items = self._sharded.ckpt_items()
        for n, b in self._buffers.items():
            if b is not None:
                items[f"buffers/{n}"] = (plain(b), Placement(tuple(b.shape)))
        return items

    def _ckpt_extra(self):
        extra = {"step_count": self._step_count}
        if self.optimizer is not None:
            extra["optimizer_step_count"] = self.optimizer._step_count
        return extra

    def _ckpt_restore(self, flat, extra):
        self._prep()
        self._sharded.restore(flat)
        for n, b in self._buffers.items():
            if b is not None and f"buffers/{n}" in flat:
                restore_local(plain(b), Placement(tuple(b.shape)),
                              flat[f"buffers/{n}"])
        self._pending = False
        self._step_count = int(extra.get("step_count", self._step_count))
        if self.optimizer is not None and "optimizer_step_count" in extra:
            self.optimizer._step_count = int(extra["optimizer_step_count"])

    def save_checkpoint(self, path, async_save=False):
        """Sharded checkpoint of (params, buffers, opt_state) and the step
        counts; :meth:`load_checkpoint` takes it on any mesh."""
        from .checkpoint import DistributedSaver

        saver = DistributedSaver(self)
        saver.save(path, async_save=async_save)
        return saver

    def load_checkpoint(self, path):
        from .checkpoint import DistributedSaver

        return DistributedSaver(self).load(path)


def _degrees(strategy):
    from .mesh import _degrees as d

    return d(strategy)
