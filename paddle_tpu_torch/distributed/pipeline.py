"""Pipeline parallelism over the ``pp`` axis (counterpart of
``paddle_tpu/distributed/pipeline.py``; Paddle's ``PipelineLayer`` /
``LayerDesc`` and its schedules).

The reference is one SPMD program: stage weights stacked on a leading
dim sharded over ``pp``, micro-batches marching through a scan with one
``ppermute`` a tick, and a hand-scheduled backward for 1F1B. Here each pp
rank is a process that holds its own stages and runs a schedule of
forward (F) and backward (B) units, handing activations forward and
cotangents back with point-to-point sends over the pp group (tagged per
unit, so the units of several virtual stages share a channel):

- ``"fthenb"`` (GPipe fill-drain, the reference's ``spmd_pipeline``):
  every forward, then every backward;
- ``"1f1b"`` (the reference's ``spmd_pipeline_1f1b``): ``S - s - 1``
  warm-up forwards on stage ``s``, then one forward and one backward a
  step, then the remaining backwards, so a stage keeps at most ``S - s``
  micro-batches in flight;
- ``"interleaved"`` (``spmd_pipeline_interleaved``): ``vpp`` chunks per
  rank, virtual stage ``v`` on rank ``v % S`` as chunk ``v // S``, the
  order of :func:`interleave_stage_params`; fill-drain over the ``S *
  vpp`` virtual stages, as the reference's scan is.

The loss is the mean over micro-batches of each micro-batch's loss, as
in the reference; gradients are those of that mean. Every schedule
computes the same function; they differ in what is in flight.
"""
from __future__ import annotations

import torch

from ..core.tensor import plain
from ..nn.layer import Layer

__all__ = [
    "LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
    "stack_stage_params", "interleave_stage_params", "schedule_order",
    "PipelineRunner", "spmd_pipeline", "SCHEDULES",
]

SCHEDULES = ("fthenb", "1f1b", "interleaved")


class LayerDesc:
    """Lazy layer spec (Paddle's LayerDesc): built only by the stage that
    owns it."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, *args, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.key = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Uniform segmentation (Paddle's SegmentLayers): stage bounds."""

    def __init__(self, layers, num_parts, method="uniform"):
        self.layers = layers
        self.num_parts = num_parts

    def do_segment(self):
        n = len(self.layers)
        per, rem = divmod(n, self.num_parts)
        bounds = [0]
        for i in range(self.num_parts):
            bounds.append(bounds[-1] + per + (1 if i < rem else 0))
        return bounds


class PipelineLayer(Layer):
    """The layer list of a pipeline, segmented into ``num_stages`` stages.
    Under a mesh with pp > 1 this rank builds only its own stage's layers
    (as Paddle does); otherwise every layer, and ``forward`` runs them in
    order."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None):
        super().__init__()
        from .mesh import get_hybrid_communicate_group

        descs = list(layers)
        hcg = get_hybrid_communicate_group()
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        self._num_stages = num_stages or pp
        self._loss_fn = loss_fn
        self.segment_parts = SegmentLayers(descs, self._num_stages,
                                           seg_method).do_segment()
        self.stage_id = hcg.get_stage_id() if pp > 1 else None
        if self.stage_id is None:
            lo, hi = 0, len(descs)
        else:
            lo = self.segment_parts[self.stage_id]
            hi = self.segment_parts[self.stage_id + 1]
        self._lo = lo
        self.run_function = torch.nn.ModuleList(
            [d.build_layer() if isinstance(d, LayerDesc) else d
             for d in descs[lo:hi]])

    def get_stage_layers(self, stage_id):
        lo = self.segment_parts[stage_id] - self._lo
        hi = self.segment_parts[stage_id + 1] - self._lo
        if lo < 0 or hi > len(self.run_function):
            raise ValueError(f"stage {stage_id}'s layers live on another "
                             f"rank")
        return list(self.run_function)[lo:hi]

    def forward(self, x):
        for layer in self.run_function:
            x = layer(x)
        return x


def stack_stage_params(per_stage_params):
    """[{name: tensor} per stage] -> {name: [S, ...] tensor}."""
    keys = per_stage_params[0].keys()
    return {k: torch.stack([plain(p[k]) for p in per_stage_params])
            for k in keys}


def interleave_stage_params(params_L, n_stages):
    """Reorder logical-stage-stacked params ``[L, ...]`` (``L = n_stages *
    vpp``) into ``[n_stages, vpp, ...]``: device ``d`` hosts chunks ``d,
    d + n, d + 2n, ...`` (the reference's layout; ``[d][c]`` is virtual
    stage ``c * n + d``)."""
    def rearrange(a):
        a = plain(a)
        v = a.shape[0] // n_stages
        return a.reshape((v, n_stages) + tuple(a.shape[1:])).transpose(0, 1)

    if isinstance(params_L, dict):
        return {k: rearrange(v) for k, v in params_L.items()}
    return rearrange(params_L)


def schedule_order(schedule, n_micro, n_stages, stage, vpp=1):
    """The units stage ``stage`` runs, in order: ``("F" | "B",
    micro_batch, chunk)``."""
    M, S = n_micro, n_stages
    if schedule not in SCHEDULES:
        raise ValueError(f"pp_schedule must be one of {SCHEDULES}; got "
                         f"{schedule!r}")
    if schedule == "1f1b" and vpp == 1:
        warm = min(S - stage - 1, M)
        ops = [("F", m, 0) for m in range(warm)]
        for i in range(M - warm):
            ops += [("F", warm + i, 0), ("B", i, 0)]
        ops += [("B", m, 0) for m in range(M - warm, M)]
        return ops
    fwd = [("F", m, c) for m in range(M) for c in range(vpp)]
    bwd = [("B", m, c) for m in reversed(range(M))
           for c in reversed(range(vpp))]
    return fwd + bwd


class PipelineRunner:
    """Runs one stage's units of a schedule.

    group:  the pp :class:`~.collective.Group` (rank = stage).
    shape, dtype, device: of the activation handed between stages.
    first(m) -> h          the first virtual stage's input of micro-batch
                           m (differentiable into its own parameters);
    chunk(c, h) -> h       this rank's chunk c;
    last(m, h) -> loss     the last virtual stage's loss of micro-batch m
                           (already divided by the micro-batch count).
    """

    def __init__(self, group, n_micro, vpp, shape, dtype, device):
        self.group, self.M, self.vpp = group, n_micro, vpp
        self.S = group.nranks
        self.stage = group.rank
        self.L = self.S * vpp
        self.shape, self.dtype, self.device = tuple(shape), dtype, device

    def _tag(self, kind, v, m):
        return (kind * self.L + v) * self.M + m

    def run(self, schedule, first, chunk, last):
        """Run the schedule; returns the sum of the last stage's losses on
        that stage (0 elsewhere), detached."""
        from .collective import recv, send

        S, st = self.S, self.stage
        saved, pending = {}, []
        total = torch.zeros((), device=self.device)
        for kind, m, c in schedule_order(schedule, self.M, S, st, self.vpp):
            v = c * S + st
            if kind == "F":
                if v == 0:
                    h_in = first(m)
                else:
                    h_in = torch.empty(self.shape, dtype=self.dtype,
                                       device=self.device)
                    recv(h_in, src=(v - 1) % S, group=self.group,
                         tag=self._tag(0, v, m))
                    h_in.requires_grad_()
                h_out = chunk(c, h_in)
                if v == self.L - 1:
                    loss = last(m, h_out)
                    total = total + loss.detach()
                    saved[m, c] = (h_in, loss, None)
                else:
                    h_send = h_out.detach().contiguous()
                    pending.append((send(h_send, dst=(v + 1) % S,
                                         group=self.group, sync_op=False,
                                         tag=self._tag(0, v + 1, m)),
                                    h_send))
                    saved[m, c] = (h_in, None, h_out)
            else:
                h_in, loss, h_out = saved.pop((m, c))
                if loss is not None:
                    loss.backward()
                else:
                    g = torch.empty(self.shape, dtype=self.dtype,
                                    device=self.device)
                    recv(g, src=(v + 1) % S, group=self.group,
                         tag=self._tag(1, v, m))
                    torch.autograd.backward(h_out, g)
                if v > 0:
                    gi = h_in.grad.contiguous()
                    pending.append((send(gi, dst=(v - 1) % S,
                                         group=self.group, sync_op=False,
                                         tag=self._tag(1, v - 1, m)), gi))
        for work, _ in pending:
            work.wait()
        return total

    def forward_only(self, first, chunk):
        """The fill-drain forwards without autograd; returns the last
        virtual stage's outputs ``[M, ...]`` on its rank (None
        elsewhere)."""
        from .collective import recv, send

        S, st = self.S, self.stage
        outs, pending = [None] * self.M, []
        with torch.no_grad():
            for m in range(self.M):
                for c in range(self.vpp):
                    v = c * S + st
                    if v == 0:
                        h = first(m)
                    else:
                        h = torch.empty(self.shape, dtype=self.dtype,
                                        device=self.device)
                        recv(h, src=(v - 1) % S, group=self.group,
                             tag=self._tag(0, v, m))
                    h = chunk(c, h)
                    if v == self.L - 1:
                        outs[m] = h
                    else:
                        h = h.contiguous()
                        pending.append((send(h, dst=(v + 1) % S,
                                             group=self.group,
                                             sync_op=False,
                                             tag=self._tag(0, v + 1, m)), h))
        for work, _ in pending:
            work.wait()
        return torch.stack(outs) if outs[0] is not None else None


def spmd_pipeline(stage_fn, stage_params, x_micro, group="pp", vpp=1):
    """Fill-drain forward of ``x_micro`` ``[M, mb, ...]`` through the pp
    ranks: ``stage_fn(stage_params, h) -> h`` is this rank's stage (or,
    with ``vpp`` > 1, ``stage_params`` is a list of its chunks' params).
    Returns the last stage's outputs ``[M, mb, ...]`` on every pp rank
    (broadcast from the last, as the reference's ``psum`` replicates
    them). Forward only: the trainer's schedules train."""
    from .collective import _resolve_group, broadcast

    g = _resolve_group(group)
    x = plain(x_micro)
    chunks = stage_params if vpp > 1 else [stage_params]
    run = PipelineRunner(g, x.shape[0], vpp, x.shape[1:], x.dtype, x.device)
    out = run.forward_only(lambda m: x[m],
                           lambda c, h: stage_fn(chunks[c], h))
    if out is None:
        out = torch.empty_like(x)
    return broadcast(out, src=g.nranks - 1, group=g)
