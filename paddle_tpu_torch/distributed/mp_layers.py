"""Tensor-parallel layers (counterpart of ``paddle_tpu/distributed/
mp_layers.py``; Paddle's ``fleet/layers/mpu/mp_layers.py``).

The reference keeps each weight at its logical shape with a
``PartitionSpec`` and lets GSPMD insert the collectives. Here each rank
holds its shard as a plain ``Parameter`` (Paddle's ``[in, out]`` layout)
and the layers call Paddle's communication pairs as autograd Functions
over the mp group:

- ``c_identity`` (forward as is, backward all-reduce) in front of a
  column-parallel product;
- ``c_allreduce_sum`` (forward all-reduce, backward as is) after a
  row-parallel product and a vocab-parallel lookup;
- ``c_concat`` (forward all-gather along the last dim, backward this
  rank's slice) for ``gather_output``; ``c_split`` is its transpose.

A column-parallel weight may be the concatenation of segments (the fused
``qkv_proj``'s q, k and v; ``gate_up_proj``'s gate and up): each segment
splits over the ranks on its own, so a rank's columns are its part of
every segment, and a gathered output is put back in logical order. Every
layer cuts its shard from a logical full weight with :meth:`shard_of`,
draws its initial shard that way (the same generator, the same logical
weight at any mp degree), and with an mp group of one rank it is the
plain layer and issues no collective.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..framework.random import get_generator
from ..nn.layer import Layer

__all__ = [
    "VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
    "ParallelCrossEntropy", "mark_sharding", "mp_info",
]


def mp_info(mp_group=None):
    """``(group or None, rank, nranks)`` of the tensor-parallel group: the
    one given, else the active mesh's mp axis, else none (one rank);
    ``False`` is one rank whatever mesh is active."""
    from .collective import _resolve_group
    from .mesh import get_hybrid_communicate_group

    if mp_group is False:
        return None, 0, 1
    if mp_group is None:
        hcg = get_hybrid_communicate_group()
        if hcg is None or hcg.get_model_parallel_world_size() == 1:
            return None, 0, 1
        mp_group = "mp"
    g = _resolve_group(mp_group)
    if g.nranks == 1:
        return None, 0, 1
    return g, g.rank, g.nranks


def mark_sharding(x, *spec):
    """The reference pins GSPMD layouts with this; each rank here already
    holds its layout, so it returns ``x``."""
    return x


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from .collective import all_reduce

        g = g.contiguous().clone()
        all_reduce(g, group=ctx.group)
        return g, None


class _CAllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        from .collective import all_reduce

        out = x.contiguous().clone()
        all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x, group):
    from .collective import all_gather

    parts = all_gather([], x.contiguous(), group=group)
    return [torch.Tensor.view_as(p, p) for p in parts]


class _CConcat(torch.autograd.Function):
    """All-gather along the last dim; ``segments`` (local sizes) put the
    gathered columns back in logical order."""

    @staticmethod
    def forward(ctx, x, group, rank, n, segments):
        ctx.rank, ctx.n, ctx.segments = rank, n, segments
        parts = _gather_last(x, group)
        if segments is None:
            return torch.cat(parts, dim=-1)
        split = [p.split(segments, dim=-1) for p in parts]
        return torch.cat([split[r][s] for s in range(len(segments))
                          for r in range(n)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _take_cols(g, ctx.rank, ctx.n, ctx.segments), None, None, \
            None, None


def _take_cols(full, rank, n, segments):
    """This rank's columns of a logical last dim (its part of every
    segment; ``segments`` are the local sizes)."""
    if segments is None:
        w = full.shape[-1] // n
        return full.narrow(-1, rank * w, w).contiguous()
    out, start = [], 0
    for s in segments:
        out.append(full.narrow(-1, start + rank * s, s))
        start += s * n
    return torch.cat(out, dim=-1).contiguous()


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.group = group
        return _take_cols(x, rank, n, None)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather_last(g, ctx.group),
                         dim=-1), None, None, None


def _row_placement(logical, local, start, n):
    from .checkpoint import Placement

    if n == 1:
        return Placement(logical)
    return Placement.offset(logical, tuple(local), 0, start, "mp")


def _col_placement(logical, rank, n, segments):
    """The boxes of a column shard on the last dim: one, or one per
    segment."""
    from .checkpoint import Placement

    if n == 1:
        return Placement(logical)
    d = len(logical) - 1
    segs = segments or [logical[-1] // n]
    boxes, lstart, gstart = [], 0, 0
    for s in segs:
        l0, g0, size = [0] * len(logical), [0] * len(logical), list(logical)
        l0[d], g0[d], size[d] = lstart, gstart + rank * s, s
        boxes.append((tuple(l0), tuple(g0), tuple(size)))
        lstart += s
        gstart += s * n
    spec = [None] * len(logical)
    spec[d] = "mp"
    return Placement(logical, boxes, axes=("mp",), spec=spec)


def _draw(shape, device, dtype, generator, init, transposed=True):
    """A logical weight: ``init`` (``"normal:<std>"``, ``"xavier"``,
    ``"xavier_normal"``, ``"zeros"``) drawn, for a 2-D ``[in, out]``
    weight, in torch's ``[out, in]`` order (as the port's ``nn.Linear``
    draws) unless ``transposed`` is False, and returned in Paddle's
    ``[in, out]``."""
    g = generator if generator is not None else get_generator(device)
    transposed = transposed and len(shape) == 2
    t_shape = (shape[1], shape[0]) if transposed else tuple(shape)
    w = torch.empty(t_shape, device=device, dtype=dtype)
    if init == "zeros":
        w.zero_()
    elif init == "xavier":
        torch.nn.init.xavier_uniform_(w, generator=g)
    elif init == "xavier_normal":
        torch.nn.init.xavier_normal_(w, generator=g)
    else:
        w.normal_(0.0, float(init.split(":")[1]), generator=g)
    return w.t() if transposed else w


def _linear_weight(rows, cols, **kw):
    """A ``[rows, cols]`` (Paddle's ``[in, out]``) weight stored column
    major: ``w.t()`` is then the contiguous ``[out, in]`` that
    ``F.linear`` reads as torch's own ``Linear`` does, so the products
    run the same GEMMs, with the same bf16 rounding, as a plain
    ``nn.Linear`` model."""
    return torch.nn.Parameter(torch.empty(cols, rows, **kw).t())


class _ParallelBase(Layer):
    def _setup(self, mp_group):
        self._group, self._rank, self._n = mp_info(mp_group)

    @property
    def mp_rank(self):
        return self._rank

    @property
    def mp_degree(self):
        return self._n

    @torch.no_grad()
    def reset_parameters(self, generator=None, init=None):
        """Draw the logical weight and keep this rank's shard."""
        w = self.weight
        full = _draw(self.logical_shape, w.device, w.dtype, generator,
                     init or self._init,
                     transposed=not isinstance(self, VocabParallelEmbedding))
        torch.Tensor.copy_(w, self.shard_of(full))
        if getattr(self, "bias", None) is not None:
            self.bias.zero_()


class VocabParallelEmbedding(_ParallelBase):
    """Embedding with the vocabulary split over the mp ranks: rank ``r``
    holds rows ``[r V/n, (r+1) V/n)``, looks up the ids it owns (zeros
    for the rest) and the partial rows are summed over the group."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None, init="xavier_normal"):
        super().__init__()
        self._setup(mp_group)
        if num_embeddings % self._n:
            raise ValueError(f"vocab {num_embeddings} does not split over "
                             f"{self._n} mp ranks")
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.per_rank = num_embeddings // self._n
        self.logical_shape = (num_embeddings, embedding_dim)
        self._init = init
        self.weight = torch.nn.Parameter(torch.empty(
            self.per_rank, embedding_dim, device=resolve_device(device),
            dtype=dtype))
        self.reset_parameters(generator)

    def shard_of(self, full):
        return full[self._rank * self.per_rank:
                    (self._rank + 1) * self.per_rank]

    def placements(self):
        """``{parameter name: checkpoint.Placement}`` of this rank's
        shards in the logical weights."""
        return {"weight": _row_placement(self.logical_shape,
                                         self.weight.shape,
                                         self._rank * self.per_rank,
                                         self._n)}

    def forward(self, x, weight=None):
        w = self.weight if weight is None else weight
        if self._n == 1:
            return torch.nn.functional.embedding(x, w)
        start = self._rank * self.per_rank
        local = x - start
        outside = (local < 0) | (local >= self.per_rank)
        out = torch.nn.functional.embedding(local.clamp(0, self.per_rank - 1),
                                            w)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return _CAllReduceSum.apply(out, self._group)


class ColumnParallelLinear(_ParallelBase):
    """``y = x W + b`` with ``W`` ``[in, out]`` split by output columns
    (rank ``r`` holds its part of every segment of ``segments``, the
    logical column groups; default one). ``gather_output`` all-gathers
    ``y`` in logical order; else each rank keeps its columns (the input
    of a :class:`RowParallelLinear`)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, segments=None, device=None,
                 dtype=torch.float32, generator=None, init="xavier"):
        super().__init__()
        self._setup(mp_group)
        segments = list(segments) if segments is not None else [out_features]
        if sum(segments) != out_features or any(s % self._n
                                                for s in segments):
            raise ValueError(f"column segments {segments} do not split "
                             f"over {self._n} mp ranks")
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self._segments = (None if len(segments) == 1
                          else [s // self._n for s in segments])
        self.logical_shape = (in_features, out_features)
        self._init = init
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = _linear_weight(in_features, out_features // self._n,
                                     **kw)
        self.bias = (torch.nn.Parameter(torch.empty(out_features // self._n,
                                                    **kw))
                     if has_bias else None)
        self.reset_parameters(generator)

    def shard_of(self, full):
        return _take_cols(full, self._rank, self._n, self._segments)

    def placements(self):
        out = {"weight": _col_placement(self.logical_shape, self._rank,
                                        self._n, self._segments)}
        if self.bias is not None:
            out["bias"] = _col_placement((self.out_features,), self._rank,
                                         self._n, self._segments)
        return out

    def forward(self, x, weight=None):
        w = self.weight if weight is None else weight
        if self._n == 1:
            return torch.nn.functional.linear(x, torch.Tensor.t(w), self.bias)
        x = _CIdentity.apply(x, self._group)
        y = torch.nn.functional.linear(x, torch.Tensor.t(w), self.bias)
        if self.gather_output:
            y = _CConcat.apply(y, self._group, self._rank, self._n,
                               self._segments)
        return y


class RowParallelLinear(_ParallelBase):
    """``y = x W + b`` with ``W`` ``[in, out]`` split by input rows: each
    rank multiplies its slice of ``x``'s last dim (``input_is_parallel``:
    ``x`` is that slice already) and the partial products are summed over
    the group; ``b`` is added once, after the sum."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32, generator=None,
                 init="xavier"):
        super().__init__()
        self._setup(mp_group)
        if in_features % self._n:
            raise ValueError(f"in_features {in_features} does not split "
                             f"over {self._n} mp ranks")
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.per_rank = in_features // self._n
        self.logical_shape = (in_features, out_features)
        self._init = init
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = _linear_weight(self.per_rank, out_features, **kw)
        self.bias = (torch.nn.Parameter(torch.empty(out_features, **kw))
                     if has_bias else None)
        self.reset_parameters(generator)

    def shard_of(self, full):
        return full[self._rank * self.per_rank:
                    (self._rank + 1) * self.per_rank]

    def placements(self):
        out = {"weight": _row_placement(self.logical_shape,
                                        self.weight.shape,
                                        self._rank * self.per_rank,
                                        self._n)}
        if self.bias is not None:
            from .checkpoint import Placement

            out["bias"] = Placement((self.out_features,))
        return out

    def forward(self, x, weight=None):
        w = self.weight if weight is None else weight
        if self._n == 1:
            return torch.nn.functional.linear(x, torch.Tensor.t(w), self.bias)
        if not self.input_is_parallel:
            x = _CSplit.apply(x, self._group, self._rank, self._n)
        y = _CAllReduceSum.apply(torch.matmul(x, w), self._group)
        return y if self.bias is None else y + self.bias


class _ParallelCE(torch.autograd.Function):
    """Softmax cross entropy over vocab-split logits (Paddle's
    ``c_softmax_with_cross_entropy``): the row max, the sum of
    exponentials and the label's logit are reduced over the group."""

    @staticmethod
    def forward(ctx, logits, label, group, rank, n, ignore_index):
        from .collective import ReduceOp, all_reduce

        def reduce_(t, op=ReduceOp.SUM):
            if n > 1:
                all_reduce(t, op=op, group=group)

        x = logits.float()
        V = x.shape[-1]
        m = x.max(dim=-1, keepdim=True).values
        reduce_(m, ReduceOp.MAX)
        e = torch.exp(x - m)
        s = e.sum(dim=-1, keepdim=True)
        reduce_(s)
        local = label - rank * V
        own = (local >= 0) & (local < V)
        idx = local.clamp(0, V - 1).unsqueeze(-1)
        tgt = torch.where(own.unsqueeze(-1), x.gather(-1, idx) - m,
                          torch.zeros_like(m))
        reduce_(tgt)
        loss = (torch.log(s) - tgt).squeeze(-1)
        keep = label != ignore_index
        loss = torch.where(keep, loss, torch.zeros_like(loss))
        ctx.save_for_backward(e / s, idx, own, keep)
        return loss

    @staticmethod
    def backward(ctx, g):
        p, idx, own, keep = ctx.saved_tensors
        onehot = torch.zeros_like(p).scatter_(
            -1, idx, own.unsqueeze(-1).to(p.dtype))
        grad = (p - onehot) * (g * keep).unsqueeze(-1)
        return grad, None, None, None, None, None


class ParallelCrossEntropy(Layer):
    """Per-token cross entropy of vocab-split logits ``[..., V / n]``
    against global labels; ``ignore_index`` tokens give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._group, self._rank, self._n = mp_info(mp_group)

    def forward(self, input, label):
        label = label.long()
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        out = _ParallelCE.apply(input, label, self._group, self._rank,
                                self._n, self.ignore_index)
        return out.to(input.dtype)
