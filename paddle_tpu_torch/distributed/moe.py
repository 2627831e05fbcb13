"""Mixture of experts with expert parallelism (counterpart of
``paddle_tpu/distributed/moe.py``; Paddle's ``MoELayer`` with its gates
and ``global_scatter`` / ``global_gather``).

Gates, as in the reference: ``top1_gating`` (Switch: top-1, the
load-balance aux loss, tokens past an expert's capacity dropped) and
``top2_gating`` (GShard: the second choice queues after every first
choice). Dispatch and combine are GShard's einsums over an ``[E, C, D]``
buffer.

Expert parallelism over the ``ep`` axis: rank ``r`` holds experts ``[r E
/ n, (r+1) E / n)`` and its own tokens. The gate logits are all-gathered
so every rank routes the whole batch exactly as one device would (the
capacity positions count over every token); each rank scatters its
tokens into the ``[E, C, D]`` buffer, an all-to-all sends each expert's
block to the rank that holds it (where the blocks of every rank sum,
their slots being disjoint), the experts run, and a second all-to-all
brings every expert's output to every rank for its tokens' combine. The
result equals the single-device layer on the same tokens.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.tensor import plain
from ..nn.layer import Layer

__all__ = ["MoELayer", "top2_gating", "top1_gating"]


def _one_hot(idx, n):
    """One-hot f32 that is all zeros for an index outside ``[0, n)``
    (``jax.nn.one_hot``'s rule)."""
    inside = (idx >= 0) & (idx < n)
    oh = torch.nn.functional.one_hot(idx.clamp(0, n - 1).long(), n).float()
    return oh * inside.unsqueeze(-1)


def top1_gating(logits, capacity, noisy=False, key=None):
    """Switch-style top-1 routing. logits ``[N, E]`` -> dispatch ``[N, E,
    C]``, combine ``[N, E, C]``, aux loss."""
    N, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    mask = _one_hot(torch.argmax(probs, dim=-1), E)
    aux = torch.sum(mask.mean(0) * probs.mean(0)) * E
    pos = torch.cumsum(mask, 0) * mask - 1.0
    pos_in = torch.sum(pos * mask, -1)
    keep = (pos_in < capacity).float()
    gate = torch.sum(probs * mask, -1) * keep
    slot = _one_hot(pos_in.long(), capacity)[:, None, :]
    dispatch = mask[..., None] * slot * keep[:, None, None]
    combine = gate[:, None, None] * dispatch
    return dispatch, combine, aux


def top2_gating(logits, capacity):
    """GShard top-2 routing."""
    N, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    mask1 = _one_hot(torch.argmax(probs, dim=-1), E)
    mask2 = _one_hot(torch.argmax(probs * (1 - mask1), dim=-1), E)
    aux = torch.sum(mask1.mean(0) * probs.mean(0)) * E
    pos_in1 = torch.sum((torch.cumsum(mask1, 0) * mask1 - 1.0) * mask1, -1)
    pos2 = (torch.cumsum(mask2, 0) + mask1.sum(0, keepdim=True)) * mask2 - 1.0
    pos_in2 = torch.sum(pos2 * mask2, -1)
    keep1 = (pos_in1 < capacity).float()
    keep2 = (pos_in2 < capacity).float()
    g1 = torch.sum(probs * mask1, -1) * keep1
    g2 = torch.sum(probs * mask2, -1) * keep2
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    slot1 = _one_hot(pos_in1.long(), capacity)[:, None, :]
    slot2 = _one_hot(pos_in2.long(), capacity)[:, None, :]
    d1 = mask1[..., None] * slot1 * keep1[:, None, None]
    d2 = mask2[..., None] * slot2 * keep2[:, None, None]
    combine = g1[:, None, None] * d1 + g2[:, None, None] * d2
    return d1 + d2, combine, aux


class _AllGatherRows(torch.autograd.Function):
    """All-gather along dim 0; backward keeps this rank's rows of the
    summed cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        from .collective import all_gather

        ctx.group, ctx.rows = group, x.shape[0]
        return plain(all_gather(x.contiguous(), group=group))

    @staticmethod
    def backward(ctx, g):
        from .collective import all_reduce

        g = g.contiguous().clone()
        all_reduce(g, group=ctx.group)
        r = ctx.group.rank
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


class MoELayer(Layer):
    """Experts are per-expert FFNs (``w1`` ``[E, d, h]``, ``b1`` ``[E, 1,
    h]``, ``w2`` ``[E, h, d]``, ``b2`` ``[E, 1, d]``), this rank holding
    its ``E / ep`` of them; ``forward(x)`` takes this rank's tokens
    ``[..., d]``. ``aux_loss`` holds the last forward's gate loss."""

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 top_k=None, capacity_factor=1.25, activation=None,
                 mp_group=None, name=None, *, ep_group=None, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        from .mp_layers import _draw

        self._group = _ep_group(ep_group)
        n = self._group.nranks if self._group is not None else 1
        if num_experts % n:
            raise ValueError(f"{num_experts} experts do not split over {n} "
                             f"ep ranks")
        self.num_experts = num_experts
        self.local_experts = num_experts // n
        self.capacity_factor = capacity_factor
        self.gate_type = gate if isinstance(gate, str) else "gshard"
        self.top_k = top_k or (2 if self.gate_type == "gshard" else 1)
        dev = resolve_device(device)
        r = self._group.rank if self._group is not None else 0
        lo, hi = r * self.local_experts, (r + 1) * self.local_experts

        def param(shape, init, local=True):
            full = _draw(shape, dev, dtype, generator, init)
            return torch.nn.Parameter((full[lo:hi] if local else full)
                                      .contiguous())

        self.gate_weight = param([d_model, num_experts], "xavier",
                                 local=False)
        self.w1 = param([num_experts, d_model, d_hidden], "xavier")
        self.b1 = param([num_experts, 1, d_hidden], "zeros")
        self.w2 = param([num_experts, d_hidden, d_model], "xavier")
        self.b2 = param([num_experts, 1, d_model], "zeros")
        self.aux_loss = None

    def placements(self):
        from .checkpoint import Placement

        out = {"gate_weight": Placement(tuple(self.gate_weight.shape))}
        n = self._group.nranks if self._group is not None else 1
        for name in ("w1", "b1", "w2", "b2"):
            p = getattr(self, name)
            logical = (self.num_experts,) + tuple(p.shape[1:])
            out[name] = (Placement(logical) if n == 1 else Placement.offset(
                logical, tuple(p.shape), 0,
                self._group.rank * self.local_experts, "ep"))
        return out

    def forward(self, x):
        from .collective import all_gather
        from .sequence_parallel import _AllToAll

        x = plain(x)
        g = self._group
        n = g.nranks if g is not None else 1
        shape = x.shape
        d = shape[-1]
        xf = x.reshape(-1, d)
        N_local = xf.shape[0]
        logits = xf @ self.gate_weight
        if n > 1:
            logits = _AllGatherRows.apply(logits, g)
        N = logits.shape[0]
        E = self.num_experts
        capacity = max(int(self.capacity_factor * self.top_k * N / E), 4)
        if self.gate_type in ("gshard", "top2"):
            dispatch, combine, aux = top2_gating(logits, capacity)
        else:
            dispatch, combine, aux = top1_gating(logits, capacity)
        if n > 1:
            r = g.rank
            dispatch = dispatch[r * N_local:(r + 1) * N_local]
            combine = combine[r * N_local:(r + 1) * N_local]
        expert_in = torch.einsum("nec,nd->ecd", dispatch, xf.float())
        if n > 1:
            # block j (experts of rank j) to rank j; sum what every rank sent
            expert_in = _AllToAll.apply(
                expert_in.reshape(n, self.local_experts, capacity, d),
                g).sum(0)
        h = torch.einsum("ecd,edh->ech", expert_in, self.w1) + self.b1
        h = torch.nn.functional.gelu(h, approximate="tanh")
        expert_out = torch.einsum("ech,ehd->ecd", h, self.w2) + self.b2
        if n > 1:
            # every rank gets every expert's outputs for its tokens
            expert_out = _AllToAll.apply(
                expert_out.unsqueeze(0).expand(n, -1, -1, -1).contiguous(),
                g).reshape(E, capacity, d)
        out = torch.einsum("nec,ecd->nd", combine, expert_out)
        self.aux_loss = aux
        return out.reshape(shape).to(x.dtype)


def _ep_group(ep_group):
    from .collective import _resolve_group
    from .mesh import get_hybrid_communicate_group

    if ep_group is not None:
        return _resolve_group(ep_group)
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_expert_parallel_world_size() == 1:
        return None
    return hcg.group("ep")
