"""Sequence / context parallelism over the ``sep`` axis (counterpart of
``paddle_tpu/distributed/sequence_parallel.py``).

Each ``sep`` rank holds one contiguous block of the sequence of q, k and
v (``[B, S / n, H, D]``, rank ``r`` the ``r``-th block).

- :func:`ring_attention`: K/V rotate one hop a tick around the group;
  each tick runs the flash kernel on the block that is resident (full
  when it came from an earlier rank, causal on the diagonal, skipped when
  it came from a later one under ``causal``) and merges the kernel's
  ``(out, lse)`` into the running result with the online-softmax rule
  (:func:`merge_partials`, the reference's ``_merge_partials``). The
  rotation is a differentiable ``ppermute`` (its backward sends the
  cotangents the other way) and the flash kernel takes the lse
  cotangent, so the backward is the kernels' backward per block.
- :func:`ulysses_attention`: two all-to-alls turn the sequence split into
  a head split (``[B, S, H / n, D]``), the flash kernel attends over the
  whole sequence, and two more turn it back.

A group of one rank runs plain flash attention.
"""
from __future__ import annotations

import math

import torch

from ..core.tensor import plain

__all__ = ["ring_attention", "ulysses_attention", "merge_partials",
           "block_flash"]

NEG_INF = -1e30


def _sep_group(group, axis):
    from .collective import _resolve_group
    from .mesh import get_hybrid_communicate_group

    if group is not None:
        return _resolve_group(group)
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return None
    return hcg.group(axis)


class _Shift(torch.autograd.Function):
    """``ppermute`` by one hop (rank i -> i + 1); backward the other
    way."""

    @staticmethod
    def forward(ctx, x, group):
        from .collective import ppermute

        ctx.group = group
        n = group.nranks
        return plain(ppermute(x, [(i, (i + 1) % n) for i in range(n)],
                              group=group))

    @staticmethod
    def backward(ctx, g):
        from .collective import ppermute

        n = ctx.group.nranks
        return plain(ppermute(g.contiguous(),
                              [((i + 1) % n, i) for i in range(n)],
                              group=ctx.group)), None


class _Anchor(torch.autograd.Function):
    """``x`` as it is, with ``kv`` joined to its graph: the last rotated
    K/V block becomes an input of the result on every rank, so every
    rank runs every rotation's backward (a causal rank that skipped the
    block would otherwise leave its peers' sends unanswered)."""

    @staticmethod
    def forward(ctx, x, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv
        return g, torch.zeros(shape, dtype=dtype, device=device)


def block_flash(q, k, v, sm_scale, causal):
    """One ring block through the flash kernel: ``(out [B, S, H, D],
    lse [B, H, S] f32)``, differentiable through both."""
    from ..kernels.flash_attention import flash_attention_fwd

    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)


def merge_partials(o1, lse1, o2, lse2):
    """Online-softmax merge of two normalised partials (o ``[B, S, H,
    D]``, lse ``[B, H, S]``); returns the merged pair, o in f32."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = torch.clamp(w1 + w2, min=1e-30)
    sw = lambda w: w.transpose(1, 2).unsqueeze(-1)   # [B, S, H, 1]
    out = (o1.float() * sw(w1) + o2.float() * sw(w2)) / sw(denom)
    return out, m + torch.log(denom)


def ring_attention(q, k, v, mesh=None, axis="sep", causal=True, scale=None,
                   group=None):
    """q, k, v: this rank's sequence block ``[B, S / n, H, D]`` (GQA: k/v
    with fewer heads). Returns this rank's block of the attention output,
    in q's dtype."""
    q, k, v = plain(q), plain(k), plain(v)
    g = _sep_group(group, axis)
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if g is None or g.nranks == 1:
        return block_flash(q, k, v, sm_scale, causal)[0]
    n, my = g.nranks, g.rank
    B, Sl, H, D = q.shape
    out = torch.zeros((B, Sl, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Sl), NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack([k, v])        # one rotation a tick carries both
    for r in range(n):
        src = (my - r) % n          # the rank this K/V block came from
        if not causal or src <= my:
            o_b, lse_b = block_flash(q, kv[0], kv[1], sm_scale,
                                     causal and src == my)
            out, lse = merge_partials(out, lse, o_b, lse_b)
        if r < n - 1:
            kv = _Shift.apply(kv, g)
    return _Anchor.apply(out, kv).to(q.dtype)


class _AllToAll(torch.autograd.Function):
    """Block all-to-all over dim 0 (block ``j`` to rank ``j``); it is its
    own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        from .collective import all_to_all

        ctx.group = group
        return plain(all_to_all(x.contiguous(), group=group))

    @staticmethod
    def backward(ctx, g):
        from .collective import all_to_all

        return plain(all_to_all(g.contiguous(), group=ctx.group)), None


def ulysses_attention(q, k, v, mesh=None, axis="sep", causal=True,
                      scale=None, attn_fn=None, group=None):
    """Ulysses: all-to-all from a sequence split to a head split, full
    attention (``attn_fn(q, k, v)``; default the flash kernel) per head
    group, all-to-all back. Needs the (KV) head counts divisible by the
    group size."""
    from ..nn.functional import scaled_dot_product_attention

    q, k, v = plain(q), plain(k), plain(v)
    attn = attn_fn or (lambda a, b, c: scaled_dot_product_attention(
        a, b, c, is_causal=causal, scale=scale))
    g = _sep_group(group, axis)
    if g is None or g.nranks == 1:
        return attn(q, k, v)
    n = g.nranks

    def seq_to_head(x):
        B, Sl, H, D = x.shape
        xs = x.reshape(B, Sl, n, H // n, D).permute(2, 0, 1, 3, 4)
        xs = _AllToAll.apply(xs, g)          # [n (seq block), B, Sl, H/n, D]
        return xs.permute(1, 0, 2, 3, 4).reshape(B, n * Sl, H // n, D)

    def head_to_seq(x):
        B, S, Hl, D = x.shape
        xs = x.reshape(B, n, S // n, Hl, D).permute(1, 0, 2, 3, 4)
        xs = _AllToAll.apply(xs, g)          # [n (head group), B, S/n, Hl, D]
        return xs.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hl, D)

    out = attn(seq_to_head(q), seq_to_head(k), seq_to_head(v))
    return head_to_seq(out)
