"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

Layout is ``[batch, seq, heads, head_dim]``. :func:`sdpa_ref` is the plain
einsum composition the reference uses off-TPU and the serving cache uses
for prefill; :func:`scaled_dot_product_attention` is the model's no-cache
attention and runs the flash-attention forward kernel on the card.
"""
from __future__ import annotations

import math

import torch

from ...kernels.flash_attention import flash_attention_fwd

__all__ = ["sdpa_ref", "scaled_dot_product_attention"]

NEG_INF = -1e30


def sdpa_ref(q, k, v, attn_mask=None, is_causal=False, scale=None):
    """Plain einsum attention, a transcription of the reference's
    ``sdpa_ref`` (without dropout). GQA by repeating KV heads (Hkv | Hq).
    Scores are computed in the inputs' dtype, softmax in f32, and the
    probabilities are cast back to q's dtype before the product with V —
    the reference's rounding points. ``attn_mask`` is a bool mask
    (True = attend) broadcastable to ``[B, H, Sq, Sk]``; causal uses the
    bottom-right diagonal."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if Hk != Hq:
        k = k.repeat_interleave(Hq // Hk, dim=2)
        v = v.repeat_interleave(Hq // Hk, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg = torch.full_like(logits, NEG_INF)
    if is_causal:
        vis = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(
            Sk - Sq)
        logits = torch.where(vis, logits, neg)
    if attn_mask is not None:
        if attn_mask.dtype != torch.bool:
            raise TypeError(f"sdpa_ref takes a bool attn_mask; got "
                            f"{attn_mask.dtype}")
        logits = torch.where(attn_mask, logits, neg)
    acc_t = torch.promote_types(logits.dtype, torch.float32)
    probs = torch.softmax(logits.to(acc_t), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, is_causal=False,
                                 scale=None):
    """Dense attention, ``[B, S, H, D]`` layout, GQA when the KV heads
    divide the query heads. The flash-attention forward kernel on CUDA
    tensors, its plain version on CPU tensors. Masks and dropout are not
    in this slice."""
    out, _ = flash_attention_fwd(query, key, value, causal=is_causal,
                                 sm_scale=scale)
    return out
