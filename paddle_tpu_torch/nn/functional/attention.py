"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

Layout is ``[batch, seq, heads, head_dim]``. :func:`sdpa_ref` is the plain
einsum composition the reference uses off-TPU, the serving cache uses for
prefill, and float additive masks use everywhere;
:func:`scaled_dot_product_attention` is the model's attention and runs the
flash-attention kernels on the card, dropout and bool masks included;
:func:`flash_attention` is the reference's API shape of the same, and
:func:`flash_attn_unpadded` its varlen entry over packed sequences.
"""
from __future__ import annotations

import math

import torch

from ...framework.random import get_generator
from ...kernels.flash_attention import flash_attention_fwd, flash_attn_varlen

__all__ = ["sdpa_ref", "scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded"]

NEG_INF = -1e30


def sdpa_ref(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False,
             scale=None, training=True, generator=None):
    """Plain einsum attention, a transcription of the reference's
    ``sdpa_ref``. GQA by repeating KV heads (Hkv | Hq). Scores are computed
    in the inputs' dtype, softmax in f32, and the probabilities are cast
    back to q's dtype before the product with V: the reference's rounding
    points. ``attn_mask`` is a bool mask (True = attend) or a float
    additive bias, broadcastable to ``[B, H, Sq, Sk]``; causal uses the
    bottom-right diagonal. In training, ``dropout_p`` drops probabilities
    (upscale-in-train) with a keep mask from ``generator`` (default:
    ``framework.random``'s generator of q's device), so it agrees with the
    reference in distribution, not in bits."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if Hk != Hq:
        k = k.repeat_interleave(Hq // Hk, dim=2)
        v = v.repeat_interleave(Hq // Hk, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if is_causal:
        vis = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(
            Sk - Sq)
        logits = torch.where(vis, logits, torch.full_like(logits, NEG_INF))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits,
                                 torch.full_like(logits, NEG_INF))
        else:
            logits = logits + attn_mask
    acc_t = torch.promote_types(logits.dtype, torch.float32)
    probs = torch.softmax(logits.to(acc_t), dim=-1).to(q.dtype)
    if dropout_p and training:
        g = generator if generator is not None else get_generator(q.device)
        keep = torch.rand(probs.shape, device=q.device, generator=g) \
            < (1.0 - dropout_p)
        probs = probs * keep.to(probs.dtype) / (1.0 - dropout_p)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None,
                                 seed=None):
    """Attention in the ``[B, S, H, D]`` layout, GQA when the KV heads
    divide the query heads; differentiable in query, key and value. Routes
    as the reference's ``flash_attention_pallas`` does:

    - no mask, or a bool mask (True = attend; any shape broadcastable to
      ``[B, H, Sq, Sk]``, read by the kernels without being widened): the
      flash-attention kernels on CUDA tensors (forward, and backward under
      autograd), their plain versions on CPU tensors, which mask as the
      reference's ``_mirror_fwd`` does (a row whose every visible key is
      masked averages V over the hidden keys, not zeros); dropout is
      applied in-kernel (``seed`` fixes its mask; by default one is drawn
      on the host); the mask gets no gradient;
    - a float additive mask: :func:`sdpa_ref`, so the bias differentiates.
    """
    if not training:
        dropout_p = 0.0
    if attn_mask is None or attn_mask.dtype == torch.bool:
        out, _ = flash_attention_fwd(query, key, value, causal=is_causal,
                                     sm_scale=scale, dropout_p=dropout_p,
                                     seed=seed, mask=attn_mask)
        return out
    return sdpa_ref(query, key, value, attn_mask=attn_mask,
                    dropout_p=dropout_p, is_causal=is_causal, scale=scale,
                    training=training)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """The reference's ``flash_attention`` API shape over
    :func:`scaled_dot_product_attention` (no mask): returns ``(out, None)``
    (the kernels materialise no softmax). ``fixed_seed_offset`` fixes the
    dropout mask's seed."""
    out = scaled_dot_product_attention(
        query, key, value, dropout_p=dropout, is_causal=causal,
        training=training, seed=fixed_seed_offset)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen (packed-sequence) flash attention, the reference's
    ``flash_attn_unpadded``: query ``[total_q, H, D]``, key and value
    ``[total_k, Hkv, D]``, ``cu_seqlens_*`` int32 ``[nseq + 1]`` cumulative
    offsets from 0. Tokens attend within their own sequence; ``causal`` is
    positional in the packed rows and needs ``cu_seqlens_q ==
    cu_seqlens_k`` (raises otherwise); tokens past ``cu_seqlens[-1]`` get
    zeros. The kernels on CUDA tensors, the plain versions on CPU tensors,
    differentiable in query, key and value. Eager, ``cu_seqlens`` is
    copied to the host once a call (it sizes the kernels' grid), so
    ``max_seqlen_*`` are taken for the API and not needed; inside a
    compiled or exported program they size the grid (no host read), the
    total tokens where they are None. Returns ``(out, None)``."""
    if not training:
        dropout = 0.0
    out, _ = flash_attn_varlen(query, key, value, cu_seqlens_q, cu_seqlens_k,
                               causal=causal, sm_scale=scale,
                               dropout_p=dropout, seed=fixed_seed_offset,
                               max_seqlen_q=max_seqlen_q,
                               max_seqlen_k=max_seqlen_k)
    return out, None
