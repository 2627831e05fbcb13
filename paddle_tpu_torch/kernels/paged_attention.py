"""Ragged paged attention (decode): CUDA kernel and plain version.

Replaces ``paddle_tpu/kernels/paged_attention.py`` ``_paged_kernel`` (its
``pallas_call`` in ``paged_attention_pallas``). The kernel is
``csrc/paged_attention.cu``; the plain version below repeats
``paged_attention_ref`` of the reference in PyTorch.

For one query token per slot,

    out[s] = softmax(q[s] @ K[s, :ctx[s]]^T * scale) @ V[s, :ctx[s]]

with K/V gathered through the slot's block table from one layer's pool
``[num_blocks, 2, kv_heads, block_size, head_dim]``.

What bounds it on the H100: bytes (each live K/V row is read once for
``rep = q_heads / kv_heads`` dot products). The kernel runs one thread block
per (slot, kv head) and loops over the slot's context inside the block
(a GPU grid carries nothing from one block to the next, unlike the TPU's
sequential grid axis), 64 tokens a step with 16-byte loads through the
block table; it reads only the tokens below ``ctx``, keeps the
online-softmax state in f32 and writes the output in q's dtype. With few slots the grid is smaller than the card's
132 SMs; splitting the block loop across thread blocks is later work.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, _build, use_kernel

__all__ = ["paged_attention", "paged_attention_plain", "paged_attention_cuda"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def paged_attention_plain(q, kv_pool, block_tables, context_lens, *,
                          sm_scale=None):
    """PyTorch transcription of the reference's ``paged_attention_ref``.

    q:            [slots, num_q_heads, head_dim] — one query token per slot
    kv_pool:      [num_blocks, 2, kv_heads, block_size, head_dim]
    block_tables: int [slots, max_blocks] pool indices per slot
    context_lens: int [slots] valid tokens per slot; positions >= ctx are
                  masked
    returns       [slots, num_q_heads, head_dim] in q's dtype
    """
    S, Hq, D = q.shape
    _, _, Hkv, bs, _ = kv_pool.shape
    M = block_tables.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    rep = Hq // Hkv
    pages = kv_pool[block_tables.long()]          # [S, M, 2, Hkv, bs, D]
    k = pages[:, :, 0].permute(0, 2, 1, 3, 4).reshape(S, Hkv, M * bs, D)
    v = pages[:, :, 1].permute(0, 2, 1, 3, 4).reshape(S, Hkv, M * bs, D)
    qg = (q.float() * scale).reshape(S, Hkv, rep, D)
    logits = torch.einsum("shrd,shtd->shrt", qg, k.float())
    pos = torch.arange(M * bs, device=q.device)
    valid = pos[None, :] < context_lens.long()[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("shrt,shtd->shrd", probs, v.float())
    return out.reshape(S, Hq, D).to(q.dtype)


def paged_attention_cuda(q, kv_pool, block_tables, context_lens, *,
                         sm_scale=None):
    """Launch ``csrc/paged_attention.cu``; same contract as
    :func:`paged_attention_plain`. Raises on what the kernel does not take."""
    S, Hq, D = q.shape
    N, two, Hkv, bs, Dp = kv_pool.shape
    M = block_tables.shape[1]
    if two != 2 or Dp != D or Hq % Hkv:
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)} does not fit pool "
            f"{tuple(kv_pool.shape)}")
    if block_tables.shape[0] != S or context_lens.shape != (S,):
        raise ValueError("paged_attention: tables/context lengths must "
                         "have one row per slot")
    if q.dtype not in _DTYPES or kv_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16 q and pool "
            f"of one dtype; got {q.dtype} and {kv_pool.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block tables and context lengths "
                        "must be int32")
    if not kv_pool.is_contiguous():
        raise ValueError("paged_attention: the pool must be contiguous")
    if (D * q.element_size()) % 16 or kv_pool.data_ptr() % 16:
        raise ValueError("paged_attention kernel: K/V rows must be a "
                         "multiple of 16 bytes and the pool 16-byte aligned "
                         "(16-byte vector loads)")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q = q.contiguous()
    bt = block_tables.contiguous()
    ctx = context_lens.contiguous()
    out = torch.empty_like(q)
    fn = _build.function(
        "paged_attention", "paged_attention_fwd",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), kv_pool.data_ptr(), bt.data_ptr(), ctx.data_ptr(),
             out.data_ptr(), S, Hq, Hkv, bs, D, M, float(scale),
             _DTYPES[q.dtype], stream)
    _build.check(err, "paged_attention", "paged_attention_fwd launch")
    LAUNCHES["paged_attention"] += 1
    return out


def paged_attention(q, kv_pool, block_tables, context_lens, *, sm_scale=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    impl = (paged_attention_cuda
            if use_kernel(q, kv_pool, block_tables, context_lens)
            else paged_attention_plain)
    return impl(q, kv_pool, block_tables, context_lens, sm_scale=sm_scale)
