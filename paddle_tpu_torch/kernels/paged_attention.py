"""Ragged paged attention (decode): CUDA kernel and plain version.

Replaces ``paddle_tpu/kernels/paged_attention.py`` ``_paged_kernel`` (its
``pallas_call`` in ``paged_attention_pallas``). The kernel is
``csrc/paged_attention.cu``; the plain version below repeats
``paged_attention_ref`` of the reference in PyTorch.

For one query token per slot,

    out[s] = softmax(q[s] @ K[s, :ctx[s]]^T * scale) @ V[s, :ctx[s]]

with K/V gathered through the slot's block table from one layer's pool
``[num_blocks, 2, kv_heads, block_size, head_dim]``.

What bounds it on the H100: bytes. Each live K/V row is read once for
``rep = q_heads / kv_heads`` dot products, 1-8 flops a byte, so tensor
cores would not help; the kernel streams the pages and keeps every
product and the softmax in f32 on the CUDA cores. The byte bound is the
live K/V (``2 * sum(ctx) * kv_heads * head_dim`` elements), q, out and
the live table entries over 3.35 TB/s.

The kernel is flash-decoding: the grid is ``(splits, kv_heads * qg,
slots)``, each block owns ``pps`` table entries of one slot and streams
their K/V rows into shared memory by bulk asynchronous copies through a
ring of mbarrier stages, four warps each keeping online softmaxes in
registers; splits merge deterministically, in split order, in the last
block to finish. :func:`launch_plan` fixes the whole launch from the
shapes alone, never from ``context_lens`` (the decode loop does not sync
with the host, and a CUDA graph can capture the launch):
:func:`split_plan` sizes the splits so the grid holds about ``WAVES``
waves of 132 blocks when every slot's context is full (4, from a probe
of 2-16 recorded in ``PERF.md``); blocks whose run lies past a slot's
``ctx`` exit at once.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import LAUNCHES, _build, in_program, route, use_kernel
from ..core.tensor import bound_public

__all__ = ["paged_attention", "paged_attention_plain", "paged_attention_cuda",
           "split_plan", "launch_plan", "LaunchPlan"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kept equal to csrc/paged_attention.cu
STAGE_BYTES = 8192      # K rows + V rows of one ring stage
PPS_MAX = 256           # table entries a block caches in shared memory
# f32 registers a lane spends on its query rows' vectors (and as many on
# their accumulators): R * NC * (16 / element size) <= ROW_REGS
ROW_REGS = 64
SMS = 132               # H100 SXM streaming multiprocessors
WAVES = 4               # the split plan's target, in waves of SMS blocks


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


def _cdiv(a, b):
    return -(-a // b)


def split_plan(slots, groups, M):
    """``(splits, pps)``: the grid's split count and the table entries each
    split owns, from shapes alone. ``groups`` is the blocks a slot has per
    split (kv heads times query groups), ``M`` the block table's width.
    Split ``i`` owns entries ``[i * pps, min(M, (i + 1) * pps))``: every
    entry lies in exactly one split and none is empty. The runs are equal
    but the last, and about as many as give ``WAVES * SMS`` blocks when
    every context is full (at least half of that where the table has the
    pages; more when a run would pass ``PPS_MAX`` entries)."""
    if slots < 1 or groups < 1 or M < 1:
        raise ValueError(f"split_plan: slots {slots}, groups {groups}, "
                         f"table width {M} must be positive")
    want = max(_cdiv(WAVES * SMS, slots * groups), _cdiv(M, PPS_MAX))
    pps = _cdiv(M, min(want, M))
    return _cdiv(M, pps), pps


class LaunchPlan(NamedTuple):
    """How ``csrc/paged_attention.cu`` lays one call out.

    lpr:    lanes a K/V row (a power of two); 32 / lpr rows at once a warp
    nc:     16-byte vectors a lane holds of a row (1, 2 or 4)
    r:      query rows a block (1, 2, 4 or 8)
    qg:     query groups a kv head (``qg * r >= rep``)
    ch:     rows a ring stage holds (divides the block size)
    splits: runs of the block table (grid dim x)
    pps:    table entries a run
    """
    lpr: int
    nc: int
    r: int
    qg: int
    ch: int
    splits: int
    pps: int


def launch_plan(slots, q_heads, kv_heads, block_size, head_dim, M,
                element_size):
    """The kernel's :class:`LaunchPlan` for these shapes (no tensor
    values). Raises on a head too wide for the kernel's registers."""
    vec = 16 // element_size
    nvec = head_dim // vec
    lpr = min(32, 1 << max(0, nvec - 1).bit_length())
    nc = _cdiv(nvec, lpr)
    if nc > 4:
        raise ValueError(
            f"paged_attention kernel: head_dim {head_dim} is wider than "
            f"{128 * vec} at {element_size}-byte elements")
    nc = 4 if nc == 3 else nc
    rep = q_heads // kv_heads
    r = min(1 << max(0, rep - 1).bit_length(), 8, ROW_REGS // (nc * vec))
    row_bytes = head_dim * element_size
    ch = max(c for c in range(1, block_size + 1)
             if block_size % c == 0 and 2 * c * row_bytes <= STAGE_BYTES)
    qg = _cdiv(rep, r)
    return LaunchPlan(lpr, nc, r, qg, ch,
                      *split_plan(slots, kv_heads * qg, M))


# per device: arrival counters of the split merge, all 0 between launches
# (the last block of each (slot, group) resets its own), grown on demand
_SEMAPHORES: dict[torch.device, torch.Tensor] = {}


def _semaphores(device, n):
    sem = _SEMAPHORES.get(device)
    if sem is None or sem.numel() < n:
        sem = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _SEMAPHORES[device] = sem
    return sem


def paged_attention_cuda(q, kv_pool, block_tables, context_lens, *,
                         sm_scale=None):
    """Launch ``csrc/paged_attention.cu``; same contract as
    :func:`paged_attention_plain` (but zeros where ``ctx <= 0``). Raises on
    what the kernel does not take."""
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
    if M < 1:
        raise ValueError("paged_attention: the block table has no column")
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
                         "(bulk copies of whole rows)")
    plan = launch_plan(S, Hq, Hkv, bs, D, M, q.element_size())
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q = q.contiguous()
    if q.data_ptr() % 16:             # a view into its storage: realign
        q = q.clone()
    bt = block_tables.contiguous()
    ctx = context_lens.contiguous()
    out = torch.empty_like(q)
    if S == 0:
        return out
    part = sem = None
    if plan.splits > 1:
        # each split's acc [S, Hq, splits, D], then its (m, l)
        part = torch.empty(S * Hq * plan.splits * (D + 2),
                           dtype=torch.float32, device=q.device)
        sem = _semaphores(q.device, S * Hkv * plan.qg)
    fn = _build.function(
        "paged_attention", "paged_attention_fwd",
        [_P] * 7 + [_I] * 13 + [_F, _I, _P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), kv_pool.data_ptr(), bt.data_ptr(), ctx.data_ptr(),
             out.data_ptr(), None if part is None else part.data_ptr(),
             None if sem is None else sem.data_ptr(), S, Hq, Hkv, bs, D, M,
             plan.qg, plan.r, plan.nc, plan.lpr, plan.ch, plan.splits,
             plan.pps, float(scale), _DTYPES[q.dtype], stream)
    _build.check(err, "paged_attention", "paged_attention_fwd launch")
    LAUNCHES["paged_attention"] += 1
    return out


def paged_attention(q, kv_pool, block_tables, context_lens, *, sm_scale=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors, the
    registered op (``library.py``) inside a program."""
    if in_program(q, kv_pool):
        return torch.ops.paddle_tpu_torch.paged_attention(
            q, kv_pool, block_tables, context_lens, sm_scale)
    return route("paged_attention",
                 use_kernel(q, kv_pool, block_tables, context_lens),
                 paged_attention_cuda, paged_attention_plain, q, kv_pool,
                 block_tables, context_lens, sm_scale=sm_scale)


# public entry points hand back Tensors when a Tensor came in
bound_public(globals())
