"""Flash attention forward: CUDA kernel and plain version.

Replaces ``paddle_tpu/kernels/flash_attention.py`` ``_fwd_kernel`` (its
``pallas_call`` in ``_core_fwd``; public ``flash_attention_pallas``) for the
dense case: causal or not, no mask, no segment ids, no dropout. Those
options, and the backward kernels, are later slices (ROADMAP Queue 2). The
kernel is ``csrc/flash_attention.cu``; the plain version below repeats the
reference's ``_mirror_fwd`` in PyTorch.

Layout is the reference's public one: q ``[B, Sq, H, D]``, k/v
``[B, Sk, Hkv, D]`` with ``H % Hkv == 0``. Returns ``(out, lse)``, out
``[B, Sq, H, D]`` in q's dtype and lse ``[B, H, Sq]`` f32. Causal means
query i attends key j iff ``j <= i + (Sk - Sq)``.

What bounds it on the H100: at long S, the flops (``4 * Sq * Sk * D`` per
head, about half of that causal) against the bf16 tensor-core peak. The
kernel tiles 64 queries by 64 keys through shared memory with the online
softmax in f32, stops causal rows at the diagonal and masks ragged S
itself. In bf16 both products run on the tensor cores (``mma.sync``, f32
accumulation; the probabilities are rounded to bf16 before P.V, as in
FlashAttention); in f32 on the CUDA cores. ``wgmma``/TMA tiles are the next
step toward the bound (PERF.md).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, _build, use_kernel

__all__ = ["flash_attention_fwd", "flash_attention_plain",
           "flash_attention_cuda"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_shapes(q, k, v, causal):
    B, Sq, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit [B, S, H, D] with Hkv | H")
    if causal and Sq > k.shape[1]:
        raise ValueError("flash_attention: causal needs Sq <= Sk")


def flash_attention_plain(q, k, v, causal=False, sm_scale=None):
    """PyTorch transcription of the reference's ``_mirror_fwd``: f32
    scores, f32 softmax, out cast to q's dtype; returns ``(out, lse)``."""
    _check_shapes(q, k, v, causal)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        vis = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(
            Sk - Sq)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.float()).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def flash_attention_cuda(q, k, v, causal=False, sm_scale=None):
    """Launch ``csrc/flash_attention.cu``; same contract as
    :func:`flash_attention_plain`. Raises on what the kernel does not take."""
    _check_shapes(q, k, v, causal)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}; got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: q, k, v must be 16-byte "
                         "aligned (16-byte vector loads)")
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32)
    fn = _build.function(
        "flash_attention", "flash_attention_fwd",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, H, Hkv, Sq, Sk, D, float(scale),
             int(bool(causal)), _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention", "flash_attention_fwd launch")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    impl = (flash_attention_cuda if use_kernel(q, k, v)
            else flash_attention_plain)
    return impl(q, k, v, causal=causal, sm_scale=sm_scale)
