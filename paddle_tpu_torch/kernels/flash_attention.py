"""Flash attention, forward and backward: CUDA kernels, plain versions and
the autograd Function that joins them.

Replaces ``paddle_tpu/kernels/flash_attention.py`` ``_fwd_kernel`` (its
``pallas_call`` in ``_core_fwd``) and ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel`` (in ``_flash_core_bwd``), whose ``custom_vjp`` over
``(out, lse)`` becomes :class:`FlashAttentionFunction`, for the dense
case: causal or not, no mask, no segment ids, no dropout. Those options
are a later slice (ROADMAP Queue 2). The kernels are
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(dQ, then dK/dV); the plain versions repeat the reference's
``_mirror_fwd`` and ``_mirror_bwd`` in PyTorch.

Layout is the reference's public one: q ``[B, Sq, H, D]``, k/v
``[B, Sk, Hkv, D]`` with ``H % Hkv == 0``. The forward returns
``(out, lse)``, out ``[B, Sq, H, D]`` in q's dtype and lse ``[B, H, Sq]``
f32; both are differentiable, and the lse cotangent folds into the
backward as ``ds = p * (dp - delta + g_lse)``, as the reference's does
(ring attention merges per-block ``(out, lse)``). Causal means query i
attends key j iff ``j <= i + (Sk - Sq)``.

What bounds the kernels on the H100: at long S, the flops (``4 * Sq * Sk
* D`` per head forward, 2.5 times that backward, about half of each
causal) against the bf16 tensor-core peak. The forward tiles 64 queries
by 64 keys through shared memory with the online softmax in f32; the
backward runs FlashAttention-2's two kernels (dQ per query tile; dK/dV per
key tile, looping over the query heads of its KV group, so GQA needs no
atomics). All stop causal rows at the diagonal and mask ragged S
themselves. In bf16 the products run on the tensor cores (``mma.sync``,
f32 accumulation; probabilities and ds are rounded to bf16 as operands,
as in FlashAttention); in f32 on the CUDA cores. ``wgmma``/TMA tiles are
the next step toward the bound (PERF.md).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, _build, refuse_grad, use_kernel

__all__ = ["flash_attention_fwd", "flash_attention_plain",
           "flash_attention_cuda", "flash_attention_bwd_plain",
           "flash_attention_bwd_cuda", "delta_minus_glse",
           "FlashAttentionFunction"]

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


def _kernel_inputs(what, q, k, v, causal, *more):
    """Check what the kernels take; returns contiguous q, k, v, *more."""
    _check_shapes(q, k, v, causal)
    D = q.shape[3]
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in {_HEAD_DIMS}; "
                         f"got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    out = [t.contiguous() for t in (q, k, v, *more)]
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError(f"{what} kernel: q, k, v and the gradient must be "
                         f"16-byte aligned (16-byte vector loads)")
    return out


def flash_attention_cuda(q, k, v, causal=False, sm_scale=None):
    """Launch ``csrc/flash_attention.cu``; same contract as
    :func:`flash_attention_plain`. Raises on what the kernel does not take."""
    refuse_grad("flash_attention_cuda", q, k, v)
    q, k, v = _kernel_inputs("flash_attention", q, k, v, causal)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
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


def delta_minus_glse(out, g, g_lse=None):
    """``dg = rowsum(dO * O) - g_lse`` [B, H, Sq] f32, what both backward
    versions take per query row (the reference computes delta in jnp
    outside its kernels too)."""
    dg = (g.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        dg = dg - g_lse.float()
    return dg.contiguous()


def flash_attention_bwd_plain(q, k, v, g, lse, dg, causal=False,
                              sm_scale=None):
    """PyTorch transcription of the reference's ``_mirror_bwd``, GQA
    included (dK/dV summed over the query heads of a KV group): from the
    forward's lse and ``dg = delta - g_lse`` (:func:`delta_minus_glse`),
    returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    _check_shapes(q, k, v, causal)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf, gf = q.float(), g.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    if causal:
        vis = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(
            Sk - Sq)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    ds = p * (dp - dg[..., None])
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if rep > 1:
        dk = dk.reshape(B, Sk, Hkv, rep, D).sum(3)
        dv = dv.reshape(B, Sk, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_cuda(q, k, v, g, lse, dg, causal=False,
                             sm_scale=None):
    """Launch ``csrc/flash_attention_bwd.cu`` (the dQ kernel, then the
    dK/dV kernel); same contract as :func:`flash_attention_bwd_plain`."""
    refuse_grad("flash_attention_bwd_cuda", q, k, v, g, lse, dg)
    q, k, v, g = _kernel_inputs("flash_attention_bwd", q, k, v, causal, g)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: the gradient must match q in "
                         "shape and dtype")
    for name, t in (("lse", lse), ("dg", dg)):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"[B, H, Sq] float32")
    lse, dg = lse.contiguous(), dg.contiguous()
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)  # Sq == 0: no launch
    fn = _build.function(
        "flash_attention_bwd", "flash_attention_bwd",
        [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), dg.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), B, H, Hkv, Sq, Sk, D, float(scale),
             int(bool(causal)), _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention_bwd", "flash_attention_bwd launch")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``(q, k, v, causal, sm_scale) -> (out, lse)``, differentiable in q,
    k and v through both outputs. The kernels for CUDA tensors, the plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        cuda = use_kernel(q, k, v)
        out, lse = (flash_attention_cuda if cuda else flash_attention_plain)(
            q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.cuda, ctx.causal, ctx.sm_scale = cuda, causal, sm_scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dg = delta_minus_glse(out, g, g_lse)
        bwd = flash_attention_bwd_cuda if ctx.cuda else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, g, lse, dg, causal=ctx.causal,
                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """``(out, lse)`` through :class:`FlashAttentionFunction`: the kernels
    for CUDA tensors, the plain versions for CPU tensors; differentiable."""
    return FlashAttentionFunction.apply(q, k, v, causal, sm_scale)
