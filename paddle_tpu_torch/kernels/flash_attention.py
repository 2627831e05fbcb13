"""Flash attention, forward and backward: CUDA kernels, plain versions and
the autograd Function that joins them.

Replaces ``paddle_tpu/kernels/flash_attention.py`` ``_fwd_kernel`` (its
``pallas_call`` in ``_core_fwd``) and ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel`` (in ``_flash_core_bwd``), whose ``custom_vjp`` over
``(out, lse)`` becomes :class:`FlashAttentionFunction`: causal or not,
with or without dropout on the probabilities; masks and segment ids are a
later slice (ROADMAP Queue 2). The kernels are ``csrc/flash_attention.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (dQ, then dK/dV); the plain
versions repeat the reference's ``_mirror_fwd`` and ``_mirror_bwd`` in
PyTorch.

Dropout (the reference's ``_drop_mask``): the keep bit of score
``(b * H + h, i, j)`` is a pure function of ``(seed, b * H + h, i, j)``
(:func:`dropout_bits_plain`; in CUDA ``drop_row_key``/``drop_bits`` of
``csrc/common.cuh``, shared by all three kernels), never of a tile, so
the backward kernels regenerate the forward's mask although they tile
otherwise. The TPU keyed its bits per (q-block, k-block) tile, which only
holds while every kernel uses the same tiles. As in the reference, ``l``
sums the un-dropped p, ``p * z / (1 - p)`` feeds ``P.V`` and ``dV``,
``dP`` is multiplied by ``z / (1 - p)``, and ``delta = rowsum(dO * O)``
is unchanged. The plain versions compute the same bits in ``torch.int64``
ops, so kernel and plain version apply the same mask, bit for bit.

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

Head widths 36, 64 and 128. 36 (the Conformer's 144 over 4 heads) rides
zero-padded to 48 in the kernels' shared-memory tiles, since the
tensor-core product steps its depth by 16; its rows start only 8-byte
aligned, so it moves in 8-byte chunks, and only the 36 real columns are
stored. The softmax scale stays ``1 / sqrt(36)`` and the dropout bits do
not depend on the width.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..framework.random import next_seed
from . import LAUNCHES, _build, plain_math, refuse_grad, use_kernel

__all__ = ["flash_attention_fwd", "flash_attention_plain",
           "flash_attention_cuda", "flash_attention_bwd_plain",
           "flash_attention_bwd_cuda", "delta_minus_glse",
           "dropout_bits_plain", "dropout_bits_cuda", "dropout_keep_plain",
           "FlashAttentionFunction"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (36, 64, 128)   # 36: the Conformer's 144 / 4
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# dropout keep bits (the same function as csrc/common.cuh)
# ---------------------------------------------------------------------------

def _mul32(a, c):
    """``a * c mod 2^32`` for int64 tensors ``a`` in [0, 2^32) and a 32-bit
    constant ``c``, in two 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits_plain(seed, BH, Sq, Sk, device=None):
    """The raw 32 bits of every score ``[BH, Sq, Sk]`` (int64 in
    [0, 2^32)), bh = b * H + h over query heads; a score is kept iff its
    bits are >= ``dropout_threshold(p)``."""
    bh = torch.arange(BH, device=device, dtype=torch.int64)[:, None, None]
    i = torch.arange(Sq, device=device, dtype=torch.int64)[None, :, None]
    j = torch.arange(Sk, device=device, dtype=torch.int64)[None, None, :]
    kbh = _fmix32(_fmix32((_mul32(bh, 0x9E3779B9) + 0x7F4A7C15) & _M32)
                  ^ (int(seed) & _M32))
    krow = _fmix32(kbh ^ ((_mul32(i, 0x85EBCA77) + 0x165667B1) & _M32))
    return _fmix32((krow + _mul32(j, 0x9E3779B9)) & _M32)


def dropout_threshold(p):
    """``floor(p * 2^32)``, capped at ``2^32 - 1``: keep iff bits >= it."""
    return min(int(p * 2.0 ** 32), _M32)


def dropout_keep_plain(seed, B, H, Sq, Sk, dropout_p, device=None):
    """Bool keep mask ``[B, H, Sq, Sk]`` of the kernels' dropout."""
    bits = dropout_bits_plain(seed, B * H, Sq, Sk, device)
    return (bits >= dropout_threshold(dropout_p)).reshape(B, H, Sq, Sk)


def _drop_mult(seed, B, H, Sq, Sk, dropout_p, device):
    """``z / (1 - p)`` f32 ``[B, H, Sq, Sk]``, as the reference's
    ``_mirror_dropmask`` scales its keep mask."""
    keep = dropout_keep_plain(seed, B, H, Sq, Sk, dropout_p, device)
    return keep.float() / (1.0 - dropout_p)


def dropout_bits_cuda(seed, BH, Sq, Sk, device):
    """The CUDA side's bits (``flash_dropout_bits`` of
    ``csrc/flash_attention.cu``, the same ``__device__`` function the
    kernels call) as int64 ``[BH, Sq, Sk]``; a check of the mask function,
    not a kernel of any model path."""
    bits = torch.empty(BH, Sq, Sk, device=device, dtype=torch.int32)
    fn = _build.function("flash_attention", "flash_dropout_bits",
                         [_P, _U, _I, _I, _I, _P])
    err = fn(bits.data_ptr(), int(seed) & _M32, BH, Sq, Sk,
             torch.cuda.current_stream(bits.device).cuda_stream)
    _build.check(err, "flash_attention", "flash_dropout_bits launch")
    return bits.to(torch.int64) & _M32


def _drop_args(dropout_p, seed):
    """(flag, seed, threshold, 1 / (1 - p)) of the C entries."""
    if not dropout_p:
        return 0, 0, 0, 1.0
    if not 0.0 < dropout_p < 1.0:
        raise ValueError(f"flash attention: dropout_p must lie in [0, 1); "
                         f"got {dropout_p}")
    return (1, int(seed) & _M32, dropout_threshold(dropout_p),
            float(1.0 / (1.0 - dropout_p)))


def _check_shapes(q, k, v, causal):
    B, Sq, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit [B, S, H, D] with Hkv | H")
    if causal and Sq > k.shape[1]:
        raise ValueError("flash_attention: causal needs Sq <= Sk")


def flash_attention_plain(q, k, v, causal=False, sm_scale=None,
                          dropout_p=0.0, seed=0):
    """PyTorch transcription of the reference's ``_mirror_fwd``: f32
    scores, f32 softmax, the normalised probabilities times ``z / (1 - p)``
    with dropout, out cast to q's dtype; returns ``(out, lse)``."""
    _check_shapes(q, k, v, causal)
    with plain_math(q.device):
        return _fwd_plain(q, k, v, causal, sm_scale, dropout_p, seed)


def _fwd_plain(q, k, v, causal, sm_scale, dropout_p, seed):
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
    pn = p / l_safe
    if dropout_p:
        pn = pn * _drop_mult(seed, B, H, Sq, Sk, dropout_p, q.device)
    out = torch.einsum("bhqk,bkhd->bqhd", pn, v.float()).to(q.dtype)
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


def flash_attention_cuda(q, k, v, causal=False, sm_scale=None,
                         dropout_p=0.0, seed=0):
    """Launch ``csrc/flash_attention.cu``; same contract as
    :func:`flash_attention_plain`. Raises on what the kernel does not take.
    Counts under ``flash_attention_dropout`` when ``dropout_p > 0``."""
    refuse_grad("flash_attention_cuda", q, k, v)
    drop = _drop_args(dropout_p, seed)
    q, k, v = _kernel_inputs("flash_attention", q, k, v, causal)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32)
    fn = _build.function(
        "flash_attention", "flash_attention_fwd",
        [_P] * 5 + [_I] * 6 + [_F, _I, _I, _I, _U, _U, _F, _P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, H, Hkv, Sq, Sk, D, float(scale),
             int(bool(causal)), _DTYPES[q.dtype], *drop, stream)
    _build.check(err, "flash_attention", "flash_attention_fwd launch")
    LAUNCHES["flash_attention_dropout" if drop[0] else "flash_attention"] += 1
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
                              sm_scale=None, dropout_p=0.0, seed=0):
    """PyTorch transcription of the reference's ``_mirror_bwd``, GQA
    included (dK/dV summed over the query heads of a KV group): from the
    forward's lse and ``dg = delta - g_lse`` (:func:`delta_minus_glse`),
    returns ``(dq, dk, dv)`` in the inputs' dtypes. With dropout, the
    forward's mask from the same ``seed`` scales dV's p and dP."""
    _check_shapes(q, k, v, causal)
    with plain_math(q.device):
        return _bwd_plain(q, k, v, g, lse, dg, causal, sm_scale, dropout_p,
                          seed)


def _bwd_plain(q, k, v, g, lse, dg, causal, sm_scale, dropout_p, seed):
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
    if dropout_p:
        mult = _drop_mult(seed, B, H, Sq, Sk, dropout_p, q.device)
        dv = torch.einsum("bhqk,bqhd->bkhd", p * mult, gf)
        dp = dp * mult
    else:
        dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    ds = p * (dp - dg[..., None])
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if rep > 1:
        dk = dk.reshape(B, Sk, Hkv, rep, D).sum(3)
        dv = dv.reshape(B, Sk, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_cuda(q, k, v, g, lse, dg, causal=False,
                             sm_scale=None, dropout_p=0.0, seed=0):
    """Launch ``csrc/flash_attention_bwd.cu`` (the dQ kernel, then the
    dK/dV kernel); same contract as :func:`flash_attention_bwd_plain`.
    Counts under ``flash_attention_bwd_dropout`` when ``dropout_p > 0``."""
    refuse_grad("flash_attention_bwd_cuda", q, k, v, g, lse, dg)
    drop = _drop_args(dropout_p, seed)
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
        [_P] * 9 + [_I] * 6 + [_F, _I, _I, _I, _U, _U, _F, _P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), dg.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), B, H, Hkv, Sq, Sk, D, float(scale),
             int(bool(causal)), _DTYPES[q.dtype], *drop, stream)
    _build.check(err, "flash_attention_bwd", "flash_attention_bwd launch")
    LAUNCHES["flash_attention_bwd_dropout" if drop[0]
             else "flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``(q, k, v, causal, sm_scale, dropout_p, seed) -> (out, lse)``,
    differentiable in q, k and v through both outputs. The kernels for
    CUDA tensors, the plain versions for CPU tensors; the backward
    regenerates the forward's dropout mask from the same seed."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, dropout_p, seed):
        cuda = use_kernel(q, k, v)
        out, lse = (flash_attention_cuda if cuda else flash_attention_plain)(
            q, k, v, causal=causal, sm_scale=sm_scale, dropout_p=dropout_p,
            seed=seed)
        ctx.cuda, ctx.causal, ctx.sm_scale = cuda, causal, sm_scale
        ctx.dropout_p, ctx.seed = dropout_p, seed
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dg = delta_minus_glse(out, g, g_lse)
        bwd = flash_attention_bwd_cuda if ctx.cuda else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, g, lse, dg, causal=ctx.causal,
                         sm_scale=ctx.sm_scale, dropout_p=ctx.dropout_p,
                         seed=ctx.seed)
        return dq, dk, dv, None, None, None, None


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, dropout_p=0.0,
                        seed=None):
    """``(out, lse)`` through :class:`FlashAttentionFunction`: the kernels
    for CUDA tensors, the plain versions for CPU tensors; differentiable.
    ``dropout_p > 0`` drops probabilities in-kernel; ``seed`` (a 32-bit
    int) fixes the mask, else one is drawn on the host from
    ``framework.random``'s CPU generator (no wait for the card)."""
    dropout_p = float(dropout_p)
    if dropout_p and seed is None:
        seed = next_seed()
    return FlashAttentionFunction.apply(q, k, v, causal, sm_scale, dropout_p,
                                        0 if seed is None else int(seed))
