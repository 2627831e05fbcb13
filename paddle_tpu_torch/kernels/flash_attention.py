"""Flash attention, forward and backward: CUDA kernels, plain versions and
the autograd Functions that join them.

Replaces ``paddle_tpu/kernels/flash_attention.py`` ``_fwd_kernel`` (its
``pallas_call`` in ``_core_fwd``) and ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel`` (in ``_flash_core_bwd``), whose ``custom_vjp`` over
``(out, lse)`` becomes :class:`FlashAttentionFunction` (dense batches) and
:class:`FlashVarlenFunction` (packed sequences), with every option of the
reference's kernels: causal or not, dropout on the probabilities, a dense
bool mask, varlen segments and any head width 1..256. The kernels are two
families (below), each a forward and a backward (dQ, then dK/dV); the
plain versions repeat the reference's ``_mirror_fwd`` and ``_mirror_bwd``
in PyTorch.

Dropout (the reference's ``_drop_mask``): the keep bit of score
``(bh, i, j)`` is a pure function of ``(seed, bh, i, j)``
(:func:`dropout_bits_plain`; in CUDA ``drop_row_key``/``drop_bits`` of
``csrc/common.cuh``, shared by every flash kernel), never of a tile, so
the backward kernels regenerate the forward's mask although they tile
otherwise. The TPU keyed its bits per (q-block, k-block) tile, which only
holds while every kernel uses the same tiles. As in the reference, ``l``
sums the un-dropped p, ``p * z / (1 - p)`` feeds ``P.V`` and ``dV``,
``dP`` is multiplied by ``z / (1 - p)``, and ``delta = rowsum(dO * O)``
is unchanged. ``bh = b * H + h`` over query heads for dense batches; for
varlen ``bh = h`` and ``i``, ``j`` are packed positions (the reference's
varlen call has batch 1). The plain versions compute the same bits in
``torch.int64`` ops, so kernel and plain version apply the same mask, bit
for bit.

Bool mask (True = attend; the reference's ``_canon_mask`` and
``_tile_mask``): any shape broadcastable to ``[B, H, Sq, Sk]`` (up to 4
dims, broadcast from the left); :func:`mask_view` also turns the
reference's canonical ``[1|B|H|B*H, 1|Sq, 1|Sk]`` with its mode
(``one``/``batch``/``head``/``bh``) into such a shape. The kernels read it
as bytes through strides, 0 on broadcast dims, so it is never widened. A masked score is ``bf16(-1e30)`` added to
the score, which in f32 is :data:`MASKED` whatever the score, below the
``-1e30`` that causality writes; so, as in the mirror, a row whose every
visible key is masked averages V over the causally hidden keys (over all
keys without causality) and gets no zeros. The mask has no gradient.

Varlen (``flash_attn_varlen_pallas``): q ``[Tq, H, D]``, k/v
``[Tk, Hkv, D]``, ``cu_seqlens`` int32 ``[nseq + 1]`` starting at 0;
tokens attend within their own sequence, causality is positional in the
packed rows (and needs ``cu_q == cu_k``), and tokens past ``cu[-1]`` get
a zero output and zero gradients (the reference gives them pad segment
ids). The kernels walk each sequence's own rows, so keys of another
sequence are never read; a query whose key sequence is empty gets out 0
and lse -1e30. ``cu_seqlens`` is copied to the host once a forward call
(it sizes the grid); the backward reuses that copy. Inside a compiled or
exported program the grid is sized from ``max_seqlen_*`` instead (else the
total tokens), with no host read (:func:`flash_attn_varlen`).

Layout is the reference's public one: q ``[B, Sq, H, D]``, k/v
``[B, Sk, Hkv, D]`` with ``H % Hkv == 0``. The forward returns
``(out, lse)``, out in q's dtype and lse ``[B, H, Sq]`` f32 (varlen
``[H, Tq]``); both are differentiable, and the lse cotangent folds into
the backward as ``ds = p * (dp - delta + g_lse)``, as the reference's does
(ring attention merges per-block ``(out, lse)``). Causal means query i
attends key j iff ``j <= i + (Sk - Sq)``.

What bounds the kernels on the H100: at long S, the flops (``4 * Sq * Sk
* D`` per head forward, 2.5 times that backward, about half of each
causal) against the bf16 tensor-core peak; at small D (16, the
Conformer's 36) the exponentials, one a score, against the
special-function units. Two kernel families compute the same function
(:func:`_flash_design` picks one from the inputs alone):

- ``sm90`` (``csrc/flash_attention_sm90.cuh``,
  ``csrc/flash_attention_bwd_sm90.cuh``, built per head-width class group
  by ``csrc/flash_attention{,_bwd}_sm90_{narrow,wide,wider}.cu``; the
  classes 64 and 128 keep their own tuned kernels in
  ``csrc/flash_attention{,_bwd}_sm90.cu``): bf16
  at every head_dim 1..256 whose rows TMA can read (:func:`_tma_rows`):
  16-byte head rows (D a multiple of 8) with every base address 16-byte
  aligned, or 8-byte head rows (D % 8 == 4 up to 44, the Conformer's 36)
  inside 16-byte token rows (``H * D`` a multiple of 8, ``H == Hkv``), read
  through a tensor map flattened over the heads. Hopper's design: a
  producer warp keeps TMA loads of K and V (Q and dO in the dK/dV kernel)
  in flight through a ring of shared-memory stages, two consumer
  warpgroups run ``wgmma`` on them (probabilities and ds as the register
  operand, V, K, Q and dO read transposed through the descriptor, nothing
  moved by a thread), softmax in f32 with ``exp2``. A head rides in its
  class (:func:`sm90_class`: a multiple of 16 up to 64, of 32 up to 256),
  in blocks of 64, 32 or 16 columns with the swizzle of the same width.
  The backward keeps FlashAttention-2's two kernels (dQ; dK/dV looping
  over the query heads of its KV group), so it adds no atomics. Their
  tensor maps' geometry is :func:`tma_geometry`.
- ``mma`` (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``):
  f32 (CUDA cores; a tensor-core path would be TF32 and change the
  arithmetic) and the bf16 rows TMA cannot read (odd widths, 2- or 4-byte
  chunks, misaligned bases), with ``mma.sync`` on tiles the threads load.

Probabilities and ds are rounded to bf16 as product operands, as in
FlashAttention. Each launch counts under its variant
(``flash_attention{,_bwd}`` + ``_dropout``/``_mask``/``_varlen``) and its
design (``flash_attention{,_bwd}_sm90`` or ``_mma``).

Head widths 1..256: in the ``mma`` kernels each rides zero-padded in the
shared-memory tiles to a multiple of 16 up to 128 and of 32 up to 256;
only the real columns are loaded and stored, rows moving in the widest
chunk (16, 8, 4 or 2 bytes) their length and base addresses allow. The
softmax scale stays ``1 / sqrt(D)``; the dropout bits do not depend on the
width. Above 256 the CUDA wrappers raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..framework.random import next_seed
from . import (LAUNCHES, _build, in_program, plain_math, refuse_grad,
               route, use_kernel)
from ..core.tensor import bound_public

__all__ = ["flash_attention_fwd", "flash_attention_plain",
           "flash_attention_cuda", "flash_attention_bwd_plain",
           "flash_attention_bwd_cuda", "delta_minus_glse",
           "dropout_bits_plain", "dropout_bits_cuda", "dropout_keep_plain",
           "FlashAttentionFunction", "flash_attn_varlen",
           "flash_attn_varlen_plain", "flash_attn_varlen_cuda",
           "flash_attn_varlen_bwd_plain", "flash_attn_varlen_bwd_cuda",
           "FlashVarlenFunction", "mask_view", "segments_from_cu",
           "MAX_HEAD_DIM", "SM90_CLASSES", "sm90_class", "tma_geometry",
           "fwd_geometry", "bwd_geometry", "fwd_key_tile", "dq_key_tile",
           "dkv_key_tile", "dkv_query_tile", "exp2_probe_cuda"]

NEG_INF = -1e30
# bf16(-1e30) in f32: the reference's _canon_mask stores a masked entry so
MASKED = -1.0002555517425873e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_L = ctypes.c_longlong
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


def dropout_bits_plain(seed, BH, Sq, Sk, device=None, bh0=0):
    """The raw 32 bits of every score ``[BH, Sq, Sk]`` (int64 in
    [0, 2^32)), bh = ``bh0`` + 0..BH-1 over query heads; a score is kept
    iff its bits are >= ``dropout_threshold(p)``."""
    bh = torch.arange(bh0, bh0 + BH, device=device,
                      dtype=torch.int64)[:, None, None]
    i = torch.arange(Sq, device=device, dtype=torch.int64)[None, :, None]
    j = torch.arange(Sk, device=device, dtype=torch.int64)[None, None, :]
    kbh = _fmix32(_fmix32((_mul32(bh, 0x9E3779B9) + 0x7F4A7C15) & _M32)
                  ^ (int(seed) & _M32))
    krow = _fmix32(kbh ^ ((_mul32(i, 0x85EBCA77) + 0x165667B1) & _M32))
    return _fmix32((krow + _mul32(j, 0x9E3779B9)) & _M32)


def dropout_threshold(p):
    """``floor(p * 2^32)``, capped at ``2^32 - 1``: keep iff bits >= it."""
    return min(int(p * 2.0 ** 32), _M32)


def dropout_keep_plain(seed, B, H, Sq, Sk, dropout_p, device=None, bh0=0):
    """Bool keep mask ``[B, H, Sq, Sk]`` of the kernels' dropout."""
    bits = dropout_bits_plain(seed, B * H, Sq, Sk, device, bh0)
    return (bits >= dropout_threshold(dropout_p)).reshape(B, H, Sq, Sk)


def _drop_mult(seed, B, H, Sq, Sk, dropout_p, device, bh0=0):
    """``z / (1 - p)`` f32 ``[B, H, Sq, Sk]``, as the reference's
    ``_mirror_dropmask`` scales its keep mask."""
    keep = dropout_keep_plain(seed, B, H, Sq, Sk, dropout_p, device, bh0)
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


def _drop_args(dropout_p, seed, device=None):
    """(flag, seed, seed pointer, threshold, 1 / (1 - p)) of the C entries.
    ``seed`` is an int, or an int64 tensor of one element on the inputs'
    ``device`` (the registered ops' form), which the kernels read there: a
    compiled program's seed, drawn on the card, never goes through the
    host."""
    if not dropout_p:
        return 0, 0, None, 0, 1.0
    if not 0.0 < dropout_p < 1.0:
        raise ValueError(f"flash attention: dropout_p must lie in [0, 1); "
                         f"got {dropout_p}")
    scale = (dropout_threshold(dropout_p), float(1.0 / (1.0 - dropout_p)))
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1 \
                or seed.device != (device or seed.device):
            raise ValueError(f"flash attention: a seed tensor must be one "
                             f"int64 on {device}; got {seed.dtype} "
                             f"{tuple(seed.shape)} on {seed.device}")
        return (1, 0, seed.data_ptr(), *scale)
    return (1, int(seed) & _M32, None, *scale)


# ---------------------------------------------------------------------------
# shapes, masks, segments
# ---------------------------------------------------------------------------

def _check_shapes(q, k, v, causal):
    B, Sq, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit [B, S, H, D] with Hkv | H")
    if causal and Sq > k.shape[1]:
        raise ValueError("flash_attention: causal needs Sq <= Sk")


_MODES = ("one", "batch", "head", "bh")


def mask_view(mask, B, H, Sq, Sk, mode=None, device=None):
    """A bool mask as a ``[B, H, Sq, Sk]`` view with stride 0 on its
    broadcast dims (nothing widened), or None. ``mask`` is broadcastable to
    ``[B, H, Sq, Sk]`` (up to 4 dims, from the left), or, with ``mode``,
    the reference's canonical ``[N, 1|Sq, 1|Sk]``: N is 1 (``one``), B
    (``batch``, broadcast over heads), H (``head``, over batches) or B * H
    (``bh``), which tells B from H where B == H. The mask moves to
    ``device`` when given (a small tensor, before it is broadcast)."""
    if mask is None:
        return None
    if device is not None:
        mask = mask.to(device)
    if mask.dtype != torch.bool:
        raise TypeError(f"flash attention takes a bool mask; got "
                        f"{mask.dtype} (a float bias goes to sdpa_ref)")
    m = mask
    if mode is not None:
        if mode not in _MODES or m.dim() != 3:
            raise ValueError(f"flash attention: a mask with a mode is the "
                             f"canonical [N, Sq|1, Sk|1] with mode in "
                             f"{_MODES}; got {tuple(m.shape)}, {mode!r}")
        mb, mh = {"one": (1, 1), "batch": (B, 1), "head": (1, H),
                  "bh": (B, H)}[mode]
        if m.shape[0] != mb * mh:
            raise ValueError(f"flash attention: mode {mode!r} needs "
                             f"{mb * mh} masks; got {m.shape[0]}")
        m = m.reshape(mb, mh, *m.shape[1:])
    elif m.dim() > 4:
        raise ValueError(f"attn_mask of {m.dim()} dims")
    while m.dim() < 4:
        m = m[None]
    if any(n not in (1, full) for n, full in zip(m.shape, (B, H, Sq, Sk))):
        raise ValueError(f"attn_mask shape {tuple(mask.shape)} not "
                         f"broadcastable to [{B}, {H}, {Sq}, {Sk}]")
    return m.expand(B, H, Sq, Sk)   # the kernels take any strides


def segments_from_cu(cu, total, pad_id):
    """Segment ids ``[total]`` int64 from cumulative lengths, the
    reference's ``_segments_from_cu``: position t lies in sequence s iff
    ``cu[s] <= t < cu[s + 1]``; positions past ``cu[-1]`` get ``pad_id``."""
    cu = cu.to(torch.int64)
    pos = torch.arange(total, device=cu.device, dtype=torch.int64)
    seg = torch.searchsorted(cu, pos, right=True) - 1
    nseg = cu.shape[0] - 1
    valid = (pos < torch.clamp(cu[-1], max=total)) & (seg < nseg)
    return torch.where(valid, seg, torch.full_like(seg, pad_id))


def _scores(q, k, scale, causal, off, mask, qseg, kseg):
    """The mirror's logits ``[B, H, Sq, Sk]`` f32 (``_mirror_logits``: the
    scaled scores, plus the mask, then causality and segments to -1e30)
    and, with segments, which scores are visible (bool) else None. q, k
    ``[B, S, H, D]`` with k's heads already repeated; key j is causally
    visible to query i iff ``j <= i + off``."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if mask is not None:
        s = s + torch.where(mask, 0.0, MASKED)
    vis = None
    if causal:
        cvis = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(off)
        s = torch.where(cvis, s, NEG_INF)
    if qseg is not None:
        vis = (qseg[:, :, None] == kseg[:, None, :])[:, None]
        s = torch.where(vis, s, NEG_INF)
        if causal:
            vis = vis & cvis
    return s, vis


def _repeat_kv(k, v, H):
    rep = H // k.shape[2]
    if rep == 1:
        return k, v
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, causal=False, sm_scale=None,
                          dropout_p=0.0, seed=0, mask=None):
    """PyTorch transcription of the reference's ``_mirror_fwd``: f32
    scores, the bool mask and causality as the mirror applies them, f32
    softmax, the normalised probabilities times ``z / (1 - p)`` with
    dropout, out cast to q's dtype; returns ``(out, lse)``."""
    _check_shapes(q, k, v, causal)
    B, Sq, H, _ = q.shape
    m4 = mask_view(mask, B, H, Sq, k.shape[1], device=q.device)
    with plain_math(q.device):
        return _fwd_plain(q, k, v, causal, sm_scale, dropout_p, seed, m4)


def _fwd_plain(q, k, v, causal, sm_scale, dropout_p, seed, mask=None,
               qseg=None, kseg=None, off=None, bh0=0):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k, v = _repeat_kv(k, v, H)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    s, vis = _scores(q, k, scale, causal, Sk - Sq if off is None else off,
                     mask, qseg, kseg)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:      # segments: a row may see no key at all
        p = torch.where(vis, p, 0.0)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pn = p / l_safe
    if dropout_p:
        pn = pn * _drop_mult(seed, B, H, Sq, Sk, dropout_p, q.device, bh0)
    out = torch.einsum("bhqk,bkhd->bqhd", pn, v.float()).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def delta_minus_glse(out, g, g_lse=None):
    """``dg = rowsum(dO * O) - g_lse`` f32, ``[B, H, Sq]`` (varlen
    ``[H, Tq]``): what both backward versions take per query row (the
    reference computes delta in jnp outside its kernels too)."""
    dg = (g.float() * out.float()).sum(-1).transpose(-1, -2)
    if g_lse is not None:
        dg = dg - g_lse.float()
    return dg.contiguous()


def flash_attention_bwd_plain(q, k, v, g, lse, dg, causal=False,
                              sm_scale=None, dropout_p=0.0, seed=0,
                              mask=None):
    """PyTorch transcription of the reference's ``_mirror_bwd``, GQA
    included (dK/dV summed over the query heads of a KV group): from the
    forward's lse and ``dg = delta - g_lse`` (:func:`delta_minus_glse`),
    returns ``(dq, dk, dv)`` in the inputs' dtypes. With dropout, the
    forward's mask from the same ``seed`` scales dV's p and dP."""
    _check_shapes(q, k, v, causal)
    B, Sq, H, _ = q.shape
    m4 = mask_view(mask, B, H, Sq, k.shape[1], device=q.device)
    with plain_math(q.device):
        return _bwd_plain(q, k, v, g, lse, dg, causal, sm_scale, dropout_p,
                          seed, m4)


def _bwd_plain(q, k, v, g, lse, dg, causal, sm_scale, dropout_p, seed,
               mask=None, qseg=None, kseg=None, off=None, bh0=0):
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kf, vf = _repeat_kv(k.float(), v.float(), H)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf, gf = q.float(), g.float()
    s, vis = _scores(qf, kf, scale, causal, Sk - Sq if off is None else off,
                     mask, qseg, kseg)
    p = torch.exp(s - lse[..., None])
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    if dropout_p:
        mult = _drop_mult(seed, B, H, Sq, Sk, dropout_p, q.device, bh0)
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


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _kernel_inputs(what, q, k, v, *more):
    """Check what the kernels take; returns contiguous q, k, v, *more."""
    D = q.shape[-1]
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{what} kernel takes head_dim 1..{MAX_HEAD_DIM}; "
                         f"got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    return [t.contiguous() for t in (q, k, v, *more)]


def _chunk(D, *tensors):
    """The bytes a bf16 row moves in: the widest of 16, 8, 4, 2 that
    divides the row's length and every tensor's base address."""
    w = 16
    while w > 2 and ((2 * D) % w or any(t.data_ptr() % w for t in tensors)):
        w //= 2
    return w


def _mask_args(m4):
    """(pointer, 4 element strides) of a mask view, or nulls."""
    if m4 is None:
        return (None, 0, 0, 0, 0)
    return (m4.data_ptr(), *m4.stride())


def _counter(base, drop, mask, varlen):
    """The launch counter of a variant: ``_varlen``, ``_mask``,
    ``_dropout`` (in that order of precedence) or the dense name."""
    return base + ("_varlen" if varlen else "_mask" if mask
                   else "_dropout" if drop else "")


SM90_CLASSES = (16, 32, 48, 64, 96, 128, 160, 192, 224, 256)


def sm90_class(D):
    """``(DP, W)``: the head-width class a head of D columns rides in
    zero-padded in the sm90 kernels (a multiple of 16 up to 64, of 32 up to
    256: ``sm90::flash_class``) and its block width (``sm90::block_cols``:
    64 where DP is a multiple of 64, else 32, else 16), the columns of a
    TMA box and of a swizzle row (2 W bytes)."""
    DP = -(-D // 16) * 16 if D <= 64 else -(-D // 32) * 32
    return DP, 64 if DP % 64 == 0 else 32 if DP % 32 == 0 else 16


def _tma_rows(D, H, Hkv, *tensors):
    """The rows the sm90 kernels' tensor maps read, in bytes a head row:
    16 where every head row is 16-byte (D a multiple of 8, the maps
    ``{D, heads, rows, batches}``), 8 where head rows are 8-byte (D % 8 ==
    4, up to 44: only the classes up to 48 compile the flattened maps)
    inside 16-byte token rows (``H * D`` a multiple of 8: the maps
    flattened over the heads, ``{heads * D, 1, rows, batches}``) and
    ``H == Hkv`` (TMA starts a box on a 16-byte boundary, so head h's box
    starts ``(h D) mod 8`` columns early; a query head and its KV head must
    share that shift), else 0; 0 too unless every base address is 16-byte
    aligned (TMA)."""
    if any(t.data_ptr() % 16 for t in tensors):
        return 0
    if D % 8 == 0:
        return 16
    if D % 8 == 4 and D <= 44 and H == Hkv and (H * D) % 8 == 0:
        return 8
    return 0


def _flash_design(dtype, D, tma):
    """Which kernel family takes a launch: ``"sm90"`` (the wgmma / TMA
    kernels) for bf16 at head_dim 1..256 whose rows the tensor maps read
    (``tma``, :func:`_tma_rows`, 16 or 8), else ``"mma"``
    (``csrc/flash_attention{,_bwd}.cu``: f32, bf16 rows of 2 or 4 bytes or
    misaligned bases). Each launch also counts under
    ``flash_attention{,_bwd}_<design>``."""
    return ("sm90" if dtype == torch.bfloat16 and 1 <= D <= MAX_HEAD_DIM
            and tma in (8, 16) else "mma")


def _sm90_lib(D, bwd):
    """The library (``csrc/<name>.cu``) holding class ``sm90_class(D)``:
    the class groups each build with one nvcc, all in parallel; the
    classes 64 and 128 are ``flash_attention{,_bwd}_sm90``'s own
    kernels."""
    DP = sm90_class(D)[0]
    group = ("_narrow" if DP <= 48 else "" if DP in (64, 128)
             else "_wide" if DP <= 160 or not bwd else "_wider")
    return f"flash_attention{'_bwd' if bwd else ''}_sm90{group}"


def tma_geometry(rows, batches, heads, D, box_rows, flat=False):
    """The TMA tensor map of a bf16 ``[batches, rows, heads, D]`` tensor as
    the sm90 kernels read it (``sm90::encode_map``): dims innermost first
    ``(D, heads, rows, batches)``, the byte strides of dims 1..3, the box
    ``(W, 1, box_rows, 1)``: W columns (:func:`sm90_class`; 2 W bytes, one
    swizzle row; a head loads as ``DP / W`` boxes) of one head over
    ``box_rows`` rows, and the swizzle's bytes (2 W). ``flat`` (8-byte head
    rows): dims ``(heads * D, 1, rows, batches)``, head h's box starting at
    column ``h * D - (h * D) % 8`` (16-byte aligned, as TMA needs). Varlen tensors ``[T, heads, D]`` are ``rows = T``,
    ``batches = 1``. Rows past ``rows`` read as zeros, and columns past D
    (past ``heads * D`` when flat)."""
    W = sm90_class(D)[1]
    row = 2 * heads * D
    dims = (heads * D, 1) if flat else (D, heads)
    return (*dims, rows, batches, row if flat else 2 * D, row,
            row * rows, W, 1, box_rows, 1, 2 * W)


def _geometry(maps):
    """The C array of ``tma_geometry`` tuples, one after the other."""
    flat = [x for g in maps for x in g]
    return (ctypes.c_longlong * len(flat))(*flat)


def _rows_batches(t, B, varlen):
    """(rows, batches) of a kernel tensor: ``[B, S, H, D]``, or
    ``[T, H, D]`` as one batch of T rows."""
    return (t.shape[0], 1) if varlen else (t.shape[1], B)


def fwd_key_tile(D):
    """The forward's key tile (``fwd_bk``): 128 for the classes 64 to 128,
    else 64 (up to class 48 two blocks an SM share the registers; above 128
    two Q buffers and two stages share the shared memory)."""
    return 128 if 64 <= sm90_class(D)[0] <= 128 else 64


def fwd_geometry(q, k, B, varlen, flat=False):
    """The forward's tensor maps: q with 128-row boxes, k and v with
    :func:`fwd_key_tile` rows."""
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[-2]
    gq = tma_geometry(*_rows_batches(q, B, varlen), H, D, 128, flat)
    gk = tma_geometry(*_rows_batches(k, B, varlen), Hkv, D, fwd_key_tile(D),
                      flat)
    return (gq, gk, gk)


def dq_key_tile(D):
    """The dQ kernel's key tile (``dq_bk``): 64, 32 up to class 48 (two
    blocks an SM, consumers in 104 registers) and from class 192 on (dQ's
    accumulator is DP / 2 registers a thread)."""
    DP = sm90_class(D)[0]
    return 32 if DP <= 48 or DP >= 192 else 64


def dkv_key_tile(D):
    """The dK/dV kernel's key tile (``dkv_bk`` in
    ``csrc/flash_attention_bwd_sm90.cuh``): 128 up to class 96, whose two
    consumer warpgroups split them, 64 above, where they split dK from dV
    instead."""
    return 128 if sm90_class(D)[0] <= 96 else 64


def dkv_query_tile(D):
    """The dK/dV kernel's query tile (``dkv_bq``): 64, 32 from class 192
    on."""
    return 32 if sm90_class(D)[0] >= 192 else 64


def bwd_geometry(q, k, B, varlen, flat=False):
    """The backward's tensor maps: for the dQ kernel q and dO with 128-row
    boxes, k and v with :func:`dq_key_tile`; for the dK/dV kernel k and v
    with :func:`dkv_key_tile` rows, q and dO with :func:`dkv_query_tile`."""
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[-2]
    rq, rk = _rows_batches(q, B, varlen), _rows_batches(k, B, varlen)
    q128, qt = (tma_geometry(*rq, H, D, n, flat)
                for n in (128, dkv_query_tile(D)))
    kq, kt = (tma_geometry(*rk, Hkv, D, n, flat)
              for n in (dq_key_tile(D), dkv_key_tile(D)))
    return (q128, q128, kq, kq, kt, kt, qt, qt)


_FWD_ARGS = [_P] * 5 + [_I] * 6 + [_F, _I, _I, _I, _U, _P, _U, _F] \
    + [_P, _L, _L, _L, _L, _P, _P, _I, _I, _P]
_BWD_ARGS = [_P] * 9 + [_I] * 6 + [_F, _I, _I, _I, _U, _P, _U, _F] \
    + [_P, _L, _L, _L, _L, _P, _P, _I, _I, _P]
_SM90_FWD_ARGS = [_P] * 5 + [_I] * 6 + [_F, _I, _I, _U, _P, _U, _F] \
    + [_P, _L, _L, _L, _L, _P, _P, _I, _I, _P, _P]
_SM90_BWD_ARGS = [_P] * 9 + [_I] * 6 + [_F, _I, _I, _U, _P, _U, _F] \
    + [_P, _L, _L, _L, _L, _P, _P, _I, _I, _P, _P]


def _launch_fwd(q, k, v, out, lse, B, Sq, Sk, causal, scale, drop, m4,
                cu=(None, None), Tq=0, design=None):
    """Launch the forward of the inputs' design; ``design`` names one
    instead (``chip_smoke.py`` times the mma kernels beside the sm90 ones
    at the same inputs with it; no entry point passes it)."""
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[-2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tma = _tma_rows(D, H, Hkv, q, k, v, out)
    design = design or _flash_design(q.dtype, D, tma)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              # lint: allow-host-sync(a Python scalar argument, no device value)
              lse.data_ptr(), B, H, Hkv, Sq, Sk, D, float(scale),
              int(bool(causal)))
    tail = (*drop, *_mask_args(m4),
            *(None if c is None else c.data_ptr() for c in cu), Tq)
    if design == "sm90":
        lib, name = _sm90_lib(D, False), "flash_attention_sm90_fwd"
        fn = _build.function(lib, name, _SM90_FWD_ARGS)
        geo = fwd_geometry(q, k, B, cu[0] is not None, tma == 8)
        err = fn(*common, *tail, tma, _geometry(geo), stream)
    else:
        lib, name = "flash_attention", "flash_attention_fwd"
        fn = _build.function(lib, name, _FWD_ARGS)
        err = fn(*common, _DTYPES[q.dtype], *tail, _chunk(D, q, k, v, out),
                 stream)
    _build.check(err, lib, f"{name} launch")
    LAUNCHES[_counter("flash_attention", drop[0], m4 is not None,
                      cu[0] is not None)] += 1
    LAUNCHES[f"flash_attention_{design}"] += 1


def _launch_bwd(q, k, v, g, lse, dg, dq, dk, dv, B, Sq, Sk, causal, scale,
                drop, m4, cu=(None, None), Tq=0, design=None):
    """Launch the backward of the inputs' design (``design`` as in
    :func:`_launch_fwd`)."""
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[-2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tma = _tma_rows(D, H, Hkv, q, k, v, g, dq, dk, dv)
    design = design or _flash_design(q.dtype, D, tma)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              lse.data_ptr(), dg.data_ptr(), dq.data_ptr(), dk.data_ptr(),
              # lint: allow-host-sync(a Python scalar argument, no device value)
              dv.data_ptr(), B, H, Hkv, Sq, Sk, D, float(scale),
              int(bool(causal)))
    tail = (*drop, *_mask_args(m4),
            *(None if c is None else c.data_ptr() for c in cu), Tq)
    if design == "sm90":
        lib, name = _sm90_lib(D, True), "flash_attention_sm90_bwd"
        fn = _build.function(lib, name, _SM90_BWD_ARGS)
        geo = bwd_geometry(q, k, B, cu[0] is not None, tma == 8)
        err = fn(*common, *tail, tma, _geometry(geo), stream)
    else:
        lib, name = "flash_attention_bwd", "flash_attention_bwd"
        fn = _build.function(lib, name, _BWD_ARGS)
        err = fn(*common, _DTYPES[q.dtype], *tail,
                 _chunk(D, q, k, v, g, dq, dk, dv), stream)
    _build.check(err, lib, f"{name} launch")
    LAUNCHES[_counter("flash_attention_bwd", drop[0], m4 is not None,
                      cu[0] is not None)] += 1
    LAUNCHES[f"flash_attention_bwd_{design}"] += 1


def exp2_probe_cuda(blocks, iters, device="cuda"):
    """Launch ``flash_exp2_probe`` (``csrc/flash_attention_sm90.cu``):
    ``blocks`` blocks of 256 threads, each thread 8 independent chains of
    ``iters`` exponentials (``ex2.approx``, as the sm90 templates' softmax);
    returns the threads' sums ``[blocks * 256]``. A
    timing probe of the card's exp2 rate (the flash kernels' bound at small
    head widths), not a kernel of any model path."""
    out = torch.empty(blocks * 256, device=device, dtype=torch.float32)
    fn = _build.function("flash_attention_sm90", "flash_exp2_probe",
                         [_P, _I, _I, _P])
    err = fn(out.data_ptr(), blocks, iters,
             torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "flash_attention_sm90", "flash_exp2_probe launch")
    return out


def flash_attention_cuda(q, k, v, causal=False, sm_scale=None,
                         dropout_p=0.0, seed=0, mask=None):
    """Launch the flash forward kernel of the inputs' design
    (:func:`_flash_design`); same contract as :func:`flash_attention_plain`.
    Raises on what the kernel does not take.
    Counts under ``flash_attention_mask`` with a mask, else
    ``flash_attention_dropout`` when ``dropout_p > 0``."""
    refuse_grad("flash_attention_cuda", q, k, v)
    drop = _drop_args(dropout_p, seed, q.device)
    _check_shapes(q, k, v, causal)
    q, k, v = _kernel_inputs("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    m4 = mask_view(mask, B, H, Sq, Sk, device=q.device)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32)
    _launch_fwd(q, k, v, out, lse, B, Sq, Sk, causal, scale, drop, m4)
    return out, lse


def _check_grads(what, q, g, lse, dg, lse_shape):
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"{what}: the gradient must match q in shape and "
                         f"dtype")
    for name, t in (("lse", lse), ("dg", dg)):
        if tuple(t.shape) != lse_shape or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be {list(lse_shape)} "
                             f"float32")
    return lse.contiguous(), dg.contiguous()


def flash_attention_bwd_cuda(q, k, v, g, lse, dg, causal=False,
                             sm_scale=None, dropout_p=0.0, seed=0,
                             mask=None):
    """Launch the flash backward kernels of the inputs' design (the dQ
    kernel, then the dK/dV kernel); same contract as
    :func:`flash_attention_bwd_plain`.
    Counts under ``flash_attention_bwd_mask`` with a mask, else
    ``flash_attention_bwd_dropout`` when ``dropout_p > 0``."""
    refuse_grad("flash_attention_bwd_cuda", q, k, v, g, lse, dg)
    drop = _drop_args(dropout_p, seed, q.device)
    _check_shapes(q, k, v, causal)
    q, k, v, g = _kernel_inputs("flash_attention_bwd", q, k, v, g)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    lse, dg = _check_grads("flash_attention_bwd", q, g, lse, dg, (B, H, Sq))
    m4 = mask_view(mask, B, H, Sq, Sk, device=q.device)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)  # Sq == 0: no launch
    _launch_bwd(q, k, v, g, lse, dg, dq, dk, dv, B, Sq, Sk, causal, scale,
                drop, m4)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``(q, k, v, causal, sm_scale, dropout_p, seed, mask) -> (out, lse)``,
    differentiable in q, k and v through both outputs; ``mask`` is a bool
    ``[B, H, Sq, Sk]`` view (:func:`mask_view`) or None. The kernels for
    CUDA tensors, the plain versions for CPU tensors, the registered ops
    (``library.py``) inside a program (:func:`~paddle_tpu_torch.kernels.
    in_program`); the backward regenerates the forward's dropout mask from
    the same seed (an int, or a program's int64 tensor)."""

    @staticmethod
    def forward(q, k, v, causal, sm_scale, dropout_p, seed, mask):
        if in_program(q, k, v):
            return torch.ops.paddle_tpu_torch.flash_attention_fwd(
                q, k, v, mask, causal, sm_scale, dropout_p,
                _seed_tensor(dropout_p, seed, q.device))
        return route("flash_attention_fwd", use_kernel(q, k, v),
                     flash_attention_cuda, flash_attention_plain, q, k, v,
                     causal=causal, sm_scale=sm_scale, dropout_p=dropout_p,
                     seed=seed, mask=mask)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, sm_scale, dropout_p, seed, mask = inputs
        ctx.causal, ctx.sm_scale, ctx.dropout_p = causal, sm_scale, dropout_p
        tensor_seed = isinstance(seed, torch.Tensor)
        ctx.seed = None if tensor_seed else seed
        ctx.save_for_backward(q, k, v, *output, seed if tensor_seed else None,
                              mask)

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse, seed_t, mask = ctx.saved_tensors
        seed = ctx.seed if seed_t is None else seed_t
        dg = delta_minus_glse(out, g, g_lse)
        if in_program(q, g):
            dq, dk, dv = torch.ops.paddle_tpu_torch.flash_attention_bwd(
                q, k, v, g, lse, dg, mask, ctx.causal, ctx.sm_scale,
                ctx.dropout_p, _seed_tensor(ctx.dropout_p, seed, q.device))
        else:
            dq, dk, dv = route(
                "flash_attention_bwd", use_kernel(q, k, v),
                flash_attention_bwd_cuda, flash_attention_bwd_plain, q, k, v,
                g, lse, dg, causal=ctx.causal, sm_scale=ctx.sm_scale,
                dropout_p=ctx.dropout_p, seed=seed, mask=mask)
        return dq, dk, dv, None, None, None, None, None


def _seed(dropout_p, seed, device):
    """The dropout seed of a call: ``seed`` where given; else, eager, one
    drawn on the host from ``framework.random``'s CPU generator (no wait
    for the card), and inside a compiled or exported program an int64
    tensor drawn on ``device`` by the program itself, so each call drops
    another mask."""
    if not dropout_p:
        return 0
    if seed is not None:
        return int(seed)
    if torch.compiler.is_compiling():
        return torch.randint(0, 2 ** 32, (), dtype=torch.int64,
                             device=device)
    return next_seed()


def _seed_tensor(dropout_p, seed, device):
    """A registered op's seed argument: None without dropout, else an
    int64 tensor on ``device`` (an int seed becomes a constant there, with
    the same low 32 bits the eager launch takes)."""
    if not dropout_p:
        return None
    if isinstance(seed, torch.Tensor):
        return seed
    return torch.full((), int(seed) & _M32, dtype=torch.int64, device=device)


def _distinct(*tensors):
    """The tensors with each repeat of an earlier one (self-attention's
    ``q is k is v``, ``cu_seqlens_q is cu_seqlens_k``) replaced by an alias
    of it: Dynamo refuses an ``autograd.Function`` handed one tensor
    twice."""
    out = []
    for t in tensors:
        out.append(t.view_as(t) if any(t is o for o in out) else t)
    return out


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, dropout_p=0.0,
                        seed=None, mask=None):
    """``(out, lse)`` through :class:`FlashAttentionFunction`: the kernels
    for CUDA tensors, the plain versions for CPU tensors; differentiable.
    ``dropout_p > 0`` drops probabilities in-kernel; ``seed`` (a 32-bit
    int) fixes the mask, the same eager and compiled; else one is drawn
    per call (:func:`_seed`). ``mask``: a bool attention mask (True =
    attend, see :func:`mask_view`)."""
    # lint: allow-host-sync(a Python scalar argument, no device value)
    dropout_p = float(dropout_p)
    _check_shapes(q, k, v, causal)
    B, Sq, H, _ = q.shape
    m4 = mask_view(mask, B, H, Sq, k.shape[1], device=q.device)
    if torch.compiler.is_compiling():
        q, k, v = _distinct(q, k, v)
    return FlashAttentionFunction.apply(q, k, v, causal, sm_scale, dropout_p,
                                        _seed(dropout_p, seed, q.device), m4)


# ---------------------------------------------------------------------------
# varlen (packed sequences)
# ---------------------------------------------------------------------------

def _check_varlen_shapes(q, k, v, cu_q, cu_k):
    """The shapes of a varlen call (no host read)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[2] != q.shape[2] or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"flash_attn_varlen: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit [T, H, D] with Hkv | H")
    for name, cu in (("cu_seqlens_q", cu_q), ("cu_seqlens_k", cu_k)):
        if cu.dim() != 1 or cu.shape[0] < 1 or cu.dtype.is_floating_point:
            raise ValueError(f"flash_attn_varlen: {name} must be a 1-D "
                             f"integer tensor of cumulative lengths")
    if cu_q.shape != cu_k.shape:
        raise ValueError("flash_attn_varlen: cu_seqlens_q and cu_seqlens_k "
                         "must hold the same number of sequences")


def _check_varlen(q, k, v, cu_q, cu_k, causal):
    """Shapes and ``cu_seqlens`` of a varlen call; returns the host copies
    ``(cu_q, cu_k)`` as lists (one device-to-host copy each)."""
    _check_varlen_shapes(q, k, v, cu_q, cu_k)
    hosts = []
    for name, cu, T in (("cu_seqlens_q", cu_q, q.shape[0]),
                        ("cu_seqlens_k", cu_k, k.shape[0])):
        # lint: allow-host-sync(validating cu_seqlens needs them on the host; the varlen entry's documented sync)
        h = [int(x) for x in cu.tolist()]
        if h[0] != 0 or any(b < a for a, b in zip(h, h[1:])) or h[-1] > T:
            raise ValueError(f"flash_attn_varlen: {name} must start at 0, "
                             f"never decrease and end at most at {T}; got "
                             f"{h}")
        hosts.append(h)
    if causal and hosts[0] != hosts[1]:
        raise ValueError(
            "causal varlen attention requires cu_seqlens_q == cu_seqlens_k "
            "(positional causality is defined within aligned packed "
            "sequences)")
    return hosts[0], hosts[1]


def _varlen_segments(cu_q, cu_k, Tq, Tk, device):
    nseg = len(cu_q) - 1
    cq = torch.tensor(cu_q, dtype=torch.int64, device=device)
    ck = torch.tensor(cu_k, dtype=torch.int64, device=device)
    return (segments_from_cu(cq, Tq, nseg + 1)[None],
            segments_from_cu(ck, Tk, nseg + 2)[None])


def _kv_groups(H, Hkv, Tq, Tk, budget=2 ** 28):
    """KV heads per chunk of the plain varlen versions, so one chunk's f32
    ``[heads, Tq, Tk]`` scores stay within ``budget`` bytes."""
    rep = H // Hkv
    return max(1, min(Hkv, budget // max(1, 4 * rep * Tq * Tk)))


def flash_attn_varlen_plain(q, k, v, cu_q, cu_k, causal=False,
                            sm_scale=None, dropout_p=0.0, seed=0,
                            cu_host=None):
    """The reference's varlen attention as its mirror computes it: the
    packed rows as one batch with segment ids (``segments_from_cu``; pad
    ids past ``cu[-1]``), scores of another sequence and causally hidden
    ones at -1e30, and rows that see no key at 0 (the kernels never visit
    such keys). q ``[Tq, H, D]``, k/v ``[Tk, Hkv, D]``; returns
    ``(out [Tq, H, D], lse [H, Tq] f32)``. Computed a few KV heads at a time
    (each head is independent), so long packs fit in memory."""
    if cu_host is None:
        cu_host = _check_varlen(q, k, v, cu_q, cu_k, causal)
    Tq, H, D = q.shape
    Tk, Hkv = k.shape[0], k.shape[1]
    rep = H // Hkv
    qseg, kseg = _varlen_segments(*cu_host, Tq, Tk, q.device)
    step = _kv_groups(H, Hkv, Tq, Tk)
    outs, lses = [], []
    with plain_math(q.device):
        for g0 in range(0, Hkv, step):
            hs = slice(g0 * rep, min(Hkv, g0 + step) * rep)
            ks = slice(g0, min(Hkv, g0 + step))
            o, l_ = _fwd_plain(q[None, :, hs], k[None, :, ks], v[None, :, ks],
                               causal, sm_scale, dropout_p, seed, None, qseg,
                               kseg, 0, hs.start)
            outs.append(o[0])
            lses.append(l_[0])
    return torch.cat(outs, 1), torch.cat(lses, 0)


def flash_attn_varlen_bwd_plain(q, k, v, g, lse, dg, cu_q, cu_k,
                                causal=False, sm_scale=None, dropout_p=0.0,
                                seed=0, cu_host=None):
    """Backward of :func:`flash_attn_varlen_plain` (``_mirror_bwd`` with
    segments); ``dg = delta - g_lse`` ``[H, Tq]``; returns
    ``(dq, dk, dv)``."""
    if cu_host is None:
        cu_host = _check_varlen(q, k, v, cu_q, cu_k, causal)
    Tq, H, D = q.shape
    Tk, Hkv = k.shape[0], k.shape[1]
    rep = H // Hkv
    qseg, kseg = _varlen_segments(*cu_host, Tq, Tk, q.device)
    step = _kv_groups(H, Hkv, Tq, Tk)
    grads = ([], [], [])
    with plain_math(q.device):
        for g0 in range(0, Hkv, step):
            hs = slice(g0 * rep, min(Hkv, g0 + step) * rep)
            ks = slice(g0, min(Hkv, g0 + step))
            got = _bwd_plain(q[None, :, hs], k[None, :, ks], v[None, :, ks],
                             g[None, :, hs], lse[None, hs], dg[None, hs],
                             causal, sm_scale, dropout_p, seed, None, qseg,
                             kseg, 0, hs.start)
            for acc, t in zip(grads, got):
                acc.append(t[0])
    return tuple(torch.cat(t, 1) for t in grads)


def _cu_device(cu, device):
    return cu.to(device=device, dtype=torch.int32).contiguous()


def _longest(cu):
    """The longest sequence of host cumulative lengths (the grid's size)."""
    return max((b - a for a, b in zip(cu, cu[1:])), default=0)


def _varlen_grid(q, k, v, cu_q, cu_k, causal, cu_host, max_len):
    """``(sequences, Sq, Sk, first free q row, first free k row)`` of a
    varlen launch: from the host copies of ``cu_seqlens`` (``cu_host``,
    copied here when None), or, given ``max_len`` ``(max_q, max_k)`` (the
    registered ops' form, with no host read), from those and the shapes,
    every row then free (zeroed before the launch)."""
    if max_len is not None:
        _check_varlen_shapes(q, k, v, cu_q, cu_k)
        return (cu_q.shape[0] - 1, *max_len, 0, 0)
    if cu_host is None:
        cu_host = _check_varlen(q, k, v, cu_q, cu_k, causal)
    hq, hk = cu_host
    return len(hq) - 1, _longest(hq), _longest(hk), hq[-1], hk[-1]


def flash_attn_varlen_cuda(q, k, v, cu_q, cu_k, causal=False, sm_scale=None,
                           dropout_p=0.0, seed=0, cu_host=None,
                           max_len=None):
    """Launch the flash forward kernel on packed sequences (one thread
    block per sequence, query tile and head); same contract as
    :func:`flash_attn_varlen_plain`. ``cu_host`` (the lists
    :func:`_check_varlen` returns) spares the copy of ``cu_seqlens`` to the
    host; ``max_len`` sizes the grid without it (:func:`_varlen_grid`).
    Counts under ``flash_attention_varlen``."""
    refuse_grad("flash_attn_varlen_cuda", q, k, v)
    drop = _drop_args(dropout_p, seed, q.device)
    nseq, Sq, Sk, end, _ = _varlen_grid(q, k, v, cu_q, cu_k, causal, cu_host,
                                        max_len)
    q, k, v = _kernel_inputs("flash_attn_varlen", q, k, v)
    Tq, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(H, Tq, device=q.device, dtype=torch.float32)
    out[end:] = 0               # past cu[-1]: no sequence, zero output
    lse[:, end:] = NEG_INF
    cu = (_cu_device(cu_q, q.device), _cu_device(cu_k, q.device))
    _launch_fwd(q, k, v, out, lse, nseq, Sq, Sk, causal, scale, drop, None,
                cu, Tq)
    return out, lse


def flash_attn_varlen_bwd_cuda(q, k, v, g, lse, dg, cu_q, cu_k, causal=False,
                               sm_scale=None, dropout_p=0.0, seed=0,
                               cu_host=None, max_len=None):
    """Launch the flash backward kernels on packed sequences; same
    contract as :func:`flash_attn_varlen_bwd_plain`, ``cu_host`` and
    ``max_len`` as in :func:`flash_attn_varlen_cuda`. Counts under
    ``flash_attention_bwd_varlen``."""
    refuse_grad("flash_attn_varlen_bwd_cuda", q, k, v, g, lse, dg)
    drop = _drop_args(dropout_p, seed, q.device)
    nseq, Sq, Sk, end_q, end_k = _varlen_grid(q, k, v, cu_q, cu_k, causal,
                                              cu_host, max_len)
    q, k, v, g = _kernel_inputs("flash_attn_varlen_bwd", q, k, v, g)
    Tq, H, D = q.shape
    lse, dg = _check_grads("flash_attn_varlen_bwd", q, g, lse, dg, (H, Tq))
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq[end_q:] = 0
    dk[end_k:] = 0
    dv[end_k:] = 0
    cu = (_cu_device(cu_q, q.device), _cu_device(cu_k, q.device))
    _launch_bwd(q, k, v, g, lse, dg, dq, dk, dv, nseq, Sq, Sk, causal, scale,
                drop, None, cu, Tq)
    return dq, dk, dv


class FlashVarlenFunction(torch.autograd.Function):
    """``(q, k, v, cu_q, cu_k, causal, sm_scale, dropout_p, seed, cu_host,
    max_len) -> (out, lse)`` over packed sequences, differentiable in q, k
    and v; the kernels for CUDA tensors, the plain versions for CPU
    tensors. Eager calls hand in ``cu_host``, the host copy of
    ``cu_seqlens`` (one a call), which the backward reuses; a program
    hands in None and ``max_len`` (:func:`flash_attn_varlen`) and runs the
    registered ops."""

    @staticmethod
    def forward(q, k, v, cu_q, cu_k, causal, sm_scale, dropout_p, seed,
                cu_host, max_len):
        if cu_host is None:
            return torch.ops.paddle_tpu_torch.flash_varlen_fwd(
                q, k, v, cu_q, cu_k, *max_len, causal, sm_scale, dropout_p,
                _seed_tensor(dropout_p, seed, q.device))
        return route("flash_varlen_fwd", use_kernel(q, k, v),
                     flash_attn_varlen_cuda, flash_attn_varlen_plain, q, k, v,
                     cu_q, cu_k, causal, sm_scale, dropout_p, seed,
                     cu_host=cu_host)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (q, k, v, cu_q, cu_k, causal, sm_scale, dropout_p, seed, cu_host,
         max_len) = inputs
        ctx.causal, ctx.sm_scale, ctx.dropout_p = causal, sm_scale, dropout_p
        ctx.cu_host = cu_host
        ctx.max_len = max_len if cu_host is None else tuple(
            _longest(h) for h in cu_host)
        tensor_seed = isinstance(seed, torch.Tensor)
        ctx.seed = None if tensor_seed else seed
        ctx.save_for_backward(q, k, v, *output, cu_q, cu_k,
                              seed if tensor_seed else None)

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse, cu_q, cu_k, seed_t = ctx.saved_tensors
        seed = ctx.seed if seed_t is None else seed_t
        dg = delta_minus_glse(out, g, g_lse)
        g = g.contiguous()
        if ctx.cu_host is None or in_program(q, g):
            dq, dk, dv = torch.ops.paddle_tpu_torch.flash_varlen_bwd(
                q, k, v, g, lse, dg, cu_q, cu_k, *ctx.max_len, ctx.causal,
                ctx.sm_scale, ctx.dropout_p,
                _seed_tensor(ctx.dropout_p, seed, q.device))
        else:
            dq, dk, dv = route(
                "flash_varlen_bwd", use_kernel(q, k, v),
                flash_attn_varlen_bwd_cuda, flash_attn_varlen_bwd_plain, q, k,
                v, g, lse, dg, cu_q, cu_k, ctx.causal, ctx.sm_scale,
                ctx.dropout_p, seed, cu_host=ctx.cu_host)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_attn_varlen(q, k, v, cu_q, cu_k, causal=False, sm_scale=None,
                      dropout_p=0.0, seed=None, max_seqlen_q=None,
                      max_seqlen_k=None):
    """``(out, lse)`` of packed sequences through
    :class:`FlashVarlenFunction`: q ``[Tq, H, D]``, k/v ``[Tk, Hkv, D]``,
    ``cu_seqlens`` int32 ``[nseq + 1]``; dropout and ``seed`` as in
    :func:`flash_attention_fwd`. Eager calls copy ``cu_seqlens`` to the
    host once (the grid's size, and the checks) and ignore
    ``max_seqlen_*``; inside a compiled or exported program the grid is
    sized from ``max_seqlen_*`` (at least each sequence's length), else
    from the total tokens, with no host read and no check of
    ``cu_seqlens``' values."""
    # lint: allow-host-sync(a Python scalar argument, no device value)
    dropout_p = float(dropout_p)
    seed = _seed(dropout_p, seed, q.device)
    if torch.compiler.is_compiling():
        max_len = (q.shape[0] if max_seqlen_q is None else int(max_seqlen_q),
                   k.shape[0] if max_seqlen_k is None else int(max_seqlen_k))
        q, k, v, cu_q, cu_k = _distinct(q, k, v, cu_q, cu_k)
        return FlashVarlenFunction.apply(q, k, v, cu_q, cu_k, causal,
                                         sm_scale, dropout_p, seed, None,
                                         max_len)
    cu_host = _check_varlen(q, k, v, cu_q, cu_k, causal)
    return FlashVarlenFunction.apply(q, k, v, cu_q, cu_k, causal, sm_scale,
                                     dropout_p, seed, cu_host, None)


# public entry points hand back Tensors when a Tensor came in
bound_public(globals())
