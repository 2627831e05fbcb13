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
(it sizes the grid); the backward reuses that copy.

Layout is the reference's public one: q ``[B, Sq, H, D]``, k/v
``[B, Sk, Hkv, D]`` with ``H % Hkv == 0``. The forward returns
``(out, lse)``, out in q's dtype and lse ``[B, H, Sq]`` f32 (varlen
``[H, Tq]``); both are differentiable, and the lse cotangent folds into
the backward as ``ds = p * (dp - delta + g_lse)``, as the reference's does
(ring attention merges per-block ``(out, lse)``). Causal means query i
attends key j iff ``j <= i + (Sk - Sq)``.

What bounds the kernels on the H100: at long S, the flops (``4 * Sq * Sk
* D`` per head forward, 2.5 times that backward, about half of each
causal) against the bf16 tensor-core peak. Two kernel families compute the
same function (:func:`_flash_design` picks one from the inputs alone):

- ``sm90`` (``csrc/flash_attention_sm90.cu``,
  ``csrc/flash_attention_bwd_sm90.cu``): bf16 at head_dim 64 and 128 with
  every row and base address 16-byte aligned, the widths of every
  full-width model path. Hopper's design: a producer warp keeps TMA loads
  of K and V (Q and dO in the dK/dV kernel) in flight through a ring of
  shared-memory stages, two consumer warpgroups run ``wgmma`` on them
  (probabilities and ds as the register operand, V, K, Q and dO read
  transposed through the descriptor, nothing moved by a thread), softmax
  in f32 with ``exp2f``. The backward keeps FlashAttention-2's two kernels
  (dQ; dK/dV looping over the query heads of its KV group), so it adds no
  atomics. Their tensor maps' geometry is :func:`tma_geometry`.
- ``mma`` (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``):
  everything else — f32 (CUDA cores), the other head widths and rows that
  are not 16-byte aligned (``mma.sync`` on tiles the threads load).

Probabilities and ds are rounded to bf16 as product operands, as in
FlashAttention. Each launch counts under its variant
(``flash_attention{,_bwd}`` + ``_dropout``/``_mask``/``_varlen``) and its
design (``flash_attention{,_bwd}_sm90`` or ``_mma``).

Head widths 1..256: each rides zero-padded in the kernels' shared-memory
tiles to its class, a multiple of 16 up to 128 (the tensor-core product
steps its depth by 16) and of 32 up to 256; only the real columns are
loaded and stored, rows moving in the widest chunk (16, 8, 4 or 2 bytes)
their length and base addresses allow. The softmax scale stays
``1 / sqrt(D)``; the dropout bits do not depend on the width. Above 256
the CUDA wrappers raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..framework.random import next_seed
from . import LAUNCHES, _build, plain_math, refuse_grad, use_kernel
from ..core.tensor import bound_public

__all__ = ["flash_attention_fwd", "flash_attention_plain",
           "flash_attention_cuda", "flash_attention_bwd_plain",
           "flash_attention_bwd_cuda", "delta_minus_glse",
           "dropout_bits_plain", "dropout_bits_cuda", "dropout_keep_plain",
           "FlashAttentionFunction", "flash_attn_varlen",
           "flash_attn_varlen_plain", "flash_attn_varlen_cuda",
           "flash_attn_varlen_bwd_plain", "flash_attn_varlen_bwd_cuda",
           "FlashVarlenFunction", "mask_view", "segments_from_cu",
           "MAX_HEAD_DIM", "SM90_HEAD_DIMS", "tma_geometry", "fwd_geometry",
           "bwd_geometry", "dkv_key_tile"]

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


def _drop_args(dropout_p, seed):
    """(flag, seed, threshold, 1 / (1 - p)) of the C entries."""
    if not dropout_p:
        return 0, 0, 0, 1.0
    if not 0.0 < dropout_p < 1.0:
        raise ValueError(f"flash attention: dropout_p must lie in [0, 1); "
                         f"got {dropout_p}")
    return (1, int(seed) & _M32, dropout_threshold(dropout_p),
            float(1.0 / (1.0 - dropout_p)))


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


SM90_HEAD_DIMS = (64, 128)


def _flash_design(dtype, D, chunk):
    """Which kernel family takes a launch: ``"sm90"`` (the wgmma / TMA
    kernels, ``csrc/flash_attention{,_bwd}_sm90.cu``) for bf16 at head_dim
    64 or 128 with every row and base address 16-byte aligned (``chunk``
    16, which TMA needs), else ``"mma"`` (``csrc/flash_attention{,_bwd}.cu``:
    f32, other widths, misaligned rows). Each launch also counts under
    ``flash_attention{,_bwd}_<design>``."""
    return ("sm90" if dtype == torch.bfloat16 and D in SM90_HEAD_DIMS
            and chunk == 16 else "mma")


def tma_geometry(rows, batches, heads, D, box_rows):
    """The TMA tensor map of a bf16 ``[batches, rows, heads, D]`` tensor as
    the sm90 kernels read it (``sm90::encode_map``): dims innermost first
    ``(D, heads, rows, batches)``, the byte strides of dims 1..3, and the
    box ``(64, 1, box_rows, 1)``: 64 columns (128 bytes, one 128-byte
    swizzle atom; a 128-wide head loads as two boxes) of one head over
    ``box_rows`` rows. Varlen tensors ``[T, heads, D]`` are ``rows = T``,
    ``batches = 1``. Rows past ``rows`` read as zeros."""
    return (D, heads, rows, batches,
            2 * D, 2 * heads * D, 2 * rows * heads * D,
            64, 1, box_rows, 1)


def _geometry(maps):
    """The C array of ``tma_geometry`` tuples, one after the other."""
    flat = [x for g in maps for x in g]
    return (ctypes.c_longlong * len(flat))(*flat)


def _rows_batches(t, B, varlen):
    """(rows, batches) of a kernel tensor: ``[B, S, H, D]``, or
    ``[T, H, D]`` as one batch of T rows."""
    return (t.shape[0], 1) if varlen else (t.shape[1], B)


def fwd_geometry(q, k, B, varlen):
    """The forward's tensor maps: q, k, v, each with 128-row boxes."""
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[-2]
    gq = tma_geometry(*_rows_batches(q, B, varlen), H, D, 128)
    gk = tma_geometry(*_rows_batches(k, B, varlen), Hkv, D, 128)
    return (gq, gk, gk)


def dkv_key_tile(D):
    """The dK/dV kernel's key tile (``dkv_bk`` in
    ``csrc/flash_attention_bwd_sm90.cu``): 128 keys at head_dim 64, whose
    two consumer warpgroups split them, 64 at 128, where they split dK
    from dV instead."""
    return 128 if D == 64 else 64


def bwd_geometry(q, k, B, varlen):
    """The backward's tensor maps: for the dQ kernel q and dO with 128-row
    boxes, k and v with 64; for the dK/dV kernel k and v with
    :func:`dkv_key_tile` rows, q and dO with 64."""
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[-2]
    rq, rk = _rows_batches(q, B, varlen), _rows_batches(k, B, varlen)
    q128, q64 = (tma_geometry(*rq, H, D, n) for n in (128, 64))
    k64, kt = (tma_geometry(*rk, Hkv, D, n) for n in (64, dkv_key_tile(D)))
    return (q128, q128, k64, k64, kt, kt, q64, q64)


_FWD_ARGS = [_P] * 5 + [_I] * 6 + [_F, _I, _I, _I, _U, _U, _F] \
    + [_P, _L, _L, _L, _L, _P, _P, _I, _I, _P]
_BWD_ARGS = [_P] * 9 + [_I] * 6 + [_F, _I, _I, _I, _U, _U, _F] \
    + [_P, _L, _L, _L, _L, _P, _P, _I, _I, _P]
_SM90_FWD_ARGS = [_P] * 5 + [_I] * 6 + [_F, _I, _I, _U, _U, _F] \
    + [_P, _L, _L, _L, _L, _P, _P, _I, _P, _P]
_SM90_BWD_ARGS = [_P] * 9 + [_I] * 6 + [_F, _I, _I, _U, _U, _F] \
    + [_P, _L, _L, _L, _L, _P, _P, _I, _P, _P]


def _launch_fwd(q, k, v, out, lse, B, Sq, Sk, causal, scale, drop, m4,
                cu=(None, None), Tq=0):
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[-2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    chunk = _chunk(D, q, k, v, out)
    design = _flash_design(q.dtype, D, chunk)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), B, H, Hkv, Sq, Sk, D, float(scale),
              int(bool(causal)))
    tail = (*drop, *_mask_args(m4),
            *(None if c is None else c.data_ptr() for c in cu), Tq)
    if design == "sm90":
        lib, name = "flash_attention_sm90", "flash_attention_sm90_fwd"
        fn = _build.function(lib, name, _SM90_FWD_ARGS)
        err = fn(*common, *tail,
                 _geometry(fwd_geometry(q, k, B, cu[0] is not None)), stream)
    else:
        lib, name = "flash_attention", "flash_attention_fwd"
        fn = _build.function(lib, name, _FWD_ARGS)
        err = fn(*common, _DTYPES[q.dtype], *tail, chunk, stream)
    _build.check(err, lib, f"{name} launch")
    LAUNCHES[_counter("flash_attention", drop[0], m4 is not None,
                      cu[0] is not None)] += 1
    LAUNCHES[f"flash_attention_{design}"] += 1


def _launch_bwd(q, k, v, g, lse, dg, dq, dk, dv, B, Sq, Sk, causal, scale,
                drop, m4, cu=(None, None), Tq=0):
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[-2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    chunk = _chunk(D, q, k, v, g, dq, dk, dv)
    design = _flash_design(q.dtype, D, chunk)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              lse.data_ptr(), dg.data_ptr(), dq.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), B, H, Hkv, Sq, Sk, D, float(scale),
              int(bool(causal)))
    tail = (*drop, *_mask_args(m4),
            *(None if c is None else c.data_ptr() for c in cu), Tq)
    if design == "sm90":
        lib, name = "flash_attention_bwd_sm90", "flash_attention_sm90_bwd"
        fn = _build.function(lib, name, _SM90_BWD_ARGS)
        err = fn(*common, *tail,
                 _geometry(bwd_geometry(q, k, B, cu[0] is not None)), stream)
    else:
        lib, name = "flash_attention_bwd", "flash_attention_bwd"
        fn = _build.function(lib, name, _BWD_ARGS)
        err = fn(*common, _DTYPES[q.dtype], *tail, chunk, stream)
    _build.check(err, lib, f"{name} launch")
    LAUNCHES[_counter("flash_attention_bwd", drop[0], m4 is not None,
                      cu[0] is not None)] += 1
    LAUNCHES[f"flash_attention_bwd_{design}"] += 1


def flash_attention_cuda(q, k, v, causal=False, sm_scale=None,
                         dropout_p=0.0, seed=0, mask=None):
    """Launch the flash forward kernel of the inputs' design
    (:func:`_flash_design`); same contract as :func:`flash_attention_plain`.
    Raises on what the kernel does not take.
    Counts under ``flash_attention_mask`` with a mask, else
    ``flash_attention_dropout`` when ``dropout_p > 0``."""
    refuse_grad("flash_attention_cuda", q, k, v)
    drop = _drop_args(dropout_p, seed)
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
    drop = _drop_args(dropout_p, seed)
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
    CUDA tensors, the plain versions for CPU tensors; the backward
    regenerates the forward's dropout mask from the same seed."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, dropout_p, seed, mask):
        cuda = use_kernel(q, k, v)
        out, lse = (flash_attention_cuda if cuda else flash_attention_plain)(
            q, k, v, causal=causal, sm_scale=sm_scale, dropout_p=dropout_p,
            seed=seed, mask=mask)
        ctx.cuda, ctx.causal, ctx.sm_scale = cuda, causal, sm_scale
        ctx.dropout_p, ctx.seed, ctx.mask = dropout_p, seed, mask
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dg = delta_minus_glse(out, g, g_lse)
        bwd = (flash_attention_bwd_cuda if ctx.cuda
               else flash_attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, g, lse, dg, causal=ctx.causal,
                         sm_scale=ctx.sm_scale, dropout_p=ctx.dropout_p,
                         seed=ctx.seed, mask=ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def _seed(dropout_p, seed):
    if dropout_p and seed is None:
        seed = next_seed()
    return 0 if seed is None else int(seed)


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, dropout_p=0.0,
                        seed=None, mask=None):
    """``(out, lse)`` through :class:`FlashAttentionFunction`: the kernels
    for CUDA tensors, the plain versions for CPU tensors; differentiable.
    ``dropout_p > 0`` drops probabilities in-kernel; ``seed`` (a 32-bit
    int) fixes the mask, else one is drawn on the host from
    ``framework.random``'s CPU generator (no wait for the card). ``mask``:
    a bool attention mask (True = attend, see :func:`mask_view`)."""
    dropout_p = float(dropout_p)
    _check_shapes(q, k, v, causal)
    B, Sq, H, _ = q.shape
    m4 = mask_view(mask, B, H, Sq, k.shape[1], device=q.device)
    return FlashAttentionFunction.apply(q, k, v, causal, sm_scale, dropout_p,
                                        _seed(dropout_p, seed), m4)


# ---------------------------------------------------------------------------
# varlen (packed sequences)
# ---------------------------------------------------------------------------

def _check_varlen(q, k, v, cu_q, cu_k, causal):
    """Shapes and ``cu_seqlens`` of a varlen call; returns the host copies
    ``(cu_q, cu_k)`` as lists (one device-to-host copy each)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[2] != q.shape[2] or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"flash_attn_varlen: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit [T, H, D] with Hkv | H")
    hosts = []
    for name, cu, T in (("cu_seqlens_q", cu_q, q.shape[0]),
                        ("cu_seqlens_k", cu_k, k.shape[0])):
        if cu.dim() != 1 or cu.shape[0] < 1 or cu.dtype.is_floating_point:
            raise ValueError(f"flash_attn_varlen: {name} must be a 1-D "
                             f"integer tensor of cumulative lengths")
        h = [int(x) for x in cu.tolist()]
        if h[0] != 0 or any(b < a for a, b in zip(h, h[1:])) or h[-1] > T:
            raise ValueError(f"flash_attn_varlen: {name} must start at 0, "
                             f"never decrease and end at most at {T}; got "
                             f"{h}")
        hosts.append(h)
    if len(hosts[0]) != len(hosts[1]):
        raise ValueError("flash_attn_varlen: cu_seqlens_q and cu_seqlens_k "
                         "must hold the same number of sequences")
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


def flash_attn_varlen_cuda(q, k, v, cu_q, cu_k, causal=False, sm_scale=None,
                           dropout_p=0.0, seed=0, cu_host=None):
    """Launch the flash forward kernel on packed sequences (one thread
    block per sequence, query tile and head); same contract as
    :func:`flash_attn_varlen_plain`. ``cu_host`` (the lists
    :func:`_check_varlen` returns) spares the copy of ``cu_seqlens`` to the
    host. Counts under ``flash_attention_varlen``."""
    refuse_grad("flash_attn_varlen_cuda", q, k, v)
    drop = _drop_args(dropout_p, seed)
    if cu_host is None:
        cu_host = _check_varlen(q, k, v, cu_q, cu_k, causal)
    q, k, v = _kernel_inputs("flash_attn_varlen", q, k, v)
    Tq, H, D = q.shape
    hq, hk = cu_host
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(H, Tq, device=q.device, dtype=torch.float32)
    out[hq[-1]:] = 0            # past cu[-1]: no sequence, zero output
    lse[:, hq[-1]:] = NEG_INF
    cu = (_cu_device(cu_q, q.device), _cu_device(cu_k, q.device))
    _launch_fwd(q, k, v, out, lse, len(hq) - 1, _longest(hq), _longest(hk),
                causal, scale, drop, None, cu, Tq)
    return out, lse


def flash_attn_varlen_bwd_cuda(q, k, v, g, lse, dg, cu_q, cu_k, causal=False,
                               sm_scale=None, dropout_p=0.0, seed=0,
                               cu_host=None):
    """Launch the flash backward kernels on packed sequences; same
    contract as :func:`flash_attn_varlen_bwd_plain`. Counts under
    ``flash_attention_bwd_varlen``."""
    refuse_grad("flash_attn_varlen_bwd_cuda", q, k, v, g, lse, dg)
    drop = _drop_args(dropout_p, seed)
    if cu_host is None:
        cu_host = _check_varlen(q, k, v, cu_q, cu_k, causal)
    q, k, v, g = _kernel_inputs("flash_attn_varlen_bwd", q, k, v, g)
    Tq, H, D = q.shape
    lse, dg = _check_grads("flash_attn_varlen_bwd", q, g, lse, dg, (H, Tq))
    hq, hk = cu_host
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq[hq[-1]:] = 0
    dk[hk[-1]:] = 0
    dv[hk[-1]:] = 0
    cu = (_cu_device(cu_q, q.device), _cu_device(cu_k, q.device))
    _launch_bwd(q, k, v, g, lse, dg, dq, dk, dv, len(hq) - 1, _longest(hq),
                _longest(hk), causal, scale, drop, None, cu, Tq)
    return dq, dk, dv


class FlashVarlenFunction(torch.autograd.Function):
    """``(q, k, v, cu_q, cu_k, causal, sm_scale, dropout_p, seed) ->
    (out, lse)`` over packed sequences, differentiable in q, k and v; the
    kernels for CUDA tensors, the plain versions for CPU tensors. The
    forward copies ``cu_seqlens`` to the host once; the backward reuses
    it."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, causal, sm_scale, dropout_p, seed):
        cuda = use_kernel(q, k, v)
        cu_host = _check_varlen(q, k, v, cu_q, cu_k, causal)
        fwd = flash_attn_varlen_cuda if cuda else flash_attn_varlen_plain
        out, lse = fwd(q, k, v, cu_q, cu_k, causal, sm_scale, dropout_p,
                       seed, cu_host=cu_host)
        ctx.cuda, ctx.causal, ctx.sm_scale = cuda, causal, sm_scale
        ctx.dropout_p, ctx.seed, ctx.cu_host = dropout_p, seed, cu_host
        ctx.save_for_backward(q, k, v, out, lse, cu_q, cu_k)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse, cu_q, cu_k = ctx.saved_tensors
        dg = delta_minus_glse(out, g, g_lse)
        bwd = (flash_attn_varlen_bwd_cuda if ctx.cuda
               else flash_attn_varlen_bwd_plain)
        dq, dk, dv = bwd(q, k, v, g.contiguous(), lse, dg, cu_q, cu_k,
                         ctx.causal, ctx.sm_scale, ctx.dropout_p, ctx.seed,
                         cu_host=ctx.cu_host)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attn_varlen(q, k, v, cu_q, cu_k, causal=False, sm_scale=None,
                      dropout_p=0.0, seed=None):
    """``(out, lse)`` of packed sequences through
    :class:`FlashVarlenFunction`: q ``[Tq, H, D]``, k/v ``[Tk, Hkv, D]``,
    ``cu_seqlens`` int32 ``[nseq + 1]``; dropout and ``seed`` as in
    :func:`flash_attention_fwd`."""
    dropout_p = float(dropout_p)
    return FlashVarlenFunction.apply(q, k, v, cu_q, cu_k, causal, sm_scale,
                                     dropout_p, _seed(dropout_p, seed))


# public entry points hand back Tensors when a Tensor came in
bound_public(globals())
