"""RMSNorm (+ optional residual add), forward and backward: CUDA kernels,
plain versions and the autograd Function that joins them.

Replaces ``paddle_tpu/kernels/rmsnorm.py`` ``_fwd_kernel`` (its
``pallas_call`` in ``_fwd``) and ``_bwd_kernel`` (in ``_core_bwd``); public
``rmsnorm_pallas`` and ``rmsnorm_residual_pallas``, whose ``custom_vjp``
becomes :class:`RMSNormFunction`. The kernels are ``csrc/rmsnorm.cu``.

What bounds them on the H100: bytes. Per element they do a few flops
against 2-6 bytes moved, so the least time is (bytes read + bytes written)
over 3.35 TB/s. The forward gives each row one thread block, so a row is
read from device memory once and re-read from L1 for the scaling pass; the
backward gives a chunk of rows one thread block, which keeps the chunk's
dw partial in shared memory, and the partials are summed afterwards in a
fixed order (no float atomics: two runs give the same bits). Unlike the
reference, which makes its kernel opt-in from a TPU measurement, the port
always runs the kernels on the card.

For CPU tensors the same Function runs :func:`rmsnorm_plain` and
:func:`rmsnorm_bwd_plain`, which compute the same things in PyTorch: f32
throughout, one cast to x's dtype at the end.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build, in_program, refuse_grad, route, use_kernel
from ..core.tensor import bound_public

__all__ = ["rmsnorm", "rmsnorm_residual", "rmsnorm_plain", "rmsnorm_cuda",
           "rmsnorm_bwd_plain", "rmsnorm_bwd_cuda", "RMSNormFunction"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the backward's grid: about two thread blocks per SM of an H100 (132)
_BWD_BLOCKS = 264


def rmsnorm_plain(x, weight, eps, residual=None):
    """Plain PyTorch RMSNorm over the last dim of ``x`` [rows, F].

    Returns ``(out, h, rstd)``: ``out`` in x's dtype, ``h = x + residual``
    in x's dtype (None without a residual) and ``rstd`` [rows] f32."""
    s = x.float()
    if residual is not None:
        s = s + residual.float()
    rstd = torch.rsqrt(s.pow(2).mean(-1) + eps)
    out = (s * rstd[:, None] * weight.float()).to(x.dtype)
    h = None if residual is None else s.to(x.dtype)
    return out, h, rstd


def _check(x, weight, residual, what):
    if x.dim() != 2 or weight.shape != (x.shape[1],):
        raise ValueError(
            f"{what}: x must be [rows, F] and weight [F]; got "
            f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(
            f"{what} kernel takes float32 or bfloat16 x with a weight of "
            f"the same dtype; got {x.dtype} and {weight.dtype}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"{what}: residual must match x in shape and dtype")
    if (x.shape[1] * x.element_size()) % 16:
        raise ValueError(f"{what} kernel: a row must be a multiple of 16 "
                         f"bytes (16-byte vector loads)")


def _aligned(what, *tensors):
    out = [None if t is None else t.contiguous() for t in tensors]
    if any(t.data_ptr() % 16 for t in out if t is not None):
        raise ValueError(f"{what} kernel: every tensor must be 16-byte "
                         f"aligned (16-byte vector loads)")
    return out


def rmsnorm_cuda(x, weight, eps, residual=None):
    """Launch ``rmsnorm_fwd`` of ``csrc/rmsnorm.cu`` on CUDA tensors; same
    contract as :func:`rmsnorm_plain`. Raises on what the kernel does not
    take."""
    refuse_grad("rmsnorm_cuda", x, weight, residual)
    _check(x, weight, residual, "rmsnorm")
    x, weight, residual = _aligned("rmsnorm", x, weight, residual)
    rows, cols = x.shape
    out = torch.empty_like(x)
    rstd = torch.empty(rows, device=x.device, dtype=torch.float32)
    h = None if residual is None else torch.empty_like(x)
    fn = _build.function("rmsnorm", "rmsnorm_fwd",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(),
             None if residual is None else residual.data_ptr(),
             weight.data_ptr(), out.data_ptr(),
             None if h is None else h.data_ptr(), rstd.data_ptr(),
             rows, cols, float(eps), _DTYPES[x.dtype], stream)
    _build.check(err, "rmsnorm", "rmsnorm_fwd launch")
    LAUNCHES["rmsnorm"] += 1
    return out, h, rstd


def rmsnorm_bwd_plain(x, weight, rstd, g, residual=None):
    """Plain PyTorch backward, a transcription of the reference's
    ``_mirror_bwd``: from the saved ``rstd`` [rows] f32 and the output
    gradient ``g`` [rows, F], returns ``(dx, dw)``; ``dx`` (which is also
    the residual's gradient) in x's dtype, ``dw`` in weight's."""
    s = x.float()
    if residual is not None:
        s = s + residual.float()
    gf = g.float()
    gw = gf * weight.float()
    r = rstd[:, None]
    dot = (s * gw).mean(-1, keepdim=True)
    dx = r * gw - s * r.pow(3) * dot
    dw = ((s * r) * gf).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def rmsnorm_bwd_cuda(x, weight, rstd, g, residual=None):
    """Launch ``rmsnorm_bwd`` of ``csrc/rmsnorm.cu``; same contract as
    :func:`rmsnorm_bwd_plain`. dw is the sum of the kernel's per-chunk f32
    partials, taken in a fixed order."""
    refuse_grad("rmsnorm_bwd_cuda", x, weight, rstd, g, residual)
    _check(x, weight, residual, "rmsnorm_bwd")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("rmsnorm_bwd: the gradient must match x in shape "
                         "and dtype")
    if rstd.shape != (x.shape[0],) or rstd.dtype != torch.float32:
        raise ValueError("rmsnorm_bwd: rstd must be [rows] float32")
    x, weight, g, residual = _aligned("rmsnorm_bwd", x, weight, g, residual)
    rstd = rstd.contiguous()
    rows, cols = x.shape
    per_block = max(1, -(-rows // _BWD_BLOCKS))
    blocks = -(-rows // per_block)
    dx = torch.empty_like(x)
    dw_part = torch.empty(blocks, cols, device=x.device, dtype=torch.float32)
    fn = _build.function("rmsnorm", "rmsnorm_bwd",
                         [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(),
             None if residual is None else residual.data_ptr(),
             weight.data_ptr(), rstd.data_ptr(), g.data_ptr(), dx.data_ptr(),
             dw_part.data_ptr(), rows, cols, per_block, _DTYPES[x.dtype],
             stream)
    _build.check(err, "rmsnorm", "rmsnorm_bwd launch")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw_part.sum(0).to(weight.dtype)


class RMSNormFunction(torch.autograd.Function):
    """``(x [rows, F], weight, residual or None, eps) -> (out, h, rstd)``
    with ``h = x + residual`` (None without a residual) and ``rstd`` [rows]
    f32 (not differentiable). Forward and backward are the kernels for CUDA
    tensors, the plain versions for CPU tensors and the registered ops
    (``library.py``) inside a program; the residual's gradient is x's
    (``dresid = dx``)."""

    @staticmethod
    def forward(x, weight, residual, eps):
        if in_program(x, weight, residual):
            out, h, rstd = torch.ops.paddle_tpu_torch.rmsnorm_fwd(
                x, weight, residual, eps)
            return out, (None if residual is None else h), rstd
        tensors = (x, weight) if residual is None else (x, weight, residual)
        return route("rmsnorm_fwd", use_kernel(*tensors), rmsnorm_cuda,
                     rmsnorm_plain, x, weight, eps, residual)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, residual, _ = inputs
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_backward(x, weight, residual, output[2])

    @staticmethod
    def backward(ctx, g_out, g_h, _):
        x, weight, residual, rstd = ctx.saved_tensors
        g = g_out.contiguous()
        if in_program(x, g):
            dx, dw = torch.ops.paddle_tpu_torch.rmsnorm_bwd(x, weight, rstd,
                                                            g, residual)
        else:
            dx, dw = route("rmsnorm_bwd", use_kernel(x, weight),
                           rmsnorm_bwd_cuda, rmsnorm_bwd_plain, x, weight,
                           rstd, g, residual)
        if g_h is not None:          # h = x + residual feeds both addends
            dx = dx + g_h
        return dx, dw, (None if residual is None else dx), None


def _fwd(x, weight, eps, residual):
    shape = x.shape
    F = shape[-1]
    r2 = None if residual is None else residual.reshape(-1, F)
    out, h, _ = RMSNormFunction.apply(x.reshape(-1, F), weight, r2, eps)
    return out.reshape(shape), None if h is None else h.reshape(shape)


def rmsnorm(x, weight, eps=1e-6):
    """``x * rsqrt(mean(x^2) + eps) * weight`` over the last dim;
    differentiable in x and weight."""
    return _fwd(x, weight, eps, None)[0]


def rmsnorm_residual(x, residual, weight, eps=1e-6):
    """RMSNorm of ``x + residual``; returns ``(normed, x + residual)``,
    differentiable in x, residual and weight."""
    return _fwd(x, weight, eps, residual)


# public entry points hand back Tensors when a Tensor came in
bound_public(globals())
