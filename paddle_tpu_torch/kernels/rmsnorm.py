"""RMSNorm forward (+ optional residual add): CUDA kernel and plain version.

Replaces ``paddle_tpu/kernels/rmsnorm.py`` ``_fwd_kernel`` (its
``pallas_call`` in ``_fwd``; public ``rmsnorm_pallas`` and
``rmsnorm_residual_pallas``). The kernel is ``csrc/rmsnorm.cu``.

What bounds it on the H100: bytes. Per element it does a few flops against
2-6 bytes moved, so the least time is (bytes read + bytes written) over
3.35 TB/s. The kernel gives each row one thread block, so a row is read
from device memory once and re-read from L1 for the scaling pass, and the
f32 sum of squares reduces by warp shuffles. Unlike the reference, which
makes its kernel opt-in from a TPU measurement, the port always runs the
kernel on the card.

For a CPU tensor the wrappers run :func:`rmsnorm_plain`, which computes the
same thing in PyTorch: f32 throughout, one cast to x's dtype at the end.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build, use_kernel

__all__ = ["rmsnorm", "rmsnorm_residual", "rmsnorm_plain", "rmsnorm_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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


def rmsnorm_cuda(x, weight, eps, residual=None):
    """Launch ``csrc/rmsnorm.cu`` on CUDA tensors; same contract as
    :func:`rmsnorm_plain`. Raises on what the kernel does not take."""
    if x.dim() != 2 or weight.shape != (x.shape[1],):
        raise ValueError(
            f"rmsnorm: x must be [rows, F] and weight [F]; got "
            f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm kernel takes float32 or bfloat16 x with a weight of "
            f"the same dtype; got {x.dtype} and {weight.dtype}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("rmsnorm: residual must match x in shape and dtype")
    if (x.shape[1] * x.element_size()) % 16:
        raise ValueError("rmsnorm kernel: a row must be a multiple of 16 "
                         "bytes (16-byte vector loads)")
    x = x.contiguous()
    weight = weight.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    if any(t.data_ptr() % 16 for t in (x, weight, residual) if t is not None):
        raise ValueError("rmsnorm kernel: x, residual and weight must be "
                         "16-byte aligned (16-byte vector loads)")
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


def _fwd(x, weight, eps, residual):
    shape = x.shape
    F = shape[-1]
    x2 = x.reshape(-1, F)
    r2 = None if residual is None else residual.reshape(-1, F)
    tensors = (x2, weight) if r2 is None else (x2, weight, r2)
    impl = rmsnorm_cuda if use_kernel(*tensors) else rmsnorm_plain
    out, h, _ = impl(x2, weight, eps, r2)
    return out.reshape(shape), None if h is None else h.reshape(shape)


def rmsnorm(x, weight, eps=1e-6):
    """``x * rsqrt(mean(x^2) + eps) * weight`` over the last dim."""
    return _fwd(x, weight, eps, None)[0]


def rmsnorm_residual(x, residual, weight, eps=1e-6):
    """RMSNorm of ``x + residual``; returns ``(normed, x + residual)``."""
    return _fwd(x, weight, eps, residual)
