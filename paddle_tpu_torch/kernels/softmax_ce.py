"""Softmax cross-entropy with integer labels, forward and backward: CUDA
kernels, plain versions and the autograd Function that joins them.

Replaces ``paddle_tpu/kernels/softmax_ce.py`` ``_fwd_kernel`` (its
``pallas_call`` in ``_fwd``) and ``_bwd_kernel`` (in ``_core_bwd``); public
``softmax_ce_pallas``, whose ``custom_vjp`` becomes
:class:`SoftmaxCEFunction`. The kernels are ``csrc/softmax_ce.cu``.

Per row of the logits x [N, V]: ``loss = lse - x[label]`` with the
logsumexp in f32, and ``dx = g * (softmax(x) - onehot(label))`` in x's
dtype, recomputed from the saved lse (the [N, V] softmax is never kept).
Labels must lie in [0, V); callers with an ignore index map it to 0 first
and mask the loss after, as ``nn.functional.cross_entropy`` does. A label
outside [0, V) gives a NaN loss on the card (the kernel reads no logit out
of bounds) and raises in the plain version.

What bounds the kernels on the H100: bytes. The forward reads the logits
once, the backward reads them and writes dx; one thread block per row,
16-byte vector loads over the aligned body of a row, scalar loads over its
ragged head and tail (an odd V misaligns every row), a running f32 (max,
sum of exp) per thread merged once across the block.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build, refuse_grad, use_kernel
from ..core.tensor import bound_public

__all__ = ["softmax_ce", "softmax_ce_plain", "softmax_ce_cuda",
           "softmax_ce_bwd_plain", "softmax_ce_bwd_cuda", "SoftmaxCEFunction"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABELS = {torch.int32: 0, torch.int64: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def softmax_ce_plain(x, labels):
    """Plain PyTorch forward, a transcription of the reference's
    ``_mirror_fwd``: returns ``(loss [N] f32, lse [N] f32)``."""
    xf = x.float()
    m = xf.amax(-1, keepdim=True)
    lse = m + torch.log(torch.exp(xf - m).sum(-1, keepdim=True))
    picked = xf.gather(1, labels.long()[:, None])
    return (lse - picked)[:, 0], lse[:, 0]


def softmax_ce_bwd_plain(x, labels, lse, g):
    """Plain PyTorch backward (the reference's ``_core_bwd`` mirror):
    ``g[:, None] * (exp(x - lse) - onehot)`` in x's dtype."""
    p = torch.exp(x.float() - lse[:, None])
    onehot = torch.nn.functional.one_hot(labels.long(), x.shape[1])
    return (g.float()[:, None] * (p - onehot)).to(x.dtype)


def _check(x, labels, what):
    if x.dim() != 2 or labels.shape != (x.shape[0],):
        raise ValueError(f"{what}: logits must be [N, V] and labels [N]; got "
                         f"{tuple(x.shape)} and {tuple(labels.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 logits; "
                        f"got {x.dtype}")
    if labels.dtype not in _LABELS:
        raise TypeError(f"{what} kernel takes int32 or int64 labels; got "
                        f"{labels.dtype}")
    x, labels = x.contiguous(), labels.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{what} kernel: the logits must start 16-byte "
                         f"aligned (16-byte vector loads)")
    return x, labels


def softmax_ce_cuda(x, labels):
    """Launch ``softmax_ce_fwd`` of ``csrc/softmax_ce.cu``; same contract as
    :func:`softmax_ce_plain`. Raises on what the kernel does not take."""
    refuse_grad("softmax_ce_cuda", x)
    x, labels = _check(x, labels, "softmax_ce")
    N, V = x.shape
    loss = torch.empty(N, device=x.device, dtype=torch.float32)
    lse = torch.empty(N, device=x.device, dtype=torch.float32)
    fn = _build.function("softmax_ce", "softmax_ce_fwd",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
             N, V, _DTYPES[x.dtype], _LABELS[labels.dtype], stream)
    _build.check(err, "softmax_ce", "softmax_ce_fwd launch")
    LAUNCHES["softmax_ce"] += 1
    return loss, lse


def softmax_ce_bwd_cuda(x, labels, lse, g):
    """Launch ``softmax_ce_bwd`` of ``csrc/softmax_ce.cu``; same contract as
    :func:`softmax_ce_bwd_plain`."""
    refuse_grad("softmax_ce_bwd_cuda", x, lse, g)
    x, labels = _check(x, labels, "softmax_ce_bwd")
    N, V = x.shape
    if lse.shape != (N,) or g.shape != (N,):
        raise ValueError("softmax_ce_bwd: lse and g must be [N]")
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    dx = torch.empty_like(x)
    fn = _build.function("softmax_ce", "softmax_ce_bwd",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
             dx.data_ptr(), N, V, _DTYPES[x.dtype], _LABELS[labels.dtype],
             stream)
    _build.check(err, "softmax_ce", "softmax_ce_bwd launch")
    LAUNCHES["softmax_ce_bwd"] += 1
    return dx


class SoftmaxCEFunction(torch.autograd.Function):
    """``(logits [N, V], labels [N]) -> loss [N] f32``, differentiable in
    the logits. The kernels for CUDA tensors, the plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, x, labels):
        cuda = use_kernel(x, labels)
        loss, lse = (softmax_ce_cuda if cuda else softmax_ce_plain)(x, labels)
        ctx.cuda = cuda
        ctx.save_for_backward(x, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, labels, lse = ctx.saved_tensors
        bwd = softmax_ce_bwd_cuda if ctx.cuda else softmax_ce_bwd_plain
        return bwd(x, labels, lse, g), None


def softmax_ce(logits, labels):
    """Per-example CE loss over the last axis; logits [..., V], integer
    labels [...] in [0, V). Returns the loss [...] float32."""
    V = logits.shape[-1]
    lead = logits.shape[:-1]
    loss = SoftmaxCEFunction.apply(logits.reshape(-1, V), labels.reshape(-1))
    return loss.reshape(lead)


# public entry points hand back Tensors when a Tensor came in
bound_public(globals())
