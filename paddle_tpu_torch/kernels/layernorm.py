"""LayerNorm over the last dim: the CUDA forward kernel, its plain version,
the backward composition and the autograd Function that joins them.

Replaces ``paddle_tpu/kernels/layernorm.py`` ``_fwd_kernel`` (its
``pallas_call`` in ``_fwd``); public ``layer_norm_pallas``, whose
``custom_vjp`` becomes :class:`LayerNormFunction`. The kernel is
``csrc/layernorm.cu``. Its backward stays a composition of tensor ops over
the saved mean and rstd, as the reference's ``_bwd_vjp`` is jnp (the
reference measured a Pallas backward losing to XLA's fusion); a backward
kernel is later work (ROADMAP).

What bounds the kernel on the H100: bytes (read x once, write out once, a
few flops per element), so one thread block holds a row in registers
through both reductions and the output pass; 16-byte loads where the row
and the parameters are aligned, one element at a time where they are not.

For CPU tensors the Function runs :func:`layer_norm_plain`, the
reference's ``_fwd_kernel`` arithmetic in PyTorch: f32 throughout, the
two-pass variance, one cast to the output dtype (x's, w's and b's
promotion) at the end.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build, in_program, refuse_grad, route, use_kernel
from ..core.tensor import bound_public

__all__ = ["layer_norm_plain", "layer_norm_cuda", "layer_norm_bwd",
           "LayerNormFunction", "layernorm"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _out_dtype(x, weight, bias):
    return torch.promote_types(torch.promote_types(x.dtype, weight.dtype),
                               bias.dtype)


def layer_norm_plain(x, weight, bias, eps):
    """Plain PyTorch LayerNorm of ``x`` [rows, F] with ``weight``, ``bias``
    [F]. Returns ``(out, mean, rstd)``: ``out`` in the promoted dtype,
    ``mean`` and ``rstd`` [rows] f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (xf - mean) * rstd * weight.float() + bias.float()
    return out.to(_out_dtype(x, weight, bias)), mean[:, 0], rstd[:, 0]


def layer_norm_cuda(x, weight, bias, eps):
    """Launch ``layernorm_fwd`` of ``csrc/layernorm.cu`` on CUDA tensors;
    same contract as :func:`layer_norm_plain`. Raises on what the kernel
    does not take."""
    refuse_grad("layer_norm_cuda", x, weight, bias)
    if x.dim() != 2 or weight.shape != (x.shape[1],) \
            or bias.shape != (x.shape[1],):
        raise ValueError(
            f"layer_norm: x must be [rows, F], weight and bias [F]; got "
            f"{tuple(x.shape)}, {tuple(weight.shape)}, {tuple(bias.shape)}")
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES \
            or bias.dtype not in _DTYPES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16; got "
                        f"{x.dtype}, {weight.dtype}, {bias.dtype}")
    out_dtype = _out_dtype(x, weight, bias)
    w_dtype = torch.promote_types(weight.dtype, bias.dtype)
    x = x.contiguous()
    weight = weight.to(w_dtype).contiguous()    # an exact upcast, if any
    bias = bias.to(w_dtype).contiguous()
    rows, cols = x.shape
    out = torch.empty(rows, cols, device=x.device, dtype=out_dtype)
    mean = torch.empty(rows, device=x.device, dtype=torch.float32)
    rstd = torch.empty(rows, device=x.device, dtype=torch.float32)
    vec = (cols % (16 // x.element_size()) == 0
           and not any(t.data_ptr() % 16 for t in (x, weight, bias, out)))
    fn = _build.function("layernorm", "layernorm_fwd",
                         [_P] * 6 + [_I, _I, _F, _I, _I, _I, _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, cols,
             # lint: allow-host-sync(a Python scalar argument, no device value)
             float(eps), _DTYPES[x.dtype], _DTYPES[w_dtype], int(vec),
             stream)
    _build.check(err, "layernorm", "layernorm_fwd launch")
    LAUNCHES["layernorm"] += 1
    return out, mean, rstd


def layer_norm_bwd(x, weight, bias, mean, rstd, g):
    """The reference's ``_bwd_vjp`` in PyTorch ops (both devices): from the
    saved ``mean``, ``rstd`` [rows] f32 and the output gradient ``g``
    [rows, F], returns ``(dx, dw, db)`` in x's, weight's and bias's
    dtypes."""
    xf, gf = x.float(), g.float()
    w = weight.float()[None, :]
    xn = (xf - mean[:, None]) * rstd[:, None]
    gw = gf * w
    m1 = gw.mean(1, keepdim=True)
    m2 = (gw * xn).mean(1, keepdim=True)
    dx = (rstd[:, None] * (gw - m1 - xn * m2)).to(x.dtype)
    return (dx, (gf * xn).sum(0).to(weight.dtype),
            gf.sum(0).to(bias.dtype))


class LayerNormFunction(torch.autograd.Function):
    """``(x [rows, F], weight, bias, eps) -> (out, mean, rstd)`` (mean and
    rstd not differentiable): the kernel for CUDA tensors, the plain
    version for CPU tensors, the registered op inside a program; the
    backward is :func:`layer_norm_bwd` on either."""

    @staticmethod
    def forward(x, weight, bias, eps):
        if in_program(x, weight, bias):
            # a program calls the launch as one registered op
            # (kernels/library.py); eager calls it directly
            return torch.ops.paddle_tpu_torch.layernorm_fwd(x, weight, bias,
                                                            eps)
        return route("layernorm_fwd", use_kernel(x, weight, bias),
                     layer_norm_cuda, layer_norm_plain, x, weight, bias, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, bias, _ = inputs
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(x, weight, bias, *output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, bias, mean, rstd, g)
        return dx, dw, db, None


def layernorm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last dim of ``x`` with ``weight`` and ``bias``;
    differentiable in all three."""
    shape = x.shape
    out, _, _ = LayerNormFunction.apply(x.reshape(-1, shape[-1]), weight,
                                        bias, eps)
    return out.reshape(shape)


# public entry points hand back Tensors when a Tensor came in
bound_public(globals())
