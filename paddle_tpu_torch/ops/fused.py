"""Fused ops (counterpart of ``paddle_tpu/ops/fused.py``): the two
device-generic entries of Paddle's fused_ops.yaml, as one composition each
(no kernel of the port's: neither is on a path a TPU kernel ran)."""
from __future__ import annotations

import torch

from ..framework.random import get_generator
from .registry import defop

__all__ = ["fused_dropout_add", "fused_linear_param_grad_add"]


@defop("fused_dropout_add", category="fused")
def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      seed=None):
    """``dropout(x) + y``; the keep mask comes from the device's generator
    (or a generator seeded with ``seed``)."""
    if not training:
        return x * (1.0 - p) + y if mode == "downscale_in_infer" else x + y
    if p == 0.0:
        return x + y
    g = get_generator(x.device) if seed is None else \
        torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=g, device=x.device) >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0) + y
    return torch.where(keep, x, 0.0) + y


@defop("fused_linear_param_grad_add", category="fused")
def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None,
                                multi_precision=True):
    """``dweight + x^T dout`` and ``dbias + sum(dout)`` (f32 accumulation
    for bf16 / f16 activations with ``multi_precision``)."""
    x2 = x.reshape(-1, x.shape[-1])
    d2 = dout.reshape(-1, dout.shape[-1])
    acc = torch.float32 if multi_precision else d2.dtype
    dw = x2.transpose(0, 1).to(acc) @ d2.to(acc)
    db = d2.to(acc).sum(0)
    if dweight is not None:
        dw = dw + dweight.to(acc)
    if dbias is not None:
        db = db + dbias.to(acc)
    if not multi_precision:
        dw, db = dw.to(d2.dtype), db.to(d2.dtype)
    return dw, db
