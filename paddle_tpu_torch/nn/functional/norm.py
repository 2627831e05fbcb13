"""Normalisation functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``; this slice ports ``rms_norm``)."""
from __future__ import annotations

from ...kernels.rmsnorm import rmsnorm

__all__ = ["rms_norm"]


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim: ``x * rsqrt(mean(x^2) + eps) * weight``,
    computed in f32 and cast to x's dtype. Runs the RMSNorm kernel for CUDA
    tensors (always: the reference's TPU opt-in does not carry over) and
    its plain version for CPU tensors."""
    return rmsnorm(x, weight, epsilon)
