"""Normalisation layers (counterpart of ``paddle_tpu/nn/layers/norm.py``;
this slice ports ``RMSNorm``)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import rms_norm

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """RMSNorm over the last dim with a learned scale (initialised to 1)."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))
        self.epsilon = epsilon

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
