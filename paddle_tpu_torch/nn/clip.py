"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``.

Each clip is called with ``[(param, grad)]`` and returns the same list
with clipped gradients (pairs whose grad is None pass through). Norms are
taken in f32 and stay on the gradients' device: the scale is a tensor, so
clipping never waits for the card.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class _ClipBase:
    def __call__(self, params_grads):
        present = [g for _, g in params_grads if g is not None]
        clipped = iter(self._clip(present))
        return [(p, None if g is None else next(clipped))
                for p, g in params_grads]

    def _clip(self, grads):
        raise NotImplementedError


class ClipGradByValue(_ClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip(self, grads):
        return [g.clamp(self.min, self.max) for g in grads]


class ClipGradByNorm(_ClipBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, grads):
        out = []
        for g in grads:
            norm = torch.linalg.vector_norm(g.float())
            scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(_ClipBase):
    """One L2 norm over all gradients; every gradient scaled by the same
    ``min(1, clip_norm / global_norm)``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads):
        if not grads:
            return torch.zeros(())
        sq = torch.stack([g.float().square().sum() for g in grads]).sum()
        return sq.sqrt()

    def _clip(self, grads):
        if not grads:
            return []
        scale = (self.clip_norm / self.global_norm(grads).clamp_min(1e-12)
                 ).clamp_max(1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]
