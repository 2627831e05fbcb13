"""Adam and AdamW (counterpart of ``paddle_tpu/optimizer/optimizers.py``),
with the reference's arithmetic, not ``torch.optim``'s: AdamW decays
``p *= 1 - lr * wd`` first; then Adam advances ``beta1_pow`` and
``beta2_pow``, the moments, and ``p -= lr * mhat / (sqrt(vhat) + eps)``
with ``mhat = m / (1 - beta1_pow)`` and ``vhat = v / (1 - beta2_pow)``. The
parameter and the state are updated in place (the reference returns new
arrays), which keeps one copy of each on the card."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, param):
        one = torch.ones((), dtype=param.dtype, device=param.device)
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def update(self, param, grad, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        b1p = state["beta1_pow"].mul_(b1)
        b2p = state["beta2_pow"].mul_(b2)
        m = state["moment1"].mul_(b1).add_((1 - b1) * grad)
        v = state["moment2"].mul_(b2).add_((1 - b2) * grad.square())
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        param.sub_(lr * mhat / (vhat.sqrt_() + eps))


class AdamW(Adam):
    """Adam with decoupled weight decay (reference:
    python/paddle/optimizer/adamw.py)."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW: lr_ratio and apply_decay_param_fun are not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)

    def update(self, param, grad, state, lr):
        wd = float(self._weight_decay or 0.0)
        if wd:
            param.mul_(1.0 - lr * wd)
        super().update(param, grad, state, lr)
