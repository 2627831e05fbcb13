"""SGD, Momentum, Adam and AdamW (counterpart of
``paddle_tpu/optimizer/optimizers.py``), with the reference's arithmetic,
not ``torch.optim``'s. SGD steps ``p -= lr * g``; Momentum keeps a
``velocity`` ``v = momentum * v + g`` and steps ``p -= lr * v`` (Nesterov:
``p -= lr * (g + momentum * v)``); L2 decay is folded into ``g`` by
``Optimizer.step`` before either. AdamW decays
``p *= 1 - lr * wd`` first; then Adam advances ``beta1_pow`` and
``beta2_pow``, the moments, and ``p -= lr * mhat / (sqrt(vhat) + eps)``
with ``mhat = m / (1 - beta1_pow)`` and ``vhat = v / (1 - beta2_pow)``. The
parameter and the state are updated in place (the reference returns new
arrays), which keeps one copy of each on the card."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def update(self, param, grad, state, lr):
        param.sub_(lr * grad)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, param):
        return {"velocity": torch.zeros_like(param)}

    def update(self, param, grad, state, lr):
        v = state["velocity"].mul_(self._momentum).add_(grad)
        if self._nesterov:
            param.sub_(lr * (grad + self._momentum * v))
        else:
            param.sub_(lr * v)


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
