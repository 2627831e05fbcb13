"""SGD, Momentum, Adam, AdamW, Adagrad, RMSProp, Adadelta, Adamax and Lamb
(counterpart of ``paddle_tpu/optimizer/optimizers.py``), with the
reference's arithmetic in its order of operations, not ``torch.optim``'s. SGD steps ``p -= lr * g``; Momentum keeps a
``velocity`` ``v = momentum * v + g`` and steps ``p -= lr * v`` (Nesterov:
``p -= lr * (g + momentum * v)``); L2 decay is folded into ``g`` by
``Optimizer.step`` before either. AdamW decays
``p *= 1 - lr * wd`` first; then Adam advances ``beta1_pow`` and
``beta2_pow``, the moments, and ``p -= lr * mhat / (sqrt(vhat) + eps)``
with ``mhat = m / (1 - beta1_pow)`` and ``vhat = v / (1 - beta2_pow)``;
its ``lr_ratio(param)`` scales one parameter's lr (decay included) and
``apply_decay_param_fun(name)`` picks the parameters that decay. Lamb
(You et al. 2019) takes Adam's step plus ``lamb_weight_decay * p``, scaled
by the trust ratio ``|p| / |step|``; ``exclude_from_weight_decay_fn(param)``
exempts a parameter from that decay. The state keeps the reference's names
(``moment``, ``mean_square``, ``avg_squared_grad``, ``inf_norm``, ...), so a
``.pdopt`` of either package loads into the other. The parameter and the
state are updated in place (the reference returns new arrays), which keeps
one copy of each on the card."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
           "Adadelta", "Adamax", "Lamb"]


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
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, param):
        """The reference's rule: a named parameter decays iff
        ``apply_decay_param_fun(name)``; an unnamed one always."""
        fn, name = self._apply_decay_param_fun, getattr(param, "name", None)
        return fn is None or not name or bool(fn(name))

    def update(self, param, grad, state, lr):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(param)
        wd = float(self._weight_decay or 0.0)
        if wd and self._decays(param):
            param.mul_(1.0 - lr * wd)
        super().update(param, grad, state, lr)


class Adagrad(Optimizer):
    """``moment += g^2; p -= lr * g / (sqrt(moment) + eps)``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, param):
        return {"moment": torch.full_like(param, self._init_acc)}

    def update(self, param, grad, state, lr):
        acc = state["moment"].add_(grad.square())
        param.sub_(lr * grad / (acc.sqrt() + self._eps))


class RMSProp(Optimizer):
    """``mean_square = rho * ms + (1 - rho) g^2`` (centered: less the
    square of ``mean_grad``, the same average of g), ``momentum =
    momentum * mom + lr * g / sqrt(ms [- mg^2] + eps)``, ``p -= mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, param):
        st = {"mean_square": torch.zeros_like(param),
              "momentum": torch.zeros_like(param)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(param)
        return st

    def update(self, param, grad, state, lr):
        rho = self._rho
        ms = state["mean_square"].mul_(rho).add_((1 - rho) * grad.square())
        if self._centered:
            mg = state["mean_grad"].mul_(rho).add_((1 - rho) * grad)
            denom = (ms - mg.square() + self._eps).sqrt_()
        else:
            denom = (ms + self._eps).sqrt_()
        mom = state["momentum"].mul_(self._momentum).add_(lr * grad / denom)
        param.sub_(mom)


class Adadelta(Optimizer):
    """``avg_squared_grad`` and ``avg_squared_update``, rho-averages of g^2
    and of the update's square; the update is ``sqrt(asu + eps) /
    sqrt(asg + eps) * g``, applied times lr."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon

    def init_state(self, param):
        return {"avg_squared_grad": torch.zeros_like(param),
                "avg_squared_update": torch.zeros_like(param)}

    def update(self, param, grad, state, lr):
        rho, eps = self._rho, self._eps
        asg = state["avg_squared_grad"].mul_(rho).add_(
            (1 - rho) * grad.square())
        asu = state["avg_squared_update"]
        upd = (asu + eps).sqrt_() / (asg + eps).sqrt_() * grad
        asu.mul_(rho).add_((1 - rho) * upd.square())
        param.sub_(lr * upd)


class Adamax(Optimizer):
    """Adam with the infinity norm: ``inf_norm = max(beta2 * u, |g|)``,
    ``p -= lr / (1 - beta1_pow) * m / (u + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, param):
        return {"moment": torch.zeros_like(param),
                "inf_norm": torch.zeros_like(param),
                "beta1_pow": torch.ones((), dtype=param.dtype,
                                        device=param.device)}

    def update(self, param, grad, state, lr):
        b1 = self._beta1
        b1p = state["beta1_pow"].mul_(b1)
        m = state["moment"].mul_(b1).add_((1 - b1) * grad)
        u = torch.maximum(state["inf_norm"].mul_(self._beta2), grad.abs(),
                          out=state["inf_norm"])
        param.sub_(lr / (1 - b1p) * m / (u + self._eps))


class Lamb(Optimizer):
    """Layer-wise adaptive moments (You et al. 2019, BERT / ERNIE large-batch
    pretraining): Adam's ``mhat / (sqrt(vhat) + eps)`` plus
    ``lamb_weight_decay * p`` is the step ``r``, applied as ``p -= lr *
    trust * r`` with ``trust = |p| / |r|`` (1 where either norm is 0)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, param):
        one = torch.ones((), dtype=param.dtype, device=param.device)
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def update(self, param, grad, state, lr):
        b1, b2 = self._beta1, self._beta2
        b1p = state["beta1_pow"].mul_(b1)
        b2p = state["beta2_pow"].mul_(b2)
        m = state["moment1"].mul_(b1).add_((1 - b1) * grad)
        v = state["moment2"].mul_(b2).add_((1 - b2) * grad.square())
        wd = 0.0 if self._exclude_fn is not None and self._exclude_fn(
            param) else self._wd
        r = (m / (1 - b1p)) / ((v / (1 - b2p)).sqrt_() + self._eps) \
            + wd * param
        w_norm = torch.linalg.vector_norm(param)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        param.sub_(lr * trust * r)
