"""Learning-rate schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``;
ports ``LRScheduler``, ``LinearWarmup``, ``PiecewiseDecay``,
``PolynomialDecay`` and ``CosineAnnealingDecay``, the rest is in ROADMAP
Queue 1). Pure Python
arithmetic, the reference's formulas. An optimizer given a scheduler as
``learning_rate`` reads ``scheduler()`` at each step; the caller advances
it with ``scheduler.step()``, as in Paddle."""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "LinearWarmup", "PiecewiseDecay",
           "PolynomialDecay", "CosineAnnealingDecay"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def get_lr(self):
        raise NotImplementedError

    def step(self, epoch=None):
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.last_lr = self.get_lr()

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list, tuple))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict
    state_keys = state_dict


class PiecewiseDecay(LRScheduler):
    """``values[i]`` while ``last_epoch < boundaries[i]``, then the last
    value (``len(values) == len(boundaries) + 1``)."""

    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step, ds = self.last_epoch, self.decay_steps
        if self.cycle:
            ds = ds * (math.ceil(step / ds) if step > 0 else 1)
        else:
            step = min(step, ds)
        return ((self.base_lr - self.end_lr) * (1 - step / ds) ** self.power
                + self.end_lr)


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a number or a scheduler, stepped from 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_arg = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = (learning_rate.base_lr if isinstance(learning_rate,
                                                    LRScheduler)
                else float(learning_rate))
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.start_lr + (self.end_lr - self.start_lr)
                    * self.last_epoch / self.warmup_steps)
        if isinstance(self.lr_arg, LRScheduler):
            self.lr_arg.step(self.last_epoch - self.warmup_steps)
            return self.lr_arg.get_lr()
        return float(self.lr_arg)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
