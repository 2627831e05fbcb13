"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Each optimizer is an update rule ``update(param, grad, state, lr)`` over
one parameter and its state dict, applied in place by :meth:`step` to every
parameter that has a ``.grad``; the state keeps paddle's names. Learning
rate schedulers (``lr.py``) and gradient clipping are not ported yet: the
learning rate is a number, and there is no ``grad_clip``.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer"]


class Optimizer:
    _decoupled_wd = False   # AdamW applies its decay in update() instead

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, name=None):
        self._lr = float(learning_rate)
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = weight_decay
        self._accumulators: dict[int, dict[str, torch.Tensor]] = {}

    def get_lr(self) -> float:
        return self._lr

    def init_state(self, param: torch.Tensor) -> dict:
        """The initial state of one parameter (dict of tensors)."""
        return {}

    def update(self, param, grad, state, lr) -> None:
        """Apply the rule to ``param`` and ``state`` in place. Override."""
        raise NotImplementedError

    def state_for(self, param: torch.Tensor) -> dict:
        """The state dict of one parameter (created at its first step)."""
        st = self._accumulators.get(id(param))
        if st is None:
            st = self._accumulators[id(param)] = self.init_state(param)
        return st

    @torch.no_grad()
    def step(self) -> None:
        if self._parameter_list is None:
            raise ValueError("Optimizer constructed without parameters")
        lr = self.get_lr()
        wd = self._weight_decay
        for p in self._parameter_list:
            if p.grad is None or not p.requires_grad:
                continue
            g = p.grad.to(p.dtype)
            if wd and not self._decoupled_wd:    # L2 decay folded into g
                g = g + float(wd) * p
            self.update(p, g, self.state_for(p), lr)

    def clear_grad(self) -> None:
        """Drop every parameter's gradient (``.grad = None``, PyTorch's way
        of zeroing: the next backward writes a fresh one)."""
        for p in self._parameter_list or ():
            p.grad = None
