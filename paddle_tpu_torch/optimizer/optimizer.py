"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Each optimizer is an update rule ``update(param, grad, state, lr)`` over
one parameter and its state dict, applied in place by :meth:`step` to every
parameter that has a ``.grad``; the state keeps paddle's names. The
learning rate is a number or an ``lr.LRScheduler`` (read at each step; the
caller steps the scheduler); ``grad_clip`` is one of ``nn.clip``'s clips.
:meth:`step` follows the reference's order: clip all gradients, then fold
in L2 decay (or, for AdamW, decay inside the update), then update.
:meth:`state_dict` / :meth:`set_state_dict` keep the reference's layout:
``_step_count``, ``<key>.<state name>`` per parameter (``key`` its
``name`` or ``param<i>`` by position) and the scheduler's state under
``LR_Scheduler``; the moments of a plain ``torch.nn.Linear``'s weight
(``[out, in]`` here) are written and read in Paddle's ``[in, out]``, as
``Layer.state_dict`` writes the weight (ROADMAP F4).
"""
from __future__ import annotations

import torch

from ..core.tensor import raw_grad
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    _decoupled_wd = False   # AdamW applies its decay in update() instead

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr_scheduler = (learning_rate
                              if isinstance(learning_rate, LRScheduler)
                              else None)
        self._lr = (learning_rate if self._lr_scheduler is not None
                    else float(learning_rate))
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators: dict[int, dict[str, torch.Tensor]] = {}
        self._step_count = 0

    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return self._lr

    def set_lr(self, value) -> None:
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

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

    def step(self) -> None:
        self._apply()
        self._step_count += 1

    @torch.no_grad()
    def _apply(self) -> None:
        """One update from the parameters' ``.grad``, without counting it
        (``hapi.Model`` counts its ``train_batch`` calls instead, as the
        reference does)."""
        if self._parameter_list is None:
            raise ValueError("Optimizer constructed without parameters")
        lr = self.get_lr()
        wd = self._weight_decay
        pairs = [(p, g) for p in self._parameter_list
                 if (g := raw_grad(p)) is not None and p.requires_grad]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        for p, g in pairs:
            g = g.to(p.dtype)
            if wd and not self._decoupled_wd:    # L2 decay folded into g
                g = g + torch.mul(p, float(wd))   # torch's op: no wrapping
            self.update(p, g, self.state_for(p), lr)

    def clear_grad(self) -> None:
        """Drop every parameter's gradient (``.grad = None``, PyTorch's way
        of zeroing: the next backward writes a fresh one)."""
        for p in self._parameter_list or ():
            p.grad = None

    def _param_keys(self) -> list[str]:
        """The parameters' state keys: a parameter's ``name`` where it has
        one, else ``param<i>`` by position; a repeated name gets
        ``__<n>``."""
        keys, seen = [], {}
        for i, p in enumerate(self._parameter_list or ()):
            key = getattr(p, "name", None) or f"param{i}"
            n = seen.get(key, 0)
            seen[key] = n + 1
            keys.append(key if n == 0 else f"{key}__{n}")
        return keys

    def state_dict(self) -> dict:
        out = {"_step_count": self._step_count}
        for p, key in zip(self._parameter_list or (), self._param_keys()):
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                out[f"{key}.{k}"] = v.t() if _paddle_t(p, v) else v
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return out

    def set_state_dict(self, state: dict) -> None:
        """Take a :meth:`state_dict` (tensors or numpy arrays, on any
        device): each state tensor is copied onto its parameter's device,
        floating ones in the parameter's dtype. A state tensor of neither
        the parameter's shape nor a scalar raises ``ValueError``; the
        ``[in, out]`` moments of a plain ``torch.nn.Linear``'s weight are
        taken transposed."""
        self._step_count = int(state.get("_step_count", 0))
        for p, key in zip(self._parameter_list or (), self._param_keys()):
            prefix = f"{key}."
            st = {}
            for k, v in state.items():
                if isinstance(k, str) and k.startswith(prefix):
                    t = torch.Tensor.detach(torch.as_tensor(v))  # plain
                    if _paddle_t(p, t):
                        t = t.t()
                    if t.dim() and t.shape != p.shape:
                        raise ValueError(
                            f"optimizer state {k}: shape {tuple(t.shape)} "
                            f"does not match its parameter's "
                            f"{tuple(p.shape)}")
                    dtype = p.dtype if t.is_floating_point() else t.dtype
                    st[k[len(prefix):]] = t.to(p.device, dtype, copy=True)
            if st:
                self._accumulators[id(p)] = st
        if self._lr_scheduler is not None and "LR_Scheduler" in state:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])


def _paddle_t(p, v) -> bool:
    """True for a state tensor of a parameter whose Paddle layout is its
    transpose (a plain ``torch.nn.Linear``'s weight)."""
    return getattr(p, "_paddle_t", False) and v.dim() == 2
