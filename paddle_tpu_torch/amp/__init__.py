"""``paddle.amp`` (counterpart of ``paddle_tpu/amp/__init__.py``): O1 and
O2 mixed precision with Paddle's own white and black lists.

- **O1**: white-list ops (matmul, linear, conv, einsum) compute in the amp
  dtype, black-list ops (layer_norm, cross_entropy, softmax, ...) in f32,
  the rest in whatever dtype reaches them (a bf16 linear output plus an f32
  residual is f32, by type promotion, as in the reference).
- **O2**: :func:`decorate` casts the model's f32 parameters to the amp
  dtype; black-list ops still compute in f32.

The white list rides on ``torch.autocast`` (whose own lower-precision ops
are matmul, linear, conv and the batched products), entered on the CPU and,
when there is one, on the card; it is entered only while ``linear`` and
``matmul`` stay on the effective white list. The port's functionals apply
the black list themselves through :func:`cast_for`: ``layer_norm`` takes
f32 inputs; ``cross_entropy``'s softmax-CE kernel reads bf16 logits and
upcasts them in registers, the same arithmetic as an f32 copy without
writing one. The plain versions of the kernels turn autocast off inside
(``kernels.plain_math``), so they keep computing in the dtypes they state.

:class:`GradScaler` keeps Paddle's API. bf16 needs no loss scaling; the
scaler does the reference's dynamic scaling when it is enabled (for f16),
and with ``enable=False`` it is a pass-through.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "amp_state",
           "cast_for", "op_cast_plan", "WHITE_LIST", "BLACK_LIST"]

# the reference's O1 lists (paddle_tpu/amp/__init__.py)
WHITE_LIST = {"matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mm",
              "einsum"}
BLACK_LIST = {
    "exp", "log", "logsumexp", "softmax", "log_softmax", "cross_entropy",
    "layer_norm", "batch_norm", "rms_norm", "mean", "sum", "norm", "cumsum",
}
_AMP_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               torch.bfloat16: torch.bfloat16, torch.float16: torch.float16}

_state = threading.local()


def amp_state():
    """The active ``auto_cast`` settings (a dict), or None."""
    return getattr(_state, "amp", None)


def op_cast_plan(op_name):
    """``(mode, dtype)`` for a Paddle op name under the active auto_cast:
    ``"down"`` casts f32 inputs to the amp dtype, ``"up"`` casts bf16/f16
    inputs to f32, ``None`` leaves them (the reference's rule)."""
    st = amp_state()
    if st is None:
        return None, None
    if st["level"] == "O2":
        if op_name in st["black"]:
            return "up", torch.float32
        return "down", st["dtype"]
    if op_name in st["white"]:
        return "down", st["dtype"]
    if op_name in st["black"]:
        return "up", torch.float32
    return None, None


def cast_for(op_name, *tensors):
    """``tensors`` cast as :func:`op_cast_plan` says for ``op_name``
    (None entries pass through); a tuple of the same length."""
    mode, dt = op_cast_plan(op_name)
    if mode is None:
        return tensors
    low = (torch.bfloat16, torch.float16)

    def cast(t):
        if t is None:
            return t
        if mode == "down" and t.dtype == torch.float32:
            return t.to(dt)
        if mode == "up" and t.dtype in low:
            return t.to(torch.float32)
        return t

    return tuple(cast(t) for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Paddle's ``auto_cast`` context (see the module docstring)."""
    if not enable or level == "O0":
        yield
        return
    if level not in ("O1", "O2"):
        raise ValueError(f"auto_cast: level must be O0, O1 or O2; got {level}")
    st = {"dtype": _AMP_DTYPES[dtype], "level": level,
          "white": set(WHITE_LIST) | set(custom_white_list or ()),
          "black": set(BLACK_LIST) | set(custom_black_list or ())}
    prev = amp_state()
    _state.amp = st
    try:
        with contextlib.ExitStack() as stack:
            if all(op_cast_plan(op)[0] == "down" for op in ("linear",
                                                             "matmul")):
                devices = ["cpu"] + (["cuda"] if torch.cuda.is_available()
                                     else [])
                for dev in devices:
                    stack.enter_context(torch.autocast(dev, dtype=st["dtype"]))
            yield
    finally:
        _state.amp = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' f32 parameters to the amp dtype in place (the
    optimizers hold the same Parameter objects). O1 leaves them."""
    dt = _AMP_DTYPES[dtype]
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(dt)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling with Paddle's API (``scale``, ``unscale_``,
    ``step``, ``update``, ``minimize``). A port of the reference's class;
    ``enable=False`` makes every method a pass-through, which is what bf16
    training wants."""

    def __init__(self, enable=True, init_loss_scaling=32768.0, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio, self._decr_ratio = incr_ratio, decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = self._bad_steps = self._streak = 0
        self._found_inf = self._unscaled = self._stepped = False

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        return loss * self._scale if self._enable else loss

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale, once per step, and note
        whether any is not finite."""
        if not self._enable or self._unscaled:
            return
        grads = [p.grad for p in optimizer._parameter_list or ()
                 if p.grad is not None]
        for g in grads:
            g.mul_(1.0 / self._scale)
        self._found_inf = bool(grads) and not all(
            bool(torch.isfinite(g).all()) for g in grads)
        self._unscaled = True

    def step(self, optimizer):
        """Unscale (unless done) and step unless a gradient was not finite;
        ``update()`` follows, as in the reference."""
        if not self._enable:
            optimizer.step()
            return
        if self._stepped:
            raise RuntimeError("scaler.step() has already been called since "
                               "the last update()")
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._stepped = True

    def update(self):
        if not self._enable:
            return
        self._unscaled = self._stepped = False
        if not self._dynamic:
            self._streak = self._streak + 1 if self._found_inf else 0
        elif self._found_inf:
            self._streak += 1
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        elif self._streak > 0:
            # the first finite step after a non-finite streak cools it off
            # without growing the scale (growing re-triggers the overflow)
            self._streak = self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
