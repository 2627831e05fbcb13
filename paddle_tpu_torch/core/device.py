"""Device resolution for the port's entry points.

Counterpart of ``paddle_tpu/core/device.py``: there the placement is a JAX
device; here it is a ``torch.device``. The rule every entry point follows:
the port runs on ``cuda`` unless the caller asks for the CPU by name. With
no GPU and no explicit CPU request, :func:`resolve_device` raises; it never
carries on on the CPU quietly.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` (or a CPU ``torch.device``) is the
    only way onto the CPU. Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
