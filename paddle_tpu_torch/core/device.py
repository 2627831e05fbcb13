"""Devices (counterpart of ``paddle_tpu/core/device.py``).

There the placement is a JAX device; here it is a ``torch.device``. The
rule every entry point follows: the port runs on ``cuda`` unless the caller
asks for the CPU, by passing ``device="cpu"`` or by ``set_device("cpu")``.
With no card and no such request, :func:`resolve_device` raises; it never
carries on on the CPU quietly. ``set_device`` takes Paddle's names
(``"gpu"``, ``"gpu:1"``, ``"cpu"``; ``"cuda"`` too) and holds for the
whole process.
"""
from __future__ import annotations

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "set_device", "get_device",
           "device_count", "resolve_device"]

_state = {"device": None}   # what set_device asked for (None: the default)


class Place:
    """Device identity, ``Place("gpu", 0)`` or ``Place("cpu")``, as
    ``paddle.CPUPlace()`` / ``paddle.CUDAPlace(i)`` give it."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type="gpu", device_id=0):
        self.device_type = "gpu" if device_type == "cuda" else device_type
        self.device_id = device_id

    @classmethod
    def of(cls, device: torch.device) -> "Place":
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        return cls(device.type, 0)

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device(self.device_type)

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"


def CPUPlace():
    return Place("cpu", 0)


def CUDAPlace(idx=0):
    return Place("gpu", idx)


def _torch_device(device) -> torch.device:
    if isinstance(device, Place):
        return device.torch_device
    if isinstance(device, str):
        kind, _, idx = device.partition(":")
        if kind == "gpu":
            kind = "cuda"
        device = f"{kind}:{idx}" if idx else kind
    return torch.device(device)


def set_device(device) -> Place:
    """``paddle.set_device``: the device that entry points and creation ops
    use when the caller names none. ``"cpu"`` is the caller asking for the
    CPU. Raises, as :func:`resolve_device` does, for a card that is not
    there."""
    dev = resolve_device(_torch_device(device))
    _state["device"] = dev
    return Place.of(dev)


def get_device() -> str:
    """``"gpu:0"`` or ``"cpu"``, as Paddle spells it; the default is the
    card."""
    dev = _state["device"] or torch.device("cuda", 0)
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def device_count(device_type=None) -> int:
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count()


def resolve_device(device=None) -> torch.device:
    """``None`` means what :func:`set_device` set, else ``cuda``; ``"cpu"``
    (or a CPU ``torch.device`` or ``Place``) is the only way onto the CPU.
    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is visible."""
    if device is None:
        device = _state["device"]
    dev = torch.device("cuda") if device is None else _torch_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or call set_device('cpu')) to "
            "run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
