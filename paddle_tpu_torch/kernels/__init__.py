"""Kernel selection layer (counterpart of ``paddle_tpu/kernels/__init__.py``).

The JAX package picks a Pallas kernel or its jnp mirror from the platform
policy. Here the choice is the tensor's device and nothing else:

- tensors on a CUDA device go to the hand-written Hopper kernel, which
  launches or raises (there is no ``try`` that falls back);
- tensors on the CPU go to the kernel's plain PyTorch version, which the
  CPU tests hold against the JAX package.

Every wrapper adds one to its entry of :data:`LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels. The kernels of this slice:

=================  ==========================  ================================
name               port                        replaces (TPU kernel)
=================  ==========================  ================================
flash_attention    kernels/flash_attention.py  kernels/flash_attention.py
                   + csrc/flash_attention.cu   ``_fwd_kernel``
paged_attention    kernels/paged_attention.py  kernels/paged_attention.py
                   + csrc/paged_attention.cu   ``_paged_kernel``
rmsnorm            kernels/rmsnorm.py          kernels/rmsnorm.py
                   + csrc/rmsnorm.cu           ``_fwd_kernel``
=================  ==========================  ================================
"""
from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "use_kernel", "launch_counts", "reset_launch_counts"]

# launches per kernel since the last reset (plain ints)
LAUNCHES: dict[str, int] = {
    "flash_attention": 0,
    "paged_attention": 0,
    "rmsnorm": 0,
}


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (run the plain version). Tensors split across
    devices, or on any other device, raise."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(
        f"kernel inputs must all lie on one CUDA device or all on the CPU; "
        f"got {sorted(str(t.device) for t in tensors)}")


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
