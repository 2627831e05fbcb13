"""Kernel selection layer (counterpart of ``paddle_tpu/kernels/__init__.py``).

The JAX package picks a Pallas kernel or its jnp mirror from the platform
policy. Here the choice is the tensor's device and nothing else:

- tensors on a CUDA device go to the hand-written Hopper kernel, which
  launches or raises (there is no ``try`` that falls back);
- tensors on the CPU go to the kernel's plain PyTorch version, which the
  CPU tests hold against the JAX package.

Every wrapper adds one to its entry of :data:`LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels. A gradient goes through a ``torch.autograd.Function``
whose backward is a kernel too; a raw ``*_cuda`` wrapper, which returns
buffers a ctypes launch filled, raises when it is handed a tensor that
requires grad while grad mode is on (:func:`refuse_grad`), so no output is
ever cut from the autograd graph in silence. Inside a compiled or exported
program, and on functorch's wrapped tensors (``torch.func.grad``, which
``static.gradients`` replays through), every launch runs as a registered op
(``library.py``, :func:`in_program`); eager calls launch directly. The
kernels so far (the
flash kernels count their dropout, bool-mask and varlen variants under
their own names, so a run can show which variant its path took, and each
launch once more under the design that ran it:
``flash_attention{,_bwd}_sm90``, the wgmma / TMA kernels
``flash_attention{,_bwd}_sm90.cu`` and ``.cuh``, or ``_mma``, the mma.sync
ones):

===========================  =============================  =====================
name                         port (kernels/ + csrc/)        replaces, in
                                                            paddle_tpu/kernels
===========================  =============================  =====================
ctc_alpha                    ctc.py, ctc.cu                 ctc.py
                                                            ``_alpha_kernel``
ctc_beta                     ctc.py, ctc.cu                 ``_beta_kernel``
flash_attention              flash_attention.py,            flash_attention.py
                             flash_attention.cu             ``_fwd_kernel``
flash_attention_dropout      the same, dropout p > 0        with ``_drop_mask``
flash_attention_mask         the same, a bool mask          with ``_tile_mask``
flash_attention_varlen       the same, packed sequences     with segment ids
flash_attention_bwd          flash_attention.py,            ``_bwd_dq_kernel``,
                             flash_attention_bwd.cu         ``_bwd_dkv_kernel``
flash_attention_bwd_dropout  the same, dropout p > 0        with ``_drop_mask``
flash_attention_bwd_mask     the same, a bool mask          with ``_tile_mask``
flash_attention_bwd_varlen   the same, packed sequences     with segment ids
layernorm                    layernorm.py, layernorm.cu     layernorm.py
                                                            ``_fwd_kernel``
paged_attention              paged_attention.py,            paged_attention.py
                             paged_attention.cu             ``_paged_kernel``
rmsnorm                      rmsnorm.py, rmsnorm.cu         rmsnorm.py
                                                            ``_fwd_kernel``
rmsnorm_bwd                  rmsnorm.py, rmsnorm.cu         ``_bwd_kernel``
rnnt_alpha                   rnnt.py, rnnt.cu               rnnt.py
                                                            ``_alpha_kernel``
rnnt_beta_grad               rnnt.py, rnnt.cu               ``_beta_grad_kernel``
softmax_ce                   softmax_ce.py, softmax_ce.cu   softmax_ce.py
                                                            ``_fwd_kernel``
softmax_ce_bwd               softmax_ce.py, softmax_ce.cu   ``_bwd_kernel``
===========================  =============================  =====================
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["LAUNCHES", "use_kernel", "refuse_grad", "plain_math",
           "launch_counts", "reset_launch_counts", "in_program"]

# launches per kernel since the last reset (plain ints)
LAUNCHES: dict[str, int] = {
    "ctc_alpha": 0,
    "ctc_beta": 0,
    "flash_attention": 0,
    "flash_attention_dropout": 0,
    "flash_attention_mask": 0,
    "flash_attention_varlen": 0,
    "flash_attention_sm90": 0,
    "flash_attention_mma": 0,
    "flash_attention_bwd": 0,
    "flash_attention_bwd_dropout": 0,
    "flash_attention_bwd_mask": 0,
    "flash_attention_bwd_varlen": 0,
    "flash_attention_bwd_sm90": 0,
    "flash_attention_bwd_mma": 0,
    "layernorm": 0,
    "paged_attention": 0,
    "rmsnorm": 0,
    "rmsnorm_bwd": 0,
    "rnnt_alpha": 0,
    "rnnt_beta_grad": 0,
    "softmax_ce": 0,
    "softmax_ce_bwd": 0,
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


def refuse_grad(name: str, *tensors) -> None:
    """Raise when a raw kernel wrapper would cut the autograd graph: grad
    mode is on and one of its inputs requires grad. The differentiable
    entry points call the wrappers inside ``autograd.Function``s, where
    grad mode is off."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the raw kernel wrapper has no autograd; call the "
            f"differentiable entry point instead, or run under "
            f"torch.no_grad()")


def in_program(*tensors) -> bool:
    """True where a kernel call must go through its registered op
    (``library.py``): while ``torch.compile`` or ``torch.export`` traces
    (a ctypes launch cannot be traced), or where a tensor is one of
    functorch's wrappers (the backward of a Function under an eager
    ``torch.func.grad``), which has no storage to hand a launch; the op's
    dispatch unwraps it. Eager calls on plain tensors launch directly."""
    return torch.compiler.is_compiling() or any(
        t is not None and torch._C._functorch.is_functorch_wrapped_tensor(t)
        for t in tensors)


def plain_math(device: torch.device):
    """A context that turns autocast off on ``device``'s type: a plain
    version computes in the dtypes it states (f32 products), also inside
    ``amp.auto_cast``, whose autocast would otherwise run its einsums in
    bf16."""
    if device.type not in ("cpu", "cuda"):
        return contextlib.nullcontext()
    return torch.autocast(device.type, enabled=False)


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


from . import library  # noqa: E402,F401  (registers the ops)
