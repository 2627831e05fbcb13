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
program the LayerNorm and flash forwards run as registered ops
(``library.py``); every other launch raises :class:`NotCompilable` there
(:func:`refuse_compile`), never running eagerly in silence. The kernels so
far (the
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
           "launch_counts", "reset_launch_counts", "NotCompilable",
           "refuse_compile"]

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


class NotCompilable(RuntimeError):
    """A kernel launch met while ``torch.compile`` or ``torch.export``
    traces, where the launch is not registered as an op."""


def refuse_compile(name: str) -> None:
    """Raise :class:`NotCompilable` naming kernel ``name`` while
    ``torch.compile`` / ``torch.export`` traces: its ctypes launch cannot
    be traced, and it is not one of the registered ops of
    ``kernels/library.py`` (flash attention's forward and LayerNorm's),
    so a compiled or exported program never runs it eagerly in silence."""
    if torch.compiler.is_compiling():
        raise NotCompilable(
            f"the {name} kernel is not registered as an op: it cannot run "
            f"inside a compiled or exported program (to_static, jit.save, "
            f"static.Executor); only flash attention's forward and "
            f"LayerNorm's forward can so far (ROADMAP)")


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
