"""The kernel launches of the static-graph path as registered ops.

The kernels are bound through ``ctypes`` (``_build.function``, raw
``data_ptr()``s, a Python :data:`~paddle_tpu_torch.kernels.LAUNCHES`
counter). ``torch.compile`` cannot trace through a ctypes call, and
``torch.export`` runs the code on fake tensors that have no storage. So the
forward launches that ``jit.to_static``, ``jit.save`` and
``static.Executor`` reach on the ERNIE serving path are registered here as
operators of the ``paddle_tpu_torch`` library (``torch.library.Library``:
a schema, a CUDA and a CPU kernel, a fake), which a compiled or exported
graph calls as one node. They are registered directly, not through
``torch.library.custom_op``, whose Python wrappers (autograd, the
aliasing check) cost ~140 us a call with torch 2.11 on an NVIDIA H100's
host (a cProfile of a batch-1 ERNIE forward, 37 calls, ``PERF.md`` §6):
more than the kernels take.

- ``paddle_tpu_torch::flash_attention_fwd(q, k, v, mask, causal, sm_scale,
  dropout_p, seed) -> (out, lse)``: ``flash_attention_cuda`` on CUDA
  tensors, ``_fwd_plain`` on CPU tensors; ``mask`` is the optional bool
  ``[B, H, Sq, Sk]`` view of the mask variant;
- ``paddle_tpu_torch::layernorm_fwd(x, weight, bias, eps) -> (out, mean,
  rstd)``: ``layer_norm_cuda`` on CUDA tensors, ``layer_norm_plain`` on
  CPU tensors.

Their fake implementations give each output's shape and dtype from the
inputs' (symbolic) shapes. The launch counters move inside the ops'
bodies, so compiled and exported runs count their launches too.
``FlashAttentionFunction`` and ``LayerNormFunction`` call these ops only
while ``torch.compiler.is_compiling()``; in eager they call the launches
directly, so the host-bound eager paths pay no dispatch for them. The
other kernels are not registered: reaching one while tracing raises
:class:`~paddle_tpu_torch.kernels.NotCompilable` naming it.
"""
from __future__ import annotations

import torch

from . import plain_math
from .flash_attention import _fwd_plain, flash_attention_cuda
from .layernorm import _out_dtype, layer_norm_cuda, layer_norm_plain

__all__ = ["flash_attention_fwd", "layernorm_fwd"]


_LIB = torch.library.Library("paddle_tpu_torch", "DEF")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor? mask, "
            "bool causal, float? sm_scale, float dropout_p, int seed) -> "
            "(Tensor, Tensor)")
_LIB.define("layernorm_fwd(Tensor x, Tensor weight, Tensor bias, float eps) "
            "-> (Tensor, Tensor, Tensor)")


def _flash_cuda(q, k, v, mask, causal, sm_scale, dropout_p, seed):
    return flash_attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                                dropout_p=dropout_p, seed=seed, mask=mask)


def _flash_cpu(q, k, v, mask, causal, sm_scale, dropout_p, seed):
    with plain_math(q.device):
        out, lse = _fwd_plain(q, k, v, causal, sm_scale, dropout_p, seed,
                              mask)
    # the kernel's layouts: contiguous [B, Sq, H, D] and [B, H, Sq]
    return out.contiguous(), lse.contiguous()


def _flash_fake(q, k, v, mask, causal, sm_scale, dropout_p, seed):
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _layernorm_cuda(x, weight, bias, eps):
    return layer_norm_cuda(x, weight, bias, eps)


def _layernorm_cpu(x, weight, bias, eps):
    out, mean, rstd = layer_norm_plain(x, weight, bias, eps)
    # the plain version's mean / rstd are views of [rows, 1] columns
    return out, mean.contiguous(), rstd.contiguous()


def _layernorm_fake(x, weight, bias, eps):
    rows, cols = x.shape
    return (x.new_empty((rows, cols), dtype=_out_dtype(x, weight, bias)),
            x.new_empty((rows,), dtype=torch.float32),
            x.new_empty((rows,), dtype=torch.float32))


for _name, _cuda, _cpu, _fake in (
        ("flash_attention_fwd", _flash_cuda, _flash_cpu, _flash_fake),
        ("layernorm_fwd", _layernorm_cuda, _layernorm_cpu, _layernorm_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"paddle_tpu_torch::{_name}", _fake,
                                lib=_LIB)

flash_attention_fwd = torch.ops.paddle_tpu_torch.flash_attention_fwd.default
layernorm_fwd = torch.ops.paddle_tpu_torch.layernorm_fwd.default
