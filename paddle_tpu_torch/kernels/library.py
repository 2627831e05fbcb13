"""Every kernel launch as a registered op, for compiled and exported
programs.

The kernels are bound through ``ctypes`` (``_build.function``, raw
``data_ptr()``s, a Python :data:`~paddle_tpu_torch.kernels.LAUNCHES`
counter). ``torch.compile`` cannot trace through a ctypes call, and
``torch.export`` runs the code on fake tensors that have no storage. So each
launch is registered here as an operator of the ``paddle_tpu_torch``
library (``torch.library.Library``: a schema, a CUDA and a CPU kernel, a
fake), which a compiled or exported graph calls as one node. They are
registered directly, not through ``torch.library.custom_op``, whose Python
wrappers (autograd, the aliasing check) cost ~140 us a call with torch 2.11
on an NVIDIA H100's host (a cProfile of a batch-1 ERNIE forward, 37 calls,
``PERF.md`` §6): more than the kernels take.

Each op's CUDA kernel is the launch (``*_cuda``), which launches or raises;
its CPU kernel is the plain version, which runs only for CPU tensors; its
fake gives each output's shape and dtype from the inputs' (symbolic) shapes.
The launch counters move inside the CUDA kernels, so compiled and exported
runs count their launches too. The ``autograd.Function``s of the kernel
modules call these ops where :func:`~paddle_tpu_torch.kernels.in_program`
says so (while tracing, or on functorch's wrapped tensors); eager calls on
plain tensors launch directly, so the host-bound eager paths pay no
dispatch for them.

- ``flash_attention_fwd`` / ``flash_attention_bwd``: dense flash attention,
  either design (``sm90`` or ``mma``) as in eager, ``mask`` the optional
  bool ``[B, H, Sq, Sk]`` view of the mask variant; ``seed`` the dropout
  seed as an int64 tensor the kernels read on the card (None without
  dropout), so a program draws a fresh one each call without a host sync;
- ``flash_varlen_fwd`` / ``flash_varlen_bwd``: packed sequences;
  ``max_q`` / ``max_k`` (ints: ``flash_attn_unpadded``'s ``max_seqlen_*``,
  else the total tokens) size the grid, where eager copies ``cu_seqlens``
  to the host, and every row starts at zero, so rows past ``cu[-1]`` get
  zeros without a host read;
- ``layernorm_fwd``, ``rmsnorm_fwd`` / ``rmsnorm_bwd`` (``h`` is an empty
  ``[0]`` tensor without a residual), ``softmax_ce_fwd`` /
  ``softmax_ce_bwd``, ``paged_attention``, ``ctc_alpha`` / ``ctc_beta``,
  ``rnnt_alpha`` / ``rnnt_beta_grad`` (the CTC and RNN-T kernels choose
  their route from the shapes inside the launch, as in eager).
"""
from __future__ import annotations

import torch

from . import plain_math
from .ctc import (ctc_alpha_cuda, ctc_alpha_plain, ctc_beta_cuda,
                  ctc_beta_plain)
from .flash_attention import (_bwd_plain, _fwd_plain, flash_attention_bwd_cuda,
                              flash_attention_cuda, flash_attn_varlen_bwd_cuda,
                              flash_attn_varlen_bwd_plain,
                              flash_attn_varlen_cuda, flash_attn_varlen_plain)
from .layernorm import _out_dtype, layer_norm_cuda, layer_norm_plain
from .paged_attention import paged_attention_cuda, paged_attention_plain
from .rmsnorm import (rmsnorm_bwd_cuda, rmsnorm_bwd_plain, rmsnorm_cuda,
                      rmsnorm_plain)
from .rnnt import (rnnt_alpha_cuda, rnnt_alpha_plain, rnnt_beta_grad_cuda,
                   rnnt_beta_grad_plain)
from .softmax_ce import (softmax_ce_bwd_cuda, softmax_ce_bwd_plain,
                         softmax_ce_cuda, softmax_ce_plain)

__all__ = ["OPS"]

_LIB = torch.library.Library("paddle_tpu_torch", "DEF")
_F32 = torch.float32


def _host_seed(seed):
    """The plain versions' int seed from the op's tensor (a CPU tensor)."""
    return 0 if seed is None else int(seed)


def _cpu(impl):
    """A plain version as an op's CPU kernel: its outputs contiguous, as
    the launches write them and the fakes state."""
    def run(*args):
        out = impl(*args)
        if isinstance(out, torch.Tensor):
            return out.contiguous()
        return tuple(t.contiguous() for t in out)
    return run


# -- flash attention, dense ------------------------------------------------

def _flash_fwd_cuda(q, k, v, mask, causal, sm_scale, dropout_p, seed):
    return flash_attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                                dropout_p=dropout_p, seed=seed, mask=mask)


def _flash_fwd_cpu(q, k, v, mask, causal, sm_scale, dropout_p, seed):
    with plain_math(q.device):
        out, lse = _fwd_plain(q, k, v, causal, sm_scale, dropout_p,
                              _host_seed(seed), mask)
    return out, lse


def _flash_fwd_fake(q, k, v, mask, causal, sm_scale, dropout_p, seed):
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, Sq), dtype=_F32))


def _flash_bwd_cuda(q, k, v, g, lse, dg, mask, causal, sm_scale, dropout_p,
                    seed):
    return flash_attention_bwd_cuda(q, k, v, g, lse, dg, causal=causal,
                                    sm_scale=sm_scale, dropout_p=dropout_p,
                                    seed=seed, mask=mask)


def _flash_bwd_cpu(q, k, v, g, lse, dg, mask, causal, sm_scale, dropout_p,
                   seed):
    with plain_math(q.device):
        return _bwd_plain(q, k, v, g, lse, dg, causal, sm_scale, dropout_p,
                          _host_seed(seed), mask)


def _flash_bwd_fake(q, k, v, g, lse, dg, mask, causal, sm_scale, dropout_p,
                    seed):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


# -- flash attention, packed sequences -------------------------------------

def _varlen_fwd_cuda(q, k, v, cu_q, cu_k, max_q, max_k, causal, sm_scale,
                     dropout_p, seed):
    return flash_attn_varlen_cuda(q, k, v, cu_q, cu_k, causal, sm_scale,
                                  dropout_p, seed, max_len=(max_q, max_k))


def _varlen_fwd_cpu(q, k, v, cu_q, cu_k, max_q, max_k, causal, sm_scale,
                    dropout_p, seed):
    return flash_attn_varlen_plain(q, k, v, cu_q, cu_k, causal, sm_scale,
                                   dropout_p, _host_seed(seed))


def _varlen_fwd_fake(q, k, v, cu_q, cu_k, max_q, max_k, causal, sm_scale,
                     dropout_p, seed):
    Tq, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((H, Tq), dtype=_F32))


def _varlen_bwd_cuda(q, k, v, g, lse, dg, cu_q, cu_k, max_q, max_k, causal,
                     sm_scale, dropout_p, seed):
    return flash_attn_varlen_bwd_cuda(q, k, v, g, lse, dg, cu_q, cu_k,
                                      causal, sm_scale, dropout_p, seed,
                                      max_len=(max_q, max_k))


def _varlen_bwd_cpu(q, k, v, g, lse, dg, cu_q, cu_k, max_q, max_k, causal,
                    sm_scale, dropout_p, seed):
    return flash_attn_varlen_bwd_plain(q, k, v, g, lse, dg, cu_q, cu_k,
                                       causal, sm_scale, dropout_p,
                                       _host_seed(seed))


def _varlen_bwd_fake(q, k, v, g, lse, dg, cu_q, cu_k, max_q, max_k, causal,
                     sm_scale, dropout_p, seed):
    return _flash_bwd_fake(q, k, v, None, None, None, None, None, None, None,
                           None)


# -- LayerNorm, RMSNorm, softmax-CE ----------------------------------------

def _layernorm_fake(x, weight, bias, eps):
    rows, cols = x.shape
    return (x.new_empty((rows, cols), dtype=_out_dtype(x, weight, bias)),
            x.new_empty((rows,), dtype=_F32), x.new_empty((rows,), dtype=_F32))


def _rmsnorm_fwd(impl):
    def run(x, weight, residual, eps):
        out, h, rstd = impl(x, weight, eps, residual)
        return out, (x.new_empty(0) if h is None else h), rstd
    return run


def _rmsnorm_fwd_fake(x, weight, residual, eps):
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty(0) if residual is None else
            torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty((x.shape[0],), dtype=_F32))


def _rmsnorm_bwd_fake(x, weight, rstd, g, residual):
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            torch.empty_like(weight))


def _softmax_ce_fwd_fake(x, labels):
    return (x.new_empty((x.shape[0],), dtype=_F32),
            x.new_empty((x.shape[0],), dtype=_F32))


def _softmax_ce_bwd_fake(x, labels, lse, g):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# -- paged attention, CTC, RNN-T -------------------------------------------

def _paged(impl):
    def run(q, kv_pool, block_tables, context_lens, sm_scale):
        return impl(q, kv_pool, block_tables, context_lens,
                    sm_scale=sm_scale)
    return run


def _paged_fake(q, kv_pool, block_tables, context_lens, sm_scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _ctc_lattice_fake(log_probs, labels, input_lengths, label_lengths):
    T, B = log_probs.shape[:2]
    return log_probs.new_empty((T, B, 2 * labels.shape[1] + 1), dtype=_F32)


def _ctc_alpha_fake(log_probs, labels, input_lengths, label_lengths, blank):
    return (_ctc_lattice_fake(log_probs, labels, input_lengths,
                              label_lengths),
            log_probs.new_empty((log_probs.shape[1],), dtype=_F32))


def _ctc_beta_fake(log_probs, labels, input_lengths, label_lengths, blank):
    return _ctc_lattice_fake(log_probs, labels, input_lengths, label_lengths)


def _rnnt_alpha_fake(blank_lp, emit_lp, t_len, u_len):
    return (blank_lp.new_empty(blank_lp.shape, dtype=_F32),
            blank_lp.new_empty((blank_lp.shape[0],), dtype=_F32))


def _rnnt_beta_grad(impl):
    def run(blank_lp, emit_lp, alphas, t_len, u_len, ll):
        gb, ge, _ = impl(blank_lp, emit_lp, alphas, t_len, u_len, ll)
        return gb, ge
    return run


def _rnnt_beta_grad_fake(blank_lp, emit_lp, alphas, t_len, u_len, ll):
    return tuple(blank_lp.new_empty(blank_lp.shape, dtype=_F32)
                 for _ in range(2))


# name: (schema, CUDA kernel, CPU kernel, fake)
OPS = {
    "flash_attention_fwd": (
        "(Tensor q, Tensor k, Tensor v, Tensor? mask, bool causal, "
        "float? sm_scale, float dropout_p, Tensor? seed) -> (Tensor, Tensor)",
        _flash_fwd_cuda, _flash_fwd_cpu, _flash_fwd_fake),
    "flash_attention_bwd": (
        "(Tensor q, Tensor k, Tensor v, Tensor g, Tensor lse, Tensor dg, "
        "Tensor? mask, bool causal, float? sm_scale, float dropout_p, "
        "Tensor? seed) -> (Tensor, Tensor, Tensor)",
        _flash_bwd_cuda, _flash_bwd_cpu, _flash_bwd_fake),
    "flash_varlen_fwd": (
        "(Tensor q, Tensor k, Tensor v, Tensor cu_q, Tensor cu_k, int max_q, "
        "int max_k, bool causal, float? sm_scale, float dropout_p, "
        "Tensor? seed) -> (Tensor, Tensor)",
        _varlen_fwd_cuda, _varlen_fwd_cpu, _varlen_fwd_fake),
    "flash_varlen_bwd": (
        "(Tensor q, Tensor k, Tensor v, Tensor g, Tensor lse, Tensor dg, "
        "Tensor cu_q, Tensor cu_k, int max_q, int max_k, bool causal, "
        "float? sm_scale, float dropout_p, Tensor? seed) -> "
        "(Tensor, Tensor, Tensor)",
        _varlen_bwd_cuda, _varlen_bwd_cpu, _varlen_bwd_fake),
    "layernorm_fwd": (
        "(Tensor x, Tensor weight, Tensor bias, float eps) -> "
        "(Tensor, Tensor, Tensor)",
        layer_norm_cuda, layer_norm_plain, _layernorm_fake),
    "rmsnorm_fwd": (
        "(Tensor x, Tensor weight, Tensor? residual, float eps) -> "
        "(Tensor, Tensor, Tensor)",
        _rmsnorm_fwd(rmsnorm_cuda), _rmsnorm_fwd(rmsnorm_plain),
        _rmsnorm_fwd_fake),
    "rmsnorm_bwd": (
        "(Tensor x, Tensor weight, Tensor rstd, Tensor g, Tensor? residual) "
        "-> (Tensor, Tensor)",
        rmsnorm_bwd_cuda, rmsnorm_bwd_plain, _rmsnorm_bwd_fake),
    "softmax_ce_fwd": (
        "(Tensor x, Tensor labels) -> (Tensor, Tensor)",
        softmax_ce_cuda, softmax_ce_plain, _softmax_ce_fwd_fake),
    "softmax_ce_bwd": (
        "(Tensor x, Tensor labels, Tensor lse, Tensor g) -> Tensor",
        softmax_ce_bwd_cuda, softmax_ce_bwd_plain, _softmax_ce_bwd_fake),
    "paged_attention": (
        "(Tensor q, Tensor kv_pool, Tensor block_tables, "
        "Tensor context_lens, float? sm_scale) -> Tensor",
        _paged(paged_attention_cuda), _paged(paged_attention_plain),
        _paged_fake),
    "ctc_alpha": (
        "(Tensor log_probs, Tensor labels, Tensor input_lengths, "
        "Tensor label_lengths, int blank) -> (Tensor, Tensor)",
        ctc_alpha_cuda, ctc_alpha_plain, _ctc_alpha_fake),
    "ctc_beta": (
        "(Tensor log_probs, Tensor labels, Tensor input_lengths, "
        "Tensor label_lengths, int blank) -> Tensor",
        ctc_beta_cuda, ctc_beta_plain, _ctc_beta_fake),
    "rnnt_alpha": (
        "(Tensor blank_lp, Tensor emit_lp, Tensor t_len, Tensor u_len) -> "
        "(Tensor, Tensor)",
        rnnt_alpha_cuda, rnnt_alpha_plain, _rnnt_alpha_fake),
    "rnnt_beta_grad": (
        "(Tensor blank_lp, Tensor emit_lp, Tensor alphas, Tensor t_len, "
        "Tensor u_len, Tensor ll) -> (Tensor, Tensor)",
        _rnnt_beta_grad(rnnt_beta_grad_cuda),
        _rnnt_beta_grad(rnnt_beta_grad_plain), _rnnt_beta_grad_fake),
}

for _name, (_schema, _cuda, _plain, _fake) in OPS.items():
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu(_plain), "CPU")
    torch.library.register_fake(f"paddle_tpu_torch::{_name}", _fake,
                                lib=_LIB)

flash_attention_fwd = torch.ops.paddle_tpu_torch.flash_attention_fwd.default
layernorm_fwd = torch.ops.paddle_tpu_torch.layernorm_fwd.default
