"""CTC loss lattice: the CUDA alpha and beta kernels, their plain versions
and the autograd Function that joins them.

Replaces ``paddle_tpu/kernels/ctc.py`` ``_alpha_kernel`` (its
``pallas_call`` in ``_alphas``) and ``_beta_kernel`` (in ``_betas``);
public ``ctc_loss_pallas``, whose ``custom_vjp`` becomes
:class:`CTCLossFunction`. The kernels are ``csrc/ctc.cu``: one thread
block per utterance, threads over the extended states, the lattice row
double-buffered in shared memory (one ``__syncthreads`` a time step),
``log_probs[t, b, ext[s]]`` read straight from the ``[T, B, C]`` input.
T dependent steps on B blocks bound them by latency, not by bytes or
flops.

The arithmetic is the reference kernels': -1e30 is the log-space -inf,
:func:`_lse3` keeps their guard, the skip from ``s - 2`` is barred where
``ext[s] == ext[s - 2]`` and at states 0 and 1, the alpha row at t = 0 is
``log_probs`` at states 0 and 1, the beta rows take their terminal value
at ``t == in_len - 1`` and keep -1e30 after it, and the log-likelihood is
``logaddexp(alpha[in_len - 1, 2L], alpha[in_len - 1, 2L - 1])`` (the second
term barred when the label is empty). For CPU tensors the Function runs
:func:`ctc_alpha_plain` and :func:`ctc_beta_plain`, the same recursions in
PyTorch over ``[B, S]`` rows, one time step a loop iteration (the
reference's ``lax.scan`` lattice, with the kernels' guard).

The gradient, ``-g * exp(alpha + beta - ll)`` scattered from the states to
the classes, is :func:`ctc_grad`, a PyTorch composition on both devices
with the reference's one-hot product (``_bwd``), a fixed-order sum, so
runs repeat bit for bit. One deliberate difference: an utterance with no
feasible alignment (``in_len`` shorter than its label and repeats need)
has loss 1e30 in both packages, but here a zero gradient. In the reference
``alpha + beta - ll`` cancels to 0 where alpha is finite and beta is
-1e30 (both -1e30 absorb the finite part in f32), so its gradient there is
a count of such states (its Pallas and scan paths disagree on it).
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build, plain_math, refuse_grad, use_kernel

__all__ = ["NEG", "MAX_STATES", "extended_labels",
           "ctc_alpha_plain", "ctc_beta_plain", "ctc_alpha_cuda",
           "ctc_beta_cuda", "ctc_grad", "CTCLossFunction", "ctc_lattice"]

NEG = -1e30
MAX_STATES = 8192          # csrc/ctc.cu: 1024 threads x 8 states a thread
_P, _I = ctypes.c_void_p, ctypes.c_int


def extended_labels(labels, blank):
    """``[B, 2L + 1]`` int64: blank, l1, blank, l2, ..., blank."""
    B, L = labels.shape
    ext = torch.full((B, 2 * L + 1), blank, dtype=torch.int64,
                     device=labels.device)
    ext[:, 1::2] = labels.long()
    return ext


def _lse3(a, b, c):
    """``log(e^a + e^b + e^c)``, exactly -1e30 where the largest term is
    below -5e29 (the reference's ``_lse3``)."""
    m = torch.maximum(a, torch.maximum(b, c))
    dead = m <= NEG / 2
    safe = torch.where(dead, 0.0, m)
    out = safe + torch.log(torch.exp(a - safe) + torch.exp(b - safe)
                           + torch.exp(c - safe))
    return torch.where(dead, NEG, out)


def _shift(x, k, fill=NEG):
    """``x[:, s - k]`` along the states (``k < 0``: ``x[:, s + |k|]``),
    ``fill`` where that falls outside; any S, 1 included."""
    S = x.shape[1]
    if k > 0:
        return torch.nn.functional.pad(x, (k, 0), value=fill)[:, :S]
    return torch.nn.functional.pad(x, (0, -k), value=fill)[:, -k:]


def _lattice_inputs(log_probs, labels, blank):
    """``(logp_ext [T, B, S] f32, ext [B, S], noskip [B, S] bool)`` with
    labels clamped into ``[0, C)`` as the kernels clamp them."""
    T, B, C = log_probs.shape
    ext = extended_labels(labels.long().clamp(0, C - 1), blank)
    S = ext.shape[1]
    logp_ext = log_probs.float().gather(2, ext[None].expand(T, B, S))
    noskip = torch.ones(B, S, dtype=torch.bool, device=ext.device)
    noskip[:, 2:] = ext[:, 2:] == ext[:, :-2]
    return logp_ext, ext, noskip


def _check(log_probs, labels, input_lengths, label_lengths):
    if log_probs.dim() != 3 or labels.dim() != 2 \
            or labels.shape[0] != log_probs.shape[1] \
            or input_lengths.shape != (log_probs.shape[1],) \
            or label_lengths.shape != (log_probs.shape[1],):
        raise ValueError(
            f"ctc: log_probs must be [T, B, C], labels [B, L], the lengths "
            f"[B]; got {tuple(log_probs.shape)}, {tuple(labels.shape)}, "
            f"{tuple(input_lengths.shape)}, {tuple(label_lengths.shape)}")
    if log_probs.shape[0] == 0:
        raise ValueError("ctc: log_probs has no time steps")


def ctc_alpha_plain(log_probs, labels, input_lengths, label_lengths,
                    blank=0):
    """Plain PyTorch forward lattice. Returns ``(alphas [T, B, S] f32,
    ll [B] f32)``, ``S = 2L + 1``."""
    _check(log_probs, labels, input_lengths, label_lengths)
    with plain_math(log_probs.device):
        logp_ext, _, noskip = _lattice_inputs(log_probs, labels, blank)
        T, B, S = logp_ext.shape
        state = torch.arange(S, device=logp_ext.device)
        alpha = torch.where(state < 2, logp_ext[0], NEG)
        rows = [alpha]
        for t in range(1, T):
            a3 = torch.where(noskip, NEG, _shift(alpha, 2))
            alpha = _lse3(alpha, _shift(alpha, 1), a3) + logp_ext[t]
            rows.append(alpha)
        alphas = torch.stack(rows)
        tl = (input_lengths.long() - 1).clamp(0, T - 1)
        sl = (2 * label_lengths.long()).clamp(0, S - 1)
        last = alphas[tl, torch.arange(B, device=alphas.device)]
        a_end = last.gather(1, sl[:, None])[:, 0]
        a_pre = last.gather(1, (sl - 1).clamp_min(0)[:, None])[:, 0]
        a_pre = torch.where(sl > 0, a_pre, NEG)
        return alphas, torch.logaddexp(a_end, a_pre)


def ctc_beta_plain(log_probs, labels, input_lengths, label_lengths,
                   blank=0):
    """Plain PyTorch backward lattice: ``betas [T, B, S]`` f32, -1e30 for
    ``t >= in_len``; ``beta[t, s]`` excludes ``log_probs[t, ext[s]]``."""
    _check(log_probs, labels, input_lengths, label_lengths)
    with plain_math(log_probs.device):
        logp_ext, _, noskip = _lattice_inputs(log_probs, labels, blank)
        T, B, S = logp_ext.shape
        dev = logp_ext.device
        state = torch.arange(S, device=dev)[None]
        il = input_lengths.long()[:, None]
        sl = 2 * label_lengths.long()[:, None]
        init = torch.where((state == sl) | ((state == sl - 1) & (sl > 0)),
                           0.0, NEG)
        skip_ok = ~_shift(noskip, -2, fill=True)   # s + 2 may come from s
        tmp = torch.full((B, S), NEG, device=dev)
        rows = [None] * T
        for t in range(T - 1, -1, -1):
            b3 = torch.where(skip_ok, _shift(tmp, -2), NEG)
            beta = _lse3(tmp, _shift(tmp, -1), b3)
            beta = torch.where(t == il - 1, init, beta)
            beta = torch.where(t >= il, NEG, beta)
            rows[t] = beta
            tmp = logp_ext[t] + beta
        return torch.stack(rows)


def _kernel_inputs(log_probs, labels, input_lengths, label_lengths):
    _check(log_probs, labels, input_lengths, label_lengths)
    S = 2 * labels.shape[1] + 1
    if S > MAX_STATES:
        raise ValueError(
            f"ctc kernels hold at most {MAX_STATES} extended states (labels "
            f"of {(MAX_STATES - 1) // 2}) in shared memory; got S = {S}")
    if log_probs.dtype not in (torch.float32, torch.bfloat16,
                               torch.float16):
        raise TypeError(f"ctc kernels take float log_probs; got "
                        f"{log_probs.dtype}")
    return (log_probs.float().contiguous(), labels.int().contiguous(),
            input_lengths.int().contiguous(),
            label_lengths.int().contiguous())


def ctc_alpha_cuda(log_probs, labels, input_lengths, label_lengths,
                   blank=0):
    """Launch ``ctc_alpha`` of ``csrc/ctc.cu``; same contract as
    :func:`ctc_alpha_plain`."""
    refuse_grad("ctc_alpha_cuda", log_probs)
    lp, lbl, il, ll_len = _kernel_inputs(log_probs, labels, input_lengths,
                                         label_lengths)
    T, B, C = lp.shape
    L = lbl.shape[1]
    alphas = torch.empty(T, B, 2 * L + 1, device=lp.device,
                         dtype=torch.float32)
    ll = torch.empty(B, device=lp.device, dtype=torch.float32)
    fn = _build.function("ctc", "ctc_alpha", [_P] * 6 + [_I] * 5 + [_P])
    err = fn(lp.data_ptr(), lbl.data_ptr(), il.data_ptr(), ll_len.data_ptr(),
             alphas.data_ptr(), ll.data_ptr(), T, B, C, L, int(blank),
             torch.cuda.current_stream(lp.device).cuda_stream)
    _build.check(err, "ctc", "ctc_alpha launch")
    LAUNCHES["ctc_alpha"] += 1
    return alphas, ll


def ctc_beta_cuda(log_probs, labels, input_lengths, label_lengths,
                  blank=0):
    """Launch ``ctc_beta`` of ``csrc/ctc.cu``; same contract as
    :func:`ctc_beta_plain`."""
    refuse_grad("ctc_beta_cuda", log_probs)
    lp, lbl, il, ll_len = _kernel_inputs(log_probs, labels, input_lengths,
                                         label_lengths)
    T, B, C = lp.shape
    L = lbl.shape[1]
    betas = torch.empty(T, B, 2 * L + 1, device=lp.device,
                        dtype=torch.float32)
    fn = _build.function("ctc", "ctc_beta", [_P] * 5 + [_I] * 5 + [_P])
    err = fn(lp.data_ptr(), lbl.data_ptr(), il.data_ptr(), ll_len.data_ptr(),
             betas.data_ptr(), T, B, C, L, int(blank),
             torch.cuda.current_stream(lp.device).cuda_stream)
    _build.check(err, "ctc", "ctc_beta launch")
    LAUNCHES["ctc_beta"] += 1
    return betas


def ctc_grad(alphas, betas, ll, labels, g, num_classes, blank=0):
    """``d(sum_b g[b] * -ll[b]) / d log_probs`` ``[T, B, C]`` f32 (both
    devices): the posterior ``exp(alpha + beta - ll)`` of each extended
    state, times ``-g``, summed onto its class by a one-hot product (the
    reference's ``_bwd``). Rows without a feasible alignment
    (``ll <= -5e29``) get 0."""
    with plain_math(alphas.device):
        feasible = (ll > NEG / 2)[None, :, None]
        post = torch.where(feasible, torch.exp(alphas + betas
                                               - ll[None, :, None]), 0.0)
        g_ext = -post * g.float()[None, :, None]
        C = num_classes
        ext = extended_labels(labels.long().clamp(0, C - 1), blank)
        onehot = torch.nn.functional.one_hot(ext, C).float()   # [B, S, C]
        return torch.einsum("tbs,bsc->tbc", g_ext, onehot)


class CTCLossFunction(torch.autograd.Function):
    """``(log_probs [T, B, C], labels [B, L], input_lengths [B],
    label_lengths [B], blank) -> loss [B] = -ll``, differentiable in
    log_probs only. The alpha kernel forward and the beta kernel backward
    for CUDA tensors; their plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank):
        cuda = use_kernel(log_probs, labels, input_lengths, label_lengths)
        alpha = ctc_alpha_cuda if cuda else ctc_alpha_plain
        alphas, ll = alpha(log_probs, labels, input_lengths, label_lengths,
                           blank)
        ctx.cuda, ctx.blank = cuda, blank
        ctx.dtype, ctx.num_classes = log_probs.dtype, log_probs.shape[2]
        ctx.save_for_backward(log_probs, labels, input_lengths,
                              label_lengths, alphas, ll)
        return -ll

    @staticmethod
    def backward(ctx, g):
        log_probs, labels, in_len, lbl_len, alphas, ll = ctx.saved_tensors
        beta = ctc_beta_cuda if ctx.cuda else ctc_beta_plain
        betas = beta(log_probs, labels, in_len, lbl_len, ctx.blank)
        grad = ctc_grad(alphas, betas, ll, labels, g, ctx.num_classes,
                        ctx.blank)
        return grad.to(ctx.dtype), None, None, None, None


def ctc_lattice(log_probs, labels, input_lengths, label_lengths, blank=0):
    """Per-utterance negative log-likelihood ``[B]`` f32 (no reduction, as
    the reference's ``ctc_loss_pallas``); differentiable in log_probs."""
    return CTCLossFunction.apply(log_probs, labels, input_lengths,
                                 label_lengths, int(blank))
