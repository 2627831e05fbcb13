"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``;
ports ``cross_entropy``, ``ctc_loss`` and ``rnnt_loss``)."""
from __future__ import annotations

import torch

from ...kernels.ctc import ctc_lattice
from ...kernels.rnnt import NEG, rnnt_lattice
from ...kernels.softmax_ce import softmax_ce

__all__ = ["cross_entropy", "ctc_loss", "rnnt_loss"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Paddle's ``cross_entropy`` over ``axis``.

    Hard integer labels over the last axis with the softmax, no weight and
    no smoothing (the language-model head's case) go through the
    softmax-CE kernel on the card (its plain version on the CPU), with the
    reference's handling of ``ignore_index``: ignored rows take label 0
    into the kernel, their loss is masked to 0 after, and the mean is over
    the valid rows (at least 1). The loss is then float32. Soft labels,
    label smoothing and class weights are plain PyTorch compositions of the
    reference's formulas, in the input's dtype."""
    ax = axis % input.ndim
    soft = soft_label or (label.ndim == input.ndim
                          and label.shape == input.shape)
    if soft:
        logp = _log_probs(input, ax, use_softmax)
        target = label
        if label_smoothing:
            target = (target * (1 - label_smoothing)
                      + label_smoothing / input.shape[ax])
        return _reduce(-(target * logp).sum(ax), reduction)
    lbl = label.squeeze(ax) if label.ndim == input.ndim else label
    if lbl.dtype not in (torch.int32, torch.int64):
        lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    if (use_softmax and not label_smoothing and weight is None
            and ax == input.ndim - 1):
        loss = torch.where(valid, softmax_ce(input, safe), 0.0)
    else:
        logp = _log_probs(input, ax, use_softmax)
        picked = logp.gather(ax, safe.long().unsqueeze(ax)).squeeze(ax)
        if label_smoothing:
            picked = ((1 - label_smoothing) * picked
                      + label_smoothing * logp.mean(ax))
        loss = torch.where(valid, -picked, 0.0)
        if weight is not None:
            wsel = torch.where(valid, weight[safe.long()], 0.0)
            loss = loss * wsel
            if reduction == "mean":
                return loss.sum() / wsel.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1).to(loss.dtype)
    return _reduce(loss, reduction)


def _log_probs(input, ax, use_softmax):
    if use_softmax:
        return torch.log_softmax(input, dim=ax)
    return torch.log(input.clamp_min(1e-30))


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss of ``log_probs`` ``[T, B, C]`` (Paddle's layout) against
    ``labels`` ``[B, L]`` padded with blank, with ``input_lengths`` and
    ``label_lengths`` ``[B]``; differentiable in log_probs.

    The lattice runs the CTC alpha and beta kernels on CUDA tensors and
    their plain versions on CPU tensors (``kernels/ctc.py``); labels and
    lengths follow log_probs to its device. ``norm_by_times`` divides each
    utterance's loss by its input length (at least 1); the reductions are
    the JAX package's (``"mean"`` is the batch mean, not upstream Paddle's
    division by the label lengths). The loss is float32."""
    dev = log_probs.device
    labels, input_lengths, label_lengths = (
        t.to(dev) for t in (labels, input_lengths, label_lengths))
    loss = ctc_lattice(log_probs, labels, input_lengths, label_lengths,
                       blank)
    if norm_by_times:
        loss = loss / input_lengths.to(loss.dtype).clamp_min(1.0)
    return _reduce(loss, reduction)


def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean"):
    """RNN-Transducer loss (Graves 2012) of the joint network's ``logits``
    ``[B, T, U + 1, V]`` against ``labels`` ``[B, U]``, with
    ``logit_lengths`` and ``label_lengths`` ``[B]``; differentiable in
    logits. The loss is float32 (the logits are upcast first, as the
    reference's ``lg.astype(float32)``).

    The reference's steps: ``log_softmax``; ``blank_lp = lp[..., blank]``
    ``[B, T, U + 1]``; ``emit_lp`` the labels' log-probs at ``u < U``;
    FastEmit's ``+ log1p(fastemit_lambda)`` on every emit log-prob; emits
    at ``u >= label_length`` set to -1e30 (and a -1e30 column at ``U``).
    Every complete path takes exactly ``label_length`` emits, so FastEmit
    shifts each utterance's loss by ``-label_length * log1p(lambda)`` and
    leaves every gradient unchanged (the reference's behaviour, kept; Yu
    et al.'s FastEmit scales the emit gradient instead). The lattice runs
    the RNN-T alpha and beta-gradient kernels on CUDA tensors and their
    plain versions on CPU tensors (``kernels/rnnt.py``); its gradients
    reach the logits through autograd of the gather and ``log_softmax``.
    Labels and lengths follow logits to its device. ``"mean"`` is the
    mean over the batch (the JAX package's ``_reduce``), not a division
    by the label lengths."""
    dev = logits.device
    labels, logit_lengths, label_lengths = (
        t.to(dev) for t in (labels, logit_lengths, label_lengths))
    B, T, U1, V = logits.shape
    U = U1 - 1
    if labels.shape != (B, U):
        raise ValueError(f"rnnt_loss: labels must be [{B}, {U}] for logits "
                         f"{tuple(logits.shape)}; got {tuple(labels.shape)}")
    lp = torch.log_softmax(logits.float(), dim=-1)
    blank_lp = lp[..., blank].contiguous()
    idx = labels.long().clamp(0, V - 1)[:, None, :, None].expand(B, T, U, 1)
    emit_lp = lp[:, :, :U].gather(3, idx).squeeze(3)
    if fastemit_lambda:
        emit_lp = emit_lp + torch.log1p(torch.tensor(
            fastemit_lambda, dtype=torch.float32, device=dev))
    valid = torch.arange(U, device=dev) < label_lengths[:, None]
    emit_lp = torch.where(valid[:, None, :], emit_lp, NEG)
    emit_lp = torch.nn.functional.pad(emit_lp, (0, 1), value=NEG)
    loss = rnnt_lattice(blank_lp, emit_lp, logit_lengths, label_lengths)
    return _reduce(loss, reduction)
