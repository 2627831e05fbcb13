"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` (and ``softmax_with_cross_entropy`` through it), the CTC
and the RNN-T losses run the port's kernels; the others are the
reference's formulas, none of which is a Pallas kernel there. ``"mean"``
and ``"sum"`` reduce over every element, ``"none"`` keeps them."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...kernels.ctc import ctc_lattice
from ...kernels.rnnt import NEG, rnnt_lattice
from ...kernels.softmax_ce import softmax_ce

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div", "smooth_l1_loss",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
           "square_error_cost", "sigmoid_focal_loss", "dice_loss",
           "ctc_loss", "rnnt_loss"]


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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced ``cross_entropy`` with the class axis kept (size 1):
    hard labels over the last axis take the softmax-CE kernel on the card,
    as the reference routes them; with ``return_softmax`` also the
    softmax of ``logits``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.ndim < logits.ndim:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)


def square_error_cost(input, label):
    return (input - label).square()


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``input`` ``[N, C, ...]``
    at ``label`` ``[N, ...]`` (or ``[N, 1]``), class axis 1; ignored
    labels count 0 and leave the mean's denominator, class weights weigh
    it."""
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    if input.ndim == lbl.ndim + 1:
        picked = input.gather(1, safe.unsqueeze(1)).squeeze(1)
    else:
        picked = input.gather(1, safe)
    loss = torch.where(valid, -picked, 0.0)
    if weight is not None:
        wsel = torch.where(valid, weight[safe], 0.0)
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / wsel.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1).to(loss.dtype)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """``-(y log p + (1 - y) log(1 - p))``, ``p`` clipped to ``[1e-12,
    1 - 1e-12]`` in its own dtype."""
    p = input.clamp(1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable ``max(z, 0) - z y + log1p(exp(-|z|))``; with
    ``pos_weight``, ``-(pw y log sigmoid(z) + (1 - y) log sigmoid(-z))``."""
    if pos_weight is None:
        loss = logit.clamp_min(0) - logit * label + torch.log1p(
            torch.exp(-logit.abs()))
    else:
        loss = -(pos_weight * label * TF.logsigmoid(logit)
                 + (1 - label) * TF.logsigmoid(-logit))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    """``y (log y - x)`` (``exp(y) (y - x)`` with ``log_target``), x the
    log-probabilities; ``"batchmean"`` divides the sum by the batch."""
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(label.clamp_min(1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Huber's loss over ``delta``: ``0.5 d^2 / delta`` below it, ``d - 0.5
    delta`` above."""
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce((-label * (input - other) + margin).clamp_min(0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input, (margin - input).clamp_min(0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    """``1 - cos`` for pairs labelled 1, ``max(0, cos - margin)`` else;
    the cosine over the last axis, its denominator at least 1e-12."""
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1)).clamp_min(1e-12)
    loss = torch.where(label == 1, 1 - cos, (cos - margin).clamp_min(0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """``max(0, d(a, pos) - d(a, neg) + margin)``, ``d(u, v) = (sum (|u - v|
    + epsilon)^p)^(1 / p)`` over the last axis (``swap``: the smaller of
    ``d(a, neg)`` and ``d(pos, neg)``)."""
    def dist(u, v):
        return ((u - v).abs() + epsilon).pow(p).sum(-1).pow(1.0 / p)

    d_an = dist(input, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    return _reduce((dist(input, positive) - d_an + margin).clamp_min(0.0),
                   reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """Focal loss: ``a_t (1 - p_t)^gamma`` times the stable sigmoid
    cross-entropy, divided by ``normalizer``."""
    p = torch.sigmoid(logit)
    ce = logit.clamp_min(0) - logit * label + torch.log1p(
        torch.exp(-logit.abs()))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * (1 - p_t).pow(gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - (2 |p y| + eps) / (|p| + |y| + eps)`` per sample, ``y`` the
    one-hot of ``label`` ``[..., 1]`` over ``input``'s last axis; the batch
    mean."""
    y = TF.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.ndim))
    inter = 2 * (input * y).sum(dims)
    union = input.sum(dims) + y.sum(dims)
    return (1 - (inter + epsilon) / (union + epsilon)).mean()


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
