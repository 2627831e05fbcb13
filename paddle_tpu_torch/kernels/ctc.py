"""CTC loss lattice: the CUDA alpha and beta kernels, their plain versions
and the autograd Function that joins them.

Replaces ``paddle_tpu/kernels/ctc.py`` ``_alpha_kernel`` (its
``pallas_call`` in ``_alphas``) and ``_beta_kernel`` (in ``_betas``);
public ``ctc_loss_pallas``, whose ``custom_vjp`` becomes
:class:`CTCLossFunction`. The kernels are ``csrc/ctc.cu``, built for the
H100: one thread block per utterance. Compute warps hold a lattice row in
registers, ``cells`` adjacent extended states a lane (4; 8 past S = 1024,
16 past 4096), so a state's neighbours ``s - 1`` and ``s - 2`` are the
lane's own registers but at its first states, whose neighbours come from
the next lane by warp shuffle; the skip bar is a bit a state. The four
states of a lane step in lockstep (the blanks, which never skip, by the
one-exp form of :func:`_lse3`; the kernels' expf and logf are CUDA's own
instruction sequences, so the same bits). At ``S <= 128`` one compute
warp holds the row (route ``"warp"``, no barrier on the chain); wider rows
take ``ceil(S / 32 cells)`` compute warps passing their edge states
through shared memory (route ``"block"``, a barrier a step). Helper warps
stage the log-probs two bands of ``band`` time steps ahead into a ring in
shared memory (``stage`` ``"gather"``: the gathered ``log_probs[t, b,
ext[s]]`` when ``C >= S``; ``"rows"``: whole rows ``log_probs[t, b, :]``,
which the lanes gather, when ``C < S``) and write the results as rows of
``S`` contiguous floats while the next band runs, so no device-memory
access is on the chain; one barrier a band. Beta's chain starts at its
terminal row ``in_len - 1`` (rows past it are a plain -1e30 fill), and the
log-likelihood is read from the band that holds row ``in_len - 1``.
:func:`launch_plan` gives the layout from ``(S, C)`` alone (the kernels'
``plan_for`` computes the same), so a launch reads no length on the host.
Alpha is ``T`` dependent steps and beta ``in_len``, each a shuffle,
:func:`_lse3` and an add: the kernels are bound by that chain, not by
bytes or flops (``chip_smoke.py`` reports steps x one step's latency,
timed by ``ctc_chain_probe``).

The arithmetic is the reference kernels': -1e30 is the log-space -inf,
:func:`_lse3` keeps their guard, the skip from ``s - 2`` is barred where
``ext[s] == ext[s - 2]`` and at states 0 and 1, the alpha row at t = 0 is
``log_probs`` at states 0 and 1, alpha carries every row ``t < T``, the
beta rows take their terminal value at ``t == in_len - 1`` and are -1e30
after it, and the log-likelihood is ``logaddexp(alpha[in_len - 1, 2L],
alpha[in_len - 1, 2L - 1])`` (the second term barred when the label is
empty). For CPU tensors the Function runs :func:`ctc_alpha_plain` and
:func:`ctc_beta_plain`, the same recursions in PyTorch over ``[B, S]``
rows, one time step a loop iteration (the reference's ``lax.scan``
lattice, with the kernels' guard).

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
from typing import NamedTuple

import torch

from . import (LAUNCHES, _build, in_program, plain_math, refuse_grad,
               route, use_kernel)
from ..core.tensor import bound_public

__all__ = ["NEG", "MAX_STATES", "LaunchPlan", "launch_plan", "ROUTES",
           "extended_labels", "ctc_alpha_plain", "ctc_beta_plain",
           "ctc_alpha_cuda", "ctc_beta_cuda", "ctc_launch_plan_cuda",
           "chain_probe_cuda", "math_check_cuda", "ctc_grad",
           "CTCLossFunction", "ctc_lattice"]

NEG = -1e30
MAX_STATES = 8192          # csrc/ctc.cu: 16 compute warps x 32 lanes x 16
MAX_BAND = 32              # a band of G time steps: G at most
HELPERS_WARP = 7           # helper warps beside one compute warp
SMEM_LIMIT = 232448        # 227 KB of shared memory a block on the H100
_P, _I = ctypes.c_void_p, ctypes.c_int

# launches per kernel and route since import (the wrappers add one where
# they launch, beside LAUNCHES); chip_smoke.py and the card tests read which
# route a shape took
ROUTES: dict[str, int] = {f"{k}_{r}": 0 for k in ("ctc_alpha", "ctc_beta")
                          for r in ("warp", "block")}


class LaunchPlan(NamedTuple):
    """How ``csrc/ctc.cu`` lays out one utterance's block: ``route``
    ``"warp"`` (one compute warp, neighbours by shuffle alone) or
    ``"block"`` (``warps`` compute warps passing their edge states
    through shared memory), ``cells`` adjacent states a lane, ``helpers``
    warps that stage the log-probs and write the rows, ``stage``
    ``"gather"`` (the gathered ``log_probs[t, b, ext[s]]``) or ``"rows"``
    (whole rows of ``C``), bands of ``band`` time steps, a log-prob ring
    of ``stages`` bands, ``smem`` bytes of shared memory."""
    route: str
    cells: int
    warps: int
    helpers: int
    stage: str
    band: int
    stages: int
    smem: int


def _max_warps(cells):
    """Warps a block-route block may hold at ``cells`` states a lane (what
    the compute warps' registers leave room for)."""
    return {4: 16, 8: 24, 16: 20}[cells]


def launch_plan(S, C):
    """The kernels' launch plan at ``S = 2L + 1`` extended states and ``C``
    classes: a function of the shapes alone, as ``plan_for`` in
    ``csrc/ctc.cu``. Helpers: 7 beside one compute warp, else as many as
    the compute warps, at least 4, within the block's warp budget. Whole
    rows are staged where ``C < S`` (fewer copies than the gathered
    states; the row is padded with a -1e30 column for the states past
    ``S``), so the ring never grows with the vocabulary. The ring holds 3
    bands (2 where 3 do not fit even bands of one step), the output bands
    2; ``band`` is the largest power of two up to ``MAX_BAND`` whose ring,
    output bands, edge states and (gathering) ``ext`` fit ``SMEM_LIMIT``.
    Raises outside ``1 <= S <= MAX_STATES`` or for ``C < 1``."""
    if not 1 <= S <= MAX_STATES:
        raise ValueError(
            f"ctc kernels hold at most {MAX_STATES} extended states (labels "
            f"of {(MAX_STATES - 1) // 2}) in registers; got S = {S}")
    if C < 1:
        raise ValueError(f"ctc kernels need at least one class; got C = {C}")
    cells = 4 if S <= 1024 else 8 if S <= 4096 else 16
    warps = -(-S // (32 * cells))
    helpers = (HELPERS_WARP if warps == 1
               else min(max(4, warps), _max_warps(cells) - warps))
    rows = C < S
    Ss = warps * 32 * cells
    rl = (C + 4) // 4 * 4 if rows else Ss
    fixed = (4 * (warps + 1) + (0 if rows else Ss)) * 4
    for stages in (3, 2):
        band = MAX_BAND
        while band >= 1:
            smem = (stages * rl + 2 * Ss) * 4 * band + fixed
            if smem <= SMEM_LIMIT:
                return LaunchPlan("warp" if warps == 1 else "block", cells,
                                  warps, helpers,
                                  "rows" if rows else "gather", band, stages,
                                  smem)
            band //= 2
    raise AssertionError(f"no launch plan fits S = {S}, C = {C}")


def extended_labels(labels, blank):
    """``[B, 2L + 1]`` int64: blank, l1, blank, l2, ..., blank."""
    B, L = labels.shape
    ext = torch.full((B, 2 * L + 1), blank, dtype=torch.int64,
                     device=labels.device)
    ext[:, 1::2] = labels.long()
    return ext


def _lse3(a, b, c):
    """``log(e^a + e^b + e^c)``, exactly -1e30 where the largest term is
    below -5e29 (the reference's ``_lse3``), as the kernels compute it:
    the reference's sum ``(e^(a-m) + e^(b-m)) + e^(c-m)`` holds the
    maximum's ``e^0 = 1`` exactly, so only the two other terms ``x, y``
    take an exp, added in the reference's order (``(e^x + e^y) + 1`` when
    ``c`` is the maximum, else ``(1 + e^x) + e^y``): the same bits with two
    exponentials instead of three."""
    m = torch.maximum(a, torch.maximum(b, c))
    cm, am = c == m, a == m
    ex = torch.exp(torch.where(cm | ~am, a, b) - m)
    ey = torch.exp(torch.where(cm, b, c) - m)
    out = m + torch.log(torch.where(cm, (ex + ey) + 1, (1 + ex) + ey))
    return torch.where(m <= NEG / 2, NEG, out)


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


def _kernel_inputs(log_probs, labels, input_lengths, label_lengths, blank):
    """The contiguous f32 log-probs and i32 labels and lengths the kernels
    take, and their launch plan (which raises past ``MAX_STATES``)."""
    _check(log_probs, labels, input_lengths, label_lengths)
    C = log_probs.shape[2]
    plan = launch_plan(2 * labels.shape[1] + 1, C)
    if not 0 <= blank < C:
        raise ValueError(f"ctc: blank {blank} is not a class of {C}")
    if log_probs.dtype not in (torch.float32, torch.bfloat16,
                               torch.float16):
        raise TypeError(f"ctc kernels take float log_probs; got "
                        f"{log_probs.dtype}")
    return (log_probs.float().contiguous(), labels.int().contiguous(),
            input_lengths.int().contiguous(),
            label_lengths.int().contiguous(), plan)


def ctc_alpha_cuda(log_probs, labels, input_lengths, label_lengths,
                   blank=0):
    """Launch ``ctc_alpha`` of ``csrc/ctc.cu``; same contract as
    :func:`ctc_alpha_plain`."""
    refuse_grad("ctc_alpha_cuda", log_probs)
    lp, lbl, il, ll_len, plan = _kernel_inputs(
        log_probs, labels, input_lengths, label_lengths, int(blank))
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
    ROUTES[f"ctc_alpha_{plan.route}"] += 1
    return alphas, ll


def ctc_beta_cuda(log_probs, labels, input_lengths, label_lengths,
                  blank=0):
    """Launch ``ctc_beta`` of ``csrc/ctc.cu``; same contract as
    :func:`ctc_beta_plain`."""
    refuse_grad("ctc_beta_cuda", log_probs)
    lp, lbl, il, ll_len, plan = _kernel_inputs(
        log_probs, labels, input_lengths, label_lengths, int(blank))
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
    ROUTES[f"ctc_beta_{plan.route}"] += 1
    return betas


def ctc_launch_plan_cuda(S, C):
    """The plan ``csrc/ctc.cu`` itself computes at ``(S, C)``, as
    ``(cells, warps, helpers, rows, band, stages, smem)`` (the card tests
    hold it against :func:`launch_plan`)."""
    out = (ctypes.c_int * 7)()
    fn = _build.function("ctc", "ctc_launch_plan", [_I, _I, _P])
    _build.check(fn(S, C, ctypes.addressof(out)), "ctc", "ctc_launch_plan")
    return tuple(out)


def chain_probe_cuda(steps, w):
    """Launch ``ctc_chain_probe``: one warp runs ``steps`` dependent steps
    of the kernels' recursion at one state a lane in registers (two
    shuffles, :func:`_lse3` with two exps, an add), adding the constants
    in ``w`` (a CUDA f32 tensor of 3: ``w[0]`` the log-prob, ``w[2]`` the
    skip term's weight). Returns the warp's 32 results. A timing probe of
    the chain's step latency, not a kernel of any model path, so it has no
    launch count."""
    out = torch.empty(32, device=w.device, dtype=torch.float32)
    fn = _build.function("ctc", "ctc_chain_probe", [_P, _P, _I, _P])
    err = fn(out.data_ptr(), w.data_ptr(), steps,
             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "ctc", "ctc_chain_probe launch")
    return out


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


def math_check_cuda(lo, n, fn):
    """``ctc_math_check``: how many of the floats with bits ``lo .. lo + n
    - 1`` the kernels' ``fn`` (``"exp"`` or ``"log"``, CUDA's expf / logf
    written out for the lockstep states) gives in other bits than CUDA's
    own. A check of the kernels' arithmetic, not a kernel of any model
    path, so it has no launch count."""
    bad = torch.zeros(1, device="cuda", dtype=torch.int64)
    fn_ = _build.function("ctc", "ctc_math_check",
                          [_P, ctypes.c_uint, ctypes.c_longlong, _I, _P])
    err = fn_(bad.data_ptr(), lo, n, {"exp": 0, "log": 1}[fn],
              torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ctc", "ctc_math_check launch")
    return int(bad.item())


class CTCLossFunction(torch.autograd.Function):
    """``(log_probs [T, B, C], labels [B, L], input_lengths [B],
    label_lengths [B], blank) -> (loss [B] = -ll, alphas, ll)``,
    differentiable in log_probs through the loss only. The alpha kernel
    forward and the beta kernel backward for CUDA tensors; their plain
    versions for CPU tensors; the registered ops (``library.py``) inside a
    program."""

    @staticmethod
    def forward(log_probs, labels, input_lengths, label_lengths, blank):
        args = (log_probs, labels, input_lengths, label_lengths)
        if in_program(*args):
            alphas, ll = torch.ops.paddle_tpu_torch.ctc_alpha(*args, blank)
        else:
            alphas, ll = route("ctc_alpha", use_kernel(*args), ctc_alpha_cuda,
                               ctc_alpha_plain, *args, blank)
        return -ll, alphas, ll

    @staticmethod
    def setup_context(ctx, inputs, output):
        log_probs, labels, input_lengths, label_lengths, blank = inputs
        ctx.blank = blank
        ctx.dtype, ctx.num_classes = log_probs.dtype, log_probs.shape[2]
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(log_probs, labels, input_lengths,
                              label_lengths, *output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        log_probs, labels, in_len, lbl_len, alphas, ll = ctx.saved_tensors
        args = (log_probs, labels, in_len, lbl_len, ctx.blank)
        if in_program(log_probs, g):
            betas = torch.ops.paddle_tpu_torch.ctc_beta(*args)
        else:
            betas = route("ctc_beta", use_kernel(*args[:4]), ctc_beta_cuda,
                          ctc_beta_plain, *args)
        grad = ctc_grad(alphas, betas, ll, labels, g, ctx.num_classes,
                        ctx.blank)
        return grad.to(ctx.dtype), None, None, None, None


def ctc_lattice(log_probs, labels, input_lengths, label_lengths, blank=0):
    """Per-utterance negative log-likelihood ``[B]`` f32 (no reduction, as
    the reference's ``ctc_loss_pallas``); differentiable in log_probs."""
    return CTCLossFunction.apply(log_probs, labels, input_lengths,
                                 label_lengths, int(blank))[0]


# public entry points hand back Tensors when a Tensor came in
bound_public(globals())
