"""RNN-Transducer loss lattice: the CUDA alpha and beta-gradient kernels,
their plain versions and the autograd Function that joins them.

Replaces ``paddle_tpu/kernels/rnnt.py`` ``_alpha_kernel`` (its
``pallas_call`` in ``_run_alpha``) and ``_beta_grad_kernel`` (in
``_bwd``); public ``rnnt_core_pallas``, whose ``custom_vjp`` becomes
:class:`RNNTLossFunction`. The lattices keep the natural batch-major
layout ``[B, T, U + 1]`` f32 (the reference's ``[T, B, Up]``, padded to 128
lanes and batches of 8, is TPU tiling): ``blank[b, t, u]`` is the log-prob
of blank at ``(t, u)``, ``emit[b, t, u]`` that of label ``u`` there, with
emit column ``U`` and the columns ``>= u_len`` at the -1e30 sentinel.

The kernels are ``csrc/rnnt.cu``, an **anti-diagonal wavefront** built for
the H100: one thread block per utterance. Compute warps hold a diagonal,
lanes over ``u`` with ``C`` adjacent cells a lane (2; 4 and 8 past
``U + 1`` of 1792 and 3584); at diagonal ``d = t + u`` each cell combines
its own previous value (a register) with its left neighbour's (alpha) or
right neighbour's (beta), which comes from the next lane by a warp
shuffle. At ``U + 1 <= 64`` one compute warp holds a whole diagonal (route
``"warp"``, no barrier on the chain); wider lattices take ``ceil((U + 1) /
32C)`` compute warps that pass their edge cells through shared memory, one
barrier a diagonal (route ``"block"``). Helper warps stage the inputs in
shared memory two bands of ``G`` diagonals ahead of the wavefront (a band
crosses each row in a run of ``G`` cells, copied by consecutive threads
with 4-byte ``cp.async``) and write the results out as row runs with the
dead cells' fill folded in, so no device-memory access is on the chain;
one barrier a band hands inputs in and results out. :func:`launch_plan`
gives the route, cells, compute and helper warps, ``G`` and the ring's
stages from ``U + 1`` alone (the kernels' ``plan_for`` computes the same),
so a launch reads no length on the host. The TPU kernel's row form
(``alpha[t] = E + logcumsumexp(base - E)``, a lane scan over ``u``) suits a
128-lane vector unit; on the card the wavefront takes one exp/log pair a
cell and avoids the cancellation of a large exclusive emit sum ``E``
against ``base`` in f32. The beta kernel runs the mirrored wavefront from
``(t_len - 1, u_len)`` and writes the blank and emit posteriors ``gb``,
``ge`` in the same pass. Both are bound by their chain of ``max(t_len +
u_len)`` dependent steps, not by bytes or flops (``chip_smoke.py`` reports
steps x the latency of one step, timed by ``rnnt_chain_probe``).

The arithmetic is the reference kernels': -1e30 is the log-space -inf,
:func:`_lse2` keeps their guard, ``alpha[0, 0] = 0``, the loss is
``-(alpha[t_len - 1, u_len] + blank[t_len - 1, u_len])``, the beta rows
start from the virtual terminal row ``bhat[t_len, u] = (u == u_len ? 0 :
-1e30)``, and ``gb = exp(min(alpha + blank + bhat[t + 1, u] - ll, 0))``,
``ge = exp(min(alpha + emit + bhat[t, u + 1] - ll, 0))``, 0 for
``t >= t_len``. Cells outside ``t < t_len, u <= u_len`` are -1e30 (alpha,
bhat) and 0 (gb, ge) in both versions; ``t_len`` is clamped into
``[1, T]`` and ``u_len`` into ``[0, U]``. For CPU tensors the Function
runs :func:`rnnt_alpha_plain` and :func:`rnnt_beta_grad_plain`: the same
recursions in the same order, vectorised over each anti-diagonal
(``max(t_len + u_len)`` loop iterations of a few ops on ``[B, U + 1]``).
The gradient goes back to the vocabulary through autograd of the gather
and ``log_softmax`` that built the lattices (``nn.functional.rnnt_loss``),
as the reference rides jax's VJP of its gather.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import (LAUNCHES, _build, in_program, plain_math, refuse_grad,
               route, use_kernel)
from ..core.tensor import bound_public

__all__ = ["NEG", "MAX_STATES", "LaunchPlan", "launch_plan", "ROUTES",
           "rnnt_alpha_plain", "rnnt_beta_grad_plain", "rnnt_alpha_cuda",
           "rnnt_beta_grad_cuda", "rnnt_launch_plan_cuda", "chain_probe_cuda",
           "RNNTLossFunction", "rnnt_lattice"]

NEG = -1e30
MAX_STATES = 4096          # csrc/rnnt.cu: 16 warps x 32 lanes x 8 cells
MAX_BAND = 32              # a band of G diagonals: G at most
COMPUTE_WARPS_MAX = 28     # + 4 helper warps <= 32 warps a block
SMEM_LIMIT = 232448        # 227 KB of shared memory a block on the H100
_P, _I = ctypes.c_void_p, ctypes.c_int

# launches per kernel and route since import (the wrappers add one where
# they launch, beside LAUNCHES); chip_smoke.py and the card tests read which
# route a shape took
ROUTES: dict[str, int] = {f"{k}_{r}": 0 for k in ("rnnt_alpha",
                                                  "rnnt_beta_grad")
                          for r in ("warp", "block")}


class LaunchPlan(NamedTuple):
    """How ``csrc/rnnt.cu`` lays out one utterance's block: ``route``
    ``"warp"`` (one compute warp, neighbours by shuffle alone) or
    ``"block"`` (``warps`` compute warps passing their edge cells through
    shared memory), ``cells`` adjacent cells a lane, ``helpers`` warps
    that stage the inputs and write the results, bands of ``band``
    diagonals, an input ring of ``stages`` bands, ``smem`` bytes of shared
    memory."""
    route: str
    cells: int
    warps: int
    helpers: int
    band: int
    stages: int
    smem: int


def _helpers(warps, cells):
    """Helper warps: 7 beside one compute warp; else as many as the
    compute warps, at least 4, at most 32 warps a block (20 at eight cells
    a lane, whose compute warps need more registers)."""
    if warps == 1:
        return 7
    return min(max(4, warps), (20 if cells == 8 else 32) - warps)


def launch_plan(U1, beta=False):
    """The kernels' launch plan at ``U + 1 = U1`` (``beta``: the
    beta-gradient kernel's, which stages three inputs and bands three
    outputs; else the alpha kernel's, two and one): a function of the
    shape alone, as ``plan_for`` in ``csrc/rnnt.cu``. The input ring holds
    3 bands (2 where 3 do not fit even bands of one diagonal), the output
    bands 2; ``band`` is the largest power of two up to ``MAX_BAND`` whose
    ring and bands fit ``SMEM_LIMIT``. Raises outside ``1..MAX_STATES``."""
    if not 1 <= U1 <= MAX_STATES:
        raise ValueError(
            f"rnnt kernels hold at most {MAX_STATES} label positions (U + 1, "
            f"labels of {MAX_STATES - 1}) on one diagonal; got U + 1 = {U1}")
    cells = (2 if U1 <= COMPUTE_WARPS_MAX * 64 else
             4 if U1 <= COMPUTE_WARPS_MAX * 128 else 8)
    warps = -(-U1 // (32 * cells))
    nin, nout = (3, 3) if beta else (2, 1)
    plane = warps * 32 * cells * 4
    edge = 2 * warps * 4
    for stages in (3, 2):
        band = MAX_BAND
        while band >= 1:
            smem = (stages * nin + 2 * nout) * plane * band + edge
            if smem <= SMEM_LIMIT:
                return LaunchPlan("warp" if warps == 1 else "block", cells,
                                  warps, _helpers(warps, cells), band,
                                  stages, smem)
            band //= 2
    raise AssertionError(f"no launch plan fits U + 1 = {U1}")


def _lse2(a, b):
    """``log(e^a + e^b)``, exactly -1e30 where the larger term is below
    -5e29 (the reference's ``_lse2``), as the kernels compute it: ``m +
    log(1 + exp(-|a - b|))``. The reference's ``exp(a - m) + exp(b - m)``
    holds ``exp(0) = 1`` exactly and ``b - a = -(a - b)`` in IEEE
    arithmetic, so both forms give the same bits."""
    m = torch.maximum(a, b)
    out = m + torch.log(1 + torch.exp(-torch.abs(a - b)))
    return torch.where(m <= NEG / 2, NEG, out)


def _shift(x, k, fill=NEG):
    """``x[:, u - k]`` along the last axis (``k < 0``: ``x[:, u + |k|]``),
    ``fill`` where that falls outside."""
    n = x.shape[1]
    if k > 0:
        return torch.nn.functional.pad(x, (k, 0), value=fill)[:, :n]
    return torch.nn.functional.pad(x, (0, -k), value=fill)[:, -k:]


def _check(blank_lp, emit_lp, t_len, u_len):
    if blank_lp.dim() != 3 or emit_lp.shape != blank_lp.shape \
            or t_len.shape != (blank_lp.shape[0],) \
            or u_len.shape != (blank_lp.shape[0],):
        raise ValueError(
            f"rnnt: blank_lp and emit_lp must both be [B, T, U + 1], the "
            f"lengths [B]; got {tuple(blank_lp.shape)}, "
            f"{tuple(emit_lp.shape)}, {tuple(t_len.shape)}, "
            f"{tuple(u_len.shape)}")
    if blank_lp.shape[1] == 0 or blank_lp.shape[2] == 0:
        raise ValueError(f"rnnt: an empty lattice {tuple(blank_lp.shape)}")


def _lengths(shape, t_len, u_len):
    """``(t_len, u_len)`` int64, clamped as the kernels clamp them."""
    _, T, U1 = shape
    return t_len.long().clamp(1, T), u_len.long().clamp(0, U1 - 1)


def _cells(rows, T, fill):
    """``[B, T, U + 1]`` from the anti-diagonals ``rows[d]`` ``[B, U + 1]``
    (cell ``(t, u)`` lies on ``rows[t + u]``); ``fill`` past the last."""
    D = torch.stack(rows + [torch.full_like(rows[0], fill)])
    U1 = D.shape[2]
    u = torch.arange(U1, device=D.device)
    d = (torch.arange(T, device=D.device)[:, None] + u).clamp_max(len(rows))
    return D[d, :, u].permute(2, 0, 1).contiguous()


def rnnt_alpha_plain(blank_lp, emit_lp, t_len, u_len):
    """Plain PyTorch forward lattice. Returns ``(alphas [B, T, U + 1] f32,
    ll [B] f32)``, ``ll = alpha[t_len - 1, u_len] + blank[t_len - 1,
    u_len]`` (the loss is ``-ll``)."""
    _check(blank_lp, emit_lp, t_len, u_len)
    with plain_math(blank_lp.device):
        blank, emit = blank_lp.float(), emit_lp.float()
        B, T, U1 = blank.shape
        tl, ul = _lengths(blank.shape, t_len, u_len)
        u = torch.arange(U1, device=blank.device)
        diag = torch.full((B, U1), NEG, device=blank.device)
        rows = []
        for d in range(int((tl - 1 + ul).max()) + 1):
            t = d - u
            live = (t >= 0) & (t < tl[:, None]) & (u <= ul[:, None])
            cb = blank[:, (t - 1).clamp(0, T - 1), u]      # blank[t - 1, u]
            ce = emit[:, t.clamp(0, T - 1), (u - 1).clamp_min(0)]
            a = torch.where(t > 0, diag + cb, NEG)
            e = torch.where(u > 0, _shift(diag, 1) + ce, NEG)
            v = torch.where((t == 0) & (u == 0), 0.0, _lse2(a, e))
            diag = torch.where(live, v, NEG)
            rows.append(diag)
        alphas = _cells(rows, T, NEG)
        b = torch.arange(B, device=blank.device)
        return alphas, alphas[b, tl - 1, ul] + blank[b, tl - 1, ul]


def rnnt_beta_grad_plain(blank_lp, emit_lp, alphas, t_len, u_len, ll,
                         with_betas=False):
    """Plain PyTorch backward lattice and posteriors. Returns ``(gb, ge,
    betas)``, each ``[B, T, U + 1]`` f32: ``gb``/``ge`` the blank and emit
    posteriors (``d(-loss) / d blank``, ``/ d emit``), ``betas`` the
    suffix lattice ``bhat`` when ``with_betas`` (else None)."""
    _check(blank_lp, emit_lp, t_len, u_len)
    with plain_math(blank_lp.device):
        blank, emit = blank_lp.float(), emit_lp.float()
        alphas, llc = alphas.float(), ll.float()[:, None]
        B, T, U1 = blank.shape
        tl, ul = _lengths(blank.shape, t_len, u_len)
        u = torch.arange(U1, device=blank.device)
        term = torch.where(u == ul[:, None], 0.0, NEG)
        diag = torch.full((B, U1), NEG, device=blank.device)
        rows, gbs, ges = [], [], []
        for d in range(int((tl - 1 + ul).max()), -1, -1):
            t = d - u
            live = (t >= 0) & (t < tl[:, None]) & (u <= ul[:, None])
            tc = t.clamp(0, T - 1)
            cb, ce, ca = blank[:, tc, u], emit[:, tc, u], alphas[:, tc, u]
            bn = torch.where(t == tl[:, None] - 1, term, diag)
            r = _shift(diag, -1)                           # bhat[t, u + 1]
            v = _lse2(cb + bn, ce + r)
            g_b = torch.exp(torch.clamp_max(ca + cb + bn - llc, 0.0))
            g_e = torch.exp(torch.clamp_max(ca + ce + r - llc, 0.0))
            diag = torch.where(live, v, NEG)
            rows.append(diag)
            gbs.append(torch.where(live, g_b, 0.0))
            ges.append(torch.where(live, g_e, 0.0))
        betas = _cells(rows[::-1], T, NEG) if with_betas else None
        return _cells(gbs[::-1], T, 0.0), _cells(ges[::-1], T, 0.0), betas


def _kernel_inputs(blank_lp, emit_lp, t_len, u_len, beta=False):
    """The contiguous f32 lattices and i32 lengths the kernels take, and
    their launch plan (which raises past ``MAX_STATES``)."""
    _check(blank_lp, emit_lp, t_len, u_len)
    plan = launch_plan(blank_lp.shape[2], beta)
    for x in (blank_lp, emit_lp):
        if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise TypeError(f"rnnt kernels take float lattices; got "
                            f"{x.dtype}")
    return (blank_lp.float().contiguous(), emit_lp.float().contiguous(),
            t_len.int().contiguous(), u_len.int().contiguous(), plan)


def rnnt_alpha_cuda(blank_lp, emit_lp, t_len, u_len):
    """Launch ``rnnt_alpha`` of ``csrc/rnnt.cu``; same contract as
    :func:`rnnt_alpha_plain`."""
    refuse_grad("rnnt_alpha_cuda", blank_lp, emit_lp)
    blank, emit, tl, ul, plan = _kernel_inputs(blank_lp, emit_lp, t_len,
                                               u_len)
    B, T, U1 = blank.shape
    alphas = torch.empty(B, T, U1, device=blank.device, dtype=torch.float32)
    ll = torch.empty(B, device=blank.device, dtype=torch.float32)
    fn = _build.function("rnnt", "rnnt_alpha", [_P] * 6 + [_I] * 3 + [_P])
    err = fn(blank.data_ptr(), emit.data_ptr(), tl.data_ptr(), ul.data_ptr(),
             alphas.data_ptr(), ll.data_ptr(), B, T, U1,
             torch.cuda.current_stream(blank.device).cuda_stream)
    _build.check(err, "rnnt", "rnnt_alpha launch")
    LAUNCHES["rnnt_alpha"] += 1
    ROUTES[f"rnnt_alpha_{plan.route}"] += 1
    return alphas, ll


def rnnt_beta_grad_cuda(blank_lp, emit_lp, alphas, t_len, u_len, ll,
                        with_betas=False):
    """Launch ``rnnt_beta_grad`` of ``csrc/rnnt.cu``; same contract as
    :func:`rnnt_beta_grad_plain`."""
    refuse_grad("rnnt_beta_grad_cuda", blank_lp, emit_lp, alphas, ll)
    blank, emit, tl, ul, plan = _kernel_inputs(blank_lp, emit_lp, t_len,
                                               u_len, beta=True)
    B, T, U1 = blank.shape
    if alphas.shape != blank.shape or ll.shape != (B,):
        raise ValueError(f"rnnt_beta_grad: alphas must be {tuple(blank.shape)} "
                         f"and ll [{B}]; got {tuple(alphas.shape)}, "
                         f"{tuple(ll.shape)}")
    alphas, ll = alphas.float().contiguous(), ll.float().contiguous()
    gb, ge = (torch.empty(B, T, U1, device=blank.device, dtype=torch.float32)
              for _ in range(2))
    betas = torch.empty_like(gb) if with_betas else None
    fn = _build.function("rnnt", "rnnt_beta_grad", [_P] * 9 + [_I] * 3 + [_P])
    err = fn(blank.data_ptr(), emit.data_ptr(), alphas.data_ptr(),
             tl.data_ptr(), ul.data_ptr(), ll.data_ptr(), gb.data_ptr(),
             ge.data_ptr(), None if betas is None else betas.data_ptr(),
             B, T, U1, torch.cuda.current_stream(blank.device).cuda_stream)
    _build.check(err, "rnnt", "rnnt_beta_grad launch")
    LAUNCHES["rnnt_beta_grad"] += 1
    ROUTES[f"rnnt_beta_grad_{plan.route}"] += 1
    return gb, ge, betas


def rnnt_launch_plan_cuda(U1, beta=False):
    """The plan ``csrc/rnnt.cu`` itself computes at ``U + 1 = U1``, as
    ``(cells, warps, helpers, band, stages, smem)`` (the card tests hold
    it against :func:`launch_plan`)."""
    out = (ctypes.c_int * 6)()
    fn = _build.function("rnnt", "rnnt_launch_plan", [_I, _I, _P])
    _build.check(fn(U1, int(beta), ctypes.addressof(out)), "rnnt",
                 "rnnt_launch_plan")
    return tuple(out)


def chain_probe_cuda(steps, terms, w):
    """Launch ``rnnt_chain_probe``: one warp runs ``steps`` dependent
    steps of the RNN-T recursion in registers (``terms`` must be 2: a
    shuffle + lse2; the CTC step's probe is ``kernels/ctc.py``
    ``chain_probe_cuda``), adding the constants in ``w`` (a CUDA f32
    tensor of 3). Returns the warp's 32 results. A timing probe of the
    chain's step latency, not a kernel of any model path, so it has no
    launch count."""
    out = torch.empty(32, device=w.device, dtype=torch.float32)
    fn = _build.function("rnnt", "rnnt_chain_probe", [_P, _P, _I, _I, _P])
    err = fn(out.data_ptr(), w.data_ptr(), steps, terms,
             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "rnnt", "rnnt_chain_probe launch")
    return out


class RNNTLossFunction(torch.autograd.Function):
    """``(blank_lp, emit_lp [B, T, U + 1], t_len [B], u_len [B]) -> loss
    [B] = -ll, alphas, ll)``, differentiable in both lattices through the
    loss. The alpha kernel forward and the beta-gradient kernel backward
    for CUDA tensors; their plain versions for CPU tensors; the registered
    ops (``library.py``) inside a program. The backward returns
    ``-gb * g`` and ``-ge * g``."""

    @staticmethod
    def forward(blank_lp, emit_lp, t_len, u_len):
        args = (blank_lp, emit_lp, t_len, u_len)
        if in_program(*args):
            alphas, ll = torch.ops.paddle_tpu_torch.rnnt_alpha(*args)
        else:
            alphas, ll = route("rnnt_alpha", use_kernel(*args),
                               rnnt_alpha_cuda, rnnt_alpha_plain, *args)
        return -ll, alphas, ll

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(*inputs, *output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        blank_lp, emit_lp, t_len, u_len, alphas, ll = ctx.saved_tensors
        args = (blank_lp, emit_lp, alphas, t_len, u_len, ll)
        if in_program(blank_lp, g):
            gb, ge = torch.ops.paddle_tpu_torch.rnnt_beta_grad(*args)
        else:
            gb, ge, _ = route("rnnt_beta_grad",
                              use_kernel(blank_lp, emit_lp),
                              rnnt_beta_grad_cuda, rnnt_beta_grad_plain,
                              *args)
        g = g.float()[:, None, None]
        return ((-gb * g).to(blank_lp.dtype), (-ge * g).to(emit_lp.dtype),
                None, None)


def rnnt_lattice(blank_lp, emit_lp, t_len, u_len):
    """Per-utterance negative log-likelihood ``[B]`` f32 (no reduction, as
    the reference's ``rnnt_core_pallas``); differentiable in both
    lattices."""
    return RNNTLossFunction.apply(blank_lp, emit_lp, t_len, u_len)[0]


# public entry points hand back Tensors when a Tensor came in
bound_public(globals())
