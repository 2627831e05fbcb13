"""The rest of the reference's op inventory (counterpart of
``paddle_tpu/ops/parity.py``): the ops that the core op modules and
``nn.functional`` do not provide under the reference's op name.

Two kinds of entries, as there:

- aliases: capabilities that exist under another public name (``conv2d``
  lives in ``nn.functional``, ``warpctc`` is ``F.ctc_loss``) registered
  under the reference op's name, so ``OPS[name].fn`` reaches the port's
  function (and, for ``flash_attn``, ``layer_norm``,
  ``cross_entropy_with_softmax``, ``warpctc`` and ``warprnnt``, its
  hand-written kernel);
- new bodies over torch tensors (:func:`registry.defop`), each the
  reference body's formula in PyTorch's idiom.

The reference writes these in ``jnp``; none reaches ``pl.pallas_call``, so
a plain PyTorch body is their port. The in-place reference ops
(``adam_``, ``check_finite_and_unscale_``, ...) are functional, as there:
each returns the updated values. Where the reference reads a value on the
host (``bincount``'s length, ``lu_unpack``'s pivots, ``segment_pool``'s
segment count) the port does too, and says so. ``nms`` keeps the
reference's greedy answer without a step a box on the host: the keep mask
is the fixed point of ``keep[i] = not any(keep[j] and overlaps[j, i], j <
i)`` iterated from all-ones on the device (the recurrence runs over a DAG,
so the fixed point is the greedy answer and is reached); the host reads
whether it moved once every :data:`NMS_ROUND` steps. The random ops draw
from ``framework.random``'s generators and agree with the reference in
distribution.

The public names of :data:`PUBLIC_OPS` are installed into the
``paddle_tpu_torch`` namespace and as ``Tensor`` methods where neither
has the name already; ``max`` / ``min`` / ``all`` / ``any`` (the core
math ops, registered here under the reference's op names) live in that
dict only, so they never shadow a builtin inside this module.
"""
from __future__ import annotations

import builtins
import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.device import resolve_device
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.tensor import wrap
from ..framework.random import get_generator
from . import math as M
from .registry import OPS, OpDef, defop

__all__ = ["PUBLIC_OPS", "NMS_ROUND", "nms_keep"]

# Jacobi steps of the nms keep mask between two reads of "did it move"
NMS_ROUND = 8


def _alias(name, fn, category="parity"):
    if name not in OPS:
        OPS[name] = OpDef(name, fn, category)
    return fn


def _dims(axis, ndim):
    """``axis`` (None, an int, a list or tuple) as a tuple of dims; all
    dims for None."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % builtins.max(ndim, 1) for a in axis)
    return (int(axis) % builtins.max(ndim, 1),)


def _like(v, like, dtype=None):
    """``v`` (a number, list or array) as a tensor on ``like``'s device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v), device=like.device,
                           dtype=dtype or like.dtype)


def _new(t):
    """A result made from no tensor input: on the default device, as a
    ``Tensor``."""
    return wrap(t.to(resolve_device(None)))


# ---------------------------------------------------------------------------
# reductions / elementwise math (the core math ops the reference registers
# here under their own names: the port's are the same functions)
# ---------------------------------------------------------------------------
for _name in ("max", "min", "all", "any", "add_n", "cumsum", "logsumexp",
              "trace", "multiplex"):
    _alias(_name, getattr(M, _name))
del _name


@defop("addmm")
def _addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * (x @ y)


@defop("mean_all")
def _mean_all(x):
    return torch.mean(x)


@defop("elementwise_pow")
def _elementwise_pow(x, y):
    return torch.pow(x, y)


@defop("increment")
def _increment(x, value=1.0):
    return x + value


@defop("fill")
def _fill(x, value):
    return torch.full_like(x, value)


@defop("full_int_array")
def _full_int_array(shape, value, dtype="int64"):
    return _new(torch.full(tuple(int(s) for s in shape), value,
                           dtype=convert_dtype(dtype)))


@defop("full_batch_size_like")
def _full_batch_size_like(x, shape, value, input_dim_idx=0,
                          output_dim_idx=0):
    shape = list(shape)
    shape[output_dim_idx] = x.shape[input_dim_idx]
    return torch.full(tuple(shape), value, dtype=x.dtype, device=x.device)


@defop("cumprod")
def _cumprod(x, dim=None):
    return torch.cumprod(x.reshape(-1), 0) if dim is None \
        else torch.cumprod(x, int(dim))


@defop("cummax")
def _cummax(x, axis=-1):
    out = torch.cummax(x, int(axis))
    return out.values, out.indices


@defop("cummin")
def _cummin(x, axis=-1):
    out = torch.cummin(x, int(axis))
    return out.values, out.indices


@defop("logcumsumexp")
def _logcumsumexp(x, axis=-1):
    return torch.logcumsumexp(x, int(axis))


@defop("diagonal")
def _diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@defop("diag_embed")
def _diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


@defop("fill_diagonal_tensor")
def _fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    xt = torch.movedim(x, (dim1, dim2), (-2, -1)).clone()
    n = builtins.min(xt.shape[-2], xt.shape[-1] - offset) if offset >= 0 \
        else builtins.min(xt.shape[-2] + offset, xt.shape[-1])
    ii = torch.arange(n, device=x.device) + (-offset if offset < 0 else 0)
    jj = torch.arange(n, device=x.device) + (offset if offset > 0 else 0)
    xt[..., ii, jj] = y.to(xt.dtype)
    return torch.movedim(xt, (-2, -1), (dim1, dim2))


@defop("complex")
def _complex(real, imag):
    return torch.complex(real, imag)


@defop("conj")
def _conj(x):
    return torch.conj_physical(x) if x.is_complex() else x.clone()


@defop("real")
def _real(x):
    return torch.real(x).clone()


@defop("imag")
def _imag(x):
    return torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x)


_i0 = defop("i0")(lambda x: torch.special.i0(x))
_i0e = defop("i0e")(lambda x: torch.special.i0e(x))
_i1 = defop("i1")(lambda x: torch.special.i1(x))
_i1e = defop("i1e")(lambda x: torch.special.i1e(x))


@defop("polygamma")
def _polygamma(x, n=1):
    return torch.special.polygamma(int(n), x)


@defop("nextafter")
def _nextafter(x, y):
    return torch.nextafter(x, _like(y, x))


@defop("frobenius_norm")
def _frobenius_norm(x, axis=None, keepdim=False):
    dims = tuple(axis) if axis else tuple(range(x.dim()))
    return torch.sqrt(torch.sum(torch.square(x), dims, keepdim))


@defop("p_norm")
def _p_norm(x, porder=2.0, axis=-1, epsilon=1e-12, keepdim=False,
            asvector=False):
    if asvector:
        x = x.reshape(-1)
        axis = 0
    if porder == float("inf"):
        return torch.amax(torch.abs(x), axis, keepdim)
    if porder == float("-inf"):
        return torch.amin(torch.abs(x), axis, keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), porder), axis,
                               keepdim) + epsilon, 1.0 / porder)


@defop("squared_l2_norm")
def _squared_l2_norm(x):
    return torch.sum(torch.square(x))


@defop("clip_by_norm")
def _clip_by_norm(x, max_norm):
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm,
                       x * (max_norm / torch.clamp(norm, min=1e-12)), x)


@defop("renorm")
def _renorm(x, p, axis, max_norm):
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.pow(torch.sum(torch.pow(torch.abs(flat), p), 1), 1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return torch.movedim((flat * factor[:, None]).reshape(moved.shape), 0,
                         axis)


@defop("bincount")
def _bincount(x, weights=None, minlength=0):
    # the output length is read on the host, as the reference reads it
    top = int(x.max().item()) if x.numel() else -1
    return torch.bincount(x.reshape(-1).long(), weights,
                          builtins.max(int(minlength), top + 1))


@defop("nanmedian")
def _nanmedian(x, axis=None, keepdim=False):
    """The median of the non-NaN values, the mean of the two middle ones
    for an even count (numpy's, and the reference's)."""
    dims = _dims(axis, x.dim())
    rest = [d for d in range(x.dim()) if d not in dims]
    v = x.permute(*rest, *dims).reshape(*[x.shape[d] for d in rest], -1)
    s = torch.sort(v, -1).values           # NaNs sort last
    n = (~torch.isnan(v)).sum(-1, keepdim=True)
    lo = torch.clamp((n - 1) // 2, min=0)
    mid = (torch.gather(s, -1, lo) + torch.gather(s, -1, n // 2)) / 2
    out = torch.where(n > 0, mid, torch.full_like(mid, float("nan")))[..., 0]
    if keepdim:
        out = out.reshape([1 if d in dims else x.shape[d]
                           for d in range(x.dim())])
    return out


@defop("inverse")
def _inverse(x):
    return torch.linalg.inv(x)


@defop("cholesky_solve")
def _cholesky_solve(x, y, upper=False):
    """``A^-1 x`` for ``A = y y^T`` (``y^T y`` when ``upper``) by two
    triangular solves, so ``y``'s gradient lies in its own triangle, as
    the reference's ``cho_solve`` gives it."""
    z = torch.linalg.solve_triangular(y.mT if upper else y, x, upper=False)
    return torch.linalg.solve_triangular(y if upper else y.mT, z, upper=True)


@defop("lu_unpack")
def _lu_unpack(lu_mat, pivots, unpack_ludata=True, unpack_pivots=True):
    m, n = lu_mat.shape[-2:]
    k = builtins.min(m, n)
    eye = torch.eye(m, k, dtype=lu_mat.dtype, device=lu_mat.device)
    L = torch.tril(lu_mat[..., :, :k], -1) + eye
    U = torch.triu(lu_mat[..., :k, :])
    # pivots (1-based sequential swaps) read on the host, as the reference
    perm = np.arange(m)
    for i, p in enumerate(pivots.reshape(-1).tolist()):
        p = int(p) - 1
        perm[[i, p]] = perm[[p, i]]
    P = torch.eye(m, dtype=lu_mat.dtype, device=lu_mat.device)[
        torch.as_tensor(perm, device=lu_mat.device)].T
    return P, L, U


@defop("matrix_rank_tol")
def _matrix_rank_tol(x, atol, hermitian=False):
    s = torch.linalg.eigvalsh(x) if hermitian else torch.linalg.svdvals(x)
    return torch.sum(torch.abs(s) > atol, -1).long()


@defop("broadcast_tensors")
def _broadcast_tensors(inputs):
    return tuple(torch.broadcast_tensors(*inputs))


@defop("strided_slice")
def _strided_slice(x, axes, starts, ends, strides):
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax = int(ax) % x.dim()
        sl = slice(int(s), int(e), int(st))
        if int(st) > 0:
            x = x[(slice(None),) * ax + (sl,)]
        else:                   # torch slices take no negative step
            idx = torch.arange(*sl.indices(x.shape[ax]), device=x.device)
            x = torch.index_select(x, ax, idx)
    return x


@defop("split_with_num")
def _split_with_num(x, num, axis=0):
    if x.shape[axis] % int(num):
        raise ValueError(f"split_with_num: dim {x.shape[axis]} is not "
                         f"divisible by {num}")
    return tuple(torch.split(x, x.shape[axis] // int(num), axis))


@defop("reverse")
def _reverse(x, axis):
    return torch.flip(x, _dims(axis, x.dim()))


@defop("trans_layout")
def _trans_layout(x, perm):
    return x.permute(*perm)


@defop("tril_indices")
def _tril_indices(rows, cols, offset=0, dtype="int64"):
    return _new(torch.tril_indices(rows, cols, offset).to(
        convert_dtype(dtype)))


@defop("triu_indices")
def _triu_indices(row, col, offset=0, dtype="int64"):
    return _new(torch.triu_indices(row, col, offset).to(
        convert_dtype(dtype)))


@defop("shard_index")
def _shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(x, shard_size),
                       torch.full_like(x, ignore_value))


@defop("assign_out_")
def _assign_out_(x, output):
    return torch.broadcast_to(x, output.shape).to(output.dtype).clone()


@defop("assign_value_")
def _assign_value_(shape, dtype, values):
    return _new(torch.as_tensor(np.asarray(values),
                                dtype=convert_dtype(dtype)).reshape(
        tuple(shape)))


@defop("copy_to")
def _copy_to(x, place=None, blocking=True):
    """``x`` on ``place`` (a copy; ``x``'s own device when None)."""
    dev = x.device if place is None else resolve_device(place)
    return x.to(dev, copy=True, non_blocking=not blocking)


@defop("coalesce_tensor")
def _coalesce_tensor(inputs, **kw):
    """The inputs in one contiguous buffer (the reference fuses buffers
    for a fused allreduce): the outputs are views of the flat buffer,
    which comes last."""
    flat = torch.cat([i.reshape(-1) for i in inputs])
    outs, off = [], 0
    for i in inputs:
        outs.append(flat[off:off + i.numel()].reshape(i.shape))
        off += i.numel()
    return (*outs, flat)


@defop("check_numerics")
def _check_numerics(x, op_type="", var_name="", message=""):
    nan, inf = torch.isnan(x), torch.isinf(x)
    return nan.any() | inf.any(), nan.sum() + inf.sum()


@defop("check_finite_and_unscale_")
def _check_finite_and_unscale_(grads, scale):
    inv = 1.0 / scale
    found_inf = torch.zeros((), dtype=torch.bool, device=grads[0].device)
    outs = []
    for g in grads:
        g = g * inv
        found_inf = found_inf | ~torch.isfinite(g).all()
        outs.append(g)
    return (*outs, found_inf)


@defop("update_loss_scaling_")
def _update_loss_scaling_(scale, good_steps, bad_steps, found_inf,
                          incr_every_n_steps=2000, decr_every_n_nan_or_inf=2,
                          incr_ratio=2.0, decr_ratio=0.5):
    found_inf = _like(found_inf, scale, torch.bool)
    new_good = torch.where(found_inf, 0, good_steps + 1)
    new_bad = torch.where(found_inf, bad_steps + 1, 0)
    grow = new_good >= incr_every_n_steps
    shrink = new_bad >= decr_every_n_nan_or_inf
    new_scale = torch.where(shrink, scale * decr_ratio,
                            torch.where(grow, scale * incr_ratio, scale))
    return (new_scale,
            torch.where(grow, 0, new_good).to(good_steps.dtype),
            torch.where(shrink, 0, new_bad).to(bad_steps.dtype))


@defop("average_accumulates_")
def _average_accumulates_(param, sum1, sum2, sum3, num_accum, old_num,
                          num_updates, average_window=10,
                          max_average_window=10000, min_average_window=10000):
    return (sum1 + param, sum2.clone(), sum3.clone(), num_accum + 1,
            old_num.clone(), num_updates + 1)


@defop("segment_pool")
def _segment_pool(x, segment_ids, pooltype="SUM"):
    # the segment count is read on the host, as the reference reads it
    num = int(segment_ids.max().item()) + 1 if segment_ids.numel() else 0
    ids = segment_ids.long()
    shape = (num,) + tuple(x.shape[1:])
    index = ids.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)
    if pooltype in ("SUM", "MEAN"):
        s = torch.zeros(shape, dtype=x.dtype, device=x.device).scatter_add(
            0, index, x)
        if pooltype == "SUM":
            return s
        c = torch.zeros(shape, dtype=x.dtype, device=x.device).scatter_add(
            0, index, torch.ones_like(x))
        return s / torch.clamp(c, min=1)
    if pooltype in ("MAX", "MIN"):
        # an empty segment holds the identity (-inf / +inf), as
        # jax.ops.segment_max / segment_min leave it
        fill = float("-inf") if pooltype == "MAX" else float("inf")
        out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        return out.scatter_reduce(0, index, x, "amax" if pooltype == "MAX"
                                  else "amin", include_self=True)
    raise ValueError(pooltype)


# ---------------------------------------------------------------------------
# random: from the port's explicit generators
# ---------------------------------------------------------------------------
def _draw_args(dtype):
    dev = resolve_device(None)
    return dev, get_generator(dev), convert_dtype(dtype or
                                                   get_default_dtype())


@defop("gaussian")
def _gaussian(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    dev, g, dt = _draw_args(dtype)
    z = torch.randn(tuple(int(s) for s in shape), generator=g, device=dev,
                    dtype=dt)
    return wrap(mean + std * z)


@defop("truncated_gaussian_random")
def _truncated_gaussian_random(shape, mean=0.0, std=1.0, seed=0,
                               dtype="float32"):
    """A normal truncated to two standard deviations, by the inverse CDF
    of a uniform draw over [Phi(-2), Phi(2)]."""
    dev, g, dt = _draw_args(dtype)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(tuple(int(s) for s in shape), generator=g, device=dev,
                   dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1)
    return wrap((mean + std * z.clamp(-2.0, 2.0)).to(dt))


def _standard_gamma(alpha, g):
    """Gamma(alpha, 1) draws by Marsaglia and Tsang's method from
    generator ``g`` (alpha < 1 boosted by ``U ** (1 / alpha)``); the host
    reads once a round whether every draw was accepted."""
    a = alpha.double()
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(a.shape, generator=g, device=a.device,
                        dtype=a.dtype)
        u = torch.rand(a.shape, generator=g, device=a.device, dtype=a.dtype)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a.shape, generator=g, device=a.device, dtype=a.dtype)
    return torch.where(boost, out * u ** (1.0 / a), out)


@defop("dirichlet")
def _dirichlet(alpha):
    y = _standard_gamma(alpha, get_generator(alpha.device))
    return (y / y.sum(-1, keepdim=True)).to(alpha.dtype)


@defop("uniform_inplace")
def _uniform_inplace(x, min=-1.0, max=1.0, seed=0, **kw):
    return torch.empty_like(x).uniform_(min, max,
                                        generator=get_generator(x.device))


# ---------------------------------------------------------------------------
# signal: frame / overlap_add
# ---------------------------------------------------------------------------
@defop("frame")
def _frame(x, frame_length, hop_length, axis=-1):
    n = x.shape[axis]
    num_frames = 1 + (n - frame_length) // hop_length
    starts = torch.arange(num_frames, device=x.device) * hop_length
    idx = starts[:, None] + torch.arange(frame_length, device=x.device)
    framed = torch.movedim(x, axis, -1)[..., idx]   # [..., frames, length]
    framed = framed.transpose(-2, -1)               # [..., length, frames]
    if axis == 0:
        framed = torch.movedim(framed, (-2, -1), (0, 1))
    return framed


@defop("overlap_add")
def _overlap_add(x, hop_length, axis=-1):
    if axis == 0:
        x = torch.movedim(x, (0, 1), (-2, -1))
    frame_length, num_frames = x.shape[-2], x.shape[-1]
    out_len = (num_frames - 1) * hop_length + frame_length
    starts = torch.arange(num_frames, device=x.device) * hop_length
    idx = starts[None, :] + torch.arange(frame_length, device=x.device)[:,
                                                                       None]
    out = torch.zeros(x.shape[:-2] + (out_len,), dtype=x.dtype,
                      device=x.device)
    out = out.index_add(-1, idx.reshape(-1),
                        x.reshape(x.shape[:-2] + (-1,)))
    if axis == 0:
        out = torch.movedim(out, -1, 0)
    return out


# ---------------------------------------------------------------------------
# sequence decoding
# ---------------------------------------------------------------------------
@defop("edit_distance")
def _edit_distance(hyps, refs, hypslength=None, refslength=None,
                   normalized=True):
    """Levenshtein distance, one row of the DP table a hypothesis token for
    the whole batch: ``new[j] = j + cummin_k(t[k] - k)`` with ``t[0] =
    d[0] + 1`` and ``t[k] = min(d[k] + 1, d[k - 1] + cost)`` (the same
    values as the reference's inner scan over the reference tokens)."""
    b, hlen = hyps.shape
    rlen = refs.shape[1]
    dev = hyps.device
    hl = hypslength.reshape(-1) if hypslength is not None else \
        torch.full((b,), hlen, device=dev)
    rl = refslength.reshape(-1) if refslength is not None else \
        torch.full((b,), rlen, device=dev)
    ar = torch.arange(rlen + 1, device=dev, dtype=torch.float32)
    d = ar.expand(b, rlen + 1)
    for i in range(hlen):
        cost = (refs != hyps[:, i:i + 1]).float()          # [b, rlen]
        t = torch.cat([d[:, :1] + 1.0,
                       torch.minimum(d[:, 1:] + 1.0, d[:, :-1] + cost)], 1)
        new = torch.cummin(t - ar, 1).values + ar
        d = torch.where((i < hl)[:, None], new, d)
    dist = torch.gather(d, 1, rl.long()[:, None])[:, 0]
    if normalized:
        dist = dist / torch.clamp(rl, min=1)
    return dist.reshape(b, 1), torch.tensor(b, dtype=torch.int64,
                                            device=dev)


@defop("gather_tree")
def _gather_tree(ids, parents):
    """Beam-search ancestry traced backwards: ids / parents ``[time,
    batch, beam]``."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).to(parents.dtype)
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        outs[t] = torch.gather(ids[t], -1, beams.long())
        beams = torch.gather(parents[t], -1, beams.long())
    return torch.stack(outs)


@defop("viterbi_decode")
def _viterbi_decode(potentials, transition, lengths,
                    include_bos_eos_tag=True):
    """Max-product decode over a linear-chain CRF: potentials ``[B, T,
    N]``, transition ``[N, N]`` -> (scores ``[B]``, paths ``[B, T]``).
    ``include_bos_eos_tag`` is taken and ignored, as the reference
    ignores it (ROADMAP R25)."""
    B, T, N = potentials.shape
    ar = torch.arange(N, device=potentials.device)
    score = potentials[:, 0]
    bps = []
    for t in range(1, T):
        cand = score[:, :, None] + transition        # [B, from, to]
        best, bp = cand.max(1)
        valid = (t < lengths)[:, None]
        score = torch.where(valid, best + potentials[:, t], score)
        bps.append(torch.where(valid, bp, ar))
    last = torch.argmax(score, -1)
    path = [last]
    tag = last
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return score.amax(-1), torch.stack(path[::-1], 1).long()


# ---------------------------------------------------------------------------
# vision ops
# ---------------------------------------------------------------------------
@defop("affine_grid")
def _affine_grid(theta, out_shape, align_corners=True):
    n, c, h, w = [int(s) for s in out_shape]
    kw = dict(dtype=theta.dtype, device=theta.device)

    def axis_coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, **kw)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size, **kw)

    gy, gx = torch.meshgrid(axis_coords(h), axis_coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
    grid = torch.einsum("nij,pj->npi", theta, base)
    return grid.reshape(n, h, w, 2)


def _pixels(x, bidx):
    """``at(yy, xx)``: the channels-last rows of ``x [N, C, H, W]`` at
    integer coordinates of images ``bidx``, zero outside the map
    (``[*S, C]``): one row gather over ``x.permute(0, 2, 3, 1)``."""
    N, C, H, W = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    base = bidx.long() * (H * W)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    def at(yy, xx):
        valid = ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W))[..., None]
        flat = base + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        return torch.where(valid, rows[flat.reshape(-1)].reshape(
            flat.shape + (C,)), zero)

    return at


def bilinear_gather(x, bidx, ys, xs):
    """Bilinear samples of ``x [N, C, H, W]`` at float coordinates ``ys``,
    ``xs`` (any equal shapes ``S``) of images ``bidx`` (an int tensor
    broadcastable to ``S``): ``[*S, C]``, each corner outside the map
    reading zero; one row gather a corner, whatever the number of boxes
    or images."""
    at = _pixels(x, bidx)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0, x0 = y0.long(), x0.long()
    return (at(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
            + at(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
            + at(y0 + 1, x0) * (wy * (1 - wx))[..., None]
            + at(y0 + 1, x0 + 1) * (wy * wx)[..., None])


@defop("grid_sample")
def _grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                 align_corners=True):
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * (w - 1) / 2
        fy = (gy + 1) * (h - 1) / 2
    else:
        fx = ((gx + 1) * w - 1) / 2
        fy = ((gy + 1) * h - 1) / 2
    bidx = torch.arange(n, device=x.device).reshape(
        (n,) + (1,) * (fx.dim() - 1))
    if mode == "nearest":
        out = _pixels(x, bidx)(torch.round(fy).long(),
                               torch.round(fx).long())
    else:
        out = bilinear_gather(x, bidx, fy, fx)
    return torch.movedim(out, -1, 1)


@defop("box_coder")
def _box_coder(prior_box, prior_box_var, target_box,
               code_type="encode_center_size", box_normalized=True, axis=0):
    one = 0 if box_normalized else 1
    pw = prior_box[:, 2] - prior_box[:, 0] + one
    ph = prior_box[:, 3] - prior_box[:, 1] + one
    px = prior_box[:, 0] + pw * 0.5
    py = prior_box[:, 1] + ph * 0.5
    var = _like(prior_box_var, prior_box) if prior_box_var is not None \
        else torch.ones((1, 4), dtype=prior_box.dtype, device=prior_box.device)
    if code_type == "encode_center_size":
        tw = target_box[:, 2] - target_box[:, 0] + one
        th = target_box[:, 3] - target_box[:, 1] + one
        tx = target_box[:, 0] + tw * 0.5
        ty = target_box[:, 1] + th * 0.5
        out = torch.stack([(tx[:, None] - px[None]) / pw[None],
                           (ty[:, None] - py[None]) / ph[None],
                           torch.log(tw[:, None] / pw[None]),
                           torch.log(th[:, None] / ph[None])], -1)
        return out / var[None]
    d = target_box * var if var.dim() == 2 else target_box
    ox = d[..., 0] * pw + px
    oy = d[..., 1] * ph + py
    ow = torch.exp(d[..., 2]) * pw
    oh = torch.exp(d[..., 3]) * ph
    return torch.stack([ox - ow * 0.5, oy - oh * 0.5,
                        ox + ow * 0.5 - one, oy + oh * 0.5 - one], -1)


@defop("prior_box")
def _prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
               variances=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
               steps=(0.0, 0.0), offset=0.5,
               min_max_aspect_ratios_order=False):
    h, w = input.shape[2], input.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_w = steps[0] or img_w / w
    step_h = steps[1] or img_h / h
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / a for a in aspect_ratios if a != 1.0]
    boxes = []
    for ms in min_sizes:
        for ar in ars:
            boxes.append((ms * np.sqrt(ar) / 2, ms / np.sqrt(ar) / 2))
        for mx in max_sizes or ():
            s = np.sqrt(ms * mx) / 2
            boxes.append((s, s))
    dt = input.dtype if input.is_floating_point() else torch.float32
    kw = dict(dtype=dt, device=input.device)
    cx = (torch.arange(w, **kw) + offset) * step_w
    cy = (torch.arange(h, **kw) + offset) * step_h
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    out = torch.stack([
        torch.stack([(gx - bw) / img_w, (gy - bh) / img_h,
                     (gx + bw) / img_w, (gy + bh) / img_h], -1)
        for bw, bh in boxes], 2)                     # [h, w, num, 4]
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.as_tensor(list(variances), **kw).expand(h, w, len(boxes),
                                                        4).clone()
    return out, var


@defop("yolo_box")
def _yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
              downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
              iou_aware=False, iou_aware_factor=0.5):
    n, _, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + class_num, h, w)
    kw = dict(dtype=x.dtype, device=x.device)
    gx = torch.arange(w, **kw)[None, None, None, :]
    gy = torch.arange(h, **kw)[None, None, :, None]
    bx = (torch.sigmoid(x[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
          + gx) / w
    by = (torch.sigmoid(x[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
          + gy) / h
    in_w = w * downsample_ratio
    in_h = h * downsample_ratio
    # the anchors as Python numbers, one anchor at a time: no upload
    bw = torch.stack([torch.exp(x[:, a, 2]) * float(anchors[2 * a]) / in_w
                      for a in range(na)], 1)
    bh = torch.stack([torch.exp(x[:, a, 3]) * float(anchors[2 * a + 1])
                      / in_h for a in range(na)], 1)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    img_h = img_size[:, 0].to(x.dtype)[:, None, None, None]
    img_w = img_size[:, 1].to(x.dtype)[:, None, None, None]
    x0 = (bx - bw / 2) * img_w
    y0 = (by - bh / 2) * img_h
    x1 = (bx + bw / 2) * img_w
    y1 = (by + bh / 2) * img_h
    if clip_bbox:
        zero = torch.zeros((), **kw)
        x0 = torch.clamp(x0, zero, img_w - 1)
        y0 = torch.clamp(y0, zero, img_h - 1)
        x1 = torch.clamp(x1, zero, img_w - 1)
        y1 = torch.clamp(y1, zero, img_h - 1)
    boxes = torch.stack([x0, y0, x1, y1], -1).reshape(n, -1, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    mask = (conf.reshape(n, -1) > conf_thresh)[..., None]
    zero = torch.zeros((), **kw)
    return torch.where(mask, boxes, zero), torch.where(mask, scores, zero)


def iou_overlaps(b, threshold, offset=0.0):
    """``iou[..., j, i] > threshold`` for boxes ``b [..., n, 4]`` (x0, y0,
    x1, y1), the reference nms's formula (``+ 1e-10`` in the union; with
    ``offset`` 1 the pixel-coordinate areas of multiclass NMS)."""
    area = (b[..., 2] - b[..., 0] + offset) * (b[..., 3] - b[..., 1] + offset)
    x0 = torch.maximum(b[..., :, None, 0], b[..., None, :, 0])
    y0 = torch.maximum(b[..., :, None, 1], b[..., None, :, 1])
    x1 = torch.minimum(b[..., :, None, 2], b[..., None, :, 2])
    y1 = torch.minimum(b[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(x1 - x0 + offset, min=0) * torch.clamp(
        y1 - y0 + offset, min=0)
    iou = inter / (area[..., :, None] + area[..., None, :] - inter + 1e-10)
    return iou > threshold


def nms_keep(overlaps, valid=None):
    """The greedy keep mask of boxes in score order, from ``overlaps[...,
    j, i]`` (box j overlaps box i above the threshold): box i is kept
    unless a kept box j < i overlaps it. Iterated from all-ones as
    ``keep = ~any(keep[j] & overlaps[j, i], j < i)`` (one boolean
    reduction a step, all leading dims at once); after step s the first s
    boxes' entries are final, and a step that changes nothing is the
    fixed point: the host reads that once every :data:`NMS_ROUND` steps.
    ``valid`` (same leading dims) drops padded boxes from both sides.
    Returns the mask and the host reads it took."""
    n = overlaps.shape[-1]
    over = torch.triu(overlaps, 1)
    if valid is not None:
        over = over & valid[..., :, None] & valid[..., None, :]
    keep = torch.ones(overlaps.shape[:-1], dtype=torch.bool,
                      device=overlaps.device)
    reads = 0
    for _ in range(0, n + 1, NMS_ROUND):
        for _ in range(NMS_ROUND - 1):
            keep = ~(keep[..., :, None] & over).any(-2)
        new = ~(keep[..., :, None] & over).any(-2)
        reads += 1
        if torch.equal(new, keep):
            break
        keep = new
    return keep, reads


@defop("nms")
def _nms(boxes, scores=None, threshold=0.3):
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True) if scores is not None else \
        torch.arange(n, device=boxes.device)
    keep, _ = nms_keep(iou_overlaps(boxes[order], threshold))
    return order[keep]


@defop("temporal_shift")
def _temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    nt, c, h, w = x.shape
    n = nt // seg_num
    x = x.reshape(n, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([x[:, 1:, :fold], torch.zeros_like(x[:, :1, :fold])], 1)
    right = torch.cat([torch.zeros_like(x[:, :1, fold:2 * fold]),
                       x[:, :-1, fold:2 * fold]], 1)
    rest = x[:, :, 2 * fold:]
    return torch.cat([left, right, rest], 2).reshape(nt, c, h, w)


@defop("pad3d")
def _pad3d(x, paddings, mode="constant", value=0.0, data_format="NCDHW"):
    p = [int(v) for v in paddings]      # [l, r, top, bottom, front, back]
    if data_format != "NCDHW":
        x = x.permute(0, 4, 1, 2, 3)
    if mode == "constant":
        out = TF.pad(x, p, value=value)
    else:
        out = TF.pad(x, p, mode={"reflect": "reflect",
                                 "replicate": "replicate",
                                 "circular": "circular"}[mode])
    return out if data_format == "NCDHW" else out.permute(0, 2, 3, 4, 1)


def _unpool_nd(x, indices, out_spatial):
    n, c = x.shape[:2]
    flat = torch.zeros((n, c, math.prod(out_spatial)), dtype=x.dtype,
                       device=x.device)
    flat = flat.scatter(2, indices.reshape(n, c, -1).long(),
                        x.reshape(n, c, -1))
    return flat.reshape((n, c) + tuple(out_spatial))


@defop("unpool")
def _unpool(x, indices, ksize, strides=None, paddings=None, output_size=None,
            data_format="NCHW"):
    h, w = x.shape[2:]
    if output_size is not None:
        out = (int(output_size[-2]), int(output_size[-1]))
    else:
        s = strides or ksize
        out = (h * s[0], w * s[1])
    return _unpool_nd(x, indices, out)


@defop("unpool3d")
def _unpool3d(x, indices, ksize, strides=None, paddings=None,
              output_size=None, data_format="NCDHW"):
    d, h, w = x.shape[2:]
    if output_size is not None:
        out = tuple(int(v) for v in output_size[-3:])
    else:
        s = strides or ksize
        out = (d * s[0], h * s[1], w * s[2])
    return _unpool_nd(x, indices, out)


@defop("repeat_interleave_with_tensor_index")
def _repeat_interleave_tensor(x, repeats, axis=0):
    return torch.repeat_interleave(x, repeats.long(), dim=axis)


@defop("spectral_norm")
def _spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    w = torch.movedim(weight, dim, 0).reshape(weight.shape[dim], -1)
    for _ in range(builtins.max(1, power_iters)):
        v = w.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = w @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ w @ v
    return weight / sigma


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(
        int(a) for a in v)


@defop("deform_conv2d")
def _deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                   dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 / v2: the sampled im2col built with one
    gather a bilinear corner over ``[N, dg, C / dg, K * Ho * Wo]`` (no loop
    over positions), then contracted with the weights by one grouped
    einsum. Offsets ``[N, 2 * dg * kh * kw, Ho, Wo]`` with the (k, {dy,
    dx}) interleave; the v2 mask ``[N, dg * kh * kw, Ho, Wo]``. Its
    backward is the gathers' scatter-add (atomics on CUDA)."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    N, Cin, H, W = x.shape
    Cout, Cin_g, kh, kw = weight.shape
    K = kh * kw
    dg = int(deformable_groups)
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev = x.device
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    ky = (torch.arange(kh, device=dev) * dh).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * dw).repeat(kh)
    oy = torch.arange(Ho, device=dev) * sh - ph
    ox = torch.arange(Wo, device=dev) * sw - pw
    ys = (ky[:, None, None] + oy[None, :, None]).expand(K, Ho, Wo).to(
        offset.dtype)
    xs = (kx[:, None, None] + ox[None, None, :]).expand(K, Ho, Wo).to(
        offset.dtype)
    ys = ys[None, None] + off[:, :, :, 0]              # [N, dg, K, Ho, Wo]
    xs = xs[None, None] + off[:, :, :, 1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, :, None]
    wx = (xs - x0)[:, :, None]
    xg = x.reshape(N, dg, Cin // dg, H * W)
    shape = (N, dg, Cin // dg, K * Ho * Wo)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        flat = (yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long())
        vals = torch.gather(xg, 3, flat.reshape(N, dg, 1, -1).expand(shape))
        return vals.reshape(N, dg, Cin // dg, K, Ho, Wo) * \
            inb[:, :, None].to(x.dtype)

    cols = (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x0 + 1) * (1 - wy) * wx
            + gather(y0 + 1, x0) * wy * (1 - wx)
            + gather(y0 + 1, x0 + 1) * wy * wx)
    if mask is not None:
        cols = cols * mask.reshape(N, dg, 1, K, Ho, Wo)
    wq = weight.reshape(groups, Cout // groups, Cin_g, K)
    cg = cols.reshape(N, groups, Cin // groups, K, Ho, Wo)
    out = torch.einsum("ngckhw,gdck->ngdhw", cg, wq).reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, Cout, 1, 1)
    return out


def roi_batch_index(boxes_num, device):
    """The image of each roi from ``boxes_num`` (read on the host, as the
    reference reads it)."""
    counts = [int(c) for c in (boxes_num.tolist() if isinstance(
        boxes_num, torch.Tensor) else np.asarray(boxes_num).tolist())]
    return torch.repeat_interleave(torch.arange(len(counts), device=device),
                                   torch.as_tensor(counts, device=device))


def quot(a, n):
    """``a / n`` for a Python number ``n``, divided by a 0-dim tensor on
    ``a``'s device: CUDA divides by a Python number as a product with its
    reciprocal, one f32 step from the quotient that the CPU (and the
    reference) take."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def _roi_grid(y0, x0, bin_h, bin_w, ph, pw, ratio, dt):
    """Sample coordinates ``[R, ph * r, pw * r]`` of each roi's bins:
    ``y0 + (i + 0.5) / ratio * bin_h``, in ``dt`` (the reference computes
    the box terms in the boxes' dtype and the grid in the promoted one)."""
    dev = y0.device
    gy = quot(torch.arange(ph * ratio, device=dev, dtype=dt) + 0.5, ratio)
    gx = quot(torch.arange(pw * ratio, device=dev, dtype=dt) + 0.5, ratio)
    ys = y0.to(dt)[:, None] + gy[None] * bin_h.to(dt)[:, None]
    xs = x0.to(dt)[:, None] + gx[None] * bin_w.to(dt)[:, None]
    return (ys[:, :, None].expand(-1, -1, xs.shape[1]),
            xs[:, None, :].expand(-1, ys.shape[1], -1))


@defop("roi_align")
def _roi_align(x, boxes, boxes_num, pooled_height=1, pooled_width=1,
               spatial_scale=1.0, sampling_ratio=-1, aligned=True):
    """RoIAlign: the mean of ``ratio x ratio`` bilinear samples a bin, all
    rois in one batched gather. ``sampling_ratio <= 0`` takes 2 samples a
    bin side, where Paddle's is adaptive (ROADMAP R21)."""
    ratio = 2 if sampling_ratio <= 0 else int(sampling_ratio)
    bi = roi_batch_index(boxes_num, x.device)
    off = 0.5 if aligned else 0.0
    x0 = boxes[:, 0] * spatial_scale - off
    y0 = boxes[:, 1] * spatial_scale - off
    x1 = boxes[:, 2] * spatial_scale - off
    y1 = boxes[:, 3] * spatial_scale - off
    floor = 1e-6 if aligned else 1.0
    rw = torch.clamp(x1 - x0, min=floor)
    rh = torch.clamp(y1 - y0, min=floor)
    ys, xs = _roi_grid(y0, x0, quot(rh, pooled_height),
                       quot(rw, pooled_width),
                       pooled_height, pooled_width, ratio,
                       torch.promote_types(x.dtype, boxes.dtype))
    samp = bilinear_gather(x, bi[:, None, None], ys, xs)   # [R, P, Q, C]
    R, C = samp.shape[0], samp.shape[-1]
    samp = samp.reshape(R, pooled_height, ratio, pooled_width, ratio, C)
    return samp.mean((2, 4)).permute(0, 3, 1, 2)


@defop("roi_pool")
def _roi_pool(x, boxes, boxes_num, pooled_height=1, pooled_width=1,
              spatial_scale=1.0):
    """RoIPool as the reference computes it: the max over a dense grid of
    4 x 4 bilinear samples a bin, not over Paddle's quantised bins
    (ROADMAP R22)."""
    ratio = 4
    bi = roi_batch_index(boxes_num, x.device)
    x0 = torch.round(boxes[:, 0] * spatial_scale)
    y0 = torch.round(boxes[:, 1] * spatial_scale)
    x1 = torch.round(boxes[:, 2] * spatial_scale)
    y1 = torch.round(boxes[:, 3] * spatial_scale)
    rh = torch.clamp(y1 - y0 + 1, min=1.0)
    rw = torch.clamp(x1 - x0 + 1, min=1.0)
    dev, dt = x.device, torch.promote_types(x.dtype, boxes.dtype)
    gy = quot(quot(torch.arange(pooled_height * ratio, device=dev, dtype=dt)
                   + 0.5, ratio), pooled_height)
    gx = quot(quot(torch.arange(pooled_width * ratio, device=dev, dtype=dt)
                   + 0.5, ratio), pooled_width)
    ys = (y0.to(dt)[:, None] + gy[None] * rh.to(dt)[:, None])[:, :, None]
    xs = (x0.to(dt)[:, None] + gx[None] * rw.to(dt)[:, None])[:, None, :]
    ys, xs = torch.broadcast_tensors(ys, xs)
    samp = bilinear_gather(x, bi[:, None, None], ys, xs)
    R, C = samp.shape[0], samp.shape[-1]
    samp = samp.reshape(R, pooled_height, ratio, pooled_width, ratio, C)
    return samp.amax((2, 4)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# losses not already in nn.functional
# ---------------------------------------------------------------------------
def _bce_logits(x, t):
    return torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


@defop("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce_logits(x, label, normalize=False, ignore_index=-100):
    mask = (label != ignore_index).to(x.dtype)
    loss = _bce_logits(x, label) * mask
    if normalize:
        loss = loss / torch.clamp(mask.sum(), min=1.0)
    return loss


@defop("margin_cross_entropy")
def _margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                          margin3=0.0, scale=64.0, return_softmax=False,
                          **kw):
    """ArcFace-style margin softmax on one device."""
    n, c = logits.shape
    theta = torch.arccos(torch.clamp(logits, -1.0, 1.0))
    tgt = torch.cos(margin1 * theta + margin2) - margin3
    onehot = TF.one_hot(label.reshape(-1).long(), c).to(logits.dtype)
    adjusted = scale * torch.where(onehot > 0, tgt, logits)
    logp = torch.log_softmax(adjusted, -1)
    loss = -torch.sum(onehot * logp, -1)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


@defop("hsigmoid_loss")
def _hsigmoid_loss(x, label, weight, bias=None, num_classes=2,
                   path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid over the default complete binary tree."""
    code_len = int(np.ceil(np.log2(builtins.max(num_classes, 2))))
    node = label.reshape(-1).long() + num_classes
    nodes, bits = [], []
    for _ in range(code_len):
        bits.append(node % 2)
        node = node // 2
        nodes.append(node)
    nodes, bits = torch.stack(nodes, 1), torch.stack(bits, 1)
    valid = nodes >= 1
    nodes = torch.clamp(nodes - 1, 0, weight.shape[0] - 1)
    logits = torch.einsum("nkd,nd->nk", weight[nodes], x)
    if bias is not None:
        logits = logits + bias.reshape(-1)[nodes]
    loss = _bce_logits(logits, bits.to(x.dtype))
    return torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device)).sum(
        -1, keepdim=True)


# ---------------------------------------------------------------------------
# metric ops
# ---------------------------------------------------------------------------
@defop("accuracy")
def _accuracy(x, indices, label):
    correct = (indices[:, :1] == label.reshape(-1, 1)).any(-1)
    return (correct.float().mean(), correct.int().sum().int(),
            torch.tensor(x.shape[0], dtype=torch.int32, device=x.device))


@defop("auc")
def _auc(predict, label, num_thresholds=4095, **kw):
    pos = predict[:, -1]
    thresh = torch.linspace(0.0, 1.0, num_thresholds + 1, device=pos.device,
                            dtype=torch.float64)
    pred_pos = pos[None, :] >= thresh[:, None]
    lab = label.reshape(-1).bool()
    tp = (pred_pos & lab[None]).sum(1)
    fp = (pred_pos & ~lab[None]).sum(1)
    tpr = tp / torch.clamp(lab.sum(), min=1)
    fpr = fp / torch.clamp((~lab).sum(), min=1)
    auc = -torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0)
    return auc, tp.long(), fp.long()


# ---------------------------------------------------------------------------
# functional optimizer update rules (the reference's in-place ops)
# ---------------------------------------------------------------------------
@defop("sgd_")
def _sgd_(param, learning_rate, grad, master_param=None,
          multi_precision=False):
    return param - learning_rate * grad


def _momentum(param, grad, velocity, learning_rate, mu=0.9,
              use_nesterov=False):
    v = mu * velocity + grad
    if use_nesterov:
        return param - learning_rate * (grad + mu * v), v
    return param - learning_rate * v, v


@defop("momentum_")
def _momentum_(param, grad, velocity, learning_rate, mu=0.9,
               use_nesterov=False, **kw):
    return _momentum(param, grad, velocity, learning_rate, mu, use_nesterov)


def _adam(param, grad, learning_rate, moment1, moment2, beta1_pow,
          beta2_pow, beta1=0.9, beta2=0.999, epsilon=1e-8):
    m = beta1 * moment1 + (1 - beta1) * grad
    v = beta2 * moment2 + (1 - beta2) * torch.square(grad)
    b1p = beta1_pow * beta1
    b2p = beta2_pow * beta2
    mhat = m / (1 - b1p)
    vhat = v / (1 - b2p)
    p = param - learning_rate * mhat / (torch.sqrt(vhat) + epsilon)
    return p, m, v, b1p, b2p


@defop("adam_")
def _adam_(param, grad, learning_rate, moment1, moment2, beta1_pow,
           beta2_pow, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
    return _adam(param, grad, learning_rate, moment1, moment2, beta1_pow,
                 beta2_pow, beta1, beta2, epsilon)


@defop("adamw_")
def _adamw_(param, grad, learning_rate, moment1, moment2, beta1_pow,
            beta2_pow, beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01,
            lr_ratio=1.0, **kw):
    param = param * (1 - learning_rate * coeff)
    return _adam(param, grad, learning_rate, moment1, moment2, beta1_pow,
                 beta2_pow, beta1, beta2, epsilon)


@defop("adamax_")
def _adamax_(param, grad, learning_rate, moment, inf_norm, beta1_pow,
             beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
    m = beta1 * moment + (1 - beta1) * grad
    u = torch.maximum(beta2 * inf_norm, torch.abs(grad))
    p = param - learning_rate / (1 - beta1_pow * beta1) * m / (u + epsilon)
    return p, m, u


@defop("adagrad_")
def _adagrad_(param, grad, moment, learning_rate, epsilon=1e-6, **kw):
    mom = moment + torch.square(grad)
    return param - learning_rate * grad / (torch.sqrt(mom) + epsilon), mom


@defop("adadelta_")
def _adadelta_(param, grad, avg_squared_grad, avg_squared_update,
               learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
    g2 = rho * avg_squared_grad + (1 - rho) * torch.square(grad)
    upd = -torch.sqrt(avg_squared_update + epsilon) / torch.sqrt(
        g2 + epsilon) * grad
    u2 = rho * avg_squared_update + (1 - rho) * torch.square(upd)
    return param + learning_rate * upd, g2, u2


@defop("rmsprop_")
def _rmsprop_(param, mean_square, grad, moment, learning_rate,
              mean_grad=None, epsilon=1e-10, decay=0.9, momentum=0.0,
              centered=False, **kw):
    ms = decay * mean_square + (1 - decay) * torch.square(grad)
    centred = centered and mean_grad is not None
    if centred:
        mg = decay * mean_grad + (1 - decay) * grad
        denom = ms - torch.square(mg) + epsilon
    else:
        denom = ms + epsilon
    mom = momentum * moment + learning_rate * grad / torch.sqrt(denom)
    return (param - mom, ms, mom) + ((mg,) if centred else ())


@defop("lamb_")
def _lamb_(param, grad, learning_rate, moment1, moment2, beta1_pow,
           beta2_pow, weight_decay=0.01, beta1=0.9, beta2=0.999,
           epsilon=1e-6, **kw):
    m = beta1 * moment1 + (1 - beta1) * grad
    v = beta2 * moment2 + (1 - beta2) * torch.square(grad)
    b1p = beta1_pow * beta1
    b2p = beta2_pow * beta2
    r = (m / (1 - b1p)) / (torch.sqrt(v / (1 - b2p)) + epsilon) \
        + weight_decay * param
    w_norm = torch.linalg.vector_norm(param)
    r_norm = torch.linalg.vector_norm(r)
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    return param - learning_rate * ratio * r, m, v, b1p, b2p


def _merged_adam(params, grads, learning_rate, moments1, moments2,
                 beta1_pows, beta2_pows, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
    outs = [_adam(p, g, learning_rate, m1, m2, b1, b2, beta1, beta2, epsilon)
            for p, g, m1, m2, b1, b2 in zip(params, grads, moments1,
                                            moments2, beta1_pows,
                                            beta2_pows)]
    return tuple(zip(*outs))


_merged_adam_ = defop("merged_adam_")(_merged_adam)
_fused_adam_ = defop("fused_adam_")(_merged_adam)


@defop("merged_momentum_")
def _merged_momentum_(params, grads, velocitys, learning_rate, mu=0.9,
                      use_nesterov=False, **kw):
    outs = [_momentum(p, g, v, learning_rate, mu, use_nesterov)
            for p, g, v in zip(params, grads, velocitys)]
    return tuple(zip(*outs))


# ---------------------------------------------------------------------------
# aliases: capabilities living in nn.functional / kernels under other names
# ---------------------------------------------------------------------------
def class_center_sample(*args, **kwargs):
    """The reference's ``F.class_center_sample`` raises (it needs the
    model-parallel group); so does the port's."""
    raise NotImplementedError("class_center_sample needs a model-parallel "
                              "group, which neither package has")


def _register_aliases():
    from ..nn import functional as F

    for name, fn in [
            ("conv2d", F.conv2d), ("conv3d", F.conv3d),
            ("conv2d_transpose", F.conv2d_transpose),
            ("conv3d_transpose", F.conv3d_transpose)]:
        _alias(name, fn)

    def _depthwise(fn):
        def conv(x, weight, bias=None, stride=1, padding=0, dilation=1,
                 groups=None, data_format="NCHW", **kw):
            # the reference's depthwise kernel: groups == input channels
            # when the caller leaves groups unset
            if groups is None or groups == 1:
                groups = (x.shape[1] if data_format.startswith("NC")
                          else x.shape[-1])
            return fn(x, weight, bias, stride, padding, dilation=dilation,
                      groups=int(groups), data_format=data_format, **kw)

        return conv

    _alias("depthwise_conv2d", _depthwise(F.conv2d))
    _alias("depthwise_conv2d_transpose", _depthwise(F.conv2d_transpose))
    _alias("batch_norm", F.batch_norm)
    _alias("sync_batch_norm_", F.batch_norm)    # one device: its statistics
    _alias("layer_norm", F.layer_norm)
    _alias("instance_norm", F.instance_norm)
    _alias("group_norm", F.group_norm)
    _alias("dropout", F.dropout)
    _alias("embedding", F.embedding)
    _alias("fold", F.fold)
    _alias("unfold", F.unfold)
    _alias("pixel_shuffle", F.pixel_shuffle)
    _alias("channel_shuffle", F.channel_shuffle)
    _alias("label_smooth", F.label_smooth)
    _alias("class_center_sample", class_center_sample)
    _alias("bilinear", F.bilinear)

    def _pool_nd(avg, mx):
        def pool(x, kernel_size=2, stride=None, padding=0,
                 pooling_type="max", **kw):
            fn = mx if str(pooling_type).lower() == "max" else avg
            return fn(x, kernel_size, stride, padding, **kw)

        return pool

    _alias("pool2d", _pool_nd(F.avg_pool2d, F.max_pool2d))
    _alias("pool3d", _pool_nd(F.avg_pool3d, F.max_pool3d))

    def _with_index(fn):
        def pool(x, kernel_size=2, stride=None, padding=0, **kw):
            # the reference's contract: always (out, argmax indices into
            # the flattened input plane)
            kw.pop("return_mask", None)
            return fn(x, kernel_size, stride, padding, return_mask=True,
                      **kw)

        return pool

    _alias("max_pool2d_with_index", _with_index(F.max_pool2d))
    _alias("max_pool3d_with_index", _with_index(F.max_pool3d))
    _alias("prelu", F.prelu)
    _alias("logsigmoid", OPS["log_sigmoid"].fn)
    _alias("tanh_shrink", OPS["tanhshrink"].fn)
    _alias("bce_loss", F.binary_cross_entropy)
    _alias("huber_loss", F.smooth_l1_loss)
    _alias("kldiv_loss", F.kl_div)
    _alias("log_loss", F.log_loss)
    _alias("nll_loss", F.nll_loss)
    # these five reach the hand-written kernels on CUDA tensors
    _alias("cross_entropy_with_softmax", F.softmax_with_cross_entropy)
    _alias("warpctc", F.ctc_loss)
    _alias("warprnnt", F.rnnt_loss)
    _alias("flash_attn", F.flash_attention)
    _alias("flash_attn_unpadded", F.flash_attn_unpadded)
    _alias("memory_efficient_attention", F.scaled_dot_product_attention)

    # interpolate modes (the reference has one op a mode)
    for op, mode in [("bilinear_interp", "bilinear"),
                     ("nearest_interp", "nearest"),
                     ("bicubic_interp", "bicubic"),
                     ("linear_interp", "linear"),
                     ("trilinear_interp", "trilinear")]:
        def make(mode=mode):
            def interp(x, size=None, scale_factor=None, align_corners=False,
                       **kw):
                return F.interpolate(x, size=size, scale_factor=scale_factor,
                                     mode=mode, align_corners=align_corners)

            return interp

        _alias(op, make())


_register_aliases()


# public tensor-API names of this module (installed by the package's
# __init__ where the namespace or Tensor lacks them)
PUBLIC_OPS = {
    "max": M.max, "min": M.min, "all": M.all, "any": M.any,
    "add_n": M.add_n, "addmm": _addmm, "increment": _increment,
    "cumsum": M.cumsum, "cumprod": _cumprod, "cummax": _cummax,
    "cummin": _cummin, "logcumsumexp": _logcumsumexp,
    "logsumexp": M.logsumexp, "trace": M.trace, "diagonal": _diagonal,
    "diag_embed": _diag_embed, "fill_diagonal_tensor": _fill_diagonal_tensor,
    "complex": _complex, "conj": _conj, "real": _real, "imag": _imag,
    "i0": _i0, "i0e": _i0e, "i1": _i1, "i1e": _i1e,
    "polygamma": _polygamma, "nextafter": _nextafter,
    "bincount": _bincount, "nanmedian": _nanmedian, "multiplex": M.multiplex,
    "inverse": _inverse, "cholesky_solve": _cholesky_solve,
    "lu_unpack": _lu_unpack, "broadcast_tensors": _broadcast_tensors,
    "renorm": _renorm, "reverse": _reverse,
    "tril_indices": _tril_indices, "triu_indices": _triu_indices,
}
