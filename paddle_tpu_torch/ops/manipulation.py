"""Shape and layout ops (counterpart of ``paddle_tpu/ops/manipulation.py``),
with the JAX package's semantics: ``reshape`` gives 0 no "copy this
dimension" meaning; ``split`` with an int makes that many equal parts and a
``-1`` section takes the rest; ``gather`` is ``take`` along an axis (any
index shape); ``view`` with a dtype casts; ``pad`` with one pair per
dimension pads them in order, with fewer pairs it pads the last dimensions
first (torch's order)."""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dispatch import apply
from ..core.dtype import convert_dtype
from .registry import register

_pyslice = builtins.slice

__all__ = [
    "reshape", "transpose", "flatten", "squeeze", "unsqueeze", "concat",
    "stack", "split", "chunk", "slice", "gather", "gather_nd", "scatter",
    "scatter_nd_add", "index_select", "masked_select", "tile", "expand",
    "expand_as", "broadcast_to", "flip", "rot90", "roll", "unbind", "unstack",
    "cast", "take_along_axis", "put_along_axis", "repeat_interleave",
    "moveaxis", "as_real", "as_complex", "view", "view_as", "tensor_split",
    "dsplit", "hsplit", "vsplit", "crop", "index_put", "index_add",
    "fill_diagonal", "pad",
]

_reg = register(category="manipulation")


def shape_arg(shape):
    """A shape (list, tuple, tensor, entries possibly 0-d tensors) as a
    tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


@_reg
def reshape(x, shape, name=None):
    return apply(torch.reshape, x, shape_arg(shape), op_name="reshape")


@_reg
def transpose(x, perm=None, name=None):
    def body(v):
        p = tuple(range(v.dim() - 1, -1, -1)) if perm is None \
            else tuple(int(i) for i in perm)
        return v.permute(p)

    return apply(body, x, op_name="transpose")


@_reg
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return apply(lambda v: torch.flatten(v, start_axis, stop_axis)
                 if v.dim() else v.reshape(1), x, op_name="flatten")


@_reg
def squeeze(x, axis=None, name=None):
    def body(v):
        if axis is None:
            return torch.squeeze(v)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(a % v.dim() for a in axes if v.shape[a % v.dim()] == 1)
        return torch.squeeze(v, axes) if axes else v.view_as(v)

    return apply(body, x, op_name="squeeze")


@_reg
def unsqueeze(x, axis, name=None):
    def body(v):
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        for a in sorted(_int(a) for a in axes):
            v = torch.unsqueeze(v, a)
        return v

    return apply(body, x, op_name="unsqueeze")


@_reg
def concat(x, axis=0, name=None):
    return apply(lambda *vs: torch.cat(vs, _int(axis)), *x, op_name="concat")


@_reg
def stack(x, axis=0, name=None):
    return apply(lambda *vs: torch.stack(vs, int(axis)), *x,
                 op_name="stack")


@_reg
def split(x, num_or_sections, axis=0, name=None):
    ax = _int(axis)

    def body(v):
        total = v.shape[ax]
        if isinstance(num_or_sections, (int, np.integer)):
            n = int(num_or_sections)
            if total % n:
                raise ValueError(f"split: axis {ax} of size {total} does not "
                                 f"divide into {n} equal parts")
            return torch.split(v, total // n, ax)
        sections = [_int(s) for s in num_or_sections]
        if -1 in sections:
            known = builtins.sum(s for s in sections if s != -1)
            sections = [s if s != -1 else total - known for s in sections]
        return torch.split(v, sections, ax)

    return list(apply(body, x, op_name="split"))


@_reg
def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


@_reg
def slice(x, axes, starts, ends, name=None):
    def body(v):
        idx = [_pyslice(None)] * v.dim()
        for a, s, e in zip(axes, starts, ends):
            idx[int(a)] = _pyslice(_int(s), _int(e))
        return v[tuple(idx)]

    return apply(body, x, op_name="slice")


@_reg
def gather(x, index, axis=0, name=None):
    ax = _int(axis)

    def body(v, i):
        ax_ = ax % v.dim()
        out = torch.index_select(v, ax_, i.reshape(-1).long())
        return out.reshape(*v.shape[:ax_], *i.shape, *v.shape[ax_ + 1:])

    return apply(body, x, index, op_name="gather")


@_reg
def gather_nd(x, index, name=None):
    return apply(lambda v, i: v[tuple(i.long().movedim(-1, 0))], x, index,
                 op_name="gather_nd")


@_reg
def scatter(x, index, updates, overwrite=True, name=None):
    def body(v, i, u):
        i = (i.reshape(-1).long(),)
        if overwrite:
            return v.index_put(i, u)
        # Paddle's overwrite=False: zero the rows, then add every update
        return v.index_put(i, torch.zeros_like(u)).index_put(
            i, u, accumulate=True)

    return apply(body, x, index, updates, op_name="scatter")


@_reg
def scatter_nd_add(x, index, updates, name=None):
    return apply(lambda v, i, u: v.index_put(tuple(i.long().movedim(-1, 0)),
                                             u, accumulate=True),
                 x, index, updates, op_name="scatter_nd_add")


@_reg
def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


@_reg
def masked_select(x, mask, name=None):
    return apply(lambda v, m: torch.masked_select(v, m.bool()), x, mask,
                 op_name="masked_select")


@_reg
def tile(x, repeat_times, name=None):
    return apply(torch.tile, x, shape_arg(repeat_times), op_name="tile")


@_reg
def expand(x, shape, name=None):
    sh = shape_arg(shape)

    def body(v):
        tgt = list(sh)
        for i, s in enumerate(tgt):
            if s == -1:
                j = i - len(tgt) + v.dim()
                tgt[i] = v.shape[j] if j >= 0 else 1
        return torch.broadcast_to(v, tgt)

    return apply(body, x, op_name="expand")


@_reg
def expand_as(x, y, name=None):
    return apply(lambda v, w: torch.broadcast_to(v, w.shape), x, y,
                 op_name="expand_as")


@_reg
def broadcast_to(x, shape, name=None):
    return apply(torch.broadcast_to, x, shape_arg(shape),
                 op_name="broadcast_to")


@_reg
def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return apply(torch.flip, x, tuple(int(a) for a in axes), op_name="flip")


@_reg
def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(torch.rot90, x, k, tuple(axes), op_name="rot90")


@_reg
def roll(x, shifts, axis=None, name=None):
    sh = tuple(shifts) if isinstance(shifts, (list, tuple)) else int(shifts)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return apply(lambda v: torch.roll(v, sh, ax) if ax is not None
                 else torch.roll(v, sh), x, op_name="roll")


@_reg
def unbind(x, axis=0, name=None):
    return list(apply(torch.unbind, x, int(axis), op_name="unbind"))


unstack = register("unstack", "manipulation")(unbind)


@_reg
def cast(x, dtype):
    nd = convert_dtype(dtype)
    return apply(lambda v: v.to(nd) if v.dtype != nd else v.view_as(v), x,
                 op_name="cast")


@_reg
def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply(lambda v, i: torch.take_along_dim(v, i.long(), int(axis)),
                 arr, indices, op_name="take_along_axis")


@_reg
def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    def body(v, i, u):
        i = i.long()
        u = torch.broadcast_to(u, i.shape) if isinstance(u, torch.Tensor) \
            else torch.full(i.shape, u, dtype=v.dtype, device=v.device)
        u = u.to(v.dtype)
        if reduce == "assign":
            return torch.scatter(v, int(axis), i, u)
        if reduce == "add":
            return torch.scatter_add(v, int(axis), i, u)
        if reduce in ("mul", "multiply"):
            return torch.scatter_reduce(v, int(axis), i, u, "prod")
        raise ValueError(f"unsupported reduce {reduce}")

    return apply(body, arr, indices, values, op_name="put_along_axis")


@_reg
def repeat_interleave(x, repeats, axis=None, name=None):
    def body(v, r):
        if axis is None:
            return torch.repeat_interleave(v.reshape(-1), r, 0)
        return torch.repeat_interleave(v, r, int(axis))

    return apply(body, x, repeats, op_name="repeat_interleave")


@_reg
def moveaxis(x, source, destination, name=None):
    return apply(torch.moveaxis, x, source, destination, op_name="moveaxis")


@_reg
def as_real(x, name=None):
    return apply(lambda v: torch.stack([v.real, v.imag], -1), x,
                 op_name="as_real")


@_reg
def as_complex(x, name=None):
    return apply(lambda v: torch.complex(v[..., 0], v[..., 1]), x,
                 op_name="as_complex")


@_reg
def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


@_reg
def view_as(x, other, name=None):
    return reshape(x, tuple(other.shape))


@_reg
def tensor_split(x, num_or_indices, axis=0, name=None):
    arg = num_or_indices if isinstance(num_or_indices, (int, np.integer)) \
        else list(num_or_indices)
    return list(apply(torch.tensor_split, x, arg, int(axis),
                      op_name="tensor_split"))


@_reg
def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


@_reg
def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1)


@_reg
def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


@_reg
def crop(x, shape=None, offsets=None, name=None):
    sh = shape_arg(shape)
    offs = shape_arg(offsets) if offsets is not None else (0,) * len(sh)
    return apply(lambda v: v[tuple(_pyslice(o, o + s)
                                   for o, s in zip(offs, sh))], x,
                 op_name="crop")


@_reg
def index_put(x, indices, value, accumulate=False, name=None):
    def body(v, u, *idx):
        idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
        return v.index_put(idx, u, accumulate=accumulate)

    return apply(body, x, value, *indices, op_name="index_put")


@_reg
def index_add(x, index, axis, value, name=None):
    return apply(lambda v, i, u: torch.index_add(v, int(axis), i.long(), u),
                 x, index, value, op_name="index_add")


@_reg
def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    def body(v):
        n = builtins.min(v.shape[-2], v.shape[-1])
        i = torch.arange(n - builtins.abs(offset) if offset else n,
                         device=v.device)
        r = i + (-offset if offset < 0 else 0)
        c = i + (offset if offset > 0 else 0)
        out = v.clone()
        out[..., r, c] = value
        return out

    return apply(body, x, op_name="fill_diagonal")


@_reg
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """N-d constant / reflect / replicate / circular padding."""
    padding = shape_arg(pad)

    def body(v):
        if len(padding) == 2 * v.dim():
            pairs = [padding[2 * i:2 * i + 2] for i in range(v.dim())]
        else:
            k = len(padding) // 2
            trailing = [padding[2 * i:2 * i + 2] for i in range(k)]
            pairs = [(0, 0)] * (v.dim() - k) + list(reversed(trailing))
        if mode == "constant":
            flat = [p for pair in reversed(pairs) for p in pair]
            return F.pad(v, flat, value=value)
        # torch pads the last 1-3 dims in these modes, with one batch dim
        first = next((d for d, p in enumerate(pairs) if tuple(p) != (0, 0)),
                     v.dim())
        lead = v.shape[:first]
        body_ = v.reshape(-1, *v.shape[first:])
        flat = [p for pair in reversed(pairs[first:]) for p in pair]
        out = F.pad(body_, flat, mode=mode)
        return out.reshape(*lead, *out.shape[1:])

    return apply(body, x, op_name="pad")
