"""``paddle.fft`` (counterpart of ``paddle_tpu/fft.py``): the three
reference FFT ops (``fft_c2c``, ``fft_r2c``, ``fft_c2r``) and the 22
public functions, over ``torch.fft`` (cuFFT on the card). The reference
computes them with ``jnp.fft``, not a Pallas kernel, so the library's FFT
is their port. ``hfft2`` / ``hfftn`` / ``ihfft2`` / ``ihfftn`` are the
reference's compositions (``fftn`` over the leading axes, then the 1-d
Hermitian transform), not ``torch.fft.hfftn``. Every function goes
through the op dispatch, so a Tensor in gives a Tensor out and gradients
flow."""
from __future__ import annotations

import torch

from .core.device import resolve_device
from .core.dispatch import apply
from .core.dtype import convert_dtype
from .core.tensor import wrap
from .ops.registry import defop

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = (None, "backward", "ortho", "forward")
F = torch.fft


def _norm(norm):
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    return norm


def _axes(axes):
    return None if axes is None else tuple(axes)


# the three reference FFT ops (complex->complex, real->complex,
# complex->real)
@defop("fft_c2c")
def _fft_c2c(x, axes=None, norm="backward", forward=True):
    return (F.fftn if forward else F.ifftn)(x, dim=_axes(axes), norm=norm)


@defop("fft_r2c")
def _fft_r2c(x, axes=None, norm="backward", forward=True, onesided=True):
    out = F.rfftn(x, dim=_axes(axes), norm=norm)
    return out if forward else torch.conj_physical(out)


@defop("fft_c2r")
def _fft_c2r(x, axes=None, norm="backward", forward=True,
             last_dim_size=None):
    s = None
    if last_dim_size is not None:
        axes_t = tuple(axes) if axes is not None else tuple(range(x.dim()))
        s = tuple(x.shape[a] for a in axes_t[:-1]) + (int(last_dim_size),)
    return F.irfftn(x, s=s, dim=_axes(axes), norm=norm)


def _op(fn, x):
    # torch's inverse transforms of real input can hand back a lazily
    # conjugated view; the result is materialised
    return apply(lambda a: fn(a).resolve_conj(), x, op_name="fft")


def fft(x, n=None, axis=-1, norm="backward", name=None):
    return _op(lambda a: F.fft(a, n, axis, _norm(norm)), x)


def ifft(x, n=None, axis=-1, norm="backward", name=None):
    return _op(lambda a: F.ifft(a, n, axis, _norm(norm)), x)


def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _op(lambda a: F.fft2(a, s, _axes(axes), _norm(norm)), x)


def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _op(lambda a: F.ifft2(a, s, _axes(axes), _norm(norm)), x)


def fftn(x, s=None, axes=None, norm="backward", name=None):
    return _op(lambda a: F.fftn(a, s, _axes(axes), _norm(norm)), x)


def ifftn(x, s=None, axes=None, norm="backward", name=None):
    return _op(lambda a: F.ifftn(a, s, _axes(axes), _norm(norm)), x)


def rfft(x, n=None, axis=-1, norm="backward", name=None):
    return _op(lambda a: F.rfft(a, n, axis, _norm(norm)), x)


def irfft(x, n=None, axis=-1, norm="backward", name=None):
    return _op(lambda a: F.irfft(a, n, axis, _norm(norm)), x)


def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _op(lambda a: F.rfft2(a, s, _axes(axes), _norm(norm)), x)


def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _op(lambda a: F.irfft2(a, s, _axes(axes), _norm(norm)), x)


def rfftn(x, s=None, axes=None, norm="backward", name=None):
    return _op(lambda a: F.rfftn(a, s, _axes(axes), _norm(norm)), x)


def irfftn(x, s=None, axes=None, norm="backward", name=None):
    return _op(lambda a: F.irfftn(a, s, _axes(axes), _norm(norm)), x)


def hfft(x, n=None, axis=-1, norm="backward", name=None):
    return _op(lambda a: F.hfft(a, n, axis, _norm(norm)), x)


def ihfft(x, n=None, axis=-1, norm="backward", name=None):
    return _op(lambda a: F.ihfft(a, n, axis, _norm(norm)), x)


def _hfft_nd(a, s, axes, norm, inverse):
    """The reference's n-d Hermitian transforms: ``fftn`` over the leading
    axes and ``hfft`` over the last (``ihfft`` over the last, then
    ``ifftn`` over the leading ones)."""
    axes = tuple(axes) if axes is not None else tuple(range(a.dim()))
    n = None if s is None else s[-1]
    if inverse:
        out = F.ihfft(a, n, axes[-1], norm)
        return F.ifftn(out, dim=axes[:-1], norm=norm) if len(axes) > 1 \
            else out
    if len(axes) > 1:
        a = F.fftn(a, dim=axes[:-1], norm=norm)
    return F.hfft(a, n, axes[-1], norm)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _op(lambda a: _hfft_nd(a, s, axes, _norm(norm), False), x)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _op(lambda a: _hfft_nd(a, s, axes, _norm(norm), True), x)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    return _op(lambda a: _hfft_nd(a, s, axes, _norm(norm), False), x)


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    return _op(lambda a: _hfft_nd(a, s, axes, _norm(norm), True), x)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return wrap(F.fftfreq(n, d, dtype=convert_dtype(dtype or "float32"),
                          device=resolve_device(None)))


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return wrap(F.rfftfreq(n, d, dtype=convert_dtype(dtype or "float32"),
                           device=resolve_device(None)))


def fftshift(x, axes=None, name=None):
    return _op(lambda a: F.fftshift(a, _axes(axes)), x)


def ifftshift(x, axes=None, name=None):
    return _op(lambda a: F.ifftshift(a, _axes(axes)), x)
