"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``; ports ``dropout`` and
``embedding``)."""
from __future__ import annotations

import torch

from ...framework.random import get_generator

__all__ = ["dropout", "embedding"]


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Paddle's dropout: in training each element (or, with ``axis``, each
    slice along those axes) is kept with probability ``1 - p``;
    ``upscale_in_train`` scales the kept ones by ``1 / (1 - p)``,
    ``downscale_in_infer`` leaves them and scales by ``1 - p`` at
    inference. The keep mask is drawn on x's device from ``generator``
    (default: ``framework.random``'s generator of that device); its bits
    differ from JAX's, so it agrees with the reference in distribution."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [a % x.ndim for a in (axis if isinstance(axis, (list, tuple))
                                     else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    g = generator if generator is not None else get_generator(x.device)
    keep = torch.rand(shape, device=x.device, generator=g) < (1.0 - p)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` ``[vocab, dim]`` at the integer ids ``x``; ids
    equal to ``padding_idx`` give zero rows (the reference's)."""
    out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out
