"""Vision transforms (counterpart of ``paddle_tpu/vision/transforms.py``):
numpy only, on CHW float arrays, so they run in loader workers.

``Resize`` is a numpy transcription of ``jax.image.resize(...,
"bilinear")`` with its default antialias: per resized axis a weight matrix
of the triangle kernel at ``(out + 0.5) / scale - 0.5``, widened by
``1 / scale`` when shrinking, each output's weights normalised to sum 1
(``jax._src.image.scale.compute_weight_mat``), the weights computed in
float64 and applied in float32 (``nn.functional.common.resize_weights``,
which ``F.interpolate`` builds on). ``torch.nn.functional.interpolate`` does
not antialias and differs when it shrinks. ``RandomCrop`` and
``RandomHorizontalFlip`` act on the last two axes and draw from numpy's
global ``np.random``, as the reference's do.
"""
from __future__ import annotations

import numpy as np

from ..nn.functional.common import resize_weights

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomCrop", "RandomHorizontalFlip", "Transpose"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToTensor:
    """HWC (or HW) to CHW float32, divided by 255 when its maximum is above
    1.5."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        elif (arr.ndim == 3 and self.data_format == "CHW"
              and arr.shape[-1] in (1, 3, 4)):
            arr = arr.transpose(2, 0, 1)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return arr


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, img):
        return (np.asarray(img, np.float32) - self.mean) / self.std


class Resize:
    """Bilinear resize of the last two axes of a CHW (or HW) array to
    ``size``, as ``jax.image.resize`` computes it (module docstring)."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        out = np.asarray(img, np.float32)
        for axis, n_out in ((out.ndim - 2, self.size[0]),
                            (out.ndim - 1, self.size[1])):
            n_in = out.shape[axis]
            if n_in == n_out:
                continue
            w = resize_weights(n_in, n_out, "linear").astype(np.float32)
            out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])),
                              -1, axis)
        return np.ascontiguousarray(out)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[-2:]
        th, tw = self.size
        i, j = (h - th) // 2, (w - tw) // 2
        return arr[..., i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding:
            pad = [(0, 0)] * (arr.ndim - 2) + [(self.padding,
                                                self.padding)] * 2
            arr = np.pad(arr, pad)
        h, w = arr.shape[-2:]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return arr[..., i:i + th, j:j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[..., ::-1].copy()
        return np.asarray(img)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)
