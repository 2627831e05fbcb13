"""Common layers (counterpart of ``paddle_tpu/nn/layers/common.py``; this
slice ports ``Dropout``). ``Linear`` and ``Embedding`` are ``torch.nn``'s:
a Paddle ``Linear`` stores its weight ``[in, out]``, ``nn.Linear``
``[out, in]``, and ``models/convert.py`` transposes."""
from __future__ import annotations

from torch import nn

from ..functional.common import dropout

__all__ = ["Dropout"]


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return dropout(x, p=self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"
