"""Common layers (counterpart of ``paddle_tpu/nn/layers/common.py``; ports
``Dropout``, and ``LayerList`` of ``paddle_tpu/nn/layer.py``). ``Linear`` and ``Embedding`` are ``torch.nn``'s:
a Paddle ``Linear`` stores its weight ``[in, out]``, ``nn.Linear``
``[out, in]``, and ``models/convert.py`` transposes."""
from __future__ import annotations

from torch import nn

from ..functional.common import dropout

__all__ = ["Dropout", "LayerList"]


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return dropout(x, p=self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class LayerList(nn.ModuleList):
    """Paddle's ``LayerList``: ``torch.nn.ModuleList`` under its name
    (sub-layers named ``"0"``, ``"1"``, ... as in the reference)."""
