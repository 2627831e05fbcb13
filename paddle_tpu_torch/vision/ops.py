"""Vision ops (counterpart of ``paddle_tpu/vision/ops.py``; ports
``ConvNormActivation``, the block the model zoo composes)."""
from __future__ import annotations

import torch

from .. import nn

__all__ = ["ConvNormActivation"]


class ConvNormActivation(nn.Sequential):
    """``Conv2D`` -> norm -> activation (``"0"``, ``"1"``, ``"2"``, as in the
    reference). ``norm_layer`` / ``activation_layer`` None skips that
    stage; the padding defaults to ``(k - 1) // 2 * dilation`` and the
    convolution has a bias only without a norm (``bias=None``). The
    convolution and the norm build on ``device`` (``cuda`` unless
    ``device="cpu"``)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, groups=1, norm_layer=nn.BatchNorm2D,
                 activation_layer=nn.ReLU, dilation=1, bias=None, *,
                 device=None, dtype=torch.float32):
        kw = dict(device=device, dtype=dtype)
        if padding is None:
            k = kernel_size if isinstance(kernel_size, int) \
                else kernel_size[0]
            padding = (k - 1) // 2 * dilation
        if bias is None:
            bias = norm_layer is None
        layers = [nn.Conv2D(in_channels, out_channels, kernel_size,
                            stride=stride, padding=padding, dilation=dilation,
                            groups=groups, bias_attr=None if bias else False,
                            **kw)]
        if norm_layer is not None:
            layers.append(norm_layer(out_channels, **kw))
        if activation_layer is not None:
            layers.append(activation_layer())
        super().__init__(*layers)
