"""MobileNetV1 (counterpart of ``paddle_tpu/vision/models/mobilenetv1.py``;
Howard et al. 2017): depthwise-separable blocks (a 3x3 depthwise
``ConvNormActivation``, ``groups`` = channels, then a 1x1 one) at widths
times ``scale`` (at least 8). Builds on ``cuda`` unless ``device="cpu"``;
weights as ``resnet.py`` draws them."""
from __future__ import annotations

import torch

from ... import nn
from ..ops import ConvNormActivation
from ._init import init_weights, layer_kw
from .resnet import _no_pretrained

__all__ = ["MobileNetV1", "mobilenet_v1"]


class ConvBNReLU(ConvNormActivation):
    def __init__(self, c_in, c_out, kernel=3, stride=1, groups=1, **kw):
        super().__init__(c_in, c_out, kernel, stride=stride, groups=groups,
                         **kw)


class DepthwiseSeparable(torch.nn.Module):
    def __init__(self, c_in, c_out, stride, **kw):
        super().__init__()
        self.dw = ConvBNReLU(c_in, c_in, 3, stride=stride, groups=c_in, **kw)
        self.pw = ConvBNReLU(c_in, c_out, 1, **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None,
                 seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [  # (c_in, c_out, stride)
            (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
            (256, 256, 1), (256, 512, 2),
            (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
            (512, 512, 1), (512, 1024, 2), (1024, 1024, 1),
        ]
        feats = [ConvBNReLU(3, c(32), stride=2, **kw)]
        feats += [DepthwiseSeparable(c(a), c(b), s, **kw) for a, b, s in cfg]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes, **kw)
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.features(x)
        if self.with_pool:
            h = self.pool(h)
        if self.num_classes > 0:
            h = self.fc(torch.flatten(h, 1))
        return h


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
