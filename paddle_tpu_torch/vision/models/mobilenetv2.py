"""MobileNetV2 (counterpart of ``paddle_tpu/vision/models/mobilenetv2.py``;
Sandler et al. 2018): inverted residuals (a 1x1 expansion, a 3x3
depthwise convolution, both with ReLU6, and a linear 1x1 projection with
batch norm) at widths times ``scale`` rounded by ``_make_divisible``.
Builds on ``cuda`` unless ``device="cpu"``; weights as ``resnet.py`` draws
them."""
from __future__ import annotations

import torch

from ... import nn
from ..ops import ConvNormActivation
from ._init import init_weights, layer_kw
from .resnet import _no_pretrained

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    """``v`` rounded to the nearest multiple of ``divisor`` (at least
    ``min_value``), and up by one more where rounding lost over 10 %."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(ConvNormActivation):
    def __init__(self, c_in, c_out, kernel=3, stride=1, groups=1, **kw):
        super().__init__(c_in, c_out, kernel, stride=stride, groups=groups,
                         activation_layer=nn.ReLU6, **kw)


class InvertedResidual(nn.Layer):
    def __init__(self, c_in, c_out, stride, expand_ratio, **kw):
        super().__init__()
        hidden = int(round(c_in * expand_ratio))
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(c_in, hidden, kernel=1, **kw))
        layers += [
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden, **kw),
            nn.Conv2D(hidden, c_out, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(c_out, **kw),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None,
                 seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        c_in = _make_divisible(32 * scale)
        last = _make_divisible(1280 * max(1.0, scale))
        feats = [ConvBNReLU(3, c_in, stride=2, **kw)]
        for t, c, n, s in cfg:
            c_out = _make_divisible(c * scale)
            for i in range(n):
                feats.append(InvertedResidual(c_in, c_out, s if i == 0 else 1,
                                              t, **kw))
                c_in = c_out
        feats.append(ConvBNReLU(c_in, last, kernel=1, **kw))
        self.features = nn.Sequential(*feats)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last, num_classes, **kw))
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.features(x)
        if self.with_pool:
            h = self.pool(h)
        if self.num_classes > 0:
            h = self.classifier(torch.flatten(h, 1))
        return h


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
