"""MobileNetV3 Small and Large (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``; Howard et al. 2019): inverted
residuals with optional squeeze-excitation (an average pool, two 1x1
convolutions, ReLU and hard sigmoid) and ReLU or hard-swish activations,
widths times ``scale`` rounded by ``_make_divisible``. Builds on ``cuda``
unless ``device="cpu"``; weights as ``resnet.py`` draws them."""
from __future__ import annotations

import torch

from ... import nn
from ..ops import ConvNormActivation
from ._init import init_weights, layer_kw
from .mobilenetv2 import _make_divisible
from .resnet import _no_pretrained

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


class ConvBNAct(ConvNormActivation):
    def __init__(self, c_in, c_out, kernel=3, stride=1, groups=1, act="HS",
                 **kw):
        super().__init__(
            c_in, c_out, kernel, stride=stride, groups=groups,
            activation_layer={"HS": nn.Hardswish, "RE": nn.ReLU,
                              None: None}[act], **kw)


class SqueezeExcitation(nn.Layer):
    def __init__(self, channels, squeeze_ratio=4, **kw):
        super().__init__()
        squeeze = _make_divisible(channels // squeeze_ratio)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(channels, squeeze, 1, **kw)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze, channels, 1, **kw)
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class Bneck(nn.Layer):
    """Inverted residual with optional SE, per (k, exp, out, se, act, s)."""

    def __init__(self, c_in, kernel, exp, c_out, use_se, act, stride, **kw):
        super().__init__()
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if exp != c_in:
            layers.append(ConvBNAct(c_in, exp, 1, act=act, **kw))
        layers.append(ConvBNAct(exp, exp, kernel, stride=stride, groups=exp,
                                act=act, **kw))
        if use_se:
            layers.append(SqueezeExcitation(exp, **kw))
        layers.append(ConvBNAct(exp, c_out, 1, act=None, **kw))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, hidden, scale=1.0, num_classes=1000,
                 with_pool=True, *, device=None, dtype=torch.float32,
                 generator=None, seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return _make_divisible(ch * scale)

        c_in = c(16)
        feats = [ConvBNAct(3, c_in, 3, stride=2, act="HS", **kw)]
        for k, exp, out, se, act, s in cfg:
            feats.append(Bneck(c_in, k, c(exp), c(out), se, act, s, **kw))
            c_in = c(out)
        last = c(last_exp)
        feats.append(ConvBNAct(c_in, last, 1, act="HS", **kw))
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last, hidden, **kw), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(hidden, num_classes, **kw))
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.features(x)
        if self.with_pool:
            h = self.pool(h)
        if self.num_classes > 0:
            h = self.classifier(torch.flatten(h, 1))
        return h


_SMALL = [  # kernel, expansion, out, SE, activation, stride
    (3, 16, 16, True, "RE", 2), (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1), (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1), (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1), (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2), (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
]
_LARGE = [
    (3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1), (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
]


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_SMALL, 576, 1024, scale, num_classes, with_pool,
                         **kw)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_LARGE, 960, 1280, scale, num_classes, with_pool,
                         **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
