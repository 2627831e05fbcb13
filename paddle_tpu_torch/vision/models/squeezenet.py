"""SqueezeNet (counterpart of ``paddle_tpu/vision/models/squeezenet.py``;
Iandola et al. 2016): fire modules (a 1x1 squeeze, then 1x1 and 3x3
expands concatenated, each with ReLU), versions 1.0 and 1.1, and a
convolutional classifier (dropout 0.5, a 1x1 convolution to the classes,
ReLU) before the pool. The convolutions carry biases and no norm. Builds
on ``cuda`` unless ``device="cpu"``; weights as ``resnet.py`` draws
them."""
from __future__ import annotations

import torch

from ... import nn
from ._init import init_weights, layer_kw
from .resnet import _no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(nn.Layer):
    def __init__(self, c_in, squeeze, e1, e3, **kw):
        super().__init__()
        self.squeeze = nn.Conv2D(c_in, squeeze, 1, **kw)
        self.expand1 = nn.Conv2D(squeeze, e1, 1, **kw)
        self.expand3 = nn.Conv2D(squeeze, e3, 3, padding=1, **kw)
        self.relu = nn.ReLU()

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1(s)),
                          self.relu(self.expand3(s))], 1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, generator=None,
                 seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)

        def fire(*a):
            return _Fire(*a, **kw)

        if version == "1.0":
            feats = [
                nn.Conv2D(3, 96, 7, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                fire(128, 32, 128, 128), nn.MaxPool2D(3, stride=2),
                fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                fire(384, 48, 192, 192), fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2), fire(512, 64, 256, 256),
            ]
        else:   # 1.1
            feats = [
                nn.Conv2D(3, 64, 3, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                fire(64, 16, 64, 64), fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2),
                fire(128, 32, 128, 128), fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                fire(384, 64, 256, 256), fire(512, 64, 256, 256),
            ]
        self.features = nn.Sequential(*feats)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1, **kw),
                nn.ReLU())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.features(x)
        if self.num_classes > 0:
            h = self.classifier(h)
        if self.with_pool:
            h = self.pool(h)
        return torch.flatten(h, 1)


def squeezenet1_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
