"""Inception v3 (counterpart of ``paddle_tpu/vision/models/inceptionv3.py``;
Szegedy et al. 2015): a stem of seven convolution-norm-ReLU blocks and two
max pools, then inception blocks A (x3), B (35 -> 17), C (x4, factorised
7x7), D (17 -> 8) and E (x2, expanded filter banks), the pool, dropout 0.2
and the classifier; 299 x 299 inputs. Every convolution is a
``ConvNormActivation`` (no bias, batch norm, ReLU); the pools' 3x3
averages exclude the padding. Builds on ``cuda`` unless ``device="cpu"``;
weights as ``resnet.py`` draws them."""
from __future__ import annotations

import torch

from ... import nn
from ..ops import ConvNormActivation
from ._init import init_weights, layer_kw
from .resnet import _no_pretrained

__all__ = ["InceptionV3", "inception_v3"]


class ConvBN(ConvNormActivation):
    def __init__(self, c_in, c_out, kernel, stride=1, padding=0, **kw):
        super().__init__(c_in, c_out, kernel, stride=stride, padding=padding,
                         **kw)


def _cat(xs):
    return torch.cat(xs, 1)


class InceptionA(nn.Layer):
    def __init__(self, c_in, pool_features, **kw):
        super().__init__()
        self.b1 = ConvBN(c_in, 64, 1, **kw)
        self.b2 = nn.Sequential(ConvBN(c_in, 48, 1, **kw),
                                ConvBN(48, 64, 5, padding=2, **kw))
        self.b3 = nn.Sequential(ConvBN(c_in, 64, 1, **kw),
                                ConvBN(64, 96, 3, padding=1, **kw),
                                ConvBN(96, 96, 3, padding=1, **kw))
        self.b4 = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                ConvBN(c_in, pool_features, 1, **kw))

    def forward(self, x):
        return _cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)])


class InceptionB(nn.Layer):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, c_in, **kw):
        super().__init__()
        self.b1 = ConvBN(c_in, 384, 3, stride=2, **kw)
        self.b2 = nn.Sequential(ConvBN(c_in, 64, 1, **kw),
                                ConvBN(64, 96, 3, padding=1, **kw),
                                ConvBN(96, 96, 3, stride=2, **kw))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.b1(x), self.b2(x), self.pool(x)])


class InceptionC(nn.Layer):
    """Factorised 7x7 branches."""

    def __init__(self, c_in, c7, **kw):
        super().__init__()
        self.b1 = ConvBN(c_in, 192, 1, **kw)
        self.b2 = nn.Sequential(
            ConvBN(c_in, c7, 1, **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, 192, (7, 1), padding=(3, 0), **kw))
        self.b3 = nn.Sequential(
            ConvBN(c_in, c7, 1, **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, 192, (1, 7), padding=(0, 3), **kw))
        self.b4 = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                ConvBN(c_in, 192, 1, **kw))

    def forward(self, x):
        return _cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)])


class InceptionD(nn.Layer):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, c_in, **kw):
        super().__init__()
        self.b1 = nn.Sequential(ConvBN(c_in, 192, 1, **kw),
                                ConvBN(192, 320, 3, stride=2, **kw))
        self.b2 = nn.Sequential(
            ConvBN(c_in, 192, 1, **kw),
            ConvBN(192, 192, (1, 7), padding=(0, 3), **kw),
            ConvBN(192, 192, (7, 1), padding=(3, 0), **kw),
            ConvBN(192, 192, 3, stride=2, **kw))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.b1(x), self.b2(x), self.pool(x)])


class InceptionE(nn.Layer):
    """Expanded filter banks."""

    def __init__(self, c_in, **kw):
        super().__init__()
        self.b1 = ConvBN(c_in, 320, 1, **kw)
        self.b2_stem = ConvBN(c_in, 384, 1, **kw)
        self.b2_a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b2_b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.b3_stem = nn.Sequential(ConvBN(c_in, 448, 1, **kw),
                                     ConvBN(448, 384, 3, padding=1, **kw))
        self.b3_a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3_b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.b4 = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                ConvBN(c_in, 192, 1, **kw))

    def forward(self, x):
        h2, h3 = self.b2_stem(x), self.b3_stem(x)
        return _cat([self.b1(x), _cat([self.b2_a(h2), self.b2_b(h2)]),
                     _cat([self.b3_a(h3), self.b3_b(h3)]), self.b4(x)])


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype=torch.float32, generator=None, seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            ConvBN(3, 32, 3, stride=2, **kw), ConvBN(32, 32, 3, **kw),
            ConvBN(32, 64, 3, padding=1, **kw), nn.MaxPool2D(3, stride=2),
            ConvBN(64, 80, 1, **kw), ConvBN(80, 192, 3, **kw),
            nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
            InceptionA(288, 64, **kw), InceptionB(288, **kw),
            InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
            InceptionC(768, 160, **kw), InceptionC(768, 192, **kw),
            InceptionD(768, **kw), InceptionE(1280, **kw),
            InceptionE(2048, **kw))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.drop = nn.Dropout(0.2)
            self.fc = nn.Linear(2048, num_classes, **kw)
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.blocks(self.stem(x))
        if self.with_pool:
            h = self.pool(h)
        if self.num_classes > 0:
            h = self.fc(self.drop(torch.flatten(h, 1)))
        return h


def inception_v3(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return InceptionV3(**kwargs)
