"""GoogLeNet / Inception v1 (counterpart of
``paddle_tpu/vision/models/googlenet.py``; Szegedy et al. 2014): a stem,
nine inception modules (four branches concatenated on the channels:
1x1, 1x1 -> 3x3, 1x1 -> 5x5, 3x3 max pool -> 1x1, each convolution with
a bias and ReLU, no norm), ceil-mode max pools, the pool, dropout 0.4 and
the classifier. ``forward`` returns ``(out, aux1, aux2)``, as the
reference's: two auxiliary heads (5x5 / 3 average pool, 1x1 to 128, fc1
to 1024, ReLU, dropout 0.7, fc2 to the classes) after stages 4a and 4d
feed the auxiliary losses in training. Their ``fc1`` takes ``128 x 4 x
4`` features, so the input must be 224 x 224. Builds on ``cuda`` unless
``device="cpu"``; weights as ``resnet.py`` draws them."""
from __future__ import annotations

import torch

from ... import nn
from ._init import init_weights, layer_kw
from .resnet import _no_pretrained

__all__ = ["GoogLeNet", "googlenet"]


class ConvReLU(nn.Sequential):
    def __init__(self, c_in, c_out, kernel, stride=1, padding=0, **kw):
        super().__init__(nn.Conv2D(c_in, c_out, kernel, stride=stride,
                                   padding=padding, **kw),
                         nn.ReLU())


class Inception(nn.Layer):
    """Four parallel branches concatenated on the channels."""

    def __init__(self, c_in, c1, c3r, c3, c5r, c5, proj, **kw):
        super().__init__()
        self.b1 = ConvReLU(c_in, c1, 1, **kw)
        self.b2 = nn.Sequential(ConvReLU(c_in, c3r, 1, **kw),
                                ConvReLU(c3r, c3, 3, padding=1, **kw))
        self.b3 = nn.Sequential(ConvReLU(c_in, c5r, 1, **kw),
                                ConvReLU(c5r, c5, 5, padding=2, **kw))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                ConvReLU(c_in, proj, 1, **kw))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)], 1)


class _AuxHead(nn.Layer):
    def __init__(self, c_in, num_classes, **kw):
        super().__init__()
        self.pool = nn.AvgPool2D(5, stride=3)
        self.conv = ConvReLU(c_in, 128, 1, **kw)
        self.fc1 = nn.Linear(128 * 4 * 4, 1024, **kw)
        self.relu = nn.ReLU()
        self.drop = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        h = self.conv(self.pool(x))
        h = self.relu(self.fc1(torch.flatten(h, 1)))
        return self.fc2(self.drop(h))


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype=torch.float32, generator=None, seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)

        def inc(*a):
            return Inception(*a, **kw)

        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            ConvReLU(3, 64, 7, stride=2, padding=3, **kw),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
            ConvReLU(64, 64, 1, **kw),
            ConvReLU(64, 192, 3, padding=1, **kw),
            nn.MaxPool2D(3, stride=2, ceil_mode=True))
        self.inc3a = inc(192, 64, 96, 128, 16, 32, 32)
        self.inc3b = inc(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.inc4a = inc(480, 192, 96, 208, 16, 48, 64)
        self.inc4b = inc(512, 160, 112, 224, 24, 64, 64)
        self.inc4c = inc(512, 128, 128, 256, 24, 64, 64)
        self.inc4d = inc(512, 112, 144, 288, 32, 64, 64)
        self.inc4e = inc(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.inc5a = inc(832, 256, 160, 320, 32, 128, 128)
        self.inc5b = inc(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.drop = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes, **kw)
            self.aux1 = _AuxHead(512, num_classes, **kw)
            self.aux2 = _AuxHead(528, num_classes, **kw)
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.stem(x)
        h = self.pool3(self.inc3b(self.inc3a(h)))
        h = self.inc4a(h)
        aux1 = self.aux1(h) if self.num_classes > 0 else None
        h = self.inc4d(self.inc4c(self.inc4b(h)))
        aux2 = self.aux2(h) if self.num_classes > 0 else None
        h = self.inc5b(self.inc5a(self.pool4(self.inc4e(h))))
        if self.with_pool:
            h = self.pool5(h)
        if self.num_classes > 0:
            h = self.fc(self.drop(torch.flatten(h, 1)))
        return h, aux1, aux2


def googlenet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
