"""VGG (counterpart of ``paddle_tpu/vision/models/vgg.py``; Simonyan and
Zisserman 2014): configurations A/B/D/E (VGG-11/13/16/19) of 3x3
convolutions (optionally with batch norm) and 2x2 max pools, an adaptive
average pool to 7x7 and a linear / dropout classifier. Builds on ``cuda``
unless ``device="cpu"``; weights as ``resnet.py`` draws them."""
from __future__ import annotations

import torch

from ... import nn
from ._init import init_weights, layer_kw
from .resnet import _no_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm, kw):
    layers = []
    c_in = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, stride=2))
            continue
        layers.append(nn.Conv2D(c_in, v, 3, padding=1, **kw))
        if batch_norm:
            layers.append(nn.BatchNorm2D(v, **kw))
        layers.append(nn.ReLU())
        c_in = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """``features`` (a ``Sequential``, on the model's device), then the
    pool and the classifier."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 dtype=torch.float32, generator=None, seed=None):
        super().__init__()
        kw = dict(device=next(features.parameters()).device, dtype=dtype)
        self.features = features
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 49, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes, **kw))
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.features(x)
        if self.with_pool:
            h = self.avgpool(h)
        if self.num_classes > 0:
            h = self.classifier(torch.flatten(h, 1))
        return h


def _vgg(cfg, pretrained, batch_norm, device=None, dtype=torch.float32,
         **kwargs):
    _no_pretrained(pretrained)
    features = _make_features(_CFGS[cfg], batch_norm,
                              layer_kw(device, dtype))
    return VGG(features, dtype=dtype, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", pretrained, batch_norm, **kwargs)
