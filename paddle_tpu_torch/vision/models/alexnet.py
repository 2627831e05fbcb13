"""AlexNet (counterpart of ``paddle_tpu/vision/models/alexnet.py``;
Krizhevsky et al. 2012): five convolutions with ReLU and three max pools,
an adaptive average pool to 6x6 and a dropout / linear classifier. Builds
on ``cuda`` unless ``device="cpu"``; weights as ``resnet.py`` draws
them."""
from __future__ import annotations

import torch

from ... import nn
from ._init import init_weights, layer_kw
from .resnet import _no_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(torch.nn.Module):
    def __init__(self, num_classes=1000, dropout=0.5, *, device=None,
                 dtype=torch.float32, generator=None, seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2, **kw), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(64, 192, 5, padding=2, **kw), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(192, 384, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(3, stride=2))
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        self.num_classes = num_classes
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(dropout), nn.Linear(256 * 36, 4096, **kw),
                nn.ReLU(), nn.Dropout(dropout), nn.Linear(4096, 4096, **kw),
                nn.ReLU(), nn.Linear(4096, num_classes, **kw))
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.avgpool(self.features(x))
        if self.num_classes > 0:
            h = self.classifier(torch.flatten(h, 1))
        return h


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)
