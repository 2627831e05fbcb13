"""LeNet (counterpart of ``paddle_tpu/vision/models/lenet.py``;
``BASELINE.md`` config #1's network): two conv + ReLU + max-pool stages on
``[N, 1, 28, 28]`` and three linear layers. Builds on ``cuda`` unless
``device="cpu"``; weights as ``resnet.py`` draws them."""
from __future__ import annotations

import torch

from ... import nn
from ._init import init_weights, layer_kw

__all__ = ["LeNet"]


class LeNet(nn.Layer):
    def __init__(self, num_classes=10, *, device=None, dtype=torch.float32,
                 generator=None, seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, **kw), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Flatten(), nn.Linear(400, 120, **kw),
                nn.Linear(120, 84, **kw), nn.Linear(84, num_classes, **kw))
        init_weights(self, generator, seed)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x)
        return x
