"""DenseNet (counterpart of ``paddle_tpu/vision/models/densenet.py``; Huang
et al. 2017: each layer of a dense block takes every earlier feature map
of the block, concatenated on the channels).

Written as the reference is, in Paddle's dygraph idiom: ``nn.Layer``
subclasses over the port's layers, ``paddle.concat`` and
``paddle.flatten`` from the op library. A Tensor in gives Tensors out
(the ops' and ``Layer.__call__``'s rule); plain tensors run the same ops.
The attribute names are the reference's, so its state dict (batch-norm
buffers included) loads through ``set_state_dict`` as it is.
``densenet121`` at 224 x 224: 7.98 M parameters, growth 32, blocks 6 /
12 / 24 / 16, 2.83 G multiply-adds a forward (``densenet_flops_per_image``
counts them). Every entry point builds on ``cuda`` unless ``device="cpu"``
(or ``set_device("cpu")``), with weights drawn from ``generator`` (or a
fresh one seeded with ``seed``; default ``framework.random``'s generator
of the device) by Paddle's initialisers.
"""
from __future__ import annotations

import torch

from ... import nn, ops
from ._init import init_weights, layer_kw
from .resnet import _no_pretrained, resnet_flops_per_image

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet_flops_per_image"]

_CFGS = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
}


class _DenseLayer(nn.Layer):
    def __init__(self, c_in, growth, bn_size=4, dropout=0.0, kw=None):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(c_in, **kw)
        self.conv1 = nn.Conv2D(c_in, bn_size * growth, 1, bias_attr=False,
                               **kw)
        self.norm2 = nn.BatchNorm2D(bn_size * growth, **kw)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False, **kw)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x):
        h = self.conv1(self.relu(self.norm1(x)))
        h = self.conv2(self.relu(self.norm2(h)))
        if self.dropout is not None:
            h = self.dropout(h)
        return ops.concat([x, h], axis=1)


class _Transition(nn.Layer):
    def __init__(self, c_in, c_out, kw):
        super().__init__()
        self.norm = nn.BatchNorm2D(c_in, **kw)
        self.conv = nn.Conv2D(c_in, c_out, 1, bias_attr=False, **kw)
        self.pool = nn.AvgPool2D(2, stride=2)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


class DenseNet(nn.Layer):
    """``[N, 3, H, W]`` images to ``[N, num_classes]`` logits (the pooled
    features with ``num_classes <= 0``)."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, *, device=None, dtype=torch.float32,
                 generator=None, seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        init_c, growth, blocks = _CFGS[layers]
        feats = [nn.Conv2D(3, init_c, 7, stride=2, padding=3,
                           bias_attr=False, **kw),
                 nn.BatchNorm2D(init_c, **kw), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        c = init_c
        for bi, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size, dropout, kw))
                c += growth
            if bi != len(blocks) - 1:
                feats.append(_Transition(c, c // 2, kw))
                c //= 2
        feats += [nn.BatchNorm2D(c, **kw), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(c, num_classes, **kw)
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.features(x)
        if self.with_pool:
            h = self.pool(h)
        if self.num_classes > 0:
            h = self.classifier(ops.flatten(h, start_axis=1))
        return h


def densenet121(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return DenseNet(121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return DenseNet(161, **kwargs)


def densenet169(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return DenseNet(169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return DenseNet(201, **kwargs)


def densenet_flops_per_image(model, image_size=224):
    """Forward flops of one image: 2 x the multiply-adds of every
    convolution and the classifier (``resnet_flops_per_image``'s count);
    a training step costs about 3x the forward."""
    return resnet_flops_per_image(model, image_size)
