"""ShuffleNetV2 (counterpart of ``paddle_tpu/vision/models/shufflenetv2.py``;
Ma et al. 2018): a stride-2 stem convolution and max pool, three stages of
shuffle units (4 / 8 / 4), a 1x1 head convolution, the pool and the
classifier. A stride-1 unit splits the channels in two, transforms the
right half (1x1, 3x3 depthwise without activation, 1x1) and shuffles the
concatenation in two groups (``F.channel_shuffle``); a downsampling unit
runs both branches at stride 2 and doubles the channels. Stage widths by
``scale`` 0.25 / 0.33 / 0.5 / 1.0 / 1.5 / 2.0; the activation ReLU or
Swish (``shufflenet_v2_swish``). ``shufflenet_v2_x1_0`` at 224 x 224:
2.28 M parameters, about 0.15 G multiply-adds a forward
(``shufflenet_flops_per_image`` counts them). Builds on ``cuda`` unless
``device="cpu"``; weights as ``resnet.py`` draws them, and the attribute
names are the reference's, so its state dict (batch-norm buffers
included) loads as it is."""
from __future__ import annotations

import torch

from ... import nn
from ...nn import functional as F
from ..ops import ConvNormActivation
from ._init import init_weights, layer_kw
from .resnet import _no_pretrained, resnet_flops_per_image

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish",
           "shufflenet_flops_per_image"]

_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512],
    0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024],
    1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024],
    2.0: [24, 244, 488, 976, 2048],
}
_REPEATS = [4, 8, 4]
_ACTS = {"relu": nn.ReLU, "swish": nn.Swish, None: None}


class ConvBNAct(ConvNormActivation):
    def __init__(self, c_in, c_out, kernel, stride=1, groups=1, act="relu",
                 **kw):
        super().__init__(c_in, c_out, kernel, stride=stride, groups=groups,
                         activation_layer=_ACTS[act], **kw)


class ShuffleUnit(nn.Layer):
    """Stride-1 unit: split the channels, transform the right half,
    concatenate, shuffle."""

    def __init__(self, channels, act, **kw):
        super().__init__()
        c = channels // 2
        self.branch = nn.Sequential(
            ConvBNAct(c, c, 1, act=act, **kw),
            ConvBNAct(c, c, 3, groups=c, act=None, **kw),
            ConvBNAct(c, c, 1, act=act, **kw))

    def forward(self, x):
        left, right = x.chunk(2, dim=1)
        return F.channel_shuffle(torch.cat([left, self.branch(right)], 1), 2)


class ShuffleUnitDS(nn.Layer):
    """Downsampling unit: both branches at stride 2, the channels
    doubled."""

    def __init__(self, c_in, c_out, act, **kw):
        super().__init__()
        c = c_out // 2
        self.left = nn.Sequential(
            ConvBNAct(c_in, c_in, 3, stride=2, groups=c_in, act=None, **kw),
            ConvBNAct(c_in, c, 1, act=act, **kw))
        self.right = nn.Sequential(
            ConvBNAct(c_in, c, 1, act=act, **kw),
            ConvBNAct(c, c, 3, stride=2, groups=c, act=None, **kw),
            ConvBNAct(c, c, 1, act=act, **kw))

    def forward(self, x):
        return F.channel_shuffle(torch.cat([self.left(x), self.right(x)], 1),
                                 2)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, device=None, dtype=torch.float32,
                 generator=None, seed=None):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"scale must be one of {sorted(_STAGE_OUT)}")
        kw = layer_kw(device, dtype)
        chans = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            ConvBNAct(3, chans[0], 3, stride=2, act=act, **kw),
            nn.MaxPool2D(3, stride=2, padding=1))
        stages = []
        c_in = chans[0]
        for i, reps in enumerate(_REPEATS):
            c_out = chans[i + 1]
            stages.append(ShuffleUnitDS(c_in, c_out, act, **kw))
            stages += [ShuffleUnit(c_out, act, **kw) for _ in range(reps - 1)]
            c_in = c_out
        self.stages = nn.Sequential(*stages)
        self.head = ConvBNAct(c_in, chans[-1], 1, act=act, **kw)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(chans[-1], num_classes, **kw)
        init_weights(self, generator, seed)

    def forward(self, x):
        h = self.head(self.stages(self.stem(x)))
        if self.with_pool:
            h = self.pool(h)
        if self.num_classes > 0:
            h = self.fc(torch.flatten(h, 1))
        return h


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ShuffleNetV2(scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ShuffleNetV2(scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ShuffleNetV2(scale=1.0, act="swish", **kwargs)


def shufflenet_flops_per_image(model, image_size=224):
    """Forward flops of one image: 2 x the multiply-adds of every
    convolution (the depthwise ones at one input channel an output) and
    the classifier, from the shapes one eval forward gives them
    (``resnet_flops_per_image``'s count; about 0.15 G multiply-adds for
    ``shufflenet_v2_x1_0`` at 224). A training step costs about 3x the
    forward."""
    return resnet_flops_per_image(model, image_size)
