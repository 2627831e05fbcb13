"""ResNet (counterpart of ``paddle_tpu/vision/models/resnet.py``;
``BASELINE.md`` config #2, ResNet-50 on ImageNet; He et al. 2016).

NCHW throughout, as the reference: a 7x7 stride-2 stem with batch norm,
ReLU and a 3x3 stride-2 max pool, four stages of basic (ResNet-18/34) or
bottleneck (ResNet-50/101/152) blocks, an adaptive average pool to 1x1
and a linear classifier. The attribute names are the reference's, so a
state dict (its 2 x 53 batch-norm buffers included, for ResNet-50)
converts key for key (``models/convert.py`` ``vision_state_from_jax``).

Convolutions and the linear layer are PyTorch library calls (cuDNN and
cuBLAS on the card), as the reference leaves them to XLA; under
``amp.auto_cast`` O1 they compute in bf16, batch norm in f32 (amp's black
list), and the loss, ``F.cross_entropy``, runs the softmax-CE kernels.

Every entry point builds on ``cuda`` unless ``device="cpu"``, with
weights drawn from ``generator`` (or a fresh one seeded with ``seed``;
default ``framework.random``'s generator of the device) by Paddle's
initialisers.
"""
from __future__ import annotations

import torch

from ... import nn
from ._init import init_weights, layer_kw

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnet_flops_per_image"]


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=None, **kw):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, **kw)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               **kw)
        self.bn2 = norm_layer(planes, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=None, **kw):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, **kw)
        self.conv2 = nn.Conv2D(planes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **kw)
        self.bn2 = norm_layer(planes, **kw)
        self.conv3 = nn.Conv2D(planes, planes * self.expansion, 1,
                               bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **kw)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """``[N, 3, H, W]`` images to ``[N, num_classes]`` logits (the pooled
    ``[N, C, 1, 1]`` features with ``num_classes <= 0``). ``width`` is
    accepted and unused, as in the reference."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, *, device=None, dtype=torch.float32,
                 generator=None, seed=None):
        super().__init__()
        kw = layer_kw(device, dtype)
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(self.inplanes, **kw)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, kw)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, kw)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, kw)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, kw)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, **kw)
        init_weights(self, generator, seed)

    def _make_layer(self, block, planes, blocks, stride, kw):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, **kw),
                nn.BatchNorm2D(planes * block.expansion, **kw))
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return nn.Sequential(*layers)

    @property
    def device(self) -> torch.device:
        return self.conv1.weight.device

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _no_pretrained(pretrained):
    if pretrained:
        raise ValueError("pretrained weights need a download, which this "
                         "package does not do; load a state dict instead")


def resnet18(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ResNet(BottleneckBlock, 152, **kwargs)


@torch.no_grad()
def resnet_flops_per_image(model, image_size=224, in_channels=3):
    """Forward flops of one image (2 x the multiply-adds of every
    convolution and linear layer, from the shapes one eval forward of a
    single image gives them; about 4.1 G multiply-adds for ResNet-50 at
    224). A training step costs about 3x the forward. Any model of the zoo
    counts the same way."""
    macs = []

    def hook(m, inp, out):
        w = m.weight
        if w.ndim > 2:                  # [out, in / groups, kh, kw]
            macs.append(out[0].numel() * w[0].numel())
        else:                           # [in, out] (torch's: [out, in])
            n_in = w.shape[0] if isinstance(m, nn.Linear) else w.shape[1]
            macs.append(out.shape[-1] * n_in)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2D, nn.Linear, torch.nn.Linear))]
    was_training = model.training
    try:
        model.eval()
        p = next(model.parameters())
        model(torch.zeros(1, in_channels, image_size, image_size,
                          device=p.device, dtype=p.dtype))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return 2 * sum(macs)
