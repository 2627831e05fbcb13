"""Vision ops (counterpart of ``paddle_tpu/vision/ops.py``): the
detection functionals of the op registry (``deform_conv2d``, ``nms``,
``roi_align``, ``roi_pool``, ``yolo_box``, ``yolo_loss``, ``prior_box``,
``box_coder``, ``matrix_nms``, ``distribute_fpn_proposals``,
``generate_proposals``), ``DeformConv2D``, and ``ConvNormActivation``,
the block the model zoo composes."""
from __future__ import annotations

import torch

from .. import nn
from ..ops.registry import OPS

__all__ = [
    "ConvNormActivation", "DeformConv2D", "deform_conv2d", "nms",
    "roi_align", "roi_pool", "yolo_box", "yolo_loss", "prior_box",
    "box_coder", "matrix_nms", "distribute_fpn_proposals",
    "generate_proposals",
]


class ConvNormActivation(nn.Sequential):
    """``Conv2D`` -> norm -> activation (``"0"``, ``"1"``, ``"2"``, as in the
    reference). ``norm_layer`` / ``activation_layer`` None skips that
    stage; the padding defaults to ``(k - 1) // 2 * dilation`` and the
    convolution has a bias only without a norm (``bias=None``). The
    convolution and the norm build on ``device`` (``cuda`` unless
    ``device="cpu"``)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, groups=1, norm_layer=nn.BatchNorm2D,
                 activation_layer=nn.ReLU, dilation=1, bias=None, *,
                 device=None, dtype=torch.float32):
        kw = dict(device=device, dtype=dtype)
        if padding is None:
            k = kernel_size if isinstance(kernel_size, int) \
                else kernel_size[0]
            padding = (k - 1) // 2 * dilation
        if bias is None:
            bias = norm_layer is None
        layers = [nn.Conv2D(in_channels, out_channels, kernel_size,
                            stride=stride, padding=padding, dilation=dilation,
                            groups=groups, bias_attr=None if bias else False,
                            **kw)]
        if norm_layer is not None:
            layers.append(norm_layer(out_channels, **kw))
        if activation_layer is not None:
            layers.append(activation_layer())
        super().__init__(*layers)


def _export(name):
    # resolved at call time: the op table finishes registering (ops.parity,
    # ops.detection) after the vision package is first imported
    def wrapper(*args, **kwargs):
        return OPS[name].fn(*args, **kwargs)

    wrapper.__name__ = name
    return wrapper


deform_conv2d = _export("deform_conv2d")
nms = _export("nms")
roi_align = _export("roi_align")
roi_pool = _export("roi_pool")
yolo_box = _export("yolo_box")
yolo_loss = _export("yolo_loss")
prior_box = _export("prior_box")
box_coder = _export("box_coder")
matrix_nms = _export("matrix_nms")
distribute_fpn_proposals = _export("distribute_fpn_proposals")
generate_proposals = _export("generate_proposals")


class DeformConv2D(nn.Layer):
    """Deformable convolution layer: ``forward(x, offset, mask=None)``
    (v1 without ``mask``, v2 with it) over ``deform_conv2d``. ``weight``
    is Paddle's ``[out, in / groups, kh, kw]`` (XavierUniform), ``bias``
    ``[out]`` (zeros; none with ``bias_attr=False``): a reference layer's
    state dict loads as it is. Builds on ``cuda`` unless
    ``device="cpu"``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None):
        super().__init__()
        k = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
             else tuple(kernel_size))
        self._cfg = dict(stride=stride, padding=padding, dilation=dilation,
                         deformable_groups=deformable_groups, groups=groups)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, k[0], k[1]],
            device=device)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], is_bias=True, device=device)

    def forward(self, x, offset, mask=None):
        return OPS["deform_conv2d"].fn(x, offset, self.weight, self.bias,
                                       mask=mask, **self._cfg)
