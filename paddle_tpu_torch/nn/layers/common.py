"""Common layers (counterpart of ``paddle_tpu/nn/layers/common.py``, and
of ``Sequential`` and ``LayerList`` of ``paddle_tpu/nn/layer.py``).

``Embedding`` is Paddle's: a ``Normal(0, 1)`` table whose ``padding_idx``
rows are zeroed in the output (``F.embedding``), not torch's, which zeroes
the row's gradient instead. The older models (ERNIE, the Conformer,
Whisper) keep ``torch.nn.Embedding``.

``Linear`` stores its weight ``[in_features, out_features]``, as Paddle
does, so ``paddle.matmul(x, fc.weight) + fc.bias == fc(x)`` and its state
dict needs no transpose. The older models' projections are plain
``torch.nn.Linear``\\ s (``[out, in]``); ``Layer.state_dict`` maps them to
Paddle's layout."""
from __future__ import annotations

import torch
from torch import nn

from ...core import resolve_device
from ...framework.random import get_generator
from .. import functional as F
from ..functional.common import dropout
from ..initializer import XavierUniform
from ..layer import Layer

__all__ = ["Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Embedding", "Flatten", "Identity", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D",
           "Pad3D", "CosineSimilarity", "Bilinear", "Unfold", "Fold",
           "PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "Sequential",
           "LayerList"]


class Linear(Layer):
    """``y = x W + b``, ``W`` of ``[in_features, out_features]``, with
    Paddle's initialisers: a Xavier-uniform weight and a zero bias (none
    with ``bias_attr=False``), drawn from ``generator`` (default:
    ``framework.random``'s generator of the device). Builds on ``cuda``
    unless ``device="cpu"``. Under ``auto_cast`` it computes in the amp
    dtype (white list)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty(out_features, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Xavier-uniform drawn in ``[out, in]`` order (the values the
        port's earlier ``[out, in]`` layer drew from the same generator),
        stored transposed."""
        g = generator if generator is not None else get_generator(
            self.weight.device)
        w = torch.empty(self.out_features, self.in_features,
                        device=self.weight.device, dtype=self.weight.dtype)
        nn.init.xavier_uniform_(w, generator=g)
        torch.Tensor.copy_(self.weight, w.t())
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return torch.nn.functional.linear(x, torch.Tensor.t(self.weight),
                                          self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return dropout(x, p=self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Dropout2D(Layer):
    """Whole channels dropped (``F.dropout2d``)."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    """Whole channels of a volume dropped (``F.dropout3d``)."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    """SELU's dropout (``F.alpha_dropout``)."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training)


class Embedding(Layer):
    """Paddle's embedding table ``weight`` ``[num_embeddings,
    embedding_dim]``, drawn ``Normal(0, 1)`` from ``generator`` (default:
    ``framework.random``'s generator of the device); ids equal to
    ``padding_idx`` give zero rows. Builds on ``cuda`` unless
    ``device="cpu"``."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device),
            dtype=dtype))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        g = generator if generator is not None else get_generator(
            self.weight.device)
        self.weight.normal_(0.0, 1.0, generator=g)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return (f"{tuple(self.weight.shape)}, "
                f"padding_idx={self._padding_idx}")


class Flatten(Layer):
    """Merge the dims ``start_axis..stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    """``F.interpolate`` with its arguments fixed (the reference's
    resize, ROADMAP R17)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True``, which the reference's resize
    ignores (half-pixel centres)."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class _PadND(Layer):
    """``F.pad`` with its arguments fixed."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode = padding, mode
        self.value, self.data_format = value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadND):
    pass


class Pad2D(_PadND):
    pass


class Pad3D(_PadND):
    pass


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] + bias[0, o]``: a
    Xavier-uniform ``weight`` ``[out, in1, in2]`` (the reference's fans:
    ``in1 * in2`` in, ``out * in2`` out) and a zero ``bias`` ``[1, out]``
    (none with ``bias_attr=False``)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            out_features, in1_features, in2_features, **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(1, out_features, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        g = generator if generator is not None else get_generator(
            self.weight.device)
        XavierUniform()._fill(self.weight, g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups

    def forward(self, x):
        return F.channel_shuffle(x, self.groups)


class Sequential(Layer, nn.Sequential):
    """Paddle's ``Sequential``: layers named ``"0"``, ``"1"``, ... in order,
    or given names, as ``(name, layer)`` pairs or one list of them."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class LayerList(Layer, nn.ModuleList):
    """Paddle's ``LayerList``: ``torch.nn.ModuleList`` under its name
    (sub-layers named ``"0"``, ``"1"``, ... as in the reference)."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)
