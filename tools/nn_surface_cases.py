"""Seeded cases of the ``nn`` surface that the port took from the reference
in its last ``nn`` slice: the 36 functionals and 44 layers of
:data:`FUNCTIONALS` and :data:`LAYERS`. ``chip_smoke.py``'s ``[nn
surface]`` phase and ``tests/test_torch_cuda.py`` run each case on the
card and on the CPU (:func:`run`) and hold the two to each other; the
CPU tests run every case once on the CPU. It imports neither JAX nor
``paddle_tpu``.

A case is ``(name, kind, target, args, kwargs)``: ``kind`` ``"F"`` calls
``nn.functional.<target>(*args, **kwargs)``; ``"L"`` builds
``nn.<target>(*args, **kwargs)`` on the CPU from a seeded generator
(``device="cpu"`` where the layer takes one), copies it to the device
and calls it on the case's ``inputs`` (kwargs key). Arrays are float32
(the differentiable inputs) or int64; a case's forward runs in eval, so
the dropouts pass their input through (their masks come from each
device's own generator), but ``SyncBatchNorm`` runs in training with its
batch statistics. ``SpectralNorm`` is not a case: it raises on
construction, in the reference too.
"""
from __future__ import annotations

import copy

import numpy as np

__all__ = ["FUNCTIONALS", "LAYERS", "cases", "run"]

FUNCTIONALS = (
    "alpha_dropout", "bilinear", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "channel_shuffle",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "cosine_embedding_loss", "cosine_similarity", "dice_loss", "dropout2d",
    "dropout3d", "fold", "hinge_embedding_loss", "interpolate", "kl_div",
    "l1_loss", "label_smooth", "linear", "local_response_norm", "log_loss",
    "margin_ranking_loss", "mse_loss", "nll_loss", "normalize", "pad",
    "pixel_shuffle", "pixel_unshuffle", "sigmoid_focal_loss",
    "smooth_l1_loss", "softmax_with_cross_entropy", "square_error_cost",
    "triplet_margin_loss", "unfold", "upsample")
LAYERS = (
    "AlphaDropout", "BCELoss", "BCEWithLogitsLoss", "Bilinear",
    "ChannelShuffle", "Conv1DTranspose", "Conv2DTranspose", "Conv3D",
    "Conv3DTranspose", "CosineEmbeddingLoss", "CosineSimilarity",
    "Dropout2D", "Dropout3D", "Embedding", "Fold", "GRU", "GRUCell",
    "GroupNorm", "HingeEmbeddingLoss", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "KLDivLoss", "L1Loss", "LocalResponseNorm", "MSELoss",
    "MarginRankingLoss", "NLLLoss", "Pad1D", "Pad2D", "Pad3D",
    "PixelShuffle", "PixelUnshuffle", "RNNCellBase", "SimpleRNN",
    "SimpleRNNCell", "SmoothL1Loss", "SpectralNorm", "SyncBatchNorm",
    "TripletMarginLoss", "Unfold", "Upsample", "UpsamplingBilinear2D",
    "UpsamplingNearest2D")
# layers that take device= (the rest hold no parameter)
_PLACED = {"Bilinear", "Conv1DTranspose", "Conv2DTranspose", "Conv3D",
           "Conv3DTranspose", "Embedding", "GRU", "GRUCell", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "SimpleRNN", "SimpleRNNCell", "SyncBatchNorm"}


def cases():
    """Every case, in a fixed order, from one seeded generator."""
    rs = np.random.RandomState(17)

    def f(*shape):
        return rs.randn(*shape).astype(np.float32)

    def prob(*shape):
        return (1 / (1 + np.exp(-f(*shape)))).astype(np.float32)

    def logp(*shape, axis=-1):
        z = f(*shape)
        z = z - z.max(axis, keepdims=True)
        return (z - np.log(np.exp(z).sum(axis, keepdims=True))).astype(
            np.float32)

    def sign(n):
        return np.where(rs.rand(n) > 0.5, 1.0, -1.0).astype(np.float32)

    def ints(hi, *shape):
        return rs.randint(0, hi, shape).astype(np.int64)

    F = "F"
    L = "L"
    out = [
        (F, "linear", [f(3, 4), f(4, 5), f(5)], {}),
        (F, "dropout2d", [f(2, 4, 3, 3)], dict(p=0.3, training=False)),
        (F, "dropout3d", [f(2, 4, 2, 3, 3)], dict(p=0.3, training=False)),
        (F, "alpha_dropout", [f(4, 6)], dict(p=0.3, training=False)),
        (F, "normalize", [f(3, 5, 2)], {}),
        (F, "cosine_similarity", [f(4, 6), f(4, 6)], {}),
        (F, "pixel_shuffle", [f(2, 8, 3, 3), 2], {}),
        (F, "pixel_unshuffle", [f(2, 2, 6, 4), 2], {}),
        (F, "channel_shuffle", [f(2, 6, 3, 3), 3], {}),
        (F, "unfold", [f(2, 3, 6, 7), [2, 3]],
         dict(strides=[1, 2], paddings=1, dilations=[1, 2])),
        (F, "fold", [f(2, 12, 42), [5, 6], 2], dict(paddings=1)),
        (F, "bilinear", [f(4, 3), f(4, 5), f(2, 3, 5), f(1, 2)], {}),
        (F, "label_smooth", [prob(4, 5)], dict(epsilon=0.2)),
        (F, "pad", [f(2, 3, 4, 5), [1, 2, 2, 1]], dict(mode="reflect")),
        (F, "interpolate", [f(2, 3, 7, 9)],
         dict(size=[3, 4], mode="bilinear")),
        (F, "interpolate", [f(2, 3, 7, 9)], dict(scale_factor=2)),
        (F, "interpolate", [f(2, 3, 5, 6)],
         dict(scale_factor=[2.5, 1.5], mode="bicubic")),
        (F, "upsample", [f(1, 2, 4, 5, 6)],
         dict(size=[3, 7, 4], mode="trilinear", data_format="NCDHW")),
        (F, "conv1d_transpose", [f(2, 4, 9), f(4, 3, 3), f(6)],
         dict(stride=2, padding=1, groups=2)),
        (F, "conv2d_transpose", [f(2, 4, 6, 7), f(4, 3, 3, 3), f(6)],
         dict(stride=2, padding=1, output_padding=1, groups=2)),
        (F, "conv2d_transpose", [f(2, 6, 7, 4), f(4, 3, 3, 2), f(3)],
         dict(stride=2, padding=[1, 0, 2, 1], data_format="NHWC")),
        (F, "conv3d_transpose", [f(1, 4, 4, 5, 3), f(4, 2, 3, 2, 2), f(4)],
         dict(stride=2, padding=1, groups=2)),
        (F, "local_response_norm", [f(2, 7, 4, 4), 5], {}),
        (F, "mse_loss", [f(4, 5), f(4, 5)], {}),
        (F, "l1_loss", [f(4, 5), f(4, 5)], dict(reduction="none")),
        (F, "square_error_cost", [f(3, 2), f(3, 2)], {}),
        (F, "nll_loss", [logp(6, 5), np.array([0, 4, 2, -100, 1, 3])], {}),
        (F, "nll_loss", [logp(2, 4, 3, 3, axis=1), ints(4, 2, 3, 3)],
         dict(reduction="sum")),
        (F, "binary_cross_entropy", [prob(6, 5), prob(6, 5)], {}),
        (F, "binary_cross_entropy_with_logits",
         [f(6, 5), prob(6, 5), np.abs(f(6, 5))], {}),
        (F, "kl_div", [logp(6, 5), prob(6, 5)],
         dict(reduction="batchmean")),
        (F, "smooth_l1_loss", [f(6, 5), f(6, 5)], dict(delta=0.5)),
        (F, "margin_ranking_loss", [f(6), f(6), sign(6)],
         dict(margin=0.3)),
        (F, "hinge_embedding_loss", [f(6), sign(6)], dict(margin=0.7)),
        (F, "cosine_embedding_loss", [f(6, 4), f(6, 4), sign(6)],
         dict(margin=0.2)),
        (F, "triplet_margin_loss", [f(5, 4), f(5, 4), f(5, 4)],
         dict(swap=True, margin=2.0)),
        (F, "log_loss", [prob(6, 5), prob(6, 5)], {}),
        (F, "sigmoid_focal_loss", [f(6, 5), (prob(6, 5) > 0.7).astype(
            np.float32)], dict(reduction="mean")),
        (F, "dice_loss", [prob(4, 3, 5), ints(5, 4, 3, 1)], {}),
        (F, "softmax_with_cross_entropy", [f(6, 5), ints(5, 6, 1)],
         dict(return_softmax=True)),
        (L, "Conv3D", [4, 6, 3], dict(stride=2, padding=1, groups=2,
                                      inputs=[f(2, 4, 5, 6, 5)])),
        (L, "Conv1DTranspose", [4, 6, 3], dict(stride=2,
                                               inputs=[f(2, 4, 7)])),
        (L, "Conv2DTranspose", [4, 6, 3],
         dict(stride=2, padding=1, output_padding=1, groups=2,
              inputs=[f(2, 4, 5, 5)])),
        (L, "Conv3DTranspose", [2, 3, 2], dict(stride=2,
                                               inputs=[f(1, 2, 3, 4, 3)])),
        (L, "GroupNorm", [3, 6], dict(inputs=[f(2, 6, 4, 3)])),
        (L, "InstanceNorm1D", [4], dict(inputs=[f(3, 4, 7)])),
        (L, "InstanceNorm2D", [4], dict(inputs=[f(3, 4, 5, 6)])),
        (L, "InstanceNorm3D", [2], dict(inputs=[f(2, 2, 3, 4, 3)])),
        (L, "LocalResponseNorm", [3], dict(inputs=[f(2, 6, 4, 4)])),
        (L, "SyncBatchNorm", [5], dict(inputs=[f(4, 5, 3, 3)])),
        (L, "Embedding", [11, 4], dict(padding_idx=2, inputs=[
            np.array([[1, 2, 3], [2, 10, 0]])])),
        (L, "Bilinear", [3, 5, 4], dict(inputs=[f(6, 3), f(6, 5)])),
        (L, "CosineSimilarity", [], dict(axis=-1, inputs=[f(3, 5),
                                                          f(3, 5)])),
        (L, "Upsample", [], dict(scale_factor=0.5, mode="bilinear",
                                 inputs=[f(2, 3, 8, 6)])),
        (L, "UpsamplingNearest2D", [], dict(size=[5, 7],
                                            inputs=[f(2, 3, 4, 4)])),
        (L, "UpsamplingBilinear2D", [], dict(scale_factor=2,
                                             inputs=[f(2, 3, 4, 4)])),
        (L, "Pad1D", [[1, 2]], dict(mode="reflect", inputs=[f(2, 3, 5)])),
        (L, "Pad2D", [[1, 0, 2, 1]], dict(value=1.5,
                                          inputs=[f(2, 3, 4, 4)])),
        (L, "Pad3D", [[1, 1, 0, 1, 1, 0]], dict(mode="replicate", inputs=[
            f(1, 2, 3, 3, 3)])),
        (L, "Unfold", [[2, 2]], dict(strides=2, inputs=[f(2, 3, 4, 6)])),
        (L, "Fold", [[4, 6], [2, 2]], dict(strides=2,
                                           inputs=[f(2, 12, 6)])),
        (L, "PixelShuffle", [2], dict(inputs=[f(2, 8, 3, 2)])),
        (L, "PixelUnshuffle", [2], dict(inputs=[f(2, 2, 4, 6)])),
        (L, "ChannelShuffle", [2], dict(inputs=[f(2, 6, 2, 2)])),
        (L, "Dropout2D", [0.4], dict(inputs=[f(2, 6, 2, 2)])),
        (L, "Dropout3D", [0.4], dict(inputs=[f(2, 6, 2, 2, 2)])),
        (L, "AlphaDropout", [0.4], dict(inputs=[f(5, 6)])),
        (L, "MSELoss", [], dict(inputs=[f(4, 3), f(4, 3)])),
        (L, "L1Loss", [], dict(inputs=[f(4, 3), f(4, 3)])),
        (L, "NLLLoss", [], dict(inputs=[logp(6, 5), ints(5, 6)])),
        (L, "BCELoss", [], dict(inputs=[prob(6, 5), prob(6, 5)])),
        (L, "BCEWithLogitsLoss", [], dict(inputs=[f(6, 5), prob(6, 5)])),
        (L, "KLDivLoss", [], dict(reduction="batchmean",
                                  inputs=[logp(6, 5), prob(6, 5)])),
        (L, "SmoothL1Loss", [], dict(delta=0.3, inputs=[f(6, 5), f(6, 5)])),
        (L, "MarginRankingLoss", [], dict(inputs=[f(6), f(6), sign(6)])),
        (L, "HingeEmbeddingLoss", [], dict(inputs=[f(6), sign(6)])),
        (L, "CosineEmbeddingLoss", [], dict(inputs=[f(6, 4), f(6, 4),
                                                    sign(6)])),
        (L, "TripletMarginLoss", [], dict(margin=3.0, inputs=[
            f(5, 4), f(5, 4), f(5, 4)])),
        (L, "SimpleRNNCell", [5, 4], dict(inputs=[f(3, 5), f(3, 4)])),
        (L, "GRUCell", [5, 4], dict(inputs=[f(3, 5), f(3, 4)])),
        # the recurrent layers: 2 layers, bidirectional, sequence_length
        (L, "GRU", [5, 4], dict(num_layers=2, direction="bidirect",
                                inputs=[f(3, 6, 5), None,
                                        np.array([6, 3, 1])])),
        (L, "SimpleRNN", [5, 4], dict(num_layers=2, direction="bidirect",
                                      inputs=[f(3, 6, 5), None,
                                              np.array([6, 3, 1])])),
    ]
    return out


def run(torch, case, device, seed=0):
    """Case ``case`` on ``device``: its outputs, then the gradients of
    ``sum(out_i * w_i)`` (seeded ``w``) with respect to every float input
    and, for a layer, every parameter, as float64 numpy arrays in a fixed
    order."""
    import paddle_tpu_torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    kind, target, args, kwargs = case
    kwargs = dict(kwargs)
    inputs = kwargs.pop("inputs", args if kind == "F" else [])
    args = [] if kind == "F" else args
    params = []
    if kind == "F":
        fn = getattr(F, target)
    else:
        paddle_tpu_torch.seed(seed)
        if target in _PLACED:
            kwargs["device"] = "cpu"
        layer = getattr(nn, target)(*args, **kwargs)
        layer = torch.nn.Module.to(copy.deepcopy(layer), device)
        layer.train(target == "SyncBatchNorm")
        fn, kwargs = layer, {}
        params = list(layer.parameters())
    ts = [torch.tensor(a, device=device, requires_grad=a.dtype == np.float32)
          if isinstance(a, np.ndarray) else a for a in inputs]
    out = fn(*ts, **kwargs)
    outs = [o for o in _flat(out) if o.is_floating_point()]
    g = np.random.RandomState(seed + 1)
    total = sum((o * torch.tensor(g.randn(*o.shape), dtype=o.dtype,
                                  device=device)).sum() for o in outs)
    diff = [t for t in ts if isinstance(t, torch.Tensor) and t.requires_grad]
    grads = torch.autograd.grad(total, diff + params, allow_unused=True)
    res = [o.detach().double().cpu().numpy() for o in outs]
    for t, gr in zip(diff + params, grads):
        res.append(np.zeros(tuple(t.shape)) if gr is None
                   else gr.double().cpu().numpy())
    return res


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]
