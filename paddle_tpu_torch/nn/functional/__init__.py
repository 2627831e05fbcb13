from ...core.tensor import bound_public as _bound_public
from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink,
                         hardsigmoid, hardswish, hardtanh, leaky_relu,
                         log_sigmoid, log_softmax, maxout, mish, one_hot,
                         prelu, relu, relu6, relu_, rrelu, selu, sigmoid,
                         silu, softmax, softplus, softshrink, softsign, swish,
                         tanh, tanhshrink, thresholded_relu)
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention, sdpa_ref)
from .common import (alpha_dropout, bilinear, channel_shuffle,
                     cosine_similarity, dropout, dropout2d, dropout3d,
                     embedding, fold, interpolate, label_smooth, linear,
                     normalize, pad, pixel_shuffle, pixel_unshuffle, unfold,
                     upsample)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cross_entropy, ctc_loss, dice_loss,
                   hinge_embedding_loss, kl_div, l1_loss, log_loss,
                   margin_ranking_loss, mse_loss, nll_loss, rnnt_loss,
                   sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = ["scaled_dot_product_attention", "sdpa_ref", "flash_attention",
           "flash_attn_unpadded", "rms_norm",
           "layer_norm", "batch_norm", "group_norm", "instance_norm",
           "local_response_norm",
           "cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div", "smooth_l1_loss",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
           "square_error_cost", "sigmoid_focal_loss", "dice_loss",
           "ctc_loss", "rnnt_loss",
           "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "pad", "normalize", "cosine_similarity",
           "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "unfold", "fold", "bilinear", "label_smooth",
           "conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose",
           "relu", "relu6", "relu_", "elu", "selu", "celu", "gelu", "sigmoid",
           "log_sigmoid", "tanh", "softmax", "log_softmax", "leaky_relu",
           "prelu", "rrelu", "silu", "swish", "mish", "hardswish",
           "hardsigmoid", "hardtanh", "hardshrink", "softshrink",
           "tanhshrink", "thresholded_relu", "softplus", "softsign",
           "maxout", "glu", "gumbel_softmax", "one_hot",
           "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d"]

# the public functionals hand back Tensors when a Tensor came in
_bound_public(globals())
