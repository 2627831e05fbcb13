from ...core.tensor import bound_public
from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink,
                         hardsigmoid, hardswish, hardtanh, leaky_relu,
                         log_sigmoid, log_softmax, maxout, mish, one_hot,
                         prelu, relu, relu6, relu_, rrelu, selu, sigmoid,
                         silu, softmax, softplus, softshrink, softsign, swish,
                         tanh, tanhshrink, thresholded_relu)
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention, sdpa_ref)
from .common import dropout, embedding
from .conv import conv1d, conv2d, conv3d
from .loss import cross_entropy, ctc_loss, rnnt_loss
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = ["scaled_dot_product_attention", "sdpa_ref", "flash_attention",
           "flash_attn_unpadded", "rms_norm",
           "layer_norm", "batch_norm", "group_norm", "instance_norm",
           "cross_entropy", "ctc_loss", "rnnt_loss", "dropout", "embedding",
           "conv1d", "conv2d", "conv3d",
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
bound_public(globals())
