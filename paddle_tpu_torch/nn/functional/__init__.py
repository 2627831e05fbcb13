from .activation import gelu, glu, log_softmax, relu, swish, tanh
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention, sdpa_ref)
from .common import dropout
from .conv import conv1d, conv2d
from .loss import cross_entropy, ctc_loss, rnnt_loss
from .norm import batch_norm, batch_norm_stats, layer_norm, rms_norm

__all__ = ["scaled_dot_product_attention", "sdpa_ref", "flash_attention",
           "flash_attn_unpadded", "rms_norm",
           "layer_norm", "batch_norm", "batch_norm_stats", "cross_entropy",
           "ctc_loss", "rnnt_loss", "dropout", "conv1d", "conv2d", "gelu", "glu",
           "log_softmax", "relu", "swish", "tanh"]
