from .activation import gelu, relu, tanh
from .attention import scaled_dot_product_attention, sdpa_ref
from .common import dropout
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["scaled_dot_product_attention", "sdpa_ref", "rms_norm",
           "layer_norm", "cross_entropy", "dropout", "gelu", "relu", "tanh"]
