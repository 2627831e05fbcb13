from .attention import scaled_dot_product_attention, sdpa_ref
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["scaled_dot_product_attention", "sdpa_ref", "rms_norm",
           "cross_entropy"]
