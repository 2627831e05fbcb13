from .attention import scaled_dot_product_attention, sdpa_ref
from .norm import rms_norm

__all__ = ["scaled_dot_product_attention", "sdpa_ref", "rms_norm"]
