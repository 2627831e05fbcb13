from . import functional
from .decode import sample_logits
from .layers import RMSNorm

__all__ = ["functional", "sample_logits", "RMSNorm"]
