from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import sample_logits
from .layers import (Dropout, LayerNorm, MultiHeadAttention, RMSNorm,
                     TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "sample_logits", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Dropout", "LayerNorm",
           "MultiHeadAttention", "RMSNorm", "TransformerEncoder",
           "TransformerEncoderLayer"]
