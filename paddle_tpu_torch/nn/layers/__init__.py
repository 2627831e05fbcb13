from .common import Dropout
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "LayerNorm", "RMSNorm", "MultiHeadAttention",
           "TransformerEncoder", "TransformerEncoderLayer"]
