from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import (BeamSearchDecoder, dynamic_decode, gather_tree,
                     sample_logits)
from .layers import (LSTM, RNN, BatchNorm1D, BiRNN, Conv1D, Conv2D, CTCLoss,
                     Dropout, LayerList, LayerNorm, LSTMCell,
                     MultiHeadAttention, RMSNorm, Transformer,
                     TransformerDecoder, TransformerDecoderLayer,
                     TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "sample_logits", "BeamSearchDecoder",
           "dynamic_decode", "gather_tree", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "BatchNorm1D", "Conv1D",
           "Conv2D", "CTCLoss", "Dropout", "LSTM", "LSTMCell", "RNN", "BiRNN",
           "LayerList", "LayerNorm", "MultiHeadAttention", "RMSNorm",
           "TransformerEncoder", "TransformerEncoderLayer",
           "TransformerDecoder", "TransformerDecoderLayer", "Transformer"]
