from .common import Dropout, LayerList
from .conv import Conv1D, Conv2D
from .loss import CTCLoss
from .norm import BatchNorm1D, LayerNorm, RMSNorm
from .rnn import LSTM, RNN, BiRNN, LSTMCell
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Dropout", "LayerList", "Conv1D", "Conv2D", "CTCLoss",
           "BatchNorm1D", "LayerNorm", "RMSNorm", "LSTM", "LSTMCell", "RNN",
           "BiRNN",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "TransformerDecoder",
           "TransformerDecoderLayer", "Transformer"]
