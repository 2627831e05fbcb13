from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU,
                         Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import Dropout, Flatten, Identity, LayerList, Linear, Sequential
from .conv import Conv1D, Conv2D
from .loss import CrossEntropyLoss, CTCLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                      MaxPool3D)
from .rnn import LSTM, RNN, BiRNN, LSTMCell
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Dropout", "Flatten", "Identity", "LayerList", "Linear",
           "Sequential", "Conv1D", "Conv2D", "CrossEntropyLoss", "CTCLoss",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm", "RMSNorm", "LSTM", "LSTMCell", "RNN", "BiRNN",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "TransformerDecoder",
           "TransformerDecoderLayer", "Transformer",
           "ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid",
           "LogSigmoid", "Tanh", "Softmax", "LogSoftmax", "LeakyReLU",
           "PReLU", "RReLU", "Silu", "Swish", "Mish", "Hardswish",
           "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink",
           "Tanhshrink", "ThresholdedReLU", "Softplus", "Softsign", "Maxout",
           "GLU", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
           "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]
