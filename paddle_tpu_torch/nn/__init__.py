from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import (BeamSearchDecoder, dynamic_decode, gather_tree,
                     sample_logits)
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers

__all__ = ["functional", "sample_logits", "BeamSearchDecoder",
           "dynamic_decode", "gather_tree", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", *_layers]
