"""``paddle.vision`` (counterpart of ``paddle_tpu/vision/``): the image
classification models of ``models`` and ``ops.ConvNormActivation``."""
from . import models, ops

__all__ = ["models", "ops"]
