"""``paddle.vision`` (counterpart of ``paddle_tpu/vision/``): the image
classification models of ``models``, ``ops.ConvNormActivation``, the
``datasets`` and the numpy ``transforms``."""
from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms"]
