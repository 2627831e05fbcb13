"""``paddle.hapi`` (counterpart of ``paddle_tpu/hapi/``): ``Model``,
``summary`` and the callbacks."""
from . import callbacks
from .model import Model, summary

__all__ = ["Model", "summary", "callbacks"]
