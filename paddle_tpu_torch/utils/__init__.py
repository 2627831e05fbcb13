"""``paddle.utils`` (counterpart of ``paddle_tpu/utils/``): ``LogWriter``."""
from .log_writer import LogWriter

__all__ = ["LogWriter"]
