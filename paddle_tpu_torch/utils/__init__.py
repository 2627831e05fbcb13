"""``paddle.utils`` (counterpart of ``paddle_tpu/utils/``): ``LogWriter``
and the fault-injection registry (``faults``)."""
from . import faults  # noqa: F401
from .faults import FaultError, FaultPlan, inject  # noqa: F401
from .log_writer import LogWriter

__all__ = ["LogWriter", "faults", "FaultError", "FaultPlan", "inject"]
