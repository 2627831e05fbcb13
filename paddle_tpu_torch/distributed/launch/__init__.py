"""``python -m paddle_tpu_torch.distributed.launch`` — the multi-process
bootstrap CLI (counterpart of ``paddle_tpu/distributed/launch``; Paddle's
``paddle.distributed.launch``): lays out the rank environment, starts one
worker per rank with its own log, watches them, and restarts the pod up
to ``--max_restarts`` times when a worker fails."""
from .main import launch, main  # noqa: F401

__all__ = ["launch", "main"]
