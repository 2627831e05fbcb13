"""paddle_tpu_torch: the port of paddle_tpu to PyTorch and CUDA on an
NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference. This package imports
neither JAX nor anything of ``paddle_tpu``. Slice 1 serves the Llama-2
decoder through ``serving.LLMEngine``; slice 2 trains it through
``models.LlamaPipelineTrainer`` with ``optimizer.AdamW``. Hand-written
Hopper kernels (``kernels/``, sources in ``csrc/``) carry both: flash
attention forward and backward, ragged paged attention, RMSNorm forward
and backward, softmax cross-entropy forward and backward. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from . import core, kernels, models, nn, optimizer, serving
from .core import resolve_device

__all__ = ["core", "kernels", "models", "nn", "optimizer", "serving",
           "resolve_device"]
