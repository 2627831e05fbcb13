"""paddle_tpu_torch: the port of paddle_tpu to PyTorch and CUDA on an
NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference. This package imports
neither JAX nor anything of ``paddle_tpu``. Slice 1 serves the Llama-2
decoder through ``serving.LLMEngine`` with three hand-written Hopper
kernels (``kernels/``, sources in ``csrc/``): flash-attention forward,
ragged paged attention and RMSNorm. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
from . import core, kernels, models, nn, serving
from .core import resolve_device

__all__ = ["core", "kernels", "models", "nn", "serving", "resolve_device"]
