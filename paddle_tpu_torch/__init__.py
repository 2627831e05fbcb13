"""paddle_tpu_torch: the port of paddle_tpu to PyTorch and CUDA on an
NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference. This package imports
neither JAX nor anything of ``paddle_tpu``. Slice 1 serves the Llama-2
decoder through ``serving.LLMEngine``; slice 2 trains it through
``models.LlamaPipelineTrainer`` with ``optimizer.AdamW``; slice 3
pretrains ERNIE (``models.ErnieForMaskedLM``) under ``amp.auto_cast``
with lr schedulers and gradient clipping. Hand-written Hopper kernels
(``kernels/``, sources in ``csrc/``) carry them: flash attention forward
and backward (with in-kernel dropout), ragged paged attention, RMSNorm
forward and backward, LayerNorm forward, softmax cross-entropy forward
and backward. Later slices add Conformer-CTC / RNN-T, Whisper and the
vision zoo (``vision.models.resnet50`` trained with
``optimizer.Momentum`` over ``PiecewiseDecay``), and the high-level API:
``Model`` (``hapi``) with ``io.DataLoader``, ``metric``, the callbacks,
``save`` / ``load`` and ``vision.datasets`` / ``vision.transforms``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from . import (amp, core, framework, hapi, io, kernels, metric, models, nn,
               optimizer, serving, utils, vision)
from .core import resolve_device
from .framework import load, save, seed
from .hapi import Model, summary

__all__ = ["amp", "core", "framework", "hapi", "io", "kernels", "metric",
           "models", "nn", "optimizer", "serving", "utils", "vision",
           "resolve_device", "seed", "save", "load", "Model", "summary"]
