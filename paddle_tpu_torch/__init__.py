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
and backward. Later slices add Conformer-CTC / RNN-T, Whisper, the
vision zoo (``vision.models.resnet50`` trained with ``optimizer.Momentum``
over ``PiecewiseDecay``), the high-level API (``Model`` with
``io.DataLoader``, ``metric``, the callbacks, ``save`` / ``load``,
``vision.datasets`` / ``vision.transforms``), and Paddle's eager API:
``Tensor`` / ``Parameter`` / ``to_tensor``, autograd (``grad``,
``no_grad``, ``autograd.PyLayer``), the op library (``paddle.concat``,
``paddle.matmul``, ...), ``nn.Layer`` and ``nn.initializer``; and the
static-graph and deployment path: ``jit.to_static`` / ``jit.save`` /
``jit.load``, ``static`` Program / Executor / ``save_inference_model``,
``inference.create_predictor``, ``set_flags`` / ``get_flags``; and the
rest of the op library: ``ops.parity`` and ``ops.detection`` (the
reference's remaining op names, ``paddle.inverse``, ``paddle.complex``,
``paddle.bincount``, ...), ``vision.ops``' detection functionals and
``DeformConv2D``, ``fft``, ``TensorArray`` / ``create_array``,
``text.viterbi_decode``, and the ``FLAGS_check_nan_inf`` /
``FLAGS_benchmark`` hooks.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
or calls ``set_device("cpu")``::

    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    x = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)
    (paddle.matmul(x, x.t()) * 2).sum().backward()
"""
from . import (amp, analysis, autograd, core, framework, hapi, inference,
               io, jit, kernels, metric, models, nn, ops, optimizer,
               profiler, serving, static, telemetry, utils, vision)
from .core import (CPUPlace, CUDAPlace, Place, device_count, get_device,
                   resolve_device, set_device)
from .core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, get_default_dtype, int8, int16,
                         int32, int64, set_default_dtype, uint8)
from .core.tensor import Parameter, Tensor, to_tensor
from .framework import load, save, seed
from .framework.flags import get_flags, set_flags
from .hapi import Model, summary
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .ops import op_coverage
from .ops import detection as _detection  # noqa: F401  (needs nn)
from .ops import parity as _parity
from . import fft, text  # noqa: E402
from .core.containers import (SelectedRows, TensorArray, array_length,
                              array_read, array_write, create_array)

# the parity ops' public names, where neither the namespace nor Tensor has
# them (the dict keeps max / min / all / any off every module's builtins)
_installed = []
for _k, _v in _parity.PUBLIC_OPS.items():
    if _k not in globals():
        globals()[_k] = _v
        _installed.append(_k)
    if not hasattr(Tensor, _k):
        setattr(Tensor, _k, _v)
del _k, _v

bool = bool_  # paddle.bool

__all__ = ["amp", "autograd", "core", "framework", "hapi", "inference", "io",
           "jit", "kernels", "metric", "models", "nn", "ops", "optimizer",
           "serving", "static", "utils", "vision", "resolve_device", "seed",
           "save", "load", "set_flags", "get_flags", "Model",
           "summary", "Tensor", "Parameter", "to_tensor", "no_grad",
           "enable_grad", "set_grad_enabled", "is_grad_enabled", "grad",
           "set_device", "get_device", "device_count", "Place", "CPUPlace",
           "CUDAPlace", "set_default_dtype", "get_default_dtype",
           "op_coverage", "bool", "bool_", "uint8", "int8", "int16",
           "int32", "int64", "float16", "bfloat16", "float32", "float64",
           "complex64", "complex128", "fft", "text", "TensorArray",
           "SelectedRows", "create_array", "array_write", "array_read",
           "array_length", *_ops_all, *_installed]
