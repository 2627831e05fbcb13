"""``paddle.inference``: ``Config`` and ``create_predictor`` over saved
programs (counterpart of ``paddle_tpu/inference/__init__.py``; Paddle's
AnalysisPredictor and its zero-copy handle workflow).

The config points at a ``jit.save`` / ``static.save_inference_model`` pair
(``<prefix>.pdmodel`` / ``<prefix>.pdiparams``). The predictor loads the
exported program onto its device (``enable_use_gpu(..., device_id)``:
``cuda:<id>``; ``disable_gpu()``: the CPU; default the card), moving a
program exported on the other device there. With IR optimisation on
(``switch_ir_optim``, on by default as in Paddle) the loaded program is
compiled with ``torch.compile`` once per input signature (the backend of
``jit.DEFAULT_BACKEND``, inductor); off, the exported graph runs as it is.

Handles: ``copy_from_cpu`` stages host data; ``share_external_data``
adopts a tensor already on the predictor's device without a copy; outputs
stay on the device until ``copy_to_cpu``. ``run([arrays])`` is the direct
form. ``clone()`` shares the program and the weights and gets its own
handles.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["Config", "Predictor", "create_predictor"]


class Config:
    """``paddle.inference.Config(prog_file, params_file)``: the two files
    ``<prefix>.pdmodel`` / ``<prefix>.pdiparams``."""

    def __init__(self, prog_file=None, params_file=None):
        self._prefix = None
        self._params_file = None
        self._device = None
        self._ir_optim = True
        if prog_file is not None:
            self.set_prog_file(prog_file)
        if params_file is not None:
            self.set_params_file(params_file)

    def set_prog_file(self, path):
        if path.endswith(".pdmodel"):
            path = path[: -len(".pdmodel")]
        self._prefix = path

    def set_params_file(self, path):
        self._params_file = path

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def params_file(self):
        if self._params_file is not None:
            return self._params_file
        return (self._prefix or "") + ".pdiparams"

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = torch.device("cuda", device_id)

    def disable_gpu(self):
        self._device = torch.device("cpu")

    def device(self) -> torch.device:
        dev = resolve_device(self._device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def switch_ir_optim(self, x=True):
        self._ir_optim = bool(x)

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self, *a, **k):
        pass  # the caching allocator reuses freed blocks either way


class _IOHandle:
    """A tensor handle (Paddle's ZeroCopyTensor): ``copy_from_cpu`` stages
    host data on the device; ``share_external_data`` adopts a tensor on the
    device without a copy (one elsewhere is copied there); outputs stay on
    the device until ``copy_to_cpu``."""

    def __init__(self, device):
        self._device = device
        self._value = None

    def copy_from_cpu(self, array):
        self._value = torch.as_tensor(np.asarray(array)).to(self._device)

    def share_external_data(self, tensor):
        if isinstance(tensor, torch.Tensor):
            t = torch.Tensor.detach(tensor)
            self._value = t if t.device == self._device else \
                t.to(self._device)
        else:
            self.copy_from_cpu(tensor)

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)

    def copy_to_cpu(self):
        v = self._value
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def shape(self):
        return None if self._value is None else list(self._value.shape)


class _Served:
    """The loaded program shared by a predictor and its clones, compiled
    once per input signature when IR optimisation is on."""

    def __init__(self, layer, ir_optim):
        self.layer = layer
        self.ir_optim = ir_optim
        self.compiled: dict = {}

    def __call__(self, arrays):
        if not self.ir_optim:
            return self.layer.run_plain(*arrays)
        from ..jit import compile_fresh

        key = tuple((tuple(a.shape), a.dtype) for a in arrays)
        fn = self.compiled.get(key)
        if fn is None:
            layer = self.layer

            def serve(*xs):
                return layer._program(layer._params, layer._buffers_in, *xs)

            fn = compile_fresh(serve, f"{len(self.compiled)}_"
                                      f"{id(self) & 0xffffff:x}")
            self.compiled[key] = fn
        with torch.no_grad():
            return fn(*arrays)


class Predictor:
    """Paddle's AnalysisPredictor: the handle workflow, and ``clone()``
    sharing the loaded program and weights with handles of its own (the
    serving fan-out of ``analysis_predictor.h`` ``Clone``)."""

    def __init__(self, config: Config, _served=None):
        from ..jit import load as jit_load

        self._config = config
        self._device = config.device()
        if _served is None:
            if config._prefix is None:
                raise ValueError(
                    "inference.Config has no model to load: neither "
                    "prog_file nor params_file is set, so there is no "
                    "'<prefix>.pdmodel' / '<prefix>.pdiparams' pair to "
                    "read. Pass them to Config(prog_file, params_file) or "
                    "call set_prog_file() / set_params_file() first.")
            missing = [p for p in (config.prog_file(), config.params_file())
                       if not os.path.exists(p)]
            if missing:
                raise FileNotFoundError(
                    "inference model file(s) not found: "
                    + ", ".join(missing)
                    + " (expected the jit.save pair <prefix>.pdmodel / "
                      "<prefix>.pdiparams)")
            layer = jit_load(config._prefix,
                             params_file=config.params_file(),
                             device=self._device)
            _served = _Served(layer, config.ir_optim())
        self._served = _served
        n_in = len(_served.layer.in_shapes or [])
        self._inputs = {f"input_{i}": _IOHandle(self._device)
                        for i in range(max(n_in, 1))}
        self._outputs = {}

    def get_input_names(self):
        return list(self._inputs)

    def get_input_handle(self, name):
        return self._inputs[name]

    def run(self, inputs=None):
        """The handle workflow (``run()`` with the input handles filled,
        outputs in the output handles) or the direct form ``run([arrays])
        -> [numpy arrays]``."""
        if inputs is not None:
            arrays = [torch.Tensor.detach(a).to(self._device)
                      if isinstance(a, torch.Tensor)
                      else torch.as_tensor(np.asarray(a)).to(self._device)
                      for a in inputs]
        else:
            missing = [n for n, h in self._inputs.items() if h._value is None]
            if missing:
                raise ValueError(
                    f"input handle(s) not filled before run(): {missing}")
            arrays = [h._value for h in self._inputs.values()]
        out = self._served(arrays)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = {}
        for i, o in enumerate(outs):
            h = _IOHandle(self._device)
            h._value = o            # stays on the device until copy_to_cpu
            self._outputs[f"output_{i}"] = h
        if inputs is not None:
            return [h.copy_to_cpu() for h in self._outputs.values()]
        return None

    def get_output_names(self):
        return list(self._outputs)

    def get_output_handle(self, name):
        return self._outputs[name]

    def clone(self):
        """A predictor over the same loaded program and weights, with
        handles of its own."""
        return Predictor(self._config, _served=self._served)

    @property
    def _layer(self):
        return self._served.layer


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
