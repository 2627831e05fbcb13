"""Weights from the JAX package's models into the port's.

The port's ``Layer.state_dict`` / ``set_state_dict`` / ``load_state_dict``
speak the reference's names and layouts (ROADMAP F4), so a reference
state dict loads as it is: these helpers only turn its arrays into CPU
tensors of their own (in the arrays' dtype; loading moves them to the
model's device and dtype) and check the names. :func:`state_from_jax`
(Llama) drops the RoPE tables, which neither package persists;
:func:`trainer_state_from_jax` maps the reference trainer's stacked
parameter dict (``LlamaPipelineTrainer._state[0]``) onto the port
model's names; :func:`ernie_state_from_jax`,
:func:`conformer_state_from_jax` (with the batch-norm buffers),
:func:`whisper_state_from_jax` and :func:`vision_state_from_jax` (with
the batch-norm buffers) raise ``KeyError`` on a name the port model
lacks. Feed any of them to ``model.load_state_dict`` (or
``set_state_dict``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["state_from_jax", "trainer_state_from_jax", "ernie_state_from_jax",
           "conformer_state_from_jax", "whisper_state_from_jax",
           "vision_state_from_jax"]


def _tensors(arrays):
    return {name: torch.tensor(np.ascontiguousarray(np.asarray(a)))
            for name, a in arrays.items()}      # copies they own


def state_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A Llama reference model's parameters as the port model's state
    dict (the same names and layouts; the RoPE tables dropped)."""
    return _tensors({n: a for n, a in params.items()
                     if n not in ("rope_cos", "rope_sin")})


# the reference trainer's edge layers and the port model's names for them
_TRAINER_EDGES = {"embed.weight": "embed_tokens.weight",
                  "norm.weight": "norm.weight",
                  "head.weight": "lm_head.weight"}


def trainer_state_from_jax(params: dict[str, np.ndarray]
                           ) -> dict[str, torch.Tensor]:
    """Map the reference trainer's parameters onto the port model's.

    ``blocks.<name>`` is stacked ``[stages, layers / stages, ...]`` and
    unstacks, stage-major, into ``layers.<i>.<name>``; ``embed``, ``norm``
    and ``head`` become ``embed_tokens``, ``norm`` and ``lm_head``."""
    flat = {}
    for name, arr in params.items():
        a = np.asarray(arr)
        if name.startswith("blocks."):
            sub = name[len("blocks."):]
            layers = a.reshape((-1,) + a.shape[2:])
            for i in range(layers.shape[0]):
                flat[f"layers.{i}.{sub}"] = layers[i]
        elif name in _TRAINER_EDGES:
            flat[_TRAINER_EDGES[name]] = a
        else:
            raise KeyError(f"unknown reference trainer parameter {name!r}")
    return state_from_jax(flat)


def _check_names(arrays, model):
    """Raise ``KeyError`` on a name that is not a parameter or buffer of
    ``model``."""
    unknown = sorted(set(arrays) - set(model.state_dict()))
    if unknown:
        raise KeyError(f"the port model has no parameter {unknown[0]!r} "
                       f"(and {len(unknown) - 1} more unknown names)")


def ernie_state_from_jax(params: dict[str, np.ndarray], model: nn.Module
                         ) -> dict[str, torch.Tensor]:
    """An ERNIE reference model's parameters for ``model`` (a port
    ``ErnieModel`` / ``ErnieForMaskedLM`` / ``ErnieForSequenceClassification``
    or any port layer with the reference's attribute names)."""
    _check_names(params, model)
    return _tensors(params)


def conformer_state_from_jax(arrays: dict[str, np.ndarray], model: nn.Module
                             ) -> dict[str, torch.Tensor]:
    """A Conformer reference model's parameters AND buffers (the batch
    norms' ``_mean`` and ``_variance``) for the port ``model``
    (``ConformerForCTC`` or ``ConformerForRNNT``)."""
    _check_names(arrays, model)
    return _tensors(arrays)


def whisper_state_from_jax(params: dict[str, np.ndarray], model: nn.Module
                           ) -> dict[str, torch.Tensor]:
    """A Whisper reference model's parameters for the port ``model``
    (``WhisperForConditionalGeneration``; the sinusoid table is not
    persistable in either package)."""
    _check_names(params, model)
    return _tensors(params)


def vision_state_from_jax(arrays: dict[str, np.ndarray], model: nn.Module
                          ) -> dict[str, torch.Tensor]:
    """A vision model's parameters AND buffers (the batch norms' ``_mean``
    and ``_variance``) for the port ``model`` of the same family
    (``vision.models``)."""
    _check_names(arrays, model)
    return _tensors(arrays)
