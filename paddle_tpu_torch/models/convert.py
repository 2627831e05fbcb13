"""Weights from the JAX package's models into the port's.

The only way the tests give both packages the same weights: the reference
model's ``functional_state(model)[0]`` / ``state_dict()`` exported as numpy
goes through :func:`state_from_jax` (Llama) or :func:`ernie_state_from_jax`
(ERNIE) or :func:`conformer_state_from_jax` (Conformer-CTC and -RNN-T, with
the batch-norm buffers) or :func:`whisper_state_from_jax` (Whisper) or
:func:`vision_state_from_jax` (the vision zoo, with the batch-norm buffers)
and into ``load_state_dict``; the reference trainer's parameter dict
(``LlamaPipelineTrainer._state[0]``) goes through
:func:`trainer_state_from_jax` into the port trainer's ``model``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["state_from_jax", "trainer_state_from_jax", "ernie_state_from_jax",
           "conformer_state_from_jax", "whisper_state_from_jax",
           "vision_state_from_jax"]

# paddle Linear stores [in, out]; nn.Linear stores [out, in]
_LINEAR_SUFFIXES = ("qkv_proj.weight", "o_proj.weight", "gate_up_proj.weight",
                    "down_proj.weight", "lm_head.weight")


def state_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map reference parameter names and layouts onto the port's.

    Linear weights are transposed; embedding and norm weights copy as they
    are. The RoPE tables are not persistable in either package and are
    rebuilt by the port's model, so they are dropped here. The tensors are
    CPU copies in the arrays' dtype; ``load_state_dict`` moves them to the
    model's device and dtype."""
    out = {}
    for name, arr in params.items():
        if name in ("rope_cos", "rope_sin"):
            continue
        a = np.asarray(arr)
        if name.endswith(_LINEAR_SUFFIXES):
            a = a.T
        out[name] = torch.tensor(np.ascontiguousarray(a))  # a copy it owns
    return out


# the reference trainer's edge layers and the port model's names for them
_TRAINER_EDGES = {"embed.weight": "embed_tokens.weight",
                  "norm.weight": "norm.weight",
                  "head.weight": "lm_head.weight"}


def trainer_state_from_jax(params: dict[str, np.ndarray]
                           ) -> dict[str, torch.Tensor]:
    """Map the reference trainer's parameters onto the port model's.

    ``blocks.<name>`` is stacked ``[stages, layers / stages, ...]`` and
    unstacks, stage-major, into ``layers.<i>.<name>``; ``embed``, ``norm``
    and ``head`` become ``embed_tokens``, ``norm`` and ``lm_head``. Then
    :func:`state_from_jax` transposes the linear weights (the head's
    included)."""
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


def ernie_state_from_jax(params: dict[str, np.ndarray], model: nn.Module
                         ) -> dict[str, torch.Tensor]:
    """Map an ERNIE reference model's parameters onto ``model`` (a port
    ``ErnieModel`` / ``ErnieForMaskedLM`` / ``ErnieForSequenceClassification``
    with the same attribute names).

    A paddle ``Linear`` stores ``[in, out]``, ``nn.Linear`` ``[out, in]``:
    exactly the weights whose module in ``model`` is an ``nn.Linear`` are
    transposed, found by looking each name's module up on ``model``;
    everything else copies as it is. Raises on a name ``model`` lacks. CPU
    copies in the arrays' dtype, for ``load_state_dict``."""
    out = {}
    for name, arr in params.items():
        owner, _, leaf = name.rpartition(".")
        try:
            module = model.get_submodule(owner)
        except AttributeError:
            raise KeyError(f"the port model has no module {owner!r} for "
                           f"reference parameter {name!r}") from None
        a = np.asarray(arr)
        if isinstance(module, nn.Linear) and leaf == "weight":
            a = a.T
        out[name] = torch.tensor(np.ascontiguousarray(a))
    return out


def conformer_state_from_jax(arrays: dict[str, np.ndarray], model: nn.Module
                             ) -> dict[str, torch.Tensor]:
    """Map a Conformer reference model's parameters AND buffers (the batch
    norms' ``_mean`` and ``_variance``, from ``named_buffers()``) onto the
    port ``model`` (``ConformerForCTC`` or ``ConformerForRNNT``), by the
    same module lookup as :func:`ernie_state_from_jax`: only ``nn.Linear``
    weights are transposed; convolution weights (``[out, in / groups, *k]``
    in both packages), norms, buffers, the LSTM's ``[4H, in]`` /
    ``[4H, H]`` weights and the label embedding copy as they are."""
    return ernie_state_from_jax(arrays, model)


def _check_names(arrays, model):
    """Raise ``KeyError`` on a name that is not a parameter or buffer of
    ``model``."""
    unknown = sorted(set(arrays) - set(model.state_dict()))
    if unknown:
        raise KeyError(f"the port model has no parameter {unknown[0]!r} "
                       f"(and {len(unknown) - 1} more unknown names)")


def whisper_state_from_jax(params: dict[str, np.ndarray], model: nn.Module
                           ) -> dict[str, torch.Tensor]:
    """Map a Whisper reference model's parameters onto the port ``model``
    (``WhisperForConditionalGeneration``, the same attribute names) by the
    module lookup of :func:`ernie_state_from_jax`: exactly the ``nn.Linear``
    weights (the attentions' projections, the FFNs, the bias-free ``proj``)
    are transposed; convolutions (``[out, in, k]`` in both packages), the
    embeddings and the norms copy as they are. Raises ``KeyError`` on a
    name that is not a parameter or buffer of ``model`` (the sinusoid
    table is not persistable in either package)."""
    _check_names(params, model)
    return ernie_state_from_jax(params, model)


def vision_state_from_jax(arrays: dict[str, np.ndarray], model: nn.Module
                          ) -> dict[str, torch.Tensor]:
    """Map a vision model's parameters AND buffers (the batch norms'
    ``_mean`` and ``_variance``, from ``named_buffers()``) onto the port
    ``model`` of the same family (``vision.models``), by the module lookup
    of :func:`ernie_state_from_jax`: exactly the weights of the linear
    layers (``nn.Linear`` ``Linear``, ``[out, in]`` where Paddle's are
    ``[in, out]``) are transposed; convolutions (``[out, in / groups, kh,
    kw]`` in both packages), norms and buffers copy as they are. Raises
    ``KeyError`` on a name that is not a parameter or buffer of
    ``model``."""
    _check_names(arrays, model)
    return ernie_state_from_jax(arrays, model)
