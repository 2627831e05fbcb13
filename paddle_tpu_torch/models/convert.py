"""Weights from the JAX package's models into the port's.

The port's ``Layer.state_dict`` / ``set_state_dict`` / ``load_state_dict``
speak the reference's names and layouts (ROADMAP F4), so a reference
state dict loads as it is: these helpers only turn its arrays into CPU
tensors of their own (in the arrays' dtype; loading moves them to the
model's device and dtype) and check the names. :func:`state_from_jax`
(Llama) drops the RoPE tables, which neither package persists;
:func:`trainer_state_from_jax` maps the reference trainer's stacked
parameter dict (``LlamaPipelineTrainer._state[0]``) onto the port
model's names; :func:`rank_state_from_jax` cuts either of those into one
rank's shards of a hybrid mesh; :func:`ernie_state_from_jax`,
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

__all__ = ["state_from_jax", "trainer_state_from_jax", "rank_state_from_jax",
           "ernie_state_from_jax",
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


def _mp_shard(name, a, config, rank, n):
    """Rank ``rank``'s shard (of ``n``) of the logical Llama parameter
    ``name`` (Paddle's ``[in, out]`` layouts). The fused projections split
    per head and per half: ``qkv_proj``'s columns are q, k and v, and a
    rank takes its heads of each; ``gate_up_proj``'s are gate and up, and
    a rank takes its part of each. A contiguous column split would hand a
    rank some other rank's heads."""
    if n == 1:
        return a
    c = config

    def rows(x):
        k = x.shape[0] // n
        return x[rank * k:(rank + 1) * k]

    def cols(x, segments):
        out, start = [], 0
        for seg in segments:
            k = seg // n
            out.append(x[:, start + rank * k:start + (rank + 1) * k])
            start += seg
        return np.concatenate(out, axis=1)

    leaf = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else name
    if name == "embed_tokens.weight" or leaf in ("o_proj", "down_proj"):
        return rows(a)
    if leaf == "qkv_proj":
        q = c.num_attention_heads * c.head_dim
        kv = c.num_key_value_heads * c.head_dim
        return cols(a, [q, kv, kv])
    if leaf == "gate_up_proj":
        return cols(a, [c.intermediate_size] * 2)
    if name == "lm_head.weight":
        return cols(a, [a.shape[1]])
    return a                                      # norms: replicated


def rank_state_from_jax(params: dict[str, np.ndarray], config, coords: dict,
                        degrees: dict, vpp: int = 1
                        ) -> dict[str, torch.Tensor]:
    """One rank's shards of the reference Llama's logical parameters.

    params:  the reference model's ``state_dict`` arrays or its trainer's
             stacked ``_state[0]`` (``blocks.*`` names are unstacked).
    coords:  this rank's mesh coordinates ``{"dp", "sharding", "pp", "sep",
             "mp"}`` (missing: 0); degrees likewise (missing: 1).
    vpp:     chunks per pipeline rank (the interleaved schedule).

    Returns ``{global name: tensor}``: the decoder layers of this rank's
    virtual stages (``layers.<global index>.*``), the embedding on the
    first stage, the final norm and head on the last, each cut to this
    rank's mp shard. dp, sharding and sep ranks hold the same weights
    (ZeRO slices the optimizer state, not these)."""
    if any(k.startswith("blocks.") for k in params):
        full = trainer_state_from_jax(params)
    else:
        full = state_from_jax(params)
    S, st = int(degrees.get("pp", 1)), int(coords.get("pp", 0))
    n, r = int(degrees.get("mp", 1)), int(coords.get("mp", 0))
    L = config.num_hidden_layers
    lpv = L // (S * vpp)
    mine = {i for c in range(vpp)
            for i in range((c * S + st) * lpv, (c * S + st + 1) * lpv)}
    out = {}
    for name, t in full.items():
        if name.startswith("layers."):
            if int(name.split(".")[1]) not in mine:
                continue
        elif name == "embed_tokens.weight" and st != 0:
            continue
        elif name in ("norm.weight", "lm_head.weight") and st != S - 1:
            continue
        out[name] = torch.tensor(np.ascontiguousarray(
            _mp_shard(name, t.numpy(), config, r, n)))
    return out


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
