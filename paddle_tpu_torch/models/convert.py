"""Weights from the JAX package's Llama into the port's.

The only way the tests give both packages the same weights: the reference
model's ``functional_state(model)[0]`` / ``state_dict()`` exported as numpy
goes through :func:`state_from_jax` and into ``load_state_dict``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_jax"]

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
