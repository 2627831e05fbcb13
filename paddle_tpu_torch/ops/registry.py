"""Op registry (counterpart of ``paddle_tpu/ops/registry.py``): one table
from Paddle op name to the port's eager function, and the op-coverage count
of that table against the reference's op inventory (its own copy of
``reference_ops.txt``: the names of Paddle's ops.yaml, legacy_ops.yaml,
sparse_ops.yaml, static_ops.yaml and fused_ops.yaml)."""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass

from ..core.dispatch import apply

__all__ = ["OpDef", "OPS", "register", "defop", "op_coverage"]


@dataclass
class OpDef:
    name: str
    fn: object
    category: str = "core"


OPS: dict[str, OpDef] = {}


def register(name=None, category="core"):
    """Register an already-built eager op under ``name`` (default: the
    function's name)."""

    def deco(fn):
        OPS[name or fn.__name__] = OpDef(name or fn.__name__, fn, category)
        return fn

    return deco


def defop(name, category="core"):
    """Build and register an eager op from a body over torch tensors: the
    body runs inside :func:`core.dispatch.apply`."""

    def deco(body):
        @functools.wraps(body)
        def op(*args, **kwargs):
            return apply(body, *args, op_name=name, **kwargs)

        OPS[name] = OpDef(name, op, category)
        return op

    return deco


# reference ops that mean nothing on this stack (hardware codecs, the
# graph-sampling suite, SelectedRows plumbing, XPU lowerings): reported,
# not hidden; the JAX package's list
NOT_APPLICABLE = {
    "decode_jpeg", "npu_identity", "merge_selected_rows", "reindex_graph",
    "send_u_recv", "send_ue_recv", "send_uv", "weighted_sample_neighbors",
    "static.decode_jpeg", "static.share_buffer", "fused.add_act_xpu",
    "fused.conv2d_xpu", "fused.embedding_with_eltwise_add_xpu",
    "fused.fc_xpu", "fused.fused_multi_transformer_xpu",
    "fused.generate_sequence_xpu", "fused.multi_encoder_xpu",
    "fused.yolo_box_xpu",
}
# static_ops.yaml names whose capability is registered under another name
_STATIC_ALIASES = {"assign_value": "assign", "tril_triu": "tril",
                   "gaussian": "randn", "exponential_": "exponential",
                   "truncated_gaussian_random": "truncated_normal",
                   "pool2d": "max_pool2d", "pool3d": "max_pool3d",
                   "unpool": "max_unpool2d"}


# collective / pipeline static ops: covered by the verbs of
# ``distributed.collective`` (the JAX package's ``_STATIC_COLLECTIVES``)
_STATIC_COLLECTIVES = {
    "all_gather", "all_reduce", "broadcast", "reduce", "reduce_scatter",
    "p_recv", "p_recv_array", "p_send", "p_send_array",
}


def _collective_covered(name):
    from ..distributed import collective

    base = name.replace("p_recv", "recv").replace("p_send", "send")
    base = base.removesuffix("_array")
    return hasattr(collective, base) or hasattr(collective, name)


def _registered(name):
    return name in OPS or name.rstrip("_") in OPS


def _covered(name):
    if name.startswith("sparse."):
        return False            # no sparse tensors in the port yet
    if name.startswith("fused."):
        return name[len("fused."):] in OPS
    if name.startswith("static."):
        base = name[len("static."):]
        alias = _STATIC_ALIASES.get(base)
        if _registered(base) or (alias is not None and _registered(alias)):
            return True
        return base in _STATIC_COLLECTIVES and _collective_covered(base)
    return _registered(name)


@functools.lru_cache(maxsize=1)
def _reference_ops():
    path = os.path.join(os.path.dirname(__file__), "reference_ops.txt")
    with open(path) as f:
        return tuple(line.strip() for line in f
                     if line.strip() and not line.startswith("#"))


def op_coverage():
    """Coverage of the port's registry against the reference's op
    inventory, by the JAX package's rules (an in-place ``op_`` counts as
    its functional form)."""
    applicable = [n for n in _reference_ops() if n not in NOT_APPLICABLE]
    covered = [n for n in applicable if _covered(n)]
    missing = [n for n in applicable if not _covered(n)]
    return {"total": len(applicable), "covered": len(covered),
            "pct": len(covered) / len(applicable), "missing": missing,
            "not_applicable": sorted(NOT_APPLICABLE),
            "registered": len(OPS)}
