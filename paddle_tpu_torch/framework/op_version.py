"""Op-version / program-compat registry (counterpart of
``paddle_tpu/framework/op_version.py``; Paddle's
``paddle/fluid/framework/op_version_registry.h``).

Exported programs (``jit.save``, ``static.save_inference_model``) carry a
``.pdversion`` JSON sidecar: the framework version, the serialization IR
and the op-version table. :func:`check_compat` accepts artifacts whose op
versions are at most the live registry's and refuses newer ones, as
Paddle's ``IsProgramVersionSupported`` does. The port's IR is a
``torch.export`` archive; a sidecar naming the JAX package's
(``stablehlo+jax.export``) is refused with a message saying that the
program is StableHLO (its ``.pdiparams`` still load through
``jit.load(prefix, layer_cls=...)``).
"""
from __future__ import annotations

import json
import os

__all__ = [
    "FRAMEWORK_VERSION", "IR", "register_op_version", "op_version",
    "version_snapshot", "write_version_file", "read_version_file",
    "check_compat",
]

FRAMEWORK_VERSION = "0.5.0"
IR = "torch.export"
_JAX_IR = "stablehlo+jax.export"

# op -> (version, changelog); the JAX package's history, whose semantics
# the port implements
_REGISTRY: dict[str, tuple[int, str]] = {}


def register_op_version(op: str, version: int, note: str):
    cur = _REGISTRY.get(op, (0, ""))[0]
    if version <= cur:
        raise ValueError(
            f"op_version({op!r}): new version {version} must exceed {cur}")
    _REGISTRY[op] = (version, note)


def op_version(op: str) -> int:
    return _REGISTRY.get(op, (0, ""))[0]


register_op_version(
    "flash_attn_unpadded", 2,
    "real cu_seqlens varlen kernel; version 1 aliased the padded path")
register_op_version(
    "max_pool2d_with_index", 2,
    "returns real argmax indices into the flattened input plane; version 1 "
    "returned the pooled values only")
register_op_version(
    "reduce", 2,
    "rank-asymmetric dst semantics (non-dst ranks keep their input); "
    "version 1 broadcast the reduction to every rank")
register_op_version(
    "dropout", 2, "eval-mode downscale_in_infer honored; version 1 ignored "
    "mode")


def version_snapshot() -> dict:
    return {
        "framework_version": FRAMEWORK_VERSION,
        "ir": IR,
        "op_versions": {k: v for k, (v, _) in _REGISTRY.items()},
    }


def write_version_file(path_prefix: str):
    """The sidecar next to the artifact: ``<prefix>.pdversion``."""
    with open(path_prefix + ".pdversion", "w") as f:
        json.dump(version_snapshot(), f, indent=1)


def read_version_file(path_prefix: str) -> dict | None:
    p = path_prefix + ".pdversion"
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def check_compat(meta: dict | None, origin: str = "artifact"):
    """Raise if the artifact is not a ``torch.export`` program or claims
    newer op semantics than this build has; an artifact without a sidecar
    is tolerated (``torch.export.load`` checks its own format)."""
    if meta is None:
        return
    ir = meta.get("ir")
    if ir == _JAX_IR:
        raise RuntimeError(
            f"{origin}: the program is StableHLO ({ir!r}, written by the "
            f"JAX package's jit.save), which this package cannot run; it "
            f"loads {IR!r} programs. The weights load into a layer: "
            f"jit.load(prefix, layer_cls=...)")
    if ir not in (None, IR):
        raise RuntimeError(
            f"{origin}: serialized with IR {ir!r}; this build loads {IR!r}")
    newer = {op: v for op, v in (meta.get("op_versions") or {}).items()
             if v > op_version(op)}
    if newer:
        detail = {k: f"artifact v{v} > runtime v{op_version(k)}"
                  for k, v in newer.items()}
        raise RuntimeError(
            f"{origin}: built against newer op semantics than this "
            f"framework provides: {detail}. Upgrade paddle_tpu_torch or "
            f"re-export the model.")
