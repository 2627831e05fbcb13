"""``paddle.distributed.sharding`` — the ``group_sharded_parallel`` facade
(counterpart of ``paddle_tpu/distributed/sharding.py``; Paddle's
``sharding/group_sharded.py``: levels ``os``, ``os_g``, ``p_g_os``, host
offload).

As in the reference, ZeRO is the engine's layout rather than a wrapper
object: this sets the stage, the offload tier and the sharding degree on
the ambient fleet strategy, and an ``engine.DistributedEngine`` (or a
``hapi.Model``) built after the call trains group-sharded. The model,
optimizer and scaler come back as they went in.
"""
from __future__ import annotations

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """Configure ZeRO stage ``level`` (``"os"`` | ``"os_g"`` |
    ``"p_g_os"``) and optional host offload on the fleet strategy; the
    data-parallel ranks fold into the sharding axis. Returns (model,
    optimizer, scaler). The buffer and segment sizes are taken for
    Paddle's signature."""
    if level not in _LEVELS:
        raise ValueError(
            f"level must be one of {sorted(_LEVELS)}, got {level!r}")
    from . import fleet
    from .strategy import DistributedStrategy

    strategy = fleet.get_strategy() or DistributedStrategy()
    fleet.init(is_collective=True, strategy=strategy)
    h = strategy.hybrid_configs
    if h.sharding_degree == 1 and h.dp_degree > 1:
        h.sharding_degree, h.dp_degree = h.dp_degree, 1
    strategy.sharding.stage = _LEVELS[level]
    strategy.sharding.offload = bool(offload)
    fleet.init(is_collective=True, strategy=strategy)
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Save the (re-assembled) model and optimizer state: an engine's
    state is synced back to the layer first."""
    import os

    from ..framework import io as fio

    eng = getattr(model, "_engine", None)
    if eng is not None:
        eng.sync_to_layer()
    net = getattr(model, "network", model)
    os.makedirs(output, exist_ok=True)
    fio.save(net.state_dict(), os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        fio.save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
