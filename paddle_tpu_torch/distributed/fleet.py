"""Fleet facade (counterpart of ``paddle_tpu/distributed/fleet.py``;
Paddle's ``fleet.init`` / ``distributed_model`` /
``distributed_optimizer``)."""
from __future__ import annotations

from .mesh import get_hybrid_communicate_group
from .parallel import DataParallel, get_rank, get_world_size, \
    init_parallel_env
from .strategy import DistributedStrategy

__all__ = [
    "init", "distributed_model", "distributed_optimizer",
    "get_hybrid_communicate_group", "worker_index", "worker_num",
    "is_first_worker", "DistributedStrategy", "get_strategy",
]

_strategy: DistributedStrategy | None = None


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO", device=None):
    """Join the process group (``init_parallel_env``) and install the
    hybrid mesh of ``strategy``; a strategy of one rank in a larger world
    puts every rank on data parallel, as Paddle does. Returns the HCG."""
    global _strategy
    _strategy = strategy or DistributedStrategy()
    world = get_world_size()
    if _strategy.world_degree == 1 and world > 1:
        _strategy.hybrid_configs.dp_degree = world
    init_parallel_env(_strategy, device=device)
    return get_hybrid_communicate_group()


def get_strategy() -> DistributedStrategy | None:
    return _strategy


def distributed_model(model):
    """Pure data parallel (dp > 1, mp = pp = 1) wraps ``model`` in
    :class:`DataParallel`; tensor-parallel layers bring their own
    collectives, and pipelines are built by their trainers, so any other
    topology returns ``model`` as it is."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        init()
        hcg = get_hybrid_communicate_group()
    if hcg.get_data_parallel_world_size() > 1 and \
            hcg.get_model_parallel_world_size() == 1 and \
            hcg.get_pipe_parallel_world_size() == 1:
        return DataParallel(model)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer as it is: the data-parallel gradients arrive averaged
    (``DataParallel``), and sharded optimizer state is the engine's
    (``engine.DistributedEngine``)."""
    return optimizer


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def is_first_worker():
    return get_rank() == 0
