"""paddle_tpu_torch.distributed — ``paddle.distributed`` over
``torch.distributed``, one process per rank (counterpart of
``paddle_tpu/distributed/``): the hybrid mesh and its groups
(``mesh``), the environment and data parallel (``parallel``), the eager
collectives (``collective``), ``spawn`` and the ``launch`` CLI, the fleet
facade, the TP RNG tracker, recompute, the tensor-parallel layers, ZeRO
(``sharding``, ``engine``), the pipeline schedules, ring / Ulysses
attention, MoE and sharded checkpoints, with the rendezvous store
(``tcp_store.py``). The reference's ``auto_parallel``, ``auto_tuner``,
``cost_model``, ``elastic``, ``ps`` and ``rpc`` are still to come
(ROADMAP Queue 1)."""
from . import collective, fleet, sharding  # noqa: F401
from .checkpoint import (  # noqa: F401
    Checkpoint,
    CheckpointCorrupt,
    DistributedSaver,
    load_distributed_checkpoint,
    save_distributed_checkpoint,
)
from .collective import (  # noqa: F401
    CollectiveTimeoutError,
    ReduceOp,
    all_gather,
    all_reduce,
    all_to_all,
    alltoall,
    barrier,
    broadcast,
    get_group,
    new_group,
    ppermute,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    shard_to_group,
    unshard,
)
from .engine import DistributedEngine  # noqa: F401
from .fleet_random import (  # noqa: F401
    MODEL_PARALLEL_RNG, RNGStatesTracker, get_rng_state_tracker,
    model_parallel_random_seed)
from .mesh import (  # noqa: F401
    HybridCommunicateGroup,
    P,
    build_mesh,
    current_mesh,
    get_hybrid_communicate_group,
    set_hybrid_communicate_group,
)
from .moe import MoELayer  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    mark_sharding,
)
from .parallel import (  # noqa: F401
    DataParallel,
    ParallelEnv,
    get_rank,
    get_world_size,
    init_parallel_env,
)
from .pipeline import (  # noqa: F401
    LayerDesc,
    PipelineLayer,
    SharedLayerDesc,
    spmd_pipeline,
    stack_stage_params,
)
from .recompute import recompute, recompute_sequential  # noqa: F401
from .sequence_parallel import ring_attention, ulysses_attention  # noqa: F401
from .spawn import MultiprocessContext, spawn  # noqa: F401
from .strategy import DistributedStrategy  # noqa: F401
from .tcp_store import StoreCorruptValue, StoreTimeout, TCPStore  # noqa: F401

__all__ = [
    "init_parallel_env", "spawn", "MultiprocessContext", "get_rank",
    "get_world_size", "ParallelEnv", "DataParallel",
    "ReduceOp", "all_reduce", "all_gather", "reduce_scatter", "broadcast",
    "all_to_all", "alltoall", "reduce", "scatter", "barrier", "send", "recv",
    "ppermute", "new_group", "get_group", "shard_to_group", "unshard",
    "CollectiveTimeoutError",
    "DistributedStrategy", "HybridCommunicateGroup", "build_mesh", "P",
    "current_mesh", "get_hybrid_communicate_group",
    "set_hybrid_communicate_group",
    "DistributedEngine", "fleet", "collective", "sharding",
    "DistributedSaver", "Checkpoint", "CheckpointCorrupt",
    "save_distributed_checkpoint", "load_distributed_checkpoint",
    "TCPStore", "StoreTimeout", "StoreCorruptValue",
    "VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
    "ParallelCrossEntropy", "mark_sharding", "MoELayer",
    "RNGStatesTracker", "get_rng_state_tracker", "model_parallel_random_seed",
    "MODEL_PARALLEL_RNG", "LayerDesc", "SharedLayerDesc", "PipelineLayer",
    "spmd_pipeline", "stack_stage_params", "recompute",
    "recompute_sequential", "ring_attention", "ulysses_attention",
]
