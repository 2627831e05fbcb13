"""paddle_tpu_torch.serving — continuous-batching LLM serving (counterpart
of ``paddle_tpu/serving``): the engine, scheduler and paged KV cache, and
above them the fleet plane — :mod:`.router` (``FleetRouter`` over
``LocalReplica`` threads or SIGKILL-able ``ProcReplica`` children),
:mod:`.gateway` (the HTTP front door with its write-ahead
:mod:`.journal`), :mod:`.kv_fabric` (the fleet's prefix directory over the
``TCPStore`` and cross-replica KV migration), :mod:`.tenancy`,
:mod:`.autoscaler` and :mod:`.workload`; :mod:`.remediation`,
:mod:`.rollout` and :mod:`.soak` are imported by name."""
from . import kv_fabric  # noqa: F401
from .autoscaler import Autoscaler  # noqa: F401
from .engine import STATS_KEYS, LLMEngine, naive_generate
from .gateway import Gateway  # noqa: F401
from .journal import Journal, JournalError, JournalTornWrite  # noqa: F401
from .kv_cache import (SCRATCH_BLOCK, BlockAllocator, DenseKVCache,
                       PagedCacheView, PagedKVCache)
from .router import (CircuitBreaker, FleetRouter, LocalReplica,  # noqa: F401
                     NoHealthyReplica, ProcReplica, ReplicaState,
                     RouterRequest, RouterShed)
from .scheduler import (DeadlineExceeded, EngineClosed, PreemptionStorm,
                        QueueFull, Request, RequestState, SamplingParams,
                        Scheduler)
from .tenancy import AuthError, FairQueue, Tenant, TenantRegistry, TokenBucket
from .workload import (ClosedLoopRunner, OpenLoopRunner, Workload,
                       WorkloadError, WorkloadRequest, WorkloadSpec)

__all__ = ["LLMEngine", "naive_generate", "STATS_KEYS", "BlockAllocator",
           "PagedKVCache", "PagedCacheView", "DenseKVCache", "SCRATCH_BLOCK",
           "Request", "RequestState", "SamplingParams", "Scheduler",
           "EngineClosed", "QueueFull", "DeadlineExceeded", "PreemptionStorm",
           "FleetRouter", "LocalReplica", "ProcReplica", "ReplicaState",
           "RouterRequest", "RouterShed", "NoHealthyReplica", "Gateway",
           "CircuitBreaker", "Journal", "JournalError", "JournalTornWrite",
           "kv_fabric",
           "Tenant", "TenantRegistry", "TokenBucket", "FairQueue",
           "AuthError", "Autoscaler",
           "WorkloadSpec", "WorkloadRequest", "Workload", "WorkloadError",
           "OpenLoopRunner", "ClosedLoopRunner"]
