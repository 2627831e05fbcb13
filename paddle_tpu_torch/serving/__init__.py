from .engine import STATS_KEYS, LLMEngine, naive_generate
from .kv_cache import (SCRATCH_BLOCK, BlockAllocator, DenseKVCache,
                       PagedCacheView, PagedKVCache)
from .scheduler import (DeadlineExceeded, EngineClosed, PreemptionStorm,
                        QueueFull, Request, RequestState, SamplingParams,
                        Scheduler)
from .tenancy import AuthError, FairQueue, Tenant, TenantRegistry, TokenBucket
from .workload import (ClosedLoopRunner, OpenLoopRunner, Workload,
                       WorkloadError, WorkloadRequest, WorkloadSpec)

__all__ = ["LLMEngine", "naive_generate", "STATS_KEYS", "BlockAllocator",
           "PagedKVCache", "PagedCacheView", "DenseKVCache", "SCRATCH_BLOCK",
           "SamplingParams", "Request", "RequestState", "Scheduler",
           "EngineClosed", "QueueFull", "DeadlineExceeded", "PreemptionStorm",
           "Tenant", "TenantRegistry", "TokenBucket", "FairQueue",
           "AuthError", "WorkloadSpec", "WorkloadRequest", "Workload",
           "WorkloadError", "OpenLoopRunner", "ClosedLoopRunner"]
