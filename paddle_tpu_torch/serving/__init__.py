from .engine import LLMEngine, naive_generate
from .kv_cache import (SCRATCH_BLOCK, BlockAllocator, DenseKVCache,
                       PagedCacheView, PagedKVCache)
from .scheduler import (EngineClosed, PreemptionStorm, QueueFull, Request,
                        RequestState, SamplingParams, Scheduler)

__all__ = ["LLMEngine", "naive_generate", "BlockAllocator", "PagedKVCache",
           "PagedCacheView", "DenseKVCache", "SCRATCH_BLOCK", "SamplingParams",
           "Request", "RequestState", "Scheduler", "EngineClosed", "QueueFull",
           "PreemptionStorm"]
