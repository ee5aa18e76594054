from .batching import (DeadlineExceeded, EngineStopped, QueueFull, Request,
                       ServeFuture, assemble)
from .decode_scheduler import (DecodeScheduler, LMRequest,
                               decode_scheduler_threads_alive,
                               prefill_padded_end, prefill_schedule)
from .engine import ServingEngine, serving_threads_alive
from .kv_cache import (HostKVPool, HostPoolOOM, KVCacheOOM, KVSwapManager,
                       PagedKVCache, blocks_for_tokens,
                       kv_swap_threads_alive)
from .prefix_cache import PrefixCache, chain_keys
from .registry import ModelRegistry, ModelVersion
from .router import PriorityClass, Router, router_threads_alive

__all__ = ["DeadlineExceeded", "EngineStopped", "QueueFull", "Request",
           "ServeFuture", "assemble", "DecodeScheduler", "LMRequest",
           "decode_scheduler_threads_alive", "prefill_padded_end",
           "prefill_schedule", "ServingEngine", "serving_threads_alive",
           "HostKVPool", "HostPoolOOM", "KVCacheOOM", "KVSwapManager",
           "PagedKVCache", "blocks_for_tokens", "kv_swap_threads_alive",
           "PrefixCache", "chain_keys", "ModelRegistry", "ModelVersion",
           "PriorityClass", "Router", "router_threads_alive"]
