from .batching import DeadlineExceeded, EngineStopped, QueueFull, ServeFuture
from .decode_scheduler import (DecodeScheduler, LMRequest,
                               decode_scheduler_threads_alive,
                               prefill_padded_end, prefill_schedule)
from .kv_cache import (HostKVPool, HostPoolOOM, KVCacheOOM, KVSwapManager,
                       PagedKVCache, blocks_for_tokens,
                       kv_swap_threads_alive)
from .prefix_cache import PrefixCache, chain_keys
from .registry import ModelRegistry, ModelVersion

__all__ = ["DeadlineExceeded", "EngineStopped", "QueueFull", "ServeFuture",
           "DecodeScheduler", "LMRequest", "decode_scheduler_threads_alive",
           "prefill_padded_end", "prefill_schedule", "HostKVPool",
           "HostPoolOOM", "KVCacheOOM", "KVSwapManager", "PagedKVCache",
           "blocks_for_tokens", "kv_swap_threads_alive", "PrefixCache",
           "chain_keys", "ModelRegistry", "ModelVersion"]
