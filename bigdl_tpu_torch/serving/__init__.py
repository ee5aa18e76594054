from .batching import DeadlineExceeded, EngineStopped, QueueFull, ServeFuture
from .decode_scheduler import (DecodeScheduler, LMRequest,
                               decode_scheduler_threads_alive,
                               prefill_padded_end, prefill_schedule)
from .kv_cache import KVCacheOOM, PagedKVCache, blocks_for_tokens
from .registry import ModelRegistry, ModelVersion

__all__ = ["DeadlineExceeded", "EngineStopped", "QueueFull", "ServeFuture",
           "DecodeScheduler", "LMRequest", "decode_scheduler_threads_alive",
           "prefill_padded_end", "prefill_schedule", "KVCacheOOM",
           "PagedKVCache", "blocks_for_tokens", "ModelRegistry",
           "ModelVersion"]
