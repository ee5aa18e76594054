from .flash import flash_attention, flash_chunk_attention, paged_attention
from .moe import top1_routing

__all__ = ["flash_attention", "flash_chunk_attention", "paged_attention",
           "top1_routing"]
