from .flash import flash_attention, flash_chunk_attention, paged_attention

__all__ = ["flash_attention", "flash_chunk_attention", "paged_attention"]
