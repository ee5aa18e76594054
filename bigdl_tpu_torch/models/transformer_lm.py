"""Transformer language model (counterpart of
``bigdl_tpu/models/transformer_lm.py``)."""
from __future__ import annotations

from ..nn.attention import Transformer


def TransformerLM(vocab_size: int = 32000, hidden_size: int = 512,
                  num_heads: int = 8, filter_size: int = 2048,
                  num_layers: int = 6, max_len: int = 2048,
                  use_flash: bool = True, num_kv_heads=None,
                  pos_encoding: str = "sinusoidal",
                  ffn_activation: str = "relu", device=None, seed: int = 0):
    """Decoder-only LM. ``num_kv_heads < num_heads`` is grouped-query
    attention; ``pos_encoding='rope'`` uses rotary embeddings. ``device``
    defaults to the CUDA device (raises without one; pass ``'cpu'`` for
    the CPU)."""
    return Transformer(vocab_size=vocab_size, hidden_size=hidden_size,
                       num_heads=num_heads, filter_size=filter_size,
                       num_hidden_layers=num_layers, mode="lm",
                       max_len=max_len, use_flash=use_flash,
                       num_kv_heads=num_kv_heads, pos_encoding=pos_encoding,
                       ffn_activation=ffn_activation, device=device,
                       seed=seed)
