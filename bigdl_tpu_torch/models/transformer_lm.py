"""Transformer language model (counterpart of
``bigdl_tpu/models/transformer_lm.py``)."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..nn.attention import Transformer


def TransformerLM(vocab_size: int = 32000, hidden_size: int = 512,
                  num_heads: int = 8, filter_size: int = 2048,
                  num_layers: int = 6, dropout: float = 0.0,
                  max_len: int = 2048, use_flash: bool = True,
                  remat: bool = False, num_kv_heads=None,
                  pos_encoding: str = "sinusoidal",
                  ffn_activation: str = "relu", device=None, seed: int = 0):
    """Decoder-only LM. ``num_kv_heads < num_heads`` is grouped-query
    attention; ``pos_encoding='rope'`` uses rotary embeddings. ``dropout``
    sets the attention, relu and (never applied, as in the JAX package)
    postprocess dropout; ``remat`` recomputes each block in the backward.
    ``device`` defaults to the CUDA device (raises without one; pass
    ``'cpu'`` for the CPU)."""
    return Transformer(vocab_size=vocab_size, hidden_size=hidden_size,
                       num_heads=num_heads, filter_size=filter_size,
                       num_hidden_layers=num_layers,
                       postprocess_dropout=dropout,
                       attention_dropout=dropout, relu_dropout=dropout,
                       mode="lm", max_len=max_len, use_flash=use_flash,
                       remat=remat, num_kv_heads=num_kv_heads,
                       pos_encoding=pos_encoding,
                       ffn_activation=ffn_activation, device=device,
                       seed=seed)


def _chunk_loss(hx, embf, yx, padding_value: int):
    """(sum of -log p(target), count of valid targets) over one chunk; the
    (B, chunk, V) logits are float32 (bf16 operands are exact in float32,
    so this is JAX's f32-accumulated product with f32 output)."""
    logits = hx.float() @ embf.T
    lse = torch.logsumexp(logits, -1)
    idx = yx.clamp(0, logits.shape[-1] - 1)
    gold = logits.gather(-1, idx[..., None])[..., 0]
    valid = (yx != padding_value).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def lm_loss_chunked(h, embed, targets, chunk: int = 128,
                    padding_value: int = 0):
    """Tied-projection softmax cross-entropy over hidden states without
    materialising the full (B, T, vocab) logits: the sequence is cut into
    chunks (the largest divisor of T that is <= ``chunk``) and each chunk's
    float32 logits are built under ``torch.utils.checkpoint``, so forward
    and backward hold one (B, chunk, vocab) block at a time.

    h: (B, T, H) hidden states; embed: (vocab, H) tied embedding; targets:
    (B, T) RAW token ids (0-based embedding rows; ``padding_value`` entries
    are ignored). Returns the mean over valid positions (float32 scalar)."""
    B, T, H = h.shape
    if T % chunk != 0:
        chunk = next(c for c in range(min(chunk, T), 0, -1) if T % c == 0)
    y = torch.as_tensor(targets, device=h.device).long()
    embf = embed.float()        # one upcast shared by every chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, T, chunk):
        ls, c = checkpoint(_chunk_loss, h[:, s:s + chunk], embf,
                           y[:, s:s + chunk], padding_value,
                           use_reentrant=False, preserve_rng_state=False)
        total = total + ls
        count = count + c
    return total / count.clamp(min=1.0)
