"""Attention and the decoder-only Transformer (counterpart of
``bigdl_tpu/nn/attention.py``, LM mode).

The model code is written as functions of a parameter tree (``params``,
the nested dict of :attr:`Module.params`) as in the JAX package, so one
model object serves several weight versions. Self-attention over a whole
sequence goes through the flash kernel (``parallel.flash``), cached
attention over a paged pool through the paged kernel; dense cached decode
of fewer than 8 positions uses the plain einsum, as the JAX package does.

Unlike JAX's functional arrays, the dense KV caches and the paged KV pools
are updated IN PLACE: ``decode_chunk`` writes into the cache tensors it is
given and ``decode_paged`` scatters into the pages with ``index_put_``;
both return the same tensors for symmetry with the JAX signatures.

The training forward (``hidden_states`` and ``call`` with ``training`` and
a dropout ``generator``; ``forward``) is differentiable; self-attention
there goes through the flash ``autograd.Function`` (K1-fwd forward, K1-bwd
backward). Every cached inference entry point (``prefill``, the decode
steps, ``generate``) runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.paged_attention import paged_attention_reference
from ..parallel.flash import (flash_attention, flash_chunk_attention,
                              paged_attention)
from ..utils.engine import refuse_unported, resolve_device
from .module import Module
from .norm import LayerNormalization


def _glorot(gen, shape):
    fan_in, fan_out = shape[0], shape[-1]
    s = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-s, s, generator=gen)


def rotary_embedding(x, positions, base: float = 10000.0):
    """Rotary position embedding (rotate-half). x: (..., T, D), D even;
    positions: (T,) shared or (B, T) per row for x of shape (B, H, T, D)."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE needs an even head dim, got {d}")
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    pos = positions.to(device=x.device, dtype=torch.float32)
    if pos.dim() == 2:
        ang = pos[..., None] * freqs                     # (B, T, half)
        cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    else:
        ang = pos[:, None] * freqs[None, :]
        cos, sin = ang.cos(), ang.sin()                  # (T, half)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def dropout(x, p: float, generator):
    """Inverted dropout: each element kept with probability 1 - p (drawn
    from ``generator``, on x's device) and scaled by 1 / (1 - p)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def dot_product_attention(q, k, v, mask=None, dropout_p: float = 0.0,
                          generator=None, training: bool = False):
    """q, k, v: (B, H, T, D); mask additive (broadcastable) or None.
    Computes in float32, returns q's dtype. With ``training``, ``dropout_p
    > 0`` and a ``generator``, the attention weights are dropped out (as
    the JAX package does with an rng)."""
    d = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1)
    if training and dropout_p > 0.0 and generator is not None:
        w = dropout(w, dropout_p, generator)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def causal_mask(t, dtype=torch.float32, device=None):
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
    return torch.where(keep, 0.0, -1e9).to(dtype)[None, None]


def position_encoding(length, hidden_size, dtype=torch.float32,
                      device=None):
    """Sinusoidal PE (computed in float64 with numpy, as the JAX package
    does, then cast)."""
    pos = np.arange(length)[:, None].astype(np.float64)
    dim = np.arange(hidden_size // 2)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * dim / hidden_size)
    pe = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


def embed_ids(embed, ids, hidden_size, with_pe: bool = True):
    """Token embedding * sqrt(hidden) + sinusoidal PE cast to the
    embedding dtype (an f32 PE would promote every bf16 activation)."""
    return _embed_ids(embed, ids, hidden_size, with_pe)


def _embed_ids(embed, ids, hidden_size, with_pe: bool = True, pe=None):
    """:func:`embed_ids` with ``pe`` a precomputed (>= T, H) table (the
    model's cache), or None to compute it."""
    h = embed[ids.long()] * math.sqrt(hidden_size)
    if not with_pe:
        return h
    t = ids.shape[1]
    if pe is None:
        pe = position_encoding(t, hidden_size, h.dtype, h.device)
    return h + pe[:t].to(h.dtype)


class Attention(Module):
    """Multi-head self-attention with optional grouped-query K/V heads
    (``num_kv_heads``) and rotary embeddings. ``attention_dropout`` drops
    attention weights in training (then the einsum path runs instead of
    flash, as in the JAX package). Sequence parallelism (``seq_axis``,
    ``seq_impl``) is not ported. ``generator`` seeds the weights."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attention_dropout: float = 0.0, use_flash: bool = True,
                 seq_axis=None, causal: bool = False, seq_impl: str = "ring",
                 num_kv_heads=None, rope: bool = False, name=None,
                 generator=None):
        super().__init__(name=name)
        refuse_unported("Attention", seq_axis=(seq_axis, None),
                        seq_impl=(seq_impl, "ring"))
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} not a multiple of "
                             f"num_heads {num_heads}")
        if rope and (hidden_size // num_heads) % 2:
            raise ValueError("RoPE needs an even head dim")
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise ValueError(f"num_kv_heads ({num_kv_heads}) must divide "
                             f"num_heads ({num_heads})")
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.use_flash, self.causal = use_flash, causal
        self.num_kv_heads, self.rope = num_kv_heads, rope
        self.attention_dropout = attention_dropout
        H = hidden_size
        kvd = self._kvh() * (H // num_heads)
        P = torch.nn.Parameter
        self.wq = P(_glorot(generator, (H, H)))
        self.wk = P(_glorot(generator, (H, kvd)))
        self.wv = P(_glorot(generator, (H, kvd)))
        self.wo = P(_glorot(generator, (H, H)))

    def _kvh(self):
        return self.num_kv_heads or self.num_heads

    def _split(self, x, heads=None):
        b, t, _ = x.shape
        return x.reshape(b, t, heads or self.num_heads, -1).transpose(1, 2)

    def qkv(self, params, x):
        """Query (B, nH, T, D) and key/value (B, kvH, T, D) heads. Three
        matmuls; the JAX package fuses them into one over concatenated
        weights, which in eager PyTorch would copy the weights every
        call."""
        kvh = self._kvh()
        return (self._split(x @ params["wq"]),
                self._split(x @ params["wk"], kvh),
                self._split(x @ params["wv"], kvh))

    def _expand_kv(self, k, v):
        g = self.num_heads // self._kvh()
        if g == 1:
            return k, v
        return (k.repeat_interleave(g, dim=1).contiguous(),
                v.repeat_interleave(g, dim=1).contiguous())

    def _merge(self, o, params):
        b, h, t, d = o.shape
        return o.transpose(1, 2).reshape(b, t, h * d) @ params["wo"]

    def decode_chunk(self, params, x, k_cache, v_cache, pos: int):
        """S cached positions: project x (B, S, H), write K/V into the
        dense caches (B, kvH, Tmax, D) IN PLACE at pos..pos+S-1, attend
        causal-within-chunk plus everything before. Returns
        (out (B, S, H), k_cache, v_cache)."""
        q, k_t, v_t = self.qkv(params, x)
        S = q.shape[2]
        if self.rope:
            p = pos + torch.arange(S, device=x.device)
            q = rotary_embedding(q, p)
            k_t = rotary_embedding(k_t, p)   # the cache holds rotated K
        k_cache[:, :, pos:pos + S] = k_t.to(k_cache.dtype)
        v_cache[:, :, pos:pos + S] = v_t.to(v_cache.dtype)
        groups = self.num_heads // self._kvh()
        if groups == 1 and self.use_flash and S >= 8:
            o = flash_chunk_attention(q.contiguous(), k_cache, v_cache,
                                      q_offset=pos, kv_len=pos + S)
            return self._merge(o, params), k_cache, v_cache
        t = k_cache.shape[2]
        keep = (torch.arange(t, device=x.device)[None, :]
                <= (pos + torch.arange(S, device=x.device))[:, None])
        b, h, _, dd = q.shape
        qg = q.float().reshape(b, h // groups, groups, S, dd)
        logits = torch.einsum("bkgsd,bktd->bkgst", qg,
                              k_cache.float()) / math.sqrt(dd)
        logits = logits.masked_fill(~keep, float("-inf"))
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bkgst,bktd->bkgsd", w, v_cache.float())
        o = o.reshape(b, h, S, dd).to(q.dtype)
        return self._merge(o, params), k_cache, v_cache

    def decode_paged(self, params, x, k_pages, v_pages, block_tables,
                     positions):
        """Cached attention over a PAGED KV pool with per-row positions.
        x (B, S, H) lands at ``positions[b]..positions[b]+S-1``;
        k_pages/v_pages (num_blocks, kvH, block_size, D); block_tables
        (B, max_blocks) int32 (0 = the null block); positions (B,) int32.
        Scatters the S new K/V rows into the pages IN PLACE through the
        tables, then attends through the paged kernel (whose plain version,
        ``kernels.paged_attention.paged_attention_reference``, is the JAX
        package's ``_paged_gather_attend``). Returns
        (out (B, S, H), k_pages, v_pages)."""
        q, k_t, v_t = self.qkv(params, x)
        S = x.shape[1]
        pos_s = positions.long()[:, None] + torch.arange(S, device=x.device)
        if self.rope:
            q = rotary_embedding(q, pos_s)
            k_t = rotary_embedding(k_t, pos_s)   # pages hold rotated K
        bs = k_pages.shape[2]
        blk = block_tables.long().gather(1, pos_s // bs)     # (B, S)
        off = pos_s % bs
        # (B, kvH, S, D) -> (B, S, kvH, D) rows; duplicate targets only
        # occur between padded slots aimed at the null block
        k_pages[blk, :, off, :] = k_t.transpose(1, 2).to(k_pages.dtype)
        v_pages[blk, :, off, :] = v_t.transpose(1, 2).to(v_pages.dtype)
        o = paged_attention(
            q.contiguous(), k_pages, v_pages, block_tables, positions,
            lambda: paged_attention_reference(q, k_pages, v_pages,
                                              block_tables, positions))
        return self._merge(o, params), k_pages, v_pages

    def call(self, params, x, training: bool = False, generator=None):
        """Self-attention over x (B, T, H); causal when built so.
        Differentiable; dropout on the weights only with ``training`` and a
        ``generator``."""
        q, k, v = self.qkv(params, x)
        if self.rope:
            pos = torch.arange(q.shape[2], device=x.device)
            q = rotary_embedding(q, pos)
            k = rotary_embedding(k, pos)
        k, v = self._expand_kv(k, v)
        drop = (training and self.attention_dropout > 0.0
                and generator is not None)
        if self.causal and self.use_flash and not drop:
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
        else:
            mask = (causal_mask(q.shape[2], device=x.device) if self.causal
                    else None)
            o = dot_product_attention(q, k, v, mask, self.attention_dropout,
                                      generator, training)
        return self._merge(o, params)


class FeedForwardNetwork(Module):
    """Position-wise FFN: 'relu', 'gelu' (tanh form, as jax.nn.gelu) or
    'swiglu' (``(silu(x@w1 + b1) * (x@w3)) @ w2 + b2``). ``relu_dropout``
    drops the hidden activations in training."""

    def __init__(self, hidden_size: int, filter_size: int,
                 relu_dropout: float = 0.0, activation: str = "relu",
                 name=None, generator=None):
        super().__init__(name=name)
        if activation not in ("relu", "gelu", "swiglu"):
            raise ValueError(f"activation must be relu/gelu/swiglu, "
                             f"got {activation!r}")
        self.hidden_size, self.filter_size = hidden_size, filter_size
        self.activation = activation
        self.relu_dropout = relu_dropout
        P = torch.nn.Parameter
        self.w1 = P(_glorot(generator, (hidden_size, filter_size)))
        self.b1 = P(torch.zeros(filter_size))
        self.w2 = P(_glorot(generator, (filter_size, hidden_size)))
        self.b2 = P(torch.zeros(hidden_size))
        if activation == "swiglu":
            self.w3 = P(_glorot(generator, (hidden_size, filter_size)))

    def call(self, params, x, training: bool = False, generator=None):
        a = x @ params["w1"] + params["b1"]
        if self.activation == "swiglu":
            h = F.silu(a) * (x @ params["w3"])
        elif self.activation == "gelu":
            h = F.gelu(a, approximate="tanh")
        else:
            h = F.relu(a)
        if training and self.relu_dropout > 0.0 and generator is not None:
            h = dropout(h, self.relu_dropout, generator)
        return h @ params["w2"] + params["b2"]


class TransformerBlock(Module):
    """Pre-LN block: self-attention then FFN, each residual; causal only
    when asked (``causal=False``, JAX's default, attends both ways). The
    cross-attention sublayer (``with_cross``) is not ported."""

    def __init__(self, hidden_size: int, num_heads: int, filter_size: int,
                 attn_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 with_cross: bool = False, causal: bool = False,
                 use_flash: bool = True, num_kv_heads=None,
                 rope: bool = False, ffn_activation: str = "relu", name=None,
                 generator=None):
        super().__init__(name=name)
        refuse_unported("TransformerBlock", with_cross=(with_cross, False))
        self.attn = Attention(hidden_size, num_heads, use_flash=use_flash,
                              causal=causal, num_kv_heads=num_kv_heads,
                              rope=rope, generator=generator,
                              attention_dropout=attn_dropout)
        self.ffn = FeedForwardNetwork(hidden_size, filter_size,
                                      activation=ffn_activation,
                                      generator=generator,
                                      relu_dropout=ffn_dropout)
        self.ln1 = LayerNormalization(hidden_size)
        self.ln2 = LayerNormalization(hidden_size)

    def _ffn_sublayer(self, params, h, training=False, generator=None):
        return h + self.ffn.call(params["ffn"],
                                 self.ln2.call(params["ln2"], h),
                                 training, generator)

    def call(self, params, h, training: bool = False, generator=None):
        h = h + self.attn.call(params["attn"],
                               self.ln1.call(params["ln1"], h),
                               training, generator)
        return self._ffn_sublayer(params, h, training, generator)

    def prefill(self, params, h):
        """Causal forward over a whole prompt that also returns the
        compact (kvH) K/V heads for the decode cache: (h, (k, v))."""
        n = self.ln1.call(params["ln1"], h)
        q, k, v = self.attn.qkv(params["attn"], n)
        if self.attn.rope:
            pos = torch.arange(q.shape[2], device=h.device)
            q = rotary_embedding(q, pos)
            k = rotary_embedding(k, pos)
        ke, ve = self.attn._expand_kv(k, v)
        if self.attn.use_flash:
            o = flash_attention(q.contiguous(), ke.contiguous(),
                                ve.contiguous(), causal=True)
        else:
            o = dot_product_attention(q, ke, ve,
                                      causal_mask(q.shape[2],
                                                  device=h.device))
        h = h + self.attn._merge(o, params["attn"])
        return self._ffn_sublayer(params, h), (k, v)

    def decode_step(self, params, h_t, kv, pos: int):
        n = self.ln1.call(params["ln1"], h_t)
        a, k_cache, v_cache = self.attn.decode_chunk(params["attn"], n, kv[0],
                                                     kv[1], pos)
        return self._ffn_sublayer(params, h_t + a), (k_cache, v_cache)

    def decode_step_paged(self, params, h_t, k_pages, v_pages,
                          block_tables, positions):
        n = self.ln1.call(params["ln1"], h_t)
        a, k_pages, v_pages = self.attn.decode_paged(
            params["attn"], n, k_pages, v_pages, block_tables, positions)
        return self._ffn_sublayer(params, h_t + a), k_pages, v_pages


class Transformer(Module):
    """Decoder-only Transformer LM over token ids (``mode='lm'``; the
    translation mode is not ported yet). Returns logits over the vocab
    through the tied embedding.

    ``device``: where the weights live - a CUDA device by default, which
    raises when there is none; pass ``device='cpu'`` for the CPU.
    ``seed``: the weights are drawn from ``torch.Generator().manual_seed
    (seed)`` (glorot-uniform matrices, N(0, 0.02) embedding).
    ``attention_dropout`` / ``relu_dropout`` apply in training when a
    generator is given; ``postprocess_dropout`` is stored and never applied,
    exactly as in the JAX package. ``remat`` recomputes each block in the
    backward (``torch.utils.checkpoint``, the JAX package's
    ``jax.checkpoint``): activation memory drops to the block inputs."""

    def __init__(self, vocab_size: int, hidden_size: int = 256,
                 num_heads: int = 4, filter_size: int = 1024,
                 num_hidden_layers: int = 2, postprocess_dropout: float = 0.0,
                 attention_dropout: float = 0.0, relu_dropout: float = 0.0,
                 mode: str = "lm", max_len: int = 2048,
                 use_flash: bool = True, remat: bool = False,
                 num_kv_heads=None, pos_encoding: str = "sinusoidal",
                 ffn_activation: str = "relu", name=None, device=None,
                 seed: int = 0):
        super().__init__(name=name)
        if mode != "lm":
            raise NotImplementedError("only mode='lm' is ported")
        if pos_encoding not in ("sinusoidal", "rope"):
            raise ValueError(f"pos_encoding must be 'sinusoidal' or "
                             f"'rope', got {pos_encoding!r}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.vocab_size, self.hidden_size = vocab_size, hidden_size
        self.mode, self.max_len = mode, max_len
        self.dropout_p = postprocess_dropout
        self.remat = remat
        self.pos_encoding = pos_encoding
        self.embed = torch.nn.Parameter(
            0.02 * torch.randn((vocab_size, hidden_size), generator=gen))
        self.ln_f = LayerNormalization(hidden_size)
        blocks = []
        for i in range(num_hidden_layers):
            blk = TransformerBlock(hidden_size, num_heads, filter_size,
                                   causal=True, use_flash=use_flash,
                                   num_kv_heads=num_kv_heads,
                                   rope=(pos_encoding == "rope"),
                                   ffn_activation=ffn_activation,
                                   generator=gen,
                                   attn_dropout=attention_dropout,
                                   ffn_dropout=relu_dropout)
            self.add_module(f"block{i}", blk)
            blocks.append(blk)
        self.blocks = tuple(blocks)
        self._pe_cache = {}
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _pe(self, dtype):
        pe = self._pe_cache.get(dtype)
        if pe is None:
            pe = position_encoding(self.max_len, self.hidden_size, dtype,
                                   self.device)
            self._pe_cache[dtype] = pe
        return pe

    def _ids(self, ids):
        return torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids)
                               else ids, device=self.device).long()

    def _embed(self, params, ids):
        emb = params["embed"]
        return _embed_ids(emb, ids, self.hidden_size,
                          with_pe=self.pos_encoding != "rope",
                          pe=self._pe(emb.dtype))

    def _block(self, blk, params, h, training, generator):
        if not self.remat:
            return blk.call(params, h, training, generator)
        # checkpoint restores the global RNG states for the recomputation,
        # not a private generator's: each run of the block draws from a
        # copy of ``generator`` as it stood at the block's start (so the
        # backward's recomputation sees the same dropout masks), and the
        # caller's generator then moves on from where the first run ended
        start = None if generator is None else generator.get_state()
        end = {}

        def run(h):
            g = None
            if start is not None:
                g = torch.Generator(device=generator.device)
                g.set_state(start)
            out = blk.call(params, h, training, g)
            if g is not None:
                end["state"] = g.get_state()
            return out

        out = checkpoint(run, h, use_reentrant=False,
                         preserve_rng_state=False)
        if generator is not None:
            generator.set_state(end["state"])
        return out

    def hidden_states(self, params, ids, training: bool = False,
                      generator=None):
        """Final-LayerNorm hidden states (B, T, H): the LM trunk without
        the vocab projection (see ``models.lm_loss_chunked``).
        Differentiable; dropout only with ``training`` and a ``generator``
        (a ``torch.Generator`` on the model's device)."""
        h = self._embed(params, self._ids(ids))
        for i, blk in enumerate(self.blocks):
            h = self._block(blk, params[f"block{i}"], h, training, generator)
        return self.ln_f.call(params["ln_f"], h)

    def call(self, params, ids, training: bool = False, generator=None):
        """Logits (B, T, vocab) through the tied embedding;
        differentiable."""
        return self.hidden_states(params, ids, training, generator) \
            @ params["embed"].T

    def apply(self, params, state, ids, training: bool = False,
              generator=None):
        """``(call(params, ids, training, generator), state)``: the
        Transformer keeps no state."""
        return self.call(params, ids, training, generator), state

    def forward(self, ids, params=None):
        """Logits (B, T, vocab) of token ids (B, T) in the module's mode
        (``training()`` / ``evaluate()``; no dropout without a generator,
        which ``call`` takes)."""
        return self.call(self.params if params is None else params, ids,
                         bool(self.training))

    # -- cached inference --------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32):
        """Per-block dense (k, v) caches (B, kvH, max_len, D), zeroed."""
        attn = self.blocks[0].attn
        shape = (batch, attn._kvh(), max_len,
                 self.hidden_size // attn.num_heads)
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in self.blocks]

    @torch.no_grad()
    def prefill(self, params, ids, max_len: int):
        """Run the prompt once (flash, causal): (last-position logits,
        caches)."""
        ids = self._ids(ids)
        B, Tp = ids.shape
        h = self._embed(params, ids)
        caches = self.init_cache(B, max_len, h.dtype)
        for i, blk in enumerate(self.blocks):
            h, (k, v) = blk.prefill(params[f"block{i}"], h)
            caches[i][0][:, :, :Tp] = k.to(caches[i][0].dtype)
            caches[i][1][:, :, :Tp] = v.to(caches[i][1].dtype)
        h = self.ln_f.call(params["ln_f"], h)
        return h[:, -1] @ params["embed"].T, caches

    @torch.no_grad()
    def prefill_chunked(self, params, ids, max_len: int, chunk: int = 512):
        """Prompt prefill in ``chunk``-sized pieces through the cached
        decode trunk (rectangular-causal flash for pieces of >= 8)."""
        ids = self._ids(ids)
        B, Tp = ids.shape
        if Tp > max_len:
            raise ValueError(f"prompt {Tp} > max_len {max_len}")
        caches = self.init_cache(B, max_len, params["embed"].dtype)
        h = None
        for s in range(0, Tp, chunk):
            h, caches = self._decode_trunk(params, ids[:, s:s + chunk], s,
                                           caches)
        return h[:, -1] @ params["embed"].T, caches

    @torch.no_grad()
    def decode_one(self, params, tokens, pos: int, caches):
        """One cached step: tokens (B,) at position ``pos``. Returns
        (logits (B, V), caches)."""
        logits, caches = self.decode_chunk(
            params, self._ids(tokens)[:, None], pos, caches)
        return logits[:, 0], caches

    def _decode_trunk(self, params, tokens, pos: int, caches):
        emb = params["embed"]
        h = emb[tokens] * math.sqrt(self.hidden_size)
        S = tokens.shape[1]
        if self.pos_encoding != "rope":
            h = h + self._pe(emb.dtype)[pos:pos + S]
        for i, blk in enumerate(self.blocks):
            h, caches[i] = blk.decode_step(params[f"block{i}"], h,
                                           caches[i], pos)
        return self.ln_f.call(params["ln_f"], h), caches

    @torch.no_grad()
    def decode_chunk(self, params, tokens, pos: int, caches):
        """S cached steps: tokens (B, S) at positions pos..pos+S-1.
        Returns (logits (B, S, V), caches)."""
        h, caches = self._decode_trunk(params, self._ids(tokens), pos,
                                       caches)
        return h @ params["embed"].T, caches

    @torch.no_grad()
    def decode_paged(self, params, tokens, positions, pages, block_tables):
        """S cached steps over a PAGED KV pool with per-row positions:
        tokens (B, S) at ``positions[b]..positions[b]+S-1``; positions
        (B,) int32; pages a per-block list of (k_pages, v_pages), each
        (num_blocks, kvH, block_size, D), updated in place; block_tables
        (B, max_blocks) int32. Returns (logits (B, S, V), pages)."""
        tokens = self._ids(tokens)
        emb = params["embed"]
        h = emb[tokens] * math.sqrt(self.hidden_size)
        S = tokens.shape[1]
        if self.pos_encoding != "rope":
            pos_s = positions.long()[:, None] \
                + torch.arange(S, device=h.device)
            h = h + self._pe(emb.dtype)[pos_s]
        for i, blk in enumerate(self.blocks):
            h, kp, vp = blk.decode_step_paged(
                params[f"block{i}"], h, pages[i][0], pages[i][1],
                block_tables, positions)
        h = self.ln_f.call(params["ln_f"], h)
        return h @ params["embed"].T, pages

    @torch.no_grad()
    def generate(self, params, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, generator=None, top_k: int = 0,
                 top_p: float = 0.0, eos_id=None):
        """Prefill the prompt, then one cached decode step per token:
        greedy when ``temperature`` is 0, else temperature / top-k /
        top-p sampling from ``generator`` (a ``torch.Generator`` on the
        model's device; seed 0 when None). Returns (B, Tp +
        max_new_tokens) int64 ids; with ``eos_id``, positions after a
        row's first EOS are 0."""
        prompt = self._ids(prompt_ids)
        B, Tp = prompt.shape
        if max_new_tokens <= 0:
            return prompt
        total = Tp + max_new_tokens
        if total > self.max_len:
            raise ValueError(f"prompt + new tokens {total} > max_len "
                             f"{self.max_len}")
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def pick(logits):
            if temperature <= 0.0:
                return logits.argmax(-1)
            lg = logits.float() / temperature
            if top_k > 0:
                kth = lg.topk(min(top_k, lg.shape[-1]), -1).values[:, -1:]
                lg = lg.masked_fill(lg < kth, -1e30)
            if top_p > 0.0:
                srt = lg.sort(-1, descending=True).values
                probs = torch.softmax(srt, -1)
                keep = (probs.cumsum(-1) - probs) < top_p
                n_keep = keep.sum(-1).clamp(min=1)
                cutoff = srt.gather(-1, n_keep[:, None] - 1)
                lg = lg.masked_fill(lg < cutoff, -1e30)
            return torch.multinomial(torch.softmax(lg, -1), 1,
                                     generator=generator)[:, 0]

        logits, caches = self.prefill(params, prompt, total)
        tok = pick(logits)
        done = (tok == eos_id) if eos_id is not None else None
        out = [prompt, tok[:, None]]
        for pos in range(Tp, total - 1):
            logits, caches = self.decode_one(params, tok, pos, caches)
            tok = pick(logits)
            if eos_id is not None:
                tok = tok.masked_fill(done, 0)
                done = done | (tok == eos_id)
            out.append(tok[:, None])
        return torch.cat(out, 1)
