"""Attention and the Transformer (counterpart of
``bigdl_tpu/nn/attention.py``): the decoder-only LM mode and the
encoder-decoder translation mode, with greedy and beam-search decoding.

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
a dropout ``generator``; ``forward``) is differentiable; LM-mode
self-attention there goes through the flash ``autograd.Function`` (K1-fwd
forward, K1-bwd backward). The translation mode keeps additive masks (a
source padding mask is no static causal pattern), so it runs the masked
einsum everywhere, as the JAX package does. Every cached inference entry
point (``prefill``, the decode steps, ``generate``, the beam searches,
``translate``) runs under ``torch.no_grad()``.

Dtypes follow ``jnp``'s promotion: attention with an additive float32 mask
returns float32 for bf16 operands (the JAX package adds the mask to the
q-dtype logits), and from there the residual stream is float32. Every
product therefore casts both operands to their promoted dtype first
(:func:`_mm`), because ``torch.matmul`` refuses a float32 x bf16 pair.

Model parallelism comes from the parameters a rank is given, as JAX's
comes from their placement (``parallel.sharding``), with the axes on the
mesh ``parallel.collective.over`` sets:

* Tensor parallel (``transformer_tp_specs``): a column-split ``wq`` marks
  the attention's heads split over ``model``; ``wk`` / ``wv``, ``w1`` /
  ``w3`` / ``b1`` column-split and ``wo`` / ``w2`` row-split hold this
  rank's heads and filter columns. The attention and the FFN run on them
  (this rank's q and kv heads, its filter columns) and sum their partial
  outputs over ``model`` after ``wo`` and after ``w2`` (Megatron's g,
  whose backward is the identity), with ``b2`` added once after the sum;
  their replicated inputs carry Megatron's f (identity forward, sum of
  the input gradients backward). Embedding, norms and the head stay
  replicated. Where the heads do not divide by the split, the split
  leaves are gathered and the layer runs whole on every rank (JAX's
  compiler reshards those columns).
* FSDP (``fsdp_specs``): any other leaf smaller than the module's own is
  a slice over ``data``; each block gathers its slices just before it
  runs and drops them after (``sharding.gather_param``: its gradient is
  the reduce-scatter), and the embedding is gathered where it is used.
* Sequence parallel (``Attention(seq_axis=)``): this rank's block of the
  sequence; RoPE positions are offset by the block, GQA's K/V heads are
  broadcast before the exchange, and attention runs through the ring
  (``parallel.ring_flash``) or the all-to-all (``parallel.seq_all_to_all``).
"""
from __future__ import annotations

import math
from contextlib import nullcontext as _nullcontext

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.paged_attention import paged_attention_reference
from ..parallel import collective
from ..parallel.flash import (_PAGED_CTX, flash_attention,
                              flash_chunk_attention, paged_attention)
from ..utils.carrier import TreeCarrier
from ..utils.engine import resolve_device
from ..utils.table import Table
from .module import Module
from .norm import LayerNormalization

NEG = -1e30     # a dead or frozen beam's candidate score (float32)


def _mm(a, b):
    """``a @ b`` in the promoted dtype of the two (``jnp.matmul``'s rule):
    a float32 activation times a bf16 weight is a float32 product. A
    quantized weight (``quantization.lm``) computes its own product in
    ``a``'s dtype (its ``__rmatmul__``), as in JAX."""
    if a.dtype == b.dtype or isinstance(b, TreeCarrier):
        return a @ b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


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
    from ``generator``, on x's device; in a replicated data-parallel step,
    this rank's rows of the global batch's mask, and under tensor
    parallelism this rank's heads or filter columns of the whole layer's
    mask) and scaled by 1 / (1 - p)."""
    from ..parallel.collective import batch_rows
    keep = batch_rows(lambda s: torch.rand(s, generator=generator,
                                           device=x.device),
                      x.shape) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def dot_product_attention(q, k, v, mask=None, dropout_p: float = 0.0,
                          generator=None, training: bool = False):
    """q, k, v: (B, H, T, D); mask additive (broadcastable) or None.
    Computes in float32. Returns q's dtype without a mask and, with one,
    the dtype q's and the mask's promote to, as ``jnp`` does (float32 for
    bf16 q and the float32 masks of :func:`causal_mask` and
    :func:`padding_mask`). With ``training``, ``dropout_p > 0`` and a
    ``generator``, the attention weights are dropped out (as the JAX
    package does with an rng)."""
    d = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    out_dtype = q.dtype
    if mask is not None:
        logits = logits + mask
        out_dtype = torch.promote_types(q.dtype, mask.dtype)
    w = torch.softmax(logits, dim=-1)
    if training and dropout_p > 0.0 and generator is not None:
        w = dropout(w, dropout_p, generator)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(out_dtype)


def causal_mask(t, dtype=torch.float32, device=None):
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
    return torch.where(keep, 0.0, -1e9).to(dtype)[None, None]


def padding_mask(lengths_or_mask, t):
    """Additive (B, 1, 1, T) float32 mask from a (B, T) 0/1 keep-mask:
    0 where kept, -1e9 where padded."""
    m = lengths_or_mask.float()
    return (m[:, None, None, :] - 1.0) * 1e9


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
    """Multi-head attention with optional grouped-query K/V heads
    (``num_kv_heads``) and rotary embeddings. Its input is one tensor
    (self-attention) or ``Table(query, key_value[, additive_mask])``
    (cross-attention when ``key_value`` is another sequence).
    ``attention_dropout`` drops attention weights in training (then the
    einsum path runs instead of flash, as in the JAX package).
    ``seq_axis`` names a mesh axis the sequence is split over: the input is
    this rank's block and attention runs sequence-parallel, by
    ``seq_impl`` ``"ring"`` (``parallel.ring_flash``: K/V blocks around the
    ring, flash blocks, any head count) or ``"a2a"``
    (``parallel.seq_all_to_all``: heads exchanged for sequence, needs
    num_heads % axis size == 0); self-attention only, masked by
    ``causal``, and without attention dropout (refused, as in JAX).
    ``generator`` seeds the weights."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attention_dropout: float = 0.0, use_flash: bool = True,
                 seq_axis=None, causal: bool = False, seq_impl: str = "ring",
                 num_kv_heads=None, rope: bool = False, name=None,
                 generator=None):
        super().__init__(name=name)
        if seq_axis is not None and attention_dropout > 0:
            raise ValueError(
                "seq-parallel attention does not support attention "
                "dropout (the ring kernel has no dropout path) - set "
                "attention_dropout=0")
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
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
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

    def _tp(self, params) -> int:
        """The tensor-parallel degree of this rank's attention weights: how
        many ways ``wq``'s columns are split (1: whole)."""
        return self.hidden_size // params["wq"].shape[1]

    def _local(self, params, keys):
        """(params, n): this rank's weights and the degree its heads are
        split over ``model``. When the heads do not divide by the split,
        the leaves ``keys`` are gathered whole and n is 1 (every rank
        then runs the whole layer)."""
        n = self._tp(params)
        if n == 1 or (self.num_heads % n == 0 and self._kvh() % n == 0):
            return params, n
        dims = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
        if any(isinstance(params[k], TreeCarrier) for k in keys):
            raise NotImplementedError(
                f"quantized attention weights split {n} ways over 'model' "
                f"need the heads ({self.num_heads}, kv {self._kvh()}) to "
                f"divide by the split")
        out = dict(params)
        for k in keys:
            out[k] = collective._tp_gather(params[k], dims[k])
        return out, 1

    def qkv(self, params, qx, kx=None):
        """Query heads (B, nH, T, D) of ``qx`` and key/value heads
        (B, kvH, Tk, D) of ``kx`` (``qx`` when None: self-attention; the
        translation mode's cross-attention passes the encoder output).
        Three matmuls; the JAX package fuses them into one over
        concatenated weights, which in eager PyTorch would copy the
        weights every call. Under tensor parallelism, this rank's nH / n
        and kvH / n heads."""
        params, n = self._local(params, ("wq", "wk", "wv"))
        self_attn = kx is None or kx is qx
        if n > 1:
            qx = collective._tp_enter(qx)
            kx = qx if self_attn else collective._tp_enter(kx)
        else:
            kx = qx if self_attn else kx
        return (self._split(_mm(qx, params["wq"]), self.num_heads // n),
                self._split(_mm(kx, params["wk"]), self._kvh() // n),
                self._split(_mm(kx, params["wv"]), self._kvh() // n))

    def _expand_kv(self, k, v):
        g = self.num_heads // self._kvh()
        if g == 1:
            return k, v
        return (k.repeat_interleave(g, dim=1).contiguous(),
                v.repeat_interleave(g, dim=1).contiguous())

    def _merge(self, o, params):
        """The heads' output through ``wo``; under tensor parallelism this
        rank's rows of it, summed over ``model``."""
        params, n = self._local(params, ("wo",))
        b, h, t, d = o.shape
        y = _mm(o.transpose(1, 2).reshape(b, t, h * d), params["wo"])
        return collective._tp_exit(y) if n > 1 else y

    def decode(self, params, x_t, k_cache, v_cache, pos: int):
        """One autoregressive step: x_t (B, 1, H) at position ``pos``, its
        K/V written into the caches in place. The S = 1 case of
        :meth:`decode_chunk`; returns (out (B, 1, H), k_cache, v_cache)."""
        return self.decode_chunk(params, x_t, k_cache, v_cache, pos)

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
        mesh, axis = _PAGED_CTX.get()
        if axis is not None:
            from ..parallel.mesh import axis_size
            if k_pages.shape[1] * axis_size(mesh, axis) != self._kvh():
                raise ValueError(
                    f"pages split over {axis!r} hold {k_pages.shape[1]} kv "
                    f"heads, not {self._kvh()} / "
                    f"{axis_size(mesh, axis)}")
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
        """Attention over x: a tensor (B, T, H) attends to itself, causal
        when built so; ``Table(query, key_value[, mask])`` attends from
        the query to ``key_value`` under the additive ``mask`` (None: the
        causal flag decides). Differentiable; dropout on the weights only
        with ``training`` and a ``generator``."""
        if isinstance(x, Table):
            qx = x[1]
            kx = x[2] if len(x) >= 2 else qx
            mask = x[3] if len(x) >= 3 else None
        else:
            qx, kx, mask = x, x, None
        q, k, v = self.qkv(params, qx, kx)
        if self.rope:
            if kx is not qx:
                raise ValueError("RoPE supports self-attention only")
            t = q.shape[2]
            pos = torch.arange(t, device=qx.device)
            if self.seq_axis is not None:
                # this rank's block -> its global positions
                pos = pos + collective.axis_group(self.seq_axis)[2] * t
            q = rotary_embedding(q, pos)
            k = rotary_embedding(k, pos)
        k, v = self._expand_kv(k, v)
        drop = (training and self.attention_dropout > 0.0
                and generator is not None)
        if self.seq_axis is not None:
            if mask is not None:
                raise ValueError(
                    "seq-parallel attention supports causal masking only "
                    "(set causal=True); additive masks cannot cross the "
                    "ring")
            if self.seq_impl == "a2a":
                from ..parallel.seq_all_to_all import a2a_attention
                o = a2a_attention(q, k, v, axis=self.seq_axis,
                                  causal=self.causal,
                                  use_flash=self.use_flash)
            else:
                from ..parallel.ring_flash import ring_flash_attention
                o = ring_flash_attention(q, k, v, axis=self.seq_axis,
                                         causal=self.causal)
        elif self.causal and mask is None and self.use_flash and not drop:
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
        else:
            if self.causal and mask is None:
                mask = causal_mask(q.shape[2], device=qx.device)
            # heads split over ``model``: the weights' dropout mask is this
            # rank's heads of the whole layer's
            with (collective._model_split(1)
                  if q.shape[1] < self.num_heads else _nullcontext()):
                o = dot_product_attention(q, k, v, mask,
                                          self.attention_dropout, generator,
                                          training)
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
        """Under tensor parallelism (``w1``'s columns split over
        ``model``), this rank's filter columns; the partial outputs are
        summed after ``w2`` and ``b2`` is added once, after the sum."""
        n = self.filter_size // params["w1"].shape[1]
        if n > 1:
            x = collective._tp_enter(x)
        a = _mm(x, params["w1"]) + params["b1"]
        if self.activation == "swiglu":
            h = F.silu(a) * _mm(x, params["w3"])
        elif self.activation == "gelu":
            h = F.gelu(a, approximate="tanh")
        else:
            h = F.relu(a)
        if training and self.relu_dropout > 0.0 and generator is not None:
            with (collective._model_split(-1) if n > 1
                  else _nullcontext()):
                h = dropout(h, self.relu_dropout, generator)
        y = _mm(h, params["w2"])
        if n > 1:
            y = collective._tp_exit(y)
        return y + params["b2"]


class TransformerBlock(Module):
    """Pre-LN block: self-attention, then (``with_cross``, the translation
    decoder's blocks) cross-attention to the encoder output, then the FFN,
    each residual; causal only when asked (``causal=False``, JAX's
    default, attends both ways)."""

    def __init__(self, hidden_size: int, num_heads: int, filter_size: int,
                 attn_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 with_cross: bool = False, causal: bool = False,
                 use_flash: bool = True, num_kv_heads=None,
                 rope: bool = False, ffn_activation: str = "relu", name=None,
                 generator=None):
        super().__init__(name=name)
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
        self.with_cross = with_cross
        if with_cross:
            self.cross = Attention(hidden_size, num_heads, attn_dropout,
                                   generator=generator)
            self.ln3 = LayerNormalization(hidden_size)

    def _whole(self, params):
        """This block's parameters with every FSDP slice gathered over
        ``data``: called just before the block runs, so the whole leaves
        live only while it does. Under tensor parallelism (``wq``'s
        columns split n ways over ``model``) a leaf's tensor-parallel shape
        is the module's own with its ``transformer_tp_specs`` dimension
        divided by n, and that ``model`` block stays this rank's; any leaf
        smaller than that shape (the module's own outside tensor
        parallelism) is a slice over ``data`` and is gathered, along the
        one dimension where the shapes differ - a leaf split over both
        axes gathers its ``data`` dimension only."""
        from ..parallel.sharding import gather_param, transformer_tp_specs
        n = self.attn._tp(params["attn"])
        specs = transformer_tp_specs(self.params) if n > 1 else None

        def walk(p, own, spec):
            if isinstance(p, dict):
                return {k: walk(v, own[k], None if spec is None else spec[k])
                        for k, v in p.items()}
            shape = list(own.shape)
            for d, ax in enumerate(spec or ()):
                if ax is not None:
                    shape[d] //= n
            if tuple(p.shape) == tuple(shape):
                return p
            if isinstance(p, TreeCarrier):
                raise NotImplementedError(
                    "quantized weights sliced over 'data' (FSDP) are not "
                    "gathered; serve them replicated or tensor-parallel")
            return gather_param(p, shape)
        return walk(params, self.params, specs)

    def _ffn_sublayer(self, params, h, training=False, generator=None):
        return h + self.ffn.call(params["ffn"],
                                 self.ln2.call(params["ln2"], h),
                                 training, generator)

    def call(self, params, x, training: bool = False, generator=None):
        """x: hidden states (B, T, H), or ``Table(h, mask[, enc,
        enc_mask])`` with an additive self-attention ``mask`` (None: the
        causal flag decides) and, for a ``with_cross`` block, the encoder
        output and its additive padding mask."""
        if isinstance(x, Table):
            h, mask = x[1], x[2]
            enc = x[3] if len(x) >= 3 else None
            enc_mask = x[4] if len(x) >= 4 else None
        else:
            h, mask, enc, enc_mask = x, None, None, None
        params = self._whole(params)
        n = self.ln1.call(params["ln1"], h)
        h = h + self.attn.call(params["attn"], Table(n, n, mask), training,
                               generator)
        if self.with_cross and enc is not None:
            n = self.ln3.call(params["ln3"], h)
            h = h + self.cross.call(params["cross"], Table(n, enc, enc_mask),
                                    training, generator)
        return self._ffn_sublayer(params, h, training, generator)

    def prefill(self, params, h):
        """Causal forward over a whole prompt that also returns the
        compact (kvH) K/V heads for the decode cache: (h, (k, v))."""
        params = self._whole(params)
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

    def cross_kv(self, params, enc):
        """The cross-attention K/V heads of the encoder output enc
        (B, Ts, H), constant across decode steps (the query is per step)."""
        if not self.with_cross:
            raise ValueError("cross_kv needs a block built with_cross=True")
        p = params["cross"]
        return (self.cross._split(_mm(enc, p["wk"])),
                self.cross._split(_mm(enc, p["wv"])))

    def decode_step(self, params, h_t, kv, pos: int, cross_kv=None,
                    cross_mask=None):
        """S cached positions: h_t (B, S, H) lands at pos..pos+S-1, its
        K/V written into ``kv`` = (k_cache, v_cache) in place. A
        translation block also takes ``cross_kv`` (from :meth:`cross_kv`)
        and the additive source padding ``cross_mask``. Returns
        (h (B, S, H), (k_cache, v_cache))."""
        params = self._whole(params)
        n = self.ln1.call(params["ln1"], h_t)
        a, k_cache, v_cache = self.attn.decode(params["attn"], n, kv[0],
                                               kv[1], pos)
        h_t = h_t + a
        if self.with_cross and cross_kv is not None:
            n = self.ln3.call(params["ln3"], h_t)
            q = self.cross._split(_mm(n, params["cross"]["wq"]))
            o = dot_product_attention(q, cross_kv[0], cross_kv[1],
                                      cross_mask)
            h_t = h_t + self.cross._merge(o, params["cross"])
        return self._ffn_sublayer(params, h_t), (k_cache, v_cache)

    def decode_step_paged(self, params, h_t, k_pages, v_pages,
                          block_tables, positions):
        params = self._whole(params)
        n = self.ln1.call(params["ln1"], h_t)
        a, k_pages, v_pages = self.attn.decode_paged(
            params["attn"], n, k_pages, v_pages, block_tables, positions)
        return self._ffn_sublayer(params, h_t + a), k_pages, v_pages


class Transformer(Module):
    """Transformer over token ids: ``mode='lm'`` (decoder-only causal LM;
    input ids (B, T)) or ``mode='translation'`` (encoder-decoder; input
    ``Table(src_ids, tgt_ids)``, id 0 is the source's padding). Returns
    logits over the vocab through the tied embedding. The translation mode
    adds ``enc_block{i}`` (bidirectional, relu, full heads) beside the
    decoder's ``block{i}``, which are built ``with_cross=True`` and take
    an explicit causal mask; RoPE is LM-only, as in the JAX package.

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
        if mode not in ("lm", "translation"):
            raise ValueError(f"mode must be 'lm' or 'translation', got "
                             f"{mode!r}")
        if pos_encoding not in ("sinusoidal", "rope"):
            raise ValueError(f"pos_encoding must be 'sinusoidal' or "
                             f"'rope', got {pos_encoding!r}")
        if pos_encoding == "rope" and mode != "lm":
            raise ValueError("RoPE is LM-mode only (cross-attention has "
                             "no rotary form here)")
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
        translation = mode == "translation"
        blocks = []
        for i in range(num_hidden_layers):
            blk = TransformerBlock(hidden_size, num_heads, filter_size,
                                   attention_dropout, relu_dropout,
                                   with_cross=translation,
                                   causal=not translation,
                                   use_flash=use_flash,
                                   num_kv_heads=num_kv_heads,
                                   rope=(pos_encoding == "rope"),
                                   ffn_activation=ffn_activation,
                                   generator=gen)
            self.add_module(f"block{i}", blk)
            blocks.append(blk)
        self.blocks = tuple(blocks)
        enc_blocks = []
        for i in range(num_hidden_layers if translation else 0):
            blk = TransformerBlock(hidden_size, num_heads, filter_size,
                                   attention_dropout, relu_dropout,
                                   generator=gen)
            self.add_module(f"enc_block{i}", blk)
            enc_blocks.append(blk)
        self.enc_blocks = tuple(enc_blocks)
        self._pe_cache = {}
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _need_mode(self, mode, what):
        if self.mode != mode:
            raise ValueError(f"{what} needs mode={mode!r}, this model is "
                             f"mode={self.mode!r}")

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

    def _embed_w(self, params):
        """The embedding, whole (gathered where FSDP holds a slice)."""
        emb = params["embed"]
        if emb.shape == self.embed.shape:
            return emb
        from ..parallel.sharding import gather_param
        return gather_param(emb, self.embed.shape)

    def _ln_f(self, params, h):
        """The final LayerNorm on h, its FSDP slices gathered where this
        rank holds slices of it."""
        p, own = params["ln_f"], self.ln_f.params
        if any(tuple(p[k].shape) != tuple(v.shape) for k, v in own.items()):
            from ..parallel.sharding import gather_param
            p = {k: gather_param(p[k], v.shape) for k, v in own.items()}
        return self.ln_f.call(p, h)

    def _embed(self, params, ids, emb=None):
        emb = self._embed_w(params) if emb is None else emb
        return _embed_ids(emb, ids, self.hidden_size,
                          with_pe=self.pos_encoding != "rope",
                          pe=self._pe(emb.dtype))

    def _block(self, blk, params, h, training, generator, extra=None):
        """One block of a stack on h; ``extra`` = (mask, enc, enc_mask) of
        the translation mode (None: the LM's causal flag decides)."""
        def block_input(h):
            return h if extra is None else Table(h, *extra)

        if not self.remat:
            return blk.call(params, block_input(h), training, generator)
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
            out = blk.call(params, block_input(h), training, g)
            if g is not None:
                end["state"] = g.get_state()
            return out

        out = checkpoint(run, h, use_reentrant=False,
                         preserve_rng_state=False)
        if generator is not None:
            generator.set_state(end["state"])
        return out

    def _stack(self, blocks, prefix, params, h, training, generator,
               extra=None):
        for i, blk in enumerate(blocks):
            h = self._block(blk, params[f"{prefix}{i}"], h, training,
                            generator, extra)
        return h

    def hidden_states(self, params, x, training: bool = False,
                      generator=None):
        """Final-LayerNorm hidden states (B, T, H): the LM trunk without
        the vocab projection (see ``models.lm_loss_chunked``).
        Differentiable; dropout only with ``training`` and a ``generator``
        (a ``torch.Generator`` on the model's device)."""
        self._need_mode("lm", "hidden_states")
        h = self._embed(params, self._ids(x))
        h = self._stack(self.blocks, "block", params, h, training, generator)
        return self._ln_f(params, h)

    def _logits(self, params, h, emb=None):
        """The tied output projection, in the promoted dtype."""
        emb = self._embed_w(params) if emb is None else emb
        return _mm(h, emb.T)

    def _encode_src(self, params, src, training=False, generator=None):
        """The source side of the translation mode: the padding mask of
        ids (B, Ts) (0 is padding) and the encoder stack, (enc,
        src_mask)."""
        src_mask = padding_mask(src != 0, src.shape[1])
        enc = self._embed(params, src)
        enc = self._stack(self.enc_blocks, "enc_block", params, enc,
                          training, generator, (src_mask,))
        return enc, src_mask

    def call(self, params, x, training: bool = False, generator=None):
        """Logits (B, T, vocab) through the tied embedding;
        differentiable. LM mode: x is ids (B, T). Translation mode: x is
        ``Table(src_ids, tgt_ids)``; the source padding mask comes from
        ``src_ids != 0`` and the target self-attention is causal."""
        if self.mode != "translation":
            return self._logits(params, self.hidden_states(
                params, x, training, generator))
        src, tgt = self._ids(x[1]), self._ids(x[2])
        enc, src_mask = self._encode_src(params, src, training, generator)
        h = self._embed(params, tgt)
        mask = causal_mask(tgt.shape[1], device=h.device)
        h = self._stack(self.blocks, "block", params, h, training, generator,
                        (mask, enc, src_mask))
        return self._logits(params, self._ln_f(params, h))

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        """``(call(params, x, training, generator), state)``: the
        Transformer keeps no state."""
        return self.call(params, x, training, generator), state

    def forward(self, x):
        """Logits (B, T, vocab) of token ids (B, T), or of ``Table(src_ids,
        tgt_ids)`` in translation mode, with the module's own parameters,
        in its mode (``training()`` / ``evaluate()``; no dropout without a
        generator, which ``call`` takes)."""
        return self.call(self.params, x, bool(self.training))

    # -- cached inference --------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32):
        """Per-block dense (k, v) caches (B, kvH, max_len, D), zeroed."""
        return self._init_cache(batch, max_len, dtype)

    def _init_cache(self, batch, max_len, dtype, params=None):
        """:meth:`init_cache`; with the tensor-parallel ``params`` a rank
        serves, its kvH / n heads (every head where they do not divide)."""
        attn = self.blocks[0].attn
        kvh = attn._kvh()
        if params is not None:
            n = attn._tp(params["block0"]["attn"])
            if kvh % n == 0 and attn.num_heads % n == 0:
                kvh //= n
        shape = (batch, kvh, max_len, self.hidden_size // attn.num_heads)
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in self.blocks]

    @torch.no_grad()
    def prefill(self, params, ids, max_len: int):
        """Run the prompt once (flash, causal): (last-position logits,
        caches)."""
        self._need_mode("lm", "prefill")
        ids = self._ids(ids)
        B, Tp = ids.shape
        emb = self._embed_w(params)
        h = self._embed(params, ids, emb)
        caches = self._init_cache(B, max_len, h.dtype, params)
        for i, blk in enumerate(self.blocks):
            h, (k, v) = blk.prefill(params[f"block{i}"], h)
            caches[i][0][:, :, :Tp] = k.to(caches[i][0].dtype)
            caches[i][1][:, :, :Tp] = v.to(caches[i][1].dtype)
        h = self._ln_f(params, h)
        return self._logits(params, h[:, -1], emb), caches

    @torch.no_grad()
    def prefill_chunked(self, params, ids, max_len: int, chunk: int = 512):
        """Prompt prefill in ``chunk``-sized pieces through the cached
        decode trunk (rectangular-causal flash for pieces of >= 8)."""
        self._need_mode("lm", "prefill_chunked")
        ids = self._ids(ids)
        B, Tp = ids.shape
        if Tp > max_len:
            raise ValueError(f"prompt {Tp} > max_len {max_len}")
        caches = self._init_cache(B, max_len, params["embed"].dtype,
                                   params)
        h = None
        for s in range(0, Tp, chunk):
            h, caches = self._decode_trunk(params, ids[:, s:s + chunk], s,
                                           caches)
        return self._logits(params, h[:, -1]), caches

    @torch.no_grad()
    def decode_one(self, params, tokens, pos: int, caches, cross=None,
                   cross_mask=None):
        """One cached step: tokens (B,) at position ``pos``, K/V written
        into ``caches`` in place. Returns (logits (B, V), caches). The
        translation mode passes each block's cross-attention K/V
        (``cross``, from ``TransformerBlock.cross_kv``) and the additive
        source padding ``cross_mask``; the LM path is the S = 1 case of
        :meth:`decode_chunk`."""
        if cross is None:
            logits, caches = self.decode_chunk(
                params, self._ids(tokens)[:, None], pos, caches)
            return logits[:, 0], caches
        emb = self._embed_w(params)
        h = emb[self._ids(tokens)] * math.sqrt(self.hidden_size)
        if self.pos_encoding != "rope":
            h = h + self._pe(emb.dtype)[pos:pos + 1]
        h = h[:, None, :]
        for i, blk in enumerate(self.blocks):
            h, caches[i] = blk.decode_step(params[f"block{i}"], h, caches[i],
                                           pos, cross[i], cross_mask)
        h = self._ln_f(params, h)
        return self._logits(params, h[:, 0], emb), caches

    def _decode_trunk(self, params, tokens, pos: int, caches, emb=None):
        self._need_mode("lm", "the LM decode trunk")
        emb = self._embed_w(params) if emb is None else emb
        h = emb[tokens] * math.sqrt(self.hidden_size)
        S = tokens.shape[1]
        if self.pos_encoding != "rope":
            h = h + self._pe(emb.dtype)[pos:pos + S]
        for i, blk in enumerate(self.blocks):
            h, caches[i] = blk.decode_step(params[f"block{i}"], h,
                                           caches[i], pos)
        return self._ln_f(params, h), caches

    @torch.no_grad()
    def decode_chunk(self, params, tokens, pos: int, caches):
        """S cached steps: tokens (B, S) at positions pos..pos+S-1.
        Returns (logits (B, S, V), caches)."""
        emb = self._embed_w(params)
        h, caches = self._decode_trunk(params, self._ids(tokens), pos,
                                       caches, emb)
        return self._logits(params, h, emb), caches

    @torch.no_grad()
    def decode_paged(self, params, tokens, positions, pages, block_tables):
        """S cached steps over a PAGED KV pool with per-row positions:
        tokens (B, S) at ``positions[b]..positions[b]+S-1``; positions
        (B,) int32; pages a per-block list of (k_pages, v_pages), each
        (num_blocks, kvH, block_size, D), updated in place; block_tables
        (B, max_blocks) int32. Returns (logits (B, S, V), pages)."""
        self._need_mode("lm", "decode_paged")
        tokens = self._ids(tokens)
        emb = self._embed_w(params)
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
        h = self._ln_f(params, h)
        return self._logits(params, h, emb), pages

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

    @torch.no_grad()
    def generate_beam(self, params, prompt_ids, max_new_tokens: int,
                      beam_size: int = 4, eos_id=None,
                      length_penalty: float = 0.0):
        """Beam-search generation (LM mode): the prompt is prefilled ONCE
        on the un-repeated batch (flash, one launch a layer), the caches
        are then repeated to the (B * beam) layout and the beams ride the
        cached decode step of :meth:`generate`. Score = sum of float32
        log-probs / len ** ``length_penalty`` (len counts non-zero ids:
        id 0 is pad, as in the JAX package); beams that emit ``eos_id``
        freeze with their score and emit 0. Returns (B, Tp +
        max_new_tokens) int64 ids of each row's best beam.
        ``beam_size=1`` is greedy :meth:`generate`, token for token."""
        self._need_mode("lm", "generate_beam")
        prompt = self._ids(prompt_ids)
        B, Tp = prompt.shape
        K = beam_size
        if max_new_tokens <= 0:
            return prompt
        total = Tp + max_new_tokens
        if total > self.max_len:
            raise ValueError(f"prompt + new tokens {total} > max_len "
                             f"{self.max_len}")
        logits, caches = self.prefill(params, prompt, total)
        caches = [(k.repeat_interleave(K, 0), v.repeat_interleave(K, 0))
                  for k, v in caches]
        logp0 = torch.log_softmax(logits.float(), -1)
        scores0, tok0 = _top_k(logp0, K)                     # (B, K)
        tok = tok0.reshape(-1)
        done = (tok == eos_id) if eos_id is not None \
            else torch.zeros_like(tok, dtype=torch.bool)
        scores, toks, parents = self._beam_scan(
            lambda t, p, c: self.decode_one(params, t, p, c),
            caches, tok, scores0.reshape(-1), done, Tp, max_new_tokens - 1,
            B, K, eos_id)
        paths, roots = _beam_backtrack(toks, parents, B, K)
        paths = torch.cat([tok0.gather(1, roots)[None], paths], 0)
        return torch.cat([prompt, _beam_select(scores, paths, B, K,
                                               length_penalty)], 1)

    def _beam_scan(self, step_fn, caches, tok, scores, done, pos0: int,
                   steps: int, B: int, K: int, eos_id):
        """``steps`` beam expansions in the flattened (B * K) layout, the
        one implementation behind :meth:`generate_beam` and
        :meth:`translate_beam`. ``step_fn(tok, pos, caches) -> (logits,
        caches)`` is the cached decode step. Candidates are (V + 1) wide:
        the extra column is a frozen beam's one "stay" continuation (score
        unchanged, emits 0), so vocab column 0 stays selectable by live
        beams. The top K are picked lower index first among equal scores
        (``jax.lax.top_k``'s order). Each expansion gathers the caches of
        the surviving beams into NEW tensors: the decode step writes the
        caches in place, and a reorder in place would overwrite rows it
        still has to read. Runs every step even when all beams are done,
        as the JAX scan does. Returns (scores (B * K,), toks, parents),
        the last two (steps, B, K) int64."""
        V = self.vocab_size
        dev = tok.device
        base = (torch.arange(B, device=dev) * K)[:, None]
        toks, parents = [], []
        pos = pos0
        for _ in range(steps):
            logits, caches = step_fn(tok, pos, caches)
            logp = torch.log_softmax(logits.float(), -1)
            live = torch.where(done[:, None], NEG, logp) + scores[:, None]
            stay = torch.where(done, scores, NEG)[:, None]
            cand = torch.cat([live, stay], 1).reshape(B, K * (V + 1))
            top, flat_idx = _top_k(cand, K)                  # (B, K)
            beam_idx = flat_idx // (V + 1)
            col = (flat_idx % (V + 1)).reshape(-1)
            rows = (base + beam_idx).reshape(-1)
            caches = [(k.index_select(0, rows), v.index_select(0, rows))
                      for k, v in caches]
            done = done[rows]
            emitted = torch.where(col == V, 0, col)          # stay -> pad
            if eos_id is not None:
                done = done | ((col != V) & (emitted == eos_id))
            tok, scores, pos = emitted, top.reshape(-1), pos + 1
            toks.append(emitted.reshape(B, K))
            parents.append(beam_idx)
        if not steps:
            empty = torch.zeros((0, B, K), dtype=torch.long, device=dev)
            return scores, empty, empty
        return scores, torch.stack(toks), torch.stack(parents)

    @torch.no_grad()
    def translate(self, params, src_ids, max_new_tokens: int,
                  bos_id: int = 1, eos_id=None):
        """Greedy encoder-decoder decoding (translation mode): encode the
        source once, build each block's cross-attention K/V once, then
        one cached decode step a target token from ``bos_id``. Tokens
        after a row's first ``eos_id`` are emitted as 0 (the argmax is
        still fed back, as in the JAX package). The caches take the
        encoder output's dtype. Returns (B, max_new_tokens) int64 ids
        (BOS excluded)."""
        self._need_mode("translation", "translate")
        src = self._ids(src_ids)
        B = src.shape[0]
        self._check_target_len(max_new_tokens)
        enc, src_mask = self._encode_src(params, src)
        cross = [blk.cross_kv(params[f"block{i}"], enc)
                 for i, blk in enumerate(self.blocks)]
        caches = self.init_cache(B, max_new_tokens + 1, enc.dtype)
        tok = torch.full((B,), bos_id, dtype=torch.long, device=src.device)
        done = torch.zeros((B,), dtype=torch.bool, device=src.device)
        out = []
        for pos in range(max_new_tokens):
            logits, caches = self.decode_one(params, tok, pos, caches, cross,
                                             src_mask)
            tok = logits.argmax(-1)
            out.append(torch.where(done, 0, tok))
            if eos_id is not None:
                done = done | (tok == eos_id)
        return torch.stack(out, 1)

    @torch.no_grad()
    def translate_beam(self, params, src_ids, max_new_tokens: int,
                       beam_size: int = 4, bos_id: int = 1, eos_id=None,
                       length_penalty: float = 0.0):
        """Beam-search decoding (translation mode) through the cached
        decode step of :meth:`translate`: the cross-attention K/V are
        built once on the un-repeated encoder output and repeated to the
        (B * beam) layout; beam 0 of each row starts live and the others
        at -1e30, so the first expansion draws ``beam_size`` distinct
        continuations of BOS. Scoring and freezing as in
        :meth:`generate_beam`. Returns (B, max_new_tokens) int64 ids of
        each row's best beam (BOS excluded). ``beam_size=1`` is
        :meth:`translate`."""
        self._need_mode("translation", "translate_beam")
        src = self._ids(src_ids)
        B = src.shape[0]
        K = beam_size
        self._check_target_len(max_new_tokens)
        enc, src_mask = self._encode_src(params, src)
        cross = [tuple(t.repeat_interleave(K, 0)
                       for t in blk.cross_kv(params[f"block{i}"], enc))
                 for i, blk in enumerate(self.blocks)]
        mask_k = src_mask.repeat_interleave(K, 0)
        caches = self.init_cache(B * K, max_new_tokens + 1, enc.dtype)
        dev = src.device
        scores0 = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
        scores0[:, 0] = 0.0
        bos = torch.full((B * K,), bos_id, dtype=torch.long, device=dev)
        done0 = torch.zeros((B * K,), dtype=torch.bool, device=dev)
        scores, toks, parents = self._beam_scan(
            lambda t, p, c: self.decode_one(params, t, p, c, cross, mask_k),
            caches, bos, scores0.reshape(-1), done0, 0, max_new_tokens,
            B, K, eos_id)
        paths, _ = _beam_backtrack(toks, parents, B, K)
        return _beam_select(scores, paths, B, K, length_penalty)

    def _check_target_len(self, max_new_tokens):
        if max_new_tokens + 1 > self.max_len:
            raise ValueError(f"BOS + {max_new_tokens} new tokens > max_len "
                             f"{self.max_len}")


def _top_k(x, k):
    """The k largest entries of each row of x and their indices, larger
    first and, among equal values, lower index first: the order of
    ``jax.lax.top_k`` (``torch.topk`` promises none among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_backtrack(toks, parents, B, K):
    """Follow parent pointers from the final beam slots back to step 0
    (beam slots are re-gathered every expansion, so a slot's column of
    ``toks`` mixes hypotheses). toks / parents: (steps, B, K). Returns
    (paths (steps, B, K), roots (B, K)): ``roots[b, k]`` is final beam
    k's slot at entry to step 0."""
    beams = torch.arange(K, device=toks.device).repeat(B, 1)
    rev = []
    for t in range(toks.shape[0] - 1, -1, -1):
        rev.append(toks[t].gather(1, beams))
        beams = parents[t].gather(1, beams)
    paths = torch.stack(rev[::-1]) if rev else toks.new_zeros((0, B, K))
    return paths, beams


def _beam_select(scores, paths, B, K, length_penalty):
    """Each row's best beam under the length penalty, as (B, T) ids:
    length = count of non-zero ids (id 0 is pad), at least 1; score =
    sum of log-probs / length ** ``length_penalty``; the first best beam
    among equal scores (``argmax``)."""
    lens = (paths != 0).sum(0).float()                      # (B, K)
    final = scores.reshape(B, K) / lens.clamp(min=1.0) ** length_penalty
    best = final.argmax(1)                                  # (B,)
    out = paths.gather(2, best[None, :, None].expand(paths.shape[0], B, 1))
    return out[:, :, 0].T
