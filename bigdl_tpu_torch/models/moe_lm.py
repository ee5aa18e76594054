"""Switch-MoE Transformer language model (counterpart of
``bigdl_tpu/models/moe_lm.py``).

A decoder-only causal LM whose every ``moe_every``-th block replaces its
dense FFN with a top-1-routed :class:`nn.MixtureOfExperts`. The summed
router loss is the state ``aux_loss`` and the second output of
:meth:`MoETransformerLM.hidden_states`, so training adds ``aux_weight *
aux`` to its objective. Self-attention runs through the flash seam (K1-fwd
forward, K1-bwd backward) as in the flagship; the routing and the experts
are plain products.

The cached inference methods are the flagship ``Transformer``'s, bound as
the JAX package binds them; a block's FFN sublayer reaches the mixture
through ``MixtureOfExperts.call``, which drops the router loss. Expert
capacity is computed per forward, so a full-sequence forward can drop a
token at a tight ``capacity_factor`` where one-token decode steps never
do: cached and naive decoding then differ, as in JAX.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..nn.attention import Transformer, TransformerBlock
from ..nn.moe import MixtureOfExperts
from ..nn.module import Module
from ..nn.norm import LayerNormalization
from ..utils.engine import resolve_device
from ..utils.table import Table

__all__ = ["MoETransformerLM"]


class MoETransformerLM(Module):
    """GPT-style decoder with MoE FFNs on a stride (Switch Transformer).
    ``device``: the CUDA device by default (raises without one; ``'cpu'``
    for the CPU). ``seed``: the weights are drawn from
    ``torch.Generator().manual_seed(seed)``. ``remat`` recomputes each
    block in the backward (``torch.utils.checkpoint``)."""

    def __init__(self, vocab_size: int, hidden_size: int = 256,
                 num_heads: int = 4, filter_size: int = 1024,
                 num_layers: int = 4, n_experts: int = 4,
                 moe_every: int = 2, capacity_factor: float = 1.25,
                 max_len: int = 2048, use_flash: bool = True,
                 remat: bool = False, num_kv_heads=None,
                 pos_encoding: str = "sinusoidal", name=None, device=None,
                 seed: int = 0):
        super().__init__(name=name)
        if pos_encoding not in ("sinusoidal", "rope"):
            raise ValueError(f"pos_encoding must be 'sinusoidal' or "
                             f"'rope', got {pos_encoding!r}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.vocab_size, self.hidden_size = vocab_size, hidden_size
        self.max_len = max_len
        self.pos_encoding = pos_encoding
        self.remat = remat
        self.mode = "lm"    # the Transformer inference methods' guard
        self.moe_idx = set(range(moe_every - 1, num_layers, moe_every))
        self.embed = torch.nn.Parameter(
            0.02 * torch.randn((vocab_size, hidden_size), generator=gen))
        self.ln_f = LayerNormalization(hidden_size)
        rope = pos_encoding == "rope"
        blocks = []
        for i in range(num_layers):
            if i in self.moe_idx:
                blk = _MoEBlock(hidden_size, num_heads, filter_size,
                                n_experts, capacity_factor,
                                use_flash=use_flash,
                                num_kv_heads=num_kv_heads, rope=rope,
                                generator=gen)
            else:
                blk = TransformerBlock(hidden_size, num_heads, filter_size,
                                       causal=True, use_flash=use_flash,
                                       num_kv_heads=num_kv_heads, rope=rope,
                                       generator=gen)
            self.add_module(f"block{i}", blk)
            blocks.append(blk)
        self.blocks = tuple(blocks)
        self.register_buffer("aux_loss", torch.zeros(()))
        self._pe_cache = {}
        self.to(dev)

    device = Transformer.device
    _need_mode = Transformer._need_mode
    _pe = Transformer._pe
    _ids = Transformer._ids
    _embed_w = Transformer._embed_w
    _embed = Transformer._embed
    _logits = Transformer._logits

    def _block(self, i, blk, params, h, training, generator):
        """Block ``i`` on h: (h, its router loss or None)."""
        if i in self.moe_idx:
            def run(hh):
                return blk.apply_with_aux(params, hh, None, training,
                                          generator)
        else:
            def run(hh):
                return blk.call(params, hh, training, generator), None
        if not self.remat:
            return run(h)
        return checkpoint(run, h, use_reentrant=False,
                          preserve_rng_state=False)

    def hidden_states(self, params, ids, training: bool = False,
                      generator=None):
        """``(h, aux)``: the final-LayerNorm hidden states (B, T, H) and
        the summed router loss (a scalar in h's dtype), for a loss over
        the tied projection without the full logits
        (``models.lm_loss_chunked``). Differentiable."""
        h = self._embed(params, self._ids(ids))
        aux = torch.zeros((), dtype=h.dtype, device=h.device)
        for i, blk in enumerate(self.blocks):
            h, a = self._block(i, blk, params[f"block{i}"], h, training,
                               generator)
            if a is not None:
                aux = aux + a
        return self.ln_f.call(params["ln_f"], h), aux

    def call(self, params, x, training: bool = False, generator=None):
        """Logits (B, T, vocab) through the tied embedding."""
        return self.apply(params, {}, x, training, generator)[0]

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        h, aux = self.hidden_states(params, x, training, generator)
        return self._logits(params, h), {**state, "aux_loss": aux}

    # the flagship's cached inference, bound as-is (MoE routing is token
    # level, so a cached decode step routes its new tokens normally)
    init_cache = Transformer.init_cache
    _init_cache = Transformer._init_cache
    prefill = Transformer.prefill
    prefill_chunked = Transformer.prefill_chunked
    _decode_trunk = Transformer._decode_trunk
    decode_one = Transformer.decode_one
    decode_chunk = Transformer.decode_chunk
    generate = Transformer.generate


class _MoEBlock(TransformerBlock):
    """A causal TransformerBlock whose FFN slot holds a MixtureOfExperts
    (its router loss is kept out of the model's state tree, as JAX's block
    keeps it out of its own)."""

    def __init__(self, hidden_size: int, num_heads: int, filter_size: int,
                 n_experts: int, capacity_factor: float,
                 use_flash: bool = True, num_kv_heads=None,
                 rope: bool = False, name=None, generator=None):
        super().__init__(hidden_size, num_heads, filter_size, causal=True,
                         use_flash=use_flash, num_kv_heads=num_kv_heads,
                         rope=rope, name=name, generator=generator)
        self.ffn = MixtureOfExperts(hidden_size, n_experts,
                                    ffn_hidden=filter_size,
                                    capacity_factor=capacity_factor,
                                    generator=generator)
        self.ffn.register_buffer("aux_loss", self.ffn.aux_loss,
                                 persistent=False)

    def apply_with_aux(self, params, h, mask, training, generator):
        """(h, router loss) of the block on hidden states h under the
        additive ``mask`` (None: causal)."""
        n = self.ln1.call(params["ln1"], h)
        h = h + self.attn.call(params["attn"], Table(n, n, mask), training,
                               generator)
        f, st = self.ffn.apply(params["ffn"], {},
                               self.ln2.call(params["ln2"], h), training)
        return h + f, st["aux_loss"]

    def call(self, params, x, training: bool = False, generator=None):
        h, mask = (x[1], x[2]) if isinstance(x, Table) else (x, None)
        return self.apply_with_aux(params, h, mask, training, generator)[0]
