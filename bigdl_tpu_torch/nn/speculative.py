"""Speculative decoding for the LM family (counterpart of
``bigdl_tpu/nn/speculative.py``).

A cheap DRAFT model proposes ``k`` tokens one at a time and the TARGET
model verifies all of them (plus a bonus token) in ONE cached chunked
forward (``Transformer.decode_chunk``): one pass over the target's weights
serves up to ``k+1`` emitted tokens.

- ``temperature == 0``: greedy, output-preserving: the emitted ids are the
  target's own greedy choices, the draft only changes how many target
  forwards produce them.
- ``temperature > 0``: rejection sampling. Proposal ``d_i`` (drawn from the
  draft's distribution ``p_d``) is accepted with probability
  ``min(1, p_t(d_i)/p_d(d_i))``; on rejection the token is drawn from the
  residual ``max(p_t - p_d, 0)`` (renormalised), and a fully accepted round
  draws the bonus token from ``p_t``. Each emitted token is distributed as
  target sampling at that temperature.

Batching is lockstep: a round accepts ``j = min`` over the batch of the
per-row acceptance lengths, so one position serves the whole batch. The
serving scheduler keeps per-row lengths instead (:func:`batched_acceptance`).

The JAX package runs the loop as one ``lax.while_loop``; here it is a
Python loop over the port's dense ``prefill`` / ``decode_one`` /
``decode_chunk``, whose caches are written in place. The caches are never
rewound: rejected positions hold values that the position-masked attention
never reads and the next round overwrites. Random draws come from a
``torch.Generator`` (JAX's ``rng``); their bits differ from JAX's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SpecStats(NamedTuple):
    """Aggregate speculative statistics (returned with the ids)."""
    rounds: torch.Tensor         # target verify forwards run
    drafted: torch.Tensor        # draft tokens proposed (rounds * k)
    accepted: torch.Tensor       # draft tokens accepted by the target


def batched_acceptance(drafts, choices, eligible):
    """Per-row greedy acceptance for one batched speculative round (the
    serving scheduler's schedule), on device tensors.

    drafts (B, k) int: the draft's proposals; choices (B, k+1) int: the
    target's choice after consuming ``[last, d_1..d_i]`` for each i;
    eligible (B,) bool: rows not speculating this round are forced to
    acceptance 0 and emit ``choices[:, 0]``.

    Returns ``(accept_len (B,), emit (B, k+1))``, both int32: row ``b``
    emits ``emit[b, :accept_len[b]+1]``, its accepted draft prefix and the
    target's own choice at the first divergence. Every emitted token is one
    of the target's choices."""
    drafts = drafts.to(torch.int32)
    choices = choices.to(torch.int32)
    B, k = drafts.shape
    match = (drafts == choices[:, :k]).to(torch.int32)
    j = torch.cumprod(match, dim=1).sum(dim=1)
    j = torch.where(eligible.to(torch.bool), j, torch.zeros_like(j))
    bonus = choices.gather(1, j[:, None].long())
    dpad = torch.cat([drafts, drafts.new_zeros((B, 1))], dim=1)
    idx = torch.arange(k + 1, device=drafts.device)[None, :]
    emit = torch.where(idx < j[:, None], dpad,
                       torch.where(idx == j[:, None], bonus,
                                   torch.zeros_like(dpad)))
    return j.to(torch.int32), emit


def speculative_generate(model, params, draft_model, draft_params,
                         prompt_ids, max_new_tokens: int, k: int = 4,
                         temperature: float = 0.0, generator=None,
                         return_stats: bool = False):
    """Speculative generation (greedy at ``temperature == 0``, rejection
    sampling above). ``model`` / ``draft_model``: LM-mode ``Transformer``s
    over the same vocabulary on one device; ``k``: draft tokens a round;
    ``generator``: a ``torch.Generator`` on the model's device for the
    sampling mode (seed 0 when None). Returns (B, Tp + max_new_tokens)
    int64 ids, plus a :class:`SpecStats` when ``return_stats``."""
    if model.mode != "lm" or draft_model.mode != "lm":
        raise ValueError("speculative_generate needs LM-mode models")
    if model.vocab_size != draft_model.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    sampling = temperature > 0.0
    prompt = model._ids(prompt_ids)
    B, Tp = prompt.shape
    dev = prompt.device
    zero = torch.zeros((), dtype=torch.int32)
    if max_new_tokens <= 0:
        return (prompt, SpecStats(zero, zero, zero)) if return_stats \
            else prompt
    # a round may run k positions past the accepted length
    cap = Tp + max_new_tokens + k + 1
    if cap > model.max_len or cap > draft_model.max_len:
        raise ValueError(f"prompt + new tokens + k + 1 = {cap} exceeds "
                         f"max_len ({model.max_len}, {draft_model.max_len})")
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def probs(logits):
        return torch.softmax(logits.float() / temperature, dim=-1)

    def draw(p):
        return torch.multinomial(p, 1, generator=generator)[:, 0]

    with torch.no_grad():
        logits_t, caches_t = model.prefill(params, prompt, cap)
        _, caches_d = draft_model.prefill(draft_params, prompt, cap)
        first = (draw(probs(logits_t)) if sampling
                 else logits_t.argmax(-1))
        out = [first[:, None]]
        n, pos, last = 1, Tp, first
        rounds = accepted = 0
        ar = torch.arange(k + 1, device=dev)
        while n < max_new_tokens:
            # draft: k + 1 steps, the last one writing d_k's K/V so that a
            # fully accepted round leaves no hole in the draft cache
            tok, drafts, pdraft = last, [], []
            for i in range(k + 1):
                lg, caches_d = draft_model.decode_one(draft_params, tok,
                                                      pos + i, caches_d)
                if sampling:
                    p = probs(lg)
                    tok = draw(p)
                    pdraft.append(p)
                else:
                    tok = lg.argmax(-1)
                drafts.append(tok)
            drafts = torch.stack(drafts[:k], dim=1)            # (B, k)
            # verify: one chunked target forward over [last, d_1..d_k]
            chunk = torch.cat([last[:, None], drafts], dim=1)
            lg, caches_t = model.decode_chunk(params, chunk, pos, caches_t)
            dpad = torch.cat([drafts, drafts.new_zeros((B, 1))], dim=1)
            if sampling:
                p_t = probs(lg)                                # (B, k+1, V)
                p_d = torch.stack(pdraft[:k], dim=1)           # (B, k, V)
                d_idx = drafts[..., None]
                pt_d = p_t[:, :k].gather(-1, d_idx)[..., 0]
                pd_d = p_d.gather(-1, d_idx)[..., 0]
                u = torch.rand((B, k), generator=generator, device=dev)
                acc = (u * pd_d < pt_d).to(torch.int64)
                a_row = torch.cumprod(acc, dim=1).sum(dim=1)
                j = int(a_row.min())
                pt_j = p_t[:, j]
                pd_j = (torch.zeros_like(pt_j) if j == k
                        else p_d[:, min(j, k - 1)])
                res = (pt_j - pd_j).clamp(min=0.0)
                res = torch.where(res.sum(-1, keepdim=True) > 0, res, pt_j)
                res_tok = draw(res / res.sum(-1, keepdim=True))
                nxt = torch.where(a_row > j, dpad[:, j], res_tok)
            else:
                choices = lg.argmax(-1)
                match = (drafts == choices[:, :k]).to(torch.int64)
                j = int(torch.cumprod(match, dim=1).sum(dim=1).min())
                nxt = choices[:, j]
            emit = torch.where(ar[None, :] < j, dpad,
                               torch.where(ar[None, :] == j, nxt[:, None],
                                           torch.zeros_like(dpad)))
            out.append(emit[:, :j + 1])
            last, pos, n = nxt, pos + j + 1, n + j + 1
            rounds += 1
            accepted += j
    ids = torch.cat([prompt] + out, dim=1)[:, :Tp + max_new_tokens]
    if return_stats:
        return ids, SpecStats(torch.tensor(rounds, dtype=torch.int32),
                              torch.tensor(rounds * k, dtype=torch.int32),
                              torch.tensor(accepted, dtype=torch.int32))
    return ids
