"""Recommender models: Neural Collaborative Filtering and Wide&Deep
(counterpart of ``bigdl_tpu/models/recommender.py``).

Both take an (N, 2) array of 1-based ``[user, item]`` id pairs (the layout
of ``dataset.movielens.get_id_pairs``; float ids are truncated) and give a
sigmoid interaction score (N,), for ``BCECriterion`` and the HitRatio /
NDCG validation methods. ``WideAndDeep`` (Cheng et al. 2016) sums a wide
half (linear user / item weights and a hashed user x item cross bucket)
and a deep half (embeddings -> MLP) before the sigmoid.
"""
from __future__ import annotations

import torch

from ..nn import Linear, ReLU, Sequential
from ..nn.init import RandomNormal
from ..nn.module import Module
from ._build import placed

__all__ = ["NeuralCFEmbedding", "NeuralCF", "WideDeepInput", "WideAndDeep"]

_CROSS_MULT = 2654435761    # the cross bucket's multiplicative hash
_U32 = 0xFFFFFFFF


def _pair_ids(x, user_count, item_count):
    """0-based (user, item) rows of a pair array, clipped into range."""
    ids = torch.as_tensor(x).to(torch.int32).long()
    return ((ids[..., 0] - 1).clamp(0, user_count - 1),
            (ids[..., 1] - 1).clamp(0, item_count - 1))


class NeuralCFEmbedding(Module):
    """The user and item embeddings of the GMF and MLP towers, gathered
    from one (N, 2) pair tensor; N(0, 0.01) tables ``mf_user`` /
    ``mf_item`` (mf_dim) and ``mlp_user`` / ``mlp_item`` (mlp_dim). Output
    (N, mf_dim + 2 mlp_dim): the GMF product, then the two MLP
    embeddings."""

    def __init__(self, user_count, item_count, mf_dim, mlp_dim, name=None):
        super().__init__(name=name)
        self.user_count, self.item_count = user_count, item_count
        self.mf_dim, self.mlp_dim = mf_dim, mlp_dim
        P = torch.nn.Parameter
        self.mf_user = P(torch.empty(user_count, mf_dim))
        self.mf_item = P(torch.empty(item_count, mf_dim))
        self.mlp_user = P(torch.empty(user_count, mlp_dim))
        self.mlp_item = P(torch.empty(item_count, mlp_dim))
        self._reset(None)

    def _reset(self, generator):
        init = RandomNormal(0.0, 0.01)
        for p in (self.mf_user, self.mf_item, self.mlp_user, self.mlp_item):
            p.data.copy_(init(p.shape, generator=generator, device=p.device))

    def call(self, params, x):
        u, i = _pair_ids(x, self.user_count, self.item_count)
        u, i = u.to(params["mf_user"].device), i.to(params["mf_user"].device)
        gmf = params["mf_user"][u] * params["mf_item"][i]
        return torch.cat([gmf, params["mlp_user"][u],
                          params["mlp_item"][i]], -1)


class _NcfHead(Module):
    """The GMF passthrough beside the MLP tower, then one affine unit and
    the sigmoid."""

    def __init__(self, mf_dim, mlp_dim, hidden_layers, name=None):
        super().__init__(name=name)
        self.mf_dim = mf_dim
        self.mlp = Sequential()
        prev = 2 * mlp_dim
        for h in hidden_layers:
            self.mlp.add(Linear(prev, h))
            self.mlp.add(ReLU())
            prev = h
        self.final = Linear(mf_dim + prev, 1)

    def call(self, params, x):
        gmf, mlp_in = x[..., :self.mf_dim], x[..., self.mf_dim:]
        h, _ = self.mlp.apply(params["mlp"], self.mlp.state, mlp_in)
        z = self.final.call(params["final"], torch.cat([gmf, h], -1))
        return torch.sigmoid(z)[..., 0]


def NeuralCF(user_count: int, item_count: int, mf_dim: int = 8,
             mlp_dim: int = 16, hidden_layers=(32, 16, 8), device=None,
             seed: int = 0):
    """NCF (He et al. 2017): GMF and MLP over (user, item) id pairs -> a
    score in (0, 1) of shape (N,). Built on ``device`` with weights drawn
    from ``seed``."""
    model = Sequential()
    model.add(NeuralCFEmbedding(user_count, item_count, mf_dim, mlp_dim))
    model.add(_NcfHead(mf_dim, mlp_dim, hidden_layers))
    return placed(model, device, seed)


class WideDeepInput(Module):
    """Wide half: linear user and item weights and a user x item cross
    bucket ``(u * 2654435761 + i) mod 2^32 mod cross_buckets`` (JAX's
    wrapping uint32 arithmetic, here in int64 masked to 32 bits), all
    zero-initialised; deep half: N(0, 0.01) user and item embeddings.
    Output (N, 1 + 2 embed_dim): the wide sum, then the embeddings."""

    def __init__(self, user_count, item_count, embed_dim=16,
                 cross_buckets=1000, name=None):
        super().__init__(name=name)
        self.user_count, self.item_count = user_count, item_count
        self.embed_dim, self.cross_buckets = embed_dim, cross_buckets
        P = torch.nn.Parameter
        self.wide_user = P(torch.zeros(user_count))
        self.wide_item = P(torch.zeros(item_count))
        self.wide_cross = P(torch.zeros(cross_buckets))
        self.emb_user = P(torch.empty(user_count, embed_dim))
        self.emb_item = P(torch.empty(item_count, embed_dim))
        self._reset(None)

    def _reset(self, generator):
        init = RandomNormal(0.0, 0.01)
        for p in (self.wide_user, self.wide_item, self.wide_cross):
            p.data.zero_()
        for p in (self.emb_user, self.emb_item):
            p.data.copy_(init(p.shape, generator=generator, device=p.device))

    def _cross_bucket(self, u, i):
        """The cross bucket of 0-based user and item rows (int64)."""
        return ((u * _CROSS_MULT + i) & _U32) % self.cross_buckets

    def call(self, params, x):
        u, i = _pair_ids(x, self.user_count, self.item_count)
        dev = params["wide_user"].device
        u, i = u.to(dev), i.to(dev)
        cross = self._cross_bucket(u, i)
        wide = (params["wide_user"][u] + params["wide_item"][i]
                + params["wide_cross"][cross])
        return torch.cat([wide[..., None], params["emb_user"][u],
                          params["emb_item"][i]], -1)


class _WideDeepHead(Module):
    def __init__(self, embed_dim, hidden_layers, name=None):
        super().__init__(name=name)
        self.deep = Sequential()
        prev = 2 * embed_dim
        for h in hidden_layers:
            self.deep.add(Linear(prev, h))
            self.deep.add(ReLU())
            prev = h
        self.deep_out = Linear(prev, 1)
        self.bias = torch.nn.Parameter(torch.zeros(()))

    def _reset(self, generator):
        self.bias.data.zero_()

    def call(self, params, x):
        h, _ = self.deep.apply(params["deep"], self.deep.state, x[..., 1:])
        d = self.deep_out.call(params["deep_out"], h)[..., 0]
        return torch.sigmoid(x[..., 0] + d + params["bias"])


def WideAndDeep(user_count: int, item_count: int, embed_dim: int = 16,
                hidden_layers=(64, 32, 16), cross_buckets: int = 1000,
                device=None, seed: int = 0):
    """Wide&Deep (Cheng et al. 2016) over (user, item) id pairs -> a score
    in (0, 1) of shape (N,). Built on ``device`` with weights drawn from
    ``seed``."""
    model = Sequential()
    model.add(WideDeepInput(user_count, item_count, embed_dim, cross_buckets))
    model.add(_WideDeepHead(embed_dim, hidden_layers))
    return placed(model, device, seed)
