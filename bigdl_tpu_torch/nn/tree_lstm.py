"""TreeLSTM / BinaryTreeLSTM (counterpart of ``bigdl_tpu/nn/tree_lstm.py``;
Tai et al. 2015's constituency Tree-LSTM).

The JAX package sweeps each tree level-synchronously: every sweep composes
**every** node from its children's (c, h), and keeps the result only at
the nodes whose two children are done and which are not. Here the sweep
runs over the whole batch at once, a batched gather of the children over
(B, N) in place of JAX's per-tree ``vmap``, and it runs exactly as many
sweeps as JAX's scan (``max_depth``, or the node count), with no early
exit: an exit would read a flag back to the host each sweep.

Trees are the reference's ``TensorTree`` rows: (batch, nNodes, 3), columns
left / right child (1-based node numbers; 0 for none), and the leaf's
1-based word number; a padding row has -1 in column 0. Input ``Table(
inputs, trees)`` (or a tuple) with ``inputs`` (batch, nWords, inputSize);
output (batch, nNodes, hiddenSize), each node's h, zeros at padding rows.
"""
from __future__ import annotations

import numpy as np
import torch

from .init import RandomUniform
from .module import Module

__all__ = ["TreeLSTM", "BinaryTreeLSTM", "tensor_tree"]


class TreeLSTM(Module):
    """Abstract base (nn/TreeLSTM.scala)."""

    def __init__(self, input_size: int, hidden_size: int = 150, name=None):
        super().__init__(name=name)
        self.input_size = input_size
        self.hidden_size = hidden_size


class BinaryTreeLSTM(TreeLSTM):
    """Binary constituency Tree-LSTM (nn/BinaryTreeLSTM.scala).

    Leaf: ``c = x leaf_wc^T + leaf_bc``, ``h = sigmoid(x leaf_wo^T +
    leaf_bo) * tanh(c)`` (``tanh(c)`` without ``gate_output``). Composer:
    the gates i, lf, rf, u (and o) of ``lh comp_wl^T + rh comp_wr^T +
    comp_b``, (n_gate H, H) each, ``c = i u + lf lc + rf rc``. Weights
    U(+-1/sqrt(fan-in)), biases zero. ``with_graph`` is accepted and
    changes nothing, as in the JAX package. ``max_depth`` bounds the
    sweeps (None: the node count, enough for any tree)."""

    def __init__(self, input_size: int, hidden_size: int = 150,
                 gate_output: bool = True, with_graph: bool = True,
                 max_depth: int | None = None, name=None):
        super().__init__(input_size, hidden_size, name=name)
        self.gate_output = gate_output
        self.with_graph = with_graph
        self.max_depth = max_depth
        h, d = hidden_size, input_size
        n_gate = 5 if gate_output else 4
        p = lambda *s: torch.nn.Parameter(torch.empty(*s))
        self.leaf_wc, self.leaf_bc = p(h, d), p(h)
        self.comp_wl, self.comp_wr = p(n_gate * h, h), p(n_gate * h, h)
        self.comp_b = p(n_gate * h)
        if gate_output:
            self.leaf_wo, self.leaf_bo = p(h, d), p(h)
        self.reset()

    def _reset(self, generator):
        h, d = self.hidden_size, self.input_size
        init = RandomUniform()
        dev = self.leaf_wc.device
        ws = [(self.leaf_wc, d), (self.comp_wl, h), (self.comp_wr, h)]
        if self.gate_output:
            ws.append((self.leaf_wo, d))
        for w, fan_in in ws:
            w.copy_(init(w.shape, fan_in=fan_in, fan_out=w.shape[0],
                         generator=generator, device=dev))
        for b in (self.leaf_bc, self.comp_b) + (
                (self.leaf_bo,) if self.gate_output else ()):
            b.zero_()

    def _leaf(self, params, x):
        c = x @ params["leaf_wc"].T + params["leaf_bc"]
        if self.gate_output:
            o = torch.sigmoid(x @ params["leaf_wo"].T + params["leaf_bo"])
            return c, o * torch.tanh(c)
        return c, torch.tanh(c)

    def _compose(self, params, lc, lh, rc, rh):
        H = self.hidden_size
        g = lh @ params["comp_wl"].T + rh @ params["comp_wr"].T \
            + params["comp_b"]
        i = torch.sigmoid(g[..., :H])
        lf = torch.sigmoid(g[..., H:2 * H])
        rf = torch.sigmoid(g[..., 2 * H:3 * H])
        u = torch.tanh(g[..., 3 * H:4 * H])
        c = i * u + lf * lc + rf * rc
        if self.gate_output:
            return c, torch.sigmoid(g[..., 4 * H:5 * H]) * torch.tanh(c)
        return c, torch.tanh(c)

    def call(self, params, x):
        inputs, trees = (x[0], x[1]) if isinstance(x, (tuple, list)) \
            else (x[1], x[2])
        trees = torch.as_tensor(trees, device=inputs.device)
        squeeze = inputs.dim() == 2
        if squeeze:
            inputs, trees = inputs[None], trees[None]
        B, N, H = trees.shape[0], trees.shape[1], self.hidden_size
        left = trees[..., 0].to(torch.int64)
        right = trees[..., 1].to(torch.int64)
        leaf_idx = trees[..., 2].to(torch.int64)
        is_leaf = left == 0
        has_child = left > 0
        # the leaves' word vectors, (B, N, D)
        wi = (leaf_idx - 1).clamp(0, inputs.shape[1] - 1)
        wv = inputs.gather(1, wi[..., None].expand(B, N, inputs.shape[2]))
        lc, lh = self._leaf(params, wv)
        m = is_leaf[..., None]
        c = torch.where(m, lc, 0.0)
        h = torch.where(m, lh, 0.0)
        done = is_leaf
        li = (left - 1).clamp(0, N - 1)
        ri = (right - 1).clamp(0, N - 1)
        lg, rg = li[..., None].expand(B, N, H), ri[..., None].expand(B, N, H)
        for _ in range(self.max_depth or N):
            cc, hh = self._compose(params, c.gather(1, lg), h.gather(1, lg),
                                   c.gather(1, rg), h.gather(1, rg))
            ready = has_child & done.gather(1, li) & done.gather(1, ri) \
                & ~done
            rm = ready[..., None]
            c = torch.where(rm, cc, c)
            h = torch.where(rm, hh, h)
            done = done | ready
        return h[0] if squeeze else h


def tensor_tree(n_nodes: int):
    """An (n_nodes, 3) float32 numpy tree with every row padding (-1 in
    column 0), to be filled with (left, right, leaf word) rows
    (BinaryTreeLSTM.scala's ``TensorTree``)."""
    t = np.zeros((n_nodes, 3), np.float32)
    t[:, 0] = -1.0
    return t
