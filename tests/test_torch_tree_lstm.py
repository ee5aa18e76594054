"""The port's ``BinaryTreeLSTM`` against the JAX package
(``nn/tree_lstm.py``) on padded batches of binary trees of at most 7
nodes: output (every node's h, zeros at padding rows), parameter and
input gradients of sum(sin(out / 2)) at 1e-5 (float32;
``torch_parity_helpers.TOL``), JAX's side compiled once. Trees are
``TensorTree`` rows: 1-based children, 0 at a leaf, -1 on padding rows.
"""
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.table import Table
from torch_parity_helpers import check_pair

torch.set_num_threads(1)


def _tree(rows, n=7):
    t = nn.tensor_tree(n)
    t[:len(rows)] = rows
    return t


# node 1 is the root; leaves name their 1-based word
BALANCED = _tree([[2, 3, -1], [4, 5, 0], [6, 7, 0], [0, 0, 1], [0, 0, 2],
                  [0, 0, 3], [0, 0, 4]])
SPINE = _tree([[2, 5, -1], [3, 4, 0], [0, 0, 2], [0, 0, 1], [0, 0, 3]])
PAIR = _tree([[2, 3, -1], [0, 0, 2], [0, 0, 1]])


def _words(b, n, d, seed=0):
    return np.random.RandomState(seed).randn(b, n, d).astype(np.float32)


TREES = np.stack([BALANCED, SPINE, PAIR])

CASES = {
    "padded_batch": (lambda m: m.BinaryTreeLSTM(4, 6),
                     lambda: [_words(3, 4, 4), TREES]),
    "int_trees": (lambda m: m.BinaryTreeLSTM(4, 6),
                  lambda: [_words(3, 4, 4), TREES.astype(np.int32)]),
    "no_output_gate": (lambda m: m.BinaryTreeLSTM(3, 5, False),
                       lambda: [_words(3, 4, 3), TREES]),
    "max_depth_2": (lambda m: m.BinaryTreeLSTM(4, 6, max_depth=2),
                    lambda: [_words(3, 4, 4), TREES]),
    "single_tree": (lambda m: m.BinaryTreeLSTM(4, 6),
                    lambda: [_words(1, 4, 4)[0], SPINE]),
    "word_index_past_the_end": (lambda m: m.BinaryTreeLSTM(4, 6),
                                lambda: [_words(3, 2, 4), TREES]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tree_lstm_matches_jax(name):
    make, x = CASES[name]
    check_pair(make(jnn), make(nn), x(), training=True, jit=True)


def test_tuple_input_and_padding_rows():
    """A tuple works as the Table does; padding rows come out zero, and
    with a sweep per node every node of the deepest tree is done."""
    tm = nn.BinaryTreeLSTM(4, 6)
    words = torch.from_numpy(_words(3, 4, 4))
    trees = torch.from_numpy(TREES)
    out = tm.forward((words, trees))
    torch.testing.assert_close(out, tm.forward(Table(words, trees)))
    assert not out[1, 5:].any() and not out[2, 3:].any()
    assert out[0].abs().sum(-1).min() > 0


def test_the_sweep_runs_its_full_count_without_an_exit(monkeypatch):
    """Exactly ``max_depth`` (else node count) composer sweeps, each over
    every node: no early exit, which would read a flag back each sweep."""
    tm = nn.BinaryTreeLSTM(4, 6)
    shapes = []
    compose = tm._compose

    def counted(params, lc, lh, rc, rh):
        shapes.append(tuple(lc.shape))
        return compose(params, lc, lh, rc, rh)
    monkeypatch.setattr(tm, "_compose", counted)
    tm.forward(Table(torch.from_numpy(_words(3, 4, 4)),
                     torch.from_numpy(TREES)))
    assert shapes == [(3, 7, 6)] * 7
    shapes.clear()
    tm.max_depth = 3
    tm.forward(Table(torch.from_numpy(_words(3, 4, 4)),
                     torch.from_numpy(TREES)))
    assert len(shapes) == 3
