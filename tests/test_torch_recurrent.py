"""The port's recurrent layers against the JAX package
(``nn/recurrent.py``): every cell alone (``Table(x_t, hidden)`` and a bare
``x_t``) and under ``Recurrent``, ``MultiRNNCell``, ``BiRecurrent`` with
its three merges, ``RecurrentDecoder``, ``TimeDistributed`` over a
stateful layer, ``ConvLSTMPeephole`` with the spatial size taken from the
first input.

Output, new state, parameter and input gradients of sum(sin(out / 2)) at
1e-5 (float32; ``torch_parity_helpers.TOL``: six steps of 0.5 N(0, 1)
weights keep the sums' rounding near 1e-7), on JAX's parameters redrawn
from a numpy seed, JAX's side compiled once (``jit=True``). T <= 6,
hidden <= 8.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.table import Table
from torch_parity_helpers import check_pair

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _sin(m):
    """A callable activation of the package ``m``."""
    return jnp.sin if m is jnn else torch.sin


CASES = {
    # a cell alone: Table(x_t, hidden) and a bare x_t
    "rnn_cell_table": (lambda m: m.RnnCell(3, 5),
                       [_x(2, 3), _x(2, 5, seed=1)]),
    "rnn_cell_bare": (lambda m: m.RNN(3, 5, "relu"), _x(2, 3)),
    "lstm_cell_table": (lambda m: m.LSTM(3, 4),
                        [_x(2, 3), [_x(2, 4, seed=1), _x(2, 4, seed=2)]]),
    "peephole_cell_bare": (lambda m: m.LSTMPeephole(3, 4), _x(2, 3)),
    "gru_cell_table": (lambda m: m.GRU(3, 4), [_x(2, 3), _x(2, 4, seed=1)]),
    "multi_cell_table": (lambda m: m.MultiRNNCell([m.LSTM(3, 4),
                                                   m.GRU(4, 5)]),
                         [_x(2, 3), [[_x(2, 4, seed=1), _x(2, 4, seed=2)],
                                     _x(2, 5, seed=3)]]),
    "conv_lstm_cell_table": (lambda m: m.ConvLSTMPeephole(2, 3, 3, 3)
                             .set_spatial(4, 5),
                             [_x(2, 2, 4, 5), [_x(2, 3, 4, 5, seed=1),
                                               _x(2, 3, 4, 5, seed=2)]]),
    # Recurrent over (B, T, ...)
    "recurrent_rnn_tanh": (lambda m: m.Recurrent(m.RnnCell(3, 5)),
                           _x(2, 6, 3)),
    "recurrent_rnn_sigmoid": (lambda m: m.Recurrent(m.RnnCell(
        3, 5, "sigmoid")), _x(2, 6, 3)),
    "recurrent_rnn_callable": (lambda m: m.Recurrent(m.RnnCell(
        3, 5, _sin(m))), _x(2, 6, 3)),
    "recurrent_lstm": (lambda m: m.Recurrent().add(m.LSTM(3, 6)),
                       _x(2, 6, 3)),
    "recurrent_lstm_activations": (lambda m: m.Recurrent(m.LSTM(
        3, 4, 0.3, _sin(m), _sin(m))), _x(2, 5, 3)),
    "recurrent_peephole": (lambda m: m.Recurrent(m.LSTMPeephole(3, 6)),
                           _x(2, 6, 3)),
    "recurrent_gru": (lambda m: m.Recurrent(m.GRU(3, 6)), _x(3, 6, 3)),
    "recurrent_multi_lstm": (lambda m: m.Recurrent(m.MultiRNNCell(
        [m.LSTM(3, 5), m.LSTM(5, 5)])), _x(2, 6, 3)),
    "recurrent_multi_mixed": (lambda m: m.Recurrent(m.MultiRNNCell(
        [m.GRU(3, 4), m.RnnCell(4, 5), m.LSTMPeephole(5, 3)])), _x(2, 5, 3)),
    "recurrent_conv_lstm": (lambda m: m.Recurrent(m.ConvLSTMPeephole(
        2, 3, 3, 3)), _x(2, 4, 2, 5, 4)),
    "recurrent_conv_lstm_no_peephole_k2": (lambda m: m.Recurrent(
        m.ConvLSTMPeephole(2, 3, 2, 3, 2, 0, False)), _x(2, 3, 2, 4, 5)),
    "recurrent_conv_lstm_3d_alias": (lambda m: m.Recurrent(
        m.ConvLSTMPeephole3D(1, 2, 3, 1)), _x(1, 3, 1, 4, 4)),
    # BiRecurrent: add, concat, a callable merge
    "bi_add": (lambda m: m.BiRecurrent().add(m.LSTM(3, 4)), _x(2, 5, 3)),
    "bi_concat": (lambda m: m.BiRecurrent("concat").add(m.GRU(3, 4)),
                  _x(2, 5, 3)),
    "bi_callable": (lambda m: m.BiRecurrent(lambda a, b: a * b).add(
        m.RnnCell(3, 4)), _x(2, 5, 3)),
    "bi_multi": (lambda m: m.BiRecurrent("concat").add(m.MultiRNNCell(
        [m.LSTM(3, 4), m.GRU(4, 4)])), _x(2, 4, 3)),
    # RecurrentDecoder feeds each output back
    "decoder_lstm": (lambda m: m.RecurrentDecoder(5).add(m.LSTM(4, 4)),
                     _x(2, 4)),
    "decoder_gru": (lambda m: m.RecurrentDecoder(4).add(m.GRU(3, 3)),
                    _x(3, 3)),
    "decoder_multi": (lambda m: m.RecurrentDecoder(3).add(m.MultiRNNCell(
        [m.RnnCell(4, 5), m.LSTM(5, 4)])), _x(2, 4)),
    # TimeDistributed
    "time_distributed_linear": (lambda m: m.TimeDistributed(m.Linear(4, 3)),
                                _x(2, 5, 4)),
    "time_distributed_conv": (lambda m: m.TimeDistributed(
        m.SpatialConvolution(2, 3, 3, 3, 1, 1, 1, 1)), _x(2, 3, 2, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_recurrent_matches_jax(name):
    make, x = CASES[name]
    check_pair(make(jnn), make(nn), x, training=True, jit=True)


def _bn_state(js):
    rng = np.random.RandomState(9)
    return {"layer": {"running_mean": rng.randn(4).astype(np.float32),
                      "running_var": (rng.rand(4) + 0.5).astype(np.float32)}}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_time_distributed_threads_the_layer_state(training):
    """A BatchNormalization inside: the batch statistics are over B T rows
    and the new running statistics come back under ``layer``."""
    make = lambda m: m.TimeDistributed(m.BatchNormalization(4))
    check_pair(make(jnn), make(nn), _x(3, 5, 4), training=training,
               state=_bn_state, jit=True)


def test_recurrent_hoists_the_input_projection():
    """One (T B, in) x (in, 4H) product for every timestep, then one
    h x w_h product a step: the split the GPU's launch count rests on."""
    from torch.overrides import TorchFunctionMode

    class Products(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.addmm, torch.matmul, torch.Tensor.__matmul__):
                a = args[1] if func is torch.addmm else args[0]
                self.shapes.append(tuple(a.shape))
            return func(*args, **(kwargs or {}))

    rec = nn.Recurrent(nn.LSTM(3, 4))
    with Products() as mode:
        rec.forward(torch.randn(2, 6, 3))
    assert mode.shapes == [(12, 3)] + [(2, 4)] * 6


def test_wrappers_reach_the_cell():
    """``training()`` / ``evaluate()`` / ``modules_iter`` reach the cell
    as in JAX; ``add`` returns the wrapper; ``Recurrent`` keeps the spatial
    size of the first input, as JAX's mutates its cell."""
    for m in (jnn, nn):
        cell = m.LSTM(3, 4)
        rec = m.Recurrent().add(cell)
        rec.evaluate()
        assert not (cell.is_training() if m is nn else cell.train_mode)
        rec.training()
        assert (cell.is_training() if m is nn else cell.train_mode)
        assert [type(x).__name__ for x in rec.modules_iter()] == \
            ["Recurrent", "LSTM"]
    conv = nn.ConvLSTMPeephole(2, 3)
    with pytest.raises(ValueError):
        conv.init_hidden(2)
    rec = nn.Recurrent(conv)
    rec.forward(torch.randn(1, 2, 2, 4, 5))
    assert conv.spatial == (4, 5)
    out = conv.forward(Table(torch.randn(1, 2, 4, 5), conv.init_hidden(1)))
    assert out[1].shape == (1, 3, 4, 5) and out[2][2].shape == (1, 3, 4, 5)


def test_bi_recurrent_directions_have_their_own_weights():
    bi = nn.BiRecurrent().add(nn.GRU(3, 4))
    assert bi.cell is bi.fwd
    assert not torch.equal(bi.params["fwd"]["w_h"], bi.params["bwd"]["w_h"])
    assert sorted(bi.params) == ["bwd", "fwd"]


def test_lstm_forget_bias_and_ignored_arguments():
    """The forget gate's bias starts at 1; ``p``, ``isInputWithBias`` and
    the regularizers are accepted and change nothing, as in JAX."""
    cell = nn.LSTM(3, 4, 0.5, w_regularizer="ignored")
    assert cell.bias.tolist() == [0.0] * 4 + [1.0] * 4 + [0.0] * 8
    rnn = nn.RnnCell(3, 4, None, False, "w", "u", "b")
    assert sorted(rnn.params) == ["bias", "w_h", "w_i"]
    conv = nn.ConvLSTMPeephole(2, 3, stride=2, padding=0)
    assert not conv.p_i.any() and conv.bias[3:6].tolist() == [1.0] * 3
