"""Recurrent layers (counterpart of ``bigdl_tpu/nn/recurrent.py``): the
cells ``RnnCell`` / ``RNN``, ``LSTM``, ``LSTMPeephole``, ``GRU``,
``ConvLSTMPeephole`` (and its ``ConvLSTMPeephole3D`` alias) and
``MultiRNNCell``, and the wrappers ``Recurrent``, ``RecurrentDecoder``,
``BiRecurrent`` and ``TimeDistributed``.

The recurrence is written the way the JAX package writes it, not as
cuDNN's fused RNN (whose GRU computes ``r * (h W_hn + b_hn)`` where JAX
computes ``tanh(zn + (r * h) W_hn)``, and which takes no arbitrary
activations): a cell whose input projection does not depend on the
hidden state hoists it for all T timesteps into one (T B, in) x (in,
gates) product (``precompute``), and a Python loop over the timesteps
then runs only the hidden-to-hidden step (``step_pre``: one ``h @ w_h``
product and the gates' elementwise ops). JAX's ``lax.scan`` is one
compiled loop; here every step is a handful of eager launches, so a long
sequence of small steps is paced by the host (PERF.md).

Input layout is (batch, time, features...). Parameter trees carry JAX's
names: ``w_i`` (in, gates), ``w_h`` (hidden, gates), ``bias``, GRU's
``w_hn``, the peepholes ``p_i`` / ``p_f`` / ``p_o``; a wrapper nests its
cell under ``cell``, ``BiRecurrent`` under ``fwd`` / ``bwd``,
``MultiRNNCell`` under ``"0"``, ``"1"``, ..., ``TimeDistributed`` under
``layer``. A cell's hidden state is a tensor (RNN, GRU) or a
``Table(h, c)`` (the LSTMs), a ``MultiRNNCell``'s a ``Table`` of its
cells'.
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import torch

from ..utils.table import Table
from .conv import _conv2d, _same_pad
from .init import _uniform
from .module import Module

__all__ = ["Cell", "RnnCell", "RNN", "LSTM", "LSTMPeephole", "GRU",
           "ConvLSTMPeephole", "ConvLSTMPeephole3D", "MultiRNNCell",
           "Recurrent", "RecurrentDecoder", "BiRecurrent", "TimeDistributed"]


def _param(*shape):
    return torch.nn.Parameter(torch.empty(*shape))


def _uniform_(p, stdv, generator):
    p.copy_(_uniform(p.shape, stdv, generator, p.device))


def _forget_bias_(bias, hidden):
    """Gate order (i, f, g, o): zeros with the forget gate's block at 1."""
    bias.zero_()
    bias[hidden:2 * hidden] = 1.0


class Cell(Module):
    """Base recurrent cell: subclasses define ``init_hidden(batch_size,
    dtype)`` and ``step(params, x_t, h) -> (out_t, new_h)``. A cell whose
    input projection does not depend on the hidden state also defines
    ``precompute(params, xt)`` (the projection of every timestep of a
    (T, B, ...) input in one product) and ``step_pre(params, pre_t, h)``;
    the wrappers then loop over ``step_pre`` only. Used alone, a cell takes
    ``Table(x_t, hidden)`` (or a bare ``x_t``, from a zero hidden state)
    and returns ``Table(out, new_hidden)``. ``init_hidden`` puts the state
    on the cell's parameters' device."""

    def init_hidden(self, batch_size: int, dtype=torch.float32):
        raise NotImplementedError(type(self).__name__)

    def step(self, params, x_t, h):
        raise NotImplementedError(type(self).__name__)

    def precompute(self, params, xt):
        """The hoisted input projection of a (T, B, ...) input, or None
        when the cell has none (the wrappers then loop over ``step``)."""
        return None

    def step_pre(self, params, pre_t, h):
        raise NotImplementedError(type(self).__name__)

    def _device(self):
        p = next(self.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def call(self, params, x):
        if isinstance(x, Table):
            out, new_h = self.step(params, x[1], x[2])
        else:
            out, new_h = self.step(params, x,
                                   self.init_hidden(x.shape[0], x.dtype))
        return Table(out, new_h)


def _run_cell(cell, params, h, xt):
    """The outputs (T, B, ...) of ``cell`` over a (T, B, ...) input from
    hidden state ``h``, through the hoisted projection when the cell has
    one (``Cell``). Shared by ``Recurrent`` and ``BiRecurrent``."""
    pre = cell.precompute(params, xt)
    outs = []
    if pre is not None:
        for pre_t in pre.unbind(0):
            out, h = cell.step_pre(params, pre_t, h)
            outs.append(out)
    else:
        for x_t in xt.unbind(0):
            out, h = cell.step(params, x_t, h)
            outs.append(out)
    return torch.stack(outs, 0)


def _project(params, x):
    """``x @ w_i + bias`` over every leading dim of ``x`` as one product:
    for a (T, B, in) sequence, one (T B, in) x (in, gates) product."""
    flat = torch.addmm(params["bias"], x.reshape(-1, x.shape[-1]),
                       params["w_i"])
    return flat.reshape(tuple(x.shape[:-1]) + (flat.shape[-1],))


def _activation(act, default):
    """A string activation ("tanh", "relu", "sigmoid"), a callable on
    tensors, or None (``default``)."""
    if isinstance(act, str):
        return {"tanh": torch.tanh, "relu": torch.relu,
                "sigmoid": torch.sigmoid}[act]
    return act if callable(act) else default


class RnnCell(Cell):
    """Vanilla RNN cell (nn/RNN.scala): h' = act(x w_i + bias + h w_h),
    ``activation`` a string, a callable or None (tanh). As in the JAX
    package, ``isInputWithBias`` and the regularizers are accepted and
    ignored."""

    def __init__(self, input_size: int, hidden_size: int, activation=None,
                 isInputWithBias: bool = True, w_regularizer=None,
                 u_regularizer=None, b_regularizer=None, name=None):
        super().__init__(name=name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self.w_i = _param(input_size, hidden_size)
        self.w_h = _param(hidden_size, hidden_size)
        self.bias = _param(hidden_size)
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        for p in (self.w_i, self.w_h, self.bias):
            _uniform_(p, stdv, generator)

    def init_hidden(self, batch_size, dtype=torch.float32):
        return torch.zeros(batch_size, self.hidden_size, dtype=dtype,
                           device=self._device())

    def step(self, params, x_t, h):
        return self.step_pre(params, self.precompute(params, x_t), h)

    def precompute(self, params, xt):
        return _project(params, xt)

    def step_pre(self, params, pre_t, h):
        act = _activation(self.activation, torch.tanh)
        nh = act(pre_t + h @ params["w_h"])
        return nh, nh


class LSTM(Cell):
    """LSTM cell (nn/LSTM.scala): gates (i, f, g, o) from one ``w_i`` (in,
    4H) and ``w_h`` (H, 4H), the forget gate's bias 1. ``activation``
    (tanh) and ``inner_activation`` (sigmoid) are callables on tensors or
    None. As in the JAX package, the dropout ``p`` and the regularizers
    are accepted and ignored."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation=None, inner_activation=None, w_regularizer=None,
                 u_regularizer=None, b_regularizer=None, name=None):
        super().__init__(name=name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p
        self.activation = activation
        self.inner_activation = inner_activation
        self.w_i = _param(input_size, 4 * hidden_size)
        self.w_h = _param(hidden_size, 4 * hidden_size)
        self.bias = _param(4 * hidden_size)
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        _uniform_(self.w_i, stdv, generator)
        _uniform_(self.w_h, stdv, generator)
        _forget_bias_(self.bias, self.hidden_size)

    def init_hidden(self, batch_size, dtype=torch.float32):
        z = torch.zeros(batch_size, self.hidden_size, dtype=dtype,
                        device=self._device())
        return Table(z, z)

    def step(self, params, x_t, h):
        return self.step_pre(params, self.precompute(params, x_t), h)

    def precompute(self, params, xt):
        return _project(params, xt)

    def step_pre(self, params, pre_t, h):
        act = self.activation or torch.tanh
        inner = self.inner_activation or torch.sigmoid
        z = torch.addmm(pre_t, h[1], params["w_h"])
        i, f, g, o = z.chunk(4, -1)
        c = inner(f) * h[2] + inner(i) * act(g)
        hnew = inner(o) * act(c)
        return hnew, Table(hnew, c)


class LSTMPeephole(Cell):
    """LSTM with peephole connections (nn/LSTMPeephole.scala): the input
    and forget gates see c, the output gate the new c, through ``p_i``,
    ``p_f``, ``p_o``. ``p`` is accepted and ignored, as in the JAX
    package."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 name=None):
        super().__init__(name=name)
        self.input_size, self.hidden_size = input_size, hidden_size
        H = hidden_size
        self.w_i = _param(input_size, 4 * H)
        self.w_h = _param(H, 4 * H)
        self.bias = _param(4 * H)
        self.p_i, self.p_f, self.p_o = _param(H), _param(H), _param(H)
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        for p in (self.w_i, self.w_h, self.p_i, self.p_f, self.p_o):
            _uniform_(p, stdv, generator)
        _forget_bias_(self.bias, self.hidden_size)

    def init_hidden(self, batch_size, dtype=torch.float32):
        z = torch.zeros(batch_size, self.hidden_size, dtype=dtype,
                        device=self._device())
        return Table(z, z)

    def step(self, params, x_t, h):
        return self.step_pre(params, self.precompute(params, x_t), h)

    def precompute(self, params, xt):
        return _project(params, xt)

    def step_pre(self, params, pre_t, h):
        cx = h[2]
        z = torch.addmm(pre_t, h[1], params["w_h"])
        i, f, g, o = z.chunk(4, -1)
        i = torch.sigmoid(i + params["p_i"] * cx)
        f = torch.sigmoid(f + params["p_f"] * cx)
        c = f * cx + i * torch.tanh(g)
        o = torch.sigmoid(o + params["p_o"] * c)
        hnew = o * torch.tanh(c)
        return hnew, Table(hnew, c)


class GRU(Cell):
    """GRU cell (nn/GRU.scala), JAX's form: ``w_i`` (in, 3H) projects
    (r, z, n), ``w_h`` (H, 2H) covers r and z only, and the candidate is
    ``n = tanh(zn + (r * h) w_hn)``; h' = (1 - z) n + z h. The bias starts
    at zero. ``p`` and the regularizers are accepted and ignored, as in
    the JAX package."""

    def __init__(self, input_size: int, output_size: int, p: float = 0.0,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 name=None):
        super().__init__(name=name)
        self.input_size, self.hidden_size = input_size, output_size
        H = output_size
        self.w_i = _param(input_size, 3 * H)
        self.w_h = _param(H, 2 * H)
        self.w_hn = _param(H, H)
        self.bias = _param(3 * H)
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        for p in (self.w_i, self.w_h, self.w_hn):
            _uniform_(p, stdv, generator)
        self.bias.zero_()

    def init_hidden(self, batch_size, dtype=torch.float32):
        return torch.zeros(batch_size, self.hidden_size, dtype=dtype,
                           device=self._device())

    def step(self, params, x_t, h):
        return self.step_pre(params, self.precompute(params, x_t), h)

    def precompute(self, params, xt):
        return _project(params, xt)

    def step_pre(self, params, pre_t, h):
        H = self.hidden_size
        zr, zz, zn = pre_t[..., :H], pre_t[..., H:2 * H], pre_t[..., 2 * H:]
        hh = h @ params["w_h"]
        r = torch.sigmoid(zr + hh[..., :H])
        z = torch.sigmoid(zz + hh[..., H:])
        n = torch.tanh(zn + (r * h) @ params["w_hn"])
        hnew = (1 - z) * n + z * h
        return hnew, hnew


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM with peepholes over NCHW maps
    (nn/ConvLSTMPeephole.scala): ``w_i`` (4 O, I, k_i, k_i), ``w_h`` (4
    O, O, k_c, k_c), SAME padding at stride 1 whatever ``stride`` and
    ``padding`` say (the JAX package ignores them, and so does the port);
    peepholes ``p_i`` / ``p_f`` / ``p_o`` start at zero. The hidden maps'
    (H, W) come from ``set_spatial``, or from the first input a
    ``Recurrent`` sees. ``ConvLSTMPeephole3D`` is the same class, as in
    the JAX package."""

    def __init__(self, input_size: int, output_size: int, kernel_i: int = 3,
                 kernel_c: int = 3, stride: int = 1, padding: int = -1,
                 with_peephole: bool = True, name=None):
        super().__init__(name=name)
        self.input_size, self.output_size = input_size, output_size
        self.kernel_i, self.kernel_c = kernel_i, kernel_c
        self.with_peephole = with_peephole
        self.spatial = None
        O, I = output_size, input_size
        self.w_i = _param(4 * O, I, kernel_i, kernel_i)
        self.w_h = _param(4 * O, O, kernel_c, kernel_c)
        self.bias = _param(4 * O)
        if with_peephole:
            self.p_i, self.p_f, self.p_o = _param(O), _param(O), _param(O)
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / math.sqrt(self.input_size * self.kernel_i ** 2)
        _uniform_(self.w_i, stdv, generator)
        _uniform_(self.w_h, stdv, generator)
        _forget_bias_(self.bias, self.output_size)
        if self.with_peephole:
            for p in (self.p_i, self.p_f, self.p_o):
                p.zero_()

    def set_spatial(self, h, w):
        self.spatial = (h, w)
        return self

    def init_hidden(self, batch_size, dtype=torch.float32):
        if self.spatial is None:
            raise ValueError("call set_spatial(h, w) before init_hidden, or "
                             "use Recurrent which infers it from the input")
        z = torch.zeros(batch_size, self.output_size, *self.spatial,
                        dtype=dtype, device=self._device())
        return Table(z, z)

    @staticmethod
    def _conv(x, w):
        k = w.shape[-1]
        pads = tuple(_same_pad(n, k, 1) for n in x.shape[2:])
        return _conv2d(x, w, None, (1, 1), pads)

    def step(self, params, x_t, h):
        hx, cx = h[1], h[2]
        z = self._conv(x_t, params["w_i"]) + self._conv(hx, params["w_h"]) \
            + params["bias"][None, :, None, None]
        i, f, g, o = z.chunk(4, 1)
        if self.with_peephole:
            i = i + params["p_i"][None, :, None, None] * cx
            f = f + params["p_f"][None, :, None, None] * cx
        i, f = torch.sigmoid(i), torch.sigmoid(f)
        c = f * cx + i * torch.tanh(g)
        if self.with_peephole:
            o = o + params["p_o"][None, :, None, None] * c
        hnew = torch.sigmoid(o) * torch.tanh(c)
        return hnew, Table(hnew, c)


ConvLSTMPeephole3D = ConvLSTMPeephole


class MultiRNNCell(Cell):
    """A stack of cells acting as one (nn/MultiRNNCell.scala): params
    under ``"0"``, ``"1"``, ..., the hidden state a ``Table`` of the
    cells'. Only the first cell sees the sequence, so only its projection
    is hoisted; the others step on the previous cell's output."""

    def __init__(self, cells, name=None):
        super().__init__(name=name)
        for i, c in enumerate(cells):
            self.add_module(str(i), c)

    @property
    def cells(self):
        return list(self._modules.values())

    def init_hidden(self, batch_size, dtype=torch.float32):
        return Table(*[c.init_hidden(batch_size, dtype) for c in self.cells])

    def step(self, params, x_t, h):
        new_hs, out = [], x_t
        for i, c in enumerate(self.cells):
            out, nh = c.step(params[str(i)], out, h[i + 1])
            new_hs.append(nh)
        return out, Table(*new_hs)

    def precompute(self, params, xt):
        return self.cells[0].precompute(params["0"], xt)

    def step_pre(self, params, pre_t, h):
        cells = self.cells
        out, nh = cells[0].step_pre(params["0"], pre_t, h[1])
        new_hs = [nh]
        for i, c in enumerate(cells[1:], start=1):
            out, nh = c.step(params[str(i)], out, h[i + 1])
            new_hs.append(nh)
        return out, Table(*new_hs)


class Recurrent(Module):
    """Run a cell over (batch, time, ...) from a zero hidden state
    (nn/Recurrent.scala): (batch, time, ...) outputs. The cell's params
    are under ``cell``; ``training()`` / ``evaluate()`` /
    ``modules_iter`` reach it. A ``ConvLSTMPeephole`` without a spatial
    size takes it from the first input (and keeps it, as in the JAX
    package)."""

    def __init__(self, cell: Optional[Cell] = None, name=None):
        super().__init__(name=name)
        self.cell = cell

    def add(self, cell: Cell):
        self.cell = cell
        return self

    def _infer_spatial(self, x):
        if isinstance(self.cell, ConvLSTMPeephole) \
                and self.cell.spatial is None:
            self.cell.set_spatial(x.shape[-2], x.shape[-1])

    def call(self, params, x):
        self._infer_spatial(x)
        h0 = self.cell.init_hidden(x.shape[0], x.dtype)
        ys = _run_cell(self.cell, params["cell"], h0, x.transpose(0, 1))
        return ys.transpose(0, 1)

    def modules_iter(self):
        yield self
        if self.cell is not None:
            yield from self.cell.modules_iter()


class RecurrentDecoder(Module):
    """Feed each output back as the next input for ``seq_length`` steps
    (nn/RecurrentDecoder.scala): a (B, features) first input gives (B,
    seq_length, features)."""

    def __init__(self, seq_length: int, name=None):
        super().__init__(name=name)
        self.seq_length = seq_length
        self.cell: Optional[Cell] = None

    def add(self, cell: Cell):
        self.cell = cell
        return self

    def call(self, params, x):
        h = self.cell.init_hidden(x.shape[0], x.dtype)
        outs, inp = [], x
        for _ in range(self.seq_length):
            inp, h = self.cell.step(params["cell"], inp, h)
            outs.append(inp)
        return torch.stack(outs, 1)


class BiRecurrent(Module):
    """Bidirectional recurrence (nn/BiRecurrent.scala): the cell runs
    forward under params ``fwd`` and over the time-reversed input under
    ``bwd`` (its outputs flipped back). ``merge``: None adds the two (the
    reference's CAddTable), "concat" joins them on the last dim, a
    callable takes ``(fwd, bwd)``. The two parameter sets are two copies
    of the added cell, drawn apart; ``cell`` is the one added."""

    def __init__(self, merge=None, name=None):
        super().__init__(name=name)
        self.merge = merge

    @property
    def cell(self):
        return self._modules.get("fwd")

    def add(self, cell: Cell):
        self.fwd = cell
        self.bwd = copy.deepcopy(cell)
        self.bwd.reset()
        return self

    def _run(self, params, x):
        h0 = self.fwd.init_hidden(x.shape[0], x.dtype)
        return _run_cell(self.fwd, params, h0, x.transpose(0, 1)) \
            .transpose(0, 1)

    def call(self, params, x):
        fwd = self._run(params["fwd"], x)
        bwd = self._run(params["bwd"], x.flip(1)).flip(1)
        if self.merge == "concat":
            return torch.cat([fwd, bwd], -1)
        if callable(self.merge):
            return self.merge(fwd, bwd)
        return fwd + bwd


class TimeDistributed(Module):
    """Apply ``layer`` at every timestep (nn/TimeDistributed.scala), by
    folding time into the batch: one call on (B T, ...) instead of T.
    The layer's params and state are under ``layer`` and its new state is
    threaded back."""

    def __init__(self, layer: Module, name=None):
        super().__init__(name=name)
        self.layer = layer

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        b, t = x.shape[0], x.shape[1]
        y, new_sub = self.layer.apply(params["layer"], state["layer"],
                                      x.reshape((b * t,) + tuple(x.shape[2:])),
                                      training, generator)
        return y.reshape((b, t) + tuple(y.shape[1:])), \
            {**state, "layer": new_sub}


class RNN(RnnCell):
    """The reference's file name (nn/RNN.scala) for ``RnnCell``."""
