"""RNN language models (counterpart of ``bigdl_tpu/models/rnn.py``, the
reference's ``models/rnn/PTBModel.scala`` and ``SimpleRNN.scala``)."""
from __future__ import annotations

from ..nn import (GRU, LSTM, Dropout, Linear, LogSoftMax, LookupTable,
                  MultiRNNCell, Recurrent, RnnCell, Select, Sequential,
                  TimeDistributed)
from ._build import placed

__all__ = ["PTBModel", "SimpleRNN"]


def PTBModel(input_size: int, hidden_size: int = 256, output_size: int = None,
             num_layers: int = 2, keep_prob: float = 1.0,
             cell_type: str = "lstm", device=None, seed: int = 0):
    """Embedding, ``num_layers`` stacked LSTM (or, for any other
    ``cell_type``, GRU) cells under one ``Recurrent``, a per-step
    ``Linear`` and log-softmax (models/rnn/PTBModel.scala): (B, T) 1-based
    token ids -> (B, T, output_size) log-probabilities. ``keep_prob`` < 1
    adds dropout after the embedding. Built on ``device`` with weights
    drawn from ``seed``."""
    output_size = output_size or input_size
    model = Sequential()
    model.add(LookupTable(input_size, hidden_size))
    if keep_prob < 1.0:
        model.add(Dropout(1.0 - keep_prob))
    cell = LSTM if cell_type == "lstm" else GRU
    cells = [cell(hidden_size, hidden_size) for _ in range(num_layers)]
    model.add(Recurrent(MultiRNNCell(cells) if len(cells) > 1 else cells[0]))
    model.add(TimeDistributed(Linear(hidden_size, output_size)))
    model.add(LogSoftMax(axis=-1))
    return placed(model, device, seed)


def SimpleRNN(input_size: int = 100, hidden_size: int = 40,
              output_size: int = 10, device=None, seed: int = 0):
    """One tanh RNN over (B, T, input_size), its last step through a
    ``Linear`` and log-softmax (models/rnn/SimpleRNN.scala)."""
    model = Sequential()
    model.add(Recurrent(RnnCell(input_size, hidden_size)))
    model.add(Select(2, -1))
    model.add(Linear(hidden_size, output_size))
    model.add(LogSoftMax())
    return placed(model, device, seed)
