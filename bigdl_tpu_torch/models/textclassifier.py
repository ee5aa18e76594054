"""TextClassifier, the 20 Newsgroups model (counterpart of
``bigdl_tpu/models/textclassifier.py``; the reference's
``example/utils/TextClassifier.scala`` buildModel and the pyspark
``textclassifier.py`` with its lstm / gru encoders). Input (N,
sequence_length, embedding_dim) GloVe sequences; output log-probabilities
over ``class_num`` classes."""
from __future__ import annotations

import re
from collections import Counter

import numpy as np

from ..nn import (GRU, LSTM, Dropout, Linear, LogSoftMax, Recurrent, ReLU,
                  Select, Sequential, Squeeze, TemporalConvolution,
                  TemporalMaxPooling)
from ._build import placed

__all__ = ["TextClassifier", "tokenize_to_glove_sequences"]


def TextClassifier(class_num: int, embedding_dim: int = 50,
                   sequence_length: int = 500, encoder: str = "cnn",
                   encoder_output_dim: int = 256, device=None,
                   seed: int = 0):
    """``encoder`` "cnn" (a width-5 ``TemporalConvolution``, ReLU and a max
    over the whole sequence) or "lstm" / "gru" (a ``Recurrent`` whose last
    step is kept), then Linear(128), Dropout(0.2), ReLU, Linear(class_num)
    and log-softmax. Built on ``device`` with weights drawn from
    ``seed``."""
    model = Sequential()
    if encoder == "cnn":
        model.add(TemporalConvolution(embedding_dim, encoder_output_dim, 5))
        model.add(ReLU())
        model.add(TemporalMaxPooling(sequence_length - 5 + 1))
        model.add(Squeeze(2))
    elif encoder in ("lstm", "gru"):
        cell = LSTM(embedding_dim, encoder_output_dim) if encoder == "lstm" \
            else GRU(embedding_dim, encoder_output_dim)
        model.add(Recurrent().add(cell))
        model.add(Select(2, -1))
    else:
        raise ValueError(f"unsupported encoder {encoder}")
    model.add(Linear(encoder_output_dim, 128))
    model.add(Dropout(0.2))
    model.add(ReLU())
    model.add(Linear(128, class_num))
    model.add(LogSoftMax())
    return placed(model, device, seed)


def tokenize_to_glove_sequences(texts, w2v=None, sequence_length=500,
                                embedding_dim=50, max_words=5000):
    """The reference pipeline's featurisation on the host (TextClassifier.
    scala getData): lowercase word tokens, the ``max_words`` most frequent
    as the vocabulary, each kept token's vector (``w2v``, or
    ``news20.get_glove_w2v``'s) in order, zero-padded to
    ``sequence_length``. Returns (features (N, L, D) float32, labels (N,)
    int64, 1-based)."""
    from ..dataset.news20 import get_glove_w2v

    tokenized = [(re.findall(r"[a-z0-9]+", t.lower()), y) for t, y in texts]
    freq = Counter(w for toks, _ in tokenized for w in toks)
    vocab = set(w for w, _ in freq.most_common(max_words))
    if w2v is None:
        w2v = get_glove_w2v(None, dim=embedding_dim, vocab=vocab)
    zeros = np.zeros((embedding_dim,), np.float32)
    feats = np.zeros((len(tokenized), sequence_length, embedding_dim),
                     np.float32)
    labels = np.zeros((len(tokenized),), np.int64)
    for n, (toks, y) in enumerate(tokenized):
        vecs = [w2v.get(wd, zeros) for wd in toks[:sequence_length]
                if wd in vocab]
        if vecs:
            feats[n, :len(vecs)] = np.stack(vecs)
        labels[n] = y
    return feats, labels
