"""Text pipeline (counterpart of ``bigdl_tpu/dataset/text.py``, the
reference's ``dataset/text/``): SentenceSplitter, SentenceBiPadding,
SentenceTokenizer, Dictionary, TextToLabeledSentence,
LabeledSentenceToSample, and ``ptb_synthetic``, the PTB-like corpus that
stands in for the real one (which is not in the repository). Host-side
numpy; the same calls give the same tokens, ids and corpus as the JAX
package's.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import List, Optional

import numpy as np

from .sample import Sample
from .transformer import Transformer

__all__ = ["SentenceSplitter", "SentenceBiPadding", "SentenceTokenizer",
           "Dictionary", "LabeledSentence", "TextToLabeledSentence",
           "LabeledSentenceToSample", "ptb_synthetic"]


class SentenceSplitter(Transformer):
    """Split raw text into sentences (dataset/text/SentenceSplitter.scala)."""

    def apply(self, it):
        for doc in it:
            for s in re.split(r"(?<=[.!?])\s+", doc.strip()):
                if s:
                    yield s


class SentenceBiPadding(Transformer):
    """Wrap each sentence as "<start> x <end>"
    (dataset/text/SentenceBiPadding.scala; default tokens match the
    reference's SentenceToken start/end)."""

    def __init__(self, start=None, end=None):
        self.start = start if start is not None else "SENTENCESTART"
        self.end = end if end is not None else "SENTENCEEND"

    def apply(self, it):
        for s in it:
            yield f"{self.start} {s} {self.end}"


class SentenceTokenizer(Transformer):
    """Tokenize sentences (dataset/text/SentenceTokenizer.scala)."""

    def apply(self, it):
        for sent in it:
            toks = re.findall(r"[\w']+|[.,!?;]", sent.lower())
            if toks:
                yield toks


class Dictionary:
    """Vocabulary (dataset/text/Dictionary.scala). Index 0 reserved for
    unknown ('<unk>'); ids are 0-based here, +1 shift applied when building
    LookupTable inputs (1-based embedding ids)."""

    def __init__(self, sentences=None, vocab_size: Optional[int] = None):
        self.word2idx = {}
        self.idx2word = []
        if sentences is not None:
            self.build(sentences, vocab_size)

    def build(self, sentences, vocab_size=None):
        counts = Counter()
        for s in sentences:
            counts.update(s if isinstance(s, (list, tuple)) else s.split())
        vocab = [w for w, _ in counts.most_common(vocab_size)]
        self.idx2word = ["<unk>"] + vocab
        self.word2idx = {w: i for i, w in enumerate(self.idx2word)}
        return self

    def get_index(self, word):
        return self.word2idx.get(word, 0)

    def get_word(self, idx):
        return self.idx2word[idx] if 0 <= idx < len(self.idx2word) else "<unk>"

    def vocab_size(self):
        return len(self.idx2word)

    def __len__(self):
        return len(self.idx2word)


class LabeledSentence:
    """(dataset/text/LabeledSentence.scala) — data ids + label ids (next-word
    targets for LM)."""

    def __init__(self, data, label):
        self.data = np.asarray(data, np.int64)
        self.label = np.asarray(label, np.int64)


class TextToLabeledSentence(Transformer):
    """token list → LabeledSentence with next-word labels
    (dataset/text/TextToLabeledSentence.scala)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def apply(self, it):
        for toks in it:
            ids = [self.dictionary.get_index(t) for t in toks]
            if len(ids) < 2:
                continue
            yield LabeledSentence(ids[:-1], ids[1:])


class LabeledSentenceToSample(Transformer):
    """LabeledSentence → Sample (dataset/text/LabeledSentenceToSample.scala).
    Ids are shifted +1 (1-based, LookupTable convention); optional fixed
    length pad/truncate."""

    def __init__(self, fixed_length: Optional[int] = None, padding_value=0):
        self.fixed_length = fixed_length
        self.padding_value = padding_value

    def apply(self, it):
        for ls in it:
            d = ls.data + 1
            l = ls.label + 1
            if self.fixed_length is not None:
                T = self.fixed_length
                if len(d) >= T:
                    d, l = d[:T], l[:T]
                else:
                    pad = np.full(T - len(d), self.padding_value, np.int64)
                    d = np.concatenate([d, pad])
                    l = np.concatenate([l, pad])
            yield Sample(d.astype(np.float32), l.astype(np.float32))


def ptb_synthetic(n_sentences=256, vocab=200, max_len=20, seed=0):
    """Synthetic PTB-like corpus: markov-chain token sequences (deterministic,
    learnable structure) for the zero-egress environment."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab)
    sents = []
    for _ in range(n_sentences):
        length = rng.randint(5, max_len)
        toks = [rng.randint(vocab)]
        for _ in range(length - 1):
            toks.append(rng.choice(vocab, p=trans[toks[-1]]))
        sents.append([f"w{t}" for t in toks])
    return sents
