"""Sentence helpers (counterpart of ``bigdl_tpu/dataset/sentence.py``, the
pyspark reference's ``bigdl/dataset/sentence.py``). The reference tokenizes
with NLTK (Punkt + word_tokenize); these keep its function surface on
regular expressions, as the JAX package's do. ``sentence_tokenizer`` keeps
case and splits off every punctuation mark, where
``text.SentenceTokenizer`` lowercases for dictionary building."""
from __future__ import annotations

import re

__all__ = ["read_localfile", "sentences_split", "sentences_bipadding",
           "sentence_tokenizer"]


def read_localfile(fileName):
    with open(fileName) as f:
        return [line for line in f]


def sentences_split(line):
    return [s for s in re.split(r"(?<=[.!?])\s+", line.strip()) if s]


def sentences_bipadding(sent):
    return "SENTENCESTART " + sent + " SENTENCEEND"


def sentence_tokenizer(sentences):
    return re.findall(r"[\w']+|[^\w\s]", sentences)
