"""20 Newsgroups and GloVe loaders (counterpart of
``bigdl_tpu/dataset/news20.py``, the pyspark reference's
``bigdl/dataset/news20.py``): ``get_news20`` reads an extracted
``20news-18828`` folder and ``get_glove_w2v`` a ``glove.6B.<dim>d.txt``.
Nothing is downloaded: without the corpus ``get_news20`` returns
``synthetic``'s corpus of class-correlated words, and without the vectors
``get_glove_w2v`` gives each token a random vector seeded by its crc32 -
the same corpus and vectors as the JAX package's, draw for draw.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["synthetic", "get_news20", "get_glove_w2v"]

CLASS_NUM = 20

_TOPIC_WORDS = [
    ["game", "team", "score", "season", "player", "win"],
    ["space", "orbit", "nasa", "launch", "moon", "shuttle"],
    ["car", "engine", "drive", "wheel", "dealer", "mile"],
    ["windows", "file", "driver", "program", "disk", "dos"],
    ["god", "church", "faith", "bible", "belief", "scripture"],
    ["gun", "law", "right", "state", "crime", "weapon"],
    ["image", "graphics", "color", "format", "display", "pixel"],
    ["price", "sale", "offer", "ship", "sell", "condition"],
    ["doctor", "disease", "patient", "medicine", "health", "treatment"],
    ["key", "encryption", "security", "chip", "privacy", "clipper"],
]

_FILLER = ["the", "a", "of", "and", "to", "in", "is", "that", "it", "for",
           "on", "with", "as", "was", "this", "but", "they", "have"]


def synthetic(n_per_class=30, class_num=CLASS_NUM, doc_len=60, seed=0):
    """Deterministic synthetic (text, label) list, labels 1-based like the
    reference's ``get_news20``."""
    rng = np.random.RandomState(seed)
    texts = []
    for label in range(1, class_num + 1):
        topic = _TOPIC_WORDS[(label - 1) % len(_TOPIC_WORDS)]
        # classes sharing a topic list are distinguished by a class token
        marker = f"class{label}tok"
        for _ in range(n_per_class):
            words = []
            for _ in range(doc_len):
                r = rng.rand()
                if r < 0.35:
                    words.append(topic[rng.randint(len(topic))])
                elif r < 0.45:
                    words.append(marker)
                else:
                    words.append(_FILLER[rng.randint(len(_FILLER))])
            texts.append((" ".join(words), label))
    return texts


def get_news20(source_dir=None, n_per_class=30):
    """Return list of (content, label). Parses an on-disk ``20news-18828``
    tree when present (reference layout: one folder per class, numeric file
    names); otherwise synthetic."""
    if source_dir:
        for root in (os.path.join(source_dir, "20news-18828"), source_dir):
            if os.path.isdir(root):
                texts = []
                label_id = 0
                subdirs = [d for d in sorted(os.listdir(root))
                           if os.path.isdir(os.path.join(root, d))]
                if subdirs:
                    for name in subdirs:
                        label_id += 1
                        path = os.path.join(root, name)
                        for fname in sorted(os.listdir(path)):
                            if fname.isdigit():
                                with open(os.path.join(path, fname),
                                          encoding="latin-1") as f:
                                    texts.append((f.read(), label_id))
                    return texts
    return synthetic(n_per_class=n_per_class)


def get_glove_w2v(source_dir=None, dim=50, vocab=None, seed=0):
    """Return dict token → float32 vector. Reads ``glove.6B.<dim>d.txt`` when
    present; otherwise deterministic per-token random vectors (hash-seeded so
    the same token always maps to the same vector)."""
    if source_dir:
        for cand in (os.path.join(source_dir, "glove.6B",
                                  f"glove.6B.{dim}d.txt"),
                     os.path.join(source_dir, f"glove.6B.{dim}d.txt")):
            if os.path.exists(cand):
                w2v = {}
                with open(cand, encoding="utf-8") as f:
                    for line in f:
                        parts = line.rstrip().split(" ")
                        if vocab is not None and parts[0] not in vocab:
                            continue
                        w2v[parts[0]] = np.asarray(parts[1:], np.float32)
                return w2v
    if vocab is None:
        return {}
    import zlib
    out = {}
    for tok in vocab:
        h = (zlib.crc32(tok.encode("utf-8")) ^ seed) & 0x7FFFFFFF
        out[tok] = np.random.RandomState(h).randn(dim).astype(np.float32) * 0.1
    return out
