"""The sequence models and their text data against the JAX package:
``models/rnn.py`` (``PTBModel``, ``SimpleRNN``), ``models/textclassifier.py``
(``TextClassifier`` with each encoder, ``tokenize_to_glove_sequences``),
``dataset/text.py``, ``dataset/sentence.py`` and ``dataset/news20.py``.

The models, in evaluation mode (dropout off), vocab <= 50, hidden <= 16,
T <= 6, on JAX's parameters redrawn as 0.5 N(0, 1), JAX's side compiled
once: the float32 output at 1e-5 (``torch_parity_helpers.TOL``), then the
output and every parameter's and float input's gradient of sum(sin(out /
2)) in float64 in both packages (JAX's x64 mode) at 1e-9. Whole models
sum hundreds of such products: their float32 gradients reach ~20, where
the two packages' summation orders leave ~2e-5 apart on a leaf (the
TextClassifier's convolution weight), rounding and not semantics, which
float64 holds to ~1e-14. A ``save_weights`` file crosses the packages
both ways. The data: the same corpora, vectors, ids and samples, element for
element (``ptb_synthetic``'s Markov chain and ``news20.synthetic`` draw
with numpy's ``RandomState`` as JAX's do, and the GloVe fallback seeds a
token's vector with its crc32).
"""
import os

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import models as jmodels
from bigdl_tpu.dataset import news20 as jnews20
from bigdl_tpu.dataset import sentence as jsentence
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu_torch import convert, models
from bigdl_tpu_torch.dataset import news20, sentence, text
from torch_parity_helpers import (TOL, close, jax_params, leaves, load,
                                  run_jax, run_port)

torch.set_num_threads(1)


def _ids(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(1, vocab + 1, size=(b, t)) \
        .astype(np.int32)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


MODELS = {
    "ptb_lstm_2_layers": (lambda m, **kw: m.PTBModel(40, 12, **kw),
                          _ids(3, 6, 40)),
    "ptb_gru_1_layer_out": (lambda m, **kw: m.PTBModel(
        30, 10, 20, 1, 1.0, "gru", **kw), _ids(2, 5, 30)),
    "ptb_lstm_3_layers_dropout": (lambda m, **kw: m.PTBModel(
        50, 8, None, 3, 0.7, **kw), _ids(2, 4, 50)),
    "simple_rnn": (lambda m, **kw: m.SimpleRNN(6, 8, 5, **kw), _x(3, 5, 6)),
    "textclassifier_cnn": (lambda m, **kw: m.TextClassifier(
        5, 6, 12, "cnn", 8, **kw), _x(2, 12, 6)),
    "textclassifier_lstm": (lambda m, **kw: m.TextClassifier(
        5, 6, 6, "lstm", 8, **kw), _x(2, 6, 6)),
    "textclassifier_gru": (lambda m, **kw: m.TextClassifier(
        4, 5, 6, "gru", 7, **kw), _x(2, 6, 5)),
}


def _sin64(out, xp):
    return sum(xp.sum(xp.sin(0.5 * o)) for o in leaves(out))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    make, x = MODELS[name]
    jm, tm = make(jmodels), make(models, device="cpu")
    jp, js = jax_params(jm, jit=True)
    load(tm, jp, js)
    jout = run_jax(jm, jp, js, x, False, jit=True)[0]
    close(run_port(tm, x, False)[0], jout, TOL, "float32 output")
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(
        a, np.float64), t)
    x = x.astype(np.float64) if x.dtype == np.float32 else x
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)   # for this test only
    try:
        want = run_jax(jm, to64(jp), to64(js), x, False, _sin64, jit=True)
    finally:
        jax.config.update("jax_enable_x64", prev)
    got = run_port(tm.double(), x, False, _sin64)
    assert got[0].dtype == torch.float64
    for g, w, what in zip(got, want, ("output", "state", "param grads",
                                      "input grads")):
        close(g, w, dict(atol=1e-9, rtol=1e-9), what)


def test_textclassifier_refuses_an_unknown_encoder():
    with pytest.raises(ValueError):
        models.TextClassifier(5, encoder="transformer", device="cpu")


def test_ptb_save_weights_cross_the_packages(tmp_path):
    """A ``save_weights`` file of the port's PTBModel loads into JAX's and
    gives JAX's forward, and JAX's file loads into the port's."""
    jm = jmodels.PTBModel(30, 8)
    jp, js = jax_params(jm, jit=True)
    tm = load(models.PTBModel(30, 8, device="cpu"), jp, js)
    tm.save_weights(str(tmp_path / "port"))
    files = sorted(np.load(tmp_path / "port.npz").files)
    assert files == ["0/weight", "1/cell/0/bias", "1/cell/0/w_h",
                     "1/cell/0/w_i", "1/cell/1/bias", "1/cell/1/w_h",
                     "1/cell/1/w_i", "2/layer/bias", "2/layer/weight"]
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   jax.eval_shape(jm._init_params,
                                                  jax.random.PRNGKey(0)))
    jm.params, jm.state = zeros, js
    jm.load_weights(str(tmp_path / "port.npz"))
    ids = _ids(2, 5, 30)
    tm.evaluate()
    jm.evaluate()
    want = np.asarray(jm.forward(ids))
    got = tm.forward(torch.from_numpy(ids))
    torch.testing.assert_close(got, torch.from_numpy(want.copy()), atol=1e-5,
                               rtol=1e-5)
    jm.save_weights(str(tmp_path / "jax.npz"))
    tm2 = models.PTBModel(30, 8, device="cpu", seed=1)
    tm2.load_weights(str(tmp_path / "jax"))
    for k, v in convert.flatten(tm.params).items():
        assert torch.equal(v, convert.flatten(tm2.params)[k]), k


# -- the text data ------------------------------------------------------------

DOCS = ["The cat sat. A dog ran! Did it?  Yes, it's done.",
        "Hello world... Fine; go on."]


def test_text_pipeline_matches_jax():
    for mod in (jtext, text):
        sents = list(mod.SentenceSplitter()(DOCS))
        padded = list(mod.SentenceBiPadding()(sents))
        toks = list(mod.SentenceTokenizer()(padded))
        d = mod.Dictionary(toks, vocab_size=8)
        labeled = list(mod.TextToLabeledSentence(d)(toks))
        samples = list(mod.LabeledSentenceToSample(6)(labeled))
        free = list(mod.LabeledSentenceToSample()(labeled))
        out = (sents, padded, toks, d.idx2word, d.vocab_size(), len(d),
               d.get_index("cat"), d.get_index("zebra"), d.get_word(2),
               d.get_word(99), [(s.data.tolist(), s.label.tolist())
                                for s in labeled],
               [(s.feature().tolist(), s.label().tolist())
                for s in samples + free],
               list(mod.SentenceBiPadding("<s>", "</s>")(["x y"])))
        if mod is jtext:
            want = out
    assert out == want


def test_ptb_synthetic_and_sentence_helpers_match_jax(tmp_path):
    assert text.ptb_synthetic() == jtext.ptb_synthetic()
    assert text.ptb_synthetic(20, 30, 8, 3) == jtext.ptb_synthetic(20, 30, 8,
                                                                   3)
    path = tmp_path / "doc.txt"
    path.write_text("One. Two!\nThree?\n")
    for fn in ("read_localfile", "sentences_split", "sentences_bipadding",
               "sentence_tokenizer"):
        arg = str(path) if fn == "read_localfile" else DOCS[0]
        assert getattr(sentence, fn)(arg) == getattr(jsentence, fn)(arg)


def test_news20_and_glove_match_jax(tmp_path):
    assert news20.synthetic() == jnews20.synthetic()
    assert news20.synthetic(3, 5, 7, 2) == jnews20.synthetic(3, 5, 7, 2)
    assert news20.get_news20(None, 2) == jnews20.get_news20(None, 2)
    assert news20.CLASS_NUM == jnews20.CLASS_NUM
    for i, cls in enumerate(["alt.atheism", "comp.graphics"]):
        os.makedirs(tmp_path / "20news-18828" / cls)
        (tmp_path / "20news-18828" / cls / "101").write_text(f"doc {i}")
        (tmp_path / "20news-18828" / cls / "notes").write_text("skipped")
    assert news20.get_news20(str(tmp_path)) == \
        jnews20.get_news20(str(tmp_path)) == [("doc 0", 1), ("doc 1", 2)]
    vocab = {"game", "space", "class3tok", "the"}
    got = news20.get_glove_w2v(None, 6, vocab, seed=3)
    want = jnews20.get_glove_w2v(None, 6, vocab, seed=3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert news20.get_glove_w2v(None) == {}
    (tmp_path / "glove.6B.3d.txt").write_text("game 1 2 3\nmoon 4 5 6\n")
    got = news20.get_glove_w2v(str(tmp_path), 3, {"game"})
    np.testing.assert_array_equal(got["game"], [1, 2, 3])
    assert sorted(got) == ["game"]


def test_tokenize_to_glove_sequences_matches_jax():
    texts = jnews20.synthetic(2, 4, 15, 1)
    got = models.tokenize_to_glove_sequences(texts, None, 12, 5, 20)
    want = jmodels.textclassifier.tokenize_to_glove_sequences(
        texts, None, 12, 5, 20)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
