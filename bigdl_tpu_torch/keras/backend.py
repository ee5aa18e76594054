"""Run a LIVE keras model on the port's engine (counterpart of
``bigdl_tpu/keras/backend.py``).

Parity: reference ``pyspark/bigdl/keras/backend.py`` — its headline keras
UX is ``with_bigdl_backend(kmodel)``: hand over a *compiled keras model
object* (not a JSON file) and get back fit / evaluate / predict running on
the BigDL engine. This is the same entry point over the port's stack:

    kmodel = tf.keras.Sequential([...]); kmodel.compile("sgd", "mse")
    bmodel = with_bigdl_backend(kmodel, device="cuda")
    bmodel.fit(x, y, batch_size=32, nb_epoch=2)
    preds = bmodel.predict(x)

Conversion rides the existing pieces: the model definition goes through
``converter.model_from_json`` (the analog of the reference's
``DefinitionLoader.from_kmodel``), the layer weights through
``converter.load_weights`` (``WeightLoader.load_weights_from_kmodel``),
and the compiled optimizer/loss/metrics through the reference's
``OptimConverter`` mapping (here ``_compile_from_training_config``). The
converted model lives on ``device`` (the CUDA device by default;
``"cpu"`` for the CPU). Nothing here imports ``tensorflow``: the keras
model arrives as an object, and is read through its own methods.
"""
from __future__ import annotations

import warnings

import numpy as np

from .converter import (model_from_json, load_weights,
                        _compile_from_training_config)

__all__ = ["KerasModelWrapper", "with_bigdl_backend"]

# tf.keras Loss-class spellings → our compile() loss strings
_LOSS_CLASS_NAMES = {
    "MeanSquaredError": "mse",
    "MeanAbsoluteError": "mae",
    "BinaryCrossentropy": "binary_crossentropy",
    "CategoricalCrossentropy": "categorical_crossentropy",
    "SparseCategoricalCrossentropy": "sparse_categorical_crossentropy",
    "Hinge": "hinge",
    "KLDivergence": "kullback_leibler_divergence",
    "Poisson": "poisson",
    "CosineSimilarity": "cosine_proximity",
    "MeanAbsolutePercentageError": "mean_absolute_percentage_error",
    "MeanSquaredLogarithmicError": "mean_squared_logarithmic_error",
}


def _loss_name(kloss):
    """keras loss (string / function / Loss object) → our loss string."""
    if kloss is None:
        return None
    if isinstance(kloss, str):
        return kloss
    name = type(kloss).__name__
    if name in _LOSS_CLASS_NAMES:
        return _LOSS_CLASS_NAMES[name]
    # loss functions keep their snake_case __name__ in every keras version
    return getattr(kloss, "__name__", None)


def _training_config(kmodel):
    """Compiled keras model → the training_config dict shape
    ``_compile_from_training_config`` understands (OptimConverter parity:
    optimizer hyperparams read off the live object)."""
    opt = getattr(kmodel, "optimizer", None)
    if opt is None:
        return None
    try:
        oc = dict(opt.get_config())
    except Exception:
        oc = {}
    # tf.keras 2/3 spell it learning_rate; the 1.2-style mapper reads lr
    if "lr" not in oc and "learning_rate" in oc:
        lr = oc["learning_rate"]
        # schedules serialize as dicts — take their base rate if present
        if isinstance(lr, dict):
            lr = lr.get("config", {}).get("initial_learning_rate", 0.01)
        oc["lr"] = float(lr)
    cls = oc.get("name") or type(opt).__name__
    loss = _loss_name(getattr(kmodel, "loss", None))
    # keras 3 wraps user metrics in a CompileMetrics container
    # (model._compile_metrics._user_metrics); keras 2's container is
    # model.compiled_metrics (same _user_metrics attr); model.metrics
    # last (it is empty pre-train on keras 2, but costs nothing to try)
    kmetrics = None
    for holder in (getattr(kmodel, "_compile_metrics", None),
                   getattr(kmodel, "compiled_metrics", None)):
        kmetrics = getattr(holder, "_user_metrics", None)
        if kmetrics is not None:
            break
    if kmetrics is None:
        kmetrics = getattr(kmodel, "metrics", None) or []
    metrics = []
    for m in kmetrics:
        nm = m if isinstance(m, str) else getattr(m, "name", "")
        if nm in ("accuracy", "acc"):
            metrics.append("accuracy")
        elif nm and nm not in ("loss", "compile_metrics"):
            warnings.warn(f"with_bigdl_backend: metric {nm!r} unsupported "
                          "— dropped (reference OptimConverter rejects "
                          "it too)")
    return {"optimizer": {"class_name": cls, "config": oc},
            "loss": loss, "metrics": metrics}


class KerasModelWrapper:
    """A live keras model re-hosted on the port's engine.

    ``self.model`` is the converted native keras-API model (Sequential /
    Model from ``bigdl_tpu_torch.keras``, on ``device``); fit / evaluate /
    predict delegate to it with keras semantics. Reference:
    ``pyspark/bigdl/keras/backend.py:21`` (KerasModelWrapper).
    """

    def __init__(self, kmodel, device=None):
        self.model = model_from_json(kmodel.to_json(), device=device)
        weights = {}
        for layer in kmodel.layers:
            ws = layer.get_weights()
            if ws:
                weights[layer.name] = [np.asarray(w) for w in ws]
        if weights:
            load_weights(self.model, weights)
        tc = _training_config(kmodel)
        if tc is not None:
            if tc["loss"] is None:
                warnings.warn("with_bigdl_backend: compiled model has no "
                              "mappable loss; call .compile() on the "
                              "wrapper's .model before fit")
            else:
                _compile_from_training_config(self.model, tc)

    def fit(self, x, y=None, batch_size=32, nb_epoch=10,
            validation_data=None, distributed=False):
        """Train on the port's engine (LocalOptimizer; keras
        fit semantics — see reference backend.py:85)."""
        self.model.fit(x, y, batch_size=batch_size, nb_epoch=nb_epoch,
                       validation_data=validation_data,
                       distributed=distributed)
        return self

    def evaluate(self, x, y, batch_size=32):
        """[loss, *metric values] like keras (reference backend.py:33)."""
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size=32):
        return self.model.predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size=32, zero_based_label=True):
        return self.model.predict_classes(x, batch_size=batch_size,
                                          zero_based_label=zero_based_label)


def with_bigdl_backend(kmodel, device=None):
    """Reference ``backend.py:178`` — wrap a compiled keras model so
    fit/evaluate/predict run on the port's engine, on ``device``."""
    return KerasModelWrapper(kmodel, device=device)
