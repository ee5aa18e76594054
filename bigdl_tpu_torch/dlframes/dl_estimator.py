"""ML-pipeline style estimators (counterpart of
``bigdl_tpu/dlframes/dl_estimator.py``).

Parity: reference ``dlframes/DLEstimator.scala`` / ``DLClassifier.scala``
(Spark ML Pipeline stages). Without Spark, the pipeline substrate is a
pandas DataFrame or a dict of columns / arrays: ``fit`` consumes one with
a features column and a label column and returns a ``DLModel`` whose
``transform`` appends a prediction column - the same stage contract.
pandas is never imported here: a DataFrame is told apart by its
``columns``. Each stage takes a trailing ``device`` (the CUDA device by
default, which raises without one; ``"cpu"`` for the CPU), where its
model must already live: training and prediction run there.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..dataset.dataset import DataSet
from ..dataset.sample import Sample
from ..optim.optimizer import LocalOptimizer
from ..optim.optim_method import Adam
from ..optim.trigger import max_epoch
from ..utils import engine

__all__ = ["DLEstimator", "DLModel", "DLClassifier", "DLClassifierModel"]


def _get_col(data, col):
    if hasattr(data, "columns"):  # pandas
        return np.stack([np.asarray(v, np.float32).reshape(-1)
                         for v in data[col].to_list()])
    return np.asarray(data[col], np.float32)


def _check_device(model, device):
    """Refuse a model that does not live on ``device`` (``LocalOptimizer``
    refuses it for ``fit``; prediction would move the data to it)."""
    where = {t.device for t in model.parameters()} | \
        {t.device for t in model.buffers()}
    if where and where != {device}:
        raise ValueError(f"the model lives on {sorted(map(str, where))}, "
                         f"the stage on {device}: build the model with "
                         f"device='{device}'")


class DLEstimator:
    """dlframes/DLEstimator.scala - generic supervised estimator."""

    def __init__(self, model, criterion, feature_size: Sequence[int],
                 label_size: Sequence[int], features_col="features",
                 label_col="label", prediction_col="prediction",
                 device=None):
        self.device = engine.resolve_device(device)
        self.model = model
        self.criterion = criterion
        self.feature_size = tuple(feature_size)
        self.label_size = tuple(label_size)
        self.features_col, self.label_col = features_col, label_col
        self.prediction_col = prediction_col
        self.batch_size = 32
        self.max_epoch_n = 10
        self.optim_method = None
        self.learning_rate = 1e-3

    def set_batch_size(self, b):
        self.batch_size = b
        return self

    def set_max_epoch(self, e):
        self.max_epoch_n = e
        return self

    def set_optim_method(self, m):
        self.optim_method = m
        return self

    def set_learning_rate(self, lr):
        self.learning_rate = lr
        return self

    def _label_transform(self, y):
        return y.reshape((-1,) + self.label_size)

    def fit(self, df) -> "DLModel":
        x = _get_col(df, self.features_col).reshape(
            (-1,) + self.feature_size)
        y = self._label_transform(_get_col(df, self.label_col))
        samples = [Sample(x[i], y[i]) for i in range(len(x))]
        opt = LocalOptimizer(
            self.model, DataSet.array(samples), self.criterion,
            self.optim_method or Adam(learningrate=self.learning_rate),
            max_epoch(self.max_epoch_n), self.batch_size,
            device=self.device)
        trained = opt.optimize()
        return self._make_model(trained)

    def _make_model(self, trained):
        return DLModel(trained, self.feature_size, self.features_col,
                       self.prediction_col, device=self.device)


class DLModel:
    """dlframes/DLEstimator.scala DLModel - transform appends predictions."""

    def __init__(self, model, feature_size, features_col="features",
                 prediction_col="prediction", device=None):
        self.device = engine.resolve_device(device)
        self.model = model
        self.feature_size = tuple(feature_size)
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.batch_size = 32

    def set_batch_size(self, b):
        self.batch_size = b
        return self

    def _predict(self, x):
        from ..optim.predictor import Predictor
        _check_device(self.model, self.device)
        return Predictor(self.model).predict(
            x.reshape((-1,) + self.feature_size), self.batch_size)

    def transform(self, df):
        x = _get_col(df, self.features_col)
        pred = self._predict(x)
        if hasattr(df, "columns"):
            out = df.copy()
            out[self.prediction_col] = list(pred)
            return out
        out = dict(df)
        out[self.prediction_col] = pred
        return out


class DLClassifier(DLEstimator):
    """dlframes/DLClassifier.scala - scalar 1-based class labels."""

    def __init__(self, model, criterion, feature_size,
                 features_col="features", label_col="label",
                 prediction_col="prediction", device=None):
        super().__init__(model, criterion, feature_size, (),
                         features_col, label_col, prediction_col,
                         device=device)

    def _label_transform(self, y):
        return y.reshape(-1)

    def _make_model(self, trained):
        return DLClassifierModel(trained, self.feature_size,
                                 self.features_col, self.prediction_col,
                                 device=self.device)


class DLClassifierModel(DLModel):
    def transform(self, df):
        x = _get_col(df, self.features_col)
        pred = self._predict(x).argmax(-1) + 1.0  # 1-based, like reference
        if hasattr(df, "columns"):
            out = df.copy()
            out[self.prediction_col] = pred
            return out
        out = dict(df)
        out[self.prediction_col] = pred
        return out
