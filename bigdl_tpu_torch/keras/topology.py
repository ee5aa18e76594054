"""Keras-style API core (counterpart of ``bigdl_tpu/keras/topology.py``).

Parity: reference ``nn/keras/Topology.scala`` (Sequential/Model),
``nn/keras/KerasLayer.scala`` (shape inference + build), and the python
frontend ``pyspark/bigdl/nn/keras``. Keras-1.2.2 semantics, channels-first
image layout (the reference's default dim ordering).

Each KerasLayer knows ``compute_output_shape`` and ``build(input_shape) ->
bigdl_tpu_torch.nn.Module``; Sequential/Model propagate shapes at
graph-construction time (host-side), so the built model is an ordinary nn
module. ``Sequential`` and ``Model`` take a trailing ``device`` (the CUDA
device by default, which raises without one; ``"cpu"`` for the CPU): each
built module goes there as it is added, and ``fit`` / ``evaluate`` /
``predict`` train and run there.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import nn as N
from ..dataset.dataset import DataSet
from ..dataset.sample import Sample
from ..optim import (LocalOptimizer, SGD, Adam, RMSprop, Adagrad, Adadelta,
                     Adamax, max_epoch, Top1Accuracy, Loss as LossMetric)
from ..utils import engine

__all__ = ["KerasLayer", "KerasNode", "Input", "InputLayer", "Sequential",
           "Model"]


class KerasLayer:
    """Base: subclasses implement build() and compute_output_shape()."""

    def __init__(self, input_shape: Optional[Sequence[int]] = None, name=None):
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name
        self.built_module: Optional[N.Module] = None

    def compute_output_shape(self, input_shape: Tuple[int, ...]):
        return tuple(input_shape)

    def build(self, input_shape: Tuple[int, ...]) -> N.Module:
        raise NotImplementedError

    def _built(self, input_shape):
        m = self.build(tuple(input_shape))
        if self.name:
            m.set_name(self.name)
        self.built_module = m
        return m

    def __call__(self, node: "KerasNode") -> "KerasNode":
        m = self._built(node.shape)
        out_shape = self.compute_output_shape(node.shape)
        return KerasNode(m(node.nn_node), out_shape)


class KerasNode:
    """A graph node + its (batch-free) shape."""

    def __init__(self, nn_node, shape):
        self.nn_node = nn_node
        self.shape = tuple(shape)


def Input(shape: Sequence[int], name=None) -> KerasNode:
    """nn/keras/Input.scala - placeholder carrying shape (no batch dim)."""
    return KerasNode(N.Input(name=name), tuple(shape))


def InputLayer(input_shape: Sequence[int], name=None) -> KerasNode:
    """pyspark nn/keras/layer.py InputLayer - keyword-arg spelling of
    ``Input`` used by Sequential models and the JSON converter."""
    return Input(input_shape, name=name)


_OPTIMIZERS = {
    "sgd": lambda: SGD(learningrate=0.01),
    "adam": lambda: Adam(),
    "rmsprop": lambda: RMSprop(),
    "adagrad": lambda: Adagrad(),
    "adadelta": lambda: Adadelta(),
    "adamax": lambda: Adamax(),
}

_LOSSES = {
    "mse": N.MSECriterion, "mean_squared_error": N.MSECriterion,
    "mae": N.AbsCriterion, "mean_absolute_error": N.AbsCriterion,
    "binary_crossentropy": N.BCECriterion,
    "categorical_crossentropy": N.CategoricalCrossEntropy,
    "sparse_categorical_crossentropy": N.CrossEntropyCriterion,
    "hinge": N.MarginCriterion,
    "kullback_leibler_divergence": N.KullbackLeiblerDivergenceCriterion,
    "poisson": N.PoissonCriterion,
    "cosine_proximity": N.CosineProximityCriterion,
    "mean_absolute_percentage_error": N.MeanAbsolutePercentageCriterion,
    "mean_squared_logarithmic_error": N.MeanSquaredLogarithmicCriterion,
}


class _Trainable:
    """compile/fit/evaluate/predict shared by Sequential and Model
    (parity: nn/keras/Topology.scala KerasModel), on ``self.device``."""

    def _module(self) -> N.Module:
        raise NotImplementedError

    def compile(self, optimizer, loss, metrics=None):
        if isinstance(optimizer, str):
            optimizer = _OPTIMIZERS[optimizer.lower()]()
        self.optim_method = optimizer
        if isinstance(loss, str):
            loss = _LOSSES[loss.lower()]()
        self.loss = loss
        self.metrics = metrics or []
        self._sparse_targets = isinstance(
            loss, (N.CrossEntropyCriterion, N.ClassNLLCriterion))
        return self

    def _to_samples(self, x, y=None):
        x = np.asarray(x, np.float32)
        if y is None:
            return [Sample(x[i]) for i in range(len(x))]
        y = np.asarray(y)
        if self._sparse_targets:
            if y.ndim == 2 and y.shape[1] > 1:  # one-hot -> 1-based indices
                y = y.argmax(-1) + 1
            elif y.min() == 0:  # 0-based indices -> 1-based
                y = y + 1
        return [Sample(x[i], y[i].astype(np.float32)) for i in range(len(x))]

    def fit(self, x, y=None, batch_size=32, nb_epoch=10,
            validation_data=None, distributed=False):
        model = self._module()
        ds = DataSet.array(self._to_samples(x, y))
        opt = LocalOptimizer(model, ds, self.loss, self.optim_method,
                             max_epoch(nb_epoch), batch_size,
                             device=self.device)
        if validation_data is not None:
            from ..optim import every_epoch
            vx, vy = validation_data
            vds = DataSet.array(self._to_samples(vx, vy))
            methods = [Top1Accuracy() if m in ("accuracy", "acc") else m
                       for m in self.metrics] or [LossMetric(self.loss)]
            opt.set_validation(every_epoch(), vds, methods, batch_size)
        opt.optimize()
        self.history = opt
        return self

    def predict(self, x, batch_size=32):
        from ..optim import Predictor
        ds = DataSet.array(self._to_samples(x))
        return Predictor(self._module()).predict(ds, batch_size)

    def predict_classes(self, x, batch_size=32, zero_based_label=True):
        pred = self.predict(x, batch_size)
        cls = pred.argmax(-1)
        return cls if zero_based_label else cls + 1

    def evaluate(self, x, y, batch_size=32):
        """Keras semantics: returns [loss, *metric values] (scalar loss if
        no metrics were compiled)."""
        model = self._module()
        ds = DataSet.array(self._to_samples(x, y))
        methods = [LossMetric(self.loss)] + \
            [Top1Accuracy() if m in ("accuracy", "acc") else m
             for m in self.metrics]
        from ..optim import Evaluator
        vals = [r.result()[0] for r in
                Evaluator(model).evaluate(ds, methods, batch_size)]
        return vals if len(vals) > 1 else vals[0]

    def summary(self):
        m = self._module()
        lines = [f"Model: {type(self).__name__}"]
        for mod in m.modules_iter():
            lines.append(f"  {mod.name} ({type(mod).__name__})")
        s = "\n".join(lines)
        print(s)
        return s


class Sequential(_Trainable):
    """nn/keras/Topology.scala Sequential."""

    def __init__(self, device=None):
        self.device = engine.resolve_device(device)
        self.layers: List[KerasLayer] = []
        self.shapes: List[Tuple[int, ...]] = []
        self._model = N.Sequential().to(self.device)

    def add(self, layer: KerasLayer):
        if not self.layers:
            if layer.input_shape is None:
                raise ValueError("first layer needs input_shape")
            in_shape = layer.input_shape
        else:
            in_shape = self.shapes[-1]
        self._model.add(layer._built(in_shape).to(self.device))
        self.layers.append(layer)
        self.shapes.append(layer.compute_output_shape(in_shape))
        return self

    @property
    def output_shape(self):
        return self.shapes[-1] if self.shapes else None

    def _module(self):
        return self._model

    def get_output_shape(self):
        return self.output_shape


class Model(_Trainable):
    """nn/keras/Topology.scala Model (functional graph)."""

    def __init__(self, input, output, device=None):
        self.device = engine.resolve_device(device)
        ins = input if isinstance(input, (list, tuple)) else [input]
        outs = output if isinstance(output, (list, tuple)) else [output]
        self._model = N.Graph([i.nn_node for i in ins],
                              [o.nn_node for o in outs]).to(self.device)
        self.output_shape = outs[0].shape

    def _module(self):
        return self._model
