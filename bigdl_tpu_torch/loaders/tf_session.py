"""TF Session training path (counterpart of
``bigdl_tpu/loaders/tf_session.py``).

Parity: reference ``utils/tf/Session.scala`` (``BigDLSessionImpl.train`` /
``predict``) — train or run a *loaded TensorFlow graph* rather than just
doing frozen inference. The reference pulls data from TF queue runners
inside the graph; here the session takes a :class:`DataSet` (queues are a
Spark-executor feeding mechanism; the data pipeline here is the host
prefetcher).

The loaded graph's conv/linear/BN weights are ordinary module parameters,
so a GraphDef trains exactly like a native model through ``Optimizer``, on
the session's ``device`` (the CUDA device by default; ``"cpu"`` for the
CPU).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..utils import engine
from .tensorflow import load_tf_graph


class TFSession:
    """Train/predict a TensorFlow GraphDef with the port's optimizers.

    ``sess = TFSession(graphdef)`` then
    ``model = sess.train(["logits"], dataset, optim_method=SGD(...),
    criterion=ClassNLLCriterion(), end_trigger=max_epoch(5))``.
    """

    def __init__(self, graph, inputs: Optional[List[str]] = None,
                 device=None):
        self._device = engine.resolve_device(device)
        if isinstance(graph, (bytes, bytearray)):
            self._data = bytes(graph)
        else:
            with open(graph, "rb") as f:
                self._data = f.read()
        self._inputs = inputs
        self._model = None
        self._outputs = None

    def _build(self, outputs: Optional[Sequence[str]]):
        outs = list(outputs) if outputs else None
        if self._model is None:
            self._model = load_tf_graph(self._data, inputs=self._inputs,
                                        outputs=outs, device=self._device)
            self._outputs = outs
        elif outs != self._outputs:
            # rebuilding from the original GraphDef would silently discard
            # any training done on the cached model — refuse instead
            raise ValueError(
                f"session already built for outputs {self._outputs}; "
                f"requested {outs}. Use one TFSession per output set")
        return self._model

    def train(self, outputs: Sequence[str], dataset, optim_method,
              criterion, end_trigger, batch_size: int = 32):
        """Session.train parity: build the graph up to ``outputs``, then
        optimize ``criterion(graph(x), y)`` over ``dataset``."""
        from ..optim import Optimizer
        model = self._build(outputs)
        model.training()
        opt = Optimizer(model=model, training_set=dataset,
                        criterion=criterion, optim_method=optim_method,
                        end_trigger=end_trigger, batch_size=batch_size,
                        device=self._device)
        opt.optimize()
        model.evaluate()
        return model

    def predict(self, outputs: Sequence[str], data, batch_size: int = 32):
        """Session.predict parity: batched forward to ``outputs`` (the
        shared Predictor, Table-input aware)."""
        model = self._build(outputs)
        model.evaluate()
        return model.predict(data, batch_size)


__all__ = ["TFSession"]
