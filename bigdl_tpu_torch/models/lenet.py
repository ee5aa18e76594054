"""LeNet-5 (counterpart of ``bigdl_tpu/models/lenet.py``)."""
from __future__ import annotations

from ..nn import (Linear, LogSoftMax, Reshape, Sequential, SpatialConvolution,
                  SpatialMaxPooling, Tanh)
from ._build import placed

__all__ = ["LeNet5"]


def LeNet5(class_num: int = 10, device=None, seed: int = 0):
    """conv(1 -> 6, 5x5) tanh pool conv(6 -> 12, 5x5) tanh pool fc(192 ->
    100) tanh fc(100 -> class_num) log-softmax over 28x28 inputs
    (models/lenet/LeNet5.scala), built on ``device`` with weights drawn
    from ``seed``."""
    model = Sequential()
    model.add(Reshape([1, 28, 28]))
    model.add(SpatialConvolution(1, 6, 5, 5).set_name("conv1_5x5"))
    model.add(Tanh())
    model.add(SpatialMaxPooling(2, 2, 2, 2))
    model.add(SpatialConvolution(6, 12, 5, 5).set_name("conv2_5x5"))
    model.add(Tanh())
    model.add(SpatialMaxPooling(2, 2, 2, 2))
    model.add(Reshape([12 * 4 * 4]))
    model.add(Linear(12 * 4 * 4, 100).set_name("fc_1"))
    model.add(Tanh())
    model.add(Linear(100, class_num).set_name("fc_2"))
    model.add(LogSoftMax())
    return placed(model, device, seed)
