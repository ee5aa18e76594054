"""Autoencoder (counterpart of ``bigdl_tpu/models/autoencoder.py``)."""
from __future__ import annotations

from ..nn import Linear, ReLU, Reshape, Sequential, Sigmoid
from ._build import placed

__all__ = ["Autoencoder"]


def Autoencoder(class_num: int = 32, device=None, seed: int = 0):
    """784 -> class_num -> 784 with a sigmoid output
    (models/autoencoder/Autoencoder.scala)."""
    model = Sequential()
    model.add(Reshape([28 * 28]))
    model.add(Linear(28 * 28, class_num))
    model.add(ReLU(True))
    model.add(Linear(class_num, 28 * 28))
    model.add(Sigmoid())
    return placed(model, device, seed)
