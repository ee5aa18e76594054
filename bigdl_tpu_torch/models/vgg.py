"""VGG (counterpart of ``bigdl_tpu/models/vgg.py``): ``VggForCifar10`` and
the ImageNet ``Vgg_16`` / ``Vgg_19``."""
from __future__ import annotations

from ..nn import (BatchNormalization, Dropout, Linear, LogSoftMax, ReLU,
                  Sequential, SpatialBatchNormalization, SpatialConvolution,
                  SpatialMaxPooling, View)
from ._build import placed

__all__ = ["VggForCifar10", "Vgg_16", "Vgg_19"]


def _conv_bn_relu(model, nin, nout, bn=True):
    model.add(SpatialConvolution(nin, nout, 3, 3, 1, 1, 1, 1))
    if bn:
        model.add(SpatialBatchNormalization(nout, 1e-3))
    model.add(ReLU(True))
    return nout


def VggForCifar10(class_num: int = 10, has_dropout: bool = True,
                  device=None, seed: int = 0):
    """VGG-16's convolutions with BatchNorm for 32x32 inputs, ceil-mode
    pools, and a 512-512 classifier (models/vgg/VggForCifar10.scala)."""
    model = Sequential()
    nin = 3
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"):
        if v == "M":
            model.add(SpatialMaxPooling(2, 2, 2, 2).ceil())
        else:
            nin = _conv_bn_relu(model, nin, v)
    model.add(View(512))
    classifier = Sequential()
    if has_dropout:
        classifier.add(Dropout(0.5))
    classifier.add(Linear(512, 512))
    classifier.add(BatchNormalization(512))
    classifier.add(ReLU(True))
    if has_dropout:
        classifier.add(Dropout(0.5))
    classifier.add(Linear(512, class_num))
    classifier.add(LogSoftMax())
    model.add(classifier)
    return placed(model, device, seed)


def _vgg_imagenet(cfg, class_num, has_dropout, device, seed):
    model = Sequential()
    nin = 3
    for v in cfg:
        if v == "M":
            model.add(SpatialMaxPooling(2, 2, 2, 2))
        else:
            nin = _conv_bn_relu(model, nin, v, bn=False)
    model.add(View(512 * 7 * 7))
    model.add(Linear(512 * 7 * 7, 4096))
    model.add(ReLU(True))
    if has_dropout:
        model.add(Dropout(0.5))
    model.add(Linear(4096, 4096))
    model.add(ReLU(True))
    if has_dropout:
        model.add(Dropout(0.5))
    model.add(Linear(4096, class_num))
    model.add(LogSoftMax())
    return placed(model, device, seed)


def Vgg_16(class_num: int = 1000, has_dropout: bool = True, device=None,
           seed: int = 0):
    """VGG-16 for 224x224 inputs (models/vgg/Vgg_16.scala)."""
    return _vgg_imagenet([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                          512, 512, 512, "M", 512, 512, 512, "M"],
                         class_num, has_dropout, device, seed)


def Vgg_19(class_num: int = 1000, has_dropout: bool = True, device=None,
           seed: int = 0):
    """VGG-19 for 224x224 inputs (models/vgg/Vgg_19.scala)."""
    return _vgg_imagenet([64, 64, "M", 128, 128, "M", 256, 256, 256, 256,
                          "M", 512, 512, 512, 512, "M", 512, 512, 512, 512,
                          "M"], class_num, has_dropout, device, seed)
