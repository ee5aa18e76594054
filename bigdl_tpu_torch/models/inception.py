"""Inception v1 (GoogLeNet) and v2 (BN-Inception) (counterpart of
``bigdl_tpu/models/inception.py``): Sequential / Concat trees of the port's
layers, as the reference's helpers build them; the ceil-mode pools take
the JAX package's windows (``nn.pool``)."""
from __future__ import annotations

from ..nn import (Sequential, SpatialConvolution, ReLU, SpatialMaxPooling,
                  SpatialAveragePooling, SpatialCrossMapLRN, Linear, View,
                  Dropout, LogSoftMax, Concat, SpatialBatchNormalization)
from ..nn.init import Xavier
from ._build import placed

__all__ = ["inception_block", "Inception_v1_NoAuxClassifier", "Inception_v1",
           "inception_layer_v2", "Inception_v2_NoAuxClassifier",
           "Inception_v2"]


def _conv(nin, nout, kw, kh, sw=1, sh=1, pw=0, ph=0, name=""):
    c = SpatialConvolution(nin, nout, kw, kh, sw, sh, pw, ph,
                           init_method=Xavier())
    if name:
        c.set_name(name)
    return c


def inception_block(input_size, config, name_prefix=""):
    """config: ((1x1), (3x3reduce, 3x3), (5x5reduce, 5x5), (poolproj))
    (models/inception/Inception_v1.scala inception())."""
    concat = Concat(2)
    c1 = Sequential()
    c1.add(_conv(input_size, config[0][0], 1, 1, name=name_prefix + "1x1"))
    c1.add(ReLU(True))
    concat.add(c1)
    c3 = Sequential()
    c3.add(_conv(input_size, config[1][0], 1, 1,
                 name=name_prefix + "3x3_reduce"))
    c3.add(ReLU(True))
    c3.add(_conv(config[1][0], config[1][1], 3, 3, 1, 1, 1, 1,
                 name=name_prefix + "3x3"))
    c3.add(ReLU(True))
    concat.add(c3)
    c5 = Sequential()
    c5.add(_conv(input_size, config[2][0], 1, 1,
                 name=name_prefix + "5x5_reduce"))
    c5.add(ReLU(True))
    c5.add(_conv(config[2][0], config[2][1], 5, 5, 1, 1, 2, 2,
                 name=name_prefix + "5x5"))
    c5.add(ReLU(True))
    concat.add(c5)
    pool = Sequential()
    pool.add(SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
    pool.add(_conv(input_size, config[3][0], 1, 1,
                   name=name_prefix + "pool_proj"))
    pool.add(ReLU(True))
    concat.add(pool)
    return concat


def Inception_v1_NoAuxClassifier(class_num: int = 1000,
                                 has_dropout: bool = True, device=None,
                                 seed: int = 0):
    """models/inception/Inception_v1.scala:36 (no aux heads variant)."""
    model = Sequential()
    model.add(_conv(3, 64, 7, 7, 2, 2, 3, 3, "conv1/7x7_s2"))
    model.add(ReLU(True))
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    model.add(SpatialCrossMapLRN(5, 0.0001, 0.75))
    model.add(_conv(64, 64, 1, 1, name="conv2/3x3_reduce"))
    model.add(ReLU(True))
    model.add(_conv(64, 192, 3, 3, 1, 1, 1, 1, "conv2/3x3"))
    model.add(ReLU(True))
    model.add(SpatialCrossMapLRN(5, 0.0001, 0.75))
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    model.add(inception_block(192, ((64,), (96, 128), (16, 32), (32,)),
                              "inception_3a/"))
    model.add(inception_block(256, ((128,), (128, 192), (32, 96), (64,)),
                              "inception_3b/"))
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    model.add(inception_block(480, ((192,), (96, 208), (16, 48), (64,)),
                              "inception_4a/"))
    model.add(inception_block(512, ((160,), (112, 224), (24, 64), (64,)),
                              "inception_4b/"))
    model.add(inception_block(512, ((128,), (128, 256), (24, 64), (64,)),
                              "inception_4c/"))
    model.add(inception_block(512, ((112,), (144, 288), (32, 64), (64,)),
                              "inception_4d/"))
    model.add(inception_block(528, ((256,), (160, 320), (32, 128), (128,)),
                              "inception_4e/"))
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    model.add(inception_block(832, ((256,), (160, 320), (32, 128), (128,)),
                              "inception_5a/"))
    model.add(inception_block(832, ((384,), (192, 384), (48, 128), (128,)),
                              "inception_5b/"))
    model.add(SpatialAveragePooling(7, 7, 1, 1, global_pooling=True))
    if has_dropout:
        model.add(Dropout(0.4))
    model.add(View(1024))
    model.add(Linear(1024, class_num).set_name("loss3/classifier"))
    model.add(LogSoftMax())
    return placed(model, device, seed)


Inception_v1 = Inception_v1_NoAuxClassifier


def _conv_bn(seq, nin, nout, kw, kh, sw=1, sh=1, pw=0, ph=0, name=""):
    seq.add(_conv(nin, nout, kw, kh, sw, sh, pw, ph, name=name))
    seq.add(SpatialBatchNormalization(nout, 1e-3).set_name(name + "/bn"))
    seq.add(ReLU(True))
    return seq


def inception_layer_v2(input_size, config, name_prefix=""):
    """BN-Inception block (models/inception/Inception_v2.scala:28
    Inception_Layer_v2): optional 1x1 branch, 3x3 (strided when the pool
    branch is a projection-free max pool), double-3x3, and max/avg pool
    branch with optional 1x1 projection. Every conv is followed by BN+ReLU.

    config: ((n1x1,), (n3x3r, n3x3), (d3x3r, d3x3), (pool_kind, n_proj))
    """
    concat = Concat(2)
    stride = 2 if (config[3][0] == "max" and config[3][1] == 0) else 1
    if config[0][0] != 0:
        c1 = Sequential()
        _conv_bn(c1, input_size, config[0][0], 1, 1, name=name_prefix + "1x1")
        concat.add(c1)
    c3 = Sequential()
    _conv_bn(c3, input_size, config[1][0], 1, 1,
             name=name_prefix + "3x3_reduce")
    _conv_bn(c3, config[1][0], config[1][1], 3, 3, stride, stride, 1, 1,
             name=name_prefix + "3x3")
    concat.add(c3)
    c33 = Sequential()
    _conv_bn(c33, input_size, config[2][0], 1, 1,
             name=name_prefix + "double3x3_reduce")
    _conv_bn(c33, config[2][0], config[2][1], 3, 3, 1, 1, 1, 1,
             name=name_prefix + "double3x3a")
    _conv_bn(c33, config[2][1], config[2][1], 3, 3, stride, stride, 1, 1,
             name=name_prefix + "double3x3b")
    concat.add(c33)
    pool = Sequential()
    if config[3][0] == "max":
        if config[3][1] != 0:
            pool.add(SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
        else:
            pool.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    else:
        pool.add(SpatialAveragePooling(3, 3, 1, 1, 1, 1).ceil())
    if config[3][1] != 0:
        _conv_bn(pool, input_size, config[3][1], 1, 1,
                 name=name_prefix + "pool_proj")
    concat.add(pool)
    return concat.set_name(name_prefix + "output")


def Inception_v2_NoAuxClassifier(class_num: int = 1000, device=None,
                                 seed: int = 0):
    """BN-Inception trunk with the single (main) classifier head
    (models/inception/Inception_v2.scala:186 without the two aux heads)."""
    model = Sequential()
    _conv_bn(model, 3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2")
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    _conv_bn(model, 64, 64, 1, 1, name="conv2/3x3_reduce")
    _conv_bn(model, 64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3")
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    model.add(inception_layer_v2(
        192, ((64,), (64, 64), (64, 96), ("avg", 32)), "inception_3a/"))
    model.add(inception_layer_v2(
        256, ((64,), (64, 96), (64, 96), ("avg", 64)), "inception_3b/"))
    model.add(inception_layer_v2(
        320, ((0,), (128, 160), (64, 96), ("max", 0)), "inception_3c/"))
    model.add(inception_layer_v2(
        576, ((224,), (64, 96), (96, 128), ("avg", 128)), "inception_4a/"))
    model.add(inception_layer_v2(
        576, ((192,), (96, 128), (96, 128), ("avg", 128)), "inception_4b/"))
    model.add(inception_layer_v2(
        576, ((160,), (128, 160), (128, 160), ("avg", 96)), "inception_4c/"))
    model.add(inception_layer_v2(
        576, ((96,), (128, 192), (160, 192), ("avg", 96)), "inception_4d/"))
    model.add(inception_layer_v2(
        576, ((0,), (128, 192), (192, 256), ("max", 0)), "inception_4e/"))
    model.add(inception_layer_v2(
        1024, ((352,), (192, 320), (160, 224), ("avg", 128)), "inception_5a/"))
    model.add(inception_layer_v2(
        1024, ((352,), (192, 320), (192, 224), ("max", 128)), "inception_5b/"))
    model.add(SpatialAveragePooling(7, 7, 1, 1, global_pooling=True))
    model.add(View(1024))
    model.add(Linear(1024, class_num).set_name("loss3/classifier"))
    model.add(LogSoftMax())
    return placed(model, device, seed)


def Inception_v2(class_num: int = 1000, device=None, seed: int = 0):
    """Full 3-head BN-Inception (models/inception/Inception_v2.scala:186):
    the main head plus two auxiliary classifier heads; outputs the three
    log-softmax vectors concatenated along the class dim (reference Concat(2)
    over output3|output2|output1), i.e. shape (N, 3*class_num)."""
    features1 = Sequential()
    _conv_bn(features1, 3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2")
    features1.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    _conv_bn(features1, 64, 64, 1, 1, name="conv2/3x3_reduce")
    _conv_bn(features1, 64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3")
    features1.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    features1.add(inception_layer_v2(
        192, ((64,), (64, 64), (64, 96), ("avg", 32)), "inception_3a/"))
    features1.add(inception_layer_v2(
        256, ((64,), (64, 96), (64, 96), ("avg", 64)), "inception_3b/"))
    features1.add(inception_layer_v2(
        320, ((0,), (128, 160), (64, 96), ("max", 0)), "inception_3c/"))

    output1 = Sequential()
    output1.add(SpatialAveragePooling(5, 5, 3, 3).ceil())
    _conv_bn(output1, 576, 128, 1, 1, name="loss1/conv")
    output1.add(View(128 * 4 * 4))
    output1.add(Linear(128 * 4 * 4, 1024).set_name("loss1/fc"))
    output1.add(ReLU(True))
    output1.add(Linear(1024, class_num).set_name("loss1/classifier"))
    output1.add(LogSoftMax())

    features2 = Sequential()
    features2.add(inception_layer_v2(
        576, ((224,), (64, 96), (96, 128), ("avg", 128)), "inception_4a/"))
    features2.add(inception_layer_v2(
        576, ((192,), (96, 128), (96, 128), ("avg", 128)), "inception_4b/"))
    features2.add(inception_layer_v2(
        576, ((160,), (128, 160), (128, 160), ("avg", 96)), "inception_4c/"))
    features2.add(inception_layer_v2(
        576, ((96,), (128, 192), (160, 192), ("avg", 96)), "inception_4d/"))
    features2.add(inception_layer_v2(
        576, ((0,), (128, 192), (192, 256), ("max", 0)), "inception_4e/"))

    output2 = Sequential()
    output2.add(SpatialAveragePooling(5, 5, 3, 3).ceil())
    _conv_bn(output2, 1024, 128, 1, 1, name="loss2/conv")
    output2.add(View(128 * 2 * 2))
    output2.add(Linear(128 * 2 * 2, 1024).set_name("loss2/fc"))
    output2.add(ReLU(True))
    output2.add(Linear(1024, class_num).set_name("loss2/classifier"))
    output2.add(LogSoftMax())

    output3 = Sequential()
    output3.add(inception_layer_v2(
        1024, ((352,), (192, 320), (160, 224), ("avg", 128)), "inception_5a/"))
    output3.add(inception_layer_v2(
        1024, ((352,), (192, 320), (192, 224), ("max", 128)), "inception_5b/"))
    output3.add(SpatialAveragePooling(7, 7, 1, 1).ceil())
    output3.add(View(1024))
    output3.add(Linear(1024, class_num).set_name("loss3/classifier"))
    output3.add(LogSoftMax())

    split2 = Concat(2)
    split2.add(output3)
    split2.add(output2)
    main_branch = Sequential()
    main_branch.add(features2)
    main_branch.add(split2)

    split1 = Concat(2)
    split1.add(main_branch)
    split1.add(output1)

    model = Sequential()
    model.add(features1)
    model.add(split1)
    return placed(model, device, seed)
