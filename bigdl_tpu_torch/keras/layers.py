"""Keras layer set (counterpart of ``bigdl_tpu/keras/layers.py``; parity:
reference ``nn/keras/*.scala``): each layer builds the same ``nn`` module
tree, with the same parameter names, as the JAX package's.

Image layout: channels-first (reference default dim ordering 'th')."""
from __future__ import annotations

import numpy as np

from .. import nn as N
from .topology import KerasLayer

__all__ = ["Dense", "Activation", "Dropout", "Flatten", "Reshape", "Permute",
           "RepeatVector", "Convolution2D", "Convolution1D", "MaxPooling2D",
           "AveragePooling2D", "GlobalAveragePooling2D", "GlobalMaxPooling2D",
           "MaxPooling1D", "GlobalAveragePooling1D", "ZeroPadding2D",
           "UpSampling2D", "Cropping2D", "BatchNormalization", "Embedding",
           "LSTM", "GRU", "SimpleRNN", "Bidirectional", "TimeDistributed",
           "Merge", "Highway", "LeakyReLU", "ELU", "ThresholdedReLU",
           "GaussianNoise", "GaussianDropout", "SpatialDropout2D", "Masking",
           "SoftMax", "AtrousConvolution2D", "AtrousConvolution1D",
           "SeparableConvolution2D", "Deconvolution2D", "Convolution3D",
           "LocallyConnected1D", "LocallyConnected2D", "Cropping1D",
           "Cropping3D", "ZeroPadding1D", "ZeroPadding3D", "UpSampling1D",
           "UpSampling3D", "AveragePooling1D", "MaxPooling3D",
           "AveragePooling3D", "GlobalMaxPooling1D", "GlobalMaxPooling3D",
           "GlobalAveragePooling3D", "ConvLSTM2D", "MaxoutDense", "PReLU",
           "SReLU", "SpatialDropout1D", "SpatialDropout3D"]

_ACTIVATIONS = {
    "relu": N.ReLU, "tanh": N.Tanh, "sigmoid": N.Sigmoid,
    "softmax": N.SoftMax, "log_softmax": N.LogSoftMax, "linear": N.Identity,
    "softplus": N.SoftPlus, "softsign": N.SoftSign,
    "hard_sigmoid": N.HardSigmoid, "elu": N.ELU, "relu6": N.ReLU6,
    "gelu": N.GELU,
}


def _activation(name):
    if name is None or name == "linear":
        return None
    if callable(name):
        return name
    return _ACTIVATIONS[name]()


class Dense(KerasLayer):
    """nn/keras/Dense.scala."""

    def __init__(self, output_dim: int, activation=None, with_bias=True,
                 w_regularizer=None, b_regularizer=None, input_shape=None,
                 input_dim=None, name=None):
        if input_dim is not None:
            input_shape = (input_dim,)
        super().__init__(input_shape, name)
        self.output_dim = output_dim
        self.activation = activation
        self.with_bias = with_bias
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer

    def compute_output_shape(self, s):
        return tuple(s[:-1]) + (self.output_dim,)

    def build(self, s):
        lin = N.Linear(s[-1], self.output_dim, self.with_bias,
                       self.w_regularizer, self.b_regularizer)
        if len(s) > 1:
            lin = N.Bottle(lin, n_input_dim=2)
        act = _activation(self.activation)
        return N.Sequential(lin, act) if act else lin


class Activation(KerasLayer):
    def __init__(self, activation, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.activation = activation

    def build(self, s):
        return _activation(self.activation) or N.Identity()


class Dropout(KerasLayer):
    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p

    def build(self, s):
        return N.Dropout(self.p)


class Flatten(KerasLayer):
    def compute_output_shape(self, s):
        return (int(np.prod(s)),)

    def build(self, s):
        return N.Reshape([int(np.prod(s))], batch_mode=True)


class Reshape(KerasLayer):
    def __init__(self, target_shape, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.target_shape = tuple(target_shape)

    def compute_output_shape(self, s):
        if -1 in self.target_shape:
            known = -int(np.prod(self.target_shape))
            total = int(np.prod(s))
            return tuple(total // known if d == -1 else d
                         for d in self.target_shape)
        return self.target_shape

    def build(self, s):
        return N.Reshape(list(self.compute_output_shape(s)), batch_mode=True)


class Permute(KerasLayer):
    def __init__(self, dims, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.dims = tuple(dims)  # 1-based over non-batch dims

    def compute_output_shape(self, s):
        return tuple(s[d - 1] for d in self.dims)

    def build(self, s):
        # express permutation as swaps (reference KerasLayer does the same)
        perm = [d for d in self.dims]
        swaps = []
        cur = list(range(1, len(s) + 1))
        for i, want in enumerate(perm):
            j = cur.index(want)
            if j != i:
                cur[i], cur[j] = cur[j], cur[i]
                swaps.append((i + 2, j + 2))  # +1 batch, +1 1-based
        return N.Transpose(swaps) if swaps else N.Identity()


class RepeatVector(KerasLayer):
    def __init__(self, n: int, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.n = n

    def compute_output_shape(self, s):
        return (self.n,) + tuple(s)

    def build(self, s):
        return N.Replicate(self.n, dim=2)


class Convolution2D(KerasLayer):
    """nn/keras/Convolution2D.scala (channels-first)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode: str = "valid",
                 subsample=(1, 1), dim_ordering="th", w_regularizer=None,
                 b_regularizer=None, bias=True, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = tuple(subsample)
        self.bias = bias
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer

    def _pads(self):
        if self.border_mode == "same":
            return -1, -1
        return 0, 0

    def compute_output_shape(self, s):
        c, h, w = s
        pw, ph = self._pads()
        if self.border_mode == "same":
            oh = int(np.ceil(h / self.subsample[0]))
            ow = int(np.ceil(w / self.subsample[1]))
        else:
            oh = (h - self.nb_row) // self.subsample[0] + 1
            ow = (w - self.nb_col) // self.subsample[1] + 1
        return (self.nb_filter, oh, ow)

    def build(self, s):
        pw, ph = self._pads()
        conv = N.SpatialConvolution(
            s[0], self.nb_filter, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], pw, ph,
            with_bias=self.bias, w_regularizer=self.w_regularizer,
            b_regularizer=self.b_regularizer)
        act = _activation(self.activation)
        return N.Sequential(conv, act) if act else conv


class Convolution1D(KerasLayer):
    """nn/keras/Convolution1D.scala — input (T, C)."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 border_mode="valid", subsample_length: int = 1,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter, self.filter_length = nb_filter, filter_length
        self.activation = activation
        self.border_mode = border_mode
        self.subsample_length = subsample_length

    def compute_output_shape(self, s):
        t, c = s
        if self.border_mode == "same":
            ot = int(np.ceil(t / self.subsample_length))
        else:
            ot = (t - self.filter_length) // self.subsample_length + 1
        return (ot, self.nb_filter)

    def build(self, s):
        conv = N.TemporalConvolution(s[-1], self.nb_filter,
                                     self.filter_length,
                                     self.subsample_length)
        act = _activation(self.activation)
        return N.Sequential(conv, act) if act else conv


class _Pool2D(KerasLayer):
    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 dim_ordering="th", input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.pool_size = tuple(pool_size)
        self.strides = tuple(strides) if strides else self.pool_size
        self.border_mode = border_mode

    def compute_output_shape(self, s):
        c, h, w = s
        if self.border_mode == "same":
            return (c, int(np.ceil(h / self.strides[0])),
                    int(np.ceil(w / self.strides[1])))
        return (c, (h - self.pool_size[0]) // self.strides[0] + 1,
                (w - self.pool_size[1]) // self.strides[1] + 1)


class MaxPooling2D(_Pool2D):
    def build(self, s):
        pad = -1 if self.border_mode == "same" else 0
        return N.SpatialMaxPooling(self.pool_size[1], self.pool_size[0],
                                   self.strides[1], self.strides[0], pad, pad)


class AveragePooling2D(_Pool2D):
    def build(self, s):
        pad = -1 if self.border_mode == "same" else 0
        # keras 'same' averaging excludes the zero padding from the count
        return N.SpatialAveragePooling(self.pool_size[1], self.pool_size[0],
                                       self.strides[1], self.strides[0],
                                       pad, pad, count_include_pad=False)


class GlobalAveragePooling2D(KerasLayer):
    def compute_output_shape(self, s):
        return (s[0],)

    def build(self, s):
        return N.Sequential(
            N.SpatialAveragePooling(1, 1, global_pooling=True),
            N.Reshape([s[0]], batch_mode=True))


class GlobalMaxPooling2D(KerasLayer):
    def compute_output_shape(self, s):
        return (s[0],)

    def build(self, s):
        return N.Sequential(
            N.SpatialMaxPooling(s[2], s[1], 1, 1),
            N.Reshape([s[0]], batch_mode=True))


class MaxPooling1D(KerasLayer):
    def __init__(self, pool_length: int = 2, stride=None,
                 border_mode="valid", input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.pool_length = pool_length
        self.stride = stride or pool_length

    def compute_output_shape(self, s):
        return ((s[0] - self.pool_length) // self.stride + 1, s[1])

    def build(self, s):
        return N.TemporalMaxPooling(self.pool_length, self.stride)


class GlobalAveragePooling1D(KerasLayer):
    def compute_output_shape(self, s):
        return (s[1],)

    def build(self, s):
        return N.Mean(dimension=2)


class ZeroPadding2D(KerasLayer):
    def __init__(self, padding=(1, 1), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.padding = tuple(padding)

    def compute_output_shape(self, s):
        return (s[0], s[1] + 2 * self.padding[0], s[2] + 2 * self.padding[1])

    def build(self, s):
        return N.SpatialZeroPadding(self.padding[1], self.padding[1],
                                    self.padding[0], self.padding[0])


class UpSampling2D(KerasLayer):
    def __init__(self, size=(2, 2), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.size = tuple(size)

    def compute_output_shape(self, s):
        return (s[0], s[1] * self.size[0], s[2] * self.size[1])

    def build(self, s):
        return N.UpSampling2D(self.size)


class Cropping2D(KerasLayer):
    def __init__(self, cropping=((0, 0), (0, 0)), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.cropping = cropping

    def compute_output_shape(self, s):
        (t, b), (l, r) = self.cropping
        return (s[0], s[1] - t - b, s[2] - l - r)

    def build(self, s):
        return N.Cropping2D(self.cropping[0], self.cropping[1])


class BatchNormalization(KerasLayer):
    def __init__(self, epsilon=1e-3, momentum=0.99, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.epsilon, self.momentum = epsilon, momentum

    def build(self, s):
        # keras momentum is running-average keep-rate; reference BN momentum
        # is the update rate
        if len(s) == 3:
            return N.SpatialBatchNormalization(s[0], self.epsilon,
                                               1.0 - self.momentum)
        return N.BatchNormalization(s[-1], self.epsilon, 1.0 - self.momentum)


class Embedding(KerasLayer):
    """nn/keras/Embedding.scala — 0-based token ids in, (T, dim) out."""

    def __init__(self, input_dim: int, output_dim: int, input_shape=None,
                 input_length=None, name=None):
        if input_length is not None:
            input_shape = (input_length,)
        super().__init__(input_shape, name)
        self.input_dim, self.output_dim = input_dim, output_dim

    def compute_output_shape(self, s):
        return (s[0], self.output_dim)

    def build(self, s):
        return N.Sequential(N.AddConstant(1.0),
                            N.LookupTable(self.input_dim, self.output_dim))


class _KerasRecurrent(KerasLayer):
    def __init__(self, output_dim: int, activation="tanh",
                 return_sequences=False, go_backwards=False,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.output_dim = output_dim
        self.activation = activation
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def compute_output_shape(self, s):
        if self.return_sequences:
            return (s[0], self.output_dim)
        return (self.output_dim,)

    def _cell(self, input_size):
        raise NotImplementedError

    def build(self, s):
        seq = N.Sequential()
        if self.go_backwards:
            seq.add(N.Reverse(2))
        seq.add(N.Recurrent(self._cell(s[-1])))
        if not self.return_sequences:
            seq.add(N.Select(2, -1))
        return seq


class LSTM(_KerasRecurrent):
    def _cell(self, input_size):
        return N.LSTM(input_size, self.output_dim)


class GRU(_KerasRecurrent):
    def _cell(self, input_size):
        return N.GRU(input_size, self.output_dim)


class SimpleRNN(_KerasRecurrent):
    def _cell(self, input_size):
        return N.RnnCell(input_size, self.output_dim)


class Bidirectional(KerasLayer):
    def __init__(self, layer: _KerasRecurrent, merge_mode="concat",
                 input_shape=None, name=None):
        super().__init__(input_shape or layer.input_shape, name)
        self.layer = layer
        self.merge_mode = merge_mode

    def compute_output_shape(self, s):
        base = self.layer.compute_output_shape(s)
        if self.merge_mode == "concat":
            return base[:-1] + (base[-1] * 2,)
        return base

    def build(self, s):
        br = N.BiRecurrent("concat" if self.merge_mode == "concat" else None)
        br.add(self.layer._cell(s[-1]))
        seq = N.Sequential(br)
        if not self.layer.return_sequences:
            seq.add(N.Select(2, -1))
        return seq


class TimeDistributed(KerasLayer):
    def __init__(self, layer: KerasLayer, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.layer = layer

    def compute_output_shape(self, s):
        inner = self.layer.compute_output_shape(s[1:])
        return (s[0],) + tuple(inner)

    def build(self, s):
        return N.TimeDistributed(self.layer._built(s[1:]))


class Merge(KerasLayer):
    """nn/keras/Merge.scala — merge a list of KerasNodes."""

    def __init__(self, layers=None, mode="sum", concat_axis=-1,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.mode = mode
        self.concat_axis = concat_axis

    def compute_output_shape_multi(self, shapes):
        if self.mode == "concat":
            ax = self.concat_axis if self.concat_axis >= 0 else \
                len(shapes[0]) - 1
            out = list(shapes[0])
            out[ax] = sum(s[ax] for s in shapes)
            return tuple(out)
        return tuple(shapes[0])

    def build(self, s):
        if self.mode == "sum":
            return N.CAddTable()
        if self.mode == "mul":
            return N.CMulTable()
        if self.mode == "max":
            return N.CMaxTable()
        if self.mode == "ave":
            return N.CAveTable()
        if self.mode == "dot":
            return N.DotProduct()
        if self.mode == "concat":
            ax = self.concat_axis
            return N.JoinTable(ax + 1 if ax > 0 else -1)
        raise ValueError(f"unknown merge mode {self.mode}")

    def __call__(self, nodes):
        from .topology import KerasNode
        m = self._built(nodes[0].shape)
        nn_node = m([n.nn_node for n in nodes])
        shape = self.compute_output_shape_multi([n.shape for n in nodes])
        return KerasNode(nn_node, shape)


class Highway(KerasLayer):
    def __init__(self, activation="tanh", input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.activation = activation

    def build(self, s):
        return N.Highway(s[-1], activation=self.activation)


class LeakyReLU(KerasLayer):
    def __init__(self, alpha=0.3, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.alpha = alpha

    def build(self, s):
        return N.LeakyReLU(self.alpha)


class ELU(KerasLayer):
    def __init__(self, alpha=1.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.alpha = alpha

    def build(self, s):
        return N.ELU(self.alpha)


class ThresholdedReLU(KerasLayer):
    def __init__(self, theta=1.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.theta = theta

    def build(self, s):
        return N.Threshold(self.theta, 0.0)


class GaussianNoise(KerasLayer):
    def __init__(self, sigma, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.sigma = sigma

    def build(self, s):
        return N.GaussianNoise(self.sigma)


class GaussianDropout(KerasLayer):
    def __init__(self, p, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p

    def build(self, s):
        return N.GaussianDropout(self.p)


class SpatialDropout2D(KerasLayer):
    def __init__(self, p=0.5, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p

    def build(self, s):
        return N.SpatialDropout2D(self.p)


class Masking(KerasLayer):
    def __init__(self, mask_value=0.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.mask_value = mask_value

    def build(self, s):
        return N.Masking(self.mask_value)


# ---------------------------------------------------------------------------
# Long-tail keras-1.2 layer set (parity: reference nn/keras/*.scala beyond the
# core; channels-first like the reference's default 'th' dim ordering).
# ---------------------------------------------------------------------------


class SoftMax(KerasLayer):
    """nn/keras/SoftMax.scala."""

    def build(self, s):
        return N.SoftMax()


class AtrousConvolution2D(KerasLayer):
    """nn/keras/AtrousConvolution2D.scala — dilated conv, 'valid' only
    (the reference supports only border_mode='valid' too)."""

    def __init__(self, nb_filter, nb_row, nb_col, activation=None,
                 border_mode="valid", subsample=(1, 1), atrous_rate=(1, 1),
                 w_regularizer=None, b_regularizer=None, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        if border_mode != "valid":
            raise ValueError("AtrousConvolution2D supports only "
                             "border_mode='valid' (same as the reference)")
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.subsample = tuple(subsample)
        self.atrous_rate = tuple(atrous_rate)
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer

    def compute_output_shape(self, s):
        c, h, w = s
        kh = (self.nb_row - 1) * self.atrous_rate[0] + 1
        kw = (self.nb_col - 1) * self.atrous_rate[1] + 1
        return (self.nb_filter, (h - kh) // self.subsample[0] + 1,
                (w - kw) // self.subsample[1] + 1)

    def build(self, s):
        conv = N.SpatialDilatedConvolution(
            s[0], self.nb_filter, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], 0, 0,
            self.atrous_rate[1], self.atrous_rate[0],
            w_regularizer=self.w_regularizer,
            b_regularizer=self.b_regularizer)
        act = _activation(self.activation)
        return N.Sequential(conv, act) if act else conv


class AtrousConvolution1D(KerasLayer):
    """nn/keras/AtrousConvolution1D.scala — (T, C) in; dilated temporal conv
    expressed as a (C, T, 1) dilated spatial conv like the reference."""

    def __init__(self, nb_filter, filter_length, activation=None,
                 border_mode="valid", subsample_length=1, atrous_rate=1,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        if border_mode != "valid":
            raise ValueError("AtrousConvolution1D supports only "
                             "border_mode='valid' (same as the reference)")
        self.nb_filter, self.filter_length = nb_filter, filter_length
        self.activation = activation
        self.subsample_length = subsample_length
        self.atrous_rate = atrous_rate

    def compute_output_shape(self, s):
        t, c = s
        k = (self.filter_length - 1) * self.atrous_rate + 1
        return ((t - k) // self.subsample_length + 1, self.nb_filter)

    def build(self, s):
        conv = N.SpatialDilatedConvolution(
            s[-1], self.nb_filter, 1, self.filter_length,
            1, self.subsample_length, 0, 0, 1, self.atrous_rate)
        seq = N.Sequential(
            N.Transpose([(2, 3)]), N.Unsqueeze(4), conv,
            N.Squeeze(4), N.Transpose([(2, 3)]))
        act = _activation(self.activation)
        return seq.add(act) if act else seq


class SeparableConvolution2D(KerasLayer):
    """nn/keras/SeparableConvolution2D.scala."""

    def __init__(self, nb_filter, nb_row, nb_col, activation=None,
                 border_mode="valid", subsample=(1, 1), depth_multiplier=1,
                 bias=True, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = tuple(subsample)
        self.depth_multiplier = depth_multiplier
        self.bias = bias

    def compute_output_shape(self, s):
        c, h, w = s
        if self.border_mode == "same":
            return (self.nb_filter, int(np.ceil(h / self.subsample[0])),
                    int(np.ceil(w / self.subsample[1])))
        return (self.nb_filter, (h - self.nb_row) // self.subsample[0] + 1,
                (w - self.nb_col) // self.subsample[1] + 1)

    def build(self, s):
        pad = -1 if self.border_mode == "same" else 0
        conv = N.SpatialSeparableConvolution(
            s[0], self.nb_filter, self.depth_multiplier,
            self.nb_col, self.nb_row, self.subsample[1], self.subsample[0],
            pad, pad, has_bias=self.bias)
        act = _activation(self.activation)
        return N.Sequential(conv, act) if act else conv


class Deconvolution2D(KerasLayer):
    """nn/keras/Deconvolution2D.scala — transposed conv, 'valid' only."""

    def __init__(self, nb_filter, nb_row, nb_col, activation=None,
                 border_mode="valid", subsample=(1, 1), bias=True,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        if border_mode != "valid":
            raise ValueError("Deconvolution2D supports only "
                             "border_mode='valid' (same as the reference)")
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.subsample = tuple(subsample)
        self.bias = bias

    def compute_output_shape(self, s):
        c, h, w = s
        return (self.nb_filter, (h - 1) * self.subsample[0] + self.nb_row,
                (w - 1) * self.subsample[1] + self.nb_col)

    def build(self, s):
        conv = N.SpatialFullConvolution(
            s[0], self.nb_filter, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], no_bias=not self.bias)
        act = _activation(self.activation)
        return N.Sequential(conv, act) if act else conv


class Convolution3D(KerasLayer):
    """nn/keras/Convolution3D.scala — (C, D1, D2, D3) in."""

    def __init__(self, nb_filter, kernel_dim1, kernel_dim2, kernel_dim3,
                 activation=None, border_mode="valid", subsample=(1, 1, 1),
                 bias=True, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter = nb_filter
        self.kernel = (kernel_dim1, kernel_dim2, kernel_dim3)
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = tuple(subsample)
        self.bias = bias

    def compute_output_shape(self, s):
        c = self.nb_filter
        if self.border_mode == "same":
            return (c,) + tuple(int(np.ceil(d / st))
                                for d, st in zip(s[1:], self.subsample))
        return (c,) + tuple((d - k) // st + 1 for d, k, st in
                            zip(s[1:], self.kernel, self.subsample))

    def build(self, s):
        pad = -1 if self.border_mode == "same" else 0
        conv = N.VolumetricConvolution(
            s[0], self.nb_filter, self.kernel[0], self.kernel[2],
            self.kernel[1], self.subsample[0], self.subsample[2],
            self.subsample[1], pad, pad, pad, with_bias=self.bias)
        act = _activation(self.activation)
        return N.Sequential(conv, act) if act else conv


class LocallyConnected1D(KerasLayer):
    """nn/keras/LocallyConnected1D.scala — (T, C) in, untied weights."""

    def __init__(self, nb_filter, filter_length, activation=None,
                 subsample_length=1, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter, self.filter_length = nb_filter, filter_length
        self.activation = activation
        self.subsample_length = subsample_length

    def compute_output_shape(self, s):
        t, c = s
        return ((t - self.filter_length) // self.subsample_length + 1,
                self.nb_filter)

    def build(self, s):
        lc = N.LocallyConnected1D(s[0], s[1], self.nb_filter,
                                  self.filter_length, self.subsample_length)
        act = _activation(self.activation)
        return N.Sequential(lc, act) if act else lc


class LocallyConnected2D(KerasLayer):
    """nn/keras/LocallyConnected2D.scala — (C, H, W) in, untied weights."""

    def __init__(self, nb_filter, nb_row, nb_col, activation=None,
                 border_mode="valid", subsample=(1, 1), bias=True,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = tuple(subsample)
        self.bias = bias

    def compute_output_shape(self, s):
        c, h, w = s
        if self.border_mode == "same":
            return (self.nb_filter, int(np.ceil(h / self.subsample[0])),
                    int(np.ceil(w / self.subsample[1])))
        return (self.nb_filter, (h - self.nb_row) // self.subsample[0] + 1,
                (w - self.nb_col) // self.subsample[1] + 1)

    def build(self, s):
        pre = None
        h, w = s[1], s[2]
        if self.border_mode == "same":
            # SAME padding is asymmetric for even kernels; LocallyConnected2D
            # takes symmetric pads only, so pad explicitly then run VALID.
            oh = int(np.ceil(h / self.subsample[0]))
            ow = int(np.ceil(w / self.subsample[1]))
            th = max(0, (oh - 1) * self.subsample[0] + self.nb_row - h)
            tw = max(0, (ow - 1) * self.subsample[1] + self.nb_col - w)
            if th or tw:
                pre = N.SpatialZeroPadding(tw // 2, tw - tw // 2,
                                           th // 2, th - th // 2)
            h, w = h + th, w + tw
        lc = N.LocallyConnected2D(s[0], w, h, self.nb_filter,
                                  self.nb_col, self.nb_row,
                                  self.subsample[1], self.subsample[0],
                                  0, 0, with_bias=self.bias)
        act = _activation(self.activation)
        mods = [m for m in (pre, lc, act) if m is not None]
        return mods[0] if len(mods) == 1 else N.Sequential(*mods)


class Cropping1D(KerasLayer):
    """nn/keras/Cropping1D.scala — (T, C) in."""

    def __init__(self, cropping=(1, 1), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.cropping = tuple(cropping)

    def compute_output_shape(self, s):
        return (s[0] - sum(self.cropping), s[1])

    def build(self, s):
        a, b = self.cropping
        return N.Narrow(2, a + 1, s[0] - a - b)


class Cropping3D(KerasLayer):
    """nn/keras/Cropping3D.scala — (C, D1, D2, D3) in."""

    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.cropping = tuple(tuple(c) for c in cropping)

    def compute_output_shape(self, s):
        return (s[0],) + tuple(d - sum(c)
                               for d, c in zip(s[1:], self.cropping))

    def build(self, s):
        return N.Cropping3D(*self.cropping)


class ZeroPadding1D(KerasLayer):
    """nn/keras/ZeroPadding1D.scala — (T, C) in."""

    def __init__(self, padding=1, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.padding = (padding, padding) if isinstance(padding, int) \
            else tuple(padding)

    def compute_output_shape(self, s):
        return (s[0] + sum(self.padding), s[1])

    def build(self, s):
        return N.Sequential(
            N.Padding(1, -self.padding[0], 2),
            N.Padding(1, self.padding[1], 2))


class ZeroPadding3D(KerasLayer):
    """nn/keras/ZeroPadding3D.scala — (C, D1, D2, D3) in."""

    def __init__(self, padding=(1, 1, 1), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.padding = tuple(padding)

    def compute_output_shape(self, s):
        return (s[0],) + tuple(d + 2 * p
                               for d, p in zip(s[1:], self.padding))

    def build(self, s):
        seq = N.Sequential()
        for dim, p in enumerate(self.padding, start=2):
            if p:
                seq.add(N.Padding(dim, -p, 4)).add(N.Padding(dim, p, 4))
        return seq if seq.modules else N.Identity()


class UpSampling1D(KerasLayer):
    """nn/keras/UpSampling1D.scala — (T, C) in."""

    def __init__(self, length=2, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.length = length

    def compute_output_shape(self, s):
        return (s[0] * self.length, s[1])

    def build(self, s):
        return N.UpSampling1D(self.length)


class UpSampling3D(KerasLayer):
    """nn/keras/UpSampling3D.scala — (C, D1, D2, D3) in."""

    def __init__(self, size=(2, 2, 2), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.size = tuple(size)

    def compute_output_shape(self, s):
        return (s[0],) + tuple(d * f for d, f in zip(s[1:], self.size))

    def build(self, s):
        return N.UpSampling3D(self.size)


class AveragePooling1D(KerasLayer):
    """nn/keras/AveragePooling1D.scala — (T, C) in; expressed as a (C, T, 1)
    spatial pooling."""

    def __init__(self, pool_length=2, stride=None, border_mode="valid",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.pool_length = pool_length
        self.stride = stride or pool_length
        self.border_mode = border_mode

    def compute_output_shape(self, s):
        if self.border_mode == "same":
            return (int(np.ceil(s[0] / self.stride)), s[1])
        return ((s[0] - self.pool_length) // self.stride + 1, s[1])

    def build(self, s):
        pad = -1 if self.border_mode == "same" else 0
        return N.Sequential(
            N.Transpose([(2, 3)]), N.Unsqueeze(4),
            N.SpatialAveragePooling(1, self.pool_length, 1, self.stride,
                                    pad, pad, count_include_pad=False),
            N.Squeeze(4), N.Transpose([(2, 3)]))


class MaxPooling3D(KerasLayer):
    """nn/keras/MaxPooling3D.scala — (C, D1, D2, D3) in, 'valid' only."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.pool_size = tuple(pool_size)
        self.strides = tuple(strides) if strides else self.pool_size

    def compute_output_shape(self, s):
        return (s[0],) + tuple((d - k) // st + 1 for d, k, st in
                               zip(s[1:], self.pool_size, self.strides))

    def build(self, s):
        return N.VolumetricMaxPooling(
            self.pool_size[0], self.pool_size[2], self.pool_size[1],
            self.strides[0], self.strides[2], self.strides[1])


class AveragePooling3D(KerasLayer):
    """nn/keras/AveragePooling3D.scala — (C, D1, D2, D3) in, 'valid' only."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.pool_size = tuple(pool_size)
        self.strides = tuple(strides) if strides else self.pool_size

    def compute_output_shape(self, s):
        return (s[0],) + tuple((d - k) // st + 1 for d, k, st in
                               zip(s[1:], self.pool_size, self.strides))

    def build(self, s):
        return N.VolumetricAveragePooling(
            self.pool_size[0], self.pool_size[2], self.pool_size[1],
            self.strides[0], self.strides[2], self.strides[1])


class GlobalMaxPooling1D(KerasLayer):
    """nn/keras/GlobalMaxPooling1D.scala — (T, C) → (C,)."""

    def compute_output_shape(self, s):
        return (s[1],)

    def build(self, s):
        return N.Max(dim=1, num_input_dims=2)


class GlobalMaxPooling3D(KerasLayer):
    """nn/keras/GlobalMaxPooling3D.scala — (C, D1, D2, D3) → (C,)."""

    def compute_output_shape(self, s):
        return (s[0],)

    def build(self, s):
        return N.Sequential(
            N.VolumetricMaxPooling(s[1], s[3], s[2], 1, 1, 1),
            N.Reshape([s[0]], batch_mode=True))


class GlobalAveragePooling3D(KerasLayer):
    """nn/keras/GlobalAveragePooling3D.scala — (C, D1, D2, D3) → (C,)."""

    def compute_output_shape(self, s):
        return (s[0],)

    def build(self, s):
        return N.Sequential(
            N.VolumetricAveragePooling(s[1], s[3], s[2], 1, 1, 1),
            N.Reshape([s[0]], batch_mode=True))


class ConvLSTM2D(KerasLayer):
    """nn/keras/ConvLSTM2D.scala — (T, C, H, W) in; square kernel, SAME pad,
    peephole ConvLSTM scanned over time."""

    def __init__(self, nb_filter, nb_kernel, activation="tanh",
                 border_mode="same", subsample=1, return_sequences=False,
                 go_backwards=False, input_shape=None, name=None):
        super().__init__(input_shape, name)
        if activation not in ("tanh", None):
            raise ValueError("ConvLSTM2D supports only activation='tanh' "
                             "(same as the reference)")
        if border_mode != "same":
            raise ValueError("ConvLSTM2D supports only border_mode='same' "
                             "(same as the reference)")
        self.nb_filter, self.nb_kernel = nb_filter, nb_kernel
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.subsample = subsample

    def compute_output_shape(self, s):
        t, c, h, w = s
        oh = int(np.ceil(h / self.subsample))
        ow = int(np.ceil(w / self.subsample))
        if self.return_sequences:
            return (t, self.nb_filter, oh, ow)
        return (self.nb_filter, oh, ow)

    def build(self, s):
        cell = N.ConvLSTMPeephole(s[1], self.nb_filter, self.nb_kernel,
                                  self.nb_kernel, self.subsample, -1)
        seq = N.Sequential()
        if self.go_backwards:
            seq.add(N.Reverse(2))
        seq.add(N.Recurrent(cell))
        if not self.return_sequences:
            seq.add(N.Select(2, -1))
        return seq


class MaxoutDense(KerasLayer):
    """nn/keras/MaxoutDense.scala."""

    def __init__(self, output_dim, nb_feature=4, bias=True, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.output_dim, self.nb_feature = output_dim, nb_feature
        self.bias = bias

    def compute_output_shape(self, s):
        return (self.output_dim,)

    def build(self, s):
        return N.Maxout(s[-1], self.output_dim, self.nb_feature,
                        with_bias=self.bias)


class PReLU(KerasLayer):
    """nn/keras/... PReLU advanced activation."""

    def build(self, s):
        return N.PReLU()


class SReLU(KerasLayer):
    """nn/keras/SReLU.scala."""

    def __init__(self, shared_axes=None, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.shared_axes = shared_axes

    def build(self, s):
        return N.SReLU(s, shared_axes=self.shared_axes)


class SpatialDropout1D(KerasLayer):
    def __init__(self, p=0.5, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p

    def build(self, s):
        return N.SpatialDropout1D(self.p)


class SpatialDropout3D(KerasLayer):
    def __init__(self, p=0.5, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p

    def build(self, s):
        return N.SpatialDropout3D(self.p)
