"""Keras-1.2.2 model-definition converter (counterpart of
``bigdl_tpu/keras/converter.py``).

Parity: reference ``pyspark/bigdl/keras/converter.py`` (DefinitionLoader /
WeightLoader / WeightsConverter). Ingests actual Keras 1.2 ``model.to_json()``
definitions — both ``Sequential`` configs and functional ``Model`` graphs —
into the :mod:`bigdl_tpu_torch.keras` API, and loads weights from Keras HDF5 files
(h5py) with the layout conversions each layer needs (Dense kernels are
(in, out) in Keras vs (out, in) here; LSTM/GRU store per-gate blocks; BN
carries running stats in its weight list).

Channels-first (``dim_ordering="th"``, the reference default) is supported
end-to-end. ``"tf"``-ordered (channels-last — including every modern
tf.keras export) spatial stacks are converted through a transposed-weight
pipeline: the model is BUILT channels-first (3-D input shapes transposed
(H, W, C) → (C, H, W) — feed NCHW arrays), conv kernels are transposed at
load ((kh, kw, in, out) → (out, in, kh, kw)), and a Dense following a
Flatten gets its kernel rows permuted from the keras (h, w, c) flatten
order to our (c, h, w) order — beyond the reference, whose converter
assumes "th" (pyspark/bigdl/keras/converter.py).

``model_from_json`` and ``load_keras`` take a trailing ``device`` (the
CUDA device by default; ``"cpu"`` for the CPU), where the model is built;
weights are written into the live tensors there, each cast to its
tensor's dtype. ``h5py`` is imported inside the functions that read
HDF5, never with the module.
"""
from __future__ import annotations

import json
import logging
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import nn as N
from . import layers as L
from .topology import Input, KerasNode, Model, Sequential

__all__ = ["layer_from_config", "model_from_json", "load_weights",
           "load_weights_hdf5", "load_keras"]

log = logging.getLogger("bigdl_tpu_torch.keras.converter")


# ---------------------------------------------------------------------------
# layer factories: keras-1.2 config dict → bigdl_tpu_torch.keras layer
# ---------------------------------------------------------------------------


def _act(cfg, key="activation"):
    a = cfg.get(key)
    return None if a in (None, "linear") else a


def _is_tf(cfg) -> bool:
    return cfg.get("dim_ordering", "th") == "tf"


def _pair(v, default):
    if v is None:
        return default
    return tuple(int(x) for x in v)


def _l_dense(cfg):
    return L.Dense(int(cfg["output_dim"]), activation=_act(cfg),
                   with_bias=cfg.get("bias", True))


def _l_activation(cfg):
    return L.Activation(cfg["activation"])


def _l_dropout(cfg):
    return L.Dropout(float(cfg.get("p", 0.5)))


def _l_flatten(cfg):
    return L.Flatten()


def _l_reshape(cfg):
    return L.Reshape(tuple(cfg["target_shape"]))


def _l_permute(cfg):
    return L.Permute(tuple(cfg["dims"]))


def _l_repeatvector(cfg):
    return L.RepeatVector(int(cfg["n"]))


def _l_conv1d(cfg):
    return L.Convolution1D(int(cfg["nb_filter"]), int(cfg["filter_length"]),
                           activation=_act(cfg),
                           border_mode=cfg.get("border_mode", "valid"),
                           subsample_length=int(cfg.get("subsample_length",
                                                        1)))


def _l_conv2d(cfg):
    return L.Convolution2D(int(cfg["nb_filter"]), int(cfg["nb_row"]),
                           int(cfg["nb_col"]), activation=_act(cfg),
                           border_mode=cfg.get("border_mode", "valid"),
                           subsample=_pair(cfg.get("subsample"), (1, 1)),
                           bias=cfg.get("bias", True))


def _l_conv3d(cfg):
    return L.Convolution3D(int(cfg["nb_filter"]), int(cfg["kernel_dim1"]),
                           int(cfg["kernel_dim2"]), int(cfg["kernel_dim3"]),
                           activation=_act(cfg),
                           border_mode=cfg.get("border_mode", "valid"),
                           subsample=_pair(cfg.get("subsample"), (1, 1, 1)),
                           bias=cfg.get("bias", True))


def _l_atrous1d(cfg):
    return L.AtrousConvolution1D(
        int(cfg["nb_filter"]), int(cfg["filter_length"]),
        activation=_act(cfg), border_mode=cfg.get("border_mode", "valid"),
        subsample_length=int(cfg.get("subsample_length", 1)),
        atrous_rate=int(cfg.get("atrous_rate", 1)))


def _l_atrous2d(cfg):
    return L.AtrousConvolution2D(
        int(cfg["nb_filter"]), int(cfg["nb_row"]), int(cfg["nb_col"]),
        activation=_act(cfg), border_mode=cfg.get("border_mode", "valid"),
        subsample=_pair(cfg.get("subsample"), (1, 1)),
        atrous_rate=_pair(cfg.get("atrous_rate"), (1, 1)))


def _l_separable2d(cfg):
    return L.SeparableConvolution2D(
        int(cfg["nb_filter"]), int(cfg["nb_row"]), int(cfg["nb_col"]),
        activation=_act(cfg), border_mode=cfg.get("border_mode", "valid"),
        subsample=_pair(cfg.get("subsample"), (1, 1)),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        bias=cfg.get("bias", True))


def _l_deconv2d(cfg):
    return L.Deconvolution2D(int(cfg["nb_filter"]), int(cfg["nb_row"]),
                             int(cfg["nb_col"]), activation=_act(cfg),
                             border_mode=cfg.get("border_mode", "valid"),
                             subsample=_pair(cfg.get("subsample"), (1, 1)),
                             bias=cfg.get("bias", True))


def _l_maxpool2d(cfg):
    return L.MaxPooling2D(pool_size=_pair(cfg.get("pool_size"), (2, 2)),
                          strides=_pair(cfg.get("strides"), None) or None,
                          border_mode=cfg.get("border_mode", "valid"))


def _l_avgpool2d(cfg):
    return L.AveragePooling2D(pool_size=_pair(cfg.get("pool_size"), (2, 2)),
                              strides=_pair(cfg.get("strides"), None) or None,
                              border_mode=cfg.get("border_mode", "valid"))


def _l_maxpool1d(cfg):
    return L.MaxPooling1D(pool_length=int(cfg.get("pool_length", 2)),
                          stride=cfg.get("stride"),
                          border_mode=cfg.get("border_mode", "valid"))


def _l_avgpool1d(cfg):
    return L.AveragePooling1D(pool_length=int(cfg.get("pool_length", 2)),
                              stride=cfg.get("stride"),
                              border_mode=cfg.get("border_mode", "valid"))


def _l_maxpool3d(cfg):
    return L.MaxPooling3D(pool_size=_pair(cfg.get("pool_size"), (2, 2, 2)),
                          strides=_pair(cfg.get("strides"), None) or None)


def _l_avgpool3d(cfg):
    return L.AveragePooling3D(pool_size=_pair(cfg.get("pool_size"),
                                              (2, 2, 2)),
                              strides=_pair(cfg.get("strides"), None) or None)


def _l_zeropad1d(cfg):
    return L.ZeroPadding1D(padding=cfg.get("padding", 1))


def _l_zeropad2d(cfg):
    return L.ZeroPadding2D(padding=_pair(cfg.get("padding"), (1, 1)))


def _l_zeropad3d(cfg):
    return L.ZeroPadding3D(padding=_pair(cfg.get("padding"), (1, 1, 1)))


def _l_crop1d(cfg):
    return L.Cropping1D(cropping=_pair(cfg.get("cropping"), (1, 1)))


def _l_crop2d(cfg):
    c = cfg.get("cropping", ((0, 0), (0, 0)))
    return L.Cropping2D(cropping=tuple(tuple(int(x) for x in p) for p in c))


def _l_crop3d(cfg):
    c = cfg.get("cropping", ((1, 1), (1, 1), (1, 1)))
    return L.Cropping3D(cropping=tuple(tuple(int(x) for x in p) for p in c))


def _l_upsample1d(cfg):
    return L.UpSampling1D(length=int(cfg.get("length", 2)))


def _l_upsample2d(cfg):
    return L.UpSampling2D(size=_pair(cfg.get("size"), (2, 2)))


def _l_upsample3d(cfg):
    return L.UpSampling3D(size=_pair(cfg.get("size"), (2, 2, 2)))


def _l_batchnorm(cfg):
    if cfg.get("mode", 0) not in (0, 2):
        raise NotImplementedError("keras converter: BatchNormalization "
                                  f"mode={cfg['mode']} unsupported")
    axis = int(cfg.get("axis", -1))
    eps = float(cfg.get("epsilon", 1e-3))
    momentum = float(cfg.get("momentum", 0.99))
    bn = L.BatchNormalization(epsilon=eps, momentum=momentum)
    orig_build = bn.build

    tf_model = bool(cfg.get("_model_tf_ordered"))

    def build(s):
        if len(s) >= 3:
            # spatial input: only channel-axis normalization converts. In a
            # th model that is axis=1; in a tf-ordered model keras axis
            # -1/3 IS the channel axis (our models are built channels-first
            # either way, so both land on our axis 1)
            # keras channel axis for channels-last is the LAST axis:
            # -1 or len(s) counting the batch dim (3 for rank-4 inputs,
            # 4 for rank-5) — never a fixed 3, which is the W axis of a
            # volumetric input
            channel_axes = (-1, len(s)) if tf_model else (1,)
            if axis not in channel_axes:
                raise NotImplementedError(
                    f"keras converter: BatchNormalization axis={axis} over "
                    f"a rank-{len(s) + 1} input — only channel-axis "
                    f"({'-1/' + str(len(s)) if tf_model else '1'}) converts")
            return orig_build(s)
        if len(s) == 2:
            # temporal (T, F) input: keras axis=-1/2 normalizes features —
            # collapse (B, T) through Bottle so feature BN sees (B*T, F)
            if axis not in (-1, 2):
                raise NotImplementedError(
                    f"keras converter: BatchNormalization axis={axis} over "
                    "a (T, F) input — only feature-axis (-1) converts")
            return N.Bottle(N.BatchNormalization(s[-1], eps,
                                                 1.0 - momentum),
                            n_input_dim=2)
        return orig_build(s)

    bn.build = build
    return bn


def _l_embedding(cfg):
    return L.Embedding(int(cfg["input_dim"]), int(cfg["output_dim"]),
                       input_length=cfg.get("input_length"))


def _recurrent_kwargs(cfg):
    return dict(activation=cfg.get("activation", "tanh"),
                return_sequences=cfg.get("return_sequences", False),
                go_backwards=cfg.get("go_backwards", False))


def _l_lstm(cfg):
    return L.LSTM(int(cfg["output_dim"]), **_recurrent_kwargs(cfg))


def _l_gru(cfg):
    return L.GRU(int(cfg["output_dim"]), **_recurrent_kwargs(cfg))


def _l_simplernn(cfg):
    return L.SimpleRNN(int(cfg["output_dim"]), **_recurrent_kwargs(cfg))


def _l_merge(cfg):
    return L.Merge(mode=cfg.get("mode", "sum"),
                   concat_axis=int(cfg.get("concat_axis", -1)))


def _l_highway(cfg):
    return L.Highway(activation=_act(cfg) or "tanh")


def _l_maxoutdense(cfg):
    return L.MaxoutDense(int(cfg["output_dim"]),
                         nb_feature=int(cfg.get("nb_feature", 4)),
                         bias=cfg.get("bias", True))


def _l_leakyrelu(cfg):
    return L.LeakyReLU(alpha=float(cfg.get("alpha", 0.3)))


def _l_elu(cfg):
    return L.ELU(alpha=float(cfg.get("alpha", 1.0)))


def _l_thresholdedrelu(cfg):
    return L.ThresholdedReLU(theta=float(cfg.get("theta", 1.0)))


def _l_prelu(cfg):
    return L.PReLU()


def _l_srelu(cfg):
    return L.SReLU(shared_axes=cfg.get("shared_axes"))


def _l_masking(cfg):
    return L.Masking(mask_value=float(cfg.get("mask_value", 0.0)))


def _l_gaussiannoise(cfg):
    return L.GaussianNoise(float(cfg.get("sigma", 0.1)))


def _l_gaussiandropout(cfg):
    return L.GaussianDropout(float(cfg.get("p", 0.5)))


def _l_spatialdropout1d(cfg):
    return L.SpatialDropout1D(float(cfg.get("p", 0.5)))


def _l_spatialdropout2d(cfg):
    return L.SpatialDropout2D(float(cfg.get("p", 0.5)))


def _l_spatialdropout3d(cfg):
    return L.SpatialDropout3D(float(cfg.get("p", 0.5)))


def _l_globalmaxpool1d(cfg):
    return L.GlobalMaxPooling1D()


def _l_globalavgpool1d(cfg):
    return L.GlobalAveragePooling1D()


def _l_globalmaxpool2d(cfg):
    return L.GlobalMaxPooling2D()


def _l_globalavgpool2d(cfg):
    return L.GlobalAveragePooling2D()


def _l_globalmaxpool3d(cfg):
    return L.GlobalMaxPooling3D()


def _l_globalavgpool3d(cfg):
    return L.GlobalAveragePooling3D()


def _l_locallyconnected1d(cfg):
    return L.LocallyConnected1D(int(cfg["nb_filter"]),
                                int(cfg["filter_length"]),
                                activation=_act(cfg),
                                subsample_length=int(
                                    cfg.get("subsample_length", 1)))


def _l_locallyconnected2d(cfg):
    return L.LocallyConnected2D(int(cfg["nb_filter"]), int(cfg["nb_row"]),
                                int(cfg["nb_col"]), activation=_act(cfg),
                                border_mode=cfg.get("border_mode", "valid"),
                                subsample=_pair(cfg.get("subsample"), (1, 1)),
                                bias=cfg.get("bias", True))


_FACTORIES = {
    "Dense": _l_dense, "Activation": _l_activation, "Dropout": _l_dropout,
    "Flatten": _l_flatten, "Reshape": _l_reshape, "Permute": _l_permute,
    "RepeatVector": _l_repeatvector,
    "Convolution1D": _l_conv1d, "Convolution2D": _l_conv2d,
    "Convolution3D": _l_conv3d, "AtrousConvolution1D": _l_atrous1d,
    "AtrousConvolution2D": _l_atrous2d,
    "SeparableConvolution2D": _l_separable2d,
    "Deconvolution2D": _l_deconv2d,
    "MaxPooling1D": _l_maxpool1d, "MaxPooling2D": _l_maxpool2d,
    "MaxPooling3D": _l_maxpool3d,
    "AveragePooling1D": _l_avgpool1d, "AveragePooling2D": _l_avgpool2d,
    "AveragePooling3D": _l_avgpool3d,
    "GlobalMaxPooling1D": _l_globalmaxpool1d,
    "GlobalMaxPooling2D": _l_globalmaxpool2d,
    "GlobalMaxPooling3D": _l_globalmaxpool3d,
    "GlobalAveragePooling1D": _l_globalavgpool1d,
    "GlobalAveragePooling2D": _l_globalavgpool2d,
    "GlobalAveragePooling3D": _l_globalavgpool3d,
    "ZeroPadding1D": _l_zeropad1d, "ZeroPadding2D": _l_zeropad2d,
    "ZeroPadding3D": _l_zeropad3d,
    "Cropping1D": _l_crop1d, "Cropping2D": _l_crop2d,
    "Cropping3D": _l_crop3d,
    "UpSampling1D": _l_upsample1d, "UpSampling2D": _l_upsample2d,
    "UpSampling3D": _l_upsample3d,
    "BatchNormalization": _l_batchnorm, "Embedding": _l_embedding,
    "LSTM": _l_lstm, "GRU": _l_gru, "SimpleRNN": _l_simplernn,
    "Merge": _l_merge, "Highway": _l_highway,
    "MaxoutDense": _l_maxoutdense,
    "LeakyReLU": _l_leakyrelu, "ELU": _l_elu,
    "ThresholdedReLU": _l_thresholdedrelu, "PReLU": _l_prelu,
    "SReLU": _l_srelu, "Masking": _l_masking,
    "GaussianNoise": _l_gaussiannoise,
    "GaussianDropout": _l_gaussiandropout,
    "SpatialDropout1D": _l_spatialdropout1d,
    "SpatialDropout2D": _l_spatialdropout2d,
    "SpatialDropout3D": _l_spatialdropout3d,
    "LocallyConnected1D": _l_locallyconnected1d,
    "LocallyConnected2D": _l_locallyconnected2d,
}


_MODERN_CLASS = {
    "Conv1D": "Convolution1D", "Conv2D": "Convolution2D",
    "Conv3D": "Convolution3D", "Conv2DTranspose": "Deconvolution2D",
    "SeparableConv2D": "SeparableConvolution2D",
}


def _as_list(v):
    return [v] if isinstance(v, (int, float)) else list(v)


def _modernize(class_name: str, cfg: Dict):
    """Accept keras 2.x/3.x (tf.keras / ``model.to_json()`` today) config
    keys alongside the keras-1.2 names the reference converter targets —
    translate the modern spelling into the 1.2 one this module dispatches
    on. Weight layouts are NOT translated (load_weights_hdf5 stays 1.2).
    Translation is COMPLETE for what it claims: anything it cannot express
    in 1.2 terms surfaces through the existing guards (per-class
    NotImplementedError at definition or weight-load time) rather than
    converting silently wrong. channels_last spellings map to
    dim_ordering="tf" and ride the transposed-weight pipeline.
    """
    cfg = dict(cfg)
    ren = {"units": "output_dim", "use_bias": "bias", "rate": "p",
           "batch_shape": "batch_input_shape",
           "recurrent_activation": "inner_activation",
           "negative_slope": "alpha"}
    for new, old in ren.items():
        if new in cfg and old not in cfg:
            cfg[old] = cfg.pop(new)
    # data_format appears on conv/pool/global-pool/upsampling/locally
    # classes in keras 2/3 — translate for ALL of them so the tf-ordering
    # guard actually fires instead of being bypassed
    if cfg.get("data_format") == "channels_last":
        cfg.setdefault("dim_ordering", "tf")
    elif cfg.get("data_format") == "channels_first":
        cfg.setdefault("dim_ordering", "th")
    if isinstance(cfg.get("axis"), (list, tuple)):  # tf.keras 2.x BN axis
        cfg["axis"] = int(cfg["axis"][0])
    if class_name in _MODERN_CLASS:
        dil = cfg.get("dilation_rate", 1)
        dil = _as_list(dil)
        if any(int(d) != 1 for d in dil):
            # keras-1.2 spells dilation as a separate Atrous class
            if class_name == "Conv1D":
                class_name, cfg["atrous_rate"] = "AtrousConvolution1D",                     int(dil[0])
            elif class_name == "Conv2D":
                class_name = "AtrousConvolution2D"
                cfg["atrous_rate"] = [int(d) for d in (dil * 2)[:2]]
            else:
                raise NotImplementedError(
                    f"keras converter: dilated {class_name} has no "
                    "keras-1.2 equivalent")
        if "filters" in cfg:
            cfg.setdefault("nb_filter", int(cfg["filters"]))
        ks = cfg.get("kernel_size")
        if ks is not None:
            ks = _as_list(ks)
            if class_name in ("Conv1D", "AtrousConvolution1D"):
                cfg.setdefault("filter_length", int(ks[0]))
            elif class_name == "Conv3D" and len(ks) >= 3:
                cfg.setdefault("kernel_dim1", int(ks[0]))
                cfg.setdefault("kernel_dim2", int(ks[1]))
                cfg.setdefault("kernel_dim3", int(ks[2]))
            elif len(ks) >= 2:
                cfg.setdefault("nb_row", int(ks[0]))
                cfg.setdefault("nb_col", int(ks[1]))
        if "strides" in cfg:
            st = _as_list(cfg["strides"])
            if class_name in ("Conv1D", "AtrousConvolution1D"):
                cfg.setdefault("subsample_length", int(st[0]))
            else:
                cfg.setdefault("subsample", st)
        if "padding" in cfg:
            cfg.setdefault("border_mode", cfg["padding"])
        class_name = _MODERN_CLASS.get(class_name, class_name)
    if class_name in ("MaxPooling2D", "AveragePooling2D", "MaxPooling3D",
                      "AveragePooling3D") and "padding" in cfg:
        cfg.setdefault("border_mode", cfg["padding"])
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        if "pool_size" in cfg and "pool_length" not in cfg:
            cfg["pool_length"] = int(_as_list(cfg["pool_size"])[0])
        if "strides" in cfg and "stride" not in cfg:
            st = cfg["strides"]
            cfg["stride"] = None if st is None else int(_as_list(st)[0])
        if "padding" in cfg:
            cfg.setdefault("border_mode", cfg["padding"])
    return class_name, cfg


def layer_from_config(class_name: str, config: Dict):
    """One Keras-1.2 layer config → a bigdl_tpu_torch.keras layer (unbuilt);
    modern (keras 2/3) config spellings accepted via _modernize."""
    return _layer_from_modern(*_modernize(class_name, config))


def _layer_from_modern(class_name: str, config: Dict):
    """layer_from_config for an ALREADY-modernized (class_name, config)."""
    if class_name == "TimeDistributed":
        inner = config["layer"]
        return L.TimeDistributed(layer_from_config(inner["class_name"],
                                                   inner["config"]))
    if class_name == "Bidirectional":
        inner = config["layer"]
        return L.Bidirectional(layer_from_config(inner["class_name"],
                                                 inner["config"]),
                               merge_mode=config.get("merge_mode", "concat"))
    fac = _FACTORIES.get(class_name)
    if fac is None:
        raise NotImplementedError(
            f"keras converter: layer class {class_name} unsupported")
    layer = fac(config)
    layer.name = config.get("name")
    return layer


def _input_shape_of(config: Dict,
                    class_name: str = "") -> Optional[Tuple[int, ...]]:
    bis = config.get("batch_input_shape")
    if bis:
        return tuple(int(d) for d in bis[1:])
    if class_name == "Embedding":
        # Embedding's input_dim is the vocab size, not the input shape;
        # the sequence length comes from input_length only
        if config.get("input_length"):
            return (int(config["input_length"]),)
        return None
    if config.get("input_length") and config.get("input_dim"):
        # legacy recurrent-layer spelling: input_shape=(T, features)
        return (int(config["input_length"]), int(config["input_dim"]))
    if config.get("input_dim"):
        return (int(config["input_dim"]),)
    return None


# ---------------------------------------------------------------------------
# definition loading
# ---------------------------------------------------------------------------


class _Record:
    """One converted layer: its keras identity + the built nn module."""

    def __init__(self, name, class_name, config, keras_layer):
        self.name = name
        self.class_name = class_name
        self.config = config
        self.keras_layer = keras_layer
        self.input_shape = None    # OUR shape of this layer's input
        self.parent_names = None   # functional-graph parents (else None)

    @property
    def module(self):
        return self.keras_layer.built_module


def _specs_tf_ordered(specs) -> bool:
    """True when any spatial layer in the definition is channels-last."""
    return any(_is_tf(_modernize(sp["class_name"], sp["config"])[1])
               for sp in specs)


def _maybe_nchw(shape, tf_ordered: bool):
    """tf-ordered spatial input → the channels-first shape this model is
    built with: (H, W, C) → (C, H, W), (D, H, W, C) → (C, D, H, W) (the
    converted model consumes channels-first arrays)."""
    if tf_ordered and shape is not None and len(shape) in (3, 4):
        return (shape[-1],) + tuple(shape[:-1])
    return shape


def _from_sequential(config, device=None) -> Tuple[Sequential,
                                                   List[_Record]]:
    layers = config["layers"] if isinstance(config, dict) else config
    model = Sequential(device=device)
    records = []
    pending_shape = None
    tf_ordered = _specs_tf_ordered(layers)
    for i, spec in enumerate(layers):
        cls, cfg = _modernize(spec["class_name"], spec["config"])
        if cls == "InputLayer":
            pending_shape = _input_shape_of(cfg, cls)
            continue
        if tf_ordered:
            cfg["_model_tf_ordered"] = True  # BN channel-axis detection
        layer = _layer_from_modern(cls, cfg)
        if not model.layers:
            shape = pending_shape or _input_shape_of(cfg, cls)
            if shape is None:
                raise ValueError("keras converter: first layer carries no "
                                 "batch_input_shape/input_dim")
            layer.input_shape = _maybe_nchw(shape, tf_ordered)
        in_shape = (layer.input_shape if not model.layers
                    else model.shapes[-1])
        model.add(layer)
        rec = _Record(cfg.get("name", f"layer_{i}"), cls, cfg, layer)
        rec.input_shape = in_shape  # ours (channels-first for tf models)
        records.append(rec)
    model._tf_ordered = tf_ordered
    return model, records


def _parent_names(node) -> List[str]:
    """Parent layer names from ONE inbound node, accepting both formats:
    keras-1.2 ``[["layer", 0, 0], ...]`` and keras 2/3
    ``{"args": [{"config": {"keras_history": ["layer", 0, 0]}}, ...]}``."""
    if isinstance(node, dict):  # keras 2/3
        out = []
        args = node.get("args", [])
        for a in (args[0] if args and isinstance(args[0], list) else args):
            if isinstance(a, dict):
                hist = a.get("config", {}).get("keras_history")
                if hist:
                    out.append(hist[0])
        return out
    return [ref[0] for ref in node]


def _from_model(config, device=None) -> Tuple[Model, List[_Record]]:
    nodes: Dict[str, KerasNode] = {}
    records = []
    tf_ordered = _specs_tf_ordered(config["layers"])
    for spec in config["layers"]:
        cls, cfg = _modernize(spec["class_name"], spec["config"])
        name = spec.get("name", cfg.get("name"))
        inbound = spec.get("inbound_nodes", [])
        if cls == "InputLayer":
            shape = _maybe_nchw(_input_shape_of(cfg), tf_ordered)
            nodes[name] = Input(shape, name=name)
            continue
        if len(inbound) != 1:
            raise NotImplementedError(
                f"keras converter: layer {name} applied {len(inbound)} "
                "times — shared layers are unsupported")
        parent_names = _parent_names(inbound[0])
        parents = [nodes[pn] for pn in parent_names]
        if tf_ordered:
            cfg["_model_tf_ordered"] = True  # BN channel-axis detection
        layer = _layer_from_modern(cls, cfg)
        layer.name = name
        if isinstance(layer, L.Merge):
            nodes[name] = layer(parents)
        else:
            if len(parents) != 1:
                raise NotImplementedError(
                    f"keras converter: non-Merge layer {name} has "
                    f"{len(parents)} inputs")
            nodes[name] = layer(parents[0])
        rec = _Record(name, cls, cfg, layer)
        rec.input_shape = parents[0].shape if len(parents) == 1 else None
        rec.parent_names = parent_names
        records.append(rec)
    def refs(entry):
        # keras-1.2: [["name", 0, 0], ...]; keras 2/3 collapses a single
        # ref to a flat ["name", 0, 0]
        if entry and isinstance(entry[0], str):
            return [entry[0]]
        return [ref[0] for ref in entry]

    ins = [nodes[n] for n in refs(config["input_layers"])]
    outs = [nodes[n] for n in refs(config["output_layers"])]
    model = Model(ins, outs, device=device)
    model._tf_ordered = tf_ordered
    return model, records


def model_from_json(json_def, device=None):
    """DefinitionLoader parity: Keras-1.2 ``model.to_json()`` → model.

    Returns a :class:`bigdl_tpu_torch.keras.Sequential` or ``Model`` on
    ``device``; the converted records ride on ``model.converted_records``
    for weight loading.
    """
    spec = json.loads(json_def) if isinstance(json_def, str) else json_def
    cls = spec["class_name"]
    if cls == "Functional":  # keras 2/3 name for the graph Model
        cls = "Model"
    if cls == "Sequential":
        model, records = _from_sequential(spec["config"], device)
    elif cls in ("Model", "Graph"):
        model, records = _from_model(spec["config"], device)
    else:
        raise ValueError(f"keras converter: unknown model class {cls}")
    model.converted_records = records
    return model


# ---------------------------------------------------------------------------
# weight conversion (keras get_weights order → our param trees)
# ---------------------------------------------------------------------------


# layer classes that carry no weights in keras 1.2 — everything else is
# expected to have a _convert branch; a weighted class without one raises at
# load time instead of silently keeping random init
_WEIGHTLESS = {
    "Activation", "Dropout", "Flatten", "Reshape", "Permute", "RepeatVector",
    "Merge", "Masking", "GaussianNoise", "GaussianDropout",
    "SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D",
    "MaxPooling1D", "MaxPooling2D", "MaxPooling3D",
    "AveragePooling1D", "AveragePooling2D", "AveragePooling3D",
    "GlobalMaxPooling1D", "GlobalMaxPooling2D", "GlobalMaxPooling3D",
    "GlobalAveragePooling1D", "GlobalAveragePooling2D",
    "GlobalAveragePooling3D",
    "ZeroPadding1D", "ZeroPadding2D", "ZeroPadding3D",
    "Cropping1D", "Cropping2D", "Cropping3D",
    "UpSampling1D", "UpSampling2D", "UpSampling3D",
    "LeakyReLU", "ELU", "ThresholdedReLU", "SoftMax", "InputLayer",
}


def _iter_paths(module, prefix=()):
    """(path, module) of ``module`` and its descendants, depth first, the
    path the keys of its params tree (a container's children by index, a
    Recurrent's cell under ``cell``)."""
    yield prefix, module
    for name, ch in module._modules.items():
        if ch is not None:
            yield from _iter_paths(ch, prefix + (name,))


def _find(module, cls):
    for rel, m in _iter_paths(module):
        if isinstance(m, cls):
            return rel, m
    raise KeyError(f"no {cls} inside {type(module).__name__}")


def _lstm_gates(ws, order):
    """Per-gate keras blocks → our packed (i, f, g, o) layout."""
    W = np.concatenate([ws[3 * i] for i in order], axis=1)
    U = np.concatenate([ws[3 * i + 1] for i in order], axis=1)
    b = np.concatenate([ws[3 * i + 2] for i in order], axis=0)
    return W, U, b


def _convert(record: _Record, ws: List[np.ndarray]):
    """→ list of (target nn class, param updates, state updates)."""
    cls = record.class_name
    cfg = record.config
    if cls in ("TimeDistributed", "Bidirectional"):
        raise NotImplementedError(
            f"keras converter: weights for {cls} wrapper unsupported")
    if cls == "Dense":
        p = {"weight": ws[0].T}
        if len(ws) > 1:
            p["bias"] = ws[1]
        return [(N.Linear, p, {})]
    if cls == "Convolution2D":
        # th stores (out, in, kh, kw) — our layout; tf (incl. every modern
        # tf.keras export) stores (kh, kw, in, out)
        w = ws[0]
        if _is_tf(cfg):
            w = w.transpose(3, 2, 0, 1)
        p = {"weight": w}
        if len(ws) > 1:
            p["bias"] = ws[1]
        return [(N.SpatialConvolution, p, {})]
    if cls == "Convolution1D":
        # keras 1.2 stores (filter_length, 1, input_dim, nb_filter)
        w = ws[0]
        if w.ndim == 4:
            w = w[:, 0]
        p = {"weight": w.transpose(2, 1, 0)}
        if len(ws) > 1:
            p["bias"] = ws[1]
        return [(N.TemporalConvolution, p, {})]
    if cls == "Convolution3D":
        w = ws[0]
        if _is_tf(cfg):  # (kd, kh, kw, in, out) → (out, in, kd, kh, kw)
            w = w.transpose(4, 3, 0, 1, 2)
        p = {"weight": w}
        if len(ws) > 1:
            p["bias"] = ws[1]
        return [(N.VolumetricConvolution, p, {})]
    if cls == "AtrousConvolution2D":
        w = ws[0]
        if _is_tf(cfg):
            w = w.transpose(3, 2, 0, 1)
        p = {"weight": w}
        if len(ws) > 1:
            p["bias"] = ws[1]
        return [(N.SpatialDilatedConvolution, p, {})]
    if cls == "AtrousConvolution1D":
        # keras (filter_length, 1, in, out) → the (out, in, filter_length, 1)
        # dilated spatial conv the layer builds
        w = ws[0]
        if w.ndim == 4:
            w = w.transpose(3, 2, 0, 1)
        p = {"weight": w}
        if len(ws) > 1:
            p["bias"] = ws[1]
        return [(N.SpatialDilatedConvolution, p, {})]
    if cls == "Embedding":
        return [(N.LookupTable, {"weight": ws[0]}, {})]
    if cls == "BatchNormalization":
        p = {"weight": ws[0], "bias": ws[1]}
        st = {"running_mean": ws[2], "running_var": ws[3]}
        return [((N.SpatialBatchNormalization, N.BatchNormalization), p, st)]
    if cls == "LSTM":
        if len(ws) == 3:
            # consume_less='gpu': concatenated (i, f, c, o) — our layout
            return [(N.LSTM, {"w_i": ws[0], "w_h": ws[1], "bias": ws[2]},
                     {})]
        # consume_less='cpu'/'mem': (i, c, f, o) per-gate triples; ours
        # packs (i, f, g, o)
        W, U, b = _lstm_gates(ws, (0, 2, 1, 3))
        return [(N.LSTM, {"w_i": W, "w_h": U, "bias": b}, {})]
    if cls == "GRU":
        if len(ws) == 3:
            # concatenated (z, r, h) blocks → split and repack
            H = ws[0].shape[1] // 3
            Wz, Wr, Wh = (ws[0][:, i * H:(i + 1) * H] for i in range(3))
            Uz, Ur, Uh = (ws[1][:, i * H:(i + 1) * H] for i in range(3))
            bz, br, bh = (ws[2][i * H:(i + 1) * H] for i in range(3))
            ws = [Wz, Uz, bz, Wr, Ur, br, Wh, Uh, bh]
        # keras 1.2 order: (z, r, h) triples; ours packs w_i/b as (r, z, n),
        # w_h as (r, z), w_hn = U_h
        W = np.concatenate([ws[3], ws[0], ws[6]], axis=1)
        b = np.concatenate([ws[5], ws[2], ws[8]], axis=0)
        U = np.concatenate([ws[4], ws[1]], axis=1)
        return [(N.GRU, {"w_i": W, "w_h": U, "w_hn": ws[7], "bias": b}, {})]
    if cls == "SimpleRNN":
        return [(N.RnnCell, {"w_i": ws[0], "w_h": ws[1], "bias": ws[2]}, {})]
    if cls == "Highway":
        # keras 1.2: [W, W_carry, b, b_carry]; ours applies x @ w.T
        p = {"w_h": ws[0].T, "w_t": ws[1].T}
        if len(ws) > 2:
            p["b_h"], p["b_t"] = ws[2], ws[3]
        return [(N.Highway, p, {})]
    if cls == "PReLU":
        a = np.asarray(ws[0]).reshape(-1)
        if not np.allclose(a, a.flat[0]):
            raise NotImplementedError("keras converter: per-element PReLU "
                                      "alphas unsupported (shared only)")
        return [(N.PReLU, {"weight": a[:1]}, {})]
    raise NotImplementedError(
        f"keras converter: weights for {cls} unsupported")


def _assign(tree, path, updates):
    """Write each array of ``updates`` into the live tensor of the same
    name in ``tree`` (a module's params or state, the tensors themselves),
    as a tensor of that leaf's dtype on its device."""
    node = tree
    for k in path:
        node = node[k]
    for k, v in updates.items():
        if k not in node:
            raise KeyError(f"param {k} missing at {'/'.join(path)}")
        cur = node[k]
        v = np.asarray(v)
        if tuple(cur.shape) != v.shape:
            raise ValueError(f"shape mismatch at {'/'.join(path)}/{k}: "
                             f"model {tuple(cur.shape)} vs weights "
                             f"{v.shape}")
        with torch.no_grad():
            cur.copy_(torch.as_tensor(np.ascontiguousarray(v)).to(
                device=cur.device, dtype=cur.dtype))


# records whose presence between Flatten and Dense does not disturb the
# flatten element order
_ORDER_PRESERVING = {"Activation", "Dropout", "Masking", "GaussianNoise",
                     "GaussianDropout", "LeakyReLU", "ELU",
                     "ThresholdedReLU", "SoftMax"}
# order-preserving but carrying PER-FEATURE parameters: a Flatten behind
# one of these would need the same h,w,c→c,h,w permutation applied to its
# weights — unimplemented, must be refused loudly, never converted wrong
_ORDER_PRESERVING_WITH_PARAMS = {"BatchNormalization", "PReLU", "SReLU"}


def _flatten_shape_before(records, dense_record):
    """If ``dense_record``'s input is (possibly through order-preserving
    layers) the output of a Flatten, return that Flatten's input shape
    (OUR channels-first shape) — the tf→th row permutation needs it.
    Raises NotImplementedError when a per-feature-parameter layer sits
    between a (3-D) Flatten and the Dense: its weights would need the same
    permutation, which is unimplemented — silent mis-conversion is the one
    unacceptable outcome."""

    def walk(next_fn, start):
        blocker = None
        r = next_fn(start)
        while r is not None:
            if r.class_name == "Flatten":
                if blocker is not None and r.input_shape is not None \
                        and len(r.input_shape) == 3:
                    raise NotImplementedError(
                        f"keras converter: tf-ordered Flatten→"
                        f"{blocker}→Dense — the {blocker} layer's "
                        "per-feature weights would need the flatten-order "
                        "permutation too; re-export channels-first")
                return None if blocker else r.input_shape
            if r.class_name in _ORDER_PRESERVING_WITH_PARAMS:
                blocker = blocker or r.class_name
            elif r.class_name not in _ORDER_PRESERVING:
                return None  # feature order re-mixed by a weighted op
            r = next_fn(r)
        return None

    if dense_record.parent_names is not None:  # functional graph
        by_name = {r.name: r for r in records}

        def parent(r):
            names = r.parent_names or []
            return by_name.get(names[0]) if len(names) == 1 else None
        return walk(parent, dense_record)
    try:  # sequential: walk backwards
        i = records.index(dense_record)
    except ValueError:
        return None
    seq = records[:i][::-1] + [None]

    def prev(r):
        if r is dense_record:
            return seq[0] if seq else None
        j = seq.index(r)
        return seq[j + 1]
    return walk(prev, dense_record)


def load_weights(model, weights: Dict[str, List[np.ndarray]],
                 by_name=False, strict=True) -> None:
    """Apply a {layer_name: [arrays]} weight dict to a converted model.

    ``by_name=False`` (keras default) matches weighted layers in definition
    order; ``by_name=True`` matches on layer names only. ``strict=True``
    refuses models containing a weighted layer this converter cannot load
    (rather than leaving it randomly initialized); ``strict=False`` loads
    what it can and warns loudly about the layers it skipped.
    """
    records = getattr(model, "converted_records", None)
    if records is None:
        raise ValueError("model was not produced by model_from_json")
    root = model._module()
    root.ensure_initialized()
    path_of = {}
    for path, m in _iter_paths(root):
        path_of.setdefault(id(m), path)
    params, state = root.params, root.state

    expecting = []
    unsupported = []
    for r in records:
        if r.class_name in _WEIGHTLESS:
            continue
        try:
            _convert(r, None)  # probe: unsupported classes raise fast
        except NotImplementedError as e:
            if strict:
                # a weighted layer we cannot load — refuse rather than
                # leave it randomly initialized (silent wrong outputs)
                raise NotImplementedError(
                    f"layer {r.name}: {e}. Pass strict=False to load the "
                    "rest, or set weights manually via "
                    "model.converted_records") from None
            unsupported.append(r.name)
        except Exception:
            expecting.append(r)
    if unsupported:
        warnings.warn(
            "keras converter: weights NOT loaded for layers "
            f"{unsupported} (unsupported classes) — they keep random "
            "init")
    if by_name:
        pairs = [(r, weights[r.name]) for r in expecting if r.name in weights]
    else:
        named = [(n, w) for n, w in weights.items() if w]
        if len(named) != len(expecting):
            warnings.warn(
                f"keras converter: {len(named)} weighted layers in file vs "
                f"{len(expecting)} in model; matching by name instead")
            pairs = [(r, weights[r.name]) for r in expecting
                     if r.name in weights]
        else:
            pairs = list(zip(expecting, (w for _, w in named)))

    tf_ordered = getattr(model, "_tf_ordered", False)
    for record, ws in pairs:
        ws = [np.asarray(w) for w in ws]
        if tf_ordered and record.class_name == "Dense":
            fshape = _flatten_shape_before(records, record)
            if fshape is not None and len(fshape) == 3:
                # keras flattened (h, w, c); this model flattens (c, h, w):
                # permute the Dense kernel's input rows accordingly
                C, H, W = fshape
                perm = np.arange(C * H * W).reshape(H, W, C) \
                         .transpose(2, 0, 1).ravel()
                ws[0] = ws[0][perm]
        for target_cls, p_up, s_up in _convert(record, ws):
            built = record.module
            rel, _ = _find(built, target_cls)
            base = path_of[id(built)]
            if p_up:
                _assign(params, base + rel, p_up)
            if s_up:
                _assign(state, base + rel, s_up)


def _read_hdf5_weights(path: str) -> Dict[str, List[np.ndarray]]:
    import h5py
    out: Dict[str, List[np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        names = [n.decode() if isinstance(n, bytes) else n
                 for n in g.attrs["layer_names"]]
        for ln in names:
            grp = g[ln]
            wn = [n.decode() if isinstance(n, bytes) else n
                  for n in grp.attrs.get("weight_names", [])]
            out[ln] = [np.asarray(grp[n]) for n in wn]
    return out


def load_weights_hdf5(model, hdf5_path: str, by_name=False,
                      strict=True) -> None:
    """WeightLoader.load_weights_from_hdf5 parity (local files via h5py,
    imported here)."""
    load_weights(model, _read_hdf5_weights(hdf5_path), by_name=by_name,
                 strict=strict)


def _compile_from_training_config(model, tc) -> None:
    """Keras 1.2 ``training_config`` attr → model.compile(...).

    Parity: reference ``pyspark/bigdl/keras/optimization.py`` (OptimConverter
    maps keras optimizers/losses to bigdl ones).
    """
    from ..optim import SGD, Adam, Adagrad, Adadelta, Adamax, RMSprop
    cfg = json.loads(tc) if isinstance(tc, str) else tc
    opt = cfg.get("optimizer", {})
    cls = opt.get("class_name", "SGD")
    oc = opt.get("config", {})
    lr = float(oc.get("lr", 0.01))
    decay = float(oc.get("decay", 0.0))
    builders = {
        "sgd": lambda: SGD(learningrate=lr, learningrate_decay=decay,
                           momentum=float(oc.get("momentum", 0.0)),
                           nesterov=bool(oc.get("nesterov", False))),
        "adam": lambda: Adam(learningrate=lr, learningrate_decay=decay,
                             beta1=float(oc.get("beta_1", 0.9)),
                             beta2=float(oc.get("beta_2", 0.999)),
                             epsilon=float(oc.get("epsilon", 1e-8))),
        "rmsprop": lambda: RMSprop(learningrate=lr,
                                   learningrate_decay=decay,
                                   decayrate=float(oc.get("rho", 0.9)),
                                   epsilon=float(oc.get("epsilon", 1e-8))),
        "adagrad": lambda: Adagrad(learningrate=lr,
                                   learningrate_decay=decay),
        "adadelta": lambda: Adadelta(
            decayrate=float(oc.get("rho", 0.95)),
            epsilon=float(oc.get("epsilon", 1e-8))),
        "adamax": lambda: Adamax(learningrate=lr,
                                 beta1=float(oc.get("beta_1", 0.9)),
                                 beta2=float(oc.get("beta_2", 0.999))),
    }
    builder = builders.get(cls.lower())
    if builder is None:
        warnings.warn(f"keras converter: optimizer {cls} unsupported; "
                      "model left uncompiled")
        return
    loss = cfg.get("loss", "categorical_crossentropy")
    from .topology import _LOSSES
    # validate BEFORE compile: a failed compile must not leave the model
    # half-mutated (optimizer set, loss missing)
    if not isinstance(loss, str) or loss.lower() not in _LOSSES:
        warnings.warn(f"keras converter: loss {loss!r} has no mapping; "
                      "model left uncompiled")
        return
    metrics = []
    for m in cfg.get("metrics") or []:
        if m in ("accuracy", "acc"):
            metrics.append(m)
        else:
            warnings.warn(f"keras converter: metric {m!r} unsupported — "
                          "dropped (reference OptimConverter rejects it "
                          "too)")
    model.compile(optimizer=builder(), loss=loss, metrics=metrics or None)


def load_keras(json_path: Optional[str] = None,
               hdf5_path: Optional[str] = None, device=None):
    """One-call loader: JSON definition (+ optional HDF5 weights) → model
    on ``device``.

    ``load_keras(json_path=...)`` — definition only;
    ``load_keras(json_path=..., hdf5_path=...)`` — definition + weights;
    ``load_keras(hdf5_path=...)`` — full-model HDF5 (``model_config`` attr).
    """
    def _dec(v):
        return v.decode() if isinstance(v, bytes) else v

    mc = tc = weights = None
    if hdf5_path is not None:
        import h5py
        with h5py.File(hdf5_path, "r") as f:  # one open for everything
            mc = _dec(f.attrs.get("model_config"))
            tc = _dec(f.attrs.get("training_config"))
            g = f["model_weights"] if "model_weights" in f else f
            weights = {}
            for ln in (n.decode() if isinstance(n, bytes) else n
                       for n in g.attrs["layer_names"]):
                grp = g[ln]
                wn = [n.decode() if isinstance(n, bytes) else n
                      for n in grp.attrs.get("weight_names", [])]
                weights[ln] = [np.asarray(grp[n]) for n in wn]

    if json_path is not None:
        with open(json_path) as f:
            model = model_from_json(f.read(), device=device)
    elif mc is not None:
        model = model_from_json(mc, device=device)
    else:
        raise ValueError("hdf5 has no model_config; pass json_path"
                         if hdf5_path else "need json_path or hdf5_path")
    if weights is not None:
        load_weights(model, weights)
        if tc is not None:
            _compile_from_training_config(model, tc)
    return model
