"""Caffe model export (counterpart of
``bigdl_tpu/loaders/caffe_persister.py``; parity: reference ``utils/caffe/CaffePersister.scala``).

Mirror image of ``loaders.caffe.load_caffe``: writes a deploy ``.prototxt``
(protobuf text format) plus a ``.caffemodel`` (protobuf wire format,
LayerParameter field 100 with BlobProto blobs) — no caffe/protoc dependency.

Layout notes:
  * conv weights are (out, in/g, kh, kw) in both frameworks → direct dump;
  * caffe's InnerProduct flattens NCHW implicitly, same order as our
    View/Reshape-then-Linear, so Linear weights dump directly too;
  * BatchNormalization splits into caffe's BatchNorm (moving stats,
    scale_factor=1) + Scale (gamma/beta) pair — the same pair ``load_caffe``
    converts back, so round trips are numerically exact;
  * SAME pads (-1) are emitted as explicit (k-1)/2 pads (odd kernels).

Supported set mirrors the loader: Sequential composition, Concat (→ Concat
layer), ConcatTable + CAddTable/CMulTable/CMaxTable (→ Eltwise), conv /
linear / pooling / ReLU / Tanh / Sigmoid / Softmax / LogSoftmax / LRN /
Dropout / BN.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import nn as N
from ._walk import children, conv_geometry, has_bias, host
from .wire import field_bytes, field_string, field_varint, field_packed_float


# ---------------------------------------------------------------------------
# caffemodel wire emission
# ---------------------------------------------------------------------------


def _blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    shape = b"".join(field_varint(1, int(d)) for d in arr.shape)
    body = field_bytes(7, shape)                    # BlobProto.shape
    body += field_packed_float(5, arr.reshape(-1))  # BlobProto.data
    return body


def _layer_param(name: str, blobs: List[np.ndarray]) -> bytes:
    body = field_string(1, name)
    for b in blobs:
        body += field_bytes(7, _blob(b))
    return field_bytes(100, body)  # NetParameter.layer


# ---------------------------------------------------------------------------
# prototxt emission
# ---------------------------------------------------------------------------


def _fmt_param(d: Dict) -> str:
    parts = []
    for k, v in d.items():
        if isinstance(v, bool):
            parts.append(f"{k}: {'true' if v else 'false'}")
        elif isinstance(v, str):
            parts.append(f'{k}: "{v}"')
        else:
            parts.append(f"{k}: {v}")
    return " ".join(parts)


class _Net:
    def __init__(self):
        self.layers: List[str] = []
        self.blobs: List[Tuple[str, List[np.ndarray]]] = []
        self.counter = 0

    def fresh(self, base: str) -> str:
        self.counter += 1
        return f"{base}_{self.counter}"

    def layer(self, name, typ, bottoms, top, params: Optional[Dict] = None,
              param_key: Optional[str] = None, blobs=None):
        lines = [f'  name: "{name}"', f'  type: "{typ}"']
        for b in bottoms:
            lines.append(f'  bottom: "{b}"')
        lines.append(f'  top: "{top}"')
        if params:
            lines.append(f"  {param_key} {{ {_fmt_param(params)} }}")
        self.layers.append("layer {\n" + "\n".join(lines) + "\n}")
        if blobs:
            self.blobs.append((name, blobs))
        return top


def _sym_pad(pad: int, k: int) -> int:
    if pad == -1:  # SAME
        if k % 2 == 0:
            raise NotImplementedError(
                "caffe export: SAME pad with even kernel has no caffe analog")
        return (k - 1) // 2
    return pad


def _emit(m, bottom: str, net: _Net) -> str:
    name = m.name

    if isinstance(m, N.Sequential):
        cur = bottom
        pending = None
        for child in children(m):
            if pending is not None:
                cur = _emit_eltwise(child, pending, net)
                pending = None
                continue
            if isinstance(child, N.ConcatTable):
                pending = [_emit(c, cur, net) for c in children(child)]
                continue
            cur = _emit(child, cur, net)
        if pending is not None:
            raise NotImplementedError("dangling ConcatTable in caffe export")
        return cur

    if isinstance(m, N.Concat):
        assert m.dimension == 2, "caffe Concat exports channel concat only"
        tops = [_emit(c, bottom, net) for c in children(m)]
        return net.layer(name, "Concat", tops, name)

    if isinstance(m, (N.Identity,)):
        return bottom

    if isinstance(m, N.Dropout):
        return net.layer(name, "Dropout", [bottom], name,
                         {"dropout_ratio": float(m.p)}, "dropout_param")

    if isinstance(m, N.SpatialConvolution):
        (kh, kw), (sh, sw), (pad_h, pad_w) = conv_geometry(m)
        ph = _sym_pad(pad_h, kh)
        pw = _sym_pad(pad_w, kw)
        p = {"num_output": m.n_output_plane,
             "kernel_h": kh, "kernel_w": kw,
             "stride_h": sh, "stride_w": sw,
             "pad_h": ph, "pad_w": pw,
             "group": m.n_group, "bias_term": has_bias(m)}
        blobs = [host(m.weight)]
        if has_bias(m):
            blobs.append(host(m.bias).reshape(-1))
        return net.layer(name, "Convolution", [bottom], name, p,
                         "convolution_param", blobs)

    if isinstance(m, N.Linear):
        blobs = [host(m.weight)]
        if has_bias(m):
            blobs.append(host(m.bias).reshape(-1))
        return net.layer(name, "InnerProduct", [bottom], name,
                         {"num_output": m.output_size, "bias_term":
                          has_bias(m)}, "inner_product_param", blobs)

    if isinstance(m, (N.Reshape, N.View)) or type(m).__name__ == \
            "InferReshape":
        # caffe InnerProduct flattens implicitly (same NCHW order as ours):
        # flatten layers need no caffe node
        return bottom

    if isinstance(m, N.SpatialMaxPooling):
        p = {"pool": "MAX", "kernel_h": m.kh, "kernel_w": m.kw,
             "stride_h": m.dh, "stride_w": m.dw,
             "pad_h": _sym_pad(m.pad_h, m.kh), "pad_w": _sym_pad(m.pad_w,
                                                                 m.kw)}
        return net.layer(name, "Pooling", [bottom], name, p, "pooling_param")

    if isinstance(m, N.SpatialAveragePooling):
        p = {"pool": "AVE"}
        if getattr(m, "global_pooling", False):
            p["global_pooling"] = True
            p["kernel_size"] = 1
        else:
            p.update({"kernel_h": m.kh, "kernel_w": m.kw,
                      "stride_h": m.dh, "stride_w": m.dw,
                      "pad_h": _sym_pad(m.pad_h, m.kh),
                      "pad_w": _sym_pad(m.pad_w, m.kw)})
        return net.layer(name, "Pooling", [bottom], name, p, "pooling_param")

    simple = {N.ReLU: "ReLU", N.Sigmoid: "Sigmoid", N.Tanh: "TanH",
              N.SoftMax: "Softmax", N.LogSoftMax: "LogSoftmax"}
    for cls, typ in simple.items():
        if type(m) is cls:
            return net.layer(name, typ, [bottom], name)

    if isinstance(m, N.SpatialCrossMapLRN):
        p = {"local_size": m.size, "alpha": float(m.alpha),
             "beta": float(m.beta), "k": float(m.k)}
        return net.layer(name, "LRN", [bottom], name, p, "lrn_param")

    if isinstance(m, N.SpatialBatchNormalization):
        mean = host(m.running_mean).astype(np.float32)
        var = host(m.running_var).astype(np.float32)
        bn_top = net.layer(name, "BatchNorm", [bottom], name,
                           {"use_global_stats": True, "eps": float(m.eps)},
                           "batch_norm_param",
                           [mean, var, np.asarray([1.0], np.float32)])
        if m.weight is not None:
            gamma = host(m.weight).astype(np.float32)
            beta = host(m.bias).astype(np.float32)
            sname = name + "_scale"
            return net.layer(sname, "Scale", [bn_top], sname,
                             {"bias_term": True}, "scale_param",
                             [gamma, beta])
        return bn_top

    raise NotImplementedError(
        f"caffe export: module {type(m).__name__} ({name}) unsupported")


def _emit_eltwise(m, bottoms: List[str], net: _Net) -> str:
    name = m.name
    if isinstance(m, N.CAddTable):
        op = "SUM"
    elif isinstance(m, N.CMulTable):
        op = "PROD"
    elif isinstance(m, N.CMaxTable):
        op = "MAX"
    else:
        raise NotImplementedError(
            f"caffe export: table consumer {type(m).__name__} unsupported")
    return net.layer(name, "Eltwise", bottoms, name, {"operation": op},
                     "eltwise_param")


def save_caffe(model, prototxt_path: str, caffemodel_path: str,
               input_shape=(3, 224, 224)) -> None:
    """CaffePersister parity: write deploy prototxt + caffemodel.

    ``input_shape``: NCHW input shape without batch. Round trip:
    ``load_caffe(prototxt, caffemodel)`` reproduces the model's outputs.
    """
    model.evaluate()
    net = _Net()
    top = _emit(model, "data", net)

    c, h, w = input_shape
    header = "\n".join([
        'name: "bigdl_tpu_export"',
        'input: "data"',
        "input_dim: 1",
        f"input_dim: {c}",
        f"input_dim: {h}",
        f"input_dim: {w}",
    ])
    with open(prototxt_path, "w") as f:
        f.write(header + "\n" + "\n".join(net.layers) + "\n")

    body = field_string(1, "bigdl_tpu_export")
    for lname, blobs in net.blobs:
        body += _layer_param(lname, blobs)
    with open(caffemodel_path, "wb") as f:
        f.write(body)


__all__ = ["save_caffe"]
