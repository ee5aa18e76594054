"""Caffe model loader (counterpart of ``bigdl_tpu/loaders/caffe.py``).

Parity: reference ``utils/caffe/CaffeLoader.scala`` + ``Converter.scala``
(Module.loadCaffeModel(prototxt, caffemodel)). No protoc dependency:

* prototxt: hand-written parser for the protobuf *text* format subset Caffe
  uses (nested ``name { ... }`` blocks, ``key: value`` scalars);
* caffemodel: minimal protobuf *wire-format* decoder extracting
  LayerParameter name/type/blobs (field numbers from caffe.proto: NetParameter
  ``layer = 100`` / ``layers = 2(V1)``, LayerParameter ``name=1, type=2,
  blobs=7``; V1LayerParameter ``name=1, type=2(enum), blobs=6``; BlobProto
  ``shape=7, data=5(packed float), num/channels/height/width=1-4``).

Supported layer types cover the Inception-v1 / VGG / ResNet class of nets:
Convolution, InnerProduct, Pooling, ReLU, LRN, Concat, Dropout, Softmax,
BatchNorm, Scale, Eltwise, Input/Data.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

import torch

from .. import nn as N
from ..utils import engine
from ._walk import assign
from .wire import read_varint as _read_varint, iter_fields as _iter_fields


# ---------------------------------------------------------------------------
# prototxt (text format) parser
# ---------------------------------------------------------------------------
_TOKEN = re.compile(r"[\w.+-]+|\"[^\"]*\"|'[^']*'|[{}:]")


def parse_prototxt(text: str) -> Dict:
    """Parse protobuf text format into nested dicts; repeated fields become
    lists."""
    toks = _TOKEN.findall(re.sub(r"#.*", "", text))
    pos = [0]

    def parse_block():
        out: Dict = {}
        while pos[0] < len(toks):
            t = toks[pos[0]]
            if t == "}":
                pos[0] += 1
                return out
            key = t
            pos[0] += 1
            nxt = toks[pos[0]]
            if nxt == ":":
                pos[0] += 1
                val = toks[pos[0]]
                pos[0] += 1
                if val.startswith(('"', "'")):
                    val = val[1:-1]
                else:
                    try:
                        val = int(val)
                    except ValueError:
                        try:
                            val = float(val)
                        except ValueError:
                            if val in ("true", "false"):
                                val = val == "true"
            elif nxt == "{":
                pos[0] += 1
                val = parse_block()
            else:
                raise ValueError(f"unexpected token {nxt} after {key}")
            if key in out:
                if not isinstance(out[key], list):
                    out[key] = [out[key]]
                out[key].append(val)
            else:
                out[key] = val
        return out

    return parse_block()


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# ---------------------------------------------------------------------------
# caffemodel (binary wire format) decoder — primitives in loaders/wire.py
# ---------------------------------------------------------------------------


def _decode_blob(buf) -> np.ndarray:
    shape = []
    dims_legacy = {}
    data = None
    for field, wire, val in _iter_fields(buf):
        if field == 7 and wire == 2:  # BlobShape
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        j = 0
                        while j < len(v2):
                            d, j = _read_varint(v2, j)
                            shape.append(d)
                    else:
                        shape.append(v2)
        elif field in (1, 2, 3, 4) and wire == 0:  # num/channels/h/w
            dims_legacy[field] = val
        elif field == 5 and wire == 2:  # packed float data
            data = np.frombuffer(val, dtype="<f4")
        elif field == 5 and wire == 5:  # unpacked single float
            data = np.concatenate([data if data is not None else
                                   np.empty(0, np.float32),
                                   np.frombuffer(val, dtype="<f4")])
        elif field == 8 and wire == 2:  # double data
            data = np.frombuffer(val, dtype="<f8").astype(np.float32)
    if not shape and dims_legacy:
        shape = [dims_legacy.get(k, 1) for k in (1, 2, 3, 4)]
    if data is None:
        data = np.empty(0, np.float32)
    if shape and int(np.prod(shape)) == data.size:
        data = data.reshape(shape)
    return data


_V1_TYPE_NAMES = {
    4: "Convolution", 14: "InnerProduct", 17: "Pooling", 18: "ReLU",
    15: "LRN", 3: "Concat", 6: "Dropout", 20: "Softmax", 21: "SoftmaxWithLoss",
    5: "Data", 33: "Eltwise", 19: "Sigmoid", 23: "Tanh",
}


def read_caffemodel_blobs(path: str) -> Dict[str, List[np.ndarray]]:
    """Return {layer_name: [blob arrays]} from a .caffemodel file."""
    with open(path, "rb") as f:
        buf = f.read()
    out: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in _iter_fields(buf):
        if field == 100 and wire == 2:  # LayerParameter (V2)
            name, blobs = "", []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    name = v2.decode("utf-8", "replace")
                elif f2 == 7:
                    blobs.append(_decode_blob(v2))
            if blobs:
                out[name] = blobs
        elif field == 2 and wire == 2:  # V1LayerParameter
            name, blobs = "", []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    name = v2.decode("utf-8", "replace")
                elif f2 == 6:
                    blobs.append(_decode_blob(v2))
            if blobs:
                out[name] = blobs
    return out


# ---------------------------------------------------------------------------
# layer conversion (prototxt → bigdl_tpu modules)
# ---------------------------------------------------------------------------
def _kernel_params(p):
    k = p.get("kernel_size", p.get("kernel_h", 1))
    kh = int(p.get("kernel_h", k))
    kw = int(p.get("kernel_w", k))
    s = p.get("stride", 1)
    sh = int(p.get("stride_h", s))
    sw = int(p.get("stride_w", s))
    pad = p.get("pad", 0)
    ph = int(p.get("pad_h", pad))
    pw = int(p.get("pad_w", pad))
    return kh, kw, sh, sw, ph, pw


def _convert_layer(layer: Dict, in_channels: Optional[int]):
    """Return (module or None, out_channels or None)."""
    typ = layer.get("type")
    if isinstance(typ, int):
        typ = _V1_TYPE_NAMES.get(typ, str(typ))
    name = layer.get("name", typ)
    if typ in ("Data", "Input", "HDF5Data", "ImageData", "Accuracy",
               "Silence", None):
        return None, in_channels
    if typ == "Convolution":
        p = layer.get("convolution_param", {})
        nout = int(p["num_output"])
        kh, kw, sh, sw, ph, pw = _kernel_params(p)
        group = int(p.get("group", 1))
        bias = bool(p.get("bias_term", True))
        m = N.SpatialConvolution(in_channels, nout, kw, kh, sw, sh, pw, ph,
                                 n_group=group, with_bias=bias)
        m.set_name(name)
        return m, nout
    if typ == "InnerProduct":
        # caffe flattens implicitly; channel tracking assumes 1x1 spatial at
        # this point (true after global pooling, e.g. Inception/ResNet deploy
        # nets). Full spatial-shape propagation is the r2 item (SURVEY §2.8).
        p = layer.get("inner_product_param", {})
        nout = int(p["num_output"])
        m = N.Sequential(N.InferReshape([0, -1], batch_mode=False),
                         N.Linear(in_channels, nout))
        m.set_name(name)
        return m, nout
    if typ == "Pooling":
        p = layer.get("pooling_param", {})
        kh, kw, sh, sw, ph, pw = _kernel_params(p)
        global_p = bool(p.get("global_pooling", False))
        pool = p.get("pool", "MAX")
        if pool in ("MAX", 0):
            m = N.SpatialMaxPooling(kw, kh, sw, sh, pw, ph).ceil()
        else:
            m = N.SpatialAveragePooling(kw, kh, sw, sh, pw, ph,
                                        global_pooling=global_p,
                                        ceil_mode=True)
        m.set_name(name)
        return m, in_channels
    if typ == "ReLU":
        return N.ReLU().set_name(name), in_channels
    if typ == "Sigmoid":
        return N.Sigmoid().set_name(name), in_channels
    if typ == "TanH" or typ == "Tanh":
        return N.Tanh().set_name(name), in_channels
    if typ == "LRN":
        p = layer.get("lrn_param", {})
        m = N.SpatialCrossMapLRN(int(p.get("local_size", 5)),
                                 float(p.get("alpha", 1.0)),
                                 float(p.get("beta", 0.75)),
                                 float(p.get("k", 1.0)))
        return m.set_name(name), in_channels
    if typ == "Concat":
        # reference Converter fromCaffeConcat honors concat_param.axis
        # (default 1 = channels); JoinTable is 1-based including batch for
        # ax >= 0 and takes caffe-style negative axes unchanged
        ax = _concat_axis(layer)
        return N.JoinTable(ax + 1 if ax >= 0 else ax).set_name(name), None
    if typ == "Dropout":
        p = layer.get("dropout_param", {})
        return N.Dropout(float(p.get("dropout_ratio", 0.5))).set_name(name), \
            in_channels
    if typ in ("Softmax", "SoftmaxWithLoss"):
        return N.SoftMax().set_name(name), in_channels
    if typ == "LogSoftmax":
        return N.LogSoftMax().set_name(name), in_channels
    if typ == "BatchNorm":
        m = N.SpatialBatchNormalization(in_channels, affine=False)
        return m.set_name(name), in_channels
    if typ == "Scale":
        m = N.Scale([in_channels, 1, 1])
        return m.set_name(name), in_channels
    if typ == "Eltwise":
        p = layer.get("eltwise_param", {})
        op = p.get("operation", "SUM")
        if op in ("SUM", 1):
            return N.CAddTable().set_name(name), in_channels
        if op in ("PROD", 0):
            return N.CMulTable().set_name(name), in_channels
        return N.CMaxTable().set_name(name), in_channels
    if typ == "Flatten":
        return N.InferReshape([0, -1], batch_mode=False).set_name(name), \
            in_channels
    if typ == "Power":
        # y = (shift + scale * x) ^ power  (caffe power_param semantics,
        # reference utils/caffe/Converter.scala fromCaffePower)
        p = layer.get("power_param", {})
        m = N.Power(float(p.get("power", 1.0)), float(p.get("scale", 1.0)),
                    float(p.get("shift", 0.0)))
        return m.set_name(name), in_channels
    if typ == "PReLU":
        return N.PReLU(in_channels or 1).set_name(name), in_channels
    if typ == "Threshold":
        # caffe Threshold outputs the INDICATOR x > t (unlike torch
        # Threshold, which passes x through) — BinaryThreshold matches
        p = layer.get("threshold_param", {})
        m = N.BinaryThreshold(float(p.get("threshold", 0.0)))
        return m.set_name(name), in_channels
    if typ == "Exp":
        # y = base^(scale*x + shift); base=-1 means e
        p = layer.get("exp_param", {})
        base = float(p.get("base", -1.0))
        scale = float(p.get("scale", 1.0))
        shift = float(p.get("shift", 0.0))
        ln_base = 1.0 if base <= 0 else float(np.log(base))
        m = N.Sequential(N.MulConstant(scale * ln_base),
                         N.AddConstant(shift * ln_base), N.Exp())
        return m.set_name(name), in_channels
    if typ == "Log":
        # y = log_base(scale*x + shift)
        p = layer.get("log_param", {})
        base = float(p.get("base", -1.0))
        scale = float(p.get("scale", 1.0))
        shift = float(p.get("shift", 0.0))
        m = N.Sequential(N.MulConstant(scale), N.AddConstant(shift),
                         N.Log())
        if base > 0:
            m.add(N.MulConstant(1.0 / float(np.log(base))))
        return m.set_name(name), in_channels
    if typ == "AbsVal":
        return N.Abs().set_name(name), in_channels
    if typ == "ELU":
        p = layer.get("elu_param", {})
        return N.ELU(float(p.get("alpha", 1.0))).set_name(name), in_channels
    if typ == "Deconvolution":
        p = layer.get("convolution_param", {})
        nout = int(p["num_output"])
        kh, kw, sh, sw, ph, pw = _kernel_params(p)
        group = int(p.get("group", 1))
        bias = bool(p.get("bias_term", True))
        m = N.SpatialFullConvolution(in_channels, nout, kw, kh, sw, sh,
                                     pw, ph, n_group=group,
                                     no_bias=not bias)
        m.set_name(name)
        return m, nout
    raise ValueError(f"unsupported caffe layer type {typ} ({name})")


def _concat_axis(layer) -> int:
    """Concat layer's axis, shared by the JoinTable construction and the
    channel bookkeeping in load_caffe so they cannot desynchronize."""
    return int(layer.get("concat_param", {}).get("axis", 1))


def load_caffe(prototxt_path: str, caffemodel_path: Optional[str] = None,
               input_channels: int = 3, device=None):
    """Build a Graph from a deploy prototxt; optionally load weights. The
    graph's tensors go to ``device`` (the CUDA device by default; ``"cpu"``
    for the CPU).

    Parity: Module.loadCaffeModel (utils/caffe/CaffeLoader.scala:430).
    """
    dev = engine.resolve_device(device)
    with open(prototxt_path) as f:
        net = parse_prototxt(f.read())
    layers = _as_list(net.get("layer")) + _as_list(net.get("layers"))

    # channel tracking per top blob
    channels: Dict[str, Optional[int]] = {}
    inputs = _as_list(net.get("input"))
    input_dims = _as_list(net.get("input_dim"))
    if inputs:
        channels[inputs[0]] = (int(input_dims[1]) if len(input_dims) >= 2
                               else input_channels)
    nodes: Dict[str, object] = {}
    in_node = N.Input(name="data")
    for iname in inputs or ["data"]:
        nodes[iname] = in_node
        channels.setdefault(iname, input_channels)

    modules_by_name = {}
    last_top = None
    for layer in layers:
        typ = layer.get("type")
        bottoms = _as_list(layer.get("bottom"))
        tops = _as_list(layer.get("top"))
        if isinstance(typ, str) and typ in ("Input",):
            for t in tops:
                nodes[t] = in_node
                p = layer.get("input_param", {}).get("shape", {})
                dims = _as_list(p.get("dim")) if isinstance(p, dict) else []
                channels[t] = int(dims[1]) if len(dims) >= 2 else \
                    input_channels
            continue
        in_ch = channels.get(bottoms[0]) if bottoms else input_channels
        if typ == "Slice":
            # multi-output: one Narrow node per top blob (reference
            # Converter.scala fromCaffeSlice; our DAG keys nodes by top,
            # so each output gets its own slice node)
            p = layer.get("slice_param", {})
            axis = int(p.get("axis", 1))
            points = [int(x) for x in _as_list(p.get("slice_point"))]
            total = in_ch if axis == 1 else None
            if not points:
                if total is None or total % max(len(tops), 1):
                    raise ValueError(
                        f"Slice {layer.get('name')}: need slice_point or a "
                        "channel count divisible by the top count")
                step = total // len(tops)
                points = [step * (i + 1) for i in range(len(tops) - 1)]
            if total is None and len(points) < len(tops):
                why = ("axis != 1" if axis != 1
                       else "channel count of the bottom is untracked")
                raise ValueError(
                    f"Slice {layer.get('name')}: the slice-axis extent is "
                    f"unknown ({why}), so slice_point must give every "
                    "boundary (len(tops) points) — the last output's "
                    "extent cannot be derived")
            bounds = [0] + points + ([total] if total is not None else [])
            if len(bounds) < len(tops) + 1:
                raise ValueError(
                    f"Slice {layer.get('name')}: slice_point count must be "
                    "len(tops)-1")
            src = nodes[bottoms[0]]
            for i, t in enumerate(tops):
                lo, hi = bounds[i], bounds[i + 1]
                m = N.Narrow(axis + 1, lo + 1, hi - lo)  # 1-based incl. batch
                m.set_name(f"{layer.get('name', 'slice')}_{i}")
                modules_by_name[m.name] = m
                nodes[t] = m(src)
                channels[t] = (hi - lo) if axis == 1 else in_ch
            last_top = tops[0] if tops else last_top
            continue
        if typ == "Concat" or typ == 3:
            # channel counts add up only when concatenating ON the channel
            # axis (1, or -3 on this converter's 4D NCHW blobs); off-axis
            # concat keeps the bottoms' (common) count
            cat_ax = _concat_axis(layer)
            in_ch_total = sum(channels.get(b) or 0 for b in bottoms) \
                if cat_ax in (1, -3) else in_ch
        m, out_ch = _convert_layer(layer, in_ch)
        if m is None:
            for t in tops:
                if bottoms:
                    nodes[t] = nodes.get(bottoms[0], in_node)
                    channels[t] = channels.get(bottoms[0], input_channels)
                else:
                    nodes[t] = in_node
                    channels[t] = input_channels
            continue
        modules_by_name[layer.get("name", "")] = m
        ins = [nodes[b] for b in bottoms] if bottoms else [in_node]
        node = m(*ins) if len(ins) > 1 else m(ins[0])
        if typ == "Concat" or typ == 3:
            out_ch = in_ch_total
        for t in tops:
            nodes[t] = node
            channels[t] = out_ch
        last_top = tops[0] if tops else last_top

    graph = N.Graph(in_node, nodes[last_top])

    if caffemodel_path:
        blobs = read_caffemodel_blobs(caffemodel_path)
        _load_weights(graph, modules_by_name, blobs)
    return graph.to(dev)



def _load_weights(graph, modules_by_name, blobs):
    in_graph = {id(m) for m in graph.modules()}
    for name, bl in blobs.items():
        m = modules_by_name.get(name)
        if m is None or id(m) not in in_graph:
            continue
        if isinstance(m, N.Sequential):
            # InnerProduct wrapper: flatten + Linear at index 1
            inner = next((c for c in m.children()
                          if isinstance(c, N.Linear)), None)
            if inner is not None:
                want = tuple(inner.weight.shape)
                if bl[0].size != int(np.prod(want)):
                    # the graph builder guessed the flattened input dim from
                    # channel tracking (caffe flattens implicitly; spatial
                    # extent is invisible in the prototxt). The weight blob
                    # knows the truth: (num_output, true_flat_in).
                    true_in = bl[0].size // want[0]
                    inner.input_size = true_in
                    inner.weight = torch.nn.Parameter(
                        torch.empty(want[0], true_in))
                assign(inner.weight, bl[0])
                if len(bl) > 1 and inner.bias is not None:
                    assign(inner.bias, bl[1])
            continue
        if isinstance(m, (N.SpatialConvolution, N.SpatialFullConvolution,
                          N.Linear)):
            # caffe Deconvolution blobs are (in, out/g, kh, kw) — exactly
            # our SpatialFullConvolution layout; Convolution blobs match
            # SpatialConvolution's (out, in/g, kh, kw)
            assign(m.weight, bl[0])
            if len(bl) > 1 and m.bias is not None:
                assign(m.bias, bl[1])
        elif isinstance(m, N.PReLU):
            assign(m.weight, bl[0])
        elif isinstance(m, N.SpatialBatchNormalization):
            scale = float(bl[2].reshape(-1)[0]) if len(bl) > 2 and \
                bl[2].size else 1.0
            scale = 1.0 / scale if scale != 0 else 1.0
            assign(m.running_mean, bl[0].reshape(-1) * scale)
            assign(m.running_var, bl[1].reshape(-1) * scale)
        elif isinstance(m, N.Scale):
            assign(m.weight, bl[0])
            if len(bl) > 1:
                assign(m.bias, bl[1])
    return graph


__all__ = ["parse_prototxt", "read_caffemodel_blobs", "load_caffe"]
