"""TensorFlow GraphDef export (counterpart of ``bigdl_tpu/loaders/tf_saver.py``;
parity: reference ``utils/tf/TensorflowSaver.scala`` +
``utils/tf/BigDLToTensorflow.scala``).

Serialises a model to a frozen NHWC GraphDef at the protobuf wire
level (loaders/wire.py — no tensorflow dependency), the mirror image of
``load_tf_graph``. The exported graph round-trips: ``load_tf_graph(save_tf_graph
(model, shape))`` reproduces the model's outputs bit-for-bit on the same input.

Layout: the in-memory model is NCHW-native; TF convention is NHWC. Conv/pool
kernels and strides are emitted NHWC, conv weights are transposed OIHW→HWIO,
and the first Linear after a flatten gets its columns permuted from the
NCHW flatten order (C,H,W) to TF's NHWC order (H,W,C) — the same
transformation ``load_tf_graph`` applies in reverse.

Supported module set mirrors the reference saver's (BigDLToTensorflow.scala
covers Linear/SpatialConvolution/Pooling/ReLU/Tanh/Sigmoid/Softmax/BN/LRN/
Dropout/Reshape/View/Concat/CAddTable...): Sequential composition, Concat
branches (→ ConcatV2), ConcatTable + CAddTable/JoinTable (residual blocks),
and the core layer zoo.

A strided max pool with explicit pads (ResNet's 3x3 / 2 / 1 stem pool)
is exported as a PadV2 of -inf and a VALID pool: TF's SAME would pad at
the end only and move every window (the JAX package's saver exports it as
SAME, and its round trip differs from the model).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import struct

import numpy as np
import torch

from .. import nn as N
from ._walk import children, conv_geometry, has_bias, host
from .wire import (field_bytes, field_string, field_varint, tag)

# tensorflow DataType enums
_DT_FLOAT, _DT_INT32, _DT_BOOL = 1, 3, 10


# ---------------------------------------------------------------------------
# wire-level emitters (graph.proto / node_def.proto / attr_value.proto /
# tensor.proto field numbers)
# ---------------------------------------------------------------------------


def _shape_proto(dims) -> bytes:
    out = b""
    for d in dims:
        out += field_bytes(2, field_varint(1, int(d)))  # Dim.size
    return out


def _tensor_proto(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype in (np.float64,):
        arr = arr.astype(np.float32)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    dt = {np.dtype(np.float32): _DT_FLOAT,
          np.dtype(np.int32): _DT_INT32,
          np.dtype(np.bool_): _DT_BOOL}[arr.dtype]
    body = field_varint(1, dt)                       # dtype
    body += field_bytes(2, _shape_proto(arr.shape))  # tensor_shape
    body += field_bytes(4, arr.astype(arr.dtype).tobytes())  # tensor_content
    return body


def _attr_tensor(arr) -> bytes:
    return field_bytes(8, _tensor_proto(arr))


def _attr_type(dt: int) -> bytes:
    return field_varint(6, dt)


def _attr_int(v: int) -> bytes:
    return field_varint(3, v)


def _attr_float(v: float) -> bytes:
    return tag(4, 5) + struct.pack("<f", v)


def _attr_bool(v: bool) -> bytes:
    return field_varint(5, 1 if v else 0)


def _attr_string(s: str) -> bytes:
    return field_bytes(2, s.encode("utf-8"))


def _attr_ints(vals) -> bytes:
    body = b"".join(field_varint(3, int(v)) for v in vals)
    return field_bytes(1, body)  # list.i


def _attr_shape(dims) -> bytes:
    return field_bytes(7, _shape_proto(dims))


def _node(name: str, op: str, inputs: List[str],
          attrs: Dict[str, bytes]) -> bytes:
    body = field_string(1, name) + field_string(2, op)
    for i in inputs:
        body += field_string(3, i)
    for k, v in attrs.items():
        entry = field_string(1, k) + field_bytes(2, v)
        body += field_bytes(5, entry)
    return field_bytes(1, body)  # GraphDef.node


# ---------------------------------------------------------------------------
# model walk
# ---------------------------------------------------------------------------


class _Ctx:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.counter = 0

    def fresh(self, base: str) -> str:
        self.counter += 1
        return f"{base}_{self.counter}"

    def const(self, name: str, arr) -> str:
        self.nodes.append(_node(name, "Const", [], {
            "dtype": _attr_type(_DT_INT32 if np.asarray(arr).dtype.kind in
                                "iu" else _DT_FLOAT),
            "value": _attr_tensor(arr)}))
        return name

    def emit(self, name, op, inputs, attrs=None):
        self.nodes.append(_node(name, op, inputs, attrs or {}))
        return name


def _apply_leaf(module, x):
    with torch.no_grad():
        out, _ = module.apply(module.params, module.state, x, training=False)
    return out


def _conv_padding(m) -> str:
    pad_h, pad_w = conv_geometry(m)[2]
    if pad_w == -1 or pad_h == -1:
        return "SAME"
    if pad_w == 0 and pad_h == 0:
        return "VALID"
    return "EXPLICIT"


def _maybe_pad(ctx, in_name, ph, pw, base, value=None, extra=(0, 0)):
    """Emit an explicit NHWC Pad node for pad codes TF can't express (a
    PadV2 of ``value`` when given: -inf before a max pool); ``extra`` adds
    rows / columns at the bottom / right (a ceil-mode pool's last
    window)."""
    pads = np.asarray([[0, 0], [ph, ph + extra[0]], [pw, pw + extra[1]],
                       [0, 0]], np.int32)
    c = ctx.const(ctx.fresh(base + "/paddings"), pads)
    if value is None:
        return ctx.emit(ctx.fresh(base + "/pad"), "Pad", [in_name, c],
                        {"T": _attr_type(_DT_FLOAT)})
    v = ctx.const(ctx.fresh(base + "/pad_value"), np.float32(value))
    return ctx.emit(ctx.fresh(base + "/pad"), "PadV2", [in_name, c, v],
                    {"T": _attr_type(_DT_FLOAT)})


def _pool_padding(m) -> str:
    if m.pad_h == -1 or m.pad_w == -1:
        return "SAME"
    if m.pad_h == 0 and m.pad_w == 0 and not m.ceil_mode:
        return "VALID"
    if m.dh == 1 and m.dw == 1 and m.pad_h == (m.kh - 1) // 2 \
            and m.pad_w == (m.kw - 1) // 2 and m.kh % 2 and m.kw % 2:
        return "SAME"  # stride-1 half padding of an odd kernel ≡ SAME
    # TF's SAME pads a strided window at the end only: explicit pads
    return "EXPLICIT"


def _ceil_extra(m, x):
    """Rows / columns a ceil-mode pool's last window reads past the
    explicit pads (0 in floor mode)."""
    if not m.ceil_mode:
        return (0, 0)
    out = []
    for n, k, s, p in ((x.shape[2], m.kh, m.dh, m.pad_h),
                       (x.shape[3], m.kw, m.dw, m.pad_w)):
        o = -(-(n + 2 * p - k) // s) + 1
        if (o - 1) * s >= n + p:       # torch drops a window in the pad
            o -= 1
        out.append(max((o - 1) * s + k - (n + 2 * p), 0))
    return tuple(out)


def _nchw_to_nhwc_perm(c, h, w):
    """Column permutation taking a (C*H*W)-flattened vector to (H*W*C)."""
    idx = np.arange(c * h * w).reshape(c, h, w)       # our flatten order
    return idx.transpose(1, 2, 0).reshape(-1)          # TF flatten order


_ACTIVATIONS = {
    N.ReLU: "Relu", N.ReLU6: "Relu6", N.Tanh: "Tanh", N.Sigmoid: "Sigmoid",
    N.SoftMax: "Softmax", N.LogSoftMax: "LogSoftmax", N.ELU: "Elu",
    N.SoftPlus: "Softplus", N.SoftSign: "Softsign",
}


def _emit_module(m, x, in_name, ctx):
    """Emit TF nodes for module ``m``; returns (out_activation, out_name).
    ``x`` is the running NCHW dummy activation (exact shape tracking via the
    functional apply); ``in_name`` names the NHWC TF tensor carrying it."""
    name = m.name

    if isinstance(m, N.Sequential):
        cur, cur_name = x, in_name
        pending = None  # Table output of a ConcatTable
        for child in children(m):
            if pending is not None:
                cur, cur_name = _emit_table_consumer(child, pending, ctx)
                pending = None
                continue
            if isinstance(child, N.ConcatTable):
                pending = _emit_concat_table(child, cur, cur_name, ctx)
                continue
            cur, cur_name = _emit_module(child, cur, cur_name, ctx)
        if pending is not None:
            raise NotImplementedError("ConcatTable must be consumed by a "
                                      "table op in the same Sequential")
        return cur, cur_name

    if isinstance(m, N.Concat):
        outs = [_emit_module(child, x, in_name, ctx)
                for child in children(m)]
        assert m.dimension == 2, "only channel concat is exportable"
        axis = ctx.const(ctx.fresh(name + "/axis"), np.asarray(3, np.int32))
        out_name = ctx.emit(name, "ConcatV2",
                            [n for _, n in outs] + [axis],
                            {"N": _attr_int(len(outs)),
                             "T": _attr_type(_DT_FLOAT)})
        out = torch.cat([o for o, _ in outs], dim=1)
        return out, out_name

    if isinstance(m, (N.Identity, N.Dropout)):
        return x, ctx.emit(name, "Identity", [in_name],
                           {"T": _attr_type(_DT_FLOAT)})

    if isinstance(m, N.SpatialConvolution):
        w = host(m.weight)  # OIHW
        (_, _), (stride_h, stride_w), (pad_h, pad_w) = conv_geometry(m)
        pad = _conv_padding(m)
        src = in_name
        if pad == "EXPLICIT":
            src = _maybe_pad(ctx, in_name, pad_h, pad_w, name)
            pad = "VALID"
        if m.n_group > 1:
            # grouped conv → DepthwiseConv2dNative when group == cin
            cin = m.n_input_plane
            mult = m.n_output_plane // cin
            assert m.n_group == cin, "TF export supports depthwise groups only"
            wk = ctx.const(name + "/weights",
                           w.reshape(cin, mult, *w.shape[2:])
                            .transpose(2, 3, 0, 1).astype(np.float32))
            out_name = ctx.emit(name, "DepthwiseConv2dNative", [src, wk], {
                "strides": _attr_ints([1, stride_h, stride_w, 1]),
                "padding": _attr_string(pad),
                "T": _attr_type(_DT_FLOAT),
                "data_format": _attr_string("NHWC")})
        else:
            wk = ctx.const(name + "/weights",
                           np.transpose(w, (2, 3, 1, 0)).astype(np.float32))
            out_name = ctx.emit(name, "Conv2D", [src, wk], {
                "strides": _attr_ints([1, stride_h, stride_w, 1]),
                "padding": _attr_string(pad),
                "T": _attr_type(_DT_FLOAT),
                "data_format": _attr_string("NHWC")})
        if has_bias(m):
            b = ctx.const(name + "/bias", host(m.bias).astype(np.float32))
            out_name = ctx.emit(name + "/bias_add", "BiasAdd",
                                [out_name, b], {"T": _attr_type(_DT_FLOAT)})
        return _apply_leaf(m, x), out_name

    if isinstance(m, N.Linear):
        w = host(m.weight)  # (out, in)
        if x.dim() == 4:
            raise NotImplementedError("flatten (View/Reshape) must precede "
                                      "Linear for TF export")
        wt = w.T.astype(np.float32)  # (in, out) — TF MatMul layout
        flat_src = getattr(ctx, "_last_flatten", None)
        if flat_src is not None:
            c, h, w_ = flat_src
            perm = _nchw_to_nhwc_perm(c, h, w_)
            wt = wt[perm]
            ctx._last_flatten = None
        wk = ctx.const(name + "/weights", wt)
        out_name = ctx.emit(name, "MatMul", [in_name, wk],
                            {"T": _attr_type(_DT_FLOAT),
                             "transpose_a": _attr_bool(False),
                             "transpose_b": _attr_bool(False)})
        if has_bias(m):
            b = ctx.const(name + "/bias", host(m.bias).astype(np.float32))
            out_name = ctx.emit(name + "/bias_add", "BiasAdd",
                                [out_name, b], {"T": _attr_type(_DT_FLOAT)})
        return _apply_leaf(m, x), out_name

    if isinstance(m, N.SpatialBatchNormalization):
        gamma = np.ones(m.n_output, np.float32) if m.weight is None \
            else host(m.weight)
        beta = np.zeros(m.n_output, np.float32) if m.bias is None \
            else host(m.bias)
        mean = host(m.running_mean).astype(np.float32)
        var = host(m.running_var).astype(np.float32)
        ins = [in_name,
               ctx.const(name + "/gamma", gamma.astype(np.float32)),
               ctx.const(name + "/beta", beta.astype(np.float32)),
               ctx.const(name + "/moving_mean", mean),
               ctx.const(name + "/moving_variance", var)]
        out_name = ctx.emit(name, "FusedBatchNorm", ins, {
            "T": _attr_type(_DT_FLOAT),
            "epsilon": _attr_float(float(m.eps)),
            "is_training": _attr_bool(False),
            "data_format": _attr_string("NHWC")})
        return _apply_leaf(m, x), out_name

    for cls, tf_op in _ACTIVATIONS.items():
        if type(m) is cls:
            attrs = {"T": _attr_type(_DT_FLOAT)}
            return _apply_leaf(m, x), \
                ctx.emit(name, tf_op, [in_name], attrs)
    if isinstance(m, N.LeakyReLU):
        return _apply_leaf(m, x), \
            ctx.emit(name, "LeakyRelu", [in_name],
                     {"T": _attr_type(_DT_FLOAT),
                      "alpha": _attr_float(float(m.negval))})

    if isinstance(m, (N.SpatialMaxPooling, N.SpatialAveragePooling)):
        if getattr(m, "global_pooling", False):
            axes = ctx.const(ctx.fresh(name + "/axes"),
                             np.asarray([1, 2], np.int32))
            out_name = ctx.emit(name, "Mean", [in_name, axes],
                                {"T": _attr_type(_DT_FLOAT),
                                 "keep_dims": _attr_bool(True)})
            return _apply_leaf(m, x), out_name
        pad = _pool_padding(m)
        src = in_name
        if pad == "EXPLICIT":
            extra = _ceil_extra(m, x)
            if isinstance(m, N.SpatialMaxPooling):
                src = _maybe_pad(ctx, in_name, m.pad_h, m.pad_w, name,
                                 float("-inf"), extra)
            elif any(extra):
                raise NotImplementedError(
                    "ceil-mode average pool with a partial last window not "
                    "exportable")
            else:
                src = _maybe_pad(ctx, in_name, m.pad_h, m.pad_w, name)
            pad = "VALID"
        op = "MaxPool" if isinstance(m, N.SpatialMaxPooling) else "AvgPool"
        out_name = ctx.emit(name, op, [src], {
            "ksize": _attr_ints([1, m.kh, m.kw, 1]),
            "strides": _attr_ints([1, m.dh, m.dw, 1]),
            "padding": _attr_string(pad),
            "T": _attr_type(_DT_FLOAT),
            "data_format": _attr_string("NHWC")})
        return _apply_leaf(m, x), out_name

    if isinstance(m, N.SpatialCrossMapLRN):
        radius = (m.size - 1) // 2
        out_name = ctx.emit(name, "LRN", [in_name], {
            "depth_radius": _attr_int(radius),
            "alpha": _attr_float(float(m.alpha) / m.size),
            "beta": _attr_float(float(m.beta)),
            "bias": _attr_float(float(m.k)),
            "T": _attr_type(_DT_FLOAT)})
        return _apply_leaf(m, x), out_name

    if isinstance(m, (N.Reshape, N.View)):
        out = _apply_leaf(m, x)
        if x.dim() == 4 and out.dim() == 2:
            # flatten: remember (C,H,W) so the next Linear permutes columns
            ctx._last_flatten = tuple(int(d) for d in x.shape[1:])
            target = np.asarray([-1, int(out.shape[1])], np.int32)
        else:
            tgt = list(out.shape[1:])
            if out.dim() == 4:  # NCHW target → NHWC
                tgt = [tgt[1], tgt[2], tgt[0]]
            target = np.asarray([-1] + [int(t) for t in tgt], np.int32)
        shp = ctx.const(ctx.fresh(name + "/shape"), target)
        out_name = ctx.emit(name, "Reshape", [in_name, shp],
                            {"T": _attr_type(_DT_FLOAT)})
        return out, out_name

    raise NotImplementedError(
        f"TF export: module {type(m).__name__} ({name}) unsupported")


def _emit_concat_table(m, x, in_name, ctx):
    return [_emit_module(child, x, in_name, ctx) for child in children(m)]


def _emit_table_consumer(m, pending, ctx):
    xs = [o for o, _ in pending]
    names = [n for _, n in pending]
    name = m.name
    if isinstance(m, N.CAddTable):
        if len(names) == 2:
            out_name = ctx.emit(name, "AddV2", names,
                                {"T": _attr_type(_DT_FLOAT)})
        else:
            out_name = ctx.emit(name, "AddN", names,
                                {"N": _attr_int(len(names)),
                                 "T": _attr_type(_DT_FLOAT)})
        return sum(xs[1:], xs[0]), out_name
    if isinstance(m, N.CMulTable):
        assert len(names) == 2
        out_name = ctx.emit(name, "Mul", names, {"T": _attr_type(_DT_FLOAT)})
        return xs[0] * xs[1], out_name
    if isinstance(m, N.JoinTable):
        assert m.dimension == 2, "only channel join is exportable"
        axis = ctx.const(ctx.fresh(name + "/axis"), np.asarray(3, np.int32))
        out_name = ctx.emit(name, "ConcatV2", names + [axis],
                            {"N": _attr_int(len(names)),
                             "T": _attr_type(_DT_FLOAT)})
        return torch.cat(xs, dim=1), out_name
    raise NotImplementedError(
        f"TF export: table consumer {type(m).__name__} unsupported")


def save_tf_graph(model, input_shape, path: Optional[str] = None,
                  input_name: str = "input") -> bytes:
    """Export ``model`` to frozen-GraphDef bytes (TensorflowSaver parity).

    ``input_shape``: the NCHW activation shape WITHOUT batch, e.g.
    ``(3, 224, 224)`` (or ``(features,)`` for 2-D models). The emitted
    Placeholder is NHWC, matching TF convention and ``load_tf_graph``.
    """
    model.evaluate()
    ctx = _Ctx()
    ctx._last_flatten = None

    shape = tuple(int(s) for s in input_shape)
    if len(shape) == 3:
        c, h, w = shape
        ph_shape = [-1, h, w, c]
    else:
        ph_shape = [-1] + list(shape)
    ctx.emit(input_name, "Placeholder", [],
             {"dtype": _attr_type(_DT_FLOAT),
              "shape": _attr_shape(ph_shape)})

    dev = next(iter(model.parameters()), torch.zeros(())).device
    x = torch.zeros((1,) + shape, dtype=torch.float32, device=dev)
    _, out_name = _emit_module(model, x, input_name, ctx)
    data = b"".join(ctx.nodes)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


__all__ = ["save_tf_graph"]
