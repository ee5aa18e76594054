"""TensorFlow GraphDef loader (counterpart of
``bigdl_tpu/loaders/tensorflow.py``).

Parity: reference ``utils/tf/TensorflowLoader.scala`` + ``nn/tf`` op layers
(Module.loadTF(graphFile, inputs, outputs)). No TensorFlow dependency: the
GraphDef/NodeDef/AttrValue/TensorProto messages are decoded at the protobuf
wire level (loaders/wire.py); field numbers from tensorflow's graph.proto,
node_def.proto, attr_value.proto, tensor.proto.

Supported op set covers the frozen-inference-graph class of nets (the
reference's loader has the same scope): Placeholder, Const, Identity, Conv2D,
DepthwiseConv2dNative, MatMul, BiasAdd, Add/AddV2/Sub/Mul, Relu/Relu6/Tanh/
Sigmoid/Softmax, MaxPool/AvgPool, FusedBatchNorm(V2/V3), Reshape, Squeeze,
Pad/PadV2, ConcatV2/Concat, Mean (spatial → global average pool).

Layout: TF frozen graphs are NHWC; the built Graph is NCHW-native. Weights are transposed at load time (HWIO→OIHW, and MatMul
kernels are permuted so NCHW-flattened inputs line up); the returned model
takes NCHW input.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn as N
from ..utils import engine
from ._walk import assign
from .wire import iter_fields, to_signed, unpack_packed

# tensorflow DataType enum (types.proto)
_DT_NUMPY = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 14: np.uint16, 19: np.float16,
}


# ---------------------------------------------------------------------------
# GraphDef wire decoding
# ---------------------------------------------------------------------------


def _decode_shape(buf: bytes) -> List[int]:
    dims = []
    for f, w, v in iter_fields(buf):
        if f == 2 and w == 2:  # Dim
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1:
                    dims.append(to_signed(v2))
    return dims


def _decode_tensor(buf: bytes) -> np.ndarray:
    dtype, shape, content = 1, [], None
    float_vals, int_vals, double_vals = [], [], []
    for f, w, v in iter_fields(buf):
        if f == 1 and w == 0:
            dtype = v
        elif f == 2 and w == 2:
            shape = _decode_shape(v)
        elif f == 4 and w == 2:
            content = v
        elif f == 5:  # float_val (tensor.proto)
            float_vals += unpack_packed(v, "float") if w == 2 else \
                [struct.unpack("<f", v)[0]]
        elif f == 6:  # double_val
            double_vals += unpack_packed(v, "double") if w == 2 else \
                [struct.unpack("<d", v)[0]]
        elif f in (7, 10):  # int_val / int64_val
            int_vals += [to_signed(x) for x in unpack_packed(v, "varint")] \
                if w == 2 else [to_signed(v)]
    np_dtype = _DT_NUMPY.get(dtype, np.float32)
    if content is not None:
        arr = np.frombuffer(content, dtype=np_dtype)
    elif float_vals:
        arr = np.array(float_vals, np.float32)
    elif double_vals:
        arr = np.array(double_vals, np.float64)
    elif int_vals:
        arr = np.array(int_vals, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    n = int(np.prod(shape)) if shape else arr.size
    if arr.size == 1 and n > 1:  # splat scalar fill
        arr = np.full(n, arr[0])
    return arr.reshape(shape) if shape else arr


def _decode_attr(buf: bytes):
    """AttrValue → python value."""
    for f, w, v in iter_fields(buf):
        if f == 2:   # s
            return v.decode("utf-8", "replace") if isinstance(v, bytes) else v
        if f == 3:   # i
            return to_signed(v)
        if f == 4:   # f
            return struct.unpack("<f", v)[0]
        if f == 5:   # b
            return bool(v)
        if f == 6:   # type
            return int(v)
        if f == 7:   # shape
            return _decode_shape(v)
        if f == 8:   # tensor
            return _decode_tensor(v)
        if f == 1:   # list
            out = {"s": [], "i": [], "f": [], "b": []}
            for f2, w2, v2 in iter_fields(v):
                if f2 == 2:
                    out["s"].append(v2.decode("utf-8", "replace"))
                elif f2 == 3:
                    out["i"] += [to_signed(x) for x in
                                 unpack_packed(v2, "varint")] \
                        if w2 == 2 else [to_signed(v2)]
                elif f2 == 4:
                    out["f"] += unpack_packed(v2, "float") if w2 == 2 else \
                        [struct.unpack("<f", v2)[0]]
                elif f2 == 5:
                    out["b"] += [bool(x) for x in unpack_packed(v2, "varint")]\
                        if w2 == 2 else [bool(v2)]
            if out["i"]:
                return out["i"]
            if out["f"]:
                return out["f"]
            if out["s"]:
                return out["s"]
            return out["b"]
    return None


def _decode_node(buf: bytes) -> Dict:
    node = {"name": "", "op": "", "inputs": [], "attrs": {}}
    for f, w, v in iter_fields(buf):
        if f == 1:
            node["name"] = v.decode("utf-8")
        elif f == 2:
            node["op"] = v.decode("utf-8")
        elif f == 3:
            node["inputs"].append(v.decode("utf-8"))
        elif f == 5 and w == 2:  # map<string, AttrValue> entry
            key, val = None, None
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1:
                    key = v2.decode("utf-8")
                elif f2 == 2:
                    val = _decode_attr(v2)
            if key is not None:
                node["attrs"][key] = val
    return node


def parse_graphdef(data: bytes) -> List[Dict]:
    """GraphDef bytes → list of node dicts {name, op, inputs, attrs}."""
    return [_decode_node(v) for f, w, v in iter_fields(data)
            if f == 1 and w == 2]


# ---------------------------------------------------------------------------
# conversion to a bigdl_tpu Graph (NCHW)
# ---------------------------------------------------------------------------


class _TFReshape(N.Module):
    """TF Reshape with NHWC semantics on NCHW activations: transpose 4D
    input back to NHWC, reshape to the (NHWC-order) target, then return
    4D results to NCHW. Keeps element order — and downstream MatMul weights
    trained on NHWC flatten order — aligned with the frozen graph."""

    def __init__(self, target, name=None):
        super().__init__(name=name)
        self.target = [int(t) for t in target]

    def call(self, params, x):
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        y = x.reshape(self.target)
        if y.dim() == 4:
            y = y.permute(0, 3, 1, 2)
        return y


class _TFPad(N.Module):
    """tensorflow Pad / PadV2 with constant paddings (already permuted to
    NCHW) and value."""

    def __init__(self, paddings, value=0.0, name=None):
        super().__init__(name=name)
        self.paddings = [tuple(int(x) for x in p) for p in paddings]
        self.value = value

    def call(self, params, x):
        pads = self.paddings
        if len(pads) == x.dim() - 1:  # stored without batch dim
            pads = [(0, 0)] + pads
        return F.pad(x, [v for p in reversed(pads) for v in p],
                     value=self.value)


def _base_name(inp: str) -> str:
    """Strip the :output-index suffix and ^control prefix of a TF input."""
    inp = inp.lstrip("^")
    return inp.split(":")[0]


def _out_index(inp: str) -> int:
    inp = inp.lstrip("^")
    return int(inp.split(":")[1]) if ":" in inp else 0


# ops whose module output is a Table of tensors; consumers select by index
_MULTI_OUT = {"Split", "SplitV", "Unpack", "Unstack", "TopKV2", "TopK"}

# real frozen graphs compute shape/axis tensors from Consts (Range over a
# Shape slice, packed dims, ...). Fold those sub-DAGs to Consts up front so
# the op converters see static values — the TPU-native requirement (static
# shapes under jit) and the reference's Session-freezing behave the same way.
_FOLDABLE = {
    "Identity", "Cast", "Reshape", "Range", "Pack", "ExpandDims", "Squeeze",
    "ConcatV2", "Concat", "Slice", "StridedSlice", "Add", "AddV2", "Sub",
    "Mul", "RealDiv", "Floor", "FloorDiv", "Maximum", "Minimum", "Neg",
    "Shape", "Size", "Rank", "GatherV2", "Gather", "Fill",
}


def _fold_constants(nodes, consts, by_name):
    changed = True
    while changed:
        changed = False
        for n in nodes:
            name, op = n["name"], n["op"]
            if name in consts or op not in _FOLDABLE:
                continue
            ins = [i for i in n["inputs"] if not i.startswith("^")]
            if not ins or not all(_base_name(i) in consts for i in ins):
                continue
            vals = [np.asarray(consts[_base_name(i)]) for i in ins]
            a = n["attrs"]
            try:
                consts[name] = _fold_one(op, vals, a)
                changed = True
            except Exception:
                continue


def _fold_one(op, vals, attrs):
    if op == "Identity":
        return vals[0]
    if op == "Cast":
        return vals[0].astype(_DT_NUMPY.get(attrs.get("DstT", 1), np.float32))
    if op == "Reshape":
        return vals[0].reshape([int(x) for x in vals[1].reshape(-1)])
    if op == "Range":
        return np.arange(int(vals[0]), int(vals[1]), int(vals[2]), np.int32)
    if op == "Pack":
        return np.stack(vals, axis=attrs.get("axis", 0))
    if op == "ExpandDims":
        return np.expand_dims(vals[0], int(vals[1]))
    if op == "Squeeze":
        return np.squeeze(vals[0])
    if op in ("ConcatV2", "Concat"):
        axis = int(vals[-1]) if op == "ConcatV2" else int(vals[0])
        parts = vals[:-1] if op == "ConcatV2" else vals[1:]
        return np.concatenate(parts, axis=axis)
    if op == "Slice":
        begin = vals[1].reshape(-1)
        size = vals[2].reshape(-1)
        idx = tuple(slice(int(b), None if s == -1 else int(b) + int(s))
                    for b, s in zip(begin, size))
        return vals[0][idx]
    if op == "StridedSlice":
        begin, end, strides = [v.reshape(-1) for v in vals[1:4]]
        shrink = attrs.get("shrink_axis_mask", 0)
        idx = []
        for d in range(len(begin)):
            if (shrink >> d) & 1:
                idx.append(int(begin[d]))
            else:
                idx.append(slice(int(begin[d]), int(end[d]), int(strides[d])))
        return vals[0][tuple(idx)]
    if op in ("Add", "AddV2"):
        return vals[0] + vals[1]
    if op == "Sub":
        return vals[0] - vals[1]
    if op == "Mul":
        return vals[0] * vals[1]
    if op == "RealDiv":
        return vals[0] / vals[1]
    if op == "Floor":
        return np.floor(vals[0])
    if op == "FloorDiv":
        return np.floor_divide(vals[0], vals[1])
    if op == "Maximum":
        return np.maximum(vals[0], vals[1])
    if op == "Minimum":
        return np.minimum(vals[0], vals[1])
    if op == "Neg":
        return -vals[0]
    if op == "Shape":
        return np.asarray(vals[0].shape, np.int32)
    if op == "Size":
        return np.asarray(vals[0].size, np.int32)
    if op == "Rank":
        return np.asarray(vals[0].ndim, np.int32)
    if op in ("Gather", "GatherV2"):
        axis = int(vals[2]) if len(vals) > 2 else 0
        return np.take(vals[0], vals[1].astype(np.int64), axis=axis)
    if op == "Fill":
        return np.full([int(x) for x in vals[0].reshape(-1)], vals[1])
    raise NotImplementedError(op)


def _strides_hw(attrs) -> Tuple[int, int]:
    s = attrs.get("strides", [1, 1, 1, 1])
    if attrs.get("data_format", "NHWC") == "NCHW":
        return int(s[2]), int(s[3])
    return int(s[1]), int(s[2])


def _pad_code(attrs) -> int:
    return -1 if attrs.get("padding", "VALID") == "SAME" else 0


def load_tf_graph(path_or_bytes, inputs: Optional[List[str]] = None,
                  outputs: Optional[List[str]] = None,
                  device=None) -> N.Module:
    """Module.loadTF parity: build an NCHW Graph from a frozen GraphDef.
    ``inputs``/``outputs`` default to the Placeholder nodes and the
    terminal node; the graph's tensors go to ``device`` (the CUDA device
    by default; ``"cpu"`` for the CPU)."""
    dev = engine.resolve_device(device)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    nodes = parse_graphdef(data)
    by_name = {n["name"]: n for n in nodes}
    consts: Dict[str, np.ndarray] = {
        n["name"]: n["attrs"].get("value") for n in nodes
        if n["op"] == "Const"}
    _fold_constants(nodes, consts, by_name)

    if inputs is None:
        inputs = [n["name"] for n in nodes if n["op"] == "Placeholder"]
    if outputs is None:
        consumed = {_base_name(i) for n in nodes for i in n["inputs"]}
        outputs = [n["name"] for n in nodes
                   if n["op"] != "Const" and n["name"] not in consumed]
    if not inputs:
        raise ValueError("no Placeholder inputs found; pass inputs=[...]")

    graph_nodes: Dict[str, object] = {}
    input_nodes = []
    for name in inputs:
        gn = N.Input(name=name)
        graph_nodes[name] = gn
        input_nodes.append(gn)

    def data_inputs(node):
        """Non-const, non-control producer names."""
        return [_base_name(i) for i in node["inputs"]
                if not i.startswith("^") and _base_name(i) not in consts]

    def const_inputs(node):
        return [consts[_base_name(i)] for i in node["inputs"]
                if _base_name(i) in consts]

    def build(name: str):
        if name in graph_nodes:
            return graph_nodes[name]
        node = by_name[name]
        op, attrs = node["op"], node["attrs"]
        srcs = [build_output(i) for i in node["inputs"]
                if not i.startswith("^") and _base_name(i) not in consts]
        cns = const_inputs(node)
        m = _convert_op(node, op, attrs, cns, by_name, consts)
        gn = m(srcs[0] if len(srcs) == 1 else srcs)
        graph_nodes[name] = gn
        return gn

    def build_output(ref: str):
        """Resolve an input reference, selecting the right output of a
        multi-output producer (Split/Unpack return a Table)."""
        base, idx = _base_name(ref), _out_index(ref)
        gn = build(base)
        if by_name.get(base, {}).get("op") in _MULTI_OUT:
            key = f"{base}:{idx}"
            if key not in graph_nodes:
                graph_nodes[key] = N.SelectTable(idx + 1)(gn)
            return graph_nodes[key]
        return gn

    out_nodes = [build_output(o) for o in outputs]
    g = N.Graph(input_nodes, out_nodes).to(dev)
    # frozen GraphDefs are inference graphs: BN must use the loaded moving
    # stats, dropout must be a no-op
    g.evaluate()
    return g



def _convert_op(node, op, attrs, cns, by_name, consts) -> N.Module:
    name = node["name"]
    if op in ("Identity", "StopGradient", "CheckNumerics", "PreventGradient"):
        return N.Identity(name=name)
    if op == "Conv2D":
        w = cns[0]  # HWIO
        kh, kw, cin, cout = w.shape
        sh, sw = _strides_hw(attrs)
        m = N.SpatialConvolution(cin, cout, kw, kh, sw, sh,
                                 _pad_code(attrs), _pad_code(attrs),
                                 with_bias=False, name=name)
        assign(m.weight, np.transpose(w, (3, 2, 0, 1)))
        return m
    if op == "DepthwiseConv2dNative":
        w = cns[0]  # (kh, kw, cin, channel_multiplier)
        kh, kw, cin, mult = w.shape
        sh, sw = _strides_hw(attrs)
        m = N.SpatialConvolution(cin, cin * mult, kw, kh, sw, sh,
                                 _pad_code(attrs), _pad_code(attrs),
                                 n_group=cin, with_bias=False, name=name)
        # (kh,kw,cin,mult) → OIHW with O=cin*mult grouped by input channel
        ww = np.transpose(w, (2, 3, 0, 1)).reshape(cin * mult, 1, kh, kw)
        assign(m.weight, ww)
        return m
    if op == "MatMul":
        w = cns[0]
        if attrs.get("transpose_b"):
            w = w.T
        cin, cout = w.shape
        m = N.Linear(cin, cout, with_bias=False, name=name)
        assign(m.weight, w.T)  # ours is (out, in)
        return m
    if op == "BiasAdd":
        b = cns[0]
        if _is_2d_activation(node, by_name, consts):  # after MatMul: (B, C)
            m = N.CAdd([b.size], name=name)
        else:  # conv activations are NCHW here: bias broadcasts over (C,1,1)
            m = N.CAdd([b.size, 1, 1], name=name)
        assign(m.bias, b)
        return m
    if op in ("Add", "AddV2", "Sub", "Mul") and cns:
        c = cns[0].astype(np.float32)
        if c.size == 1:
            v = float(c.reshape(()))
            if op == "Mul":
                return N.MulConstant(v, name=name)
            return N.AddConstant(-v if op == "Sub" else v, name=name)
        shp = list(c.reshape(-1, 1, 1).shape) if c.ndim == 1 else list(c.shape)
        m = (N.CMul if op == "Mul" else N.CAdd)(shp, name=name)
        key = "weight" if op == "Mul" else "bias"
        assign(getattr(m, key), c.reshape(shp) if op != "Sub" else
                -c.reshape(shp))
        return m
    if op in ("Add", "AddV2"):
        return N.CAddTable(name=name)
    if op == "Sub":
        return N.CSubTable(name=name)
    if op == "Mul":
        return N.CMulTable(name=name)
    if op == "Relu":
        return N.ReLU(name=name)
    if op == "Relu6":
        return N.ReLU6(name=name)
    if op == "Tanh":
        return N.Tanh(name=name)
    if op == "Sigmoid":
        return N.Sigmoid(name=name)
    if op == "Softmax":
        return N.SoftMax(name=name)
    if op in ("MaxPool", "AvgPool"):
        k = attrs.get("ksize", [1, 2, 2, 1])
        if attrs.get("data_format", "NHWC") == "NCHW":
            kh, kw = int(k[2]), int(k[3])
        else:
            kh, kw = int(k[1]), int(k[2])
        sh, sw = _strides_hw(attrs)
        pad = _pad_code(attrs)
        if op == "MaxPool":
            return N.SpatialMaxPooling(kw, kh, sw, sh, pad, pad, name=name)
        return N.SpatialAveragePooling(kw, kh, sw, sh, pad, pad,
                                       count_include_pad=False, name=name)
    if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
        gamma, beta, mean, var = cns[:4]
        eps = attrs.get("epsilon", 1e-3)
        m = N.SpatialBatchNormalization(gamma.size, eps=float(eps), name=name)
        assign(m.weight, gamma)
        assign(m.bias, beta)
        if mean.size:  # frozen inference graph carries moving stats
            assign(m.running_mean, mean)
            assign(m.running_var, var)
        return m
    if op == "Reshape":
        target = [int(x) for x in cns[0].reshape(-1)] if cns else [-1]
        return _TFReshape(target, name=name)
    if op == "Squeeze":
        dims = attrs.get("squeeze_dims", attrs.get("axis"))
        if dims:
            d = sorted(int(x) for x in (dims if isinstance(dims, list)
                                        else [dims]))
            # NHWC spatial squeeze [1,2] → NCHW [2,3]
            if d == [1, 2]:
                return N.Sequential(N.Squeeze(4), N.Squeeze(3), name=name)
        return N.Squeeze(name=name)
    if op in ("Pad", "PadV2"):
        pads = cns[0].reshape(-1, 2)
        if len(pads) == 4:  # NHWC → NCHW
            pads = pads[[0, 3, 1, 2]]
        value = float(cns[1].reshape(())) if len(cns) > 1 else 0.0
        return _TFPad(pads, value, name=name)
    if op in ("ConcatV2", "Concat"):
        axis = int(cns[-1].reshape(())) if cns else -1
        # NHWC channel concat (axis 3 or -1) → NCHW dim 2 (1-based)
        dim = 2 if axis in (3, -1) else axis + 1
        return N.JoinTable(dim, name=name)
    if op == "Mean":
        axes = sorted(int(x) for x in cns[0].reshape(-1)) if cns else []
        if axes == [1, 2]:  # NHWC spatial mean → global average pool
            keep = attrs.get("keep_dims", attrs.get("keepdims", False))
            m = N.SpatialAveragePooling(1, 1, global_pooling=True, name=name)
            if keep:
                return m
            return N.Sequential(m, N.Squeeze(4), N.Squeeze(3), name=name)
        keep = bool(attrs.get("keep_dims", attrs.get("keepdims", False)))
        from .. import ops as _ops
        return _ops.Mean(axis=tuple(axes), keep_dims=keep, name=name)
    m = _convert_op_extended(node, op, attrs, cns, by_name, consts)
    if m is not None:
        return m
    raise NotImplementedError(f"TF op '{op}' (node {name}) not supported; "
                              "supported set in loaders/tensorflow.py")


# NHWC dim → NCHW dim for 4-D activations (this loader builds NCHW graphs)
_NHWC_TO_NCHW = {0: 0, 1: 2, 2: 3, 3: 1, -1: 1}


def _tf_axis(axis: int, ndim_hint: int) -> int:
    """Map a TF NHWC axis to our NCHW layout when the activation is 4-D."""
    if ndim_hint == 4:
        return _NHWC_TO_NCHW.get(axis, axis)
    return axis


class _TFSplit(N.Module):
    """tf Split with NHWC axis semantics: remap to NCHW only when the
    activation is 4-D (this loader's graphs carry NCHW activations)."""

    def __init__(self, num_split, axis, name=None):
        super().__init__(name=name)
        self.num_split, self.axis = num_split, axis

    def call(self, params, x):
        from ..ops.ops import split
        from ..utils.table import Table
        ax = _tf_axis(self.axis, x.dim())
        return Table(*split(x, self.num_split, ax))


class _ConstBinary(N.Module):
    """Binary elementwise op with one baked constant operand (the TF graph
    had a Const input). The constant is a buffer outside the state tree,
    broadcast over (C, 1, 1) on NCHW activations."""

    def __init__(self, fn, const, const_is_lhs=False, name=None):
        super().__init__(name=name)
        self.fn = fn
        self.register_buffer("const", torch.as_tensor(np.asarray(const)),
                             persistent=False)
        self.const_is_lhs = const_is_lhs

    def call(self, params, x):
        c = self.const
        if x.dim() == 4 and c.dim() == 1 and c.shape[0] == x.shape[1]:
            c = c.reshape(-1, 1, 1)  # channel vector on NCHW activations
        return self.fn(c, x) if self.const_is_lhs else self.fn(x, c)


def _convert_op_extended(node, op, attrs, cns, by_name, consts):
    """Round-2 op-set growth toward the reference's nn/ops coverage
    (spark/dl/.../nn/ops/*.scala): elementwise math, comparisons, gather/
    select/tile/strided-slice, batched matmul, resize, split/pack."""
    from .. import ops as OPS2
    from ..ops.ops import take
    name = node["name"]

    simple = {
        "Sqrt": N.Sqrt, "Square": N.Square, "Neg": N.Negative, "Abs": N.Abs,
        "Exp": N.Exp, "Log": N.Log, "Elu": N.ELU, "Softplus": N.SoftPlus,
        "Softsign": N.SoftSign, "LogSoftmax": N.LogSoftMax,
        "Erf": OPS2.Erf, "Erfc": OPS2.Erfc, "Floor": OPS2.Floor,
        "Ceil": OPS2.Ceil, "Round": OPS2.Round, "Rint": OPS2.Rint,
        "Sign": OPS2.Sign, "Expm1": OPS2.Expm1, "Log1p": OPS2.Log1p,
        "IsFinite": OPS2.IsFinite, "IsInf": OPS2.IsInf, "IsNan": OPS2.IsNan,
        "Reciprocal": OPS2.Inv, "Inv": OPS2.Inv,
        "InvertPermutation": OPS2.InvertPermutation,
    }
    if op in simple:
        return simple[op](name=name)
    if op == "Rsqrt":
        return OPS2.TensorOp(lambda t: 1.0 / torch.sqrt(t), name=name)
    if op == "LeakyRelu":
        return N.LeakyReLU(negval=float(attrs.get("alpha", 0.2)), name=name)

    two_input = {
        "Equal": OPS2.Equal, "NotEqual": OPS2.NotEqual,
        "Greater": OPS2.Greater, "GreaterEqual": OPS2.GreaterEqual,
        "Less": OPS2.Less, "LessEqual": OPS2.LessEqual,
        "LogicalAnd": OPS2.LogicalAnd, "LogicalOr": OPS2.LogicalOr,
        "SquaredDifference": OPS2.SquaredDifference, "Pow": OPS2.Pow,
        "FloorDiv": OPS2.FloorDiv, "FloorMod": OPS2.FloorMod,
        "Mod": OPS2.Mod, "TruncateDiv": OPS2.TruncateDiv,
    }
    if op in two_input:
        if cns:  # one side constant
            # work out whether the const was lhs or rhs
            lhs_const = _base_name(node["inputs"][0]) in consts
            cls = two_input[op]
            fn = cls()._op
            return _ConstBinary(fn, cns[0], const_is_lhs=lhs_const, name=name)
        return two_input[op](name=name)
    if op == "LogicalNot":
        return OPS2.LogicalNot(name=name)

    if op in ("RealDiv", "Div", "Maximum", "Minimum"):
        fn = {"RealDiv": torch.true_divide, "Div": torch.true_divide,
              "Maximum": torch.maximum, "Minimum": torch.minimum}[op]
        if cns:
            lhs_const = _base_name(node["inputs"][0]) in consts
            return _ConstBinary(fn, cns[0], const_is_lhs=lhs_const, name=name)
        table = {"RealDiv": N.CDivTable, "Div": N.CDivTable,
                 "Maximum": N.CMaxTable, "Minimum": N.CMinTable}[op]
        return table(name=name)
    if op == "AddN":
        return N.CAddTable(name=name)

    if op == "Cast":
        return OPS2.Cast(_DT_NUMPY.get(attrs.get("DstT", 1), np.float32),
                         name=name)
    if op in ("Gather", "GatherV2"):
        axis = int(cns[-1].reshape(())) if (op == "GatherV2" and
                                            len(cns) > 0 and
                                            cns[-1].size == 1) else 0
        if _base_name(node["inputs"][1]) in consts:
            # constant indices: bake them in, input is params
            idx = torch.from_numpy(np.asarray(cns[0]).astype(np.int32))
            return OPS2.TensorOp(
                lambda t, _i=idx, _a=axis: take(t, _i, _a % t.dim()),
                name=name)
        return OPS2.Gather(axis=axis, name=name)
    if op in ("Select", "SelectV2"):
        return OPS2.Select(name=name)
    if op == "Tile":
        mult = [int(x) for x in cns[0].reshape(-1)]
        return OPS2.Tile(mult, name=name)
    if op == "StridedSlice":
        begin, end, strides = [list(np.asarray(c).reshape(-1).astype(int))
                               for c in cns[:3]]
        return OPS2.StridedSlice(
            begin, end, strides,
            shrink_axis_mask=attrs.get("shrink_axis_mask", 0),
            begin_mask=attrs.get("begin_mask", 0),
            end_mask=attrs.get("end_mask", 0), name=name)
    if op == "ExpandDims":
        return OPS2.ExpandDims(int(cns[0].reshape(())), name=name)
    if op == "Transpose":
        perm = [int(x) for x in cns[0].reshape(-1)]
        return OPS2.TensorOp(
            lambda t, _p=tuple(perm): t.permute(_p), name=name)
    if op == "ArgMax":
        axis = int(cns[0].reshape(())) if cns else 0
        return OPS2.ArgMax(axis=axis, name=name)
    if op == "OneHot":
        depth = int(cns[0].reshape(()))
        on = float(cns[1].reshape(())) if len(cns) > 1 else 1.0
        off = float(cns[2].reshape(())) if len(cns) > 2 else 0.0
        return OPS2.OneHot(depth, on, off, axis=attrs.get("axis", -1),
                           name=name)
    if op in ("BatchMatMul", "BatchMatMulV2"):
        return OPS2.BatchMatMul(adj_x=bool(attrs.get("adj_x", False)),
                                adj_y=bool(attrs.get("adj_y", False)),
                                name=name)
    if op == "ResizeBilinear":
        oh, ow = [int(x) for x in cns[0].reshape(-1)]
        return OPS2.ResizeBilinear(
            oh, ow, align_corners=bool(attrs.get("align_corners", False)),
            data_format="NCHW", name=name)
    if op == "LRN":
        radius = int(attrs.get("depth_radius", 5))
        size = 2 * radius + 1
        # TF alpha is per-element; ours (caffe-style) divides by size
        alpha = float(attrs.get("alpha", 1.0)) * size
        return N.SpatialCrossMapLRN(size, alpha,
                                    float(attrs.get("beta", 0.5)),
                                    float(attrs.get("bias", 1.0)), name=name)
    if op in ("Split", "SplitV"):
        num = int(attrs.get("num_split", 1))
        if op == "Split":
            axis = int(cns[0].reshape(())) if cns else 0
        else:
            axis = int(cns[-1].reshape(())) if cns else 0
        return _TFSplit(num, axis, name=name)
    if op in ("Pack", "Stack"):
        return OPS2.Pack(axis=attrs.get("axis", 0), name=name)
    if op in ("Unpack", "Unstack"):
        return OPS2.Unpack(int(attrs.get("num", 1)),
                           axis=attrs.get("axis", 0), name=name)
    if op == "SegmentSum":
        return OPS2.SegmentSum(name=name)
    if op in ("Sum", "Prod", "Max", "Min", "All", "Any"):
        axes = tuple(int(x) for x in cns[0].reshape(-1)) if cns else None
        keep = bool(attrs.get("keep_dims", attrs.get("keepdims", False)))
        cls = {"Sum": OPS2.Sum, "Prod": OPS2.Prod, "Max": OPS2.Max,
               "Min": OPS2.Min, "All": OPS2.All, "Any": OPS2.Any}[op]
        return cls(axis=axes, keep_dims=keep, name=name)
    if op == "Conv2DBackpropInput":
        # tf.nn.conv2d_transpose (deconv) — reference analog:
        # utils/tf/loaders/Conv2DBackpropInput.scala:30 → SpatialFullConv.
        # inputs: [output_sizes(const), filter(const HWIO, fwd-conv layout:
        # I = deconv OUTPUT channels, O = deconv INPUT channels), activation]
        out_sizes = [int(x) for x in cns[0].reshape(-1)]
        w = cns[1]
        sh, sw = _strides_hw(attrs)
        return _TFDeconv(w, (sh, sw), attrs.get("padding", b"SAME"),
                         out_sizes, name=name)
    if op in ("TopKV2", "TopK"):
        # k is the 2nd input (const) for V2, an attr for V1
        k = int(cns[0].reshape(())) if cns else int(attrs.get("k", 1))
        return OPS2.TopK(k, name=name)
    if op == "RandomShuffle":
        return _TFRandomShuffle(seed=int(attrs.get("seed", 0)), name=name)
    return None


class _TFDeconv(N.Module):
    """Conv2DBackpropInput as a transposed conv, the gradient of TF's
    forward conv. The per-dimension padding is computed from the graph's
    static ``output_sizes`` with TF's own forward-conv padding formula
    (asymmetric SAME included): ``conv_transpose2d`` crops the front pad
    from both ends, the rest of the back pad is cropped after it, and the
    trailing pixels no forward window touches get the zero gradient TF
    gives them. Activations here are NCHW (this loader's layout); the TF
    filter stays HWIO under ``weight`` (I = this op's output channels)."""

    def __init__(self, w_hwio, strides, padding, out_sizes, name=None):
        super().__init__(name=name)
        self._strides = tuple(int(s) for s in strides)
        pad = padding.decode() if isinstance(padding, bytes) else str(padding)
        assert pad in ("SAME", "VALID"), f"deconv padding {pad!r}"
        self._same = pad == "SAME"
        self._out_sizes = out_sizes  # NHWC [n, h, w, c] from the graph
        self.weight = torch.nn.Parameter(torch.from_numpy(
            np.array(w_hwio, np.float32)))

    def call(self, params, x):
        squeeze = False
        if x.dim() == 3:
            x, squeeze = x[None], True
        w = params["weight"]
        kh, kw = w.shape[:2]
        fronts, backs, tails = [], [], []
        for o, i, k, s in zip(self._out_sizes[1:3], x.shape[2:4],
                              (kh, kw), self._strides):
            # TF forward-conv padding for input size o → output size i
            total = max((i - 1) * s + k - o, 0) if self._same else 0
            pl = total // 2
            fronts.append(pl)
            backs.append(total - pl - pl)
            # m = grad size the transposed conv yields; for any TF-valid
            # (o, i) pair m <= o and the o-m tail pixels are untouched by
            # every forward window → zero gradient
            m = (i - 1) * s + k - total
            assert m <= o, (f"deconv output_sizes {o} inconsistent with "
                            f"input {i}, kernel {k}, stride {s}")
            tails.append(o - m)
        y = F.conv_transpose2d(x, w.permute(3, 2, 0, 1).to(x.dtype),
                               stride=self._strides, padding=tuple(fronts))
        y = y[:, :, :y.shape[2] - backs[0], :y.shape[3] - backs[1]]
        if any(tails):
            y = F.pad(y, (0, tails[1], 0, tails[0]))
        assert y.shape[1] == self._out_sizes[3], (
            f"deconv channels {y.shape[1]} != output_sizes "
            f"{self._out_sizes[3]}")
        return y[0] if squeeze else y


class _TFRandomShuffle(N.Module):
    """RandomShuffle (utils/tf/loaders/RandomShuffle.scala): permute along
    dim 0 with the generator given to ``apply`` (training pipelines);
    without one (deterministic inference) it is the identity permutation,
    a valid sample that keeps frozen-graph evaluation reproducible. A
    graph seed draws from a generator seeded with it: the same permutation
    per graph seed (the port's stream, not JAX's)."""

    def __init__(self, seed: int = 0, name=None):
        super().__init__(name=name)
        self._seed = seed

    def apply(self, params, state, x, training=False, generator=None):
        if generator is None:
            return x, state
        if self._seed:  # TF seeded shuffle: same permutation per graph seed
            generator = torch.Generator(device=x.device).manual_seed(
                self._seed)
        perm = torch.randperm(x.shape[0], generator=generator,
                              device=generator.device).to(x.device)
        return x[perm], state


def _is_2d_activation(node, by_name, consts) -> bool:
    """Heuristic: BiasAdd after MatMul acts on (B, C)."""
    for i in node["inputs"]:
        b = _base_name(i)
        if b in by_name and b not in consts:
            return by_name[b]["op"] in ("MatMul", "Identity") and \
                (by_name[b]["op"] != "Identity" or
                 _is_2d_activation(by_name[b], by_name, consts))
    return False


load_tf = load_tf_graph


__all__ = ["parse_graphdef", "load_tf_graph", "load_tf"]
