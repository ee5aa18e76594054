"""Torch7 .t7 serialization reader and writer (counterpart of
``bigdl_tpu/loaders/torchfile.py``).

Parity: reference ``utils/TorchFile.scala`` (Module.loadTorch). Implements
the legacy torch binary format: little-endian records, type tags
(nil/number/string/table/torch-object/boolean), torch.*Tensor /
torch.*Storage payloads, and object memoization by index. Converts common
torch nn modules (Sequential, Linear, SpatialConvolution[MM], ReLU, Tanh,
SpatialMaxPooling, View, Reshape, Dropout, LogSoftMax, …) into bigdl_tpu
modules with weights, and writes them back (``save_torch``).
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

from ..utils import engine
from ._walk import assign, children, conv_geometry, has_bias, host

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8
TYPE_LEGACY_RECUR_FUNCTION = 7

_TENSOR_DTYPES = {
    "torch.DoubleTensor": np.float64, "torch.FloatTensor": np.float32,
    "torch.LongTensor": np.int64, "torch.IntTensor": np.int32,
    "torch.ShortTensor": np.int16, "torch.CharTensor": np.int8,
    "torch.ByteTensor": np.uint8,
}
_STORAGE_DTYPES = {
    "torch.DoubleStorage": np.float64, "torch.FloatStorage": np.float32,
    "torch.LongStorage": np.int64, "torch.IntStorage": np.int32,
    "torch.ShortStorage": np.int16, "torch.CharStorage": np.int8,
    "torch.ByteStorage": np.uint8,
}


class TorchObject:
    def __init__(self, torch_typename, obj):
        self.torch_typename = torch_typename
        self.obj = obj

    def __getitem__(self, k):
        return self.obj.get(k)

    def get(self, k, default=None):
        return self.obj.get(k, default) if isinstance(self.obj, dict) \
            else default

    def __repr__(self):
        return f"TorchObject({self.torch_typename})"


class _Reader:
    def __init__(self, f):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def _read(self, fmt, n):
        return struct.unpack(fmt, self.f.read(n))

    def read_int(self):
        return self._read("<i", 4)[0]

    def read_long(self):
        return self._read("<q", 8)[0]

    def read_double(self):
        return self._read("<d", 8)[0]

    def read_string(self):
        n = self.read_int()
        return self.f.read(n).decode("utf-8", "replace")

    def read_object(self):
        typeidx = self.read_int()
        if typeidx == TYPE_NIL:
            return None
        if typeidx == TYPE_NUMBER:
            return self.read_double()
        if typeidx == TYPE_BOOLEAN:
            return self.read_int() == 1
        if typeidx == TYPE_STRING:
            return self.read_string()
        if typeidx in (TYPE_TABLE, TYPE_TORCH, TYPE_FUNCTION,
                       TYPE_RECUR_FUNCTION, TYPE_LEGACY_RECUR_FUNCTION):
            index = self.read_int()
            if index in self.memo:
                return self.memo[index]
            if typeidx == TYPE_TORCH:
                version = self.read_string()
                if version.startswith("V "):
                    class_name = self.read_string()
                else:
                    class_name = version
                return self._read_torch(index, class_name)
            if typeidx == TYPE_TABLE:
                return self._read_table(index)
            # functions: skip dumped bytecode, read upvalues table
            n = self.read_int()
            self.f.read(n)
            self.memo[index] = None
            self.read_object()
            return None
        raise ValueError(f"unknown type index {typeidx}")

    def _read_torch(self, index, class_name):
        if class_name in _TENSOR_DTYPES:
            ndim = self.read_int()
            sizes = [self.read_long() for _ in range(ndim)]
            strides = [self.read_long() for _ in range(ndim)]
            offset = self.read_long() - 1
            placeholder = {}
            self.memo[index] = placeholder
            storage = self.read_object()
            if storage is None or ndim == 0:
                arr = np.zeros(sizes, _TENSOR_DTYPES[class_name])
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=sizes,
                    strides=[s * storage.dtype.itemsize for s in strides]
                ).copy()
            self.memo[index] = arr
            return arr
        if class_name in _STORAGE_DTYPES:
            size = self.read_long()
            dt = _STORAGE_DTYPES[class_name]
            arr = np.frombuffer(self.f.read(size * np.dtype(dt).itemsize),
                                dtype=dt)
            self.memo[index] = arr
            return arr
        # generic torch class: payload is a table (or custom via read())
        placeholder = TorchObject(class_name, {})
        self.memo[index] = placeholder
        payload = self.read_object()
        placeholder.obj = payload if payload is not None else {}
        return placeholder

    def _read_table(self, index):
        size = self.read_int()
        tbl: Dict[Any, Any] = {}
        self.memo[index] = tbl
        for _ in range(size):
            k = self.read_object()
            v = self.read_object()
            if isinstance(k, float) and k.is_integer():
                k = int(k)
            tbl[k] = v
        return tbl


def _read_t7(path: str):
    """A .t7 file as python objects, its tensors as numpy arrays."""
    with open(path, "rb") as f:
        return _Reader(f).read_object()


def _to_device(obj, dev, seen):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj, copy=True)).to(dev)
    if id(obj) in seen:                   # memoized (shared) objects
        return seen[id(obj)]
    if isinstance(obj, dict):
        out = seen[id(obj)] = {}
        for k, v in obj.items():
            out[k] = _to_device(v, dev, seen)
        return out
    if isinstance(obj, TorchObject):
        out = seen[id(obj)] = TorchObject(obj.torch_typename, None)
        out.obj = _to_device(obj.obj, dev, seen)
        return out
    return obj


def load_t7(path: str, device=None):
    """Read a .t7 file into python objects, its tensors as torch tensors
    on ``device`` (the CUDA device by default; ``"cpu"`` for the CPU)."""
    dev = engine.resolve_device(device)
    return _to_device(_read_t7(path), dev, {})


# ---------------------------------------------------------------------------
# torch nn → port module conversion
# ---------------------------------------------------------------------------
def _to_module(obj):
    from .. import nn as N
    if not isinstance(obj, TorchObject):
        raise ValueError(f"not a torch module: {obj}")
    t = obj.torch_typename
    g = obj.get

    def set_params(m, **kw):
        for k, v in kw.items():
            if v is not None:
                assign(getattr(m, k), v)
        return m

    def fill_container(cont):
        mods = g("modules", {})
        for i in sorted(k for k in mods if isinstance(k, int)):
            cont.add(_to_module(mods[i]))
        return cont

    if t in ("nn.Sequential",):
        return fill_container(N.Sequential())
    if t == "nn.Concat":
        return fill_container(N.Concat(int(g("dimension", 2))))
    if t == "nn.ConcatTable":
        return fill_container(N.ConcatTable())
    if t == "nn.ParallelTable":
        return fill_container(N.ParallelTable())
    if t == "nn.CAddTable":
        return N.CAddTable()
    if t == "nn.JoinTable":
        return N.JoinTable(int(g("dimension", 2)),
                           int(g("nInputDims", -1) or -1))
    if t == "nn.LeakyReLU":
        return N.LeakyReLU(float(g("negval", 0.01)))
    if t == "nn.Threshold":
        return N.Threshold(float(g("threshold", 1e-6)), float(g("val", 0.0)))
    if t == "nn.SpatialCrossMapLRN":
        return N.SpatialCrossMapLRN(int(g("size", 5)),
                                    float(g("alpha", 1.0)),
                                    float(g("beta", 0.75)),
                                    float(g("k", 1.0)))
    if t == "nn.SpatialZeroPadding":
        return N.SpatialZeroPadding(int(g("pad_l", 0)), int(g("pad_r", 0)),
                                    int(g("pad_t", 0)), int(g("pad_b", 0)))
    if t == "nn.BatchNormalization":
        w = g("weight")
        n = int(g("nOutput", w.shape[0] if w is not None else 0))
        m = N.BatchNormalization(n, float(g("eps", 1e-5)),
                                 float(g("momentum", 0.1)),
                                 affine=w is not None)
        m = set_params(m, weight=w, bias=g("bias"))
        if g("running_mean") is not None:
            set_params(m, running_mean=g("running_mean"),
                       running_var=g("running_var"))
        return m
    if t in ("nn.Sequencer", "nn.Recurrent"):
        inner = g("module") or g("rnn")
        return N.Recurrent(_to_module(inner))
    if t == "nn.LSTM":
        # Element-Research-style record: torch Linear layout (out, in) for
        # i2g/o2g; gate chunk order (i, f, g, o) — bigdl_tpu LSTM layout
        # transposed. Fixture/round-trip format (TorchFile.scala analog has
        # no LSTM at all; this extends the set).
        isize = int(g("inputSize"))
        hsize = int(g("outputSize", g("hiddenSize", 0)) or g("hiddenSize"))
        m = N.LSTM(isize, hsize)
        w_i = g("i2g_weight")
        w_h = g("o2g_weight")
        b = g("i2g_bias")
        return set_params(m, w_i=None if w_i is None else w_i.T,
                          w_h=None if w_h is None else w_h.T, bias=b)
    if t == "nn.Linear":
        w, b = g("weight"), g("bias")
        m = N.Linear(w.shape[1], w.shape[0], with_bias=b is not None)
        return set_params(m, weight=w, bias=b)
    if t in ("nn.SpatialConvolution", "nn.SpatialConvolutionMM"):
        w = g("weight")
        nout = int(g("nOutputPlane"))
        nin = int(g("nInputPlane"))
        kw_, kh = int(g("kW")), int(g("kH"))
        m = N.SpatialConvolution(nin, nout, kw_, kh, int(g("dW", 1)),
                                 int(g("dH", 1)), int(g("padW", 0)),
                                 int(g("padH", 0)))
        return set_params(m, weight=w.reshape(nout, nin, kh, kw_),
                          bias=g("bias"))
    if t == "nn.SpatialMaxPooling":
        m = N.SpatialMaxPooling(int(g("kW")), int(g("kH")), int(g("dW", 1)),
                                int(g("dH", 1)), int(g("padW", 0)),
                                int(g("padH", 0)))
        if g("ceil_mode"):
            m.ceil()
        return m
    if t == "nn.SpatialAveragePooling":
        return N.SpatialAveragePooling(int(g("kW")), int(g("kH")),
                                       int(g("dW", 1)), int(g("dH", 1)),
                                       int(g("padW", 0)), int(g("padH", 0)),
                                       ceil_mode=bool(g("ceil_mode")))
    if t == "nn.ReLU":
        return N.ReLU()
    if t == "nn.Tanh":
        return N.Tanh()
    if t == "nn.Sigmoid":
        return N.Sigmoid()
    if t == "nn.LogSoftMax":
        return N.LogSoftMax()
    if t == "nn.SoftMax":
        return N.SoftMax()
    if t == "nn.Dropout":
        return N.Dropout(float(g("p", 0.5)))
    if t == "nn.View":
        sizes = g("size")
        if isinstance(sizes, np.ndarray):
            sizes = [int(s) for s in sizes]
        return N.View(sizes)
    if t == "nn.Reshape":
        sizes = g("size")
        if isinstance(sizes, np.ndarray):
            sizes = [int(s) for s in sizes]
        return N.Reshape(sizes)
    if t == "nn.Identity":
        return N.Identity()
    if t == "nn.SpatialBatchNormalization":
        w = g("weight")
        n = int(g("nOutput", w.shape[0] if w is not None else 0))
        m = N.SpatialBatchNormalization(n, float(g("eps", 1e-5)),
                                        float(g("momentum", 0.1)),
                                        affine=w is not None)
        m = set_params(m, weight=w, bias=g("bias"))
        if g("running_mean") is not None:
            set_params(m, running_mean=g("running_mean"),
                       running_var=g("running_var"))
        return m
    raise ValueError(f"unsupported torch module {t}")


def load_torch(path: str, device=None):
    """Module.loadTorch parity — read a .t7 model file and convert; the
    model's tensors go to ``device`` (the CUDA device by default;
    ``"cpu"`` for the CPU)."""
    dev = engine.resolve_device(device)
    return _to_module(_read_t7(path)).to(dev)


# ---------------------------------------------------------------------------
# Torch7 .t7 serialization writer (save side)
# Parity: reference ``utils/TorchFile.scala`` saveTorch / Module.saveTorch.
# ---------------------------------------------------------------------------

_DTYPE_TENSOR_NAMES = {
    np.dtype(np.float64): ("torch.DoubleTensor", "torch.DoubleStorage"),
    np.dtype(np.float32): ("torch.FloatTensor", "torch.FloatStorage"),
    np.dtype(np.int64): ("torch.LongTensor", "torch.LongStorage"),
    np.dtype(np.int32): ("torch.IntTensor", "torch.IntStorage"),
    np.dtype(np.int16): ("torch.ShortTensor", "torch.ShortStorage"),
    np.dtype(np.int8): ("torch.CharTensor", "torch.CharStorage"),
    np.dtype(np.uint8): ("torch.ByteTensor", "torch.ByteStorage"),
}


class _Writer:
    def __init__(self, f):
        self.f = f
        self._next_index = 1

    def _fresh(self):
        i = self._next_index
        self._next_index += 1
        return i

    def write_int(self, v):
        self.f.write(struct.pack("<i", int(v)))

    def write_long(self, v):
        self.f.write(struct.pack("<q", int(v)))

    def write_double(self, v):
        self.f.write(struct.pack("<d", float(v)))

    def write_string(self, s):
        b = s.encode("utf-8")
        self.write_int(len(b))
        self.f.write(b)

    def write_object(self, v):
        if v is None:
            self.write_int(TYPE_NIL)
        elif isinstance(v, bool):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(1 if v else 0)
        elif isinstance(v, (int, float)):
            self.write_int(TYPE_NUMBER)
            self.write_double(v)
        elif isinstance(v, str):
            self.write_int(TYPE_STRING)
            self.write_string(v)
        elif isinstance(v, np.ndarray) or torch.is_tensor(v):
            self._write_tensor(host(v))
        elif isinstance(v, TorchObject):
            self.write_int(TYPE_TORCH)
            self.write_int(self._fresh())
            self.write_string("V 1")
            self.write_string(v.torch_typename)
            self.write_object(v.obj)
        elif isinstance(v, dict):
            self.write_int(TYPE_TABLE)
            self.write_int(self._fresh())
            self.write_int(len(v))
            for k, val in v.items():
                self.write_object(k)
                self.write_object(val)
        else:
            raise TypeError(f"t7 writer: unsupported type {type(v)}")

    def _write_tensor(self, arr):
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _DTYPE_TENSOR_NAMES:
            arr = arr.astype(np.float32)
        tname, sname = _DTYPE_TENSOR_NAMES[arr.dtype]
        self.write_int(TYPE_TORCH)
        self.write_int(self._fresh())
        self.write_string("V 1")
        self.write_string(tname)
        self.write_int(arr.ndim)
        for d in arr.shape:
            self.write_long(d)
        # contiguous strides in elements
        stride = 1
        strides = []
        for d in reversed(arr.shape):
            strides.append(stride)
            stride *= d
        for s in reversed(strides):
            self.write_long(s)
        self.write_long(1)  # storage offset (1-based)
        # storage
        self.write_int(TYPE_TORCH)
        self.write_int(self._fresh())
        self.write_string("V 1")
        self.write_string(sname)
        self.write_long(arr.size)
        self.f.write(arr.tobytes())


def save_t7(obj, path: str) -> None:
    """Write python objects (numpy arrays and tensors, from any device, as
    torch tensors) to a .t7 file."""
    with open(path, "wb") as f:
        _Writer(f).write_object(obj)


def _np(v):
    return None if v is None else host(v).astype(np.float32)


def _from_module(m):
    """bigdl_tpu module → TorchObject tree the legacy format understands."""
    from .. import nn as N
    t = type(m).__name__

    def container_obj(tname, extra=None):
        mods = {}
        for i, child in enumerate(children(m)):
            mods[i + 1] = _from_module(child)
        obj = {"modules": mods}
        if extra:
            obj.update(extra)
        return TorchObject(tname, obj)

    if isinstance(m, N.Sequential):
        return container_obj("nn.Sequential")
    if isinstance(m, N.Concat):
        return container_obj("nn.Concat", {"dimension": m.dimension})
    if isinstance(m, N.ConcatTable):
        return container_obj("nn.ConcatTable")
    if isinstance(m, N.ParallelTable):
        return container_obj("nn.ParallelTable")
    if isinstance(m, N.CAddTable):
        return TorchObject("nn.CAddTable", {})
    if isinstance(m, N.JoinTable):
        return TorchObject("nn.JoinTable", {"dimension": m.dimension,
                                            "nInputDims": m.n_input_dims})
    if isinstance(m, N.LeakyReLU):
        return TorchObject("nn.LeakyReLU", {"negval": float(m.negval)})
    if type(m) is N.Threshold:
        return TorchObject("nn.Threshold", {"threshold": float(m.th),
                                            "val": float(m.v)})
    if isinstance(m, N.SpatialCrossMapLRN):
        return TorchObject("nn.SpatialCrossMapLRN", {
            "size": m.size, "alpha": float(m.alpha),
            "beta": float(m.beta), "k": float(m.k)})
    if isinstance(m, N.SpatialZeroPadding):
        return TorchObject("nn.SpatialZeroPadding", {
            "pad_l": m.l, "pad_r": m.r, "pad_t": m.t, "pad_b": m.b})
    if isinstance(m, N.Recurrent):
        cell_obj = _from_module(m.cell)
        return TorchObject("nn.Sequencer", {"module": cell_obj})
    if type(m) is N.LSTM:
        # torch Linear layout (out, in); gate order (i, f, g, o)
        obj = {"inputSize": m.input_size, "hiddenSize": m.hidden_size,
               "outputSize": m.hidden_size,
               "i2g_weight": _np(m.w_i).T.copy(),
               "o2g_weight": _np(m.w_h).T.copy(),
               "i2g_bias": _np(m.bias).reshape(-1)}
        return TorchObject("nn.LSTM", obj)
    if type(m) is N.Linear:
        obj = {"weight": _np(m.weight)}
        if has_bias(m):
            obj["bias"] = _np(m.bias).reshape(-1)
        return TorchObject("nn.Linear", obj)
    if isinstance(m, N.SpatialConvolution):
        if m.n_group != 1:
            raise NotImplementedError("t7 export: grouped conv unsupported")
        if tuple(m.dilation) != (1, 1):
            raise NotImplementedError("t7 export: dilated conv has no "
                                      "legacy-torch analog")
        if getattr(m, "format", "NCHW") != "NCHW":
            raise NotImplementedError("t7 export: NHWC conv unsupported "
                                      "(legacy torch is NCHW-only)")
        (kh, kw), (sh, sw), (ph, pw) = conv_geometry(m)
        obj = {"weight": _np(m.weight),
               "nOutputPlane": m.n_output_plane,
               "nInputPlane": m.n_input_plane,
               "kW": kw, "kH": kh,
               "dW": sw, "dH": sh,
               "padW": pw, "padH": ph}
        if has_bias(m):
            obj["bias"] = _np(m.bias).reshape(-1)
        return TorchObject("nn.SpatialConvolution", obj)
    if isinstance(m, (N.SpatialMaxPooling, N.SpatialAveragePooling)):
        if getattr(m, "format", "NCHW") != "NCHW":
            raise NotImplementedError("t7 export: NHWC pooling unsupported "
                                      "(legacy torch is NCHW-only)")
    if isinstance(m, N.SpatialMaxPooling):
        return TorchObject("nn.SpatialMaxPooling", {
            "kW": m.kw, "kH": m.kh, "dW": m.dw, "dH": m.dh,
            "padW": m.pad_w, "padH": m.pad_h,
            "ceil_mode": bool(getattr(m, "ceil_mode", False))})
    if isinstance(m, N.SpatialAveragePooling):
        if getattr(m, "global_pooling", False):
            raise NotImplementedError("t7 export: global average pooling "
                                      "has no legacy-torch analog — use an "
                                      "explicit kernel size")
        if not getattr(m, "count_include_pad", True):
            raise NotImplementedError("t7 export: count_include_pad=False "
                                      "unsupported")
        return TorchObject("nn.SpatialAveragePooling", {
            "kW": m.kw, "kH": m.kh, "dW": m.dw, "dH": m.dh,
            "padW": m.pad_w, "padH": m.pad_h,
            "ceil_mode": bool(getattr(m, "ceil_mode", False))})
    if isinstance(m, N.BatchNormalization):
        obj = {"nOutput": m.n_output, "eps": float(m.eps),
               "momentum": float(m.momentum),
               "running_mean": _np(m.running_mean),
               "running_var": _np(m.running_var)}
        if m.weight is not None:
            obj["weight"] = _np(m.weight)
            obj["bias"] = _np(m.bias)
        tname = ("nn.SpatialBatchNormalization"
                 if isinstance(m, N.SpatialBatchNormalization)
                 else "nn.BatchNormalization")
        return TorchObject(tname, obj)
    simple = {"ReLU": "nn.ReLU", "Tanh": "nn.Tanh", "Sigmoid": "nn.Sigmoid",
              "LogSoftMax": "nn.LogSoftMax", "SoftMax": "nn.SoftMax",
              "Identity": "nn.Identity"}
    if t in simple:
        return TorchObject(simple[t], {})
    if isinstance(m, N.Dropout):
        return TorchObject("nn.Dropout", {"p": float(m.p)})
    if isinstance(m, N.View):
        return TorchObject("nn.View",
                           {"size": np.asarray(m.sizes, np.int64)})
    if isinstance(m, N.Reshape):
        return TorchObject("nn.Reshape",
                           {"size": np.asarray(m.size, np.int64)})
    raise NotImplementedError(f"t7 export: module {t} unsupported")


def save_torch(model, path: str) -> None:
    """Module.saveTorch parity — write a model as a legacy torch .t7 file.

    Round trip: ``load_torch(path)`` rebuilds the model with identical
    outputs. Covers the same module set the reader converts.
    """
    save_t7(_from_module(model), path)


__all__ = ["TorchObject", "load_t7", "load_torch", "save_t7", "save_torch"]
