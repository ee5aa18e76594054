"""bigdl.proto-compatible module serializer (counterpart of
``bigdl_tpu/loaders/bigdl_proto.py``).

Parity: reference ``utils/serializer`` (``ModuleSerializer`` /
``ModuleLoader.loadFromFile`` / ``module.saveModule``), whose on-disk form is
a raw ``BigDLModule`` protobuf (``spark/dl/src/main/resources/serialization/
bigdl.proto``) written via ``File.saveBytes`` — no extra framing. This module
reads and writes that wire format directly (loaders/wire.py primitives, no
protoc), so checkpoints cross-load between the reference, the JAX package
and the port for the common layer set.

Field numbers (bigdl.proto):
- BigDLModule: name=1, subModules=2, weight=3, bias=4, preModules=5,
  nextModules=6, moduleType=7, attr=8(map), version=9, train=10,
  namePostfix=11, id=12, inputShape=13, outputShape=14, hasParameters=15,
  parameters=16.
- BigDLTensor: datatype=1, size=2, stride=3, offset=4, dimension=5,
  nElements=6, isScalar=7, storage=8, id=9, tensorType=10.
- TensorStorage: datatype=1, float_data=2, double_data=3, bool_data=4,
  string_data=5, int_data=6, long_data=7, bytes_data=8, id=9.
- AttrValue: dataType=1, subType=2, oneof value: int32=3, int64=4, float=5,
  double=6, string=7, bool=8, regularizer=9, tensor=10, varFormat=11,
  initMethod=12, module=13, nameAttrList=14, array=15, dataFormat=16,
  custom=17, shape=18.

Storage sharing matches the reference: the first occurrence of a storage id
carries the data; later references carry only the id.

Two tiers, as in the JAX package:

1. **Reference-compatible tier** (``_SAVE_TYPES``): the common layer set is
   written with Scala class names and ctor-param attrs.
2. **Generic native tier** (everything else): ``moduleType`` is
   ``bigdl_tpu::<the JAX package's module path>.<ClassName>`` — the port
   writes the JAX package's names, so a file of the typed tiers is the same
   bytes from either package, and maps a ``bigdl_tpu.`` path onto its
   ``bigdl_tpu_torch.`` twin by string on load (it never imports
   ``bigdl_tpu``). The configuration is stored as typed ``cfg:`` attrs in
   the JAX module's attribute order (``_JAX_CONFIG`` where the port's
   modules keep theirs in another order or shape); the parameter / state
   trees as dtype-preserving ``param:<path>`` / ``state:<path>`` tensor
   attrs. int8 / uint8 / bf16 / f16 tensors use the extension datatypes
   100-103 (bf16 and f16 travel as float32 values, exactly; a bf16 leaf
   loads as a ``torch.bfloat16`` tensor). A quantized weight carrier
   (``utils.carrier.TreeCarrier``) in a tree is written as its children
   under ``<path>/[i]`` plus a ``paramC:`` / ``stateC:`` attr naming its
   kind (the port's own form; JAX pickles its carriers).

Loading builds the port's module from the config (its constructor, with
the config's values for the parameters it names, on the CPU or, where the
constructor takes one, on ``device``), copies the trees into it (a leaf
keeps the file's dtype) and moves it to ``device``.

Trust model: the generic tier's pickled-config fallback (``cfg_pickle``,
``cfgp:``, ``param_pickle``) runs the pickle VM on load. By default
``load_bigdl`` uses a restricted unpickler that resolves the port's classes
(``bigdl_tpu_torch``), numpy's array reconstruction, a few builtins and
torch's tensor rebuilds, and refuses every other global (``os.system``,
``builtins.eval``, ...). A pickle written by the JAX package is read only
as far as it holds data: its array reconstruction
(``jax._src.array._reconstruct_array``) becomes a numpy array; a class or
function of ``bigdl_tpu``, ``jax`` or ``ml_dtypes`` is refused with an
error that names it (the port does not import them; re-save the model in
the typed tiers, or carry its weights over with ``convert``).
``allow_pickle=False`` refuses pickled attrs outright;
``allow_pickle="unsafe"`` is raw pickle for trusted port-written files.

Plain containers in either tier store children as ``subModules`` (field 2),
so a Sequential can mix reference-compatible and native-only layers.
"""
from __future__ import annotations

import contextvars
import importlib
import inspect
import io
import pickle
import struct
import sys
from typing import Dict, List

import numpy as np
import torch

from .. import nn as N
from ..nn.module import Container, Criterion, Module
from ..utils import engine
from ..utils.carrier import TreeCarrier
from ._walk import host
from .wire import (field_bytes, field_string, field_varint, field_double,
                   field_packed_double, field_packed_varint, iter_fields,
                   to_signed, unpack_packed)

_SCALA_NN = "com.intel.analytics.bigdl.nn."

# AttrValue DataType enum values (bigdl.proto)
_DT_INT32, _DT_INT64, _DT_FLOAT, _DT_DOUBLE = 0, 1, 2, 3
_DT_STRING, _DT_BOOL = 4, 5
_DT_REGULARIZER, _DT_TENSOR, _DT_MODULE = 9, 10, 13
_DT_ARRAY = 15

# native datatype extension values (outside the reference enum range) —
# only emitted by the generic tier, never on reference-compatible layers
_NDT_INT8, _NDT_UINT8, _NDT_BF16, _NDT_F16 = 100, 101, 102, 103
# Generic-tier float64 (decodes back to f64; the reference DOUBLE enum value
# keeps its historical load-as-f32 behavior for reference checkpoints).
_NDT_F64 = 104

_JAX_PACKAGES = {"bigdl_tpu", "jax", "jaxlib", "ml_dtypes"}


def _array_from_jax(fun, args, arr_state, aval_state):
    """A JAX-pickled array (``jax._src.array._reconstruct_array``) as the
    numpy array it carries."""
    arr = fun(*args)
    arr.__setstate__(arr_state)
    return arr


class _RestrictedUnpickler(pickle.Unpickler):
    """Default unpickler for .bigdl payloads: resolves the port's own
    classes, plus user-defined Module/Criterion subclasses from
    already-imported modules (the generic tier's out-of-package
    capability), numpy's reconstruction surface and torch's tensor
    rebuilds. Everything else — os.system, subprocess.*, builtins.eval,
    numpy's exec-style test helpers, arbitrary callables a pickle REDUCE
    could invoke — raises UnpicklingError, and so does every class or
    function of the JAX package and its dependencies (their arrays alone
    are mapped to numpy). Restricted mode blocks code execution; it does
    not make a malicious file fully safe to load — use allow_pickle=False
    where the typed tiers suffice."""
    _OPEN_PACKAGES = {"bigdl_tpu_torch"}
    # numpy is NOT open (numpy.testing._private.utils.runstring is exec):
    # only the reconstruction surface pickle actually emits
    _EXACT = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.numeric", "_frombuffer"),
        ("numpy._core.numeric", "_frombuffer"),
        ("numpy", "ndarray"), ("numpy", "dtype"),
        ("builtins", "complex"), ("builtins", "set"),
        ("builtins", "frozenset"), ("builtins", "slice"),
        ("builtins", "range"), ("builtins", "bytearray"),
        ("builtins", "object"), ("collections", "OrderedDict"),
        ("functools", "partial"), ("copyreg", "_reconstructor"),
        # a module's tensors, stripped to the meta device (no storage)
        ("torch._utils", "_rebuild_meta_tensor_no_storage"),
        ("torch._utils", "_rebuild_parameter"),
        ("torch", "Size"), ("torch", "device"),
        ("types", "SimpleNamespace"),
    }
    # numpy scalar types (np.float32, ...), numpy.dtypes dtype classes,
    # and the umath modules where ufuncs (np.add, ...) live
    _NUMPY_TYPE_MODULES = {"numpy", "numpy.dtypes",
                           "numpy.core._multiarray_umath",
                           "numpy._core._multiarray_umath"}

    def _refuse(self, module, name, why=""):
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} from a .bigdl file"
            f"{why}; only bigdl_tpu_torch/numpy-array names and "
            "Module/Criterion subclasses from already-imported modules are "
            "allowed. If the file is trusted, pass allow_pickle='unsafe' "
            "to load_bigdl.")

    def _resolve(self, module, name):
        """Like CPython's find_class, but every step of a dotted name —
        including the final object — must be a CLASS: module attributes
        (the protocol-4 STACK_GLOBAL 'pickle.loads' re-export bypass) and
        methods (Module.load is raw pickle on an attacker path) are both
        out."""
        obj = super().find_class(module, name.partition(".")[0])
        for part in name.split(".")[1:]:
            if not isinstance(obj, type):
                self._refuse(module, name,
                             " (dotted name traverses a non-class)")
            obj = getattr(obj, part)
        return obj

    def find_class(self, module, name):
        top = module.partition(".")[0]
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _array_from_jax
        if top in _JAX_PACKAGES:
            raise pickle.UnpicklingError(
                f"{module}.{name}: this .bigdl file pickles an object of "
                f"the JAX package (bigdl_tpu / jax / ml_dtypes), which the "
                f"port does not import; re-save the model so that its "
                f"configuration is typed, or carry its weights over with "
                f"bigdl_tpu_torch.convert")
        if (module, name) in self._EXACT:
            return super().find_class(module, name)
        if module == "torch" and "." not in name:
            obj = super().find_class(module, name)
            if isinstance(obj, torch.dtype):
                return obj
            self._refuse(module, name, " (not a dtype)")
        if (module in self._NUMPY_TYPE_MODULES and "." not in name):
            obj = super().find_class(module, name)
            # scalar/dtype types and ufuncs (data-only callables a config
            # like TableOperation(np.add) legitimately references) — but
            # NOT e.g. np.memmap, an arbitrary file-write primitive
            if (isinstance(obj, type)
                    and issubclass(obj, (np.generic, np.dtype))) \
                    or isinstance(obj, np.ufunc):
                return obj
            self._refuse(module, name, " (not a scalar/dtype type/ufunc)")
        if top in self._OPEN_PACKAGES:
            obj = self._resolve(module, name)
            # CLASSES only: the package's own loader entry points
            # (load_bigdl, Module.load) are REDUCE-invocable file
            # primitives, and a MODULE object would let BUILD rewrite
            # package globals.
            if not isinstance(obj, type):
                self._refuse(module, name, " (not a class)")
            # block foreign re-exports (e.g. `subprocess.Popen` imported
            # inside an open-package module) from laundering through the
            # package whitelist
            owner = getattr(obj, "__module__", None) or ""
            if owner.partition(".")[0] not in (
                    self._OPEN_PACKAGES | {"numpy"}):
                self._refuse(module, name, " (foreign re-export)")
            return obj
        # out-of-package Module/Criterion subclasses: only from modules the
        # process has already imported (no import side effects on behalf of
        # the attacker)
        if module in sys.modules:
            obj = self._resolve(module, name)
            if isinstance(obj, type) and issubclass(obj,
                                                    (Module, Criterion)):
                return obj
        self._refuse(module, name)


# per-call pickle policy, set by load_bigdl: "restricted" (default),
# False (refuse pickled attrs), or "unsafe" (raw pickle.loads).
# ContextVar so concurrent load_bigdl calls on different threads can't
# leak one caller's 'unsafe' into another's default-restricted load.
_PICKLE_MODE = contextvars.ContextVar("bigdl_pickle_mode",
                                      default="restricted")


def _loads(data: bytes):
    mode = _PICKLE_MODE.get()
    if mode == "unsafe":
        return pickle.loads(data)
    if mode is False:
        raise ValueError(
            "this .bigdl file carries pickled attrs, refused because "
            "load_bigdl(..., allow_pickle=False); reference-compatible "
            "files never need pickle — re-save the model or pass "
            "allow_pickle=True (restricted) / 'unsafe'")
    return _RestrictedUnpickler(io.BytesIO(data)).load()


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


class _Ids:
    def __init__(self):
        self.next = 1

    def take(self):
        v = self.next
        self.next += 1
        return v


_TORCH_DT = {torch.int8: _NDT_INT8, torch.uint8: _NDT_UINT8,
             torch.bfloat16: _NDT_BF16, torch.float16: _NDT_F16,
             torch.int32: _DT_INT32, torch.int16: _DT_INT32,
             torch.int64: _DT_INT64, torch.bool: _DT_BOOL,
             torch.float64: _DT_DOUBLE}


def _tensor_datatype(a) -> int:
    """The storage datatype of a tensor or a numpy array."""
    if torch.is_tensor(a):
        return _TORCH_DT.get(a.dtype, _DT_FLOAT)
    dtype = np.dtype(a.dtype)
    if dtype == np.int8:
        return _NDT_INT8
    if dtype == np.uint8:
        return _NDT_UINT8
    if dtype == np.float16:
        return _NDT_F16
    if dtype == np.int32 or dtype == np.int16:
        return _DT_INT32
    if dtype == np.int64:
        return _DT_INT64
    if dtype == np.bool_:
        return _DT_BOOL
    if dtype == np.float64:
        return _DT_DOUBLE
    return _DT_FLOAT


def _flat(a) -> np.ndarray:
    """A tensor or array as a flat host numpy array; bfloat16 and float16
    as float32, which holds them exactly (how the wire carries them)."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        a = a.numpy()
    return np.asarray(a).ravel()


def _enc_storage(data, sid: int, keep_dtype: bool = False) -> bytes:
    dt = _tensor_datatype(data)
    if dt == _DT_DOUBLE and keep_dtype:
        dt = _NDT_F64          # generic tier: f64 must round-trip exactly
    out = field_varint(1, dt)
    flat = _flat(data)
    if dt in (_NDT_INT8, _NDT_UINT8):
        out += field_bytes(8, flat.tobytes())
    elif dt == _DT_INT32:
        out += field_packed_varint(6, [int(v) for v in flat])
    elif dt == _DT_INT64:
        out += field_packed_varint(7, [int(v) for v in flat])
    elif dt == _DT_BOOL:
        out += field_packed_varint(4, [int(v) for v in flat])
    elif dt in (_DT_DOUBLE, _NDT_F64):
        out += field_bytes(3, np.ascontiguousarray(flat, "<f8").tobytes())
    else:  # FLOAT / BF16 / F16 all travel as f32 floats (exact supersets)
        out += field_bytes(2, np.ascontiguousarray(
            flat, "<f4").tobytes())
    out += field_varint(9, sid)
    return out


def _enc_tensor(arr, ids: _Ids, keep_dtype: bool = False) -> bytes:
    if not keep_dtype:
        arr = arr.detach().float() if torch.is_tensor(arr) else \
            np.asarray(arr, np.float32)
    elif not torch.is_tensor(arr):
        arr = np.asarray(arr)
    sizes = list(arr.shape)
    strides = [int(np.prod(sizes[i + 1:])) for i in range(len(sizes))]
    dt = _tensor_datatype(arr)
    if dt == _DT_DOUBLE and keep_dtype:
        dt = _NDT_F64
    numel = int(np.prod(sizes)) if sizes else 1
    out = field_varint(1, dt)
    for s in sizes:
        out += field_varint(2, s)
    for s in strides:
        out += field_varint(3, s)
    out += field_varint(4, 1)            # torch-style 1-based storage offset
    out += field_varint(5, len(sizes))
    out += field_varint(6, numel)
    if len(sizes) == 0:
        out += field_varint(7, 1)        # isScalar
    out += field_bytes(8, _enc_storage(arr, ids.take(), keep_dtype))
    out += field_varint(9, ids.take())
    return out


def _attr(dt: int, body: bytes = b"") -> bytes:
    return field_varint(1, dt) + body


def _attr_i32(v: int) -> bytes:
    return _attr(_DT_INT32, field_varint(3, int(v)))  # write_varint handles <0


def _attr_double(v: float) -> bytes:
    return _attr(_DT_DOUBLE, field_double(6, float(v)))


def _attr_bool(v: bool) -> bytes:
    return _attr(_DT_BOOL, field_varint(8, 1 if v else 0))


def _attr_null_reg() -> bytes:
    return _attr(_DT_REGULARIZER)


def _attr_null_tensor() -> bytes:
    return _attr(_DT_TENSOR)


def _attr_tensor(arr: np.ndarray, ids: "_Ids") -> bytes:
    return _attr(_DT_TENSOR, field_bytes(10, _enc_tensor(arr, ids)))


def _attr_i32_array(vals) -> bytes:
    body = field_varint(1, len(vals)) + field_varint(2, _DT_INT32)
    body += field_packed_varint(3, [int(v) for v in vals])  # packed i32
    return _attr(_DT_ARRAY, field_bytes(15, body))


def _map_entry(key: str, attr_bytes: bytes) -> bytes:
    return field_bytes(8, field_string(1, key) + field_bytes(2, attr_bytes))


# ---------------------------------------------------------------------------
# generic native tier: typed AttrValue encoders for arbitrary configs
# ---------------------------------------------------------------------------

_NATIVE_PREFIX = "bigdl_tpu::"
_DT_CUSTOM = 17       # native: AttrValue custom slot (field 17 bytes)

# module attributes that are runtime state, not configuration
_RUNTIME_ATTRS = frozenset({"params", "state", "grad_params", "output",
                            "grad_input", "name", "train_mode"})


class _Unrepresentable(Exception):
    """Raised when a config value has no typed AttrValue form — the caller
    falls back to the pickled-config custom attr."""


def _attr_i64(v: int) -> bytes:
    return _attr(_DT_INT64, field_varint(4, int(v)))


def _attr_str(s: str) -> bytes:
    return _attr(_DT_STRING, field_string(7, s))


def _attr_double_array(vals) -> bytes:
    body = field_varint(1, len(vals)) + field_varint(2, _DT_DOUBLE)
    body += field_packed_double(6, [float(v) for v in vals])
    return _attr(_DT_ARRAY, field_bytes(15, body))


def _attr_str_array(vals) -> bytes:
    body = field_varint(1, len(vals)) + field_varint(2, _DT_STRING)
    for s in vals:
        body += field_string(7, s)
    return _attr(_DT_ARRAY, field_bytes(15, body))


def _attr_module(mbytes: bytes) -> bytes:
    return _attr(_DT_MODULE, field_bytes(13, mbytes))


def _attr_module_array(mods) -> bytes:
    body = field_varint(1, len(mods)) + field_varint(2, _DT_MODULE)
    for mb in mods:
        body += field_bytes(13, mb)
    return _attr(_DT_ARRAY, field_bytes(15, body))


def _attr_custom(blob: bytes) -> bytes:
    return _attr(_DT_CUSTOM, field_bytes(17, blob))


def _is_array(v) -> bool:
    return torch.is_tensor(v) or isinstance(v, np.ndarray)


# ---------------------------------------------------------------------------
# generic native tier: typed AttrValue encoders for arbitrary configs
# ---------------------------------------------------------------------------

_NATIVE_PREFIX = "bigdl_tpu::"
_DT_CUSTOM = 17       # native: AttrValue custom slot (field 17 bytes)

# module attributes that are runtime state (or torch's own), not
# configuration
_RUNTIME_ATTRS = frozenset(torch.nn.Module().__dict__) | {
    "params", "state", "grad_params", "output", "grad_input", "name",
    "train_mode", "_train_mode", "_facade_generators", "_forward_draw"}

# the JAX modules' configuration attributes, in their order, for the port
# classes that keep theirs in another order or shape (every other class
# keeps JAX's: its own attributes, then its child modules)
_JAX_CONFIG = {
    "nn.attention.Transformer": (
        "vocab_size", "hidden_size", "mode", "max_len", "dropout_p",
        "remat", "pos_encoding", "blocks", "ln_f"),
    "nn.attention.TransformerBlock": ("attn", "ffn", "ln1", "ln2",
                                      "with_cross"),
    "nn.attention.Attention": (
        "hidden_size", "num_heads", "attention_dropout", "use_flash",
        "seq_axis", "seq_impl", "causal", "num_kv_heads", "rope"),
    "nn.attention.FeedForwardNetwork": ("hidden_size", "filter_size",
                                        "relu_dropout", "activation"),
    "quantization.quantize.QuantizedSpatialConvolution": (
        "cfg", "_src_params", "_act_scale"),
}


def _rel_path(cls) -> str:
    """'nn.attention.Transformer' for the port's (or JAX's) class."""
    mod = cls.__module__
    for pkg in ("bigdl_tpu_torch.", "bigdl_tpu."):
        if mod.startswith(pkg):
            return mod[len(pkg):] + "." + cls.__qualname__
    return mod + "." + cls.__qualname__


def _jax_type(cls) -> str:
    """The moduleType the JAX package writes for this class's twin."""
    if cls.__module__.startswith("bigdl_tpu_torch."):
        return _NATIVE_PREFIX + "bigdl_tpu." + _rel_path(cls)
    return _NATIVE_PREFIX + cls.__module__ + "." + cls.__qualname__


class _Unrepresentable(Exception):
    """Raised when a config value has no typed AttrValue form — the caller
    falls back to the pickled-config custom attr."""


def _attr_i64(v: int) -> bytes:
    return _attr(_DT_INT64, field_varint(4, int(v)))


def _attr_str(s: str) -> bytes:
    return _attr(_DT_STRING, field_string(7, s))


def _attr_double_array(vals) -> bytes:
    body = field_varint(1, len(vals)) + field_varint(2, _DT_DOUBLE)
    body += field_packed_double(6, [float(v) for v in vals])
    return _attr(_DT_ARRAY, field_bytes(15, body))


def _attr_str_array(vals) -> bytes:
    body = field_varint(1, len(vals)) + field_varint(2, _DT_STRING)
    for s in vals:
        body += field_string(7, s)
    return _attr(_DT_ARRAY, field_bytes(15, body))


def _attr_module(mbytes: bytes) -> bytes:
    return _attr(_DT_MODULE, field_bytes(13, mbytes))


def _attr_module_array(mods) -> bytes:
    body = field_varint(1, len(mods)) + field_varint(2, _DT_MODULE)
    for mb in mods:
        body += field_bytes(13, mb)
    return _attr(_DT_ARRAY, field_bytes(15, body))


def _attr_custom(blob: bytes) -> bytes:
    return _attr(_DT_CUSTOM, field_bytes(17, blob))


def _is_config_object(v) -> bool:
    return isinstance(v, (Module, Criterion))


def _enc_value(v, ids: _Ids) -> bytes:
    """One config value → typed AttrValue bytes, or _Unrepresentable."""
    if _is_config_object(v):
        return _attr_module(_enc_module(v, ids, with_params=False))
    if isinstance(v, (bool, np.bool_)):
        return _attr_bool(bool(v))
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        return _attr_i32(iv) if -2**31 <= iv < 2**31 else _attr_i64(iv)
    if isinstance(v, (float, np.floating)):
        return _attr_double(float(v))
    if isinstance(v, str):
        return _attr_str(v)
    if v is None:
        return _attr(_DT_TENSOR)          # decodes back to None
    if _is_array(v):
        return _attr(_DT_TENSOR,
                     field_bytes(10, _enc_tensor(v, ids, keep_dtype=True)))
    if isinstance(v, (list, tuple)):
        items = list(v)
        if all(isinstance(x, (bool, np.bool_)) for x in items) and items:
            raise _Unrepresentable("bool arrays have no typed form")
        if all(isinstance(x, (int, np.integer)) for x in items):
            return _attr_i32_array(items)  # covers the empty list too
        if all(isinstance(x, (int, float, np.integer, np.floating))
               for x in items):
            return _attr_double_array(items)
        if all(isinstance(x, str) for x in items):
            return _attr_str_array(items)
        if all(_is_config_object(x) for x in items):
            return _attr_module_array(
                [_enc_module(x, ids, with_params=False) for x in items])
        raise _Unrepresentable(f"heterogeneous sequence {v!r}")
    raise _Unrepresentable(f"{type(v).__name__} has no typed AttrValue form")


def _host_value(v):
    """A config value with its tensors as host numpy arrays (a pickled
    value never carries a device)."""
    if torch.is_tensor(v):
        return host(v)
    if isinstance(v, dict):
        return {k: _host_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host_value(x) for x in v)
    return v


def _pickle_config(m) -> bytes:
    """Pickle a module without its tensors (the meta-device copy
    ``Module.save`` pickles) — config only, no params."""
    return pickle.dumps(m._strip_runtime() if isinstance(m, Module) else m)


def _quantized_float_conv(m, qconv_cfg):
    """The float convolution a quantized one was made from, as JAX keeps
    it (``cfg``): its settings, and its shape from the int8 weight."""
    c = qconv_cfg
    (kh, kw), (sh, sw), (ph, pw) = c.kernel, c.stride, c.padding
    out_c, in_g = m.qweight.shape[:2]
    conv = N.SpatialConvolution(in_g * c.n_group, out_c, kw, kh, sw, sh, pw,
                                ph, c.n_group, c.with_bias,
                                dilation_w=c.dilation[1],
                                dilation_h=c.dilation[0], name=c.name)
    conv.evaluate() if not m.training else conv.training()
    return conv


def _config(m):
    """(name, value) pairs of a module's configuration, in the JAX
    module's attribute order."""
    keys = _JAX_CONFIG.get(_rel_path(type(m)))
    if keys is not None:
        out = [("_scale_w", m._scale_w), ("_scale_b", m._scale_b)]
        for k in keys:
            v = getattr(m, k, None)
            if k == "cfg" and not _is_config_object(v):
                v = _quantized_float_conv(m, v)
            out.append((k, list(v) if isinstance(v, tuple) else v))
        return out
    out = [(k, v) for k, v in m.__dict__.items() if k not in _RUNTIME_ATTRS]
    if isinstance(m, Module) and not _plain_container(m):
        out += list(m._modules.items())
    return out


def _plain_container(m) -> bool:
    return isinstance(m, Container) and not isinstance(m, N.Graph)


def _flatten_tree(tree):
    """(path, leaf) pairs for a nested dict/list pytree; empty dicts/lists
    become ('<path>', _EMPTY_DICT/_EMPTY_LIST) markers so the exact
    structure round-trips; a carrier is a ('<path>', carrier) pair whose
    children follow under '<path>/[i]'."""
    pairs = []

    def rec(t, path):
        if isinstance(t, dict):
            if not t:
                pairs.append((path, _EMPTY_DICT))
                return
            for k in t:
                ks = str(k)
                if not isinstance(k, str) or "/" in ks or ks.startswith("["):
                    raise _Unrepresentable(f"param key {k!r}")
                rec(t[k], f"{path}/{ks}" if path else ks)
        elif isinstance(t, tuple):
            raise _Unrepresentable("tuple in param/state tree")
        elif isinstance(t, list):
            if not t:
                pairs.append((path, _EMPTY_LIST))
                return
            for i, v in enumerate(t):
                rec(v, f"{path}/[{i}]" if path else f"[{i}]")
        elif isinstance(t, TreeCarrier):
            pairs.append((path, t))
            for i, c in enumerate(t.children()):
                rec(c, f"{path}/[{i}]")
        else:
            pairs.append((path, t))

    rec(tree, "")
    return pairs


_EMPTY_DICT = object()
_EMPTY_LIST = object()


def _unflatten_pairs(pairs, carriers=None):
    if len(pairs) == 1 and pairs[0][0] == "":
        v = pairs[0][1]
        return {} if v is _EMPTY_DICT else ([] if v is _EMPTY_LIST else v)
    root: Dict = {}
    for path, v in pairs:
        segs = path.split("/")
        cur = root
        for s in segs[:-1]:
            cur = cur.setdefault(s, {})
        cur[segs[-1]] = v

    def conv(d, path):
        if d is _EMPTY_DICT:
            return {}
        if d is _EMPTY_LIST:
            return []
        if isinstance(d, dict):
            if d and all(k.startswith("[") and k.endswith("]") for k in d):
                items = [conv(d[f"[{i}]"], f"{path}/[{i}]" if path
                              else f"[{i}]") for i in range(len(d))]
                if carriers and path in carriers:
                    return _carrier(carriers[path], items)
                return items
            return {k: conv(v, f"{path}/{k}" if path else k)
                    for k, v in d.items()}
        return d

    return conv(root, "")


def _carrier_kind(c) -> str:
    group = getattr(c, "group", None)
    return type(c).__name__ + ("" if group is None else f":{group}")


def _carrier(kind: str, children):
    from ..quantization.lm import QuantizedWeight, QuantizedWeightInt4
    name, _, group = kind.partition(":")
    kids = [_tensor(c) for c in children]
    if name == "QuantizedWeight":
        return QuantizedWeight(*kids)
    if name == "QuantizedWeightInt4":
        return QuantizedWeightInt4(*kids, group=int(group))
    raise ValueError(f"unknown carrier kind {kind!r}")


def _enc_tree_attrs(tree, tag: str, ids: _Ids, attrs: Dict[str, bytes]):
    """Encode a param/state tree as '<tag>:<path>' typed attrs; on any
    unrepresentable leaf fall back to ONE '<tag>_pickle' custom attr."""
    try:
        for path, leaf in _flatten_tree(tree):
            if leaf is _EMPTY_DICT:
                attrs[f"{tag}E:{path}"] = _attr_bool(True)
            elif leaf is _EMPTY_LIST:
                attrs[f"{tag}L:{path}"] = _attr_bool(True)
            elif isinstance(leaf, TreeCarrier):
                attrs[f"{tag}C:{path}"] = _attr_str(_carrier_kind(leaf))
            elif _is_array(leaf):
                attrs[f"{tag}:{path}"] = _attr(
                    _DT_TENSOR,
                    field_bytes(10, _enc_tensor(leaf, ids, keep_dtype=True)))
            elif isinstance(leaf, (bool, int, float, str, np.bool_,
                                   np.integer, np.floating)) or leaf is None:
                attrs[f"{tag}:{path}"] = _enc_value(leaf, ids)
            else:
                raise _Unrepresentable(type(leaf).__name__)
    except _Unrepresentable:
        for k in [k for k in attrs
                  if k.startswith((f"{tag}:", f"{tag}E:", f"{tag}L:",
                                   f"{tag}C:"))]:
            del attrs[k]
        attrs[f"{tag}_pickle"] = _attr_custom(pickle.dumps(_host_value(tree)))


def _module_attrs(m, ids: "_Ids", with_params: bool) -> Dict[str, bytes]:
    """Constructor-parameter attrs, names matching the Scala ctor params so
    the reference's reflection-based deserializer can rebuild the layer."""
    t = type(m).__name__
    if t == "Linear":
        return {"inputSize": _attr_i32(m.input_size),
                "outputSize": _attr_i32(m.output_size),
                "withBias": _attr_bool(m.bias is not None),
                "wRegularizer": _attr_null_reg(),
                "bRegularizer": _attr_null_reg(),
                "initWeight": _attr_null_tensor(),
                "initBias": _attr_null_tensor(),
                "initGradWeight": _attr_null_tensor(),
                "initGradBias": _attr_null_tensor()}
    if t in ("SpatialConvolution", "SpatialShareConvolution"):
        (kh, kw), (sh, sw), (ph, pw) = m.kernel, m.stride, m.padding
        return {"nInputPlane": _attr_i32(m.n_input_plane),
                "nOutputPlane": _attr_i32(m.n_output_plane),
                "kernelW": _attr_i32(kw),
                "kernelH": _attr_i32(kh),
                "strideW": _attr_i32(sw),
                "strideH": _attr_i32(sh),
                "padW": _attr_i32(pw), "padH": _attr_i32(ph),
                "nGroup": _attr_i32(m.n_group),
                "propagateBack": _attr_bool(True),
                "wRegularizer": _attr_null_reg(),
                "bRegularizer": _attr_null_reg(),
                "initWeight": _attr_null_tensor(),
                "initBias": _attr_null_tensor(),
                "initGradWeight": _attr_null_tensor(),
                "initGradBias": _attr_null_tensor(),
                "withBias": _attr_bool(m.bias is not None)}
    if t in ("SpatialMaxPooling",):
        # ceilMode is toggled by .ceil()/.floor() post-ctor; the reference
        # stores it the same way (SpatialMaxPooling.scala doSerializeModule)
        return {"kW": _attr_i32(m.kw), "kH": _attr_i32(m.kh),
                "dW": _attr_i32(m.dw), "dH": _attr_i32(m.dh),
                "padW": _attr_i32(m.pad_w), "padH": _attr_i32(m.pad_h),
                "ceilMode": _attr_bool(m.ceil_mode)}
    if t in ("SpatialAveragePooling",):
        return {"kW": _attr_i32(m.kw), "kH": _attr_i32(m.kh),
                "dW": _attr_i32(m.dw), "dH": _attr_i32(m.dh),
                "padW": _attr_i32(m.pad_w), "padH": _attr_i32(m.pad_h),
                "globalPooling": _attr_bool(m.global_pooling),
                "ceilMode": _attr_bool(m.ceil_mode),
                "countIncludePad": _attr_bool(m.count_include_pad),
                "divide": _attr_bool(m.divide)}
    if t == "Dropout":
        return {"initP": _attr_double(m.p),
                "inplace": _attr_bool(False), "scale": _attr_bool(True)}
    if t in ("BatchNormalization", "SpatialBatchNormalization"):
        # the reference's BN doSerializeModule stores running stats (and the
        # per-batch save buffers) as tensor attrs (BatchNormalization.scala:419)
        mean = m.running_mean if with_params else np.zeros(m.n_output)
        var = m.running_var if with_params else np.ones(m.n_output)
        return {"nOutput": _attr_i32(m.n_output),
                "eps": _attr_double(m.eps),
                "momentum": _attr_double(m.momentum),
                "affine": _attr_bool(m.weight is not None),
                "initWeight": _attr_null_tensor(),
                "initBias": _attr_null_tensor(),
                "initGradWeight": _attr_null_tensor(),
                "initGradBias": _attr_null_tensor(),
                "runningMean": _attr_tensor(mean, ids),
                "runningVar": _attr_tensor(var, ids),
                "saveMean": _attr_tensor(np.zeros(tuple(mean.shape),
                                                  np.float32), ids),
                "saveStd": _attr_tensor(np.ones(tuple(var.shape),
                                                np.float32), ids)}
    if t == "Reshape":
        a = {"size": _attr_i32_array(list(m.size))}
        if m.batch_mode is not None:
            a["batchMode"] = _attr_bool(m.batch_mode)
        return a
    if t == "View":
        return {"sizes": _attr_i32_array(list(m.sizes))}
    if t == "JoinTable":
        return {"dimension": _attr_i32(m.dimension),
                "nInputDims": _attr_i32(m.n_input_dims)}
    return {}


def _collect_parameters(m) -> List:
    """Trainable tensors in the reference's (weight, bias) order, with the
    conv weight expanded to the reference's 5-D grouped layout."""
    t = type(m).__name__
    if t in ("SpatialConvolution", "SpatialShareConvolution"):
        w = m.weight
        g = m.n_group
        out = [w.reshape(g, w.shape[0] // g, *w.shape[1:])]
        if m.bias is not None:
            out.append(m.bias)
        return out
    return [p for p in (getattr(m, "weight", None), getattr(m, "bias", None))
            if isinstance(p, torch.Tensor)]


_SAVE_TYPES = ("Sequential", "Linear", "SpatialConvolution",
               "SpatialShareConvolution", "SpatialMaxPooling",
               "SpatialAveragePooling", "ReLU", "Tanh", "Sigmoid", "SoftMax",
               "LogSoftMax", "Dropout", "BatchNormalization",
               "SpatialBatchNormalization", "Reshape", "View", "Identity",
               "CAddTable", "JoinTable")


def _train_flag(m) -> bool:
    return bool(m.training) if isinstance(m, Module) else False


def _enc_module(m, ids: _Ids, with_params: bool = True) -> bytes:
    t = type(m).__name__
    if t in _SAVE_TYPES and type(m) is getattr(N, t, None):
        return _enc_ref_compatible(m, ids, with_params)
    return _enc_generic(m, ids, with_params)


def _enc_ref_compatible(m, ids: _Ids, with_params: bool) -> bytes:
    """Reference wire form: Scala class name + ctor-param attrs."""
    t = type(m).__name__
    parts = [field_string(1, m.name)]
    if isinstance(m, N.Sequential):
        parts += [field_bytes(2, _enc_module(child, ids, with_params))
                  for child in m._modules.values()]
    parts.append(field_string(7, _SCALA_NN + t))
    parts += [_map_entry(key, ab) for key, ab in
              _module_attrs(m, ids, with_params).items()]
    parts.append(field_string(9, "0.4.0"))
    parts.append(field_varint(10, 1 if _train_flag(m) else 0))
    parts.append(field_varint(12, ids.take()))
    tensors = [] if isinstance(m, N.Sequential) or not with_params else \
        _collect_parameters(m)
    if tensors:
        parts.append(field_varint(15, 1))  # hasParameters
        parts += [field_bytes(16, _enc_tensor(tns, ids)) for tns in tensors]
    return b"".join(parts)


def _prune_empty(tree):
    """A state tree without its empty subtrees (a module that is not a
    container holds its children's state in its own tree, which JAX's
    keeps flat: an empty state is one empty dict)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune_empty(v)
            if not v:
                continue
        out[k] = v
    return out


def _enc_generic(m, ids: _Ids, with_params: bool) -> bytes:
    """Generic native tier: any Module (or Criterion) → proto bytes."""
    cls = type(m)
    out = field_string(1, getattr(m, "name", "") or "")
    mtype = _jax_type(cls)

    # plain containers (child list is the only structure) use subModules;
    # Graph subclasses carry Node topology, which only the pickled config
    # can represent, so their children stay inside the parent's param tree
    plain_container = _plain_container(m)
    attrs: Dict[str, bytes] = {}
    if isinstance(m, N.Graph) or not cls.__module__.startswith(
            "bigdl_tpu_torch"):
        # Graphs need Node topology; classes outside the package are
        # stored by reference in the pickled config
        attrs["cfg_pickle"] = _attr_custom(_pickle_config(m))
        plain_container = False
    else:
        try:
            for k, v in _config(m):
                try:
                    key = ("cfgt:" + k) if isinstance(v, tuple) \
                        else ("cfg:" + k)
                    attrs[key] = _enc_value(v, ids)
                except _Unrepresentable:
                    # no typed form for this one value (dicts, callables,
                    # dtypes, ...) — pickle just the value, keep the rest
                    # of the config typed and wire-inspectable
                    attrs["cfgp:" + k] = _attr_custom(
                        pickle.dumps(_host_value(v)))
        except Exception:
            # unpicklable value (lambda, ...) — last resort: whole config
            attrs = {"cfg_pickle": _attr_custom(_pickle_config(m))}
            plain_container = False

    sub_bytes = []
    handled = set()
    if plain_container and "cfg_pickle" not in attrs:
        for i, child in enumerate(m._modules.values()):
            sub_bytes.append(_enc_module(child, ids, with_params))
            handled.add(str(i))

    # the parts are joined once: a model's tensors make a large file
    parts = [out] + [field_bytes(2, sb) for sb in sub_bytes]
    parts.append(field_string(7, mtype))

    own = isinstance(m, Module) and with_params
    if own:
        params = {k: v for k, v in m.params.items() if k not in handled}
        _enc_tree_attrs(params, "param", ids, attrs)
        state = {k: v for k, v in m.state.items() if k not in handled}
        if not isinstance(m, Container):
            state = _prune_empty(state)
        _enc_tree_attrs(state, "state", ids, attrs)
    parts += [_map_entry(key, ab) for key, ab in attrs.items()]
    parts.append(field_string(9, "0.4.0"))
    parts.append(field_varint(10, 1 if _train_flag(m) else 0))
    parts.append(field_varint(12, ids.take()))
    if own:
        parts.append(field_varint(15, 1))  # hasParameters: params tree
    return b"".join(parts)


def save_bigdl(model, path: str) -> None:
    """module.saveModule(path) parity — writes a BigDLModule protobuf from
    the model's tensors wherever they live.

    Reference-compatible layers cross-load with the actual reference;
    every other module (incl. quantized, Graph, recurrent, criteria) uses
    the generic native tier in the same container format."""
    data = _enc_module(model, _Ids(), with_params=isinstance(model, Module))
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _numel(a) -> int:
    return a.numel() if torch.is_tensor(a) else a.size


def _dec_storage(buf: bytes, storages: Dict[int, np.ndarray]):
    sid, data, dt, raw = -1, None, _DT_FLOAT, None
    for f, w, v in iter_fields(buf):
        if f == 1 and w == 0:
            dt = v
        elif f == 9 and w == 0:
            sid = to_signed(v, 32)
        elif f == 2:
            data = np.frombuffer(v, "<f4").astype(np.float32) \
                if w == 2 else np.array([struct.unpack("<f", v)[0]],
                                        np.float32)
        elif f == 3:
            data = np.frombuffer(v, "<f8").astype(np.float64) \
                if w == 2 else np.array([struct.unpack("<d", v)[0]],
                                        np.float64)
        elif f == 4:
            vals = unpack_packed(v, "varint") if w == 2 else [v]
            data = np.array([bool(x) for x in vals], np.bool_)
        elif f == 6:
            # negatives are wire-encoded as 64-bit two's-complement
            # varints (proto int32 rule) — decode at 64 bits, then narrow
            vals = unpack_packed(v, "varint") if w == 2 else [v]
            data = np.array([to_signed(x) for x in vals],
                            np.int64).astype(np.int32)
        elif f == 7:
            vals = unpack_packed(v, "varint") if w == 2 else [v]
            data = np.array([to_signed(x) for x in vals], np.int64)
        elif f == 8 and w == 2:
            raw = v
    if raw is not None and data is None:
        data = np.frombuffer(
            raw, np.uint8 if dt == _NDT_UINT8 else np.int8).copy()
    if data is not None:
        if dt == _NDT_BF16:    # numpy has no bfloat16: a torch tensor
            data = torch.from_numpy(np.array(data, np.float32)).to(
                torch.bfloat16)
        elif dt == _NDT_F16:
            data = data.astype(np.float16)
        elif dt == _DT_DOUBLE and data.dtype == np.float64:
            # reference double checkpoints load as f32 (as the JAX
            # package loads them)
            data = data.astype(np.float32)
    if data is not None and sid != -1:
        storages[sid] = data
    return sid, data


def _dec_tensor(buf: bytes, storages: Dict[int, np.ndarray]) -> np.ndarray:
    sizes, strides, offset, data, sid = [], [], 1, None, -1
    is_scalar = False
    for f, w, v in iter_fields(buf):
        if f == 2:
            sizes += [to_signed(x, 32) for x in unpack_packed(v, "varint")] \
                if w == 2 else [to_signed(v, 32)]
        elif f == 3:
            strides += [to_signed(x, 32) for x in unpack_packed(v, "varint")]\
                if w == 2 else [to_signed(v, 32)]
        elif f == 4 and w == 0:
            offset = to_signed(v, 32)
        elif f == 7 and w == 0:
            is_scalar = bool(v)
        elif f == 8 and w == 2:
            sid, data = _dec_storage(v, storages)
    if data is None and sid in storages:
        data = storages[sid]
    if data is None:
        return np.zeros(sizes, np.float32)
    n = int(np.prod(sizes)) if sizes else _numel(data)
    flat = data[offset - 1: offset - 1 + n]
    if is_scalar and not sizes:
        return flat.reshape(())
    return flat.reshape(sizes) if sizes else flat


def _dec_attr(buf: bytes, storages):
    dt, val = _DT_INT32, None
    for f, w, v in iter_fields(buf):
        if f == 1 and w == 0:
            dt = v
        elif f == 3:
            val = to_signed(v)  # negative int32 is wire-encoded as 64-bit
        elif f == 4:
            val = to_signed(v)
        elif f == 5 and w == 5:
            val = struct.unpack("<f", v)[0]
        elif f == 6 and w == 1:
            val = struct.unpack("<d", v)[0]
        elif f == 7 and w == 2:
            val = v.decode("utf-8")
        elif f == 8 and w == 0:
            val = bool(v)
        elif f == 10 and w == 2:
            val = _dec_tensor(v, storages)
        elif f == 13 and w == 2:   # nested BigDLModule (generic tier cfg)
            val = decode_bigdl_module(v, storages)
        elif f == 17 and w == 2:   # custom bytes (native pickled payloads)
            val = v
        elif f == 15 and w == 2:  # ArrayValue
            arr = {"i32": [], "flt": [], "dbl": [], "str": [], "mod": []}
            empty = False
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1 and w2 == 0:
                    empty = v2 == 0
                elif f2 == 3 or f2 == 4:
                    arr["i32"] += [to_signed(x) for x in
                                   unpack_packed(v2, "varint")] \
                        if w2 == 2 else [to_signed(v2)]
                elif f2 == 5:
                    arr["flt"] += unpack_packed(v2, "float") if w2 == 2 \
                        else [struct.unpack("<f", v2)[0]]
                elif f2 == 6:
                    arr["dbl"] += unpack_packed(v2, "double") if w2 == 2 \
                        else [struct.unpack("<d", v2)[0]]
                elif f2 == 7 and w2 == 2:
                    arr["str"].append(v2.decode("utf-8"))
                elif f2 == 13 and w2 == 2:
                    arr["mod"].append(decode_bigdl_module(v2, storages))
            val = (arr["i32"] or arr["flt"] or arr["dbl"] or arr["str"]
                   or arr["mod"])
            if empty:
                val = []
    return val


def decode_bigdl_module(buf: bytes, storages=None) -> Dict:
    """BigDLModule bytes → nested dict."""
    storages = {} if storages is None else storages
    mod = {"name": "", "moduleType": "", "subModules": [], "attr": {},
           "parameters": [], "weight": None, "bias": None, "train": False,
           "hasParameters": False}
    for f, w, v in iter_fields(buf):
        if f == 1 and w == 2:
            mod["name"] = v.decode("utf-8")
        elif f == 2 and w == 2:
            mod["subModules"].append(decode_bigdl_module(v, storages))
        elif f == 3 and w == 2:
            mod["weight"] = _dec_tensor(v, storages)
        elif f == 4 and w == 2:
            mod["bias"] = _dec_tensor(v, storages)
        elif f == 7 and w == 2:
            mod["moduleType"] = v.decode("utf-8")
        elif f == 8 and w == 2:
            key, ab = None, None
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1:
                    key = v2.decode("utf-8")
                elif f2 == 2:
                    ab = v2
            if key is not None:
                mod["attr"][key] = _dec_attr(ab or b"", storages)
        elif f == 10 and w == 0:
            mod["train"] = bool(v)
        elif f == 15 and w == 0:
            mod["hasParameters"] = bool(v)
        elif f == 16 and w == 2:
            mod["parameters"].append(_dec_tensor(v, storages))
    return mod


# ---------------------------------------------------------------------------
# module reconstruction
# ---------------------------------------------------------------------------


def _tensor(v):
    """A decoded leaf (numpy array or bf16 tensor) as a CPU tensor."""
    if torch.is_tensor(v):
        return v
    return torch.from_numpy(np.array(v, copy=True))


def _install_tree(live, tree, where, owner=None, buffers=False):
    """Put each leaf of ``tree`` into the matching tensor of ``live`` (a
    module's params or state tree) in place; a leaf of another dtype
    replaces the tensor's data, so the module keeps the file's dtype. A
    leaf the module lacks becomes a parameter (or, for ``buffers``, a
    buffer) of ``owner``, the module built without its constructor."""
    for k, v in tree.items():
        child = owner._modules.get(k) if owner is not None else None
        if k not in live:
            if owner is None or isinstance(v, dict) or hasattr(owner, k):
                raise ValueError(f"{where}{k}: the file holds a tensor the "
                                 f"module does not have")
            t = _tensor(v)
            if buffers:
                owner.register_buffer(k, t)
            else:
                owner.register_parameter(k, torch.nn.Parameter(
                    t, requires_grad=t.is_floating_point()))
            continue
        t = live[k]
        if isinstance(v, dict):
            _install_tree(t, v, f"{where}{k}/", child, buffers)
            continue
        v = _tensor(v)
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{where}{k}: shape {tuple(v.shape)} does not "
                             f"match {tuple(t.shape)}")
        with torch.no_grad():
            if v.dtype == t.dtype:
                t.copy_(v)
            else:
                t.data = v.to(t.device)


def _install(m, params, state):
    if params:
        if not m.params and hasattr(m, "_set_params"):
            # a quantized layer builds its int8 tensors from float ones
            m._set_params({k: _tensor(v) for k, v in params.items()})
        else:
            _install_tree(m.params, params, "", m)
    if state:
        _install_tree(m.state, state, "", m, buffers=True)


def _build_module(mod: Dict):
    t = mod["moduleType"].rsplit(".", 1)[-1]
    a = mod["attr"]
    if t == "Linear":
        m = N.Linear(int(a["inputSize"]), int(a["outputSize"]),
                     bool(a.get("withBias", True)))
    elif t in ("SpatialConvolution", "SpatialShareConvolution"):
        cls = getattr(N, t)
        m = cls(
            int(a["nInputPlane"]), int(a["nOutputPlane"]),
            int(a["kernelW"]), int(a["kernelH"]),
            int(a.get("strideW", 1)), int(a.get("strideH", 1)),
            int(a.get("padW", 0)), int(a.get("padH", 0)),
            n_group=int(a.get("nGroup", 1)),
            with_bias=bool(a.get("withBias", True)))
    elif t == "SpatialMaxPooling":
        m = N.SpatialMaxPooling(int(a["kW"]), int(a["kH"]),
                                int(a.get("dW") or a["kW"]),
                                int(a.get("dH") or a["kH"]),
                                int(a.get("padW", 0)), int(a.get("padH", 0)))
        if a.get("ceilMode"):
            m.ceil()
    elif t == "SpatialAveragePooling":
        m = N.SpatialAveragePooling(
            int(a["kW"]), int(a["kH"]),
            int(a.get("dW") or a["kW"]), int(a.get("dH") or a["kH"]),
            int(a.get("padW", 0)), int(a.get("padH", 0)),
            global_pooling=bool(a.get("globalPooling", False)),
            ceil_mode=bool(a.get("ceilMode", False)),
            count_include_pad=bool(a.get("countIncludePad", True)),
            divide=bool(a.get("divide", True)))
    elif t == "ReLU":
        m = N.ReLU()
    elif t == "Tanh":
        m = N.Tanh()
    elif t == "Sigmoid":
        m = N.Sigmoid()
    elif t == "SoftMax":
        m = N.SoftMax()
    elif t == "LogSoftMax":
        m = N.LogSoftMax()
    elif t == "Dropout":
        m = N.Dropout(float(a.get("initP", 0.5)))
    elif t == "BatchNormalization":
        m = N.BatchNormalization(int(a["nOutput"]),
                                 float(a.get("eps", 1e-5)),
                                 float(a.get("momentum", 0.1)),
                                 bool(a.get("affine", True)))
    elif t == "SpatialBatchNormalization":
        m = N.SpatialBatchNormalization(int(a["nOutput"]),
                                        float(a.get("eps", 1e-5)),
                                        float(a.get("momentum", 0.1)),
                                        bool(a.get("affine", True)))
    elif t == "View":
        m = N.View(*[int(x) for x in a.get("sizes", a.get("size", []))])
    elif t == "Reshape":
        size = [int(x) for x in a.get("size", a.get("sizes", []))]
        m = N.Reshape(size, batch_mode=a.get("batchMode"))
    elif t == "Identity":
        m = N.Identity()
    elif t == "CAddTable":
        m = N.CAddTable()
    elif t == "JoinTable":
        m = N.JoinTable(int(a.get("dimension", 1)),
                        int(a.get("nInputDims", -1)))
    else:
        raise NotImplementedError(
            f"bigdl.proto load of moduleType {mod['moduleType']} "
            "not supported")
    if mod["name"]:
        m.set_name(mod["name"])
    return m


def _ref_params(m, mod: Dict):
    """(params, state) of a reference-compatible leaf from its record."""
    params, state = {}, {}
    if isinstance(m, N.BatchNormalization):
        a = mod["attr"]
        if isinstance(a.get("runningMean"), np.ndarray) and \
                a["runningMean"].size:
            state["running_mean"] = a["runningMean"].reshape(-1)
        if isinstance(a.get("runningVar"), np.ndarray) and \
                a["runningVar"].size:
            state["running_var"] = a["runningVar"].reshape(-1)
    tensors = mod["parameters"]
    if not tensors and mod["weight"] is not None:
        tensors = [mod["weight"]] + \
            ([mod["bias"]] if mod["bias"] is not None else [])
    keys = [k for k in ("weight", "bias") if m.params.get(k) is not None]
    for k, tns in zip(keys, tensors):
        params[k] = tns.reshape(tuple(m.params[k].shape))
    return params, state


def _resolve_native(mtype: str):
    """'bigdl_tpu::bigdl_tpu.<module>.<Class>' (the JAX package's name,
    which both packages write) → the port's twin class,
    ``bigdl_tpu_torch.<module>.<Class>``, mapped by string: ``bigdl_tpu``
    itself is never imported."""
    path = mtype[len(_NATIVE_PREFIX):]
    if path.startswith("bigdl_tpu."):
        path = "bigdl_tpu_torch." + path[len("bigdl_tpu."):]
    elif not path.startswith("bigdl_tpu_torch."):
        raise ValueError(f"refusing to resolve non-bigdl_tpu type {path!r}")
    parts = path.split(".")
    pymod = None
    for cut in range(len(parts) - 1, 0, -1):
        try:
            pymod = importlib.import_module(".".join(parts[:cut]))
            break
        except ImportError:
            continue
    if pymod is None:
        raise ValueError(f"cannot import module for {path!r}")
    obj = pymod
    for nm in parts[cut:]:
        if not hasattr(obj, nm):
            raise ValueError(f"{mtype}: the port has no twin {path!r}")
        obj = getattr(obj, nm)
    return obj


def _tree_from_attrs(a: Dict, tag: str):
    """The '<tag>:' / '<tag>E:' / '<tag>L:' / '<tag>C:' attrs as a tree
    (None when there are none)."""
    if f"{tag}_pickle" in a:
        return _loads(a[f"{tag}_pickle"])
    pairs, carriers = [], {}
    for key, val in a.items():
        if key.startswith(f"{tag}:"):
            pairs.append((key[len(tag) + 1:], val))
        elif key.startswith(f"{tag}E:"):
            pairs.append((key[len(tag) + 2:], _EMPTY_DICT))
        elif key.startswith(f"{tag}L:"):
            pairs.append((key[len(tag) + 2:], _EMPTY_LIST))
        elif key.startswith(f"{tag}C:"):
            carriers[key[len(tag) + 2:]] = val
    return _unflatten_pairs(pairs, carriers) if pairs else None


def _cfg_dict(mod: Dict) -> Dict:
    """A generic-tier record's config: {name: value}, tuples restored,
    pickled values unpickled, nested module records kept as records."""
    cfg = {}
    for key, val in mod["attr"].items():
        if key.startswith("cfgt:"):
            cfg[key[5:]] = tuple(val) if isinstance(val, list) else val
        elif key.startswith("cfgp:"):
            cfg[key[5:]] = _loads(val)
        elif key.startswith("cfg:"):
            cfg[key[4:]] = val
    return cfg


def _is_record(v) -> bool:
    return isinstance(v, dict) and "moduleType" in v


def _cfg_value(val, dev):
    """A config value with its nested module records built."""
    if _is_record(val):
        return _assemble(val, dev)
    if isinstance(val, (list, tuple)) and val and all(
            _is_record(x) for x in val):
        return type(val)(_assemble(x, dev) for x in val)
    return val


def _build_transformer(cls, cfg, dev):
    blocks = cfg["blocks"]
    blk = _cfg_dict(blocks[0])
    attn, ffn = _cfg_dict(blk["attn"]), _cfg_dict(blk["ffn"])
    return cls(cfg["vocab_size"], cfg["hidden_size"], attn["num_heads"],
               ffn["filter_size"], len(blocks), cfg.get("dropout_p", 0.0),
               attn.get("attention_dropout", 0.0),
               ffn.get("relu_dropout", 0.0), cfg.get("mode", "lm"),
               cfg.get("max_len", 2048), attn.get("use_flash", True),
               cfg.get("remat", False), attn.get("num_kv_heads"),
               cfg.get("pos_encoding", "sinusoidal"),
               ffn.get("activation", "relu"), device=dev)


def _build_quantized_conv(cls, cfg, dev):
    m = cls(_cfg_value(cfg["cfg"], None))
    m._act_scale = cfg.get("_act_scale")
    return m


_BUILDERS = {
    "nn.attention.Transformer": _build_transformer,
    "quantization.quantize.QuantizedSpatialConvolution":
        _build_quantized_conv,
    "quantization.quantize.QuantizedSpatialSeparableConvolution":
        _build_quantized_conv,
}

_PORT_ONLY = {"name", "device", "generator", "seed"}


def _construct(cls, cfg, dev):
    """The port's module from a JAX-layout config: its constructor with
    the config's values for the parameters it names (the CPU, or
    ``device`` where the constructor takes one)."""
    build = _BUILDERS.get(_rel_path(cls))
    if build is not None:
        return build(cls, cfg, dev)
    sig = inspect.signature(cls.__init__)
    kwargs = {}
    for p in list(sig.parameters.values())[1:]:
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) \
                or p.name in _PORT_ONLY:
            continue
        if p.name in cfg:
            kwargs[p.name] = _cfg_value(cfg[p.name], None)
        elif p.default is p.empty:
            return _blank(cls, cfg)
    if "device" in sig.parameters and dev is not None:
        kwargs["device"] = dev
    m = cls(**kwargs)
    for k in ("_scale_w", "_scale_b", "_act_scale"):
        if k in cfg:
            setattr(m, k, cfg[k])
    return m


def _blank(cls, cfg):
    """A module whose constructor's parameters the config does not name
    (it keeps them under other names): built as JAX builds every generic
    module, the base constructor, then each config value set as an
    attribute (a module value becomes a child); its tensors come from the
    file's trees."""
    m = cls.__new__(cls)
    (Module if issubclass(cls, Module) else Criterion).__init__(m)
    for k, v in cfg.items():
        setattr(m, k, _cfg_value(v, None))
    return m


def _assemble(mod: Dict, dev=None):
    """BigDLModule record (either tier) → the port's module with its
    tensors (on the CPU, or on ``dev`` where a constructor takes it)."""
    mtype = mod["moduleType"]
    if mtype.startswith(_NATIVE_PREFIX):
        return _assemble_generic(mod, dev)
    t = mtype.rsplit(".", 1)[-1]
    if t == "Sequential":
        seq = N.Sequential()
        if mod["name"]:
            seq.set_name(mod["name"])
        for sub in mod["subModules"]:
            seq.add(_assemble(sub, dev))
        _set_mode(seq, mod)
        return seq
    # reference-compatible leaf
    m = _build_module(mod)
    params, state = _ref_params(m, mod)
    _install(m, params, state)
    _set_mode(m, mod)
    return m


def _set_mode(m, mod):
    if isinstance(m, Module):
        m.train(bool(mod["train"]))


def _assemble_generic(mod: Dict, dev):
    """Generic-tier record → the port's module (or criterion)."""
    a = mod["attr"]
    if "cfg_pickle" in a:
        m = _loads(a["cfg_pickle"])
        if isinstance(m, Module):
            m = m.to_empty(device="cpu")
    else:
        cls = _resolve_native(mod["moduleType"])
        m = _construct(cls, _cfg_dict(mod), dev)
        if mod["subModules"]:
            for sub in mod["subModules"]:
                m.add(_assemble(sub, dev))
    if not isinstance(m, Module):
        return m
    if mod["name"]:
        m.name = mod["name"]
    params = _tree_from_attrs(a, "param")
    state = _tree_from_attrs(a, "state")
    _install(m, params, state)
    _set_mode(m, mod)
    return m


def load_bigdl(path_or_bytes, allow_pickle=True, device=None):
    """ModuleLoader.loadFromFile parity — builds the port's module (or
    criterion) from a BigDLModule protobuf, either tier, written by the
    reference, the JAX package or the port; its tensors go to ``device``
    (the CUDA device by default; ``"cpu"`` for the CPU).

    ``allow_pickle`` governs the generic tier's pickled-attr fallback
    (see the module docstring's trust model): ``True`` (default) unpickles
    through a whitelist restricted to the port's classes and numpy / torch
    data, ``False`` refuses pickled attrs entirely (reference-compatible
    files never carry them), ``"unsafe"`` is raw pickle for trusted
    files."""
    dev = engine.resolve_device(device)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    # identity checks: 1 == True / 0 == False would silently pass an `in`
    if not (allow_pickle is True or allow_pickle is False
            or allow_pickle == "unsafe"):
        raise ValueError(
            f"allow_pickle must be True, False, or 'unsafe', "
            f"got {allow_pickle!r}")
    mod = decode_bigdl_module(data)
    token = _PICKLE_MODE.set(
        "restricted" if allow_pickle is True else allow_pickle)
    try:
        m = _assemble(mod, dev)
    finally:
        _PICKLE_MODE.reset(token)
    if isinstance(m, Module):
        m = m.to(dev)
    return m


__all__ = ["save_bigdl", "load_bigdl", "decode_bigdl_module"]
