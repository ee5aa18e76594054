"""Fused BatchNorm-apply + ReLU + matmul + batch statistics (K3, K3-nhwc):
the CUDA kernels, their plain versions and the ``autograd.Function`` around
them.

Replaces the Pallas kernels of ``bigdl_tpu/kernels/fused_matmul.py``:
``fused_bn_relu_matmul`` (``_fwd``, ``_bwd``) and
``fused_bn_relu_matmul_nhwc`` (``_fwd4``, ``_bwd4``). A contiguous NHWC
activation already is a (B*H*W, K) matrix, so
:func:`fused_bn_relu_matmul_nhwc` is a view onto the flat entry, and an M
that is not a multiple of the kernels' row tile is masked in the
kernels (the JAX kernels' row masks), never padded. Each wrapper picks its
kernels by dtype and one shape rule (:func:`route`):

- ``"bf16_sm90"``: bfloat16 with K and N multiples of 8 (every ResNet-50
  call) takes ``csrc/fused_matmul_sm90.cu`` (bf16 wgmma, the weight
  through TMA, the prologue in registers);
- ``"bf16_ragged"``: other bfloat16 shapes (the ragged route: any K and
  N) take ``csrc/fused_matmul.cu``: the same bf16 kernels with their ragged
  load / store policy (element copies of the activations, the weight copied
  with rows zero-padded to 8, predicated stores);
- ``"f32_sm90"``: float32 with K and N multiples of 4 (every ResNet-50
  call) takes ``csrc/fused_matmul_tf32_sm90.cu`` (3xTF32 wgmma: each
  float32 operand split into tf32 hi and lo halves, three products, which
  keeps float32 accuracy);
- ``"f32"``: other float32 shapes (the ragged route: any K and N) take
  ``csrc/fused_matmul.cu``: the same 3xTF32 kernels with their ragged load
  / store policy (element copies of the activations, the weight's split
  halves zero-padded to whole stages, predicated stores), so no
  activation is copied or padded.

Each source's header note says what bounds it on an H100 and what the
design does about it. Besides ``<wrapper>.launches``, each wrapper counts
its launches per route in ``<wrapper>.launches_by_route``.

:func:`fused_matmul_fwd` and :func:`fused_matmul_bwd` are the wrappers:
tensors on the CPU take :func:`fused_matmul_fwd_reference` /
:func:`fused_matmul_bwd_reference`, plain PyTorch with the JAX kernels'
rounding points (the affine prologue and ``dz_eff`` rounded to x's dtype,
float32 sums and statistics); tensors on a CUDA device launch the kernels
or raise. :class:`FusedBnReluMatmul` is the counterpart of JAX's
``custom_vjp``. JAX's VMEM fitter and its unfused fallback for shapes that
overflow VMEM are not ported: the kernels tile K and N and take any shape.

Without ``stats`` the statistics come back as None (the Pallas kernels
leave them unwritten); in the backward None gradients of ``s1``/``s2``
(both or neither: autograd passes None for outputs that were None and
zeros for unused ones) count as zero.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.engine import refuse_unported
from . import _build, _flops

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dtype -> (aligned route, the multiple K and N must be of for it, the
# ragged route of the other shapes); each route's (library, symbol) for the
# forward and backward
_ROUTES = {torch.bfloat16: ("bf16_sm90", 8, "bf16_ragged"),
           torch.float32: ("f32_sm90", 4, "f32")}
_RAGGED = "bf16_ragged"
_FWD_FN = {"bf16_sm90": ("fused_matmul_sm90", "bigdl_fused_matmul_sm90_fwd"),
           _RAGGED: ("fused_matmul", "bigdl_fused_matmul_fwd"),
           "f32_sm90": ("fused_matmul_tf32_sm90",
                        "bigdl_fused_matmul_tf32_sm90_fwd"),
           "f32": ("fused_matmul", "bigdl_fused_matmul_fwd")}
_BWD_FN = {"bf16_sm90": ("fused_matmul_sm90", "bigdl_fused_matmul_sm90_bwd"),
           _RAGGED: ("fused_matmul", "bigdl_fused_matmul_bwd"),
           "f32_sm90": ("fused_matmul_tf32_sm90",
                        "bigdl_fused_matmul_tf32_sm90_bwd"),
           "f32": ("fused_matmul", "bigdl_fused_matmul_bwd")}
_KBK = 32          # contraction depth of a 3xTF32 stage (kBK)
# rows each partial of the column sums covers: the tensor-core cores'
# kPartRows, one per consumer warpgroup, on every route
_PART_ROWS = dict.fromkeys(_FWD_FN, 64)
_SMS = 132         # streaming multiprocessors of an H100 SXM
_FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                 + [ctypes.c_void_p])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _dw_splits_sm(rows, k, n, quantum):
    bn = 64 if n <= 64 else 128
    tiles = -(-k // 64) * -(-n // bn)
    want = max(1, min(-(-_SMS // tiles), -(-rows // 256)))
    per = -(-(-(-rows // want)) // quantum) * quantum
    return -(-rows // per), per


def dw_splits_sm90(rows: int, k: int, n: int):
    """(splits, rows per split) of the bf16 tensor-core weight gradient:
    its blocks own 64 x BN tiles of dw (BN = 64 for N <= 64, else 128), so
    enough (K/64 x N/BN x splits) blocks for one per SM, at least 256
    pixels per split, a multiple of 128 rows each (the block's two
    warpgroups take alternate 64-pixel chunks). Each split writes two
    float32 partials."""
    return _dw_splits_sm(rows, k, n, 128)


def dw_splits_tf32(rows: int, k: int, n: int):
    """(splits, rows per split) of the 3xTF32 weight gradient: the same
    64 x BN blocks, one per SM, at least 256 pixels per split, a multiple
    of 64 rows each (the block's two warpgroups take alternate 32-pixel
    chunks). Each split writes two float32 partials."""
    return _dw_splits_sm(rows, k, n, 64)


# each route's weight-gradient splits (two partials a split, on the
# tensor-core cores of every route); the aligned routes read their operands
# by TMA and 16-byte copies
_TC_SPLITS = {"bf16_sm90": dw_splits_sm90, _RAGGED: dw_splits_sm90,
              "f32_sm90": dw_splits_tf32, "f32": dw_splits_tf32}
_ALIGNED = ("bf16_sm90", "f32_sm90")
# the routes whose C entries take the weight's scratch
_WSPLIT = ("f32_sm90", "f32", _RAGGED)


def route(dtype, k: int, n: int) -> str:
    """The route of a CUDA call with contraction / input channels ``k``
    and output columns ``n``: bfloat16 -> ``"bf16_sm90"`` when k and n are
    multiples of 8, else ``"bf16_ragged"``; float32 -> ``"f32_sm90"`` when
    they are multiples of 4, else ``"f32"``."""
    tc, quantum, other = _ROUTES[dtype]
    return tc if k % quantum == 0 and n % quantum == 0 else other


def _check_aligned(fn, *tensors):
    """The tensor-core kernels read through TMA: 16-byte aligned bases."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: the tensor-core kernels need 16-byte "
                             f"aligned tensors (data_ptr {t.data_ptr():#x})")


def wsplit_elems(rt, k, n, fwd=True):
    """float32 elements of a call's weight scratch, which the entry's prep
    kernel writes each call. The 3xTF32 routes: the weight's tf32 hi and lo
    halves, B of the product - w^T (N rows of K) for the forward, w (K rows
    of N) for dx -, the ragged route ``"f32"`` with B's rows zero-padded to
    whole 32-deep stages (K, or N, rounded up to 32) so that TMA can read
    them. ``"bf16_ragged"``: w (K, N) copied with rows zero-padded to a
    multiple of 8 (16 bytes), K x N8 bf16, for both products. 0 on
    ``"bf16_sm90"``."""
    if rt == "f32_sm90":
        return 2 * k * n
    if rt == "f32":
        rows, inner = (n, k) if fwd else (k, n)
        return 2 * rows * (-(-inner // _KBK) * _KBK)
    if rt == _RAGGED:
        return -(-k * (-(-n // 8) * 8) // 2)
    return 0


def _wsplit(rt, k, n, device, fwd=True):
    """(scratch, the trailing C arguments) of a route's forward (``fwd``)
    or backward: for the routes whose entries take the argument
    (``_WSPLIT``) ``wsplit_elems`` float32, passed as the entry's last
    argument (None for none); no argument on the others. The caller holds
    the scratch until the launch is queued."""
    if rt not in _WSPLIT:
        return None, ()
    size = wsplit_elems(rt, k, n, fwd)
    t = torch.empty(size, device=device) if size else None
    return t, (_ptr(t),)


def _prologue(x, a, b, relu):
    """act(x * a + b): the affine in float32, rounded to x's dtype, then
    ReLU (without ``a``: x itself, through the ReLU when ``relu``)."""
    if a is not None:
        x = (x.float() * a.float() + b.float()).to(x.dtype)
    return torch.relu(x) if relu else x


def _dz_eff(dz, z, ds1, ds2, dtype, stats):
    """dz + ds1 + 2 z ds2 rounded to ``dtype``, as float32 (dz alone
    without stats)."""
    d = dz.to(dtype).float()
    if stats:
        d = (d + ds1.float() + 2.0 * z.float() * ds2.float()).to(dtype).float()
    return d


def fused_matmul_fwd_reference(x, w, a, b, relu: bool, stats: bool):
    """Plain version: x (M, K), w (K, N), a/b (K,) or None. Returns
    ``(z in x's dtype, s1, s2)``, z = act(x * a + b) @ w summed in float32
    and s1 / s2 the float32 column sums of z and z^2 (None without
    ``stats``)."""
    zf = _prologue(x, a, b, relu).float() @ w.float()
    if stats:
        return zf.to(x.dtype), zf.sum(0), (zf * zf).sum(0)
    return zf.to(x.dtype), None, None


def fused_matmul_bwd_reference(x, w, a, b, z, dz, ds1, ds2, relu: bool,
                               stats: bool):
    """Plain version of the backward: returns ``(dx, dw, da, db)`` with dx
    in x's dtype, dw in w's, da / db float32 (None without ``a``)."""
    dt = x.dtype
    d = _dz_eff(dz, z, ds1, ds2, dt, stats)
    dxh = d @ w.float().T
    xf = x.float()
    xn = xf * a.float() + b.float() if a is not None else xf
    dxn = torch.where(xn > 0, dxh, torch.zeros_like(dxh)) if relu else dxh
    dw = (_prologue(x, a, b, relu).float().T @ d).to(w.dtype)
    if a is None:
        return dxn.to(dt), dw, None, None
    return ((dxn * a.float()).to(dt), dw, (dxn * xf).sum(0), dxn.sum(0))


def _check(fn, x, w, a, b, *like_x):
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)) + like_x:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{fn}: the kernel builds no autograd graph; "
                             f"differentiate through FusedBnReluMatmul or "
                             f"run under torch.no_grad()")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{fn}: x {x.dtype} and w {w.dtype} must be one of "
                        f"float32, bfloat16")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"{fn}: x{tuple(x.shape)} @ w{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{fn}: x and w must be contiguous")
    if (a is None) != (b is None):
        raise ValueError(f"{fn}: scale and bias go together")
    K = x.shape[1]
    if a is not None and (a.shape != (K,) or b.shape != (K,)):
        raise ValueError(f"{fn}: scale/bias {tuple(a.shape)}/"
                         f"{tuple(b.shape)} for K = {K}")
    for name, t in like_x:
        if t.shape != (x.shape[0], w.shape[1]):
            raise ValueError(f"{fn}: {name}{tuple(t.shape)} is not (M, N) = "
                             f"{(x.shape[0], w.shape[1])}")
    if 0 in x.shape or 0 in w.shape:
        raise ValueError(f"{fn}: empty x{tuple(x.shape)} or w{tuple(w.shape)}")
    if x.numel() >= 2**31 or x.shape[0] * w.shape[1] >= 2**31:
        raise ValueError(f"{fn}: x{tuple(x.shape)} @ w{tuple(w.shape)} is "
                         f"past the kernel's 32-bit row and column indices")


def _f32(t):
    """t as contiguous, 16-byte aligned float32 (a copy unless it already
    is: the tensor-core kernels copy it 16 bytes at a time); the caller
    holds the result until the kernel is queued, since a temporary freed
    earlier could hand its memory to the next allocation."""
    if t is None:
        return None
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_matmul_fwd(x, w, a=None, b=None, relu: bool = False,
                     stats: bool = True):
    """K3 forward: x (M, K), w (K, N) of one dtype (float32 or bfloat16),
    a/b (K,) or None. Returns ``(z (M, N) in x's dtype, s1, s2)`` (float32
    (N,), or None without ``stats``)."""
    if x.device.type == "cpu":
        return fused_matmul_fwd_reference(x, w, a, b, relu, stats)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_matmul_fwd: no kernel for device "
                           f"{x.device}")
    _check("fused_matmul_fwd", x, w, a, b)
    M, K = x.shape
    N = w.shape[1]
    rt = route(x.dtype, K, N)
    if rt in _ALIGNED:
        _check_aligned("fused_matmul_fwd", x, w)
    z = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = s = None
    if stats:
        part = torch.empty((2, -(-M // _PART_ROWS[rt]), N), device=x.device)
        s = torch.empty((2, N), device=x.device)
    af, bf = _f32(a), _f32(b)      # held until the launch is queued
    wsp, extra = _wsplit(rt, K, N, x.device)   # held, like af / bf
    fn = _build.function(*_FWD_FN[rt],
                         _FWD_ARGTYPES + [ctypes.c_void_p] * len(extra))
    err = fn(x.data_ptr(), w.data_ptr(), _ptr(af), _ptr(bf),
             z.data_ptr(), _ptr(part), None if part is None else
             part[1].data_ptr(), _ptr(s), None if s is None else
             s[1].data_ptr(), _DTYPES[x.dtype], M, K, N, int(a is not None),
             int(bool(relu)), int(bool(stats)), _stream(x), *extra)
    if err:
        raise RuntimeError(f"fused_matmul_fwd kernel launch failed ({rt}): "
                           f"CUDA error {err}")
    fused_matmul_fwd.launches += 1
    _flops.tally("fused_matmul_fwd", 2 * M * K * N)
    fused_matmul_fwd.launches_by_route[rt] += 1
    return (z, s[0], s[1]) if stats else (z, None, None)


fused_matmul_fwd.launches = 0
fused_matmul_fwd.launches_by_route = dict.fromkeys(_FWD_FN, 0)


def fused_matmul_bwd(x, w, a, b, z, dz, ds1, ds2, relu: bool = False,
                     stats: bool = True):
    """K3 backward from the forward's inputs, its output ``z`` (with
    ``stats``) and the gradients ``dz`` (M, N), ``ds1``/``ds2`` (N,) (both
    None count as zero). Returns ``(dx, dw, da, db)``: dx in x's dtype, dw in
    w's, da / db float32 (None without a prologue). One count in
    ``fused_matmul_bwd.launches`` is one launch of the dx + da/db kernel
    and the dw kernel with their second passes."""
    stats = bool(stats) and ds1 is not None
    if x.device.type == "cpu":
        return fused_matmul_bwd_reference(x, w, a, b, z, dz, ds1, ds2, relu,
                                          stats)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_matmul_bwd: no kernel for device "
                           f"{x.device}")
    dz = dz.to(x.dtype).contiguous()
    _check("fused_matmul_bwd", x, w, a, b, ("dz", dz),
           *((("z", z),) if stats else ()))
    M, K = x.shape
    N = w.shape[1]
    rt = route(x.dtype, K, N)
    if rt in _ALIGNED:
        _check_aligned("fused_matmul_bwd", x, w, dz, *((z,) if stats else ()))
    prologue = a is not None
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    dadb = torch.empty((2, K), device=x.device) if prologue else None
    splits, per = _TC_SPLITS[rt](M, K, N)   # two partials a split
    ws = torch.empty((2 * splits, K, N), device=x.device)
    part = (torch.empty((2, -(-M // _PART_ROWS[rt]), K), device=x.device)
            if prologue else None)
    af, bf = _f32(a), _f32(b)      # held until the launch is queued
    d1, d2 = (_f32(ds1), _f32(ds2)) if stats else (None, None)
    wsp, extra = _wsplit(rt, K, N, x.device, fwd=False)   # held, like af
    fn = _build.function(*_BWD_FN[rt],
                         _BWD_ARGTYPES + [ctypes.c_void_p] * len(extra))
    err = fn(x.data_ptr(), w.data_ptr(), _ptr(af), _ptr(bf),
             dz.data_ptr(), _ptr(z if stats else None), _ptr(d1), _ptr(d2),
             dx.data_ptr(),
             dw.data_ptr(), ws.data_ptr(), _ptr(part),
             None if part is None else part[1].data_ptr(), _ptr(dadb),
             None if dadb is None else dadb[1].data_ptr(), _DTYPES[x.dtype],
             M, K, N, int(prologue), int(bool(relu)), int(stats), splits, per,
             _stream(x), *extra)
    if err:
        raise RuntimeError(f"fused_matmul_bwd kernel launch failed ({rt}): "
                           f"CUDA error {err}")
    fused_matmul_bwd.launches += 1
    _flops.tally("fused_matmul_bwd", 4 * M * K * N)
    fused_matmul_bwd.launches_by_route[rt] += 1
    if not prologue:
        return dx, dw, None, None
    return dx, dw, dadb[0], dadb[1]


fused_matmul_bwd.launches = 0
fused_matmul_bwd.launches_by_route = dict.fromkeys(_BWD_FN, 0)


class FusedBnReluMatmul(torch.autograd.Function):
    """``FusedBnReluMatmul.apply(x, w, a, b, relu, stats)`` -> (z, s1, s2)
    over a flat x (M, K): the forward through :func:`fused_matmul_fwd`,
    saving (x, w, a, b, z), the backward through :func:`fused_matmul_bwd`
    (JAX's ``_fused`` ``custom_vjp``). da / db come back in a's / b's
    dtype."""

    @staticmethod
    def forward(ctx, x, w, a, b, relu, stats):
        z, s1, s2 = fused_matmul_fwd(x, w, a, b, relu, stats)
        ctx.save_for_backward(x, w, a, b, z if stats else None)
        ctx.relu, ctx.stats = relu, stats
        return z, s1, s2

    @staticmethod
    def backward(ctx, dz, ds1, ds2):
        x, w, a, b, z = ctx.saved_tensors
        dx, dw, da, db = fused_matmul_bwd(x, w, a, b, z, dz, ds1, ds2,
                                          ctx.relu, ctx.stats)
        if a is not None:
            da, db = da.to(a.dtype), db.to(b.dtype)
        return dx, dw, da, db, None, None


def fused_bn_relu_matmul(x, w, scale=None, bias=None, *, relu=None,
                         stats: bool = True, block_m: int = 512,
                         block_n: int = 512, interpret: bool = False):
    """``z = act(x * scale + bias) @ w`` with fused per-channel output
    statistics. x (M, K), w (K, N), scale/bias (K,) (the previous
    BatchNorm folded to an affine) or None; ``relu`` defaults to True with
    a prologue. Returns ``(z, s1, s2)``, s1 = sum_m z and s2 = sum_m z^2 in
    float32 (None without ``stats``). Differentiable in x, w, scale and
    bias, through the statistics too. JAX's TPU tile sizes (``block_m``,
    ``block_n``) and ``interpret`` are not ported (the CUDA kernels pick
    their own tiles)."""
    refuse_unported("fused_bn_relu_matmul", block_m=(block_m, 512),
                    block_n=(block_n, 512), interpret=(interpret, False))
    if relu is None:
        relu = scale is not None
    return FusedBnReluMatmul.apply(x, w, scale, bias, bool(relu),
                                   bool(stats))


def fused_bn_relu_matmul_nhwc(x, w, scale=None, bias=None, *, relu=None,
                              stats: bool = True, block_n: int = 512,
                              interpret: bool = False):
    """The NHWC form: x (B, H, W, K) -> ``(z (B, H, W, N), s1, s2)``, a
    view onto :func:`fused_bn_relu_matmul` over the B*H*W rows (a
    non-contiguous x is copied once by ``reshape``)."""
    refuse_unported("fused_bn_relu_matmul_nhwc", block_n=(block_n, 512),
                    interpret=(interpret, False))
    B, H, W, K = x.shape
    z, s1, s2 = fused_bn_relu_matmul(x.reshape(B * H * W, K), w, scale, bias,
                                     relu=relu, stats=stats)
    return z.view(B, H, W, w.shape[1]), s1, s2
