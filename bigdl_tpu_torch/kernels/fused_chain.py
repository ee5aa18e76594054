"""Cross-layer fused residual junction + next 1x1 conv + batch statistics
(K5): the CUDA kernels, their plain versions and the ``autograd.Function``
around them.

Replaces the Pallas kernels of ``bigdl_tpu/kernels/fused_chain.py``
``fused_residual_matmul_nhwc`` (``_cfwd``, ``_cbwd``). At a ResNet
bottleneck junction,

    h  = relu(z * a + b + r)        block n's output (block n+1's residual)
    zo = h @ w                      block n+1's 1x1 reduce conv
    s1, s2 = sum zo, sum zo^2       BN1 statistics of block n+1

run as one kernel that writes h once. Each wrapper picks its kernels by
dtype and K3's shape rule (:func:`route`, ``fused_matmul.route`` of (K,
N)):

- ``"bf16_sm90"``: bfloat16 with K and N multiples of 8 (every ResNet-50
  junction) takes ``csrc/fused_chain_sm90.cu`` (bf16 wgmma over the core of
  ``csrc/fused_gemm_sm90.cuh``, the junction made in registers as the A
  operand);
- ``"f32_sm90"``: float32 with K and N multiples of 4 (every ResNet-50
  junction) takes ``csrc/fused_chain_tf32_sm90.cu`` (3xTF32 wgmma over the
  core of ``csrc/fused_gemm_tf32_sm90.cuh``: each float32 operand split
  into tf32 hi and lo halves, three products);
- ``"f32"`` and ``"bf16_ragged"``: other float32 and bfloat16 shapes (any
  K and N) take ``csrc/fused_chain.cu``: the same 3xTF32 and bf16 kernels
  with their ragged load / store policy (element copies of z, r, dh, dzo
  and zo, the weight prepared with zero-padded rows, predicated stores of
  h, zo, dz and dr), so no activation is copied or padded.

Each source's header note says what bounds it on an H100 and what the
design does about it. Besides ``<wrapper>.launches``, each wrapper counts
its launches per route in ``<wrapper>.launches_by_route``.

:func:`fused_chain_fwd` and :func:`fused_chain_bwd` are the wrappers over
flat (M, K) rows: tensors on the CPU take :func:`residual_chain_reference`
/ :func:`residual_chain_bwd_reference` (plain PyTorch with the kernels'
rounding points: h and ``dzo_eff`` rounded to z's dtype, float32 sums and
statistics); tensors on a CUDA device launch the kernels or raise.
:class:`FusedResidualMatmul` is the counterpart of JAX's ``_chain``
``custom_vjp``. JAX's VMEM fitter (and the None it returns when nothing
fits) is not ported: the kernel tiles any shape.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.engine import refuse_unported
from . import _build, _flops
from .fused_matmul import _ALIGNED, _DTYPES, _TC_SPLITS, _PART_ROWS, \
    _RAGGED, _check_aligned, _dz_eff, _f32, _ptr, _stream, _wsplit, route

# each route's (library, symbol) for the forward and backward
_FWD_FN = {"bf16_sm90": ("fused_chain_sm90", "bigdl_fused_chain_sm90_fwd"),
           _RAGGED: ("fused_chain", "bigdl_fused_chain_fwd"),
           "f32_sm90": ("fused_chain_tf32_sm90",
                        "bigdl_fused_chain_tf32_sm90_fwd"),
           "f32": ("fused_chain", "bigdl_fused_chain_fwd")}
_BWD_FN = {"bf16_sm90": ("fused_chain_sm90", "bigdl_fused_chain_sm90_bwd"),
           _RAGGED: ("fused_chain", "bigdl_fused_chain_bwd"),
           "f32_sm90": ("fused_chain_tf32_sm90",
                        "bigdl_fused_chain_tf32_sm90_bwd"),
           "f32": ("fused_chain", "bigdl_fused_chain_bwd")}
_FWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p])


def _junction(z, r, a, b):
    """u = z * a + b + r in float32 (the pre-activation of block n's
    output)."""
    return z.float() * a.float() + b.float() + r.float()


def residual_chain_reference(z, r, a, b, w, stats: bool = True):
    """Plain version: z, r (M, K), a/b (K,), w (K, N). Returns
    ``(h, zo, s1, s2)``: h = relu(z * a + b + r) in z's dtype, zo = h @ w
    summed in float32 and written in z's dtype, s1 / s2 the float32 column
    sums of zo and zo^2 (None without ``stats``)."""
    h = torch.relu(_junction(z, r, a, b)).to(z.dtype)
    zf = h.float() @ w.float()
    if stats:
        return h, zf.to(z.dtype), zf.sum(0), (zf * zf).sum(0)
    return h, zf.to(z.dtype), None, None


def residual_chain_bwd_reference(z, r, a, b, w, zo, dh, dzo, ds1, ds2,
                                 stats: bool):
    """Plain version of the backward: returns ``(dz, dr, da, db, dw)``; dz
    and dr in z's dtype, da / db float32, dw in w's dtype."""
    dt = z.dtype
    d = _dz_eff(dzo, zo, ds1, ds2, dt, stats)
    u = _junction(z, r, a, b)
    g = d @ w.float().T + dh.to(dt).float()
    g = torch.where(u > 0, g, torch.zeros_like(g))
    dw = (torch.relu(u).to(dt).float().T @ d).to(w.dtype)
    return ((g * a.float()).to(dt), g.to(dt), (g * z.float()).sum(0),
            g.sum(0), dw)


def _check(fn, z, r, a, b, w, *like_z):
    for name, t in (("z", z), ("r", r), ("a", a), ("b", b), ("w", w)) + like_z:
        if t.device != z.device:
            raise ValueError(f"{fn}: {name} on {t.device}, z on {z.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{fn}: the kernel builds no autograd graph; "
                             f"differentiate through FusedResidualMatmul or "
                             f"run under torch.no_grad()")
    if z.dtype not in _DTYPES or r.dtype != z.dtype or w.dtype != z.dtype:
        raise TypeError(f"{fn}: z {z.dtype}, r {r.dtype} and w {w.dtype} "
                        f"must be one of float32, bfloat16")
    M, K = z.shape if z.dim() == 2 else (None, None)
    if (z.dim() != 2 or r.shape != z.shape or w.dim() != 2
            or w.shape[0] != K or a.shape != (K,) or b.shape != (K,)):
        raise ValueError(f"{fn}: z{tuple(z.shape)} r{tuple(r.shape)} "
                         f"w{tuple(w.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    for name, t in (("z", z), ("r", r), ("w", w)) + like_z:
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in like_z:
        want = (M, K) if name == "dh" else (M, w.shape[1])
        if t.shape != want:
            raise ValueError(f"{fn}: {name}{tuple(t.shape)}, want {want}")
    if 0 in z.shape or 0 in w.shape:
        raise ValueError(f"{fn}: empty z{tuple(z.shape)} or w{tuple(w.shape)}")
    if z.numel() >= 2**31 or M * w.shape[1] >= 2**31:
        raise ValueError(f"{fn}: z{tuple(z.shape)} is past the kernel's "
                         f"32-bit row and column indices")


def fused_chain_fwd(z, r, a, b, w, stats: bool = True):
    """K5 forward over flat rows: z, r (M, K) and w (K, N) of one dtype
    (float32 or bfloat16), a/b (K,). Returns ``(h, zo, s1, s2)`` (s1/s2
    None without ``stats``)."""
    if z.device.type == "cpu":
        return residual_chain_reference(z, r, a, b, w, stats)
    if z.device.type != "cuda":
        raise RuntimeError(f"fused_chain_fwd: no kernel for device "
                           f"{z.device}")
    _check("fused_chain_fwd", z, r, a, b, w)
    M, K = z.shape
    N = w.shape[1]
    rt = route(z.dtype, K, N)
    if rt in _ALIGNED:
        _check_aligned("fused_chain_fwd", z, r, w)
    h = torch.empty_like(z)
    zo = torch.empty((M, N), dtype=z.dtype, device=z.device)
    part = s = None
    if stats:
        part = torch.empty((2, -(-M // _PART_ROWS[rt]), N), device=z.device)
        s = torch.empty((2, N), device=z.device)
    af, bf = _f32(a), _f32(b)      # held until the launch is queued
    wsp, extra = _wsplit(rt, K, N, z.device)   # held, like af / bf
    fn = _build.function(*_FWD_FN[rt],
                         _FWD_ARGTYPES + [ctypes.c_void_p] * len(extra))
    err = fn(z.data_ptr(), r.data_ptr(), af.data_ptr(), bf.data_ptr(),
             w.data_ptr(), h.data_ptr(), zo.data_ptr(), _ptr(part),
             None if part is None else part[1].data_ptr(), _ptr(s),
             None if s is None else s[1].data_ptr(), _DTYPES[z.dtype], M, K,
             N, int(bool(stats)), _stream(z), *extra)
    if err:
        raise RuntimeError(f"fused_chain_fwd kernel launch failed ({rt}): "
                           f"CUDA error {err}")
    fused_chain_fwd.launches += 1
    _flops.tally("fused_chain_fwd", 2 * M * K * N)
    fused_chain_fwd.launches_by_route[rt] += 1
    return (h, zo, s[0], s[1]) if stats else (h, zo, None, None)


fused_chain_fwd.launches = 0
fused_chain_fwd.launches_by_route = dict.fromkeys(_FWD_FN, 0)


def fused_chain_bwd(z, r, a, b, w, zo, dh, dzo, ds1, ds2, stats: bool = True):
    """K5 backward from the forward's inputs, its ``zo`` (with ``stats``)
    and the gradients ``dh`` (M, K), ``dzo`` (M, N), ``ds1``/``ds2`` (N,)
    (both None count as zero). Returns ``(dz, dr, da, db, dw)``. One count in
    ``fused_chain_bwd.launches`` is one launch of the dz/dr/da/db kernel
    and the dw kernel with their second passes."""
    stats = bool(stats) and ds1 is not None
    if z.device.type == "cpu":
        return residual_chain_bwd_reference(z, r, a, b, w, zo, dh, dzo, ds1,
                                            ds2, stats)
    if z.device.type != "cuda":
        raise RuntimeError(f"fused_chain_bwd: no kernel for device "
                           f"{z.device}")
    dh = dh.to(z.dtype).contiguous()
    dzo = dzo.to(z.dtype).contiguous()
    _check("fused_chain_bwd", z, r, a, b, w, ("dh", dh), ("dzo", dzo),
           *((("zo", zo),) if stats else ()))
    M, K = z.shape
    N = w.shape[1]
    rt = route(z.dtype, K, N)
    if rt in _ALIGNED:
        _check_aligned("fused_chain_bwd", z, r, w, dh, dzo,
                       *((zo,) if stats else ()))
    dz, dr = torch.empty_like(z), torch.empty_like(z)
    dw = torch.empty_like(w)
    dadb = torch.empty((2, K), device=z.device)
    part = torch.empty((2, -(-M // _PART_ROWS[rt]), K), device=z.device)
    splits, per = _TC_SPLITS[rt](M, K, N)   # two partials a split
    ws = torch.empty((2 * splits, K, N), device=z.device)
    af, bf = _f32(a), _f32(b)      # held until the launch is queued
    d1, d2 = (_f32(ds1), _f32(ds2)) if stats else (None, None)
    wsp, extra = _wsplit(rt, K, N, z.device, fwd=False)   # held, like af
    fn = _build.function(*_BWD_FN[rt],
                         _BWD_ARGTYPES + [ctypes.c_void_p] * len(extra))
    err = fn(z.data_ptr(), r.data_ptr(), af.data_ptr(), bf.data_ptr(),
             w.data_ptr(), dh.data_ptr(), dzo.data_ptr(),
             _ptr(zo if stats else None), _ptr(d1), _ptr(d2), dz.data_ptr(),
             dr.data_ptr(), dw.data_ptr(), ws.data_ptr(), part.data_ptr(),
             part[1].data_ptr(), dadb.data_ptr(), dadb[1].data_ptr(),
             _DTYPES[z.dtype], M, K, N, int(stats), splits, per, _stream(z),
             *extra)
    if err:
        raise RuntimeError(f"fused_chain_bwd kernel launch failed ({rt}): "
                           f"CUDA error {err}")
    fused_chain_bwd.launches += 1
    _flops.tally("fused_chain_bwd", 4 * M * K * N)
    fused_chain_bwd.launches_by_route[rt] += 1
    return dz, dr, dadb[0], dadb[1], dw


fused_chain_bwd.launches = 0
fused_chain_bwd.launches_by_route = dict.fromkeys(_BWD_FN, 0)


class FusedResidualMatmul(torch.autograd.Function):
    """``FusedResidualMatmul.apply(z, r, a, b, w, stats)`` -> (h, zo, s1,
    s2) over flat (M, K) rows: the forward through :func:`fused_chain_fwd`,
    saving (z, r, a, b, w, zo), the backward through
    :func:`fused_chain_bwd`. da / db come back in a's / b's dtype."""

    @staticmethod
    def forward(ctx, z, r, a, b, w, stats):
        h, zo, s1, s2 = fused_chain_fwd(z, r, a, b, w, stats)
        ctx.save_for_backward(z, r, a, b, w, zo if stats else None)
        ctx.stats = stats
        return h, zo, s1, s2

    @staticmethod
    def backward(ctx, dh, dzo, ds1, ds2):
        z, r, a, b, w, zo = ctx.saved_tensors
        dz, dr, da, db, dw = fused_chain_bwd(z, r, a, b, w, zo, dh, dzo, ds1,
                                             ds2, ctx.stats)
        return dz, dr, da.to(a.dtype), db.to(b.dtype), dw, None


def fused_residual_matmul_nhwc(z, r, w, scale, bias, *, stats: bool = True,
                               interpret: bool = False):
    """relu(z * scale + bias + r) fused with the next 1x1 conv. z, r
    (B, H, W, K) NHWC (block n's conv3 output and its shortcut); w (K, N)
    the next block's reduce weight; scale/bias (K,) BN3's affine. Returns
    ``(h, z_next, s1, s2)``: h (B, H, W, K) is block n's output, z_next
    (B, H, W, N), s1 / s2 float32 (N,) or None without ``stats``. JAX's
    ``interpret`` is not ported."""
    refuse_unported("fused_residual_matmul_nhwc",
                    interpret=(interpret, False))
    B, H, W, K = z.shape
    h, zo, s1, s2 = FusedResidualMatmul.apply(
        z.reshape(-1, K), r.reshape(-1, K), scale, bias, w, bool(stats))
    return h.view(B, H, W, K), zo.view(B, H, W, w.shape[1]), s1, s2
