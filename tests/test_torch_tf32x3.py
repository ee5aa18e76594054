"""A torch model of the 3xTF32 numerics of the float32 tensor-core route of
K3 and K5 (``csrc/fused_gemm_tf32_sm90.cuh``), held against the JAX
package's Pallas kernels run in interpret mode.

The kernels split every float32 operand x into hi = tf32_rn(x) and lo =
tf32_rn(x - hi) (``cvt.rna.tf32.f32``: 10 explicit mantissa bits, to
nearest, ties away from zero) and take hi hi + hi lo + lo hi for each
product, a 32-deep chunk at a time, each chunk's sum added to the total in
float32. This file models that in PyTorch on the CPU (tf32 values times
tf32 values are exact in float32, so a float32 matmul of the halves is the
tensor cores' product up to the order of the sums) and shows:

* tf32_rn by bit arithmetic rounds as the instruction does, and hi + lo
  reproduces x within 2^-21 of |x|;
* the modelled kernels hold the Pallas kernels at the float32 route's
  tolerance, 1e-5 of the largest magnitude of each output, for K3 and K5
  forward and backward, with contractions of 64 to 2048 and one weight
  gradient contracted over 3,000 rows;
* one TF32 pass (hi hi alone) misses that tolerance: the reason for three.

On the card ``chip_smoke.py`` holds the kernels themselves against the
plain float32 versions at the same tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.kernels import fused_chain as jfc
from bigdl_tpu.kernels import fused_matmul as jfm

torch.set_num_threads(1)
TOL = 1e-5
CHUNK = 32          # the kernels' contraction depth of one stage


def tf32_rn(x):
    """x (float32, finite) rounded to tf32 and kept as float32: add half of
    the 13 dropped bits' unit to the magnitude bits, then clear them (a
    carry into the exponent rounds up to the next power of two)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rn(x)
    return hi, tf32_rn(x - hi)


def mm3(a, b):
    """a @ b as the kernels take it: per 32-deep chunk of the contraction,
    lo hi + hi lo + hi hi of the tf32 halves in float32, each chunk's sum
    added to the total."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], CHUNK):
        s = slice(k, k + CHUNK)
        out = out + (al[:, s] @ bh[s] + ah[:, s] @ bl[s] + ah[:, s] @ bh[s])
    return out


def mm1(a, b):
    """One TF32 pass: the operands rounded to tf32 once."""
    return tf32_rn(a) @ tf32_rn(b)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-6)


def _arrays(seed, shapes):
    rng = np.random.RandomState(seed)
    out = []
    for shape, kind in shapes:
        a = {"randn": lambda: rng.randn(*shape),
             "w": lambda: rng.randn(*shape) * 0.1,
             "scale": lambda: rng.rand(*shape) + 0.5,
             "small": lambda: rng.randn(*shape) * 0.01}[kind]()
        out.append(a.astype(np.float32))
    return out


# -- tf32_rn and the split ------------------------------------------------------

def test_tf32_rn_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                   # tf32's unit at 1.0
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23,
                      1 + ulp / 2 + 2 ** -23, -(1 + ulp / 2), 2 - 2 ** -23,
                      3 * 2 ** -120, 0.0, -0.0, 65504.0])
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 2.0,
                         3 * 2 ** -120, 0.0, -0.0, 65504.0])
    got = tf32_rn(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    r = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32)) * 10.0 ** torch.randint(-20, 20, (4096,),
                                             generator=torch.Generator()
                                             .manual_seed(0))
    t = tf32_rn(r)
    assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((t - r).abs() <= 2.0 ** -11 * r.abs()).all())


def test_hi_plus_lo_reproduces_x_within_2_to_the_minus_21():
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(20000) * 10.0 ** rng.randint(
        -15, 15, 20000)).astype(np.float32))
    hi, lo = split(x)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    # one half alone is the single TF32 pass's operand: 2^-11 at most
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -14


# -- K3: the modelled kernel against the Pallas kernels --------------------------

def _k3_model(x, w, a, b, dz, ds1, ds2, relu, mm):
    """K3 forward and backward as the 3xTF32 kernels compute them (the
    prologue and dz_eff in float32, each operation rounded)."""
    xh = x * a + b
    if relu:
        xh = torch.relu(xh)
    z = mm(xh, w)
    d = dz + ds1 + 2.0 * z * ds2
    dxh = mm(d, w.T)
    dxn = torch.where(x * a + b > 0, dxh, torch.zeros_like(dxh)) \
        if relu else dxh
    dw = mm(xh.T, d)
    return (z, z.sum(0), (z * z).sum(0), dxn * a, dw, (dxn * x).sum(0),
            dxn.sum(0))


def _k3_pallas(x, w, a, b, dz, ds1, ds2, relu):
    def f(x, w, a, b):
        return jfm.fused_bn_relu_matmul(x, w, a, b, relu=relu, stats=True,
                                        block_m=128, block_n=128,
                                        interpret=True)
    out, vjp = jax.vjp(f, *map(jnp.asarray, (x, w, a, b)))
    return tuple(out) + tuple(vjp(tuple(map(jnp.asarray, (dz, ds1, ds2)))))


K3_SHAPES = [
    # M, K, N: contractions K (z), N (dx) and M (dw)
    (96, 64, 48),
    (64, 2048, 32),
    (64, 32, 2048),
    (3000, 16, 24),
]


def _k3_inputs(M, K, N):
    return _arrays(M + K + N, [((M, K), "randn"), ((K, N), "w"),
                               ((K,), "scale"), ((K,), "randn"),
                               ((M, N), "randn"), ((N,), "randn"),
                               ((N,), "small")])


@pytest.mark.parametrize("M,K,N", K3_SHAPES)
def test_k3_3xtf32_model_holds_the_pallas_kernels(M, K, N):
    arrs = _k3_inputs(M, K, N)
    want = _k3_pallas(*arrs, relu=True)
    got = _k3_model(*map(torch.from_numpy, arrs), relu=True, mm=mm3)
    names = ("z", "s1", "s2", "dx", "dw", "da", "db")
    errs = {n: _rel(g, w) for n, g, w in zip(names, got, want)}
    assert max(errs.values()) <= TOL, errs


# -- K5 -------------------------------------------------------------------------

def _k5_model(z, r, a, b, w, dh, dzo, ds1, ds2, mm):
    """K5 forward and backward over flat rows as the 3xTF32 kernels compute
    them."""
    u = z * a + b + r
    h = torch.relu(u)
    zo = mm(h, w)
    d = dzo + ds1 + 2.0 * zo * ds2
    g = mm(d, w.T) + dh
    g = torch.where(u > 0, g, torch.zeros_like(g))
    dw = mm(h.T, d)
    return (h, zo, zo.sum(0), (zo * zo).sum(0), g * a, g, (g * z).sum(0),
            g.sum(0), dw)


def _k5_pallas(z, r, a, b, w, dh, dzo, ds1, ds2):
    def f(z, r, a, b, w):
        return jfc.fused_residual_matmul_nhwc(z, r, w, a, b, interpret=True)
    out, vjp = jax.vjp(f, *map(jnp.asarray, (z, r, a, b, w)))
    dz, dr, da, db, dw = vjp(tuple(map(jnp.asarray, (dh, dzo, ds1, ds2))))
    return tuple(out) + (dz, dr, da, db, dw)


K5_SHAPES = [
    # B, H, W, K, N: contractions K (zo), N (dz / dr), B H W (dw)
    (2, 6, 6, 256, 64),
    (1, 4, 4, 2048, 32),
    (3, 32, 32, 16, 8),
]


def _k5_inputs(B, H, W, K, N):
    return _arrays(B + H + K + N, [
        ((B, H, W, K), "randn"), ((B, H, W, K), "randn"), ((K,), "scale"),
        ((K,), "randn"), ((K, N), "w"), ((B, H, W, K), "randn"),
        ((B, H, W, N), "randn"), ((N,), "randn"), ((N,), "small")])


@pytest.mark.parametrize("B,H,W,K,N", K5_SHAPES)
def test_k5_3xtf32_model_holds_the_pallas_kernels(B, H, W, K, N):
    arrs = _k5_inputs(B, H, W, K, N)
    want = _k5_pallas(*arrs)
    flat = [torch.from_numpy(t.reshape(-1, t.shape[-1]) if t.ndim == 4
                             else t) for t in arrs]
    got = _k5_model(*flat, mm=mm3)
    names = ("h", "zo", "s1", "s2", "dz", "dr", "da", "db", "dw")
    errs = {n: _rel(g, np.asarray(w).reshape(g.shape))
            for n, g, w in zip(names, got, want)}
    assert max(errs.values()) <= TOL, errs


# -- the control: one TF32 pass --------------------------------------------------

def test_one_tf32_pass_misses_the_float32_tolerance():
    """hi hi alone (2^-11 per operand) leaves K3's and K5's outputs a few
    1e-4 off the Pallas kernels: above 1e-5, where three passes stay."""
    arrs = _k3_inputs(96, 64, 48)
    want = _k3_pallas(*arrs, relu=True)
    one = _k3_model(*map(torch.from_numpy, arrs), relu=True, mm=mm1)
    three = _k3_model(*map(torch.from_numpy, arrs), relu=True, mm=mm3)
    e1 = max(_rel(g, w) for g, w in zip(one, want))
    e3 = max(_rel(g, w) for g, w in zip(three, want))
    assert e3 <= TOL < 3 * TOL < e1, (e3, e1)
    arrs = _k5_inputs(2, 6, 6, 256, 64)
    want = _k5_pallas(*arrs)
    flat = [torch.from_numpy(t.reshape(-1, t.shape[-1]) if t.ndim == 4
                             else t) for t in arrs]
    e1 = max(_rel(g, np.asarray(w).reshape(g.shape))
             for g, w in zip(_k5_model(*flat, mm=mm1), want))
    assert e1 > 3 * TOL, e1
