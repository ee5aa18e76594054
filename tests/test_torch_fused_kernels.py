"""The port's fused ResNet kernels (K3, K3-nhwc, K5, K4), held against the
JAX package's Pallas kernels run in interpret mode.

On the CPU each wrapper of ``bigdl_tpu_torch.kernels`` runs its plain
PyTorch version, so these tests pin the plain versions, and the
``autograd.Function`` around them, to the Pallas kernels' function and
``custom_vjp``: values, statistics and every gradient through a loss that
touches every output. The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.

Tolerances, as the largest error over the largest magnitude of the JAX
result, per output:

* float32: 1e-5 for values and statistics, 1e-4 for gradients. Both
  sides round at the same points (the prologue and ``dz_eff`` to the
  input dtype) and sum in float32 in another order. Values agree to about
  1e-6; the gradients of the losses that normalise by the kernels'
  one-pass variance s2 / m - mean^2 (as BatchNorm does) carry that
  subtraction's cancellation, observed up to 2.1e-5 (the JAX package's own
  kernel tests allow 2e-4 there).
* bfloat16: 1e-2 for values, statistics and gradients. A float32 sum
  that lands on the other side of a bf16 rounding boundary moves a result
  by one bf16 ulp (2^-8 relative), and a rounded ``dz_eff`` carries that
  into the gradients.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.kernels import fused_chain as jfc
from bigdl_tpu.kernels import fused_conv as jcv
from bigdl_tpu.kernels import fused_matmul as jfm
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.kernels import (_build, fused_bn_relu_conv3x3,
                                     fused_bn_relu_matmul,
                                     fused_bn_relu_matmul_nhwc,
                                     fused_residual_matmul_nhwc)

torch.set_num_threads(1)
F32, BF16 = "float32", "bfloat16"
VAL_TOL = {F32: 1e-5, BF16: 1e-2}
GRAD_TOL = {F32: 1e-4, BF16: 1e-2}
TORCH_DT = {F32: torch.float32, BF16: torch.bfloat16}


def _rel(got, want):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-6)


def _inputs(seed, shapes, dt):
    """Arrays from a numpy seed: JAX arrays and leaf tensors of dtype
    ``dt`` holding the same (rounded) values."""
    rng = np.random.RandomState(seed)
    out_j, out_t = [], []
    for shape, kind in shapes:
        a = {"randn": lambda: rng.randn(*shape),
             "w": lambda: rng.randn(*shape) * 0.1,
             "scale": lambda: rng.rand(*shape) + 0.5}[kind]()
        a = a.astype(np.float32)
        out_j.append(jnp.asarray(a).astype(dt))
        out_t.append(torch.from_numpy(a).to(TORCH_DT[dt]).requires_grad_())
    return out_j, out_t


def _stat_loss(z, s1, s2, xp):
    """A loss touching z and, when given, s1 and s2 (float32)."""
    zf = z.astype(jnp.float32) if xp is jnp else z.float()
    loss = xp.sum(xp.tanh(zf * 0.3))
    if s1 is not None:
        loss = loss + xp.sum(s1 * 0.01) + xp.sum(s2 * 0.001)
    return loss


# -- K3 / K3-nhwc -------------------------------------------------------------

K3_CASES = [
    # M, K, N, prologue, relu, stats, dtype
    (300, 24, 40, True, True, True, F32),    # ragged M (300 = 2 x 128 + 44)
    (300, 24, 40, True, True, True, BF16),
    (64, 16, 24, False, False, True, F32),   # a block entry: no prologue
    (77, 16, 24, True, True, False, F32),    # eval: no statistics
    (77, 16, 24, False, True, True, F32),    # ReLU without an affine
    (130, 136, 72, True, True, True, BF16),  # K and N past one tile
    (77, 72, 40, True, True, False, BF16),   # bf16 eval; K not a multiple of 64
    (200, 16, 136, False, True, True, BF16),  # bf16 ReLU alone, ragged M
    # ragged K and N (the f32 / bf16_ragged routes on the card): K ends
    # mid-k8 / mid-k16 (63, 130, 6), N not a multiple of 4 or 8
    (129, 63, 50, True, True, True, F32),
    (129, 63, 50, True, True, True, BF16),
    (257, 130, 70, False, False, True, F32),
    (257, 130, 70, False, False, True, BF16),
    (77, 6, 24, True, True, True, F32),
    (77, 6, 24, True, True, False, BF16),
]


@pytest.mark.parametrize("M,K,N,prologue,relu,stats,dt", K3_CASES)
def test_fused_matmul_plain_matches_pallas_interpret(M, K, N, prologue, relu,
                                                     stats, dt):
    shapes = [((M, K), "randn"), ((K, N), "w")]
    if prologue:
        shapes += [((K,), "scale"), ((K,), "randn")]
    js, ts = _inputs(M + K + N, shapes, dt)

    def jfwd(*args):
        x, w, *ab = args
        a, b = ab if ab else (None, None)
        return jfm.fused_bn_relu_matmul(x, w, a, b, relu=relu, stats=stats,
                                        block_m=128, block_n=128,
                                        interpret=True)

    def jloss(*args):
        z, s1, s2 = jfwd(*args)
        return _stat_loss(z, s1 if stats else None, s2, jnp)

    jz, js1, js2 = jfwd(*js)
    jg = jax.grad(jloss, argnums=tuple(range(len(js))))(*js)
    x, w, *ab = ts
    a, b = ab if ab else (None, None)
    z, s1, s2 = fused_bn_relu_matmul(x, w, a, b, relu=relu, stats=stats)
    assert z.dtype == TORCH_DT[dt] and z.shape == (M, N)
    assert _rel(z, jz) <= VAL_TOL[dt]
    if stats:
        assert s1.dtype == s2.dtype == torch.float32
        assert _rel(s1, js1) <= VAL_TOL[dt] and _rel(s2, js2) <= VAL_TOL[dt]
    else:
        assert s1 is None and s2 is None
    _stat_loss(z, s1, s2, torch).backward()
    for name, t, g in zip("xwab", ts, jg):
        assert t.grad.dtype == t.dtype, name
        assert _rel(t.grad, g) <= GRAD_TOL[dt], (name, _rel(t.grad, g))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_fused_matmul_nhwc_plain_matches_pallas_interpret(dt):
    B, H, W, K, N = 2, 6, 4, 16, 32
    js, ts = _inputs(7, [((B, H, W, K), "randn"), ((K, N), "w"),
                         ((K,), "scale"), ((K,), "randn")], dt)

    def jloss(x, w, a, b):
        z, s1, s2 = jfm.fused_bn_relu_matmul_nhwc(x, w, a, b,
                                                  interpret=True)
        return _stat_loss(z, s1, s2, jnp)

    jz, js1, js2 = jfm.fused_bn_relu_matmul_nhwc(*js, interpret=True)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*js)
    z, s1, s2 = fused_bn_relu_matmul_nhwc(*ts)
    assert z.shape == (B, H, W, N)
    for got, want in ((z, jz), (s1, js1), (s2, js2)):
        assert _rel(got, want) <= VAL_TOL[dt]
    _stat_loss(z, s1, s2, torch).backward()
    for name, t, g in zip("xwab", ts, jg):
        assert _rel(t.grad, g) <= GRAD_TOL[dt], (name, _rel(t.grad, g))


# -- K5 -----------------------------------------------------------------------

def _chain_loss(h, zo, s1, s2, m, xp):
    """The JAX package's chain-kernel test loss: a BatchNorm of zo from the
    kernel's statistics, then tanh, plus sin(h)."""
    f32 = (lambda v: v.astype(jnp.float32)) if xp is jnp else \
        (lambda v: v.float())
    rsqrt = jax.lax.rsqrt if xp is jnp else torch.rsqrt
    mean = s1 / m
    var = s2 / m - mean ** 2
    zh = (f32(zo) - mean) * rsqrt(var + 1e-5)
    return xp.sum(xp.tanh(zh * 0.3)) + 0.5 * xp.sum(xp.sin(f32(h)))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_fused_chain_plain_matches_pallas_interpret(dt):
    B, H, W, K, N = 2, 4, 4, 48, 24
    js, ts = _inputs(11, [((B, H, W, K), "randn"), ((B, H, W, K), "randn"),
                          ((K,), "scale"), ((K,), "randn"), ((K, N), "w")],
                     dt)
    m = B * H * W

    def jfwd(z, r, a, b, w):
        return jfc.fused_residual_matmul_nhwc(z, r, w, a, b, interpret=True)

    jout = jfwd(*js)
    jg = jax.grad(lambda *a: _chain_loss(*jfwd(*a), m, jnp),
                  argnums=(0, 1, 2, 3, 4))(*js)
    z, r, a, b, w = ts
    out = fused_residual_matmul_nhwc(z, r, w, a, b)
    assert out[0].shape == (B, H, W, K) and out[1].shape == (B, H, W, N)
    for got, want in zip(out, jout):
        assert _rel(got, want) <= VAL_TOL[dt]
    _chain_loss(*out, m, torch).backward()
    for name, t, g in zip("zrabw", ts, jg):
        assert t.grad.dtype == t.dtype, name
        assert _rel(t.grad, g) <= GRAD_TOL[dt], (name, _rel(t.grad, g))


@pytest.mark.parametrize("K,N,dt", [(42, 20, F32), (42, 20, BF16),
                                    (24, 6, F32), (24, 6, BF16),
                                    (63, 50, F32)])
def test_fused_chain_ragged_junctions_match_pallas_interpret(K, N, dt):
    """Junctions whose K or N is not a multiple of 4 (float32) or 8 (bf16),
    the ragged routes on the card, at the loss of
    test_fused_chain_plain_matches_pallas_interpret."""
    B, H, W = 2, 3, 5
    js, ts = _inputs(K + N, [((B, H, W, K), "randn"), ((B, H, W, K), "randn"),
                             ((K,), "scale"), ((K,), "randn"), ((K, N), "w")],
                     dt)
    m = B * H * W

    def jfwd(z, r, a, b, w):
        return jfc.fused_residual_matmul_nhwc(z, r, w, a, b, interpret=True)

    jout = jfwd(*js)
    jg = jax.grad(lambda *a: _chain_loss(*jfwd(*a), m, jnp),
                  argnums=(0, 1, 2, 3, 4))(*js)
    z, r, a, b, w = ts
    out = fused_residual_matmul_nhwc(z, r, w, a, b)
    assert out[0].shape == (B, H, W, K) and out[1].shape == (B, H, W, N)
    for got, want in zip(out, jout):
        assert _rel(got, want) <= VAL_TOL[dt]
    _chain_loss(*out, m, torch).backward()
    for name, t, g in zip("zrabw", ts, jg):
        assert t.grad.dtype == t.dtype, name
        assert _rel(t.grad, g) <= GRAD_TOL[dt], (name, _rel(t.grad, g))


def test_fused_chain_without_stats_matches_pallas_interpret():
    B, H, W, K, N = 2, 3, 5, 32, 16
    js, ts = _inputs(12, [((B, H, W, K), "randn"), ((B, H, W, K), "randn"),
                          ((K,), "scale"), ((K,), "randn"), ((K, N), "w")],
                     F32)

    def jloss(z, r, a, b, w):
        h, zo, _, _ = jfc.fused_residual_matmul_nhwc(z, r, w, a, b,
                                                     stats=False,
                                                     interpret=True)
        return jnp.sum(jnp.tanh(zo)) + jnp.sum(jnp.sin(h))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*js)
    z, r, a, b, w = ts
    h, zo, s1, s2 = fused_residual_matmul_nhwc(z, r, w, a, b, stats=False)
    assert s1 is None and s2 is None
    (torch.tanh(zo).sum() + torch.sin(h).sum()).backward()
    for name, t, g in zip("zrabw", ts, jg):
        assert _rel(t.grad, g) <= GRAD_TOL[F32], (name, _rel(t.grad, g))


# -- K4 -----------------------------------------------------------------------

@pytest.mark.parametrize("B,H,W,C,N,stride,dt", [
    (2, 8, 8, 16, 24, 1, F32),
    (2, 8, 8, 16, 24, 2, F32),
    (2, 7, 5, 16, 8, 2, F32),      # odd planes: the last tap in the padding
    (2, 8, 8, 16, 24, 1, BF16),
    (2, 8, 8, 16, 24, 2, BF16),
    (2, 7, 5, 16, 8, 2, BF16),     # odd planes in bf16
    (1, 5, 6, 72, 16, 1, BF16),    # C not a multiple of 64: chunks span taps
    # truly ragged: C not a multiple of 4 or 8, N odd (the ragged routes)
    (2, 8, 8, 50, 50, 1, F32),
    (2, 7, 5, 20, 13, 2, F32),
    (2, 8, 8, 50, 50, 1, BF16),
    (1, 6, 6, 7, 13, 2, BF16),
])
def test_fused_conv_plain_matches_pallas_interpret(B, H, W, C, N, stride, dt):
    js, ts = _inputs(B + H + C + stride, [
        ((B, H, W, C), "randn"), ((3, 3, C, N), "w"), ((C,), "scale"),
        ((C,), "randn")], dt)

    def jfwd(x, w, a, b):
        return jcv.fused_bn_relu_conv3x3(x, w, a, b, stride=stride,
                                         interpret=True)

    def loss(z, s1, s2, xp):
        f32 = z.astype(jnp.float32) if xp is jnp else z.float()
        rsqrt = jax.lax.rsqrt if xp is jnp else torch.rsqrt
        m = z.shape[0] * z.shape[1] * z.shape[2]
        mean = s1 / m
        zh = (f32 - mean) * rsqrt(s2 / m - mean ** 2 + 1e-5)
        return xp.sum(xp.tanh(zh * 0.3))

    jz, js1, js2 = jfwd(*js)
    jg = jax.grad(lambda *a: loss(*jfwd(*a), jnp), argnums=(0, 1, 2, 3))(*js)
    z, s1, s2 = fused_bn_relu_conv3x3(*ts, stride=stride)
    assert z.shape == (B, -(-H // stride), -(-W // stride), N)
    for got, want in ((z, jz), (s1, js1), (s2, js2)):
        assert _rel(got, want) <= VAL_TOL[dt]
    loss(z, s1, s2, torch).backward()
    for name, t, g in zip("xwab", ts, jg):
        assert t.grad.dtype == t.dtype, name
        assert _rel(t.grad, g) <= GRAD_TOL[dt], (name, _rel(t.grad, g))


def test_fused_conv_without_stats_matches_pallas_interpret():
    """bf16, stride 2 over odd planes, no statistics (the Pallas kernel
    leaves them unwritten; the port returns None)."""
    B, H, W, C, N = 2, 7, 7, 24, 16
    js, ts = _inputs(21, [((B, H, W, C), "randn"), ((3, 3, C, N), "w"),
                          ((C,), "scale"), ((C,), "randn")], BF16)

    def jz(x, w, a, b):
        return jcv.fused_bn_relu_conv3x3(x, w, a, b, stride=2, stats=False,
                                         interpret=True)[0]

    jg = jax.grad(lambda *a: jnp.sum(jnp.tanh(jz(*a).astype(jnp.float32))),
                  argnums=(0, 1, 2, 3))(*js)
    z, s1, s2 = fused_bn_relu_conv3x3(*ts, stride=2, stats=False)
    assert s1 is None and s2 is None and z.shape == (B, 4, 4, N)
    assert _rel(z, jz(*js)) <= VAL_TOL[BF16]
    torch.tanh(z.float()).sum().backward()
    for name, t, g in zip("xwab", ts, jg):
        assert _rel(t.grad, g) <= GRAD_TOL[BF16], (name, _rel(t.grad, g))


def test_fused_conv_padding_comes_after_the_prologue():
    """A tap in the zero padding contributes 0, not relu(b): with x = 0
    and b = 1, every output sees relu(b) only from in-plane taps."""
    x = torch.zeros(1, 3, 3, 1)
    w = torch.ones(3, 3, 1, 1)
    z, _, _ = fused_bn_relu_conv3x3(x, w, torch.ones(1), torch.ones(1))
    want = torch.tensor([[4., 6., 4.], [6., 9., 6.], [4., 6., 4.]])
    torch.testing.assert_close(z[0, :, :, 0], want, atol=0, rtol=0)


# -- wrappers and build -------------------------------------------------------

def test_cpu_runs_launch_no_kernel_and_other_devices_raise():
    kernels.reset_launch_counts()
    x = torch.randn(8, 4)
    w = torch.randn(4, 3)
    fused_bn_relu_matmul(x, w, torch.ones(4), torch.zeros(4))
    fused_residual_matmul_nhwc(torch.randn(1, 2, 2, 4), torch.randn(1, 2, 2, 4),
                               w, torch.ones(4), torch.zeros(4))
    fused_bn_relu_conv3x3(torch.randn(1, 3, 3, 4), torch.randn(3, 3, 4, 2),
                          torch.ones(4), torch.zeros(4))
    assert set(kernels.launch_counts().values()) == {0}
    meta = torch.empty(8, 4, device="meta")
    for fn, args in ((kernels.fused_matmul_fwd, (meta, w.to("meta"))),
                     (kernels.fused_chain_fwd, (meta, meta, torch.ones(
                         4, device="meta"), torch.ones(4, device="meta"),
                         w.to("meta"))),
                     (kernels.fused_conv_fwd, (meta[None, None], w.to(
                         "meta"), meta[0], meta[0]))):
        with pytest.raises(RuntimeError, match="no kernel for device"):
            fn(*args)


def test_each_library_digest_covers_the_headers_its_source_includes():
    """A library's digest covers every header under csrc/ that its source
    includes, directly or through another header."""
    def includes(f, seen):
        for h in re.findall(r'#include "([^"]+)"',
                            (_build.CSRC / f).read_text()):
            if h not in seen:
                seen.add(h)
                includes(h, seen)
        return seen

    for name, (source, *headers) in _build.SOURCES.items():
        assert sorted(includes(source, set())) == sorted(headers), name
    attention = {n for n, f in _build.SOURCES.items()
                 if "attn_tile.cuh" in f}
    fused = {n for n, f in _build.SOURCES.items() if "fused_gemm.cuh" in f}
    assert attention == {"paged_attention", "paged_attention_sm90"}
    assert fused == {"fused_matmul", "fused_chain", "fused_conv",
                     "fused_matmul_sm90", "fused_conv_sm90",
                     "fused_chain_sm90", "fused_matmul_tf32_sm90",
                     "fused_chain_tf32_sm90", "fused_conv_tf32_sm90",
                     "flash_fwd_tf32_sm90", "flash_bwd_tf32_sm90"}
