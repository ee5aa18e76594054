"""A torch model of the 3xTF32 numerics of K4's float32 route on the
tensor cores (``csrc/fused_conv_tf32_sm90.cu`` over
``csrc/fused_gemm_tf32_sm90.cuh``), held against the JAX package's Pallas
kernel ``fused_bn_relu_conv3x3`` run in interpret mode.

The kernel is an implicit GEMM: output pixels are rows, the contraction
runs over the 9 C (tap, channel) pairs in the HWIO weight's row order, and
each 32-deep chunk of it is one tap and 32 channels (C a multiple of 32).
The ragged route (``csrc/fused_conv.cu``, any C) runs the same core over
a tap-major contraction whose taps are padded with zero channels to Cp, C
rounded up to 32, so that a chunk is still one tap: the model pads the
gathered rows and the weight alike.
For each chunk it gathers the shifted input pixels, applies relu(x * a +
b) in float32 (each operation rounded), sets a tap that lies in the zero
padding to 0 after that prologue (not relu(b)), splits the values and the
weight into tf32 hi and lo halves (``tests/test_torch_tf32x3.py``'s
``split``) and adds the chunk's three products (lo hi, hi lo, hi hi) to
the float32 sum. The model does the same with whole tensors, at stride 1
and 2 and with b > 0, so a wrongly placed padding would show; one TF32
pass misses the float32 route's tolerance (1e-5 of the largest magnitude
of each output), which three passes hold.

On the card ``chip_smoke.py`` holds the kernel itself against the plain
float32 version at every ResNet-50 shape.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.kernels import fused_conv as jfc
from test_torch_tf32x3 import CHUNK, TOL, _rel, split

torch.set_num_threads(1)


def gather9(x, a, b, stride):
    """(B * H2 * W2, 9 C) rows of the implicit GEMM: relu(x * a + b) of
    each tap's input pixel, 0 where the tap lies in the zero padding;
    columns in the weight's (dy, dx, c) order."""
    B, H, W, C = x.shape
    xh = torch.relu(x * a + b)
    xp = torch.nn.functional.pad(xh, (0, 0, 1, 1, 1, 1))
    H2, W2 = -(-H // stride), -(-W // stride)
    taps = [xp[:, dy:dy + stride * H2:stride, dx:dx + stride * W2:stride]
            for dy in range(3) for dx in range(3)]
    return torch.cat(taps, -1).reshape(B * H2 * W2, 9 * C), (B, H2, W2)


def pad_taps(m, C, Cp, axis):
    """m with its 9 C (tap, channel) columns (axis 1) or rows (axis 0)
    zero-padded tap by tap to 9 Cp."""
    t = m.reshape(m.shape[0], 9, C) if axis == 1 else m.reshape(9, C, -1)
    pad = (0, Cp - C) if axis == 1 else (0, 0, 0, Cp - C)
    t = torch.nn.functional.pad(t, pad)
    return t.reshape(m.shape[0], 9 * Cp) if axis == 1 else t.reshape(
        9 * Cp, -1)


def conv_model(x, w, a, b, stride, passes=3):
    """(z, s1, s2) as the 3xTF32 kernels compute them (passes=3), or with
    one TF32 pass (hi hi alone, passes=1): C a multiple of 32 as the
    aligned kernel (Cp = C), any other C as the ragged one (each tap's
    channels padded to Cp, the next multiple of 32)."""
    C, N = x.shape[3], w.shape[3]
    Cp = -(-C // CHUNK) * CHUNK    # a chunk of the contraction is one tap
    A, (B, H2, W2) = gather9(x, a, b, stride)
    A = pad_taps(A, C, Cp, 1)
    W9 = pad_taps(w.reshape(9 * C, N), C, Cp, 0)
    (ah, al), (bh, bl) = split(A), split(W9)
    z = torch.zeros(A.shape[0], N)
    for k in range(0, 9 * Cp, CHUNK):
        s = slice(k, k + CHUNK)
        if passes == 3:
            part = al[:, s] @ bh[s] + ah[:, s] @ bl[s] + ah[:, s] @ bh[s]
        else:
            part = ah[:, s] @ bh[s]
        z = z + part
    return z.reshape(B, H2, W2, N), z.sum(0), (z * z).sum(0)


def _inputs(seed, B, H, C, N, bias):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, H, C).astype(np.float32)
    w = (rng.randn(3, 3, C, N) * 0.1).astype(np.float32)
    a = (rng.rand(C) + 0.5).astype(np.float32)
    b = (np.full(C, bias) if bias is not None else rng.randn(C)).astype(
        np.float32)
    return x, w, a, b


def _pallas(x, w, a, b, stride):
    return jfc.fused_bn_relu_conv3x3(*map(jnp.asarray, (x, w, a, b)),
                                     stride=stride, stats=True,
                                     interpret=True)


CASES = [
    # B, H, C, N, stride, b (None: random)
    (2, 7, 64, 64, 1, 1.0),     # every pad tap would give relu(1) = 1
    (2, 9, 64, 40, 2, 1.0),     # stride 2, odd H
    (1, 6, 32, 36, 1, None),
    (1, 8, 96, 32, 2, 2.0),
    (2, 8, 50, 50, 1, 1.0),     # the ragged route: taps padded 50 -> 64
    (2, 7, 20, 13, 2, None),    # ... 20 -> 32, N odd, stride 2
]


@pytest.mark.parametrize("B,H,C,N,stride,bias", CASES)
def test_k4_3xtf32_model_holds_the_pallas_kernel(B, H, C, N, stride, bias):
    arrs = _inputs(B + H + C + N, B, H, C, N, bias)
    want = _pallas(*arrs, stride)
    got = conv_model(*map(torch.from_numpy, arrs), stride)
    errs = {n: _rel(g, np.asarray(w))
            for n, g, w in zip(("z", "s1", "s2"), got, want)}
    assert max(errs.values()) <= TOL, errs


def test_padding_after_the_prologue_matters():
    """With b = 1 a tap in the zero padding gives 0; taking relu(b) there
    (the prologue after the padding) is far off the Pallas kernel."""
    x, w, a, b = _inputs(3, 2, 7, 32, 16, 1.0)
    want = np.asarray(_pallas(x, w, a, b, 1)[0])
    t = list(map(torch.from_numpy, (x, w, a, b)))
    xp = torch.nn.functional.pad(torch.relu(t[0] * t[2] + t[3]),
                                 (0, 0, 1, 1, 1, 1), value=1.0)
    taps = [xp[:, dy:dy + 7, dx:dx + 7] for dy in range(3) for dx in range(3)]
    wrong = torch.cat(taps, -1).reshape(-1, 9 * 32) @ t[1].reshape(-1, 16)
    assert _rel(wrong.reshape(want.shape), want) > 1e-2
    assert _rel(conv_model(*t, 1)[0], want) <= TOL


def test_one_tf32_pass_misses_the_k4_tolerance():
    arrs = _inputs(11, 2, 7, 64, 64, None)
    want = _pallas(*arrs, 1)
    t = list(map(torch.from_numpy, arrs))
    e3 = max(_rel(g, np.asarray(w)) for g, w in zip(conv_model(*t, 1), want))
    e1 = max(_rel(g, np.asarray(w))
             for g, w in zip(conv_model(*t, 1, passes=1), want))
    assert e3 <= TOL < 3 * TOL < e1, (e3, e1)
