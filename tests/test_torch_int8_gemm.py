"""The int8 GEMM's launch plan, its padded operands and its fused epilogue
(``bigdl_tpu_torch.kernels.int8_matmul``), off the card.

* :func:`plan` at every contraction of the int8 Inception v1 B32/224
  forward (57 convolutions and the classifier, the table checked against
  the port's model) and at edge shapes: the tile width at most the
  narrowest that holds N (any for N > 256), the least ``plan_us`` of every
  width and one-wave split, the K parts covering the K steps exactly and
  none empty, a split plan within one wave (tiles x splits <= 132 SMs),
  and the workspace bytes equal to their formula; no split at Inception's
  shapes, a split where one tile runs deep in K.
* The card's operands of a convolution (``_conv_operands``): each group's
  columns padded to a 16-byte row stride, K left at the group's own, and
  the int32 GEMM over the strided views the kernel's tensor maps walk
  equal to JAX's ``lax.conv_general_dilated(..., preferred_element_type=
  int32)`` bit for bit, at Inception's first convolution (K = 147), a 5x5
  at K = 600, a depthwise 3x3, stride 2 and dilation.
* The wrappers' ``scale`` / ``bias`` (the epilogue the kernel fuses): the
  plain path against JAX's ``QuantizedLinear`` / ``QuantizedSpatialConvolution``
  ``_apply`` at the quantized modules' tolerance (1e-5 of the largest
  value), and bit for bit against the unfused torch expression
  ``acc.to(float32) * scale + bias``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from bigdl_tpu import nn as jnn
from bigdl_tpu import quantization as jq
from bigdl_tpu.quantization.quantize import _dynamic_quantize as jax_dq
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.kernels import int8_conv2d, int8_matmul
from bigdl_tpu_torch.kernels.int8_matmul import (
    MAX_K, TILE_K, TILE_NS, _conv_operands, _kmajor, int8_conv2d_reference,
    int8_matmul_reference, plan, plan_us)

torch.set_num_threads(1)
TOL = 1e-5          # quantized modules, of the largest value
SMS = 132           # an H100 SXM's SMs


def inception_v1_contractions(B=32):
    """(name, M, N, K) of the int8 Inception v1 forward at B/224: the 57
    convolutions in model order (M = B Ho Wo, N = output channels, K =
    C kh kw), then the classifier."""
    out = [("conv1/7x7_s2", B * 112 * 112, 64, 147),
           ("conv2/3x3_reduce", B * 56 * 56, 64, 64),
           ("conv2/3x3", B * 56 * 56, 192, 576)]
    blocks = [("3a", 28, 192, (64, 96, 128, 16, 32, 32)),
              ("3b", 28, 256, (128, 128, 192, 32, 96, 64)),
              ("4a", 14, 480, (192, 96, 208, 16, 48, 64)),
              ("4b", 14, 512, (160, 112, 224, 24, 64, 64)),
              ("4c", 14, 512, (128, 128, 256, 24, 64, 64)),
              ("4d", 14, 512, (112, 144, 288, 32, 64, 64)),
              ("4e", 14, 528, (256, 160, 320, 32, 128, 128)),
              ("5a", 7, 832, (256, 160, 320, 32, 128, 128)),
              ("5b", 7, 832, (384, 192, 384, 48, 128, 128))]
    for name, hw, cin, (c1, r3, c3, r5, c5, pp) in blocks:
        M = B * hw * hw
        out += [(f"{name}/1x1", M, c1, cin),
                (f"{name}/3x3_reduce", M, r3, cin),
                (f"{name}/3x3", M, c3, 9 * r3),
                (f"{name}/5x5_reduce", M, r5, cin),
                (f"{name}/5x5", M, c5, 25 * r5),
                (f"{name}/pool_proj", M, pp, cin)]
    out.append(("loss3/classifier", B, 1000, 1024))
    return out


def test_inception_table_is_the_models_layers():
    """The table's N and K, layer by layer, are the port's Inception v1's
    convolutions and classifier."""
    m = models.Inception_v1_NoAuxClassifier(1000, device="cpu", seed=0)
    layers = [(mod.weight.shape[0], int(np.prod(mod.weight.shape[1:])))
              for mod in m.modules()
              if isinstance(mod, (nn.SpatialConvolution, nn.Linear))]
    table = inception_v1_contractions()
    assert len(table) == 58 and len(layers) == 58
    assert [(n, k) for _, _, n, k in table] == layers


def _check_plan(G, M, N, K):
    pl = plan(G, M, N, K, SMS)
    widest = 256 if N > 256 else next(b for b in TILE_NS if b >= N)
    assert pl.tile_m == 128 and pl.tile_n in TILE_NS
    assert pl.tile_n <= widest
    tiles = G * -(-M // 128) * -(-N // pl.tile_n)
    steps = -(-K // TILE_K)
    assert (pl.tiles, pl.steps) == (tiles, steps)
    # the parts cover the K steps exactly, none empty
    S = pl.splits
    parts = [range(p * steps // S, (p + 1) * steps // S) for p in range(S)]
    assert [j for r in parts for j in r] == list(range(steps))
    assert steps == 0 or all(len(r) >= 1 for r in parts)
    if S > 1:     # a split plan is one wave on the card
        assert tiles * S <= SMS
    assert pl.grid == max(1, min(tiles * S, SMS))
    assert pl.workspace_bytes == (tiles * S * 128 * pl.tile_n * 4
                                  if S > 1 else 0)
    # the least modelled time among every width up to the widest and
    # every one-wave split
    own = plan_us(pl.tile_n, S, tiles, steps, SMS)
    for bn in TILE_NS:
        if bn > widest:
            continue
        t = G * -(-M // 128) * -(-N // bn)
        for s in range(1, max(steps, 1) + 1):
            if s > 1 and t * s > SMS:
                break
            assert own <= plan_us(bn, s, t, steps, SMS), (bn, s)
    return pl


@pytest.mark.parametrize("case", inception_v1_contractions(),
                         ids=[c[0] for c in inception_v1_contractions()])
def test_plan_at_inception_b32(case):
    _, M, N, K = case
    pl = _check_plan(1, M, N, K)
    # narrow tiles fill the card at these shapes: no K split pays
    assert pl.splits == 1
    assert pl.tiles >= 40 or M * N <= 128 * 1000


EDGES = [  # G, M, N, K
    (1, 10, 64, 576),          # M < 64: one half-empty tile
    (1, 63, 200, 147),
    (1, 500, 5, 64),           # N < 8
    (256, 6272, 1, 9),         # depthwise 3x3: N = 1, G = 256
    (8, 33, 7, 600),
    (1, 1000, 77, 333),
    (1, 100352, 64, 147),      # conv1 at B8
    (1, 1568, 320, 1440),
    (1, 32, 1000, 1024),
    (1, 16, 288, 9),
    (1, 4096, 24, 600),
    (1, 128, 48, MAX_K),
    (1, 32, 16, 4096),
    (3, 1, 1, 1),
    (1, 5, 5, 0),
]


@pytest.mark.parametrize("case", EDGES, ids=[str(c) for c in EDGES])
def test_plan_at_edge_shapes(case):
    _check_plan(*case)


def test_plan_splits_long_k_over_few_tiles():
    """One tile deep in K is split; the card-filling shapes are not."""
    pl = plan(1, 32, 16, 4096)
    assert (pl.tiles, pl.splits) == (1, 11)
    assert plan(1, 128, 48, MAX_K).splits > 1
    assert plan(1, 1568, 320, 1440) == (128, 32, 1, 130, 12, 130, 0)
    assert plan(1, 401408, 64, 147).tile_n == 64


# -- the padded operands --------------------------------------------------------

def _i8(rng, *shape):
    return rng.randint(-128, 128, shape).astype(np.int8)


PADDED = [  # x shape, w shape, stride, ((top, bottom), (left, right)), dilation, groups
    ((2, 3, 16, 16), (8, 3, 7, 7), (2, 2), ((3, 3), (3, 3)), (1, 1), 1),
    ((1, 24, 9, 9), (16, 24, 5, 5), (1, 1), ((2, 2), (2, 2)), (1, 1), 1),
    ((2, 16, 10, 10), (16, 1, 3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1), 16),
    ((2, 8, 11, 12), (8, 1, 3, 3), (2, 2), ((1, 1), (1, 1)), (1, 1), 8),
    ((2, 6, 12, 13), (10, 3, 3, 3), (1, 2), ((2, 2), (2, 2)), (2, 2), 2),
    ((1, 32, 6, 6), (16, 32, 1, 1), (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
]


@pytest.mark.parametrize("case", PADDED, ids=["conv1_k147", "k600",
                                              "depthwise", "depthwise_s2",
                                              "dilated_grouped", "aligned"])
def test_padded_operands_equal_conv_general_dilated(case):
    xs, ws, stride, pads, dil, groups = case
    rng = np.random.RandomState(sum(xs) + sum(ws) + 7)
    x, w = _i8(rng, *xs), _i8(rng, *ws)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), stride, list(pads),
        rhs_dilation=dil, dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=groups, preferred_element_type=jnp.int32))
    cols, wc, out, (G, M, N, K, lda, ldb, ldc, sa, sb, sc) = \
        _conv_operands(torch.from_numpy(x), torch.from_numpy(w), stride,
                       pads, dil, groups)
    Kg = ws[1] * ws[2] * ws[3]
    Kp = -(-Kg // 16) * 16
    # K stays the group's; the strides are TMA's (multiples of 16 bytes)
    assert (G, N, K) == (groups, ws[0] // groups, Kg)
    assert (lda, ldb, sa, sb) == (groups * Kp, Kp, Kp, N * Kp)
    assert cols.shape == (M, groups * Kp) and wc.shape == (ws[0], Kp)
    assert all(v % 16 == 0 for v in (lda, ldb, sa, sb))
    assert out.dtype == torch.int32 and out.shape[-1] == ws[0]
    # the GEMM over the views the tensor maps walk (columns past K unread)
    flat_a, flat_b, flat_out = cols.reshape(-1), wc.reshape(-1), \
        out.reshape(-1)
    for g in range(G):
        a = flat_a.as_strided((M, K), (lda, 1), g * sa)
        b = flat_b.as_strided((N, K), (ldb, 1), g * sb)
        flat_out.as_strided((M, N), (ldc, 1), g * sc).copy_(
            int8_matmul_reference(a, b))
    np.testing.assert_array_equal(out.permute(0, 3, 1, 2).numpy(), want)
    # a float32 output for the fused epilogue, same operands
    assert _conv_operands(torch.from_numpy(x), torch.from_numpy(w), stride,
                          pads, dil, groups, torch.float32)[2].dtype \
        == torch.float32


@pytest.mark.parametrize("case", PADDED, ids=["conv1_k147", "k600",
                                              "depthwise", "depthwise_s2",
                                              "dilated_grouped", "aligned"])
def test_channels_last_input_gives_the_same_operands(case):
    """A channels-last input (the layout the card's output has) is read
    through its own strides: the same im2col, and for a 1x1 convolution at
    stride 1 no copy at all."""
    xs, ws, stride, pads, dil, groups = case
    rng = np.random.RandomState(sum(xs) + 5)
    x = torch.from_numpy(_i8(rng, *xs))
    w = torch.from_numpy(_i8(rng, *ws))
    xl = x.contiguous(memory_format=torch.channels_last)
    a, wa, _, ga = _conv_operands(x, w, stride, pads, dil, groups)
    b, wb, _, gb = _conv_operands(xl, w, stride, pads, dil, groups)
    K, lda = ga[3], ga[4]
    assert ga == gb and torch.equal(wa[:, :K], wb[:, :K])
    assert torch.equal(a.reshape(a.shape[0], -1, lda // groups)[..., :K],
                       b.reshape(b.shape[0], -1, lda // groups)[..., :K])
    one_by_one = ws[2:] == (1, 1) and stride == (1, 1) and \
        pads == ((0, 0), (0, 0)) and K % 16 == 0
    assert (b.data_ptr() == xl.data_ptr()) == one_by_one


@pytest.mark.parametrize("k", [1, 9, 16, 147, 333, 600])
def test_matmul_operand_padding(k):
    rng = np.random.RandomState(k)
    t = torch.from_numpy(_i8(rng, 3, 5, k))
    got, ld = _kmajor(t)
    assert ld % 16 == 0 and ld >= k and got.shape == (3, 5, ld)
    assert (got is t) == (k % 16 == 0)
    assert torch.equal(got[..., :k], t)


# -- the fused epilogue ---------------------------------------------------------

def _jax_quantized(layer, rng):
    """JAX's quantized layer and its params, with a random bias."""
    q = jq.quantize(jnn.Sequential().add(layer))
    mod, p = q.modules[0], dict(q.params["0"])
    if "bias" in p:
        p["bias"] = jnp.asarray(rng.randn(*p["bias"].shape).astype(
            np.float32))
    return mod, p


def _t(v):
    return torch.from_numpy(np.array(v))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_matmul_epilogue_equals_jax_quantized_linear(bias):
    rng = np.random.RandomState(11)
    mod, p = _jax_quantized(jnn.Linear(147, 24, with_bias=bias), rng)
    x = rng.randn(37, 147).astype(np.float32)
    want = np.asarray(mod._apply(p, None, jnp.asarray(x), False, None))
    xq, xs = jax_dq(jnp.asarray(x))
    s = _t(xs) * _t(p["scale"])
    bv = _t(p["bias"]) if bias else None
    got = int8_matmul(_t(xq), _t(p["qweight"]), scale=s, bias=bv)
    assert got.dtype == torch.float32
    rel = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert rel < TOL, rel
    unfused = int8_matmul_reference(_t(xq), _t(p["qweight"])).to(
        torch.float32) * s
    if bias:
        unfused = unfused + bv
    assert torch.equal(got, unfused)
    # batched over groups: the vectors are shared by the groups
    a2 = torch.stack([_t(xq), _t(xq).flip(0)])
    b2 = torch.stack([_t(p["qweight"])] * 2)
    g2 = int8_matmul(a2, b2, scale=s, bias=bv)
    assert torch.equal(g2[0], got) and torch.equal(g2[1], got.flip(0))


CONV_EPI = [  # layer args, x shape
    ((3, 16, 7, 7, 2, 2, 3, 3), (2, 3, 20, 20)),
    ((24, 8, 5, 5, 1, 1, 2, 2), (1, 24, 9, 9)),
    ((8, 8, 3, 3, 1, 1, 1, 1, 8), (2, 8, 10, 10)),
    ((8, 12, 3, 3, 2, 2, 1, 1, 4), (2, 8, 11, 11)),
]


@pytest.mark.parametrize("case", CONV_EPI, ids=["conv1_k147", "k600",
                                                "depthwise", "grouped_s2"])
def test_conv_epilogue_equals_jax_quantized_convolution(case):
    args, xs = case
    rng = np.random.RandomState(sum(xs))
    kw = {"n_group": args[8]} if len(args) > 8 else {}
    mod, p = _jax_quantized(jnn.SpatialConvolution(*args[:8], **kw), rng)
    x = rng.randn(*xs).astype(np.float32)
    want = np.asarray(mod._apply(p, None, jnp.asarray(x), False, None))
    xq, xs_ = jax_dq(jnp.asarray(x))
    s = _t(xs_) * _t(p["scale"])
    stride, pad = (args[4], args[5]), ((args[6],) * 2, (args[7],) * 2)
    groups = kw.get("n_group", 1)
    got = int8_conv2d(_t(xq), _t(p["qweight"]), stride, pad, 1, groups,
                      scale=s, bias=_t(p["bias"]))
    assert got.dtype == torch.float32 and got.shape == want.shape
    rel = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert rel < TOL, rel
    acc = int8_conv2d_reference(_t(xq), _t(p["qweight"]), stride, pad, 1,
                                groups)
    unfused = acc.to(torch.float32) * s[None, :, None, None] \
        + _t(p["bias"])[None, :, None, None]
    assert torch.equal(got, unfused)
    # no bias: the rescale alone
    assert torch.equal(
        int8_conv2d(_t(xq), _t(p["qweight"]), stride, pad, 1, groups,
                    scale=s),
        acc.to(torch.float32) * s[None, :, None, None])


def test_epilogue_arguments_are_checked():
    a = torch.zeros(4, 32, dtype=torch.int8)
    b = torch.zeros(6, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="needs a scale"):
        int8_matmul(a, b, bias=torch.zeros(6))
    with pytest.raises(ValueError, match="scale of shape"):
        int8_matmul(a, b, scale=torch.zeros(4))
    with pytest.raises(ValueError, match="bias of shape"):
        int8_matmul(a, b, scale=torch.zeros(6), bias=torch.zeros(1))
    x = torch.zeros(1, 4, 5, 5, dtype=torch.int8)
    w = torch.zeros(6, 4, 3, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="scale of shape"):
        int8_conv2d(x, w, scale=torch.zeros(4))
    # the int32 path is unchanged without a scale
    assert int8_matmul(a, b).dtype == torch.int32
