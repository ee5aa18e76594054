"""The port's pooling, convolutions, normalisations and initialisers
against the JAX package (``nn/pool.py``, ``nn/conv.py``, ``nn/norm.py``,
``nn/init.py``).

Output, new state, parameter and input gradients of sum(sin(out / 2)) at
1e-5, in training and evaluation mode, on JAX's parameters redrawn from a
numpy seed (BatchNorm with non-trivial running statistics). The pooling
cases cover the windows where torch's own modes differ from JAX's: ceil
mode at ragged sizes and with the kernel smaller than the stride (JAX
keeps a last window that starts past the input when pad is 0, torch's
``ceil_mode`` drops it), ``count_include_pad`` on ceil windows (JAX
divides by kh * kw, the ceil padding included; Inception v2's auxiliary
head, 5x5/3 over 7x7), SAME padding (pad -1) at stride 2, and ties in both
max-pool gradient modes. Each pitfall also has a test that a naive torch
call gets it wrong.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import init as jinit
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import init as tinit
from torch_parity_helpers import check_pair, close

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _relu(*shape, seed=0):
    """Half the entries 0: windows with tied maxima, as after a ReLU."""
    return np.maximum(_x(*shape, seed=seed), 0.0)


def _bn_state(n, seed=9):
    rng = np.random.RandomState(seed)
    return lambda js: {"running_mean": rng.randn(n).astype(np.float32),
                       "running_var": (rng.rand(n) + 0.5).astype(np.float32)}


CASES = {
    # pooling
    "max_floor_pad": (lambda m: m.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
                      _x(2, 3, 9, 8)),
    "max_ceil_ragged": (lambda m: m.SpatialMaxPooling(3, 3, 2, 2).ceil(),
                        _x(2, 3, 10, 9)),
    "max_ceil_k_lt_s": (lambda m: m.SpatialMaxPooling(2, 2, 3, 3).ceil(),
                        _x(2, 3, 7, 8)),
    "max_ceil_pad": (lambda m: m.SpatialMaxPooling(3, 3, 2, 2, 1, 1).ceil(),
                     _x(2, 3, 8, 10)),
    "max_same_s2": (lambda m: m.SpatialMaxPooling(3, 3, 2, 2, -1, -1),
                    _x(2, 3, 8, 7)),
    "max_exact_ties": (lambda m: m.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
                       _relu(2, 3, 9, 9)),
    "max_fast_ties": (lambda m: m.SpatialMaxPooling(
        3, 3, 2, 2, 1, 1, grad_mode="fast"), _relu(2, 3, 9, 9)),
    "max_fast_ceil_nhwc": (lambda m: m.SpatialMaxPooling(
        3, 3, 2, 2, format="NHWC", grad_mode="fast").ceil(),
        _relu(2, 8, 9, 3)),
    "max_nhwc_ceil": (lambda m: m.SpatialMaxPooling(
        2, 2, 3, 3, format="NHWC").ceil(), _x(2, 7, 8, 3)),
    "max_unbatched": (lambda m: m.SpatialMaxPooling(2, 2), _x(3, 6, 6)),
    "avg_window": (lambda m: m.SpatialAveragePooling(3, 3, 2, 2, 1, 1),
                   _x(2, 3, 9, 8)),
    "avg_ceil_include_pad": (lambda m: m.SpatialAveragePooling(
        3, 3, 2, 2).ceil(), _x(2, 3, 10, 9)),
    "avg_aux_head_5x5s3": (lambda m: m.SpatialAveragePooling(
        5, 5, 3, 3).ceil(), _x(2, 4, 7, 7)),
    "avg_ceil_exclude_pad": (lambda m: m.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1, ceil_mode=True, count_include_pad=False),
        _x(2, 3, 8, 10)),
    "avg_ceil_k_lt_s": (lambda m: m.SpatialAveragePooling(
        2, 2, 3, 3, ceil_mode=True), _x(2, 3, 7, 8)),
    "avg_same_s2": (lambda m: m.SpatialAveragePooling(3, 3, 2, 2, -1, -1),
                    _x(2, 3, 8, 7)),
    "avg_same_exclude_pad": (lambda m: m.SpatialAveragePooling(
        3, 3, 2, 2, -1, -1, count_include_pad=False), _x(2, 3, 8, 7)),
    "avg_no_divide": (lambda m: m.SpatialAveragePooling(
        2, 2, 2, 2, divide=False), _x(2, 3, 6, 6)),
    "avg_pad_exclude_floor": (lambda m: m.SpatialAveragePooling(
        3, 3, 1, 1, 1, 1, count_include_pad=False), _x(2, 3, 5, 5)),
    "avg_global": (lambda m: m.SpatialAveragePooling(
        7, 7, global_pooling=True), _x(2, 3, 5, 4)),
    "avg_global_sum": (lambda m: m.SpatialAveragePooling(
        7, 7, global_pooling=True, divide=False), _x(2, 3, 5, 4)),
    "avg_nhwc_ceil": (lambda m: m.SpatialAveragePooling(
        3, 3, 2, 2, format="NHWC").ceil(), _x(2, 10, 9, 3)),
    "temporal_max": (lambda m: m.TemporalMaxPooling(3, 2), _relu(2, 9, 4)),
    "temporal_max_unbatched": (lambda m: m.TemporalMaxPooling(2),
                               _x(8, 4)),
    "volumetric_max": (lambda m: m.VolumetricMaxPooling(2, 2, 2, 2, 2, 2,
                                                        1, 0, 1),
                       _x(2, 2, 5, 6, 5)),
    "volumetric_max_ceil": (lambda m: m.VolumetricMaxPooling(
        2, 3, 3, 2, 2, 2).ceil(), _x(2, 2, 5, 6, 7)),
    "volumetric_avg": (lambda m: m.VolumetricAveragePooling(
        2, 2, 2, 2, 2, 2, 1, 1, 0), _x(2, 2, 5, 6, 5)),
    "volumetric_avg_exclude_ceil": (lambda m: m.VolumetricAveragePooling(
        2, 3, 3, 2, 2, 2, 0, 1, 1, False).ceil(), _x(1, 2, 5, 6, 7)),
    # convolutions
    "conv_grouped": (lambda m: m.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1,
                                                    2), _x(2, 4, 7, 6)),
    "conv_dilated": (lambda m: m.SpatialConvolution(
        3, 5, 3, 3, 1, 1, 2, 2, dilation_w=2, dilation_h=2), _x(2, 3, 9, 9)),
    "conv_same_s2": (lambda m: m.SpatialConvolution(3, 4, 3, 3, 2, 2, -1, -1),
                     _x(2, 3, 8, 7)),
    "conv_same_s2_k4": (lambda m: m.SpatialConvolution(
        3, 4, 4, 4, 2, 2, -1, 0), _x(2, 3, 9, 8)),
    "conv_same_dilated": (lambda m: m.SpatialConvolution(
        3, 4, 3, 3, 1, 1, -1, -1, dilation_w=2, dilation_h=3),
        _x(2, 3, 7, 8)),
    "conv_nhwc_grouped_same": (lambda m: m.SpatialConvolution(
        4, 4, 3, 3, 2, 2, -1, -1, 4, format="NHWC"), _x(2, 7, 8, 4)),
    "conv_no_bias_unbatched": (lambda m: m.SpatialConvolution(
        3, 4, 3, 2, 1, 2, 0, 1, with_bias=False), _x(3, 6, 7)),
    "conv_no_propagate_back": (lambda m: m.SpatialConvolution(
        3, 4, 3, 3, propagate_back=False), _x(2, 3, 6, 6)),
    "conv_share": (lambda m: m.SpatialShareConvolution(3, 4, 3, 3, 1, 1, 1,
                                                       1), _x(2, 3, 6, 6)),
    "conv_dilated_class": (lambda m: m.SpatialDilatedConvolution(
        3, 4, 3, 3, 2, 2, 2, 2, 2, 2), _x(2, 3, 11, 10)),
    "full_conv": (lambda m: m.SpatialFullConvolution(3, 4, 3, 3, 2, 2, 1, 1),
                  _x(2, 3, 5, 4)),
    "full_conv_adj": (lambda m: m.SpatialFullConvolution(
        3, 4, 4, 3, 2, 2, 1, 0, 1, 1), _x(2, 3, 5, 4)),
    "full_conv_adj_ge_stride": (lambda m: m.SpatialFullConvolution(
        2, 3, 3, 3, 1, 1, 1, 1, 2, 1), _x(2, 2, 4, 4)),
    "full_conv_grouped_no_bias": (lambda m: m.SpatialFullConvolution(
        4, 6, 3, 3, 2, 1, 0, 1, 0, 0, 2, True), _x(2, 4, 4, 5)),
    "full_conv_unbatched": (lambda m: m.SpatialFullConvolution(3, 2, 2, 2,
                                                               2, 2),
                            _x(3, 4, 4)),
    "separable": (lambda m: m.SpatialSeparableConvolution(3, 5, 2, 3, 3, 1,
                                                          1, 1, 1),
                  _x(2, 3, 7, 6)),
    "separable_same_s2": (lambda m: m.SpatialSeparableConvolution(
        3, 4, 1, 3, 3, 2, 2, -1, -1, False), _x(2, 3, 8, 7)),
    # normalisations
    "bn_nchw": (lambda m: m.SpatialBatchNormalization(3), _x(4, 3, 5, 5)),
    "bn_nchw_no_affine": (lambda m: m.SpatialBatchNormalization(
        3, 1e-3, 0.2, False), _x(4, 3, 5, 5)),
    "bn_1d": (lambda m: m.BatchNormalization(5), _x(6, 5)),
    "bn_volumetric": (lambda m: m.VolumetricBatchNormalization(3),
                      _x(2, 3, 3, 4, 4)),
    "layernorm": (lambda m: m.LayerNormalization(6), _x(3, 4, 6)),
    "lrn_cross_map": (lambda m: m.SpatialCrossMapLRN(5, 0.0001, 0.75),
                      _x(2, 7, 4, 4) * 10),
    "lrn_cross_map_even": (lambda m: m.SpatialCrossMapLRN(4, 0.5, 0.6, 2.0),
                           _x(2, 6, 3, 3)),
    "lrn_within_channel": (lambda m: m.SpatialWithinChannelLRN(3, 0.3, 0.6),
                           _x(2, 3, 5, 6)),
    "normalize_l2": (lambda m: m.Normalize(), _x(3, 5)),
    "normalize_l1": (lambda m: m.Normalize(1.0), _x(3, 5)),
    "normalize_l3": (lambda m: m.Normalize(3.0), _x(3, 5)),
    "normalize_inf": (lambda m: m.Normalize(float("inf")), _x(3, 5)),
    "normalize_scale": (lambda m: m.NormalizeScale(2.0, 1e-10, 2.0,
                                                   (1, 3, 1, 1)),
                        _x(2, 3, 4, 4)),
    "subtractive": (lambda m: m.SpatialSubtractiveNormalization(3),
                    _x(2, 3, 10, 11)),
    "subtractive_kernel": (lambda m: m.SpatialSubtractiveNormalization(
        2, np.array([1.0, 2.0, 1.0], np.float32)), _x(2, 2, 6, 7)),
    "divisive": (lambda m: m.SpatialDivisiveNormalization(2),
                 _x(2, 2, 10, 9) + 1.0),
    "contrastive": (lambda m: m.SpatialContrastiveNormalization(
        2, np.ones((5, 5), np.float32)), _x(2, 2, 8, 8)),
    "masking": (lambda m: m.Masking(0.0),
                _x(2, 4, 3) * np.array([1, 0, 1, 0], np.float32)[None, :,
                                                                  None]),
}
STATE = {"bn_nchw": _bn_state(3), "bn_nchw_no_affine": _bn_state(3),
         "bn_1d": _bn_state(5), "bn_volumetric": _bn_state(3)}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name, training):
    make, x = CASES[name]
    check_pair(make(jnn), make(nn), x, training, state=STATE.get(name))


# -- the pitfalls, each against a naive torch call ---------------------------

def _pool(m, x):
    return m.call({}, torch.from_numpy(x))


@pytest.mark.parametrize("cls", ["SpatialMaxPooling", "SpatialAveragePooling"])
def test_ceil_pool_kernel_smaller_than_stride_keeps_jax_last_window(cls):
    """2x2/3 in ceil mode: over 9 JAX makes 4 windows, the last starting
    at 9, wholly in the ceil padding (JAX drops such a window only when
    pad > 0): -inf for the max, 0 for the average. torch's ceil_mode drops
    it at pad 0 too and makes 3."""
    for size in (7, 8, 9):
        x = _x(1, 2, size, size)
        got = _pool(getattr(nn, cls)(2, 2, 3, 3).ceil(), x)
        want = getattr(jnn, cls)(2, 2, 3, 3).ceil().apply(
            {}, {}, jnp.asarray(x))[0]
        close(got, want)
    assert got.shape[-1] == 4
    pool = F.max_pool2d if cls == "SpatialMaxPooling" else F.avg_pool2d
    assert pool(torch.from_numpy(x), 2, 3, ceil_mode=True).shape[-1] == 3


def test_ceil_avg_pool_divides_by_the_full_window_like_jax():
    """Inception v2's auxiliary head: 5x5/3 in ceil mode over 7x7 pads one
    column and row; JAX divides the last windows by 25, torch's ceil mode
    by the 10 or 4 elements inside."""
    x = _x(2, 4, 7, 7)
    m = nn.SpatialAveragePooling(5, 5, 3, 3).ceil()
    got = _pool(m, x)
    want = jnn.SpatialAveragePooling(5, 5, 3, 3).ceil().apply(
        {}, {}, jnp.asarray(x))[0]
    close(got, want)
    naive = F.avg_pool2d(torch.from_numpy(x), 5, 3, ceil_mode=True)
    assert naive.shape == got.shape
    assert not torch.allclose(naive[..., -1, -1], got[..., -1, -1])


def test_same_padding_at_stride_2_puts_the_extra_row_after():
    """SAME, 3x3 at stride 2 over 8: total padding 1, split (0, 1), the
    larger half after the input; a symmetric pad of 1 (F.conv2d's
    padding=1) gives as many windows, every one shifted, and F.conv2d's
    padding='same' refuses the stride."""
    x = _x(2, 3, 8, 8)
    jm = jnn.SpatialConvolution(3, 4, 3, 3, 2, 2, -1, -1)
    tm = nn.SpatialConvolution(3, 4, 3, 3, 2, 2, -1, -1)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v))
                        for k, v in jp.items()})
    got = tm.call(tm.params, torch.from_numpy(x))
    close(got, jm.apply(jp, {}, jnp.asarray(x))[0])
    naive = F.conv2d(torch.from_numpy(x), tm.weight, tm.bias, 2, 1)
    assert naive.shape == got.shape and not torch.allclose(naive, got,
                                                           atol=1e-3)
    with pytest.raises(RuntimeError):
        F.conv2d(torch.from_numpy(x), tm.weight, tm.bias, 2, "same")


@pytest.mark.parametrize("grad_mode,want", [
    ("exact", [[1.0, 0.0], [0.0, 0.0]]),         # the first maximum
    # the max-tree's levels, each tie split in half: max(max(max(a, b),
    # c), d) passes d 1/2, c 1/4, a and b 1/8 each
    ("fast", [[0.125, 0.125], [0.25, 0.5]]),
])
def test_max_pool_tie_gradients_follow_jax(grad_mode, want):
    x = np.zeros((1, 1, 2, 2), np.float32)
    t = torch.from_numpy(x).requires_grad_()
    nn.SpatialMaxPooling(2, 2, grad_mode=grad_mode).call({}, t).sum() \
        .backward()
    jg = jax.grad(lambda v: jnn.SpatialMaxPooling(2, 2, grad_mode=grad_mode)
                  .apply({}, {}, v)[0].sum())(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(jg)[0, 0], want)
    torch.testing.assert_close(t.grad[0, 0], torch.tensor(want))


def test_conv_init_weight_and_bias_and_batchnorm_init():
    w = _x(4, 3, 3, 3)
    b = _x(4, seed=1)
    c = nn.SpatialConvolution(3, 4, 3, 3, init_weight=w.reshape(-1),
                              init_bias=b)
    torch.testing.assert_close(c.weight.detach(), torch.from_numpy(w))
    torch.testing.assert_close(c.bias.detach(), torch.from_numpy(b))
    c.reset(torch.Generator().manual_seed(1))       # the values stay given
    torch.testing.assert_close(c.weight.detach(), torch.from_numpy(w))
    bn = nn.SpatialBatchNormalization(3, init_weight=np.zeros(3),
                                      init_bias=np.ones(3))
    assert float(bn.weight.abs().sum()) == 0 and float(bn.bias.sum()) == 3


@pytest.mark.parametrize("name,make", [
    ("zeros", lambda i: i.Zeros()), ("ones", lambda i: i.Ones()),
    ("const", lambda i: i.ConstInit(0.7)),
    ("const_method", lambda i: i.ConstInitMethod(-2.0)),
    ("bilinear", lambda i: i.BilinearFiller()),
])
def test_deterministic_initialisers_equal_jax(name, make):
    shape = (3, 2, 4, 5)
    want = np.asarray(make(jinit)(jax.random.PRNGKey(0), shape))
    got = make(tinit)(shape)
    torch.testing.assert_close(got, torch.from_numpy(want))


@pytest.mark.parametrize("make,mean,std", [
    (lambda i: i.RandomNormal(0.5, 2.0), 0.5, 2.0),
    (lambda i: i.RandomUniform(-1.0, 3.0), 1.0, 4 / 12 ** 0.5),
    (lambda i: i.Xavier(), 0.0, (6 / (200 * 9 + 100 * 9)) ** 0.5 / 3 ** 0.5),
    (lambda i: i.MsraFiller(False), 0.0, (2 / (200 * 9)) ** 0.5),
], ids=["normal", "uniform", "xavier", "msra"])
def test_random_initialisers_draw_jax_distributions(make, mean, std):
    shape = (100, 200, 3, 3)
    j = np.asarray(make(jinit)(jax.random.PRNGKey(0), shape))
    t = make(tinit)(shape, generator=torch.Generator().manual_seed(0))
    for a in (j, t.numpy()):
        assert abs(a.mean() - mean) < 0.02 * max(std, 1)
        assert abs(a.std() - std) < 0.02 * std
