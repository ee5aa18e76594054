"""The port's dense layers and the sequence zoo's convolutions against the
JAX package (``nn/linear.py``; ``nn/conv.py``'s ``TemporalConvolution``,
``SpatialConvolutionMap``, ``VolumetricConvolution``,
``VolumetricFullConvolution``, ``LocallyConnected1D`` / ``2D``).

Output and the parameter and input gradients of sum(sin(out / 2)) at
1e-5 (float32; ``torch_parity_helpers.TOL``), on JAX's parameters
redrawn from a numpy seed. The cases cover ``LookupTable``'s clamped
out-of-range ids (their gradient lands on the first and last rows),
``max_norm`` under both norms and ``mask_zero``; Cosine at a zero input
row (JAX's NaN gradient, followed on purpose); the transposed 3-D
convolution with ``adj`` at and past the stride (which
``F.conv_transpose3d``'s ``output_padding`` refuses) and negative crops;
the three connection tables and the mask's hold on the gradient; SAME
padding; ``F.unfold``'s (C, kh, kw) patch order against JAX's
``conv_general_dilated_patches``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax import lax

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import convert, nn
from torch_parity_helpers import check_pair, jax_params, load

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ids(*shape, low, high, seed=0):
    return np.random.RandomState(seed).randint(low, high, size=shape) \
        .astype(np.int32)


CASES = {
    # nn/linear.py
    "linear": (lambda m: m.Linear(5, 4), _x(3, 5)),
    "bilinear": (lambda m: m.Bilinear(3, 4, 5), [_x(2, 3), _x(2, 4, seed=1)]),
    "bilinear_no_bias": (lambda m: m.Bilinear(3, 4, 2, False),
                         [_x(2, 3), _x(2, 4, seed=1)]),
    "cosine": (lambda m: m.Cosine(5, 3), _x(4, 5)),
    "euclidean": (lambda m: m.Euclidean(5, 3), _x(4, 5)),
    "add": (lambda m: m.Add(5), _x(3, 5)),
    "mul": (lambda m: m.Mul(), _x(3, 5)),
    "cmul_broadcast": (lambda m: m.CMul((4, 1)), _x(2, 3, 4, 5)),
    "cadd_broadcast": (lambda m: m.CAdd((1, 5)), _x(2, 3, 5)),
    "scale_broadcast": (lambda m: m.Scale((3, 1, 1)), _x(2, 3, 4, 4)),
    "highway_tanh": (lambda m: m.Highway(6), _x(3, 6)),
    "highway_relu_no_bias": (lambda m: m.Highway(6, False, "relu"), _x(3, 6)),
    "highway_identity": (lambda m: m.Highway(6, True, None), _x(3, 6)),
    # out-of-range ids (0, -2, 9, 12 over 8 rows) clamp to rows 1 and 8
    "lookup_clamped": (lambda m: m.LookupTable(8, 4),
                       np.array([[1, 0, 9, 3], [12, -2, 8, 5]], np.int32)),
    "lookup_max_norm_l2": (lambda m: m.LookupTable(8, 4, max_norm=1.0),
                           _ids(3, 5, low=1, high=9)),
    "lookup_max_norm_l1": (lambda m: m.LookupTable(
        8, 4, max_norm=1.5, norm_type=1.0), _ids(3, 5, low=1, high=9)),
    "lookup_mask_zero": (lambda m: m.LookupTable(8, 4, mask_zero=True),
                         np.array([[0, 2, 0, 7], [3, 0, 1, 8]], np.int32)),
    "lookup_mask_padding_value": (lambda m: m.LookupTable(
        8, 4, padding_value=3, mask_zero=True),
        np.array([[3, 2, 3, 7]], np.int32)),
    # nn/conv.py
    "temporal": (lambda m: m.TemporalConvolution(4, 5, 3), _x(2, 7, 4)),
    "temporal_stride_unbatched": (lambda m: m.TemporalConvolution(
        4, 5, 3, 2), _x(9, 4)),
    "conv_map_full": (lambda m: m.SpatialConvolutionMap(
        m.SpatialConvolutionMap.full(3, 4), 3, 3), _x(2, 3, 6, 6)),
    "conv_map_one_to_one_same": (lambda m: m.SpatialConvolutionMap(
        m.SpatialConvolutionMap.one_to_one(3), 3, 3, 2, 2, -1, -1),
        _x(2, 3, 7, 6)),
    "conv_map_random_pad": (lambda m: m.SpatialConvolutionMap(
        m.SpatialConvolutionMap.random(4, 3, 2), 3, 2, 1, 2, 1, 1),
        _x(2, 4, 6, 7)),
    "conv_map_unbatched": (lambda m: m.SpatialConvolutionMap(
        m.SpatialConvolutionMap.random(3, 2, 2), 2, 2), _x(3, 5, 5)),
    "volumetric": (lambda m: m.VolumetricConvolution(2, 3, 2, 3, 2),
                   _x(2, 2, 4, 5, 6)),
    "volumetric_stride_pad": (lambda m: m.VolumetricConvolution(
        2, 3, 3, 3, 3, 2, 1, 2, 1, 0, 1), _x(1, 2, 6, 5, 7)),
    "volumetric_same_s2": (lambda m: m.VolumetricConvolution(
        2, 3, 3, 2, 3, 2, 2, 2, -1, 0, 0, False), _x(2, 2, 5, 6, 7)),
    "volumetric_unbatched": (lambda m: m.VolumetricConvolution(
        2, 2, 2, 2, 2), _x(2, 3, 3, 3)),
    "vol_full": (lambda m: m.VolumetricFullConvolution(2, 3, 3, 3, 3),
                 _x(2, 2, 3, 4, 3)),
    "vol_full_stride_pad": (lambda m: m.VolumetricFullConvolution(
        2, 3, 3, 2, 3, 2, 2, 1, 1, 0, 1), _x(1, 2, 3, 3, 4)),
    # adj at and past the stride, and pads past the kernel (crops)
    "vol_full_adj_ge_stride": (lambda m: m.VolumetricFullConvolution(
        2, 3, 2, 3, 2, 2, 1, 2, 0, 1, 0, 2, 1, 3), _x(1, 2, 3, 3, 3)),
    "vol_full_big_pad_no_bias": (lambda m: m.VolumetricFullConvolution(
        2, 2, 2, 2, 2, 1, 1, 1, 2, 0, 1, no_bias=True), _x(1, 2, 4, 4, 5)),
    "vol_full_n_group_ignored": (lambda m: m.VolumetricFullConvolution(
        2, 4, 2, 2, 2, n_group=2), _x(1, 2, 3, 3, 3)),
    "vol_full_unbatched": (lambda m: m.VolumetricFullConvolution(
        2, 2, 2, 2, 2, 2, 2, 2), _x(2, 2, 3, 2)),
    "local2d": (lambda m: m.LocallyConnected2D(2, 6, 5, 3, 3, 2),
                _x(2, 2, 5, 6)),
    "local2d_stride_pad": (lambda m: m.LocallyConnected2D(
        3, 7, 6, 2, 3, 2, 2, 1, 1, 1), _x(2, 3, 6, 7)),
    "local2d_no_bias_unbatched": (lambda m: m.LocallyConnected2D(
        2, 5, 5, 3, 2, 2, with_bias=False), _x(2, 5, 5)),
    "local1d": (lambda m: m.LocallyConnected1D(7, 4, 5, 3), _x(2, 7, 4)),
    "local1d_stride_unbatched": (lambda m: m.LocallyConnected1D(
        9, 3, 2, 3, 2), _x(9, 3)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name):
    make, x = CASES[name]
    check_pair(make(jnn), make(nn), x, training=True, jit=True)


def test_lookup_table_clamps_out_of_range_ids_onto_the_end_rows():
    """JAX clips, never refuses: id 0 and -2 read row 1, ids past n_index
    row n_index, and their gradient lands there."""
    jm, tm = jnn.LookupTable(5, 2), nn.LookupTable(5, 2)
    jp, js = jax_params(jm)
    load(tm, jp, js)
    ids = torch.tensor([[0, -2, 7, 5]], dtype=torch.int32)
    out = tm.call(tm.params, ids)
    w = tm.weight.detach()
    torch.testing.assert_close(out[0], w[[0, 0, 4, 4]])
    g, = torch.autograd.grad(out.sum(), tm.weight)
    assert g[0].tolist() == [2.0, 2.0] and g[4].tolist() == [2.0, 2.0]
    assert not g[1:4].any()


def test_lookup_table_max_norm_leaves_the_weight_as_it_is():
    """The rescaling is part of the forward (and its gradient), not an
    in-place renormalisation of the stored weight as in
    ``F.embedding(max_norm=)``."""
    tm = nn.LookupTable(6, 3, max_norm=0.5)
    before = tm.weight.detach().clone()
    out = tm.call(tm.params, torch.tensor([[1, 2, 6]]))
    assert torch.equal(tm.weight.detach(), before)
    norms = torch.linalg.vector_norm(out, dim=-1)
    assert bool((norms <= 0.5 + 1e-6).all())


def test_cosine_zero_row_gradient_is_jax_s_nan():
    """JAX's |x| (``jnp.linalg.norm``) passes NaN back at a zero row; the
    port writes ``sqrt(sum(x * x))`` out and follows it (a
    ``vector_norm`` would give 0). The output, the other row's gradient
    and the weight's gradient agree."""
    jm, tm = jnn.Cosine(3, 2), nn.Cosine(3, 2)
    jp, js = jax_params(jm)
    load(tm, jp, js)
    x = np.array([[0, 0, 0], [1, 2, 3]], np.float32)
    f = lambda p, v: jnp.sum(jnp.sin(jm.apply(p, js, v)[0]))
    jgp, jgx = jax.grad(f, argnums=(0, 1))(jax.tree_util.tree_map(
        jnp.asarray, jp), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    gx, gw = torch.autograd.grad(torch.sin(tm.call(tm.params, xt)).sum(),
                                 [xt, tm.weight])
    jgx = np.asarray(jgx)
    assert np.isnan(jgx[0]).all() and torch.isnan(gx[0]).all()
    torch.testing.assert_close(gx[1], torch.from_numpy(jgx[1]), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(gw, torch.from_numpy(
        np.asarray(jgp["weight"])), atol=1e-5, rtol=1e-5)


def test_conv_map_mask_holds_the_gradient():
    """The unconnected taps take no gradient and stay zero after a step:
    the mask is applied at every call, not only at initialisation."""
    table = nn.SpatialConvolutionMap.random(4, 3, 2)
    tm = nn.SpatialConvolutionMap(table, 3, 3)
    with torch.no_grad():
        tm.weight.copy_(torch.randn(tm.weight.shape))   # every tap nonzero
    g, = torch.autograd.grad(tm.call(tm.params, torch.randn(2, 4, 6, 6))
                             .sum(), tm.weight)
    off = tm.mask[:, :, 0, 0] == 0
    assert int(off.sum()) == 3 * 4 - len(table)
    assert not g[off].any() and g[~off].abs().sum() > 0
    np.testing.assert_array_equal(table, jnn.SpatialConvolutionMap.random(
        4, 3, 2))


def test_unfold_patch_order_is_jax_s():
    """``F.unfold`` flattens a patch (C, kh, kw), as JAX's
    ``conv_general_dilated_patches`` does: the premise of
    LocallyConnected2D's einsum."""
    x = _x(2, 3, 5, 6)
    want = lax.conv_general_dilated_patches(
        jnp.asarray(x), (2, 3), (1, 2), [(1, 1), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    got = F.unfold(torch.from_numpy(x), (2, 3), padding=(1, 0),
                   stride=(1, 2)).reshape(want.shape)
    torch.testing.assert_close(got, torch.from_numpy(np.asarray(want)))


def test_vol_full_adj_past_the_stride_is_refused_by_torch():
    """Why the transposed 3-D convolution crops and pads its full output:
    torch refuses ``output_padding`` at or past the stride, which JAX's
    input-dilated convolution takes."""
    with pytest.raises(RuntimeError):
        F.conv_transpose3d(torch.zeros(1, 2, 3, 3, 3),
                           torch.zeros(2, 3, 2, 2, 2), stride=2,
                           output_padding=2)
    tm = nn.VolumetricFullConvolution(2, 3, 2, 2, 2, 2, 2, 2, adj_t=2)
    assert tm.call(tm.params, torch.zeros(1, 2, 3, 3, 3)).shape \
        == (1, 3, 8, 6, 6)


def test_params_carry_jax_names():
    for make, x in CASES.values():
        jm, tm = make(jnn), make(nn)
        jp = jax.eval_shape(jm._init_params, jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in convert.flatten(jp).items()} \
            == {k: tuple(v.shape) for k, v in convert.flatten(
                tm.params).items()}
