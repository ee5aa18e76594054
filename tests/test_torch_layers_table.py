"""The port's table layers, containers and shape layers against the JAX
package (``nn/table_ops.py``, ``nn/containers.py``, ``nn/shape_ops.py``).

Inputs are numpy arrays or lists of them (a ``Table`` on each side,
1-based); JAX's parameters are redrawn from a numpy seed and carried into
the port with ``convert`` (strictly: the trees must have JAX's names).
Output, parameter gradients and float-input gradients of sum(sin(out / 2))
are held at 1e-5 in training and evaluation mode. ``Max`` / ``Min`` /
``CMaxTable`` / ``CMinTable`` are also run on tied inputs, where JAX
splits the gradient; ``ResizeBilinear`` shrinking (JAX's antialiased
resize) and growing, with and without ``align_corners``.
"""
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.table import Table
from torch_parity_helpers import check_pair

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tied(*shape):
    """Values on a coarse grid, so most reductions meet ties."""
    return np.round(_x(*shape) * 1.5).astype(np.float32)


def _pair(*shape):
    return [_x(*shape), _x(*shape, seed=1)]


CASES = {
    # table ops
    "CAddTable": (lambda m: m.CAddTable(), [_x(3, 4), _x(3, 4, seed=1),
                                            _x(3, 4, seed=2)]),
    "CSubTable": (lambda m: m.CSubTable(), _pair(3, 4)),
    "CMulTable": (lambda m: m.CMulTable(), _pair(3, 4)),
    "CDivTable": (lambda m: m.CDivTable(), [_x(3, 4), np.abs(
        _x(3, 4, seed=1)) + 0.5]),
    "CMaxTable_ties": (lambda m: m.CMaxTable(), [_tied(3, 4), _tied(3, 4)
                                                 * 0 + _tied(4, 3).T]),
    "CMinTable_ties": (lambda m: m.CMinTable(), [_tied(3, 4), _tied(3, 4)
                                                 * 0 + _tied(4, 3).T]),
    "CAveTable": (lambda m: m.CAveTable(), _pair(3, 4)),
    "JoinTable": (lambda m: m.JoinTable(2), _pair(3, 4)),
    "JoinTable_batch_dims": (lambda m: m.JoinTable(1, 2),
                             [_x(2, 3, 4), _x(2, 5, 4)]),
    "SplitTable": (lambda m: m.SplitTable(2), _x(3, 4, 2)),
    "SplitTable_negative": (lambda m: m.SplitTable(-1), _x(3, 4, 2)),
    "BifurcateSplitTable": (lambda m: m.BifurcateSplitTable(2), _x(3, 5)),
    "SelectTable": (lambda m: m.SelectTable(2), [_x(2), _x(3), _x(4)]),
    "SelectTable_last": (lambda m: m.SelectTable(-1), [_x(2), _x(3)]),
    "NarrowTable": (lambda m: m.NarrowTable(2, 2), [_x(2), _x(3), _x(4)]),
    "NarrowTable_to_end": (lambda m: m.NarrowTable(2, -1),
                           [_x(2), _x(3), _x(4)]),
    "FlattenTable": (lambda m: m.FlattenTable(),
                     [_x(2), [_x(3), [_x(4), _x(1)]]]),
    "MixtureTable_table": (lambda m: m.MixtureTable(),
                           [_x(3, 2), [_x(3, 4), _x(3, 4, seed=5)]]),
    "MixtureTable_tensor": (lambda m: m.MixtureTable(),
                            [_x(3, 2), _x(3, 2, 4)]),
    "DotProduct": (lambda m: m.DotProduct(), _pair(3, 4)),
    "DotProduct_vector": (lambda m: m.DotProduct(), _pair(4)),
    "CrossProduct": (lambda m: m.CrossProduct(), [_x(3, 4), _x(3, 4, seed=1),
                                                  _x(3, 4, seed=2)]),
    "MM": (lambda m: m.MM(), [_x(2, 3, 4), _x(2, 4, 5)]),
    "MM_transposed": (lambda m: m.MM(True, True),
                      [_x(2, 4, 3), _x(2, 5, 4)]),
    "MV": (lambda m: m.MV(), [_x(2, 3, 4), _x(2, 4)]),
    "MV_transposed": (lambda m: m.MV(True), [_x(2, 4, 3), _x(2, 4)]),
    "PairwiseDistance": (lambda m: m.PairwiseDistance(), _pair(3, 4)),
    "PairwiseDistance_L1": (lambda m: m.PairwiseDistance(1), _pair(3, 4)),
    "CosineDistance": (lambda m: m.CosineDistance(), _pair(3, 4)),
    "TableOperation": (lambda m: m.TableOperation(lambda a, b: a * b + a),
                       [_x(3, 4), _x(1, 4)]),
    # containers
    "Concat_channels": (lambda m: m.Concat(
        2, m.SpatialConvolution(2, 3, 1, 1), m.Tanh(),
        m.SpatialConvolution(2, 1, 3, 3, 1, 1, 1, 1)), _x(2, 2, 5, 5)),
    "ConcatTable": (lambda m: m.ConcatTable(m.Linear(4, 3), m.Identity(),
                                            m.Tanh()), _x(2, 4)),
    "ParallelTable": (lambda m: m.ParallelTable(m.Linear(4, 3), m.Tanh()),
                      [_x(2, 4), _x(2, 5)]),
    "MapTable": (lambda m: m.MapTable(m.Linear(4, 3)),
                 [_x(2, 4), _x(5, 4), _x(1, 4)]),
    "Bottle": (lambda m: m.Bottle(m.Linear(4, 3)), _x(2, 5, 4)),
    "Bottle_3d": (lambda m: m.Bottle(m.Linear(4, 3), 3, 3), _x(2, 3, 5, 4)),
    "residual_block": (lambda m: m.Sequential(
        m.ConcatTable(m.Sequential(m.Linear(4, 4), m.ReLU()), m.Identity()),
        m.CAddTable(), m.Tanh()), _x(3, 4)),
    # shape ops
    "Reshape": (lambda m: m.Reshape([4, 3]), _x(2, 12)),
    "Reshape_no_batch": (lambda m: m.Reshape([3, 4]), _x(12)),
    "Reshape_batch_mode": (lambda m: m.Reshape([2, 2], True), _x(3, 4)),
    "View": (lambda m: m.View(2, 6), _x(3, 12)),
    "View_infer": (lambda m: m.View(-1, 6), _x(3, 12)),
    "InferReshape": (lambda m: m.InferReshape([0, -1]), _x(3, 4, 2)),
    "InferReshape_batch": (lambda m: m.InferReshape([-1, 2], True),
                           _x(3, 4, 2)),
    "Squeeze": (lambda m: m.Squeeze(2), _x(3, 1, 4)),
    "Squeeze_all": (lambda m: m.Squeeze(), _x(3, 1, 4, 1)),
    "Squeeze_batch": (lambda m: m.Squeeze(1, 2), _x(3, 1, 4)),
    "Unsqueeze": (lambda m: m.Unsqueeze(2), _x(3, 4)),
    "Unsqueeze_batch": (lambda m: m.Unsqueeze(1, 1), _x(3, 4)),
    "Transpose": (lambda m: m.Transpose([(1, 3), (2, 3)]), _x(2, 3, 4)),
    "Replicate": (lambda m: m.Replicate(3, 2), _x(2, 4)),
    "Replicate_batch": (lambda m: m.Replicate(3, 1, 1), _x(2, 4)),
    "Padding_after": (lambda m: m.Padding(2, 3, 4, 0.5), _x(2, 3, 4, 4)),
    "Padding_before": (lambda m: m.Padding(1, -2, 1), _x(2, 3)),
    "SpatialZeroPadding": (lambda m: m.SpatialZeroPadding(1, 2, 0, 3),
                           _x(2, 3, 4, 5)),
    "SpatialZeroPadding_crop": (lambda m: m.SpatialZeroPadding(-1, 2, 1, -2),
                                _x(2, 3, 5, 5)),
    "Narrow": (lambda m: m.Narrow(2, 2, 3), _x(3, 6)),
    "Narrow_negative": (lambda m: m.Narrow(2, -4, -2), _x(3, 6)),
    "Select": (lambda m: m.Select(2, 3), _x(3, 6)),
    "Select_last": (lambda m: m.Select(-1, -1), _x(3, 6)),
    "Index": (lambda m: m.Index(2), [_x(3, 6), np.array([2, 6, 2, 1])]),
    "MaskedSelect": (lambda m: m.MaskedSelect(),
                     [_x(3, 4), (_x(3, 4, seed=1) > 0).astype(np.float32)]),
    "Max_ties": (lambda m: m.Max(2), _tied(3, 6)),
    "Max_batch": (lambda m: m.Max(1, 1), _tied(3, 6)),
    "Min_ties": (lambda m: m.Min(1), _tied(5, 2)),
    "Mean": (lambda m: m.Mean(2), _x(3, 6)),
    "Mean_keep": (lambda m: m.Mean(1, 1, False), _x(3, 6)),
    "Sum": (lambda m: m.Sum(2), _x(3, 6)),
    "Sum_average": (lambda m: m.Sum(1, -1, True, False), _x(3, 6)),
    "Tile": (lambda m: m.Tile(2, 3), _x(3, 2)),
    "ExpandSize": (lambda m: m.ExpandSize([3, -1, 4]), _x(1, 2, 1)),
    "Cropping2D": (lambda m: m.Cropping2D((1, 2), (0, 1)), _x(2, 3, 6, 5)),
    "Cropping2D_nhwc": (lambda m: m.Cropping2D((1, 0), (2, 1), "NHWC"),
                        _x(2, 6, 5, 3)),
    "Cropping3D": (lambda m: m.Cropping3D((1, 0), (0, 1), (1, 1)),
                   _x(2, 3, 4, 4, 4)),
    "Reverse": (lambda m: m.Reverse(2), _x(3, 4)),
    "Pack": (lambda m: m.Pack(2), [_x(3, 4), _x(3, 4, seed=1)]),
    "UpSampling1D": (lambda m: m.UpSampling1D(3), _x(2, 3, 4)),
    "UpSampling2D": (lambda m: m.UpSampling2D((2, 3)), _x(2, 3, 3, 2)),
    "UpSampling3D": (lambda m: m.UpSampling3D((2, 1, 2)), _x(1, 2, 2, 3, 2)),
    "ResizeBilinear_grow": (lambda m: m.ResizeBilinear(7, 9), _x(2, 3, 4, 5)),
    "ResizeBilinear_shrink": (lambda m: m.ResizeBilinear(3, 4),
                              _x(2, 3, 9, 11)),
    "ResizeBilinear_mixed": (lambda m: m.ResizeBilinear(5, 5),
                             _x(1, 2, 9, 3)),
    "ResizeBilinear_align": (lambda m: m.ResizeBilinear(7, 3, True),
                             _x(2, 3, 4, 5)),
}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name, training):
    make, x = CASES[name]
    check_pair(make(jnn), make(nn), x, training)


def test_containers_keep_jax_trees_and_one_based_dims():
    m = nn.Concat(2, nn.Linear(3, 2), nn.ParallelTable(nn.Linear(3, 4)))
    assert sorted(m.params) == ["0", "1"]
    assert sorted(m.params["1"]["0"]) == ["bias", "weight"]
    x = torch.ones(2, 3)
    y = nn.Concat(2, nn.Identity(), nn.Identity()).forward(x)
    assert y.shape == (2, 6)
    t = nn.ConcatTable(nn.Identity(), nn.Identity()).forward(x)
    assert isinstance(t, Table) and len(t) == 2 and t[1] is x
    assert list(m.modules_iter())[1] is m[0]


def test_resize_bilinear_shrink_is_antialiased_unlike_interpolate():
    """Shrinking 8 -> 2 filters with a triangle 4 pixels wide
    (``jax.image.resize``); bilinear sampling without the filter
    (``F.interpolate``) reads two pixels of each output and misses the
    checkerboard's other phase."""
    import jax
    import jax.numpy as jnp
    x = np.zeros((1, 1, 8, 8), np.float32)
    x[..., ::2, ::2] = 1.0
    y = nn.ResizeBilinear(2, 2).call({}, torch.from_numpy(x))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 1, 2, 2),
                                       "bilinear"))
    torch.testing.assert_close(y, torch.from_numpy(want))
    naive = torch.nn.functional.interpolate(torch.from_numpy(x), (2, 2),
                                            mode="bilinear")
    assert not torch.allclose(naive, y, atol=1e-3)
