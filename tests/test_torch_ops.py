"""The port's TF-style ops (``bigdl_tpu_torch.ops``) against the JAX
package's (``bigdl_tpu.ops``): every name of ``ops.__all__`` on the same
numpy inputs through both packages' ``forward``. Float32 results agree to
1e-5; integer, boolean and string results are equal, with the same dtype.
The semantics where a plain torch call would differ from JAX (``jnp.take``
out of range, antialiased downsampling, ties in top-k, floor division and
modulo of negatives, half-way rounding, SAME dilation padding) have cases
of their own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import ops as jops
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import ops as pops
from bigdl_tpu_torch.utils.table import Table as PTable

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _r(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _jax_in(a):
    return a if isinstance(a, np.ndarray) and a.dtype == object \
        else jnp.asarray(a)


def _port_in(a):
    if isinstance(a, np.ndarray) and a.dtype == object:
        return a
    return torch.from_numpy(np.array(a, copy=True))


def _np(out):
    if isinstance(out, (JTable, PTable)):
        return [_np(o) for o in out.to_list()]
    if torch.is_tensor(out):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def run_both(name, args, inputs, kwargs=None):
    kwargs = kwargs or {}
    jop = getattr(jops, name)(*args, **kwargs)
    pop = getattr(pops, name)(*args, **kwargs)
    if len(inputs) == 1:
        jx, px = _jax_in(inputs[0]), _port_in(inputs[0])
    else:
        jx = JTable(*[_jax_in(a) for a in inputs])
        px = PTable(*[_port_in(a) for a in inputs])
    jop.evaluate()
    pop.evaluate()
    want, got = _np(jop.forward(jx)), _np(pop.forward(px))
    _same(got, want)
    return got


A = _r(0, 3, 4)
B = _r(1, 3, 4)
POS = np.abs(_r(2, 3, 4)) + 0.1
I1 = np.array([-7, -4, -1, 0, 3, 7, 9], np.int32)
I2 = np.array([2, 3, -2, 5, -3, 2, 4], np.int32)
F1 = np.array([-7.5, -4.0, -1.5, 0.5, 3.0, 7.25, 9.0], np.float32)
F2 = np.array([2.0, 3.0, -2.0, 5.0, -3.0, 2.0, 4.0], np.float32)
HALF = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, -3.5], np.float32)
BOOLS = np.array([[True, False, True], [True, True, True]])

CASES = [
    ("Equal", (), [A, np.where(np.arange(12).reshape(3, 4) % 2, A, B)]),
    ("NotEqual", (), [A, np.where(np.arange(12).reshape(3, 4) % 2, A, B)]),
    ("Greater", (), [A, B]), ("GreaterEqual", (), [A, A * (A > 0)]),
    ("Less", (), [A, B]), ("LessEqual", (), [A, A * (A > 0)]),
    ("ApproximateEqual", (0.5,), [A, A + 0.3 * B]),
    ("LogicalAnd", (), [BOOLS, BOOLS[::-1].copy()]),
    ("LogicalOr", (), [BOOLS, BOOLS[::-1].copy()]),
    ("LogicalNot", (), [BOOLS]),
    ("All", (1,), [BOOLS]), ("Any", (0,), [BOOLS]),
    ("Sum", (0,), [A]), ("Sum", ((0, 1), True), [A]),
    ("Sum", (1,), [I1.reshape(1, 7)]), ("Sum", (0,), [BOOLS]),
    ("Prod", (1,), [A]), ("Prod", (1,), [I2.reshape(1, 7)]),
    ("Max", (1,), [A]), ("Min", (None, True), [A]),
    ("Mean", (), [A]), ("Mean", (0,), [I1.reshape(7, 1)]),
    ("Exp", (), [A]), ("Expm1", (), [A]), ("Log1p", (), [POS]),
    ("Floor", (), [F1]), ("Ceil", (), [F1]), ("Round", (), [HALF]),
    ("Rint", (), [HALF]), ("Sign", (), [np.array([-2., 0., 3.], np.float32)]),
    ("Inv", (), [POS]), ("Erf", (), [A]), ("Erfc", (), [A]),
    ("Lgamma", (), [POS * 3]), ("Digamma", (), [POS * 3]),
    ("IsFinite", (), [np.array([1., np.inf, np.nan], np.float32)]),
    ("IsInf", (), [np.array([1., -np.inf, np.nan], np.float32)]),
    ("IsNan", (), [np.array([1., np.inf, np.nan], np.float32)]),
    ("Pow", (), [POS, B]), ("Maximum", (), [A, B]), ("Minimum", (), [A, B]),
    ("FloorDiv", (), [I1, I2]), ("FloorDiv", (), [F1, F2]),
    ("FloorMod", (), [I1, I2]), ("FloorMod", (), [F1, F2]),
    ("Mod", (), [I1, I2]), ("Mod", (), [F1, F2]),
    ("TruncateDiv", (), [I1, I2]), ("TruncateDiv", (), [F1, F2]),
    ("SquaredDifference", (), [A, B]),
    ("Shape", (), [_r(3, 2, 3, 5)]), ("Rank", (), [_r(3, 2, 3, 5)]),
    ("Cast", (np.int32,), [F1]), ("Cast", (np.float32,), [I1]),
    ("Cast", ("bool",), [I1]),
    ("Gather", (0,), [_r(4, 5, 3), np.array([4, 0, 2, 2], np.int32)]),
    ("Gather", (1,), [_r(4, 5, 3), np.array([[2, 0], [1, 1]], np.int32)]),
    ("Select", (), [A > 0, A, B]),
    ("Slice", ([1, 0], [2, -1]), [A]),
    ("StridedSlice", ([0, 1], [3, 4], [2, 2]), [A]),
    ("StridedSlice", ([2, 3], [0, 0], [-1, -2], 0, 0, 2), [A]),
    ("StridedSlice", ([1, 0], [2, 4], [1, 1], 1), [A]),
    ("Tile", ([2, 1],), [A]),
    ("OneHot", (4, 2.0, -1.0), [np.array([0, 3, 1, -1, 5], np.int32)]),
    ("OneHot", (3, 1.0, 0.0, 0), [np.array([0, 2], np.int32)]),
    ("TopK", (2,), [A]),
    ("InTopK", (2,), [A, np.array([0, 1, 3], np.int32)]),
    ("ArgMax", (1,), [A]), ("ArgMax", (0,), [A]),
    ("BatchMatMul", (), [_r(5, 2, 3, 4), _r(6, 2, 4, 5)]),
    ("BatchMatMul", (True, True), [_r(5, 2, 4, 3), _r(6, 2, 5, 4)]),
    ("SegmentSum", (3,), [_r(7, 5, 2), np.array([0, 0, 2, 1, 2], np.int32)]),
    ("SegmentSum", (), [_r(7, 5, 2), np.array([1, 1, 0, 3, 3], np.int32)]),
    ("Pad", ([[1, 0], [0, 2]], 1.5), [A]),
    ("ExpandDims", (1,), [A]), ("ExpandDims", (-1,), [A]),
    ("SplitAndSelect", (1, 1, 2), [A]),
    ("InvertPermutation", (), [np.array([2, 0, 3, 1], np.int32)]),
    ("Pack", (1,), [A, B]), ("Split", (2, 1), [A]), ("Unpack", (3, 0), [A]),
    ("ResizeBilinear", (6, 10), [_r(8, 2, 3, 5, 2)]),
    ("ResizeBilinear", (7, 9, True), [_r(8, 2, 4, 5, 2)]),
    ("ResizeBilinear", (5, 4, False, "NCHW"), [_r(8, 1, 2, 3, 6)]),
    ("Dilation2D", ([1, 1, 1, 1], [1, 1, 1, 1]),
     [_r(9, 1, 5, 6, 2), _r(10, 3, 3, 2)]),
    ("Dilation2D", ([1, 2, 2, 1], [1, 2, 1, 1], "VALID"),
     [_r(9, 1, 7, 6, 2), _r(10, 2, 2, 2)]),
    ("L2Loss", (), [A]), ("CrossEntropy", (), [A, np.eye(4, dtype=np.float32)[:3]]),
    ("BucketizedCol", ([0.0, 10.0, 100.0],),
     [np.array([-5.0, 0.0, 5.0, 10.0, 50.0, 500.0], np.float32)]),
    ("CategoricalColHashBucket", (16,),
     [np.array(["a", "b", "a", "zz"], dtype=object)]),
    ("CategoricalColVocaList", (["cat", "dog"], -1, 2),
     [np.array(["dog", "bird", "cat", "fish"], dtype=object)]),
    ("CategoricalColVocaList", (["cat", "dog"],),
     [np.array(["dog", "bird"], dtype=object)]),
    ("CrossCol", (32,), [np.array(["a", "b"], dtype=object),
                         np.array(["x", "y"], dtype=object)]),
    ("IndicatorCol", (4,), [np.array([[0, 2], [3, 3]], np.int32)]),
    ("Kv2Tensor", (",", ":", 4),
     [np.array(["0:1.5,2:3.0", "1:2.0", ""], dtype=object)]),
    ("MkString", ("-",), [np.array([[1, 2], [3, 4]], dtype=object)]),
    ("Substr", (1, 2), [np.array(["hello", "world"], dtype=object)]),
    ("RangeOps", (), [np.int32(2), np.int32(14), np.int32(3)]),
    ("DepthwiseConv2D", (1, 1, 1, 1, "NCHW"),
     [_r(11, 2, 6, 7, 7), _r(12, 3, 3, 6, 2)]),
    ("DepthwiseConv2D", (2, 1, 0, 1, "NHWC"),
     [_r(11, 2, 7, 7, 6), _r(12, 3, 3, 6, 2)]),
    ("NoOp", (), [A]), ("ControlDependency", (), [A]),
    ("BiasAdd", (), [_r(13, 2, 3, 4), np.arange(4, dtype=np.float32)]),
]


@pytest.mark.parametrize("name,args,inputs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_matches_jax(name, args, inputs):
    run_both(name, args, inputs)


def test_every_op_has_a_case():
    covered = {c[0] for c in CASES} | {
        "Operation", "Compare", "Assert", "RandomUniform", "TruncatedNormal",
        "ModuleToOperation", "TensorModuleWrapper", "TensorOp"}
    assert set(pops.__all__) == covered
    assert set(pops.__all__) == set(jops.__all__)


# -- the traps: where a plain torch call reads differently ------------------

def test_gather_fills_out_of_range_and_wraps_negative():
    idx = np.array([7, -1, -6, 2], np.int32)      # 5 rows
    got = run_both("Gather", (0,), [_r(14, 5, 2), idx])
    assert np.isnan(got[0]).all() and np.isnan(got[2]).all()
    ints = run_both("Gather", (0,), [np.arange(5, dtype=np.int32), idx])
    assert ints.tolist() == [np.iinfo(np.int32).min, 4,
                             np.iinfo(np.int32).min, 2]


def test_resize_bilinear_antialiases_when_it_shrinks():
    x = _r(15, 2, 17, 23, 3)
    got = run_both("ResizeBilinear", (6, 8), [x])
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(6, 8),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - plain).max() > 1e-2     # not the plain interpolation
    run_both("ResizeBilinear", (9, 4), [x])      # one axis up, one down


def test_top_k_takes_the_lowest_index_among_ties():
    x = np.array([[1., 3., 3., 2., 3.], [0., 0., 0., 0., 0.]], np.float32)
    v, i = run_both("TopK", (3,), [x])
    assert i.tolist() == [[1, 2, 4], [0, 1, 2]] and i.dtype == np.int32
    assert run_both("ArgMax", (1,), [x]).tolist() == [1, 0]
    run_both("InTopK", (2,), [x, np.array([4, 2], np.int32)])


def test_floor_division_modulo_and_rounding_of_negatives_and_halves():
    assert run_both("FloorDiv", (), [I1, I2]).tolist() == \
        (I1 // I2).tolist()
    assert run_both("FloorMod", (), [F1, F2]).tolist() == \
        np.mod(F1, F2).tolist()
    assert run_both("TruncateDiv", (), [I1, I2]).tolist() == \
        np.trunc(I1 / I2).astype(np.int32).tolist()
    assert run_both("Round", (), [HALF]).tolist() == \
        [-2., -2., -0., 0., 2., 2., 4., -4.]


def test_dilation_same_pads_with_minus_infinity():
    x = -np.abs(_r(16, 1, 4, 4, 1)) - 5.0     # every value far below 0
    got = run_both("Dilation2D", ([1, 1, 1, 1], [1, 1, 1, 1]),
                   [x, np.zeros((3, 3, 1), np.float32)])
    assert got.max() < -5.0                     # no zero pad leaked in


def test_segment_sum_drops_out_of_range_ids():
    run_both("SegmentSum", (3,), [_r(17, 6, 4),
                                  np.array([0, 5, 2, -1, 2, 0], np.int32)])
    run_both("SegmentSum", (4,), [np.arange(6, dtype=np.int32),
                                  np.array([3, 3, 0, 1, 9, 0], np.int32)])


def test_reduction_axes_from_a_second_input():
    run_both("Sum", (), [A, np.array([0], np.int32)])
    run_both("Max", (None, True), [A, np.array([1, 0], np.int32)])
    run_both("ArgMax", (), [A, np.int32(1)])
    run_both("Tile", (), [A, np.array([1, 3], np.int32)])


def test_assert_checks_eagerly_and_passes_data_through():
    x = _r(18, 2, 3)
    out = pops.Assert().forward(PTable(torch.tensor(True),
                                       torch.from_numpy(x)))
    np.testing.assert_array_equal(out.numpy(), x)
    with pytest.raises(ValueError, match="Assert op failed"):
        pops.Assert().forward(PTable(torch.tensor([True, False]),
                                     torch.from_numpy(x)))
    with pytest.raises(ValueError):
        jops.Assert().forward(JTable(np.bool_(False), jnp.asarray(x)))


def test_tensor_op_chains_and_wrappers_match_jax():
    x = POS
    j = jops.TensorOp().exp().add(1.0).log().mul(2.0).sub(0.5).div(3.0) \
        .abs().sqrt().square().pow(1.5)
    p = pops.TensorOp().exp().add(1.0).log().mul(2.0).sub(0.5).div(3.0) \
        .abs().sqrt().square().pow(1.5)
    _same(_np(p.forward(torch.from_numpy(x))), _np(j.forward(jnp.asarray(x))))
    for cls in ("ModuleToOperation", "TensorModuleWrapper"):
        j = getattr(jops, cls)(jnn.AddConstant(2.0))
        p = getattr(pops, cls)(pnn.AddConstant(2.0))
        _same(_np(p.forward(torch.from_numpy(A))),
              _np(j.forward(jnp.asarray(A))))
    lin_j = jops.ModuleToOperation(jnn.Linear(4, 2))
    lin_p = pops.ModuleToOperation(pnn.Linear(4, 2))
    lin_j.ensure_initialized()
    assert set(lin_p.params) == set(lin_j.params) == {"weight", "bias"}

    class JGt(jops.Compare):
        def _cmp(self, a, b):
            return a > b

    class PGt(pops.Compare):
        def _cmp(self, a, b):
            return a > b
    _same(_np(PGt().forward(PTable(torch.from_numpy(A), torch.from_numpy(B)))),
          _np(JGt().forward(JTable(jnp.asarray(A), jnp.asarray(B)))))


def test_random_ops_range_moments_and_determinism():
    shape = np.array([400, 50], np.int32)
    u = pops.RandomUniform(2.0, 3.0, seed=7)
    a, _ = u.apply({}, {}, torch.from_numpy(shape))
    b, _ = u.apply({}, {}, torch.from_numpy(shape))
    assert a.shape == (400, 50) and torch.equal(a, b)
    assert float(a.min()) >= 2.0 and float(a.max()) < 3.0
    assert abs(float(a.mean()) - 2.5) < 0.01
    assert abs(float(a.var()) - 1 / 12) < 0.005
    g = torch.Generator().manual_seed(1)
    c, _ = u.apply({}, {}, torch.from_numpy(shape), False, g)
    assert not torch.equal(a, c)
    t = pops.TruncatedNormal(1.0, 2.0)
    z, _ = t.apply({}, {}, torch.from_numpy(shape))
    z2, _ = pops.TruncatedNormal(1.0, 2.0, seed=0).apply(
        {}, {}, torch.from_numpy(shape))
    assert torch.equal(z, z2)
    assert float((z - 1.0).abs().max()) <= 4.0 + 1e-5
    # the normal truncated at 2 sigma: mean 0, variance 0.7737
    zs = (z - 1.0) / 2.0
    assert abs(float(zs.mean())) < 0.02
    assert abs(float(zs.var()) - 0.7737) < 0.02
    # JAX's draws come from its own key stream: only their law agrees
    jz = np.asarray(jops.TruncatedNormal(1.0, 2.0).apply(
        {}, {}, jnp.asarray(shape), False, jax.random.PRNGKey(0))[0])
    assert abs(float(((jz - 1) / 2).var()) - float(zs.var())) < 0.03
