"""The port's int8 quantization (``bigdl_tpu_torch.quantization`` and the
int8 contraction ``kernels.int8_matmul``) against the JAX package's.

* The plain versions of the int8 contraction (``int8_matmul_reference``,
  ``int8_conv2d_reference``) against JAX's ``lax.dot_general`` /
  ``lax.conv_general_dilated`` over the same int8 operands: equal int32,
  with groups, dilation, stride, asymmetric padding and the depthwise
  case. The card's im2col operands (``_conv_operands``: the strides the
  CUDA kernel walks for each group) are held here too, by an int32 GEMM
  over the same strided views.
* ``QuantizedLinear``, ``QuantizedSpatialConvolution`` and the separable
  convolution against JAX's, from the same float weights, dynamic and
  calibrated: the int8 codes equal (a code may differ only where
  w / scale is an exact .5 tie, and then by one step; the check says
  where) and the outputs within 1e-5 of the largest JAX value.
* ``quantize`` of LeNet-5 and of JAX's graph model at 1e-5, and of the
  default ResNet-50 at B2/64x64: JAX's own bounds against the float model
  (top-1 agreement >= 0.5, relative logit error < 0.25) and port against
  JAX at 1e-4 (a deep int8 stack requantizes at every layer; see
  ``test_quantize_resnet50``).
* ``calibrate`` with each observer, and ``fold_batchnorm``, against JAX.
* ``quantize_lm_params``: int8, int4 at group 16 and at an auto-fitted
  group. Logits of ``apply`` within 1e-4 of JAX's quantized model,
  ``generate`` tokens up to the first near-tie, ``lm_quantized_bytes``
  equal, the registry's transform placing the carriers, ``bf16_params``
  of a quantized tree equal to JAX's, ``speculative_generate`` over an
  int4 target, and tensor-parallel serving over a gloo world of two
  ranks (the carriers' columns and scales split together) against one
  rank. JAX's ``str(q.dtype) == "int4"`` check becomes a check of the
  value range: the port holds int4 codes in an int8 tensor.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from bigdl_tpu import nn as jnn
from bigdl_tpu import quantization as jq
from bigdl_tpu.models import lenet as jlenet, resnet as jresnet
from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.nn.speculative import speculative_generate as jax_spec
from bigdl_tpu.utils.amp import bf16_params as jax_bf16
from bigdl_tpu_torch import convert, models, nn, quantization as tq
from bigdl_tpu_torch.kernels import int8_conv2d, int8_matmul
from bigdl_tpu_torch.kernels.int8_matmul import (
    MAX_K, _conv_operands, int8_conv2d_reference, int8_matmul_reference)
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn import speculative_generate
from bigdl_tpu_torch.serving import ModelRegistry
from bigdl_tpu_torch.utils.amp import bf16_params

from torch_quant_world import run_world

torch.set_num_threads(1)
TOL = 1e-5          # quantized modules and models, of the largest value
LM_TOL = 1e-4       # quantized LM logits
MARGIN = 1e-3       # a greedy step whose top-2 margin is below is a tie


def _i8(rng, *shape):
    return rng.randint(-128, 128, shape).astype(np.int8)


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _twin(jm, tm):
    """Carry the port model's weights into the JAX model."""
    tp, ts = convert.to_numpy_trees(tm)
    jm.params = jax.tree_util.tree_map(jnp.asarray, tp)
    jm.state = jax.tree_util.tree_map(jnp.asarray, ts)
    return jm


# -- the int8 contraction ---------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (5, 3, 7), (37, 19, 147),
                                   (64, 16, 32), (17, 8, 9), (33, 65, 1440)])
def test_int8_matmul_reference_equals_dot_general(m, n, k):
    rng = np.random.RandomState(m * 7 + n + k)
    a, b = _i8(rng, m, k), _i8(rng, n, k)
    want = lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                           (((1,), (1,)), ((), ())),
                           preferred_element_type=jnp.int32)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the batched form: G independent products
    g = int8_matmul(torch.from_numpy(np.stack([a, a[::-1]])),
                    torch.from_numpy(np.stack([b, b])))
    np.testing.assert_array_equal(g[1].numpy(),
                                  int8_matmul_reference(
                                      torch.from_numpy(a[::-1].copy()),
                                      torch.from_numpy(b)).numpy())


CONVS = [  # x shape, w shape, stride, ((top, bottom), (left, right)), dilation, groups
    ((2, 3, 16, 16), (8, 3, 7, 7), (2, 2), ((3, 3), (3, 3)), (1, 1), 1),
    ((2, 16, 9, 9), (12, 16, 3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1), 1),
    ((2, 8, 10, 10), (8, 1, 3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1), 8),
    ((1, 6, 11, 13), (6, 1, 3, 3), (2, 2), ((0, 1), (1, 0)), (1, 1), 6),
    ((3, 8, 11, 13), (12, 4, 3, 5), (2, 1), ((2, 2), (1, 1)), (2, 1), 2),
    ((2, 4, 12, 12), (6, 2, 3, 3), (1, 2), ((2, 2), (2, 2)), (2, 2), 2),
    ((1, 5, 7, 7), (3, 5, 1, 1), (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
]


@pytest.mark.parametrize("case", CONVS, ids=[f"conv{i}" for i in
                                             range(len(CONVS))])
def test_int8_conv2d_reference_equals_conv_general_dilated(case):
    xs, ws, stride, pads, dil, groups = case
    rng = np.random.RandomState(sum(xs) + sum(ws))
    x, w = _i8(rng, *xs), _i8(rng, *ws)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), stride, list(pads),
        rhs_dilation=dil, dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=groups, preferred_element_type=jnp.int32))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = int8_conv2d(xt, wt, stride, pads, dil, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the card's operands: group g's GEMM over the strided views the
    # kernel walks (lda / ldb / ldc, group strides sa / sb / sc)
    cols, wc, out, (G, M, N, K, lda, ldb, ldc, sa, sb, sc) = \
        _conv_operands(xt, wt, stride, pads, dil, groups)
    flat_out = out.reshape(-1)
    for g in range(G):
        a = cols.reshape(-1).as_strided((M, K), (lda, 1), g * sa)
        b = wc.reshape(-1).as_strided((N, K), (ldb, 1), g * sb)
        flat_out.as_strided((M, N), (ldc, 1), g * sc).copy_(
            int8_matmul_reference(a, b))
    np.testing.assert_array_equal(out.permute(0, 3, 1, 2).numpy(), want)


def test_int8_contraction_refuses_an_overflowing_depth():
    a = torch.zeros(1, MAX_K + 1, dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        int8_matmul(a, a)
    assert MAX_K * 128 * 128 < 2**31 <= (MAX_K + 1) * 128 * 128


# -- quantized modules ------------------------------------------------------------

def _codes_equal(got, want, w, scale, axis=0):
    """Equal int8 codes, but where w / scale is an exact .5 tie (the one
    place two correct roundings may differ), where they may differ by one
    step: the positions are returned."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.nonzero(got != want)
    if diff[0].size:
        ratio = np.asarray(w, np.float32) / np.asarray(scale, np.float32)
        frac = np.abs(ratio[diff] - np.trunc(ratio[diff]))
        assert np.all(frac == 0.5) and np.all(
            np.abs(got[diff] - want[diff]) == 1), list(zip(*diff))
    return list(zip(*diff))


def _module_pair(make_j, make_t, x, calibrate=False, observer=None):
    """(JAX quantized model, port quantized model, JAX float model, port
    float model): the same float weights, quantized by each package."""
    tm = make_t().evaluate()
    jm = _twin(make_j(), tm).evaluate()
    jcal = tcal = None
    if calibrate:
        batches = [x, x * 0.5]
        kw = {} if observer is None else {"observer_factory": observer[0]}
        tkw = {} if observer is None else {"observer_factory": observer[1]}
        jcal = jq.calibrate(jm, batches, **kw)
        tcal = tq.calibrate(tm, batches, **tkw)
        assert sorted(jcal) == sorted(tcal)
        for k in jcal:
            assert abs(jcal[k] - tcal[k]) <= 1e-7 * max(jcal[k], 1e-8), k
    return jq.quantize(jm, jcal), tq.quantize(tm, tcal), jm, tm


def _check_quantized(jqm, tqm, x):
    jflat = convert.flatten(jax.tree_util.tree_map(np.asarray, jqm.params))
    tflat = convert.flatten(convert.to_numpy_tree(tqm.params))
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        if v.dtype == np.int8:
            assert tflat[k].dtype == np.int8, k
            np.testing.assert_array_equal(tflat[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(tflat[k], v, rtol=1e-7, atol=0,
                                       err_msg=k)
    want = np.asarray(jqm.forward(x))
    got = tqm.forward(torch.from_numpy(x))
    assert _rel(got, want) < TOL, _rel(got, want)
    return got, want


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "static"])
@pytest.mark.parametrize("kind", ["linear", "conv", "conv_same_dilated",
                                  "conv_grouped", "separable"])
def test_quantized_module_equals_jax(kind, calibrated):
    rng = np.random.RandomState(3)
    if kind == "linear":
        mk = lambda p: p.Sequential().add(p.Linear(24, 10))
        x = rng.randn(6, 24).astype(np.float32)
    elif kind == "conv":
        mk = lambda p: p.Sequential().add(
            p.SpatialConvolution(3, 8, 3, 3, 2, 2, 1, 1))
        x = rng.randn(2, 3, 9, 9).astype(np.float32)
    elif kind == "conv_same_dilated":
        mk = lambda p: p.Sequential().add(p.SpatialConvolution(
            4, 6, 3, 3, 2, 2, -1, -1, dilation_w=2, dilation_h=2))
        x = rng.randn(2, 4, 9, 10).astype(np.float32)
    elif kind == "conv_grouped":
        mk = lambda p: p.Sequential().add(p.SpatialConvolution(
            8, 12, 3, 3, 1, 1, 1, 1, n_group=4, with_bias=False))
        x = rng.randn(2, 8, 7, 7).astype(np.float32)
    else:
        mk = lambda p: p.Sequential().add(p.SpatialSeparableConvolution(
            4, 6, 2, 3, 3, 1, 1, 1, 1))
        x = rng.randn(2, 4, 8, 8).astype(np.float32)
    jqm, tqm, _, _ = _module_pair(lambda: mk(jnn), lambda: mk(nn), x,
                                  calibrate=calibrated)
    _check_quantized(jqm, tqm, x)
    # the port's quantized layer keeps no gradient and is in eval mode
    assert not bool(tqm.training)
    assert all(not p.requires_grad for p in tqm.parameters())


def test_quantize_weight_codes_equal_jax_and_ties_are_named():
    rng = np.random.RandomState(5)
    w = rng.randn(16, 3, 3, 3).astype(np.float32)
    w[0, 0, 0, 0] = 2.0                       # a channel whose max is 2
    w[0, 0, 0, 1] = np.float32(2.0 / 127 * 60.5)   # near a .5 tie
    want_q, want_s = jq.quantize_weight(jnp.asarray(w), axis=0)
    got_q, got_s = tq.quantize_weight(torch.from_numpy(w), axis=0)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    ties = _codes_equal(got_q.numpy(), np.asarray(want_q), w,
                        np.asarray(want_s))
    assert ties == []
    # a 1-D weight (one channel a value) as JAX's reduces over no axis
    v = rng.randn(7).astype(np.float32)
    np.testing.assert_array_equal(
        tq.quantize_weight(torch.from_numpy(v))[0].numpy(),
        np.asarray(jq.quantize_weight(jnp.asarray(v))[0]))


def test_quantize_lenet5_equals_jax():
    x = np.random.RandomState(0).randn(4, 28, 28).astype(np.float32)
    jqm, tqm, _, _ = _module_pair(lambda: jlenet.LeNet5(10),
                                  lambda: models.LeNet5(10, device="cpu"), x)
    _check_quantized(jqm, tqm, x)
    kinds = [type(m) for m in tqm.modules()]
    assert kinds.count(tq.QuantizedLinear) == 2
    assert kinds.count(tq.QuantizedSpatialConvolution) == 2


def _graph(p, head):
    """JAX's graph model (``test_quantization.py``
    ``test_quantized_graph_model``: conv, ReLU), with a Linear head."""
    inp = p.Input()
    h = p.SpatialConvolution(1, 4, 3, 3)(inp)
    r = p.ReLU()(h)
    if not head:
        return p.Graph(inp, r)
    o = p.Linear(4 * 4 * 4, 3)(p.Reshape([64], batch_mode=True)(r))
    return p.Graph(inp, o)


@pytest.mark.parametrize("head", [False, True], ids=["jax_graph", "linear"])
def test_quantize_graph_model_equals_jax(head):
    x = np.random.RandomState(1).randn(2, 1, 6, 6).astype(np.float32)
    jqm, tqm, jm, tm = _module_pair(lambda: _graph(jnn, head),
                                    lambda: _graph(nn, head), x)
    got, _ = _check_quantized(jqm, tqm, x)
    # the graph's nodes were rewired to the quantized modules
    mods = [n.module for n in tqm.topo if n.module is not None]
    assert any(isinstance(m, tq.QuantizedSpatialConvolution) for m in mods)
    assert any(isinstance(m, tq.QuantizedLinear) for m in mods) == head
    # the float model is untouched
    ref = tm.forward(torch.from_numpy(x))
    assert _rel(got, ref.detach().numpy()) < 0.05
    assert not any(isinstance(m, tq.QuantizedLinear)
                   for m in tm.modules())


def test_quantize_resnet50_jax_bounds_and_parity():
    """JAX's ResNet-50 check (``test_quantization.py``
    ``test_quantized_resnet50_accuracy_drop``) on the port, and the port's
    int8 logits against JAX's. Dynamic activation scales requantize at
    every one of 54 layers, so a last-bit difference of a float32 rescale
    (XLA fuses the multiplies differently) can move one int8 code by a
    step downstream: port against JAX is held at 1e-4, the float model at
    JAX's bounds."""
    x = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    jqm, tqm, jm, tm = _module_pair(
        lambda: jresnet.ResNet(class_num=10, depth=50),
        lambda: models.ResNet(class_num=10, depth=50, device="cpu"), x)
    ref = tm.forward(torch.from_numpy(x)).detach().numpy()
    out = tqm.forward(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.5
    assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-8) < 0.25
    # JAX's forward compiled once (op by op it compiles every layer's ops)
    want = jax.jit(lambda p, s, x: jqm.apply(p, s, x, training=False)[0])(
        jqm.params, jqm.state, jnp.asarray(x))
    assert _rel(out, want) < 1e-4


def test_sparse_linear_stays_float():
    m = nn.Sequential(nn.SparseLinear(6, 4), nn.ReLU())
    q = tq.quantize(m)
    assert isinstance(q[0], nn.SparseLinear)
    assert q.params["0"]["weight"].dtype == torch.float32


def test_module_quantize_is_quantize():
    m = nn.Sequential(nn.Linear(5, 3))
    x = torch.randn(2, 5)
    a, b = m.quantize(), tq.quantize(m)
    torch.testing.assert_close(a.forward(x), b.forward(x), rtol=0, atol=0)


# -- calibration ------------------------------------------------------------------

def _convnet(p):
    return p.Sequential().add(p.SpatialConvolution(1, 4, 3, 3)).add(
        p.ReLU()).add(p.Reshape([4 * 6 * 6], batch_mode=True)).add(
        p.Linear(4 * 6 * 6, 10))


@pytest.mark.parametrize("obs", ["minmax", "moving", "percentile"])
def test_calibrate_equals_jax(obs):
    factories = {"minmax": (jq.MinMaxObserver, tq.MinMaxObserver),
                 "moving": (lambda: jq.MovingAverageObserver(0.7),
                            lambda: tq.MovingAverageObserver(0.7)),
                 "percentile": (lambda: jq.PercentileObserver(99.0),
                                lambda: tq.PercentileObserver(99.0))}[obs]
    x = np.random.RandomState(4).randn(4, 1, 8, 8).astype(np.float32)
    jqm, tqm, _, tm = _module_pair(lambda: _convnet(jnn),
                                   lambda: _convnet(nn), x, calibrate=True,
                                   observer=factories)
    _check_quantized(jqm, tqm, x)
    assert "act_scale" in tqm.params["0"] and "act_scale" in tqm.params["3"]
    # the hooks are gone: the class's apply is back
    for _, m in tq.quantizable_paths(tm):
        assert "apply" not in m.__dict__


def test_observers_equal_jax():
    batches = [np.full((4,), v, np.float32) for v in (1.0, 3.0, 2.0)]
    for jo, to in ((jq.MinMaxObserver(), tq.MinMaxObserver()),
                   (jq.MovingAverageObserver(0.5),
                    tq.MovingAverageObserver(0.5))):
        for b in batches:
            jo.update(jnp.asarray(b))
            to.update(torch.from_numpy(b))
        assert jo.absmax == to.absmax and jo.scale == to.scale
    x = np.ones(100, np.float32)
    x[0] = 1000.0
    jo, to = jq.PercentileObserver(50), tq.PercentileObserver(50)
    jo.update(jnp.asarray(x))
    to.update(torch.from_numpy(x))
    assert jo.absmax == to.absmax < 10


def _bn_net(p):
    return p.Sequential().add(p.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1,
                                                   with_bias=False)).add(
        p.SpatialBatchNormalization(4)).add(p.ReLU()).add(
        p.Reshape([4 * 5 * 5], batch_mode=True)).add(p.Linear(100, 6)).add(
        p.BatchNormalization(6))


def test_fold_batchnorm_equals_jax():
    rng = np.random.RandomState(6)
    tm = _bn_net(nn)
    with torch.no_grad():       # running statistics away from (0, 1)
        for i in (1, 5):
            tm[i].running_mean.copy_(torch.from_numpy(
                rng.randn(tm[i].n_output).astype(np.float32)))
            tm[i].running_var.copy_(torch.from_numpy(
                rng.rand(tm[i].n_output).astype(np.float32) + 0.5))
            tm[i].weight.copy_(torch.from_numpy(
                rng.randn(tm[i].n_output).astype(np.float32)))
    tm.evaluate()
    jm = _twin(_bn_net(jnn), tm).evaluate()
    x = rng.randn(3, 2, 5, 5).astype(np.float32)
    ref = tm.forward(torch.from_numpy(x)).detach().numpy()
    jq.fold_batchnorm(jm)
    tq.fold_batchnorm(tm)
    assert isinstance(tm[1], nn.Identity) and isinstance(tm[5], nn.Identity)
    assert tm.params["1"] == {} and tm.state["5"] == {}
    jflat = convert.flatten(jax.tree_util.tree_map(np.asarray, jm.params))
    tflat = convert.flatten(convert.to_numpy_tree(tm.params))
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    got = tm.forward(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, np.asarray(jm.forward(x))) < TOL
    assert _rel(got, ref) < 1e-4       # folding keeps the function
    # folded, then calibrated and quantized, as JAX's
    cal_j = jq.calibrate(jm, [x])
    cal_t = tq.calibrate(tm, [x])
    _check_quantized(jq.quantize(jm, cal_j), tq.quantize(tm, cal_t), x)


# -- the weight-only LM -----------------------------------------------------------

V = 43
LM = dict(vocab_size=V, hidden_size=32, num_heads=2, filter_size=64,
          num_layers=2, max_len=32)
_lm_cache = {}


def _lm_pair(seed=0, **over):
    key = (seed, tuple(sorted(over.items())))
    if key not in _lm_cache:
        cfg = dict(LM, **over)
        jm = JaxLM(**cfg)
        jp, _ = jm.init(jax.random.PRNGKey(seed))
        # 0.3 N(0, 1) weights: clear greedy margins (a fresh 0.02-scale
        # model repeats one token on near-tied logits)
        rng = np.random.RandomState(seed + 50)
        jp = jax.tree_util.tree_map(
            lambda a: jnp.asarray(0.3 * rng.randn(*a.shape), a.dtype), jp)
        tm = TransformerLM(device="cpu", **cfg)
        tm.load_state_dict(convert.jax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jp)))
        _lm_cache[key] = (jm, jp, tm)
    return _lm_cache[key]


QUANTS = {"int8": dict(bits=8), "int4_g16": dict(bits=4, group=16),
          "int4_auto": dict(bits=4)}


def _quantized(kind, seed=0):
    jm, jp, tm = _lm_pair(seed)
    jqp = jq.quantize_lm_params(jp, **QUANTS[kind])
    tqp = tq.quantize_lm_params(tm.params, **QUANTS[kind])
    return jm, jqp, tm, tqp


@pytest.mark.parametrize("kind", list(QUANTS))
def test_quantize_lm_params_equals_jax(kind):
    jm, jqp, tm, tqp = _quantized(kind)
    carrier = tq.QuantizedWeight if kind == "int8" else tq.QuantizedWeightInt4
    for blk in range(2):
        for where, k in (("attn", "wq"), ("attn", "wo"), ("ffn", "w1"),
                         ("ffn", "w2")):
            t, j = tqp[f"block{blk}"][where][k], jqp[f"block{blk}"][where][k]
            assert isinstance(t, carrier), (k, type(t))
            q = np.asarray(j.q).astype(np.int8)
            np.testing.assert_array_equal(t.q.numpy(), q)
            np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))
            if kind != "int8":
                # JAX's int4 dtype check, as the codes' range
                assert t.q.dtype == torch.int8 and t.group == j.group
                assert int(t.q.min()) >= -8 and int(t.q.max()) <= 7
    assert torch.equal(tqp["embed"], tm.params["embed"])     # dense
    assert tq.lm_quantized_bytes(tqp) == jq.lm_quantized_bytes(jqp)
    ids = np.random.RandomState(0).randint(1, V, (2, 10)).astype(np.int32)
    fwd = jax.jit(lambda p, x: jm.apply(p, {}, x, training=False)[0])
    want = fwd(jqp, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = tm.apply(tqp, {}, torch.from_numpy(ids), training=False)
    assert _rel(got, want) < LM_TOL, _rel(got, want)
    dense = fwd(_lm_pair()[1], jnp.asarray(ids))
    bound = 0.08 if kind == "int8" else 0.2          # JAX's bounds
    assert _rel(got, dense) < bound


def _margins(tm, params, ids, tp):
    with torch.no_grad():
        lg = tm.call(params, torch.as_tensor(ids[:, :-1]))[:, tp - 1:]
    top = lg.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).numpy()


def _agree(got, want, margins):
    for g, w, m in zip(np.asarray(got), np.asarray(want), margins):
        low = np.nonzero(m < MARGIN)[0]
        k = len(m) if low.size == 0 else int(low[0]) + 1
        tp = len(g) - len(m)
        np.testing.assert_array_equal(g[:tp + k], w[:tp + k])


@pytest.mark.parametrize("kind", list(QUANTS))
def test_quantized_lm_generate_equals_jax(kind):
    jm, jqp, tm, tqp = _quantized(kind)
    ids = np.random.RandomState(1).randint(1, V, (2, 4)).astype(np.int32)
    want = np.asarray(jm.generate(jqp, jnp.asarray(ids), max_new_tokens=6))
    with torch.no_grad():
        got = tm.generate(tqp, torch.from_numpy(ids), 6).numpy()
    _agree(got, want, _margins(tm, tqp, got, 4))


def test_registry_transform_places_the_carriers():
    jm, jp, tm = _lm_pair()
    reg = ModelRegistry(device="cpu")
    v = reg.publish(tm.params, version="int8", activate=True,
                    transform=tq.quantize_lm_params)
    qp = reg.get(v).params
    w = qp["block0"]["attn"]["wq"]
    assert isinstance(w, tq.QuantizedWeight)
    assert w.q.device.type == "cpu" and w.s.device.type == "cpu"
    assert not w.s.requires_grad
    with torch.no_grad():
        out = tm.generate(qp, torch.tensor([[1, 2, 3]]), 4)
    assert tuple(out.shape) == (1, 7)


@pytest.mark.parametrize("kind", ["int8", "int4_g16"])
def test_bf16_params_of_a_quantized_tree_equals_jax(kind):
    _, jqp, _, tqp = _quantized(kind)
    j16, t16 = jax_bf16(jqp), bf16_params(tqp)
    w_j, w_t = j16["block1"]["ffn"]["w2"], t16["block1"]["ffn"]["w2"]
    assert w_t.q.dtype == torch.int8 and w_t.s.dtype == torch.bfloat16
    assert str(w_j.s.dtype) == "bfloat16" and w_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(w_t.q.numpy(), np.asarray(w_j.q)
                                  .astype(np.int8))
    np.testing.assert_array_equal(
        w_t.s.float().numpy(), np.asarray(w_j.s).astype(np.float32))
    jflat = convert.flatten({k: v for k, v in j16.items()})
    assert t16["embed"].dtype == torch.bfloat16
    assert str(jflat["embed"].dtype) == "bfloat16"


def test_speculative_over_an_int4_target_equals_jax():
    """JAX's ``test_speculative_composes_with_weight_only_quantization``:
    speculation over the int4 target is the target's own greedy decode."""
    jm, jqp, tm, tqp = _quantized("int4_g16")
    jd, jdp, td = _lm_pair(seed=11, num_layers=1)
    ids = np.random.RandomState(13).randint(1, V, (2, 5)).astype(np.int32)
    want = np.asarray(jax_spec(jm, jqp, jd, jdp, jnp.asarray(ids),
                               max_new_tokens=8, k=3))
    with torch.no_grad():
        dense = tm.generate(tqp, torch.from_numpy(ids), 8).numpy()
        got = speculative_generate(tm, tqp, td, td.params,
                                   torch.from_numpy(ids), max_new_tokens=8,
                                   k=3).numpy()
    np.testing.assert_array_equal(got, dense)
    _agree(got, want, _margins(tm, tqp, got, 5))


def test_convert_carries_jax_quantized_trees():
    _, jqp, _, tqp = _quantized("int4_g16")
    carried = convert.to_torch_tree(jax.tree_util.tree_map(np.asarray, jqp))
    w = carried["block0"]["ffn"]["w1"]
    assert isinstance(w, tq.QuantizedWeightInt4) and w.q.dtype == torch.int8
    assert w.group == 16
    t = tqp["block0"]["ffn"]["w1"]
    assert torch.equal(w.q, t.q) and torch.equal(w.s, t.s)
    back = convert.to_numpy_tree(tqp)["block0"]["ffn"]["w1"]
    assert isinstance(back.q, np.ndarray) and back.group == 16


@pytest.mark.parametrize("kind", ["int8", "int4_g16"])
def test_quantized_lm_tensor_parallel_equals_one_rank(kind):
    """JAX serves a quantized tree over a ``model`` mesh (its spec tree
    goes into the carriers, the compiler splits the products); the port's
    two gloo ranks each hold their columns (or rows) of every carrier and
    its scales, and give one rank's logits and tokens. FSDP slices of a
    carrier are refused with a clear error."""
    _, _, tm = _lm_pair(seed=3, num_heads=4)
    weights = convert.host_copy_tree(tm.params)
    cfg = dict(LM, num_heads=4)
    ids = np.random.RandomState(2).randint(1, V, (2, 4)).astype(np.int32)
    outs = run_world("quantized_tp", 2, cfg, weights, ids, 5,
                     QUANTS[kind])
    for o in outs:
        assert o["split"], o
        np.testing.assert_array_equal(o["tokens"], o["solo"])
        assert _rel(o["logits"], o["solo_logits"]) < LM_TOL
        assert "FSDP" in o["fsdp_error"]
