"""The port's bigdl.proto serializer (``bigdl_tpu_torch.loaders.
bigdl_proto``) against the JAX package's, both tiers, both directions: a
file either package writes loads in the other and gives the writer's
outputs, and for the same model and params the two write the same bytes
(the module names set alike: each package numbers its auto-generated names
from its own counter). Covered: BatchNorm running statistics, a grouped
convolution, the reference's legacy weight / bias fields, negative int
attrs, a RoPE / GQA LM's logits (1e-4), a quantized LeNet-5, a criterion,
a graph, and the pickle refusals."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.loaders import bigdl_proto as JB
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models.transformer_lm import TransformerLM as JLM
from bigdl_tpu_torch import convert, models
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.loaders import bigdl_proto as PB
from bigdl_tpu_torch.loaders import wire
from bigdl_tpu_torch.models.transformer_lm import TransformerLM as PLM

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
LM_TOL = dict(atol=1e-4, rtol=1e-4)


def _conv_net(N, p):
    """A small net in the reference tier: grouped conv, BatchNorm, pools,
    dropout, a flatten with a negative size, linear, log-softmax."""
    return N.Sequential(
        N.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1, n_group=2),
        N.SpatialBatchNormalization(4),
        N.ReLU(),
        N.SpatialMaxPooling(2, 2, 2, 2).ceil(),
        N.SpatialConvolution(4, 6, 3, 3, 1, 1, -1, -1),
        N.Tanh(),
        N.SpatialAveragePooling(2, 2, 2, 2),
        N.Dropout(0.25),
        N.Reshape([-1, 6 * 2 * 2]),
        N.Linear(24, 5),
        N.Identity(),
        N.LogSoftMax())


def _name_alike(jm, pm, prefix="m"):
    """Give the two packages' modules the same names, walking the
    containers' children in order."""
    jm.set_name(prefix)
    pm.set_name(prefix)
    jkids = getattr(jm, "modules", None)
    if isinstance(jkids, list):
        for i, (jc, pc) in enumerate(zip(jkids, pm._modules.values())):
            _name_alike(jc, pc, f"{prefix}_{i}")


def _pair(seed=0):
    jm, pm = _conv_net(jnn, None), _conv_net(pnn, None)
    _name_alike(jm, pm)
    # JAX's parameter shapes without running its initialisers
    shapes = jax.eval_shape(jm._init_params, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    jp = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.randn(*a.shape)).astype(np.float32), shapes)
    js = jax.tree_util.tree_map(
        lambda a: (0.5 + rng.rand(*np.shape(a))).astype(np.float32),
        jm._init_state())
    jm.params = jax.tree_util.tree_map(jnp.asarray, jp)
    jm.state = jax.tree_util.tree_map(jnp.asarray, js)
    pm.load_state_dict(convert.jax_to_state_dict(jp, js))
    jm.evaluate()
    pm.evaluate()
    return jm, pm


X = np.random.RandomState(5).randn(3, 2, 8, 8).astype(np.float32)


def _out_j(jm, x=X):
    """JAX's evaluation-mode forward, compiled once."""
    jm.ensure_initialized()
    f = jax.jit(lambda p, s, v: jm.apply(p, s, v, training=False)[0])
    return np.asarray(f(jm.params, jm.state, jnp.asarray(x)))


def _out_p(pm, x=X):
    with torch.no_grad():
        return pm.forward(torch.from_numpy(x)).numpy()


def test_reference_tier_same_bytes_and_both_directions(tmp_path):
    jm, pm = _pair()
    JB.save_bigdl(jm, str(tmp_path / "j.bigdl"))
    PB.save_bigdl(pm, str(tmp_path / "p.bigdl"))
    jb = (tmp_path / "j.bigdl").read_bytes()
    assert jb == (tmp_path / "p.bigdl").read_bytes()
    want = _out_j(jm)
    np.testing.assert_allclose(_out_p(pm), want, **TOL)
    back = PB.load_bigdl(str(tmp_path / "j.bigdl"), device="cpu")
    np.testing.assert_allclose(_out_p(back), want, **TOL)
    # the running statistics and the grouped weight came across exactly
    np.testing.assert_array_equal(back[1].running_var.numpy(),
                                  np.asarray(jm.state["1"]["running_var"]))
    assert back[0].n_group == 2 and back[4].padding == (-1, -1)
    assert list(back[8].size) == [-1, 24]
    jback = JB.load_bigdl(str(tmp_path / "p.bigdl"))
    np.testing.assert_allclose(_out_j(jback), want, **TOL)
    # the port writes what it read, byte for byte
    PB.save_bigdl(back, str(tmp_path / "again.bigdl"))
    assert (tmp_path / "again.bigdl").read_bytes() == jb


def test_legacy_weight_and_bias_fields(tmp_path):
    rng = np.random.RandomState(1)
    w = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    ids = JB._Ids()
    body = wire.field_string(1, "fc")
    body += wire.field_bytes(3, JB._enc_tensor(w, ids))
    body += wire.field_bytes(4, JB._enc_tensor(b, ids))
    body += wire.field_string(7, JB._SCALA_NN + "Linear")
    body += JB._map_entry("inputSize", JB._attr_i32(4))
    body += JB._map_entry("outputSize", JB._attr_i32(3))
    (tmp_path / "l.bigdl").write_bytes(body)
    m = PB.load_bigdl(str(tmp_path / "l.bigdl"), device="cpu")
    np.testing.assert_array_equal(m.weight.detach().numpy(), w)
    np.testing.assert_array_equal(m.bias.detach().numpy(), b)
    x = rng.randn(2, 4).astype(np.float32)
    np.testing.assert_allclose(
        _out_p(m, x), np.asarray(JB.load_bigdl(body).forward(x)), **TOL)


def test_negative_int_attrs_round_trip():
    ids = JB._Ids()
    for v in (-1, -7, -2**31, 2**31 - 1):
        enc = JB._attr_i32(v)
        assert JB._dec_attr(enc, {}) == PB._dec_attr(enc, {}) == v
        assert PB._attr_i32(v) == enc
    arr = JB._attr_i32_array([-1, 0, 5, -300])
    assert PB._attr_i32_array([-1, 0, 5, -300]) == arr
    assert PB._dec_attr(arr, {}) == [-1, 0, 5, -300]
    t = np.array([[-3, 7], [0, -2**31]], np.int32)
    enc = JB._enc_tensor(t, ids, keep_dtype=True)
    assert PB._enc_tensor(torch.from_numpy(t), PB._Ids(), True) == \
        JB._enc_tensor(t, JB._Ids(), keep_dtype=True)
    np.testing.assert_array_equal(PB._dec_tensor(enc, {}), t)


def _in_order(like, tree):
    """``tree``'s leaves as JAX arrays in ``like``'s key order (a
    ``tree_map`` sorts dict keys, and JAX writes a tree in its order)."""
    if isinstance(like, dict):
        return {k: _in_order(like[k], tree[k]) for k in like}
    return jnp.asarray(tree)


def _lm_pair():
    jl = JLM(64, 32, 4, 64, 2, num_kv_heads=2, pos_encoding="rope")
    pl = PLM(64, 32, 4, 64, 2, num_kv_heads=2, pos_encoding="rope",
             device="cpu")
    # JAX's shapes without its initialisers, in its initialisers' key
    # order (the port's tree keeps it)
    shapes = jax.eval_shape(jl._init_params, jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    jp = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32), shapes)
    jl.params = _in_order(pl.params, jp)
    jl.state = {}
    pl.load_state_dict(convert.jax_to_state_dict(jp))
    for m in (jl, pl):
        m.set_name("lm")
        m.ln_f.set_name("ln_f")
        for i, b in enumerate(m.blocks):
            b.set_name(f"b{i}")
            for part in ("attn", "ffn", "ln1", "ln2"):
                getattr(b, part).set_name(f"b{i}_{part}")
    return jl, pl


def test_rope_gqa_lm_same_bytes_and_logits(tmp_path):
    jl, pl = _lm_pair()
    JB.save_bigdl(jl, str(tmp_path / "j.bigdl"))
    PB.save_bigdl(pl, str(tmp_path / "p.bigdl"))
    assert (tmp_path / "j.bigdl").read_bytes() == \
        (tmp_path / "p.bigdl").read_bytes()
    ids = np.random.RandomState(4).randint(1, 64, (2, 12)).astype(np.int32)
    want = _out_j(jl, ids)
    back = PB.load_bigdl(str(tmp_path / "j.bigdl"), device="cpu")
    assert back.blocks[0].attn.num_kv_heads == 2 and back.blocks[0].attn.rope
    with torch.no_grad():
        got = back.call(back.params, torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **LM_TOL)
    jback = JB.load_bigdl(str(tmp_path / "p.bigdl"))
    np.testing.assert_allclose(_out_j(jback, ids), want, **LM_TOL)


def test_bf16_leaves_keep_their_dtype(tmp_path):
    _, pl = _lm_pair()
    with torch.no_grad():
        for p in pl.parameters():
            p.data = p.data.to(torch.bfloat16)
    PB.save_bigdl(pl, str(tmp_path / "bf16.bigdl"))
    back = PB.load_bigdl(str(tmp_path / "bf16.bigdl"), device="cpu")
    want, got = convert.flatten(pl.params), convert.flatten(back.params)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == torch.bfloat16, k
        assert torch.equal(got[k], want[k]), k
    # JAX reads the extension datatype back as bfloat16 too
    jback = JB.load_bigdl(str(tmp_path / "bf16.bigdl"))
    assert str(jback.params["embed"].dtype) == "bfloat16"


def _quantized_lenets():
    import importlib
    tq = importlib.import_module("bigdl_tpu_torch.quantization.quantize")
    jq = importlib.import_module("bigdl_tpu.quantization.quantize")
    tm = models.LeNet5(10, device="cpu").evaluate()
    jm = jlenet.LeNet5(10)
    jm.params = jax.tree_util.tree_map(jnp.asarray,
                                       convert.to_numpy_tree(tm.params))
    jm.state = jm._init_state()
    jm.evaluate()
    return jq.quantize(jm), tq.quantize(tm)


def test_quantized_lenet_both_directions(tmp_path):
    x = np.random.RandomState(0).randn(4, 28, 28).astype(np.float32)
    jq, tq = _quantized_lenets()
    want = _out_j(jq, x)
    JB.save_bigdl(jq, str(tmp_path / "j.bigdl"))
    back = PB.load_bigdl(str(tmp_path / "j.bigdl"), device="cpu")
    got = _out_p(back, x)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    PB.save_bigdl(tq, str(tmp_path / "p.bigdl"))
    pback = PB.load_bigdl(str(tmp_path / "p.bigdl"), device="cpu")
    np.testing.assert_array_equal(_out_p(pback, x), _out_p(tq, x))
    for k, v in convert.flatten(tq.params).items():
        w = convert.flatten(pback.params)[k]
        assert w.dtype == v.dtype and torch.equal(w, v), k
    jback = JB.load_bigdl(str(tmp_path / "p.bigdl"))
    jgot = _out_j(jback, x)
    assert np.abs(jgot - want).max() <= 1e-5 * np.abs(want).max()


def test_criterion_same_bytes_and_both_directions(tmp_path):
    w = np.array([1.0, 2.0, 0.5], np.float32)
    jc = jnn.ClassNLLCriterion(jnp.asarray(w), size_average=False)
    pc = pnn.ClassNLLCriterion(torch.from_numpy(w), size_average=False)
    JB.save_bigdl(jc, str(tmp_path / "j.bigdl"))
    PB.save_bigdl(pc, str(tmp_path / "p.bigdl"))
    assert (tmp_path / "j.bigdl").read_bytes() == \
        (tmp_path / "p.bigdl").read_bytes()
    back = PB.load_bigdl(str(tmp_path / "j.bigdl"), device="cpu")
    assert isinstance(back, pnn.ClassNLLCriterion)
    logp = np.log(np.full((4, 3), 1 / 3, np.float32)) + \
        np.random.RandomState(0).randn(4, 3).astype(np.float32)
    t = np.array([1, 3, 2, 1], np.float32)
    want = float(jc.forward(jnp.asarray(logp), jnp.asarray(t)))
    got = float(back.forward(torch.from_numpy(logp), torch.from_numpy(t)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_graph_round_trips_through_the_pickled_config(tmp_path):
    inp = pnn.Input()
    h = pnn.Linear(4, 6)(inp)
    o = pnn.Tanh()(pnn.ReLU()(h))
    g = pnn.Graph(inp, o).evaluate()
    PB.save_bigdl(g, str(tmp_path / "g.bigdl"))
    back = PB.load_bigdl(str(tmp_path / "g.bigdl"), device="cpu")
    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    np.testing.assert_array_equal(_out_p(back, x), _out_p(g, x))
    with pytest.raises(ValueError, match="allow_pickle=False"):
        PB.load_bigdl(str(tmp_path / "g.bigdl"), allow_pickle=False,
                      device="cpu")
    assert isinstance(PB.load_bigdl(str(tmp_path / "g.bigdl"),
                                    allow_pickle="unsafe", device="cpu"),
                      pnn.Graph)


def test_a_jax_pickled_graph_is_refused_by_name(tmp_path):
    inp = jnn.Input()
    g = jnn.Graph(inp, jnn.ReLU()(jnn.Linear(4, 6)(inp)))
    JB.save_bigdl(g, str(tmp_path / "jg.bigdl"))
    with pytest.raises(pickle.UnpicklingError, match="bigdl_tpu"):
        PB.load_bigdl(str(tmp_path / "jg.bigdl"), device="cpu")


class _Gadget:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


def test_restricted_unpickler_refuses_gadgets(tmp_path):
    ids = PB._Ids()
    body = wire.field_string(1, "x")
    body += wire.field_string(7, PB._NATIVE_PREFIX +
                              "bigdl_tpu.nn.activation.ReLU")
    body += PB._map_entry("cfgp:evil", PB._attr_custom(
        pickle.dumps(_Gadget())))
    body += wire.field_varint(12, ids.take())
    for bad in (body,):
        with pytest.raises(pickle.UnpicklingError, match="posix.system|"
                           "os.system|refusing"):
            PB.load_bigdl(bad, device="cpu")
    with pytest.raises(ValueError, match="allow_pickle"):
        PB.load_bigdl(body, allow_pickle=False, device="cpu")
    for v in (1, 0, "yes", None):
        with pytest.raises(ValueError, match="allow_pickle must be"):
            PB.load_bigdl(body, allow_pickle=v, device="cpu")


def test_a_jax_pickled_array_loads_as_numpy():
    data = pickle.dumps({"w": jnp.arange(6.0).reshape(2, 3)})
    token = PB._PICKLE_MODE.set("restricted")
    try:
        got = PB._loads(data)
    finally:
        PB._PICKLE_MODE.reset(token)
    assert isinstance(got["w"], np.ndarray)
    np.testing.assert_array_equal(got["w"], np.arange(6.0).reshape(2, 3))


def test_carrier_trees_round_trip():
    from bigdl_tpu_torch.quantization import lm as qlm
    w = torch.randn(256, 8, generator=torch.Generator().manual_seed(0))
    tree = {"a": qlm.quantize_weight_int8(w),
            "b": qlm.quantize_weight_int4(w), "c": {"d": w}, "e": []}
    attrs, ids = {}, PB._Ids()
    PB._enc_tree_attrs(tree, "param", ids, attrs)
    assert not any(k.endswith("_pickle") for k in attrs)
    dec = {k: PB._dec_attr(v, {}) for k, v in attrs.items()}
    back = PB._tree_from_attrs(dec, "param")
    assert type(back["a"]) is type(tree["a"])
    assert type(back["b"]) is type(tree["b"]) and back["b"].group == \
        tree["b"].group
    for x, y in zip(back["a"].children() + back["b"].children(),
                    tree["a"].children() + tree["b"].children()):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(PB._tensor(back["c"]["d"]), w) and back["e"] == []
