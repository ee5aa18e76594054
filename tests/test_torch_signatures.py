"""The port's public signatures against the JAX package's (ROADMAP C.1).

Every public class and function of ``bigdl_tpu_torch`` (the ``__all__``
lists of its packages and modules) that has a twin in ``bigdl_tpu`` (the
same name in the mirrored module) takes the twin's parameters in the
twin's order, with the twin's kinds and defaults, so that a call written
for JAX binds the same way in the port. The port's own additions are
allowed by name and only after every parameter of the twin:
``PORT_ADDITIONS`` (where a call runs and its random source; the port's
``generator`` stands in the place of JAX's ``rng``) and ``PORT_SWITCHES``
(a keyword for a switch JAX reads from the environment, which the port
never reads). A parameter the port does not implement yet is accepted and
raises ``NotImplementedError`` at a value other than JAX's default; the
behaviour tests below hold the constructors the signature diff found
wrong to JAX's reading of positional calls.

Public methods are held the same way: every public method of a class in
both packages takes its twin's parameters (a method the port's modules
inherit from ``torch.nn.Module`` keeps torch's), and every public JAX
method the port lacks is listed in ``UNPORTED_METHODS`` by the JAX class
that defines it, with the ROADMAP item that ports it.
"""
import importlib
import inspect
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu_torch
from bigdl_tpu.nn.attention import TransformerBlock as JaxBlock
from bigdl_tpu_torch import convert, nn
from bigdl_tpu_torch.utils.engine import refuse_unported

torch.set_num_threads(1)
MOD_TOL = dict(atol=1e-5, rtol=1e-5)     # float32 modules, as elsewhere

PORT_ADDITIONS = {"device", "generator", "seed"}
# JAX's BIGDL_TPU_FUSED_CONV2 and BIGDL_TPU_FUSED_CHAIN environment
# switches as keywords
PORT_SWITCHES = {("ResNet", "fused_conv2"), ("FusedBottleneck", "fused_conv2"),
                 ("ResNet", "fused_chain")}


def _twin(obj, name, package):
    """The JAX object of the same name in the mirrored defining module, or
    in the mirrored package that exports it; None without one."""
    for mod in (obj.__module__, package):
        try:
            jm = importlib.import_module(
                "bigdl_tpu" + mod[len("bigdl_tpu_torch"):])
        except ImportError:
            continue
        if hasattr(jm, name):
            return getattr(jm, name)
    return None


def _pairs():
    mods = ["bigdl_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                              "bigdl_tpu_torch.")]
    out, seen = [], set()
    for mn in sorted(mods):
        m = importlib.import_module(mn)
        for name in getattr(m, "__all__", ()):
            obj = getattr(m, name)
            if not (inspect.isclass(obj) or inspect.isfunction(obj)):
                continue
            key = f"{obj.__module__}.{name}"
            if key in seen:
                continue
            seen.add(key)
            twin = _twin(obj, name, mn)
            if twin is not None:
                out.append((key, obj, twin))
    return out


PAIRS = _pairs()


def _params(obj):
    fn = obj.__init__ if inspect.isclass(obj) else obj
    return [p for p in inspect.signature(fn).parameters.values()
            if p.name != "self"]


def _default(d):
    """Defaults compared across frameworks: a dtype by its name."""
    if d is inspect.Parameter.empty:
        return "<required>"
    if isinstance(d, torch.dtype):
        return str(d).replace("torch.", "")
    if isinstance(d, type):
        try:
            return np.dtype(d).name
        except TypeError:
            pass
    return repr(d)


def test_the_pairs_cover_the_fleet_classes():
    names = {key for key, _, _ in PAIRS}
    for want in ("transport.TransportServer", "transport.TransportClient",
                 "transport.RemoteError", "fleet.ReplicaAgent",
                 "fleet.RemoteReplica", "fleet.FleetMonitor",
                 "fleet.DisaggregatedFleet", "fleet.KVHandoffError",
                 "fleet.warm_replica", "fleet.agent_from_config",
                 "controller.FleetController", "controller.ScalePolicy"):
        assert "bigdl_tpu_torch.serving." + want in names, want


def test_the_pairs_cover_the_repaired_constructors():
    names = {key.rsplit(".", 1)[1] for key, _, _ in PAIRS}
    assert {"TransformerBlock", "Attention", "FeedForwardNetwork",
            "SpatialConvolution", "Linear", "SpatialAveragePooling",
            "SpatialBatchNormalization", "ModelRegistry", "ModelVersion",
            "DecodeScheduler", "PagedKVCache", "paged_decode_attention",
            "ResNet", "TransformerLM"} <= names
    assert len(PAIRS) >= 40


@pytest.mark.parametrize("key,port,twin", PAIRS, ids=[p[0] for p in PAIRS])
def test_signature_matches_the_jax_twin(key, port, twin):
    name = key.rsplit(".", 1)[1]
    jp = _params(twin)
    jnames = {p.name for p in jp}
    rows, extra = [], []
    pp = _params(port)
    for i, p in enumerate(pp):
        pname = "rng" if p.name == "generator" and "rng" in jnames else p.name
        if pname not in jnames and (p.name in PORT_ADDITIONS
                                    or (name, p.name) in PORT_SWITCHES):
            extra.append(i)
            continue
        rows.append((pname, p.kind, _default(p.default)))
    want = [(p.name, p.kind, _default(p.default)) for p in jp]
    assert rows == want
    # the additions come after every parameter of the twin
    assert extra == list(range(len(pp) - len(extra), len(pp)))


# -- positional calls read as JAX reads them -------------------------------

def test_transformer_block_defaults_to_bidirectional_like_jax():
    """TransformerBlock(16, 2, 32) attends both ways, as JAX's default
    ``causal=False`` does: the first position's output depends on the
    last, and the block matches JAX's on the same weights."""
    jb = JaxBlock(16, 2, 32)
    jp, _ = jb.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)       # every weight nonzero
    jp = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32), jp)
    tb = nn.TransformerBlock(16, 2, 32)
    assert tb.attn.causal is False
    tp = convert.unflatten(convert.jax_to_state_dict(jp))
    x = np.random.RandomState(0).randn(2, 6, 16).astype(np.float32)
    want, _ = jb.apply(jp, {}, jnp.asarray(x))
    got = tb.call(tp, torch.from_numpy(x))
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               **MOD_TOL)
    x2 = x.copy()
    x2[:, -1] = np.random.RandomState(2).randn(2, 16)    # the last token
    assert not torch.allclose(tb.call(tp, torch.from_numpy(x2))[:, 0],
                              got[:, 0])


def test_positional_dropouts_land_where_jax_puts_them():
    a = nn.Attention(16, 2, 0.1)
    assert a.attention_dropout == 0.1 and a.use_flash is True
    f = nn.FeedForwardNetwork(16, 32, 0.1)
    assert f.relu_dropout == 0.1 and f.activation == "relu"
    b = nn.TransformerBlock(16, 2, 32, 0.1, 0.2)
    assert b.attn.attention_dropout == 0.1 and b.ffn.relu_dropout == 0.2


@pytest.mark.parametrize("build,error", [
    (lambda: nn.Linear(4, 3, True, None, None, np.ones((3, 4))),  # init_weight
     NotImplementedError),
    # seq_axis is ported; JAX's own refusal stays: attention dropout with it
    (lambda: nn.Attention(16, 2, 0.1, True, "seq"), ValueError),
], ids=["linear_init_weight", "attention_seq_axis"])
def test_unported_parameters_raise_at_a_non_default_value(build, error):
    with pytest.raises(error):
        build()


# -- layer parameters that were refused and now take values -------------------

def _x(*shape):
    return torch.from_numpy(np.random.RandomState(0).randn(*shape)
                            .astype(np.float32))


def _accepts_conv_n_group():
    c = nn.SpatialConvolution(4, 8, 3, 3, 1, 1, 1, 1, 2)
    assert c.weight.shape == (8, 2, 3, 3)
    assert c.call(c.params, _x(1, 4, 5, 5)).shape == (1, 8, 5, 5)


def _accepts_conv_dilation():
    c = nn.SpatialConvolution(4, 8, 3, 3, dilation_w=2)
    assert c.call(c.params, _x(1, 4, 7, 7)).shape == (1, 8, 5, 3)


def _accepts_avgpool_ceil_mode():
    p = nn.SpatialAveragePooling(2, 2, 2, 2, 0, 0, False, True)
    assert p.call({}, _x(1, 1, 5, 5)).shape == (1, 1, 3, 3)


def _accepts_avgpool_count_pad():
    p = nn.SpatialAveragePooling(3, 3, 1, 1, 1, 1, count_include_pad=False)
    torch.testing.assert_close(p.call({}, torch.ones(1, 1, 4, 4)),
                               torch.ones(1, 1, 4, 4))


def _accepts_bn_init_weight():
    bn = nn.SpatialBatchNormalization(8, 1e-5, 0.1, True, np.full(8, 2.0))
    assert float(bn.weight.sum()) == 16.0


@pytest.mark.parametrize("case", [
    _accepts_conv_n_group, _accepts_conv_dilation, _accepts_avgpool_ceil_mode,
    _accepts_avgpool_count_pad, _accepts_bn_init_weight],
    ids=["conv_n_group", "conv_dilation", "avgpool_ceil_mode",
         "avgpool_count_pad", "bn_init_weight"])
def test_layer_parameters_are_accepted(case):
    """Constructors that refused these values until the layer library was
    ported; the layer tests hold each to JAX."""
    case()


@pytest.mark.parametrize("build,where", [
    (lambda r: nn.Linear(4, 3, True, r), ("weight",)),
    (lambda r: nn.Linear(4, 3, True, None, r), ("bias",)),
    (lambda r: nn.Linear(4, 3, False, None, r), ()),
    (lambda r: nn.SpatialConvolution(4, 8, 3, 3, 1, 1, 1, 1, 1, True, r),
     ("weight",)),
    (lambda r: nn.SpatialConvolution(4, 8, 3, 3, b_regularizer=r),
     ("bias",)),
], ids=["linear_w_regularizer", "linear_b_regularizer",
        "linear_b_regularizer_without_bias", "conv_w_regularizer",
        "conv_b_regularizer"])
def test_regularizer_parameters_are_accepted(build, where):
    """The regularizers were refused before they were ported; a positional
    regularizer lands where JAX puts it."""
    from bigdl_tpu_torch.optim import L2Regularizer
    r = L2Regularizer(0.1)
    assert tuple(build(r)._regularizers()) == where


def test_positional_defaults_build_what_they_built():
    conv = nn.SpatialConvolution(4, 8, 3, 3, 1, 1, 1, 1, 1, True)
    assert conv.bias is not None and conv.padding == (1, 1)
    bn = nn.SpatialBatchNormalization(8, 1e-5, 0.1, True, None, None, "NHWC")
    assert bn._channel_axis == -1
    assert nn.Linear(4, 3).name.startswith("Linear")
    assert nn.ReLU(name="act").name == "act"


def test_refuse_unported_passes_defaults_and_names_the_first_change():
    refuse_unported("f", a=(None, None), b=(4, 4), c=((), ()))
    with pytest.raises(NotImplementedError, match=r"f: b=5"):
        refuse_unported("f", a=(None, None), b=(5, 4))
    with pytest.raises(NotImplementedError, match=r"a=0"):
        refuse_unported("f", a=(0, None))


# -- public methods ------------------------------------------------------------

# public JAX methods the port does not have yet, by the JAX class that
# defines them; each name here must really be missing from the port
UNPORTED_METHODS = {
    # by design, no port: Orbax checkpoints (orbax imports jax; ROADMAP A,
    # "Not ported, by design")
    "bigdl_tpu.nn.module.Module": {"load_orbax", "save_orbax"},
}

CLASS_PAIRS = [(k, p, t) for k, p, t in PAIRS if inspect.isclass(p)]


def _is_method(v):
    return inspect.isfunction(v) or inspect.ismethod(v)


def _definer(fn):
    fn = inspect.unwrap(fn)
    return f"{fn.__module__}.{fn.__qualname__.rsplit('.', 1)[0]}"


def _public_methods(cls):
    return [(n, v) for n, v in inspect.getmembers(cls)
            if not n.startswith("_") and _is_method(v)]


def _method_pairs():
    """(id, port method, JAX method) for every public JAX method the port
    defines itself (the port's modules subclass ``torch.nn.Module``; a
    method they inherit from it unchanged, such as ``parameters``, keeps
    torch's signature)."""
    out = []
    for key, port, twin in CLASS_PAIRS:
        for name, jv in _public_methods(twin):
            pv = getattr(port, name, None)
            if not _is_method(pv) \
                    or pv is getattr(torch.nn.Module, name, None):
                continue
            out.append((f"{key}.{name}", pv, jv))
    return out


METHOD_PAIRS = _method_pairs()


def test_the_method_pairs_cover_the_serving_tier():
    ids = {i for i, _, _ in METHOD_PAIRS}
    for want in ("DecodeScheduler.submit", "DecodeScheduler.defrag",
                 "DecodeScheduler.cached_prefix_tokens",
                 "PagedKVCache.fork_blocks", "PagedKVCache.defrag",
                 "PagedKVCache.snapshot_blocks", "PagedKVCache.adopt",
                 "PrefixCache.lookup", "PrefixCache.evict",
                 "KVSwapManager.refill_many", "HostKVPool.alloc",
                 "ModelRegistry.get", "ModelRegistry.versions"):
        assert any(i.endswith(want) for i in ids), want
    assert len(METHOD_PAIRS) >= 150


@pytest.mark.parametrize("key,port,twin", METHOD_PAIRS,
                         ids=[p[0] for p in METHOD_PAIRS])
def test_method_signature_matches_the_jax_twin(key, port, twin):
    test_signature_matches_the_jax_twin(key, port, twin)


@pytest.mark.parametrize("key,port,twin", CLASS_PAIRS,
                         ids=[p[0] for p in CLASS_PAIRS])
def test_every_jax_method_is_ported_or_listed(key, port, twin):
    missing = sorted((name, _definer(jv)) for name, jv in
                     _public_methods(twin) if not hasattr(port, name))
    unlisted = [(n, d) for n, d in missing
                if n not in UNPORTED_METHODS.get(d, ())]
    assert not unlisted, f"public JAX methods missing from the port: " \
                         f"{unlisted}"
    # a listed method the port now has leaves the list
    for name, jv in _public_methods(twin):
        if name in UNPORTED_METHODS.get(_definer(jv), ()):
            assert not hasattr(port, name), f"{name} is ported: unlist it"


# public JAX members of the modules the port mirrors that it does not have
# yet, by module, with the ROADMAP item that ports them
UNPORTED_MEMBERS = {
    # by design, no port: the environment switches (the port has one route
    # per device)
    "parallel.flash": {"flash_mode", "paged_mode"},
    # by design, no port: a trace-time spy (the port counts launches)
    "kernels.paged_attention": {"trace_count"},
    # by design, no port: JAX's key stream (the port passes
    # torch.Generators) and XLA's compilation cache
    "utils.engine": {"next_rng_key", "next_rng_keys",
                     "enable_compilation_cache",
                     "maybe_enable_compilation_cache",
                     "compilation_cache_dir", "compilation_cache_stats",
                     "compilation_cache_entries"},
}
MIRRORED = ["parallel.failure", "parallel.chaos", "observability.metrics",
            "observability.trace", "observability.exporters",
            "observability.flight", "observability.health",
            "observability.cluster", "serving.engine", "serving.router",
            "serving.batching", "optim.predictor", "optim.staging",
            "optim.validation", "optim.evaluator", "optim.regularizer",
            "parallel.elastic", "utils.table", "nn.elementwise",
            "nn.activation", "nn.dropout", "nn.table_ops", "nn.containers",
            "nn.shape_ops", "nn.pool", "nn.conv", "nn.norm", "nn.criterion",
            "nn.init", "models.lenet", "models.vgg", "models.inception",
            "models.autoencoder", "nn.recurrent", "nn.tree_lstm", "nn.linear",
            "models.rnn", "models.textclassifier", "dataset.text",
            "dataset.sentence", "dataset.news20", "dataset.dataset",
            "dataset.transformer", "kernels.flash_attention",
            "kernels.paged_attention", "nn.module", "optim.optimizer",
            "parallel.flash", "utils.engine", "native",
            "transform._vision_impl", "transform.image_frame",
            "transform.vision", "dataset.base", "dataset.imagenet",
            "dataset.mnist", "dataset.cifar", "dataset.tfrecord",
            "parallel.moe", "nn.moe", "models.moe_lm", "utils.directed_graph",
            "nn.graph_container", "nn.dynamic_graph", "nn.sparse",
            "dataset.movielens", "models.recommender", "dataset.datamining",
            "nn.detection", "dataset.segmentation", "parallel.mesh",
            "parallel.collective", "parallel.allreduce", "parallel.sharding",
            "parallel.pipeline", "parallel.ring_attention",
            "parallel.ring_flash", "parallel.seq_all_to_all",
            "parallel.seq_decode", "serving.transport", "serving.fleet",
            "serving.controller", "quantization.quantize",
            "quantization.calibration", "quantization.lm",
            "observability.perf", "utils.shape", "utils.misc", "ops.ops",
            "loaders.wire", "loaders.bigdl_proto", "loaders.caffe",
            "loaders.caffe_persister", "loaders.torchfile",
            "loaders.tensorflow", "loaders.tf_saver", "loaders.tf_session",
            "keras.topology", "keras.layers", "keras.converter",
            "keras.backend", "dlframes.dl_estimator",
            "dlframes.dl_image_reader", "util.common", "util.tf_utils"]
# public JAX members a mirrored module re-exports from a module the port
# does not have yet, with the ROADMAP item that ports them (the member test
# above counts the members a module defines)
UNPORTED_REEXPORTS = {}


@pytest.mark.parametrize("mod", MIRRORED)
def test_every_jax_member_is_ported_or_listed(mod):
    jm = importlib.import_module("bigdl_tpu." + mod)
    pm = importlib.import_module("bigdl_tpu_torch." + mod)
    listed = UNPORTED_MEMBERS.get(mod, set())
    missing = {n for n, v in vars(jm).items()
               if not n.startswith("_")
               and (inspect.isclass(v) or inspect.isfunction(v))
               and v.__module__ == jm.__name__ and not hasattr(pm, n)}
    assert missing == listed
    # what the port has is public: its __all__ names it
    jnames = {n for n, v in vars(jm).items()
              if not n.startswith("_")
              and (inspect.isclass(v) or inspect.isfunction(v))
              and v.__module__ == jm.__name__}
    assert jnames - listed <= set(pm.__all__)
    for n in UNPORTED_REEXPORTS.get(mod, ()):
        assert hasattr(jm, n) and not hasattr(pm, n), n


def test_translation_and_padding_parameters_raise_at_a_non_default_value():
    """Nothing of these constructors is refused any more: the transformer
    chains on data sets this test refused are accepted (``DataSet.array``
    with a transformer), and so are the translation and padding
    parameters (the cases below, one for each)."""
    from bigdl_tpu_torch.dataset import DataSet, FuncTransformer, Sample
    attn = nn.Attention(16, 2)
    x = torch.zeros(1, 3, 16)
    assert [t.shape for t in attn.qkv(attn.params, x)] == [(1, 2, 3, 8)] * 3
    ds = DataSet.array([Sample(np.full(2, i)) for i in range(3)],
                       FuncTransformer(lambda s: s.features[0][0]))
    assert list(ds.data(train=False)) == [0, 1, 2]


# -- translation and padding parameters that were refused and now take values -

def _accepts_cross_block():
    b = nn.TransformerBlock(16, 2, 32, 0.0, 0.0, True)
    assert b.with_cross and b.cross.hidden_size == 16
    assert {"cross", "ln3"} <= set(b.params)


def _accepts_qkv_kx():
    attn = nn.Attention(16, 2)
    q, k, v = attn.qkv(attn.params, torch.zeros(1, 3, 16),
                       torch.zeros(1, 5, 16))
    assert q.shape == (1, 2, 3, 8) and k.shape == v.shape == (1, 2, 5, 8)


def _accepts_feature_padding():
    from bigdl_tpu_torch.dataset import MiniBatch, PaddingParam, Sample
    mb = MiniBatch.from_samples([Sample(np.ones(2)), Sample(np.ones(3))],
                                PaddingParam(-1.0))
    np.testing.assert_array_equal(mb.input, [[1, 1, -1], [1, 1, 1]])


@pytest.mark.parametrize("case", [_accepts_cross_block, _accepts_qkv_kx,
                                  _accepts_feature_padding],
                         ids=["block_with_cross", "qkv_kx",
                              "from_samples_feature_padding"])
def test_translation_and_padding_parameters_are_accepted(case):
    case()


# -- serving parameters that were refused and now take values -----------------

@pytest.mark.parametrize("kw,attr,want", [
    ({"draft_model": "draft"}, "draft_kv", "pool"),
    ({"draft_model": "draft", "spec_k": 2}, "spec_k", 2),
    ({"host_blocks": 8}, "preempt_enabled", True),
    ({"host_blocks": 8, "preempt": False}, "preempt_enabled", False),
    ({"prefix_cache_entries": 3}, "prefix", 3),
    ({"prefix_cache": False}, "prefix", None),
    ({"stall_deadline_s": 1.5}, "stall_deadline_s", 1.5),
    ({"name": "r0"}, "beacon_name", "serving/decode_scheduler[r0]"),
    ({"tags": ["int8"]}, "tags", ("int8",)),
    ({"audit_every": 1}, "audit_every", 1),
    ({"fault_policy": "policy"}, "fault_policy", "policy"),
], ids=["draft_model", "spec_k", "host_blocks", "preempt",
        "prefix_cache_entries", "prefix_cache_off", "stall_deadline_s",
        "name", "tags", "audit_every", "fault_policy"])
def test_serving_parameters_are_accepted(kw, attr, want):
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import DecodeScheduler
    cfg = dict(vocab_size=16, hidden_size=16, num_heads=2, filter_size=32,
               num_layers=1, max_len=64, device="cpu")
    kw = dict(kw)
    if kw.get("draft_model") == "draft":
        kw["draft_model"] = TransformerLM(seed=1, **cfg)
    if kw.get("fault_policy") == "policy":
        from bigdl_tpu_torch.parallel.failure import FaultPolicy
        kw["fault_policy"] = want = FaultPolicy(max_restarts=2)
    ds = DecodeScheduler(TransformerLM(**cfg), max_slots=2, block_size=4,
                         max_seq_len=32, prefill_chunk=8, **kw)
    got = getattr(ds, attr)
    if want == "pool":
        assert got.metric_prefix == "serve/draft_kv"
    elif attr == "prefix" and want is not None:
        assert got.max_entries == want
    else:
        assert got == want
    ds.shutdown()
    from bigdl_tpu_torch.serving import kv_swap_threads_alive
    assert kv_swap_threads_alive() == 0


_NI, _VE = NotImplementedError, ValueError


@pytest.mark.parametrize("call, exc", [
    (lambda q: __import__("bigdl_tpu_torch.kernels.flash_attention",
                          fromlist=["x"]).flash_attention_fused(
        q, q, q, scale=0.5), _NI),
    (lambda q: __import__("bigdl_tpu_torch.kernels.flash_attention",
                          fromlist=["x"]).flash_attention_fused(
        q, q, q, block_q=128), _NI),
    (lambda q: __import__("bigdl_tpu_torch.kernels.flash_attention",
                          fromlist=["x"]).flash_chunk_attention(
        q, q, q, 0, block_k=256), _NI),
    (lambda q: __import__("bigdl_tpu_torch.parallel.mesh",
                          fromlist=["x"]).make_mesh((64,), ("data",),
                                                    devices=[0]), _VE),
    (lambda q: __import__("bigdl_tpu_torch.optim.optimizer",
                          fromlist=["x"]).RemediationPolicy(
        heartbeat="hb", heartbeat_every=0), _VE),
    (lambda q: __import__("bigdl_tpu_torch.optim.optimizer",
                          fromlist=["x"]).RemediationPolicy(
        straggler_monitor="sm", straggler_every=0), _VE),
], ids=["flash_scale", "flash_block_q", "chunk_block_k", "engine_mesh",
        "remediation_heartbeat", "remediation_straggler"])
def test_tile_mesh_and_multi_gpu_parameters_are_refused(call, exc):
    """TPU tile sizes and a scale other than 1/sqrt(D) raise
    ``NotImplementedError`` at a value other than JAX's default; the mesh
    and the remediation's multi-GPU detectors are ported, and refuse what
    JAX's refuse with ``ValueError``: a mesh larger than its ranks, a
    heartbeat or straggler monitor without a cadence."""
    with pytest.raises(exc):
        call(torch.zeros(1, 1, 4, 8))


def test_flash_entries_match_the_jax_kernels_on_the_cpu():
    """``flash_attention_fused`` (forward and gradient) and
    ``flash_chunk_attention`` against JAX's Pallas kernels in interpret
    mode; ``interpret`` is accepted and changes nothing."""
    from bigdl_tpu.kernels import flash_attention as jfa
    from bigdl_tpu_torch.kernels import flash_attention as tfa
    rng = np.random.RandomState(0)
    q, k, v, g = (rng.randn(1, 2, 16, 8).astype(np.float32)
                  for _ in range(4))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = tfa.flash_attention_fused(tq, tk, tv, causal=True,
                                    interpret=True)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention_fused(
            q, k, v, causal=True, block_q=8, block_k=8, interpret=True)
            * g)
    want = jfa.flash_attention_fused(q, k, v, causal=True, block_q=8,
                                     block_k=8, interpret=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **MOD_TOL)
    for got, w in zip(grads, jax.grad(f, (0, 1, 2))(q, k, v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **MOD_TOL)
    kc, vc = (rng.randn(1, 2, 32, 8).astype(np.float32) for _ in range(2))
    qc = rng.randn(1, 2, 4, 8).astype(np.float32)
    got = tfa.flash_chunk_attention(torch.from_numpy(qc),
                                    torch.from_numpy(kc),
                                    torch.from_numpy(vc), 12, kv_len=16)
    want = jfa.flash_chunk_attention(qc, kc, vc, 12, kv_len=16, block_q=8,
                                     block_k=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)


@pytest.mark.parametrize("kw", ["mesh", "placement"],
                         ids=["mesh", "placement"])
def test_scheduler_still_refuses_mesh_serving(kw):
    """Mesh serving is ported; JAX's own refusals stay: a draft model with
    a mesh (speculative decoding is single-device), and ``placement=``
    together with an explicit registry (it would be ignored)."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import DecodeScheduler, ModelRegistry
    cfg = dict(vocab_size=16, hidden_size=16, num_heads=2, filter_size=32,
               num_layers=1, max_len=64, device="cpu")
    lm = TransformerLM(**cfg)
    mesh = make_mesh((1,), ("model",), device="cpu")
    extra = ({"draft_model": TransformerLM(**cfg)} if kw == "mesh" else
             {"placement": "tp", "registry": ModelRegistry(mesh=mesh)})
    with pytest.raises(ValueError, match=("single-device" if kw == "mesh"
                                          else "explicit registry")):
        DecodeScheduler(lm, max_slots=2, block_size=4, max_seq_len=32,
                        prefill_chunk=8, mesh=mesh, **extra)
