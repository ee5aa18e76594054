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
# JAX's BIGDL_TPU_FUSED_CONV2 environment switch as a keyword
PORT_SWITCHES = {("ResNet", "fused_conv2"), ("FusedBottleneck", "fused_conv2")}


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


@pytest.mark.parametrize("build", [
    lambda: nn.SpatialConvolution(4, 8, 3, 3, 1, 1, 1, 1, 2),      # n_group
    lambda: nn.SpatialConvolution(4, 8, 3, 3, dilation_w=2),
    lambda: nn.Linear(4, 3, True, "l2"),                        # w_regularizer
    lambda: nn.Linear(4, 3, True, None, None, np.ones((3, 4))),  # init_weight
    lambda: nn.SpatialAveragePooling(7, 7, 1, 1, 0, 0, True, True),  # ceil
    lambda: nn.SpatialAveragePooling(7, 7, global_pooling=True,
                                     count_include_pad=False),
    lambda: nn.SpatialBatchNormalization(8, 1e-5, 0.1, True, np.ones(8)),
    lambda: nn.TransformerBlock(16, 2, 32, 0.0, 0.0, True),        # with_cross
    lambda: nn.Attention(16, 2, 0.0, True, "seq"),                 # seq_axis
], ids=["conv_n_group", "conv_dilation", "linear_w_regularizer",
        "linear_init_weight", "avgpool_ceil_mode", "avgpool_count_pad",
        "bn_init_weight", "block_with_cross", "attention_seq_axis"])
def test_unported_parameters_raise_at_a_non_default_value(build):
    with pytest.raises(NotImplementedError):
        build()


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
