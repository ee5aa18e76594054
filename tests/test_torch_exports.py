"""Every package's exported names in the port against the JAX package's
(ROADMAP C.9): ``from bigdl_tpu.<pkg> import X`` works in the port as
``from bigdl_tpu_torch.<pkg> import X`` for every public name a JAX
package exports (its submodules aside), except the names still to port,
listed below by their ROADMAP item. A listed name the port now has must
leave the list. The member test of ``test_torch_signatures.py`` counts
only what a module defines, so it cannot see a missing re-export; this
one can.
"""
import importlib
import types

import pytest

PACKAGES = ["", "nn", "optim", "dataset", "models", "parallel", "serving",
            "kernels", "utils", "observability", "transform",
            "visualization", "native", "quantization", "ops", "loaders",
            "keras", "nn.keras", "dlframes", "util"]

# public names of JAX's packages the port does not export yet, by package,
# with the ROADMAP item that ports them
UNPORTED = {}


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("pkg", PACKAGES, ids=[p or "root" for p in PACKAGES])
def test_every_jax_export_is_exported_or_listed(pkg):
    suffix = "." + pkg if pkg else ""
    jm = importlib.import_module("bigdl_tpu" + suffix)
    pm = importlib.import_module("bigdl_tpu_torch" + suffix)
    missing = {n for n in _public(jm) if not hasattr(pm, n)}
    assert missing == UNPORTED.get(pkg, set())


@pytest.mark.parametrize("pkg,name", [
    ("optim", "Predictor"), ("optim", "PredictionService"),
    ("optim", "TrainSummary"), ("optim", "ValidationSummary"),
    ("optim", "ActivityRegularization"), ("nn", "Layer"),
    ("nn", "flash_attention"), ("dataset", "IdentityTransformer"),
    ("models", "ShortcutType"), ("parallel", "ChaosError"),
    ("parallel", "ChaosPlan"), ("serving", "TransientDeviceError"),
    ("serving", "THREAD_NAME"), ("kernels", "flash_attention_fused"),
    ("", "Table"), ("", "T"), ("utils", "Table"), ("utils", "T")])
def test_the_repaired_reexports_are_the_port_s_own_objects(pkg, name):
    """Each re-export C.9 added is the object the port defines in its
    submodule (the JAX package's aliases, kept)."""
    suffix = "." + pkg if pkg else ""
    got = getattr(importlib.import_module("bigdl_tpu_torch" + suffix), name)
    want = {
        "Predictor": "optim.predictor", "PredictionService": "optim.predictor",
        "TrainSummary": "visualization.summary",
        "ValidationSummary": "visualization.summary",
        "ActivityRegularization": "nn.criterion", "Layer": "nn.module",
        "flash_attention": "parallel.flash",
        "IdentityTransformer": "dataset.transformer",
        "ShortcutType": "models.resnet", "ChaosError": "parallel.chaos",
        "ChaosPlan": "parallel.chaos",
        "TransientDeviceError": "parallel.failure",
        "THREAD_NAME": "serving.engine",
        "flash_attention_fused": "kernels.flash_attention",
        "Table": "utils.table", "T": "utils.table"}[name]
    attr = {"Layer": "Module", "IdentityTransformer": "Identity"}.get(name,
                                                                     name)
    assert got is getattr(importlib.import_module("bigdl_tpu_torch." + want),
                          attr)


@pytest.mark.parametrize("pkg", PACKAGES, ids=[p or "root" for p in PACKAGES])
def test_the_listed_names_are_really_missing(pkg):
    suffix = "." + pkg if pkg else ""
    pm = importlib.import_module("bigdl_tpu_torch" + suffix)
    jm = importlib.import_module("bigdl_tpu" + suffix)
    for n in UNPORTED.get(pkg, set()):
        assert hasattr(jm, n) and not hasattr(pm, n), n
