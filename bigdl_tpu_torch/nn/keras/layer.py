"""``bigdl_tpu_torch.nn.keras.layer``: the pyspark module path of the
Keras-style layers (implementation: ``bigdl_tpu_torch.keras.layers``)."""
from ...keras import layers as _layers

from bigdl_tpu_torch.util._parity import public_names as _public_names

__all__ = _public_names(_layers)
globals().update({n: getattr(_layers, n) for n in __all__})

# the reference keeps Input/InputLayer in nn/keras/layer.py; ours live
# with the topology - re-export for path parity
from ...keras.topology import Input, InputLayer  # noqa: E402,F401

__all__ += ["Input", "InputLayer"]
