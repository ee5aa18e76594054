"""``bigdl_tpu_torch.nn.keras.topology``: the pyspark module path of the
Keras-style Sequential/Model (implementation:
``bigdl_tpu_torch.keras.topology``)."""
from ...keras import topology as _topology

from bigdl_tpu_torch.util._parity import public_names as _public_names

__all__ = _public_names(_topology)
globals().update({n: getattr(_topology, n) for n in __all__})
