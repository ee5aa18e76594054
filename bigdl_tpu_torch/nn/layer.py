"""``bigdl_tpu_torch.nn.layer``: the pyspark module path of every layer
(counterpart of ``bigdl_tpu/nn/layer.py``), so ``from bigdl.nn.layer
import Linear, Sequential`` ports with the package rename alone; the
layers live in the ``nn`` modules and are exported by the package."""
from . import __all__  # noqa: F401
from . import *  # noqa: F401,F403
