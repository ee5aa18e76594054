"""``bigdl_tpu_torch.nn.initialization_method``: the pyspark module path of
the initialisation methods (counterpart of
``bigdl_tpu/nn/initialization_method.py``); they live in ``nn.init``."""
from .init import *  # noqa: F401,F403
from .init import __all__  # noqa: F401
