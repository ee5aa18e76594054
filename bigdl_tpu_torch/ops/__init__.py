"""TF-style operation layer (counterpart of ``bigdl_tpu/ops``; parity:
reference ``nn/ops/*.scala`` ~70 ops + ``nn/tf/*.scala``).

Each op is a small ``Module`` whose forward is a few eager PyTorch
expressions. Multi-input ops take a Table/list input (same convention as
``CAddTable``). Feature-column ops that are inherently host-side string
processing (CategoricalColVocaList, CrossCol, MkString, Substr) run on numpy
object arrays, mirroring how the reference runs them on the Spark driver
side.
"""
from .ops import *  # noqa: F401,F403
from .ops import __all__  # noqa: F401
