"""``bigdl_tpu_torch.dlframes.dl_image_transformer``: the pyspark module
path (reference ``bigdl/dlframes/dl_image_transformer.py``)."""
from .dl_image_reader import DLImageTransformer  # noqa

__all__ = ["DLImageTransformer"]
