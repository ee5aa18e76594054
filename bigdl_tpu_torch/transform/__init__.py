"""Vision transforms and the image frame (counterpart of
``bigdl_tpu/transform``)."""
from . import vision
from .image_frame import ImageFrame, LocalImageFrame, MTImageFeatureToBatch

__all__ = ["vision", "ImageFrame", "LocalImageFrame",
           "MTImageFeatureToBatch"]
