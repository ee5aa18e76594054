"""``bigdl_tpu_torch.transform.vision`` — the reference's package path
(``bigdl/transform/vision/``); the implementation lives in
``transform/_vision_impl.py``."""
from ...dataset.transformer import Transformer
from .._vision_impl import (AspectScale, Brightness, CenterCrop,
                            ChannelNormalize, ChannelOrder,
                            ChannelScaledNormalizer, ColorJitter, Contrast,
                            Crop, Expand, FeatureTransformer, Filler, HFlip,
                            Hue, ImageFeature, ImageFrameToSample, Lighting,
                            MatToTensor, PixelNormalizer, RandomAlterAspect,
                            RandomCrop, RandomCropper, RandomFlip,
                            RandomResize, RandomResizedCrop,
                            RandomTransformer, Resize, Saturation)

__all__ = ["AspectScale", "Brightness", "CenterCrop", "ChannelNormalize",
           "ChannelOrder", "ChannelScaledNormalizer", "ColorJitter",
           "Contrast", "Crop", "Expand", "FeatureTransformer", "Filler",
           "HFlip", "Hue", "ImageFeature", "ImageFrameToSample", "Lighting",
           "MatToTensor", "PixelNormalizer", "RandomAlterAspect",
           "RandomCrop", "RandomCropper", "RandomFlip", "RandomResize",
           "RandomResizedCrop", "RandomTransformer", "Resize", "Saturation",
           "Transformer"]
