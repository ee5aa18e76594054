"""Int8 post-training quantization and weight-only int8 / int4 LM
weights (counterpart of ``bigdl_tpu/quantization``)."""
from .quantize import (quantize, QuantizedLinear, QuantizedSpatialConvolution,
                       quantize_weight)
from .calibration import (calibrate, fold_batchnorm, quantizable_paths,
                          Observer, MinMaxObserver, MovingAverageObserver,
                          PercentileObserver)
from .lm import (QuantizedWeight, QuantizedWeightInt4, quantize_lm_params,
                 quantize_weight_int8, quantize_weight_int4,
                 lm_quantized_bytes)

__all__ = ["quantize", "QuantizedLinear", "QuantizedSpatialConvolution",
           "quantize_weight", "calibrate", "fold_batchnorm",
           "quantizable_paths", "Observer", "MinMaxObserver",
           "MovingAverageObserver", "PercentileObserver", "QuantizedWeight",
           "QuantizedWeightInt4", "quantize_lm_params",
           "quantize_weight_int8", "quantize_weight_int4",
           "lm_quantized_bytes"]
