"""``bigdl_tpu_torch.nn.keras``: the pyspark package path (reference
``bigdl/nn/keras/``; counterpart of ``bigdl_tpu/nn/keras/``); the
Keras-style API lives in ``bigdl_tpu_torch.keras``."""
