"""bigdl_tpu_torch: the PyTorch / CUDA port of bigdl_tpu for NVIDIA Hopper.

This slice covers the TransformerLM serving path: the model
(``models.TransformerLM``), cached generation (``Transformer.generate``)
and continuous-batching serving over a paged KV cache
(``serving.DecodeScheduler``), with hand-written CUDA kernels for flash
attention and paged attention (``kernels``). Entry points run on a CUDA
device unless the caller passes ``device='cpu'``. The package imports
neither JAX nor bigdl_tpu.
"""
