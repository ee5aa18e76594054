"""bigdl_tpu_torch: the PyTorch / CUDA port of bigdl_tpu for NVIDIA Hopper.

It covers the flagship TransformerLM: serving - the model
(``models.TransformerLM``), cached generation (``Transformer.generate``)
and continuous-batching serving over a paged KV cache
(``serving.DecodeScheduler``), beam search and the encoder-decoder
translation mode (``nn.Transformer``) - and training - the differentiable
model, ``models.lm_loss_chunked``, criteria (``nn``), optim methods,
triggers, validation and the ``LocalOptimizer`` loop (``optim``) over
``dataset`` (padded ``Table`` batches too) - with
hand-written CUDA kernels for flash attention forward and backward and
paged attention (``kernels``). Entry points run on a CUDA device unless
the caller passes ``device='cpu'``. The package imports neither JAX nor
bigdl_tpu.
"""
from .utils import T, Table, Shape  # noqa: E402,F401

__all__ = ["Table", "T", "Shape"]
