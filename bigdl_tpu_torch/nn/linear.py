"""Dense layers (counterpart of ``bigdl_tpu/nn/linear.py``; the ResNet
slice ports ``Linear``)."""
from __future__ import annotations

import torch

from ..utils.engine import refuse_unported
from .init import RandomUniform
from .module import Module


class Linear(Module):
    """y = x W^T + b with ``weight`` (out, in), the reference layout. Both
    are drawn from ``init_method`` (default U(+-1/sqrt(in))) unless
    ``bias_init_method`` is given for the bias. The regularizers and
    ``init_weight`` / ``init_bias`` are not ported and raise at a value
    other than None."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, init_weight=None, init_bias=None,
                 init_method=None, bias_init_method=None, name=None):
        super().__init__(name=name)
        refuse_unported("Linear", w_regularizer=(w_regularizer, None),
                        b_regularizer=(b_regularizer, None),
                        init_weight=(init_weight, None),
                        init_bias=(init_bias, None))
        self.input_size, self.output_size = input_size, output_size
        self.init_method = init_method or RandomUniform()
        self.bias_init_method = bias_init_method
        self.weight = torch.nn.Parameter(
            torch.empty(output_size, input_size))
        self.bias = (torch.nn.Parameter(torch.empty(output_size))
                     if with_bias else None)
        self.reset()

    def _reset(self, generator):
        fans = dict(fan_in=self.input_size, fan_out=self.output_size,
                    generator=generator, device=self.weight.device)
        self.weight.copy_(self.init_method(self.weight.shape, **fans))
        if self.bias is not None:
            init = self.bias_init_method or self.init_method
            self.bias.copy_(init(self.bias.shape, **fans))

    def call(self, params, x):
        y = x @ params["weight"].T
        if "bias" in params:
            y = y + params["bias"]
        return y
