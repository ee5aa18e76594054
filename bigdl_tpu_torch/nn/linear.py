"""Dense and affine-family layers (counterpart of
``bigdl_tpu/nn/linear.py``): ``Linear``, ``Bilinear``, ``Cosine``,
``Euclidean``, ``Add``, ``Mul``, ``CMul``, ``CAdd``, ``Scale``,
``Highway`` and ``LookupTable``.

Weights keep the reference layouts and the JAX trees' names (``weight``
(out, in), ``bias``; Highway's ``w_t`` / ``w_h`` / ``b_t`` / ``b_h``) and
are drawn from the JAX package's distributions; the draws differ from
JAX's for the same seed (tests load JAX's weights).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.engine import refuse_unported
from .init import RandomUniform, _uniform
from .module import Module

__all__ = ["Linear", "Bilinear", "Cosine", "Euclidean", "Add", "Mul", "CMul",
           "CAdd", "Scale", "Highway", "LookupTable"]


def _param(*shape):
    return torch.nn.Parameter(torch.empty(*shape))


def _lead_ones(t, ndim):
    """``t`` with ones prepended to its shape up to ``ndim`` dims (JAX's
    broadcast of CMul / CAdd / Scale)."""
    return t.reshape((1,) * (ndim - t.dim()) + tuple(t.shape)) \
        if t.dim() < ndim else t


class Linear(Module):
    """y = x W^T + b with ``weight`` (out, in), the reference layout. Both
    are drawn from ``init_method`` (default U(+-1/sqrt(in))) unless
    ``bias_init_method`` is given for the bias. ``w_regularizer`` /
    ``b_regularizer`` (``optim.regularizer``) add their penalty to the
    training loss; ``init_weight`` / ``init_bias`` are not ported and raise
    at a value other than None."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, init_weight=None, init_bias=None,
                 init_method=None, bias_init_method=None, name=None):
        super().__init__(name=name)
        refuse_unported("Linear", init_weight=(init_weight, None),
                        init_bias=(init_bias, None))
        self.input_size, self.output_size = input_size, output_size
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
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

    def _regularizers(self):
        """{param name: Regularizer} for the training step's penalty."""
        r = {}
        if self.w_regularizer is not None:
            r["weight"] = self.w_regularizer
        if self.b_regularizer is not None and self.bias is not None:
            r["bias"] = self.b_regularizer
        return r

    def call(self, params, x):
        y = x @ params["weight"].T
        if "bias" in params:
            y = y + params["bias"]
        return y


class Bilinear(Module):
    """y_k = x1^T W_k x2 + b_k over a Table(x1, x2) (nn/Bilinear.scala);
    ``weight`` (out, in1, in2) and ``bias`` U(+-1/sqrt(in1)). The
    regularizers are stored and, as in the JAX package, not applied."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, w_regularizer=None,
                 b_regularizer=None, name=None):
        super().__init__(name=name)
        self.input_size1, self.input_size2 = input_size1, input_size2
        self.output_size, self.bias_res = output_size, bias_res
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
        self.weight = _param(output_size, input_size1, input_size2)
        self.bias = _param(output_size) if bias_res else None
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / math.sqrt(self.input_size1)
        dev = self.weight.device
        self.weight.copy_(_uniform(self.weight.shape, stdv, generator, dev))
        if self.bias is not None:
            self.bias.copy_(_uniform(self.bias.shape, stdv, generator, dev))

    def call(self, params, x):
        y = torch.einsum("bi,oij,bj->bo", x[1], params["weight"], x[2])
        if self.bias_res:
            y = y + params["bias"]
        return y


class Cosine(Module):
    """Cosine similarity to each of ``output_size`` weight rows
    (nn/Cosine.scala): ``x / (|x| + 1e-12)`` against the rows normalised
    the same way. |x| is ``sqrt(sum(x * x))`` written out, as
    ``jnp.linalg.norm`` computes it, so a zero row's gradient is JAX's NaN
    (``torch.linalg.vector_norm`` would give 0 there; ROADMAP C, reference
    caveats)."""

    def __init__(self, input_size: int, output_size: int, name=None):
        super().__init__(name=name)
        self.input_size, self.output_size = input_size, output_size
        self.weight = _param(output_size, input_size)
        self.reset()

    def _reset(self, generator):
        self.weight.copy_(_uniform(self.weight.shape,
                                   1.0 / math.sqrt(self.input_size),
                                   generator, self.weight.device))

    @staticmethod
    def _unit(v):
        return v / (torch.sqrt((v * v).sum(-1, keepdim=True)) + 1e-12)

    def call(self, params, x):
        return self._unit(x) @ self._unit(params["weight"]).T


class Euclidean(Module):
    """Distance to each weight row, ``sqrt(sum (x - w)^2 + 1e-12)``
    (nn/Euclidean.scala). ``fast_backward`` is accepted and ignored, as in
    the JAX package."""

    def __init__(self, input_size: int, output_size: int, fast_backward=True,
                 name=None):
        super().__init__(name=name)
        self.input_size, self.output_size = input_size, output_size
        self.weight = _param(output_size, input_size)
        self.reset()

    def _reset(self, generator):
        self.weight.copy_(_uniform(self.weight.shape,
                                   1.0 / math.sqrt(self.input_size),
                                   generator, self.weight.device))

    def call(self, params, x):
        diff = x[..., None, :] - params["weight"]
        return torch.sqrt((diff * diff).sum(-1) + 1e-12)


class Add(Module):
    """A learnable bias vector added (nn/Add.scala), U(+-1/sqrt(size))."""

    def __init__(self, input_size: int, name=None):
        super().__init__(name=name)
        self.input_size = input_size
        self.bias = _param(input_size)
        self.reset()

    def _reset(self, generator):
        self.bias.copy_(_uniform(self.bias.shape,
                                 1.0 / math.sqrt(self.input_size),
                                 generator, self.bias.device))

    def call(self, params, x):
        return x + params["bias"]


class Mul(Module):
    """One learnable scalar multiply (nn/Mul.scala), U(-1, 1)."""

    def __init__(self, name=None):
        super().__init__(name=name)
        self.weight = _param(1)
        self.reset()

    def _reset(self, generator):
        self.weight.copy_(_uniform((1,), 1.0, generator, self.weight.device))

    def call(self, params, x):
        return x * params["weight"][0]


class CMul(Module):
    """Componentwise learnable multiply by a ``size`` weight, broadcast by
    prepending ones to its shape (nn/CMul.scala)."""

    def __init__(self, size, name=None):
        super().__init__(name=name)
        self.size = tuple(size)
        self.weight = _param(*self.size)
        self.reset()

    def _reset(self, generator):
        self.weight.copy_(_uniform(self.size,
                                   1.0 / math.sqrt(math.prod(self.size)),
                                   generator, self.weight.device))

    def call(self, params, x):
        return x * _lead_ones(params["weight"], x.dim())


class CAdd(Module):
    """Componentwise learnable add of a ``size`` bias, broadcast as CMul's
    weight (nn/CAdd.scala)."""

    def __init__(self, size, name=None):
        super().__init__(name=name)
        self.size = tuple(size)
        self.bias = _param(*self.size)
        self.reset()

    def _reset(self, generator):
        self.bias.copy_(_uniform(self.size,
                                 1.0 / math.sqrt(math.prod(self.size)),
                                 generator, self.bias.device))

    def call(self, params, x):
        return x + _lead_ones(params["bias"], x.dim())


class Scale(Module):
    """CMul then CAdd (nn/Scale.scala)."""

    def __init__(self, size, name=None):
        super().__init__(name=name)
        self.size = tuple(size)
        self.weight = _param(*self.size)
        self.bias = _param(*self.size)
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / math.sqrt(math.prod(self.size))
        dev = self.weight.device
        self.weight.copy_(_uniform(self.size, stdv, generator, dev))
        self.bias.copy_(_uniform(self.size, stdv, generator, dev))

    def call(self, params, x):
        return x * _lead_ones(params["weight"], x.dim()) \
            + _lead_ones(params["bias"], x.dim())


_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu,
                "sigmoid": torch.sigmoid, None: lambda v: v}


class Highway(Module):
    """Highway layer (nn/Highway.scala): ``t * act(x w_h^T + b_h) + (1 - t)
    * x`` with the gate ``t = sigmoid(x w_t^T + b_t)``; ``b_t`` starts at
    -2 (toward carrying x). ``activation`` is "tanh", "relu", "sigmoid",
    None (identity) or a callable on tensors."""

    def __init__(self, size: int, with_bias: bool = True, activation="tanh",
                 name=None):
        super().__init__(name=name)
        self.size, self.with_bias = size, with_bias
        self.activation = activation
        self.w_t = _param(size, size)
        self.w_h = _param(size, size)
        self.b_t = _param(size) if with_bias else None
        self.b_h = _param(size) if with_bias else None
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / math.sqrt(self.size)
        dev = self.w_t.device
        for w in (self.w_t, self.w_h):
            w.copy_(_uniform(w.shape, stdv, generator, dev))
        if self.with_bias:
            self.b_t.fill_(-2.0)
            self.b_h.copy_(_uniform(self.b_h.shape, stdv, generator, dev))

    def call(self, params, x):
        t = x @ params["w_t"].T
        h = x @ params["w_h"].T
        if self.with_bias:
            t, h = t + params["b_t"], h + params["b_h"]
        t = torch.sigmoid(t)
        act = self.activation if callable(self.activation) \
            else _ACTIVATIONS[self.activation]
        return t * act(h) + (1.0 - t) * x


class LookupTable(Module):
    """Embedding lookup (nn/LookupTable.scala), ``weight`` (n_index,
    n_output) N(0, 1). Ids are 1-based and truncated to integers; an id
    out of [1, n_index] is clamped, not refused, as JAX's ``jnp.clip``
    does, so its row (and gradient) is row 1 or row n_index. A finite
    ``max_norm`` rescales every row to at most that ``norm_type`` norm on
    the fly, differentiably (``w * min(1, max_norm / (|w| + 1e-12))``; the
    stored weight is not touched, unlike ``F.embedding(max_norm=)``).
    ``mask_zero`` zeroes the outputs of ids equal to ``padding_value``.
    ``should_scale_grad_by_freq`` is accepted and ignored, as in the JAX
    package; ``w_regularizer`` adds its penalty to the training loss."""

    def __init__(self, n_index: int, n_output: int, padding_value: float = 0,
                 max_norm: float = np.inf, norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False, w_regularizer=None,
                 mask_zero: bool = False, name=None):
        super().__init__(name=name)
        self.n_index, self.n_output = n_index, n_output
        self.padding_value = padding_value
        self.max_norm, self.norm_type = max_norm, norm_type
        self.mask_zero = mask_zero
        self.w_regularizer = w_regularizer
        self.weight = _param(n_index, n_output)
        self.reset()

    def _reset(self, generator):
        self.weight.normal_(0.0, 1.0, generator=generator)

    def _regularizers(self):
        """{param name: Regularizer} for the training step's penalty."""
        return {"weight": self.w_regularizer} if self.w_regularizer else {}

    def call(self, params, x):
        w = params["weight"]
        if np.isfinite(self.max_norm):
            norms = torch.linalg.vector_norm(w, self.norm_type, dim=1,
                                             keepdim=True)
            w = w * torch.clamp(self.max_norm / (norms + 1e-12), max=1.0)
        idx = (x.long() - 1).clamp(0, self.n_index - 1)
        out = F.embedding(idx, w)
        if self.mask_zero:
            out = out * (x != self.padding_value).to(out.dtype)[..., None]
        return out
