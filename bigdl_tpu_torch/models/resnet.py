"""ResNet (counterpart of ``bigdl_tpu/models/resnet.py``).

This slice ports the ImageNet family's ``fused="pallas"`` NHWC arm, the
repository's headline training model: the 7x7 stem (``stem="conv7"``),
BatchNorm, ReLU, the 3x3/2 max pool with exact gradients, then stages of
:class:`FusedBottleneck` blocks chained by :class:`FusedBottleneckChain`
(the cross-layer junction kernel is always on, as it is by default in the
JAX package), global average pooling, ``View`` and ``Linear``. Every 1x1
conv runs through K3 (``kernels.fused_bn_relu_matmul_nhwc``), every
junction through K5 (``kernels.fused_residual_matmul_nhwc``) and, with
``fused_conv2=True`` (the JAX package's ``BIGDL_TPU_FUSED_CONV2=1``), every
3x3 conv through K4 (``kernels.fused_bn_relu_conv3x3``); on the CPU these
are the kernels' plain versions.

Not ported yet (they raise): ``fused="xla"`` and ``fused="none"`` (which
need ``ConcatTable``, ``CAddTable`` and ``Identity``), the NCHW format,
``stem="s2d"`` (``SpaceToDepthStem``), ``pool_grad="fast"``, the CIFAR
family, ``with_log_softmax``, shortcut types A and C, and the chain-off
control arm. The JAX package's TPU tuning knobs (block sizes, the
flattened layout, VMEM fitting) have no counterpart.

Parameter and state trees keep the JAX names and layouts: Sequential
indices, chain blocks under ``"0"``, ``"1"``, ...; the stem weight OIHW;
each block's ``w1``/``w2``/``w3``/``proj_w`` HWIO with ``bn1``/``bn2``/
``bn3``/``proj_bn`` (``weight``, ``bias``; state ``running_mean``,
``running_var``), so ``convert.jax_to_state_dict`` carries JAX weights
across by name.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import (fused_bn_relu_conv3x3, fused_bn_relu_matmul_nhwc,
                       fused_residual_matmul_nhwc)
from ..nn import (Linear, ReLU, Sequential, SpatialAveragePooling,
                  SpatialBatchNormalization, SpatialConvolution,
                  SpatialMaxPooling, View)
from ..nn.init import MsraFiller
from ..nn.module import Module
from ..utils.engine import refuse_unported, resolve_device


def _max0(u):
    """max(u, 0) with the JAX package's ``jnp.maximum(u, 0)`` gradient:
    half the gradient where u == 0 exactly (``torch.relu`` passes none).
    Ties are everywhere at initialisation, where the zero-initialised BN3
    gamma makes u = shortcut, itself the output of a ReLU."""
    return torch.maximum(u, u.new_zeros(()))


class _BN(Module):
    """One BatchNorm of a fused bottleneck, applied by the block itself
    through the kernels' statistics: params ``weight``/``bias``, state
    ``running_mean``/``running_var``."""

    def __init__(self, n: int, zero_gamma: bool = False):
        super().__init__()
        self.zero_gamma = zero_gamma
        self.weight = torch.nn.Parameter(torch.empty(n))
        self.bias = torch.nn.Parameter(torch.empty(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self.reset()

    def _reset(self, generator):
        self.weight.fill_(0.0 if self.zero_gamma else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class FusedBottleneck(Module):
    """NHWC bottleneck (1x1 reduce, 3x3 with the stride - v1.5 placement -,
    1x1 expand, shortcut B) whose 1x1 convs run through K3 with the
    previous BatchNorm's affine + ReLU as the prologue and the next
    BatchNorm's batch statistics from the epilogue; with ``fused_conv2``
    the 3x3 conv runs through K4 the same way, otherwise BN1 + ReLU is one
    elementwise pass, the conv is ``F.conv2d`` on the channels-last view
    and BN2's statistics are two reductions (as in the JAX package).

    BatchNorm statistics here are the unshifted ``s2 / m - mean^2`` from
    the kernels' sums (the JAX package's ``_bn_affine``); each affine
    ``(a, b)`` is computed in float32 and rounded to the activations'
    dtype before it reaches a kernel. ``kernel`` other than JAX's default
    'pallas' (the XLA-fused arm) is not ported; ``fused_conv2`` is the
    keyword form of JAX's ``BIGDL_TPU_FUSED_CONV2`` switch (the port reads
    no environment)."""

    def __init__(self, nin: int, nmid: int, stride: int = 1,
                 expansion: int = 4, zero_init_residual: bool = False,
                 eps: float = 1e-5, momentum: float = 0.1,
                 kernel: str = "pallas", name=None,
                 fused_conv2: bool = False):
        super().__init__(name=name)
        refuse_unported("FusedBottleneck", kernel=(kernel, "pallas"))
        self.nin, self.nmid, self.stride = nin, nmid, stride
        self.nout = nmid * expansion
        self.eps, self.momentum = eps, momentum
        self.fused_conv2 = fused_conv2
        self.project = nin != self.nout or stride != 1
        self.w1 = torch.nn.Parameter(torch.empty(1, 1, nin, nmid))
        self.w2 = torch.nn.Parameter(torch.empty(3, 3, nmid, nmid))
        self.w3 = torch.nn.Parameter(torch.empty(1, 1, nmid, self.nout))
        self.bn1 = _BN(nmid)
        self.bn2 = _BN(nmid)
        self.bn3 = _BN(self.nout, zero_init_residual)
        if self.project:
            self.proj_w = torch.nn.Parameter(
                torch.empty(1, 1, nin, self.nout))
            self.proj_bn = _BN(self.nout)
        self.reset()

    def _reset(self, generator):
        msra = MsraFiller(False)
        for name in ("w1", "w2", "w3", "proj_w"):
            p = self._parameters.get(name)
            if p is None:
                continue
            kh, kw, cin, cout = p.shape
            # drawn OIHW so the std matches the unfused convs (fan-in
            # cin * kh * kw), stored HWIO
            w = msra((cout, cin, kh, kw), fan_in=cin * kh * kw,
                     fan_out=cout * kh * kw, generator=generator,
                     device=p.device)
            p.copy_(w.permute(2, 3, 1, 0))

    def _bn_affine(self, params, state, key, s1, s2, m, training):
        """Batch (training) or running statistics -> the per-channel
        float32 affine (a, b), and the new running statistics."""
        g = params[key]["weight"].float()
        beta = params[key]["bias"].float()
        st = state[key]
        if training:
            mean = s1 / m
            var = torch.clamp(s2 / m - mean * mean, min=0.0)
            unbiased = var * m / max(m - 1, 1)
            mo = self.momentum
            new = {"running_mean": ((1 - mo) * st["running_mean"]
                                    + mo * mean).detach(),
                   "running_var": ((1 - mo) * st["running_var"]
                                   + mo * unbiased).detach()}
        else:
            mean = st["running_mean"].float()
            var = st["running_var"].float()
            new = st
        a = g * torch.rsqrt(var + self.eps)
        return a, beta - mean * a, new

    def _conv1(self, params, x, training):
        """Block entry: the 1x1 reduce conv (+ BN1's statistics)."""
        w1 = params["w1"].reshape(self.nin, self.nmid).to(x.dtype)
        return fused_bn_relu_matmul_nhwc(x, w1, None, None, relu=False,
                                         stats=training)

    def _body(self, params, state, z1, s11, s12, x_short, training):
        """From conv1's output to ``(z3, a3, b3, short, new_state)``: what
        block n contributes to ``out = relu(z3 * a3 + b3 + short)``, split
        out so :class:`FusedBottleneckChain` can fuse that epilogue with
        the next block's conv1."""
        B, H, W, _ = z1.shape
        dt = z1.dtype
        new_state = {}
        a1, b1, new_state["bn1"] = self._bn_affine(
            params, state, "bn1", s11, s12, B * H * W, training)
        w2 = params["w2"].to(dt)
        if self.fused_conv2:
            z2, s21, s22 = fused_bn_relu_conv3x3(
                z1, w2, a1.to(dt), b1.to(dt), stride=self.stride,
                stats=training)
        else:
            xh1 = _max0(z1 * a1.to(dt) + b1.to(dt))
            # explicit padding 1 (not SAME, whose stride-2 taps differ)
            z2 = F.conv2d(xh1.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1),
                          stride=self.stride, padding=1).permute(0, 2, 3, 1)
            s21 = s22 = None
            if training:
                z2f = z2.float()
                s21 = z2f.sum((0, 1, 2))
                s22 = (z2f * z2f).sum((0, 1, 2))
        m2 = B * z2.shape[1] * z2.shape[2]
        a2, b2, new_state["bn2"] = self._bn_affine(
            params, state, "bn2", s21, s22, m2, training)
        w3 = params["w3"].reshape(self.nmid, self.nout).to(dt)
        z3, s31, s32 = fused_bn_relu_matmul_nhwc(
            z2, w3, a2.to(dt), b2.to(dt), relu=True, stats=training)
        a3, b3, new_state["bn3"] = self._bn_affine(
            params, state, "bn3", s31, s32, m2, training)
        if self.project:
            # the strided shortcut (every stride-th pixel) is gathered by
            # the reshape into the kernel's rows, as XLA materialises the
            # slice before the Pallas call
            xs = x_short[:, ::self.stride, ::self.stride, :]
            wp = params["proj_w"].reshape(self.nin, self.nout).to(dt)
            zp, sp1, sp2 = fused_bn_relu_matmul_nhwc(
                xs, wp, None, None, relu=False, stats=training)
            ap, bp, new_state["proj_bn"] = self._bn_affine(
                params, state, "proj_bn", sp1, sp2, m2, training)
            short = zp * ap.to(dt) + bp.to(dt)
        else:
            short = x_short
        return z3, a3, b3, short, new_state

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        z1, s11, s12 = self._conv1(params, x, training)
        z3, a3, b3, short, new_state = self._body(
            params, state, z1, s11, s12, x, training)
        dt = x.dtype
        # BN3 + residual + ReLU: one elementwise pass in x's dtype
        return _max0(z3 * a3.to(dt) + b3.to(dt) + short), new_state


class FusedBottleneckChain(Module):
    """A stage of :class:`FusedBottleneck` blocks whose identity junctions
    run through K5: block n's epilogue ``relu(z3 * a3 + b3 + short)`` and
    block n+1's 1x1 reduce conv in one kernel that writes the junction
    once. The stage's first block (projecting or striding) keeps its
    plain entry; the last block's epilogue is an elementwise pass."""

    def __init__(self, blocks, name=None):
        super().__init__(name=name)
        if not blocks:
            raise ValueError("empty chain")
        for blk in blocks[1:]:
            if blk.project or blk.stride != 1:
                raise ValueError("chained junctions need identity "
                                 "shortcuts")
        for i, blk in enumerate(blocks):
            self.add_module(str(i), blk)
        self.blocks = tuple(blocks)

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        dt = x.dtype
        new_state = {}
        blk = self.blocks[0]
        z1, s11, s12 = blk._conv1(params["0"], x, training)
        z3, a3, b3, short, new_state["0"] = blk._body(
            params["0"], state["0"], z1, s11, s12, x, training)
        for i in range(1, len(self.blocks)):
            nxt, key = self.blocks[i], str(i)
            w1n = params[key]["w1"].reshape(nxt.nin, nxt.nmid).to(dt)
            out, z1, s11, s12 = fused_residual_matmul_nhwc(
                z3, short, w1n, a3.to(dt), b3.to(dt), stats=training)
            z3, a3, b3, short, new_state[key] = nxt._body(
                params[key], state[key], z1, s11, s12, out, training)
        return _max0(z3 * a3.to(dt) + b3.to(dt) + short), new_state


_IMAGENET_CFG = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def ResNet(class_num: int = 1000, depth: int = 50, shortcut_type: str = "B",
           data_set: str = "ImageNet", zero_init_residual: bool = True,
           with_log_softmax: bool = False, format: str = "NCHW",
           stem: str = "conv7", pool_grad: str = "exact",
           fused: str = "none", fused_conv2: bool = False, device=None,
           seed: int = 0):
    """The JAX package's factory (the reference's ``ResNet(classNum,
    opt)``), for the ported arm: ``format="NHWC", fused="pallas"`` over the
    ImageNet depths 50, 101 and 152. ``fused_conv2`` routes the 3x3 convs
    through K4. The model is built on ``device`` (the CUDA device by
    default, which raises without one; ``'cpu'`` for the CPU) with weights
    drawn from a generator seeded with ``seed``."""
    unported = {
        "data_set": (data_set.lower(), "imagenet"),
        "fused": (fused, "pallas"), "format": (format, "NHWC"),
        "stem": (stem, "conv7"), "pool_grad": (pool_grad, "exact"),
        "shortcut_type": (shortcut_type, "B"),
        "with_log_softmax": (with_log_softmax, False)}
    for name, (got, ported) in unported.items():
        if got != ported:
            raise NotImplementedError(
                f"ResNet({name}={got!r}) is not ported; the port builds "
                f"format='NHWC', fused='pallas' ImageNet ResNets")
    if depth not in _IMAGENET_CFG:
        raise ValueError(f"ImageNet ResNet depth must be one of "
                         f"{sorted(_IMAGENET_CFG)}, got {depth}")
    dev = resolve_device(device)
    model = Sequential(
        SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, with_bias=False,
                           init_method=MsraFiller(False), format="NHWC"),
        SpatialBatchNormalization(64, data_format="NHWC"), ReLU(),
        SpatialMaxPooling(3, 3, 2, 2, 1, 1, format="NHWC",
                          grad_mode=pool_grad))
    nin = 64
    for stage, n_blocks in enumerate(_IMAGENET_CFG[depth]):
        nmid = 64 * 2 ** stage
        blocks = []
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            blocks.append(FusedBottleneck(nin, nmid, stride, 4,
                                          zero_init_residual,
                                          fused_conv2=fused_conv2))
            nin = nmid * 4
        model.add(FusedBottleneckChain(blocks))
    model.add(SpatialAveragePooling(7, 7, 1, 1, global_pooling=True,
                                    format="NHWC"))
    model.add(View(nin))
    model.add(Linear(nin, class_num))
    model.to(dev)
    return model.reset(torch.Generator(device=dev).manual_seed(seed))


def ResNet50(class_num: int = 1000, **kw):
    return ResNet(class_num, 50, **kw)
