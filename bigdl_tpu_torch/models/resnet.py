"""ResNet (counterpart of ``bigdl_tpu/models/resnet.py``).

Both families of the JAX package: the ImageNet bottleneck ResNets (depths
50, 101, 152; the 7x7 stem, or ``stem="s2d"``'s space-to-depth form of
it in NHWC) and the CIFAR basic-block ResNets (depth 6n + 2,
:func:`ResNetCifar`, shortcut A by default). ``fused="none"``, JAX's
default, builds the plain Torch-style blocks (:func:`bottleneck`,
:func:`basic_block`: ``ConcatTable`` of the main branch and the shortcut,
``CAddTable``, ``ReLU``) in NCHW or NHWC, their convolutions PyTorch's.
``fused="pallas"`` (NHWC) builds stages of :class:`FusedBottleneck`
blocks chained by :class:`FusedBottleneckChain`: every 1x1 conv runs
through K3 (``kernels.fused_bn_relu_matmul_nhwc``), every identity
junction through K5 (``kernels.fused_residual_matmul_nhwc``) and, with
``fused_conv2=True`` (the JAX package's ``BIGDL_TPU_FUSED_CONV2=1``),
every 3x3 conv through K4 (``kernels.fused_bn_relu_conv3x3``); on the CPU
these are the kernels' plain versions. ``fused_chain=False`` (the JAX
package's ``BIGDL_TPU_FUSED_CHAIN=0``) leaves the blocks unchained in the
``Sequential``: each block runs its own junction as one elementwise pass
and its conv1 through K3 (36 K3 launches a training forward of ResNet-50
and no K5, against 24 and 12 chained).

``fused="xla"`` is the JAX package's control arm: the same restructured
blocks (1x1 convs as products over the last axis of the NHWC tensor with
the affine prologue and float32 sums of z and z^2; the chain's junction
written out) in eager PyTorch ops, calling no wrapper of ``kernels``.
The JAX package's TPU tuning knobs (block sizes, the flattened layout,
VMEM fitting) have no counterpart.

Parameter and state trees keep the JAX names and layouts: Sequential
indices; the plain blocks' ``"0"`` (ConcatTable) / ``"0"`` (main) /
``"1"`` (shortcut) nesting; the convs' weights OIHW; fused chain blocks
under ``"0"``, ``"1"``, ... (unchained blocks at the ``Sequential``'s own
indices, 4-19 for ResNet-50), each block's ``w1``/``w2``/``w3``/``proj_w``
HWIO with ``bn1``/``bn2``/``bn3``/``proj_bn`` (``weight``, ``bias``;
state ``running_mean``, ``running_var``), so ``convert.jax_to_state_dict``
carries JAX weights across by name.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import (fused_bn_relu_conv3x3, fused_bn_relu_matmul_nhwc,
                       fused_residual_matmul_nhwc)
from ..nn import (CAddTable, ConcatTable, Identity, Linear, LogSoftMax,
                  Padding, ReLU, Sequential, SpatialAveragePooling,
                  SpatialBatchNormalization, SpatialConvolution,
                  SpatialMaxPooling, View)
from ..nn.init import MsraFiller
from ..nn.module import Module
from ._build import placed

__all__ = ["SpaceToDepthStem", "ShortcutType", "basic_block", "bottleneck",
           "FusedBottleneck", "FusedBottleneckChain", "ResNet",
           "ResNetCifar", "ResNet50"]


def _conv(nin, nout, k, stride=1, pad=0, fmt="NCHW"):
    return SpatialConvolution(nin, nout, k, k, stride, stride, pad, pad,
                              with_bias=False, init_method=MsraFiller(False),
                              format=fmt)


class SpaceToDepthStem(SpatialConvolution):
    """The 7x7/2 ImageNet stem computed as the identical 4x4/1 conv over a
    2x2 space-to-depth input (NHWC (N, H, W, 3) -> (N, H/2, W/2, 12)), the
    weight kept in the plain stem's (64, 3, 7, 7) OIHW layout and the
    equivalent kernel rebuilt on each call: y[oh] reads x rows 2 oh + kh -
    3, kh in [0, 7); writing kh - 3 = 2 t + dh (dh in {0, 1}) gives taps t
    in {-2..1} over s2d row oh + t and sub-row dh, a stride-1 conv padded
    (2, 1) whose kernel is the 7x7 one zero-padded to 8x8 (one leading row
    and column) and 2x2-blocked to (4, 4, 12, nout)."""

    def __init__(self, n_output_plane: int = 64, name=None):
        super().__init__(3, n_output_plane, 7, 7, 2, 2, 3, 3,
                         with_bias=False, init_method=MsraFiller(False),
                         format="NHWC", name=name)

    def call(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        n, h, w, c = x.shape
        if c != 3 or h % 2 or w % 2:
            raise ValueError(f"SpaceToDepthStem wants NHWC with even H, W "
                             f"and C = 3, got {tuple(x.shape)}")
        x2 = x.reshape(n, h // 2, 2, w // 2, 2, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 12)
        wk = params["weight"].permute(2, 3, 1, 0)          # HWIO (7,7,3,O)
        wk = F.pad(wk, (0, 0, 0, 0, 1, 0, 1, 0))           # (8,8,3,O)
        wk = wk.reshape(4, 2, 4, 2, 3, -1).permute(0, 2, 1, 3, 4, 5) \
            .reshape(4, 4, 12, -1)
        y = F.conv2d(F.pad(x2.permute(0, 3, 1, 2), (2, 1, 2, 1)),
                     wk.permute(3, 2, 0, 1).to(x2.dtype))
        y = y.permute(0, 2, 3, 1)
        return y[0] if squeeze else y


def _bn(n, zero_gamma=False, fmt="NCHW"):
    return SpatialBatchNormalization(
        n, init_weight=np.zeros(n, np.float32) if zero_gamma else None,
        data_format=fmt)


class ShortcutType:
    A = "A"     # identity, channels zero-padded (CIFAR)
    B = "B"     # a 1x1 conv projection where the shape changes
    C = "C"     # as B here (the JAX package's reading)


def _shortcut(nin, nout, stride, shortcut_type=ShortcutType.B, fmt="NCHW"):
    if nin != nout or stride != 1:
        if shortcut_type == ShortcutType.A:
            if fmt != "NCHW":
                raise ValueError("shortcut A (CIFAR) is NCHW only")
            # every stride-th pixel, then the new channels zero-padded
            return Sequential(SpatialAveragePooling(1, 1, stride, stride),
                              Padding(2, nout - nin, 4))
        return Sequential(_conv(nin, nout, 1, stride, fmt=fmt),
                          _bn(nout, fmt=fmt))
    return Identity()


def basic_block(nin, nout, stride=1, shortcut_type=ShortcutType.B,
                zero_init_residual=False, fmt="NCHW"):
    """Two 3x3 conv + BN (ReLU between) beside the shortcut, added, ReLU."""
    main = Sequential(
        _conv(nin, nout, 3, stride, 1, fmt), _bn(nout, fmt=fmt), ReLU(),
        _conv(nout, nout, 3, 1, 1, fmt), _bn(nout, zero_init_residual, fmt))
    return Sequential(
        ConcatTable(main, _shortcut(nin, nout, stride, shortcut_type, fmt)),
        CAddTable(), ReLU())


def bottleneck(nin, nmid, stride=1, expansion=4,
               shortcut_type=ShortcutType.B, zero_init_residual=False,
               fmt="NCHW"):
    """1x1 reduce, 3x3 with the stride (v1.5 placement), 1x1 expand, each
    with BN (ReLU after the first two), beside the shortcut, added, ReLU."""
    nout = nmid * expansion
    main = Sequential(
        _conv(nin, nmid, 1, fmt=fmt), _bn(nmid, fmt=fmt), ReLU(),
        _conv(nmid, nmid, 3, stride, 1, fmt), _bn(nmid, fmt=fmt), ReLU(),
        _conv(nmid, nout, 1, fmt=fmt), _bn(nout, zero_init_residual, fmt))
    return Sequential(
        ConcatTable(main, _shortcut(nin, nout, stride, shortcut_type, fmt)),
        CAddTable(), ReLU())


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
    1x1 expand, shortcut B) whose 1x1 convs are products over the last
    axis with the previous BatchNorm's affine + ReLU as the prologue and
    the next BatchNorm's batch statistics from the epilogue: through K3
    with ``kernel="pallas"``, in eager ops with ``kernel="xla"`` (JAX's
    control arm). With ``fused_conv2`` (pallas only) the 3x3 conv runs
    through K4 the same way, otherwise BN1 + ReLU is one elementwise pass,
    the conv is ``F.conv2d`` on the channels-last view and BN2's
    statistics are two reductions (as in the JAX package).

    BatchNorm statistics here are the unshifted ``s2 / m - mean^2`` from
    the sums (the JAX package's ``_bn_affine``); each affine ``(a, b)`` is
    computed in float32 and rounded to the activations' dtype before it
    is applied. ``fused_conv2`` is the keyword form of JAX's
    ``BIGDL_TPU_FUSED_CONV2`` switch (the port reads no environment)."""

    def __init__(self, nin: int, nmid: int, stride: int = 1,
                 expansion: int = 4, zero_init_residual: bool = False,
                 eps: float = 1e-5, momentum: float = 0.1,
                 kernel: str = "pallas", name=None,
                 fused_conv2: bool = False):
        super().__init__(name=name)
        if kernel not in ("pallas", "xla"):
            raise ValueError(f"kernel must be 'pallas' or 'xla', got "
                             f"{kernel!r}")
        if fused_conv2 and kernel != "pallas":
            raise ValueError("fused_conv2 routes the 3x3 conv through K4: "
                             "it needs kernel='pallas'")
        self.kernel = kernel
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
            from ..parallel.collective import batch_group, global_sums
            bg = batch_group()
            if bg is not None:
                # a replicated data-parallel step: the kernels' column sums
                # summed over the ranks give the global batch's statistics
                s1, s2 = global_sums(s1, s2)
                m = m * bg[1]
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

    def _mm(self, x, w, a, b, relu, stats):
        """One 1x1 conv as a product over the last axis of ``x`` (..., K):
        ``(z (..., N), s1, s2)``. K3 on the 'pallas' arm; on the 'xla' arm
        the JAX package's plain ops: the affine prologue in x's dtype,
        max(., 0), ``torch.matmul`` (no reshape of the NHWC tensor) and
        float32 sums of z and z^2."""
        if self.kernel == "pallas":
            return fused_bn_relu_matmul_nhwc(x, w, a, b, relu=relu,
                                             stats=stats)
        xh = x if a is None else x * a + b
        if relu:
            xh = _max0(xh)
        z = torch.matmul(xh, w)
        if not stats:
            return z, None, None
        zf = z.float()
        red = tuple(range(z.dim() - 1))
        return z, zf.sum(red), (zf * zf).sum(red)

    def _conv1(self, params, x, training):
        """Block entry: the 1x1 reduce conv (+ BN1's statistics)."""
        w1 = params["w1"].reshape(self.nin, self.nmid).to(x.dtype)
        return self._mm(x, w1, None, None, relu=False, stats=training)

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
        z3, s31, s32 = self._mm(z2, w3, a2.to(dt), b2.to(dt), relu=True,
                                stats=training)
        a3, b3, new_state["bn3"] = self._bn_affine(
            params, state, "bn3", s31, s32, m2, training)
        if self.project:
            # the strided shortcut (every stride-th pixel) is gathered by
            # the reshape into the kernel's rows, as XLA materialises the
            # slice before the Pallas call
            xs = x_short[:, ::self.stride, ::self.stride, :]
            wp = params["proj_w"].reshape(self.nin, self.nout).to(dt)
            zp, sp1, sp2 = self._mm(xs, wp, None, None, relu=False,
                                    stats=training)
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
    fuse block n's epilogue ``relu(z3 * a3 + b3 + short)`` with block
    n+1's 1x1 reduce conv: through K5, one kernel that writes the junction
    once, for 'pallas' blocks; written out (the elementwise epilogue, then
    the block's product) for 'xla' blocks, as the JAX package's
    ``_junction`` does off its kernel. The stage's first block (projecting
    or striding) keeps its plain entry; the last block's epilogue is an
    elementwise pass."""

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

    def _junction(self, z3, a3, b3, short, w1n, training):
        """``(out, z1, s1, s2)``: the junction ``out = relu(z3 * a3 + b3 +
        short)`` and the next block's conv1 on it."""
        if self.blocks[0].kernel == "pallas":
            return fused_residual_matmul_nhwc(z3, short, w1n, a3, b3,
                                              stats=training)
        out = _max0(z3 * a3 + b3 + short)
        return (out,) + self.blocks[0]._mm(out, w1n, None, None, False,
                                           training)

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
            out, z1, s11, s12 = self._junction(z3, a3.to(dt), b3.to(dt),
                                               short, w1n, training)
            z3, a3, b3, short, new_state[key] = nxt._body(
                params[key], state[key], z1, s11, s12, out, training)
        return _max0(z3 * a3.to(dt) + b3.to(dt) + short), new_state


_IMAGENET_CFG = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def ResNet(class_num: int = 1000, depth: int = 50, shortcut_type: str = "B",
           data_set: str = "ImageNet", zero_init_residual: bool = True,
           with_log_softmax: bool = False, format: str = "NCHW",
           stem: str = "conv7", pool_grad: str = "exact",
           fused: str = "none", fused_conv2: bool = False,
           fused_chain: bool = True, device=None, seed: int = 0):
    """The JAX package's factory (the reference's ``ResNet(classNum,
    opt)``): ``data_set="cifar10"`` gives :func:`ResNetCifar` (with this
    ``shortcut_type``); otherwise the ImageNet depths 50, 101 and 152 in
    ``format`` NCHW or NHWC, ``fused="none"`` (plain blocks), ``"pallas"``
    (NHWC, shortcut B: the kernels, ``fused_conv2`` routing the 3x3 convs
    through K4) or ``"xla"`` (the same blocks in eager ops, no kernel).
    ``fused_chain=False`` (the JAX package's ``BIGDL_TPU_FUSED_CHAIN=0``)
    leaves the fused blocks unchained. ``stem="s2d"`` (NHWC) is the
    space-to-depth stem, ``pool_grad`` the stem max pool's ``grad_mode``.
    The model is built on ``device`` (the CUDA device by default, which
    raises without one; ``'cpu'`` for the CPU) with weights drawn from a
    generator seeded with ``seed``."""
    if data_set.lower() == "cifar10":
        return ResNetCifar(class_num, depth, shortcut_type, device=device,
                           seed=seed)
    if fused not in ("none", "pallas", "xla"):
        raise ValueError(f"fused must be 'none', 'pallas' or 'xla', got "
                         f"{fused!r}")
    if depth not in _IMAGENET_CFG:
        raise ValueError(f"ImageNet ResNet depth must be one of "
                         f"{sorted(_IMAGENET_CFG)}, got {depth}")
    fmt = format
    if fused != "none":
        if fmt != "NHWC":
            raise ValueError("fused bottlenecks are the NHWC path")
        if shortcut_type != ShortcutType.B:
            raise NotImplementedError(
                f"fused={fused!r} implements shortcut type B only "
                f"(requested {shortcut_type!r}), as the JAX package's fused "
                f"arms do")
    if fused_conv2 and fused != "pallas":
        raise ValueError("fused_conv2 routes the fused bottlenecks' 3x3 "
                         "convs through K4: it needs fused='pallas'")
    model = Sequential()
    if stem == "s2d":
        if fmt != "NHWC":
            raise ValueError("the space-to-depth stem is the NHWC path")
        model.add(SpaceToDepthStem(64))
    else:
        model.add(_conv(3, 64, 7, 2, 3, fmt))
    model.add(_bn(64, fmt=fmt))
    model.add(ReLU())
    model.add(SpatialMaxPooling(3, 3, 2, 2, 1, 1, format=fmt,
                                grad_mode=pool_grad))
    nin = 64
    for stage, n_blocks in enumerate(_IMAGENET_CFG[depth]):
        nmid = 64 * 2 ** stage
        blocks = []
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            if fused != "none":
                blk = FusedBottleneck(nin, nmid, stride, 4,
                                      zero_init_residual, kernel=fused,
                                      fused_conv2=fused_conv2)
                if fused_chain:
                    blocks.append(blk)
                else:
                    model.add(blk)
            else:
                model.add(bottleneck(nin, nmid, stride, 4, shortcut_type,
                                     zero_init_residual, fmt))
            nin = nmid * 4
        if blocks:
            model.add(FusedBottleneckChain(blocks))
    model.add(SpatialAveragePooling(7, 7, 1, 1, global_pooling=True,
                                    format=fmt))
    model.add(View(nin))
    model.add(Linear(nin, class_num))
    if with_log_softmax:
        model.add(LogSoftMax())
    return placed(model, device, seed)


def ResNetCifar(class_num: int = 10, depth: int = 20,
                shortcut_type: str = ShortcutType.A, device=None,
                seed: int = 0):
    """The CIFAR-10 ResNet of depth 6n + 2 (20, 32, 44, 56, 110): a 3x3
    stem, three stages of n basic blocks (16, 32, 64 channels), global
    average pooling, ``Linear`` and log-softmax, NCHW."""
    if depth < 8 or (depth - 2) % 6:
        raise ValueError(f"CIFAR depth must be 6n + 2, got {depth}")
    n = (depth - 2) // 6
    model = Sequential()
    model.add(_conv(3, 16, 3, 1, 1))
    model.add(_bn(16))
    model.add(ReLU())
    nin = 16
    for stage in range(3):
        nout = 16 * 2 ** stage
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            model.add(basic_block(nin, nout, stride, shortcut_type))
            nin = nout
    model.add(SpatialAveragePooling(8, 8, 1, 1, global_pooling=True))
    model.add(View(nin))
    model.add(Linear(nin, class_num))
    model.add(LogSoftMax())
    return placed(model, device, seed)


def ResNet50(class_num: int = 1000, **kw):
    return ResNet(class_num, 50, **kw)
