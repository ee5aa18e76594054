#!/usr/bin/env python3
"""How far float32 rounding alone moves ResNet-50's logits and gradients in
the PyTorch port: the ``fused="xla"`` arm (eager ops, no kernel) run in
float32 and in float64 on the same weights and batch, on the CPU.

This is the floor under any comparison of two float32 arms (phase 16 (b)
of ``chip_smoke.py`` holds the kernels' arms against the ``"xla"`` arm):
two float32 summation orders cannot be expected to agree closer than each
does with float64. The inputs are phase 16 (b)'s: weights from seed 5
(``zero_init_residual=False``), a B8 batch at 224 and labels from
``np.random.RandomState(16)``, cross entropy. For training and evaluation
mode it prints the logits' error (largest error over the largest value),
the gradients' error as the norm of all differences over the norm of all
gradients, and the worst parameter leaves.

    PYTHONPATH=. python3 tools/torch_resnet_f32_spread.py [--batch 8]

It needs no card and imports no JAX (~1 minute with 4 threads).
"""
import argparse
import copy

import numpy as np
import torch

from bigdl_tpu_torch.convert import flatten
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.nn import CrossEntropyCriterion


def _grads(model, x, y, dtype, training):
    params = model.params
    out, _ = model.apply(params, model.state,
                         torch.from_numpy(x.astype(dtype)), training=training)
    leaves = flatten(params)
    loss = CrossEntropyCriterion()._forward(out, y)
    return out, dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    m32 = ResNet(1000, 50, format="NHWC", fused="xla",
                 zero_init_residual=False, device="cpu", seed=5)
    m64 = copy.deepcopy(m32).double()
    rng = np.random.RandomState(16)
    x = rng.randn(args.batch, args.size, args.size, 3)
    y = torch.from_numpy(rng.randint(1, 1001, size=args.batch))
    for training in (True, False):
        o32, g32 = _grads(m32, x, y, np.float32, training)
        o64, g64 = _grads(m64, x, y, np.float64, training)
        rel = {k: float((g32[k].double() - g64[k]).abs().max()
                        / g64[k].abs().max()) for k in g64}
        num = sum(float(((g32[k].double() - g64[k]) ** 2).sum())
                  for k in g64)
        den = sum(float((g64[k] ** 2).sum()) for k in g64)
        worst = sorted(rel.items(), key=lambda e: -e[1])[:3]
        o32, o64 = o32.detach(), o64.detach()
        logits = float((o32.double() - o64).abs().max() / o64.abs().max())
        print(f"{'training' if training else 'evaluation'}: logits "
              f"{logits:.3e}, gradients (norm) {(num / den) ** 0.5:.3e}, "
              f"worst leaves {[(k, round(v, 5)) for k, v in worst]}",
              flush=True)


if __name__ == "__main__":
    main()
