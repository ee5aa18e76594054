#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bigdl_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi``), the torch / CUDA versions and the
   kernel build time;
2. holds each kernel against its plain PyTorch version on the card at the
   serving, LM training and ResNet-50 shapes, and times kernel, plain
   version and the PyTorch call computing the same function
   (``scaled_dot_product_attention``, its backward for K1-bwd; for the
   fused ResNet kernels, which no single call computes, the bare product
   alone: cuBLAS ``x @ w``, or cuDNN's conv for K4) with CUDA events, over
   CUDA graphs of back-to-back launches on inputs rotated past the 50 MB
   L2 where the call can be captured. The flash kernels are checked on
   their routes (bf16: the tensor-core kernels; float32: in 3xTF32 on the
   tensor cores, the forward up to D = 112 and the backward up to D = 64,
   past them on the CUDA cores) at ragged T, D = 32/64/128, the chunk
   form and kv_len = 0, the backward also in the ring form (external
   delta, float32 gradients) and for bitwise-equal reruns; the float32
   forward and backward timed at (8,16,256,64) and (2,16,1024,64) on
   3xTF32, each also on the CUDA-core route, and at D = 128 (forward) /
   96 (backward) on the CUDA cores; K2 (split-K, ``paged_attention_sm90``)
   at decode in float32 and bf16 pages, at positions up to 4096 and in the
   chunk form (S = 32), each timed beside the unsplit kernel it succeeds
   (``paged_attention.cu``), with grouped-query heads, the padded slot at
   position 0, a table one split wide and bitwise-equal reruns; then
   every other head dim the attention kernels are instantiated for (each
   multiple of 16 up to 128 on the bf16 flash kernels, up to 112 on the
   float32 forward's 3xTF32 route and 256 on its CUDA-core route and on
   K2, up to 64 on the float32 backward's 3xTF32 route and 192 on its
   CUDA-core route) and their padded route (a D not a multiple of 16),
   with the launches by route, and the bf16 flash pair timed at D = 96
   (hidden 768, 8 heads) at the training shape. The fused ResNet kernels
   are checked on all four routes (bf16 and float32 in 3xTF32 on the
   tensor cores; ragged bf16 and the other float32 shapes on the CUDA
   cores) at small and ragged shapes, at pad taps where relu(b) != 0, K3
   and K5 also without statistics at M = 147 and K5 at the ReLU's tie,
   with the float32 launches by route, and, with two launches bit for bit
   equal, at every distinct ResNet-50 B256/224 shape of K3 (forward and
   backward), K4 and K5 in bf16 and every B32/224 shape of K3, K4 and K5
   in float32 (also on the CUDA-core route, for comparison; K5's h also
   written into a NaN-filled buffer, which must come back whole), each
   timed with its library call and bound; the launches a step times the
   time of each family is printed against the measured steps of phases 7
   and 8. K5's bf16 stage-0 junction must take at most 1.0 ms forward and
   3.0 ms backward; in float32 at B32, K3's stage-0 conv3 at most 0.12 /
   0.40 ms and K5's stage-0 junction 0.20 / 0.60 ms; the float32 flash
   forward and backward at (8,16,256,64) must beat SDPA (forward,
   backward) and K4's float32 stage-0 call cuDNN's float32 conv, timed in
   the same run, and K2's decode case must take at most a third of the
   unsplit kernel's time.
   The tensor-core libraries (``*_sm90``) must build without spills;
3. runs ``Transformer.generate`` on the flagship TransformerLM (vocab
   32000, hidden 1024, 16 heads, filter 4096, 12 layers, bf16 weights,
   batch 8, prompt 128) and checks ``prefill`` (causal flash kernel)
   against ``prefill_chunked`` (rectangular-causal flash kernel);
4. serves 16 greedy requests of mixed lengths through
   ``DecodeScheduler`` and checks each against a solo decode of its prompt
   up to the first near-tie;
5. trains the flagship with the repository's bf16 LM recipe (float32
   masters, ``bf16_params``, ``hidden_states(training=True)``,
   ``lm_loss_chunked(chunk=128)``, ``SGD(0.01, momentum=0.9)``) at batch
   16 x 1024 tokens, remat off and on: 1 warmup step and 5 steps on one
   fixed batch, each loss and gradient finite and the last loss below
   the first;
6. trains through the normal entry point, ``LocalOptimizer`` with
   ``LMCriterion`` and ``SGD(0.01, momentum=0.9)``, 4 iterations of
   batch 8 x 256 tokens on float32 parameters;
7. runs one training step of ResNet-50 (``fused="pallas"``, NHWC,
   ``fused_conv2``) at B2/224 on the card and on the CPU with the same
   weights, in float32 and through the bf16 recipe (logits, running
   statistics, gradients; the max pool's ties in float32),
   then trains full-width, full-depth ResNet-50 with the repository's
   recipe (``bench.py`` ``_build_resnet_step``: float32 masters,
   ``bf16_params``, bf16 images, ``CrossEntropyCriterion`` on float32
   logits, ``SGD(0.1, momentum=0.9)``) at B256/224, ``fused_conv2`` off
   and on: 1 warmup step and 4 steps on one fixed batch, then (off arm)
   2 steps under ``torch.profiler``: CUDA kernel time a step against the
   untraced step, and the largest kernels;
8. trains ResNet-50 through ``Optimizer.create`` (a ``LocalOptimizer``)
   over a DataSet of image Samples, 3 iterations of B32/224, float32, then
   2 more under ``torch.profiler``: CUDA kernel time a step by family.

The kernels' launch counters are set to 0 just before each path is driven
(``generate``, ``prefill_chunked``, serving after the scheduler's warmup,
each training step, each ``LocalOptimizer`` run) and read just after; a
path's kernel launched other than its expected number of times (once per
layer and prefill piece or LM training step, twice for the forward with
remat; per ResNet-50 step 24 K3 and 12 K5 forwards and as many backwards,
16 K4 forwards with ``fused_conv2``), or any other kernel launched, fails
the run; so does a flash, K3, K4 or K5 launch on another route than the
path's dtype and shapes give (``bf16_sm90`` in ``generate``,
``prefill_chunked`` and the bf16 recipes; in the ``LocalOptimizer`` run
``f32_sm90`` for the flash forward and backward; ``f32_split`` for K2 in
serving; ``f32_sm90`` for K3, K4 and K5 in phases 7 and 8). Every check
that fails exits non-zero. The line before the last is one JSON object with
each kernel's numbers (``flash_fwd`` at the serving prefill shape with the
``generate`` launches, ``flash_fwd_train`` at the training shape with the
launches of the five remat-off training steps, ``flash_bwd`` likewise,
``flash_fwd_chunk`` with the ``prefill_chunked`` launches, the ``_f32``
rows at the ``LocalOptimizer`` shape with its launches by route, the
CUDA-core forward's row at D = 128 and backward's at D = 96; K2's rows at
the decode and long decode cases with the serving launches by route, and
the unsplit kernel's row at the decode case; the fused ResNet kernels at
their timed shapes with the launches of the four ResNet-50 steps of the arm
that runs them, their ``_f32`` rows (3xTF32) at phase 8's stage-0 shape
with its launches (K4's with those of phase 7's float32 step, and its
CUDA-core route's row beside it); the flash, K3, K4 and K5 rows carry their
``dtype_route``, the 3xTF32 rows their CUDA-core route's ``cuda_core_ms``);
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TF32_FLOPS = 494.7e12            # dense tf32 tensor cores (data sheet)
L2_BYTES = 50 * 2**20


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def only_on(counts, route, n):
    """A wrapper's launches by route are ``n`` on ``route`` and none on
    any other (the padded routes and ``bf16_ragged`` included)."""
    return counts == {r: (n if r == route else 0) for r in counts}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


_CAPTURE = {}


def graph_ms(torch, fn, n_sets, reps=20, iters=7):
    """Median device milliseconds of one ``fn(i)`` call: ``reps`` calls
    (i = 0, 1, ...; callers rotate over ``n_sets`` input copies) are
    captured in one CUDA graph and replayed ``iters`` times between CUDA
    events. All captures share one side stream: cuBLAS keeps a workspace
    for every stream it has run on for the life of the process, so a new
    stream per capture would leave tens of MiB allocated per timed call
    and inflate the later phases' peak-memory readings."""
    s = _CAPTURE.get("stream")
    if s is None:
        s = _CAPTURE["stream"] = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(2):
            fn(i % n_sets)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(i % n_sets)
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def event_ms(torch, fn, reps=5, iters=5):
    """Median device milliseconds of one ``fn()`` call, timed with CUDA
    events around ``reps`` eager calls (for calls a CUDA graph cannot
    capture, such as an autograd backward)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def host_call_ms(torch, fn, n=50):
    """Median host milliseconds to return from one ``fn()`` call (checks,
    tensor-map encoding and launch; the device is idle at each call)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def launch_ms(torch, fn, n=10):
    """{kernel: device ms a call} of the launches one ``fn()`` call makes
    (a 3xTF32 wrapper: its split kernel, then its product kernel), from
    ``torch.profiler`` over ``n`` eager calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^void |<.*|\(.*", "", e.key).split("::")[-1]
            out[name] = out.get(name, 0.0) + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0)) / 1e3 / n
    return out


def n_copies(bytes_per_set):
    return max(1, math.ceil(2 * L2_BYTES / bytes_per_set))


def bound(nbytes, flops, dtype, route=None):
    """(bound ms, 'bytes' | 'operations'): the larger of the two times. The
    3xTF32 route (``f32_sm90``) runs three tf32 products for each float32
    one, so its operations count three times at the tf32 rate; other
    float32 work counts at the CUDA cores' float32 rate."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    if route == "f32_sm90":
        t_ops = 3 * flops / TF32_FLOPS * 1e3
    else:
        t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


# -- phase 2: kernels against their plain versions ---------------------------

@contextlib.contextmanager
def cuda_core_flash(torch):
    """float32 flash forward calls on the CUDA-core route (csrc/flash_fwd.cu:
    float32 FMAs, the route of head dims past the 3xTF32 kernel's widest,
    and of every float32 call before it), at any head dim it takes."""
    from bigdl_tpu_torch.kernels import flash_attention as fa
    rule = fa.fwd_route
    fa.fwd_route = lambda dtype, d: (
        "f32" if dtype == torch.float32 else rule(dtype, d))
    try:
        yield
    finally:
        fa.fwd_route = rule


@contextlib.contextmanager
def cuda_core_bwd(torch):
    """float32 flash backward calls on the CUDA-core route (csrc/flash_bwd.cu:
    float32 FMAs, the route of head dims past the 3xTF32 kernel's widest,
    and of every float32 call before it), at any head dim it takes."""
    from bigdl_tpu_torch.kernels import flash_attention as fa
    rule = fa.bwd_route
    fa.bwd_route = lambda dtype, d: (
        "f32" if dtype == torch.float32 else rule(dtype, d))
    try:
        yield
    finally:
        fa.bwd_route = rule


@contextlib.contextmanager
def unsplit_paged():
    """K2 calls on the kernel the split-K one succeeds (csrc/paged_attention.cu:
    one block per batch row and kv head walking the whole history; routes
    ``f32`` and ``bf16``)."""
    from bigdl_tpu_torch.kernels import paged_attention as pa
    rule = pa.route
    pa.route = lambda page_dtype, d: rule(page_dtype, d)[:-len("_split")]
    try:
        yield
    finally:
        pa.route = rule


def flash_case(torch, K, B, H, Tq, Tkv, D, dtype, causal, q_offset, kv_len,
               timed):
    """K1-fwd against flash_fwd_reference; timed: the wrapper's call (on
    the 3xTF32 route the split kernel and the attention kernel), the plain
    version and SDPA, and on the 3xTF32 route also the CUDA-core route at
    the same shape."""
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + Tq)
    esz = torch.empty((), dtype=dtype).element_size()
    per_set = esz * (B * H * Tq * D * 2 + 2 * B * H * Tkv * D) + 4 * B * H * Tq
    sets = n_copies(per_set) if timed else 1

    def mk(t):
        return torch.randn(B, H, t, D, device="cuda", generator=g).to(dtype)
    qs = [mk(Tq) for _ in range(sets)]
    ks = [mk(Tkv) for _ in range(sets)]
    vs = [mk(Tkv) for _ in range(sets)]
    o, lse = K.flash_fwd(qs[0], ks[0], vs[0], causal=causal,
                         q_offset=q_offset, kv_len=kv_len)
    ro, rlse = K.flash_fwd_reference(qs[0], ks[0], vs[0], causal, q_offset,
                                     kv_len)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    # rows that see no key (kv_len = 0) give lse = -inf on both sides
    seen = torch.isfinite(rlse)
    lerr = ((lse[seen] - rlse[seen]).abs().max().item() if seen.any()
            else 0.0)
    same_inf = torch.equal(torch.isneginf(lse), ~seen)
    # bf16: o is rounded to bf16 on both sides (one ulp is 2^-8 relative,
    # 0.0078 at |o| in [1, 2)) and p is rounded to bf16 before the PV
    # product on both sides, but at running (kernel) against final (plain)
    # maxima, so the two roundings of one p can differ by an ulp; lse is a
    # float32 sum of unrounded p on both sides
    tol = 2e-5 if dtype == torch.float32 else 1.6e-2
    check(torch.isfinite(o).all().item(), "flash_fwd: non-finite output")
    rec = {"shape": [B, H, Tq, Tkv, D], "dtype": str(dtype),
           "route": K.flash_attention.fwd_route(dtype, D),
           "causal": causal, "q_offset": q_offset, "kv_len": kv_len,
           "max_abs_err": err, "lse_err": lerr, "tol": tol}
    print(f"  K1 flash_fwd {rec}", flush=True)
    check(err <= tol and lerr <= 1e-4 and same_inf,
          f"flash_fwd disagrees with its plain version: {rec}")
    if not timed:
        return rec
    rows = q_offset + np.arange(Tq)
    seen = np.minimum(kv_len, rows + 1) if causal else np.full(Tq, kv_len)
    flops = 4.0 * D * B * H * float(seen.sum())
    nbytes = (esz * (2 * B * H * Tq * D + 2 * B * H * kv_len * D)
              + 4 * B * H * Tq)
    bound_ms, bound_by = bound(nbytes, flops, dtype, rec["route"])
    F = torch.nn.functional
    if q_offset == 0 and kv_len == Tkv:
        lib = lambda i: F.scaled_dot_product_attention(
            qs[i], ks[i], vs[i], is_causal=causal)
    else:
        cols = torch.arange(kv_len, device="cuda")
        mask = cols[None, :] <= (q_offset + torch.arange(
            Tq, device="cuda"))[:, None]
        lib = lambda i: F.scaled_dot_product_attention(
            qs[i], ks[i][:, :, :kv_len], vs[i][:, :, :kv_len],
            attn_mask=mask)
    rec.update(
        ms=graph_ms(torch, lambda i: K.flash_fwd(
            qs[i], ks[i], vs[i], causal=causal, q_offset=q_offset,
            kv_len=kv_len), sets),
        plain_ms=graph_ms(torch, lambda i: K.flash_fwd_reference(
            qs[i], ks[i], vs[i], causal, q_offset, kv_len), sets),
        library_ms=graph_ms(torch, lib, sets),
        host_ms=host_call_ms(torch, lambda: K.flash_fwd(
            qs[0], ks[0], vs[0], causal=causal, q_offset=q_offset,
            kv_len=kv_len)),
        bound_ms=bound_ms, bound_by=bound_by)
    if rec["route"] == "f32_sm90":
        with cuda_core_flash(torch):
            rec["cuda_core_ms"] = graph_ms(torch, lambda i: K.flash_fwd(
                qs[i], ks[i], vs[i], causal=causal, q_offset=q_offset,
                kv_len=kv_len), sets)
            rec["cuda_core_bound_ms"] = bound(nbytes, flops, dtype)[0]
        rec["launch_ms"] = launch_ms(torch, lambda: K.flash_fwd(
            qs[0], ks[0], vs[0], causal=causal, q_offset=q_offset,
            kv_len=kv_len))
    print(f"  K1 timing {rec}", flush=True)
    return rec


def bwd_case(torch, K, B, H, T, D, dtype, causal, timed, ring=False):
    """K1-bwd (dK/dV kernel, then dQ kernel) against flash_bwd_reference
    on the residuals of the K1-fwd kernel. ``ring``: with an external
    delta and float32 gradients (``out_dtype``), as a ring backward calls
    it. bf16 inputs: two launches must give bitwise-equal gradients (no
    atomics)."""
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + T + D)
    q, k, v, do = [torch.randn(B, H, T, D, device="cuda",
                               generator=g).to(dtype) for _ in range(4)]
    o, lse = K.flash_fwd(q, k, v, causal=causal)
    kw = {}
    if ring:
        kw = dict(delta=(do.float() * o.float()).sum(-1),
                  out_dtype=torch.float32)
    got = K.flash_bwd(q, k, v, o, lse, do, causal, **kw)
    ref = K.flash_bwd_reference(q, k, v, o, lse, do, causal, **kw)
    again = K.flash_bwd(q, k, v, o, lse, do, causal, **kw)
    torch.cuda.synchronize()
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(got, ref)]
    mag = max(b.float().abs().max().item() for b in ref)
    # both sides round p and ds to the input type before their products
    # (as the JAX kernels do) and sum in float32: float32 differs by
    # summation order (~1e-6 relative over T <= 1024 terms); bf16 by a
    # rounding of p or ds that falls the other way (2^-8 relative on one
    # term) and by the rounding of the gradients (2^-9 relative) - the
    # tolerances leave a factor of 5-100 over that
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * max(1.0, mag)
    check(all(torch.isfinite(x).all().item() for x in got),
          "flash_bwd: non-finite gradient")
    want_dt = torch.float32 if ring else dtype
    check(all(x.dtype == want_dt for x in got),
          f"flash_bwd returned {[x.dtype for x in got]}, expected {want_dt}")
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    rec = {"shape": [B, H, T, D], "dtype": str(dtype),
           "route": K.flash_attention.bwd_route(dtype, D), "causal": causal,
           "external_delta_f32_out": ring, "max_abs_err": max(errs),
           "err_dq_dk_dv": errs, "max_abs_grad": mag, "tol": tol,
           "rerun_bitwise_equal": bitwise}
    print(f"  K1-bwd flash_bwd {rec}", flush=True)
    check(max(errs) <= tol,
          f"flash_bwd disagrees with its plain version: {rec}")
    check(bitwise, f"flash_bwd: two launches differ: {rec}")
    if not timed:
        return rec
    esz = torch.empty((), dtype=dtype).element_size()
    seen = np.arange(1, T + 1) if causal else np.full(T, T)
    # five products of 2 * D operations per (row, visible key) pair: 2.5
    # times the forward's; q, k, v, o, dO, lse and delta read once, dq,
    # dk and dv written once
    flops = 10.0 * D * B * H * float(seen.sum())
    nbytes = esz * 8 * B * H * T * D + 4 * 2 * B * H * T
    bound_ms, bound_by = bound(nbytes, flops, dtype, rec["route"])
    F = torch.nn.functional
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    rec.update(
        ms=graph_ms(torch, lambda i: K.flash_bwd(q, k, v, o, lse, do,
                                                 causal), 1, reps=5, iters=5),
        # the wrapper's delta = rowsum(dO * O) (one torch expression) and the
        # kernel pair alone, given that delta
        delta_ms=graph_ms(torch, lambda i: (do.float() * o.float()).sum(-1),
                          1, reps=5, iters=5),
        kernels_ms=graph_ms(torch, lambda i: K.flash_bwd(
            q, k, v, o, lse, do, causal, delta=delta), 1, reps=5, iters=5),
        plain_ms=graph_ms(torch, lambda i: K.flash_bwd_reference(
            q, k, v, o, lse, do, causal), 1, reps=3, iters=5),
        library_ms=event_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True)),
        bound_ms=bound_ms, bound_by=bound_by)
    if rec["route"] == "f32_sm90":
        with cuda_core_bwd(torch):
            rec["cuda_core_ms"] = graph_ms(torch, lambda i: K.flash_bwd(
                q, k, v, o, lse, do, causal), 1, reps=5, iters=5)
            rec["cuda_core_bound_ms"] = bound(nbytes, flops, dtype)[0]
        rec["launch_ms"] = launch_ms(torch, lambda: K.flash_bwd(
            q, k, v, o, lse, do, causal))
    print(f"  K1-bwd timing {rec}", flush=True)
    return rec


def paged_case(torch, K, B, nH, kvH, S, D, bs, pdtype, timed, max_pos=320):
    """K2 against paged_attention_reference, and a second launch bit for
    bit against the first (no atomics); positions drawn from 32 ..
    max_pos, the last row a padded slot (the null table at position 0)
    when B > 1. timed: the wrapper's call (split kernel, and the combine
    kernel when the table is wider than one split), the plain version, and
    the kernel the split-K one succeeds, at the same inputs."""
    from bigdl_tpu_torch.kernels import paged_attention as pa
    rng = np.random.RandomState(B * 100 + S + kvH)
    nblk = -(-(max_pos + S) // bs)
    NB = 1 + B * nblk
    esz = torch.empty((), dtype=pdtype).element_size()
    per_set = 2 * NB * kvH * bs * D * esz
    sets = n_copies(per_set) if timed else 1
    g = torch.Generator(device="cuda").manual_seed(S * 7 + kvH)
    kps = [torch.randn(NB, kvH, bs, D, device="cuda",
                       generator=g).to(pdtype) for _ in range(sets)]
    vps = [torch.randn(NB, kvH, bs, D, device="cuda",
                       generator=g).to(pdtype) for _ in range(sets)]
    tables = np.zeros((B, nblk), np.int32)
    for b in range(B):
        tables[b] = rng.permutation(np.arange(1, NB))[:nblk]
    pos = rng.randint(32, max_pos, size=B).astype(np.int32)
    if B > 1:               # a padded slot: the null table at position 0
        tables[-1] = 0
        pos[-1] = 0
    tb = torch.from_numpy(tables).cuda()
    ps = torch.from_numpy(pos).cuda()
    q = torch.randn(B, nH, S, D, device="cuda", generator=g).to(pdtype)
    o = K.paged_decode_attention(q, kps[0], vps[0], tb, ps)
    again = K.paged_decode_attention(q, kps[0], vps[0], tb, ps)
    ro = K.paged_attention_reference(q, kps[0], vps[0], tb, ps)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    tol = 2e-5 if pdtype == torch.float32 else 1.6e-2
    check(torch.isfinite(o).all().item(), "paged_attention: non-finite")
    w = K.flash_attention.head_dim_width("paged_attention", "t", D, pa._DIMS)
    splits, span = pa.split_plan(B, kvH, nH // kvH * S, nblk * bs, w,
                                 pa._sm_count(q.device))
    rec = {"shape": [B, nH, kvH, S, D, bs], "dtype": str(pdtype),
           "route": pa.route(pdtype, D), "max_pos": max_pos,
           "splits": splits, "span": span, "max_abs_err": err, "tol": tol,
           "rerun_bitwise_equal": torch.equal(o, again)}
    print(f"  K2 paged_attention {rec}", flush=True)
    check(err <= tol, f"paged_attention disagrees with its plain version: "
          f"{rec}")
    check(rec["rerun_bitwise_equal"], f"paged_attention: two launches "
          f"differ: {rec}")
    if not timed:
        return rec
    G = nH // kvH
    need_blocks = sum(-(-(int(p) + S) // bs) for p in pos)
    nbytes = (2 * need_blocks * kvH * bs * D * esz      # the pages read
              + 2 * B * nH * S * D * esz                # q in, o out
              + 4 * need_blocks + 4 * B)                # table rows, pos
    keys = sum(int(p) + s + 1 for p in pos for s in range(S))
    flops = 4.0 * D * kvH * G * keys
    bound_ms, bound_by = bound(nbytes, flops, pdtype)
    call = lambda i: K.paged_decode_attention(q, kps[i], vps[i], tb, ps)
    rec.update(
        ms=graph_ms(torch, call, sets),
        plain_ms=graph_ms(torch, lambda i: K.paged_attention_reference(
            q, kps[i], vps[i], tb, ps), sets),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        launch_ms=launch_ms(torch, lambda: call(0)))
    with unsplit_paged():
        uo = call(0)
        torch.cuda.synchronize()
        rec["unsplit_err"] = (uo.float() - ro.float()).abs().max().item()
        check(rec["unsplit_err"] <= tol, f"paged_attention.cu (unsplit "
              f"route) disagrees with its plain version: {rec}")
        rec["unsplit_ms"] = graph_ms(torch, call, sets)
    rec["hbm_share"] = bound_ms / rec["ms"]
    print(f"  K2 timing {rec}", flush=True)
    return rec


# -- phase 2, the fused ResNet kernels (K3, K3-nhwc, K5, K4) -----------------

def _rel_err(got, want):
    """Largest |got - want| over max(1, largest |want|)."""
    return ((got.float() - want.float()).abs().max().item()
            / max(1.0, want.float().abs().max().item()))


FUSED_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 1e-2}


def _esz(torch, dtype):
    return torch.empty((), dtype=dtype).element_size()


def _same(torch, got, again):
    """Two launches on the same inputs agree bit for bit (no atomics)."""
    return all((p is None and q is None) or torch.equal(p, q)
               for p, q in zip(got, again))


def k3_case(torch, K, M, Kd, N, dtype, prologue, relu, stats, timed, bwd=True,
            plain=True):
    """K3 forward (and backward) against the plain versions on one set of
    inputs, and a second launch bit for bit against the first; timed:
    kernel, plain version (with ``plain``) and the bare product (cuBLAS
    ``x @ w``; for the backward ``dz @ w.T`` and ``x.T @ dz``), which
    computes the product alone, without the prologue and statistics."""
    from bigdl_tpu_torch.kernels.fused_matmul import route
    g = torch.Generator(device="cuda").manual_seed(M + Kd + N)
    x = torch.randn(M, Kd, device="cuda", generator=g).to(dtype)
    w = (0.1 * torch.randn(Kd, N, device="cuda", generator=g)).to(dtype)
    a = b = None
    if prologue:
        a = (torch.rand(Kd, device="cuda", generator=g) + 0.5).to(dtype)
        b = torch.randn(Kd, device="cuda", generator=g).to(dtype)
    got = K.fused_matmul_fwd(x, w, a, b, relu, stats)
    ref = K.fused_matmul_fwd_reference(x, w, a, b, relu, stats)
    errs = [_rel_err(p, q) for p, q in zip(got, ref) if q is not None]
    same = _same(torch, got, K.fused_matmul_fwd(x, w, a, b, relu, stats))
    rec = {"shape": [M, Kd, N], "dtype": str(dtype), "prologue": prologue,
           "relu": relu, "stats": stats, "route": route(dtype, Kd, N),
           "err_z_s1_s2": errs}
    if bwd:
        z = ref[0]
        dz = torch.randn(M, N, device="cuda", generator=g).to(dtype)
        ds1 = torch.randn(N, device="cuda", generator=g) if stats else None
        ds2 = (0.01 * torch.randn(N, device="cuda", generator=g)
               if stats else None)
        gb = K.fused_matmul_bwd(x, w, a, b, z, dz, ds1, ds2, relu, stats)
        rb = K.fused_matmul_bwd_reference(x, w, a, b, z, dz, ds1, ds2, relu,
                                          stats)
        rec["err_dx_dw_da_db"] = [_rel_err(p, q) for p, q in zip(gb, rb)
                                  if q is not None]
        errs = errs + rec["err_dx_dw_da_db"]
        same = same and _same(torch, gb, K.fused_matmul_bwd(
            x, w, a, b, z, dz, ds1, ds2, relu, stats))
    torch.cuda.synchronize()
    tol = FUSED_TOL[str(dtype)]
    rec.update(max_abs_err=max(errs), tol=tol, reruns_equal=same)
    print(f"  K3 fused_matmul {rec}", flush=True)
    check(max(errs) <= tol, f"fused_matmul disagrees with its plain version: "
          f"{rec}")
    check(same, f"fused_matmul: two launches differ: {rec}")
    if not timed:
        return rec
    e = _esz(torch, dtype)
    nbytes = e * (M * Kd + Kd * N + M * N) + 4 * (2 * N + (2 * Kd if prologue
                                                           else 0))
    rec["fwd"] = dict(
        ms=graph_ms(torch, lambda i: K.fused_matmul_fwd(x, w, a, b, relu,
                                                        stats), 1, reps=10),
        plain_ms=graph_ms(torch, lambda i: K.fused_matmul_fwd_reference(
            x, w, a, b, relu, stats), 1, reps=5) if plain else None,
        library_ms=graph_ms(torch, lambda i: x @ w, 1, reps=10))
    rec["fwd"]["bound_ms"], rec["fwd"]["bound_by"] = bound(
        nbytes, 2.0 * M * Kd * N, dtype, rec["route"])
    if bwd:
        # reads x, w, a, b, dz, z, ds1, ds2; writes dx, dw, da, db
        nbytes = (e * (2 * M * Kd + 2 * Kd * N + 2 * M * N)
                  + 4 * (2 * N + (4 * Kd if prologue else 0)))
        rec["bwd"] = dict(
            ms=graph_ms(torch, lambda i: K.fused_matmul_bwd(
                x, w, a, b, z, dz, ds1, ds2, relu, stats), 1, reps=5,
                iters=5),
            plain_ms=graph_ms(torch, lambda i: K.fused_matmul_bwd_reference(
                x, w, a, b, z, dz, ds1, ds2, relu, stats), 1, reps=3,
                iters=5) if plain else None,
            library_ms=graph_ms(torch, lambda i: (dz @ w.T, x.T @ dz), 1,
                                reps=5, iters=5))
        rec["bwd"]["bound_ms"], rec["bwd"]["bound_by"] = bound(
            nbytes, 4.0 * M * Kd * N, dtype, rec["route"])
    print(f"  K3 timing {rec}", flush=True)
    return rec


def _k5_nan_h(torch, K, z, r, a, b, w, h_ref):
    """The K5 forward's C entry on its route, with an h pre-filled with NaN:
    True when every element of h came back as the plain version's."""
    import ctypes
    from bigdl_tpu_torch.kernels import _build, fused_chain as fc
    from bigdl_tpu_torch.kernels.fused_matmul import _PART_ROWS, _wsplit, route
    M, Kd = z.shape
    N = w.shape[1]
    rt = route(z.dtype, Kd, N)
    h = torch.full_like(z, float("nan"))
    zo = torch.empty((M, N), dtype=z.dtype, device="cuda")
    part = torch.empty((2, -(-M // _PART_ROWS[rt]), N), device="cuda")
    st = torch.empty((2, N), device="cuda")
    af, bf = a.float().contiguous(), b.float().contiguous()
    wsp, extra = _wsplit(rt, Kd, N, z.device)
    fn = _build.function(*fc._FWD_FN[rt], fc._FWD_ARGTYPES
                         + [ctypes.c_void_p] * len(extra))
    err = fn(z.data_ptr(), r.data_ptr(), af.data_ptr(), bf.data_ptr(),
             w.data_ptr(), h.data_ptr(), zo.data_ptr(), part.data_ptr(),
             part[1].data_ptr(), st.data_ptr(), st[1].data_ptr(),
             fc._DTYPES[z.dtype], M, Kd, N, 1,
             torch.cuda.current_stream().cuda_stream, *extra)
    check(err == 0, f"fused_chain forward C entry: CUDA error {err}")
    torch.cuda.synchronize()
    return bool(torch.equal(h, h_ref))


def k5_case(torch, K, B, H, Kd, N, dtype, timed, plain=True, stats=True,
            tie=False, nan_h=False):
    """K5 forward and backward against the plain versions, and a second
    launch bit for bit against the first; timed like K3, the bare product
    being ``h @ w`` (and ``dzo @ w.T``, ``h.T @ dzo``). ``tie``: z = r = 0
    and b = 0 on every other channel, so u = z a + b + r is exactly 0 there
    (the ReLU's tie, whose gradient is 0 on both sides). ``nan_h``: the
    forward's C entry is also called on an h pre-filled with NaN, which
    must come back equal to the plain version's h everywhere (written in
    full by the kernel)."""
    from bigdl_tpu_torch.kernels.fused_matmul import route
    g = torch.Generator(device="cuda").manual_seed(B + H + Kd + N)
    M = B * H * H
    z = torch.randn(M, Kd, device="cuda", generator=g).to(dtype)
    r = torch.randn(M, Kd, device="cuda", generator=g).to(dtype)
    w = (0.1 * torch.randn(Kd, N, device="cuda", generator=g)).to(dtype)
    a = (torch.rand(Kd, device="cuda", generator=g) + 0.5).to(dtype)
    b = torch.randn(Kd, device="cuda", generator=g).to(dtype)
    if tie:
        z[:, ::2] = 0
        r[:, ::2] = 0
        b[::2] = 0
    got = K.fused_chain_fwd(z, r, a, b, w, stats)
    ref = K.residual_chain_reference(z, r, a, b, w, stats)
    same = _same(torch, got, K.fused_chain_fwd(z, r, a, b, w, stats))
    h, zo = ref[0], ref[1]
    dh = torch.randn(M, Kd, device="cuda", generator=g).to(dtype)
    dzo = torch.randn(M, N, device="cuda", generator=g).to(dtype)
    ds1 = torch.randn(N, device="cuda", generator=g) if stats else None
    ds2 = 0.01 * torch.randn(N, device="cuda", generator=g) if stats else None
    gb = K.fused_chain_bwd(z, r, a, b, w, zo, dh, dzo, ds1, ds2, stats)
    rb = K.residual_chain_bwd_reference(z, r, a, b, w, zo, dh, dzo, ds1, ds2,
                                        stats)
    same = same and _same(torch, gb, K.fused_chain_bwd(
        z, r, a, b, w, zo, dh, dzo, ds1, ds2, stats))
    torch.cuda.synchronize()
    errs = [_rel_err(p, q) for p, q in zip(got + gb, ref + rb)
            if q is not None]
    tol = FUSED_TOL[str(dtype)]
    rec = {"shape": [B, H, H, Kd, N], "M": M, "dtype": str(dtype),
           "stats": stats, "tie": tie, "route": route(dtype, Kd, N),
           "err_h_zo_s1_s2_dz_dr_da_db_dw": errs, "max_abs_err": max(errs),
           "tol": tol, "reruns_equal": same}
    if nan_h:
        rec["nan_h_equal"] = _k5_nan_h(torch, K, z, r, a, b, w, h)
    print(f"  K5 fused_chain {rec}", flush=True)
    check(max(errs) <= tol, f"fused_chain disagrees with its plain version: "
          f"{rec}")
    check(same, f"fused_chain: two launches differ: {rec}")
    check(rec.get("nan_h_equal", True), f"fused_chain: h not written in full "
          f"(NaN left in a pre-filled h): {rec}")
    if not timed:
        return rec
    e = _esz(torch, dtype)
    rec["fwd"] = dict(
        ms=graph_ms(torch, lambda i: K.fused_chain_fwd(z, r, a, b, w, True),
                    1, reps=10),
        plain_ms=graph_ms(torch, lambda i: K.residual_chain_reference(
            z, r, a, b, w, True), 1, reps=5) if plain else None,
        library_ms=graph_ms(torch, lambda i: h @ w, 1, reps=10))
    # reads z, r, w, a, b; writes h, zo, s1, s2
    rec["fwd"]["bound_ms"], rec["fwd"]["bound_by"] = bound(
        e * (3 * M * Kd + Kd * N + M * N) + 4 * (2 * Kd + 2 * N),
        2.0 * M * Kd * N, dtype, rec["route"])
    rec["bwd"] = dict(
        ms=graph_ms(torch, lambda i: K.fused_chain_bwd(
            z, r, a, b, w, zo, dh, dzo, ds1, ds2, True), 1, reps=5, iters=5),
        plain_ms=graph_ms(torch, lambda i: K.residual_chain_bwd_reference(
            z, r, a, b, w, zo, dh, dzo, ds1, ds2, True), 1, reps=3, iters=5)
        if plain else None,
        library_ms=graph_ms(torch, lambda i: (dzo @ w.T, h.T @ dzo), 1,
                            reps=5, iters=5))
    # reads z, r, w, a, b, dh, dzo, zo, ds1, ds2; writes dz, dr, da, db, dw
    rec["bwd"]["bound_ms"], rec["bwd"]["bound_by"] = bound(
        e * (5 * M * Kd + 2 * Kd * N + 2 * M * N) + 4 * (4 * Kd + 2 * N),
        4.0 * M * Kd * N, dtype, rec["route"])
    print(f"  K5 timing {rec}", flush=True)
    return rec


def k4_case(torch, K, B, H, C, N, stride, dtype, timed, bias=None,
            plain=True):
    """K4 forward against its plain version, and a second launch bit for
    bit against the first; ``bias`` (a constant b) instead of random
    ones: with b > 0 every tap in the zero padding would give relu(b) != 0
    if the kernel applied the prologue after the padding. Timed like K3,
    the library call being cuDNN's bare conv (``F.conv2d`` on the
    channels-last view, without the prologue and statistics)."""
    from bigdl_tpu_torch.kernels.fused_conv import route
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(B + H + C + stride)
    x = torch.randn(B, H, H, C, device="cuda", generator=g).to(dtype)
    w = (0.1 * torch.randn(3, 3, C, N, device="cuda", generator=g)).to(dtype)
    a = (torch.rand(C, device="cuda", generator=g) + 0.5).to(dtype)
    b = (torch.randn(C, device="cuda", generator=g) if bias is None
         else torch.full((C,), float(bias), device="cuda")).to(dtype)
    got = K.fused_conv_fwd(x, w, a, b, stride, True)
    ref = K.conv3x3_reference(x, w, a, b, stride, True)
    same = _same(torch, got, K.fused_conv_fwd(x, w, a, b, stride, True))
    torch.cuda.synchronize()
    errs = [_rel_err(p, q) for p, q in zip(got, ref)]
    tol = FUSED_TOL[str(dtype)]
    rec = {"shape": [B, H, H, C, N], "stride": stride, "dtype": str(dtype),
           "bias": bias, "route": route(dtype, C, N), "err_z_s1_s2": errs,
           "max_abs_err": max(errs), "tol": tol, "reruns_equal": same}
    print(f"  K4 fused_conv {rec}", flush=True)
    check(max(errs) <= tol, f"fused_conv disagrees with its plain version: "
          f"{rec}")
    check(same, f"fused_conv: two launches differ: {rec}")
    if not timed:
        return rec
    H2 = -(-H // stride)
    e = _esz(torch, dtype)
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    rec.update(
        ms=graph_ms(torch, lambda i: K.fused_conv_fwd(x, w, a, b, stride,
                                                      True), 1, reps=5),
        plain_ms=graph_ms(torch, lambda i: K.conv3x3_reference(
            x, w, a, b, stride, True), 1, reps=3) if plain else None,
        library_ms=graph_ms(torch, lambda i: F.conv2d(
            xc, wc, stride=stride, padding=1), 1, reps=10))
    rec["bound_ms"], rec["bound_by"] = bound(
        e * (B * H * H * C + 9 * C * N + B * H2 * H2 * N) + 4 * (2 * C + 2 * N),
        2.0 * B * H2 * H2 * 9 * C * N, dtype, rec["route"])
    if rec["route"] == "f32_sm90":
        rec["launch_ms"] = launch_ms(torch, lambda: K.fused_conv_fwd(
            x, w, a, b, stride, True))
    print(f"  K4 timing {rec}", flush=True)
    return rec


# ResNet-50 at B256/224 (models/resnet.py): the fused calls of one training
# step, (name, shape, launches a step). K3: (M, K, N, prologue BN2 + ReLU);
# K4: (H, C, N, stride); K5: (H, K, N).
RB = 256
RESNET_K3 = [("s0 conv1", (RB * 56 * 56, 64, 64, False), 1),
             ("s1 conv1", (RB * 56 * 56, 256, 128, False), 1),
             ("s2 conv1", (RB * 28 * 28, 512, 256, False), 1),
             ("s3 conv1", (RB * 14 * 14, 1024, 512, False), 1),
             ("s0 conv3", (RB * 56 * 56, 64, 256, True), 3),
             ("s1 conv3", (RB * 28 * 28, 128, 512, True), 4),
             ("s2 conv3", (RB * 14 * 14, 256, 1024, True), 6),
             ("s3 conv3", (RB * 7 * 7, 512, 2048, True), 3),
             ("s0 proj", (RB * 56 * 56, 64, 256, False), 1),
             ("s1 proj", (RB * 28 * 28, 256, 512, False), 1),
             ("s2 proj", (RB * 14 * 14, 512, 1024, False), 1),
             ("s3 proj", (RB * 7 * 7, 1024, 2048, False), 1)]
RESNET_K4 = [("s0 3x3", (56, 64, 64, 1), 3),
             ("s1 3x3/2", (56, 128, 128, 2), 1),
             ("s2 3x3/2", (28, 256, 256, 2), 1),
             ("s3 3x3/2", (14, 512, 512, 2), 1),
             ("s1 3x3", (28, 128, 128, 1), 3),
             ("s2 3x3", (14, 256, 256, 1), 5),
             ("s3 3x3", (7, 512, 512, 1), 2)]
RESNET_K5 = [("s0 junction", (56, 256, 64), 2),
             ("s1 junction", (28, 512, 128), 3),
             ("s2 junction", (14, 1024, 256), 5),
             ("s3 junction", (7, 2048, 512), 2)]
# the shapes whose plain versions are timed too (the kernels line's rows)
JSON_SHAPES = ("s0 conv3", "s3 proj", "s0 3x3", "s1 3x3/2", "s0 junction")
# ms a call the 3xTF32 route must keep to at phase 8's stage-0 shapes (B32):
# about the bf16 routes' distance from their bounds
F32_LIMITS = {"K3 fwd": 0.12, "K3 bwd": 0.40, "K5 fwd": 0.20, "K5 bwd": 0.60}


def resnet_shapes(torch, K):
    """Every distinct ResNet-50 B256/224 shape of K3 (forward and backward)
    and K4 held against the plain versions (bf16, two launches bit for
    bit) and timed with the library call and the bound, and K5 (forward
    and backward) likewise. Returns ({family: [(name, launches a step,
    timing)]}, {name: case record})."""
    bf = torch.bfloat16
    fam = {"K3 fwd": [], "K3 bwd": [], "K4": [], "K5 fwd": [], "K5 bwd": []}
    recs = {}
    for name, (M, Kd, N, pro), n in RESNET_K3:
        r = recs[name] = k3_case(torch, K, M, Kd, N, bf, pro, pro, True, True,
                                 plain=name in JSON_SHAPES)
        fam["K3 fwd"].append((name, n, r["fwd"]))
        fam["K3 bwd"].append((name, n, r["bwd"]))
    for name, (H, C, N, st), n in RESNET_K4:
        r = recs[name] = k4_case(torch, K, RB, H, C, N, st, bf, True,
                                 plain=name in JSON_SHAPES)
        fam["K4"].append((name, n, r))
    for name, (H, Kd, N), n in RESNET_K5:
        r = recs[name] = k5_case(torch, K, RB, H, Kd, N, bf, True,
                                 plain=name in JSON_SHAPES, nan_h=True)
        fam["K5 fwd"].append((name, n, r["fwd"]))
        fam["K5 bwd"].append((name, n, r["bwd"]))
    _print_families(fam)
    return fam, recs


# phase 8's batch: Optimizer.create at B32/224 on float32 parameters
FB = 32


@contextlib.contextmanager
def cuda_core_route(torch):
    """K3, K4 and K5 float32 calls on the CUDA-core route
    (csrc/fused_matmul.cu, csrc/fused_conv.cu, csrc/fused_chain.cu: float32
    FMAs, the route of float32 shapes outside the 3xTF32 rules, and of
    every float32 call before them), at any shape."""
    from bigdl_tpu_torch.kernels import (fused_chain as fc, fused_conv as fcv,
                                         fused_matmul as fm)
    rule, conv_rule = fm.route, fcv.route
    fm.route = fc.route = lambda dtype, k, n: (
        "f32" if dtype == torch.float32 else rule(dtype, k, n))
    fcv.route = lambda dtype, c, n: (
        "f32" if dtype == torch.float32 else conv_rule(dtype, c, n))
    try:
        yield
    finally:
        fm.route = fc.route = rule
        fcv.route = conv_rule


def resnet_shapes_f32(torch, K):
    """Every distinct ResNet-50 B32/224 shape of K3 and K5 (forward and
    backward) in float32, the calls of phase 8, and of K4 (phase 7's
    float32 step runs it), held against the plain versions (two launches
    bit for bit; K5's h also into a NaN-filled buffer) and timed with the
    library call and the bound, on the 3xTF32 route and then on the
    CUDA-core route; the plain versions are timed at stage 0. Returns
    ({family: [(name, launches a step, timing)]} of each route, {name:
    case record} of each route)."""
    f32 = torch.float32
    fams, recs_by_route = [], []
    for cc in (False, True):
        fam = {"K3 fwd": [], "K3 bwd": [], "K5 fwd": [], "K5 bwd": [],
               "K4": []}
        recs = {}
        with (cuda_core_route(torch) if cc else contextlib.nullcontext()):
            for name, (M, Kd, N, pro), n in RESNET_K3:
                r = recs[name] = k3_case(
                    torch, K, M // RB * FB, Kd, N, f32, pro, pro, True, True,
                    plain=name == "s0 conv3" and not cc)
                fam["K3 fwd"].append((name, n, r["fwd"]))
                fam["K3 bwd"].append((name, n, r["bwd"]))
            for name, (H, Kd, N), n in RESNET_K5:
                r = recs[name] = k5_case(
                    torch, K, FB, H, Kd, N, f32, True,
                    plain=name == "s0 junction" and not cc, nan_h=True)
                fam["K5 fwd"].append((name, n, r["fwd"]))
                fam["K5 bwd"].append((name, n, r["bwd"]))
            for name, (H, C, N, st), n in RESNET_K4:
                r = recs[name] = k4_case(torch, K, FB, H, C, N, st, f32, True,
                                         plain=name == "s0 3x3" and not cc)
                fam["K4"].append((name, n, r))
        want = "f32" if cc else "f32_sm90"
        check(all(r["route"] == want for r in recs.values()),
              f"float32 ResNet-50 shapes off the {want} route: "
              f"{ {k: r['route'] for k, r in recs.items()} }")
        fams.append(fam)
        recs_by_route.append(recs)
    for f, rows in fams[0].items():
        for (name, n, r), (_, _, o) in zip(rows, fams[1][f]):
            print(f"  float32 B{FB} {f} {name}: {n} a step x {r['ms']:.4f} "
                  f"ms 3xTF32, {o['ms']:.4f} ms CUDA cores (library "
                  f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                  f"{r['bound_by']}; CUDA-core bound {o['bound_ms']:.4f})",
                  flush=True)
    return fams, recs_by_route


def _print_families(fam):
    for f, rows in fam.items():
        for name, n, r in rows:
            print(f"  {f} {name}: {n} a step x {r['ms']:.4f} ms (library "
                  f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                  f"{r['bound_by']})", flush=True)


# -- phase 4 helper ------------------------------------------------------------

def solo_greedy(torch, model, params, prompt, n):
    """Dense solo greedy decode of one prompt: (tokens, top-2 margins)."""
    logits, caches = model.prefill(params, prompt[None], model.max_len)
    toks, margins = [], []
    pos = prompt.size
    for i in range(n):
        top = logits[0].float().topk(2).values
        margins.append(float(top[0] - top[1]))
        toks.append(int(logits[0].argmax()))
        if i < n - 1:
            logits, caches = model.decode_one(params, [toks[-1]], pos,
                                              caches)
            pos += 1
    return toks, margins


# -- phases 5 and 6: training ---------------------------------------------------

def train_recipe(torch, K, model, init, x, y, remat, steps=5):
    """The bf16 LM training recipe (bench_extra.py bench_transformer_lm):
    float32 masters, cast to bf16 inside the loss, hidden_states in
    training mode, lm_loss_chunked(chunk=128), gradients to the masters,
    SGD(0.01, momentum=0.9) in place. 1 warmup step, then ``steps`` on the
    same batch; launch counts are read per step."""
    from bigdl_tpu_torch.convert import flatten, unflatten
    from bigdl_tpu_torch.models import lm_loss_chunked
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.amp import bf16_params
    model.load_state_dict(init)
    model.remat = remat
    params = model.params
    leaves = flatten(params)
    optim = SGD(learningrate=0.01, momentum=0.9)
    opt_state = optim.init_state(params)

    def step():
        p16 = bf16_params(params)
        h = model.hidden_states(p16, x, training=True)
        loss = lm_loss_chunked(h, p16["embed"], y, chunk=128)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        optim.update(unflatten(dict(zip(leaves, grads))), params, opt_state,
                     0.01)
        return loss, grads

    L = len(model.blocks)
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(flash_fwd=2 * L if remat else L, flash_bwd=L)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, total = [], [], {n: 0 for n in want}
    for i in range(steps + 1):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        check(counts == want, f"training step (remat={remat}) launched "
              f"{counts}, expected {want}")
        routes = K.launches_by_route()
        check(all(only_on(routes[n], "bf16_sm90", want[n])
                  for n in ("flash_fwd", "flash_bwd")),
              f"training step (remat={remat}): flash launches by route "
              f"{routes}, all expected on bf16_sm90")
        check(torch.stack([torch.isfinite(g).all() for g in grads])
              .all().item(), f"non-finite gradient (remat={remat})")
        losses.append(loss.item())
        if i > 0:                      # step 0 is the warmup
            times.append(dt)
            for n in total:
                total[n] += counts[n]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss "
          f"{losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    # the seed-0 model's loss on the seed-0 batch before any update, as the
    # CUDA-core kernels gave it (10.5815 with p kept in float32)
    check(abs(losses[0] - 10.5815) <= 1e-3, f"first loss {losses[0]} is "
          f"not within 1e-3 of 10.5815")
    return {"remat": remat, "losses": losses,
            "step_s": statistics.median(times), "step_s_all": times,
            "max_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "launches": total}


def local_optimizer_run(torch, K, model, init, V, B=8, T=256, iters=4):
    """The normal entry point: LocalOptimizer over a DataSet of samples,
    LMCriterion, SGD(0.01, momentum=0.9), float32 parameters."""
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.nn import LMCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim import max_iteration
    model.load_state_dict(init)
    model.remat = False
    rng = np.random.RandomState(2)
    ids = rng.randint(1, V, (B * iters, T + 1)).astype(np.int32)
    samples = [Sample(r[:-1], r[1:]) for r in ids]
    losses = []
    stop = max_iteration(iters)
    end = Trigger(lambda st: losses.append(st["loss"]) or stop(st))
    opt = LocalOptimizer(model, DataSet.array(samples), LMCriterion(),
                         SGD(learningrate=0.01, momentum=0.9), end,
                         batch_size=B)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    L = len(model.blocks)
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(flash_fwd=L * iters, flash_bwd=L * iters)
    check(counts == want, f"LocalOptimizer launched {counts}, expected "
          f"{want}")
    routes = K.launches_by_route()
    check(only_on(routes["flash_fwd"], "f32_sm90", want["flash_fwd"])
          and only_on(routes["flash_bwd"], "f32_sm90", want["flash_bwd"]),
          f"LocalOptimizer (float32 params): flash launches by route "
          f"{routes}, expected the forward and the backward all on "
          f"f32_sm90")
    check(len(losses) == iters and all(math.isfinite(v) for v in losses),
          f"LocalOptimizer losses {losses}")
    return {"losses": losses, "wall_s": dt,
            "step_s": opt.metrics.values["step_time"], "launches": counts,
            "routes": routes}


# -- phases 7 and 8: ResNet-50 training ---------------------------------------------

def _step_errs(got, want):
    """Relative errors of one ResNet-50 training step's (logits, running
    statistics, gradients) against another's."""
    (lc, sc, gc), (lp, sp, gp) = got, want
    gerr = sorted(((_rel_err(gc[k], gp[k]), k) for k in gp), reverse=True)
    return {"logits": _rel_err(lc, lp),
            "state": max(_rel_err(sc[k], sp[k]) for k in sp),
            "grad_fc": _rel_err(gc["10.weight"], gp["10.weight"]),
            "grad_all": gerr[0][0], "grad_worst3": gerr[:3]}


STEP_METRICS = ("logits", "state", "grad_fc", "grad_all")


def resnet_card_vs_cpu(torch, K, dtype, truth=None, B=2, S=224):
    """The model on the card (the kernels) against the same weights on the
    CPU (the kernels' plain versions), TF32 off: logits, new running
    statistics and gradients of one training step on a small batch, in
    float32, or through the bf16 recipe (``bf16_params`` of float32
    masters, bf16 images, float32 logits into the loss) with every fused
    launch on the card on the ``bf16_sm90`` route, where both bf16 runs are
    also held against ``truth``, the float32 step on the CPU; in float32
    also the exact max pool's tie routing on the card against the CPU's.
    Returns (record, the CPU's step)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.convert import flatten
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.utils.amp import bf16_params
    rng = np.random.RandomState(3)
    x = rng.randn(B, S, S, 3).astype(np.float32)
    y = torch.from_numpy(rng.randint(1, 1001, size=B))
    bf16 = dtype == torch.bfloat16
    out = {}
    for dev in ("cuda", "cpu"):
        m = ResNet50(format="NHWC", fused="pallas", fused_conv2=True,
                     zero_init_residual=False, device=dev, seed=5)
        if dev == "cpu":
            m.load_state_dict({k: v.cpu() for k, v in card_sd.items()})
        else:
            card_sd = m.state_dict()
        params = m.params
        K.reset_launch_counts()
        logits, ns = m.apply(bf16_params(params) if bf16 else params, m.state,
                             torch.from_numpy(x).to(dev, dtype),
                             training=True)
        loss = nn.CrossEntropyCriterion()._forward(logits.float(), y.to(dev))
        leaves = flatten(params)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if dev == "cuda":
            routes = K.launches_by_route()
        out[dev] = (logits.detach().float().cpu(),
                    {k: v.float().cpu() for k, v in flatten(ns).items()},
                    {k: g.float().cpu() for k, g in zip(leaves, grads)})
    rec = dict(dtype=str(dtype), **_step_errs(out["cuda"], out["cpu"]))
    rec["fused_routes"] = {n: routes[n] for n in (
        "fused_matmul_fwd", "fused_matmul_bwd", "fused_chain_fwd",
        "fused_chain_bwd", "fused_conv_fwd")}
    # bf16: every fused launch on bf16_sm90; float32: every one on the
    # 3xTF32 route
    want = {n: "bf16_sm90" if bf16 else "f32_sm90"
            for n in rec["fused_routes"]}
    check(all(r[want[n]] > 0 and sum(r.values()) == r[want[n]]
              for n, r in rec["fused_routes"].items()),
          f"ResNet-50 on the card ({dtype}): fused launches by route "
          f"{rec['fused_routes']}, expected {want}")
    if bf16:
        card = _step_errs(out["cuda"], truth)
        cpu = _step_errs(out["cpu"], truth)
        rec["card_vs_f32"] = {k: card[k] for k in STEP_METRICS}
        rec["cpu_vs_f32"] = {k: cpu[k] for k in STEP_METRICS}
        print(f"[7] ResNet-50 card vs CPU (B{B}/{S}, bf16 recipe, "
              f"fused_conv2, one training step): {rec}", flush=True)
        # bf16 keeps 8 significant bits, and the two runs round every
        # activation at the same points but after float32 sums taken in
        # other orders, so a sum that lands on the other side of a bf16
        # rounding boundary moves by one ulp (2^-8) and carries that
        # through 50 layers and the one-pass BatchNorm variances of the B2
        # batch (cancellation in stage 3): the two bf16 runs differ by
        # percents, and by more in the deep gradients. What the kernels
        # must not do is add error: the card's bf16 step has to be as close
        # to the float32 step as the CPU's bf16 step is (at most twice its
        # distance, plus 1e-3)
        check(all(card[k] <= 2 * cpu[k] + 1e-3 for k in STEP_METRICS),
              f"ResNet-50 bf16 on the card is further from float32 than "
              f"bf16 on the CPU: {rec}")
        return rec, out["cpu"]
    # ties, as after the stem's ReLU: the first maximum of each window
    pool = nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format="NHWC")
    xp = torch.relu(torch.from_numpy(rng.randn(4, 56, 56, 64).astype(
        np.float32)))
    gpool = {}
    for dev in ("cuda", "cpu"):
        t = xp.to(dev).requires_grad_()
        pool.forward(t).sum().backward()
        gpool[dev] = t.grad.cpu()
    rec["pool_grad_equal"] = bool(torch.equal(gpool["cuda"], gpool["cpu"]))
    print(f"[7] ResNet-50 card vs CPU (B{B}/{S}, float32, fused_conv2, one "
          f"training step): {rec}", flush=True)
    # float32 everywhere, sums in other orders: the logits, statistics and
    # classifier gradients agree to ~1e-5 (1e-4 allowed); the deeper
    # gradients pass backwards through the one-pass BatchNorm variances of
    # stage 3 (98 pixels each at B2), whose cancellation amplifies the
    # rounding differences (the JAX package's own plain and kernel paths
    # differ by 2-8% there at small batches; 1e-1 allowed)
    check(rec["logits"] <= 1e-4 and rec["state"] <= 1e-4
          and rec["grad_fc"] <= 1e-4 and rec["grad_all"] <= 1e-1,
          f"ResNet-50 on the card disagrees with the CPU: {rec}")
    check(rec["pool_grad_equal"], "max pool ties routed differently on the "
          "card and the CPU")
    return rec, out["cpu"]


def trace_steps(torch, step, n=2, top=20, per_call=1):
    """``n`` calls of ``step`` (each ``per_call`` training steps) under
    ``torch.profiler``: the wall ms per step (profiled, so inflated by
    the profiler's own host work), the
    device ms per step (the sum of the CUDA kernels' own times), the
    kernel launches per step, the device ms per step of each family of
    kernels (the port's own, cuDNN's convolutions, cuBLAS's products,
    PyTorch's elementwise / reduction / copy kernels, the rest) and the
    ``top`` kernels by time, (name, ms per step, launches per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (n * per_call)
    n *= per_call
    own = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3 / n
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted(((e.key, own(e), e.count / n) for e in kern),
                  key=lambda r: -r[1])

    def family(name):
        low = name.lower()
        if "bigdl" in low:
            return "port kernels"
        if any(w in low for w in ("conv", "cudnn", "xmma", "dgrad",
                                  "wgrad", "implicit")):
            return "cuDNN conv"
        if "gemm" in low or "cutlass" in low or "cublas" in low:
            return "cuBLAS"
        if "at::native" in low:
            return "PyTorch elementwise/reduce/copy"
        return "other"
    fams = {}
    for k, ms, _ in rows:
        fams[family(k)] = fams.get(family(k), 0.0) + ms
    return {"wall_ms": wall, "device_ms": sum(r[1] for r in rows),
            "launches": sum(r[2] for r in rows),
            "families": {f: round(ms, 2) for f, ms in sorted(
                fams.items(), key=lambda f: -f[1])},
            "top": [(k[:90], round(ms, 3), c) for k, ms, c in rows[:top]]}


def resnet_recipe(torch, K, model, init, x, y, steps=4, trace=False):
    """The repository's ResNet-50 recipe (bench.py _build_resnet_step):
    float32 masters, ``bf16_params`` inside the loss, bf16 images, the
    model's functional ``apply`` in training mode, ``CrossEntropyCriterion``
    on float32 logits, SGD(0.1, momentum=0.9) in place, the new running
    statistics written back. 1 warmup step, then ``steps`` on the same
    batch; launch counts are read per step. ``trace``: then two more steps
    under the profiler (:func:`trace_steps`)."""
    from bigdl_tpu_torch.convert import flatten, unflatten
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.module import assign_state
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.amp import bf16_params
    model.load_state_dict(init)
    params, mstate = model.params, model.state
    leaves = flatten(params)
    crit = CrossEntropyCriterion()
    optim = SGD(learningrate=0.1, momentum=0.9)
    opt_state = optim.init_state(params)

    def step():
        out, new_state = model.apply(bf16_params(params), mstate, x,
                                     training=True)
        loss = crit._forward(out.float(), y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        optim.update(unflatten(dict(zip(leaves, grads))), params, opt_state,
                     0.1)
        assign_state(mstate, new_state)
        return loss, grads

    conv2 = model[4].blocks[0].fused_conv2
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(fused_matmul_fwd=24, fused_matmul_bwd=24, fused_chain_fwd=12,
                fused_chain_bwd=12, fused_conv_fwd=16 if conv2 else 0)
    # every bf16 K3 / K4 / K5 launch on the tensor-core route
    fused = ("fused_matmul_fwd", "fused_matmul_bwd", "fused_chain_fwd",
             "fused_chain_bwd", "fused_conv_fwd")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, total = [], [], dict.fromkeys(want, 0)
    for i in range(steps + 1):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        check(counts == want, f"ResNet-50 step (fused_conv2={conv2}) "
              f"launched {counts}, expected {want}")
        routes = K.launches_by_route()
        check(all(only_on(routes[n], "bf16_sm90", want[n]) for n in fused),
              f"ResNet-50 step (fused_conv2={conv2}) launches by route "
              f"{routes}, expected all on bf16_sm90")
        check(torch.stack([torch.isfinite(g).all() for g in grads])
              .all().item(), f"non-finite gradient (fused_conv2={conv2})")
        losses.append(loss.item())
        if i > 0:                      # step 0 is the warmup
            times.append(dt)
            for n in total:
                total[n] += counts[n]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    moved = float(model[1].running_mean.abs().max())
    check(moved > 0, "the stem BatchNorm's running mean never moved")
    out = {"fused_conv2": conv2, "losses": losses,
           "step_s": statistics.median(times), "step_s_all": times,
           "max_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": total}
    if trace:
        out["trace"] = trace_steps(torch, step)
    return out


def resnet_local_optimizer(torch, K, model, init, B=32, S=224, iters=3):
    """The normal entry point: ``Optimizer.create`` (a LocalOptimizer) over
    a DataSet of image Samples (H, W, 3) with 1-based labels,
    CrossEntropyCriterion, SGD(0.1, momentum=0.9), float32 parameters."""
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger, max_iteration
    model.load_state_dict(init)
    rng = np.random.RandomState(4)
    imgs = rng.randn(B * iters, S, S, 3).astype(np.float32)
    labels = rng.randint(1, 1001, size=B * iters)
    samples = [Sample(imgs[i], labels[i]) for i in range(B * iters)]
    losses = []
    stop = max_iteration(iters)
    end = Trigger(lambda st: losses.append(st["loss"]) or stop(st))
    opt = Optimizer.create(model, DataSet.array(samples),
                           CrossEntropyCriterion(), end, batch_size=B,
                           optim_method=SGD(learningrate=0.1, momentum=0.9))
    before = model[1].running_mean.clone()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    routes = K.launches_by_route()
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(fused_matmul_fwd=24 * iters, fused_matmul_bwd=24 * iters,
                fused_chain_fwd=12 * iters, fused_chain_bwd=12 * iters)
    check(counts == want, f"ResNet-50 LocalOptimizer launched {counts}, "
          f"expected {want}")
    # float32 parameters: every K3 and K5 launch on the 3xTF32 route
    for n in ("fused_matmul_fwd", "fused_matmul_bwd", "fused_chain_fwd",
              "fused_chain_bwd"):
        check(only_on(routes[n], "f32_sm90", want[n]),
              f"ResNet-50 LocalOptimizer {n} launches by route {routes[n]}")
    check(len(losses) == iters and all(math.isfinite(v) for v in losses),
          f"ResNet-50 LocalOptimizer losses {losses}")
    check(not torch.equal(model[1].running_mean, before),
          "LocalOptimizer left the running statistics where they were")
    # two more iterations (a new Optimizer over the first two batches)
    # under the profiler: the device's busy time a step against the step
    again = Optimizer.create(model, DataSet.array(samples[:2 * B]),
                             CrossEntropyCriterion(), max_iteration(2),
                             batch_size=B,
                             optim_method=SGD(learningrate=0.1, momentum=0.9))
    trace = trace_steps(torch, again.optimize, n=1, per_call=2)
    return {"losses": losses, "wall_s": dt,
            "step_s": opt.metrics.values["step_time"], "launches": counts,
            "routes": routes, "trace": trace}


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "bigdl_tpu_torch")):
        fail("bigdl_tpu_torch not found beside chip_smoke.py: run from a "
             "checkout of the repository")
    sys.path.insert(0, root)
    import bigdl_tpu_torch.kernels as K
    from bigdl_tpu_torch.kernels import _build
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import (DecodeScheduler, ModelRegistry,
                                         PagedKVCache)
    from bigdl_tpu_torch.utils.amp import bf16_params

    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}", flush=True)
    print(f"    torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    build_s = _build.build_all()
    print(f"    kernel build: {build_s:.2f} s ({len(_build.SOURCES)} sources "
          f"in parallel)", flush=True)
    sm90_spills = {}
    for name in _build.SOURCES:     # nvcc -Xptxas -v, one line a library
        log = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", log)]
        if regs:
            print(f"    {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                  f"registers, static smem up to {max(smem or [0])} bytes, "
                  f"spill stores up to {max(spills or [0])} bytes")
        if name.endswith("_sm90"):
            sm90_spills[name] = max(spills or [-1])
            # ptxas note C7514: wgmma products serialised (a performance
            # loss, not an error)
            print(f"    {name}: wgmma serialisation notes (C7514): "
                  f"{log.count('C7514')}")

    # -- phase 2 ----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[2] kernels vs plain versions (allow_tf32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32})", flush=True)
    bf, f32 = torch.bfloat16, torch.float32
    # K1-fwd: bf16 (tensor-core route) at the three timed shapes (serving
    # prefill, prefill_chunked piece, training), ragged T, D = 32 and 128,
    # non-causal Tq != Tkv and kv_len = 0; float32 (3xTF32 route, D <= 112)
    # beside
    k1_main = flash_case(torch, K, 8, 16, 128, 128, 64, bf, True, 0, 128,
                         timed=True)
    flash_case(torch, K, 8, 16, 128, 128, 64, f32, True, 0, 128, False)
    flash_case(torch, K, 8, 16, 77, 77, 64, bf, True, 0, 77, False)
    flash_case(torch, K, 8, 16, 77, 77, 64, f32, True, 0, 77, False)
    flash_case(torch, K, 8, 16, 130, 130, 64, bf, True, 0, 130, False)
    flash_case(torch, K, 8, 16, 130, 130, 32, bf, True, 0, 130, False)
    flash_case(torch, K, 2, 8, 200, 200, 128, bf, True, 0, 200, False)
    flash_case(torch, K, 4, 16, 100, 260, 64, bf, False, 0, 260, False)
    flash_case(torch, K, 4, 16, 100, 260, 128, bf, False, 0, 200, False)
    flash_case(torch, K, 2, 4, 16, 64, 64, bf, False, 0, 0, False)
    flash_case(torch, K, 2, 4, 16, 64, 64, bf, True, 0, 0, False)
    k1_chunk = flash_case(torch, K, 8, 16, 32, 384, 64, bf, True, 96, 128,
                          timed=True)
    flash_case(torch, K, 8, 16, 32, 384, 64, f32, True, 96, 128, False)
    k1_train = flash_case(torch, K, 16, 16, 1024, 1024, 64, bf, True, 0,
                          1024, timed=True)
    # the float32 route at the LocalOptimizer shape (phase 6: B8/T256) and
    # at T = 1024, each also on the CUDA-core route; then a head dim past
    # the 3xTF32 kernel's widest (112), which stays on the CUDA cores
    k1_f32 = flash_case(torch, K, 8, 16, 256, 256, 64, f32, True, 0, 256,
                        timed=True)
    k1_f32_long = flash_case(torch, K, 2, 16, 1024, 1024, 64, f32, True, 0,
                             1024, timed=True)
    k1_f32_wide = flash_case(torch, K, 8, 16, 256, 256, 128, f32, True, 0,
                             256, timed=True)
    check(k1_f32["route"] == k1_f32_long["route"] == "f32_sm90"
          and k1_f32_wide["route"] == "f32",
          f"float32 flash routes {k1_f32['route']}, {k1_f32_long['route']}, "
          f"{k1_f32_wide['route']}: expected f32_sm90 at D = 64, f32 at 128")
    # K1-bwd: bf16 at the training shape, ragged T, D = 32 and 128, the
    # ring form (external delta, float32 gradients); float32 beside: the
    # 3xTF32 route (D <= 64) timed at phase 6's shape and at T = 1024 (each
    # also on the CUDA-core route), ragged and non-causal, the ring form,
    # and D = 96 past its widest (the CUDA-core route, timed)
    k1b_main = bwd_case(torch, K, 16, 16, 1024, 64, bf, True, timed=True)
    k1b_f32 = bwd_case(torch, K, 8, 16, 256, 64, f32, True, timed=True)
    k1b_f32_long = bwd_case(torch, K, 2, 16, 1024, 64, f32, True, timed=True)
    bwd_case(torch, K, 8, 16, 77, 64, bf, True, False)
    bwd_case(torch, K, 8, 16, 77, 64, f32, False, False)
    bwd_case(torch, K, 4, 16, 130, 32, bf, True, False)
    bwd_case(torch, K, 4, 16, 130, 32, bf, False, False)
    bwd_case(torch, K, 4, 16, 130, 32, f32, False, False)
    bwd_case(torch, K, 2, 8, 200, 128, bf, True, False)
    bwd_case(torch, K, 2, 8, 200, 128, f32, True, False)
    bwd_case(torch, K, 4, 16, 300, 64, bf, False, False, ring=True)
    bwd_case(torch, K, 4, 16, 300, 64, f32, True, False, ring=True)
    k1b_f32_wide = bwd_case(torch, K, 8, 8, 256, 96, f32, True, timed=True)
    check(k1b_f32["route"] == k1b_f32_long["route"] == "f32_sm90"
          and k1b_f32_wide["route"] == "f32",
          f"float32 flash backward routes {k1b_f32['route']}, "
          f"{k1b_f32_long['route']}, {k1b_f32_wide['route']}: expected "
          f"f32_sm90 at D = 64, f32 at 96")
    # K2 (split-K) at the decode shape in float32 and bf16 pages and at
    # positions up to 4096, timed with the kernel it succeeds; the chunk
    # form (S = 32); GQA; a table one split wide (no combine kernel)
    k2_main = paged_case(torch, K, 8, 16, 16, 1, 64, 16, f32, timed=True)
    k2_bf16 = paged_case(torch, K, 8, 16, 16, 1, 64, 16, bf, timed=True)
    k2_long = paged_case(torch, K, 8, 16, 16, 1, 64, 16, f32, timed=True,
                         max_pos=4096)
    k2_chunk = paged_case(torch, K, 1, 16, 16, 32, 64, 16, f32, timed=True)
    for kvh in (16, 4):
        for S in (1, 32):
            for pdt in (f32, bf):
                paged_case(torch, K, 8, 16, kvh, S, 64, 16, pdt, False)
    k2_one = paged_case(torch, K, 8, 16, 16, 1, 64, 16, f32, False,
                        max_pos=48)
    check(k2_one["splits"] == 1 and k2_main["splits"] > 1
          and all(r["route"] == "f32_split"
                  for r in (k2_main, k2_long, k2_chunk, k2_one))
          and k2_bf16["route"] == "bf16_split",
          f"K2 routes / splits {[(r['route'], r['splits']) for r in (k2_main, k2_bf16, k2_long, k2_chunk, k2_one)]}")
    check("paged_combine_kernel" in k2_main["launch_ms"],
          f"K2 decode case launched {k2_main['launch_ms']}")
    # head dims: every instantiation the first cases left out (each
    # multiple of 16 up to 128 on the bf16 flash kernels, up to 112 on the
    # float32 flash forward's 3xTF32 route and up to 256 on its CUDA-core
    # route and on K2, up to 64 on the float32 backward's 3xTF32 route and
    # up to 192 on its CUDA-core route) and the padded route of each kernel
    # (a D not a multiple of 16), each against its plain version; then the
    # launches by route
    K.reset_launch_counts()
    new_dims = [d for d in range(16, 257, 16) if d not in (32, 64, 128)]
    for D in new_dims:
        flash_case(torch, K, 2, 4, 77, 77, D, f32, True, 0, 77, False)
        paged_case(torch, K, 4, 8, 4, 1, D, 16, f32, False)
        if D <= 192:
            bwd_case(torch, K, 2, 4, 77, D, f32, True, False)
        if D <= 128:
            flash_case(torch, K, 2, 4, 77, 77, D, bf, True, 0, 77, False)
            bwd_case(torch, K, 2, 4, 77, D, bf, True, False)
            paged_case(torch, K, 4, 8, 4, 1, D, 16, bf, False)
    flash_case(torch, K, 2, 4, 77, 77, 40, f32, True, 0, 77, False)
    bwd_case(torch, K, 2, 4, 77, 40, f32, False, False)
    flash_case(torch, K, 4, 4, 100, 260, 40, bf, False, 0, 200, False)
    bwd_case(torch, K, 2, 4, 77, 100, bf, True, False)
    paged_case(torch, K, 4, 8, 4, 4, 40, 16, f32, False)
    hd_routes = K.launches_by_route()
    n_f32 = len(new_dims)
    n_bwd = len([d for d in new_dims if d <= 192])
    n_bf = len([d for d in new_dims if d <= 128])
    n_tc = len([d for d in new_dims if d <= 112])
    n_tcb = len([d for d in new_dims if d <= 64])
    # float32: flash_case launches the forward once, bwd_case the forward
    # once (3xTF32 up to D = 112) and the backward twice (the rerun check,
    # 3xTF32 up to D = 64); paged_case launches K2 twice (the rerun check)
    hd_want = {
        "flash_fwd": {"bf16_sm90": 2 * n_bf, "bf16_sm90_padded": 2,
                      "f32_sm90": 2 * n_tc, "f32_sm90_padded": 2,
                      "f32": n_f32 + n_bwd - 2 * n_tc, "f32_padded": 0},
        "flash_bwd": {"bf16_sm90": 2 * n_bf, "bf16_sm90_padded": 2,
                      "f32_sm90": 2 * n_tcb, "f32_sm90_padded": 2,
                      "f32": 2 * (n_bwd - n_tcb), "f32_padded": 0},
        "paged_attention": {"f32_split": 2 * n_f32, "f32_split_padded": 2,
                            "bf16_split": 2 * n_bf, "bf16_split_padded": 0,
                            "f32": 0, "f32_padded": 0, "bf16": 0,
                            "bf16_padded": 0}}
    print(f"    head dims {new_dims} (bf16 flash and K2 up to 128, float32 "
          f"forward on 3xTF32 up to 112, float32 backward on 3xTF32 up to "
          f"64 and up to 192), padded D = 40 / 100; launches by route "
          f"{ {n: hd_routes[n] for n in hd_want} }", flush=True)
    check(all(hd_routes[n] == r for n, r in hd_want.items()),
          f"head-dim cases launched {hd_routes}, expected {hd_want}")
    # a TransformerLM with hidden 768 and 8 heads (D = 96) at the training
    # shape, both passes, timed
    k1_d96 = flash_case(torch, K, 16, 8, 1024, 1024, 96, bf, True, 0, 1024,
                        timed=True)
    k1b_d96 = bwd_case(torch, K, 16, 8, 1024, 96, bf, True, timed=True)
    # the fused ResNet kernels: small and ragged shapes in both dtypes,
    # then the three timed ResNet-50 shapes at B256/224
    for dt in (f32, bf):
        k3_case(torch, K, 300, 24, 40, dt, True, True, True, False)
        k3_case(torch, K, 257, 130, 70, dt, False, False, True, False)
        k3_case(torch, K, 129, 16, 8, dt, True, False, False, False)
        k5_case(torch, K, 2, 5, 48, 24, dt, False)
        k4_case(torch, K, 2, 8, 16, 24, 1, dt, False)
        k4_case(torch, K, 2, 7, 32, 40, 2, dt, False)
    # bf16 pad taps that would give relu(b) = 1 or 2 if the prologue came
    # after the padding, at stride 1 and 2 and with C not a multiple of 64
    k4_case(torch, K, 2, 7, 64, 64, 1, bf, False, bias=1.0)
    k4_case(torch, K, 2, 9, 64, 64, 2, bf, False, bias=1.0)
    k4_case(torch, K, 2, 9, 72, 16, 1, bf, False, bias=2.0)
    # K5 on the tensor cores: M = 147 (not a multiple of 128) without
    # statistics, the ReLU's tie (u == 0 on every other channel), and a
    # bf16 shape outside the rule (K, N not multiples of 8: bf16_ragged)
    k5_case(torch, K, 3, 7, 256, 64, bf, False, stats=False)
    k5_case(torch, K, 3, 7, 256, 64, bf, False, tie=True)
    k5_case(torch, K, 2, 5, 44, 20, bf, False)
    # K3 and K5 in float32: the 3xTF32 route (K and N multiples of 4) at M
    # = 147 without statistics, contraction and column tails (K = 20 and
    # 132, N = 36 and 68) and the ReLU's tie; the CUDA-core route for K or
    # N not a multiple of 4; K4 in float32 on the 3xTF32 route (C a
    # multiple of 32) at pad taps where relu(b) = 1, stride 1 and 2, and on
    # the CUDA-core route at C = 72; then the launches by route (each K3 /
    # K5 case launches the forward and the backward twice, each K4 case the
    # forward twice: the rerun check)
    K.reset_launch_counts()
    k3_case(torch, K, 147, 64, 256, f32, True, True, False, False)
    k3_case(torch, K, 200, 20, 36, f32, True, True, True, False)
    k3_case(torch, K, 257, 132, 68, f32, False, False, True, False)
    k3_case(torch, K, 257, 130, 70, f32, False, False, True, False)
    k5_case(torch, K, 3, 7, 256, 64, f32, False, stats=False)
    k5_case(torch, K, 3, 7, 256, 64, f32, False, tie=True, nan_h=True)
    k5_case(torch, K, 2, 5, 42, 20, f32, False)
    k4_case(torch, K, 2, 7, 64, 64, 1, f32, False, bias=1.0)
    k4_case(torch, K, 2, 9, 64, 64, 2, f32, False, bias=1.0)
    k4_case(torch, K, 2, 9, 72, 16, 1, f32, False, bias=2.0)
    f32_routes = K.launches_by_route()
    f32_want = {"fused_matmul_fwd": {"f32_sm90": 6, "f32": 2},
                "fused_matmul_bwd": {"f32_sm90": 6, "f32": 2},
                "fused_chain_fwd": {"f32_sm90": 4, "f32": 2},
                "fused_chain_bwd": {"f32_sm90": 4, "f32": 2},
                "fused_conv_fwd": {"f32_sm90": 4, "f32": 2}}
    print(f"    float32 K3 / K4 / K5 cases, launches by route "
          f"{ {n: f32_routes[n] for n in f32_want} }", flush=True)
    check(all(f32_routes[n] == {r: w.get(r, 0) for r in f32_routes[n]}
              for n, w in f32_want.items()),
          f"float32 K3 / K4 / K5 cases launched {f32_routes}, expected "
          f"{f32_want}")
    # every ResNet-50 B256/224 shape of K3, K4 and K5, checked and timed
    fam, recs = resnet_shapes(torch, K)
    k3_s0, k3_s3, k5_s0 = recs["s0 conv3"], recs["s3 proj"], recs["s0 junction"]
    k4_s0, k4_s1 = recs["s0 3x3"], recs["s1 3x3/2"]
    # the float32 routes at phase 8's shapes (B32): every K3, K4 and K5
    # shape on the 3xTF32 route, then on the CUDA-core route
    (fam32, fam_cc), (recs32, recs_cc) = resnet_shapes_f32(torch, K)
    k3_f32, k5_f32 = recs32["s0 conv3"], recs32["s0 junction"]
    k4_f32 = recs32["s0 3x3"]
    # the CUDA-core route's row (now taken by K4 float32 shapes with C not
    # a multiple of 32 only) at the same shape; the plain version is the
    # same function on the same inputs
    k4_cc = dict(recs_cc["s0 3x3"], plain_ms=k4_f32["plain_ms"])
    # the K5 bf16 stage-0 junction's limits (ms a call)
    check(k5_s0["fwd"]["ms"] <= 1.0 and k5_s0["bwd"]["ms"] <= 3.0,
          f"K5 stage-0 junction over its limits (1.0 ms forward, 3.0 ms "
          f"backward): {k5_s0['fwd']['ms']:.4f} / {k5_s0['bwd']['ms']:.4f}")
    # the 3xTF32 stage-0 limits at B32 (ms a call)
    f32_ms = {"K3 fwd": k3_f32["fwd"]["ms"], "K3 bwd": k3_f32["bwd"]["ms"],
              "K5 fwd": k5_f32["fwd"]["ms"], "K5 bwd": k5_f32["bwd"]["ms"]}
    print(f"    3xTF32 stage-0 B32 ms {f32_ms}, limits {F32_LIMITS}",
          flush=True)
    check(all(f32_ms[k] <= v for k, v in F32_LIMITS.items()),
          f"3xTF32 stage-0 B32 calls over their limits {F32_LIMITS}: "
          f"{f32_ms}")
    # the float32 flash forward and K4 on 3xTF32 against one library call
    # computing the same function, timed in this run: SDPA at phase 6's
    # shape, cuDNN's float32 conv (TF32 off) at stage 0, B32
    lib_ms = {"K1-fwd f32 (8,16,256,64)": (k1_f32["ms"], k1_f32["library_ms"]),
              "K1-bwd f32 (8,16,256,64)": (k1b_f32["ms"],
                                           k1b_f32["library_ms"]),
              "K4 f32 s0 B32": (k4_f32["ms"], k4_f32["library_ms"])}
    print(f"    3xTF32 (ms, library ms) {lib_ms}", flush=True)
    check(all(ms < lib for ms, lib in lib_ms.values()),
          f"3xTF32 flash forward, backward or K4 not faster than the "
          f"library call: {lib_ms}")
    # K2's split-K kernel against the kernel it succeeds, same call
    k2_gain = {n: r["unsplit_ms"] / r["ms"] for n, r in (
        ("decode", k2_main), ("decode bf16", k2_bf16), ("long", k2_long),
        ("chunk", k2_chunk))}
    print(f"    K2 split-K speed-up over paged_attention.cu {k2_gain}; long "
          f"context at {k2_long['hbm_share']:.1%} of its bytes bound",
          flush=True)
    check(k2_gain["decode"] >= 3.0 and k2_gain["chunk"] > 1.0,
          f"K2 split-K under 3x the unsplit kernel at decode, or slower at "
          f"the chunk: {k2_gain}")

    # -- phase 3: generate on the flagship model ---------------------------
    V, L, B, TP, NEW = 32000, 12, 8, 128, 32
    t0 = time.perf_counter()
    model = TransformerLM(vocab_size=V, hidden_size=1024, num_heads=16,
                          filter_size=4096, num_layers=L, max_len=512,
                          seed=0)
    with torch.no_grad():      # serving weights are leaves
        params = bf16_params(model.params)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[3] flagship TransformerLM: {n_params / 1e6:.1f}M params, bf16 "
          f"weights, built in {time.perf_counter() - t0:.1f} s", flush=True)
    prompt = np.random.RandomState(0).randint(1, V, (B, TP)).astype(np.int32)
    model.generate(params, prompt[:, :16], 2)          # library warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(params, prompt, NEW)
    torch.cuda.synchronize()
    dt_gen = time.perf_counter() - t0
    gen_counts = K.launch_counts()
    check(tuple(out.shape) == (B, TP + NEW), f"generate shape {out.shape}")
    check(bool(((out >= 0) & (out < V)).all()), "generate: ids out of range")
    check(torch.equal(out[:, :TP].cpu(), torch.from_numpy(prompt).long()),
          "generate: prompt not preserved")
    # generate = one causal prefill (one flash launch per layer), then
    # single-token dense decode steps, which take no kernel
    gen_routes = K.launches_by_route()
    check(gen_counts["flash_fwd"] == L, f"generate launched the flash kernel "
          f"{gen_counts['flash_fwd']} times, expected {L}")
    check(only_on(gen_routes["flash_fwd"], "bf16_sm90", L),
          f"generate's flash launches by route: {gen_routes}")
    lp, _ = model.prefill(params, prompt, TP + NEW)
    CH = 32
    K.reset_launch_counts()
    lc, _ = model.prefill_chunked(params, prompt, TP + NEW, chunk=CH)
    torch.cuda.synchronize()
    chunk_counts = K.launch_counts()
    chunk_routes = K.launches_by_route()
    check(only_on(chunk_routes["flash_fwd"], "bf16_sm90", L * -(-TP // CH)),
          f"prefill_chunked's flash launches by route: {chunk_routes}")
    check(chunk_counts["flash_fwd"] == L * -(-TP // CH),
          f"prefill_chunked launched the flash kernel "
          f"{chunk_counts['flash_fwd']} times, expected {L * -(-TP // CH)}")
    check(torch.isfinite(lp.float()).all().item()
          and torch.isfinite(lc.float()).all().item(), "non-finite logits")
    diff = (lp.float() - lc.float()).abs().max().item()
    scale = lp.float().abs().max().item()
    # the two forms differ only in how the projections and the attention
    # are cut into rows; bf16 keeps 8 significant bits (2^-8 = 0.4%), so a
    # few roundings apart stay well under 1% of the largest logit
    tol = 1e-2 * max(scale, 1.0)
    print(f"    generate: {B}x{NEW} new tokens in {dt_gen:.3f} s = "
          f"{B * NEW / dt_gen:.1f} tokens/s (prefill included); launches "
          f"{gen_counts}; prefill_chunked (chunk {CH}) launches "
          f"{chunk_counts}; prefill vs prefill_chunked last logits max "
          f"|diff| {diff:.4g} (|logits| <= {scale:.3g}, tol {tol:.3g})",
          flush=True)
    check(diff <= tol, "prefill and prefill_chunked disagree")

    # -- phase 4: continuous-batching serving ------------------------------
    rng = np.random.RandomState(1)
    n_req = 16
    prompts = [rng.randint(1, V, rng.randint(32, 257)).astype(np.int32)
               for _ in range(n_req)]
    budgets = [int(rng.randint(16, 65)) for _ in range(n_req)]
    reg = ModelRegistry(device=model.device)
    reg.publish(params, version="bf16", activate=True)
    t0 = time.perf_counter()
    sched = DecodeScheduler(model, max_slots=8, block_size=16,
                            max_seq_len=384, registry=reg).start()
    t_warm = time.perf_counter() - t0
    torch.cuda.synchronize()
    K.reset_launch_counts()        # after start()'s warmup dispatches
    t0 = time.perf_counter()
    futs = [sched.submit(p, n) for p, n in zip(prompts, budgets)]
    results = [f.result(600) for f in futs]
    dt_serve = time.perf_counter() - t0
    sched.shutdown()
    torch.cuda.synchronize()
    serve_counts = K.launch_counts()
    st = sched.stats()
    traces = [f.trace for f in futs]
    ttft = sorted(t["ttft_ms"] for t in traces)
    n_tok = sum(r.size for r in results)
    print(f"[4] DecodeScheduler: {n_req} requests, prompts 32-256, budgets "
          f"16-64, warmup {t_warm:.2f} s; {n_tok} tokens in {dt_serve:.3f} s"
          f" = {n_tok / dt_serve:.1f} tokens/s; TTFT ms p50 "
          f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; decode steps "
          f"{st['decode_steps']}, prefill chunks {st['prefill_chunks']}; "
          f"launches {serve_counts}", flush=True)
    check(st["kv"]["blocks_in_use"] == 0, "KV blocks leaked")
    check(sched.audit()["ok"], "KV ledger audit failed")
    check(serve_counts["paged_attention"] > 0, "serving path never "
          "launched the paged-attention kernel")
    serve_routes = K.launches_by_route()["paged_attention"]
    check(only_on(serve_routes, "f32_split", serve_counts["paged_attention"]),
          f"serving's K2 launches by route {serve_routes}, expected all on "
          f"f32_split (the pool's float32 pages)")
    margin_tol = 0.1     # bf16 logits through two paths (dense vs paged)
    compared = 0
    for i, (p, n, r) in enumerate(zip(prompts, budgets, results)):
        check(r.size == n, f"request {i}: {r.size} of {n} tokens")
        solo, margins = solo_greedy(torch, model, params, p, n)
        for t in range(n):
            if margins[t] < margin_tol:
                break
            check(int(r[t]) == solo[t], f"request {i} step {t}: served "
                  f"{int(r[t])}, solo {solo[t]} (margin {margins[t]:.3g})")
            compared += 1
    check(compared > 0, "no served step cleared the margin")

    # one serving decode step at the full bucket, eager (host-paced) and
    # replayed as a CUDA graph (device time only): the gap is host overhead
    kv = PagedKVCache(model, num_blocks=8 * 24 + 1, block_size=16,
                      max_blocks_per_seq=24)
    tbl = torch.arange(1, 8 * 24 + 1, dtype=torch.int32,
                       device="cuda").reshape(8, 24)
    posv = torch.full((8,), 256, dtype=torch.int32, device="cuda")
    tok = torch.from_numpy(prompt[:, :1]).cuda()
    step = lambda i: model.decode_paged(params, tok, posv, kv.pages(), tbl)
    host = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(0)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    dev_ms = graph_ms(torch, step, 1, reps=5)
    print(f"    decode step (bucket 8, pos 256, 12 layers): eager "
          f"{statistics.median(host[2:]):.3f} ms wall, CUDA-graph replay "
          f"{dev_ms:.3f} ms device", flush=True)
    print(f"    served tokens equal solo decode on {compared} steps "
          f"(each request up to its first top-2 margin < {margin_tol})",
          flush=True)
    del sched, kv, model, params
    torch.cuda.empty_cache()

    # -- phase 5: the bf16 training recipe on the flagship ------------------
    TB, TT = 16, 1024
    t0 = time.perf_counter()
    tmodel = TransformerLM(vocab_size=V, hidden_size=1024, num_heads=16,
                           filter_size=4096, num_layers=L, max_len=TT, seed=0)
    init = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    print(f"[5] training recipe, flagship at B{TB}/T{TT} (model built in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    ids = np.random.RandomState(0).randint(1, V, (TB, TT + 1))
    tx = torch.from_numpy(ids[:, :-1]).cuda()
    ty = torch.from_numpy(ids[:, 1:]).cuda()
    attn_ms = L * (k1_train["ms"] + k1b_main["ms"])
    arms = []
    for remat in (False, True):
        r = train_recipe(torch, K, tmodel, init, tx, ty, remat)
        r["tokens_per_s"] = TB * TT / r["step_s"]
        fwd_extra = L * k1_train["ms"] if remat else 0.0
        r["attention_share"] = (attn_ms + fwd_extra) / (r["step_s"] * 1e3)
        arms.append(r)
        print(f"    remat={remat}: losses {[round(v, 4) for v in r['losses']]}"
              f"; step {r['step_s'] * 1e3:.1f} ms (median of 5; all "
              f"{[round(t * 1e3, 1) for t in r['step_s_all']]}) = "
              f"{r['tokens_per_s']:.0f} tokens/s (smoke reading); peak "
              f"memory {r['max_mem_gb']:.2f} GiB; launches over the 5 "
              f"steps {r['launches']}; {L} x (K1-fwd "
              f"{k1_train['ms']:.3f}{' x 2' if remat else ''} + K1-bwd "
              f"{k1b_main['ms']:.3f} ms) = {r['attention_share']:.1%} of "
              f"the step", flush=True)

    # -- phase 6: the normal entry point ------------------------------------
    r6 = local_optimizer_run(torch, K, tmodel, init, V)
    print(f"[6] LocalOptimizer, flagship width, B8/T256, float32 params, "
          f"SGD(0.01, momentum=0.9), 4 iterations: losses "
          f"{[round(v, 4) for v in r6['losses']]}; {r6['wall_s']:.2f} s "
          f"(first step {r6['step_s'][0] * 1e3:.0f} ms, then "
          f"{[round(t * 1e3) for t in r6['step_s'][1:]]} ms); launches "
          f"{r6['launches']}", flush=True)

    del tmodel, init
    torch.cuda.empty_cache()

    # -- phase 7: ResNet-50, card against CPU, then the bf16 recipe ----------
    from bigdl_tpu_torch.models import ResNet50
    r7, truth = resnet_card_vs_cpu(torch, K, torch.float32)
    r7b, _ = resnet_card_vs_cpu(torch, K, torch.bfloat16, truth)
    RB, RS = 256, 224
    rng = np.random.RandomState(0)
    rx = torch.from_numpy(rng.randn(RB, RS, RS, 3).astype(
        np.float32)).to("cuda", torch.bfloat16)
    ry = torch.from_numpy(rng.randint(1, 1001, size=RB)).cuda()
    rn_arms = []
    for conv2 in (False, True):
        t0 = time.perf_counter()
        rmodel = ResNet50(format="NHWC", fused="pallas", fused_conv2=conv2,
                          seed=0)
        if not conv2:
            rinit = {k: v.detach().clone()
                     for k, v in rmodel.state_dict().items()}
        built = time.perf_counter() - t0
        r = resnet_recipe(torch, K, rmodel, rinit, rx, ry,
                          trace=not conv2)
        r["images_per_s"] = RB / r["step_s"]
        rn_arms.append(r)
        print(f"    ResNet-50 B{RB}/{RS} bf16 recipe, fused_conv2={conv2} "
              f"(built in {built:.1f} s): losses "
              f"{[round(v, 4) for v in r['losses']]}; step "
              f"{r['step_s'] * 1e3:.1f} ms (median of 4; all "
              f"{[round(t * 1e3, 1) for t in r['step_s_all']]}) = "
              f"{r['images_per_s']:.1f} images/s (smoke reading); peak "
              f"memory {r['max_mem_gb']:.2f} GiB; launches over the 4 steps "
              f"{r['launches']}", flush=True)
        if "trace" in r:
            tr = r["trace"]
            busy = tr["device_ms"] / (r["step_s"] * 1e3)
            print(f"    traced (torch.profiler, 2 more steps): "
                  f"{tr['device_ms']:.1f} ms of CUDA kernels a step in "
                  f"{tr['launches']:.0f} launches = {busy:.1%} of the "
                  f"untraced median step (profiled wall "
                  f"{tr['wall_ms']:.1f} ms); ms a step by family "
                  f"{tr['families']}; largest kernels (ms a step, "
                  f"launches a step): {tr['top']}", flush=True)
        del rmodel
        torch.cuda.empty_cache()

    # -- phase 8: ResNet-50 through the normal entry point --------------------
    r8 = resnet_local_optimizer(
        torch, K, ResNet50(format="NHWC", fused="pallas", seed=0), rinit)
    print(f"[8] Optimizer.create (LocalOptimizer), ResNet-50, B32/224 image "
          f"Samples, float32 params, SGD(0.1, momentum=0.9), 3 iterations: "
          f"losses {[round(v, 4) for v in r8['losses']]}; {r8['wall_s']:.2f} "
          f"s (steps {[round(t * 1e3) for t in r8['step_s']]} ms); launches "
          f"{r8['launches']}", flush=True)
    tr = r8["trace"]
    print(f"    traced (torch.profiler, 2 more iterations): "
          f"{tr['device_ms']:.1f} ms of CUDA kernels a step in "
          f"{tr['launches']:.0f} launches (profiled wall {tr['wall_ms']:.1f} "
          f"ms a step); ms a step by family {tr['families']}; largest "
          f"kernels (ms a step, launches a step): {tr['top'][:10]}",
          flush=True)

    def kernel_rec(name, source, replaces, rec, launches):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"],
               "library_ms": rec["library_ms"]}
        if "route" in rec:          # the wrapper's route (dtype, shape rule)
            out["dtype_route"] = rec["route"]
        if "cuda_core_ms" in rec:   # a 3xTF32 row's CUDA-core route, same call
            out["cuda_core_ms"] = rec["cuda_core_ms"]
        if "launch_ms" in rec:      # ms covers these launches (profiler)
            out["launch_ms"] = rec["launch_ms"]
        if "unsplit_ms" in rec:     # K2: the kernel it succeeds, same call
            out["unsplit_ms"] = rec["unsplit_ms"]
        return out

    for name, rec in (
            ("flash_fwd serving prefill (8x16, T=128, causal, bf16)", k1_main),
            ("flash_fwd chunk form (8x16, S=32, q_offset=96, kv_len=128)",
             k1_chunk),
            ("flash_fwd training shape (16x16, T=1024, causal, bf16)",
             k1_train),
            ("flash_fwd float32 3xTF32 route, split + attention kernel "
             "(8x16, T=256, causal)", k1_f32),
            ("flash_fwd float32 3xTF32 route (2x16, T=1024, causal)",
             k1_f32_long),
            ("flash_fwd float32 CUDA-core route, D=128 (8x16, T=256, causal)",
             k1_f32_wide),
            ("flash_bwd training shape (16x16, T=1024, causal, bf16)",
             k1b_main),
            ("flash_bwd float32 3xTF32 route, dK/dV + dQ kernels (8x16, "
             "T=256, causal)", k1b_f32),
            ("flash_bwd float32 3xTF32 route (2x16, T=1024, causal)",
             k1b_f32_long),
            ("flash_bwd float32 CUDA-core route, D=96 (8x8, T=256, causal)",
             k1b_f32_wide),
            ("flash_fwd D=96 (16x8, T=1024, causal, bf16)", k1_d96),
            ("flash_bwd D=96 (16x8, T=1024, causal, bf16)", k1b_d96)):
        print(f"    {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
              f"sdpa {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
              f"({rec['bound_by']})"
              + (f", host call {rec['host_ms']:.4f} ms" if "host_ms" in rec
                 else "")
              + (f" (delta op {rec['delta_ms']:.4f} ms, kernel pair "
                 f"{rec['kernels_ms']:.4f} ms)" if "delta_ms" in rec else "")
              + (f"; CUDA-core route {rec['cuda_core_ms']:.4f} ms (bound "
                 f"{rec['cuda_core_bound_ms']:.4f})" if "cuda_core_ms" in rec
                 else "")
              + (f"; launches (profiler, ms a call) {rec['launch_ms']}"
                 if "launch_ms" in rec else ""))
    for name, rec in (
            ("K2 decode (8x16, S=1, f32 pages, positions 32-320)", k2_main),
            ("K2 decode (8x16, S=1, bf16 pages, positions 32-320)", k2_bf16),
            ("K2 long decode (8x16, S=1, f32 pages, positions 32-4096)",
             k2_long),
            ("K2 chunk (1x16, S=32, f32 pages, positions 32-320)",
             k2_chunk)):
        print(f"    {name}: {rec['ms']:.4f} ms in {rec['splits']} splits of "
              f"{rec['span']} keys, plain {rec['plain_ms']:.4f}, unsplit "
              f"kernel {rec['unsplit_ms']:.4f}, bound {rec['bound_ms']:.4f} "
              f"({rec['bound_by']}, {rec['hbm_share']:.1%}); launches "
              f"(profiler, ms a call) {rec['launch_ms']}")
    off, on = rn_arms[0]["launches"], rn_arms[1]["launches"]
    for name, rec in (("K3-nhwc stage-0 conv3 fwd", k3_s0["fwd"]),
                      ("K3-nhwc stage-0 conv3 bwd", k3_s0["bwd"]),
                      ("K3 stage-3 projection fwd", k3_s3["fwd"]),
                      ("K5 stage-0 junction fwd", k5_s0["fwd"]),
                      ("K5 stage-0 junction bwd", k5_s0["bwd"]),
                      ("K3 float32 stage-0 conv3 fwd (B32)", k3_f32["fwd"]),
                      ("K3 float32 stage-0 conv3 bwd (B32)", k3_f32["bwd"]),
                      ("K5 float32 stage-0 junction fwd (B32)", k5_f32["fwd"]),
                      ("K5 float32 stage-0 junction bwd (B32)", k5_f32["bwd"]),
                      ("K4 stage-0 3x3", k4_s0), ("K4 stage-1 3x3/2", k4_s1),
                      ("K4 float32 stage-0 3x3 (B32)", k4_f32),
                      ("K4 float32 stage-0 3x3 (B32), CUDA-core route",
                       k4_cc)):
        print(f"    {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
              f"bare product {rec['library_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f} ({rec['bound_by']})"
              + (f"; launches (profiler, ms a call) {rec['launch_ms']}"
                 if "launch_ms" in rec else ""))
    # launches x ms of each fused family over the ResNet-50 shapes, against
    # the measured steps (K4 runs in the fused_conv2 arm only)
    step_off, step_on = (r["step_s"] * 1e3 for r in rn_arms)
    for f, rows in fam.items():
        tot = sum(n * r["ms"] for _, n, r in rows)
        lib = sum(n * r["library_ms"] for _, n, r in rows)
        bnd = sum(n * r["bound_ms"] for _, n, r in rows)
        step = step_on if f == "K4" else step_off
        print(f"    {f}: {sum(n for _, n, _ in rows)} launches a step, "
              f"sum of launches x ms {tot:.3f} ms = {tot / step:.1%} of the "
              f"{step:.1f} ms step (fused_conv2={f == 'K4'}); library "
              f"{lib:.3f} ms, bound {bnd:.3f} ms", flush=True)
    # the same for the float32 K3, K4 and K5 calls at B32 against phase 8's
    # steps (the median of the steps after the first; K4 runs only with
    # fused_conv2, which phase 8 leaves off)
    step8 = statistics.median(r8["step_s"][1:]) * 1e3
    tot32 = tot_cc = 0.0
    for f, rows in fam32.items():
        tot = sum(n * r["ms"] for _, n, r in rows)
        cc = sum(n * r["ms"] for _, n, r in fam_cc[f])
        if f != "K4":
            tot32 += tot
            tot_cc += cc
        share = ("with fused_conv2 only, not in phase 8's step" if f == "K4"
                 else f"{tot / step8:.1%} of phase 8's {step8:.1f} ms step")
        print(f"    float32 {f} (B32): {sum(n for _, n, _ in rows)} launches "
              f"a step, sum of launches x ms {tot:.3f} ms = {share} "
              f"(CUDA-core route {cc:.3f} ms); library "
              f"{sum(n * r['library_ms'] for _, n, r in rows):.3f} ms, bound "
              f"{sum(n * r['bound_ms'] for _, n, r in rows):.3f} ms",
              flush=True)
    print(f"    float32 K3 + K5 a B32 step: {tot32:.3f} ms = "
          f"{tot32 / step8:.1%} of phase 8's step (CUDA-core route "
          f"{tot_cc:.3f} ms)", flush=True)
    # the tensor-core kernels keep their accumulators in registers: ptxas
    # must report no spill (-1: no build log)
    check(all(v == 0 for v in sm90_spills.values()),
          f"spill stores (bytes) in the tensor-core libraries: {sm90_spills}")
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": [
        kernel_rec("flash_fwd", "bigdl_tpu_torch/csrc/flash_fwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_main,
                   gen_counts["flash_fwd"]),
        kernel_rec("flash_fwd_chunk",
                   "bigdl_tpu_torch/csrc/flash_fwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_chunk,
                   chunk_counts["flash_fwd"]),
        kernel_rec("flash_fwd_train",
                   "bigdl_tpu_torch/csrc/flash_fwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_train,
                   arms[0]["launches"]["flash_fwd"]),
        kernel_rec("flash_bwd", "bigdl_tpu_torch/csrc/flash_bwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:263", k1b_main,
                   arms[0]["launches"]["flash_bwd"]),
        kernel_rec("flash_fwd_f32",
                   "bigdl_tpu_torch/csrc/flash_fwd_tf32_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_f32,
                   r6["routes"]["flash_fwd"]["f32_sm90"]),
        kernel_rec("flash_fwd_f32_cuda_cores",
                   "bigdl_tpu_torch/csrc/flash_fwd.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_f32_wide,
                   r6["routes"]["flash_fwd"]["f32"]),
        kernel_rec("flash_bwd_f32",
                   "bigdl_tpu_torch/csrc/flash_bwd_tf32_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:263", k1b_f32,
                   r6["routes"]["flash_bwd"]["f32_sm90"]),
        kernel_rec("flash_bwd_f32_cuda_cores",
                   "bigdl_tpu_torch/csrc/flash_bwd.cu",
                   "bigdl_tpu/kernels/flash_attention.py:263", k1b_f32_wide,
                   r6["routes"]["flash_bwd"]["f32"]),
        kernel_rec("paged_attention",
                   "bigdl_tpu_torch/csrc/paged_attention_sm90.cu",
                   "bigdl_tpu/kernels/paged_attention.py:107", k2_main,
                   serve_routes["f32_split"]),
        kernel_rec("paged_attention_long",
                   "bigdl_tpu_torch/csrc/paged_attention_sm90.cu",
                   "bigdl_tpu/kernels/paged_attention.py:107", k2_long,
                   serve_routes["f32_split"]),
        kernel_rec("paged_attention_unsplit",
                   "bigdl_tpu_torch/csrc/paged_attention.cu",
                   "bigdl_tpu/kernels/paged_attention.py:107",
                   {"max_abs_err": k2_main["unsplit_err"], "route": "f32",
                    "ms": k2_main["unsplit_ms"],
                    "plain_ms": k2_main["plain_ms"],
                    "bound_ms": k2_main["bound_ms"],
                    "bound_by": k2_main["bound_by"], "library_ms": None},
                   serve_routes["f32"]),
        kernel_rec("fused_matmul_nhwc",
                   "bigdl_tpu_torch/csrc/fused_matmul_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:688",
                   dict(k3_s0["fwd"], max_abs_err=k3_s0["max_abs_err"],
                        route=k3_s0["route"]), off["fused_matmul_fwd"]),
        kernel_rec("fused_matmul", "bigdl_tpu_torch/csrc/fused_matmul_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:344",
                   dict(k3_s3["fwd"], max_abs_err=k3_s3["max_abs_err"],
                        route=k3_s3["route"]), off["fused_matmul_fwd"]),
        kernel_rec("fused_matmul_bwd",
                   "bigdl_tpu_torch/csrc/fused_matmul_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:580",
                   dict(k3_s0["bwd"], max_abs_err=k3_s0["max_abs_err"],
                        route=k3_s0["route"]), off["fused_matmul_bwd"]),
        kernel_rec("fused_matmul_f32",
                   "bigdl_tpu_torch/csrc/fused_matmul_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:344",
                   dict(k3_f32["fwd"], max_abs_err=k3_f32["max_abs_err"],
                        route=k3_f32["route"]),
                   r8["routes"]["fused_matmul_fwd"]["f32_sm90"]),
        kernel_rec("fused_matmul_bwd_f32",
                   "bigdl_tpu_torch/csrc/fused_matmul_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:229",
                   dict(k3_f32["bwd"], max_abs_err=k3_f32["max_abs_err"],
                        route=k3_f32["route"]),
                   r8["routes"]["fused_matmul_bwd"]["f32_sm90"]),
        kernel_rec("fused_chain", "bigdl_tpu_torch/csrc/fused_chain_sm90.cu",
                   "bigdl_tpu/kernels/fused_chain.py:318",
                   dict(k5_s0["fwd"], max_abs_err=k5_s0["max_abs_err"],
                        route=k5_s0["route"]), off["fused_chain_fwd"]),
        kernel_rec("fused_chain_bwd",
                   "bigdl_tpu_torch/csrc/fused_chain_sm90.cu",
                   "bigdl_tpu/kernels/fused_chain.py:214",
                   dict(k5_s0["bwd"], max_abs_err=k5_s0["max_abs_err"],
                        route=k5_s0["route"]), off["fused_chain_bwd"]),
        kernel_rec("fused_chain_f32",
                   "bigdl_tpu_torch/csrc/fused_chain_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_chain.py:318",
                   dict(k5_f32["fwd"], max_abs_err=k5_f32["max_abs_err"],
                        route=k5_f32["route"]),
                   r8["routes"]["fused_chain_fwd"]["f32_sm90"]),
        kernel_rec("fused_chain_bwd_f32",
                   "bigdl_tpu_torch/csrc/fused_chain_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_chain.py:214",
                   dict(k5_f32["bwd"], max_abs_err=k5_f32["max_abs_err"],
                        route=k5_f32["route"]),
                   r8["routes"]["fused_chain_bwd"]["f32_sm90"]),
        kernel_rec("fused_conv", "bigdl_tpu_torch/csrc/fused_conv_sm90.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188", k4_s0,
                   on["fused_conv_fwd"]),
        kernel_rec("fused_conv_s2", "bigdl_tpu_torch/csrc/fused_conv_sm90.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188", k4_s1,
                   on["fused_conv_fwd"]),
        kernel_rec("fused_conv_f32",
                   "bigdl_tpu_torch/csrc/fused_conv_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188",
                   dict(k4_f32, cuda_core_ms=k4_cc["ms"]),
                   r7["fused_routes"]["fused_conv_fwd"]["f32_sm90"]),
        kernel_rec("fused_conv_f32_ragged",
                   "bigdl_tpu_torch/csrc/fused_conv.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188", k4_cc,
                   r7["fused_routes"]["fused_conv_fwd"]["f32"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
