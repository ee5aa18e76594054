#!/usr/bin/env python3
"""The int8 GEMM of two checkouts side by side on one CUDA card: a parent
tree's ``bigdl_tpu_torch/csrc/int8_gemm_sm90.cu`` and this tree's, in turns
(parent, this tree, this tree, parent), each turn a process of its own that
builds only that tree's int8 library.

Each turn times, with CUDA graphs of back-to-back launches between CUDA
events (device ms a call; ``chip_smoke.graph_ms``):

* the kernel alone (the tree's ``_launch``) at ``chip_smoke.py`` phase
  21 (a)'s three GEMM shapes and at every distinct contraction of the int8
  Inception v1 B32/224 forward (``chip_smoke.inception_int8_shapes``), on
  the operands the tree's convolution path hands it (row stride K in a
  tree without ``plan``, K padded to 16 in one with it): int32 output, and
  with the quantized layers' rescale and bias (the fused epilogue where
  the tree has one, else the kernel then ``acc.to(float32) * s + bias`` as
  the parent's layers compute it);
* phase 21 (a)'s depthwise 3x3 through ``int8_conv2d`` (im2col included),
  int32 and with the epilogue;
* with ``--forward``, the int8 Inception v1 B32/224 forward of the tree's
  package (``calibrate`` on 8 images, ``quantize(calibration=)``), eager,
  CUDA events around 3 forwards, and the float model's.

This tree's turns also time ``torch._int_mm`` where it takes the shape and
a bf16 cuBLAS product. Prints one line a case (the four readings, the bound,
the library times) and the sums over the 58 contractions, with the card's
name and power limit, and writes everything to ``--out``. Needs a CUDA card;
run from the repository's root, with the parent unpacked into a directory
that ``.gitignore`` lists:

    git archive <parent> | tar -x -C _chip_tmp/parent
    python3 tools/torch_int8_gemm_turns.py --parent _chip_tmp/parent \\
        --forward --out build/int8_turns.json
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This tree's ``chip_smoke.py`` as a module (not the parent's)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree, forward):
    cs = _smoke()
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from bigdl_tpu_torch.kernels import _build
    _build.SOURCES = {"int8_gemm_sm90": _build.SOURCES["int8_gemm_sm90"]}
    import bigdl_tpu_torch.kernels.int8_matmul  # noqa: F401 (the module)
    I = sys.modules["bigdl_tpu_torch.kernels.int8_matmul"]
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    fused = hasattr(I, "plan")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(25)
    i8 = lambda *s: torch.randint(-127, 128, s, dtype=torch.int8, device=dev,
                                  generator=g)
    cases = [("q21 " + n, M, N, K, 1) for n, (M, N, K) in cs.Q21["gemm"]]
    seen = {}
    for n, M, N, K in cs.inception_int8_shapes(32):
        key = (M, N, K)
        if key in seen:
            seen[key][4] += 1
        else:
            seen[key] = [n, M, N, K, 1]
    cases += [tuple(v) for v in seen.values()]
    out = {"tree": tree, "fused": fused, "build_s": build_s, "cases": []}
    for name, M, N, K, count in cases:
        ld = -(-K // 16) * 16 if fused else K
        a = torch.zeros(M, ld, dtype=torch.int8, device=dev)
        b = torch.zeros(N, ld, dtype=torch.int8, device=dev)
        a[:, :K] = i8(M, K)
        b[:, :K] = i8(N, K)
        c = torch.empty(M, N, dtype=torch.int32, device=dev)
        cf = torch.empty(M, N, dtype=torch.float32, device=dev)
        s = torch.rand(N, device=dev, generator=g) * 1e-3
        bias = torch.randn(N, device=dev, generator=g)
        gemm = (1, M, N, K, ld, ld, N, M * ld, N * ld, M * N)
        int32 = lambda i: I._launch(a, b, c, *gemm)
        if fused:
            epi = lambda i: I._launch(a, b, cf, *gemm, s, bias, 0)
        else:
            epi = lambda i: (I._launch(a, b, c, *gemm),
                             c.to(torch.float32) * s + bias)
        rec = {"name": name, "M": M, "N": N, "K": K, "count": count,
               "int32_ms": cs.graph_ms(torch, int32, 1, reps=20),
               "epi_ms": cs.graph_ms(torch, epi, 1, reps=20)}
        rec["bound_ms"], rec["bound_by"] = cs.int8_bound(M, N, K)
        if fused:
            ab, bb = a[:, :K].to(torch.bfloat16), b[:, :K].to(torch.bfloat16)
            rec["bf16_ms"] = cs.graph_ms(torch, lambda i: ab @ bb.T, 1,
                                         reps=20)
            if M > 16 and K % 8 == 0 and N % 8 == 0:
                a2, bt = a[:, :K].contiguous(), b[:, :K].T
                rec["int_mm_ms"] = cs.graph_ms(
                    torch, lambda i: torch._int_mm(a2, bt), 1, reps=20)
        out["cases"].append(rec)
        del a, b, c, cf
    # the depthwise 3x3 of phase 21 (a), im2col included
    name, (B, C, H) = cs.Q21["dw"]
    x, w = i8(B, C, H, H), i8(C, 1, 3, 3)
    s = torch.rand(C, device=dev, generator=g) * 1e-3
    bias = torch.randn(C, device=dev, generator=g)
    conv = lambda i: I.int8_conv2d(x, w, 1, 1, 1, C)
    if fused:
        cepi = lambda i: I.int8_conv2d(x, w, 1, 1, 1, C, scale=s, bias=bias)
    else:
        cepi = lambda i: I.int8_conv2d(x, w, 1, 1, 1, C).to(
            torch.float32) * s[None, :, None, None] + bias[None, :, None,
                                                           None]
    M = B * H * H
    rec = {"name": "q21 " + name, "M": M, "N": 1, "K": 9, "G": C,
           "count": 1, "int32_ms": cs.graph_ms(torch, conv, 1, reps=20),
           "epi_ms": cs.graph_ms(torch, cepi, 1, reps=20)}
    rec["bound_ms"], rec["bound_by"] = cs.int8_bound(
        M, 1, 9, C, a_bytes=x.numel())
    out["cases"].append(rec)
    # the wrapper's host cost at 1568 x 320 x 1440 (the device idle)
    a, b = i8(1568, 1440), i8(320, 1440)
    s, bias = torch.rand(320, device=dev), torch.randn(320, device=dev)
    call = (lambda: I.int8_matmul(a, b, scale=s, bias=bias)) if fused else \
        (lambda: I.int8_matmul(a, b).to(torch.float32) * s + bias)
    out["host_call_ms"] = cs.host_call_ms(torch, call)
    if forward:
        from bigdl_tpu_torch import models
        from bigdl_tpu_torch.quantization import calibrate, quantize
        rng = np.random.RandomState(21)
        model = models.Inception_v1_NoAuxClassifier(1000, device=dev,
                                                    seed=21)
        model.evaluate()
        cal = torch.from_numpy(rng.randn(8, 3, 224, 224).astype(
            np.float32)).to(dev)
        xb = torch.from_numpy(rng.randn(32, 3, 224, 224).astype(
            np.float32)).to(dev)
        qm = quantize(model, calibration=calibrate(model, [cal]))
        with torch.no_grad():
            for tag, m in (("int8", qm), ("float", model)):
                ms = cs.event_ms(torch, lambda: m.forward(xb), reps=3,
                                 iters=3)
                out[f"{tag}_forward_ms"] = ms
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--out", default="build/int8_turns.json")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child, args.forward)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = _smoke().card_line()
    turns = []
    for tag, tree in (("parent", args.parent), ("change", ROOT),
                      ("change", ROOT), ("parent", args.parent)):
        cmd = [sys.executable, os.path.abspath(__file__), "--parent",
               args.parent, "--child", tree] + (["--forward"]
                                                if args.forward else [])
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            sys.exit(f"{tag} turn failed ({p.returncode}):\n"
                     f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        rec = json.loads(lines[-1][7:])
        rec["tag"] = tag
        turns.append(rec)
        print(f"{tag} turn: build {rec['build_s']:.1f} s, host call "
              f"{rec['host_call_ms']:.4f} ms"
              + (f", int8 forward {rec['int8_forward_ms']:.2f} ms, float "
                 f"{rec['float_forward_ms']:.2f} ms" if args.forward
                 else ""), flush=True)
    par = [t for t in turns if t["tag"] == "parent"]
    chg = [t for t in turns if t["tag"] == "change"]
    sums = {}
    for i, case in enumerate(chg[0]["cases"]):
        rd = lambda ts, key: [t["cases"][i][key] for t in ts]
        lib = (f"; _int_mm {case['int_mm_ms']:.4f}" if "int_mm_ms" in case
               else "") + (f"; bf16 {case['bf16_ms']:.4f}" if "bf16_ms" in
                           case else "")
        print(f"{case['name']} ({case['M']} x {case['N']} x {case['K']}"
              f"{', G ' + str(case['G']) if 'G' in case else ''}, "
              f"x{case['count']}): int32 parent {rd(par, 'int32_ms')} "
              f"change {rd(chg, 'int32_ms')}; with epilogue parent "
              f"{rd(par, 'epi_ms')} change {rd(chg, 'epi_ms')}; bound "
              f"{case['bound_ms']:.4f} ({case['bound_by']}){lib}",
              flush=True)
        if case["name"].startswith("q21 "):
            continue
        for tag, ts in (("parent", par), ("change", chg)):
            for key in ("int32_ms", "epi_ms"):
                sums.setdefault(f"{tag}_{key}", [0.0] * len(ts))
                for j, t in enumerate(ts):
                    sums[f"{tag}_{key}"][j] += case["count"] * \
                        t["cases"][i][key]
        sums["bound_ms"] = sums.get("bound_ms", 0.0) + case["count"] * \
            case["bound_ms"]
        sums["count"] = sums.get("count", 0) + case["count"]
        for key in ("int_mm_ms", "bf16_ms"):
            if key in case:
                sums[key] = sums.get(key, 0.0) + case["count"] * case[key]
                sums[key + "_count"] = sums.get(key + "_count", 0) + \
                    case["count"]
    print(f"the B32 forward's {sums['count']} contractions, summed: "
          + ", ".join(f"{k} {v}" for k, v in sums.items()
                      if k != "count") + f" ({card})", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "turns": turns, "sums": sums}, f, indent=1)


if __name__ == "__main__":
    main()
