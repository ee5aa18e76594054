#!/usr/bin/env python3
"""Every launch plan of the int8 GEMM (``bigdl_tpu_torch/csrc/
int8_gemm_sm90.cu``) at the contractions of the int8 Inception v1 B32/224
forward and at ``chip_smoke.py`` phase 21 (a)'s GEMM shapes, on one CUDA
card: each tile width of ``int8_matmul.TILE_NS`` up to the narrowest
that holds N (all five for N > 256), times each K split (at most 16) that
keeps the work items within one wave (tiles x splits <= the card's SMs),
the kernel
called through its C entry with that plan, with the quantized layers' fused
epilogue (float32 out, scale and bias). Device ms a call from CUDA graphs
of back-to-back launches between CUDA events (``chip_smoke.graph_ms``).
Prints, a shape, every plan's ms, the best plan and ``plan``'s own, with
the card's name and power limit, and writes them to ``--out``. Then fits
``int8_matmul.plan_us``'s cost model to every reading (least squares on
the relative error) and prints its constants, the fit's mean relative error
and the summed ms of the best plans against the model's picks: the
constants of ``int8_matmul._COST`` come from this fit. Needs a CUDA card;
run from the repository's root:

    python3 tools/torch_int8_gemm_sweep.py --out build/int8_sweep.json
"""
import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_SPLITS = 16


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/int8_sweep.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from bigdl_tpu_torch.kernels import _build
    import bigdl_tpu_torch.kernels.int8_matmul  # noqa: F401 (the module)
    I = sys.modules["bigdl_tpu_torch.kernels.int8_matmul"]
    card = cs.card_line()
    dev = torch.device("cuda")
    sms = I._sm_count(dev)
    fn = _build.function(*I._FN, I._ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(25)
    shapes = {}
    for n, M, N, K in cs.inception_int8_shapes(32):
        shapes.setdefault((M, N, K), n)
    for n, (M, N, K) in cs.Q21["gemm"]:
        shapes.setdefault((M, N, K), "q21 " + n)
    out = {"card": card, "sms": sms, "shapes": []}
    for (M, N, K), name in shapes.items():
        ld = I._padded_k(K)
        a = torch.randint(-127, 128, (M, ld), dtype=torch.int8, device=dev,
                          generator=g)
        b = torch.randint(-127, 128, (N, ld), dtype=torch.int8, device=dev,
                          generator=g)
        c = torch.empty(M, N, dtype=torch.float32, device=dev)
        s = torch.rand(N, device=dev, generator=g) * 1e-3
        bias = torch.randn(N, device=dev, generator=g)
        # exact: every |sum| < 2^31 < 2^53
        acc = (a[:, :K].double() @ b[:, :K].double().T).to(torch.int32)
        want = acc.to(torch.float32) * s + bias
        del acc
        own = I.plan(1, M, N, K, sms)
        widest = 256 if N > 256 else next(t for t in I.TILE_NS if t >= N)
        steps = -(-K // I.TILE_K)
        rec = {"name": name, "M": M, "N": N, "K": K,
               "plan": [own.tile_n, own.splits], "ms": {}}
        for bn in I.TILE_NS:
            if bn > widest:
                continue
            tiles = -(-M // I.TILE_M) * -(-N // bn)
            for S in range(1, MAX_SPLITS + 1):
                if S > max(steps, 1) or (S > 1 and tiles * S > sms):
                    continue
                ws = torch.empty(max(tiles * S * I.TILE_M * bn, 1),
                                 dtype=torch.int32, device=dev)
                cnt = I._counters(dev, stream, max(tiles, sms))
                grid = max(1, min(tiles * S, sms))

                def call(i, bn=bn, S=S, ws=ws, cnt=cnt, grid=grid):
                    st = torch.cuda.current_stream(dev).cuda_stream
                    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                             s.data_ptr(), bias.data_ptr(), cnt.data_ptr(),
                             ws.data_ptr(), 1, M, N, K, ld, ld, N, M * ld,
                             N * ld, M * N, 0, bn, S, grid, st)
                    if err:
                        raise RuntimeError(f"CUDA error {err}")
                call(0)
                torch.cuda.synchronize()
                if not torch.equal(c, want):
                    sys.exit(f"{name} bn {bn} splits {S}: differs")
                rec["ms"][f"{bn}x{S}"] = cs.graph_ms(torch, call, 1, reps=10,
                                                     iters=5)
        best = min(rec["ms"], key=rec["ms"].get)
        rec["best"] = best
        key = f"{own.tile_n}x{own.splits}"
        print(f"{name} ({M} x {N} x {K}): plan {key} {rec['ms'].get(key)} "
              f"ms, best {best} {rec['ms'][best]:.4f} ms; "
              + ", ".join(f"{k} {v:.4f}" for k, v in rec["ms"].items()),
              flush=True)
        out["shapes"].append(rec)
        del a, b, c
    out["fit"] = fit(out["shapes"], I, sms)
    print(f"cost model fit: {out['fit']} ({card})", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


def fit(shapes, I, sms):
    """Least squares (on relative error) of ``int8_matmul.plan_us``'s
    constants to every reading; with the fit's mean relative error and the
    summed ms of each shape's best plan against the model's pick."""
    import numpy as np
    names = ("T0", "A", "B", "C", "D", "E", "F")
    rows, ys, keys = [], [], []
    for r in shapes:
        steps = -(-r["K"] // I.TILE_K)
        for k, ms in r["ms"].items():
            bn, S = map(int, k.split("x"))
            tiles = -(-r["M"] // I.TILE_M) * -(-r["N"] // bn)
            W = -(-tiles * S // sms)
            sp = -(-steps // S)
            sk = 1.0 if S > 1 else 0.0
            rows.append([1.0, W * sp, W * sp * bn, W, W * bn, sk,
                         sk * bn * (S - 1)])
            ys.append(ms * 1e3)
            keys.append((r["name"], k))
    X, y = np.array(rows), np.array(ys)
    coef, *_ = np.linalg.lstsq(X / y[:, None], np.ones_like(y), rcond=None)
    pred = X @ coef
    best, pick = {}, {}
    for (name, k), t, p in zip(keys, y, pred):
        if name not in best or t < best[name]:
            best[name] = t
        if name not in pick or p < pick[name][0]:
            pick[name] = (p, t)
    return {"constants": {n: round(float(c), 5) for n, c in zip(names, coef)},
            "mean_rel_err": float(np.mean(np.abs(pred - y) / y)),
            "best_us": float(sum(best.values())),
            "picked_us": float(sum(t for _, t in pick.values()))}


if __name__ == "__main__":
    main()
