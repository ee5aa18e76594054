#!/usr/bin/env python3
"""The float32 flash backward past D = 64 of two checkouts side by side on
one CUDA card: a parent tree's kernels and this tree's, in turns (parent,
this tree, this tree, parent), each turn a process of its own that builds
only that tree's libraries of the route (the float32 flash forward's, for
the residuals, and the float32 backward's at each timed head dim).

Each turn times, with ``chip_smoke.bwd_case`` (CUDA graphs of back-to-back
launches between CUDA events: device ms a call; every call first held
against the tree's plain version, and launched twice bit for bit), the
float32 backward at causal (8, 8, 256, D) for D = 96, 128 and 192: the
wrapper's call (delta = rowsum(dO * O) and the kernel pair), the kernel
pair alone given delta, the delta op, the plain version and SDPA's
backward as the library call.

Prints each case's readings as parent [first, last] change [first,
second], with the library call and the bound (this tree's), the card's
name and power limit, and writes everything to ``--out``. Needs a CUDA
card; run from the repository's root, with the parent unpacked into a
directory that ``.gitignore`` lists:

    git archive <parent> | tar -x -C _chip_tmp/parent
    python3 tools/torch_wide_bwd_turns.py --parent _chip_tmp/parent \\
        --out build/wide_bwd_turns.json
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BWD_D = (96, 128, 192)


def _smoke():
    """This tree's ``chip_smoke.py`` as a module (not the parent's)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree):
    cs = _smoke()
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import bigdl_tpu_torch.kernels as K
    from bigdl_tpu_torch.kernels import _build
    from bigdl_tpu_torch.kernels import flash_attention as fa
    f32 = torch.float32
    libs = {fa._FWD_FN[fa.fwd_route(f32, 128)][0]}
    libs |= {fa._BWD_FN[fa.bwd_route(f32, D)][0] for D in BWD_D}
    _build.SOURCES = {n: _build.SOURCES[n] for n in sorted(libs)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    out = {"tree": tree, "build_s": time.perf_counter() - t0, "cases": []}
    for D in BWD_D:
        rec = cs.bwd_case(torch, K, 8, 8, 256, D, f32, True, timed=True)
        out["cases"].append({k: rec.get(k) for k in (
            "shape", "dtype", "route", "max_abs_err", "ms", "kernels_ms",
            "delta_ms", "library_ms", "bound_ms", "bound_by", "plain_ms",
            "rerun_bitwise_equal")} | {"name": f"K1-bwd f32 causal "
                                               f"(8,8,256,{D})"})
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default="build/wide_bwd_turns.json")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = _smoke().card_line()
    turns = []
    for tag, tree in (("parent", args.parent), ("change", ROOT),
                      ("change", ROOT), ("parent", args.parent)):
        cmd = [sys.executable, os.path.abspath(__file__), "--parent",
               args.parent, "--child", tree]
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            sys.exit(f"{tag} turn failed ({p.returncode}):\n"
                     f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        rec = json.loads(lines[-1][7:])
        rec["tag"] = tag
        turns.append(rec)
        print(f"{tag} turn: build {rec['build_s']:.1f} s", flush=True)
    par = [t for t in turns if t["tag"] == "parent"]
    chg = [t for t in turns if t["tag"] == "change"]
    for i, case in enumerate(chg[0]["cases"]):
        rd = lambda ts, key="ms": [round(t["cases"][i][key], 4) for t in ts]
        ratio = sum(rd(par)) / max(sum(rd(chg)), 1e-9)
        print(f"{case['name']} ({case['route']}; parent's route "
              f"{par[0]['cases'][i]['route']}): parent {rd(par)} change "
              f"{rd(chg)} ({ratio:.2f}x); kernel pair parent "
              f"{rd(par, 'kernels_ms')} change {rd(chg, 'kernels_ms')}; "
              f"SDPA backward {[round(t['cases'][i]['library_ms'], 4) for t in chg]}, "
              f"bound {case['bound_ms']:.4f} ({case['bound_by']}); max "
              f"error (change) {case['max_abs_err']:.3g}", flush=True)
    print(f"card: {card}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "turns": turns}, f, indent=1)


if __name__ == "__main__":
    main()
