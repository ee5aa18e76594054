#!/usr/bin/env python3
"""The float32 flash forward past D = 112 and K4's ragged routes of two
checkouts side by side on one CUDA card: a parent tree's kernels and this
tree's, in turns (parent, this tree, this tree, parent), each turn a
process of its own that builds only that tree's libraries of the two
routes (the flash forward's library for float32 at D = 128, and
``fused_conv``).

Each turn times, with ``chip_smoke.flash_case`` / ``k4_case`` (CUDA graphs
of back-to-back launches between CUDA events: device ms a call; every call
first held against the tree's plain version, K4's also launched twice bit
for bit):

* K1-fwd in float32, causal, at (8, 16, 256, D) for D = 128, 192 and 256,
  and the chunk form at D = 128 (S = 32, q_offset 96, kv_len 128), with
  SDPA as the library call;
* K4 at ResNet-50's stage-0 3x3 (56 x 56 x 64 -> 64) forced onto the
  ragged routes (``chip_smoke.ragged_route``): float32 at B32, bf16 at
  B256; and at the width-50 bottleneck chain's 3x3 (C = N = 50, 56 x 56)
  on its own ragged route: float32 at B32, bf16 at B64; cuDNN's bare conv
  (TF32 off) as the library call.

Prints each case's readings as parent [first, last] change [first,
second], with the library call and the bound (this tree's), the card's
name and power limit, and writes everything to ``--out``. Needs a CUDA
card; run from the repository's root, with the parent unpacked into a
directory that ``.gitignore`` lists:

    git archive <parent> | tar -x -C _chip_tmp/parent
    python3 tools/torch_wide_ragged_turns.py --parent _chip_tmp/parent \\
        --out build/wide_ragged_turns.json
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH_D = (128, 192, 256)


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
    f32, bf = torch.float32, torch.bfloat16
    flash_lib = fa._FWD_FN[fa.fwd_route(f32, 128)][0]
    _build.SOURCES = {n: _build.SOURCES[n] for n in (flash_lib, "fused_conv")}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    out = {"tree": tree, "build_s": time.perf_counter() - t0, "cases": []}

    def add(name, rec):
        out["cases"].append({k: rec.get(k) for k in (
            "shape", "dtype", "route", "max_abs_err", "ms", "library_ms",
            "bound_ms", "bound_by", "plain_ms")} | {"name": name})

    for D in FLASH_D:
        add(f"K1-fwd f32 causal (8,16,256,{D})", cs.flash_case(
            torch, K, 8, 16, 256, 256, D, f32, True, 0, 256, timed=True))
    add("K1-fwd f32 chunk (8,16,S=32,D=128, q_offset 96, kv_len 128)",
        cs.flash_case(torch, K, 8, 16, 32, 384, 128, f32, True, 96, 128,
                      timed=True))
    with cs.ragged_route(torch):
        add("K4 f32 stage-0 B32 56x56x64->64, forced", cs.k4_case(
            torch, K, cs.FB, 56, 64, 64, 1, f32, True, plain=False))
        add("K4 bf16 stage-0 B256 56x56x64->64, forced", cs.k4_case(
            torch, K, cs.RB, 56, 64, 64, 1, bf, True, plain=False))
    for dt in (f32, bf):
        B, S = cs.CHAIN_SHAPE[str(dt)]
        add(f"K4 {str(dt)[6:]} C=N=50 B{B}/{S}", cs.k4_case(
            torch, K, B, S, cs.CHAIN_RAGGED, cs.CHAIN_RAGGED, 1, dt, True,
            plain=False))
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default="build/wide_ragged_turns.json")
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
        rd = lambda ts: [round(t["cases"][i]["ms"], 4) for t in ts]
        ratio = sum(rd(par)) / max(sum(rd(chg)), 1e-9)
        print(f"{case['name']} ({case['route']}; parent's route "
              f"{par[0]['cases'][i]['route']}): parent {rd(par)} change "
              f"{rd(chg)} ({ratio:.2f}x); library {case['library_ms']:.4f}, "
              f"bound {case['bound_ms']:.4f} ({case['bound_by']}); max error "
              f"(change) {case['max_abs_err']:.3g}", flush=True)
    print(f"card: {card}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "turns": turns}, f, indent=1)


if __name__ == "__main__":
    main()
