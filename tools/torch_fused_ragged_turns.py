#!/usr/bin/env python3
"""K3's and K5's ragged routes of two checkouts side by side on one CUDA
card: a parent tree's ``csrc/fused_matmul.cu`` / ``csrc/fused_chain.cu``
and this tree's, in turns (parent, this tree, this tree, parent), each turn
a process of its own that builds only that tree's fused K3 / K5 libraries
(the ragged ones; with ``--chain`` also the aligned ones the chain step
needs).

Each turn times, with ``chip_smoke.k3_case`` / ``k5_case`` (CUDA graphs of
back-to-back launches between CUDA events: device ms a call; every call
first held against the tree's plain version and launched twice bit for
bit), forward and backward:

* every ResNet-50 B32/224 shape of K3 and K5 in float32 forced onto the
  ragged route ``f32`` (``chip_smoke.ragged_route``);
* the truly ragged shapes: K3 at K = 63, N = 255 over B32 x 56 x 56 rows
  in float32 and B256 x 56 x 56 in bf16 (route ``bf16_ragged``), and K5's
  stage-0 junction at K = 255, N = 63 (B32 float32, B256 bf16);
* with ``--chain``, the training step of ``chip_smoke``'s width-50
  bottleneck chain beside the width-48 one at ``CHAIN_SHAPE`` in both
  dtypes (``chip_smoke.chain_ms``: the kernels' device ms a step from
  ``torch.profiler``, the fused K3 / K5 kernels' part of it, and the
  eager wall ms).

Every turn also times the bare cuBLAS products (TF32 off) as the library
call, and the bound is computed from the shape. Prints each case's
readings as parent [first, last] change [first, second], the launches-a-
step sums of the forced B32 shapes, with the card's name and power limit,
and writes everything to ``--out``. Needs a CUDA card; run from the
repository's root, with the parent unpacked into a directory that
``.gitignore`` lists:

    git archive <parent> | tar -x -C _chip_tmp/parent
    python3 tools/torch_fused_ragged_turns.py --parent _chip_tmp/parent \\
        --chain --out build/ragged_turns.json
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = ("fused_matmul", "fused_chain")
ALIGNED_LIBS = ("fused_matmul_sm90", "fused_chain_sm90",
                "fused_matmul_tf32_sm90", "fused_chain_tf32_sm90")


def _smoke():
    """This tree's ``chip_smoke.py`` as a module (not the parent's)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timing(rec):
    return {f"{tag}_{k}": rec[tag][k] for tag in ("fwd", "bwd")
            for k in ("ms", "library_ms", "bound_ms", "bound_by")}


def child(tree, chain):
    cs = _smoke()
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import bigdl_tpu_torch.kernels as K
    from bigdl_tpu_torch.kernels import _build
    _build.SOURCES = {n: _build.SOURCES[n]
                      for n in LIBS + (ALIGNED_LIBS if chain else ())}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    out = {"tree": tree, "build_s": time.perf_counter() - t0, "cases": []}
    f32, bf = torch.float32, torch.bfloat16

    def add(name, family, count, rec):
        out["cases"].append(dict(name=name, family=family, count=count,
                                 dtype=rec["dtype"], shape=rec["shape"],
                                 route=rec["route"],
                                 max_abs_err=rec["max_abs_err"],
                                 **_timing(rec)))

    with cs.ragged_route(torch):
        for name, (M, Kd, N, pro), n in cs.RESNET_K3:
            add(f"B{cs.FB} {name}", "K3", n, cs.k3_case(
                torch, K, M // cs.RB * cs.FB, Kd, N, f32, pro, pro, True,
                True, plain=False))
        for name, (H, Kd, N), n in cs.RESNET_K5:
            add(f"B{cs.FB} {name}", "K5", n, cs.k5_case(
                torch, K, cs.FB, H, Kd, N, f32, True, plain=False))
    for dt, rb in ((f32, cs.FB), (bf, cs.RB)):
        add(f"B{rb} K 63 N 255", "K3 ragged", 0, cs.k3_case(
            torch, K, rb * 56 * 56, 63, 255, dt, True, True, True, True,
            plain=False))
        add(f"B{rb} junction K 255 N 63", "K5 ragged", 0, cs.k5_case(
            torch, K, rb, 56, 255, 63, dt, True, plain=False))
    if chain:
        out["chain"] = {}
        for dt in (f32, bf):
            B, S = cs.CHAIN_SHAPE[str(dt)]
            for w in (cs.CHAIN_RAGGED, cs.CHAIN_ALIGNED):
                m = cs._chain(torch, w, "cuda")
                x = torch.from_numpy(np.random.RandomState(w).randn(
                    B, S, S, 2 * w).astype(np.float32)).to("cuda", dt)
                out["chain"][f"{dt} width {w} B{B}/{S}"] = cs.chain_ms(
                    torch, lambda: cs._chain_step(torch, m, x, dt == bf))
                del m, x
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--chain", action="store_true")
    ap.add_argument("--out", default="build/ragged_turns.json")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child, args.chain)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = _smoke().card_line()
    turns = []
    for tag, tree in (("parent", args.parent), ("change", ROOT),
                      ("change", ROOT), ("parent", args.parent)):
        cmd = [sys.executable, os.path.abspath(__file__), "--parent",
               args.parent, "--child", tree] + (["--chain"] if args.chain
                                                else [])
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
    sums = {}
    for i, case in enumerate(chg[0]["cases"]):
        rd = lambda ts, key: [round(t["cases"][i][key], 4) for t in ts]
        for tag in ("fwd", "bwd"):
            print(f"{case['family']} {tag} {case['name']} {case['shape']} "
                  f"{case['dtype']} ({case['route']}): parent "
                  f"{rd(par, tag + '_ms')} change {rd(chg, tag + '_ms')}; "
                  f"library {case[tag + '_library_ms']:.4f}, bound "
                  f"{case[tag + '_bound_ms']:.4f} ({case[tag + '_bound_by']})"
                  f"; max error (change) {case['max_abs_err']:.3g}",
                  flush=True)
            if case["count"]:
                key = f"{case['family']} {tag}"
                for who, ts in (("parent", par), ("change", chg)):
                    got = sums.setdefault(key, {}).setdefault(
                        who, [0.0] * len(ts))
                    for j, t in enumerate(ts):
                        got[j] += case["count"] * t["cases"][i][tag + "_ms"]
                lib = sums[key].setdefault("library", 0.0)
                sums[key]["library"] = lib + case["count"] * \
                    case[tag + "_library_ms"]
    for key, v in sums.items():
        print(f"B{32} step's {key} launches x ms, forced onto the ragged "
              f"route: parent {[round(x, 3) for x in v['parent']]} change "
              f"{[round(x, 3) for x in v['change']]}; library "
              f"{v['library']:.3f}", flush=True)
    if args.chain:
        for key in chg[0]["chain"]:
            rd = lambda ts, k: [round(t["chain"][key][k], 4) for t in ts]
            print(f"chain step {key}: device ms parent {rd(par, 'ms')} "
                  f"change {rd(chg, 'ms')}; fused K3 / K5 kernels parent "
                  f"{rd(par, 'fused_ms')} change {rd(chg, 'fused_ms')}; eager"
                  f" wall parent {rd(par, 'wall_ms')} change "
                  f"{rd(chg, 'wall_ms')}", flush=True)
    print(f"card: {card}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "turns": turns, "sums": sums}, f, indent=1)


if __name__ == "__main__":
    main()
