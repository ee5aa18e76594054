#!/usr/bin/env python3
"""What one FSDP serving step's gathers cost when two gloo ranks share one
CUDA card (phase 19 (b) of ``chip_smoke.py`` runs that way: NCCL refuses
two ranks on one card).

The flagship's sliced leaves at bf16 (12 blocks of wq / wk / wv / wo
(512, 1024), w1 (1024, 2048), w2 (2048, 1024), and the embedding's
(16000, 1024) half) are all-gathered three ways: one
``all_gather_into_tensor`` a leaf (what ``sharding.gather_param`` does),
one a block over the leaves concatenated, and one a block staged through
pinned host buffers. Prints the seconds a step of each (the mean of three
after a warm-up), with the card's name and power limit. Needs a CUDA card; run from the
repository's root:

    python3 tools/torch_gloo_gather_probe.py
"""
import datetime
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist


def rank_main(rank, port):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda")
    H, F = 1024, 4096
    shapes = [(H // 2, H)] * 4 + [(H, F // 2), (F // 2, H)]
    blocks = [[torch.randn(s, device=dev).to(torch.bfloat16) for s in shapes]
              for _ in range(12)]
    emb = torch.randn(16000, H, device=dev).to(torch.bfloat16)

    def per_leaf():
        for t in [x for blk in blocks for x in blk] + [emb]:
            out = t.new_empty((2 * t.shape[0],) + t.shape[1:])
            dist.all_gather_into_tensor(out, t)

    flat = [torch.cat([t.reshape(-1) for t in blk]) for blk in blocks] + \
        [emb.reshape(-1)]

    def per_block():
        for f in flat:
            out = f.new_empty((2 * f.shape[0],))
            dist.all_gather_into_tensor(out, f)

    pin = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True) for f in flat]
    pout = [torch.empty((2 * f.shape[0],), dtype=f.dtype, pin_memory=True)
            for f in flat]

    def host_staged():
        for f, p, po in zip(flat, pin, pout):
            p.copy_(f)
            dist.all_gather_into_tensor(po, p)
            po.to(dev, non_blocking=True)
        torch.cuda.synchronize()

    res = {}
    for name, fn in (("per_leaf", per_leaf), ("per_block", per_block),
                     ("host_staged", host_staged)):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t) / 3
    if rank == 0:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(f"{card}: seconds a step {res}", flush=True)
    os._exit(0)


def main():
    if not torch.cuda.is_available():
        sys.exit("this probe needs a CUDA card")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    ps = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            str(r), port]) for r in range(2)]
    sys.exit(max(p.wait() for p in ps))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), sys.argv[2])
    main()
