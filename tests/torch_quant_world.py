"""Gloo worlds of the port for the quantization tests.

``run_world(job, n, *args)`` starts ``n`` processes of this file, joins
them into one gloo group on the CPU and runs ``job(rank, n, *args)`` on
each (a function of this module, named by string: the workers import
``torch`` and ``bigdl_tpu_torch`` only), returning the results by rank.
A rank that fails, or a world that outlives its deadline, fails the test
with the workers' output, as ``torch_dist_helpers.run_world`` does.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import time

from torch_dist_helpers import WORLD_TIMEOUT_S, _ROOT, _free_port


def run_world(job, n, *args, timeout_s=WORLD_TIMEOUT_S):
    with tempfile.TemporaryDirectory() as d:
        spec = os.path.join(d, "job.pkl")
        with open(spec, "wb") as f:
            pickle.dump((job, args), f)
        env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        port = str(_free_port())
        logs = [open(os.path.join(d, f"err{r}.txt"), "wb") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, str(r), str(n),
             port], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                if any(c not in (None, 0) for c in codes):
                    failed = "a rank failed"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = f"the world did not finish in {timeout_s}s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        if failed:
            errs = []
            for r in range(n):
                with open(os.path.join(d, f"err{r}.txt"), "rb") as f:
                    errs.append(f"--- rank {r}\n{f.read().decode()[-3000:]}")
            raise RuntimeError(failed + "\n" + "\n".join(errs))
        out = []
        for r in range(n):
            with open(os.path.join(d, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def quantized_tp(rank, n, cfg, weights, ids, max_new, quant):
    """``generate`` and the prefill logits of a quantized LM over a
    ``model`` mesh of ``n`` ranks (``transformer_tp_specs``) and on this
    rank alone; and the error an FSDP placement of the carriers raises."""
    import torch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn.module import copy_tree_into
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import over
    from bigdl_tpu_torch.parallel.sharding import (fsdp_specs,
                                                   place_with_specs,
                                                   transformer_tp_specs)
    from bigdl_tpu_torch.quantization import quantize_lm_params
    model = TransformerLM(device="cpu", **cfg)
    copy_tree_into(model.params, weights)
    qp = quantize_lm_params(model.params, **quant)
    mesh = make_mesh((n,), ("model",), device="cpu")
    placed = place_with_specs(qp, mesh, transformer_tp_specs(qp))
    w = placed["block0"]["attn"]["wq"]
    split = (w.q.shape[1] == qp["block0"]["attn"]["wq"].q.shape[1] // n
             and w.s.shape[-1] == w.q.shape[1])
    prompt = torch.from_numpy(ids)
    with torch.no_grad():
        solo = model.generate(qp, prompt, max_new)
        solo_logits, _ = model.prefill(qp, solo, solo.shape[1] + 1)
        with over(mesh):
            got = model.generate(placed, prompt, max_new)
            logits, _ = model.prefill(placed, got, got.shape[1] + 1)
        dmesh = make_mesh((n,), ("data",), device="cpu")
        sliced = place_with_specs(qp, dmesh,
                                  fsdp_specs(qp, dmesh, min_elems=256))
        try:
            with over(dmesh):
                model.generate(sliced, prompt, 1)
            fsdp_error = ""
        except NotImplementedError as e:
            fsdp_error = str(e)
    return {"split": bool(split), "solo": solo.numpy(),
            "tokens": got.numpy(), "solo_logits": solo_logits.numpy(),
            "logits": logits.numpy(), "fsdp_error": fsdp_error}


def _worker(spec, rank, n, port):
    import torch
    torch.set_num_threads(1)
    from bigdl_tpu_torch.utils import engine
    with open(spec, "rb") as f:
        name, args = pickle.load(f)
    engine.init_process_group(rank, n, f"tcp://127.0.0.1:{port}",
                              device="cpu", timeout_s=WORLD_TIMEOUT_S)
    out = globals()[name](rank, n, *args)
    with open(os.path.join(os.path.dirname(spec), f"out{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
