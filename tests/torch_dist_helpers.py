"""Gloo worlds of the port for the distributed parity tests.

``run_world(job, n, *args)`` starts ``n`` processes of this file, joins
them into one gloo group on the CPU (``engine.init_process_group``) and
runs ``job(rank, n, *args)`` on each - a function of this module, so the
workers import ``torch`` and ``bigdl_tpu_torch`` only, never JAX. It
returns the jobs' return values by rank. A world has a deadline: a rank
that is still running after ``timeout_s`` (or that fails) takes the
whole world down, and the test fails with the workers' errors instead of
hanging. The jobs below are the port's halves of the tests; the JAX
halves run in the test process.
"""
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

WORLD_TIMEOUT_S = 150.0
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(job, n, *args, timeout_s=WORLD_TIMEOUT_S, **kw):
    with tempfile.TemporaryDirectory() as d:
        spec = os.path.join(d, "job.pkl")
        with open(spec, "wb") as f:
            pickle.dump((job.__name__, args, kw), f)
        env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        port = str(_free_port())
        procs, logs = [], []
        for r in range(n):
            log = open(os.path.join(d, f"err{r}.txt"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec, str(r),
                 str(n), port], env=env, stdout=log,
                stderr=subprocess.STDOUT))
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
                    errs.append(f"--- rank {r} (exit {procs[r].returncode})"
                                f"\n{f.read().decode()[-3000:]}")
            raise RuntimeError(failed + "\n" + "\n".join(errs))
        out = []
        for r in range(n):
            with open(os.path.join(d, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _worker(spec, rank, n, port):
    import torch
    torch.set_num_threads(1)
    from bigdl_tpu_torch.utils import engine
    with open(spec, "rb") as f:
        name, args, kw = pickle.load(f)
    engine.init_process_group(rank, n, f"tcp://127.0.0.1:{port}",
                               device="cpu", timeout_s=WORLD_TIMEOUT_S)
    out = globals()[name](rank, n, *args, **kw)
    with open(os.path.join(os.path.dirname(spec), f"out{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    sys.stdout.flush()
    # no teardown: a probe's abandoned collective may still hold the group
    os._exit(0)


# -- jobs --------------------------------------------------------------------

def host(tree):
    from bigdl_tpu_torch import convert
    return convert.host_copy_tree(tree)


def torch_tree(tree):
    import torch
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _mesh(n=None):
    from bigdl_tpu_torch.parallel import data_parallel_mesh
    return data_parallel_mesh(n, device="cpu")


def lenet_runs(rank, n, weights, feats, labels, configs):
    """LeNet-5 on the MNIST stand-in through ``DistriOptimizer`` (or the
    local optimizer, ``mode="local"``) for each ``(name, mode, method,
    iterations, kw)``: every rank's trained params by name."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn.module import copy_tree_into
    from bigdl_tpu_torch.optim import (SGD, Adam, DistriOptimizer,
                                       LocalOptimizer, max_iteration)
    mesh = _mesh()
    out = {}
    for name, mode, method, iters, kw in configs:
        model = LeNet5(10, device="cpu")
        copy_tree_into(model.params, weights)
        ds = DataSet.array([Sample(f, l) for f, l in zip(feats, labels)])
        optim = SGD(learningrate=0.05) if method == "sgd" else \
            Adam(learningrate=0.01)
        if mode == "local":
            opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), optim,
                                 max_iteration(iters), batch_size=64,
                                 device="cpu")
        else:
            opt = DistriOptimizer(model, ds, nn.ClassNLLCriterion(), optim,
                                  max_iteration(iters), batch_size=64,
                                  mesh=mesh, parameter_mode=mode, **kw)
        opt.optimize()
        out[name] = host(model.params)
    return out



class FixedBatches:
    """A batch-level data set of fixed global MiniBatches in a fixed
    order (no shuffle)."""

    def __init__(self, batches):
        from bigdl_tpu_torch.dataset import MiniBatch
        self._mbs = [MiniBatch(x, y) for x, y in batches]

    def size(self):
        return sum(len(m.get_input()) for m in self._mbs)

    def batches_per_epoch(self):
        return len(self._mbs)

    def shuffle(self):
        return self

    def data(self, train=True):
        return iter(self._mbs)


def collectives(rank, n, xs, ids, rows, vocab, tree, grads, w_full):
    """Every collective of ``parallel.collective`` on rank r's ``xs[r]``
    (4 ranks: a data mesh), their gradients, the mesh factories, the
    data-parallel placements, the sparse exchange and ZeRO-1's wires."""
    import torch
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import collective as C
    from bigdl_tpu_torch.parallel import mesh as M
    from bigdl_tpu_torch.parallel import sharding as S
    from bigdl_tpu_torch.parallel.allreduce import (
        AllReduceParameter, FlatParameter, sparse_embedding_grad_allreduce)
    from bigdl_tpu_torch.utils import engine
    out = {}
    mesh = M.set_default_mesh(_mesh())
    x = torch.from_numpy(xs[rank])
    out["psum"] = C.psum(x).numpy()
    out["pmean"] = C.pmean(x).numpy()
    out["gather"] = C.all_gather(x).numpy()
    out["gather_stacked"] = C.all_gather(x, tiled=False).numpy()
    out["scatter0"] = C.reduce_scatter(x).numpy()
    out["scatter1"] = C.reduce_scatter(x, scatter_dimension=1).numpy()
    out["ring1"] = C.ppermute_ring(x).numpy()
    out["ring3"] = C.ppermute_ring(x, shift=3).numpy()
    out["a2a"] = C.all_to_all(x, "data", 0, 1).numpy()
    out["a2a_t"] = C.all_to_all(x, "data", 1, 0).numpy()
    out["tree"] = {k: v.numpy() for k, v in C.all_reduce_mean(
        {"a": x, "b": 2 * x}).items()}
    xg = x.clone().requires_grad_(True)
    w = torch.arange(xg.numel() * n, dtype=torch.float32)
    loss = (C.all_gather(xg).reshape(-1) * w).sum() + \
        (C.psum(xg) * xg).sum() + (C.reduce_scatter(xg).sum() * (rank + 1))
    out["grad"] = torch.autograd.grad(loss, xg)[0].numpy()
    # meshes
    m2 = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    out["mesh2"] = (tuple(m2.mesh_dim_names), M.axis_size(m2, "data"),
                    M.axis_size(m2, "model"),
                    torch.distributed.get_process_group_ranks(
                        m2.get_group("model")))
    h = M.make_hybrid_mesh((1, 4), (1, 1), ("data", "model"), device="cpu")
    out["hybrid"] = (tuple(h.mesh.shape), tuple(h.mesh_dim_names))
    try:
        M.make_mesh((8,), ("data",), device="cpu")
    except ValueError as e:
        out["too_many"] = str(e)
    eng = engine.init(mesh_shape=(2, 2), mesh_axes=("data", "seq"),
                      device="cpu")
    out["engine_mesh"] = (engine.get_mesh() is eng,
                          tuple(eng.mesh_dim_names), engine.core_number())
    # placements: the global batch, this rank's rows
    batch = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    out["shard_batch"] = S.shard_batch(batch, mesh).numpy()
    out["stacked"] = S.shard_stacked_batch(
        np.stack([batch, batch + 100]), mesh).numpy()
    out["put"] = S.put_global(batch, mesh, S.data_sharding(mesh)).numpy()
    out["put_rep"] = S.put_global(batch, mesh, ()).numpy()
    out["gathered"] = S.gather_to_host(
        {"v": S.shard_batch(batch, mesh), "t": torch.tensor(3.0)}, mesh)
    out["multi"] = S.is_multi_process(mesh)
    out["survivors"] = S.surviving_devices(m2, [3])
    out["after_loss"] = M.mesh_ranks(S.mesh_after_loss(m2, [3])).tolist()
    out["after_loss_1d"] = M.mesh_ranks(
        S.mesh_after_loss(mesh, [1, 2])).tolist()
    # the sparse exchange, on rank r's block of ids / rows
    b = len(ids) // n
    out["sparse"] = sparse_embedding_grad_allreduce(
        torch.from_numpy(ids[rank * b:(rank + 1) * b]),
        torch.from_numpy(rows[rank * b:(rank + 1) * b]), vocab,
        "data").numpy()
    # ZeRO-1's wires on the same per-rank gradient vectors
    flat = FlatParameter(tree, n)
    out["flat"] = (flat.orig_size, flat.padded_size, flat.shard_size,
                   flat.flatten(tree))
    for wire in ("wire", "compress", "none"):
        arp = AllReduceParameter(
            SGD(learningrate=0.1), mesh,
            wire_dtype="bf16" if wire == "wire" else "none",
            compress="bf16" if wire == "compress" else "none")
        flat_w, st = arp.prepare(torch_tree(tree))
        new_full, _ = arp.update(torch.from_numpy(grads[rank]), flat_w, st,
                                 0.1)
        out["arp_" + wire] = new_full.numpy()
    return out


# -- the twin models, criteria and optim methods, by name ----------------------
# ``pkg`` is either package's ``nn`` (the test process builds JAX's twin
# with the same function)

def build(name, pkg):
    if name == "mlp":
        return pkg.Sequential(pkg.Linear(6, 8), pkg.ReLU(), pkg.Linear(8, 3))
    if name == "linear":
        return pkg.Sequential(pkg.Linear(6, 3))
    if name == "mlp_lsm":
        return pkg.Sequential(pkg.Linear(6, 8), pkg.ReLU(), pkg.Linear(8, 3),
                              pkg.LogSoftMax())
    if name == "mlp_drop":
        return pkg.Sequential(pkg.Linear(6, 8), pkg.ReLU(), pkg.Dropout(0.5),
                              pkg.Linear(8, 3))
    if name == "bn_net":
        return pkg.Sequential(
            pkg.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, with_bias=False,
                                   format="NHWC"),
            pkg.SpatialBatchNormalization(4, data_format="NHWC"), pkg.ReLU(),
            pkg.View(4 * 6 * 6), pkg.Linear(4 * 6 * 6, 3))
    if name == "masked":
        return pkg.Sequential(pkg.LookupTable(20, 8), pkg.Linear(8, 5),
                              pkg.LogSoftMax())
    if name == "sparse":
        m = pkg.Sequential()
        m.add(pkg.LookupTable(512, 16))
        m.add(pkg.TemporalMaxPooling(4))
        m.add(pkg.Squeeze(2))
        m.add(pkg.Linear(16, 5))
        m.add(pkg.LogSoftMax())
        return m
    raise KeyError(name)


def criterion(name, pkg):
    return {"nll": lambda: pkg.ClassNLLCriterion(),
            "ce": lambda: pkg.CrossEntropyCriterion(),
            "masked": lambda: pkg.TimeDistributedMaskCriterion(
                pkg.ClassNLLCriterion(), 0),
            # applied row by row (vmap), then divided by the global count
            "masked_ce": lambda: pkg.TimeDistributedMaskCriterion(
                pkg.CrossEntropyCriterion(), 0),
            # a plain sum over the batch, divided by a constant
            "smoothl1w": lambda: pkg.SmoothL1CriterionWithWeights(1.0, 4),
            # size_average=False: the sum over the batch
            "distkl_sum": lambda: pkg.DistKLDivCriterion(
                size_average=False)}[name]()


def method(name, optim):
    return {"sgd": lambda: optim.SGD(learningrate=0.05),
            "sgd1": lambda: optim.SGD(learningrate=0.1),
            "sgdm": lambda: optim.SGD(learningrate=0.1, momentum=0.9),
            "adam": lambda: optim.Adam(learningrate=0.01)}[name]()


def port_model(case):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn.module import copy_tree_into
    model = LeNet5(10, device="cpu") if case["model"] == "lenet" else \
        build(case["model"], nn)
    copy_tree_into(model.params, case["weights"])
    if case.get("state") is not None:
        copy_tree_into(model.state, case["state"])
    if case.get("freeze") is not None:
        model[case["freeze"]].freeze()
    return model


def port_data(case):
    from bigdl_tpu_torch.dataset import DataSet, Sample
    kind, a, b = case["data"]
    if kind == "fixed":
        return FixedBatches(list(zip(a, b)))
    return DataSet.array([Sample(f, l) for f, l in zip(a, b)])


def train_case(case, mesh):
    """One training run of ``case`` (a dict: model, weights, data, crit,
    method, iters, batch, mode, kw, setup): the port's trained params and
    model state, the optimizer and the model."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.optim import (DistriOptimizer, LocalOptimizer,
                                       max_iteration)
    model = port_model(case)
    args = (model, port_data(case), criterion(case["crit"], nn),
            method(case["method"], optim), max_iteration(case["iters"]))
    if case["mode"] == "local":
        opt = LocalOptimizer(*args, batch_size=case["batch"], device="cpu")
    else:
        opt = DistriOptimizer(*args, batch_size=case["batch"], mesh=mesh,
                              parameter_mode=case["mode"],
                              **case.get("kw", {}))
    setup(opt, case, optim)
    opt.optimize()
    return {"params": host(model.params), "state": host(model.state)}, \
        opt, model


def setup(opt, case, optim):
    """Apply ``case['setup']``'s calls to either package's optimizer
    (``optim``: that package's optim module; a checkpoint every
    iteration into the given directory)."""
    for name, a in case.get("setup", ()):
        if name == "set_checkpoint":
            a = (optim.several_iteration(1),) + tuple(a)
        getattr(opt, name)(*a)


def distri_cases(rank, n, cases, tmp):
    """Every training case on the world's data mesh, then the factory,
    the validator and the summaries: rank 0's results."""
    import torch
    from bigdl_tpu_torch import nn, observability as obs, optim
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.optim import (DistriOptimizer, DistriValidator,
                                       Evaluator, LocalOptimizer, Loss,
                                       Optimizer, Top1Accuracy,
                                       max_iteration, several_iteration)
    from bigdl_tpu_torch.visualization import (TrainSummary,
                                               ValidationSummary)
    mesh = _mesh()
    out = {}
    for case in cases:
        if case.get("observe"):
            obs.enable()
            obs.registry().reset()
        res, opt, model = train_case(case, mesh)
        if case.get("observe"):
            reg = obs.registry()
            res["counters"] = {
                k: reg.get(k).value for k in (
                    "collective/sparse_grad_wire_traced_bytes",
                    "collective/grad_dense_traced_bytes",
                    "collective/sparse_layers_selected")
                if reg.get(k) is not None}
            obs.disable()
        res["selected"] = getattr(opt, "_sparse_embedding_enabled",
                                  lambda: None)()
        res["metrics"] = {k: len(v) for k, v in opt.metrics.values.items()}
        if case.get("ckpt"):
            res["ckpt"] = sorted(os.listdir(case["ckpt"]))
        out[case["name"]] = res
    # the factory: a mesh of more than one rank builds the distributed one
    lenet = next(c for c in cases if c["model"] == "lenet")
    m = port_model(lenet)
    ds = port_data(lenet)
    kinds = [type(Optimizer(m, ds, nn.ClassNLLCriterion(), mesh=mesh)),
             type(Optimizer(m, ds, nn.ClassNLLCriterion())),
             type(Optimizer.create(m, ds, nn.ClassNLLCriterion()))]
    out["factory"] = [k.__name__ for k in kinds]
    try:
        DistriOptimizer(m, ds, nn.ClassNLLCriterion(), mesh=mesh,
                        parameter_mode="zero1", sparse_embedding=True)
    except ValueError as e:
        out["refuse_zero1_sparse"] = str(e)
    opt = DistriOptimizer(m, ds, nn.ClassNLLCriterion(), mesh=mesh,
                          sparse_embedding=True)
    try:
        opt._sparse_embedding_path()
    except ValueError as e:
        out["refuse_no_embedding"] = str(e)
    reg = nn.Sequential(nn.LookupTable(
        64, 8, w_regularizer=optim.L2Regularizer(1e-4)), nn.Squeeze(2))
    try:
        DistriOptimizer(reg, ds, nn.ClassNLLCriterion(), mesh=mesh,
                        sparse_embedding=True)._sparse_embedding_path()
    except ValueError as e:
        out["refuse_regularized"] = str(e)
    emb = nn.Sequential(nn.LookupTable(64, 8), nn.Squeeze(2))
    out["auto"] = [DistriOptimizer(
        mm, ds, nn.ClassNLLCriterion(), mesh=mesh, **kw)
        ._sparse_embedding_enabled() for mm, kw in (
            (emb, {}), (emb, {"sparse_embedding": False}), (m, {}),
            (reg, {}), (emb, {"parameter_mode": "zero1"}))]
    # validation sharded over the ranks, against the whole data set here
    vfeats, vlabels = lenet["val"]
    val = DataSet.array([Sample(f, l) for f, l in zip(vfeats, vlabels)])
    methods = [Top1Accuracy(), Loss(nn.ClassNLLCriterion())]
    m.evaluate()
    dv = DistriValidator(m).evaluate(val, methods, 32)
    ev = Evaluator(m).evaluate(val, methods, 32)
    out["validator"] = ([r.result() for r in dv], [r.result() for r in ev])
    # DistriOptimizer with validation and summaries (the first rank
    # writes them)
    m = port_model(lenet)
    opt = DistriOptimizer(m, port_data(lenet), nn.ClassNLLCriterion(),
                          optim.SGD(learningrate=0.2), max_iteration(6),
                          batch_size=64, mesh=mesh, parameter_mode="zero1")
    opt.set_validation(several_iteration(2), val, methods, 32)
    ts = TrainSummary(tmp, "distri")
    vs = ValidationSummary(tmp, "distri")
    opt.set_train_summary(ts)
    opt.set_val_summary(vs)
    opt.optimize()
    out["summaries"] = (ts.read_scalar("Loss"),
                        vs.read_scalar("Top1Accuracy"))
    return out if rank == 0 else None


def uneven_split(rank, n, sizes):
    """Ranks whose data sets give different batch counts: every rank must
    refuse at setup, within the world's deadline."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.optim import DistriOptimizer, max_iteration
    rng = np.random.RandomState(rank)
    ds = DataSet.array([Sample(rng.randn(6).astype(np.float32),
                               np.float32(1)) for _ in range(sizes[rank])])
    model = build("mlp", nn)
    opt = DistriOptimizer(model, ds, nn.CrossEntropyCriterion(),
                          optim.SGD(learningrate=0.1), max_iteration(4),
                          batch_size=8, mesh=_mesh())
    try:
        opt.optimize()
    except ValueError as e:
        return str(e)
    return None


def resume_zero1(rank, n, case, ckpt, iters, out_dir, every):
    """Load ``ckpt`` (either package's) into a ZeRO-1 run on this world,
    train to ``iters`` writing a checkpoint every ``every`` iterations into
    ``out_dir``: rank 0's params and its newest checkpoint's payload."""
    import pickle as pk
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.optim import DistriOptimizer, max_iteration
    from bigdl_tpu_torch.parallel.elastic import find_latest_checkpoint
    model = port_model(case)
    opt = DistriOptimizer(model, port_data(case), criterion(case["crit"], nn),
                          method(case["method"], optim),
                          max_iteration(iters), batch_size=case["batch"],
                          mesh=_mesh(), parameter_mode="zero1")
    opt.load_checkpoint(ckpt)
    opt.set_checkpoint(optim.several_iteration(every), out_dir)
    opt.optimize()
    if rank:
        return None
    with open(find_latest_checkpoint(out_dir), "rb") as f:
        payload = pk.load(f)
    return host(model.params), payload


def failure_world(rank, n):
    """The detectors on 4 ranks: probes of a 1-D and a 2-D mesh, a
    healthy heartbeat, a rank whose counter stops, the straggler report;
    last, rank 0 alone probes and beats while the others have left (a
    hung collective: the probe fails and the beat raises within their
    timeouts)."""
    import torch
    from bigdl_tpu_torch.parallel import mesh as M
    from bigdl_tpu_torch.parallel.failure import (Heartbeat, HeartbeatLost,
                                                  StragglerMonitor,
                                                  probe_mesh)
    out = {}
    mesh = _mesh()
    p = probe_mesh(mesh, timeout_s=30)
    out["probe"] = (p.ok, p.n_devices, p.error)
    p = probe_mesh(M.make_mesh((2, 2), ("data", "model"), device="cpu"),
                   timeout_s=30)
    out["probe2"] = (p.ok, p.n_devices)
    hb = Heartbeat(stale_after=2)
    out["healthy"] = [hb.beat(timeout_s=30) for _ in range(3)]

    class Stuck(Heartbeat):
        """A rank whose loop stopped advancing: it keeps sending 1."""
        def _gather(self, value):
            return super()._gather(1 if rank == 3 else value)

    hb = Stuck(stale_after=2)
    out["stale"] = [hb.beat() for _ in range(4)]
    sm = StragglerMonitor(threshold=1.5, persist_after=1)
    for _ in range(3):
        sm.record(0.5 if rank == 2 else 0.1)
    out["straggler"] = sm.report()
    if rank == 0:
        torch.distributed.barrier()
        time.sleep(0.5)                 # the others have left
        p = probe_mesh(mesh, timeout_s=1.0)
        out["probe_lost"] = (p.ok, p.error)
        try:
            Heartbeat().beat(timeout_s=1.0)
        except HeartbeatLost as e:
            out["beat_lost"] = str(e)
    else:
        torch.distributed.barrier()
    return out


def remediation_world(rank, n, case, ckdir):
    """One rank: the remediation policy's detectors on a distributed
    run - a heartbeat peer that stops (a halt with a checkpoint and the
    peer as ``lost_processes``), the straggler monitor fed every step's
    time, and the stall remediation's mesh probe (healthy: the stall is
    transient and the beacon re-arms; failed: a PERMANENT halt)."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.optim import (DistriOptimizer, RemediationPolicy,
                                       max_iteration)
    from bigdl_tpu_torch.optim import optimizer as O
    from bigdl_tpu_torch.parallel.failure import (
        Heartbeat, MeshProbeResult, StragglerMonitor, TrainingHalted)

    class PeerStops(Heartbeat):
        def _gather(self, value):
            return [value, 1]           # rank 1 stuck at its first beat

    out = {}
    sm = StragglerMonitor()
    opt = DistriOptimizer(port_model(case), port_data(case),
                          criterion(case["crit"], nn),
                          method(case["method"], optim), max_iteration(8),
                          batch_size=case["batch"], mesh=_mesh(),
                          parameter_mode="zero1")
    opt.set_checkpoint(optim.several_iteration(100), ckdir)
    opt.set_remediation(RemediationPolicy(
        heartbeat=PeerStops(stale_after=2), heartbeat_every=1,
        straggler_monitor=sm, straggler_every=2))
    try:
        opt.optimize()
    except TrainingHalted as h:
        out["halt"] = (h.cause, h.lost_processes, h.neval,
                       os.path.basename(h.checkpoint_path or ""))
    out["straggler_times"] = len(sm.times)

    class Beacon:
        name = "optim/step"
        rearmed = False

        def rearm(self):
            self.rearmed = True

    b = Beacon()
    opt._running = True
    opt._remediate_stall(b, 5.0)
    out["stall_ok"] = (b.rearmed, opt._halt_requested)
    real = O.probe_mesh
    O.probe_mesh = lambda mesh, timeout_s: MeshProbeResult(
        False, 1, 0.1, "injected")
    try:
        opt._remediate_stall(Beacon(), 5.0)
    finally:
        O.probe_mesh = real
    h = opt._halt_requested
    out["stall_dead"] = (h.cause, h.failure_class)
    return out


def elastic_world(rank, n, case, ckdir):
    """ZeRO-1 on 2 ranks halts after step 2 naming rank 1 lost; the
    runner resumes rank 0 alone from the canonical checkpoint to step 4.
    Rank 0 then trains the same 4 steps uninterrupted on one rank."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.optim import DistriOptimizer, Trigger
    from bigdl_tpu_torch.parallel.elastic import (ElasticRunner,
                                                  data_parallel_factory)
    from bigdl_tpu_torch.parallel.failure import TrainingHalted
    attempts = []

    def make(mesh):
        attempt = len(attempts)
        attempts.append(mesh.size())

        def end(st):
            if attempt == 0 and st["neval"] == 2:
                raise TrainingHalted("drill", lost_processes=[1],
                                     neval=st["neval"])
            return st["neval"] >= 4

        opt = DistriOptimizer(port_model(case), port_data(case),
                              criterion(case["crit"], nn),
                              method(case["method"], optim), Trigger(end),
                              batch_size=case["batch"], mesh=mesh,
                              parameter_mode="zero1")
        opt.set_checkpoint(optim.several_iteration(1), ckdir)
        return opt

    runner = ElasticRunner(data_parallel_factory(make), ckdir,
                           max_restarts=1, aggregate_bundles=False)
    model = runner.run()
    if rank:
        return {"model": model, "attempts": attempts}
    opt = DistriOptimizer(port_model(case), port_data(case),
                          criterion(case["crit"], nn),
                          method(case["method"], optim),
                          optim.max_iteration(4), batch_size=case["batch"],
                          mesh=_mesh(), parameter_mode="zero1")
    opt.optimize()
    return {"elastic": host(model.params), "straight": host(opt.model.params),
            "attempts": attempts, "restarts": runner.restarts,
            "halts": [h.cause for h in runner.halts]}


# -- model parallelism -------------------------------------------------------

def _lm(cfg, weights):
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn.module import copy_tree_into
    m = TransformerLM(device="cpu", **cfg)
    copy_tree_into(m.params, weights)
    return m


def _serve(sched, prompts, max_new):
    with sched:
        futs = [sched.submit(p, max_new) for p in prompts]
        return [np.asarray(f.result(timeout=60)) for f in futs]


def _pool(sched):
    return [(k.clone().numpy(), v.clone().numpy())
            for k, v in sched.kv.pages()]


def mesh_serving(rank, n, cfg, weights, shape, axes, placement, sched_kw,
                 prompts, max_new, prefix_prompts, swap_prompts):
    """``DecodeScheduler(mesh=, placement=)`` on a mesh of ``shape`` /
    ``axes`` against the one-rank scheduler each rank also runs alone:
    rank 0's tokens (the plain drill, a prefix warm hit and a hot swap
    mid-traffic), every rank's pool after the plain drill and its shapes.
    The other ranks run the worker loop under the same ``with``."""
    import time
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import DecodeScheduler
    from bigdl_tpu_torch.parallel.sharding import fsdp_specs
    model = _lm(cfg, weights)
    out = {}
    mesh = make_mesh(shape, axes, device="cpu")
    if placement == "fsdp256":       # slices at the test's small widths
        placement = lambda p: fsdp_specs(p, mesh, min_elems=256)  # noqa
    solo = DecodeScheduler(model, **sched_kw)
    out["solo"] = _serve(solo, prompts, max_new)
    out["solo_pool"] = _pool(solo)
    sched = DecodeScheduler(model, mesh=mesh, placement=placement,
                            **sched_kw)
    out["wq"] = tuple(sched.registry.current().params["block0"]["attn"]
                      ["wq"].shape)
    out["resident"] = sum(t.numel() for t in
                          _flat(sched.registry.current().params).values())
    out["page"] = tuple(sched.kv.pages()[0][0].shape)
    with sched:
        if rank == 0:
            futs = [sched.submit(p, max_new) for p in prompts]
            out["tokens"] = [np.asarray(f.result(timeout=60)) for f in futs]
    out["pool"] = _pool(sched)
    # a prefix warm hit: the second request adopts the first's blocks
    sched = DecodeScheduler(model, mesh=mesh, placement=placement,
                            **sched_kw)
    with sched:
        if rank == 0:
            out["prefix"] = [np.asarray(sched.submit(p, max_new)
                                        .result(timeout=60))
                             for p in prefix_prompts]
            out["prefix_stats"] = {k: sched.stats()[k] for k in
                                   ("prefix_hits", "prefix_reused_tokens")}
    # a hot swap mid-traffic: admitted requests keep v0
    sched = DecodeScheduler(model, mesh=mesh, placement=placement,
                            **sched_kw)
    new = {k: v * 1.5 for k, v in _flat(model.params).items()}
    with sched:
        if rank == 0:
            pre = [sched.submit(p, 12) for p in swap_prompts]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                st = sched.stats()
                if st["active"] + st["prefilling"] + st["completed"] >= 3:
                    break
                time.sleep(0.005)
            v1 = sched.swap(_unflat(new))
            post = sched.submit(swap_prompts[0], 8)
            out["swap_pre"] = [np.asarray(f.result(timeout=60)) for f in pre]
            out["swap_post"] = np.asarray(post.result(timeout=60))
            out["swap_versions"] = ([f.version for f in pre], post.version,
                                    v1)
    out["swap_wq"] = tuple(sched.registry.get("v1").params["block0"]["attn"]
                           ["wq"].shape)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v.detach().clone()
    return out


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def mesh_engine(rank, n, weights, shape, axes, placement, max_batch, xs):
    """``ServingEngine(mesh=, placement=)`` over LeNet-5 on a mesh of
    ``shape`` / ``axes``: rank 0's outputs for ``xs``, the bucket floor and
    buckets, and every rank's resident slice of the largest leaf."""
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn.module import copy_tree_into
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import ServingEngine
    model = LeNet5(10, device="cpu")
    copy_tree_into(model.params, weights)
    mesh = make_mesh(shape, axes, device="cpu")
    eng = ServingEngine(model, input_shape=(784,), max_batch=max_batch,
                        mesh=mesh, placement=placement, name="mesh")
    big = max(_flat(eng.registry.current().params).items(),
              key=lambda kv: _flat(model.params)[kv[0]].numel())
    from bigdl_tpu_torch.parallel.sharding import (batch_shard_count,
                                                   serving_batch_spec)
    spec = serving_batch_spec(mesh)
    out = {"floor": eng._bucket_floor, "buckets": eng._buckets(),
           "spec": spec, "count": batch_shard_count(mesh, spec),
           "bucket_for": [eng._bucket_for(i) for i in range(1, max_batch
                                                            + 1)],
           "big": (big[0], tuple(big[1].shape))}
    with eng:
        if rank == 0:
            out["outs"] = [eng.submit(x).result(timeout=30) for x in xs]
    try:
        ServingEngine(model, input_shape=(784,), max_batch=max_batch + 1,
                      mesh=mesh, placement=placement, warmup=False)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def mp_generate(rank, n, cfg, weights, ids, max_new, placement):
    """``generate`` over this rank's ``placement`` ("tp": a ``model`` mesh,
    "fsdp": a ``data`` mesh with 256-element slices) and alone: (tokens,
    last-step logits) of both, and the resident parameter elements."""
    import torch
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import over
    from bigdl_tpu_torch.parallel.sharding import (fsdp_specs,
                                                   place_with_specs,
                                                   transformer_tp_specs)
    model = _lm(cfg, weights)
    axis = "model" if placement == "tp" else "data"
    mesh = make_mesh((n,), (axis,), device="cpu")
    specs = (transformer_tp_specs(model.params) if placement == "tp"
             else fsdp_specs(model.params, mesh, min_elems=256))
    placed = place_with_specs(model.params, mesh, specs)
    prompt = torch.from_numpy(ids)
    solo = model.generate(model.params, prompt, max_new)
    solo_logits, _ = model.prefill(model.params, solo, solo.shape[1] + 1)
    with over(mesh):
        got = model.generate(placed, prompt, max_new)
        logits, _ = model.prefill(placed, got, got.shape[1] + 1)
    return {"solo": solo.numpy(), "tokens": got.numpy(),
            "solo_logits": solo_logits.numpy(), "logits": logits.numpy(),
            "resident": sum(t.numel() for t in _flat(placed).values()),
            "whole": sum(t.numel() for t in _flat(model.params).values())}


def mp_training(rank, n, cfg, weights, x, y, placement, steps):
    """``steps`` SGD steps (lr 0.1, momentum 0.9) of the flagship's recipe
    (``hidden_states``, ``lm_loss_chunked``, ``torch.autograd.grad``,
    ``SGD.update``) over this rank's ``placement``: "tp" on a ``model``
    mesh (every rank the whole batch), "fsdp" on a ``data`` mesh with
    256-element slices (this rank's rows; each rank's loss is its share,
    the replicated leaves' gradients are summed over ``data`` as in data
    parallelism, the slices' arrive summed through the gathers). Returns
    the losses and this rank's parameter blocks after each step."""
    import torch
    from bigdl_tpu_torch.models import lm_loss_chunked
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import all_reduce_sum, over, psum
    from bigdl_tpu_torch.parallel.sharding import (fsdp_specs, gather_param,
                                                   place_with_specs,
                                                   shard_batch,
                                                   transformer_tp_specs)
    model = _lm(cfg, weights)
    axis = "model" if placement == "tp" else "data"
    mesh = make_mesh((n,), (axis,), device="cpu")
    specs = (transformer_tp_specs(model.params) if placement == "tp"
             else fsdp_specs(model.params, mesh, min_elems=256))
    p = place_with_specs(model.params, mesh, specs)
    flat_p, flat_s = _flat_refs(p), _flat_refs(specs)
    for t in flat_p.values():
        t.requires_grad_(True)
    xb, yb = torch.from_numpy(x), torch.from_numpy(y)
    if placement == "fsdp":
        xb, yb = shard_batch(x, mesh), shard_batch(y, mesh)
    optim = SGD(learningrate=0.1, momentum=0.9)
    state = optim.init_state(p)
    losses, params = [], []
    with over(mesh):
        for _ in range(steps):
            h = model.hidden_states(p, xb, training=False)
            emb = gather_param(p["embed"], model.embed.shape)
            loss = lm_loss_chunked(h, emb, yb, chunk=4)
            if placement == "fsdp":
                loss = loss / n
            keys = list(flat_p)
            grads = torch.autograd.grad(loss, [flat_p[k] for k in keys])
            g = dict(zip(keys, grads))
            if placement == "fsdp":
                for k in keys:
                    if not flat_s[k]:
                        g[k] = all_reduce_sum(g[k], "data")
                loss = psum(loss.detach(), "data")
            with torch.no_grad():
                optim.update(_unflat(g), p, state, 0.1)
            losses.append(float(loss))
            params.append({k: v.detach().clone().numpy()
                           for k, v in flat_p.items()})
    return {"losses": losses, "params": params}


def _flat_refs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_refs(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def mp_cases(rank, n, cases):
    """Each ``(kind, kwargs)`` of ``cases`` (``"generate"``: :func:`
    mp_generate`, ``"train"``: :func:`mp_training`) in one world, in
    order; their results in a list."""
    jobs = {"generate": mp_generate, "train": mp_training}
    return [jobs[kind](rank, n, **kw) for kind, kw in cases]


def _seq_block(a, rank, n, dim):
    import torch
    k = a.shape[dim] // n
    return torch.from_numpy(np.ascontiguousarray(
        np.take(a, range(rank * k, (rank + 1) * k), axis=dim)))


def seq_parallel(rank, n, qkv, attn_cases, attn_x, attn_weights, decode):
    """Sequence parallelism on a ``seq`` mesh of every rank: for each
    function of ``parallel`` (ring, ring-flash, a2a with and without
    flash; causal and not) this rank's output block for ``qkv`` (global
    (B, H, T, D) arrays) and its blocks of d(sum(sin(out)))/d(q, k, v);
    ``Attention(seq_axis=)`` for each ``(impl, kvh)`` of ``attn_cases``
    (RoPE, causal) on ``attn_x``: its output block, its input gradient
    block and the parameters' gradients summed over the ranks; and the
    sequence-sharded decode of ``decode`` (per step q, k_t, v_t over
    (nH, kvH) cases): every step's output on this rank."""
    import torch
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.module import copy_tree_into
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import all_reduce_sum, over
    from bigdl_tpu_torch.parallel.ring_attention import make_ring_attention
    from bigdl_tpu_torch.parallel.ring_flash import make_ring_flash_attention
    from bigdl_tpu_torch.parallel.seq_all_to_all import a2a_attention
    from bigdl_tpu_torch.parallel.seq_decode import make_seq_sharded_decoder
    mesh = make_mesh((n,), ("seq",), device="cpu")

    def a2a(flash, causal):
        def f(q, k, v):
            with over(mesh):
                return a2a_attention(q, k, v, "seq", causal, flash)
        return f
    fns = {}
    for causal in (False, True):
        fns[("ring", causal)] = make_ring_attention(mesh, "seq", causal)
        fns[("ring_flash", causal)] = make_ring_flash_attention(mesh, "seq",
                                                                causal)
        fns[("a2a_flash", causal)] = a2a(True, causal)
        fns[("a2a", causal)] = a2a(False, causal)
    out = {}
    for key, f in fns.items():
        q, k, v = (_seq_block(a, rank, n, 2).requires_grad_(True)
                   for a in qkv)
        o = f(q, k, v)
        grads = torch.autograd.grad(o.sin().sum(), (q, k, v))
        out[key] = (o.detach().numpy(), [g.numpy() for g in grads])
    for impl, kvh in attn_cases:
        H, heads = attn_x.shape[-1], 8
        m = nn.Attention(H, heads, causal=True, use_flash=True,
                         seq_axis="seq", seq_impl=impl, num_kv_heads=kvh,
                         rope=True)
        copy_tree_into(m.params, attn_weights[kvh])
        x = _seq_block(attn_x, rank, n, 1).requires_grad_(True)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in m.params.items()}
        with over(mesh):
            o = m.call(params, x)
            names = sorted(params)
            grads = torch.autograd.grad(o.sin().sum(),
                                        [x] + [params[k] for k in names])
            pg = {k: all_reduce_sum(g, "seq").numpy()
                  for k, g in zip(names, grads[1:])}
        out[("attn", impl, kvh)] = (o.detach().numpy(), grads[0].numpy(),
                                    pg)
    dec = make_seq_sharded_decoder(mesh, "seq")
    for (nh, kvh), steps in decode.items():
        B, Tmax, D = 2, 16, 8
        kc = torch.zeros(B, kvh, Tmax // n, D)
        vc = torch.zeros(B, kvh, Tmax // n, D)
        outs = []
        for pos, (q, kt, vt) in enumerate(steps):
            o, kc, vc = dec(*(torch.from_numpy(a) for a in (q, kt, vt)), kc,
                            vc, pos)
            outs.append(o.numpy())
        out[("decode", nh, kvh)] = np.stack(outs)
    return out


def pipe_moe(rank, n, stages, x, y, router_w, ws, moe_x, cap):
    """``gpipe`` over a ``pipe`` mesh of every rank (this rank holds stage
    ``rank`` of ``stages``): the outputs and this stage's gradients of a
    mean squared error share; and ``moe_ffn`` over an ``expert`` mesh
    (this rank's expert ``ws[rank]`` and tokens): outputs, the aux loss,
    the router's gradient summed over the ranks and this expert's."""
    import torch
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import (all_reduce_sum, over,
                                                     pmean)
    from bigdl_tpu_torch.parallel.moe import moe_ffn
    from bigdl_tpu_torch.parallel.pipeline import gpipe
    out = {}
    pmesh = make_mesh((n,), ("pipe",), device="cpu")
    p = {k: torch.from_numpy(np.ascontiguousarray(v[rank:rank + 1]))
         .requires_grad_(True) for k, v in stages.items()}
    run = gpipe(lambda sp, h: torch.tanh(h @ sp["w"] + sp["b"]), "pipe")
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    with over(pmesh):
        o = run(p, xs)
        loss = ((o - ys) ** 2).mean() / n      # this rank's share
        g = torch.autograd.grad(loss, [p["w"], p["b"]])
    out["pipe"] = (o.detach().numpy(), [t.numpy() for t in g])
    emesh = make_mesh((n,), ("expert",), device="cpu")
    rw = torch.from_numpy(router_w).requires_grad_(True)
    we = {"w": torch.from_numpy(np.ascontiguousarray(ws[rank:rank + 1]))
          .requires_grad_(True)}
    xe = _seq_block(moe_x, rank, n, 0)
    run = moe_ffn(lambda ep, h: torch.tanh(h @ ep["w"]), "expert", cap)
    with over(emesh):
        ye, aux = run(rw, we, xe)
        loss = (pmean((ye ** 2).mean(), "expert") + 0.01 * aux) / n
        gr, gw = torch.autograd.grad(loss, [rw, we["w"]])
        gr = all_reduce_sum(gr, "expert")
    out["moe"] = (ye.detach().numpy(), float(aux), gr.numpy(), gw.numpy())
    return out


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
