"""Elastic restart (counterpart of ``bigdl_tpu/parallel/elastic.py``).

A halt (``TrainingHalted``, from the remediation tier: a stale heartbeat
names the lost ranks as ``lost_processes``) ends an attempt with a
checkpoint; :class:`ElasticRunner` resumes on the ranks that survive. Its
state carries across: checkpoints hold ZeRO-1 state in the canonical
params-shaped form, so a snapshot written under N ranks restores under
N' (``AllReduceParameter.place_canonical_state``).

In JAX one program reshapes its mesh over the surviving devices. In the
port every rank is a process: after a halt that shrinks the membership a
rank that is not a survivor leaves the run (``run`` returns None there),
and the survivors form a NEW process group among themselves
(:func:`regroup`: a world of one over an in-process store, or a
rendezvous at the old group's address on the next port, on the backend
of the device), in which the factory builds the next attempt's
optimizer.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional

from .. import observability as obs
from ..observability import cluster as _cluster
from ..observability import flight as _flight
from ..observability import health as _health
from .failure import TrainingHalted

__all__ = ["ElasticRunner", "find_latest_checkpoint", "shrink_devices",
           "data_parallel_factory", "regroup"]

_LOG = logging.getLogger("bigdl_tpu_torch.parallel.elastic")


def find_latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The newest ``checkpoint*.bigdl`` under ``checkpoint_dir`` by
    modification time, or None."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    snaps = [os.path.join(checkpoint_dir, f)
             for f in os.listdir(checkpoint_dir)
             if f.startswith("checkpoint") and f.endswith(".bigdl")]
    return max(snaps, key=os.path.getmtime) if snaps else None


def shrink_devices(devices: List, halt: TrainingHalted) -> List:
    """Default membership update: drop the ranks the halt's
    ``lost_processes`` name (a halt that names none keeps the set: the
    restart is a plain retry at the same shape)."""
    if not halt.lost_processes:
        return list(devices)
    lost = set(halt.lost_processes)
    return [d for d in devices if d not in lost]


def regroup(survivors: List[int], attempt: int):
    """Leave the current process group and form a new one of
    ``survivors`` (global ranks of the old group, in order); returns this
    process's new rank, or None when it is not a survivor. A world of one
    needs no rendezvous; a larger one meets at the old group's TCP
    address with the port advanced by ``attempt``."""
    from ..utils import engine
    grp = dict(engine.process_group() or {})
    me = grp.get("rank", 0)
    engine.destroy_process_group()
    if me not in survivors:
        return None
    new_rank = survivors.index(me)
    init = None
    if len(survivors) > 1:
        method = grp.get("init_method") or ""
        host, _, port = method.rpartition(":")
        init = f"{host}:{int(port) + attempt}"
    # the backend follows the device again (a world that shared one card
    # over gloo regroups onto NCCL)
    engine.init_process_group(rank=new_rank, world_size=len(survivors),
                              init_method=init, device=grp.get("device"))
    return new_rank


class ElasticRunner:
    """Restart supervisor: ``factory(devices, attempt) -> optimizer``
    builds a FRESH optimizer for the ranks ``devices`` (in the current
    group) that writes its checkpoints into ``checkpoint_dir``; the runner
    loads the latest checkpoint (the last halt's own first), runs
    ``optimize()`` and, on :class:`TrainingHalted`, merges the flight
    bundles, shrinks the membership (``membership(devices, halt)``,
    :func:`shrink_devices` by default), regroups the survivors and goes
    again, up to ``max_restarts`` times and never below ``min_devices``.
    Returns the trained model (None on a rank that left)."""

    def __init__(self, factory: Callable, checkpoint_dir: str,
                 max_restarts: int = 2,
                 membership: Optional[Callable] = None,
                 devices: Optional[List] = None, min_devices: int = 1,
                 backoff_s: float = 0.0, aggregate_bundles: bool = True):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, "
                             f"got {max_restarts}")
        self.factory = factory
        self.checkpoint_dir = checkpoint_dir
        self.max_restarts = int(max_restarts)
        self.membership = membership or shrink_devices
        if devices is None:
            import torch.distributed as dist
            devices = list(range(dist.get_world_size()
                                 if dist.is_initialized() else 1))
        self.devices = list(devices)
        self.min_devices = int(min_devices)
        self.backoff_s = float(backoff_s)
        self.aggregate = aggregate_bundles
        self.restarts = 0
        self.halts: List[TrainingHalted] = []

    def run(self):
        devices = list(self.devices)
        resume_from = None
        for attempt in range(self.max_restarts + 1):
            opt = self.factory(devices, attempt)
            ckpt = resume_from \
                if resume_from and os.path.exists(resume_from) \
                else find_latest_checkpoint(self.checkpoint_dir)
            if ckpt is not None:
                opt.load_checkpoint(ckpt)
                _LOG.info("elastic attempt %d: resuming %s on %d devices",
                          attempt, os.path.basename(ckpt), len(devices))
            try:
                return opt.optimize()
            except TrainingHalted as halt:
                self.halts.append(halt)
                resume_from = halt.checkpoint_path
                import torch.distributed as dist
                first = not dist.is_initialized() or dist.get_rank() == 0
                if self.aggregate and first:
                    _flight.aggregate_bundles()
                    _cluster.write_aggregate(context={
                        "elastic_attempt": attempt,
                        "cause": halt.cause,
                        "neval": halt.neval,
                        "lost_processes": list(halt.lost_processes)})
                survivors = list(self.membership(devices, halt))
                if attempt >= self.max_restarts:
                    _LOG.error("restart budget (%d) exhausted; halting",
                               self.max_restarts)
                    raise
                if len(survivors) < self.min_devices:
                    _LOG.error(
                        "only %d devices survive (< min_devices=%d); "
                        "halting", len(survivors), self.min_devices)
                    raise
                self.restarts += 1
                if obs.enabled():
                    obs.gauge("elastic/restarts").set(self.restarts)
                _health.emit(
                    "elastic_restart", attempt=attempt + 1,
                    cause=halt.cause, neval=halt.neval,
                    devices_before=len(devices),
                    devices_after=len(survivors),
                    checkpoint=halt.checkpoint_path,
                    lost_processes=list(halt.lost_processes))
                if survivors != devices:
                    if regroup(survivors, attempt + 1) is None:
                        return None     # this rank is not a survivor
                    survivors = list(range(len(survivors)))
                devices = survivors
                if self.backoff_s > 0:
                    time.sleep(self.backoff_s)
        raise AssertionError("unreachable")


def data_parallel_factory(make_optimizer):
    """``make_optimizer(mesh) -> optimizer`` as an :class:`ElasticRunner`
    factory that builds a one-axis ``data`` mesh over the ranks it is
    given."""
    from .mesh import make_mesh

    def factory(devices, attempt):
        mesh = make_mesh((len(devices),), ("data",), devices=devices)
        return make_optimizer(mesh)

    return factory
