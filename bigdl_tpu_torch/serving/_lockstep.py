"""Lockstep serving over a mesh: the command channel that stands in for
JAX's single controller.

JAX drives every device of a mesh from one thread. The port runs one
process a rank, and the model's collectives (tensor-parallel sums, FSDP
gathers) need every rank to run every step with the same shapes in the
same order. So mesh rank 0 alone takes requests and decides, and before
each step and each write to the page pool it broadcasts a command; the
other ranks replay the commands in order (``DecodeScheduler`` and
``ServingEngine`` under ``mesh=``).
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from ..utils.carrier import TreeCarrier


def host(a):
    """A step operand as host numpy (a command to the other ranks)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _host_tree(t):
    if isinstance(t, dict):
        return {k: _host_tree(v) for k, v in t.items()}
    if isinstance(t, TreeCarrier):          # a quantized weight
        return t.map(_host_tree)
    return t.detach().cpu().clone() if isinstance(t, torch.Tensor) else t


class Lockstep:
    """The command channel of a serving loop over a mesh: mesh rank 0 (the
    root) broadcasts each command - a small picklable tuple - to every
    rank of the mesh (``broadcast_object_list`` on a group of the mesh's
    ranks, through host memory on gloo); the others receive them in order.
    Publishes recorded by the registry's listener go out before the next
    command, so a step never names a version a rank lacks. Sends are
    serialised by a lock; an idle root sends a keep-alive once a second so
    no rank waits out its group's timeout."""

    KEEPALIVE_S = 1.0

    def __init__(self, mesh):
        import torch.distributed as dist
        from ..parallel.mesh import mesh_ranks
        ranks = sorted(int(r) for r in mesh_ranks(mesh).flat)
        self.root = ranks[0]
        self.is_root = dist.get_rank() == self.root
        self.group = (None if len(ranks) == dist.get_world_size()
                      else dist.new_group(ranks,
                                          use_local_synchronization=True))
        backend = dist.get_backend(self.group)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if backend == "nccl" else torch.device("cpu"))
        self._outbox: deque = deque()
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._stopped = False

    def _bcast(self, box):
        import torch.distributed as dist
        dist.broadcast_object_list(box, src=self.root, group=self.group,
                                   device=self.device)
        return box[0]

    def on_publish(self, event, version, params, state):
        """Registry listener (under its lock): record only."""
        if event == "publish":
            self._outbox.append(("publish", version, _host_tree(params),
                                 _host_tree(state)))
        else:
            self._outbox.append(("retire", version))

    def send(self, cmd):
        with self._lock:
            while self._outbox:
                self._bcast([self._outbox.popleft()])
            self._bcast([cmd])
            self._last = time.monotonic()

    def keepalive(self):
        if time.monotonic() - self._last > self.KEEPALIVE_S:
            self.send(("idle",))

    def stop(self):
        if not self._stopped:
            self._stopped = True
            self.send(("stop",))

    def recv(self):
        return self._bcast([None])
