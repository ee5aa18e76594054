"""Placement of batches and parameters on a mesh, the data-parallel half
(counterpart of ``bigdl_tpu/parallel/sharding.py``).

In JAX a placement is a ``NamedSharding`` and a placed array spans the
mesh. In the port each rank is a process that holds its own piece, so a
placement says what THIS rank holds: a replicated value in full, a value
sharded along an axis as its block of rows. :func:`shard_batch` takes the
GLOBAL batch, which every rank reads in the same order (the data set's
seeded shuffle), and keeps this rank's contiguous rows ``[r * B / n, (r +
1) * B / n)`` - the rows JAX's ``P('data')`` gives device r.
:func:`gather_to_host` is the way back: an all-gather of the blocks.

The tensor-parallel, FSDP and serving specs of JAX's module
(``transformer_tp_specs``, ``fsdp_specs``, ``serving_*``,
``place_with_specs``, ``tp_linear_rules``, ``constraint``) are the
model-parallel half of multi-GPU work and not ported yet.
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.table import Table
from .mesh import axis_size, mesh_device, mesh_ranks

__all__ = ["Placement", "replicated", "data_sharding", "is_multi_process",
           "put_global", "gather_to_host", "shard_batch",
           "shard_stacked_batch", "shard_params", "surviving_devices",
           "mesh_after_loss"]


class Placement(NamedTuple):
    """What a rank holds of a value on ``mesh``: ``spec[i]`` names the
    mesh axis dim i is split over (None: that dim whole); an empty spec
    is a replicated value."""
    mesh: object
    spec: Tuple[Optional[str], ...] = ()


def replicated(mesh):
    return Placement(mesh, ())


def data_sharding(mesh, axis: str = "data"):
    """The leading (batch) dim split over ``axis``."""
    return Placement(mesh, (axis,))


def is_multi_process(mesh) -> bool:
    """True when the mesh spans more than one process: in the port, more
    than one rank."""
    return mesh.size() > 1


def _rows(x, mesh, axis: str, dim: int = 0):
    """This rank's block of dim ``dim`` of ``x`` over ``axis``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    r = mesh.get_local_rank(axis)
    b = np.shape(x)[dim]
    if b % n:
        raise ValueError(f"batch of {b} rows does not split over {n} "
                         f"'{axis}' shards")
    k = b // n
    idx = [slice(None)] * (dim + 1)
    idx[dim] = slice(r * k, (r + 1) * k)
    return x[tuple(idx)]


def _map(fn, x):
    if x is None:
        return None
    if isinstance(x, Table):
        return Table(*(_map(fn, i) for i in x))
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    return fn(x)


def _place(x, device):
    from ..optim.staging import place_host_value
    return place_host_value(x, device)


def put_global(x, mesh, spec):
    """A value that every rank holds in full, placed with ``spec`` (a
    :class:`Placement`'s spec: ``()`` replicated, ``('data',)`` rows over
    ``data``, ``(None, 'data')`` dim 1 over ``data``): this rank's piece
    on the mesh's device."""
    spec = tuple(spec.spec if isinstance(spec, Placement) else spec or ())
    for d, ax in enumerate(spec):
        if ax is not None:
            x = _rows(x, mesh, ax, d)
    return _place(x, mesh_device(mesh))


def gather_to_host(tree, mesh):
    """This rank's blocks of a tree sharded along dim 0 over the mesh's
    ``data`` axis (ZeRO-1's optimizer state) -> the whole values as host
    numpy, on every rank (an all-gather, so every rank calls it at the
    same point); 0-d leaves are replicated and kept as they are."""
    names = tuple(mesh.mesh_dim_names)
    axis = "data" if "data" in names else names[0]
    n = axis_size(mesh, axis)
    group = mesh.get_group(axis) if n > 1 else None

    def one(t):
        t = t.detach()
        if t.dim() == 0 or n == 1:
            return t.cpu().numpy().copy()
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out.cpu().numpy()
    return _map(one, tree)


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of a GLOBAL host batch (every rank passes the same
    batch), on the mesh's device: the rows JAX's ``P(axis)`` places on
    this rank's device. Raises when the rows do not split evenly."""
    dev = mesh_device(mesh)
    return _map(lambda x: _place(_rows(x, mesh, axis), dev), batch)


def shard_stacked_batch(batch, mesh, axis: str = "data"):
    """A superstep stack ``[K, batch, ...]``: every step's rows split as
    :func:`shard_batch` splits them (dim 1); 1-d leaves whole."""
    dev = mesh_device(mesh)
    return _map(lambda x: _place(
        _rows(x, mesh, axis, 1) if np.ndim(x) >= 2 else x, dev), batch)


def shard_params(params, mesh):
    """Parameters every rank holds in full (the same seed everywhere), on
    the mesh's device."""
    dev = mesh_device(mesh)
    return _map(lambda t: t if isinstance(t, torch.Tensor)
                and t.device == dev else _place(t, dev), params)


def surviving_devices(mesh, lost_processes=()):
    """The ranks of ``mesh`` not in ``lost_processes``, in mesh order."""
    lost = set(lost_processes)
    return [int(r) for r in mesh_ranks(mesh).flat if int(r) not in lost]


def mesh_after_loss(mesh, lost_processes=(), devices=None,
                    axis: str = "data"):
    """The mesh after ranks are lost: the same axis names, ``axis``
    shrunk to the whole rows of the original mesh that survive, every
    other axis kept (JAX's rule: a model or sequence group is never
    regrouped across rows; survivors stranded in a broken row are
    dropped, with a warning). ``devices`` (ranks) overrides the
    ``lost_processes`` filter. The new mesh is built over the current
    process group, so every rank of it calls this at the same point."""
    from .mesh import _build
    if devices is None:
        devices = surviving_devices(mesh, lost_processes)
    devices = [int(d) for d in devices]
    if not devices:
        raise ValueError("no surviving devices to build a mesh from")
    axes = tuple(mesh.mesh_dim_names)
    if axis not in axes:
        raise ValueError(f"mesh has no {axis!r} axis (axes: {axes})")
    ax = axes.index(axis)
    arr = mesh_ranks(mesh)
    other = arr.size // arr.shape[ax]
    if other == 1:
        shape = tuple(len(devices) if a == axis else 1 for a in axes)
        return _build(np.asarray(devices).reshape(shape), axes,
                      mesh_device(mesh))
    surv = set(devices)
    rows = np.moveaxis(arr, ax, 0).reshape(arr.shape[ax], other)
    whole = [row for row in rows if all(int(d) in surv for d in row)]
    if not whole:
        raise ValueError(
            f"{len(devices)} surviving devices leave no whole {axis!r} "
            f"row of {other} devices intact (mesh axes {axes})")
    if len(whole) * other < len(devices):
        logging.getLogger(__name__).warning(
            "mesh_after_loss: dropping %d surviving devices stranded in "
            "broken %r rows of %d (keeping %d of %d)",
            len(devices) - len(whole) * other, axis, other,
            len(whole) * other, len(devices))
    rest = tuple(s for i, s in enumerate(arr.shape) if i != ax)
    new = np.moveaxis(np.asarray(whole).reshape((len(whole),) + rest), 0,
                      ax)
    return _build(new, axes, mesh_device(mesh))
