"""Device meshes (counterpart of ``bigdl_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group (``utils.engine.init_process_group``), with JAX's axis
names as its ``mesh_dim_names``: ``data`` (data parallelism), ``model``,
``seq``. Where JAX lays devices out, the port lays out ranks, one process
each; the mesh's device type is the group's device (``cuda`` under NCCL,
``cpu`` under gloo). ``get_group(axis)`` is the process group a
collective over that axis runs on (``parallel.collective``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["make_mesh", "make_hybrid_mesh", "data_parallel_mesh",
           "set_default_mesh", "get_default_mesh", "axis_size",
           "mesh_ranks", "mesh_device"]

_default_mesh = None


def _group(device):
    from ..utils import engine
    return engine.init_process_group(device=device)


def _build(ranks: np.ndarray, axes, device):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    grp = _group(device)
    mesh = DeviceMesh(grp["device"].type, torch.as_tensor(ranks),
                      mesh_dim_names=tuple(axes))
    mesh._bigdl_device = grp["device"]
    return mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None,
              device=None):
    """A mesh of ``shape`` with axis names ``axes`` over the ranks
    ``devices`` (every rank of the group by default), laid out in rank
    order; the group is joined on ``device`` if it is not yet. Raises
    ``ValueError`` when the mesh needs more ranks than there are."""
    n = int(np.prod(shape))
    if devices is not None and n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grp = _group(device)
    ranks = list(devices) if devices is not None \
        else list(range(grp["world_size"]))
    if n > len(ranks):
        raise ValueError(f"mesh needs {n} devices, have {len(ranks)}")
    arr = np.asarray(ranks[:n], dtype=np.int64).reshape(tuple(shape))
    return _build(arr, axes, device)


def make_hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                     axes: Sequence[str], device=None):
    """A mesh over nodes x ranks of a node (JAX's DCN x ICI): axis i has
    ``ici_shape[i] * dcn_shape[i]`` ranks, its DCN factor spanning nodes
    and its ICI factor staying inside one. A node is the
    ``LOCAL_WORLD_SIZE`` ranks torchrun starts on one host (every rank
    when that variable is unset, so on one node DCN is 1)."""
    import os
    if not (len(ici_shape) == len(dcn_shape) == len(axes)):
        raise ValueError("ici_shape, dcn_shape and axes must align "
                         f"(got {ici_shape}, {dcn_shape}, {axes})")
    grp = _group(device)
    world = grp["world_size"]
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_ici, n_dcn = int(np.prod(ici_shape)), int(np.prod(dcn_shape))
    if n_ici != local or n_dcn * n_ici != world:
        raise ValueError(
            f"hybrid mesh ici {tuple(ici_shape)} x dcn {tuple(dcn_shape)} "
            f"does not cover {world // local} node(s) of {local} rank(s)")
    k = len(axes)
    # ranks are node-major: (dcn..., ici...) -> interleave per axis
    arr = np.arange(world).reshape(tuple(dcn_shape) + tuple(ici_shape))
    order = [i for pair in zip(range(k), range(k, 2 * k)) for i in pair]
    arr = arr.transpose(order).reshape(
        tuple(d * i for d, i in zip(dcn_shape, ici_shape)))
    return _build(arr, axes, device)


def data_parallel_mesh(n: Optional[int] = None, device=None):
    """A one-axis ``data`` mesh over the first ``n`` ranks (all of them
    by default)."""
    grp = _group(device)
    n = n or grp["world_size"]
    return make_mesh((n,), ("data",), list(range(grp["world_size"])),
                     device=device)


def set_default_mesh(mesh):
    global _default_mesh
    _default_mesh = mesh
    return mesh


def get_default_mesh():
    """The mesh collectives and the distributed optimizer use when given
    none: the one set last, else a data mesh over every rank."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = data_parallel_mesh()
    return _default_mesh


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def mesh_ranks(mesh) -> np.ndarray:
    """The mesh's ranks in its layout (an int array of its shape)."""
    return np.asarray(mesh.mesh.cpu().numpy())


def mesh_device(mesh):
    """The ``torch.device`` this rank's tensors of ``mesh`` live on."""
    dev = getattr(mesh, "_bigdl_device", None)
    if dev is not None:
        return dev
    from ..utils import engine
    return engine.process_group()["device"]
