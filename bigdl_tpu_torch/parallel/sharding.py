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

The model-parallel half: :func:`transformer_tp_specs` (Megatron-style
tensor parallelism), :func:`fsdp_specs` (ZeRO-3 slices) and the serving
specs return exactly JAX's spec trees, as the port's spec tuples (``P()``
is ``()``, ``P(None, 'model')`` is ``(None, 'model')``,
``P(('replica', 'data'))`` is ``(('replica', 'data'),)``).
:func:`place_with_specs` keeps this rank's block of each leaf, as
:func:`put_global` does. JAX's compiler then inserts the collectives a
placement implies; the port's model finds the placement in the shapes of
the leaves it is given (``nn.attention``: a column-split ``wq`` is tensor
parallel, any other leaf smaller than the module's own is an FSDP slice)
and runs the collectives itself, on the mesh ``collective.over`` sets.
:func:`gather_param` is that FSDP gather: the whole leaf from the slices,
differentiable (its gradient is the reduce-scatter).
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
           "mesh_after_loss", "transformer_tp_specs", "fsdp_specs",
           "SERVING_BATCH_AXES", "serving_batch_spec", "batch_shard_count",
           "serving_param_specs", "place_with_specs", "tp_linear_rules",
           "constraint", "gather_param"]


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


def _axes_index(mesh, axes):
    """(n, r): how many blocks a dim split over ``axes`` (one axis name or
    a tuple, major first, as JAX orders ``P(('replica', 'data'))``) has,
    and which of them is this rank's."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    n, r = 1, 0
    for a in axes:
        k = axis_size(mesh, a)
        n, r = n * k, r * k + (mesh.get_local_rank(a) if k > 1 else 0)
    return n, r


def _rows(x, mesh, axis, dim: int = 0):
    """This rank's block of dim ``dim`` of ``x`` over ``axis`` (a name or
    a tuple of names)."""
    n, r = _axes_index(mesh, axis)
    if n == 1:
        return x
    b = np.shape(x)[dim]
    if b % n:
        raise ValueError(f"dimension {dim} of {b} does not split over {n} "
                         f"{axis!r} shards")
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


# -- the model-parallel half -------------------------------------------------

def _path_map(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict (JAX's tree_map_with_path)."""
    if isinstance(tree, dict):
        return {k: _path_map(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def transformer_tp_specs(params, axis: str = "model"):
    """Spec tree for Transformer / TransformerLM parameters, Megatron-style
    tensor parallelism (JAX's rules, matched on the leaf's path): ``wq`` /
    ``wk`` / ``wv``, ``w1`` and SwiGLU's ``w3`` column-split
    ``(None, axis)``, ``wo`` and ``w2`` row-split ``(axis, None)``, ``b1``
    split ``(axis,)``, every other leaf replicated ``()``. The port's model
    runs the per-layer all-reduces itself (``nn.attention``); the heads
    should divide by the axis size (where they do not, the model gathers
    the split leaves and computes replicated, as JAX's compiler reshards)."""

    def spec_for(path, leaf):
        joined = "/".join(path)
        nd = len(_shape(leaf))
        if nd == 2:
            if any(k in joined for k in ("wq", "wk", "wv")):
                return (None, axis)
            if "wo" in joined:
                return (axis, None)
            if "w1" in joined or "w3" in joined:
                return (None, axis)
            if "w2" in joined:
                return (axis, None)
        if "b1" in joined and nd == 1:
            return (axis,)
        return ()

    return _path_map(spec_for, params)


def fsdp_specs(params, mesh, axis: str = "data", min_elems: int = 16384):
    """ZeRO-3 / FSDP spec tree: a leaf of at least ``min_elems`` elements
    is split over ``axis`` along its largest dimension that divides by the
    axis size (the first such among equal sizes, JAX's stable sort); smaller
    leaves stay replicated. The model gathers each block's slices just
    before the block runs (:func:`gather_param`), so resident parameter
    memory is about 1/n; the gather's gradient is a reduce-scatter."""
    n = axis_size(mesh, axis)

    def spec(path, leaf):
        shape = _shape(leaf)
        if not hasattr(leaf, "shape") or int(np.prod(shape)) < min_elems:
            return ()
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % n == 0:
                parts = [None] * len(shape)
                parts[i] = axis
                return tuple(parts)
        return ()

    return _path_map(spec, params)


#: mesh axes a serving batch splits over when the mesh has them (JAX's
#: ``P(("replica", "data"))``: replicas of the engine and rows within one)
SERVING_BATCH_AXES = ("replica", "data")


def serving_batch_spec(mesh, axes=SERVING_BATCH_AXES):
    """The spec of a serving micro-batch's leading dim: split jointly over
    whichever of ``axes`` the mesh has (``(('replica', 'data'),)``, or
    ``('data',)`` for one of them), or
    replicated ``()`` when it has neither (a pure tensor-parallel mesh
    serves the whole batch on every rank)."""
    names = tuple(mesh.mesh_dim_names)
    present = tuple(a for a in axes if a in names)
    if not present:
        return ()
    # one axis is its name, as JAX's PartitionSpec normalises (('data',))
    return (present if len(present) > 1 else present[0],)


def batch_shard_count(mesh, spec) -> int:
    """How many ways ``spec`` splits the leading batch dim on ``mesh``: the
    serving engine's bucket floor."""
    spec = tuple(spec or ())
    if not spec or spec[0] is None:
        return 1
    return _axes_index(mesh, spec[0] if isinstance(spec[0], tuple)
                       else (spec[0],))[0]


def serving_param_specs(params, mesh, placement, model_axis: str = "model",
                        data_axis: str = "data"):
    """A serving placement as a spec tree: ``"tp"`` ->
    :func:`transformer_tp_specs` over ``model_axis``, ``"fsdp"`` ->
    :func:`fsdp_specs` over ``data_axis``, ``"replicated"`` / None -> every
    leaf ``()``, a callable -> ``placement(params)``, anything else is
    taken as an explicit spec tree."""
    if placement is None or placement == "replicated":
        return _path_map(lambda p, _: (), params)
    if callable(placement):
        return placement(params)
    if placement == "tp":
        return transformer_tp_specs(params, axis=model_axis)
    if placement == "fsdp":
        return fsdp_specs(params, mesh, axis=data_axis)
    return placement


def _block_of(x, mesh, spec):
    """This rank's block of the whole leaf ``x`` under ``spec``, on the
    mesh's device: a copy when it is a proper block (the whole leaf is not
    kept alive by a view of it)."""
    spec = tuple(spec.spec if isinstance(spec, Placement) else spec or ())
    if isinstance(x, torch.Tensor):
        x = x.detach()
    part = x
    for d, ax in enumerate(spec):
        if ax is not None:
            part = _rows(part, mesh, ax, d)
    out = _place(part, mesh_device(mesh))
    if part is not x and isinstance(x, torch.Tensor) \
            and out.untyped_storage().data_ptr() \
            == x.untyped_storage().data_ptr():
        out = out.clone()
    return out


def place_with_specs(tree, mesh, specs):
    """This rank's block of every leaf of ``tree`` (a tree every rank holds
    whole, or rank 0 hands out) under the matching spec of ``specs``, on
    the mesh's device: the sharded load of a serving publish, run on the
    publishing thread."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: place_with_specs(v, mesh, specs[k])
                for k, v in tree.items()}
    return _block_of(tree, mesh, specs)


def tp_linear_rules(axis: str = "model"):
    """Specs for a column -> row parallel ``nn.Linear`` pair (weights
    (out, in)): the first column-split, the second row-split, one sum at
    the end."""
    return {
        "column": {"weight": (axis, None), "bias": (axis,)},
        "row": {"weight": (None, axis), "bias": ()},
    }


def constraint(x, mesh, spec):
    """JAX's ``with_sharding_constraint``: a layout hint to its compiler.
    In the port a rank's tensor is already its block, so the value is
    returned as it is (after checking the spec names axes of the mesh)."""
    spec = tuple(spec.spec if isinstance(spec, Placement) else spec or ())
    names = set(mesh.mesh_dim_names)
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {tuple(names)}")
    return x


def gather_param(x, full_shape, axis: str = "data"):
    """The whole leaf from this rank's slice ``x`` of a leaf of
    ``full_shape`` split along one dimension over ``axis`` (on the mesh
    ``collective.over`` sets): an all-gather along the dimension where the
    shapes differ, whose gradient is the reduce-scatter of the whole
    leaf's gradient. ``x`` itself when the shapes agree."""
    from .collective import all_gather
    full_shape = tuple(full_shape)
    if tuple(x.shape) == full_shape:
        return x
    dims = [i for i, (a, b) in enumerate(zip(x.shape, full_shape)) if a != b]
    if len(dims) != 1 or len(x.shape) != len(full_shape):
        raise ValueError(f"a slice {tuple(x.shape)} of {full_shape} must "
                         f"differ in exactly one dimension")
    d = dims[0]
    out = all_gather(x.movedim(d, 0).contiguous(), axis)
    if out.shape[0] != full_shape[d]:
        raise ValueError(f"slices {tuple(x.shape)} over {axis!r} gather to "
                         f"{out.shape[0]} rows, not {full_shape[d]}")
    return out.movedim(0, d)


def _gather_whole(tree, specs, mesh):
    """Every leaf of ``tree`` (this rank's blocks under ``specs``) whole,
    by all-gathers over each split dimension's axes: the serving engine's
    per-dispatch gather of a version placed in slices (a generic model has
    no per-layer hook). Inference only (no gradient)."""
    if isinstance(tree, dict):
        return {k: _gather_whole(v, specs[k], mesh) for k, v in tree.items()}
    spec = tuple(specs.spec if isinstance(specs, Placement) else specs or ())
    x = tree
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        for a in reversed(axes):     # minor axis first: major-order blocks
            n = axis_size(mesh, a)
            if n == 1:
                continue
            xm = x.movedim(d, 0).contiguous()
            out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
            dist.all_gather_into_tensor(out, xm, group=mesh.get_group(a))
            x = out.movedim(0, d)
    return x
