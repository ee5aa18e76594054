"""Runtime engine: device resolution, seeds, the process group and the
device mesh (counterpart of ``bigdl_tpu/utils/engine.py``).

Every entry point of the port runs on a CUDA device unless its caller asks
for the CPU with ``device="cpu"`` (the tests do). Without a card and
without that request it raises: the port never moves to the CPU on its own.

Where JAX runs one program over the devices it sees, the port runs one
process per rank (``torchrun --nproc_per_node=N``, or processes started
with explicit ranks). :func:`init_process_group` joins this process to its
``torch.distributed`` group: NCCL for a CUDA device, gloo for the CPU; a
process started without torchrun's variables is a world of one.
"""
from __future__ import annotations

import datetime
import os
import random
from typing import Optional, Sequence

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises when there
    is none); ``"cpu"`` -> the CPU; a ``torch.device`` passes through the
    same check."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


_state = {"seed": None, "initialized": False, "node_number": 1,
          "core_number": 1, "engine_type": "cuda", "mesh": None,
          "group": None}
_DEFAULT_SEED = 42     # the JAX package's default when no seed was set


def set_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators and record the
    seed that :func:`new_generator` starts from (the port's own entry
    points take explicit ``seed``s / ``torch.Generator``s)."""
    _state["seed"] = seed
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)


def get_seed():
    """The seed last given to :func:`set_seed` (None if never set)."""
    return _state["seed"]


def new_generator(device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded from
    :func:`get_seed` (42 when unset). It stands in for the JAX package's
    ``next_rng_key`` stream: a training run draws its dropout masks from
    one such generator. Its bits differ from JAX's for the same seed, so
    tests compare dropout by its invariants, never mask for mask."""
    seed = _DEFAULT_SEED if _state["seed"] is None else _state["seed"]
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def init_process_group(rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None, device=None,
                       timeout_s: float = 300.0):
    """Join this process to its ``torch.distributed`` group, once; returns
    the group's record ``{"rank", "world_size", "local_rank", "device",
    "backend", "init_method"}``. Ranks come from the arguments, else from
    torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and
    ``MASTER_ADDR`` / ``MASTER_PORT``; without either this process is a
    world of one over an in-process store. The backend follows the device
    (``nccl`` for ``cuda``, ``gloo`` for ``cpu``); on ``cuda`` the process
    takes the card ``LOCAL_RANK``. Every collective of the group gives up
    after ``timeout_s``. A group made before (by this function or by the
    caller, say over gloo for several ranks that share one card) is kept,
    with its backend."""
    import torch.distributed as dist
    if _state["group"] is not None and dist.is_initialized():
        return _state["group"]
    env = os.environ
    local = int(env.get("LOCAL_RANK", 0))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.is_available():
        dev = torch.device("cuda", local % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        if rank is None and "RANK" in env:
            rank = int(env["RANK"])
        if world_size is None and "WORLD_SIZE" in env:
            world_size = int(env["WORLD_SIZE"])
        rank = 0 if rank is None else int(rank)
        world_size = 1 if world_size is None else int(world_size)
        if init_method is None and world_size > 1:
            init_method = (f"tcp://{env.get('MASTER_ADDR', '127.0.0.1')}:"
                           f"{env['MASTER_PORT']}")
        if world_size == 1 and init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=timeout)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=world_size,
                                    timeout=timeout)
    _state["group"] = {"rank": rank, "world_size": world_size,
                       "local_rank": local, "device": dev,
                       "backend": backend, "init_method": init_method}
    return _state["group"]


def process_group():
    """The record :func:`init_process_group` returned, or None."""
    return _state["group"]


def destroy_process_group():
    """Leave the group (and forget the mesh built over it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(group=None, mesh=None)
    from ..parallel import mesh as _mesh
    _mesh._default_mesh = None


def init(node_number: int = 1,
         core_number: Optional[int] = None,
         mesh_shape: Optional[Sequence[int]] = None,
         mesh_axes: Sequence[str] = ("data",),
         seed: int = 42,
         devices=None, device=None):
    """Initialise the engine (JAX's ``Engine.init``): join the process
    group (:func:`init_process_group` on ``device``, the CUDA device by
    default), build the mesh ``mesh_shape`` x ``mesh_axes`` over the ranks
    ``devices`` (every rank by default, one ``data`` axis), record the
    node and core numbers (``core_number`` defaults to the mesh's size) and
    seed the generators with ``seed``. Returns the mesh, a
    ``torch.distributed.device_mesh.DeviceMesh``."""
    from ..parallel.mesh import make_mesh
    grp = init_process_group(device=device)
    ranks = list(devices) if devices is not None \
        else list(range(grp["world_size"]))
    if mesh_shape is None:
        mesh_shape = (len(ranks),)
    mesh = make_mesh(mesh_shape, mesh_axes, devices=ranks,
                     device=grp["device"])
    if core_number is None:
        core_number = mesh.size()
    _state.update(initialized=True, node_number=node_number,
                  core_number=core_number, mesh=mesh)
    set_seed(seed)
    return mesh


def is_initialized() -> bool:
    return _state["initialized"]


def get_mesh():
    """The engine's mesh; the first call without :func:`init` initialises
    the engine with its defaults (a world of one on the CUDA device unless
    torchrun's variables say otherwise), as JAX's does."""
    if _state["mesh"] is None:
        init()
    return _state["mesh"]


def node_number() -> int:
    return _state["node_number"]


def core_number() -> int:
    return _state["core_number"]


def engine_type() -> str:
    """``"cuda"``, where JAX's says ``"xla"``."""
    return _state["engine_type"]


def device_count() -> int:
    """The number of CUDA devices (0 without a card)."""
    return torch.cuda.device_count()


def default_dtype():
    return np.float32


_random = {}


class RandomGenerator:
    """The reference's RandomGenerator facade over the engine's random
    stream: :meth:`set_seed` seeds the engine (and numpy's global
    generator), :meth:`uniform` / :meth:`normal` draw host tensors from
    one ``torch.Generator`` seeded from :func:`get_seed`. The values do
    not match JAX's draws for the same seed (a different generator)."""

    @staticmethod
    def set_seed(seed):
        set_seed(seed)
        np.random.seed(seed & 0x7FFFFFFF)
        _random.clear()

    @staticmethod
    def _generator():
        if "cpu" not in _random:
            _random["cpu"] = new_generator("cpu")
        return _random["cpu"]

    @staticmethod
    def uniform(lo, hi, shape=()):
        g = RandomGenerator._generator()
        return lo + (hi - lo) * torch.rand(tuple(shape), generator=g)

    @staticmethod
    def normal(mean, std, shape=()):
        g = RandomGenerator._generator()
        return mean + std * torch.randn(tuple(shape), generator=g)


def refuse_unported(owner: str, **given):
    """The port takes every parameter of its JAX twin's signature, in
    order, with the same defaults; what it does not do yet it refuses,
    never ignores. ``given`` maps a parameter name to ``(value, JAX
    default)``: the first whose value differs from its default raises
    ``NotImplementedError`` naming ``owner`` and the parameter."""
    for name, (value, default) in given.items():
        if value is default:
            continue
        if value is None or default is None or value != default:
            raise NotImplementedError(
                f"{owner}: {name}={value!r} is not ported (only the JAX "
                f"default {default!r}; ROADMAP.md lists what is left)")


__all__ = ["resolve_device", "set_seed", "get_seed", "new_generator", "init",
           "init_process_group", "process_group", "destroy_process_group",
           "get_mesh", "is_initialized", "node_number", "core_number", "engine_type",
           "device_count", "default_dtype", "RandomGenerator",
           "refuse_unported"]
