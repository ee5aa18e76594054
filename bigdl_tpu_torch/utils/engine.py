"""Runtime engine: device resolution and seeds (counterpart of
``bigdl_tpu/utils/engine.py``).

Every entry point of the port runs on a CUDA device unless its caller asks
for the CPU with ``device="cpu"`` (the tests do). Without a card and
without that request it raises: the port never moves to the CPU on its own.
"""
from __future__ import annotations

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
          "core_number": 1, "engine_type": "cuda"}
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


def init(node_number: int = 1,
         core_number: Optional[int] = None,
         mesh_shape: Optional[Sequence[int]] = None,
         mesh_axes: Sequence[str] = ("data",),
         seed: int = 42,
         devices=None):
    """Initialise the engine (JAX's ``Engine.init``): record the node and
    core numbers (``core_number`` defaults to :func:`device_count`) and
    seed the generators with ``seed``. The device mesh is multi-GPU work
    (ROADMAP A.6): ``mesh_shape``, ``mesh_axes`` and ``devices`` are
    refused at values other than their defaults. Returns None where JAX's
    returns its mesh."""
    refuse_unported("engine.init", mesh_shape=(mesh_shape, None),
                    mesh_axes=(tuple(mesh_axes), ("data",)),
                    devices=(devices, None))
    if core_number is None:
        core_number = device_count()
    _state.update(initialized=True, node_number=node_number,
                  core_number=core_number)
    set_seed(seed)


def is_initialized() -> bool:
    return _state["initialized"]


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
           "is_initialized", "node_number", "core_number", "engine_type",
           "device_count", "default_dtype", "RandomGenerator",
           "refuse_unported"]
