"""Runtime engine: device resolution and seeds (counterpart of
``bigdl_tpu/utils/engine.py``).

Every entry point of the port runs on a CUDA device unless its caller asks
for the CPU with ``device="cpu"`` (the tests do). Without a card and
without that request it raises: the port never moves to the CPU on its own.
"""
from __future__ import annotations

import random

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


_state = {"seed": None}
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
