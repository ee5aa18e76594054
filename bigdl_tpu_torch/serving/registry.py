"""Versioned model registry with atomic hot swap (counterpart of
``bigdl_tpu/serving/registry.py``, without mesh placement).

``publish`` places a parameter tree and a state tree (the model's
non-trained state; ``None`` or ``{}`` for a TransformerLM) on the
registry's device on the caller's thread; ``activate`` is a pointer write
under a lock, so a swap lands on a dispatch boundary."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch


class ModelVersion:
    """(version id, device-resident parameter tree, state tree)."""

    __slots__ = ("version", "params", "state")

    def __init__(self, version: str, params, state):
        self.version = version
        self.params = params
        self.state = state

    def __repr__(self):
        return f"ModelVersion({self.version!r})"


def _place(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t if device is None else t.to(device)
    return tree


class ModelRegistry:
    """Thread-safe version store: ``publish`` loads, ``activate`` swaps,
    ``retire`` drops a version that is not active. JAX's mesh placement
    (``mesh``, ``param_specs``, ``state_specs``) is not ported: the port
    serves on one device (``device``)."""

    def __init__(self, mesh=None, param_specs=None, state_specs=None,
                 device=None):
        for name, v in (("mesh", mesh), ("param_specs", param_specs),
                        ("state_specs", state_specs)):
            if v is not None:
                raise NotImplementedError(
                    f"ModelRegistry({name}=...): mesh placement is not "
                    f"ported (one device; ROADMAP A.6)")
        self.device = device
        self._versions: Dict[str, ModelVersion] = {}
        self._order: List[str] = []
        self._active: Optional[str] = None
        self._counter = 0
        self._used: set = set()
        self._lock = threading.Lock()

    def publish(self, params, state=None, version: Optional[str] = None,
                activate: bool = False, transform=None) -> str:
        """Place ``params`` and ``state`` on the registry's device and
        store them as a new version; activate it when asked or when it is
        the first. ``transform`` (``params -> params``) runs once, here,
        before placement; the version holds its result. Returns the
        version id (``v<n>`` when not given)."""
        if transform is not None:
            params = transform(params)
        placed = ModelVersion("", _place(params, self.device),
                              _place(state, self.device))
        with self._lock:
            if version is None:
                while f"v{self._counter}" in self._used:
                    self._counter += 1
                version = f"v{self._counter}"
                self._counter += 1
            elif version in self._used:
                raise ValueError(f"version {version!r} already published "
                                 "(versions are immutable - pick a new id)")
            self._used.add(version)
            placed.version = version
            self._versions[version] = placed
            self._order.append(version)
            if activate or self._active is None:
                self._active = version
        return version

    def activate(self, version: str):
        with self._lock:
            if version not in self._versions:
                raise KeyError(f"unknown version {version!r}; published: "
                               f"{self._order}")
            self._active = version

    def current(self) -> Optional[ModelVersion]:
        with self._lock:
            return (self._versions[self._active]
                    if self._active is not None else None)

    @property
    def active_version(self) -> Optional[str]:
        with self._lock:
            return self._active

    def retire(self, version: str):
        with self._lock:
            if version == self._active:
                raise ValueError(f"version {version!r} is active - "
                                 "activate a replacement before retiring")
            self._versions.pop(version, None)
            if version in self._order:
                self._order.remove(version)
