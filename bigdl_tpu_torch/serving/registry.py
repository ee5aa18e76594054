"""Versioned model registry with atomic hot swap (counterpart of
``bigdl_tpu/serving/registry.py``).

``publish`` places a parameter tree and a state tree (the model's
non-trained state; ``None`` or ``{}`` for a TransformerLM) on the
registry's device on the caller's thread; ``activate`` is a pointer write
under a lock, so a swap lands on a dispatch boundary.

With a ``mesh`` and ``param_specs`` (a spec tree, or a callable resolved
per publish), every publish is a sharded load on the publishing thread:
this rank keeps its block of each leaf (``sharding.place_with_specs``).
A serving loop that keeps several ranks in lockstep hears of each publish
before its version can be activated (``add_publish_listener``) and hands
the other ranks the tree to load their blocks of."""
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
    ``retire`` drops a version that is not active. Without a mesh the
    versions live on ``device``; with ``mesh`` + ``param_specs`` each
    publish keeps this rank's blocks on the mesh's device
    (``state_specs``: replicated by default)."""

    def __init__(self, mesh=None, param_specs=None, state_specs=None,
                 device=None):
        self.mesh = mesh
        self._param_specs = param_specs
        self._state_specs = state_specs
        if mesh is not None:
            from ..parallel.mesh import mesh_device
            device = mesh_device(mesh)
        self.device = device
        self._listeners: list = []
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
        placed = ModelVersion("", self._place_tree(params,
                                                   self._param_specs),
                              self._place_tree(state, self._state_specs))
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
            # listeners hear of the version before it can be activated
            for fn in self._listeners:
                fn("publish", version, params, state)
            if activate or self._active is None:
                self._active = version
        return version

    def _place_tree(self, tree, specs):
        """Placement of one tree: this rank's blocks on the mesh (specs
        resolved per publish when callable; replicated when None), else
        the whole tree on the registry's device."""
        if tree is None:
            return None
        if self.mesh is None:
            return _place(tree, self.device)
        from ..parallel.sharding import place_with_specs, serving_param_specs
        specs = specs(tree) if callable(specs) else specs
        if specs is None:
            specs = serving_param_specs(tree, self.mesh, None)
        return place_with_specs(tree, self.mesh, specs)

    def add_publish_listener(self, fn):
        """``fn(event, version, params, state)`` on every later ``publish``
        (before the version can be activated) and ``retire`` (params and
        state None), under the registry's lock: it must only record."""
        with self._lock:
            self._listeners.append(fn)

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

    def get(self, version: str) -> ModelVersion:
        with self._lock:
            return self._versions[version]

    def versions(self) -> List[str]:
        with self._lock:
            return list(self._order)

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
            for fn in self._listeners:
                fn("retire", version, None, None)
