"""Versioned model registry with atomic hot swap (counterpart of
``bigdl_tpu/serving/registry.py``, without mesh placement).

``publish`` places a parameter tree on the registry's device on the
caller's thread; ``activate`` is a pointer write under a lock, so a swap
lands on a dispatch boundary."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch


class ModelVersion:
    """(version id, device-resident parameter tree)."""

    __slots__ = ("version", "params")

    def __init__(self, version: str, params):
        self.version = version
        self.params = params

    def __repr__(self):
        return f"ModelVersion({self.version!r})"


def _place(tree, device):
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t if device is None else t.to(device)
    return tree


class ModelRegistry:
    """Thread-safe version store: ``publish`` loads, ``activate`` swaps,
    ``retire`` drops a version that is not active."""

    def __init__(self, device=None):
        self.device = device
        self._versions: Dict[str, ModelVersion] = {}
        self._order: List[str] = []
        self._active: Optional[str] = None
        self._counter = 0
        self._used: set = set()
        self._lock = threading.Lock()

    def publish(self, params, version: Optional[str] = None,
                activate: bool = False) -> str:
        """Place ``params`` on the registry's device and store it as a new
        version; activate it when asked or when it is the first. Returns
        the version id (``v<n>`` when not given)."""
        placed = ModelVersion("", _place(params, self.device))
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
