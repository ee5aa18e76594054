"""Torch-style heterogeneous activity container (counterpart of
``bigdl_tpu/utils/table.py``, parity with the reference's
``utils/Table.scala``): a 1-indexed list of activities, with string-keyed
entries beside them, wherever a module consumes or produces several (the
translation model's ``Table(src_ids, tgt_ids)``, a batch of samples with
several features). PyTorch needs no pytree registration: the code that
takes a ``Table`` walks it itself."""
from __future__ import annotations

__all__ = ["Table", "T"]


class Table:
    """1-indexed heterogeneous container (reference utils/Table.scala:37).
    ``Table(a, b)`` and ``Table([a, b])`` hold the same items."""

    def __init__(self, *items):
        if len(items) == 1 and isinstance(items[0], (list, tuple)):
            items = tuple(items[0])
        self._items = list(items)
        self._named = {}      # string-keyed entries (the reference's Table
        #                       is an arbitrary-keyed map)

    # -- torch-style 1-indexed access ------------------------------------
    def __getitem__(self, key):
        if isinstance(key, int):
            if key < 1:
                raise IndexError("Table is 1-indexed (torch convention)")
            return self._items[key - 1]
        if isinstance(key, str):
            return self._named[key]
        raise TypeError(f"Table index must be int or str, got {type(key)}")

    def __setitem__(self, key, value):
        if isinstance(key, str):
            self._named[key] = value
            return
        if key < 1:
            raise IndexError("Table is 1-indexed")
        while len(self._items) < key:
            self._items.append(None)
        self._items[key - 1] = value

    def __contains__(self, key):
        if isinstance(key, str):
            return key in self._named
        return isinstance(key, int) and 1 <= key <= len(self._items)

    def keys(self):
        """Named keys (string-keyed entries only)."""
        return self._named.keys()

    def update(self, key, value):
        """Reference ``table.update(key, value)`` alias."""
        self[key] = value
        return self

    def insert(self, value):
        self._items.append(value)
        return self

    def length(self):
        return len(self._items)

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def to_list(self):
        return list(self._items)

    def __repr__(self):
        parts = [repr(i) for i in self._items]
        parts += [f"{k}={v!r}" for k, v in self._named.items()]
        return "Table{" + ", ".join(parts) + "}"

    def __eq__(self, other):
        if isinstance(other, Table):
            return (self._items == other._items
                    and self._named == other._named)
        return NotImplemented

    def __hash__(self):
        return id(self)


def T(*items):
    """Shorthand constructor, parity with reference ``T(...)``."""
    return Table(*items)
