"""Shape descriptors for the keras-style API (counterpart of
``bigdl_tpu/utils/shape.py``; parity: the reference's ``utils/Shape.scala``,
SingleShape / MultiShape)."""
from __future__ import annotations

__all__ = ["Shape", "SingleShape", "MultiShape"]


class Shape:
    @staticmethod
    def of(*dims):
        if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
            return SingleShape(list(dims[0]))
        if len(dims) and isinstance(dims[0], Shape):
            return MultiShape(list(dims))
        return SingleShape(list(dims))


class SingleShape(Shape):
    def __init__(self, dims):
        self.dims = list(dims)

    def to_single(self):
        return self.dims

    def copy_and_update(self, idx, value):
        d = list(self.dims)
        d[idx] = value
        return SingleShape(d)

    def __eq__(self, other):
        return isinstance(other, SingleShape) and self.dims == other.dims

    def __repr__(self):
        return f"SingleShape({self.dims})"


class MultiShape(Shape):
    def __init__(self, shapes):
        self.shapes = list(shapes)

    def to_multi(self):
        return self.shapes

    def __eq__(self, other):
        return isinstance(other, MultiShape) and self.shapes == other.shapes

    def __repr__(self):
        return f"MultiShape({self.shapes})"
