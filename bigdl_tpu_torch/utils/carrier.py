"""Objects that hold tensors inside a parameter tree.

The JAX package registers its quantized weights
(``quantization.lm.QuantizedWeight`` / ``QuantizedWeightInt4``) as pytree
nodes, so every ``jax.tree_util`` walk goes into their tensors. The port's
tree walkers go into dicts, lists and tuples; a :class:`TreeCarrier` is the
one other node they know: they map over its tensors (:meth:`map`) and keep
the carrier around the results, as JAX's walks do.
"""
from __future__ import annotations


class TreeCarrier:
    """A tree node holding a fixed tuple of tensors (its children)."""

    def children(self) -> tuple:
        raise NotImplementedError

    def with_children(self, children) -> "TreeCarrier":
        """A carrier of the same kind over new children."""
        raise NotImplementedError

    def map(self, fn, *others):
        """The carrier of ``fn`` applied to each child (with the matching
        children of ``others``, carriers of the same kind)."""
        rest = [o.children() for o in others]
        return self.with_children(tuple(
            fn(c, *(r[i] for r in rest))
            for i, c in enumerate(self.children())))


__all__ = ["TreeCarrier"]
