"""Sharded parameter aggregation, ZeRO-1 (counterpart of
``bigdl_tpu/parallel/allreduce.py``; the reference's
``parameters/AllReduceParameter.scala`` and ``FP16CompressedTensor``).

The parameters are flattened into one vector in the order JAX's
``ravel_pytree`` takes them (dict keys sorted at every level) and padded
to a multiple of the ``data`` axis size n, so the shard boundaries, and
the canonical checkpoint state, agree with JAX's at every n. Each step:

* the gradient leg: ``reduce_scatter`` of the local gradient vector
  (``compress="bf16"``/``"fp16"`` casts it first and the collective sums
  in that dtype), or, with ``wire_dtype``, an ``all_to_all`` of the
  compressed per-owner slices that the owner decompresses and sums in
  float32 in rank order (JAX's ``jnp.sum(axis=0)``) - the wire rounded
  once, the sum never;
* the mean over shards (``/ n``), the optim method's update of this
  rank's slice (its state lives only here: ZeRO-1);
* ``all_gather`` of the updated float32 slices into the full vector.

With observability on, ``collective/reduce_scatter_traced_bytes`` and
``collective/grad_wire_traced_bytes`` count the bytes each step hands
the gradient leg (JAX's names; counted per call, so per step).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import observability as obs
from .collective import _record

__all__ = ["FP16CompressPolicy", "FlatParameter", "AllReduceParameter",
           "sparse_embedding_grad_allreduce"]

_SLICE = "flat"     # the key the slice is handed to an optim method under


class FP16CompressPolicy:
    """Gradient wire-compression policies (parity: FP16CompressedTensor)."""
    NONE = "none"
    BF16 = "bf16"
    FP16 = "fp16"

    @staticmethod
    def compress(x, policy):
        if policy == FP16CompressPolicy.BF16:
            return x.to(torch.bfloat16)
        if policy == FP16CompressPolicy.FP16:
            return x.to(torch.float16)
        return x

    @staticmethod
    def decompress(x, dtype):
        return x.to(dtype)


def _sorted_leaves(tree):
    """The leaves of a tree, dict keys sorted at every level (the order
    JAX's ``ravel_pytree`` flattens in)."""
    if not isinstance(tree, dict):
        return [tree]
    return [t for k in sorted(tree) for t in _sorted_leaves(tree[k])]


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


class FlatParameter:
    """A params tree as one flat vector (parity: Module.getParameters),
    leaves in ``ravel_pytree``'s order, padded to a multiple of
    ``n_shards``."""

    def __init__(self, params, n_shards: int):
        self.shapes = _shape_tree(params)
        self.sizes = [int(np.prod(s)) for s in _sorted_leaves(self.shapes)] \
            if isinstance(self.shapes, dict) else [int(np.prod(self.shapes))]
        self.orig_size = int(sum(self.sizes))
        self.n_shards = n_shards
        pad = (-self.orig_size) % n_shards
        self.padded_size = self.orig_size + pad
        self.shard_size = self.padded_size // n_shards

    def flatten(self, tree):
        """The padded flat vector of ``tree`` (tensors -> a tensor on
        their device, numpy -> numpy)."""
        leaves = _sorted_leaves(tree)
        pad = self.padded_size - self.orig_size
        if leaves and isinstance(leaves[0], torch.Tensor):
            flat = torch.cat([t.detach().reshape(-1).float()
                              for t in leaves])
            return F.pad(flat, (0, pad))
        flat = np.concatenate([np.asarray(t, np.float32).reshape(-1)
                               for t in leaves])
        return np.pad(flat, (0, pad))

    def unflatten(self, flat):
        """The tree of a flat vector (views of it for a tensor)."""
        flat = flat[: self.orig_size]
        if isinstance(flat, torch.Tensor):
            parts = iter(flat.split(self.sizes))
        else:
            parts = iter(np.split(np.asarray(flat),
                                  np.cumsum(self.sizes)[:-1]))

        def rebuild(node):
            if isinstance(node, dict):
                return {k: rebuild(node[k]) for k in sorted(node)}
            return next(parts).reshape(node)
        return rebuild(self.shapes)


def _is_slice(node):
    return isinstance(node, dict) and set(node) == {_SLICE}


def _map_state(fn_vec, fn_scalar, witness, *others):
    """Walk the per-slice state ``witness``: a ``{'flat': vector}`` node
    goes to ``fn_vec(*others' nodes)``, a scalar leaf to
    ``fn_scalar(witness leaf, *others' leaves)``."""
    if _is_slice(witness):
        return fn_vec(*others)
    if isinstance(witness, dict):
        return {k: _map_state(fn_vec, fn_scalar, witness[k],
                              *(o[k] for o in others))
                for k in witness}
    return fn_scalar(witness, *others)


class AllReduceParameter:
    """ZeRO-1 sharded optimizer update over the mesh's ``axis``."""

    def __init__(self, optim_method, mesh, axis: str = "data",
                 compress: str = FP16CompressPolicy.NONE,
                 wire_dtype: str = FP16CompressPolicy.NONE):
        """``compress``: the reduce-scatter runs (and accumulates) in the
        compressed dtype. ``wire_dtype``: compressed slices travel, the
        owner sums in float32. Mutually exclusive; both off by default."""
        valid = (FP16CompressPolicy.NONE, FP16CompressPolicy.BF16,
                 FP16CompressPolicy.FP16)
        if compress not in valid or wire_dtype not in valid:
            raise ValueError(f"compress/wire_dtype must be one of {valid}, "
                             f"got {compress!r}/{wire_dtype!r}")
        if compress != FP16CompressPolicy.NONE \
                and wire_dtype != FP16CompressPolicy.NONE:
            raise ValueError(
                "compress= and wire_dtype= are two implementations of the "
                "same wire - set one (wire_dtype keeps f32 accumulation "
                "and is the one to prefer)")
        from .mesh import axis_size, mesh_device
        self.optim = optim_method
        self.mesh = mesh
        self.axis = axis
        self.compress = compress
        self.wire_dtype = wire_dtype
        self.n = axis_size(mesh, axis)
        self.index = mesh.get_local_rank(axis) if self.n > 1 else 0
        self.group = mesh.get_group(axis)
        self.device = mesh_device(mesh)
        self.flat: Optional[FlatParameter] = None

    # -- setup and the canonical state ----------------------------------
    def _my_slice(self, full):
        k = self.flat.shard_size
        return full[self.index * k:(self.index + 1) * k]

    def prepare(self, params, resume_state=None):
        """``(flat params vector, this rank's optimizer state)``. With
        ``resume_state`` (a CANONICAL host state, possibly written under
        another shard count or by JAX) the state is re-flattened and
        re-padded against THIS mesh's boundaries."""
        self.flat = FlatParameter(params, self.n)
        flat_w = self.flat.flatten(params).to(self.device)
        if obs.enabled():
            wire = (self.wire_dtype
                    if self.wire_dtype != FP16CompressPolicy.NONE
                    else self.compress)
            gbytes = 2 if wire in (FP16CompressPolicy.BF16,
                                   FP16CompressPolicy.FP16) else 4
            obs.gauge("allreduce/param_elems").set(self.flat.orig_size)
            obs.gauge("allreduce/shard_elems").set(self.flat.shard_size)
            obs.gauge("allreduce/bytes_per_step", unit="B").set(
                self.flat.padded_size * (gbytes + 4))
            obs.gauge("allreduce/n_shards").set(self.n)
        if resume_state is not None:
            return flat_w, self.place_canonical_state(resume_state)
        return flat_w, self.optim.init_state(
            {_SLICE: self._my_slice(flat_w).clone()})

    def _slice_state_shapes(self):
        """The per-slice state of a fresh init (a witness of which leaves
        are slices and which are scalars)."""
        return self.optim.init_state(
            {_SLICE: torch.zeros(self.flat.shard_size)})

    def state_to_canonical(self, gathered_state):
        """Gathered host state (full padded vectors of THIS mesh) -> the
        canonical form checkpoints hold: each vector unflattened into a
        params-shaped tree, scalars as they are. It is also the state a
        local optimizer of the same method keeps."""
        return _map_state(
            lambda node: self.flat.unflatten(np.asarray(node[_SLICE])),
            lambda w, leaf: np.asarray(leaf), self._slice_state_shapes(),
            gathered_state)

    def state_from_canonical(self, canonical):
        """Canonical host state -> full host vectors padded to THIS mesh's
        boundaries (``{'flat': vector}`` nodes). Flat-vector leaves (old
        checkpoints) are trimmed to the parameter count and re-padded."""
        def widen(sub):
            if isinstance(sub, dict) and not _is_slice(sub):
                return {_SLICE: self.flat.flatten(sub)}
            if _is_slice(sub):
                sub = sub[_SLICE]
            vec = np.asarray(sub, np.float32).ravel()[: self.flat.orig_size]
            return {_SLICE: np.pad(vec, (0, self.flat.padded_size
                                         - vec.shape[0]))}
        return _map_state(widen, lambda w, leaf: np.asarray(leaf),
                          self._slice_state_shapes(), canonical)

    def place_canonical_state(self, canonical):
        """Canonical host state -> this rank's state on the device: its
        slice of every vector, every scalar whole (the one path fresh
        restores and mid-run restores share)."""
        full = self.state_from_canonical(canonical)
        return _map_state(
            lambda node: {_SLICE: self._my_slice(torch.from_numpy(
                np.ascontiguousarray(node[_SLICE]))).clone()
                .to(self.device)},
            lambda w, leaf: torch.as_tensor(leaf, dtype=w.dtype)
            .to(self.device), self._slice_state_shapes(), full)

    def state_specs(self):
        """Per-leaf placement specs of the state: slices ``('data',)``
        (this rank's block), scalars ``()`` (replicated)."""
        return _map_state(lambda: {_SLICE: (self.axis,)},
                          lambda w: (), self._slice_state_shapes())

    # -- the step --------------------------------------------------------
    def _gradient_slice(self, grads_flat, traced_steps):
        """This rank's slice of the mean gradient over the shards."""
        n, k = self.n, self.flat.shard_size
        dtype = grads_flat.dtype
        if self.wire_dtype != FP16CompressPolicy.NONE:
            g = FP16CompressPolicy.compress(grads_flat, self.wire_dtype)
            if obs.enabled():
                obs.counter("collective/grad_wire_traced_bytes",
                            unit="B").inc(
                    float(g.numel() * g.element_size()) * traced_steps)
            pieces = torch.empty_like(g)
            dist.all_to_all_single(pieces, g.contiguous(), group=self.group)
            pieces = FP16CompressPolicy.decompress(pieces, dtype).view(n, k)
            acc = pieces[0].clone()
            for j in range(1, n):       # rank order, as jnp.sum(axis=0)
                acc = acc + pieces[j]
            return acc / n
        g = FP16CompressPolicy.compress(grads_flat, self.compress)
        if obs.enabled():
            obs.counter("collective/reduce_scatter_traced_bytes",
                        unit="B").inc(
                float(g.numel() * g.element_size()) * traced_steps)
        out = g.new_empty((k,))
        dist.reduce_scatter_tensor(out, g.contiguous(),
                                   op=dist.ReduceOp.SUM, group=self.group)
        return FP16CompressPolicy.decompress(out, dtype) / n

    def update(self, grads_flat, params_flat, opt_state, lr,
               traced_steps: int = 1):
        """One sharded update: ``(new full params vector, new state)``,
        both new tensors (the caller writes them, through the NaN guard).
        ``grads_flat`` is this rank's local gradient vector,
        ``params_flat`` the full vector, ``opt_state`` this rank's state.
        ``traced_steps`` multiplies the byte counters (JAX counts a
        superstep's K steps at once; the port counts each step, so 1)."""
        gslice = self._gradient_slice(grads_flat, traced_steps)
        wslice = self._my_slice(params_flat)
        pairs = self.optim._updates({_SLICE: gslice}, {_SLICE: wslice},
                                    opt_state, lr)
        new = {id(d): v for d, v in pairs}
        new_slice = new.get(id(wslice), wslice).to(params_flat.dtype)
        new_state = _map_leaves(lambda t: new.get(id(t), t), opt_state)
        new_full = params_flat.new_empty(params_flat.shape)
        _record("all_gather", new_slice)
        dist.all_gather_into_tensor(new_full, new_slice.contiguous(),
                                    group=self.group)
        return new_full, new_state


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def sparse_embedding_grad_allreduce(ids, row_grads, vocab_size: int,
                                    axis: str, mean: bool = True,
                                    traced_steps: int = 1):
    """Sparsity-aware embedding-gradient aggregation (Parallax,
    arXiv:1808.02621): the ranks of ``axis`` exchange their (token ids,
    gradient rows) with two all-gathers and scatter-add them into the
    dense ``(vocab_size, H)`` gradient, the same on every rank - what a
    dense ``psum`` of each rank's scatter-add gives, for ``n * B_local *
    (H + 1)`` elements on the wire instead of ``vocab * H``. ``ids``:
    (B,) local ids; ``row_grads``: (B, H) local rows
    (``nn.sparse.embedding_grad_rows``). ``mean`` divides by the axis
    size. With observability on,
    ``collective/sparse_grad_wire_traced_bytes`` counts the bytes sent."""
    from .collective import axis_group
    group, n, _ = axis_group(axis)
    if obs.enabled():
        obs.counter("collective/sparse_grad_wire_traced_bytes",
                    unit="B").inc(
            float(ids.numel() * 4
                  + row_grads.numel() * row_grads.element_size())
            * traced_steps)
    ids = ids.to(torch.int32).contiguous()
    rows = row_grads.contiguous()
    all_ids = ids.new_empty((n * ids.shape[0],))
    all_rows = rows.new_empty((n * rows.shape[0],) + tuple(rows.shape[1:]))
    dist.all_gather_into_tensor(all_ids, ids, group=group)
    dist.all_gather_into_tensor(all_rows, rows, group=group)
    dense = rows.new_zeros((vocab_size, rows.shape[-1])).index_add_(
        0, all_ids.long(), all_rows)
    if mean:
        dense = dense / n
    return dense
