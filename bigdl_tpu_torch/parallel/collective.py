"""Collectives over a mesh axis (counterpart of
``bigdl_tpu/parallel/collective.py``).

JAX calls these inside ``shard_map``, where an axis name resolves to the
devices along it. The port runs one process per rank, so an axis name
resolves to the process group of that mesh dimension
(``DeviceMesh.get_group``) of the default mesh
(``parallel.mesh.get_default_mesh``), and every rank of the group calls the
same collective at the same point of its program. Each call is one
``torch.distributed`` collective on the group's backend (NCCL on the card,
gloo on the CPU); a backend that refuses one raises.

The collectives JAX differentiates through carry gradients here: the
gradient of ``psum`` is the ``psum`` of the gradients, of ``all_gather``
the ``reduce_scatter``, of ``reduce_scatter`` the ``all_gather``, of
``all_to_all`` the reverse ``all_to_all`` and of ``ppermute_ring`` the
reverse rotation.

A ring hop (``ppermute_ring``) is a paired send / receive; gloo has no
send / receive of CUDA tensors, so on a gloo group a CUDA block is staged
through host buffers (``_hop_route``, chosen by the group's backend); NCCL
groups and CPU tensors send the tensor itself.

The model-parallel layers use three private collectives with the
gradients tensor parallelism needs (every rank holds the whole loss):
``_tp_enter`` (Megatron's f: identity forward, sum of the input
gradients backward), ``_tp_exit`` (g: sum forward, identity backward; a
``psum`` there would sum the replicated cotangent again and scale the
gradients by n) and ``_tp_gather`` (whole leaves from column blocks, the
backward keeping this rank's block); ``_pmax`` is JAX's ``lax.pmax``
(no gradient).

``over(mesh)`` makes axis names resolve on ``mesh`` inside a block (the
distributed optimizer's steps, the model-parallel layers); ``global_batch`` marks a replicated
data-parallel step, where BatchNorm and the count-divided criteria reduce
over the global batch (``global_sums``, ``global_count``).

Observability: with it on, each call counts ``collective/<op>_calls`` and
the bytes it hands the collective, ``collective/<op>_traced_bytes`` (JAX's
names; JAX counts once per compiled program, the port once per call, so
the port's counter is the bytes a run really moved).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from .. import observability as obs
from ..utils.carrier import TreeCarrier

__all__ = ["psum", "pmean", "all_reduce_sum", "all_reduce_mean",
           "all_gather", "reduce_scatter", "ppermute_ring", "all_to_all",
           "axis_group", "over", "global_batch", "local_batch",
           "batch_group", "batch_rows", "global_sums", "global_count"]

_current = threading.local()


def _record(op: str, x):
    """Count one call and its bytes (no-op unless observability is on)."""
    if not obs.enabled():
        return
    obs.counter(f"collective/{op}_calls").inc()
    obs.counter(f"collective/{op}_traced_bytes", unit="B").inc(
        float(x.numel() * x.element_size()))


@contextlib.contextmanager
def over(mesh):
    """Resolve axis names on ``mesh`` inside the block (this thread), as
    a ``shard_map`` over ``mesh`` does in JAX."""
    prev = getattr(_current, "mesh", None)
    _current.mesh = mesh
    try:
        yield mesh
    finally:
        _current.mesh = prev


def axis_group(axis: str = "data"):
    """``(process group, size, this rank's index)`` of ``axis`` on the
    mesh :func:`over` set, else on the default mesh."""
    from .mesh import get_default_mesh
    mesh = getattr(_current, "mesh", None) or get_default_mesh()
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


@contextlib.contextmanager
def _batch_block(value):
    prev = getattr(_current, "batch", None)
    _current.batch = value
    try:
        yield
    finally:
        _current.batch = prev


def global_batch(group, n: int):
    """Inside the block (this thread), the batch this rank holds is one
    of ``n`` equal shares of a global batch over ``group``: BatchNorm
    takes its batch statistics over the global batch
    (:func:`global_sums`) and the criteria that divide by a count that
    depends on the data divide by the global count (:func:`global_count`),
    a sum over the batch is scaled by ``n`` (the optimizer then averages
    over the ranks) and a random draw over the batch is this rank's rows
    of the global batch's (:func:`batch_rows`) - what JAX's replicated
    step computes, since one program sees the whole batch there."""
    return _batch_block((group, int(n)))


def local_batch():
    """Inside the block (this thread) the batch is this rank's own again,
    as outside :func:`global_batch`: a criterion applied row by row
    scales and reduces nothing across the ranks."""
    return _batch_block(None)


def batch_group():
    """``(group, n)`` of the :func:`global_batch` block, or None."""
    return getattr(_current, "batch", None)


@contextlib.contextmanager
def _model_split(dim: int, axis: str = "model"):
    """Inside the block (this thread), a tensor-parallel region: the
    tensors there hold this rank's block along ``dim`` of a whole split
    over ``axis`` (the attention's heads, the FFN's filter columns), so a
    random draw over them is this rank's block of the whole's
    (:func:`batch_rows`)."""
    prev = getattr(_current, "split", None)
    _current.split = (int(dim), axis)
    try:
        yield
    finally:
        _current.split = prev


def batch_rows(draw, shape):
    """``draw(shape)``, a random tensor over a batch (dim 0), drawn as a
    local run over the global batch draws it: inside :func:`global_batch`
    every rank draws the global batch's shape from its generator (which
    stays in step with the other ranks') and keeps its own rows, so no
    two ranks' rows share a draw. Inside a tensor-parallel region
    (``_model_split``) the split dimension is drawn whole too and this
    rank's block of it kept, so no two ranks' heads or filter columns
    share a draw. Outside both, ``draw(shape)``."""
    bg = batch_group()
    split = getattr(_current, "split", None)
    shape = tuple(shape)
    if (bg is None and split is None) or not shape:
        return draw(shape)
    full = list(shape)
    if bg is not None:
        full[0] *= bg[1]
    if split is not None:
        d = split[0] % len(shape)
        _, n, r_model = axis_group(split[1])
        full[d] *= n
    out = draw(tuple(full))
    if bg is not None:
        r = dist.get_rank(bg[0])
        out = out.narrow(0, r * shape[0], shape[0])
    if split is not None:
        out = out.narrow(d, r_model * shape[d], shape[d])
    return out


def global_sums(*ts):
    """Per-rank partial sums -> their sums over the global batch's ranks
    (one all-reduce, gradients carried), or the tensors themselves
    outside :func:`global_batch`."""
    bg = batch_group()
    if bg is None:
        return ts
    flat = torch.cat([t.reshape(-1) for t in ts])
    _record("psum", flat)
    out = _Psum.apply(flat, bg[0]).split([t.numel() for t in ts])
    return tuple(o.view(t.shape) for o, t in zip(out, ts))


def global_count(count):
    """A rank's count of the data -> the count over the global batch (no
    gradient), or the count itself outside :func:`global_batch`."""
    bg = batch_group()
    if bg is None:
        return count
    _record("psum", count)
    return _sum(count.detach(), bg[0])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, TreeCarrier):       # a quantized weight's tensors
        return tree.map(lambda t: _tree_map(fn, t))
    return fn(tree)


def _sum(x, group):
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _gather0(x, group, n):
    """All ranks' ``x`` concatenated along dim 0 in rank order."""
    x = x.detach().contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _scatter0(x, group, n):
    """Rank r's sum over ranks of the r-th block of dim 0."""
    x = x.detach().contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def _a2a0(x, group):
    """Block j of dim 0 to rank j; the blocks received, in rank order."""
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _hop_route(x, group) -> str:
    """How a ring hop moves ``x`` on ``group``: ``"send_recv"`` (a paired
    send / receive of the tensor itself: NCCL, or gloo on the CPU) or
    ``"host_staged"`` (gloo with a CUDA tensor: gloo has no send / receive
    of CUDA tensors, so the hop copies the block to the host, sends and
    receives there, and copies the block received back to the card).
    Chosen by the group's backend and the tensor's device, never by
    catching a refusal."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return "host_staged"
    return "send_recv"


def _rotate(x, group, n, shift):
    """Send ``x`` to the rank ``shift`` places on, receive from the one
    ``shift`` places back (the route: :func:`_hop_route`)."""
    me = dist.get_rank(group)
    x = x.detach().contiguous()
    if n == 1 or shift % n == 0:
        return x.clone()
    to = dist.get_global_rank(group, (me + shift) % n)
    frm = dist.get_global_rank(group, (me - shift) % n)
    staged = _hop_route(x, group) == "host_staged"
    src = x.cpu() if staged else x
    out = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, to, group),
                                   dist.P2POp(dist.irecv, out, frm, group)])
    for r in reqs:
        r.wait()
    return out.to(x.device) if staged else out


def _max(x, group):
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _pmax(x, axis: str):
    """The elementwise maximum of ``x`` over the ranks of ``axis`` (JAX's
    ``lax.pmax``; JAX's collective module has no wrapper either). No
    gradient: its callers use it as a stabilising shift."""
    _record("pmax", x)
    group, _, _ = axis_group(axis)
    return _max(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather0(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter0(g, ctx.group, ctx.n), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _scatter0(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.group, ctx.n), None, None


class _A2A(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a0(g, ctx.group), None


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, shift):
        ctx.group, ctx.n, ctx.shift = group, n, shift
        return _rotate(x, group, n, shift)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, ctx.n, -ctx.shift), None, None, None


class _TPEnter(torch.autograd.Function):
    """Megatron's "f": the replicated input of a column-parallel product.
    The identity forward; the backward sums the ranks' partial input
    gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _TPExit(torch.autograd.Function):
    """Megatron's "g": the sum of a row-parallel product's partial
    outputs. The gradient of the replicated sum is already whole on every
    rank, so the backward is the identity (``psum``'s backward, a second
    sum, would scale it by n)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TPGather(torch.autograd.Function):
    """The whole of a leaf split along dim 0 over a tensor-parallel group,
    for a computation every rank then runs in full: the backward keeps
    this rank's block of the (already whole) gradient."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.r, ctx.k = dist.get_rank(group), x.shape[0]
        return _gather0(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.r * ctx.k:(ctx.r + 1) * ctx.k].contiguous(), None, None


def _tp_gather(x, dim: int, axis: str = "model"):
    """``x``'s blocks along ``dim`` from every rank of ``axis``, whole."""
    _record("all_gather", x)
    group, n, _ = axis_group(axis)
    if n == 1:
        return x
    out = _TPGather.apply(x.movedim(dim, 0).contiguous(), group, n)
    return out.movedim(0, dim)


def _tp_enter(x, axis: str = "model"):
    """Mark ``x`` as the replicated input of a column-parallel region."""
    group, n, _ = axis_group(axis)
    return x if n == 1 else _TPEnter.apply(x, group)


def _tp_exit(x, axis: str = "model"):
    """Sum a row-parallel region's partial outputs over ``axis``."""
    _record("psum", x)
    group, n, _ = axis_group(axis)
    return x if n == 1 else _TPExit.apply(x, group)


def psum(x, axis: str = "data"):
    """The sum of ``x`` over the ranks of ``axis``, on every rank."""
    _record("psum", x)
    group, _, _ = axis_group(axis)
    return _Psum.apply(x, group)


def pmean(x, axis: str = "data"):
    _record("pmean", x)
    group, n, _ = axis_group(axis)
    return _Psum.apply(x, group) / n


def all_reduce_sum(tree, axis: str = "data"):
    return _tree_map(lambda t: psum(t, axis), tree)


def all_reduce_mean(tree, axis: str = "data"):
    return _tree_map(lambda t: pmean(t, axis), tree)


def all_gather(x, axis: str = "data", tiled: bool = True):
    """Every rank's ``x`` in rank order: concatenated along dim 0
    (``tiled``) or stacked along a new dim 0."""
    _record("all_gather", x)
    group, n, _ = axis_group(axis)
    xs = x if tiled else x.unsqueeze(0)
    if xs.dim() == 0:
        xs = xs.reshape(1)
    return _Gather.apply(xs, group, n)


def reduce_scatter(x, axis: str = "data", scatter_dimension: int = 0):
    """Rank r's block r of ``scatter_dimension`` of the sum over ranks
    (``psum_scatter`` tiled)."""
    _record("reduce_scatter", x)
    group, n, _ = axis_group(axis)
    d = scatter_dimension % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                         f"split over {n} ranks")
    out = _Scatter.apply(x.movedim(d, 0), group, n)
    return out.movedim(0, d)


def ppermute_ring(x, axis: str = "data", shift: int = 1):
    """Rotate ``x`` around the ring of ``axis``: rank i's value goes to
    rank (i + shift) mod n."""
    _record("ppermute", x)
    group, n, _ = axis_group(axis)
    return _Rotate.apply(x, group, n, shift)


def all_to_all(x, axis: str, split_axis: int, concat_axis: int):
    """Split ``split_axis`` into n blocks, send block j to rank j, and
    concatenate the blocks received along ``concat_axis`` in rank order
    (``lax.all_to_all`` tiled)."""
    _record("all_to_all", x)
    group, n, _ = axis_group(axis)
    s, c = split_axis % x.dim(), concat_axis % x.dim()
    if x.shape[s] % n:
        raise ValueError(f"dimension {s} of size {x.shape[s]} does not "
                         f"split over {n} ranks")
    blocks = x.unflatten(s, (n, x.shape[s] // n)).movedim(s, 0)
    got = _A2A.apply(blocks, group)          # [n, ...] from each rank
    # block j came from rank j: concatenate them along concat_axis
    parts = got.unbind(0)
    return torch.cat(parts, dim=c)
