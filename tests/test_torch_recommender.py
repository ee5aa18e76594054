"""The recommenders and the sparse layers of the port against the JAX package
on the CPU: ``NeuralCF`` and ``WideAndDeep`` (scores and every gradient at
1e-5, the wide half's wrapping uint32 cross bucket at ids that wrap, one
``LocalOptimizer`` step each with ``BCECriterion`` and ``Adam``), and
``nn.sparse``: ``SparseTensor`` (``from_dense``, ``coo``, ``to_dense``),
``sparse_dense_matmul``, ``SparseLinear``, ``LookupTableSparse`` (each
combiner, weights, ``max_norm``, the dense id path), ``SparseJoinTable``,
``DenseToSparse`` and ``embedding_grad_rows``, values and gradients at
1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.nn import sparse as jsp
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import recommender as trec
from bigdl_tpu_torch.nn import sparse as tsp
from bigdl_tpu_torch.utils.table import Table

from torch_loop_helpers import FixedBatches, assert_close, optimizers
from torch_parity_helpers import close, load, run_jax, run_port

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _pairs(n, users, items, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(1, users + 1, n),
                     rng.randint(1, items + 1, n)], 1).astype(np.int64)


# -- the recommenders ---------------------------------------------------------------

@pytest.mark.parametrize("which", ["ncf", "wd"])
def test_recommender_matches_jax(which):
    """Scores (N,) and every parameter's gradient; ids out of range clamp
    as in JAX, and WideAndDeep runs at 5000 users, where u * 2654435761
    wraps 32 bits."""
    import bigdl_tpu.models as jmods
    if which == "ncf":
        U, I, args = 60, 40, (4, 8, (16, 8))
        jm, tm = jmods.NeuralCF(U, I, *args), trec.NeuralCF(U, I, *args,
                                                            device="cpu")
    else:
        U, I, args = 5000, 3000, (6, (12, 8), 97)
        jm, tm = jmods.WideAndDeep(U, I, *args), trec.WideAndDeep(
            U, I, *args, device="cpu")
    x = _pairs(64, U, I)
    x[:3] = [[0, 0], [10 ** 6, 10 ** 6], [U, I]]
    # every parameter 0.5 N(0, 1), the scalar bias too
    jp, js = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(100)
    jp = jax.tree_util.tree_map(lambda a: np.asarray(
        0.5 * rng.randn(*np.shape(a)), np.float32), jp)
    js = jax.tree_util.tree_map(np.asarray, js)
    load(tm, jp, js)
    jout, _, jgp, _ = run_jax(jm, jp, js, x, True)
    out, _, gp, _ = run_port(tm, x, True)
    close(out, jout, TOL, "scores")
    close(gp, jgp, TOL, "param grads")
    assert out.shape == (64,) and ((out > 0) & (out < 1)).all()


def test_wide_cross_bucket_wraps_as_uint32():
    m = trec.WideDeepInput(10 ** 6, 10 ** 6, 4, 1009)
    u = np.array([0, 1, 2, 1617, 999999, 123456], np.int64)
    i = np.array([0, 7, 3, 999999, 999998, 5], np.int64)
    want = ((u.astype(np.uint32) * np.uint32(2654435761)
             + i.astype(np.uint32)) % np.uint32(1009)).astype(np.int64)
    got = m._cross_bucket(torch.from_numpy(u), torch.from_numpy(i)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (u[2:] * 2654435761 > 2 ** 32).all()        # these wrap


@pytest.mark.parametrize("which", ["ncf", "wd"])
def test_one_local_optimizer_step_matches_jax(which):
    import bigdl_tpu.models as jmods
    U, I = 30, 20
    if which == "ncf":
        tm = trec.NeuralCF(U, I, 4, 8, (8, 4), device="cpu")
        jm = jmods.NeuralCF(U, I, 4, 8, (8, 4))
    else:
        tm = trec.WideAndDeep(U, I, 4, (8, 4), 50, device="cpu")
        jm = jmods.WideAndDeep(U, I, 4, (8, 4), 50)
    with torch.no_grad():      # a nonzero wide half
        for p in convert.flatten(tm.params).values():
            if p.dim() == 1 and not p.abs().sum():
                p.normal_(0.0, 0.1)
    jm.ensure_initialized()
    jm.params = jax.tree_util.tree_map(jnp.array,
                                       convert.host_copy_tree(tm.params))
    rng = np.random.RandomState(2)
    batches = [(_pairs(16, U, I, 3).astype(np.float32),
                rng.randint(0, 2, 16).astype(np.float32))]
    from bigdl_tpu.dataset.minibatch import MiniBatch as JMB
    from bigdl_tpu_torch.dataset import MiniBatch as TMB
    jopt, topt = optimizers(
        jm, tm, (FixedBatches(batches, JMB), FixedBatches(batches, TMB)),
        lambda nn: nn.BCECriterion(), lambda o: o.Adam(learningrate=0.02),
        lambda o: o.Trigger.max_iteration(1), 16)
    jopt.optimize()
    topt.optimize()
    assert_close(convert.host_copy_tree(tm.params), jm.params, TOL, which)


# -- nn.sparse -------------------------------------------------------------------------

def _dense_ids(seed=0):
    """(4, 6) 1-based ids with zero padding (a row of padding only)."""
    rng = np.random.RandomState(seed)
    d = rng.randint(1, 9, (4, 6)).astype(np.float32)
    d[rng.rand(4, 6) < 0.4] = 0
    d[2] = 0
    return d


def test_sparse_tensor_round_trips_like_jax():
    d = _dense_ids()
    js = jsp.SparseTensor.from_dense(d, nnz=20)
    ts = tsp.SparseTensor.from_dense(d, nnz=20)
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(js.values))
    assert ts.shape == js.shape and ts.nnz == js.nnz == 20 and ts.ndim == 2
    assert ts.indices.dtype == torch.int32
    np.testing.assert_array_equal(ts.to_dense().numpy(), d)
    with pytest.raises(ValueError, match="exceed"):
        tsp.SparseTensor.from_dense(d, nnz=3)
    c = tsp.SparseTensor.coo([[0, 1], [2, 3], [2, 3]], [1.0, 2.0, 0.5],
                             (3, 4))
    want = jsp.SparseTensor.coo([[0, 1], [2, 3], [2, 3]], [1.0, 2.0, 0.5],
                                (3, 4)).to_dense()
    np.testing.assert_array_equal(c.to_dense().numpy(), np.asarray(want))
    assert repr(c).startswith("SparseTensor(shape=(3, 4), nnz=3")


def test_sparse_dense_matmul_and_sparse_linear_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(5, 7).astype(np.float32)
    x[rng.rand(5, 7) < 0.6] = 0
    w = rng.randn(7, 3).astype(np.float32)
    g = rng.randn(5, 3).astype(np.float32)
    jsx = jsp.SparseTensor.from_dense(x, nnz=30)
    want, vjp = jax.vjp(lambda d: jsp.sparse_dense_matmul(jsx, d),
                        jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    got = tsp.sparse_dense_matmul(tsp.SparseTensor.from_dense(x, nnz=30), tw)
    torch.testing.assert_close(got, torch.from_numpy(np.asarray(want)), **TOL)
    gw, = torch.autograd.grad(got, tw, torch.from_numpy(g))
    torch.testing.assert_close(gw, torch.from_numpy(np.asarray(
        vjp(jnp.asarray(g))[0])), **TOL)
    # SparseLinear on a sparse input equals Linear on the dense one
    jl = jsp.SparseLinear(7, 3)
    jp, js = jl.init(jax.random.PRNGKey(0))
    tl = tsp.SparseLinear(7, 3)
    tl.load_state_dict(convert.jax_to_state_dict(jp, js))
    jy, _ = jl.apply(jp, js, jsx)
    ty = tl.call(tl.params, tsp.SparseTensor.from_dense(x, nnz=30))
    torch.testing.assert_close(ty, torch.from_numpy(np.asarray(jy)), **TOL)
    torch.testing.assert_close(ty, tl.call(tl.params, torch.from_numpy(x)),
                               **TOL)
    # the facade takes the sparse input in training mode too
    assert tl.forward(tsp.SparseTensor.from_dense(x)).shape == (5, 3)


@pytest.mark.parametrize("combiner,max_norm,weighted", [
    ("sum", -1.0, False), ("mean", -1.0, False), ("sqrtn", -1.0, False),
    ("mean", 0.8, False), ("sum", -1.0, True), ("sqrtn", 1.5, True)])
def test_lookup_table_sparse_matches_jax(combiner, max_norm, weighted):
    d = _dense_ids(2)
    jm = jsp.LookupTableSparse(9, 5, combiner, max_norm)
    jp, js = jm.init(jax.random.PRNGKey(0))
    tm = tsp.LookupTableSparse(9, 5, combiner, max_norm)
    tm.load_state_dict(convert.jax_to_state_dict(jp, js))
    wts = np.abs(np.random.RandomState(3).randn(*d.shape)).astype(
        np.float32) * (d != 0)
    jx = jsp.SparseTensor.from_dense(d, nnz=24)
    tx = tsp.SparseTensor.from_dense(d, nnz=24)
    if weighted:
        jw = jsp.SparseTensor(jx.indices, jnp.asarray(
            wts[tuple(np.asarray(jx.indices).T)]), d.shape)
        tw = tsp.SparseTensor(tx.indices, torch.from_numpy(
            wts[tuple(tx.indices.long().numpy().T)]), d.shape)
        jx, tx = JTable(jx, jw), Table(tx, tw)
    g = np.random.RandomState(4).randn(4, 5).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jm.apply(p, js, jx)[0], jp)
    params = tm.params
    got = tm.call(params, tx)
    torch.testing.assert_close(got, torch.from_numpy(np.asarray(want)), **TOL)
    assert not got[2].any()                     # a padding-only row
    gw, = torch.autograd.grad(got, params["weight"], torch.from_numpy(g))
    torch.testing.assert_close(gw, torch.from_numpy(np.asarray(
        vjp(jnp.asarray(g))[0]["weight"])), **TOL)
    if not weighted:                           # the dense id path
        dense = tm.call(params, torch.from_numpy(d))
        torch.testing.assert_close(dense, got, **TOL)


def test_sparse_join_table_and_dense_to_sparse_match_jax():
    a, b = _dense_ids(5)[:, :4], _dense_ids(6)[:, :3]
    jt = jsp.SparseJoinTable(2).apply(
        {}, {}, JTable(jsp.SparseTensor.from_dense(a, nnz=14),
                       jsp.SparseTensor.from_dense(b, nnz=10)))[0]
    tt = tsp.SparseJoinTable(2).call({}, Table(
        tsp.SparseTensor.from_dense(a, nnz=14),
        tsp.SparseTensor.from_dense(b, nnz=10)))
    assert tt.shape == jt.shape == (4, 7)
    np.testing.assert_array_equal(tt.indices.numpy(), np.asarray(jt.indices))
    np.testing.assert_array_equal(tt.to_dense().numpy(),
                                  np.concatenate([a, b], 1))
    with pytest.raises(NotImplementedError):
        tsp.SparseJoinTable(1)
    with pytest.raises(TypeError):
        tsp.SparseJoinTable().call({}, Table(torch.zeros(4, 2),
                                             torch.zeros(4, 2)))
    d2s = tsp.DenseToSparse(nnz=16)
    s = d2s.call({}, torch.from_numpy(a))
    js_ = jsp.DenseToSparse(nnz=16).apply({}, {}, a)[0]
    np.testing.assert_array_equal(s.values.numpy(), np.asarray(js_.values))
    with pytest.warns(UserWarning, match="nnz budget"):
        tsp.DenseToSparse()


def test_embedding_grad_rows_matches_jax():
    rng = np.random.RandomState(8)
    ids = np.array([3, 1, 3, 7, 1, 0], np.int32)
    dense = rng.randn(9, 4).astype(np.float32)
    want = jsp.embedding_grad_rows(jnp.asarray(dense), jnp.asarray(ids))
    got = tsp.embedding_grad_rows(torch.from_numpy(dense),
                                  torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[2].any() and not got[4].any()


@pytest.mark.parametrize("which", ["ncf", "wd", "graph"])
def test_convert_carries_the_port_s_weights_back_to_jax(which):
    """The port's seeded weights through ``convert.to_numpy_trees`` into
    JAX's apply give the port's output (the recommenders' trees, and a
    graph's ``str(mod_idx)`` keys)."""
    import bigdl_tpu.models as jmods
    import bigdl_tpu.nn as jnn
    import bigdl_tpu_torch.nn as tnn
    if which == "graph":
        def build(nn):
            x = nn.Input()
            h = nn.Tanh()(nn.Linear(2, 6)(x))
            return nn.Graph(x, nn.CAddTable()(nn.Linear(6, 3)(h),
                                              nn.Linear(6, 3)(h)))
        jm, tm = build(jnn), build(tnn)
        x = _pairs(8, 30, 20).astype(np.float32)
    else:
        make = "NeuralCF" if which == "ncf" else "WideAndDeep"
        jm = getattr(jmods, make)(30, 20)
        tm = getattr(trec, make)(30, 20, device="cpu", seed=5)
        with torch.no_grad():        # a nonzero wide half
            for p in convert.flatten(tm.params).values():
                if not p.abs().sum():
                    p.normal_(0.0, 0.1)
        x = _pairs(8, 30, 20)
    params, state = convert.to_numpy_trees(tm)
    want, _ = jm.apply(jax.tree_util.tree_map(jnp.asarray, params),
                       jax.tree_util.tree_map(jnp.asarray, state),
                       jnp.asarray(x))
    got, _ = tm.apply(tm.params, tm.state, torch.from_numpy(x))
    torch.testing.assert_close(got.detach(),
                               torch.from_numpy(np.asarray(want)), **TOL)
