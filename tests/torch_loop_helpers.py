"""Shared pieces of the training-loop parity tests (``test_torch_loop_depth``,
``test_torch_checkpoint``, ``test_torch_optim_methods``,
``test_torch_freeze_regularize``): small twin models built from the same
numpy weights in both packages, fixed batch-level data sets, and the
two optimizers driven the same way."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet, Sample as JaxSample
from bigdl_tpu.dataset.minibatch import MiniBatch as JaxMiniBatch
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu_torch import convert, nn as tnn
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, Sample
from bigdl_tpu_torch.optim import LocalOptimizer

TOL = dict(atol=1e-5, rtol=1e-5)     # float32, the same formulas


def mlp(pkg, d_in=6, hidden=8, classes=3):
    return pkg.Sequential(pkg.Linear(d_in, hidden), pkg.ReLU(),
                          pkg.Linear(hidden, classes))


def conv_net(pkg, w_reg=None, b_reg=None, lin_reg=None, classes=3):
    """conv3x3(3 -> 4, NHWC) -> ReLU -> View -> Linear on 6x6 images."""
    return pkg.Sequential(
        pkg.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, w_regularizer=w_reg,
                               b_regularizer=b_reg, format="NHWC"),
        pkg.ReLU(), pkg.View(4 * 6 * 6),
        pkg.Linear(4 * 6 * 6, classes, w_regularizer=lin_reg))


def bn_net(pkg, classes=3):
    """conv3x3 without a bias (BatchNorm cancels it, leaving only rounding
    noise as its gradient) -> BatchNorm (running statistics: model state)
    -> ReLU -> View -> Linear on 6x6 NHWC images."""
    return pkg.Sequential(
        pkg.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, with_bias=False,
                               format="NHWC"),
        pkg.SpatialBatchNormalization(4, data_format="NHWC"), pkg.ReLU(),
        pkg.View(4 * 6 * 6), pkg.Linear(4 * 6 * 6, classes))


def twins(build, seed=0):
    """The same architecture in both packages with the port's seeded
    initial weights: (jax model, port model, numpy params)."""
    torch.manual_seed(seed)
    tm = build(tnn)
    tm.reset(torch.Generator().manual_seed(seed))
    jm = build(jnn)
    jm.ensure_initialized()
    w = convert.host_copy_tree(tm.params)
    jm.params = jax.tree_util.tree_map(jnp.array, w)
    return jm, tm, w


def jax_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def assert_close(got, want, tol=TOL, what=""):
    """Nested numpy trees (a port tree, JAX's) leaf for leaf."""
    g, w = convert.flatten(got), convert.flatten(jax_tree(want))
    assert set(g) == set(w), (what, sorted(g), sorted(w))
    for k in g:
        np.testing.assert_allclose(np.asarray(g[k], np.float64),
                                   np.asarray(w[k], np.float64),
                                   err_msg=f"{what} {k}", **tol)


def assert_equal(got, want, what=""):
    g, w = convert.flatten(got), convert.flatten(want)
    assert set(g) == set(w), what
    for k in g:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=f"{what} {k}")


def image_batches(n, batch=8, hw=6, classes=3, seed=0, poison=()):
    """``n`` (x, y) numpy batches of NHWC images and 1-based labels; the
    batches listed in ``poison`` hold a NaN pixel."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rng.randn(batch, hw, hw, 3).astype(np.float32)
        if i in poison:
            x[0, 0, 0, 0] = np.nan
        out.append((x, rng.randint(1, classes + 1, batch)))
    return out


def vector_batches(n, batch=8, d_in=6, classes=3, seed=0, poison=(),
                   sizes=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        b = sizes[i] if sizes else batch
        x = rng.randn(b, d_in).astype(np.float32)
        if i in poison:
            x[0, 0] = np.nan
        out.append((x, rng.randint(1, classes + 1, b)))
    return out


class FixedBatches:
    """A batch-level data set of fixed MiniBatches in a fixed order (no
    shuffle), for either package's ``MiniBatch``: places a NaN at a known
    iteration."""

    def __init__(self, batches, mb_cls):
        self._mbs = [mb_cls(x, y) for x, y in batches]

    def size(self):
        return sum(len(m.get_input()) for m in self._mbs)

    def batches_per_epoch(self):
        return len(self._mbs)

    def shuffle(self):
        return self

    def data(self, train=True):
        return iter(self._mbs)


def samples(batches, cls):
    return [cls(x, y) for xb, yb in batches for x, y in zip(xb, yb)]


def data_pair(batches, fixed=True):
    """(JAX data set, port data set) over the same batches: fixed order,
    or the Sample data sets each package shuffles the same way."""
    if fixed:
        return FixedBatches(batches, JaxMiniBatch), \
            FixedBatches(batches, MiniBatch)
    return JaxDataSet.array(samples(batches, JaxSample)), \
        DataSet.array(samples(batches, Sample))


def recording(trigger, seen):
    """``trigger`` that also records ``state['loss']`` at every ask."""
    def fn(state):
        seen.append(state.get("loss"))
        return trigger(state)
    return fn


def optimizers(jm, tm, data, crit, method, end, batch, **setup):
    """The JAX and the port LocalOptimizer over the same data, criterion
    (a class of both packages' ``nn``), optim method (a function of the
    package's ``optim`` module), end trigger (a function of the package's
    trigger module) and setup calls ``{name: args}``."""
    import bigdl_tpu.optim as jo
    import bigdl_tpu_torch.optim as to
    jd, td = data
    jopt = JaxLocalOptimizer(jm, jd, crit(jnn), method(jo), end(jo), batch)
    topt = LocalOptimizer(tm, td, crit(tnn), method(to), end(to), batch,
                          device="cpu")
    for name, args in setup.items():
        getattr(jopt, name)(*args)
        getattr(topt, name)(*args)
    return jopt, topt

