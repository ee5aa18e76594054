"""Drop-in spelling of ``bigdl.util.common`` (reference
``pyspark/bigdl/util/common.py``; counterpart of
``bigdl_tpu/util/common.py``): the helpers every reference user script
imports, over the port's runtime.

There is no JVM and no Spark here, so the py4j plumbing (``JavaValue``,
``callBigDlFunc``, gateways) does not exist; ``init_engine`` initialises
the port's engine (``utils.engine.init``: a process group and a mesh on
``device``, the CUDA device by default) instead of a JVM; the Spark
helpers raise with a pointer to the ``torch.distributed`` path rather
than half-working.
"""
from __future__ import annotations

import numpy as np

from ..dataset.sample import Sample  # noqa: F401  (parity re-export)
from ..utils import engine

__all__ = ["get_dtype", "JTensor", "RNG", "init_engine",
           "get_node_and_core_number", "to_list", "to_sample_rdd",
           "redire_spark_logs", "show_bigdl_info_logs", "create_spark_conf",
           "get_spark_context", "get_spark_sql_context", "Sample"]


def get_dtype(bigdl_type="float"):
    """Numeric dtype for the reference's ``bigdl_type`` tag."""
    return np.float64 if bigdl_type == "double" else np.float32


class JTensor:
    """ndarray carrier (parity: ``bigdl.util.common.JTensor``).

    The reference uses it to marshal tensors across py4j; here it is a
    plain host-side (storage, shape[, indices]) triple with the same
    constructor and round-trip surface, so ported code keeps working.
    ``indices`` present means a sparse (COO) tensor.
    """

    def __init__(self, storage, shape, bigdl_type="float", indices=None):
        dt = get_dtype(bigdl_type)
        if isinstance(storage, bytes) and isinstance(shape, bytes):
            self.storage = np.frombuffer(storage, dtype=dt)
            self.shape = np.frombuffer(shape, dtype=np.int32)
        else:
            self.storage = np.array(storage, dtype=dt)
            self.shape = np.array(shape, dtype=np.int32)
        if indices is None:
            self.indices = None
        elif isinstance(indices, bytes):
            self.indices = np.frombuffer(indices, dtype=np.int32)
        else:
            self.indices = np.array(indices, dtype=np.int32)
        self.bigdl_type = bigdl_type

    @classmethod
    def from_ndarray(cls, a_ndarray, bigdl_type="float"):
        a = np.asarray(a_ndarray)
        return cls(a.reshape(-1), np.array(a.shape, np.int32), bigdl_type)

    @classmethod
    def sparse(cls, a_ndarray, i_ndarray, shape, bigdl_type="float"):
        """COO sparse: values + (ndim, nnz) indices + dense shape."""
        return cls(np.asarray(a_ndarray).reshape(-1),
                   np.array(shape, np.int32), bigdl_type,
                   indices=np.asarray(i_ndarray).reshape(-1))

    def to_ndarray(self):
        assert self.indices is None, \
            "sparse JTensor: use bigdl_tpu_torch.nn.SparseTensor for compute"
        return self.storage.reshape(tuple(int(s) for s in self.shape))

    def __repr__(self):
        kind = "Sparse" if self.indices is not None else "Dense"
        return f"JTensor[{kind}]{tuple(int(s) for s in self.shape)}"


class RNG:
    """Seeded tensor generator (parity: ``bigdl.util.common.RNG``): host
    draws from numpy; ``set_seed`` also seeds the port's engine (Python's,
    numpy's and torch's generators)."""

    def __init__(self, bigdl_type="float"):
        self.bigdl_type = bigdl_type
        self._rng = np.random.RandomState()

    def set_seed(self, seed):
        self._rng = np.random.RandomState(seed)
        engine.set_seed(seed)

    def uniform(self, a, b, size):
        return self._rng.uniform(a, b, size).astype(
            get_dtype(self.bigdl_type))


def init_engine(bigdl_type="float", device=None):
    """Initialise the execution engine (reference: spins up the JVM and
    the BigDL engine; here: the port's engine - its process group and
    default mesh on ``device``, the CUDA device by default, ``"cpu"`` for
    the CPU)."""
    if not engine.is_initialized():
        engine.init(device=device)


def get_node_and_core_number(bigdl_type="float", device=None):
    if not engine.is_initialized():
        init_engine(device=device)   # lazy-init like engine.get_mesh():
        # never the placeholder (1, 1) of an uninitialised engine
    return engine.node_number(), engine.core_number()


def to_list(a):
    if isinstance(a, list):
        return a
    return [a]


def to_sample_rdd(x, y, numSlices=None):
    """Reference: parallelises (x, y) into an RDD[Sample]. Here: the
    local list of Samples the optimizers' data set protocol accepts (the
    training loop owns the split over devices)."""
    x = np.asarray(x)
    y = np.asarray(y)
    return [Sample.from_ndarray(xi, yi) for xi, yi in zip(x, y)]


_log_handlers = {}


def redire_spark_logs(bigdl_type="float", log_path=None):
    """No Spark logs exist here; route the framework logger to a file
    instead so ported scripts keep their logging side effect. Default
    path matches the reference (``./bigdl.log``); repeated calls for the
    same path reuse one handler instead of multiplying log lines."""
    import logging
    import os
    log_path = log_path or os.path.join(os.getcwd(), "bigdl.log")
    key = os.path.abspath(log_path)
    if key not in _log_handlers:
        _log_handlers[key] = logging.FileHandler(log_path)
        logging.getLogger("bigdl_tpu_torch").addHandler(_log_handlers[key])


def show_bigdl_info_logs(bigdl_type="float"):
    import logging
    logging.getLogger("bigdl_tpu_torch").setLevel(logging.INFO)


def _no_spark(name):
    raise NotImplementedError(
        f"{name}: there is no Spark runtime in bigdl_tpu_torch - "
        "distribution runs over torch.distributed (utils.engine."
        "init_process_group, parallel.mesh); DistriOptimizer replaces the "
        "Spark execution path.")


def create_spark_conf():
    _no_spark("create_spark_conf")


def get_spark_context(conf=None):
    _no_spark("get_spark_context")


def get_spark_sql_context(sc=None):
    _no_spark("get_spark_sql_context")
