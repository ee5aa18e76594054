"""The port's ``utils.shape`` and ``utils.misc`` against the JAX
package's: ``Shape`` / ``SingleShape`` / ``MultiShape``, ``crc32`` and
``string_hash`` (equal values), ``File`` (either package reads the
other's file of plain data), ``ThreadPool``, ``redirect_spark_info_logs``,
and the port's profiling hooks on ``torch.profiler`` and
``torch.cuda.memory_stats`` (on the CPU: a trace of CPU events, and no
devices)."""
import json
import logging
import os

import numpy as np
import pytest
import torch

import bigdl_tpu
from bigdl_tpu.utils import misc as jmisc, shape as jshape
import bigdl_tpu_torch
from bigdl_tpu_torch import utils
from bigdl_tpu_torch.utils import misc, shape

torch.set_num_threads(1)


@pytest.mark.parametrize("dims", [(3,), (2, 5), ([4, 6],), ((1, 2, 3),)],
                         ids=["one", "two", "list", "tuple"])
def test_shape_of_equals_jax(dims):
    j, t = jshape.Shape.of(*dims), shape.Shape.of(*dims)
    assert type(t).__name__ == type(j).__name__ == "SingleShape"
    assert t.to_single() == j.to_single()
    assert repr(t) == repr(j)
    assert t.copy_and_update(0, 9).to_single() == \
        j.copy_and_update(0, 9).to_single()
    assert t == shape.SingleShape(j.to_single()) and t != j.to_single()


def test_multi_shape_equals_jax():
    j = jshape.Shape.of(jshape.Shape.of(2, 3), jshape.Shape.of(4))
    t = shape.Shape.of(shape.Shape.of(2, 3), shape.Shape.of(4))
    assert isinstance(t, shape.MultiShape)
    assert repr(t) == repr(j)
    assert [s.to_single() for s in t.to_multi()] == \
        [s.to_single() for s in j.to_multi()]
    assert t == shape.MultiShape([shape.SingleShape([2, 3]),
                                  shape.SingleShape([4])])


@pytest.mark.parametrize("data,seed", [(b"", 0), (b"bigdl", 0),
                                       (bytes(range(256)), 7),
                                       (b"x" * 1000, 2**31)])
def test_crc32_equals_jax(data, seed):
    assert misc.crc32(data, seed) == jmisc.crc32(data, seed)


@pytest.mark.parametrize("s", ["", "user_42", "ünïcode", "a" * 300])
def test_string_hash_equals_jax(s):
    assert misc.string_hash(s) == jmisc.string_hash(s)


def test_file_round_trips_across_the_packages(tmp_path):
    obj = {"a": [1, 2.5, "x"], "b": np.arange(6).reshape(2, 3)}
    p1, p2 = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    misc.File.save(obj, p1)
    jmisc.File.save(obj, p2)
    for got in (jmisc.File.load(p1), misc.File.load(p2)):
        assert got["a"] == obj["a"]
        np.testing.assert_array_equal(got["b"], obj["b"])
    with pytest.raises(IOError):
        misc.File.save(obj, p1, overwrite=False)
    with pytest.raises(IOError):
        jmisc.File.save(obj, p1, overwrite=False)


def test_thread_pool_equals_jax():
    fns = [lambda i=i: i * i for i in range(7)]
    tp, jp = misc.ThreadPool(3), jmisc.ThreadPool(3)
    try:
        assert tp.invoke_and_wait(fns) == jp.invoke_and_wait(fns) == \
            [i * i for i in range(7)]
        assert [f.result() for f in tp.invoke(fns[:2])] == [0, 1]
        assert tp.pool_size == jp.pool_size == 3
    finally:
        tp.shutdown()
        jp.shutdown()


def test_redirect_spark_info_logs(tmp_path):
    log = tmp_path / "bigdl.log"
    names = ("bigdl_test_quiet_a", "bigdl_test_quiet_b")
    saved = [(logging.getLogger(n).handlers, logging.getLogger(n).propagate,
              logging.getLogger(n).level) for n in names]
    keep = logging.getLogger("bigdl_tpu").level
    try:
        misc.redirect_spark_info_logs(str(log), quiet_loggers=names)
        logging.getLogger(names[0]).info("to the file")
        for h in logging.getLogger(names[0]).handlers:
            h.flush()
        assert "to the file" in log.read_text()
        assert not logging.getLogger(names[1]).propagate
        assert logging.getLogger("bigdl_tpu").level == logging.INFO
    finally:
        for n, (h, p, lv) in zip(names, saved):
            lg = logging.getLogger(n)
            for x in lg.handlers:
                x.close()
            lg.handlers, lg.propagate = h, p
            lg.setLevel(lv)
        logging.getLogger("bigdl_tpu").setLevel(keep)


def test_profile_trace_writes_a_torch_profiler_trace(tmp_path):
    with misc.profile_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "prof" / f"trace_{os.getpid()}.json"
    doc = json.loads(path.read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert prof is not None


def test_device_memory_stats_keys_the_cuda_devices():
    # one entry a CUDA device (none on a CPU-only machine; JAX's CPU
    # devices report None each)
    want = {f"cuda:{i}" for i in range(torch.cuda.device_count())} \
        if torch.cuda.is_available() else set()
    assert set(misc.device_memory_stats()) == want


def test_the_packages_re_export_them_as_jax():
    for n in ("Shape", "SingleShape", "MultiShape", "File", "ThreadPool",
              "crc32", "string_hash", "redirect_spark_info_logs",
              "profile_trace", "device_memory_stats"):
        assert getattr(utils, n) is getattr(
            misc if hasattr(misc, n) else shape, n)
        assert hasattr(bigdl_tpu.utils, n)
    assert bigdl_tpu_torch.Shape is shape.Shape
