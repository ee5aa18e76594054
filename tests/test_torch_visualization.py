"""The port's event files (``bigdl_tpu_torch.visualization``) against the
JAX package's: crc32c's RFC 3720 values, scalar / histogram / event /
file-version records byte for byte at the same wall time, each package's
reader on the other's files, a truncated tail, histograms of tensors,
and the summaries' triggers and readback."""
import os
import struct

import numpy as np
import pytest
import torch

from bigdl_tpu.visualization import TrainSummary as JaxTrainSummary
from bigdl_tpu.visualization import event_reader as jreader
from bigdl_tpu.visualization import event_writer as jwriter
from bigdl_tpu_torch.optim import several_iteration
from bigdl_tpu_torch.visualization import (EventWriter, TrainSummary,
                                           ValidationSummary, crc32c,
                                           event_reader, event_writer,
                                           iter_records, read_scalar)

torch.set_num_threads(1)


@pytest.mark.parametrize("data,want", [
    (b"", 0), (b"123456789", 0xE3069283), (bytes(32), 0x8A9136AA),
    (bytes(range(32)), None), (b"\xff" * 32, None)],
    ids=["empty", "digits", "zeros", "ramp", "ones"])
def test_crc32c_values(data, want):
    """RFC 3720's vectors (JAX's test values), and the same as JAX's on
    more data; the masked form too."""
    assert crc32c(data) == jwriter.crc32c(data)
    if want is not None:
        assert crc32c(data) == want
    assert event_writer._masked_crc(data) == jwriter._masked_crc(data)


@pytest.mark.parametrize("tag,value,step,wall", [
    ("Loss", 1.5, 1, 1700000000.25), ("LearningRate", 1e-3, 12345, 0.0),
    ("Top1Accuracy", -0.0, 0, 3.5), ("Throughput", 3.4e38, 2 ** 40, 9e9),
    ("Loss", float("nan"), -3, 1.0)],
    ids=["loss", "lr", "neg_zero", "large", "nan_negative_step"])
def test_scalar_event_bytes_equal_jax(tag, value, step, wall):
    got = event_writer.encode_event(
        step, event_writer.encode_scalar_summary(tag, value), wall)
    want = jwriter.encode_event(
        step, jwriter.encode_scalar_summary(tag, value), wall)
    assert got == want


@pytest.mark.parametrize("values", [
    np.random.RandomState(0).randn(100), np.arange(7.0), np.zeros(0),
    np.full(5, 2.5)], ids=["normal", "ramp", "empty", "constant"])
def test_histogram_bytes_equal_jax(values):
    want = jwriter.encode_event(
        4, jwriter.encode_histogram_summary("w", values), 12.5)
    for given in (values, torch.from_numpy(values.astype(np.float64))):
        got = event_writer.encode_event(
            4, event_writer.encode_histogram_summary("w", given), 12.5)
        assert got == want


def test_histogram_of_a_float32_tensor_reads_it_back():
    t = torch.from_numpy(np.random.RandomState(1).randn(3, 4)
                         .astype(np.float32))
    assert event_writer.encode_histogram_summary("w", t) == \
        jwriter.encode_histogram_summary("w", t.numpy())


def test_file_version_and_name_pattern(tmp_path, monkeypatch):
    monkeypatch.setattr(event_writer.time, "time", lambda: 1234.5)
    monkeypatch.setattr(jwriter.time, "time", lambda: 1234.5)
    assert event_writer.encode_file_version() == \
        jwriter.encode_file_version()
    a = EventWriter(str(tmp_path / "a"), suffix=".x")
    b = jwriter.EventWriter(str(tmp_path / "b"), suffix=".x")
    a.close()
    b.close()
    assert os.path.basename(a.path) == os.path.basename(b.path) == \
        "events.out.tfevents.1234.bigdl_tpu.x"
    assert open(a.path, "rb").read() == open(b.path, "rb").read()


def _write(writer_cls, d, rows):
    w = writer_cls(d)
    for tag, v, step in rows:
        w.add_scalar(tag, v, step)
    w.add_histogram("h", np.arange(4.0), 1)
    w.close()
    return w.path


ROWS = [("Loss", 2.0, 1), ("Loss", 1.25, 2), ("LearningRate", 0.1, 2),
        ("Loss", 0.5, 3)]


@pytest.mark.parametrize("writer,reader", [
    ("port", "jax"), ("jax", "port"), ("port", "port")])
def test_readers_read_either_packages_files(tmp_path, writer, reader):
    cls = EventWriter if writer == "port" else jwriter.EventWriter
    _write(cls, str(tmp_path), ROWS)
    read = read_scalar if reader == "port" else jreader.read_scalar
    assert read(str(tmp_path), "Loss") == [(1, 2.0), (2, 1.25), (3, 0.5)]
    assert read(str(tmp_path), "LearningRate") == \
        [(2, np.float32(0.1))]
    assert read(str(tmp_path), "Missing") == []


def test_records_frame_like_jax(tmp_path):
    path = _write(EventWriter, str(tmp_path), ROWS)
    assert list(iter_records(path)) == list(jreader.iter_records(path))
    assert len(list(iter_records(path))) == 6


def test_truncated_tail_keeps_the_valid_prefix(tmp_path):
    path = _write(EventWriter, str(tmp_path), ROWS)
    with open(path, "ab") as f:
        f.write(b"\x40\x00\x00\x00\x00\x00\x00\x00garbage")
    assert read_scalar(str(tmp_path), "Loss") == \
        jreader.read_scalar(str(tmp_path), "Loss") == \
        [(1, 2.0), (2, 1.25), (3, 0.5)]
    # a frame cut inside its payload
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) - 30])
    assert read_scalar(str(tmp_path), "Loss") == \
        jreader.read_scalar(str(tmp_path), "Loss")


def test_scalar_cache_rescans_only_appended_bytes(tmp_path):
    cache = event_reader.ScalarCache(str(tmp_path))
    w = EventWriter(str(tmp_path))
    w.add_scalar("Loss", 3.0, 1)
    assert cache.read("Loss") == [(1, 3.0)]
    offset = next(iter(cache._files.values()))[0]
    w.add_scalar("Loss", 2.0, 2)
    assert cache.read("Loss") == [(1, 3.0), (2, 2.0)]
    assert next(iter(cache._files.values()))[0] > offset
    w.close()
    # a replaced (shorter) file is read again from its start
    with open(w.path, "wb") as f:
        f.write(b"")
    assert cache.read("Loss") == []


def test_summaries_against_jax(tmp_path):
    """The same calls through both packages' summaries: the same
    directories and readback; a histogram of a tensor is accepted."""
    for pkg, cls in (("port", TrainSummary), ("jax", JaxTrainSummary)):
        s = cls(str(tmp_path / pkg), "app")
        s.add_scalar("Loss", 2.0, 1).add_scalar("Loss", 1.0, 2)
        s.add_histogram("w", torch.arange(4.0) if pkg == "port"
                        else np.arange(4.0), 2)
        assert s.read_scalar("Loss") == [(1, 2.0), (2, 1.0)]
        s.close()
        assert os.path.isdir(str(tmp_path / pkg / "app" / "train"))
    v = ValidationSummary(str(tmp_path / "port"), "app")
    v.add_scalar("Top1Accuracy", 0.9, 10)
    assert v.read_scalar("Top1Accuracy") == [(10, np.float32(0.9))]
    assert jreader.read_scalar(str(tmp_path / "port" / "app" /
                                   "validation"), "Top1Accuracy") == \
        [(10, np.float32(0.9))]
    v.close()


def test_summary_triggers_gate_tags():
    s = TrainSummary.__new__(TrainSummary)
    s._triggers = {}
    assert s.should_record("Loss", {"neval": 1})
    s.set_summary_trigger("Loss", several_iteration(2))
    assert [s.should_record("Loss", {"neval": n}) for n in (1, 2, 3, 4)] \
        == [False, True, False, True]
    assert s.should_record("LearningRate", {"neval": 1})


def test_restart_reads_the_whole_history(tmp_path):
    s = TrainSummary(str(tmp_path), "app")
    s.add_scalar("Loss", 2.0, 1)
    s.close()
    s2 = TrainSummary(str(tmp_path), "app")
    s2.add_scalar("Loss", 1.0, 2)
    assert s2.read_scalar("Loss") == [(1, 2.0), (2, 1.0)]
    s2.close()
    head = open(s2.writer.path, "rb").read(12)
    assert struct.unpack("<I", head[8:12])[0] == \
        jwriter._masked_crc(head[:8])
