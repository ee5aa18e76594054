"""The port's fleet transport (``serving/transport.py``) against JAX's.

The frame layout is JAX's byte for byte, so a port client talks to a JAX
``TransportServer`` and a JAX client to a port server, both ways, with the
same arrays and trees. The codecs round-trip float32, int32 and bfloat16
bit for bit (numpy has no bfloat16: a bfloat16 tensor travels as its raw
2-byte buffer under the ``"bfloat16"`` tag and comes back a bfloat16
tensor over the same bits); error frames rehydrate typed;
``pick_advertise_host`` answers as JAX's does.
"""
import json

import numpy as np
import pytest
import torch

from bigdl_tpu.serving import transport as jt
from bigdl_tpu_torch.serving import transport as pt

torch.set_num_threads(1)


def _bf16(seed, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _bits(t):
    return t.view(torch.int16).numpy()


def _echo(reply, op, meta, arrays):
    if op == "echo":
        reply(meta={"meta": meta, "n": len(arrays)}, arrays=arrays)
    elif op == "boom":
        reply(error={"type": "EngineStopped", "msg": "dead"},
              meta={"has_partial": True},
              arrays=[np.arange(3, dtype=np.int32)])
    else:
        raise ValueError(f"nope: {op}")


def test_codecs_round_trip_float32_int32_and_bf16_bit_for_bit():
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    b = np.arange(5, dtype=np.int32)
    c = _bf16(1, (2, 3, 4))
    d = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    descr, bufs = pt.pack_arrays([a, b, c, d])
    assert [x["dtype"] for x in descr] == ["<f4", "<i4", "bfloat16", "<f4"]
    out = pt.unpack_arrays(json.loads(json.dumps(descr)),
                           [bytearray(bytes(x)) for x in bufs])
    assert out[0].dtype == np.float32 and np.array_equal(out[0], a)
    assert out[1].dtype == np.int32 and np.array_equal(out[1], b)
    assert out[2].dtype == torch.bfloat16 and out[2].shape == c.shape
    np.testing.assert_array_equal(_bits(out[2]), _bits(c))
    np.testing.assert_array_equal(out[3], d.numpy())
    # an empty bfloat16 leaf
    e = torch.empty((0, 4), dtype=torch.bfloat16)
    descr, bufs = pt.pack_arrays([e])
    assert pt.unpack_arrays(descr, [bytearray()])[0].shape == (0, 4)
    with pytest.raises(ValueError, match="mismatch"):
        pt.unpack_arrays(descr, [])


def test_tree_codec_keeps_structure_scalars_and_bf16_leaves():
    tree = {"w": np.ones((2, 3), np.float32),
            "inner": {"b": np.zeros((4,), np.int32), "lr": 0.5,
                      "t": (np.full((1,), 7.0), None)},
            "l": [np.arange(2)], "h": _bf16(2, (3, 3))}
    bufs = []
    spec = pt.encode_tree(tree, bufs)
    descr, raw = pt.pack_arrays(bufs)
    arrays = pt.unpack_arrays(descr, [bytearray(bytes(x)) for x in raw])
    back = pt.decode_tree(json.loads(json.dumps(spec)), arrays)
    assert back["inner"]["lr"] == 0.5 and back["inner"]["t"][1] is None
    assert isinstance(back["inner"]["t"], tuple)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["l"][0], tree["l"][0])
    assert back["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(back["h"]), _bits(tree["h"]))
    # the same spec as JAX's for the same numpy tree
    np_tree = {k: v for k, v in tree.items() if k != "h"}
    assert pt.encode_tree(np_tree, []) == jt.encode_tree(np_tree, [])


def test_port_server_and_client_echo_errors_typed_and_bf16():
    srv = pt.TransportServer(_echo, name="p").start()
    cli = pt.TransportClient("127.0.0.1", srv.port, name="p").connect()
    try:
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        h = _bf16(3, (4, 5))
        meta, arrays = cli.request("echo", {"k": 1}, [a, h], timeout=10)
        assert meta == {"meta": {"k": 1}, "n": 2}
        np.testing.assert_array_equal(arrays[0], a)
        assert arrays[1].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(arrays[1]), _bits(h))
        with pytest.raises(pt.RemoteError) as ei:
            cli.request("boom", timeout=10)
        assert ei.value.type_name == "EngineStopped"
        assert ei.value.meta == {"has_partial": True}
        np.testing.assert_array_equal(ei.value.arrays[0], np.arange(3))
        # a handler exception answers typed; the connection survives
        with pytest.raises(pt.RemoteError, match="nope") as ei:
            cli.request("wat", timeout=10)
        assert ei.value.type_name == "ValueError"
        assert cli.request("echo", {}, [], timeout=10)[0]["n"] == 0
    finally:
        cli.close()
        srv.close()
    assert pt.transport_threads_alive() == 0
    with pytest.raises(pt.TransportClosed):
        cli.request_async("echo")


@pytest.mark.parametrize("server,client", [(jt, pt), (pt, jt)],
                         ids=["port_client_jax_server",
                              "jax_client_port_server"])
def test_frames_interoperate_with_jax_both_ways(server, client):
    srv = server.TransportServer(_echo, name="x").start()
    cli = client.TransportClient("127.0.0.1", srv.port, name="x").connect()
    try:
        rng = np.random.RandomState(4)
        arrays = [rng.randn(5, 3).astype(np.float32),
                  rng.randint(0, 100, (7,)).astype(np.int32),
                  rng.randn(2, 2).astype(np.float64)]
        tree = {"a": arrays[0], "n": {"b": arrays[1], "s": "x", "f": 1.5}}
        bufs = []
        spec = client.encode_tree(tree, bufs)
        meta, back = cli.request("echo", {"spec": spec}, bufs, timeout=10)
        got = server.decode_tree(meta["meta"]["spec"], back)
        np.testing.assert_array_equal(got["a"], tree["a"])
        np.testing.assert_array_equal(got["n"]["b"], tree["n"]["b"])
        assert got["n"]["s"] == "x" and got["n"]["f"] == 1.5
        meta, back = cli.request("echo", {"k": [1, 2]}, arrays, timeout=10)
        assert meta["meta"] == {"k": [1, 2]}
        for g, w in zip(back, arrays):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        with pytest.raises(client.RemoteError) as ei:
            cli.request("boom", timeout=10)
        assert ei.value.type_name == "EngineStopped"
        np.testing.assert_array_equal(ei.value.arrays[0], np.arange(3))
    finally:
        cli.close()
        srv.close()


def test_frame_bytes_equal_jax_and_bounds_are_jax_s():
    class Sink:
        def __init__(self):
            self.data = b""

        def sendall(self, b):
            self.data += bytes(b)

    import threading
    a = np.arange(6, dtype=np.int32)
    out = []
    for mod in (pt, jt):
        s = Sink()
        descr, bufs = mod.pack_arrays([a])
        mod._send_frame(s, threading.Lock(), {"mid": 1, "op": "x",
                                              "arrays": descr}, bufs)
        out.append(s.data)
    assert out[0] == out[1] and out[0].startswith(b"BTF1")
    assert (pt.MAGIC, pt._MAX_HEADER, pt._MAX_BUF) == \
        (jt.MAGIC, jt._MAX_HEADER, jt._MAX_BUF)


def test_closed_connection_fails_in_flight_typed():
    import threading
    hold = threading.Event()
    seen = []

    def slow(reply, op, meta, arrays):
        seen.append(reply)
        hold.set()

    srv = pt.TransportServer(slow, name="s").start()
    cli = pt.TransportClient("127.0.0.1", srv.port, name="s").connect()
    fut = cli.request_async("wait")
    assert hold.wait(10)
    srv.close()
    with pytest.raises(pt.TransportClosed):
        fut.result(timeout=10)
    cli.close()
    assert pt.transport_threads_alive() == 0


def test_pick_advertise_host_and_wait_for_port_equal_jax():
    for h in ("10.1.2.3", "127.0.0.1", "0.0.0.0", "", "::"):
        assert pt.pick_advertise_host(h) == jt.pick_advertise_host(h)
    assert pt.pick_advertise_host("0.0.0.0") not in ("", "0.0.0.0", "::")
    srv = pt.TransportServer(_echo, name="w").start()
    try:
        assert pt.wait_for_port("127.0.0.1", srv.port, timeout_s=5)
    finally:
        srv.close()


def test_close_while_a_connection_thread_is_starting():
    """close() racing the accept loop between registering a connection's
    thread and starting it: close() waits for the start (the accept loop
    starts the thread under the server's lock) and joins a started thread,
    instead of raising on an unstarted one."""
    import socket
    import threading
    from unittest import mock
    registered, release = threading.Event(), threading.Event()
    real_start = threading.Thread.start

    def slow_start(self):
        if self.name == f"{pt.THREAD_PREFIX}-conn[w]":
            registered.set()
            release.wait(5)
        real_start(self)

    errors = []

    def close(srv):
        try:
            srv.close()
        except Exception as e:      # noqa: BLE001 - recorded for the assert
            errors.append(e)

    with mock.patch.object(threading.Thread, "start", slow_start):
        srv = pt.TransportServer(_echo, name="w").start()
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        try:
            assert registered.wait(5)
            closer = threading.Thread(target=close, args=(srv,))
            closer.start()
            closer.join(0.3)        # close() is under way before the start
            release.set()
            closer.join(10)
        finally:
            release.set()
            sock.close()
    assert not closer.is_alive() and errors == []
