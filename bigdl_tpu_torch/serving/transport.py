"""Framed binary transport for the cross-process serving fleet
(counterpart of ``bigdl_tpu/serving/transport.py``).

The fleet tier (``serving/fleet.py``) splits its two planes: **control**
rides the snapshot / membership FILES (one atomic JSON rewrite per beat,
``observability/cluster.py`` and ``parallel/failure.FileHeartbeat``), and
**data** rides THIS module: one length-prefixed frame per message over a
local socket, with every tensor payload (token vectors, KV pages,
published parameter leaves) sent as its RAW little-endian bytes -
``sendall(memoryview(...))`` out, ``np.frombuffer`` in.

Frame layout (all integers little-endian), the JAX package's byte for
byte, so a client of either package talks to a server of the other::

    b"BTF1" | u32 header_len | header (utf-8 json) |
    u32 nbufs | nbufs x (u64 buf_len | raw bytes)

The header names the operation (requests) or the request it answers
(replies) plus dtype / shape descriptors for the buffers. Messages are
correlated by ``mid`` so one connection carries many in-flight requests
and replies may land out of order.

Leaves may be numpy arrays or torch tensors. A tensor goes to host bytes
on the sending caller's thread (``pack_arrays``). numpy has no bfloat16,
so a bfloat16 tensor travels as its raw 2-byte buffer under the dtype tag
``"bfloat16"`` and decodes as a bfloat16 torch tensor over those bytes
(``torch.frombuffer(...).view(torch.bfloat16)``): its bits survive the
round trip, and nothing is cast to float32. Every other leaf decodes as a
numpy array, whatever package sent it.

:class:`TransportServer` hands each request to a handler with a one-shot
``reply`` callable; :class:`TransportClient` demultiplexes replies onto
per-request futures on one receiver thread, and a lost connection fails
every in-flight request with :class:`TransportClosed`. The
``fleet/transport`` chaos site fires on every client send (tag = the peer
name).
"""
from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import chaos as _chaos

_LOG = logging.getLogger("bigdl_tpu_torch.serving.transport")

__all__ = ["TransportClosed", "pack_arrays", "unpack_arrays", "encode_tree",
           "decode_tree", "TransportServer", "TransportClient", "RemoteError",
           "transport_threads_alive", "wait_for_port", "pick_advertise_host"]

MAGIC = b"BTF1"
THREAD_PREFIX = "bigdl_tpu_torch-fleet-transport"

#: sanity bound on one frame's header (a corrupt length prefix must not
#: make the reader try to allocate gigabytes)
_MAX_HEADER = 16 * 1024 * 1024

#: sanity bound on one payload buffer. Big transfers are legitimate -
#: a published param leaf or a long prefix's KV pages run to hundreds
#: of MB - but a garbage u64 from a desynchronized stream is
#: astronomically large with overwhelming probability; refusing past
#: 8 GB turns it into the same typed TransportClosed the header bound
#: gives, instead of an allocation death spiral
_MAX_BUF = 8 * 1024 * 1024 * 1024


class TransportClosed(ConnectionError):
    """The peer's connection is gone (process death, socket teardown).
    The fleet layer converts this into the replica-dead signal the
    router's failover machinery already understands."""


# -- array / pytree codecs -------------------------------------------------

#: the dtype tag of a bfloat16 buffer (numpy has no bfloat16)
BF16 = "bfloat16"


def _host(a):
    """A leaf as host bytes: a numpy array, or a CPU bfloat16 tensor."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.ascontiguousarray(a)


def pack_arrays(arrays: Sequence[np.ndarray]) -> Tuple[List[dict], List]:
    """(descriptors, buffers) for a list of numpy arrays or torch tensors.
    Buffers are zero-copy views of the (C-contiguous) host bytes; a torch
    tensor is copied to the host first, on the calling thread, and a
    bfloat16 one is tagged ``"bfloat16"`` over its raw 2-byte buffer."""
    descr, bufs = [], []
    for a in arrays:
        a = _host(a)
        if isinstance(a, torch.Tensor):
            descr.append({"dtype": BF16, "shape": list(a.shape)})
            a = a.view(torch.int16).numpy()
        else:
            descr.append({"dtype": a.dtype.str, "shape": list(a.shape)})
        # an empty leaf has no buffer to view
        bufs.append(memoryview(a).cast("B") if a.size else b"")
    return descr, bufs


def unpack_arrays(descr: Sequence[dict], bufs: Sequence[bytes]) \
        -> List[np.ndarray]:
    """The arrays of a frame: numpy arrays over the received bytes, and
    bfloat16 torch tensors for the ``"bfloat16"`` buffers."""
    if len(descr) != len(bufs):
        raise ValueError(f"array descriptor/buffer count mismatch: "
                         f"{len(descr)} vs {len(bufs)}")
    out = []
    for d, b in zip(descr, bufs):
        if d["dtype"] == BF16:
            shape = tuple(d["shape"])
            if len(b) == 0:
                out.append(torch.empty(shape, dtype=torch.bfloat16))
                continue
            t = torch.frombuffer(b, dtype=torch.int16)
            out.append(t.view(torch.bfloat16).reshape(shape))
            continue
        a = np.frombuffer(b, dtype=np.dtype(d["dtype"]))
        out.append(a.reshape(d["shape"]))
    return out


def encode_tree(tree, bufs: List[np.ndarray]):
    """JSON-able spec for a params / state tree (nested dict / list /
    tuple of arrays, tensors and scalars); array and tensor leaves are
    appended to ``bufs`` and referenced by index - the publish path ships
    a whole version as one frame whose buffers are the raw leaf bytes."""
    if tree is None:
        return {"t": "n"}
    if isinstance(tree, dict):
        return {"t": "d", "k": {str(k): encode_tree(v, bufs)
                                for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"t": "l" if isinstance(tree, list) else "u",
                "v": [encode_tree(v, bufs) for v in tree]}
    if isinstance(tree, (bool, int, float, str)):
        return {"t": "s", "v": tree}
    a = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    idx = len(bufs)
    bufs.append(a)
    return {"t": "a", "i": idx}


def decode_tree(spec, arrays: Sequence[np.ndarray]):
    t = spec["t"]
    if t == "n":
        return None
    if t == "d":
        return {k: decode_tree(v, arrays) for k, v in spec["k"].items()}
    if t in ("l", "u"):
        out = [decode_tree(v, arrays) for v in spec["v"]]
        return out if t == "l" else tuple(out)
    if t == "s":
        return spec["v"]
    return arrays[spec["i"]]


# -- framing ---------------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly n bytes (into one writable buffer, so the arrays and
    tensors decoded over it own writable memory) or raise
    :class:`TransportClosed`."""
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        except OSError as e:
            raise TransportClosed(f"connection lost mid-frame: {e}") from e
        if not k:
            raise TransportClosed("peer closed the connection")
        got += k
    return out


def _send_frame(sock: socket.socket, lock: threading.Lock, header: dict,
                bufs: Sequence = ()):
    """One frame out: header json + raw buffers, under the connection's
    send lock (frames from concurrent repliers must not interleave).
    Raises :class:`TransportClosed` on a dead socket."""
    h = json.dumps(header).encode()
    try:
        with lock:
            sock.sendall(b"".join([MAGIC, struct.pack("<I", len(h)), h,
                                   struct.pack("<I", len(bufs))]))
            for b in bufs:
                mv = memoryview(b).cast("B")
                sock.sendall(struct.pack("<Q", len(mv)))
                sock.sendall(mv)
    except OSError as e:
        raise TransportClosed(f"send failed: {e}") from e


def _recv_frame(sock: socket.socket) -> Tuple[dict, List[bytes]]:
    magic = _read_exact(sock, 4)
    if magic != MAGIC:
        raise TransportClosed(f"bad frame magic {magic!r}")
    (hlen,) = struct.unpack("<I", _read_exact(sock, 4))
    if hlen > _MAX_HEADER:
        raise TransportClosed(f"header length {hlen} exceeds bound")
    header = json.loads(_read_exact(sock, hlen).decode())
    (nbufs,) = struct.unpack("<I", _read_exact(sock, 4))
    bufs = []
    for _ in range(nbufs):
        (blen,) = struct.unpack("<Q", _read_exact(sock, 8))
        if blen > _MAX_BUF:
            raise TransportClosed(f"buffer length {blen} exceeds bound")
        bufs.append(_read_exact(sock, blen))
    return header, bufs


# -- server ----------------------------------------------------------------

class _Conn:
    """One accepted connection: the ``reply`` factory the handler gets."""

    __slots__ = ("sock", "send_lock", "peer")

    def __init__(self, sock: socket.socket, peer: str):
        self.sock = sock
        self.send_lock = threading.Lock()
        self.peer = peer

    def reply(self, mid: int, meta: Optional[dict] = None,
              arrays: Sequence[np.ndarray] = (),
              error: Optional[dict] = None):
        """Answer request ``mid`` (success meta or a typed error dict).
        Safe from any thread; a reply onto a connection the client
        already dropped is swallowed - the client is gone either way."""
        descr, bufs = pack_arrays(arrays)
        header = {"reply_to": mid, "ok": error is None,
                  "meta": meta or {}, "arrays": descr}
        if error is not None:
            header["error"] = error
        try:
            _send_frame(self.sock, self.send_lock, header, bufs)
        except TransportClosed:
            pass


#: handler signature: (reply_fn, op, meta, arrays) where reply_fn is a
#: one-shot ``(meta=None, arrays=(), error=None)`` callable
Handler = Callable[[Callable, str, dict, List[np.ndarray]], None]


class TransportServer:
    """Accept loop + per-connection reader threads over a local socket.

    The handler runs ON the connection's reader thread - it must either
    answer fast (stats, probes) or capture ``reply`` and answer later
    from another thread (the submit path answers from the engine's
    future callback). A handler exception answers the request with a
    typed error frame instead of killing the connection."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 port: int = 0, name: str = ""):
        self.handler = handler
        self.name = name
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[_Conn] = []
        self._lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "TransportServer":
        self._sock.listen(16)
        t = threading.Thread(target=self._accept_loop,
                             name=f"{THREAD_PREFIX}-accept[{self.name}]",
                             daemon=True)
        self._accept_thread = t
        t.start()
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return  # closed
            if self._stop.is_set():   # the close() wake-up poke
                try:
                    sock.close()
                except OSError:
                    pass
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock, f"{addr[0]}:{addr[1]}")
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(
                target=self._conn_loop, args=(conn,),
                name=f"{THREAD_PREFIX}-conn[{self.name}]", daemon=True)
            with self._lock:
                self._threads.append(t)
            t.start()

    def _conn_loop(self, conn: _Conn):
        try:
            while not self._stop.is_set():
                header, bufs = _recv_frame(conn.sock)
                mid = header.get("mid")
                op = header.get("op", "")
                try:
                    arrays = unpack_arrays(header.get("arrays", ()), bufs)
                    done = []

                    def reply(meta=None, arrays=(), error=None,
                              _mid=mid, _done=done):
                        if _done:
                            raise RuntimeError("reply() called twice")
                        _done.append(True)
                        conn.reply(_mid, meta, arrays, error)

                    self.handler(reply, op, header.get("meta", {}), arrays)
                except TransportClosed:
                    raise
                except BaseException as e:  # noqa: BLE001 - answer typed
                    conn.reply(mid, error={"type": type(e).__name__,
                                           "msg": str(e)})
        except TransportClosed:
            pass
        finally:
            try:
                conn.sock.close()
            except OSError:
                pass
            # prune this connection's bookkeeping - a long-lived agent
            # whose peers reconnect (failover drills, monitor rejoins)
            # must not accumulate dead _Conn/Thread objects forever
            with self._lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
                try:
                    self._threads.remove(threading.current_thread())
                except ValueError:
                    pass

    def close(self):
        self._stop.set()
        # closing a listening socket does not reliably wake a thread
        # blocked in accept() - poke it with a throwaway connection
        # first, then close (the loop checks _stop before accepting)
        try:
            poke = socket.create_connection((self.host, self.port),
                                            timeout=1.0)
            poke.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            # shutdown BEFORE close: closing an fd another thread is
            # blocked recv()ing on does not reliably wake it - the
            # half-close does, and it sends the FIN the peer's demux
            # needs to fail its in-flight futures
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.sock.close()
            except OSError:
                pass
        me = threading.current_thread()
        for t in list(self._threads):
            if t is not me:   # a handler may close its own server
                t.join(5.0)
        if self._accept_thread is not None and self._accept_thread is not me:
            self._accept_thread.join(5.0)


# -- client ----------------------------------------------------------------

class TransportClient:
    """One connection to a fleet peer, many in-flight requests.

    ``request_async`` SENDS on the calling thread (so an injected
    ``fleet/transport`` fault or a dead socket raises typed into the
    caller - the router's dispatch loop converts that into
    try-the-next-replica) and resolves the returned future from the
    single receiver thread when the peer answers. A connection loss
    fails every in-flight future with :class:`TransportClosed`."""

    def __init__(self, host: str, port: int, name: str = "",
                 connect_timeout_s: float = 10.0):
        self.host, self.port = host, int(port)
        self.name = name
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._plock = threading.Lock()
        self._mid = 0
        self._recv_thread: Optional[threading.Thread] = None
        self._closed = False
        self._connect_timeout_s = connect_timeout_s

    @property
    def closed(self) -> bool:
        return self._closed

    def connect(self) -> "TransportClient":
        if self._sock is not None:
            return self
        s = socket.create_connection((self.host, self.port),
                                     timeout=self._connect_timeout_s)
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._recv_thread = threading.Thread(
            target=self._recv_loop,
            name=f"{THREAD_PREFIX}-client[{self.name}]", daemon=True)
        self._recv_thread.start()
        return self

    def request_async(self, op: str, meta: Optional[dict] = None,
                      arrays: Sequence[np.ndarray] = ()) -> Future:
        """Send one request; the future resolves to ``(meta, arrays)``
        or raises the peer's typed error / :class:`TransportClosed`.
        The send itself happens HERE, synchronously - a transport fault
        surfaces on the caller, not inside a callback."""
        _chaos_fire("fleet/transport", tag=self.name)
        if self._closed or self._sock is None:
            raise TransportClosed(
                f"transport to {self.name or self.host} is closed")
        fut: Future = Future()
        with self._plock:
            self._mid += 1
            mid = self._mid
            self._pending[mid] = fut
        descr, bufs = pack_arrays(arrays)
        header = {"mid": mid, "op": op, "meta": meta or {},
                  "arrays": descr}
        try:
            _send_frame(self._sock, self._send_lock, header, bufs)
        except TransportClosed:
            with self._plock:
                self._pending.pop(mid, None)
            self._fail_all("send failed")
            raise
        return fut

    def request(self, op: str, meta: Optional[dict] = None,
                arrays: Sequence[np.ndarray] = (),
                timeout: Optional[float] = None):
        """Synchronous convenience: ``(meta, arrays)`` or the typed
        error."""
        return self.request_async(op, meta, arrays).result(timeout)

    def _recv_loop(self):
        try:
            while not self._closed:
                header, bufs = _recv_frame(self._sock)
                mid = header.get("reply_to")
                with self._plock:
                    fut = self._pending.pop(mid, None)
                if fut is None:
                    continue  # peer answered a request we gave up on
                if header.get("ok", False):
                    try:
                        arrays = unpack_arrays(header.get("arrays", ()),
                                               bufs)
                        fut.set_result((header.get("meta", {}), arrays))
                    except Exception as e:  # noqa: BLE001 - typed fail
                        fut.set_exception(e)
                else:
                    err = header.get("error", {})
                    try:
                        arrays = unpack_arrays(header.get("arrays", ()),
                                               bufs)
                    except Exception:  # noqa: BLE001
                        arrays = []
                    fut.set_exception(RemoteError(
                        err.get("type", "RuntimeError"),
                        err.get("msg", "remote failure"), arrays,
                        meta=header.get("meta", {})))
        except TransportClosed as e:
            self._fail_all(str(e))
        except Exception as e:  # noqa: BLE001 - fabric bug, fail typed
            self._fail_all(f"{type(e).__name__}: {e}")

    def _fail_all(self, why: str):
        self._closed = True
        with self._plock:
            pending = list(self._pending.values())
            self._pending.clear()
        exc = TransportClosed(
            f"transport to {self.name or self.host}:{self.port} lost "
            f"({why})")
        for fut in pending:
            try:
                fut.set_exception(exc)
            except Exception:  # noqa: BLE001 - already resolved
                pass

    def close(self):
        self._closed = True
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        self._fail_all("closed by caller")
        t = self._recv_thread
        if t is not None and t is not threading.current_thread():
            t.join(5.0)


class RemoteError(RuntimeError):
    """A typed error frame from the peer: carries the remote exception's
    class name, message, and any attached arrays (a dying scheduler's
    ``partial`` token vector rides array 0). The fleet layer re-raises
    it as the matching LOCAL serving exception type so the router's
    isinstance-based failover/recovery logic is process-transparent."""

    def __init__(self, type_name: str, msg: str,
                 arrays: Sequence[np.ndarray] = (), meta=None):
        super().__init__(msg)
        self.type_name = type_name
        self.arrays = list(arrays)
        self.meta = dict(meta or {})


def transport_threads_alive() -> int:
    """Live transport threads (tests assert 0 after close)."""
    return sum(1 for t in threading.enumerate()
               if t.name.startswith(THREAD_PREFIX) and t.is_alive())


def _chaos_fire(site: str, tag: Optional[str] = None):
    """The ``fleet/transport`` chaos seam (disarmed: one module-global
    read inside ``chaos.maybe_fire``)."""
    _chaos.maybe_fire(site, tag=tag)


def wait_for_port(host: str, port: int, timeout_s: float = 30.0) -> bool:
    """Poll until a peer listens (spawned agent startup)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            s = socket.create_connection((host, port), timeout=1.0)
            s.close()
            return True
        except OSError:
            time.sleep(0.05)
    return False


def pick_advertise_host(bind_host: str = "0.0.0.0",
                        probe: str = "10.255.255.255") -> str:
    """The address peers should DIAL for a server bound to
    ``bind_host``. A concrete bind address is already reachable and is
    returned as-is; a wildcard bind (``0.0.0.0`` / ``::`` / empty) needs
    the host's outbound interface address - resolved with the classic
    connected-UDP-socket trick (no packet is sent; the kernel just picks
    the route to ``probe`` and reports the source address it would use).
    Falls back to ``127.0.0.1`` on boxes with no route at all, which
    keeps single-host fleets working offline."""
    if bind_host not in ("", "0.0.0.0", "::"):
        return bind_host
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((probe, 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"
