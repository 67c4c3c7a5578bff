"""The store and socket planes of the serving fleet (counterpart of the
``TCPStore`` and ``P2PEndpoint`` classes of
``paddle_tpu/native/__init__.py``), without native code of their own:

- ``TCPStore`` wraps ``torch.distributed.TCPStore`` behind the JAX
  class's API (``set``, ``get(key, timeout)`` raising ``TimeoutError``,
  ``add``, ``delete_key``, ``wait``, ``close``, ``host``/``port``;
  ``is_master=True`` runs the server in-process, port 0 picking a free
  port). torch's store has no 1 MB value cap, but the KV wire keeps the
  JAX protocol's chunking (``serving/kv_transfer.publish_blob``), so the
  keys and values a blob leaves on a store are the same in both
  packages.
- ``P2PEndpoint`` is a tag-addressed message endpoint on stdlib
  sockets: a listener thread, one reader thread per accepted
  connection, per-tag FIFO mailboxes, and cached outgoing connections.
  Each frame is two native-endian ``uint64`` (tag, payload length) and
  the payload, as in ``native/src/p2p.cc``, so this endpoint and the
  JAX package's exchange messages.

Nothing here touches a GPU or starts a thread at import.
"""

import collections
import socket
import struct
import threading
import time
from datetime import timedelta

__all__ = ["is_available", "TCPStore", "P2PEndpoint",
           "decode_counter"]

_FRAME = struct.Struct("=QQ")          # tag, payload length


def decode_counter(raw) -> int:
    """Decode a store counter value, as the JAX ``native.decode_counter``
    does for its own store. The JAX store's ``add`` keeps counters as
    8 raw little-endian int64 bytes; ``torch.distributed.TCPStore``'s
    keeps them as ASCII decimal, and a ``set`` writes ASCII on both. So
    an ASCII integer is parsed first: read as little-endian, a counter of
    8 digits (10,000,000 and up) would be misread. Only 8 bytes that are
    not an ASCII integer fall back to little-endian."""
    if isinstance(raw, (bytes, bytearray)):
        try:
            return int(raw)
        except ValueError:
            if len(raw) == 8:
                return int.from_bytes(raw, "little", signed=True)
            raise
    return int(raw)


def is_available() -> bool:
    """True: both planes need only torch and the standard library."""
    return True


class TCPStore:
    """Rendezvous KV store over ``torch.distributed.TCPStore``.

    ``is_master=True`` also runs the server in this process."""

    QUIET_WAIT_S = 0.05

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, timeout: float = 30.0):
        from torch.distributed import TCPStore as _Store
        try:
            self._store = _Store(host, int(port), is_master=is_master,
                                 wait_for_workers=False,
                                 timeout=timedelta(seconds=timeout))
        except RuntimeError as e:
            raise ConnectionError(
                f"TCPStore {'serve' if is_master else 'connect'} "
                f"{host}:{port} failed: {e}") from e
        self.host, self.port = host, int(self._store.port)

    def set(self, key: str, value):
        self._store.set(key, value)

    def get(self, key: str, timeout: float = 30.0) -> bytes:
        """The value under ``key``, waiting up to ``timeout`` seconds for
        it to appear (torch's ``get`` waits the store's whole timeout, so
        the per-call bound is a ``check``, then a ``wait``).

        A timeout of at most ``QUIET_WAIT_S`` is a probe of a key that is
        most often absent (the serve loops probe the shutdown key and the
        mailbox counter every iteration): it sleeps the timeout out and
        checks once more instead of torch's ``wait``, which logs two c10d
        warning lines each time it times out."""
        from torch.distributed import DistStoreError
        if self._store.check([key]):
            return self._store.get(key)
        if timeout <= self.QUIET_WAIT_S:
            time.sleep(max(timeout, 0.0))
            if self._store.check([key]):
                return self._store.get(key)
            raise TimeoutError(f"get({key!r}) timed out")
        try:
            self._store.wait([key], timedelta(seconds=max(timeout, 1e-3)))
            return self._store.get(key)
        except DistStoreError as e:
            raise TimeoutError(f"get({key!r}) timed out") from e

    def add(self, key: str, amount: int = 1) -> int:
        return int(self._store.add(key, int(amount)))

    def delete_key(self, key: str):
        self._store.delete_key(key)

    def wait(self, keys, timeout: float = 30.0):
        for k in (keys if isinstance(keys, (list, tuple)) else [keys]):
            self.get(k, timeout=timeout)

    def close(self):
        # torch's store closes its connection (and a master its server)
        # when the last reference goes
        self._store = None


def _recv_exact(sock, n: int):
    """``n`` bytes from ``sock``, or None once the peer closed."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if k == 0:
            return None
        got += k
    return buf


class P2PEndpoint:
    """Tag-addressed point-to-point message endpoint, one per replica:
    ``send(host, port, tag, payload)`` writes one frame on a cached
    connection; ``recv(tag, timeout)`` pops the oldest message of that
    tag from the local mailbox."""

    def __init__(self, port: int = 0):
        try:
            lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lsock.bind(("", int(port)))
            lsock.listen(64)
        except OSError as e:
            raise RuntimeError(
                f"P2PEndpoint failed to listen on {port}: {e}") from e
        self._lsock = lsock
        self.port = lsock.getsockname()[1]
        self._cv = threading.Condition()
        self._mail = collections.defaultdict(collections.deque)
        self._out = {}                  # (host, port) -> socket
        self._out_lock = threading.Lock()
        self._conns = []                # accepted sockets
        self._threads = []
        self._closed = False
        t = threading.Thread(target=self._accept_loop,
                             name=f"p2p-accept-{self.port}", daemon=True)
        self._threads.append(t)
        t.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return                  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._cv:
                if self._closed:
                    conn.close()
                    return
                self._conns.append(conn)
            t = threading.Thread(target=self._read_loop, args=(conn,),
                                 name=f"p2p-read-{self.port}", daemon=True)
            self._threads.append(t)
            t.start()

    def _read_loop(self, conn):
        try:
            while True:
                hdr = _recv_exact(conn, _FRAME.size)
                if hdr is None:
                    return
                tag, n = _FRAME.unpack(hdr)
                payload = _recv_exact(conn, n) if n else bytearray()
                if payload is None:
                    return
                with self._cv:
                    self._mail[tag].append(bytes(payload))
                    self._cv.notify_all()
        except OSError:
            return                      # connection reset or closed

    def send(self, host: str, port: int, tag: int, payload: bytes):
        key = (host, int(port))
        with self._out_lock:
            sock = self._out.get(key)
            if sock is None:
                try:
                    sock = socket.create_connection(key)
                except OSError as e:
                    raise ConnectionError(
                        f"p2p connect {host}:{port} failed: {e}") from e
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._out[key] = sock
            try:
                sock.sendall(_FRAME.pack(int(tag), len(payload)))
                if payload:
                    sock.sendall(payload)
            except OSError as e:
                # dropped from the cache: the next send redials
                self._out.pop(key, None)
                sock.close()
                raise BrokenPipeError(
                    f"p2p send to {host}:{port} failed: {e}") from e

    def recv(self, tag: int, timeout: float = 60.0) -> bytes:
        with self._cv:
            if not self._cv.wait_for(lambda: self._mail.get(tag),
                                     timeout=max(0.0, timeout)):
                raise TimeoutError(f"p2p recv(tag={tag}) timed out "
                                   f"after {timeout}s")
            box = self._mail[tag]
            msg = box.popleft()
            if not box:
                del self._mail[tag]
            return msg

    def close(self):
        with self._cv:
            if self._closed:
                return
            self._closed = True
            conns, self._conns = self._conns, []
        for s in [self._lsock] + conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        with self._out_lock:
            for s in self._out.values():
                s.close()
            self._out.clear()
        for t in self._threads:
            t.join(timeout=5.0)
