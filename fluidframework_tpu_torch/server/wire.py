"""Socket-side pieces of the wire protocol that the columnar front door
and its client share.

- :data:`MAX_FRAME` bounds one frame's payload: the door faults a
  connection whose frame header announces more, before its payload
  arrives (``native_ingress.MAX_PAYLOAD``).
- :class:`WireError` is what a client's frame read raises on a corrupt
  frame or a peer that closed mid-frame (a ``ConnectionError``, hence an
  ``OSError``).
- :class:`BufferedSocketReader` serves the client's three-reads-a-frame
  parser from one large kernel ``recv``.
"""

from __future__ import annotations

import socket

#: defensive bound on one frame's payload
MAX_FRAME = 64 * 1024 * 1024

#: how much a buffered reader asks the kernel for a recv: one large read
#: amortizes the syscall over every frame it holds
READ_CHUNK = 256 * 1024


class WireError(ConnectionError):
    pass


class BufferedSocketReader:
    """Socket wrapper whose ``recv(n)`` serves from a userspace buffer
    refilled by one large kernel recv, so a frame parser that reads a
    header, a payload and a trailer costs one syscall a ``READ_CHUNK`` of
    traffic. Other attributes pass through to the wrapped socket (its
    timeout bounds every refill)."""

    def __init__(self, sock: socket.socket, chunk: int = READ_CHUNK):
        self._sock = sock
        self._chunk = chunk
        self._buf = b""
        self._pos = 0

    def recv(self, n: int) -> bytes:
        have = len(self._buf) - self._pos
        if have == 0:
            data = self._sock.recv(max(n, self._chunk))
            if len(data) <= n:
                return data  # exact fit or EOF b"": no buffering needed
            self._buf = data
            self._pos = 0
            have = len(data)
        take = min(n, have)
        out = self._buf[self._pos:self._pos + take]
        self._pos += take
        if self._pos == len(self._buf):
            self._buf = b""
            self._pos = 0
        return out

    def __getattr__(self, name):
        return getattr(self._sock, name)
