"""The parameter-server wire framing: one ``<I``-length-prefixed frame
protocol, the port's copy of ``_read_exact``, ``frame_send`` and
``frame_recv`` from the JAX package's ``distributed/ps.py``.

The fleet replica transport (``serving/fleet/replica.py`` and
``worker.py``) speaks it. The parameter server itself (``PSServer``,
``PSClient``, ``Communicator``) is not ported: ROADMAP.md, M9.
"""

import struct

__all__ = ["frame_send", "frame_recv"]


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        buf += chunk
    return buf


def frame_send(sock, body):
    """Send one length-prefixed frame."""
    sock.sendall(struct.pack("<I", len(body)) + body)


def frame_recv(sock):
    """Read one length-prefixed frame; ConnectionError on EOF."""
    (blen,) = struct.unpack("<I", _read_exact(sock, 4))
    return _read_exact(sock, blen)
