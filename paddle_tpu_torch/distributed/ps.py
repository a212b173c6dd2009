"""Parameter-server client + in-process server host.

Reference: paddle/fluid/operators/distributed/ RPCClient (rpc_client.h) and
framework/fleet/fleet_wrapper.h (PullSparseVarsSync :84, PushSparseVarsAsync
:141, PushDenseVarsAsync :114, LoadModel/SaveModel :199-206, Shrink :226).
The server itself is native C++ spoken to over a length-prefixed TCP
protocol: the port's own copy of the JAX package's ``csrc/ps/ps.cc``
(``native/csrc/ps.cc``, built by ``native.load_native``), so the wire,
the per-id row init and the table files are the same in both packages —
either package's client talks to the other's server, and a table saved
by one loads in the other. PSServer hosts it in-process via ctypes for
single-host jobs and tests, and `python -m
paddle_tpu_torch.distributed.ps` runs it standalone for real multi-host
clusters. PSClient's retry and reconnect run on the port's
``resilience/retry.py`` and its fault site ``ps.rpc`` on the port's
injector.

The fleet replica transport (``serving/fleet/replica.py`` and
``worker.py``) speaks the same frames (``frame_send``/``frame_recv``).
"""

import ctypes
import socket
import struct
import threading

import numpy as np

from paddle_tpu_torch.native import load_native
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.retry import RetryPolicy
from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["PSServer", "PSClient", "Communicator", "frame_send",
           "frame_recv"]

CMD_CREATE = 1
CMD_PULL_SPARSE = 2
CMD_PUSH_SPARSE = 3
CMD_PULL_DENSE = 4
CMD_PUSH_DENSE = 5
CMD_SAVE = 6
CMD_LOAD = 7
CMD_SHRINK = 8
CMD_BARRIER = 9
CMD_HEARTBEAT = 10
CMD_STOP = 11
CMD_STATS = 12

OPT_SGD = 0
OPT_ADAGRAD = 1


# -- the shared wire framing -------------------------------------------------
# ONE definition of the '<I'-length-prefixed frame protocol: the PS
# client below and the fleet replica transport
# (serving/fleet/{replica,worker}.py) all speak it — a framing fix
# lands once, here.


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


class PSServer:
    """In-process native PS (thread pool lives in the C++ lib)."""

    def __init__(self, port=0):
        self._lib = load_native("ps")
        self._lib.paddle_ps_start.restype = ctypes.c_void_p
        self._lib.paddle_ps_start.argtypes = [ctypes.c_int]
        self._lib.paddle_ps_port.restype = ctypes.c_int
        self._lib.paddle_ps_port.argtypes = [ctypes.c_void_p]
        self._lib.paddle_ps_stop.argtypes = [ctypes.c_void_p]
        self._h = self._lib.paddle_ps_start(port)
        enforce(self._h, f"failed to start PS on port {port}")
        self.port = self._lib.paddle_ps_port(self._h)
        self.endpoint = f"127.0.0.1:{self.port}"

    def stop(self):
        if self._h:
            self._lib.paddle_ps_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class PSClient:
    """Blocking client; one TCP connection per client (thread-safe via lock).
    For multi-server sharding, ids are routed by id %% n_servers — the
    analog of the reference's per-parameter block placement
    (reference: python/paddle/fluid/transpiler/distribute_transpiler.py:254
    slice_variable round-robin)."""

    _DEFAULT_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05,
                                 max_delay_s=1.0, deadline_s=60.0)

    def __init__(self, endpoints, retry=_DEFAULT_RETRY):
        if isinstance(endpoints, str):
            endpoints = endpoints.split(",")
        self._eps = list(endpoints)
        self._socks = []
        self._lock = threading.Lock()
        # transient transport errors reconnect + resend under the shared
        # policy (requests are single-message, so a fresh socket starts
        # clean; non-idempotent cmds become at-least-once on retry);
        # retry=None disables for raw fail-fast semantics
        self._retry = retry
        for ep in self._eps:
            self._socks.append(self._connect(ep))

    @staticmethod
    def _connect(ep):
        host, port = ep.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=60)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _reconnect(self, server):
        try:
            self._socks[server].close()
        except OSError:
            pass
        self._socks[server] = self._connect(self._eps[server])

    @property
    def n_servers(self):
        return len(self._socks)

    # -- wire helpers ------------------------------------------------------
    def _rpc(self, server, cmd, table_id, payload=b""):
        body = struct.pack("<BI", cmd, table_id) + payload

        def exchange():
            faults.fire("ps.rpc")
            s = self._socks[server]
            frame_send(s, body)
            return frame_recv(s)

        def repair(exc, attempt):
            if isinstance(exc, (ConnectionError, OSError)) and not isinstance(
                exc, faults.InjectedFault
            ):
                try:
                    self._reconnect(server)
                except OSError:
                    # server still down: let the policy's bounded backoff
                    # decide whether another attempt happens — a reconnect
                    # failure must not abort the retry loop early
                    pass

        if self._retry is None:
            body = exchange()
        else:
            try:
                body = self._retry.call(exchange, on_retry=repair)
            except (ConnectionError, OSError) as e:
                # a permanently dead PS exhausts the bounded policy; name
                # the endpoint and the budget instead of surfacing a bare
                # socket error (or, worse, retrying forever)
                raise ConnectionError(
                    f"parameter server {self._eps[server]} unreachable: "
                    f"cmd={cmd} failed after "
                    f"{self._retry.max_attempts} attempts ({e})"
                ) from e
        status = body[0]
        if status != 0:
            raise RuntimeError(
                f"PS rpc cmd={cmd} failed: {body[1:].decode(errors='replace')}"
            )
        return body[1:]

    # -- API ---------------------------------------------------------------
    def create_table(self, table_id, dim=0, dense_size=0, init_range=0.01,
                     optimizer=OPT_SGD, is_dense=False):
        payload = struct.pack(
            "<BIQfB", int(is_dense), dim, dense_size, init_range, optimizer
        )
        with self._lock:
            for srv in range(self.n_servers):
                self._rpc(srv, CMD_CREATE, table_id, payload)

    def _route(self, ids):
        """ids (u64 ndarray) -> per-server (ids, positions)."""
        srv = ids % self.n_servers
        out = []
        for sidx in range(self.n_servers):
            pos = np.nonzero(srv == sidx)[0]
            out.append((ids[pos], pos))
        return out

    def pull_sparse(self, table_id, ids, dim):
        """ids: 1-D uint64; returns [len(ids), dim] float32."""
        ids = np.ascontiguousarray(ids, dtype=np.uint64)
        out = np.empty((len(ids), dim), dtype=np.float32)
        with self._lock:
            for sidx, (sids, pos) in enumerate(self._route(ids)):
                if len(sids) == 0:
                    continue
                payload = struct.pack("<Q", len(sids)) + sids.tobytes()
                resp = self._rpc(sidx, CMD_PULL_SPARSE, table_id, payload)
                out[pos] = np.frombuffer(resp, dtype=np.float32).reshape(
                    len(sids), dim
                )
        return out

    def push_sparse(self, table_id, ids, grads, lr):
        ids = np.ascontiguousarray(ids, dtype=np.uint64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        with self._lock:
            for sidx, (sids, pos) in enumerate(self._route(ids)):
                if len(sids) == 0:
                    continue
                payload = (
                    struct.pack("<fQ", lr, len(sids))
                    + sids.tobytes()
                    + grads[pos].tobytes()
                )
                self._rpc(sidx, CMD_PUSH_SPARSE, table_id, payload)

    def pull_dense(self, table_id):
        with self._lock:
            resp = self._rpc(0, CMD_PULL_DENSE, table_id)
        return np.frombuffer(resp, dtype=np.float32).copy()

    def push_dense(self, table_id, grads, lr):
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        payload = struct.pack("<fQ", lr, grads.size) + grads.tobytes()
        with self._lock:
            self._rpc(0, CMD_PUSH_DENSE, table_id, payload)

    def save(self, table_id, path):
        """Checkpoint a table server-side (reference: checkpoint_notify_op —
        snapshots happen where the data lives). With multiple servers each
        saves its shard to <path>.shard<i>."""
        with self._lock:
            for sidx in range(self.n_servers):
                p = path if self.n_servers == 1 else f"{path}.shard{sidx}"
                payload = struct.pack("<I", len(p)) + p.encode()
                self._rpc(sidx, CMD_SAVE, table_id, payload)

    def load(self, table_id, path):
        with self._lock:
            for sidx in range(self.n_servers):
                p = path if self.n_servers == 1 else f"{path}.shard{sidx}"
                payload = struct.pack("<I", len(p)) + p.encode()
                self._rpc(sidx, CMD_LOAD, table_id, payload)

    def shrink(self, table_id, keep_versions=1000):
        dropped = 0
        with self._lock:
            for sidx in range(self.n_servers):
                resp = self._rpc(
                    sidx, CMD_SHRINK, table_id, struct.pack("<Q", keep_versions)
                )
                dropped += struct.unpack("<Q", resp)[0]
        return dropped

    def barrier(self, n_workers):
        with self._lock:
            self._rpc(0, CMD_BARRIER, 0, struct.pack("<I", n_workers))

    def heartbeat(self, worker_id):
        """Returns {worker_id: seconds_since_last_seen} as tracked by the
        chief server (reference: heart_beat_monitor.h:54)."""
        with self._lock:
            resp = self._rpc(0, CMD_HEARTBEAT, 0, struct.pack("<I", worker_id))
        (n,) = struct.unpack("<I", resp[:4])
        out = {}
        off = 4
        for _ in range(n):
            wid, age = struct.unpack("<If", resp[off:off + 8])
            out[wid] = age
            off += 8
        return out

    def table_stats(self):
        """{table_id: total_rows (sparse) / size (dense)} across servers."""
        out = {}
        with self._lock:
            for sidx in range(self.n_servers):
                resp = self._rpc(sidx, CMD_STATS, 0)
                (n,) = struct.unpack("<I", resp[:4])
                off = 4
                for _ in range(n):
                    tid, cnt = struct.unpack("<IQ", resp[off:off + 12])
                    out[tid] = out.get(tid, 0) + cnt
                    off += 12
        return out

    def stop_server(self):
        with self._lock:
            for sidx in range(self.n_servers):
                try:
                    self._rpc(sidx, CMD_STOP, 0)
                except (RuntimeError, ConnectionError, OSError):
                    pass

    def close(self):
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
        self._socks = []


class Communicator:
    """Async gradient communicator: trainer threads enqueue sparse grads;
    a background thread merges duplicate ids and pushes batched updates
    (reference: paddle/fluid/operators/distributed/communicator.h:237
    AsyncCommunicator — send queues + merge + batched send; :365 GeoSgd).
    mode='sync' pushes inline; 'async' merges up to `merge_steps` batches."""

    def __init__(self, client, mode="async", merge_steps=4, max_queue=64):
        import queue as _q

        self._client = client
        self._mode = mode
        self._merge_steps = merge_steps
        self._queue = _q.Queue(maxsize=max_queue)
        self._thread = None
        self._stop = threading.Event()
        self._err = []
        if mode == "async":
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def push_sparse(self, table_id, ids, grads, lr):
        import queue as _q

        if self._mode == "sync":
            self._client.push_sparse(table_id, ids, grads, lr)
            return
        item = (table_id, np.asarray(ids), np.asarray(grads), lr)
        # bounded put that keeps checking for a dead background thread —
        # blocking forever on a full queue would hide the PS failure
        while True:
            if self._err:
                raise self._err[0]
            try:
                self._queue.put(item, timeout=0.2)
                return
            except _q.Full:
                continue

    def _loop(self):
        import queue as _q

        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.05)
            except _q.Empty:
                continue
            batch = [item]
            for _ in range(self._merge_steps - 1):
                try:
                    batch.append(self._queue.get_nowait())
                except _q.Empty:
                    break
            try:
                self._flush(batch)
            except BaseException as e:
                # lockdep: ok(single append from the one loop thread before it exits; list.append is atomic under the GIL and readers only probe emptiness then index 0)
                self._err.append(e)
                return

    def _flush(self, batch):
        by_table = {}
        for table_id, ids, grads, lr in batch:
            by_table.setdefault((table_id, lr), []).append((ids, grads))
        for (table_id, lr), items in by_table.items():
            ids = np.concatenate([i for i, _ in items])
            grads = np.concatenate([g for _, g in items])
            # merge duplicate ids: sum grads (matches allreduce-sum semantics)
            uniq, inv = np.unique(ids, return_inverse=True)
            merged = np.zeros((len(uniq), grads.shape[1]), dtype=np.float32)
            np.add.at(merged, inv, grads)
            self._client.push_sparse(table_id, uniq, merged, lr)

    def flush(self):
        """Drain pending async pushes (barrier before save/eval)."""
        import queue as _q

        if self._mode != "async":
            return
        pending = []
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except _q.Empty:
                break
        if pending:
            self._flush(pending)
        if self._err:
            raise self._err[0]

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.flush()


def main():
    """Standalone server: python -m paddle_tpu_torch.distributed.ps --port 7164"""
    import argparse
    import time

    parser = argparse.ArgumentParser("paddle_tpu_torch parameter server")
    parser.add_argument("--port", type=int, default=7164)
    args = parser.parse_args()
    srv = PSServer(args.port)
    print(f"PS listening on {srv.endpoint}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
