"""The port's parameter server (``paddle_tpu_torch/distributed/ps.py``
over its own copy of the native server, ``native/csrc/ps.cc``) against
the JAX package's, on the wire both ways:

* every command — sparse tables under SGD and Adagrad (create, pull,
  push, the per-id row init), dense tables, save and load, shrink, stats,
  barrier, heartbeat — gives the same bytes for each of the four
  client/server pairings (JAX or port client against JAX or port server);
* a table file saved by either package's server loads in the other's,
  and a pull of the same ids then gives the same bits; multi-server
  routing too;
* the port's ``Communicator`` merges duplicate ids as the JAX one does
  (sync and async);
* the port's ``PSClient`` reconnects under its seeded retry policy and
  names a dead server with its attempt budget;
* ``python -m paddle_tpu_torch.distributed.ps`` serves a JAX client.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.distributed import ps as jax_ps
from paddle_tpu_torch.distributed import ps as torch_ps
from paddle_tpu_torch.resilience.retry import RetryPolicy
from test_ps import _StubPS

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [("jax", "jax"), ("jax", "torch"), ("torch", "jax"),
         ("torch", "torch")]
MOD = {"jax": jax_ps, "torch": torch_ps}


def _ids(*v):
    return np.array(v, dtype=np.uint64)


def _drive(client, tmp):
    """Every command once; returns what came back."""
    out = {}
    client.create_table(1, dim=4, init_range=0.05)
    client.create_table(3, dim=2, init_range=0.01,
                        optimizer=MOD["torch"].OPT_ADAGRAD)
    client.create_table(2, dense_size=8, is_dense=True)
    ids = _ids(10, 2 ** 40 + 3, 10, 7)
    out["init"] = client.pull_sparse(1, ids, 4)
    client.push_sparse(1, _ids(10, 7), np.array([[2.0] * 4, [1.0] * 4], "f"),
                       lr=0.25)
    out["sgd"] = client.pull_sparse(1, ids, 4)
    client.push_sparse(3, _ids(7, 8), np.array([[3.0, 4.0], [1.0, -2.0]], "f"),
                       lr=0.1)
    out["adagrad"] = client.pull_sparse(3, _ids(7, 8, 9), 2)
    client.push_dense(2, np.arange(8, dtype=np.float32), lr=1.0)
    out["dense"] = client.pull_dense(2)
    path = str(tmp / "t1.tbl")
    client.save(1, path)
    client.push_sparse(1, _ids(10), np.ones((1, 4), "f"), lr=1.0)
    out["pushed"] = client.pull_sparse(1, _ids(10), 4)
    client.load(1, path)
    out["loaded"] = client.pull_sparse(1, ids, 4)
    out["stats"] = client.table_stats()
    for step in range(4):
        client.push_sparse(1, _ids(100 + step), np.ones((1, 4), "f"), lr=0.1)
    out["shrunk"] = client.shrink(1, keep_versions=2)
    out["stats_after"] = client.table_stats()
    client.barrier(1)
    out["heartbeat"] = sorted(client.heartbeat(3))
    with open(path, "rb") as f:
        out["file"] = f.read()
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_every_command_gives_the_same_bytes_in_every_pairing(
        tmp_path, client_pkg, server_pkg):
    results = {}
    for c_pkg, s_pkg in (("jax", "jax"), (client_pkg, server_pkg)):
        srv = MOD[s_pkg].PSServer()
        client = MOD[c_pkg].PSClient([srv.endpoint])
        d = tmp_path / f"{c_pkg}-{s_pkg}"
        d.mkdir(exist_ok=True)
        try:
            results[(c_pkg, s_pkg)] = _drive(client, d)
        finally:
            client.close()
            srv.stop()
    want, got = results[("jax", "jax")], results[(client_pkg, server_pkg)]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
        else:
            assert got[k] == w, k
    assert want["shrunk"] > 0 and want["heartbeat"] == [3]
    np.testing.assert_allclose(want["sgd"][0], want["init"][0] - 0.5, rtol=1e-6)


@pytest.mark.parametrize("saver,loader", [("torch", "jax"), ("jax", "torch")])
def test_table_files_cross_the_packages(tmp_path, saver, loader):
    path = str(tmp_path / "emb.tbl")
    ids = _ids(*range(0, 4000, 37), 2 ** 50 + 1)
    srv = MOD[saver].PSServer()
    c = MOD[saver].PSClient([srv.endpoint])
    try:
        c.create_table(9, dim=8, init_range=0.1, optimizer=1)
        c.pull_sparse(9, ids, 8)
        c.push_sparse(9, ids[::3], np.random.RandomState(0).randn(
            len(ids[::3]), 8).astype("f"), lr=0.05)
        before = c.pull_sparse(9, ids, 8)
        c.save(9, path)
    finally:
        c.close()
        srv.stop()
    srv = MOD[loader].PSServer()
    c = MOD[loader].PSClient([srv.endpoint])
    try:
        c.create_table(9, dim=8, init_range=0.1, optimizer=1)
        c.load(9, path)
        after = c.pull_sparse(9, ids, 8)
        assert c.table_stats()[9] == len(ids)
        # the Adagrad state came across too: one more push lands alike
        g = np.ones((len(ids), 8), "f")
        c.push_sparse(9, ids, g, lr=0.05)
        pushed = c.pull_sparse(9, ids, 8)
    finally:
        c.close()
        srv.stop()
    assert after.tobytes() == before.tobytes()
    srv = MOD[saver].PSServer()
    c = MOD[saver].PSClient([srv.endpoint])
    try:
        c.create_table(9, dim=8, init_range=0.1, optimizer=1)
        c.load(9, path)
        c.push_sparse(9, ids, g, lr=0.05)
        assert c.pull_sparse(9, ids, 8).tobytes() == pushed.tobytes()
    finally:
        c.close()
        srv.stop()


def test_two_servers_route_and_save_shards_alike(tmp_path):
    pulled = {}
    for pkg in ("jax", "torch"):
        srvs = [MOD[pkg].PSServer(), MOD[pkg].PSServer()]
        c = MOD[pkg].PSClient([s.endpoint for s in srvs])
        try:
            c.create_table(1, dim=4, init_range=0.1)
            ids = np.arange(100, dtype=np.uint64)
            pulled[pkg] = c.pull_sparse(1, ids, 4)
            assert c.table_stats()[1] == 100
            c.save(1, str(tmp_path / f"{pkg}.tbl"))
        finally:
            c.close()
            for s in srvs:
                s.stop()
        for i in range(2):
            assert (tmp_path / f"{pkg}.tbl.shard{i}").exists()
    assert pulled["torch"].tobytes() == pulled["jax"].tobytes()
    for i in range(2):
        assert ((tmp_path / f"torch.tbl.shard{i}").read_bytes()
                == (tmp_path / f"jax.tbl.shard{i}").read_bytes())


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_the_communicator_merges_as_the_jax_one(mode):
    got = {}
    for pkg in ("jax", "torch"):
        srv = MOD[pkg].PSServer()
        c = MOD[pkg].PSClient([srv.endpoint])
        try:
            c.create_table(5, dim=3, init_range=0.0)
            comm = MOD[pkg].Communicator(c, mode=mode, merge_steps=8)
            r = np.random.RandomState(1)
            for _ in range(6):
                ids = r.randint(0, 5, 7).astype(np.uint64)
                comm.push_sparse(5, ids, r.randn(7, 3).astype("f"), 0.1)
            comm.flush()
            comm.stop()
            got[pkg] = c.pull_sparse(5, np.arange(5, dtype=np.uint64), 3)
        finally:
            c.close()
            srv.stop()
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-6,
                               atol=1e-7)
    assert np.abs(got["torch"]).sum() > 0


def test_the_client_reconnects_with_the_seeded_backoff():
    srv = _StubPS()
    srv.start()
    try:
        sleeps = []
        policy = RetryPolicy(max_attempts=3, base_delay_s=0.01,
                             max_delay_s=0.1, seed=7,
                             sleep=lambda d: sleeps.append(d))
        client = torch_ps.PSClient([srv.endpoint], retry=policy)
        assert np.array_equal(client.pull_dense(1), np.zeros(4, "f"))
        srv.drop_next = 1
        assert np.array_equal(client.pull_dense(1), np.zeros(4, "f"))
        ref = RetryPolicy(max_attempts=3, base_delay_s=0.01,
                          max_delay_s=0.1, seed=7)
        assert sleeps == [pytest.approx(ref.delay(1))]
        assert srv.requests == 3            # ok + dropped + resent
        client.close()
    finally:
        srv.stop()


def test_a_dead_server_is_named_with_the_attempt_budget():
    srv = _StubPS()
    srv.start()
    sleeps = []
    policy = RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.1,
                         seed=7, sleep=lambda d: sleeps.append(d))
    client = torch_ps.PSClient([srv.endpoint], retry=policy)
    assert client.pull_dense(1).shape == (4,)
    srv.stop()
    time.sleep(0.3)
    with pytest.raises(ConnectionError) as ei:
        client.pull_dense(1)
    assert srv.endpoint in str(ei.value) and "3 attempts" in str(ei.value)
    assert len(sleeps) == 2
    client.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_standalone_server_serves_a_jax_client():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.ps",
         "--port", str(port)], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"127.0.0.1:{port}" in line, line + proc.stderr.read()
        c = jax_ps.PSClient([f"127.0.0.1:{port}"])
        c.create_table(1, dim=2, init_range=0.0)
        c.push_sparse(1, _ids(4), np.ones((1, 2), "f"), lr=0.5)
        np.testing.assert_array_equal(c.pull_sparse(1, _ids(4), 2),
                                      [[-0.5, -0.5]])
        c.close()
    finally:
        proc.kill()
        proc.wait(10)
