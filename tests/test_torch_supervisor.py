"""The port's gang supervisor (``resilience/supervisor.py``), as
``tests/test_resilience.py`` holds the JAX one:

* a crashed gang is restarted under the budget, with the JAX package's
  event timeline; an exhausted budget raises ``GangFailedError``; a
  heartbeat-declared hang restarts the gang; ``heartbeat_tick`` is inert
  without a supervisor;
* before a restart, corrupt checkpoints are quarantined, so the
  relaunched gang resumes from the newest valid one;
* ``restart(rank)`` respawns one rank into its slot and leaves the
  others alone, counted in ``resilience_events_total{kind=rank_restart}``;
* the fleet router restarts a DEAD replica in place through the
  supervisor (``supervisor=`` / ``revive_factory=``), before autoscale
  would replace it.
"""

import os
import textwrap
import time

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed.launch import terminate_gang
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.supervisor import (
    HEARTBEAT_DIR_ENV,
    GangFailedError,
    GangSupervisor,
    heartbeat_tick,
)
from paddle_tpu_torch.serving.decode import build_decoder_model
from paddle_tpu_torch.serving.fleet import FleetRouter, LocalReplica

GEOM = dict(vocab_size=24, hidden=8, num_layers=1, slots=2, max_len=16)


def _write_script(tmp_path, name, body):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        f.write(textwrap.dedent(body))
    return p


def test_supervisor_restarts_crashed_gang(tmp_path):
    marker = str(tmp_path / "crashed_once")
    script = _write_script(tmp_path, "worker.py", """
        import os, sys
        marker = sys.argv[1]
        if not os.path.exists(marker):
            open(marker, "w").close()
            sys.exit(7)
        sys.exit(0)
    """)
    sup = GangSupervisor([script, marker], nproc=1, max_restarts=2,
                         restart_backoff_s=0.05)
    assert sup.run() == [0]
    assert sup.restarts == 1
    kinds = [e["kind"] for e in sup.events]
    assert kinds == ["gang_start", "rank_exit", "restart", "gang_start",
                     "gang_ok"]
    exit_ev = next(e for e in sup.events if e["kind"] == "rank_exit")
    assert exit_ev["rank"] == 0 and exit_ev["code"] == 7


def test_supervisor_restart_budget_exhausted(tmp_path):
    script = _write_script(tmp_path, "always_dies.py", """
        import sys
        sys.exit(5)
    """)
    sup = GangSupervisor([script], nproc=1, max_restarts=1,
                         restart_backoff_s=0.05)
    with pytest.raises(GangFailedError) as ei:
        sup.run()
    assert ei.value.codes == [5]
    kinds = [e["kind"] for e in ei.value.events]
    assert kinds.count("rank_exit") == 2
    assert kinds[-1] == "gang_failed"


def test_supervisor_detects_hang_via_heartbeat(tmp_path):
    marker = str(tmp_path / "hung_once")
    script = _write_script(tmp_path, "hang.py", """
        import os, sys, time
        marker = sys.argv[1]
        hb = os.environ["PADDLE_RESILIENCE_HEARTBEAT_DIR"]
        rank = os.environ["PADDLE_TRAINER_ID"]
        with open(os.path.join(hb, "hb_" + rank), "w") as f:
            f.write("tick")
        if not os.path.exists(marker):
            open(marker, "w").close()
            time.sleep(60)  # wedge: no further ticks
        sys.exit(0)
    """)
    sup = GangSupervisor([script, marker], nproc=1, max_restarts=1,
                         restart_backoff_s=0.05, hang_timeout_s=1.0,
                         heartbeat_dir=str(tmp_path / "hb"))
    t0 = time.monotonic()
    assert sup.run() == [0]
    assert time.monotonic() - t0 < 30
    hang_ev = next(e for e in sup.events if e["kind"] == "hang")
    assert hang_ev["rank"] == 0 and hang_ev["age_s"] >= 1.0


def test_heartbeat_tick_helper(tmp_path, monkeypatch):
    monkeypatch.delenv(HEARTBEAT_DIR_ENV, raising=False)
    assert heartbeat_tick() is False  # no supervisor: inert
    monkeypatch.setenv(HEARTBEAT_DIR_ENV, str(tmp_path))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    assert heartbeat_tick() is True
    assert os.path.exists(str(tmp_path / "hb_3"))


def _checkpoints(ckdir, steps):
    """fit_a_line checkpoints at ``steps`` through the port's writer."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.core.ir import Program, program_guard
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint

    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        pred = layers.fc(x, size=1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        pt.optimizer.SGD(learning_rate=0.01).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    ck = AutoCheckpoint(exe, main, ckdir, max_to_keep=5, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 4).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32)}
    for step in steps:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ck.save(step, blocking=True)
    ck.close()


def test_restart_quarantines_corrupt_checkpoints_first(tmp_path):
    """Before relaunching, the supervisor walks each checkpoint dir and
    quarantines a corrupt newest entry, so the gang resumes from the
    newest VALID checkpoint (the ``restart`` event names it)."""
    ckdir = str(tmp_path / "ck")
    _checkpoints(ckdir, steps=(1, 2))
    newest = sorted(d for d in os.listdir(ckdir) if d.startswith("ckpt_"))
    faults.corrupt_file(os.path.join(ckdir, newest[-1], "state.npz"))
    marker = str(tmp_path / "crashed_once")
    script = _write_script(tmp_path, "worker.py", """
        import os, sys
        if not os.path.exists(sys.argv[1]):
            open(sys.argv[1], "w").close()
            sys.exit(9)
    """)
    sup = GangSupervisor([script, marker], nproc=1, max_restarts=1,
                         restart_backoff_s=0.05, checkpoint_dirs=[ckdir])
    assert sup.run() == [0]
    restart = next(e for e in sup.events if e["kind"] == "restart")
    assert restart["resume_from"] == {ckdir: newest[0]}
    assert any(n.startswith(newest[-1]) and n.endswith(".corrupt")
               for n in os.listdir(ckdir))


def test_supervisor_restart_single_rank(tmp_path):
    script = _write_script(tmp_path, "sleepy.py", """
        import time, sys
        time.sleep(30)
        sys.exit(0)
    """)
    sup = GangSupervisor([script], nproc=3)
    procs = sup.launch()
    pids = [p.pid for p in procs]
    try:
        sup.restart(1)
        assert sup._procs[1].pid != pids[1]
        assert sup._procs[0].pid == pids[0] and procs[0].poll() is None
        assert sup._procs[2].pid == pids[2] and procs[2].poll() is None
        assert sup.rank_restarts == {1: 1}
        ev = [e for e in sup.events if e["kind"] == "rank_restart"]
        assert len(ev) == 1 and ev[0]["rank"] == 1
        c = obs_metrics.registry().get(
            "resilience_events_total", labels={"kind": "rank_restart"})
        assert c is not None and c.value >= 1
    finally:
        sup.terminate()
    assert all(p.poll() is not None for p in sup.procs())


def test_dead_replica_restarts_in_place_via_supervisor():
    """A DEAD replica whose rank a GangSupervisor owns is terminated and
    respawned INTO ITS OWN slot (``supervisor.restart(rank)``) and
    re-enters routing via ``revive_replica`` — autoscale replacement
    never fires. Hand-stepped (no pump thread)."""
    sup = GangSupervisor(["-c", "import time; time.sleep(600)"],
                         nproc=1, grace_s=0.5)
    sup.launch()

    def b():
        return build_decoder_model(name="fleet_t", version="1", **GEOM)

    def factory(index):
        return LocalReplica.create(f"r{index}", index, b,
                                   place=pt.CPUPlace())

    def revive_factory(rid, index):
        assert rid == "r0" and index == 0
        return factory(index)

    router = FleetRouter(
        replica_factory=factory, autoscale=True, min_replicas=1,
        health_interval_s=1e9, supervisor=sup,
        revive_factory=revive_factory)
    handle = router.add_replica(factory(0))
    counter = obs_metrics.registry().counter(
        "resilience_events_total", "gang supervisor decisions",
        labels={"kind": "rank_restart"})
    before = counter.value
    old_pid = sup.procs()[0].pid
    try:
        handle.kill()
        router._health_pass()             # transport loss -> DEAD latch
        assert router.replicas()["r0"] == "dead"
        router._tick()                    # revive runs BEFORE autoscale
        assert sup.rank_restarts == {0: 1}
        assert counter.value == before + 1
        assert sup.procs()[0].pid != old_pid
        assert router.metrics.count("supervisor_restarts") == 1
        assert router.metrics.count("scale_ups") == 0
        assert router.replicas()["r0"] != "dead"
        router._tick()
        assert sup.rank_restarts == {0: 1}
        resp = router.submit([1, 2, 3], max_new_tokens=3, model="fleet_t",
                             version="1")
        deadline = time.time() + 60
        while not resp.done() and time.time() < deadline:
            router._tick()
            time.sleep(0.005)
        ref = router._replicas["r0"].engine.entry(
            "fleet_t", "1").offline_decode([1, 2, 3], 3)
        assert [int(t) for t in resp.result(timeout=5)["tokens"]] == ref
    finally:
        terminate_gang(sup.procs(), grace_s=0.5)
        for h in router._replicas.values():
            h.close()
