"""The port's lockdep witness (``observability/lockdep.py``):

* ``tests/test_concurrency.py``'s witness tests on the port: a
  cycle-closing edge and a declared-order inversion raise at acquire
  time, naming both classes, the held chain and where the opposite order
  was first seen; RLock re-entrancy and ``Condition.wait`` keep the
  record straight; same-class nesting raises; toggling mid-hold leaves
  no phantom edge; disabled, the witness is inert;
* the port declares every lock order the JAX package declares among the
  lock names the port has (the data plane's, the remote lookup's, the
  fetcher's and the heartbeat monitor's included);
* armed, the fleet router's 8-thread hammer (a replica dies mid-hammer)
  and a decode engine's chunked, speculative and parked serving run
  with no violation, witnessing ``fleet.router -> serving.queue`` and
  ``serving.queue -> decode.tenant``.
"""

import re
import threading
import time
from pathlib import Path

import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.observability import lockdep
from paddle_tpu_torch.serving.decode import GenerationEngine, build_decoder_model
from paddle_tpu_torch.serving.fleet import FleetRouter, LocalReplica

ROOT = Path(__file__).resolve().parents[1]
GEOM = dict(vocab_size=24, hidden=8, num_layers=1, slots=2, max_len=16)


@pytest.fixture
def armed_lockdep():
    """Enable + reset the witness for a test, restoring prior state (the
    graph is process-global; declared chains survive by design)."""
    was = lockdep.enabled()
    lockdep.enable()
    lockdep.reset()
    yield lockdep
    lockdep.reset()
    lockdep.enable(was)


# ---------------------------------------------------------------------------
# runtime witness unit behaviour
# ---------------------------------------------------------------------------


def test_witness_raises_on_cycle_closing_edge(armed_lockdep):
    a = lockdep.named_lock("tw.a")
    b = lockdep.named_lock("tw.b", rlock=True)
    with a:
        with b:
            pass
    with pytest.raises(lockdep.LockOrderError) as ei:
        with b:
            with a:
                pass
    msg = str(ei.value)
    assert "tw.a" in msg and "tw.b" in msg
    assert "held chain: tw.b" in msg and "first seen at" in msg
    assert lockdep.violations()


def test_witness_enforces_declared_hierarchy(armed_lockdep):
    import paddle_tpu_torch.serving.decode.engine  # noqa: F401 - declares

    q = lockdep.named_lock("serving.queue", rlock=True)
    t = lockdep.named_lock("decode.tenant")
    with q:
        with t:
            pass
    with pytest.raises(lockdep.LockOrderError) as ei:
        with t:
            with q:
                pass
    assert "declared lock order 'serving.queue -> decode.tenant'" \
        in str(ei.value)


def test_witness_reentrant_and_condition_protocol(armed_lockdep):
    q = lockdep.named_lock("tw.cond", rlock=True)
    cond = threading.Condition(q)
    woke = []

    def waiter():
        with cond:
            woke.append(cond.wait(timeout=5))

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    time.sleep(0.05)
    with cond:
        with q:  # re-entrant: no self-edge, no error
            pass
        cond.notify_all()
    th.join(5)
    assert woke == [True]
    snap = lockdep.snapshot()
    assert snap["cycles"] == [] and snap["violations"] == []


def test_witness_same_class_nesting_raises(armed_lockdep):
    a1 = lockdep.named_lock("tw.same")
    a2 = lockdep.named_lock("tw.same")
    with a1:
        with pytest.raises(lockdep.LockOrderError) as ei:
            with a2:
                pass
    assert "same-class nesting" in str(ei.value)


def test_witness_toggle_mid_hold_keeps_stack_consistent():
    was = lockdep.enabled()
    try:
        lockdep.enable()
        lockdep.reset()
        lk = lockdep.named_lock("tw.toggle")
        lk.acquire()
        lockdep.enable(False)
        lk.release()
        lockdep.enable(True)
        with lockdep.named_lock("tw.toggle.other"):
            pass
        snap = lockdep.snapshot()
        assert snap["edges"] == [] and snap["violations"] == []
    finally:
        lockdep.reset()
        lockdep.enable(was)


def test_witness_condition_restore_violation_surfaces_cleanly(
        armed_lockdep):
    import paddle_tpu_torch.serving.decode.engine  # noqa: F401 - declares

    q = lockdep.named_lock("serving.queue", rlock=True)
    t = lockdep.named_lock("decode.tenant")
    cond = threading.Condition(q)
    err = []

    def waiter():
        try:
            with cond:
                with t:
                    cond.wait(timeout=5)
        except BaseException as e:
            err.append(e)

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    th.join(5)
    assert len(err) == 1 and isinstance(err[0], lockdep.LockOrderError), err
    assert "declared lock order" in str(err[0])


def test_witness_disabled_is_inert():
    was = lockdep.enabled()
    lockdep.enable(False)
    try:
        a = lockdep.named_lock("tw.off.a")
        b = lockdep.named_lock("tw.off.b")
        with a:
            with b:
                pass
        with b:
            with a:  # would raise when armed
                pass
        assert lockdep.violations() == []
    finally:
        lockdep.enable(was)


def test_witness_env_switch():
    assert lockdep.LOCKDEP_ENV == "PADDLE_TPU_LOCKDEP"
    import os
    import subprocess
    import sys

    probe = ("from paddle_tpu_torch.observability import lockdep; "
             "print(lockdep.enabled())")
    env = {**os.environ, "PYTHONPATH": str(ROOT), lockdep.LOCKDEP_ENV: "1"}
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "True", out.stderr


# ---------------------------------------------------------------------------
# the declared hierarchy against the JAX package's
# ---------------------------------------------------------------------------


_NAMED = re.compile(r"named_(?:lock|condition)\(\s*\"([\w.]+)\"")


def _pairs(chains):
    return {(c[i], c[j]) for c in chains
            for i in range(len(c)) for j in range(i + 1, len(c))}


def test_port_declares_every_jax_order_among_its_lock_names():
    import paddle_tpu.dataset  # noqa: F401
    import paddle_tpu.distributed.lookup  # noqa: F401
    import paddle_tpu.embedding.store  # noqa: F401
    import paddle_tpu.incubate.checkpoint  # noqa: F401
    import paddle_tpu.observability.fetcher  # noqa: F401
    import paddle_tpu.serving.fleet  # noqa: F401
    from paddle_tpu.observability import lockdep as jax_lockdep

    import paddle_tpu_torch.dataset  # noqa: F401
    import paddle_tpu_torch.distributed.lookup  # noqa: F401
    import paddle_tpu_torch.embedding.store  # noqa: F401
    import paddle_tpu_torch.incubate.checkpoint  # noqa: F401
    import paddle_tpu_torch.observability.fetcher  # noqa: F401
    import paddle_tpu_torch.serving.fleet  # noqa: F401

    have = set()
    for path in (ROOT / "paddle_tpu_torch").rglob("*.py"):
        have.update(_NAMED.findall(path.read_text()))
    jax_names = set()
    for path in (ROOT / "paddle_tpu").rglob("*.py"):
        jax_names.update(_NAMED.findall(path.read_text()))
    assert {"fleet.router", "serving.queue", "decode.tenant",
            "decode.blocks", "checkpoint.manifest", "dataio.dataset.feed",
            "dataio.dataset.truncate", "lookup.prefetch", "lookup.push",
            "observability.fetcher", "resilience.heartbeat"} <= have
    # every name the port takes is one the JAX package takes
    assert have <= jax_names, have - jax_names
    want = {(a, b) for a, b in _pairs(jax_lockdep.declared_orders())
            if a in have and b in have}
    got = _pairs(lockdep.declared_orders())
    assert want and want <= got, want - got


# ---------------------------------------------------------------------------
# armed drives
# ---------------------------------------------------------------------------


def _builder(name="fleet_t", version="1", **over):
    kw = {**GEOM, **over}

    def b():
        return build_decoder_model(name=name, version=version, **kw)

    return b


def test_router_hammer_8_threads_under_lockdep(armed_lockdep):
    """8 submit threads race the pump's failover/health passes and stats
    readers while a replica dies mid-hammer: totals stay exact
    (accepted == completed), the witness stays silent, and every future
    resolves."""
    router = FleetRouter(health_interval_s=0.01)
    b = _builder()
    for i in range(3):
        router.add_replica(LocalReplica.create(f"r{i}", i, b,
                                               place=pt.CPUPlace()))
    router.start()
    errors = []
    responses = []
    resp_lock = threading.Lock()
    stop = threading.Event()
    N = 12

    def submitter(k):
        try:
            for i in range(N):
                r = router.submit([((k * N + i) % 23) + 1, 2],
                                  max_new_tokens=3, tenant=f"t{k % 3}")
                with resp_lock:
                    responses.append(r)
                time.sleep(0.001)
        except BaseException as e:
            errors.append(e)

    def reader():
        try:
            last = 0
            while not stop.is_set():
                st = router.stats()
                assert st["completed"] >= last
                last = st["completed"]
                router.replicas()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(k,), daemon=True)
               for k in range(8)]
    threads.append(threading.Thread(target=reader, daemon=True))
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)
        router._replicas["r2"].kill()  # die mid-hammer
        for t in threads[:-1]:
            t.join(120)
        stop.set()
        threads[-1].join(10)
        assert not errors, f"hammer raised: {errors[:3]}"
        outs = [r.result(timeout=120) for r in responses]
        assert all(len(o["tokens"]) == 3 for o in outs)
        st = router.stats()
        assert st["accepted"] == 8 * N
        assert st["completed"] == 8 * N, f"zero-loss violated: {st}"
    finally:
        stop.set()
        router.shutdown()
    snap = lockdep.snapshot()
    assert snap["violations"] == [] and snap["cycles"] == []
    assert ["fleet.router", "serving.queue"] in snap["edges"]


def test_decode_engine_serves_armed_without_violation(armed_lockdep):
    """Chunked prefill and draft-KV speculation on one entry, and
    park/resume through a cut block pool on another, under the armed
    witness: every stream equals ``offline_decode``, with no
    violation."""
    geom = dict(vocab_size=24, hidden=8, num_layers=1, slots=2, max_len=24)
    engine = GenerationEngine(place=pt.CPUPlace(), queue_depth=64,
                              breaker_threshold=0, host_tier_mb=4)
    target = engine.register_model(build_decoder_model(
        **geom, block_size=2, chunk_tokens=4, name="armed"))
    cut = engine.register_model(build_decoder_model(
        **geom, block_size=2, num_blocks=9, name="armed_cut"))
    engine.register_model(build_decoder_model(**geom, name="armed_draft"))
    prompts = [[(3 * i + j) % 24 for j in range(5 + i)] for i in range(5)]
    engine.start()
    try:
        resps = [engine.submit(p, model=m, max_new_tokens=6,
                               tenant=f"t{i % 2}")
                 for m in ("armed", "armed_cut")
                 for i, p in enumerate(prompts)]
        resps.append(engine.submit(prompts[0], model="armed",
                                   max_new_tokens=6,
                                   draft_model="armed_draft", spec_k=2))
        outs = [[int(t) for t in r.result(timeout=120)["tokens"]]
                for r in resps]
        st, cst = target.stats(), cut.stats()
    finally:
        engine.shutdown()
    refs = [target.offline_decode(p, 6) for p in prompts]
    assert outs == refs + refs + refs[:1]
    assert st["chunk_runs"] >= 1 and st["spec_target_steps"] >= 1
    assert cst["sessions_parked"] >= 1
    snap = lockdep.snapshot()
    assert snap["violations"] == [] and snap["cycles"] == []
    assert ["serving.queue", "decode.tenant"] in snap["edges"]
